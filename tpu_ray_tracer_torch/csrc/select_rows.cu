// The backward of the pipeline's per-ray gather of a per-object table,
// out = table[idx], for Hopper (sm_90a): grad_table[n, c] = the sum of
// grad_out[r, c] over the rows r with idx[r] == n.
//
// Replaces no Pallas kernel. It is the counterpart of the scatter-add that
// XLA emits for the transpose of the JAX pipeline's gathers
// (`scene.coefs[idx]`, `scene.colors[idx]`, `refl[idx]`,
// tpu_ray_tracer/render/pipeline.py:93, :95, :150, :187) inside the jitted
// train step. Without it, autograd runs aten's `index_put_(accumulate=True)`,
// which sorts the indices and sums each run of equal indices serially: where
// every ray hits the one object of the scene, a single thread group adds all
// the rows one after another.
//
// What bounds it on this card: its bytes. It reads each gradient row (C
// values) and its int64 index once, and writes N * C values: on clebsch
// 800x600's soft step (two branches of 374 rows of 800 rays, C = 20, f32)
// 598,400 * 88 B = 52.7 MB a call, 15.7 us at 3.35 TB/s.
//
// Design. No atomics, so a call repeated on the same inputs gives the same
// bits (a captured graph replays the eager call's bits):
// - `select_rows_bwd_kernel`: one resident wave of 256-thread blocks (fewer
//   for a small input), each summing a contiguous slab of rows. A row is Q
//   = C / V vectors of V values (16-byte loads where C allows); a warp is G
//   = 32 / Q groups of Q lanes (G = 1, and vectors lane, lane + 32, ...
//   where Q >= 32), and group g reads row base + g, so a warp reads G whole
//   consecutive rows, coalesced. Each lane starts the loads of UNROLL rows
//   (their indices and values together) before it adds any. Every (warp,
//   group) owns its [N, C] copy of the sums and lane (g, q) writes only
//   vector q of its group's copy: no two lanes ever write the same word. The
//   copies live in shared memory, or, where WARPS * G * N * C values do not
//   fit in SMEM_LIMIT, in the block's slice of global scratch (one block an
//   SM then). The block sums its copies in a fixed order into its column of
//   a [N * C, blocks] partial table;
// - `select_rows_reduce_kernel`: one block per output value, the fixed
//   tree of render_bwd.cu's `reduce_rows_kernel`.
// f32 and f64 tables (the FAST and GOLDEN dtypes), each summed in its own
// type. The gradient must be 16-byte aligned (the wrapper's allocation).
//
// Measured on an H100 (PERF.md): 25.05 us on clebsch's row block, 62.8% of
// its bound. The first design (one column a lane, 4-byte loads, a row's load
// started after its index had arrived, 74 registers, 3 blocks an SM) took
// 64.98 us, latency-bound at 24%.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MIN_BLOCKS = 4;  // at most 64 registers: 32 warps resident on an SM
constexpr int WARPS = BLOCK / 32;
constexpr int UNROLL = 4;
constexpr int REDUCE_THREADS = 256;
// The shared placement up to here, so that two blocks fit in an SM's 227 KB.
constexpr size_t SMEM_LIMIT = 96 * 1024;
// Rows a lane group sums at least before another block is worth its launch.
constexpr long long MIN_GROUP_ROWS = 32;

enum Placement { SHARED = 0, GLOBAL = 1 };

// V values of a row, loaded and stored as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// Values a load: 16 bytes where the row's length allows.
template <typename T>
inline int vector_width(int c) {
  const int widest = 16 / (int)sizeof(T);
  for (int v = widest; v > 1; v >>= 1)
    if (c % v == 0) return v;
  return 1;
}

__host__ __device__ inline int groups_for(int q) { return q >= 32 ? 1 : 32 / q; }

// Each block: the rows [rows * b / blocks, rows * (b + 1) / blocks).
template <typename T, int V>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
select_rows_bwd_kernel(const T* __restrict__ grad, const long long* __restrict__ idx,
                       long long rows, int n, int c, T* __restrict__ partial,
                       T* __restrict__ g_acc) {
  using VT = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q_row = c / V;  // vectors a row
  const int G = groups_for(q_row);
  const size_t copy = (size_t)n * c;
  const size_t copies = (size_t)WARPS * G * copy;
  T* block_acc = g_acc ? g_acc + (size_t)blockIdx.x * copies : reinterpret_cast<T*>(smem_raw);
  for (size_t k = threadIdx.x; k < copies; k += BLOCK) block_acc[k] = T(0);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = q_row >= 32 ? 0 : lane / q_row;
  if (g < G) {  // the lanes past G * Q idle
    VT* acc = reinterpret_cast<VT*>(block_acc + ((size_t)warp * G + g) * copy);
    const VT* rows_v = reinterpret_cast<const VT*>(grad);
    const int q0 = lane - g * q_row;
    const long long lo = rows * blockIdx.x / gridDim.x;
    const long long hi = rows * (blockIdx.x + 1) / gridDim.x;
    const long long stride = (long long)WARPS * G;
    for (long long base = lo + (long long)warp * G + g; base < hi; base += UNROLL * stride) {
      for (int q = q0; q < q_row; q += 32) {
        long long obj[UNROLL];
        VT v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long row = base + u * stride;
          const bool in = row < hi;
          obj[u] = in ? idx[row] : -1;
          if (in) v[u] = rows_v[(size_t)row * q_row + q];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          long long i = obj[u];
          if (base + u * stride >= hi) continue;
          if (i < 0) i += n;  // torch's negative indices count from the end
          if (i < 0 || i >= n) continue;
          VT& a = acc[(size_t)i * q_row + q];
          VT s = a;
#pragma unroll
          for (int j = 0; j < V; ++j) s.v[j] += v[u].v[j];
          a = s;
        }
      }
    }
  }
  __syncthreads();

  // the block's column of the partial table: its copies in order
  for (size_t k = threadIdx.x; k < copy; k += BLOCK) {
    T s = block_acc[k];
    for (size_t w = 1; w < (size_t)WARPS * G; ++w) s += block_acc[w * copy + k];
    partial[k * gridDim.x + blockIdx.x] = s;
  }
}

// out[k] = the sum over blocks of partial[k, :], one block per value, in a
// fixed tree: thread j sums columns j, j + 256, ... in order, then shared
// memory halves.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
select_rows_reduce_kernel(const T* __restrict__ partial, int n_cols, T* __restrict__ out) {
  __shared__ T buf[REDUCE_THREADS];
  const T* row = partial + (size_t)blockIdx.x * n_cols;
  T s = T(0);
  for (int j = threadIdx.x; j < n_cols; j += REDUCE_THREADS) s += row[j];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int h = REDUCE_THREADS / 2; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}

// The kernel of a row of c values: loads of vector_width<T>(c) values.
template <typename T>
void* kernel_for(int c) {
  constexpr int widest = 16 / (int)sizeof(T);
  const int v = vector_width<T>(c);
  if (v == widest) return (void*)select_rows_bwd_kernel<T, widest>;
  if (v == 2) return (void*)select_rows_bwd_kernel<T, 2>;
  return (void*)select_rows_bwd_kernel<T, 1>;
}

template <typename T, int V>
void launch_bwd(int blocks, size_t smem, cudaStream_t st, const T* grad, const long long* idx,
                long long rows, int n, int c, T* partial, T* g_acc) {
  select_rows_bwd_kernel<T, V><<<blocks, BLOCK, smem, st>>>(grad, idx, rows, n, c, partial,
                                                            g_acc);
}

// Values of the warp copies of one block.
template <typename T>
size_t copies_for(int n, int c) {
  return (size_t)WARPS * groups_for(c / vector_width<T>(c)) * n * c;
}

template <typename T>
size_t smem_for(int n, int c, int placement) {
  return placement == GLOBAL ? 0 : copies_for<T>(n, c) * sizeof(T);
}

template <typename T>
cudaError_t allow_smem(int c, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel_for<T>(c), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
cudaError_t plan(long long rows, int n, int c, long long* out) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t copies = copies_for<T>(n, c);
  const int placement = copies * sizeof(T) > SMEM_LIMIT ? GLOBAL : SHARED;
  const size_t smem = smem_for<T>(n, c, placement);
  if ((err = allow_smem<T>(c, smem)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel_for<T>(c), BLOCK, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const long long wave = (long long)(placement == GLOBAL ? 1 : occ) * sms;
  const long long per_block = (long long)(copies / ((size_t)n * c)) * MIN_GROUP_ROWS;
  const long long need = (rows + per_block - 1) / per_block;
  const long long blocks = need < 1 ? 1 : need < wave ? need : wave;
  out[0] = placement;
  out[1] = blocks;
  out[2] = (long long)n * c * blocks + (placement == GLOBAL ? blocks * (long long)copies : 0);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* grad, const void* idx, void* scratch, void* out, long long rows,
                   int n, int c, int placement, int blocks, cudaStream_t st) {
  const size_t smem = smem_for<T>(n, c, placement);
  cudaError_t err = allow_smem<T>(c, smem);
  if (err != cudaSuccess) return err;
  T* partial = static_cast<T*>(scratch);
  T* g_acc = placement == GLOBAL ? partial + (size_t)n * c * blocks : nullptr;
  const T* g = static_cast<const T*>(grad);
  const long long* ix = static_cast<const long long*>(idx);
  constexpr int widest = 16 / (int)sizeof(T);
  const int v = vector_width<T>(c);
  if (v == widest) launch_bwd<T, widest>(blocks, smem, st, g, ix, rows, n, c, partial, g_acc);
  else if (v == 2) launch_bwd<T, 2>(blocks, smem, st, g, ix, rows, n, c, partial, g_acc);
  else launch_bwd<T, 1>(blocks, smem, st, g, ix, rows, n, c, partial, g_acc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  select_rows_reduce_kernel<T><<<n * c, REDUCE_THREADS, 0, st>>>(partial, blocks,
                                                                 static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// The launch for `rows` gradient rows of an [n, c] table (f64: the table is
// double, else float): out[0] the placement of the warp copies (0 shared
// memory, 1 global scratch), out[1] the blocks, one resident wave or fewer
// for a small input, out[2] the values of device scratch (the [n * c,
// blocks] partial table, then the global copies). Returns a CUDA error.
extern "C" int trt_select_rows_plan(long long rows, int n, int c, int f64, long long* out) {
  return (int)(f64 ? plan<double>(rows, n, c, out) : plan<float>(rows, n, c, out));
}

// grad [rows, c] (16-byte aligned) and idx [rows] (int64), both contiguous,
// into out [n, c] with the plan's placement and blocks; scratch holds the
// plan's out[2] values of the table's type.
extern "C" int trt_select_rows_bwd(const void* grad, const void* idx, void* scratch, void* out,
                                   long long rows, int n, int c, int f64, int placement,
                                   int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(f64 ? launch<double>(grad, idx, scratch, out, rows, n, c, placement, blocks, st)
                   : launch<float>(grad, idx, scratch, out, rows, n, c, placement, blocks, st));
}

extern "C" const char* trt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
