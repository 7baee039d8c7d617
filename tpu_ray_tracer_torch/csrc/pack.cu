// A frame's table packing and its VJP for Hopper (sm_90a): two kernels of
// one block each.
//
// They replace no Pallas kernel. In the JAX package one frame on the kernel
// route is one executable, `_render_pallas_jit`
// (tpu_ray_tracer/render/pallas_backend.py:1457), and XLA fuses what it does
// beside the Pallas call into a few fusions: the f32 casts and the
// cubics-first `jnp.take` of the tables (:1464-1478), `_pack_lights`
// (:1177), `_pack_camera` (:1190) and `_dir_form_table` (:1139, added at
// :1432 in `_dispatch_fwd`); `jax.grad` fuses their VJP after `_packed_bwd`
// (:2073-2118) the same way. Written with torch ops, that is ~70 small
// kernels a frame and as many again in its backward; these two kernels are
// the port's counterpart of XLA's fusions:
//
// - `pack_frame_kernel` writes the 8 tables of one `render_fwd` call from
//   the scene's and the camera's own tensors (f32 or f64, cast to f32 as
//   `scene.astype(torch.float32)` casts them): the slot-gathered coefs,
//   colours and reflection ratios, orig_index and posdef, the light table
//   [L, 7], the direction-form table [L, N] and cam [18] (the rotation
//   columns from yaw and pitch, eye, aspect * tanf, tanf, bg, row0).
// - `pack_vjp_kernel` maps `render_bwd`'s gradient vector (18 + 24N + 7L
//   rows: cam | coefs | colours | lights | refl, in slot order) to the
//   gradients of the scene's and camera's tensors: it un-permutes the slot
//   rows, drops cam row 17 (the row offset) and light column 0 (the kind
//   flag), which no tensor owns (what `_packed_bwd` zeroes, :2100-2109),
//   and takes the camera's rows back through the rotation's normalisations,
//   cross products and trig in closed form. Each gradient is written in its
//   tensor's dtype; a null output pointer is skipped.
//
// What bounds them: their launch. Each moves a few kilobytes (pack_frame:
// 1.1 KB on dingdong, 8.7 KB on 20spheres) and does a few hundred to a few
// thousand f32 operations: under 3 ns at 3.35 TB/s and 67 TFLOP/s
// (render/bounds.py `pack_work`, `vjp_work`), against microseconds of
// launch. So each is one block
// of PACK_THREADS threads: every table entry is one thread's work in a
// block-stride loop over one index space of all the tables (any N and L
// that render_fwd takes), the camera is the last warp's, and no entry
// depends on another, so there is no synchronisation and no shared memory.
// More blocks would add scheduling and nothing else. One index space, not a
// loop a table, and the camera on a thread of its own keep a thread from
// waiting on several rounds of loads one after another (a design with a
// loop a table and the camera after thread 0's entries took 8.0 us inside
// the graph, this one 3.4-3.5; PERF.md).
//
// Numerics. The tables must equal the plain version's
// (render/pack_kernel.py `pack_tables_plain`, torch ops on the card) bit for
// bit: the direction-form table feeds knife-edge occlusion sign tests (a
// bf16 version flipped 499 penumbra pixels on 20spheres in the JAX
// package). NVCC_FLAGS has -fmad=true, so every product and sum here is an
// explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn), which nvcc never contracts into an FMA; sinf, cosf and sqrtf
// are the full-precision ones torch's CUDA ops call. Sums follow the order
// of torch's CUDA reduction over a contiguous last dimension of n elements
// (`torch_sum`), and the rotation's cross products torch's CUDA cross,
// which fuses one product of each entry (`torch_cross`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PACK_THREADS = 256;
constexpr int N_COEFS = 20;
constexpr int QUAD_START = 10;  // first degree-2 monomial (x2)
constexpr int N_QUAD = 6;       // x2 y2 z2 xy xz yz

// Monomial exponents (px, py, pz) of the cubic (0-9) or the quadratic
// (10-15) coefficients, as models/surface.py's MONOMIAL_POWERS (and
// render_fwd.cu's mono_code), 6 bits a monomial, so that unrolled loops
// fold them.
__host__ __device__ constexpr unsigned long long pows(int x, int y, int z) {
  return x | y << 2 | z << 4;
}
__host__ __device__ constexpr unsigned long long mono_pows(bool cubic) {
  return cubic ? pows(3, 0, 0) | pows(0, 3, 0) << 6 | pows(0, 0, 3) << 12 | pows(2, 1, 0) << 18 |
                     pows(1, 2, 0) << 24 | pows(2, 0, 1) << 30 | pows(1, 0, 2) << 36 |
                     pows(0, 2, 1) << 42 | pows(0, 1, 2) << 48 | pows(1, 1, 1) << 54
               : pows(2, 0, 0) | pows(0, 2, 0) << 6 | pows(0, 0, 2) << 12 | pows(1, 1, 0) << 18 |
                     pows(1, 0, 1) << 24 | pows(0, 1, 1) << 30;
}

// The float inputs of pack_frame, by bit of `f64` (set: the tensor is f64).
enum FloatIn { IN_COEFS, IN_COLORS, IN_REFL, IN_LIGHT_P, IN_LIGHT_COLOR, IN_BG, IN_TANF,
               IN_POSITION, IN_YAW, IN_PITCH, N_FLOAT_IN };

struct PackIn {
  const void* f[N_FLOAT_IN];
  const unsigned char* light_kind;  // torch.bool
  const long long* gather;          // slot -> object (int64)
  const int* posdef;                // per slot
  int f64;
};

struct PackOut {
  float* coefs;
  int* orig_index;
  float* colors;
  float* refl;
  float* lights;
  float* dir_table;
  int* posdef;
  float* cam;
};

// The gradients of pack_vjp, in kernel_backend._grad_tensors' order, by bit
// of `f64`.
enum GradOut { G_COEFS, G_COLORS, G_REFL, G_LIGHT_P, G_LIGHT_COLOR, G_BG, G_TANF,
               G_POSITION, G_YAW, G_PITCH, N_GRAD };

struct VjpOut {
  void* g[N_GRAD];
  int f64;
};

__device__ __forceinline__ float load(const void* p, bool f64, long long i) {
  return f64 ? __double2float_rn(static_cast<const double*>(p)[i])
             : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, bool f64, long long i, float v) {
  if (f64) static_cast<double*>(p)[i] = static_cast<double>(v);
  else static_cast<float*>(p)[i] = v;
}

__host__ __device__ constexpr int last_pow2(int n) { return n < 2 ? 1 : 2 * last_pow2(n / 2); }

// torch.sum over a contiguous last dimension of n <= 16 elements, in the
// order torch's CUDA reduction takes them: last_pow2(n) lanes, lane l
// summing (0 + e[l]) + (0 + e[l + lanes]) and then its two idle
// accumulators (each 0), then a tree of halving offsets, lane l < offset
// adding lane l + offset (n = 6: ((e0 + e4) + e2) + ((e1 + e5) + e3)). The
// zeros are added as torch adds them, so signed zeros come out alike.
// Measured against torch 2.11's CUDA sum on the card for n = 3, 6 and 10
// and 1 to 5000 outputs: every value equal.
// (Unrolled for a compile-time n, so the values stay in registers.)
template <int N>
__device__ __forceinline__ float torch_sum(const float (&e)[N]) {
  constexpr int lanes = last_pow2(N);
  float v[lanes];
#pragma unroll
  for (int l = 0; l < lanes; ++l) {
    const float a = __fadd_rn(0.0f, e[l]);
    const float b = l + lanes < N ? __fadd_rn(0.0f, e[l + lanes < N ? l + lanes : 0]) : 0.0f;
    v[l] = __fadd_rn(__fadd_rn(__fadd_rn(a, b), 0.0f), 0.0f);
  }
#pragma unroll
  for (int offset = lanes / 2; offset > 0; offset /= 2)
#pragma unroll
    for (int l = 0; l < offset; ++l) v[l] = __fadd_rn(v[l], v[l + offset]);
  return v[0];
}

// cross(a, b) as torch.linalg.cross computes it on the card: each entry
// a_i b_j - a_k b_l with the first product fused, fma(a_i, b_j, -(a_k b_l))
// (measured against torch 2.11's CUDA cross: 9000 of 9000 entries equal).
__device__ __forceinline__ void torch_cross(const float* a, const float* b, float* out) {
  out[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
  out[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
  out[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// cross(a, b) with each product and difference rounded, as the plain VJP
// (pack_kernel._cross) writes it.
__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = __fsub_rn(__fmul_rn(a[1], b[2]), __fmul_rn(a[2], b[1]));
  out[1] = __fsub_rn(__fmul_rn(a[2], b[0]), __fmul_rn(a[0], b[2]));
  out[2] = __fsub_rn(__fmul_rn(a[0], b[1]), __fmul_rn(a[1], b[0]));
}

// The camera frame of ops/camera.py (`view_direction`, `camera_frame`) in
// f32 from yaw and pitch (degrees), with the intermediates the VJP reads.
struct Frame {
  float cy, sy, cp, sp;  // cos/sin of yaw and pitch (radians)
  float nd[3];           // -d, d the view direction
  float r1;              // |nd|
  float f[3];            // nd / r1
  float c[3];            // cross(f, up)
  float r2;              // |c|
  float s[3];            // c / r2: rotation column 0
  float u[3];            // cross(s, f): rotation column 1
};

// pi / 180 rounded to f32, as torch multiplies an f32 tensor by a Python float
__device__ __forceinline__ float deg2rad() { return static_cast<float>(3.141592653589793 / 180.0); }

// v / sqrt(sum(v * v)) of ops/camera.py `_normalize`: the norm into *r
__device__ __forceinline__ void normalize3(const float* v, float* out, float* r) {
  const float sq[3] = {__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1]), __fmul_rn(v[2], v[2])};
  *r = sqrtf(torch_sum(sq));
  for (int k = 0; k < 3; ++k) out[k] = __fdiv_rn(v[k], *r);
}

__device__ Frame camera_frame(float yaw_deg, float pitch_deg) {
  Frame F;
  const float yaw = __fmul_rn(yaw_deg, deg2rad());
  const float pitch = __fmul_rn(pitch_deg, deg2rad());
  F.cy = cosf(yaw);
  F.sy = sinf(yaw);
  F.cp = cosf(pitch);
  F.sp = sinf(pitch);
  const float d[3] = {__fmul_rn(F.cy, F.cp), F.sp, __fmul_rn(F.sy, F.cp)};
  for (int k = 0; k < 3; ++k) F.nd[k] = -d[k];
  normalize3(F.nd, F.f, &F.r1);
  const float up[3] = {0.0f, 1.0f, 0.0f};
  torch_cross(F.f, up, F.c);
  normalize3(F.c, F.s, &F.r2);
  torch_cross(F.s, F.f, F.u);
  return F;
}

// Entry (li, slot) of the direction-form table (pack_kernel's
// `_dir_form_table`) from the light's stored direction `comp` (f32): the
// cubic form of the slot's coefficients (object `obj`) for a cubic slot,
// the quadratic form for the others; each monomial a left-to-right product
// of the components, unrolled.
template <bool CUBIC>
__device__ __forceinline__ float dir_form(const float* comp, const void* coefs, bool f64,
                                          long long obj) {
  constexpr int m0 = CUBIC ? 0 : QUAD_START, n = CUBIC ? QUAD_START : N_QUAD;
  constexpr unsigned long long table = mono_pows(CUBIC);
  float terms[n];
#pragma unroll
  for (int j = 0; j < n; ++j) {
    float mono = 0.0f;
    bool first = true;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int p = 0; p < static_cast<int>(table >> (6 * j + 2 * a) & 3); ++p) {
        mono = first ? comp[a] : __fmul_rn(mono, comp[a]);
        first = false;
      }
    terms[j] = __fmul_rn(mono, load(coefs, f64, obj * N_COEFS + m0 + j));
  }
  return torch_sum(terms);
}

// The threads of the first PACK_THREADS - 32 each take entries of one
// index space over every table (coefs, colours, the per-slot ones, the
// light table, the direction-form table) in a block-stride loop, so a
// small scene's entries run side by side, one each; the last warp's first
// thread packs the camera, whose loads it issues first. The critical path
// is one entry's dependent loads (gather index, then the row) or the
// camera's chain of trig, square roots and divisions, not their sum.
__global__ void __launch_bounds__(PACK_THREADS)
pack_frame_kernel(PackIn in, PackOut out, int n_obj, int n_cubic, int n_lights, float aspect,
                  float row0) {
  const int t = threadIdx.x, table_threads = blockDim.x - 32;
  auto f64 = [&](int which) { return static_cast<bool>(in.f64 >> which & 1); };
  if (t == table_threads) {
    const float yaw = load(in.f[IN_YAW], f64(IN_YAW), 0);
    const float pitch = load(in.f[IN_PITCH], f64(IN_PITCH), 0);
    const float tanf_ = load(in.f[IN_TANF], f64(IN_TANF), 0);
    float eye[3], bg[3];
    for (int k = 0; k < 3; ++k) {
      eye[k] = load(in.f[IN_POSITION], f64(IN_POSITION), k);
      bg[k] = load(in.f[IN_BG], f64(IN_BG), k);
    }
    const Frame F = camera_frame(yaw, pitch);
    for (int k = 0; k < 3; ++k) {
      out.cam[k] = F.s[k];
      out.cam[3 + k] = F.u[k];
      out.cam[6 + k] = -F.f[k];
      out.cam[9 + k] = eye[k];
      out.cam[14 + k] = bg[k];
    }
    out.cam[12] = __fmul_rn(tanf_, aspect);
    out.cam[13] = tanf_;
    out.cam[17] = row0;
    return;
  }
  if (t > table_threads) return;
  const long long n_coefs = (long long)n_obj * N_COEFS, n_colors = 3LL * n_obj,
                  n_light_rows = 7LL * n_lights, n_dir = (long long)n_lights * n_obj;
  const long long total = n_coefs + n_colors + n_obj + n_light_rows + n_dir;
  for (long long i = t; i < total; i += table_threads) {
    long long j = i;
    if (j < n_coefs) {
      const long long s = j / N_COEFS;
      out.coefs[j] = load(in.f[IN_COEFS], f64(IN_COEFS),
                          in.gather[s] * N_COEFS + (j - s * N_COEFS));
      continue;
    }
    j -= n_coefs;
    if (j < n_colors) {
      const long long s = j / 3;
      out.colors[j] = load(in.f[IN_COLORS], f64(IN_COLORS), in.gather[s] * 3 + (j - s * 3));
      continue;
    }
    j -= n_colors;
    if (j < n_obj) {
      out.refl[j] = load(in.f[IN_REFL], f64(IN_REFL), in.gather[j]);
      out.orig_index[j] = static_cast<int>(in.gather[j]);
      out.posdef[j] = in.posdef[j];
      continue;
    }
    j -= n_obj;
    if (j < n_light_rows) {
      const long long li = j / 7, col = j - li * 7;
      out.lights[j] = col == 0 ? (in.light_kind[li] ? 1.0f : 0.0f)
                    : col < 4  ? load(in.f[IN_LIGHT_P], f64(IN_LIGHT_P), li * 3 + col - 1)
                               : load(in.f[IN_LIGHT_COLOR], f64(IN_LIGHT_COLOR), li * 3 + col - 4);
      continue;
    }
    j -= n_light_rows;
    const long long li = j / n_obj, s = j - li * n_obj;
    float comp[3];
    for (int a = 0; a < 3; ++a) comp[a] = load(in.f[IN_LIGHT_P], f64(IN_LIGHT_P), li * 3 + a);
    const long long obj = in.gather[s];
    out.dir_table[j] = s < n_cubic ? dir_form<true>(comp, in.f[IN_COEFS], f64(IN_COEFS), obj)
                                   : dir_form<false>(comp, in.f[IN_COEFS], f64(IN_COEFS), obj);
  }
}

// d(yaw, pitch) in degrees from the gradients of the rotation columns (gs,
// gu and g(-f): cam rows 0-8), through u = cross(s, f), s = c / |c|,
// c = cross(f, up), f = nd / |nd|, nd = -d and d(yaw, pitch); each
// normalisation's backward is autograd's: d(v / r) gives g / r to v and
// -sum(g * (v / r) / r) to r, and d sqrt(q) = g / (2 r).
__device__ void camera_vjp(const Frame& F, const float* g, float* gyaw, float* gpitch) {
  float gs[3], gf[3], tmp[3];
  const float gu[3] = {g[3], g[4], g[5]};
  for (int k = 0; k < 3; ++k) {
    gs[k] = g[k];
    gf[k] = -g[6 + k];
  }
  cross3(F.f, gu, tmp);  // u = cross(s, f): to s
  for (int k = 0; k < 3; ++k) gs[k] = __fadd_rn(gs[k], tmp[k]);
  cross3(gu, F.s, tmp);  // ... and to f
  for (int k = 0; k < 3; ++k) gf[k] = __fadd_rn(gf[k], tmp[k]);
  // s = c / r2, r2 = sqrt(c . c)
  float gc[3], acc = 0.0f;
  for (int k = 0; k < 3; ++k) {
    gc[k] = __fdiv_rn(gs[k], F.r2);
    const float term = __fmul_rn(gs[k], __fdiv_rn(F.s[k], F.r2));
    acc = k == 0 ? term : __fadd_rn(acc, term);
  }
  const float gq2 = __fdiv_rn(-acc, __fmul_rn(F.r2, 2.0f));
  for (int k = 0; k < 3; ++k) gc[k] = __fadd_rn(gc[k], __fmul_rn(__fmul_rn(F.c[k], gq2), 2.0f));
  // c = cross(f, up), up = (0, 1, 0): to f, cross(up, gc) = (gc2, 0, -gc0)
  gf[0] = __fadd_rn(gf[0], gc[2]);
  gf[2] = __fsub_rn(gf[2], gc[0]);
  // f = nd / r1, r1 = sqrt(nd . nd)
  float gnd[3];
  acc = 0.0f;
  for (int k = 0; k < 3; ++k) {
    gnd[k] = __fdiv_rn(gf[k], F.r1);
    const float term = __fmul_rn(gf[k], __fdiv_rn(F.f[k], F.r1));
    acc = k == 0 ? term : __fadd_rn(acc, term);
  }
  const float gq1 = __fdiv_rn(-acc, __fmul_rn(F.r1, 2.0f));
  for (int k = 0; k < 3; ++k) gnd[k] = __fadd_rn(gnd[k], __fmul_rn(__fmul_rn(F.nd[k], gq1), 2.0f));
  // nd = -d, d = (cy cp, sp, sy cp)
  const float gd0 = -gnd[0], gd1 = -gnd[1], gd2 = -gnd[2];
  const float a = __fmul_rn(gd0, F.cp), b = __fmul_rn(gd2, F.cp);
  const float g_yaw = __fsub_rn(__fmul_rn(b, F.cy), __fmul_rn(a, F.sy));
  const float gc_p = __fadd_rn(__fmul_rn(gd0, F.cy), __fmul_rn(gd2, F.sy));
  const float g_pitch = __fsub_rn(__fmul_rn(gd1, F.cp), __fmul_rn(gc_p, F.sp));
  *gyaw = __fmul_rn(g_yaw, deg2rad());
  *gpitch = __fmul_rn(g_pitch, deg2rad());
}

// The same split as pack_frame_kernel: the first PACK_THREADS - 32
// threads write the table gradients, the last warp's first thread the
// camera's and tan_half_fov's.
__global__ void __launch_bounds__(PACK_THREADS)
pack_vjp_kernel(const float* vec, const long long* gather, const void* yaw, const void* pitch,
                int angles_f64, VjpOut out, int n_obj, int n_lights, float aspect) {
  const int t = threadIdx.x, table_threads = blockDim.x - 32;
  auto f64 = [&](int which) { return static_cast<bool>(out.f64 >> which & 1); };
  if (t == table_threads) {
    for (int k = 0; k < 3; ++k) {
      if (out.g[G_BG]) store(out.g[G_BG], f64(G_BG), k, vec[14 + k]);
      if (out.g[G_POSITION]) store(out.g[G_POSITION], f64(G_POSITION), k, vec[9 + k]);
    }
    // cam[12] = tanf * aspect and cam[13] = tanf
    if (out.g[G_TANF])
      store(out.g[G_TANF], f64(G_TANF), 0, __fadd_rn(__fmul_rn(vec[12], aspect), vec[13]));
    if (out.g[G_YAW] || out.g[G_PITCH]) {
      const Frame F = camera_frame(load(yaw, angles_f64 & 1, 0),
                                   load(pitch, angles_f64 >> 1 & 1, 0));
      float gyaw, gpitch;
      camera_vjp(F, vec, &gyaw, &gpitch);
      if (out.g[G_YAW]) store(out.g[G_YAW], f64(G_YAW), 0, gyaw);
      if (out.g[G_PITCH]) store(out.g[G_PITCH], f64(G_PITCH), 0, gpitch);
    }
    return;
  }
  if (t > table_threads) return;
  const long long n_coefs = (long long)n_obj * N_COEFS, n_colors = 3LL * n_obj,
                  n_light_cols = 3LL * n_lights;
  const long long row_colors = 18 + n_coefs, row_lights = row_colors + n_colors,
                  row_refl = row_lights + 7LL * n_lights;
  const long long total = n_coefs + n_colors + n_obj + n_light_cols;
  for (long long i = t; i < total; i += table_threads) {
    long long j = i;
    if (j < n_coefs) {
      const long long s = j / N_COEFS;
      if (out.g[G_COEFS])
        store(out.g[G_COEFS], f64(G_COEFS), gather[s] * N_COEFS + (j - s * N_COEFS),
              vec[18 + j]);
      continue;
    }
    j -= n_coefs;
    if (j < n_colors) {
      const long long s = j / 3;
      if (out.g[G_COLORS])
        store(out.g[G_COLORS], f64(G_COLORS), gather[s] * 3 + (j - s * 3), vec[row_colors + j]);
      continue;
    }
    j -= n_colors;
    if (j < n_obj) {
      if (out.g[G_REFL]) store(out.g[G_REFL], f64(G_REFL), gather[j], vec[row_refl + j]);
      continue;
    }
    j -= n_obj;  // columns 1-3 and 4-6 of each light
    const long long li = j / 3, k = j - li * 3;
    if (out.g[G_LIGHT_P])
      store(out.g[G_LIGHT_P], f64(G_LIGHT_P), j, vec[row_lights + li * 7 + 1 + k]);
    if (out.g[G_LIGHT_COLOR])
      store(out.g[G_LIGHT_COLOR], f64(G_LIGHT_COLOR), j, vec[row_lights + li * 7 + 4 + k]);
  }
}

}  // namespace

// float inputs (N_FLOAT_IN, FloatIn order), light kinds, gather, posdef |
// f64 mask | 8 outputs (the tables of render_fwd in its order) | n_obj
// n_cubic n_lights | aspect row0 | stream
extern "C" int trt_pack_frame(const void* coefs, const void* colors, const void* refl,
                              const void* light_p, const void* light_color, const void* bg,
                              const void* tanf, const void* position, const void* yaw,
                              const void* pitch, const void* light_kind, const void* gather,
                              const void* posdef, int f64, void* out_coefs, void* out_orig,
                              void* out_colors, void* out_refl, void* out_lights, void* out_dir,
                              void* out_posdef, void* out_cam, int n_obj, int n_cubic,
                              int n_lights, double aspect, int row0, void* stream) {
  PackIn in{{coefs, colors, refl, light_p, light_color, bg, tanf, position, yaw, pitch},
            static_cast<const unsigned char*>(light_kind),
            static_cast<const long long*>(gather), static_cast<const int*>(posdef), f64};
  PackOut out{static_cast<float*>(out_coefs), static_cast<int*>(out_orig),
              static_cast<float*>(out_colors), static_cast<float*>(out_refl),
              static_cast<float*>(out_lights), static_cast<float*>(out_dir),
              static_cast<int*>(out_posdef), static_cast<float*>(out_cam)};
  // the Python float's f32 rounding, as torch's f32 tensor * Python float takes it
  pack_frame_kernel<<<1, PACK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, n_obj, n_cubic, n_lights, static_cast<float>(aspect), static_cast<float>(row0));
  return (int)cudaGetLastError();
}

// gradient vector, gather, yaw, pitch | angles' f64 bits (yaw 1, pitch 2) |
// 10 outputs (GradOut order; null: not wanted) | their f64 mask | n_obj
// n_lights | aspect | stream
extern "C" int trt_pack_vjp(const void* vec, const void* gather, const void* yaw,
                            const void* pitch, int angles_f64, void* g_coefs, void* g_colors,
                            void* g_refl, void* g_light_p, void* g_light_color, void* g_bg,
                            void* g_tanf, void* g_position, void* g_yaw, void* g_pitch, int f64,
                            int n_obj, int n_lights, double aspect, void* stream) {
  VjpOut out{{g_coefs, g_colors, g_refl, g_light_p, g_light_color, g_bg, g_tanf, g_position,
              g_yaw, g_pitch}, f64};
  pack_vjp_kernel<<<1, PACK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vec), static_cast<const long long*>(gather), yaw, pitch,
      angles_f64, out, n_obj, n_lights, static_cast<float>(aspect));
  return (int)cudaGetLastError();
}

extern "C" const char* trt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
