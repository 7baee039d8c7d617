// Backward render kernel for Hopper (sm_90a): one thread per pixel.
//
// Replaces the fused backward Pallas TPU kernel of
// tpu_ray_tracer/render/pallas_backend.py (`_make_bwd_kernel`, inner
// `kernel`, launched by `_dispatch_bwd`). From the per-stage aux of the
// forward (hit distance, slot, occlusion bits; render_fwd.cu with save_aux)
// it solves no roots: it regenerates the primary ray, rebuilds the
// reflection chain forward (Phase A: points, normals, pre-clamp lit sums,
// blend ratios and colours), then replays it in reverse (Phase B: the at-cap
// blend, per-stage blend and ratio, the clamp mask, the shading backward,
// the normal backward through grad F and the Hessian, the implicit-function
// root backward with the 1e-6 grazing clamp, the reflect/bias geometry
// between stages, the camera's ray generation). The arithmetic follows the
// Pallas kernel operation for operation; render/bwd_kernel.py holds the
// plain PyTorch version of the same math.
//
// Output: one f32 vector of 18 + 24N + 7L rows (cam | coefs | colors |
// lights | refl, `_acc_layout`), summed over all pixels.
//
// Per-stage state. The Pallas kernel unrolls every stage and keeps all of
// its fields live into Phase B. Here Phase A keeps 13 floats per stage (ray
// origin and direction, pre-clamp lit, cumulative ratio, chain colour) in a
// per-thread array of MAX_STAGES entries; grad F, the normal and the
// monomial powers are recomputed from (o, d, t, slot) in the reverse sweep
// (without a chain, stage 0's are kept from Phase A).
// A stage past the array is rebuilt by stepping forward from the last stored
// one, so every bounce count the JAX package accepts runs.
//
// The reduction. CUDA blocks run concurrently, where the TPU grid revisits
// one accumulator in order, and no float atomics are used: a call repeated
// on the same inputs gives the same bits. Each thread sums the row values
// of every pixel it visits into a place of its own, in visiting order:
// - the 17 camera rows in registers;
// - the light rows, and with the "columns" placement also the object rows
//   (coefs, colours, refl) of whatever slot its pixel hit, in its own column
//   of a [rows, BLOCK] table in shared memory (thread t owns column t, so a
//   warp's 32 lanes touch 32 banks whatever rows they add to).
// Rows that have no column (the "warp" and "light_columns" placements, for
// scenes whose rows do not fit) are summed over the warp as they are
// produced (a fixed xor butterfly), object rows once per distinct slot in
// the warp, into that warp's own copy of the rows (shared memory, or global
// scratch when the copies do not fit). The camera registers are summed over
// the warp once, at the end. Then each block sums, per row, its warp copies
// in order and its columns in a fixed rotated order (conflict-free) into a
// per-block column of a [rows, blocks] partial table, and a second kernel
// sums each row over the blocks in a fixed tree. The launcher picks the
// first placement of (columns, light_columns, warp) that fits with at least
// 256 threads resident on an SM; the grid is one resident wave (occupancy x
// SMs) striding over the pixels.
//
// What bounds it on this card: on dingdong, its bytes. It reads 12 B of
// cotangent and 12 B of aux per pixel and stage (22 MB at 1280x720: 6.6 us
// at 3.35 TB/s) and writes 18 + 24N + 7L floats. Its arithmetic, counted
// along the path the aux records (render/bounds.py `bwd_work`: a stage that
// hit pays its geometry and, per lit light, the light's terms and their
// reverse, then the normal and root backward; a light the aux marks
// occluded pays nothing, one facing away its sign test; a miss only its
// background rows), is 407 f32 operations a pixel on dingdong (FMA = 2),
// 0.4e9 in all, 5.6 us at 67 TFLOP/s; 249 on 20spheres, where 84% of the
// pixels miss. Measured on an H100 (700 W, chip_smoke.py and kernel_ab.py,
// PERF.md): 0.067 ms on dingdong, 10% of the 6.6 us; the first design took
// 0.126 ms. It summed every row value over its warp as it was produced
// (~60 butterflies of 5 shuffles a pixel, at a quarter of the f32 rate),
// ran 1024 blocks as 2.6 waves, and rebuilt stage 0's geometry in the
// reverse sweep. The per-thread rows above, one resident wave, the geometry
// kept from the forward sweep when there is no chain, and 64-thread blocks
// with at least 8 resident (the sweep's best) are what this design does
// about it. What stops it short of half its bound (kernel_ab.py,
// kernel_bench.py; no per-instruction profiler on the card): it does a
// hit's work on every lane (a miss gathers a zero row), and its
// instructions are mostly not f32 arithmetic: of the `columns` kernel's
// 3144 SASS instructions (a static count) 26% are f32 arithmetic, 34%
// integer and address arithmetic (the row and column indices), 16% loads
// and stores (the shared-memory read-modify-write of every row value) and
// 5% shuffles; at 128 registers 16 of 64 warps are resident to hide the
// shared-memory latency (fewer registers spilled and ran slower).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "poly.cuh"

namespace {

constexpr float GRAZING_CLAMP = 1e-6f;  // Pallas `_GRAZING_CLAMP` (:1514)
// 64-thread blocks, at least 8 resident for the one-stage kernels (at most
// 128 registers, no spills): the fastest point of the sweep of kernel_ab.py
// on dingdong and 20spheres (PERF.md). The chain kernels (184 and 164
// registers) would spill under a cap.
constexpr int BLOCK = 64;
constexpr int MIN_BLOCKS = 8;
constexpr int MIN_BLOCKS_CHAIN = 1;
constexpr int WARPS = BLOCK / 32;
constexpr int MAX_STAGES = 8;
constexpr int REDUCE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_LIMIT = 200 * 1024;
constexpr int MIN_RESIDENT = 256 / BLOCK;  // blocks (256 threads) a column placement keeps

// Sum of v over the warp, the same bits in every lane (each butterfly step
// adds a and b in both orders, and IEEE addition commutes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The warp's sum of v, added by lane 0 to the warp's own copy of `row`.
// Every lane of the warp must call it.
__device__ __forceinline__ void reduce_row(float* acc, int row, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) acc[row] += v;
}

// Where a thread's row values go: its own column for rows [lo, hi), the
// warp reduction for the others. `col` points at the thread's column.
struct Sink {
  float* acc;  // this warp's copy of the rows
  float* col;  // this thread's column: row r at col[(r - lo) * BLOCK]
  int lo, hi;
  // every lane of the warp must call it with the same row
  __device__ __forceinline__ void add(int row, float v) const {
    if (row >= lo && row < hi) col[(row - lo) * BLOCK] += v;
    else reduce_row(acc, row, v);
  }
};

struct Rows {
  int cam, coefs, colors, lights, refl, total;
};

__host__ __device__ inline Rows acc_layout(int n_obj, int n_lights) {
  Rows r;
  r.cam = 0;
  r.coefs = 18;
  r.colors = r.coefs + n_obj * N_COEFS;
  r.lights = r.colors + n_obj * 3;
  r.refl = r.lights + n_lights * 7;
  r.total = r.refl + n_obj;
  return r;
}

// Scene tables in shared memory; row n_obj of coefs/colors/refl is zero and
// is what slot -1 (a miss, or a stage not entered) gathers.
struct Tables {
  const float* coefs;   // [N + 1, 20]
  const float* colors;  // [N + 1, 3]
  const float* refl;    // [N + 1]
  const float* lights;  // [L, 7]
  const float* cam;     // [18]
  int n_obj, n_lights;
};

// What Phase B needs of a chain stage beyond (t, slot, occ).
struct Stage {
  float o[3], d[3];  // the stage's ray
  float lit[3];      // pre-clamp lit sum
  float ratio;       // cumulative ratio r_s
  float c[3];        // chain colour c_s
};

// Point, grad F and normal of a stage (Phase A :1722-1728).
struct Geo {
  float p[3], gF[3], inv_nu, n[3];
  Pow3 P;
};

__device__ __forceinline__ void geometry(const float* sel, const float o[3], const float d[3],
                                         float t, Geo& G) {
#pragma unroll
  for (int k = 0; k < 3; ++k) G.p[k] = o[k] + t * d[k];
  G.P = powers(G.p[0], G.p[1], G.p[2]);
  float f, mag;
  eval_F<0, false, true>(sel, G.P, f, mag, G.gF);
  const float nu = sqrtf(G.gF[0] * G.gF[0] + G.gF[1] * G.gF[1] + G.gF[2] * G.gF[2]);
  G.inv_nu = 1.f / (nu > 0.f ? nu : 1.f);
#pragma unroll
  for (int k = 0; k < 3; ++k) G.n[k] = G.gF[k] * G.inv_nu;
}

// The forward's shading quantities for one light at a stage's point and
// normal (Pallas `light_terms`, :1667, static-kind branches; the kind is
// column 0 of the light table, the same for every thread).
struct LightT {
  bool sph;
  float to[3], dist2, inv_dn, ld[3], colr[3], ndotl, lam, notocc;
};

__device__ __forceinline__ LightT light_terms(const float* L, int li, const Geo& G, int occ) {
  LightT r;
  r.sph = L[0] > 0.5f;
  if (r.sph) {
#pragma unroll
    for (int k = 0; k < 3; ++k) r.to[k] = L[1 + k] - G.p[k];
    r.dist2 = r.to[0] * r.to[0] + r.to[1] * r.to[1] + r.to[2] * r.to[2];
    r.inv_dn = rsqrtf(r.dist2 > 0.f ? r.dist2 : 1.f);
#pragma unroll
    for (int k = 0; k < 3; ++k) r.ld[k] = r.to[k] * r.inv_dn;
#pragma unroll
    for (int c = 0; c < 3; ++c) r.colr[c] = L[4 + c] / (FOUR_PI * r.dist2);
  } else {  // directional: the stored direction and colour, no falloff
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r.to[k] = 0.f;
      r.ld[k] = L[1 + k];
      r.colr[k] = L[4 + k];
    }
    r.dist2 = r.inv_dn = 0.f;
  }
  r.ndotl = G.n[0] * r.ld[0] + G.n[1] * r.ld[1] + G.n[2] * r.ld[2];
  r.lam = jmax(0.f, r.ndotl);
  r.notocc = 1.f - (float)((occ >> li) & 1);
  return r;
}

// One stage's aux, with the defaults of a stage that does not exist for this
// thread (a pixel past the image).
struct Aux {
  float t;
  int slot, occ;
};

__device__ __forceinline__ Aux read_aux(const float* aux_t, const int* aux_slot,
                                        const int* aux_occ, int s, size_t n_px, size_t pix,
                                        bool valid) {
  if (!valid) return Aux{0.f, -1, 0};
  const size_t i = (size_t)s * n_px + pix;
  return Aux{aux_t[i], aux_slot[i], aux_occ[i]};
}

__device__ __forceinline__ int gather_row(const Tables& T, int slot) {
  return slot >= 0 ? slot : T.n_obj;
}

// Stage s's record from its ray and the previous stage's chain values
// (Phase A :1716-1771): the pre-clamp lit sum, then the ratio and colour.
__device__ __forceinline__ void make_stage(const Tables& T, const float o[3], const float d[3], const Aux& a,
                           int s, float ratio_prev, const float c_prev[3], bool prev_hit,
                           float prev_rfl, const float bg[3], Stage& out, Geo& G) {
  const int row = gather_row(T, a.slot);
  const float* objc = T.colors + 3 * row;
  geometry(T.coefs + N_COEFS * row, o, d, a.t, G);
  float lit[3] = {0.f, 0.f, 0.f};
  for (int li = 0; li < T.n_lights; ++li) {
    const LightT L = light_terms(T.lights + 7 * li, li, G, a.occ);
    const float w = L.lam * INV_PI * L.notocc;
#pragma unroll
    for (int c = 0; c < 3; ++c) lit[c] = lit[c] + objc[c] * L.colr[c] * w;
  }
  const bool hit = a.slot >= 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out.o[k] = o[k];
    out.d[k] = d[k];
    out.lit[k] = lit[k];
  }
  if (s == 0) {
    out.ratio = 1.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) out.c[c] = hit ? jmin(1.f, lit[c]) : bg[c];
    return;
  }
  const bool enter = prev_hit && prev_rfl > EPS;
  const float r_s = enter ? ratio_prev * prev_rfl : ratio_prev;
  out.ratio = r_s;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float bcol = hit ? jmin(1.f, lit[c]) : bg[c];
    out.c[c] = enter ? (1.f - r_s) * c_prev[c] + r_s * bcol : c_prev[c];
  }
}

// Stage s + 1's record from stage s's (o_{s+1} = p + bias n,
// d_{s+1} = d - 2 (d.n) n).
__device__ void step_stage(const Tables& T, const Stage& cur, int s, const Aux& a_cur,
                           const Aux& a_next, const float bg[3], Stage& out) {
  const int row = gather_row(T, a_cur.slot);
  Geo G;
  geometry(T.coefs + N_COEFS * row, cur.o, cur.d, a_cur.t, G);
  float o[3], d[3];
  const float dot = cur.d[0] * G.n[0] + cur.d[1] * G.n[1] + cur.d[2] * G.n[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = G.p[k] + SHADOW_BIAS * G.n[k];
    d[k] = cur.d[k] - 2.f * dot * G.n[k];
  }
  make_stage(T, o, d, a_next, s + 1, cur.ratio, cur.c, a_cur.slot >= 0, T.refl[row], bg, out,
             G);
}

struct PixelCtx {
  const float *aux_t;
  const int *aux_slot, *aux_occ;
  size_t n_px, pix;
  bool valid;
  __device__ Aux aux(int s) const {
    return read_aux(aux_t, aux_slot, aux_occ, s, n_px, pix, valid);
  }
};

// Stage s's record: stored by Phase A, or rebuilt from the last stored one.
template <int NREC>
__device__ __forceinline__ Stage get_stage(const Tables& T, const Stage* rec, int s,
                                           const PixelCtx& px, const float bg[3]) {
  if (s < NREC) return rec[s];
  Stage cur = rec[NREC - 1];
  Aux a = px.aux(NREC - 1);
  for (int k = NREC - 1; k < s; ++k) {
    const Aux a_next = px.aux(k + 1);
    Stage nxt;
    step_stage(T, cur, k, a, a_next, bg, nxt);
    cur = nxt;
    a = a_next;
  }
  return cur;
}

// Close one stage (Pallas `shade_bwd` :1775 and `stage_bwd` :1834): the
// light rows and the per-object rows go to the sink (OBJ_COLS: the object
// rows to the thread's column, else one warp reduction per distinct slot);
// returns the cotangents (do, dd) of the stage's ray.
template <bool OBJ_COLS>
__device__ __forceinline__ void stage_bwd(const Tables& T, const Rows& R, const Sink& sink,
                                          const Geo& G, const float d[3], const Aux& a,
                                          const float dlit[3], const float dn_in[3],
                                          const float dp_in[3], float drefl_val,
                                          bool with_refl, float do_out[3], float dd_out[3]) {
  const int row = gather_row(T, a.slot);
  const float* sel = T.coefs + N_COEFS * row;
  const float* objc = T.colors + 3 * row;
  float dn[3], dpoint[3], dobjc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dn[k] = 0.f;
    dpoint[k] = 0.f;
  }

  // --- shade_bwd: reverse through the per-light Lambertian sum ---
  for (int li = 0; li < T.n_lights; ++li) {
    const LightT L = light_terms(T.lights + 7 * li, li, G, a.occ);
    const int lrow = R.lights + 7 * li;
    float dlam = 0.f, ddist2 = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float u_lam = dlit[c] * L.notocc;
      dobjc[c] = dobjc[c] + u_lam * INV_PI * L.colr[c] * L.lam;
      const float dcol_c = u_lam * objc[c] * INV_PI * L.lam;
      dlam = dlam + u_lam * objc[c] * INV_PI * L.colr[c];
      if (L.sph) {
        sink.add(lrow + 4 + c, dcol_c / (FOUR_PI * L.dist2));
        ddist2 = ddist2 - dcol_c * L.colr[c] / L.dist2;
      } else {
        sink.add(lrow + 4 + c, dcol_c);
      }
    }
    const float dndotl = dlam * (L.ndotl > 0.f ? 1.f : 0.f);
    float dld[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dld[k] = dndotl * G.n[k];
      dn[k] = dn[k] + dndotl * L.ld[k];
    }
    if (!L.sph) {  // directional: ld is the stored direction
#pragma unroll
      for (int k = 0; k < 3; ++k) sink.add(lrow + 1 + k, dld[k]);
      continue;
    }
    // ld = to / |to|, dist2 = |to|^2
    const float udot = L.ld[0] * dld[0] + L.ld[1] * dld[1] + L.ld[2] * dld[2];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float dto_k = (dld[k] - L.ld[k] * udot) * L.inv_dn + 2.f * L.to[k] * ddist2;
      sink.add(lrow + 1 + k, dto_k);
      dpoint[k] = dpoint[k] - dto_k;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dn[k] = dn_in[k] + dn[k];
    dpoint[k] = dp_in[k] + dpoint[k];
  }

  // --- normal backward: n = gF / |gF| ---
  const float ndotdn = G.n[0] * dn[0] + G.n[1] * dn[1] + G.n[2] * dn[2];
  float dgF[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) dgF[k] = (dn[k] - G.n[k] * ndotdn) * G.inv_nu;
  // gF depends on sel through d(grad mono) and on the point through the
  // Hessian of F
  float dsel[N_COEFS];
#pragma unroll
  for (int m = 0; m < N_COEFS; ++m) dsel[m] = 0.f;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
#pragma unroll
    for (int m = 0; m < N_COEFS; ++m) {
      int e[3] = {mpow(m, 0), mpow(m, 1), mpow(m, 2)};
      const int ea = e[axis];
      if (ea == 0) continue;
      e[axis] -= 1;
      const float f = mono(G.P, e[0], e[1], e[2]);
      dsel[m] = dsel[m] + dgF[axis] * (ea == 1 ? f : f * (float)ea);
    }
  }
  float hv[3] = {0.f, 0.f, 0.f};  // (H @ dgF), Pallas `_hessian_apply`
#pragma unroll
  for (int m = 0; m < N_COEFS; ++m) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const int ea = mpow(m, ax);
      if (ea == 0) continue;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        int e[3] = {mpow(m, 0), mpow(m, 1), mpow(m, 2)};
        float fac;
        if (ax == b) {
          if (ea < 2) continue;
          fac = (float)(ea * (ea - 1));
          e[ax] -= 2;
        } else {
          const int eb = e[b];
          if (eb == 0) continue;
          fac = (float)(ea * eb);
          e[ax] -= 1;
          e[b] -= 1;
        }
        hv[b] = hv[b] + sel[m] * (mono(G.P, e[0], e[1], e[2]) * fac) * dgF[ax];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) dpoint[k] = dpoint[k] + hv[k];

  // --- point backward: p = o + t d ---
  const float dt = dpoint[0] * d[0] + dpoint[1] * d[1] + dpoint[2] * d[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    do_out[k] = dpoint[k];
    dd_out[k] = a.t * dpoint[k];
  }

  // --- implicit-function-theorem root backward, clamped at grazing ---
  const float df_dt = G.gF[0] * d[0] + G.gF[1] * d[1] + G.gF[2] * d[2];
  const bool valid = a.slot >= 0 && fabsf(df_dt) > GRAZING_CLAMP;
  const float sc = dt * (valid ? -1.f / df_dt : 0.f);
#pragma unroll
  for (int m = 0; m < N_COEFS; ++m)
    dsel[m] = dsel[m] + sc * mono(G.P, mpow(m, 0), mpow(m, 1), mpow(m, 2));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    do_out[k] = do_out[k] + sc * G.gF[k];
    dd_out[k] = dd_out[k] + sc * a.t * G.gF[k];
  }

  // --- per-object rows of the hit slot ---
  if (OBJ_COLS) {  // the thread's own column holds every object row
    if (a.slot >= 0) {
      float* c_coefs = sink.col + (size_t)(R.coefs + N_COEFS * a.slot - sink.lo) * BLOCK;
#pragma unroll
      for (int m = 0; m < N_COEFS; ++m) c_coefs[m * BLOCK] += dsel[m];
      float* c_colors = sink.col + (size_t)(R.colors + 3 * a.slot - sink.lo) * BLOCK;
#pragma unroll
      for (int c = 0; c < 3; ++c) c_colors[c * BLOCK] += dobjc[c];
      if (with_refl) sink.col[(size_t)(R.refl + a.slot - sink.lo) * BLOCK] += drefl_val;
    }
    return;
  }
  // one warp reduction per distinct slot
  unsigned todo = __ballot_sync(FULL, a.slot >= 0);
  while (todo) {
    const int leader = __ffs(todo) - 1;
    const int slot = __shfl_sync(FULL, a.slot, leader);
    const bool mine = a.slot == slot;
    todo &= ~__ballot_sync(FULL, mine);
#pragma unroll
    for (int m = 0; m < N_COEFS; ++m)
      reduce_row(sink.acc, R.coefs + N_COEFS * slot + m, mine ? dsel[m] : 0.f);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      reduce_row(sink.acc, R.colors + 3 * slot + c, mine ? dobjc[c] : 0.f);
    if (with_refl) reduce_row(sink.acc, R.refl + slot, mine ? drefl_val : 0.f);
  }
}

// OBJ_COLS: the object rows live in the threads' columns ("columns"
// placement); CHAIN = false: bounces is 0, one stage, no per-stage array.
template <bool OBJ_COLS, bool CHAIN>
__global__ void __launch_bounds__(BLOCK, CHAIN ? MIN_BLOCKS_CHAIN : MIN_BLOCKS)
render_bwd_kernel(const float* __restrict__ g_coefs, const float* __restrict__ g_colors,
                  const float* __restrict__ g_refl, const float* __restrict__ g_lights,
                  const float* __restrict__ g_cam, const float* __restrict__ grad,
                  const float* __restrict__ aux_t, const int* __restrict__ aux_slot,
                  const int* __restrict__ aux_occ, float* __restrict__ partial,
                  float* __restrict__ g_acc, int width, int height, int rows, int n_obj,
                  int n_lights, int bounces, int col_lo, int col_hi) {
  constexpr int NREC = CHAIN ? MAX_STAGES : 1;
  const Rows R = acc_layout(n_obj, n_lights);
  if (!CHAIN) bounces = 0;
  const int n_stages = bounces + 1;

  // --- stage the tables (with a zero row for slot -1) into shared memory ---
  extern __shared__ float smem[];
  float* s_coefs = smem;
  float* s_colors = s_coefs + (n_obj + 1) * N_COEFS;
  float* s_refl = s_colors + (n_obj + 1) * 3;
  float* s_lights = s_refl + (n_obj + 1);
  float* s_cam = s_lights + n_lights * 7;
  // each warp's copy of the rows: shared memory, or this block's slice of
  // the global scratch when the rows do not fit; then the threads' columns
  float* s_acc = g_acc ? g_acc + (size_t)blockIdx.x * WARPS * R.total : s_cam + 18;
  float* s_cols = (g_acc ? s_cam + 18 : s_acc + WARPS * R.total);
  const int tid = threadIdx.x;
  // empty tables may come with a null pointer: the loop bounds keep them unread
  for (int k = tid; k < (n_obj + 1) * N_COEFS; k += BLOCK)
    s_coefs[k] = k < n_obj * N_COEFS ? g_coefs[k] : 0.f;
  for (int k = tid; k < (n_obj + 1) * 3; k += BLOCK)
    s_colors[k] = k < n_obj * 3 ? g_colors[k] : 0.f;
  for (int k = tid; k < n_obj + 1; k += BLOCK) s_refl[k] = k < n_obj ? g_refl[k] : 0.f;
  for (int k = tid; k < n_lights * 7; k += BLOCK) s_lights[k] = g_lights[k];
  for (int k = tid; k < 18; k += BLOCK) s_cam[k] = g_cam[k];
  for (int k = tid; k < WARPS * R.total; k += BLOCK) s_acc[k] = 0.f;
  for (int k = tid; k < (col_hi - col_lo) * BLOCK; k += BLOCK) s_cols[k] = 0.f;
  __syncthreads();

  const Tables T{s_coefs, s_colors, s_refl, s_lights, s_cam, n_obj, n_lights};
  const Sink sink{s_acc + (size_t)(tid >> 5) * R.total, s_cols + tid, col_lo, col_hi};
  const float bg[3] = {s_cam[14], s_cam[15], s_cam[16]};
  const size_t n_px = (size_t)rows * width;
  const float eye[3] = {s_cam[9], s_cam[10], s_cam[11]};
  const bool with_refl = CHAIN && bounces > 0;
  float cam_acc[17];  // the camera rows of every pixel this thread visits
#pragma unroll
  for (int k = 0; k < 17; ++k) cam_acc[k] = 0.f;

  // the loop bounds are the same for the whole block, so every warp takes
  // every reduction with all its lanes
  for (size_t base = (size_t)blockIdx.x * BLOCK; base < n_px; base += (size_t)gridDim.x * BLOCK) {
    const size_t pix = base + tid;
    const bool valid = pix < n_px;
    const PixelCtx px{aux_t, aux_slot, aux_occ, n_px, pix, valid};
    float g[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) g[c] = valid ? grad[3 * pix + c] : 0.f;
    // A warp whose lanes all miss at stage 0 adds only the background rows:
    // such a pixel's colour is the background, it enters no later stage,
    // and every other row value it has is 0 (its gathered rows are 0; a
    // spherical light at the eye itself, whose falloff is infinite there,
    // would make them NaN on the full path).
    if (__all_sync(FULL, px.aux(0).slot < 0)) {
#pragma unroll
      for (int c = 0; c < 3; ++c) cam_acc[14 + c] = cam_acc[14 + c] + g[c];
      continue;
    }

    // --- regenerate the primary ray (identical math to the forward) ---
    const int y_local = (int)(pix / width);
    const int x = (int)(pix - (size_t)y_local * width);
    const int y = y_local + (int)s_cam[17];
    const float ndc_x = ((float)x + 0.5f) * (float)(1.0 / (double)width);
    const float ndc_y = ((float)y + 0.5f) * (float)(1.0 / (double)height);
    const float gxf = 2.f * ndc_x - 1.f;
    const float gyf = 2.f * ndc_y - 1.f;
    const float cx = gxf * s_cam[12];
    const float cy = gyf * s_cam[13];
    const float tx = cx * s_cam[0] + cy * s_cam[3] + s_cam[6];
    const float ty = cx * s_cam[1] + cy * s_cam[4] + s_cam[7];
    const float tz = cx * s_cam[2] + cy * s_cam[5] + s_cam[8];
    const float inv_len = rsqrtf(tx * tx + ty * ty + tz * tz);
    const float d0[3] = {tx * inv_len, ty * inv_len, tz * inv_len};

    // === Phase A: rebuild the chain forward (no root solves) ===
    Stage rec[NREC];
    Geo G0;  // stage 0's geometry: Phase B reuses it when there is no chain
    {
      const float zero3[3] = {0.f, 0.f, 0.f};
      Aux a = px.aux(0);
      make_stage(T, eye, d0, a, 0, 1.f, zero3, false, 0.f, bg, rec[0], G0);
      const int stored = n_stages < NREC ? n_stages : NREC;
      for (int s = 1; s < stored; ++s) {
        const Aux a_next = px.aux(s);
        step_stage(T, rec[s - 1], s - 1, a, a_next, bg, rec[s]);
        a = a_next;
      }
    }

    // === Phase B: reverse sweep, last stage first ===
    float dc[3], dratio = 0.f, drefl_cur = 0.f;
    Stage cur = get_stage<NREC>(T, rec, n_stages - 1, px, bg);
    Aux a = px.aux(n_stages - 1);
    if (with_refl) {  // the at-cap blend
      const float rfl_b = T.refl[gather_row(T, a.slot)];
      const bool ent_b = a.slot >= 0 && rfl_b > EPS;
      const float entf = ent_b ? 1.f : 0.f;
      const float rr = cur.ratio * rfl_b;
#pragma unroll
      for (int c = 0; c < 3; ++c) dc[c] = ent_b ? g[c] * (1.f - rr) : g[c];
      const float drr = (g[0] * (bg[0] - cur.c[0]) + g[1] * (bg[1] - cur.c[1])
                         + g[2] * (bg[2] - cur.c[2])) * entf;
#pragma unroll
      for (int c = 0; c < 3; ++c) cam_acc[14 + c] = cam_acc[14 + c] + g[c] * rr * entf;
      dratio = drr * rfl_b;
      drefl_cur = drr * cur.ratio;
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) dc[c] = g[c];
    }

    float do_nxt[3] = {0.f, 0.f, 0.f}, dd_nxt[3] = {0.f, 0.f, 0.f};
    for (int s = n_stages - 1; s >= 0; --s) {
      const bool hit = a.slot >= 0;
      float dcol[3], drefl_prev = 0.f;
      Stage prev;
      Aux a_prev{0.f, -1, 0};
      if (s > 0) {
        // c_s = enter ? (1 - r_s) c_{s-1} + r_s bcol_s : c_{s-1}
        // r_s = enter ? r_{s-1} rfl_{s-1} : r_{s-1}
        prev = get_stage<NREC>(T, rec, s - 1, px, bg);
        a_prev = px.aux(s - 1);
        const float prev_rfl = T.refl[gather_row(T, a_prev.slot)];
        const bool enter_b = a_prev.slot >= 0 && prev_rfl > EPS;
        const float enterf = enter_b ? 1.f : 0.f;
        const float r_s = cur.ratio;
        float bcol[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          bcol[c] = hit ? jmin(1.f, cur.lit[c]) : bg[c];
          dcol[c] = dc[c] * r_s * enterf;
        }
        dratio = dratio + (dc[0] * (bcol[0] - prev.c[0]) + dc[1] * (bcol[1] - prev.c[1])
                           + dc[2] * (bcol[2] - prev.c[2])) * enterf;
#pragma unroll
        for (int c = 0; c < 3; ++c) dc[c] = enter_b ? dc[c] * (1.f - r_s) : dc[c];
        drefl_prev = enter_b ? dratio * prev.ratio : 0.f;
        dratio = enter_b ? dratio * prev_rfl : dratio;
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) dcol[c] = dc[c];
      }

      // stage colour: where(hit, min(1, lit), bg)
      const float hitf = hit ? 1.f : 0.f;
      float dlit[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dlit[c] = dcol[c] * hitf * (cur.lit[c] < 1.f ? 1.f : 0.f);
        cam_acc[14 + c] = cam_acc[14 + c] + dcol[c] * (1.f - hitf);
      }

      Geo G;
      if (CHAIN) geometry(T.coefs + N_COEFS * gather_row(T, a.slot), cur.o, cur.d, a.t, G);
      else G = G0;
      // cotangents from stage s+1's ray: o' = p + bias n, d' = d - 2 (d.n) n
      float dp_in[3], dn_in[3], dd_in[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dp_in[k] = do_nxt[k];
        dn_in[k] = SHADOW_BIAS * do_nxt[k];
      }
      if (s + 1 < n_stages) {
        const float nddp = G.n[0] * dd_nxt[0] + G.n[1] * dd_nxt[1] + G.n[2] * dd_nxt[2];
        const float u = cur.d[0] * G.n[0] + cur.d[1] * G.n[1] + cur.d[2] * G.n[2];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          dd_in[k] = dd_nxt[k] - 2.f * G.n[k] * nddp;
          dn_in[k] = dn_in[k] - 2.f * (nddp * cur.d[k] + u * dd_nxt[k]);
        }
      }
      float do_s[3], dd_s[3];
      stage_bwd<OBJ_COLS>(T, R, sink, G, cur.d, a, dlit, dn_in, dp_in, drefl_cur, with_refl,
                          do_s, dd_s);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        do_nxt[k] = do_s[k];
        dd_nxt[k] = dd_s[k] + dd_in[k];
      }
      drefl_cur = drefl_prev;
      if (s > 0) {
        cur = prev;
        a = a_prev;
      }
    }

    // --- camera backward: d0 = target / |target| ---
    const float dddot = d0[0] * dd_nxt[0] + d0[1] * dd_nxt[1] + d0[2] * dd_nxt[2];
    float dtg[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dtg[k] = (dd_nxt[k] - d0[k] * dddot) * inv_len;
      cam_acc[k] = cam_acc[k] + cx * dtg[k];
      cam_acc[3 + k] = cam_acc[3 + k] + cy * dtg[k];
      cam_acc[6 + k] = cam_acc[6 + k] + dtg[k];
      cam_acc[9 + k] = cam_acc[9 + k] + do_nxt[k];
    }
    const float dcx = dtg[0] * s_cam[0] + dtg[1] * s_cam[1] + dtg[2] * s_cam[2];
    const float dcy = dtg[0] * s_cam[3] + dtg[1] * s_cam[4] + dtg[2] * s_cam[5];
    cam_acc[12] = cam_acc[12] + gxf * dcx;
    cam_acc[13] = cam_acc[13] + gyf * dcy;
  }
#pragma unroll
  for (int k = 0; k < 17; ++k) reduce_row(sink.acc, R.cam + k, cam_acc[k]);

  // --- the block's column of the partial table: its warps in order, then
  // its threads' columns, row r starting at column r mod BLOCK (so the 32
  // rows a warp sums at once sit in 32 banks) ---
  __syncthreads();
  for (int r = tid; r < R.total; r += BLOCK) {
    float v = s_acc[r];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += s_acc[(size_t)w * R.total + r];
    if (r >= col_lo && r < col_hi) {
      const float* row = s_cols + (size_t)(r - col_lo) * BLOCK;
      for (int j = 0; j < BLOCK; ++j) v += row[(j + r) & (BLOCK - 1)];
    }
    partial[(size_t)r * gridDim.x + blockIdx.x] = v;
  }
}

// out[r] = sum over blocks of partial[r, :], one block per row, in a fixed
// tree: thread j sums columns j, j + 256, ... in order, then shared memory
// halves.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_rows_kernel(const float* __restrict__ partial, int n_cols, float* __restrict__ out) {
  __shared__ float buf[REDUCE_THREADS];
  const float* row = partial + (size_t)blockIdx.x * n_cols;
  float v = 0.f;
  for (int j = threadIdx.x; j < n_cols; j += REDUCE_THREADS) v += row[j];
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int h = REDUCE_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}

static_assert((BLOCK & (BLOCK - 1)) == 0 && BLOCK % 32 == 0, "BLOCK: a power of 2 warps");

// Placements of the rows (`trt_render_bwd`'s `placement`): every non-camera
// row in the threads' columns, the light rows only, or none. The plan takes
// the first of PLACEMENT_ORDER that fits: columns do no warp reduction per
// row value, light columns none for the light rows.
enum Placement { WARP = 0, LIGHT_COLUMNS = 1, COLUMNS = 2 };
constexpr int PLACEMENT_ORDER[] = {COLUMNS, LIGHT_COLUMNS, WARP};

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const float*, const float*, const int*, const int*, float*, float*, int,
                          int, int, int, int, int, int, int);

KernelFn kernel_for(int placement, bool chain) {
  if (placement == COLUMNS)
    return chain ? render_bwd_kernel<true, true> : render_bwd_kernel<true, false>;
  return chain ? render_bwd_kernel<false, true> : render_bwd_kernel<false, false>;
}

// Where a placement puts the rows: the column rows [col_lo, col_hi), the
// dynamic shared memory, and whether the warp copies live in global scratch
// (when they do not fit beside the tables).
struct Layout {
  int col_lo, col_hi;
  size_t smem_bytes;
  bool global_acc;
};

Layout layout(int n_obj, int n_lights, int placement) {
  const Rows R = acc_layout(n_obj, n_lights);
  const size_t table = (size_t)(n_obj + 1) * (N_COEFS + 3 + 1) + (size_t)n_lights * 7 + 18;
  const size_t warp_rows = (size_t)WARPS * R.total;
  const bool global_acc = sizeof(float) * (table + warp_rows) > SMEM_LIMIT;
  const int lo = placement == COLUMNS ? R.coefs : placement == LIGHT_COLUMNS ? R.lights : 0;
  const int hi = placement == COLUMNS ? R.total : placement == LIGHT_COLUMNS ? R.refl : 0;
  return Layout{lo, hi,
                sizeof(float) * (table + (global_acc ? 0 : warp_rows) + (size_t)(hi - lo) * BLOCK),
                global_acc};
}

// Shared memory past the default 48 KB must be asked for, per kernel.
cudaError_t allow_smem(KernelFn kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// The launch for a frame: out[0] the placement, the first of
// PLACEMENT_ORDER that fits in shared memory with at least 256 resident
// threads on an SM (the warp placement with at least one block); out[1]
// the blocks, one resident wave (occupancy x SMs) or fewer where the image
// is small; out[2] the floats of device scratch (the [rows, blocks] partial
// table, and the warp row copies when they do not fit in shared memory).
// Returns a CUDA error; cudaErrorInvalidConfiguration when nothing fits.
extern "C" int trt_render_bwd_plan(int width, int rows, int n_obj, int n_lights, int bounces,
                                   long long* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  for (const int p : PLACEMENT_ORDER) {
    const Layout L = layout(n_obj, n_lights, p);
    if (L.smem_bytes > SMEM_LIMIT) continue;
    const KernelFn kernel = kernel_for(p, bounces > 0);
    int occ = 0;
    if ((err = allow_smem(kernel, L.smem_bytes)) != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, BLOCK, L.smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (occ < 1 || (p != WARP && occ < MIN_RESIDENT)) continue;
    const long long need = ((long long)width * rows + BLOCK - 1) / BLOCK;
    const long long blocks = need < (long long)occ * sms ? (need > 0 ? need : 1)
                                                         : (long long)occ * sms;
    const Rows R = acc_layout(n_obj, n_lights);
    out[0] = p;
    out[1] = blocks;
    out[2] = R.total * blocks + (L.global_acc ? blocks * WARPS * R.total : 0);
    return 0;
  }
  return (int)cudaErrorInvalidConfiguration;
}

// Launch the kernel and the row reduction with the plan's placement and
// blocks (trt_render_bwd_plan's out[0] and out[1]; scratch holds out[2]
// floats).
extern "C" int trt_render_bwd(const void* coefs, const void* colors, const void* refl,
                              const void* lights, const void* cam, const void* grad,
                              const void* aux_t, const void* aux_slot, const void* aux_occ,
                              void* scratch, void* out, int width, int height, int rows,
                              int n_obj, int n_lights, int bounces, int placement, int blocks,
                              void* stream) {
  const Layout L = layout(n_obj, n_lights, placement);
  const KernelFn kernel = kernel_for(placement, bounces > 0);
  cudaError_t err = allow_smem(kernel, L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const Rows R = acc_layout(n_obj, n_lights);
  float* partial = static_cast<float*>(scratch);
  float* g_acc = L.global_acc ? partial + (size_t)R.total * blocks : nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, BLOCK, L.smem_bytes, st>>>(
      static_cast<const float*>(coefs), static_cast<const float*>(colors),
      static_cast<const float*>(refl), static_cast<const float*>(lights),
      static_cast<const float*>(cam), static_cast<const float*>(grad),
      static_cast<const float*>(aux_t), static_cast<const int*>(aux_slot),
      static_cast<const int*>(aux_occ), partial, g_acc, width, height, rows, n_obj, n_lights,
      bounces, L.col_lo, L.col_hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<R.total, REDUCE_THREADS, 0, st>>>(partial, blocks,
                                                         static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* trt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
