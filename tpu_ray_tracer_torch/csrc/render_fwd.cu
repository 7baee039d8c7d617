// Forward render kernel for Hopper (sm_90a): one thread per pixel.
//
// Replaces the forward Pallas TPU kernel of
// tpu_ray_tracer/render/pallas_backend.py (`_make_kernel`, inner `kernel`,
// launched by `_dispatch_fwd`), with and without save_aux: ray generation, the
// nearest hit over all objects (cubic slots: Cardano/trig seeds plus two
// dominant-balance seeds, a 1-D Newton screen with a residual test and the
// winner polished against the direct 20-monomial F; quadric slots: stable
// closed form and at most 2 polish steps), the normal, shading with
// shadow-ray occlusion, and the reflection chain with the at-cap background
// blend. The arithmetic follows the Pallas kernel operation for operation;
// render/fwd_kernel.py holds the plain PyTorch version of the same math.
//
// save_aux (three non-null aux pointers, [bounces + 1, rows, width] each)
// also stores, per chain stage, what the backward kernel (render_bwd.cu)
// replays the stage from without a root solve: the hit distance (0 on a
// miss), the permuted hit slot (-1) and the i32 occlusion bitmask (Pallas
// :1025-1029, :1084-1088). A bounce stage keeps t and slot only where the
// lane advanced into it and the bits only where it entered. Stages past the
// thread's early exit from the bounce loop keep 0 / -1 / 0, written before
// the chain starts. The image arithmetic is the same with and without aux:
// the aux stores sit behind a runtime pointer test.
//
// What bounds it on this card: f32 operations. The only device-memory
// traffic is the framebuffer (12 B a pixel, 11 MB at 1280x720: 3.3 us at
// 3.35 TB/s); the scene tables are a few KB staged once per block into
// shared memory. The work is the root solves (per cubic slot the ray
// expansion, the seeds with their powf and cosf, 5 screens of 3 Newton
// steps, the 3-step polish on the 20-monomial F), the per-object F, grad F
// and Hessian at the shadow origin, and the shadow tests. Counted along the
// path each pixel takes (render/bounds.py `fwd_work`, with the branch
// shares of the kernel's own aux: the stage's hit, each light lit, occluded
// or facing away): dingdong 1280x720 needs 2378 f32 operations a pixel (FMA
// = 2, the math functions at their SASS counts), 2.2e9 in all, 0.033 ms at
// 67 TFLOP/s; 20spheres 2536 a pixel. Measured on an H100 (700 W,
// chip_smoke.py and kernel_ab.py, PERF.md): 0.128 ms on dingdong, 26% of
// that bound (the first design: 0.161 ms); 20spheres 0.174 ms (0.193), 10%.
//
// What the design does about it:
// - the main path's iteration counts (polish 3, screen 3, shadow 1) and the
//   presence of a reflection chain are template parameters, so every Newton,
//   screen and candidate loop unrolls; a generic instantiation of the same
//   source takes runtime counts for any other setting (`trt_render_fwd`'s
//   `variant`, chosen by the wrapper): the generic one takes 12% longer on
//   dingdong;
// - the object loops run over a cubic range and a quadric range with each
//   solver inlined: no call frames, no runtime test of the slot's kind, no
//   local arrays (the first design spilled 108 bytes at 96 registers; the
//   main instantiation takes 72 registers and spills nothing);
// - each object's coefficients are read from shared memory into registers
//   once per object, not at every use;
// - stage 0 forms each slot's t-polynomial from eye-hoisted coefficients
//   (`eye_coeffs`, once per block): 47 operations a pixel for the cubic
//   slot where the binomial expansion takes 290;
// - the reflection chain is one loop over stages around a single inlined
//   trace-and-shade, so the chain does not double the code;
// - the occlusion loops read only a light's shadow-ray direction; its
//   Lambert factor and falloff are computed in the pending test and in the
//   final sum only;
// - 16x8 blocks with at least 6 resident per SM, the fastest point of the
//   block-shape sweep.
// What stops it short of half its bound (measured by kernel_ab.py and
// kernel_bench.py; there is no per-instruction profiler on the card): its
// instruction mix. Of the main instantiation's 5717 SASS instructions (a
// static count) 46% are f32 arithmetic (at 1.56 counted operations each,
// against the 2 of an FFMA), the rest integer and address arithmetic (25%),
// control (12%), compares and selects (10%) and loads (5%). Executed in
// that mix, one instruction per scheduler and cycle reaches 36% of the
// bound; it runs at 72% of that.
// Divergence costs little on dingdong: a warp reaches the root solves, the
// polish, the shading and the shadow tests with 31.3 to 32 of its 32 lanes
// active (20spheres: 23.5 in its shadow tests, 25.7 in the shading).
//
// The TPU kernel's tile-uniform skips become per-thread exits: a miss skips
// shading, a light that does not face the point (lambert factor 0) skips its
// occlusion tests, an occluded light stops testing further objects, and the
// bounce loop ends once the thread stops reflecting. None of these changes
// a result.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "poly.cuh"

namespace {

constexpr float MAX_T = 1e6f;
constexpr float RESIDUAL_TOL = 1e-5f;
constexpr float FAKE_ROOT = 2e6f;
constexpr float BIG_ROOT = 2.0f * FAKE_ROOT;
constexpr double TWO_THIRD_PI_D = PI_D * 2.0 / 3.0;
constexpr float TTP1 = (float)TWO_THIRD_PI_D;
constexpr float TTP2 = (float)(2.0 * TWO_THIRD_PI_D);
constexpr float PI_F = (float)PI_D;
constexpr float ONE_THIRD = (float)(1.0 / 3.0);
// 16x8 blocks (warps of 16x2 pixels) with at least 6 resident per SM (at
// most 80 registers): the fastest point of the block-shape sweep of
// kernel_ab.py on both dingdong and 20spheres (PERF.md)
constexpr int BLOCK_X = 16;
constexpr int BLOCK_Y = 8;
constexpr int MIN_BLOCKS = 6;

// Iteration counts: compile-time on the main path, runtime in the generic
// instantiation. Both answer the same three questions.
template <int POLISH, int SCREEN, int SHADOW>
struct FixedIters {
  __device__ __forceinline__ constexpr int polish() const { return POLISH; }
  __device__ __forceinline__ constexpr int screen() const { return SCREEN; }
  __device__ __forceinline__ constexpr int shadow() const { return SHADOW; }
};
struct RuntimeIters {
  int polish_, screen_, shadow_;
  __device__ __forceinline__ int polish() const { return polish_; }
  __device__ __forceinline__ int screen() const { return screen_; }
  __device__ __forceinline__ int shadow() const { return shadow_; }
};
using MainIters = FixedIters<3, 3, 1>;  // kernel_backend.py's defaults

__host__ __device__ constexpr int binom3(int n, int k) {  // n <= 3
  return (k == 0 || k == n) ? 1 : (n == 3 ? 3 : 2);
}

// sign(x) * |x|^(1/3), the Pallas kernel's seed-level cube root (:97).
__device__ __forceinline__ float cbrt_seed(float x) {
  const float p = powf(fabsf(x), ONE_THIRD);
  return x > 0.f ? p : (x < 0.f ? -p : x * p);
}

// Abramowitz & Stegun 4.4.45 polynomial acos, |err| < 7e-5 rad (:102).
__device__ __forceinline__ float acos_seed(float x) {
  const float ax = fabsf(x);
  const float p = 1.5707288f + ax * (-0.2121144f + ax * (0.0742610f + ax * (-0.0187293f)));
  const float pos = sqrtf(jmax(1.f - ax, 0.f)) * p;
  return x < 0.f ? PI_F - pos : pos;
}

// An object's coefficients [M_START, 20) from shared memory into registers.
template <int M_START>
__device__ __forceinline__ void load_coefs(const float* src, float c[N_COEFS]) {
#pragma unroll
  for (int m = 0; m < N_COEFS; ++m) c[m] = m < M_START ? 0.f : src[m];
}

// [Hxx, Hyy, Hzz, Hxy, Hxz, Hyz] of F at P (Pallas `_hessian_entries`, :208).
__device__ __forceinline__ void hessian(const float* c, const Pow3& P, float h[6]) {
  const int pa[6] = {0, 1, 2, 0, 0, 1};
  const int pb[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int a = pa[q], b = pb[q];
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < N_COEFS; ++m) {
      int e[3] = {mpow(m, 0), mpow(m, 1), mpow(m, 2)};
      float fac;
      if (a == b) {
        if (e[a] < 2) continue;
        fac = (float)(e[a] * (e[a] - 1));
        e[a] -= 2;
      } else {
        if (e[a] == 0 || e[b] == 0) continue;
        fac = (float)(e[a] * e[b]);
        e[a] -= 1;
        e[b] -= 1;
      }
      acc += c[m] * (mono(P, e[0], e[1], e[2]) * fac);
    }
    h[q] = acc;
  }
}

// Coefficients t[k] of F(o + t d) for k <= K_MAX over monomials [M_START, 20)
// (Pallas `_ray_coeffs_scalar`, :142; the binomial expansion of ops/poly.py
// `_EXPANSION`, walked in the same order).
template <int M_START, int K_MAX>
__device__ __forceinline__ void ray_coeffs(const float* c, const Pow3& O,
                                           const Pow3& D, float t[K_MAX + 1]) {
#pragma unroll
  for (int k = 0; k <= K_MAX; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int m = M_START; m < N_COEFS; ++m) {
      const int px = mpow(m, 0), py = mpow(m, 1), pz = mpow(m, 2);
      if (k > px + py + pz) continue;
      float ts = 0.f;
#pragma unroll
      for (int jx = 0; jx <= 3; ++jx) {
#pragma unroll
        for (int jy = 0; jy <= 3; ++jy) {
#pragma unroll
          for (int jz = 0; jz <= 3; ++jz) {
            if (jx > px || jy > py || jz > pz || jx + jy + jz != k) continue;
            float term = mono(O, px - jx, py - jy, pz - jz) * mono(D, jx, jy, jz);
            const int w = binom3(px, jx) * binom3(py, jy) * binom3(pz, jz);
            if (w != 1) term = term * (float)w;
            ts += term;
          }
        }
      }
      acc += c[m] * ts;
    }
    t[k] = acc;
  }
}

// Stage 0's ray expansion with the eye hoisted: every primary ray leaves
// the eye e, so F(e + t d) = sum_k t^k sum_{deg n = k} q[n] d^(p_n), where
// q[n] = sum_{m : p_m >= p_n} c[m] w(p_m, p_n) e^(p_m - p_n) depends on the
// object and the eye only (computed once per block, `eye_coeffs`); a pixel
// then forms t_k from its direction's monomials. render_fwd_plain computes
// stage 0 the same way (`_eye_coeffs`, `_eye_ray_coeffs`).
__device__ __forceinline__ void eye_coeffs(const float* c, const Pow3& E, float q[N_COEFS]) {
#pragma unroll
  for (int n = 0; n < N_COEFS; ++n) {
    const int jx = mpow(n, 0), jy = mpow(n, 1), jz = mpow(n, 2);
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < N_COEFS; ++m) {
      const int px = mpow(m, 0), py = mpow(m, 1), pz = mpow(m, 2);
      if (jx > px || jy > py || jz > pz) continue;
      float term = mono(E, px - jx, py - jy, pz - jz);
      const int w = binom3(px, jx) * binom3(py, jy) * binom3(pz, jz);
      if (w != 1) term = term * (float)w;
      acc += c[m] * term;
    }
    q[n] = acc;
  }
}

template <int M_START, int K_MAX>
__device__ __forceinline__ void eye_ray_coeffs(const float* q, const Pow3& D,
                                               float t[K_MAX + 1]) {
#pragma unroll
  for (int k = 0; k <= K_MAX; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int n = M_START; n < N_COEFS; ++n) {
      const int jx = mpow(n, 0), jy = mpow(n, 1), jz = mpow(n, 2);
      if (jx + jy + jz != k) continue;
      acc += q[n] * mono(D, jx, jy, jz);
    }
    t[k] = acc;
  }
}

__device__ __forceinline__ float newton_step(float t, float f, float df) {
  const float step = fabsf(df) > 1e-12f ? f / df : 0.f;
  const float tn = t - step;
  return isfinite(tn) ? tn : t;
}

// Newton against the direct F, then (REJECT) the residual test
// (Pallas `_polish`, :239).
template <int M_START, bool REJECT>
__device__ __forceinline__ float polish(const float* c, float ox, float oy, float oz,
                                        float dx, float dy, float dz, float t, int iters) {
  const float seed = t;
  float f, mag, g[3];
#pragma unroll
  for (int it = 0; it < iters; ++it) {
    const Pow3 P = powers(ox + t * dx, oy + t * dy, oz + t * dz);
    eval_F<M_START, false, true>(c, P, f, mag, g);
    t = newton_step(t, f, g[0] * dx + g[1] * dy + g[2] * dz);
  }
  if (!REJECT) return t;
  const Pow3 P = powers(ox + t * dx, oy + t * dy, oz + t * dz);
  eval_F<M_START, true, false>(c, P, f, mag, g);
  const bool genuine = fabsf(f) <= RESIDUAL_TOL * mag;
  return genuine ? t : (seed < 0.f ? seed : FAKE_ROOT);
}

struct Cubic {
  float t3, t2, t1, t0;
  __device__ __forceinline__ float f(float t) const { return ((t3 * t + t2) * t + t1) * t + t0; }
  __device__ __forceinline__ float df(float t) const { return (3.f * t3 * t + 2.f * t2) * t + t1; }
  __device__ __forceinline__ float mag(float t) const {
    const float at = fabsf(t);
    return fabsf(t3) * at * at * at + fabsf(t2) * at * at + fabsf(t1) * at + fabsf(t0) + 1e-30f;
  }
  __device__ __forceinline__ float newton(float t, int iters) const {
#pragma unroll
    for (int i = 0; i < iters; ++i) t = newton_step(t, f(t), df(t));
    return t;
  }
  __device__ __forceinline__ bool residual_ok(float t) const {
    return fabsf(f(t)) <= RESIDUAL_TOL * mag(t);
  }
  // the 1-D candidate screen of `_solve_object` (`pol`, :306)
  __device__ __forceinline__ float screen(float t, int iters) const {
    const float seed = t;
    t = newton(t, iters);
    return residual_ok(t) ? t : (seed < 0.f ? seed : FAKE_ROOT);
  }
  // three scale-normalised Cardano/trig seeds; Delta > 0 puts the Cardano
  // root in the first slot (`_solve_object` :324-358, `cubic_occ_one` :815-842)
  __device__ __forceinline__ void seeds(float& r0, float& r1, float& r2) const {
    const float s3 = fabsf(t3) > EPS ? t3 : 1.f;
    float a = t2 / s3, b = t1 / s3, c = t0 / s3;
    const float s = jmax(jmax(fabsf(a), sqrtf(fabsf(b))), jmax(cbrt_seed(fabsf(c)), 1e-30f));
    a = a / s;
    b = b / (s * s);
    c = c / (s * s * s);
    const float q = (3.f * b - a * a) / 9.f;
    const float r = (9.f * a * b - 27.f * c - 2.f * a * a * a) / 54.f;
    const float delta = q * q * q + r * r;
    const float sq_delta = sqrtf(jmax(delta, 0.f));
    const float q_neg = jmax(-q, 0.f);
    const float denom = sqrtf(q_neg * q_neg * q_neg);
    const float ratio = jmin(jmax(r / (denom == 0.f ? 1.f : denom), -1.f), 1.f);
    const float theta = acos_seed(ratio) / 3.f;
    const float two_sq = 2.f * sqrtf(q_neg);
    const float a3 = a / 3.f;
    const float first = delta > 0.f ? cbrt_seed(r + sq_delta) + cbrt_seed(r - sq_delta)
                                    : two_sq * cosf(theta);
    r0 = s * (first - a3);
    r1 = s * (two_sq * cosf(theta + TTP1) - a3);
    r2 = s * (two_sq * cosf(theta + TTP2) - a3);
  }
};

// Cancellation-stable quadratic roots in the reference's (lo, hi) order.
__device__ __forceinline__ float stable_quad_roots(float t2, float t1, float t0,
                                                   float& lo, float& hi) {
  const float disc = t1 * t1 - 4.f * t2 * t0;
  const float s = sqrtf(jmax(disc, 0.f));
  const float sgn = t1 >= 0.f ? 1.f : -1.f;
  const float qq = -0.5f * (t1 + sgn * s);
  const float r_q = qq / (fabsf(t2) > EPS ? t2 : 1.f);
  const float r_c = fabsf(qq) > 0.f ? t0 / qq : -1.f;
  lo = t1 >= 0.f ? r_q : r_c;
  hi = t1 >= 0.f ? r_c : r_q;
  return disc;
}

// Root for a cubic slot (Pallas `_solve_object`, :263-405), from the ray's
// t-polynomial tc.
template <class It>
__device__ __forceinline__ float solve_cubic(const float* c, const float tc[4], float ox,
                                             float oy, float oz, float dx, float dy, float dz,
                                             It I) {
  const Cubic p{tc[3], tc[2], tc[1], tc[0]};
  const bool is_cubic = fabsf(p.t3) > EPS;
  const bool is_quad = fabsf(p.t2) > EPS;
  if (!is_cubic && !is_quad) return fabsf(p.t1) > EPS ? -p.t0 / p.t1 : -1.f;

  const float sq2 = is_quad ? p.t2 : 1.f;
  const float qdisc = p.t1 * p.t1 - 4.f * p.t2 * p.t0;
  const float qsq = sqrtf(jmax(qdisc, 0.f));
  const float sub_lo = p.screen((-p.t1 - qsq) / (2.f * sq2), I.screen());
  const float sub_hi = p.screen((-p.t1 + qsq) / (2.f * sq2), I.screen());
  if (is_cubic) {
    float s0, s1, s2;
    p.seeds(s0, s1, s2);
    const float cands[5] = {p.screen(s0, I.screen()), p.screen(s1, I.screen()),
                            p.screen(s2, I.screen()), sub_lo, sub_hi};
    float root = BIG_ROOT;
#pragma unroll
    for (int i = 0; i < 5; ++i)
      if (cands[i] >= EPS && cands[i] < root) root = cands[i];
    if (root < FAKE_ROOT)
      root = polish<0, true>(c, ox, oy, oz, dx, dy, dz, root, I.polish());
    return root >= BIG_ROOT ? -1.f : root;
  }
  float root = qdisc < 0.f ? -1.f : (sub_lo >= EPS ? sub_lo : sub_hi);
  if (qdisc >= 0.f && root < FAKE_ROOT)
    root = polish<0, false>(c, ox, oy, oz, dx, dy, dz, root, I.polish());
  return root;
}

// Root for a quadric slot (Pallas `_solve_quadric`, :408-453), from the
// ray's t-polynomial tc.
template <class It>
__device__ __forceinline__ float solve_quadric(const float* c, const float tc[3], float ox,
                                               float oy, float oz, float dx, float dy,
                                               float dz, It I) {
  const float t2 = tc[2], t1 = tc[1], t0 = tc[0];
  if (!(fabsf(t2) > EPS)) return fabsf(t1) > EPS ? -t0 / t1 : -1.f;
  float lo, hi;
  const float disc = stable_quad_roots(t2, t1, t0, lo, hi);
  if (disc < 0.f) return -1.f;
  return polish<QUAD_START, false>(c, ox, oy, oz, dx, dy, dz, lo >= EPS ? lo : hi,
                                   I.polish() < 2 ? I.polish() : 2);
}

// Occlusion by a degree <= 2 t-polynomial from signs alone (Pallas
// `quadlin_occ_coeffs`, :665-752). The posdef / unbounded specialisations
// answer differently from the generic test in geometry beyond MAX_T, so they
// are taken exactly where the Pallas kernel takes them.
__device__ __forceinline__ bool quadlin_occ(float t2, float t1, float t0, float max_t,
                                            bool posdef, bool unbounded) {
  const float E = EPS;
  const float fE = (t2 * E + t1) * E + t0;
  const float gE = 2.f * t2 * E + t1;
  const bool disc_ok = t1 * t1 - 4.f * t2 * t0 >= 0.f;
  if (posdef && unbounded) return disc_ok && (fE < 0.f || gE < 0.f);
  const float fM = (t2 * max_t + t1) * max_t + t0;
  const float gM = 2.f * t2 * max_t + t1;
  const bool a_pos = fE > 0.f && gE < 0.f && (fM < 0.f || gM > 0.f);
  const bool b_pos = fE < 0.f && fM > 0.f && gM > 0.f;
  const bool occ_pos = disc_ok && (a_pos || b_pos);
  if (posdef) return occ_pos;
  if (fabsf(t2) > EPS) {
    const bool occ_neg = disc_ok && (fE > 0.f || gE > 0.f) && fM < 0.f && gM < 0.f;
    return t2 > 0.f ? occ_pos : occ_neg;
  }
  if (!(fabsf(t1) > EPS)) return false;
  const float a = -t0;
  return t1 > 0.f ? (a > E * t1 && a < max_t * t1) : (a < E * t1 && a > max_t * t1);
}

// Occlusion by a cubic slot (Pallas `cubic_occ_one`, :771-853).
__device__ __forceinline__ bool cubic_occ(float t3, const float h[6], const float g0[3],
                                          float f0, float sdx, float sdy, float sdz,
                                          float max_t, int shadow_iters) {
  const float t2 = 0.5f * (h[0] * (sdx * sdx) + h[1] * (sdy * sdy) + h[2] * (sdz * sdz))
                 + h[3] * (sdx * sdy) + h[4] * (sdx * sdz) + h[5] * (sdy * sdz);
  const float t1 = g0[0] * sdx + g0[1] * sdy + g0[2] * sdz;
  if (!(fabsf(t3) > EPS)) return quadlin_occ(t2, t1, f0, max_t, false, false);
  const Cubic p{t3, t2, t1, f0};
  float cands[5];
  p.seeds(cands[0], cands[1], cands[2]);
  stable_quad_roots(t2, t1, f0, cands[3], cands[4]);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float t = p.newton(cands[i], shadow_iters);
    if (p.residual_ok(t) && t > EPS && t < max_t) return true;
  }
  return false;
}

// Scene tables staged in shared memory for the whole block.
struct Tables {
  const float* coefs;  // [N, 20]
  const float* colors; // [N, 3]
  const float* lights; // [L, 7]
  const float* dtab;   // [L, N]
  const int* orig;     // [N]
  const int* posdef;   // [N]
  int n_obj, n_cubic, n_lights;
};

struct Hit {
  bool hit;
  int idx;
  float t;  // the hit distance, 0 on a miss
  float px, py, pz, nx, ny, nz;
};

// Nearest valid hit over all slots (Pallas `nearest_hit`, :535-579): strict
// `<` with ties to the lower original index, then the point and the normal.
// Cubic slots first, then quadrics: the slot order of the tables. `eyeq`
// (stage 0: the rays leave the eye) holds each slot's eye-hoisted
// coefficients, else null.
template <class It>
__device__ __forceinline__ Hit trace(const Tables& T, const float* eyeq, float ox, float oy,
                                     float oz, float dx, float dy, float dz, It I) {
  float best_t = MAX_T;
  int best_idx = -1, best_orig = 1 << 30;
  auto take = [&](int i, float t) {
    const int orig = T.orig[i];
    if (t >= EPS && t < MAX_T && (t < best_t || (t == best_t && orig < best_orig))) {
      best_t = t;
      best_idx = i;
      best_orig = orig;
    }
  };
  const Pow3 D = powers(dx, dy, dz);
#pragma unroll 1
  for (int i = 0; i < T.n_cubic; ++i) {
    float c[N_COEFS], tc[4];
    load_coefs<0>(T.coefs + i * N_COEFS, c);
    if (eyeq) {
      float q[N_COEFS];
      load_coefs<0>(eyeq + i * N_COEFS, q);
      eye_ray_coeffs<0, 3>(q, D, tc);
    } else {
      ray_coeffs<0, 3>(c, powers(ox, oy, oz), D, tc);
    }
    take(i, solve_cubic(c, tc, ox, oy, oz, dx, dy, dz, I));
  }
#pragma unroll 1
  for (int i = T.n_cubic; i < T.n_obj; ++i) {
    float c[N_COEFS], tc[3];
    load_coefs<QUAD_START>(T.coefs + i * N_COEFS, c);
    if (eyeq) {
      float q[N_COEFS];
      load_coefs<QUAD_START>(eyeq + i * N_COEFS, q);
      eye_ray_coeffs<QUAD_START, 2>(q, D, tc);
    } else {
      ray_coeffs<QUAD_START, 2>(c, powers(ox, oy, oz), D, tc);
    }
    take(i, solve_quadric(c, tc, ox, oy, oz, dx, dy, dz, I));
  }
  Hit h;
  h.hit = best_idx >= 0;
  h.idx = best_idx;
  const float t = h.hit ? best_t : 0.f;
  h.t = t;
  h.px = ox + t * dx;
  h.py = oy + t * dy;
  h.pz = oz + t * dz;
  h.nx = h.ny = h.nz = 0.f;
  if (h.hit) {  // normal = normalized grad F (Pallas `normal_at`, :943)
    float c[N_COEFS];
    load_coefs<0>(T.coefs + best_idx * N_COEFS, c);
    float f, mag, g[3];
    eval_F<0, false, true>(c, powers(h.px, h.py, h.pz), f, mag, g);
    const float norm = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
    const float inv = 1.f / (norm > 0.f ? norm : 1.f);
    h.nx = g[0] * inv;
    h.ny = g[1] * inv;
    h.nz = g[2] * inv;
  }
  return h;
}

// A light's shadow ray from a point: direction (unnormalised to-light for a
// spherical light) and the far end of the occlusion interval.
struct ShadowRay {
  bool spherical;
  float sdx, sdy, sdz, max_t;
};

__device__ __forceinline__ ShadowRay shadow_ray(const float* L, const Hit& h) {
  ShadowRay r;
  r.spherical = L[0] > 0.5f;
  if (r.spherical) {
    r.sdx = L[1] - h.px;
    r.sdy = L[2] - h.py;
    r.sdz = L[3] - h.pz;
    r.max_t = 1.f;
  } else {
    r.sdx = L[1];
    r.sdy = L[2];
    r.sdz = L[3];
    r.max_t = MAX_T;
  }
  return r;
}

// A light's Lambert factor and colour scale at a point with normal n.
struct Lambert {
  float lam, cscale;
};

__device__ __forceinline__ Lambert lambert(const ShadowRay& r, const Hit& h) {
  Lambert w;
  if (r.spherical) {
    const float dist2 = r.sdx * r.sdx + r.sdy * r.sdy + r.sdz * r.sdz;
    const float inv_dn = rsqrtf(dist2 > 0.f ? dist2 : 1.f);
    w.lam = jmax(0.f, h.nx * (r.sdx * inv_dn) + h.ny * (r.sdy * inv_dn) + h.nz * (r.sdz * inv_dn));
    w.cscale = 1.f / (FOUR_PI * dist2);
  } else {
    w.lam = jmax(0.f, h.nx * r.sdx + h.ny * r.sdy + h.nz * r.sdz);
    w.cscale = 1.f;
  }
  return w;
}

// Shadow-tested Lambertian sum over lights, clamped to 1 (Pallas `shade`,
// :596-941). Lights go in chunks of 32 (one bitmask word); within a chunk
// the loops run objects outer (cubic slots, then quadric slots) and lights
// inner, so each object's F, grad F and Hessian at the shadow origin are
// computed once per chunk. Returns the occlusion bits of the first chunk
// (lights 0-31), the aux bitmask. A light that does not face the point
// (lambert factor 0) is never tested, so its bit stays 0 where the Pallas
// kernel may set it; nothing reads such a bit: the backward multiplies it by
// ndotl <= 0 terms that are 0 (dndotl, the colour and distance cotangents)
// whatever it holds.
template <class It>
__device__ __forceinline__ uint32_t shade(const Tables& T, const Hit& h, It I, float out[3]) {
  const float* col = T.colors + 3 * h.idx;
  const Pow3 S = powers(h.px + SHADOW_BIAS * h.nx, h.py + SHADOW_BIAS * h.ny,
                        h.pz + SHADOW_BIAS * h.nz);
  float acc[3] = {0.f, 0.f, 0.f};
  uint32_t bits0 = 0u;
#pragma unroll 1
  for (int l0 = 0; l0 < T.n_lights; l0 += 32) {
    const int nl = T.n_lights - l0 < 32 ? T.n_lights - l0 : 32;
    uint32_t pending = 0u, occluded = 0u;
#pragma unroll 1
    for (int j = 0; j < nl; ++j)
      if (lambert(shadow_ray(T.lights + 7 * (l0 + j), h), h).lam != 0.f) pending |= 1u << j;
#pragma unroll 1
    for (int i = 0; i < T.n_cubic && pending; ++i) {
      float c[N_COEFS];
      load_coefs<0>(T.coefs + i * N_COEFS, c);
      float f0, mag, g0[3], hs[6];
      eval_F<0, false, true>(c, S, f0, mag, g0);
      hessian(c, S, hs);
#pragma unroll 1
      for (uint32_t bits = pending; bits; bits &= bits - 1) {
        const int j = __ffs(bits) - 1;
        const int li = l0 + j;
        const ShadowRay sr = shadow_ray(T.lights + 7 * li, h);
        float t3;
        if (sr.spherical) {
          const Pow3 SD = powers(sr.sdx, sr.sdy, sr.sdz);
          t3 = 0.f;
#pragma unroll
          for (int m = 0; m < QUAD_START; ++m)
            t3 += c[m] * mono(SD, mpow(m, 0), mpow(m, 1), mpow(m, 2));
        } else {
          t3 = T.dtab[li * T.n_obj + i];
        }
        if (cubic_occ(t3, hs, g0, f0, sr.sdx, sr.sdy, sr.sdz, sr.max_t, I.shadow())) {
          occluded |= 1u << j;
          pending &= ~(1u << j);
        }
      }
    }
#pragma unroll 1
    for (int i = T.n_cubic; i < T.n_obj && pending; ++i) {
      float c[N_COEFS];
      load_coefs<QUAD_START>(T.coefs + i * N_COEFS, c);
      float f0, mag, g0[3];
      eval_F<QUAD_START, false, true>(c, S, f0, mag, g0);
      const bool pd = T.posdef[i] != 0;
#pragma unroll 1
      for (uint32_t bits = pending; bits; bits &= bits - 1) {
        const int j = __ffs(bits) - 1;
        const int li = l0 + j;
        const ShadowRay sr = shadow_ray(T.lights + 7 * li, h);
        const float sdx = sr.sdx, sdy = sr.sdy, sdz = sr.sdz;
        const float t2 = sr.spherical
            ? c[10] * (sdx * sdx) + c[11] * (sdy * sdy) + c[12] * (sdz * sdz)
                  + c[13] * (sdx * sdy) + c[14] * (sdx * sdz) + c[15] * (sdy * sdz)
            : T.dtab[li * T.n_obj + i];
        const float t1 = g0[0] * sdx + g0[1] * sdy + g0[2] * sdz;
        if (quadlin_occ(t2, t1, f0, sr.max_t, pd, !sr.spherical)) {
          occluded |= 1u << j;
          pending &= ~(1u << j);
        }
      }
    }
#pragma unroll 1
    for (int j = 0; j < nl; ++j) {
      const float* L = T.lights + 7 * (l0 + j);
      const Lambert lw = lambert(shadow_ray(L, h), h);
      const float w = (occluded >> j) & 1u ? 0.f : lw.lam * INV_PI;
      const float scale = lw.cscale * w;
      acc[0] = acc[0] + col[0] * L[4] * scale;
      acc[1] = acc[1] + col[1] * L[5] * scale;
      acc[2] = acc[2] + col[2] * L[6] * scale;
    }
    if (l0 == 0) bits0 = occluded;
  }
  out[0] = jmin(1.f, acc[0]);
  out[1] = jmin(1.f, acc[1]);
  out[2] = jmin(1.f, acc[2]);
  return bits0;
}

// CHAIN = false: bounces is 0 and the reflection code is compiled out.
template <class It, bool CHAIN>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y, MIN_BLOCKS)
render_fwd_kernel(const float* __restrict__ g_coefs, const int* __restrict__ g_orig,
                  const float* __restrict__ g_colors, const float* __restrict__ g_refl,
                  const float* __restrict__ g_lights, const float* __restrict__ g_dtab,
                  const int* __restrict__ g_posdef, const float* __restrict__ g_cam,
                  float* __restrict__ out, float* __restrict__ aux_t,
                  int* __restrict__ aux_slot, int* __restrict__ aux_occ, int width,
                  int height, int rows, int n_obj, int n_cubic, int n_lights, It I,
                  int bounces) {
  // --- stage the scene tables (a few KB) into shared memory ---
  extern __shared__ float smem[];
  float* s_coefs = smem;
  float* s_colors = s_coefs + n_obj * N_COEFS;
  float* s_refl = s_colors + n_obj * 3;
  float* s_lights = s_refl + n_obj;
  float* s_dtab = s_lights + n_lights * 7;
  float* s_cam = s_dtab + n_lights * n_obj;
  int* s_orig = reinterpret_cast<int*>(s_cam + 18);
  int* s_posdef = s_orig + n_obj;
  float* s_eyeq = reinterpret_cast<float*>(s_posdef + n_obj);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  // empty tables may come with a null pointer: the loop bounds keep them unread
  for (int k = tid; k < n_obj * N_COEFS; k += nthreads) s_coefs[k] = g_coefs[k];
  for (int k = tid; k < n_obj * 3; k += nthreads) s_colors[k] = g_colors[k];
  for (int k = tid; k < n_obj; k += nthreads) {
    s_refl[k] = g_refl[k];
    s_orig[k] = g_orig[k];
    s_posdef[k] = g_posdef[k];
  }
  for (int k = tid; k < n_lights * 7; k += nthreads) s_lights[k] = g_lights[k];
  for (int k = tid; k < n_lights * n_obj; k += nthreads) s_dtab[k] = g_dtab[k];
  for (int k = tid; k < 18; k += nthreads) s_cam[k] = g_cam[k];
  __syncthreads();
  {  // each slot's eye-hoisted coefficients for stage 0
    const Pow3 E = powers(s_cam[9], s_cam[10], s_cam[11]);
    for (int i = tid; i < n_obj; i += nthreads) {
      float c[N_COEFS], q[N_COEFS];
      load_coefs<0>(s_coefs + i * N_COEFS, c);
      eye_coeffs(c, E, q);
#pragma unroll
      for (int n = 0; n < N_COEFS; ++n) s_eyeq[i * N_COEFS + n] = q[n];
    }
  }
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y_local = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y_local >= rows) return;

  const Tables T{s_coefs, s_colors, s_lights, s_dtab, s_orig, s_posdef, n_obj, n_cubic,
                 n_lights};
  if (!CHAIN) bounces = 0;

  // --- ray generation (Pallas kernel :984-1016) ---
  const int y = y_local + (int)s_cam[17];
  const float ndc_x = ((float)x + 0.5f) * (float)(1.0 / (double)width);
  const float ndc_y = ((float)y + 0.5f) * (float)(1.0 / (double)height);
  const float cx = (2.f * ndc_x - 1.f) * s_cam[12];
  const float cy = (2.f * ndc_y - 1.f) * s_cam[13];
  const float tx = cx * s_cam[0] + cy * s_cam[3] + s_cam[6];
  const float ty = cx * s_cam[1] + cy * s_cam[4] + s_cam[7];
  const float tz = cx * s_cam[2] + cy * s_cam[5] + s_cam[8];
  const float inv_len = rsqrtf(tx * tx + ty * ty + tz * tz);
  float dx = tx * inv_len, dy = ty * inv_len, dz = tz * inv_len;
  float ox = s_cam[9], oy = s_cam[10], oz = s_cam[11];
  const float bg[3] = {s_cam[14], s_cam[15], s_cam[16]};

  // aux of stage s for this pixel sits at s * stage + pix
  const bool save_aux = aux_t != nullptr;
  const size_t pix = (size_t)y_local * width + x;
  const size_t stage = (size_t)rows * width;
  if (save_aux) {
    for (int s = 0; s <= bounces; ++s) {
      aux_t[s * stage + pix] = 0.f;
      aux_slot[s * stage + pix] = -1;
      aux_occ[s * stage + pix] = 0;
    }
  }

  // --- stage 0, then the reflection chain (Pallas kernel :1031-1130): one
  // trace-and-shade per entered stage; a stage that misses ends the chain,
  // and a hit at the cap stage blends in the background ---
  float result[3];
  float ratio = 1.f;
#pragma unroll 1
  for (int k = 0;; ++k) {
    const Hit h = trace(T, k == 0 ? s_eyeq : nullptr, ox, oy, oz, dx, dy, dz, I);
    float col[3] = {bg[0], bg[1], bg[2]};
    if (h.hit) {
      const uint32_t bits = shade(T, h, I, col);
      if (save_aux) {  // stage 0, or entered and hit: the lane advances into stage k
        aux_t[k * stage + pix] = h.t;
        aux_slot[k * stage + pix] = h.idx;
        aux_occ[k * stage + pix] = (int)bits;
      }
    }
    if (k == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) result[c] = col[c];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) result[c] = (1.f - ratio) * result[c] + ratio * col[c];
    }
    if (!CHAIN || !h.hit) break;
    const float refl_c = s_refl[h.idx];
    if (k == bounces) {  // at-cap background blend
      if (bounces > 0 && refl_c > EPS) {
        const float rr = ratio * refl_c;
#pragma unroll
        for (int c = 0; c < 3; ++c) result[c] = (1.f - rr) * result[c] + rr * bg[c];
      }
      break;
    }
    if (!(refl_c > EPS)) break;
    ratio = ratio * refl_c;
    const float dot = dx * h.nx + dy * h.ny + dz * h.nz;
    ox = h.px + SHADOW_BIAS * h.nx;
    oy = h.py + SHADOW_BIAS * h.ny;
    oz = h.pz + SHADOW_BIAS * h.nz;
    dx = dx - 2.f * dot * h.nx;
    dy = dy - 2.f * dot * h.ny;
    dz = dz - 2.f * dot * h.nz;
  }

  float* o = out + 3 * ((size_t)y_local * width + x);
  o[0] = result[0];
  o[1] = result[1];
  o[2] = result[2];
}

struct Args {
  const void *coefs, *orig, *colors, *refl, *lights, *dtab, *posdef, *cam;
  void *out, *aux_t, *aux_slot, *aux_occ;
  int width, height, rows, n_obj, n_cubic, n_lights, bounces;
};

template <class It, bool CHAIN>
int launch(const Args& a, It iters, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)a.n_obj * (2 * N_COEFS + 3 + 1)
                                       + (size_t)a.n_lights * 7
                                       + (size_t)a.n_lights * a.n_obj + 18)
                    + sizeof(int) * 2 * (size_t)a.n_obj;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        render_fwd_kernel<It, CHAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((a.width + BLOCK_X - 1) / BLOCK_X, (a.rows + BLOCK_Y - 1) / BLOCK_Y);
  render_fwd_kernel<It, CHAIN><<<grid, block, smem, stream>>>(
      static_cast<const float*>(a.coefs), static_cast<const int*>(a.orig),
      static_cast<const float*>(a.colors), static_cast<const float*>(a.refl),
      static_cast<const float*>(a.lights), static_cast<const float*>(a.dtab),
      static_cast<const int*>(a.posdef), static_cast<const float*>(a.cam),
      static_cast<float*>(a.out), static_cast<float*>(a.aux_t), static_cast<int*>(a.aux_slot),
      static_cast<int*>(a.aux_occ), a.width, a.height, a.rows, a.n_obj, a.n_cubic, a.n_lights,
      iters, a.bounces);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 = the main path's counts (polish 3, screen 3, shadow 1) without
// a chain (bounces 0); 1 = the same counts with a chain; 2 = generic
// (runtime counts, any bounces). A variant that does not fit the arguments
// is refused with cudaErrorInvalidValue.
extern "C" int trt_render_fwd(const void* coefs, const void* orig_index, const void* colors,
                              const void* refl, const void* lights, const void* dir_table,
                              const void* posdef, const void* cam, void* out, void* aux_t,
                              void* aux_slot, void* aux_occ, int width,
                              int height, int rows, int n_obj, int n_cubic, int n_lights,
                              int polish_iters, int shadow_iters, int screen_iters,
                              int bounces, int variant, void* stream) {
  const Args a{coefs, orig_index, colors, refl, lights, dir_table, posdef, cam, out, aux_t,
               aux_slot, aux_occ, width, height, rows, n_obj, n_cubic, n_lights, bounces};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool main_counts = polish_iters == 3 && screen_iters == 3 && shadow_iters == 1;
  switch (variant) {
    case 0:
      if (!main_counts || bounces != 0) return (int)cudaErrorInvalidValue;
      return launch<MainIters, false>(a, MainIters{}, st);
    case 1:
      if (!main_counts) return (int)cudaErrorInvalidValue;
      return launch<MainIters, true>(a, MainIters{}, st);
    case 2:
      return launch<RuntimeIters, true>(a, RuntimeIters{polish_iters, screen_iters, shadow_iters},
                                        st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* trt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
