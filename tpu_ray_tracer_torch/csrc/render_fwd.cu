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
// What bounds it on this card: per-thread ALU work and register pressure
// from the unrolled 20-monomial polynomials (ray expansion, Newton steps,
// the per-object shadow precompute), not bytes. The scene tables are a few
// KB, staged once per block into shared memory; the only device-memory
// traffic is the framebuffer write. What the simple design does about it:
// nothing yet. Scene statics (object and light counts, the cubic/quadric
// split, per-slot posdef, per-light kind, iteration counts, bounces) are
// runtime arguments, so one build serves every scene.
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
constexpr int BLOCK_X = 8;  // the reference's 8x8 pixel blocks
constexpr int BLOCK_Y = 8;

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

__device__ __forceinline__ float newton_step(float t, float f, float df) {
  const float step = fabsf(df) > 1e-12f ? f / df : 0.f;
  const float tn = t - step;
  return isfinite(tn) ? tn : t;
}

// Newton against the direct F, then (REJECT) the residual test
// (Pallas `_polish`, :239).
template <int M_START, bool REJECT>
__device__ float polish(const float* c, float ox, float oy, float oz, float dx,
                        float dy, float dz, float t, int iters) {
  const float seed = t;
  float f, mag, g[3];
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
  __device__ __forceinline__ void seeds(float out[3]) const {
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
    out[0] = s * (first - a3);
    out[1] = s * (two_sq * cosf(theta + TTP1) - a3);
    out[2] = s * (two_sq * cosf(theta + TTP2) - a3);
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

// Root for a cubic slot (Pallas `_solve_object`, :263-405).
__device__ float solve_object(const float* c, float ox, float oy, float oz,
                              float dx, float dy, float dz, int polish_iters,
                              int screen_iters) {
  float tc[4];
  ray_coeffs<0, 3>(c, powers(ox, oy, oz), powers(dx, dy, dz), tc);
  const Cubic p{tc[3], tc[2], tc[1], tc[0]};
  const bool is_cubic = fabsf(p.t3) > EPS;
  const bool is_quad = fabsf(p.t2) > EPS;
  if (!is_cubic && !is_quad) return fabsf(p.t1) > EPS ? -p.t0 / p.t1 : -1.f;

  const float sq2 = is_quad ? p.t2 : 1.f;
  const float qdisc = p.t1 * p.t1 - 4.f * p.t2 * p.t0;
  const float qsq = sqrtf(jmax(qdisc, 0.f));
  const float sub_lo = p.screen((-p.t1 - qsq) / (2.f * sq2), screen_iters);
  const float sub_hi = p.screen((-p.t1 + qsq) / (2.f * sq2), screen_iters);
  if (is_cubic) {
    float seed[3];
    p.seeds(seed);
    const float cands[5] = {p.screen(seed[0], screen_iters), p.screen(seed[1], screen_iters),
                            p.screen(seed[2], screen_iters), sub_lo, sub_hi};
    float root = BIG_ROOT;
#pragma unroll
    for (int i = 0; i < 5; ++i)
      if (cands[i] >= EPS && cands[i] < root) root = cands[i];
    if (root < FAKE_ROOT)
      root = polish<0, true>(c, ox, oy, oz, dx, dy, dz, root, polish_iters);
    return root >= BIG_ROOT ? -1.f : root;
  }
  float root = qdisc < 0.f ? -1.f : (sub_lo >= EPS ? sub_lo : sub_hi);
  if (qdisc >= 0.f && root < FAKE_ROOT)
    root = polish<0, false>(c, ox, oy, oz, dx, dy, dz, root, polish_iters);
  return root;
}

// Root for a quadric slot (Pallas `_solve_quadric`, :408-453).
__device__ float solve_quadric(const float* c, float ox, float oy, float oz,
                               float dx, float dy, float dz, int polish_iters) {
  float tc[3];
  ray_coeffs<QUAD_START, 2>(c, powers(ox, oy, oz), powers(dx, dy, dz), tc);
  const float t2 = tc[2], t1 = tc[1], t0 = tc[0];
  if (!(fabsf(t2) > EPS)) return fabsf(t1) > EPS ? -t0 / t1 : -1.f;
  float lo, hi;
  const float disc = stable_quad_roots(t2, t1, t0, lo, hi);
  if (disc < 0.f) return -1.f;
  return polish<QUAD_START, false>(c, ox, oy, oz, dx, dy, dz, lo >= EPS ? lo : hi,
                                   polish_iters < 2 ? polish_iters : 2);
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
__device__ bool cubic_occ(float t3, const float h[6], const float g0[3], float f0,
                          float sdx, float sdy, float sdz, float max_t, int shadow_iters) {
  const float t2 = 0.5f * (h[0] * (sdx * sdx) + h[1] * (sdy * sdy) + h[2] * (sdz * sdz))
                 + h[3] * (sdx * sdy) + h[4] * (sdx * sdz) + h[5] * (sdy * sdz);
  const float t1 = g0[0] * sdx + g0[1] * sdy + g0[2] * sdz;
  if (!(fabsf(t3) > EPS)) return quadlin_occ(t2, t1, f0, max_t, false, false);
  const Cubic p{t3, t2, t1, f0};
  float cands[5];
  p.seeds(cands);
  stable_quad_roots(t2, t1, f0, cands[3], cands[4]);
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
  int n_obj, n_cubic, n_lights, polish_iters, shadow_iters, screen_iters;
};

struct Hit {
  bool hit;
  int idx;
  float t;  // the hit distance, 0 on a miss
  float px, py, pz, nx, ny, nz;
};

// Nearest valid hit over all slots (Pallas `nearest_hit`, :535-579): strict
// `<` with ties to the lower original index, then the point and the normal.
__device__ Hit trace(const Tables& T, float ox, float oy, float oz, float dx,
                     float dy, float dz) {
  float best_t = MAX_T;
  int best_idx = -1, best_orig = 1 << 30;
  for (int i = 0; i < T.n_obj; ++i) {
    const float* c = T.coefs + i * N_COEFS;
    const float t = i < T.n_cubic
        ? solve_object(c, ox, oy, oz, dx, dy, dz, T.polish_iters, T.screen_iters)
        : solve_quadric(c, ox, oy, oz, dx, dy, dz, T.polish_iters);
    const int orig = T.orig[i];
    if (t >= EPS && t < MAX_T && (t < best_t || (t == best_t && orig < best_orig))) {
      best_t = t;
      best_idx = i;
      best_orig = orig;
    }
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
    float f, mag, g[3];
    eval_F<0, false, true>(T.coefs + best_idx * N_COEFS, powers(h.px, h.py, h.pz), f, mag, g);
    const float norm = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
    const float inv = 1.f / (norm > 0.f ? norm : 1.f);
    h.nx = g[0] * inv;
    h.ny = g[1] * inv;
    h.nz = g[2] * inv;
  }
  return h;
}

// Per-light shading terms for a point with normal n.
struct LightDir {
  bool spherical;
  float sdx, sdy, sdz;  // shadow-ray direction (unnormalised to-light for spherical)
  float max_t, lam, cscale;
};

__device__ __forceinline__ LightDir light_dir(const float* L, const Hit& h) {
  LightDir r;
  r.spherical = L[0] > 0.5f;
  if (r.spherical) {
    r.sdx = L[1] - h.px;
    r.sdy = L[2] - h.py;
    r.sdz = L[3] - h.pz;
    r.max_t = 1.f;
    const float dist2 = r.sdx * r.sdx + r.sdy * r.sdy + r.sdz * r.sdz;
    const float inv_dn = rsqrtf(dist2 > 0.f ? dist2 : 1.f);
    r.lam = jmax(0.f, h.nx * (r.sdx * inv_dn) + h.ny * (r.sdy * inv_dn) + h.nz * (r.sdz * inv_dn));
    r.cscale = 1.f / (FOUR_PI * dist2);
  } else {
    r.sdx = L[1];
    r.sdy = L[2];
    r.sdz = L[3];
    r.max_t = MAX_T;
    r.lam = jmax(0.f, h.nx * r.sdx + h.ny * r.sdy + h.nz * r.sdz);
    r.cscale = 1.f;
  }
  return r;
}

// Shadow-tested Lambertian sum over lights, clamped to 1 (Pallas `shade`,
// :596-941). Lights go in chunks of 32 (one bitmask word); within a chunk
// the loop runs objects outer and lights inner, so each object's F, grad F
// and Hessian at the shadow origin are computed once per chunk. Returns the
// occlusion bits of the first chunk (lights 0-31), the aux bitmask. A light
// that does not face the point (lambert factor 0) is never tested, so its
// bit stays 0 where the Pallas kernel may set it; nothing reads such a bit:
// the backward multiplies it by ndotl <= 0 terms that are 0 (dndotl, the
// colour and distance cotangents) whatever it holds.
__device__ uint32_t shade(const Tables& T, const Hit& h, float out[3]) {
  const float* col = T.colors + 3 * h.idx;
  const Pow3 S = powers(h.px + SHADOW_BIAS * h.nx, h.py + SHADOW_BIAS * h.ny,
                        h.pz + SHADOW_BIAS * h.nz);
  float acc[3] = {0.f, 0.f, 0.f};
  uint32_t bits0 = 0u;
  for (int l0 = 0; l0 < T.n_lights; l0 += 32) {
    const int nl = T.n_lights - l0 < 32 ? T.n_lights - l0 : 32;
    uint32_t pending = 0u, occluded = 0u;
    for (int j = 0; j < nl; ++j)
      if (light_dir(T.lights + 7 * (l0 + j), h).lam != 0.f) pending |= 1u << j;
    for (int i = 0; i < T.n_obj && pending; ++i) {
      const float* c = T.coefs + i * N_COEFS;
      float f0, mag, g0[3];
      if (i < T.n_cubic) {
        float hs[6];
        eval_F<0, false, true>(c, S, f0, mag, g0);
        hessian(c, S, hs);
        for (uint32_t bits = pending; bits; bits &= bits - 1) {
          const int j = __ffs(bits) - 1;
          const int li = l0 + j;
          const LightDir ld = light_dir(T.lights + 7 * li, h);
          float t3;
          if (ld.spherical) {
            const Pow3 SD = powers(ld.sdx, ld.sdy, ld.sdz);
            t3 = 0.f;
#pragma unroll
            for (int m = 0; m < QUAD_START; ++m)
              t3 += c[m] * mono(SD, mpow(m, 0), mpow(m, 1), mpow(m, 2));
          } else {
            t3 = T.dtab[li * T.n_obj + i];
          }
          if (cubic_occ(t3, hs, g0, f0, ld.sdx, ld.sdy, ld.sdz, ld.max_t, T.shadow_iters)) {
            occluded |= 1u << j;
            pending &= ~(1u << j);
          }
        }
      } else {
        eval_F<QUAD_START, false, true>(c, S, f0, mag, g0);
        const bool pd = T.posdef[i] != 0;
        for (uint32_t bits = pending; bits; bits &= bits - 1) {
          const int j = __ffs(bits) - 1;
          const int li = l0 + j;
          const LightDir ld = light_dir(T.lights + 7 * li, h);
          const float sdx = ld.sdx, sdy = ld.sdy, sdz = ld.sdz;
          const float t2 = ld.spherical
              ? c[10] * (sdx * sdx) + c[11] * (sdy * sdy) + c[12] * (sdz * sdz)
                    + c[13] * (sdx * sdy) + c[14] * (sdx * sdz) + c[15] * (sdy * sdz)
              : T.dtab[li * T.n_obj + i];
          const float t1 = g0[0] * sdx + g0[1] * sdy + g0[2] * sdz;
          if (quadlin_occ(t2, t1, f0, ld.max_t, pd, !ld.spherical)) {
            occluded |= 1u << j;
            pending &= ~(1u << j);
          }
        }
      }
    }
    for (int j = 0; j < nl; ++j) {
      const float* L = T.lights + 7 * (l0 + j);
      const LightDir ld = light_dir(L, h);
      const float w = (occluded >> j) & 1u ? 0.f : ld.lam * INV_PI;
      const float scale = ld.cscale * w;
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

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
render_fwd_kernel(const float* __restrict__ g_coefs, const int* __restrict__ g_orig,
                  const float* __restrict__ g_colors, const float* __restrict__ g_refl,
                  const float* __restrict__ g_lights, const float* __restrict__ g_dtab,
                  const int* __restrict__ g_posdef, const float* __restrict__ g_cam,
                  float* __restrict__ out, float* __restrict__ aux_t,
                  int* __restrict__ aux_slot, int* __restrict__ aux_occ, int width,
                  int height, int rows, int n_obj,
                  int n_cubic, int n_lights, int polish_iters, int shadow_iters,
                  int screen_iters, int bounces) {
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

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y_local = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y_local >= rows) return;

  const Tables T{s_coefs, s_colors, s_lights, s_dtab, s_orig, s_posdef, n_obj,
                 n_cubic, n_lights, polish_iters, shadow_iters, screen_iters};

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

  Hit h = trace(T, s_cam[9], s_cam[10], s_cam[11], dx, dy, dz);
  float result[3] = {bg[0], bg[1], bg[2]};
  if (h.hit) {
    const uint32_t bits = shade(T, h, result);
    if (save_aux) {
      aux_t[pix] = h.t;
      aux_slot[pix] = h.idx;
      aux_occ[pix] = (int)bits;
    }
  }

  // --- reflection chain (Pallas kernel :1031-1130) ---
  if (h.hit && bounces > 0) {
    float ratio = 1.f;
    float refl_c = s_refl[h.idx];
    bool active = true;
    for (int k = 0; k < bounces; ++k) {
      if (!(refl_c > EPS)) {
        active = false;
        break;
      }
      ratio = ratio * refl_c;
      const float dot = dx * h.nx + dy * h.ny + dz * h.nz;
      const float rdx = dx - 2.f * dot * h.nx;
      const float rdy = dy - 2.f * dot * h.ny;
      const float rdz = dz - 2.f * dot * h.nz;
      const Hit h2 = trace(T, h.px + SHADOW_BIAS * h.nx, h.py + SHADOW_BIAS * h.ny,
                           h.pz + SHADOW_BIAS * h.nz, rdx, rdy, rdz);
      float bcol[3] = {bg[0], bg[1], bg[2]};
      if (h2.hit) {
        const uint32_t bits = shade(T, h2, bcol);
        if (save_aux) {  // entered and hit: the lane advances into stage k + 1
          aux_t[(k + 1) * stage + pix] = h2.t;
          aux_slot[(k + 1) * stage + pix] = h2.idx;
          aux_occ[(k + 1) * stage + pix] = (int)bits;
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) result[c] = (1.f - ratio) * result[c] + ratio * bcol[c];
      dx = rdx;
      dy = rdy;
      dz = rdz;
      if (!h2.hit) {
        active = false;
        break;
      }
      h = h2;
      refl_c = s_refl[h2.idx];
    }
    // at-cap background blend
    if (active && refl_c > EPS) {
      const float rr = ratio * refl_c;
#pragma unroll
      for (int c = 0; c < 3; ++c) result[c] = (1.f - rr) * result[c] + rr * bg[c];
    }
  }

  float* o = out + 3 * ((size_t)y_local * width + x);
  o[0] = result[0];
  o[1] = result[1];
  o[2] = result[2];
}

}  // namespace

extern "C" int trt_render_fwd(const void* coefs, const void* orig_index, const void* colors,
                              const void* refl, const void* lights, const void* dir_table,
                              const void* posdef, const void* cam, void* out, void* aux_t,
                              void* aux_slot, void* aux_occ, int width,
                              int height, int rows, int n_obj, int n_cubic, int n_lights,
                              int polish_iters, int shadow_iters, int screen_iters,
                              int bounces, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)n_obj * (N_COEFS + 3 + 1) + (size_t)n_lights * 7
                                       + (size_t)n_lights * n_obj + 18)
                    + sizeof(int) * 2 * (size_t)n_obj;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        render_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((width + BLOCK_X - 1) / BLOCK_X, (rows + BLOCK_Y - 1) / BLOCK_Y);
  render_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coefs), static_cast<const int*>(orig_index),
      static_cast<const float*>(colors), static_cast<const float*>(refl),
      static_cast<const float*>(lights), static_cast<const float*>(dir_table),
      static_cast<const int*>(posdef), static_cast<const float*>(cam),
      static_cast<float*>(out), static_cast<float*>(aux_t), static_cast<int*>(aux_slot),
      static_cast<int*>(aux_occ), width, height, rows, n_obj, n_cubic, n_lights, polish_iters,
      shadow_iters, screen_iters, bounces);
  return (int)cudaGetLastError();
}

extern "C" const char* trt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
