// The pipeline's root solve for Hopper (sm_90a): for every (ray, object)
// pair the ray parameter of the reference's selected root of F(o + t d),
// the forward of `intersect_all` (tpu_ray_tracer_torch/ops/intersect.py),
// one thread per entry of the [..., N] root table.
//
// Replaces no Pallas kernel. It is the counterpart of XLA's fusion of the
// JAX package's `intersect_all` (tpu_ray_tracer/ops/intersect.py:37-54),
// plain JAX that XLA fuses into a few loops. Eager torch runs the same
// function, `_solve_plain` (ops/solve_kernel.py), as some 3,220 kernels a
// call, each writing its intermediate to device memory, most of them
// broadcast: on clebsch 800x600's soft fit step two such calls a row block
// were 70% of the step's kernels and 84% of the bytes it wrote.
//
// A second entry, `roots_excluding_pair_kernel` (`trt_roots_excluding_pair`,
// ops/solve_kernel.py `roots_excluding_pair`), is the root table of the
// soft render's branch B, diff/soft.py `_raw_roots_excluding_pair`: the
// same expansion, seeds and polish (the device functions below), another
// selection, with the pair of roots that merges at the discriminant's zero
// left out. It too replaces no Pallas kernel (the JAX package's
// `_roots_excluding_pair`, tpu_ray_tracer/diff/soft.py, is plain JAX); in
// eager torch it was ~950 kernels a call, 38% of the soft fit step's.
//
// What bounds both on this card: their operations. A thread reads its ray
// (6 values, through the broadcast strides: nothing is materialised) and
// writes one value; between them the expansion (~300 operations), the
// seeds and, with polish, six (branch B: four) Newton-polished candidates
// at a few hundred operations each (render/bounds.py `solve_work` and
// `excluding_pair_work` count them). Everything stays in registers; the
// object's 20 coefficients are staged in shared memory once a block.
//
// Its bits are the plain version's on the card, operation for operation:
// - this source is built with -fmad=false (render/_build.py), so every
//   multiply and add rounds on its own, as each aten kernel does;
// - a division by a Python scalar in the plain version is aten's
//   multiplication by the scalar's reciprocal, rounded in the dtype
//   (x / 3.0 is x * (1.0f / 3.0f));
// - the math functions are the ones aten's kernels call: pow(x, (float)(1/3))
//   (powf), sqrt, acos, cos, copysign, fmax/fmin for clamp, maximum with
//   NaN propagated first, as torch.clamp and torch.maximum do;
// - the expansion walks `TRT_EXPANSION`, ops/poly.py's `_EXPANSION` written
//   out in the plain version's order (tests/test_torch_solve_roots.py
//   `expansion_rows` makes the rows), and the polish `TRT_MONOMIALS`;
// - where the plain version computes every branch and selects, the kernel
//   computes only the branch its entry selects (the selected values are the
//   same operations on the same values).
// f32 (FAST, polish 1-3) and f64 (GOLDEN, polish 0); coefficients of one
// dtype and rays of the other (f64 parameters under an f32 configuration)
// compute as torch promotes them: the expansion's columns in the rays'
// dtype, everything after in the wider one.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BLOCK = 128;
constexpr int MAX_DIMS = 6;  // ops/solve_kernel.py MAX_DIMS
constexpr int N_COEFS = 20;
constexpr double TWO_THIRD_PI = 3.14159265358979311600 * 2.0 / 3.0;  // ops/constants.py
constexpr double EPS = 1e-7;  // ops/constants.py
constexpr double BIG = 4e6;   // 2 * ops/roots.py _FAKE_ROOT

// The origin and direction powers of t^k in each monomial m of F(o + t d):
// TERM(k, m, first, weight, ox, oy, oz, dx, dy, dz) adds weight * o^(ox, oy,
// oz) * d^(dx, dy, dz) to the column (first: starts it); COLUMN(k, m, first)
// adds the column times coefficient m to t^k's sum (first: starts it).
// Generated by tests/test_torch_solve_roots.py `expansion_rows`, which holds
// them equal.
#define TRT_EXPANSION(TERM, COLUMN) \
  TERM(3, 0, 1, 1, 0, 0, 0, 3, 0, 0) \
  COLUMN(3, 0, 1) \
  TERM(3, 1, 1, 1, 0, 0, 0, 0, 3, 0) \
  COLUMN(3, 1, 0) \
  TERM(3, 2, 1, 1, 0, 0, 0, 0, 0, 3) \
  COLUMN(3, 2, 0) \
  TERM(3, 3, 1, 1, 0, 0, 0, 2, 1, 0) \
  COLUMN(3, 3, 0) \
  TERM(3, 4, 1, 1, 0, 0, 0, 1, 2, 0) \
  COLUMN(3, 4, 0) \
  TERM(3, 5, 1, 1, 0, 0, 0, 2, 0, 1) \
  COLUMN(3, 5, 0) \
  TERM(3, 6, 1, 1, 0, 0, 0, 1, 0, 2) \
  COLUMN(3, 6, 0) \
  TERM(3, 7, 1, 1, 0, 0, 0, 0, 2, 1) \
  COLUMN(3, 7, 0) \
  TERM(3, 8, 1, 1, 0, 0, 0, 0, 1, 2) \
  COLUMN(3, 8, 0) \
  TERM(3, 9, 1, 1, 0, 0, 0, 1, 1, 1) \
  COLUMN(3, 9, 0) \
  TERM(2, 0, 1, 3, 1, 0, 0, 2, 0, 0) \
  COLUMN(2, 0, 1) \
  TERM(2, 1, 1, 3, 0, 1, 0, 0, 2, 0) \
  COLUMN(2, 1, 0) \
  TERM(2, 2, 1, 3, 0, 0, 1, 0, 0, 2) \
  COLUMN(2, 2, 0) \
  TERM(2, 3, 1, 2, 1, 0, 0, 1, 1, 0) \
  TERM(2, 3, 0, 1, 0, 1, 0, 2, 0, 0) \
  COLUMN(2, 3, 0) \
  TERM(2, 4, 1, 1, 1, 0, 0, 0, 2, 0) \
  TERM(2, 4, 0, 2, 0, 1, 0, 1, 1, 0) \
  COLUMN(2, 4, 0) \
  TERM(2, 5, 1, 2, 1, 0, 0, 1, 0, 1) \
  TERM(2, 5, 0, 1, 0, 0, 1, 2, 0, 0) \
  COLUMN(2, 5, 0) \
  TERM(2, 6, 1, 1, 1, 0, 0, 0, 0, 2) \
  TERM(2, 6, 0, 2, 0, 0, 1, 1, 0, 1) \
  COLUMN(2, 6, 0) \
  TERM(2, 7, 1, 2, 0, 1, 0, 0, 1, 1) \
  TERM(2, 7, 0, 1, 0, 0, 1, 0, 2, 0) \
  COLUMN(2, 7, 0) \
  TERM(2, 8, 1, 1, 0, 1, 0, 0, 0, 2) \
  TERM(2, 8, 0, 2, 0, 0, 1, 0, 1, 1) \
  COLUMN(2, 8, 0) \
  TERM(2, 9, 1, 1, 1, 0, 0, 0, 1, 1) \
  TERM(2, 9, 0, 1, 0, 1, 0, 1, 0, 1) \
  TERM(2, 9, 0, 1, 0, 0, 1, 1, 1, 0) \
  COLUMN(2, 9, 0) \
  TERM(2, 10, 1, 1, 0, 0, 0, 2, 0, 0) \
  COLUMN(2, 10, 0) \
  TERM(2, 11, 1, 1, 0, 0, 0, 0, 2, 0) \
  COLUMN(2, 11, 0) \
  TERM(2, 12, 1, 1, 0, 0, 0, 0, 0, 2) \
  COLUMN(2, 12, 0) \
  TERM(2, 13, 1, 1, 0, 0, 0, 1, 1, 0) \
  COLUMN(2, 13, 0) \
  TERM(2, 14, 1, 1, 0, 0, 0, 1, 0, 1) \
  COLUMN(2, 14, 0) \
  TERM(2, 15, 1, 1, 0, 0, 0, 0, 1, 1) \
  COLUMN(2, 15, 0) \
  TERM(1, 0, 1, 3, 2, 0, 0, 1, 0, 0) \
  COLUMN(1, 0, 1) \
  TERM(1, 1, 1, 3, 0, 2, 0, 0, 1, 0) \
  COLUMN(1, 1, 0) \
  TERM(1, 2, 1, 3, 0, 0, 2, 0, 0, 1) \
  COLUMN(1, 2, 0) \
  TERM(1, 3, 1, 1, 2, 0, 0, 0, 1, 0) \
  TERM(1, 3, 0, 2, 1, 1, 0, 1, 0, 0) \
  COLUMN(1, 3, 0) \
  TERM(1, 4, 1, 2, 1, 1, 0, 0, 1, 0) \
  TERM(1, 4, 0, 1, 0, 2, 0, 1, 0, 0) \
  COLUMN(1, 4, 0) \
  TERM(1, 5, 1, 1, 2, 0, 0, 0, 0, 1) \
  TERM(1, 5, 0, 2, 1, 0, 1, 1, 0, 0) \
  COLUMN(1, 5, 0) \
  TERM(1, 6, 1, 2, 1, 0, 1, 0, 0, 1) \
  TERM(1, 6, 0, 1, 0, 0, 2, 1, 0, 0) \
  COLUMN(1, 6, 0) \
  TERM(1, 7, 1, 1, 0, 2, 0, 0, 0, 1) \
  TERM(1, 7, 0, 2, 0, 1, 1, 0, 1, 0) \
  COLUMN(1, 7, 0) \
  TERM(1, 8, 1, 2, 0, 1, 1, 0, 0, 1) \
  TERM(1, 8, 0, 1, 0, 0, 2, 0, 1, 0) \
  COLUMN(1, 8, 0) \
  TERM(1, 9, 1, 1, 1, 1, 0, 0, 0, 1) \
  TERM(1, 9, 0, 1, 1, 0, 1, 0, 1, 0) \
  TERM(1, 9, 0, 1, 0, 1, 1, 1, 0, 0) \
  COLUMN(1, 9, 0) \
  TERM(1, 10, 1, 2, 1, 0, 0, 1, 0, 0) \
  COLUMN(1, 10, 0) \
  TERM(1, 11, 1, 2, 0, 1, 0, 0, 1, 0) \
  COLUMN(1, 11, 0) \
  TERM(1, 12, 1, 2, 0, 0, 1, 0, 0, 1) \
  COLUMN(1, 12, 0) \
  TERM(1, 13, 1, 1, 1, 0, 0, 0, 1, 0) \
  TERM(1, 13, 0, 1, 0, 1, 0, 1, 0, 0) \
  COLUMN(1, 13, 0) \
  TERM(1, 14, 1, 1, 1, 0, 0, 0, 0, 1) \
  TERM(1, 14, 0, 1, 0, 0, 1, 1, 0, 0) \
  COLUMN(1, 14, 0) \
  TERM(1, 15, 1, 1, 0, 1, 0, 0, 0, 1) \
  TERM(1, 15, 0, 1, 0, 0, 1, 0, 1, 0) \
  COLUMN(1, 15, 0) \
  TERM(1, 16, 1, 1, 0, 0, 0, 1, 0, 0) \
  COLUMN(1, 16, 0) \
  TERM(1, 17, 1, 1, 0, 0, 0, 0, 1, 0) \
  COLUMN(1, 17, 0) \
  TERM(1, 18, 1, 1, 0, 0, 0, 0, 0, 1) \
  COLUMN(1, 18, 0) \
  TERM(0, 0, 1, 1, 3, 0, 0, 0, 0, 0) \
  COLUMN(0, 0, 1) \
  TERM(0, 1, 1, 1, 0, 3, 0, 0, 0, 0) \
  COLUMN(0, 1, 0) \
  TERM(0, 2, 1, 1, 0, 0, 3, 0, 0, 0) \
  COLUMN(0, 2, 0) \
  TERM(0, 3, 1, 1, 2, 1, 0, 0, 0, 0) \
  COLUMN(0, 3, 0) \
  TERM(0, 4, 1, 1, 1, 2, 0, 0, 0, 0) \
  COLUMN(0, 4, 0) \
  TERM(0, 5, 1, 1, 2, 0, 1, 0, 0, 0) \
  COLUMN(0, 5, 0) \
  TERM(0, 6, 1, 1, 1, 0, 2, 0, 0, 0) \
  COLUMN(0, 6, 0) \
  TERM(0, 7, 1, 1, 0, 2, 1, 0, 0, 0) \
  COLUMN(0, 7, 0) \
  TERM(0, 8, 1, 1, 0, 1, 2, 0, 0, 0) \
  COLUMN(0, 8, 0) \
  TERM(0, 9, 1, 1, 1, 1, 1, 0, 0, 0) \
  COLUMN(0, 9, 0) \
  TERM(0, 10, 1, 1, 2, 0, 0, 0, 0, 0) \
  COLUMN(0, 10, 0) \
  TERM(0, 11, 1, 1, 0, 2, 0, 0, 0, 0) \
  COLUMN(0, 11, 0) \
  TERM(0, 12, 1, 1, 0, 0, 2, 0, 0, 0) \
  COLUMN(0, 12, 0) \
  TERM(0, 13, 1, 1, 1, 1, 0, 0, 0, 0) \
  COLUMN(0, 13, 0) \
  TERM(0, 14, 1, 1, 1, 0, 1, 0, 0, 0) \
  COLUMN(0, 14, 0) \
  TERM(0, 15, 1, 1, 0, 1, 1, 0, 0, 0) \
  COLUMN(0, 15, 0) \
  TERM(0, 16, 1, 1, 1, 0, 0, 0, 0, 0) \
  COLUMN(0, 16, 0) \
  TERM(0, 17, 1, 1, 0, 1, 0, 0, 0, 0) \
  COLUMN(0, 17, 0) \
  TERM(0, 18, 1, 1, 0, 0, 1, 0, 0, 0) \
  COLUMN(0, 18, 0) \
  TERM(0, 19, 1, 1, 0, 0, 0, 0, 0, 0) \
  COLUMN(0, 19, 0)

// The monomials of F in the order of the coefficients (models/surface.py
// MONOMIAL_POWERS): MONO(m, px, py, pz). The first monomial with a power of
// x, y and z is m = 0, 1 and 2.
#define TRT_MONOMIALS(MONO) \
  MONO(0, 3, 0, 0) \
  MONO(1, 0, 3, 0) \
  MONO(2, 0, 0, 3) \
  MONO(3, 2, 1, 0) \
  MONO(4, 1, 2, 0) \
  MONO(5, 2, 0, 1) \
  MONO(6, 1, 0, 2) \
  MONO(7, 0, 2, 1) \
  MONO(8, 0, 1, 2) \
  MONO(9, 1, 1, 1) \
  MONO(10, 2, 0, 0) \
  MONO(11, 0, 2, 0) \
  MONO(12, 0, 0, 2) \
  MONO(13, 1, 1, 0) \
  MONO(14, 1, 0, 1) \
  MONO(15, 0, 1, 1) \
  MONO(16, 1, 0, 0) \
  MONO(17, 0, 1, 0) \
  MONO(18, 0, 0, 1) \
  MONO(19, 0, 0, 0)

struct Layout {
  long long size[MAX_DIMS];      // batch dimensions, outermost first
  long long o_stride[MAX_DIMS];  // origin's element stride in each (0: broadcast)
  long long d_stride[MAX_DIMS];  // dir's
  long long o_comp, d_comp;      // the stride of x, y, z
  int dims;
};

template <typename T>
struct Ray {
  T ox, oy, oz, dx, dy, dz;
};

// The math functions aten's f32 and f64 kernels call
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float pow_(float x, float e) { return powf(x, e); }
__device__ __forceinline__ double pow_(double x, double e) { return pow(x, e); }
__device__ __forceinline__ float acos_(float x) { return acosf(x); }
__device__ __forceinline__ double acos_(double x) { return acos(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float copysign_(float x, float s) { return copysignf(x, s); }
__device__ __forceinline__ double copysign_(double x, double s) { return copysign(x, s); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_(double a, double b) { return fmin(a, b); }
// torch.isfinite: neither infinite nor NaN
__device__ __forceinline__ bool finite_(float x) { return fabsf(x) <= FLT_MAX; }
__device__ __forceinline__ bool finite_(double x) { return fabs(x) <= DBL_MAX; }

// torch.clamp(v, min=0), torch.clamp(v, lo, hi) and torch.maximum(a, b):
// NaN first, then fmax/fmin as aten's kernels
template <typename T>
__device__ __forceinline__ T clamp_min0(T v) { return v != v ? v : max_(v, T(0)); }
template <typename T>
__device__ __forceinline__ T clamp(T v, T lo, T hi) { return v != v ? v : min_(max_(v, lo), hi); }
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return a != a ? a : (b != b ? b : max_(a, b));
}

// ops/roots.py `cbrt`: sign(x) |x|^(1/3) and one Newton step
template <typename T>
__device__ __forceinline__ T cbrt_(T x) {
  const T ax = abs_(x);
  T y = pow_(ax, T(1.0 / 3.0));
  const bool ok = y > T(0) && finite_(y);
  const T ys = ok ? y : T(1);
  y = ok ? ys + (ax / (ys * ys) - ys) * (T(1) / T(3)) : y;
  return copysign_(y, x);
}

// ops/poly.py `_powers`: x, x * x, (x * x) * x for each axis
template <typename T>
__device__ __forceinline__ void powers(T (&p)[3][4], T x, T y, T z) {
  p[0][1] = x; p[0][2] = x * x; p[0][3] = p[0][2] * x;
  p[1][1] = y; p[1][2] = y * y; p[1][3] = p[1][2] * y;
  p[2][1] = z; p[2][2] = z * z; p[2][3] = p[2][2] * z;
}

// ops/poly.py `_product`: the cached powers multiplied in axis order, 1 for
// none
template <int EX, int EY, int EZ, typename T>
__device__ __forceinline__ T product(const T (&p)[3][4]) {
  if constexpr (EX != 0 && EY != 0 && EZ != 0) return p[0][EX] * p[1][EY] * p[2][EZ];
  else if constexpr (EX != 0 && EY != 0) return p[0][EX] * p[1][EY];
  else if constexpr (EX != 0 && EZ != 0) return p[0][EX] * p[2][EZ];
  else if constexpr (EY != 0 && EZ != 0) return p[1][EY] * p[2][EZ];
  else if constexpr (EX != 0) return p[0][EX];
  else if constexpr (EY != 0) return p[1][EY];
  else if constexpr (EZ != 0) return p[2][EZ];
  else return T(1);
}

// One monomial's term of dF/d(axis) (ops/poly.py `_gradient_columns` and
// `_contract`): the first monomial with a power of the axis starts the sum
template <int AXIS, int M, int PX, int PY, int PZ, typename T>
__device__ __forceinline__ void grad_term(T& acc, const T (&p)[3][4], const T (&c)[N_COEFS]) {
  constexpr int E = AXIS == 0 ? PX : AXIS == 1 ? PY : PZ;
  if constexpr (E != 0) {
    T term = product<PX - (AXIS == 0), PY - (AXIS == 1), PZ - (AXIS == 2)>(p);
    if constexpr (E != 1) term = term * T(E);
    if constexpr (M == AXIS) acc = term * c[M];
    else acc = acc + term * c[M];
  }
}

// ops/poly.py `eval_poly_and_slope` at the point of powers p: F and grad F . d
template <typename T>
__device__ __forceinline__ void f_and_slope(const T (&p)[3][4], const T (&c)[N_COEFS],
                                            const Ray<T>& r, T& f, T& slope) {
  T gx = T(0), gy = T(0), gz = T(0);
  f = T(0);
#define TRT_F_SLOPE(M, PX, PY, PZ)                          \
  {                                                         \
    const T term = product<PX, PY, PZ>(p) * c[M];           \
    f = M == 0 ? term : f + term;                           \
    grad_term<0, M, PX, PY, PZ>(gx, p, c);                  \
    grad_term<1, M, PX, PY, PZ>(gy, p, c);                  \
    grad_term<2, M, PX, PY, PZ>(gz, p, c);                  \
  }
  TRT_MONOMIALS(TRT_F_SLOPE)
#undef TRT_F_SLOPE
  slope = gx * r.dx + gy * r.dy + gz * r.dz;
}

// ops/poly.py `eval_poly` and `eval_poly_magnitude` at the point of powers p
template <typename T>
__device__ __forceinline__ void f_and_magnitude(const T (&p)[3][4], const T (&c)[N_COEFS],
                                                T& f, T& mag) {
  f = T(0);
  mag = T(0);
#define TRT_F_MAG(M, PX, PY, PZ)                            \
  {                                                         \
    const T mono = product<PX, PY, PZ>(p);                  \
    const T term = mono * c[M];                             \
    const T size = abs_(c[M] * mono);                       \
    f = M == 0 ? term : f + term;                           \
    mag = M == 0 ? size : mag + size;                       \
  }
  TRT_MONOMIALS(TRT_F_MAG)
#undef TRT_F_MAG
}

// ops/roots.py `make_newton_polisher`'s `polish` of one candidate: `iters`
// Newton steps against the direct F, then the residual test
template <typename T>
__device__ __forceinline__ T polish(T t, const T (&c)[N_COEFS], const Ray<T>& r, int iters) {
  const T seed = t;
  T p[3][4];
  for (int i = 0; i < iters; ++i) {
    powers(p, r.ox + t * r.dx, r.oy + t * r.dy, r.oz + t * r.dz);
    T f, slope;
    f_and_slope(p, c, r, f, slope);
    const T step = abs_(slope) > T(1e-12) ? f / slope : T(0);
    const T t_new = t - step;
    t = finite_(t_new) ? t_new : t;
  }
  powers(p, r.ox + t * r.dx, r.oy + t * r.dy, r.oz + t * r.dz);
  T f, mag;
  f_and_magnitude(p, c, f, mag);
  // _RESIDUAL_TOL, _FAKE_ROOT
  return abs_(f) <= T(1e-5) * mag ? t : (seed < T(0) ? seed : T(2e6));
}


// The scale-normalized depressed cubic of a cubic entry (|t3| > EPS), as
// ops/roots.py `min_positive_root` and diff/soft.py `_normalized_qr` make
// it: t = s u with the scale s, the normalized a, and q, r
template <typename T>
struct Depressed {
  T a, q, r, s;
};

template <typename T>
__device__ __forceinline__ Depressed<T> depressed(T t3, T t2, T t1, T t0) {
  T a = t2 / t3, b = t1 / t3, cc = t0 / t3;
  const T s = maximum(maximum(abs_(a), sqrt_(abs_(b))), maximum(cbrt_(abs_(cc)), T(1e-30)));
  a = a / s;
  b = b / (s * s);
  cc = cc / (s * s * s);
  const T q = (T(3) * b - a * a) * (T(1) / T(9));
  const T r = (T(9) * a * b - T(27) * cc - T(2) * a * a * a) * (T(1) / T(54));
  return {a, q, r, s};
}

// the discriminant q^3 + r^2
template <typename T>
__device__ __forceinline__ T discriminant(const Depressed<T>& d) {
  return d.q * d.q * d.q + d.r * d.r;
}

// Cardano's root s (cbrt(r + sqrt delta) + cbrt(r - sqrt delta) - a / 3)
template <typename T>
__device__ __forceinline__ T cardano(const Depressed<T>& d, T delta) {
  const T sqrt_delta = sqrt_(clamp_min0(delta));
  return d.s * (cbrt_(d.r + sqrt_delta) + cbrt_(d.r - sqrt_delta) - d.a * (T(1) / T(3)));
}

// the trigonometric roots s (2 sqrt(-q) cos(theta + 2 pi k / 3) - a / 3),
// k = 0, 1, 2
template <typename T>
__device__ __forceinline__ void trig_roots(const Depressed<T>& d, T (&trig)[3]) {
  const T third = T(1) / T(3);
  const T q_neg = clamp_min0(-d.q);
  const T denom = sqrt_(q_neg * q_neg * q_neg);
  const T ratio = clamp(d.r / (denom == T(0) ? T(1) : denom), T(-1), T(1));
  const T theta = acos_(ratio) * third;
  const T two_sqrt_q = T(2) * sqrt_(q_neg);
  const T a_third = d.a * third;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    trig[k] = d.s * (two_sqrt_q * cos_(theta + T(k * TWO_THIRD_PI)) - a_third);
}

// the roots (-t1 -/+ sqrt(disc)) / (2 s2) of t2 t^2 + t1 t + t0, s2 = t2
// where |t2| > EPS, else 1; returns disc
template <typename T>
__device__ __forceinline__ T quadratic_roots(T t2, T t1, T t0, bool is_quad, T& lo, T& hi) {
  const T s2 = is_quad ? t2 : T(1);
  const T disc = t1 * t1 - T(4) * t2 * t0;
  const T sqrt_disc = sqrt_(clamp_min0(disc));
  lo = (-t1 - sqrt_disc) / (T(2) * s2);
  hi = (-t1 + sqrt_disc) / (T(2) * s2);
  return disc;
}

// the smallest candidate >= EPS, else a miss (-1); a candidate at
// 2 * _FAKE_ROOT never wins
template <int N, typename T>
__device__ __forceinline__ T smallest_root(const T (&cands)[N]) {
  T best = T(BIG);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (cands[i] >= T(EPS) && cands[i] < best) best = cands[i];
  return best >= T(BIG) ? T(-1) : best;
}

// ops/roots.py `min_positive_root` on (t3, t2, t1, t0), polished by
// `polish` where iters > 0 (the FAST path's selection), else the
// reference's exact branching (GOLDEN)
template <typename T>
__device__ __forceinline__ T select_root(T t3, T t2, T t1, T t0, const T (&c)[N_COEFS],
                                         const Ray<T>& r, int iters) {
  const T eps = T(EPS);
  const bool is_cubic = abs_(t3) > eps, is_quad = abs_(t2) > eps, is_lin = abs_(t1) > eps;
  const bool polished = iters > 0;
  if (!is_cubic && !is_quad) return is_lin ? -(t0 / t1) : T(-1);

  // the quadratic branch's roots, the polished cubic's extra candidates
  T lo = T(0), hi = T(0);
  if (!is_cubic || polished) {
    const T disc = quadratic_roots(t2, t1, t0, is_quad, lo, hi);
    if (polished) {
      lo = polish(lo, c, r, iters);
      hi = polish(hi, c, r, iters);
    }
    if (!is_cubic) return disc < T(0) ? T(-1) : (lo >= eps ? lo : hi);
  }

  // the cubic's seeds, scale-normalized
  const Depressed<T> d = depressed(t3, t2, t1, t0);
  const T delta = discriminant(d);
  if (!polished && delta > T(0)) return cardano(d, delta);
  T trig[3];
  trig_roots(d, trig);
  if (!polished) {
    // the reference's asymmetric selection: start from k = 0 unchecked
    T x = trig[0];
    if (trig[1] >= eps && trig[1] < x) x = trig[1];
    if (trig[2] >= eps && trig[2] < x) x = trig[2];
    return x;
  }
  // the smallest genuine polished candidate >= EPS, else a miss
  const T cands[6] = {polish(cardano(d, delta), c, r, iters), polish(trig[0], c, r, iters),
                      polish(trig[1], c, r, iters), polish(trig[2], c, r, iters), lo, hi};
  return smallest_root(cands);
}

// diff/soft.py `_raw_roots_excluding_pair` at a cubic entry (|t3| > EPS):
// the root as if the two roots that merge as delta -> 0- had annihilated.
// Candidates: Cardano's root, the trigonometric root that survives the
// merge (k = 0 where r >= 0, else k = 1) and the dominant-balance
// quadratic's two roots, each polished (iters >= 1); a quadratic one is
// dropped where it lies within 1e-3 s + 1e-6 of either unpolished
// trigonometric root of the merging pair; then the smallest >= EPS
template <typename T>
__device__ __forceinline__ T root_excluding_pair(T t3, T t2, T t1, T t0,
                                                 const T (&c)[N_COEFS], const Ray<T>& r,
                                                 int iters) {
  const Depressed<T> d = depressed(t3, t2, t1, t0);
  T trig[3];
  trig_roots(d, trig);
  const bool r_pos = d.r >= T(0);
  const T pair_a = r_pos ? trig[1] : trig[0], pair_b = trig[2];
  T lo, hi;
  quadratic_roots(t2, t1, t0, abs_(t2) > T(EPS), lo, hi);
  T cands[4] = {polish(cardano(d, discriminant(d)), c, r, iters),
                polish(r_pos ? trig[0] : trig[1], c, r, iters), polish(lo, c, r, iters),
                polish(hi, c, r, iters)};
  const T pair_tol = d.s * T(1e-3) + T(1e-6);
#pragma unroll
  for (int i = 2; i < 4; ++i)
    if (abs_(cands[i] - pair_a) < pair_tol || abs_(cands[i] - pair_b) < pair_tol)
      cands[i] = T(BIG);
  return smallest_root(cands);
}

// The dtype the plain version computes in past the expansion: torch's
// promotion of the coefficients' and the rays' dtypes
template <typename C, typename R>
using Wider = typename std::conditional<(sizeof(C) > sizeof(R)), C, R>::type;

// The coefficient rows of the objects this block's entries solve for, in
// shared memory: row j holds object (obj0 + j) mod N, so entry i0 + tid
// reads row tid mod N. The caller synchronizes.
template <typename C, typename T>
__device__ __forceinline__ void stage_rows(T* rows, const C* coefs, int n_obj, long long c_row,
                                           long long c_col) {
  const long long i0 = (long long)blockIdx.x * BLOCK;
  const int n_rows = n_obj < BLOCK ? n_obj : BLOCK;
  const int obj0 = (int)(i0 % n_obj);
  for (int j = threadIdx.x; j < n_rows * N_COEFS; j += BLOCK) {
    int obj = obj0 + j / N_COEFS;
    if (obj >= n_obj) obj -= n_obj;
    rows[j] = T(coefs[obj * c_row + (j % N_COEFS) * c_col]);
  }
}

// Entry i's object coefficients c, its ray r in the wider dtype (the
// polish's points o + t d are computed in it, as torch promotes them) and
// the t^k coefficients tk[k] of F(o + t d): ops/poly.py `ray_poly_coeffs`,
// the expansion's columns in the rays' dtype, contracted with the
// coefficients in m order in the wider one
template <typename R, typename T>
__device__ __forceinline__ void expand_entry(const T* rows, const R* origin, const R* dir,
                                             const Layout& lay, long long i, int n_obj,
                                             T (&c)[N_COEFS], Ray<T>& r, T (&tk)[4]) {
  const T* row = rows + (threadIdx.x % n_obj) * N_COEFS;
#pragma unroll
  for (int m = 0; m < N_COEFS; ++m) c[m] = row[m];

  long long ray = i / n_obj, o_off = 0, d_off = 0;
  for (int k = lay.dims - 1; k >= 0; --k) {
    const long long digit = ray % lay.size[k];
    ray /= lay.size[k];
    o_off += digit * lay.o_stride[k];
    d_off += digit * lay.d_stride[k];
  }
  const Ray<R> rr{origin[o_off], origin[o_off + lay.o_comp], origin[o_off + 2 * lay.o_comp],
                  dir[d_off], dir[d_off + lay.d_comp], dir[d_off + 2 * lay.d_comp]};

  R po[3][4], pd[3][4];
  powers(po, rr.ox, rr.oy, rr.oz);
  powers(pd, rr.dx, rr.dy, rr.dz);
  tk[0] = tk[1] = tk[2] = tk[3] = T(0);
  R col = R(0);
#define TRT_TERM(K, M, FIRST, W, OX, OY, OZ, DX, DY, DZ)                \
  {                                                                     \
    R term = product<OX, OY, OZ>(po) * product<DX, DY, DZ>(pd);         \
    if (W != 1) term = term * R(W);                                     \
    col = FIRST ? term : col + term;                                    \
  }
#define TRT_COLUMN(K, M, FIRST) tk[K] = FIRST ? T(col) * c[M] : tk[K] + T(col) * c[M];
  TRT_EXPANSION(TRT_TERM, TRT_COLUMN)
#undef TRT_TERM
#undef TRT_COLUMN
  r = Ray<T>{T(rr.ox), T(rr.oy), T(rr.oz), T(rr.dx), T(rr.dy), T(rr.dz)};
}

// The root table of ops/solve_kernel.py `solve_roots`: intersect_all's
// forward, entry i = ray * n_obj + object
template <typename C, typename R>
__global__ void __launch_bounds__(BLOCK) solve_roots_kernel(
    const C* __restrict__ coefs, const R* __restrict__ origin, const R* __restrict__ dir,
    Wider<C, R>* __restrict__ out, const Layout lay, long long total, int n_obj,
    long long c_row, long long c_col, int iters) {
  using T = Wider<C, R>;
  __shared__ T rows[BLOCK * N_COEFS];
  stage_rows(rows, coefs, n_obj, c_row, c_col);
  __syncthreads();
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= total) return;
  T c[N_COEFS], tk[4];
  Ray<T> r;
  expand_entry(rows, origin, dir, lay, i, n_obj, c, r, tk);
  out[i] = select_root(tk[3], tk[2], tk[1], tk[0], c, r, iters);
}

// The root table of diff/soft.py `_raw_roots_excluding_pair`: a cubic
// entry of a cubic-class object (kind 1; kind -1 classes each entry by
// |t3| > EPS) takes `root_excluding_pair`; a quadric entry (|t2| > EPS) of
// a quadric-class object (kind 0, or -1) no root (-1); every other entry
// its normal root, t_normal[i] (intersect_all's table for the same rays)
template <typename C, typename R>
__global__ void __launch_bounds__(BLOCK) roots_excluding_pair_kernel(
    const C* __restrict__ coefs, const R* __restrict__ origin, const R* __restrict__ dir,
    const unsigned char* __restrict__ kinds, long long k_stride,
    const Wider<C, R>* __restrict__ t_normal, Wider<C, R>* __restrict__ out, const Layout lay,
    long long total, int n_obj, long long c_row, long long c_col, int iters) {
  using T = Wider<C, R>;
  __shared__ T rows[BLOCK * N_COEFS];
  stage_rows(rows, coefs, n_obj, c_row, c_col);
  __syncthreads();
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= total) return;
  T c[N_COEFS], tk[4];
  Ray<T> r;
  expand_entry(rows, origin, dir, lay, i, n_obj, c, r, tk);
  const bool is_cubic = abs_(tk[3]) > T(EPS), is_quad = abs_(tk[2]) > T(EPS);
  const int kind = kinds == nullptr ? -1 : kinds[(i % n_obj) * k_stride] != 0;
  if (is_cubic && kind != 0)
    out[i] = root_excluding_pair(tk[3], tk[2], tk[1], tk[0], c, r, iters);
  else
    out[i] = is_quad && kind != 1 ? T(-1) : t_normal[i];
}

// What both entries launch with
struct Launch {
  const void *coefs, *origin, *dir;
  void* out;
  Layout lay;
  long long total;
  int n_obj;
  long long c_row, c_col;
  int iters;
  unsigned blocks;
  cudaStream_t st;
};

// `a` from the entries' arguments (`layout`: ops/solve_kernel.py
// `solve_layout`, flattened); a CUDA error where they are out of range
cudaError_t make_launch(Launch& a, const void* coefs, const void* origin, const void* dir,
                        void* out, const long long* layout, int dims, long long rays, int n_obj,
                        long long c_row, long long c_col, int iters, void* stream) {
  if (dims < 0 || dims > MAX_DIMS || n_obj <= 0) return cudaErrorInvalidValue;
  for (int k = 0; k < MAX_DIMS; ++k) {
    a.lay.size[k] = layout[k];
    a.lay.o_stride[k] = layout[MAX_DIMS + k];
    a.lay.d_stride[k] = layout[2 * MAX_DIMS + k];
  }
  a.lay.o_comp = layout[3 * MAX_DIMS];
  a.lay.d_comp = layout[3 * MAX_DIMS + 1];
  a.lay.dims = dims;
  a.total = rays * n_obj;
  const long long blocks = (a.total + BLOCK - 1) / BLOCK;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  a.blocks = (unsigned)blocks;
  a.coefs = coefs;
  a.origin = origin;
  a.dir = dir;
  a.out = out;
  a.n_obj = n_obj;
  a.c_row = c_row;
  a.c_col = c_col;
  a.iters = iters;
  a.st = static_cast<cudaStream_t>(stream);
  return cudaSuccess;
}

template <typename C, typename R>
cudaError_t solve(const Launch& a) {
  solve_roots_kernel<C, R><<<a.blocks, BLOCK, 0, a.st>>>(
      static_cast<const C*>(a.coefs), static_cast<const R*>(a.origin),
      static_cast<const R*>(a.dir), static_cast<Wider<C, R>*>(a.out), a.lay, a.total, a.n_obj,
      a.c_row, a.c_col, a.iters);
  return cudaGetLastError();
}

template <typename C, typename R>
cudaError_t excluding_pair(const Launch& a, const void* kinds, long long k_stride,
                           const void* t_normal) {
  roots_excluding_pair_kernel<C, R><<<a.blocks, BLOCK, 0, a.st>>>(
      static_cast<const C*>(a.coefs), static_cast<const R*>(a.origin),
      static_cast<const R*>(a.dir), static_cast<const unsigned char*>(kinds), k_stride,
      static_cast<const Wider<C, R>*>(t_normal), static_cast<Wider<C, R>*>(a.out), a.lay,
      a.total, a.n_obj, a.c_row, a.c_col, a.iters);
  return cudaGetLastError();
}

// FN<C, R>(...) for the coefficients' dtype C and the rays' R
#define TRT_BY_DTYPE(FN, ...)                                                      \
  (coef_f64 ? (ray_f64 ? FN<double, double>(__VA_ARGS__) : FN<double, float>(__VA_ARGS__)) \
            : (ray_f64 ? FN<float, double>(__VA_ARGS__) : FN<float, float>(__VA_ARGS__)))

}  // namespace

// coefs [n_obj, 20] (element strides c_row, c_col; double if coef_f64, else
// float); origin and dir (double if ray_f64, else float) read through
// `layout` (ops/solve_kernel.py `solve_layout`: MAX_DIMS sizes, MAX_DIMS
// origin strides, MAX_DIMS dir strides, then origin's and dir's stride of x,
// y, z; the first `dims` of each used); out [rays, n_obj] contiguous, double
// if either is. Returns a CUDA error.
extern "C" int trt_solve_roots(const void* coefs, const void* origin, const void* dir,
                               void* out, const long long* layout, int dims, long long rays,
                               int n_obj, long long c_row, long long c_col, int iters,
                               int coef_f64, int ray_f64, void* stream) {
  Launch a;
  const cudaError_t bad = make_launch(a, coefs, origin, dir, out, layout, dims, rays, n_obj,
                                      c_row, c_col, iters, stream);
  return (int)(bad != cudaSuccess ? bad : TRT_BY_DTYPE(solve, a));
}

// As trt_solve_roots, with kinds (one byte an object, element stride
// k_stride; null: classed by entry) and t_normal [rays, n_obj] contiguous
// in out's dtype; iters >= 1.
extern "C" int trt_roots_excluding_pair(const void* coefs, const void* origin, const void* dir,
                                        const void* kinds, long long k_stride,
                                        const void* t_normal, void* out,
                                        const long long* layout, int dims, long long rays,
                                        int n_obj, long long c_row, long long c_col, int iters,
                                        int coef_f64, int ray_f64, void* stream) {
  Launch a;
  const cudaError_t bad = make_launch(a, coefs, origin, dir, out, layout, dims, rays, n_obj,
                                      c_row, c_col, iters, stream);
  if (bad != cudaSuccess) return (int)bad;
  if (iters < 1) return (int)cudaErrorInvalidValue;
  return (int)TRT_BY_DTYPE(excluding_pair, a, kinds, k_stride, t_normal);
}

extern "C" const char* trt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
