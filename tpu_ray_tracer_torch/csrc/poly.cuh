// Polynomial helpers shared by the forward and backward render kernels:
// constants of the reference, the 20-monomial basis of degree <= 3 and the
// evaluation of F and grad F at cached point powers. Everything here is in
// an anonymous namespace: each kernel source is its own translation unit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float EPS = 1e-7f;
constexpr float SHADOW_BIAS = 1e-2f;
constexpr double PI_D = 3.14159265358979323846;
constexpr float INV_PI = (float)(1.0 / PI_D);
constexpr float FOUR_PI = (float)(4.0 * PI_D);
constexpr int N_COEFS = 20;
constexpr int QUAD_START = 10;  // first degree-<=2 monomial (x2)

// Monomial exponents (px, py, pz) as hex digits 0xXYZ, in the reference order
// x3 y3 z3 x2y xy2 x2z xz2 y2z yz2 xyz x2 y2 z2 xy xz yz x y z c
// (models/surface.py MONOMIAL_POWERS).
__host__ __device__ constexpr int mono_code(int m) {
  return m == 0 ? 0x300 : m == 1 ? 0x030 : m == 2 ? 0x003 : m == 3 ? 0x210
       : m == 4 ? 0x120 : m == 5 ? 0x201 : m == 6 ? 0x102 : m == 7 ? 0x021
       : m == 8 ? 0x012 : m == 9 ? 0x111 : m == 10 ? 0x200 : m == 11 ? 0x020
       : m == 12 ? 0x002 : m == 13 ? 0x110 : m == 14 ? 0x101 : m == 15 ? 0x011
       : m == 16 ? 0x100 : m == 17 ? 0x010 : m == 18 ? 0x001 : 0x000;
}
__host__ __device__ constexpr int mpow(int m, int axis) {
  return (mono_code(m) >> (4 * (2 - axis))) & 0xF;
}
static_assert(mpow(3, 0) == 2 && mpow(3, 1) == 1 && mpow(3, 2) == 0, "x2y");
static_assert(mpow(9, 0) == 1 && mpow(9, 1) == 1 && mpow(9, 2) == 1, "xyz");
static_assert(mpow(15, 1) == 1 && mpow(15, 2) == 1 && mpow(19, 0) == 0, "yz, c");

// NaN-propagating max/min, as jnp.maximum / torch.maximum (fmaxf drops NaN).
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// P[a][e] = component a to the power e; P[a][0] = 1, so a product over all
// three axes equals the Pallas `_prod` over the nonzero exponents exactly.
struct Pow3 {
  float v[3][4];
};

__device__ __forceinline__ Pow3 powers(float x, float y, float z) {
  Pow3 P;
  const float c[3] = {x, y, z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    P.v[a][0] = 1.f;
    P.v[a][1] = c[a];
    P.v[a][2] = c[a] * c[a];
    P.v[a][3] = P.v[a][2] * c[a];
  }
  return P;
}

__device__ __forceinline__ float mono(const Pow3& P, int ex, int ey, int ez) {
  return P.v[0][ex] * P.v[1][ey] * P.v[2][ez];
}

// F, sum |terms| and dF at the point powers P, over monomials [M_START, 20)
// (Pallas `_eval_F_and_grad`, :168).
template <int M_START, bool NEED_MAG, bool NEED_GRAD>
__device__ __forceinline__ void eval_F(const float* c, const Pow3& P, float& f,
                                       float& mag, float g[3]) {
  f = 0.f;
  mag = 0.f;
  g[0] = g[1] = g[2] = 0.f;
#pragma unroll
  for (int m = M_START; m < N_COEFS; ++m) {
    const int ex = mpow(m, 0), ey = mpow(m, 1), ez = mpow(m, 2);
    const float term = c[m] * mono(P, ex, ey, ez);
    f += term;
    if (NEED_MAG) mag += fabsf(term);
    if (NEED_GRAD) {
      if (ex > 0) g[0] += (c[m] * (float)ex) * mono(P, ex - 1, ey, ez);
      if (ey > 0) g[1] += (c[m] * (float)ey) * mono(P, ex, ey - 1, ez);
      if (ez > 0) g[2] += (c[m] * (float)ez) * mono(P, ex, ey, ez - 1);
    }
  }
}

}  // namespace
