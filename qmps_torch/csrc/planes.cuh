// Device helpers shared by the D = 2 kernels: complex float32 arithmetic in
// registers, the two-site block AA, the transfer matrix E and the N = 4
// dominant-eigenpair solve.
//
// Counterparts in the JAX package: tdvp_fused.py::_cmul / _plane_AA,
// energy_fused.py::_plane_E, pallas_power.py::_solve_planes (squaring) and
// ::_power_kernel (power iteration).  There every quantity is a
// (rows, 128) plane of the batch; here it is one scalar of one thread's
// batch element, so the same unrolled algebra runs per thread with all
// state in registers.
//
// Index conventions (as in the JAX package):
//   A[s, i, j]        -> a[s*4 + i*2 + j]            (8 complex)
//   AA[(s1 s2), i, j] -> aa[(s1*2 + s2)*4 + i*2 + j] (16 complex)
//   E[(i j), (k l)]   -> e[(i*2 + j)*4 + k*2 + l]    (16 complex, row-major 4x4)
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace qmps {

// Threads per block for every kernel of the slice.  One thread owns one
// batch element; 32-thread blocks spread a 4096-element batch over 128 SMs
// (the work is latency-bound, so SM coverage beats occupancy), and let a
// thread keep up to 255 registers.
constexpr int kThreads = 32;

struct c32 {
  float re, im;
};

__device__ __forceinline__ c32 mk(float re, float im) { return c32{re, im}; }
__device__ __forceinline__ c32 operator+(c32 a, c32 b) { return c32{a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ c32 operator-(c32 a, c32 b) { return c32{a.re - b.re, a.im - b.im}; }
__device__ __forceinline__ c32 operator*(c32 a, c32 b) {
  return c32{a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__device__ __forceinline__ c32 operator*(float s, c32 a) { return c32{s * a.re, s * a.im}; }
__device__ __forceinline__ c32 conj(c32 a) { return c32{a.re, -a.im}; }
__device__ __forceinline__ float norm2(c32 a) { return a.re * a.re + a.im * a.im; }
// acc += a * b
__device__ __forceinline__ void cfma(c32& acc, c32 a, c32 b) {
  acc.re += a.re * b.re - a.im * b.im;
  acc.im += a.re * b.im + a.im * b.re;
}
// a / b with the denominator floored as the JAX kernels floor it
__device__ __forceinline__ c32 cdiv_floored(c32 a, c32 b) {
  float den = 1.0f / fmaxf(norm2(b), 1e-30f);
  return c32{(a.re * b.re + a.im * b.im) * den, (a.im * b.re - a.re * b.im) * den};
}

// complex64 memory (interleaved re, im) <-> registers
__device__ __forceinline__ c32 ld(const float2* p, int k) {
  float2 x = p[k];
  return c32{x.x, x.y};
}
__device__ __forceinline__ void st(float2* p, int k, c32 a) { p[k] = make_float2(a.re, a.im); }

// AA[(s1 s2), i, j] = sum_k A[s1, i, k] A[s2, k, j]   (tdvp_fused.py::_plane_AA)
__device__ __forceinline__ void build_AA(const c32 a[8], c32 aa[16]) {
#pragma unroll
  for (int s1 = 0; s1 < 2; ++s1)
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          c32 acc = a[s1 * 4 + i * 2 + 0] * a[s2 * 4 + 0 * 2 + j];
          cfma(acc, a[s1 * 4 + i * 2 + 1], a[s2 * 4 + 1 * 2 + j]);
          aa[(s1 * 2 + s2) * 4 + i * 2 + j] = acc;
        }
}

// E[(i j), (k l)] = sum_s AA[s, i, k] conj(AA[s, j, l])   (energy_fused.py::_plane_E)
__device__ __forceinline__ void build_E(const c32 aa[16], c32 e[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          c32 acc = mk(0.f, 0.f);
#pragma unroll
          for (int s = 0; s < 4; ++s) cfma(acc, aa[s * 4 + i * 2 + k], conj(aa[s * 4 + j * 2 + l]));
          e[(i * 2 + j) * 4 + k * 2 + l] = acc;
        }
}

// w = M x for a 4x4 row-major M
__device__ __forceinline__ void matvec4(const c32 m[16], const c32 x[4], c32 w[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c32 acc = mk(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j) cfma(acc, m[i * 4 + j], x[j]);
    w[i] = acc;
  }
}

// r = m m (4x4 complex)
__device__ __forceinline__ void matsq4(const c32 m[16], c32 r[16]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      c32 acc = mk(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) cfma(acc, m[a * 4 + k], m[k * 4 + b]);
      r[a * 4 + b] = acc;
    }
}

// x <- x * rsqrt(max(sum |x|^2, 1e-30)), the clamp of pallas_power.py:78,115,147
template <int N>
__device__ __forceinline__ void normalize(c32 x[N]) {
  float n2 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) n2 += norm2(x[i]);
  float inv = rsqrtf(fmaxf(n2, 1e-30f));
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = inv * x[i];
}

// The two fixed start vectors of pallas_power.py::_chirps (N = 4):
//   c1[j] = (cos(0.7 j + 0.3), sin(1.3 j + 1.1))
//   c2[j] = (cos(1.9 j + 0.8), sin(0.5 j + 2.0))
// (evaluated in double and rounded once, as the Python constants are; j is
// a compile-time constant in every unrolled caller, so this folds away)
__device__ __forceinline__ c32 chirp(int which, int j) {
  return which == 0 ? mk((float)cos(0.7 * j + 0.3), (float)sin(1.3 * j + 1.1))
                    : mk((float)cos(1.9 * j + 0.8), (float)sin(0.5 * j + 2.0));
}

enum SolveMethod { kSquaring = 0, kPower = 1 };

// Dominant right eigenpair of one 4x4 complex matrix e: lam and unit v.
//
// kSquaring (pallas_power.py::_solve_planes): m <- m^2 / ||m^2||_F, iters
// times; v is the converged power applied to the two chirps, the larger of
// the two results, normalised; lam = v^dag e v with the original e.
// kPower (pallas_power.py::_power_kernel): v from column 0 of e plus a
// dither, iters normalised matvecs, lam the Rayleigh quotient.
__device__ __forceinline__ void solve4(const c32 e[16], int iters, int method, c32& lam, c32 v[4]) {
  if (method == kPower) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = mk(e[i * 4].re + (float)(0.37 * cos(1.7 * i + 0.3)), e[i * 4].im);
    for (int it = 0; it < iters; ++it) {
      c32 w[4];
      matvec4(e, v, w);
      normalize<4>(w);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = w[i];
    }
  } else {
    c32 m[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = e[k];
    for (int it = 0; it < iters; ++it) {
      c32 r[16];
      matsq4(m, r);
      normalize<16>(r);
#pragma unroll
      for (int k = 0; k < 16; ++k) m[k] = r[k];
    }
    c32 c[4], v1[4], v2[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = chirp(0, j);
    matvec4(m, c, v1);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = chirp(1, j);
    matvec4(m, c, v2);
    float n1 = 0.f, n2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      n1 += norm2(v1[i]);
      n2 += norm2(v2[i]);
    }
    const bool use1 = n1 >= n2;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = use1 ? v1[i] : v2[i];
    normalize<4>(v);
  }
  // Rayleigh quotient lam = v^dag (e v), v unit norm
  c32 w[4];
  matvec4(e, v, w);
  lam = mk(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) cfma(lam, conj(v[i]), w[i]);
}

}  // namespace qmps
