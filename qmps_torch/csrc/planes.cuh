// Device helpers shared by the D = 2 kernels: complex float32 arithmetic in
// registers, the two-site block AA, the transfer matrix E and the N = 4
// dominant-eigenpair solve.
//
// Counterparts in the JAX package: tdvp_fused.py::_cmul / _plane_AA /
// _build_E_planes, energy_fused.py::_plane_E and the AA-build adjoint,
// pallas_power.py::_solve_planes (squaring) and ::_power_kernel (power
// iteration).  There every quantity is a (rows, 128) plane of the batch;
// here it is one scalar of one thread's batch element, so the same unrolled
// algebra runs per thread with all state in registers.
//
// Index conventions (as in the JAX package):
//   A[s, i, j]        -> a[s*4 + i*2 + j]            (8 complex)
//   AA[(s1 s2), i, j] -> aa[(s1*2 + s2)*4 + i*2 + j] (16 complex)
//   E[(i j), (k l)]   -> e[(i*2 + j)*4 + k*2 + l]    (16 complex, row-major 4x4)
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace qmps {

// Threads per block for the kernels where one thread owns one batch
// element; 32-thread blocks spread a 4096-element batch over 128 SMs (the
// work is latency-bound, so SM coverage beats occupancy), and let a thread
// keep up to 255 registers.
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

// The adjoint of the two-site block AA = A A (build_AA): g pairs with dAA ->
// out[s, a, b] = sum_{t,j} g[(s t), a, j] A[t, b, j] + sum_{t,i} g[(t s), i, b] A[t, i, a]
__device__ __forceinline__ void store_aa_adjoint(const c32 g[16], const c32 a[8], float2* out) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        c32 acc = mk(0.f, 0.f);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
#pragma unroll
          for (int j = 0; j < 2; ++j) cfma(acc, g[(s * 2 + t) * 4 + p * 2 + j], a[t * 4 + c * 2 + j]);
#pragma unroll
          for (int i = 0; i < 2; ++i) cfma(acc, g[(t * 2 + s) * 4 + i * 2 + c], a[t * 4 + i * 2 + p]);
        }
        st(out, s * 4 + p * 2 + c, acc);
      }
}

// Mixed transfer matrix E[(i j), (k l)] = sum_s X[s, i, k] conj(Y[s, j, l])
// of two-site blocks X (ket) and Y (bra)   (tdvp_fused.py::_build_E_planes)
__device__ __forceinline__ void build_E_mixed(const c32 x[16], const c32 y[16], c32 e[16]) {
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
          for (int s = 0; s < 4; ++s) cfma(acc, x[s * 4 + i * 2 + k], conj(y[s * 4 + j * 2 + l]));
          e[(i * 2 + j) * 4 + k * 2 + l] = acc;
        }
}

// Row r = (i j) of build_E_mixed, its sums in the same order (the quad
// layouts: lane r builds the row it owns)
__device__ __forceinline__ void build_E_mixed_row(const c32 x[16], const c32 y[16], int r, c32 row[4]) {
  const bool i1 = r >> 1, j1 = r & 1;
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      c32 acc = mk(0.f, 0.f);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        cfma(acc, i1 ? x[s * 4 + 2 + k] : x[s * 4 + k], conj(j1 ? y[s * 4 + 2 + l] : y[s * 4 + l]));
      row[k * 2 + l] = acc;
    }
}

// E[(i j), (k l)] = sum_s AA[s, i, k] conj(AA[s, j, l])   (energy_fused.py::_plane_E)
__device__ __forceinline__ void build_E(const c32 aa[16], c32 e[16]) { build_E_mixed(aa, aa, e); }

// Column c = (k l) of build_E, its sums in the same order (K3's quad: lane
// c builds row c of E^T)
__device__ __forceinline__ void build_E_col(const c32 aa[16], int c, c32 col[4]) {
  const bool k1 = c >> 1, l1 = c & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      c32 acc = mk(0.f, 0.f);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        cfma(acc, k1 ? aa[s * 4 + i * 2 + 1] : aa[s * 4 + i * 2], conj(l1 ? aa[s * 4 + j * 2 + 1] : aa[s * 4 + j * 2]));
      col[i * 2 + j] = acc;
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

// m <- m^2 / ||m^2||_F, iters times (the squaring chain of _solve_planes)
__device__ __forceinline__ void squarings4(c32 m[16], int iters) {
  for (int it = 0; it < iters; ++it) {
    c32 r[16];
    matsq4(m, r);
    normalize<16>(r);
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = r[k];
  }
}

// A quad of lanes an element (K2 and K4 at small batches): lane r of the
// quad owns row r of a 4x4 matrix; width-4 shuffles fetch the other rows.
constexpr int kQuadThreads = 32;  // 8 elements a block

// row k of the quad's matrix, whose row q lane q holds
__device__ __forceinline__ c32 quad_get(c32 x, int k) {
  return mk(__shfl_sync(0xffffffffu, x.re, k, 4), __shfl_sync(0xffffffffu, x.im, k, 4));
}

// the sum of x over the quad, on every lane (a two-round butterfly)
__device__ __forceinline__ c32 quad_sum(c32 x) {
#pragma unroll
  for (int m = 1; m < 4; m <<= 1)
    x = x + mk(__shfl_xor_sync(0xffffffffu, x.re, m), __shfl_xor_sync(0xffffffffu, x.im, m));
  return x;
}

// row r of a 4 x 4 array, selected in registers by unrolled compares (an
// index by the lane's r would put the array in local memory)
__device__ __forceinline__ void select_row(const c32 x[16], int r, c32 row[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    row[c] = x[c];
#pragma unroll
    for (int t = 1; t < 4; ++t)
      if (t == r) row[c] = x[t * 4 + c];
  }
}

// the whole 4x4 matrix on every lane of the quad
__device__ __forceinline__ void quad_gather(const c32 row[4], c32 full[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) full[k * 4 + c] = quad_get(row[c], k);
}

// This lane's row of the quad's M^2, m its row of M: row r of M^2 = sum_k
// M[r, k] M[k, :] (k in matsq4's order), 16 multiply-adds a lane
__device__ __forceinline__ void quad_square_row(const c32 m[4], c32 p[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) p[c] = mk(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) cfma(p[c], m[k], quad_get(m[c], k));
}

// squarings4 over the quad: m is this lane's row, squared by
// quad_square_row; the Frobenius norm as a two-step butterfly
__device__ __forceinline__ void quad_squarings4(c32 m[4], int iters) {
  for (int it = 0; it < iters; ++it) {
    c32 p[4];
    quad_square_row(m, p);
    float n2 = norm2(p[0]) + norm2(p[1]) + norm2(p[2]) + norm2(p[3]);
    n2 += __shfl_xor_sync(0xffffffffu, n2, 1);
    n2 += __shfl_xor_sync(0xffffffffu, n2, 2);
    const float inv = rsqrtf(fmaxf(n2, 1e-30f));
#pragma unroll
    for (int c = 0; c < 4; ++c) m[c] = inv * p[c];
  }
}

// The eigenvector read off a converged power m (pallas_power.py::
// _extract_eigpair): m c for the two chirps, the larger of the two,
// normalised.  kDagger reads m^dag instead, the power of e^dag: its
// dominant right eigenvector is e's left one (kernels/pallas_power.py::
// _left_vector), with no second squaring chain.
template <bool kDagger>
__device__ __forceinline__ void chirp_read4(const c32 m[16], c32 v[4]) {
  c32 v1[4], v2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v1[i] = mk(0.f, 0.f);
    v2[i] = mk(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const c32 x = kDagger ? conj(m[j * 4 + i]) : m[i * 4 + j];
      cfma(v1[i], x, chirp(0, j));
      cfma(v2[i], x, chirp(1, j));
    }
  }
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

// The Rayleigh quotient lam = v^dag (e v), v unit norm
__device__ __forceinline__ c32 rayleigh4(const c32 e[16], const c32 v[4]) {
  c32 w[4];
  matvec4(e, v, w);
  c32 lam = mk(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) cfma(lam, conj(v[i]), w[i]);
  return lam;
}

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
    squarings4(m, iters);
    chirp_read4<false>(m, v);
  }
  lam = rayleigh4(e, v);
}

}  // namespace qmps
