// K4 and K5: the fused D = 2 TDVP overlap objective and its rank-1 adjoint.
//
// K4 replaces qmps_tpu/kernels/tdvp_fused.py::_tdvp_fused_kernel (launched
// by _fused_forward), K5 replaces ::_tdvp_bwd_kernel (launched by
// _fused_backward_pallas).  The math, per batch element:
//
//   AA = A A, BB = B B (two-site blocks), WAA[s] = sum_t W[s, t] AA[t]
//   E[(i j), (k l)] = sum_s WAA[s, i, k] conj(BB[s, j, l])
//   (lam, v) = dominant right eigenpair of E by squaring (planes.cuh::
//              squarings4, chirp_read4); with with_left, u that of E^dag,
//              the left eigenvector of E, read off the conjugate transpose
//              of the same power (no second chain: (E^dag)^2 = (E^2)^dag)
//   objective = -|lam| (taken by the PyTorch wrapper)
//
// and the adjoint of -|lam|: K = coef conj(u) v^T with
// coef = -ct (conj(lam)/|lam|) / (u^dag v), pushed through the transposed
// E build (P pairs dWAA, C pairs dBB), the W product (Q pairs dAA, Wbar)
// and the two AA builds.  Abar, Bbar and the per-element Wbar come out in
// the JAX pairing convention (df = Re sum Xbar dX); the wrapper conjugates
// them and sums Wbar over the batch for a shared W.
//
// W is read through a per-element stride: 0 for one shared (4, 4) gate,
// 16 for a (B, 4, 4) batch, so one kernel serves both (the TPU kernels
// needed an SMEM and a VMEM variant).  A shared W's 16 entries are the
// same addresses for every thread and stay in L1.
//
// What bounds K4 on an H100: operations at large batches, one element's
// dependent chain at small ones.  It reads 256 bytes (128 with a shared W)
// and writes 72 per element against ~28,000 float32 flops (chip_smoke.py's
// kernel_work), 48 squarings of a 4x4 complex matrix with a norm, a
// reduction and an rsqrt after each.  Its design:
// - one chain: the JAX kernel, and this one before, squared E^dag in a
//   second chain for u, doubling the work;
// - a quad of lanes an element up to kQuadMaxB elements (the quench's
//   batch is 64: two 32-thread blocks of one thread an element ran one
//   thread's 96-squaring chain on 2 of 132 SMs).  Lane r owns row r of E
//   and of its power; each squaring fetches the other rows with width-4
//   __shfl_sync, forms row r of M^2 and takes the Frobenius norm as a
//   two-step butterfly, so a chain step is 16 multiply-adds, not 64.  The
//   reads off the power (v, u, lam) gather the whole matrix on every lane
//   once.  Above kQuadMaxB the card is full and the 34 shuffles a squaring
//   cost more than they save: one thread an element, the whole chain in
//   registers.  Measured (qmps_torch/kernel_ab.py, NVIDIA H100 80GB HBM3,
//   700 W): quad / thread 0.0130 / 0.0193 ms at 64, 0.0171 / 0.0204 at
//   8,192, 0.0220 / 0.0204 at 12,288, 0.1062 / 0.0628 at 65,536.
//
// K5 reads ~330 bytes and writes 256 against ~500 complex multiply-adds with
// no loop, one thread an element.  It holds A, B, v, K's row factor conj(u)
// coef, AA, P, C and Q (~100 complex values at the peak): BB and WAA are
// built in scopes that end once P and C are formed, K is never stored (its
// entries are formed as cu[r] v[c] where used), and W is re-read from memory
// instead of held.
#include "planes.cuh"

namespace qmps {

// WAA[s, i, j] = sum_t W[s, t] AA[t, i, j], W row-major (4, 4) in memory
__device__ __forceinline__ void build_WAA(const float2* w, const c32 aa[16], c32 waa[16]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int ij = 0; ij < 4; ++ij) {
      c32 acc = mk(0.f, 0.f);
#pragma unroll
      for (int t = 0; t < 4; ++t) cfma(acc, ld(w, s * 4 + t), aa[t * 4 + ij]);
      waa[s * 4 + ij] = acc;
    }
}

// K4, one thread an element (large batches)
__global__ void __launch_bounds__(kThreads)
    tdvp_fwd_kernel(const float2* __restrict__ A, const float2* __restrict__ Bm,
                    const float2* __restrict__ W, int w_stride, float2* __restrict__ lam_out,
                    float2* __restrict__ v_out, float2* __restrict__ u_out, int B, int iters,
                    int with_left) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  c32 e[16];
  {
    c32 a[8], bt[8], aa[16], waa[16], bb[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[k] = ld(A + (size_t)b * 8, k);
      bt[k] = ld(Bm + (size_t)b * 8, k);
    }
    build_AA(a, aa);
    build_WAA(W + (size_t)b * w_stride, aa, waa);
    build_AA(bt, bb);
    build_E_mixed(waa, bb, e);
  }
  c32 m[16], v[4];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = e[k];
  squarings4(m, iters);
  chirp_read4<false>(m, v);
  st(lam_out, b, rayleigh4(e, v));
#pragma unroll
  for (int i = 0; i < 4; ++i) st(v_out + (size_t)b * 4, i, v[i]);
  if (with_left) {
    c32 u[4];
    chirp_read4<true>(m, u);  // off M^dag: no chain on E^dag
#pragma unroll
    for (int i = 0; i < 4; ++i) st(u_out + (size_t)b * 4, i, u[i]);
  }
}

// K4 over a quad of lanes an element (small batches), 8 elements a block
constexpr int kQuadThreads = 32;

// row k of the quad's matrix, whose row q lane q holds (width-4 shuffles)
__device__ __forceinline__ c32 quad_get(c32 x, int k) {
  return mk(__shfl_sync(0xffffffffu, x.re, k, 4), __shfl_sync(0xffffffffu, x.im, k, 4));
}

// the whole 4x4 matrix on every lane of the quad
__device__ __forceinline__ void quad_gather(const c32 row[4], c32 full[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) full[k * 4 + c] = quad_get(row[c], k);
}

__global__ void __launch_bounds__(kQuadThreads)
    tdvp_fwd_quad_kernel(const float2* __restrict__ A, const float2* __restrict__ Bm,
                         const float2* __restrict__ W, int w_stride, float2* __restrict__ lam_out,
                         float2* __restrict__ v_out, float2* __restrict__ u_out, int B, int iters,
                         int with_left) {
  const int r = threadIdx.x & 3;  // this lane's row (i j) = (r >> 1, r & 1) of E and its power
  const long long elem = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const bool live = elem < B;
  // lanes past B compute on the last element (every lane takes part in the
  // shuffles) and store nothing
  const size_t b = live ? (size_t)elem : (size_t)(B - 1);
  c32 m[4];  // row r of E, then of its power
  {
    // AA, BB and WAA whole on each lane (~150 multiply-adds, against 48 x 16
    // in the chain), then E's row r: the sums of build_E_mixed in its order
    c32 a[8], bt[8], aa[16], waa[16], bb[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[k] = ld(A + b * 8, k);
      bt[k] = ld(Bm + b * 8, k);
    }
    build_AA(a, aa);
    build_WAA(W + b * w_stride, aa, waa);
    build_AA(bt, bb);
    const bool i1 = r >> 1, j1 = r & 1;
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        c32 acc = mk(0.f, 0.f);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          cfma(acc, i1 ? waa[s * 4 + 2 + k] : waa[s * 4 + k], conj(j1 ? bb[s * 4 + 2 + l] : bb[s * 4 + l]));
        m[k * 2 + l] = acc;
      }
  }
  c32 e[16];
  quad_gather(m, e);
  for (int it = 0; it < iters; ++it) {
    // row r of M^2 = sum_k M[r, k] M[k, :], k in matsq4's order
    c32 p[4] = {mk(0.f, 0.f), mk(0.f, 0.f), mk(0.f, 0.f), mk(0.f, 0.f)};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) cfma(p[c], m[k], quad_get(m[c], k));
    float n2 = norm2(p[0]) + norm2(p[1]) + norm2(p[2]) + norm2(p[3]);
    n2 += __shfl_xor_sync(0xffffffffu, n2, 1);
    n2 += __shfl_xor_sync(0xffffffffu, n2, 2);
    const float inv = rsqrtf(fmaxf(n2, 1e-30f));
#pragma unroll
    for (int c = 0; c < 4; ++c) m[c] = inv * p[c];
  }
  // the reads off the power, whole on every lane: a few hundred flops once
  c32 mf[16], v[4], u[4];
  quad_gather(m, mf);
  chirp_read4<false>(mf, v);
  if (with_left) chirp_read4<true>(mf, u);  // off M^dag: no chain on E^dag
  const c32 lam = rayleigh4(e, v);
  if (!live) return;
  if (r == 0) st(lam_out, b, lam);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c == r) {
      st(v_out + b * 4, c, v[c]);
      if (with_left) st(u_out + b * 4, c, u[c]);
    }
}

__global__ void __launch_bounds__(kThreads)
    tdvp_bwd_kernel(const float2* __restrict__ A, const float2* __restrict__ Bm,
                    const float2* __restrict__ W, int w_stride, const float2* __restrict__ V,
                    const float2* __restrict__ U, const float2* __restrict__ LAM,
                    const float* __restrict__ CT, float2* __restrict__ abar_out,
                    float2* __restrict__ bbar_out, float2* __restrict__ wbar_out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float2* w = W + (size_t)b * w_stride;
  c32 a[8], bt[8], v[4], cu[4];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = ld(A + (size_t)b * 8, k);
    bt[k] = ld(Bm + (size_t)b * 8, k);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = ld(V + (size_t)b * 4, i);

  // coef = -ct (conj(lam)/|lam|) / (u^dag v), the floors of tdvp_fused.py:288-290;
  // K[r, c] = cu[r] v[c] with cu = coef conj(u)
  {
    c32 u[4], d = mk(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u[i] = ld(U + (size_t)b * 4, i);
      cfma(d, conj(u[i]), v[i]);
    }
    const c32 lam = ld(LAM, b);
    const c32 nrm = rsqrtf(fmaxf(norm2(lam), 1e-30f)) * conj(lam);
    const float dn = 1.0f / fmaxf(norm2(d), 1e-30f);
    const c32 coef = (-CT[b] * dn) * (nrm * conj(d));
#pragma unroll
    for (int r = 0; r < 4; ++r) cu[r] = coef * conj(u[r]);
  }

  c32 aa[16], P[16], C[16];
  build_AA(a, aa);
  {
    // P[s, i, k] = sum_{j,l} K[(i j), (k l)] conj(BB[s, j, l])   (pairs dWAA)
    c32 bb[16];
    build_AA(bt, bb);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          c32 acc = mk(0.f, 0.f);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            c32 in = mk(0.f, 0.f);
#pragma unroll
            for (int l = 0; l < 2; ++l) cfma(in, v[k * 2 + l], conj(bb[s * 4 + j * 2 + l]));
            cfma(acc, cu[i * 2 + j], in);
          }
          P[s * 4 + i * 2 + k] = acc;
        }
  }
  {
    // C[s, j, l] = conj(sum_{i,k} K[(i j), (k l)] WAA[s, i, k])   (pairs dBB)
    c32 waa[16];
    build_WAA(w, aa, waa);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          c32 acc = mk(0.f, 0.f);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            c32 in = mk(0.f, 0.f);
#pragma unroll
            for (int k = 0; k < 2; ++k) cfma(in, v[k * 2 + l], waa[s * 4 + i * 2 + k]);
            cfma(acc, cu[i * 2 + j], in);
          }
          C[s * 4 + j * 2 + l] = conj(acc);
        }
  }
  // per-element Wbar[s, t] = sum_{i,k} P[s, i, k] AA[t, i, k]
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      c32 acc = mk(0.f, 0.f);
#pragma unroll
      for (int ik = 0; ik < 4; ++ik) cfma(acc, P[s * 4 + ik], aa[t * 4 + ik]);
      st(wbar_out + (size_t)b * 16, s * 4 + t, acc);
    }
  // Q[t, i, k] = sum_s P[s, i, k] W[s, t]   (pairs dAA)
  c32 Q[16];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int ik = 0; ik < 4; ++ik) {
      c32 acc = mk(0.f, 0.f);
#pragma unroll
      for (int s = 0; s < 4; ++s) cfma(acc, P[s * 4 + ik], ld(w, s * 4 + t));
      Q[t * 4 + ik] = acc;
    }
  store_aa_adjoint(Q, a, abar_out + (size_t)b * 8);
  store_aa_adjoint(C, bt, bbar_out + (size_t)b * 8);
}

}  // namespace qmps

// The largest batch K4 runs over quads of lanes; above it, one thread an
// element: the crossover lies between 8,192 and 12,288 (the note at the top).
constexpr int kQuadMaxB = 8192;

// A, B (B, 2, 2, 2) complex64 and W ((4, 4) with w_stride 0, or (B, 4, 4)
// with w_stride 16) -> lam (B,), v (B, 4) and, if with_left, u (B, 4)
// complex64 (u may be null otherwise).  Returns cudaGetLastError().
extern "C" int qmps_tdvp_fwd(const void* A, const void* Bm, const void* W, int w_stride, void* lam,
                             void* v, void* u, int B, int iters, int with_left, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= kQuadMaxB) {
    const int grid = (4 * B + qmps::kQuadThreads - 1) / qmps::kQuadThreads;
    qmps::tdvp_fwd_quad_kernel<<<grid, qmps::kQuadThreads, 0, s>>>(
        (const float2*)A, (const float2*)Bm, (const float2*)W, w_stride, (float2*)lam, (float2*)v,
        (float2*)u, B, iters, with_left);
  } else {
    const int grid = (B + qmps::kThreads - 1) / qmps::kThreads;
    qmps::tdvp_fwd_kernel<<<grid, qmps::kThreads, 0, s>>>(
        (const float2*)A, (const float2*)Bm, (const float2*)W, w_stride, (float2*)lam, (float2*)v,
        (float2*)u, B, iters, with_left);
  }
  return (int)cudaGetLastError();
}

// The forward's A, B, W (and stride), v, the left vector u, lam and the
// cotangent ct (B,) float32 -> Abar, Bbar (B, 2, 2, 2) and the per-element
// Wbar (B, 4, 4) complex64, JAX pairing convention.  Returns
// cudaGetLastError().
extern "C" int qmps_tdvp_bwd(const void* A, const void* Bm, const void* W, int w_stride,
                             const void* v, const void* u, const void* lam, const void* ct,
                             void* abar, void* bbar, void* wbar, int B, void* stream) {
  const int grid = (B + qmps::kThreads - 1) / qmps::kThreads;
  qmps::tdvp_bwd_kernel<<<grid, qmps::kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)A, (const float2*)Bm, (const float2*)W, w_stride, (const float2*)v,
      (const float2*)u, (const float2*)lam, (const float*)ct, (float2*)abar, (float2*)bbar,
      (float2*)wbar, B);
  return (int)cudaGetLastError();
}
