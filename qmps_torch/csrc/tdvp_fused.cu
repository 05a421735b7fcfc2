// K4 and K5: the fused D = 2 TDVP overlap objective and its rank-1 adjoint.
//
// K4 replaces qmps_tpu/kernels/tdvp_fused.py::_tdvp_fused_kernel (launched
// by _fused_forward), K5 replaces ::_tdvp_bwd_kernel (launched by
// _fused_backward_pallas).  The math, per batch element:
//
//   AA = A A, BB = B B (two-site blocks), WAA[s] = sum_t W[s, t] AA[t]
//   E[(i j), (k l)] = sum_s WAA[s, i, k] conj(BB[s, j, l])
//   (lam, v) = dominant right eigenpair of E (planes.cuh::solve4); with
//              with_left, u = that of E^dag, the left eigenvector of E
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
// What bounds them on an H100: arithmetic latency in registers, not memory.
// K4 reads 256 bytes (128 with a shared W) and writes 72 per element
// against ~200 complex multiply-adds of builds and 2 x 48 dependent
// squarings of the 4x4 solve (~6,000 complex multiply-adds); K5 reads ~330
// bytes and writes 256 against ~500 complex multiply-adds with no loop.  At
// the quench's batch (64 trajectories) each is two 32-thread blocks, so its
// time is one thread's dependent chain.  K5 holds A, B, v, K's row factor
// conj(u) coef, AA, P, C and Q (~100 complex values at the peak): BB and
// WAA are built in scopes that end once P and C are formed, K is never
// stored (its entries are formed as cu[r] v[c] where used), and W is
// re-read from memory instead of held.
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
  c32 lam, v[4];
  solve4(e, iters, kSquaring, lam, v);
  st(lam_out, b, lam);
#pragma unroll
  for (int i = 0; i < 4; ++i) st(v_out + (size_t)b * 4, i, v[i]);
  if (with_left) {
    // E^dag[(k l), (i j)] = conj(E[(i j), (k l)]): a register transpose;
    // its dominant right eigenvector is E's left one (tdvp_fused.py:146-147)
    c32 ed[16], lam_l, u[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) ed[r * 4 + c] = conj(e[c * 4 + r]);
    solve4(ed, iters, kSquaring, lam_l, u);
#pragma unroll
    for (int i = 0; i < 4; ++i) st(u_out + (size_t)b * 4, i, u[i]);
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

// A, B (B, 2, 2, 2) complex64 and W ((4, 4) with w_stride 0, or (B, 4, 4)
// with w_stride 16) -> lam (B,), v (B, 4) and, if with_left, u (B, 4)
// complex64 (u may be null otherwise).  Returns cudaGetLastError().
extern "C" int qmps_tdvp_fwd(const void* A, const void* Bm, const void* W, int w_stride, void* lam,
                             void* v, void* u, int B, int iters, int with_left, void* stream) {
  const int grid = (B + qmps::kThreads - 1) / qmps::kThreads;
  qmps::tdvp_fwd_kernel<<<grid, qmps::kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)A, (const float2*)Bm, (const float2*)W, w_stride, (float2*)lam, (float2*)v,
      (float2*)u, B, iters, with_left);
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
