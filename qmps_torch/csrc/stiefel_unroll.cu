// The Stiefel sweep's environment unroll and its adjoint, one launch each
// (stiefel_unroll_fwd_kernel, stiefel_unroll_bwd_kernel).
//
// They replace no TPU kernel: the JAX package runs the unroll
// (qmps_tpu/mps/transfer.py::right_eigpair_warm_unroll) through XLA, and the
// port ran it as plain autograd through ``mps/transfer._power_forward``:
// per iteration two batched 32x16x16 complex gemms, a Frobenius norm and a
// division, ~2,250 small kernels a descent step at D = 16 that each do
// under a microsecond of work.
//
// The math, per row (one point and restart; d = 2, A_s = V[:, s, :] of the
// isometry V whose rows are (i, s)):
//
//   r_0 = r0 / ||r0||,  W_k = sum_s A_s r_k A_s^dag,  r_{k+1} = W_k / ||W_k||
//   lam = <r, sum_s A_s r A_s^dag>,  r = r_iters
//
// and, walking k = iters-1 .. 0 from g = rbar (torch's convention: the
// conjugate of jax.grad, dL = Re <g, dr>):
//
//   G_W = (g - Re<r_{k+1}, g> r_{k+1}) / ||W_k||
//   Abar_s += G_W A_s r_k^dag + G_W^dag A_s r_k
//   g <- sum_s A_s^dag G_W A_s
//
// (kernels/stiefel_unroll.py has the same in plain PyTorch, _fwd_plain and
// _bwd_plain, and the Rayleigh quotient's own cotangent.)
//
// What bounds them on an H100: the float32 multiply-adds and the shared-
// memory loads that feed them.  A row at D = 16 does 4 D^3 complex
// multiply-adds an iteration forward and 10 D^3 backward over 96 dependent
// iterations, on 11 KB (forward) and 17 KB (backward) of state that never
// leaves the SM.  So one block
// owns one row: A, r and the products stay in shared memory across all
// iterations, each thread accumulates a 2 x 2 or 2 x 4 block of a product
// in registers, so one shared-memory load feeds two or four complex
// multiply-adds (a product summed over 2 DP runs as two halves that meet by
// one shuffle), and the Frobenius norms are warp shuffles and one shared-
// memory step.  Full float32 on the CUDA cores, accumulation in float32: the
// configuration states TF32 off.  The forward keeps the iterates r_k and
// the norms ||W_k|| in device memory only when a gradient is needed; the
// backward reads them back one iteration at a time, and A's cotangent stays
// in registers until the end.
//
// Every D up to 32 runs, padded with zeros to DP = 8, 16 or 32 (the zeros
// change no sum).  A block has DP^2 / 2 threads: 128 at D = 16, so a
// 1,024-row batch is one wave of 8 blocks an SM on 132 SMs.  Measured on an
// H100 (80GB HBM3, 700 W; chip_smoke.py phase 14), 1,024 rows x 96
// iterations at D = 16: forward 0.50 ms, backward 1.12 ms, 39% and 43% of
// their float32 bound; plain autograd through the same iterations, replayed
// as a CUDA graph, 2.84 and 8.95 ms.
#include "planes.cuh"

namespace qmps {
namespace unroll {

template <int DP>
struct Shape {
  static constexpr int NT = DP * DP / 2;   // threads of a block (one row)
  static constexpr int NW = NT / 32;       // its warps
  static constexpr int NB = DP / 2;        // thread (tm, tn): tm in [0, DP), tn in [0, NB) (coords())
  static constexpr int LD = DP + 1;        // padded row stride of a DP-wide plane, in complex
  static constexpr int LDPQ = 2 * DP + 1;  // of the backward's (2 DP, 2 DP) [P; Q]
  static constexpr int MINB = 1024 / NT;   // blocks an SM: at most 64 registers a thread
  // the backward's dynamic shared memory: A, r_k, G_W, [P; Q]
  static constexpr int BWD_BYTES = (2 * DP * LD + 2 * DP * LD + 2 * DP * LDPQ) * 8;
};

// acc[a][c] += sum_k L(a, k) R(k, c): one thread's TM x TN block of a
// product whose operands L and R read shared memory (a, c and k are
// compile-time constants after the unroll, so the operands' branches fold)
template <int TM, int TN, int K, class LF, class RF>
__device__ __forceinline__ void tile_mac(c32 (&acc)[TM][TN], LF L, RF R) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    c32 l[TM], r[TN];
#pragma unroll
    for (int a = 0; a < TM; ++a) l[a] = L(a, k);
#pragma unroll
    for (int c = 0; c < TN; ++c) r[c] = R(k, c);
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int c = 0; c < TN; ++c) cfma(acc[a][c], l[a], r[c]);
  }
}

// the sum of x over the block, on every thread: a shuffle butterfly in each
// warp, then each warp's sum in red[] and one barrier.  The caller puts a
// barrier between two calls (red is rewritten).
template <int NW>
__device__ __forceinline__ c32 block_sum(c32 x, float2* red) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    x = x + mk(__shfl_xor_sync(0xffffffffu, x.re, m), __shfl_xor_sync(0xffffffffu, x.im, m));
  if (NW == 1) return x;
  if ((threadIdx.x & 31) == 0) st(red, threadIdx.x >> 5, x);
  __syncthreads();
  c32 s = mk(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < NW; ++w) s = s + ld(red, w);
  return s;
}

// A (from V's rows (i, s)) into sA's rows (s, i), zero-padded to DP x DP
template <int DP>
__device__ __forceinline__ void load_A(float2* sA, const float2* V, int D) {
  using S = Shape<DP>;
  for (int e = threadIdx.x; e < 2 * DP * DP; e += S::NT) {
    const int s = e / (DP * DP), i = (e / DP) % DP, j = e % DP;
    sA[(s * DP + i) * S::LD + j] = (i < D && j < D) ? V[(i * 2 + s) * D + j] : make_float2(0.f, 0.f);
  }
}

// A thread's two entries (tm, tn) and (tm, tn + NB) of a D x D matrix: the
// entries it owns in every DP x DP product and elementwise step
template <int DP>
__device__ __forceinline__ void own_load(c32 (&x)[2], const float2* p, int D, int tm, int tn) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int l = tn + c * Shape<DP>::NB;
    x[c] = (tm < D && l < D) ? ld(p, tm * D + l) : mk(0.f, 0.f);
  }
}

template <int DP>
__device__ __forceinline__ void own_store(float2* p, const c32 (&x)[2], int D, int tm, int tn) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int l = tn + c * Shape<DP>::NB;
    if (tm < D && l < D) st(p, tm * D + l, x[c]);
  }
}

template <int DP>
__device__ __forceinline__ void own_store_smem(float2* p, const c32 (&x)[2], int tm, int tn) {
#pragma unroll
  for (int c = 0; c < 2; ++c) st(p, tm * Shape<DP>::LD + tn + c * Shape<DP>::NB, x[c]);
}

// A thread's place: h = bit 4 of its lane, q its index among the threads of
// the same h; (tr, tc) = (q / NB, q % NB).  It owns (tm, tn) = (tr + h NB,
// tc): the entries (tm, tn) and (tm, tn + NB) of every DP x DP matrix.
struct Coords {
  int h, tr, tc, tm, tn;
};

template <int DP>
__device__ __forceinline__ Coords coords() {
  constexpr int NB = Shape<DP>::NB;
  const int t = threadIdx.x, h = (t >> 4) & 1, q = (t & 15) | ((t >> 5) << 4);
  return Coords{h, q / NB, q % NB, q / NB + h * NB, q % NB};
}

// out = this thread's entries of a DP x DP product whose K = 2 DP sum runs
// over two halves (u = 0, 1): each thread sums half h of the 2 x 2 block
// (rows tr, tr + NB; columns tc, tc + NB), and the two halves meet by one
// exchange with the lane 16 away (which holds the other half), each thread
// keeping its row tm.  L(u, a, k) and R(u, k, c) read half u's operands.
template <int DP, class LF, class RF>
__device__ __forceinline__ void split_product(c32 (&out)[2], const Coords& p, LF L, RF R) {
  c32 acc[2][2] = {};
  tile_mac<2, 2, DP>(
      acc, [&](int a, int k) { return L(p.h, a, k); }, [&](int k, int c) { return R(p.h, k, c); });
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const c32 give = p.h ? acc[0][c] : acc[1][c], keep = p.h ? acc[1][c] : acc[0][c];
    out[c] = keep + mk(__shfl_xor_sync(0xffffffffu, give.re, 16), __shfl_xor_sync(0xffffffffu, give.im, 16));
  }
}

// w = this thread's entries of sum_s A_s r A_s^dag, r in sR: X = A r into sX
// (rows (s, i)), a barrier, then W = [X_0 | X_1] [A_0^dag; A_1^dag]
template <int DP>
__device__ __forceinline__ void matvec(const float2* sA, const float2* sR, float2* sX, c32 (&w)[2],
                                       const Coords& p) {
  using S = Shape<DP>;
  constexpr int LD = S::LD, NB = S::NB;
  const int tm = p.tm, tn = p.tn;
  c32 x[2][2] = {};
  tile_mac<2, 2, DP>(
      x, [&](int a, int j) { return ld(sA, (a * DP + tm) * LD + j); },
      [&](int j, int c) { return ld(sR, j * LD + tn + c * NB); });
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) st(sX, (a * DP + tm) * LD + tn + c * NB, x[a][c]);
  __syncthreads();
  split_product<DP>(
      w, p, [&](int s, int a, int k) { return ld(sX, (s * DP + p.tr + a * NB) * LD + k); },
      [&](int s, int k, int c) { return conj(ld(sA, (s * DP + p.tc + c * NB) * LD + k)); });
}

// V (B, D, 2, D), r0 (B, D, D) -> r (B, D, D), lam (B,); with rs (B, iters,
// D, D) and ns (B, iters) not null, also each iteration's r_k and ||W_k||
template <int DP>
__global__ void __launch_bounds__(Shape<DP>::NT, Shape<DP>::MINB)
    stiefel_unroll_fwd_kernel(const float2* __restrict__ V, const float2* __restrict__ r0,
                              float2* __restrict__ r_out, float2* __restrict__ lam_out, float2* __restrict__ rs,
                              float* __restrict__ ns, int D, int iters) {
  using S = Shape<DP>;
  __shared__ float2 sA[2 * DP * S::LD], sR[DP * S::LD], sX[2 * DP * S::LD], red[S::NW];
  const Coords p = coords<DP>();
  const int tm = p.tm, tn = p.tn;
  const size_t b = blockIdx.x, dd = (size_t)D * D;
  load_A<DP>(sA, V + b * 2 * dd, D);
  c32 r[2];
  own_load<DP>(r, r0 + b * dd, D, tm, tn);
  float n = sqrtf(block_sum<S::NW>(mk(norm2(r[0]) + norm2(r[1]), 0.f), red).re);
#pragma unroll
  for (int c = 0; c < 2; ++c) r[c] = mk(r[c].re / n, r[c].im / n);
  for (int k = 0; k < iters; ++k) {
    // sR's last reads (the last product's first half) lie before its barrier,
    // red's before block_sum's, sX's before the barrier below
    own_store_smem<DP>(sR, r, tm, tn);
    if (rs) own_store<DP>(rs + (b * iters + k) * dd, r, D, tm, tn);
    __syncthreads();
    c32 w[2];
    matvec<DP>(sA, sR, sX, w, p);
    n = sqrtf(block_sum<S::NW>(mk(norm2(w[0]) + norm2(w[1]), 0.f), red).re);
    if (ns && threadIdx.x == 0) ns[b * iters + k] = n;
#pragma unroll
    for (int c = 0; c < 2; ++c) r[c] = mk(w[c].re / n, w[c].im / n);
  }
  own_store_smem<DP>(sR, r, tm, tn);
  __syncthreads();
  c32 w[2];
  matvec<DP>(sA, sR, sX, w, p);
  c32 lam = conj(r[0]) * w[0];
  cfma(lam, conj(r[1]), w[1]);
  lam = block_sum<S::NW>(lam, red);
  own_store<DP>(r_out + b * dd, r, D, tm, tn);
  if (threadIdx.x == 0) st(lam_out, b, lam);
}

// V, the forward's rs, ns and r, and r's cotangent g_r (B, D, D) -> A's
// cotangent gV (B, D, 2, D) in V's layout, torch's convention
template <int DP>
__global__ void __launch_bounds__(Shape<DP>::NT, Shape<DP>::MINB)
    stiefel_unroll_bwd_kernel(const float2* __restrict__ V, const float2* __restrict__ rs,
                              const float* __restrict__ ns, const float2* __restrict__ r_fin,
                              const float2* __restrict__ g_r, float2* __restrict__ gV, int D, int iters) {
  using S = Shape<DP>;
  constexpr int LD = S::LD, LDPQ = S::LDPQ, NB = S::NB;
  extern __shared__ float2 smem[];
  float2* const sA = smem;             // (2 DP, LD): rows (s, i)
  float2* const sRk = sA + 2 * DP * LD;  // (DP, LD): r_k
  float2* const sG = sRk + DP * LD;      // (DP, LD): G_W
  float2* const sPQ = sG + DP * LD;      // (2 DP, LDPQ): rows (u, i), columns (s, j); P_s = G_W A_s, Q_s = G_W^dag A_s
  __shared__ float2 red[S::NW];
  const Coords p = coords<DP>();
  const int tm = p.tm, tn = p.tn;
  const size_t b = blockIdx.x, dd = (size_t)D * D;
  load_A<DP>(sA, V + b * 2 * dd, D);
  c32 g[2], rn[2];  // this thread's entries of r_{k+1}'s cotangent and of r_{k+1}
  own_load<DP>(g, g_r + b * dd, D, tm, tn);
  own_load<DP>(rn, r_fin + b * dd, D, tm, tn);
  c32 ga[2][2] = {};  // A's cotangent: rows (s = a, i = tm), columns tn + c NB
  for (int k = iters - 1; k >= 0; --k) {
    c32 rk[2];
    own_load<DP>(rk, rs + (b * iters + k) * dd, D, tm, tn);
    c32 dot = conj(rn[0]) * g[0];
    cfma(dot, conj(rn[1]), g[1]);
    const float re = block_sum<S::NW>(dot, red).re, n = ns[b * iters + k];
    c32 gw[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) gw[c] = mk((g[c].re - re * rn[c].re) / n, (g[c].im - re * rn[c].im) / n);
    // the last iteration's reads of sRk and sPQ lie before block_sum's barrier
    // (a one-warp block has none there)
    if (S::NW == 1) __syncthreads();
    own_store_smem<DP>(sG, gw, tm, tn);
    own_store_smem<DP>(sRk, rk, tm, tn);
    __syncthreads();
    // [P; Q] = [G_W; G_W^dag] [A_0 | A_1]
    c32 pq[2][4] = {};
    tile_mac<2, 4, DP>(
        pq,
        [&](int a, int l) { return a == 0 ? ld(sG, tm * LD + l) : conj(ld(sG, l * LD + tm)); },
        [&](int l, int c) { return ld(sA, ((c / 2) * DP + l) * LD + tn + (c % 2) * NB); });
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) st(sPQ, (a * DP + tm) * LDPQ + (c / 2) * DP + tn + (c % 2) * NB, pq[a][c]);
    __syncthreads();
    // Abar_s += P_s r_k^dag + Q_s r_k, the iteration's term summed apart
    // first: 96 roundings into Abar instead of 96 x 4 DP
    c32 term[2][2] = {};
    tile_mac<2, 2, DP>(
        term, [&](int a, int j) { return ld(sPQ, tm * LDPQ + a * DP + j); },
        [&](int j, int c) { return conj(ld(sRk, (tn + c * NB) * LD + j)); });
    tile_mac<2, 2, DP>(
        term, [&](int a, int j) { return ld(sPQ, (DP + tm) * LDPQ + a * DP + j); },
        [&](int j, int c) { return ld(sRk, j * LD + tn + c * NB); });
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) ga[a][c] = ga[a][c] + term[a][c];
    // g <- sum_s A_s^dag P_s
    split_product<DP>(
        g, p, [&](int s, int a, int i) { return conj(ld(sA, (s * DP + i) * LD + p.tr + a * NB)); },
        [&](int s, int i, int c) { return ld(sPQ, i * LDPQ + s * DP + p.tc + c * NB); });
#pragma unroll
    for (int c = 0; c < 2; ++c) rn[c] = rk[c];
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = tn + c * NB;
      if (tm < D && m < D) st(gV + b * 2 * dd, (tm * 2 + a) * D + m, ga[a][c]);
    }
}

template <int DP>
int launch_fwd(const float2* V, const float2* r0, float2* r, float2* lam, float2* rs, float* ns, int B, int D,
               int iters, cudaStream_t s) {
  stiefel_unroll_fwd_kernel<DP><<<B, Shape<DP>::NT, 0, s>>>(V, r0, r, lam, rs, ns, D, iters);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd(const float2* V, const float2* rs, const float* ns, const float2* r, const float2* g_r, float2* gV,
               int B, int D, int iters, cudaStream_t s) {
  constexpr int bytes = Shape<DP>::BWD_BYTES;
  if (bytes > 48 * 1024) {  // above the default limit only after the opt-in
    const cudaError_t err =
        cudaFuncSetAttribute(stiefel_unroll_bwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  stiefel_unroll_bwd_kernel<DP><<<B, Shape<DP>::NT, bytes, s>>>(V, rs, ns, r, g_r, gV, D, iters);
  return (int)cudaGetLastError();
}

}  // namespace unroll
}  // namespace qmps

// V (B, D, 2, D) and r0 (B, D, D) complex64 -> r (B, D, D), lam (B,)
// complex64, and where rs and ns are not null each iteration's r_k (B,
// iters, D, D) complex64 and ||W_k|| (B, iters) float32; D <= 32, all
// contiguous on the device.  Returns cudaGetLastError() after the launch.
extern "C" int qmps_stiefel_unroll_fwd(const void* V, const void* r0, void* r, void* lam, void* rs, void* ns, int B,
                                       int D, int iters, void* stream) {
  using namespace qmps::unroll;
  const float2 *v = (const float2*)V, *q = (const float2*)r0;
  float2 *o = (float2*)r, *l = (float2*)lam, *x = (float2*)rs;
  float* n = (float*)ns;
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 32) return (int)cudaErrorInvalidValue;
  if (D <= 8) return launch_fwd<8>(v, q, o, l, x, n, B, D, iters, s);
  if (D <= 16) return launch_fwd<16>(v, q, o, l, x, n, B, D, iters, s);
  return launch_fwd<32>(v, q, o, l, x, n, B, D, iters, s);
}

// The forward's V, rs, ns and r, and g_r (B, D, D) complex64, r's cotangent
// -> gV (B, D, 2, D) complex64, A's cotangent in V's layout (torch's
// convention).  Returns cudaGetLastError() after the launch.
extern "C" int qmps_stiefel_unroll_bwd(const void* V, const void* rs, const void* ns, const void* r, const void* g_r,
                                       void* gV, int B, int D, int iters, void* stream) {
  using namespace qmps::unroll;
  const float2 *v = (const float2*)V, *x = (const float2*)rs, *q = (const float2*)r, *g = (const float2*)g_r;
  const float* n = (const float*)ns;
  float2* o = (float2*)gV;
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 32) return (int)cudaErrorInvalidValue;
  if (D <= 8) return launch_bwd<8>(v, x, n, q, g, o, B, D, iters, s);
  if (D <= 16) return launch_bwd<16>(v, x, n, q, g, o, B, D, iters, s);
  return launch_bwd<32>(v, x, n, q, g, o, B, D, iters, s);
}
