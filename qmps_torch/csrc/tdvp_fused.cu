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
// no loop: what bounds it is one element's chain at the quench's 64 and the
// bytes at large batches.  Its design: 16 lanes an element, two elements a
// 32-thread block (64 elements: 32 warps on 32 SMs, where one thread an
// element ran two warps on 2).  Every stage of the adjoint is a 16-entry
// tile (AA, BB, WAA; P, C; Wbar, Q; Abar | Bbar), lane l forms entry l of
// each from the tiles before it in shared memory, a __syncwarp apart, so a
// lane's chain is ~45 multiply-adds, not ~550, and lane l's Wbar[b, l] and
// Abar/Bbar rows are contiguous stores.  K's entries are formed as
// cu[r] v[c] where used.  Measured (qmps_torch/kernel_ab.py, launches
// queued, NVIDIA H100 80GB HBM3, 700 W): 16 lanes / one thread an element
// (the layout it replaced) 0.00253 / 0.00647 ms at 64 (an empty launch: 0.00174), 0.00407 /
// 0.00694 at 4,096, 0.0241 / 0.0394 at 65,536, so one layout serves every
// batch.
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
    build_E_mixed_row(waa, bb, r, m);
  }
  c32 e[16];
  quad_gather(m, e);
  quad_squarings4(m, iters);
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

// K5 over 16 lanes an element, two elements a warp (a block).  Lane l forms
// entry l of each 16-entry stage in turn; the element's tiles pass between
// the stages through shared memory, a __syncwarp apart.
constexpr int kBwdLanes = 16;
constexpr int kBwdThreads = 32;

struct BwdTiles {  // one element's; entry l written by lane l
  float2 ab[16];   // A (0-7), then B (8-15)
  float2 w[16], aa[16], bb[16], waa[16], p[16], c[16], q[16];
};

__global__ void __launch_bounds__(kBwdThreads)
    tdvp_bwd_lanes_kernel(const float2* __restrict__ A, const float2* __restrict__ Bm,
                          const float2* __restrict__ W, int w_stride, const float2* __restrict__ V,
                          const float2* __restrict__ U, const float2* __restrict__ LAM,
                          const float* __restrict__ CT, float2* __restrict__ abar_out,
                          float2* __restrict__ bbar_out, float2* __restrict__ wbar_out, int B) {
  __shared__ BwdTiles tiles[kBwdThreads / kBwdLanes];
  BwdTiles& T = tiles[threadIdx.x / kBwdLanes];
  const int l = threadIdx.x & (kBwdLanes - 1);
  const long long elem = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kBwdLanes;
  const bool live = elem < B;
  // lanes past B compute on the last element (every lane meets the
  // __syncwarp) and store nothing
  const size_t b = live ? (size_t)elem : (size_t)(B - 1);
  T.ab[l] = l < 8 ? A[b * 8 + l] : Bm[b * 8 + l - 8];  // coalesced: 128 bytes an element
  T.w[l] = W[b * w_stride + l];

  // coef = -ct (conj(lam)/|lam|) / (u^dag v), the floors of tdvp_fused.py:288-290,
  // on every lane; K[r, c] = cu[r] v[c] with cu = coef conj(u)
  c32 v[4], cu[4];
  {
    c32 u[4], d = mk(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = ld(V + b * 4, i);
      u[i] = ld(U + b * 4, i);
      cfma(d, conj(u[i]), v[i]);
    }
    const c32 lam = ld(LAM, b);
    const c32 nrm = rsqrtf(fmaxf(norm2(lam), 1e-30f)) * conj(lam);
    const float dn = 1.0f / fmaxf(norm2(d), 1e-30f);
    const c32 coef = (-CT[b] * dn) * (nrm * conj(d));
#pragma unroll
    for (int r = 0; r < 4; ++r) cu[r] = coef * conj(u[r]);
  }
  // lane l = s*4 + hi*2 + lo: the stage entry it forms in each 16-entry tile
  const int s = l >> 2, q4 = l & 3, hi = q4 >> 1, lo = l & 1;
  __syncwarp();

  // AA[l], BB[l], and WAA[l] = sum_t W[s, t] AA[t, q4]: this lane builds
  // AA[t, q4] for all four t (8 multiply-adds against 8 shuffles)
  {
    const float2* a = T.ab;
    const float2* bt = T.ab + 8;
    c32 aat[4], aa = mk(0.f, 0.f), waa = mk(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int s1 = t >> 1, s2 = t & 1;
      aat[t] = ld(a, s1 * 4 + hi * 2) * ld(a, s2 * 4 + lo);
      cfma(aat[t], ld(a, s1 * 4 + hi * 2 + 1), ld(a, s2 * 4 + 2 + lo));
      cfma(waa, ld(T.w, s * 4 + t), aat[t]);
      if (t == s) aa = aat[t];
    }
    c32 bb = ld(bt, (s >> 1) * 4 + hi * 2) * ld(bt, (s & 1) * 4 + lo);
    cfma(bb, ld(bt, (s >> 1) * 4 + hi * 2 + 1), ld(bt, (s & 1) * 4 + 2 + lo));
    st(T.aa, l, aa);
    st(T.bb, l, bb);
    st(T.waa, l, waa);
  }
  __syncwarp();

  // P[s, i, k] (i = hi, k = lo; pairs dWAA) and C[s, j, l'] (j = hi,
  // l' = lo; pairs dBB), each a sum over (j, l') or (i, k) as _bwd_plain's
  {
    const c32 v_k[2] = {lo ? v[2] : v[0], lo ? v[3] : v[1]};   // v[k*2 + l'], k = lo
    const c32 v_l[2] = {lo ? v[1] : v[0], lo ? v[3] : v[2]};   // v[k*2 + l'], l' = lo
    const c32 cu_i[2] = {hi ? cu[2] : cu[0], hi ? cu[3] : cu[1]};  // cu[i*2 + j], i = hi
    const c32 cu_j[2] = {hi ? cu[1] : cu[0], hi ? cu[3] : cu[2]};  // cu[i*2 + j], j = hi
    c32 P = mk(0.f, 0.f), C = mk(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      c32 in = mk(0.f, 0.f);
#pragma unroll
      for (int l2 = 0; l2 < 2; ++l2) cfma(in, v_k[l2], conj(ld(T.bb, s * 4 + j * 2 + l2)));
      cfma(P, cu_i[j], in);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      c32 in = mk(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 2; ++k) cfma(in, v_l[k], ld(T.waa, s * 4 + i * 2 + k));
      cfma(C, cu_j[i], in);
    }
    st(T.p, l, P);
    st(T.c, l, conj(C));
  }
  __syncwarp();

  // Wbar[s, t = q4] = sum_ik P[s, ik] AA[t, ik] (stored: 128 contiguous
  // bytes an element) and Q[t = s, ik = q4] = sum_s' P[s', ik] W[s', t]
  {
    c32 wb = mk(0.f, 0.f), Q = mk(0.f, 0.f);
#pragma unroll
    for (int ik = 0; ik < 4; ++ik) cfma(wb, ld(T.p, s * 4 + ik), ld(T.aa, q4 * 4 + ik));
#pragma unroll
    for (int s2 = 0; s2 < 4; ++s2) cfma(Q, ld(T.p, s2 * 4 + q4), ld(T.w, s2 * 4 + s));
    if (live) st(wbar_out + b * 16, l, wb);
    st(T.q, l, Q);
  }
  __syncwarp();

  // the AA-build adjoints (store_aa_adjoint's sums, one output entry a
  // lane): lanes 0-7 Abar from Q and A, lanes 8-15 Bbar from C and B
  {
    const float2* g = l < 8 ? T.q : T.c;
    const float2* x = l < 8 ? T.ab : T.ab + 8;
    const int o = l & 7, so = o >> 2, p = (o >> 1) & 1, c = o & 1;
    c32 acc = mk(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) cfma(acc, ld(g, (so * 2 + t) * 4 + p * 2 + j), ld(x, t * 4 + c * 2 + j));
#pragma unroll
      for (int i = 0; i < 2; ++i) cfma(acc, ld(g, (t * 2 + so) * 4 + i * 2 + c), ld(x, t * 4 + i * 2 + p));
    }
    if (live) st((l < 8 ? abar_out : bbar_out) + b * 8, o, acc);
  }
}

// an empty kernel, launched as K5's lane layout is: the launch floor
__global__ void empty_kernel() {}

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
  const int grid = (int)(((long long)qmps::kBwdLanes * B + qmps::kBwdThreads - 1) / qmps::kBwdThreads);
  qmps::tdvp_bwd_lanes_kernel<<<grid, qmps::kBwdThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)A, (const float2*)Bm, (const float2*)W, w_stride, (const float2*)v,
      (const float2*)u, (const float2*)lam, (const float*)ct, (float2*)abar, (float2*)bbar,
      (float2*)wbar, B);
  return (int)cudaGetLastError();
}

// The launch floor: an empty kernel on the grid K5's lane layout takes for
// B elements, launched as qmps_tdvp_bwd launches it.  Returns
// cudaGetLastError().
extern "C" int qmps_empty(int B, void* stream) {
  const int grid = (int)(((long long)qmps::kBwdLanes * B + qmps::kBwdThreads - 1) / qmps::kBwdThreads);
  qmps::empty_kernel<<<grid, qmps::kBwdThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
