// K2 and K3: the fused D = 2 energy objective and its implicit adjoint.
//
// K2 replaces qmps_tpu/kernels/energy_fused.py::_energy_fwd_kernel
// (launched by _fwd_pallas), K3 replaces ::_energy_bwd_kernel (launched by
// _bwd_pallas).  The math, per batch element (A left-canonical):
//
//   AA = A A (two-site block), E = sum_s AA_s (x) conj(AA_s)
//   (lam, v) = dominant right eigenpair of E (planes.cuh::solve4), v's
//              phase fixed so that tr(v as 2x2) > 0 (trace_gauge)
//   r = herm(v) / tr herm(v)
//   e = Re sum_{t,s} h[t, s] tr(AA_s r AA_t^dag)
//
// and the adjoint of e through the direct AA slots, the r chain, the
// eigenvector (T^T z = P^T vbar by the deflated product-form series, K
// doublings) and the transposed E and AA builds.  Abar and hbar come out in
// the JAX pairing convention (de = Re sum Abar dA); the PyTorch wrapper
// conjugates.
//
// Complex float32 in registers; every tensor is read in its (B, ...)
// complex64 layout and the ragged edge is guarded, where the TPU kernels
// used component-major (ncomp, R, 128) planes padded to 1024.
//
// What bounds them on an H100: arithmetic latency and registers, not memory
// (K2 reads 384 bytes and writes 44 per element against ~3500 complex
// multiply-adds, most of them the 48 dependent squarings; K3 reads ~470
// bytes against ~24 x 80 complex multiply-adds of the series).  K2 at the
// sweep's 4,096 ran one thread an element: 128 one-warp blocks, one warp an
// SM carrying the 48-squaring chain.  Up to kEnergyQuadMaxB it runs over a
// quad of lanes an element as K4 does (planes.cuh::quad_squarings4): 512
// warps, 16 multiply-adds a lane a squaring.  K3, one thread an element, is
// the register-heavy one (255 registers): the series carries the 4x4 X and
// its square beside z.  It therefore rebuilds AA, r and M and re-reads h
// AFTER the series instead of keeping them live across it, so only A, v,
// lam, ct and the series state cross the loop.  At the sweep's 4,096 that
// was 128 one-warp blocks, one warp an SM carrying the 24 doublings of
// ~80 dependent multiply-adds: 0.0162 ms, 9% of its bound.  Up to
// kEnergyBwdQuadMaxB K3 runs over a quad of lanes an element as K2 does
// (energy_bwd_quad_kernel): lane r owns x[r] and row r of X (20
// multiply-adds and 40 shuffles a lane a doubling), writes row r of hbar
// and G's two-site slot r, and butterflies sum r2bar and Abar.  Measured
// (qmps_torch/kernel_ab.py; NVIDIA H100 80GB HBM3, 700 W): 0.0082 ms at
// 4,096, 0.0112 at 8,192 against one thread's 0.0169; above, one thread
// wins again (0.0187 against 0.0197 at 12,288): the quad takes 210
// registers a lane, 9 warps an SM, and capped at 128 it spills 308 bytes
// and runs 1.6x slower.
#include "planes.cuh"

namespace qmps {

// v <- v conj(tau0)/|tau0|, tau0 = tr(v as 2x2) = v[0] + v[3]: the phase
// the squaring leaves on v is that of lam^(2^iters), arbitrary after f32
// rounding, and near pi/2 herm(v) cancels.  e and its gradient do not
// depend on the phase (energy_fused.py::_trace_gauge); the JAX kernel does
// not fix it.
__device__ __forceinline__ void trace_gauge(c32 v[4]) {
  const c32 tau0 = v[0] + v[3];
  const c32 ph = rsqrtf(fmaxf(norm2(tau0), 1e-30f)) * conj(tau0);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = v[i] * ph;
}

// r1 = herm(v as 2x2), tau = tr r1, r2 = r1 / tau (den floor of
// energy_fused.py:229)
__device__ __forceinline__ void r_chain(const c32 v[4], c32 r1[4], c32 r2[4], c32& tau) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      r1[a * 2 + b] = mk((v[a * 2 + b].re + v[b * 2 + a].re) * 0.5f,
                         (v[a * 2 + b].im - v[b * 2 + a].im) * 0.5f);
  tau = r1[0] + r1[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) r2[k] = cdiv_floored(r1[k], tau);
}

// M[s, i, k] = sum_j AA[s, i, j] r2[j, k]   (index s*4 + i*2 + k)
__device__ __forceinline__ void build_M(const c32 aa[16], const c32 r2[4], c32 m[16]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        c32 acc = aa[s * 4 + i * 2 + 0] * r2[0 * 2 + k];
        cfma(acc, aa[s * 4 + i * 2 + 1], r2[1 * 2 + k]);
        m[s * 4 + i * 2 + k] = acc;
      }
}

// T[t, s] = sum_{i,k} M[s, i, k] conj(AA[t, i, k])
__device__ __forceinline__ c32 T_entry(const c32 m[16], const c32 aa[16], int t, int s) {
  c32 acc = mk(0.f, 0.f);
#pragma unroll
  for (int ik = 0; ik < 4; ++ik) cfma(acc, m[s * 4 + ik], conj(aa[t * 4 + ik]));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    energy_fwd_kernel(const float2* __restrict__ A, const float2* __restrict__ H,
                      float* __restrict__ e_out, float2* __restrict__ lam_out,
                      float2* __restrict__ v_out, int B, int iters) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  c32 a[8], aa[16], e[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = ld(A + (size_t)b * 8, k);
  build_AA(a, aa);
  build_E(aa, e);
  c32 lam, v[4];
  solve4(e, iters, kSquaring, lam, v);
  trace_gauge(v);

  c32 r1[4], r2[4], tau, m[16];
  r_chain(v, r1, r2, tau);
  build_M(aa, r2, m);
  const float2* h = H + (size_t)b * 16;
  float en = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      c32 T = T_entry(m, aa, t, s);
      c32 hts = ld(h, t * 4 + s);
      en += hts.re * T.re - hts.im * T.im;
    }
  e_out[b] = en;
  st(lam_out, b, lam);
#pragma unroll
  for (int i = 0; i < 4; ++i) st(v_out + (size_t)b * 4, i, v[i]);
}

// K2 over a quad of lanes an element (small batches), 8 elements a block:
// lane r owns row r of E and of its power (planes.cuh::quad_squarings4); the
// reads gather the power and E once; the energy is split by t, t = r, and
// summed by a butterfly
__global__ void __launch_bounds__(kQuadThreads)
    energy_fwd_quad_kernel(const float2* __restrict__ A, const float2* __restrict__ H,
                           float* __restrict__ e_out, float2* __restrict__ lam_out,
                           float2* __restrict__ v_out, int B, int iters) {
  const int r = threadIdx.x & 3;
  const long long elem = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const bool live = elem < B;
  // lanes past B compute on the last element (every lane takes part in the
  // shuffles) and store nothing
  const size_t b = live ? (size_t)elem : (size_t)(B - 1);
  c32 a[8], erow[4], m[4];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = ld(A + b * 8, k);
  {
    c32 aa[16];
    build_AA(a, aa);
    build_E_mixed_row(aa, aa, r, erow);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) m[c] = erow[c];
  quad_squarings4(m, iters);
  c32 lam, v[4];
  {
    c32 full[16];
    quad_gather(m, full);
    chirp_read4<false>(full, v);
    quad_gather(erow, full);
    lam = rayleigh4(full, v);
  }
  trace_gauge(v);

  c32 aa[16], r1[4], r2[4], tau, mm[16], aar[4];
  build_AA(a, aa);
  r_chain(v, r1, r2, tau);
  build_M(aa, r2, mm);
  select_row(aa, r, aar);  // AA[t = r, :]
  const float2* h = H + b * 16;
  float en = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    c32 T = mk(0.f, 0.f);  // T[r, s], T_entry's sum
#pragma unroll
    for (int ik = 0; ik < 4; ++ik) cfma(T, mm[s * 4 + ik], conj(aar[ik]));
    const c32 hts = ld(h, r * 4 + s);
    en += hts.re * T.re - hts.im * T.im;
  }
  en += __shfl_xor_sync(0xffffffffu, en, 1);
  en += __shfl_xor_sync(0xffffffffu, en, 2);
  if (!live) return;
  if (r == 0) {
    e_out[b] = en;
    st(lam_out, b, lam);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c == r) st(v_out + b * 4, c, v[c]);
}

// r2bar -> r1bar (r2 = r1 / tau) -> vbar = (r1bar + r1bar^dag) / 2 (r1 =
// herm(r0)), projected onto the solvable subspace: q = vbar - (v.vbar) /
// (v.w) w, w = vec(I) (wden floor, energy_fused.py:423)
__device__ __forceinline__ void vbar_projected(const c32 r2bar[4], const c32 r1[4], c32 tau, const c32 v[4],
                                               c32 q[4]) {
  // r1bar = r2bar / tau - (sum r2bar * r1) / tau^2 * I
  c32 inner = mk(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 4; ++k) cfma(inner, r2bar[k], r1[k]);
  const float den = 1.0f / fmaxf(norm2(tau), 1e-30f);
  const c32 t2 = conj(tau) * conj(tau);
  const c32 c2 = inner * mk(t2.re * den * den, t2.im * den * den);
  c32 r1bar[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c32 d = mk((r2bar[k].re * tau.re + r2bar[k].im * tau.im) * den,
               (r2bar[k].im * tau.re - r2bar[k].re * tau.im) * den);
    r1bar[k] = (k == 0 || k == 3) ? d - c2 : d;
  }
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y)
      q[x * 2 + y] = mk((r1bar[x * 2 + y].re + r1bar[y * 2 + x].re) * 0.5f,
                        (r1bar[x * 2 + y].im - r1bar[y * 2 + x].im) * 0.5f);
  c32 vq = mk(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) cfma(vq, v[i], q[i]);
  const c32 alpha = cdiv_floored(vq, v[0] + v[3]);
  q[0] = q[0] - alpha;
  q[3] = q[3] - alpha;
}

// Row i of the series matrix X = (E^T - lam w v^T / (v.w)) / lam from
// column i of E (lden floor, energy_fused.py:432)
__device__ __forceinline__ void series_row(const c32 ecol[4], int i, c32 lam, const c32 v[4], c32 row[4]) {
  const c32 vw = v[0] + v[3];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c32 x = ecol[j];
    if (i == 0 || i == 3) x = x - cdiv_floored(lam * v[j], vw);
    row[j] = cdiv_floored(x, lam);
  }
}

// G[(s1 s2) = r, :, :] = dE/dAA at one two-site slot r (index i * 2 + j):
// the direct ket slot (s = r), the direct bra slot (t = r) and the two
// terms of Ebar = z v^T through the E build
__device__ __forceinline__ void g_slot(const c32 aa[16], const c32 m[16], const c32 r2[4], const c32 z[4],
                                       const c32 v[4], const float2* h, float ct, int r, c32 g[4]) {
  c32 aar[4];
  select_row(aa, r, aar);
  // direct slot 1: G[r, i, j] = ct sum_t h[t, r] sum_k r2[j, k] conj(AA[t, i, k])
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      c32 acc = mk(0.f, 0.f);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        c32 c1 = r2[j * 2 + 0] * conj(aa[t * 4 + i * 2 + 0]);
        cfma(c1, r2[j * 2 + 1], conj(aa[t * 4 + i * 2 + 1]));
        cfma(acc, ld(h, t * 4 + r), c1);
      }
      g[i * 2 + j] = ct * acc;
    }
  // direct slot 2 (bra): G[r, i, k] += ct conj(sum_s h[r, s] M[s, i, k])
#pragma unroll
  for (int ik = 0; ik < 4; ++ik) {
    c32 acc = mk(0.f, 0.f);
#pragma unroll
    for (int s = 0; s < 4; ++s) cfma(acc, ld(h, r * 4 + s), m[s * 4 + ik]);
    g[ik] = g[ik] + ct * conj(acc);
  }
  // Ebar: G[r, i, k] += sum_{j,l} Ebar[(i j), (k l)] conj(AA[r, j, l])
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      c32 acc = mk(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int l = 0; l < 2; ++l) cfma(acc, z[i * 2 + j] * v[k * 2 + l], conj(aar[j * 2 + l]));
      g[i * 2 + k] = g[i * 2 + k] + acc;
    }
  // G[r, j, l] += conj(sum_{i,k} Ebar[(i j), (k l)] AA[r, i, k])
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      c32 acc = mk(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < 2; ++k) cfma(acc, z[i * 2 + j] * v[k * 2 + l], aar[i * 2 + k]);
      g[j * 2 + l] = g[j * 2 + l] + conj(acc);
    }
}

__global__ void __launch_bounds__(kThreads)
    energy_bwd_kernel(const float2* __restrict__ A, const float2* __restrict__ H,
                      const float2* __restrict__ V, const float2* __restrict__ LAM,
                      const float* __restrict__ CT, float2* __restrict__ abar_out,
                      float2* __restrict__ hbar_out, int B, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float2* h = H + (size_t)b * 16;
  c32 a[8], v[4];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = ld(A + (size_t)b * 8, k);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = ld(V + (size_t)b * 4, i);
  const c32 lam = ld(LAM, b);
  const float ct = CT[b];

  // ---- before the series: hbar, r2bar -> r1bar -> vbar -> q, and X ----
  c32 q[4], X[16];
  {
    c32 aa[16], r1[4], r2[4], tau, m[16];
    build_AA(a, aa);
    r_chain(v, r1, r2, tau);
    build_M(aa, r2, m);
    // hbar[t, s] = ct T[t, s]
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int s = 0; s < 4; ++s) st(hbar_out + (size_t)b * 16, t * 4 + s, ct * T_entry(m, aa, t, s));

    // r2bar[j, k] = ct sum_{s,t,i} h[t, s] AA[s, i, j] conj(AA[t, i, k])
    c32 r2bar[4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        c32 acc = mk(0.f, 0.f);
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            c32 hts = ld(h, t * 4 + s);
#pragma unroll
            for (int i = 0; i < 2; ++i) cfma(acc, hts, aa[s * 4 + i * 2 + j] * conj(aa[t * 4 + i * 2 + k]));
          }
        r2bar[j * 2 + k] = ct * acc;
      }
    vbar_projected(r2bar, r1, tau, v, q);

    c32 e[16];
    build_E(aa, e);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const c32 ecol[4] = {e[i], e[4 + i], e[8 + i], e[12 + i]};
      series_row(ecol, i, lam, v, X + i * 4);
    }
  }

  // ---- z = (1/lam) sum_k X^k q  =  (1/lam) prod_k (I + X^(2^k)) q ----
  c32 x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = q[i];
  for (int it = 0; it < K; ++it) {
    c32 nx[4], X2[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      nx[i] = x[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) cfma(nx[i], X[i * 4 + j], x[j]);
    }
    matsq4(X, X2);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = nx[i];
#pragma unroll
    for (int k = 0; k < 16; ++k) X[k] = X2[k];
  }
  c32 z[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) z[i] = cdiv_floored(x[i], lam);

  // ---- after the series: rebuild AA, r2, M; G = dE/dAA, through the AA build ----
  c32 G[16];
  {
    c32 aa[16], r1[4], r2[4], tau, m[16];
    build_AA(a, aa);
    r_chain(v, r1, r2, tau);
    build_M(aa, r2, m);
#pragma unroll
    for (int s = 0; s < 4; ++s) g_slot(aa, m, r2, z, v, h, ct, s, G + s * 4);
  }
  store_aa_adjoint(G, a, abar_out + (size_t)b * 8);
}

// K3 over a quad of lanes an element (small batches), 8 elements a block.
// Lane r writes row t = r of hbar and sums the t = r part of r2bar (a
// butterfly adds the quad's parts); it owns x[r] and row r of the series
// matrix X (column r of E, deflated), gathers x for the matvec and squares
// its row as quad_squarings4 does (planes.cuh::quad_square_row); after the
// series it computes G's slot (s1 s2) = r and that slot's part of every
// Abar entry through the AA build, which a butterfly sums, and stores Abar
// entries 2r and 2r + 1.  AA, r and M are built on every lane.
__global__ void __launch_bounds__(kQuadThreads)
    energy_bwd_quad_kernel(const float2* __restrict__ A, const float2* __restrict__ H,
                           const float2* __restrict__ V, const float2* __restrict__ LAM,
                           const float* __restrict__ CT, float2* __restrict__ abar_out,
                           float2* __restrict__ hbar_out, int B, int K) {
  const int r = threadIdx.x & 3;
  const long long elem = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const bool live = elem < B;
  // lanes past B compute on the last element (every lane takes part in the
  // shuffles) and store nothing
  const size_t b = live ? (size_t)elem : (size_t)(B - 1);
  const float2* h = H + b * 16;
  c32 a[8], v[4];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = ld(A + b * 8, k);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = ld(V + b * 4, i);
  const c32 lam = ld(LAM, b);
  const float ct = CT[b];

  // ---- before the series: hbar row r, r2bar -> q, and row r of X ----
  c32 x, xrow[4];
  {
    c32 aa[16], r1[4], r2[4], tau, m[16], aar[4];
    build_AA(a, aa);
    r_chain(v, r1, r2, tau);
    build_M(aa, r2, m);
    select_row(aa, r, aar);  // AA[t = r, :]
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      c32 T = mk(0.f, 0.f);  // T[r, s], T_entry's sum
#pragma unroll
      for (int ik = 0; ik < 4; ++ik) cfma(T, m[s * 4 + ik], conj(aar[ik]));
      if (live) st(hbar_out + b * 16, r * 4 + s, ct * T);
    }
    // r2bar[j, k]: this lane's t = r part, summed over the quad
    c32 r2bar[4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        c32 acc = mk(0.f, 0.f);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const c32 hts = ld(h, r * 4 + s);
#pragma unroll
          for (int i = 0; i < 2; ++i) cfma(acc, hts, aa[s * 4 + i * 2 + j] * conj(aar[i * 2 + k]));
        }
        r2bar[j * 2 + k] = ct * quad_sum(acc);
      }
    c32 q[4], ecol[4];
    vbar_projected(r2bar, r1, tau, v, q);
    x = q[0];
#pragma unroll
    for (int i = 1; i < 4; ++i)
      if (i == r) x = q[i];
    build_E_col(aa, r, ecol);
    series_row(ecol, r, lam, v, xrow);
  }

  // ---- the series: lane r holds x[r] and row r of X ----
  for (int it = 0; it < K; ++it) {
    c32 nx = x, x2[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) cfma(nx, xrow[j], quad_get(x, j));
    quad_square_row(xrow, x2);
    x = nx;
#pragma unroll
    for (int c = 0; c < 4; ++c) xrow[c] = x2[c];
  }
  c32 z[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) z[i] = cdiv_floored(quad_get(x, i), lam);

  // ---- after the series: G's slot r, then its part of Abar ----
  c32 g[4];
  {
    c32 aa[16], r1[4], r2[4], tau, m[16];
    build_AA(a, aa);
    r_chain(v, r1, r2, tau);
    build_M(aa, r2, m);
    g_slot(aa, m, r2, z, v, h, ct, r, g);
  }
  // store_aa_adjoint split by slot: slot r = (s1 s2) enters out[s, p, c] =
  // sum_{t,j} g[(s t), p, j] A[t, c, j] + sum_{t,i} g[(t s), i, c] A[t, i, p]
  // at (s, t) = (s1, s2) in the first sum and (t, s) = (s1, s2) in the second
  const int s1 = r >> 1, s2 = r & 1;
  c32 a1[4], a2[4];  // A[s1], A[s2]
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a1[k] = s1 ? a[4 + k] : a[k];
    a2[k] = s2 ? a[4 + k] : a[k];
  }
  c32 first[4], second[4];  // index p * 2 + c
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      c32 f = mk(0.f, 0.f), sc = mk(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 2; ++j) cfma(f, g[p * 2 + j], a2[c * 2 + j]);
#pragma unroll
      for (int i = 0; i < 2; ++i) cfma(sc, g[i * 2 + c], a1[i * 2 + p]);
      first[p * 2 + c] = f;
      second[p * 2 + c] = sc;
    }
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int pc = 0; pc < 4; ++pc) {
      c32 o = mk(0.f, 0.f);
      if (s == s1) o = o + first[pc];
      if (s == s2) o = o + second[pc];
      o = quad_sum(o);
      if (live && (s * 4 + pc) >> 1 == r) st(abar_out + b * 8, s * 4 + pc, o);
    }
}

}  // namespace qmps

// The largest batch K2 runs over quads of lanes; above it, one thread an
// element.
constexpr int kEnergyQuadMaxB = 8192;
// The same for K3.
constexpr int kEnergyBwdQuadMaxB = 8192;

// A (B, 2, 2, 2) and h (B, 4, 4) complex64 -> e (B,) float32, lam (B,)
// complex64, v (B, 4) complex64.  Returns cudaGetLastError().
extern "C" int qmps_energy_fwd(const void* A, const void* h, void* e, void* lam, void* v, int B,
                               int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= kEnergyQuadMaxB) {
    const int grid = (int)((4LL * B + qmps::kQuadThreads - 1) / qmps::kQuadThreads);
    qmps::energy_fwd_quad_kernel<<<grid, qmps::kQuadThreads, 0, s>>>(
        (const float2*)A, (const float2*)h, (float*)e, (float2*)lam, (float2*)v, B, iters);
  } else {
    const int grid = (B + qmps::kThreads - 1) / qmps::kThreads;
    qmps::energy_fwd_kernel<<<grid, qmps::kThreads, 0, s>>>(
        (const float2*)A, (const float2*)h, (float*)e, (float2*)lam, (float2*)v, B, iters);
  }
  return (int)cudaGetLastError();
}

// The forward's A, h, v, lam and the cotangent ct (B,) float32 -> Abar
// (B, 2, 2, 2) and hbar (B, 4, 4) complex64, JAX pairing convention.
// Returns cudaGetLastError().
extern "C" int qmps_energy_bwd(const void* A, const void* h, const void* v, const void* lam,
                               const void* ct, void* abar, void* hbar, int B, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= kEnergyBwdQuadMaxB) {
    const int grid = (int)((4LL * B + qmps::kQuadThreads - 1) / qmps::kQuadThreads);
    qmps::energy_bwd_quad_kernel<<<grid, qmps::kQuadThreads, 0, s>>>(
        (const float2*)A, (const float2*)h, (const float2*)v, (const float2*)lam, (const float*)ct,
        (float2*)abar, (float2*)hbar, B, K);
  } else {
    const int grid = (B + qmps::kThreads - 1) / qmps::kThreads;
    qmps::energy_bwd_kernel<<<grid, qmps::kThreads, 0, s>>>(
        (const float2*)A, (const float2*)h, (const float2*)v, (const float2*)lam, (const float*)ct,
        (float2*)abar, (float2*)hbar, B, K);
  }
  return (int)cudaGetLastError();
}
