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
// One thread per element, complex float32 in registers; every tensor is read
// in its (B, ...) complex64 layout and the ragged edge is guarded, where the
// TPU kernels used component-major (ncomp, R, 128) planes padded to 1024.
//
// What bounds them on an H100: arithmetic latency and registers, not memory
// (K2 reads 384 bytes and writes 44 per element against ~3500 complex
// multiply-adds, most of them the 48 dependent squarings; K3 reads ~470
// bytes against ~24 x 80 complex multiply-adds of the series).  K3 is the
// register-heavy one: the series carries the 4x4 X and its square beside z.
// It therefore rebuilds AA, r and M and re-reads h AFTER the series instead
// of keeping them live across it, so only A, v, lam, ct and the series state
// cross the loop.
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
    // r0bar = (r1bar + r1bar^dag) / 2 -> vbar
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
        q[x * 2 + y] = mk((r1bar[x * 2 + y].re + r1bar[y * 2 + x].re) * 0.5f,
                          (r1bar[x * 2 + y].im - r1bar[y * 2 + x].im) * 0.5f);

    // project onto the solvable subspace: q -= (v.q)/(v.w) w, w = vec(I)
    c32 vq = mk(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) cfma(vq, v[i], q[i]);
    const c32 vw = v[0] + v[3];
    const c32 alpha = cdiv_floored(vq, vw);  // wden floor, energy_fused.py:423
    q[0] = q[0] - alpha;
    q[3] = q[3] - alpha;

    // X = (E^T - lam w v^T / (v.w)) / lam   (lden floor, energy_fused.py:432)
    c32 e[16];
    build_E(aa, e);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c32 x = e[j * 4 + i];
        if (i == 0 || i == 3) x = x - cdiv_floored(lam * v[j], vw);
        X[i * 4 + j] = cdiv_floored(x, lam);
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

  // ---- after the series: rebuild AA, r2, M; G = dE/dAA ----
  c32 aa[16], G[16];
  {
    c32 r1[4], r2[4], tau, m[16];
    build_AA(a, aa);
    r_chain(v, r1, r2, tau);
    build_M(aa, r2, m);
    // direct slot 1: G[s, i, j] = ct sum_t h[t, s] sum_k r2[j, k] conj(AA[t, i, k])
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          c32 acc = mk(0.f, 0.f);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            c32 c1 = r2[j * 2 + 0] * conj(aa[t * 4 + i * 2 + 0]);
            cfma(c1, r2[j * 2 + 1], conj(aa[t * 4 + i * 2 + 1]));
            cfma(acc, ld(h, t * 4 + s), c1);
          }
          G[s * 4 + i * 2 + j] = ct * acc;
        }
    // direct slot 2 (bra): G[t, i, k] += ct conj(sum_s h[t, s] M[s, i, k])
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int ik = 0; ik < 4; ++ik) {
        c32 acc = mk(0.f, 0.f);
#pragma unroll
        for (int s = 0; s < 4; ++s) cfma(acc, ld(h, t * 4 + s), m[s * 4 + ik]);
        G[t * 4 + ik] = G[t * 4 + ik] + ct * conj(acc);
      }
  }

  // ---- Ebar = z v^T through the E build ----
  // G[s, i, k] += sum_{j,l} Ebar[(i j), (k l)] conj(AA[s, j, l])
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        c32 acc = mk(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int l = 0; l < 2; ++l) cfma(acc, z[i * 2 + j] * v[k * 2 + l], conj(aa[s * 4 + j * 2 + l]));
        G[s * 4 + i * 2 + k] = G[s * 4 + i * 2 + k] + acc;
      }
  // G[s, j, l] += conj(sum_{i,k} Ebar[(i j), (k l)] AA[s, i, k])
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        c32 acc = mk(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int k = 0; k < 2; ++k) cfma(acc, z[i * 2 + j] * v[k * 2 + l], aa[s * 4 + i * 2 + k]);
        G[s * 4 + j * 2 + l] = G[s * 4 + j * 2 + l] + conj(acc);
      }

  // ---- AA build: Abar[s, a, b] = sum_{t,j} G[(s t), a, j] A[t, b, j]
  //                              + sum_{t,i} G[(t s), i, b] A[t, i, a] ----
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
          for (int j = 0; j < 2; ++j) cfma(acc, G[(s * 2 + t) * 4 + p * 2 + j], a[t * 4 + c * 2 + j]);
#pragma unroll
          for (int i = 0; i < 2; ++i) cfma(acc, G[(t * 2 + s) * 4 + i * 2 + c], a[t * 4 + i * 2 + p]);
        }
        st(abar_out + (size_t)b * 8, s * 4 + p * 2 + c, acc);
      }
}

}  // namespace qmps

// A (B, 2, 2, 2) and h (B, 4, 4) complex64 -> e (B,) float32, lam (B,)
// complex64, v (B, 4) complex64.  Returns cudaGetLastError().
extern "C" int qmps_energy_fwd(const void* A, const void* h, void* e, void* lam, void* v, int B,
                               int iters, void* stream) {
  const int grid = (B + qmps::kThreads - 1) / qmps::kThreads;
  qmps::energy_fwd_kernel<<<grid, qmps::kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)A, (const float2*)h, (float*)e, (float2*)lam, (float2*)v, B, iters);
  return (int)cudaGetLastError();
}

// The forward's A, h, v, lam and the cotangent ct (B,) float32 -> Abar
// (B, 2, 2, 2) and hbar (B, 4, 4) complex64, JAX pairing convention.
// Returns cudaGetLastError().
extern "C" int qmps_energy_bwd(const void* A, const void* h, const void* v, const void* lam,
                               const void* ct, void* abar, void* hbar, int B, int K, void* stream) {
  const int grid = (B + qmps::kThreads - 1) / qmps::kThreads;
  qmps::energy_bwd_kernel<<<grid, qmps::kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)A, (const float2*)h, (const float2*)v, (const float2*)lam, (const float*)ct,
      (float2*)abar, (float2*)hbar, B, K);
  return (int)cudaGetLastError();
}
