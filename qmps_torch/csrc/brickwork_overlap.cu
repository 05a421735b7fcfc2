// K6: the fused gen-2 brickwork TDVP overlap, forward only.
//
// Replaces qmps_tpu/kernels/brickwork_pallas.py::_overlap_kernel (launched
// by manifold_overlap_pallas).  Per batch element it computes
//
//   <psi(U1', U2')| Ml (x) W (x) Mr |psi(U1, U2)>
//
// on 6 qubits, the contraction of kernels/brickwork_fast.py's flat form:
//   v = c2 (x) c2 (x) c2          c2 = U2[:, 0], over (q0 q1)(q2 q3)(q4 q5)
//   v <- (U1 (x) U1) v            on (q1 q2)(q3 q4), the SECOND factor on (q3 q4)
//   v <- W v                      on the middle 16 = (q1 q2 q3 q4), W shared
//   v <- (Ml (x) Mr) v            Ml on q0, Mr on q5
//   v <- (U1'^dag (x) U1'^dag) v
//   out = (r2 (x) r2 (x) r2) . v  r2 = conj(U2'[:, 0])
//
// Layout.  The state index is q = (a, j, l, c) = (q0)(q1 q2)(q3 q4)(q5).
// Every step but Ml (x) Mr acts on (j, l) alone, so (a, c) splits the
// 64-entry state into four 16-vectors.  A quad of lanes owns one element:
// lane t of the quad holds the 16-vector of (a, c) = (t >> 1, t & 1) in
// registers (32 floats, plus 32 of scratch for the W product).  One thread
// per element would hold the TPU kernel's 64-entry state and 64-entry
// scratch, 256 floats, over the 255-register limit.  Mr mixes lanes
// t and t ^ 1, Ml lanes t and t ^ 2: two butterfly rounds of __shfl_xor_sync,
// 16 complex values each; the final sum over the quad is two more.
//
// The quad's lanes read the same U1, U1' and M entries (L1 broadcasts);
// c2, r2 come from the wrapper as contiguous (B, 4) columns, and W is
// loaded once per block into shared memory (2 KB), where every lane of a
// warp reads the same entry at the same time (a broadcast, no conflicts).
// Elements past B are not padded: their lanes compute on the last element
// (every lane of a warp must take part in the shuffles) and store nothing.
//
// What bounds it on an H100: operations.  The function needs 1,444 complex
// multiply-adds an element (11,552 float32 flops, an FMA counted as 2) in
// the cheapest pairwise order of its network (chip_smoke.py's
// cheapest_contraction: Ml and Mr fold into the outer c2 and r2 first, and
// W's 1,024 dominate), against 392 bytes (U1, U1' 128 each, c2, r2, Ml, Mr
// 32 each, the output 8): ~29 flops a byte, above the card's float32 ridge
// of 67e12 / 3.35e12 = 20.  This kernel does more, 2,240 multiply-adds and
// 384 products an element: the cubes and both U1 steps on the whole state,
// and Ml (x) Mr applied to it rather than folded into the bra.
#include "planes.cuh"

namespace qmps {

// 4 lanes an element, 64 elements a block
constexpr int kOverlapThreads = 256;

__device__ __forceinline__ c32 shfl_xor(c32 x, int m) {
  return mk(__shfl_xor_sync(0xffffffffu, x.re, m), __shfl_xor_sync(0xffffffffu, x.im, m));
}

// v[i, k] <- sum_{j, l} G[i, j] G[k, l] v[j, l] on one lane's 16-vector
// (index j * 4 + l), G = U or U^dag for U row-major (4, 4) in memory;
// factorised: the second factor along l, then the first along j, each in
// place through 4 temporaries
template <bool kDagger>
__device__ __forceinline__ void kron_apply(const float2* __restrict__ u, c32 v[16]) {
  c32 g[16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) g[r * 4 + c] = kDagger ? conj(ld(u, c * 4 + r)) : ld(u, r * 4 + c);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c32 t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      t[k] = mk(0.f, 0.f);
#pragma unroll
      for (int l = 0; l < 4; ++l) cfma(t[k], g[k * 4 + l], v[j * 4 + l]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) v[j * 4 + k] = t[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c32 t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t[i] = mk(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) cfma(t[i], g[i * 4 + j], v[j * 4 + k]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i * 4 + k] = t[i];
  }
}

// The cube x (x) x (x) x of a 4-vector over (q0 q1)(q2 q3)(q4 q5), read at
// this lane's (a, c): w[j * 4 + l] = x[a, j >> 1] x[j & 1, l >> 1] x[l & 1, c]
__device__ __forceinline__ void lane_cube(const float2* __restrict__ x, int a, int c, c32 w[16]) {
  c32 x0[2], mid[4], x5[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    x0[h] = ld(x, a * 2 + h);
    x5[h] = ld(x, h * 2 + c);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) mid[k] = ld(x, k);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int l = 0; l < 4; ++l) w[j * 4 + l] = (x0[j >> 1] * mid[(j & 1) * 2 + (l >> 1)]) * x5[l & 1];
}

__global__ void __launch_bounds__(kOverlapThreads)
    brickwork_overlap_kernel(const float2* __restrict__ U1, const float2* __restrict__ C2,
                             const float2* __restrict__ U1p, const float2* __restrict__ R2,
                             const float2* __restrict__ Ml, const float2* __restrict__ Mr,
                             const float2* __restrict__ W, float2* __restrict__ out, int B) {
  __shared__ float2 w_s[256];
  for (int k = threadIdx.x; k < 256; k += blockDim.x) w_s[k] = W[k];
  __syncthreads();

  const long long elem = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const size_t e = (size_t)(elem < B ? elem : B - 1);
  const int lane = threadIdx.x & 3;
  const int a = lane >> 1, c = lane & 1;

  c32 v[16];
  lane_cube(C2 + e * 4, a, c, v);
  kron_apply<false>(U1 + e * 16, v);
  {
    c32 t[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      t[i] = mk(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 16; ++j) cfma(t[i], ld(w_s, i * 16 + j), v[j]);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = t[i];
  }
  {
    // Mr on c: lane (a, y) <- Mr[y, y] v(a, y) + Mr[y, 1 - y] v(a, 1 - y), partner t ^ 1
    const c32 ms = ld(Mr + e * 4, c * 3), mo = ld(Mr + e * 4, c * 2 + (c ^ 1));
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const c32 o = shfl_xor(v[m], 1);
      v[m] = ms * v[m];
      cfma(v[m], mo, o);
    }
    // Ml on a: lane (x, y) <- Ml[x, x] v(x, y) + Ml[x, 1 - x] v(1 - x, y), partner t ^ 2
    const c32 ls = ld(Ml + e * 4, a * 3), lo = ld(Ml + e * 4, a * 2 + (a ^ 1));
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const c32 o = shfl_xor(v[m], 2);
      v[m] = ls * v[m];
      cfma(v[m], lo, o);
    }
  }
  kron_apply<true>(U1p + e * 16, v);
  c32 r[16];
  lane_cube(R2 + e * 4, a, c, r);
  c32 acc = mk(0.f, 0.f);
#pragma unroll
  for (int m = 0; m < 16; ++m) cfma(acc, r[m], v[m]);
  acc = acc + shfl_xor(acc, 1);
  acc = acc + shfl_xor(acc, 2);
  if (lane == 0 && elem < B) st(out, (int)elem, acc);
}

}  // namespace qmps

// U1, U1p (B, 4, 4), c2 = U2[:, :, 0] and r2 = conj(U2p[:, :, 0]) (B, 4),
// Ml, Mr (B, 2, 2), W (16, 16) shared, all complex64 and contiguous ->
// out (B,) complex64.  Returns cudaGetLastError().
extern "C" int qmps_brickwork_overlap(const void* U1, const void* c2, const void* U1p, const void* r2,
                                      const void* Ml, const void* Mr, const void* W, void* out, int B,
                                      void* stream) {
  const long long threads = 4LL * B;
  const int grid = (int)((threads + qmps::kOverlapThreads - 1) / qmps::kOverlapThreads);
  qmps::brickwork_overlap_kernel<<<grid, qmps::kOverlapThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)U1, (const float2*)c2, (const float2*)U1p, (const float2*)r2, (const float2*)Ml,
      (const float2*)Mr, (const float2*)W, (float2*)out, B);
  return (int)cudaGetLastError();
}
