// K6: the fused gen-2 brickwork TDVP overlap, forward only.
//
// Replaces qmps_tpu/kernels/brickwork_pallas.py::_overlap_kernel (launched
// by manifold_overlap_pallas).  Per batch element it computes
//
//   <psi(U1', U2')| Ml (x) W (x) Mr |psi(U1, U2)>
//
// on 6 qubits, the contraction of kernels/brickwork_fast.py's flat form:
//   v = c2 (x) c2 (x) c2          c2 = U2[:, 0], over (q0 q1)(q2 q3)(q4 q5)
//   v <- (U1 (x) U1) v            on (q1 q2)(q3 q4)
//   v <- W v                      on the middle 16 = (q1 q2 q3 q4), W shared
//   v <- (Ml (x) Mr) v            Ml on q0, Mr on q5
//   v <- (U1'^dag (x) U1'^dag) v
//   out = (r2 (x) r2 (x) r2) . v  r2 = conj(U2'[:, 0])
//
// The kernel reads U2 and U2' as they lie, (B, 4, 4), and takes their
// column 0 with a stride of four entries; it conjugates the bra's column in
// registers.  So the wrapper launches this one kernel a call and nothing
// else (it copied both columns before, two more kernels).
//
// Contraction order.  The state index is q = (a, j, l, c) = (q0)(q1 q2)
// (q3 q4)(q5), and every step but Ml (x) Mr acts on (j, l) alone, so (a, c)
// splits the state into four 16-vectors, one a sector.  Ml and Mr commute
// with U1'^dag (x) U1'^dag and with W, so they fold into the bra's outer
// factors, r2'(a, q1) = sum_x Ml[x, a] r2(x, q1) and r2''(q4, c) =
// sum_y Mr[y, c] r2(q4, y), and the overlap is
//
//   out = sum_(a, c) b_ac^T W k_ac,
//   k_ac = U1 C_ac U1^T,   b_ac = conj(U1' C'_ac U1'^T)
//
// with k, b and C as 4 x 4 matrices over (j, l).  C_ac[(q1 q2), (q3 q4)] =
// x0[q1] mid[q2, q3] x5[q4] (x0 = c2[a, :], mid = c2, x5 = c2[:, c]; C' the
// same of the conjugated, folded bra columns) is a sum of two outer
// products over q3, so k_ac = sum_q3 (U1 y_q3)(U1 z_q3)^T costs 88 complex
// multiplications a sector (sector_state), where the cube and the two U1
// factors on the whole 16-vector took 16 + 128.  The element takes 1,808
// (704 for kets and bras, 1,024 for W, 64 for the dots, 16 for the fold),
// against the 2,240 multiply-adds and 384 products of
// the kernel this replaces (which applied Ml and Mr to the state by two
// butterfly rounds of 16 shuffles) and the 1,444 of the cheapest pairwise
// order of the network (chip_smoke.py's cheapest_contraction: it sweeps
// the network from q5 to q0 and shares the sectors' common factors; W's
// 1,024 are the same in both).
//
// Layout.  Lane (g, t) = (lane >> 2, lane & 3) of a warp owns element g
// of the warp's 8 and its sector (a, c) = (t >> 1, t & 1): the ket and bra
// of a sector are lane-local, the lanes of a quad read the same U1, U2 and
// M entries (L1 broadcasts).  W, 1,024 of the element's multiply-adds,
// runs on the tensor cores: W is shared across the batch, so W (k_1 ...
// k_4B) is a 16 x 16 by 16 x 4B complex product.  A warp's 8 elements give
// a 16 x 32 tile, one m16n8k8 column tile a sector (column = element), two
// k-steps, and three real products (Karatsuba: Wr Vr, Wi Vi, (Wr + Wi)
// (Vr + Vi)), each in 3xTF32 (tf32.cuh): 72 mma a warp.  One-pass TF32
// would miss the 1e-5 gate on overlaps up to 1 (tests/
// test_torch_brickwork.py::test_k6_tensor_core_numerics).  Each warp
// splits its W fragments itself (8 entries a lane from L1).  The kets pass
// to the mma's B fragments, and the bras to the D fragments' positions,
// through shared memory, a __syncwarp apart: element stride 68 and sector
// stride 17 float2 keep the ket's stores and the B loads free of bank
// conflicts (the bra reads have two-way ones).  The D fragment holds rows
// g, g + 8 of two elements' columns, so the dot with the bra is summed over
// the 8 lanes of a column (three butterfly rounds).  Elements past B are
// not padded: their lanes compute on the last element (every lane of a
// warp takes part in the shuffles and the mma) and store nothing.
//
// Measured in turns (qmps_torch/kernel_ab.py, launches queued; NVIDIA H100
// 80GB HBM3, 700 W), at config 5's 16,384 / 65,536 elements: the kernel
// this replaces 0.0128 / 0.0438 ms; with Ml and Mr folded into the bra
// alone 0.0116 / 0.0390; the factored kets and bras with W on the CUDA
// cores (W in shared memory, every lane of a warp reading the same entry,
// 256 multiply-adds and 256 shared loads a lane) 0.0103 / 0.0354; with W
// on the tensor cores 0.0088 / 0.0285, so that kernel alone stays.
//
// What bounds it on an H100: bytes.  U2 and U2' are read as whole 128-byte
// rows (column 0 touches all four 32-byte sectors of a row), so an element
// moves 584 bytes (U1, U2, U1', U2' 128 each, Ml, Mr 32 each, the output
// 8): 0.00286 ms at 16,384 over 3.35 TB/s.  The function needs 1,444
// complex multiply-adds in its cheapest order; with W's 1,024 on the
// tensor cores (18,432 TF32 flops an element in 3xTF32) and the rest on
// the CUDA cores, 0.0015 ms (chip_smoke.py's kernel_work).  At 16,384 the
// kernel reaches a third of the bound: 2,048 warps fill 15.5 of an SM's
// 64 warp slots, too few to hide the loads' latency.
#include "planes.cuh"
#include "tf32.cuh"

namespace qmps {

// 4 warps of 8 elements a block
constexpr int kOverlapTcWarps = 4;
// a warp's element stride and sector stride in its shared-memory tiles (float2)
constexpr int kElemStride = 68, kSectorStride = 17;

__device__ __forceinline__ c32 shfl_xor(c32 x, int m) {
  return mk(__shfl_xor_sync(0xffffffffu, x.re, m), __shfl_xor_sync(0xffffffffu, x.im, m));
}

// k = U C U^T on one sector, U row-major (4, 4) in memory (k[j * 4 + l]),
// C[(q1 q2), (q3 q4)] = x0[q1] mid[q2 * 2 + q3] x5[q4]:
// k[j, l] = sum_q3 alpha_q3[j] omega_q3[l], alpha_q3 = U y_q3 with
// y_q3[(q1 q2)] = x0[q1] mid[q2, q3], omega_q3[l] = sum_q4 U[l, 2 q3 + q4]
// x5[q4]; 88 complex multiplications
__device__ __forceinline__ void sector_state(const float2* __restrict__ u, const c32 x0[2], const c32 mid[4],
                                             const c32 x5[2], c32 k[16]) {
  c32 g[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) g[i] = ld(u, i);
  c32 alpha[2][4], omega[2][4];
#pragma unroll
  for (int q3 = 0; q3 < 2; ++q3) {
    c32 y[4];
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) y[jp] = x0[jp >> 1] * mid[(jp & 1) * 2 + q3];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      alpha[q3][j] = g[j * 4] * y[0];
#pragma unroll
      for (int jp = 1; jp < 4; ++jp) cfma(alpha[q3][j], g[j * 4 + jp], y[jp]);
      omega[q3][j] = g[j * 4 + 2 * q3] * x5[0];
      cfma(omega[q3][j], g[j * 4 + 2 * q3 + 1], x5[1]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      k[j * 4 + l] = alpha[0][j] * omega[0][l];
      cfma(k[j * 4 + l], alpha[1][j], omega[1][l]);
    }
}

// This lane's ket k_ac of element e (sector a = t >> 1, c = t & 1):
// x0 = c2[a, :], mid = c2, x5 = c2[:, c], c2 = U2[e, :, 0]
__device__ __forceinline__ void lane_ket(const float2* __restrict__ U1, const float2* __restrict__ U2, size_t e,
                                         int a, int c, c32 ket[16]) {
  c32 mid[4], x0[2], x5[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) mid[i] = ld(U2 + e * 16, i * 4);  // column 0: a stride of four entries
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // selects: an index by the lane's a or c would put mid in local memory
    x0[h] = a ? mid[2 + h] : mid[h];
    x5[h] = c ? mid[h * 2 + 1] : mid[h * 2];
  }
  sector_state(U1 + e * 16, x0, mid, x5, ket);
}

// This lane's bra b_ac = conj(U1' C' U1'^T), C' of d = U2'[e, :, 0] =
// conj(r2) with Ml and Mr folded in conjugated: x0'[q1] = sum_x
// conj(Ml[x, a]) d[x, q1], mid' = d, x5'[q4] = sum_y conj(Mr[y, c]) d[q4, y]
__device__ __forceinline__ void lane_bra(const float2* __restrict__ U1p, const float2* __restrict__ U2p,
                                         const float2* __restrict__ Ml, const float2* __restrict__ Mr, size_t e,
                                         int a, int c, c32 bra[16]) {
  c32 mid[4], x0[2], x5[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) mid[i] = ld(U2p + e * 16, i * 4);
  const c32 ml0 = conj(ld(Ml + e * 4, a)), ml1 = conj(ld(Ml + e * 4, 2 + a));
  const c32 mr0 = conj(ld(Mr + e * 4, c)), mr1 = conj(ld(Mr + e * 4, 2 + c));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    x0[h] = ml0 * mid[h];
    cfma(x0[h], ml1, mid[2 + h]);
    x5[h] = mr0 * mid[h * 2];
    cfma(x5[h], mr1, mid[h * 2 + 1]);
  }
  sector_state(U1p + e * 16, x0, mid, x5, bra);
#pragma unroll
  for (int i = 0; i < 16; ++i) bra[i] = conj(bra[i]);
}

// W on the tensor cores: warp w of the block owns 8 elements, lane (g, t) =
// (lane >> 2, lane & 3) element g's sector t
__global__ void __launch_bounds__(kOverlapTcWarps * 32)
    brickwork_overlap_tc_kernel(const float2* __restrict__ U1, const float2* __restrict__ U2,
                                const float2* __restrict__ U1p, const float2* __restrict__ U2p,
                                const float2* __restrict__ Ml, const float2* __restrict__ Mr,
                                const float2* __restrict__ W, float2* __restrict__ out, int B) {
  __shared__ float2 kets[kOverlapTcWarps][8 * kElemStride], bras[kOverlapTcWarps][8 * kElemStride];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = ((long long)blockIdx.x * kOverlapTcWarps + warp) * 8;
  const size_t e = (size_t)(base + g < B ? base + g : B - 1);
  float2* ks = kets[warp];
  float2* bs = bras[warp];
  {
    c32 x[16];
    lane_ket(U1, U2, e, t >> 1, t & 1, x);
#pragma unroll
    for (int i = 0; i < 16; ++i) st(ks + g * kElemStride + t * kSectorStride, i, x[i]);
    lane_bra(U1p, U2p, Ml, Mr, e, t >> 1, t & 1, x);
#pragma unroll
    for (int i = 0; i < 16; ++i) st(bs + g * kElemStride + t * kSectorStride, i, x[i]);
  }
  // W's A fragments for both k-steps: Wr, Wi and Ws = Wr + Wi, split
  uint32_t wh[3][2][4], wl[3][2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of k-step s
      const c32 x = ld(W, (g + 8 * (f & 1)) * 16 + 8 * s + t + 4 * (f >> 1));
      split_tf32(x.re, wh[0][s][f], wl[0][s][f]);
      split_tf32(x.im, wh[1][s][f], wl[1][s][f]);
      split_tf32(x.re + x.im, wh[2][s][f], wl[2][s][f]);
    }
  __syncwarp();
  c32 acc[2] = {mk(0.f, 0.f), mk(0.f, 0.f)};  // elements 2t and 2t + 1
#pragma unroll
  for (int n = 0; n < 4; ++n) {  // column tile n: sector n of the warp's 8 elements
    float p[3][4] = {};         // Wr Vr, Wi Vi, Ws Vs
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // b0 (row t, column g), b1 (row t + 4, column g) of k-step s
      const c32 v0 = ld(ks + g * kElemStride + n * kSectorStride, 8 * s + t);
      const c32 v1 = ld(ks + g * kElemStride + n * kSectorStride, 8 * s + t + 4);
      const float planes[3][2] = {{v0.re, v1.re}, {v0.im, v1.im}, {v0.re + v0.im, v1.re + v1.im}};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        uint32_t bh[2], bl[2];
        split_tf32(planes[q][0], bh[0], bl[0]);
        split_tf32(planes[q][1], bh[1], bl[1]);
        mma_tf32(p[q], wl[q][s], bh);  // the small terms first
        mma_tf32(p[q], wh[q][s], bl);
        mma_tf32(p[q], wh[q][s], bh);
      }
    }
    // d0 (row g, column 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const c32 d = mk(p[0][f] - p[1][f], p[2][f] - p[0][f] - p[1][f]);
      const int col = 2 * t + (f & 1), row = g + 8 * (f >> 1);
      cfma(acc[f & 1], ld(bs + col * kElemStride + n * kSectorStride, row), d);
    }
  }
#pragma unroll
  for (int m = 4; m < 32; m <<= 1) {  // the sum over a column's 8 lanes (same t)
    acc[0] = acc[0] + shfl_xor(acc[0], m);
    acc[1] = acc[1] + shfl_xor(acc[1], m);
  }
  if (g == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (base + 2 * t + h < B) st(out, (int)(base + 2 * t + h), acc[h]);
  }
}

}  // namespace qmps

// U1, U2, U1p, U2p (B, 4, 4), Ml, Mr (B, 2, 2), W (16, 16) shared, all
// complex64 and contiguous -> out (B,) complex64.  Returns
// cudaGetLastError().
extern "C" int qmps_brickwork_overlap(const void* U1, const void* U2, const void* U1p, const void* U2p,
                                      const void* Ml, const void* Mr, const void* W, void* out, int B,
                                      void* stream) {
  const long long warps = (B + 7LL) / 8;
  const int grid = (int)((warps + qmps::kOverlapTcWarps - 1) / qmps::kOverlapTcWarps);
  qmps::brickwork_overlap_tc_kernel<<<grid, qmps::kOverlapTcWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float2*)U1, (const float2*)U2, (const float2*)U1p, (const float2*)U2p, (const float2*)Ml,
      (const float2*)Mr, (const float2*)W, (float2*)out, B);
  return (int)cudaGetLastError();
}
