// K1: batched dominant eigenpair of 4x4 complex matrices (D = 2 transfer
// matrices), and on request the left eigenvector.
//
// Replaces the TPU kernel qmps_tpu/kernels/pallas_power.py::_squaring_kernel
// (body _solve_planes) and ::_power_kernel, launched through
// dominant_eig_batched_pallas.  The TPU version lays the batch out
// component-major on the 128 lanes and pads it to a multiple of 1024; here
// each element's 16 complex64 entries are read straight from the (B, 4, 4)
// tensor, the whole solve runs in registers, and lam, v (and w) are
// written.  The ragged edge is guarded instead of padded.
//
// What bounds it on an H100: arithmetic, and at small batches one
// element's latency.  Each element is 128 bytes in and 40 out (72 with w)
// against 40-48 squarings of a 4x4 complex matrix, all dependent through
// the Frobenius normalisation.  Its design:
// - the squaring in three real products, R R, I I and S S (S = R + I):
//   re = RR - II, im = SS - RR - II (squarings4_3p), 6 N^3 + 4 N^2 flops
//   where the complex product (planes.cuh::squarings4, which K2 and K4
//   keep) takes 8 N^3: the form the bound counts (chip_smoke.py's
//   csquare_flops).  The power method keeps planes.cuh::solve4;
// - a quad of lanes an element up to kDominantQuadMaxB elements, the
//   layout of K2 and K4 at small batches (planes.cuh::quad_squarings4:
//   lane r owns row r of the power, 16 multiply-adds and 34 shuffles a
//   squaring; the reads off the power gather it whole on every lane, and
//   the Rayleigh quotient is summed over the quad).  The sweep's represent
//   step launches it on 1,024 matrices: one thread an element runs 32
//   warps there, on 32 of the card's 132 SMs;
// - w, the left eigenvector, read off the conjugate transpose of the same
//   power (chirp_read4<true>, as K4 reads it): (E^dag)^2 = (E^2)^dag, so no
//   second chain on E^dag, where the gradient path solved [E, E^dag] on 2B
//   matrices before.
// Measured in turns (qmps_torch/kernel_ab.py, launches queued; NVIDIA H100
// 80GB HBM3, 700 W), the four-product chain on one thread (the kernel this
// replaces) / the three-product chain on one thread / a quad of lanes:
// 0.0146 / 0.0122 / 0.0113 ms at 1,024, 0.0146 / 0.0123 / 0.0116 at 4,096,
// 0.0150 / 0.0126 / 0.0136 at 8,192, 0.0486 / 0.0394 / 0.0716 at 65,536:
// the quad up to 4,096 (kDominantQuadMaxB).
#include "planes.cuh"

namespace qmps {

// r = m m in three real products; the sums in matsq4's k order
__device__ __forceinline__ void matsq4_3p(const c32 m[16], c32 r[16]) {
  float s[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) s[k] = m[k].re + m[k].im;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float rr = 0.f, ii = 0.f, ss = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rr = fmaf(m[a * 4 + k].re, m[k * 4 + b].re, rr);
        ii = fmaf(m[a * 4 + k].im, m[k * 4 + b].im, ii);
        ss = fmaf(s[a * 4 + k], s[k * 4 + b], ss);
      }
      r[a * 4 + b] = mk(rr - ii, ss - rr - ii);
    }
}

// m <- m^2 / ||m^2||_F, iters times, each square in three real products
__device__ __forceinline__ void squarings4_3p(c32 m[16], int iters) {
  for (int it = 0; it < iters; ++it) {
    c32 r[16];
    matsq4_3p(m, r);
    normalize<16>(r);
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = r[k];
  }
}

// one thread an element (large batches, and the power method)
__global__ void __launch_bounds__(kThreads)
    dominant_eig_kernel(const float2* __restrict__ E, float2* __restrict__ lam_out,
                        float2* __restrict__ v_out, float2* __restrict__ w_out, int B, int iters,
                        int method) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  c32 e[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) e[k] = ld(E + (size_t)b * 16, k);
  c32 lam, v[4];
  if (method == kPower) {
    solve4(e, iters, kPower, lam, v);
  } else {
    c32 m[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = e[k];
    squarings4_3p(m, iters);
    chirp_read4<false>(m, v);
    lam = rayleigh4(e, v);
    if (w_out) {
      c32 w[4];
      chirp_read4<true>(m, w);  // off M^dag: no chain on E^dag
#pragma unroll
      for (int i = 0; i < 4; ++i) st(w_out + (size_t)b * 4, i, w[i]);
    }
  }
  st(lam_out, b, lam);
#pragma unroll
  for (int i = 0; i < 4; ++i) st(v_out + (size_t)b * 4, i, v[i]);
}

// a quad of lanes an element (small batches, squaring only), 8 elements a block
__global__ void __launch_bounds__(kQuadThreads)
    dominant_eig_quad_kernel(const float2* __restrict__ E, float2* __restrict__ lam_out,
                             float2* __restrict__ v_out, float2* __restrict__ w_out, int B, int iters) {
  const int r = threadIdx.x & 3;  // this lane's row of E and of its power
  const long long elem = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const bool live = elem < B;
  // lanes past B compute on the last element (every lane takes part in the
  // shuffles) and store nothing
  const size_t b = live ? (size_t)elem : (size_t)(B - 1);
  c32 erow[4], m[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) m[c] = erow[c] = ld(E + b * 16, r * 4 + c);
  quad_squarings4(m, iters);
  c32 mf[16], v[4];
  quad_gather(m, mf);
  chirp_read4<false>(mf, v);
  // lam = v^dag E v: this lane's conj(v[r]) (E v)[r], summed over the quad
  c32 ev = mk(0.f, 0.f), vr = v[0];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cfma(ev, erow[c], v[c]);
    if (c == r) vr = v[c];
  }
  const c32 lam = quad_sum(conj(vr) * ev);
  c32 w[4];
  if (w_out) chirp_read4<true>(mf, w);  // off M^dag: no chain on E^dag
  if (!live) return;
  if (r == 0) st(lam_out, b, lam);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c == r) {
      st(v_out + b * 4, c, v[c]);
      if (w_out) st(w_out + b * 4, c, w[c]);
    }
}

}  // namespace qmps

// The largest batch K1 squares over quads of lanes; above it, one thread an
// element (the top of the file).
constexpr int kDominantQuadMaxB = 4096;

// E (B, 4, 4) complex64 -> lam (B,) complex64, v (B, 4) complex64 and, if
// w is not null (method 0 only), the left eigenvector w (B, 4) complex64,
// all contiguous on the device.  Returns cudaGetLastError() after the launch.
extern "C" int qmps_dominant_eig(const void* E, void* lam, void* v, void* w, int B, int iters, int method,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (method == qmps::kSquaring && B <= kDominantQuadMaxB) {
    const int grid = (int)((4LL * B + qmps::kQuadThreads - 1) / qmps::kQuadThreads);
    qmps::dominant_eig_quad_kernel<<<grid, qmps::kQuadThreads, 0, s>>>(
        (const float2*)E, (float2*)lam, (float2*)v, (float2*)w, B, iters);
  } else {
    const int grid = (B + qmps::kThreads - 1) / qmps::kThreads;
    qmps::dominant_eig_kernel<<<grid, qmps::kThreads, 0, s>>>(
        (const float2*)E, (float2*)lam, (float2*)v, (float2*)w, B, iters, method);
  }
  return (int)cudaGetLastError();
}
