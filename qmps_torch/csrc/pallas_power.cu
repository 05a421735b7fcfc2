// K1: batched dominant eigenpair of 4x4 complex matrices (D = 2 transfer
// matrices).
//
// Replaces the TPU kernel qmps_tpu/kernels/pallas_power.py::_squaring_kernel
// (body _solve_planes) and ::_power_kernel, launched through
// dominant_eig_batched_pallas.  The TPU version lays the batch out
// component-major on the 128 lanes and pads it to a multiple of 1024; here
// one thread owns one element, reads its 16 complex64 entries straight from
// the (B, 4, 4) tensor, runs the whole solve in registers and writes lam
// and v.  The ragged edge is guarded instead of padded.
//
// What bounds it on an H100: arithmetic latency, not memory.  Each element
// is 128 bytes in and 40 out against ~64 complex multiply-adds per squaring
// (iters = 40-48 squarings), all dependent through the Frobenius
// normalisation; the unrolled 4x4 product gives each thread 16 independent
// accumulators of instruction-level parallelism, and the state (the
// original E for the Rayleigh quotient, the power and its square) is ~100
// registers.
#include "planes.cuh"

namespace qmps {

__global__ void __launch_bounds__(kThreads)
    dominant_eig_kernel(const float2* __restrict__ E, float2* __restrict__ lam_out,
                        float2* __restrict__ v_out, int B, int iters, int method) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  c32 e[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) e[k] = ld(E + (size_t)b * 16, k);
  c32 lam, v[4];
  solve4(e, iters, method, lam, v);
  st(lam_out, b, lam);
#pragma unroll
  for (int i = 0; i < 4; ++i) st(v_out + (size_t)b * 4, i, v[i]);
}

}  // namespace qmps

// E (B, 4, 4) complex64 -> lam (B,) complex64, v (B, 4) complex64, all
// contiguous on the device.  Returns cudaGetLastError() after the launch.
extern "C" int qmps_dominant_eig(const void* E, void* lam, void* v, int B, int iters, int method,
                                 void* stream) {
  const int grid = (B + qmps::kThreads - 1) / qmps::kThreads;
  qmps::dominant_eig_kernel<<<grid, qmps::kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)E, (float2*)lam, (float2*)v, B, iters, method);
  return (int)cudaGetLastError();
}
