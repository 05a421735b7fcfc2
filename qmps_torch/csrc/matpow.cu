// K7 and K8: the normalised power E^(2^iters) of a batch of N x N complex
// matrices, N = D^2 > 4: the squaring half of the batched dominant-eigenpair
// solve at bond dimension D >= 3.  The eigenpair itself is read off the power
// outside (kernels/pallas_power.py::_extract_eigpair, one matvec), as in the
// JAX package.
//
// Replaces qmps_tpu/kernels/pallas_power.py::_matpow_kernel_looped (K7,
// 4 < N <= 16, launched by _matrix_power_batched_component) and
// ::_squaring_kernel_mxu (K8, N > 16, launched by _matrix_power_batched_mxu).
// Both compute, per element,
//
//   M <- E / ||E||_F;  iters times: M <- M M / ||M M||_F
//
// with the norm floored as rsqrt(max(n2, 1e-30)), so that a zero matrix
// stays finite (zero).  The TPU layouts are not carried over: no
// component-major planes, no padding of the batch to 1024, no block-diagonal
// pack of 128 // N elements for the 128-wide MXU and no Karatsuba (which
// trades a product for cancellation).  Both kernels read the (B, N, N)
// complex64 tensor as it is and write the power in the same layout; the
// ragged edge of the batch is guarded.  K8 normalises after every squaring
// where the MXU kernel does so after every second one: the same normalised
// power up to rounding, and no range to watch in float32.
//
// What bounds them on an H100: operations.  A squaring is N^3 complex
// multiply-adds (8 float32 flops each) against 16 N^2 bytes that the whole
// loop reads and writes once: at N = 16 and 48 squarings ~1,000 flops a
// byte, far above the card's float32 ridge of 67e12 / 3.35e12 = 20.  All
// arithmetic is float32 FMAs on the CUDA cores (the port keeps squaring
// paths off TF32, ROADMAP "Numerics follow the reference").  What the
// design does about it: the power stays on chip for all iters squarings
// (shared memory up to N = 64), every thread keeps a register tile of the
// product, so each operand it loads from shared memory feeds several
// multiply-adds, and the product is written back in place once the norm is
// known.
//
// K7 (4 < N <= 16): one warp an element, 8 elements a block.  The power
// lives in shared memory (N^2 x 8 B, 2 KB at N = 16); the square is held
// in registers: lane l owns column j = l % N and the rows r0, r0 + R, ...
// (r0 = l / N, R = 32 / N lanes a column; at N = 16 two lanes a column,
// eight rows each), so the column entry it loads is used ROWS times and the
// row entries are broadcasts.  The norm is a __shfl_xor_sync butterfly.
//
// K8 (N > 16): one block of 256 threads an element, a 16 x 16 grid of
// threads each owning a 4 x 4 tile of the product (rows ty + 16 p, columns
// tx + 16 q), the norm a block reduction.  Up to N = 64 the power lives in
// shared memory, zero-padded to 16 T >= N (32 KB at N = 64: the square is in
// registers, so one buffer suffices and no opt-in above 48 KB is needed);
// zero rows and columns stay zero through the squaring.  Above N = 64 it
// ping-pongs between the output and a workspace of the same shape in device
// memory (L2-resident at these sizes), each squaring over 64 x 64 output
// tiles and 16-deep contraction chunks staged in shared memory; one block
// owns one element, so __syncthreads is the only synchronisation needed.
#include "planes.cuh"

namespace qmps {

constexpr float kNormFloor = 1e-30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// ---------------------------------------------------------------------------
// K7: 4 < N <= 16, one warp an element
// ---------------------------------------------------------------------------

constexpr int kSmallWarps = 8;

template <int N>
__global__ void __launch_bounds__(kSmallWarps * 32)
    matpow_small_kernel(const float2* __restrict__ E, float2* __restrict__ out, int B, int iters) {
  constexpr int NN = N * N;
  constexpr int R = 32 / N;              // lanes that share a column
  constexpr int ROWS = (N + R - 1) / R;  // rows a lane computes
  __shared__ float2 sm[kSmallWarps][NN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kSmallWarps + warp;
  if (b >= B) return;  // the whole warp: K7 synchronises warps only
  float2* s = sm[warp];
  const float2* e = E + (size_t)b * NN;

  float n2 = 0.f;
  for (int k = lane; k < NN; k += 32) {
    const float2 x = e[k];
    s[k] = x;
    n2 += x.x * x.x + x.y * x.y;
  }
  float inv = rsqrtf(fmaxf(warp_sum(n2), kNormFloor));
  for (int k = lane; k < NN; k += 32) st(s, k, inv * ld(s, k));
  __syncwarp();

  const bool active = lane < R * N;
  const int j = lane % N, r0 = lane / N;
  for (int it = 0; it < iters; ++it) {
    c32 acc[ROWS];
#pragma unroll
    for (int t = 0; t < ROWS; ++t) acc[t] = mk(0.f, 0.f);
    if (active) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const c32 bkj = ld(s, k * N + j);
#pragma unroll
        for (int t = 0; t < ROWS; ++t)
          if (r0 + R * t < N) cfma(acc[t], ld(s, (r0 + R * t) * N + k), bkj);
      }
    }
    n2 = 0.f;
#pragma unroll
    for (int t = 0; t < ROWS; ++t) n2 += norm2(acc[t]);  // zero where unowned
    inv = rsqrtf(fmaxf(warp_sum(n2), kNormFloor));
    __syncwarp();  // every lane has read the old power
    if (active) {
#pragma unroll
      for (int t = 0; t < ROWS; ++t)
        if (r0 + R * t < N) st(s, (r0 + R * t) * N + j, inv * acc[t]);
    }
    __syncwarp();
  }
  for (int k = lane; k < NN; k += 32) out[(size_t)b * NN + k] = s[k];
}

template <int N>
int launch_small(const float2* E, float2* out, int B, int iters, cudaStream_t stream) {
  const int grid = (B + kSmallWarps - 1) / kSmallWarps;
  matpow_small_kernel<N><<<grid, kSmallWarps * 32, 0, stream>>>(E, out, B, iters);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8: N > 16, one block an element
// ---------------------------------------------------------------------------

constexpr int kLargeThreads = 256;  // a 16 x 16 grid of threads
constexpr int kGrid = 16;
constexpr int kOutTile = 64;        // the device-memory path's output tile
constexpr int kChunk = 16;          // and its contraction chunk

// The sum of x over the block, on every thread.  Its first barrier also
// orders every read before it against every write after it.
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kLargeThreads / 32; ++w) s += red[w];
  __syncthreads();  // red is free again
  return s;
}

// 16 < N <= 16 T <= 64: the power in shared memory, zero-padded to NP = 16 T
template <int T>
__global__ void __launch_bounds__(kLargeThreads)
    matpow_shared_kernel(const float2* __restrict__ E, float2* __restrict__ out, int N, int iters) {
  constexpr int NP = kGrid * T;
  __shared__ float2 s[NP * NP];
  __shared__ float red[kLargeThreads / 32];
  const int tx = threadIdx.x % kGrid, ty = threadIdx.x / kGrid;
  const size_t off = (size_t)blockIdx.x * N * N;

  float n2 = 0.f;
  for (int k = threadIdx.x; k < NP * NP; k += kLargeThreads) {
    const int i = k / NP, j = k % NP;
    const float2 x = (i < N && j < N) ? E[off + i * N + j] : make_float2(0.f, 0.f);
    s[k] = x;
    n2 += x.x * x.x + x.y * x.y;
  }
  float inv = rsqrtf(fmaxf(block_sum(n2, red), kNormFloor));
  for (int k = threadIdx.x; k < NP * NP; k += kLargeThreads) st(s, k, inv * ld(s, k));
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    c32 acc[T][T];
#pragma unroll
    for (int p = 0; p < T; ++p)
#pragma unroll
      for (int q = 0; q < T; ++q) acc[p][q] = mk(0.f, 0.f);
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      c32 a[T], c[T];
#pragma unroll
      for (int p = 0; p < T; ++p) a[p] = ld(s, (ty + kGrid * p) * NP + k);
#pragma unroll
      for (int q = 0; q < T; ++q) c[q] = ld(s, k * NP + tx + kGrid * q);
#pragma unroll
      for (int p = 0; p < T; ++p)
#pragma unroll
        for (int q = 0; q < T; ++q) cfma(acc[p][q], a[p], c[q]);
    }
    n2 = 0.f;
#pragma unroll
    for (int p = 0; p < T; ++p)
#pragma unroll
      for (int q = 0; q < T; ++q) n2 += norm2(acc[p][q]);  // zero in the padding
    inv = rsqrtf(fmaxf(block_sum(n2, red), kNormFloor));
#pragma unroll
    for (int p = 0; p < T; ++p)
#pragma unroll
      for (int q = 0; q < T; ++q) st(s, (ty + kGrid * p) * NP + tx + kGrid * q, inv * acc[p][q]);
    __syncthreads();
  }
  for (int k = threadIdx.x; k < N * N; k += kLargeThreads) out[off + k] = s[(k / N) * NP + k % N];
}

// N > 64: the power in device memory, ping-ponging between out and work
__global__ void __launch_bounds__(kLargeThreads)
    matpow_global_kernel(const float2* __restrict__ E, float2* out, float2* work, int N, int iters) {
  __shared__ float2 sa[kOutTile * kChunk];  // rows i0.., columns k0..
  __shared__ float2 sb[kChunk * kOutTile];  // rows k0.., columns j0..
  __shared__ float red[kLargeThreads / 32];
  const int tx = threadIdx.x % kGrid, ty = threadIdx.x / kGrid;
  const int NN = N * N;
  const size_t off = (size_t)blockIdx.x * NN;
  const float2* e = E + off;
  // the power starts in src; after an odd number of squarings it is in the
  // other buffer, so the start buffer is chosen for the last one to be out
  float2* src = ((iters & 1) ? work : out) + off;
  float2* dst = ((iters & 1) ? out : work) + off;

  float n2 = 0.f;
  for (int k = threadIdx.x; k < NN; k += kLargeThreads) n2 += norm2(ld(e, k));
  float inv = rsqrtf(fmaxf(block_sum(n2, red), kNormFloor));
  for (int k = threadIdx.x; k < NN; k += kLargeThreads) st(src, k, inv * ld(e, k));
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    n2 = 0.f;
    for (int i0 = 0; i0 < N; i0 += kOutTile)
      for (int j0 = 0; j0 < N; j0 += kOutTile) {
        c32 acc[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = mk(0.f, 0.f);
        for (int k0 = 0; k0 < N; k0 += kChunk) {
          for (int l = threadIdx.x; l < kOutTile * kChunk; l += kLargeThreads) {
            const int r = l / kChunk, c = l % kChunk;
            sa[l] = (i0 + r < N && k0 + c < N) ? src[(i0 + r) * N + k0 + c] : make_float2(0.f, 0.f);
          }
          for (int l = threadIdx.x; l < kChunk * kOutTile; l += kLargeThreads) {
            const int r = l / kOutTile, c = l % kOutTile;
            sb[l] = (k0 + r < N && j0 + c < N) ? src[(k0 + r) * N + j0 + c] : make_float2(0.f, 0.f);
          }
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < kChunk; ++kk) {
            c32 a[4], c[4];
#pragma unroll
            for (int p = 0; p < 4; ++p) a[p] = ld(sa, (ty + kGrid * p) * kChunk + kk);
#pragma unroll
            for (int q = 0; q < 4; ++q) c[q] = ld(sb, kk * kOutTile + tx + kGrid * q);
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
              for (int q = 0; q < 4; ++q) cfma(acc[p][q], a[p], c[q]);
          }
          __syncthreads();  // the chunk is consumed before the next one loads
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + ty + kGrid * p, j = j0 + tx + kGrid * q;
            if (i < N && j < N) {
              st(dst, i * N + j, acc[p][q]);
              n2 += norm2(acc[p][q]);
            }
          }
      }
    inv = rsqrtf(fmaxf(block_sum(n2, red), kNormFloor));
    // each thread rescales the entries it wrote itself
    for (int i0 = 0; i0 < N; i0 += kOutTile)
      for (int j0 = 0; j0 < N; j0 += kOutTile)
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + ty + kGrid * p, j = j0 + tx + kGrid * q;
            if (i < N && j < N) st(dst, i * N + j, inv * ld(dst, i * N + j));
          }
    __syncthreads();  // dst is complete before it is read as src
    float2* t = src;
    src = dst;
    dst = t;
  }
}

}  // namespace qmps

// K7.  E, out (B, N, N) complex64, contiguous on the device, 4 < N <= 16.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// N it does not take).
extern "C" int qmps_matpow_small(const void* E, void* out, int B, int N, int iters, void* stream) {
  const float2* e = (const float2*)E;
  float2* o = (float2*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (N) {
    case 5: return qmps::launch_small<5>(e, o, B, iters, s);
    case 6: return qmps::launch_small<6>(e, o, B, iters, s);
    case 7: return qmps::launch_small<7>(e, o, B, iters, s);
    case 8: return qmps::launch_small<8>(e, o, B, iters, s);
    case 9: return qmps::launch_small<9>(e, o, B, iters, s);
    case 10: return qmps::launch_small<10>(e, o, B, iters, s);
    case 11: return qmps::launch_small<11>(e, o, B, iters, s);
    case 12: return qmps::launch_small<12>(e, o, B, iters, s);
    case 13: return qmps::launch_small<13>(e, o, B, iters, s);
    case 14: return qmps::launch_small<14>(e, o, B, iters, s);
    case 15: return qmps::launch_small<15>(e, o, B, iters, s);
    case 16: return qmps::launch_small<16>(e, o, B, iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K8.  E, out (B, N, N) complex64, contiguous on the device, N > 16; work a
// (B, N, N) complex64 workspace for N > 64 (unused, may be null, below).
// Returns cudaGetLastError() after the launch.
extern "C" int qmps_matpow_large(const void* E, void* out, void* work, int B, int N, int iters,
                                 void* stream) {
  const float2* e = (const float2*)E;
  float2* o = (float2*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 16 || (N > 64 && work == nullptr)) return (int)cudaErrorInvalidValue;
  if (N <= 32)
    qmps::matpow_shared_kernel<2><<<B, qmps::kLargeThreads, 0, s>>>(e, o, N, iters);
  else if (N <= 48)
    qmps::matpow_shared_kernel<3><<<B, qmps::kLargeThreads, 0, s>>>(e, o, N, iters);
  else if (N <= 64)
    qmps::matpow_shared_kernel<4><<<B, qmps::kLargeThreads, 0, s>>>(e, o, N, iters);
  else
    qmps::matpow_global_kernel<<<B, qmps::kLargeThreads, 0, s>>>(e, o, (float2*)work, N, iters);
  return (int)cudaGetLastError();
}
