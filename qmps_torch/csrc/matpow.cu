// K7 and K8: the normalised power E^(2^iters) of a batch of N x N complex
// matrices, N = D^2 > 4: the squaring half of the batched dominant-eigenpair
// solve at bond dimension D >= 3.  The eigenpair itself is read off the power
// outside (kernels/pallas_power.py::_extract_eigpair, one matvec; the left
// eigenvector off the same power's conjugate transpose, _left_vector).
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
// component-major planes, no padding of the batch to 1024 and no
// block-diagonal pack of 128 // N elements for the 128-wide MXU.  Both
// kernels read the (B, N, N) complex64 tensor as it is and write the power
// in the same layout.  K8 normalises after every squaring where the MXU
// kernel does so after every second one: the same normalised power up to
// rounding, no range to watch in float32, and N^2 work against N^3.
//
// What bounds them on an H100: operations.  A squaring is N^3 complex
// multiply-adds against 16 N^2 bytes that the whole loop reads and writes
// once: at N = 16 and 48 squarings ~1,000 flops a byte.
//
// K7 (4 < N <= 16), one warp an element.  On the CUDA cores
// (matpow_small_kernel, 8 elements a block) every multiply-add costs a
// shared-memory load of a row entry, so the 4,096 D = 4 E took 0.214 ms,
// 37% of the float32 bound.  From kMatpowTcMinN on, K7 therefore squares
// on the tensor cores as K8 does (matpow_tc_kernel at T = 1): the power
// padded to 16 x 16, 36 mma a squaring, kTcElems elements a block, each
// warp on its own planes, synchronised by __syncwarp and warp_sum alone.
// Only R and I have planes (rows of 48 floats, 6 KB an element), S = R + I
// is summed from the entries a thread loads, so all 4,096 elements of the
// objective's call fit on the card at once (three planes, one wave and a
// third: 6% slower).  What bounds it there is the issue rate, not the
// tensor cores: the 3xTF32 splits of 48 fragment values, the epilogue and
// the norm make ~400 instructions a squaring a warp for its 36 mma.
// Measured (qmps_torch/kernel_ab.py; NVIDIA H100 80GB HBM3, 700 W): 0.128
// ms on the 4,096 D = 4 E, 29% of its 0.0369 ms bound (the products' TF32
// flops over 495 TFLOP/s), against 0.214 ms on the CUDA cores.  Padded to
// 16, the tensor cores save nothing below N = 13: at N = 12 the two units
// tie within 3% (0.126-0.130 ms), at N = 9 the CUDA cores take 0.068 ms
// and the tensor cores 0.125-0.146.  matpow_small_kernel keeps the power
// in shared memory (N^2 x 8 B) and the square in registers: lane l owns
// column j = l % N and the rows r0, r0 + R, ... (r0 = l / N, R = 32 / N
// lanes a column), so the column entry it loads is used ROWS times and the
// row entries are broadcasts.  The norm is a __shfl_xor_sync butterfly.
//
// K8 (16 < N <= 64, D = 5..8): the tensor cores, which the CUDA cores'
// 67 TFLOP/s leave far behind (495 TFLOP/s dense TF32).  One block an
// element, one warp for each 16-row strip of the power, padded to NP = 16 T
// >= N (T = 2, 3, 4 warps).  The power stays in shared memory for all iters
// squarings as three float32 planes, R, I and S = R + I (3 x 24 KB at
// N = 64, rows of 96 floats; dynamic shared memory above the default
// 48 KB), each row skewed (skew) so that both fragment loads are free of
// bank conflicts.
// A squaring is three real products, RR, II and SS (Karatsuba, as the TPU
// kernel squares: 6 N^3 flops where four products take 8 N^3), each as
// mma.sync.m16n8k8 tiles in 3xTF32: every operand is split into TF32 hi
// and lo when its fragment is loaded, and hi hi + hi lo + lo hi is summed
// in float32 registers.  One-pass TF32 keeps ~3 decimal digits and breaks
// the squaring fixed point (lam off by ~4e-4 at N = 64); 3xTF32 keeps
// float32's (tests/test_torch_matpow.py::test_k8_tensor_core_numerics
// emulates both).  Then re = RR - II and im = SS - RR - II in registers,
// the norm is a block reduction, and the rescaled planes are written back
// in place once every warp has read the old ones.  Zero padding stays
// zero.  The fragments are mma.sync's, not wgmma's (64-row tiles from
// shared memory, K-major TF32 operands): 3xTF32 splits each operand in
// registers, which wgmma's shared-memory B operand would take as a fourth
// and fifth plane; wgmma is the later step.  Measured (qmps_torch/
// kernel_ab.py; NVIDIA H100 80GB HBM3, 700 W): 5.7-5.9 ms on the 4,096
// D = 8 matrices of a 4,096-pair objective call, 34% of the bound (2.0 ms:
// the products' 3 x 6 N^3 TF32 flops a squaring over 495 TFLOP/s, the N^2
// work over 67), against 12.3-12.7 ms for the CUDA-core kernel it replaced.
// Two changes to the first tensor-core design paid 1.21x: the split by
// integer rounding (cvt.rna.tf32.f32 compiles to compares and selects
// around the rounding) and the additive skew (the XOR swizzle cost address
// arithmetic for every B fragment).  Twice the warps (two a strip) did
// not pay (4% slower): 128 registers and 72 KB of shared memory give 3
// blocks, 12 warps, an SM.
//
// Above N = 64 (D >= 9): the same three products on the tensor cores in
// 3xTF32, over the whole card at once (matpow_tc_tiles_kernel).  One
// matrix's power, 2 x 256 KB at N = 256, does not fit in an SM, so it lives
// in device memory as two float32 planes R and I, zero-padded to NP, a
// multiple of 64, and each squaring is one launch over a grid of 64 x 64
// output tiles times the batch (133 x 16 = 2,128 CTAs at N = 256), whatever
// the batch.  A CTA's four warps each own a 32 x 32 quarter of its tile.
// Its K-chunks (16 deep) of the A rows and B columns of R and I are staged
// in shared memory by cp.async, three chunks in flight; S = R + I is summed
// from the R and I entries a thread has loaded for its fragments, bitwise
// the plane the previous squaring would have written, so the power moves
// through device memory and L2 as two planes, not three.  The epilogue is
// re = RR - II, im = SS - RR - II.  The norm takes no pass of its own: each
// CTA writes the partial ||.||^2 of its tile, and the next squaring (or
// the output pass) sums its element's partials in a fixed order and scales
// its product by their reciprocal, c = 1 / max(n2, 1e-30): with Y the
// stored product, Y' = c Y Y = M M for the normalised M = Y / ||Y||, whose
// square has norm <= 1, so nothing overflows.  No atomics: the result is
// the same bits on every run.  The planes ping-pong between two sets of a
// workspace the wrapper allocates (kernels/pallas_power.matpow_work_floats),
// with the partial norms beside them; a first pass splits E into the
// planes (its partials are ||E||^2, folded into the first squaring) and a
// last one scales the power and interleaves it into out.  At N = 256 the
// power and workspace of 133 elements (~136 MB) exceed the card's 50 MB of
// L2, so every squaring reads its planes back from device memory; the
// element-major grid keeps the four CTAs that share a row or column panel
// in flight together, so those panels are read from L2.
#include <cstdint>

#include "planes.cuh"
#include "tf32.cuh"

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
// K8: N > 16
// ---------------------------------------------------------------------------

// The sum of x over a block of kWarps warps, on every thread.  Its first
// barrier also orders every read before it against every write after it.
template <int kWarps>
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();  // red is free again
  return s;
}

// ---- 16 < N <= 64: the squaring on the tensor cores in 3xTF32 ----

// The column skew of row r: entry (r, c) of a plane lives at
// r * LD + c + skew(r) (TcShape::LD).  skew is 8 (r mod 4) + 4 (bit 2 of
// r), so both fragment loads hit 32 distinct banks: the A tile's rows
// g < 8 at column t < 4 and the B tile's rows t < 4 at column g < 8.  Being
// added, not XORed, it keeps every fragment at a compile-time offset from
// a base the thread computes once (a k-step moves the base).
__device__ __forceinline__ int skew(int r) { return ((r & 3) << 3) | (r & 4); }

// K7 on the tensor cores (T = 1): elements a block, one warp each
constexpr int kTcElems = 4;

template <int T>
struct TcShape {
  static constexpr int NP = 16 * T;  // padded size: T warps of 16-row strips
  // row stride of a plane, floats, >= NP + 28 (where skew ends): a multiple
  // of 32 adds no bank offset a row; 48 (16 rows) adds 16 banks to every
  // odd row, which leaves the A tile's rows g < 8 at bank offsets 0, 24,
  // 16, 8, 4, 28, 20, 12 and the B tile's rows t < 4 at 0, 24, 16, 8: both
  // loads still hit 32 distinct banks
  static constexpr int LD = T == 1 ? 48 : T == 2 ? 64 : 96;
  static constexpr int PLANE = NP * LD;
  static constexpr int ELEMS = T == 1 ? kTcElems : 1;  // elements a block, T warps each
  static constexpr int THREADS = 32 * T * ELEMS;
  // planes in shared memory: R, I and (T > 1) S = R + I; at T = 1 S is
  // summed from the R and I entries a thread has loaded
  static constexpr int PLANES = T == 1 ? 2 : 3;
  static constexpr int BYTES = (PLANES * PLANE * ELEMS + 32) * (int)sizeof(float);  // the planes; the reduction
};

// Entry a of plane p (R, I or S), S summed from R and I where it has no
// plane: bitwise the value the plane would hold (written as R + I)
template <int PLANES>
__device__ __forceinline__ float plane_at(float* const pl[3], int p, int a) {
  return (PLANES == 3 || p < 2) ? pl[p][a] : pl[0][a] + pl[1][a];
}

// The sum of x over an element's T warps, on each of their threads.  It
// also orders every read of the element's planes before it against every
// write after it: one warp an element (T = 1) needs no block barrier.
template <int T>
__device__ __forceinline__ float tc_sum(float x, float* red) {
  if constexpr (T == 1) {
    x = warp_sum(x);
    __syncwarp();
    return x;
  } else {
    return block_sum<T>(x, red);
  }
}

template <int T>
__device__ __forceinline__ void tc_sync() {
  if constexpr (T == 1)
    __syncwarp();
  else
    __syncthreads();
}

template <int T>
__global__ void __launch_bounds__(TcShape<T>::THREADS)
    matpow_tc_kernel(const float2* __restrict__ E, float2* __restrict__ out, int B, int N, int iters) {
  using S = TcShape<T>;
  constexpr int NP = S::NP, LD = S::LD, NT = NP / 8, ET = 32 * T;  // ET threads an element
  extern __shared__ float sm[];
  // the element's slot in the block and its thread index there (constants
  // 0 and threadIdx.x at one element a block)
  const int slot = S::ELEMS == 1 ? 0 : threadIdx.x / ET, tid = S::ELEMS == 1 ? threadIdx.x : threadIdx.x % ET;
  const long long elem = (long long)blockIdx.x * S::ELEMS + slot;
  if (S::ELEMS > 1 && elem >= B) return;  // a whole warp (T = 1; at T > 1 the grid is B)
  float* const base = sm + slot * S::PLANES * S::PLANE;
  // R, I and S = R + I; pl[2] is the next element's at PLANES = 2, where
  // only plane_at reads S
  float* const pl[3] = {base, base + S::PLANE, base + 2 * S::PLANE};
  float* const red = sm + S::PLANES * S::PLANE * S::ELEMS;
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t off = (size_t)elem * N * N;

  float n2 = 0.f;
  for (int k = tid; k < NP * NP; k += ET) {
    const int i = k / NP, j = k % NP;
    const float2 x = (i < N && j < N) ? E[off + i * N + j] : make_float2(0.f, 0.f);
    pl[0][i * LD + j + skew(i)] = x.x;
    pl[1][i * LD + j + skew(i)] = x.y;
    n2 += x.x * x.x + x.y * x.y;
  }
  float inv = rsqrtf(fmaxf(tc_sum<T>(n2, red), kNormFloor));
  for (int k = tid; k < NP * NP; k += ET) {  // the entries this thread wrote
    const int a = (k / NP) * LD + k % NP + skew(k / NP);
    const float re = inv * pl[0][a], im = inv * pl[1][a];
    pl[0][a] = re;
    pl[1][a] = im;
    if (S::PLANES == 3) pl[2][a] = re + im;
  }
  tc_sync<T>();

  // this warp's strip: rows r0 + g and r0 + g + 8 of the A fragments and
  // of the accumulators (skew(r0 + g) = skew(r0 + g + 8) = skew(g)), at
  // column t of the k-step; the B fragments' rows t and t + 4 of the k-step
  // (skew 8 t and 8 t + 4) at column g of the n-tile
  const int r0 = 16 * warp;
  const int a0 = (r0 + g) * LD + skew(g) + t, b0 = t * LD + 8 * t + g;
  for (int it = 0; it < iters; ++it) {
    float acc[3][NT][4];  // RR, II, SS over the strip, n-tile n, fragment entry
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < NP / 8; ++kk) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int A = a0 + 8 * kk, Bk = b0 + 8 * kk * LD;
        uint32_t ah[4], al[4];
        split_tf32(plane_at<S::PLANES>(pl, p, A), ah[0], al[0]);
        split_tf32(plane_at<S::PLANES>(pl, p, A + 8 * LD), ah[1], al[1]);
        split_tf32(plane_at<S::PLANES>(pl, p, A + 4), ah[2], al[2]);
        split_tf32(plane_at<S::PLANES>(pl, p, A + 8 * LD + 4), ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bh[2], bl[2];
          split_tf32(plane_at<S::PLANES>(pl, p, Bk + 8 * n), bh[0], bl[0]);
          split_tf32(plane_at<S::PLANES>(pl, p, Bk + 4 * LD + 4 + 8 * n), bh[1], bl[1]);
          mma_tf32(acc[p][n], al, bh);  // the small terms first
          mma_tf32(acc[p][n], ah, bl);
          mma_tf32(acc[p][n], ah, bh);
        }
      }
    }
    // re = RR - II, im = SS - RR - II (Karatsuba, as the TPU kernel)
    n2 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float re = acc[0][n][e] - acc[1][n][e], im = acc[2][n][e] - acc[0][n][e] - acc[1][n][e];
        acc[0][n][e] = re;
        acc[1][n][e] = im;
        n2 += re * re + im * im;  // zero in the padding
      }
    inv = rsqrtf(fmaxf(tc_sum<T>(n2, red), kNormFloor));  // every warp has read the old planes
    // entries (r, 2t) and (r, 2t + 1) of each n-tile, r = r0 + g (e = 0, 1)
    // and r0 + g + 8 (e = 2, 3): adjacent, 8-byte aligned (skew is even)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = a0 - t + h * 8 * LD + 8 * n + 2 * t;
        const float re0 = inv * acc[0][n][2 * h], re1 = inv * acc[0][n][2 * h + 1];
        const float im0 = inv * acc[1][n][2 * h], im1 = inv * acc[1][n][2 * h + 1];
        *reinterpret_cast<float2*>(pl[0] + a) = make_float2(re0, re1);
        *reinterpret_cast<float2*>(pl[1] + a) = make_float2(im0, im1);
        if (S::PLANES == 3) *reinterpret_cast<float2*>(pl[2] + a) = make_float2(re0 + im0, re1 + im1);
      }
    tc_sync<T>();
  }
  for (int k = tid; k < N * N; k += ET) {
    const int a = (k / N) * LD + k % N + skew(k / N);
    out[off + k] = make_float2(pl[0][a], pl[1][a]);
  }
}

template <int T>
int launch_tc(const float2* E, float2* out, int B, int N, int iters, cudaStream_t stream) {
  constexpr int bytes = TcShape<T>::BYTES;
  if (bytes > 48 * 1024) {  // above the default limit only after the opt-in
    const cudaError_t err =
        cudaFuncSetAttribute(matpow_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + TcShape<T>::ELEMS - 1) / TcShape<T>::ELEMS;
  matpow_tc_kernel<T><<<grid, TcShape<T>::THREADS, bytes, stream>>>(E, out, B, N, iters);
  return (int)cudaGetLastError();
}

// ---- N > 64: the squaring over 64 x 64 output tiles, tensor cores in 3xTF32 ----

constexpr int kTile = 64;           // output tile of a CTA, and the unit NP is padded to
constexpr int kTileK = 16;          // contraction chunk
constexpr int kTileStages = 3;      // chunks in flight
constexpr int kTileThreads = 128;   // 2 x 2 warps, 32 x 32 outputs each
constexpr int kTileMinBlocks = 2;   // CTAs an SM (__launch_bounds__): 213 registers a thread
constexpr int kPlaneThreads = 256;  // the split and output passes
// row strides in shared memory, floats: 20 puts the A fragment's rows
// g < 8 at banks 20 g mod 32 (0, 20, 8, 28, 16, 4, 24, 12) + t, 72 the B
// fragment's rows t < 4 at 8 t + g: 32 distinct banks a load, and every
// row start 16-byte aligned for cp.async
constexpr int kLdA = kTileK + 4;
constexpr int kLdB = kTile + 8;
constexpr int kStageA = 2 * kTile * kLdA;   // R and I: the chunk's 64 A rows
constexpr int kStageB = 2 * kTileK * kLdB;  // R and I: its 16 B rows
constexpr int kStage = kStageA + kStageB;
constexpr int kTileSmem = (kTileStages * kStage + kTileThreads / 32) * (int)sizeof(float);  // + the reduction

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The squared norm of element b's stored power: its T2 tiles' partials,
// summed in tile order (the same bits in every CTA that reads them)
__device__ __forceinline__ float tiles_norm2(const float* part, long long b, int T2) {
  float n2 = 0.f;
  for (int k = 0; k < T2; ++k) n2 += part[b * T2 + k];
  return n2;
}

// E (B, N, N) complex64 -> the R and I planes (B, 2, NP, NP), zero-padded,
// and each tile's partial ||E||^2.  One CTA a 64 x 64 tile, element-major.
__global__ void __launch_bounds__(kPlaneThreads)
    matpow_tiles_split_kernel(const float2* __restrict__ E, float* __restrict__ Y, float* __restrict__ part, int N,
                              int NP) {
  __shared__ float red[kPlaneThreads / 32];
  const int T = NP / kTile, T2 = T * T, tile = blockIdx.x % T2;
  const long long b = blockIdx.x / T2;
  const int i0 = (tile / T) * kTile, j0 = (tile % T) * kTile;
  const size_t NN = (size_t)NP * NP;
  float* R = Y + b * 2 * NN;
  float* I = R + NN;
  const float2* e = E + b * N * N;
  float n2 = 0.f;
  for (int k = threadIdx.x; k < kTile * kTile; k += kPlaneThreads) {
    const int i = i0 + k / kTile, j = j0 + k % kTile;
    const float2 x = (i < N && j < N) ? e[(size_t)i * N + j] : make_float2(0.f, 0.f);
    R[(size_t)i * NP + j] = x.x;
    I[(size_t)i * NP + j] = x.y;
    n2 += x.x * x.x + x.y * x.y;
  }
  n2 = block_sum<kPlaneThreads / 32>(n2, red);
  if (threadIdx.x == 0) part[b * T2 + tile] = n2;
}

// One squaring: dst = c src src, c = 1 / max(||src||^2, 1e-30) from
// part_in, and dst's partial norms into part_out.  src, dst (B, 2, NP, NP).
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
    matpow_tc_tiles_kernel(const float* __restrict__ src, float* __restrict__ dst, const float* __restrict__ part_in,
                           float* __restrict__ part_out, int NP) {
  extern __shared__ __align__(16) float sm[];
  const int T = NP / kTile, T2 = T * T, KT = NP / kTileK, tile = blockIdx.x % T2;
  const long long b = blockIdx.x / T2;
  const int i0 = (tile / T) * kTile, j0 = (tile % T) * kTile;
  const size_t NN = (size_t)NP * NP;
  const float* const R = src + b * 2 * NN;
  const float* const I = R + NN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 1, wn = warp & 1;

  // chunk kc into stage st: 2 planes x 64 A rows x kTileK / 4 pieces of 16
  // bytes, and 2 planes x kTileK B rows x 16 pieces
  auto load = [&](int st, int kc) {
    constexpr int PA = kTileK / 4, PB = kTile / 4;  // pieces a row
    float* const a = sm + st * kStage;
    float* const bs = a + kStageA;
    const int k0 = kc * kTileK;
#pragma unroll
    for (int l = tid; l < 2 * kTile * PA; l += kTileThreads) {
      const int p = l / (kTile * PA), r = l / PA % kTile, c = l % PA * 4;
      cp_async16(a + p * kTile * kLdA + r * kLdA + c, (p ? I : R) + (size_t)(i0 + r) * NP + k0 + c);
    }
#pragma unroll
    for (int l = tid; l < 2 * kTileK * PB; l += kTileThreads) {
      const int p = l / (kTileK * PB), r = l / PB % kTileK, c = l % PB * 4;
      cp_async16(bs + p * kTileK * kLdB + r * kLdB + c, (p ? I : R) + (size_t)(k0 + r) * NP + j0 + c);
    }
  };

  float acc[3][2][4][4];  // RR, II, SS; m-tile, n-tile, fragment entry
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mt][nt][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kTileStages - 1; ++st) {
    if (st < KT) load(st, st);
    cp_async_commit();
  }
  for (int kc = 0; kc < KT; ++kc) {
    cp_async_wait<kTileStages - 2>();  // chunk kc has landed (this thread's pieces)
    __syncthreads();                   // everyone's pieces; and chunk kc - 1 is consumed
    if (kc + kTileStages - 1 < KT) load((kc + kTileStages - 1) % kTileStages, kc + kTileStages - 1);
    cp_async_commit();  // an empty group at the tail keeps the count
    const float* const a = sm + (kc % kTileStages) * kStage;
    const float* const bs = a + kStageA;
#pragma unroll
    for (int ks = 0; ks < kTileK / 8; ++ks) {
      float ar[2][2][4], br[2][4][2];  // plane R, I; m-tile or n-tile; fragment entry
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* x = a + p * kTile * kLdA + (wm * 32 + mt * 16 + g) * kLdA + ks * 8 + t;
          ar[p][mt][0] = x[0];
          ar[p][mt][1] = x[8 * kLdA];
          ar[p][mt][2] = x[4];
          ar[p][mt][3] = x[8 * kLdA + 4];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* x = bs + p * kTileK * kLdB + (ks * 8 + t) * kLdB + wn * 32 + nt * 8 + g;
          br[p][nt][0] = x[0];
          br[p][nt][1] = x[4 * kLdB];
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {  // R R, I I, S S with S = R + I
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(q < 2 ? ar[q][mt][e] : ar[0][mt][e] + ar[1][mt][e], ah[mt][e], al[mt][e]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) split_tf32(q < 2 ? br[q][nt][e] : br[0][nt][e] + br[1][nt][e], bh[e], bl[e]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(acc[q][mt][nt], al[mt], bh);  // the small terms first
            mma_tf32(acc[q][mt][nt], ah[mt], bl);
            mma_tf32(acc[q][mt][nt], ah[mt], bh);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // re = RR - II, im = SS - RR - II, times c; entries (r, 2t) and (r, 2t + 1)
  // of each n-tile, r = g (e = 0, 1) and g + 8 (e = 2, 3) of the m-tile
  const float s = rsqrtf(fmaxf(tiles_norm2(part_in, b, T2), kNormFloor)), c = s * s;
  float* const Ro = dst + b * 2 * NN;
  float* const Io = Ro + NN;
  float n2 = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* rr = acc[0][mt][nt] + 2 * h;
        const float* ii = acc[1][mt][nt] + 2 * h;
        const float* ss = acc[2][mt][nt] + 2 * h;
        const float re0 = c * (rr[0] - ii[0]), re1 = c * (rr[1] - ii[1]);
        const float im0 = c * (ss[0] - rr[0] - ii[0]), im1 = c * (ss[1] - rr[1] - ii[1]);
        const size_t at = (size_t)(i0 + wm * 32 + mt * 16 + g + 8 * h) * NP + j0 + wn * 32 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(Ro + at) = make_float2(re0, re1);
        *reinterpret_cast<float2*>(Io + at) = make_float2(im0, im1);
        n2 += re0 * re0 + re1 * re1 + im0 * im0 + im1 * im1;  // zero in the padding
      }
  n2 = block_sum<kTileThreads / 32>(n2, sm + kTileStages * kStage);
  if (tid == 0) part_out[b * T2 + tile] = n2;
}

// out (B, N, N) complex64 = the stored power Y over its norm
__global__ void __launch_bounds__(kPlaneThreads)
    matpow_tiles_out_kernel(const float* __restrict__ Y, const float* __restrict__ part, float2* __restrict__ out,
                            int N, int NP) {
  const int T = NP / kTile, T2 = T * T, tile = blockIdx.x % T2;
  const long long b = blockIdx.x / T2;
  const int i0 = (tile / T) * kTile, j0 = (tile % T) * kTile;
  const size_t NN = (size_t)NP * NP;
  const float* R = Y + b * 2 * NN;
  const float* I = R + NN;
  const float s = rsqrtf(fmaxf(tiles_norm2(part, b, T2), kNormFloor));
  for (int k = threadIdx.x; k < kTile * kTile; k += kPlaneThreads) {
    const int i = i0 + k / kTile, j = j0 + k % kTile;
    if (i < N && j < N)
      out[(size_t)b * N * N + (size_t)i * N + j] = make_float2(s * R[(size_t)i * NP + j], s * I[(size_t)i * NP + j]);
  }
}

// K8 above N = 64: the split pass, iters squarings and the output pass on
// a workspace of two sets of planes (B, 2, NP, NP) and two of partial norms
// (B, T2), NP = N rounded up to 64 and T2 = (NP / 64)^2
// (kernels/pallas_power.py::matpow_work_floats computes its size)
int launch_tiles(const float2* E, float2* out, float* work, int B, int N, int iters, cudaStream_t stream) {
  const int NP = (N + kTile - 1) / kTile * kTile, T2 = (NP / kTile) * (NP / kTile);
  if ((long long)B * T2 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t planes = (size_t)B * 2 * NP * NP;
  float* const Y[2] = {work, work + planes};
  float* const part[2] = {work + 2 * planes, work + 2 * planes + (size_t)B * T2};
  const cudaError_t err =
      cudaFuncSetAttribute(matpow_tc_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(B * T2);
  matpow_tiles_split_kernel<<<grid, kPlaneThreads, 0, stream>>>(E, Y[0], part[0], N, NP);
  for (int it = 1; it <= iters; ++it) {
    matpow_tc_tiles_kernel<<<grid, kTileThreads, kTileSmem, stream>>>(Y[(it - 1) & 1], Y[it & 1],
                                                                      part[(it - 1) & 1], part[it & 1], NP);
    if (it == 1) {  // a launch refused once is refused every time: stop at the first
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  matpow_tiles_out_kernel<<<grid, kPlaneThreads, 0, stream>>>(Y[iters & 1], part[iters & 1], out, N, NP);
  return (int)cudaGetLastError();
}

}  // namespace qmps

// The smallest N that K7 squares on the tensor cores, padded to 16; below
// it, on the CUDA cores (matpow_small_kernel).
constexpr int kMatpowTcMinN = 13;

// K7.  E, out (B, N, N) complex64, contiguous on the device, 4 < N <= 16.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// N it does not take).
extern "C" int qmps_matpow_small(const void* E, void* out, int B, int N, int iters, void* stream) {
  const float2* e = (const float2*)E;
  float2* o = (float2*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 4 || N > 16) return (int)cudaErrorInvalidValue;
  if (N >= kMatpowTcMinN) return qmps::launch_tc<1>(e, o, B, N, iters, s);
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
    default: return qmps::launch_small<16>(e, o, B, iters, s);
  }
}

// K8.  E, out (B, N, N) complex64, contiguous on the device, N > 16; work
// for N > 64 a float32 workspace of matpow_work_floats(B, N) floats
// (kernels/pallas_power.py; unused, may be null, below).  Returns
// cudaGetLastError() after the launches.
extern "C" int qmps_matpow_large(const void* E, void* out, void* work, int B, int N, int iters,
                                 void* stream) {
  const float2* e = (const float2*)E;
  float2* o = (float2*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 16 || (N > 64 && work == nullptr)) return (int)cudaErrorInvalidValue;
  if (N <= 32) return qmps::launch_tc<2>(e, o, B, N, iters, s);
  if (N <= 48) return qmps::launch_tc<3>(e, o, B, N, iters, s);
  if (N <= 64) return qmps::launch_tc<4>(e, o, B, N, iters, s);
  return qmps::launch_tiles(e, o, (float*)work, B, N, iters, s);
}
