// The original 128x128 block contraction, kept for bsr_spgemm alone (no path
// calls it, as in JAX; it also serves as the in-run witness of the
// mainloop that the semiring_matmul, bsr_spgemm_reduce and pair-list
// kernels left for the cp.async ring and the TF32 tensor-core routes).
//
// A block of 256 threads owns one 128x128 fp32 accumulator in registers:
// thread (ty, tx) = (tid / 16, tid % 16) holds rows {ty*4 + i, 64 + ty*4 + i}
// and columns {tx*4 + j, 64 + tx*4 + j} (i, j < 4), 8x8 values.  A and B
// stream through shared memory in 32-deep k-slabs (128x32 fp32 = 16 KB
// each): A is stored transposed (slab.a[k][row]) so that both operands are
// read as float4 rows; every thread then does 8x8 semiring MACs per k.
#pragma once

#include "semiring.cuh"

namespace tile {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;

struct Slab {
  float a[BK][BM];  // A slab, transposed: a[k][row]
  float b[BK][BN];  // B slab: b[k][col]
};

__device__ __forceinline__ int row_of(int ty, int i) { return (i < 4 ? 0 : 64) + ty * 4 + (i & 3); }
__device__ __forceinline__ int col_of(int tx, int j) { return (j < 4 ? 0 : 64) + tx * 4 + (j & 3); }

// Copy the [128 x 32] A slab at `A` (row-major, leading dimension lda) and
// the [32 x 128] B slab at `B` (row-major, ldb) into shared memory.  All
// pointers and leading dimensions are multiples of 4 floats (16 bytes).
__device__ __forceinline__ void load_slab(Slab& s, const float* __restrict__ A, long long lda,
                                          const float* __restrict__ B, long long ldb) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // A: neighbouring threads take neighbouring rows, so the transposed
    // shared-memory stores fall in distinct banks
    const int f = tid + THREADS * q;
    const int row = f & (BM - 1);
    const int k4 = (f >> 7) * 4;
    const float4 v = *reinterpret_cast<const float4*>(A + row * lda + k4);
    s.a[k4 + 0][row] = v.x;
    s.a[k4 + 1][row] = v.y;
    s.a[k4 + 2][row] = v.z;
    s.a[k4 + 3][row] = v.w;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int f = tid + THREADS * q;
    const int k = f >> 5;
    const int c4 = (f & 31) * 4;
    *reinterpret_cast<float4*>(&s.b[k][c4]) =
        *reinterpret_cast<const float4*>(B + k * ldb + c4);
  }
}

template <class SR>
__device__ __forceinline__ void fill(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = SR::zero();
}

// acc ⊕= slab.a ⊗.⊕ slab.b over the slab's 32 k.
template <class SR>
__device__ __forceinline__ void mma_slab(const Slab& s, float (&acc)[8][8]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&s.a[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&s.a[k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&s.b[k][64 + tx * 4]);
    const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = SR::mac(acc[i][j], ar[i], br[j]);
  }
}

// acc ⊕= A ⊗.⊕ B for A [128 x K] (lda) and B [K x 128] (ldb), K % 32 == 0.
template <class SR>
__device__ __forceinline__ void contract(Slab& s, float (&acc)[8][8], const float* __restrict__ A,
                                         long long lda, const float* __restrict__ B,
                                         long long ldb, int K) {
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_slab(s, A + k0, lda, B + k0 * ldb, ldb);
    __syncthreads();
    mma_slab<SR>(s, acc);
    __syncthreads();
  }
}

// Write the accumulator to the 128x128 tile at C (row-major, ldc).
__device__ __forceinline__ void store_tile(float* __restrict__ C, long long ldc,
                                           const float (&acc)[8][8]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = C + row_of(ty, i) * ldc;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace tile
