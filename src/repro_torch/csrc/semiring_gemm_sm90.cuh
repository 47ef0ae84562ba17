// The CUDA-core semiring contraction of semiring_matmul, bsr_spgemm,
// bsr_spgemm_reduce, bsr_pairlist and bsr_pairlist_reduce for the five
// semirings with no tensor-core form (max_plus, min_plus, max_min,
// max_times, and_or); (+, ×) takes the TF32 routes (semiring_tf32_sm90.cu,
// bsr_pairlist_tf32_sm90.cu).
//
// Bound on an H100: instruction issue.  ⊕ is one FMNMX, which issues on the
// 64-wide ALU pipe (64 a clock per SM on cc 9.0, FFMA 128), and ⊗ is one
// FADD, FMUL or FMNMX: two instructions per MAC, so a sub-partition's one
// warp instruction a clock is the limit.  Every shared-memory load, address
// or loop instruction comes out of the same budget, so the design keeps them
// near 3% of a MAC's: 8 x 8 outputs a thread, k unrolled by 4.
//
// A block of 256 threads owns one 128 x 128 ⊕-accumulator in registers:
// thread (ty, tx) = (tid / 16, tid % 16) holds rows {ty*4 + i, 64 + ty*4 + i}
// and columns {tx*4 + j, 64 + tx*4 + j} (i, j < 4).
// A and B stream through a 3-stage ring of 32-deep slabs in dynamic shared
// memory, loaded with cp.async.cg 16-byte copies, so the next two slabs are
// in flight while one is contracted; one barrier a slab.  cp.async cannot
// transpose, so A stays row-major in shared memory, each row padded by 4
// floats (144 bytes): a thread reads a float4 along k for each of its 8
// rows (8 LDS.128 per 4 k) and B's two float4 of a k row (8 LDS.128 per 4
// k): 4 LDS per k for 64 MACs, 128 ALU instructions.  (A prepass that
// writes A^T, with the next k's fragments read while this k's MACs run,
// measured no faster on an H100: the loads are not what holds the loop
// back.)  Two blocks share an SM (3 x 34 KB of ring each, at most 128
// registers a thread).
#pragma once

#include <stdint.h>

#include "semiring.cuh"

namespace ring {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int A_LD = BK + 4;  // padded A row, floats
constexpr int KTILE = 128;    // mask granularity along K

struct Stage {
  float a[BM][A_LD];  // A slab, row-major: a[row][k]
  float b[BK][BN];    // B slab: b[k][col]
};
constexpr int SMEM_BYTES = STAGES * (int)sizeof(Stage);  // 104,448

__device__ __forceinline__ int row_of(int ty, int i) { return (i < 4 ? 0 : 64) + ty * 4 + (i & 3); }
__device__ __forceinline__ int col_of(int tx, int j) { return (j < 4 ? 0 : 64) + tx * 4 + (j & 3); }

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Queue the copies of the [128 x 32] A slab at A (row-major, lda) and the
// [32 x 128] B slab at B (row-major, ldb): 4 + 4 16-byte copies a thread,
// a warp covering whole 128-byte rows.
__device__ __forceinline__ void load_stage(Stage& s, const float* __restrict__ A, long long lda,
                                           const float* __restrict__ B, long long ldb) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int f = tid + THREADS * q;
    const int row = f >> 3, c4 = (f & 7) * 4;
    cp16(&s.a[row][c4], A + row * lda + c4);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int f = tid + THREADS * q;
    const int k = f >> 5, c4 = (f & 31) * 4;
    cp16(&s.b[k][c4], B + k * ldb + c4);
  }
}

template <class SR>
__device__ __forceinline__ void fill(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = SR::zero();
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// acc ⊕= stage.a ⊗.⊕ stage.b over the slab's 32 k.
template <class SR>
__device__ __forceinline__ void mma_stage(const Stage& s, float (&acc)[8][8]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll 1
  for (int k4 = 0; k4 < BK; k4 += 4) {
    float4 a4[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a4[i] = *reinterpret_cast<const float4*>(&s.a[row_of(ty, i)][k4]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[k4 + c][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.b[k4 + c][64 + tx * 4]);
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ai = lane(a4[i], c);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = SR::mac(acc[i][j], ai, br[j]);
      }
    }
  }
}

// The k slabs to contract: all K / 32 (mrow null) or, for a block-masked A,
// the 4 slabs of each present 128-wide k tile of the block-row (mrow: the
// block-row's mask).  The walk is the same for every thread of the block.
struct Slabs {
  const int* mrow;
  int n_tiles, kt, sub;
  __device__ __forceinline__ Slabs(const int* m, int k) : mrow(m), kt(0), sub(0) {
    n_tiles = m ? k / KTILE : k / BK;
    skip();
  }
  __device__ __forceinline__ void skip() {
    if (mrow != nullptr)
      while (kt < n_tiles && mrow[kt] == 0) ++kt;
  }
  __device__ __forceinline__ long long k0() const {
    return mrow ? (long long)kt * KTILE + sub * BK : (long long)kt * BK;
  }
  __device__ __forceinline__ void next() {
    if (mrow == nullptr || ++sub == KTILE / BK) {
      sub = 0;
      ++kt;
      skip();
    }
  }
  __device__ __forceinline__ int count() const {
    if (mrow == nullptr) return n_tiles;
    int n = 0;
    for (int t = 0; t < n_tiles; ++t) n += mrow[t] != 0;
    return n * (KTILE / BK);
  }
};

// acc = ⊕ over the slabs of A[128 rows, k] ⊗.⊕ B[k, 128 cols]; A at the
// block-row's first element (lda), B at the block-column's (ldb).  Ends on
// a barrier with no copy in flight, so the ring is free for an epilogue.
template <class SR>
__device__ __forceinline__ void contract(Stage* ring, float (&acc)[8][8],
                                         const float* __restrict__ A, long long lda,
                                         const float* __restrict__ B, long long ldb,
                                         const int* mrow, int K) {
  fill<SR>(acc);
  Slabs ld(mrow, K);
  const int n = ld.count();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) {
      load_stage(ring[s], A + ld.k0(), lda, B + ld.k0() * ldb, ldb);
      ld.next();
    }
    cp_commit();
  }
  for (int t = 0; t < n; ++t) {
    cp_wait<STAGES - 2>();  // slab t has landed (this thread's copies)
    __syncthreads();        // ... everyone's; and slab t - 1 is contracted
    if (t + STAGES - 1 < n) {
      load_stage(ring[(t + STAGES - 1) % STAGES], A + ld.k0(), lda, B + ld.k0() * ldb, ldb);
      ld.next();
    }
    cp_commit();
    mma_stage<SR>(ring[t % STAGES], acc);
  }
  cp_wait<0>();
  __syncthreads();
}

// The same pipeline over any walk of 32-deep slabs: `ld` gives count(), the
// slab's A corner a() (128 x 32, lda) and B corner b() (32 x 128, ldb), and
// next() (the pair-list kernels walk their pairs' tiles).  contract keeps
// its own copy: in this form the masked kernels spill at 128 registers.
template <class SR, class Walk>
__device__ __forceinline__ void contract_walk(Stage* ring, float (&acc)[8][8], Walk ld,
                                              long long lda, long long ldb) {
  fill<SR>(acc);
  const int n = ld.count();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) {
      load_stage(ring[s], ld.a(), lda, ld.b(), ldb);
      ld.next();
    }
    cp_commit();
  }
  for (int t = 0; t < n; ++t) {
    cp_wait<STAGES - 2>();  // slab t has landed (this thread's copies)
    __syncthreads();        // ... everyone's; and slab t - 1 is contracted
    if (t + STAGES - 1 < n) {
      load_stage(ring[(t + STAGES - 1) % STAGES], ld.a(), lda, ld.b(), ldb);
      ld.next();
    }
    cp_commit();
    mma_stage<SR>(ring[t % STAGES], acc);
  }
  cp_wait<0>();
  __syncthreads();
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

}  // namespace ring
