// bsr_pairlist and bsr_pairlist_reduce: packed-tile BSR ⊗.⊕ over a pair list.
//
// Replace bsr_pairlist_pallas and bsr_pairlist_reduce_pallas
// (src/repro/kernels/bsr_spgemm/pairlist.py).
//
// For each pair p: C[pair_c[p]] ⊕= A[pair_a[p]] ⊗.⊕ B[pair_b[p]] over
// 128x128 fp32 tiles.  The planner sorts the pairs by output tile, and the
// wrapper turns the sorted output ids into run offsets (run_start), so
// block t owns exactly the pairs [run_start[t], run_start[t+1]): no two
// blocks write one output, and there are no atomics.  The TPU kernel walks
// the pairs on one sequential grid; here the runs run in parallel, one per
// block, and the walk over a run's pairs is the loop inside the block.
//
// Bound on an H100: operations.  Each pair is 2·128^3 fp32 operations
// against at most 128 KB of tile reads, 32 operations a byte, above the
// card's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 a byte).  The design:
// the 128x128 accumulator stays in registers across the whole run (256
// threads x 64 values) and A and B stream through shared memory in 16 KB
// k-slabs (tile_mma.cuh), so C is written once.  (+, ×) is plain fp32 FMA.
// Hub tiles with long runs are not balanced across blocks yet.
//
// The reduce variant groups pairs by output block (pair_o) instead: the
// run's products accumulate in the same registers (⊕ is associative and
// commutative, so ⊕_p ⊕_j C_p[r][j] = ⊕_j ⊕_p C_p[r][j]), and at the end
// the block folds its accumulator over columns (axis 1) or rows (axis 0)
// through shared memory into one [128] vector.  No C tile is ever stored.
#include "tile_mma.cuh"

namespace {

constexpr long long kTile = (long long)tile::BM * tile::BN;

template <class SR>
__device__ __forceinline__ void run_product(tile::Slab& s, float (&acc)[8][8],
                                            const float* __restrict__ a_tiles,
                                            const float* __restrict__ b_tiles,
                                            const int* __restrict__ pair_a,
                                            const int* __restrict__ pair_b, int p0, int p1) {
  tile::fill<SR>(acc);
  for (int p = p0; p < p1; ++p) {
    const float* A = a_tiles + pair_a[p] * kTile;
    const float* B = b_tiles + pair_b[p] * kTile;
    tile::contract<SR>(s, acc, A, tile::BM, B, tile::BN, tile::BM);
  }
}

template <class SR>
__global__ void __launch_bounds__(tile::THREADS)
    bsr_pairlist_kernel(const float* __restrict__ a_tiles, const float* __restrict__ b_tiles,
                        const int* __restrict__ pair_a, const int* __restrict__ pair_b,
                        const int* __restrict__ run_start, float* __restrict__ c_tiles) {
  __shared__ tile::Slab s;
  const int t = blockIdx.x;
  float acc[8][8];
  run_product<SR>(s, acc, a_tiles, b_tiles, pair_a, pair_b, run_start[t], run_start[t + 1]);
  tile::store_tile(c_tiles + t * kTile, tile::BN, acc);
}

template <class SR>
__global__ void __launch_bounds__(tile::THREADS)
    bsr_pairlist_reduce_kernel(const float* __restrict__ a_tiles,
                               const float* __restrict__ b_tiles,
                               const int* __restrict__ pair_a, const int* __restrict__ pair_b,
                               const int* __restrict__ run_start, float* __restrict__ out,
                               int axis) {
  __shared__ tile::Slab s;
  const int o = blockIdx.x;
  float acc[8][8];
  run_product<SR>(s, acc, a_tiles, b_tiles, pair_a, pair_b, run_start[o], run_start[o + 1]);

  // fold: each thread ⊕-folds its 8 columns (axis 1) or 8 rows (axis 0)
  // into red[16][128], then 128 threads fold the 16 partials.  `contract`
  // ended on a barrier, so the slab's shared memory is free.
  float* red = &s.a[0][0];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  if (axis == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = acc[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) v = SR::add(v, acc[i][j]);
      red[tx * tile::BM + tile::row_of(ty, i)] = v;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[0][j];
#pragma unroll
      for (int i = 1; i < 8; ++i) v = SR::add(v, acc[i][j]);
      red[ty * tile::BN + tile::col_of(tx, j)] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < tile::BM) {
    float v = red[threadIdx.x];
#pragma unroll
    for (int q = 1; q < 16; ++q) v = SR::add(v, red[q * tile::BM + threadIdx.x]);
    out[(long long)o * tile::BM + threadIdx.x] = v;
  }
}

}  // namespace

// a_tiles [nA,128,128], b_tiles [nB,128,128], c_tiles [n_c,128,128] fp32;
// pair_a, pair_b int32 [P]; run_start int32 [n_c + 1].
extern "C" int bsr_pairlist_launch(int sr, const void* a_tiles, const void* b_tiles,
                                   const void* pair_a, const void* pair_b,
                                   const void* run_start, void* c_tiles, int n_c,
                                   void* stream) {
  if (n_c <= 0) return 0;
  SR_DISPATCH(sr, bsr_pairlist_kernel<SR><<<n_c, tile::THREADS, 0, (cudaStream_t)stream>>>(
                      (const float*)a_tiles, (const float*)b_tiles, (const int*)pair_a,
                      (const int*)pair_b, (const int*)run_start, (float*)c_tiles));
  return (int)cudaGetLastError();
}

// As above with runs grouped by output block; out [n_o, 128] fp32.
extern "C" int bsr_pairlist_reduce_launch(int sr, const void* a_tiles, const void* b_tiles,
                                          const void* pair_a, const void* pair_b,
                                          const void* run_start, void* out, int n_o, int axis,
                                          void* stream) {
  if (n_o <= 0) return 0;
  SR_DISPATCH(sr,
              bsr_pairlist_reduce_kernel<SR><<<n_o, tile::THREADS, 0, (cudaStream_t)stream>>>(
                  (const float*)a_tiles, (const float*)b_tiles, (const int*)pair_a,
                  (const int*)pair_b, (const int*)run_start, (float*)out, axis));
  return (int)cudaGetLastError();
}
