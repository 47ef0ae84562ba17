// bsr_pairlist and bsr_pairlist_reduce on the CUDA cores: packed-tile BSR
// ⊗.⊕ over a pair list for the five semirings with no tensor-core form
// (max_plus, min_plus, max_min, max_times, and_or); (+, ×) takes the TF32
// route (bsr_pairlist_tf32_sm90.cu).
//
// Replace bsr_pairlist_pallas and bsr_pairlist_reduce_pallas
// (src/repro/kernels/bsr_spgemm/pairlist.py) for every semiring but
// PLUS_TIMES, which those kernels send to the matrix unit.
//
// For each pair p: C[pair_c[p]] ⊕= A[pair_a[p]] ⊗.⊕ B[pair_b[p]] over
// 128x128 fp32 tiles.  The pairs come sorted by output, and each item
// (pairlist_items.cuh) owns whole runs or chunks of one, so no two blocks
// write one output and there are no atomics.  The TPU kernel walks the
// pairs on one sequential grid; here the items run in parallel, one per
// block, and the walk over an item's pairs is the loop inside the block.
//
// Bound on an H100: instruction issue on the CUDA cores (two instructions
// per MAC, ⊕ on the 64-wide ALU pipe; semiring_gemm_sm90.cuh).  The design
// is the ring's: the 128x128 ⊕-accumulator stays in registers across the
// item (256 threads x 8x8 values), and the pairs' A and B tiles stream
// through a 3-stage cp.async ring as 32-deep slabs, four a pair: the
// producer's walk visits a_tiles + pair_a[p]·16384 + k0 and b_tiles +
// pair_b[p]·16384 + k0·128 for k0 = 0, 32, 64, 96, so the next two slabs
// are in flight while one is contracted, across pair boundaries too.
//
// bsr_pairlist gives each output tile's run to one block and stores the
// tile.  The reduce variant's items are chunks of at most `chunk` pairs of
// an output block's run (pair_o): a chunk's products accumulate in the same
// registers (⊕ is associative and commutative, so ⊕_p ⊕_j C_p[r][j] =
// ⊕_j ⊕_p C_p[r][j]); the block folds its accumulator over columns (axis 1)
// or rows (axis 0) through shared memory into one [128] partial, and
// fold_chunks ⊕-folds each output's partials.  No C tile is ever stored.
#include "pairlist_items.cuh"
#include "semiring_gemm_sm90.cuh"

namespace {

using pairs::TILE;
using pairs::TILE_ELEMS;

// The slabs of an item: for each pair, A's four 128 x 32 column slabs
// against B's four 32 x 128 row slabs.
struct PairWalk {
  const float* a_tiles;
  const float* b_tiles;
  const int* pair_a;
  const int* pair_b;
  int p, p1, sub;
  const float* a_tile;
  const float* b_tile;

  __device__ __forceinline__ PairWalk(const float* at, const float* bt, const int* pa,
                                      const int* pb, int p0, int p_end)
      : a_tiles(at), b_tiles(bt), pair_a(pa), pair_b(pb), p(p0), p1(p_end), sub(0) {
    load();
  }
  __device__ __forceinline__ void load() {
    if (p < p1) {
      a_tile = a_tiles + pair_a[p] * TILE_ELEMS;
      b_tile = b_tiles + pair_b[p] * TILE_ELEMS;
    }
  }
  __device__ __forceinline__ int count() const { return (p1 - p) * (TILE / ring::BK); }
  __device__ __forceinline__ const float* a() const { return a_tile + sub * ring::BK; }
  __device__ __forceinline__ const float* b() const { return b_tile + sub * ring::BK * TILE; }
  __device__ __forceinline__ void next() {
    if (++sub == TILE / ring::BK) {
      sub = 0;
      ++p;
      load();
    }
  }
};

struct Args {
  const float* a_tiles;
  const float* b_tiles;
  const int* pair_a;
  const int* pair_b;
  pairs::Items items;
  float* out;  // C tiles [n_c, 128, 128], or the partials [items, 128]
  int axis;
};

template <class SR>
__global__ void __launch_bounds__(ring::THREADS, 2) bsr_pairlist_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ring::Stage* st = reinterpret_cast<ring::Stage*>(smem_raw);
  const int t = blockIdx.x;
  int p0, p1;
  p.items.range(t, p0, p1);
  float acc[8][8];
  ring::contract_walk<SR>(st, acc, PairWalk(p.a_tiles, p.b_tiles, p.pair_a, p.pair_b, p0, p1),
                          TILE, TILE);
  ring::store_tile(p.out + t * TILE_ELEMS, TILE, acc);
}

template <class SR>
__global__ void __launch_bounds__(ring::THREADS, 2) bsr_pairlist_reduce_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ring::Stage* st = reinterpret_cast<ring::Stage*>(smem_raw);
  const int it = blockIdx.x;
  if (it >= p.items.count()) return;  // the grid covers the most items the runs can make
  int p0, p1;
  p.items.range(it, p0, p1);
  float acc[8][8];
  ring::contract_walk<SR>(st, acc, PairWalk(p.a_tiles, p.b_tiles, p.pair_a, p.pair_b, p0, p1),
                          TILE, TILE);

  // fold: each thread ⊕-folds its 8 columns (axis 1) or 8 rows (axis 0)
  // into red[16][128], then 128 threads fold the 16 partials.  The ring is
  // free: contract_walk ends on a barrier with no copy in flight.
  float* red = reinterpret_cast<float*>(smem_raw);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  if (p.axis == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = acc[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) v = SR::add(v, acc[i][j]);
      red[tx * TILE + ring::row_of(ty, i)] = v;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[0][j];
#pragma unroll
      for (int i = 1; i < 8; ++i) v = SR::add(v, acc[i][j]);
      red[ty * TILE + ring::col_of(tx, j)] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < TILE) {
    float v = red[threadIdx.x];
#pragma unroll
    for (int q = 1; q < 16; ++q) v = SR::add(v, red[q * TILE + threadIdx.x]);
    p.out[(long long)it * TILE + threadIdx.x] = v;
  }
}

template <class SR>
int launch(const Args& p, int n_c, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(bsr_pairlist_kernel<SR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ring::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  bsr_pairlist_kernel<SR><<<n_c, ring::THREADS, ring::SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

template <class SR>
int launch_reduce(const Args& p, float* out, int max_items, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(bsr_pairlist_reduce_kernel<SR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ring::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  bsr_pairlist_reduce_kernel<SR><<<max_items, ring::THREADS, ring::SMEM_BYTES, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pairs::fold_chunks<SR><<<p.items.n_out, TILE, 0, stream>>>(p.out, p.items.chunk_off, out);
  return (int)cudaGetLastError();
}

}  // namespace

// a_tiles [nA,128,128], b_tiles [nB,128,128], c_tiles [n_c,128,128] fp32;
// pair_a, pair_b int32 [P]; runs int32 [n_c + 1]; sr one of the five
// CUDA-core semirings (1..5).
extern "C" int bsr_pairlist_launch(int sr, const void* a_tiles, const void* b_tiles,
                                   const void* pair_a, const void* pair_b, const void* runs,
                                   void* c_tiles, int n_c, void* stream) {
  if (n_c <= 0) return 0;
  const Args p{(const float*)a_tiles, (const float*)b_tiles, (const int*)pair_a,
               (const int*)pair_b,   {(const int*)runs, nullptr, n_c, 0},
               (float*)c_tiles,      1};
  SR_DISPATCH_CORE(sr, return launch<SR>(p, n_c, (cudaStream_t)stream));
  return 0;
}

// As above with runs grouped by output block and cut into chunks of at most
// `chunk` pairs: chunk_off int32 [n_o + 1] (the first item of each output;
// at most max_items items), part [max_items, 128] fp32 scratch, out
// [n_o, 128] fp32.
extern "C" int bsr_pairlist_reduce_launch(int sr, const void* a_tiles, const void* b_tiles,
                                          const void* pair_a, const void* pair_b,
                                          const void* runs, const void* chunk_off, void* part,
                                          void* out, int n_o, int max_items, int chunk,
                                          int axis, void* stream) {
  if (n_o <= 0) return 0;
  if (max_items < n_o || chunk <= 0 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const Args p{(const float*)a_tiles, (const float*)b_tiles, (const int*)pair_a,
               (const int*)pair_b,   {(const int*)runs, (const int*)chunk_off, n_o, chunk},
               (float*)part,         axis};
  SR_DISPATCH_CORE(sr, return launch_reduce<SR>(p, (float*)out, max_items, (cudaStream_t)stream));
  return 0;
}
