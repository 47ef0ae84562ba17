// bsr_spgemm and bsr_spgemm_reduce: block-masked dense A ⊗.⊕ dense B.
//
// Replace bsr_spgemm_pallas and bsr_spgemm_reduce_pallas
// (src/repro/kernels/bsr_spgemm/bsr_spgemm.py).
//
// A is [M, K] fp32, stored dense but block-masked by an int32
// [M/128, K/128] presence mask: an absent 128x128 tile counts as the
// semiring zero and its contraction is skipped.  B is [K, N] fp32, dense.
// One 256-thread block owns one 128x128 output tile (i, j): it walks the
// k tiles of block-row i, skips those with mask[i][k] == 0, and
// contracts the present ones into a register accumulator
// (tile::contract, 32-deep k-slabs through shared memory).  The TPU
// kernel carries that accumulator across a sequential k grid axis; here
// the k walk is the loop inside the block, and the (i, j) tiles run in
// parallel on the SMs.  A block-row with no present tile stores sr.zero,
// as the Pallas _init does.
//
// bsr_spgemm stores the tile.  bsr_spgemm_reduce never stores C: the
// block ⊕-folds its tile over columns (axis 1) or rows (axis 0) through
// shared memory into one [128] vector and writes it as a partial,
// [N/128, M] for axis 1 or [M/128, N] for axis 0; the wrapper ⊕-folds
// the leading axis (the JAX wrapper folds its lanes the same way).  No
// two blocks write one partial, so there are no atomics.
//
// Bound on an H100: operations.  Every present tile pair is 2·128^3 fp32
// operations against 128 KB of tile reads (32 a byte, above the fp32
// ridge of 20), and the reduce writes 1/128 of C.  The design is the
// dense semiring_matmul kernel's, tile for tile, plus a skip of absent
// tiles that is uniform across the block (the mask is one int per
// block-row and k tile, so the branch never diverges).
#include "tile_mma.cuh"

namespace {

constexpr int kTileK = 128;  // mask granularity along K

// acc = ⊕ over present k tiles of A[i-tile, k-tile] ⊗.⊕ B[k-tile, j-tile].
template <class SR>
__device__ __forceinline__ void masked_row_product(tile::Slab& s, float (&acc)[8][8],
                                                   const float* __restrict__ A,
                                                   const int* __restrict__ mask,
                                                   const float* __restrict__ B, long long bi,
                                                   long long bj, int N, int K) {
  const int kb = K / kTileK;
  const int* mrow = mask + bi * kb;
  const float* arow = A + bi * tile::BM * (long long)K;
  tile::fill<SR>(acc);
  for (int kt = 0; kt < kb; ++kt) {
    if (mrow[kt] == 0) continue;  // the same for every thread of the block
    const long long k0 = (long long)kt * kTileK;
    tile::contract<SR>(s, acc, arow + k0, K, B + k0 * N + bj * tile::BN, N, kTileK);
  }
}

template <class SR>
__global__ void __launch_bounds__(tile::THREADS)
    bsr_spgemm_kernel(const float* __restrict__ A, const int* __restrict__ mask,
                      const float* __restrict__ B, float* __restrict__ C, int N, int K) {
  __shared__ tile::Slab s;
  const long long bi = blockIdx.y;
  const long long bj = blockIdx.x;
  float acc[8][8];
  masked_row_product<SR>(s, acc, A, mask, B, bi, bj, N, K);
  tile::store_tile(C + bi * tile::BM * N + bj * tile::BN, N, acc);
}

template <class SR>
__global__ void __launch_bounds__(tile::THREADS)
    bsr_spgemm_reduce_kernel(const float* __restrict__ A, const int* __restrict__ mask,
                             const float* __restrict__ B, float* __restrict__ part, int M,
                             int N, int K, int axis) {
  __shared__ tile::Slab s;
  const long long bi = blockIdx.y;
  const long long bj = blockIdx.x;
  float acc[8][8];
  masked_row_product<SR>(s, acc, A, mask, B, bi, bj, N, K);

  // fold: each thread ⊕-folds its 8 columns (axis 1) or 8 rows (axis 0)
  // into red[16][128], then 128 threads fold the 16 partials.  A skipped
  // or finished contraction leaves the slab free: the last contract ended
  // on a barrier, and with no present tile no thread touched it.
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
    // axis 1: row bi*128 + t of partial bj ([N/128, M]);
    // axis 0: column bj*128 + t of partial bi ([M/128, N])
    if (axis == 1)
      part[bj * M + bi * tile::BM + threadIdx.x] = v;
    else
      part[bi * N + bj * tile::BN + threadIdx.x] = v;
  }
}

}  // namespace

// A [M, K], B [K, N], C [M, N] fp32 row-major; mask int32 [M/128, K/128];
// M, N and K multiples of 128.
extern "C" int bsr_spgemm_launch(int sr, const void* a, const void* mask, const void* b,
                                 void* c, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid(n / tile::BN, m / tile::BM);
  SR_DISPATCH(sr, bsr_spgemm_kernel<SR><<<grid, tile::THREADS, 0, (cudaStream_t)stream>>>(
                      (const float*)a, (const int*)mask, (const float*)b, (float*)c, n, k));
  return (int)cudaGetLastError();
}

// As above; part is [N/128, M] (axis 1) or [M/128, N] (axis 0) fp32.
extern "C" int bsr_spgemm_reduce_launch(int sr, const void* a, const void* mask,
                                        const void* b, void* part, int m, int n, int k,
                                        int axis, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid(n / tile::BN, m / tile::BM);
  SR_DISPATCH(sr,
              bsr_spgemm_reduce_kernel<SR><<<grid, tile::THREADS, 0, (cudaStream_t)stream>>>(
                  (const float*)a, (const int*)mask, (const float*)b, (float*)part, m, n, k,
                  axis));
  return (int)cudaGetLastError();
}
