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
// contracts the present ones into a register accumulator.  The TPU
// kernel carries that accumulator across a sequential k grid axis; here
// the k walk is the loop inside the block, and the (i, j) tiles run in
// parallel on the SMs.  A block-row with no present tile gives sr.zero,
// as the Pallas _init does.
//
// bsr_spgemm stores the tile; it contracts with tile::contract
// (tile_mma.cuh: 32-deep k-slabs loaded through registers into one
// shared-memory slab) for all six semirings.  bsr_spgemm_reduce never
// stores C: the block ⊕-folds its tile over columns (axis 1) or rows
// (axis 0) through shared memory into one [128] vector and writes it as a
// partial, [N/128, M] for axis 1 or [M/128, N] for axis 0; the wrapper
// ⊕-folds the leading axis (the JAX wrapper folds its lanes the same way).
// No two blocks write one partial, so there are no atomics.  Its five
// CUDA-core semirings contract on the cp.async ring (ring::contract,
// semiring_gemm_sm90.cuh), which walks only the present k tiles;
// PLUS_TIMES takes the TF32 route (semiring_tf32_sm90.cu).
//
// Bound on an H100: operations.  Every present tile pair is 2·128^3 fp32
// operations against 128 KB of tile reads (32 a byte, above the fp32
// ridge of 20), and the reduce writes 1/128 of C.  The skip of absent
// tiles is uniform across the block (the mask is one int per block-row
// and k tile, so the branch never diverges).
#include "semiring_gemm_sm90.cuh"
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
__global__ void __launch_bounds__(ring::THREADS, 2)
    bsr_spgemm_reduce_kernel(const float* __restrict__ A, const int* __restrict__ mask,
                             const float* __restrict__ B, float* __restrict__ part, int M,
                             int N, int K, int axis) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ring::Stage* st = reinterpret_cast<ring::Stage*>(smem_raw);
  const long long bi = blockIdx.y;
  const long long bj = blockIdx.x;
  float acc[8][8];
  ring::contract<SR>(st, acc, A + bi * ring::BM * (long long)K, K, B + bj * ring::BN, N,
                     mask + bi * (K / kTileK), K);

  // fold: each thread ⊕-folds its 8 columns (axis 1) or 8 rows (axis 0)
  // into red[16][128], then 128 threads fold the 16 partials.  The ring is
  // free: contract ends on a barrier with no copy in flight.
  float* red = reinterpret_cast<float*>(smem_raw);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  if (axis == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = acc[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) v = SR::add(v, acc[i][j]);
      red[tx * ring::BM + ring::row_of(ty, i)] = v;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[0][j];
#pragma unroll
      for (int i = 1; i < 8; ++i) v = SR::add(v, acc[i][j]);
      red[ty * ring::BN + ring::col_of(tx, j)] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < ring::BM) {
    float v = red[threadIdx.x];
#pragma unroll
    for (int q = 1; q < 16; ++q) v = SR::add(v, red[q * ring::BM + threadIdx.x]);
    // axis 1: row bi*128 + t of partial bj ([N/128, M]);
    // axis 0: column bj*128 + t of partial bi ([M/128, N])
    if (axis == 1)
      part[bj * M + bi * ring::BM + threadIdx.x] = v;
    else
      part[bi * N + bj * ring::BN + threadIdx.x] = v;
  }
}

template <class SR>
int launch_reduce(const float* a, const int* mask, const float* b, float* part, int m, int n,
                  int k, int axis, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(bsr_spgemm_reduce_kernel<SR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ring::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n / ring::BN, m / ring::BM);
  bsr_spgemm_reduce_kernel<SR><<<grid, ring::THREADS, ring::SMEM_BYTES, stream>>>(
      a, mask, b, part, m, n, k, axis);
  return (int)cudaGetLastError();
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

// As above, for the five CUDA-core semirings (1..5; PLUS_TIMES takes
// bsr_spgemm_reduce_tf32_launch); part is [N/128, M] (axis 1) or
// [M/128, N] (axis 0) fp32.
extern "C" int bsr_spgemm_reduce_launch(int sr, const void* a, const void* mask,
                                        const void* b, void* part, int m, int n, int k,
                                        int axis, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  SR_DISPATCH_CORE(sr, return launch_reduce<SR>((const float*)a, (const int*)mask,
                                                (const float*)b, (float*)part, m, n, k, axis,
                                                (cudaStream_t)stream));
  return 0;
}
