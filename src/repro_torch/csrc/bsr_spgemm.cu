// bsr_spgemm and bsr_spgemm_reduce: block-masked dense A ⊗.⊕ dense B for
// the five semirings of the CUDA-core ring; PLUS_TIMES takes the TF32 route
// (semiring_tf32_sm90.cu: bsr_spgemm_tf32_launch, bsr_spgemm_reduce_tf32_launch).
//
// Replace bsr_spgemm_pallas and bsr_spgemm_reduce_pallas
// (src/repro/kernels/bsr_spgemm/bsr_spgemm.py) for every semiring but
// PLUS_TIMES.
//
// A is [M, K] fp32, stored dense but block-masked by an int32
// [M/128, K/128] presence mask: an absent 128x128 tile counts as the
// semiring zero and its contraction is skipped.  B is [K, N] fp32, dense.
// One 256-thread block owns one 128x128 output tile (i, j) and contracts
// it on the cp.async ring (ring::contract, semiring_gemm_sm90.cuh), which
// walks only the 32-deep slabs of block-row i's present k tiles.  The TPU
// kernel carries that accumulator across a sequential k grid axis; here
// the k walk is the loop inside the block, and the (i, j) tiles run in
// parallel on the SMs.  A block-row with no present tile gives sr.zero,
// as the Pallas _init does.
//
// bsr_spgemm stores the tile (ring::store_tile), as semiring_matmul does.
// bsr_spgemm_reduce never stores C: the block ⊕-folds its tile over
// columns (axis 1) or rows (axis 0) through shared memory into one [128]
// vector and writes it as a partial, [N/128, M] for axis 1 or [M/128, N]
// for axis 0; the wrapper ⊕-folds the leading axis (the JAX wrapper folds
// its lanes the same way).  No two blocks write one partial, so there are
// no atomics.
//
// Bound on an H100: instruction issue on the CUDA cores (two instructions
// per MAC, ⊕ on the 64-wide ALU pipe; semiring_gemm_sm90.cuh): 2·128^3
// semiring operations per present tile pair against 128 KB of tile reads.
// The skip of absent tiles is uniform across the block (the mask is one
// int per block-row and k tile, so the branch never diverges).
#include "semiring_gemm_sm90.cuh"

namespace {

template <class SR>
__global__ void __launch_bounds__(ring::THREADS, 2)
    bsr_spgemm_kernel(const float* __restrict__ A, const int* __restrict__ mask,
                      const float* __restrict__ B, float* __restrict__ C, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ring::Stage* st = reinterpret_cast<ring::Stage*>(smem_raw);
  const long long bi = blockIdx.y;
  const long long bj = blockIdx.x;
  float acc[8][8];
  ring::contract<SR>(st, acc, A + bi * ring::BM * (long long)K, K, B + bj * ring::BN, N,
                     mask + bi * (K / ring::KTILE), K);
  ring::store_tile(C + bi * ring::BM * N + bj * ring::BN, N, acc);
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
                     mask + bi * (K / ring::KTILE), K);

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

// Both kernels take the ring's dynamic shared memory: one 128x128 tile a
// block, grid (N/128, M/128).
template <class Kernel, class... Args>
int launch_ring(Kernel kernel, int m, int n, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ring::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n / ring::BN, m / ring::BM);
  kernel<<<grid, ring::THREADS, ring::SMEM_BYTES, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// A [M, K], B [K, N], C [M, N] fp32 row-major; mask int32 [M/128, K/128];
// M, N and K multiples of 128; sr one of the five CUDA-core semirings
// (1..5; PLUS_TIMES takes bsr_spgemm_tf32_launch).
extern "C" int bsr_spgemm_launch(int sr, const void* a, const void* mask, const void* b,
                                 void* c, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  SR_DISPATCH_CORE(sr, return launch_ring(bsr_spgemm_kernel<SR>, m, n, (cudaStream_t)stream,
                                          (const float*)a, (const int*)mask, (const float*)b,
                                          (float*)c, n, k));
  return 0;
}

// As above, for the five CUDA-core semirings (1..5; PLUS_TIMES takes
// bsr_spgemm_reduce_tf32_launch); part is [N/128, M] (axis 1) or
// [M/128, N] (axis 0) fp32.
extern "C" int bsr_spgemm_reduce_launch(int sr, const void* a, const void* mask,
                                        const void* b, void* part, int m, int n, int k,
                                        int axis, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  SR_DISPATCH_CORE(sr, return launch_ring(bsr_spgemm_reduce_kernel<SR>, m, n,
                                          (cudaStream_t)stream, (const float*)a,
                                          (const int*)mask, (const float*)b, (float*)part, m,
                                          n, k, axis));
  return 0;
}
