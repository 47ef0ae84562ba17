// semiring_matmul: dense C[i,j] = ⊕_k A[i,k] ⊗ B[k,j] for every semiring.
//
// Replaces semiring_matmul_pallas
// (src/repro/kernels/semiring_matmul/semiring_matmul.py).
//
// Bound on an H100: operations.  The dense strategy's products are square
// and large (4096^3 at the uniform n=12 workload), so the 2·M·N·K fp32
// operations on CUDA cores (67 TFLOP/s, FMA counted as two) outweigh the
// (MK + KN + MN)·4 bytes by two orders of magnitude.  None of the five
// max/min semirings has a tensor-core form, and (+, ×) stays in fp32 FMA
// (no TF32) so it agrees with the plain version to rounding.  The design
// works for that bound with register tiling: a 128x128 output tile per
// block, 8x8 outputs per thread, 32-deep k-slabs in shared memory, so each
// shared-memory float4 feeds 16 MACs.  The K loop runs inside the block
// (the Pallas grid's sequential axis), and the wrapper pads M and N to 128
// and K to 32 with the semiring zero, so the kernel has no edge cases.
#include "tile_mma.cuh"

namespace {

template <class SR>
__global__ void __launch_bounds__(tile::THREADS)
    semiring_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                           float* __restrict__ C, int M, int N, int K) {
  __shared__ tile::Slab s;
  const long long bi = blockIdx.y;
  const long long bj = blockIdx.x;
  float acc[8][8];
  tile::fill<SR>(acc);
  tile::contract<SR>(s, acc, A + bi * tile::BM * K, K, B + bj * tile::BN, N, K);
  tile::store_tile(C + bi * tile::BM * N + bj * tile::BN, N, acc);
}

}  // namespace

// A [M, K], B [K, N], C [M, N], fp32 row-major; M % 128 == N % 128 == 0,
// K % 32 == 0.
extern "C" int semiring_matmul_launch(int sr, const void* a, const void* b, void* c, int m,
                                      int n, int k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid(n / tile::BN, m / tile::BM);
  SR_DISPATCH(sr, semiring_matmul_kernel<SR><<<grid, tile::THREADS, 0, (cudaStream_t)stream>>>(
                      (const float*)a, (const float*)b, (float*)c, m, n, k));
  return (int)cudaGetLastError();
}
