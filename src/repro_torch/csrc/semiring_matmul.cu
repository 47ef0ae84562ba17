// semiring_matmul: dense C[i,j] = ⊕_k A[i,k] ⊗ B[k,j] for the five
// semirings with no tensor-core form; (+, ×) takes the TF32 route
// (semiring_tf32_sm90.cu, semiring_matmul_tf32_launch).
//
// Replaces semiring_matmul_pallas
// (src/repro/kernels/semiring_matmul/semiring_matmul.py) for every
// semiring but PLUS_TIMES, which that kernel sends to the matrix unit.
//
// Bound on an H100: instruction issue on the CUDA cores (two instructions
// per MAC, ⊕ on the 64-wide ALU pipe; semiring_gemm_sm90.cuh).  The design
// is the ring's: a 128x128 output tile per block, 8x8 outputs per thread,
// a 3-stage cp.async ring of 32-deep k-slabs.  The K loop runs inside the
// block (the Pallas grid's sequential axis), and the wrapper pads M and N
// to 128 and K to 32 with the semiring zero, so the kernel has no edge
// cases.
#include "semiring_gemm_sm90.cuh"

namespace {

template <class SR>
__global__ void __launch_bounds__(ring::THREADS, 2)
    semiring_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                           float* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ring::Stage* st = reinterpret_cast<ring::Stage*>(smem_raw);
  const long long bi = blockIdx.y;
  const long long bj = blockIdx.x;
  float acc[8][8];
  ring::contract<SR>(st, acc, A + bi * ring::BM * K, K, B + bj * ring::BN, N, nullptr, K);
  ring::store_tile(C + bi * ring::BM * N + bj * ring::BN, N, acc);
}

template <class SR>
int launch(const float* a, const float* b, float* c, int m, int n, int k, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(semiring_matmul_kernel<SR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ring::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n / ring::BN, m / ring::BM);
  semiring_matmul_kernel<SR><<<grid, ring::THREADS, ring::SMEM_BYTES, stream>>>(a, b, c, m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// A [M, K], B [K, N], C [M, N], fp32 row-major; M % 128 == N % 128 == 0,
// K % 32 == 0; sr one of the five CUDA-core semirings (1..5).
extern "C" int semiring_matmul_launch(int sr, const void* a, const void* b, void* c, int m,
                                      int n, int k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  SR_DISPATCH_CORE(sr, return launch<SR>((const float*)a, (const float*)b, (float*)c, m, n, k,
                                         (cudaStream_t)stream));
  return 0;
}
