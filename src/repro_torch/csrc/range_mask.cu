// range_mask: the keep mask of a rank-box selection over padded COO triples.
//
// Replaces range_mask_pallas (src/repro/kernels/range_extract/range_extract.py).
// keep[t] = rows[t] in [rlo, rhi) && cols[t] in [clo, chi) && rows[t] != SENT.
//
// Bound on an H100: memory.  Each entry reads 8 bytes and writes 4, with four
// integer compares, so the time floor is 12 bytes x N over 3.35 TB/s.  The
// design keeps to that floor: one thread per four entries with 16-byte
// (int4) loads and stores, so each warp moves whole 512-byte lines, and the
// bounds travel as kernel arguments instead of a device array.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kSent = 2147483647;

__device__ __forceinline__ int inside(int r, int c, int rlo, int rhi, int clo, int chi) {
  return (r != kSent) & (r >= rlo) & (r < rhi) & (c >= clo) & (c < chi);
}

__global__ void __launch_bounds__(256) range_mask_kernel(const int* __restrict__ rows,
                                                         const int* __restrict__ cols,
                                                         int* __restrict__ keep, long long n,
                                                         int rlo, int rhi, int clo, int chi) {
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  if (g < n4) {
    const int4 r = reinterpret_cast<const int4*>(rows)[g];
    const int4 c = reinterpret_cast<const int4*>(cols)[g];
    int4 k;
    k.x = inside(r.x, c.x, rlo, rhi, clo, chi);
    k.y = inside(r.y, c.y, rlo, rhi, clo, chi);
    k.z = inside(r.z, c.z, rlo, rhi, clo, chi);
    k.w = inside(r.w, c.w, rlo, rhi, clo, chi);
    reinterpret_cast<int4*>(keep)[g] = k;
  } else {
    const long long t = n4 * 4 + (g - n4);  // the n % 4 tail, one per thread
    if (t < n) keep[t] = inside(rows[t], cols[t], rlo, rhi, clo, chi);
  }
}

}  // namespace

extern "C" int range_mask_launch(const void* rows, const void* cols, void* keep, long long n,
                                 int rlo, int rhi, int clo, int chi, void* stream) {
  if (n <= 0) return 0;
  const long long threads = n / 4 + n % 4;
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  range_mask_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)rows, (const int*)cols, (int*)keep, n, rlo, rhi, clo, chi);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
