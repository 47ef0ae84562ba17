// range_mask: the keep mask of a rank-box selection over padded COO triples.
//
// Replaces range_mask_pallas (src/repro/kernels/range_extract/range_extract.py).
// keep[t] = rows[t] in [rlo, rhi) && cols[t] in [clo, chi) && rows[t] != SENT.
//
// Bound on an H100: memory.  The function needs rows (4 bytes an entry),
// keep (4 bytes) and cols only where the row decides nothing alone (4
// bytes an entry whose row lies in [rlo, rhi)): 8N + 4·|rows inside| bytes
// over 3.35 TB/s (ops.range_mask_bytes).  A canonical COO is sorted by row,
// so a row box's entries form one contiguous run, and the design reads
// cols only around it:
//
// * row-gated cols: a thread loads an int4 of cols only where one of the
//   int4's four rows lies in [rlo, rhi).  A warp's 32 int4 cover 128
//   consecutive entries, so warps outside the run skip their cols lines on
//   a warp-uniform branch; unsorted input stays correct and reads more.
// * bytes in flight: each thread takes kGroups int4 of rows a pass, every
//   load issued before the compares, in a grid-stride loop over at most
//   one wave of resident blocks (132 SMs x blocks an SM).
// Timed on an H100 against variants of this source (PERF.md § Findings):
// kGroups 2 over 1, 4 and 8, and half a wave of blocks, by 1-9%;
// streaming hints left out: ld.global.cs on the inputs made the kernel
// about 3% slower, st.global.cs on keep changed nothing.
// The bounds travel as kernel arguments; the n % 4 tail (at most three
// entries) is block 0's.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kSent = 2147483647;
constexpr int kThreads = 256;
constexpr int kGroups = 2;                   // int4 of rows a thread takes a pass
constexpr int kChunk = kThreads * kGroups;   // int4 a block takes a pass

__device__ __forceinline__ int row_in(int r, int rlo, int rhi) {
  return (r != kSent) & (r >= rlo) & (r < rhi);
}
__device__ __forceinline__ int col_in(int c, int clo, int chi) { return (c >= clo) & (c < chi); }

__global__ void __launch_bounds__(kThreads)
    range_mask_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                      int* __restrict__ keep, long long n, int rlo, int rhi, int clo, int chi) {
  const long long n4 = n / 4;
  const int4* r4 = reinterpret_cast<const int4*>(rows);
  const int4* c4 = reinterpret_cast<const int4*>(cols);
  int4* k4 = reinterpret_cast<int4*>(keep);
  const long long stride = (long long)gridDim.x * kChunk;
  for (long long base = blockIdx.x * (long long)kChunk + threadIdx.x; base < n4;
       base += stride) {
    int4 r[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const long long q = base + g * kThreads;
      r[g] = q < n4 ? r4[q] : make_int4(kSent, kSent, kSent, kSent);
    }
    int4 c[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int any = row_in(r[g].x, rlo, rhi) | row_in(r[g].y, rlo, rhi) |
                      row_in(r[g].z, rlo, rhi) | row_in(r[g].w, rlo, rhi);
      c[g] = any ? c4[base + g * kThreads] : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const long long q = base + g * kThreads;
      if (q < n4) {
        int4 k;
        k.x = row_in(r[g].x, rlo, rhi) & col_in(c[g].x, clo, chi);
        k.y = row_in(r[g].y, rlo, rhi) & col_in(c[g].y, clo, chi);
        k.z = row_in(r[g].z, rlo, rhi) & col_in(c[g].z, clo, chi);
        k.w = row_in(r[g].w, rlo, rhi) & col_in(c[g].w, clo, chi);
        k4[q] = k;
      }
    }
  }
  const long long t = n4 * 4 + threadIdx.x;  // the n % 4 tail
  if (blockIdx.x == 0 && t < n)
    keep[t] = row_in(rows[t], rlo, rhi) & col_in(cols[t], clo, chi);
}

// The blocks of one wave on the current device, asked once per device.
cudaError_t wave_blocks(long long* blocks) {
  static int cached_dev = -1;
  static long long cached = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != cached_dev) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, range_mask_kernel, kThreads, 0);
    if (e == cudaSuccess) {
      cached = (long long)sms * per_sm;
      cached_dev = dev;
    }
  }
  *blocks = cached;
  return e;
}

}  // namespace

// rows, cols, keep int32 [n], 16-byte aligned.
extern "C" int range_mask_launch(const void* rows, const void* cols, void* keep, long long n,
                                 int rlo, int rhi, int clo, int chi, void* stream) {
  if (n <= 0) return 0;
  long long wave = 0;
  const cudaError_t e = wave_blocks(&wave);
  if (e != cudaSuccess) return (int)e;
  if (wave < 1) return (int)cudaErrorInvalidConfiguration;
  const long long need = (n / 4 + kChunk - 1) / kChunk;
  const long long grid = need < 1 ? 1 : (need < wave ? need : wave);
  range_mask_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)rows, (const int*)cols, (int*)keep, n, rlo, rhi, clo, chi);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
