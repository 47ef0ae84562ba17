// rank_count: for each element of sorted int32 i, its rank and hit count
// in sorted int32 j.
//
// Replaces rank_count_pallas (src/repro/kernels/sorted_merge/sorted_merge.py).
// rank[m] = #{n : j[n] < i[m]} and hit[m] = #{n : j[n] == i[m]}: exactly
// two searchsorted calls (left and right) of i[m] in j, on every entry,
// sentinels included, with no padding.
//
// The TPU kernel tiles an all-pairs compare (O(Ni·Nj) vector compares,
// cheap on the VPU, with no gathers).  On Hopper that would be 6.9·10^10
// compares at the ingest path's 262,144 × 262,144; a binary search is
// O(Ni·log Nj) scattered loads instead.  One thread per i element runs a
// lower-bound and an upper-bound search over j.  j is at most a few MB at
// the ingest path's sizes, so after the first probes it sits in the 50 MB
// L2 and the searches' dependent loads are L2 hits.
//
// Bound on an H100: bytes.  Each i element reads 4 bytes and writes 8, and
// j is read once: 4·(2·Ni + Nj) bytes over 3.35 TB/s.  The kernel is far
// from that floor by nature (log2 Nj dependent loads per thread, about 18
// at 262,144); merge-path partitioning, which streams both arrays once,
// is later work.
#include <cuda_runtime.h>

namespace {

// first index n in [lo, hi) with j[n] >= x (left) or j[n] > x (right),
// given that every j before lo is below that bound
__device__ __forceinline__ int search(const int* __restrict__ j, int lo, int hi, int x,
                                      bool right) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int v = __ldg(j + mid);
    if (right ? (v <= x) : (v < x))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(256) rank_count_kernel(const int* __restrict__ i,
                                                         const int* __restrict__ j,
                                                         int* __restrict__ rank,
                                                         int* __restrict__ hit, int ni,
                                                         int nj) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= ni) return;
  const int x = i[m];
  const int left = search(j, 0, nj, x, false);
  const int right = search(j, left, nj, x, true);  // at or after the left bound
  rank[m] = left;
  hit[m] = right - left;
}

}  // namespace

// i int32 [ni], j int32 [nj], both sorted ascending; rank, hit int32 [ni].
extern "C" int rank_count_launch(const void* i, const void* j, void* rank, void* hit, int ni,
                                 int nj, void* stream) {
  if (ni <= 0) return 0;
  const int block = 256;
  const int grid = (ni + block - 1) / block;
  rank_count_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)i, (const int*)j, (int*)rank, (int*)hit, ni, nj);
  return (int)cudaGetLastError();
}
