// rank_count: for each element of sorted int32 i, its rank and hit count
// in sorted int32 j, as one merge-path pass over both arrays.
//
// Replaces rank_count_pallas (src/repro/kernels/sorted_merge/sorted_merge.py).
// rank[m] = #{n : j[n] < i[m]} and hit[m] = #{n : j[n] == i[m]}: exactly
// two searchsorted calls (left and right) of i[m] in j, on every entry,
// sentinels included, with no padding.
//
// The TPU kernel tiles an all-pairs compare (O(Ni·Nj) vector compares,
// cheap on the VPU, with no gathers).  On Hopper that would be 6.9·10^10
// compares at the ingest path's 262,144 × 262,144, and one binary search
// per element (the first port) is O(Ni·log Nj) dependent scattered loads.
// This kernel streams both arrays once instead:
//
// Merging i and j gives each i[m] a count of j elements before it.  With
// ties broken i first, that count is the lower bound #{j < i[m]} (rank);
// with ties broken j first, it is the upper bound #{j <= i[m]}, and
// hit = upper - lower.  Block (x, order) owns the diagonal slice
// [x·TILE, (x+1)·TILE) of the merged sequence in that order: one warp
// finds the slice's start on the merge path and another its end, each with
// a 32-way search (every lane probes one split per round, so a round cuts
// the range 32-fold: 4 rounds of dependent loads at 2^18 keys where a
// binary search takes 18).  The block copies its windows of i and j into
// shared memory with coalesced loads, each thread finds its own start in
// the window by binary search and merges ITEMS consecutive elements
// sequentially, and the block writes its counts back in order.  Both
// orders run in the same launch (gridDim.y = 2); rank is stored by the
// lower order, and hit (zeroed first) gets +upper and -lower as integer
// reductions, so its result does not depend on which block runs first.
// Only comparisons are used (no x + 1), so the sentinel 2^31 - 1 and runs
// of equal values that span many blocks need no special case.
//
// Bound on an H100: bytes.  i and j are read once and rank and hit written
// once: 4·(2·Ni + Nj) bytes over 3.35 TB/s.  The kernel reads each array
// twice (once per order) and does two integer reductions per element of
// i; at the ingest path's sizes its time is mostly the partition searches'
// latency and the launch.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // merged elements per block
constexpr unsigned FULL = 0xffffffffu;

// does a[x] come before b[diag - x - 1] in the merge?  Ties: a first for
// the lower order, b first for the upper order
__device__ __forceinline__ bool a_first(int av, int bv, bool lower) {
  return lower ? av <= bv : av < bv;
}

// The split of diagonal `diag`: the number of a elements among the first
// `diag` merged elements, found by the whole warp.  The predicate
// a_first(a[x], b[diag - x - 1]) is true then false over x; each round
// every lane probes one x and the ballot narrows the range 32-fold.
__device__ int warp_split(const int* __restrict__ a, int na, const int* __restrict__ b, int nb,
                          int diag, bool lower, int lane) {
  int lo = max(0, diag - nb), hi = min(diag, na);  // the split lies in [lo, hi]
  while (hi > lo) {
    const int span = hi - lo;
    const int x = lo + (span <= 32 ? lane : (int)((long long)lane * span / 32));
    const bool probe = span <= 32 ? lane < span : true;
    const bool t = probe && a_first(__ldg(a + x), __ldg(b + diag - x - 1), lower);
    const int k = __popc(__ballot_sync(FULL, t));  // lanes 0..k-1 are true
    if (span <= 32) return lo + k;
    if (k == 0) return lo;
    const int next_hi = k < 32 ? lo + (int)((long long)k * span / 32) : hi;
    lo = lo + (int)((long long)(k - 1) * span / 32) + 1;
    hi = next_hi;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS) rank_count_kernel(const int* __restrict__ i,
                                                             const int* __restrict__ j,
                                                             int* __restrict__ rank,
                                                             int* __restrict__ hit, int ni,
                                                             int nj) {
  __shared__ int si[TILE], sj[TILE], cnt[TILE];
  __shared__ int split[2];
  const bool lower = blockIdx.y == 0;
  const int total = ni + nj;
  // d0 + TILE may pass 2^31 - 1 in the last block: sum in 64 bits
  const int d0 = blockIdx.x * TILE, d1 = (int)min((long long)d0 + TILE, (long long)total);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const int s = warp_split(i, ni, j, nj, warp == 0 ? d0 : d1, lower, lane);
    if (lane == 0) split[warp] = s;
  }
  __syncthreads();
  const int a0 = split[0], a1 = split[1];
  const int b0 = d0 - a0, b1 = d1 - a1;
  // sorted input gives na, nb >= 0 with na + nb = d1 - d0 <= TILE; the
  // clamps keep unsorted input inside both arrays and the windows
  const int na = max(0, min(a1 - a0, TILE)), nb = max(0, min(b1 - b0, TILE - na));
  for (int x = threadIdx.x; x < na; x += THREADS) si[x] = __ldg(i + a0 + x);
  for (int x = threadIdx.x; x < nb; x += THREADS) sj[x] = __ldg(j + b0 + x);
  __syncthreads();

  // this thread's ITEMS merged elements, from its own split of the window
  const int diag = min(threadIdx.x * ITEMS, na + nb);
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a_first(si[mid], sj[diag - mid - 1], lower))
      lo = mid + 1;
    else
      hi = mid;
  }
  int x = lo, y = diag - lo;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (x + y < na + nb) {
      if (y >= nb || (x < na && a_first(si[x], sj[y], lower))) {
        cnt[x] = b0 + y;  // j elements before i[a0 + x] in this order
        ++x;
      } else {
        ++y;
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < na; k += THREADS) {
    const int c = cnt[k];
    if (lower) {
      rank[a0 + k] = c;
      atomicAdd(hit + a0 + k, -c);
    } else {
      atomicAdd(hit + a0 + k, c);
    }
  }
}

}  // namespace

// i int32 [ni], j int32 [nj], both sorted ascending; rank, hit int32 [ni].
extern "C" int rank_count_launch(const void* i, const void* j, void* rank, void* hit, int ni,
                                 int nj, void* stream) {
  if (ni <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(hit, 0, (size_t)ni * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)ni + nj;
  const dim3 grid((unsigned)((total + TILE - 1) / TILE), 2);
  rank_count_kernel<<<grid, THREADS, 0, st>>>((const int*)i, (const int*)j, (int*)rank,
                                              (int*)hit, ni, nj);
  return (int)cudaGetLastError();
}
