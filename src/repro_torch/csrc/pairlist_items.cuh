// The work items of the pair-list kernels (bsr_pairlist.cu on the CUDA
// cores, bsr_pairlist_tf32_sm90.cu on the tensor cores), and the fold of
// the fused reduce's chunk partials.
//
// The planner sorts the pairs by output, and the wrapper turns the sorted
// output ids into run offsets (runs[o] .. runs[o + 1] are output o's
// pairs).  bsr_pairlist gives each run to one item.  bsr_pairlist_reduce
// cuts each run into chunks of at most `chunk` pairs (an empty run is one
// empty chunk), so no block waits on a hub's long run: chunk_off[o] is
// output o's first item, chunk_off[n_out] the number of items, and each
// item writes its own [128] partial, which fold_chunks ⊕-folds per output
// in item order.  The wrapper builds chunk_off on the device from runs.
#pragma once

#include "semiring.cuh"

namespace pairs {

constexpr int TILE = 128;
constexpr long long TILE_ELEMS = (long long)TILE * TILE;

struct Items {
  const int* runs;       // [n_out + 1] run offsets into the pair list
  const int* chunk_off;  // [n_out + 1] first item of each output; null: one item per output
  int n_out, chunk;

  __device__ __forceinline__ int count() const { return chunk_off ? chunk_off[n_out] : n_out; }

  // item i's pairs [p0, p1)
  __device__ __forceinline__ void range(int i, int& p0, int& p1) const {
    if (chunk_off == nullptr) {
      p0 = runs[i];
      p1 = runs[i + 1];
      return;
    }
    int lo = 0, hi = n_out;  // chunk_off[lo] <= i < chunk_off[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (chunk_off[mid] <= i)
        lo = mid;
      else
        hi = mid;
    }
    p0 = runs[lo] + (i - chunk_off[lo]) * chunk;
    p1 = min(p0 + chunk, runs[lo + 1]);
  }
};

// out[o] = ⊕ of the partials of output o's items, in item order; one block
// of 128 threads an output
template <class SR>
__global__ void __launch_bounds__(TILE)
    fold_chunks(const float* __restrict__ part, const int* __restrict__ chunk_off,
                float* __restrict__ out) {
  const int o = blockIdx.x;
  const int c0 = chunk_off[o], c1 = chunk_off[o + 1];
  float v = part[(long long)c0 * TILE + threadIdx.x];
  for (int c = c0 + 1; c < c1; ++c) v = SR::add(v, part[(long long)c * TILE + threadIdx.x]);
  out[(long long)o * TILE + threadIdx.x] = v;
}

}  // namespace pairs
