// segment_scan: inclusive segmented ⊕-scan (sum, min or max) of fp32
// values over runs of equal keys in a sorted int32 key array.
//
// Replaces segment_scan_pallas
// (src/repro/kernels/segment_reduce/segment_reduce.py).
//
// out[i] = ⊕ of vals[j] over j <= i in i's run.  The TPU kernel walks
// 1024-element blocks in order and carries (last key, running value) from
// one grid step to the next.  CUDA blocks run in no order, so the carry is
// two more passes, and no result depends on which block ran first:
//   1. scan_blocks: one 256-thread block per 1024 elements (4 per thread)
//      scans its elements as if a run began at the block's start: a serial
//      scan of each thread's 4, then a segmented scan of the thread totals
//      (warp shuffles, then the 8 warp totals).  It writes the local result
//      and a summary: the block's last key, its last local value, and the
//      length of its leading run.
//   2. scan_carries: one 1024-thread block scans the summaries, in the
//      same segmented way, into the full value at the end of each block (a
//      block continues its predecessor's run when it is one run with the
//      predecessor's last key).
//   3. apply_carries: block j ⊕-combines the full value at the end of
//      block j-1 into its leading run, where that run has block j-1's
//      last key.
// min and max are exact.  A sum is taken in another order than the
// plain version's (a tree of doublings) or the Pallas kernel's, so sums
// differ by rounding only.
//
// Bound on an H100: bytes.  Keys and values are read once and the result
// written once: 12 bytes an element, 25.2 MB at the dedup size of the
// clustered n=18 array (2^21 elements), 0.0075 ms at 3.35 TB/s.  Pass 1
// moves those bytes with 16-byte loads; pass 3 rewrites only the leading
// runs (a few elements a block where runs are short), and pass 2 reads 12
// bytes per 1024 elements.  The three launches cost a few microseconds
// each, which dominates below about a million elements.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BN = 1024;          // elements per block of pass 1
constexpr int T1 = 256;           // threads of pass 1 (4 elements each)
constexpr int T2 = 1024;          // threads of pass 2
constexpr unsigned FULL = 0xffffffffu;

struct Sum {
  static __device__ __forceinline__ float id() { return 0.f; }
  static __device__ __forceinline__ float op(float a, float b) { return a + b; }
};
struct Min {
  static __device__ __forceinline__ float id() { return CUDART_INF_F; }
  static __device__ __forceinline__ float op(float a, float b) { return fminf(a, b); }
};
struct Max {
  static __device__ __forceinline__ float id() { return -CUDART_INF_F; }
  static __device__ __forceinline__ float op(float a, float b) { return fmaxf(a, b); }
};

// Segmented exclusive scan of per-thread aggregates (f: the thread's
// elements hold a run head, v: ⊕ since its last head) across the block.
// On return `pre` says whether any thread precedes this one, and `pv` is
// the ⊕ of the elements from the last head before this thread up to it.
// wv/wf: shared scratch of NT/32 entries.  Every thread must call it.
template <class Op, int NT>
__device__ __forceinline__ void block_exclusive(int f, float v, float* wv, int* wf, float& pv,
                                                bool& pre) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sv = v;
  int sf = f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float ov = __shfl_up_sync(FULL, sv, off);
    const int of = __shfl_up_sync(FULL, sf, off);
    if (lane >= off) {
      sv = sf ? sv : Op::op(ov, sv);
      sf |= of;
    }
  }
  if (lane == 31) {
    wv[warp] = sv;
    wf[warp] = sf;
  }
  __syncthreads();
  if (warp == 0) {
    float tv = lane < NW ? wv[lane] : Op::id();
    int tf = lane < NW ? wf[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float ov = __shfl_up_sync(FULL, tv, off);
      const int of = __shfl_up_sync(FULL, tf, off);
      if (lane >= off) {
        tv = tf ? tv : Op::op(ov, tv);
        tf |= of;
      }
    }
    if (lane < NW) {
      wv[lane] = tv;  // inclusive over warps 0..lane
      wf[lane] = tf;
    }
  }
  __syncthreads();
  const float ev = __shfl_up_sync(FULL, sv, 1);
  const int ef = __shfl_up_sync(FULL, sf, 1);
  if (lane == 0) {
    pre = warp > 0;
    pv = warp > 0 ? wv[warp - 1] : Op::id();
  } else {
    pre = true;
    pv = (warp > 0 && !ef) ? Op::op(wv[warp - 1], ev) : ev;
  }
  __syncthreads();  // wv/wf may be reused by the caller
}

// Pass 1.  Elements past n take key keys[n-1] and the identity, so they
// extend the last run without changing it, and are not written.
template <class Op>
__global__ void __launch_bounds__(T1)
    scan_blocks(const int* __restrict__ keys, const float* __restrict__ vals,
                float* __restrict__ out, long long n, int* __restrict__ blk_key,
                float* __restrict__ blk_val, int* __restrict__ blk_lead) {
  __shared__ float wv[T1 / 32];
  __shared__ int wf[T1 / 32];
  __shared__ int lead;
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * BN + 4 * t;
  if (t == 0) lead = BN;
  int k[4];
  float v[4];
  if (base + 3 < n) {
    const int4 kk = *reinterpret_cast<const int4*>(keys + base);
    const float4 vv = *reinterpret_cast<const float4*>(vals + base);
    k[0] = kk.x, k[1] = kk.y, k[2] = kk.z, k[3] = kk.w;
    v[0] = vv.x, v[1] = vv.y, v[2] = vv.z, v[3] = vv.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long i = base + e;
      k[e] = keys[i < n ? i : n - 1];
      v[e] = i < n ? vals[i] : Op::id();
    }
  }
  const int prev = t == 0 ? 0 : keys[base - 1 < n ? base - 1 : n - 1];
  // run heads among this thread's elements; the block's first element
  // starts a run here (pass 3 joins it to the previous block's)
  float run[4];
  int first_head = -1, lead_here = BN;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool differs = e == 0 ? (t > 0 && k[0] != prev) : k[e] != k[e - 1];
    const bool head = differs || (t == 0 && e == 0);
    run[e] = head || e == 0 ? v[e] : Op::op(run[e - 1], v[e]);
    if (head && first_head < 0) first_head = e;
    if (differs && lead_here == BN) lead_here = 4 * t + e;
  }
  __syncthreads();  // `lead` is initialised
  if (lead_here < BN) atomicMin(&lead, lead_here);

  float pv;
  bool pre;
  block_exclusive<Op, T1>(first_head >= 0, run[3], wv, wf, pv, pre);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (pre && (first_head < 0 || e < first_head)) run[e] = Op::op(pv, run[e]);
    if (base + e < n) out[base + e] = run[e];
  }
  if (t == T1 - 1) {  // the block's last element (block_exclusive's barriers
    blk_key[blockIdx.x] = k[3];  // came after every atomicMin)
    blk_val[blockIdx.x] = run[3];
    blk_lead[blockIdx.x] = lead;
  }
}

// Pass 2: full[j] = the scanned value at the end of block j.  Block j
// continues block j-1's run when it is one run (its leading run fills it)
// with block j-1's last key.  Each thread takes `per` consecutive blocks.
template <class Op>
__global__ void __launch_bounds__(T2)
    scan_carries(const int* __restrict__ blk_key, const float* __restrict__ blk_val,
                 const int* __restrict__ blk_lead, float* __restrict__ full, int nb) {
  __shared__ float wv[T2 / 32];
  __shared__ int wf[T2 / 32];
  const int per = (nb + T2 - 1) / T2;
  const int j0 = threadIdx.x * per, j1 = min(j0 + per, nb);
  int f = 0;
  float v = Op::id();
  for (int j = j0; j < j1; ++j) {
    const bool head = j == 0 || blk_lead[j] != BN || blk_key[j] != blk_key[j - 1];
    v = head ? blk_val[j] : Op::op(v, blk_val[j]);
    f |= head;
  }
  float pv;
  bool pre;
  block_exclusive<Op, T2>(f, v, wv, wf, pv, pre);
  float x = pv;
  for (int j = j0; j < j1; ++j) {
    const bool head = j == 0 || blk_lead[j] != BN || blk_key[j] != blk_key[j - 1];
    x = head || (!pre && j == j0) ? blk_val[j] : Op::op(x, blk_val[j]);
    full[j] = x;
  }
}

// Pass 3: block j (from 1) ⊕-combines full[j-1] into its leading run when
// that run has block j-1's last key.
template <class Op>
__global__ void __launch_bounds__(T1)
    apply_carries(const int* __restrict__ keys, float* __restrict__ out, long long n,
                  const int* __restrict__ blk_key, const int* __restrict__ blk_lead,
                  const float* __restrict__ full) {
  const int j = blockIdx.x + 1;
  const long long b0 = (long long)j * BN;
  if (keys[b0] != blk_key[j - 1]) return;
  const float c = full[j - 1];
  const long long end = min((long long)blk_lead[j], n - b0);
  for (long long i = threadIdx.x; i < end; i += T1) out[b0 + i] = Op::op(c, out[b0 + i]);
}

template <class Op>
int launch_op(const int* keys, const float* vals, float* out, long long n, int* scratch,
              cudaStream_t stream) {
  const int nb = (int)((n + BN - 1) / BN);
  int* blk_key = scratch;
  float* blk_val = reinterpret_cast<float*>(scratch + nb);
  int* blk_lead = scratch + 2 * nb;
  float* full = reinterpret_cast<float*>(scratch + 3 * nb);
  scan_blocks<Op><<<nb, T1, 0, stream>>>(keys, vals, out, n, blk_key, blk_val, blk_lead);
  if (nb > 1) {
    scan_carries<Op><<<1, T2, 0, stream>>>(blk_key, blk_val, blk_lead, full, nb);
    apply_carries<Op><<<nb - 1, T1, 0, stream>>>(keys, out, n, blk_key, blk_lead, full);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// combine 0: sum, 1: min, 2: max.  keys int32 [n] sorted ascending, vals
// fp32 [n], out fp32 [n], all 16-byte aligned; scratch int32 [4 * ceil(n /
// 1024)].
extern "C" int segment_scan_launch(int combine, const void* keys, const void* vals, void* out,
                                   long long n, void* scratch, void* stream) {
  if (n <= 0) return 0;
  const int* k = static_cast<const int*>(keys);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  int* s = static_cast<int*>(scratch);
  cudaStream_t st = (cudaStream_t)stream;
  switch (combine) {
    case 0: return launch_op<Sum>(k, v, o, n, s, st);
    case 1: return launch_op<Min>(k, v, o, n, s, st);
    case 2: return launch_op<Max>(k, v, o, n, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
