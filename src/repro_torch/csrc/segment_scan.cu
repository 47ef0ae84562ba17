// segment_scan: inclusive segmented ⊕-scan (sum, min or max) of fp32
// values over runs of equal adjacent int32 keys, in one launch and one
// pass.
//
// Replaces segment_scan_pallas
// (src/repro/kernels/segment_reduce/segment_reduce.py).
//
// out[i] = ⊕ of vals[j] over j <= i in i's run, where a run is a maximal
// stretch of adjacent equal keys (sorted keys make one run per key; the
// keys need not be sorted).  The TPU kernel walks 1024-element blocks in
// order and carries (last key, running value) from one grid step to the
// next.  CUDA blocks run in no order, so each tile of TILE = 256 threads x
// E elements finds its carry by a decoupled look-back over the tiles
// before it:
//
//   1. Load.  Thread t of tile j holds elements j·TILE + t·E + [0, E); each
//      warp loads its 32·E elements with coalesced int4 / float4 loads and
//      hands them out through shared memory.  Thread 0 also reads the one
//      key before the tile.  A run head is element 0 or a key that differs
//      from its predecessor's.
//   2. Local scan (the order the plain model segment_scan_tiled_ref in
//      kernels/segment_reduce/ref.py repeats step by step): a serial scan of
//      each thread's E elements, x[e] = head ? v[e] : x[e-1] ⊕ v[e]; a
//      Hillis-Steele segmented scan of the 32 thread totals of each warp
//      (shuffles at offsets 1..16); the same over the 8 warp totals (offsets
//      1, 2, 4; warp 0); each thread's exclusive prefix is (the warp prefix
//      before its warp) ⊕ (the lane prefix before it), and its elements up to
//      its first head take prefix ⊕ x[e].  The tile's summary is the block
//      scan's last entry: (holds a head, ⊕ of its trailing run).
//   3. Publish the summary at once, as one 64-bit status word (the value's
//      bits, a head bit, this call's epoch) with st.release.gpu.  A warp
//      whose elements all follow the tile's first head is final and stores
//      them now (coalesced, through shared memory again).
//   4. Look-back (warp 0), only where the tile's first element is not a head
//      (or where the tile closes a group, below).  Statuses come in levels:
//      level 0 holds every tile's summary; the last tile of each full group of
//      32 level-L entries writes their level L+1 summary (a Hillis-Steele scan
//      of the 32, lane 31's result), so no word waits on another tile's
//      look-back.  At level L the tile's index is idx = j >> 5L and c = idx %
//      32: lanes 0..c-1 wait (ld.acquire.gpu) for the c entries before it in
//      its group, the warp scans them, and lane c-1's result W_L extends the
//      carry: carry = W_L, then W_{L+1} ⊕ carry, and so on up until a window
//      holds a head.  Level 0 covers the 31 tiles before j within its group,
//      level 1 the groups before it within its 1024 tiles, and so on; tile 0's
//      first element is a head, so the walk always ends.  Runs of length 1 or
//      a few (the repo's pair ids) put a head first in nearly every tile: no
//      wait at all.  One run over every tile waits on at most one window a
//      level: log32 of the tiles.
//   5. The tile's leading run (the elements before its first head) takes
//      carry ⊕ its local value, and is stored.
//
// Deterministic: every combination above has a fixed place, set by the
// data and the tile index, never by which block ran first, so sums come out
// the same in every bit on every call (and equal to the model's).
//
// Forward progress: the grid is persistent, at most the blocks the card
// holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), and
// block b takes tiles b, b + grid, ... in increasing order.  A tile waits
// only on tiles before it, whose blocks are all resident and each work
// through their tiles in order, so every wait ends.  A wait that does not
// end within about 16 s traps: a bug fails the launch and does not hang
// the card.
//
// Stale words: the status words are zeroed once when the host allocates
// them, and from then on only this kernel writes them, so a word there is 0
// or an earlier call's.  Every word carries its call's 31-bit epoch (the
// host counts calls on a buffer, 1 .. 2^31 - 1, and zeroes it again before
// the count wraps), and a reader takes only a word with its own epoch.
//
// max and min propagate NaN (max.NaN / min.NaN of semiring.cuh), as
// jnp.maximum and torch.maximum do: a NaN reaches every later element of
// its run and no other.
//
// Summation depth: a sum out[i] is a tree in which each term passes at most
// d(i) additions, so |out[i] - exact| <= γ_d(i) · (Σ |v| over the run up to
// i), γ_d = d·2^-24 / (1 - d·2^-24).  d(i) <= E + 9 where i's run starts
// in its tile; in a tile's leading run d(i) <= E + 14 + 5·L, L the highest
// look-back level the carry reached (E = 16: 25, then 30, 35, 40, ...).
// segment_scan_depth (ref.py) gives d(i) exactly, by the model run with the
// depth max(a, b) + 1 for ⊕.
//
// Bound on an H100: bytes.  Keys and values are read once and the result
// written once: 12 bytes an element (plus one key and 8-byte status words a
// tile), 25.2 MB at the dedup size of the clustered n=18 array (2^21
// elements), 0.0075 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>

#include "semiring.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int E = 16;               // elements a thread (E / 4 int4)
constexpr int TILE = THREADS * E;   // 4096
constexpr int MAX_LEVELS = 6;       // 32^6 tiles
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SPIN_LIMIT = 1LL << 24;  // polls of at most 1 µs each

struct Sum {
  static __device__ __forceinline__ float id() { return 0.f; }
  static __device__ __forceinline__ float op(float a, float b) { return a + b; }
};
struct Min {
  static __device__ __forceinline__ float id() { return CUDART_INF_F; }
  static __device__ __forceinline__ float op(float a, float b) { return min_nan(a, b); }
};
struct Max {
  static __device__ __forceinline__ float id() { return -CUDART_INF_F; }
  static __device__ __forceinline__ float op(float a, float b) { return max_nan(a, b); }
};

// Status words: level L (0 .. nl-1) holds ceil(n_tiles / 32^L) words and
// follows level L-1 in the scratch.  The kernel walks the levels in order
// and keeps the offsets as it goes (an array of them would live in local
// memory).

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// upper half: epoch << 1 | head; lower half: the value's bits
__device__ __forceinline__ void publish(unsigned long long* p, unsigned epoch, int head, float v) {
  st_release(p, ((unsigned long long)((epoch << 1) | (unsigned)head) << 32) | __float_as_uint(v));
}

// Wait until the word at p carries this call's epoch; its (head, value).
__device__ __forceinline__ void wait_word(const unsigned long long* p, unsigned epoch, int& head,
                                          float& v) {
  unsigned long long w = ld_acquire(p);
  unsigned ns = 32;
  for (long long tries = 0; (unsigned)(w >> 33) != epoch; ++tries) {
    if (tries > SPIN_LIMIT) __trap();
    __nanosleep(ns);
    if (ns < 1024) ns *= 2;
    w = ld_acquire(p);
  }
  head = (int)((w >> 32) & 1);
  v = __uint_as_float((unsigned)w);
}

// Inclusive segmented Hillis-Steele scan of (f: holds a head, v) over the
// first `width` lanes of the warp (offsets 1, 2, ... < width); a lane's
// result depends only on the lanes before it.  Every lane must call it.
template <class Op, int width>
__device__ __forceinline__ void lane_scan(int& f, float& v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < width; off <<= 1) {
    const float ov = __shfl_up_sync(FULL, v, off);
    const int of = __shfl_up_sync(FULL, f, off);
    if (lane >= off) {
      v = f ? v : Op::op(ov, v);
      f |= of;
    }
  }
}

// Warp 0: the carry of tile j (the ⊕ from the nearest head before the tile
// to its end), where need_carry; and the level L+1 summaries of the groups
// the tile closes.  (own_f, own_v): the tile's own summary.
template <class Op>
__device__ __forceinline__ float look_back(int j, bool need_carry, int own_f, float own_v,
                                           unsigned long long* __restrict__ status,
                                           int n_tiles, int nl, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  bool acc_set = false;
  int acc_f = 0;
  float acc_v = Op::id();
  bool own_valid = true;  // own: the summary of the level-L entry idx
  int idx = j;
  long long off = 0;      // level L's first word
  int size = n_tiles;     // and its words
  for (int L = 0; L < nl; ++L) {
    const int c = idx & 31;
    const bool write_next = own_valid && c == 31 && L + 1 < nl;
    const bool want = need_carry && !acc_f;
    if (!want && !write_next) break;
    int f = 0;
    float v = Op::id();
    if (lane == c) {
      f = own_f;
      v = own_v;
    } else if (lane < c && (want || !own_f)) {
      wait_word(status + off + (idx - c + lane), epoch, f, v);
    }
    lane_scan<Op, 32>(f, v);
    if (want && c > 0) {
      const int wf = __shfl_sync(FULL, f, c - 1);
      const float wv = __shfl_sync(FULL, v, c - 1);
      acc_v = acc_set ? Op::op(wv, acc_v) : wv;  // acc_f is 0 here
      acc_f = wf;
      acc_set = true;
    }
    if (write_next) {
      own_f = __shfl_sync(FULL, f, 31);
      own_v = __shfl_sync(FULL, v, 31);
      if (lane == 0) publish(status + off + size + (idx >> 5), epoch, own_f, own_v);
    }
    own_valid = write_next;
    idx >>= 5;
    off += size;
    size = (size + 31) >> 5;
  }
  return acc_v;
}

// Each warp moves its SEG elements through a stage in shared memory: the
// global loads and stores are coalesced int4 / float4 (lane l takes the 4
// elements at q·128 + 4l, q < E / 4), and each lane reads or writes its own
// E contiguous elements in the stage.  A lane's row is padded to LD words,
// so a quarter-warp's float4 reads of 8 rows hit 32 distinct banks.
constexpr int SEG = 32 * E;  // elements a warp
constexpr int LD = E + 4;    // words a lane's row takes in the stage

__device__ __forceinline__ int stage_at(int e) { return (e / E) * LD + e % E; }

// The warp's elements [wbase, wbase + SEG) into k and v, lane l holding
// wbase + l·E + [0, E).  Past n: the last key and the identity (they extend
// the last run, change no element before n and are never stored).
template <class Op>
__device__ __forceinline__ void load_warp(const int* __restrict__ keys,
                                          const float* __restrict__ vals, long long wbase,
                                          long long n, int* sk, float* sv, int (&k)[E],
                                          float (&v)[E]) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the stage's reads of the last tile are done
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const int e = q * 128 + lane * 4;
    const long long i = wbase + e;
    int4 kk;
    float4 vv;
    if (i + 4 <= n) {
      kk = *reinterpret_cast<const int4*>(keys + i);
      vv = *reinterpret_cast<const float4*>(vals + i);
    } else {
      int kc[4];
      float vc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kc[c] = keys[i + c < n ? i + c : n - 1];
        vc[c] = i + c < n ? vals[i + c] : Op::id();
      }
      kk = make_int4(kc[0], kc[1], kc[2], kc[3]);
      vv = make_float4(vc[0], vc[1], vc[2], vc[3]);
    }
    *reinterpret_cast<int4*>(sk + stage_at(e)) = kk;
    *reinterpret_cast<float4*>(sv + stage_at(e)) = vv;
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const int4 kk = *reinterpret_cast<const int4*>(sk + lane * LD + 4 * q);
    const float4 vv = *reinterpret_cast<const float4*>(sv + lane * LD + 4 * q);
    k[4 * q] = kk.x, k[4 * q + 1] = kk.y, k[4 * q + 2] = kk.z, k[4 * q + 3] = kk.w;
    v[4 * q] = vv.x, v[4 * q + 1] = vv.y, v[4 * q + 2] = vv.z, v[4 * q + 3] = vv.w;
  }
}

// The warp's results (lane l: v for wbase + l·E + [0, E)) to out, those
// before n.
__device__ __forceinline__ void store_warp(float* __restrict__ out, long long wbase, long long n,
                                           float* sv, const float (&v)[E]) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // every lane has read its values out of the stage
#pragma unroll
  for (int q = 0; q < E / 4; ++q)
    *reinterpret_cast<float4*>(sv + lane * LD + 4 * q) =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const int e = q * 128 + lane * 4;
    const long long i = wbase + e;
    const float4 x = *reinterpret_cast<const float4*>(sv + stage_at(e));
    if (i + 4 <= n) {
      *reinterpret_cast<float4*>(out + i) = x;
    } else {
      const float xc[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (i + c < n) out[i + c] = xc[c];
    }
  }
}

template <class Op>
__global__ void __launch_bounds__(THREADS)
    segment_scan_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                        float* __restrict__ out, long long n, int n_tiles, int nl,
                        unsigned long long* __restrict__ status, unsigned epoch) {
  __shared__ __align__(16) int stage_k[WARPS][32 * LD];
  __shared__ __align__(16) float stage_v[WARPS][32 * LD];
  __shared__ int last_key[WARPS];
  __shared__ int wf[WARPS];
  __shared__ float wv[WARPS];
  __shared__ float carry;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int j = blockIdx.x; j < n_tiles; j += gridDim.x) {
    const long long wbase = (long long)j * TILE + (long long)warp * SEG;
    const long long base = wbase + (long long)lane * E;
    int k[E];
    float v[E];
    load_warp<Op>(keys, vals, wbase, n, stage_k[warp], stage_v[warp], k, v);
    // the key before each thread's first element
    if (lane == 31) last_key[warp] = k[E - 1];
    int before = __shfl_up_sync(FULL, k[E - 1], 1);
    if (t == 0 && j > 0) before = keys[base - 1];
    __syncthreads();
    if (lane == 0 && warp > 0) before = last_key[warp - 1];

    // 1. serial scan of the thread's elements
    unsigned heads = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool h = e == 0 ? (base == 0 || k[0] != before) : k[e] != k[e - 1];
      heads |= (unsigned)h << e;
      if (e > 0 && !h) v[e] = Op::op(v[e - 1], v[e]);
    }
    // 2. the warp's thread totals, then the block's warp totals
    int f = heads != 0;
    float tv = v[E - 1];
    lane_scan<Op, 32>(f, tv);
    if (lane == 31) {
      wf[warp] = f;
      wv[warp] = tv;
    }
    const int ef = __shfl_up_sync(FULL, f, 1);
    const float ev = __shfl_up_sync(FULL, tv, 1);
    __syncthreads();
    int own_f = 0;
    float own_v = 0.f;
    if (warp == 0) {
      int bf = lane < WARPS ? wf[lane] : 0;
      float bv = lane < WARPS ? wv[lane] : Op::id();
      lane_scan<Op, WARPS>(bf, bv);
      if (lane < WARPS) {
        wf[lane] = bf;  // inclusive over warps 0..lane
        wv[lane] = bv;
      }
      // 3. the tile's summary, published before anything waits
      if (lane == WARPS - 1) publish(status + j, epoch, bf, bv);
      own_f = __shfl_sync(FULL, bf, WARPS - 1);
      own_v = __shfl_sync(FULL, bv, WARPS - 1);
    }
    __syncthreads();
    // the thread's exclusive prefix within the tile: (pf: holds a head, pv)
    int pf;
    float pv;
    bool pre;
    if (lane == 0) {
      pre = warp > 0;
      pf = warp > 0 ? wf[warp - 1] : 0;
      pv = warp > 0 ? wv[warp - 1] : Op::id();
    } else {
      pre = true;
      pf = ef | (warp > 0 ? wf[warp - 1] : 0);
      pv = (warp > 0 && !ef) ? Op::op(wv[warp - 1], ev) : ev;
    }
    const int first = heads ? __ffs(heads) - 1 : E;  // elements before the thread's first head
    if (pre) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e < first) v[e] = Op::op(pv, v[e]);
    }
    // the tile's leading run waits for the carry; a warp without any of it
    // is final and is stored now
    const bool lead = j > 0 && !pf && first > 0;
    const bool lead_warp = __any_sync(FULL, lead);
    if (!lead_warp) store_warp(out, wbase, n, stage_v[warp], v);
    // 4. look-back
    if (warp == 0) {
      const bool need_carry = j > 0 && !(__shfl_sync(FULL, heads, 0) & 1u);
      const float c = look_back<Op>(j, need_carry, own_f, own_v, status, n_tiles, nl, epoch);
      if (lane == 0) carry = c;
    }
    __syncthreads();
    // 5. the leading run
    if (lead_warp) {
      if (lead) {
        const float c = carry;
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (e < first) v[e] = Op::op(c, v[e]);
      }
      store_warp(out, wbase, n, stage_v[warp], v);
    }
    // no barrier needed here: the next tile writes last_key before its first
    // barrier and wf/wv/carry after it, and every read of this tile's
    // shared words comes before the barrier above (the stage is the warp's
    // own, ordered by __syncwarp)
  }
}

// Levels of status words for n_tiles tiles: the fewest nl with n_tiles <=
// 32^nl; level L holds ceil(n_tiles / 32^L) words.  Returns the words, or
// -1 beyond MAX_LEVELS.
long long levels_of(int n_tiles, int& nl) {
  long long words = 0, size = n_tiles;
  for (nl = 1;; ++nl) {
    if (nl > MAX_LEVELS) return -1;
    words += size;
    if (size <= 32) return words;
    size = (size + 31) / 32;
  }
}

template <class Op>
int launch_op(const int* keys, const float* vals, float* out, long long n,
              unsigned long long* status, long long words, unsigned epoch,
              cudaStream_t stream) {
  const long long tiles = (n + TILE - 1) / TILE;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  int nl = 0;
  const long long need = levels_of((int)tiles, nl);
  if (need < 0 || words < need) return (int)cudaErrorInvalidValue;
  // resident blocks on this device: the persistent grid's size
  static int resident[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, occ = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, segment_scan_kernel<Op>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = sms * occ;
  }
  const int grid = (int)(tiles < resident[dev] ? tiles : resident[dev]);
  segment_scan_kernel<Op><<<grid, THREADS, 0, stream>>>(keys, vals, out, n, (int)tiles, nl,
                                                         status, epoch);
  return (int)cudaGetLastError();
}

}  // namespace

// Status words a call on n elements needs (uint64).
extern "C" long long segment_scan_scratch_words(long long n) {
  const long long tiles = (n + TILE - 1) / TILE;
  if (n <= 0) return 0;
  if (tiles > INT_MAX) return -1;
  int nl = 0;
  return levels_of((int)tiles, nl);
}

// combine 0: sum, 1: min, 2: max.  keys int32 [n], vals fp32 [n], out fp32
// [n], all 16-byte aligned; scratch: `words` uint64 status words (at least
// segment_scan_scratch_words(n)), each 0 or written by an earlier call of
// this entry; epoch in [1, 2^31 - 1], that of no earlier call since the
// scratch was zeroed.
extern "C" int segment_scan_launch(int combine, const void* keys, const void* vals, void* out,
                                   long long n, void* scratch, long long words,
                                   unsigned epoch, void* stream) {
  if (n <= 0) return 0;
  if (epoch == 0 || epoch >= (1u << 31)) return (int)cudaErrorInvalidValue;
  const int* k = static_cast<const int*>(keys);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  unsigned long long* s = static_cast<unsigned long long*>(scratch);
  cudaStream_t st = (cudaStream_t)stream;
  switch (combine) {
    case 0: return launch_op<Sum>(k, v, o, n, s, words, epoch, st);
    case 1: return launch_op<Min>(k, v, o, n, s, words, epoch, st);
    case 2: return launch_op<Max>(k, v, o, n, s, words, epoch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
