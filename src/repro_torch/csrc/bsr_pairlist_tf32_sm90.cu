// (+, ×) on the tensor cores: bsr_pairlist and bsr_pairlist_reduce under
// PLUS_TIMES as three TF32 wgmma passes, split inside the kernel, for Hopper.
//
// Replace the (+, ×) branch of bsr_pairlist_pallas and
// bsr_pairlist_reduce_pallas (src/repro/kernels/bsr_spgemm/pairlist.py),
// which send (+, ×) to the TPU's matrix unit (jnp.dot when sr.mxu).  The
// other five semirings take the CUDA-core ring (bsr_pairlist.cu).
//
// For each item (pairlist_items.cuh: an output tile's run of pairs, or for
// the reduce a chunk of at most `chunk` pairs of an output block's run):
// C = Σ_p A[pair_a[p]] · B[pair_b[p]] over 128x128 fp32 tiles.
//
// Bound on an H100: operations.  Three TF32 products, 3 · 2·128^3 a pair
// over 495 TFLOP/s, against 2·128^3 over 67 TFLOP/s for one fp32 product on
// the CUDA cores (2.5x as long).  The tiles are read once from HBM (the
// pairs reuse them through L2), so bytes bound only the short-run product.
//
// No split pass.  A separate pass writing hi/lo copies would more than
// double the bytes (41,043 tiles read and written once at n=18: 2.69 GB;
// with split copies written and read back 6.84 GB, as long as the fp32
// bound), so the fp32 tiles are read once and split on chip:
//   * wgmma takes .tf32 operands K-major only, and a B tile is N-major, so
//     the kernel computes C^T = B^T · A^T.  B^T is wgmma's register
//     operand: each consumer thread loads its fragment (4 values a k8 step)
//     straight from the fp32 B slab in shared memory (rows padded to 136
//     floats: the 32 lanes hit 32 banks) and splits it in registers
//     (tf32_sm90.cuh: cvt.rna.tf32's rounding in integer operations).  A^T is the shared-memory operand, K-major as the A tile
//     already lies: TMA brings A's 128 x 32 slab with the 128-byte swizzle,
//     and two split warps round it to hi in place and write lo beside it,
//     element by element, so the swizzle holds.  (A transform warpgroup
//     that writes B^T hi/lo would move 32 KB more through shared memory a
//     slab, on a kernel whose wgmma operand reads already take half of it.)
//   * Per k8 step B_hi^T·A_lo^T and B_lo^T·A_hi^T, then B_hi^T·A_hi^T; hi is
//     rounded (wgmma drops a 32-bit operand's low 13 bits, which would
//     truncate).  A slab's 12 products go into a fresh register sum d; once
//     they have retired, the CUDA cores add d to the accumulator rounded to
//     nearest (the tensor cores' sums may truncate, and each small lo
//     product would cost one long sum up to an ulp).
//   * The split marks each row of A (split warps, in shared memory, per
//     item) and column of B (consumer threads, in registers) that holds a
//     value that is not finite or exceeds 2^62; the epilogue recomputes an
//     output on a marked row or column in fp32 FMA, in k order over the
//     item's pairs, so ±inf, NaN and overflow follow IEEE as in the plain
//     version (an inf times a lo part of 0 would give NaN in the split).
//
// Block: 352 threads, one block an SM, persistent over the items (block b
// takes items b, b + grid, ...; runs of 1-4 pairs at n=18 make a tile's
// epilogue a large share of its life, and here the next item's loads and
// splits run under it).  Warps 0-7 are two consumer warpgroups, 64 rows of
// C^T (columns of C) each; warp 8 is the producer: lane 0 TMA-loads the A
// slab, the 32 lanes bulk-copy B's 32 rows of 512 bytes, into a 4-stage
// ring with full / ready / empty mbarriers; warps 9-10 split (thread r
// owns A rows r and r + 64).  No setmaxnreg (ptxas would not give the
// consumers more): a 352-thread block gets 168 registers a thread, which
// hold the consumers' 64 accumulators, 64 slab sums and two k8 steps'
// fragments.
//
// Epilogue.  bsr_pairlist stores C (the accumulator transposed back: each
// warp store covers four 32-byte rows segments).  bsr_pairlist_reduce folds
// it over columns (axis 1: a row of C^T per thread pair, then across
// lanes and the 8 consumer warps through shared memory) or rows (axis 0:
// within the thread, then the quad) into the item's [128] partial;
// fold_chunks adds each output's partials in item order.
//
// Accuracy.  The TF32 product of semiring_tf32_sm90.cu with K = 128 x (the
// item's pairs): |C - A·B| <= (52 · 2^-22 + ceil(K/32) · 2^-24) · Σ_p
// |A_p|·|B_p| element-wise, for bsr_pairlist (its runs are one item each).
// The reduce adds the fold's fp32 sums: at most 2^-23 · 128 · Σ|C| over the
// folded 128 outputs (a sum of n terms in fp32 errs by at most (n - 1) ·
// 2^-24 of the sum of their magnitudes), and the fold of the chunk
// partials at most (chunks - 1) · 2^-24 of their magnitude sum.  Exact
// wherever every input is a TF32 value and every partial sum fits in 24
// bits: the main path's 1.0 values and the kernel checks' quarter values.
#include "pairlist_items.cuh"
#include "tf32_sm90.cuh"

namespace {

using namespace sm90;
using pairs::TILE;
using pairs::TILE_ELEMS;

constexpr int BK = 32;                       // k slab
constexpr int SUBS = TILE / BK;              // slabs a pair
constexpr int STAGES = 4;  // at most a pair's slabs: the row flags' double buffer relies on it
constexpr int PRODUCER_WARP = 8;
constexpr int SPLIT0 = 288;                  // warps 9-10
constexpr int SPLITTERS = 64;
constexpr int THREADS = 352;
constexpr int B_LD = TILE + 8;               // padded B row, floats
constexpr int A_BYTES = TILE * BK * 4;       // 128 x 32 fp32: 16 KB
constexpr int B_ROW_BYTES = TILE * 4;        // one B row: 512 bytes
constexpr int STAGE_BYTES = 2 * A_BYTES + BK * B_LD * 4;  // A_hi, A_lo, B
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int FLAG_OFF = BAR_OFF + 3 * 8 * STAGES;  // full, ready, empty
constexpr int RED_OFF = FLAG_OFF + 2 * 4 * 4;       // row flags [2][4] words
constexpr int SMEM_BYTES = RED_OFF + 8 * TILE * 4 + 1024;  // + slack to align the base
static_assert(STAGE_BYTES % 1024 == 0, "stages must keep the 128 B swizzle's 1 KB alignment");
static_assert(SMEM_BYTES <= 232448, "shared memory");

struct Args {
  const float* a_tiles;
  const float* b_tiles;
  const int* pair_a;
  const int* pair_b;
  pairs::Items items;
  float* out;  // C tiles [n_c, 128, 128], or the partials [items, 128]
  int axis;
};

// -- producer: warp 8 ---------------------------------------------------------------

__device__ __forceinline__ void produce(const CUtensorMap* a_map, const Args& p, uint32_t base,
                                        uint32_t full, uint32_t empty, int n_items) {
  const int lane = threadIdx.x & 31;
  int x = 0;  // slabs issued
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    int p0, p1;
    p.items.range(i, p0, p1);
    for (int q = p0; q < p1; ++q) {
      const int pa = p.pair_a[q];
      const float* bt = p.b_tiles + p.pair_b[q] * TILE_ELEMS;
      for (int sub = 0; sub < SUBS; ++sub, ++x) {
        const int s = x % STAGES;
        const uint32_t st = base + s * STAGE_BYTES;
        mbar_wait(empty + 8 * s, ((x / STAGES) & 1) ^ 1);  // the first round passes
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, A_BYTES + BK * B_ROW_BYTES);
          tma_load(st, a_map, full + 8 * s, sub * BK, pa * TILE);
        }
        __syncwarp();
        bulk_load(st + 2 * A_BYTES + lane * B_LD * 4, bt + (sub * BK + lane) * TILE,
                  B_ROW_BYTES, full + 8 * s);
      }
    }
  }
}

// -- split: warps 9-10 ------------------------------------------------------------

// row r of the stage's A slab (128 bytes, its 16-byte chunks in swizzled
// order, which an element-wise split keeps): hi in place, lo beside it.
// Thread r starts at chunk r % 8, so 8 neighbouring rows hit 8 distinct
// bank groups.  True where the row holds a value for the exact path.
__device__ __forceinline__ bool split_row(unsigned char* st, int r) {
  float4* hi = reinterpret_cast<float4*>(st + r * 128);
  float4* lo = reinterpret_cast<float4*>(st + A_BYTES + r * 128);
  bool bad = false;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int j = (c + r) & 7;
    const float4 v = hi[j];
    float4 h, l;
    bad |= split(v.x, h.x, l.x) | split(v.y, h.y, l.y) | split(v.z, h.z, l.z) |
           split(v.w, h.w, l.w);
    hi[j] = h;
    lo[j] = l;
  }
  return bad;
}

__device__ __forceinline__ void split_stage(const Args& p, unsigned char* sbase, uint32_t full,
                                            uint32_t ready, uint32_t* rowflag, int n_items) {
  const int r = threadIdx.x - SPLIT0;  // rows r and r + 64
  const int w = r >> 5, lane = threadIdx.x & 31;
  int x = 0, q = 0;  // slabs split, items with pairs
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    int p0, p1;
    p.items.range(i, p0, p1);
    const int n = (p1 - p0) * SUBS;
    if (n == 0) continue;
    bool bad0 = false, bad1 = false;
    for (int t = 0; t < n; ++t, ++x) {
      const int s = x % STAGES;
      unsigned char* st = sbase + s * STAGE_BYTES;
      mbar_wait(full + 8 * s, (x / STAGES) & 1);
      bad0 |= split_row(st, r);
      bad1 |= split_row(st, r + 64);
      if (t == n - 1) {
        // the item's row flags, one bit a row: word k holds rows 32k..32k+31.
        // The consumers read them after this stage's ready barrier; the
        // other slot is the previous item's, which they may still read.
        const unsigned b0 = __ballot_sync(FULL, bad0), b1 = __ballot_sync(FULL, bad1);
        if (lane == 0) {
          rowflag[(q & 1) * 4 + w] = b0;
          rowflag[(q & 1) * 4 + 2 + w] = b1;
        }
      }
      fence_proxy_async();
      mbar_arrive(ready + 8 * s);
    }
    ++q;
  }
}

// -- consumers: warps 0-7 ---------------------------------------------------------

// ⊕ over the item's pairs and k, in order, in fp32 FMA: the plain
// version's arithmetic for an output whose inputs the split cannot carry
__device__ float exact_dot(const Args& p, int p0, int p1, int m, int n) {
  float s = 0.f;
  for (int q = p0; q < p1; ++q) {
    const float* ar = p.a_tiles + p.pair_a[q] * TILE_ELEMS + m * TILE;
    const float* bc = p.b_tiles + p.pair_b[q] * TILE_ELEMS + n;
    for (int k = 0; k < TILE; ++k) s = fmaf(ar[k], bc[k * TILE], s);
  }
  return s;
}

// keep the fragment registers alive (and in place) until the wgmma that
// reads them has retired
__device__ __forceinline__ void fence_frag(uint32_t (&f)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f[e])::"memory");
}

template <bool REDUCE>
__device__ __forceinline__ void consume(const Args& p, uint32_t base, const unsigned char* sbase,
                                        uint32_t full, uint32_t ready, uint32_t empty,
                                        const uint32_t* rowflag, float* red, int n_items) {
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, qd = lane & 3;
  // this thread's rows of C^T (columns of C): n0 and n0 + 8.  acc[4j + e]
  // is C^T[n0 + 8·(e >> 1)][8j + 2·qd + (e & 1)]
  const int n0 = wg * 64 + warp * 16 + g;
  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  int x = 0, q = 0;  // slabs consumed, items with pairs
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    int n;  // the item's slabs
    {
      int p0, p1;
      p.items.range(i, p0, p1);
      n = (p1 - p0) * SUBS;
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    bool cb0 = false, cb1 = false;  // columns n0, n0 + 8 of B need the exact path
    for (int it = 0; it < n; ++it, ++x) {
      const int s = x % STAGES;
      const uint32_t st = base + s * STAGE_BYTES;
      const float* bs = reinterpret_cast<const float*>(sbase + s * STAGE_BYTES + 2 * A_BYTES);
      mbar_wait(full + 8 * s, (x / STAGES) & 1);   // B landed
      mbar_wait(ready + 8 * s, (x / STAGES) & 1);  // A split
      uint32_t fh[2][4], fl[2][4];
      fence_regs(d);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const int b = kk & 1;
        // B^T[n][k] = B[k][n]: (n0, qd), (n0 + 8, qd), (n0, qd + 4), (n0 + 8, qd + 4)
        const float* bk = bs + (kk * 8 + qd) * B_LD + n0;
        const float v[4] = {bk[0], bk[8], bk[4 * B_LD], bk[4 * B_LD + 8]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float h, l;
          const bool bad = split(v[e], h, l);
          if (e & 1)
            cb1 |= bad;
          else
            cb0 |= bad;
          fh[b][e] = __float_as_uint(h);
          fl[b][e] = __float_as_uint(l);
        }
        wgmma_fence();
        const uint64_t dh = sw128_desc(st + kk * 32);  // 32 bytes a k8 step in the swizzled row
        const uint64_t dl = sw128_desc(st + A_BYTES + kk * 32);
        wgmma_tf32_rs(d, fh[b], dl, kk > 0);  // the slab's first product starts d afresh
        wgmma_tf32_rs(d, fl[b], dh, 1);
        wgmma_tf32_rs(d, fh[b], dh, 1);
        wgmma_commit();
        if (kk > 0) {
          wgmma_wait<1>();  // step kk - 1 has retired: its fragments are free
          fence_frag(fh[b ^ 1]);
          fence_frag(fl[b ^ 1]);
        }
      }
      wgmma_wait<0>();
      fence_frag(fh[1]);
      fence_frag(fl[1]);
      fence_regs(d);
      if (t == 0) mbar_arrive(empty + 8 * s);  // this warpgroup is done with the stage
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += d[e];  // rounded to nearest, on the CUDA cores
    }

    // the exact path for outputs on a marked row of A or column of B
    if (n > 0) {
      const uint32_t* rf = rowflag + (q & 1) * 4;
      const uint32_t r0 = rf[0], r1 = rf[1], r2 = rf[2], r3 = rf[3];
      cb0 |= __shfl_xor_sync(FULL, (int)cb0, 1);  // the quad saw all k of its columns
      cb1 |= __shfl_xor_sync(FULL, (int)cb1, 1);
      cb0 |= __shfl_xor_sync(FULL, (int)cb0, 2);
      cb1 |= __shfl_xor_sync(FULL, (int)cb1, 2);
      if (__any_sync(FULL, (r0 | r1 | r2 | r3) != 0 || cb0 || cb1)) {
        const uint32_t rows[4] = {r0, r1, r2, r3};
        int p0, p1;  // read again here, not held through the mainloop
        p.items.range(i, p0, p1);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = 8 * j + 2 * qd + (e & 1);  // in rows[j / 4]: 8j..8j+7 share a word
            if (((rows[j >> 2] >> (m & 31)) & 1) || (e < 2 ? cb0 : cb1))
              acc[4 * j + e] = exact_dot(p, p0, p1, m, n0 + 8 * (e >> 1));
          }
      }
      ++q;
    }

    if (!REDUCE) {
      // the address is made here: held through the mainloop, it spilled
      int off = n0 + 2 * qd * TILE;
      asm volatile("" : "+r"(off));
      float* c = p.out + i * TILE_ELEMS + off;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[(8 * j + (e & 1)) * TILE + 8 * (e >> 1)] = acc[4 * j + e];
      continue;
    }
    float* part = p.out + (long long)i * TILE;
    if (p.axis == 0) {
      // a column n of C: its 128 rows m, 32 in each thread of the quad
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        v0 += acc[4 * j] + acc[4 * j + 1];
        v1 += acc[4 * j + 2] + acc[4 * j + 3];
      }
      v0 += __shfl_xor_sync(FULL, v0, 1);
      v1 += __shfl_xor_sync(FULL, v1, 1);
      v0 += __shfl_xor_sync(FULL, v0, 2);
      v1 += __shfl_xor_sync(FULL, v1, 2);
      if (qd == 0) {
        part[n0] = v0;
        part[n0 + 8] = v1;
      }
      continue;
    }
    // axis 1: a row m of C: its 128 columns n, 2 in each thread, 16 in a
    // warp (its 8 lanes of one qd), then the 8 consumer warps through
    // shared memory
    const int w8 = wg * 4 + warp;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = acc[4 * j + e] + acc[4 * j + 2 + e];
        v += __shfl_xor_sync(FULL, v, 4);
        v += __shfl_xor_sync(FULL, v, 8);
        v += __shfl_xor_sync(FULL, v, 16);
        if (lane < 4) red[w8 * TILE + 8 * j + 2 * qd + e] = v;
      }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the two consumer warpgroups
    if (threadIdx.x < TILE) {
      float v = red[threadIdx.x];
#pragma unroll
      for (int k = 1; k < 8; ++k) v += red[k * TILE + threadIdx.x];
      part[threadIdx.x] = v;
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // red is free for the next item
  }
}

template <bool REDUCE>
__global__ void __launch_bounds__(THREADS, 1)
    pair_tf32_kernel(const __grid_constant__ CUtensorMap a_map, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128 B swizzle atoms
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t full = base + BAR_OFF, ready = full + 8 * STAGES, empty = ready + 8 * STAGES;
  uint32_t* rowflag = reinterpret_cast<uint32_t*>(sbase + FLAG_OFF);
  float* red = reinterpret_cast<float*>(sbase + RED_OFF);
  const int n_items = p.items.count();
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);            // the producer's expect_tx, then the bytes
      mbar_init(ready + 8 * s, SPLITTERS);   // every split thread
      mbar_init(empty + 8 * s, 2);           // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= SPLIT0) {
    split_stage(p, sbase, full, ready, rowflag, n_items);
  } else if (threadIdx.x >= PRODUCER_WARP * 32) {
    produce(&a_map, p, base, full, empty, n_items);
  } else {
    consume<REDUCE>(p, base, sbase, full, ready, empty, rowflag, red, n_items);
  }
}

template <bool REDUCE>
int run(const Args& p, int n_a, int max_items, cudaStream_t stream) {
  CUtensorMap a_map;  // the A tiles as one [n_a·128, 128] array: 128 x 32 boxes
  if (!make_map_k32(&a_map, p.a_tiles, (long long)n_a * TILE, TILE))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(pair_tf32_kernel<REDUCE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int grid = max_items < sms ? max_items : sms;
  pair_tf32_kernel<REDUCE><<<grid, THREADS, SMEM_BYTES, stream>>>(a_map, p);
  return (int)cudaGetLastError();
}

}  // namespace

// As bsr_pairlist_launch under PLUS_TIMES: a_tiles [n_a,128,128], b_tiles
// [nB,128,128], c_tiles [n_c,128,128] fp32; pair_a, pair_b int32 [P]; runs
// int32 [n_c + 1].
extern "C" int bsr_pairlist_tf32_launch(const void* a_tiles, const void* b_tiles,
                                        const void* pair_a, const void* pair_b, const void* runs,
                                        void* c_tiles, int n_a, int n_c, void* stream) {
  if (n_c <= 0) return 0;
  if (n_a <= 0) return (int)cudaErrorInvalidValue;
  const Args p{(const float*)a_tiles, (const float*)b_tiles, (const int*)pair_a,
               (const int*)pair_b,   {(const int*)runs, nullptr, n_c, 0},
               (float*)c_tiles,      1};
  return run<false>(p, n_a, n_c, (cudaStream_t)stream);
}

// As bsr_pairlist_reduce_launch under PLUS_TIMES (chunk_off, part, out as
// there).
extern "C" int bsr_pairlist_reduce_tf32_launch(const void* a_tiles, const void* b_tiles,
                                               const void* pair_a, const void* pair_b,
                                               const void* runs, const void* chunk_off,
                                               void* part, void* out, int n_a, int n_o,
                                               int max_items, int chunk, int axis,
                                               void* stream) {
  if (n_o <= 0) return 0;
  if (n_a <= 0 || max_items < n_o || chunk <= 0 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const Args p{(const float*)a_tiles, (const float*)b_tiles, (const int*)pair_a,
               (const int*)pair_b,   {(const int*)runs, (const int*)chunk_off, n_o, chunk},
               (float*)part,         axis};
  const int e = run<true>(p, n_a, max_items, (cudaStream_t)stream);
  if (e != 0) return e;
  pairs::fold_chunks<PlusTimes><<<n_o, TILE, 0, (cudaStream_t)stream>>>(
      (const float*)part, (const int*)chunk_off, (float*)out);
  return (int)cudaGetLastError();
}
