// (+, ×) on the tensor cores: semiring_matmul, bsr_spgemm and
// bsr_spgemm_reduce under PLUS_TIMES as three TF32 wgmma passes ("3xTF32"),
// for Hopper.
//
// Replace the (+, ×) branch of semiring_matmul_pallas
// (src/repro/kernels/semiring_matmul/semiring_matmul.py) and of
// bsr_spgemm_pallas and bsr_spgemm_reduce_pallas
// (src/repro/kernels/bsr_spgemm/bsr_spgemm.py), which send (+, ×) to the
// TPU's matrix unit (jnp.dot when sr.mxu).  The other five semirings take
// the CUDA-core ring (semiring_gemm_sm90.cuh).
//
// Bound on an H100: operations.  Three TF32 products, 3 · 2MNK over 495
// TFLOP/s (0.833 ms at 4096^3), against 2MNK over 67 TFLOP/s (2.05 ms)
// for one fp32 product on the CUDA cores.
//
// Split pass.  x = hi + lo + d with hi = x and lo = x - hi (exact in
// fp32) each rounded to TF32 as cvt.rna.tf32 rounds (tf32_sm90.cuh: split).
// wgmma ignores the low 13 bits of a 32-bit operand, so hi is rounded
// here; a raw fp32 would be truncated.  A keeps its [M, K] layout; B is written transposed as
// B_hi^T and B_lo^T [N, K] through a 32 x 32 shared-memory tile, because
// wgmma takes .tf32 operands K-major only (the transpose bits exist for
// 16-bit types alone).  The same pass flags every row of A and column of B
// that holds an entry that is not finite or exceeds 2^62 in magnitude.
// For a block-masked A (int32 [M/128, K/128]) the pass skips A's absent
// tiles: they are never read again.
//
// Mainloop.  One 384-thread block owns one 128 x 128 output tile.
// Warpgroup 2's first thread is the producer: it walks the k slabs (32
// deep; under a block mask only the present 128-wide k tiles of the
// block-row, a skip that is uniform across the block) and TMA-loads
// A_hi, A_lo, B_hi^T and B_lo^T (16 KB each, 128-byte swizzle: a 32-column
// fp32 box is one 128-byte swizzle row) into a 3-stage ring with a full
// and an empty mbarrier per stage.  Warpgroups 0 and 1 own 64 rows each
// and run wgmma m64n128k8 f32.tf32.tf32 from shared memory: per k8 step
// A_lo·B_hi and A_hi·B_lo before A_hi·B_hi; the descriptors advance 32
// bytes per k8 step inside the swizzled row.  The tensor cores' fp32 sums
// may truncate, and the small lo products would each cost the long sum up
// to an ulp: so a slab's 12 products go into a fresh register sum d, and
// once they have retired (the stage's empty barrier is released then) d is
// added to the accumulator on the CUDA cores, rounded to nearest.  The two
// consumer warpgroups take turns on the tensor cores while one adds.
//
// Epilogue.  An output whose row of A or column of B was flagged is
// recomputed exactly in fp32 FMA over its k (its present k tiles), in k
// order, so ±inf, NaN and overflow follow IEEE as in the plain version:
// an inf times a lo part of 0 would give NaN in the split product.
// The caller picks the epilogue, the mask pointer the walk: semiring_matmul
// (no mask) and bsr_spgemm (masked) store the tile; bsr_spgemm_reduce
// folds it over columns (axis 1: within the thread, then across the quad)
// or rows (axis 0: within the thread, across the warp's lanes by shuffles,
// then across the 8 warps through shared memory) and writes the partials
// [N/128, M] or [M/128, N], one per block, as the CUDA-core kernel does.
//
// Accuracy (derivation in PERF.md § Findings).  With u = 2^-11, |x - hi| <= u|x|
// and the part that lo drops, e = x - hi - lo, |e| <= u^2 |x|; the dropped
// terms of a·b are hi_a·e_b + e_a·hi_b + (a - hi_a)(b - hi_b), at most
// 3(1 + u)u^2 |a||b| <= 4 · 2^-22 |a||b|, and every tf32 x tf32 product is
// exact in fp32.  A slab's sum takes 96 additions, each taken as
// truncating (2^-23 of at most Σ|terms| <= (1 + 4u)|A_s|·|B_s|): 48.1 ·
// 2^-22 |A_s|·|B_s|.  The ceil(K/32) slab sums add in round-to-nearest
// (2^-24 each).  Element-wise:
//   |C - A·B| <= (52 · 2^-22 + ceil(K/32) · 2^-24) · (|A|·|B|),
// with K = 128 x (the block-row's present k tiles) and A's absent tiles
// zeroed under a block mask (an empty block-row gives exactly 0).
// The result is exact wherever every input is a TF32 value (lo = 0) and
// every partial sum fits in 24 bits: the D4M workloads' integers 1..100 and
// the kernel checks' multiples of 1/4 in [1/4, 2].
#include "semiring_gemm_sm90.cuh"  // ring::Slabs: the walk over present k slabs
#include "tf32_sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 384;
constexpr int KTILE = 128;                  // mask granularity along K
constexpr int TILE_BYTES = BM * BK * 4;     // one 128 x 32 fp32 box: 16 KB
constexpr int STAGE_BYTES = 4 * TILE_BYTES;  // A_hi, A_lo, B_hi^T, B_lo^T
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int RED_OFF = BAR_OFF + 16 * STAGES;  // full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = RED_OFF + 8 * BN * 4 + 1024;  // + slack to align the base

// -- split pass ---------------------------------------------------------------

// A [M, K] -> hi, lo [M, K]; flag[row] = 1 where the row needs the exact
// path.  With a mask (int32 [M/128, K/128]) absent tiles are skipped.
__global__ void split_rows(const float4* __restrict__ a, float4* __restrict__ hi,
                           float4* __restrict__ lo, int* __restrict__ flag,
                           const int* __restrict__ mask, long long n4, int k) {
  const int k4 = k / 4;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < n4;
       q += (long long)gridDim.x * blockDim.x) {
    const long long row = q / k4;
    if (mask != nullptr && mask[(row / KTILE) * (k / KTILE) + (q % k4) * 4 / KTILE] == 0)
      continue;
    const float4 v = a[q];
    float4 h, l;
    const bool bad = split(v.x, h.x, l.x) | split(v.y, h.y, l.y) | split(v.z, h.z, l.z) |
                     split(v.w, h.w, l.w);
    hi[q] = h;
    lo[q] = l;
    if (bad) flag[row] = 1;
  }
}

// B [K, N] -> hi^T, lo^T [N, K] through a 32 x 33 tile; flag[col] = 1
// where the column needs the exact path.  Block (32, 8), grid (N/32, K/32).
__global__ void split_cols_t(const float* __restrict__ b, float* __restrict__ hi,
                             float* __restrict__ lo, int* __restrict__ flag, int k, int n) {
  __shared__ float th[32][33], tl[32][33];
  __shared__ int tf[32];
  const int c0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (ty == 0) tf[tx] = 0;
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {  // row k0 + r, column c0 + tx
    float h, l;
    if (split(b[(long long)(k0 + r) * n + c0 + tx], h, l)) tf[tx] = 1;
    th[r][tx] = h;
    tl[r][tx] = l;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {  // row c0 + r of the transpose, column k0 + tx
    const long long o = (long long)(c0 + r) * k + k0 + tx;
    hi[o] = th[tx][r];
    lo[o] = tl[tx][r];
  }
  if (ty == 0 && tf[tx]) flag[c0 + tx] = 1;
}

// -- the product --------------------------------------------------------------

struct Maps {
  CUtensorMap a_hi, a_lo, b_hi, b_lo;  // [M, K] and [N, K] tf32 in fp32 containers
};

struct Args {
  const float* a;  // the original A [M, K] and B [K, N], for the exact path
  const float* b;
  const int* mask;  // int32 [M/128, K/128], or null: every k slab
  const int* row_flag;
  const int* col_flag;
  float* out;  // C [M, N], or the partials
  int m, n, k, axis;
};

__device__ __forceinline__ ring::Slabs slabs_of(const Args& p, int bi) {
  return ring::Slabs(p.mask ? p.mask + (long long)bi * (p.k / KTILE) : nullptr, p.k);
}

// ⊕ over the k that the mask keeps, in k order, in fp32 FMA: the plain
// version's arithmetic for an output whose inputs the split cannot carry
__device__ float exact_dot(const Args& p, int row, int col) {
  const float* ar = p.a + (long long)row * p.k;
  const int* mrow = p.mask ? p.mask + (long long)(row / BM) * (p.k / KTILE) : nullptr;
  float s = 0.f;
  for (int k = 0; k < p.k; ++k) {
    if (mrow != nullptr && mrow[k / KTILE] == 0) {
      k += KTILE - 1;
      continue;
    }
    s = fmaf(ar[k], p.b[(long long)k * p.n + col], s);
  }
  return s;
}

template <bool REDUCE>
__global__ void __launch_bounds__(THREADS, 1)
    tf32x3_kernel(const __grid_constant__ Maps maps, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 128 B swizzle atoms
  float* red = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + RED_OFF);
  const uint32_t full = base + BAR_OFF, empty = full + 8 * STAGES;
  const int bi = blockIdx.y, bj = blockIdx.x;
  const int n_slabs = slabs_of(p, bi).count();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      ring::Slabs sl = slabs_of(p, bi);
      for (int t = 0; t < n_slabs; ++t, sl.next()) {
        const int s = t % STAGES;
        const uint32_t st = base + s * STAGE_BYTES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        const int k0 = (int)sl.k0();
        tma_load(st, &maps.a_hi, full + 8 * s, k0, bi * BM);
        tma_load(st + TILE_BYTES, &maps.a_lo, full + 8 * s, k0, bi * BM);
        tma_load(st + 2 * TILE_BYTES, &maps.b_hi, full + 8 * s, k0, bj * BN);
        tma_load(st + 3 * TILE_BYTES, &maps.b_lo, full + 8 * s, k0, bj * BN);
      }
    }
    return;
  }

  // consumers: 64 rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, qd = lane & 3;
  float acc[64];  // acc[4j + e]: row r0 (e < 2) or r0 + 8, column 8j + 2·qd + (e & 1)
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t a_off = wg * 64 * 128;  // this warpgroup's 64 rows: 8 KB into each A box
  float d[64];  // this slab's sum, in the accumulator layout
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int it = 0; it < n_slabs; ++it) {
    const int s = it % STAGES;
    const uint32_t st = base + s * STAGE_BYTES;
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {  // k8 steps: 32 bytes into the swizzled row
      const uint32_t off = kk * 32;
      const uint64_t ah = sw128_desc(st + a_off + off);
      const uint64_t al = sw128_desc(st + TILE_BYTES + a_off + off);
      const uint64_t bh = sw128_desc(st + 2 * TILE_BYTES + off);
      const uint64_t bl = sw128_desc(st + 3 * TILE_BYTES + off);
      wgmma_tf32(d, al, bh, kk > 0);  // the slab's first product starts d afresh
      wgmma_tf32(d, ah, bl, 1);
      wgmma_tf32(d, ah, bh, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(d);
    if (t == 0) mbar_arrive(empty + 8 * s);  // this warpgroup is done with the stage
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];  // rounded to nearest, on the CUDA cores
  }

  // the exact path for outputs on a flagged row or column
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);  // and r0 + 8, in the tile
  const long long grow = (long long)bi * BM + r0, gcol = (long long)bj * BN + 2 * qd;
  const bool f0 = p.row_flag[grow] != 0, f1 = p.row_flag[grow + 8] != 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = gcol + 8 * j + (e & 1);
      if ((e < 2 ? f0 : f1) || p.col_flag[col] != 0)
        acc[4 * j + e] = exact_dot(p, grow + (e < 2 ? 0 : 8), col);
    }

  if (!REDUCE) {
    float* c0 = p.out + grow * p.n + gcol;
    float* c1 = c0 + 8LL * p.n;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<float2*>(c0 + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(c1 + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    return;
  }
  if (p.axis == 1) {
    // a row's 128 columns: 32 in each thread of its quad
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
    if (qd == 0) {  // row bi*128 + r of partial bj ([N/128, M])
      p.out[(long long)bj * p.m + grow] = v0;
      p.out[(long long)bj * p.m + grow + 8] = v1;
    }
    return;
  }
  // axis 0: a column's 128 rows: 2 in each thread, 16 in a warp (its 8
  // lanes of one qd), then the 8 consumer warps through shared memory
  const int w8 = wg * 4 + warp;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = acc[4 * j + e] + acc[4 * j + 2 + e];
      v += __shfl_xor_sync(FULL, v, 4);
      v += __shfl_xor_sync(FULL, v, 8);
      v += __shfl_xor_sync(FULL, v, 16);
      if (lane < 4) red[w8 * BN + 8 * j + 2 * qd + e] = v;
    }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the two consumer warpgroups
  if (threadIdx.x < BN) {
    float v = red[threadIdx.x];
#pragma unroll
    for (int q = 1; q < 8; ++q) v += red[q * BN + threadIdx.x];
    p.out[(long long)bi * p.n + (long long)bj * BN + threadIdx.x] = v;  // [M/128, N]
  }
}

// split A and B into the scratch, then the product: the tile stored
// (reduce false) or folded along axis; mask null walks every k slab.
// scratch: A_hi, A_lo [M, K], B_hi^T, B_lo^T [N, K]; flags: int32 [M + N],
// zeroed by the caller.
int run(const float* a, const int* mask, const float* b, float* scratch, int* flags, float* out,
        int m, int n, int k, bool reduce, int axis, cudaStream_t stream) {
  float* a_hi = scratch;
  float* a_lo = a_hi + (long long)m * k;
  float* b_hi = a_lo + (long long)m * k;
  float* b_lo = b_hi + (long long)n * k;
  const long long n4 = (long long)m * k / 4;
  const int blocks = (int)((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  split_rows<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(a),
                                         reinterpret_cast<float4*>(a_hi),
                                         reinterpret_cast<float4*>(a_lo), flags, mask, n4, k);
  split_cols_t<<<dim3(n / 32, k / 32), dim3(32, 8), 0, stream>>>(b, b_hi, b_lo, flags + m, k, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Maps maps;
  if (!make_map_k32(&maps.a_hi, a_hi, m, k) || !make_map_k32(&maps.a_lo, a_lo, m, k) ||
      !make_map_k32(&maps.b_hi, b_hi, n, k) || !make_map_k32(&maps.b_lo, b_lo, n, k))
    return (int)cudaErrorInvalidValue;
  Args p{a, b, mask, flags, flags + m, out, m, n, k, axis};
  const dim3 grid(n / BN, m / BM);
  if (!reduce) {
    e = cudaFuncSetAttribute(tf32x3_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    tf32x3_kernel<false><<<grid, THREADS, SMEM_BYTES, stream>>>(maps, p);
  } else {
    e = cudaFuncSetAttribute(tf32x3_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    tf32x3_kernel<true><<<grid, THREADS, SMEM_BYTES, stream>>>(maps, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// A [M, K], B [K, N], C [M, N] fp32 row-major; M % 128 == N % 128 == 0,
// K % 32 == 0; scratch 2(M + N)K fp32; flags int32 [M + N], zeroed.
extern "C" int semiring_matmul_tf32_launch(const void* a, const void* b, void* scratch,
                                           void* flags, void* c, int m, int n, int k,
                                           void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (m % BM || n % BN || k % BK || k <= 0) return (int)cudaErrorInvalidValue;
  return run((const float*)a, nullptr, (const float*)b, (float*)scratch, (int*)flags, (float*)c,
             m, n, k, false, 1, (cudaStream_t)stream);
}

// As bsr_spgemm_launch under PLUS_TIMES: C [M, N] of the block-masked A
// (mask int32 [M/128, K/128]; M, N, K multiples of 128), with the scratch
// and flags above.  A block-row with no present tile gives 0.
extern "C" int bsr_spgemm_tf32_launch(const void* a, const void* mask, const void* b,
                                      void* scratch, void* flags, void* c, int m, int n, int k,
                                      void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (m % BM || n % BN || k % KTILE || k <= 0) return (int)cudaErrorInvalidValue;
  return run((const float*)a, (const int*)mask, (const float*)b, (float*)scratch, (int*)flags,
             (float*)c, m, n, k, false, 1, (cudaStream_t)stream);
}

// As bsr_spgemm_reduce_launch under PLUS_TIMES (mask int32 [M/128, K/128];
// M, N, K multiples of 128; part [N/128, M] for axis 1, [M/128, N] for
// axis 0), with the scratch and flags above.
extern "C" int bsr_spgemm_reduce_tf32_launch(const void* a, const void* mask, const void* b,
                                             void* scratch, void* flags, void* part, int m,
                                             int n, int k, int axis, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (m % BM || n % BN || k % KTILE || k <= 0 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  return run((const float*)a, (const int*)mask, (const float*)b, (float*)scratch, (int*)flags,
             (float*)part, m, n, k, true, axis, (cudaStream_t)stream);
}
