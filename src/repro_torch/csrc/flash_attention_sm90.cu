// flash_attention (bf16 route): online-softmax attention for Hopper, with
// TMA loads, wgmma products and the softmax in registers.  GQA head
// mapping and causal / sliding-window masks from global positions.
//
// Replaces flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py) for bf16 inputs;
// fp32 inputs take the CUDA-core route (flash_attention.cu).
//
// q is [B, H, Sq, D], k [B, KV, Sk, D], v [B, KV, Sk, Dv], o [B, H, Sq,
// Dv], each with any 16-byte strides over (b, h, s) and the last axis
// contiguous, so the model's [B, S, H, D] tensors go in and come out
// without a transpose copy.  Query row i sits at position q_off + i, key j
// at j; q-head h reads kv-head h / (H / KV).  The q/k head dim D and the v
// head dim Dv are padded to instances (DQ, DV) of (64, 64), (128, 128) and
// (192, 128), the last for MLA's prefill (qk_nope 128 + qk_rope 64 against
// v_head_dim 128).
//
// Design.  One 384-thread block owns one (b, h, 128-row q tile); q tiles
// run heaviest causal tile first.  Warpgroup 2 is the producer: one thread
// issues every TMA load (setmaxnreg drops the group to 40 registers).
// Warpgroups 0 and 1 are consumers of 64 query rows each.  They ask for
// 232 registers with setmaxnreg.inc, but ptxas compiles the whole kernel
// to the 168 registers a 384-thread block may hold, so the consumers' code
// uses 168 all the same: the raise frees no spill today.
//  * TMA reads the caller's strided 4-D views through tensor maps over
//    (D, S, heads, B) with 128-byte swizzle, in boxes of 64 columns x 128
//    rows: a tile of DQ (or DV) columns loads as DQ / 64 boxes, and a head
//    dim below the instance's (16 ... 112) is zero-filled past it by TMA.
//    Rows past Sq or Sk are zero-filled too.
//  * Shared memory: Q once (128 x DQ), then a 2-stage ring of 128-key K
//    (128 x DQ) and V (128 x DV) tiles: 160 KB in all at (128, 128), 208
//    KB of the 227 KB at (192, 128).  The accumulators depend on DV alone,
//    so (192, 128) holds the registers of (128, 128) and only takes 12
//    k16 steps for S where (128, 128) takes 8.  Each stage has a full barrier
//    for K, one for V (so S = Q·K^T starts before V lands) and an empty
//    barrier that each consumer warpgroup arrives on once its P·V wgmma
//    has retired.
//  * S = Q·K^T: wgmma m64n128k16, Q and K both K-major from shared memory.
//  * Online softmax in registers on the m64nNk16 accumulator layout: each
//    thread holds rows 16·warp + lane/4 and +8, so a row's max takes two
//    quad shuffles.  fp32 running max m and sum l; p = 2^(s·scale·log2 e
//    - m), with m kept in those units.  Only tiles that cross the causal
//    diagonal, the window edge or Sk are masked; keys past Sk are zero-
//    filled by TMA (score 0, not -inf), so they are masked explicitly.
//    Masked entries get p = 0, so a row with no visible key is 0, as in
//    the plain version.
//  * O += P·V: P rounded to bf16 in registers (p.astype(v.dtype) in the
//    Pallas kernel) is the register A operand of wgmma m64nDVk16 (the
//    S accumulator's layout is the bf16 A fragment's, k16 chunk by
//    chunk); V [keys, D] is MN-major for B, so the transpose bit is set.
//    O is scaled by alpha in registers before the product.
//  * Epilogue: O / max(l, 1e-30) rounded to bf16, stored straight from
//    registers to the strided output (columns past Dv and rows past Sq
//    are not stored); in training also each row's log-sum-exp (fp32) for
//    flash_attention_bwd.cu, from the running max and sum the loop keeps
//    anyway.
//
// Bound on an H100 at the serve path's shape (B 4, H 16, KV 8, S 2048,
// D 128, causal): operations.  4·D FLOPs per visible (q, k) pair, 68.7
// GFLOP, over 989 TFLOP/s is 0.069 ms, against 0.030 ms for the 100.7 MB of
// Q, K, V and O.  At MLA's (D 192, Dv 128) a visible pair costs 2·(D + Dv)
// FLOPs.  Tried on an H100 and measured slower or no faster
// (PERF.md): issuing the next tile's S behind this tile's P·V (its P
// fragments, S and O then share the 168 registers ptxas allots at this
// block size and spill), and a third ring stage.  Not yet done: overlap
// of one warpgroup's softmax with the other's wgmma (ping-pong),
// persistent blocks, and sharing K/V tiles across a GQA group.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // query rows per block: two consumer warpgroups of 64
constexpr int BN = 128;  // keys per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr int ROW_BYTES = 128;  // one swizzled box row: 64 bf16
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  __nv_bfloat16* o;
  float* lse;       // [B, H, Sq] row log-sum-exp (natural log), or null
  long long os[3];  // element strides of o over (b, h, s)
  int Sq, Sk, Dv, group;
  int causal, window, q_off;  // window <= 0: none
  float scale_log2;           // softmax scale · log2(e)
};

// Byte offsets from the 1024-aligned base of shared memory.  A box of
// 64 columns is ROWS x 128 B; a tile of DQ columns is DQ / 64 boxes.
template <int DQ, int DV>
struct Smem {
  static constexpr int NQ = DQ / 64;  // boxes of a Q or K row block
  static constexpr int NV = DV / 64;  // boxes of a V row block
  static constexpr int Q_BOX = BM * ROW_BYTES;
  static constexpr int KV_BOX = BN * ROW_BYTES;
  static constexpr int K_TILE = NQ * KV_BOX;
  static constexpr int V_TILE = NV * KV_BOX;
  static constexpr int Q = 0;
  static constexpr int K = Q + NQ * Q_BOX;
  static constexpr int V = K + STAGES * K_TILE;
  static constexpr int BAR = V + STAGES * V_TILE;
  // barriers: q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;  // + slack to align the base
  static_assert(BYTES <= 227 * 1024, "shared memory past the 227 KB a block may take");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that never
// ends (a lost transaction) traps, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for wgmma's register A operand, which it reads until it retires
template <int N>
__device__ __forceinline__ void fence_regs_u(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (+)= A · B^T, m64n128k16, A and B K-major bf16 in shared memory (128 B
// swizzle), fp32 accumulator in registers.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P · V, m64n128k16: P bf16 from registers (the A fragment), V
// MN-major bf16 in shared memory (transpose bit set), fp32 accumulator.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Smem<DQ, DV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 128 B swizzle atoms
  const uint32_t q_full = base + L::BAR;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.group;
  const int q0 = qt * BM;
  // keys any row of the block can see, in whole tiles from kstart
  int k_lo = 0, k_hi = p.Sk;
  if (p.causal) k_hi = min(p.Sk, p.q_off + min(q0 + BM, p.Sq));
  if (p.window > 0) k_lo = max(0, p.q_off + q0 - p.window + 1);
  const int kstart = (k_lo / BN) * BN;
  const int n_tiles = k_hi > kstart ? (k_hi - kstart + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_expect_tx(q_full, L::NQ * L::Q_BOX);
      for (int c = 0; c < L::NQ; ++c)
        tma_load(base + L::Q + c * L::Q_BOX, &tq, q_full, 64 * c, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const int k0 = kstart + it * BN;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(k_full + 8 * s, L::K_TILE);
        for (int c = 0; c < L::NQ; ++c)
          tma_load(base + L::K + s * L::K_TILE + c * L::KV_BOX, &tk, k_full + 8 * s, 64 * c, k0,
                   kvh, b);
        mbar_expect_tx(v_full + 8 * s, L::V_TILE);
        for (int c = 0; c < L::NV; ++c)
          tma_load(base + L::V + s * L::V_TILE + c * L::KV_BOX, &tv, v_full + 8 * s, 64 * c, k0,
                   kvh, b);
      }
    }
  } else {
    // consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int qd = lane & 3;
    const int row = q0 + wg * 64 + warp * 16 + (lane >> 2);  // and row + 8
    const int pos0 = p.q_off + row, pos1 = pos0 + 8;
    const int wg_first = p.q_off + q0 + wg * 64, wg_last = wg_first + 63;
    const float c = p.scale_log2;
    // this warpgroup's 64 rows of Q: 8 KB into each 128-row box
    const uint32_t qa = base + L::Q + wg * 64 * ROW_BYTES;

    float o[DV / 2];  // m64nDV accumulator: o[4j + e], columns 8j + 2·qd + (e & 1)
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF;  // rows row and row + 8, in log2 units
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES, ph = (it / STAGES) & 1;
      const int k0 = kstart + it * BN;

      // S = Q K^T over DQ / 16 k16 steps: 32 bytes into a 128-byte
      // swizzled row, then the next 64-column box
      float sc[64];  // sc[4j + e]: row (e < 2 ? row : row + 8), key k0 + 8j + 2·qd + (e & 1)
      const uint32_t ka = base + L::K + s * L::K_TILE;
      mbar_wait(k_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DQ / 16; ++kc) {
        const uint32_t off = (kc & 3) * 32;
        wgmma_ss_n128(sc, sw128_desc(qa + (kc >> 2) * L::Q_BOX + off, 16, 1024),
                      sw128_desc(ka + (kc >> 2) * L::KV_BOX + off, 16, 1024), kc > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // masks, only on tiles that cross the causal diagonal, the window
      // edge or Sk (TMA's zero fill past Sk gives scores of 0)
      const bool edge = (k0 + BN > p.Sk) || (p.causal && k0 + BN - 1 > wg_first) ||
                        (p.window > 0 && wg_last - k0 >= p.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * qd + (e & 1);
            const int pos = e < 2 ? pos0 : pos1;
            const bool vis = key < p.Sk && (!p.causal || key <= pos) &&
                             (p.window <= 0 || pos - key < p.window);
            if (!vis) sc[4 * j + e] = -CUDART_INF_F;
          }
      }

      // online softmax: row max over the quad, then p = 2^(s·c - m)
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        sc[4 * j] = exp2f(fmaf(sc[4 * j], c, -mn0));  // 0 where masked
        sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], c, -mn0));
        sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], c, -mn1));
        sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], c, -mn1));
        ls0 += sc[4 * j] + sc[4 * j + 1];
        ls1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * al0 + ls0;
      l1 = l1 * al1 + ls1;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
      // P as bf16 A fragments: the S accumulator's layout is the A
      // fragment's, k16 chunk kk being pa[4kk .. 4kk + 3]
      uint32_t pa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

      // O += P V over 8 k16 steps of 16 keys (2 KB of swizzled rows each);
      // the leading byte offset steps to V's next 64-column box
      mbar_wait(v_full + 8 * s, ph);
      fence_regs(o);
      wgmma_fence();
      const uint32_t va = base + L::V + s * L::V_TILE;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(o, pa + 4 * kk, sw128_desc(va + kk * 16 * ROW_BYTES, L::KV_BOX, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs_u(pa);
      if (t == 0) mbar_arrive(empty + 8 * s);  // this warpgroup is done with the stage
    }

    // epilogue: O / max(l, 1e-30), rounded to bf16, straight to global
    l0 += __shfl_xor_sync(FULL, l0, 1);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* og = p.o + b * p.os[0] + h * p.os[1] + (long long)row * p.os[2] + 2 * qd;
    const bool st0 = row < p.Sq, st1 = row + 8 < p.Sq;
    if (p.lse != nullptr && qd == 0) {
      // the backward's row statistic: m is in log2 units of the scaled
      // scores, so lse = (m + log2 l)·ln 2; +inf for a row with no key
      float* lg = p.lse + ((long long)b * gridDim.y + h) * p.Sq;
      if (st0) lg[row] = l0 > 0.f ? (m0 + log2f(l0)) * 0.6931471805599453f : CUDART_INF_F;
      if (st1) lg[row + 8] = l1 > 0.f ? (m1 + log2f(l1)) * 0.6931471805599453f : CUDART_INF_F;
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      if (8 * j < p.Dv) {  // Dv is a multiple of 16: whole 8-column blocks
        if (st0)
          *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) =
              __floats2bfloat162_rn(o[4 * j] / lc0, o[4 * j + 1] / lc0);
        if (st1)
          *reinterpret_cast<__nv_bfloat162*>(og + 8 * p.os[2] + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2] / lc1, o[4 * j + 3] / lc1);
      }
    }
  }
}

// cuTensorMapEncodeTiled, taken through the runtime's driver entry point
// (the library links no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a tensor map over the strided [B, heads, S, D] bf16 view, as a 4-D
// tensor (D, S, heads, B), boxes of 64 columns x 128 rows, 128 B swizzle,
// zero fill out of bounds
bool make_map(CUtensorMap* map, const void* ptr, const long long* st, int B, int heads, int S,
              int D) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQ, int DV>
int launch_dp(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
              const Params& p, int B, int H, cudaStream_t stream) {
  const int bytes = Smem<DQ, DV>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma<DQ, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + BM - 1) / BM, H, B);
  flash_fwd_wgmma<DQ, DV><<<grid, THREADS, bytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, o; the arguments of flash_attention_launch (lse: null in
// serving; in training fp32 [B, H, Sq] contiguous, each row's log-sum-exp,
// stored in the epilogue from the running max and sum, after the main
// loop, so the loop's registers do not change).  strides: 12
// element strides, (b, h, s) of q, k, v and o in that order, each a
// multiple of 8 (16 bytes), base pointers 16-byte aligned.  window <= 0:
// no window.  Sq, Sk >= 1; D and Dv multiples of 16 whose instance
// (each rounded up to 64) is (64, 64), (128, 128) or (192, 128).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                            float* lse, const long long* strides, int B,
                                            int H, int KV, int Sq, int Sk, int D, int Dv,
                                            int causal, int window, int q_off, float scale,
                                            void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Sk <= 0 || D < 16 || D % 16 != 0 || Dv < 16 || Dv % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int dq = (D + 63) / 64 * 64, dv = (Dv + 63) / 64 * 64;
  if (!((dq == dv && dq <= 128) || (dq == 192 && dv == 128))) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, strides, B, H, Sq, D) || !make_map(&tk, k, strides + 3, B, KV, Sk, D) ||
      !make_map(&tv, v, strides + 6, B, KV, Sk, Dv))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.Sq = Sq;
  p.Sk = Sk;
  p.Dv = Dv;
  p.group = H / KV;
  p.causal = causal;
  p.window = window;
  p.q_off = q_off;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = (cudaStream_t)stream;
  if (dq == 192) return launch_dp<192, 128>(tq, tk, tv, p, B, H, st);
  return dq == 64 ? launch_dp<64, 64>(tq, tk, tv, p, B, H, st)
                  : launch_dp<128, 128>(tq, tk, tv, p, B, H, st);
}
