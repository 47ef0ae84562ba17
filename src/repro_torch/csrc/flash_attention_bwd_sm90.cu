// flash_attention_bwd (bf16 route): the gradient of flash attention for
// Hopper, with TMA loads, wgmma for all five products and dK/dV in
// registers (FlashAttention-3's backward).  fp32 inputs take the CUDA-core
// route (flash_attention_bwd.cu).
//
// Replaces no TPU kernel: the JAX package has no backward kernel and lets
// XLA differentiate its query-chunked reference path
// (src/repro/models/attention.py).  Given q [B, H, Sq, D], k [B, KV, Sk,
// D], v [B, KV, Sk, Dv], the forward's output o and its gradient dO [B, H,
// Sq, Dv] and the forward's row log-sum-exp lse [B, H, Sq] (fp32, natural
// log, +inf for a row that sees no key), it writes dq, dk and dv (bf16,
// any 16-byte strides over (b, h, s), the last axis contiguous):
//     P = exp(scale·S − lse) (S = Q·K^T, masked entries 0),
//     delta_i = Σ_e dO_ie·O_ie,
//     dV = P^T·dO,  dP = dO·V^T,  dS = P ∘ (dP − delta),
//     dQ = scale·dS·K,  dK = scale·dS^T·Q,
// dK and dV summed over each GQA group.  Masks as in the forward: causal,
// sliding window, queries at q_off + i, keys at j, any Sq and Sk.  The head
// dims run in the forward's instances (DQ, DV) = (64, 64), (128, 128) and
// (192, 128); a narrower head dim is zero-filled past D by TMA and its
// columns are not stored.
//
// One call, three launches (four when a GQA group is split):
//  * flash_bwd_pre: 16 threads a query row compute delta (fp32) and lse2 =
//    lse·log2(e) (+inf past Sq, so those rows get P = 0) and zero the row
//    of an fp32 dQ accumulator.  Sq is padded to Sq_pad, a multiple of 64;
//    the three live in one scratch tensor the wrapper allocates.
//  * flash_bwd_wgmma: one 256-thread block per (b, kv head, GQA split,
//    128-key tile).  Blocks run in chunks of about one wave of whole (b, kv
//    head, split) groups, the heaviest causal key tile first inside a
//    chunk, so the dQ rows that the running blocks add into stay in L2
//    (with the key tile the slowest index of all blocks, deepseek-v3's
//    backward takes 1.6x as long and zamba2-7b's 1.37x).  Two warpgroups own 64 keys each;
//    thread 0 also issues the TMA loads.  K and V (128 rows) stay in shared
//    memory.  A 2-stage ring streams the (head, 64-row query tile) pairs of
//    the block's heads that can see the key tile: Q, dO (4-D tensor maps
//    over the caller's strided views, 128-byte swizzle, rows past Sq
//    zero-filled) and the tile's lse2 and delta (1-D bulk copies).  For
//    each pair a warpgroup computes
//      S^T = K·Q^T and dP^T = V·dO^T   wgmma m64n64k16, Q and dO K-major
//        in shared memory; K and V K-major in shared memory, or at D 64
//        the warpgroup's rows as register A fragments loaded once (6-7%
//        faster there; D 128 has no registers to spare);
//      P^T = 2^(S^T·scale·log2 e − lse2) (ex2.approx) in registers on the
//        accumulator layout, explicit masks only on tiles that cross the
//        diagonal, the window edge or Sk (keys past Sk are zero-filled,
//        score 0), rounded to bf16;
//      dS^T = P^T ∘ (dP^T − delta), from the bf16 P, rounded to bf16;
//      dV += P^T·dO and dK += dS^T·Q   wgmma with P^T and dS^T as the
//        register A operand (the m64nNk16 accumulator's layout is the A
//        fragment's, one k16 chunk of queries at a time) and dO, Q
//        MN-major from the ring (transpose bit set);
//      dQ_tile = dS·K   wgmma with both operands in shared memory, MN-major
//        (both transpose bits): dS^T goes to a swizzled 128 x 64 bf16
//        buffer (two, alternating, so one named barrier an iteration keeps
//        the warpgroups apart).  The warpgroups split dQ's 64-column
//        chunks (D 128: one each; D 192: two and one) over the 128 keys;
//        at D 64 each takes its own 64 keys, and its barrier is its own.
//        Each 64 x 64 chunk is added into the accumulator with float4
//        atomicAdd (RED.128) straight from the accumulator registers: the
//        accumulator keeps each chunk in the m64n64 fragment order, so a
//        warp's 32 adds are 512 contiguous bytes (faster on an H100 than
//        float2 adds into row-major rows, and no slower than staging the
//        chunk in shared memory for one bulk reduce-add).
//    The ring stage is released once dV and dK have retired; dQ does not
//    read it.  dK·scale and dV are rounded once and stored into the
//    caller's strides (a key tile that no query sees stores zeros), or,
//    when the group is split, stored in fp32 for the fourth launch.
//  * flash_bwd_post: dq = scale·acc, rounded once into the caller's dq,
//    reading the accumulator in its memory order.
//  * flash_bwd_combine (split groups only): dk and dv = the splits'
//    shares summed in split order, rounded once.  A group is split where
//    its blocks would fill under two waves (ops.bwd_group_split: chatglm3's
//    16 heads a kv head make 128 blocks for 132 SMs; whole, the groups
//    take 1.34x as long as in 3 splits).
//
// The five products cost 2·(3·D + 2·Dv) FLOPs a visible (query, key) pair:
// no recompute.  dq is summed by atomics in an order that changes from run
// to run, so it is not bitwise reproducible; dk and dv are (a group's
// heads are summed in registers, and its splits in a fixed order).
//
// Registers.  dK and dV of a warpgroup's 64 keys are DQ/2 + DV/2 fp32 a
// thread (128 at (128, 128), 160 at (192, 128)); S^T and dP^T at 64
// queries 32 each.  At (128, 128) and (64, 64) the dP product runs beside
// the softmax and the dQ product beside dV/dK (OVERLAP); at (192, 128)
// each waits for the one before (dP after P is packed, dQ after dV/dK
// retire), which keeps the kernel within the 255 registers a 256-thread
// block allows, with no spill.
//
// Bound on an H100 at qwen3-1.7b's train shape (B 4, H 16, KV 8, S 2048,
// D 128, causal): operations.  1,280 FLOPs a visible pair on 134M pairs,
// 172 GFLOP, over 989 TFLOP/s is 0.174 ms, against 0.05 ms for the bytes.
// The dQ accumulator adds 4·B·H·Sq_pad·DQ bytes of memory and its zeroing,
// atomics and final pass.  tools/flash_bwd_ablate.py times the kernel
// against its own source with one of these choices undone.  Tried on an
// H100 and measured slower: dQ over each warpgroup's own keys at D 128
// (twice the atomics, no shared barrier), S and dP in two halves of 32
// queries (A read twice from shared memory), the next pair's S and dP
// issued behind this pair's dQ (spills), a memset of the accumulator
// apart from flash_bwd_pre.  Not yet done: a producer warp apart from the
// consumers, K and V register fragments at D 128 (no registers left),
// ping-pong of the two warpgroups.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

constexpr int BM = 64;   // query rows of a streamed tile
constexpr int BN = 128;  // keys of a block: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int ROW_BYTES = 128;      // one swizzled box row: 64 bf16
constexpr int STAT_BYTES = BM * 4;  // a tile's lse2 or delta
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dO;
  const float* lse;  // [B, H, Sq], contiguous
  float* acc;        // [B·H, Sq_pad / 64, DQ / 64] chunks of 64 x 64 fp32 (dQ / scale), each in
                     // the m64n64 accumulator's fragment order: float4 (warp·8 + j)·32 + lane
  float* lse2;       // [B·H, Sq_pad]: lse·log2(e), +inf past Sq
  float* delta;      // [B·H, Sq_pad]: rowsum(dO ∘ O), 0 past Sq
  float* part;       // nsplit > 1: [nsplit, B, KV, Sk, DQ + DV], each split's dK·scale | dV
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long os[3], dos[3], dqs[3], dks[3], dvs[3];  // element strides of (b, h, s)
  int B, H, KV, Sq, Sk, Sq_pad, D, Dv, DQ, group;   // group = H / KV, DQ the instance's
  int wave;                                         // the SMs: blocks that run at once
  int nsplit, gper;  // blocks a GQA group is split over, and its heads in each
  int causal, window, q_off;                        // window <= 0: none
  float scale, scale_log2;                          // softmax scale, and · log2(e)
};

// Byte offsets from the 1024-aligned base of shared memory.  A box of 64
// columns is ROWS x 128 B, swizzled; a tile of DQ columns is DQ / 64 boxes.
template <int DQ, int DV>
struct Smem {
  static constexpr int NQ = DQ / 64;             // boxes of a Q or K row block
  static constexpr int NV = DV / 64;             // boxes of a V or dO row block
  static constexpr int KV_BOX = BN * ROW_BYTES;  // 128 key rows
  static constexpr int Q_BOX = BM * ROW_BYTES;   // 64 query rows
  static constexpr int K = 0;
  static constexpr int V = K + NQ * KV_BOX;
  static constexpr int Q = V + NV * KV_BOX;       // 2 stages of NQ boxes
  static constexpr int DO = Q + 2 * NQ * Q_BOX;   // 2 stages of NV boxes
  static constexpr int DS = DO + 2 * NV * Q_BOX;  // 2 buffers of dS^T: 128 keys x 64 queries
  static constexpr int LSE = DS + 2 * KV_BOX;     // 2 stages
  static constexpr int DELTA = LSE + 2 * STAT_BYTES;
  static constexpr int BAR = DELTA + 2 * STAT_BYTES;  // kv_full, full[2], empty[2]
  static constexpr int BYTES = BAR + 8 * 5 + 1024;    // + slack to align the base
  static_assert(BYTES <= 227 * 1024, "shared memory past the 227 KB a block may take");
};

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (+)= A · B, m64n64k16, A and B bf16 in shared memory (128 B swizzle),
// fp32 accumulator in registers; TA / TB set the transpose bits (1: the
// operand is MN-major, its M or N axis contiguous)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// 2^x, the MUFU approximation (2 ulp), flushing denormals: what exp2f
// costs beyond it is range handling that P's arguments (<= ~0) never need
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the two bf16 halves of a pack_bf16 word, exactly, as fp32
__device__ __forceinline__ float lo_bf16(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// a contiguous run of global memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// D^T of one k-major product over `steps` k16 steps: the A rows at `a`, the
// B rows at `b` (K-major, boxes `a_box` / `b_box` bytes apart)
template <int STEPS>
__device__ __forceinline__ void kmajor_product(float (&d)[32], uint32_t a, int a_box, uint32_t b,
                                               int b_box) {
#pragma unroll
  for (int kc = 0; kc < STEPS; ++kc) {
    const uint32_t off = (kc & 3) * 32;  // 32 bytes into a 128-byte row, then the next box
    wgmma_ss_n64<0, 0>(d, sw128_desc(a + (kc >> 2) * a_box + off, 16, 1024),
                       sw128_desc(b + (kc >> 2) * b_box + off, 16, 1024), kc > 0);
  }
  wgmma_commit();
}

// D (+)= A · B, m64n64k16, A bf16 from registers (the A fragment), B
// K-major bf16 in shared memory (128 B swizzle)
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], const uint32_t* a, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// kmajor_product with A's 64 rows as register fragments (4 a k16 step)
template <int STEPS>
__device__ __forceinline__ void kmajor_product_rs(float (&d)[32], const uint32_t* af, uint32_t b,
                                                  int b_box) {
#pragma unroll
  for (int kc = 0; kc < STEPS; ++kc)
    wgmma_rs_k(d, af + 4 * kc, sw128_desc(b + (kc >> 2) * b_box + (kc & 3) * 32, 16, 1024),
               kc > 0);
  wgmma_commit();
}

// ring stage it & 1 <- (head, query tile) pair `it` of the block: Q, dO,
// lse2 and delta, once both warpgroups have released the stage's previous
// pair (it - 2)
template <int DQ, int DV>
__device__ __forceinline__ void load_stage(const CUtensorMap* tq, const CUtensorMap* tdo,
                                           const Params& p, uint32_t base, int it, int qt_lo,
                                           int n_qt, int g_lo, int kvh, int b) {
  using L = Smem<DQ, DV>;
  const int s = it & 1;
  const int h = kvh * p.group + g_lo + it / n_qt, q0 = (qt_lo + it % n_qt) * BM;
  const uint32_t full = base + L::BAR + 8 + 8 * s, empty = base + L::BAR + 24 + 8 * s;
  mbar_wait(empty, ((it >> 1) & 1) ^ 1);  // the first round passes
  mbar_expect_tx(full, (L::NQ + L::NV) * L::Q_BOX + 2 * STAT_BYTES);
  for (int c = 0; c < L::NQ; ++c)
    tma_load(base + L::Q + (s * L::NQ + c) * L::Q_BOX, tq, full, 64 * c, q0, h, b);
  for (int c = 0; c < L::NV; ++c)
    tma_load(base + L::DO + (s * L::NV + c) * L::Q_BOX, tdo, full, 64 * c, q0, h, b);
  const long long row = ((long long)b * p.H + h) * p.Sq_pad + q0;
  bulk_load(base + L::LSE + s * STAT_BYTES, p.lse2 + row, STAT_BYTES, full);
  bulk_load(base + L::DELTA + s * STAT_BYTES, p.delta + row, STAT_BYTES, full);
}

// delta = Σ dO ∘ O, lse2 and the zeroed dQ accumulator: 16 threads a
// padded query row, 8 columns each (grid: x over a head's rows, 16 a
// block; y over the heads, strided)
__global__ void __launch_bounds__(256) flash_bwd_pre(const Params p) {
  const int sub = threadIdx.x & 15, i = blockIdx.x * 16 + (threadIdx.x >> 4);
  for (int bh = blockIdx.y; bh < p.B * p.H; bh += gridDim.y) {
    const int b = bh / p.H, h = bh % p.H;
    const long long row = (long long)bh * p.Sq_pad + i;
    float acc = 0.f;
    if (i < p.Sq && 8 * sub < p.Dv) {
      const uint4 x = *reinterpret_cast<const uint4*>(p.o + b * p.os[0] + h * p.os[1] +
                                                      i * p.os[2] + 8 * sub);
      const uint4 y = *reinterpret_cast<const uint4*>(p.dO + b * p.dos[0] + h * p.dos[1] +
                                                      i * p.dos[2] + 8 * sub);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc = fmaf(lo_bf16(xs[c]), lo_bf16(ys[c]), fmaf(hi_bf16(xs[c]), hi_bf16(ys[c]), acc));
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
    if (sub == 0) {
      p.delta[row] = acc;
      p.lse2[row] = i < p.Sq ? p.lse[(long long)bh * p.Sq + i] * LOG2E : CUDART_INF_F;
    }
    float4* a = reinterpret_cast<float4*>(p.acc + row * p.DQ);
    for (int c = sub; c < p.DQ / 4; c += 16) a[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// dq = scale·acc, one float4 of the accumulator a thread, in its memory
// order (a warp reads 512 contiguous bytes): rows r0 and r0 + 8 of a
// 64-row tile, columns 8j + 2·qd and + 1 of a 64-column chunk (grid: x over
// a head's float4s, y over the heads, strided)
__global__ void __launch_bounds__(256) flash_bwd_post(const Params p) {
  const int nch = p.DQ / 64, per = p.Sq_pad / 64 * nch * 1024;
  for (int bh = blockIdx.y; bh < p.B * p.H; bh += gridDim.y) {
    const int b = bh / p.H, h = bh % p.H;
    const float4* acc = reinterpret_cast<const float4*>(p.acc + (long long)bh * p.Sq_pad * p.DQ);
    __nv_bfloat16* dq = p.dq + b * p.dqs[0] + h * p.dqs[1];
    for (int idx = blockIdx.x * 256 + threadIdx.x; idx < per; idx += gridDim.x * 256) {
      const int f = idx & 1023, chunk = idx >> 10;  // (warp·8 + j)·32 + lane
      const int lane = f & 31, r = 64 * (chunk / nch) + 16 * (f >> 8) + (lane >> 2);
      const int col = 64 * (chunk % nch) + 8 * ((f >> 5) & 7) + 2 * (lane & 3);
      if (col >= p.D) continue;
      const float4 x = acc[idx];
      if (r < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(dq + r * p.dqs[2] + col) =
            __floats2bfloat162_rn(x.x * p.scale, x.y * p.scale);
      if (r + 8 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(dq + (r + 8) * p.dqs[2] + col) =
            __floats2bfloat162_rn(x.z * p.scale, x.w * p.scale);
    }
  }
}

template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const Params p) {
  using L = Smem<DQ, DV>;
  constexpr int NQ = L::NQ, NV = L::NV;
  constexpr bool OVERLAP = DQ <= 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128 B swizzle atoms
  unsigned char* sm = smem_raw + (base - raw);   // the same base, as a generic pointer
  const uint32_t kv_full = base + L::BAR;

  // blocks run in chunks of about one wave (p.wave blocks) of whole (b, kv
  // head) groups, the key tile the slowest index inside a chunk: the
  // causally heaviest tiles first, and the dQ rows that a chunk adds into
  // (its groups' heads) stay in L2
  const int nbk = p.KV * p.B * p.nsplit, n_kt = (p.Sk + BN - 1) / BN;
  const int cg = max(1, p.wave / n_kt);                         // groups a chunk
  const int chunk = blockIdx.x / (cg * n_kt), in = blockIdx.x % (cg * n_kt);
  const int groups = min(cg, nbk - chunk * cg);                // the last chunk's may be fewer
  const int kt = in / groups, grp = chunk * cg + in % groups;
  const int split = grp % p.nsplit, kvh = grp / p.nsplit % p.KV, b = grp / p.nsplit / p.KV;
  const int g_lo = split * p.gper, n_heads = max(0, min(p.group - g_lo, p.gper));
  const int k0 = kt * BN, k_last = min(k0 + BN, p.Sk) - 1;
  // query rows that can see a key of the tile, in whole 64-row tiles
  int i_lo = 0, i_hi = p.Sq;
  if (p.causal) i_lo = max(0, k0 - p.q_off);
  if (p.window > 0) i_hi = min(i_hi, k_last + p.window - p.q_off);
  const int qt_lo = i_lo / BM;
  const int n_qt = i_hi > i_lo ? (i_hi + BM - 1) / BM - qt_lo : 0;
  const int n_it = n_qt * n_heads;  // (head, query tile) pairs, head-major

  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(kv_full + 8 * i, i < 3 ? 1 : 2);  // empty: one per warpgroup
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_it > 0) {
    mbar_expect_tx(kv_full, (NQ + NV) * L::KV_BOX);
    for (int c = 0; c < NQ; ++c)
      tma_load(base + L::K + c * L::KV_BOX, &tk, kv_full, 64 * c, k0, kvh, b);
    for (int c = 0; c < NV; ++c)
      tma_load(base + L::V + c * L::KV_BOX, &tv, kv_full, 64 * c, k0, kvh, b);
    load_stage<DQ, DV>(&tq, &tdo, p, base, 0, qt_lo, n_qt, g_lo, kvh, b);
    if (n_it > 1) load_stage<DQ, DV>(&tq, &tdo, p, base, 1, qt_lo, n_qt, g_lo, kvh, b);
  }
  __syncwarp();

  const int w = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, qd = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);  // accumulator rows r0 and r0 + 8 of the 64
  const int kw = k0 + 64 * w;              // the warpgroup's first key
  const uint32_t ka = base + L::K + w * 64 * ROW_BYTES, va = base + L::V + w * 64 * ROW_BYTES;
  // dQ's share of this warpgroup: 64-column chunks [c_lo, c_hi) over the
  // k16 steps of keys [kk_lo, kk_lo + KSTEPS)
  const int c_lo = NQ == 1 ? 0 : (NQ == 2 ? w : 2 * w);
  const int c_hi = NQ == 1 ? 1 : (NQ == 2 ? w + 1 : 2 + w);
  constexpr int KSTEPS = NQ == 1 ? 4 : 8;
  const int kk_lo = NQ == 1 ? 4 * w : 0;

  float dk[NQ][32], dv[NV][32];  // [chunk][4j + e]: row r0 (+8 if e >= 2), column 64·chunk + 8j + 2·qd + (e & 1)
#pragma unroll
  for (int c = 0; c < NQ; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = 0.f;
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[c][i] = 0.f;

  if (n_it > 0) mbar_wait(kv_full, 0);
  // D 64: this warpgroup's 64 rows of K and V as wgmma A fragments, read
  // once from the swizzled tiles (S^T and dP^T then read only Q and dO
  // from shared memory)
  constexpr bool KVREG = DQ == 64;
  uint32_t kf[KVREG ? 16 : 1], vf[KVREG ? 16 : 1];
  if (KVREG && n_it > 0) {
    const int sw = (lane >> 2) & 7;
    const unsigned char* kr = sm + L::K + (64 * w + r0) * ROW_BYTES;
    const unsigned char* vr = sm + L::V + (64 * w + r0) * ROW_BYTES;
#pragma unroll
    for (int kc = 0; kc < (KVREG ? 4 : 0); ++kc) {
      const int c0 = (((2 * kc) ^ sw) << 4) + 4 * qd, c1 = (((2 * kc + 1) ^ sw) << 4) + 4 * qd;
      kf[4 * kc] = *reinterpret_cast<const uint32_t*>(kr + c0);
      kf[4 * kc + 1] = *reinterpret_cast<const uint32_t*>(kr + 8 * ROW_BYTES + c0);
      kf[4 * kc + 2] = *reinterpret_cast<const uint32_t*>(kr + c1);
      kf[4 * kc + 3] = *reinterpret_cast<const uint32_t*>(kr + 8 * ROW_BYTES + c1);
      vf[4 * kc] = *reinterpret_cast<const uint32_t*>(vr + c0);
      vf[4 * kc + 1] = *reinterpret_cast<const uint32_t*>(vr + 8 * ROW_BYTES + c0);
      vf[4 * kc + 2] = *reinterpret_cast<const uint32_t*>(vr + c1);
      vf[4 * kc + 3] = *reinterpret_cast<const uint32_t*>(vr + 8 * ROW_BYTES + c1);
    }
  }
  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1;
    // the ring runs one pair ahead; the stage's previous pair was released
    // before the last named barrier, which both warpgroups have passed
    if (threadIdx.x == 0 && it >= 1 && it + 1 < n_it)
      load_stage<DQ, DV>(&tq, &tdo, p, base, it + 1, qt_lo, n_qt, g_lo, kvh, b);
    __syncwarp();
    const int h = kvh * p.group + g_lo + it / n_qt, q0 = (qt_lo + it % n_qt) * BM;
    const uint32_t qs = base + L::Q + s * NQ * L::Q_BOX, dos = base + L::DO + s * NV * L::Q_BOX;
    const uint32_t full = kv_full + 8 + 8 * s, empty = kv_full + 24 + 8 * s;
    mbar_wait(full, (it >> 1) & 1);

    // S^T = K Q^T (and, with OVERLAP, dP^T = V dO^T behind it)
    float st[32], dpt[32];  // [4j + e]: key row r0 (+8), query 8j + 2·qd + (e & 1)
    wgmma_fence();
    if constexpr (KVREG) {
      kmajor_product_rs<DQ / 16>(st, kf, qs, L::Q_BOX);
      kmajor_product_rs<DV / 16>(dpt, vf, dos, L::Q_BOX);
      wgmma_wait<1>();
    } else if (OVERLAP) {
      kmajor_product<DQ / 16>(st, ka, L::KV_BOX, qs, L::Q_BOX);
      kmajor_product<DV / 16>(dpt, va, L::KV_BOX, dos, L::Q_BOX);
      wgmma_wait<1>();
    } else {
      kmajor_product<DQ / 16>(st, ka, L::KV_BOX, qs, L::Q_BOX);
      wgmma_wait<0>();
    }
    fence_regs(st);

    // P^T = 2^(S^T·c − lse2), masked only where the tile crosses the
    // diagonal, the window edge or Sk; rows past Sq have lse2 = +inf
    const float* lse2 = reinterpret_cast<const float*>(sm + L::LSE + s * STAT_BYTES);
    const float* delta = reinterpret_cast<const float*>(sm + L::DELTA + s * STAT_BYTES);
    const int pos0 = p.q_off + q0;
    const bool edge = kw + 63 >= p.Sk || (p.causal && kw + 63 > pos0) ||
                      (p.window > 0 && pos0 + 63 - kw >= p.window);
    uint32_t pa[16];  // P^T as bf16 A fragments: k16 chunk kk is pa[4kk .. 4kk + 3]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * qd);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = ex2(fmaf(st[4 * j + e], p.scale_log2, (e & 1) ? -l.y : -l.x));
      if (edge) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + r0 + (e >> 1) * 8, pos = pos0 + 8 * j + 2 * qd + (e & 1);
          const bool vis = key < p.Sk && (!p.causal || key <= pos) &&
                           (p.window <= 0 || pos - key < p.window);
          if (!vis) x[e] = 0.f;
        }
      }
      pa[2 * j] = pack_bf16(x[0], x[1]);
      pa[2 * j + 1] = pack_bf16(x[2], x[3]);
    }
    if (!OVERLAP) {
      wgmma_fence();
      kmajor_product<DV / 16>(dpt, va, L::KV_BOX, dos, L::Q_BOX);
    }
    wgmma_wait<0>();
    fence_regs(dpt);

    // dS^T = P^T ∘ (dP^T − delta) from the bf16 P, as bf16 A fragments, and
    // into this warpgroup's 64 rows of the swizzled dS^T buffer
    uint32_t da[16];
    unsigned char* dsb = sm + L::DS + s * L::KV_BOX;
    const int row = 64 * w + r0, sw = (lane >> 2) & 7;  // row & 7 == (row + 8) & 7 == sw
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * qd);
      da[2 * j] = pack_bf16(lo_bf16(pa[2 * j]) * (dpt[4 * j] - d.x),
                            hi_bf16(pa[2 * j]) * (dpt[4 * j + 1] - d.y));
      da[2 * j + 1] = pack_bf16(lo_bf16(pa[2 * j + 1]) * (dpt[4 * j + 2] - d.x),
                                hi_bf16(pa[2 * j + 1]) * (dpt[4 * j + 3] - d.y));
      const int chunk = ((j ^ sw) << 4) + 4 * qd;
      *reinterpret_cast<uint32_t*>(dsb + row * ROW_BYTES + chunk) = da[2 * j];
      *reinterpret_cast<uint32_t*>(dsb + (row + 8) * ROW_BYTES + chunk) = da[2 * j + 1];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // dS^T visible to wgmma

    // dV += P^T dO and dK += dS^T Q: register A, dO and Q MN-major (16
    // query rows, 2 KB, a k16 step; the leading byte offset steps boxes)
#pragma unroll
    for (int c = 0; c < NV; ++c) fence_regs(dv[c]);
#pragma unroll
    for (int c = 0; c < NQ; ++c) fence_regs(dk[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NV; ++c)
        wgmma_rs(dv[c], pa + 4 * kk,
                 sw128_desc(dos + c * L::Q_BOX + kk * 16 * ROW_BYTES, L::Q_BOX, 1024));
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NQ; ++c)
        wgmma_rs(dk[c], da + 4 * kk,
                 sw128_desc(qs + c * L::Q_BOX + kk * 16 * ROW_BYTES, L::Q_BOX, 1024));
    wgmma_commit();
    if (!OVERLAP) {
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NV; ++c) fence_regs(dv[c]);
#pragma unroll
      for (int c = 0; c < NQ; ++c) fence_regs(dk[c]);
      fence_regs_u(pa);
      fence_regs_u(da);
      if (t == 0) mbar_arrive(empty);  // this warpgroup is done with the stage
    }
    // dS^T in place for dQ: both halves (D 128, 192), or this warpgroup's
    // own (D 64: its dQ runs over its own keys)
    if (NQ == 1)
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
    else
      asm volatile("bar.sync 1, 256;\n" ::: "memory");

    // dQ_tile (64 queries x this warpgroup's chunks) = dS K, both MN-major
    // in shared memory, added into the fp32 accumulator
    const uint32_t dsa = base + L::DS + s * L::KV_BOX;
    float* accg = p.acc + (((long long)b * p.H + h) * p.Sq_pad + q0) * DQ;  // the tile's chunks
    for (int ch = c_lo; ch < c_hi; ++ch) {
      float dq[32];
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < KSTEPS; ++i) {
        const int kk = kk_lo + i;
        wgmma_ss_n64<1, 1>(dq, sw128_desc(dsa + kk * 16 * ROW_BYTES, L::KV_BOX, 1024),
                           sw128_desc(base + L::K + ch * L::KV_BOX + kk * 16 * ROW_BYTES,
                                      L::KV_BOX, 1024),
                           i > 0);
      }
      wgmma_commit();
      if (OVERLAP) {
        wgmma_wait<1>();  // dV and dK have retired
#pragma unroll
        for (int c = 0; c < NV; ++c) fence_regs(dv[c]);
#pragma unroll
        for (int c = 0; c < NQ; ++c) fence_regs(dk[c]);
        fence_regs_u(pa);
        fence_regs_u(da);
        if (t == 0) mbar_arrive(empty);  // this warpgroup is done with the stage
      }
      wgmma_wait<0>();
      fence_regs(dq);
      // the chunk in fragment order: each thread's 4 values of column block
      // j are one float4, a warp's 32 of them 512 contiguous bytes
      float4* a4 = reinterpret_cast<float4*>(accg + ch * 4096) + warp * 256 + lane;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        atomicAdd(a4 + 32 * j, make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]));
    }
  }

  // epilogue: dK·scale and dV rounded once into the caller's strides or,
  // when the GQA group is split over blocks, this split's share in fp32 for
  // flash_bwd_combine
  const int key = kw + r0;
  const bool st0 = key < p.Sk, st1 = key + 8 < p.Sk;
  if (p.nsplit == 1) {
    __nv_bfloat16* dkg = p.dk + b * p.dks[0] + kvh * p.dks[1] + (long long)key * p.dks[2] + 2 * qd;
    __nv_bfloat16* dvg = p.dv + b * p.dvs[0] + kvh * p.dvs[1] + (long long)key * p.dvs[2] + 2 * qd;
#pragma unroll
    for (int c = 0; c < NQ; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j;  // D is a multiple of 16: whole 8-column blocks
        if (col < p.D) {
          if (st0)
            *reinterpret_cast<__nv_bfloat162*>(dkg + col) =
                __floats2bfloat162_rn(dk[c][4 * j] * p.scale, dk[c][4 * j + 1] * p.scale);
          if (st1)
            *reinterpret_cast<__nv_bfloat162*>(dkg + 8 * p.dks[2] + col) =
                __floats2bfloat162_rn(dk[c][4 * j + 2] * p.scale, dk[c][4 * j + 3] * p.scale);
        }
      }
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j;
        if (col < p.Dv) {
          if (st0)
            *reinterpret_cast<__nv_bfloat162*>(dvg + col) =
                __floats2bfloat162_rn(dv[c][4 * j], dv[c][4 * j + 1]);
          if (st1)
            *reinterpret_cast<__nv_bfloat162*>(dvg + 8 * p.dvs[2] + col) =
                __floats2bfloat162_rn(dv[c][4 * j + 2], dv[c][4 * j + 3]);
        }
      }
  } else {
    constexpr int W = DQ + DV;  // a partial row: dK·scale | dV
    float* pk = p.part + ((((long long)split * p.B + b) * p.KV + kvh) * p.Sk + key) * W + 2 * qd;
#pragma unroll
    for (int c = 0; c < NQ; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j;
        if (col < p.D) {
          if (st0)
            *reinterpret_cast<float2*>(pk + col) =
                make_float2(dk[c][4 * j] * p.scale, dk[c][4 * j + 1] * p.scale);
          if (st1)
            *reinterpret_cast<float2*>(pk + 8 * W + col) =
                make_float2(dk[c][4 * j + 2] * p.scale, dk[c][4 * j + 3] * p.scale);
        }
      }
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j;
        if (col < p.Dv) {
          if (st0)
            *reinterpret_cast<float2*>(pk + DQ + col) = make_float2(dv[c][4 * j], dv[c][4 * j + 1]);
          if (st1)
            *reinterpret_cast<float2*>(pk + 8 * W + DQ + col) =
                make_float2(dv[c][4 * j + 2], dv[c][4 * j + 3]);
        }
      }
  }
}

// dk and dv from the splits' shares, summed in split order (deterministic)
// and rounded once, two columns a thread (grid: x over a kv head's rows, y
// over the (b, kv head) pairs, strided)
__global__ void __launch_bounds__(256) flash_bwd_combine(const Params p) {
  const int width = p.DQ + (p.Dv + 63) / 64 * 64, n2 = (p.D + p.Dv) / 2, per = p.Sk * n2;
  const long long split_stride = (long long)p.B * p.KV * p.Sk * width;
  for (int bk = blockIdx.y; bk < p.B * p.KV; bk += gridDim.y) {
    const int b = bk / p.KV, kvh = bk % p.KV;
    const float* src = p.part + (long long)bk * p.Sk * width;
    for (int idx = blockIdx.x * 256 + threadIdx.x; idx < per; idx += gridDim.x * 256) {
      const int key = idx / n2, col = (idx - key * n2) * 2;
      const bool is_k = col < p.D;
      const float* s = src + (long long)key * width + (is_k ? col : p.DQ + col - p.D);
      float x = 0.f, y = 0.f;
      for (int sp = 0; sp < p.nsplit; ++sp) {
        const float2 v = *reinterpret_cast<const float2*>(s + sp * split_stride);
        x += v.x;
        y += v.y;
      }
      __nv_bfloat16* d = is_k ? p.dk + b * p.dks[0] + kvh * p.dks[1] + key * p.dks[2] + col
                              : p.dv + b * p.dvs[0] + kvh * p.dvs[1] + key * p.dvs[2] + col - p.D;
      *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(x, y);
    }
  }
}

template <int DQ, int DV>
int launch_main(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                const CUtensorMap& tdo, const Params& p, cudaStream_t stream) {
  const int bytes = Smem<DQ, DV>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_wgmma<DQ, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (p.Sk + BN - 1) / BN * p.KV * p.B * p.nsplit;
  flash_bwd_wgmma<DQ, DV><<<blocks, THREADS, bytes, stream>>>(tq, tk, tv, tdo, p);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, o, dO, dq, dk, dv; lse fp32 [B, H, Sq] contiguous (the
// forward's).  scratch: fp32, 16-byte aligned, B·H·Sq_pad·(DQ + 2)
// elements (Sq_pad = Sq rounded up to 64, DQ = D rounded up to 64) — the dQ
// accumulator, lse2 and delta — and, when nsplit > 1, nsplit·B·KV·Sk·(DQ +
// DV) more for the splits' dK/dV shares; the call fills it.  strides: 24
// element strides, (b, h, s) of q, k, v, o, dO, dq, dk, dv in that order,
// those of q, k, v and dO multiples of 8 (16 bytes, for TMA) and the
// others even, each tensor's last axis contiguous, base pointers 16-byte
// aligned (4 for o, dq, dk, dv).  window <= 0: no window.  D and Dv
// multiples of 16 whose instance (each rounded up to 64) is (64, 64),
// (128, 128) or (192, 128).  nsplit: blocks each GQA group's heads are
// split over, 1 .. H / KV.  Launches: delta / lse2 / the zeroed
// accumulator, dK / dV / dQ, dq, and with nsplit > 1 the dK / dV sum.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dO, const float* lse,
    float* scratch, void* dq, void* dk, void* dv, const long long* strides, int B, int H, int KV,
    int Sq, int Sk, int D, int Dv, int causal, int window, int q_off, int nsplit, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || D < 16 || D % 16 != 0 || Dv < 16 || Dv % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int dq_i = (D + 63) / 64 * 64, dv_i = (Dv + 63) / 64 * 64;
  if (!((dq_i == dv_i && dq_i <= 128) || (dq_i == 192 && dv_i == 128)))
    return (int)cudaErrorInvalidValue;
  if (nsplit < 1 || nsplit > H / KV) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, strides, B, H, Sq, D, BM) ||
      !make_map(&tk, k, strides + 3, B, KV, Sk, D, BN) ||
      !make_map(&tv, v, strides + 6, B, KV, Sk, Dv, BN) ||
      !make_map(&tdo, dO, strides + 12, B, H, Sq, Dv, BM))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dO = static_cast<const __nv_bfloat16*>(dO);
  p.lse = lse;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  long long* dst[5] = {p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[9 + 3 * t + i];
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Sq_pad = (Sq + BM - 1) / BM * BM;
  p.D = D;
  p.Dv = Dv;
  p.DQ = dq_i;
  p.group = H / KV;
  p.nsplit = nsplit;
  p.gper = (p.group + nsplit - 1) / nsplit;
  p.causal = causal;
  p.window = window;
  p.q_off = q_off;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  const long long rows = (long long)B * H * p.Sq_pad;
  p.acc = scratch;
  p.lse2 = scratch + rows * dq_i;
  p.delta = p.lse2 + rows;
  p.part = p.delta + rows;
  int dev = 0, e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&p.wave, cudaDevAttrMultiProcessorCount, dev);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned heads = (unsigned)(B * H < 65535 ? B * H : 65535);
  flash_bwd_pre<<<dim3((unsigned)(p.Sq_pad / 16), heads), 256, 0, st>>>(p);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  if (dq_i == 192)
    e = launch_main<192, 128>(tq, tk, tv, tdo, p, st);
  else if (dq_i == 64)
    e = launch_main<64, 64>(tq, tk, tv, tdo, p, st);
  else
    e = launch_main<128, 128>(tq, tk, tv, tdo, p, st);
  if (e != 0) return e;
  const int per = p.Sq_pad / 64 * (dq_i / 64) * 1024;  // a head's float4s
  flash_bwd_post<<<dim3((unsigned)((per + 255) / 256), heads), 256, 0, st>>>(p);
  e = (int)cudaGetLastError();
  if (e != 0 || nsplit == 1) return e;
  const int per_kv = Sk * ((D + Dv) / 2);  // 2 columns a thread
  flash_bwd_combine<<<dim3((unsigned)((per_kv + 255) / 256),
                           (unsigned)(B * KV < 65535 ? B * KV : 65535)),
                      256, 0, st>>>(p);
  return (int)cudaGetLastError();
}
