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

#include "flash_sm90.cuh"

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
