// flash_attention_bwd (fp32 route): the gradient of flash attention on the
// CUDA cores; bf16 inputs take the Hopper route
// (flash_attention_bwd_sm90.cu: TMA, wgmma).  Given q [B, H, Sq, D], k [B,
// KV, Sk, D], v [B, KV, Sk, Dv], the forward's output o [B, H, Sq, Dv], its
// row log-sum-exp lse [B, H, Sq] (fp32, natural log of Σ_j
// exp(scale·q_i·k_j) over the visible keys) and the output's gradient dO
// [B, H, Sq, Dv], it writes dq, dk and dv in the inputs' layout (fp32; any
// strides over (b, h, s), the last axis contiguous).  dk and dv are summed over each GQA group inside
// the kernel.  Masks as in the forward: causal, sliding window, queries at
// q_off + i, keys at j, Sk any length.
//
// Replaces no TPU kernel: the JAX package has no backward kernel and lets
// XLA differentiate its query-chunked reference path.  The port trains
// through the forward kernel (flash_attention_sm90.cu, flash_attention.cu),
// which writes lse when asked, and this kernel computes the same gradients
// as that reference path: with P = exp(scale·S − lse) (S = Q·K^T, masked
// entries 0) and delta_i = Σ_e dO_ie·O_ie,
//     dV = P^T·dO,  dP = dO·V^T,  dS = P ∘ (dP − delta),
//     dQ = scale·dS·K,  dK = scale·dS^T·Q.
//
// Design (FlashAttention-2's two passes, no atomics, deterministic):
//  * flash_bwd_dq: one 256-thread block per (b, h, 64-row query tile),
//    heaviest causal tile first.  It computes delta for its rows (and
//    stores it for the second pass), then walks the visible 64-key tiles:
//    recompute S and dP, form P and dS in shared memory, dQ += dS·K in
//    registers.
//  * flash_bwd_dkdv: one block per (b, kv-head, 64-key tile).  K and V stay
//    in shared memory; the block walks the group's q-heads and, for each,
//    the query tiles that can see its keys: recompute P and dS, then
//    dV += P^T·dO and dK += dS^T·Q in registers.  Launched after
//    flash_bwd_dq on the same stream, so delta is in place.
//  * Tiles are staged in shared memory as fp32 rows padded to an odd
//    length (D + 1 floats), so the 16 key rows that a warp reads at one
//    column fall in 16 banks.  Each thread owns a 4 x 4 block of the
//    64 x 64 score tile (rows ty + 16r, keys tx + 16c) and of every
//    accumulator (rows ty + 16r, columns tx + 16c).
//  * The head dims run in instances (DQ, DV) of (64, 64), (128, 128) and
//    (192, 128), as the forward's bf16 route: a narrower head dim is
//    zero-filled past D in shared memory and its columns are not stored.
//    Shared memory: 194 KB at (192, 128), 162 KB at (128, 128).
//  * Arithmetic in fp32 FMAs throughout.
//
// Bound on an H100: operations.  The five products cost 2·(3·D + 2·Dv)
// FLOPs per visible (query, key) pair (S and dQ and dK over D; dP and dV
// over Dv); over the 989 TFLOP/s of the bf16 tensor cores that is 0.174
// ms at qwen3-1.7b's 4 x 2048 causal, 16/8 heads x 128.  fp32 has no
// tensor-core route here, so the kernel runs on the CUDA cores (67 TFLOP/s
// of fp32 FMA at most, shared-memory loads before that) and sits far from
// that bound; training runs in bf16, on flash_attention_bwd_sm90.cu.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int THREADS = 256;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dO;
  float* dq;
  float* dk;
  float* dv;
  const float* lse;  // [B, H, Sq], contiguous
  float* delta;      // [B, H, Sq], contiguous: written by flash_bwd_dq
  // element strides of (b, h, s): q, k, v, o, dO, dq, dk, dv
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int H, Sq, Sk, D, Dv, group;  // group = H / KV
  int causal, window, q_off;    // window <= 0: none
  float scale;
};

// Shared memory in floats: Q, K (rows of DQ + 1), dO, V (rows of DV + 1),
// P and dS (64 x 65), then the tile's lse and delta.
template <int DQ, int DV>
struct Smem {
  static constexpr int LQ = DQ + 1;
  static constexpr int LV = DV + 1;
  static constexpr int LP = BK + 1;
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LQ;
  static constexpr int DO = K + BK * LQ;
  static constexpr int V = DO + BQ * LV;
  static constexpr int P = V + BK * LV;
  static constexpr int DS = P + BQ * LP;
  static constexpr int LSE = DS + BQ * LP;
  static constexpr int DELTA = LSE + BQ;
  static constexpr int BYTES = (DELTA + BQ) * 4;
  static_assert(BYTES <= 227 * 1024, "shared memory past the 227 KB a block may take");
};

// rows [0, 64) x columns [0, DP) of a tile into fp32 shared rows of `ld`
// floats, from global rows `ld_g` elements apart; rows at or past `valid`
// and columns at or past `d` are zero
template <int DP>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const float* __restrict__ src, long long ld_g,
                                          int valid, int d) {
  for (int idx = threadIdx.x; idx < 64 * DP; idx += THREADS) {
    const int r = idx / DP, c = idx % DP;
    float x = 0.f;
    if (r < valid && c < d) x = src[r * ld_g + c];
    dst[r * ld + c] = x;
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qrow, int key) {
  const int pos = p.q_off + qrow;
  return qrow < p.Sq && key < p.Sk && (!p.causal || key <= pos) &&
         (p.window <= 0 || pos - key < p.window);
}

// P and dS of the 64 x 64 tile (queries q0 + i, keys k0 + j) into shared
// memory, from Q, K, dO, V and the rows' lse and delta there
template <int DQ, int DV>
__device__ __forceinline__ void p_and_ds(const Params& p, float* smem, int q0, int k0) {
  using L = Smem<DQ, DV>;
  const float* Qs = smem + L::Q;
  const float* Ks = smem + L::K;
  const float* dOs = smem + L::DO;
  const float* Vs = smem + L::V;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DQ; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = Qs[(ty + 16 * r) * L::LQ + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = Ks[(tx + 16 * c) * L::LQ + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
  }
#pragma unroll 4
  for (int e = 0; e < DV; ++e) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = dOs[(ty + 16 * r) * L::LV + e];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = Vs[(tx + 16 * c) * L::LV + e];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[r][c] = fmaf(a[r], b[c], dp[r][c]);
  }
  float* Ps = smem + L::P;
  float* dSs = smem + L::DS;
  const float* lse = smem + L::LSE;
  const float* delta = smem + L::DELTA;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const float pv = visible(p, q0 + i, k0 + j) ? expf(fmaf(s[r][c], p.scale, -lse[i])) : 0.f;
      Ps[i * L::LP + j] = pv;
      dSs[i * L::LP + j] = pv * (dp[r][c] - delta[i]);
    }
  }
}

// dQ: one block per (b, h, 64-row query tile)
template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq(Params p) {
  using L = Smem<DQ, DV>;
  extern __shared__ __align__(16) float smem[];
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.group;
  const int q0 = qt * BQ;
  const int valid_q = p.Sq - q0;
  const float* qg = p.q + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2];
  const float* dog = p.dO + b * p.dos[0] + h * p.dos[1] + q0 * p.dos[2];
  const float* og = p.o + b * p.os[0] + h * p.os[1] + q0 * p.os[2];
  const float* kg = p.k + b * p.ks[0] + kvh * p.ks[1];
  const float* vg = p.v + b * p.vs[0] + kvh * p.vs[1];
  const long long row0 = ((long long)b * p.H + h) * p.Sq + q0;  // lse / delta index of row 0

  load_tile<DQ>(smem + L::Q, L::LQ, qg, p.qs[2], valid_q, p.D);
  load_tile<DV>(smem + L::DO, L::LV, dog, p.dos[2], valid_q, p.Dv);
  __syncthreads();
  // delta = rowsum(dO ∘ O): warp w takes rows 8w .. 8w + 7
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int rr = 0; rr < 8; ++rr) {
      const int i = warp * 8 + rr;
      float acc = 0.f;
      if (i < valid_q)
        for (int e = lane; e < p.Dv; e += 32)
          acc = fmaf(smem[L::DO + i * L::LV + e], og[i * p.os[2] + e], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        smem[L::DELTA + i] = acc;
        smem[L::LSE + i] = i < valid_q ? p.lse[row0 + i] : 0.f;
        if (i < valid_q) p.delta[row0 + i] = acc;
      }
    }
  }

  // keys any row of the tile can see
  int k_lo = 0, k_hi = p.Sk;
  if (p.causal) k_hi = min(p.Sk, p.q_off + min(q0 + BQ, p.Sq));
  if (p.window > 0) k_lo = max(0, p.q_off + q0 - p.window + 1);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int NC = DQ / 16;
  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's K and dS are no longer read
    load_tile<DQ>(smem + L::K, L::LQ, kg + k0 * p.ks[2], p.ks[2], p.Sk - k0, p.D);
    load_tile<DV>(smem + L::V, L::LV, vg + k0 * p.vs[2], p.vs[2], p.Sk - k0, p.Dv);
    __syncthreads();
    p_and_ds<DQ, DV>(p, smem, q0, k0);
    __syncthreads();
    const float* dSs = smem + L::DS;
    const float* Ks = smem + L::K;
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[r] = dSs[(ty + 16 * r) * L::LP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = Ks[j * L::LQ + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(ds[r], kv, acc[r][c]);
      }
    }
  }

  float* dqg = p.dq + b * p.dqs[0] + h * p.dqs[1] + q0 * p.dqs[2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (i >= valid_q) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) dqg[i * p.dqs[2] + d] = acc[r][c] * p.scale;
    }
  }
}

// dK and dV: one block per (b, kv-head, 64-key tile), over the group's heads
template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv(Params p) {
  using L = Smem<DQ, DV>;
  extern __shared__ __align__(16) float smem[];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;  // the causally heaviest (earliest) keys first
  const int valid_k = p.Sk - k0;
  load_tile<DQ>(smem + L::K, L::LQ, p.k + b * p.ks[0] + kvh * p.ks[1] + k0 * p.ks[2], p.ks[2],
                valid_k, p.D);
  load_tile<DV>(smem + L::V, L::LV, p.v + b * p.vs[0] + kvh * p.vs[1] + k0 * p.vs[2], p.vs[2],
                valid_k, p.Dv);

  // query rows that can see any key of the tile
  int i_lo = 0, i_hi = p.Sq;
  if (p.causal) i_lo = max(0, k0 - p.q_off);
  if (p.window > 0) i_hi = min(p.Sq, k0 + BK - 1 + p.window - p.q_off);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int NK = DQ / 16, NV = DV / 16;
  float dk[4][NK], dv[4][NV];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < NK; ++c) dk[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) dv[r][c] = 0.f;
  }

  for (int g = 0; g < p.group; ++g) {
    const int h = kvh * p.group + g;
    const long long rows = ((long long)b * p.H + h) * p.Sq;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      const int valid_q = p.Sq - q0;
      __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
      load_tile<DQ>(smem + L::Q, L::LQ, p.q + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2],
                    p.qs[2], valid_q, p.D);
      load_tile<DV>(smem + L::DO, L::LV, p.dO + b * p.dos[0] + h * p.dos[1] + q0 * p.dos[2],
                    p.dos[2], valid_q, p.Dv);
      if (threadIdx.x < BQ) {
        const int i = threadIdx.x;
        smem[L::LSE + i] = i < valid_q ? p.lse[rows + q0 + i] : 0.f;
        smem[L::DELTA + i] = i < valid_q ? p.delta[rows + q0 + i] : 0.f;
      }
      __syncthreads();
      p_and_ds<DQ, DV>(p, smem, q0, k0);
      __syncthreads();
      const float* Ps = smem + L::P;
      const float* dSs = smem + L::DS;
      const float* Qs = smem + L::Q;
      const float* dOs = smem + L::DO;
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pj[4], dsj[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pj[r] = Ps[i * L::LP + ty + 16 * r];
          dsj[r] = dSs[i * L::LP + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const float o = dOs[i * L::LV + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) dv[r][c] = fmaf(pj[r], o, dv[r][c]);
        }
#pragma unroll
        for (int c = 0; c < NK; ++c) {
          const float qv = Qs[i * L::LQ + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) dk[r][c] = fmaf(dsj[r], qv, dk[r][c]);
        }
      }
    }
  }

  float* dkg = p.dk + b * p.dks[0] + kvh * p.dks[1] + k0 * p.dks[2];
  float* dvg = p.dv + b * p.dvs[0] + kvh * p.dvs[1] + k0 * p.dvs[2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty + 16 * r;
    if (j >= valid_k) continue;
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) dkg[j * p.dks[2] + d] = dk[r][c] * p.scale;
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int e = tx + 16 * c;
      if (e < p.Dv) dvg[j * p.dvs[2] + e] = dv[r][c];
    }
  }
}

template <int DQ, int DV>
int launch_t(const Params& p, int B, int KV, cudaStream_t stream) {
  const int bytes = Smem<DQ, DV>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq<DQ, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv<DQ, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<DQ, DV><<<dim3((p.Sq + BQ - 1) / BQ, p.H, B), THREADS, bytes, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv<DQ, DV><<<dim3((p.Sk + BK - 1) / BK, KV, B), THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_dp(const Params& p, int B, int KV, cudaStream_t stream) {
  const int dq = (p.D + 63) / 64 * 64, dv = (p.Dv + 63) / 64 * 64;
  if (dq == 192 && dv == 128) return launch_t<192, 128>(p, B, KV, stream);
  if (dq != dv) return (int)cudaErrorInvalidValue;
  if (dq == 64) return launch_t<64, 64>(p, B, KV, stream);
  if (dq == 128) return launch_t<128, 128>(p, B, KV, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// fp32 q, k, v, o, dO, dq, dk, dv; lse and delta fp32 [B, H, Sq]
// contiguous (delta is scratch the call fills).  strides: 24 element
// strides, (b, h, s) of q, k, v, o, dO, dq, dk, dv in that order, each
// tensor's last axis contiguous.  window <= 0: no window.  B, H, Sq, Sk >=
// 1; D and Dv multiples of 16 whose instance (each rounded up to 64) is
// (64, 64), (128, 128) or (192, 128).  Two launches: dQ (and delta), then
// dK and dV.
extern "C" int flash_attention_bwd_launch(const float* q, const float* k, const float* v,
                                          const float* o, const float* dO, const float* lse,
                                          float* delta, float* dq, float* dk, float* dv,
                                          const long long* strides, int B, int H, int KV, int Sq,
                                          int Sk, int D, int Dv, int causal, int window,
                                          int q_off, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || D < 16 || D % 16 != 0 || Dv < 16 || Dv % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dO = dO;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  p.delta = delta;
  long long* dst[8] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.Dv = Dv;
  p.group = H / KV;
  p.causal = causal;
  p.window = window;
  p.q_off = q_off;
  p.scale = scale;
  return launch_dp(p, B, KV, (cudaStream_t)stream);
}
