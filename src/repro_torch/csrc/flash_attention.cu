// flash_attention (fp32 route): online-softmax attention with GQA head
// mapping and causal / sliding-window masks from global positions, on the
// CUDA cores.  bf16 inputs take the Hopper route instead
// (flash_attention_sm90.cu: TMA, wgmma, softmax in registers).
//
// Replaces flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py) for fp32 inputs.
//
// q is [B, H, Sq, D], k [B, KV, Sk, D], v [B, KV, Sk, Dv], o [B, H, Sq,
// Dv], each with any strides over (b, h, s) and the last axis contiguous,
// so the model's [B, S, H, D] tensors go in and come out without a
// transpose copy.  Query row i sits at position q_off + i, key j at j;
// q-head h reads kv-head h / (H / KV).  D = Dv takes 16 ... 128 in steps
// of 16; (D, Dv) = (192, 128) is MLA's prefill.
// One 128-thread block owns one (b, h, 64-row q tile); each of its four
// warps owns 16 query rows.  The block walks the 64-key tiles in a loop
// (the TPU kernel's sequential grid axis ik): K and V tiles are staged in
// shared memory, each warp computes its 16 x 64 scores, folds them into a
// running max m, sum l and output accumulator (all fp32, NEG_INF = -1e30,
// l clamped at 1e-30 at the end, as in the Pallas kernel).  Masked entries
// get p = 0, so a row with no visible key is 0, as in the plain version
// (the Pallas kernel gives such a row the mean of V; every row of the
// model's path sees at least itself).  Tiles wholly above the causal
// diagonal or wholly outside the window are skipped, and the q tiles run
// heaviest first (the causal work grows with the tile).
//
// Arithmetic: both products (Q·K^T and P·V) are fp32 FMAs (exact
// products, fp32 sums), so the result differs from the plain version by
// summation order only.
//
// Bound on an H100: operations, 4·D FLOPs per visible (q, k) pair over the
// 67 TFLOP/s of fp32 outside the tensor cores.  No path of the port runs
// fp32 attention at scale (the model computes in bf16); this kernel is
// the exact route the card tests hold the masks and GQA mapping with.
//
// With a non-null lse pointer (training: the autograd Function of
// kernels/flash_attention/ops.py) the epilogue also stores each row's
// log-sum-exp m + log(l) for flash_attention_bwd.cu.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;                             // [B, H, Sq] row log-sum-exp, or null
  long long qs[3], ks[3], vs[3], os[3];  // element strides of (b, h, s)
  int H, Sq, Sk, group;                   // group = H / KV
  int causal, window, q_off;              // window <= 0: none
  float scale;
};

// Shared memory of one block, in bytes from the base: Q, K, V tiles with
// rows padded by 16 bytes, then fp32 scores (and P) per warp.
template <int D, int DV>
struct Layout {
  static constexpr int LD = D + 4;    // Q/K row stride, floats
  static constexpr int LDV = DV + 4;  // V row stride
  static constexpr int LDS = BK + 4;  // score row stride
  static constexpr int TILE = BQ * LD * 4;
  static constexpr int V_OFF = 2 * TILE;
  static constexpr int S_OFF = V_OFF + BQ * LDV * 4;
  static constexpr int BYTES = S_OFF + WARPS * 16 * LDS * 4;
};

// rows [0, 64) of a tile of D columns from global rows with stride ld_g
// (elements) into rows of D + 4 floats; rows at or past `valid` are zero.
// 16-byte copies.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          long long ld_g, int valid) {
  constexpr int CH = D / 4;
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = __ldg(reinterpret_cast<const float4*>(src + r * ld_g) + c);
    reinterpret_cast<float4*>(dst + r * LD)[c] = val;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS) flash_fwd(Params p) {
  using L = Layout<D, DV>;
  constexpr int LD = L::LD, LDV = L::LDV, LDS = L::LDS;
  constexpr int NT = DV / 16;  // 16-wide column tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = reinterpret_cast<float*>(smem + L::TILE);
  float* Vs = reinterpret_cast<float*>(smem + L::V_OFF);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;  // this lane's row and column half
  float* Sw = reinterpret_cast<float*>(smem + L::S_OFF) + warp * 16 * LDS;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.group;
  const int q0 = qt * BQ;
  const float* qg = p.q + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2];
  const float* kg = p.k + b * p.ks[0] + kvh * p.ks[1];
  const float* vg = p.v + b * p.vs[0] + kvh * p.vs[1];
  load_tile<D>(Qs, qg, p.qs[2], p.Sq - q0);

  const int qrow = q0 + warp * 16 + r;
  const int qpos = p.q_off + qrow;
  // keys any row of the block can see
  int k_lo = 0, k_hi = p.Sk;
  if (p.causal) k_hi = min(p.Sk, p.q_off + min(q0 + BQ, p.Sq));
  if (p.window > 0) k_lo = max(0, p.q_off + q0 - p.window + 1);

  float m = NEG_INF, l = 0.f;
  float acc[NT * 8];  // acc[nt*8 + j] holds column nt*16 + half*8 + j
#pragma unroll
  for (int i = 0; i < NT * 8; ++i) acc[i] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // Q is in; the previous tile's K and V are no longer read
    load_tile<D>(Ks, kg + k0 * p.ks[2], p.ks[2], p.Sk - k0);
    load_tile<DV>(Vs, vg + k0 * p.vs[2], p.vs[2], p.Sk - k0);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows, into Sw
    const float* qr = Qs + (warp * 16 + r) * LD;
    for (int j = 0; j < BK / 2; ++j) {
      const float* kr = Ks + (half + 2 * j) * LD;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      Sw[r * LDS + half + 2 * j] = s;
    }
    __syncwarp();

    // online softmax of row r over this lane's 32 columns (half + 2j)
    float sv[BK / 2];
    float mloc = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int key = k0 + half + 2 * j;
      const bool vis = key < p.Sk && (!p.causal || key <= qpos) &&
                       (p.window <= 0 || qpos - key < p.window);
      sv[j] = vis ? Sw[r * LDS + half + 2 * j] * p.scale : -CUDART_INF_F;
      mloc = fmaxf(mloc, sv[j]);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(FULL, mloc, 1));
    const float m_new = fmaxf(m, mloc);
    const float alpha = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float pj = expf(sv[j] - m_new);  // 0 where masked
      lsum += pj;
      Sw[r * LDS + half + 2 * j] = pj;
    }
    lsum += __shfl_xor_sync(FULL, lsum, 1);
    l = l * alpha + lsum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NT * 8; ++i) acc[i] *= alpha;
    __syncwarp();

    // acc += P V
    for (int c = 0; c < BK; ++c) {
      const float pc = Sw[r * LDS + c];
      const float* vr = Vs + c * LDV + half * 8;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[nt * 8 + j] = fmaf(pc, vr[nt * 16 + j], acc[nt * 8 + j]);
    }
  }

  if (qrow >= p.Sq) return;
  // the backward's row statistic, natural log; +inf for a row with no key
  if (p.lse != nullptr && half == 0)
    p.lse[((long long)b * p.H + h) * p.Sq + qrow] = l > 0.f ? m + logf(l) : CUDART_INF_F;
  const float lc = fmaxf(l, 1e-30f);
  float* og = p.o + b * p.os[0] + h * p.os[1] + qrow * p.os[2] + half * 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 8; ++j) og[nt * 16 + j] = acc[nt * 8 + j] / lc;
}

template <int D, int DV = D>
int launch_t(const Params& p, int B, cudaStream_t stream) {
  const int bytes = Layout<D, DV>::BYTES;
  cudaError_t e =
      cudaFuncSetAttribute(flash_fwd<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_fwd<D, DV><<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 q, k, v, o.  lse: null, or fp32 [B, H, Sq] contiguous, which gets
// each row's log-sum-exp of its scaled scores (the backward's input; the
// serving path passes null).  strides: 12 element strides, (b, h, s) of q,
// k, v and o in that order.  window <= 0: no window.  Sq, Sk >= 1.  (D,
// Dv): D = Dv a multiple of 16 up to 128, or (192, 128).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      float* lse, const long long* strides, int B, int H,
                                      int KV, int Sq, int Sk, int D, int Dv, int causal,
                                      int window, int q_off, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = lse;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.group = H / KV;
  p.causal = causal;
  p.window = window;
  p.q_off = q_off;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 192 && Dv == 128) return launch_t<192, 128>(p, B, st);
  if (Dv != D) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_t<16>(p, B, st);
    case 32: return launch_t<32>(p, B, st);
    case 48: return launch_t<48>(p, B, st);
    case 64: return launch_t<64>(p, B, st);
    case 80: return launch_t<80>(p, B, st);
    case 96: return launch_t<96>(p, B, st);
    case 112: return launch_t<112>(p, B, st);
    case 128: return launch_t<128>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
