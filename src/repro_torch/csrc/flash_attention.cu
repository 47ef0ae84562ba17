// flash_attention: online-softmax attention with GQA head mapping and
// causal / sliding-window masks from global positions.
//
// Replaces flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py).
//
// q is [B, H, Sq, D], k and v [B, KV, Sk, D], o [B, H, Sq, D], each with
// any strides over (b, h, s) and D contiguous, so the model's [B, S, H, D]
// tensors go in and come out without a transpose copy.  Query row i sits
// at position q_off + i, key j at j; q-head h reads kv-head h / (H / KV).
// One 128-thread block owns one (b, h, 64-row q tile); each of its four
// warps owns 16 query rows.  The block walks the 64-key tiles in a loop
// (the TPU kernel's sequential grid axis ik): K and V tiles are staged in
// shared memory, each warp computes its 16 x 64 scores, folds them into a
// running max m, sum l and output accumulator (all fp32, NEG_INF = -1e30,
// l clamped at 1e-30 at the end, as in the Pallas kernel), and rounds the
// probabilities P to the value type before P·V, as p.astype(v.dtype)
// does there.  Masked entries get p = 0, so a row with no visible key is
// 0, as in the plain version (the Pallas kernel gives such a row the mean
// of V; every row of the model's path sees at least itself).  Tiles wholly
// above the causal diagonal or wholly outside the window are skipped, and
// the q tiles run heaviest first (the causal work grows with the tile).
//
// Arithmetic: bf16 inputs run both products (Q·K^T and P·V) on the tensor
// cores through WMMA (mma.sync, 16x16x16 bf16, fp32 accumulation); fp32
// inputs run them as fp32 FMAs on CUDA cores (exact products, fp32 sums).
// Softmax statistics and the accumulator are fp32 in both.  So the result
// differs from the plain version by summation order, and in bf16 by the
// rounding of P and of the output (each at most half a bf16 ulp).
//
// Bound on an H100 at the serve path's shape (B 4, H 16, KV 8, S 2048,
// D 128, causal, bf16): operations.  4·D FLOPs per visible (q, k) pair,
// 68.7 GFLOP, over 989 TFLOP/s is 0.069 ms, against 0.030 ms for the
// 100.7 MB of Q, K, V and O.  This first kernel is far from that: scores,
// probabilities and each 16x16 P·V tile make a round trip through shared
// memory (WMMA fragments have no documented register layout, so the
// per-row softmax cannot be applied in registers), K/V loads are not
// overlapped with compute, and 81 KB of shared memory per block allows
// two blocks per SM.  wgmma with TMA and register-resident softmax is the
// later design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of (b, h, s)
  int H, Sq, Sk, group;                   // group = H / KV
  int causal, window, q_off;              // window <= 0: none
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }  // the fp32 path's loads
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory of one block, in bytes from the base: Q, K, V tiles of T
// with rows padded by 16 bytes, fp32 scores per warp, and (bf16 only) P and
// one 16x16 P·V tile per warp.  Every WMMA pointer lands on 32 bytes.
template <typename T, int D>
struct Layout {
  static constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LD = D + 16 / (int)sizeof(T);  // Q/K/V row stride
  static constexpr int LDS = BK + 4;                  // score row stride
  static constexpr int LDP = BK + 8;                  // P row stride
  static constexpr int TILE = BQ * LD * (int)sizeof(T);
  static constexpr int S_OFF = 3 * TILE;
  static constexpr int P_OFF = S_OFF + WARPS * 16 * LDS * 4;
  static constexpr int O_OFF = P_OFF + (TC ? WARPS * 16 * LDP * 2 : 0);
  static constexpr int BYTES = O_OFF + (TC ? WARPS * 16 * 16 * 4 : 0);
};

// rows [0, 64) of a tile from global rows with stride ld_g (elements);
// rows at or past `valid` are zero.  16-byte copies.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, const T* __restrict__ src,
                                          long long ld_g, int valid) {
  constexpr int CH = D * (int)sizeof(T) / 16;
  constexpr int LD = Layout<T, D>::LD;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = __ldg(reinterpret_cast<const uint4*>(src + r * ld_g) + c);
    reinterpret_cast<uint4*>(dst + r * LD)[c] = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd(Params p) {
  using L = Layout<T, D>;
  constexpr int LD = L::LD, LDS = L::LDS, LDP = L::LDP;
  constexpr int NT = D / 16;  // 16-wide column tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + L::TILE);
  T* Vs = reinterpret_cast<T*>(smem + 2 * L::TILE);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;  // this lane's row and column half
  float* Sw = reinterpret_cast<float*>(smem + L::S_OFF) + warp * 16 * LDS;
  __nv_bfloat16* Pw = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF) + warp * 16 * LDP;
  float* Ow = reinterpret_cast<float*>(smem + L::O_OFF) + warp * 16 * 16;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.group;
  const int q0 = qt * BQ;
  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[1];
  load_tile<T, D>(Qs, qg, p.qs[2], p.Sq - q0);

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

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[L::TC ? NT : 1];
  __syncthreads();
  if constexpr (L::TC) {
#pragma unroll
    for (int kk = 0; kk < NT; ++kk)
      wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * LD + kk * 16, LD);
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile<T, D>(Ks, kg + k0 * p.ks[2], p.ks[2], p.Sk - k0);
    load_tile<T, D>(Vs, vg + k0 * p.vs[2], p.vs[2], p.Sk - k0);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows, into Sw
    if constexpr (L::TC) {
#pragma unroll
      for (int nt = 0; nt < BK / 16; ++nt) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, Ks + nt * 16 * LD + kk * 16, LD);
          wmma::mma_sync(c, qf[kk], kf, c);
        }
        wmma::store_matrix_sync(Sw + nt * 16, c, LDS, wmma::mem_row_major);
      }
    } else {
      const T* qr = Qs + (warp * 16 + r) * LD;
      for (int j = 0; j < BK / 2; ++j) {
        const T* kr = Ks + (half + 2 * j) * LD;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(to_f(qr[d]), to_f(kr[d]), s);
        Sw[r * LDS + half + 2 * j] = s;
      }
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
      if constexpr (L::TC)
        Pw[r * LDP + half + 2 * j] = __float2bfloat16(pj);
      else
        Sw[r * LDS + half + 2 * j] = pj;
    }
    lsum += __shfl_xor_sync(FULL, lsum, 1);
    l = l * alpha + lsum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NT * 8; ++i) acc[i] *= alpha;
    __syncwarp();

    // acc += P V
    if constexpr (L::TC) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wmma::load_matrix_sync(pf[kk], Pw + kk * 16, LDP);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, Vs + kk * 16 * LD + nt * 16, LD);
          wmma::mma_sync(c, pf[kk], vf, c);
        }
        wmma::store_matrix_sync(Ow, c, 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[nt * 8 + j] += Ow[r * 16 + half * 8 + j];
        __syncwarp();
      }
    } else {
      for (int c = 0; c < BK; ++c) {
        const float pc = Sw[r * LDS + c];
        const T* vr = Vs + c * LD + half * 8;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[nt * 8 + j] = fmaf(pc, to_f(vr[nt * 16 + j]), acc[nt * 8 + j]);
      }
    }
  }

  if (qrow >= p.Sq) return;
  const float lc = fmaxf(l, 1e-30f);
  T* og = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[1] + qrow * p.os[2] + half * 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 8; ++j) og[nt * 16 + j] = from_f<T>(acc[nt * 8 + j] / lc);
}

template <typename T, int D>
int launch_t(const Params& p, int B, cudaStream_t stream) {
  const int bytes = Layout<T, D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_fwd<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_t<T, 16>(p, B, stream);
    case 32: return launch_t<T, 32>(p, B, stream);
    case 48: return launch_t<T, 48>(p, B, stream);
    case 64: return launch_t<T, 64>(p, B, stream);
    case 80: return launch_t<T, 80>(p, B, stream);
    case 96: return launch_t<T, 96>(p, B, stream);
    case 112: return launch_t<T, 112>(p, B, stream);
    case 128: return launch_t<T, 128>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0: fp32, 1: bf16.  strides: 12 element strides, (b, h, s) of q, k,
// v and o in that order.  window <= 0: no window.  Sq, Sk >= 1.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* o, const long long* strides, int B, int H, int KV,
                                      int Sq, int Sk, int D, int causal, int window, int q_off,
                                      float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  return dtype == 1 ? launch_d<__nv_bfloat16>(p, B, D, st) : launch_d<float>(p, B, D, st);
}
