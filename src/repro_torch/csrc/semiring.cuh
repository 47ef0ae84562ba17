// Semirings as template parameters: a functor for ⊕, one for ⊗, and a zero.
//
// Every registered semiring of repro_torch.core.semiring has one instance
// here; the Python wrappers pass its index (SEMIRING_IDS in
// repro_torch/kernels/cuda_lib.py) and SR_DISPATCH picks the template.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct OpPlus {
  __device__ __forceinline__ static float apply(float a, float b) { return a + b; }
};
struct OpTimes {
  __device__ __forceinline__ static float apply(float a, float b) { return a * b; }
};
struct OpMax {
  __device__ __forceinline__ static float apply(float a, float b) { return fmaxf(a, b); }
};
struct OpMin {
  __device__ __forceinline__ static float apply(float a, float b) { return fminf(a, b); }
};

// Zero of ⊕ (annihilator of ⊗): 0, -inf or +inf.
enum ZeroKind { ZERO_0 = 0, ZERO_NEG_INF = 1, ZERO_POS_INF = 2 };

template <class Add, class Mul, int Z>
struct Semiring {
  __device__ __forceinline__ static float zero() {
    return Z == ZERO_0 ? 0.0f : (Z == ZERO_NEG_INF ? -INFINITY : INFINITY);
  }
  __device__ __forceinline__ static float add(float a, float b) { return Add::apply(a, b); }
  __device__ __forceinline__ static float mul(float a, float b) { return Mul::apply(a, b); }
  // acc ⊕ (a ⊗ b); (+, ×) is one fp32 fused multiply-add (no TF32)
  __device__ __forceinline__ static float mac(float acc, float a, float b) {
    return Add::apply(acc, Mul::apply(a, b));
  }
};

template <>
__device__ __forceinline__ float Semiring<OpPlus, OpTimes, ZERO_0>::mac(float acc, float a,
                                                                       float b) {
  return fmaf(a, b, acc);
}

using PlusTimes = Semiring<OpPlus, OpTimes, ZERO_0>;
using MaxPlus = Semiring<OpMax, OpPlus, ZERO_NEG_INF>;
using MinPlus = Semiring<OpMin, OpPlus, ZERO_POS_INF>;
using MaxMin = Semiring<OpMax, OpMin, ZERO_NEG_INF>;
using MaxTimes = Semiring<OpMax, OpTimes, ZERO_0>;
using AndOr = Semiring<OpMax, OpMin, ZERO_0>;

// Run the statement list with `SR` bound to semiring number `id`; an unknown
// id returns cudaErrorInvalidValue from the enclosing entry point.
#define SR_DISPATCH(id, ...)                      \
  switch (id) {                                   \
    case 0: { using SR = PlusTimes; __VA_ARGS__; } break; \
    case 1: { using SR = MaxPlus; __VA_ARGS__; } break;   \
    case 2: { using SR = MinPlus; __VA_ARGS__; } break;   \
    case 3: { using SR = MaxMin; __VA_ARGS__; } break;    \
    case 4: { using SR = MaxTimes; __VA_ARGS__; } break;  \
    case 5: { using SR = AndOr; __VA_ARGS__; } break;     \
    default: return (int)cudaErrorInvalidValue;   \
  }
