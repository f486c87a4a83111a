// What the MoE experts' forward (moe_experts.cu) and backward
// (moe_experts_bwd.cu) kernels share: the tile shape, the element
// conversions and rounding, the activations and their derivatives, the
// warp scan that finds a row tile's expert, and the 16-byte cp.async.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;  // rows of a tile
constexpr int kBN = 64;  // columns of a tile
constexpr int kTcBK = 32;
constexpr int kTcThreads = 128;
constexpr int kSimtBK = 16;
constexpr int kSimtThreads = 256;
constexpr int kLdA = kTcBK + 8;  // 16-bit elements; rows stay 16-byte aligned
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;    // floats
constexpr int kLdS = kBM + 4;    // floats, simt tiles

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

// What a tensor of type T holds of v.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluA = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(kGeluC * (x + kGeluA * x * x * x)));
}

// d silu / dx = s (1 + x (1 - s)), s = sigmoid(x).
__device__ __forceinline__ float silu_grad(float x) {
  const float s = 1.f / (1.f + expf(-x));
  return s * (1.f + x * (1.f - s));
}

// d gelu_tanh / dx = 0.5 (1 + t) + 0.5 x (1 - t^2) c (1 + 3 a x^2),
// t = tanh(c (x + a x^3)).
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float t = tanhf(kGeluC * (x + kGeluA * x * x * x));
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * kGeluC * (1.f + 3.f * kGeluA * x * x);
}

// Warp 0: which expert owns row tile t, and its rows.  Writes (expert,
// first row, end row) to info, expert -1 if t lies past the last tile.
__device__ void find_tile(const int* __restrict__ offs, int E, int M, int t,
                          int* info) {
  const int lane = threadIdx.x & 31;
  int carry = 0, found = -1, row0 = 0, row_end = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    int lo = 0, hi = 0;
    if (e < E) {
      lo = min(max(e ? offs[e - 1] : 0, 0), M);
      hi = min(max(offs[e], lo), M);
    }
    const int tiles = (hi - lo + kBM - 1) / kBM;
    int incl = tiles;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int start = carry + incl - tiles;
    const unsigned hit = __ballot_sync(0xffffffffu, t >= start && t < start + tiles);
    if (hit) {
      const int src = __ffs(hit) - 1;
      found = base + src;
      row0 = __shfl_sync(0xffffffffu, lo + (t - start) * kBM, src);
      row_end = __shfl_sync(0xffffffffu, hi, src);
      break;
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) {
    info[0] = found;
    info[1] = row0;
    info[2] = row_end;
  }
}

// 16 bytes from global to shared memory; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
