// What the MoE experts' forward (moe_experts.cu), backward
// (moe_experts_bwd.cu) and tensor-core (moe_experts_sm90.cu) kernels share:
// the tile shape of the simt route, the element conversions and rounding,
// the activations and their derivatives, the epilogues' arithmetic, the
// warp scan that finds a row tile's expert, and the entry points of the
// wgmma route.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;  // rows of a tile
constexpr int kBN = 64;  // columns of a tile
constexpr int kSimtBK = 16;
constexpr int kSimtThreads = 256;
constexpr int kLdS = kBM + 4;  // floats, simt tiles

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

struct TileInfo {
  int expert;  // -1 past the last expert's tiles
  int row0;
  int row_end;
};

// Which expert owns row tile t (tiles of BM rows, numbered expert after
// expert), and its rows: a scan over offs by one whole warp, the result in
// every lane.
template <int BM>
__device__ TileInfo locate_tile(const int* __restrict__ offs, int E, int M, int t) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  TileInfo info{-1, 0, 0};
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    int lo = 0, hi = 0;
    if (e < E) {
      lo = min(max(e ? offs[e - 1] : 0, 0), M);
      hi = min(max(offs[e], lo), M);
    }
    const int tiles = (hi - lo + BM - 1) / BM;
    int incl = tiles;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int start = carry + incl - tiles;
    const unsigned hit = __ballot_sync(0xffffffffu, t >= start && t < start + tiles);
    if (hit) {
      const int src = __ffs(hit) - 1;
      info.expert = base + src;
      info.row0 = __shfl_sync(0xffffffffu, lo + (t - start) * BM, src);
      info.row_end = __shfl_sync(0xffffffffu, hi, src);
      break;
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  return info;
}

// Warp 0: locate_tile for the simt route's 64-row tiles; writes
// (expert, first row, end row) to info.
__device__ void find_tile(const int* __restrict__ offs, int E, int M, int t, int* info) {
  const TileInfo ti = locate_tile<kBM>(offs, E, M, t);
  if ((threadIdx.x & 31) == 0) {
    info[0] = ti.expert;
    info[1] = ti.row0;
    info[2] = ti.row_end;
  }
}

// Expert e's rows [lo, hi), clamped as locate_tile clamps them.
__device__ __forceinline__ void expert_rows(const int* __restrict__ offs, int e, int M, int* lo,
                                            int* hi) {
  *lo = min(max(e ? offs[e - 1] : 0, 0), M);
  *hi = min(max(offs[e], *lo), M);
}

// The forward's modes: 1 silu GLU, 2 gelu GLU, 3 silu, 4 gelu, 0 the
// product alone.
constexpr int kPlain = 0;

// The forward's output element from the fp32 sums of the first (a) and
// gate (b) products: each product rounded to T, then the activation, then
// the gate's product.
template <typename T>
__device__ __forceinline__ float epilogue(int mode, float a, float b) {
  if (mode == kPlain) return a;
  const float x = rnd<T>(a);
  const float act = rnd<T>((mode == 1 || mode == 3) ? silu(x) : gelu_tanh(x));
  return mode <= 2 ? act * rnd<T>(b) : act;
}

// The activation at x (the same operations as silu and gelu_tanh) and its
// derivative, from one exponential or one tanh:
//   d silu / dx = s (1 + x (1 - s)), s = sigmoid(x);
//   d gelu_tanh / dx = 0.5 (1 + t) + 0.5 x (1 - t^2) c (1 + 3 a x^2),
//   t = tanh(c (x + a x^3)).
__device__ __forceinline__ void act_and_grad(bool is_silu, float x, float* act, float* grad) {
  if (is_silu) {
    const float d = 1.f + expf(-x);
    const float s = 1.f / d;
    *act = x / d;
    *grad = s * (1.f + x * (1.f - s));
  } else {
    const float t = tanhf(kGeluC * (x + kGeluA * x * x * x));
    *act = 0.5f * x * (1.f + t);
    *grad = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * kGeluC * (1.f + 3.f * kGeluA * x * x);
  }
}

// dh's epilogue: from the fp32 sum dh_acc of dY w_down^T and the saved
// products a, b (mode 1/2: the GLU; 3/4: the activation of b alone), the
// values written as dA (GLU only), dB and h, in fp32 before the last
// rounding.  act' is taken at the saved, rounded products.
template <typename T>
__device__ __forceinline__ void glu_backward(int mode, float dh_acc, float a, float b, float* da,
                                             float* db, float* h) {
  const float dh = rnd<T>(dh_acc);
  const bool is_silu = mode == 1 || mode == 3;
  float act, grad;
  if (mode <= 2) {
    act_and_grad(is_silu, a, &act, &grad);
    act = rnd<T>(act);
    *h = act * b;
    *da = dh * b * grad;
    *db = dh * act;
  } else {
    act_and_grad(is_silu, b, &act, &grad);
    *h = rnd<T>(act);
    *da = 0.f;
    *db = dh * grad;
  }
}

}  // namespace

// The wgmma route (moe_experts_sm90.cu), called by the launchers of
// moe_experts.cu and moe_experts_bwd.cu for route 2; dtype 1 bf16, 2 fp16.
// Each returns the CUDA error of its launch, or kEncodeFailed + the
// CUresult when a tensor map cannot be encoded.
int moe_sm90_forward(int dtype, const void* a, const void* b, const void* b2, const void* offs,
                     void* out, void* save, void* save2, int M, int K, int N, int E, int mode,
                     cudaStream_t stream);
int moe_sm90_nt(int dtype, const void* a0, const void* bt0, const void* a1, const void* bt1,
                const void* offs, int M, int K, int N, int E, int mode, void* out,
                const void* pa, const void* pb, void* da, void* db, void* h,
                cudaStream_t stream);
int moe_sm90_tn(int dtype, const void* x, const void* g, const void* g2, const void* offs,
                void* out, void* out2, int M, int K, int N, int E, cudaStream_t stream);
