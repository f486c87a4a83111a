// The MoE experts' grouped products on Hopper.
//
// Replaces no TPU kernel: the JAX package computes these products with
// jax.lax.ragged_dot (src/repro/models/moe.py, moe_ffn_ragged), an XLA op.
// The port's moe_ffn (ragged and capacity) launches them through
// ops.moe_experts, once per MoE layer per prefill or decode step.
//
// What it computes.  The rows of A [M, K] are sorted by expert: expert e
// owns rows [offs[e-1], offs[e]) (expert 0 from row 0), offs int32 [E]
// cumulative.  One launch computes, for every row r of expert e,
//   GLU modes:  out[r] = act(A[r] @ B[e]) * (A[r] @ B2[e])
//   one-matrix: out[r] = act(A[r] @ B[e])  (or A[r] @ B[e], mode 0)
// with B, B2 [E, K, N] row-major, act silu or tanh-gelu.  Each product is
// rounded to the element type before the activation, the activation before
// the gate's product, as the reference's ragged_dot and elementwise ops
// round.  The wrapper launches it twice: up (A = tokens, N = ff), then down
// (A = the up output, N = d, mode 0).  Rows past offs[E-1] are not written.
// When autograd records the call, the up launch also writes its two
// products, rounded as above ([M, ff] each: the gate's a and the up b, or
// b alone without a gate), for the backward kernels of moe_experts_bwd.cu;
// under no_grad those pointers are null and nothing more is written.
//
// Bound.  A decode step routes a few dozen rows, so each expert it touches
// streams its three [d, ff] matrices once: bytes.  A 500-token prefill
// routes 3,000 rows over 64 experts, ~47 each: tensor-core operations.
//
// Design.  One CTA per (row tile of one expert, 64-column tile).  The group
// sizes stay on the device (the host never reads them, so a CUDA graph can
// capture the call): the row tiles of all experts are numbered expert
// after expert, the wrapper launches an upper bound of them, ceil(M/64) +
// E, and warp 0 of each CTA finds its expert with a warp scan over offs;
// a CTA numbered past the last expert's tiles returns.  CTAs of one column
// tile and neighbouring row tiles run side by side, so an expert's weight
// tile is read from device memory once and from L2 by its other row tiles.
//   route "simt" (any float type and shape; fp32 always): 256 threads, 4x4
//   outputs each, fp32 FMAs over tiles of depth 16 staged in shared memory.
//   route "wgmma" (the card's for bf16/fp16): moe_experts_sm90.cu's TMA +
//   wgmma mainloop, called by the launcher below.
//
// Plain C interface, bound with ctypes: the launcher returns the CUDA error
// code of its launch (0 on success) and never synchronises.

#include "moe_experts.cuh"

namespace {

// The output element at i, and (when the backward needs them) the two
// products rounded to T: save gets the first, save2 the gate's.
template <typename T>
__device__ __forceinline__ void store(T* __restrict__ out, T* __restrict__ save,
                                      T* __restrict__ save2, size_t i, int mode, float a,
                                      float b) {
  if (save) save[i] = from_f<T>(a);
  if (save2) save2[i] = from_f<T>(b);
  out[i] = from_f<T>(epilogue<T>(mode, a, b));
}

// ---------------------------------------------------------------------- //
// Route "simt".
// ---------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kSimtThreads)
moe_simt_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ b2,
                const int* __restrict__ offs, T* __restrict__ out, T* __restrict__ save,
                T* __restrict__ save2, int M, int K, int N, int E, int mode) {
  __shared__ __align__(16) float sa[kSimtBK][kLdS];  // A transposed: [k][row]
  __shared__ __align__(16) float sb[kSimtBK][kLdS];
  __shared__ __align__(16) float sb2[kSimtBK][kLdS];
  __shared__ int info[3];

  if (threadIdx.x < 32) find_tile(offs, E, M, blockIdx.x, info);
  __syncthreads();
  const int group = info[0];
  if (group < 0) return;
  const int row0 = info[1], row_end = info[2];
  const int col0 = blockIdx.y * kBN;
  const bool glu = b2 != nullptr;
  const T* bg = b + (size_t)group * K * N;
  const T* bu = glu ? b2 + (size_t)group * K * N : b;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // columns tx*4.., rows ty*4..

  float acc[4][4], acc2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSimtBK) {
    for (int i = threadIdx.x; i < kBM * kSimtBK; i += kSimtThreads) {
      const int r = i / kSimtBK, kk = i % kSimtBK;
      const int row = row0 + r, k = k0 + kk;
      sa[kk][r] = (row < row_end && k < K) ? to_f(a[(size_t)row * K + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < kSimtBK * kBN; i += kSimtThreads) {
      const int kk = i / kBN, c = i % kBN;
      const int k = k0 + kk, n = col0 + c;
      const bool ok = k < K && n < N;
      sb[kk][c] = ok ? to_f(bg[(size_t)k * N + n]) : 0.f;
      if (glu) sb2[kk][c] = ok ? to_f(bu[(size_t)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sa[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sb[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      if (glu) {
        const float4 cv = *reinterpret_cast<const float4*>(&sb2[kk][tx * 4]);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc2[i][j] = fmaf(ar[i], cr[j], acc2[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx * 4 + j;
      if (n < N) store<T>(out, save, save2, (size_t)row * N + n, mode, acc[i][j], acc2[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* b2, const void* offs, void* out,
           void* save, void* save2, int M, int K, int N, int E, int mode, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM + E, (N + kBN - 1) / kBN);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* pb2 = static_cast<const T*>(b2);
  const int* po = static_cast<const int*>(offs);
  T* pout = static_cast<T*>(out);
  T* ps = static_cast<T*>(save);
  T* ps2 = static_cast<T*>(save2);
  moe_simt_kernel<T><<<grid, kSimtThreads, 0, stream>>>(pa, pb, pb2, po, pout, ps, ps2, M, K,
                                                        N, E, mode);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16; route: 1 simt, 2 wgmma
// (moe_experts_sm90.cu; bf16 and fp16); b2 null for the
// one-matrix modes.  save and save2, each [M, N] or null, get the two
// products rounded to the element type (the backward's saved tensors; null
// under no_grad); save2 only in the GLU modes.
extern "C" int moe_experts_launch(int dtype, int route, const void* a, const void* b,
                                  const void* b2, const void* offs, void* out, void* save,
                                  void* save2, int M, int K, int N, int E, int mode,
                                  void* stream) {
  if (M <= 0 || N <= 0 || E <= 0 || K <= 0 || mode < 0 || mode > 4 || route < 1 || route > 2)
    return cudaErrorInvalidValue;
  if ((mode == 1 || mode == 2) != (b2 != nullptr)) return cudaErrorInvalidValue;
  if (save2 != nullptr && b2 == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2)
    return moe_sm90_forward(dtype, a, b, b2, offs, out, save, save2, M, K, N, E, mode, s);
  switch (dtype) {
    case 0: return launch<float>(a, b, b2, offs, out, save, save2, M, K, N, E, mode, s);
    case 1: return launch<__nv_bfloat16>(a, b, b2, offs, out, save, save2, M, K, N, E, mode, s);
    case 2: return launch<__half>(a, b, b2, offs, out, save, save2, M, K, N, E, mode, s);
    default: return cudaErrorInvalidValue;
  }
}
