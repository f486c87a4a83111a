// The backward of the MoE experts' grouped products on Hopper.
//
// Replaces no TPU kernel: the JAX package trains through XLA's autodiff of
// jax.lax.ragged_dot (src/repro/models/moe.py, moe_ffn_ragged) and of the
// capacity dispatch's einsums.  ops.moe_experts_backward launches these
// kernels from the autograd Function of ops.moe_experts, once per MoE
// layer per backward pass.
//
// What it computes.  The layouts of moe_experts.cu: rows sorted by
// expert, expert e owning rows R_e = [offs[e-1], offs[e]); xs [M, d];
// w_gate, w_up [E, d, ff]; w_down [E, ff, d]; the forward's products
// a = xs w_gate[e] and b = xs w_up[e], saved [M, ff] by its up launch.
// Given dY [M, d]:
//   dh: dH = dY w_down[e]^T, and in its epilogue the GLU's backward,
//       dA = dH b act'(a), dB = dH act(a) (without a gate dB = dH act'(b)),
//       and h = act(a) b (act(b)) recomputed for dW_down;
//   dx: dXs = dA w_gate[e]^T + dB w_up[e]^T, both products summed in one
//       fp32 accumulator before one rounding (without a gate dB w_up^T);
//   dw: dW[e] = X[R_e]^T G[R_e], one launch for dW_gate and dW_up (X = xs,
//       G = dA and dB, sharing the xs tile) and one for dW_down (X = h,
//       G = dY); an expert with no rows gets exactly 0.
// All products accumulate in fp32 and round to the element type as the
// forward does: each product, then the activation, then the gate's
// product; act' is evaluated in fp32 at the saved (rounded) products.
// Rows of dXs past offs[E-1] are not written (the wrapper zeroes them).
// Each output element is summed by one thread in a fixed order and no
// kernel uses atomics, so two calls on the same inputs agree bit for bit.
//
// Bound.  At moonshot's train shapes (M 24,576 rows of one microbatch, d
// 2,048, ff 1,408, E 64) the six products are 8.5e11 operations, 0.86 ms
// at the H100's 989 TFLOP/s bf16 datasheet rate; the bytes (the weights
// read once and their gradients written once, 2.2 GB, with xs, dY, a, b
// and dXs) are 0.78 ms at 3.35 TB/s.  Operations bound it, bytes nearly.
//
// Design.  Two routes.  route "simt" (any float type and shape; fp32
// always): 256 threads, 4x4 outputs each, fp32 FMAs over tiles staged in
// shared memory.
//   dh, dx ("nt": C = A Bt^T with Bt [E, N, K] read in place): one CTA per
//   (row tile of one expert, 64-column tile), the expert found by the
//   forward's warp scan over offs (find_tile), so the host never reads
//   the group sizes.  The weights are read untransposed: a tile of Bt rows
//   is staged [k][n] in shared memory.  dx walks K twice, first (dA,
//   w_gate), then (dB, w_up), into the same accumulators.
//   dw ("tn"): grid (N tile, K tile, expert); each CTA reads its expert's
//   row range from offs on the device and walks it in tiles of 16 rows,
//   rows outside [start, end) zero-filled.
// route "wgmma" (the card's for bf16/fp16): moe_experts_sm90.cu's TMA +
// wgmma mainloop, called by the launchers below.
//
// Plain C interface, bound with ctypes: each launcher returns the CUDA
// error code of its launch (0 on success) and never synchronises.

#include "moe_experts.cuh"

namespace {

// "nt": C[r, n] = sum over terms t of A_t[r, :] . Bt_t[e][n, :], A_t
// [M, K], Bt_t [E, N, K]; terms 1 or 2.  The epilogue: mode 0 stores C to
// out; modes 1/2 (silu/gelu GLU) and 3/4 (silu/gelu alone) take C as dH
// and write dA (GLU only), dB and h from the saved pa (GLU only) and pb.
template <typename T>
struct NtArgs {
  const T* a0;
  const T* bt0;
  const T* a1;
  const T* bt1;
  const int* offs;
  int terms, M, K, N, E, mode;
  T* out;
  const T* pa;
  const T* pb;
  T* da;
  T* db;
  T* h;
};

template <typename T>
__device__ __forceinline__ void nt_epilogue(const NtArgs<T>& p, size_t i, float acc) {
  if (p.mode == 0) {
    p.out[i] = from_f<T>(acc);
    return;
  }
  const bool glu = p.mode <= 2;
  float da, db, h;
  glu_backward<T>(p.mode, acc, glu ? to_f(p.pa[i]) : 0.f, to_f(p.pb[i]), &da, &db, &h);
  if (glu) p.da[i] = from_f<T>(da);
  p.db[i] = from_f<T>(db);
  p.h[i] = from_f<T>(h);
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads) moe_bwd_nt_simt_kernel(NtArgs<T> p) {
  __shared__ __align__(16) float sa[kSimtBK][kLdS];  // [k][row]
  __shared__ __align__(16) float sb[kSimtBK][kLdS];  // [k][column]
  __shared__ int info[3];

  if (threadIdx.x < 32) find_tile(p.offs, p.E, p.M, blockIdx.x, info);
  __syncthreads();
  const int group = info[0];
  if (group < 0) return;
  const int row0 = info[1], row_end = info[2];
  const int col0 = blockIdx.y * kBN;
  const int K = p.K, N = p.N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // columns tx*4.., rows ty*4..

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < p.terms; ++t) {
    const T* A = t ? p.a1 : p.a0;
    const T* Bt = (t ? p.bt1 : p.bt0) + (size_t)group * N * K;
    for (int k0 = 0; k0 < K; k0 += kSimtBK) {
      for (int i = threadIdx.x; i < kBM * kSimtBK; i += kSimtThreads) {
        const int r = i / kSimtBK, kk = i % kSimtBK;
        const int k = k0 + kk, row = row0 + r, n = col0 + r;
        sa[kk][r] = (row < row_end && k < K) ? to_f(A[(size_t)row * K + k]) : 0.f;
        sb[kk][r] = (n < N && k < K) ? to_f(Bt[(size_t)n * K + k]) : 0.f;
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
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx * 4 + j;
      if (n < N) nt_epilogue(p, (size_t)row * N + n, acc[i][j]);
    }
  }
}

// "tn": out[e][k][n] = sum over r in R_e of x[r][k] g[r][n] (x [M, K], g
// [M, N], out [E, K, N]), and out2 from g2 the same way when g2 is set.
template <typename T>
struct TnArgs {
  const T* x;
  const T* g;
  const T* g2;
  const int* offs;
  T* out;
  T* out2;
  int M, K, N, E;
};

template <typename T>
__global__ void __launch_bounds__(kSimtThreads) moe_bwd_tn_simt_kernel(TnArgs<T> p) {
  __shared__ __align__(16) float sx[kSimtBK][kLdS];  // [row][k]
  __shared__ __align__(16) float sg[kSimtBK][kLdS];  // [row][n]
  __shared__ __align__(16) float sg2[kSimtBK][kLdS];

  const int e = blockIdx.z, k0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int K = p.K, N = p.N;
  int lo, hi;
  expert_rows(p.offs, e, p.M, &lo, &hi);
  const bool two = p.g2 != nullptr;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // n tx*4.., k ty*4..

  float acc[4][4], acc2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = 0.f;

  for (int r0 = lo; r0 < hi; r0 += kSimtBK) {
    for (int i = threadIdx.x; i < kSimtBK * kBN; i += kSimtThreads) {
      const int r = i / kBN, c = i % kBN;
      const int row = r0 + r, k = k0 + c, n = n0 + c;
      const bool in = row < hi, okg = in && n < N;
      sx[r][c] = (in && k < K) ? to_f(p.x[(size_t)row * K + k]) : 0.f;
      sg[r][c] = okg ? to_f(p.g[(size_t)row * N + n]) : 0.f;
      if (two) sg2[r][c] = okg ? to_f(p.g2[(size_t)row * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kSimtBK; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(&sx[r][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sg[r][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      if (two) {
        const float4 cv = *reinterpret_cast<const float4*>(&sg2[r][tx * 4]);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc2[i][j] = fmaf(ar[i], cr[j], acc2[i][j]);
      }
    }
    __syncthreads();
  }

  const size_t base = (size_t)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const size_t o = base + (size_t)k * N + n;
      p.out[o] = from_f<T>(acc[i][j]);
      if (two) p.out2[o] = from_f<T>(acc2[i][j]);
    }
  }
}

template <typename T>
int launch_nt(const NtArgs<T>& p, cudaStream_t stream) {
  const dim3 grid((p.M + kBM - 1) / kBM + p.E, (p.N + kBN - 1) / kBN);
  moe_bwd_nt_simt_kernel<T><<<grid, kSimtThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch_tn(const TnArgs<T>& p, cudaStream_t stream) {
  const dim3 grid((p.N + kBN - 1) / kBN, (p.K + kBM - 1) / kBM, p.E);
  moe_bwd_tn_simt_kernel<T><<<grid, kSimtThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool bad_common(int route, int M, int d, int ff, int E) {
  return M <= 0 || d <= 0 || ff <= 0 || E <= 0 || E > 65535 || route < 1 || route > 2;
}

template <typename T>
int dh(const void* dy, const void* w_down, const void* offs, const void* pa,
       const void* pb, void* da, void* db, void* h, int M, int d, int ff, int E, int mode,
       cudaStream_t s) {
  NtArgs<T> p{};
  p.a0 = static_cast<const T*>(dy);
  p.bt0 = static_cast<const T*>(w_down);
  p.offs = static_cast<const int*>(offs);
  p.terms = 1;
  p.M = M;
  p.K = d;
  p.N = ff;
  p.E = E;
  p.mode = mode;
  p.pa = static_cast<const T*>(pa);
  p.pb = static_cast<const T*>(pb);
  p.da = static_cast<T*>(da);
  p.db = static_cast<T*>(db);
  p.h = static_cast<T*>(h);
  return launch_nt<T>(p, s);
}

template <typename T>
int dx(const void* da, const void* w_gate, const void* db, const void* w_up,
       const void* offs, void* out, int M, int d, int ff, int E, cudaStream_t s) {
  NtArgs<T> p{};
  const bool glu = da != nullptr;
  p.a0 = static_cast<const T*>(glu ? da : db);
  p.bt0 = static_cast<const T*>(glu ? w_gate : w_up);
  p.a1 = static_cast<const T*>(db);
  p.bt1 = static_cast<const T*>(w_up);
  p.offs = static_cast<const int*>(offs);
  p.terms = glu ? 2 : 1;
  p.M = M;
  p.K = ff;
  p.N = d;
  p.E = E;
  p.mode = 0;
  p.out = static_cast<T*>(out);
  return launch_nt<T>(p, s);
}

template <typename T>
int dw(const void* x, const void* g, const void* g2, const void* offs, void* out,
       void* out2, int M, int K, int N, int E, cudaStream_t s) {
  TnArgs<T> p{};
  p.x = static_cast<const T*>(x);
  p.g = static_cast<const T*>(g);
  p.g2 = static_cast<const T*>(g2);
  p.offs = static_cast<const int*>(offs);
  p.out = static_cast<T*>(out);
  p.out2 = static_cast<T*>(out2);
  p.M = M;
  p.K = K;
  p.N = N;
  p.E = E;
  return launch_tn<T>(p, s);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16; route: 1 simt, 2 wgmma
// (moe_experts_sm90.cu; bf16 and fp16).

// dH = dY w_down[e]^T with the activation's backward in the epilogue:
// mode 1 silu GLU, 2 gelu GLU (pa = a, pb = b; writes da, db, h), 3 silu,
// 4 gelu (pb = b; pa and da null; writes db, h).  All [M, ff] but dy.
extern "C" int moe_bwd_dh_launch(int dtype, int route, const void* dy, const void* w_down,
                                 const void* offs, const void* pa, const void* pb, void* da,
                                 void* db, void* h, int M, int d, int ff, int E, int mode,
                                 void* stream) {
  if (bad_common(route, M, d, ff, E) || mode < 1 || mode > 4) return cudaErrorInvalidValue;
  if ((mode <= 2) != (pa != nullptr && da != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2)
    return moe_sm90_nt(dtype, dy, w_down, nullptr, nullptr, offs, M, d, ff, E, mode, nullptr, pa,
                       pb, da, db, h, s);
  switch (dtype) {
    case 0: return dh<float>(dy, w_down, offs, pa, pb, da, db, h, M, d, ff, E, mode, s);
    case 1:
      return dh<__nv_bfloat16>(dy, w_down, offs, pa, pb, da, db, h, M, d, ff, E, mode, s);
    case 2: return dh<__half>(dy, w_down, offs, pa, pb, da, db, h, M, d, ff, E, mode, s);
    default: return cudaErrorInvalidValue;
  }
}

// dXs = dA w_gate[e]^T + dB w_up[e]^T; da and w_gate null without a gate.
extern "C" int moe_bwd_dx_launch(int dtype, int route, const void* da, const void* w_gate,
                                 const void* db, const void* w_up, const void* offs, void* out,
                                 int M, int d, int ff, int E, void* stream) {
  if (bad_common(route, M, d, ff, E) || (da == nullptr) != (w_gate == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    const bool glu = da != nullptr;
    return moe_sm90_nt(dtype, glu ? da : db, glu ? w_gate : w_up, glu ? db : nullptr,
                       glu ? w_up : nullptr, offs, M, ff, d, E, 0, out, nullptr, nullptr,
                       nullptr, nullptr, nullptr, s);
  }
  switch (dtype) {
    case 0: return dx<float>(da, w_gate, db, w_up, offs, out, M, d, ff, E, s);
    case 1: return dx<__nv_bfloat16>(da, w_gate, db, w_up, offs, out, M, d, ff, E, s);
    case 2: return dx<__half>(da, w_gate, db, w_up, offs, out, M, d, ff, E, s);
    default: return cudaErrorInvalidValue;
  }
}

// out[e] = x[R_e]^T g[R_e] ([E, K, N]); out2 from g2 likewise, both null
// or both set.
extern "C" int moe_bwd_dw_launch(int dtype, int route, const void* x, const void* g,
                                 const void* g2, const void* offs, void* out, void* out2, int M,
                                 int K, int N, int E, void* stream) {
  if (bad_common(route, M, K, N, E) || (g2 == nullptr) != (out2 == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2) return moe_sm90_tn(dtype, x, g, g2, offs, out, out2, M, K, N, E, s);
  switch (dtype) {
    case 0: return dw<float>(x, g, g2, offs, out, out2, M, K, N, E, s);
    case 1: return dw<__nv_bfloat16>(x, g, g2, offs, out, out2, M, K, N, E, s);
    case 2: return dw<__half>(x, g, g2, offs, out, out2, M, K, N, E, s);
    default: return cudaErrorInvalidValue;
  }
}
