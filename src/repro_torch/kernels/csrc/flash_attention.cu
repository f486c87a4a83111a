// Blocked (flash) attention, forward only, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::_flash_kernel  (flash_attention)
// which the JAX package reaches through repro.kernels.ops.flash_attention.
//
// What it computes: for q [B, H, S, D] and k, v [B, Hkv, S, D] (query head
// h reads KV head h / (H / Hkv)), out = softmax(q k^T * scale) v, with the
// logits in fp32 and, when causal, a key after its query masked to -1e30
// (not -inf).  FlashAttention-2's recurrence: key tiles are walked in
// order with the running max m, denominator l and accumulator acc of each
// query row in fp32; key tiles wholly after a block's last query are
// skipped; out = acc / max(l, 1e-30) in q's dtype.  The tiles here are the
// kernel's own (64 queries x 64 keys); the caller's block sizes only fix
// the reference's divisibility contract, and skipping or regrouping fully
// masked keys changes no result beyond rounding.
//
// Bound.  Attention at S = 4,096 does ~4*S*D flops per query row against
// 2*S*D elements of K and V: far above the card's ~295 flops/byte balance,
// so operations bound it (the tensor-core rate in bf16/fp16).
//
// Design (simple and right first; mma.sync / wgmma tiles, TMA loads and a
// producer warp are later work).  SIMT fp32 FMAs.  One block of 8 warps per
// (64-query block, head, batch); the last query blocks, which have the
// most key tiles under a causal mask, are launched first.  The block keeps
// its queries in shared memory in fp32; each key tile's K (transposed, one
// padded row per feature, so a warp reads 32 banks) and V are staged in
// shared memory in fp32.  Each warp owns 8 query rows: for the logits a
// lane owns 2 keys of the tile and reads the 8 rows' queries as broadcast
// float4s; the softmax is a shuffle reduction per row; the probabilities go
// through shared memory; for P V a lane owns up to 8 output columns of the
// 8 rows and reads V as float4s.  GQA by index: no repeated K/V copy.
//
// Plain C interface, bound with ctypes: the launcher returns the CUDA error
// code of its launch (0 on success) and never synchronises.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;              // query rows per warp
constexpr int kBq = kWarps * kRows;   // query rows per block
constexpr int kBk = 64;               // keys per tile: two per lane
constexpr int kKs = kBk + 1;          // padded row of the transposed K tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Shared memory of one block, in floats, for a padded head width dp.
__host__ __device__ constexpr int smem_floats(int dp) {
  return kBq * dp        // q  [kBq][dp]
         + dp * kKs      // K^T [dp][kKs]
         + kBk * dp      // V  [kBk][dp]
         + kBq * kBk;    // P  [kWarps][kRows][kBk]
}

// NC = output columns per lane = dp / 32, a power of two up to 8.  A lane
// owns NC / VG groups of VG consecutive columns: col = g*32*VG + lane*VG + e.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int H, int hkv, int S, int D, float scale, int causal) {
  constexpr int DP = NC * 32;
  constexpr int VG = NC < 4 ? NC : 4;
  constexpr int NG = NC / VG;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;              // [kBq][DP]
  float* kt_s = q_s + kBq * DP;   // [DP][kKs]
  float* v_s = kt_s + DP * kKs;   // [kBk][DP]
  float* p_s = v_s + kBk * DP;    // [kWarps][kRows][kBk]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qb = gridDim.x - 1 - blockIdx.x;  // the heaviest causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / hkv);
  const int q0 = qb * kBq;
  const T* qh = q + (static_cast<int64_t>(b) * H + h) * S * D;
  const T* kh = k + (static_cast<int64_t>(b) * hkv + kvh) * S * D;
  const T* vh = v + (static_cast<int64_t>(b) * hkv + kvh) * S * D;

  for (int e = tid; e < kBq * DP; e += kThreads) {
    const int r = e / DP, d = e - r * DP;
    q_s[e] = (q0 + r < S && d < D) ? to_f32(qh[static_cast<int64_t>(q0 + r) * D + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int last_row = min(q0 + kBq, S) - 1;
  const int n_tiles = causal ? last_row / kBk + 1 : (S + kBk - 1) / kBk;
  const float* qw = q_s + warp * kRows * DP;
  float* pw = p_s + warp * kRows * kBk;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBk;
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    for (int e = tid; e < kBk * DP; e += kThreads) {
      const int j = e / DP, d = e - j * DP;
      const bool in = k0 + j < S && d < D;
      const int64_t off = static_cast<int64_t>(k0 + j) * D + d;
      kt_s[d * kKs + j] = in ? to_f32(kh[off]) : 0.f;
      v_s[e] = in ? to_f32(vh[off]) : 0.f;
    }
    __syncthreads();

    // Logits of the warp's 8 rows against the lane's keys lane, lane + 32.
    float s0[kRows], s1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s0[r] = s1[r] = 0.f;
    for (int d4 = 0; d4 < DP; d4 += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = *reinterpret_cast<const float4*>(qw + r * DP + d4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ka = kt_s[(d4 + e) * kKs + lane];
        const float kb = kt_s[(d4 + e) * kKs + lane + 32];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float qe = e == 0 ? qv[r].x : e == 1 ? qv[r].y : e == 2 ? qv[r].z : qv[r].w;
          s0[r] = fmaf(qe, ka, s0[r]);
          s1[r] = fmaf(qe, kb, s1[r]);
        }
      }
    }

    // Online softmax, one row at a time across the warp.
    const int key0 = k0 + lane, key1 = key0 + 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + warp * kRows + r;
      float x0 = s0[r] * scale, x1 = s1[r] * scale;
      if (key0 >= S) x0 = -INFINITY;  // past the sequence: no weight at all
      else if (causal && key0 > row) x0 = kNegInf;
      if (key1 >= S) x1 = -INFINITY;
      else if (causal && key1 > row) x1 = kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      pw[r * kBk + lane] = p0;
      pw[r * kBk + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V over the tile's keys, four at a time.
    for (int j4 = 0; j4 < kBk; j4 += 4) {
      float4 pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pr[r] = *reinterpret_cast<const float4*>(pw + r * kBk + j4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = v_s + (j4 + jj) * DP + lane * VG;
        float vv[NC];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if constexpr (VG == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + g * 32 * VG);
            vv[g * 4 + 0] = x.x;
            vv[g * 4 + 1] = x.y;
            vv[g * 4 + 2] = x.z;
            vv[g * 4 + 3] = x.w;
          } else {
#pragma unroll
            for (int e = 0; e < VG; ++e) vv[g * VG + e] = vrow[g * 32 * VG + e];
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y : jj == 2 ? pr[r].z : pr[r].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
    }
  }

  T* oh = out + (static_cast<int64_t>(b) * H + h) * S * D;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int e = 0; e < VG; ++e) {
        const int col = g * 32 * VG + lane * VG + e;
        if (col < D) oh[static_cast<int64_t>(row) * D + col] = from_f32<T>(acc[r][g * VG + e] * inv);
      }
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int hkv, int S,
           int D, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(NC * 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + kBq - 1) / kBq, H, B);
  flash_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, hkv, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int H, int hkv,
             int S, int D, float scale, int causal, cudaStream_t s) {
  if (D <= 32) return launch<T, 1>(q, k, v, out, B, H, hkv, S, D, scale, causal, s);
  if (D <= 64) return launch<T, 2>(q, k, v, out, B, H, hkv, S, D, scale, causal, s);
  if (D <= 128) return launch<T, 4>(q, k, v, out, B, H, hkv, S, D, scale, causal, s);
  if (D <= 256) return launch<T, 8>(q, k, v, out, B, H, hkv, S, D, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and out share it).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* out, int B, int H, int hkv, int S, int D,
                                      float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (hkv <= 0 || H % hkv || D <= 0 || D > 256 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, out, B, H, hkv, S, D, scale, causal, s);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, out, B, H, hkv, S, D, scale, causal, s);
    case 2:
      return launch_d<__half>(q, k, v, out, B, H, hkv, S, D, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
