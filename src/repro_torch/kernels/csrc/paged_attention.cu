// Paged decode attention over the disaggregated KV pool, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::_paged_attn_kernel  (paged_attention)
// which PagedServer's decode step launches once per layer per step.
//
// What it computes, for each sequence b and KV head h: the G query heads
// h*G .. h*G+G-1 of q [B, Hkv, G, D] attend over the first seq_lens[b]
// tokens of the pages block_tables[b, 0..] of the pool [P, page, Hkv, D].
// Pages j with j*page >= seq_lens[b] are skipped; keys at positions
// >= seq_lens[b] inside a page are masked to -1e30 (not -inf).  (m, l, acc)
// are carried in fp32 across pages (online softmax), and the output is
// acc / max(l, 1e-30) in q's dtype, so seq_len == 0 gives zeros.  The
// scale multiplies the dot product.  Page ids are clamped into [0, P-1], so
// no id reads outside the pool.
//
// Bound.  Decode attention does ~4*G*D flops per K/V element pair it reads,
// far below the card's ~295 flops/byte balance point: the kernel is bound by
// bytes, each sequence's ceil(seq_len/page) K and V pages read once.
//
// Design (simple and right first; split-K across SMs and cp.async/TMA page
// prefetch are later work).  One block per (KV head, sequence).  The G query
// heads of that KV head are staged once in shared memory in fp32, so each
// K/V element read from device memory serves all G heads.  The block walks
// its pages in chunks of up to 32 keys: the chunk's K and V rows are loaded
// into shared memory (converted to fp32), one warp computes each (head, key)
// dot product with a shuffle reduction, one warp per head updates (m, l)
// with one lane per key, and every thread updates its share of acc [G, D],
// which lives in shared memory.
//
// Plain C interface, bound with ctypes: the launcher returns the CUDA error
// code of its launch (0 on success) and never synchronises.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;  // keys per chunk: one lane per key in the softmax
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q,                  // [B, Hkv, G, D]
                  const T* __restrict__ k_pool,             // [P, page, Hkv, D]
                  const T* __restrict__ v_pool,             // [P, page, Hkv, D]
                  const int32_t* __restrict__ block_tables, // [B, maxp]
                  const int32_t* __restrict__ seq_lens,     // [B]
                  T* __restrict__ out,                      // [B, Hkv, G, D]
                  int P, int page, int hkv, int g, int d, int maxp, float scale) {
  extern __shared__ float smem[];
  const int gd = g * d;
  float* q_s = smem;             // [G, D]
  float* acc_s = q_s + gd;       // [G, D]
  float* k_s = acc_s + gd;       // [kKeys, D]
  float* v_s = k_s + kKeys * d;  // [kKeys, D]
  float* p_s = v_s + kKeys * d;  // [G, kKeys] logits, then probabilities
  float* m_s = p_s + g * kKeys;  // [G] running max
  float* l_s = m_s + g;          // [G] running denominator
  float* a_s = l_s + g;          // [G] this chunk's rescale factor

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int64_t qoff = (static_cast<int64_t>(b) * hkv + h) * gd;
  for (int e = tid; e < gd; e += kThreads) {
    q_s[e] = to_f32(q[qoff + e]);
    acc_s[e] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int seq_len = seq_lens[b];
  int npages = seq_len > 0 ? static_cast<int>((static_cast<int64_t>(seq_len) + page - 1) / page) : 0;
  if (npages > maxp) npages = maxp;
  const int64_t tok_stride = static_cast<int64_t>(hkv) * d;  // between tokens of a page

  for (int j = 0; j < npages; ++j) {
    int pid = block_tables[static_cast<int64_t>(b) * maxp + j];
    pid = min(max(pid, 0), P - 1);
    const int64_t base = (static_cast<int64_t>(pid) * page * hkv + h) * d;
    const int page_start = j * page;
    for (int c0 = 0; c0 < page && page_start + c0 < seq_len; c0 += kKeys) {
      const int nk = min(kKeys, page - c0);
      // Stage the chunk's K and V rows of head h in fp32.
      for (int e = tid; e < nk * d; e += kThreads) {
        const int t = e / d;
        const int64_t off = base + (c0 + t) * tok_stride + (e - t * d);
        k_s[e] = to_f32(k_pool[off]);
        v_s[e] = to_f32(v_pool[off]);
      }
      __syncthreads();
      // Logits: one warp per (head, key) pair.
      for (int pr = warp; pr < g * nk; pr += kWarps) {
        const int gi = pr / nk;
        const int t = pr - gi * nk;
        const float* qr = q_s + gi * d;
        const float* kr = k_s + t * d;
        float s = 0.f;
        for (int di = lane; di < d; di += 32) s += qr[di] * kr[di];
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        if (lane == 0) {
          p_s[gi * kKeys + t] = page_start + c0 + t < seq_len ? s * scale : kNegInf;
        }
      }
      __syncthreads();
      // Online softmax: one warp per head, one lane per key.
      for (int gi = warp; gi < g; gi += kWarps) {
        const float s = lane < nk ? p_s[gi * kKeys + lane] : kNegInf;
        float mc = s;
        for (int o = 16; o > 0; o >>= 1) mc = fmaxf(mc, __shfl_xor_sync(kFull, mc, o));
        const float m_prev = m_s[gi];
        const float m_new = fmaxf(m_prev, mc);
        const float pe = lane < nk ? expf(s - m_new) : 0.f;
        float sum = pe;
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        if (lane < nk) p_s[gi * kKeys + lane] = pe;
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[gi] = alpha;
          l_s[gi] = l_s[gi] * alpha + sum;
          m_s[gi] = m_new;
        }
      }
      __syncthreads();
      // acc = acc * alpha + P @ V.
      for (int e = tid; e < gd; e += kThreads) {
        const int gi = e / d;
        const int di = e - gi * d;
        const float* pr = p_s + gi * kKeys;
        float a = acc_s[e] * a_s[gi];
        for (int t = 0; t < nk; ++t) a += pr[t] * v_s[t * d + di];
        acc_s[e] = a;
      }
      __syncthreads();
    }
  }

  for (int e = tid; e < gd; e += kThreads) {
    out[qoff + e] = from_f32<T>(acc_s[e] / fmaxf(l_s[e / d], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bt, const void* sl,
           void* out, int B, int P, int page, int hkv, int g, int d, int maxp, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(g) * d + 2 * kKeys * d +
                                       static_cast<size_t>(g) * kKeys + 3 * g);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_attn_kernel<T><<<dim3(hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(bt), static_cast<const int32_t*>(sl), static_cast<T*>(out),
      P, page, hkv, g, d, maxp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, the pools and out share it).
extern "C" int paged_attention_launch(int dtype, const void* q, const void* k_pool,
                                      const void* v_pool, const void* block_tables,
                                      const void* seq_lens, void* out, int B, int P, int page,
                                      int hkv, int g, int d, int maxp, float scale,
                                      void* stream) {
  if (B <= 0 || hkv <= 0 || g <= 0) return 0;
  if (P <= 0 || page <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, block_tables, seq_lens, out, B, P, page, hkv, g, d,
                           maxp, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, block_tables, seq_lens, out, B, P, page,
                                   hkv, g, d, maxp, scale, s);
    case 2:
      return launch<__half>(q, k_pool, v_pool, block_tables, seq_lens, out, B, P, page, hkv, g,
                            d, maxp, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
