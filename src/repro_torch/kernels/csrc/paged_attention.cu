// Paged decode attention over the disaggregated KV pool, on Hopper: split
// over pages, then a combine pass.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::_paged_attn_kernel  (paged_attention)
// which PagedServer's decode step launches once per layer per step.
//
// What it computes, for each sequence b and KV head h: the G query heads
// h*G .. h*G+G-1 of q [B, Hkv, G, D] attend over the first seq_lens[b]
// tokens of the pages block_tables[b, 0..] of the pool [P, page, Hkv, D].
// Pages j with j*page >= seq_lens[b] are skipped; keys at positions
// >= seq_lens[b] inside a live page are masked to -1e30 (not -inf).  The
// output is acc / max(l, 1e-30) in q's dtype, so seq_len == 0 gives zeros.
// The scale multiplies the dot product.  Page ids are clamped into
// [0, P-1], so no id reads outside the pool.
//
// Bound.  Decode attention does ~4*G*D flops per K/V element pair it reads,
// far below the card's ~295 flops/byte balance point: the kernel is bound by
// bytes, each sequence's ceil(seq_len/page) K and V pages read once.
//
// Design.  Two launches.
// 1. paged_split_kernel, grid (splits, Hkv * head groups, B): split i takes
//    pages [i*pps, (i+1)*pps) of its sequence.  The host picks splits from
//    the shapes alone (ops._paged_splits: about two CTAs per SM) and never
//    reads seq_lens; a split whose first page lies at or past seq_len
//    writes an empty partial (m = -inf, l = 0) and exits.  A live split
//    reads its page ids (at most kMaxPps) into shared memory once.  Up to 8 query
//    heads of the KV head sit in registers, D spread over a warp's lanes
//    (E = D/32 elements a lane).  Each of the 4 warps walks its own steps of
//    4 consecutive tokens (step s goes to warp s % 4) through a warp-private
//    ring of 4 stages in shared memory, filled by 16-byte cp.async (a
//    token's row of one head is D*size contiguous bytes at stride Hkv*D),
//    so 3 steps per warp are in flight; only __syncwarp orders a stage.
//    Logits, max and sum live in registers (warp shuffles); the warps merge
//    their (m, l, acc) once per split through shared memory and write the
//    split's partial, fp32, to the workspace [B, Hq, splits, D + 2].
// 2. paged_combine_kernel, one CTA per (b, query head): the log-sum-exp
//    merge m = max m_i, l = sum l_i 2^(m_i - m), acc = sum acc_i 2^(m_i - m)
//    (an empty partial weighs 0), then acc / max(l, 1e-30) in q's dtype.
// Logits are carried in log2 units (scale * log2 e folded into q . k).
//
// Plain C interface, bound with ctypes: each launcher returns the CUDA error
// code of its launch (0 on success) and never synchronises.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTok = 4;     // tokens of one warp step
constexpr int kStages = 4;  // warp-private ring depth
constexpr int kGMax = 8;    // query heads of one CTA
constexpr int kMaxPps = 1024;  // pages of one split (their ids sit in shared memory)
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of one split CTA: the warps' rings, later reused for the
// warps' partials, then the split's page ids.
__host__ __device__ constexpr int ring_elems(int dp) { return kWarps * kStages * 2 * kTok * dp; }
__host__ __device__ constexpr int merge_floats(int g, int dp) { return kWarps * g * (dp + 2); }
template <typename T, int E, int GT>
__host__ __device__ constexpr int pid_offset() {
  return sizeof(T) * ring_elems(32 * E) > sizeof(float) * merge_floats(GT, 32 * E)
             ? sizeof(T) * ring_elems(32 * E)
             : sizeof(float) * merge_floats(GT, 32 * E);
}

// E = elements of D per lane (D <= 32*E); GT = query heads per CTA.
template <typename T, int E, int GT>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q,                  // [B, Hkv, G, D]
                   const T* __restrict__ k_pool,             // [P, page, Hkv, D]
                   const T* __restrict__ v_pool,             // [P, page, Hkv, D]
                   const int32_t* __restrict__ block_tables, // [B, maxp]
                   const int32_t* __restrict__ seq_lens,     // [B]
                   float* __restrict__ ws,                   // [B, Hq, splits, D + 2]
                   int P, int page, int hkv, int g, int d, int maxp, int pps, int vec,
                   float scale_log2) {
  constexpr int DP = 32 * E;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int ngroups = (g + GT - 1) / GT;
  const int h = blockIdx.y / ngroups;
  const int g0 = (blockIdx.y - h * ngroups) * GT;  // first query head (within the KV head)
  const int ng = min(GT, g - g0);
  const int b = blockIdx.z;
  const int hq0 = h * g + g0;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq_all = hkv * g;

  const int seq_len = seq_lens[b];
  int npages = seq_len > 0 ? static_cast<int>((static_cast<int64_t>(seq_len) + page - 1) / page) : 0;
  npages = min(npages, maxp);
  const int p_begin = split * pps;
  const int p_end = min(p_begin + pps, npages);
  if (p_begin >= p_end) {  // nothing of this sequence here: an empty partial
    for (int gi = tid; gi < ng; gi += kThreads) {
      float* w = ws + ((static_cast<int64_t>(b) * hq_all + hq0 + gi) * splits + split) * (d + 2);
      w[0] = -INFINITY;
      w[1] = 0.f;
    }
    return;
  }
  const int t_begin = p_begin * page;
  const int t_end = p_end * page;
  const int nsteps = (t_end - t_begin + kTok - 1) / kTok;
  const int nmine = nsteps > warp ? (nsteps - warp + kWarps - 1) / kWarps : 0;

  // The lane's slice of each query head, in fp32, scale * log2 e folded in.
  float qr[GT][E], acc[GT][E], m[GT], l[GT];
  const int64_t qoff = (static_cast<int64_t>(b) * hkv + h) * g * d;
#pragma unroll
  for (int gi = 0; gi < GT; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int di = lane * E + e;
      qr[gi][e] = gi < ng && di < d ? to_f32(q[qoff + (g0 + gi) * d + di]) * scale_log2 : 0.f;
      acc[gi][e] = 0.f;
    }
  }

  // The split's page ids, clamped into the pool, read once: no step waits
  // on a block-table load before it can issue its copies.
  int* pids = reinterpret_cast<int*>(smem + pid_offset<T, E, GT>());
  const int32_t* bt = block_tables + static_cast<int64_t>(b) * maxp + p_begin;
  for (int j = tid; j < p_end - p_begin; j += kThreads) pids[j] = min(max(bt[j], 0), P - 1);
  __syncthreads();
  T* ring = reinterpret_cast<T*>(smem) + warp * kStages * 2 * kTok * DP;
  const int64_t tok_stride = static_cast<int64_t>(hkv) * d;
  const int row16 = d * static_cast<int>(sizeof(T)) / 16;  // 16-byte pieces of a row (vec)

  // Copy the K and V rows of warp step k into its stage.  tk counts tokens
  // from the split's first page.
  auto issue = [&](int k) {
    const int tk0 = (warp + kWarps * k) * kTok;
    const int nt = min(kTok, t_end - t_begin - tk0);
    T* st = ring + (k % kStages) * 2 * kTok * DP;
    if (vec) {
      for (int u = lane; u < nt * row16; u += 32) {
        const int tok = u / row16, c = u - tok * row16;
        const int tk = tk0 + tok, j = tk / page;
        const int64_t off = (static_cast<int64_t>(pids[j]) * page + (tk - j * page)) * tok_stride + h * d;
        const int e0 = c * (16 / static_cast<int>(sizeof(T)));
        cp_async16(st + tok * DP + e0, k_pool + off + e0);
        cp_async16(st + (kTok + tok) * DP + e0, v_pool + off + e0);
      }
    } else {
      for (int u = lane; u < nt * d; u += 32) {
        const int tok = u / d, di = u - tok * d;
        const int tk = tk0 + tok, j = tk / page;
        const int64_t off = (static_cast<int64_t>(pids[j]) * page + (tk - j * page)) * tok_stride + h * d;
        st[tok * DP + di] = k_pool[off + di];
        st[(kTok + tok) * DP + di] = v_pool[off + di];
      }
    }
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nmine) issue(k);
    cp_async_commit();
  }
  for (int k = 0; k < nmine; ++k) {
    if (k + kStages - 1 < nmine) issue(k + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const T* st = ring + (k % kStages) * 2 * kTok * DP;
    const int tk0 = t_begin + (warp + kWarps * k) * kTok;
    const int nt = min(kTok, t_end - tk0);

    // Logits of the step's tokens for every head, reduced over the warp.
    float s[kTok][GT];
#pragma unroll
    for (int tok = 0; tok < kTok; ++tok) {
      float kf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int di = lane * E + e;
        kf[e] = tok < nt && di < d ? to_f32(st[tok * DP + di]) : 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < GT; ++gi) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qr[gi][e], kf[e], x);
        s[tok][gi] = x;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int tok = 0; tok < kTok; ++tok)
#pragma unroll
        for (int gi = 0; gi < GT; ++gi) s[tok][gi] += __shfl_xor_sync(kFull, s[tok][gi], o);
    }
    // Online softmax over the step; keys past seq_len are -1e30, tokens past
    // the split are not there.
#pragma unroll
    for (int tok = 0; tok < kTok; ++tok) {
#pragma unroll
      for (int gi = 0; gi < GT; ++gi) {
        if (tok >= nt) s[tok][gi] = -INFINITY;
        else if (tk0 + tok >= seq_len) s[tok][gi] = kMasked;
      }
    }
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
      float mc = s[0][gi];
#pragma unroll
      for (int tok = 1; tok < kTok; ++tok) mc = fmaxf(mc, s[tok][gi]);
      const float m_new = fmaxf(m[gi], mc);  // finite: the step has a token
      const float alpha = exp2f(m[gi] - m_new);
      m[gi] = m_new;
      l[gi] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] *= alpha;
#pragma unroll
      for (int tok = 0; tok < kTok; ++tok) {
        const float p = exp2f(s[tok][gi] - m_new);
        s[tok][gi] = p;
        l[gi] += p;
      }
    }
#pragma unroll
    for (int tok = 0; tok < kTok; ++tok) {
      if (tok >= nt) break;
      float vf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int di = lane * E + e;
        vf[e] = di < d ? to_f32(st[(kTok + tok) * DP + di]) : 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < GT; ++gi)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[gi][e] = fmaf(s[tok][gi], vf[e], acc[gi][e]);
    }
    __syncwarp();  // the stage is refilled by the next step's issue
  }
  cp_async_wait<0>();

  // Merge the warps' (m, l, acc) once and write the split's partial.
  __syncthreads();  // every ring is drained: reuse it for the partials
  float* part = reinterpret_cast<float*>(smem);  // [kWarps][GT][DP + 2]
#pragma unroll
  for (int gi = 0; gi < GT; ++gi) {
    float* w = part + (warp * GT + gi) * (DP + 2);
    if (lane == 0) {
      w[0] = m[gi];
      w[1] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) w[2 + lane * E + e] = acc[gi][e];
  }
  __syncthreads();
  for (int idx = tid; idx < ng * d; idx += kThreads) {
    const int gi = idx / d, di = idx - gi * d;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part[(w * GT + gi) * (DP + 2)]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = part + (w * GT + gi) * (DP + 2);
      if (pw[0] == -INFINITY) continue;  // a warp with no step
      const float f = exp2f(pw[0] - mx);
      lt += pw[1] * f;
      at += pw[2 + di] * f;
    }
    float* o = ws + ((static_cast<int64_t>(b) * hq_all + hq0 + gi) * splits + split) * (d + 2);
    if (di == 0) {
      o[0] = mx;
      o[1] = lt;
    }
    o[2 + di] = at;
  }
}

// One CTA per (query head, sequence), one thread per output column.
template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int hq_all,
                                     int splits, int d) {
  const int hq = blockIdx.x, b = blockIdx.y, di = threadIdx.x;
  if (di >= d) return;
  const float* w = ws + (static_cast<int64_t>(b) * hq_all + hq) * splits * (d + 2);
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, w[s * (d + 2)]);
  float lt = 0.f, at = 0.f;
  if (mx != -INFINITY) {  // else seq_len 0: zeros
    for (int s = 0; s < splits; ++s) {
      const float* ps = w + s * (d + 2);
      if (ps[0] == -INFINITY) continue;  // an empty split weighs nothing
      const float f = exp2f(ps[0] - mx);
      lt += ps[1] * f;
      at += ps[2 + di] * f;
    }
  }
  out[(static_cast<int64_t>(b) * hq_all + hq) * d + di] = from_f32<T>(at / fmaxf(lt, 1e-30f));
}

template <typename T, int E, int GT>
int launch_split(const void* q, const void* k, const void* v, const void* bt, const void* sl,
                 float* ws, int B, int P, int page, int hkv, int g, int d, int maxp, int splits,
                 int pps, int vec, float scale, cudaStream_t stream) {
  const int dp = 32 * E;
  const size_t ring = sizeof(T) * static_cast<size_t>(ring_elems(dp));
  const size_t merge = sizeof(float) * static_cast<size_t>(merge_floats(GT, dp));
  const size_t smem = (ring > merge ? ring : merge) + sizeof(int) * static_cast<size_t>(pps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(paged_split_kernel<T, E, GT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int ngroups = (g + GT - 1) / GT;
  paged_split_kernel<T, E, GT><<<dim3(splits, hkv * ngroups, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(bt), static_cast<const int32_t*>(sl), ws, P, page, hkv, g, d,
      maxp, pps, vec, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int launch_g(const void* q, const void* k, const void* v, const void* bt, const void* sl, float* ws,
             int B, int P, int page, int hkv, int g, int d, int maxp, int splits, int pps, int vec,
             float scale, cudaStream_t s) {
  if (g == 1) return launch_split<T, E, 1>(q, k, v, bt, sl, ws, B, P, page, hkv, g, d, maxp, splits, pps, vec, scale, s);
  if (g == 2) return launch_split<T, E, 2>(q, k, v, bt, sl, ws, B, P, page, hkv, g, d, maxp, splits, pps, vec, scale, s);
  if (g <= 4) return launch_split<T, E, 4>(q, k, v, bt, sl, ws, B, P, page, hkv, g, d, maxp, splits, pps, vec, scale, s);
  return launch_split<T, E, kGMax>(q, k, v, bt, sl, ws, B, P, page, hkv, g, d, maxp, splits, pps, vec, scale, s);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const void* bt, const void* sl, float* ws,
             int B, int P, int page, int hkv, int g, int d, int maxp, int splits, int pps, int vec,
             float scale, cudaStream_t s) {
  if (d <= 32) return launch_g<T, 1>(q, k, v, bt, sl, ws, B, P, page, hkv, g, d, maxp, splits, pps, vec, scale, s);
  if (d <= 64) return launch_g<T, 2>(q, k, v, bt, sl, ws, B, P, page, hkv, g, d, maxp, splits, pps, vec, scale, s);
  if (d <= 128) return launch_g<T, 4>(q, k, v, bt, sl, ws, B, P, page, hkv, g, d, maxp, splits, pps, vec, scale, s);
  if (d <= 256) return launch_g<T, 8>(q, k, v, bt, sl, ws, B, P, page, hkv, g, d, maxp, splits, pps, vec, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q and the pools share it).  ws
// is fp32 [B, Hkv*G, splits, D + 2]; vec = 1 when every row of the pools
// can be copied in 16-byte pieces (D * size a multiple of 16, pools
// 16-byte aligned).
extern "C" int paged_attention_split_launch(int dtype, const void* q, const void* k_pool,
                                            const void* v_pool, const void* block_tables,
                                            const void* seq_lens, void* ws, int B, int P,
                                            int page, int hkv, int g, int d, int maxp, int splits,
                                            int pps, int vec, float scale, void* stream) {
  if (B <= 0 || hkv <= 0 || g <= 0) return 0;
  if (P <= 0 || page <= 0 || d <= 0 || d > 256 || splits <= 0 || pps < 0 || pps > kMaxPps ||
      B > 65535 ||
      splits > 65535 || static_cast<int64_t>(hkv) * ((g + kGMax - 1) / kGMax) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  switch (dtype) {
    case 0:
      return launch_t<float>(q, k_pool, v_pool, block_tables, seq_lens, w, B, P, page, hkv, g, d,
                             maxp, splits, pps, vec, scale, s);
    case 1:
      return launch_t<__nv_bfloat16>(q, k_pool, v_pool, block_tables, seq_lens, w, B, P, page, hkv,
                                     g, d, maxp, splits, pps, vec, scale, s);
    case 2:
      return launch_t<__half>(q, k_pool, v_pool, block_tables, seq_lens, w, B, P, page, hkv, g, d,
                              maxp, splits, pps, vec, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [B, Hq, D] in dtype from the partials ws [B, Hq, splits, D + 2].
extern "C" int paged_attention_combine_launch(int dtype, const void* ws, void* out, int B, int hq,
                                              int d, int splits, void* stream) {
  if (B <= 0 || hq <= 0) return 0;
  if (d <= 0 || d > 256 || splits <= 0 || B > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(hq, B);
  const int threads = (d + 31) / 32 * 32;
  const float* w = static_cast<const float*>(ws);
  switch (dtype) {
    case 0:
      paged_combine_kernel<float><<<grid, threads, 0, s>>>(w, static_cast<float*>(out), hq, splits, d);
      break;
    case 1:
      paged_combine_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
          w, static_cast<__nv_bfloat16*>(out), hq, splits, d);
      break;
    case 2:
      paged_combine_kernel<__half><<<grid, threads, 0, s>>>(w, static_cast<__half*>(out), hq, splits, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
