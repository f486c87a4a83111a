// Paged decode attention of multi-head latent attention (MLA), on Hopper:
// split over pages, then a combine pass.
//
// Replaces no TPU kernel: the JAX package has no latent attention.  It is
// the decode attention of the port's DeepSeek-V3-style models, launched by
// PagedServer's decode step once per layer per step
// (repro_torch.kernels.ops.paged_mla_attention; plain version
// kernels/paged_mla.py::paged_mla_plain).
//
// What it computes, for each sequence b: the H (<= 32) query heads of
// q [B, H, Dk] (absorbed: q_nope W_UK^T beside the roped q_pe) attend over
// the first seq_lens[b] latents [c ‖ k_pe] of the pages block_tables[b, 0..]
// of the pool [P, page, Dk]; a head's key is the whole latent, its value
// the latent's first DV entries.  Pages j with j*page >= seq_lens[b] are
// skipped; positions >= seq_lens[b] inside a read page are masked to -1e30
// (not -inf).  The output [B, H, DV] is acc / max(l, 1e-30) in q's dtype,
// so seq_len == 0 gives zeros.  Page ids are clamped into [0, P-1].
//
// Bound.  Per latent (Dk = 576 bf16, 1,152 bytes) and head: 2 Dk + 2 DV
// operations, 34,816 for 16 heads, ~30 operations a byte: far below the
// card's ~295 (bf16 tensor cores), so the kernel is bound by bytes: each
// sequence's latent pages read once, for all heads together.  But ~30 a
// byte is above what the fp32 FMA units give at full bandwidth (67 TFLOP/s
// against 3.35 TB/s: 20 a byte), so the products run on the tensor cores.
//
// Design.  Two launches.
// 1. The split kernel, n CTAs (two an SM, from the shapes alone: the host
//    never reads seq_lens).  The sequences' live pages, laid end to end,
//    are cut into n equal runs, one a CTA, so a CTA's work does not depend
//    on how the lengths vary (the schedule below); a run falls into
//    segments, one per sequence it touches, each writing a partial.  A CTA
//    holds every head, so each latent is read from device memory once.
//    Route "mma" (bf16/fp16, Dk a multiple of 64, DV 512): 4 warps.
//    q sits in shared memory ([16][Dk] rows padded by 16 bytes, so that the
//    8 rows of an ldmatrix fall in 8 bank groups); the segment's latents go
//    through a ring of 2 tiles of 32 tokens, filled by 16-byte cp.async
//    (a page's rows are contiguous; tokens past the segment read zeros), the
//    next tile's copies in flight while this one is computed.  Per tile:
//    S = Q K^T by mma.sync m16n8k16 (each warp 8 tokens over all of Dk in
//    four independent chains of products, fp32 sums), the tile's row maxima exchanged through shared memory, the
//    online softmax in registers (log2 units, scale * log2 e folded in), P
//    rounded to the input type into shared memory, then O += P V by
//    mma.sync with V read transposed (ldmatrix.trans) from the same tile:
//    each warp owns DV/4 output columns, 16 x DV/4 fp32 sums in registers.
//    Three __syncthreads a tile.  Sizes (Dk 576, DV 512): ~100 KB of shared
//    memory, two CTAs an SM.
//    Route "simt" (everything else; fp32 always): 4 warps, each its share
//    of the heads (up to 4) in registers, D spread over the lanes, one
//    latent at a time read from device memory (the warps' repeats hit L1),
//    warp-shuffle dot products, fp32 FMA.  Correct and slow: the served
//    model takes the mma route.
//    Route "mma" at 17 to 32 heads (Kimi-Linear's 32): the kernel
//    paged_mla_mma_kernel_h32, the same schedule and tile loop with two
//    16-row mma tiles of heads in one CTA of 8 warps, so each latent is
//    still read once for every head.  For S, warp w takes the 8 tokens
//    (w & 3) of the tile against head tile w >> 2; the row maxima of all
//    32 heads meet in shared memory and every thread keeps the running
//    maxima of the four rows it touches, so the S and P V roles agree on
//    them; for P V each warp owns DV/8 output columns of both head tiles
//    (2 x 16 x DV/8 fp32 sums).  A ring of 3 tiles (two in flight),
//    ~158 KB of shared memory, one CTA an SM (the host launches n = SMs).
//    Route "simt" above 16 heads: a second grid row per 16 heads (each
//    latent read once per 16 heads).
//    Both write each segment's partial, fp32 (m, l, acc), to its slot of
//    the workspace [n + B, H, DV + 2].
// 2. The combine kernel, one CTA per (head, sequence): the log-sum-exp
//    merge of the partials of the CTAs that hold the sequence's pages,
//    m = max m_i, l = sum l_i 2^(m_i - m), acc = sum acc_i 2^(m_i - m),
//    then acc / max(l, 1e-30) in q's dtype.
//
// Plain C interface, bound with ctypes: each launcher returns the CUDA error
// code of its launch (0 on success) and never synchronises.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 4 warps, both routes
constexpr int kHMax = 16;      // heads of one CTA (the mma's 16 rows)
constexpr int kH32 = 32;       // heads of one h32 CTA: two 16-row tiles
constexpr int kThreads32 = 256;  // 8 warps of an h32 CTA
constexpr int kStages32 = 3;   // tiles in the h32 ring
constexpr int kTile = 32;      // tokens of one mma tile (4 warps x 8)
constexpr int kStages = 2;     // tiles in the ring
constexpr int kPad = 8;        // elements of padding per shared row (16 bytes)
constexpr int kPLd = kTile + kPad;  // row stride of P in shared memory
constexpr int kMaxPps = 1024;  // pages of one CTA (their ids sit in shared memory)
constexpr int kMaxB = 1024;    // sequences of one call (their page counts sit in shared memory)
constexpr int kMaxDk = 576;    // simt: 18 elements a lane
constexpr int kMaxDv = 512;    // simt: 16 elements a lane
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

// Two floats rounded to the input type, packed as the mma's operand.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; with ok == false the 16 bytes are zeros
// (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b, m16n8k16, a row-major 16 x 16, b column-major 16 x 8, fp32 sums.
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                                   uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The schedule.  Sequence b holds ceil(seq_lens[b] / page) pages (at most
// maxp); laid end to end they make T pages, and CTA c of n takes the pages
// [c T / n, (c + 1) T / n) of that list: equal work whatever the lengths.
// Its pages fall into segments, one per sequence they touch, and the
// segment of sequence b in CTA c writes its partial to slot c + b (unique:
// a later CTA never holds an earlier sequence), so the workspace holds
// n + B slots.  The combine of sequence b finds its CTAs from the same list.
__device__ __forceinline__ int seq_pages(int seq_len, int page, int maxp) {
  return seq_len > 0 ? min(static_cast<int>((static_cast<int64_t>(seq_len) + page - 1) / page), maxp)
                     : 0;
}

// cum[b] = the pages of the sequences before b, cum[B] = T: warp 0 scans
// 32 sequences at a time by shuffles; a whole-CTA call.
__device__ __forceinline__ void page_prefix(const int32_t* seq_lens, int B, int page, int maxp,
                                            int* cum) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < B; base += 32) {
      const int b = base + lane;
      int v = b < B ? seq_pages(seq_lens[b], page, maxp) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += t;
      }
      if (b < B) cum[b + 1] = carry + v;
      carry += __shfl_sync(kFull, v, 31);
    }
    if (lane == 0) cum[0] = 0;
  }
  __syncthreads();
}

__device__ __forceinline__ int cta_first_page(int c, int n, int total) {
  return static_cast<int>(static_cast<int64_t>(c) * total / n);
}

// The CTA whose pages hold page g (the last c with cta_first_page <= g).
__device__ __forceinline__ int cta_of(int g, int n, int total) {
  return static_cast<int>((static_cast<int64_t>(g + 1) * n + total - 1) / total) - 1;
}

// ---------------------------------------------------------------------- //
// Route "mma".
// ---------------------------------------------------------------------- //
__host__ __device__ constexpr size_t mma_smem_bytes(int dk, int pmax, int B) {
  return 2 * (static_cast<size_t>(kHMax) * (dk + kPad) + static_cast<size_t>(kStages) * kTile * (dk + kPad) +
              static_cast<size_t>(kHMax) * kPLd) +
         sizeof(float) * 2 * 4 * kHMax + sizeof(int) * (static_cast<size_t>(pmax) + B + 1);
}

template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 2)
paged_mla_mma_kernel(const T* __restrict__ q,                  // [B, H, Dk]
                     const T* __restrict__ lat,                // [P, page, Dk]
                     const int32_t* __restrict__ block_tables, // [B, maxp]
                     const int32_t* __restrict__ seq_lens,     // [B]
                     float* __restrict__ ws,                   // [n + B, H, DV + 2]
                     int B, int H, int P, int page, int dk, int maxp, int pmax, float scale_log2) {
  constexpr int NT = DV / 32;  // n-tiles of 8 columns a warp owns
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = dk + kPad;
  T* qs = reinterpret_cast<T*>(smem);   // [16][ld]
  T* ring = qs + kHMax * ld;            // [kStages][kTile][ld]
  T* ps = ring + kStages * kTile * ld;  // [16][kPLd]
  float* red = reinterpret_cast<float*>(ps + kHMax * kPLd);  // [4][16] row maxima
  float* lsum = red + 4 * kHMax;                              // [4][16] row sums
  int* pids = reinterpret_cast<int*>(lsum + 4 * kHMax);       // [pmax]
  int* cum = pids + pmax;                                     // [B + 1]

  const int c = blockIdx.x, n = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  page_prefix(seq_lens, B, page, maxp, cum);
  const int total = cum[B];
  const int g0 = cta_first_page(c, n, total), g1 = cta_first_page(c + 1, n, total);
  if (g0 >= g1) return;
  int b = 0;
  while (cum[b + 1] <= g0) ++b;
  for (; b < B && cum[b] < g1; ++b) {
    const int p_begin = max(g0, cum[b]) - cum[b], p_end = min(g1, cum[b + 1]) - cum[b];
    if (p_begin >= p_end) continue;  // a sequence without pages
    const int seq_len = seq_lens[b];
    __syncthreads();  // the previous segment is done with q, the ids and the ring
    const int t_begin = p_begin * page, t_end = p_end * page;
    const int ntiles = (t_end - t_begin + kTile - 1) / kTile;
    const int cpr = dk / 8;  // 16-byte pieces of a row

    // q (rows past H zero) and the segment's page ids, clamped into the pool.
    const T* qb = q + static_cast<int64_t>(b) * H * dk;
    for (int u = tid; u < kHMax * cpr; u += kThreads) {
      const int row = u / cpr, ch = u - row * cpr;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < H) v = *reinterpret_cast<const uint4*>(qb + row * dk + ch * 8);
      *reinterpret_cast<uint4*>(qs + row * ld + ch * 8) = v;
    }
    const int32_t* bt = block_tables + static_cast<int64_t>(b) * maxp + p_begin;
    for (int j = tid; j < p_end - p_begin; j += kThreads) pids[j] = min(max(bt[j], 0), P - 1);
    __syncthreads();

    // Tile k's latents into stage k % kStages, each warp 8 rows, its lanes
    // over a row's 16-byte pieces; tokens past the segment are zeros.
    auto issue = [&](int k) {
      T* st = ring + (k % kStages) * kTile * ld;
      for (int tok = warp * 8; tok < warp * 8 + 8; ++tok) {
        const int tk = k * kTile + tok;  // from the segment's first token
        const bool ok = t_begin + tk < t_end;
        const T* src = lat;
        if (ok) {
          const int j = tk / page;
          src = lat + (static_cast<int64_t>(pids[j]) * page + (tk - j * page)) * dk;
        }
        for (int ch = lane; ch < cpr; ch += 32)
          cp_async16(st + tok * ld + ch * 8, ok ? src + ch * 8 : lat, ok);
      }
      cp_async_commit();
    };

    float o[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    const int r = lane >> 2;  // this thread's heads: r and r + 8
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    issue(0);
    for (int k = 0; k < ntiles; ++k) {
      cp_async_wait_all();
      __syncthreads();  // tile k landed for every warp; tile k - 1 is done with
      if (k + 1 < ntiles) issue(k + 1);
      const T* tile = ring + (k % kStages) * kTile * ld;

      // S = Q K^T for this warp's 8 tokens, over Dk in four independent
      // chains of products (one chain would wait on each mma's latency).
      float sc[4][4] = {};
      const T* kt = tile + (warp * 8 + (lane & 7)) * ld + (lane >> 3) * 8;
      const T* qt = qs + (lane & 15) * ld + (lane >> 4) * 8;
      for (int ks = 0; ks < dk; ks += 64) {
        uint32_t bk[4], bk2[4], a[4];
        ldsm_x4(bk, kt + ks);
        ldsm_x4(bk2, kt + ks + 32);
        ldsm_x4(a, qt + ks);
        mma<T>(sc[0], a, bk[0], bk[1]);
        ldsm_x4(a, qt + ks + 16);
        mma<T>(sc[1], a, bk[2], bk[3]);
        ldsm_x4(a, qt + ks + 32);
        mma<T>(sc[2], a, bk2[0], bk2[1]);
        ldsm_x4(a, qt + ks + 48);
        mma<T>(sc[3], a, bk2[2], bk2[3]);
      }
      float s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = (sc[0][i] + sc[1][i]) + (sc[2][i] + sc[3][i]);
      // Scale, mask, and the tile's row maxima.
      const int t0 = t_begin + k * kTile + warp * 8 + (lane & 3) * 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + (i & 1);
        s[i] = t >= t_end ? -INFINITY : (t >= seq_len ? kMasked : s[i] * scale_log2);
      }
      float x0 = fmaxf(s[0], s[1]), x1 = fmaxf(s[2], s[3]);
      x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 2));
      if ((lane & 3) == 0) {
        red[warp * kHMax + r] = x0;
        red[warp * kHMax + r + 8] = x1;
      }
      __syncthreads();
      float n0 = m0, n1 = m1;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        n0 = fmaxf(n0, red[w * kHMax + r]);
        n1 = fmaxf(n1, red[w * kHMax + r + 8]);
      }
      // finite: every tile holds a token of the segment, the first a live one
      const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      const float p0 = exp2f(s[0] - n0), p1 = exp2f(s[1] - n0);
      const float p2 = exp2f(s[2] - n1), p3 = exp2f(s[3] - n1);
      l0 = l0 * a0 + p0 + p1;
      l1 = l1 * a1 + p2 + p3;
      const int pc = warp * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(ps + r * kPLd + pc) = pack2<T>(p0, p1);
      *reinterpret_cast<uint32_t*>(ps + (r + 8) * kPLd + pc) = pack2<T>(p2, p3);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][0] *= a0;
        o[nt][1] *= a0;
        o[nt][2] *= a1;
        o[nt][3] *= a1;
      }
      __syncthreads();  // P of every warp in shared memory

      // O += P V, V the first DV entries of the tile's latents.
      const T* vt = tile + warp * (DV / 4);
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, ps + (lane & 15) * kPLd + kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vt + (kk + (lane & 15)) * ld + np * 16 + (lane >> 4) * 8);
          mma<T>(o[2 * np], a, bv[0], bv[1]);
          mma<T>(o[2 * np + 1], a, bv[2], bv[3]);
        }
      }
    }

    // The segment's partial: m, l (summed over the quad, then the warps), acc.
    l0 += __shfl_xor_sync(kFull, l0, 1);
    l0 += __shfl_xor_sync(kFull, l0, 2);
    l1 += __shfl_xor_sync(kFull, l1, 1);
    l1 += __shfl_xor_sync(kFull, l1, 2);
    if ((lane & 3) == 0) {
      lsum[warp * kHMax + r] = l0;
      lsum[warp * kHMax + r + 8] = l1;
    }
    __syncthreads();
    auto row = [&](int h) { return ws + (static_cast<int64_t>(c + b) * H + h) * (DV + 2); };
    if (warp == 0 && (lane & 3) == 0) {
      const float lt0 = lsum[r] + lsum[kHMax + r] + lsum[2 * kHMax + r] + lsum[3 * kHMax + r];
      const float lt1 = lsum[r + 8] + lsum[kHMax + r + 8] + lsum[2 * kHMax + r + 8] +
                        lsum[3 * kHMax + r + 8];
      if (r < H) {
        row(r)[0] = m0;
        row(r)[1] = lt0;
      }
      if (r + 8 < H) {
        row(r + 8)[0] = m1;
        row(r + 8)[1] = lt1;
      }
    }
    const int c0 = 2 + warp * (DV / 4) + (lane & 3) * 2;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (r < H) *reinterpret_cast<float2*>(row(r) + c0 + nt * 8) = make_float2(o[nt][0], o[nt][1]);
      if (r + 8 < H)
        *reinterpret_cast<float2*>(row(r + 8) + c0 + nt * 8) = make_float2(o[nt][2], o[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------- //
// Route "mma", 17 to 32 heads: two 16-row head tiles in one CTA.
// ---------------------------------------------------------------------- //
__host__ __device__ constexpr size_t mma32_smem_bytes(int dk, int pmax, int B) {
  return 2 * (static_cast<size_t>(kH32) * (dk + kPad) +
              static_cast<size_t>(kStages32) * kTile * (dk + kPad) + static_cast<size_t>(kH32) * kPLd) +
         sizeof(float) * 2 * 4 * kH32 + sizeof(int) * (static_cast<size_t>(pmax) + B + 1);
}

template <typename T, int DV>
__global__ void __launch_bounds__(kThreads32, 1)
paged_mla_mma_kernel_h32(const T* __restrict__ q,                  // [B, H, Dk]
                         const T* __restrict__ lat,                // [P, page, Dk]
                         const int32_t* __restrict__ block_tables, // [B, maxp]
                         const int32_t* __restrict__ seq_lens,     // [B]
                         float* __restrict__ ws,                   // [n + B, H, DV + 2]
                         int B, int H, int P, int page, int dk, int maxp, int pmax, float scale_log2) {
  constexpr int NT = DV / 64;  // n-tiles of 8 columns a warp owns (DV / 8 warps)
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = dk + kPad;
  T* qs = reinterpret_cast<T*>(smem);     // [32][ld]
  T* ring = qs + kH32 * ld;               // [kStages32][kTile][ld]
  T* ps = ring + kStages32 * kTile * ld;  // [32][kPLd]
  float* red = reinterpret_cast<float*>(ps + kH32 * kPLd);  // [4][32] row maxima
  float* lsum = red + 4 * kH32;                              // [4][32] row sums
  int* pids = reinterpret_cast<int*>(lsum + 4 * kH32);       // [pmax]
  int* cum = pids + pmax;                                    // [B + 1]

  const int c = blockIdx.x, n = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tw = warp & 3, mt = warp >> 2;  // S: this warp's tokens and head tile
  page_prefix(seq_lens, B, page, maxp, cum);
  const int total = cum[B];
  const int g0 = cta_first_page(c, n, total), g1 = cta_first_page(c + 1, n, total);
  if (g0 >= g1) return;
  int b = 0;
  while (cum[b + 1] <= g0) ++b;
  for (; b < B && cum[b] < g1; ++b) {
    const int p_begin = max(g0, cum[b]) - cum[b], p_end = min(g1, cum[b + 1]) - cum[b];
    if (p_begin >= p_end) continue;  // a sequence without pages
    const int seq_len = seq_lens[b];
    __syncthreads();  // the previous segment is done with q, the ids and the ring
    const int t_begin = p_begin * page, t_end = p_end * page;
    const int ntiles = (t_end - t_begin + kTile - 1) / kTile;
    const int cpr = dk / 8;

    const T* qb = q + static_cast<int64_t>(b) * H * dk;
    for (int u = tid; u < kH32 * cpr; u += kThreads32) {
      const int row = u / cpr, ch = u - row * cpr;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < H) v = *reinterpret_cast<const uint4*>(qb + row * dk + ch * 8);
      *reinterpret_cast<uint4*>(qs + row * ld + ch * 8) = v;
    }
    const int32_t* bt = block_tables + static_cast<int64_t>(b) * maxp + p_begin;
    for (int j = tid; j < p_end - p_begin; j += kThreads32) pids[j] = min(max(bt[j], 0), P - 1);
    __syncthreads();

    // Tile k's latents into stage k % kStages32, each warp 4 rows; past the
    // last tile an empty group, so that "all but the newest group" is
    // always tile k.
    auto issue = [&](int k) {
      if (k < ntiles) {
        T* st = ring + (k % kStages32) * kTile * ld;
        for (int tok = warp * 4; tok < warp * 4 + 4; ++tok) {
          const int tk = k * kTile + tok;
          const bool ok = t_begin + tk < t_end;
          const T* src = lat;
          if (ok) {
            const int j = tk / page;
            src = lat + (static_cast<int64_t>(pids[j]) * page + (tk - j * page)) * dk;
          }
          for (int ch = lane; ch < cpr; ch += 32)
            cp_async16(st + tok * ld + ch * 8, ok ? src + ch * 8 : lat, ok);
        }
      }
      cp_async_commit();
    };

    float o[2][NT][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) o[t][nt][0] = o[t][nt][1] = o[t][nt][2] = o[t][nt][3] = 0.f;
    const int r = lane >> 2;
    // Running maxima of rows r, r + 8, 16 + r, 24 + r (the rows of o this
    // thread holds; its S rows are two of them), the same in every thread.
    float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    float l0 = 0.f, l1 = 0.f;  // sums of this thread's S rows mt*16 + r, + 8

    issue(0);
    issue(1);
    for (int k = 0; k < ntiles; ++k) {
      cp_async_wait_one();
      __syncthreads();  // tile k landed for every warp; tile k - 1 is done with
      issue(k + 2);
      const T* tile = ring + (k % kStages32) * kTile * ld;

      float sc[4][4] = {};
      const T* kt = tile + (tw * 8 + (lane & 7)) * ld + (lane >> 3) * 8;
      const T* qt = qs + (mt * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
      for (int ks = 0; ks < dk; ks += 64) {
        uint32_t bk[4], bk2[4], a[4];
        ldsm_x4(bk, kt + ks);
        ldsm_x4(bk2, kt + ks + 32);
        ldsm_x4(a, qt + ks);
        mma<T>(sc[0], a, bk[0], bk[1]);
        ldsm_x4(a, qt + ks + 16);
        mma<T>(sc[1], a, bk[2], bk[3]);
        ldsm_x4(a, qt + ks + 32);
        mma<T>(sc[2], a, bk2[0], bk2[1]);
        ldsm_x4(a, qt + ks + 48);
        mma<T>(sc[3], a, bk2[2], bk2[3]);
      }
      float s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = (sc[0][i] + sc[1][i]) + (sc[2][i] + sc[3][i]);
      const int t0 = t_begin + k * kTile + tw * 8 + (lane & 3) * 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + (i & 1);
        s[i] = t >= t_end ? -INFINITY : (t >= seq_len ? kMasked : s[i] * scale_log2);
      }
      float x0 = fmaxf(s[0], s[1]), x1 = fmaxf(s[2], s[3]);
      x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 2));
      if ((lane & 3) == 0) {
        red[tw * kH32 + mt * 16 + r] = x0;
        red[tw * kH32 + mt * 16 + r + 8] = x1;
      }
      __syncthreads();
      float a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = (j >> 1) * 16 + (j & 1) * 8 + r;
        float nm = m[j];
#pragma unroll
        for (int w = 0; w < 4; ++w) nm = fmaxf(nm, red[w * kH32 + row]);
        // finite: every tile holds a token of the segment, the first a live one
        a[j] = exp2f(m[j] - nm);
        m[j] = nm;
      }
      const float n0 = mt ? m[2] : m[0], n1 = mt ? m[3] : m[1];
      const float a0 = mt ? a[2] : a[0], a1 = mt ? a[3] : a[1];
      const float p0 = exp2f(s[0] - n0), p1 = exp2f(s[1] - n0);
      const float p2 = exp2f(s[2] - n1), p3 = exp2f(s[3] - n1);
      l0 = l0 * a0 + p0 + p1;
      l1 = l1 * a1 + p2 + p3;
      const int pc = tw * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(ps + (mt * 16 + r) * kPLd + pc) = pack2<T>(p0, p1);
      *reinterpret_cast<uint32_t*>(ps + (mt * 16 + r + 8) * kPLd + pc) = pack2<T>(p2, p3);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          o[t][nt][0] *= a[2 * t];
          o[t][nt][1] *= a[2 * t];
          o[t][nt][2] *= a[2 * t + 1];
          o[t][nt][3] *= a[2 * t + 1];
        }
      __syncthreads();  // P of every warp in shared memory

      // O += P V for this warp's DV/8 columns, both head tiles.
      const T* vt = tile + warp * (DV / 8);
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        uint32_t a0f[4], a1f[4];
        ldsm_x4(a0f, ps + (lane & 15) * kPLd + kk + (lane >> 4) * 8);
        ldsm_x4(a1f, ps + (16 + (lane & 15)) * kPLd + kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vt + (kk + (lane & 15)) * ld + np * 16 + (lane >> 4) * 8);
          mma<T>(o[0][2 * np], a0f, bv[0], bv[1]);
          mma<T>(o[0][2 * np + 1], a0f, bv[2], bv[3]);
          mma<T>(o[1][2 * np], a1f, bv[0], bv[1]);
          mma<T>(o[1][2 * np + 1], a1f, bv[2], bv[3]);
        }
      }
    }
    cp_async_wait_all();  // the empty groups past the last tile

    l0 += __shfl_xor_sync(kFull, l0, 1);
    l0 += __shfl_xor_sync(kFull, l0, 2);
    l1 += __shfl_xor_sync(kFull, l1, 1);
    l1 += __shfl_xor_sync(kFull, l1, 2);
    if ((lane & 3) == 0) {
      lsum[tw * kH32 + mt * 16 + r] = l0;
      lsum[tw * kH32 + mt * 16 + r + 8] = l1;
    }
    __syncthreads();
    auto row = [&](int h) { return ws + (static_cast<int64_t>(c + b) * H + h) * (DV + 2); };
    if (warp == 0 && (lane & 3) == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = (j >> 1) * 16 + (j & 1) * 8 + r;
        if (h < H) {
          row(h)[0] = m[j];
          row(h)[1] = lsum[h] + lsum[kH32 + h] + lsum[2 * kH32 + h] + lsum[3 * kH32 + h];
        }
      }
    }
    const int c0 = 2 + warp * (DV / 8) + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int h0 = t * 16 + r, h1 = h0 + 8;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (h0 < H)
          *reinterpret_cast<float2*>(row(h0) + c0 + nt * 8) = make_float2(o[t][nt][0], o[t][nt][1]);
        if (h1 < H)
          *reinterpret_cast<float2*>(row(h1) + c0 + nt * 8) = make_float2(o[t][nt][2], o[t][nt][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------- //
// Route "simt".
// ---------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_mla_simt_kernel(const T* __restrict__ q, const T* __restrict__ lat,
                      const int32_t* __restrict__ block_tables, const int32_t* __restrict__ seq_lens,
                      float* __restrict__ ws, int B, int H, int P, int page, int dk, int dv,
                      int maxp, float scale_log2) {
  constexpr int EK = kMaxDk / 32, EV = kMaxDv / 32, GW = kHMax / 4;
  extern __shared__ int cum[];  // [B + 1]
  const int c = blockIdx.x, n = gridDim.x, h0 = blockIdx.y * kHMax;  // grid row: 16 heads
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  page_prefix(seq_lens, B, page, maxp, cum);
  const int total = cum[B];
  const int g0 = cta_first_page(c, n, total), g1 = cta_first_page(c + 1, n, total);
  if (g0 >= g1) return;
  int b = 0;
  while (cum[b + 1] <= g0) ++b;
  for (; b < B && cum[b] < g1; ++b) {
    const int p_begin = max(g0, cum[b]) - cum[b], p_end = min(g1, cum[b + 1]) - cum[b];
    if (p_begin >= p_end) continue;
    const int seq_len = seq_lens[b];
    // This warp's heads: h0 + warp, h0 + warp + 4, ...
    float qr[GW][EK], acc[GW][EV], m[GW], l[GW];
#pragma unroll
    for (int gi = 0; gi < GW; ++gi) {
      const int h = h0 + warp + 4 * gi;
      m[gi] = -INFINITY;
      l[gi] = 0.f;
#pragma unroll
      for (int e = 0; e < EK; ++e) {
        const int di = lane + 32 * e;
        qr[gi][e] = h < H && di < dk
                        ? to_f32(q[(static_cast<int64_t>(b) * H + h) * dk + di]) * scale_log2
                        : 0.f;
      }
#pragma unroll
      for (int e = 0; e < EV; ++e) acc[gi][e] = 0.f;
    }
    const int32_t* bt = block_tables + static_cast<int64_t>(b) * maxp;
    for (int t = p_begin * page; t < p_end * page; ++t) {
      const int j = t / page;
      const int pid = min(max(bt[j], 0), P - 1);
      const T* row = lat + (static_cast<int64_t>(pid) * page + (t - j * page)) * dk;
      float x[EK];
#pragma unroll
      for (int e = 0; e < EK; ++e) {
        const int di = lane + 32 * e;
        x[e] = di < dk ? to_f32(row[di]) : 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < GW; ++gi) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EK; ++e) s = fmaf(qr[gi][e], x[e], s);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        if (t >= seq_len) s = kMasked;
        const float mn = fmaxf(m[gi], s);
        const float alpha = exp2f(m[gi] - mn), p = exp2f(s - mn);
        m[gi] = mn;
        l[gi] = l[gi] * alpha + p;
#pragma unroll
        for (int e = 0; e < EV; ++e) acc[gi][e] = fmaf(p, x[e], acc[gi][e] * alpha);
      }
    }
#pragma unroll
    for (int gi = 0; gi < GW; ++gi) {
      const int h = h0 + warp + 4 * gi;
      if (h >= H) continue;
      float* w = ws + (static_cast<int64_t>(c + b) * H + h) * (dv + 2);
      if (lane == 0) {
        w[0] = m[gi];
        w[1] = l[gi];
      }
#pragma unroll
      for (int e = 0; e < EV; ++e) {
        const int di = lane + 32 * e;
        if (di < dv) w[2 + di] = acc[gi][e];
      }
    }
  }
}

// One CTA per (head, sequence): the partials of the CTAs whose pages hold
// the sequence's (from the first's to the last's, skipping CTAs given no
// page), merged.  Their (m, l) and weights 2^(m_i - m) go through shared
// memory once; then each thread sums its columns over the partials, the
// loads of one partial independent of each other.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_mla_combine_kernel(const float* __restrict__ ws, const int32_t* __restrict__ seq_lens,
                         T* __restrict__ out, int B, int H, int page, int maxp, int n, int dv) {
  extern __shared__ float sm[];  // [B + 1] page counts, then per CTA lo..hi: m, l
  int* cum = reinterpret_cast<int*>(sm);
  const int h = blockIdx.x, b = blockIdx.y;
  page_prefix(seq_lens, B, page, maxp, cum);
  const int total = cum[B], p0 = cum[b], p1 = cum[b + 1];
  const int lo = p0 < p1 ? cta_of(p0, n, total) : 0;
  const int hi = p0 < p1 ? cta_of(p1 - 1, n, total) : -1;  // none for seq_len 0: zeros
  const int k = hi - lo + 1;
  float* mw = sm + B + 1;  // [k] m_i (-inf for a CTA given no page), then weights
  float* lw = mw + k;      // [k] l_i
  auto part = [&](int c) { return ws + (static_cast<int64_t>(c + b) * H + h) * (dv + 2); };
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const int c = lo + i;
    const bool empty = cta_first_page(c, n, total) == cta_first_page(c + 1, n, total);
    mw[i] = empty ? -INFINITY : part(c)[0];
    lw[i] = empty ? 0.f : part(c)[1];
  }
  __syncthreads();
  float mx = -INFINITY, lt = 0.f;
  for (int i = 0; i < k; ++i) mx = fmaxf(mx, mw[i]);
  for (int i = 0; i < k; ++i) lt += lw[i] * exp2f(mw[i] - mx);  // an empty CTA weighs 0
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x) mw[i] = exp2f(mw[i] - mx);
  __syncthreads();
  const float inv = 1.f / fmaxf(lt, 1e-30f);
  T* o = out + (static_cast<int64_t>(b) * H + h) * dv;
  for (int d0 = threadIdx.x; d0 < dv; d0 += 4 * blockDim.x) {
    float at[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < k; ++i) {
      const float f = mw[i];
      if (f == 0.f) continue;
      const float* w = part(lo + i) + 2;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int di = d0 + u * blockDim.x;
        if (di < dv) at[u] += w[di] * f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int di = d0 + u * blockDim.x;
      if (di < dv) o[di] = from_f32<T>(at[u] * inv);
    }
  }
}

template <typename T, int DV>
int launch_mma(const void* q, const void* lat, const void* bt, const void* sl, float* ws, int B,
               int H, int P, int page, int dk, int maxp, int n, int pmax, float scale,
               cudaStream_t stream) {
  // The opt-in to more than 48 KB, once, for the largest shapes taken (no
  // call in a graph capture after the first).
  static bool opted = false;
  if (!opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(paged_mla_mma_kernel<T, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(mma_smem_bytes(kMaxDk, kMaxPps, kMaxB)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const size_t smem = mma_smem_bytes(dk, pmax, B);
  paged_mla_mma_kernel<T, DV><<<n, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(lat), static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(sl), ws, B, H, P, page, dk, maxp, pmax, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DV>
int launch_mma32(const void* q, const void* lat, const void* bt, const void* sl, float* ws, int B,
                 int H, int P, int page, int dk, int maxp, int n, int pmax, float scale,
                 cudaStream_t stream) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_mla_mma_kernel_h32<T, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(mma32_smem_bytes(kMaxDk, kMaxPps, kMaxB)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const size_t smem = mma32_smem_bytes(dk, pmax, B);
  paged_mla_mma_kernel_h32<T, DV><<<n, kThreads32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(lat), static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(sl), ws, B, H, P, page, dk, maxp, pmax, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt(const void* q, const void* lat, const void* bt, const void* sl, float* ws, int B,
                int H, int P, int page, int dk, int dv, int maxp, int n, float scale,
                cudaStream_t s) {
  const dim3 grid(n, (H + kHMax - 1) / kHMax);
  paged_mla_simt_kernel<T><<<grid, kThreads, sizeof(int) * (B + 1), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(lat), static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(sl), ws, B, H, P, page, dk, dv, maxp, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q and the pool share it); route:
// 0 mma (16-bit types, dk % 64 == 0, dv 512, q and the pool
// 16-byte aligned; H <= 16 paged_mla_mma_kernel, 17 to 32
// paged_mla_mma_kernel_h32), 1 simt (dk <= 576, dv <= 512); H <= 32.  n CTAs share the pages
// (see the schedule above), pmax >= ceil(B * maxp / n) of them at most
// each; ws is fp32 [n + B, H, dv + 2].
extern "C" int paged_mla_split_launch(int dtype, int route, const void* q, const void* lat,
                                      const void* block_tables, const void* seq_lens, void* ws,
                                      int B, int H, int P, int page, int dk, int dv, int maxp,
                                      int n, int pmax, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (H > kH32 || B > kMaxB || P <= 0 || page <= 0 || dk <= 0 || dv <= 0 || dv > dk || n <= 0 ||
      n > 65535 || pmax <= 0 || pmax > kMaxPps ||
      static_cast<int64_t>(pmax) * n < static_cast<int64_t>(B) * maxp)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (route == 0) {
    if (dk % 64 || dk > kMaxDk || dv != kMaxDv) return static_cast<int>(cudaErrorInvalidValue);
    if (H > kHMax) {
      if (dtype == 1)
        return launch_mma32<__nv_bfloat16, kMaxDv>(q, lat, block_tables, seq_lens, w, B, H, P, page,
                                                   dk, maxp, n, pmax, scale, s);
      if (dtype == 2)
        return launch_mma32<__half, kMaxDv>(q, lat, block_tables, seq_lens, w, B, H, P, page, dk,
                                            maxp, n, pmax, scale, s);
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (dtype == 1)
      return launch_mma<__nv_bfloat16, kMaxDv>(q, lat, block_tables, seq_lens, w, B, H, P, page, dk,
                                               maxp, n, pmax, scale, s);
    if (dtype == 2)
      return launch_mma<__half, kMaxDv>(q, lat, block_tables, seq_lens, w, B, H, P, page, dk, maxp, n,
                                        pmax, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != 1 || dk > kMaxDk || dv > kMaxDv) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_simt<float>(q, lat, block_tables, seq_lens, w, B, H, P, page, dk, dv, maxp, n,
                                scale, s);
    case 1:
      return launch_simt<__nv_bfloat16>(q, lat, block_tables, seq_lens, w, B, H, P, page, dk, dv,
                                        maxp, n, scale, s);
    case 2:
      return launch_simt<__half>(q, lat, block_tables, seq_lens, w, B, H, P, page, dk, dv, maxp, n,
                                 scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [B, H, dv] in dtype from the partials ws [n + B, H, dv + 2].
extern "C" int paged_mla_combine_launch(int dtype, const void* ws, const void* seq_lens, void* out,
                                        int B, int H, int page, int maxp, int n, int dv,
                                        void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (dv <= 0 || n <= 0 || B > kMaxB || H > 65535 || sizeof(float) * (B + 1 + 2 * n) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, B);
  // the sequences' page counts, and (m, l) of up to n CTAs
  const size_t smem = sizeof(float) * (static_cast<size_t>(B) + 1 + 2 * static_cast<size_t>(n));
  const float* w = static_cast<const float*>(ws);
  const int32_t* sl = static_cast<const int32_t*>(seq_lens);
  switch (dtype) {
    case 0:
      paged_mla_combine_kernel<float><<<grid, kThreads, smem, s>>>(w, sl, static_cast<float*>(out), B, H,
                                                                   page, maxp, n, dv);
      break;
    case 1:
      paged_mla_combine_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
          w, sl, static_cast<__nv_bfloat16*>(out), B, H, page, maxp, n, dv);
      break;
    case 2:
      paged_mla_combine_kernel<__half><<<grid, kThreads, smem, s>>>(w, sl, static_cast<__half*>(out), B, H,
                                                                    page, maxp, n, dv);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
