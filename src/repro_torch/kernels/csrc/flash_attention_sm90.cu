// Blocked (flash) attention, forward only, on Hopper's tensor cores: the
// bf16/fp16 route at query-key / value head widths (Dk, Dv) of (64, 64),
// (128, 128), (256, 256) and (192, 128) (latent attention's heads:
// nope 128 + rope 64 against values of 128).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::_flash_kernel  (flash_attention)
// for those inputs; fp32 and the other widths stay on the SIMT kernel in
// flash_attention.cu.  repro_torch.kernels.ops.flash_attention picks the
// route (ops._flash_route); the served prefill's causal self-attention
// reaches it through repro_torch.models.layers (prefill_route).
//
// What it computes is flash_attention.cu's function: out = softmax(q k^T *
// scale) v over q [B, H, S, Dk], k [B, Hkv, S, Dk] and v [B, Hkv, S, Dv]
// (query head h reads KV head h / (H / Hkv)), out [B, H, S, Dv], each
// tensor at its own strides along B, heads and S (unit stride along the
// width), so the model's [B, S, H, D] layout is read and written in
// place; logits and (m, l, acc) in fp32; with causal a key
// after its query is masked to -1e30, keys past S get no weight, key tiles
// wholly above the diagonal are skipped and rows past S are not stored;
// out = acc / max(l, 1e-30) in q's dtype.  P is rounded to q's dtype before
// P V (the tensor cores' operand type); l sums the fp32 probabilities.
//
// Bound.  At S = 4,096 attention does ~2*S*(Dk + Dv) flops per query row
// for S*(Dk + Dv) K/V elements: far above the ~295 flops/byte balance, so
// the tensor-core rate bounds it.
//
// Design (FlashAttention-3's forward, without its warpgroup ping-pong).
// One CTA per (head, 128-query tile, batch), heads fastest in the grid so
// that the heaviest causal tiles of every head launch first;
// three warpgroups: a producer (one thread issues every copy, setmaxnreg
// gives its registers away) and two consumers of 64 query rows each.
// - Copies are TMA (cp.async.bulk.tensor, 4-d maps {D, S, heads, B} at the
//   tensor's strides, built on the host with cuTensorMapEncodeTiled,
//   passed as __grid_constant__): the Q tile once, then K and V tiles
//   through a ring of stages (as many as fit, at most 3: 3 at D 64/128
//   and at 192/128, 2 at D 256), full/empty mbarriers per stage.  Every box
//   is 64 elements (128 bytes) wide with the 128-byte swizzle, so a tile
//   is D/64 column blocks of rows x 128 bytes, 1024-byte aligned.  Rows
//   past S come in as zeros.
// - Per warpgroup the softmax of key tile t overlaps the P V product of
//   tile t-1 (two wgmma groups in flight, FlashAttention-3's intra-
//   warpgroup pipelining).
// - S = Q K^T by wgmma m64nBKk16 (Dk/16 steps) with both operands in shared memory,
//   K-major (descriptor: 128-byte swizzle, 1024-byte stride between 8-row
//   groups; one k16 step is +32 bytes inside the swizzle row).
// - Online softmax on the accumulator fragment (a thread holds rows r and
//   r + 8 of its warp's 16, two columns in each 8-column block): row max and
//   sum over the quad by shuffles, exp2f with scale * log2(e) folded in.
// - O += P V by wgmma m64nDvk16 with P from registers (the S fragment is the
//   A fragment, packed to q's dtype) and V from shared memory MN-major (the
//   descriptor's transpose bit; 1024 bytes between 8-key groups, BK*128
//   bytes between 64-column blocks).
// - Key tile 128 at Dk 64/128, 64 at Dk 192 and 256 (at 256 O is 128 fp32
//   registers a thread; at 192/128 a ring of 3 stages of 64 keys, 169 KB,
//   ran 9-13% faster than 2 stages of 128, 208 KB, at S 1,359-4,155 with
//   16 heads on an H100 SXM).  Shared memory: 112/224/192 KB at D
//   64/128/256.
//
// Plain C interface, bound with ctypes: the launcher returns the CUDA error
// code of its launch (0 on success), or kEncodeFailed + the CUresult when a
// tensor map cannot be encoded, and never synchronises.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kBq = 128;       // query rows per CTA: two consumer warpgroups
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kSmemOptin = 232448;  // a block's shared memory on an H100

template <int DK, int DV>
struct Cfg {
  static constexpr int BK = DK >= 192 ? 64 : 128;  // keys per tile
  static constexpr int CK = DK / 64;               // 128-byte column blocks of Q, K
  static constexpr int CV = DV / 64;               // and of V, O
  static constexpr int Q_BYTES = kBq * DK * 2;
  static constexpr int K_BYTES = BK * DK * 2;      // one K tile
  static constexpr int V_BYTES = BK * DV * 2;      // one V tile
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int FIXED = Q_BYTES + 8 * 7 + 1024;  // Q, barriers, alignment slack
  static constexpr int FIT = (kSmemOptin - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 3 ? FIT : 3;  // K/V ring depth
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;  // + alignment slack
  static_assert(STAGES >= 2 && SMEM <= kSmemOptin, "the K/V ring needs two stages");
  static_assert(DK % 64 == 0 && DV % 64 == 0 && DV <= DK, "widths");
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One consumer warpgroup: 64 query rows against every key tile it needs.
// Fragment of an m64nN accumulator: register n*4 + i*2 + j holds row
// warp*16 + lane/4 + 8*i, column n*8 + (lane%4)*2 + j.
//
// The loop overlaps tile t's softmax with tile t-1's P V: it issues
// S_t = Q K_t^T and O += P_{t-1} V_{t-1} as two wgmma groups, waits for
// the first, runs the softmax on S_t while the second runs, then waits for
// it, releases stage t-1, rescales O and packs P_t.
template <typename T, int DK, int DV>
__device__ __forceinline__ void consume(uint32_t q_s, uint32_t kv_s, uint32_t full0, uint32_t empty0,
                                        uint32_t qbar, T* __restrict__ oh, int64_t o_ss, int S,
                                        int q0, int n_tiles, int cw, float scale_log2, int causal) {
  using C = Cfg<DK, DV>;
  constexpr int BK = C::BK;
  constexpr int NS = BK / 2;  // S accumulator registers
  constexpr int NO = DV / 2;  // O accumulator registers
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + cw * 64;                       // the warpgroup's first row
  const int r_lo = row0 + warp * 16 + lane / 4;        // this thread's rows r_lo, r_lo + 8
  const int my_tiles = causal ? min(n_tiles, min(row0 + 63, S - 1) / BK + 1) : n_tiles;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  const uint32_t qa = q_s + cw * 64 * 128;

  auto k_tile = [&](int t) { return kv_s + (t % C::STAGES) * C::STAGE_BYTES; };
  auto wait_tile = [&](int t) { mbar_wait(full0 + 8 * (t % C::STAGES), (t / C::STAGES) & 1); };
  auto release_tile = [&](int t) { mbar_arrive(empty0 + 8 * (t % C::STAGES)); };
  // S = Q K_t^T, issued as one wgmma group.
  auto issue_qk = [&](float (&s)[NS], int t) {
    const uint32_t ks = k_tile(t);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t col = kk / 4, inner = (kk % 4) * 32;
      wgmma_ss<BK, T>(s, desc_sw128(qa + col * kBq * 128 + inner, 16, 1024),
                      desc_sw128(ks + col * BK * 128 + inner, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V_t, issued as one wgmma group.
  auto issue_pv = [&](const uint32_t (&pa)[BK / 16][4], int t) {
    const uint32_t vs = k_tile(t) + C::K_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DV, T>(o, pa[kk], desc_sw128(vs + kk * 16 * 128, BK * 128, 1024));
    wgmma_commit();
  };
  // Scale, mask and exponentiate S_t in place; returns O's rescale factors.
  auto softmax = [&](float (&s)[NS], int t, float& a0, float& a1) {
    const int k0 = t * BK;
    const bool edge = (causal && k0 + BK - 1 > row0) || k0 + BK > S;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + n * 8 + (lane % 4) * 2 + j;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = s[n * 4 + i * 2 + j] * scale_log2;
          if (edge) {
            if (key >= S) x = -INFINITY;  // past the sequence: no weight
            else if (causal && key > r_lo + 8 * i) x = kMasked;
          }
          s[n * 4 + i * 2 + j] = x;
        }
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n * 4 + 0], s[n * 4 + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[n * 4 + 2], s[n * 4 + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    a0 = exp2f(m0 - mx0);
    a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n * 4 + 0] = exp2f(s[n * 4 + 0] - mx0);
      s[n * 4 + 1] = exp2f(s[n * 4 + 1] - mx0);
      s[n * 4 + 2] = exp2f(s[n * 4 + 2] - mx1);
      s[n * 4 + 3] = exp2f(s[n * 4 + 3] - mx1);
      ps0 += s[n * 4 + 0] + s[n * 4 + 1];
      ps1 += s[n * 4 + 2] + s[n * 4 + 3];
    }
    l0 = l0 * a0 + ps0;  // a per-thread partial: the quad sums it at the end
    l1 = l1 * a1 + ps1;
  };
  // The S fragment is the A fragment of P V, packed to q's dtype.
  auto pack_p = [&](const float (&s)[NS], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto rescale_o = [&](float a0, float a1) {
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[n * 4 + 0] *= a0;
      o[n * 4 + 1] *= a0;
      o[n * 4 + 2] *= a1;
      o[n * 4 + 3] *= a1;
    }
  };

  float s[NS];
  uint32_t pa[BK / 16][4];
  float a0, a1;
  mbar_wait(qbar, 0);
  wait_tile(0);
  issue_qk(s, 0);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(s, 0, a0, a1);  // O is still zero: no rescale
  pack_p(s, pa);
  for (int t = 1; t < my_tiles; ++t) {
    wait_tile(t);
    issue_qk(s, t);
    issue_pv(pa, t - 1);
    wgmma_wait<1>();  // S_t is in; P_{t-1} V_{t-1} still runs
    fence_regs(s);
    softmax(s, t, a0, a1);
    wgmma_wait<0>();
    fence_regs(o);
    release_tile(t - 1);
    rescale_o(a0, a1);
    pack_p(s, pa);
  }
  issue_pv(pa, my_tiles - 1);
  wgmma_wait<0>();
  fence_regs(o);
  release_tile(my_tiles - 1);
  // Tiles wholly above this warpgroup's diagonal: released once they are
  // in (so an arrival never counts toward an earlier phase of the stage).
  for (int t = my_tiles; t < n_tiles; ++t) {
    wait_tile(t);
    release_tile(t);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= S) continue;
    T* orow = oh + row * o_ss + (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack2<T>(o[n * 4 + i * 2] * inv[i], o[n * 4 + i * 2 + 1] * inv[i]);
    }
  }
}

// The output's element strides along B, heads and S (unit along Dv).
struct OutStrides {
  int64_t b, h, s;
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(__grid_constant__ const CUtensorMap qmap, __grid_constant__ const CUtensorMap kmap,
                  __grid_constant__ const CUtensorMap vmap, T* __restrict__ out, OutStrides os,
                  int H, int hkv, int S, float scale_log2, int causal) {
  using C = Cfg<DK, DV>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;  // swizzled tiles want 1024-byte alignment
  const uint32_t kv_s = q_s + C::Q_BYTES;        // stage st: K, then V
  const uint32_t full0 = q_s + C::BAR_OFF;
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  const uint32_t qbar = empty0 + 8 * C::STAGES;

  const int qb = gridDim.y - 1 - blockIdx.y;  // the heaviest causal tiles first
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int q0 = qb * kBq;
  const int last_row = min(q0 + kBq, S) - 1;
  const int n_tiles = causal ? last_row / BK + 1 : (S + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 256);  // every consumer thread releases the stage
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int c = 0; c < C::CK; ++c)
        tma_load_4d(q_s + c * kBq * 128, &qmap, qbar, c * 64, q0, h, b);
      const int kvh = h / (H / hkv);  // GQA by index
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % C::STAGES;
        mbar_wait(empty0 + 8 * st, ((t / C::STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, C::STAGE_BYTES);
        const uint32_t ks = kv_s + st * C::STAGE_BYTES;
        for (int c = 0; c < C::CK; ++c)
          tma_load_4d(ks + c * BK * 128, &kmap, full, c * 64, t * BK, kvh, b);
        for (int c = 0; c < C::CV; ++c)
          tma_load_4d(ks + C::K_BYTES + c * BK * 128, &vmap, full, c * 64, t * BK, kvh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<T, DK, DV>(q_s, kv_s, full0, empty0, qbar, out + b * os.b + h * os.h, os.s, S, q0,
                       n_tiles, wg - 1, scale_log2, causal);
  }
}

// ---- host ------------------------------------------------------------------
// A [B, heads, S, D] tensor at element strides st = {b, h, s} (unit along
// D) as the 4-d map {D, S, heads, B}, boxes of 64 x rows x 1 x 1.
template <typename T>
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B, int heads, int S, int D,
                const long long* st, int rows) {
  const CUtensorMapDataType ty = std::is_same_v<T, __nv_bfloat16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, ty, 4, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// st: the element strides {b, h, s} of q, k, v and out, in that order.
template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int hkv, int S,
           const long long* st, float scale, int causal, cudaStream_t stream) {
  using C = Cfg<DK, DV>;
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kEncodeFailed + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  CUtensorMap qm, km, vm;
  CUresult r = encode<T>(fn, &qm, q, B, H, S, DK, st, kBq);
  if (r == CUDA_SUCCESS) r = encode<T>(fn, &km, k, B, hkv, S, DK, st + 3, C::BK);
  if (r == CUDA_SUCCESS) r = encode<T>(fn, &vm, v, B, hkv, S, DV, st + 6, C::BK);
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  static bool opted_in = false;  // per instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_sm90_kernel<T, DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(H, (S + kBq - 1) / kBq, B);
  flash_sm90_kernel<T, DK, DV><<<grid, kThreads, C::SMEM, stream>>>(
      qm, km, vm, static_cast<T*>(out), OutStrides{st[9], st[10], st[11]}, H, hkv, S,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int H, int hkv, int S,
             int DK, int DV, const long long* st, float scale, int causal, cudaStream_t s) {
  if (DK == 64 && DV == 64) return launch<T, 64, 64>(q, k, v, out, B, H, hkv, S, st, scale, causal, s);
  if (DK == 128 && DV == 128) return launch<T, 128, 128>(q, k, v, out, B, H, hkv, S, st, scale, causal, s);
  if (DK == 256 && DV == 256) return launch<T, 256, 256>(q, k, v, out, B, H, hkv, S, st, scale, causal, s);
  if (DK == 192 && DV == 128) return launch<T, 192, 128>(q, k, v, out, B, H, hkv, S, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 1 bfloat16, 2 float16 (q, k, v and out share it); (DK, DV) one of
// (64, 64), (128, 128), (256, 256), (192, 128); strides: 12 element
// strides, {b, h, s} of q, k, v and out in turn, each a multiple of 8
// (16 bytes), every pointer 16-byte aligned, unit stride along the width.
extern "C" int flash_attention_sm90_launch(int dtype, const void* q, const void* k, const void* v,
                                           void* out, int B, int H, int hkv, int S, int DK, int DV,
                                           const long long* strides, float scale, int causal,
                                           void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (hkv <= 0 || H % hkv || B > 65535 || H > 65535 || (S + kBq - 1) / kBq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch_d<__nv_bfloat16>(q, k, v, out, B, H, hkv, S, DK, DV, strides, scale, causal, s);
    case 2: return launch_d<__half>(q, k, v, out, B, H, hkv, S, DK, DV, strides, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
