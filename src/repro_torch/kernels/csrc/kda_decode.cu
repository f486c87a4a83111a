// One decode token of Kimi Delta Attention (KDA) for a batch, in place on
// the state slots.
//
// Replaces no TPU kernel: the JAX package has no KDA layer.  It is the
// state update of the port's Kimi-Linear decode step, launched once per
// KDA layer per step (repro_torch.kernels.ops.kda_decode; plain version
// kernels/kda_decode.py::kda_decode_plain).
//
// What it computes, for each sequence b and head h, with S the K x V fp32
// state at row slots[b] of the layer's slots [S, H, K, V]:
//   S <- Diag(exp g) S;  u = beta (v - S^T k);  S <- S + k u^T;
//   o = scale * S^T q = scale * ((Diag(exp g) S_old)^T q + u (k . q)),
// S written back in place; q, k, g [B, H, K], v and o [B, H, V], beta
// [B, H], all fp32.  Slot ids are clamped into [0, S - 1].
//
// Bound.  Per (sequence, head) the state is read and written once (2 K V
// fp32: 128 KB at K = V = 128) against ~6 K V operations: 0.75 an operation
// a byte, so the kernel is bound by bytes and the state's two passes are
// all that counts.
//
// Design.  One CTA per (sequence, head), 256 threads: thread (group,
// column) owns column `column` of rows [group * K/2, (group + 1) * K/2)
// of S, held in registers from one load to one store (a warp's 32 loads of
// a row are 128 contiguous bytes).  k, q and exp(g) sit in shared memory.
// Each thread sums its rows of (decayed S)^T k and ^T q; the two groups'
// sums meet in shared memory, then every thread forms u for its column,
// writes its rows of the new S, and group 0 writes o.  Two __syncthreads.
//
// Plain C interface, bound with ctypes: the launcher returns the CUDA error
// code of its launch (0 on success) and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;               // V at most: one column a thread
constexpr int kGroups = 2;               // row groups of a CTA
constexpr int kThreads = kCols * kGroups;
constexpr int kMaxK = 128;
constexpr int kRows = kMaxK / kGroups;   // rows of one thread at most
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
kda_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ beta, float* __restrict__ state,
                  const int32_t* __restrict__ slots, float* __restrict__ out, int H, int K, int V,
                  int S, float scale) {
  __shared__ float ks[kMaxK], qs[kMaxK], eg[kMaxK];
  __shared__ float red[2][kGroups][kCols];
  __shared__ float kq;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, col = tid % kCols, grp = tid / kCols;
  const int64_t in = static_cast<int64_t>(bh) * K;
  for (int i = tid; i < K; i += kThreads) {
    ks[i] = k[in + i];
    qs[i] = q[in + i];
    eg[i] = expf(g[in + i]);
  }
  __syncthreads();
  if (tid < 32) {
    float a = 0.f;
    for (int i = tid; i < K; i += 32) a = fmaf(ks[i], qs[i], a);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
    if (tid == 0) kq = a;
  }
  const int slot = min(max(slots[b], 0), S - 1);
  float* st = state + (static_cast<int64_t>(slot) * H + h) * K * V;
  const int rows = (K + kGroups - 1) / kGroups;
  const int r0 = grp * rows, r1 = min(K, r0 + rows);
  float s[kRows];
  float dk = 0.f, dq = 0.f;
  if (col < V) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i;
      s[i] = r < r1 ? st[static_cast<int64_t>(r) * V + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i;
      if (r < r1) {
        s[i] *= eg[r];
        dk = fmaf(s[i], ks[r], dk);
        dq = fmaf(s[i], qs[r], dq);
      }
    }
  }
  red[0][grp][col] = dk;
  red[1][grp][col] = dq;
  __syncthreads();
  if (col >= V) return;
  float tk = 0.f, tq = 0.f;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    tk += red[0][j][col];
    tq += red[1][j][col];
  }
  const float u = beta[bh] * (v[static_cast<int64_t>(bh) * V + col] - tk);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i;
    if (r < r1) st[static_cast<int64_t>(r) * V + col] = fmaf(ks[r], u, s[i]);
  }
  if (grp == 0) out[static_cast<int64_t>(bh) * V + col] = scale * fmaf(u, kq, tq);
}

}  // namespace

// q k g [B, H, K], v [B, H, V], beta [B, H], state [S, H, K, V] (updated in
// place), slots int32 [B], out [B, H, V]; fp32 but the slots; K, V <= 128.
extern "C" int kda_decode_launch(const void* q, const void* k, const void* v, const void* g,
                                 const void* beta, void* state, const void* slots, void* out, int B,
                                 int H, int K, int V, int S, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (K <= 0 || K > kMaxK || V <= 0 || V > kCols || S <= 0 ||
      static_cast<int64_t>(B) * H > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  kda_decode_kernel<<<B * H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(beta), static_cast<float*>(state),
      static_cast<const int32_t*>(slots), static_cast<float*>(out), H, K, V, S, scale);
  return static_cast<int>(cudaGetLastError());
}
