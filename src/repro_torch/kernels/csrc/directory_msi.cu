// In-network MSI directory transitions, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/directory_msi.py::_msi_kernel  (msi_transition)
// which the JAX package reaches through repro.kernels.ops.msi_transition.
//
// What it computes: the requests (slots[i], requesters[i], is_write[i]) are
// applied to the directory (state, sharers, owner) [S] one after the other,
// in batch order -- the switch's packet serialisation -- through the
// materialized 24x5 transition table.  Each request reads its entry, picks
// the table row ((state*2 + w)*2 + is_owner)*2 + in_sharers, emits
// fetch_src and inval_mask, and writes the entry back.  The inputs are left
// as they are.
//
// Integer semantics are XLA's, for any int32 input (C++ leaves the first
// two undefined, so every shift is guarded):
//   1 << k        is 0 for k outside [0, 31]; 1 << 31 is INT32_MIN;
//   x >> k        fills with the sign bit for k outside [0, 31];
//   slot, row     a negative index counts from the end once, then it is
//                 clamped into [0, n-1], as jnp reads a ref;
//   row index     wraps in int32.
//
// Bound.  The function moves each request's three words in and two out,
// and the directory once in and once out: bytes bound it, microseconds at
// 1.6M requests.  What really bounds it is the longest dependency chain: a
// request reads only its own slot's entry and writes only that entry back,
// so the requests of one slot are a chain that runs in batch order, and
// different slots are independent.  Under MIND's zipf(1.1) traffic the
// hottest of 30,000 slots takes ~14% of the batch.
//
// Design: group the requests by slot, then walk every slot's chain at once.
// 1. msi_keys_kernel: each request's clamped slot (jnp_index); the
//    directory is copied into the outputs (slots without requests keep it).
// 2. A stable LSD radix sort of the requests on the clamped slot, 8 bits a
//    pass, ceil(log2 S / 8) passes (two at 30,000 slots), each pass a
//    counting sort written out by hand:
//    - msi_hist_kernel: per-tile digit histograms, digit-major, tiles of
//      4,096 requests;
//    - msi_scan_kernel: one exclusive scan over (digit, tile);
//    - msi_scatter_kernel: ranks inside each tile in batch order -- each
//      warp owns 16 groups of 32 requests, counts its digits
//      (__match_any_sync), the block turns counts into per-warp bases, and
//      each warp walks its groups in order giving each request its base
//      plus its rank among the group's equal digits.
//    The last pass writes, in slot order, each request's record (slot,
//    requester, is_write, batch index) as one int4.
// 3. msi_walk_kernel: one thread per sorted position; the head of each
//    slot's run walks it with the entry in registers, the table in shared
//    memory and the next records loaded ahead, writes each request's
//    (fetch_src, inval_mask) in slot order (sequential stores) and the
//    entry back once.
// 4. msi_unsort_kernel: the outputs back to each request's batch index.
// The walk takes as long as the hottest slot's chain, one table lookup in
// shared memory and a few dependent instructions a request; the sort is a
// few bandwidth-bound passes.  To shorten the chain, while a request's
// table row is loaded its successor's is_owner and in_sharers are worked
// out for every owner and sharers action the row may hold, and the row
// only picks among them; the outputs are stored in slot order and put back
// in batch order by a parallel pass.
//
// Measured with chip_smoke.py on the H100 (30,000 slots, 1.6M zipf(1.1)
// requests, the hottest chain ~228k long; PERF.md has the runs): the
// design before this one (one thread walking all requests in batch order,
// the directory in global memory, an L2 round trip a request) took
// ~396 ms.
//
// Plain C interface, bound with ctypes: the launcher returns the CUDA error
// code of its launches (0 on success) and never synchronises; the caller
// passes the scratch (ops._msi_workspace_bytes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 24;
constexpr int kCols = 5;

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kGroups = 16;  // groups of 32 requests a warp ranks in turn
constexpr int kTileReq = kSortWarps * kGroups * 32;  // 4,096
constexpr int kScanThreads = 1024;
constexpr int kWalkThreads = 256;
constexpr int kAhead = 8;  // records a walker loads ahead (one 128-byte line)

// Action codes of the table's columns (repro_torch/kernels/directory_msi.py).
constexpr int kFetchLocal = 0, kFetchMem = 1;
constexpr int kInvOthers = 1, kInvOwner = 2;
constexpr int kShSetMe = 1, kShOrMe = 2;
constexpr int kOwSetReq = 1, kOwClear = 2;

__device__ __forceinline__ int32_t shl1(int32_t k) {
  return (k >= 0 && k < 32) ? static_cast<int32_t>(1u << k) : 0;
}

// Bit k of x after an arithmetic shift right by k: x >> bit_of(k) & 1.
__device__ __forceinline__ int bit_of(int32_t k) { return (k >= 0 && k < 32) ? k : 31; }

__device__ __forceinline__ int32_t jnp_index(int32_t i, int32_t n) {
  int64_t j = i < 0 ? static_cast<int64_t>(i) + n : i;
  return static_cast<int32_t>(j < 0 ? 0 : (j >= n ? n - 1 : j));
}

__global__ void msi_keys_kernel(const int32_t* __restrict__ slots, int n_req,
                                int n_slots, int32_t* __restrict__ keys,
                                const int32_t* __restrict__ state_in,
                                const int32_t* __restrict__ sharers_in,
                                const int32_t* __restrict__ owner_in,
                                int32_t* __restrict__ state, int32_t* __restrict__ sharers,
                                int32_t* __restrict__ owner) {
  const int n = n_req > n_slots ? n_req : n_slots;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    if (i < n_req) keys[i] = jnp_index(slots[i], n_slots);
    if (i < n_slots) {
      state[i] = state_in[i];
      sharers[i] = sharers_in[i];
      owner[i] = owner_in[i];
    }
  }
}

// hist[d * ntiles + tile]: requests of the tile whose digit is d.
__global__ void __launch_bounds__(kSortThreads)
msi_hist_kernel(const int32_t* __restrict__ keys, int n_req, int shift,
                int32_t* __restrict__ hist, int ntiles) {
  __shared__ int32_t cnt[kRadix];
  for (int d = threadIdx.x; d < kRadix; d += blockDim.x) cnt[d] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTileReq;
  for (int k = threadIdx.x; k < kTileReq; k += blockDim.x) {
    const int i = base + k;
    if (i < n_req) atomicAdd(&cnt[(keys[i] >> shift) & (kRadix - 1)], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kRadix; d += blockDim.x)
    hist[static_cast<int64_t>(d) * ntiles + blockIdx.x] = cnt[d];
}

// In-place exclusive scan of a[0, n) by one block.
__global__ void __launch_bounds__(kScanThreads) msi_scan_kernel(int32_t* a, int n) {
  __shared__ int32_t warp_tot[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t carry = 0;
  for (int base = 0; base < n; base += kScanThreads * 4) {
    const int i0 = base + threadIdx.x * 4;
    int32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i0 + k < n ? a[i0 + k] : 0;
    const int32_t tsum = v[0] + v[1] + v[2] + v[3];
    int32_t x = tsum;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int32_t t = warp_tot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += y;
      }
      warp_tot[lane] = t;
    }
    __syncthreads();
    int32_t run = carry + (warp ? warp_tot[warp - 1] : 0) + x - tsum;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i0 + k < n) a[i0 + k] = run;
      run += v[k];
    }
    carry += warp_tot[kScanThreads / 32 - 1];
    __syncthreads();  // warp_tot is read before the next round writes it
  }
}

// One counting-sort pass: requests move to offs[(digit, tile)] plus their
// rank among the tile's equal digits in batch order.  idx == nullptr means
// the identity (the first pass).  The last pass writes int4 records.
template <bool kLast>
__global__ void __launch_bounds__(kSortThreads)
msi_scatter_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ idx,
                   int n_req, int shift, const int32_t* __restrict__ offs, int ntiles,
                   int32_t* __restrict__ keys_out, int32_t* __restrict__ idx_out,
                   const int32_t* __restrict__ requesters,
                   const int32_t* __restrict__ is_write, int4* __restrict__ rec) {
  __shared__ int32_t cnt[kSortWarps][kRadix];
  for (int k = threadIdx.x; k < kSortWarps * kRadix; k += blockDim.x)
    (&cnt[0][0])[k] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kTileReq + warp * kGroups * 32;
  int32_t key[kGroups], id[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int i = base + g * 32 + lane;
    key[g] = i < n_req ? keys[i] : 0;
    id[g] = i < n_req ? (idx ? idx[i] : i) : 0;
  }
  // Group g's digit, -1 past the end of the batch.
  auto digit = [&](int g) {
    return base + g * 32 + lane < n_req ? (key[g] >> shift) & (kRadix - 1) : -1;
  };
  // This warp's digit counts.
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int d = digit(g);
    const uint32_t peers = __match_any_sync(0xffffffffu, d);
    if (d >= 0 && lane == __ffs(peers) - 1) cnt[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Per-warp bases: the tile's offset of each digit, then the warps in order.
  for (int d = threadIdx.x; d < kRadix; d += blockDim.x) {
    int32_t run = offs[static_cast<int64_t>(d) * ntiles + blockIdx.x];
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const int32_t c = cnt[w][d];
      cnt[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
  // Ranks in batch order: the groups of each warp in turn.
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int d = digit(g);
    const uint32_t peers = __match_any_sync(0xffffffffu, d);
    const int32_t pos = d >= 0 ? cnt[warp][d] + __popc(peers & below) : 0;
    __syncwarp();  // every peer has read the base
    if (d >= 0 && lane == __ffs(peers) - 1) cnt[warp][d] += __popc(peers);
    __syncwarp();
    if (d >= 0) {
      if (kLast) {
        rec[pos] = make_int4(key[g], requesters[id[g]], is_write[id[g]], id[g]);
      } else {
        keys_out[pos] = key[g];
        idx_out[pos] = id[g];
      }
    }
  }
}

// The head of each slot's run walks it in batch order; out[j] gets sorted
// request j's (fetch_src, inval_mask).
__global__ void __launch_bounds__(kWalkThreads)
msi_walk_kernel(const int4* __restrict__ rec, int n_req,
                const int32_t* __restrict__ table,  // [24, 5]
                const int32_t* __restrict__ state_in,
                const int32_t* __restrict__ sharers_in,
                const int32_t* __restrict__ owner_in, int32_t* __restrict__ state,
                int32_t* __restrict__ sharers, int32_t* __restrict__ owner,
                int2* __restrict__ out) {
  // Row r: (new_state, fetch_kind, inval_kind, sharers_code), owner_code.
  __shared__ int4 tbl4[kRows];
  __shared__ int32_t tbl_ow[kRows];
  if (threadIdx.x < kRows) {
    const int32_t* r = table + threadIdx.x * kCols;
    tbl4[threadIdx.x] = make_int4(r[0], r[1], r[2], r[3]);
    tbl_ow[threadIdx.x] = r[4];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_req) return;
  const int32_t slot = rec[i].x;
  if (i > 0 && rec[i - 1].x == slot) return;  // not the head of a run

  int32_t st = state_in[slot], sh = sharers_in[slot], ow = owner_in[slot];
  int4 cur[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    cur[u] = i + u < n_req ? rec[i + u] : make_int4(-1, 0, 0, 0);
  // The row index ((st*2 + w)*2 + is_ow)*2 + in_sh wraps in uint32 as
  // 8*st + 4*w + 2*is_ow + in_sh does.  `low` = 2*is_ow + in_sh of the next
  // request: while a request's table row is loaded, its successor's is_ow
  // and in_sh are computed for each of the row's possible owner and
  // sharers actions, and the row only picks among them.
  uint32_t low = (ow == cur[0].y ? 2u : 0u) + ((static_cast<uint32_t>(sh) >> bit_of(cur[0].y)) & 1u);
  for (int j = i;; j += kAhead) {
    int4 nxt[kAhead];  // in flight while this batch is walked
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      nxt[u] = j + kAhead + u < n_req ? rec[j + kAhead + u] : make_int4(-1, 0, 0, 0);
    if (j + 4 * kAhead < n_req) {  // a long run: its records a few lines ahead
      asm volatile("prefetch.global.L1 [%0];" ::"l"(rec + j + 4 * kAhead));
    }
    int u = 0;
#pragma unroll
    for (; u < kAhead; ++u) {
      if (cur[u].x != slot) break;
      const int32_t req = cur[u].y;
      const int32_t me = shl1(req);
      // MAU stage 2: the materialized transition table, its row read as jnp
      // reads a ref (a negative index counts from the end once, then both
      // ends clamp).
      const uint32_t raw = static_cast<uint32_t>(st) * 8u + static_cast<uint32_t>(cur[u].z) * 4u + low;
      const int32_t r = static_cast<int32_t>(raw);
      const int row = raw < static_cast<uint32_t>(kRows) ? r : (r < 0 ? max(r + kRows, 0) : kRows - 1);
      const int4 act = tbl4[row];
      const int32_t ow_code = tbl_ow[row];
      // The successor's facts under each action (the run's last request
      // computes them for a record it does not walk).
      const int32_t req2 = u + 1 < kAhead ? cur[u + 1].y : nxt[0].y;
      const int kq2 = bit_of(req2);
      const uint32_t ow_is_req = req == req2, ow_is_none = req2 == -1, ow_kept = ow == req2;
      const uint32_t in_me = (static_cast<uint32_t>(me) >> kq2) & 1u;
      const uint32_t in_or = (static_cast<uint32_t>(sh | me) >> kq2) & 1u;
      const uint32_t in_kept = (static_cast<uint32_t>(sh) >> kq2) & 1u;
      // The request's outputs, in slot order (msi_unsort_kernel puts them
      // back in batch order), selected without branches.
      const int32_t others = sh & ~me, owner_bit = shl1(ow);
      out[j + u] = make_int2(act.y == kFetchLocal ? -1 : (act.y == kFetchMem ? -2 : ow),
                             (others & -static_cast<int32_t>(act.z == kInvOthers)) |
                                 (owner_bit & -static_cast<int32_t>(act.z == kInvOwner)));
      // Write-back (the recirculation), kept in registers until the run ends.
      st = act.x;
      sh = act.w == kShSetMe ? me : (act.w == kShOrMe ? (sh | me) : sh);
      ow = ow_code == kOwSetReq ? req : (ow_code == kOwClear ? -1 : ow);
      low = 2u * (ow_code == kOwSetReq ? ow_is_req : (ow_code == kOwClear ? ow_is_none : ow_kept)) +
            (act.w == kShSetMe ? in_me : (act.w == kShOrMe ? in_or : in_kept));
    }
    if (u < kAhead) break;  // the run ended inside this batch
#pragma unroll
    for (int v = 0; v < kAhead; ++v) cur[v] = nxt[v];
  }
  state[slot] = st;
  sharers[slot] = sh;
  owner[slot] = ow;
}

// fetch_src / inval_mask at each request's batch index.
__global__ void msi_unsort_kernel(const int4* __restrict__ rec, const int2* __restrict__ out,
                                  int n_req, int32_t* __restrict__ fetch_src,
                                  int32_t* __restrict__ inval_mask) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n_req; j += gridDim.x * blockDim.x) {
    const int at = rec[j].w;
    const int2 o = out[j];
    fetch_src[at] = o.x;
    inval_mask[at] = o.y;
  }
}

int sort_passes(int n_slots) {
  int bits = 0;
  for (uint32_t m = static_cast<uint32_t>(n_slots - 1); m; m >>= 1) ++bits;
  const int p = (bits + kRadixBits - 1) / kRadixBits;
  return p > 0 ? p : 1;
}

int64_t tiles_of(int n_req) { return (static_cast<int64_t>(n_req) + kTileReq - 1) / kTileReq; }

}  // namespace

// All tensors int32 and contiguous: directory [S] in and out, requests and
// per-request outputs [B], the table [24, 5].  ws: 16-byte aligned scratch
// of ws_bytes >= records int4 [B] + keys and indices twice int32 [B] +
// histograms int32 [256 * tiles] (ops._msi_workspace_bytes).
extern "C" int msi_transition_launch(const void* state_in, const void* sharers_in,
                                     const void* owner_in, const void* slots,
                                     const void* requesters, const void* is_write,
                                     const void* table, int n_slots, int n_req, void* state,
                                     void* sharers, void* owner, void* fetch_src,
                                     void* inval_mask, void* ws, long long ws_bytes,
                                     void* stream) {
  if (n_slots <= 0 || n_req < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t need = 32 * static_cast<int64_t>(n_req) + 4 * kRadix * tiles_of(n_req);
  if (ws_bytes < need || (reinterpret_cast<uintptr_t>(ws) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  using I = int32_t;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t b = n_req;
  const int ntiles = static_cast<int>(tiles_of(n_req));
  int4* rec = static_cast<int4*>(ws);
  I* keys[2] = {reinterpret_cast<I*>(rec + b), reinterpret_cast<I*>(rec + b) + b};
  I* idx[2] = {keys[1] + b, keys[1] + 2 * b};
  I* hist = keys[1] + 3 * b;

  const int64_t blocks = ((n_req > n_slots ? b : n_slots) + 255) / 256;
  const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);
  msi_keys_kernel<<<grid, 256, 0, st>>>(
      static_cast<const I*>(slots), n_req, n_slots, keys[0], static_cast<const I*>(state_in),
      static_cast<const I*>(sharers_in), static_cast<const I*>(owner_in), static_cast<I*>(state),
      static_cast<I*>(sharers), static_cast<I*>(owner));
  if (n_req == 0) return static_cast<int>(cudaGetLastError());

  const int passes = sort_passes(n_slots);
  for (int p = 0; p < passes; ++p) {
    const int shift = p * kRadixBits;
    const I* kin = keys[p & 1];
    const I* iin = p ? idx[p & 1] : nullptr;
    msi_hist_kernel<<<ntiles, kSortThreads, 0, st>>>(kin, n_req, shift, hist, ntiles);
    msi_scan_kernel<<<1, kScanThreads, 0, st>>>(hist, kRadix * ntiles);
    if (p + 1 < passes) {
      msi_scatter_kernel<false><<<ntiles, kSortThreads, 0, st>>>(
          kin, iin, n_req, shift, hist, ntiles, keys[(p + 1) & 1], idx[(p + 1) & 1], nullptr,
          nullptr, nullptr);
    } else {
      msi_scatter_kernel<true><<<ntiles, kSortThreads, 0, st>>>(
          kin, iin, n_req, shift, hist, ntiles, nullptr, nullptr,
          static_cast<const I*>(requesters), static_cast<const I*>(is_write), rec);
    }
  }
  // The sorted keys are no longer needed: their 8 bytes a request hold the
  // sorted outputs.
  int2* out = reinterpret_cast<int2*>(keys[0]);
  msi_walk_kernel<<<static_cast<int>((b + kWalkThreads - 1) / kWalkThreads), kWalkThreads, 0,
                    st>>>(rec, n_req, static_cast<const I*>(table),
                          static_cast<const I*>(state_in), static_cast<const I*>(sharers_in),
                          static_cast<const I*>(owner_in), static_cast<I*>(state),
                          static_cast<I*>(sharers), static_cast<I*>(owner), out);
  msi_unsort_kernel<<<grid, 256, 0, st>>>(rec, out, n_req, static_cast<I*>(fetch_src),
                                          static_cast<I*>(inval_mask));
  return static_cast<int>(cudaGetLastError());
}
