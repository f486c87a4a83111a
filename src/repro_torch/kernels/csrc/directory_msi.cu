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
// fetch_src and inval_mask, and writes the entry back.  The directory is
// copied into the outputs first, so the inputs are left as they are.
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
// 1.6M requests.  The real limit is the dependency chain: a request may
// read the entry the previous one wrote, so requests are applied one after
// the other, each a read of the directory from L2 and a write back.
//
// Design (simple and right first; a slot-parallel walk, each thread owning
// the requests of a disjoint set of slots, is later work).  One block: all
// threads copy the directory into the outputs and stage the table in
// shared memory; after a barrier one thread walks the requests in batch
// order.  The directory stays in global memory (L2-resident at MIND's
// 30,000 slots, 360 KB).
//
// Plain C interface, bound with ctypes: the launcher returns the CUDA error
// code of its launch (0 on success) and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRows = 24;
constexpr int kCols = 5;

// Action codes of the table's columns (repro_torch/kernels/directory_msi.py).
constexpr int kFetchLocal = 0, kFetchMem = 1;
constexpr int kInvOthers = 1, kInvOwner = 2;
constexpr int kShSetMe = 1, kShOrMe = 2;
constexpr int kOwSetReq = 1, kOwClear = 2;

__device__ __forceinline__ int32_t shl1(int32_t k) {
  return (k >= 0 && k < 32) ? static_cast<int32_t>(1u << k) : 0;
}

__device__ __forceinline__ int32_t sar(int32_t x, int32_t k) {
  return x >> ((k >= 0 && k < 32) ? k : 31);  // arithmetic on signed int
}

__device__ __forceinline__ int32_t jnp_index(int32_t i, int32_t n) {
  int64_t j = i < 0 ? static_cast<int64_t>(i) + n : i;
  return static_cast<int32_t>(j < 0 ? 0 : (j >= n ? n - 1 : j));
}

__global__ void __launch_bounds__(kThreads)
msi_kernel(const int32_t* __restrict__ state_in, const int32_t* __restrict__ sharers_in,
           const int32_t* __restrict__ owner_in, const int32_t* __restrict__ slots,
           const int32_t* __restrict__ requesters, const int32_t* __restrict__ is_write,
           const int32_t* __restrict__ table,  // [24, 5]
           int32_t* __restrict__ state, int32_t* __restrict__ sharers,
           int32_t* __restrict__ owner, int32_t* __restrict__ fetch_src,
           int32_t* __restrict__ inval_mask, int n_slots, int n_req) {
  __shared__ int32_t tbl[kRows * kCols];
  for (int i = threadIdx.x; i < kRows * kCols; i += blockDim.x) tbl[i] = table[i];
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    state[i] = state_in[i];
    sharers[i] = sharers_in[i];
    owner[i] = owner_in[i];
  }
  __syncthreads();  // the copies and the table are visible to thread 0
  if (threadIdx.x != 0) return;

  for (int i = 0; i < n_req; ++i) {
    const int32_t slot = jnp_index(slots[i], n_slots);
    const int32_t req = requesters[i];
    const int32_t w = is_write[i];
    const int32_t me = shl1(req);
    // MAU stage 1: directory lookup.
    const int32_t st = state[slot];
    const int32_t sh = sharers[slot];
    const int32_t ow = owner[slot];
    // MAU stage 2: the materialized transition table.
    const int32_t is_ow = ow == req ? 1 : 0;
    const int32_t in_sh = sar(sh, req) & 1;
    const uint32_t raw = ((static_cast<uint32_t>(st) * 2u + static_cast<uint32_t>(w)) * 2u +
                          static_cast<uint32_t>(is_ow)) * 2u + static_cast<uint32_t>(in_sh);
    const int32_t* row = tbl + jnp_index(static_cast<int32_t>(raw), kRows) * kCols;
    const int32_t fetch_kind = row[1], inval_kind = row[2], sh_code = row[3],
                  ow_code = row[4];
    fetch_src[i] = fetch_kind == kFetchLocal ? -1 : (fetch_kind == kFetchMem ? -2 : ow);
    inval_mask[i] = inval_kind == kInvOthers ? (sh & ~me)
                                             : (inval_kind == kInvOwner ? shl1(ow) : 0);
    // Write-back (the recirculation).
    state[slot] = row[0];
    sharers[slot] = sh_code == kShSetMe ? me : (sh_code == kShOrMe ? (sh | me) : sh);
    owner[slot] = ow_code == kOwSetReq ? req : (ow_code == kOwClear ? -1 : ow);
  }
}

}  // namespace

// All tensors int32 and contiguous: directory [S] in and out, requests and
// per-request outputs [B], the table [24, 5].
extern "C" int msi_transition_launch(const void* state_in, const void* sharers_in,
                                     const void* owner_in, const void* slots,
                                     const void* requesters, const void* is_write,
                                     const void* table, int n_slots, int n_req, void* state,
                                     void* sharers, void* owner, void* fetch_src,
                                     void* inval_mask, void* stream) {
  if (n_slots <= 0 || n_req < 0) return static_cast<int>(cudaErrorInvalidValue);
  using I = int32_t;
  msi_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const I*>(state_in), static_cast<const I*>(sharers_in),
      static_cast<const I*>(owner_in), static_cast<const I*>(slots),
      static_cast<const I*>(requesters), static_cast<const I*>(is_write),
      static_cast<const I*>(table), static_cast<I*>(state), static_cast<I*>(sharers),
      static_cast<I*>(owner), static_cast<I*>(fetch_src), static_cast<I*>(inval_mask), n_slots,
      n_req);
  return static_cast<int>(cudaGetLastError());
}
