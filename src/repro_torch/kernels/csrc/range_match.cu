// Stages 1 and 2 of MIND's switch pipeline on Hopper: the TCAM protection
// check and the longest-prefix-match translation (MIND §4.2, §4.4).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/range_match.py::_translate_kernel  (translate_lookup)
//   src/repro/kernels/range_match.py::_protect_kernel    (protect_check)
//
// Design.  One thread per request; the match-action table is staged through
// shared memory one tile of rows at a time, and each thread keeps a running
// minimum LPM key (translate) or a running any-match (protect) across the
// tiles.  Both kernels move little data and do B*T cheap integer compares:
// at the engine's shapes (a real rack's table is a few hundred rows) they
// are bound by reading the request stream, so the table is read from shared
// memory, never again from device memory.
//
// The TPU kernel carried 64-bit addresses as (hi, lo) int32 pairs because
// its vector unit is 32-bit (range_match.py:10-12).  Here vaddrs and table
// rows stay native int64, and prefix_eq() reproduces _prefix_eq for every
// int32 log2 (see the comment there).
//
// Plain C interface, bound with ctypes: each launcher returns the CUDA error
// code of its launch (0 on success) and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;                 // table rows per shared-memory tile
constexpr int32_t kNoMatch = 0x7FFFFFFF;   // range_match.NO_MATCH
constexpr uint32_t kLpmStride = 1u << 20;  // > max table rows
constexpr int32_t kBig = 1 << 30;          // "no candidate" LPM key

// (v >> log2) == (base >> log2), bit for bit what _prefix_eq computes on the
// split halves: log2 < 0 compares all 64 bits (its low mask is -1 << 0) and
// log2 >= 64 compares the sign bit only (its high shift clips at 31), so the
// shift is clamped to [0, 63] and the compare done on uint64.
__device__ __forceinline__ bool prefix_eq(int64_t v, int64_t base, int32_t log2) {
  const int l = log2 < 0 ? 0 : (log2 > 63 ? 63 : log2);
  const uint64_t mask = ~0ull << l;
  return ((static_cast<uint64_t>(v) ^ static_cast<uint64_t>(base)) & mask) == 0;
}

__global__ void translate_kernel(const int64_t* __restrict__ vaddrs, int B,
                                 const int64_t* __restrict__ table, int T,
                                 int32_t* __restrict__ blade_out,
                                 int32_t* __restrict__ row_out) {
  __shared__ int64_t s_base[kTile];
  __shared__ int32_t s_log2[kTile];
  __shared__ int32_t s_blade[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t v = i < B ? vaddrs[i] : 0;
  int32_t best_key = kBig;
  int32_t best_row = 0;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int64_t* row = table + static_cast<int64_t>(t0 + r) * 4;
      s_base[r] = row[0];
      s_log2[r] = static_cast<int32_t>(row[1]);   // astype(int32), as the TPU wrapper
      s_blade[r] = static_cast<int32_t>(row[2]);
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const int32_t lg = s_log2[r];
      if (prefix_eq(v, s_base[r], lg)) {
        // LPM key log2 * 2^20 + row in wrapping int32, as the TPU kernel
        // computes it.  Strict '<' keeps the lowest row on a tie (argmin).
        const int32_t key = static_cast<int32_t>(
            static_cast<uint32_t>(lg) * kLpmStride + static_cast<uint32_t>(t0 + r));
        if (key < best_key) {
          best_key = key;
          best_row = t0 + r;
        }
      }
    }
    __syncthreads();
  }
  if (i < B) {
    const bool matched = best_key < kBig;
    // The winner's blade is read from device memory once, after the scan.
    blade_out[i] = matched ? static_cast<int32_t>(table[static_cast<int64_t>(best_row) * 4 + 2]) : -1;
    row_out[i] = matched ? best_row : kNoMatch;
  }
}

__global__ void protect_kernel(const int32_t* __restrict__ pdids,
                               const int64_t* __restrict__ vaddrs,
                               const int32_t* __restrict__ need, int B,
                               const int64_t* __restrict__ table, int T,
                               bool* __restrict__ allow_out) {
  __shared__ int32_t s_pdid[kTile];
  __shared__ int64_t s_base[kTile];
  __shared__ int32_t s_log2[kTile];
  __shared__ int32_t s_perm[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t v = i < B ? vaddrs[i] : 0;
  const int32_t pd = i < B ? pdids[i] : 0;
  const int32_t nd = i < B ? need[i] : 0;
  bool allow = false;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int64_t* row = table + static_cast<int64_t>(t0 + r) * 4;
      s_pdid[r] = static_cast<int32_t>(row[0]);
      s_base[r] = row[1];
      s_log2[r] = static_cast<int32_t>(row[2]);
      s_perm[r] = static_cast<int32_t>(row[3]);
    }
    __syncthreads();
    // Parallel-TCAM semantics: any valid row whose PDID and prefix match
    // and whose permission covers `need` admits the access.
    for (int r = 0; r < n && !allow; ++r) {
      allow = s_pdid[r] == pd && prefix_eq(v, s_base[r], s_log2[r]) &&
              (s_perm[r] & nd) == nd;
    }
    __syncthreads();
  }
  if (i < B) allow_out[i] = allow;
}

}  // namespace

extern "C" int rm_translate(const void* vaddrs, int B, const void* table, int T,
                            void* blade_out, void* row_out, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  translate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(vaddrs), B, static_cast<const int64_t*>(table), T,
      static_cast<int32_t*>(blade_out), static_cast<int32_t*>(row_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rm_protect(const void* pdids, const void* vaddrs, const void* need,
                          int B, const void* table, int T, void* allow_out,
                          void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  protect_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pdids), static_cast<const int64_t*>(vaddrs),
      static_cast<const int32_t*>(need), B, static_cast<const int64_t*>(table), T,
      static_cast<bool*>(allow_out));
  return static_cast<int>(cudaGetLastError());
}
