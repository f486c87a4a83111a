// Stages 1 and 2 of MIND's switch pipeline on Hopper: the TCAM protection
// check and the longest-prefix-match translation (MIND §4.2, §4.4).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/range_match.py::_translate_kernel  (translate_lookup)
//   src/repro/kernels/range_match.py::_protect_kernel    (protect_check)
//
// What bounds them.  At the engine's shapes (B 1.6 M requests against a
// table of a few rows) both stream their requests once and do a handful
// of integer operations per (request, row): they are bound by the bytes
// of the request streams, with the compares close behind (the 64 INT32
// lanes of an SM issue 6 of them per pair).  A table of thousands of rows
// makes them bound by those compares.
//
// Design.
// * A persistent grid (the wrapper sizes it from the card: SMs x resident
//   blocks, never more than there are tiles).  Each block walks tiles of
//   requests in a grid-stride loop; indices are 64-bit.  A translate block
//   is 512 threads with 4 contiguous requests a thread (tiles of 2,048); a
//   protect block is 1,024 threads with one request a thread (tiles of
//   1,024).  protect's scan stops at the first admitting row, so it is a
//   chain of dependent shared-memory reads: what hides their latency is
//   warps, and 1,024-thread blocks keep 2,048 threads an SM even when a
//   4,096-row table takes 96 KB of each block's shared memory (PERF.md
//   has the times).
// * The table is decoded into shared memory once per block ("staged"
//   route): per row the masked base and the prefix mask
//   ~0 << clamp(log2, 0, 63), and either the LPM key (translate: the
//   wrapping int32 log2 * 2^20 + row, stored with its sign bit flipped so
//   an unsigned min orders it, or as "never" when it is not below 2^30)
//   and the blade, or the pdid and ~perm (protect).  A (request, row) pair
//   is then one and-and-compare plus a min (translate) or an and
//   (protect).  Keys are unique, so the min key names the winning row
//   (its low 20 bits) and the lowest row wins ties, as argmin does; the
//   winner's blade comes from shared memory.
// * A table too large for shared memory ("tiled" route, chosen by the
//   wrapper) is decoded a tile of 1,024 rows at a time for each tile of
//   requests, as the first port did; the winner's blade is then read from
//   the table once, after the scan.
// * translate loads its 4 vaddrs with two 16-byte loads that bypass L1
//   (ld.global.nc.L1::no_allocate) and issues its next tile's before it
//   scans this one, so 4 are in flight before a compare; it stores blade
//   and row in 16-byte streaming stores (st.global.cs).  protect's three
//   loads a thread (4 + 8 + 4 bytes) and its byte store coalesce across
//   the warp; cache hints and a next-tile prefetch gained it nothing.
// * Edges.  translate's outputs are the wrapper's own allocations, 16-byte
//   aligned, so its units of 4 requests count from request 0.  A vaddr
//   stream whose start is not 16-byte aligned (a contiguous view may start
//   at any element) is read with scalar loads, as is the last unit when B
//   is not a multiple of 4.  protect reads and writes element by element
//   and takes any alignment.
//
// The TPU kernel carried 64-bit addresses as (hi, lo) int32 pairs because
// its vector unit is 32-bit (range_match.py:10-12).  Here vaddrs and table
// rows stay native int64, and prefix_mask() reproduces _prefix_eq for
// every int32 log2 (see the comment there).
//
// Plain C interface, bound with ctypes: each launcher returns the CUDA error
// code of its launch (0 on success) and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;                 // a translate block
constexpr int kProtectThreads = 1024;         // a protect block: 2 an SM with a 4,096-row table
constexpr int kVec = 4;                       // requests of one translate thread a tile
constexpr int kTableTile = 1024;              // rows the tiled route stages
constexpr int kRowBytes = 24;                 // one decoded row in shared memory
static_assert(kVec == 4, "a unit is two 16-byte loads of vaddrs and one 16-byte store an output");
constexpr int32_t kNoMatch = 0x7FFFFFFF;      // range_match.NO_MATCH
constexpr uint32_t kLpmStride = 1u << 20;     // > max table rows
constexpr uint32_t kRowBits = kLpmStride - 1;
constexpr int32_t kBig = 1 << 30;             // keys at or above never win
constexpr uint32_t kFlip = 0x80000000u;       // signed order -> unsigned order
constexpr uint32_t kNever = 0xFFFFFFFFu;      // the decoded key of no candidate
enum Route { kStaged = 0, kTiled = 1 };

// ~0 << log2 with the shift clamped to [0, 63]: bit for bit the compare
// _prefix_eq makes on the split halves (log2 < 0 compares all 64 bits, its
// low mask being -1 << 0; log2 >= 64 the sign bit only, its high shift
// clipping at 31).
__device__ __forceinline__ uint64_t prefix_mask(int32_t log2) {
  const int l = log2 < 0 ? 0 : (log2 > 63 ? 63 : log2);
  return ~0ull << l;
}

// ---- streaming loads and stores ---------------------------------------
__device__ __forceinline__ void ld_stream(const int64_t* p, int64_t& a, int64_t& b) {
  asm("ld.global.nc.L1::no_allocate.v2.s64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "l"(p));
}

// The kVec requests [i0, i0 + kVec) of one stream (0 past B): 16-byte loads
// when the stream is aligned and the unit is whole, else one at a time.
__device__ __forceinline__ void load_unit(const int64_t* __restrict__ p, int64_t i0,
                                          int64_t B, bool vec, int64_t (&x)[kVec]) {
  if (i0 + kVec <= B) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < kVec; j += 2) ld_stream(p + i0 + j, x[j], x[j + 1]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = __ldg(p + i0 + j);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = i0 + j < B ? __ldg(p + i0 + j) : 0;
  }
}

// Outputs are 16-byte aligned (the launchers check), so a whole unit is one
// 16-byte streaming store.
__device__ __forceinline__ void store_unit(int32_t* __restrict__ p, int64_t i0, int64_t B,
                                           const int32_t (&x)[kVec]) {
  if (i0 + kVec <= B) {
    __stcs(reinterpret_cast<int4*>(p + i0), make_int4(x[0], x[1], x[2], x[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (i0 + j < B) p[i0 + j] = x[j];
  }
}

// ---- decoded tables ------------------------------------------------------
// Shared memory of a block: kRowBytes a row, for the whole table (staged)
// or one tile of it (tiled).  Both kernels keep a 16-byte (masked base,
// mask) array first and two 4-byte fields a row after it.
struct TranslateRows {
  ulonglong2* bm;     // (base & mask, mask)
  uint32_t* key;      // LPM key, sign flipped; kNever if it cannot win
  int32_t* blade;
  __device__ TranslateRows(unsigned char* smem, int cap)
      : bm(reinterpret_cast<ulonglong2*>(smem)),
        key(reinterpret_cast<uint32_t*>(bm + cap)),
        blade(reinterpret_cast<int32_t*>(key + cap)) {}
  // Rows [t0, t0 + n) of the table into slots [0, n).
  __device__ void decode(const int64_t* __restrict__ table, int t0, int n) {
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int64_t* row = table + static_cast<int64_t>(t0 + r) * 4;
      const int32_t lg = static_cast<int32_t>(row[1]);  // astype(int32), as the TPU wrapper
      const uint64_t m = prefix_mask(lg);
      bm[r] = make_ulonglong2(static_cast<uint64_t>(row[0]) & m, m);
      // log2 * 2^20 + row in wrapping int32, as the TPU kernel computes it.
      const int32_t k = static_cast<int32_t>(static_cast<uint32_t>(lg) * kLpmStride +
                                             static_cast<uint32_t>(t0 + r));
      key[r] = k < kBig ? static_cast<uint32_t>(k) ^ kFlip : kNever;
      blade[r] = static_cast<int32_t>(row[2]);
    }
  }
};

struct ProtectRows {
  ulonglong2* bm;     // (base & mask, mask)
  int32_t* pdid;
  int32_t* nperm;     // ~perm
  __device__ ProtectRows(unsigned char* smem, int cap)
      : bm(reinterpret_cast<ulonglong2*>(smem)),
        pdid(reinterpret_cast<int32_t*>(bm + cap)),
        nperm(pdid + cap) {}
  __device__ void decode(const int64_t* __restrict__ table, int t0, int n) {
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int64_t* row = table + static_cast<int64_t>(t0 + r) * 4;
      const uint64_t m = prefix_mask(static_cast<int32_t>(row[2]));
      bm[r] = make_ulonglong2(static_cast<uint64_t>(row[1]) & m, m);
      pdid[r] = static_cast<int32_t>(row[0]);
      nperm[r] = ~static_cast<int32_t>(row[3]);
    }
  }
};

// The least key among the rows [0, n) that each request matches.
__device__ __forceinline__ void scan_translate(const TranslateRows& rows, int n,
                                               const int64_t (&v)[kVec],
                                               uint32_t (&best)[kVec]) {
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    const ulonglong2 e = rows.bm[r];
    const uint32_t k = rows.key[r];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if ((static_cast<uint64_t>(v[j]) & e.y) == e.x) best[j] = min(best[j], k);
  }
}

// Parallel-TCAM semantics: any row whose PDID and prefix match and whose
// permission covers `need` admits the access.  The scan stops at the first,
// and reads a row's prefix and permission only when its PDID matches: in a
// table shared by many protection domains most rows fail on the PDID alone.
__device__ __forceinline__ bool scan_protect(const ProtectRows& rows, int n, int64_t v,
                                             int32_t pd, int32_t nd, bool hit) {
  for (int r = 0; r < n && !hit; ++r) {
    if (rows.pdid[r] != pd) continue;
    const ulonglong2 e = rows.bm[r];
    hit = (static_cast<uint64_t>(v) & e.y) == e.x && (nd & rows.nperm[r]) == 0;
  }
  return hit;
}

// Both kernels walk tiles tile, tile + grid, ... of requests.  A translate
// thread takes kVec contiguous ones from i0 and issues its next tile's
// loads (from i0 + step) before this tile's scan, so they are in flight
// while it computes.
template <int kRoute>
__global__ void __launch_bounds__(kThreads)
translate_kernel(const int64_t* __restrict__ vaddrs, int64_t B,
                 const int64_t* __restrict__ table, int T, bool vec_v,
                 int32_t* __restrict__ blade_out, int32_t* __restrict__ row_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  TranslateRows rows(smem, kRoute == kStaged ? T : kTableTile);
  if (kRoute == kStaged) {
    rows.decode(table, 0, T);
    __syncthreads();
  }
  const int64_t tiles = ((B + kVec - 1) / kVec + kThreads - 1) / kThreads;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kVec;
  int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  int64_t v[kVec];
  if (blockIdx.x < tiles) load_unit(vaddrs, i0, B, vec_v, v);
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, i0 += step) {
    int64_t next[kVec];
    if (tile + gridDim.x < tiles) load_unit(vaddrs, i0 + step, B, vec_v, next);
    uint32_t best[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) best[j] = kNever;
    if (kRoute == kStaged) {
      scan_translate(rows, T, v, best);
    } else {
      for (int t0 = 0; t0 < T; t0 += kTableTile) {
        const int n = min(kTableTile, T - t0);
        __syncthreads();  // the last tile's scan is done
        rows.decode(table, t0, n);
        __syncthreads();
        scan_translate(rows, n, v, best);
      }
    }
    int32_t blade[kVec], row[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool hit = best[j] != kNever;
      const int32_t r = static_cast<int32_t>((best[j] ^ kFlip) & kRowBits);
      int32_t b = -1;
      if (hit) b = kRoute == kStaged ? rows.blade[r]
                                     : static_cast<int32_t>(table[static_cast<int64_t>(r) * 4 + 2]);
      blade[j] = b;
      row[j] = hit ? r : kNoMatch;
    }
    store_unit(blade_out, i0, B, blade);
    store_unit(row_out, i0, B, row);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = next[j];
  }
}

template <int kRoute>
__global__ void __launch_bounds__(kProtectThreads, 2)
protect_kernel(const int32_t* __restrict__ pdids, const int64_t* __restrict__ vaddrs,
               const int32_t* __restrict__ need, int64_t B,
               const int64_t* __restrict__ table, int T, bool* __restrict__ allow_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  ProtectRows rows(smem, kRoute == kStaged ? T : kTableTile);
  if (kRoute == kStaged) {
    rows.decode(table, 0, T);
    __syncthreads();
  }
  const int64_t tiles = (B + kProtectThreads - 1) / kProtectThreads;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t i = tile * kProtectThreads + threadIdx.x;
    const bool in = i < B;
    const int32_t pd = in ? pdids[i] : 0;
    const int64_t v = in ? vaddrs[i] : 0;
    const int32_t nd = in ? need[i] : 0;
    // A request past B counts as admitted, so it never holds its warp back.
    bool hit = !in;
    if (kRoute == kStaged) {
      hit = scan_protect(rows, T, v, pd, nd, hit);
    } else {
      for (int t0 = 0; t0 < T; t0 += kTableTile) {
        const int n = min(kTableTile, T - t0);
        __syncthreads();  // the last tile's scan is done
        rows.decode(table, t0, n);
        __syncthreads();
        hit = scan_protect(rows, n, v, pd, nd, hit);
      }
    }
    if (in) allow_out[i] = hit;
  }
}

size_t smem_bytes(int route, int T) {
  return static_cast<size_t>(kRowBytes) * (route == kStaged ? T : kTableTile);
}

template <typename Kernel>
cudaError_t set_smem(Kernel k, size_t bytes) {
  // Above 48 KB a block's dynamic shared memory must be asked for.
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();  // clear it, so that no later launch reports it
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The shapes ops.py sizes the launches of kernel 0 (translate) or 1
// (protect) with: requests of one block a tile, bytes of one decoded row in
// shared memory, rows of one tile of the tiled route.
extern "C" void rm_geometry(int kernel, int* out) {
  out[0] = kernel == 0 ? kThreads * kVec : kProtectThreads;
  out[1] = kRowBytes;
  out[2] = kTableTile;
}

// Resident blocks of one SM for kernel 0 (translate) or 1 (protect) on
// `route` with a table of T rows: the wrapper sizes the persistent grid
// from it.  Fails (cudaErrorInvalidValue) when the route's shared memory
// exceeds what a block may have.
extern "C" int rm_blocks_per_sm(int kernel, int route, int T, int* out) {
  const size_t bytes = smem_bytes(route, T);
  cudaError_t err;
  if (kernel == 0) {
    auto k = route == kStaged ? translate_kernel<kStaged> : translate_kernel<kTiled>;
    err = set_smem(k, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, kThreads, bytes);
  } else {
    auto k = route == kStaged ? protect_kernel<kStaged> : protect_kernel<kTiled>;
    err = set_smem(k, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, kProtectThreads, bytes);
  }
  if (err != cudaSuccess) cudaGetLastError();  // as in set_smem
  if (err == cudaSuccess && *out < 1) err = cudaErrorInvalidConfiguration;
  return static_cast<int>(err);
}

extern "C" int rm_translate(const void* vaddrs, int B, const void* table, int T,
                            void* blade_out, void* row_out, int route, int grid,
                            void* stream) {
  if (B <= 0) return 0;
  if (!aligned16(blade_out) || !aligned16(row_out)) return cudaErrorMisalignedAddress;
  const size_t bytes = smem_bytes(route, T);
  auto k = route == kStaged ? translate_kernel<kStaged> : translate_kernel<kTiled>;
  const cudaError_t err = set_smem(k, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(vaddrs), B, static_cast<const int64_t*>(table), T,
      aligned16(vaddrs), static_cast<int32_t*>(blade_out), static_cast<int32_t*>(row_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rm_protect(const void* pdids, const void* vaddrs, const void* need,
                          int B, const void* table, int T, void* allow_out, int route,
                          int grid, void* stream) {
  if (B <= 0) return 0;
  const size_t bytes = smem_bytes(route, T);
  auto k = route == kStaged ? protect_kernel<kStaged> : protect_kernel<kTiled>;
  const cudaError_t err = set_smem(k, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<grid, kProtectThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pdids), static_cast<const int64_t*>(vaddrs),
      static_cast<const int32_t*>(need), B, static_cast<const int64_t*>(table), T,
      static_cast<bool*>(allow_out));
  return static_cast<int>(cudaGetLastError());
}
