// Stage 3 of MIND's switch pipeline on Hopper: the MSI directory and
// blade-cache wave loop.
//
// Replaces src/repro/dataplane/engine.py::_lane_replay, which the JAX
// package runs as one XLA program, jax.jit(jax.vmap(_lane_replay)).  The
// plain PyTorch transcription beside it is
// src/repro_torch/kernels/lane_replay.py::lane_replay_plain; read the two
// together, statement by statement.
//
// Design.  One block per lane; each lane walks its waves in order.  Per
// wave every thread decodes the packet (the directory row and a handful of
// scalars, read by all threads from the same addresses), the block's threads
// cover the [2*NB, span] plane window for the masked popcounts and the
// multicast word-clears, a block reduction sums the page counts, and thread
// 0 does the requester insert, the directory-row update and the packed
// output words.  Each lane reads and writes its own copy of `dirrows` and
// `planes`: the host merges the lane copies by bit ownership afterwards.
//
// What bounds it: not bytes and not operations but the wave loop's serial
// dependency.  A wave is a few hundred integer operations and three block
// barriers, and a lane cannot start wave i+1 before wave i has written its
// row and window back, so the kernel runs at the latency of one wave times
// the number of waves, with one SM per lane.  Making it faster (a warp per
// lane, the window in registers, several lanes per block) is later work.
//
// int32 bit semantics.  Plane words use bit 31, so they are negative int32,
// and the packed words are w1 = flags | kind << 4 | inval << 7 and
// w2 = nfalse | dropped << 15.  Every shift and popcount is done on uint32
// (signed overflow on << is undefined in C++) with XLA's semantics for an
// out-of-range amount: shl gives 0, an arithmetic right shift fills with the
// sign bit.
//
// Index clamping.  lax.dynamic_slice / dynamic_update_slice wrap a negative
// start once and then clamp it into [0, dim - size]; a gather (x[b, rwi])
// wraps and clamps into [0, dim - 1]; a scatter (.at[b, rwi].set) wraps and
// drops an update that is still out of range.  The stream padding relies on
// in-range dummies (slot s_dev - 1, w0 padded to `words`, planes widened by
// `span` columns), and every index below goes through the same rule.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t shl32(uint32_t x, int32_t k) {
  return (k >= 0 && k < 32) ? (x << k) : 0u;
}

// Bit k of x after an arithmetic shift right by k (the sign bit when k is
// out of range, as XLA's shift_right_arithmetic gives).
__device__ __forceinline__ uint32_t bit_at(uint32_t x, int32_t k) {
  return (x >> ((k >= 0 && k < 32) ? k : 31)) & 1u;
}

__device__ __forceinline__ int gather_idx(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ int slice_start(int i, int dim, int size) {
  if (i < 0) i += dim;
  const int hi = dim - size;
  return i < 0 ? 0 : (i > hi ? hi : i);
}

// Returns the wrapped index, or -1 where a scatter would drop the update.
__device__ __forceinline__ int scatter_idx(int i, int n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// Sum of `v` over the block, valid in thread 0.  Ends with a barrier, so the
// writes made before it are visible to every thread after it.
__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>((blockDim.x + 31) >> 5); ++w) total += red[w];
  }
  return total;
}

__global__ void lane_replay_kernel(
    int L, int S, int span, int NB, int W, int nsteps, int dkc,
    const int32_t* __restrict__ slot, const int32_t* __restrict__ blade,
    const int32_t* __restrict__ write, const bool* __restrict__ valid,
    const int32_t* __restrict__ ptype, const int32_t* __restrict__ w0,
    const int32_t* __restrict__ rw, const int32_t* __restrict__ bit,
    int32_t* dirrows, const int32_t* __restrict__ cmask, int32_t* planes_i,
    int32_t* __restrict__ w1, int32_t* __restrict__ w2, int32_t* __restrict__ w3) {
  __shared__ int red_p[32];
  __shared__ int red_d[32];
  const int g = blockIdx.x;
  const int64_t so = static_cast<int64_t>(g) * L;
  slot += so; blade += so; write += so; valid += so; ptype += so;
  w0 += so; rw += so; bit += so; w1 += so; w2 += so; w3 += so;
  dirrows += static_cast<int64_t>(g) * S * 4;
  cmask += static_cast<int64_t>(g) * S * span;
  uint32_t* planes = reinterpret_cast<uint32_t*>(planes_i) +
                     static_cast<int64_t>(g) * 2 * NB * W;
  const int nwin = 2 * NB * span;

  for (int i = 0; i < nsteps; ++i) {
    // ---- every thread: packet decode (MAU stages 1 and 2) -------------
    const int32_t b = blade[i];
    const int32_t w = write[i];
    const bool v = valid[i];
    const bool ev = ptype[i] == 1;
    const bool cev = ptype[i] == 2;
    const int32_t rwi = rw[i];
    const int32_t biti = bit[i];
    const uint32_t me = shl32(1u, b);
    const int s = slice_start(slot[i], S, 1);
    const int c0 = slice_start(w0[i], W, span);  // window start column
    int32_t* drow = dirrows + static_cast<int64_t>(s) * 4;
    const int32_t cst = drow[0];
    const uint32_t csh = static_cast<uint32_t>(drow[1]);
    const int32_t cow = drow[2];
    const int32_t cpp = drow[3];
    const int32_t* mask = cmask + static_cast<int64_t>(s) * span;
    const int bg = gather_idx(b, NB);    // win_p[b, rwi] reads
    const int rg = gather_idx(rwi, span);
    // `has` is read before the multicast clear.
    const bool has = bit_at(planes[static_cast<int64_t>(bg) * W + c0 + rg], biti) == 1u;

    const bool wr = w == 1;
    const uint32_t others = csh & ~me;
    const bool is_i = cst == 0, is_s = cst == 1, is_m = cst == 2;
    const bool is_ow = cow == b;
    const bool in_sh = bit_at(csh, b) == 1u;
    const bool m_other = is_m && !is_ow;
    const bool hit = is_s ? (in_sh && has) : (is_m && is_ow && (has || cpp == 1));
    const uint32_t owner_bit = shl32(1u, cow > 0 ? cow : 0);
    uint32_t inval = (is_s && wr) ? others : (m_other ? owner_bit : 0u);
    const bool fetch = !hit;
    const bool seq = m_other;
    const bool par = is_s && wr && others != 0u;
    const int32_t new_st = (wr || (is_m && is_ow)) ? 2 : 1;
    const bool down = dkc && m_other && !wr && !ev && !cev;
    const uint32_t down_sh = me | owner_bit;
    const uint32_t new_sh = (is_m && is_ow) ? csh
                          : ((is_s && !wr) ? (csh | me) : (down ? down_sh : me));
    const int32_t new_ow = (is_m && is_ow) ? cow : (wr ? b : -1);
    const int32_t new_pp = (m_other || (is_s && wr)) ? 0 : cpp;
    const int32_t kind = is_i ? (wr ? 1 : 0)
                       : (is_s ? (wr ? 3 : 2) : ((m_other && !wr) ? 5 : 4));
    const uint32_t ev_targets = is_s ? csh : (cow >= 0 ? owner_bit : 0u);
    inval = ev ? ev_targets : (cev ? 0u : inval);

    // The requester's page bit at every selected blade, before the clear
    // (an eviction has no requesting page: every dropped page is false).
    int reqb = 0;
    if (threadIdx.x == 0 && !ev) {
      for (int k = 0; k < NB; ++k) {
        if (bit_at(inval, k))
          reqb += static_cast<int>(bit_at(planes[static_cast<int64_t>(k) * W + c0 + rg], biti));
      }
    }
    __syncthreads();  // all reads of the old row and window are done

    // ---- block: masked popcounts + multicast word-clear ----------------
    // A downgrade flushes the dirty bits but keeps the presence bits.
    int pc = 0, dc = 0;
    for (int e = threadIdx.x; e < nwin; e += blockDim.x) {
      const int r = e / span;
      const int c = e - r * span;
      const bool pres = r < NB;
      if (!bit_at(inval, pres ? r : r - NB)) continue;
      uint32_t* word = planes + static_cast<int64_t>(r) * W + c0 + c;
      const uint32_t m = static_cast<uint32_t>(mask[c]);
      const uint32_t x = *word;
      const int cnt = __popc(x & m);
      if (pres) {
        pc += cnt;
        if (v && !down) *word = x & ~m;
      } else {
        dc += cnt;
        if (v) *word = x & ~m;
      }
    }
    const int pc_sum = block_sum(pc, red_p);
    const int dc_sum = block_sum(dc, red_d);  // barrier: clears visible

    // ---- thread 0: requester insert, row update, output words ----------
    if (threadIdx.x == 0) {
      const int32_t dropped = down ? 0 : pc_sum;
      const int32_t flushed = dc_sum;
      const int32_t nfalse = down ? 0 : pc_sum - reqb;
      if (v) {
        if (!ev) {
          // The requester's bits are read after the clear.
          uint32_t* wp = planes + static_cast<int64_t>(bg) * W + c0 + rg;
          uint32_t* wd = planes + static_cast<int64_t>(NB + bg) * W + c0 + rg;
          const uint32_t cur_p = *wp, cur_d = *wd;
          const uint32_t one = shl32(1u, biti);
          const uint32_t new_dirty = (has ? bit_at(cur_d, biti) : 0u) |
                                     static_cast<uint32_t>(w);
          const uint32_t ins_p = cev ? (cur_p & ~one) : (cur_p | one);
          const uint32_t ins_d = cev ? (cur_d & ~one)
                                     : ((cur_d & ~one) | shl32(new_dirty, biti));
          const int bs = scatter_idx(b, NB);
          const int rs = scatter_idx(rwi, span);
          if (bs >= 0 && rs >= 0) {
            planes[static_cast<int64_t>(bs) * W + c0 + rs] = ins_p;
            planes[static_cast<int64_t>(NB + bs) * W + c0 + rs] = ins_d;
          }
        }
        if (ev) {  // directory eviction: the row returns to Invalid
          drow[0] = 0; drow[1] = 0; drow[2] = -1; drow[3] = 0;
        } else if (!cev) {  // a blade-cache eviction leaves the row as-is
          drow[0] = new_st;
          drow[1] = static_cast<int32_t>(new_sh);
          drow[2] = new_ow;
          drow[3] = new_pp;
        }
        const uint32_t word1 = static_cast<uint32_t>(hit) |
                               (static_cast<uint32_t>(fetch) << 1) |
                               (static_cast<uint32_t>(seq) << 2) |
                               (static_cast<uint32_t>(par) << 3) |
                               shl32(static_cast<uint32_t>(kind), 4) |
                               shl32(inval, 7);
        const uint32_t word2 = static_cast<uint32_t>(nfalse) |
                               shl32(static_cast<uint32_t>(dropped), 15);
        w1[i] = static_cast<int32_t>(word1);
        w2[i] = static_cast<int32_t>(word2);
        w3[i] = flushed;
      }
    }
    __syncthreads();  // the row and window are written before the next wave
  }
}

}  // namespace

extern "C" int lane_replay_launch(
    int G, int L, int S, int span, int NB, int W, int nsteps, int dkc,
    int threads, const void* slot, const void* blade, const void* write,
    const void* valid, const void* ptype, const void* w0, const void* rw,
    const void* bit, void* dirrows, const void* cmask, void* planes, void* w1,
    void* w2, void* w3, void* stream) {
  if (G <= 0 || nsteps <= 0) return 0;
  lane_replay_kernel<<<G, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      L, S, span, NB, W, nsteps, dkc,
      static_cast<const int32_t*>(slot), static_cast<const int32_t*>(blade),
      static_cast<const int32_t*>(write), static_cast<const bool*>(valid),
      static_cast<const int32_t*>(ptype), static_cast<const int32_t*>(w0),
      static_cast<const int32_t*>(rw), static_cast<const int32_t*>(bit),
      static_cast<int32_t*>(dirrows), static_cast<const int32_t*>(cmask),
      static_cast<int32_t*>(planes), static_cast<int32_t*>(w1),
      static_cast<int32_t*>(w2), static_cast<int32_t*>(w3));
  return static_cast<int>(cudaGetLastError());
}
