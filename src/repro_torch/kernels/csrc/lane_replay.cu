// Stage 3 of MIND's switch pipeline on Hopper: the MSI directory and
// blade-cache wave loop.
//
// Replaces src/repro/dataplane/engine.py::_lane_replay, which the JAX
// package runs as one XLA program, jax.jit(jax.vmap(_lane_replay)).  The
// plain PyTorch transcription beside it is
// src/repro_torch/kernels/lane_replay.py::lane_replay_plain; read the two
// together, statement by statement.
//
// What bounds it: not bytes and not operations but one lane's dependency
// chain.  Wave step i+1 of a lane may read the directory row and the plane
// words that step i wrote, so a lane's steps run one after the other, and
// the kernel takes (wave steps) x (time of one step).  On the H100 a step
// is the instruction stream of one warp: shared-memory loads, the decode,
// the window pass and the stores, each instruction mostly waiting on the
// one before, so the warp issues well under one instruction a cycle.  The
// lanes of a launch are independent: one block each.
//
// Design.  One warp walks a lane, its state on chip.
// * Route "smem": the block's 256 threads copy the lane's dirrows [S,4],
//   cmask [S,span] and planes [2NB,W] into dynamic shared memory once, warp
//   0 walks every wave step there, and the block writes dirrows and planes
//   back once.  Route "global": when the state does not fit in the card's
//   opt-in shared memory (ops.lane_smem_bytes > the limit, ops._lane_route)
//   the same template walks the state in the output copies, in global
//   memory.  Everything else is shared by the two routes.
// * The eight input streams do not depend on the state: the walking warp
//   loads the next tile of 32 wave steps (one step a lane, coalesced) while
//   it walks the current one, and each lane decodes its step's indices,
//   flags and shifted bits into a shared ring (three int4 a step), so a
//   step's chain starts at its state reads.  The output words of a tile are
//   collected in shared memory and stored coalesced at its end; the idle
//   warps zero the words past the last step.
// * MAU stage 2 is a table: the step's state facts (the entry's state
//   class, write, owner == blade, blade in sharers, has, prepop, packet
//   type, other sharers, owner >= 0) form an 11-bit key, and one shared
//   load gives every decision of the reference's formulas (transition_code,
//   built per launch with the downgrade flag).
// * Steps whose rows differ and whose windows share no column are
//   independent: a tile marks groups of up to three consecutive such steps,
//   which read all their state, decode, clear and write together, so the
//   warp interleaves their chains.
// * The [2NB, span] window's masked popcounts and word-clears are spread
//   over the 32 lanes (presence rows on 16, dirty rows on the other 16), one
//   selected blade a round, and summed with __reduce_add_sync; __syncwarp
//   alone orders the steps.  When inval == 0 (every hit, every miss on an
//   Invalid entry, every blade-cache eviction) the pass is skipped.  The
//   requester's words after the clear are computed from its mask word, not
//   re-read.  An invalid (padding) step touches no state and writes zeros.
//
// Measured with chip_smoke.py on the H100 (its main cell: 884,106 wave
// steps in 725 launches; PERF.md has the runs): the design before this
// one (a block of up to 256 threads per lane, the state in global memory,
// four block barriers and two serial loops in thread 0 a step) took
// ~1.78 us a step, one warp with the state in shared memory 647 ns, this
// design ~0.32 us.  Tried and dropped on the way: groups of two or of four
// steps (slower than three), the window pass as an out-of-line call
// (slower), the outputs summed with warp reductions in each step (slower
// than the partial sums at the end of the tile).
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
//
// Order inside a step, as in the reference: `has` and the requester's page
// bits for the false-invalidation count are read before the multicast
// clear, the requester's words are taken after it.
//
// Plain C interface, bound with ctypes: the launcher returns the CUDA error
// code of its launch (0 on success) and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // staging and write-back; warp 0 walks
constexpr int kTile = 32;      // wave steps of one ring tile, one per lane
constexpr int kStreams = 8;    // slot blade write valid ptype w0 rw bit
constexpr int kOuts = 2;       // w1 and the downgrade flag of each step

enum { kSlot, kBlade, kWrite, kValid, kPtype, kW0, kRw, kBit };
// A decoded wave step, as the ring holds it: every index, flag and shifted
// bit that does not depend on the state, computed by the lane that loaded
// the step, 12 words (three int4) a step, so that a step's dependent chain
// starts at its state reads.
enum {
  // int4 0: what the state reads need
  kFlags,    // kFValid | kFEv | kFCev | kFPut | kFWr | kFBitIn, and the
             // bit_shift of the blade (<< 8), the page bit (<< 16) and the
             // gathered blade (<< 24)
  kRowOff,   // the directory row: 4 * slice_start(slot)
  kWordOff,  // the requester's presence word: bg * W + c0 + rg
  kDWordOff, // the requester's dirty word: kWordOff + NB * W
  // int4 1
  kB,        // blade
  kMe,       // shl32(1, blade)
  kW,        // write
  kOne,      // shl32(1, page bit)
  // int4 2
  kBitIdx,   // page bit
  kMrgOff,   // the clear-mask word over the requester: kMaskOff + rg
  kMaskOff,  // the row's clear-mask: span * slice_start(slot)
  kC0,       // the window's first column
  kFields
};
enum { kFValid = 1, kFEv = 2, kFCev = 4, kFPut = 8, kFWr = 16, kFBitIn = 32 };
// Steps walked as one group: consecutive valid steps of one tile whose
// directory rows differ and whose windows share no column read all their
// state before any of them writes, so their dependent chains interleave.
// kFlags bits 6-7 hold the size - 1 of the group that starts at a step.
// Groups of up to 3 measured fastest (groups of 2 and 4 were slower).
constexpr int kGroup = 3;
constexpr int kQuads = kFields / 4;
constexpr int kRingInts = (kFields + kOuts) * kTile;
// MAU stage 2 as a table, built per launch: one code word for every key of
// a step's state facts (see transition_code).
constexpr int kKeyBits = 11;
constexpr int kTableInts = 1 << kKeyBits;
// Each lane's share of a tile's window popcounts (presence, dirty, the
// requester's bits), summed at the end of the tile: [3][32 lanes][33], the
// row padded so that a step's stores and the sums' loads hit 32 banks.
constexpr int kPartRow = kTile + 1;
constexpr int kPartInts = 3 * 32 * kPartRow;
// ops._LANE_FIXED_INTS mirrors this: the ring, the table and the partial
// sums sit before the state in shared memory.
constexpr int kFixedInts = kRingInts + kTableInts + kPartInts;

__device__ __forceinline__ uint32_t shl32(uint32_t x, int32_t k) {
  return (k >= 0 && k < 32) ? (x << k) : 0u;
}

// The shift that reads bit k of x as (x >> k) & 1 with XLA's arithmetic
// shift: an amount outside [0, 32) yields the sign bit.
__device__ __forceinline__ int bit_shift(int32_t k) { return (k >= 0 && k < 32) ? k : 31; }

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

// Block-wide copy of n words, 16 bytes a thread where both ends allow it.
__device__ __forceinline__ void copy_words(int32_t* dst, const int32_t* src, int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15u) == 0) {
    const int n4 = n >> 2;
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int4* s4 = reinterpret_cast<const int4*>(src);
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

struct Streams {
  const int32_t* slot;
  const int32_t* blade;
  const int32_t* write;
  const bool* valid;
  const int32_t* ptype;
  const int32_t* w0;
  const int32_t* rw;
  const int32_t* bit;
};

// Step i's eight stream words, or an invalid step past the end.
__device__ __forceinline__ void load_step(const Streams& in, int i, int nsteps,
                                          int32_t (&x)[kStreams]) {
  if (i < nsteps) {
    x[kSlot] = __ldg(in.slot + i);
    x[kBlade] = __ldg(in.blade + i);
    x[kWrite] = __ldg(in.write + i);
    x[kValid] = in.valid[i] ? 1 : 0;
    x[kPtype] = __ldg(in.ptype + i);
    x[kW0] = __ldg(in.w0 + i);
    x[kRw] = __ldg(in.rw + i);
    x[kBit] = __ldg(in.bit + i);
  } else {
#pragma unroll
    for (int k = 0; k < kStreams; ++k) x[k] = 0;
  }
}

// The code word of one transition key.  Key bits: the directory state's
// class (0 I, 1 S, 2 M, 3 any other value), write, owner == blade, blade
// in sharers, has, prepop == 1 (<< 6), the packet type (<< 7: 0 access,
// 1 directory eviction, 2 blade-cache eviction), other sharers (<< 9),
// owner >= 0 (<< 10).  Code bits: hit, fetch, seq, par, kind (<< 4; the
// low 7 bits of w1), the new state (<< 8), the sharers' source (<< 10:
// sharers, sharers | me, me | owner bit, me), the owner's (<< 12: owner,
// blade, -1), the prepop's (<< 14: 0, prepop), the invalidation mask's
// (<< 16: 0, sharers, other sharers, owner bit), down (<< 18), the row
// action (<< 20: new row, freed, kept) and the requester's plane action
// (<< 22: none, insert, clear).  The formulas are the reference's.
__device__ uint32_t transition_code(int key, int dkc) {
  const int cls = key & 3;
  const bool wr = (key >> 2) & 1, is_ow = (key >> 3) & 1, in_sh = (key >> 4) & 1;
  const bool has = (key >> 5) & 1, pp1 = (key >> 6) & 1;
  const int ptype = (key >> 7) & 3;
  const bool others_nz = (key >> 9) & 1, cow_ge0 = (key >> 10) & 1;
  const bool ev = ptype == 1, cev = ptype == 2;
  const bool is_i = cls == 0, is_s = cls == 1, is_m = cls == 2;
  const bool m_own = is_m && is_ow, m_other = is_m && !is_ow;
  const bool hit = is_s ? (in_sh && has) : (m_own && (has || pp1));
  const bool par = is_s && wr && others_nz;
  const uint32_t kind = is_i ? (wr ? 1 : 0) : (is_s ? (wr ? 3 : 2) : ((m_other && !wr) ? 5 : 4));
  const bool down = dkc && m_other && !wr && !ev && !cev;
  const uint32_t inval = ev ? (is_s ? 1 : (cow_ge0 ? 3 : 0))
                            : (cev ? 0 : ((is_s && wr) ? 2 : (m_other ? 3 : 0)));
  const uint32_t sh = m_own ? 0 : ((is_s && !wr) ? 1 : (down ? 2 : 3));
  const uint32_t ow = m_own ? 0 : (wr ? 1 : 2);
  const uint32_t pp = (m_other || (is_s && wr)) ? 0 : 1;
  const uint32_t st = (wr || m_own) ? 2 : 1;
  const uint32_t row = ev ? 1 : (cev ? 2 : 0);
  const uint32_t plane = ev ? 0 : (cev ? 2 : 1);
  return static_cast<uint32_t>(hit) | (static_cast<uint32_t>(!hit) << 1) |
         (static_cast<uint32_t>(m_other) << 2) | (static_cast<uint32_t>(par) << 3) |
         (kind << 4) | (st << 8) | (sh << 10) | (ow << 12) | (pp << 14) | (inval << 16) |
         (static_cast<uint32_t>(down) << 18) | (row << 20) | (plane << 22);
}

// Step x's state-independent part (the packet decode's indices).
__device__ __forceinline__ void decode_step(const int32_t (&x)[kStreams], int S, int span,
                                            int NB, int W, int32_t (&d)[kFields]) {
  const int s = slice_start(x[kSlot], S, 1);
  const int c0 = slice_start(x[kW0], W, span);
  const int bg = gather_idx(x[kBlade], NB);  // win_p[b, rwi] reads
  const int rg = gather_idx(x[kRw], span);
  const bool put = scatter_idx(x[kBlade], NB) >= 0 && scatter_idx(x[kRw], span) >= 0;
  const int32_t b = x[kBlade], bit = x[kBit];
  d[kFlags] = (x[kValid] ? kFValid : 0) | (x[kPtype] == 1 ? kFEv : 0) |
              (x[kPtype] == 2 ? kFCev : 0) | (put ? kFPut : 0) |
              (x[kWrite] == 1 ? kFWr : 0) | (bit_shift(bit) == bit ? kFBitIn : 0) |
              (bit_shift(b) << 8) | (bit_shift(bit) << 16) | (bit_shift(bg) << 24);
  d[kRowOff] = 4 * s;
  d[kWordOff] = bg * W + c0 + rg;
  d[kDWordOff] = (NB + bg) * W + c0 + rg;
  d[kB] = b;
  d[kMe] = static_cast<int32_t>(shl32(1u, b));
  d[kW] = x[kWrite];
  d[kOne] = static_cast<int32_t>(shl32(1u, bit));
  d[kBitIdx] = bit;
  d[kMrgOff] = span * s + rg;
  d[kMaskOff] = span * s;
  d[kC0] = c0;
}

// One step's masked popcounts and multicast word-clear over its
// [2NB, span] window at column c0: this lane's share of the presence bits,
// dirty bits and requester page bits under the mask of the selected rows.
// Row r of either half is selected by bit r of inval (bit 31 for r >= 32,
// the sign bit).  Lanes 0-15 take presence columns, 16-31 the same columns
// of the dirty row, 16 columns a round.
__device__ __forceinline__ int3 window_pass(const int lane, const uint32_t inval,
                                            const int flags, const bool down,
                                            const int32_t* mask, const int c0, const int rg,
                                            uint32_t* pl, const int span, const int NB,
                                            const int W, const uint32_t low_blades,
                                            const uint32_t high_rows) {
  const bool dirty_half = lane >= 16;
  const int col = lane & 15;
  const int bb = (flags >> 16) & 31;
  const bool clear = dirty_half || !down;             // a downgrade keeps presence
  const bool req_bit = !dirty_half && !(flags & kFEv);  // an eviction requests no page
  int pc = 0, dc = 0, reqb = 0;
#pragma unroll 1
  for (int c_base = 0; c_base < span; c_base += 16) {
    const int c = c_base + col;
    const bool on = c < span;
    const uint32_t m = on ? static_cast<uint32_t>(mask[c]) : 0u;
    // One selected blade's presence and dirty row a round: the blades of
    // inval's set bits, then (a rack of more than 32 blades) rows 32 and up
    // when bit 31 is set.
    auto blade_round = [&](int blade) {
      const int at = (dirty_half ? NB + blade : blade) * W + c0 + c;
      const uint32_t xw = on ? pl[at] : 0u;
      const int cnt = __popc(xw & m);
      pc += dirty_half ? 0 : cnt;
      dc += dirty_half ? cnt : 0;
      // The requester's page bit at this selected blade, before the clear.
      reqb += (req_bit && c == rg) ? static_cast<int>((xw >> bb) & 1u) : 0;
      if (on && clear) pl[at] = xw & ~m;
    };
#pragma unroll 1
    for (uint32_t sel = inval & low_blades; sel != 0u; sel &= sel - 1u) blade_round(__ffs(sel) - 1);
    if (high_rows != 0u && (inval >> 31)) {
#pragma unroll 1
      for (int blade = 32; blade < NB; ++blade) blade_round(blade);
    }
  }
  return make_int3(pc, dc, reqb);
}

// Walk N mutually independent steps j..j+N-1 of the tile (N > 1: all
// valid): every state read, then every decode, window pass and write.
template <int N>
__device__ __forceinline__ void walk_group(
    const int lane, const int j, const int4* rs, const uint32_t* table, int32_t* dir,
    const int32_t* cm, uint32_t* pl, int32_t* ro, int32_t* part, uint32_t& windows,
    int span, int NB, int W, uint32_t low_blades, uint32_t high_rows) {
  int4 f0[N], f1[N], f2[N], row[N];
  uint32_t cur_p[N], cur_d[N], m_rg[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    f0[k] = rs[(j + k) * kQuads];
    f1[k] = rs[(j + k) * kQuads + 1];
    f2[k] = rs[(j + k) * kQuads + 2];
  }
  if (N == 1 && !(f0[0].x & kFValid)) {  // padding: no state, zero words
    ro[j] = 0;
    ro[kTile + j] = 0;
    return;
  }
  // ---- every lane: the state reads ----------------------------------------
#pragma unroll
  for (int k = 0; k < N; ++k) {
    row[k] = *reinterpret_cast<const int4*>(dir + f0[k].y);
    cur_p[k] = pl[f0[k].z];
    cur_d[k] = pl[f0[k].w];
    m_rg[k] = static_cast<uint32_t>(cm[f2[k].y]);
  }
  __syncwarp();  // every lane has read the rows and the requesters' words

  // ---- every lane: packet decode (MAU stages 1 and 2) --------------------
  uint32_t code[N], inval[N], owner_bit[N], has[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int flags = f0[k].x;
    const int bsh = (flags >> 8) & 31, bb = (flags >> 16) & 31;
    const int32_t b = f1[k].x;
    const uint32_t me = static_cast<uint32_t>(f1[k].y);
    const int32_t cst = row[k].x;
    const uint32_t csh = static_cast<uint32_t>(row[k].y);
    const int32_t cow = row[k].z;
    // `has` is read before the multicast clear.
    has[k] = (cur_p[k] >> bb) & 1u;
    // MAU stage 2: the step's facts index the transition table.
    const uint32_t others = csh & ~me;
    const int key = (((flags >> 4) & 1) << 2) | (((flags >> 1) & 3) << 7) |
                    (static_cast<uint32_t>(cst) < 3u ? cst : 3) | ((cow == b) << 3) |
                    (((csh >> bsh) & 1u) << 4) | (has[k] << 5) | ((row[k].w == 1) << 6) |
                    ((others != 0u) << 9) | ((cow >= 0) << 10);
    code[k] = table[key];
    owner_bit[k] = cow < 32 ? 1u << (cow > 0 ? cow : 0) : 0u;
    const uint32_t src = (code[k] >> 16) & 3u;
    inval[k] = src == 0u ? 0u : (src == 1u ? csh : (src == 2u ? others : owner_bit[k]));
  }

  // ---- warp: masked popcounts + multicast word-clear ---------------------
  // No selected blade (inval == 0): nothing to count or clear.
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (inval[k] == 0u) continue;
    const bool down = (code[k] >> 18) & 1u;
    const int3 share = window_pass(lane, inval[k], f0[k].x, down, cm + f2[k].z, f2[k].w,
                                   f2[k].y - f2[k].z, pl, span, NB, W, low_blades, high_rows);
    // Summed over the lanes at the end of the tile, off the chain.
    part[lane * kPartRow + j + k] = share.x;
    part[(32 + lane) * kPartRow + j + k] = share.y;
    part[(64 + lane) * kPartRow + j + k] = share.z;
    windows |= 1u << (j + k);
    // The requester's words after the clear, as the window pass left them.
    if ((inval[k] >> (f0[k].x >> 24)) & 1u) {
      if (!down) cur_p[k] &= ~m_rg[k];
      cur_d[k] &= ~m_rg[k];
    }
  }
  __syncwarp();  // the window stores come before the inserts

  // ---- requester inserts, row updates, output words ----------------------
  // Every lane holds the same values and stores them: a store of one value
  // to one address, without a branch.
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int flags = f0[k].x;
    const uint32_t cd = code[k];
    const int bb = (flags >> 16) & 31;
    const uint32_t one = static_cast<uint32_t>(f1[k].w);
    const uint32_t me = static_cast<uint32_t>(f1[k].y);
    const uint32_t csh = static_cast<uint32_t>(row[k].y);
    const uint32_t plane = (cd >> 22) & 3u;  // 1 insert, 2 clear
    const uint32_t new_dirty =
        (has[k] ? (cur_d[k] >> bb) & 1u : 0u) | static_cast<uint32_t>(f1[k].z);
    const uint32_t ins_p = plane == 2u ? (cur_p[k] & ~one) : (cur_p[k] | one);
    const uint32_t ins_d =
        (cur_d[k] & ~one) | (plane == 1u && (flags & kFBitIn) ? new_dirty << f2[k].x : 0u);
    const uint32_t sh_src = (cd >> 10) & 3u, ow_src = (cd >> 12) & 3u;
    const uint32_t row_act = (cd >> 20) & 3u;  // 1 freed, 2 kept
    const uint32_t new_sh =
        sh_src == 0u ? csh : (sh_src == 1u ? (csh | me) : (sh_src == 2u ? (me | owner_bit[k]) : me));
    const int4 new_row =
        row_act == 1u ? make_int4(0, 0, -1, 0)
                      : make_int4(static_cast<int32_t>((cd >> 8) & 3u), static_cast<int32_t>(new_sh),
                                  ow_src == 0u ? row[k].z : (ow_src == 1u ? f1[k].x : -1),
                                  ((cd >> 14) & 1u) ? row[k].w : 0);
    // A scatter in range writes where the gather read.
    if (plane != 0u && (flags & kFPut)) {
      pl[f0[k].z] = ins_p;
      pl[f0[k].w] = ins_d;
    }
    if (row_act != 2u) *reinterpret_cast<int4*>(dir + f0[k].y) = new_row;
    // w1 now; w2 and w3 at the end of the tile, from the partial sums.
    ro[j + k] = static_cast<int32_t>((cd & 0x7fu) | (inval[k] << 7));
    ro[kTile + j + k] = static_cast<int32_t>((cd >> 18) & 1u);  // down
  }
  __syncwarp();  // the rows and windows are written before the next group
}

// Warp 0 walks the lane's wave steps over the state at dir / cm / pl
// (shared or global memory, by route).
__device__ __forceinline__ void walk(
    const int lane, const Streams& in, int S, int span, int NB, int W,
    int nsteps, int32_t* ring, const uint32_t* table, int32_t* part, int32_t* dir,
    const int32_t* cm, uint32_t* pl, int32_t* w1, int32_t* w2, int32_t* w3) {
  int4* rs = reinterpret_cast<int4*>(ring);  // [kTile][kQuads]
  int32_t* ro = ring + kFields * kTile;      // [kOuts][kTile]
  const uint32_t low_blades = NB >= 32 ? 0xffffffffu : (1u << NB) - 1u;
  const uint32_t high_rows = NB > 32 ? NB - 32 : 0;

  int32_t x[kStreams];
  load_step(in, lane, nsteps, x);
  for (int t0 = 0; t0 < nsteps; t0 += kTile) {
    const int n = nsteps - t0 < kTile ? nsteps - t0 : kTile;
    {
      int32_t d[kFields];
      decode_step(x, S, span, NB, W, d);
      // The group starting at this step: the next steps of the tile while
      // they are valid and independent of every step before them in it.
      int row_off[kGroup], c0[kGroup], ok[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        row_off[q] = __shfl_down_sync(0xffffffffu, d[kRowOff], q);
        c0[q] = __shfl_down_sync(0xffffffffu, d[kC0], q);
        ok[q] = __shfl_down_sync(0xffffffffu, d[kFlags] & kFValid, q) && lane + q < n;
      }
      int size = 1;
      bool grow = ok[0];
#pragma unroll
      for (int q = 1; q < kGroup; ++q) {
        bool indep = grow && ok[q];
#pragma unroll
        for (int r = 0; r < q; ++r) {
          const int gap = c0[q] - c0[r];
          indep = indep && row_off[q] != row_off[r] && (gap >= span || -gap >= span);
        }
        grow = indep;
        size += grow ? 1 : 0;
      }
      d[kFlags] |= (size - 1) << 6;
      __syncwarp();  // the last tile's ring reads are done
#pragma unroll
      for (int k = 0; k < kQuads; ++k)
        rs[lane * kQuads + k] = make_int4(d[4 * k], d[4 * k + 1], d[4 * k + 2], d[4 * k + 3]);
      __syncwarp();
    }
    // The next tile's loads are in flight while this tile is walked.
    load_step(in, t0 + kTile + lane, nsteps, x);

    uint32_t windows = 0u;  // the tile's steps that ran a window pass
    for (int j = 0; j < n;) {
      const int size = ((rs[j * kQuads].x >> 6) & 3) + 1;
      static_assert(kGroup == 3, "one walk_group instantiation per group size");
      if (size == 3) {
        walk_group<3>(lane, j, rs, table, dir, cm, pl, ro, part, windows, span, NB, W,
                         low_blades, high_rows);
      } else if (size == 2) {
        walk_group<2>(lane, j, rs, table, dir, cm, pl, ro, part, windows, span, NB, W,
                         low_blades, high_rows);
      } else {
        walk_group<1>(lane, j, rs, table, dir, cm, pl, ro, part, windows, span, NB, W,
                         low_blades, high_rows);
      }
      j += size;
    }
    __syncwarp();  // the tile's output words and partial sums are in place
    if (lane < n) {
      int pc = 0, dc = 0, reqb = 0;
      if ((windows >> lane) & 1u) {
#pragma unroll 8
        for (int l = 0; l < 32; ++l) {
          pc += part[l * kPartRow + lane];
          dc += part[(32 + l) * kPartRow + lane];
          reqb += part[(64 + l) * kPartRow + lane];
        }
      }
      const int i = t0 + lane;
      w1[i] = ro[lane];
      // w2 = nfalse | dropped << 15, both 0 on a downgrade.
      w2[i] = ro[kTile + lane] ? 0 : static_cast<int32_t>(static_cast<uint32_t>(pc - reqb) |
                                                        (static_cast<uint32_t>(pc) << 15));
      w3[i] = dc;
    }
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) lane_replay_kernel(
    int L, int S, int span, int NB, int W, int nsteps, int dkc, Streams in,
    const int32_t* __restrict__ dir_in, const int32_t* __restrict__ cmask,
    const int32_t* __restrict__ planes_in, int32_t* dir_out, int32_t* planes_out,
    int32_t* __restrict__ w1, int32_t* __restrict__ w2, int32_t* __restrict__ w3) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  const int g = blockIdx.x;
  const int64_t so = static_cast<int64_t>(g) * L;
  in.slot += so; in.blade += so; in.write += so; in.valid += so;
  in.ptype += so; in.w0 += so; in.rw += so; in.bit += so;
  w1 += so; w2 += so; w3 += so;
  const int nd = 4 * S, nc = S * span, np = 2 * NB * W;
  dir_in += static_cast<int64_t>(g) * nd;
  dir_out += static_cast<int64_t>(g) * nd;
  cmask += static_cast<int64_t>(g) * nc;
  planes_in += static_cast<int64_t>(g) * np;
  planes_out += static_cast<int64_t>(g) * np;

  uint32_t* table = reinterpret_cast<uint32_t*>(smem + kRingInts);
  int32_t* part = smem + kRingInts + kTableInts;
  for (int k = threadIdx.x; k < kTableInts; k += blockDim.x) table[k] = transition_code(k, dkc);
  int32_t* dir;
  const int32_t* cm;
  int32_t* pl;
  if (kSmem) {  // the state after the ring and table, on chip for the launch
    dir = smem + kFixedInts;
    int32_t* c = dir + nd;
    pl = c + nc;
    copy_words(dir, dir_in, nd);
    copy_words(c, cmask, nc);
    copy_words(pl, planes_in, np);
    cm = c;
  } else {  // the state in the output copies
    copy_words(dir_out, dir_in, nd);
    copy_words(planes_out, planes_in, np);
    dir = dir_out;
    cm = cmask;
    pl = planes_out;
  }
  __syncthreads();  // the state is staged
  if (threadIdx.x < 32) {
    walk(threadIdx.x, in, S, span, NB, W, nsteps, smem, table, part, dir, cm,
         reinterpret_cast<uint32_t*>(pl), w1, w2, w3);
  } else {  // the other warps zero the output words of the steps not walked
    for (int i = nsteps + threadIdx.x - 32; i < L; i += blockDim.x - 32) {
      w1[i] = 0;
      w2[i] = 0;
      w3[i] = 0;
    }
  }
  if (kSmem) {
    __syncthreads();  // the walk is done
    copy_words(dir_out, dir, nd);
    copy_words(planes_out, pl, np);
  }
}

}  // namespace

// The largest dynamic shared memory one block may opt into on the current
// device (ops._lane_route compares ops.lane_smem_bytes with it).
extern "C" int lane_replay_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

// route 0: the state in shared memory; 1: the state in global memory.
// Streams [G, L] (valid bool), dirrows [G, S, 4], cmask [G, S, span],
// planes [G, 2NB, W] in and out, w1..w3 [G, L] (0 at the steps past nsteps
// and the invalid ones).
extern "C" int lane_replay_launch(
    int G, int L, int S, int span, int NB, int W, int nsteps, int dkc,
    int route, const void* slot, const void* blade, const void* write,
    const void* valid, const void* ptype, const void* w0, const void* rw,
    const void* bit, const void* dir_in, const void* cmask,
    const void* planes_in, void* dir_out, void* planes_out, void* w1,
    void* w2, void* w3, void* stream) {
  if (G <= 0 || nsteps <= 0) return 0;
  if (route != 0 && route != 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t state = 4 * (4 * static_cast<size_t>(S) + static_cast<size_t>(S) * span +
                            2 * static_cast<size_t>(NB) * W);
  const size_t bytes = 4 * static_cast<size_t>(kFixedInts) + (route == 0 ? state : 0);
  auto kern = route == 0 ? lane_replay_kernel<true> : lane_replay_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that no later launch reports it
    return static_cast<int>(err);
  }
  Streams in{static_cast<const int32_t*>(slot), static_cast<const int32_t*>(blade),
             static_cast<const int32_t*>(write), static_cast<const bool*>(valid),
             static_cast<const int32_t*>(ptype), static_cast<const int32_t*>(w0),
             static_cast<const int32_t*>(rw), static_cast<const int32_t*>(bit)};
  kern<<<G, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      L, S, span, NB, W, nsteps, dkc, in, static_cast<const int32_t*>(dir_in),
      static_cast<const int32_t*>(cmask), static_cast<const int32_t*>(planes_in),
      static_cast<int32_t*>(dir_out), static_cast<int32_t*>(planes_out),
      static_cast<int32_t*>(w1), static_cast<int32_t*>(w2), static_cast<int32_t*>(w3));
  return static_cast<int>(cudaGetLastError());
}
