// The MoE experts' grouped products on Hopper's tensor cores: route "wgmma"
// of ops.moe_experts (the forward's two launches) and of
// ops.moe_experts_backward (its four), bf16 and fp16.
//
// Replaces no TPU kernel: the JAX package computes these products with
// jax.lax.ragged_dot (src/repro/models/moe.py, moe_ffn_ragged) and trains
// through XLA's autodiff of it.  The functions are those of moe_experts.cu
// (forward) and moe_experts_bwd.cu (backward), whose header comments define
// them; the launchers there call the entry points at the end of this file
// for route 2.  Each product is rounded to the element type, then the
// activation, then the gate's product; act' is taken at the saved, rounded
// products; dx's two products go into one fp32 sum with one rounding; rows
// past offs[E-1] are not written; an empty expert's dW is exactly 0.
//
// Bound.  A decode step routes a few rows to each expert it touches: the
// weights stream once, so bytes bound it.  A 500-token prefill routes ~47
// rows to each expert, a training microbatch (M 24,576 over 64 experts)
// ~384: tensor-core operations bound them (the prefill's weights nearly).
//
// Design: one grouped-GEMM mainloop for three operand layouts, all 16-bit
// operands read by wgmma from shared memory in the 128-byte swizzle, no
// tensor transposed in device memory:
//   "nn" (forward): C[rows, n] = A[rows, :] . W[e][:, n]; A K-major, W
//        [E, K, N] MN-major (the descriptor's transpose bit).
//   "nt" (dh, dx):  C[rows, n] = sum over terms of A_t[rows, :] . Bt_t[e][n, :];
//        Bt [E, N, K] K-major, read in place.
//   "tn" (dw):      C[e][k, n] = X[R_e]^T G[R_e]; X^T and G both MN-major,
//        the rows of expert e the reduction.
// - Copies are TMA (cp.async.bulk.tensor): 2-d maps over the row operands
//   [M, K], 3-d maps over the weights [E, K, N] (the expert a box
//   coordinate), encoded on the host per call from the pointers and shapes
//   alone (the host never reads offs, so a CUDA graph can capture the call)
//   and passed as __grid_constant__.  Every box is 64 elements (128 bytes)
//   wide; a stage holds one 64-deep step of A and of each B.  Ragged K and
//   N tails and rows past M come in as TMA's zeros; columns past N are
//   computed and not stored.
// - Persistent CTAs (one per SM, at most the tiles) walk the output tiles
//   in a fixed order.  "nn"/"nt": a tile is a row tile of one expert x 128
//   columns; the row tiles of all experts are numbered expert after expert
//   and each warp finds its tile's expert with locate_tile's scan over
//   offs; rows of the next expert inside a row tile are computed and never
//   stored.  "tn": a tile is expert x 128 K x 128 N, walking the expert's
//   rows from its first in steps of 64; the last step's rows at or past the
//   expert's end (whole 128-byte staged rows: the swizzle moves 16-byte
//   chunks within a row) are zeroed in shared memory, then fenced to the
//   async proxy, before a wgmma reads them.
// - Warp specialisation: one producer warp keeps a ring of 4-8 stages of
//   TMA loads in flight (full/empty mbarriers; a consumer warp releases a
//   stage once its wgmma group is done); one or two consumer warpgroups of
//   64 rows each run wgmma m64n128k16 with fp32 accumulators in registers,
//   one wgmma group in flight while the previous stage is released.
// - The epilogue runs on the register fragments (nothing goes back through
//   shared memory): the forward's GLU and activation and its saved a, b;
//   dh's dA, dB and h from the saved products; plain stores for the rest.
//   Two things keep it cheap against a mainloop of a few steps (dw's ~6):
//   each quad of lanes transposes its row's pairs by shuffles so that a
//   lane stores (and dh loads) 16 bytes, whole sectors; and a rolled loop
//   over groups of column blocks, shifting the fragments in registers,
//   keeps the activations' code small enough for the instruction cache.
// - Tiles by regime (from M and E alone): 64-row tiles (one consumer) when
//   fewer than 32 rows go to an expert on average (decode), else 128 (two
//   consumers; prefill, training, and always for dw).  With a GLU (the
//   forward's up launch, dw of gate and up) the two products share the A
//   tile and keep two 64x128 accumulators a thread's 128 registers.
// - Determinism: no split-K and no atomics; each output element is summed
//   by one CTA in a fixed order, so two calls agree bit for bit.
//
// The entry points return the CUDA error code of the launch (0 on success),
// or kEncodeFailed + the CUresult when a tensor map cannot be encoded, and
// never synchronise.

#include "moe_experts.cuh"
#include "sm90.cuh"

namespace {

enum Layout { kNN = 0, kNT = 1, kTN = 2 };

constexpr int kTileN = 128;             // output columns of a tile
constexpr int kStepK = 64;              // reduction depth of a stage: 128 bytes of 16-bit elements
constexpr int kBlock = 64 * 128;        // one 64-row x 128-byte swizzled block
constexpr int kSmemBudget = 200 * 1024; // the ring's shared memory
constexpr int kDecodeRows = 32;         // rows an expert below which a row tile is 64

// KC consumer warpgroups (64 rows each), NB B operands (accumulators).
template <int KC, int NB>
struct WgCfg {
  static constexpr int A_BYTES = KC * kBlock;       // BM rows (or BM columns of X^T) x 128 bytes
  static constexpr int B_BYTES = 2 * kBlock;        // 128 columns x 64 deep
  static constexpr int STAGE_BYTES = A_BYTES + NB * B_BYTES;
  static constexpr int STAGES = kSmemBudget / STAGE_BYTES < 8 ? kSmemBudget / STAGE_BYTES : 8;
  static constexpr int THREADS = 128 * (KC + 1);
  static constexpr int SMEM = STAGES * STAGE_BYTES + 16 * STAGES + 1024;  // + alignment slack
};

template <typename T>
struct WgArgs {
  const int* offs;
  int M, K, N, E;
  int mode;   // nn: the forward's mode; nt: 0 a plain store, 1-4 dh's epilogue
  int terms;  // nt: products summed (dx with a gate: 2)
  int ncol;   // column tiles
  int nk;     // 64-deep steps of one product (nn, nt)
  int kt;     // tn: 128-row tiles of K
  T* out;
  T* out2;    // tn: the second product's dW
  T* save;    // nn: the first product, rounded (null under no_grad)
  T* save2;   // nn: the gate's product
  const T* pa;
  const T* pb;
  T* da;
  T* db;
  T* h;
};

struct Tile {
  int e, row0, row_end, col0, k0, steps;
};

// Tile t of the walk, or false past the last.  Called by whole warps.
template <typename T, int L, int KC>
__device__ __forceinline__ bool next_tile(const WgArgs<T>& p, int t, Tile* tl) {
  if constexpr (L == kTN) {
    const int per = p.kt * p.ncol;
    if (t >= p.E * per) return false;
    tl->e = t / per;
    const int r = t % per;
    tl->k0 = (r / p.ncol) * 64 * KC;
    tl->col0 = (r % p.ncol) * kTileN;
    expert_rows(p.offs, tl->e, p.M, &tl->row0, &tl->row_end);
    tl->steps = (tl->row_end - tl->row0 + kStepK - 1) / kStepK;
  } else {
    const TileInfo ti = locate_tile<64 * KC>(p.offs, p.E, p.M, t / p.ncol);
    if (ti.expert < 0) return false;
    tl->e = ti.expert;
    tl->row0 = ti.row0;
    tl->row_end = ti.row_end;
    tl->col0 = (t % p.ncol) * kTileN;
    tl->k0 = 0;
    tl->steps = p.nk * p.terms;
  }
  return true;
}

// The producer warp: lane 0 issues every copy.
template <typename T, int L, int KC, int NB>
__device__ __forceinline__ void produce(const CUtensorMap* ma0, const CUtensorMap* ma1,
                                        const CUtensorMap* mb0, const CUtensorMap* mb1,
                                        const WgArgs<T>& p, uint32_t ring, uint32_t full0,
                                        uint32_t empty0) {
  using C = WgCfg<KC, NB>;
  const bool leader = (threadIdx.x & 31) == 0;
  int it = 0;
  Tile tl;
  for (int t = blockIdx.x; next_tile<T, L, KC>(p, t, &tl); t += gridDim.x) {
    for (int s = 0; s < tl.steps; ++s, ++it) {
      const int st = it % C::STAGES;
      if (leader) {
        mbar_wait(empty0 + 8 * st, ((it / C::STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, C::STAGE_BYTES);
        const uint32_t sa = ring + st * C::STAGE_BYTES, sb = sa + C::A_BYTES;
        if constexpr (L == kTN) {
          const int r0 = tl.row0 + s * kStepK;
#pragma unroll
          for (int c = 0; c < KC; ++c) tma_load_2d(sa + c * kBlock, ma0, full, tl.k0 + 64 * c, r0);
#pragma unroll
          for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              tma_load_2d(sb + b * C::B_BYTES + c * kBlock, b ? mb1 : mb0, full,
                          tl.col0 + 64 * c, r0);
        } else {
          const bool second = s >= p.nk;
          const int k0 = (second ? s - p.nk : s) * kStepK;
          tma_load_2d(sa, second ? ma1 : ma0, full, k0, tl.row0);
          if constexpr (L == kNN) {
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                tma_load_3d(sb + b * C::B_BYTES + c * kBlock, b ? mb1 : mb0, full,
                            tl.col0 + 64 * c, k0, tl.e);
          } else {
            tma_load_3d(sb, second ? mb1 : mb0, full, k0, tl.col0, tl.e);
          }
        }
      }
      __syncwarp();
    }
  }
}

// Two fp32 values as two T in one 32-bit word.
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

// Eight 16-bit elements through the read-only cache.  Volatile, so that
// a run of them is issued in program order, all in flight before the
// first use waits.
__device__ __forceinline__ void ldg16(uint32_t* w, const void* src) {
  asm volatile("ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "l"(src));
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  } else {
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  }
}

// Four column blocks of one fragment row, held by a quad (the 4 lanes of
// one row): lane q's w[k] (columns 8 k + 2 q and the next) goes to lane k's
// w[q], by shuffles, so that lane q holds block q's 8 columns; and back, the
// same way.  Every lane calls it.
__device__ __forceinline__ void quad_transpose(uint32_t* w) {
  const int q = threadIdx.x & 3;
  {
    const bool b = q & 1;
    const uint32_t s0 = __shfl_xor_sync(0xffffffffu, b ? w[0] : w[1], 1);
    const uint32_t s1 = __shfl_xor_sync(0xffffffffu, b ? w[2] : w[3], 1);
    if (b) {
      w[0] = s0;
      w[2] = s1;
    } else {
      w[1] = s0;
      w[3] = s1;
    }
  }
  {
    const bool b = q & 2;
    const uint32_t s0 = __shfl_xor_sync(0xffffffffu, b ? w[0] : w[2], 2);
    const uint32_t s1 = __shfl_xor_sync(0xffffffffu, b ? w[1] : w[3], 2);
    if (b) {
      w[0] = s0;
      w[1] = s1;
    } else {
      w[2] = s0;
      w[3] = s1;
    }
  }
}

// A group of four column blocks of one fragment row, stored as 16 bytes a
// lane at row + col (col = this lane's block after quad_transpose): a
// warp's store writes 8 rows x 64 bytes of whole sectors, not 8 x 16 bytes.
// Every lane calls it; ok (the row is stored) is the same in a quad.
template <typename T>
__device__ __forceinline__ void store_group(T* row, uint32_t (&w)[4], int col, int N, bool ok) {
  quad_transpose(w);
  if (ok && col < N) *reinterpret_cast<uint4*>(row + col) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Zeroes rows [valid, 64) of a "tn" stage: the KC blocks of X and the 2 NB
// blocks of G, 16 bytes a store, by every consumer thread.
template <int KC, int NB>
__device__ __forceinline__ void zero_tail_rows(uint32_t sa, int valid) {
  constexpr int kBlocks = KC + 2 * NB;  // G's blocks follow X's in the stage
  const int per = (64 - valid) * 8;
  for (int i = static_cast<int>(threadIdx.x) - 128; i < kBlocks * per; i += 128 * KC) {
    const int blk = i / per, rem = i % per;
    const uint32_t addr = sa + blk * kBlock + (valid + rem / 8) * 128 + (rem % 8) * 16;
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr), "r"(0) : "memory");
  }
}

// The epilogue of one tile on a thread's fragments (rows r + 8 i of the
// tile, i = 0, 1): the forward's GLU or activation and its saved products;
// dh's GLU backward (the saved products loaded first, 16 bytes a lane, all
// in flight together, then quad-transposed to the fragment's layout); or
// plain stores.  A rolled loop over four groups of four
// column blocks, shifting the fragments down by a group a turn (register
// moves), so that the activations' code is there once and not 16 times
// (unrolled, dh's overflows the instruction cache: 5x its product's time
// at train shapes).  Each group is stored through store_group.  MODE is
// p.mode as a constant (the caller dispatches on it once), so that a
// group's 16 elements are straight-line code the compiler interleaves.
template <typename T, int L, int NB, int MODE>
__device__ __forceinline__ void epilogue_tile(const WgArgs<T>& p, const Tile& tl,
                                              float (&acc)[NB][kTileN / 2], int r) {
  constexpr int NR = kTileN / 2, NP = kTileN / 8;
  const int q = threadIdx.x & 3;
  bool ok[2];
  size_t base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if constexpr (L == kTN) {
      const int k = tl.k0 + r + 8 * i;
      ok[i] = k < p.K;
      base[i] = ((size_t)tl.e * p.K + k) * p.N;
    } else {
      const int row = tl.row0 + r + 8 * i;
      ok[i] = row < tl.row_end;
      base[i] = (size_t)row * p.N;
    }
  }
  constexpr bool dh = L == kNT && MODE != 0;
  constexpr bool glu = MODE <= 2;
  uint32_t ra[2][NP], rb[2][NP];  // dh: group g's block g*4 + q at [4 g, 4 g + 4)
  if constexpr (L == kNT) {
    if (dh) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int g = 0; g < NP / 4; ++g) {
          const int col = tl.col0 + (g * 4 + q) * 8;
          const bool in = ok[i] && col < p.N;
#pragma unroll
          for (int k = 0; k < 4; ++k) ra[i][g * 4 + k] = rb[i][g * 4 + k] = 0u;
          if (in && glu) ldg16(&ra[i][g * 4], p.pa + base[i] + col);
          if (in) ldg16(&rb[i][g * 4], p.pb + base[i] + col);
        }
    }
  }
#pragma unroll 1
  for (int g = 0; g < NP / 4; ++g) {
    const int col = tl.col0 + (g * 4 + q) * 8;  // this lane's block after the transpose
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t w0[4], w1[4], w2[4];
      if constexpr (L == kNT) {
        if (dh) {  // the saved products to the fragment's layout
          quad_transpose(&ra[i][0]);
          quad_transpose(&rb[i][0]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v0 = acc[0][k * 4 + i * 2], v1 = acc[0][k * 4 + i * 2 + 1];
        if constexpr (L == kNN) {
          float u0 = 0.f, u1 = 0.f;
          if constexpr (NB == 2) {
            u0 = acc[1][k * 4 + i * 2];
            u1 = acc[1][k * 4 + i * 2 + 1];
          }
          w0[k] = pack2<T>(epilogue<T>(MODE, v0, u0), epilogue<T>(MODE, v1, u1));
          w1[k] = pack2<T>(v0, v1);
          w2[k] = pack2<T>(u0, u1);
        } else if constexpr (L == kTN) {
          w0[k] = pack2<T>(v0, v1);
          if constexpr (NB == 2) w1[k] = pack2<T>(acc[1][k * 4 + i * 2], acc[1][k * 4 + i * 2 + 1]);
        } else {
          if (dh) {
            const float2 a = unpack2<T>(ra[i][k]), b = unpack2<T>(rb[i][k]);
            float da0, db0, h0, da1, db1, h1;
            glu_backward<T>(MODE, v0, a.x, b.x, &da0, &db0, &h0);
            glu_backward<T>(MODE, v1, a.y, b.y, &da1, &db1, &h1);
            w0[k] = pack2<T>(da0, da1);
            w1[k] = pack2<T>(db0, db1);
            w2[k] = pack2<T>(h0, h1);
          } else {
            w0[k] = pack2<T>(v0, v1);
          }
        }
      }
      if constexpr (L == kNN) {
        store_group(p.out + base[i], w0, col, p.N, ok[i]);
        if (p.save) store_group(p.save + base[i], w1, col, p.N, ok[i]);
        if (NB == 2 && p.save2) store_group(p.save2 + base[i], w2, col, p.N, ok[i]);
      } else if constexpr (L == kTN) {
        store_group(p.out + base[i], w0, col, p.N, ok[i]);
        if constexpr (NB == 2) store_group(p.out2 + base[i], w1, col, p.N, ok[i]);
      } else if (dh) {
        if (glu) store_group(p.da + base[i], w0, col, p.N, ok[i]);
        store_group(p.db + base[i], w1, col, p.N, ok[i]);
        store_group(p.h + base[i], w2, col, p.N, ok[i]);
      } else {
        store_group(p.out + base[i], w0, col, p.N, ok[i]);
      }
    }
    // The next group to the front.
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j + 16 < NR; ++j) acc[b][j] = acc[b][j + 16];
    if constexpr (L == kNT) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j + 4 < NP; ++j) {
          ra[i][j] = ra[i][j + 4];
          rb[i][j] = rb[i][j + 4];
        }
    }
  }
}

// One consumer warpgroup: rows [64 cw, 64 cw + 64) of each tile.
// Fragment of an m64n128 accumulator: register n*4 + i*2 + j holds row
// warp*16 + lane/4 + 8*i, column n*8 + (lane%4)*2 + j.
template <typename T, int L, int KC, int NB>
__device__ __forceinline__ void consume(const WgArgs<T>& p, uint32_t ring, uint32_t full0,
                                        uint32_t empty0, int cw) {
  using C = WgCfg<KC, NB>;
  constexpr int NR = kTileN / 2;
  constexpr int TA = L == kTN ? 1 : 0;  // X^T is MN-major
  constexpr int TB = L == kNT ? 0 : 1;  // W and G are MN-major, Bt K-major
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  float acc[NB][NR];
  int it = 0;
  Tile tl;
  for (int t = blockIdx.x; next_tile<T, L, KC>(p, t, &tl); t += gridDim.x) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[b][i] = 0.f;
    for (int s = 0; s < tl.steps; ++s, ++it) {
      const int st = it % C::STAGES;
      mbar_wait(full0 + 8 * st, (it / C::STAGES) & 1);
      const uint32_t sa = ring + st * C::STAGE_BYTES, sb = sa + C::A_BYTES;
      if constexpr (L == kTN) {
        const int valid = tl.row_end - (tl.row0 + s * kStepK);
        if (valid < kStepK) {  // the expert's last step: rows of the next expert
          zero_tail_rows<KC, NB>(sa, valid);
          fence_proxy_async();
          asm volatile("bar.sync 1, %0;\n" ::"n"(128 * KC) : "memory");
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStepK / 16; ++kk) {
        const uint64_t da = L == kTN ? desc_sw128(sa + cw * kBlock + kk * 2048, kBlock, 1024)
                                     : desc_sw128(sa + cw * kBlock + kk * 32, 16, 1024);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const uint64_t db = L == kNT ? desc_sw128(sb + kk * 32, 16, 1024)
                                       : desc_sw128(sb + b * C::B_BYTES + kk * 2048, kBlock, 1024);
          wgmma_ss<kTileN, T, TA, TB>(acc[b], da, db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's group is done: release its stage
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
      if (s > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % C::STAGES));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    if (tl.steps > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % C::STAGES));

    const int r = cw * 64 + warp * 16 + lane / 4;
    if constexpr (L == kTN) {
      epilogue_tile<T, L, NB, 0>(p, tl, acc, r);
    } else if constexpr (L == kNN && NB == 2) {  // the GLU's up launch
      if (p.mode == 1) epilogue_tile<T, L, NB, 1>(p, tl, acc, r);
      else epilogue_tile<T, L, NB, 2>(p, tl, acc, r);
    } else {
      switch (p.mode) {
        case 0: epilogue_tile<T, L, NB, 0>(p, tl, acc, r); break;
        case 3: epilogue_tile<T, L, NB, 3>(p, tl, acc, r); break;
        case 4: epilogue_tile<T, L, NB, 4>(p, tl, acc, r); break;
        default:
          if constexpr (L == kNT) {  // dh of a GLU
            if (p.mode == 1) epilogue_tile<T, L, NB, 1>(p, tl, acc, r);
            else epilogue_tile<T, L, NB, 2>(p, tl, acc, r);
          }
      }
    }
  }
}

template <typename T, int L, int KC, int NB>
__device__ __forceinline__ void grouped_gemm(const CUtensorMap* ma0, const CUtensorMap* ma1,
                                             const CUtensorMap* mb0, const CUtensorMap* mb1,
                                             const WgArgs<T>& p) {
  using C = WgCfg<KC, NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzled tiles: 1024-byte aligned
  const uint32_t full0 = ring + C::STAGES * C::STAGE_BYTES;
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  if (threadIdx.x == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 4 * KC);  // every consumer warp releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if constexpr (KC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32) produce<T, L, KC, NB>(ma0, ma1, mb0, mb1, p, ring, full0, empty0);
  } else {
    if constexpr (KC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<T, L, KC, NB>(p, ring, full0, empty0, wg - 1);
  }
}

// Three kernel names, one mainloop: the forward's, and the backward's two
// ("moe_bwd_" marks the backward's kernels in a profile).
template <typename T, int KC, int NB>
__global__ void __launch_bounds__(128 * (KC + 1), 1)
moe_wgmma_kernel(__grid_constant__ const CUtensorMap ma0, __grid_constant__ const CUtensorMap ma1,
                 __grid_constant__ const CUtensorMap mb0, __grid_constant__ const CUtensorMap mb1,
                 __grid_constant__ const WgArgs<T> p) {
  grouped_gemm<T, kNN, KC, NB>(&ma0, &ma1, &mb0, &mb1, p);
}

template <typename T, int KC>
__global__ void __launch_bounds__(128 * (KC + 1), 1)
moe_bwd_nt_wgmma_kernel(__grid_constant__ const CUtensorMap ma0,
                        __grid_constant__ const CUtensorMap ma1,
                        __grid_constant__ const CUtensorMap mb0,
                        __grid_constant__ const CUtensorMap mb1,
                        __grid_constant__ const WgArgs<T> p) {
  grouped_gemm<T, kNT, KC, 1>(&ma0, &ma1, &mb0, &mb1, p);
}

template <typename T, int NB>
__global__ void __launch_bounds__(384, 1)
moe_bwd_tn_wgmma_kernel(__grid_constant__ const CUtensorMap ma0,
                        __grid_constant__ const CUtensorMap ma1,
                        __grid_constant__ const CUtensorMap mb0,
                        __grid_constant__ const CUtensorMap mb1,
                        __grid_constant__ const WgArgs<T> p) {
  grouped_gemm<T, kTN, 2, NB>(&ma0, &ma1, &mb0, &mb1, p);
}

// ---- host ------------------------------------------------------------------
template <typename T>
CUtensorMapDataType map_type() {
  return std::is_same_v<T, __nv_bfloat16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// A row-major [rows, cols] tensor in boxes of 64 columns x box_rows rows.
template <typename T>
CUresult map_2d(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, map_type<T>(), 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// An [E, outer, inner] tensor in boxes of 64 inner x box_outer x 1 expert.
template <typename T>
CUresult map_3d(EncodeTiled fn, CUtensorMap* map, const void* ptr, int E, int outer, int inner,
                int box_outer) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(outer) * inner * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_outer), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, map_type<T>(), 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int sm_count(int dev) {
  static int counts[64] = {};
  if (dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
    counts[dev] = n;
  }
  return counts[dev];
}

template <typename T, int L, int KC, int NB>
int launch(const CUtensorMap (&m)[4], const WgArgs<T>& p, long long tiles, cudaStream_t stream) {
  using C = WgCfg<KC, NB>;
  auto kernel = [] {
    if constexpr (L == kNN) return moe_wgmma_kernel<T, KC, NB>;
    else if constexpr (L == kNT) return moe_bwd_nt_wgmma_kernel<T, KC>;
    else return moe_bwd_tn_wgmma_kernel<T, NB>;
  }();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static unsigned long long opted_in = 0;  // per instantiation, a bit per device
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted_in & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in |= bit;
  }
  const long long sms = sm_count(dev);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  if (grid <= 0) return 0;
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

bool decode_regime(int M, int E) {
  return static_cast<long long>(M) < static_cast<long long>(kDecodeRows) * E;
}

template <typename T>
int forward(const void* a, const void* b, const void* b2, const void* offs, void* out, void* save,
            void* save2, int M, int K, int N, int E, int mode, cudaStream_t stream) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kEncodeFailed + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const bool small = decode_regime(M, E);
  CUtensorMap m[4];
  CUresult r = map_2d<T>(fn, &m[0], a, M, K, small ? 64 : 128);
  if (r == CUDA_SUCCESS) r = map_3d<T>(fn, &m[2], b, E, K, N, kStepK);
  if (r == CUDA_SUCCESS && b2 != nullptr) r = map_3d<T>(fn, &m[3], b2, E, K, N, kStepK);
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  m[1] = m[0];
  if (b2 == nullptr) m[3] = m[2];
  WgArgs<T> p{};
  p.offs = static_cast<const int*>(offs);
  p.M = M;
  p.K = K;
  p.N = N;
  p.E = E;
  p.mode = mode;
  p.terms = 1;
  p.ncol = ceil_div(N, kTileN);
  p.nk = ceil_div(K, kStepK);
  p.out = static_cast<T*>(out);
  p.save = static_cast<T*>(save);
  p.save2 = static_cast<T*>(save2);
  const long long tiles = (static_cast<long long>(ceil_div(M, small ? 64 : 128)) + E) * p.ncol;
  if (small)
    return b2 ? launch<T, kNN, 1, 2>(m, p, tiles, stream) : launch<T, kNN, 1, 1>(m, p, tiles, stream);
  return b2 ? launch<T, kNN, 2, 2>(m, p, tiles, stream) : launch<T, kNN, 2, 1>(m, p, tiles, stream);
}

template <typename T>
int nt(const void* a0, const void* bt0, const void* a1, const void* bt1, const void* offs, int M,
       int K, int N, int E, int mode, void* out, const void* pa, const void* pb, void* da, void* db,
       void* h, cudaStream_t stream) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kEncodeFailed + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const bool small = decode_regime(M, E);
  const bool two = a1 != nullptr;
  CUtensorMap m[4];
  CUresult r = map_2d<T>(fn, &m[0], a0, M, K, small ? 64 : 128);
  if (r == CUDA_SUCCESS) r = map_3d<T>(fn, &m[2], bt0, E, N, K, kTileN);
  if (r == CUDA_SUCCESS && two) r = map_2d<T>(fn, &m[1], a1, M, K, small ? 64 : 128);
  if (r == CUDA_SUCCESS && two) r = map_3d<T>(fn, &m[3], bt1, E, N, K, kTileN);
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  if (!two) {
    m[1] = m[0];
    m[3] = m[2];
  }
  WgArgs<T> p{};
  p.offs = static_cast<const int*>(offs);
  p.M = M;
  p.K = K;
  p.N = N;
  p.E = E;
  p.mode = mode;
  p.terms = two ? 2 : 1;
  p.ncol = ceil_div(N, kTileN);
  p.nk = ceil_div(K, kStepK);
  p.out = static_cast<T*>(out);
  p.pa = static_cast<const T*>(pa);
  p.pb = static_cast<const T*>(pb);
  p.da = static_cast<T*>(da);
  p.db = static_cast<T*>(db);
  p.h = static_cast<T*>(h);
  const long long tiles = (static_cast<long long>(ceil_div(M, small ? 64 : 128)) + E) * p.ncol;
  return small ? launch<T, kNT, 1, 1>(m, p, tiles, stream) : launch<T, kNT, 2, 1>(m, p, tiles, stream);
}

template <typename T>
int tn(const void* x, const void* g, const void* g2, const void* offs, void* out, void* out2, int M,
       int K, int N, int E, cudaStream_t stream) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kEncodeFailed + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  CUtensorMap m[4];
  CUresult r = map_2d<T>(fn, &m[0], x, M, K, kStepK);
  if (r == CUDA_SUCCESS) r = map_2d<T>(fn, &m[2], g, M, N, kStepK);
  if (r == CUDA_SUCCESS && g2 != nullptr) r = map_2d<T>(fn, &m[3], g2, M, N, kStepK);
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  m[1] = m[0];
  if (g2 == nullptr) m[3] = m[2];
  WgArgs<T> p{};
  p.offs = static_cast<const int*>(offs);
  p.M = M;
  p.K = K;
  p.N = N;
  p.E = E;
  p.ncol = ceil_div(N, kTileN);
  p.kt = ceil_div(K, 128);
  p.out = static_cast<T*>(out);
  p.out2 = static_cast<T*>(out2);
  const long long tiles = static_cast<long long>(E) * p.kt * p.ncol;
  return g2 ? launch<T, kTN, 2, 2>(m, p, tiles, stream) : launch<T, kTN, 2, 1>(m, p, tiles, stream);
}

}  // namespace

int moe_sm90_forward(int dtype, const void* a, const void* b, const void* b2, const void* offs,
                     void* out, void* save, void* save2, int M, int K, int N, int E, int mode,
                     cudaStream_t stream) {
  switch (dtype) {
    case 1: return forward<__nv_bfloat16>(a, b, b2, offs, out, save, save2, M, K, N, E, mode, stream);
    case 2: return forward<__half>(a, b, b2, offs, out, save, save2, M, K, N, E, mode, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int moe_sm90_nt(int dtype, const void* a0, const void* bt0, const void* a1, const void* bt1,
                const void* offs, int M, int K, int N, int E, int mode, void* out,
                const void* pa, const void* pb, void* da, void* db, void* h,
                cudaStream_t stream) {
  switch (dtype) {
    case 1:
      return nt<__nv_bfloat16>(a0, bt0, a1, bt1, offs, M, K, N, E, mode, out, pa, pb, da, db, h,
                               stream);
    case 2:
      return nt<__half>(a0, bt0, a1, bt1, offs, M, K, N, E, mode, out, pa, pb, da, db, h, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int moe_sm90_tn(int dtype, const void* x, const void* g, const void* g2, const void* offs,
                void* out, void* out2, int M, int K, int N, int E, cudaStream_t stream) {
  switch (dtype) {
    case 1: return tn<__nv_bfloat16>(x, g, g2, offs, out, out2, M, K, N, E, stream);
    case 2: return tn<__half>(x, g, g2, offs, out, out2, M, K, N, E, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
