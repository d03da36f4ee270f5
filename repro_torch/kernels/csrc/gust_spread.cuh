// GUST SpMV spread over the card: the block kernel, the in-order fold, the
// launch plan and the dtype dispatch of every SpMV kernel of the port,
// templated on the gather, the number of x-tile stages and the number of
// stream stages:
//   resident (Gather::kResident, no x-tile stage): a slot reads x[col]
//     directly; kernels 1 and 2 (gust_spmv.cu, padded and ragged; the
//     next chunk's slots prefetched into registers) and kernels 5 and 7
//     (gust_spmv_db.cu, padded and ragged; the slots come through a ring
//     of two stream stages in shared memory, filled by bulk copies, where
//     the leaves allow it, else as kernels 1/2).
//   segment-local (Gather::kLocal): a slot reads x through its block's
//     segment table, the slot at block-local address col_loc of block t
//     taking x[seg_blk[t, col_loc / l] * l + col_loc % l]; one x-tile
//     stage for kernels 3/4 (gust_spmv_local.cu), two for 6/8
//     (gust_spmv_local_db.cu).
// Each source includes this header once and keeps its own entry points and
// library.
//
// What they compute.  The stream holds blocks of c_blk cycles x l lanes;
// in each cycle lane j carries one slot (value, column, adder row) that
// adds value * x[column, :] into its row of the window's (l, B) output
// tile.  Each (c_blk, l) block is summed cycle by cycle into a zeroed
// (l, B) tile (products and sums rounded with the _rn intrinsics, slots
// whose value is 0 skipped), then the window's block tiles are folded in
// stream order: acc = p[t0], acc = __fadd_rn(acc, p[t]).  That association
// is defined here alone, and every instance keeps it, so on one artifact,
// for finite x, every kernel equals every other bitwise (single ==
// double, resident == local, padded == ragged), and at B=1 each equals the
// plain version run on the CPU (repro_torch/kernels/ref.py), which adds in
// the same order.
//
// Design.  A block's tile depends on nothing outside the block, so the
// blocks need not run one window to a CTA.
//   1. spread_partials: a persistent grid (CTAs per SM from the occupancy
//      calculator times the SMs, never more CTAs than blocks) in which CTA
//      c takes the run of consecutive blocks T*c/G .. T*(c+1)/G of the
//      whole stream, whatever their windows, and writes each block's (l, B)
//      tile to a scratch (T, l, B) f32.  spread_fold then adds each
//      window's tiles in stream order, one thread per (window, lane,
//      column), with exactly the adds above.  The C entry points launch
//      both on the caller's stream.
//   2. Local only: a ring of two seg_blk rows in shared memory is filled
//      ahead, so the count of a block's staged tiles comes from shared
//      memory, one warp ballot.  The staged tiles of a block are the
//      strictly increasing prefix of its table row (the packer's rows:
//      distinct segments ascending, then padding with segment 0, which no
//      slot references), at most `cap` of them, copied with cp.async (16
//      bytes at a time where x's alignment and the tile length allow).
//        STAGES == 1: at the top of block t, once block t-1 has read its
//        last tile, the CTA starts the copies of block t's tiles into the
//        one stage and of block t+1's table row, then waits once and
//        passes one barrier; block t's first slots are already in
//        registers.  No x tile is copied ahead of its block.
//        STAGES == 2: at the top of block t the CTA waits once for block
//        t's copies, passes one barrier and starts the copies of block
//        t+1's tiles into the other stage and of block t+2's table row;
//        they fly while block t computes.
//   3. A local slot whose segment is staged reads x at tiles[col_loc * bt
//      + k] in shared memory.  A local slot past the staged tiles (past the
//      cap, or past a prefix that a table out of order cuts short) reads
//      seg_blk and x directly, so the result never rests on the order or
//      the cap; it only costs a dependent read.  A resident slot always
//      reads x directly: x is read once per slot from L2 (it is 0.26 MB
//      at B=1 on crankseg_2), and there is nothing to stage.  At B=8 a
//      slot's x row (from the stage or from x) is read, and a block tile's
//      row written to the scratch, 16 bytes at a time (mul_row,
//      store_row): with one 4-byte access per column each warp access
//      touched 32 sectors for 128 bytes, and the 16-byte rows took 24-43%
//      off the B=8 time of kernels 3/4 and 6/8 (python -m
//      repro_torch.kernels.local_db_sweep, variants scalar_*).
//   4. The cycles of a chunk (up to kc cycles of one block) run with two
//      barriers, not one per cycle: each lane writes its slots' products
//      into a shared (cycle, column, row) buffer (collision-free: within a
//      cycle no two real slots share a row), then thread j adds row j's
//      entries cycle by cycle into its register tile and clears them.  A
//      cycle that has no slot on a row leaves +0 there, and adding +0 to a
//      sum that started at +0 changes no bit.  The local instances pass
//      the second barrier at a block's top (the stage barrier of 2); the
//      resident one after every chunk.
//   5. Where a chunk's (value, column, row) slots come from:
//        RING == 0: each thread loads the next chunk's slots, the next
//        block's first ones included, into registers as soon as this
//        chunk's products are out, before the barrier, so they are in
//        flight while the chunk sums (4-byte loads, one per leaf, slot and
//        thread).
//        RING == 2 (resident only, at B > 1): a chunk's rows of the three
//        leaves are one contiguous byte range of each, and a CTA's chunks
//        follow one another in the stream.  Stage u % 2 of a ring in
//        shared memory holds chunk u of the CTA's run, with an mbarrier of
//        its own: one thread arms the barrier with the chunk's bytes and
//        asks for the three rows with cp.async.bulk, which complete on
//        it; the CTA waits on the stage's phase (parity u / 2 % 2, tracked
//        from the run's chunk count, so any number of blocks and windows
//        may pass) and thread j reads element j of each row where it uses
//        it (no bank conflict, and no copy of the chunk in registers).
//        Right after the chunk's product barrier, by which every thread
//        has read the stage, the same thread fences the async proxy and
//        refills the stage with chunk u + 2, so the ring needs no barrier
//        of its own, and nothing is asked for past the run's last chunk.
//        A bulk copy needs 16-byte aligned addresses and sizes: the ring
//        runs where l * sizeof(leaf) % 16 == 0 for the three leaves and
//        their base pointers are 16-byte aligned (then every chunk,
//        short last chunks too, is whole 16-byte runs), else the same
//        entry point runs RING == 0; the launch plan reports which
//        (stream_stages).  At B=1 the entry points run RING == 0 too:
//        there the ring's stages (48 KB a CTA at l=256, f32) take the
//        shared memory that otherwise serves as L1 for x (0.26 MB at B=1
//        on crankseg_2), and the ring was slower than the register
//        prefetch on the card; at B=8 x does not fit in L1 either way and
//        the ring is faster (PERF.md; python -m
//        repro_torch.kernels.local_db_sweep, variants ring_b1,
//        stream_registers, ring_bytes).
// Shared memory per CTA: the (kc, B, l) product buffer; a local CTA also
// holds STAGES stages of `cap` x tiles of (l, B) f32 and the two table
// rows, sized from l, B and the cap, never from S_blk; a ring CTA holds two
// stream stages of kc rows of each leaf and their mbarriers.  An x-tile
// stage fills kStageBytes, so the cap is 16 tiles at l=256 and B=1 and 2
// at B=8 for either local instance; one stage with the bytes of two (4
// tiles at B=8) was 11-13% slower on the card at B=8, its larger CTA
// leaving 3 CTAs per SM instead of 4 (python -m
// repro_torch.kernels.local_db_sweep, variant cap_x2).  kc is 8 cycles at
// B=1, 4 at B>1.  A resident CTA takes 8 KB at l=256 and B=1, 32 KB at
// B=8; the ring adds 2 x 12 KB at B=8 for f32 values and int32 indices.
//
// Bound.  Memory: each stream slot read once (value + column + row bytes),
// the scales, x once (local: also the referenced prefix of each seg_blk
// row), y written once.  The design adds the scratch, T*l*B*4 bytes
// written and read again (chip_smoke.py prints it as partial_bytes), and
// for the local gather the x-tile copies, which re-read x from L2
// (x_tile_bytes).  One multiply and one add per slot and vector column is
// far below the card's rate.

#pragma once

#include <algorithm>

#include "gust_common.cuh"

namespace {

using gust::align16;
using gust::allow_smem;
using gust::bulk_copy_g2s;
using gust::cp_async16;
using gust::cp_async4;
using gust::cp_async_commit;
using gust::cp_async_wait;
using gust::fence_mbarrier_init;
using gust::fence_proxy_async_shared;
using gust::load_value;
using gust::max_shared_bytes;
using gust::mbar_arrive_expect_tx;
using gust::mbar_init;
using gust::mbar_wait;

// Where a slot's x value comes from: x[col] (resident) or x through the
// block's segment table (local).
enum class Gather { kResident, kLocal };

constexpr int kMaxCap = 16;             // most x tiles staged per block
constexpr int kStageBytes = 16 * 1024;  // bytes of one x-tile stage
constexpr int kFoldThreads = 256;

// Most cycles per chunk: the slots a thread holds in registers at once.
template <int BT>
__host__ __device__ constexpr int chunk_cycles() {
  return BT == 1 ? 8 : 4;
}

// dst[k * l] = val * src[k] for the bt values of the row at src, read 16
// bytes at a time where the row is whole (bt == BT, a multiple of 4) and
// src is 16-byte aligned, else one at a time; GLOBAL reads through the
// read-only cache.
template <int BT, bool GLOBAL>
__device__ __forceinline__ void mul_row(float* dst, int l, float val,
                                        const float* src, int bt) {
  if constexpr (BT % 4 == 0) {
    if (bt == BT && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
#pragma unroll
      for (int k = 0; k < BT; k += 4) {
        const float4* q = reinterpret_cast<const float4*>(src + k);
        const float4 w = GLOBAL ? __ldg(q) : *q;
        dst[k * l] = __fmul_rn(val, w.x);
        dst[(k + 1) * l] = __fmul_rn(val, w.y);
        dst[(k + 2) * l] = __fmul_rn(val, w.z);
        dst[(k + 3) * l] = __fmul_rn(val, w.w);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < BT; ++k) {
    if (k < bt) dst[k * l] = __fmul_rn(val, GLOBAL ? __ldg(src + k) : src[k]);
  }
}

// r's first bt values to the row at p, 16 bytes at a time as mul_row.
template <int BT>
__device__ __forceinline__ void store_row(float* p, int bt,
                                          const float (&r)[BT]) {
  if constexpr (BT % 4 == 0) {
    if (bt == BT && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
#pragma unroll
      for (int k = 0; k < BT; k += 4) {
        *reinterpret_cast<float4*>(p + k) =
            make_float4(r[k], r[k + 1], r[k + 2], r[k + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < BT; ++k) {
    if (k < bt) p[k] = r[k];
  }
}

// Shared-memory layout of spread_partials, in bytes (a resident CTA has
// no x-tile stage and no table ring: cap == stages == 0; only a ring
// instance has stream stages: ring == 2, with ev and ei the bytes of a
// value and an index).
struct Smem {
  size_t stage;    // one x-tile stage: cap tiles of (l, BT) f32
  size_t contrib;  // offset of the (kc, BT, l) f32 product buffer
  size_t ring;     // offset of the two cap-entry table rows
  size_t stream;   // offset of the stream stages
  size_t cols_at;  // offsets, in a stream stage, of its column and row rows
  size_t rows_at;  //   (its value rows start it)
  size_t slots;    // one stream stage: kc rows of each leaf
  size_t bars;     // offset of the stream stages' mbarriers
  size_t total;
};

__host__ __device__ __forceinline__ Smem smem_layout(int l, int bt, int cc,
                                                     int cap, int stages,
                                                     int ring, size_t ev,
                                                     size_t ei) {
  Smem s;
  s.stage = align16((size_t)cap * l * bt * sizeof(float));
  s.contrib = stages * s.stage;
  s.ring = s.contrib + align16((size_t)cc * bt * l * sizeof(float));
  s.stream = s.ring + align16((size_t)2 * cap * sizeof(int));
  s.cols_at = align16((size_t)cc * l * ev);
  s.rows_at = s.cols_at + align16((size_t)cc * l * ei);
  s.slots = ring ? s.rows_at + align16((size_t)cc * l * ei) : 0;
  s.bars = s.stream + ring * s.slots;
  s.total = s.bars + ring * sizeof(uint64_t);
  return s;
}

// Whether a stream with these leaves can come through the bulk-copy ring:
// every row of each leaf a whole number of 16-byte runs, every base
// pointer 16-byte aligned.
template <typename V, typename I>
bool ring_fits(int l, const void* m, const void* cols, const void* row) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return (size_t)l * sizeof(V) % 16 == 0 && (size_t)l * sizeof(I) % 16 == 0 &&
         aligned(m) && aligned(cols) && aligned(row);
}

// cols: the resident gather's columns of x, or the local gather's
// block-local columns (col_loc) with their table seg_blk; a resident
// instance takes seg_blk == nullptr, s_blk == cap == 0.  RING: stream
// stages (0: register prefetch; 2: the bulk-copy ring, resident only, for
// leaves that ring_fits).
template <typename V, typename I, bool QUANT, int BT, Gather G, int STAGES,
          int RING>
__global__ void __launch_bounds__(1024) spread_partials(
    const V* __restrict__ m, const I* __restrict__ cols,
    const I* __restrict__ row, const int* __restrict__ seg_blk,
    const float* __restrict__ scale, const float* __restrict__ x,
    float* __restrict__ part, int t_blk, int l, int c_blk, int s_blk, int b,
    int cc, int cap) {
  constexpr bool LOCAL = G == Gather::kLocal;
  static_assert(LOCAL ? STAGES == 1 || STAGES == 2 : STAGES == 0,
                "one or two x-tile stages for the local gather, none for "
                "the resident one");
  static_assert(RING == 0 || (RING == 2 && !LOCAL),
                "a stream ring of two stages, for the resident gather only");
  constexpr int KC = chunk_cycles<BT>();
  constexpr int NR = RING > 0 ? RING : 1;  // stream stages, as a divisor
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay = smem_layout(l, BT, cc, cap, STAGES, RING, sizeof(V), sizeof(I));
  float* contrib = reinterpret_cast<float*>(smem + lay.contrib);  // [cycle][column][row]
  int* ring = reinterpret_cast<int*>(smem + lay.ring);            // [slot][cap]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);  // [stream stage]
  const int j = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.y * BT;
  const int bt = min(BT, b - b0);
  const int tile_f = l * bt;  // floats of one staged x tile
  const int row_n = min(s_blk, cap);  // table entries kept per row
  const int ta = (int)((long long)t_blk * blockIdx.x / gridDim.x);
  const int tb = (int)((long long)t_blk * (blockIdx.x + 1) / gridDim.x);
  if (ta >= tb) return;
  // one column tile whose rows are 16-byte runs: x tiles copy 16 bytes at a time
  const bool vec = bt == b && tile_f % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int nchunk = (c_blk + cc - 1) / cc;  // chunks per block
  const int units = (tb - ta) * nchunk;      // chunks of this CTA's run

  auto stage_of = [&](int slot) {
    return reinterpret_cast<float*>(smem + (STAGES == 2 ? slot : 0) * lay.stage);
  };
  auto fetch_row = [&](int t, int slot) {
    for (int e = j; e < row_n; e += nt) {
      cp_async4(ring + slot * cap + e, seg_blk + (size_t)t * s_blk + e);
    }
  };
  // Tiles staged for the row in ring slot `slot`: its strictly increasing
  // prefix, at most cap.  Every thread computes the same count; with full
  // warps each warp counts the row's ascents with one ballot (row_n <= 16).
  auto staged = [&](int slot) {
    const int* r = ring + slot * cap;
    if (l % 32 == 0) {
      const int lane = j & 31;
      const bool up = lane >= 1 && lane < row_n && r[lane] > r[lane - 1];
      return __ffs(~__ballot_sync(0xffffffffu, up) & ~1u) - 1;
    }
    int n = 1;
    while (n < row_n && r[n] > r[n - 1]) ++n;
    return n;
  };
  // The n tiles named by ring slot `slot` into the stage of `slot`, as
  // (l, bt) each.
  auto fetch_tiles = [&](int slot, int n) {
    const int* r = ring + slot * cap;
    float* dst = stage_of(slot);
    if (vec) {
      const int per = tile_f / 4;
      for (int e = j; e < n * per; e += nt) {
        const int s = e / per, q = (e - s * per) * 4;
        cp_async16(dst + s * tile_f + q, x + (size_t)r[s] * tile_f + q);
      }
    } else {
      for (int e = j; e < n * tile_f; e += nt) {
        const int s = e / tile_f, q = e - s * tile_f;
        const int rr = q / bt, k = q - rr * bt;
        cp_async4(dst + e, x + ((size_t)r[s] * l + rr) * b + b0 + k);
      }
    }
  };
  // Stream stage u % RING, which holds chunk u of the run (RING > 0).
  auto slots_of = [&](int u) { return smem + lay.stream + (u % NR) * lay.slots; };
  // One thread asks for chunk u's rows of the three leaves.
  auto issue = [&](int u) {
    const int t = ta + u / nchunk, c0 = (u % nchunk) * cc;
    const int ncc = min(cc, c_blk - c0);
    const size_t first = ((size_t)t * c_blk + c0) * l;
    const unsigned nv = ncc * l * sizeof(V), ni = ncc * l * sizeof(I);
    unsigned char* st = slots_of(u);
    uint64_t* bar = bars + u % NR;
    mbar_arrive_expect_tx(bar, nv + 2 * ni);
    bulk_copy_g2s(st, m + first, nv, bar);
    bulk_copy_g2s(st + lay.cols_at, cols + first, ni, bar);
    bulk_copy_g2s(st + lay.rows_at, row + first, ni, bar);
  };

  // This thread's slots of one chunk, and the chunk's block scale.
  V v[KC];
  I cl[KC], rw[KC];
  float s = 1.f;
  auto load_chunk = [&](int t, int c0) {
    const int ncc = min(cc, c_blk - c0);
    const size_t base = ((size_t)t * c_blk + c0) * l + j;
    if (QUANT) s = scale[t];
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      if (i < ncc) {
        v[i] = m[base + (size_t)i * l];
        cl[i] = cols[base + (size_t)i * l];
        rw[i] = row[base + (size_t)i * l];
      }
    }
  };
  // With the ring, chunk u's rows in stream stage u % RING, read where
  // they are used (no copy in registers), once the stage's copies are in.
  const V* sv = nullptr;
  const I* sc = nullptr;
  const I* sr = nullptr;
  auto take_chunk = [&](int u, int t) {
    mbar_wait(bars + u % NR, (u / NR) & 1);
    const unsigned char* st = slots_of(u);
    sv = reinterpret_cast<const V*>(st);
    sc = reinterpret_cast<const I*>(st + lay.cols_at);
    sr = reinterpret_cast<const I*>(st + lay.rows_at);
    if (QUANT) s = scale[t];
  };
  // Slot i of the chunk: value, column, adder row.
  auto slot_v = [&](int i) { return RING > 0 ? sv[i * l + j] : v[i]; };
  auto slot_c = [&](int i) { return static_cast<int>(RING > 0 ? sc[i * l + j] : cl[i]); };
  auto slot_r = [&](int i) { return static_cast<int>(RING > 0 ? sr[i * l + j] : rw[i]); };

  for (int e = j; e < cc * BT * l; e += nt) contrib[e] = 0.f;
  if constexpr (LOCAL) {
    fetch_row(ta, 0);
    cp_async_commit();
    cp_async_wait<0>();
  }
  if (RING > 0 && j == 0) {
    for (int q = 0; q < RING; ++q) mbar_init(bars + q, 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  int n_cur = 0, n_next = 0;
  if (STAGES == 2) {
    n_cur = staged(0);
    fetch_tiles(0, n_cur);
    if (ta + 1 < tb) fetch_row(ta + 1, 1);
    cp_async_commit();
  }
  if constexpr (RING > 0) {
    if (j == 0) {
      for (int u = 0; u < RING && u < units; ++u) issue(u);
    }
  } else {
    load_chunk(ta, 0);
  }

  float acc[BT];
  int t = ta, ci = 0;
  for (int u = 0; t < tb; ++u) {
    const int slot = (t - ta) & 1;
    if (ci == 0) {
      if constexpr (LOCAL) {
        if (STAGES == 1) {
          // the stage is free: block t-1 read its last tile before its last
          // chunk's product barrier
          n_cur = staged(slot);
          fetch_tiles(slot, n_cur);
          if (t + 1 < tb) fetch_row(t + 1, slot ^ 1);
          cp_async_commit();
        }
        cp_async_wait<0>();
        __syncthreads();  // block t's tiles and row t+1 are in; block t-1 is done
        if (STAGES == 2) {
          if (t + 1 < tb) {
            n_next = staged(slot ^ 1);
            fetch_tiles(slot ^ 1, n_next);
            if (t + 2 < tb) fetch_row(t + 2, slot);
          }
          cp_async_commit();
        }
      }
#pragma unroll
      for (int k = 0; k < BT; ++k) acc[k] = 0.f;
    }
    const int c0 = ci * cc;
    const int ncc = min(cc, c_blk - c0);
    if constexpr (RING > 0) take_chunk(u, t);
    const float* tiles = stage_of(slot);
    const int lim = n_cur * l;
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      if (i < ncc) {
        const float val = load_value<QUANT>(slot_v(i), s);
        if (val != 0.f) {
          const int c = slot_c(i);
          float* dst = contrib + (size_t)i * BT * l + slot_r(i);
          if constexpr (!LOCAL) {
            mul_row<BT, true>(dst, l, val, x + (size_t)c * b + b0, bt);
          } else if (c < lim) {
            mul_row<BT, false>(dst, l, val, tiles + c * bt, bt);
          } else {
            const int seg = seg_blk[(size_t)t * s_blk + c / l];
            mul_row<BT, true>(dst, l, val, x + ((size_t)seg * l + c % l) * b + b0, bt);
          }
        }
      }
    }
    const bool last = ci + 1 == nchunk;
    if constexpr (RING == 0) {
      // the next chunk's slots fly through the barrier and the sums
      if (!last || t + 1 < tb) load_chunk(last ? t + 1 : t, last ? 0 : c0 + cc);
    }
    __syncthreads();  // every product of the chunk is in the buffer
    if constexpr (RING > 0) {
      // every thread has read stage u: refill it with chunk u + RING
      if (j == 0 && u + RING < units) {
        fence_proxy_async_shared();
        issue(u + RING);
      }
    }
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      if (i < ncc) {
#pragma unroll
        for (int k = 0; k < BT; ++k) {
          if (k < bt) {
            float* p = contrib + ((size_t)i * BT + k) * l + j;
            acc[k] = __fadd_rn(acc[k], *p);
            *p = 0.f;
          }
        }
      }
    }
    if (last) {
      store_row<BT>(part + ((size_t)t * l + j) * b + b0, bt, acc);
      if (STAGES == 2) n_cur = n_next;
      ci = 0;
      ++t;
      // resident: no block-top barrier, so the next block's first chunk
      // waits here for the cleared buffer
      if (!LOCAL && t < tb) __syncthreads();
    } else {
      ++ci;
      __syncthreads();  // the next chunk writes into the cleared buffer
    }
  }
}

// y[w, j, c] = the stream-order sum of window w's block tiles part[t, j, c]:
// acc = p[t0], then acc = __fadd_rn(acc, p[t]); 0 for a window with no
// block.
template <bool RAGGED>
__global__ void __launch_bounds__(kFoldThreads) spread_fold(
    const float* __restrict__ part, float* __restrict__ y,
    const int* __restrict__ block_starts, int bpw, int num_windows, int l,
    int b) {
  const size_t per_w = (size_t)l * b;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)num_windows * per_w) return;
  const int w = (int)(e / per_w);
  const float* p = part + (e - (size_t)w * per_w);
  const int t0 = RAGGED ? block_starts[w] : w * bpw;
  const int t1 = RAGGED ? block_starts[w + 1] : t0 + bpw;
  float acc = 0.f;
  if (t0 < t1) {
    acc = __ldg(p + (size_t)t0 * per_w);
    int t = t0 + 1;
    for (; t + 8 <= t1; t += 8) {  // eight loads in flight, added in order
      float q[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = __ldg(p + (size_t)(t + i) * per_w);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = __fadd_rn(acc, q[i]);
    }
    for (; t < t1; ++t) acc = __fadd_rn(acc, __ldg(p + (size_t)t * per_w));
  }
  y[e] = acc;
}

// The launch of spread_partials for one stream: chunk height, stage cap,
// stream stages, shared memory, CTAs per SM and grid.
struct Plan {
  int cc, cap, ring, ctas_per_sm, grid_x, grid_y;
  size_t smem;
};

template <typename V, typename I, bool QUANT, int BT, Gather G, int STAGES,
          int RING>
cudaError_t plan_partials(int t_blk, int l, int c_blk, int b, Plan& p) {
  const size_t limit = max_shared_bytes();
  auto bytes = [&](int cc) {
    return smem_layout(l, BT, cc, p.cap, STAGES, RING, sizeof(V), sizeof(I)).total;
  };
  p.ring = RING;
  p.cc = std::min(c_blk, chunk_cycles<BT>());
  p.cap = G == Gather::kResident
              ? 0
              : std::max(1, std::min(kMaxCap, kStageBytes / (l * BT * 4)));
  while (p.cc > 1 && bytes(p.cc) > limit) --p.cc;
  p.smem = bytes(p.cc);
  if (p.smem > limit) return cudaErrorInvalidConfiguration;
  auto kernel = spread_partials<V, I, QUANT, BT, G, STAGES, RING>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.ctas_per_sm, kernel,
                                                      l, p.smem);
  if (err != cudaSuccess) return err;
  if (p.ctas_per_sm < 1) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  p.grid_y = (b + BT - 1) / BT;
  const int fill = (sms * p.ctas_per_sm + p.grid_y - 1) / p.grid_y;
  p.grid_x = std::max(1, std::min(t_blk, fill));
  return cudaSuccess;
}

// Whether spread<..., RING> has a ring instance at this column tile: at
// B > 1 only (see the note, item 5).
template <int BT, int RING>
constexpr bool kRingAt = RING > 0 && BT > 1;

// The plan of the instance that spread<..., RING> runs for these leaves:
// the ring where kRingAt and ring_fits, else the register prefetch.
template <typename V, typename I, bool QUANT, int BT, Gather G, int STAGES,
          int RING>
cudaError_t plan_for(const void* m, const void* cols, const void* row,
                     int t_blk, int l, int c_blk, int b, Plan& p) {
  if constexpr (kRingAt<BT, RING>) {
    if (ring_fits<V, I>(l, m, cols, row)) {
      return plan_partials<V, I, QUANT, BT, G, STAGES, RING>(t_blk, l, c_blk, b, p);
    }
  }
  return plan_partials<V, I, QUANT, BT, G, STAGES, 0>(t_blk, l, c_blk, b, p);
}

template <typename V, typename I, bool QUANT, bool RAGGED, int BT, Gather G,
          int STAGES, int RING>
cudaError_t launch(const void* m, const void* cols, const void* row,
                   const int* seg_blk, const float* scale, const float* x,
                   float* y, float* part, const int* block_starts,
                   int num_windows, int t_blk, int bpw, int l, int c_blk,
                   int s_blk, int b, cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_for<V, I, QUANT, BT, G, STAGES, RING>(
      m, cols, row, t_blk, l, c_blk, b, p);
  if (err != cudaSuccess) return err;
  auto kernel = spread_partials<V, I, QUANT, BT, G, STAGES, 0>;
  if constexpr (kRingAt<BT, RING>) {
    if (p.ring > 0) kernel = spread_partials<V, I, QUANT, BT, G, STAGES, RING>;
  }
  kernel<<<dim3(p.grid_x, p.grid_y), l, p.smem, stream>>>(
      static_cast<const V*>(m), static_cast<const I*>(cols),
      static_cast<const I*>(row), seg_blk, scale, x, part, t_blk, l, c_blk,
      s_blk, b, p.cc, p.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)num_windows * l * b;
  spread_fold<RAGGED>
      <<<(unsigned)((n + kFoldThreads - 1) / kFoldThreads), kFoldThreads, 0,
         stream>>>(part, y, block_starts, bpw, num_windows, l, b);
  return cudaGetLastError();
}

// Padded (RAGGED false: window w owns blocks w*bpw .. (w+1)*bpw) or ragged
// (window w owns blocks block_starts[w] .. block_starts[w+1]) stream of
// t_blk blocks; part is a (t_blk, l, b) f32 scratch, y is (W, l, b).
// seg_blk and s_blk: the local gather's table (nullptr and 0 for the
// resident one).  vdt and idt: the dtype codes of gust::dispatch_dtypes.
// RING: the stream stages of the resident gather at B > 1 where the leaves
// allow them (kRingAt, ring_fits), else 0.
template <bool RAGGED, Gather G, int STAGES, int RING>
cudaError_t spread(const void* m, const void* cols, const void* row,
                   const int* seg_blk, const float* scale, const float* x,
                   float* y, float* part, const int* block_starts, int vdt,
                   int idt, int num_windows, int t_blk, int bpw, int l,
                   int c_blk, int s_blk, int b, void* stream) {
  if (l < 1 || l > 1024 || c_blk < 1 || b < 1 || num_windows < 1 ||
      t_blk < 1 || !part || (vdt == 2) != (scale != nullptr) ||
      (G == Gather::kLocal && (s_blk < 1 || !seg_blk)) ||
      (RAGGED && !block_starts) ||
      (!RAGGED && (bpw < 1 || (long long)bpw * num_windows != t_blk))) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  return gust::dispatch_dtypes(vdt, idt, [&](auto v, auto i, auto q) {
    using V = typename decltype(v)::type;
    using I = typename decltype(i)::type;
    constexpr bool Q = decltype(q)::value;
    if (b == 1) {
      return launch<V, I, Q, RAGGED, 1, G, STAGES, RING>(
          m, cols, row, seg_blk, scale, x, y, part, block_starts,
          num_windows, t_blk, bpw, l, c_blk, s_blk, b, s);
    }
    return launch<V, I, Q, RAGGED, 8, G, STAGES, RING>(
        m, cols, row, seg_blk, scale, x, y, part, block_starts, num_windows,
        t_blk, bpw, l, c_blk, s_blk, b, s);
  });
}

// The launch spread<..., G, STAGES, RING> makes for t_blk blocks of a
// stream with these leaves and dtypes and l, c_blk, b on the current
// device: out[0..6] = CTAs per SM, grid x, grid y, shared bytes per CTA,
// stage cap (tiles; 0 for the resident gather), cycles per chunk, stream
// stages (2: the bulk-copy ring; 0: register prefetch).
template <Gather G, int STAGES, int RING>
cudaError_t spread_plan(const void* m, const void* cols, const void* row,
                        int vdt, int idt, int t_blk, int l, int c_blk, int b,
                        int* out) {
  if (l < 1 || l > 1024 || c_blk < 1 || b < 1 || t_blk < 1 || !out) {
    return cudaErrorInvalidValue;
  }
  return gust::dispatch_dtypes(vdt, idt, [&](auto v, auto i, auto q) {
    using V = typename decltype(v)::type;
    using I = typename decltype(i)::type;
    constexpr bool Q = decltype(q)::value;
    Plan p;
    cudaError_t err =
        b == 1 ? plan_for<V, I, Q, 1, G, STAGES, RING>(m, cols, row, t_blk, l,
                                                       c_blk, b, p)
               : plan_for<V, I, Q, 8, G, STAGES, RING>(m, cols, row, t_blk, l,
                                                       c_blk, b, p);
    if (err == cudaSuccess) {
      const int vals[7] = {p.ctas_per_sm, p.grid_x, p.grid_y, (int)p.smem,
                           p.cap, p.cc, p.ring};
      std::copy(vals, vals + 7, out);
    }
    return err;
  });
}

}  // namespace
