// GUST SpGEMM on Hopper (sm_90a): C = A @ B over A's packed color-block
// stream and B's rows, each output row tile owned by one warp.
//
// Replaces the TPU kernel
//   repro/kernels/gust_spgemm.py::make_gust_spgemm
//
// What it computes.  A's stream (either layout, viewed as the ragged block
// stream: window w owns blocks block_starts[w] .. block_starts[w+1]) holds
// cycles of l slots (value a, ORIGINAL column j, adder row).  Slot
// (a, row, j) of window w adds a * B[j, c] into cell (w, row, c) of the
// (W, l, n_out) f32 result for every entry (c, B[j, c]) of B's row j.  B
// comes in one of two carriers: the condensed planes (row j is k_max
// (value, column) pairs, its real entries first, columns ascending and
// distinct, then padding (0, 0); its length is 1 + the position of its
// last nonzero value), or row offsets (row j is entries ptr[j] ..
// ptr[j+1] of flat value and column arrays, columns ascending and
// distinct).  Every cell is summed in stream order from +0 with _rn
// intrinsics (no FMA contraction), skipping slots with a == 0 and entries
// with b == 0 (a skipped term is +-0 and changes no sum that starts at +0):
// the order of the TPU kernel's one-window-at-a-time accumulate, and of the
// plain version on the CPU.
//
// Design.  The TPU kernel keeps a window's (l, n_out) accumulator in VMEM
// and routes partial rows onto adder rows with one-hot matmuls.  Here the
// order of the sums is the only thing to keep, and it is per cell: cells of
// different adder rows never meet, so whoever walks one adder row's slots
// in stream order may own that row's cells with no barrier and no atomic.
// (The edge colouring, which gives a cycle's real slots distinct rows, is
// what let a whole cycle run at once; it is not needed here.)
//   1. Pre-pass (six small kernels, no host synchronisation): B's row
//      starts and lengths; for each B row and tile of kTileCols output
//      columns the row's first entry in the tile (r_rows * (n_tiles + 1)
//      ints, 1/kTileCols of the output's size); per stream block whether
//      any value's bits are nonzero (a block of padding is read once, 16 bytes at a time,
//      and then skipped) and each adder row's count of real slots and cost
//      (its partial products plus a weight per slot); per window an
//      exclusive scan of the counts over its live blocks; one CTA scans
//      the rows' counts into row offsets and orders the rows heaviest
//      first (by the bit length of their cost); per live block each real
//      slot's (a, j) goes to compact arrays, in stream order within its row
//      (its place in the block from a per-row bit mask of the cycles that
//      hold the row).  Only the real slots go on: 377,508 of the 115 M
//      slots of G's padded stream, and the compact arrays are sized by the
//      caller's count of A's nonzeros, not by the stream.
//   2. Row tiles: units are (row, tile of kTileCols output columns),
//      W*l*ceil(n_out/kTileCols) of them, taken by warps of a persistent
//      grid (sized by the occupancy calculator) from a counter, heaviest
//      rows first; an atomic on the counter orders no sum.  A warp keeps
//      its tile's kTileCols cells in shared memory and takes its row's
//      slots 128 at a time: each lane reads where its slots' B rows enter
//      and leave the tile from the table (no search), then the slots'
//      entries go in order, a round of up to 32 entries of one slot at a
//      time (a B row's columns are distinct, so no two lanes meet), four
//      rounds' loads in flight ahead of the adds.  (Rounds of 32 products
//      of several slots fill more lanes, but lanes that meet on a cell must
//      then be found, __match_any_sync, and added in slot order: slower on
//      the card.  So was staging 32 slots' entries in shared memory, their
//      loads all in flight, ahead of adds from there: the B loads' latency
//      is not what a slot costs.)  The tile is then written to y once,
//      coalesced and streaming: every cell of y is written exactly once, so
//      y is neither zeroed first nor read back.
// A row's tiles walk all its slots each, so a hub row of thousands of
// slots is the longest work: its tiles go first, beside the rest, and the
// cost of a slot, not of a product, sets the kernel's time.
//
// Bound.  Memory: A's stream read once, B's real entries read once (plus
// one 32-byte sector per row to find its end), the (W, l, n_out) output
// written once.  On G (16,384 nodes, l = 256) that is 0.3356 ms ragged and
// 0.7333 ms padded, mostly the 1.07 GB output.  The planes carrier's
// length pre-pass reads the whole value plane, padding included: a cost of
// that carrier, which the SpGEMM path does not use.  The operations (one
// multiply and one add per partial product) are far below the card's rate.

#include "gust_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPrepThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kTileWarps = 4;  // warps per CTA of the row-tile kernel
constexpr int kTileMinCtas = 4;  // CTAs per SM it is built for: up to 128 registers
constexpr int kBuckets = 65;   // cost bit lengths 0..64
constexpr int kSlotWeight = 32;  // a slot's own cost in a unit, in partial products
// Output columns of a warp's tile; spgemm_sweep.py times 512 and 2048
// beside it (its tile_ variants).
constexpr int kTileCols = 1024;
constexpr size_t kTileSmem = (size_t)kTileWarps * kTileCols * sizeof(float);

// The window that owns stream block t: the last w with block_starts[w] <= t.
__device__ __forceinline__ int window_of(const int* __restrict__ block_starts,
                                         int num_windows, int t) {
  int lo = 0, n = num_windows + 1;  // first index with block_starts > t
  while (n > 0) {
    const int half = n >> 1;
    if (block_starts[lo + half] <= t) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo - 1;
}

// First position in cols[0, n) whose column is >= v (cols ascending).
__device__ __forceinline__ int lower_bound(const int* __restrict__ cols, int n,
                                           int v) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (__ldg(cols + lo + half) < v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// Scratch of one call, carved from the wrapper's workspace.
struct Work {
  unsigned long long* cost;     // (W*l,) partial products + slot weights
  unsigned long long* counter;  // (1,) next unit of the row-tile kernel
  long long* b_start;           // (r_rows,) first entry of B's row
  int* b_len;                   // (r_rows,) entries of B's row
  int* b_tile;                  // (r_rows, n_tiles + 1) B row's first entry in tile t
  unsigned char* live;          // (T_blk,) 1 where a block may hold a real slot
  int* cnt;                     // (T_blk, l) per-block counts, then bases
  int* total;                   // (W*l,) real slots per row
  long long* row_ptr;           // (W*l + 1,) row offsets into a_c / j_c
  int* order;                   // (W*l,) rows, heaviest first
  float* a_c;                   // (slots,) compact A values, slots >= real slots
  int* j_c;                     // (slots,) compact A columns
  size_t zeroed;                // bytes from the start that start at 0
  size_t bytes;
};

Work carve(char* base, int num_windows, int l, long long rows, int c_blk,
           int r_rows, int n_tiles, long long slots) {
  Work w{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off = gust::align16(off + bytes);
    return p;
  };
  const size_t wl = (size_t)num_windows * l;
  w.cost = reinterpret_cast<unsigned long long*>(take(wl * 8));
  w.counter = reinterpret_cast<unsigned long long*>(take(8));
  w.zeroed = off;
  w.b_start = reinterpret_cast<long long*>(take((size_t)r_rows * 8));
  w.b_len = reinterpret_cast<int*>(take((size_t)r_rows * 4));
  w.b_tile = reinterpret_cast<int*>(take((size_t)r_rows * (n_tiles + 1) * 4));
  w.live = reinterpret_cast<unsigned char*>(take((size_t)(rows / c_blk)));
  w.cnt = reinterpret_cast<int*>(take((size_t)(rows / c_blk) * l * 4));
  w.total = reinterpret_cast<int*>(take(wl * 4));
  w.row_ptr = reinterpret_cast<long long*>(take((wl + 1) * 8));
  w.order = reinterpret_cast<int*>(take(wl * 4));
  w.a_c = reinterpret_cast<float*>(take((size_t)slots * 4));
  w.j_c = reinterpret_cast<int*>(take((size_t)slots * 4));
  w.bytes = off;
  return w;
}

// B's row starts and lengths, one warp per row.  Planes (b_ptr null): start
// j * k_max, length 1 + the position of the row's last nonzero value.
// Offsets: ptr[j] and ptr[j+1] - ptr[j].
__global__ void __launch_bounds__(kPrepThreads)
    b_rows_kernel(const float* __restrict__ b_vals,
                  const long long* __restrict__ b_ptr, int r_rows, int k_max,
                  long long* __restrict__ b_start, int* __restrict__ b_len) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= r_rows) return;  // the whole warp
  if (b_ptr != nullptr) {
    if (lane == 0) {
      b_start[r] = b_ptr[r];
      b_len[r] = static_cast<int>(b_ptr[r + 1] - b_ptr[r]);
    }
    return;
  }
  const float* row = b_vals + (size_t)r * k_max;
  int last = -1;
  for (int k = lane; k < k_max; k += 32) {
    if (row[k] != 0.f) last = k;
  }
  for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(kFull, last, o));
  if (lane == 0) {
    b_start[r] = (long long)r * k_max;
    b_len[r] = last + 1;
  }
}

// B's row j, tile t: the first entry of the row at a column >= t * kTileCols
// (the row's length for t = n_tiles), one thread per (j, t), by binary
// search: the row tiles then find a slot's entries in their tile with two
// loads and no search.
__global__ void __launch_bounds__(kPrepThreads)
    b_tiles_kernel(const int* __restrict__ b_cols, const long long* __restrict__ b_start,
                   const int* __restrict__ b_len, int r_rows, int n_tiles,
                   int* __restrict__ b_tile) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)r_rows * (n_tiles + 1)) return;
  const int j = static_cast<int>(i / (n_tiles + 1));
  const int t = static_cast<int>(i - (long long)j * (n_tiles + 1));
  b_tile[i] = t == n_tiles ? b_len[j]
                           : lower_bound(b_cols + b_start[j], b_len[j], t * kTileCols);
}

// Per stream block t: live[t] = 0 when every value's bits are 0 (then
// the block holds no real slot, and cnt[t, :] is left unwritten: nothing
// reads it), else 1, the real slots of each adder row (cnt[t, r]), and
// each row's cost added into cost[w*l + r].  The bits are read 16 bytes at
// a time where the block is whole 16-byte runs.
template <typename V, typename I>
__global__ void __launch_bounds__(kPrepThreads)
    slot_count_kernel(const V* __restrict__ m, const I* __restrict__ col,
                      const I* __restrict__ row,
                      const int* __restrict__ block_starts, int num_windows,
                      int l, int c_blk, const int* __restrict__ b_len,
                      unsigned char* __restrict__ live, int* __restrict__ cnt,
                      unsigned long long* cost) {
  __shared__ int cnt_s[1024];
  __shared__ unsigned long long cost_s[1024];
  const int t = blockIdx.x;
  const size_t block_vals = (size_t)c_blk * l;
  const V* blk = m + (size_t)t * block_vals;
  bool any = false;
  if (block_vals * sizeof(V) % 16 == 0 && reinterpret_cast<uintptr_t>(blk) % 16 == 0) {
    const int4* q = reinterpret_cast<const int4*>(blk);
    for (size_t i = threadIdx.x; i < block_vals * sizeof(V) / 16; i += blockDim.x) {
      const int4 v = __ldg(q + i);
      any |= (v.x | v.y | v.z | v.w) != 0;
    }
  } else {
    for (size_t i = threadIdx.x; i < block_vals; i += blockDim.x) {
      any |= gust::to_f32(blk[i]) != 0.f;
    }
  }
  if (!__syncthreads_or(any)) {
    if (threadIdx.x == 0) live[t] = 0;
    return;
  }
  if (threadIdx.x == 0) live[t] = 1;
  for (int r = threadIdx.x; r < l; r += blockDim.x) {
    cnt_s[r] = 0;
    cost_s[r] = 0;
  }
  __syncthreads();
  const size_t base = (size_t)t * c_blk * l;
  for (int k = 0; k < c_blk; ++k) {
    for (int i = threadIdx.x; i < l; i += blockDim.x) {
      const size_t g = base + (size_t)k * l + i;
      if (gust::to_f32(m[g]) != 0.f) {
        const int r = static_cast<int>(row[g]);
        atomicAdd(&cnt_s[r], 1);
        atomicAdd(&cost_s[r], (unsigned long long)(b_len[static_cast<int>(col[g])] +
                                                   kSlotWeight));
      }
    }
  }
  __syncthreads();
  const size_t wl = (size_t)window_of(block_starts, num_windows, t) * l;
  for (int r = threadIdx.x; r < l; r += blockDim.x) {
    cnt[(size_t)t * l + r] = cnt_s[r];
    if (cost_s[r] != 0) atomicAdd(&cost[wl + r], cost_s[r]);
  }
}

// Per window: each row's counts become exclusive prefixes over the
// window's live blocks, and the row's total goes to total[w*l + r].
__global__ void __launch_bounds__(kPrepThreads)
    row_scan_kernel(const int* __restrict__ block_starts, int l,
                    const unsigned char* __restrict__ live,
                    int* __restrict__ cnt, int* __restrict__ total) {
  const int w = blockIdx.x;
  const int t0 = block_starts[w], t1 = block_starts[w + 1];
  for (int r = threadIdx.x; r < l; r += blockDim.x) {
    int run = 0;
    int t = t0;
    for (; t + 4 <= t1; t += 4) {  // four independent loads in flight
      int* c = cnt + (size_t)t * l + r;
      const bool l0 = live[t], l1 = live[t + 1], l2 = live[t + 2], l3 = live[t + 3];
      const int c0 = l0 ? c[0] : 0, c1 = l1 ? c[l] : 0;
      const int c2 = l2 ? c[2 * l] : 0, c3 = l3 ? c[3 * l] : 0;
      if (l0) c[0] = run;
      if (l1) c[l] = run + c0;
      if (l2) c[2 * l] = run + c0 + c1;
      if (l3) c[3 * l] = run + c0 + c1 + c2;
      run += c0 + c1 + c2 + c3;
    }
    for (; t < t1; ++t) {
      if (!live[t]) continue;
      int* c = cnt + (size_t)t * l + r;
      const int v = *c;
      *c = run;
      run += v;
    }
    total[(size_t)w * l + r] = run;
  }
}

// Inclusive scan of v over the CTA (kScanThreads threads), and the CTA's
// sum in *sum; warp_s holds kScanThreads / 32 entries.
__device__ __forceinline__ long long cta_scan(long long v, long long* warp_s,
                                              long long* sum) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long s = warp_s[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += u;
    }
    warp_s[lane] = s;
  }
  __syncthreads();
  const long long out = v + (warp ? warp_s[warp - 1] : 0);
  *sum = warp_s[kScanThreads / 32 - 1];
  __syncthreads();  // warp_s is reused by the next call
  return out;
}

// One CTA: row_ptr = exclusive scan of the rows' totals, and the rows in
// order of their cost's bit length, longest first (ties in no set order:
// the order of the units changes no result).
__global__ void __launch_bounds__(kScanThreads)
    row_index_kernel(const int* __restrict__ total,
                     const unsigned long long* __restrict__ cost, int rows,
                     long long* __restrict__ row_ptr, int* __restrict__ order) {
  __shared__ long long warp_s[kScanThreads / 32];
  __shared__ int bucket_s[kBuckets];
  long long carry = 0;
  for (int i0 = 0; i0 < rows; i0 += kScanThreads) {
    const int i = i0 + threadIdx.x;
    const long long v = i < rows ? total[i] : 0;
    long long sum;
    const long long incl = cta_scan(v, warp_s, &sum);
    if (i < rows) row_ptr[i] = carry + incl - v;
    carry += sum;
  }
  if (threadIdx.x == 0) row_ptr[rows] = carry;
  for (int b = threadIdx.x; b < kBuckets; b += blockDim.x) bucket_s[b] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    atomicAdd(&bucket_s[64 - __clzll(static_cast<long long>(cost[i]))], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // bucket starts, longest bit length first
    int at = 0;
    for (int b = kBuckets - 1; b >= 0; --b) {
      const int c = bucket_s[b];
      bucket_s[b] = at;
      at += c;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int b = 64 - __clzll(static_cast<long long>(cost[i]));
    order[atomicAdd(&bucket_s[b], 1)] = i;
  }
}

// Per stream block t: each real slot's (a, j) to its place in the compact
// arrays: its row's offset, plus the row's slots in earlier blocks of the
// window (cnt, scanned), plus those in earlier cycles of the block.  A
// place at or past `slots` (a caller's count too small) is not written.
template <typename V, typename I>
__global__ void __launch_bounds__(kPrepThreads)
    slot_scatter_kernel(const V* __restrict__ m, const I* __restrict__ col,
                        const I* __restrict__ row,
                        const int* __restrict__ block_starts, int num_windows,
                        int l, int c_blk, const unsigned char* __restrict__ live,
                        const int* __restrict__ cnt,
                        const long long* __restrict__ row_ptr, long long slots,
                        float* __restrict__ a_c, int* __restrict__ j_c) {
  __shared__ unsigned mask_s[1024];  // cycles of this sub-block holding row r
  __shared__ long long at_s[1024];   // next place of row r's slots
  const int t = blockIdx.x;
  if (!live[t]) return;  // the whole CTA: no real slot
  const size_t wl = (size_t)window_of(block_starts, num_windows, t) * l;
  for (int r = threadIdx.x; r < l; r += blockDim.x) {
    at_s[r] = row_ptr[wl + r] + cnt[(size_t)t * l + r];
  }
  const size_t base = (size_t)t * c_blk * l;
  for (int k0 = 0; k0 < c_blk; k0 += 32) {  // sub-blocks of up to 32 cycles
    const int nk = min(32, c_blk - k0);
    for (int r = threadIdx.x; r < l; r += blockDim.x) mask_s[r] = 0;
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      for (int i = threadIdx.x; i < l; i += blockDim.x) {
        const size_t g = base + (size_t)(k0 + k) * l + i;
        if (gust::to_f32(m[g]) != 0.f) atomicOr(&mask_s[static_cast<int>(row[g])], 1u << k);
      }
    }
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      for (int i = threadIdx.x; i < l; i += blockDim.x) {
        const size_t g = base + (size_t)(k0 + k) * l + i;
        const float a = gust::to_f32(m[g]);
        if (a != 0.f) {
          const int r = static_cast<int>(row[g]);
          const long long at = at_s[r] + __popc(mask_s[r] & ((1u << k) - 1u));
          if (at < slots) {
            a_c[at] = a;
            j_c[at] = static_cast<int>(col[g]);
          }
        }
      }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < l; r += blockDim.x) at_s[r] += __popc(mask_s[r]);
    __syncthreads();
  }
}

// A round: the slot's value and, per lane, B's value (0: nothing to add)
// and column; live is false past the last round.
struct Round {
  bool live;
  float a, b;
  int col;
};

template <typename T>
__device__ __forceinline__ T pick(int g, T v0, T v1, T v2, T v3) {
  return g == 0 ? v0 : g == 1 ? v1 : g == 2 ? v2 : v3;
}

// The slot rounds of 128 slots: four groups of 32, lane k of group g
// holding a slot's value (a_g), the first of its B row's entries in the
// tile (f_g) and their count (n_g), walked in slot order.  Every field but
// the per-lane slot values is the same in all lanes.
struct SlotRounds {
  float a0, a1, a2, a3;
  long long f0, f1, f2, f3;
  int n0, n1, n2, n3;
  const float* __restrict__ b_vals;
  const int* __restrict__ b_cols;
  int g = 0;             // the group being walked (4: all done)
  unsigned left = 0;     // its lanes whose slots are still to come
  float ak = 0.f;        // the slot being walked: value,
  long long fk = 0;      // first entry,
  int nk = 0, done = 0;  // entries, and entries taken so far
  bool started = false;

  __device__ __forceinline__ Round next() {
    const int lane = threadIdx.x % 32;
    if (!started) {
      started = true;
      left = __ballot_sync(kFull, n0 > 0);
    }
    while (done >= nk) {
      while (!left) {  // past the last group, every call gives a dead round
        if (g >= 3) {
          g = 4;
          return Round{false, 0.f, 0.f, 0};
        }
        ++g;
        left = __ballot_sync(kFull, pick(g, n0, n1, n2, n3) > 0);
      }
      const int k = __ffs(left) - 1;
      left &= left - 1;
      ak = __shfl_sync(kFull, pick(g, a0, a1, a2, a3), k);
      fk = __shfl_sync(kFull, pick(g, f0, f1, f2, f3), k);
      nk = __shfl_sync(kFull, pick(g, n0, n1, n2, n3), k);
      done = 0;
    }
    const int i = done + lane;
    Round r{true, ak, i < nk ? __ldg(b_vals + fk + i) : 0.f,
            i < nk ? __ldg(b_cols + fk + i) : 0};
    done += 32;
    return r;
  }
};

// Add a slot round (its lanes hold distinct columns).
__device__ __forceinline__ void add_slot_round(const Round& r, int c0, float* acc) {
  if (r.b != 0.f) acc[r.col - c0] = __fadd_rn(acc[r.col - c0], __fmul_rn(r.a, r.b));
  __syncwarp();  // the next round reads what this one wrote
}

// Every slot round of q, the loads of four rounds in flight ahead of the
// adds.
__device__ __forceinline__ void slot_products(SlotRounds& q, int c0, float* acc) {
  Round r0 = q.next(), r1 = q.next(), r2 = q.next(), r3 = q.next();
  while (r0.live) {
    add_slot_round(r0, c0, acc);
    r0 = q.next();
    if (!r1.live) break;
    add_slot_round(r1, c0, acc);
    r1 = q.next();
    if (!r2.live) break;
    add_slot_round(r2, c0, acc);
    r2 = q.next();
    if (!r3.live) break;
    add_slot_round(r3, c0, acc);
    r3 = q.next();
  }
}


// The row tiles: one warp per unit (row, tile of kTileCols columns) at a
// time.
// A unit takes its row's slots 4 * 32 at a time: the lanes load their four
// slots, and for each the start of its B row and the row's entries in the
// tile (two loads of B's tile table), all independent; then, in slot
// order, the products go in rounds of 32 (slot_products).
// stats (nullable): per CTA, its longest unit, its longest slot-loading
// phase of a unit and its longest product phase of a unit, in clock64
// cycles (three int64 a CTA).  Slots at or past `slots` are not read.
__global__ void __launch_bounds__(kTileWarps * 32, kTileMinCtas)
    row_tiles_kernel(const float* __restrict__ a_c, const int* __restrict__ j_c,
                     const long long* __restrict__ row_ptr,
                     const int* __restrict__ order,
                     const long long* __restrict__ b_start,
                     const int* __restrict__ b_tile,
                     const float* __restrict__ b_vals,
                     const int* __restrict__ b_cols, float* __restrict__ y,
                     int rows, int n_out, int n_tiles, long long slots,
                     unsigned long long* counter, unsigned long long* stats) {
  extern __shared__ float4 tiles_s[];
  const int lane = threadIdx.x % 32;
  float* acc = reinterpret_cast<float*>(tiles_s) + (threadIdx.x / 32) * kTileCols;
  const unsigned long long units = (unsigned long long)rows * n_tiles;
  const bool vec = (n_out & 3) == 0;  // tiles start on 16-byte boundaries
  unsigned long long longest = 0, longest_slots = 0, longest_products = 0;
  for (;;) {
    unsigned long long u = 0;
    if (lane == 0) u = atomicAdd(counter, 1ull);
    u = __shfl_sync(kFull, u, 0);
    if (u >= units) break;
    const long long t_begin = clock64();
    const int ri = static_cast<int>(u / n_tiles);
    const int tile = static_cast<int>(u - (unsigned long long)ri * n_tiles);
    const int c0 = tile * kTileCols;
    const int row = order[ri];
    const int width = min(kTileCols, n_out - c0);
    const long long s_begin = min(row_ptr[row], slots);
    const long long s_end = min(row_ptr[row + 1], slots);
    float* out = y + (size_t)row * n_out + c0;
    if (s_begin == s_end) {  // no slot: a tile of zeros
      if (vec) {
        for (int i = lane; i < width / 4; i += 32) {
          __stcs(reinterpret_cast<float4*>(out) + i, make_float4(0.f, 0.f, 0.f, 0.f));
        }
      } else {
        for (int i = lane; i < width; i += 32) __stcs(out + i, 0.f);
      }
      continue;
    }
    for (int i = lane; i < kTileCols / 4; i += 32) {
      reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();
    long long loading = 0;
    for (long long s0 = s_begin; s0 < s_end; s0 += 128) {
      const long long t_load = clock64();
      const long long s1 = s0 + lane, s2 = s1 + 32, s3 = s1 + 64, s4 = s1 + 96;
      const int j1 = s1 < s_end ? j_c[s1] : -1, j2 = s2 < s_end ? j_c[s2] : -1;
      const int j3 = s3 < s_end ? j_c[s3] : -1, j4 = s4 < s_end ? j_c[s4] : -1;
      const float a1 = j1 >= 0 ? a_c[s1] : 0.f, a2 = j2 >= 0 ? a_c[s2] : 0.f;
      const float a3 = j3 >= 0 ? a_c[s3] : 0.f, a4 = j4 >= 0 ? a_c[s4] : 0.f;
      const int* t1 = b_tile + (size_t)max(j1, 0) * (n_tiles + 1) + tile;
      const int* t2 = b_tile + (size_t)max(j2, 0) * (n_tiles + 1) + tile;
      const int* t3 = b_tile + (size_t)max(j3, 0) * (n_tiles + 1) + tile;
      const int* t4 = b_tile + (size_t)max(j4, 0) * (n_tiles + 1) + tile;
      const int lo1 = j1 >= 0 ? t1[0] : 0, n1 = j1 >= 0 ? t1[1] - lo1 : 0;
      const int lo2 = j2 >= 0 ? t2[0] : 0, n2 = j2 >= 0 ? t2[1] - lo2 : 0;
      const int lo3 = j3 >= 0 ? t3[0] : 0, n3 = j3 >= 0 ? t3[1] - lo3 : 0;
      const int lo4 = j4 >= 0 ? t4[0] : 0, n4 = j4 >= 0 ? t4[1] - lo4 : 0;
      const long long f1 = j1 >= 0 ? b_start[j1] + lo1 : 0;
      const long long f2 = j2 >= 0 ? b_start[j2] + lo2 : 0;
      const long long f3 = j3 >= 0 ? b_start[j3] + lo3 : 0;
      const long long f4 = j4 >= 0 ? b_start[j4] + lo4 : 0;
      loading += clock64() - t_load;
      SlotRounds q{a1, a2, a3, a4, f1, f2, f3, f4, n1, n2, n3, n4, b_vals, b_cols};
      slot_products(q, c0, acc);
    }
    if (vec) {
      for (int i = lane; i < width / 4; i += 32) {
        __stcs(reinterpret_cast<float4*>(out) + i, reinterpret_cast<const float4*>(acc)[i]);
      }
    } else {
      for (int i = lane; i < width; i += 32) __stcs(out + i, acc[i]);
    }
    __syncwarp();  // the next unit zeroes acc
    const unsigned long long took = clock64() - t_begin;
    longest = max(longest, took);
    longest_slots = max(longest_slots, (unsigned long long)loading);
    longest_products = max(longest_products, took - loading);
  }
  if (stats != nullptr && lane == 0) {
    unsigned long long* mine = stats + 3 * blockIdx.x;
    atomicMax(mine, longest);
    atomicMax(mine + 1, longest_slots);
    atomicMax(mine + 2, longest_products);
  }
}

// The row-tile kernel's launch on the current device: CTAs per SM (from
// the occupancy calculator) and the grid, that many a SM.
cudaError_t tiles_plan(int* ctas_per_sm, int* grid) {
  cudaError_t err = gust::allow_smem(row_tiles_kernel, kTileSmem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, row_tiles_kernel,
                                                      kTileWarps * 32, kTileSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess) {
    return err;
  }
  *grid = *ctas_per_sm * sms;
  return *grid > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

struct Args {
  const void *m, *col, *row;
  const int* block_starts;
  const float* b_vals;
  const int* b_cols;
  const long long* b_ptr;
  void* work;
  float* y;
  unsigned long long* stats;
  int num_windows, l, c_blk, rows, r_rows, k_max, n_out;
  long long slots;
};

template <typename V, typename I>
cudaError_t run(const Args& a, cudaStream_t s) {
  const int n_tiles = (a.n_out + kTileCols - 1) / kTileCols;
  const Work w = carve(static_cast<char*>(a.work), a.num_windows, a.l, a.rows,
                       a.c_blk, a.r_rows, n_tiles, a.slots);
  const int t_blk = a.rows / a.c_blk;
  const int wl = a.num_windows * a.l;
  cudaError_t err = cudaMemsetAsync(a.work, 0, w.zeroed, s);
  if (err != cudaSuccess) return err;
  const int warps_per_cta = kPrepThreads / 32;
  b_rows_kernel<<<(a.r_rows + warps_per_cta - 1) / warps_per_cta, kPrepThreads, 0, s>>>(
      a.b_vals, a.b_ptr, a.r_rows, a.k_max, w.b_start, w.b_len);
  const long long bounds = (long long)a.r_rows * (n_tiles + 1);
  b_tiles_kernel<<<static_cast<unsigned>((bounds + kPrepThreads - 1) / kPrepThreads),
                   kPrepThreads, 0, s>>>(a.b_cols, w.b_start, w.b_len, a.r_rows,
                                         n_tiles, w.b_tile);
  const V* m = static_cast<const V*>(a.m);
  const I* col = static_cast<const I*>(a.col);
  const I* row = static_cast<const I*>(a.row);
  slot_count_kernel<V, I><<<t_blk, kPrepThreads, 0, s>>>(
      m, col, row, a.block_starts, a.num_windows, a.l, a.c_blk, w.b_len, w.live, w.cnt,
      w.cost);
  row_scan_kernel<<<a.num_windows, kPrepThreads, 0, s>>>(a.block_starts, a.l, w.live,
                                                          w.cnt, w.total);
  row_index_kernel<<<1, kScanThreads, 0, s>>>(w.total, w.cost, wl, w.row_ptr, w.order);
  slot_scatter_kernel<V, I><<<t_blk, kPrepThreads, 0, s>>>(
      m, col, row, a.block_starts, a.num_windows, a.l, a.c_blk, w.live, w.cnt,
      w.row_ptr, a.slots, w.a_c, w.j_c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  int ctas_per_sm = 0, grid = 0;
  if ((err = tiles_plan(&ctas_per_sm, &grid)) != cudaSuccess) return err;
  if (a.stats != nullptr &&
      (err = cudaMemsetAsync(a.stats, 0, 3 * sizeof(unsigned long long) * grid, s)) !=
          cudaSuccess) {
    return err;
  }
  row_tiles_kernel<<<grid, kTileWarps * 32, kTileSmem, s>>>(
      w.a_c, w.j_c, w.row_ptr, w.order, w.b_start, w.b_tile, a.b_vals, a.b_cols, a.y, wl,
      a.n_out, n_tiles, a.slots, w.counter, a.stats);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace gust_spgemm takes for a stream of `rows` rows
// (T_blk * c_blk) of l slots over W windows, r_rows rows of B, n_out
// output columns and room for `slots` real slots of A.
int gust_spgemm_workspace(int num_windows, int l, int c_blk, long long rows,
                          int r_rows, int n_out, long long slots, long long* bytes) {
  if (num_windows < 1 || l < 1 || c_blk < 1 || rows < 0 || r_rows < 1 || n_out < 1 ||
      slots < 0) {
    return cudaErrorInvalidValue;
  }
  const int n_tiles = (n_out + kTileCols - 1) / kTileCols;
  *bytes = static_cast<long long>(
      carve(nullptr, num_windows, l, rows, c_blk, r_rows, n_tiles, slots).bytes);
  return cudaSuccess;
}

// The row-tile kernel's launch on the current device: out = {CTAs per SM,
// grid, shared bytes per CTA, warps per CTA, output columns of a tile}.
int gust_spgemm_plan(int* out) {
  out[2] = static_cast<int>(kTileSmem);
  out[3] = kTileWarps;
  out[4] = kTileCols;
  return tiles_plan(&out[0], &out[1]);
}

// A's stream m/col/row (rows, l): vdt 0 float32, 1 bfloat16; idt 0 int32,
// 1 int16.  B: b_ptr null -> planes b_vals/b_cols (r_rows, k_max) f32 /
// int32; else b_ptr (r_rows + 1,) int64 offsets into flat b_vals/b_cols.
// work: gust_spgemm_workspace bytes for `slots`, at least the count of
// A's nonzero values (those past it are dropped); y (num_windows, l,
// n_out) f32, every cell written; stats (nullable): three int64 for each CTA of the row-tile
// kernel's grid (gust_spgemm_plan), its longest unit, unit slot-loading
// phase and unit product phase in cycles.
int gust_spgemm(const void* m, const void* col, const void* row,
                const int* block_starts, const float* b_vals,
                const int* b_cols, const long long* b_ptr, void* work,
                float* y, long long* stats, int vdt, int idt, int num_windows,
                int l, int c_blk, int rows, int r_rows, int k_max, int n_out,
                long long slots, void* stream) {
  if (l < 1 || l > 1024 || c_blk < 1 || num_windows < 1 || r_rows < 1 ||
      rows < c_blk || rows % c_blk || n_out < 1 || slots < 0 ||
      (b_ptr == nullptr && k_max < 1) ||
      (long long)num_windows * l >= 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const Args a{m, col, row, block_starts, b_vals, b_cols, b_ptr, work, y,
               reinterpret_cast<unsigned long long*>(stats), num_windows, l,
               c_blk, rows, r_rows, k_max, n_out, slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using gust::Type;
  auto go = [&](auto v, auto i) {
    return run<typename decltype(v)::type, typename decltype(i)::type>(a, s);
  };
  if (vdt == 0 && idt == 0) return go(Type<float>{}, Type<int32_t>{});
  if (vdt == 0 && idt == 1) return go(Type<float>{}, Type<int16_t>{});
  if (vdt == 1 && idt == 0) return go(Type<__nv_bfloat16>{}, Type<int32_t>{});
  if (vdt == 1 && idt == 1) return go(Type<__nv_bfloat16>{}, Type<int16_t>{});
  return cudaErrorInvalidValue;
}

const char* gust_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
