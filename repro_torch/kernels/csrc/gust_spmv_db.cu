// Double-buffered GUST SpMV on Hopper (sm_90a): y = M @ x over a packed
// color-block stream, one CTA per output window, the stream or the x tiles
// copied into shared memory by cp.async while the previous unit computes.
//
// Replaces the TPU kernels
//   repro/kernels/gust_spmv.py::make_gust_spmv_db                    (padded, resident x)
//   repro/kernels/gust_spmv.py::make_gust_spmv_local_db              (padded, segment-local x)
//   repro/kernels/gust_spmv_ragged.py::make_gust_spmv_ragged_db      (ragged, resident x)
//   repro/kernels/gust_spmv_ragged.py::make_gust_spmv_ragged_local_db (ragged, segment-local x)
// with their f32/bf16 bodies and their int8 bodies (_q: value = float(q) *
// scale_blk[t], scales on pack-time blocks).
//
// What they compute is what gust_spmv.cu computes (see its note): each
// cycle of a (c_blk, l) block gives lane j one slot (value m, column, adder
// row), which adds m * x[col, :] into its window's (l, B) output tile.  The
// design is gust_spmv.cu's, so the same bits come out: one CTA per window
// walking the window's blocks in stream order, one thread per lane, a
// shared-memory block tile with a barrier per cycle, the window accumulator
// in registers (initialised from the window's first block), products and
// sums rounded with the _rn intrinsics (no FMA contraction), and slots whose
// value is 0 skipped (padding slots share row 0 with real slots).  So on one
// artifact, for finite x: these kernels equal gust_spmv_padded /
// gust_spmv_ragged bitwise (single == double, resident == local), and the
// padded and ragged kernels equal each other.
//
// Resident kernels (gust_spmv_db_*).  The unit of the pipeline is a chunk of
// up to kChunk cycles of one block.  Its (m, col, row) rows are one
// contiguous run of each leaf; the CTA copies the run of chunk u+1 into one
// of two shared-memory stages with cp.async (16-byte copies where source
// and length allow, 4-byte copies, or plain loads at a misaligned edge:
// int8/int16/bf16 leaves at odd l) while chunk u computes out of the other.
// A chunk is 8 cycles at B=1 and GUST_DB_WIDE_CHUNK (4) when B > 1.
// x is read straight from device memory (it stays in the 50 MB L2).  At B=1
// each thread starts the x loads of the whole chunk before its first add.
//
// Segment-local kernels (gust_spmv_local_db_*).  Block t reads x only
// through its segment table: the slot at local address col_loc takes
// x[seg_blk[t, col_loc / l] * l + col_loc % l].  The CTA streams the x
// tiles x[seg * l : (seg + 1) * l, :] of the block through a ring of
// shared-memory slots (4, or 2 where shared memory is short), cp.async
// keeping up to ring-1 tiles in flight, across block boundaries, while it
// picks its slots' values out of the tile that has arrived into a
// per-thread gather buffer.  When the block's last tile is in, the cycles
// run as in the resident kernel out of that buffer.  seg_blk rows hold the
// block's distinct segments strictly increasing, then padding with
// segment 0, which no slot references: the kernel counts the strictly
// increasing prefix (one barrier-count per block) and copies only those
// tiles, where the TPU kernel walks all S_blk.  A slot whose local segment
// lies past that prefix (a table from elsewhere, out of that order) reads
// its value straight from x, so the result never rests on the order; it
// only costs time.  Shared memory is sized from l, B and the chunk height,
// never from S_blk.
//
// Bound.  Memory: each stream slot read once (value + column + row bytes),
// the scales and x once, y written once; the local kernels read col_loc in
// place of the columns, plus the referenced prefix of each seg_blk row.  (Their
// x-tile copies re-read x from L2, a block's tiles at a time.)
// One multiply and one add per slot and vector column is far below the
// card's rate.  As in gust_spmv.cu, the per-cycle barrier with about two
// CTAs of 256 threads per SM keeps this first version latency-bound.  The
// local kernels add, per block, a dependent seg_blk load before each tile
// copy and two barrier-counted reads of the seg_blk row: on the H100 they
// take about 3.5x the resident kernel on the same artifact (PERF.md); a
// deeper ring did not help, staging the row ahead should.

#include <algorithm>

#include "gust_common.cuh"

// Most cycles in one pipeline unit of the resident kernels when B > 1: a
// build-time constant so that it can be swept
// (python -m repro_torch.kernels.chunk_sweep).  On the H100 at B=8 an
// 8-cycle f32 unit (56 KB of shared memory per CTA) ran 35% slower than
// kernel 1, 4 cycles (32 KB) about 5% slower, 2 and 1 slower again
// (PERF.md).
#ifndef GUST_DB_WIDE_CHUNK
#define GUST_DB_WIDE_CHUNK 4
#endif

namespace {

using gust::load_value;
using gust::referenced_tiles;

constexpr int kChunk = 8;  // most cycles in one pipeline unit
constexpr int kWideChunk = GUST_DB_WIDE_CHUNK;
static_assert(kWideChunk >= 1 && kWideChunk <= kChunk, "GUST_DB_WIDE_CHUNK");
constexpr int kSmemDefault = 48 * 1024;  // above this, opt in per kernel

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy n bytes from device memory at src into shared memory at dst (16-byte
// aligned) with all threads of the CTA: 16-byte cp.async where the source
// and the length allow it, else 4-byte cp.async, else plain byte loads.
// Every thread must call it with the same arguments.
__device__ __forceinline__ void copy_to_shared(void* dst, const void* src,
                                               size_t n) {
  const size_t tid = threadIdx.x, nt = blockDim.x;
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if (a % 16 == 0 && n % 16 == 0) {
    for (size_t i = tid * 16; i < n; i += nt * 16) cp_async16(d + i, s + i);
  } else if (a % 4 == 0 && n % 4 == 0) {
    for (size_t i = tid * 4; i < n; i += nt * 4) cp_async4(d + i, s + i);
  } else {
    for (size_t i = tid; i < n; i += nt) d[i] = s[i];
  }
}

// Window w's block range: padded w*bpw .. (w+1)*bpw, ragged from
// block_starts.
template <bool RAGGED>
__device__ __forceinline__ void window_blocks(const int* block_starts, int w,
                                              int bpw, int& t0, int& t1) {
  if (RAGGED) {
    t0 = block_starts[w];
    t1 = block_starts[w + 1];
  } else {
    t0 = w * bpw;
    t1 = t0 + bpw;
  }
}

// Thread j owns row j of the block tile: fold the block into the window
// accumulator and zero the row for the next block.
template <int BT>
__device__ __forceinline__ void fold_block(float* tile, float (&acc)[BT],
                                           bool first) {
  const int j = threadIdx.x;
#pragma unroll
  for (int k = 0; k < BT; ++k) {
    const float p = tile[j * BT + k];
    acc[k] = first ? p : __fadd_rn(acc[k], p);
    tile[j * BT + k] = 0.f;
  }
}

template <int BT>
__device__ __forceinline__ void store_window(float* y, const float (&acc)[BT],
                                             int w, int l, int b, int b0,
                                             int bt) {
  float* yr = y + ((size_t)w * l + threadIdx.x) * b + b0;
#pragma unroll
  for (int k = 0; k < BT; ++k) {
    if (k < bt) yr[k] = acc[k];
  }
}

// ---------------------------------------------------------------------------
// Resident x, double-buffered stream.
// ---------------------------------------------------------------------------

template <typename V, typename I, bool QUANT, bool RAGGED, int BT>
__global__ void __launch_bounds__(1024)
    gust_spmv_db_kernel(const V* __restrict__ m, const I* __restrict__ col,
                        const I* __restrict__ row,
                        const float* __restrict__ scale,
                        const float* __restrict__ x, float* __restrict__ y,
                        const int* __restrict__ block_starts, int bpw, int l,
                        int c_blk, int b, int cc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);  // (l, BT) block partials
  const size_t v_bytes = align16((size_t)cc * l * sizeof(V));
  const size_t i_bytes = align16((size_t)cc * l * sizeof(I));
  unsigned char* stages = smem + align16((size_t)l * BT * sizeof(float));
  const size_t stage_bytes = v_bytes + 2 * i_bytes;

  const int w = blockIdx.x;
  const int j = threadIdx.x;
  const int b0 = blockIdx.y * BT;
  const int bt = min(BT, b - b0);
  int t0, t1;
  window_blocks<RAGGED>(block_starts, w, bpw, t0, t1);
  const int nchunk = (c_blk + cc - 1) / cc;
  const int units = (t1 - t0) * nchunk;

  // Chunk u: cycles c0 .. c0+ncc of block t0 + u / nchunk.
  auto fetch = [&](int u) {
    const int t = t0 + u / nchunk;
    const int c0 = (u % nchunk) * cc;
    const int ncc = min(cc, c_blk - c0);
    const size_t first = ((size_t)t * c_blk + c0) * l;
    const size_t n = (size_t)ncc * l;
    unsigned char* st = stages + (u & 1) * stage_bytes;
    copy_to_shared(st, m + first, n * sizeof(V));
    copy_to_shared(st + v_bytes, col + first, n * sizeof(I));
    copy_to_shared(st + v_bytes + i_bytes, row + first, n * sizeof(I));
  };

  float acc[BT];
#pragma unroll
  for (int k = 0; k < BT; ++k) {
    acc[k] = 0.f;
    tile[j * BT + k] = 0.f;
  }
  if (units > 0) fetch(0);
  cp_async_commit();

  for (int u = 0; u < units; ++u) {
    // Stage (u+1)&1 was last read in unit u-1, whose last cycle ended in a
    // barrier: it is free.
    if (u + 1 < units) fetch(u + 1);
    cp_async_commit();
    cp_async_wait<1>();  // unit u's copies are in
    __syncthreads();

    const int t = t0 + u / nchunk;
    const int ci = u % nchunk;
    const int ncc = min(cc, c_blk - ci * cc);
    const unsigned char* st = stages + (u & 1) * stage_bytes;
    const V* ms = reinterpret_cast<const V*>(st);
    const I* cs = reinterpret_cast<const I*>(st + v_bytes);
    const I* rs = reinterpret_cast<const I*>(st + v_bytes + i_bytes);
    const float s = QUANT ? scale[t] : 1.f;

    float v[kChunk] = {}, xv[kChunk] = {};
    int cl[kChunk] = {}, rr[kChunk] = {};
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < ncc) {
        v[i] = load_value<QUANT>(ms[i * l + j], s);
        cl[i] = static_cast<int>(cs[i * l + j]);
        rr[i] = static_cast<int>(rs[i * l + j]);
        if (BT == 1) xv[i] = v[i] != 0.f ? __ldg(x + (size_t)cl[i] * b + b0) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < ncc) {  // ncc is the same for every thread of the CTA
        if (v[i] != 0.f) {
          float* tr = tile + rr[i] * BT;
          if (BT == 1) {
            tr[0] = __fadd_rn(tr[0], __fmul_rn(v[i], xv[i]));
          } else {
            const float* xr = x + (size_t)cl[i] * b + b0;
#pragma unroll
            for (int k = 0; k < BT; ++k) {
              if (k < bt) tr[k] = __fadd_rn(tr[k], __fmul_rn(v[i], __ldg(xr + k)));
            }
          }
        }
        __syncthreads();  // the next cycle may add into the same rows
      }
    }
    if (ci == nchunk - 1) {
      fold_block<BT>(tile, acc, t == t0);
      __syncthreads();
    }
  }
  store_window<BT>(y, acc, w, l, b, b0, bt);
}

// ---------------------------------------------------------------------------
// Segment-local x, tiles streamed through a shared-memory ring.
// ---------------------------------------------------------------------------

// Position in a window's sequence of tiles: tile s of the block's cnt
// tiles, for chunk ci of block t.
struct TileCursor {
  int t, ci, s, cnt;
};

__device__ __forceinline__ void advance(TileCursor& c, int t1, int nchunk,
                                        const int* seg_blk, int s_blk) {
  if (++c.s < c.cnt) return;
  c.s = 0;
  if (++c.ci < nchunk) return;
  c.ci = 0;
  if (++c.t < t1) c.cnt = referenced_tiles(seg_blk, c.t, s_blk);
}

template <typename V, typename I, bool QUANT, bool RAGGED, int BT>
__global__ void __launch_bounds__(1024) gust_spmv_local_db_kernel(
    const V* __restrict__ m, const I* __restrict__ col_loc,
    const I* __restrict__ row, const int* __restrict__ seg_blk,
    const float* __restrict__ scale, const float* __restrict__ x,
    float* __restrict__ y, const int* __restrict__ block_starts, int bpw,
    int l, int c_blk, int s_blk, int b, int cc, int ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tile_bytes = align16((size_t)l * BT * sizeof(float));
  float* tile = reinterpret_cast<float*>(smem);  // (l, BT) block partials
  float* slots = reinterpret_cast<float*>(smem + tile_bytes);  // ring x tiles
  const size_t slot_floats = tile_bytes / sizeof(float);
  // gather buffer, [cycle][column][lane]: thread j reads and writes only
  // lane j, so it needs no barrier
  float* g = slots + ring * slot_floats;

  const int w = blockIdx.x;
  const int j = threadIdx.x;
  const int b0 = blockIdx.y * BT;
  const int bt = min(BT, b - b0);
  int t0, t1;
  window_blocks<RAGGED>(block_starts, w, bpw, t0, t1);
  const int nchunk = (c_blk + cc - 1) / cc;

  // x tile seg, columns b0 .. b0+bt, into ring slot `slot` as (l, bt).
  auto fetch = [&](const TileCursor& c, int slot) {
    const int seg = seg_blk[(size_t)c.t * s_blk + c.s];
    float* dst = slots + slot * slot_floats;
    if (bt == b) {  // one column tile: the x tile is one contiguous run
      copy_to_shared(dst, x + (size_t)seg * l * b, (size_t)l * b * sizeof(float));
    } else {
      for (int e = j; e < l * bt; e += blockDim.x) {
        const int r = e / bt, k = e - r * bt;
        cp_async4(dst + e, x + ((size_t)seg * l + r) * b + b0 + k);
      }
    }
  };

  float acc[BT];
#pragma unroll
  for (int k = 0; k < BT; ++k) {
    acc[k] = 0.f;
    tile[j * BT + k] = 0.f;
  }
  if (t0 < t1) {
    TileCursor ahead{t0, 0, 0, referenced_tiles(seg_blk, t0, s_blk)};
    TileCursor cur = ahead;
    for (int i = 0; i < ring - 1; ++i) {
      if (ahead.t < t1) {
        fetch(ahead, i);
        advance(ahead, t1, nchunk, seg_blk, s_blk);
      }
      cp_async_commit();
    }

    float v[kChunk] = {};
    int cl[kChunk] = {}, rr[kChunk] = {};
    int ncc = 0;
    for (int u = 0; cur.t < t1; ++u) {
      if (cur.s == 0) {  // a new chunk: its slots, loaded before the wait
        const int c0 = cur.ci * cc;
        ncc = min(cc, c_blk - c0);
        const float s = QUANT ? scale[cur.t] : 1.f;
        const size_t base = ((size_t)cur.t * c_blk + c0) * l + j;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          if (i < ncc) {
            v[i] = load_value<QUANT>(m[base + (size_t)i * l], s);
            cl[i] = static_cast<int>(col_loc[base + (size_t)i * l]);
            rr[i] = static_cast<int>(row[base + (size_t)i * l]);
          }
        }
      }
      if (ring == 4) {
        cp_async_wait<2>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile u is in; every thread is done with tile u-1
      if (ahead.t < t1) {
        fetch(ahead, (u + ring - 1) % ring);
        advance(ahead, t1, nchunk, seg_blk, s_blk);
      }
      cp_async_commit();

      // pick this lane's values out of tile u (local segment cur.s)
      const float* xt = slots + (u % ring) * slot_floats;
      const int lo0 = cur.s * l;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const unsigned off = static_cast<unsigned>(cl[i] - lo0);
        if (i < ncc && v[i] != 0.f && off < static_cast<unsigned>(l)) {
#pragma unroll
          for (int k = 0; k < BT; ++k) {
            if (k < bt) g[(i * BT + k) * l + j] = xt[off * bt + k];
          }
        }
      }

      if (cur.s == cur.cnt - 1) {  // the chunk's last tile: run its cycles
        // A slot whose local segment lies past the counted prefix (a table
        // row not strictly increasing there, which the packer never
        // writes) got no value from the ring: it reads x directly.
        const int lim = cur.cnt * l;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          if (i < ncc && v[i] != 0.f && cl[i] >= lim) {
            const int seg = seg_blk[(size_t)cur.t * s_blk + cl[i] / l];
            const float* xr = x + ((size_t)seg * l + cl[i] % l) * b + b0;
#pragma unroll
            for (int k = 0; k < BT; ++k) {
              if (k < bt) g[(i * BT + k) * l + j] = __ldg(xr + k);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          if (i < ncc) {
            if (v[i] != 0.f) {
              float* tr = tile + rr[i] * BT;
#pragma unroll
              for (int k = 0; k < BT; ++k) {
                if (k < bt) {
                  tr[k] = __fadd_rn(tr[k], __fmul_rn(v[i], g[(i * BT + k) * l + j]));
                }
              }
            }
            __syncthreads();  // the next cycle may add into the same rows
          }
        }
        if (cur.ci == nchunk - 1) {
          fold_block<BT>(tile, acc, cur.t == t0);
          __syncthreads();
        }
      }
      advance(cur, t1, nchunk, seg_blk, s_blk);
    }
  }
  store_window<BT>(y, acc, w, l, b, b0, bt);
}

// ---------------------------------------------------------------------------
// Host side: shared-memory plan, launch, dtype dispatch.
// ---------------------------------------------------------------------------

int max_shared_bytes() {
  int dev = 0, bytes = kSmemDefault;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}

// Above 48 KB, dynamic shared memory needs the kernel's opt-in, or the
// launch is refused.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= (size_t)kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

size_t resident_smem(int l, int bt, int cc, size_t ev, size_t ei) {
  return align16((size_t)l * bt * 4) +
         2 * (align16((size_t)cc * l * ev) + 2 * align16((size_t)cc * l * ei));
}

size_t local_smem(int l, int bt, int cc, int ring) {
  const size_t tile = align16((size_t)l * bt * 4);
  return tile + ring * tile + (size_t)cc * bt * l * 4;
}

template <typename V, typename I, bool QUANT, bool RAGGED, int BT>
cudaError_t launch_resident(const void* m, const void* col, const void* row,
                            const float* scale, const float* x, float* y,
                            const int* block_starts, int num_windows, int bpw,
                            int l, int c_blk, int b, cudaStream_t stream) {
  const int limit = max_shared_bytes();
  int cc = std::min(c_blk, BT == 1 ? kChunk : kWideChunk);
  while (cc > 1 && resident_smem(l, BT, cc, sizeof(V), sizeof(I)) > (size_t)limit) --cc;
  const size_t bytes = resident_smem(l, BT, cc, sizeof(V), sizeof(I));
  if (bytes > (size_t)limit) return cudaErrorInvalidConfiguration;
  auto kernel = gust_spmv_db_kernel<V, I, QUANT, RAGGED, BT>;
  dim3 grid(num_windows, (b + BT - 1) / BT);
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, l, bytes, stream>>>(
      static_cast<const V*>(m), static_cast<const I*>(col),
      static_cast<const I*>(row), scale, x, y, block_starts, bpw, l, c_blk, b,
      cc);
  return cudaGetLastError();
}

template <typename V, typename I, bool QUANT, bool RAGGED, int BT>
cudaError_t launch_local(const void* m, const void* col_loc, const void* row,
                         const int* seg_blk, const float* scale,
                         const float* x, float* y, const int* block_starts,
                         int num_windows, int bpw, int l, int c_blk,
                         int s_blk, int b, cudaStream_t stream) {
  const int limit = max_shared_bytes();
  int cc = std::min(c_blk, kChunk);
  // four ring slots where they fit beside a full chunk, else two
  const int ring = local_smem(l, BT, cc, 4) <= (size_t)limit ? 4 : 2;
  while (cc > 1 && local_smem(l, BT, cc, ring) > (size_t)limit) --cc;
  const size_t bytes = local_smem(l, BT, cc, ring);
  if (bytes > (size_t)limit) return cudaErrorInvalidConfiguration;
  auto kernel = gust_spmv_local_db_kernel<V, I, QUANT, RAGGED, BT>;
  dim3 grid(num_windows, (b + BT - 1) / BT);
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, l, bytes, stream>>>(
      static_cast<const V*>(m), static_cast<const I*>(col_loc),
      static_cast<const I*>(row), seg_blk, scale, x, y, block_starts, bpw, l,
      c_blk, s_blk, b, cc, ring);
  return cudaGetLastError();
}

// The arguments of both kernel families; seg_blk is null for the resident
// ones.
struct Args {
  const void *m, *col, *row;
  const int* seg_blk;
  const float* scale;
  const float* x;
  float* y;
  const int* block_starts;
  int num_windows, bpw, l, c_blk, s_blk, b;
  cudaStream_t stream;
};

template <typename V, typename I, bool QUANT, bool RAGGED, bool LOCAL, int BT>
cudaError_t launch(const Args& a) {
  if (LOCAL) {
    return launch_local<V, I, QUANT, RAGGED, BT>(
        a.m, a.col, a.row, a.seg_blk, a.scale, a.x, a.y, a.block_starts,
        a.num_windows, a.bpw, a.l, a.c_blk, a.s_blk, a.b, a.stream);
  }
  return launch_resident<V, I, QUANT, RAGGED, BT>(
      a.m, a.col, a.row, a.scale, a.x, a.y, a.block_starts, a.num_windows,
      a.bpw, a.l, a.c_blk, a.b, a.stream);
}

template <typename V, typename I, bool QUANT, bool RAGGED, bool LOCAL>
cudaError_t launch_bt(const Args& a) {
  return a.b == 1 ? launch<V, I, QUANT, RAGGED, LOCAL, 1>(a)
                  : launch<V, I, QUANT, RAGGED, LOCAL, 8>(a);
}

// vdt and idt: the dtype codes of gust::dispatch_dtypes.
template <bool RAGGED, bool LOCAL>
cudaError_t dispatch(const Args& a, int vdt, int idt) {
  if (a.l < 1 || a.l > 1024 || a.c_blk < 1 || a.b < 1 || a.num_windows < 1 ||
      (vdt == 2) != (a.scale != nullptr) || (RAGGED && !a.block_starts) ||
      (!RAGGED && a.bpw < 1) || (LOCAL && (!a.seg_blk || a.s_blk < 1))) {
    return cudaErrorInvalidValue;
  }
  return gust::dispatch_dtypes(vdt, idt, [&](auto v, auto i, auto q) {
    return launch_bt<typename decltype(v)::type, typename decltype(i)::type,
                     decltype(q)::value, RAGGED, LOCAL>(a);
  });
}

}  // namespace

extern "C" {

// Padded stream, resident x: window w owns blocks w*bpw .. (w+1)*bpw.
// y is (W, l, b).
int gust_spmv_db_padded(const void* m, const void* col, const void* row,
                        const float* scale, const float* x, float* y, int vdt,
                        int idt, int num_windows, int blocks_per_window, int l,
                        int c_blk, int b, void* stream) {
  Args a{m, col, row, nullptr, scale, x, y, nullptr, num_windows,
         blocks_per_window, l, c_blk, 0, b, static_cast<cudaStream_t>(stream)};
  return dispatch<false, false>(a, vdt, idt);
}

// Ragged stream, resident x: window w owns blocks block_starts[w] ..
// block_starts[w+1].
int gust_spmv_db_ragged(const void* m, const void* col, const void* row,
                        const float* scale, const float* x, float* y,
                        const int* block_starts, int vdt, int idt,
                        int num_windows, int l, int c_blk, int b,
                        void* stream) {
  Args a{m, col, row, nullptr, scale, x, y, block_starts, num_windows, 0, l,
         c_blk, 0, b, static_cast<cudaStream_t>(stream)};
  return dispatch<true, false>(a, vdt, idt);
}

// Padded stream, segment-local x: col_loc and seg_blk (T, s_blk) int32 in
// place of the columns.
int gust_spmv_local_db_padded(const void* m, const void* col_loc,
                              const void* row, const int* seg_blk,
                              const float* scale, const float* x, float* y,
                              int vdt, int idt, int num_windows,
                              int blocks_per_window, int l, int c_blk,
                              int s_blk, int b, void* stream) {
  Args a{m, col_loc, row, seg_blk, scale, x, y, nullptr, num_windows,
         blocks_per_window, l, c_blk, s_blk, b,
         static_cast<cudaStream_t>(stream)};
  return dispatch<false, true>(a, vdt, idt);
}

// Ragged stream, segment-local x.
int gust_spmv_local_db_ragged(const void* m, const void* col_loc,
                              const void* row, const int* seg_blk,
                              const float* scale, const float* x, float* y,
                              const int* block_starts, int vdt, int idt,
                              int num_windows, int l, int c_blk, int s_blk,
                              int b, void* stream) {
  Args a{m, col_loc, row, seg_blk, scale, x, y, block_starts, num_windows, 0,
         l, c_blk, s_blk, b, static_cast<cudaStream_t>(stream)};
  return dispatch<true, true>(a, vdt, idt);
}

const char* gust_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
