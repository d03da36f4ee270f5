// Segment-local GUST SpMV on Hopper (sm_90a), single-buffered: y = M @ x
// over a packed color-block stream whose blocks read x only through their
// pack-time segment tables, one CTA per output window.
//
// Replaces the TPU kernels
//   repro/kernels/gust_spmv.py::make_gust_spmv_local               (padded stream)
//   repro/kernels/gust_spmv_ragged.py::make_gust_spmv_ragged_local (ragged stream)
// with their f32/bf16 bodies (_local_kernel) and int8 bodies
// (_local_kernel_q: value = float(q) * scale_blk[t]).
//
// What it computes is what gust_spmv.cu computes (see its note), with x
// read through the segment table: the slot at block-local address col_loc
// of block t takes x[seg_blk[t, col_loc / l] * l + col_loc % l].
//
// Design.  Kernel 1's (gust_spmv.cu): one CTA per window walking its blocks
// in stream order, one thread per lane, a shared-memory (l, B) block tile
// with a barrier per cycle, the window accumulator in registers, products
// and sums rounded with the _rn intrinsics, slots whose value is 0 skipped.
// So on one artifact, for finite x, this kernel equals kernel 1/2 (and the
// double-buffered local kernels of gust_spmv_local_db.cu) bitwise.  What the
// segment table changes is the gather.  Per chunk of up to kChunk cycles of
// a block, each thread holds its lane's (value, col_loc, row); the CTA then
// copies the block's referenced x tiles (the strictly increasing prefix of
// its seg_blk row, gust::referenced_tiles) into shared memory with plain
// loads, at most `stage` tiles per pass, one barrier, and each thread picks
// the values of its slots that fall in the pass into a per-thread gather
// buffer.  A slot whose local segment lies past the counted prefix (a table
// row out of order, which the packer never writes) reads x directly, so the
// result never rests on the order.  Shared memory is sized from l, B, the
// chunk height and the stage depth, never from S_blk; the TPU kernel walks
// all S_blk tiles one grid step each.
//
// Bound.  Memory: each stream slot read once (value + col_loc + row bytes),
// the scales and x once, the referenced prefix of each seg_blk row, y
// written once.  The tile copies re-read x from L2 (x stays there), one
// block after another with no copy in flight during the cycles: this
// single-buffered kernel is latency-bound, as the double-buffered local
// kernels are.

#include <algorithm>

#include "gust_common.cuh"

namespace {

using gust::load_value;
using gust::max_shared_bytes;
using gust::referenced_tiles;

constexpr int kChunk = 8;     // most cycles whose slots a thread holds at once
constexpr int kMaxStage = 8;  // most x tiles staged per pass
// Fewer tiles per pass while a CTA needs more than this, so that two CTAs
// fit on an SM at B > 1 (104 KB each at l = 256).
constexpr int kSmemTarget = 110 * 1024;

template <typename V, typename I, bool QUANT, bool RAGGED, int BT>
__global__ void __launch_bounds__(1024) gust_spmv_local_kernel(
    const V* __restrict__ m, const I* __restrict__ col_loc,
    const I* __restrict__ row, const int* __restrict__ seg_blk,
    const float* __restrict__ scale, const float* __restrict__ x,
    float* __restrict__ y, const int* __restrict__ block_starts, int bpw,
    int l, int c_blk, int s_blk, int b, int cc, int stage) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                // (l, BT) block partials
  float* tiles = tile + l * BT;      // `stage` x tiles, each (l, bt)
  float* g = tiles + stage * l * BT; // gather buffer [cycle][column][lane]
  const int w = blockIdx.x;
  const int j = threadIdx.x;
  const int b0 = blockIdx.y * BT;
  const int bt = min(BT, b - b0);
  int t0, t1;
  if (RAGGED) {
    t0 = block_starts[w];
    t1 = block_starts[w + 1];
  } else {
    t0 = w * bpw;
    t1 = t0 + bpw;
  }

  float acc[BT];
#pragma unroll
  for (int k = 0; k < BT; ++k) {
    acc[k] = 0.f;
    tile[j * BT + k] = 0.f;
  }
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const int cnt = referenced_tiles(seg_blk, t, s_blk);
    const int* seg_row = seg_blk + (size_t)t * s_blk;
    const float s = QUANT ? scale[t] : 1.f;
    for (int c0 = 0; c0 < c_blk; c0 += cc) {
      const int ncc = min(cc, c_blk - c0);
      float v[kChunk] = {};
      int cl[kChunk] = {}, rr[kChunk] = {};
      const size_t base = ((size_t)t * c_blk + c0) * l + j;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i < ncc) {
          v[i] = load_value<QUANT>(m[base + (size_t)i * l], s);
          cl[i] = static_cast<int>(col_loc[base + (size_t)i * l]);
          rr[i] = static_cast<int>(row[base + (size_t)i * l]);
        }
      }
      // The block's referenced tiles, `stage` at a time.
      for (int p0 = 0; p0 < cnt; p0 += stage) {
        const int np = min(stage, cnt - p0);
        __syncthreads();  // every thread is done with the previous pass
        const int per_tile = l * bt;
        for (int e = j; e < np * per_tile; e += blockDim.x) {
          const int st = e / per_tile;
          const int rem = e - st * per_tile;
          const int r = rem / bt, k = rem - r * bt;
          tiles[e] = x[((size_t)seg_row[p0 + st] * l + r) * b + b0 + k];
        }
        __syncthreads();
        const int lo = p0 * l;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const unsigned off = static_cast<unsigned>(cl[i] - lo);
          if (i < ncc && v[i] != 0.f && off < static_cast<unsigned>(np * l)) {
#pragma unroll
            for (int k = 0; k < BT; ++k) {
              if (k < bt) g[(i * BT + k) * l + j] = tiles[off * bt + k];
            }
          }
        }
      }
      // Slots past the counted prefix read x directly.
      const int lim = cnt * l;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i < ncc && v[i] != 0.f && cl[i] >= lim) {
          const int seg = seg_row[cl[i] / l];
          const float* xr = x + ((size_t)seg * l + cl[i] % l) * b + b0;
#pragma unroll
          for (int k = 0; k < BT; ++k) {
            if (k < bt) g[(i * BT + k) * l + j] = __ldg(xr + k);
          }
        }
      }
      // The chunk's cycles, as in kernel 1.
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i < ncc) {  // ncc is the same for every thread of the CTA
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
    }
    // Thread j owns row j: fold the block into the window accumulator and
    // zero the row for the next block.
#pragma unroll
    for (int k = 0; k < BT; ++k) {
      const float p = tile[j * BT + k];
      acc[k] = (t == t0) ? p : __fadd_rn(acc[k], p);
      tile[j * BT + k] = 0.f;
    }
    __syncthreads();
  }

  float* yr = y + ((size_t)w * l + j) * b + b0;
#pragma unroll
  for (int k = 0; k < BT; ++k) {
    if (k < bt) yr[k] = acc[k];
  }
}

size_t local_smem(int l, int bt, int cc, int stage) {
  return (size_t)l * bt * 4 * (1 + stage + cc);
}

template <typename V, typename I, bool QUANT, bool RAGGED, int BT>
cudaError_t launch(const void* m, const void* col_loc, const void* row,
                   const int* seg_blk, const float* scale, const float* x,
                   float* y, const int* block_starts, int num_windows, int bpw,
                   int l, int c_blk, int s_blk, int b, cudaStream_t stream) {
  const size_t limit = max_shared_bytes();
  int cc = std::min(c_blk, kChunk);
  int stage = kMaxStage;
  const size_t target = std::min(limit, (size_t)kSmemTarget);
  while (stage > 1 && local_smem(l, BT, cc, stage) > target) --stage;
  while (cc > 1 && local_smem(l, BT, cc, stage) > limit) --cc;
  const size_t bytes = local_smem(l, BT, cc, stage);
  if (bytes > limit) return cudaErrorInvalidConfiguration;
  auto kernel = gust_spmv_local_kernel<V, I, QUANT, RAGGED, BT>;
  cudaError_t err = gust::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(num_windows, (b + BT - 1) / BT);
  kernel<<<grid, l, bytes, stream>>>(
      static_cast<const V*>(m), static_cast<const I*>(col_loc),
      static_cast<const I*>(row), seg_blk, scale, x, y, block_starts, bpw, l,
      c_blk, s_blk, b, cc, stage);
  return cudaGetLastError();
}

// vdt and idt: the dtype codes of gust::dispatch_dtypes.
template <bool RAGGED>
cudaError_t dispatch(const void* m, const void* col_loc, const void* row,
                     const int* seg_blk, const float* scale, const float* x,
                     float* y, const int* block_starts, int vdt, int idt,
                     int num_windows, int bpw, int l, int c_blk, int s_blk,
                     int b, cudaStream_t stream) {
  if (l < 1 || l > 1024 || c_blk < 1 || b < 1 || num_windows < 1 ||
      s_blk < 1 || seg_blk == nullptr || (vdt == 2) != (scale != nullptr) ||
      (RAGGED && block_starts == nullptr) || (!RAGGED && bpw < 1)) {
    return cudaErrorInvalidValue;
  }
  return gust::dispatch_dtypes(vdt, idt, [&](auto v, auto i, auto q) {
    using V = typename decltype(v)::type;
    using I = typename decltype(i)::type;
    constexpr bool Q = decltype(q)::value;
    if (b == 1) {
      return launch<V, I, Q, RAGGED, 1>(m, col_loc, row, seg_blk, scale, x, y,
                                        block_starts, num_windows, bpw, l,
                                        c_blk, s_blk, b, stream);
    }
    return launch<V, I, Q, RAGGED, 8>(m, col_loc, row, seg_blk, scale, x, y,
                                      block_starts, num_windows, bpw, l, c_blk,
                                      s_blk, b, stream);
  });
}

}  // namespace

extern "C" {

// Padded stream: window w owns blocks w*bpw .. (w+1)*bpw; seg_blk (T, s_blk)
// int32.  y is (W, l, b).
int gust_spmv_local_padded(const void* m, const void* col_loc, const void* row,
                           const int* seg_blk, const float* scale,
                           const float* x, float* y, int vdt, int idt,
                           int num_windows, int blocks_per_window, int l,
                           int c_blk, int s_blk, int b, void* stream) {
  return dispatch<false>(m, col_loc, row, seg_blk, scale, x, y, nullptr, vdt,
                         idt, num_windows, blocks_per_window, l, c_blk, s_blk,
                         b, static_cast<cudaStream_t>(stream));
}

// Ragged stream: window w owns blocks block_starts[w] .. block_starts[w+1].
int gust_spmv_local_ragged(const void* m, const void* col_loc, const void* row,
                           const int* seg_blk, const float* scale,
                           const float* x, float* y, const int* block_starts,
                           int vdt, int idt, int num_windows, int l, int c_blk,
                           int s_blk, int b, void* stream) {
  return dispatch<true>(m, col_loc, row, seg_blk, scale, x, y, block_starts,
                        vdt, idt, num_windows, 0, l, c_blk, s_blk, b,
                        static_cast<cudaStream_t>(stream));
}

const char* gust_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
