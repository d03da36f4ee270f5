// Double-buffered GUST SpMV on Hopper (sm_90a), resident x: y = M @ x over
// a packed color-block stream.
//
// Replaces the TPU kernels
//   repro/kernels/gust_spmv.py::make_gust_spmv_db                (padded stream)
//   repro/kernels/gust_spmv_ragged.py::make_gust_spmv_ragged_db  (ragged stream)
// with their f32/bf16 bodies and their int8 bodies (_q: value = float(q) *
// scale_blk[t], scales on pack-time blocks).  Their segment-local twins
// (make_gust_spmv_local_db, make_gust_spmv_ragged_local_db) are ported in
// gust_spmv_local_db.cu.
//
// What they compute is what gust_spmv.cu computes (see its note): each
// cycle of a (c_blk, l) block gives lane j one slot (value m, column, adder
// row), which adds m * x[col, :] into its window's (l, B) output tile, with
// the association of kernels 1/2 (sum within the block cycle by cycle, then
// the blocks in stream order), products and sums rounded with the _rn
// intrinsics (no FMA contraction), and slots whose value is 0 skipped
// (padding slots share row 0 with real slots).  So on one artifact, for
// finite x, these kernels equal gust_spmv_padded / gust_spmv_ragged bitwise
// (single == double), and the padded and ragged kernels equal each other.
//
// Ragged stream (kernel 7, gust_spmv_db_ragged): the resident instance of
// gust_spread.cuh (see its note), the same code as kernel 1.  The stream's
// blocks are spread over a persistent grid, each block's tile written to a
// (T, l, B) scratch and folded per window in stream order, and a chunk's
// cycles run with two barriers.  Its second buffer is the register
// prefetch: each thread loads the next chunk's (m, col, row) slots, the
// next block's first chunk included, while this chunk sums, so the stream
// is in flight while the CTA computes.  No shared-memory stream stage: a
// cp.async copy of the next chunk's rows would only move the same bytes
// through shared memory, and such a stage was slower for kernels 6/8 on
// the card (PERF.md).
//
// Padded stream (kernel 5, gust_spmv_db_padded): still the first design,
// one CTA per window walking its blocks w*bpw .. (w+1)*bpw in stream
// order, one thread per lane, a shared-memory block tile with a barrier
// per cycle and the window accumulator in registers (initialised from the
// window's first block).  The unit of its pipeline is a chunk of up to
// kChunk cycles of one block.  Its (m, col, row) rows are one contiguous
// run of each leaf; the CTA copies the run of chunk u+1 into one of two
// shared-memory stages with cp.async (16-byte copies where source and
// length allow, 4-byte copies, or plain loads at a misaligned edge:
// int8/int16/bf16 leaves at odd l) while chunk u computes out of the
// other.  A chunk is 8 cycles at B=1 and GUST_DB_WIDE_CHUNK (4) when B > 1.
// x is read straight from device memory (it stays in the 50 MB L2).  At
// B=1 each thread starts the x loads of the whole chunk before its first
// add.
//
// Bound.  Memory: each stream slot read once (value + column + row bytes),
// the scales and x once, y written once; kernel 7 adds its scratch
// (partial_bytes).  One multiply and one add per slot and vector column
// is far below the card's rate.  Kernel 5's per-cycle barrier with about
// two CTAs of 256 threads per SM keeps it latency-bound.

#include "gust_spread.cuh"

// Most cycles in one pipeline unit of kernel 5 when B > 1: a
// build-time constant so that it can be swept
// (python -m repro_torch.kernels.chunk_sweep).  On the H100 at B=8 an
// 8-cycle f32 unit (56 KB of shared memory per CTA) ran 35% slower than
// kernel 1, 4 cycles (32 KB) about 5% slower, 2 and 1 slower again
// (PERF.md).
#ifndef GUST_DB_WIDE_CHUNK
#define GUST_DB_WIDE_CHUNK 4
#endif

namespace {

constexpr int kChunk = 8;  // most cycles in one pipeline unit
constexpr int kWideChunk = GUST_DB_WIDE_CHUNK;
static_assert(kWideChunk >= 1 && kWideChunk <= kChunk, "GUST_DB_WIDE_CHUNK");

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

template <typename V, typename I, bool QUANT, int BT>
__global__ void __launch_bounds__(1024)
    gust_spmv_db_kernel(const V* __restrict__ m, const I* __restrict__ col,
                        const I* __restrict__ row,
                        const float* __restrict__ scale,
                        const float* __restrict__ x, float* __restrict__ y,
                        int bpw, int l, int c_blk, int b, int cc) {
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
  const int t0 = w * bpw;
  const int t1 = t0 + bpw;
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

size_t resident_smem(int l, int bt, int cc, size_t ev, size_t ei) {
  return align16((size_t)l * bt * 4) +
         2 * (align16((size_t)cc * l * ev) + 2 * align16((size_t)cc * l * ei));
}

template <typename V, typename I, bool QUANT, int BT>
cudaError_t launch_padded(const void* m, const void* col, const void* row,
                          const float* scale, const float* x, float* y,
                          int num_windows, int bpw, int l, int c_blk, int b,
                          cudaStream_t stream) {
  const int limit = max_shared_bytes();
  int cc = std::min(c_blk, BT == 1 ? kChunk : kWideChunk);
  while (cc > 1 && resident_smem(l, BT, cc, sizeof(V), sizeof(I)) > (size_t)limit) --cc;
  const size_t bytes = resident_smem(l, BT, cc, sizeof(V), sizeof(I));
  if (bytes > (size_t)limit) return cudaErrorInvalidConfiguration;
  auto kernel = gust_spmv_db_kernel<V, I, QUANT, BT>;
  dim3 grid(num_windows, (b + BT - 1) / BT);
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, l, bytes, stream>>>(
      static_cast<const V*>(m), static_cast<const I*>(col),
      static_cast<const I*>(row), scale, x, y, bpw, l, c_blk, b, cc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Padded stream: window w owns blocks w*bpw .. (w+1)*bpw.  y is (W, l, b).
// vdt and idt: the dtype codes of gust::dispatch_dtypes.
int gust_spmv_db_padded(const void* m, const void* col, const void* row,
                        const float* scale, const float* x, float* y, int vdt,
                        int idt, int num_windows, int blocks_per_window, int l,
                        int c_blk, int b, void* stream) {
  if (l < 1 || l > 1024 || c_blk < 1 || b < 1 || num_windows < 1 ||
      (vdt == 2) != (scale != nullptr) || blocks_per_window < 1) {
    return cudaErrorInvalidValue;
  }
  return gust::dispatch_dtypes(vdt, idt, [&](auto v, auto i, auto q) {
    using V = typename decltype(v)::type;
    using I = typename decltype(i)::type;
    constexpr bool Q = decltype(q)::value;
    auto s = static_cast<cudaStream_t>(stream);
    if (b == 1) {
      return launch_padded<V, I, Q, 1>(m, col, row, scale, x, y, num_windows,
                                       blocks_per_window, l, c_blk, b, s);
    }
    return launch_padded<V, I, Q, 8>(m, col, row, scale, x, y, num_windows,
                                     blocks_per_window, l, c_blk, b, s);
  });
}

// Ragged stream: window w owns blocks block_starts[w] .. block_starts[w+1]
// of the t_blk blocks.  part is a (t_blk, l, b) f32 scratch, y is (W, l, b).
int gust_spmv_db_ragged(const void* m, const void* col, const void* row,
                        const float* scale, const float* x, float* y,
                        float* part, const int* block_starts, int vdt, int idt,
                        int num_windows, int t_blk, int l, int c_blk, int b,
                        void* stream) {
  return spread<true, Gather::kResident, 0>(
      m, col, row, nullptr, scale, x, y, part, block_starts, vdt, idt,
      num_windows, t_blk, 0, l, c_blk, 0, b, stream);
}

// The launch gust_spmv_db_ragged makes: see spread_plan.
int gust_spmv_db_plan(int vdt, int idt, int t_blk, int l, int c_blk, int b,
                      int* out) {
  return spread_plan<Gather::kResident, 0>(vdt, idt, t_blk, l, c_blk, b, out);
}

const char* gust_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
