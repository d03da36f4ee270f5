// GUST SpMV on Hopper (sm_90a): y = M @ x over a packed color-block stream,
// x resident in device memory.
//
// Replaces the TPU kernels
//   repro/kernels/gust_spmv.py::make_gust_spmv              (padded stream)
//   repro/kernels/gust_spmv_ragged.py::make_gust_spmv_ragged (ragged stream)
// with their f32/bf16 bodies (_kernel) and int8 bodies (_kernel_q).
//
// What it computes.  The stream holds blocks of c_blk cycles x l lanes.  In
// each cycle, lane j carries one slot (value m, original column col, adder
// row): the slot adds m * x[col, :] into row `row` of its window's (l, B)
// output tile.  The edge coloring makes each cycle collision-free: no two
// real slots of a cycle share a row.  Padding slots carry m == 0, row == 0.
//
// Padded stream (kernel 1, gust_spmv_padded): the resident, single-buffered
// instance of gust_spread.cuh (see its note).  The stream's blocks are
// spread over a persistent grid, each block's (l, B) tile summed through a
// shared product buffer with two barriers a chunk of cycles and written to
// a (T, l, B) scratch, then each window's tiles folded in stream order by
// a second kernel, so no CTA walks the longest window alone and no CTA
// waits at a barrier per cycle.  Each slot reads x[col] directly; the next
// chunk's slots load into registers while this chunk sums.  At l=256 a CTA
// takes 8 KB of shared memory at B=1 and 32 KB at B=8.
//
// Ragged stream (kernel 2, gust_spmv_ragged): still the first design, one
// CTA per window.  Each thread owns a lane: it loads x[col] directly,
// multiplies, and adds the product into a shared-memory (l, Bt) block tile
// at its row, with a barrier between cycles so that two lanes of different
// cycles never touch a row at once.  At the end of a block, thread r owns
// row r of the tile and folds it into the window accumulator it keeps in
// registers.  A CTA walks its window's blocks block_starts[w] ..
// block_starts[w+1] in stream order, so every output tile has exactly one
// owner: no atomics, and the result is deterministic.  Each thread loads
// the (m, col, row) of up to kStage cycles before it works through them.
//
// Both keep the reference kernels' association: sum within the block
// (cycle by cycle), then add the block into the tile; products and sums
// round with the _rn intrinsics, so nvcc contracts nothing into an FMA and
// the plain PyTorch version (repro_torch/kernels/ref.py) gives the same
// bits on the CPU.  Padding slots collide with real slots on row 0 within
// a cycle, so slots whose value is 0 are skipped: exact for finite x
// (adding m*x == +-0 changes no sum).  An int8 value that quantizes to 0 is
// skipped the same way.  So the two kernels equal each other bitwise on
// one matrix (padded == ragged).
//
// Bound.  Memory: every stream slot is read once (value + column + row
// bytes), plus the scales, x and y; kernel 1 adds its scratch
// (partial_bytes).  The arithmetic (one multiply and one add per slot and
// vector column) is far below the card's rate.  Kernel 2's barrier per
// cycle, with about two CTAs of 256 threads per SM, keeps it well short of
// the memory bound.

#include "gust_spread.cuh"

namespace {

constexpr int kStage = 8;  // cycles whose (m, col, row) kernel 2 loads ahead

template <typename V, typename I, bool QUANT, int BT>
__global__ void __launch_bounds__(1024)
    gust_spmv_kernel(const V* __restrict__ m, const I* __restrict__ col,
                     const I* __restrict__ row,
                     const float* __restrict__ scale,
                     const float* __restrict__ x, float* __restrict__ y,
                     const int* __restrict__ block_starts, int l, int c_blk,
                     int b) {
  extern __shared__ float tile[];  // (l, BT) partial sums of one block
  const int w = blockIdx.x;
  const int j = threadIdx.x;  // lane of the stream; after a block, tile row
  const int b0 = blockIdx.y * BT;
  const int bt = min(BT, b - b0);
  const int t0 = block_starts[w];
  const int t1 = block_starts[w + 1];

  float acc[BT];
#pragma unroll
  for (int k = 0; k < BT; ++k) {
    acc[k] = 0.f;
    tile[j * BT + k] = 0.f;
  }
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const float s = QUANT ? scale[t] : 1.f;
    const size_t base = (size_t)t * c_blk * l + j;
    for (int c0 = 0; c0 < c_blk; c0 += kStage) {
      const int nc = min(kStage, c_blk - c0);
      float v[kStage];
      int cc[kStage], rr[kStage];
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        if (i < nc) {
          const size_t slot = base + (size_t)(c0 + i) * l;
          v[i] = load_value<QUANT>(m[slot], s);
          cc[i] = static_cast<int>(col[slot]);
          rr[i] = static_cast<int>(row[slot]);
        }
      }
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        if (i < nc) {  // nc is the same for every thread of the CTA
          if (v[i] != 0.f) {
            const float* xr = x + (size_t)cc[i] * b + b0;
            float* tr = tile + rr[i] * BT;
#pragma unroll
            for (int k = 0; k < BT; ++k) {
              if (k < bt) tr[k] = __fadd_rn(tr[k], __fmul_rn(v[i], __ldg(xr + k)));
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

template <typename V, typename I, bool QUANT>
cudaError_t launch_ragged(const void* m, const void* col, const void* row,
                          const float* scale, const float* x, float* y,
                          const int* block_starts, int num_windows, int l,
                          int c_blk, int b, cudaStream_t stream) {
  const V* mv = static_cast<const V*>(m);
  const I* cv = static_cast<const I*>(col);
  const I* rv = static_cast<const I*>(row);
  if (b == 1) {
    dim3 grid(num_windows, 1);
    gust_spmv_kernel<V, I, QUANT, 1>
        <<<grid, l, l * sizeof(float), stream>>>(mv, cv, rv, scale, x, y,
                                                 block_starts, l, c_blk, b);
  } else {
    constexpr int kBt = 8;
    dim3 grid(num_windows, (b + kBt - 1) / kBt);
    gust_spmv_kernel<V, I, QUANT, kBt>
        <<<grid, l, l * kBt * sizeof(float), stream>>>(
            mv, cv, rv, scale, x, y, block_starts, l, c_blk, b);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Padded stream: window w owns blocks w*bpw .. (w+1)*bpw of the t_blk =
// W*bpw blocks.  part is a (t_blk, l, b) f32 scratch, y is (W, l, b).
// vdt and idt: the dtype codes of gust::dispatch_dtypes.
int gust_spmv_padded(const void* m, const void* col, const void* row,
                     const float* scale, const float* x, float* y, float* part,
                     int vdt, int idt, int num_windows, int t_blk,
                     int blocks_per_window, int l, int c_blk, int b,
                     void* stream) {
  return spread<false, Gather::kResident, 0>(
      m, col, row, nullptr, scale, x, y, part, nullptr, vdt, idt, num_windows,
      t_blk, blocks_per_window, l, c_blk, 0, b, stream);
}

// Ragged stream: window w owns blocks block_starts[w] .. block_starts[w+1].
// y is (W, l, b).
int gust_spmv_ragged(const void* m, const void* col, const void* row,
                     const float* scale, const float* x, float* y,
                     const int* block_starts, int vdt, int idt,
                     int num_windows, int l, int c_blk, int b, void* stream) {
  if (l < 1 || l > 1024 || c_blk < 1 || b < 1 || num_windows < 1 ||
      block_starts == nullptr || (vdt == 2) != (scale != nullptr)) {
    return cudaErrorInvalidValue;
  }
  return gust::dispatch_dtypes(vdt, idt, [&](auto v, auto i, auto q) {
    return launch_ragged<typename decltype(v)::type,
                         typename decltype(i)::type, decltype(q)::value>(
        m, col, row, scale, x, y, block_starts, num_windows, l, c_blk, b,
        static_cast<cudaStream_t>(stream));
  });
}

// The launch gust_spmv_padded makes: see spread_plan.
int gust_spmv_plan(int vdt, int idt, int t_blk, int l, int c_blk, int b,
                   int* out) {
  return spread_plan<Gather::kResident, 0>(vdt, idt, t_blk, l, c_blk, b, out);
}

const char* gust_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
