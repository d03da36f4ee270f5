// GUST SpMV on Hopper (sm_90a): y = M @ x over a packed color-block stream,
// x resident in device memory, one CTA per output window.
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
// Design.  The TPU kernels gather x and route products with one-hot matmuls
// because the TPU has no fast gather or scatter.  Here each thread owns a
// lane: it loads x[col] directly, multiplies, and adds the product into a
// shared-memory (l, Bt) block tile at its row, with a barrier between
// cycles so that two lanes of different cycles never touch a row at once.
// At the end of a block, thread r owns row r of the tile and folds it into
// the window accumulator it keeps in registers.  A CTA walks its window's
// blocks in stream order (padded: w*bpw .. (w+1)*bpw; ragged:
// block_starts[w] .. block_starts[w+1]), so every output tile has exactly
// one owner: no atomics, and the result is deterministic.  The association
// is the reference kernels': sum within the block (cycle by cycle), then
// add the block into the tile; products and sums round with the _rn
// intrinsics, so nvcc contracts nothing into an FMA and the plain PyTorch
// version (repro_torch/kernels/ref.py) gives the same bits on the CPU.
//
// Padding slots collide with real slots on row 0 within a cycle, so slots
// whose value is 0 are skipped: exact for finite x (adding m*x == +-0
// changes no sum).  An int8 value that quantizes to 0 is skipped the same
// way.  Each thread loads the (m, col, row) of up to kStage cycles before
// it works through them, so those loads are in flight together.
//
// Bound.  Memory: every stream slot is read once (value + column + row
// bytes), plus the scales, x and y.  The arithmetic (one multiply and one
// add per slot and vector column) is far below the card's rate, and the
// per-cycle barrier and the scattered shared-memory adds keep this simple
// first version well short of the memory bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStage = 8;  // cycles whose (m, col, row) are loaded ahead

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename V, typename I, bool QUANT, bool RAGGED, int BT>
__global__ void __launch_bounds__(1024)
    gust_spmv_kernel(const V* __restrict__ m, const I* __restrict__ col,
                     const I* __restrict__ row,
                     const float* __restrict__ scale,
                     const float* __restrict__ x, float* __restrict__ y,
                     const int* __restrict__ block_starts,
                     int blocks_per_window, int l, int c_blk, int b) {
  extern __shared__ float tile[];  // (l, BT) partial sums of one block
  const int w = blockIdx.x;
  const int j = threadIdx.x;  // lane of the stream; after a block, tile row
  const int b0 = blockIdx.y * BT;
  const int bt = min(BT, b - b0);
  int t0, t1;
  if (RAGGED) {
    t0 = block_starts[w];
    t1 = block_starts[w + 1];
  } else {
    t0 = w * blocks_per_window;
    t1 = t0 + blocks_per_window;
  }

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
          float vi = to_f32(m[slot]);
          if (QUANT) vi = __fmul_rn(vi, s);
          v[i] = vi;
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

template <typename V, typename I, bool QUANT, bool RAGGED>
cudaError_t launch_typed(const void* m, const void* col, const void* row,
                         const float* scale, const float* x, float* y,
                         const int* block_starts, int num_windows,
                         int blocks_per_window, int l, int c_blk, int b,
                         cudaStream_t stream) {
  const V* mv = static_cast<const V*>(m);
  const I* cv = static_cast<const I*>(col);
  const I* rv = static_cast<const I*>(row);
  if (b == 1) {
    dim3 grid(num_windows, 1);
    gust_spmv_kernel<V, I, QUANT, RAGGED, 1>
        <<<grid, l, l * sizeof(float), stream>>>(
            mv, cv, rv, scale, x, y, block_starts, blocks_per_window, l,
            c_blk, b);
  } else {
    constexpr int kBt = 8;
    dim3 grid(num_windows, (b + kBt - 1) / kBt);
    gust_spmv_kernel<V, I, QUANT, RAGGED, kBt>
        <<<grid, l, l * kBt * sizeof(float), stream>>>(
            mv, cv, rv, scale, x, y, block_starts, blocks_per_window, l,
            c_blk, b);
  }
  return cudaGetLastError();
}

// vdt: 0 float32, 1 bfloat16, 2 int8 (then scale is required);
// idt: 0 int32, 1 int16.
template <bool RAGGED>
cudaError_t dispatch(const void* m, const void* col, const void* row,
                     const float* scale, const float* x, float* y,
                     const int* block_starts, int vdt, int idt,
                     int num_windows, int blocks_per_window, int l, int c_blk,
                     int b, cudaStream_t stream) {
  if (l < 1 || l > 1024 || c_blk < 1 || b < 1 || num_windows < 1 ||
      (vdt == 2) != (scale != nullptr)) {
    return cudaErrorInvalidValue;
  }
#define GUST_LAUNCH(V, I, Q)                                                \
  return launch_typed<V, I, Q, RAGGED>(m, col, row, scale, x, y,            \
                                       block_starts, num_windows,           \
                                       blocks_per_window, l, c_blk, b, stream)
  if (idt == 0) {
    if (vdt == 0) GUST_LAUNCH(float, int32_t, false);
    if (vdt == 1) GUST_LAUNCH(__nv_bfloat16, int32_t, false);
    if (vdt == 2) GUST_LAUNCH(int8_t, int32_t, true);
  } else if (idt == 1) {
    if (vdt == 0) GUST_LAUNCH(float, int16_t, false);
    if (vdt == 1) GUST_LAUNCH(__nv_bfloat16, int16_t, false);
    if (vdt == 2) GUST_LAUNCH(int8_t, int16_t, true);
  }
#undef GUST_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Padded stream: window w owns blocks w*bpw .. (w+1)*bpw.  y is (W, l, b).
int gust_spmv_padded(const void* m, const void* col, const void* row,
                     const float* scale, const float* x, float* y, int vdt,
                     int idt, int num_windows, int blocks_per_window, int l,
                     int c_blk, int b, void* stream) {
  if (blocks_per_window < 1) return cudaErrorInvalidValue;
  return dispatch<false>(m, col, row, scale, x, y, nullptr, vdt, idt,
                         num_windows, blocks_per_window, l, c_blk, b,
                         static_cast<cudaStream_t>(stream));
}

// Ragged stream: window w owns blocks block_starts[w] .. block_starts[w+1].
int gust_spmv_ragged(const void* m, const void* col, const void* row,
                     const float* scale, const float* x, float* y,
                     const int* block_starts, int vdt, int idt,
                     int num_windows, int l, int c_blk, int b, void* stream) {
  if (block_starts == nullptr) return cudaErrorInvalidValue;
  return dispatch<true>(m, col, row, scale, x, y, block_starts, vdt, idt,
                        num_windows, 0, l, c_blk, b,
                        static_cast<cudaStream_t>(stream));
}

const char* gust_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
