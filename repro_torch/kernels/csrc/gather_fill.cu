// GUST Buffer Filler on Hopper (sm_90a): out[r, j, :] = x[col[r, j], :].
//
// Replaces the TPU kernel
//   repro/kernels/gather_fill.py::make_gather_fill
// which keeps x resident in VMEM and gathers with a one-hot over the
// column segments plus a straight/lane-flipped select (the TPU has no fast
// gather).  Here each thread loads its values directly through the
// read-only cache, and every access is 16 bytes wide where the shape
// allows it:
//   * B = 1: a thread takes 16 bytes of columns (4 int32 or 8 int16
//     slots), gathers their 4-8 values and stores them as 16-byte runs;
//   * B % 4 == 0: a thread copies one 16-byte run of one slot's row of x
//     (a float4 load and a float4 store), the runs of a slot side by side;
//   * any other B: a thread copies one slot's B values.
// A CTA's tile holds whole slots, and a thread's slot and run inside it are
// fixed offsets computed once, so no division or modulo runs per element
// (the first design divided a 64-bit index by B for every value).  The
// gather is exact: the
// result equals x_padded[col] bit for bit, and it takes any column in x,
// not only the lane-structured ones the TPU kernel relies on.
//
// Bound.  Memory: the column stream read once, x read once, the
// (rows, l, B) f32 output written once; no arithmetic.

#include <algorithm>

#include "gust_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxCtas = 1u << 20;

// Columns of 16 bytes: 4 int32 or 8 int16 slots.
template <typename I>
struct Cols16 {
  static constexpr int kSlots = 16 / sizeof(I);
};

// B = 1: thread i of the grid takes slots [i * S, i * S + S) with S =
// Cols16<I>::kSlots; the last partial run, if any, one slot per thread.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    fill_b1_kernel(const I* __restrict__ col, const float* __restrict__ x,
                   float* __restrict__ out, size_t slots) {
  constexpr int S = Cols16<I>::kSlots;
  const size_t runs = slots / S;
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < runs; i += stride) {
    union {
      int4 v;
      I c[S];
    } cols;
    cols.v = __ldg(reinterpret_cast<const int4*>(col) + i);
    float vals[S];
#pragma unroll
    for (int k = 0; k < S; ++k) vals[k] = __ldg(x + static_cast<int>(cols.c[k]));
    float4* o = reinterpret_cast<float4*>(out) + i * (S / 4);
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      o[q] = make_float4(vals[4 * q], vals[4 * q + 1], vals[4 * q + 2], vals[4 * q + 3]);
    }
  }
  for (size_t s = runs * S + (size_t)blockIdx.x * kThreads + threadIdx.x; s < slots;
       s += stride) {
    out[s] = __ldg(x + static_cast<int>(col[s]));
  }
}

// B % 4 == 0: q = B / 4 16-byte runs a slot.  A CTA's tile is `per` whole
// slots (kThreads / q of them, or one with the runs looped when q >
// kThreads); a thread's slot and run inside the tile are fixed 32-bit
// offsets, computed once.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    fill_vec4_kernel(const I* __restrict__ col, const float4* __restrict__ x,
                     float4* __restrict__ out, size_t slots, int q) {
  const bool fits = q <= kThreads;
  const int per = fits ? kThreads / q : 1;
  const int ds = fits ? threadIdx.x / q : 0;
  const int r0 = fits ? threadIdx.x - ds * q : threadIdx.x;
  const int r_step = fits ? q : kThreads;
  if (ds >= per) return;
  const size_t stride = (size_t)gridDim.x * per;
  for (size_t s = (size_t)blockIdx.x * per + ds; s < slots; s += stride) {
    const float4* src = x + (size_t)static_cast<int>(col[s]) * q;
    float4* dst = out + s * q;
    for (int r = r0; r < q; r += r_step) dst[r] = __ldg(src + r);
  }
}

// Any B: one thread per slot.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    fill_rows_kernel(const I* __restrict__ col, const float* __restrict__ x,
                     float* __restrict__ out, size_t slots, int b) {
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t s = (size_t)blockIdx.x * kThreads + threadIdx.x; s < slots; s += stride) {
    const float* src = x + (size_t)static_cast<int>(col[s]) * b;
    float* dst = out + s * b;
    for (int k = 0; k < b; ++k) dst[k] = __ldg(src + k);
  }
}

unsigned ctas_for(size_t items) {
  return static_cast<unsigned>(std::max<size_t>(
      1, std::min<size_t>((items + kThreads - 1) / kThreads, kMaxCtas)));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename I>
cudaError_t launch(const void* col_v, const float* x, float* out, size_t slots,
                   int b, cudaStream_t stream) {
  const I* col = static_cast<const I*>(col_v);
  if (b == 1 && aligned16(col) && aligned16(out)) {
    fill_b1_kernel<I><<<ctas_for(slots / Cols16<I>::kSlots + 1), kThreads, 0, stream>>>(
        col, x, out, slots);
  } else if (b % 4 == 0 && aligned16(x) && aligned16(out)) {
    const int q = b / 4;
    fill_vec4_kernel<I><<<ctas_for(slots * q), kThreads, 0, stream>>>(
        col, reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), slots, q);
  } else {
    fill_rows_kernel<I><<<ctas_for(slots), kThreads, 0, stream>>>(col, x, out, slots, b);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// col (rows * l,) slots, idt 0 int32 or 1 int16; x (S*l, b) f32; out
// (rows * l, b) f32.
int gather_fill(const void* col, const float* x, float* out, int idt,
                long long slots, int b, void* stream) {
  if (slots < 1 || b < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idt == 0) return launch<int32_t>(col, x, out, slots, b, s);
  if (idt == 1) return launch<int16_t>(col, x, out, slots, b, s);
  return cudaErrorInvalidValue;
}

const char* gust_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
