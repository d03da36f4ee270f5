// GUST Buffer Filler on Hopper (sm_90a): out[r, j, :] = x[col[r, j], :].
//
// Replaces the TPU kernel
//   repro/kernels/gather_fill.py::make_gather_fill
// which keeps x resident in VMEM and gathers with a one-hot over the
// column segments plus a straight/lane-flipped select (the TPU has no fast
// gather).  Here one thread per (slot, vector column) loads its value
// directly: neighbouring threads write neighbouring outputs, and x (read
// through the read-only cache) stays in L2.  The gather is exact, so the
// result equals x_padded[col] bit for bit, and it takes any column in x,
// not only the lane-structured ones the TPU kernel relies on.
//
// Bound.  Memory: the column stream read once, x read once, the
// (rows, l, B) f32 output written once; no arithmetic.

#include <algorithm>

#include "gust_common.cuh"

namespace {

template <typename I>
__global__ void __launch_bounds__(256)
    gather_fill_kernel(const I* __restrict__ col, const float* __restrict__ x,
                       float* __restrict__ out, size_t slots, int b) {
  const size_t total = slots * b;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const size_t s = e / b;
    const int k = static_cast<int>(e - s * b);
    out[e] = __ldg(x + (size_t)col[s] * b + k);
  }
}

template <typename I>
cudaError_t launch(const void* col, const float* x, float* out, size_t slots,
                   int b, cudaStream_t stream) {
  const size_t total = slots * b;
  const size_t ctas = std::min<size_t>((total + 255) / 256, 1u << 20);
  gather_fill_kernel<I><<<static_cast<unsigned>(ctas), 256, 0, stream>>>(
      static_cast<const I*>(col), x, out, slots, b);
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
