// GUST SpGEMM on Hopper (sm_90a): C = A @ B over A's packed color-block
// stream and B's condensed rows, one CTA per output window.
//
// Replaces the TPU kernel
//   repro/kernels/gust_spgemm.py::make_gust_spgemm
//
// What it computes.  A's stream (either layout, viewed as the ragged block
// stream: window w owns blocks block_starts[w] .. block_starts[w+1]) holds
// cycles of l slots (value a, ORIGINAL column j, adder row).  B is in the
// condensed-row format: row j of B is k_max (value, column) pairs, its real
// entries first (columns ascending, deduplicated), then padding (0, 0).
// Slot (a, row, j) adds a * B[j, k] into cell (row, B's column of k) of its
// window's (l, n_out) accumulator.  The result is (W, l, n_out) f32.
//
// Design.  The TPU kernel gathers B rows and routes partial rows onto adder
// rows with one-hot matmuls and keeps the (l, n_out) accumulator in VMEM.
// Here the accumulator is the window's own slice of y in device memory
// (16 MB per window at l = 256, n_out = 16,384: too large for shared
// memory), zeroed by a memset before the kernel, and owned by one CTA, so
// no atomics are needed.  A CTA walks its window's cycles in stream order,
// a pass of up to kPassSlots slots at a time:
//   1. each slot's pair count is the length of its B row (from a pre-pass,
//      lengths[j] = 1 + position of the row's last nonzero value), or 0 when
//      a == 0; an exclusive scan over the pass gives each slot its range of
//      pair indices;
//   2. cycle by cycle, all threads of the CTA spread the cycle's pairs
//      among themselves (a slot on the hub row of a power-law graph has
//      thousands of pairs; one thread per slot would stall the cycle on it):
//      pair p finds its slot by binary search in the scan, reads B[j, k]
//      (neighbouring threads read neighbouring entries of one B row) and
//      adds a * b into its cell with a plain read-modify-write;
//   3. a barrier ends every cycle that had pairs.
// Within a cycle no two pairs share a cell: the edge colouring gives the
// cycle's real slots distinct rows, and B's row has distinct columns.  The
// padding does collide (A's padding slots all carry row 0, B's padding
// entries column 0), so slots with a == 0 and entries with b == 0 are
// skipped: a skipped term is +-0 and changes no nonzero sum.  Each cell's
// sum runs in stream order from +0, with _rn intrinsics (no FMA
// contraction): the plain version on the CPU adds in the same order.
//
// Bound.  Memory: A's stream read once, B's real entries read once (plus
// one sector per row to find its end), y written once.  The row-length
// pre-pass reads the whole value plane, padding to k_max included: a cost
// of this design, not of the product.
// The operations (one multiply and one add per partial product) are far
// below the card's rate.  The per-cycle barrier and the scattered
// read-modify-writes to device memory keep this first version well above
// that bound, and one CTA per window leaves SMs idle when W < 132.

#include "gust_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPassSlots = 2048;  // slots staged per pass (one block at l = 256, c_blk = 8)

// lengths[r] = 1 + position of the last nonzero value of condensed row r
// (0 for a row of zeros): one warp per row.
__global__ void __launch_bounds__(256)
    row_lengths_kernel(const float* __restrict__ b_vals, int* __restrict__ lengths,
                       int r_rows, int k_max) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= r_rows) return;  // the whole warp
  const float* row = b_vals + (size_t)r * k_max;
  int last = -1;
  for (int k = lane; k < k_max; k += 32) {
    if (row[k] != 0.f) last = k;
  }
  for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  if (lane == 0) lengths[r] = last + 1;
}

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    gust_spgemm_kernel(const V* __restrict__ m, const I* __restrict__ col,
                       const I* __restrict__ row,
                       const int* __restrict__ block_starts,
                       const float* __restrict__ b_vals,
                       const int* __restrict__ b_cols,
                       const int* __restrict__ lengths, float* y, int l,
                       int c_blk, int k_max, int n_out) {
  __shared__ float a_s[kPassSlots];
  __shared__ int col_s[kPassSlots];
  __shared__ int row_s[kPassSlots];
  __shared__ int pre_s[kPassSlots + 1];  // exclusive scan of pair counts
  __shared__ int warp_s[kWarps];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* yw = y + (size_t)blockIdx.x * l * n_out;
  const int pass_cycles = max(1, min(c_blk, kPassSlots / l));
  const size_t first = (size_t)block_starts[blockIdx.x] * c_blk;
  const size_t last = (size_t)block_starts[blockIdx.x + 1] * c_blk;

  for (size_t r0 = first; r0 < last; r0 += pass_cycles) {
    const size_t left = last - r0;
    const int nc = left < (size_t)pass_cycles ? static_cast<int>(left) : pass_cycles;
    const int n = nc * l;
    // Stage the pass: thread tid owns slots s0 .. s0+per.
    const int per = (n + kThreads - 1) / kThreads;
    const int s0 = tid * per;
    int sum = 0;
    for (int i = 0; i < per; ++i) {
      const int s = s0 + i;
      if (s < n) {
        const size_t g = r0 * l + s;
        const float a = gust::to_f32(m[g]);
        const int c = static_cast<int>(col[g]);
        a_s[s] = a;
        col_s[s] = c;
        row_s[s] = static_cast<int>(row[g]);
        pre_s[s] = sum;
        sum += a != 0.f ? lengths[c] : 0;
      }
    }
    // Exclusive scan of the per-thread sums across the CTA.
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_s[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int v = warp_s[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      warp_s[lane] = v;
    }
    __syncthreads();
    const int offset = (warp ? warp_s[warp - 1] : 0) + incl - sum;
    for (int i = 0; i < per; ++i) {
      if (s0 + i < n) pre_s[s0 + i] += offset;
    }
    if (tid == 0) pre_s[n] = warp_s[kWarps - 1];
    __syncthreads();

    for (int c = 0; c < nc; ++c) {
      const int lo = pre_s[c * l], hi = pre_s[(c + 1) * l];
      if (lo == hi) continue;  // the same for every thread
      for (int p = lo + tid; p < hi; p += kThreads) {
        // the last slot s of the cycle with pre_s[s] <= p
        int a = c * l, b = (c + 1) * l;  // pre_s[a] <= p < pre_s[b]
        while (b - a > 1) {
          const int mid = (a + b) >> 1;
          if (pre_s[mid] <= p) {
            a = mid;
          } else {
            b = mid;
          }
        }
        const size_t bi = (size_t)col_s[a] * k_max + (p - pre_s[a]);
        const float bv = b_vals[bi];
        if (bv != 0.f) {
          float* cell = yw + (size_t)row_s[a] * n_out + b_cols[bi];
          *cell = __fadd_rn(*cell, __fmul_rn(a_s[a], bv));
        }
      }
      __syncthreads();  // the next cycle may add into the same cells
    }
    __syncthreads();  // the next pass rewrites the staged slots
  }
}

template <typename V, typename I>
cudaError_t launch_typed(const void* m, const void* col, const void* row,
                         const int* block_starts, const float* b_vals,
                         const int* b_cols, int* lengths, float* y,
                         int num_windows, int l, int c_blk, int r_rows,
                         int k_max, int n_out, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      y, 0, (size_t)num_windows * l * n_out * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const int warps_per_cta = 256 / 32;
  row_lengths_kernel<<<(r_rows + warps_per_cta - 1) / warps_per_cta, 256, 0,
                       stream>>>(b_vals, lengths, r_rows, k_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gust_spgemm_kernel<V, I><<<num_windows, kThreads, 0, stream>>>(
      static_cast<const V*>(m), static_cast<const I*>(col),
      static_cast<const I*>(row), block_starts, b_vals, b_cols, lengths, y, l,
      c_blk, k_max, n_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A's stream m/col/row (T*c_blk, l): vdt 0 float32, 1 bfloat16; idt 0
// int32, 1 int16.  B planes (r_rows, k_max) f32 / int32; lengths (r_rows,)
// int32 scratch; y (num_windows, l, n_out) f32, zeroed here.
int gust_spgemm(const void* m, const void* col, const void* row,
                const int* block_starts, const float* b_vals,
                const int* b_cols, int* lengths, float* y, int vdt, int idt,
                int num_windows, int l, int c_blk, int r_rows, int k_max,
                int n_out, void* stream) {
  if (l < 1 || l > 1024 || c_blk < 1 || num_windows < 1 || r_rows < 1 ||
      k_max < 1 || n_out < 1 || (long long)kPassSlots * k_max > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using gust::Type;
  auto go = [&](auto v, auto i) {
    return launch_typed<typename decltype(v)::type, typename decltype(i)::type>(
        m, col, row, block_starts, b_vals, b_cols, lengths, y, num_windows, l,
        c_blk, r_rows, k_max, n_out, s);
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
