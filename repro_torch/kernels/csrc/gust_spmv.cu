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
// real slots of a cycle share a row.  Padding slots carry m == 0, row == 0,
// and collide with real slots on row 0 within a cycle, so slots whose value
// is 0 are skipped: exact for finite x (adding m*x == +-0 changes no sum).
// An int8 value that quantizes to 0 is skipped the same way.
//
// Design.  Both kernels, padded (kernel 1, gust_spmv_padded) and ragged
// (kernel 2, gust_spmv_ragged), are the resident, single-buffered instance
// of gust_spread.cuh (see its note for the association they keep, which
// makes them equal each other and every other kernel of the port bitwise).
// The stream's blocks are spread over a persistent grid, each block's
// (l, B) tile summed through a shared product buffer with two barriers a
// chunk of cycles and written to a (T, l, B) scratch, then each window's
// tiles folded in stream order by a second kernel, so no CTA walks the
// longest window alone and no CTA waits at a barrier per cycle.  Each slot
// reads x[col] directly; the next chunk's slots load into registers while
// this chunk sums.  At l=256 a CTA takes 8 KB of shared memory at B=1 and
// 32 KB at B=8.  The two layouts differ only in how the fold finds a
// window's blocks.
//
// Bound.  Memory: every stream slot is read once (value + column + row
// bytes), plus the scales, x and y; the design adds its scratch
// (partial_bytes).  The arithmetic (one multiply and one add per slot and
// vector column) is far below the card's rate.

#include "gust_spread.cuh"

extern "C" {

// Padded stream: window w owns blocks w*bpw .. (w+1)*bpw of the t_blk =
// W*bpw blocks.  part is a (t_blk, l, b) f32 scratch, y is (W, l, b).
// vdt and idt: the dtype codes of gust::dispatch_dtypes.
int gust_spmv_padded(const void* m, const void* col, const void* row,
                     const float* scale, const float* x, float* y, float* part,
                     int vdt, int idt, int num_windows, int t_blk,
                     int blocks_per_window, int l, int c_blk, int b,
                     void* stream) {
  return spread<false, Gather::kResident, 0, 0>(
      m, col, row, nullptr, scale, x, y, part, nullptr, vdt, idt, num_windows,
      t_blk, blocks_per_window, l, c_blk, 0, b, stream);
}

// Ragged stream: window w owns blocks block_starts[w] .. block_starts[w+1]
// of the t_blk blocks.  part is a (t_blk, l, b) f32 scratch, y is (W, l, b).
int gust_spmv_ragged(const void* m, const void* col, const void* row,
                     const float* scale, const float* x, float* y, float* part,
                     const int* block_starts, int vdt, int idt,
                     int num_windows, int t_blk, int l, int c_blk, int b,
                     void* stream) {
  return spread<true, Gather::kResident, 0, 0>(
      m, col, row, nullptr, scale, x, y, part, block_starts, vdt, idt,
      num_windows, t_blk, 0, l, c_blk, 0, b, stream);
}

// The launch gust_spmv_padded and gust_spmv_ragged make: see spread_plan.
int gust_spmv_plan(const void* m, const void* col, const void* row, int vdt,
                   int idt, int t_blk, int l, int c_blk, int b, int* out) {
  return spread_plan<Gather::kResident, 0, 0>(m, col, row, vdt, idt, t_blk, l,
                                              c_blk, b, out);
}

const char* gust_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
