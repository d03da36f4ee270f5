// Double-buffered GUST SpMV on Hopper (sm_90a), resident x: y = M @ x over
// a packed color-block stream, the stream's slots brought into shared
// memory ahead of use by the Tensor Memory Accelerator.
//
// Replaces the TPU kernels
//   repro/kernels/gust_spmv.py::make_gust_spmv_db                (padded stream)
//   repro/kernels/gust_spmv_ragged.py::make_gust_spmv_ragged_db  (ragged stream)
// with their f32/bf16 bodies and their int8 bodies (_q: value = float(q) *
// scale_blk[t], scales on pack-time blocks).  Their segment-local twins
// (make_gust_spmv_local_db, make_gust_spmv_ragged_local_db) are ported in
// gust_spmv_local_db.cu.
//
// What they compute is what gust_spmv.cu computes (see its note), with the
// association of gust_spread.cuh, so on one artifact, for finite x, these
// kernels equal gust_spmv_padded / gust_spmv_ragged bitwise (single ==
// double), and the padded and ragged kernels equal each other.
//
// Design.  Padded (kernel 5, gust_spmv_db_padded) and ragged (kernel 7,
// gust_spmv_db_ragged) are the resident instance of gust_spread.cuh with a
// ring of two stream stages (see its note, item 5): the stream's blocks
// are spread over a persistent grid, a CTA's chunks of consecutive blocks
// come into shared memory through cp.async.bulk copies completing on one
// mbarrier per stage, chunk u + 2 asked for as soon as every thread has
// read chunk u, while the CTA sums chunk u + 1; each block's tile goes to
// a (T, l, B) scratch that a second kernel folds per window in stream
// order.  The TPU kernels' second buffer held the next block's stream
// tile; here the ring holds the next chunk's rows of the three leaves, and
// one thread's three copies replace every thread's three loads per slot.
// At B=1, and where a bulk copy cannot take the leaves (a row of l values
// or indices not a whole number of 16-byte runs, or a base pointer off 16
// bytes: odd l, int8 at l not a multiple of 16, int16 or bf16 at l not a
// multiple of 8), the same entry point runs the register-prefetch
// instance of kernels 1/2: at B=1 the ring's 48 KB of stages per CTA take
// the L1 that caches x, and the ring was slower on the card (PERF.md).
// gust_spmv_db_plan reports which instance runs (stream_stages 2 or 0).
// At l=256 and B=8 a ring CTA takes 56 KB of shared memory (f32 values,
// int32 indices).
//
// Bound.  Memory: each stream slot read once (value + column + row bytes),
// the scales and x once, y written once; the design adds its scratch
// (partial_bytes).  One multiply and one add per slot and vector column
// is far below the card's rate.

#include "gust_spread.cuh"

extern "C" {

// Padded stream: window w owns blocks w*bpw .. (w+1)*bpw of the t_blk =
// W*bpw blocks.  part is a (t_blk, l, b) f32 scratch, y is (W, l, b).
// vdt and idt: the dtype codes of gust::dispatch_dtypes.
int gust_spmv_db_padded(const void* m, const void* col, const void* row,
                        const float* scale, const float* x, float* y,
                        float* part, int vdt, int idt, int num_windows,
                        int t_blk, int blocks_per_window, int l, int c_blk,
                        int b, void* stream) {
  return spread<false, Gather::kResident, 0, 2>(
      m, col, row, nullptr, scale, x, y, part, nullptr, vdt, idt, num_windows,
      t_blk, blocks_per_window, l, c_blk, 0, b, stream);
}

// Ragged stream: window w owns blocks block_starts[w] .. block_starts[w+1]
// of the t_blk blocks.  part is a (t_blk, l, b) f32 scratch, y is (W, l, b).
int gust_spmv_db_ragged(const void* m, const void* col, const void* row,
                        const float* scale, const float* x, float* y,
                        float* part, const int* block_starts, int vdt, int idt,
                        int num_windows, int t_blk, int l, int c_blk, int b,
                        void* stream) {
  return spread<true, Gather::kResident, 0, 2>(
      m, col, row, nullptr, scale, x, y, part, block_starts, vdt, idt,
      num_windows, t_blk, 0, l, c_blk, 0, b, stream);
}

// The launch gust_spmv_db_padded and gust_spmv_db_ragged make: see
// spread_plan.
int gust_spmv_db_plan(const void* m, const void* col, const void* row, int vdt,
                      int idt, int t_blk, int l, int c_blk, int b, int* out) {
  return spread_plan<Gather::kResident, 0, 2>(m, col, row, vdt, idt, t_blk, l,
                                              c_blk, b, out);
}

const char* gust_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
