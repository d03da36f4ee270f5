// Segment-local, double-buffered GUST SpMV on Hopper (sm_90a): y = M @ x
// over a packed color-block stream whose blocks read x only through their
// pack-time segment tables, each block's x tiles staged one block ahead.
//
// Replaces the TPU kernels
//   repro/kernels/gust_spmv.py::make_gust_spmv_local_db               (padded stream)
//   repro/kernels/gust_spmv_ragged.py::make_gust_spmv_ragged_local_db (ragged stream)
// with their f32/bf16 bodies and their int8 bodies (_q: value = float(q) *
// scale_blk[t], scales on pack-time blocks).
//
// Design: the two-stage instance of gust_spread.cuh (see its note):
// the stream's blocks spread over a persistent grid, each block's tile
// written to a (T, l, B) scratch and folded per window in stream order;
// block t+1's x tiles (up to a cap of 16 at l=256 and B=1, 2 at B=8) and
// block t+2's table row are copied with cp.async while block t computes,
// and a chunk's cycles run with two barriers.  At l=256 and B=1 a CTA
// takes 40 KB and up to 64 registers a thread, and the registers allow 4
// CTAs per SM; at B=8 its 64 KB allow 3 (the occupancy calculator's count,
// which gust_spmv_local_db_plan returns and chip_smoke.py prints).
//
// Bound: the stream's bytes, as gust_spread.cuh says, plus the
// scratch (partial_bytes) and the x-tile L2 re-reads (x_tile_bytes).
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W; crankseg_2 with
// load_balance=False; PERF.md): at f32 B=1 kernel 6 0.147 ms (bound 0.103,
// kernel 5 0.123, the one-CTA-per-window design this replaced 0.435) and
// kernel 8 0.101 ms (bound 0.066, kernel 7 0.112, before 0.427); at B=8
// 0.454 / 0.326 ms.  Of kernel 6's time at B=1 the fold takes 9 us;
// dropping the products saves 3%, dropping the scratch write 7%, dropping
// the tile staging costs 19% (python -m repro_torch.kernels.local_db_sweep):
// what remains is the stream's loads, at about 2.5 TB/s.

#include "gust_spread.cuh"

extern "C" {

// Padded stream: window w owns blocks w*bpw .. (w+1)*bpw of the t_blk =
// W*bpw blocks; col_loc and seg_blk (t_blk, s_blk) int32 in place of the
// columns.  part is a (t_blk, l, b) f32 scratch, y is (W, l, b).
int gust_spmv_local_db_padded(const void* m, const void* col_loc,
                              const void* row, const int* seg_blk,
                              const float* scale, const float* x, float* y,
                              float* part, int vdt, int idt, int num_windows,
                              int t_blk, int blocks_per_window, int l,
                              int c_blk, int s_blk, int b, void* stream) {
  return spread<false, Gather::kLocal, 2, 0>(
      m, col_loc, row, seg_blk, scale, x, y, part, nullptr, vdt, idt,
      num_windows, t_blk, blocks_per_window, l, c_blk, s_blk, b, stream);
}

// Ragged stream: window w owns blocks block_starts[w] .. block_starts[w+1]
// of the t_blk blocks.
int gust_spmv_local_db_ragged(const void* m, const void* col_loc,
                              const void* row, const int* seg_blk,
                              const float* scale, const float* x, float* y,
                              float* part, const int* block_starts, int vdt,
                              int idt, int num_windows, int t_blk, int l,
                              int c_blk, int s_blk, int b, void* stream) {
  return spread<true, Gather::kLocal, 2, 0>(
      m, col_loc, row, seg_blk, scale, x, y, part, block_starts, vdt, idt,
      num_windows, t_blk, 0, l, c_blk, s_blk, b, stream);
}

// The launch either entry point makes: see spread_plan.
int gust_spmv_local_db_plan(const void* m, const void* col_loc,
                            const void* row, int vdt, int idt,
                            int t_blk, int l, int c_blk, int b, int* out) {
  return spread_plan<Gather::kLocal, 2, 0>(m, col_loc, row, vdt, idt, t_blk,
                                           l, c_blk, b, out);
}

const char* gust_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
