// Segment-local GUST SpMV on Hopper (sm_90a), single-buffered: y = M @ x
// over a packed color-block stream whose blocks read x only through their
// pack-time segment tables, each block's x tiles copied at the block's own
// top.
//
// Replaces the TPU kernels
//   repro/kernels/gust_spmv.py::make_gust_spmv_local               (padded stream)
//   repro/kernels/gust_spmv_ragged.py::make_gust_spmv_ragged_local (ragged stream)
// with their f32/bf16 bodies (_local_kernel) and int8 bodies
// (_local_kernel_q: value = float(q) * scale_blk[t]).
//
// Design: the one-stage instance of gust_spread.cuh (see its note),
// the block kernel and fold of the double-buffered kernels 6/8
// (gust_spmv_local_db.cu) with one x-tile stage.  The stream's blocks are
// spread over a persistent grid, each block's tile written to a (T, l, B)
// scratch and folded per window in stream order, so no CTA walks the
// longest window alone.  At the top of block t the CTA copies block t's
// tiles (up to a cap of 16 at l=256 and B=1, 2 at B=8) into the stage with
// cp.async, together with block t+1's table row, while block t's first
// slots are already loading into registers; it waits once, and the chunk's
// cycles run with two barriers.  No block copies its tiles in passes, and
// no tile is copied ahead of its block: while a CTA waits for its tiles,
// the other CTAs on its SM compute.  At l=256 a CTA takes 24 KB at B=1
// and 48 KB at B=8, and up to 64 registers a thread: 4 CTAs per SM.
//
// Bound: the stream's bytes, as gust_spread.cuh says, plus the
// scratch (partial_bytes) and the x-tile L2 re-reads (x_tile_bytes).
// Unlike kernels 6/8, a block's tile copies are not hidden behind the block
// before it: each block waits once for an L2 round trip.
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W; crankseg_2 with
// load_balance=False; PERF.md): at f32 B=1 kernel 3 0.148 ms (bound 0.103,
// cuSPARSE 0.054, the one-CTA-per-window design this replaced 0.237) and
// kernel 4 0.103 ms (bound 0.066, before 0.199), within 3% of kernels 6/8;
// at B=8 0.443 / 0.319 ms (before 2.16 / 2.06, cuSPARSE 0.543).  Of kernel
// 3's time at B=1 the fold takes 9 us; reading every slot's x directly
// instead of staging the tiles costs 15-32% at B=1 (python -m
// repro_torch.kernels.local_db_sweep).

#include "gust_spread.cuh"

extern "C" {

// Padded stream: window w owns blocks w*bpw .. (w+1)*bpw of the t_blk =
// W*bpw blocks; col_loc and seg_blk (t_blk, s_blk) int32 in place of the
// columns.  part is a (t_blk, l, b) f32 scratch, y is (W, l, b).
int gust_spmv_local_padded(const void* m, const void* col_loc, const void* row,
                           const int* seg_blk, const float* scale,
                           const float* x, float* y, float* part, int vdt,
                           int idt, int num_windows, int t_blk,
                           int blocks_per_window, int l, int c_blk, int s_blk,
                           int b, void* stream) {
  return spread<false, Gather::kLocal, 1, 0>(
      m, col_loc, row, seg_blk, scale, x, y, part, nullptr, vdt, idt,
      num_windows, t_blk, blocks_per_window, l, c_blk, s_blk, b, stream);
}

// Ragged stream: window w owns blocks block_starts[w] .. block_starts[w+1]
// of the t_blk blocks.
int gust_spmv_local_ragged(const void* m, const void* col_loc, const void* row,
                           const int* seg_blk, const float* scale,
                           const float* x, float* y, float* part,
                           const int* block_starts, int vdt, int idt,
                           int num_windows, int t_blk, int l, int c_blk,
                           int s_blk, int b, void* stream) {
  return spread<true, Gather::kLocal, 1, 0>(
      m, col_loc, row, seg_blk, scale, x, y, part, block_starts, vdt, idt,
      num_windows, t_blk, 0, l, c_blk, s_blk, b, stream);
}

// The launch either entry point makes: see spread_plan.
int gust_spmv_local_plan(const void* m, const void* col_loc,
                         const void* row, int vdt, int idt,
                         int t_blk, int l, int c_blk, int b, int* out) {
  return spread_plan<Gather::kLocal, 1, 0>(m, col_loc, row, vdt, idt, t_blk,
                                           l, c_blk, b, out);
}

const char* gust_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
