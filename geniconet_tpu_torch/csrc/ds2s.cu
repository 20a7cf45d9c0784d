// The phase chain's stride-2 conv: both stride-2 convs of a DownBlock, whose
// outputs are emitted as the 4 parity phases of the level-(s-1) grid, and
// its two backward kernels (dx and dtaps), whose cotangents come as those
// phases.
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_ds2s (kernel body
// _ds2s_fwd_kernel) and the two pallas_calls of :_ds2s_bwd (_ds2s_dx_kernel,
// _ds2s_dtaps_kernel), the custom VJP of fused_dual_s2_conv_split, with the
// optional act prologue, BatchNorm [sum, sumsq] stats, in-kernel stats fold
// and Σg_eff bias gradient.
//
// Design. The Pallas kernels split the stride-2 output into phases in VMEM
// (_split4) and re-interleave the phase cotangents in VMEM (_interleave4)
// before delegating to the generic phase-conv bodies. On the card nothing is
// moved to do that: the split is addressing. Output row (chart, i, j) of tap
// set s goes to phase 2 * (i & 1) + (j & 1) at (chart, i >> 1, j >> 1),
// shifts and masks of the cell index (gn::split_row), as the grid sides are
// powers of two; the cotangents are read back by the same map (GLoad<T,
// true>, mma::SplitRows). So each of m's kernels is the phase conv's at
// output phase 2 with its rows placed or read by that map, and equals
// phase_conv_fwd (2,) + phase_split, or phase_conv_dx / phase_conv_dtaps on
// the phase_merge'd cotangents, bit for bit in both dtypes: outputs, stats,
// dx, d_mul/d_add, dtaps and Σg_eff.
// * forward, float32: the phase conv's SIMT GEMM (gn::conv_gemm over output
//   phase 2) with the split store; the stats partials come from the tile
//   before the store, in the GEMM's row order.
// * forward, bf16: the phase conv's tensor-core forward at output phase 2
//   (mma_conv_fwd.cuh): grid_operand_pass writes the act-applied operand of
//   the 4 input phases once (tag SplitGrid), pack_taps packs both tap sets
//   side by side, and gn::mma_conv runs over its rows with SplitFwdEpi, the
//   forward epilogue whose store places each row by split_row (a 128-row
//   tile spans chart seams, and at (4,8), M = 160, samples: the map is per
//   row; a row is still cout contiguous values, so the paired 4-byte stores
//   stay); [Σy, Σy²] come from the same rounded values in the same row-tile
//   order, then the fixed-order sum_rows.
// * dx, float32: the phase conv's SIMT dx tiles (gn::dx_tile over the
//   transposed table of output phase 2) with the split cotangent loader.
//   bf16: a's path: cot_operand_pass (mma.cuh) over the split loader writes
//   row m of the merged cotangent, folded once, from its phase (stride 2
//   has no combined rows), and a's dx GEMM runs over halo.phase_dx_codes of
//   output phase 2 with its tap masks and DxEpi, Σg_eff over the written
//   rows.
// * dtaps, float32: gn::dtaps_tile with the split loader. bf16: b's path:
//   grid_operand_pass writes the act-applied operand of the 4 input phases
//   once, and gn::mma_dtaps (mma_dtaps.cuh) runs at output phase 2 with its
//   G rows read from the parity phases (mma::SplitRows; one row is still
//   cout contiguous elements, so the 16-byte copies stay, and the stats fold
//   stays in the kernel), on b's split.
//
// What bounds it on the card: in bf16, the phase conv's tensor-core GEMMs
// (mma_conv_fwd.cuh and mma_dtaps.cuh say what bounds them: 2 * 7 * C_in *
// 2 * C_out FLOPs per level-(s-1) cell each, 11-21 GFLOP, 0.011-0.021 ms,
// a site at B=36 at 989 TFLOP/s) and the passes' bytes; the split map
// costs a few shifts per stored or loaded row. In float32 the FMA rate of
// the SIMT GEMM core.
#include <type_traits>

#include "mma_conv_fwd.cuh"
#include "mma_dtaps.cuh"

namespace {

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

template <typename T>
gn::GridLoad<T> grid_load(const void* const* x, const float* mul, const float* add, int h, int w,
                          int cin) {
  gn::GridLoad<T> ld = {};
  for (int p = 0; p < 4; ++p) ld.src[p] = static_cast<const T*>(x[p]);
  ld.mul = mul;
  ld.add = add;
  ld.hw = h * w;
  ld.hw5 = 5 * h * w;
  ld.cin = cin;
  ld.south_src = 3;
  return ld;
}

// float32: the SIMT GEMM with the split store; bf16: the phase conv's
// tensor-core forward at output phase 2 (b's operand pass into `operand`,
// the taps packed into `wpack`, mma_conv) with the split store in its
// epilogue (SplitFwdEpi), then the stats' fixed-order sum.
template <typename T>
cudaError_t fwd(const void* const* x, const float* mul, const float* add, const void* w0,
                const void* b0, const void* w1, const void* b1, void* const* outs,
                const int* table, float* stats_ws, float* const* stats, void* operand,
                void* wpack, int zero_poles, int B, int h, int w, int cin, int cout, int n_sets,
                cudaStream_t stream) {
  const gn::GridLoad<T> ld = grid_load<T>(x, mul, add, h, w, cin);
  if constexpr (std::is_same_v<T, float>) {
    gn::ConvOut<T> co = {};
    for (int i = 0; i < n_sets * 4; ++i) co.out[i] = static_cast<T*>(outs[i]);
    co.w[0] = static_cast<const T*>(w0);
    co.w[1] = static_cast<const T*>(w1);
    co.bias[0] = static_cast<const T*>(b0);
    co.bias[1] = static_cast<const T*>(b1);
    co.stats = stats_ws;
    co.split_lh = log2i(h);
    co.split_lw = log2i(w);
    return gn::launch_conv_gemm<T, gn::GridLoad<T>, true>(ld, co, table, B, 5 * h * w, cin, cout,
                                                          n_sets, 2, 1, stats, stream);
  } else {
    gn::FwdOut o = {};
    for (int i = 0; i < n_sets * 4; ++i) o.out[i / 4][i % 4] = static_cast<T*>(outs[i]);
    o.bias[0] = static_cast<const T*>(b0);
    o.bias[1] = static_cast<const T*>(b1);
    o.stats = stats_ws;
    return gn::launch_grid_mma_fwd<gn::SplitGrid, true>(
        ld, 4, table, 5 * h * w, o, static_cast<const T*>(w0), static_cast<const T*>(w1),
        static_cast<T*>(operand), static_cast<T*>(wpack), zero_poles, B, cout, n_sets, 2, 1,
        stats, stream, {log2i(h), log2i(w)});
  }
}

// float32: the SIMT gather-GEMM over the transposed table of output phase 2
// with the split loader; bf16: a's path (the cotangent pass reading the
// parity phases through the split loader, a's (2,) code table and tap
// masks, the tensor-core GEMM with a's epilogue, Σg_eff over the written
// rows).
template <typename T>
cudaError_t dx(const void* const* g, const void* const* y, const float* gs0, const float* gs1,
               const void* w0, const void* w1, const void* const* raw, const float* mul,
               const float* add, void* const* outs, const int* offsets, const int* cells,
               const float* weights, const gn::DxTables& tb, float* red, float* dmul,
               float* dadd, float* gsum_ws, float* gsum0, float* gsum1, int B, int h, int w,
               int cin, int cout, int n_sets, int gsum_rows, cudaStream_t stream) {
  const int M = 5 * h * w;
  const auto gl = gn::make_split_gload<T>(g, y, gs0, gs1, log2i(h), log2i(w), cout, n_sets);
  if constexpr (std::is_same_v<T, float>) {
    gn::DxOut<T> o = {};
    for (int p = 0; p < 4; ++p) {
      o.out[p] = static_cast<T*>(outs[p]);
      o.raw[p] = mul ? static_cast<const T*>(raw[p]) : nullptr;
    }
    o.mul = mul;
    o.add = add;
    o.red = red;
    o.per = M;
    cudaError_t err = gn::launch_dx_gemm<T>(gl, w0, w1, offsets, cells, weights, o, dmul, dadd,
                                            B, 4 * M, cin, n_sets, stream);
    if (err != cudaSuccess || gsum_ws == nullptr) return err;
    return gn::launch_gsum<T>(gl, B, n_sets, gsum_rows, gsum_ws, gsum0, gsum1, stream);
  } else {
    if (mul != nullptr && (raw == nullptr || red == nullptr)) return cudaErrorInvalidValue;
    gn::DxRows rows = {};
    for (int p = 0; p < 4; ++p) {
      rows.out[p] = static_cast<T*>(outs[p]);
      rows.raw[p] = mul ? static_cast<const T*>(raw[p]) : nullptr;
    }
    rows.mul = mul;
    rows.add = add;
    rows.red = red;
    rows.cin = cin;
    return gn::launch_grid_cot_dx<gn::SplitGrid>(gl, tb, rows, static_cast<const T*>(w0),
                                                 static_cast<const T*>(w1), gsum_ws, gsum0,
                                                 gsum1, dmul, dadd, B, n_sets, gsum_rows, stream);
  }
}

// float32: the SIMT GEMM over GridLoad and the split loader; bf16: b's
// operand pass into `operand` and b's tensor-core GEMM at output phase 2,
// its G rows read from the parity phases (mma::SplitRows). Σg_eff
// (gsum_ws) by launch_gsum over the split loader.
template <typename T>
cudaError_t dtaps(const void* const* x, const float* mul, const float* add,
                  const void* const* g, const void* const* y, const float* gs0, const float* gs1,
                  const int* table, float* ws, float* dt0, float* dt1, void* operand,
                  float* gsum_ws, float* gsum0, float* gsum1, int B, int h, int w, int cin,
                  int cout, int n_sets, int kc, int n_chunks, int gsum_rows, int zero_poles,
                  cudaStream_t stream) {
  const int M = 5 * h * w;
  const auto gl = gn::make_split_gload<T>(g, y, gs0, gs1, log2i(h), log2i(w), cout, n_sets);
  const gn::GridLoad<T> ld = grid_load<T>(x, mul, add, h, w, cin);
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    err = gn::launch_dtaps_gemm<T>(ld, gl, table, cin, n_sets, 2, B * M, kc, n_chunks, ws, dt0,
                                   dt1, stream);
  } else {
    // the 4 phase pointers of each set, row b * M + m of the merged grid by split_row
    const gn::GLoad<T> phases = gn::make_gload<T>(g, y, gs0, gs1, M, cout, n_sets, 4);
    const gn::SplitOut st = {{dt0, dt1}, n_sets * cout, cout};
    const gn::mma::SplitRows rows = {{4}, gl.lh, gl.lw};
    err = gn::launch_grid_mma_dtaps<gn::SplitGrid>(ld, 4, phases, rows, table, 2, 1,
                                                   static_cast<T*>(operand), zero_poles, B, cin,
                                                   n_sets, kc, n_chunks, ws, st, stream);
  }
  if (err != cudaSuccess || gsum_ws == nullptr) return err;
  return gn::launch_gsum<T>(gl, B, n_sets, gsum_rows, gsum_ws, gsum0, gsum1, stream);
}

// The split needs an icosahedral output grid (h a power of two, w = 2h)
// with parity phases: level s-1 >= 1.
bool bad_shape(int n_sets, int h, int w) {
  return n_sets < 1 || n_sets > 2 || h < 2 || (h & (h - 1)) != 0 || w != 2 * h;
}

}  // namespace

// x0..x3: the 4 input phases (B, 5, h, w, cin) of the level-s grid;
// act_mul/act_add: float32 (cin) or null; w0/w1: taps (7, cin, cout), b0/b1:
// bias (cout) or null (set 1 unused when n_sets == 1); outs: host array of
// n_sets * 4 output pointers, set-major, each a (B, 5, h/2, w/2, cout) phase
// of the (B, 5, h, w, cout) level-(s-1) output; table: int32 (4, 7, 5*h*w)
// from halo.phase_conv_table; stats_ws: null (no stats) or float32 scratch
// of the block partials, (B * ceil(5hw/64), 2 * n_sets * cout) in float32,
// (ceil(B * 5hw / 128), 2 * n_sets * cout) in bfloat16, and then st0/st1
// receive each set's (2, cout) [sum, sumsq]. bfloat16 only (else the call is
// refused): operand, scratch of (B * (4 * 5hw + 2) + 1, cin rounded up to 8)
// for the act-applied operand (zero_poles: corner_mode "zeros"); wpack, of
// (7 * cin rounded up to 32, n_sets * cout rounded up to 128) for the packed
// taps (gn_phase_conv_fwd's). dtype: 0 float32, 1 bfloat16.
extern "C" int gn_ds2s_fwd(const void* x0, const void* x1, const void* x2, const void* x3,
                           const float* act_mul, const float* act_add, const void* w0,
                           const void* b0, const void* w1, const void* b1, void* const* outs,
                           const int* table, float* stats_ws, float* st0, float* st1,
                           void* operand, void* wpack, int B, int h, int w, int cin, int cout,
                           int n_sets, int zero_poles, int dtype, void* stream) {
  if (bad_shape(n_sets, h, w)) return cudaErrorInvalidValue;
  const void* x[4] = {x0, x1, x2, x3};
  float* stats[2] = {st0, st1};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(x, act_mul, act_add, w0, b0, w1, b1, outs, table, stats_ws, stats, nullptr,
                      nullptr, zero_poles, B, h, w, cin, cout, n_sets, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, act_mul, act_add, w0, b0, w1, b1, outs, table, stats_ws, stats,
                              operand, wpack, zero_poles, B, h, w, cin, cout, n_sets, s);
  return cudaErrorInvalidValue;
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of m's bf16 forward GEMM (the phase conv's with the split
// store), with stats or without.
extern "C" int gn_ds2s_fwd_info(int stats, int* out) {
  return stats ? gn::mma_conv_fwd_info<gn::SplitGrid, true, true>(out)
               : gn::mma_conv_fwd_info<gn::SplitGrid, false, true>(out);
}

// g: host array of n_sets * 4 phase cotangent pointers (set-major), each
// (B, 5, h/2, w/2, cout); y: null (no fold) or the forward's output phases
// in the same order, with gs0/gs1 the sets' (2, cout) float32 stats
// cotangents; the rest as gn_phase_conv_dx with out_phases (2,) on the
// (B, 5, h, w, cout) merged cotangent: w0/w1 taps, raw/mul/add the act
// prologue (or null), outs the 4 dphases (B, 5, h, w, cin), dmul/dadd with
// act, gsum_ws/gsum0/gsum1 with the fold. float32: offsets/cells/weights,
// halo.phase_dx_table(h, w, mode, (2,)); red, with act, of (B *
// ceil(4*5hw/64), 2 * cin). bfloat16 (else the call is refused): codes,
// comb_offsets/comb_cells/comb_weights and tap_mask from
// halo.phase_dx_codes(h, w, mode, (2,)); operand, scratch of (B * (5hw +
// n_comb) + 1, n_sets * cout rounded up to 8); wpack, of (7 * (n_sets *
// cout rounded up to 32), cin rounded up to 128); red, with act, of
// (ceil(B * 4 * 5hw / 128), 2 * cin). dtype: 0 float32, 1 bfloat16.
extern "C" int gn_ds2s_dx(const void* const* g, const void* const* y, const float* gs0,
                          const float* gs1, const void* w0, const void* w1,
                          const void* const* raw, const float* mul, const float* add,
                          void* const* outs, const int* offsets, const int* cells,
                          const float* weights, const int* codes, const int* comb_offsets,
                          const int* comb_cells, const float* comb_weights,
                          const unsigned char* tap_mask, void* operand, void* wpack, float* red,
                          float* dmul, float* dadd, float* gsum_ws, float* gsum0, float* gsum1,
                          int B, int h, int w, int cin, int cout, int n_sets, int n_comb,
                          int gsum_rows, int dtype, void* stream) {
  if (bad_shape(n_sets, h, w)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const gn::DxTables tb = {codes, {comb_offsets, comb_cells, comb_weights, n_comb}, tap_mask,
                           static_cast<__nv_bfloat16*>(operand),
                           static_cast<__nv_bfloat16*>(wpack), 4};
  if (dtype == 0)
    return dx<float>(g, y, gs0, gs1, w0, w1, raw, mul, add, outs, offsets, cells, weights, tb,
                     red, dmul, dadd, gsum_ws, gsum0, gsum1, B, h, w, cin, cout, n_sets,
                     gsum_rows, s);
  if (dtype == 1)
    return dx<__nv_bfloat16>(g, y, gs0, gs1, w0, w1, raw, mul, add, outs, offsets, cells,
                             weights, tb, red, dmul, dadd, gsum_ws, gsum0, gsum1, B, h, w, cin,
                             cout, n_sets, gsum_rows, s);
  return cudaErrorInvalidValue;
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of m's bf16 dx GEMM (a's, over the cotangent written from
// the parity phases), with the act epilogue or without.
extern "C" int gn_ds2s_dx_info(int act, int* out) {
  return act ? gn::mma_conv_info<gn::SplitGrid, gn::DxEpi<true>>(out)
             : gn::mma_conv_info<gn::SplitGrid, gn::DxEpi<false>>(out);
}

// x: host array of the 4 raw input phases (B, 5, h, w, cin); mul/add: the
// act prologue or null; g, y, gs0, gs1: as in gn_ds2s_dx; table:
// halo.phase_conv_table; ws: float32 scratch of (n_chunks, 7 * cin,
// n_sets * cout), the B * 5hw rows split in chunks of kc (float32: a
// multiple of 16, build.dtaps_split; bfloat16: of 32, build.grid_dtaps_split,
// as phase_conv_dtaps); dt0/dt1 receive (7, cin, cout) float32; operand:
// bfloat16 only, scratch of (B * (4 * 5hw + 2) + 1, cin rounded up to 8)
// for the act-applied operand (zero_poles: corner_mode "zeros"); gsum_ws:
// null, or scratch of (ceil(B * 5hw / gsum_rows), n_sets * cout) with
// gsum0/gsum1 receiving Σg_eff. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_ds2s_dtaps(const void* const* x, const float* mul, const float* add,
                             const void* const* g, const void* const* y, const float* gs0,
                             const float* gs1, const int* table, float* ws, float* dt0,
                             float* dt1, void* operand, float* gsum_ws, float* gsum0,
                             float* gsum1, int B, int h, int w, int cin, int cout, int n_sets,
                             int kc, int n_chunks, int gsum_rows, int zero_poles, int dtype,
                             void* stream) {
  if (bad_shape(n_sets, h, w) || kc % gn::BK != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dtaps<float>(x, mul, add, g, y, gs0, gs1, table, ws, dt0, dt1, nullptr, gsum_ws, gsum0,
                        gsum1, B, h, w, cin, cout, n_sets, kc, n_chunks, gsum_rows, zero_poles,
                        s);
  if (dtype == 1)
    return dtaps<__nv_bfloat16>(x, mul, add, g, y, gs0, gs1, table, ws, dt0, dt1, operand,
                                gsum_ws, gsum0, gsum1, B, h, w, cin, cout, n_sets, kc, n_chunks,
                                gsum_rows, zero_poles, s);
  return cudaErrorInvalidValue;
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of m's bf16 dtaps GEMM (b's over split G rows), with the
// fold or without, on the NARROW tile (a C_in of at most 64) or the wide one.
extern "C" int gn_ds2s_dtaps_info(int narrow, int fold, int* out) {
  using Tag = gn::SplitGrid;
  using R = gn::mma::SplitRows;
  if (narrow)
    return fold ? gn::mma_dtaps_info<Tag, true, true, R>(out)
                : gn::mma_dtaps_info<Tag, false, true, R>(out);
  return fold ? gn::mma_dtaps_info<Tag, true, false, R>(out)
              : gn::mma_dtaps_info<Tag, false, false, R>(out);
}
