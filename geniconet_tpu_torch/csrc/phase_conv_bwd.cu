// Phase-form hex conv, backward: dx (input cotangent) and dtaps (tap
// cotangents summed over the batch), for both output-phase modes (all 4
// phases, and phase 2 alone for stride 2), as two kernels (the split route)
// or as one merged kernel.
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_phase_conv_dx (kernel
// body _pc_dx_kernel) and :_phase_conv_dtaps (_pc_dtaps_kernel), as called
// by the custom VJPs of fused_phase_conv_s1 and fused_dual_s2_conv,
// including the in-kernel BatchNorm stats fold and the Σg_eff bias gradient;
// and, as gn_phase_conv_bwd, :_phase_conv_bwd (_pc_bwd_kernel), the merged
// one-pass backward of GENICONET_MERGED_BWD's pcs1 and ds2 families.
//
// Design. The Pallas dx kernel scatters each tap's contribution into padded
// VMEM buffers and runs the exact adjoint of the halo pad. Blocks on the card
// run in no order, so dx is instead a gather: the transposed halo table
// (halo.phase_dx_table) lists, for each source cell and tap, the output cells
// that read it with their weights (0.2 for pole means). In float32 each
// operand element of the SIMT dx GEMM sums those rows of g (gn::dx_gemm); in
// bf16 a pass writes the folded cotangent once, with a sample's combined rows
// (a row whose transposed entries are not one weight-1 read: its weighted sum
// rounded once), and the forward's tensor-core GEMM runs transposed over the
// rows that halo.phase_dx_codes names, the act adjoint in its epilogue
// (mma_conv_fwd.cuh, point 5, which also says what bounds it; a stride-2
// row tile skips the taps it does not read). No atomics: dx, d_mul/d_add
// and Σg are deterministic (d_mul/d_add and Σg through block partials and a
// fixed-order second pass; in bf16 Σg sums the written cotangent rows in
// launch_gsum's order, the values the fold gave). dtaps reduces over the
// B * n_out * 5hw rows in
// chunks, whose partials a second pass sums: in float32 it re-gathers the
// forward operand through the forward table (act prologue and pole means
// included) on the SIMT core; in bf16 it writes that operand once (the
// act-applied phases and each sample's two pole rows) and runs gn::mma_dtaps
// on the tensor cores over its gathered rows (mma_dtaps.cuh, which also says
// what bounds it; a C_in of at most 64, conv_in's 3 and the 64 of up2's
// conv01 and down0's stride-2 conv, takes its NARROW tile).
//
// What bounds float32 dx and dtaps on the card: like the forward, the
// float32 FMA rate of the SIMT GEMM core (2 * 7 * C_in * C_out FLOPs per
// output cell each); the dx operand gather reads about 1.05 rows of g per
// element (the halo and pole rows), and dtaps writes 7 * C_in * C_out floats
// per chunk.
//
// The merged kernel (gn_phase_conv_bwd) computes every output of
// _pc_bwd_kernel: dx with the act adjoint and the d_mul/d_add partials,
// the dtaps over the activated input, and Σg_eff. In float32 it is
// gn::merged_bwd (backward.cuh): dx tiles and dtaps tiles by block index in
// one SIMT launch, Σg_eff from the g tiles the first row tile's dtaps tiles
// hold (no colsum pass), then the fixed-order sum_rows passes; the two
// roles each read and fold g. In bf16 it is the split route's device code
// over ONE folded cotangent, as the TPU kernel folds once per g tile for
// both roles: a's cot_operand_pass writes g_eff once (with the combined
// rows of out_phases' code table), b's grid_operand_pass the act-applied
// input once, the taps are packed transposed, then one launch runs both
// GEMMs by block index (gn::mma_bwd, mma_merged_bwd.cuh): b's dtaps tiles
// first, their G rows read from the written cotangent (mma::WrittenRows: no
// fold in the GEMM; b's NARROW tile at a C_in of at most 64), and a's dx
// tiles around them, with a's tap masks (stride 2: B * 4 * 5hw dx rows over
// B * 5hw written rows) and a's DxEpi, whose d_mul/d_add partials take the
// dx tile's own row; then a's d_mul/d_add sum, b's fixed-order chunk sum
// and Σg_eff over the written rows. dx, d_mul/d_add and Σg_eff are a's passes, dtaps is
// b's GEMM over the same bf16 g_eff values (cot8 and b's shared-memory fold
// both round fold_geff once) on b's split: the outputs equal the split
// route's (phase_conv_dx + phase_conv_dtaps) bit for bit. What bounds it:
// the two GEMMs' tensor-core steps (mma_conv_fwd.cuh, mma_dtaps.cuh; b's
// without its fold) and the passes' bytes (the cotangent and the operand
// written once each).
#include <type_traits>

#include "mma_merged_bwd.cuh"

namespace {

template <typename T>
cudaError_t dx(const void* const* g, const void* const* y, const float* gs0, const float* gs1,
               const void* w0, const void* w1, const void* const* raw, const float* mul,
               const float* add, void* const* outs, const int* offsets, const int* cells,
               const float* weights, const gn::DxTables& tb, float* red, float* dmul, float* dadd,
               float* gsum_ws, float* gsum0, float* gsum1, int B, int h, int w, int cin, int cout,
               int n_sets, int n_out, int gsum_rows, cudaStream_t stream) {
  const int M = 5 * h * w;
  const gn::GLoad<T> gl = gn::make_gload<T>(g, y, gs0, gs1, M, cout, n_sets, n_out);
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
    // the folded cotangent written once, then the tensor-core GEMM over its
    // rows named by the code table (mma_conv_fwd.cuh), the act adjoint in
    // its epilogue
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
    return gn::launch_grid_cot_dx<gn::PhaseGrid>(gl, tb, rows, static_cast<const T*>(w0),
                                                 static_cast<const T*>(w1), gsum_ws, gsum0, gsum1,
                                                 dmul, dadd, B, n_sets, gsum_rows, stream);
  }
}

// The 4 input phases with their act prologue, as the forward reads them.
template <typename T>
gn::GridLoad<T> phase_load(const void* const* x, const float* mul, const float* add, int h,
                           int w, int cin) {
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

// float32: the SIMT GEMM over GridLoad; bf16: the operand pass into
// `operand`, then the tensor-core GEMM. Σg_eff (gsum_ws) by launch_gsum.
template <typename T>
cudaError_t dtaps(const void* const* x, const float* mul, const float* add,
                  const void* const* g, const void* const* y, const float* gs0, const float* gs1,
                  const int* table, float* ws, float* dt0, float* dt1, void* operand,
                  float* gsum_ws, float* gsum0, float* gsum1, int B, int h, int w, int cin,
                  int cout, int n_sets, int out_phase0, int n_out, int kc, int n_chunks,
                  int gsum_rows, int zero_poles, cudaStream_t stream) {
  const int M = 5 * h * w;
  const gn::GLoad<T> gl = gn::make_gload<T>(g, y, gs0, gs1, M, cout, n_sets, n_out);
  const gn::GridLoad<T> ld = phase_load<T>(x, mul, add, h, w, cin);
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    err = gn::launch_dtaps_gemm<T>(ld, gl, table, cin, n_sets, out_phase0, B * n_out * M, kc,
                                   n_chunks, ws, dt0, dt1, stream);
  } else {
    const gn::SplitOut st = {{dt0, dt1}, n_sets * cout, cout};
    err = gn::launch_grid_mma_dtaps<gn::PhaseGrid>(ld, 4, gl, table, out_phase0, n_out,
                                                   static_cast<T*>(operand), zero_poles, B, cin,
                                                   n_sets, kc, n_chunks, ws, st, stream);
  }
  if (err != cudaSuccess || gsum_ws == nullptr) return err;
  return gn::launch_gsum<T>(gl, B, n_sets, gsum_rows, gsum_ws, gsum0, gsum1, stream);
}

// float32: gn::merged_bwd, the SIMT tiles of both roles in one launch
cudaError_t merged(const void* const* x, const float* mul, const float* add,
                   const void* const* g, const void* const* y, const float* gs0, const float* gs1,
                   const void* w0, const void* w1, void* const* outs, const int* offsets,
                   const int* cells, const float* weights, const int* table, float* red,
                   float* dmul, float* dadd, float* ws, float* dt0, float* dt1, float* gpart,
                   float* gsum0, float* gsum1, int B, int h, int w, int cin, int cout,
                   int n_sets, int out_phase0, int n_out, int kc, int n_chunks,
                   cudaStream_t stream) {
  const int M = 5 * h * w;
  const gn::GLoad<float> gl = gn::make_gload<float>(g, y, gs0, gs1, M, cout, n_sets, n_out);
  gn::DxOut<float> o = {};
  for (int p = 0; p < 4; ++p) {
    o.out[p] = static_cast<float*>(outs[p]);
    o.raw[p] = mul ? static_cast<const float*>(x[p]) : nullptr;
  }
  o.mul = mul;
  o.add = add;
  o.red = red;
  o.per = M;
  const gn::SplitOut dt = {{dt0, dt1}, n_sets * cout, cout};
  return gn::launch_merged_bwd<float>(gl, w0, w1, offsets, cells, weights, o, dmul, dadd, B,
                                      4 * M, phase_load<float>(x, mul, add, h, w, cin), table,
                                      out_phase0, kc, n_chunks, ws, dt, gpart, gsum0, gsum1, cin,
                                      n_sets, stream);
}

// bf16: the folded cotangent written once (a's pass, with the combined rows
// of tb), the act-applied input written once (b's pass, into `operand`),
// the taps packed transposed, both GEMMs in one launch (gn::mma_bwd),
// then a's d_mul/d_add sum (with the act), the dtaps chunks' fixed-order
// sum (b's: sum_chunks, or sum_rows past 32 chunks) and Σg_eff over the
// written rows (CotRowsG, as a).
cudaError_t merged_mma(const void* const* x, const float* mul, const float* add,
                       const gn::GLoad<__nv_bfloat16>& gl, const void* w0, const void* w1,
                       void* const* outs, const gn::DxTables& tb, const int* table,
                       __nv_bfloat16* operand, float* red, float* dmul, float* dadd, float* ws,
                       float* dt0, float* dt1, float* gsum_ws, float* gsum0, float* gsum1, int B,
                       int h, int w, int cin, int n_sets, int out_phase0, int n_out, int kc,
                       int n_chunks, int gsum_rows, int zero_poles, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  using Tag = gn::MergedPhase;
  const int M = 5 * h * w, cout = gl.cout, Ntot = n_sets * cout;
  if (tb.codes == nullptr || tb.operand == nullptr || tb.wpack == nullptr ||
      operand == nullptr || gsum_ws == nullptr || (mul != nullptr && red == nullptr) ||
      kc % gn::mma::BK != 0 || (tb.mask != nullptr && (4 * M) % gn::fwd::BM != 0))
    return cudaErrorInvalidValue;
  cudaError_t err = gn::launch_cot_operand<Tag>(gl, tb.comb, tb.operand, B, n_sets, stream);
  if (err != cudaSuccess) return err;
  err = gn::launch_grid_operand<bf16, Tag>(phase_load<bf16>(x, mul, add, h, w, cin), operand, B,
                                           4, zero_poles, stream);
  if (err != cudaSuccess) return err;
  err = gn::launch_pack_taps_t<Tag>(static_cast<const bf16*>(w0), static_cast<const bf16*>(w1),
                                    tb.wpack, cin, cout, n_sets, stream);
  if (err != cudaSuccess) return err;
  const bool narrow = gn::mma_narrow(cin);
  const gn::MmaBwd a = gn::mma_bwd_args(gn::operand_rows(operand, table, B, M, cin, 4, M), gl, tb, B,
                                        cin, n_sets, out_phase0, n_out, narrow, kc, n_chunks, ws);
  gn::DxRows rows = {};
  for (int p = 0; p < 4; ++p) {
    rows.out[p] = static_cast<bf16*>(outs[p]);
    rows.raw[p] = mul ? static_cast<const bf16*>(x[p]) : nullptr;
  }
  rows.mul = mul;
  rows.add = add;
  rows.red = red;
  rows.cin = cin;
  using Act = gn::DxEpi<true>;
  using NoAct = gn::DxEpi<false>;
  err = narrow ? (mul ? gn::launch_mma_bwd<Tag, true>(a, Act{rows}, stream)
                      : gn::launch_mma_bwd<Tag, true>(a, NoAct{rows}, stream))
               : (mul ? gn::launch_mma_bwd<Tag, false>(a, Act{rows}, stream)
                      : gn::launch_mma_bwd<Tag, false>(a, NoAct{rows}, stream));
  if (err != cudaSuccess) return err;
  if (mul != nullptr) {
    const gn::SplitOut st = {{dmul, dadd}, 2 * cin, cin};
    err = gn::launch_sum_rows(red, gn::fwd_row_tiles(a.Qx), 2LL * cin, st, stream);
    if (err != cudaSuccess) return err;
  }
  const gn::SplitOut st = {{dt0, dt1}, Ntot, cout};
  const long long C = 7LL * cin * Ntot;
  if (n_chunks > 32) {
    err = gn::launch_sum_rows(ws, n_chunks, C, st, stream);
  } else {
    gn::sum_chunks<gn::SplitOut><<<(unsigned)((C + 255) / 256), 256, 0, stream>>>(ws, n_chunks,
                                                                                   C, st);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const gn::CotRowsG cg = {tb.operand, M, n_out, cout, a.cot.per_b, a.cot.ldk};
  return gn::launch_gsum<bf16>(cg, B, n_sets, gsum_rows, gsum_ws, gsum0, gsum1, stream);
}

bool bad_sets(int n_sets, int n_out) {
  return n_sets < 1 || n_sets > 2 || (n_out != 1 && n_out != 4);
}

}  // namespace

// g: host array of n_sets * n_out cotangent pointers (set-major), each
// (B, 5, h, w, cout); y: null (no fold) or the forward outputs in the same
// order, with gs0/gs1 the sets' (2, cout) float32 stats cotangents; w0/w1:
// taps (7, cin, cout); raw: null (no act) or a host array of the 4 raw input
// phases, with mul/add float32 (cin); outs: host array of the 4 dphase
// outputs (B, 5, h, w, cin). float32: offsets/cells/weights,
// halo.phase_dx_table for these output phases; red, with act, float32
// scratch of (B * ceil(4*5hw/64), 2 * cin). bfloat16 (else the call is
// refused): codes, comb_offsets/comb_cells/comb_weights (n_comb combined
// rows a sample) and tap_mask (null, or a byte per 128 rows of one
// sample's 4 * 5hw) from halo.phase_dx_codes; operand, scratch of (B *
// (n_out * 5hw + n_comb) + 1, n_sets * cout rounded up to 8); wpack, of
// (7 * (n_sets * cout rounded up to 32), cin rounded up to 128); red, with
// act, float32 scratch of (ceil(B * 4 * 5hw / 128), 2 * cin). dmul/dadd
// receive (cin) each with act; gsum_ws: with the fold, scratch of
// (ceil(B * n_out * 5hw / gsum_rows), n_sets * cout) and gsum0/gsum1
// receive Σg_eff (cout). dtype: 0 float32, 1 bfloat16.
extern "C" int gn_phase_conv_dx(const void* const* g, const void* const* y, const float* gs0,
                                const float* gs1, const void* w0, const void* w1,
                                const void* const* raw, const float* mul, const float* add,
                                void* const* outs, const int* offsets, const int* cells,
                                const float* weights, const int* codes, const int* comb_offsets,
                                const int* comb_cells, const float* comb_weights,
                                const unsigned char* tap_mask, void* operand, void* wpack,
                                float* red, float* dmul, float* dadd, float* gsum_ws,
                                float* gsum0, float* gsum1, int B, int h, int w, int cin,
                                int cout, int n_sets, int n_out, int n_comb, int gsum_rows,
                                int dtype, void* stream) {
  if (bad_sets(n_sets, n_out)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const gn::DxTables tb = {codes, {comb_offsets, comb_cells, comb_weights, n_comb}, tap_mask,
                           static_cast<__nv_bfloat16*>(operand),
                           static_cast<__nv_bfloat16*>(wpack), 4};
  if (dtype == 0)
    return dx<float>(g, y, gs0, gs1, w0, w1, raw, mul, add, outs, offsets, cells, weights, tb,
                     red, dmul, dadd, gsum_ws, gsum0, gsum1, B, h, w, cin, cout, n_sets, n_out,
                     gsum_rows, s);
  if (dtype == 1)
    return dx<__nv_bfloat16>(g, y, gs0, gs1, w0, w1, raw, mul, add, outs, offsets, cells,
                             weights, tb, red, dmul, dadd, gsum_ws, gsum0, gsum1, B, h, w, cin,
                             cout, n_sets, n_out, gsum_rows, s);
  return cudaErrorInvalidValue;
}

// x: host array of the 4 raw input phases (B, 5, h, w, cin); mul/add: the
// act prologue or null; g, y, gs0, gs1: as in gn_phase_conv_dx; table:
// halo.phase_conv_table; output phases out_phase0 .. +n_out-1; ws: float32
// scratch of (n_chunks, 7 * cin, n_sets * cout), the rows B * n_out * 5hw
// split in chunks of kc (float32: a multiple of 16, build.dtaps_split;
// bfloat16: of 32, build.grid_dtaps_split); dt0/dt1 receive (7, cin, cout)
// float32; operand: bfloat16 only, scratch of (B * (4 * 5hw + 2) + 1, cin
// rounded up to 8) for the act-applied operand (zero_poles: corner_mode
// "zeros", whose poles are 0); gsum_ws: null, or as in gn_phase_conv_dx for
// Σg_eff. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_phase_conv_dtaps(const void* const* x, const float* mul, const float* add,
                                   const void* const* g, const void* const* y, const float* gs0,
                                   const float* gs1, const int* table, float* ws, float* dt0,
                                   float* dt1, void* operand, float* gsum_ws, float* gsum0,
                                   float* gsum1, int B, int h, int w, int cin, int cout,
                                   int n_sets, int out_phase0, int n_out, int kc, int n_chunks,
                                   int gsum_rows, int zero_poles, int dtype, void* stream) {
  if (bad_sets(n_sets, n_out) || out_phase0 + n_out > 4 || kc % gn::BK != 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dtaps<float>(x, mul, add, g, y, gs0, gs1, table, ws, dt0, dt1, nullptr, gsum_ws,
                        gsum0, gsum1, B, h, w, cin, cout, n_sets, out_phase0, n_out, kc, n_chunks,
                        gsum_rows, zero_poles, s);
  if (dtype == 1)
    return dtaps<__nv_bfloat16>(x, mul, add, g, y, gs0, gs1, table, ws, dt0, dt1, operand,
                                gsum_ws, gsum0, gsum1, B, h, w, cin, cout, n_sets, out_phase0,
                                n_out, kc, n_chunks, gsum_rows, zero_poles, s);
  return cudaErrorInvalidValue;
}

// The grid convs' operand alone (the first launch of their bf16 dtaps): x:
// host array of n_src sources (4 phases, or 1 standard grid), each (B, 5, h,
// w, cin); mul/add: the act prologue or null; out: (B * (n_src * 5hw + 2) +
// 1, cin rounded up to 8) in x's dtype (zero_poles: corner_mode "zeros").
// dtype: 0 float32, 1 bfloat16.
extern "C" int gn_grid_operand(const void* const* x, const float* mul, const float* add,
                               void* out, int B, int h, int w, int cin, int n_src, int zero_poles,
                               int dtype, void* stream) {
  if (n_src != 1 && n_src != 4) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const void* src[4] = {x[0], x[0], x[0], x[0]};
  for (int p = 0; p < n_src; ++p) src[p] = x[p];
  if (dtype == 0) {
    gn::GridLoad<float> ld = phase_load<float>(src, mul, add, h, w, cin);
    ld.south_src = n_src - 1;
    return gn::launch_grid_operand<float, gn::PhaseGrid>(ld, static_cast<float*>(out), B, n_src,
                                                         zero_poles, s);
  }
  if (dtype == 1) {
    gn::GridLoad<__nv_bfloat16> ld = phase_load<__nv_bfloat16>(src, mul, add, h, w, cin);
    ld.south_src = n_src - 1;
    return gn::launch_grid_operand<__nv_bfloat16, gn::PhaseGrid>(
        ld, static_cast<__nv_bfloat16*>(out), B, n_src, zero_poles, s);
  }
  return cudaErrorInvalidValue;
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of a's tensor-core dx GEMM, with the act epilogue or
// without.
extern "C" int gn_phase_conv_dx_info(int act, int* out) {
  return act ? gn::mma_conv_info<gn::PhaseGrid, gn::DxEpi<true>>(out)
             : gn::mma_conv_info<gn::PhaseGrid, gn::DxEpi<false>>(out);
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of b's tensor-core GEMM, with the fold or without, on the
// NARROW tile (a C_in of at most 64) or the wide one.
extern "C" int gn_phase_conv_dtaps_info(int narrow, int fold, int* out) {
  using Tag = gn::PhaseGrid;
  if (narrow)
    return fold ? gn::mma_dtaps_info<Tag, true, true>(out)
                : gn::mma_dtaps_info<Tag, false, true>(out);
  return fold ? gn::mma_dtaps_info<Tag, true>(out) : gn::mma_dtaps_info<Tag, false>(out);
}

// The merged backward (_phase_conv_bwd). x: host array of the 4 raw input
// phases (B, 5, h, w, cin); mul/add: the act prologue or null (with it, dx
// is the raw input's cotangent and dmul/dadd receive (cin) each, through
// red); g, y, gs0, gs1: as in gn_phase_conv_dx; w0/w1: taps (7, cin,
// cout); outs: host array of the 4 dphase outputs (B, 5, h, w, cin);
// table: halo.phase_conv_table; ws: float32 scratch of (n_chunks, 7 * cin,
// n_sets * cout), the rows B * n_out * 5hw of output phases out_phase0 ..
// +n_out-1 split in chunks of kc; dt0/dt1 receive (7, cin, cout) float32
// and gsum0/gsum1 Σg_eff (cout). float32: offsets/cells/weights,
// halo.phase_dx_table for these output phases; red of (B * ceil(4*5hw/64),
// 2 * cin); kc a multiple of 16 (build.merged_scratch); gpart, float32
// scratch of (n_chunks, n_sets * cout); the bf16 arguments null. bfloat16
// (else the call is refused): the bf16 arguments of gn_phase_conv_dx
// (codes .. tap_mask, operand, wpack, red; n_comb) and of
// gn_phase_conv_dtaps (grid_operand; kc a multiple of 32,
// build.grid_dtaps_split; zero_poles); gpart, float32 scratch of
// (ceil(B * n_out * 5hw / gsum_rows), n_sets * cout) for Σg_eff's pass.
// dtype: 0 float32, 1 bfloat16.
extern "C" int gn_phase_conv_bwd(const void* const* x, const float* mul, const float* add,
                                 const void* const* g, const void* const* y, const float* gs0,
                                 const float* gs1, const void* w0, const void* w1,
                                 void* const* outs, const int* offsets, const int* cells,
                                 const float* weights, const int* codes, const int* comb_offsets,
                                 const int* comb_cells, const float* comb_weights,
                                 const unsigned char* tap_mask, const int* table, float* red,
                                 float* dmul, float* dadd, float* ws, float* dt0, float* dt1,
                                 float* gpart, float* gsum0, float* gsum1, void* operand,
                                 void* wpack, void* grid_operand, int B, int h, int w, int cin,
                                 int cout, int n_sets, int out_phase0, int n_out, int kc,
                                 int n_chunks, int n_comb, int gsum_rows, int zero_poles,
                                 int dtype, void* stream) {
  if (bad_sets(n_sets, n_out) || out_phase0 + n_out > 4) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return merged(x, mul, add, g, y, gs0, gs1, w0, w1, outs, offsets, cells, weights, table, red,
                  dmul, dadd, ws, dt0, dt1, gpart, gsum0, gsum1, B, h, w, cin, cout, n_sets,
                  out_phase0, n_out, kc, n_chunks, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const gn::GLoad<bf16> gl = gn::make_gload<bf16>(g, y, gs0, gs1, 5 * h * w, cout, n_sets, n_out);
  const gn::DxTables tb = {codes, {comb_offsets, comb_cells, comb_weights, n_comb}, tap_mask,
                           static_cast<bf16*>(operand), static_cast<bf16*>(wpack), 4};
  return merged_mma(x, mul, add, gl, w0, w1, outs, tb, table, static_cast<bf16*>(grid_operand),
                    red, dmul, dadd, ws, dt0, dt1, gpart, gsum0, gsum1, B, h, w, cin, n_sets,
                    out_phase0, n_out, kc, n_chunks, gsum_rows, zero_poles, s);
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of i's bf16 launch of both GEMMs (gn::mma_bwd), on b's
// NARROW tile (a C_in of at most 64) or the wide one, with a's act
// epilogue or without.
extern "C" int gn_phase_conv_bwd_info(int narrow, int act, int* out) {
  using Tag = gn::MergedPhase;
  using Act = gn::DxEpi<true>;
  using NoAct = gn::DxEpi<false>;
  if (narrow)
    return act ? gn::mma_bwd_info<Tag, true, Act>(out) : gn::mma_bwd_info<Tag, true, NoAct>(out);
  return act ? gn::mma_bwd_info<Tag, false, Act>(out) : gn::mma_bwd_info<Tag, false, NoAct>(out);
}
