// Standard-layout hex conv, stride 1 or 2, backward: dx (input cotangent, with
// the act adjoint and d_mul/d_add, and optionally the bias gradient Σg) and
// dtaps (tap cotangents summed over the batch, rounded to the activation
// dtype), as two kernels (the split route) or as one merged kernel.
//
// Replaces: geniconet_tpu/ops/pallas/conv_kernel.py:_pallas_dx (kernel body
// _dx_kernel) and :_pallas_dtaps (_dtaps_kernel), as called by the custom
// VJP of fused_ico_conv_s2s (each DownBlock's conv01), including the
// BatchNorm stats fold g_eff = g + gs0 + 2*gs1*y; and, as gn_ico_conv_bwd,
// :_std_bwd (pallas_call at :601, _std_bwd_kernel), the merged one-pass
// backward of GENICONET_MERGED_BWD's std family; at stride 1 and 2.
//
// Stride 2 (the Pallas _tap_slice centres P[2r+2, 2q+1], its dx the
// parity-interleave scatter _conv_transpose_dP) runs the same kernels over
// the stride-2 tables (halo.std_conv_table, std_dx_table, std_dx_codes with
// stride 2): g, y and the dtaps rows are the M = 5hw / 4 output cells, dx
// and the dx GEMM's rows the R = 5hw input cells (DxTables::m_in); the
// transposed table has no pole and no combined row there (a stride-2 centre
// never reads a pole, and a cell is read once a tap), and a 128-row tile
// reads about a third of the taps (its mask byte).
//
// Design. The Pallas dx kernel scatters the conv transpose into a padded
// VMEM buffer and then runs the exact transpose of the ico_pad halo. Blocks
// on the card run in no order, so dx is a gather instead: the transposed
// table halo.std_dx_table lists, for each input cell and tap, the output
// cells that read it with their weights (1, or 0.2 for each of the 5 cells
// of a pole mean). The act adjoint runs after the halo transpose, since the
// pole means are means of activated values.
// * float32 keeps the SIMT gather-GEMM (gn::dx_gemm, backward.cuh): each
//   operand element sums its table row's entries of g_eff.
// * bf16 runs the transposed problem on the tensor cores, as the phase
//   conv's dx (a) does, with one input grid (n_in = 1): cot_operand_pass
//   (mma.cuh, tag StdGrid) writes g_eff = g + gs0 + 2 gs1 y once with
//   GLoad's roundings, per sample its 5hw cotangent rows and then its
//   combined rows (a transposed row that is not one weight-1 read: the
//   chart seams, weights (1, 1), and the 10 pole rows, five 0.2 and two 1;
//   320 / 160 / 80 a sample at (16,32) / (8,16) / (4,8), its float32 sum
//   rounded to bf16 once), then a zero row; pack_taps_t stacks the taps
//   transposed; gn::mma_conv with DxEpi (mma_conv_fwd.cuh: mma.sync
//   m16n8k16 over a 4-stage cp.async ring, a ZERO code zero-filled) reads,
//   for each of the B * 5hw rows and each tap, the one operand row that
//   halo.std_dx_codes' (1, 7, M) code table names, and applies the act
//   adjoint with the d_mul/d_add column partials in its epilogue; Σg_eff
//   sums the written cotangent rows (launch_gsum's order: the values the
//   fold gave). A sample's rows straddle 128-row tiles at (4,8) (M = 160),
//   where there is no tap mask; each GEMM row finds its own sample.
// dtaps reduces over the B * 5hw rows in chunks; the fixed-order second
// pass writes the sum rounded to the activation dtype (the Pallas
// wrapper's out.astype(x.dtype)). In float32 it re-gathers the activated
// forward operand through the forward table on the SIMT core; in bf16 it
// writes that operand once (the act-applied grid and each sample's two
// pole rows) and runs gn::mma_dtaps on the tensor cores over its gathered
// rows (mma_dtaps.cuh, which also says what bounds it). No atomics: every
// result is the same from run to run.
//
// What bounds dx on the card: 2 * 7 * C_in * C_out FLOPs per cell (at the
// DownBlocks' conv01 shapes, B=36: 21.1, 21.1 and 5.3 GFLOP, 0.048 ms at
// 989 bf16 TFLOP/s) against the bytes of g, y, x and dx read or written
// once (0.055 ms at 3.35 TB/s): the two bounds are within 15%, so a bf16
// call is held by the GEMM's rate (the ring runs 100-250 TFLOP/s) and by
// filling the card ((4,8) at C_in 256 gives 90 blocks, under one wave of
// 132 SMs), plus the cotangent pass's bytes; float32 by the SIMT core's
// FMA rate, 7-12 TFLOP/s.
//
// The merged backward (gn_ico_conv_bwd, _std_bwd) computes every output of
// _std_bwd_kernel: dx with the act adjoint and the d_mul/d_add partials,
// dtaps over the activated input (relu(x*mul + add) cast to x's dtype)
// rounded to the activation dtype, and Σg_eff, which _std_bwd always emits.
// In float32 it is gn::merged_bwd (backward.cuh): dx tiles over
// halo.std_dx_table and dtaps tiles by block index in one SIMT launch, then
// the fixed-order sum_rows passes; the two roles each read and fold g. In
// bf16 it is f's split route over ONE folded cotangent, as i is a's and b's
// (phase_conv_bwd.cu): f's cot_operand_pass writes g_eff once with
// halo.std_dx_codes' combined rows, f's grid_operand_pass the act-applied
// grid and its two pole rows once, pack_taps_t the taps transposed (all
// tagged MergedStd), then one launch of both GEMMs (gn::mma_bwd,
// mma_merged_bwd.cuh, one input grid): f's dtaps tiles first over the
// written cotangent (mma::WrittenRows, no fold in the GEMM; the NARROW tile
// at a C_in of at most 64), f's dx tiles around them with DxEpi and f's tap
// masks (none at (4,8), where a sample's 160 rows straddle tiles); then the
// d_mul/d_add sum over the dx row tiles, the dtaps chunks' fixed-order sum
// on f's split rounded to bf16 (CastOut), and Σg_eff over the written rows.
// The written cotangent holds the values f's in-kernel fold gives (both
// round fold_geff once), so dx, dtaps, Σg_eff and d_mul/d_add equal
// ico_conv_s2s_dx (emit_gsum) + ico_conv_s2s_dtaps bit for bit. What bounds
// it: the two GEMMs' tensor-core steps (mma_conv_fwd.cuh, mma_dtaps.cuh;
// f's dtaps without its fold) and the passes' bytes (the cotangent and the
// operand written once each).
#include <type_traits>

#include "mma_merged_bwd.cuh"

namespace {

// dtaps in T: the second pass rounds each float32 sum once.
template <typename T>
struct CastOut {
  T* out;
  __device__ __forceinline__ void operator()(long long c, float v) const {
    out[c] = gn::from_f<T>(v);
  }
};

template <typename T>
gn::GLoad<T> gload(const void* g, const void* y, const float* gs, int M, int cout) {
  const void* gp[1] = {g};
  const void* yp[1] = {y};
  return gn::make_gload<T>(gp, y ? yp : nullptr, gs, nullptr, M, cout, 1, 1);
}

// The one input grid with its act prologue, as the forward reads it.
template <typename T>
gn::GridLoad<T> std_load(const void* x, const float* mul, const float* add, int h, int w,
                         int cin) {
  gn::GridLoad<T> ld = {};
  ld.src[0] = static_cast<const T*>(x);
  ld.mul = mul;
  ld.add = add;
  ld.hw = h * w;
  ld.hw5 = 5 * h * w;
  ld.cin = cin;
  ld.south_src = 0;
  return ld;
}

// float32: the SIMT gather-GEMM over halo.std_dx_table; bf16: the folded
// cotangent written once, then the tensor-core GEMM over the rows
// halo.std_dx_codes names (mma_conv_fwd.cuh), the act adjoint in its
// epilogue, one input grid (n_in = 1).
template <typename T>
cudaError_t dx(const void* g, const void* y, const float* gs, const void* taps, const void* raw,
               const float* mul, const float* add, void* out, const int* offsets,
               const int* cells, const float* weights, const gn::DxTables& tb, float* red,
               float* dmul, float* dadd, float* gsum_ws, float* gsum, int B, int h, int w,
               int cin, int cout, int stride, int gsum_rows, cudaStream_t stream) {
  const int R = 5 * h * w, M = R / (stride * stride);
  const gn::GLoad<T> gl = gload<T>(g, y, gs, M, cout);
  if constexpr (std::is_same_v<T, float>) {
    gn::DxOut<T> o = {};
    o.out[0] = static_cast<T*>(out);
    o.raw[0] = mul ? static_cast<const T*>(raw) : nullptr;
    o.mul = mul;
    o.add = add;
    o.red = red;
    o.per = R;
    cudaError_t err = gn::launch_dx_gemm<T>(gl, taps, nullptr, offsets, cells, weights, o, dmul,
                                            dadd, B, R, cin, 1, stream);
    if (err != cudaSuccess || gsum_ws == nullptr) return err;
    return gn::launch_gsum<T>(gl, B, 1, gsum_rows, gsum_ws, gsum, nullptr, stream);
  } else {
    // every table and scratch buffer, or no launch: the mask exactly where
    // a sample's M rows fill whole 128-row tiles
    if ((tb.comb.n > 0 && (tb.comb.offsets == nullptr || tb.comb.cells == nullptr ||
                           tb.comb.weights == nullptr)) ||
        (tb.mask == nullptr) != (R % gn::fwd::BM != 0) ||
        (mul != nullptr && (raw == nullptr || red == nullptr)))
      return cudaErrorInvalidValue;
    gn::DxRows rows = {};
    rows.out[0] = static_cast<T*>(out);
    rows.raw[0] = mul ? static_cast<const T*>(raw) : nullptr;
    rows.mul = mul;
    rows.add = add;
    rows.red = red;
    rows.cin = cin;
    return gn::launch_grid_cot_dx<gn::StdGrid>(gl, tb, rows, static_cast<const T*>(taps),
                                               nullptr, gsum_ws, gsum, nullptr, dmul, dadd, B, 1,
                                               gsum_rows, stream);
  }
}

// float32: the SIMT GEMM over GridLoad; bf16: the operand pass into
// `operand`, then the tensor-core GEMM; either way the sum rounded to T.
template <typename T>
cudaError_t dtaps(const void* x, const float* mul, const float* add, const void* g,
                  const void* y, const float* gs, const int* table, float* ws, void* out,
                  void* operand, int B, int h, int w, int cin, int cout, int stride, int kc,
                  int n_chunks, int zero_poles, cudaStream_t stream) {
  const int M = 5 * h * w / (stride * stride);
  const gn::GLoad<T> gl = gload<T>(g, y, gs, M, cout);
  const gn::GridLoad<T> ld = std_load<T>(x, mul, add, h, w, cin);
  const CastOut<T> st = {static_cast<T*>(out)};
  if constexpr (std::is_same_v<T, float>) {
    dim3 grid((7 * cin + gn::BM - 1) / gn::BM, (cout + gn::BN - 1) / gn::BN, n_chunks);
    gn::dtaps_gemm<T, gn::GridLoad<T> ><<<grid, gn::NT, 0, stream>>>(ld, gl, table, cin, 1, 0,
                                                                      B * M, kc, ws);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return gn::launch_sum_rows(ws, n_chunks, 7LL * cin * cout, st, stream);
  } else {
    return gn::launch_grid_mma_dtaps<gn::StdGrid>(ld, 1, gl, table, 0, 1,
                                                  static_cast<T*>(operand), zero_poles, B, cin, 1,
                                                  kc, n_chunks, ws, st, stream);
  }
}

// float32: gn::merged_bwd, the SIMT tiles of both roles in one launch
cudaError_t merged(const void* x, const float* mul, const float* add, const void* g,
                   const void* y, const float* gs, const void* taps, void* out,
                   const int* offsets, const int* cells, const float* weights, const int* table,
                   float* red, float* dmul, float* dadd, float* ws, void* dtaps, float* gpart,
                   float* gsum, int B, int h, int w, int cin, int cout, int stride, int kc,
                   int n_chunks, cudaStream_t stream) {
  const int R = 5 * h * w, M = R / (stride * stride);
  const gn::GLoad<float> gl = gload<float>(g, y, gs, M, cout);
  gn::DxOut<float> o = {};
  o.out[0] = static_cast<float*>(out);
  o.raw[0] = mul ? static_cast<const float*>(x) : nullptr;
  o.mul = mul;
  o.add = add;
  o.red = red;
  o.per = R;
  const CastOut<float> dt = {static_cast<float*>(dtaps)};
  return gn::launch_merged_bwd<float>(gl, taps, nullptr, offsets, cells, weights, o, dmul, dadd,
                                      B, R, std_load<float>(x, mul, add, h, w, cin), table, 0, kc,
                                      n_chunks, ws, dt, gpart, gsum, nullptr, cin, 1, stream);
}

// bf16: the folded cotangent written once (f's pass, with the combined rows
// of tb), the act-applied grid written once (f's operand pass, into
// `operand`), the taps packed transposed, both GEMMs in one launch
// (gn::mma_bwd over one input grid), then the d_mul/d_add sum (with the
// act), the dtaps chunks' fixed-order sum rounded to bf16 (f's: sum_chunks,
// or sum_rows past 32 chunks) and Σg_eff over the written rows (CotRowsG,
// as f's dx).
cudaError_t merged_mma(const void* x, const float* mul, const float* add,
                       const gn::GLoad<__nv_bfloat16>& gl, const void* taps, void* out,
                       const gn::DxTables& tb, const int* table, __nv_bfloat16* operand,
                       float* red, float* dmul, float* dadd, float* ws, void* dtaps,
                       float* gsum_ws, float* gsum, int B, int h, int w, int cin, int kc,
                       int n_chunks, int gsum_rows, int zero_poles, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  using Tag = gn::MergedStd;
  const int R = 5 * h * w, M = gl.M, cout = gl.cout;
  // every table and scratch buffer, or no launch: the mask exactly where a
  // sample's R dx rows fill whole 128-row tiles
  if (tb.codes == nullptr || tb.operand == nullptr || tb.wpack == nullptr || tb.n_in != 1 ||
      tb.rows(M) != R ||
      (tb.comb.n > 0 && (tb.comb.offsets == nullptr || tb.comb.cells == nullptr ||
                         tb.comb.weights == nullptr)) ||
      (tb.mask == nullptr) != (R % gn::fwd::BM != 0) || operand == nullptr ||
      gsum_ws == nullptr || (mul != nullptr && red == nullptr) || kc % gn::mma::BK != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = gn::launch_cot_operand<Tag>(gl, tb.comb, tb.operand, B, 1, stream);
  if (err != cudaSuccess) return err;
  err = gn::launch_grid_operand<bf16, Tag>(std_load<bf16>(x, mul, add, h, w, cin), operand, B, 1,
                                           zero_poles, stream);
  if (err != cudaSuccess) return err;
  err = gn::launch_pack_taps_t<Tag>(static_cast<const bf16*>(taps), nullptr, tb.wpack, cin, cout,
                                    1, stream);
  if (err != cudaSuccess) return err;
  const bool narrow = gn::mma_narrow(cin);
  const gn::MmaBwd a = gn::mma_bwd_args(gn::operand_rows(operand, table, B, M, cin, 1, R), gl, tb,
                                        B, cin, 1, 0, 1, narrow, kc, n_chunks, ws);
  gn::DxRows rows = {};
  rows.out[0] = static_cast<bf16*>(out);
  rows.raw[0] = mul ? static_cast<const bf16*>(x) : nullptr;
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
  const CastOut<bf16> st = {static_cast<bf16*>(dtaps)};
  const long long C = 7LL * cin * cout;
  if (n_chunks > 32) {
    err = gn::launch_sum_rows(ws, n_chunks, C, st, stream);
  } else {
    gn::sum_chunks<CastOut<bf16>><<<(unsigned)((C + 255) / 256), 256, 0, stream>>>(ws, n_chunks,
                                                                                   C, st);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const gn::CotRowsG cg = {tb.operand, M, 1, cout, a.cot.per_b, a.cot.ldk};
  return gn::launch_gsum<bf16>(cg, B, 1, gsum_rows, gsum_ws, gsum, nullptr, stream);
}

}  // namespace

// The conv's input is (B, 5, h, w, cin), its output (B, 5, h/stride,
// w/stride, cout) at stride 1 or 2: R = 5hw input cells, M = R / stride^2
// output cells. g: (B, M, cout) cotangent; y: null (no fold) or the
// forward output (B, M, cout), with gs the (2, cout) float32 stats
// cotangent; taps: (7, cin, cout); raw: null (no act) or the raw input
// (B, R, cin), with mul/add float32 (cin); out: dx (B, R, cin). The tables
// are halo.std_dx_table / std_dx_codes at that stride. float32:
// offsets/cells/weights, the CSR; red, with act, float32 scratch of (B *
// ceil(R/64), 2 * cin). bfloat16 (else the call is refused): codes,
// comb_offsets/comb_cells/comb_weights (n_comb combined rows a sample) and
// tap_mask (a byte per 128 rows of one sample's R; null exactly where R is
// not a multiple of 128); operand, scratch of (B * (M + n_comb) + 1, cout
// rounded up to 8); wpack, of (7 * (cout rounded up to 32), cin rounded up
// to 128); red, with act, float32 scratch of (ceil(B * R / 128), 2 * cin).
// dmul/dadd receive (cin) each with act; gsum_ws: null, or scratch of
// (ceil(B * M / gsum_rows), cout), and gsum receives Σg_eff (cout). dtype:
// 0 float32, 1 bfloat16.
extern "C" int gn_ico_conv_dx(const void* g, const void* y, const float* gs, const void* taps,
                              const void* raw, const float* mul, const float* add, void* out,
                              const int* offsets, const int* cells, const float* weights,
                              const int* codes, const int* comb_offsets, const int* comb_cells,
                              const float* comb_weights, const unsigned char* tap_mask,
                              void* operand, void* wpack, float* red, float* dmul, float* dadd,
                              float* gsum_ws, float* gsum, int B, int h, int w, int cin, int cout,
                              int stride, int n_comb, int gsum_rows, int dtype, void* stream) {
  if ((stride != 1 && stride != 2) || h % stride != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const gn::DxTables tb = {codes, {comb_offsets, comb_cells, comb_weights, n_comb}, tap_mask,
                           static_cast<__nv_bfloat16*>(operand),
                           static_cast<__nv_bfloat16*>(wpack), 1, 5 * h * w};
  if (dtype == 0)
    return dx<float>(g, y, gs, taps, raw, mul, add, out, offsets, cells, weights, tb, red, dmul,
                     dadd, gsum_ws, gsum, B, h, w, cin, cout, stride, gsum_rows, s);
  if (dtype == 1)
    return dx<__nv_bfloat16>(g, y, gs, taps, raw, mul, add, out, offsets, cells, weights, tb,
                             red, dmul, dadd, gsum_ws, gsum, B, h, w, cin, cout, stride,
                             gsum_rows, s);
  return cudaErrorInvalidValue;
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of f's bf16 dx GEMM, with the act epilogue or without.
extern "C" int gn_ico_conv_dx_info(int act, int* out) {
  return act ? gn::mma_conv_info<gn::StdGrid, gn::DxEpi<true>>(out)
             : gn::mma_conv_info<gn::StdGrid, gn::DxEpi<false>>(out);
}

// x: the raw input (B, 5, h, w, cin); mul/add: the act prologue or null;
// g, y, gs, stride: as in gn_ico_conv_dx; table: halo.std_conv_table at
// that stride; ws: float32 scratch of (n_chunks, 7 * cin, cout), the B * M
// output rows split in chunks of kc (float32: a multiple of 16,
// build.dtaps_split; bfloat16: of 32,
// build.grid_dtaps_split); out: dtaps (7, cin, cout) in the activation
// dtype; operand: bfloat16 only, scratch of (B * (5hw + 2) + 1, cin rounded
// up to 8) for the act-applied operand (zero_poles: corner_mode "zeros").
// dtype: 0 float32, 1 bfloat16.
extern "C" int gn_ico_conv_dtaps(const void* x, const float* mul, const float* add,
                                 const void* g, const void* y, const float* gs, const int* table,
                                 float* ws, void* out, void* operand, int B, int h, int w,
                                 int cin, int cout, int stride, int kc, int n_chunks,
                                 int zero_poles, int dtype, void* stream) {
  if (kc % gn::BK != 0 || (stride != 1 && stride != 2) || h % stride != 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dtaps<float>(x, mul, add, g, y, gs, table, ws, out, nullptr, B, h, w, cin, cout,
                        stride, kc, n_chunks, zero_poles, s);
  if (dtype == 1)
    return dtaps<__nv_bfloat16>(x, mul, add, g, y, gs, table, ws, out, operand, B, h, w, cin,
                                cout, stride, kc, n_chunks, zero_poles, s);
  return cudaErrorInvalidValue;
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of f's tensor-core GEMM, with the fold or without, on the
// NARROW tile (a C_in of at most 64) or the wide one.
extern "C" int gn_ico_conv_dtaps_info(int narrow, int fold, int* out) {
  using Tag = gn::StdGrid;
  if (narrow)
    return fold ? gn::mma_dtaps_info<Tag, true, true>(out)
                : gn::mma_dtaps_info<Tag, false, true>(out);
  return fold ? gn::mma_dtaps_info<Tag, true>(out) : gn::mma_dtaps_info<Tag, false>(out);
}

// The merged backward (_std_bwd). x: the raw input (B, 5, h, w, cin);
// mul/add: the act prologue or null (with it, dx is the raw input's
// cotangent and dmul/dadd receive (cin) each, through red); g, y, gs, taps,
// stride: as in gn_ico_conv_dx; out: dx (B, 5, h, w, cin); table:
// halo.std_conv_table at that stride; ws: float32 scratch of (n_chunks, 7 *
// cin, cout), the B * M output rows split in chunks of kc; dtaps: (7, cin,
// cout) in the activation dtype; gsum receives Σg_eff (cout). float32:
// offsets/cells/weights, halo.std_dx_table; red of (B * ceil(R/64), 2 *
// cin); kc a multiple of 16 (build.merged_scratch); gpart, float32 scratch
// of (n_chunks, cout); the bf16 arguments null. bfloat16 (else the call is
// refused): the bf16 arguments of gn_ico_conv_dx (codes .. tap_mask,
// operand, wpack, red; n_comb) and of gn_ico_conv_dtaps (grid_operand; kc
// a multiple of 32, build.grid_dtaps_split; zero_poles); gpart, float32
// scratch of (ceil(B * M / gsum_rows), cout) for Σg_eff's pass. dtype: 0
// float32, 1 bfloat16.
extern "C" int gn_ico_conv_bwd(const void* x, const float* mul, const float* add, const void* g,
                               const void* y, const float* gs, const void* taps, void* out,
                               const int* offsets, const int* cells, const float* weights,
                               const int* codes, const int* comb_offsets, const int* comb_cells,
                               const float* comb_weights, const unsigned char* tap_mask,
                               const int* table, float* red, float* dmul, float* dadd, float* ws,
                               void* dtaps, float* gpart, float* gsum, void* operand, void* wpack,
                               void* grid_operand, int B, int h, int w, int cin, int cout,
                               int stride, int kc, int n_chunks, int n_comb, int gsum_rows,
                               int zero_poles, int dtype, void* stream) {
  if ((stride != 1 && stride != 2) || h % stride != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return merged(x, mul, add, g, y, gs, taps, out, offsets, cells, weights, table, red, dmul,
                  dadd, ws, dtaps, gpart, gsum, B, h, w, cin, cout, stride, kc, n_chunks, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const int R = 5 * h * w;
  const gn::DxTables tb = {codes, {comb_offsets, comb_cells, comb_weights, n_comb}, tap_mask,
                           static_cast<bf16*>(operand), static_cast<bf16*>(wpack), 1, R};
  return merged_mma(x, mul, add, gload<bf16>(g, y, gs, R / (stride * stride), cout), taps, out,
                    tb, table, static_cast<bf16*>(grid_operand), red, dmul, dadd, ws, dtaps,
                    gpart, gsum, B, h, w, cin, kc, n_chunks, gsum_rows, zero_poles, s);
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of k's bf16 launch of both GEMMs (gn::mma_bwd), on f's
// NARROW dtaps tile (a C_in of at most 64) or the wide one, with the act
// epilogue or without.
extern "C" int gn_ico_conv_bwd_info(int narrow, int act, int* out) {
  using Tag = gn::MergedStd;
  using Act = gn::DxEpi<true>;
  using NoAct = gn::DxEpi<false>;
  if (narrow)
    return act ? gn::mma_bwd_info<Tag, true, Act>(out) : gn::mma_bwd_info<Tag, true, NoAct>(out);
  return act ? gn::mma_bwd_info<Tag, false, Act>(out) : gn::mma_bwd_info<Tag, false, NoAct>(out);
}
