// Upsample s -> s+1 fused with an UpBlock's two first convs, backward: dx
// (the level-s input cotangent) and dtaps of both tap sets, as two kernels
// (the split route) or as one merged kernel.
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_upd_bwd, its dx call
// (kernel body _up_dx_kernel) and its dtaps call (_up_dtaps_kernel),
// including the in-kernel BatchNorm stats fold and the Σg_eff bias gradient;
// and, as gn_up_dual_conv_bwd, the merged branch of _upd_bwd (pallas_call at
// :2068, _up_bwd_kernel), GENICONET_MERGED_BWD's upd family.
//
// Design. The Pallas dx kernel runs three adjoints in VMEM one after the
// other: the phase-pad transpose of level s+1, the upsample transpose (a
// copy, or 0.5 to each end of a midpoint) and the level-s pad transpose.
// In float32 the three are composed on the host into ONE transposed table
// with weights (halo.up_dx_table): for each level-s cell and tap, the
// output cells of the 4 new phases that read it, and how much; dx is one
// SIMT gather-GEMM with float32 sums and one rounding, as in
// phase_conv_bwd.cu, with no atomics. In bf16 they run in the Pallas
// kernel's order: the stride-1 phase conv's tensor-core dx GEMM
// (phase_conv_bwd.cu's bf16 dx, with the DuEpi epilogue of
// mma_conv_fwd.cuh) writes the float32 cotangent dU of the 4 upsampled
// phases, then up_adjoint_pass gathers it through the transposed
// upsample_table with the level-s pad (halo.up_adjoint_table) and rounds
// once. The GEMM does 4x the FLOPs a composed table would need, on the
// tensor cores, where a composed row of about 7 weighted terms would have
// to be written for every (cell, tap). dtaps reduces over B * 4 * 5hw rows
// in chunks, whose
// partials a second pass sums in a fixed order: in float32 it re-gathers the
// upsampled operand through gn::UpLoad (the forward's loader) on the SIMT
// core; in bf16 it builds the operand once and runs gn::mma_dtaps on the
// tensor cores (mma_dtaps.cuh, which also says what bounds it).
//
// What bounds float32 dx on the card: the float32 FMA rate of the SIMT GEMM
// core. A dx operand element sums about 7 rows of g (one per upsampled cell
// that holds the input cell: the copy and the 6 midpoints), so the gather
// costs more loads than the phase conv's; they hit L1/L2. In bf16: the
// GEMM's tensor cores (mma_conv_fwd.cuh), and the bytes of the passes (the
// cotangent written once; dU, float32, written once and gathered about
// 1.75 times).
//
// The merged kernel (gn_up_dual_conv_bwd): in float32 gn::merged_bwd
// (backward.cuh) with the same two tile roles: dx tiles gather through
// halo.up_dx_table, dtaps tiles re-gather the upsampled operand through
// gn::UpLoad (the upsampled tensor is never built in device memory) and, in
// the first row tile, take Σg_eff from their g tiles; one launch, then the
// fixed-order sum_rows passes; the two roles each read g (see
// phase_conv_bwd.cu). In bf16 it is the split route's device code over ONE
// folded cotangent, as the TPU kernel folds once per g tile for both
// roles: cot_operand_pass writes g_eff once (with the combined rows),
// up_operand_pass the upsampled operand once, then one launch runs both
// GEMMs by block index (gn::mma_bwd, mma_merged_bwd.cuh): d's dtaps tiles
// read their G rows from the written cotangent (mma::WrittenRows: no fold
// in the GEMM, whose ALU and shared-memory work held d's folded GEMM at
// 140-165 TFLOP/s against 230-270 without), the long tiles first, and c's
// dx tiles fill in around them into dU; then the upsample adjoint, the chunks' fixed-order sum and
// Σg_eff over the written rows. dx and Σg_eff are c's passes; dtaps is d's
// GEMM over the same bf16 g_eff values (cot8 and d's shared-memory fold
// both round fold_geff once) with d's split: the five outputs equal the
// split route's (up_dual_conv_dx + up_dual_conv_dtaps) bit for bit.
#include <type_traits>

#include "mma_merged_bwd.cuh"

namespace {

using gn::UpAdjoint;

// One thread: 4 channels of one level-s cell, dx = the float32 sum of its
// upsample-adjoint entries (gn::up_adjoint_sum: weight times the cell's
// cotangent in dU, the 4 upsampled phases (B, 4, 5hw, cin) float32),
// rounded to bf16 once. vec: cin is a multiple of 4 (16-byte loads of dU).
// Tag names the instantiation (c's GridCells, j's MergedUp) for a profile.
template <typename Tag>
__global__ void __launch_bounds__(256)
up_adjoint_pass(UpAdjoint adj, __nv_bfloat16* __restrict__ dx, int M, int cin, int vec,
                long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int chunks = (cin + 3) / 4;
  const long long r = i / chunks;
  const int k0 = (int)(i - r * chunks) * 4;
  const int b = (int)(r / M), m = (int)(r - (long long)b * M);
  float v[4];
  gn::up_adjoint_sum(adj, b, m, k0, M, cin, vec, v);
  __nv_bfloat16* dst = dx + (size_t)r * cin + k0;
  for (int e = 0; e < 4 && k0 + e < cin; ++e) dst[e] = __float2bfloat16_rn(v[e]);
}

// dx (B, 5hw, cin) bf16 from dU through the adjoint table, rounded once.
template <typename Tag>
cudaError_t launch_up_adjoint(const UpAdjoint& adj, void* dx, int B, int M, int cin,
                              cudaStream_t stream) {
  const long long total = (long long)B * M * ((cin + 3) / 4);
  up_adjoint_pass<Tag><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      adj, static_cast<__nv_bfloat16*>(dx), M, cin, cin % 4 == 0, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dx(const void* const* g, const void* const* y, const float* gs0, const float* gs1,
               const void* w0, const void* w1, void* out, const int* offsets, const int* cells,
               const float* weights, const gn::DxTables& tb, const UpAdjoint& adj,
               float* gsum_ws, float* gsum0, float* gsum1, int B, int h, int w, int cin,
               int cout, int n_sets, int gsum_rows, cudaStream_t stream) {
  const int M = 5 * h * w;
  const gn::GLoad<T> gl = gn::make_gload<T>(g, y, gs0, gs1, M, cout, n_sets, 4);
  if constexpr (std::is_same_v<T, float>) {
    gn::DxOut<T> o = {};
    o.out[0] = static_cast<T*>(out);
    o.per = M;
    cudaError_t err = gn::launch_dx_gemm<T>(gl, w0, w1, offsets, cells, weights, o, nullptr,
                                            nullptr, B, M, cin, n_sets, stream);
    if (err != cudaSuccess || gsum_ws == nullptr) return err;
    return gn::launch_gsum<T>(gl, B, n_sets, gsum_rows, gsum_ws, gsum0, gsum1, stream);
  } else {
    // the stride-1 phase conv's dx GEMM over the 4 upsampled phases into
    // float32 dU (mma_conv_fwd.cuh), then the upsample and level-s pad
    // adjoint, rounded once
    using Tag = gn::GridCells<T>;
    if (adj.du == nullptr || adj.offsets == nullptr) return cudaErrorInvalidValue;
    cudaError_t err = gn::launch_cot_dx<Tag>(gl, tb, gn::DuEpi{adj.du, cin},
                                             static_cast<const T*>(w0),
                                             static_cast<const T*>(w1), gsum_ws, gsum0, gsum1, B,
                                             cin, n_sets, gsum_rows, stream);
    if (err != cudaSuccess) return err;
    return launch_up_adjoint<Tag>(adj, out, B, M, cin, stream);
  }
}

template <typename T>
gn::UpLoad<T> up_load(const void* x, const int* up_table, int h, int w, int cin) {
  gn::UpLoad<T> ld;
  ld.x = {static_cast<const T*>(x)};
  ld.up = up_table;
  ld.hw = h * w;
  ld.hw5 = 5 * h * w;
  ld.cin = cin;
  return ld;
}

// float32: the SIMT GEMM over UpLoad; bf16: the operand pass into `operand`,
// then the tensor-core GEMM
template <typename T>
cudaError_t dtaps(const void* x, const void* const* g, const void* const* y, const float* gs0,
                  const float* gs1, const int* conv_table, const int* up_table, float* ws,
                  float* dt0, float* dt1, void* operand, int B, int h, int w, int cin, int cout,
                  int n_sets, int kc, int n_chunks, int zero_poles, cudaStream_t stream) {
  const int M = 5 * h * w;
  const gn::GLoad<T> gl = gn::make_gload<T>(g, y, gs0, gs1, M, cout, n_sets, 4);
  const gn::UpLoad<T> ld = up_load<T>(x, up_table, h, w, cin);
  if constexpr (std::is_same_v<T, float>)
    return gn::launch_dtaps_gemm<T>(ld, gl, conv_table, cin, n_sets, 0, B * 4 * M, kc,
                                    n_chunks, ws, dt0, dt1, stream);
  else
    return gn::launch_mma_dtaps(ld, gl, conv_table, static_cast<T*>(operand), nullptr,
                                zero_poles, B, cin, n_sets, kc, n_chunks, ws, dt0, dt1, stream);
}

// float32: gn::merged_bwd, the SIMT tiles of both roles in one launch
cudaError_t merged(const void* x, const void* const* g, const void* const* y, const float* gs0,
                   const float* gs1, const void* w0, const void* w1, void* out,
                   const int* offsets, const int* cells, const float* weights,
                   const int* conv_table, const int* up_table, float* ws, float* dt0,
                   float* dt1, float* gpart, float* gsum0, float* gsum1, int B, int h, int w,
                   int cin, int cout, int n_sets, int kc, int n_chunks, cudaStream_t stream) {
  const int M = 5 * h * w;
  const gn::GLoad<float> gl = gn::make_gload<float>(g, y, gs0, gs1, M, cout, n_sets, 4);
  gn::DxOut<float> o = {};
  o.out[0] = static_cast<float*>(out);
  o.per = M;
  const gn::UpLoad<float> ld = up_load<float>(x, up_table, h, w, cin);
  const gn::SplitOut dt = {{dt0, dt1}, n_sets * cout, cout};
  return gn::launch_merged_bwd<float>(gl, w0, w1, offsets, cells, weights, o, nullptr, nullptr,
                                      B, M, ld, conv_table, 0, kc, n_chunks, ws, dt, gpart, gsum0,
                                      gsum1, cin, n_sets, stream);
}

// bf16: the folded cotangent written once (c's pass, with the combined rows
// of tb), the upsampled operand written once (d's pass, into `up_operand`),
// the taps packed transposed, both GEMMs in one launch (gn::mma_bwd), the
// upsample adjoint of dU (rounded once), the dtaps chunks' fixed-order sum
// (sum_chunks, as d) and Σg_eff over the written rows (CotRowsG, as c).
cudaError_t merged_mma(const void* x, const gn::GLoad<__nv_bfloat16>& gl, const void* w0,
                       const void* w1, void* out, const gn::DxTables& tb, const UpAdjoint& adj,
                       const int* conv_table, const int* up_table, __nv_bfloat16* up_operand,
                       float* ws, float* dt0, float* dt1, float* gsum_ws, float* gsum0,
                       float* gsum1, int B, int h, int w, int cin, int n_sets, int kc,
                       int n_chunks, int gsum_rows, int zero_poles, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  using Tag = gn::MergedUp;
  const int M = 5 * h * w, cout = gl.cout, Ntot = n_sets * cout;
  if (tb.codes == nullptr || tb.operand == nullptr || tb.wpack == nullptr ||
      adj.du == nullptr || adj.offsets == nullptr || up_operand == nullptr ||
      gsum_ws == nullptr || kc % gn::mma::BK != 0 ||
      (tb.mask != nullptr && (4 * M) % gn::fwd::BM != 0))
    return cudaErrorInvalidValue;
  cudaError_t err = gn::launch_cot_operand<Tag>(gl, tb.comb, tb.operand, B, n_sets, stream);
  if (err != cudaSuccess) return err;
  err = gn::launch_upsampled_operand<bf16, Tag>(up_load<bf16>(x, up_table, h, w, cin),
                                                up_operand, B, zero_poles, stream);
  if (err != cudaSuccess) return err;
  err = gn::launch_pack_taps_t<Tag>(static_cast<const bf16*>(w0), static_cast<const bf16*>(w1),
                                    tb.wpack, cin, cout, n_sets, stream);
  if (err != cudaSuccess) return err;
  // d's tiles always wide, as d's split route takes them
  const gn::MmaBwd a = gn::mma_bwd_args(gn::operand_rows(up_operand, conv_table, B, M, cin, 4, M), gl,
                                        tb, B, cin, n_sets, 0, 4, false, kc, n_chunks, ws);
  err = gn::launch_mma_bwd<Tag, false>(a, gn::DuEpi{adj.du, cin}, stream);
  if (err != cudaSuccess) return err;
  if ((err = launch_up_adjoint<Tag>(adj, out, B, M, cin, stream)) != cudaSuccess) return err;
  const gn::SplitOut st = {{dt0, dt1}, Ntot, cout};
  const long long C = 7LL * cin * Ntot;
  gn::sum_chunks<gn::SplitOut><<<(unsigned)((C + 255) / 256), 256, 0, stream>>>(ws, n_chunks, C,
                                                                                 st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const gn::CotRowsG cg = {tb.operand, M, 4, cout, a.cot.per_b, a.cot.ldk};
  return gn::launch_gsum<bf16>(cg, B, n_sets, gsum_rows, gsum_ws, gsum0, gsum1, stream);
}

}  // namespace

// g: host array of n_sets * 4 cotangent pointers (set-major), each
// (B, 5, h, w, cout), the level-(s+1) phases; y, gs0, gs1: null, or the
// forward outputs and the (2, cout) stats cotangents for the fold; w0/w1:
// taps (7, cin, cout); out: dx (B, 5, h, w, cin), level s. float32:
// offsets/cells/weights, halo.up_dx_table. bfloat16 (else the call is
// refused): codes, comb_offsets/comb_cells/comb_weights (n_comb combined
// rows a sample) and tap_mask from halo.phase_dx_codes of all 4 output
// phases; adj_offsets/adj_cells/adj_weights, halo.up_adjoint_table;
// operand, scratch of (B * (4 * 5hw + n_comb) + 1, n_sets * cout rounded
// up to 8); wpack, of (7 * (n_sets * cout rounded up to 32), cin rounded up
// to 128); du, float32 scratch of (B, 4, 5hw, cin). gsum_ws: null, or
// float32 scratch of (ceil(B * 4 * 5hw / gsum_rows), n_sets * cout) and
// gsum0/gsum1 receive Σg_eff (cout). dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_dual_conv_dx(const void* const* g, const void* const* y, const float* gs0,
                                  const float* gs1, const void* w0, const void* w1, void* out,
                                  const int* offsets, const int* cells, const float* weights,
                                  const int* codes, const int* comb_offsets,
                                  const int* comb_cells, const float* comb_weights,
                                  const unsigned char* tap_mask, const int* adj_offsets,
                                  const int* adj_cells, const float* adj_weights, void* operand,
                                  void* wpack, float* du, float* gsum_ws, float* gsum0,
                                  float* gsum1, int B, int h, int w, int cin, int cout,
                                  int n_sets, int n_comb, int gsum_rows, int dtype,
                                  void* stream) {
  if (n_sets < 1 || n_sets > 2) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const gn::DxTables tb = {codes, {comb_offsets, comb_cells, comb_weights, n_comb}, tap_mask,
                           static_cast<__nv_bfloat16*>(operand),
                           static_cast<__nv_bfloat16*>(wpack), 4};
  const UpAdjoint adj = {adj_offsets, adj_cells, adj_weights, du};
  if (dtype == 0)
    return dx<float>(g, y, gs0, gs1, w0, w1, out, offsets, cells, weights, tb, adj, gsum_ws,
                     gsum0, gsum1, B, h, w, cin, cout, n_sets, gsum_rows, s);
  if (dtype == 1)
    return dx<__nv_bfloat16>(g, y, gs0, gs1, w0, w1, out, offsets, cells, weights, tb, adj,
                             gsum_ws, gsum0, gsum1, B, h, w, cin, cout, n_sets, gsum_rows, s);
  return cudaErrorInvalidValue;
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of c's tensor-core dx GEMM.
extern "C" int gn_up_dual_conv_dx_info(int* out) {
  return gn::mma_conv_info<gn::GridCells<__nv_bfloat16>, gn::DuEpi>(out);
}

// x: (B, 5, h, w, cin) level-s grid; g, y, gs0, gs1: as in
// gn_up_dual_conv_dx; conv_table / up_table: halo.phase_conv_table and
// halo.upsample_table; ws: float32 scratch of (n_chunks, 7 * cin,
// n_sets * cout), the rows B * 4 * 5hw split in chunks of kc (float32: a
// multiple of 16, build.dtaps_split; bfloat16: of 32, build.mma_dtaps_split);
// dt0/dt1 receive (7, cin, cout) float32; operand: bfloat16 only, scratch of
// (B * (4 * 5hw + 2) + 1, cin rounded up to 8) for the upsampled operand
// (zero_poles: corner_mode "zeros", whose phase-pad poles are 0). dtype: 0
// float32, 1 bfloat16.
extern "C" int gn_up_dual_conv_dtaps(const void* x, const void* const* g, const void* const* y,
                                     const float* gs0, const float* gs1, const int* conv_table,
                                     const int* up_table, float* ws, float* dt0, float* dt1,
                                     void* operand, int B, int h, int w, int cin, int cout,
                                     int n_sets, int kc, int n_chunks, int zero_poles, int dtype,
                                     void* stream) {
  if (n_sets < 1 || n_sets > 2 || kc % gn::BK != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dtaps<float>(x, g, y, gs0, gs1, conv_table, up_table, ws, dt0, dt1, nullptr, B, h, w,
                        cin, cout, n_sets, kc, n_chunks, zero_poles, s);
  if (dtype == 1)
    return dtaps<__nv_bfloat16>(x, g, y, gs0, gs1, conv_table, up_table, ws, dt0, dt1, operand,
                                B, h, w, cin, cout, n_sets, kc, n_chunks, zero_poles, s);
  return cudaErrorInvalidValue;
}

// The upsampled operand alone (the first launch of the bf16 dtaps): x and
// up_table as in gn_up_dual_conv_dtaps; out: (B * (4 * 5hw + 2) + 1, cin
// rounded up to 8) in x's dtype. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_operand(const void* x, const int* up_table, void* out, int B, int h, int w,
                             int cin, int zero_poles, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gn::launch_up_operand(up_load<float>(x, up_table, h, w, cin), static_cast<float*>(out),
                                 nullptr, B, zero_poles, s);
  if (dtype == 1)
    return gn::launch_up_operand(up_load<__nv_bfloat16>(x, up_table, h, w, cin),
                                 static_cast<__nv_bfloat16*>(out), nullptr, B, zero_poles, s);
  return cudaErrorInvalidValue;
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of d's tensor-core GEMM, with the fold or without.
extern "C" int gn_up_dual_conv_dtaps_info(int fold, int* out) {
  return fold ? gn::mma_dtaps_info<gn::GridCells<__nv_bfloat16>, true>(out)
              : gn::mma_dtaps_info<gn::GridCells<__nv_bfloat16>, false>(out);
}

// The merged backward (_upd_bwd's merged branch). x: (B, 5, h, w, cin)
// level-s grid; g, y, gs0, gs1, w0, w1: as in gn_up_dual_conv_dx; out: dx
// (B, 5, h, w, cin); conv_table / up_table: halo.phase_conv_table and
// halo.upsample_table; ws: float32 scratch of (n_chunks, 7 * cin,
// n_sets * cout), the rows B * 4 * 5hw split in chunks of kc; dt0/dt1
// receive (7, cin, cout) float32; gsum0/gsum1 receive Σg_eff (cout).
// float32: offsets/cells/weights, halo.up_dx_table; kc a multiple of 16
// (build.merged_scratch); gpart, float32 scratch of (n_chunks, n_sets *
// cout); the bf16 arguments null. bfloat16 (else the call is refused): the
// bf16 arguments of gn_up_dual_conv_dx (codes .. tap_mask,
// adj_offsets .. adj_weights, operand, wpack, du; n_comb) and of
// gn_up_dual_conv_dtaps (up_operand; kc a multiple of 32,
// build.mma_dtaps_split; zero_poles); gpart, float32 scratch of
// (ceil(B * 4 * 5hw / gsum_rows), n_sets * cout) for Σg_eff's pass.
// dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_dual_conv_bwd(const void* x, const void* const* g, const void* const* y,
                                   const float* gs0, const float* gs1, const void* w0,
                                   const void* w1, void* out, const int* offsets,
                                   const int* cells, const float* weights, const int* codes,
                                   const int* comb_offsets, const int* comb_cells,
                                   const float* comb_weights, const unsigned char* tap_mask,
                                   const int* adj_offsets, const int* adj_cells,
                                   const float* adj_weights, const int* conv_table,
                                   const int* up_table, float* ws, float* dt0, float* dt1,
                                   float* gpart, float* gsum0, float* gsum1, void* operand,
                                   void* wpack, float* du, void* up_operand, int B, int h, int w,
                                   int cin, int cout, int n_sets, int kc, int n_chunks,
                                   int n_comb, int gsum_rows, int zero_poles, int dtype,
                                   void* stream) {
  if (n_sets < 1 || n_sets > 2) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return merged(x, g, y, gs0, gs1, w0, w1, out, offsets, cells, weights, conv_table, up_table,
                  ws, dt0, dt1, gpart, gsum0, gsum1, B, h, w, cin, cout, n_sets, kc, n_chunks, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const gn::GLoad<bf16> gl = gn::make_gload<bf16>(g, y, gs0, gs1, 5 * h * w, cout, n_sets, 4);
  const gn::DxTables tb = {codes, {comb_offsets, comb_cells, comb_weights, n_comb}, tap_mask,
                           static_cast<bf16*>(operand), static_cast<bf16*>(wpack), 4};
  const UpAdjoint adj = {adj_offsets, adj_cells, adj_weights, du};
  return merged_mma(x, gl, w0, w1, out, tb, adj, conv_table, up_table,
                    static_cast<bf16*>(up_operand), ws, dt0, dt1, gpart, gsum0, gsum1, B, h, w,
                    cin, n_sets, kc, n_chunks, gsum_rows, zero_poles, s);
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of j's bf16 launch of both GEMMs (gn::mma_bwd).
extern "C" int gn_up_dual_conv_bwd_info(int* out) {
  return gn::mma_bwd_info<gn::MergedUp, false, gn::DuEpi>(out);
}
