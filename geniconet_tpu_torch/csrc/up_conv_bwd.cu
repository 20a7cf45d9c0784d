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
// Here the three are composed on the host into ONE transposed table with
// weights (halo.up_dx_table): for each level-s cell and tap, the output
// cells of the 4 new phases that read it, and how much. dx is then one
// gather-GEMM with float32 sums and one rounding, as in phase_conv_bwd.cu,
// with no atomics. dtaps re-gathers the upsampled operand through
// gn::UpLoad (the forward's loader) and reduces over B * 4 * 5hw rows in
// chunks, whose partials a second pass sums in a fixed order.
//
// What bounds it on the card: the float32 FMA rate of the SIMT GEMM core.
// A dx operand element sums about 7 rows of g (one per upsampled cell that
// holds the input cell: the copy and the 6 midpoints), so the gather costs
// more loads than the phase conv's; they hit L1/L2.
//
// The merged kernel is gn::merged_bwd (backward.cuh) with the same two
// tile roles: dx tiles gather through halo.up_dx_table, dtaps tiles
// re-gather the upsampled operand through gn::UpLoad (the upsampled tensor
// is never built in device memory) and, in the first row tile, take Σg_eff
// from their g tiles. One launch, then the fixed-order sum_rows passes; the
// two roles each read g (see phase_conv_bwd.cu).
#include "backward.cuh"

namespace {

template <typename T>
cudaError_t dx(const void* const* g, const void* const* y, const float* gs0, const float* gs1,
               const void* w0, const void* w1, void* out, const int* offsets, const int* cells,
               const float* weights, float* gsum_ws, float* gsum0, float* gsum1, int B, int h,
               int w, int cin, int cout, int n_sets, int gsum_rows, cudaStream_t stream) {
  const int M = 5 * h * w;
  const gn::GLoad<T> gl = gn::make_gload<T>(g, y, gs0, gs1, M, cout, n_sets, 4);
  gn::DxOut<T> o = {};
  o.out[0] = static_cast<T*>(out);
  o.per = M;
  cudaError_t err = gn::launch_dx_gemm<T>(gl, w0, w1, offsets, cells, weights, o, nullptr,
                                          nullptr, B, M, cin, n_sets, stream);
  if (err != cudaSuccess || gsum_ws == nullptr) return err;
  return gn::launch_gsum<T>(gl, B, n_sets, gsum_rows, gsum_ws, gsum0, gsum1, stream);
}

template <typename T>
cudaError_t dtaps(const void* x, const void* const* g, const void* const* y, const float* gs0,
                  const float* gs1, const int* conv_table, const int* up_table, float* ws,
                  float* dt0, float* dt1, int B, int h, int w, int cin, int cout, int n_sets,
                  int kc, int n_chunks, cudaStream_t stream) {
  const int M = 5 * h * w;
  const gn::GLoad<T> gl = gn::make_gload<T>(g, y, gs0, gs1, M, cout, n_sets, 4);
  gn::UpLoad<T> ld;
  ld.x = {static_cast<const T*>(x)};
  ld.up = up_table;
  ld.hw = h * w;
  ld.hw5 = M;
  ld.cin = cin;
  return gn::launch_dtaps_gemm<T>(ld, gl, conv_table, cin, n_sets, 0, B * 4 * M, kc, n_chunks,
                                  ws, dt0, dt1, stream);
}

template <typename T>
cudaError_t merged(const void* x, const void* const* g, const void* const* y, const float* gs0,
                   const float* gs1, const void* w0, const void* w1, void* out,
                   const int* offsets, const int* cells, const float* weights,
                   const int* conv_table, const int* up_table, float* ws, float* dt0,
                   float* dt1, float* gpart, float* gsum0, float* gsum1, int B, int h, int w,
                   int cin, int cout, int n_sets, int kc, int n_chunks, cudaStream_t stream) {
  const int M = 5 * h * w;
  const gn::GLoad<T> gl = gn::make_gload<T>(g, y, gs0, gs1, M, cout, n_sets, 4);
  gn::DxOut<T> o = {};
  o.out[0] = static_cast<T*>(out);
  o.per = M;
  gn::UpLoad<T> ld;
  ld.x = {static_cast<const T*>(x)};
  ld.up = up_table;
  ld.hw = h * w;
  ld.hw5 = M;
  ld.cin = cin;
  const gn::SplitOut dt = {{dt0, dt1}, n_sets * cout, cout};
  return gn::launch_merged_bwd<T>(gl, w0, w1, offsets, cells, weights, o, nullptr, nullptr, B,
                                  M, ld, conv_table, 0, kc, n_chunks, ws, dt, gpart, gsum0,
                                  gsum1, cin, n_sets, stream);
}

}  // namespace

// g: host array of n_sets * 4 cotangent pointers (set-major), each
// (B, 5, h, w, cout), the level-(s+1) phases; y, gs0, gs1: null, or the
// forward outputs and the (2, cout) stats cotangents for the fold; w0/w1:
// taps (7, cin, cout); out: dx (B, 5, h, w, cin), level s;
// offsets/cells/weights: halo.up_dx_table; gsum_ws: null, or float32
// scratch of (ceil(B * 4 * 5hw / gsum_rows), n_sets * cout) and
// gsum0/gsum1 receive Σg_eff (cout). dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_dual_conv_dx(const void* const* g, const void* const* y, const float* gs0,
                                  const float* gs1, const void* w0, const void* w1, void* out,
                                  const int* offsets, const int* cells, const float* weights,
                                  float* gsum_ws, float* gsum0, float* gsum1, int B, int h, int w,
                                  int cin, int cout, int n_sets, int gsum_rows, int dtype,
                                  void* stream) {
  if (n_sets < 1 || n_sets > 2) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dx<float>(g, y, gs0, gs1, w0, w1, out, offsets, cells, weights, gsum_ws, gsum0, gsum1,
                     B, h, w, cin, cout, n_sets, gsum_rows, s);
  if (dtype == 1)
    return dx<__nv_bfloat16>(g, y, gs0, gs1, w0, w1, out, offsets, cells, weights, gsum_ws,
                             gsum0, gsum1, B, h, w, cin, cout, n_sets, gsum_rows, s);
  return cudaErrorInvalidValue;
}

// x: (B, 5, h, w, cin) level-s grid; g, y, gs0, gs1: as in
// gn_up_dual_conv_dx; conv_table / up_table: halo.phase_conv_table and
// halo.upsample_table; ws: float32 scratch of (n_chunks, 7 * cin,
// n_sets * cout), the rows B * 4 * 5hw split in chunks of kc; dt0/dt1
// receive (7, cin, cout) float32. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_dual_conv_dtaps(const void* x, const void* const* g, const void* const* y,
                                     const float* gs0, const float* gs1, const int* conv_table,
                                     const int* up_table, float* ws, float* dt0, float* dt1,
                                     int B, int h, int w, int cin, int cout, int n_sets, int kc,
                                     int n_chunks, int dtype, void* stream) {
  if (n_sets < 1 || n_sets > 2 || kc % gn::BK != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dtaps<float>(x, g, y, gs0, gs1, conv_table, up_table, ws, dt0, dt1, B, h, w, cin,
                        cout, n_sets, kc, n_chunks, s);
  if (dtype == 1)
    return dtaps<__nv_bfloat16>(x, g, y, gs0, gs1, conv_table, up_table, ws, dt0, dt1, B, h, w,
                                cin, cout, n_sets, kc, n_chunks, s);
  return cudaErrorInvalidValue;
}

// The merged backward (_upd_bwd's merged branch). x: (B, 5, h, w, cin)
// level-s grid; g, y, gs0, gs1, w0, w1: as in gn_up_dual_conv_dx; out: dx
// (B, 5, h, w, cin); offsets/cells/weights: halo.up_dx_table; conv_table /
// up_table: halo.phase_conv_table and halo.upsample_table; ws: float32
// scratch of (n_chunks, 7 * cin, n_sets * cout), the rows B * 4 * 5hw split
// in chunks of kc (a multiple of 16); dt0/dt1 receive (7, cin, cout)
// float32; gpart: float32 scratch of (n_chunks, n_sets * cout), and
// gsum0/gsum1 receive Σg_eff (cout). dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_dual_conv_bwd(const void* x, const void* const* g, const void* const* y,
                                   const float* gs0, const float* gs1, const void* w0,
                                   const void* w1, void* out, const int* offsets,
                                   const int* cells, const float* weights,
                                   const int* conv_table, const int* up_table, float* ws,
                                   float* dt0, float* dt1, float* gpart, float* gsum0,
                                   float* gsum1, int B, int h, int w, int cin, int cout,
                                   int n_sets, int kc, int n_chunks, int dtype, void* stream) {
  if (n_sets < 1 || n_sets > 2) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return merged<float>(x, g, y, gs0, gs1, w0, w1, out, offsets, cells, weights, conv_table,
                         up_table, ws, dt0, dt1, gpart, gsum0, gsum1, B, h, w, cin, cout,
                         n_sets, kc, n_chunks, s);
  if (dtype == 1)
    return merged<__nv_bfloat16>(x, g, y, gs0, gs1, w0, w1, out, offsets, cells, weights,
                                 conv_table, up_table, ws, dt0, dt1, gpart, gsum0, gsum1, B, h,
                                 w, cin, cout, n_sets, kc, n_chunks, s);
  return cudaErrorInvalidValue;
}
