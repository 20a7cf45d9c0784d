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
// moved to do that: the split is addressing. The forward runs the phase
// conv's own GEMM (gn::conv_gemm over output phase 2, the stride-2 conv)
// with the split store (gn::split_row): output row (chart, i, j) of tap set s
// goes to phase 2 * (i & 1) + (j & 1) at (chart, i >> 1, j >> 1), shifts and
// masks of the cell index, as the grid sides are powers of two. The stats
// partials come from the tile before the store and the GEMM's row order is
// the phase conv's, so the outputs and stats equal phase_conv_fwd with
// out_phases (2,) followed by phase_split bit for bit. The backward kernels
// run the phase conv's dx and dtaps tiles (gn::dx_tile over the transposed
// table of output phase 2, gn::dtaps_tile) with the split cotangent loader
// GLoad<T, true>, which reads row m of the merged cotangent (and y, under
// the fold) from its phase by the same map; so dx, dtaps, d_mul/d_add and
// Σg_eff equal phase_conv_dx / phase_conv_dtaps on phase_merge'd
// cotangents bit for bit.
//
// What bounds it on the card: as the phase conv's kernels, the float32 FMA
// rate of the SIMT GEMM core (2 * 7 * C_in * 2 * C_out FLOPs per level-(s-1)
// cell, each for the forward, dx and dtaps). The split map costs a few
// shifts per stored or loaded element, next to 7 * C_in FMAs.
#include "backward.cuh"

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

template <typename T>
cudaError_t fwd(const void* const* x, const float* mul, const float* add, const void* w0,
                const void* b0, const void* w1, const void* b1, void* const* outs,
                const int* table, float* stats_ws, float* const* stats, int B, int h, int w,
                int cin, int cout, int n_sets, cudaStream_t stream) {
  const gn::GridLoad<T> ld = grid_load<T>(x, mul, add, h, w, cin);
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
}

template <typename T>
cudaError_t dx(const void* const* g, const void* const* y, const float* gs0, const float* gs1,
               const void* w0, const void* w1, const void* const* raw, const float* mul,
               const float* add, void* const* outs, const int* offsets, const int* cells,
               const float* weights, float* red, float* dmul, float* dadd, float* gsum_ws,
               float* gsum0, float* gsum1, int B, int h, int w, int cin, int cout, int n_sets,
               int gsum_rows, cudaStream_t stream) {
  const int M = 5 * h * w;
  const auto gl = gn::make_split_gload<T>(g, y, gs0, gs1, log2i(h), log2i(w), cout, n_sets);
  gn::DxOut<T> o = {};
  for (int p = 0; p < 4; ++p) {
    o.out[p] = static_cast<T*>(outs[p]);
    o.raw[p] = mul ? static_cast<const T*>(raw[p]) : nullptr;
  }
  o.mul = mul;
  o.add = add;
  o.red = red;
  o.per = M;
  cudaError_t err = gn::launch_dx_gemm<T>(gl, w0, w1, offsets, cells, weights, o, dmul, dadd, B,
                                          4 * M, cin, n_sets, stream);
  if (err != cudaSuccess || gsum_ws == nullptr) return err;
  return gn::launch_gsum<T>(gl, B, n_sets, gsum_rows, gsum_ws, gsum0, gsum1, stream);
}

template <typename T>
cudaError_t dtaps(const void* const* x, const float* mul, const float* add,
                  const void* const* g, const void* const* y, const float* gs0, const float* gs1,
                  const int* table, float* ws, float* dt0, float* dt1, float* gsum_ws,
                  float* gsum0, float* gsum1, int B, int h, int w, int cin, int cout, int n_sets,
                  int kc, int n_chunks, int gsum_rows, cudaStream_t stream) {
  const int M = 5 * h * w;
  const auto gl = gn::make_split_gload<T>(g, y, gs0, gs1, log2i(h), log2i(w), cout, n_sets);
  const gn::GridLoad<T> ld = grid_load<T>(x, mul, add, h, w, cin);
  cudaError_t err = gn::launch_dtaps_gemm<T>(ld, gl, table, cin, n_sets, 2, B * M, kc, n_chunks,
                                             ws, dt0, dt1, stream);
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
// of (B * ceil(5hw/64), 2 * n_sets * cout), and then st0/st1 receive each
// set's (2, cout) [sum, sumsq]. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_ds2s_fwd(const void* x0, const void* x1, const void* x2, const void* x3,
                           const float* act_mul, const float* act_add, const void* w0,
                           const void* b0, const void* w1, const void* b1, void* const* outs,
                           const int* table, float* stats_ws, float* st0, float* st1, int B,
                           int h, int w, int cin, int cout, int n_sets, int dtype,
                           void* stream) {
  if (bad_shape(n_sets, h, w)) return cudaErrorInvalidValue;
  const void* x[4] = {x0, x1, x2, x3};
  float* stats[2] = {st0, st1};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(x, act_mul, act_add, w0, b0, w1, b1, outs, table, stats_ws, stats, B, h, w,
                      cin, cout, n_sets, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, act_mul, act_add, w0, b0, w1, b1, outs, table, stats_ws, stats,
                              B, h, w, cin, cout, n_sets, s);
  return cudaErrorInvalidValue;
}

// g: host array of n_sets * 4 phase cotangent pointers (set-major), each
// (B, 5, h/2, w/2, cout); y: null (no fold) or the forward's output phases
// in the same order, with gs0/gs1 the sets' (2, cout) float32 stats
// cotangents; the rest as gn_phase_conv_dx with out_phases (2,): w0/w1 taps,
// raw/mul/add the act prologue (or null), outs the 4 dphases (B, 5, h, w,
// cin), offsets/cells/weights halo.phase_dx_table(h, w, mode, (2,)), red and
// dmul/dadd with act, gsum_ws/gsum0/gsum1 with the fold. dtype: 0 float32,
// 1 bfloat16.
extern "C" int gn_ds2s_dx(const void* const* g, const void* const* y, const float* gs0,
                          const float* gs1, const void* w0, const void* w1,
                          const void* const* raw, const float* mul, const float* add,
                          void* const* outs, const int* offsets, const int* cells,
                          const float* weights, float* red, float* dmul, float* dadd,
                          float* gsum_ws, float* gsum0, float* gsum1, int B, int h, int w,
                          int cin, int cout, int n_sets, int gsum_rows, int dtype,
                          void* stream) {
  if (bad_shape(n_sets, h, w)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dx<float>(g, y, gs0, gs1, w0, w1, raw, mul, add, outs, offsets, cells, weights, red,
                     dmul, dadd, gsum_ws, gsum0, gsum1, B, h, w, cin, cout, n_sets, gsum_rows, s);
  if (dtype == 1)
    return dx<__nv_bfloat16>(g, y, gs0, gs1, w0, w1, raw, mul, add, outs, offsets, cells,
                             weights, red, dmul, dadd, gsum_ws, gsum0, gsum1, B, h, w, cin,
                             cout, n_sets, gsum_rows, s);
  return cudaErrorInvalidValue;
}

// x: host array of the 4 raw input phases (B, 5, h, w, cin); mul/add: the
// act prologue or null; g, y, gs0, gs1: as in gn_ds2s_dx; table:
// halo.phase_conv_table; ws: float32 scratch of (n_chunks, 7 * cin,
// n_sets * cout), the B * 5hw rows split in chunks of kc (a multiple of 16);
// dt0/dt1 receive (7, cin, cout) float32; gsum_ws: null, or scratch of
// (ceil(B * 5hw / gsum_rows), n_sets * cout) with gsum0/gsum1 receiving
// Σg_eff. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_ds2s_dtaps(const void* const* x, const float* mul, const float* add,
                             const void* const* g, const void* const* y, const float* gs0,
                             const float* gs1, const int* table, float* ws, float* dt0,
                             float* dt1, float* gsum_ws, float* gsum0, float* gsum1, int B, int h,
                             int w, int cin, int cout, int n_sets, int kc, int n_chunks,
                             int gsum_rows, int dtype, void* stream) {
  if (bad_shape(n_sets, h, w) || kc % gn::BK != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dtaps<float>(x, mul, add, g, y, gs0, gs1, table, ws, dt0, dt1, gsum_ws, gsum0, gsum1,
                        B, h, w, cin, cout, n_sets, kc, n_chunks, gsum_rows, s);
  if (dtype == 1)
    return dtaps<__nv_bfloat16>(x, mul, add, g, y, gs0, gs1, table, ws, dt0, dt1, gsum_ws,
                                gsum0, gsum1, B, h, w, cin, cout, n_sets, kc, n_chunks,
                                gsum_rows, s);
  return cudaErrorInvalidValue;
}
