// The decoder's phase chain (kernel n): an UpBlock's upsample + both first
// convs whose level-s input is the previous UpBlock's residual tail, given
// as its raw phase pair (b0, y10) and four pending BatchNorm affines; and
// the two backward kernels, dx (into the pair's 8 phase cotangents and the
// 4 affine gradients) and dtaps.
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_updp (pallas_call at
// :2380, kernel body _up_pair_fwd_kernel) and the two pallas_calls of
// :_updp_bwd, dx at :2458 (_up_pair_dx_kernel) and dtaps at :2490
// (_up_pair_dtaps_kernel): the custom VJP of fused_up_dual_conv_pair, with
// the optional BatchNorm [sum, sumsq] stats, the in-kernel stats fold and
// the Σg_eff bias gradient.
//
// Design. The Pallas kernels join each phase relu(b0·mul1 + add1 +
// y10·mul2 + add2) in float32, cast it, interleave the four phases into the
// level-s grid in VMEM (_interleave4), and then run the up conv's bodies.
// Here nothing is interleaved: the up conv's loader gn::UpLoad reads its
// level-s cells through gn::PairCells, which joins b0 and y10 at the phase
// and row that gn::split_row maps the grid cell to (the pole means are of
// joined cells, as in the reference). The forward and the dtaps run the up
// conv's GEMMs: in float32 over that loader (gn::conv_gemm, gn::dtaps_gemm);
// in bf16 the pair is joined once into a level-s grid (gn::pair_join_pass),
// the operand pass builds the upsampled operand from it, and the
// tensor-core GEMMs run over its rows (gn::mma_conv, mma_conv_fwd.cuh;
// gn::mma_dtaps, mma_dtaps.cuh). Either way the outputs, stats and dtaps
// equal up_dual_conv_fwd / up_dual_conv_dtaps on phase_merge(join) bit for
// bit. dx is the up conv's float32 SIMT dx GEMM (in both dtypes; the up
// conv's bf16 dx runs the tensor cores since) over the same transposed
// table (halo.up_dx_table; rows are level-s grid cells) with the epilogue
// gn::DxPairOut: the tail's adjoint on the unrounded float32 dx, the masks
// from the raw pair in float32, the 8 phase cotangents stored by split_row,
// and three column sums (d_mul1, d_add1 = d_add2, d_mul2) through block
// partials and one fixed-order gn::sum_rows. The Σg_eff pass is the up
// conv's (gn::launch_gsum). No merged branch, as in the reference.
//
// What bounds it on the card: the dx kernel, as c's float32 one, the FMA
// rate of the SIMT GEMM core (2 * 4 * 7 * C_in * 2 * C_out FLOPs per level-s cell).
// The float32 forward and dtaps pay for the join on load: an operand
// element of their GEMMs joins up to two level-s cells (five for a pole
// mean), each 2 phase loads, 4 affine loads and 5 FLOPs, where the up conv
// loads one cell, and the loader holds more registers (74-77 a thread: 3
// blocks an SM where the up conv fits 4); on an H100 the float32 forward
// takes about 1.6x the up conv's time at the same shape (PERF.md §6). In
// bf16 each cell is joined once, into the level-s grid the operand pass
// reads, and the GEMMs are the up conv's.
#include <type_traits>

#include "mma_conv_fwd.cuh"
#include "mma_dtaps.cuh"

namespace {

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// pair: host array of the 8 phase pointers b0[4], y10[4]; aff: mul1, add1,
// mul2, add2. h, w: the level-s grid (twice the phases' sides).
template <typename T>
gn::UpLoad<T, gn::PairCells<T>> pair_load(const void* const* pair, const float* const* aff,
                                          const int* up_table, int h, int w, int cin) {
  gn::UpLoad<T, gn::PairCells<T>> ld = {};
  for (int p = 0; p < 4; ++p) {
    ld.x.b0[p] = static_cast<const T*>(pair[p]);
    ld.x.y10[p] = static_cast<const T*>(pair[4 + p]);
    ld.x.aff[p] = aff[p];
  }
  ld.x.lh = log2i(h);
  ld.x.lw = log2i(w);
  ld.up = up_table;
  ld.hw = h * w;
  ld.hw5 = 5 * h * w;
  ld.cin = cin;
  return ld;
}

template <typename T>
cudaError_t fwd(const void* const* pair, const float* const* aff, const void* w0, const void* b0,
                const void* w1, const void* b1, void* const* outs, const int* conv_table,
                const int* up_table, float* stats_ws, float* const* stats, void* operand,
                void* joined, void* wpack, int B, int h, int w, int cin, int cout, int zero_poles,
                cudaStream_t stream) {
  const auto ld = pair_load<T>(pair, aff, up_table, h, w, cin);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    gn::FwdOut o = {};
    for (int i = 0; i < 8; ++i) o.out[i / 4][i % 4] = static_cast<T*>(outs[i]);
    o.bias[0] = static_cast<const T*>(b0);
    o.bias[1] = static_cast<const T*>(b1);
    o.stats = stats_ws;
    return gn::launch_mma_conv_fwd(ld, o, static_cast<const T*>(w0), static_cast<const T*>(w1),
                                   conv_table, static_cast<T*>(operand), static_cast<T*>(joined),
                                   static_cast<T*>(wpack), zero_poles, B, cout, 2, stats, stream);
  } else {
    gn::ConvOut<T> co = {};
    for (int i = 0; i < 8; ++i) co.out[i] = static_cast<T*>(outs[i]);
    co.w[0] = static_cast<const T*>(w0);
    co.w[1] = static_cast<const T*>(w1);
    co.bias[0] = static_cast<const T*>(b0);
    co.bias[1] = static_cast<const T*>(b1);
    co.stats = stats_ws;
    return gn::launch_conv_gemm<T>(ld, co, conv_table, B, 5 * h * w, cin, cout, 2, 0, 4, stats,
                                   stream);
  }
}

template <typename T>
cudaError_t dx(const void* const* g, const void* const* y, const float* gs0, const float* gs1,
               const void* w0, const void* w1, const void* const* pair, const float* const* aff,
               void* const* outs, const int* offsets, const int* cells, const float* weights,
               float* red, float* const* daff, float* gsum_ws, float* gsum0, float* gsum1, int B,
               int h, int w, int cin, int cout, int gsum_rows, cudaStream_t stream) {
  const int M = 5 * h * w;
  const gn::GLoad<T> gl = gn::make_gload<T>(g, y, gs0, gs1, M, cout, 2, 4);
  gn::DxPairOut<T> o = {};
  for (int i = 0; i < 8; ++i) {
    o.out[i] = static_cast<T*>(outs[i]);
    o.raw[i] = static_cast<const T*>(pair[i]);
  }
  for (int i = 0; i < 4; ++i) o.aff[i] = aff[i];
  o.red = red;
  o.lh = log2i(h);
  o.lw = log2i(w);
  dim3 grid((M + gn::BM - 1) / gn::BM, (cin + gn::BN - 1) / gn::BN, B);
  gn::dx_gemm<T, gn::GLoad<T>, gn::DxPairOut<T>><<<grid, gn::NT, 0, stream>>>(
      gl, static_cast<const T*>(w0), static_cast<const T*>(w1), offsets, cells, weights, o, M,
      cin, 2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the (blocks, 3 * cin) partials' columns: d_mul1, d_add1, d_mul2
  const gn::StackOut st = {{daff[0], daff[1], daff[2], nullptr}, cin};
  err = gn::launch_sum_rows(red, (int)(grid.x * grid.z), 3LL * cin, st, stream);
  if (err != cudaSuccess || gsum_ws == nullptr) return err;
  return gn::launch_gsum<T>(gl, B, 2, gsum_rows, gsum_ws, gsum0, gsum1, stream);
}

// float32: the SIMT GEMM over the pair loader; bf16: the pair joined once
// into `joined`, the operand pass over it into `operand`, then the
// tensor-core GEMM
template <typename T>
cudaError_t dtaps(const void* const* pair, const float* const* aff, const void* const* g,
                  const void* const* y, const float* gs0, const float* gs1,
                  const int* conv_table, const int* up_table, float* ws, float* dt0, float* dt1,
                  void* operand, void* joined, int B, int h, int w, int cin, int cout, int kc,
                  int n_chunks, int zero_poles, cudaStream_t stream) {
  const int M = 5 * h * w;
  const gn::GLoad<T> gl = gn::make_gload<T>(g, y, gs0, gs1, M, cout, 2, 4);
  const auto ld = pair_load<T>(pair, aff, up_table, h, w, cin);
  if constexpr (std::is_same_v<T, float>)
    return gn::launch_dtaps_gemm<T>(ld, gl, conv_table, cin, 2, 0, B * 4 * M, kc, n_chunks, ws,
                                    dt0, dt1, stream);
  else
    return gn::launch_mma_dtaps(ld, gl, conv_table, static_cast<T*>(operand),
                                static_cast<T*>(joined), zero_poles, B, cin, 2, kc, n_chunks, ws,
                                dt0, dt1, stream);
}

// The pair's level-s grid needs parity phases: h = 2^lh >= 2, w = 2h.
bool bad_shape(int h, int w) { return h < 2 || (h & (h - 1)) != 0 || w != 2 * h; }

}  // namespace

// pair: host array of 8 pointers, b0[4] then y10[4], each a (B, 5, h/2,
// w/2, cin) phase of the level-s grid; aff: host array of 4 float32 (cin)
// pointers, mul1, add1, mul2, add2; w0/w1: taps (7, cin, cout); b0/b1: bias
// (cout) or null; outs: host array of 8 pointers, set-major, each (B, 5, h,
// w, cout), the level-(s+1) phases; conv_table: int32 (4, 7, 5*h*w) from
// halo.phase_conv_table; up_table: int32 (4*5*h*w, 2) from
// halo.upsample_table; stats_ws: null (no stats) or float32 scratch of the
// block partials, as in gn_up_dual_conv_fwd with n_sets = 2, and then
// st0/st1 receive each set's (2, cout) [sum, sumsq]; operand, wpack,
// zero_poles: as in gn_up_dual_conv_fwd; joined: bfloat16 only, scratch of
// (B, 5, h, w, cin) for the joined level-s grid. dtype: 0 float32, 1
// bfloat16.
extern "C" int gn_up_pair_fwd(const void* const* pair, const float* const* aff, const void* w0,
                              const void* b0, const void* w1, const void* b1, void* const* outs,
                              const int* conv_table, const int* up_table, float* stats_ws,
                              float* st0, float* st1, void* operand, void* joined, void* wpack,
                              int B, int h, int w, int cin, int cout, int zero_poles, int dtype,
                              void* stream) {
  if (bad_shape(h, w)) return cudaErrorInvalidValue;
  float* stats[2] = {st0, st1};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(pair, aff, w0, b0, w1, b1, outs, conv_table, up_table, stats_ws, stats,
                      nullptr, nullptr, nullptr, B, h, w, cin, cout, zero_poles, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(pair, aff, w0, b0, w1, b1, outs, conv_table, up_table, stats_ws,
                              stats, operand, joined, wpack, B, h, w, cin, cout, zero_poles, s);
  return cudaErrorInvalidValue;
}

// g: host array of 8 cotangent pointers (set-major), each (B, 5, h, w,
// cout), the level-(s+1) phases; y, gs0, gs1: null, or the forward outputs
// and the (2, cout) stats cotangents for the fold; w0/w1: taps (7, cin,
// cout); pair, aff: as in gn_up_pair_fwd; outs: host array of 8 pointers,
// db0[4] then dy10[4], each (B, 5, h/2, w/2, cin); offsets/cells/weights:
// halo.up_dx_table(h, w, mode); red: float32 scratch of (B * ceil(5hw/64),
// 3 * cin); daff: host array of 3 float32 (cin) pointers receiving d_mul1,
// d_add1 (= d_add2) and d_mul2; gsum_ws: null, or float32 scratch of
// (ceil(B * 4 * 5hw / gsum_rows), 2 * cout) and gsum0/gsum1 receive Σg_eff
// (cout). dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_pair_dx(const void* const* g, const void* const* y, const float* gs0,
                             const float* gs1, const void* w0, const void* w1,
                             const void* const* pair, const float* const* aff, void* const* outs,
                             const int* offsets, const int* cells, const float* weights,
                             float* red, float* const* daff, float* gsum_ws, float* gsum0,
                             float* gsum1, int B, int h, int w, int cin, int cout, int gsum_rows,
                             int dtype, void* stream) {
  if (bad_shape(h, w)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dx<float>(g, y, gs0, gs1, w0, w1, pair, aff, outs, offsets, cells, weights, red, daff,
                     gsum_ws, gsum0, gsum1, B, h, w, cin, cout, gsum_rows, s);
  if (dtype == 1)
    return dx<__nv_bfloat16>(g, y, gs0, gs1, w0, w1, pair, aff, outs, offsets, cells, weights,
                             red, daff, gsum_ws, gsum0, gsum1, B, h, w, cin, cout, gsum_rows, s);
  return cudaErrorInvalidValue;
}

// pair, aff: as in gn_up_pair_fwd; g, y, gs0, gs1: as in gn_up_pair_dx;
// conv_table / up_table: halo.phase_conv_table and halo.upsample_table; ws:
// float32 scratch of (n_chunks, 7 * cin, 2 * cout), the rows B * 4 * 5hw
// split in chunks of kc (float32: a multiple of 16; bfloat16: of 32);
// dt0/dt1 receive (7, cin, cout) float32; operand, zero_poles: as in
// gn_up_dual_conv_dtaps; joined: bfloat16 only, scratch of (B, 5, h, w,
// cin) for the joined level-s grid. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_pair_dtaps(const void* const* pair, const float* const* aff,
                                const void* const* g, const void* const* y, const float* gs0,
                                const float* gs1, const int* conv_table, const int* up_table,
                                float* ws, float* dt0, float* dt1, void* operand, void* joined,
                                int B, int h, int w, int cin, int cout, int kc, int n_chunks,
                                int zero_poles, int dtype, void* stream) {
  if (bad_shape(h, w) || kc % gn::BK != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dtaps<float>(pair, aff, g, y, gs0, gs1, conv_table, up_table, ws, dt0, dt1, nullptr,
                        nullptr, B, h, w, cin, cout, kc, n_chunks, zero_poles, s);
  if (dtype == 1)
    return dtaps<__nv_bfloat16>(pair, aff, g, y, gs0, gs1, conv_table, up_table, ws, dt0, dt1,
                                operand, joined, B, h, w, cin, cout, kc, n_chunks, zero_poles, s);
  return cudaErrorInvalidValue;
}

// The joined pair's upsampled operand alone (the first two launches of the
// bf16 dtaps): pair, aff as in gn_up_pair_fwd, up_table as in
// gn_up_pair_dtaps; out: (B * (4 * 5hw + 2) + 1, cin rounded up to 8) in the
// pair's dtype; joined: scratch of (B, 5, h, w, cin) in that dtype.
extern "C" int gn_up_pair_operand(const void* const* pair, const float* const* aff,
                                  const int* up_table, void* out, void* joined, int B, int h,
                                  int w, int cin, int zero_poles, int dtype, void* stream) {
  if (bad_shape(h, w)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gn::launch_up_operand(pair_load<float>(pair, aff, up_table, h, w, cin),
                                 static_cast<float*>(out), static_cast<float*>(joined), B,
                                 zero_poles, s);
  if (dtype == 1)
    return gn::launch_up_operand(pair_load<__nv_bfloat16>(pair, aff, up_table, h, w, cin),
                                 static_cast<__nv_bfloat16*>(out),
                                 static_cast<__nv_bfloat16*>(joined), B, zero_poles, s);
  return cudaErrorInvalidValue;
}

// out[4]: as gn_up_dual_conv_dtaps_info, for n's tensor-core GEMM.
extern "C" int gn_up_pair_dtaps_info(int fold, int* out) {
  return fold ? gn::mma_dtaps_info<gn::PairCells<__nv_bfloat16>, true>(out)
              : gn::mma_dtaps_info<gn::PairCells<__nv_bfloat16>, false>(out);
}

// out[4]: as gn_up_dual_conv_fwd_info, for n's tensor-core forward GEMM.
extern "C" int gn_up_pair_fwd_info(int stats, int* out) {
  return stats ? gn::mma_conv_fwd_info<gn::PairCells<__nv_bfloat16>, true>(out)
               : gn::mma_conv_fwd_info<gn::PairCells<__nv_bfloat16>, false>(out);
}
