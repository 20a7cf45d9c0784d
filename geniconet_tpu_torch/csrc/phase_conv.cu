// The grid convs' forward, one launcher for both: the phase-form hex conv
// (4 parity phases of a level-s grid in; 1 or 2 tap sets; either all 4
// output phases, stride 1, or output phase 2 alone, stride 2, which is the
// standard level-(s-1) grid) and the standard-layout hex conv at stride 1
// or 2 (a (B, 5, h, w, C_in) grid in, (B, 5, h/stride, w/stride, C_out)
// out), each with an
// optional relu(x*mul + add) prologue and optional BatchNorm [sum, sumsq]
// stats of the downcast outputs (block partials, then a fixed-order second
// pass, so the sums are deterministic).
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_phase_conv_fwd
// (kernel body _pc_fwd_kernel), as called by fused_phase_conv_s1 and
// fused_dual_s2_conv, and geniconet_tpu/ops/pallas/conv_kernel.py:
// _pallas_forward (kernel body _kernel), as called by fused_ico_conv_s2s
// (each DownBlock's conv01 through IcoConvS2S), at stride 1 and 2.
//
// Design. The Pallas kernels built the padded grids (the phase pad, ico_pad)
// in VMEM; here the halo is resolved through an int32 table over the
// unpadded sources (halo.phase_conv_table, halo.std_conv_table: a cell of a
// source, a pole mean, or zero), with the act prologue and the pole means
// applied as GridLoad (common.cuh) gives them. The standard conv is the
// phase conv's GEMM over one source and one table. At stride 2 its table
// (halo.std_conv_table, stride 2: the Pallas _tap_slice centres
// P[2r+2, 2q+1]) names M = 5hw / 4 output cells, each reading the one
// (5, h, w) grid: the GEMM's rows are the output cells, its operand the
// input grid's 5hw cells and two poles, so only the row count changes. It
// is the same function as the phase conv at output phase 2 on the grid's
// parity phases (the two tables name the same cells; PERF.md).
// - float32: the SIMT implicit GEMM gn::conv_gemm over GridLoad, each
//   operand element gathered on load; bound by the float32 FMA rate of the
//   CUDA cores (2 * 7 * C_in FLOPs per output value against a few bytes in
//   and out).
// - bfloat16: the act-applied operand written once (gn::grid_operand_pass,
//   the pass b's and f's dtaps run), the taps packed once, then the
//   tensor-core GEMM with the stats epilogue (mma_conv_fwd.cuh, which says
//   what bounds it).
#include <type_traits>

#include "mma_conv_fwd.cuh"

namespace {

// n_src sources x[0 .. n_src-1] with their act prologue, as the GEMMs read
// them (the south pole from the last source: phase oq, or the one grid).
template <typename T>
gn::GridLoad<T> grid_load(const void* const* x, int n_src, const float* mul, const float* add,
                          int h, int w, int cin) {
  gn::GridLoad<T> ld = {};
  for (int p = 0; p < 4; ++p) ld.src[p] = static_cast<const T*>(x[p < n_src ? p : 0]);
  ld.mul = mul;
  ld.add = add;
  ld.hw = h * w;
  ld.hw5 = 5 * h * w;
  ld.cin = cin;
  ld.south_src = n_src - 1;
  return ld;
}

// M: the output cells a phase (5hw, or 5hw / 4 for the standard conv at
// stride 2) over (h, w) sources.
template <typename T, typename Tag>
cudaError_t run(const void* const* x, int n_src, const float* mul, const float* add,
                const void* w0, const void* b0, const void* w1, const void* b1,
                void* const* outs, const int* table, float* stats_ws, float* const* stats,
                void* operand, void* wpack, int zero_poles, int B, int h, int w, int cin,
                int cout, int M, int n_sets, int out_phase0, int n_out, cudaStream_t stream) {
  const gn::GridLoad<T> ld = grid_load<T>(x, n_src, mul, add, h, w, cin);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    gn::FwdOut o = {};
    for (int i = 0; i < n_sets * n_out; ++i)
      o.out[i / n_out][i % n_out] = static_cast<T*>(outs[i]);
    o.bias[0] = static_cast<const T*>(b0);
    o.bias[1] = static_cast<const T*>(b1);
    o.stats = stats_ws;
    return gn::launch_grid_mma_fwd<Tag>(ld, n_src, table, M, o, static_cast<const T*>(w0),
                                        static_cast<const T*>(w1), static_cast<T*>(operand),
                                        static_cast<T*>(wpack), zero_poles, B, cout, n_sets,
                                        out_phase0, n_out, stats, stream);
  } else {
    gn::ConvOut<T> co = {};
    for (int i = 0; i < n_sets * n_out; ++i) co.out[i] = static_cast<T*>(outs[i]);
    co.w[0] = static_cast<const T*>(w0);
    co.w[1] = static_cast<const T*>(w1);
    co.bias[0] = static_cast<const T*>(b0);
    co.bias[1] = static_cast<const T*>(b1);
    co.stats = stats_ws;
    return gn::launch_conv_gemm<T>(ld, co, table, B, M, cin, cout, n_sets, out_phase0, n_out,
                                   stats, stream);
  }
}

template <typename Tag>
int grid_fwd(const void* const* x, int n_src, const float* mul, const float* add, const void* w0,
             const void* b0, const void* w1, const void* b1, void* const* outs, const int* table,
             float* stats_ws, float* const* stats, void* operand, void* wpack, int zero_poles,
             int B, int h, int w, int cin, int cout, int M, int n_sets, int out_phase0, int n_out,
             int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, Tag>(x, n_src, mul, add, w0, b0, w1, b1, outs, table, stats_ws, stats,
                           nullptr, nullptr, zero_poles, B, h, w, cin, cout, M, n_sets,
                           out_phase0, n_out, s);
  if (dtype == 1)
    return run<__nv_bfloat16, Tag>(x, n_src, mul, add, w0, b0, w1, b1, outs, table, stats_ws,
                                   stats, operand, wpack, zero_poles, B, h, w, cin, cout, M,
                                   n_sets, out_phase0, n_out, s);
  return cudaErrorInvalidValue;
}

template <typename Tag>
int fwd_info(int stats, int* out) {
  return stats ? gn::mma_conv_fwd_info<Tag, true>(out) : gn::mma_conv_fwd_info<Tag, false>(out);
}

}  // namespace

extern "C" const char* gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x0..x3: phases (B, 5, h, w, cin); act_mul/act_add: float32 (cin) or null;
// w0/w1: taps (7, cin, cout), b0/b1: bias (cout) or null (set 1 unused when
// n_sets == 1); outs: host array of n_sets * n_out output pointers, set-major,
// each (B, 5, h, w, cout); table: int32 (4, 7, 5*h*w) from
// halo.phase_conv_table; output phases are out_phase0 .. out_phase0+n_out-1;
// stats_ws: null (no stats) or float32 scratch of the block partials,
// (B * n_out * ceil(5hw/64), 2 * n_sets * cout) in float32,
// (ceil(B * n_out * 5hw / 128), 2 * n_sets * cout) in bfloat16, and then
// st0/st1 receive each set's (2, cout) [sum, sumsq]. bfloat16 only (else
// the call is refused): operand, scratch of (B * (4 * 5hw + 2) + 1, cin
// rounded up to 8) for the act-applied operand (zero_poles: corner_mode
// "zeros"); wpack, scratch of (7 * cin rounded up to 32, n_sets * cout
// rounded up to 128) for the packed taps. dtype: 0 float32, 1 bfloat16.
// Returns the cudaError_t.
extern "C" int gn_phase_conv_fwd(const void* x0, const void* x1, const void* x2, const void* x3,
                                 const float* act_mul, const float* act_add, const void* w0,
                                 const void* b0, const void* w1, const void* b1,
                                 void* const* outs, const int* table, float* stats_ws,
                                 float* st0, float* st1, void* operand, void* wpack, int B, int h,
                                 int w, int cin, int cout, int n_sets, int out_phase0, int n_out,
                                 int zero_poles, int dtype, void* stream) {
  if (n_sets < 1 || n_sets > 2 || n_out < 1 || out_phase0 + n_out > 4)
    return cudaErrorInvalidValue;
  const void* x[4] = {x0, x1, x2, x3};
  float* stats[2] = {st0, st1};
  return grid_fwd<gn::PhaseGrid>(x, 4, act_mul, act_add, w0, b0, w1, b1, outs, table, stats_ws,
                                 stats, operand, wpack, zero_poles, B, h, w, cin, cout, 5 * h * w,
                                 n_sets, out_phase0, n_out, dtype, stream);
}

// x: (B, 5, h, w, cin); act_mul/act_add: float32 (cin) or null; taps:
// (7, cin, cout); bias: (cout) or null; stride: 1 or 2, and M = 5hw /
// stride^2 output cells; out: (B, 5, h/stride, w/stride, cout); table:
// int32 (7, M) from halo.std_conv_table at that stride; stats_ws: null (no
// stats) or float32 scratch of the block partials, (B * ceil(M/64), 2 *
// cout) in float32, (ceil(B * M / 128), 2 * cout) in bfloat16, and then
// st0 receives the (2, cout) [sum, sumsq]. bfloat16 only: operand, scratch
// of (B * (5hw + 2) + 1, cin rounded up to 8), and wpack, as in
// gn_phase_conv_fwd. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_ico_conv_fwd(const void* x, const float* act_mul, const float* act_add,
                               const void* taps, const void* bias, void* out, const int* table,
                               float* stats_ws, float* st0, void* operand, void* wpack, int B,
                               int h, int w, int cin, int cout, int stride, int zero_poles,
                               int dtype, void* stream) {
  if ((stride != 1 && stride != 2) || h % stride != 0) return cudaErrorInvalidValue;
  const void* src[4] = {x, x, x, x};
  void* outs[1] = {out};
  float* stats[2] = {st0, nullptr};
  return grid_fwd<gn::StdGrid>(src, 1, act_mul, act_add, taps, bias, nullptr, nullptr, outs,
                               table, stats_ws, stats, operand, wpack, zero_poles, B, h, w, cin,
                               cout, 5 * h * w / (stride * stride), 1, 0, 1, dtype, stream);
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of the phase conv's (gn_phase_conv_fwd_info) or the
// standard conv's bf16 tensor-core forward GEMM, with stats or without.
extern "C" int gn_phase_conv_fwd_info(int stats, int* out) {
  return fwd_info<gn::PhaseGrid>(stats, out);
}

extern "C" int gn_ico_conv_fwd_info(int stats, int* out) {
  return fwd_info<gn::StdGrid>(stats, out);
}
