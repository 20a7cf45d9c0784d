// Phase-form hex conv, forward: 4 parity phases of a level-s grid in, with
// an optional relu(x*mul + add) prologue; 1 or 2 tap sets; either all 4
// output phases (stride 1) or output phase 2 alone (stride 2, which is the
// standard level-(s-1) grid).
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_phase_conv_fwd
// (kernel body _pc_fwd_kernel), as called by fused_phase_conv_s1 and
// fused_dual_s2_conv, with its optional BatchNorm [sum, sumsq] stats of the
// downcast outputs (per-block partials in the GEMM's epilogue, then a
// fixed-order second pass, so the sums are deterministic).
//
// What bounds it on the card: at the serving shapes (s=5, widths 64/128/256,
// B=16) the contraction does 2 * 7 * C_in FLOPs per output value against a
// few bytes per value in and out, so this float32 SIMT version is bound by
// the FMA issue rate of the CUDA cores, not by memory. The design keeps the
// halo out of device memory: the Pallas kernel built the padded phases in
// VMEM; here each operand element is gathered straight from the unpadded
// phases through an int32 table (one table read per tap and cell, shared by
// the BK channels a block stages), and the act prologue and pole means are
// applied on load. Tensor cores (wgmma on bf16) are the next step.
#include "common.cuh"

namespace {

template <typename T>
cudaError_t run(const void* const* x, const float* mul, const float* add, const void* w0,
                const void* b0, const void* w1, const void* b1, void* const* outs,
                const int* table, float* stats_ws, float* const* stats, int B, int h, int w,
                int cin, int cout, int n_sets, int out_phase0, int n_out, cudaStream_t stream) {
  gn::GridLoad<T> ld;
  for (int p = 0; p < 4; ++p) ld.src[p] = static_cast<const T*>(x[p]);
  ld.mul = mul;
  ld.add = add;
  ld.hw = h * w;
  ld.hw5 = 5 * h * w;
  ld.cin = cin;
  ld.south_src = 3;
  gn::ConvOut<T> co = {};
  for (int i = 0; i < n_sets * n_out; ++i) co.out[i] = static_cast<T*>(outs[i]);
  co.w[0] = static_cast<const T*>(w0);
  co.w[1] = static_cast<const T*>(w1);
  co.bias[0] = static_cast<const T*>(b0);
  co.bias[1] = static_cast<const T*>(b1);
  co.stats = stats_ws;
  return gn::launch_conv_gemm<T>(ld, co, table, B, 5 * h * w, cin, cout, n_sets, out_phase0,
                                 n_out, stats, stream);
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
// stats_ws: null (no stats) or float32 scratch of (B * n_out * ceil(5hw/64),
// 2 * n_sets * cout), and then st0/st1 receive each set's (2, cout)
// [sum, sumsq]. dtype: 0 float32, 1 bfloat16. Returns the cudaError_t.
extern "C" int gn_phase_conv_fwd(const void* x0, const void* x1, const void* x2, const void* x3,
                                 const float* act_mul, const float* act_add, const void* w0,
                                 const void* b0, const void* w1, const void* b1,
                                 void* const* outs, const int* table, float* stats_ws,
                                 float* st0, float* st1, int B, int h, int w,
                                 int cin, int cout, int n_sets, int out_phase0, int n_out,
                                 int dtype, void* stream) {
  if (n_sets < 1 || n_sets > 2 || n_out < 1 || out_phase0 + n_out > 4)
    return cudaErrorInvalidValue;
  const void* x[4] = {x0, x1, x2, x3};
  float* stats[2] = {st0, st1};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, act_mul, act_add, w0, b0, w1, b1, outs, table, stats_ws, stats, B, h,
                      w, cin, cout, n_sets, out_phase0, n_out, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, act_mul, act_add, w0, b0, w1, b1, outs, table, stats_ws, stats,
                              B, h, w, cin, cout, n_sets, out_phase0, n_out, s);
  return cudaErrorInvalidValue;
}
