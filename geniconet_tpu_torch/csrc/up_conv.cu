// Upsample s -> s+1 fused with both first convs of an UpBlock, forward:
// a standard level-s grid in, 2 x 4 phases of level s+1 out.
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_up_conv_fwd_impl
// (kernel body _up_fwd_kernel), as called by fused_up_dual_conv, with its
// optional BatchNorm [sum, sumsq] stats (as in phase_conv.cu).
//
// Numerics follow the Pallas kernel (gn::UpLoad in common.cuh).
//
// What bounds it on the card: like phase_conv.cu, the float32 FMA rate; the
// upsampled tensor (4x the input) is never written: every operand element of
// the contraction is rebuilt from at most two input cells through two int32
// tables (phase halo of the new phases, then the midpoint pair of each new
// cell). The redundant rebuilds (up to 7 taps read each new cell) cost
// loads that stay in L1/L2; staging a padded tile in shared memory is the
// next step.
#include "common.cuh"

namespace {

template <typename T>
cudaError_t run(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
                void* const* outs, const int* conv_table, const int* up_table, float* stats_ws,
                float* const* stats, int B, int h, int w, int cin, int cout, int n_sets,
                cudaStream_t stream) {
  gn::UpLoad<T> ld;
  ld.x = {static_cast<const T*>(x)};
  ld.up = up_table;
  ld.hw = h * w;
  ld.hw5 = 5 * h * w;
  ld.cin = cin;
  gn::ConvOut<T> co = {};
  for (int i = 0; i < n_sets * 4; ++i) co.out[i] = static_cast<T*>(outs[i]);
  co.w[0] = static_cast<const T*>(w0);
  co.w[1] = static_cast<const T*>(w1);
  co.bias[0] = static_cast<const T*>(b0);
  co.bias[1] = static_cast<const T*>(b1);
  co.stats = stats_ws;
  return gn::launch_conv_gemm<T>(ld, co, conv_table, B, 5 * h * w, cin, cout, n_sets, 0, 4,
                                 stats, stream);
}

}  // namespace

// x: (B, 5, h, w, cin) level-s grid; w0/w1: taps (7, cin, cout); b0/b1:
// bias (cout) or null; outs: host array of n_sets * 4 pointers, set-major,
// each (B, 5, h, w, cout), the level-(s+1) phases; conv_table: int32
// (4, 7, 5*h*w) from halo.phase_conv_table; up_table: int32 (4*5*h*w, 2)
// from halo.upsample_table; stats_ws, st0, st1: as in gn_phase_conv_fwd
// (scratch of B * 4 * ceil(5hw/64) rows). dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_dual_conv_fwd(const void* x, const void* w0, const void* b0, const void* w1,
                                   const void* b1, void* const* outs, const int* conv_table,
                                   const int* up_table, float* stats_ws, float* st0, float* st1,
                                   int B, int h, int w, int cin, int cout, int n_sets, int dtype,
                                   void* stream) {
  if (n_sets < 1 || n_sets > 2) return cudaErrorInvalidValue;
  float* stats[2] = {st0, st1};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, w0, b0, w1, b1, outs, conv_table, up_table, stats_ws, stats, B, h, w,
                      cin, cout, n_sets, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w0, b0, w1, b1, outs, conv_table, up_table, stats_ws, stats, B,
                              h, w, cin, cout, n_sets, s);
  return cudaErrorInvalidValue;
}
