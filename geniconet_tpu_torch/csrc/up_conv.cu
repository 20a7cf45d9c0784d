// Upsample s -> s+1 fused with both first convs of an UpBlock, forward:
// a standard level-s grid in, 2 x 4 phases of level s+1 out.
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_up_conv_fwd_impl
// (kernel body _up_fwd_kernel), as called by fused_up_dual_conv, with its
// optional BatchNorm [sum, sumsq] stats (as in phase_conv.cu).
//
// Numerics follow the Pallas kernel (gn::UpLoad in common.cuh).
//
// float32: the SIMT implicit GEMM (gn::conv_gemm) over gn::UpLoad, bound by
// the float32 FMA rate; the upsampled tensor (4x the input) is never
// written: every operand element of the contraction is rebuilt from at most
// two input cells through two int32 tables (phase halo of the new phases,
// then the midpoint pair of each new cell), for each of the 7 taps that
// read it. bf16: the operand built once, the taps packed once, then the
// tensor-core GEMM with the stats epilogue (mma_conv_fwd.cuh, which also
// says what bounds it).
#include <type_traits>

#include "mma_conv_fwd.cuh"

namespace {

template <typename T>
cudaError_t run(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
                void* const* outs, const int* conv_table, const int* up_table, float* stats_ws,
                float* const* stats, void* operand, void* wpack, int B, int h, int w, int cin,
                int cout, int n_sets, int zero_poles, cudaStream_t stream) {
  gn::UpLoad<T> ld;
  ld.x = {static_cast<const T*>(x)};
  ld.up = up_table;
  ld.hw = h * w;
  ld.hw5 = 5 * h * w;
  ld.cin = cin;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    gn::FwdOut o = {};
    for (int i = 0; i < n_sets * 4; ++i) o.out[i / 4][i % 4] = static_cast<T*>(outs[i]);
    o.bias[0] = static_cast<const T*>(b0);
    o.bias[1] = static_cast<const T*>(b1);
    o.stats = stats_ws;
    return gn::launch_mma_conv_fwd(ld, o, static_cast<const T*>(w0), static_cast<const T*>(w1),
                                   conv_table, static_cast<T*>(operand), nullptr,
                                   static_cast<T*>(wpack), zero_poles, B, cout, n_sets, stats,
                                   stream);
  } else {
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
}

}  // namespace

// x: (B, 5, h, w, cin) level-s grid; w0/w1: taps (7, cin, cout); b0/b1:
// bias (cout) or null; outs: host array of n_sets * 4 pointers, set-major,
// each (B, 5, h, w, cout), the level-(s+1) phases; conv_table: int32
// (4, 7, 5*h*w) from halo.phase_conv_table; up_table: int32 (4*5*h*w, 2)
// from halo.upsample_table; stats_ws: null (no stats) or float32 scratch of
// the block partials, (B * 4 * ceil(5hw/64), 2 * n_sets * cout) in float32
// (as gn_phase_conv_fwd), (ceil(B * 4 * 5hw / 128), 2 * n_sets * cout) in
// bfloat16; st0, st1 receive each set's (2, cout) [sum, sumsq]. bfloat16
// only: operand, scratch of (B * (4 * 5hw + 2) + 1, cin rounded up to 8)
// for the upsampled operand (zero_poles: corner_mode "zeros"); wpack,
// scratch of (7 * cin rounded up to 32, n_sets * cout rounded up to 128)
// for the packed taps. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_dual_conv_fwd(const void* x, const void* w0, const void* b0, const void* w1,
                                   const void* b1, void* const* outs, const int* conv_table,
                                   const int* up_table, float* stats_ws, float* st0, float* st1,
                                   void* operand, void* wpack, int B, int h, int w, int cin,
                                   int cout, int n_sets, int zero_poles, int dtype,
                                   void* stream) {
  if (n_sets < 1 || n_sets > 2) return cudaErrorInvalidValue;
  float* stats[2] = {st0, st1};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, w0, b0, w1, b1, outs, conv_table, up_table, stats_ws, stats, nullptr,
                      nullptr, B, h, w, cin, cout, n_sets, zero_poles, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w0, b0, w1, b1, outs, conv_table, up_table, stats_ws, stats,
                              operand, wpack, B, h, w, cin, cout, n_sets, zero_poles, s);
  return cudaErrorInvalidValue;
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of the up conv's bf16 tensor-core GEMM, with stats or
// without.
extern "C" int gn_up_dual_conv_fwd_info(int stats, int* out) {
  return stats ? gn::mma_conv_fwd_info<gn::GridCells<__nv_bfloat16>, true>(out)
               : gn::mma_conv_fwd_info<gn::GridCells<__nv_bfloat16>, false>(out);
}
