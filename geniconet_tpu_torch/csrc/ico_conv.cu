// Standard-layout hex conv, stride 1, forward: a (B, 5, h, w, C_in) grid in
// with an optional relu(x*mul + add) prologue, (B, 5, h, w, C_out) out.
//
// Replaces: geniconet_tpu/ops/pallas/conv_kernel.py:_pallas_forward (kernel
// body _kernel), as called by fused_ico_conv_s2s (each DownBlock's conv01
// through IcoConvS2S), stride 1, with its optional BatchNorm [sum, sumsq]
// stats of the downcast output (per-block partials in the GEMM's epilogue,
// then the fixed-order second pass, as phase_conv.cu).
//
// What bounds it on the card: the float32 FMA rate of the CUDA cores, as
// for phase_conv.cu, whose implicit-GEMM core it shares. The Pallas kernel
// built the ico_pad halo in VMEM; here the halo is resolved on load through
// an int32 table (halo.std_conv_table) over the unpadded grid, with the act
// prologue and the pole means applied on load, so neither the activated nor
// the padded tensor reaches device memory.
#include "common.cuh"

namespace {

template <typename T>
cudaError_t run(const void* x, const float* mul, const float* add, const void* w0, const void* b0,
                void* out, const int* table, float* stats_ws, float* st0, int B, int h, int w,
                int cin, int cout, cudaStream_t stream) {
  gn::GridLoad<T> ld = {};
  ld.src[0] = static_cast<const T*>(x);
  ld.mul = mul;
  ld.add = add;
  ld.hw = h * w;
  ld.hw5 = 5 * h * w;
  ld.cin = cin;
  ld.south_src = 0;
  gn::ConvOut<T> co = {};
  co.out[0] = static_cast<T*>(out);
  co.w[0] = static_cast<const T*>(w0);
  co.bias[0] = static_cast<const T*>(b0);
  co.stats = stats_ws;
  float* stats[2] = {st0, nullptr};
  return gn::launch_conv_gemm<T>(ld, co, table, B, 5 * h * w, cin, cout, 1, 0, 1, stats, stream);
}

}  // namespace

// x: (B, 5, h, w, cin); act_mul/act_add: float32 (cin) or null; taps:
// (7, cin, cout); bias: (cout) or null; out: (B, 5, h, w, cout); table:
// int32 (7, 5*h*w) from halo.std_conv_table; stats_ws: null (no stats) or
// float32 scratch of (B * ceil(5hw/64), 2 * cout), and then st0 receives the
// (2, cout) [sum, sumsq]. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_ico_conv_fwd(const void* x, const float* act_mul, const float* act_add,
                               const void* taps, const void* bias, void* out, const int* table,
                               float* stats_ws, float* st0, int B, int h, int w, int cin,
                               int cout, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, act_mul, act_add, taps, bias, out, table, stats_ws, st0, B, h, w, cin,
                      cout, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, act_mul, act_add, taps, bias, out, table, stats_ws, st0, B, h,
                              w, cin, cout, s);
  return cudaErrorInvalidValue;
}
