// Upsample s -> s+1 fused with both first convs of an UpBlock, forward:
// a standard level-s grid in, 2 x 4 phases of level s+1 out.
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_up_conv_fwd_impl
// (kernel body _up_fwd_kernel), as called by fused_up_dual_conv, forward
// only and without the [sum, sumsq] stats.
//
// Numerics follow the Pallas kernel: the level-s halo (ico_pad, with pole
// means cast to the activation dtype), the edge midpoints as (a + b) * 0.5
// with the sum rounded to the activation dtype, then the phase halo of the
// four new phases, whose poles are recomputed from the new phases.
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
struct UpLoad {
  const T* x;      // (B, 5, h, w, cin) level-s grid
  const int* up;   // (4 * 5hw, 2) midpoint pairs, halo.upsample_table
  int hw, hw5, cin;

  // a cell of the level-s padded grid P (a grid cell, a zero, or a pole)
  __device__ __forceinline__ float pcell(int b, int code, int k) const {
    if (code >= 0) return gn::to_f(x[((size_t)b * hw5 + code) * cin + k]);
    if (code == gn::ZERO) return 0.f;
    const int off = code == gn::NORTH ? 0 : hw - 1;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 5; ++c) acc += gn::to_f(x[((size_t)b * hw5 + c * hw + off) * cin + k]);
    return gn::round_to<T>(acc * 0.2f);
  }
  // a cell of the four upsampled phases, index p * 5hw + chart * hw + i * w + j
  __device__ __forceinline__ float ucell(int b, int idx, int k) const {
    const float a = pcell(b, up[2 * idx], k);
    const int second = up[2 * idx + 1];
    if (second == gn::NONE) return a;
    return gn::round_to<T>(gn::round_to<T>(a + pcell(b, second, k)) * 0.5f);
  }
  __device__ __forceinline__ float operator()(int b, int code, int k) const {
    if (code >= 0) return ucell(b, code, k);
    if (code == gn::ZERO) return 0.f;
    // poles of level s+1: 5-chart means of phase ee cell 0 / phase oq cell hw-1
    const int base = code == gn::NORTH ? 0 : 3 * hw5 + hw - 1;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 5; ++c) acc += ucell(b, base + c * hw, k);
    return gn::round_to<T>(acc * 0.2f);
  }
};

template <typename T>
cudaError_t run(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
                void* const* outs, const int* conv_table, const int* up_table, int B, int h,
                int w, int cin, int cout, int n_sets, cudaStream_t stream) {
  UpLoad<T> ld;
  ld.x = static_cast<const T*>(x);
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
  return gn::launch_conv_gemm<T>(ld, co, conv_table, B, 5 * h * w, cin, cout, n_sets, 0, 4,
                                 stream);
}

}  // namespace

// x: (B, 5, h, w, cin) level-s grid; w0/w1: taps (7, cin, cout); b0/b1:
// bias (cout) or null; outs: host array of n_sets * 4 pointers, set-major,
// each (B, 5, h, w, cout), the level-(s+1) phases; conv_table: int32
// (4, 7, 5*h*w) from halo.phase_conv_table; up_table: int32 (4*5*h*w, 2)
// from halo.upsample_table. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_dual_conv_fwd(const void* x, const void* w0, const void* b0, const void* w1,
                                   const void* b1, void* const* outs, const int* conv_table,
                                   const int* up_table, int B, int h, int w, int cin, int cout,
                                   int n_sets, int dtype, void* stream) {
  if (n_sets < 1 || n_sets > 2) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, w0, b0, w1, b1, outs, conv_table, up_table, B, h, w, cin, cout, n_sets,
                      s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, w0, b0, w1, b1, outs, conv_table, up_table, B, h, w, cin, cout,
                              n_sets, s);
  return cudaErrorInvalidValue;
}
