// A whole UpBlock's training forward in one launch (kernel o): upsample
// s -> s+1 + conv00 + conv10 with their BatchNorm stats (pass A), bn00's
// affine in the kernel, then conv01 as the phase conv with the affine as
// its act prologue, with its stats (pass B). See block_fwd.cuh.
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_up_block_fwd_impl
// (kernel body _up_block_kernel), as called by fused_up_block. The Pallas
// kernel walked a sequential 2G grid, carried the moments across programs
// and staged y00 by DMA in a 128-lane padded buffer; here the passes are
// tile loops of a persistent cooperative grid split by grid barriers, and
// y00 is an ordinary output.
//
// Pass A is up_conv.cu's float32 SIMT tiles (gn::UpLoad, both tap sets),
// pass B phase_conv.cu's (gn::GridLoad over y00's 4 phases); every output
// and sum equals the split route's (up_dual_conv_fwd with stats, the
// affine, then phase_conv_fwd with stats) bit for bit in float32. In bf16
// the split route runs the tensor-core GEMM (mma_conv_fwd.cuh), whose
// float32 sums are taken in another order: each output is within one bf16
// ulp of the split route's.
//
// What bounds it on the card: the float32 FMA rate of the GEMM tiles, as
// for the two kernels it merges; the merge saves the launches and the
// affine's small PyTorch kernels between them, not GEMM time.
#include "block_fwd.cuh"

namespace {

template <typename T>
cudaError_t run(const void* x, const void* const* wb, const float* gamma, const float* beta,
                void* const* outs, const int* conv_table, const int* up_table, float* part_a,
                float* part_b, float* const* stats, float* mul00, float* add00, unsigned* bar,
                int B, int h, int w, int cin, int c0, int c2, float count, float eps,
                cudaStream_t stream) {
  const int M = 5 * h * w;
  gn::TwoPass<T, gn::UpLoad<T>> a = {};
  a.lda.x = {static_cast<const T*>(x)};
  a.lda.up = up_table;
  a.lda.hw = h * w;
  a.lda.hw5 = M;
  a.lda.cin = cin;
  for (int i = 0; i < 8; ++i) a.coa.out[i] = static_cast<T*>(outs[i]);  // y00, y10
  for (int s = 0; s < 2; ++s) {
    a.coa.w[s] = static_cast<const T*>(wb[2 * s]);
    a.coa.bias[s] = static_cast<const T*>(wb[2 * s + 1]);
  }
  a.coa.stats = part_a;
  a.pa = gn::make_pass(conv_table, B, M, cin, c0, 2, 0, 4);
  for (int p = 0; p < 4; ++p) a.ldb.src[p] = static_cast<const T*>(outs[p]);
  a.ldb.hw = h * w;
  a.ldb.hw5 = M;
  a.ldb.cin = c0;
  a.ldb.south_src = 3;
  for (int p = 0; p < 4; ++p) a.cob.out[p] = static_cast<T*>(outs[8 + p]);  // b0
  a.cob.w[0] = static_cast<const T*>(wb[4]);
  a.cob.bias[0] = static_cast<const T*>(wb[5]);
  a.cob.stats = part_b;
  a.pb = gn::make_pass(conv_table, B, M, c0, c2, 1, 0, 4);
  a.gamma = gamma;
  a.beta = beta;
  a.s00 = stats[0];
  a.s10 = stats[1];
  a.s01 = stats[2];
  a.ldb.mul = a.mul_out = mul00;
  a.ldb.add = a.add_out = add00;
  a.count = count;
  a.eps = eps;
  a.bar = bar;
  return gn::launch_two_pass(a, stream);
}

}  // namespace

// x: (B, 5, h, w, cin) level-s grid; wb: host array of 6 pointers, taps
// (7, cin, c0) and bias (c0) or null of conv00 and conv10, taps (7, c0, c2)
// and bias (c2) or null of conv01; gamma/beta: bn00's float32 (c0);
// outs: host array of 12 pointers, the level-(s+1) phases (B, 5, h, w, .)
// of y00 (c0), y10 (c0) and b0 (c2); conv_table: int32 (4, 7, 5hw) from
// halo.phase_conv_table; up_table: int32 (4*5hw, 2) from
// halo.upsample_table; part_a / part_b: float32 scratch of (4B *
// ceil(5hw/64), 4 c0) and (4B * ceil(5hw/64), 2 c2); s00, s10, s01:
// float32 (2, C) [sum, sumsq] out; mul00, add00: float32 (c0) out; bar: 2
// zeroed uint32; count: 4*B*5hw; dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_block_fwd(const void* x, const void* const* wb, const float* gamma,
                               const float* beta, void* const* outs, const int* conv_table,
                               const int* up_table, float* part_a, float* part_b, float* s00,
                               float* s10, float* s01, float* mul00, float* add00, unsigned* bar,
                               int B, int h, int w, int cin, int c0, int c2, float count,
                               float eps, int dtype, void* stream) {
  float* stats[3] = {s00, s10, s01};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, wb, gamma, beta, outs, conv_table, up_table, part_a, part_b, stats,
                      mul00, add00, bar, B, h, w, cin, c0, c2, count, eps, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, wb, gamma, beta, outs, conv_table, up_table, part_a, part_b,
                              stats, mul00, add00, bar, B, h, w, cin, c0, c2, count, eps, s);
  return cudaErrorInvalidValue;
}
