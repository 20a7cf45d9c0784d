// A whole DownBlock's training forward in one launch (kernel p): both
// stride-2 convs (output phase 2 of the phase conv, the standard
// level-(s-1) grid) with an optional pending act prologue and their
// BatchNorm stats (pass A), bn00's affine in the kernel, then conv01 as
// the standard 7-tap conv with the affine as its act prologue, with its
// stats (pass B). See block_fwd.cuh.
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_dn_block_fwd_impl
// (kernel body _dn_block_kernel), as called by fused_down_block. As for
// up_block.cu, the sequential 2G grid becomes two tile loops of a
// persistent cooperative grid split by grid barriers, and y00 an ordinary
// output without the TPU's lane padding.
//
// Pass A is the float32 SIMT tiles of phase_conv.cu's phase conv
// (gn::GridLoad over the 4 input phases, two tap sets, out phase 2), pass B
// those of its standard conv (gn::GridLoad over y00, halo.std_conv_table);
// every output and sum equals the split route's (phase_conv_fwd with stats,
// the affine, then ico_conv_s2s_fwd with stats) bit for bit in float32. In
// bf16 the split route runs the tensor-core GEMM (mma_conv_fwd.cuh), whose
// float32 sums are taken in another order: each output is within one bf16
// ulp of the split route's.
//
// What bounds it on the card: the float32 FMA rate of the GEMM tiles.
#include "block_fwd.cuh"

namespace {

template <typename T>
cudaError_t run(const void* const* x, const float* in_mul, const float* in_add,
                const void* const* wb, const float* gamma, const float* beta, void* const* outs,
                const int* phase_table, const int* std_table, float* part_a, float* part_b,
                float* const* stats, float* mul00, float* add00, unsigned* bar, int B, int h,
                int w, int cin, int c0, int c2, float count, float eps, cudaStream_t stream) {
  const int M = 5 * h * w;
  gn::TwoPass<T, gn::GridLoad<T>> a = {};
  for (int p = 0; p < 4; ++p) a.lda.src[p] = static_cast<const T*>(x[p]);
  a.lda.mul = in_mul;
  a.lda.add = in_add;
  a.lda.hw = h * w;
  a.lda.hw5 = M;
  a.lda.cin = cin;
  a.lda.south_src = 3;
  for (int s = 0; s < 2; ++s) {
    a.coa.out[s] = static_cast<T*>(outs[s]);  // y00, y10
    a.coa.w[s] = static_cast<const T*>(wb[2 * s]);
    a.coa.bias[s] = static_cast<const T*>(wb[2 * s + 1]);
  }
  a.coa.stats = part_a;
  a.pa = gn::make_pass(phase_table, B, M, cin, c0, 2, 2, 1);
  a.ldb.src[0] = static_cast<const T*>(outs[0]);
  a.ldb.hw = h * w;
  a.ldb.hw5 = M;
  a.ldb.cin = c0;
  a.ldb.south_src = 0;
  a.cob.out[0] = static_cast<T*>(outs[2]);  // b0
  a.cob.w[0] = static_cast<const T*>(wb[4]);
  a.cob.bias[0] = static_cast<const T*>(wb[5]);
  a.cob.stats = part_b;
  a.pb = gn::make_pass(std_table, B, M, c0, c2, 1, 0, 1);
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

// x: host array of the 4 parity phases (B, 5, h, w, cin) of the level-s
// input; in_mul/in_add: float32 (cin) or null, the pending act prologue;
// wb: host array of 6 pointers, taps (7, cin, c0) and bias (c0) or null of
// conv00 and conv10, taps (7, c0, c2) and bias (c2) or null of conv01;
// gamma/beta: bn00's float32 (c0); outs: host array of 3 pointers, the
// level-(s-1) grids (B, 5, h, w, .) y00 (c0), y10 (c0), b0 (c2);
// phase_table: int32 (4, 7, 5hw) from halo.phase_conv_table; std_table:
// int32 (7, 5hw) from halo.std_conv_table; part_a / part_b: float32 scratch
// of (B * ceil(5hw/64), 4 c0) and (B * ceil(5hw/64), 2 c2); s00, s10, s01:
// float32 (2, C) out; mul00, add00: float32 (c0) out; bar: 2 zeroed
// uint32; count: B*5hw; dtype: 0 float32, 1 bfloat16.
extern "C" int gn_dn_block_fwd(const void* const* x, const float* in_mul, const float* in_add,
                               const void* const* wb, const float* gamma, const float* beta,
                               void* const* outs, const int* phase_table, const int* std_table,
                               float* part_a, float* part_b, float* s00, float* s10, float* s01,
                               float* mul00, float* add00, unsigned* bar, int B, int h, int w,
                               int cin, int c0, int c2, float count, float eps, int dtype,
                               void* stream) {
  float* stats[3] = {s00, s10, s01};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, in_mul, in_add, wb, gamma, beta, outs, phase_table, std_table, part_a,
                      part_b, stats, mul00, add00, bar, B, h, w, cin, c0, c2, count, eps, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, in_mul, in_add, wb, gamma, beta, outs, phase_table, std_table,
                              part_a, part_b, stats, mul00, add00, bar, B, h, w, cin, c0, c2,
                              count, eps, s);
  return cudaErrorInvalidValue;
}
