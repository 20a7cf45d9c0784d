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
// float32: pass A is the SIMT tiles of phase_conv.cu's phase conv
// (gn::GridLoad over the 4 input phases, two tap sets, out phase 2), pass B
// those of its standard conv (gn::GridLoad over y00, halo.std_conv_table), in
// block_fwd.cuh's two_pass_block; bound by the float32 FMA rate. bf16: the
// split route's tensor-core passes in one cooperative launch
// (mma_block_fwd.cuh): the act-applied operand of the 4 input phases, the
// packed taps, the GEMM into output phase 2 with stats, then the standard
// conv's act-applied operand of y00 and its GEMM; bound by the tensor cores'
// bf16 rate. In both every output and sum equals the split route's
// (phase_conv_fwd with stats, the affine, then ico_conv_s2s_fwd with stats)
// bit for bit.
#include "mma_block_fwd.cuh"

namespace {

using bf16 = __nv_bfloat16;

// bf16: pass A over the 4 input phases' operand (out phase 2, both sets),
// pass B over y00's one grid with the affine (the standard conv).
cudaError_t run_mma(const void* const* x, const float* in_mul, const float* in_add,
                    const void* const* wb, const float* gamma, const float* beta,
                    void* const* outs, const int* phase_table, const int* std_table,
                    float* part_a, float* part_b, float* const* stats, float* mul00,
                    float* add00, unsigned* bar, void* operand, void* wpack_a, void* wpack_b,
                    int B, int h, int w, int cin, int c0, int c2, float count, float eps,
                    int zero_poles, cudaStream_t stream) {
  if (operand == nullptr || wpack_a == nullptr || wpack_b == nullptr) return cudaErrorInvalidValue;
  const int M = 5 * h * w;
  gn::MmaTwoPass<gn::GridLoad<bf16>> a = {};
  for (int p = 0; p < 4; ++p) a.lda.src[p] = static_cast<const bf16*>(x[p]);
  a.lda.mul = in_mul;
  a.lda.add = in_add;
  a.lda.hw = h * w;
  a.lda.hw5 = M;
  a.lda.cin = cin;
  a.lda.south_src = 3;
  a.opa = a.opb = static_cast<bf16*>(operand);
  a.n_src_a = 4;
  a.total_a = gn::operand_total(B, M, 4, cin);
  a.vec_a = gn::grid_operand_vec(a.lda, 4);
  gn::FwdOut oa = {};
  for (int s = 0; s < 2; ++s) oa.out[s][0] = static_cast<bf16*>(outs[s]);  // y00, y10
  oa.bias[0] = static_cast<const bf16*>(wb[1]);
  oa.bias[1] = static_cast<const bf16*>(wb[3]);
  oa.stats = part_a;
  a.pa = gn::mma_pass(a.opa, phase_table, B, M, 4, cin, c0, 2, 2, 1, oa,
                      static_cast<const bf16*>(wb[0]), static_cast<const bf16*>(wb[2]),
                      static_cast<bf16*>(wpack_a));
  for (int p = 0; p < 4; ++p) a.ldb.src[p] = static_cast<const bf16*>(outs[0]);  // y00
  a.ldb.mul = a.mul_out = mul00;
  a.ldb.add = a.add_out = add00;
  a.ldb.hw = h * w;
  a.ldb.hw5 = M;
  a.ldb.cin = c0;
  a.ldb.south_src = 0;
  a.n_src_b = 1;
  a.total_b = gn::operand_total(B, M, 1, c0);
  a.vec_b = gn::grid_operand_vec(a.ldb, 1);
  gn::FwdOut ob = {};
  ob.out[0][0] = static_cast<bf16*>(outs[2]);  // b0
  ob.bias[0] = static_cast<const bf16*>(wb[5]);
  ob.stats = part_b;
  a.pb = gn::mma_pass(a.opb, std_table, B, M, 1, c0, c2, 1, 0, 1, ob,
                      static_cast<const bf16*>(wb[4]), nullptr, static_cast<bf16*>(wpack_b));
  a.zero_poles = zero_poles;
  a.B = B;
  a.gamma = gamma;
  a.beta = beta;
  a.s00 = stats[0];
  a.s10 = stats[1];
  a.s01 = stats[2];
  a.count = count;
  a.eps = eps;
  a.bar = bar;
  a.order = bar + 2;
  return gn::launch_mma_two_pass(a, stream);
}

// float32: block_fwd.cuh's SIMT tiles.
cudaError_t run_simt(const void* const* x, const float* in_mul, const float* in_add,
                     const void* const* wb, const float* gamma, const float* beta,
                     void* const* outs, const int* phase_table, const int* std_table,
                     float* part_a, float* part_b, float* const* stats, float* mul00,
                     float* add00, unsigned* bar, int B, int h, int w, int cin, int c0, int c2,
                     float count, float eps, cudaStream_t stream) {
  using T = float;
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
// of the row tiles' partials, (B * ceil(5hw/64), 4 c0) and (B *
// ceil(5hw/64), 2 c2) in float32, (ceil(B * 5hw / 128), .) in bfloat16;
// s00, s10, s01: float32 (2, C) out; mul00, add00: float32 (c0) out; bar: as
// gn_up_block_fwd; bfloat16 only (else unused): operand, scratch of (B * (4
// * 5hw + 2) + 1) rows of cin and (B * (5hw + 2) + 1) of c0 channels, each
// rounded up to 8, whichever is larger (pass A's operand, then pass B's),
// wpack_a and wpack_b, the packed taps of conv00 + conv10 and of conv01 (as
// gn_up_block_fwd); count: B*5hw; zero_poles: corner_mode "zeros"; dtype: 0
// float32, 1 bfloat16.
extern "C" int gn_dn_block_fwd(const void* const* x, const float* in_mul, const float* in_add,
                               const void* const* wb, const float* gamma, const float* beta,
                               void* const* outs, const int* phase_table, const int* std_table,
                               float* part_a, float* part_b, float* s00, float* s10, float* s01,
                               float* mul00, float* add00, unsigned* bar, void* operand,
                               void* wpack_a, void* wpack_b, int B, int h, int w, int cin, int c0,
                               int c2, float count, float eps, int zero_poles, int dtype,
                               void* stream) {
  float* stats[3] = {s00, s10, s01};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_simt(x, in_mul, in_add, wb, gamma, beta, outs, phase_table, std_table, part_a,
                    part_b, stats, mul00, add00, bar, B, h, w, cin, c0, c2, count, eps, s);
  if (dtype == 1)
    return run_mma(x, in_mul, in_add, wb, gamma, beta, outs, phase_table, std_table, part_a,
                   part_b, stats, mul00, add00, bar, operand, wpack_a, wpack_b, B, h, w, cin, c0,
                   c2, count, eps, zero_poles, s);
  return cudaErrorInvalidValue;
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of the bf16 cooperative kernel.
extern "C" int gn_dn_block_fwd_info(int* out) {
  return gn::mma_two_pass_info<gn::GridLoad<bf16>>(out);
}
