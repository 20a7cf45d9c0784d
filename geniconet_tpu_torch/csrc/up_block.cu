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
// float32: pass A is up_conv.cu's float32 SIMT tiles (gn::UpLoad, both tap
// sets), pass B phase_conv.cu's (gn::GridLoad over y00's 4 phases) in
// block_fwd.cuh's two_pass_block; bound by the float32 FMA rate of the GEMM
// tiles. bf16: the split route's tensor-core passes in one cooperative
// launch (mma_block_fwd.cuh): the upsampled operand, the packed taps, the
// GEMM with stats, then the phase conv's act-applied operand of y00 and its
// GEMM; bound by the tensor cores' bf16 rate. In both every output and sum
// equals the split route's (up_dual_conv_fwd with stats, the affine, then
// phase_conv_fwd with stats) bit for bit; the merge saves the launches and
// the affine's small PyTorch kernels between them, not GEMM time.
#include "mma_block_fwd.cuh"

namespace {

using bf16 = __nv_bfloat16;

// bf16: pass A over the upsampled operand (4 output phases from 0, both
// sets), pass B over y00's 4 phases with the affine (the phase conv).
cudaError_t run_mma(const void* x, const void* const* wb, const float* gamma, const float* beta,
                    void* const* outs, const int* conv_table, const int* up_table, float* part_a,
                    float* part_b, float* const* stats, float* mul00, float* add00,
                    unsigned* bar, void* operand, void* wpack_a, void* wpack_b, int B, int h,
                    int w, int cin, int c0, int c2, float count, float eps, int zero_poles,
                    cudaStream_t stream) {
  if (operand == nullptr || wpack_a == nullptr || wpack_b == nullptr) return cudaErrorInvalidValue;
  const int M = 5 * h * w;
  gn::MmaTwoPass<gn::UpLoad<bf16>> a = {};
  a.lda.x = {static_cast<const bf16*>(x)};
  a.lda.up = up_table;
  a.lda.hw = h * w;
  a.lda.hw5 = M;
  a.lda.cin = cin;
  a.opa = a.opb = static_cast<bf16*>(operand);
  a.n_src_a = 4;
  a.total_a = gn::operand_total(B, M, 4, cin);
  a.vec_a = cin % 8 == 0 && gn::aligned16(x);
  gn::FwdOut oa = {};
  for (int i = 0; i < 8; ++i) oa.out[i / 4][i % 4] = static_cast<bf16*>(outs[i]);  // y00, y10
  oa.bias[0] = static_cast<const bf16*>(wb[1]);
  oa.bias[1] = static_cast<const bf16*>(wb[3]);
  oa.stats = part_a;
  a.pa = gn::mma_pass(a.opa, conv_table, B, M, 4, cin, c0, 2, 0, 4, oa,
                      static_cast<const bf16*>(wb[0]), static_cast<const bf16*>(wb[2]),
                      static_cast<bf16*>(wpack_a));
  for (int p = 0; p < 4; ++p) a.ldb.src[p] = static_cast<const bf16*>(outs[p]);
  a.ldb.mul = a.mul_out = mul00;
  a.ldb.add = a.add_out = add00;
  a.ldb.hw = h * w;
  a.ldb.hw5 = M;
  a.ldb.cin = c0;
  a.ldb.south_src = 3;
  a.n_src_b = 4;
  a.total_b = gn::operand_total(B, M, 4, c0);
  a.vec_b = gn::grid_operand_vec(a.ldb, 4);
  gn::FwdOut ob = {};
  for (int p = 0; p < 4; ++p) ob.out[0][p] = static_cast<bf16*>(outs[8 + p]);  // b0
  ob.bias[0] = static_cast<const bf16*>(wb[5]);
  ob.stats = part_b;
  a.pb = gn::mma_pass(a.opb, conv_table, B, M, 4, c0, c2, 1, 0, 4, ob,
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
cudaError_t run_simt(const void* x, const void* const* wb, const float* gamma,
                     const float* beta, void* const* outs, const int* conv_table,
                     const int* up_table, float* part_a, float* part_b, float* const* stats,
                     float* mul00, float* add00, unsigned* bar, int B, int h, int w, int cin,
                     int c0, int c2, float count, float eps, cudaStream_t stream) {
  using T = float;
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
// halo.upsample_table; part_a / part_b: float32 scratch of the row tiles'
// partials, (4B * ceil(5hw/64), 4 c0) and (4B * ceil(5hw/64), 2 c2) in
// float32, (ceil(4B * 5hw / 128), .) in bfloat16; s00, s10, s01: float32 (2,
// C) [sum, sumsq] out; mul00, add00: float32 (c0) out; bar: zeroed uint32,
// 2 (the grid barrier's) and in bfloat16 2 + MAX_SLOTS + MAX_SM_IDS (then
// gn::sm_order's counters); bfloat16 only (else unused): operand, scratch
// of (B * (4 * 5hw +
// 2) + 1) rows of cin and of c0 channels rounded up to 8, whichever is
// larger (pass A's upsampled operand, then pass B's), wpack_a and wpack_b,
// the packed taps of conv00 + conv10 ((7 * cin rounded up to 32, 2 c0
// rounded up to 128)) and of conv01 ((7 * c0 .., c2 ..)); count: 4*B*5hw;
// zero_poles: corner_mode "zeros"; dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_block_fwd(const void* x, const void* const* wb, const float* gamma,
                               const float* beta, void* const* outs, const int* conv_table,
                               const int* up_table, float* part_a, float* part_b, float* s00,
                               float* s10, float* s01, float* mul00, float* add00, unsigned* bar,
                               void* operand, void* wpack_a, void* wpack_b, int B, int h, int w,
                               int cin, int c0, int c2, float count, float eps, int zero_poles,
                               int dtype, void* stream) {
  float* stats[3] = {s00, s10, s01};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_simt(x, wb, gamma, beta, outs, conv_table, up_table, part_a, part_b, stats,
                    mul00, add00, bar, B, h, w, cin, c0, c2, count, eps, s);
  if (dtype == 1)
    return run_mma(x, wb, gamma, beta, outs, conv_table, up_table, part_a, part_b, stats, mul00,
                   add00, bar, operand, wpack_a, wpack_b, B, h, w, cin, c0, c2, count, eps,
                   zero_poles, s);
  return cudaErrorInvalidValue;
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of the bf16 cooperative kernel.
extern "C" int gn_up_block_fwd_info(int* out) {
  return gn::mma_two_pass_info<gn::UpLoad<bf16>>(out);
}
