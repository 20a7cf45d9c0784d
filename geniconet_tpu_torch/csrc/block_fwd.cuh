// A whole residual block's training forward in one launch (kernels o and
// p): two conv passes with a grid-wide barrier between them, the BatchNorm
// affine of the first pass's output computed in the kernel.
//
//   pass A: conv00 and conv10 (two tap sets) over the block's input, with
//           per-tile [sum, sumsq] partials (the conv GEMM's own tiles);
//   barrier; the partials summed in sum_rows' fixed order into s00, s10;
//   barrier; bn00's affine (mul00, add00) from s00, spread over the grid;
//   barrier; pass B: conv01 on y00 with the act prologue
//           relu(y00*mul00 + add00), again with partials;
//   barrier; the partials summed into s01.
//
// Blocks of a CUDA grid run in no order, so a pass boundary inside one
// launch needs every block resident at once: the launch is cooperative
// (cudaLaunchCooperativeKernel, one block per free slot of every SM), and
// refuses rather than deadlocks when the grid does not fit. y00, the
// partials and the affine cross the barriers through device memory and are
// read back through L2 (gn::load<true>). No float atomics: the only atomics count arrivals at the
// barrier, so every sum is the same from run to run and equals the split
// route's (the same tiles, partials and reduction order).
#pragma once

#include "common.cuh"

namespace gn {

// One conv pass as a list of the conv GEMM's tiles: gx row tiles, gy
// column tiles, gz = samples * output phases.
struct Pass {
  const int* table;
  int M, cin, cout, n_sets, out_phase0, n_out, gx, gy, gz;
};

inline Pass make_pass(const int* table, int B, int M, int cin, int cout, int n_sets,
                      int out_phase0, int n_out) {
  return {table, M, cin, cout, n_sets, out_phase0, n_out, (M + BM - 1) / BM,
          (n_sets * cout + BN - 1) / BN, B * n_out};
}

// A barrier across every block of a cooperative launch, on a pair of
// counters the wrapper zeroes: bar[0] counts arrivals, bar[1] is the
// generation. Each block fences its writes before it arrives.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T, typename Loader>
__device__ __forceinline__ void run_tiles(const Loader& ld, const ConvOut<T>& co, const Pass& p,
                                          float (&As)[BK][BM], float (&Bs)[BK][BN]) {
  for (int t = blockIdx.x; t < p.gx * p.gy * p.gz; t += gridDim.x) {
    const int bx = t % p.gx, r = t / p.gx;
    conv_tile<T, Loader, false>(ld, co, p.table, p.M, p.cin, p.cout, p.n_sets, p.out_phase0,
                                p.n_out, bx, r % p.gy, r / p.gy, p.gx, As, Bs);
    __syncthreads();  // column_sums read As / Bs last
  }
}

// sum_rows over the partials written before the last barrier, 8 columns
// at a time per block (32 row lanes each), in sum_rows' order.
template <typename Store>
__device__ __forceinline__ void reduce_columns(const float* in, int R, long long C, Store st,
                                               float (&part)[32][9]) {
  const int x = threadIdx.x % 8, y = threadIdx.x / 8;
  for (long long c0 = (long long)blockIdx.x * 8; c0 < C; c0 += (long long)gridDim.x * 8) {
    part[y][x] = column_part<true>(in, R, C, c0 + x, y);
    __syncthreads();
    if (y == 0 && c0 + x < C) st(c0 + x, column_total(part, x));
    __syncthreads();
  }
}

template <typename T, typename LoadA>
struct TwoPass {
  LoadA lda;  // pass A's loader, over the block's input
  ConvOut<T> coa;
  Pass pa;
  GridLoad<T, true> ldb;  // pass B's, over y00, its act (mul, add) = (mul_out, add_out)
  ConvOut<T> cob;
  Pass pb;
  const float* gamma;  // bn00's scale and bias (C0,)
  const float* beta;
  float* s00;  // (2, C0), (2, C0), (2, C2) [sum, sumsq]
  float* s10;
  float* s01;
  float* mul_out;  // (C0,) the affine, pass B's act, kept for the backward
  float* add_out;
  float count, eps;
  unsigned* bar;
};

// _StatsBN's affine of the nn.BatchNorm moments, as IcoBatchNorm.affine
// computes it on the card: mean = s0 * (1/count) (PyTorch divides a CUDA
// tensor by a scalar as a product with its float reciprocal), var =
// max(0, s1 * (1/count) - mean^2), mul = rsqrt(var + eps) * gamma, add =
// beta - mean * mul; each operation rounded alone, no FMA contraction.
// Channel k is thread k of the grid's.
__device__ __forceinline__ void bn_affine(const float* s, int C, const float* gamma,
                                          const float* beta, float count, float eps,
                                          float* mul_out, float* add_out) {
  const float inv = __fdiv_rn(1.f, count);
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < C; k += gridDim.x * blockDim.x) {
    const float mean = __fmul_rn(__ldcg(&s[k]), inv);
    const float var =
        fmaxf(__fsub_rn(__fmul_rn(__ldcg(&s[C + k]), inv), __fmul_rn(mean, mean)), 0.f);
    const float m = __fmul_rn(rsqrtf(__fadd_rn(var, eps)), gamma[k]);
    mul_out[k] = m;
    add_out[k] = __fsub_rn(beta[k], __fmul_rn(mean, m));
  }
}

// At most 64 registers a thread, so 4 blocks fit an SM as for the split
// GEMMs (without the bound ptxas takes up to 80, and 3 fit).
template <typename T, typename LoadA>
__global__ void __launch_bounds__(NT, 4) two_pass_block(TwoPass<T, LoadA> a) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  __shared__ float part[32][9];
  run_tiles<T>(a.lda, a.coa, a.pa, As, Bs);
  grid_barrier(a.bar);
  const int ntot = a.pa.n_sets * a.pa.cout;
  reduce_columns(a.coa.stats, a.pa.gx * a.pa.gz, 2LL * ntot,
                 SplitOut{{a.s00, a.s10}, ntot, a.pa.cout}, part);
  grid_barrier(a.bar);
  bn_affine(a.s00, a.pb.cin, a.gamma, a.beta, a.count, a.eps, a.mul_out, a.add_out);
  grid_barrier(a.bar);
  run_tiles<T>(a.ldb, a.cob, a.pb, As, Bs);
  grid_barrier(a.bar);
  reduce_columns(a.cob.stats, a.pb.gx * a.pb.gz, 2LL * a.pb.cout,
                 SplitOut{{a.s01, nullptr}, a.pb.cout, a.pb.cout}, part);
}

// One cooperative launch: as many blocks as fit on the card at once (every
// SM's resident-block limit for this kernel). Returns the CUDA error; a
// grid that cannot be co-resident is refused, never run.
template <typename T, typename LoadA>
cudaError_t launch_two_pass(TwoPass<T, LoadA> a, cudaStream_t stream) {
  auto kernel = two_pass_block<T, LoadA>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(sms * per_sm),
                                    dim3(NT), params, 0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace gn
