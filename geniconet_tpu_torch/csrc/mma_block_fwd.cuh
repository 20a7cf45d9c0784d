// The merged blocks' bf16 forward (kernels o and p) on the tensor cores: the
// split route's own device code, phase by phase, in one cooperative launch
// whose grid barriers (block_fwd.cuh) stand between the phases:
//
//   0. pass A's operand (o: the upsampled operand, up_operand_chunk; p: the
//      act-applied operand of the 4 input phases with the pending act,
//      grid_operand_chunk), and the three tap sets packed (pack_tap: pass
//      A's two sets side by side, conv01's), grid-stride loops over the
//      elements the split launches cover;
//   1. pass A's GEMM with the stats epilogue (mma_conv_tile, FwdEpi<true>):
//      o into its 4 output phases from 0, p into phase 2; each block walks
//      the tile list (column tile, row tile) in a persistent loop, in an
//      order that spreads a round's tiles over the SMs (sm_order), the
//      partials a row tile's;
//   2. the partials' fixed-order column sums into s00, s10 (reduce_columns,
//      sum_rows' order);
//   3. bn00's affine (bn_affine);
//   4. pass B's operand: grid_operand_chunk over y00 with the act (mul00,
//      add00, a copy in shared memory), every read of data this launch
//      wrote through L2 (o: y00's 4 phases and the phase-conv table; p: its
//      one grid, the standard table);
//   5. pass B's GEMM with stats, then its column sums into s01.
//
// Each phase runs the same function on the same elements, tiles and
// partials as the split launches (up_dual_conv_fwd / phase_conv_fwd with
// stats, the affine, then phase_conv_fwd / ico_conv_s2s_fwd with stats), in
// the same reduction order, so all eight outputs equal the split route's
// bit for bit. The float32 path keeps block_fwd.cuh's SIMT two_pass_block.
//
// What bounds it on the card: the tensor cores' bf16 rate in the two GEMMs
// (0.005-0.086 ms a pass at B=36, 989 TFLOP/s), as for the split pair,
// plus the operand passes' bytes; the merge saves the split route's eight
// launches and the affine's small PyTorch kernels between them. Blocks:
// every SM's resident limit at the GEMM's ring (fwd::SMEM dynamic shared
// memory, __launch_bounds__(256, 2): 2 an SM on an H100, 264 in all); a
// grid that cannot be co-resident is refused, never run and never routed to
// the split kernels.
#pragma once

#include "block_fwd.cuh"
#include "mma_conv_fwd.cuh"

namespace gn {

// One tensor-core conv pass of a merged block: the GEMM over Q = B * n_out
// * M rows of its operand (named through the conv table of output phases
// out_phase0 ..), its n_sets tap sets packed into wpack ((7 Kp, Np)), its
// epilogue (outputs, biases, the row tiles' partials). It lives in the
// kernel's parameters, where the tile reads the epilogue's pointers when it
// stores (with a copy of it built in the kernel, the GEMM phases took 2-10%
// longer).
struct MmaPass {
  OperandRows rows;
  FwdEpi<true> epi;
  const __nv_bfloat16* w0;
  const __nv_bfloat16* w1;  // null for one set
  __nv_bfloat16* wpack;
  int cin, cout, n_sets, out_phase0, n_out, Q, Kp, Np, row_tiles, col_tiles;
};

inline MmaPass mma_pass(const __nv_bfloat16* operand, const int* table, int B, int M, int n_src,
                        int cin, int cout, int n_sets, int out_phase0, int n_out,
                        const FwdOut& o, const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                        __nv_bfloat16* wpack) {
  MmaPass p;
  p.rows = operand_rows(operand, table, B, M, cin, n_src, M);
  p.epi = {o, cout, n_sets};
  p.w0 = w0;
  p.w1 = w1;
  p.wpack = wpack;
  p.cin = cin;
  p.cout = cout;
  p.n_sets = n_sets;
  p.out_phase0 = out_phase0;
  p.n_out = n_out;
  p.Q = B * n_out * M;
  p.Kp = fwd::k_pad(cin);
  p.Np = fwd::n_pad(n_sets * cout);
  p.row_tiles = fwd_row_tiles(p.Q);
  p.col_tiles = p.Np / fwd::BN;
  return p;
}

// The two operand passes' elements: o's pass A upsamples, every other pass
// is a grid conv's.
template <bool ACT_SHARED, typename T>
__device__ __forceinline__ Chunk8<T> operand_chunk(const UpLoad<T>& ld, int B, int,
                                                   int zero_poles, int vec, long long i) {
  return up_operand_chunk(ld, B, zero_poles, vec, i);
}

template <bool ACT_SHARED, typename T, bool COHERENT>
__device__ __forceinline__ Chunk8<T> operand_chunk(const GridLoad<T, COHERENT>& ld, int B,
                                                   int n_src, int zero_poles, int vec,
                                                   long long i) {
  return grid_operand_chunk<ACT_SHARED>(ld, B, n_src, zero_poles, vec, i);
}

// An operand pass over its total elements, a grid-stride loop. (Computing
// 2 or 4 elements a thread before storing them ran 3-12% slower.)
template <bool ACT_SHARED = false, typename Load>
__device__ __forceinline__ void operand_pass(const Load& ld, __nv_bfloat16* out, int B,
                                             int n_src, int zero_poles, int vec,
                                             long long total) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x)
    store_chunk(out, i, operand_chunk<ACT_SHARED>(ld, B, n_src, zero_poles, vec, i));
}

// Both passes of a merged block. The operands may share memory: pass B's
// is written after pass A's GEMM has read pass A's.
template <typename LoadA>
struct MmaTwoPass {
  LoadA lda;                          // pass A's operand source
  GridLoad<__nv_bfloat16, true> ldb;  // pass B's: y00, act (mul_out, add_out)
  __nv_bfloat16* opa;
  __nv_bfloat16* opb;
  long long total_a, total_b;  // the operands' 8-channel elements
  int n_src_a, n_src_b, vec_a, vec_b, zero_poles, B;
  MmaPass pa, pb;
  const float* gamma;  // bn00's scale and bias (C0,)
  const float* beta;
  float* s00;  // (2, C0), (2, C0), (2, C2) [sum, sumsq]
  float* s10;
  float* s01;
  float* mul_out;  // (C0,) the affine, pass B's act, kept for the backward
  float* add_out;
  float count, eps;
  unsigned* bar;    // 2 zeroed: the grid barrier's
  unsigned* order;  // MAX_SLOTS + MAX_SM_IDS zeroed: sm_order's counters
  int per_sm;       // blocks an SM (the launch sets it)
};

// A pass's packed taps, a grid-stride loop.
__device__ __forceinline__ void pack_pass(const MmaPass& p) {
  const long long total = 7LL * p.Kp * p.Np;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x)
    pack_tap(p.w0, p.w1, p.wpack, p.cin, p.cout, p.n_sets, p.Kp, p.Np, i);
}

// This block's place in an order of the grid that puts each SM's first
// block first: v = slot * SMs + rank, where slot is the block's arrival
// order on its SM (%smid) and rank its arrival order among the blocks of
// that slot. A full cooperative grid holds per_sm blocks on every SM, so v
// runs over 0 .. gridDim.x - 1 once; a block that finds otherwise traps
// (the launch fails) rather than leave a tile to no block. ctr: the
// wrapper's zeroed counters, MAX_SLOTS a slot, then one an SM id.
constexpr int MAX_SLOTS = 8;
constexpr int MAX_SM_IDS = 1024;

__device__ __forceinline__ int sm_order(unsigned* ctr, int per_sm) {
  __shared__ int v;
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    const unsigned sms = gridDim.x / per_sm;
    const unsigned slot = atomicAdd(&ctr[MAX_SLOTS + sm % MAX_SM_IDS], 1u);
    const unsigned rank = slot < (unsigned)per_sm ? atomicAdd(&ctr[slot], 1u) : sms;
    if (rank >= sms) __trap();
    v = (int)(slot * sms + rank);
  }
  __syncthreads();
  return v;
}

// A pass's GEMM over its tiles (the column tile fastest, so the blocks at
// work share row tiles' operand rows in L2): the block of order v (sm_order)
// takes tiles v, v + gridDim.x, ..., so a round with fewer tiles than
// blocks puts one on each of as many SMs as it can, as a launch's blocks
// spread over the card. (Tiles x, x + gridDim.x, ... by blockIdx.x, whose
// blocks share SMs in no such order, ran the part-full rounds' tiles two
// an SM on fewer SMs: up to 1.6x the split launch's GEMM time.) Which
// block takes a tile changes no bit: a tile's outputs and partial row are
// its own.
__device__ __forceinline__ void gemm_pass(const MmaPass& p, int v, unsigned char* smem_raw) {
  const int tiles = p.row_tiles * p.col_tiles;
  for (int t = v; t < tiles; t += gridDim.x) {
    mma_conv_tile(p.rows, p.wpack, p.epi, p.out_phase0, p.n_out, p.Q, p.Np, p.Kp / fwd::BK,
                  nullptr, p.n_out * p.rows.M, t % p.col_tiles, t / p.col_tiles, smem_raw);
    __syncthreads();  // the epilogue read the ring; the next tile's copies refill it
  }
}

template <typename LoadA>
__global__ void __launch_bounds__(fwd::NT, 2) mma_two_pass_block(MmaTwoPass<LoadA> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float(&part)[32][9] = *reinterpret_cast<float(*)[32][9]>(smem_raw);
  const int v = sm_order(a.order, a.per_sm);
  operand_pass(a.lda, a.opa, a.B, a.n_src_a, a.zero_poles, a.vec_a, a.total_a);
  pack_pass(a.pa);
  pack_pass(a.pb);
  grid_barrier(a.bar);
  gemm_pass(a.pa, v, smem_raw);
  grid_barrier(a.bar);
  const int ntot = a.pa.n_sets * a.pa.cout;
  reduce_columns(a.pa.epi.o.stats, a.pa.row_tiles, 2LL * ntot,
                 SplitOut{{a.s00, a.s10}, ntot, a.pa.cout}, part);
  grid_barrier(a.bar);
  bn_affine(a.s00, a.pa.cout, a.gamma, a.beta, a.count, a.eps, a.mul_out, a.add_out);
  grid_barrier(a.bar);
  if (a.vec_b) {  // the act's mul and add staged in shared memory (the ring is free)
    const int c0 = a.ldb.cin;
    float* act = reinterpret_cast<float*>(smem_raw);
    for (int k = threadIdx.x; k < c0; k += blockDim.x) {
      act[k] = __ldcg(a.mul_out + k);
      act[c0 + k] = __ldcg(a.add_out + k);
    }
    __syncthreads();
    GridLoad<__nv_bfloat16, true> ld = a.ldb;
    ld.mul = act;
    ld.add = act + c0;
    operand_pass<true>(ld, a.opb, a.B, a.n_src_b, a.zero_poles, 1, a.total_b);
  } else {
    operand_pass(a.ldb, a.opb, a.B, a.n_src_b, a.zero_poles, 0, a.total_b);
  }
  grid_barrier(a.bar);
  gemm_pass(a.pb, v, smem_raw);
  grid_barrier(a.bar);
  reduce_columns(a.pb.epi.o.stats, a.pb.row_tiles, 2LL * a.pb.cout,
                 SplitOut{{a.s01, nullptr}, a.pb.cout, a.pb.cout}, part);
}

// The kernel's shared memory allowed (the GEMM's ring), then its blocks an
// SM at that size.
template <typename LoadA>
cudaError_t mma_two_pass_occupancy(int* per_sm) {
  auto kernel = mma_two_pass_block<LoadA>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd::SMEM);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, fwd::NT, fwd::SMEM);
}

// One cooperative launch of as many blocks as fit on the card at once.
// Returns the CUDA error; a grid that cannot be co-resident is refused.
template <typename LoadA>
cudaError_t launch_mma_two_pass(MmaTwoPass<LoadA> a, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = mma_two_pass_occupancy<LoadA>(&per_sm);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > MAX_SLOTS) per_sm = MAX_SLOTS;
  a.per_sm = per_sm;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(mma_two_pass_block<LoadA>),
                                    dim3(sms * per_sm), dim3(fwd::NT), params, fwd::SMEM, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Registers a thread, blocks an SM, dynamic shared memory and local memory
// (spills) of the kernel (for the records).
template <typename LoadA>
cudaError_t mma_two_pass_info(int* out) {
  int per_sm = 0;
  cudaError_t err = mma_two_pass_occupancy<LoadA>(&per_sm);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, mma_two_pass_block<LoadA>);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = per_sm;
  out[2] = fwd::SMEM;
  out[3] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace gn
