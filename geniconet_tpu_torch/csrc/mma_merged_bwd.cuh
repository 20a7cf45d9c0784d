// The bf16 merged backwards' one launch of both tensor-core GEMMs: i's
// (phase_conv_bwd.cu: b's dtaps tiles and a's dx tiles), j's
// (up_conv_bwd.cu: d's dtaps tiles and c's dx tiles) and k's
// (ico_conv_bwd.cu: f's dtaps tiles and f's dx tiles), after their passes
// have written the folded cotangent and the dtaps operand once.
//
// The roles by block index: blocks [0, dt_blocks) are the dtaps tiles
// (gn::mma_dtaps_tile; taps, or a NARROW block's taps, x channel tiles,
// then column tiles, then chunks; x fastest) over the written cotangent
// (mma::WrittenRows: no fold in the GEMM), the rest the dx tiles
// (gn::mma_conv_tile; column tiles, row tiles; x fastest) over the n_in
// input phases (i's and j's 4, k's one grid) with the epilogue Epi (i's and
// k's DxEpi, whose d_mul/d_add partials take the dx tile's own row; j's
// DuEpi). A dtaps tile walks a chunk of thousands of rows, a dx tile 7 taps
// of one 128-row tile, so the long tiles go first and the short ones fill
// the SMs around them and the tail (k at (4,8), C_in 256, B=36: 90 dx tiles,
// under one wave of 132 SMs, beside its dtaps tiles). Both bodies take
// mma::NT threads and 2 blocks an SM, and each ring fits the one dynamic
// allocation, the larger of the two.
#pragma once

#include "mma_conv_fwd.cuh"
#include "mma_dtaps.cuh"

namespace gn {

// One launch's operands and shapes: the dtaps over Qt rows of n_out output
// phase slots from out_phase0 (the operand rows x, the written cotangent
// gr, chunks of kc rows into ws), the dx over Qx = B * n_in * m_in rows of the
// n_in input phases (the written cotangent's rows cot named by the code
// table, the taps packed transposed in wpack, the row tiles' tap masks, a
// byte per 128 rows of a sample's n_in * m_in), and the tile counts.
struct MmaBwd {
  OperandRows x, cot;
  GLoad<__nv_bfloat16> gl;
  mma::WrittenRows gr;
  int cin, n_sets, out_phase0, n_out, Qt, kc, g_vec;
  float* ws;
  const __nv_bfloat16* wpack;
  const unsigned char* mask;
  int Qx, Np, ksteps;
  int dt_x, dt_y, dt_blocks, dx_x;  // dtaps tiles: x, y, and x * y * chunks; dx column tiles
  int n_in;                         // DxTables::n_in: 4 (i, j) or 1 (k)
};

constexpr int MMA_BWD_SMEM =
    fwd::SMEM > mma::smem_bytes(false) ? fwd::SMEM : mma::smem_bytes(false);
static_assert(fwd::NT == mma::NT, "one block size for both roles");

// Tag (MergedPhase, MergedUp, MergedStd) names the instantiation for a
// profile.
template <typename Tag, bool NARROW, typename Epi>
__global__ void __launch_bounds__(mma::NT, 2) mma_bwd(MmaBwd a, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int i = blockIdx.x;
  if (i < a.dt_blocks) {
    const int bx = i % a.dt_x;
    i /= a.dt_x;
    mma_dtaps_tile<false, NARROW>(a.x, a.gl, a.gr, a.cin, a.n_sets, a.out_phase0, a.n_out, a.Qt,
                                  a.kc, a.g_vec, a.ws, bx, i % a.dt_y, i / a.dt_y, smem_raw);
    return;
  }
  i -= a.dt_blocks;
  mma_conv_tile(a.cot, a.wpack, epi, 0, a.n_in, a.Qx, a.Np, a.ksteps, a.mask, a.n_in * a.cot.M,
                i % a.dx_x, i / a.dx_x, smem_raw);
}

template <typename Tag, bool NARROW, typename Epi>
cudaError_t mma_bwd_attr() {
  return cudaFuncSetAttribute(mma_bwd<Tag, NARROW, Epi>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_BWD_SMEM);
}

// The operands of one launch over the written cotangent (tb: its rows,
// code table, tap masks, packed taps and input phases) and the dtaps
// operand `x`, the dtaps rows of n_out output phase slots from out_phase0
// in n_chunks chunks of kc, and the tile counts (the dtaps' NARROW tile or
// the wide one, as the split route's dtaps takes it).
inline MmaBwd mma_bwd_args(const OperandRows& x, const GLoad<__nv_bfloat16>& gl,
                           const DxTables& tb, int B, int cin, int n_sets, int out_phase0,
                           int n_out, bool narrow, int kc, int n_chunks, float* ws) {
  const int M = gl.M, Ntot = n_sets * gl.cout;
  MmaBwd a;
  a.x = x;
  a.cot = cot_rows(tb.operand, tb.codes, B, M, Ntot, n_out, tb.comb.n, tb.rows(M));
  a.gl = gl;
  a.gr = {tb.operand, a.cot.per_b, a.cot.ldk};
  a.cin = cin;
  a.n_sets = n_sets;
  a.out_phase0 = out_phase0;
  a.n_out = n_out;
  a.Qt = B * n_out * M;
  a.kc = kc;
  a.g_vec = mma_dtaps_g_vec(gl, a.gr, n_sets);
  a.ws = ws;
  a.wpack = tb.wpack;
  a.mask = tb.mask;
  a.n_in = tb.n_in;
  a.Qx = B * tb.n_in * a.cot.M;
  a.Np = fwd::n_pad(cin);
  a.ksteps = fwd::k_pad(Ntot) / fwd::BK;
  const dim3 tiles = mma_dtaps_tiles(narrow, cin, Ntot);
  a.dt_x = (int)tiles.x;
  a.dt_y = (int)tiles.y;
  a.dt_blocks = (int)(tiles.x * tiles.y) * n_chunks;
  a.dx_x = a.Np / fwd::BN;
  return a;
}

// The one launch of both GEMMs (its shared memory allowed first).
template <typename Tag, bool NARROW, typename Epi>
cudaError_t launch_mma_bwd(const MmaBwd& a, const Epi& epi, cudaStream_t stream) {
  cudaError_t err = mma_bwd_attr<Tag, NARROW, Epi>();
  if (err != cudaSuccess) return err;
  const long long blocks = a.dt_blocks + (long long)a.dx_x * fwd_row_tiles(a.Qx);
  mma_bwd<Tag, NARROW, Epi><<<(unsigned)blocks, mma::NT, MMA_BWD_SMEM, stream>>>(a, epi);
  return cudaGetLastError();
}

// Registers a thread, blocks an SM, dynamic shared memory and local memory
// (spills) of one instantiation (for the records).
template <typename Tag, bool NARROW, typename Epi>
cudaError_t mma_bwd_info(int* out) {
  cudaError_t err = mma_bwd_attr<Tag, NARROW, Epi>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, mma_bwd<Tag, NARROW, Epi>)) != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mma_bwd<Tag, NARROW, Epi>, mma::NT,
                                                      MMA_BWD_SMEM);
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = MMA_BWD_SMEM;
  out[3] = (int)attr.localSizeBytes;
  return err;
}

}  // namespace gn
