// The bf16 tap gradients on the tensor cores, of the up conv (kernel d), of
// the decoder chain's pair conv (kernel n's dtaps) and of the grid convs
// (the phase conv, b, the standard conv, f, and the phase chain's stride-2
// conv, m's dtaps), and the dtaps half of the merged backwards (i, j):
// the operand is built once into device memory by a pass over the input,
// then one GEMM gathers its rows through the conv table.
//
// Replaces, in bf16: geniconet_tpu/ops/pallas/phase_kernel.py:_upd_bwd's
// dtaps call (:2150, _up_dtaps_kernel), _updp_bwd's dtaps call (:2490,
// _up_pair_dtaps_kernel), _phase_conv_dtaps (:1406, _pc_dtaps_kernel) and
// _ds2s_bwd's dtaps call (:1936, _ds2s_dtaps_kernel), the dtaps role of
// _upd_bwd's merged branch (:2068, _up_bwd_kernel; up_conv_bwd.cu runs it
// beside c's dx tiles) and of _phase_conv_bwd (:932, _pc_bwd_kernel;
// phase_conv_bwd.cu runs it beside a's dx tiles), and
// geniconet_tpu/ops/pallas/conv_kernel.py: _pallas_dtaps (:665,
// _dtaps_kernel). The float32 path keeps gn::dtaps_gemm over gn::UpLoad
// or gn::GridLoad (backward.cuh) and i's and j's gn::merged_bwd, the SIMT
// core, bit for bit.
//
// Where the G rows come from is a policy of the one GEMM (mma::DirectRows,
// SplitRows, WrittenRows): each set's output phases as they are (d, n, b,
// f); m's stride-2 output row m read from its parity phase at split_row's
// cell; i's and j's rows of the folded cotangent that cot_operand_pass
// wrote once for a's or c's dx GEMM too, so the GEMM runs without the fold.
//
// The grid convs run the same GEMM on their own operand (grid_operand_pass,
// mma.cuh): per sample the n_src * 5hw act-applied cells (the phase conv's
// 4 phases in source order, or the standard conv's grid), then its two
// pole rows, every value GridLoad's. The rows q walk n_out output phase
// slots from out_phase0 (4 from 0, 1 at phase 2 for the stride-2 phase
// conv, 1 of the standard conv's one table), and the cotangent of slot
// and set is g[set * n_out + slot], make_gload's order. A C_in of at most
// 64 takes the NARROW tile: one block holds several taps (all 7 for
// conv_in's 3 channels, 2 for 64), each load row gathering those taps'
// operand rows, where one tap a block would fill 3 (or 64) of its 128
// channels. f's sums round once to its dtype.
//
// What bounds it on the card. dtaps[t][k][n] = sum_q U[row_t(q)][k] G(q, n)
// over q = (sample, phase slot, cell), B * 4 * 5hw rows: 42-85 GFLOP a site
// at B=36, bound by the tensor cores' bf16 rate (0.04-0.09 ms at 989
// TFLOP/s). The SIMT kernel rebuilt every upsampled cell on every load
// (a conv-table read, two midpoint-table reads, one or two cells, a 5-cell
// mean at a pole; for n each cell also the pair join), once for each of the
// 7 taps and each column tile, and reached 5-6 TFLOP/s. This design's GEMM
// reaches 230-270 TFLOP/s on an H100 without the fold and 140-165 with it
// (PERF.md §6): not the tensor cores' rate but the instructions of each
// 32-row step (copies and their addresses, a barrier, the fold's ALU and
// shared-memory traffic) over 16 warps an SM. wgmma (asynchronous, a
// producer warp for the copies) is the way on; two taps a block, which
// halves what a block reads from L2 for g and y, ran slower at one block
// an SM.
//
// Design.
// 1. up_operand_pass (mma.cuh) writes the upsampled level-(s+1) operand once, in the
//    activation dtype (for n, after pair_join_pass has joined the pair once
//    into a level-s grid): per sample the 4 * 5hw cells of the four phases,
//    then the level-(s+1) north and south pole rows (the phase pad's poles: the
//    5-chart means, or zeros under corner_mode "zeros"), and after the last
//    sample one zero row; channels padded with zeros to a multiple of 8, so
//    every row is 16-byte aligned. Every value is what gn::UpLoad loads (the
//    same ucell / pcell / pole arithmetic and roundings), through GridCells
//    (d) or PairCells (n: the join of b0 and y10 by split_row, each level-s
//    cell joined once). Bound by the bytes it writes (12-94 MB a site at
//    B=36).
// 2. mma_dtaps: a block takes one tap t, 128 channels k and 128 columns n,
//    over a chunk of q in steps of 32 rows. A (the gathered operand rows,
//    [q][k]) and G (the cotangent rows, [q][n]; with the fold also y) come
//    into a 4-stage shared-memory ring by cp.async of 16 bytes, zero-filled
//    past the edges; a conv-table code names an operand row (a cell, the
//    sample's pole row, or the zero row) by selects, the codes fetched one
//    stage ahead. With the fold each thread folds, in place, the g chunks it
//    copied itself: g + gs0 + 2 * gs1 * y with GLoad's roundings (fold_geff),
//    one step ahead of the MMAs and between them, so that its ALU work
//    overlaps the tensor cores' (the fold in the B fragments' registers
//    instead, done by both warps that read a fragment, ran slower). Each
//    thread copies one row's two chunks of A and of G.
//    Both tiles are MN-major for a product that reduces over q, so the
//    fragments come by ldmatrix.trans, and mma.sync.m16n8k16 (bf16 products,
//    float32 sums) multiplies them: 8 warps, 64 x 32 a warp. wgmma would
//    read the same tiles from shared memory with its transpose bits, but
//    needs them in its core-matrix layout (and a descriptor per stage);
//    mma.sync over padded rows (136 elements, conflict-free ldmatrix) is the
//    simpler landing. The grid runs the 7 taps and the k tiles of one
//    chunk together (blockIdx.x fastest), so a chunk's g and y rows come
//    from device memory about once and from L2 the other times.
// 3. Cross-block sums as before: float32 partials per chunk, then a
//    fixed-order sum (sum_chunks: one thread a column, as the chunks are
//    few; the NARROW tile's many chunks take sum_rows' 32 row lanes a
//    column), so results repeat exactly; d and n run the same GEMM on
//    bit-equal operands with the same split, so their dtaps are bit-equal
//    on the joined grid.
#pragma once

#include "backward.cuh"
#include "mma.cuh"

namespace gn {

namespace mma {

// the dtaps GEMM's tile (its 32-row step, BK, is mma.cuh's)
constexpr int BM = 128;          // channels k of one tap a block
constexpr int BN = 128;          // columns n a block
constexpr int STAGES = 4;
constexpr int NT = 256;
constexpr int LDS = 136;         // a tile row in bf16: 128 + 8 keeps ldmatrix conflict-free
constexpr int TILE = BK * LDS;   // bf16 elements of one tile

__host__ __device__ constexpr int smem_bytes(bool fold) {
  return STAGES * (fold ? 3 : 2) * TILE * 2 + (fold ? 2 * BN * 4 : 0);
}

// Where the fold's constant of block column col (0..BN-1) lies in shared
// memory: column col = (lc + 8c) * 8 + 4q + i sits at ((2c + q) * 8 + lc) * 4
// + i, so that the 8 chunks lc of a warp's float4 reads are 8 consecutive
// vectors (conflict-free).
__host__ __device__ constexpr int gsm_at(int col) {
  return ((((col >> 6) * 2 + ((col >> 2) & 1)) * 8 + ((col >> 3) & 7)) << 2) + (col & 3);
}

}  // namespace mma

// Whether a grid conv's C_in takes the NARROW tile (C_in <= 64: an operand
// row fills at most half the tile's BM channels), and the taps a NARROW
// block holds: as many whole rows of ldk / 8 chunks as the tile's 16 fit,
// at most 7 (all of them for a C_in of at most 16). build.mma_narrow and
// build.mma_taps_per_block say the same.
__host__ __device__ __forceinline__ bool mma_narrow(int cin) {
  return operand_width(cin) <= 64;
}
__host__ __device__ __forceinline__ int mma_taps_per_block(int cin) {
  const int cpt = operand_width(cin) / 8;
  return cpt > 8 ? 1 : min(7, 16 / cpt);
}

namespace mma {

// Where mma_dtaps reads the cotangent (its G rows): row (b, slot, m) of
// column n = set * cout + nl is src(gl.g, set, idx)[off + nl] (y likewise,
// under the fold), with (idx, off) = row(...), named once a load row. Each
// row holds one set's cout columns contiguously, so the copies stay 16
// bytes. PhaseTensors: the sets' per_set phase tensors, set-major in gl.g
// (and gl.y), as the passes' loaders hold them.
struct PhaseTensors {
  static constexpr bool kWritten = false;
  int per_set;
  __device__ __forceinline__ const __nv_bfloat16* src(const __nv_bfloat16* const (&t)[8], int,
                                                      int set, int idx) const {
    return t[set * per_set + idx];
  }
  bool aligned(const GLoad<__nv_bfloat16>& gl, int n_sets, bool fold) const {
    bool ok = true;
    for (int i = 0; i < per_set * n_sets; ++i)
      ok = ok && aligned16(gl.g[i]) && (!fold || aligned16(gl.y[i]));
    return ok;
  }
};

// DirectRows: each set's n_out output phases (per_set = n_out), slot's
// tensor at row b * M + m (d, n, b, f).
struct DirectRows : PhaseTensors {
  __device__ __forceinline__ int row(int M, int cout, int b, int slot, int m, size_t& off) const {
    off = ((size_t)b * M + m) * cout;
    return slot;
  }
};

// SplitRows (m): row m of the stride-2 output grid (5, 2^lh, 2^lw), one
// output slot, from its parity phase p (per_set = 4) at the cell split_row
// maps it to (shifts and masks), as GLoad<T, true> reads it.
struct SplitRows : PhaseTensors {
  int lh, lw;
  __device__ __forceinline__ int row(int, int cout, int b, int, int m, size_t& off) const {
    size_t r;
    const int p = split_row(b, m, lh, lw, r);
    off = r * cout;
    return p;
  }
};

// WrittenRows (i, j): the folded cotangent that cot_operand_pass wrote (mma.cuh),
// per sample per_b rows of ldk columns, the sets side by side: row b * per_b
// + slot * M + m, column n itself. The fold is in its values: no FOLD.
struct WrittenRows {
  static constexpr bool kWritten = true;
  const __nv_bfloat16* rows;
  int per_b, ldk;
  __device__ __forceinline__ int row(int M, int, int b, int slot, int m, size_t& off) const {
    off = ((size_t)b * per_b + slot * M + m) * ldk;
    return 0;
  }
  __device__ __forceinline__ const __nv_bfloat16* src(const __nv_bfloat16* const (&)[8], int cout,
                                                      int set, int) const {
    return rows + set * cout;
  }
  bool aligned(const GLoad<__nv_bfloat16>&, int, bool) const {
    return aligned16(rows) && ldk % 8 == 0;
  }
};

}  // namespace mma

// dtaps partials on the tensor cores: ws[chunk][t * cin + k][n] = sum over the
// chunk's rows q of U[row_t(q)][k] * G(q, n), the rows q = (sample, output
// phase slot 0 .. n_out-1, cell) of output phases out_phase0 .. +n_out-1,
// G's rows where GRows names them. Tile (bx = t + 7 * k tile, by = n tile,
// chunk). NARROW (a C_in of at most 64, the grid convs): one block takes
// tpb = mma_taps_per_block taps t0 = tpb * bx .. +tpb-1 (all 7 for a C_in
// of at most 16), its tile row (t - t0) * ldk + k, each load row gathering
// those taps' operand rows (ldk / 8 chunks each); tile (bx, n tile, chunk).
// smem_raw: the ring, mma::smem_bytes(FOLD) bytes. Every thread of the
// block calls it. The standalone GEMM (mma_dtaps) and i's and j's launch of
// both GEMMs (phase_conv_bwd.cu, up_conv_bwd.cu) run this one function.
template <bool FOLD, bool NARROW, typename GRows>
__device__ __forceinline__ void mma_dtaps_tile(const OperandRows& ld,
                                               const GLoad<__nv_bfloat16>& gl, const GRows& gr,
                                               int cin, int n_sets, int out_phase0, int n_out,
                                               int Q, int kc, int g_vec, float* __restrict__ ws,
                                               int bx, int by, int chunk,
                                               unsigned char* smem_raw) {
  static_assert(!(FOLD && GRows::kWritten), "a written cotangent is folded already");
  using bf16 = __nv_bfloat16;
  // the tile's constants (gn:: has the SIMT core's BM, BN, BK)
  constexpr int BM = mma::BM, BN = mma::BN, BK = mma::BK, STAGES = mma::STAGES;
  constexpr int LDS = mma::LDS, TILE = mma::TILE;
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int stage_elems = (FOLD ? 3 : 2) * TILE;
  float* gsm = reinterpret_cast<float*>(smem + STAGES * stage_elems);  // FOLD: [2][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = bx % 7, k0 = NARROW ? 0 : (bx / 7) * BM;
  const int n0 = by * BN;
  const int q_lo = chunk * kc, q_hi = min(q_lo + kc, Q);
  const int steps = (q_hi - q_lo + BK - 1) / BK;
  const int M = gl.M, cout = gl.cout, Ntot = n_sets * cout;

  if constexpr (FOLD) {  // the block's columns' gs0, gs1 (gsm_at: as the fold reads them)
    if (tid < BN) {
      const int n = n0 + tid;
      float s0 = 0.f, s1 = 0.f;
      if (n < Ntot) {
        const int s = n / cout, nl = n - s * cout;
        s0 = gl.gs[s][nl];
        s1 = gl.gs[s][cout + nl];
      }
      const int at = mma::gsm_at(tid);
      gsm[at] = s0;
      gsm[BN + at] = s1;
    }
    __syncthreads();
  }

  // load roles: row lr of each stage, its 8-element chunks lc and lc + 8 of A
  // and of G (and y), so that one row's position, code and addresses serve 4
  // (6) copies. A's chunk j = lc + 8c is channels k0 + 8j .. +7 of tap t;
  // NARROW: channels 8 * (j % cpt) .. +7 of tap t0 + j / cpt (cpt = ldk / 8
  // chunks a tap; none past the block's tpb taps or the 7th), each with its
  // own code
  const int lr = tid >> 3, lc = tid & 7;
  constexpr int NC = NARROW ? 2 : 1;  // codes a row: one per A chunk when NARROW
  const int cpt = ld.ldk / 8, tpb = mma_taps_per_block(cin);
  const int t0 = NARROW ? bx * tpb : t;
  int a_bytes[2], a_tap[2], a_at[2], g_set[2], g_nl[2];
  bool g_ok[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = lc + 8 * c;
    if constexpr (NARROW) {
      const int tl = j / cpt;
      a_tap[c] = t0 + tl;
      a_at[c] = (j - tl * cpt) * 8;
      a_bytes[c] = tl < tpb && a_tap[c] < 7 ? 16 : 0;
    } else {
      a_tap[c] = t;
      a_at[c] = k0 + j * 8;
      a_bytes[c] = a_at[c] < ld.ldk ? 16 : 0;
    }
    const int gn = n0 + j * 8;
    g_ok[c] = gn < Ntot;
    g_set[c] = g_ok[c] ? gn / cout : 0;
    g_nl[c] = gn - g_set[c] * cout;
  }

  mma::RowPos pos;
  pos.start(q_lo + lr, M, n_out);
  int code[NC];
  auto fetch_codes = [&]() {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      code[c] = a_bytes[c] ? ld.code(out_phase0 + pos.slot, a_tap[c], pos.m) : ZERO;
  };
  fetch_codes();

  auto copy_step = [&](int buf) {
    bf16* As = smem + buf * stage_elems;
    bf16* Gs = As + TILE;
    const bool ok = pos.q < q_hi;
    size_t goff;  // this row's G row (gi, goff), as GRows names it
    const int gi = gr.row(M, cout, pos.b, pos.slot, pos.m, goff);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int so = lr * LDS + (lc + 8 * c) * 8;
      const bool va = ok && a_bytes[c];
      const bf16* arow = ld.row(pos.b, code[NARROW ? c : 0]) + a_at[c];
      mma::cp_async16(As + so, va ? arow : ld.rows, va ? 16 : 0);
      if (g_vec) {
        const bool v = ok && g_ok[c];
        const size_t off = goff + g_nl[c];
        mma::cp_async16(Gs + so, v ? gr.src(gl.g, cout, g_set[c], gi) + off : ld.rows,
                        v ? 16 : 0);
        if constexpr (FOLD)
          mma::cp_async16(Gs + TILE + so, v ? gr.src(gl.y, cout, g_set[c], gi) + off : ld.rows,
                          v ? 16 : 0);
      } else {  // a ragged cout (or unaligned g): element by element, into the same slots
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = n0 + (lc + 8 * c) * 8 + e;
          bf16 gv = from_f<bf16>(0.f), yv = gv;
          if (ok && n < Ntot) {
            const int s = n / cout, nl = n - s * cout;
            gv = gr.src(gl.g, cout, s, gi)[goff + nl];
            if constexpr (FOLD) yv = gr.src(gl.y, cout, s, gi)[goff + nl];
          }
          Gs[so + e] = gv;
          if constexpr (FOLD) Gs[TILE + so + e] = yv;
        }
      }
    }
  };
  auto next_row = [&]() {
    pos.advance(M, n_out);
    fetch_codes();  // used by the next copy_step
  };

  // fold the g chunk lc + 8c this thread copied of step j, in place (FOLD)
  auto fold_chunk = [&](int j, int c) {
    bf16* Gs = smem + (j % STAGES) * stage_elems + TILE;
    const int col = (lc + 8 * c) * 8, so = lr * LDS + col;
    alignas(16) bf16 gv[8], yv[8];
    *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(Gs + so);
    *reinterpret_cast<uint4*>(yv) = *reinterpret_cast<const uint4*>(Gs + TILE + so);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 s0 = reinterpret_cast<const float4*>(gsm)[mma::gsm_at(col + 4 * q) / 4];
      const float4 s1 = reinterpret_cast<const float4*>(gsm + BN)[mma::gsm_at(col + 4 * q) / 4];
      const float a0[4] = {s0.x, s0.y, s0.z, s0.w}, a1[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gv[4 * q + e] = from_f<bf16>(fold_geff<bf16>(to_f(gv[4 * q + e]), to_f(yv[4 * q + e]),
                                                     a0[e], a1[e]));
    }
    *reinterpret_cast<uint4*>(Gs + so) = *reinterpret_cast<const uint4*>(gv);
  };

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < steps) {
      copy_step(j);
      next_row();
    }
    mma::cp_async_commit();
  }
  if constexpr (FOLD) {  // step 0; later steps fold one step ahead, between the MMAs
    mma::cp_async_wait<STAGES - 2>();
    fold_chunk(0, 0);
    fold_chunk(0, 1);
  }

  // warp tile: channels wm * 64 .. +63, columns wn * 32 .. +31
  const int wm = warp & 1, wn = warp >> 1;
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  // ldmatrix row addresses (elements) within a tile, before the k16 offset
  const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * LDS + wm * 64 + ((lane >> 3) & 1) * 8;
  const int b_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDS + wn * 32 + (lane >> 4) * 8;

  for (int i = 0; i < steps; ++i) {
    // this thread's copies of step i (FOLD: of step i + 1, which it folds below) have landed
    if constexpr (FOLD) mma::cp_async_wait<STAGES - 3>();
    else mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step i (folded) visible to all; every warp is done with step i - 1
    if (i + STAGES - 1 < steps) {
      copy_step((i + STAGES - 1) % STAGES);
      next_row();
    }
    mma::cp_async_commit();
    const bf16* As = smem + (i % STAGES) * stage_elems;
    const bf16* Gs = As + TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned b[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        unsigned r[4];
        mma::ldsm_x4_trans(r, Gs + b_off + kk * LDS + nj * 16);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        unsigned a[4];
        mma::ldsm_x4_trans(a, As + a_off + kk * LDS + mi * 16);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma::mma_bf16(acc[mi][ni], a, b[ni][0], b[ni][1]);
      }
      // the next step's fold, one chunk a k16 step, while the tensor cores work
      if constexpr (FOLD)
        if (i + 1 < steps) fold_chunk(i + 1, kk / 16);
    }
  }
  mma::cp_async_wait<0>();

  // acc[mi][ni]: channels wm*64 + mi*16 + lane/4 (+8 for e >= 2), columns
  // wn*32 + ni*8 + 2*(lane%4) (+1 for odd e); NARROW: tile row
  // (tap - t0) * ldk + k
  const int Mr = 7 * cin;
  float* part = ws + (size_t)chunk * Mr * Ntot;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int tt = t, k = k0 + wm * 64 + mi * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
      if constexpr (NARROW) {
        const int tl = k / ld.ldk;
        k -= tl * ld.ldk;
        tt = t0 + tl;
        if (tl >= tpb || tt >= 7) continue;
      }
      if (k >= cin) continue;
      float* prow = part + (size_t)(tt * cin + k) * Ntot;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * (lane & 3) + (e & 1);
        if (n < Ntot) prow[n] = acc[mi][ni][e];
      }
    }
}

// The GEMM as one launch: block (t + 7 * k tile, n tile, chunk), or on the
// NARROW tile (taps tile, n tile, chunk). Tag (GridCells, PairCells,
// PhaseGrid, StdGrid or SplitGrid) only names the instantiation, so a
// profile tells d's, n's, b's, f's and m's launches apart; the code is one.
template <typename Tag, bool FOLD, bool NARROW = false, typename GRows = mma::DirectRows>
__global__ void __launch_bounds__(mma::NT, 2)
mma_dtaps(OperandRows ld, GLoad<__nv_bfloat16> gl, GRows gr, int cin, int n_sets, int out_phase0,
          int n_out, int Q, int kc, int g_vec, float* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mma_dtaps_tile<FOLD, NARROW>(ld, gl, gr, cin, n_sets, out_phase0, n_out, Q, kc, g_vec, ws,
                               blockIdx.x, blockIdx.y, blockIdx.z, smem_raw);
}

// The fixed-order sum of mma_dtaps' chunk partials: out(c) = in[0][c] +
// in[1][c] + ... in row order, one thread a column (few chunks: for R <= 32
// the sums gn::sum_rows makes, without its 32 row lanes a column).
template <typename Store>
__global__ void __launch_bounds__(256)
sum_chunks(const float* __restrict__ in, int R, long long C, Store st) {
  const long long c = (long long)blockIdx.x * 256 + threadIdx.x;
  if (c >= C) return;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) acc += in[(size_t)r * C + c];
  st(c, acc);
}

template <typename Tag, bool FOLD, bool NARROW, typename GRows = mma::DirectRows>
cudaError_t mma_dtaps_attr() {
  return cudaFuncSetAttribute(mma_dtaps<Tag, FOLD, NARROW, GRows>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, mma::smem_bytes(FOLD));
}

template <typename Tag, bool FOLD, bool NARROW, typename GRows>
cudaError_t launch_mma_dtaps_gemm(const dim3& grid, const OperandRows& ld,
                                  const GLoad<__nv_bfloat16>& gl, const GRows& gr, int cin,
                                  int n_sets, int out_phase0, int n_out, int Q, int kc, int g_vec,
                                  float* ws, cudaStream_t stream) {
  cudaError_t err = mma_dtaps_attr<Tag, FOLD, NARROW, GRows>();
  if (err != cudaSuccess) return err;
  mma_dtaps<Tag, FOLD, NARROW, GRows><<<grid, mma::NT, mma::smem_bytes(FOLD), stream>>>(
      ld, gl, gr, cin, n_sets, out_phase0, n_out, Q, kc, g_vec, ws);
  return cudaGetLastError();
}

// The blocks of one chunk of the GEMM: the 7 taps' channel tiles (NARROW:
// the taps tiles) and the column tiles.
inline dim3 mma_dtaps_tiles(bool narrow, int cin, int ntot) {
  const int tpb = mma_taps_per_block(cin);
  return dim3(narrow ? (7 + tpb - 1) / tpb : 7 * ((cin + mma::BM - 1) / mma::BM),
              (ntot + mma::BN - 1) / mma::BN);
}

// Whether the GEMM copies G 16 bytes at a time: cout a multiple of 8 and
// every row it reads aligned.
template <typename GRows>
int mma_dtaps_g_vec(const GLoad<__nv_bfloat16>& gl, const GRows& gr, int n_sets) {
  return gl.cout % 8 == 0 && gr.aligned(gl, n_sets, gl.gs[0] != nullptr);
}

// The GEMM over a built operand (`ld`) into ws (n_chunks, 7 * cin,
// n_sets * cout): Q = B * n_out * 5hw rows in chunks of kc (a multiple of
// mma::BK), G's rows where `gr` names them; NARROW: the grid convs' tile at
// mma_narrow(cin).
template <typename Tag, bool NARROW, typename GRows>
cudaError_t launch_mma_dtaps_rows(const OperandRows& ld, const GLoad<__nv_bfloat16>& gl,
                                  const GRows& gr, int B, int cin, int n_sets, int out_phase0,
                                  int n_out, int kc, int n_chunks, float* ws,
                                  cudaStream_t stream) {
  const int Q = B * n_out * gl.M;
  const dim3 tiles = mma_dtaps_tiles(NARROW, cin, n_sets * gl.cout);
  const dim3 grid(tiles.x, tiles.y, n_chunks);
  const int g_vec = mma_dtaps_g_vec(gl, gr, n_sets);
  if (gl.gs[0] != nullptr)
    return launch_mma_dtaps_gemm<Tag, true, NARROW>(grid, ld, gl, gr, cin, n_sets, out_phase0,
                                                    n_out, Q, kc, g_vec, ws, stream);
  return launch_mma_dtaps_gemm<Tag, false, NARROW>(grid, ld, gl, gr, cin, n_sets, out_phase0,
                                                   n_out, Q, kc, g_vec, ws, stream);
}

// bf16 dtaps[set] (7, cin, cout) float32 of the up convs: the operand pass
// into `operand` ((B * (4 * 5hw + 2) + 1, operand_width(cin)) bf16), the
// GEMM into ws (n_chunks, 7 * cin, n_sets * cout) over Q = B * 4 * 5hw rows
// in chunks of kc (a multiple of mma::BK), then the fixed-order sum of the
// partials (sum_chunks).
template <typename Cells>
cudaError_t launch_mma_dtaps(const UpLoad<__nv_bfloat16, Cells>& up,
                             const GLoad<__nv_bfloat16>& gl, const int* conv_table,
                             __nv_bfloat16* operand, __nv_bfloat16* joined, int zero_poles, int B,
                             int cin, int n_sets, int kc, int n_chunks, float* ws, float* dt0,
                             float* dt1, cudaStream_t stream) {
  if (kc % mma::BK != 0 || operand == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = launch_up_operand(up, operand, joined, B, zero_poles, stream);
  if (err != cudaSuccess) return err;
  const OperandRows ld = operand_rows(operand, conv_table, B, gl.M, cin, 4, gl.M);
  err = launch_mma_dtaps_rows<Cells, false>(ld, gl, mma::DirectRows{{4}}, B, cin, n_sets, 0, 4,
                                            kc, n_chunks, ws, stream);
  if (err != cudaSuccess) return err;
  const int Ntot = n_sets * gl.cout;
  const SplitOut st = {{dt0, dt1}, Ntot, gl.cout};
  const long long C = 7LL * cin * Ntot;
  sum_chunks<SplitOut><<<(unsigned)((C + 255) / 256), 256, 0, stream>>>(ws, n_chunks, C, st);
  return cudaGetLastError();
}

// bf16 dtaps of a grid conv (b: the phase conv, n_src = 4 phases in ld.src,
// table halo.phase_conv_table, output phases out_phase0 .. +n_out-1; f: the
// standard conv, n_src = 1, halo.std_conv_table (of stride 1 or 2: gl.M
// output cells, src.hw5 input cells), out_phase0 0, n_out 1; m:
// b's at output phase 2, G's rows by SplitRows): the act-applied operand
// written once into `operand` ((B * (n_src * 5hw + 2) + 1,
// operand_width(cin)) bf16), the GEMM over its gathered rows (NARROW at
// mma_narrow(cin)), then the fixed-order sum of the chunks' partials
// through `st` (SplitOut: float32 per set; f: rounded to bf16): one thread
// a column for few chunks (sum_chunks), else 32 row lanes a column
// (sum_rows; for R <= 32 the two make the same sums).
template <typename Tag, typename Store, typename GRows>
cudaError_t launch_grid_mma_dtaps(const GridLoad<__nv_bfloat16>& src, int n_src,
                                  const GLoad<__nv_bfloat16>& gl, const GRows& gr,
                                  const int* table, int out_phase0, int n_out,
                                  __nv_bfloat16* operand, int zero_poles, int B, int cin,
                                  int n_sets, int kc, int n_chunks, float* ws, const Store& st,
                                  cudaStream_t stream) {
  if (kc % mma::BK != 0 || operand == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = launch_grid_operand<__nv_bfloat16, Tag>(src, operand, B, n_src, zero_poles,
                                                            stream);
  if (err != cudaSuccess) return err;
  const OperandRows ld = operand_rows(operand, table, B, gl.M, cin, n_src, src.hw5);
  err = mma_narrow(cin) ? launch_mma_dtaps_rows<Tag, true>(ld, gl, gr, B, cin, n_sets, out_phase0,
                                                           n_out, kc, n_chunks, ws, stream)
                        : launch_mma_dtaps_rows<Tag, false>(ld, gl, gr, B, cin, n_sets,
                                                            out_phase0, n_out, kc, n_chunks, ws,
                                                            stream);
  if (err != cudaSuccess) return err;
  const long long C = 7LL * cin * n_sets * gl.cout;
  if (n_chunks > 32) return launch_sum_rows(ws, n_chunks, C, st, stream);
  sum_chunks<Store><<<(unsigned)((C + 255) / 256), 256, 0, stream>>>(ws, n_chunks, C, st);
  return cudaGetLastError();
}

// ... b's and f's: each set's n_out output phases as they are.
template <typename Tag, typename Store>
cudaError_t launch_grid_mma_dtaps(const GridLoad<__nv_bfloat16>& src, int n_src,
                                  const GLoad<__nv_bfloat16>& gl, const int* table,
                                  int out_phase0, int n_out, __nv_bfloat16* operand,
                                  int zero_poles, int B, int cin, int n_sets, int kc,
                                  int n_chunks, float* ws, const Store& st, cudaStream_t stream) {
  return launch_grid_mma_dtaps<Tag>(src, n_src, gl, mma::DirectRows{{n_out}}, table, out_phase0,
                                    n_out, operand, zero_poles, B, cin, n_sets, kc, n_chunks, ws,
                                    st, stream);
}

// Registers a thread, blocks an SM, dynamic shared memory and local memory
// (spills) of one instantiation (for the records).
template <typename Tag, bool FOLD, bool NARROW = false, typename GRows = mma::DirectRows>
cudaError_t mma_dtaps_info(int* out) {
  cudaError_t err = mma_dtaps_attr<Tag, FOLD, NARROW, GRows>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, mma_dtaps<Tag, FOLD, NARROW, GRows>)) != cudaSuccess)
    return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, mma_dtaps<Tag, FOLD, NARROW, GRows>, mma::NT, mma::smem_bytes(FOLD));
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = mma::smem_bytes(FOLD);
  out[3] = (int)attr.localSizeBytes;
  return err;
}

}  // namespace gn
