// The bf16 forward of the up conv, of the decoder chain's pair conv (kernel
// n) and of the grid convs (the phase conv and the standard conv) on the
// tensor cores: the operand is built once into device memory (mma.cuh),
// the tap sets are packed once, then one GEMM gathers the operand's rows
// through the conv table, with the BatchNorm [Σy, Σy²] stats in its
// epilogue. The same GEMM, with other epilogues, is the bf16 input gradient
// of the phase conv (a), of the up conv (c) and of the standard conv (f):
// the transposed problem.
//
// Replaces, in bf16: geniconet_tpu/ops/pallas/phase_kernel.py:
// _up_conv_fwd_impl (pallas_call at :1999, _up_fwd_kernel), _updp (:2380,
// _up_pair_fwd_kernel), _phase_conv_fwd (:1272, _pc_fwd_kernel) and _ds2s
// (:1818, _ds2s_fwd_kernel), and conv_kernel.py:_pallas_forward (:253,
// _kernel); with the dx epilogues
// phase_kernel.py:_phase_conv_dx (:1336, _pc_dx_kernel), _upd_bwd's dx
// call (:2123, _up_dx_kernel), _ds2s_bwd's dx call (:1895,
// _ds2s_dx_kernel) and conv_kernel.py:_pallas_dx (:727, _dx_kernel), and
// the dx roles of the merged _phase_conv_bwd (:932) and _upd_bwd (:2068)
// (phase_conv_bwd.cu, up_conv_bwd.cu) and conv_kernel.py:_std_bwd (:601,
// ico_conv_bwd.cu). The float32 path keeps
// gn::conv_gemm over gn::UpLoad / gn::GridLoad (common.cuh) and
// gn::dx_gemm (backward.cuh), the SIMT core, bit for bit.
//
// What bounds it on the card. out[q][n] = sum_t sum_k U[row_t(q)][k] W[t][k][n]
// + bias[n] over q = (sample, output phase slot, cell), B * n_out * 5hw rows,
// and n the columns of the tap sets side by side: 5-85 GFLOP a site at
// B=36, bound by the tensor cores' bf16 rate (0.01-0.09 ms at 989
// TFLOP/s). The SIMT kernels rebuilt every operand cell on every load (a
// conv-table read; the up convs' midpoints, the grid convs' act prologue, a
// 5-cell mean at a pole; for n each cell also the pair join), once for each
// of the 7 taps and each column tile, at 2-12 TFLOP/s.
//
// Design.
// 1. The operand: launch_up_operand (mma.cuh), the pass d's dtaps runs (for
//    n after the pair is joined once into a level-s grid); for the grid
//    convs launch_grid_operand, the pass b's and f's dtaps run (n_src = 4
//    phases or 1 grid, act applied, then each sample's two pole rows).
// 2. pack_taps writes the tap sets side by side into one bf16 buffer,
//    row t * Kp + k, column n (set n / cout, channel n % cout), zero past
//    C_in (Kp = C_in rounded up to the 32-channel step) and past the
//    columns (N rounded up to the 128-column tile), so every copy of a tap
//    tile is a whole 16-byte chunk in bounds.
// 3. mma_conv: a block takes 128 rows q and 128 columns n and walks K =
//    7 taps x Kp in 32-channel steps. Rows run flat over B * n_out * 5hw
//    (mma::RowPos over n_out output phase slots from out_phase0: 4 from 0
//    for the up convs and the stride-1 phase conv, 1 from 2 for the
//    stride-2 phase conv, 1 from 0 for the standard conv's one table), so a
//    small phase (160 cells at up0) does not leave a tile part empty. Each
//    thread copies two 16-byte chunks of one A row ([q][k], k contiguous)
//    and two of the tap tile ([k][n]) into a 4-stage cp.async ring,
//    zero-filled past the operand's width, past Q and for a ZERO code; a
//    row's conv-table code is read once per tap, and names a cell, its
//    sample's pole row or nothing (OperandRows; the pole rows follow the
//    n_src sources' cells). A is K-major, so its fragments come by ldmatrix
//    without .trans; the tap tile is N-major, so .trans, as the dtaps' g
//    tile. mma.sync.m16n8k16 (bf16 products, float32 sums), 8 warps of 64 x
//    32, 2 blocks an SM: on an H100 this ring ran 190-250 TFLOP/s where 4
//    warps of 64 x 64 (1.2-1.4x the time), 64-channel steps (1.2x) or 3 or
//    5 stages ran slower (PERF.md §6). wgmma (both operands could be
//    K-major here) is the way on.
// 4. The epilogue, a template parameter of the one kernel (FwdEpi): the
//    bias in float32, rounded to bf16, row q stored at
//    out[set][slot][(b * 5hw + m) * cout + c], two columns at a time. With
//    stats, [Σy, Σy²] of the rounded values as conv_tile takes them: per
//    block column partials (warp shuffles, then the two row warps in shared
//    memory, in a fixed order), then one fixed-order gn::sum_rows over the
//    row tiles. No atomics: results repeat exactly, and d and n, which run
//    this GEMM on bit-equal operands with the same split, are bit-equal on
//    the joined grid. m's forward (ds2s.cu) is the phase conv's at output
//    phase 2 with the split store (SplitFwdEpi: each row to its parity
//    phase by split_row), so it equals phase_conv_fwd + phase_split bit for
//    bit.
// 5. dx (a, c, f; m's is a's) is the same GEMM transposed: dx[p][m][k] =
//    sum_t sum_n G[row_t(p, m)][n] W[t][k][n] over the rows (sample, input
//    phase, cell) of the n_in input phases (4; f: its one grid, n_in = 1).
//    The A operand
//    is the folded cotangent written once (cot_operand_pass, mma.cuh: g +
//    gs0 + 2 gs1 y with GLoad's roundings, the tap sets side by side, then
//    a sample's combined rows) named by a (n_in, 7, M) code table
//    (halo.phase_dx_codes, halo.std_dx_codes): a cotangent row where the
//    transposed table holds one entry of weight 1, a combined row (its
//    weighted sum rounded to bf16 once: the stride-1 seams and poles) or
//    nothing. pack_taps_t stacks the taps transposed (row t * Kp + n,
//    column k). At stride 2 two thirds of the (tile, tap) pairs read only
//    ZERO codes, so each 128-row tile walks only the taps of its mask byte
//    (DxEpi / DuEpi set kMasked): the GEMM does the forward's FLOPs, not up
//    to 3x as many. Epilogues: a and f round once (DxEpi<false>) or apply
//    the act adjoint of DxOut (backward.cuh) on the float32 sums, with the
//    column sums of dm * x and dm as the stats are taken (DxEpi<true>); c
//    stores float32 dU of the 4 upsampled phases (DuEpi), which
//    up_conv_bwd.cu's upsample adjoint pass then reads.
#pragma once

#include "mma.cuh"

namespace gn {

namespace fwd {

constexpr int BM = 128;                     // rows q a block
constexpr int BN = 128;                     // columns n a block
constexpr int BK = mma::BK;                 // channels k of one tap a step
constexpr int STAGES = 4;
constexpr int NT = 256;                     // 8 warps, 64 x 32 each
constexpr int A_LDS = BK + 8;               // an A row in bf16: 80 bytes, conflict-free
constexpr int B_LDS = BN + 8;               // a tap-tile row: 272 bytes, likewise
constexpr int A_TILE = BM * A_LDS;
constexpr int STAGE = A_TILE + BK * B_LDS;  // bf16 elements of one stage
constexpr int SMEM = STAGES * STAGE * 2;    // bytes

// rows of one tap in the packed taps, and the packed columns
__host__ __device__ __forceinline__ int k_pad(int cin) { return (cin + BK - 1) / BK * BK; }
__host__ __device__ __forceinline__ int n_pad(int ntot) { return (ntot + BN - 1) / BN * BN; }

}  // namespace fwd

// Where the forward writes: n_out output phase slots per tap set, the sets'
// biases, and the stats partials (row tiles, 2 * n_sets * cout), [Σy | Σy²].
struct FwdOut {
  __nv_bfloat16* out[2][4];
  const __nv_bfloat16* bias[2];  // nullable
  float* stats;                  // nullable: no stats
};

// packed[t * Kp + k][n] = taps[n / cout][t][k][n % cout] for k < cin and
// n < n_sets * cout, else 0; (7 * Kp, Np): element i of the 7 Kp Np.
template <typename T>
__device__ __forceinline__ void pack_tap(const T* __restrict__ w0, const T* __restrict__ w1,
                                         T* __restrict__ out, int cin, int cout, int n_sets,
                                         int Kp, int Np, long long i) {
  const long long r = i / Np;
  const int n = (int)(i - r * Np), t = (int)(r / Kp), k = (int)(r - (long long)t * Kp);
  T v = from_f<T>(0.f);
  if (k < cin && n < n_sets * cout) {
    const int s = n / cout;
    v = (s ? w1 : w0)[((size_t)t * cin + k) * cout + (n - s * cout)];
  }
  out[i] = v;
}

// One thread an element of pack_tap. (A template, as every kernel of a
// header that two sources include; Tag, the GEMM's, names the
// instantiation for a profile.)
template <typename T, typename Tag>
__global__ void __launch_bounds__(256)
pack_taps(const T* __restrict__ w0, const T* __restrict__ w1, T* __restrict__ out, int cin,
          int cout, int n_sets, int Kp, int Np, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) pack_tap(w0, w1, out, cin, cout, n_sets, Kp, Np, i);
}

// packed[t * Kp + n][k] = taps[n / cout][t][k][n % cout] for n < n_sets *
// cout and k < cin, else 0; (7 * Kp, Np) with Kp = k_pad(n_sets * cout) and
// Np = n_pad(cin): the tap sets transposed and stacked along K, the B
// operand of the dx GEMMs (a, c). Tag names the instantiation.
template <typename T, typename Tag>
__global__ void __launch_bounds__(256)
pack_taps_t(const T* __restrict__ w0, const T* __restrict__ w1, T* __restrict__ out, int cin,
            int cout, int n_sets, int Kp, int Np, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long r = i / Np;
  const int k = (int)(i - r * Np), t = (int)(r / Kp), n = (int)(r - (long long)t * Kp);
  T v = from_f<T>(0.f);
  if (k < cin && n < n_sets * cout) {
    const int s = n / cout;
    v = (s ? w1 : w0)[((size_t)t * cin + k) * cout + (n - s * cout)];
  }
  out[i] = v;
}

// Where an epilogue thread stands: acc[mi][ni][e] of the GEMM holds row q0 +
// wm * 64 + mi * 16 + lane / 4 (+ 8 for e >= 2) and column n0 + wn * 32 +
// ni * 8 + 2 * (lane % 4) (+ 1 for odd e); a sample has `per` rows, slot
// by slot of M cells. The tile's row of the partials is q0 / BM.
struct EpiPos {
  int q0, n0, wm, wn, lane, tid, Q, M, per;
  __device__ __forceinline__ size_t row_tile() const { return (size_t)(q0 / fwd::BM); }
  __device__ __forceinline__ int col(int ni) const {
    return n0 + wn * 32 + ni * 8 + 2 * (lane & 3);
  }
  __device__ __forceinline__ int row(int mi, int h) const {
    return q0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * h;
  }
};

// The block's column sums of u and v (per thread: its 4 x 2 columns, over
// its rows) into part[c] and part[N + c], c = n0 + tid < N, in a fixed
// order: over the 8 row groups of a warp (lanes with one lane % 4), then
// over its two row warps in shared memory (the ring's, free after the main
// loop). Every thread of the block calls it.
__device__ __forceinline__ void block_column_sums(float (&u)[4][2], float (&v)[4][2],
                                                  unsigned char* smem_raw, const EpiPos& p,
                                                  float* __restrict__ part, int N) {
  constexpr int BN = fwd::BN;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {
        u[ni][e] += __shfl_xor_sync(0xffffffffu, u[ni][e], x);
        v[ni][e] += __shfl_xor_sync(0xffffffffu, v[ni][e], x);
      }
  __syncthreads();  // the ring is free
  float* red = reinterpret_cast<float*>(smem_raw);  // [wm][u | v][BN]
  if (p.lane < 4) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = p.wn * 32 + ni * 8 + 2 * p.lane + e;
        red[(p.wm * 2) * BN + col] = u[ni][e];
        red[(p.wm * 2 + 1) * BN + col] = v[ni][e];
      }
  }
  __syncthreads();
  if (p.tid < BN && p.n0 + p.tid < N) {
    part[p.n0 + p.tid] = red[p.tid] + red[2 * BN + p.tid];
    part[N + p.n0 + p.tid] = red[BN + p.tid] + red[3 * BN + p.tid];
  }
}

// The forward's epilogue: the bias added in float32, rounded to bf16,
// stored at out[set][slot][(b * 5hw + m) * cout + c], two columns at a time;
// with STATS, [Σy, Σy²] of the rounded values into the row tile's partials.
// store() is the body for any placement of a row: place(b, slot, m, at)
// returns the output slot of row q = (b, slot, m) and sets `at` to its row
// in that slot's tensor (m's split store: SplitFwdEpi).
template <bool STATS>
struct FwdEpi {
  static constexpr bool kMasked = false;  // every tap, every row tile
  FwdOut o;
  int cout, n_sets;

  template <typename Place>
  __device__ __forceinline__ void store(const float (&acc)[4][4][4], const EpiPos& p,
                                        unsigned char* smem_raw, const Place& place) const {
    using bf16 = __nv_bfloat16;
    const int Ntot = n_sets * cout, M = p.M;
    // column n is channel n - cout of set 1 from n = cout on (at most two
    // sets). Columns n and n + 1 share a set when cout is even: then one
    // 4-byte store takes both.
    const bool pairs = (cout & 1) == 0;
    float col_bias[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = p.col(ni) + e, s = n >= cout;
        const bf16* bias = s ? o.bias[1] : o.bias[0];
        col_bias[ni][e] = n < Ntot && bias != nullptr ? to_f(bias[n - s * cout]) : 0.f;
      }
    float csum[4][2] = {}, csq[4][2] = {};
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = p.row(mi, h);
        if (q >= p.Q) continue;
        const int b = q / p.per, r = q - b * p.per, slot = r / M, m = r - slot * M;
        size_t at;
        const int out_slot = place(b, slot, m, at);
        const size_t row = at * cout;
        bf16* row0 = pick4(o.out[0], out_slot) + row;
        bf16* row1 = pick4(o.out[1], out_slot) + row;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = p.col(ni);
          bf16 y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            y[e] = from_f<bf16>(acc[mi][ni][2 * h + e] + col_bias[ni][e]);
            if (STATS && n + e < Ntot) {
              const float v = to_f(y[e]);  // the moments are of the downcast output
              csum[ni][e] += v;
              csq[ni][e] += v * v;
            }
          }
          if (n >= Ntot) continue;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(n >= cout ? row1 + (n - cout) : row0 + n) =
                __halves2bfloat162(y[0], y[1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (n + e < Ntot) (n + e >= cout ? row1 + (n + e - cout) : row0 + n + e)[0] = y[e];
          }
        }
      }
    if constexpr (STATS)
      block_column_sums(csum, csq, smem_raw, p, o.stats + p.row_tile() * 2 * Ntot, Ntot);
  }

  __device__ __forceinline__ void operator()(const float (&acc)[4][4][4], const EpiPos& p,
                                             unsigned char* smem_raw) const {
    const int M = p.M;
    store(acc, p, smem_raw, [M](int b, int slot, int m, size_t& at) {
      at = (size_t)b * M + m;
      return slot;
    });
  }
};

// m's forward epilogue: FwdEpi's with the split store (split_row): row m =
// (chart, i, j) of the stride-2 output grid (5, 2^lh, 2^lw), its one output
// slot, goes to o.out[set][2 * (i & 1) + (j & 1)] at (chart, i >> 1, j >> 1)
// of the (5, 2^(lh-1), 2^(lw-1)) phase, row by row (a 128-row tile spans
// chart seams and, at M = 160, samples). A row is still cout contiguous
// values, so the paired 4-byte stores stay; the stats come from the same
// rounded values in the same order, so they are FwdEpi's bit for bit.
template <bool STATS>
struct SplitFwdEpi {
  static constexpr bool kMasked = false;
  FwdEpi<STATS> f;
  int lh, lw;

  __device__ __forceinline__ void operator()(const float (&acc)[4][4][4], const EpiPos& p,
                                             unsigned char* smem_raw) const {
    const int lh_ = lh, lw_ = lw;
    f.store(acc, p, smem_raw, [lh_, lw_](int b, int, int m, size_t& at) {
      return split_row(b, m, lh_, lw_, at);
    });
  }
};

// The split store's output grid (m): h = 2^lh, w = 2^lw.
struct SplitStore {
  int lh, lw;
};

// Where the phase conv's dx GEMM writes (a): the 4 input phases (B, 5, h,
// w, cin), or the standard conv's (f) one grid in out[0]; with the act
// prologue the raw phases it reads, mul and add, and the [d_mul | d_add]
// partials, (row tiles, 2 * cin).
struct DxRows {
  __nv_bfloat16* out[4];
  const __nv_bfloat16* raw[4];
  const float* mul;
  const float* add;
  float* red;
  int cin;
};

// a's and f's epilogue: column n is input channel k, row q = (sample,
// input phase, cell). Without ACT dx rounds once to bf16; with it the act adjoint of
// DxOut (backward.cuh) on the float32 sums: dm = d * 1{x * mul + add > 0}
// against the raw input, dx = bf16(dm * mul), and the column sums of dm * x
// and dm go to the row tile's partials, as the forward's stats do.
template <bool ACT>
struct DxEpi {
  static constexpr bool kMasked = true;  // a row tile skips the taps it does not read
  DxRows o;

  __device__ __forceinline__ void operator()(const float (&acc)[4][4][4], const EpiPos& p,
                                             unsigned char* smem_raw) const {
    using bf16 = __nv_bfloat16;
    const int cin = o.cin, M = p.M;
    const bool pairs = (cin & 1) == 0;
    float cm[4][2], ca[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = p.col(ni) + e;
        cm[ni][e] = ACT && n < cin ? o.mul[n] : 0.f;
        ca[ni][e] = ACT && n < cin ? o.add[n] : 0.f;
      }
    float su[4][2] = {}, sv[4][2] = {};
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = p.row(mi, h);
        if (q >= p.Q) continue;
        const int b = q / p.per, r = q - b * p.per, slot = r / M, m = r - slot * M;
        const size_t row = ((size_t)b * M + m) * cin;
        bf16* orow = pick4(o.out, slot) + row;
        const bf16* xrow = ACT ? pick4(o.raw, slot) + row : nullptr;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = p.col(ni);
          if (n >= cin) continue;
          bf16 y[2];
          if constexpr (ACT) {
            float x[2] = {0.f, 0.f};
            if (pairs) {
              const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(xrow + n);
              x[0] = __low2float(x2);
              x[1] = __high2float(x2);
            } else {
              x[0] = to_f(xrow[n]);
              if (n + 1 < cin) x[1] = to_f(xrow[n + 1]);
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float d = acc[mi][ni][2 * h + e];
              const float dm = __fadd_rn(__fmul_rn(x[e], cm[ni][e]), ca[ni][e]) > 0.f ? d : 0.f;
              y[e] = from_f<bf16>(dm * cm[ni][e]);
              if (n + e < cin) {
                su[ni][e] += dm * x[e];
                sv[ni][e] += dm;
              }
            }
          } else {
            y[0] = from_f<bf16>(acc[mi][ni][2 * h]);
            y[1] = from_f<bf16>(acc[mi][ni][2 * h + 1]);
          }
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(orow + n) = __halves2bfloat162(y[0], y[1]);
          } else {
            orow[n] = y[0];
            if (n + 1 < cin) orow[n + 1] = y[1];
          }
        }
      }
    if constexpr (ACT)
      block_column_sums(su, sv, smem_raw, p, o.red + p.row_tile() * 2 * cin, cin);
  }
};

// c's epilogue: the float32 cotangent of the 4 upsampled phases, dU (B, 4,
// 5hw, cin), row q at du + q * cin, unrounded (the upsample adjoint pass
// reads it and rounds once).
struct DuEpi {
  static constexpr bool kMasked = true;
  float* du;
  int cin;

  __device__ __forceinline__ void operator()(const float (&acc)[4][4][4], const EpiPos& p,
                                             unsigned char*) const {
    const bool pairs = (cin & 1) == 0;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = p.row(mi, h);
        if (q >= p.Q) continue;
        float* row = du + (size_t)q * cin;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = p.col(ni);
          if (n >= cin) continue;
          if (pairs) {
            *reinterpret_cast<float2*>(row + n) =
                make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          } else {
            row[n] = acc[mi][ni][2 * h];
            if (n + 1 < cin) row[n + 1] = acc[mi][ni][2 * h + 1];
          }
        }
      }
  }
};

// The upsample and level-s pad adjoint that follows DuEpi (c, j, n):
// halo.up_adjoint_table and the float32 dU it gathers.
struct UpAdjoint {
  const int* offsets;
  const int* cells;
  const float* weights;
  float* du;
};

// Channels k0 .. k0 + 3 (< cin) of level-s cell m of sample b: the float32
// sum, in the table's order, of each entry's weight times dU at its
// upsampled cell (dU (B, 4, M, cin)); vec: cin a multiple of 4 (16-byte
// loads). c's and j's pass (up_conv_bwd.cu) and n's (up_pair.cu) run this
// one sum, so n's unrounded dx is c's bit for bit.
__device__ __forceinline__ void up_adjoint_sum(const UpAdjoint& adj, int b, int m, int k0, int M,
                                               int cin, int vec, float (&v)[4]) {
  const float* base = adj.du + (size_t)b * 4 * M * cin + k0;
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = 0.f;
  for (int x = __ldg(&adj.offsets[m]); x < __ldg(&adj.offsets[m + 1]); ++x) {
    const float wt = __ldg(&adj.weights[x]);
    const float* src = base + (size_t)__ldg(&adj.cells[x]) * cin;
    if (vec) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src));
      v[0] += wt * t.x;
      v[1] += wt * t.y;
      v[2] += wt * t.z;
      v[3] += wt * t.w;
    } else {
      for (int e = 0; e < 4 && k0 + e < cin; ++e) v[e] += wt * src[e];
    }
  }
}

// One tile of the GEMM over Q = B * n_out * M rows, output phase slot s
// reading the conv table of output phase out_phase0 + s, with the epilogue
// Epi (the forward's FwdEpi; a's DxEpi, c's DuEpi): column tile bx, row tile
// by; 7 * Kp / BK steps, or with Epi::kMasked and a tap_mask only the taps
// of the row tile's mask byte (tap_mask[(q0 % mask_period) / BM]; a tile
// whose codes for a tap are all ZERO reads only zeros there). smem_raw:
// the ring, fwd::SMEM bytes. Every thread of the block calls it; on return
// its copies have landed, and the epilogue may still read the ring (a
// caller that runs another tile passes a __syncthreads first). The
// standalone GEMM (mma_conv), the merged blocks' cooperative launch
// (mma_block_fwd.cuh) and the merged backwards' launch of both GEMMs (i,
// j, k) run this one function.
template <typename Epi>
__device__ __forceinline__ void mma_conv_tile(const OperandRows& ld,
                                              const __nv_bfloat16* __restrict__ wp,
                                              const Epi& epi, int out_phase0, int n_out, int Q,
                                              int Np, int ksteps,
                                              const unsigned char* __restrict__ tap_mask,
                                              int mask_period, int bx, int by,
                                              unsigned char* smem_raw) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = fwd::BM, BN = fwd::BN, BK = fwd::BK, STAGES = fwd::STAGES;
  constexpr int A_LDS = fwd::A_LDS, B_LDS = fwd::B_LDS, A_TILE = fwd::A_TILE;
  constexpr int STAGE = fwd::STAGE;
  constexpr bool MASKED = Epi::kMasked;
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = bx * BN, q0 = by * BM;
  const int M = ld.M;
  unsigned taps = 0x7Fu;
  if (MASKED && tap_mask != nullptr) taps = tap_mask[(q0 % mask_period) / BM];
  const int steps = (MASKED ? __popc(taps) : 7) * ksteps;

  // load roles: A row ar, its chunks ac and ac + 1 of a step; tap-tile row
  // br, its chunks bc and bc + 8
  const int ar = tid >> 1, ac = (tid & 1) * 2, br = tid >> 3, bc = tid & 7;
  mma::RowPos pos;
  pos.start(q0 + ar, M, n_out);
  const bool row_ok = pos.q < Q;
  const int phase = out_phase0 + pos.slot;  // this row's conv table
  // this row's operand row for tap t, or null past Q and for a ZERO code:
  // cp.async then writes zeros and reads nothing (the dx GEMMs' stride-2
  // tables are mostly ZERO, and every block reading the one zero row would
  // queue on one L2 line)
  auto arow_of = [&](int t) -> const bf16* {
    if (!row_ok) return nullptr;
    const int code = ld.code(phase, t, pos.m);
    return code == ZERO ? nullptr : ld.row(pos.b, code);
  };
  // the tap and K step of the next copy
  int t = MASKED ? (taps ? __ffs(taps) - 1 : 7) : 0, ks = 0;
  const bf16* arow = t < 7 ? arow_of(t) : nullptr;
  const bf16* wrow = wp + (size_t)br * Np + n0 + bc * 8;

  auto copy_step = [&](int s) {
    bf16* As = smem + (s % STAGES) * STAGE;
    bf16* Bs = As + A_TILE;
    const bf16* wstep = wrow + (size_t)(MASKED ? t * ksteps + ks : s) * BK * Np;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = ks * BK + (ac + c) * 8;
      const bool ok = arow != nullptr && k < ld.ldk;
      mma::cp_async16(As + ar * A_LDS + (ac + c) * 8, ok ? arow + k : ld.rows, ok ? 16 : 0);
      mma::cp_async16(Bs + br * B_LDS + (bc + 8 * c) * 8, wstep + 64 * c, 16);
    }
    if (++ks == ksteps) {  // the next tap: this row's code for it
      ks = 0;
      if constexpr (MASKED) {
        const unsigned rest = taps >> (t + 1);
        t = rest ? t + __ffs(rest) : 7;
      } else {
        ++t;
      }
      if (t < 7) arow = arow_of(t);
    }
  };

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < steps) copy_step(j);
    mma::cp_async_commit();
  }

  // warp tile: rows wm * 64 .. +63, columns wn * 32 .. +31
  const int wm = warp & 1, wn = warp >> 1;
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  // ldmatrix row addresses (elements) within a stage, before the k16 offset
  const int a_off = (wm * 64 + (lane & 7) + ((lane >> 3) & 1) * 8) * A_LDS + (lane >> 4) * 8;
  const int b_off = A_TILE + ((lane & 7) + (((lane >> 3) & 1) << 3)) * B_LDS + wn * 32 +
                    (lane >> 4) * 8;

  for (int i = 0; i < steps; ++i) {
    mma::cp_async_wait<STAGES - 2>();  // this thread's copies of step i have landed
    __syncthreads();  // step i visible to all; every warp is done with step i - 1
    if (i + STAGES - 1 < steps) copy_step(i + STAGES - 1);
    mma::cp_async_commit();
    const bf16* S = smem + (i % STAGES) * STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned b[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        unsigned r[4];
        mma::ldsm_x4_trans(r, S + b_off + kk * B_LDS + nj * 16);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        unsigned a[4];
        mma::ldsm_x4(a, S + a_off + mi * 16 * A_LDS + kk);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma::mma_bf16(acc[mi][ni], a, b[ni][0], b[ni][1]);
      }
    }
  }
  mma::cp_async_wait<0>();

  const EpiPos p = {q0, n0, wm, wn, lane, tid, Q, M, n_out * M};
  epi(acc, p, smem_raw);
}

// The GEMM as one launch: block (column tile, row tile). Tag (GridCells,
// PairCells, PhaseGrid or StdGrid) names the instantiation, so a profile
// tells the up conv's launches from n's and the grid convs'; the code is
// one.
template <typename Tag, typename Epi>
__global__ void __launch_bounds__(fwd::NT, 2)
mma_conv(OperandRows ld, const __nv_bfloat16* __restrict__ wp, Epi epi, int out_phase0,
         int n_out, int Q, int Np, int ksteps, const unsigned char* __restrict__ tap_mask,
         int mask_period) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mma_conv_tile(ld, wp, epi, out_phase0, n_out, Q, Np, ksteps, tap_mask, mask_period, blockIdx.x,
                blockIdx.y, smem_raw);
}

template <typename Tag, typename Epi>
cudaError_t mma_conv_attr() {
  return cudaFuncSetAttribute(mma_conv<Tag, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              fwd::SMEM);
}

// Row tiles of the GEMM over Q rows (the stats partials' rows).
inline int fwd_row_tiles(long long Q) { return (int)((Q + fwd::BM - 1) / fwd::BM); }

// One launch of the GEMM with its epilogue (its shared memory allowed
// first); the tap masks' period is one sample's n_out * M rows (the dx
// GEMMs' input phases: 4 for a and c, 1 for f).
template <typename Tag, typename Epi>
cudaError_t launch_mma_conv(const dim3& grid, const OperandRows& ld,
                            const __nv_bfloat16* wpack, const Epi& epi, int out_phase0,
                            int n_out, int Q, int Np, int ksteps, const unsigned char* tap_mask,
                            cudaStream_t stream) {
  cudaError_t err = mma_conv_attr<Tag, Epi>();
  if (err != cudaSuccess) return err;
  mma_conv<Tag, Epi><<<grid, fwd::NT, fwd::SMEM, stream>>>(ld, wpack, epi, out_phase0, n_out, Q,
                                                           Np, ksteps, tap_mask, n_out * ld.M);
  return cudaGetLastError();
}

// The GEMM over a built operand's rows `ld` into n_out output phase slots
// from out_phase0: the taps packed into `wpack` ((7 * k_pad(cin),
// n_pad(n_sets * cout))), the GEMM, and with o.stats (row tiles, 2 * n_sets
// * cout) the fixed-order sum into stats[set] (2, cout). SPLIT (m): one
// output slot, stored by the split map of the `split` grid (SplitFwdEpi)
// into o.out[set][0 .. 3], the parity phases.
template <typename Tag, bool SPLIT = false>
cudaError_t launch_mma_fwd_rows(const OperandRows& ld, const FwdOut& o,
                                const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                                __nv_bfloat16* wpack, int B, int cin, int cout, int n_sets,
                                int out_phase0, int n_out, float* const* stats,
                                cudaStream_t stream, SplitStore split = {}) {
  const int Ntot = n_sets * cout, Kp = fwd::k_pad(cin), Np = fwd::n_pad(Ntot);
  const long long packed = 7LL * Kp * Np;
  pack_taps<__nv_bfloat16, Tag><<<(unsigned)((packed + 255) / 256), 256, 0, stream>>>(
      w0, w1, wpack, cin, cout, n_sets, Kp, Np, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int Q = B * n_out * ld.M, row_tiles = fwd_row_tiles(Q);
  const dim3 grid(Np / fwd::BN, row_tiles);
  auto gemm = [&](const auto& epi) {
    return launch_mma_conv<Tag>(grid, ld, wpack, epi, out_phase0, n_out, Q, Np, Kp / fwd::BK,
                                nullptr, stream);
  };
  if constexpr (SPLIT) {
    err = o.stats != nullptr
              ? gemm(SplitFwdEpi<true>{{o, cout, n_sets}, split.lh, split.lw})
              : gemm(SplitFwdEpi<false>{{o, cout, n_sets}, split.lh, split.lw});
  } else {
    err = o.stats != nullptr ? gemm(FwdEpi<true>{o, cout, n_sets})
                             : gemm(FwdEpi<false>{o, cout, n_sets});
  }
  if (err != cudaSuccess || o.stats == nullptr) return err;
  const SplitOut st = {{stats[0], stats[1]}, Ntot, cout};
  return launch_sum_rows(o.stats, row_tiles, 2LL * Ntot, st, stream);
}

// The up conv's (and n's) bf16 forward: the operand pass into `operand`
// ((B * (4 * 5hw + 2) + 1, operand_width(cin)); for a pair, joined first
// into `joined`), then launch_mma_fwd_rows over all 4 output phases.
template <typename Cells>
cudaError_t launch_mma_conv_fwd(const UpLoad<__nv_bfloat16, Cells>& up, const FwdOut& o,
                                const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                                const int* conv_table, __nv_bfloat16* operand,
                                __nv_bfloat16* joined, __nv_bfloat16* wpack, int zero_poles,
                                int B, int cout, int n_sets, float* const* stats,
                                cudaStream_t stream) {
  if (operand == nullptr || wpack == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = launch_up_operand(up, operand, joined, B, zero_poles, stream);
  if (err != cudaSuccess) return err;
  return launch_mma_fwd_rows<Cells>(operand_rows(operand, conv_table, B, up.hw5, up.cin, 4, up.hw5),
                                    o,
                                    w0, w1, wpack, B, up.cin, cout, n_sets, 0, 4, stats, stream);
}

// A grid conv's bf16 forward (the phase conv: n_src = 4 phases in src.src,
// table halo.phase_conv_table, output phases out_phase0 .. +n_out-1; the
// standard conv: n_src = 1, halo.std_conv_table, out_phase0 0, n_out 1; m:
// the phase conv at output phase 2, SPLIT, stored into the parity phases of
// the `split` grid): the act-applied operand written once into `operand`
// ((B * (n_src * 5hw + 2) + 1, operand_width(cin))), then
// launch_mma_fwd_rows over the table's M output cells a phase (5hw, or
// 5hw / 4 for the standard conv at stride 2).
template <typename Tag, bool SPLIT = false>
cudaError_t launch_grid_mma_fwd(const GridLoad<__nv_bfloat16>& src, int n_src, const int* table,
                                int M, const FwdOut& o, const __nv_bfloat16* w0,
                                const __nv_bfloat16* w1, __nv_bfloat16* operand,
                                __nv_bfloat16* wpack, int zero_poles, int B, int cout,
                                int n_sets, int out_phase0, int n_out, float* const* stats,
                                cudaStream_t stream, SplitStore split = {}) {
  if (operand == nullptr || wpack == nullptr || (SPLIT && n_out != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_grid_operand<__nv_bfloat16, Tag>(src, operand, B, n_src, zero_poles,
                                                            stream);
  if (err != cudaSuccess) return err;
  return launch_mma_fwd_rows<Tag, SPLIT>(
      operand_rows(operand, table, B, M, src.cin, n_src, src.hw5), o, w0, w1, wpack, B, src.cin,
      cout, n_sets, out_phase0, n_out, stats, stream, split);
}

// The dx GEMMs' operand rows (a, c, f): the cotangent operand that
// cot_operand_pass wrote (mma.cuh; per sample n_out * M cotangent rows,
// then n_comb combined rows; the zero row after the last sample), named by
// the (n_in, 7, m_in) code table of halo.phase_dx_codes (4 input phases,
// m_in = M) or halo.std_dx_codes (the one grid: m_in = M at stride 1, 4 M
// at stride 2), which holds no pole code.
inline OperandRows cot_rows(const __nv_bfloat16* operand, const int* codes, int B, int M,
                            int ntot, int n_out, int n_comb, int m_in) {
  OperandRows ld;
  ld.rows = operand;
  ld.table = codes;
  ld.M = m_in;
  ld.ldk = operand_width(ntot);
  ld.per_b = n_out * M + n_comb;
  ld.zero_row = B * ld.per_b;
  return ld;
}

// The tap sets packed transposed into `wpack` ((7 * k_pad(n_sets * cout),
// n_pad(cin))), the B operand of the dx GEMMs (a, c, f, i, j, k). Tag
// names the instantiation.
template <typename Tag>
cudaError_t launch_pack_taps_t(const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                               __nv_bfloat16* wpack, int cin, int cout, int n_sets,
                               cudaStream_t stream) {
  const int Kp = fwd::k_pad(n_sets * cout), Np = fwd::n_pad(cin);
  const long long packed = 7LL * Kp * Np;
  pack_taps_t<__nv_bfloat16, Tag><<<(unsigned)((packed + 255) / 256), 256, 0, stream>>>(
      w0, w1, wpack, cin, cout, n_sets, Kp, Np, packed);
  return cudaGetLastError();
}

// The dx GEMM of a, c and f over the B * n_in * ld.M rows of the n_in input
// phases (slots from 0: the phase conv's and the up conv's 4, the standard
// conv's one grid), with the epilogue Epi: the tap sets packed transposed
// into `wpack` ((7 * k_pad(n_sets * cout), n_pad(cin))), then mma_conv
// over K = 7 * k_pad(n_sets * cout) with the row tiles' tap masks (null:
// every tap; else one byte per 128 rows of a sample, n_in * M a multiple
// of 128). A row tile may straddle samples (f at level 2, M = 160, has no
// mask): each row finds its own sample (mma::RowPos, EpiPos).
template <typename Tag, typename Epi>
cudaError_t launch_mma_dx_rows(const OperandRows& ld, const Epi& epi, const __nv_bfloat16* w0,
                               const __nv_bfloat16* w1, __nv_bfloat16* wpack,
                               const unsigned char* tap_mask, int B, int cin, int cout,
                               int n_sets, int n_in, cudaStream_t stream) {
  if (wpack == nullptr || (n_in != 1 && n_in != 4) ||
      (tap_mask != nullptr && (n_in * ld.M) % fwd::BM != 0))
    return cudaErrorInvalidValue;
  const int Kp = fwd::k_pad(n_sets * cout), Np = fwd::n_pad(cin);
  cudaError_t err = launch_pack_taps_t<Tag>(w0, w1, wpack, cin, cout, n_sets, stream);
  if (err != cudaSuccess) return err;
  const int Q = B * n_in * ld.M;
  return launch_mma_conv<Tag>(dim3(Np / fwd::BN, fwd_row_tiles(Q)), ld, wpack, epi, 0, n_in, Q,
                              Np, Kp / fwd::BK, tap_mask, stream);
}

// The bf16 dx tables and scratch of a and c (halo.phase_dx_codes, n_in =
// 4 input phases) and of f (halo.std_dx_codes, n_in = 1): the code table,
// the combined rows, the row tiles' tap masks (null: every tap), the
// cotangent operand and the transposed taps. m_in: the cells of one input
// phase, the dx GEMM's rows a slot; 0 where they are the cotangent's M
// (every conv but the standard conv at stride 2, whose input grid has 4 M).
struct DxTables {
  const int* codes;
  CombRows comb;
  const unsigned char* mask;
  __nv_bfloat16* operand;
  __nv_bfloat16* wpack;
  int n_in;
  int m_in;
  int rows(int M) const { return m_in ? m_in : M; }
};

// The bf16 dx of a, c, f and m: the cotangent operand of gl written once
// (launch_cot_operand; m's through the split loader), the dx GEMM with the
// epilogue Epi over the rows tb.codes names (launch_mma_dx_rows), then,
// where gsum_ws is given, Σg_eff over the written cotangent rows in
// launch_gsum's order.
template <typename Tag, typename Epi, bool SPLIT>
cudaError_t launch_cot_dx(const GLoad<__nv_bfloat16, SPLIT>& gl, const DxTables& tb,
                          const Epi& epi, const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                          float* gsum_ws, float* gsum0, float* gsum1, int B, int cin,
                          int n_sets, int gsum_rows, cudaStream_t stream) {
  if (tb.codes == nullptr || tb.operand == nullptr || tb.wpack == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_cot_operand<Tag>(gl, tb.comb, tb.operand, B, n_sets, stream);
  if (err != cudaSuccess) return err;
  const OperandRows ld = cot_rows(tb.operand, tb.codes, B, gl.M, n_sets * gl.cout, gl.n_out,
                                  tb.comb.n, tb.rows(gl.M));
  err = launch_mma_dx_rows<Tag>(ld, epi, w0, w1, tb.wpack, tb.mask, B, cin, gl.cout, n_sets,
                                tb.n_in, stream);
  if (err != cudaSuccess || gsum_ws == nullptr) return err;
  const CotRowsG cg = {tb.operand, gl.M, gl.n_out, gl.cout, ld.per_b, ld.ldk};
  return launch_gsum<__nv_bfloat16>(cg, B, n_sets, gsum_rows, gsum_ws, gsum0, gsum1, stream);
}

// The bf16 dx of a grid conv (a, f, m) into `rows`: launch_cot_dx with a's
// epilogue (DxEpi<true>, the act adjoint, where rows.mul is set; else
// DxEpi<false>), then with the act the fixed-order sum of the d_mul/d_add
// partials (rows.red, a row per row tile of the B * n_in * M rows) into
// dmul, dadd.
template <typename Tag, bool SPLIT>
cudaError_t launch_grid_cot_dx(const GLoad<__nv_bfloat16, SPLIT>& gl, const DxTables& tb,
                               const DxRows& rows, const __nv_bfloat16* w0,
                               const __nv_bfloat16* w1, float* gsum_ws, float* gsum0,
                               float* gsum1, float* dmul, float* dadd, int B, int n_sets,
                               int gsum_rows, cudaStream_t stream) {
  const int cin = rows.cin;
  cudaError_t err =
      rows.mul ? launch_cot_dx<Tag>(gl, tb, DxEpi<true>{rows}, w0, w1, gsum_ws, gsum0, gsum1, B,
                                    cin, n_sets, gsum_rows, stream)
               : launch_cot_dx<Tag>(gl, tb, DxEpi<false>{rows}, w0, w1, gsum_ws, gsum0, gsum1,
                                    B, cin, n_sets, gsum_rows, stream);
  if (err != cudaSuccess || rows.mul == nullptr) return err;
  const SplitOut st = {{dmul, dadd}, 2 * cin, cin};
  return launch_sum_rows(rows.red, fwd_row_tiles((long long)B * tb.n_in * tb.rows(gl.M)),
                         2LL * cin, st, stream);
}

// Registers a thread, blocks an SM, dynamic shared memory and local memory
// (spills) of one instantiation (for the records).
template <typename Tag, typename Epi>
cudaError_t mma_conv_info(int* out) {
  cudaError_t err = mma_conv_attr<Tag, Epi>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, mma_conv<Tag, Epi>)) != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mma_conv<Tag, Epi>, fwd::NT,
                                                      fwd::SMEM);
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = fwd::SMEM;
  out[3] = (int)attr.localSizeBytes;
  return err;
}

template <typename Tag, bool STATS, bool SPLIT = false>
cudaError_t mma_conv_fwd_info(int* out) {
  if constexpr (SPLIT) return mma_conv_info<Tag, SplitFwdEpi<STATS>>(out);
  else return mma_conv_info<Tag, FwdEpi<STATS>>(out);
}

}  // namespace gn
