// Shared pieces of the backward kernels of the phase conv, the up conv and
// the standard conv: the cotangent loader (with the BatchNorm stats fold),
// the dx gather-GEMM over a transposed halo table, the dtaps GEMM with
// per-chunk partials, the bias-gradient column sum, and the merged one-pass
// backward that runs the dx and dtaps tiles in one launch. Every sum across
// blocks goes through block partials and gn::sum_rows, so results do not
// change from run to run.
#pragma once

#include "common.cuh"

namespace gn {

// The stats fold of one cotangent element: g + gs0 + 2 * gs1 * y in float32
// with the Pallas kernels' roundings (_geff_one), rounded to T.
template <typename T>
__device__ __forceinline__ float fold_geff(float g, float y, float gs0, float gs1) {
  return round_to<T>(__fadd_rn(__fadd_rn(g, gs0), __fmul_rn(__fmul_rn(2.f, y), gs1)));
}

// The upstream cotangents of n_sets tap sets, each n_out output phases of
// shape (B, 5, h, w, cout), held set-major in g[set * n_out + slot]. A row
// q = slot * M + m (M = 5hw) of one sample and a column n < n_sets * cout
// name one element. With gs[set] != null the stats cotangent is folded in:
// g_eff = g + gs0 + 2 * gs1 * y in float32, rounded to T (the Pallas
// kernels' _geff_one, with the same two roundings per product and sum).
// SPLIT (the phase chain's stride-2 conv, n_out = 1): row m of the (5, h, w)
// output grid is read from parity phase g[set * 4 + p] by the forward's split
// store map (gn::split_row), so the kernels see the phase_merge'd cotangent.
template <typename T, bool SPLIT = false>
struct GLoad {
  const T* g[8];
  const T* y[8];       // forward outputs, read only with the fold
  const float* gs[2];  // per set (2, cout) cotangents of [sum, sumsq], or null
  int M, cout, n_out;
  int lh, lw;          // SPLIT only: log2 of the (5, h, w) output grid's h and w

  __device__ __forceinline__ float operator()(int b, int q, int n) const {
    const int s = n / cout, nl = n - s * cout;
    int i;
    size_t off;
    if constexpr (SPLIT) {  // n_out = 1: row q is cell q of the grid
      size_t row;
      i = s * 4 + split_row(b, q, lh, lw, row);
      off = row * cout + nl;
    } else {
      const int slot = q / M, m = q - slot * M;
      i = s * n_out + slot;
      off = ((size_t)b * M + m) * cout + nl;
    }
    const float v = to_f(g[i][off]);
    if (gs[s] == nullptr) return v;
    return fold_geff<T>(v, to_f(y[i][off]), gs[s][nl], gs[s][cout + nl]);
  }
};

template <typename T>
GLoad<T> make_gload(const void* const* g, const void* const* y, const float* gs0,
                    const float* gs1, int M, int cout, int n_sets, int n_out) {
  GLoad<T> gl = {};
  for (int i = 0; i < n_sets * n_out; ++i) {
    gl.g[i] = static_cast<const T*>(g[i]);
    gl.y[i] = y ? static_cast<const T*>(y[i]) : nullptr;
  }
  gl.gs[0] = y ? gs0 : nullptr;
  gl.gs[1] = y ? gs1 : nullptr;
  gl.M = M;
  gl.cout = cout;
  gl.n_out = n_out;
  return gl;
}

// The split loader: g and y are host arrays of n_sets * 4 phase pointers
// (set-major), each (B, 5, h/2, w/2, cout) with h = 2^lh, w = 2^lw.
template <typename T>
GLoad<T, true> make_split_gload(const void* const* g, const void* const* y, const float* gs0,
                                const float* gs1, int lh, int lw, int cout, int n_sets) {
  GLoad<T, true> gl = {};
  for (int i = 0; i < n_sets * 4; ++i) {
    gl.g[i] = static_cast<const T*>(g[i]);
    gl.y[i] = y ? static_cast<const T*>(y[i]) : nullptr;
  }
  gl.gs[0] = y ? gs0 : nullptr;
  gl.gs[1] = y ? gs1 : nullptr;
  gl.M = 5 << (lh + lw);
  gl.cout = cout;
  gl.n_out = 1;
  gl.lh = lh;
  gl.lw = lw;
  return gl;
}

// Where dx goes: R rows per sample split over out tensors of `per` cells
// each ((B, per, cin) in T: the 4 input phases, or one level-s grid). With
// mul != null the act adjoint runs in the epilogue: dx = dx' * mul *
// 1{x * mul + add > 0} against the raw input, and the block's column sums of
// dx'·1{..}·x and dx'·1{..} go to red, (blocks, 2 * cin).
template <typename T>
struct DxOut {
  T* out[4];
  const T* raw[4];
  const float* mul;
  const float* add;
  float* red;
  int per;

  // The epilogue of tile (bx, b) whose float32 sums acc hold rows m0 + ty*4
  // + i and channels n0 + tx*4 + j; every thread of the block calls it.
  __device__ __forceinline__ void operator()(const float (&acc)[4][4], int b, int m0, int n0,
                                             int R, int cin, int bx, int gx, float (&As)[BK][BM],
                                             float (&Bs)[BK][BN]) const {
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    float smul[4] = {0.f, 0.f, 0.f, 0.f}, sadd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty * 4 + i;
      if (r >= R) continue;
      const int p = r / per, cell = r - p * per;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = n0 + tx * 4 + j;
        if (k >= cin) continue;
        const size_t off = ((size_t)b * per + cell) * cin + k;
        const float d = acc[i][j];
        if (mul == nullptr) {
          out[p][off] = from_f<T>(d);
          continue;
        }
        const float x = to_f(raw[p][off]);
        const float dm = __fadd_rn(__fmul_rn(x, mul[k]), add[k]) > 0.f ? d : 0.f;
        out[p][off] = from_f<T>(dm * mul[k]);
        smul[j] += dm * x;
        sadd[j] += dm;
      }
    }
    if (mul != nullptr) {
      float* row = red + ((size_t)b * gx + bx) * 2 * cin + n0;
      column_sums(As, Bs, smul, sadd, tid, min(BN, cin - n0), row, row + cin);
    }
  }
};

// The decoder chain's float32 dx epilogue (kernel n; its bf16 dx applies the
// same adjoint in up_pair.cu's pair_adjoint_pass): the R = 5hw rows are the cells
// of the level-s grid that the pair (b0, y10) joins into, each at its phase
// and row by split_row. The residual tail's adjoint runs on the unrounded
// float32 dx: dpre = dx * 1{pair_pre(a, b) > 0} against the raw phases,
// db0 = T(dpre * mul1) and dy10 = T(dpre * mul2) stored de-interleaved, and
// the block's column sums of dpre·a, dpre and dpre·b go to red,
// (blocks, 3 * cin): d_mul1, d_add1 (= d_add2) and d_mul2.
template <typename T>
struct DxPairOut {
  T* out[8];           // db0[4], dy10[4]
  const T* raw[8];     // b0[4], y10[4]
  const float* aff[4];  // mul1, add1, mul2, add2
  float* red;
  int lh, lw;          // log2 of the level-s grid's h and w

  __device__ __forceinline__ void operator()(const float (&acc)[4][4], int b, int m0, int n0,
                                             int R, int cin, int bx, int gx, float (&As)[BK][BM],
                                             float (&Bs)[BK][BN]) const {
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sd[4] = {0.f, 0.f, 0.f, 0.f},
          sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty * 4 + i;
      if (r >= R) continue;
      size_t row;
      const int p = split_row(b, r, lh, lw, row);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = n0 + tx * 4 + j;
        if (k >= cin) continue;
        const size_t off = row * cin + k;
        const float a = to_f(raw[p][off]), c = to_f(raw[4 + p][off]);
        const float dm = pair_pre(a, c, aff, k) > 0.f ? acc[i][j] : 0.f;
        out[p][off] = from_f<T>(dm * aff[0][k]);
        out[4 + p][off] = from_f<T>(dm * aff[2][k]);
        sa[j] += dm * a;
        sd[j] += dm;
        sb[j] += dm * c;
      }
    }
    float* red_row = red + ((size_t)b * gx + bx) * 3 * cin + n0;
    const int n_cols = min(BN, cin - n0);
    column_sums(As, Bs, sa, sd, tid, n_cols, red_row, red_row + cin);
    __syncthreads();  // the third sum reuses As / Bs (both halves write the same value)
    column_sums(As, Bs, sb, sb, tid, n_cols, red_row + 2 * cin, red_row + 2 * cin);
  }
};

// dx[b, r, k] = sum_t sum_{(q, wt) in table row t*R + r} wt * sum_n G[b, q, n] W[t][k, n],
// a GEMM over K = 7 * n_sets * cout whose A operand is gathered (and
// weighted) through the CSR transposed table. Tile (bx, by, b): BM rows r x
// BN channels k of sample b, of gx row tiles; float32 sums, one rounding at
// the end. Shared by the split dx kernel and the merged backward's dx role.
// G is GLoad<T> or the split GLoad<T, true>; O, the epilogue, is DxOut<T>
// or the pair's DxPairOut<T>.
template <typename T, typename G, typename O = DxOut<T>>
__device__ __forceinline__ void dx_tile(const G& gl, const T* __restrict__ w0,
                                        const T* __restrict__ w1,
                                        const int* __restrict__ offsets,
                                        const int* __restrict__ cells,
                                        const float* __restrict__ weights, const O& o,
                                        int R, int cin, int n_sets, int bx, int by, int b, int gx,
                                        float (&As)[BK][BM], float (&Bs)[BK][BN]) {
  const int tid = threadIdx.x;
  const int m0 = bx * BM;
  const int n0 = by * BN;
  const int cout = gl.cout;
  const int Ntot = n_sets * cout;
  const int K = 7 * Ntot;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < BM * BK / NT; ++r) {
      const int e = tid + r * NT;
      const int kk = e % BK, mm = e / BK;  // neighbouring threads: neighbouring channels
      const int m = m0 + mm, kg = k0 + kk;
      float v = 0.f;
      if (m < R && kg < K) {
        const int t = kg / Ntot, n = kg - t * Ntot;
        const int row = t * R + m;
        for (int x = offsets[row]; x < offsets[row + 1]; ++x) v += weights[x] * gl(b, cells[x], n);
      }
      As[kk][mm] = v;
    }
#pragma unroll
    for (int r = 0; r < BN * BK / NT; ++r) {
      const int e = tid + r * NT;
      const int kk = e % BK, nn = e / BK;  // W[t][k][n] is contiguous in n
      const int k = n0 + nn, kg = k0 + kk;
      float v = 0.f;
      if (k < cin && kg < K) {
        const int t = kg / Ntot, n = kg - t * Ntot;
        const int s = n / cout;
        v = to_f((s ? w1 : w0)[((size_t)t * cin + k) * cout + (n - s * cout)]);
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
    tile_fma(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  o(acc, b, m0, n0, R, cin, bx, gx, As, Bs);
}

template <typename T, typename G, typename O = DxOut<T>>
__global__ void __launch_bounds__(NT)
dx_gemm(G gl, const T* __restrict__ w0, const T* __restrict__ w1,
        const int* __restrict__ offsets, const int* __restrict__ cells,
        const float* __restrict__ weights, O o, int R, int cin, int n_sets) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  dx_tile<T, G, O>(gl, w0, w1, offsets, cells, weights, o, R, cin, n_sets, blockIdx.x,
                   blockIdx.y, blockIdx.z, gridDim.x, As, Bs);
}

template <typename T, typename G>
cudaError_t launch_dx_gemm(const G& gl, const void* w0, const void* w1,
                           const int* offsets, const int* cells, const float* weights,
                           const DxOut<T>& o, float* dmul, float* dadd, int B, int R, int cin,
                           int n_sets, cudaStream_t stream) {
  dim3 grid((R + BM - 1) / BM, (cin + BN - 1) / BN, B);
  dx_gemm<T, G><<<grid, NT, 0, stream>>>(gl, static_cast<const T*>(w0),
                                         static_cast<const T*>(w1), offsets, cells, weights, o, R,
                                         cin, n_sets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || o.mul == nullptr) return err;
  SplitOut st = {{dmul, dadd}, 2 * cin, cin};
  return launch_sum_rows(o.red, (int)(grid.x * grid.z), 2LL * cin, st, stream);
}

// dtaps partials: ws[chunk][t * cin + k][n] = sum over the chunk's rows q of
// A(q, t, k) * G(q, n), where the rows q run over (sample, output phase slot,
// cell) and A is the conv operand re-gathered through the forward table by
// the forward's Loader (act prologue, pole means, midpoints included). Tile
// (bx, by, chunk). With gpart, the tiles of the first row tile (bx == 0)
// also write the chunk's column sums of G, gpart[chunk][n]: Σg from the g
// tiles they already hold in shared memory, at no extra pass over g.
template <typename T, typename Loader, typename G>
__device__ __forceinline__ void dtaps_tile(const Loader& ld, const G& gl,
                                           const int* __restrict__ table, int cin, int n_sets,
                                           int out_phase0, int Q, int kc, float* __restrict__ ws,
                                           float* __restrict__ gpart, int bx, int by, int chunk,
                                           float (&As)[BK][BM], float (&Bs)[BK][BN]) {
  const int tid = threadIdx.x;
  const int m0 = bx * BM;  // rows t * cin + k
  const int n0 = by * BN;
  const int q_lo = chunk * kc;
  const int q_hi = min(q_lo + kc, Q);
  const int M = gl.M;
  const int per_b = gl.n_out * M;
  const int Mr = 7 * cin;
  const int Ntot = n_sets * gl.cout;
  const int tx = tid % 16, ty = tid / 16;
  const bool with_gsum = gpart != nullptr && bx == 0;
  float gacc = 0.f;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = q_lo; k0 < q_hi; k0 += BK) {
#pragma unroll
    for (int r = 0; r < BM * BK / NT; ++r) {
      const int e = tid + r * NT;
      const int mm = e % BM, kk = e / BM;  // neighbouring threads: neighbouring channels
      const int row = m0 + mm, q = k0 + kk;
      float v = 0.f;
      if (row < Mr && q < q_hi) {
        const int t = row / cin, k = row - t * cin;
        const int b = q / per_b, qq = q - b * per_b;
        const int slot = qq / M, m = qq - slot * M;
        v = ld(b, table[((size_t)(out_phase0 + slot) * 7 + t) * M + m], k);
      }
      As[kk][mm] = v;
    }
#pragma unroll
    for (int r = 0; r < BN * BK / NT; ++r) {
      const int e = tid + r * NT;
      const int nn = e % BN, kk = e / BN;
      const int n = n0 + nn, q = k0 + kk;
      float v = 0.f;
      if (n < Ntot && q < q_hi) {
        const int b = q / per_b;
        v = gl(b, q - b * per_b, n);
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
    if (with_gsum && tid < BN) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) gacc += Bs[kk][tid];
    }
    tile_fma(As, Bs, acc, tx, ty);
    __syncthreads();
  }
  if (with_gsum && tid < BN && n0 + tid < Ntot) gpart[(size_t)chunk * Ntot + n0 + tid] = gacc;
  float* part = ws + (size_t)chunk * Mr * Ntot;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= Mr) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Ntot) part[(size_t)row * Ntot + n] = acc[i][j];
    }
  }
}

template <typename T, typename Loader, typename G>
__global__ void __launch_bounds__(NT)
dtaps_gemm(Loader ld, G gl, const int* __restrict__ table, int cin, int n_sets,
           int out_phase0, int Q, int kc, float* __restrict__ ws) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  dtaps_tile<T, Loader, G>(ld, gl, table, cin, n_sets, out_phase0, Q, kc, ws, nullptr,
                           blockIdx.x, blockIdx.y, blockIdx.z, As, Bs);
}

// dtaps[set] (7, cin, cout) float32 = the fixed-order sum of the chunks'
// partials; Q = B * n_out * M rows in chunks of kc (a multiple of BK).
template <typename T, typename Loader, typename G>
cudaError_t launch_dtaps_gemm(const Loader& ld, const G& gl, const int* table, int cin,
                              int n_sets, int out_phase0, int Q, int kc, int n_chunks, float* ws,
                              float* dt0, float* dt1, cudaStream_t stream) {
  const int Ntot = n_sets * gl.cout;
  dim3 grid((7 * cin + BM - 1) / BM, (Ntot + BN - 1) / BN, n_chunks);
  dtaps_gemm<T, Loader, G><<<grid, NT, 0, stream>>>(ld, gl, table, cin, n_sets, out_phase0, Q,
                                                    kc, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  SplitOut st = {{dt0, dt1}, Ntot, gl.cout};
  return launch_sum_rows(ws, n_chunks, 7LL * cin * Ntot, st, stream);
}

// Bias gradient, first pass: part[chunk][n] = sum of G (folded) over the
// chunk's `rows` rows q of the flattened (sample, slot, cell) axis.
// Block (32, 8): 32 columns, 8 row lanes.
template <typename G>
__global__ void __launch_bounds__(256)
colsum(G gl, int Q, int rows, int Ntot, float* __restrict__ part) {
  __shared__ float red[8][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  const int q_lo = blockIdx.y * rows;
  const int q_hi = min(q_lo + rows, Q);
  const int per_b = gl.n_out * gl.M;
  float acc = 0.f;
  if (n < Ntot)
    for (int q = q_lo + threadIdx.y; q < q_hi; q += 8) {
      const int b = q / per_b;
      acc += gl(b, q - b * per_b, n);
    }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && n < Ntot) {
    float s = 0.f;
    for (int y = 0; y < 8; ++y) s += red[y][threadIdx.x];
    part[(size_t)blockIdx.y * Ntot + n] = s;
  }
}

// gsum[set] (cout) float32 = sum of G over all B * n_out * M rows.
template <typename T, typename G>
cudaError_t launch_gsum(const G& gl, int B, int n_sets, int rows, float* ws, float* gsum0,
                        float* gsum1, cudaStream_t stream) {
  const int Q = B * gl.n_out * gl.M;
  const int Ntot = n_sets * gl.cout;
  dim3 grid((Ntot + 31) / 32, (Q + rows - 1) / rows);
  colsum<G><<<grid, dim3(32, 8), 0, stream>>>(gl, Q, rows, Ntot, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  SplitOut st = {{gsum0, gsum1}, Ntot, gl.cout};
  return launch_sum_rows(ws, (int)grid.y, (long long)Ntot, st, stream);
}

// The merged backward: ONE launch runs every tile of a conv's backward, with
// two block roles chosen by block index. Blocks [0, dx_blocks) are dx tiles
// (dx_tile: the gather over the transposed table, the act adjoint and the
// d_mul/d_add partials in its epilogue); the rest are dtaps tiles
// (dtaps_tile: the per-chunk dtaps partials, and Σg_eff partials from the
// first row tile). Both roles read g through the one GLoad, so each block
// folds each g element it reads once, rounded to T. The roles do not share
// a staged g tile: each reads g itself (see the .cu files' notes).
struct MergedGrid {
  int dx_x, dx_y, dx_blocks;  // dx tiles: row tiles, channel tiles, x samples
  int dt_x, dt_y;             // dtaps tiles: row tiles, column tiles, x chunks
};

// At most 64 registers a thread, so that 4 blocks fit on an SM as for the
// split kernels (the bf16 GridLoad instantiation otherwise takes 66, which
// allows only 3).
template <typename T, typename Loader>
__global__ void __launch_bounds__(NT, 4)
merged_bwd(GLoad<T> gl, const T* __restrict__ w0, const T* __restrict__ w1,
           const int* __restrict__ offsets, const int* __restrict__ cells,
           const float* __restrict__ weights, DxOut<T> o, int R, Loader ld,
           const int* __restrict__ table, int out_phase0, int Q, int kc, float* __restrict__ ws,
           float* __restrict__ gpart, int cin, int n_sets, MergedGrid mg) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  int i = blockIdx.x;
  if (i < mg.dx_blocks) {
    const int bx = i % mg.dx_x;
    i /= mg.dx_x;
    dx_tile<T, GLoad<T>>(gl, w0, w1, offsets, cells, weights, o, R, cin, n_sets, bx,
                         i % mg.dx_y, i / mg.dx_y, mg.dx_x, As, Bs);
    return;
  }
  i -= mg.dx_blocks;
  const int bx = i % mg.dt_x;
  i /= mg.dt_x;
  dtaps_tile<T, Loader, GLoad<T>>(ld, gl, table, cin, n_sets, out_phase0, Q, kc, ws, gpart, bx,
                                  i % mg.dt_y, i / mg.dt_y, As, Bs);
}

// Launch the merged backward over B samples (R dx rows each, Q = B * n_out *
// M dtaps rows in n_chunks chunks of kc), then the fixed-order second passes:
// dtaps through dt_store, Σg_eff into gsum0/gsum1, and with act d_mul/d_add.
template <typename T, typename Loader, typename DtStore>
cudaError_t launch_merged_bwd(const GLoad<T>& gl, const void* w0, const void* w1,
                              const int* offsets, const int* cells, const float* weights,
                              const DxOut<T>& o, float* dmul, float* dadd, int B, int R,
                              const Loader& ld, const int* table, int out_phase0, int kc,
                              int n_chunks, float* ws, const DtStore& dt_store, float* gpart,
                              float* gsum0, float* gsum1, int cin, int n_sets,
                              cudaStream_t stream) {
  if (kc % BK != 0) return cudaErrorInvalidValue;
  const int Ntot = n_sets * gl.cout;
  const int Q = B * gl.n_out * gl.M;
  MergedGrid mg;
  mg.dx_x = (R + BM - 1) / BM;
  mg.dx_y = (cin + BN - 1) / BN;
  mg.dx_blocks = mg.dx_x * mg.dx_y * B;
  mg.dt_x = (7 * cin + BM - 1) / BM;
  mg.dt_y = (Ntot + BN - 1) / BN;
  const long long blocks = (long long)mg.dx_blocks + (long long)mg.dt_x * mg.dt_y * n_chunks;
  merged_bwd<T, Loader><<<(unsigned)blocks, NT, 0, stream>>>(
      gl, static_cast<const T*>(w0), static_cast<const T*>(w1), offsets, cells, weights, o, R,
      ld, table, out_phase0, Q, kc, ws, gpart, cin, n_sets, mg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_sum_rows(ws, n_chunks, 7LL * cin * Ntot, dt_store, stream);
  if (err != cudaSuccess) return err;
  SplitOut gst = {{gsum0, gsum1}, Ntot, gl.cout};
  err = launch_sum_rows(gpart, n_chunks, (long long)Ntot, gst, stream);
  if (err != cudaSuccess || o.mul == nullptr) return err;
  SplitOut st = {{dmul, dadd}, 2 * cin, cin};
  return launch_sum_rows(o.red, mg.dx_x * B, 2LL * cin, st, stream);
}

}  // namespace gn
