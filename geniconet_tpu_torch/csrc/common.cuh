// Shared pieces of the hex-conv kernels: element types, halo codes, the
// halo-resolving loaders, and one implicit-GEMM core.
//
// Layout (as the JAX package): activations channels-last (B, 5, h, w, C),
// taps (7, C_in, C_out), bias (C_out). Activations and taps are float32 or
// bfloat16; sums are float32; the act prologue's (mul, add) are float32.
//
// A conv output cell m (chart, i, j) of output phase p reads, for tap t, the
// source named by an int32 table entry table[p][t][m]: a cell index into one
// sample's source space, or a code (ZERO, NORTH, SOUTH; see
// ops/kernels/halo.py, which builds the tables from the plain pad ops).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace gn {

constexpr int ZERO = -1;
constexpr int NORTH = -2;
constexpr int SOUTH = -3;
constexpr int NONE = -4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float32 value to T and back: where the reference casts to the
// activation dtype, the kernels do too.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// The BN-apply + ReLU prologue, relu(x*mul + add) in float32 without FMA
// contraction (the reference multiplies and adds as two roundings), then
// cast to T. Applied BEFORE the halo, so pole means are of activated values.
template <typename T>
__device__ __forceinline__ float act_apply(float v, const float* mul, const float* add, int k) {
  if (mul == nullptr) return v;
  return round_to<T>(fmaxf(__fadd_rn(__fmul_rn(v, mul[k]), add[k]), 0.f));
}

// Activations of one grid held as `n_src` tensors of shape (B, 5, h, w, C)
// (the 4 phases of a phase conv, or the 1 standard grid of a plain conv).
// A source index `code >= 0` is src * 5hw + chart * hw + i * w + j.
// NORTH is the 5-chart mean of cell 0 of source 0; SOUTH of cell hw-1 of
// source `south_src` (phase oq = 3 for phases, 0 for a standard grid).
template <typename T>
struct GridLoad {
  const T* src[4];
  const float* mul;  // act prologue, nullable
  const float* add;
  int hw, hw5, cin, south_src;

  __device__ __forceinline__ float cell(int b, int s, int r, int k) const {
    return act_apply<T>(to_f(src[s][((size_t)b * hw5 + r) * cin + k]), mul, add, k);
  }
  __device__ __forceinline__ float operator()(int b, int code, int k) const {
    if (code >= 0) {
      int s = code / hw5;
      return cell(b, s, code - s * hw5, k);
    }
    if (code == ZERO) return 0.f;
    const int s = code == NORTH ? 0 : south_src;
    const int off = code == NORTH ? 0 : hw - 1;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 5; ++c) acc += cell(b, s, c * hw + off, k);
    return round_to<T>(acc * 0.2f);
  }
};

// Implicit GEMM: out[set][phase][b, m, n] = sum_{t,k} A_t[m, k] W_set[t, k, n] + bias,
// with A_t gathered through the table by a Loader. One block computes a
// BM x BN tile of (cells of one output phase of one sample) x (output
// channels of the n_sets tap sets laid side by side), walking the
// K = 7 * C_in contraction in BK slices staged in shared memory.
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;

// The GEMM cores' shared steps. A block of NT = 256 threads computes a
// BM x BN tile; thread (tx, ty) = (tid % 16, tid / 16) holds rows ty*4..+3
// and columns tx*4..+3 in acc.
__device__ __forceinline__ void tile_fma(const float (&As)[BK][BM], const float (&Bs)[BK][BN],
                                         float (&acc)[4][4], int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = Bs[kk][tx * 4 + j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

// Two per-column sums over the block's rows (each thread gives its 4
// columns' partials u, v over its 4 rows), added in a fixed order; the sums
// of tile column c land in u_out[c], v_out[c] for c < n_cols. As / Bs are
// reused, so call after the K loop's last __syncthreads; every thread of
// the block must call it, and __syncthreads before reusing As / Bs.
__device__ __forceinline__ void column_sums(float (&As)[BK][BM], float (&Bs)[BK][BN],
                                            const float (&u)[4], const float (&v)[4], int tid,
                                            int n_cols, float* u_out, float* v_out) {
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    As[ty][tx * 4 + j] = u[j];
    Bs[ty][tx * 4 + j] = v[j];
  }
  __syncthreads();
  if (tid < n_cols) {
    float su = 0.f, sv = 0.f;
    for (int r = 0; r < BK; ++r) {
      su += As[r][tid];
      sv += Bs[r][tid];
    }
    u_out[tid] = su;
    v_out[tid] = sv;
  }
}

template <typename T>
struct ConvOut {
  T* out[8];           // set-major: out[set * n_out + phase slot] (split: set * 4 + phase)
  const T* w[2];       // taps per set, (7, C_in, C_out)
  const T* bias[2];    // per set, nullable
  float* stats;        // nullable: per-block [sum | sumsq] partials, (blocks, 2 * N)
  int split_lh, split_lw;  // the split store only: log2 of the output grid's h and w
};

// The split store (the phase chain's stride-2 conv): output row m = (chart,
// i, j) of the (5, h, w) level-(s-1) grid goes to parity phase
// p = 2 * (i & 1) + (j & 1) at (chart, i >> 1, j >> 1) of a (5, h/2, w/2)
// phase grid, i.e. ops/phase.py:phase_split done by addressing. h = 2^lh and
// w = 2^lw (an icosahedral chart, h >= 2), so the map is shifts and masks.
// Returns the phase and sets `row` to the sample-b row of that phase tensor.
__device__ __forceinline__ int split_row(int b, int m, int lh, int lw, size_t& row) {
  const int chart = m >> (lh + lw), r = m & ((1 << (lh + lw)) - 1);
  const int i = r >> lw, j = r & ((1 << lw) - 1);
  row = (((((size_t)b * 5 + chart) << (lh - 1)) + (i >> 1)) << (lw - 1)) + (j >> 1);
  return ((i & 1) << 1) | (j & 1);
}

// The residual join's pre-activation ((a*mul1 + add1) + b*mul2) + add2 of
// channel k, in float32 without FMA contraction (the reference's order and
// roundings); aff = {mul1, add1, mul2, add2}, each (C,) float32.
__device__ __forceinline__ float pair_pre(float a, float b, const float* const (&aff)[4], int k) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, aff[0][k]), aff[1][k]),
                             __fmul_rn(b, aff[2][k])), aff[3][k]);
}

// The level-s grid cells an UpLoad reads, by cell index r = chart * hw +
// i * w + j of one sample (hw5 = 5hw cells a sample, cin channels): one
// (B, 5, h, w, cin) tensor ...
template <typename T>
struct GridCells {
  const T* x;
  __device__ __forceinline__ float operator()(int b, int r, int k, int hw5, int cin) const {
    return to_f(x[((size_t)b * hw5 + r) * cin + k]);
  }
};

// Entry p of a 4-array of kernel parameters by selects: indexing it with a
// run-time p would copy the array to local memory.
template <typename P>
__device__ __forceinline__ P pick4(const P (&a)[4], int p) {
  return p < 2 ? (p == 0 ? a[0] : a[1]) : (p == 2 ? a[2] : a[3]);
}

// ... or the decoder's phase chain pair: cell r is the join
// relu(pair_pre(b0[p], y10[p])) rounded to T, of the previous UpBlock's raw
// phases (B, 5, h/2, w/2, cin) at the cell that split_row maps r to (the
// reference's _pair_join, then _interleave4, done by addressing).
template <typename T>
struct PairCells {
  const T* b0[4];
  const T* y10[4];
  const float* aff[4];  // mul1, add1, mul2, add2
  int lh, lw;           // log2 of the level-s grid's h and w
  __device__ __forceinline__ float operator()(int b, int r, int k, int, int cin) const {
    size_t row;
    const int p = split_row(b, r, lh, lw, row);
    const size_t off = row * cin + k;
    const float a = to_f(pick4(b0, p)[off]), c = to_f(pick4(y10, p)[off]);
    return round_to<T>(fmaxf(pair_pre(a, c, aff, k), 0.f));
  }
};

// The cells of the upsampled level-(s+1) phases, rebuilt on load from a
// level-s grid: the level-s halo (ico_pad, with pole means cast to the
// activation dtype), the edge midpoints as (a + b) * 0.5 with the sum
// rounded to the activation dtype, then the phase halo of the four new
// phases, whose poles are recomputed from the new phases. Cells is
// GridCells<T> (the up conv) or PairCells<T> (kernel n: the level-s grid is
// the join of a pair, so the pole means are of joined cells).
template <typename T, typename Cells = GridCells<T>>
struct UpLoad {
  Cells x;         // the (B, 5, h, w, cin) level-s grid
  const int* up;   // (4 * 5hw, 2) midpoint pairs, halo.upsample_table
  int hw, hw5, cin;

  // a cell of the level-s padded grid P (a grid cell, a zero, or a pole)
  __device__ __forceinline__ float pcell(int b, int code, int k) const {
    if (code >= 0) return x(b, code, k, hw5, cin);
    if (code == ZERO) return 0.f;
    const int off = code == NORTH ? 0 : hw - 1;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 5; ++c) acc += x(b, c * hw + off, k, hw5, cin);
    return round_to<T>(acc * 0.2f);
  }
  // a cell of the four upsampled phases, index p * 5hw + chart * hw + i * w + j
  __device__ __forceinline__ float ucell(int b, int idx, int k) const {
    const float a = pcell(b, up[2 * idx], k);
    const int second = up[2 * idx + 1];
    if (second == NONE) return a;
    return round_to<T>(round_to<T>(a + pcell(b, second, k)) * 0.5f);
  }
  __device__ __forceinline__ float operator()(int b, int code, int k) const {
    if (code >= 0) return ucell(b, code, k);
    if (code == ZERO) return 0.f;
    // poles of level s+1: 5-chart means of phase ee cell 0 / phase oq cell hw-1
    const int base = code == NORTH ? 0 : 3 * hw5 + hw - 1;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 5; ++c) acc += ucell(b, base + c * hw, k);
    return round_to<T>(acc * 0.2f);
  }
};

// Where a deterministic column sum lands: column c of a (rows, C) partial
// array is (a, n) with a = c / ntot, n = c % ntot; n picks the tap set
// (n / cout) and its column, so out[set][a * cout + n % cout] gets the sum.
struct SplitOut {
  float* out[2];
  int ntot, cout;
  __device__ __forceinline__ void operator()(long long c, float v) const {
    const long long a = c / ntot;
    const int n = (int)(c - a * ntot);
    const int s = n / cout;
    out[s][a * cout + (n - s * cout)] = v;
  }
};

// Up to 4 stacked vectors of n columns each: column c of the partial array
// goes to out[c / n][c % n].
struct StackOut {
  float* out[4];
  int n;
  __device__ __forceinline__ void operator()(long long c, float v) const {
    const int s = (int)(c / n);
    out[s][c - (long long)s * n] = v;
  }
};

// The second pass of every cross-block reduction: out(c) = sum over rows r
// of in[r][c], rows taken in a fixed order, so the result does not depend
// on which block finished first. Block (32, 32): 32 columns, 32 row lanes.
template <typename Store>
__global__ void __launch_bounds__(1024)
sum_rows(const float* __restrict__ in, int R, long long C, Store st) {
  __shared__ float part[32][33];
  const long long c = (long long)blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < C)
    for (int r = threadIdx.y; r < R; r += 32) acc += in[(size_t)r * C + c];
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float s = 0.f;
    for (int y = 0; y < 32; ++y) s += part[y][threadIdx.x];
    st(c, s);
  }
}

template <typename Store>
cudaError_t launch_sum_rows(const float* in, int R, long long C, Store st, cudaStream_t stream) {
  const long long blocks = (C + 31) / 32;
  sum_rows<Store><<<(unsigned)blocks, dim3(32, 32), 0, stream>>>(in, R, C, st);
  return cudaGetLastError();
}

// SPLIT: the split store (split_row) instead of out[set * n_out + slot] at row
// b * M + m; the GEMM, its row order and the stats partials are the same.
template <typename T, typename Loader, bool SPLIT>
__global__ void __launch_bounds__(NT)
conv_gemm(Loader ld, ConvOut<T> co, const int* __restrict__ table, int M, int cin,
          int cout, int n_sets, int out_phase0, int n_out) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z / n_out;
  const int slot = blockIdx.z - b * n_out;
  const int* tab = table + (size_t)(out_phase0 + slot) * 7 * M;
  const int K = 7 * cin;
  const int N = n_sets * cout;
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
      if (m < M && kg < K) {
        const int t = kg / cin;
        v = ld(b, tab[t * M + m], kg - t * cin);
      }
      As[kk][mm] = v;
    }
#pragma unroll
    for (int r = 0; r < BN * BK / NT; ++r) {
      const int e = tid + r * NT;
      const int nn = e % BN, kk = e / BN;
      const int n = n0 + nn, kg = k0 + kk;
      float v = 0.f;
      if (n < N && kg < K) {
        const int s = n / cout;
        v = to_f(co.w[s][(size_t)kg * cout + (n - s * cout)]);
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
    tile_fma(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  float csum[4] = {0.f, 0.f, 0.f, 0.f}, csq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const int s = n / cout, nc = n - s * cout;
      const float bias = co.bias[s] ? to_f(co.bias[s][nc]) : 0.f;
      const T y = from_f<T>(acc[i][j] + bias);
      if constexpr (SPLIT) {
        size_t row;
        const int p = split_row(b, m, co.split_lh, co.split_lw, row);
        co.out[s * 4 + p][row * cout + nc] = y;
      } else {
        co.out[s * n_out + slot][((size_t)b * M + m) * cout + nc] = y;
      }
      const float v = to_f(y);  // the moments are of the downcast output
      csum[j] += v;
      csq[j] += v * v;
    }
  }
  if (co.stats != nullptr) {
    float* row = co.stats + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * 2 * N + n0;
    column_sums(As, Bs, csum, csq, tid, min(BN, N - n0), row, row + N);
  }
}

// Launch the conv GEMM, then (with co.stats) sum the block partials into
// stats[set] = (2, cout) [sum, sumsq] over every output phase and sample.
template <typename T, typename Loader, bool SPLIT = false>
cudaError_t launch_conv_gemm(const Loader& ld, const ConvOut<T>& co, const int* table, int B,
                             int M, int cin, int cout, int n_sets, int out_phase0, int n_out,
                             float* const* stats, cudaStream_t stream) {
  if (SPLIT && n_out != 1) return cudaErrorInvalidValue;
  dim3 grid((M + BM - 1) / BM, (n_sets * cout + BN - 1) / BN, B * n_out);
  conv_gemm<T, Loader, SPLIT><<<grid, NT, 0, stream>>>(ld, co, table, M, cin, cout, n_sets,
                                                       out_phase0, n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || co.stats == nullptr) return err;
  SplitOut st = {{stats[0], stats[1]}, n_sets * cout, cout};
  return launch_sum_rows(co.stats, (int)(grid.x * grid.z), 2LL * n_sets * cout, st, stream);
}

}  // namespace gn
