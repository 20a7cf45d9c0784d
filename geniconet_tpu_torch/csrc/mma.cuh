// What the tensor-core GEMMs share (bf16): the operand (its row layout, the
// passes that write it once, the loader that names its rows through the
// conv table) and the mma.sync primitives. The operand is the up convs'
// upsampled level-(s+1) grid (up_operand_pass), the grid convs'
// act-applied input (grid_operand_pass) or, for the input gradients of the
// phase conv, the up conv, the standard conv and the phase chain's
// stride-2 conv (a, c, f, m), the folded cotangent with its combined rows
// (cot_operand_pass; m's read from the parity phases). mma_dtaps.cuh (the
// tap gradients: d, n, b, f and m's; i's, j's and k's over the written
// cotangent) and mma_conv_fwd.cuh (the forwards: the up conv, n, the grid
// convs and m's; the dx of a, c, f, m, i, j and k) build their GEMMs on
// them.
#pragma once

#include "backward.cuh"

namespace gn {

// 8 channels of an operand row as they are stored (16 bytes in bf16), and
// their store: element i of an operand of ldk = 8 * chunks channels a row is
// row i / chunks, channels (i % chunks) * 8 .., at out + 8 i.
template <typename T>
struct Chunk8 {
  alignas(16) T v[8];
};

template <typename T>
__device__ __forceinline__ void store_chunk(T* __restrict__ out, long long i, const Chunk8<T>& p) {
  uint4* dst = reinterpret_cast<uint4*>(out + i * 8);
#pragma unroll
  for (int j = 0; j < (int)sizeof(p) / 16; ++j) dst[j] = reinterpret_cast<const uint4*>(p.v)[j];
}

// the operand rows' layout, shared by the passes and the GEMMs' loader: per
// sample its n_src * 5hw cells (4 phases, or 1 standard grid), then its 2
// pole rows; after the last sample one zero row
__host__ __device__ __forceinline__ int operand_width(int cin) { return (cin + 7) & ~7; }
__host__ __device__ __forceinline__ int operand_per_sample(int hw5, int n_src = 4) {
  return n_src * hw5 + 2;
}
// the 8-channel elements of an operand of cin channels a row
inline long long operand_total(int B, int hw5, int n_src, int cin) {
  return ((long long)B * operand_per_sample(hw5, n_src) + 1) * (operand_width(cin) / 8);
}

// The operand pass's loads 8 channels at a time, where C_in is a multiple
// of 8 (16-byte rows): gn::UpLoad's pcell / ucell / pole arithmetic, value
// by value in its order and roundings, on the 8 channels of a Cells8.
// COHERENT: through L2 only (data written earlier in the same launch).
template <bool COHERENT = false, typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  alignas(16) T t[8];
#pragma unroll
  for (int j = 0; j < (int)sizeof(t) / 16; ++j)
    reinterpret_cast<uint4*>(t)[j] = load<COHERENT>(reinterpret_cast<const uint4*>(p) + j);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = to_f(t[e]);
}

// 8 channels k0 .. k0 + 7 of the level-s cells: a GridCells row as it is;
// a PairCells cell joined, with its 4 affines' 8 channels loaded once.
template <typename Cells>
struct Cells8;

template <typename T>
struct Cells8<GridCells<T>> {
  const T* x;
  int k0, hw5, cin;
  __device__ __forceinline__ Cells8(const GridCells<T>& c, int k0_, int hw5_, int cin_)
      : x(c.x), k0(k0_), hw5(hw5_), cin(cin_) {}
  __device__ __forceinline__ void operator()(int b, int r, float (&v)[8]) const {
    load8(x + ((size_t)b * hw5 + r) * cin + k0, v);
  }
};

template <typename T>
struct Cells8<PairCells<T>> {
  const PairCells<T>& x;
  int k0, cin;
  float aff[4][8];
  __device__ __forceinline__ Cells8(const PairCells<T>& c, int k0_, int, int cin_)
      : x(c), k0(k0_), cin(cin_) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) aff[i][e] = c.aff[i][k0 + e];
  }
  __device__ __forceinline__ void operator()(int b, int r, float (&v)[8]) const {
    size_t row;
    const int p = split_row(b, r, x.lh, x.lw, row);
    float a[8], c[8];
    load8(pick4(x.b0, p) + row * cin + k0, a);
    load8(pick4(x.y10, p) + row * cin + k0, c);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = round_to<T>(fmaxf(pair_pre(a[e], c[e], aff[0][e], aff[1][e], aff[2][e], aff[3][e]),
                               0.f));
  }
};

template <typename T, typename Cells>
__device__ __forceinline__ void pcell8(const UpLoad<T, Cells>& ld, const Cells8<Cells>& x, int b,
                                       int code, float (&v)[8]) {
  if (code >= 0) {
    x(b, code, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  if (code == ZERO) return;
  const int off = code == NORTH ? 0 : ld.hw - 1;
  for (int c = 0; c < 5; ++c) {
    float t[8];
    x(b, c * ld.hw + off, t);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += t[e];
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = round_to<T>(v[e] * 0.2f);
}

template <typename T, typename Cells>
__device__ __forceinline__ void ucell8(const UpLoad<T, Cells>& ld, const Cells8<Cells>& x, int b,
                                       int idx, float (&v)[8]) {
  pcell8(ld, x, b, ld.up[2 * idx], v);
  const int second = ld.up[2 * idx + 1];
  if (second == NONE) return;
  float t[8];
  pcell8(ld, x, b, second, t);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = round_to<T>(round_to<T>(v[e] + t[e]) * 0.5f);
}

// Whether every level-s tensor of the cells is 16-byte aligned (with C_in a
// multiple of 8, every row then is, for the 8-channel loads).
inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }
template <typename T>
bool aligned16(const GridCells<T>& c) { return aligned16(c.x); }
template <typename T>
bool aligned16(const PairCells<T>& c) {
  for (int p = 0; p < 4; ++p)
    if (!aligned16(c.b0[p]) || !aligned16(c.y10[p])) return false;
  return true;
}

// Element i of a level-s grid's upsampled operand (for n, the pair joined
// by pair_join_pass): 8 channels of one operand row. vec: C_in is a
// multiple of 8 and the grid's rows are 16-byte aligned, so loads take 8
// channels at a time.
template <typename T>
__device__ __forceinline__ Chunk8<T> up_operand_chunk(const UpLoad<T>& ld, int B, int zero_poles,
                                                      int vec, long long i) {
  const int ldk = operand_width(ld.cin), chunks = ldk / 8;
  const long long r = i / chunks;
  const int c = (int)(i - r * chunks);
  const int per = operand_per_sample(ld.hw5);
  const int b = (int)(r / per), rr = (int)(r - (long long)b * per);
  const int phases = 4 * ld.hw5;
  const bool pole = rr >= phases, cell = b < B && !(pole && zero_poles);
  float v[8];
  if (vec) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
    const Cells8<GridCells<T>> x(ld.x, c * 8, ld.hw5, ld.cin);
    if (cell && !pole) {
      ucell8(ld, x, b, rr, v);
    } else if (cell) {  // level-(s+1) pole: 5-chart mean of phase ee cell 0 / phase oq cell hw-1
      const int base = rr == phases ? 0 : 3 * ld.hw5 + ld.hw - 1;
      for (int ch = 0; ch < 5; ++ch) {
        float t[8];
        ucell8(ld, x, b, base + ch * ld.hw, t);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += t[e];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = round_to<T>(v[e] * 0.2f);
    }
  } else {  // a ragged C_in (or rows): channel by channel through UpLoad itself
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = c * 8 + e;
      v[e] = !cell || k >= ld.cin ? 0.f
             : pole ? ld(b, rr == phases ? NORTH : SOUTH, k) : ld.ucell(b, rr, k);
    }
  }
  Chunk8<T> pack;
#pragma unroll
  for (int e = 0; e < 8; ++e) pack.v[e] = from_f<T>(v[e]);
  return pack;
}

// One thread an element of up_operand_chunk (Tag names the instantiation:
// GridCells for d, PairCells for n).
template <typename T, typename Tag>
__global__ void __launch_bounds__(256)
up_operand_pass(UpLoad<T> ld, T* __restrict__ out, int B, int zero_poles, int vec,
                long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) store_chunk(out, i, up_operand_chunk(ld, B, zero_poles, vec, i));
}

// One thread: 8 channels of one cell of the level-s grid that a pair joins
// into, written as a (B, 5, h, w, C_in) grid: PairCells' join, value by value.
template <typename T>
__global__ void __launch_bounds__(256)
pair_join_pass(PairCells<T> x, T* __restrict__ out, int hw5, int cin, int vec, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int chunks = (cin + 7) / 8;
  const long long r = i / chunks;
  const int c = (int)(i - r * chunks);
  const int b = (int)(r / hw5), cell = (int)(r - (long long)b * hw5);
  T* dst = out + r * cin + c * 8;
  if (vec) {
    float v[8];
    Cells8<PairCells<T>>(x, c * 8, hw5, cin)(b, cell, v);
    alignas(16) T pack[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) pack[e] = from_f<T>(v[e]);
#pragma unroll
    for (int j = 0; j < (int)sizeof(pack) / 16; ++j)
      reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(pack)[j];
  } else {
    for (int e = 0; e < 8 && c * 8 + e < cin; ++e)
      dst[e] = from_f<T>(x(b, cell, c * 8 + e, hw5, cin));
  }
}

// Write the (B * (4 * 5hw + 2) + 1, operand_width(cin)) operand of a level-s
// grid; Tag names the pass (GridCells: d's, PairCells: n's).
template <typename T, typename Tag>
cudaError_t launch_upsampled_operand(const UpLoad<T>& ld, T* out, int B, int zero_poles,
                                     cudaStream_t stream) {
  const long long total = operand_total(B, ld.hw5, 4, ld.cin);
  const int vec = ld.cin % 8 == 0 && aligned16(ld.x);
  up_operand_pass<T, Tag><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      ld, out, B, zero_poles, vec, total);
  return cudaGetLastError();
}

// The operand of the up conv's level-s grid (d; `joined` is not used) ...
template <typename T>
cudaError_t launch_up_operand(const UpLoad<T>& ld, T* out, void*, int B, int zero_poles,
                              cudaStream_t stream) {
  return launch_upsampled_operand<T, GridCells<T>>(ld, out, B, zero_poles, stream);
}

// ... or of a pair (n): the pair joined once into `joined`, (B, 5, h, w,
// C_in), then the same pass over that grid.
template <typename T>
cudaError_t launch_up_operand(const UpLoad<T, PairCells<T>>& ld, T* out, T* joined, int B,
                              int zero_poles, cudaStream_t stream) {
  if (joined == nullptr) return cudaErrorInvalidValue;
  const long long total = (long long)B * ld.hw5 * ((ld.cin + 7) / 8);
  const int vec = ld.cin % 8 == 0 && aligned16(ld.x);
  pair_join_pass<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(ld.x, joined, ld.hw5,
                                                                         ld.cin, vec, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  UpLoad<T> grid;
  grid.x = {joined};
  grid.up = ld.up;
  grid.hw = ld.hw;
  grid.hw5 = ld.hw5;
  grid.cin = ld.cin;
  return launch_upsampled_operand<T, PairCells<T>>(grid, out, B, zero_poles, stream);
}

// The grid convs' operand (the phase conv's 4 input phases, the standard
// conv's grid; their forwards and dtaps b, f): one thread writes 8
// channels of one row, the
// act-applied cell (act_apply, rounded to T; the raw cell without act) or a
// pole row, the 5-chart mean of cell 0 of source 0 (NORTH) / of cell hw-1
// of source south_src (SOUTH) with GridLoad's sums and roundings (zeros
// under corner_mode "zeros"), or the zero row. A cell's source-space code
// s * 5hw + cell is its row within the sample, so GridLoad names both. vec:
// C_in is a multiple of 8 and the sources 16-byte aligned (8-channel
// loads); otherwise channel by channel through GridLoad itself. COHERENT:
// the sources and the act were written earlier in the same launch (the
// merged blocks' pass B), so every read of them goes through L2 (load<true>),
// but where ACT_SHARED: there the 8-channel path's mul and add are a copy in
// shared memory, 16-byte aligned, read 4 channels a load (read through L2 at
// every chunk, 16 loads of them, the pass took 5-6x the split route's time;
// 16 loads of the shared copy, 1.2-1.5x its time with 4).
template <bool ACT_SHARED, typename T, bool COHERENT>
__device__ __forceinline__ void act8(const GridLoad<T, COHERENT>& ld, const T* src, int b, int r,
                                     int k0, float (&v)[8]) {
  load8<COHERENT>(src + ((size_t)b * ld.hw5 + r) * ld.cin + k0, v);
  if constexpr (ACT_SHARED) {  // act_apply's arithmetic, 8 channels' mul and add in 4 loads
    float m[8], a[8];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 mj = reinterpret_cast<const float4*>(ld.mul + k0)[j];
      const float4 aj = reinterpret_cast<const float4*>(ld.add + k0)[j];
      m[4 * j] = mj.x, m[4 * j + 1] = mj.y, m[4 * j + 2] = mj.z, m[4 * j + 3] = mj.w;
      a[4 * j] = aj.x, a[4 * j + 1] = aj.y, a[4 * j + 2] = aj.z, a[4 * j + 3] = aj.w;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = round_to<T>(fmaxf(__fadd_rn(__fmul_rn(v[e], m[e]), a[e]), 0.f));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = act_apply<T, COHERENT>(v[e], ld.mul, ld.add, k0 + e);
  }
}

// Element i of a grid conv's operand over n_src sources: 8 channels of one
// operand row (ACT_SHARED: as act8).
template <bool ACT_SHARED = false, typename T, bool COHERENT>
__device__ __forceinline__ Chunk8<T> grid_operand_chunk(const GridLoad<T, COHERENT>& ld, int B,
                                                        int n_src, int zero_poles, int vec,
                                                        long long i) {
  const int ldk = operand_width(ld.cin), chunks = ldk / 8;
  const long long r = i / chunks;
  const int c = (int)(i - r * chunks);
  const int per = operand_per_sample(ld.hw5, n_src), cells = n_src * ld.hw5;
  const int b = (int)(r / per), rr = (int)(r - (long long)b * per);
  const bool pole = rr >= cells, live = b < B && !(pole && zero_poles);
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  if (live && vec) {
    if (!pole) {
      const int s = rr / ld.hw5;
      act8<ACT_SHARED>(ld, pick4(ld.src, s), b, rr - s * ld.hw5, c * 8, v);
    } else {  // 5-chart mean of the sources' pole cells
      const bool north = rr == cells;
      const T* src = north ? ld.src[0] : pick4(ld.src, ld.south_src);
      for (int ch = 0; ch < 5; ++ch) {
        float t[8];
        act8<ACT_SHARED>(ld, src, b, ch * ld.hw + (north ? 0 : ld.hw - 1), c * 8, t);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += t[e];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = round_to<T>(v[e] * 0.2f);
    }
  } else if (live) {  // a ragged C_in (or unaligned sources): channel by channel
    const int code = !pole ? rr : rr == cells ? NORTH : SOUTH;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (c * 8 + e < ld.cin) v[e] = ld(b, code, c * 8 + e);
  }
  Chunk8<T> pack;
#pragma unroll
  for (int e = 0; e < 8; ++e) pack.v[e] = from_f<T>(v[e]);
  return pack;
}

// One thread an element of grid_operand_chunk; Tag names the instantiation
// (the phase conv's or the standard conv's) for a profile.
template <typename T, typename Tag>
__global__ void __launch_bounds__(256)
grid_operand_pass(GridLoad<T> ld, T* __restrict__ out, int B, int n_src, int zero_poles, int vec,
                  long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) store_chunk(out, i, grid_operand_chunk(ld, B, n_src, zero_poles, vec, i));
}

// Whether a grid conv's n_src sources are read 8 channels at a time: C_in
// a multiple of 8 and every source 16-byte aligned.
template <typename T, bool COHERENT>
int grid_operand_vec(const GridLoad<T, COHERENT>& ld, int n_src) {
  int vec = ld.cin % 8 == 0;
  for (int s = 0; s < n_src; ++s) vec = vec && aligned16(ld.src[s]);
  return vec;
}


// Write the (B * (n_src * 5hw + 2) + 1, operand_width(cin)) operand of a
// grid conv's n_src sources (ld.src[0 .. n_src-1]).
template <typename T, typename Tag>
cudaError_t launch_grid_operand(const GridLoad<T>& ld, T* out, int B, int n_src, int zero_poles,
                                cudaStream_t stream) {
  const long long total = operand_total(B, ld.hw5, n_src, ld.cin);
  grid_operand_pass<T, Tag><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      ld, out, B, n_src, zero_poles, grid_operand_vec(ld, n_src), total);
  return cudaGetLastError();
}

// The combined rows of the dx GEMMs' operand (halo.phase_dx_codes,
// halo.std_dx_codes): row j
// is the sum of weights[x] * (cotangent row cells[x]) over x in
// offsets[j] .. offsets[j + 1]; n of them a sample.
struct CombRows {
  const int* offsets;
  const int* cells;
  const float* weights;
  int n;
};

// 8 columns n0 .. n0 + 7 of cotangent row q of sample b, as GLoad gives
// them (the stats fold with fold_geff's roundings; SPLIT: row q of the
// stride-2 output grid from its parity phase at split_row's cell, m's dx);
// vec: cout is a multiple of 8 and g, y 16-byte aligned, so the 8 are one
// set's, loaded at once.
template <bool SPLIT>
__device__ __forceinline__ void cot8(const GLoad<__nv_bfloat16, SPLIT>& gl, int b, int q, int n0,
                                     int ntot, int vec, float (&v)[8]) {
  if (!vec) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = n0 + e < ntot ? gl(b, q, n0 + e) : 0.f;
    return;
  }
  const int s = n0 / gl.cout, nl = n0 - s * gl.cout;
  size_t row;
  int i;
  if constexpr (SPLIT) {
    i = s * 4 + split_row(b, q, gl.lh, gl.lw, row);
  } else {
    const int slot = q / gl.M, m = q - slot * gl.M;
    i = s * gl.n_out + slot;
    row = (size_t)b * gl.M + m;
  }
  const size_t off = row * gl.cout + nl;
  load8(gl.g[i] + off, v);
  const float* gs = gl.gs[s];
  if (gs == nullptr) return;
  float y[8];
  load8(gl.y[i] + off, y);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = fold_geff<__nv_bfloat16>(v[e], y[e], gs[nl + e], gs[gl.cout + nl + e]);
}

// One thread: 8 columns of one row of the dx GEMMs' cotangent operand (a,
// c, f): per sample its n_out * M rows q = slot * M + m (f: its one grid's
// M rows), the n_sets sets' g_eff side by side (GLoad's values, folded
// once), then its combined rows, each a float32 weighted sum of those
// values rounded to bf16 once; after the last sample one zero row; columns
// past n_sets * cout are zeros. SPLIT (m's dx): the M rows of the
// stride-2 output grid, read from its 4 parity phases (cot8). Tag names
// the instantiation (a's PhaseGrid, c's GridCells, f's StdGrid, m's
// SplitGrid, i's MergedPhase, j's MergedUp, k's MergedStd) for a profile.
template <typename Tag, bool SPLIT>
__global__ void __launch_bounds__(256)
cot_operand_pass(GLoad<__nv_bfloat16, SPLIT> gl, CombRows comb, __nv_bfloat16* __restrict__ out,
                 int B, int ntot, int vec, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ldk = operand_width(ntot), chunks = ldk / 8;
  const long long r = i / chunks;
  const int c = (int)(i - r * chunks), n0 = c * 8;
  const int rows = gl.n_out * gl.M, per = rows + comb.n;
  const int b = (int)(r / per), rr = (int)(r - (long long)b * per);
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  if (b < B && n0 < ntot) {
    if (rr < rows) {
      cot8(gl, b, rr, n0, ntot, vec, v);
    } else {
      const int j = rr - rows;
      for (int x = comb.offsets[j]; x < comb.offsets[j + 1]; ++x) {
        float t[8];
        cot8(gl, b, comb.cells[x], n0, ntot, vec, t);
        const float wt = comb.weights[x];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += wt * t[e];
      }
    }
  }
  alignas(16) __nv_bfloat16 pack[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) pack[e] = from_f<__nv_bfloat16>(v[e]);
  *reinterpret_cast<uint4*>(out + r * ldk + n0) = *reinterpret_cast<const uint4*>(pack);
}

// Write the (B * (n_out * M + comb.n) + 1, operand_width(n_sets * cout))
// cotangent operand of the cotangents gl (n_sets sets of n_out phases; the
// split loader's: n_sets sets of 4 parity phases for its one output slot).
template <typename Tag, bool SPLIT>
cudaError_t launch_cot_operand(const GLoad<__nv_bfloat16, SPLIT>& gl, const CombRows& comb,
                               __nv_bfloat16* out, int B, int n_sets, cudaStream_t stream) {
  const int ntot = n_sets * gl.cout;
  const long long rows = (long long)B * (gl.n_out * gl.M + comb.n) + 1;
  const long long total = rows * (operand_width(ntot) / 8);
  int vec = gl.cout % 8 == 0;
  for (int i = 0; i < n_sets * (SPLIT ? 4 : gl.n_out); ++i)
    vec = vec && aligned16(gl.g[i]) && (gl.y[i] == nullptr || aligned16(gl.y[i]));
  cot_operand_pass<Tag, SPLIT><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      gl, comb, out, B, ntot, vec, total);
  return cudaGetLastError();
}

// The written operand's cotangent rows as gn::colsum reads g (row q <
// n_out * M of sample b, column n): Σg_eff of a, c and f from the values the
// pass folded once, in launch_gsum's order.
struct CotRowsG {
  const __nv_bfloat16* rows;
  int M, n_out, cout, per_b, ldk;
  __device__ __forceinline__ float operator()(int b, int q, int n) const {
    return to_f(rows[((size_t)b * per_b + q) * ldk + n]);
  }
};

// Tags of the grid convs' instantiations (operand pass, forward GEMM, dtaps
// GEMM, dx pass and GEMM): a profile tells the phase conv's launches (a, b)
// from the standard conv's (f) and the phase chain's stride-2 conv's (m's
// forward, dx and dtaps) by them; the code is one. MergedPhase, MergedUp
// and MergedStd tag the merged backwards' passes and GEMMs (i, j, k).
struct PhaseGrid {};
struct StdGrid {};
struct SplitGrid {};
struct MergedPhase {};
struct MergedUp {};
struct MergedStd {};

// The operand's row loader of the GEMMs: rows of a built operand named by
// the conv table of output phase p, tap t and cell m.
struct OperandRows {
  const __nv_bfloat16* rows;
  const int* table;  // (4, 7, M) halo.phase_conv_table, or (7, M) halo.std_conv_table
  int M, ldk, per_b, zero_row;  // M: the table's cells a phase (the GEMM's rows a slot)

  __device__ __forceinline__ int code(int p, int t, int m) const {
    return __ldg(&table[(p * 7 + t) * M + m]);
  }
  // a cell, the sample's two pole rows after its cells, or the zero row
  __device__ __forceinline__ const __nv_bfloat16* row(int b, int code) const {
    const long long base = (long long)b * per_b;
    const long long r = code >= 0 ? base + code
                        : code == ZERO ? (long long)zero_row
                        : base + per_b - 2 + (code == NORTH ? 0 : 1);
    return rows + r * ldk;
  }
};

// The operand's row loader over `operand`: per sample the n_src * hw5 cells
// of its sources and 2 pole rows, then the zero row; the table names M
// output cells a phase. hw5 = M but for the standard conv at stride 2, whose
// one (5, h, w) input grid has 4 M cells.
inline OperandRows operand_rows(const __nv_bfloat16* operand, const int* table, int B, int M,
                                int cin, int n_src, int hw5) {
  OperandRows ld;
  ld.rows = operand;
  ld.table = table;
  ld.M = M;
  ld.ldk = operand_width(cin);
  ld.per_b = operand_per_sample(hw5, n_src);
  ld.zero_row = B * ld.per_b;
  return ld;
}

namespace mma {

// one pipeline step of both GEMMs: 32 rows q (dtaps), 32 channels k (forward)
constexpr int BK = 32;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8x8 b16 matrices: lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// four 8x8 b16 matrices, transposed: lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where a load row stands: q = b * n_out * M + slot * M + m, over n_out
// output phase slots (the up convs' 4; a grid conv's 4, or 1 for the
// stride-2 phase conv's phase 2 and for the standard conv).
struct RowPos {
  int q, b, slot, m;
  __device__ __forceinline__ void start(int q0, int M, int n_out = 4) {
    q = q0;
    b = q0 / (n_out * M);
    const int r = q0 - b * n_out * M;
    slot = r / M;
    m = r - slot * M;
  }
  __device__ __forceinline__ void advance(int M, int n_out = 4) {
    q += BK;
    m += BK;
    while (m >= M) {
      m -= M;
      if (++slot == n_out) {
        slot = 0;
        ++b;
      }
    }
  }
};

}  // namespace mma

}  // namespace gn
