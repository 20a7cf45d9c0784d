// Decoder tail: the last UpBlock's residual join, the 1x1 head and tanh, per
// cell of each of the 4 level-s phases:
//   t   = relu(b0 * mul1 + add1 + y10 * mul2 + add2)    (float32, cast to T)
//   v   = tanh(float(T(t @ W + bias)))                  (float32)
// its backward, and the same tail fused with the AE's position loss.
//
// gn_pair_head_fwd writes v (the serving path and the VAE's training
// forward; the caller interleaves the four F-channel outputs). Replaces
// geniconet_tpu/ops/pallas/phase_kernel.py:_phead (kernel body
// _phead_fwd_kernel), fused_pair_head.
//
// gn_pair_head_bwd is its backward for given float32 cotangents g of the 4
// output phases: it recomputes v and writes the 8 phase cotangents, dW,
// dbias and the affine gradients. Replaces phase_kernel.py:_phead_bwd
// (_phead_bwd_kernel), the VAE's training loss (and the AE's whenever its
// loss has normal or Laplacian terms).
//
// gn_pair_head_mse_fwd writes the per-sample squared-error sum of v against
// the packed target, grid cells and the two pole vertices (each the mean
// over the 5 charts of phase 0 cell (0, 0) / phase 3 cell (h-1, w-1)), and
// never writes v. gn_pair_head_mse_bwd is its backward: the same pass as
// gn_pair_head_bwd with the cotangent of v formed from the target.
// Replace phase_kernel.py:_phmse (_phmse_fwd_kernel) and :_phmse_bwd
// (_phmse_bwd_kernel), fused_pair_head_mse, the AE training loss.
//
// What bounds them on the card: memory. Each reads 8 tensors of C=64
// channels per cell (the backward also writes 8) against 2 * 64 * 3 FLOPs
// per cell and phase (about four times that backward), far below the
// card's compute-to-bandwidth ratio. So every kernel reads each input once
// from device memory, 16 bytes a lane, and keeps the joined tensor in
// registers. All of them run one cell routine (load_cell, cell_v): a group
// of lanes holds a cell's channels (8 lanes x 8 bf16 or 16 lanes x 4
// float32 at C = 64), loads b0 and y10 of its phases with every load in
// flight together, joins them, sums z = t @ W as each lane's FMA chain over
// its channels and a butterfly of shuffles inside the group, and forms v.
// The order of that sum depends on the group's width alone, so a cell's v
// has the same bits in the forward, the MSE forward, the pole pass and the
// backward's recompute (in bf16 too, where z rounds before tanh).
// * forward (pair_head_kernel): one group a cell and its 4 phases, a
//   channel's affines and W row read from shared memory once for the 4
//   (read for each phase, the time was 1.4x), v's float f written by the
//   group's lane f mod L (a warp's cells are contiguous). Where that gives
//   fewer blocks than 2 an SM (a B=1 decode: 2,560 cells), a group takes
//   one (cell, phase), 4x the blocks.
// * MSE forward (phmse_fwd_kernel): a block sums HEAD_MSE_CELLS cells of one
//   sample over their 4 phases, tpack's 4F-float row of a cell read once;
//   the lanes' sums merge by shuffles, then the warps in order through
//   shared memory, into one partial a block; phmse_poles_kernel adds a
//   sample's partials in order and the two poles' errors. No atomics.
// * pole pass (phmse_poles_kernel, the MSE forward's and h's): 10 groups
//   recompute the 10 pole cells; one thread forms each pole's mean.
// * backward (head_bwd_body, shared by both backward kernels e and h): it
//   moves b0 and y10 in and their 8 cotangents out (193 MB at the s=5
//   head, B=36: 0.058 ms at 3.35 TB/s) against about 2 * 64 * 13 FLOPs a
//   cell and phase, so it is bound by bytes. A group takes all 4 phases of
//   a cell: after cell_v, dz and each channel's dt stay in registers,
//   and db0/dy10 are written once in 16-byte stores; for h tpack's row of
//   the cell is read once, and the pole cotangents come from
//   phmse_poles_kernel first. dW, dbias, d_mul1, d_add1, d_mul2 accumulate
//   in each lane's registers over a grid-stride loop of a fixed grid
//   (head_bwd_blocks: 2 blocks an SM), merge in a fixed order (shuffles
//   across the groups of a warp, the warps in turn through shared memory)
//   into one partial row a block, and gn::sum_rows adds the rows in a fixed
//   order: no atomics, so the results repeat exactly. A head over 256
//   channels takes the wide body (head_bwd_wide_body): rounds of one chunk a
//   lane, v formed again each round. (A body that read
//   each row twice, first one thread a cell walking its channels, 128 bytes
//   apart across a warp, then coalesced, and wrote a partial row per 256
//   cells and phase, took 11x the byte bound.)
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_F = 8;
constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
// The pole pass: 10 warps, so that 10 groups of up to 32 lanes fit a block.
constexpr int POLE_THREADS = 320;
// Cells of one sample that a block of the MSE forward sums into one partial
// (build.head_mse_parts counts the partials likewise).
constexpr int HEAD_MSE_CELLS = 64;

template <typename T>
struct HeadIn {
  const T* b0[4];
  const T* y10[4];
};

// The head's inputs as every kernel takes them: the 8 phases, the 4 float32
// affines (cin), W (cin, F) and bias (F) of T; L lanes a cell's group
// (head_lanes); vec: 16-byte loads (head_vec).
template <typename T>
struct HeadArgs {
  HeadIn<T> a;
  const float *mul1, *add1, *mul2, *add2;
  const T* W;
  const T* bias;
  int cin, F, L, vec;
};

// ptr[i] for a runtime i, by selects (no copy of the array to local memory).
template <typename P>
__device__ __forceinline__ P pick(const P (&ptr)[4], int i) {
  return i == 0 ? ptr[0] : i == 1 ? ptr[1] : i == 2 ? ptr[2] : ptr[3];
}

// Every head kernel's shared memory: the four affines (4, cin), then W
// (cin, FM) as float32 with zeros past F. No barrier: the caller's follows.
template <typename T, int FM>
__device__ __forceinline__ void stage_head(float* sh, const HeadArgs<T>& h) {
  const int cin = h.cin;
  float* aff = sh;
  float* sw = sh + 4 * cin;
  for (int i = threadIdx.x; i < cin; i += blockDim.x) {
    aff[i] = h.mul1[i];
    aff[cin + i] = h.add1[i];
    aff[2 * cin + i] = h.mul2[i];
    aff[3 * cin + i] = h.add2[i];
  }
  for (int i = threadIdx.x; i < cin * FM; i += blockDim.x) {
    const int k = i / FM, f = i - k * FM;
    sw[i] = f < h.F ? gn::to_f(h.W[k * h.F + f]) : 0.f;
  }
}

// bias as float32 in registers, zeros past F.
template <typename T, int FM>
__device__ __forceinline__ void load_bias(const HeadArgs<T>& h, float (&sb)[FM]) {
#pragma unroll
  for (int f = 0; f < FM; ++f) sb[f] = f < h.F ? gn::to_f(h.bias[f]) : 0.f;
}

// The join's pre-activation for channel k: ((a*mul1 + add1) + b*mul2) + add2,
// each product and sum rounded once (no FMA contraction), as the reference.
__device__ __forceinline__ float join_pre(float a, float b, float mul1, float add1, float mul2,
                                          float add2) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, mul1), add1), __fmul_rn(b, mul2)), add2);
}

// ... with the affines from shared memory, (4, cin).
__device__ __forceinline__ float join_pre(float a, float b, const float* aff, int cin, int k) {
  return join_pre(a, b, aff[k], aff[cin + k], aff[2 * cin + k], aff[3 * cin + k]);
}

// 16 bytes of a row: VEC channels of T.
template <typename T>
struct Vec16 {
  static constexpr int VEC = 16 / sizeof(T);
};

// VEC channels k0 .. k0 + VEC - 1 of a row of T, as they are: one 16-byte
// load (vec), or channel by channel with zeros past cin.
template <typename T>
__device__ __forceinline__ void load_vec(const T* row, int k0, int cin, bool vec,
                                         T (&v)[Vec16<T>::VEC]) {
  constexpr int VEC = Vec16<T>::VEC;
  if (vec) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(row + k0);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = k0 + e < cin ? row[k0 + e] : gn::from_f<T>(0.f);
  }
}

// ... and the VEC values v rounded to T, written likewise.
template <typename T>
__device__ __forceinline__ void store_vec(T* row, int k0, int cin, bool vec,
                                          const float (&v)[Vec16<T>::VEC]) {
  constexpr int VEC = Vec16<T>::VEC;
  alignas(16) T t[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) t[e] = gn::from_f<T>(v[e]);
  if (vec) {
    *reinterpret_cast<uint4*>(row + k0) = *reinterpret_cast<const uint4*>(t);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (k0 + e < cin) row[k0 + e] = t[e];
  }
}

// A cell's rows as one lane of its group holds them: b0 and y10 of NP
// phases, CPL chunks of VEC channels.
template <typename T, int NP, int CPL>
struct CellRows {
  alignas(16) T a[NP][CPL][Vec16<T>::VEC];
  alignas(16) T b[NP][CPL][Vec16<T>::VEC];
};

// The cell routine of every head kernel, in two steps. Cell q (live: q is
// a cell) is held by a group of L lanes (L a power of two, at most 32; this
// lane is lig of it), lane lig taking the VEC-channel chunks lig, lig + L,
// ... in rounds of CPL chunks (the backward holds a cell in one round, a
// forward walks one chunk a round).
// load_cell: round r's chunks lig + (r CPL + c) L of b0 and y10 in NP
// phases from p0 (4 from 0, or one), 16 bytes a lane, all loads in flight
// together; zeros past the cell's chunks and for a cell that is not live.
template <typename T, int NP, int CPL>
__device__ __forceinline__ void load_cell(const HeadIn<T>& in, long long q, int p0, int r,
                                          bool live, int lig, int L, int cin, bool vec,
                                          CellRows<T, NP, CPL>& x) {
  constexpr int VEC = Vec16<T>::VEC;
  const int nchunk = (cin + VEC - 1) / VEC;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = lig + (r * CPL + c) * L;
#pragma unroll
      for (int e = 0; e < VEC; ++e) x.a[p][c][e] = x.b[p][c][e] = gn::from_f<T>(0.f);
      if (live && j < nchunk) {
        load_vec<T>(pick(in.b0, p0 + p) + q * cin, j * VEC, cin, vec, x.a[p][c]);
        load_vec<T>(pick(in.y10, p0 + p) + q * cin, j * VEC, cin, vec, x.b[p][c]);
      }
    }
}

// cell_v: adds the join of round r's channels in each of the NP phases
// (join_pre, its relu and its T-rounding: the reference's roundings, no FMA
// contraction) times W to z[p] as this lane's FMA chain over its channels in
// order. A channel's affines and W row (aff and sw, from shared memory in
// stage_head's layout) are read once for all NP phases. In the last round,
// then a butterfly of shuffles inside the group (every lane of it gets the
// same bits; every lane of the warp must be here) and v = tanh(float(T(z +
// bias))) in place, zeros past F. The sum's order depends on L alone, so v
// has the same bits in every head kernel.
template <typename T, int NP, int CPL, int FM>
__device__ __forceinline__ void cell_v(const CellRows<T, NP, CPL>& x, const float* aff,
                                       const float* sw, const float (&sb)[FM], int lig, int L,
                                       int r, int cin, int F, bool last, float (&z)[NP][FM]) {
  constexpr int VEC = Vec16<T>::VEC;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int k0 = (lig + (r * CPL + c) * L) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int k = k0 + e;
      if (k >= cin) continue;
      const float m1 = aff[k], a1 = aff[cin + k], m2 = aff[2 * cin + k], a2 = aff[3 * cin + k];
      float w[FM];
#pragma unroll
      for (int f = 0; f < FM; ++f) w[f] = sw[k * FM + f];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float pre =
            join_pre(gn::to_f(x.a[p][c][e]), gn::to_f(x.b[p][c][e]), m1, a1, m2, a2);
        const float t = gn::round_to<T>(fmaxf(pre, 0.f));
#pragma unroll
        for (int f = 0; f < FM; ++f) z[p][f] = fmaf(t, w[f], z[p][f]);
      }
    }
  }
  if (!last) return;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int f = 0; f < FM; ++f) {
      for (int o = 1; o < L; o <<= 1) z[p][f] += __shfl_xor_sync(0xffffffffu, z[p][f], o);
      z[p][f] = f < F ? tanhf(gn::round_to<T>(z[p][f] + sb[f])) : 0.f;
    }
}

// The forwards' and the pole pass's cell: v of cell q in NP phases from
// p0, one chunk a lane a round (load_cell, then cell_v); ready() runs once
// the first round's loads are issued (a kernel stages its shared memory and
// waits there).
template <typename T, int NP, int FM, typename Ready>
__device__ __forceinline__ void head_cell(const HeadIn<T>& in, long long q, int p0, bool live,
                                          const float* aff, const float* sw,
                                          const float (&sb)[FM], int lig, int L, int cin, int F,
                                          bool vec, Ready ready, float (&v)[NP][FM]) {
  const int rounds = ((cin + Vec16<T>::VEC - 1) / Vec16<T>::VEC + L - 1) / L;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int f = 0; f < FM; ++f) v[p][f] = 0.f;
  for (int r = 0; r < rounds; ++r) {
    CellRows<T, NP, 1> x;
    load_cell<T, NP, 1>(in, q, p0, r, live, lig, L, cin, vec, x);
    if (r == 0) ready();
    cell_v<T, NP, 1, FM>(x, aff, sw, sb, lig, L, r, cin, F, r + 1 == rounds, v);
  }
}

// This lane's place: its group's lane lig, its group grp of the warp's gpw.
struct Lane {
  int lane, warp, lig, grp, gpw;
  __device__ __forceinline__ explicit Lane(int L)
      : lane(threadIdx.x & 31), warp(threadIdx.x >> 5), lig(lane & (L - 1)), grp(lane / L),
        gpw(32 / L) {}
};

struct HeadOut {
  float* out[4];
};

// Forward of the head (_phead): group g of the grid takes cell q = g, in
// all 4 phases (NP 4, grid (cells, 1)) or in phase blockIdx.y (NP 1, grid
// (cells, 4)); lane lig of the group writes v's floats f = lig, lig + L, ...
// of a phase (one float a lane where L >= F).
// Both forwards hold 3 blocks an SM (at most 85 registers a thread; bf16 at
// C 64 spills 56 bytes): on an H100 SXM at 700 W, bf16 B=16, 0.027 ms where
// 2 blocks an SM took 0.028 and 4 blocks 0.029 (scripts/torch_kernel_times.py).
template <typename T, int NP, int FM>
__global__ void __launch_bounds__(THREADS, 3)
pair_head_kernel(HeadArgs<T> h, HeadOut o, long long Q) {
  extern __shared__ float sh[];
  const Lane ln(h.L);
  const long long q = ((long long)blockIdx.x * NW + ln.warp) * ln.gpw + ln.grp;
  const int p0 = NP == 4 ? 0 : (int)blockIdx.y;
  const bool live = q < Q;
  float sb[FM];
  load_bias(h, sb);
  float v[NP][FM];
  head_cell<T, NP, FM>(h.a, q, p0, live, sh, sh + 4 * h.cin, sb, ln.lig, h.L, h.cin, h.F,
                       h.vec != 0,
                       [&] {
                         stage_head<T, FM>(sh, h);
                         __syncthreads();
                       },
                       v);
  if (!live) return;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float* dst = pick(o.out, p0 + p) + q * h.F;
#pragma unroll
    for (int f = 0; f < FM; ++f)
      if (f < h.F && (f & (h.L - 1)) == ln.lig) dst[f] = v[p][f];
  }
}

// Forward of the head+MSE, first pass: block (x, b) takes cells
// [x, x + 1) * HEAD_MSE_CELLS of sample b, a group a cell over the 4
// phases; the group's first lane adds the cell's squared errors against
// tpack (B, M, 4F) float32 to its sum, the warp merges its lanes by a
// butterfly and the block its warps in order: part[b][x].
template <typename T, int FM>
__global__ void __launch_bounds__(THREADS, 3)
phmse_fwd_kernel(HeadArgs<T> h, const float* __restrict__ tpack, int M,
                 float* __restrict__ part) {
  extern __shared__ float sh[];
  __shared__ float red[NW];
  const Lane ln(h.L);
  const int b = blockIdx.y, F = h.F;
  const int m_begin = blockIdx.x * HEAD_MSE_CELLS;
  const int m_end = min(M, m_begin + HEAD_MSE_CELLS);
  float sb[FM];
  load_bias(h, sb);
  float acc = 0.f;
  for (int m0 = m_begin; m0 < m_end; m0 += NW * ln.gpw) {
    const int m = m0 + ln.warp * ln.gpw + ln.grp;
    const bool live = m < m_end;
    const long long q = (long long)b * M + m;
    float v[4][FM];
    head_cell<T, 4, FM>(h.a, q, 0, live, sh, sh + 4 * h.cin, sb, ln.lig, h.L, h.cin, F,
                        h.vec != 0,
                        [&] {
                          if (m0 != m_begin) return;
                          stage_head<T, FM>(sh, h);
                          __syncthreads();
                        },
                        v);
    if (live && ln.lig == 0) {
      const float* tp = tpack + q * 4 * F;
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int f = 0; f < FM; ++f) {
          if (f >= F) continue;
          const float d = v[p][f] - tp[p * F + f];
          acc = fmaf(d, d, acc);
        }
    }
  }
  for (int o = 1; o < 32; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (ln.lane == 0) red[ln.warp] = acc;
  __syncthreads();
  if (threadIdx.x != 0) return;
  float s = red[0];
  for (int w = 1; w < NW; ++w) s += red[w];
  part[(size_t)b * gridDim.x + blockIdx.x] = s;
}

// The pole pass, one block of POLE_THREADS per sample b. Groups 0-9 recompute
// v at the 10 pole cells (north: phase 0, cell (0, 0) of each chart; south:
// phase 3, cell (h-1, w-1)) with head_cell; then thread 0 forms each pole's
// mean (5-chart sum in order, times 0.2) against tpoles (B, 2F) and either
// * g == null (forward): sse[b] = the n_part partials of phmse_fwd_kernel
//   summed in order + both poles' squared errors; or
// * g != null (backward): dpole[b][pole][f] = ((2 g[b]) (mean - target)) 0.2,
//   the cotangent each of the pole's 5 cells receives.
template <typename T, int FM>
__global__ void __launch_bounds__(POLE_THREADS)
phmse_poles_kernel(HeadArgs<T> h, const float* __restrict__ tpoles,
                   const float* __restrict__ part, int n_part, const float* __restrict__ g,
                   int M, int hw, float* __restrict__ out) {
  extern __shared__ float sh[];
  __shared__ float pv[10][MAX_F];
  const Lane ln(h.L);
  const int b = blockIdx.x, F = h.F;
  const int cell = ln.warp * ln.gpw + ln.grp;  // the pole cell of this group
  const bool live = cell < 10;
  const int pole = cell >= 5, c = cell - 5 * pole;
  const long long q = live ? (long long)b * M + c * hw + (pole ? hw - 1 : 0) : 0;
  float sb[FM];
  load_bias(h, sb);
  float v[1][FM];
  head_cell<T, 1, FM>(h.a, q, pole ? 3 : 0, live, sh, sh + 4 * h.cin, sb, ln.lig, h.L, h.cin, F,
                      h.vec != 0,
                      [&] {
                        stage_head<T, FM>(sh, h);
                        __syncthreads();
                      },
                      v);
  if (live && ln.lig == 0)
#pragma unroll
    for (int f = 0; f < FM; ++f)
      if (f < F) pv[cell][f] = v[0][f];
  __syncthreads();
  if (threadIdx.x != 0) return;
  float s = 0.f;
  if (g == nullptr)
    for (int i = 0; i < n_part; ++i) s += part[(size_t)b * n_part + i];
  for (int pl = 0; pl < 2; ++pl) {
    for (int f = 0; f < F; ++f) {
      float mean = 0.f;
      for (int ch = 0; ch < 5; ++ch) mean += pv[pl * 5 + ch][f];
      const float d = mean * 0.2f - tpoles[(size_t)b * 2 * F + pl * F + f];
      if (g == nullptr)
        s = fmaf(d, d, s);
      else
        out[((size_t)b * 2 + pl) * F + f] = 2.f * g[b] * d * 0.2f;
    }
  }
  if (g == nullptr) out[b] = s;
}

template <typename T>
struct HeadGrad {
  T* db0[4];
  T* dy10[4];
};

// Where the backward's dv comes from: the given float32 cotangents g of the
// 4 output phases (gph, kernel e), or 2 g[b] (v - tpack) plus the pole
// cotangents dpole (kernel h).
struct DvSource {
  const float* gph[4];
  const float* tpack;
  const float* g;
  const float* dpole;
};

// The backward's work split (build.head_bwd_blocks says the same): a grid
// of at most HEAD_BWD_BLOCKS blocks (2 for each of the H100's 132 SMs), and
// at most one for each HEAD_CELLS_A_BLOCK cells (a bf16 block's step at C
// 64), walks the B * 5hw cells in a grid-stride loop; one partial row a
// block.
constexpr int HEAD_BWD_BLOCKS = 264;
constexpr int HEAD_CELLS_A_BLOCK = 32;
int head_bwd_blocks(long long Q) {
  const long long want = (Q + HEAD_CELLS_A_BLOCK - 1) / HEAD_CELLS_A_BLOCK;
  return (int)(want < 1 ? 1 : want > HEAD_BWD_BLOCKS ? HEAD_BWD_BLOCKS : want);
}

// The backward's arguments, as its launchers pass them on.
template <typename T>
struct HeadBwdArgs {
  HeadArgs<T> h;
  HeadGrad<T> d;
  DvSource src;
  int Q, M, hw;
  float* part;
};

// Backward main pass (kernels e and h). Each group walks cells q = (sample,
// cell) in a grid-stride loop (warp by warp, so every lane of a warp reaches
// the shuffles) and loads all 4 phases of its cell in one round
// (load_cell, CPL chunks a lane, a template constant; the rows stay in
// registers). Then, per phase, v from cell_v and:
// * dv (the given g, or 2 g_b (v - target) plus the pole cotangent),
//   dz = dv (1 - v^2) (head_dz);
// * per channel dt = sum_f dz_f W[k, f] (FMA in f order), the relu mask,
//   db0/dy10 rounded to T and written once, 16 bytes a lane; dW, d_mul1,
//   d_add1, d_mul2 (and dbias, the sum of dz) accumulate in registers
//   (head_chunk_grads).
// For h all four phases of a cell are one group's, so tpack's 4F-float row
// is read once, contiguously. At the end the groups of a warp merge by a
// butterfly of shuffles, the 8 warps in order through one shared row, and
// the block writes that row: [dW (cin*F) | dbias (F) | d_mul1 (cin) |
// d_add1 (cin) | d_mul2 (cin)] (head_merge). No atomics: the results repeat
// exactly. W (FM columns, zeros past F) and the affines are read from shared
// memory; 2 blocks an SM (at most 128 registers a thread).
//
// A cell of more than two chunks a lane of a 32-lane group (bf16 over 256
// channels: 8 a chunk, float32 over 256: 4 a chunk; bf16 takes no CPL 2)
// would hold 3 or more chunks of 4 phases
// and their sums in registers (over 255 a thread). head_bwd_wide_body walks
// it in rounds instead: round r takes chunk lig + r L of each lane, with its
// sums in registers (CPL 1), over the whole grid-stride loop, and merges
// them into the row before the next round. Each round forms v of the cell
// again (load_cell and cell_v over all its rounds of chunks, the forwards'
// order, so the same bits), then reads round r's chunk of each phase again
// for its gradients: the cell's b0 and y10 are read once a round and that
// chunk twice (the second time from L1 or L2), each output written once.
// Its kernels take 1 block an SM (up to 255 registers a thread: at 128
// the sums, v and a round's rows of 4 phases spilled 1.4-2.9 KB a thread).
template <typename T, int FM>
struct HeadGrads {
  float dW[Vec16<T>::VEC][FM], dm1[Vec16<T>::VEC], da1[Vec16<T>::VEC], dm2[Vec16<T>::VEC];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < Vec16<T>::VEC; ++e) {
      dm1[e] = da1[e] = dm2[e] = 0.f;
#pragma unroll
      for (int f = 0; f < FM; ++f) dW[e][f] = 0.f;
    }
  }
};

// dz of phase p of cell q (sample b, cell m of it) from its v: zeros for a
// cell past Q and past F.
template <typename T, bool MSE, int FM>
__device__ __forceinline__ void head_dz(const HeadBwdArgs<T>& x, long long q, int b, int m, int p,
                                        bool live, const float (&v)[FM], float (&dz)[FM]) {
  const DvSource& src = x.src;
  const int F = x.h.F;
#pragma unroll
  for (int f = 0; f < FM; ++f) dz[f] = 0.f;
  if (!live) return;
  if constexpr (MSE) {
    const float* tp = src.tpack + q * 4 * F + p * F;
    const float g2 = src.g[b] * 2.f;
    const int corner = m % x.hw;
    const float* pole = nullptr;
    if (p == 0 && corner == 0) pole = src.dpole + (size_t)b * 2 * F;
    if (p == 3 && corner == x.hw - 1) pole = src.dpole + ((size_t)b * 2 + 1) * F;
#pragma unroll
    for (int f = 0; f < FM; ++f) {
      if (f >= F) continue;
      float dv = g2 * (v[f] - tp[f]);
      if (pole) dv += pole[f];
      dz[f] = dv * (1.f - v[f] * v[f]);
    }
  } else {
    const float* gq = src.gph[p] + q * F;
#pragma unroll
    for (int f = 0; f < FM; ++f) {
      if (f >= F) continue;
      dz[f] = gq[f] * (1.f - v[f] * v[f]);
    }
  }
}

// One chunk j of phase p of cell q (its rows xa, xb as loaded): the join
// recomputed (the same bits), db0/dy10 written once, the sums accumulated.
template <typename T, int FM>
__device__ __forceinline__ void head_chunk_grads(const HeadBwdArgs<T>& x, long long q, int p,
                                                 bool live, int j, const float* aff,
                                                 const float* sw, const float (&dz)[FM],
                                                 const T (&xa)[Vec16<T>::VEC],
                                                 const T (&xb)[Vec16<T>::VEC],
                                                 HeadGrads<T, FM>& acc) {
  constexpr int VEC = Vec16<T>::VEC;
  const int cin = x.h.cin, k0 = j * VEC;
  float o0[VEC], o1[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    o0[e] = o1[e] = 0.f;
    const int k = k0 + e;
    if (k >= cin) continue;
    const float xav = gn::to_f(xa[e]), xbv = gn::to_f(xb[e]);
    const float pre = join_pre(xav, xbv, aff, cin, k);
    const float t = gn::round_to<T>(fmaxf(pre, 0.f));
    float dt = 0.f;
#pragma unroll
    for (int f = 0; f < FM; ++f) dt = fmaf(dz[f], sw[k * FM + f], dt);
    const float dm = pre > 0.f ? dt : 0.f;
    o0[e] = dm * aff[k];
    o1[e] = dm * aff[2 * cin + k];
#pragma unroll
    for (int f = 0; f < FM; ++f) acc.dW[e][f] = fmaf(t, dz[f], acc.dW[e][f]);
    acc.dm1[e] = fmaf(dm, xav, acc.dm1[e]);
    acc.da1[e] += dm;
    acc.dm2[e] = fmaf(dm, xbv, acc.dm2[e]);
  }
  if (live && j < (cin + VEC - 1) / VEC) {
    store_vec<T>(x.d.db0[p] + q * cin, k0, cin, x.h.vec != 0, o0);
    store_vec<T>(x.d.dy10[p] + q * cin, k0, cin, x.h.vec != 0, o1);
  }
}

// The groups of a warp in a butterfly, then the warps in order, into the
// block's row row_s: chunk c's sums of this lane at its channels (chunk
// lig + (r CPL + c) L); with db (round 0 only), dbias. Every thread of the
// block calls it.
template <typename T, int CPL, int FM>
__device__ __forceinline__ void head_merge(HeadGrads<T, FM> (&acc)[CPL], float (&db)[FM],
                                           bool with_db, int r, const Lane& ln, int L, int cin,
                                           int F, float* row_s) {
  constexpr int VEC = Vec16<T>::VEC;
  if (with_db)
#pragma unroll
    for (int f = 0; f < FM; ++f)
      for (int o = L; o < 32; o <<= 1) db[f] += __shfl_xor_sync(0xffffffffu, db[f], o);
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      for (int o = L; o < 32; o <<= 1) {
#pragma unroll
        for (int f = 0; f < FM; ++f)
          acc[c].dW[e][f] += __shfl_xor_sync(0xffffffffu, acc[c].dW[e][f], o);
        acc[c].dm1[e] += __shfl_xor_sync(0xffffffffu, acc[c].dm1[e], o);
        acc[c].da1[e] += __shfl_xor_sync(0xffffffffu, acc[c].da1[e], o);
        acc[c].dm2[e] += __shfl_xor_sync(0xffffffffu, acc[c].dm2[e], o);
      }
  for (int w = 0; w < NW; ++w) {
    if (ln.warp == w && ln.grp == 0) {
      auto put = [&](int i, float v) { row_s[i] = w == 0 ? v : row_s[i] + v; };
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int k = (ln.lig + (r * CPL + c) * L) * VEC + e;
          if (k >= cin) continue;
#pragma unroll
          for (int f = 0; f < FM; ++f)
            if (f < F) put(k * F + f, acc[c].dW[e][f]);
          put(cin * F + F + k, acc[c].dm1[e]);
          put(cin * F + F + cin + k, acc[c].da1[e]);
          put(cin * F + F + 2 * cin + k, acc[c].dm2[e]);
        }
      if (with_db && ln.lig == 0)
#pragma unroll
        for (int f = 0; f < FM; ++f)
          if (f < F) put(cin * F + f, db[f]);
    }
    __syncthreads();
  }
}

// The block's shared memory: the affines (4, cin), W (cin, FM), the row.
template <typename T, int FM>
__device__ __forceinline__ float* head_bwd_stage(const HeadArgs<T>& h) {
  extern __shared__ float sh[];
  stage_head<T, FM>(sh, h);
  __syncthreads();
  return sh;
}

template <typename T, bool MSE, int CPL, int FM>
__device__ __forceinline__ void head_bwd_body(const HeadBwdArgs<T>& x) {
  const HeadArgs<T>& h = x.h;
  const int cin = h.cin, F = h.F, L = h.L;
  const bool vec = h.vec != 0;
  float* sh = head_bwd_stage<T, FM>(h);
  const float* aff = sh;              // mul1 | add1 | mul2 | add2, (4, cin)
  const float* sw = sh + 4 * cin;     // W, (cin, FM), zeros past F
  float* row_s = sh + 4 * cin + cin * MAX_F;  // the block's partial row
  const int P = cin * F + F + 3 * cin;

  const Lane ln(L);
  const int lig = ln.lig, grp = ln.grp, gpw = ln.gpw;
  float sb[FM];
  load_bias(h, sb);
  HeadGrads<T, FM> acc[CPL];
  float db[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) db[f] = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c].zero();

  const long long stride = (long long)gridDim.x * NW * gpw;
  for (long long base = ((long long)blockIdx.x * NW + ln.warp) * gpw; base < x.Q;
       base += stride) {
    const long long q = base + grp;
    const bool live = q < x.Q;
    const int b = live ? (int)(q / x.M) : 0;
    const int m = live ? (int)(q - (long long)b * x.M) : 0;
    CellRows<T, 1, CPL> xr[4];  // one a phase: cell_v takes them one by one
#pragma unroll
    for (int p = 0; p < 4; ++p) load_cell<T, 1, CPL>(h.a, q, p, 0, live, lig, L, cin, vec, xr[p]);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float v[1][FM];
#pragma unroll
      for (int f = 0; f < FM; ++f) v[0][f] = 0.f;
      cell_v<T, 1, CPL, FM>(xr[p], aff, sw, sb, lig, L, 0, cin, F, true, v);
      float dz[FM];
      head_dz<T, MSE, FM>(x, q, b, m, p, live, v[0], dz);
#pragma unroll
      for (int f = 0; f < FM; ++f) db[f] += dz[f];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        head_chunk_grads<T, FM>(x, q, p, live, lig + c * L, aff, sw, dz, xr[p].a[0][c],
                                xr[p].b[0][c], acc[c]);
    }
  }
  head_merge<T, CPL, FM>(acc, db, true, 0, ln, L, cin, F, row_s);
  float* row = x.part + (size_t)blockIdx.x * P;
  for (int i = threadIdx.x; i < P; i += THREADS) row[i] = row_s[i];
}

template <typename T, bool MSE, int FM>
__device__ __forceinline__ void head_bwd_wide_body(const HeadBwdArgs<T>& x) {
  constexpr int VEC = Vec16<T>::VEC;
  const HeadArgs<T>& h = x.h;
  const int cin = h.cin, F = h.F, L = h.L;
  const bool vec = h.vec != 0;
  float* sh = head_bwd_stage<T, FM>(h);
  const float* aff = sh;
  const float* sw = sh + 4 * cin;
  float* row_s = sh + 4 * cin + cin * MAX_F;
  const int P = cin * F + F + 3 * cin;
  const int rounds = ((cin + VEC - 1) / VEC + L - 1) / L;

  const Lane ln(L);
  const int lig = ln.lig, grp = ln.grp, gpw = ln.gpw;
  float sb[FM];
  load_bias(h, sb);
  float db[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) db[f] = 0.f;
  const long long stride = (long long)gridDim.x * NW * gpw;
  for (int r = 0; r < rounds; ++r) {
    HeadGrads<T, FM> acc[1];
    acc[0].zero();
    for (long long base = ((long long)blockIdx.x * NW + ln.warp) * gpw; base < x.Q;
         base += stride) {
      const long long q = base + grp;
      const bool live = q < x.Q;
      const int b = live ? (int)(q / x.M) : 0;
      const int m = live ? (int)(q - (long long)b * x.M) : 0;
      float v[4][FM];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int f = 0; f < FM; ++f) v[p][f] = 0.f;
      for (int rr = 0; rr < rounds; ++rr) {
        CellRows<T, 4, 1> xx;
        load_cell<T, 4, 1>(h.a, q, 0, rr, live, lig, L, cin, vec, xx);
        cell_v<T, 4, 1, FM>(xx, aff, sw, sb, lig, L, rr, cin, F, rr + 1 == rounds, v);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float dz[FM];
        head_dz<T, MSE, FM>(x, q, b, m, p, live, v[p], dz);
        if (r == 0)
#pragma unroll
          for (int f = 0; f < FM; ++f) db[f] += dz[f];
        CellRows<T, 1, 1> xr;  // round r's chunk of phase p, read again (from L1 or L2)
        load_cell<T, 1, 1>(h.a, q, p, r, live, lig, L, cin, vec, xr);
        head_chunk_grads<T, FM>(x, q, p, live, lig + r * L, aff, sw, dz, xr.a[0][0], xr.b[0][0],
                                acc[0]);
      }
    }
    head_merge<T, 1, FM>(acc, db, r == 0, r, ln, L, cin, F, row_s);
  }
  float* row = x.part + (size_t)blockIdx.x * P;
  for (int i = threadIdx.x; i < P; i += THREADS) row[i] = row_s[i];
}

// Two kernels (and not one templated kernel) so that a profile names each;
// CPL 0 is the wide body (rounds of one chunk a lane), 1 block an SM.
template <typename T, int CPL, int FM>
__global__ void __launch_bounds__(THREADS, CPL == 0 ? 1 : 2) phead_bwd_kernel(HeadBwdArgs<T> x) {
  if constexpr (CPL == 0)
    head_bwd_wide_body<T, false, FM>(x);
  else
    head_bwd_body<T, false, CPL, FM>(x);
}

template <typename T, int CPL, int FM>
__global__ void __launch_bounds__(THREADS, CPL == 0 ? 1 : 2) phmse_bwd_kernel(HeadBwdArgs<T> x) {
  if constexpr (CPL == 0)
    head_bwd_wide_body<T, true, FM>(x);
  else
    head_bwd_body<T, true, CPL, FM>(x);
}

// Where each column of the backward's partial rows lands; d_add2 = d_add1.
struct HeadGradOut {
  float *dW, *dbias, *dmul1, *dadd1, *dmul2, *dadd2;
  int cin, F;
  __device__ __forceinline__ void operator()(long long c, float v) const {
    const int cf = cin * F;
    if (c < cf) {
      dW[c] = v;
      return;
    }
    if (c < cf + F) {
      dbias[c - cf] = v;
      return;
    }
    const int j = (int)(c - cf - F), r = j / cin, k = j - r * cin;
    if (r == 0) dmul1[k] = v;
    if (r == 1) {
      dadd1[k] = v;
      dadd2[k] = v;
    }
    if (r == 2) dmul2[k] = v;
  }
};

// Lanes a cell's group takes: the VEC-channel chunks of C, rounded up to a
// power of two, at most 32 (then a lane takes several chunks: the backward
// holds CPL = 2 for float32 with C over 128 up to 256, and walks a wider
// cell in rounds, as the forwards do).
template <typename T>
int head_lanes(int cin) {
  const int chunks = (cin + Vec16<T>::VEC - 1) / Vec16<T>::VEC;
  int L = 1;
  while (L < chunks && L < 32) L <<= 1;
  return L;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<size_t>(ptr) & 15) == 0; }

// Whether b0 and y10 are read 16 bytes at a time: C a multiple of VEC and
// every phase 16-byte aligned.
template <typename T>
bool head_vec(const HeadIn<T>& a, int cin) {
  bool vec = cin % Vec16<T>::VEC == 0;
  for (int p = 0; p < 4; ++p) vec = vec && aligned16(a.b0[p]) && aligned16(a.y10[p]);
  return vec;
}

template <typename T>
HeadArgs<T> head_args(void* const* ins, const float* m1, const float* a1, const float* m2,
                      const float* a2, const void* W, const void* bias, int cin, int F) {
  HeadArgs<T> h;
  for (int p = 0; p < 4; ++p) {
    h.a.b0[p] = static_cast<const T*>(ins[p]);
    h.a.y10[p] = static_cast<const T*>(ins[4 + p]);
  }
  h.mul1 = m1;
  h.add1 = a1;
  h.mul2 = m2;
  h.add2 = a2;
  h.W = static_cast<const T*>(W);
  h.bias = static_cast<const T*>(bias);
  h.cin = cin;
  h.F = F;
  h.L = head_lanes<T>(cin);
  h.vec = head_vec(h.a, cin);
  return h;
}

// The forwards' and the pole pass's shared memory: the 4 affines and W with
// FM columns (stage_head).
size_t head_fwd_smem(int cin, int FM) { return sizeof(float) * (4 + FM) * (size_t)cin; }

// Launch kernel k with smem bytes of shared memory, above 48 KB by opting in
// (a refused launch returns its error).
template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The forward: a group a cell and its 4 phases, or, where that gives fewer
// blocks than the backward's grid (2 an SM), a group a (cell, phase).
template <typename T, int FM>
cudaError_t fwd_fm(const HeadArgs<T>& h, const HeadOut& o, long long Q, cudaStream_t stream) {
  const size_t smem = head_fwd_smem(h.cin, FM);
  const long long cells_a_block = (long long)NW * (32 / h.L);
  const unsigned blocks = (unsigned)((Q + cells_a_block - 1) / cells_a_block);
  if (blocks >= (unsigned)HEAD_BWD_BLOCKS)
    return launch(pair_head_kernel<T, 4, FM>, dim3(blocks, 1), THREADS, smem, stream, h, o, Q);
  return launch(pair_head_kernel<T, 1, FM>, dim3(blocks, 4), THREADS, smem, stream, h, o, Q);
}

template <typename T>
cudaError_t fwd(const HeadArgs<T>& h, void* const* outs, long long Q, cudaStream_t stream) {
  HeadOut o;
  for (int p = 0; p < 4; ++p) o.out[p] = static_cast<float*>(outs[p]);
  return h.F <= 3 ? fwd_fm<T, 3>(h, o, Q, stream) : fwd_fm<T, MAX_F>(h, o, Q, stream);
}

// The MSE forward's partials a sample (build.head_mse_parts mirrors it).
int head_mse_parts(int M) { return (M + HEAD_MSE_CELLS - 1) / HEAD_MSE_CELLS; }

// The pole pass (forward: g null, sse into out; backward: dpole into out).
template <typename T, int FM>
cudaError_t poles(const HeadArgs<T>& h, const float* tpoles, const float* part, int n_part,
                  const float* g, int B, int M, int hw, float* out, cudaStream_t stream) {
  return launch(phmse_poles_kernel<T, FM>, dim3(B), POLE_THREADS, head_fwd_smem(h.cin, FM),
                stream, h, tpoles, part, n_part, g, M, hw, out);
}

template <typename T, int FM>
cudaError_t mse_fwd_fm(const HeadArgs<T>& h, const float* tpack, const float* tpoles, float* part,
                       float* sse, int B, int hw, cudaStream_t stream) {
  const int M = 5 * hw, n_part = head_mse_parts(M);
  cudaError_t err = launch(phmse_fwd_kernel<T, FM>, dim3(n_part, B), THREADS,
                           head_fwd_smem(h.cin, FM), stream, h, tpack, M, part);
  if (err != cudaSuccess) return err;
  return poles<T, FM>(h, tpoles, part, n_part, nullptr, B, M, hw, sse, stream);
}

template <typename T>
cudaError_t mse_fwd(const HeadArgs<T>& h, const float* tpack, const float* tpoles, float* part,
                    float* sse, int B, int hw, cudaStream_t stream) {
  return h.F <= 3 ? mse_fwd_fm<T, 3>(h, tpack, tpoles, part, sse, B, hw, stream)
                  : mse_fwd_fm<T, MAX_F>(h, tpack, tpoles, part, sse, B, hw, stream);
}

template <typename T>
HeadGrad<T> head_grad(void* const* grads) {
  HeadGrad<T> d;
  for (int p = 0; p < 4; ++p) {
    d.db0[p] = static_cast<T*>(grads[p]);
    d.dy10[p] = static_cast<T*>(grads[4 + p]);
  }
  return d;
}

// The backward's shared memory: the 4 affines, W (at most MAX_F columns)
// and the block's partial row.
size_t head_bwd_smem(int cin, int F) {
  return sizeof(float) * (4 * cin + cin * MAX_F + cin * F + F + 3 * cin);
}

// One launch of kernel e (MSE false) or h with CPL chunks a lane (0: the
// wide body's rounds), FM columns of W held (3, or MAX_F for F over 3); its
// shared memory above 48 KB by opting in.
template <typename T, bool MSE, int CPL>
cudaError_t launch_head_bwd(int blocks, size_t smem, const HeadBwdArgs<T>& x,
                            cudaStream_t stream) {
  if (x.h.F <= 3)
    return MSE ? launch(phmse_bwd_kernel<T, CPL, 3>, dim3(blocks), THREADS, smem, stream, x)
               : launch(phead_bwd_kernel<T, CPL, 3>, dim3(blocks), THREADS, smem, stream, x);
  return MSE ? launch(phmse_bwd_kernel<T, CPL, MAX_F>, dim3(blocks), THREADS, smem, stream, x)
             : launch(phead_bwd_kernel<T, CPL, MAX_F>, dim3(blocks), THREADS, smem, stream, x);
}

// The backward's main pass (kernel e or h) and the fixed-order sum of its
// partial rows (head_bwd_blocks of them) into dW, dbias and the affine
// gradients. A cell of at most one chunk a lane of a 32-lane group takes CPL
// = 1; a float32 cell of 129-256 channels CPL = 2; a wider one (bf16 over
// 256, float32 over 256) the wide body. Any C whose shared memory fits
// (head_bwd_smem: 72 bytes a channel at F 3, so C 3228 at the H100's 227
// KB); past that the launch is refused and the error returned.
// db0/dy10 move 16 bytes at a time where the inputs do and every cotangent
// phase is 16-byte aligned.
template <typename T, bool MSE>
cudaError_t head_bwd(HeadArgs<T> h, const HeadGrad<T>& d, const DvSource& src, float* part,
                     float* dW, float* dbias, float* dm1, float* da1, float* dm2, float* da2,
                     int B, int hw, cudaStream_t stream) {
  const int M = 5 * hw, Q = B * M, cin = h.cin;
  const size_t smem = head_bwd_smem(cin, h.F);
  for (int p = 0; p < 4; ++p) h.vec = h.vec && aligned16(d.db0[p]) && aligned16(d.dy10[p]);
  const HeadBwdArgs<T> x = {h, d, src, Q, M, hw, part};
  const int blocks = head_bwd_blocks(Q);
  constexpr int LANE_CHANNELS = 32 * Vec16<T>::VEC;  // one chunk for each lane of 32
  cudaError_t err;
  if (cin <= LANE_CHANNELS)
    err = launch_head_bwd<T, MSE, 1>(blocks, smem, x, stream);
  else if constexpr (std::is_same_v<T, float>)
    err = cin <= 2 * LANE_CHANNELS ? launch_head_bwd<T, MSE, 2>(blocks, smem, x, stream)
                                   : launch_head_bwd<T, MSE, 0>(blocks, smem, x, stream);
  else
    err = launch_head_bwd<T, MSE, 0>(blocks, smem, x, stream);
  if (err != cudaSuccess) return err;
  HeadGradOut st = {dW, dbias, dm1, da1, dm2, da2, cin, h.F};
  return gn::launch_sum_rows(part, blocks, (long long)cin * h.F + h.F + 3LL * cin, st, stream);
}

template <typename T>
cudaError_t pair_bwd(void* const* gph, const HeadArgs<T>& h, void* const* grads, float* part,
                     float* dW, float* dbias, float* dm1, float* da1, float* dm2, float* da2,
                     int B, int hw, cudaStream_t stream) {
  DvSource src = {};
  for (int p = 0; p < 4; ++p) src.gph[p] = static_cast<const float*>(gph[p]);
  return head_bwd<T, false>(h, head_grad<T>(grads), src, part, dW, dbias, dm1, da1, dm2, da2, B,
                            hw, stream);
}

template <typename T>
cudaError_t mse_bwd(const float* g, const HeadArgs<T>& h, const float* tpack, const float* tpoles,
                    void* const* grads, float* dpole, float* part, float* dW, float* dbias,
                    float* dm1, float* da1, float* dm2, float* da2, int B, int hw,
                    cudaStream_t stream) {
  const cudaError_t err =
      h.F <= 3 ? poles<T, 3>(h, tpoles, nullptr, 0, g, B, 5 * hw, hw, dpole, stream)
               : poles<T, MAX_F>(h, tpoles, nullptr, 0, g, B, 5 * hw, hw, dpole, stream);
  if (err != cudaSuccess) return err;
  DvSource src = {{nullptr, nullptr, nullptr, nullptr}, tpack, g, dpole};
  return head_bwd<T, true>(h, head_grad<T>(grads), src, part, dW, dbias, dm1, da1, dm2, da2, B,
                           hw, stream);
}

}  // namespace

// ins: host array of 8 pointers, the 4 b0 phases then the 4 y10 phases,
// each (B, 5, h, w, cin) of T; mul1/add1/mul2/add2: float32 (cin); W: (cin, F)
// of T; bias: (F) of T; outs: host array of 4 float32 (B, 5, h, w, F).
// Any cin whose head (the 4 affines and W) fits a block's shared memory.
// dtype: 0 float32, 1 bfloat16.
extern "C" int gn_pair_head_fwd(void* const* ins, const float* mul1, const float* add1,
                                const float* mul2, const float* add2, const void* W,
                                const void* bias, void* const* outs, int B, int h, int w, int cin,
                                int F, int dtype, void* stream) {
  if (F < 1 || F > MAX_F || cin < 1) return cudaErrorInvalidValue;
  const long long Q = (long long)B * 5 * h * w;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(head_args<float>(ins, mul1, add1, mul2, add2, W, bias, cin, F), outs, Q, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(
        head_args<__nv_bfloat16>(ins, mul1, add1, mul2, add2, W, bias, cin, F), outs, Q, s);
  return cudaErrorInvalidValue;
}

// ins, mul1..add2, W, bias: as gn_pair_head_fwd; tpack: float32
// (B, 5, h, w, 4F), phase p's target at [pF, pF + F); tpoles: float32 (B, 2F),
// [north | south]; part: float32 scratch of (B, ceil(5hw/64)) (head_mse_parts);
// sse: float32 (B) per-sample squared-error sum. Any cin whose head fits a
// block's shared memory, as gn_pair_head_fwd. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_pair_head_mse_fwd(void* const* ins, const float* mul1, const float* add1,
                                    const float* mul2, const float* add2, const void* W,
                                    const void* bias, const float* tpack, const float* tpoles,
                                    float* part, float* sse, int B, int h, int w, int cin, int F,
                                    int dtype, void* stream) {
  if (F < 1 || F > MAX_F || cin < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mse_fwd<float>(head_args<float>(ins, mul1, add1, mul2, add2, W, bias, cin, F), tpack,
                          tpoles, part, sse, B, h * w, s);
  if (dtype == 1)
    return mse_fwd<__nv_bfloat16>(
        head_args<__nv_bfloat16>(ins, mul1, add1, mul2, add2, W, bias, cin, F), tpack, tpoles,
        part, sse, B, h * w, s);
  return cudaErrorInvalidValue;
}

// gph: host array of 4 float32 (B, 5, h, w, F), the cotangents of
// gn_pair_head_fwd's outputs; ins, mul1..add2, W, bias: as gn_pair_head_fwd;
// grads: host array of 8 outputs (the b0 then the y10 phase cotangents, T);
// part: float32 scratch of (head_bwd_blocks(B * 5hw), cin*F + F + 3*cin); dW
// (cin, F), dbias (F), dmul1, dadd1, dmul2, dadd2 (cin): float32 outputs.
// Any cin whose shared memory fits (head_bwd). dtype: 0 float32, 1 bfloat16.
extern "C" int gn_pair_head_bwd(void* const* gph, void* const* ins, const float* mul1,
                                const float* add1, const float* mul2, const float* add2,
                                const void* W, const void* bias, void* const* grads, float* part,
                                float* dW, float* dbias, float* dmul1, float* dadd1, float* dmul2,
                                float* dadd2, int B, int h, int w, int cin, int F, int dtype,
                                void* stream) {
  if (F < 1 || F > MAX_F || cin < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pair_bwd<float>(gph, head_args<float>(ins, mul1, add1, mul2, add2, W, bias, cin, F),
                           grads, part, dW, dbias, dmul1, dadd1, dmul2, dadd2, B, h * w, s);
  if (dtype == 1)
    return pair_bwd<__nv_bfloat16>(
        gph, head_args<__nv_bfloat16>(ins, mul1, add1, mul2, add2, W, bias, cin, F), grads, part,
        dW, dbias, dmul1, dadd1, dmul2, dadd2, B, h * w, s);
  return cudaErrorInvalidValue;
}

// g: float32 (B) cotangent of sse; ins .. tpoles: as gn_pair_head_mse_fwd;
// grads: host array of 8 outputs (the b0 then the y10 phase cotangents, T);
// dpole: float32 scratch (B, 2, F); part: float32 scratch of
// (head_bwd_blocks(B * 5hw), cin*F + F + 3*cin); dW (cin, F), dbias (F), dmul1,
// dadd1, dmul2, dadd2 (cin): float32 outputs. Any cin whose shared memory
// fits (head_bwd). dtype: 0 float32, 1 bfloat16.
extern "C" int gn_pair_head_mse_bwd(const float* g, void* const* ins, const float* mul1,
                                    const float* add1, const float* mul2, const float* add2,
                                    const void* W, const void* bias, const float* tpack,
                                    const float* tpoles, void* const* grads, float* dpole,
                                    float* part, float* dW, float* dbias, float* dmul1,
                                    float* dadd1, float* dmul2, float* dadd2, int B, int h, int w,
                                    int cin, int F, int dtype, void* stream) {
  if (F < 1 || F > MAX_F || cin < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mse_bwd<float>(g, head_args<float>(ins, mul1, add1, mul2, add2, W, bias, cin, F), tpack,
                          tpoles, grads, dpole, part, dW, dbias, dmul1, dadd1, dmul2, dadd2, B,
                          h * w, s);
  if (dtype == 1)
    return mse_bwd<__nv_bfloat16>(
        g, head_args<__nv_bfloat16>(ins, mul1, add1, mul2, add2, W, bias, cin, F), tpack, tpoles,
        grads, dpole, part, dW, dbias, dmul1, dadd1, dmul2, dadd2, B, h * w, s);
  return cudaErrorInvalidValue;
}
