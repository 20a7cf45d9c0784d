// The decoder's phase chain (kernel n): an UpBlock's upsample + both first
// convs whose level-s input is the previous UpBlock's residual tail, given
// as its raw phase pair (b0, y10) and four pending BatchNorm affines; and
// the two backward kernels, dx (into the pair's 8 phase cotangents and the
// 4 affine gradients) and dtaps.
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_updp (pallas_call at
// :2380, kernel body _up_pair_fwd_kernel) and the two pallas_calls of
// :_updp_bwd, dx at :2458 (_up_pair_dx_kernel) and dtaps at :2490
// (_up_pair_dtaps_kernel): the custom VJP of fused_up_dual_conv_pair, with
// the optional BatchNorm [sum, sumsq] stats, the in-kernel stats fold and
// the Σg_eff bias gradient.
//
// Design. The Pallas kernels join each phase relu(b0·mul1 + add1 +
// y10·mul2 + add2) in float32, cast it, interleave the four phases into the
// level-s grid in VMEM (_interleave4), and then run the up conv's bodies.
// Here nothing is interleaved: the up conv's loader gn::UpLoad reads its
// level-s cells through gn::PairCells, which joins b0 and y10 at the phase
// and row that gn::split_row maps the grid cell to (the pole means are of
// joined cells, as in the reference). The forward and the dtaps run the up
// conv's GEMMs: in float32 over that loader (gn::conv_gemm, gn::dtaps_gemm);
// in bf16 the pair is joined once into a level-s grid (gn::pair_join_pass),
// the operand pass builds the upsampled operand from it, and the
// tensor-core GEMMs run over its rows (gn::mma_conv, mma_conv_fwd.cuh;
// gn::mma_dtaps, mma_dtaps.cuh). Either way the outputs, stats and dtaps
// equal up_dual_conv_fwd / up_dual_conv_dtaps on phase_merge(join) bit for
// bit. dx needs the up conv's level-s dx unrounded, then the tail's adjoint:
// dpre = dx * 1{pair_pre(b0, y10) > 0} against the raw pair in float32, the
// 8 phase cotangents db0 = dpre * mul1 and dy10 = dpre * mul2 rounded once
// and stored by split_row, and three column sums (d_mul1, d_add1 = d_add2,
// d_mul2) through block partials and one fixed-order gn::sum_rows. In bf16
// it is c's route (up_conv_bwd.cu) with that tail in its last pass: c's
// cotangent pass writes g_eff once with the combined rows of all 4 output
// phases, c's tensor-core dx GEMM (gn::mma_conv with DuEpi) writes float32
// dU of the 4 upsampled phases, and pair_adjoint_pass gathers each level-s
// cell's dx through halo.up_adjoint_table by c's own sum
// (gn::up_adjoint_sum, so the float32 dx is c's bit for bit) and applies
// the tail before any rounding; Σg_eff sums the written cotangent rows, as
// c's. In float32 it is the up conv's SIMT dx GEMM over the composed
// transposed table (halo.up_dx_table; rows are level-s grid cells) with
// the tail as its epilogue (gn::DxPairOut) and the up conv's Σg_eff pass
// (gn::launch_gsum). No merged branch, as in the reference.
//
// What bounds it on the card: the bf16 dx, as c's: the GEMM's tensor cores
// (4x the composed FLOPs, on the 4 upsampled phases; PERF.md §6 says why
// c chose dU), and the bytes of the passes (the cotangent written once; dU
// written once and gathered about 1.75 times; the pair read once and its 8
// cotangents written once); the float32 dx the FMA rate of the SIMT GEMM
// core (2 * 7 * C_in * 2 * C_out FLOPs per level-s cell). The float32
// forward and dtaps pay for the join on load: an operand element of their
// GEMMs joins up to two level-s cells (five for a pole mean), each 2 phase
// loads, 4 affine loads and 5 FLOPs, where the up conv loads one cell, and
// the loader holds more registers (74-77 a thread: 3 blocks an SM where the
// up conv fits 4); on an H100 the float32 forward takes about 1.6x the up
// conv's time at the same shape (PERF.md §6). In bf16 each cell is joined
// once, into the level-s grid the operand pass reads, and the GEMMs are the
// up conv's.
#include <type_traits>

#include "mma_conv_fwd.cuh"
#include "mma_dtaps.cuh"

namespace {

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// pair: host array of the 8 phase pointers b0[4], y10[4]; aff: mul1, add1,
// mul2, add2. h, w: the level-s grid (twice the phases' sides).
template <typename T>
gn::UpLoad<T, gn::PairCells<T>> pair_load(const void* const* pair, const float* const* aff,
                                          const int* up_table, int h, int w, int cin) {
  gn::UpLoad<T, gn::PairCells<T>> ld = {};
  for (int p = 0; p < 4; ++p) {
    ld.x.b0[p] = static_cast<const T*>(pair[p]);
    ld.x.y10[p] = static_cast<const T*>(pair[4 + p]);
    ld.x.aff[p] = aff[p];
  }
  ld.x.lh = log2i(h);
  ld.x.lw = log2i(w);
  ld.up = up_table;
  ld.hw = h * w;
  ld.hw5 = 5 * h * w;
  ld.cin = cin;
  return ld;
}

template <typename T>
cudaError_t fwd(const void* const* pair, const float* const* aff, const void* w0, const void* b0,
                const void* w1, const void* b1, void* const* outs, const int* conv_table,
                const int* up_table, float* stats_ws, float* const* stats, void* operand,
                void* joined, void* wpack, int B, int h, int w, int cin, int cout, int zero_poles,
                cudaStream_t stream) {
  const auto ld = pair_load<T>(pair, aff, up_table, h, w, cin);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    gn::FwdOut o = {};
    for (int i = 0; i < 8; ++i) o.out[i / 4][i % 4] = static_cast<T*>(outs[i]);
    o.bias[0] = static_cast<const T*>(b0);
    o.bias[1] = static_cast<const T*>(b1);
    o.stats = stats_ws;
    return gn::launch_mma_conv_fwd(ld, o, static_cast<const T*>(w0), static_cast<const T*>(w1),
                                   conv_table, static_cast<T*>(operand), static_cast<T*>(joined),
                                   static_cast<T*>(wpack), zero_poles, B, cout, 2, stats, stream);
  } else {
    gn::ConvOut<T> co = {};
    for (int i = 0; i < 8; ++i) co.out[i] = static_cast<T*>(outs[i]);
    co.w[0] = static_cast<const T*>(w0);
    co.w[1] = static_cast<const T*>(w1);
    co.bias[0] = static_cast<const T*>(b0);
    co.bias[1] = static_cast<const T*>(b1);
    co.stats = stats_ws;
    return gn::launch_conv_gemm<T>(ld, co, conv_table, B, 5 * h * w, cin, cout, 2, 0, 4, stats,
                                   stream);
  }
}

// float32: the up conv's SIMT dx GEMM over the composed table
// (halo.up_dx_table) with the tail's adjoint as its epilogue (DxPairOut),
// the partials' sum, then Σg_eff (launch_gsum).
cudaError_t dx_simt(const gn::GLoad<float>& gl, const void* w0, const void* w1,
                    const void* const* pair, const float* const* aff, void* const* outs,
                    const int* offsets, const int* cells, const float* weights, float* red,
                    float* const* daff, float* gsum_ws, float* gsum0, float* gsum1, int B, int h,
                    int w, int cin, int gsum_rows, cudaStream_t stream) {
  const int M = 5 * h * w;
  gn::DxPairOut<float> o = {};
  for (int i = 0; i < 8; ++i) {
    o.out[i] = static_cast<float*>(outs[i]);
    o.raw[i] = static_cast<const float*>(pair[i]);
  }
  for (int i = 0; i < 4; ++i) o.aff[i] = aff[i];
  o.red = red;
  o.lh = log2i(h);
  o.lw = log2i(w);
  dim3 grid((M + gn::BM - 1) / gn::BM, (cin + gn::BN - 1) / gn::BN, B);
  gn::dx_gemm<float, gn::GLoad<float>, gn::DxPairOut<float>><<<grid, gn::NT, 0, stream>>>(
      gl, static_cast<const float*>(w0), static_cast<const float*>(w1), offsets, cells, weights,
      o, M, cin, 2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the (blocks, 3 * cin) partials' columns: d_mul1, d_add1, d_mul2
  const gn::StackOut st = {{daff[0], daff[1], daff[2], nullptr}, cin};
  err = gn::launch_sum_rows(red, (int)(grid.x * grid.z), 3LL * cin, st, stream);
  if (err != cudaSuccess || gsum_ws == nullptr) return err;
  return gn::launch_gsum<float>(gl, B, 2, gsum_rows, gsum_ws, gsum0, gsum1, stream);
}

using bf16 = __nv_bfloat16;
using gn::UpAdjoint;

// The bf16 pair tail after the upsample adjoint: the raw pair and its
// affines, where the 8 phase cotangents go, and the column partials.
struct PairTail {
  const bf16* b0[4];
  const bf16* y10[4];
  bf16* db0[4];
  bf16* dy10[4];
  const float* aff[4];  // mul1, add1, mul2, add2
  float* red;           // (row blocks, 3 * cin): d_mul1, d_add1, d_mul2
  int lh, lw;           // log2 of the level-s grid's h and w
};

// pair_adjoint_pass's block: PA_COLS 4-channel chunks (128 channels) x
// PA_LANES row lanes over PA_ROWS level-s cells (build.PAIR_ADJOINT_ROWS).
constexpr int PA_COLS = 32;
constexpr int PA_LANES = 8;
constexpr int PA_ROWS = 64;

// Channels k0 .. k0 + 3 (< cin) of a phase row at src, in float32; vec:
// one 8-byte load.
__device__ __forceinline__ void load4(const bf16* __restrict__ src, int k0, int cin, int vec,
                                      float (&v)[4]) {
  if (vec) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    v[0] = __low2float(lo);
    v[1] = __high2float(lo);
    v[2] = __low2float(hi);
    v[3] = __high2float(hi);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = k0 + e < cin ? __bfloat162float(src[e]) : 0.f;
}

__device__ __forceinline__ void store4(bf16* __restrict__ dst, int k0, int cin, int vec,
                                       const float (&v)[4]) {
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(dst) = u;
    return;
  }
  for (int e = 0; e < 4 && k0 + e < cin; ++e) dst[e] = __float2bfloat16_rn(v[e]);
}

// n's last bf16 pass. Block (row block x, column tile y; the row blocks in
// x, whose count has no 65,535 limit): thread (tx, ty) takes channels
// k0 = 4 * (y * PA_COLS + tx) .. k0 + 3 of the level-s cells r0 + ty,
// r0 + ty + PA_LANES, ... (r0 = x * PA_ROWS, flat over the B * M cells). Each cell's dx is c's float32 sum (gn::up_adjoint_sum);
// before any rounding the tail's adjoint runs against the raw pair at the
// cell's phase and row (split_row): dm = dx where pair_pre > 0, else 0;
// db0 = bf16(dm * mul1), dy10 = bf16(dm * mul2) (as DxPairOut). The
// thread's sums of dm * b0, dm and dm * y10 add over the row lanes in order
// in shared memory into the block's partial row of red. Tag names the
// instantiation for a profile. vec: cin a multiple of 4 (16-byte dU loads,
// 8-byte pair loads and stores).
template <typename Tag>
__global__ void __launch_bounds__(PA_COLS * PA_LANES)
pair_adjoint_pass(UpAdjoint adj, PairTail tail, int M, int cin, int vec, long long rows) {
  __shared__ float part[3][PA_LANES][PA_COLS * 4];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k0 = (blockIdx.y * PA_COLS + tx) * 4;
  float aff[4][4], sa[4], sd[4], sb[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sa[e] = sd[e] = sb[e] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) aff[j][e] = k0 + e < cin ? __ldg(&tail.aff[j][k0 + e]) : 0.f;
  }
  const long long r0 = (long long)blockIdx.x * PA_ROWS;
  for (int i = ty; k0 < cin && i < PA_ROWS && r0 + i < rows; i += PA_LANES) {
    const long long r = r0 + i;
    const int b = (int)(r / M), m = (int)(r - (long long)b * M);
    float d[4], a[4], c[4], o0[4], o1[4];
    gn::up_adjoint_sum(adj, b, m, k0, M, cin, vec, d);
    size_t row;
    const int p = gn::split_row(b, m, tail.lh, tail.lw, row);
    const size_t off = row * cin + k0;
    load4(gn::pick4(tail.b0, p) + off, k0, cin, vec, a);
    load4(gn::pick4(tail.y10, p) + off, k0, cin, vec, c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float dm = gn::pair_pre(a[e], c[e], aff[0][e], aff[1][e], aff[2][e], aff[3][e]) > 0.f
                           ? d[e] : 0.f;
      o0[e] = dm * aff[0][e];
      o1[e] = dm * aff[2][e];
      sa[e] += dm * a[e];
      sd[e] += dm;
      sb[e] += dm * c[e];
    }
    store4(gn::pick4(tail.db0, p) + off, k0, cin, vec, o0);
    store4(gn::pick4(tail.dy10, p) + off, k0, cin, vec, o1);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    part[0][ty][tx * 4 + e] = sa[e];
    part[1][ty][tx * 4 + e] = sd[e];
    part[2][ty][tx * 4 + e] = sb[e];
  }
  __syncthreads();
  // one thread a (sum, column) of the tile: the row lanes in order
  for (int j = ty * PA_COLS + tx; j < 3 * PA_COLS * 4; j += PA_COLS * PA_LANES) {
    const int s = j / (PA_COLS * 4), col = j - s * PA_COLS * 4;
    const int k = blockIdx.y * PA_COLS * 4 + col;
    if (k >= cin) continue;
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < PA_LANES; ++l) acc += part[s][l][col];
    tail.red[(size_t)blockIdx.x * 3 * cin + (size_t)s * cin + k] = acc;
  }
}

// bf16: c's cotangent pass, tap pack and tensor-core dx GEMM into dU and
// Σg_eff over the written rows (gn::launch_cot_dx, tagged PairCells for a
// profile), then pair_adjoint_pass and the partials' fixed-order sum. The
// tables, the scratch and the partials are required: without them the call
// is refused.
cudaError_t dx_mma(const gn::GLoad<bf16>& gl, const void* w0, const void* w1,
                   const PairTail& tail, const gn::DxTables& tb, const UpAdjoint& adj,
                   float* const* daff, float* gsum_ws, float* gsum0, float* gsum1, int B, int cin,
                   int gsum_rows, cudaStream_t stream) {
  using Tag = gn::PairCells<bf16>;
  if (adj.du == nullptr || adj.offsets == nullptr || tail.red == nullptr)
    return cudaErrorInvalidValue;
  const int M = gl.M;
  cudaError_t err = gn::launch_cot_dx<Tag>(gl, tb, gn::DuEpi{adj.du, cin},
                                           static_cast<const bf16*>(w0),
                                           static_cast<const bf16*>(w1), gsum_ws, gsum0, gsum1,
                                           B, cin, 2, gsum_rows, stream);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * M;
  const int row_blocks = (int)((rows + PA_ROWS - 1) / PA_ROWS);
  const dim3 grid(row_blocks, (cin + 4 * PA_COLS - 1) / (4 * PA_COLS));
  auto aligned8 = [](const void* q) { return (reinterpret_cast<size_t>(q) & 7) == 0; };
  int vec = cin % 4 == 0;
  for (int p = 0; p < 4; ++p)
    vec = vec && aligned8(tail.b0[p]) && aligned8(tail.y10[p]) && aligned8(tail.db0[p]) &&
          aligned8(tail.dy10[p]);
  pair_adjoint_pass<Tag><<<grid, dim3(PA_COLS, PA_LANES), 0, stream>>>(adj, tail, M, cin, vec,
                                                                       rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const gn::StackOut st = {{daff[0], daff[1], daff[2], nullptr}, cin};
  return gn::launch_sum_rows(tail.red, row_blocks, 3LL * cin, st, stream);
}

// float32: the SIMT GEMM over the pair loader; bf16: the pair joined once
// into `joined`, the operand pass over it into `operand`, then the
// tensor-core GEMM
template <typename T>
cudaError_t dtaps(const void* const* pair, const float* const* aff, const void* const* g,
                  const void* const* y, const float* gs0, const float* gs1,
                  const int* conv_table, const int* up_table, float* ws, float* dt0, float* dt1,
                  void* operand, void* joined, int B, int h, int w, int cin, int cout, int kc,
                  int n_chunks, int zero_poles, cudaStream_t stream) {
  const int M = 5 * h * w;
  const gn::GLoad<T> gl = gn::make_gload<T>(g, y, gs0, gs1, M, cout, 2, 4);
  const auto ld = pair_load<T>(pair, aff, up_table, h, w, cin);
  if constexpr (std::is_same_v<T, float>)
    return gn::launch_dtaps_gemm<T>(ld, gl, conv_table, cin, 2, 0, B * 4 * M, kc, n_chunks, ws,
                                    dt0, dt1, stream);
  else
    return gn::launch_mma_dtaps(ld, gl, conv_table, static_cast<T*>(operand),
                                static_cast<T*>(joined), zero_poles, B, cin, 2, kc, n_chunks, ws,
                                dt0, dt1, stream);
}

// The pair's level-s grid needs parity phases: h = 2^lh >= 2, w = 2h.
bool bad_shape(int h, int w) { return h < 2 || (h & (h - 1)) != 0 || w != 2 * h; }

}  // namespace

// pair: host array of 8 pointers, b0[4] then y10[4], each a (B, 5, h/2,
// w/2, cin) phase of the level-s grid; aff: host array of 4 float32 (cin)
// pointers, mul1, add1, mul2, add2; w0/w1: taps (7, cin, cout); b0/b1: bias
// (cout) or null; outs: host array of 8 pointers, set-major, each (B, 5, h,
// w, cout), the level-(s+1) phases; conv_table: int32 (4, 7, 5*h*w) from
// halo.phase_conv_table; up_table: int32 (4*5*h*w, 2) from
// halo.upsample_table; stats_ws: null (no stats) or float32 scratch of the
// block partials, as in gn_up_dual_conv_fwd with n_sets = 2, and then
// st0/st1 receive each set's (2, cout) [sum, sumsq]; operand, wpack,
// zero_poles: as in gn_up_dual_conv_fwd; joined: bfloat16 only, scratch of
// (B, 5, h, w, cin) for the joined level-s grid. dtype: 0 float32, 1
// bfloat16.
extern "C" int gn_up_pair_fwd(const void* const* pair, const float* const* aff, const void* w0,
                              const void* b0, const void* w1, const void* b1, void* const* outs,
                              const int* conv_table, const int* up_table, float* stats_ws,
                              float* st0, float* st1, void* operand, void* joined, void* wpack,
                              int B, int h, int w, int cin, int cout, int zero_poles, int dtype,
                              void* stream) {
  if (bad_shape(h, w)) return cudaErrorInvalidValue;
  float* stats[2] = {st0, st1};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(pair, aff, w0, b0, w1, b1, outs, conv_table, up_table, stats_ws, stats,
                      nullptr, nullptr, nullptr, B, h, w, cin, cout, zero_poles, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(pair, aff, w0, b0, w1, b1, outs, conv_table, up_table, stats_ws,
                              stats, operand, joined, wpack, B, h, w, cin, cout, zero_poles, s);
  return cudaErrorInvalidValue;
}

// g: host array of 8 cotangent pointers (set-major), each (B, 5, h, w,
// cout), the level-(s+1) phases; y, gs0, gs1: null, or the forward outputs
// and the (2, cout) stats cotangents for the fold; w0/w1: taps (7, cin,
// cout); pair, aff: as in gn_up_pair_fwd; outs: host array of 8 pointers,
// db0[4] then dy10[4], each (B, 5, h/2, w/2, cin); daff: host array of 3
// float32 (cin) pointers receiving d_mul1, d_add1 (= d_add2) and d_mul2;
// gsum_ws: null, or float32 scratch of Σg_eff's pass and gsum0/gsum1
// receive Σg_eff (cout), as in gn_up_dual_conv_dx. float32:
// offsets/cells/weights, halo.up_dx_table(h, w, mode); red, float32
// scratch of (B * ceil(5hw/64), 3 * cin); the bf16 arguments null.
// bfloat16 (else the call is refused): codes .. tap_mask,
// adj_offsets .. adj_weights, operand, wpack and du as in
// gn_up_dual_conv_dx with n_sets = 2 (n_comb combined rows a sample); red,
// float32 scratch of (ceil(B * 5hw / 64), 3 * cin) (build.pair_adjoint_blocks).
// dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_pair_dx(const void* const* g, const void* const* y, const float* gs0,
                             const float* gs1, const void* w0, const void* w1,
                             const void* const* pair, const float* const* aff, void* const* outs,
                             const int* offsets, const int* cells, const float* weights,
                             const int* codes, const int* comb_offsets, const int* comb_cells,
                             const float* comb_weights, const unsigned char* tap_mask,
                             const int* adj_offsets, const int* adj_cells,
                             const float* adj_weights, void* operand, void* wpack, float* du,
                             float* red, float* const* daff, float* gsum_ws, float* gsum0,
                             float* gsum1, int B, int h, int w, int cin, int cout, int n_comb,
                             int gsum_rows, int dtype, void* stream) {
  if (bad_shape(h, w)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int M = 5 * h * w;
  if (dtype == 0)
    return dx_simt(gn::make_gload<float>(g, y, gs0, gs1, M, cout, 2, 4), w0, w1, pair, aff,
                   outs, offsets, cells, weights, red, daff, gsum_ws, gsum0, gsum1, B, h, w, cin,
                   gsum_rows, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  PairTail tail = {};
  for (int p = 0; p < 4; ++p) {
    tail.b0[p] = static_cast<const bf16*>(pair[p]);
    tail.y10[p] = static_cast<const bf16*>(pair[4 + p]);
    tail.db0[p] = static_cast<bf16*>(outs[p]);
    tail.dy10[p] = static_cast<bf16*>(outs[4 + p]);
    tail.aff[p] = aff[p];
  }
  tail.red = red;
  tail.lh = log2i(h);
  tail.lw = log2i(w);
  const gn::DxTables tb = {codes, {comb_offsets, comb_cells, comb_weights, n_comb}, tap_mask,
                           static_cast<bf16*>(operand), static_cast<bf16*>(wpack), 4};
  const UpAdjoint adj = {adj_offsets, adj_cells, adj_weights, du};
  return dx_mma(gn::make_gload<bf16>(g, y, gs0, gs1, M, cout, 2, 4), w0, w1, tail, tb, adj, daff,
                gsum_ws, gsum0, gsum1, B, cin, gsum_rows, s);
}

// out[4]: registers a thread, blocks an SM, dynamic shared memory and local
// memory (spills) of n's bf16 tensor-core dx GEMM (c's, tagged PairCells).
extern "C" int gn_up_pair_dx_info(int* out) {
  return gn::mma_conv_info<gn::PairCells<bf16>, gn::DuEpi>(out);
}

// pair, aff: as in gn_up_pair_fwd; g, y, gs0, gs1: as in gn_up_pair_dx;
// conv_table / up_table: halo.phase_conv_table and halo.upsample_table; ws:
// float32 scratch of (n_chunks, 7 * cin, 2 * cout), the rows B * 4 * 5hw
// split in chunks of kc (float32: a multiple of 16; bfloat16: of 32);
// dt0/dt1 receive (7, cin, cout) float32; operand, zero_poles: as in
// gn_up_dual_conv_dtaps; joined: bfloat16 only, scratch of (B, 5, h, w,
// cin) for the joined level-s grid. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_up_pair_dtaps(const void* const* pair, const float* const* aff,
                                const void* const* g, const void* const* y, const float* gs0,
                                const float* gs1, const int* conv_table, const int* up_table,
                                float* ws, float* dt0, float* dt1, void* operand, void* joined,
                                int B, int h, int w, int cin, int cout, int kc, int n_chunks,
                                int zero_poles, int dtype, void* stream) {
  if (bad_shape(h, w) || kc % gn::BK != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dtaps<float>(pair, aff, g, y, gs0, gs1, conv_table, up_table, ws, dt0, dt1, nullptr,
                        nullptr, B, h, w, cin, cout, kc, n_chunks, zero_poles, s);
  if (dtype == 1)
    return dtaps<__nv_bfloat16>(pair, aff, g, y, gs0, gs1, conv_table, up_table, ws, dt0, dt1,
                                operand, joined, B, h, w, cin, cout, kc, n_chunks, zero_poles, s);
  return cudaErrorInvalidValue;
}

// The joined pair's upsampled operand alone (the first two launches of the
// bf16 dtaps): pair, aff as in gn_up_pair_fwd, up_table as in
// gn_up_pair_dtaps; out: (B * (4 * 5hw + 2) + 1, cin rounded up to 8) in the
// pair's dtype; joined: scratch of (B, 5, h, w, cin) in that dtype.
extern "C" int gn_up_pair_operand(const void* const* pair, const float* const* aff,
                                  const int* up_table, void* out, void* joined, int B, int h,
                                  int w, int cin, int zero_poles, int dtype, void* stream) {
  if (bad_shape(h, w)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gn::launch_up_operand(pair_load<float>(pair, aff, up_table, h, w, cin),
                                 static_cast<float*>(out), static_cast<float*>(joined), B,
                                 zero_poles, s);
  if (dtype == 1)
    return gn::launch_up_operand(pair_load<__nv_bfloat16>(pair, aff, up_table, h, w, cin),
                                 static_cast<__nv_bfloat16*>(out),
                                 static_cast<__nv_bfloat16*>(joined), B, zero_poles, s);
  return cudaErrorInvalidValue;
}

// out[4]: as gn_up_dual_conv_dtaps_info, for n's tensor-core GEMM.
extern "C" int gn_up_pair_dtaps_info(int fold, int* out) {
  return fold ? gn::mma_dtaps_info<gn::PairCells<__nv_bfloat16>, true>(out)
              : gn::mma_dtaps_info<gn::PairCells<__nv_bfloat16>, false>(out);
}

// out[4]: as gn_up_dual_conv_fwd_info, for n's tensor-core forward GEMM.
extern "C" int gn_up_pair_fwd_info(int stats, int* out) {
  return stats ? gn::mma_conv_fwd_info<gn::PairCells<__nv_bfloat16>, true>(out)
               : gn::mma_conv_fwd_info<gn::PairCells<__nv_bfloat16>, false>(out);
}
