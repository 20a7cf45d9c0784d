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
// card's compute-to-bandwidth ratio. The designs read each input once from
// device memory and keep the joined 64-channel tensor in registers:
// * forward: one thread per cell walks its channels (head weights, bias
//   and affines in shared memory); a block never straddles samples, so its
//   fixed-order tree sum is one partial of one sample's error; a second
//   launch, one block per sample, adds the partials in order and the pole
//   errors (recomputing the 10 pole cells);
// * backward (head_bwd_body, shared by both backward kernels e and h): it
//   moves b0 and y10 in and their 8 cotangents out (193 MB at the s=5
//   head, B=36: 0.058 ms at 3.35 TB/s) against about 2 * 64 * 13 FLOPs a
//   cell and phase, so it is bound by bytes. A group of lanes holds one
//   cell's channels (8 lanes x 8 bf16 or 16 lanes x 4 float32 at C = 64)
//   and takes all 4 phases of the cell: b0 and y10 are read once in
//   16-byte loads, the join, the head's dot products (shuffles inside the
//   group), tanh, dz and each channel's dt stay in registers, and db0/dy10
//   are written once in 16-byte stores; for h tpack's row of the cell is
//   read once, and the pole cotangents come from phmse_poles_kernel first.
//   dW, dbias, d_mul1, d_add1, d_mul2 accumulate in each lane's registers
//   over a grid-stride loop of a fixed grid (head_bwd_blocks: 2 blocks an
//   SM), merge in a fixed order (shuffles across the groups of a warp, the
//   warps in turn through shared memory) into one partial row a block, and
//   gn::sum_rows adds the rows in a fixed order: no atomics, so the
//   results repeat exactly. (A body that read each row twice, first one
//   thread a cell walking its channels, 128 bytes apart across a warp,
//   then coalesced, and wrote a partial row per 256 cells and phase, took
//   11x the byte bound.)
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_F = 8;
constexpr int THREADS = 256;

template <typename T>
struct HeadIn {
  const T* b0[4];
  const T* y10[4];
};

// Cooperative load of W (cin, F), bias (F) and the four affines (cin) into
// shared memory: sw | sb | aff(mul1, add1, mul2, add2). Ends with a barrier.
template <typename T>
__device__ __forceinline__ void load_head(float* sh, const float* mul1, const float* add1,
                                          const float* mul2, const float* add2, const T* W,
                                          const T* bias, int cin, int F) {
  float* sb = sh + cin * F;
  float* aff = sb + F;
  for (int i = threadIdx.x; i < cin * F; i += blockDim.x) sh[i] = gn::to_f(W[i]);
  for (int i = threadIdx.x; i < F; i += blockDim.x) sb[i] = gn::to_f(bias[i]);
  for (int i = threadIdx.x; i < cin; i += blockDim.x) {
    aff[i] = mul1[i];
    aff[cin + i] = add1[i];
    aff[2 * cin + i] = mul2[i];
    aff[3 * cin + i] = add2[i];
  }
  __syncthreads();
}

// The join's pre-activation for channel k: ((a*mul1 + add1) + b*mul2) + add2,
// each product and sum rounded once (no FMA contraction), as the reference.
__device__ __forceinline__ float join_pre(float a, float b, const float* aff, int cin, int k) {
  float t = __fadd_rn(__fmul_rn(a, aff[k]), aff[cin + k]);
  t = __fadd_rn(t, __fmul_rn(b, aff[2 * cin + k]));
  return __fadd_rn(t, aff[3 * cin + k]);
}

// v = tanh(T(t @ W + bias)) of one cell, t = T(relu(join_pre)), from the
// shared-memory head (load_head's layout).
template <typename T>
__device__ __forceinline__ void cell_v(const T* av, const T* bv, const float* sh, int cin, int F,
                                       float (&v)[MAX_F]) {
  const float* sb = sh + cin * F;
  const float* aff = sb + F;
  float z[MAX_F];
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) z[f] = 0.f;
  for (int k = 0; k < cin; ++k) {
    const float t =
        gn::round_to<T>(fmaxf(join_pre(gn::to_f(av[k]), gn::to_f(bv[k]), aff, cin, k), 0.f));
#pragma unroll
    for (int f = 0; f < MAX_F; ++f)
      if (f < F) z[f] = fmaf(t, sh[k * F + f], z[f]);
  }
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) v[f] = f < F ? tanhf(gn::round_to<T>(z[f] + sb[f])) : 0.f;
}

struct HeadOut {
  float* out[4];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
pair_head_kernel(HeadIn<T> a, HeadOut o, const float* __restrict__ mul1,
                 const float* __restrict__ add1, const float* __restrict__ mul2,
                 const float* __restrict__ add2, const T* __restrict__ W,
                 const T* __restrict__ bias, int cells, int cin, int F) {
  extern __shared__ float sh[];
  load_head<T>(sh, mul1, add1, mul2, add2, W, bias, cin, F);
  const int p = blockIdx.y;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  float v[MAX_F];
  cell_v<T>(a.b0[p] + (size_t)cell * cin, a.y10[p] + (size_t)cell * cin, sh, cin, F, v);
  float* dst = o.out[p] + (size_t)cell * F;
  for (int f = 0; f < F; ++f) dst[f] = v[f];
}

// Forward of the head+MSE, first pass: block (x, b) takes THREADS cells of
// sample b, each thread one cell over the 4 phases; part[b][x] receives the
// block's squared error against tpack (B, M, 4F) float32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
phmse_fwd_kernel(HeadIn<T> a, const float* __restrict__ mul1, const float* __restrict__ add1,
                 const float* __restrict__ mul2, const float* __restrict__ add2,
                 const T* __restrict__ W, const T* __restrict__ bias,
                 const float* __restrict__ tpack, int M, int cin, int F,
                 float* __restrict__ part) {
  extern __shared__ float sh[];
  __shared__ float red[THREADS];
  load_head<T>(sh, mul1, add1, mul2, add2, W, bias, cin, F);
  const int b = blockIdx.y;
  const int m = blockIdx.x * THREADS + threadIdx.x;
  float acc = 0.f;
  if (m < M) {
    const size_t cell = (size_t)b * M + m;
    for (int p = 0; p < 4; ++p) {
      float v[MAX_F];
      cell_v<T>(a.b0[p] + cell * cin, a.y10[p] + cell * cin, sh, cin, F, v);
      const float* tp = tpack + cell * 4 * F + p * F;
      for (int f = 0; f < F; ++f) {
        const float d = v[f] - tp[f];
        acc = fmaf(d, d, acc);
      }
    }
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {  // fixed-order tree
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) part[(size_t)b * gridDim.x + blockIdx.x] = red[0];
}

// One block of 32 threads per sample b. Threads 0-9 recompute v at the 10
// pole cells (north: phase 0, cell (0, 0) of each chart; south: phase 3,
// cell (h-1, w-1)); then thread 0 forms each pole's mean (5-chart sum in
// order, times 0.2) against tpoles (B, 2F) and either
// * g == null (forward): sse[b] = the block partials of phmse_fwd_kernel
//   summed in order (n_part per sample) + both poles' squared errors; or
// * g != null (backward): dpole[b][pole][f] = ((2 g[b]) (mean - target)) 0.2,
//   the cotangent each of the pole's 5 cells receives.
template <typename T>
__global__ void __launch_bounds__(32)
phmse_poles_kernel(HeadIn<T> a, const float* __restrict__ mul1, const float* __restrict__ add1,
                   const float* __restrict__ mul2, const float* __restrict__ add2,
                   const T* __restrict__ W, const T* __restrict__ bias,
                   const float* __restrict__ tpoles, const float* __restrict__ part, int n_part,
                   const float* __restrict__ g, int M, int hw, int cin, int F,
                   float* __restrict__ out) {
  extern __shared__ float sh[];
  __shared__ float pv[10][MAX_F];
  load_head<T>(sh, mul1, add1, mul2, add2, W, bias, cin, F);
  const int b = blockIdx.x;
  if (threadIdx.x < 10) {
    const int pole = threadIdx.x / 5, c = threadIdx.x % 5;
    const int p = pole ? 3 : 0;
    const size_t cell = (size_t)b * M + c * hw + (pole ? hw - 1 : 0);
    float v[MAX_F];
    cell_v<T>(a.b0[p] + cell * cin, a.y10[p] + cell * cin, sh, cin, F, v);
    for (int f = 0; f < F; ++f) pv[threadIdx.x][f] = v[f];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float s = 0.f;
  if (g == nullptr)
    for (int i = 0; i < n_part; ++i) s += part[(size_t)b * n_part + i];
  for (int pole = 0; pole < 2; ++pole) {
    for (int f = 0; f < F; ++f) {
      float mean = 0.f;
      for (int c = 0; c < 5; ++c) mean += pv[pole * 5 + c][f];
      const float d = mean * 0.2f - tpoles[(size_t)b * 2 * F + pole * F + f];
      if (g == nullptr)
        s = fmaf(d, d, s);
      else
        out[((size_t)b * 2 + pole) * F + f] = 2.f * g[b] * d * 0.2f;
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

// Backward main pass (kernels e and h). A cell's C channels are held by a
// group of L lanes (L a power of two, at most 32: C / VEC rounded up), lane
// l of a group taking the VEC-channel chunks l, l + L, ... (CPL of them, a
// template constant). Each group walks cells q = (sample, cell) in a
// grid-stride loop (warp by warp, so every lane of a warp reaches the
// shuffles) and, per cell, its 4 phases:
// * b0 and y10 read once, 16 bytes a lane (8 bf16 or 4 float32), the 4
//   phases' loads in flight together;
// * the join, its relu and its T-rounding in registers (join_pre, round_to:
//   the roundings of the forward, no FMA contraction), z_f = t @ W[:, f]
//   as each lane's FMA chain over its channels, then a butterfly of
//   shuffles inside the group (every lane gets the same bits);
// * v = tanh(float(T(z + bias))), dv (the given g, or 2 g_b (v - target)
//   plus the pole cotangent), dz = dv (1 - v^2);
// * per channel dt = sum_f dz_f W[k, f] (FMA in f order), the relu mask,
//   db0/dy10 rounded to T and written once, 16 bytes a lane; dW, d_mul1,
//   d_add1, d_mul2 (and dbias, the sum of dz) accumulate in registers.
// For h all four phases of a cell are one group's, so tpack's 4F-float row
// is read once, contiguously. At the end the groups of a warp merge by a
// butterfly of shuffles, the 8 warps in order through one shared row, and
// the block writes that row: [dW (cin*F) | dbias (F) | d_mul1 (cin) |
// d_add1 (cin) | d_mul2 (cin)]. No atomics: the results repeat exactly.
// W (FM columns, zeros past F) and the affines are read from shared memory;
// 2 blocks an SM (at most 128 registers a thread).
template <typename T, bool MSE, int CPL, int FM>
__device__ __forceinline__ void head_bwd_body(const HeadIn<T>& a, const HeadGrad<T>& d,
                                              const float* mul1, const float* add1,
                                              const float* mul2, const float* add2, const T* W,
                                              const T* bias, const DvSource& src, int Q, int M,
                                              int hw, int cin, int F, int L, int vec,
                                              float* part) {
  constexpr int VEC = Vec16<T>::VEC;
  constexpr int NW = THREADS / 32;
  extern __shared__ float sh[];
  float* aff = sh;                   // mul1 | add1 | mul2 | add2, (4, cin)
  float* sw = sh + 4 * cin;          // W, (cin, FM), zeros past F
  float* row_s = sw + cin * MAX_F;   // the block's partial row
  const int P = cin * F + F + 3 * cin;
  for (int i = threadIdx.x; i < cin; i += THREADS) {
    aff[i] = mul1[i];
    aff[cin + i] = add1[i];
    aff[2 * cin + i] = mul2[i];
    aff[3 * cin + i] = add2[i];
  }
  for (int i = threadIdx.x; i < cin * FM; i += THREADS) {
    const int k = i / FM, f = i - k * FM;
    sw[i] = f < F ? gn::to_f(W[k * F + f]) : 0.f;
  }
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lig = lane & (L - 1), grp = lane / L, gpw = 32 / L;
  const int nchunk = (cin + VEC - 1) / VEC;
  float sb[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) sb[f] = f < F ? gn::to_f(bias[f]) : 0.f;
  float dW[CPL][VEC][FM], dm1[CPL][VEC], da1[CPL][VEC], dm2[CPL][VEC], db[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) db[f] = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      dm1[c][e] = da1[c][e] = dm2[c][e] = 0.f;
#pragma unroll
      for (int f = 0; f < FM; ++f) dW[c][e][f] = 0.f;
    }

  const long long stride = (long long)gridDim.x * NW * gpw;
  for (long long base = ((long long)blockIdx.x * NW + warp) * gpw; base < Q; base += stride) {
    const long long q = base + grp;
    const bool live = q < Q;
    const int b = live ? (int)(q / M) : 0;
    const int m = live ? (int)(q - (long long)b * M) : 0;
    // b0 and y10 of this lane's channels in all 4 phases, read once and
    // all in flight together
    alignas(16) T xa[4][CPL][VEC], xb[4][CPL][VEC];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int j = lig + c * L, k0 = j * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) xa[p][c][e] = xb[p][c][e] = gn::from_f<T>(0.f);
        if (live && j < nchunk) {
          load_vec<T>(a.b0[p] + q * cin, k0, cin, vec, xa[p][c]);
          load_vec<T>(a.y10[p] + q * cin, k0, cin, vec, xb[p][c]);
        }
      }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      // the join and z's partial sums over this lane's channels
      float z[FM];
#pragma unroll
      for (int f = 0; f < FM; ++f) z[f] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int k0 = (lig + c * L) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int k = k0 + e;
          if (k >= cin) continue;
          const float pre =
              join_pre(gn::to_f(xa[p][c][e]), gn::to_f(xb[p][c][e]), aff, cin, k);
          const float t = gn::round_to<T>(fmaxf(pre, 0.f));
#pragma unroll
          for (int f = 0; f < FM; ++f) z[f] = fmaf(t, sw[k * FM + f], z[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < FM; ++f)
        for (int o = 1; o < L; o <<= 1) z[f] += __shfl_xor_sync(0xffffffffu, z[f], o);
      // v, dv, dz of the cell's phase p (zero for a cell past Q)
      float dz[FM];
#pragma unroll
      for (int f = 0; f < FM; ++f) dz[f] = 0.f;
      if (live) {
        if constexpr (MSE) {
          const float* tp = src.tpack + q * 4 * F + p * F;
          const float g2 = src.g[b] * 2.f;
          const int corner = m % hw;
          const float* pole = nullptr;
          if (p == 0 && corner == 0) pole = src.dpole + (size_t)b * 2 * F;
          if (p == 3 && corner == hw - 1) pole = src.dpole + ((size_t)b * 2 + 1) * F;
#pragma unroll
          for (int f = 0; f < FM; ++f) {
            if (f >= F) continue;
            const float v = tanhf(gn::round_to<T>(z[f] + sb[f]));
            float dv = g2 * (v - tp[f]);
            if (pole) dv += pole[f];
            dz[f] = dv * (1.f - v * v);
          }
        } else {
          const float* gq = src.gph[p] + q * F;
#pragma unroll
          for (int f = 0; f < FM; ++f) {
            if (f >= F) continue;
            const float v = tanhf(gn::round_to<T>(z[f] + sb[f]));
            dz[f] = gq[f] * (1.f - v * v);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < FM; ++f) db[f] += dz[f];
      // the channels' cotangents (the join recomputed, the same bits),
      // written once, and the sums
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int j = lig + c * L, k0 = j * VEC;
        float o0[VEC], o1[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          o0[e] = o1[e] = 0.f;
          const int k = k0 + e;
          if (k >= cin) continue;
          const float xav = gn::to_f(xa[p][c][e]), xbv = gn::to_f(xb[p][c][e]);
          const float pre = join_pre(xav, xbv, aff, cin, k);
          const float t = gn::round_to<T>(fmaxf(pre, 0.f));
          float dt = 0.f;
#pragma unroll
          for (int f = 0; f < FM; ++f) dt = fmaf(dz[f], sw[k * FM + f], dt);
          const float dm = pre > 0.f ? dt : 0.f;
          o0[e] = dm * aff[k];
          o1[e] = dm * aff[2 * cin + k];
#pragma unroll
          for (int f = 0; f < FM; ++f) dW[c][e][f] = fmaf(t, dz[f], dW[c][e][f]);
          dm1[c][e] = fmaf(dm, xav, dm1[c][e]);
          da1[c][e] += dm;
          dm2[c][e] = fmaf(dm, xbv, dm2[c][e]);
        }
        if (live && j < nchunk) {
          store_vec<T>(d.db0[p] + q * cin, k0, cin, vec, o0);
          store_vec<T>(d.dy10[p] + q * cin, k0, cin, vec, o1);
        }
      }
    }
  }

  // the groups of a warp in a butterfly, then the warps in order
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
          dW[c][e][f] += __shfl_xor_sync(0xffffffffu, dW[c][e][f], o);
        dm1[c][e] += __shfl_xor_sync(0xffffffffu, dm1[c][e], o);
        da1[c][e] += __shfl_xor_sync(0xffffffffu, da1[c][e], o);
        dm2[c][e] += __shfl_xor_sync(0xffffffffu, dm2[c][e], o);
      }
  for (int w = 0; w < NW; ++w) {
    if (warp == w && grp == 0) {
      auto put = [&](int i, float v) { row_s[i] = w == 0 ? v : row_s[i] + v; };
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int k = (lig + c * L) * VEC + e;
          if (k >= cin) continue;
#pragma unroll
          for (int f = 0; f < FM; ++f)
            if (f < F) put(k * F + f, dW[c][e][f]);
          put(cin * F + F + k, dm1[c][e]);
          put(cin * F + F + cin + k, da1[c][e]);
          put(cin * F + F + 2 * cin + k, dm2[c][e]);
        }
      if (lig == 0)
#pragma unroll
        for (int f = 0; f < FM; ++f)
          if (f < F) put(cin * F + f, db[f]);
    }
    __syncthreads();
  }
  float* row = part + (size_t)blockIdx.x * P;
  for (int i = tid; i < P; i += THREADS) row[i] = row_s[i];
}

// The backward's arguments, as its launchers pass them on.
template <typename T>
struct HeadBwdArgs {
  HeadIn<T> a;
  HeadGrad<T> d;
  const float *mul1, *add1, *mul2, *add2;
  const T* W;
  const T* bias;
  DvSource src;
  int Q, M, hw, cin, F, L, vec;
  float* part;
};

// Two kernels (and not one templated kernel) so that a profile names each.
template <typename T, int CPL, int FM>
__global__ void __launch_bounds__(THREADS, 2) phead_bwd_kernel(HeadBwdArgs<T> x) {
  head_bwd_body<T, false, CPL, FM>(x.a, x.d, x.mul1, x.add1, x.mul2, x.add2, x.W, x.bias, x.src,
                                   x.Q, x.M, x.hw, x.cin, x.F, x.L, x.vec, x.part);
}

template <typename T, int CPL, int FM>
__global__ void __launch_bounds__(THREADS, 2) phmse_bwd_kernel(HeadBwdArgs<T> x) {
  head_bwd_body<T, true, CPL, FM>(x.a, x.d, x.mul1, x.add1, x.mul2, x.add2, x.W, x.bias, x.src,
                                  x.Q, x.M, x.hw, x.cin, x.F, x.L, x.vec, x.part);
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

template <typename T>
HeadIn<T> head_in(void* const* ins) {
  HeadIn<T> a;
  for (int p = 0; p < 4; ++p) {
    a.b0[p] = static_cast<const T*>(ins[p]);
    a.y10[p] = static_cast<const T*>(ins[4 + p]);
  }
  return a;
}

size_t head_smem(int cin, int F) { return sizeof(float) * (cin * F + F + 4 * cin); }

template <typename T>
cudaError_t fwd(void* const* ins, const float* m1, const float* a1, const float* m2,
                const float* a2, const void* W, const void* bias, void* const* outs, int cells,
                int cin, int F, cudaStream_t stream) {
  const size_t smem = head_smem(cin, F);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  HeadOut o;
  for (int p = 0; p < 4; ++p) o.out[p] = static_cast<float*>(outs[p]);
  dim3 grid((cells + THREADS - 1) / THREADS, 4);
  pair_head_kernel<T><<<grid, THREADS, smem, stream>>>(
      head_in<T>(ins), o, m1, a1, m2, a2,
      static_cast<const T*>(W), static_cast<const T*>(bias), cells, cin, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mse_fwd(void* const* ins, const float* m1, const float* a1, const float* m2,
                    const float* a2, const void* W, const void* bias, const float* tpack,
                    const float* tpoles, float* part, float* sse, int B, int h, int w, int cin,
                    int F, cudaStream_t stream) {
  const size_t smem = head_smem(cin, F);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int M = 5 * h * w;
  const HeadIn<T> a = head_in<T>(ins);
  const T* Wt = static_cast<const T*>(W);
  const T* bt = static_cast<const T*>(bias);
  dim3 grid((M + THREADS - 1) / THREADS, B);
  phmse_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(a, m1, a1, m2, a2, Wt, bt, tpack, M, cin,
                                                       F, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  phmse_poles_kernel<T><<<B, 32, smem, stream>>>(a, m1, a1, m2, a2, Wt, bt, tpoles, part,
                                                 (int)grid.x, nullptr, M, h * w, cin, F, sse);
  return cudaGetLastError();
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

// Lanes a cell's group takes: the VEC-channel chunks of C, rounded up to a
// power of two, at most 32 (then a lane takes CPL = 2 chunks: float32 with
// C over 128).
template <typename T>
int head_lanes(int cin) {
  const int chunks = (cin + Vec16<T>::VEC - 1) / Vec16<T>::VEC;
  int L = 1;
  while (L < chunks && L < 32) L <<= 1;
  return L;
}

// Whether b0, y10 and their cotangents are read and written 16 bytes at a
// time: C a multiple of VEC and every phase 16-byte aligned.
template <typename T>
bool head_vec(const HeadIn<T>& a, const HeadGrad<T>& d, int cin) {
  bool vec = cin % Vec16<T>::VEC == 0;
  for (int p = 0; p < 4; ++p) {
    const void* ptrs[4] = {a.b0[p], a.y10[p], d.db0[p], d.dy10[p]};
    for (const void* ptr : ptrs) vec = vec && (reinterpret_cast<size_t>(ptr) & 15) == 0;
  }
  return vec;
}

// One launch of kernel e (MSE false) or h with CPL chunks a lane, FM
// columns of W held (3, or MAX_F for F over 3).
template <typename T, bool MSE, int CPL>
cudaError_t launch_head_bwd(int blocks, size_t smem, const HeadBwdArgs<T>& x,
                            cudaStream_t stream) {
  if (x.F <= 3) {
    if constexpr (MSE)
      phmse_bwd_kernel<T, CPL, 3><<<blocks, THREADS, smem, stream>>>(x);
    else
      phead_bwd_kernel<T, CPL, 3><<<blocks, THREADS, smem, stream>>>(x);
  } else {
    if constexpr (MSE)
      phmse_bwd_kernel<T, CPL, MAX_F><<<blocks, THREADS, smem, stream>>>(x);
    else
      phead_bwd_kernel<T, CPL, MAX_F><<<blocks, THREADS, smem, stream>>>(x);
  }
  return cudaGetLastError();
}

// The backward's main pass (kernel e or h) and the fixed-order sum of its
// partial rows (head_bwd_blocks of them) into dW, dbias and the affine
// gradients. CPL = 2 only where a float32 cell of over 128 channels needs
// two chunks a lane.
template <typename T, bool MSE>
cudaError_t head_bwd(const HeadIn<T>& a, const HeadGrad<T>& d, const float* m1, const float* a1,
                     const float* m2, const float* a2, const void* W, const void* bias,
                     const DvSource& src, float* part, float* dW, float* dbias, float* dm1,
                     float* da1, float* dm2, float* da2, int B, int h, int w, int cin, int F,
                     cudaStream_t stream) {
  const int M = 5 * h * w, Q = B * M;
  const size_t smem = head_bwd_smem(cin, F);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const HeadBwdArgs<T> x = {a, d, m1, a1, m2, a2, static_cast<const T*>(W),
                            static_cast<const T*>(bias), src, Q, M, h * w, cin, F,
                            head_lanes<T>(cin), head_vec(a, d, cin), part};
  const int blocks = head_bwd_blocks(Q);
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>)
    err = cin > 32 * Vec16<T>::VEC ? launch_head_bwd<T, MSE, 2>(blocks, smem, x, stream)
                                   : launch_head_bwd<T, MSE, 1>(blocks, smem, x, stream);
  else
    err = launch_head_bwd<T, MSE, 1>(blocks, smem, x, stream);
  if (err != cudaSuccess) return err;
  HeadGradOut st = {dW, dbias, dm1, da1, dm2, da2, cin, F};
  return gn::launch_sum_rows(part, blocks, (long long)cin * F + F + 3LL * cin, st, stream);
}

template <typename T>
cudaError_t pair_bwd(void* const* gph, void* const* ins, const float* m1, const float* a1,
                     const float* m2, const float* a2, const void* W, const void* bias,
                     void* const* grads, float* part, float* dW, float* dbias, float* dm1,
                     float* da1, float* dm2, float* da2, int B, int h, int w, int cin, int F,
                     cudaStream_t stream) {
  if (head_bwd_smem(cin, F) > 48 * 1024) return cudaErrorInvalidValue;
  DvSource src = {};
  for (int p = 0; p < 4; ++p) src.gph[p] = static_cast<const float*>(gph[p]);
  return head_bwd<T, false>(head_in<T>(ins), head_grad<T>(grads), m1, a1, m2, a2, W, bias, src,
                            part, dW, dbias, dm1, da1, dm2, da2, B, h, w, cin, F, stream);
}

template <typename T>
cudaError_t mse_bwd(const float* g, void* const* ins, const float* m1, const float* a1,
                    const float* m2, const float* a2, const void* W, const void* bias,
                    const float* tpack, const float* tpoles, void* const* grads, float* dpole,
                    float* part, float* dW, float* dbias, float* dm1, float* da1, float* dm2,
                    float* da2, int B, int h, int w, int cin, int F, cudaStream_t stream) {
  const size_t smem = head_smem(cin, F);
  if (head_bwd_smem(cin, F) > 48 * 1024) return cudaErrorInvalidValue;
  const int M = 5 * h * w;
  const HeadIn<T> a = head_in<T>(ins);
  phmse_poles_kernel<T><<<B, 32, smem, stream>>>(a, m1, a1, m2, a2, static_cast<const T*>(W),
                                                 static_cast<const T*>(bias), tpoles, nullptr, 0,
                                                 g, M, h * w, cin, F, dpole);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  DvSource src = {{nullptr, nullptr, nullptr, nullptr}, tpack, g, dpole};
  return head_bwd<T, true>(a, head_grad<T>(grads), m1, a1, m2, a2, W, bias, src, part, dW, dbias,
                           dm1, da1, dm2, da2, B, h, w, cin, F, stream);
}

}  // namespace

// ins: host array of 8 pointers, the 4 b0 phases then the 4 y10 phases,
// each (B, 5, h, w, cin) of T; mul1/add1/mul2/add2: float32 (cin); W: (cin, F)
// of T; bias: (F) of T; outs: host array of 4 float32 (B, 5, h, w, F).
// dtype: 0 float32, 1 bfloat16.
extern "C" int gn_pair_head_fwd(void* const* ins, const float* mul1, const float* add1,
                                const float* mul2, const float* add2, const void* W,
                                const void* bias, void* const* outs, int B, int h, int w, int cin,
                                int F, int dtype, void* stream) {
  if (F < 1 || F > MAX_F) return cudaErrorInvalidValue;
  const int cells = B * 5 * h * w;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(ins, mul1, add1, mul2, add2, W, bias, outs, cells, cin, F, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(ins, mul1, add1, mul2, add2, W, bias, outs, cells, cin, F, s);
  return cudaErrorInvalidValue;
}

// ins, mul1..add2, W, bias: as gn_pair_head_fwd; tpack: float32
// (B, 5, h, w, 4F), phase p's target at [pF, pF + F); tpoles: float32 (B, 2F),
// [north | south]; part: float32 scratch of (B, ceil(5hw/256)); sse: float32
// (B) per-sample squared-error sum. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_pair_head_mse_fwd(void* const* ins, const float* mul1, const float* add1,
                                    const float* mul2, const float* add2, const void* W,
                                    const void* bias, const float* tpack, const float* tpoles,
                                    float* part, float* sse, int B, int h, int w, int cin, int F,
                                    int dtype, void* stream) {
  if (F < 1 || F > MAX_F || cin < 1 || cin > THREADS) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mse_fwd<float>(ins, mul1, add1, mul2, add2, W, bias, tpack, tpoles, part, sse, B, h, w,
                          cin, F, s);
  if (dtype == 1)
    return mse_fwd<__nv_bfloat16>(ins, mul1, add1, mul2, add2, W, bias, tpack, tpoles, part, sse,
                                  B, h, w, cin, F, s);
  return cudaErrorInvalidValue;
}

// gph: host array of 4 float32 (B, 5, h, w, F), the cotangents of
// gn_pair_head_fwd's outputs; ins, mul1..add2, W, bias: as gn_pair_head_fwd;
// grads: host array of 8 outputs (the b0 then the y10 phase cotangents, T);
// part: float32 scratch of (head_bwd_blocks(B * 5hw), cin*F + F + 3*cin); dW
// (cin, F), dbias (F), dmul1, dadd1, dmul2, dadd2 (cin): float32 outputs.
// dtype: 0 float32, 1 bfloat16.
extern "C" int gn_pair_head_bwd(void* const* gph, void* const* ins, const float* mul1,
                                const float* add1, const float* mul2, const float* add2,
                                const void* W, const void* bias, void* const* grads, float* part,
                                float* dW, float* dbias, float* dmul1, float* dadd1, float* dmul2,
                                float* dadd2, int B, int h, int w, int cin, int F, int dtype,
                                void* stream) {
  if (F < 1 || F > MAX_F || cin < 1 || cin > THREADS) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pair_bwd<float>(gph, ins, mul1, add1, mul2, add2, W, bias, grads, part, dW, dbias,
                           dmul1, dadd1, dmul2, dadd2, B, h, w, cin, F, s);
  if (dtype == 1)
    return pair_bwd<__nv_bfloat16>(gph, ins, mul1, add1, mul2, add2, W, bias, grads, part, dW,
                                   dbias, dmul1, dadd1, dmul2, dadd2, B, h, w, cin, F, s);
  return cudaErrorInvalidValue;
}

// g: float32 (B) cotangent of sse; ins .. tpoles: as gn_pair_head_mse_fwd;
// grads: host array of 8 outputs (the b0 then the y10 phase cotangents, T);
// dpole: float32 scratch (B, 2, F); part: float32 scratch of
// (head_bwd_blocks(B * 5hw), cin*F + F + 3*cin); dW (cin, F), dbias (F), dmul1,
// dadd1, dmul2, dadd2 (cin): float32 outputs. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_pair_head_mse_bwd(const float* g, void* const* ins, const float* mul1,
                                    const float* add1, const float* mul2, const float* add2,
                                    const void* W, const void* bias, const float* tpack,
                                    const float* tpoles, void* const* grads, float* dpole,
                                    float* part, float* dW, float* dbias, float* dmul1,
                                    float* dadd1, float* dmul2, float* dadd2, int B, int h, int w,
                                    int cin, int F, int dtype, void* stream) {
  if (F < 1 || F > MAX_F || cin < 1 || cin > THREADS) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mse_bwd<float>(g, ins, mul1, add1, mul2, add2, W, bias, tpack, tpoles, grads, dpole,
                          part, dW, dbias, dmul1, dadd1, dmul2, dadd2, B, h, w, cin, F, s);
  if (dtype == 1)
    return mse_bwd<__nv_bfloat16>(g, ins, mul1, add1, mul2, add2, W, bias, tpack, tpoles, grads,
                                  dpole, part, dW, dbias, dmul1, dadd1, dmul2, dadd2, B, h, w,
                                  cin, F, s);
  return cudaErrorInvalidValue;
}
