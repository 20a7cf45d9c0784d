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
// per cell and phase (three times that backward), far below the card's
// compute-to-bandwidth ratio. The designs read each input once from device
// memory and keep the joined 64-channel tensor in registers:
// * forward: one thread per cell walks its channels (head weights, bias
//   and affines in shared memory); a block never straddles samples, so its
//   fixed-order tree sum is one partial of one sample's error; a second
//   launch, one block per sample, adds the partials in order and the pole
//   errors (recomputing the 10 pole cells);
// * backward (head_bwd_body, shared by both backward kernels): each block
//   takes 256 cells of one phase: one thread per cell recomputes v and the
//   cotangent dz = dv (1 - v^2) of the head's pre-activation (kept in
//   shared memory), where dv is the given g (gn_pair_head_bwd: the pole
//   adjoint is already in g) or 2 g_b (v - target) plus the poles'
//   cotangents from a first launch (gn_pair_head_mse_bwd); then threads map
//   to (cell group, channel), so the reads of b0/y10 and the writes of
//   their cotangents are coalesced, and each thread accumulates dW, d_mul1,
//   d_add1, d_mul2 for its channel in registers. Groups merge in a fixed
//   order into one partial row per block, and gn::sum_rows adds the rows in
//   a fixed order: no atomics, so the results repeat exactly.
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

// Backward main pass. Block (x, p): cells q = x*THREADS .. +THREADS of the
// flattened (sample, cell) axis, phase p. One partial row per block:
// [dW (cin*F) | dbias (F) | d_mul1 (cin) | d_add1 (cin) | d_mul2 (cin)].
template <typename T, bool MSE>
__device__ __forceinline__ void head_bwd_body(const HeadIn<T>& a, const HeadGrad<T>& d,
                                              const float* mul1, const float* add1,
                                              const float* mul2, const float* add2, const T* W,
                                              const T* bias, const DvSource& src, int Q, int M,
                                              int hw, int cin, int F, float* part) {
  extern __shared__ float sh[];
  load_head<T>(sh, mul1, add1, mul2, add2, W, bias, cin, F);
  const float* aff = sh + cin * F + F;
  float* dz_s = sh + cin * F + F + 4 * cin;  // (THREADS, F)
  float* merge = dz_s + THREADS * F;         // (THREADS, F + 3)
  const int p = blockIdx.y;
  const int q0 = blockIdx.x * THREADS;
  const int tid = threadIdx.x;

  // one thread per cell: v, dv, dz = dv (1 - v^2)
  {
    const int q = q0 + tid;
    float dz[MAX_F];
#pragma unroll
    for (int f = 0; f < MAX_F; ++f) dz[f] = 0.f;
    if (q < Q) {
      float v[MAX_F];
      cell_v<T>(a.b0[p] + (size_t)q * cin, a.y10[p] + (size_t)q * cin, sh, cin, F, v);
      if constexpr (MSE) {
        const int b = q / M, m = q - b * M;
        const float* tp = src.tpack + (size_t)q * 4 * F + p * F;
        const float g2 = src.g[b] * 2.f;
        const int corner = m % hw;
        const float* pole = nullptr;
        if (p == 0 && corner == 0) pole = src.dpole + (size_t)b * 2 * F;
        if (p == 3 && corner == hw - 1) pole = src.dpole + ((size_t)b * 2 + 1) * F;
#pragma unroll
        for (int f = 0; f < MAX_F; ++f) {
          if (f >= F) continue;
          float dv = g2 * (v[f] - tp[f]);
          if (pole) dv += pole[f];
          dz[f] = dv * (1.f - v[f] * v[f]);
        }
      } else {
        const float* gq = src.gph[p] + (size_t)q * F;
#pragma unroll
        for (int f = 0; f < MAX_F; ++f)
          if (f < F) dz[f] = gq[f] * (1.f - v[f] * v[f]);
      }
    }
    for (int f = 0; f < F; ++f) dz_s[tid * F + f] = dz[f];
  }
  __syncthreads();

  // threads as (cell group, channel k): coalesced over k
  const int G = THREADS / cin;
  const int k = tid % cin, grp = tid / cin;
  float dW[MAX_F], dm1 = 0.f, da1 = 0.f, dm2 = 0.f;
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) dW[f] = 0.f;
  if (grp < G) {
    for (int i = grp; i < THREADS && q0 + i < Q; i += G) {
      const size_t off = (size_t)(q0 + i) * cin + k;
      const float av = gn::to_f(a.b0[p][off]), bv = gn::to_f(a.y10[p][off]);
      const float pre = join_pre(av, bv, aff, cin, k);
      const float t = gn::round_to<T>(fmaxf(pre, 0.f));
      float dt = 0.f;
#pragma unroll
      for (int f = 0; f < MAX_F; ++f)
        if (f < F) dt = fmaf(dz_s[i * F + f], sh[k * F + f], dt);
      const float dm = pre > 0.f ? dt : 0.f;
      d.db0[p][off] = gn::from_f<T>(dm * aff[k]);
      d.dy10[p][off] = gn::from_f<T>(dm * aff[2 * cin + k]);
#pragma unroll
      for (int f = 0; f < MAX_F; ++f)
        if (f < F) dW[f] = fmaf(t, dz_s[i * F + f], dW[f]);
      dm1 = fmaf(dm, av, dm1);
      da1 += dm;
      dm2 = fmaf(dm, bv, dm2);
    }
    float* mine = merge + (size_t)(grp * cin + k) * (F + 3);
    for (int f = 0; f < F; ++f) mine[f] = dW[f];
    mine[F] = dm1;
    mine[F + 1] = da1;
    mine[F + 2] = dm2;
  }
  __syncthreads();
  const int P = cin * F + F + 3 * cin;
  float* row = part + ((size_t)p * gridDim.x + blockIdx.x) * P;
  if (tid < cin) {  // merge the groups in order
    float s[MAX_F + 3];
    for (int j = 0; j < F + 3; ++j) s[j] = 0.f;
    for (int gi = 0; gi < G; ++gi) {
      const float* src_row = merge + (size_t)(gi * cin + tid) * (F + 3);
      for (int j = 0; j < F + 3; ++j) s[j] += src_row[j];
    }
    for (int f = 0; f < F; ++f) row[tid * F + f] = s[f];
    row[cin * F + F + tid] = s[F];
    row[cin * F + F + cin + tid] = s[F + 1];
    row[cin * F + F + 2 * cin + tid] = s[F + 2];
  }
  if (tid < F) {
    float s = 0.f;
    for (int i = 0; i < THREADS; ++i) s += dz_s[i * F + tid];
    row[cin * F + tid] = s;
  }
}

// Two kernels (and not one templated kernel) so that a profile names each.
template <typename T>
__global__ void __launch_bounds__(THREADS)
phead_bwd_kernel(HeadIn<T> a, HeadGrad<T> d, const float* __restrict__ mul1,
                 const float* __restrict__ add1, const float* __restrict__ mul2,
                 const float* __restrict__ add2, const T* __restrict__ W,
                 const T* __restrict__ bias, DvSource src, int Q, int M, int hw, int cin, int F,
                 float* __restrict__ part) {
  head_bwd_body<T, false>(a, d, mul1, add1, mul2, add2, W, bias, src, Q, M, hw, cin, F, part);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
phmse_bwd_kernel(HeadIn<T> a, HeadGrad<T> d, const float* __restrict__ mul1,
                 const float* __restrict__ add1, const float* __restrict__ mul2,
                 const float* __restrict__ add2, const T* __restrict__ W,
                 const T* __restrict__ bias, DvSource src, int Q, int M, int hw, int cin, int F,
                 float* __restrict__ part) {
  head_bwd_body<T, true>(a, d, mul1, add1, mul2, add2, W, bias, src, Q, M, hw, cin, F, part);
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

size_t head_bwd_smem(int cin, int F) {
  return head_smem(cin, F) + sizeof(float) * THREADS * (2 * F + 3);
}

// The backward's main pass (kernel e or h) and the fixed-order sum of its
// partial rows into dW, dbias and the affine gradients.
template <typename T, bool MSE>
cudaError_t head_bwd(const HeadIn<T>& a, const HeadGrad<T>& d, const float* m1, const float* a1,
                     const float* m2, const float* a2, const void* W, const void* bias,
                     const DvSource& src, float* part, float* dW, float* dbias, float* dm1,
                     float* da1, float* dm2, float* da2, int B, int h, int w, int cin, int F,
                     cudaStream_t stream) {
  const int M = 5 * h * w, Q = B * M;
  const size_t smem = head_bwd_smem(cin, F);
  const T* Wt = static_cast<const T*>(W);
  const T* bt = static_cast<const T*>(bias);
  dim3 grid((Q + THREADS - 1) / THREADS, 4);
  if constexpr (MSE)
    phmse_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(a, d, m1, a1, m2, a2, Wt, bt, src, Q, M,
                                                         h * w, cin, F, part);
  else
    phead_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(a, d, m1, a1, m2, a2, Wt, bt, src, Q, M,
                                                         h * w, cin, F, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  HeadGradOut st = {dW, dbias, dm1, da1, dm2, da2, cin, F};
  return gn::launch_sum_rows(part, (int)(grid.x * grid.y), (long long)cin * F + F + 3LL * cin, st,
                             stream);
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
// part: float32 scratch of (4 * ceil(B*5hw/256), cin*F + F + 3*cin); dW
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
// (4 * ceil(B*5hw/256), cin*F + F + 3*cin); dW (cin, F), dbias (F), dmul1,
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
