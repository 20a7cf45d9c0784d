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

template <typename T>
struct ConvOut {
  T* out[8];           // set-major: out[set * n_out + phase slot]
  const T* w[2];       // taps per set, (7, C_in, C_out)
  const T* bias[2];    // per set, nullable
};

template <typename T, typename Loader>
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
    __syncthreads();
  }

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
      co.out[s * n_out + slot][((size_t)b * M + m) * cout + nc] = from_f<T>(acc[i][j] + bias);
    }
  }
}

template <typename T, typename Loader>
cudaError_t launch_conv_gemm(const Loader& ld, const ConvOut<T>& co, const int* table, int B,
                             int M, int cin, int cout, int n_sets, int out_phase0, int n_out,
                             cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (n_sets * cout + BN - 1) / BN, B * n_out);
  conv_gemm<T, Loader><<<grid, NT, 0, stream>>>(ld, co, table, M, cin, cout, n_sets,
                                                out_phase0, n_out);
  return cudaGetLastError();
}

}  // namespace gn
