// Decoder tail: the last UpBlock's residual join, the 1x1 head and tanh, forward.
//   t   = relu(b0 * mul1 + add1 + y10 * mul2 + add2)    (float32, cast to T)
//   out = tanh(float(T(t @ W + bias)))                  (float32 out)
// per cell of each of the 4 level-s phases; the caller interleaves the four
// F-channel outputs.
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_phead (kernel body
// _phead_fwd_kernel), as called by fused_pair_head.
//
// What bounds it on the card: memory. It reads 8 tensors of C=64 channels
// per cell and writes 3 floats, with 2 * 64 * 3 FLOPs per cell, far below
// the card's compute-to-bandwidth ratio. The design reads each input once:
// one thread per cell walks its channels (the head weights, bias and
// affines sit in shared memory), so the joined 64-channel tensor never
// exists in device memory.
#include "common.cuh"

namespace {

constexpr int MAX_F = 8;
constexpr int THREADS = 256;

template <typename T>
struct HeadArgs {
  const T* b0[4];
  const T* y10[4];
  float* out[4];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
pair_head_kernel(HeadArgs<T> a, const float* __restrict__ mul1, const float* __restrict__ add1,
                 const float* __restrict__ mul2, const float* __restrict__ add2,
                 const T* __restrict__ W, const T* __restrict__ bias, int cells, int cin, int F) {
  extern __shared__ float sh[];
  float* sw = sh;                 // (cin, F)
  float* sb = sw + cin * F;       // (F)
  float* aff = sb + F;            // mul1, add1, mul2, add2, each (cin)
  for (int i = threadIdx.x; i < cin * F; i += blockDim.x) sw[i] = gn::to_f(W[i]);
  for (int i = threadIdx.x; i < F; i += blockDim.x) sb[i] = gn::to_f(bias[i]);
  for (int i = threadIdx.x; i < cin; i += blockDim.x) {
    aff[i] = mul1[i];
    aff[cin + i] = add1[i];
    aff[2 * cin + i] = mul2[i];
    aff[3 * cin + i] = add2[i];
  }
  __syncthreads();
  const int p = blockIdx.y;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const T* av = a.b0[p] + (size_t)cell * cin;
  const T* bv = a.y10[p] + (size_t)cell * cin;
  float z[MAX_F];
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) z[f] = 0.f;
  for (int k = 0; k < cin; ++k) {
    float t = __fadd_rn(__fmul_rn(gn::to_f(av[k]), aff[k]), aff[cin + k]);
    t = __fadd_rn(t, __fmul_rn(gn::to_f(bv[k]), aff[2 * cin + k]));
    t = gn::round_to<T>(fmaxf(__fadd_rn(t, aff[3 * cin + k]), 0.f));
#pragma unroll
    for (int f = 0; f < MAX_F; ++f)
      if (f < F) z[f] = fmaf(t, sw[k * F + f], z[f]);
  }
  float* o = a.out[p] + (size_t)cell * F;
  for (int f = 0; f < F; ++f) o[f] = tanhf(gn::round_to<T>(z[f] + sb[f]));
}

template <typename T>
cudaError_t run(const void* const* ins, const float* m1, const float* a1, const float* m2,
                const float* a2, const void* W, const void* bias, void* const* outs, int cells,
                int cin, int F, cudaStream_t stream) {
  HeadArgs<T> a;
  for (int p = 0; p < 4; ++p) {
    a.b0[p] = static_cast<const T*>(ins[p]);
    a.y10[p] = static_cast<const T*>(ins[4 + p]);
    a.out[p] = static_cast<float*>(outs[p]);
  }
  const size_t smem = sizeof(float) * (cin * F + F + 4 * cin);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid((cells + THREADS - 1) / THREADS, 4);
  pair_head_kernel<T><<<grid, THREADS, smem, stream>>>(a, m1, a1, m2, a2, static_cast<const T*>(W),
                                                       static_cast<const T*>(bias), cells, cin, F);
  return cudaGetLastError();
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
    return run<float>(ins, mul1, add1, mul2, add2, W, bias, outs, cells, cin, F, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(ins, mul1, add1, mul2, add2, W, bias, outs, cells, cin, F, s);
  return cudaErrorInvalidValue;
}
