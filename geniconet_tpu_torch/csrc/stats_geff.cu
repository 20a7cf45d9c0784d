// The BatchNorm stats-cotangent fold outside the conv kernels, over a group
// of up to 4 phase tensors in one launch: g_eff = g + gs0 + 2 * gs1 * y
// elementwise, gs0/gs1 per channel, float32 math rounded to g's dtype.
//
// Replaces: geniconet_tpu/ops/pallas/phase_kernel.py:_stats_geff (kernel
// body _fold_geff_kernel), which a backward runs before its unfolded dx and
// dtaps kernels where its kernel family does not fold in-kernel.
//
// The arithmetic is the cotangent loader's (backward.cuh:GLoad), with the
// same two roundings per product and sum:
// round(fadd(fadd(g, gs0), fmul(fmul(2, y), gs1))). So this kernel followed
// by the unfolded dx and dtaps kernels gives what the in-kernel fold gives,
// bit for bit.
//
// What bounds it on the card: memory. Each element is three streams (read g,
// read y, write g_eff) and four FLOPs. The design moves 16 bytes per load
// and store (8 bf16 or 4 float32 values, one channel run: the channel count
// is a multiple of the vector width) with the matching gs0/gs1 as float4
// loads, in a grid-stride loop with one grid row per tensor of the group,
// whose channel index runs along without a division; a scalar instance
// takes the rest (channel counts not a multiple of the vector width,
// unaligned tensors).
#include "common.cuh"

namespace {

template <typename T>
struct Group {
  const T* g[4];
  const T* y[4];
  T* out[4];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
stats_geff(Group<T> grp, const float* __restrict__ gs, long long n_vec, int C) {
  const T* __restrict__ g = grp.g[blockIdx.y];
  const T* __restrict__ y = grp.y[blockIdx.y];
  T* __restrict__ out = grp.out[blockIdx.y];
  // a thread's vector v holds channels c0 .. c0 + VEC - 1, c0 = (v mod cv) * VEC:
  // kept as a running index, so the loop does no 64-bit division
  const int cv = C / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int step = (int)(stride % cv);
  long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int cvi = (int)(v % cv);
  for (; v < n_vec; v += stride) {
    const long long e = v * VEC;
    const int c0 = cvi * VEC;
    alignas(16) T gv[VEC], yv[VEC], ov[VEC];
    float a[VEC], m[VEC];
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(g + e);
      *reinterpret_cast<uint4*>(yv) = *reinterpret_cast<const uint4*>(y + e);
#pragma unroll
      for (int k = 0; k < VEC; k += 4) {
        const float4 u = __ldg(reinterpret_cast<const float4*>(gs + c0 + k));
        const float4 w = __ldg(reinterpret_cast<const float4*>(gs + C + c0 + k));
        a[k] = u.x, a[k + 1] = u.y, a[k + 2] = u.z, a[k + 3] = u.w;
        m[k] = w.x, m[k + 1] = w.y, m[k + 2] = w.z, m[k + 3] = w.w;
      }
    } else {
      gv[0] = g[e];
      yv[0] = y[e];
      a[0] = gs[c0];
      m[0] = gs[C + c0];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float yy = __fmul_rn(2.f, gn::to_f(yv[k]));
      ov[k] = gn::from_f<T>(__fadd_rn(__fadd_rn(gn::to_f(gv[k]), a[k]), __fmul_rn(yy, m[k])));
    }
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(out + e) = *reinterpret_cast<const uint4*>(ov);
    } else {
      out[e] = ov[0];
    }
    cvi += step;
    if (cvi >= cv) cvi -= cv;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

template <typename T>
cudaError_t run(const void* const* g, const void* const* y, const float* gs,
                void* const* outs, int n, long long numel, int C, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  Group<T> grp = {};
  bool vec = C % VEC == 0 && aligned16(gs);
  for (int i = 0; i < n; ++i) {
    grp.g[i] = static_cast<const T*>(g[i]);
    grp.y[i] = static_cast<const T*>(y[i]);
    grp.out[i] = static_cast<T*>(outs[i]);
    vec = vec && aligned16(g[i]) && aligned16(y[i]) && aligned16(outs[i]);
  }
  const long long n_vec = vec ? numel / VEC : numel;
  // enough blocks for 8 of 256 threads on each of the 132 SMs, shared by the group
  const long long want = (n_vec + 255) / 256, cap = (1056 + n - 1) / n;
  dim3 grid((unsigned)(want < cap ? want : cap), n);
  if (vec)
    stats_geff<T, VEC><<<grid, 256, 0, stream>>>(grp, gs, n_vec, C);
  else
    stats_geff<T, 1><<<grid, 256, 0, stream>>>(grp, gs, n_vec, C);
  return cudaGetLastError();
}

}  // namespace

// g, y, outs: host arrays of n (1..4) pointers to tensors of numel elements
// each, channels-last with C channels (the cotangents of n phase outputs,
// the outputs themselves, and where g_eff goes); gs: float32 (2, C), the
// cotangent of the outputs' [sum, sumsq]. dtype: 0 float32, 1 bfloat16.
extern "C" int gn_stats_geff(const void* const* g, const void* const* y, const float* gs,
                             void* const* outs, int n, long long numel, int C, int dtype,
                             void* stream) {
  if (n < 1 || n > 4 || C < 1 || numel % C != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(g, y, gs, outs, n, numel, C, s);
  if (dtype == 1) return run<__nv_bfloat16>(g, y, gs, outs, n, numel, C, s);
  return cudaErrorInvalidValue;
}
