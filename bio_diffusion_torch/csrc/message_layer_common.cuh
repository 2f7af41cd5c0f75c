// Device helpers shared by the message-layer kernels (message_layer.cu,
// message_layer_bwd.cu): the compute-dtype rounding points, the sigmoid, and
// the register-tiled product of a shared-memory tile with a weight matrix.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float ld(float x) { return x; }
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static __device__ __forceinline__ float st(float x) { return x; }
};

template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 st(float x) { return __float2bfloat16_rn(x); }
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// out[r, c] = sum_k in[r, k] * W[k, c] for the tile's first ceil(nrows/RPT)*RPT
// rows; epi(r, c, acc) consumes each result.  A thread owns one column and RPT
// rows; `in` rows are 16-byte aligned (ldi % 4 == 0).
template <int RPT, typename T, typename Epi>
__device__ __forceinline__ void tile_mm(const float* __restrict__ in, int ldi, int nrows, int K,
                                        const T* __restrict__ W, int ncols, Epi epi) {
  const int groups = (nrows + RPT - 1) / RPT;
  for (int item = threadIdx.x; item < groups * ncols; item += blockDim.x) {
    const int c = item % ncols;
    const int r0 = (item / ncols) * RPT;
    const float* x = in + r0 * ldi;
    const T* w = W + c;
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      const float w0 = Num<T>::ld(__ldg(w + (k + 0) * ncols));
      const float w1 = Num<T>::ld(__ldg(w + (k + 1) * ncols));
      const float w2 = Num<T>::ld(__ldg(w + (k + 2) * ncols));
      const float w3 = Num<T>::ld(__ldg(w + (k + 3) * ncols));
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(x + r * ldi + k);
        float a = acc[r];
        a = fmaf(xv.x, w0, a);
        a = fmaf(xv.y, w1, a);
        a = fmaf(xv.z, w2, a);
        a = fmaf(xv.w, w3, a);
        acc[r] = a;
      }
    }
    for (; k < K; ++k) {
      const float wk = Num<T>::ld(__ldg(w + k * ncols));
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = fmaf(x[r * ldi + k], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) epi(r0 + r, c, acc[r]);
  }
}

}  // namespace
