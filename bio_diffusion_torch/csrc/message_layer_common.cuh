// Device helpers shared by the message-layer kernels (message_layer.cu,
// message_layer_bwd.cu, gcp2_chain.cu): the compute-dtype rounding points,
// the sigmoid, the register-tiled product of a shared-memory tile with a
// weight matrix, and the residual GCP2 chain stage and attention over a tile.

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

// Vector norms and frame scalarization of a stage's projected vectors over a
// tile of TR rows: dst[r, q] = safe_norm over coords of H[r, k*hd + q]
// (q < hd), then the 9 scalarized columns c*3+a = sum_k H[r, 3hd + 9k + c*3+a]
// * frames_t[r, 3k+a].  The vh part of H is rounded in place to the compute
// dtype (the TPU kernel feeds vh to the up-projection in that dtype).
template <int TR, typename T>
__device__ __forceinline__ void norms_and_frames(float* H, int ldh, const float* FT, float* dst,
                                                 int ldd, int hd) {
  const int w = hd + 9;
  for (int idx = threadIdx.x; idx < TR * w; idx += blockDim.x) {
    const int r = idx / w, q = idx % w;
    float* h = H + r * ldh;
    float out;
    if (q < hd) {
      const float a = h[q], b = h[hd + q], c = h[2 * hd + q];
      out = sqrtf(a * a + b * b + c * c + 1e-8f) + 1e-8f;
      h[q] = Num<T>::rnd(a);
      h[hd + q] = Num<T>::rnd(b);
      h[2 * hd + q] = Num<T>::rnd(c);
    } else {
      const int qq = q - hd, a = qq % 3;
      const float* f = FT + r * 12;
      const float* vd = h + 3 * hd + qq;
      out = vd[0] * f[a] + vd[9] * f[3 + a] + vd[18] * f[6 + a];
    }
    dst[r * ldd + q] = Num<T>::rnd(out);
  }
}

// The per-row state of a tile of edge rows in shared memory (f32) that the
// residual GCP2 chain reads and updates.
struct ChainTile {
  float* A;         // [s state (S) | vnorm (Hc) | schid (9)], stride lda
  float* Vb;        // vector state, coords-major [3V], stride ldv
  float* Hb;        // projected vectors vh | vdf (rep3-expanded) [3Hc + 27], stride ldh
  float* X;         // the stage's silu(s2) [S], stride ldx
  float* Gt;        // the stage's vector gates [V], stride ldg
  const float* FT;  // transposed frames [9], stride 12
  int lda, ldv, ldh, ldx, ldg;
};

// One residual GCP2 stage over a tile of TR rows (the first nrows real):
// vhd = v @ wcomb, vnorm and scalarized frames, s2 = [s | vnorm | schid] @ wsc
// + bsc, gate = sigmoid(silu(s2) @ wgc + bgc), s += silu(s2), v += (vh @ wubd)
// * gate.  In the bf16 instantiation every value the TPU kernel rounds to the
// compute dtype is rounded at the same point.  Starts and ends at a block
// barrier.  Shared by the message layer and the flat-row chain kernel.
template <int TR, typename T>
__device__ __forceinline__ void chain_stage(const ChainTile& t, int nrows, int S, int V, int Hc,
                                            const T* wcomb, const T* wsc, const T* bsc,
                                            const T* wubd, const T* wgc, const T* bgc) {
  using NT = Num<T>;
  const int V3 = 3 * V, Wc = 3 * Hc + 27;
  tile_mm<8>(t.Vb, t.ldv, nrows, V3, wcomb, Wc,
             [&](int r, int c, float acc) { t.Hb[r * t.ldh + c] = acc; });
  __syncthreads();
  norms_and_frames<TR, T>(t.Hb, t.ldh, t.FT, t.A + S, t.lda, Hc);
  __syncthreads();
  tile_mm<8>(t.A, t.lda, nrows, S + Hc + 9, wsc, S, [&](int r, int c, float acc) {
    const float s2 = acc + NT::ld(bsc[c]);
    t.X[r * t.ldx + c] = NT::rnd(s2 * sigmoid_f(s2));
  });
  __syncthreads();
  tile_mm<4>(t.X, t.ldx, nrows, S, wgc, V, [&](int r, int c, float acc) {
    t.Gt[r * t.ldg + c] = NT::rnd(sigmoid_f(acc + NT::ld(bgc[c])));
  });
  __syncthreads();
  tile_mm<8>(t.Hb, t.ldh, nrows, 3 * Hc, wubd, V3, [&](int r, int c, float acc) {
    float* v = t.Vb + r * t.ldv + c;
    *v = NT::rnd(*v + NT::rnd(NT::rnd(acc) * t.Gt[r * t.ldg + c % V]));
  });
  for (int idx = threadIdx.x; idx < TR * S; idx += blockDim.x) {
    const int r = idx / S, c = idx % S;
    t.A[r * t.lda + c] = NT::rnd(t.A[r * t.lda + c] + t.X[r * t.ldx + c]);
  }
  __syncthreads();
}

// Sigmoid scalar attention of the chain's output, one warp per row:
// SC[r] = rnd(sigmoid(s[r] @ wattn + battn) * EM[r]), EM[r] = 1 where EM is
// null.  Ends before a barrier: the caller syncs before reading SC.
template <typename T>
__device__ __forceinline__ void attention_scale(const float* A, int lda, int nrows, int S,
                                                const T* wattn, const T* battn, const float* EM,
                                                float* SC) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < nrows; r += blockDim.x / 32) {
    float acc = 0.f;
    for (int k = lane; k < S; k += 32) acc = fmaf(A[r * lda + k], Num<T>::ld(wattn[k]), acc);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) SC[r] = Num<T>::rnd(sigmoid_f(acc + Num<T>::ld(battn[0])) * (EM ? EM[r] : 1.f));
  }
}

}  // namespace
