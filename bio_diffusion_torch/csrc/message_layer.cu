// One GCPNet message-passing layer per launch, for Hopper (sm_90a).
//
// Replaces: bio_diffusion_tpu/ops/pallas/gcp_kernel.py::fused_message_layer
// (Pallas bodies _message_layer_kernel_wm, _message_layer_kernel and their
// shared _chain_and_attn).  For every edge (i, j) of a molecule it runs the
// first message GCP over the virtual concat [node_i | edge_ij | node_j], the
// three residual GCP2 stages, sigmoid scalar attention times the edge mask,
// and sums the messages over the targets j.  The node-side projections
// (s @ wsi, s @ wsj, v @ wvi, v @ wvj) are O(B N S^2) and arrive precomputed
// (proj_i, proj_j), as they do in the TPU wrapper; every per-edge product is
// computed here.
//
// What bounds it on an H100.  At QM9 width (S=256, V=32, Se=64, Ve=16,
// H1=20, Hc=8, 3 chain stages) one edge row costs, in multiply-adds:
//   GCP1   xi@wve 48x87 + cat1@wsx 93x256 + silu@wg 256x32 + vh@wu 60x96 = 41,936
//   chain  per stage v@wcomb 96x51 + merged@wsc 273x256 + silu@wg 256x32
//          + vh@wu 24x96 = 85,280, three stages = 255,840
//   attention 256
// = 298,032 MAC = 0.60 MFLOP per row (block-diagonal zeros included).  At
// B=8, N=19 one layer is 2,888 rows = 1.7 GFLOP, while it moves ~1.6 MB of
// device memory in bf16: the packed edge tensor (2,888 x 122 values,
// 0.7 MB), ~0.3 M weights (0.6 MB, read by every block, so L2-resident),
// the node projections and the outputs (0.3 MB).  ~1,000 FLOP per byte is
// far above the card's balance point (~295 for bf16 tensor cores, ~20 for
// f32 FMA): the kernel is compute-bound.
//
// What the design does about it.  One block per (molecule b, source node i)
// walks the targets j in tiles of ROWS rows.  A tile's per-edge state (s, v,
// the stage inputs and outputs) stays in shared memory in f32 for the whole
// layer, so no per-edge intermediate ever reaches device memory; the sum over
// j is a block-local f32 accumulation (deterministic, no atomics).  Each
// product is a register-tiled loop: a thread owns one output column and RPT
// rows, reads the tile's inputs from shared memory as broadcast float4 loads
// and the weight column from L1/L2, and keeps RPT accumulators in registers.
// Tiling j makes any N work (GEOM's 181 included) with no node padding.  The
// tensor cores are not used yet (plain FMA), which is the next lever.
//
// Numerics follow the TPU kernel: products accumulate in f32; in the bf16
// instantiation every value the TPU kernel rounds to the compute dtype (stage
// outputs, residual sums, the gated vector update, the attention scale) is
// rounded to bf16 at the same point.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int ROWS = 32;      // target rows per tile
constexpr int THREADS = 256;  // threads per block

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

template <typename T>
struct Params {
  const T* proj_i;  // [B, N, S + 3H1 + 27]: s@wsi | v@wvi
  const T* proj_j;  // [B, N, S + 3H1 + 27]: s@wsj | v@wvj
  const T* epack;   // [B, N*N, P]: e | xi (coords-major) | frames_t | mask
  const T* wve;     // [3Ve, 3H1+27]
  const T* wsx;     // [Se+H1+9, S]
  const T* bs1;     // [S]
  const T* wu1;     // [3H1, 3V]
  const T* wg1;     // [S, V]
  const T* bg1;     // [V]
  const T* wcomb;   // [G, 3V, 3Hc+27]
  const T* wsc;     // [G, S+Hc+9, S]
  const T* bsc;     // [G, S]
  const T* wubd;    // [G, 3Hc, 3V]
  const T* wgc;     // [G, S, V]
  const T* bgc;     // [G, V]
  const T* wattn;   // [S, 1]
  const T* battn;   // [1]
  T* s_agg;         // [B, N, S]
  T* v_agg;         // [B, N, 3V]
  int B, N, P, S, V, Se, Ve, H1, Hc, G;
};

// Shared-memory strides (floats) of the per-tile buffers.
struct Layout {
  int lda, ldv, ldh, ldx, ldg;
  __host__ __device__ Layout(int S, int V, int Se, int Ve, int H1, int Hc) {
    const int a = S + Hc + 9, a1 = Se + H1 + 9;
    lda = round4(a > a1 ? a : a1);
    ldv = round4(3 * V);
    const int h = 3 * H1 + 27, hc = 3 * Hc + 27;
    ldh = round4(h > hc ? h : hc);
    ldx = round4(S > 3 * Ve ? S : 3 * Ve);
    ldg = round4(V);
  }
  __host__ __device__ int tile_floats() const { return ROWS * (lda + ldv + ldh + ldx + ldg + 12 + 2); }
};

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

// Vector norms and frame scalarization of a stage's projected vectors:
// dst[r, q] = safe_norm over coords of H[r, k*hd + q] (q < hd), then the 9
// scalarized columns c*3+a = sum_k H[r, 3hd + 9k + c*3+a] * frames_t[r, 3k+a].
// The vh part of H is rounded in place to the compute dtype (the TPU kernel
// feeds vh to the up-projection in that dtype).
template <typename T>
__device__ __forceinline__ void norms_and_frames(float* H, int ldh, const float* FT, float* dst,
                                                 int ldd, int hd) {
  const int w = hd + 9;
  for (int idx = threadIdx.x; idx < ROWS * w; idx += blockDim.x) {
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
message_layer_kernel(const Params<T> p) {
  using NT = Num<T>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(p.S, p.V, p.Se, p.Ve, p.H1, p.Hc);
  float* A = smem;                  // stage scalar input: cat1 | s state, vnorm, schid
  float* Vb = A + ROWS * L.lda;     // vector state, coords-major [3V]
  float* Hb = Vb + ROWS * L.ldv;    // projected vectors vh | vdf (rep3-expanded)
  float* X = Hb + ROWS * L.ldh;     // xi, then each stage's silu(s2)
  float* Gt = X + ROWS * L.ldx;     // vector gates
  float* FT = Gt + ROWS * L.ldg;    // transposed frames [9] (stride 12)
  float* EM = FT + ROWS * 12;       // edge mask
  float* SC = EM + ROWS;            // attention scale x mask
  float* AGG = SC + ROWS;           // [S + 3V] running sum over j

  const int i = blockIdx.x, b = blockIdx.y;
  const int N = p.N, S = p.S, V = p.V, Se = p.Se, Ve = p.Ve, H1 = p.H1, Hc = p.Hc, P = p.P;
  const int V3 = 3 * V, W1 = 3 * H1 + 27, Wc = 3 * Hc + 27, PW = S + W1;
  const T* pi = p.proj_i + (size_t)(b * N + i) * PW;
  const T* pj0 = p.proj_j + (size_t)b * N * PW;
  const T* ep_i = p.epack + ((size_t)b * N * N + (size_t)i * N) * P;

  for (int c = threadIdx.x; c < S + V3; c += blockDim.x) AGG[c] = 0.f;

  for (int j0 = 0; j0 < N; j0 += ROWS) {
    const int nrows = min(ROWS, N - j0);
    __syncthreads();  // previous tile's aggregation has read every buffer

    // ---- load the tile's edge rows (rows past nrows are zero) ----
    for (int idx = threadIdx.x; idx < ROWS * P; idx += blockDim.x) {
      const int r = idx / P, q = idx % P;
      const float val = r < nrows ? NT::ld(ep_i[(size_t)(j0 + r) * P + q]) : 0.f;
      if (q < Se) A[r * L.lda + q] = val;
      else if (q < Se + 3 * Ve) X[r * L.ldx + q - Se] = val;
      else if (q < Se + 3 * Ve + 9) FT[r * 12 + q - Se - 3 * Ve] = val;
      else if (q == Se + 3 * Ve + 9) EM[r] = val;
    }
    __syncthreads();

    // ---- GCP1: vh | vdf = proj_i + proj_j + xi @ wve ----
    tile_mm<8>(X, L.ldx, nrows, 3 * Ve, p.wve, W1, [&](int r, int c, float acc) {
      const float pj = r < nrows ? NT::ld(pj0[(size_t)(j0 + r) * PW + S + c]) : 0.f;
      Hb[r * L.ldh + c] = (NT::ld(pi[S + c]) + pj) + acc;
    });
    __syncthreads();
    norms_and_frames<T>(Hb, L.ldh, FT, A + Se, L.lda, H1);
    __syncthreads();
    // s2 = proj_i + proj_j + [e | vnorm | schid] @ wsx + bs
    tile_mm<8>(A, L.lda, nrows, Se + H1 + 9, p.wsx, S, [&](int r, int c, float acc) {
      const float pj = r < nrows ? NT::ld(pj0[(size_t)(j0 + r) * PW + c]) : 0.f;
      const float s2 = (NT::ld(pi[c]) + pj) + (acc + NT::ld(p.bs1[c]));
      X[r * L.ldx + c] = NT::rnd(s2 * sigmoid_f(s2));
    });
    __syncthreads();
    tile_mm<4>(X, L.ldx, nrows, S, p.wg1, V, [&](int r, int c, float acc) {
      Gt[r * L.ldg + c] = NT::rnd(sigmoid_f(acc + NT::ld(p.bg1[c])));
    });
    __syncthreads();
    tile_mm<8>(Hb, L.ldh, nrows, 3 * H1, p.wu1, V3, [&](int r, int c, float acc) {
      Vb[r * L.ldv + c] = NT::rnd(NT::rnd(acc) * Gt[r * L.ldg + c % V]);
    });
    for (int idx = threadIdx.x; idx < ROWS * S; idx += blockDim.x) {
      const int r = idx / S, c = idx % S;
      A[r * L.lda + c] = X[r * L.ldx + c];
    }
    __syncthreads();

    // ---- residual chain of GCP2 stages ----
    for (int g = 0; g < p.G; ++g) {
      tile_mm<8>(Vb, L.ldv, nrows, V3, p.wcomb + (size_t)g * V3 * Wc, Wc,
                 [&](int r, int c, float acc) { Hb[r * L.ldh + c] = acc; });
      __syncthreads();
      norms_and_frames<T>(Hb, L.ldh, FT, A + S, L.lda, Hc);
      __syncthreads();
      const T* bsc = p.bsc + (size_t)g * S;
      tile_mm<8>(A, L.lda, nrows, S + Hc + 9, p.wsc + (size_t)g * (S + Hc + 9) * S, S,
                 [&](int r, int c, float acc) {
                   const float s2 = acc + NT::ld(bsc[c]);
                   X[r * L.ldx + c] = NT::rnd(s2 * sigmoid_f(s2));
                 });
      __syncthreads();
      const T* bgc = p.bgc + (size_t)g * V;
      tile_mm<4>(X, L.ldx, nrows, S, p.wgc + (size_t)g * S * V, V, [&](int r, int c, float acc) {
        Gt[r * L.ldg + c] = NT::rnd(sigmoid_f(acc + NT::ld(bgc[c])));
      });
      __syncthreads();
      tile_mm<8>(Hb, L.ldh, nrows, 3 * Hc, p.wubd + (size_t)g * 3 * Hc * V3, V3,
                 [&](int r, int c, float acc) {
                   float* v = Vb + r * L.ldv + c;
                   *v = NT::rnd(*v + NT::rnd(NT::rnd(acc) * Gt[r * L.ldg + c % V]));
                 });
      for (int idx = threadIdx.x; idx < ROWS * S; idx += blockDim.x) {
        const int r = idx / S, c = idx % S;
        A[r * L.lda + c] = NT::rnd(A[r * L.lda + c] + X[r * L.ldx + c]);
      }
      __syncthreads();
    }

    // ---- attention x edge mask: one warp per row ----
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < nrows; r += blockDim.x / 32) {
      float acc = 0.f;
      for (int k = lane; k < S; k += 32) acc = fmaf(A[r * L.lda + k], NT::ld(p.wattn[k]), acc);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) SC[r] = NT::rnd(sigmoid_f(acc + NT::ld(p.battn[0])) * EM[r]);
    }
    __syncthreads();

    // ---- masked aggregation over this tile's targets ----
    for (int c = threadIdx.x; c < S + V3; c += blockDim.x) {
      float acc = AGG[c];
      if (c < S) {
        for (int r = 0; r < nrows; ++r) acc += NT::rnd(A[r * L.lda + c] * SC[r]);
      } else {
        for (int r = 0; r < nrows; ++r) acc += NT::rnd(Vb[r * L.ldv + c - S] * EM[r]);
      }
      AGG[c] = acc;
    }
  }
  __syncthreads();
  T* so = p.s_agg + (size_t)(b * N + i) * S;
  T* vo = p.v_agg + (size_t)(b * N + i) * V3;
  for (int c = threadIdx.x; c < S + V3; c += blockDim.x) {
    if (c < S) so[c] = NT::st(AGG[c]);
    else vo[c - S] = NT::st(AGG[c]);
  }
}

template <typename T>
int launch(const void* proj_i, const void* proj_j, const void* epack, const void* wve,
           const void* wsx, const void* bs1, const void* wu1, const void* wg1, const void* bg1,
           const void* wcomb, const void* wsc, const void* bsc, const void* wubd, const void* wgc,
           const void* bgc, const void* wattn, const void* battn, void* s_agg, void* v_agg,
           int B, int N, int P, int S, int V, int Se, int Ve, int H1, int Hc, int G,
           void* stream) {
  Params<T> p;
  p.proj_i = static_cast<const T*>(proj_i);
  p.proj_j = static_cast<const T*>(proj_j);
  p.epack = static_cast<const T*>(epack);
  p.wve = static_cast<const T*>(wve);
  p.wsx = static_cast<const T*>(wsx);
  p.bs1 = static_cast<const T*>(bs1);
  p.wu1 = static_cast<const T*>(wu1);
  p.wg1 = static_cast<const T*>(wg1);
  p.bg1 = static_cast<const T*>(bg1);
  p.wcomb = static_cast<const T*>(wcomb);
  p.wsc = static_cast<const T*>(wsc);
  p.bsc = static_cast<const T*>(bsc);
  p.wubd = static_cast<const T*>(wubd);
  p.wgc = static_cast<const T*>(wgc);
  p.bgc = static_cast<const T*>(bgc);
  p.wattn = static_cast<const T*>(wattn);
  p.battn = static_cast<const T*>(battn);
  p.s_agg = static_cast<T*>(s_agg);
  p.v_agg = static_cast<T*>(v_agg);
  p.B = B; p.N = N; p.P = P; p.S = S; p.V = V; p.Se = Se; p.Ve = Ve;
  p.H1 = H1; p.Hc = Hc; p.G = G;
  if (B <= 0 || N <= 0 || B > 65535 || P != Se + 3 * Ve + 10) return (int)cudaErrorInvalidValue;
  const Layout L(S, V, Se, Ve, H1, Hc);
  const size_t smem = sizeof(float) * ((size_t)L.tile_floats() + S + 3 * V);
  cudaError_t err = cudaFuncSetAttribute(message_layer_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  message_layer_kernel<T><<<dim3(N, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at these widths.
int message_layer_smem_bytes(int S, int V, int Se, int Ve, int H1, int Hc) {
  const Layout L(S, V, Se, Ve, H1, Hc);
  return (int)(sizeof(float) * ((size_t)L.tile_floats() + S + 3 * V));
}

#define MESSAGE_LAYER_ENTRY(NAME, T)                                                        \
  int NAME(const void* proj_i, const void* proj_j, const void* epack, const void* wve,      \
           const void* wsx, const void* bs1, const void* wu1, const void* wg1,              \
           const void* bg1, const void* wcomb, const void* wsc, const void* bsc,            \
           const void* wubd, const void* wgc, const void* bgc, const void* wattn,           \
           const void* battn, void* s_agg, void* v_agg, int B, int N, int P, int S, int V,  \
           int Se, int Ve, int H1, int Hc, int G, void* stream) {                           \
    return launch<T>(proj_i, proj_j, epack, wve, wsx, bs1, wu1, wg1, bg1, wcomb, wsc, bsc,  \
                     wubd, wgc, bgc, wattn, battn, s_agg, v_agg, B, N, P, S, V, Se, Ve, H1, \
                     Hc, G, stream);                                                        \
  }

MESSAGE_LAYER_ENTRY(message_layer_f32, float)
MESSAGE_LAYER_ENTRY(message_layer_bf16, __nv_bfloat16)

}  // extern "C"
