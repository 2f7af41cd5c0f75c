// The residual GCP2 chain and sigmoid scalar attention over flat edge rows,
// for Hopper (sm_90a).
//
// Replaces: bio_diffusion_tpu/ops/pallas/gcp_kernel.py::fused_gcp2_chain
// (Pallas body _gcp2_chain_kernel).  For every row of s [E, S], v [E, 3V]
// (coords-major) and frames_t [E, 9] (transposed, k*3+a) it runs G residual
// GCP2 stages (vhd = v @ w_comb, vnorm, frame scalarization, s2 = [s | vnorm
// | schid] @ ws + bs, gate = sigmoid(silu(s2) @ wg + bg), s += silu(s2),
// v += (vh @ wu_bd) * gate), then s *= sigmoid(s @ wattn + battn).
//
// What bounds it on an H100.  At QM9 width (S=256, V=32, Hc=8, G=3) one row
// costs, per stage, v@wcomb 96x51 + merged@ws 273x256 + silu@wg 256x32 +
// vh@wu 24x96 = 85,280 multiply-adds, three stages and the attention 256,096
// = 0.51 MFLOP per row (block-diagonal zeros included), while it moves its
// row once in and once out: (2 x (S + 3V) + 9) values = 1.4 KB in bf16.
// ~360 FLOP per byte: compute-bound against the f32 FMA pipes (~20 FLOP per
// byte), and near the balance point of the bf16 tensor cores (~295).
//
// What the design does about it.  One block per 32 flat rows (the ragged
// last tile is masked; rows need no padding to a block multiple).  The
// tile's s and v stay in shared memory in f32 through every stage, so no
// intermediate reaches device memory; the stage and the attention are the
// message layer's own device functions (message_layer_common.cuh, bf16
// rounding where the TPU kernel casts).  In bf16 each stage's merged and gate
// products (91% of a row's multiply-adds) run on the tensor cores by mma.sync
// m16n8k16 (f32 accumulators, the tile as two m16 tiles); not wgmma, whose
// 64-row tiles would need a different block shape than the one the message
// layer shares.  The small vector products and every float32 product stay on
// the FMA pipes.  What bounds it then: each block reads the stages' ~0.47 MB
// of wide weights from L2 (~0.8 GB at E=53,824), and the FMA remainder.

#include "message_layer_common.cuh"

namespace {

constexpr int ROWS = 32;      // flat rows per block
constexpr int THREADS = 256;  // threads per block

template <typename T>
struct ChainParams {
  const T* s;      // [E, S]
  const T* v;      // [E, 3V]
  const T* ft;     // [E, 9]
  const T* wcomb;  // [G, 3V, 3Hc+27]
  const T* wsc;    // [G, S+Hc+9, S]
  const T* bsc;    // [G, S]
  const T* wubd;   // [G, 3Hc, 3V]
  const T* wgc;    // [G, S, V]
  const T* bgc;    // [G, V]
  const T* wattn;  // [S, 1]
  const T* battn;  // [1]
  T* s_out;        // [E, S]
  T* v_out;        // [E, 3V]
  int E, S, V, Hc, G;
};

// Shared-memory strides (floats) of the per-tile buffers; A and X, which
// tile_mma reads, are padded to 8 (mod 16) floats.
struct ChainLayout {
  int lda, ldv, ldh, ldx, ldg;
  ChainLayout(int S, int V, int Hc)
      : lda(mma_stride(S + Hc + 9)), ldv(round4(3 * V)), ldh(round4(3 * Hc + 27)),
        ldx(mma_stride(S)), ldg(round4(V)) {}
  size_t bytes() const { return sizeof(float) * ROWS * (size_t)(lda + ldv + ldh + ldx + ldg + 12 + 1); }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
gcp2_chain_kernel(const ChainParams<T> p, const ChainLayout L) {
  using NT = Num<T>;
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);  // s state | vnorm | schid
  float* Vb = A + ROWS * L.lda;                // vector state, coords-major [3V]
  float* Hb = Vb + ROWS * L.ldv;               // projected vectors vh | vdf
  float* X = Hb + ROWS * L.ldh;                // each stage's silu(s2)
  float* Gt = X + ROWS * L.ldx;                // vector gates
  float* FT = Gt + ROWS * L.ldg;               // transposed frames [9] (stride 12)
  float* SC = FT + ROWS * 12;                  // attention scale

  const int S = p.S, V3 = 3 * p.V, Hc = p.Hc, Wc = 3 * Hc + 27;
  const size_t r0 = (size_t)blockIdx.x * ROWS;
  const int nrows = min(ROWS, p.E - (int)r0);

  // ---- load the tile (rows past nrows are zero) ----
  for (int idx = threadIdx.x; idx < ROWS * S; idx += blockDim.x) {
    const int r = idx / S, c = idx % S;
    A[r * L.lda + c] = r < nrows ? NT::ld(p.s[(r0 + r) * S + c]) : 0.f;
  }
  for (int idx = threadIdx.x; idx < ROWS * V3; idx += blockDim.x) {
    const int r = idx / V3, c = idx % V3;
    Vb[r * L.ldv + c] = r < nrows ? NT::ld(p.v[(r0 + r) * V3 + c]) : 0.f;
  }
  for (int idx = threadIdx.x; idx < ROWS * 9; idx += blockDim.x) {
    const int r = idx / 9, c = idx % 9;
    FT[r * 12 + c] = r < nrows ? NT::ld(p.ft[(r0 + r) * 9 + c]) : 0.f;
  }
  __syncthreads();

  const ChainTile tile{A, Vb, Hb, X, Gt, FT, L.lda, L.ldv, L.ldh, L.ldx, L.ldg};
  for (int g = 0; g < p.G; ++g) {
    chain_stage<ROWS, T>(tile, nrows, S, p.V, Hc, p.wcomb + (size_t)g * V3 * Wc,
                         p.wsc + (size_t)g * (S + Hc + 9) * S, p.bsc + (size_t)g * S,
                         p.wubd + (size_t)g * 3 * Hc * V3, p.wgc + (size_t)g * S * p.V,
                         p.bgc + (size_t)g * p.V);
  }
  attention_scale<T>(A, L.lda, nrows, S, p.wattn, p.battn, nullptr, SC);
  __syncthreads();

  // ---- store the real rows: s * attention (rounded as the TPU kernel's
  // product in the compute dtype), v ----
  for (int idx = threadIdx.x; idx < nrows * S; idx += blockDim.x) {
    const int r = idx / S, c = idx % S;
    p.s_out[(r0 + r) * S + c] = NT::st(A[r * L.lda + c] * SC[r]);
  }
  for (int idx = threadIdx.x; idx < nrows * V3; idx += blockDim.x) {
    const int r = idx / V3, c = idx % V3;
    p.v_out[(r0 + r) * V3 + c] = NT::st(Vb[r * L.ldv + c]);
  }
}

template <typename T>
int launch(const void* const* in, void* s_out, void* v_out, int E, int S, int V, int Hc, int G,
           void* stream) {
  if (E <= 0 || S <= 0 || V <= 0 || Hc <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  ChainParams<T> p;
  const T* const* w = reinterpret_cast<const T* const*>(in);
  p.s = w[0]; p.v = w[1]; p.ft = w[2]; p.wcomb = w[3]; p.wsc = w[4]; p.bsc = w[5];
  p.wubd = w[6]; p.wgc = w[7]; p.bgc = w[8]; p.wattn = w[9]; p.battn = w[10];
  p.s_out = static_cast<T*>(s_out);
  p.v_out = static_cast<T*>(v_out);
  p.E = E; p.S = S; p.V = V; p.Hc = Hc; p.G = G;
  const ChainLayout L(S, V, Hc);
  const size_t smem = L.bytes();
  cudaError_t err = cudaFuncSetAttribute(gcp2_chain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((E + ROWS - 1) / ROWS);
  gcp2_chain_kernel<T><<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in: s, v, frames_t, w_comb, ws, bs, wu_bd, wg, bg, wattn, battn (device
// pointers of one dtype); returns a cudaError_t code (0 on success).
int gcp2_chain_f32(const void* const* in, void* s_out, void* v_out, int E, int S, int V, int Hc,
                   int G, void* stream) {
  return launch<float>(in, s_out, v_out, E, S, V, Hc, G, stream);
}

int gcp2_chain_bf16(const void* const* in, void* s_out, void* v_out, int E, int S, int V, int Hc,
                    int G, void* stream) {
  return launch<__nv_bfloat16>(in, s_out, v_out, E, S, V, Hc, G, stream);
}

// Bytes of dynamic shared memory one block needs at these widths.
int gcp2_chain_smem_bytes(int S, int V, int Hc) { return (int)ChainLayout(S, V, Hc).bytes(); }

// Blocks of the float32 (bf16 == 0) or bf16 kernel that one SM holds at
// `smem` bytes of dynamic shared memory each; a negative CUDA error code on
// failure.
int gcp2_chain_blocks_per_sm(int bf16, int smem) {
  return bf16 ? blocks_per_sm(gcp2_chain_kernel<__nv_bfloat16>, THREADS, smem)
              : blocks_per_sm(gcp2_chain_kernel<float>, THREADS, smem);
}

}  // extern "C"
