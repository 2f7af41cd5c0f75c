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
// = 298,032 MAC = 0.60 MFLOP per real row (block-diagonal zeros included),
// a real row being an edge (i, j) whose mask is nonzero: sum_b n_b^2 rows
// for molecules of n_b atoms, whatever N the batch is padded to.  Per real
// row the kernel moves one packed edge row (122 values) and reads the
// ~0.3 M weights (0.6 MB in bf16) once a block from L2; ~1,000 FLOP per
// byte of device memory is far above the card's balance point (~295 for
// bf16 tensor cores, ~20 for f32 FMA): the kernel is compute-bound, and the
// least it can take is the real rows' FLOPs over the peak.
//
// What the design does about it.  One block per (molecule b, source node i)
// first lists the targets j whose edge mask EM(i, j) is nonzero, ascending
// (every warp ballots the mask column, warp 0 writes the list to shared
// memory), and computes only those rows: padded atoms, and any hole in the
// mask, cost one mask read each.  With trailing padding a real node's list
// is 0..n_b-1 and a padded node's is empty (its outputs are the zeros the
// block stores).  The block walks its list in tiles of ROWS rows; a tile's
// per-edge state (s, v, the stage inputs and outputs) stays in shared memory
// in f32 for the whole layer, so no per-edge intermediate ever reaches
// device memory; the sum over j is a block-local f32 accumulation in
// ascending j (deterministic, no atomics).  A row left out would add
// rnd(x * 0), a zero, so the sums over the kept rows are bit for bit those
// over all N, and NaN or Inf in a masked row no longer reaches them.  The
// products are row-independent, so computing a row in another tile or
// position changes none of its bits.  Tiling j makes any N work (GEOM's 181
// included) with no node padding.  The chain stage and the attention are
// device functions in message_layer_common.cuh, shared with the flat-row
// chain (gcp2_chain.cu).
//
// The products.  In the bf16 instantiation the four wide kinds (the first
// GCP's [e | vnorm | schid] @ wsx and silu @ wg, each stage's merged @ wsc
// and silu @ wg: 89% of a row's multiply-adds) run on the tensor cores:
// warp-level mma.sync m16n8k16, bf16 operands (the values the TPU kernel
// feeds its matrix unit are already bf16, so packing them is exact), f32
// accumulators, the 32-row tile as two m16 tiles (one when it holds <= 16
// real rows), B fragments read from the packed weights in device memory with
// one vector load per weight row and lane.  Not wgmma: it takes 64-row
// tiles, and a block holds 19 or 29 real rows (one source node's targets),
// so most of its work would be padding.  The small vector products
// (xi @ wve, vh @ wu, v @ wcomb, vh @ wu_bd) and every float32 product stay
// on the FMA pipes as register-tiled loops (a thread owns one column and RPT
// rows, reads the tile as broadcast float4 loads): float32 is the parity
// mode and keeps full f32 products (no TF32).  What bounds the bf16 kernel
// now (cli/kernel_phases.py): the wide products wait on their weights, which
// every block reads from L2 (~0.53 MB a block and tile of rows), and the
// small products on latency-bound FMA loops (~31.5k multiply-adds per row),
// each near half of a block's time.
//
// Numerics follow the TPU kernel: products accumulate in f32; in the bf16
// instantiation every value the TPU kernel rounds to the compute dtype (stage
// outputs, residual sums, the gated vector update, the attention scale) is
// rounded to bf16 at the same point.

#include "message_layer_common.cuh"

namespace {

constexpr int ROWS = 32;      // target rows per tile
constexpr int THREADS = 256;  // threads per block
constexpr int RPT = 8;        // rows a thread owns in the FMA products: a tile computes nrows rounded up to RPT

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

// Shared-memory strides (floats) of the per-tile buffers; A and X, which
// tile_mma reads, are padded to 8 (mod 16) floats.
struct Layout {
  int lda, ldv, ldh, ldx, ldg;
  __host__ __device__ Layout(int S, int V, int Se, int Ve, int H1, int Hc) {
    const int a = S + Hc + 9, a1 = Se + H1 + 9;
    lda = mma_stride(a > a1 ? a : a1);
    ldv = round4(3 * V);
    const int h = 3 * H1 + 27, hc = 3 * Hc + 27;
    ldh = round4(h > hc ? h : hc);
    ldx = mma_stride(S > 3 * Ve ? S : 3 * Ve);
    ldg = round4(V);
  }
  __host__ __device__ int tile_floats() const { return ROWS * (lda + ldv + ldh + ldx + ldg + 12 + 2); }
};

// Two blocks an SM (their shared memory fits): one block's barriers and
// latency-bound FMA loops hide behind the other's products.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
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
  int* KEPT = reinterpret_cast<int*>(AGG + p.S + 3 * p.V);  // [N] targets j with EM(i, j) != 0

  const int i = blockIdx.x, b = blockIdx.y;
  PHASE_START();
  const int N = p.N, S = p.S, V = p.V, Se = p.Se, Ve = p.Ve, H1 = p.H1, Hc = p.Hc, P = p.P;
  const int V3 = 3 * V, W1 = 3 * H1 + 27, Wc = 3 * Hc + 27, PW = S + W1;
  const T* pi = p.proj_i + (size_t)(b * N + i) * PW;
  const T* pj0 = p.proj_j + (size_t)b * N * PW;
  const T* ep_i = p.epack + ((size_t)b * N * N + (size_t)i * N) * P;

  auto store = [&](int c, float x) {  // column c of s_agg[b, i] | v_agg[b, i]
    if (c < S) p.s_agg[(size_t)(b * N + i) * S + c] = NT::st(x);
    else p.v_agg[(size_t)(b * N + i) * V3 + c - S] = NT::st(x);
  };

  // ---- the targets to compute: j with EM(i, j) != 0, ascending; every
  // warp counts them, warp 0 lists them (the first tile's barrier publishes
  // the list) ----
  const int lane = threadIdx.x % 32;
  int kept = 0;
  for (int jw = 0; jw < N; jw += 32) {
    const int j = jw + lane;
    const bool keep = j < N && NT::ld(ep_i[(size_t)j * P + Se + 3 * Ve + 9]) != 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep && threadIdx.x < 32) KEPT[kept + __popc(ballot & ((1u << lane) - 1u))] = j;
    kept += __popc(ballot);
  }
  PHASE_ROWS(kept / ROWS * ROWS + (kept % ROWS + RPT - 1) / RPT * RPT, N);
  if (kept == 0) {  // no target (a padded node): the sums are zero
    for (int c = threadIdx.x; c < S + V3; c += blockDim.x) store(c, 0.f);
    return;
  }
  for (int c = threadIdx.x; c < S + V3; c += blockDim.x) AGG[c] = 0.f;

  for (int j0 = 0; j0 < kept; j0 += ROWS) {
    const int nrows = min(ROWS, kept - j0);
    const int* J = KEPT + j0;  // this tile's targets
    __syncthreads();  // previous tile's aggregation has read every buffer
    PHASE_MARK();

    // ---- load the tile's edge rows (rows past nrows are zero) ----
    for (int idx = threadIdx.x; idx < ROWS * P; idx += blockDim.x) {
      const int r = idx / P, q = idx % P;
      const float val = r < nrows ? NT::ld(ep_i[(size_t)J[r] * P + q]) : 0.f;
      if (q < Se) A[r * L.lda + q] = val;
      else if (q < Se + 3 * Ve) X[r * L.ldx + q - Se] = val;
      else if (q < Se + 3 * Ve + 9) FT[r * 12 + q - Se - 3 * Ve] = val;
      else if (q == Se + 3 * Ve + 9) EM[r] = val;
    }
    __syncthreads();
    PHASE_MARK();

    // ---- GCP1: vh | vdf = proj_i + proj_j + xi @ wve ----
    tile_mm<RPT>(X, L.ldx, nrows, 3 * Ve, p.wve, W1, [&](int r, int c, float acc) {
      const float pj = r < nrows ? NT::ld(pj0[(size_t)J[r] * PW + S + c]) : 0.f;
      Hb[r * L.ldh + c] = (NT::ld(pi[S + c]) + pj) + acc;
    });
    __syncthreads();
    PHASE_MARK();
    norms_and_frames<ROWS, T>(Hb, L.ldh, FT, A + Se, L.lda, H1);
    __syncthreads();
    PHASE_MARK();
    // s2 = proj_i + proj_j + [e | vnorm | schid] @ wsx + bs
    wide_mm<4, RPT>(A, L.lda, nrows, Se + H1 + 9, p.wsx, S, [&](int r, int c, float acc) {
      const float pj = r < nrows ? NT::ld(pj0[(size_t)J[r] * PW + c]) : 0.f;
      const float s2 = (NT::ld(pi[c]) + pj) + (acc + NT::ld(p.bs1[c]));
      X[r * L.ldx + c] = NT::rnd(s2 * sigmoid_f(s2));
    });
    __syncthreads();
    PHASE_MARK();
    wide_mm<1, 4>(X, L.ldx, nrows, S, p.wg1, V, [&](int r, int c, float acc) {
      Gt[r * L.ldg + c] = NT::rnd(sigmoid_f(acc + NT::ld(p.bg1[c])));
    });
    __syncthreads();
    PHASE_MARK();
    tile_mm<RPT>(Hb, L.ldh, nrows, 3 * H1, p.wu1, V3, [&](int r, int c, float acc) {
      Vb[r * L.ldv + c] = NT::rnd(NT::rnd(acc) * Gt[r * L.ldg + c % V]);
    });
    for (int idx = threadIdx.x; idx < ROWS * S; idx += blockDim.x) {
      const int r = idx / S, c = idx % S;
      A[r * L.lda + c] = X[r * L.ldx + c];
    }
    __syncthreads();
    PHASE_MARK();

    // ---- residual chain of GCP2 stages, then attention x edge mask ----
    const ChainTile tile{A, Vb, Hb, X, Gt, FT, L.lda, L.ldv, L.ldh, L.ldx, L.ldg};
    for (int g = 0; g < p.G; ++g) {
      chain_stage<ROWS, T>(tile, nrows, S, V, Hc, p.wcomb + (size_t)g * V3 * Wc,
                           p.wsc + (size_t)g * (S + Hc + 9) * S, p.bsc + (size_t)g * S,
                           p.wubd + (size_t)g * 3 * Hc * V3, p.wgc + (size_t)g * S * V,
                           p.bgc + (size_t)g * V);
    }
    attention_scale<T>(A, L.lda, nrows, S, p.wattn, p.battn, EM, SC);
    __syncthreads();
    PHASE_MARK();

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
  PHASE_MARK();
  for (int c = threadIdx.x; c < S + V3; c += blockDim.x) store(c, AGG[c]);
  PHASE_MARK();
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
  const size_t smem = sizeof(float) * ((size_t)L.tile_floats() + S + 3 * V) + sizeof(int) * N;
  cudaError_t err = cudaFuncSetAttribute(message_layer_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  message_layer_kernel<T><<<dim3(N, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at these widths and N
// nodes a molecule.
int message_layer_smem_bytes(int S, int V, int Se, int Ve, int H1, int Hc, int N) {
  const Layout L(S, V, Se, Ve, H1, Hc);
  return (int)(sizeof(float) * ((size_t)L.tile_floats() + S + 3 * V) + sizeof(int) * N);
}

// Blocks of the float32 (bf16 == 0) or bf16 kernel that one SM holds at
// `smem` bytes of dynamic shared memory each; a negative CUDA error code on
// failure.
int message_layer_blocks_per_sm(int bf16, int smem) {
  return bf16 ? blocks_per_sm(message_layer_kernel<__nv_bfloat16>, THREADS, smem)
              : blocks_per_sm(message_layer_kernel<float>, THREADS, smem);
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

#ifdef PHASE_PROBE
// The phase probe's counters (see message_layer_common.cuh): copy out, zero.
int phases_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
}
int phases_reset() {
  static const unsigned long long zero[PHASE_SLOTS] = {};
  return (int)cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
