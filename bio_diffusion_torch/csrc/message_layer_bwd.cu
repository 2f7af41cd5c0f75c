// Backward of one GCPNet message-passing layer, for Hopper (sm_90a).
//
// Replaces: bio_diffusion_tpu/ops/pallas/gcp_kernel.py::fused_message_layer_bwd
// (Pallas body _message_layer_bwd_kernel).  Given the cotangents of the
// aggregated messages (d_s_agg [B,N,S], d_v_agg [B,N,3V]) it recomputes the
// forward of every edge row (i, j) -- GCP1 over [s_i | e_ij | s_j], the
// residual GCP2 stages, the sigmoid attention -- walks the stages in reverse
// and emits, in one launch sequence:
//   * d_epack [B, N*N, P]: d_e | d_xi | d_frames | d_emask per edge row;
//   * d_proj_i / d_proj_j [B, N, S+3H1+27] (f32): the cotangents of the node
//     projections s@wsi | v@wvi and s@wsj | v@wvj summed over targets j and
//     over sources i (the wrapper turns them into node and wsi/wsj/wvi/wvj
//     grads with O(B N S^2) products, as the TPU wrapper does);
//   * every edge-row weight grad in f32: GCP1 wve, wsx, bs, wu_bd, wg, bg;
//     chain w_comb, wsc, bsc, wu_bd, wgc, bgc, wattn, battn.
//
// What bounds it on an H100.  At QM9 width one edge row costs 297,776 MAC to
// recompute the forward, 297,776 MAC for the input cotangents and 299,185 MAC
// for its share of the weight grads (block-diagonal zeros included), so one
// layer at B=64, N=29 (53,824 rows) is ~96 GFLOP of FMA work: compute-bound,
// ~1.4 ms at the f32 FMA peak.  Two things do not fit the forward's design.
// (1) The reverse walk needs every stage's internals (vhd, root, s2, gate,
// vu: ~1.8k f32 per row at QM9 width) plus the operands of the weight grads
// (~4.3k f32 per row): ~24 KB per row, so the 227 KB of shared memory would
// hold fewer than 10 rows.  (2) The weight grads (~0.3 M f32 per layer) and
// d_proj_j are sums over rows that belong to different blocks.
//
// What the design does about it.
//   1. bwd_rows_kernel (0.96 ms of f32 FMA work at B=64, N=29): one block
//      per (molecule b, source node i), targets j in tiles of ROWS=16 rows.
//      The tile's running state (s, v, ds, dv and each product's output)
//      stays in shared memory; the stage internals and the weight-grad
//      operands go to a per-row scratch in device memory (written once, read
//      back by the same block and by the kernels below).  Every backward
//      product reads a weight transposed once by the wrapper.  What holds it
//      back (cli/kernel_phases.py --kernel bwd) is weight traffic, not FMAs:
//      every block reads all ~0.6 M weights once per 16-row tile (~8.8 GB
//      per layer at B=64, N=29), and with one column a thread (tile_mm)
//      each weight reached the block from L2 once per row group, the thin
//      products (a gate's 32 columns) leaving most threads idle.  So every
//      product runs on tile_rm: the weight is staged in shared memory in
//      slabs by cp.async, the next slab in flight while the current one is
//      multiplied, and each thread owns R rows by 4 columns, R chosen per
//      product so the thin ones keep the threads busy; k order of the
//      one-column loop, so float32 results are unchanged to the bit.  In
//      bf16 the recompute's four wide products run on the tensor cores as
//      the forward's do (tile_mma), so the backward recomputes the forward
//      that ran; its own products stay f32.  Registers (128 a thread) and
//      shared memory (~110 KB with the weight stage) hold it to 2 blocks per
//      SM.
//   2. weight_grad_kernel (0.48 ms of f32 FMA work, ~0.9 GB of scratch
//      columns): X^T dY for every weight at once, a list of problems in one
//      launch, rows split into fixed chunks, one partial per chunk.  A
//      register-tiled SGEMM: each problem's output tile shape is chosen from
//      128x64 (8x4 accumulators a thread) down to 32x64 so that the padded
//      work stays within ~1.08x the real (a 273-row product as 256 + 17, the
//      bias sums folded into the first row of tiles); the next 16-row block
//      of X and dY is loaded into registers while the current one is
//      multiplied out of shared memory; the one-column attention weight and
//      its bias are column sums of their own.  The chunks' partials are
//      summed in the same launch: a tile's chunks run side by side (grid
//      x), each block takes an integer ticket after its partial (fenced),
//      and the last one sums the tile's partials in chunk order from L2 and
//      writes the grads, or adds them onto a previous chunk of molecules'.
//      No second launch and no second pass over the partials.  The sums
//      read everything afresh after the ticket, so the GEMM loop keeps its
//      80 registers (3 blocks an SM); written inside the tile's code they
//      took 101 (2 an SM, ~10% slower).
//   3. proj_sum_kernel: d_proj_i and d_proj_j as fixed-order sums over
//      GCP1's cotangent columns of the scratch (~79 MB per layer at B=64,
//      N=29, bytes-bound).  One pass: a block per (molecule, slab of
//      columns) walks the source nodes in groups, each group's tiles of N
//      target rows coming in by 16-byte cp.async with the next two groups in
//      flight, summed over the targets for d_proj_i (128 threads, one a
//      (tile, column)) and added into d_proj_j kept in shared memory, so
//      every element crosses HBM once, not once for each of the two sums.
//      It runs last, when the row kernel's dirty lines have left L2.
// No float atomics: two runs give bit-identical results.
//
// Numerics follow the TPU kernel: the recompute rounds to the compute dtype
// where the forward does; the backward accumulates in f32 (the stage caches
// hold the f32 values the TPU kernel keeps: unrounded vhd, s2, gate and
// chain vu) and casts only d_epack to the compute dtype.

#include "message_layer_common.cuh"

namespace {

constexpr int ROWS = 16;      // target rows per tile
constexpr int THREADS = 256;  // threads per block of the row kernel
constexpr int MAXP = 64;      // weight-grad problems: at most 2 (4 + 4 G) + 2, G <= 6
constexpr int WG_RB = 16;     // weight-grad row block

struct Dims {
  int B, N, P, S, V, Se, Ve, H1, Hc, G;
};

// Per-edge-row scratch in device memory (floats).  Left operands of weight
// grads (xi, cat1, silu1, vin, merged, silu, sfin), their right operands (the
// d* columns) and the forward values the reverse walk reads back (vhd, root,
// s2, gate, vu, attn).  The stage-g block starts at stage0 + g * stage_w.
struct RowLayout {
  int xi, cat1, silu1, dvhd1, ds2_1, dvu1, dzg1, vhd1, root1, s2_1, gate1, vu1;
  int stage0, stage_w;
  int vin, merged, silu, dvhd, ds2, dvu, dzg, vhd, root, s2, gate, vu;
  int sfin, attn, dzattn;
  int width;
  RowLayout() = default;
  __host__ __device__ explicit RowLayout(const Dims& d) {
    const int S = d.S, V3 = 3 * d.V, W1 = 3 * d.H1 + 27, Wc = 3 * d.Hc + 27;
    int o = 0;
    xi = o; o += 3 * d.Ve;
    cat1 = o; o += d.Se + d.H1 + 9;
    silu1 = o; o += S;
    dvhd1 = o; o += W1;
    ds2_1 = o; o += S;
    dvu1 = o; o += V3;
    dzg1 = o; o += d.V;
    vhd1 = o; o += W1;
    root1 = o; o += d.H1;
    s2_1 = o; o += S;
    gate1 = o; o += d.V;
    vu1 = o; o += V3;
    int q = 0;
    vin = q; q += V3;
    merged = q; q += S + d.Hc + 9;
    silu = q; q += S;
    dvhd = q; q += Wc;
    ds2 = q; q += S;
    dvu = q; q += V3;
    dzg = q; q += d.V;
    vhd = q; q += Wc;
    root = q; q += d.Hc;
    s2 = q; q += S;
    gate = q; q += d.V;
    vu = q; q += V3;
    stage0 = o; stage_w = q; o += d.G * q;
    sfin = o; o += S;
    attn = o; o += 1;
    dzattn = o; o += 1;
    width = round4(o);
  }
};

// Shared-memory strides (floats) of the row kernel's per-tile buffers.
struct SmemLayout {
  int lda, ldv, ldh, ldx, ldg, lds, wsf;
  SmemLayout() = default;
  __host__ __device__ explicit SmemLayout(const Dims& d) {
    const int a = d.S + d.Hc + 9, a1 = d.Se + d.H1 + 9;
    lda = mma_stride(a > a1 ? a : a1);
    ldv = round4(3 * d.V);
    const int h = 3 * d.H1 + 27, hc = 3 * d.Hc + 27;
    ldh = round4(h > hc ? h : hc);
    ldx = mma_stride(d.S > 3 * d.Ve ? d.S : 3 * d.Ve);
    ldg = round4(d.V);
    lds = round4(d.S);
    // tile_rm's weight stage: two buffers of 16 rows of the widest f32 weight
    const int w[] = {d.S, a, a1, h, 3 * d.Ve, 3 * d.V, 3 * d.H1, 3 * d.Hc};
    int widest = 0;
    for (int x : w) widest = x > widest ? x : widest;
    wsf = 32 * round4(widest);
  }
  __host__ __device__ int floats(const Dims& d) const {
    return ROWS * (lda + 2 * ldv + ldh + ldx + ldg + lds + 12 + 12 + 4) + round4(d.S) +
           round4(3 * d.V) + wsf;
  }
};

template <typename T>
struct BwdParams {
  const T *proj_i, *proj_j, *epack, *ds_agg, *dv_agg;
  const T *wve, *wsx, *bs1, *wu1, *wg1, *bg1, *wcomb, *wsc, *bsc, *wubd, *wgc, *bgc, *wattn,
      *battn;
  // transposed weights of the backward products: [out, in] of the forward
  const T *wveT, *wsxT, *wu1T, *wg1T, *wcombT, *wscT, *wubdT, *wgcT;
  T* d_epack;
  float* rows;
  Dims d;
  RowLayout rl;   // computed once on the host: the kernel reads the offsets from
  SmemLayout sl;  // the parameter bank instead of holding them in registers
};

// Forward norms and frame scalarization of a stage's projected vectors H
// (as in message_layer.cu), for rows < nrows: dst[r, q] = rounded safe_norm
// (q < hd) or scalarized column (hd <= q < hd+9); the root sqrt(sum + 1e-8)
// goes to the row scratch at root_off, the unrounded values to raw_off (if
// >= 0); the vh part of H is rounded in place.
template <typename T, typename RowFn>
__device__ __forceinline__ void norms_fwd(float* H, int ldh, const float* FT, float* dst, int ldd,
                                          int hd, int nrows, RowFn row, int root_off,
                                          int raw_off) {
  const int w = hd + 9;
  for (int idx = threadIdx.x; idx < nrows * w; idx += blockDim.x) {
    const int r = idx / w, q = idx % w;
    float* h = H + r * ldh;
    float* rp = row(r);
    float out;
    if (q < hd) {
      const float a = h[q], b = h[hd + q], c = h[2 * hd + q];
      const float root = sqrtf(a * a + b * b + c * c + 1e-8f);
      rp[root_off + q] = root;
      out = root + 1e-8f;
      h[q] = Num<T>::rnd(a);
      h[hd + q] = Num<T>::rnd(b);
      h[2 * hd + q] = Num<T>::rnd(c);
    } else {
      const int qq = q - hd, a = qq % 3;
      const float* f = FT + r * 12;
      const float* vd = h + 3 * hd + qq;
      out = vd[0] * f[a] + vd[9] * f[3 + a] + vd[18] * f[6 + a];
    }
    if (raw_off >= 0) rp[raw_off + q] = out;
    dst[r * ldd + q] = Num<T>::rnd(out);
  }
}

// Backward of the norms and the scalarization.  On entry H[r, :3hd] holds
// the cotangent of vh through the up-projection; D[r, q] (q < hd) d_vnorm and
// D[r, hd + m] (m < 9) d_schid.  On exit H[r, :3hd+27] holds d_vhd (also
// written to the row scratch at out_off) and DFT[r, 3k+a] has gained
// sum_c d_schid[c*3+a] * vdf_k[c*3+a].
template <typename RowFn>
__device__ __forceinline__ void norms_bwd(float* H, int ldh, const float* D, int ldd,
                                          const float* FT, float* DFT, int hd, int nrows,
                                          RowFn row, int vhd_off, int root_off, int out_off) {
  const int w = 3 * hd + 27;
  for (int idx = threadIdx.x; idx < nrows * w; idx += blockDim.x) {
    const int r = idx / w, c = idx % w;
    float* rp = row(r);
    const float* d = D + r * ldd;
    float g;
    if (c < 3 * hd) {
      const int q = c % hd;
      const float dq = d[q] * (0.5f / rp[root_off + q]);
      g = 2.f * rp[vhd_off + c] * dq + H[r * ldh + c];
    } else {
      const int m = c - 3 * hd, k = m / 9, cc = m % 9;
      g = d[hd + cc] * FT[r * 12 + 3 * k + cc % 3];
    }
    H[r * ldh + c] = g;
    rp[out_off + c] = g;
  }
  for (int idx = threadIdx.x; idx < nrows * 9; idx += blockDim.x) {
    const int r = idx / 9, t = idx % 9, k = t / 3, a = t % 3;
    const float* rp = row(r) + vhd_off + 3 * hd + 9 * k;
    const float* d = D + r * ldd + hd;
    DFT[r * 12 + t] += d[a] * rp[a] + d[3 + a] * rp[3 + a] + d[6 + a] * rp[6 + a];
  }
}

// The recompute's four wide products (wsx, wsc, the gates): on the tensor
// cores in the bf16 instantiation (tile_mma, NPW n8 tiles per warp: the
// forward kernel's engine, so the recompute rounds as the forward does), on
// 2-D register tiles of R rows in float32.  Every other product of the row
// kernel runs on 2-D register tiles (tile_rm) in both.
template <int NPW, int R, typename T, typename Epi>
__device__ __forceinline__ void recompute_mm(const float* in, int ldi, int nrows, int K, const T* W,
                                             int ncols, float* WS, int wsf, Epi epi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    tile_mma<NPW>(in, ldi, nrows, K, W, ncols, epi);
  } else {
    tile_rm<R>(in, ldi, nrows, K, W, ncols, WS, wsf, epi);
  }
}

__device__ __forceinline__ float silu_grad(float x, float sig) {
  return sig * (1.f + x * (1.f - sig));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
bwd_rows_kernel(const BwdParams<T> p) {
  using NT = Num<T>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Dims& d = p.d;
  const SmemLayout& L = p.sl;
  const RowLayout& RL = p.rl;
  const int lda = L.lda, ldv = L.ldv, ldh = L.ldh, ldx = L.ldx, ldg = L.ldg, lds = L.lds;
  float* A = smem;                // cat1 / s state, vnorm, schid; backward d_cat1 / d_merged
  float* Vb = A + ROWS * lda;     // v state; backward dv
  float* Hb = Vb + ROWS * ldv;    // vhd; backward d_vhd
  float* X = Hb + ROWS * ldh;     // xi, silu; backward d_s2
  float* Gt = X + ROWS * ldx;     // gates; backward d_zg
  float* DS = Gt + ROWS * ldg;    // backward ds
  float* DVU = DS + ROWS * lds;   // backward d_vu
  float* FT = DVU + ROWS * ldv;   // transposed frames [9] (stride 12)
  float* DFT = FT + ROWS * 12;    // d_frames [9] (stride 12)
  float* RS = DFT + ROWS * 12;    // per row: attn, d_z_attn, d_emask
  float* DSO = RS + ROWS * 4;     // d_s_agg[b, i]
  float* DVO = DSO + round4(d.S); // d_v_agg[b, i]
  float* WS = DVO + round4(3 * d.V);  // tile_rm's weight stage (L.wsf floats)
  const int wsf = L.wsf;

  const int i = blockIdx.x, b = blockIdx.y;
  PHASE_START();
  const int N = d.N, S = d.S, V = d.V, Se = d.Se, Ve = d.Ve, H1 = d.H1, Hc = d.Hc, P = d.P;
  const int V3 = 3 * V, W1 = 3 * H1 + 27, Wc = 3 * Hc + 27, PW = S + W1, M1 = S + Hc + 9;
  const T* pi = p.proj_i + (size_t)(b * N + i) * PW;
  const T* pj0 = p.proj_j + (size_t)b * N * PW;
  const T* ep_i = p.epack + ((size_t)b * N * N + (size_t)i * N) * P;
  T* dep_i = p.d_epack + ((size_t)b * N * N + (size_t)i * N) * P;

  for (int c = threadIdx.x; c < S; c += blockDim.x) DSO[c] = NT::ld(p.ds_agg[(size_t)(b * N + i) * S + c]);
  for (int c = threadIdx.x; c < V3; c += blockDim.x) DVO[c] = NT::ld(p.dv_agg[(size_t)(b * N + i) * V3 + c]);

  for (int j0 = 0; j0 < N; j0 += ROWS) {
    const int nrows = min(ROWS, N - j0);
    const size_t row0 = ((size_t)b * N + i) * N + j0;
    auto row = [&](int r) { return p.rows + (row0 + r) * RL.width; };
    PHASE_FOLD();
    __syncthreads();  // the previous tile is done with every buffer
    PHASE_MARK();

    // ---- load the tile's edge rows ----
    for (int idx = threadIdx.x; idx < nrows * P; idx += blockDim.x) {
      const int r = idx / P, q = idx % P;
      const float val = NT::ld(ep_i[(size_t)(j0 + r) * P + q]);
      if (q < Se) {
        A[r * lda + q] = val;
        row(r)[RL.cat1 + q] = val;
      } else if (q < Se + 3 * Ve) {
        X[r * ldx + q - Se] = val;
        row(r)[RL.xi + q - Se] = val;
      } else if (q < Se + 3 * Ve + 9) {
        FT[r * 12 + q - Se - 3 * Ve] = val;
      }
    }
    __syncthreads();
    PHASE_MARK();

    // ================= forward recompute =================
    tile_rm<2>(X, ldx, nrows, 3 * Ve, p.wve, W1, WS, wsf, [&](int r, int c, float acc) {
      if (r >= nrows) return;
      const float v = (NT::ld(pi[S + c]) + NT::ld(pj0[(size_t)(j0 + r) * PW + S + c])) + acc;
      Hb[r * ldh + c] = v;
      row(r)[RL.vhd1 + c] = v;
    });
    __syncthreads();
    PHASE_MARK();
    norms_fwd<T>(Hb, ldh, FT, A + Se, lda, H1, nrows, row, RL.root1, RL.cat1 + Se);
    __syncthreads();
    PHASE_MARK();
    recompute_mm<4, 4>(A, lda, nrows, Se + H1 + 9, p.wsx, S, WS, wsf, [&](int r, int c, float acc) {
      if (r >= nrows) return;
      const float s2 = ((NT::ld(pi[c]) + NT::ld(pj0[(size_t)(j0 + r) * PW + c])) + acc) +
                       NT::ld(p.bs1[c]);
      float* rp = row(r);
      rp[RL.s2_1 + c] = s2;
      const float silu = NT::rnd(s2 * sigmoid_f(s2));
      X[r * ldx + c] = silu;
      rp[RL.silu1 + c] = silu;
    });
    __syncthreads();
    PHASE_MARK();
    recompute_mm<1, 1>(X, ldx, nrows, S, p.wg1, V, WS, wsf, [&](int r, int c, float acc) {
      if (r >= nrows) return;
      const float g = sigmoid_f(acc + NT::ld(p.bg1[c]));
      row(r)[RL.gate1 + c] = g;
      Gt[r * ldg + c] = NT::rnd(g);
    });
    __syncthreads();
    PHASE_MARK();
    tile_rm<2>(Hb, ldh, nrows, 3 * H1, p.wu1, V3, WS, wsf, [&](int r, int c, float acc) {
      if (r >= nrows) return;
      const float vu = NT::rnd(acc);
      row(r)[RL.vu1 + c] = vu;
      Vb[r * ldv + c] = NT::rnd(vu * Gt[r * ldg + c % V]);
    });
    for (int idx = threadIdx.x; idx < nrows * S; idx += blockDim.x) {
      const int r = idx / S, c = idx % S;
      A[r * lda + c] = X[r * ldx + c];
    }
    __syncthreads();
    PHASE_MARK();

    for (int g = 0; g < d.G; ++g) {
      const int sb = RL.stage0 + g * RL.stage_w;
      for (int idx = threadIdx.x; idx < nrows * V3; idx += blockDim.x) {
        const int r = idx / V3, c = idx % V3;
        row(r)[sb + RL.vin + c] = Vb[r * ldv + c];
      }
      tile_rm<1>(Vb, ldv, nrows, V3, p.wcomb + (size_t)g * V3 * Wc, Wc, WS, wsf, [&](int r, int c, float acc) {
                     if (r >= nrows) return;
                     Hb[r * ldh + c] = acc;
                     row(r)[sb + RL.vhd + c] = acc;
                   });
      __syncthreads();
      PHASE_MARK();
      norms_fwd<T>(Hb, ldh, FT, A + S, lda, Hc, nrows, row, sb + RL.root, -1);
      __syncthreads();
      PHASE_MARK();
      for (int idx = threadIdx.x; idx < nrows * M1; idx += blockDim.x) {
        const int r = idx / M1, c = idx % M1;
        row(r)[sb + RL.merged + c] = A[r * lda + c];
      }
      const T* bsc = p.bsc + (size_t)g * S;
      recompute_mm<4, 4>(A, lda, nrows, M1, p.wsc + (size_t)g * M1 * S, S, WS, wsf, [&](int r, int c, float acc) {
        if (r >= nrows) return;
        const float s2 = acc + NT::ld(bsc[c]);
        float* rp = row(r);
        rp[sb + RL.s2 + c] = s2;
        const float silu = NT::rnd(s2 * sigmoid_f(s2));
        X[r * ldx + c] = silu;
        rp[sb + RL.silu + c] = silu;
      });
      __syncthreads();
      PHASE_MARK();
      const T* bgc = p.bgc + (size_t)g * V;
      recompute_mm<1, 1>(X, ldx, nrows, S, p.wgc + (size_t)g * S * V, V, WS, wsf, [&](int r, int c, float acc) {
        if (r >= nrows) return;
        const float gf = sigmoid_f(acc + NT::ld(bgc[c]));
        row(r)[sb + RL.gate + c] = gf;
        Gt[r * ldg + c] = NT::rnd(gf);
      });
      __syncthreads();
      PHASE_MARK();
      tile_rm<2>(Hb, ldh, nrows, 3 * Hc, p.wubd + (size_t)g * 3 * Hc * V3, V3, WS, wsf, [&](int r, int c, float acc) {
                     if (r >= nrows) return;
                     row(r)[sb + RL.vu + c] = acc;
                     float* v = Vb + r * ldv + c;
                     *v = NT::rnd(*v + NT::rnd(NT::rnd(acc) * Gt[r * ldg + c % V]));
                   });
      for (int idx = threadIdx.x; idx < nrows * S; idx += blockDim.x) {
        const int r = idx / S, c = idx % S;
        A[r * lda + c] = NT::rnd(A[r * lda + c] + X[r * ldx + c]);
      }
      __syncthreads();
      PHASE_MARK();
    }

    // attention logit (unrounded, as the TPU backward keeps it); s_fin to scratch
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
    for (int r = warp; r < nrows; r += nwarps) {
      float acc = 0.f;
      for (int k = lane; k < S; k += 32) acc = fmaf(A[r * lda + k], NT::ld(p.wattn[k]), acc);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const float attn = sigmoid_f(acc + NT::ld(p.battn[0]));
        RS[r * 4] = attn;
        row(r)[RL.attn] = attn;
      }
    }
    for (int idx = threadIdx.x; idx < nrows * S; idx += blockDim.x) {
      const int r = idx / S, c = idx % S;
      row(r)[RL.sfin + c] = A[r * lda + c];
    }
    __syncthreads();
    PHASE_MARK();

    // ================= backward =================
    // attention and the mask: d_z_attn, d_emask per row
    for (int r = warp; r < nrows; r += nwarps) {
      const float em = NT::ld(ep_i[(size_t)(j0 + r) * P + Se + 3 * Ve + 9]);
      const float attn = RS[r * 4];
      float a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int c = lane; c < S; c += 32) {
        const float t = DSO[c] * A[r * lda + c];
        a1 += t * em;
        a2 += t * attn;
      }
      for (int m = lane; m < V3; m += 32) a3 += DVO[m] * Vb[r * ldv + m];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        a1 += __shfl_xor_sync(0xffffffffu, a1, off);
        a2 += __shfl_xor_sync(0xffffffffu, a2, off);
        a3 += __shfl_xor_sync(0xffffffffu, a3, off);
      }
      if (lane == 0) {
        const float dz = a1 * attn * (1.f - attn);
        RS[r * 4 + 1] = dz;
        RS[r * 4 + 2] = a2 + a3;
        RS[r * 4 + 3] = em;
        row(r)[RL.dzattn] = dz;
      }
    }
    __syncthreads();
    PHASE_MARK();
    for (int idx = threadIdx.x; idx < nrows * S; idx += blockDim.x) {
      const int r = idx / S, c = idx % S;
      DS[r * lds + c] = DSO[c] * RS[r * 4] * RS[r * 4 + 3] + RS[r * 4 + 1] * NT::ld(p.wattn[c]);
    }
    for (int idx = threadIdx.x; idx < nrows * V3; idx += blockDim.x) {
      const int r = idx / V3, m = idx % V3;
      Vb[r * ldv + m] = DVO[m] * RS[r * 4 + 3];
    }
    for (int idx = threadIdx.x; idx < nrows * 9; idx += blockDim.x) DFT[(idx / 9) * 12 + idx % 9] = 0.f;
    __syncthreads();
    PHASE_MARK();

    // chain stages in reverse
    for (int g = d.G - 1; g >= 0; --g) {
      const int sb = RL.stage0 + g * RL.stage_w;
      for (int idx = threadIdx.x; idx < nrows * V; idx += blockDim.x) {
        const int r = idx / V, c = idx % V;
        float* rp = row(r);
        const float* dv = Vb + r * ldv;
        const float gt = rp[sb + RL.gate + c];
        const float dg = dv[c] * rp[sb + RL.vu + c] + dv[V + c] * rp[sb + RL.vu + V + c] +
                         dv[2 * V + c] * rp[sb + RL.vu + 2 * V + c];
        const float dzg = dg * gt * (1.f - gt);
        Gt[r * ldg + c] = dzg;
        rp[sb + RL.dzg + c] = dzg;
      }
      for (int idx = threadIdx.x; idx < nrows * V3; idx += blockDim.x) {
        const int r = idx / V3, m = idx % V3;
        float* rp = row(r);
        const float du = Vb[r * ldv + m] * rp[sb + RL.gate + m % V];
        DVU[r * ldv + m] = du;
        rp[sb + RL.dvu + m] = du;
      }
      __syncthreads();
      PHASE_MARK();
      tile_rm<4>(Gt, ldg, nrows, V, p.wgcT + (size_t)g * V * S, S, WS, wsf, [&](int r, int c, float acc) {
        if (r >= nrows) return;
        float* rp = row(r);
        const float s2 = rp[sb + RL.s2 + c];
        const float ds2 = (DS[r * lds + c] + acc) * silu_grad(s2, sigmoid_f(s2));
        X[r * ldx + c] = ds2;
        rp[sb + RL.ds2 + c] = ds2;
      });
      __syncthreads();
      PHASE_MARK();
      tile_rm<8>(X, ldx, nrows, S, p.wscT + (size_t)g * S * M1, M1, WS, wsf, [&](int r, int c, float acc) {
        if (r >= nrows) return;
        if (c < S) DS[r * lds + c] += acc;
        else A[r * lda + c] = acc;
      });
      tile_rm<1>(DVU, ldv, nrows, V3, p.wubdT + (size_t)g * V3 * 3 * Hc, 3 * Hc, WS, wsf, [&](int r, int c, float acc) {
                     if (r < nrows) Hb[r * ldh + c] = acc;
                   });
      __syncthreads();
      PHASE_MARK();
      norms_bwd(Hb, ldh, A + S, lda, FT, DFT, Hc, nrows, row, sb + RL.vhd, sb + RL.root,
                sb + RL.dvhd);
      __syncthreads();
      PHASE_MARK();
      tile_rm<2>(Hb, ldh, nrows, Wc, p.wcombT + (size_t)g * Wc * V3, V3, WS, wsf, [&](int r, int c, float acc) {
                     if (r < nrows) Vb[r * ldv + c] += acc;
                   });
      __syncthreads();
      PHASE_MARK();
    }

    // GCP1
    for (int idx = threadIdx.x; idx < nrows * V; idx += blockDim.x) {
      const int r = idx / V, c = idx % V;
      float* rp = row(r);
      const float* dv = Vb + r * ldv;
      const float gt = rp[RL.gate1 + c];
      const float dg = dv[c] * rp[RL.vu1 + c] + dv[V + c] * rp[RL.vu1 + V + c] +
                       dv[2 * V + c] * rp[RL.vu1 + 2 * V + c];
      const float dzg = dg * gt * (1.f - gt);
      Gt[r * ldg + c] = dzg;
      rp[RL.dzg1 + c] = dzg;
    }
    for (int idx = threadIdx.x; idx < nrows * V3; idx += blockDim.x) {
      const int r = idx / V3, m = idx % V3;
      float* rp = row(r);
      const float du = Vb[r * ldv + m] * NT::rnd(rp[RL.gate1 + m % V]);
      DVU[r * ldv + m] = du;
      rp[RL.dvu1 + m] = du;
    }
    __syncthreads();
    PHASE_MARK();
    tile_rm<4>(Gt, ldg, nrows, V, p.wg1T, S, WS, wsf, [&](int r, int c, float acc) {
      if (r >= nrows) return;
      float* rp = row(r);
      const float s2 = rp[RL.s2_1 + c];
      const float ds2 = (DS[r * lds + c] + acc) * silu_grad(s2, sigmoid_f(s2));
      X[r * ldx + c] = ds2;
      rp[RL.ds2_1 + c] = ds2;
    });
    __syncthreads();
    PHASE_MARK();
    tile_rm<2>(X, ldx, nrows, S, p.wsxT, Se + H1 + 9, WS, wsf, [&](int r, int c, float acc) {
      if (r >= nrows) return;
      A[r * lda + c] = acc;
      if (c < Se) dep_i[(size_t)(j0 + r) * P + c] = NT::st(acc);
    });
    tile_rm<1>(DVU, ldv, nrows, V3, p.wu1T, 3 * H1, WS, wsf, [&](int r, int c, float acc) {
      if (r < nrows) Hb[r * ldh + c] = acc;
    });
    __syncthreads();
    PHASE_MARK();
    norms_bwd(Hb, ldh, A + Se, lda, FT, DFT, H1, nrows, row, RL.vhd1, RL.root1, RL.dvhd1);
    __syncthreads();
    PHASE_MARK();
    tile_rm<1>(Hb, ldh, nrows, W1, p.wveT, 3 * Ve, WS, wsf, [&](int r, int c, float acc) {
      if (r < nrows) dep_i[(size_t)(j0 + r) * P + Se + c] = NT::st(acc);
    });
    for (int idx = threadIdx.x; idx < nrows * 10; idx += blockDim.x) {
      const int r = idx / 10, t = idx % 10;
      const float v = t < 9 ? DFT[r * 12 + t] : RS[r * 4 + 2];
      dep_i[(size_t)(j0 + r) * P + Se + 3 * Ve + t] = NT::st(v);
    }
    PHASE_MARK();  // thread 0's end of the tile; the rest shows at the next barrier
  }
}

// d_proj_i[b, i, c] = sum_j D[b, i, j, c] and d_proj_j[b, j, c] = sum_i
// D[b, i, j, c], where D is GCP1's cotangent columns in the row scratch
// (dvhd1 | ds2_1, W1 + S columns, one contiguous range) and the outputs take
// them as ds2_1 | dvhd1; every sum in index order from 0.f.  One block per
// (slab of columns, molecule b) walks the source nodes i in order, a group
// of G at a time: the tiles D[b, i, 0..N, slab] of a group come into shared
// memory by 16-byte cp.async, the next PS_STAGES - 1 groups in flight.  The
// first PS_CHAIN threads sum each tile over j (one thread a (tile, column),
// j ascending) into d_proj_i; the others add the group's tiles, i
// ascending, into the running d_proj_j[b, 0..N, slab], written once at the
// end.  So each element of the scratch crosses HBM once.  The slabs tile
// the aligned columns [a0, a0 + cols) (see ProjSumPlan); a slab column
// outside the cotangent range is loaded (or zero-filled past `cols`) and
// never written.
constexpr int PS_THREADS = 256;
constexpr int PS_CHAIN = 128;          // threads of the d_proj_i sums
constexpr int PS_STAGES = 3;           // groups in shared memory: two in flight
constexpr int PS_GROUP_BYTES = 65536;  // at most (or one tile) a group

struct ProjSumPlan {
  int a0;     // first scratch column of the slabs: dvhd1 rounded down to 8 (32-byte sectors)
  int shift;  // dvhd1 - a0
  int cols;   // round4(shift + W1 + S): the aligned columns the slabs read
  int sw;     // columns a slab, a multiple of 4, <= PS_CHAIN
  int slabs;  // ceil(cols / sw)
  int group;  // source nodes a group: G <= PS_CHAIN / sw tiles of N x sw floats
  size_t smem;
};

// The slab width: 32 columns where B x slabs gives at least two blocks an SM,
// else 16, else 8 (at B=64, N=29 QM9 takes 32: 704 blocks; a GEOM chunk of 19
// molecules at N=96 takes 16: 418; 4 molecules at N=192 take 8: 172).  The
// group: as many tiles as PS_CHAIN threads sum and PS_GROUP_BYTES hold (QM9
// at N=29: 4).
ProjSumPlan proj_sum_plan(const Dims& d, const RowLayout& RL, int sms) {
  ProjSumPlan ps;
  ps.a0 = RL.dvhd1 & ~7;
  ps.shift = RL.dvhd1 - ps.a0;
  ps.cols = round4(ps.shift + 3 * d.H1 + 27 + d.S);
  ps.sw = 32;
  while (ps.sw > 8 && (long long)d.B * ((ps.cols + ps.sw - 1) / ps.sw) < 2LL * sms) ps.sw /= 2;
  ps.slabs = (ps.cols + ps.sw - 1) / ps.sw;
  const int tile_bytes = (int)sizeof(float) * d.N * ps.sw;
  ps.group = PS_CHAIN / ps.sw;
  if (ps.group * tile_bytes > PS_GROUP_BYTES) ps.group = PS_GROUP_BYTES / tile_bytes > 1 ? PS_GROUP_BYTES / tile_bytes : 1;
  ps.smem = (size_t)tile_bytes * (PS_STAGES * ps.group + 1);
  return ps;
}

__global__ void __launch_bounds__(PS_THREADS) proj_sum_kernel(const float* __restrict__ rows, int width,
                                                              int N, int S, int W1, const ProjSumPlan ps,
                                                              float* __restrict__ d_proj_i,
                                                              float* __restrict__ d_proj_j) {
  extern __shared__ float4 ps_smem[];
  const int sw = ps.sw, q4 = sw / 4, tile = N * sw, G = ps.group, C = S + W1;
  float* tiles = reinterpret_cast<float*>(ps_smem);  // [PS_STAGES][G][N][sw]
  float* acc = tiles + PS_STAGES * G * tile;          // [N][sw]: d_proj_j so far
  const int c0 = blockIdx.x * sw, b = blockIdx.y, steps = (N + G - 1) / G;
  const float* src0 = rows + (size_t)b * N * N * width + ps.a0 + c0;
  auto load = [&](int s) {  // group s into its buffer; one commit group a call
    if (s < steps) {
      const int i0 = s * G, ng = min(G, N - i0);
      float* dst = tiles + (s % PS_STAGES) * G * tile;
      const float* src = src0 + (size_t)i0 * N * width;
      for (int e = threadIdx.x; e < ng * N * q4; e += PS_THREADS) {
        const int r = e / q4, q = 4 * (e % q4);  // row r = g * N + j of the group
        cp_async16(dst + r * sw + q, src + (size_t)r * width + q, c0 + q < ps.cols ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // slab column t holds cotangent column k = c0 + t - shift (dvhd1 first):
  // output column S + k (k < W1) or k - W1, -1 outside the range
  auto out_col = [&](int t) {
    const int k = c0 + t - ps.shift;
    return k < 0 || k >= C ? -1 : (k < W1 ? S + k : k - W1);
  };
  for (int e = threadIdx.x; e < tile; e += PS_THREADS) acc[e] = 0.f;
  for (int s = 0; s < PS_STAGES - 1; ++s) load(s);
  for (int s = 0; s < steps; ++s) {
    load(s + PS_STAGES - 1);  // into the buffer that group s - 1 left
    cp_async_wait<PS_STAGES - 1>();
    __syncthreads();
    const float* t = tiles + (s % PS_STAGES) * G * tile;
    const int i0 = s * G, ng = min(G, N - i0);
    if (threadIdx.x < PS_CHAIN) {
      for (int u = threadIdx.x; u < ng * sw; u += PS_CHAIN) {
        const int g = u / sw, c = u % sw, col = out_col(c);
        if (col < 0) continue;
        const float* x = t + g * tile + c;
        float sum = 0.f;
#pragma unroll 8
        for (int j = 0; j < N; ++j) sum += x[j * sw];
        d_proj_i[((size_t)b * N + i0 + g) * C + col] = sum;
      }
    } else {
      const float4* t4 = reinterpret_cast<const float4*>(t);
      float4* a4 = reinterpret_cast<float4*>(acc);
      for (int e = threadIdx.x - PS_CHAIN; e < N * q4; e += PS_THREADS - PS_CHAIN) {
        float4 a = a4[e];
        for (int g = 0; g < ng; ++g) {
          const float4 x = t4[g * (tile / 4) + e];
          a.x += x.x;
          a.y += x.y;
          a.z += x.z;
          a.w += x.w;
        }
        a4[e] = a;
      }
    }
    __syncthreads();  // group s's buffer is free for group s + PS_STAGES
  }
  for (int e = threadIdx.x; e < tile; e += PS_THREADS) {
    const int c = out_col(e % sw);
    if (c >= 0) d_proj_j[((size_t)b * N + e / sw) * C + c] = acc[e];
  }
}

// The weight grads as a list of problems over all edge rows of the scratch.
// A product C[k, n] = sum_r X[r, xoff + k] * Y[r, yoff + n] (k < K, n < Nn)
// is cut into output tiles of one of WG_SHAPES; with a bias (hb = 1) its
// first row of tiles also sums the Y columns, C[K, n] = sum_r Y[r, yoff + n].
// A column sum C[c] = sum_r X[r, xoff + c] * (yoff >= 0 ? Y[r, yoff] : 1)
// (c < K, Nn = 1: the attention weight's one column and its bias) is cut into
// tiles of 32 columns (WG_SUM).  A problem writes out[0 .. K*Nn) row-major
// and its bias to out_b[0 .. Nn).  Each tile's split partials lie together
// from partials[splits * (part0 + local * tile floats)], split by split.
struct WgProblem {
  int shape, xoff, K, hb, yoff, Nn, tile0, ntn, part0;
  float* out;
  float* out_b;
};

struct WgParams {
  const float* rows;
  size_t R;
  int width, splits, chunk, np;
  int accumulate;  // 1: out += the sums (a later chunk of molecules), 0: out = the sums
  float* partials;
  int* tickets;    // one counter a tile, 0 between launches
  WgProblem prob[MAXP];
};

// Output tiles (TK rows of C by TN columns) of the products: 256 threads as
// 16 x 16, a thread TK/16 rows by TN/16 columns of accumulators.
struct WgShape {
  int tk, tn;
};
constexpr WgShape WG_SHAPES[] = {{128, 64}, {128, 32}, {32, 128}, {64, 64}, {64, 32}, {32, 64}};
constexpr int WG_NSHAPES = sizeof(WG_SHAPES) / sizeof(WG_SHAPES[0]);
constexpr int WG_SUM = WG_NSHAPES;                  // shape code of a column sum
constexpr int WG_SMEM = 2 * WG_RB * (128 + 64);     // floats: two row blocks of the largest tile

// Floats of one split's partial of a tile: a product tile's TK x TN sums
// (thread-major: thread t's at t * TK * TN / 256) and TN bias sums; a column
// sum's 32.
int wg_tile_floats(int shape) {
  return shape == WG_SUM ? 32 : WG_SHAPES[shape].tk * WG_SHAPES[shape].tn + WG_SHAPES[shape].tn;
}

// The problem of tile t: one scan of the list a block.
__device__ __forceinline__ int find_problem(const WgParams& p, int t) {
  int q = 0;
  for (int k = 1; k < p.np; ++k)
    if (p.prob[k].tile0 <= t) q = k;
  return q;
}

// Whether this block is the last of its tile's splits to finish.  Every
// thread's partial is fenced before one thread takes the tile's ticket (an
// int counter); the block that draws the last one resets the counter to 0
// for the next launch and, after a second fence, reads every split's
// partial (at L2, __ldcg: another SM wrote them).
__device__ __forceinline__ bool last_split(const WgParams& p) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = p.tickets + blockIdx.y;
    last = atomicAdd(ticket, 1) == p.splits - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The final write of a sum: in place for a later chunk of molecules (the
// same f32 addition as the wrapper's add_ of a chunk's grads).
__device__ __forceinline__ void put(float* out, float s, int accumulate) {
  *out = accumulate ? *out + s : s;
}

// Index in a TK- (or TN-) wide row block of a thread's a-th row (column),
// t its thread row (column): M = 8 takes two runs of 4, half a tile apart, so
// that the float4 loads of 16 threads hit distinct banks.
template <int M, int T>
__device__ __forceinline__ int frag_at(int t, int a) {
  return M == 8 ? (a / 4) * (T / 2) + t * 4 + a % 4 : t * M + a;
}

template <int M, int T>
__device__ __forceinline__ void load_frag(const float* row, int t, float (&v)[M]) {
  if constexpr (M == 8) {
    const float4 lo = *reinterpret_cast<const float4*>(row + t * 4);
    const float4 hi = *reinterpret_cast<const float4*>(row + T / 2 + t * 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else if constexpr (M == 4) {
    const float4 q = *reinterpret_cast<const float4*>(row + t * 4);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(row + t * 2);
    v[0] = q.x; v[1] = q.y;
  }
}

// One TK x TN tile of a product over this block's chunk of rows: row blocks
// of WG_RB rows, the next one loaded into registers while the current one is
// multiplied out of shared memory (two buffers, one barrier a block).  Rows
// past the chunk, k >= K and n >= Nn read as zero.  The block stores its
// split's partial.
template <int TK, int TN, bool BIAS>
__device__ __forceinline__ void wg_tile(const WgParams& p, const WgProblem& q, int local, float* sm) {
  constexpr int MK = TK / 16, MN = TN / 16, ME = MK * MN, TF = TK * TN + TN;
  constexpr int XE = WG_RB * TK / 256, YE = WG_RB * TN / 256;  // loads a thread makes a row block
  static_assert(XE * 256 == WG_RB * TK && YE * 256 == WG_RB * TN, "row blocks split evenly");
  static_assert(2 * WG_RB * (TK + TN) <= WG_SMEM, "two row blocks fit");
  static_assert(ME % 4 == 0, "a thread's sums go as float4");
  const int k0 = (local / q.ntn) * TK, n0 = (local % q.ntn) * TN;
  const size_t r_begin = (size_t)blockIdx.x * p.chunk;
  const size_t r_end = r_begin + p.chunk < p.R ? r_begin + p.chunk : p.R;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* Xs = sm;                  // [2][WG_RB][TK]
  float* Ys = sm + 2 * WG_RB * TK; // [2][WG_RB][TN]
  // a thread's loads of a row block: X column k0 + tid % TK of rows tid / TK
  // + e * (256 / TK), Y column n0 + tid % TN of rows tid / TN + e * (256 / TN)
  const int xrow = threadIdx.x / TK, yrow = threadIdx.x / TN;
  const bool xok = k0 + (int)threadIdx.x % TK < q.K, yok = n0 + (int)threadIdx.x % TN < q.Nn;
  const float* xcol = p.rows + q.xoff + k0 + threadIdx.x % TK + (size_t)xrow * p.width;
  const float* ycol = p.rows + q.yoff + n0 + threadIdx.x % TN + (size_t)yrow * p.width;
  const size_t xstep = (size_t)(256 / TK) * p.width, ystep = (size_t)(256 / TN) * p.width;
  float xr[XE], yr[YE];
  auto fetch = [&](size_t rb) {
    const float* xp = xcol + rb * p.width;
    const float* yp = ycol + rb * p.width;
#pragma unroll
    for (int e = 0; e < XE; ++e)
      xr[e] = xok && rb + xrow + e * (256 / TK) < r_end ? xp[e * xstep] : 0.f;
#pragma unroll
    for (int e = 0; e < YE; ++e)
      yr[e] = yok && rb + yrow + e * (256 / TN) < r_end ? yp[e * ystep] : 0.f;
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < XE; ++e) Xs[buf * WG_RB * TK + threadIdx.x + e * 256] = xr[e];
#pragma unroll
    for (int e = 0; e < YE; ++e) Ys[buf * WG_RB * TN + threadIdx.x + e * 256] = yr[e];
  };
  float acc[MK][MN], bsum[MN];
#pragma unroll
  for (int c = 0; c < MN; ++c) {
    bsum[c] = 0.f;
#pragma unroll
    for (int a = 0; a < MK; ++a) acc[a][c] = 0.f;
  }
  const bool bias = BIAS && ty == 0;  // this thread also sums its Y columns
  fetch(r_begin);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (size_t rb = r_begin; rb < r_end; rb += WG_RB) {
    const bool more = rb + WG_RB < r_end;  // uniform across the block
    if (more) fetch(rb + WG_RB);
    const float* xs = Xs + buf * WG_RB * TK;
    const float* ys = Ys + buf * WG_RB * TN;
#pragma unroll
    for (int r = 0; r < WG_RB; ++r) {
      float xv[MK], yv[MN];
      load_frag<MK, TK>(xs + r * TK, ty, xv);
      load_frag<MN, TN>(ys + r * TN, tx, yv);
#pragma unroll
      for (int a = 0; a < MK; ++a)
#pragma unroll
        for (int c = 0; c < MN; ++c) acc[a][c] = fmaf(xv[a], yv[c], acc[a][c]);
      if (bias) {
#pragma unroll
        for (int c = 0; c < MN; ++c) bsum[c] += yv[c];
      }
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  // this split's partial: thread t's sums at t * ME (a-major), the bias sums
  // of thread column tx at TK * TN + tx * MN
  float* part = p.partials + (size_t)p.splits * (q.part0 + (size_t)local * TF);
  float4* mine = reinterpret_cast<float4*>(part + (size_t)blockIdx.x * TF + threadIdx.x * ME);
#pragma unroll
  for (int e = 0; e < ME; e += 4)
    mine[e / 4] = make_float4(acc[e / MN][e % MN], acc[(e + 1) / MN][(e + 1) % MN],
                              acc[(e + 2) / MN][(e + 2) % MN], acc[(e + 3) / MN][(e + 3) % MN]);
  if (bias) {
#pragma unroll
    for (int c = 0; c < MN; ++c) part[(size_t)blockIdx.x * TF + TK * TN + tx * MN + c] = bsum[c];
  }
}

// The last split of a product tile: every split's partial of the tile in
// split order from 0.f (at L2), written as the grads (and the bias) or added
// onto them.  It reads all it needs afresh, so that nothing of the GEMM's
// stays live across its loop for it.
template <int TK, int TN>
__device__ __forceinline__ void wg_reduce(const WgParams& p, const WgProblem& q, int local) {
  constexpr int MK = TK / 16, MN = TN / 16, ME = MK * MN, TF = TK * TN + TN;
  const int k0 = (local / q.ntn) * TK, n0 = (local % q.ntn) * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* part = p.partials + (size_t)p.splits * (q.part0 + (size_t)local * TF);
  float s[ME];
#pragma unroll
  for (int e = 0; e < ME; ++e) s[e] = 0.f;
  for (int sp = 0; sp < p.splits; ++sp) {
    const float4* src = reinterpret_cast<const float4*>(part + (size_t)sp * TF + threadIdx.x * ME);
#pragma unroll
    for (int e = 0; e < ME; e += 4) {
      const float4 v = __ldcg(src + e / 4);
      s[e] += v.x;
      s[e + 1] += v.y;
      s[e + 2] += v.z;
      s[e + 3] += v.w;
    }
  }
#pragma unroll
  for (int a = 0; a < MK; ++a) {
    const int k = k0 + frag_at<MK, TK>(ty, a);
#pragma unroll
    for (int c = 0; c < MN; ++c) {
      const int n = n0 + frag_at<MN, TN>(tx, c);
      if (k < q.K && n < q.Nn) put(q.out + (size_t)k * q.Nn + n, s[a * MN + c], p.accumulate);
    }
  }
  if (q.hb && local < q.ntn && ty == 0) {
#pragma unroll
    for (int c = 0; c < MN; ++c) {
      const int n = n0 + frag_at<MN, TN>(tx, c);
      float t = 0.f;
      for (int sp = 0; sp < p.splits; ++sp) t += __ldcg(part + (size_t)sp * TF + TK * TN + tx * MN + c);
      if (n < q.Nn) put(q.out_b + n, t, p.accumulate);
    }
  }
}

// A tile of shape S; the first row of tiles of a problem with a bias also
// sums the Y columns (BIAS, uniform across the block).
template <int S>
__device__ __forceinline__ void wg_shape(const WgParams& p, const WgProblem& q, int local, float* sm) {
  constexpr int TK = WG_SHAPES[S].tk, TN = WG_SHAPES[S].tn;
  if (q.hb && local < q.ntn) {
    wg_tile<TK, TN, true>(p, q, local, sm);
  } else {
    wg_tile<TK, TN, false>(p, q, local, sm);
  }
}

// 32 columns of a column sum over this block's chunk: warp w takes rows w,
// w + 8, ..., lane l column l; the 8 warps' sums are added in warp order
// into this split's partial.
__device__ __forceinline__ void wg_sum(const WgParams& p, const WgProblem& q, int local, float* sm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = local * 32 + lane;
  const size_t r_begin = (size_t)blockIdx.x * p.chunk;
  const size_t r_end = r_begin + p.chunk < p.R ? r_begin + p.chunk : p.R;
  float acc = 0.f;
  if (c < q.K) {
#pragma unroll 8
    for (size_t row = r_begin + warp; row < r_end; row += 8) {
      const float* rp = p.rows + row * p.width;
      acc = fmaf(rp[q.xoff + c], q.yoff >= 0 ? rp[q.yoff] : 1.f, acc);
    }
  }
  sm[threadIdx.x] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += sm[w * 32 + lane];
    p.partials[(size_t)p.splits * (q.part0 + (size_t)local * 32) + blockIdx.x * 32 + lane] = s;
  }
}

// The last split of a column-sum tile: the splits' partials in split order.
__device__ __forceinline__ void wg_sum_reduce(const WgParams& p, const WgProblem& q, int local) {
  const int c = local * 32 + threadIdx.x;
  if (threadIdx.x >= 32 || c >= q.K) return;
  const float* part = p.partials + (size_t)p.splits * (q.part0 + (size_t)local * 32) + threadIdx.x;
  float s = 0.f;
  for (int sp = 0; sp < p.splits; ++sp) s += __ldcg(part + sp * 32);
  put(q.out + c, s, p.accumulate);
}

// grid (splits, tiles over all problems): one tile of one problem over one
// chunk of rows into its partial.  A tile's splits are neighbours in the
// launch order, so the last of them to finish reduces the tile while later
// tiles' blocks run.
__global__ void __launch_bounds__(256) weight_grad_kernel(const WgParams p) {
  __shared__ __align__(16) float sm[WG_SMEM];
  {
    const WgProblem& q = p.prob[find_problem(p, blockIdx.y)];
    const int local = blockIdx.y - q.tile0;
    switch (q.shape) {  // uniform across the block
      case 0: wg_shape<0>(p, q, local, sm); break;
      case 1: wg_shape<1>(p, q, local, sm); break;
      case 2: wg_shape<2>(p, q, local, sm); break;
      case 3: wg_shape<3>(p, q, local, sm); break;
      case 4: wg_shape<4>(p, q, local, sm); break;
      case 5: wg_shape<5>(p, q, local, sm); break;
      default: wg_sum(p, q, local, sm);
    }
  }
  if (!last_split(p)) return;
  const WgProblem& q = p.prob[find_problem(p, blockIdx.y)];
  const int local = blockIdx.y - q.tile0;
  switch (q.shape) {
    case 0: wg_reduce<WG_SHAPES[0].tk, WG_SHAPES[0].tn>(p, q, local); break;
    case 1: wg_reduce<WG_SHAPES[1].tk, WG_SHAPES[1].tn>(p, q, local); break;
    case 2: wg_reduce<WG_SHAPES[2].tk, WG_SHAPES[2].tn>(p, q, local); break;
    case 3: wg_reduce<WG_SHAPES[3].tk, WG_SHAPES[3].tn>(p, q, local); break;
    case 4: wg_reduce<WG_SHAPES[4].tk, WG_SHAPES[4].tn>(p, q, local); break;
    case 5: wg_reduce<WG_SHAPES[5].tk, WG_SHAPES[5].tn>(p, q, local); break;
    default: wg_sum_reduce(p, q, local);
  }
}
static_assert(WG_NSHAPES == 6, "weight_grad_kernel dispatches six tile shapes");

size_t edge_rows(const Dims& d) { return (size_t)d.B * d.N * d.N; }

// Fixed row chunks of about 2,048 rows (a multiple of WG_RB), at most 32.
int splits_for(size_t rows) {
  const size_t s = (rows + 2047) / 2048;
  return (int)(s < 1 ? 1 : (s > 32 ? 32 : s));
}

// The tiles of a K x N product in shape s, and their padded multiply-adds
// weighted by the shared-memory loads per FMA of the shape's thread tile.
int wg_tiles(int K, int N, int s) {
  return ((K + WG_SHAPES[s].tk - 1) / WG_SHAPES[s].tk) * ((N + WG_SHAPES[s].tn - 1) / WG_SHAPES[s].tn);
}
double wg_cost(int K, int N, int s) {
  const int mk = WG_SHAPES[s].tk / 16, mn = WG_SHAPES[s].tn / 16;
  return (double)wg_tiles(K, N, s) * WG_SHAPES[s].tk * WG_SHAPES[s].tn *
         (1.0 + 0.5 * (mk + mn) / (mk * mn));
}
int wg_best(int K, int N, double* cost) {
  int best = 0;
  for (int s = 1; s < WG_NSHAPES; ++s)
    if (wg_cost(K, N, s) < wg_cost(K, N, best)) best = s;
  *cost = wg_cost(K, N, best);
  return best;
}

// The weight-grad problems; returns their count (-1 past MAXP).  Problems
// are listed by the work of one tile, largest first, so that the longest
// blocks start first; tile0 and part0 follow that order.  *tiles: their
// tiles; *floats: the floats of one split's partials of all tiles.  grad:
// wve, wsx, bs, wu1, wg, bg, wcomb, wsc, bsc, wubd, wgc, bgc, wattn, battn.
int make_problems(const Dims& d, const RowLayout& RL, float* const* grad, WgProblem* prob,
                  int* tiles, long long* floats) {
  const int S = d.S, V = d.V, V3 = 3 * d.V, W1 = 3 * d.H1 + 27, Wc = 3 * d.Hc + 27;
  const int M1 = S + d.Hc + 9;
  WgProblem list[MAXP];
  int np = 0;
  auto add = [&](int shape, int xoff, int K, int yoff, int Nn, float* o, float* ob) {
    if (np < MAXP) list[np] = WgProblem{shape, xoff, K, ob ? 1 : 0, yoff, Nn, 0, 0, 0, o, ob};
    ++np;
  };
  // a product (and its bias, if ob), whole or as its first multiple of 128
  // rows and the rest, whichever costs less
  auto gemm = [&](int xoff, int K, int yoff, int Nn, float* o, float* ob) {
    double whole, c1, c2;
    const int s = wg_best(K, Nn, &whole), K1 = K / 128 * 128;
    if (K1 > 0 && K1 < K) {
      const int s1 = wg_best(K1, Nn, &c1), s2 = wg_best(K - K1, Nn, &c2);
      if (c1 + c2 < whole) {
        add(s1, xoff, K1, yoff, Nn, o, ob);
        add(s2, xoff + K1, K - K1, yoff, Nn, o + (size_t)K1 * Nn, nullptr);
        return;
      }
    }
    add(s, xoff, K, yoff, Nn, o, ob);
  };
  auto colsum = [&](int xoff, int C, int yoff, float* o) { add(WG_SUM, xoff, C, yoff, 1, o, nullptr); };
  gemm(RL.xi, 3 * d.Ve, RL.dvhd1, W1, grad[0], nullptr);
  gemm(RL.cat1, d.Se + d.H1 + 9, RL.ds2_1, S, grad[1], grad[2]);
  gemm(RL.vhd1, 3 * d.H1, RL.dvu1, V3, grad[3], nullptr);
  gemm(RL.silu1, S, RL.dzg1, V, grad[4], grad[5]);
  for (int g = 0; g < d.G; ++g) {
    const int sb = RL.stage0 + g * RL.stage_w;
    gemm(sb + RL.vin, V3, sb + RL.dvhd, Wc, grad[6] + (size_t)g * V3 * Wc, nullptr);
    gemm(sb + RL.merged, M1, sb + RL.ds2, S, grad[7] + (size_t)g * M1 * S, grad[8] + (size_t)g * S);
    gemm(sb + RL.vhd, 3 * d.Hc, sb + RL.dvu, V3, grad[9] + (size_t)g * 3 * d.Hc * V3, nullptr);
    gemm(sb + RL.silu, S, sb + RL.dzg, V, grad[10] + (size_t)g * S * V, grad[11] + (size_t)g * V);
  }
  colsum(RL.sfin, S, RL.dzattn, grad[12]);
  colsum(RL.dzattn, 1, -1, grad[13]);
  if (np > MAXP) return -1;
  auto tile_work = [](const WgProblem& q) {
    return q.shape == WG_SUM ? 0 : WG_SHAPES[q.shape].tk * WG_SHAPES[q.shape].tn;
  };
  int n = 0, t = 0;
  long long f = 0;
  bool taken[MAXP] = {};
  while (n < np) {  // stable selection by tile work, largest first
    int pick = -1;
    for (int k = 0; k < np; ++k)
      if (!taken[k] && (pick < 0 || tile_work(list[k]) > tile_work(list[pick]))) pick = k;
    taken[pick] = true;
    WgProblem q = list[pick];
    q.ntn = q.shape == WG_SUM ? 1 : (q.Nn + WG_SHAPES[q.shape].tn - 1) / WG_SHAPES[q.shape].tn;
    const int nt = q.shape == WG_SUM ? (q.K + 31) / 32 : wg_tiles(q.K, q.Nn, q.shape);
    q.tile0 = t;
    q.part0 = (int)f;
    t += nt;
    f += (long long)nt * wg_tile_floats(q.shape);
    prob[n++] = q;
  }
  *tiles = t;
  *floats = f;
  return np;
}

Dims dims_of(const int* dims) {
  return Dims{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7], dims[8], dims[9]};
}

bool dims_ok(const Dims& d) {
  return d.B > 0 && d.B <= 65535 && d.N > 0 && d.S > 0 && d.V > 0 && d.G >= 0 && d.G <= 6 &&
         d.P == d.Se + 3 * d.Ve + 10;
}

// The node sums over a scratch of d's rows.
cudaError_t launch_proj_sum(const Dims& d, const RowLayout& RL, const float* rows, float* d_proj_i,
                            float* d_proj_j, cudaStream_t stream) {
  int device = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const ProjSumPlan ps = proj_sum_plan(d, RL, sms);
  if (ps.smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(proj_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ps.smem);
  if (err != cudaSuccess) return err;
  proj_sum_kernel<<<dim3(ps.slabs, d.B), PS_THREADS, ps.smem, stream>>>(rows, RL.width, d.N, d.S, 3 * d.H1 + 27,
                                                                        ps, d_proj_i, d_proj_j);
  return cudaGetLastError();
}

// The weight grads (and biases) over a scratch of d's rows, written or, with
// accumulate, added onto `grad`'s (see make_problems).  `tickets`: one int a
// tile, all 0 (and left so).
cudaError_t launch_weight_grads(const Dims& d, const RowLayout& RL, const float* rows, float* const* grad,
                                float* partials, int* tickets, int accumulate, cudaStream_t stream) {
  WgParams w;
  w.rows = rows;
  w.R = edge_rows(d);
  w.width = RL.width;
  w.splits = splits_for(w.R);
  w.chunk = (int)((w.R + w.splits - 1) / w.splits + WG_RB - 1) / WG_RB * WG_RB;
  w.accumulate = accumulate;
  w.partials = partials;
  w.tickets = tickets;
  int tiles = 0;
  long long floats = 0;
  w.np = make_problems(d, RL, grad, w.prob, &tiles, &floats);
  if (w.np < 0 || tiles > 65535) return cudaErrorInvalidValue;
  weight_grad_kernel<<<dim3(w.splits, tiles), 256, 0, stream>>>(w);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* const* ins, void* const* outs, float* rows, float* partials, int* tickets,
               const int* dims, int accumulate, void* stream_ptr) {
  const Dims d = dims_of(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const RowLayout RL(d);
  const SmemLayout L(d);

  BwdParams<T> p;
  const T* const* in = reinterpret_cast<const T* const*>(ins);
  p.proj_i = in[0]; p.proj_j = in[1]; p.epack = in[2]; p.ds_agg = in[3]; p.dv_agg = in[4];
  p.wve = in[5]; p.wsx = in[6]; p.bs1 = in[7]; p.wu1 = in[8]; p.wg1 = in[9]; p.bg1 = in[10];
  p.wcomb = in[11]; p.wsc = in[12]; p.bsc = in[13]; p.wubd = in[14]; p.wgc = in[15];
  p.bgc = in[16]; p.wattn = in[17]; p.battn = in[18];
  p.wveT = in[19]; p.wsxT = in[20]; p.wu1T = in[21]; p.wg1T = in[22];
  p.wcombT = in[23]; p.wscT = in[24]; p.wubdT = in[25]; p.wgcT = in[26];
  p.d_epack = static_cast<T*>(outs[0]);
  p.rows = rows;
  p.d = d;
  p.rl = RL;
  p.sl = L;

  const size_t smem = sizeof(float) * (size_t)L.floats(d);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_rows_kernel<T><<<dim3(d.N, d.B), THREADS, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = launch_weight_grads(d, RL, rows, reinterpret_cast<float* const*>(outs + 3), partials, tickets, accumulate,
                            stream);
  if (err != cudaSuccess) return (int)err;
  // the node sums last: by then the row kernel's dirty lines have left L2
  return (int)launch_proj_sum(d, RL, rows, static_cast<float*>(outs[1]), static_cast<float*>(outs[2]), stream);
}

}  // namespace

extern "C" {

// sizes[0]: floats of the per-row scratch, sizes[1]: floats of the
// weight-grad partials, sizes[2]: bytes of dynamic shared memory per block
// of the row kernel, sizes[3]: the weight-grad tiles (int tile counters).
// Returns non-zero for widths the kernel does not take.
int message_layer_bwd_workspace(const int* dims, long long* sizes) {
  const Dims d = dims_of(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const RowLayout RL(d);
  WgProblem prob[MAXP];
  float* grad[14] = {};
  int tiles = 0;
  long long floats = 0;
  if (make_problems(d, RL, grad, prob, &tiles, &floats) < 0) return (int)cudaErrorInvalidValue;
  sizes[0] = (long long)edge_rows(d) * RL.width;
  sizes[1] = (long long)splits_for(edge_rows(d)) * floats;
  sizes[2] = (long long)(sizeof(float) * (size_t)SmemLayout(d).floats(d));
  sizes[3] = tiles;
  return 0;
}

// Blocks that one SM holds of the row kernel (kernel 0; float32 if bf16 ==
// 0, else bf16) at `smem` bytes of dynamic shared memory each, or of the
// weight-grad kernel (kernel 1; static shared memory only, `smem` unused); a
// negative CUDA error code on failure.
int message_layer_bwd_blocks_per_sm(int kernel, int bf16, int smem) {
  if (kernel == 1) return blocks_per_sm(weight_grad_kernel, 256, 0);
  return bf16 ? blocks_per_sm(bwd_rows_kernel<__nv_bfloat16>, THREADS, smem)
              : blocks_per_sm(bwd_rows_kernel<float>, THREADS, smem);
}

// Registers a thread (out[0]), bytes of local memory a thread, spills and
// stack (out[1]), and bytes of static shared memory a block (out[2]) of the
// row kernel (kernel 0; float32 if bf16 == 0) or the weight-grad kernel
// (kernel 1), as loaded; a CUDA error code on failure.
int message_layer_bwd_kernel_attrs(int kernel, int bf16, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      kernel == 1 ? cudaFuncGetAttributes(&a, weight_grad_kernel)
      : bf16      ? cudaFuncGetAttributes(&a, bwd_rows_kernel<__nv_bfloat16>)
                  : cudaFuncGetAttributes(&a, bwd_rows_kernel<float>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

// The backward over d's rows: the row kernel into `rows`, then the weight
// grads and the node sums; outs: d_epack, d_proj_i, d_proj_j, then the 14
// grads of make_problems, written (accumulate 0) or added onto (accumulate 1).
int message_layer_bwd_f32(const void* const* ins, void* const* outs, float* rows, float* partials,
                          int* tickets, const int* dims, int accumulate, void* stream) {
  return launch_bwd<float>(ins, outs, rows, partials, tickets, dims, accumulate, stream);
}

int message_layer_bwd_bf16(const void* const* ins, void* const* outs, float* rows, float* partials,
                           int* tickets, const int* dims, int accumulate, void* stream) {
  return launch_bwd<__nv_bfloat16>(ins, outs, rows, partials, tickets, dims, accumulate, stream);
}

// proj_sum_kernel alone on a scratch of d's layout (edge_rows x width floats).
int message_layer_bwd_proj_sums(const float* rows, const int* dims, float* d_proj_i, float* d_proj_j,
                                void* stream) {
  const Dims d = dims_of(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  return (int)launch_proj_sum(d, RowLayout(d), rows, d_proj_i, d_proj_j, static_cast<cudaStream_t>(stream));
}

// weight_grad_kernel alone on a scratch of d's layout: the 14 grads written
// or, with accumulate, added onto.
int message_layer_bwd_weight_grads(const float* rows, const int* dims, void* const* grads, float* partials,
                                   int* tickets, int accumulate, void* stream) {
  const Dims d = dims_of(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  return (int)launch_weight_grads(d, RowLayout(d), rows, reinterpret_cast<float* const*>(grads), partials,
                                  tickets, accumulate, static_cast<cudaStream_t>(stream));
}

#ifdef PHASE_PROBE
// The row kernel's phase counters (see message_layer_common.cuh): copy out, zero.
int phases_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
}
int phases_reset() {
  static const unsigned long long zero[PHASE_SLOTS] = {};
  return (int)cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
