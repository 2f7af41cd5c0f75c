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
// What bounds it on an H100.  At QM9 width one edge row costs ~0.30 M MAC to
// recompute the forward, ~0.30 M MAC for the input cotangents and ~0.30 M MAC
// for its share of the weight grads (0.6 MFLOP each, block-diagonal zeros
// included), so one layer at B=64, N=29 (53,824 rows) is ~97 GFLOP of FMA
// work: compute-bound, like the forward.  Two things do not fit the forward's
// design.  (1) The reverse walk needs every stage's internals (vhd, root,
// s2, gate, vu: ~1.8k f32 per row at QM9 width) plus the operands of the
// weight grads (~4.3k f32 per row): ~24 KB per row, so the 227 KB of shared
// memory would hold fewer than 10 rows.  (2) The weight grads (~0.29 M f32 per
// layer) and d_proj_j are sums over rows that belong to different blocks.
//
// What the design does about it.
//   1. bwd_rows_kernel: one block per (molecule b, source node i), targets j
//      in tiles of ROWS=16 rows, as the forward kernel.  The tile's running
//      state (s, v, ds, dv and each product's output) stays in shared memory
//      (~72 KB, so three blocks share an SM); the stage internals and the
//      weight-grad operands go to a per-row scratch in device memory (written
//      once, read back by the same block and by the kernels below).  Every
//      backward product reads a weight transposed once by the wrapper, so all
//      products share the forward's register-tiled FMA loop.
//   2. proj_sum_kernel: d_proj_i and d_proj_j as fixed-order sums over the
//      scratch rows.
//   3. weight_grad_kernel: X^T dY for every weight at once (a list of
//      problems; a bias is a column of ones appended to X), 64x64 output
//      tiles, rows split into fixed chunks, one partial per chunk.
//   4. reduce_kernel: the chunk partials summed in a fixed order.
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
constexpr int RPT = 8;        // rows per thread in the wide products
constexpr int MAXP = 32;      // weight-grad problems: 5 + 4 G, so G <= 6
constexpr int TK = 64, TN = 64, RB = 16;  // weight-grad tile and row block

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
  int lda, ldv, ldh, ldx, ldg, lds;
  __host__ __device__ explicit SmemLayout(const Dims& d) {
    const int a = d.S + d.Hc + 9, a1 = d.Se + d.H1 + 9;
    lda = round4(a > a1 ? a : a1);
    ldv = round4(3 * d.V);
    const int h = 3 * d.H1 + 27, hc = 3 * d.Hc + 27;
    ldh = round4(h > hc ? h : hc);
    ldx = round4(d.S > 3 * d.Ve ? d.S : 3 * d.Ve);
    ldg = round4(d.V);
    lds = round4(d.S);
  }
  __host__ __device__ int floats(const Dims& d) const {
    return ROWS * (lda + 2 * ldv + ldh + ldx + ldg + lds + 12 + 12 + 4) + round4(d.S) +
           round4(3 * d.V);
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

__device__ __forceinline__ float silu_grad(float x, float sig) {
  return sig * (1.f + x * (1.f - sig));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_rows_kernel(const BwdParams<T> p) {
  using NT = Num<T>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Dims& d = p.d;
  const SmemLayout L(d);
  const RowLayout RL(d);
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

  const int i = blockIdx.x, b = blockIdx.y;
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
    __syncthreads();  // the previous tile is done with every buffer

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

    // ================= forward recompute =================
    tile_mm<RPT>(X, ldx, nrows, 3 * Ve, p.wve, W1, [&](int r, int c, float acc) {
      if (r >= nrows) return;
      const float v = (NT::ld(pi[S + c]) + NT::ld(pj0[(size_t)(j0 + r) * PW + S + c])) + acc;
      Hb[r * ldh + c] = v;
      row(r)[RL.vhd1 + c] = v;
    });
    __syncthreads();
    norms_fwd<T>(Hb, ldh, FT, A + Se, lda, H1, nrows, row, RL.root1, RL.cat1 + Se);
    __syncthreads();
    tile_mm<RPT>(A, lda, nrows, Se + H1 + 9, p.wsx, S, [&](int r, int c, float acc) {
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
    tile_mm<4>(X, ldx, nrows, S, p.wg1, V, [&](int r, int c, float acc) {
      if (r >= nrows) return;
      const float g = sigmoid_f(acc + NT::ld(p.bg1[c]));
      row(r)[RL.gate1 + c] = g;
      Gt[r * ldg + c] = NT::rnd(g);
    });
    __syncthreads();
    tile_mm<RPT>(Hb, ldh, nrows, 3 * H1, p.wu1, V3, [&](int r, int c, float acc) {
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

    for (int g = 0; g < d.G; ++g) {
      const int sb = RL.stage0 + g * RL.stage_w;
      for (int idx = threadIdx.x; idx < nrows * V3; idx += blockDim.x) {
        const int r = idx / V3, c = idx % V3;
        row(r)[sb + RL.vin + c] = Vb[r * ldv + c];
      }
      tile_mm<RPT>(Vb, ldv, nrows, V3, p.wcomb + (size_t)g * V3 * Wc, Wc,
                   [&](int r, int c, float acc) {
                     if (r >= nrows) return;
                     Hb[r * ldh + c] = acc;
                     row(r)[sb + RL.vhd + c] = acc;
                   });
      __syncthreads();
      norms_fwd<T>(Hb, ldh, FT, A + S, lda, Hc, nrows, row, sb + RL.root, -1);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nrows * M1; idx += blockDim.x) {
        const int r = idx / M1, c = idx % M1;
        row(r)[sb + RL.merged + c] = A[r * lda + c];
      }
      const T* bsc = p.bsc + (size_t)g * S;
      tile_mm<RPT>(A, lda, nrows, M1, p.wsc + (size_t)g * M1 * S, S, [&](int r, int c, float acc) {
        if (r >= nrows) return;
        const float s2 = acc + NT::ld(bsc[c]);
        float* rp = row(r);
        rp[sb + RL.s2 + c] = s2;
        const float silu = NT::rnd(s2 * sigmoid_f(s2));
        X[r * ldx + c] = silu;
        rp[sb + RL.silu + c] = silu;
      });
      __syncthreads();
      const T* bgc = p.bgc + (size_t)g * V;
      tile_mm<4>(X, ldx, nrows, S, p.wgc + (size_t)g * S * V, V, [&](int r, int c, float acc) {
        if (r >= nrows) return;
        const float gf = sigmoid_f(acc + NT::ld(bgc[c]));
        row(r)[sb + RL.gate + c] = gf;
        Gt[r * ldg + c] = NT::rnd(gf);
      });
      __syncthreads();
      tile_mm<RPT>(Hb, ldh, nrows, 3 * Hc, p.wubd + (size_t)g * 3 * Hc * V3, V3,
                   [&](int r, int c, float acc) {
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
      tile_mm<RPT>(Gt, ldg, nrows, V, p.wgcT + (size_t)g * V * S, S, [&](int r, int c, float acc) {
        if (r >= nrows) return;
        float* rp = row(r);
        const float s2 = rp[sb + RL.s2 + c];
        const float ds2 = (DS[r * lds + c] + acc) * silu_grad(s2, sigmoid_f(s2));
        X[r * ldx + c] = ds2;
        rp[sb + RL.ds2 + c] = ds2;
      });
      __syncthreads();
      tile_mm<RPT>(X, ldx, nrows, S, p.wscT + (size_t)g * S * M1, M1, [&](int r, int c, float acc) {
        if (r >= nrows) return;
        if (c < S) DS[r * lds + c] += acc;
        else A[r * lda + c] = acc;
      });
      tile_mm<RPT>(DVU, ldv, nrows, V3, p.wubdT + (size_t)g * V3 * 3 * Hc, 3 * Hc,
                   [&](int r, int c, float acc) {
                     if (r < nrows) Hb[r * ldh + c] = acc;
                   });
      __syncthreads();
      norms_bwd(Hb, ldh, A + S, lda, FT, DFT, Hc, nrows, row, sb + RL.vhd, sb + RL.root,
                sb + RL.dvhd);
      __syncthreads();
      tile_mm<RPT>(Hb, ldh, nrows, Wc, p.wcombT + (size_t)g * Wc * V3, V3,
                   [&](int r, int c, float acc) {
                     if (r < nrows) Vb[r * ldv + c] += acc;
                   });
      __syncthreads();
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
    tile_mm<RPT>(Gt, ldg, nrows, V, p.wg1T, S, [&](int r, int c, float acc) {
      if (r >= nrows) return;
      float* rp = row(r);
      const float s2 = rp[RL.s2_1 + c];
      const float ds2 = (DS[r * lds + c] + acc) * silu_grad(s2, sigmoid_f(s2));
      X[r * ldx + c] = ds2;
      rp[RL.ds2_1 + c] = ds2;
    });
    __syncthreads();
    tile_mm<RPT>(X, ldx, nrows, S, p.wsxT, Se + H1 + 9, [&](int r, int c, float acc) {
      if (r >= nrows) return;
      A[r * lda + c] = acc;
      if (c < Se) dep_i[(size_t)(j0 + r) * P + c] = NT::st(acc);
    });
    tile_mm<RPT>(DVU, ldv, nrows, V3, p.wu1T, 3 * H1, [&](int r, int c, float acc) {
      if (r < nrows) Hb[r * ldh + c] = acc;
    });
    __syncthreads();
    norms_bwd(Hb, ldh, A + Se, lda, FT, DFT, H1, nrows, row, RL.vhd1, RL.root1, RL.dvhd1);
    __syncthreads();
    tile_mm<RPT>(Hb, ldh, nrows, W1, p.wveT, 3 * Ve, [&](int r, int c, float acc) {
      if (r < nrows) dep_i[(size_t)(j0 + r) * P + Se + c] = NT::st(acc);
    });
    for (int idx = threadIdx.x; idx < nrows * 10; idx += blockDim.x) {
      const int r = idx / 10, t = idx % 10;
      const float v = t < 9 ? DFT[r * 12 + t] : RS[r * 4 + 2];
      dep_i[(size_t)(j0 + r) * P + Se + 3 * Ve + t] = NT::st(v);
    }
  }
}

// d_proj_i[b, i, c] = sum_j D[b, i, j, c] (side 0) and d_proj_j[b, j, c] =
// sum_i D[b, i, j, c] (side 1), where D is d_s2 | d_vhd of GCP1 in the row
// scratch.  Fixed summation order.
__global__ void proj_sum_kernel(const float* __restrict__ rows, int width, int off_s, int off_v,
                                int S, int W1, int N, float* d_proj_i, float* d_proj_j) {
  const int node = blockIdx.x, b = blockIdx.y, side = blockIdx.z;
  float* out = (side == 0 ? d_proj_i : d_proj_j) + ((size_t)b * N + node) * (S + W1);
  for (int c = threadIdx.x; c < S + W1; c += blockDim.x) {
    const int col = c < S ? off_s + c : off_v + c - S;
    float s = 0.f;
    for (int o = 0; o < N; ++o) {
      const size_t r = side == 0 ? ((size_t)b * N + node) * N + o : ((size_t)b * N + o) * N + node;
      s += rows[r * width + col];
    }
    out[c] = s;
  }
}

// One weight gradient: C[k, n] = sum_r X[r, k] * Y[r, n] over all edge rows,
// X at column xoff of the row scratch (K columns, then a column of ones if
// hb: the bias), Y at column yoff (Nn columns).
struct WgProblem {
  int xoff, K, hb, yoff, Nn, tile0, ntn, elem0;
  float* out_w;
  float* out_b;
};

struct WgParams {
  const float* rows;
  size_t R;
  int width, splits, chunk, np;
  float* partials;
  WgProblem prob[MAXP];
};

__device__ __forceinline__ int find_problem(const WgParams& p, int t, bool by_tile) {
  int q = 0;
  for (int k = 1; k < p.np; ++k)
    if ((by_tile ? p.prob[k].tile0 : p.prob[k].elem0) <= t) q = k;
  return q;
}

// grid (tiles over all problems, splits): a 64x64 tile of C over one chunk
// of rows -> partials[splits * elem0 + split * (K+hb) * Nn + k * Nn + n].
__global__ void __launch_bounds__(256) weight_grad_kernel(const WgParams p) {
  __shared__ __align__(16) float Xs[RB][TK];
  __shared__ __align__(16) float Ys[RB][TN];
  const WgProblem& q = p.prob[find_problem(p, blockIdx.x, true)];
  const int local = blockIdx.x - q.tile0;
  const int k0 = (local / q.ntn) * TK, n0 = (local % q.ntn) * TN;
  const int KK = q.K + q.hb;
  const size_t r_begin = (size_t)blockIdx.y * p.chunk;
  const size_t r_end = r_begin + p.chunk < p.R ? r_begin + p.chunk : p.R;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (size_t rb = r_begin; rb < r_end; rb += RB) {
    for (int e = threadIdx.x; e < RB * TK; e += blockDim.x) {
      const int r = e / TK, c = e % TK;
      const size_t row = rb + r;
      float xv = 0.f, yv = 0.f;
      if (row < r_end) {
        const float* rp = p.rows + row * p.width;
        const int k = k0 + c, n = n0 + c;
        if (k < q.K) xv = rp[q.xoff + k];
        else if (k < KK) xv = 1.f;
        if (n < q.Nn) yv = rp[q.yoff + n];
      }
      Xs[r][c] = xv;
      Ys[r][c] = yv;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float4 xv = *reinterpret_cast<const float4*>(&Xs[r][ty * 4]);
      const float4 yv = *reinterpret_cast<const float4*>(&Ys[r][tx * 4]);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(xs[a], ys[c], acc[a][c]);
    }
    __syncthreads();
  }
  float* part = p.partials + (size_t)p.splits * q.elem0 + (size_t)blockIdx.y * KK * q.Nn;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k = k0 + ty * 4 + a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (k < KK && n < q.Nn) part[(size_t)k * q.Nn + n] = acc[a][c];
    }
  }
}

// Sum of the chunk partials in chunk order -> the f32 weight and bias grads.
__global__ void reduce_kernel(const WgParams p, int total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const WgProblem& q = p.prob[find_problem(p, e, false)];
  const int local = e - q.elem0, KK = q.K + q.hb;
  const float* part = p.partials + (size_t)p.splits * q.elem0 + local;
  float s = 0.f;
  for (int sp = 0; sp < p.splits; ++sp) s += part[(size_t)sp * KK * q.Nn];
  const int k = local / q.Nn, n = local % q.Nn;
  if (k < q.K) q.out_w[(size_t)k * q.Nn + n] = s;
  else q.out_b[n] = s;
}

size_t edge_rows(const Dims& d) { return (size_t)d.B * d.N * d.N; }

int splits_for(size_t rows) {
  const size_t s = (rows + 2047) / 2048;
  return (int)(s < 1 ? 1 : (s > 16 ? 16 : s));
}

// The weight-grad problems in output order; returns their count.
int make_problems(const Dims& d, const RowLayout& RL, float* const* out, WgProblem* prob,
                  int* tiles, int* elems) {
  const int S = d.S, V = d.V, V3 = 3 * d.V, W1 = 3 * d.H1 + 27, Wc = 3 * d.Hc + 27;
  const int M1 = S + d.Hc + 9;
  int np = 0, t = 0, e = 0;
  auto add = [&](int xoff, int K, int hb, int yoff, int Nn, float* ow, float* ob) {
    WgProblem& q = prob[np++];
    q.xoff = xoff; q.K = K; q.hb = hb; q.yoff = yoff; q.Nn = Nn;
    q.out_w = ow; q.out_b = ob;
    q.ntn = (Nn + TN - 1) / TN;
    q.tile0 = t;
    t += ((K + hb + TK - 1) / TK) * q.ntn;
    q.elem0 = e;
    e += (K + hb) * Nn;
  };
  // out: d_epack, d_proj_i, d_proj_j, wve, wsx, bs, wu1, wg, bg, wcomb, wsc, bsc, wubd, wgc, bgc,
  // wattn, battn
  add(RL.xi, 3 * d.Ve, 0, RL.dvhd1, W1, out[3], nullptr);
  add(RL.cat1, d.Se + d.H1 + 9, 1, RL.ds2_1, S, out[4], out[5]);
  add(RL.vhd1, 3 * d.H1, 0, RL.dvu1, V3, out[6], nullptr);
  add(RL.silu1, S, 1, RL.dzg1, V, out[7], out[8]);
  for (int g = 0; g < d.G; ++g) {
    const int sb = RL.stage0 + g * RL.stage_w;
    add(sb + RL.vin, V3, 0, sb + RL.dvhd, Wc, out[9] + (size_t)g * V3 * Wc, nullptr);
    add(sb + RL.merged, M1, 1, sb + RL.ds2, S, out[10] + (size_t)g * M1 * S, out[11] + (size_t)g * S);
    add(sb + RL.vhd, 3 * d.Hc, 0, sb + RL.dvu, V3, out[12] + (size_t)g * 3 * d.Hc * V3, nullptr);
    add(sb + RL.silu, S, 1, sb + RL.dzg, V, out[13] + (size_t)g * S * V, out[14] + (size_t)g * V);
  }
  add(RL.sfin, S, 1, RL.dzattn, 1, out[15], out[16]);
  *tiles = t;
  *elems = e;
  return np;
}

bool dims_ok(const Dims& d) {
  return d.B > 0 && d.B <= 65535 && d.N > 0 && d.S > 0 && d.V > 0 && d.G >= 0 &&
         5 + 4 * d.G <= MAXP && d.P == d.Se + 3 * d.Ve + 10;
}

template <typename T>
int launch_bwd(const void* const* ins, void* const* outs, float* rows, float* partials,
               const int* dims, void* stream_ptr) {
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7], dims[8],
               dims[9]};
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

  const int W1 = 3 * d.H1 + 27;
  proj_sum_kernel<<<dim3(d.N, d.B, 2), 128, 0, stream>>>(
      rows, RL.width, RL.ds2_1, RL.dvhd1, d.S, W1, d.N, static_cast<float*>(outs[1]),
      static_cast<float*>(outs[2]));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  WgParams w;
  w.rows = rows;
  w.R = edge_rows(d);
  w.width = RL.width;
  w.splits = splits_for(w.R);
  w.chunk = (int)((w.R + w.splits - 1) / w.splits);
  w.partials = partials;
  int tiles = 0, elems = 0;
  w.np = make_problems(d, RL, reinterpret_cast<float* const*>(outs), w.prob, &tiles, &elems);
  weight_grad_kernel<<<dim3(tiles, w.splits), 256, 0, stream>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<(elems + 255) / 256, 256, 0, stream>>>(w, elems);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sizes[0]: floats of the per-row scratch, sizes[1]: floats of the
// weight-grad partials, sizes[2]: bytes of dynamic shared memory per block
// of the row kernel.  Returns non-zero for widths the kernel does not take.
int message_layer_bwd_workspace(const int* dims, long long* sizes) {
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7], dims[8],
               dims[9]};
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const RowLayout RL(d);
  WgProblem prob[MAXP];
  float* outs[17] = {};
  int tiles = 0, elems = 0;
  make_problems(d, RL, outs, prob, &tiles, &elems);
  sizes[0] = (long long)edge_rows(d) * RL.width;
  sizes[1] = (long long)splits_for(edge_rows(d)) * elems;
  sizes[2] = (long long)(sizeof(float) * (size_t)SmemLayout(d).floats(d));
  return 0;
}

int message_layer_bwd_f32(const void* const* ins, void* const* outs, float* rows, float* partials,
                          const int* dims, void* stream) {
  return launch_bwd<float>(ins, outs, rows, partials, dims, stream);
}

int message_layer_bwd_bf16(const void* const* ins, void* const* outs, float* rows,
                           float* partials, const int* dims, void* stream) {
  return launch_bwd<__nv_bfloat16>(ins, outs, rows, partials, dims, stream);
}

}  // extern "C"
