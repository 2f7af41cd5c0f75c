// Device helpers shared by the message-layer kernels (message_layer.cu,
// message_layer_bwd.cu, gcp2_chain.cu): the compute-dtype rounding points,
// the sigmoid, the register-tiled products of a shared-memory tile with a
// weight matrix (FMA pipes: tile_mm, one column a thread, and tile_rm, 2-D
// register tiles over weights staged in shared memory; tensor cores for
// bf16: tile_mma), and the residual GCP2 chain stage and attention over a
// tile.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

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

// Phase probe of the message-layer kernels (cli/kernel_phases.py).  Built
// with -DPHASE_PROBE, thread 0 of a block reads clock64() at PHASE_START and
// at every PHASE_MARK (one after each block barrier of the kernel and of
// chain_stage, one at the kernel's or the tile's end) and adds the cycles
// since the previous one to that mark's counter, in the order the block
// passes them; PHASE_FOLD starts that order again, so every tile of target
// rows adds to the same counters.  PHASE_ROWS(computed, covered) adds a
// block's edge rows to the last two counters: those its products computed
// and those its grid position covers.  Otherwise all of them compile to
// nothing.
#ifdef PHASE_PROBE
constexpr int PHASE_SLOTS = 64;
constexpr int PHASE_MARKS = PHASE_SLOTS - 2;  // the rest count rows
__device__ unsigned long long phase_cycles[PHASE_SLOTS];
__shared__ long long phase_t;
__shared__ int phase_i;
#define PHASE_START()                                   \
  do {                                                  \
    if (threadIdx.x == 0) { phase_t = clock64(); phase_i = 0; } \
  } while (0)
#define PHASE_MARK()                                                                      \
  do {                                                                                    \
    if (threadIdx.x == 0) {                                                               \
      const long long t_ = clock64();                                                     \
      if (phase_i < PHASE_MARKS)                                                          \
        atomicAdd(&phase_cycles[phase_i], (unsigned long long)(t_ - phase_t));            \
      ++phase_i;                                                                          \
      phase_t = t_;                                                                       \
    }                                                                                     \
  } while (0)
#define PHASE_FOLD()                      \
  do {                                    \
    if (threadIdx.x == 0) phase_i = 0;    \
  } while (0)
#define PHASE_ROWS(computed, covered)                                                    \
  do {                                                                                   \
    if (threadIdx.x == 0) {                                                              \
      atomicAdd(&phase_cycles[PHASE_MARKS], (unsigned long long)(computed));             \
      atomicAdd(&phase_cycles[PHASE_MARKS + 1], (unsigned long long)(covered));          \
    }                                                                                    \
  } while (0)
#else
#define PHASE_START() do {} while (0)
#define PHASE_MARK() do {} while (0)
#define PHASE_FOLD() do {} while (0)
#define PHASE_ROWS(computed, covered) do {} while (0)
#endif

// Blocks of `kernel` that one SM holds at `threads` threads and `smem` bytes
// of dynamic shared memory each, as a launch configures it; a negative CUDA
// error code on failure.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// The least stride >= x that is 8 (mod 16) floats: the A-fragment loads of
// tile_mma (row lane/4, float2 at column 2*(lane%4)) then hit 32 distinct
// banks in each half-warp; a multiple of 4, as tile_mm's float4 loads need.
__host__ __device__ inline int mma_stride(int x) { return (x + 7) / 16 * 16 + 8; }

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

// Four consecutive values in shared memory as floats (p aligned to 4 of them).
__device__ __forceinline__ void lds4(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  w[0] = __uint_as_float(v.x << 16);
  w[1] = __uint_as_float(v.x & 0xffff0000u);
  w[2] = __uint_as_float(v.y << 16);
  w[3] = __uint_as_float(v.y & 0xffff0000u);
}

// Asynchronous 16-byte copy from device to shared memory (sm_80+), of which
// the first `bytes` are read and the rest zero-filled; commit, and wait for
// all but the newest N groups of this thread.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Rows k0 .. k0+kn of W [K, ncols] are one contiguous span; staged as it
// lies, in W's type, row kk starts at WS[lead + kk * ncols].  A
// 16-byte-aligned W goes by cp.async in 16-byte pieces from the aligned
// address at or below the span's start (lead = its offset; the last piece
// zero-filled past the span), left in flight in one commit group; any other
// W value by value (lead = 0).
template <typename T>
__device__ __forceinline__ int stage_lead(const T* W, int ncols, int k0) {
  constexpr int PER = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(W) % 16 == 0 ? (int)(((size_t)k0 * ncols) % PER) : 0;
}
template <typename T>
__device__ __forceinline__ void stage_span(const T* __restrict__ W, int ncols, int k0, int kn,
                                          T* __restrict__ WS) {
  constexpr int PER = 16 / sizeof(T);
  const int lead = stage_lead(W, ncols, k0), n = lead + kn * ncols;
  const T* src = W + (size_t)k0 * ncols - lead;
  if (reinterpret_cast<uintptr_t>(W) % 16 == 0) {
    for (int i = PER * threadIdx.x; i < n; i += PER * blockDim.x)
      cp_async16(WS + i, src + i, (int)sizeof(T) * min(PER, n - i));
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) WS[i] = src[i];
  }
  cp_async_commit();
}

// tile_mm's product on 2-D register tiles, the weights staged in shared
// memory.  Every block reads all of a product's weights for each tile of
// rows; read from L2 by every thread, as tile_mm reads them, the weight bytes
// bound the product.  So the block copies W (in its own type) into WS
// (ws_floats floats: two buffers) in slabs of ks rows, ks the largest
// multiple of 4 a buffer holds, the next slab in flight (cp.async) while the
// current one is multiplied, and every thread reads its weights from there:
// each weight leaves L2 once per tile.  A thread owns R rows and 4 columns
// (an item), 4 R FMAs per staged weight row it reads; R is chosen per product
// so that its items fit the block (more items take more passes, each staging
// W again).  The 4 columns are consecutive, one vector read, where ncols % 4
// == 0; else an item takes the columns cg, cg + G, cg + 2G, cg + 3G (G =
// ceil(ncols / 4)), scalar reads free of bank conflicts.  tile_mm's
// contract: rows of `in` 16-byte aligned (ldi % 4 == 0), the tile's first
// ceil(nrows/R)*R rows computed, epi(r, c, acc) for each c < ncols; and
// tile_mm's sum for each output (k = 0..K-1 by fmaf from 0), so float32
// results are bit-identical to it.  Every thread of the block calls it: it
// waits at block barriers.
template <int R, typename T, typename Epi>
__device__ __forceinline__ void tile_rm(const float* __restrict__ in, int ldi, int nrows, int K,
                                        const T* __restrict__ W, int ncols, float* __restrict__ WS,
                                        int ws_floats, Epi epi) {
  constexpr int PER = 16 / sizeof(T);
  T* const stage = reinterpret_cast<T*>(WS);
  const int cap = ws_floats * (int)(sizeof(float) / sizeof(T)) / 2;  // values a buffer
  const int groups = (ncols + 3) / 4;
  const bool quad = ncols % 4 == 0;
  const int ks = min(K, ((cap - 2 * PER) / ncols) & ~3), nslabs = (K + ks - 1) / ks;
  const int items = (nrows + R - 1) / R * groups;
  for (int base = 0; base < items; base += blockDim.x) {  // uniform across the block
    const int item = base + threadIdx.x;
    const int cg = item % groups, r0 = (item / groups) * R;
    const int c0 = quad ? 4 * cg : cg, cstep = quad ? 1 : groups;  // column e: c0 + e * cstep
    const float* x = in + r0 * ldi;
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
    __syncthreads();  // every thread is done with WS (the previous product or pass)
    stage_span(W, ncols, 0, ks, stage);
    for (int s = 0; s < nslabs; ++s) {
      const int k0 = s * ks, kn = min(ks, K - k0);
      if (s + 1 < nslabs) {
        stage_span(W, ncols, k0 + ks, min(ks, K - k0 - ks), stage + ((s + 1) & 1) * cap);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // slab s is in its buffer for every thread
      if (item < items) {
        const T* ws = stage + (s & 1) * cap + stage_lead(W, ncols, k0) + c0;
        auto wrow = [&](int kk, float (&wv)[4]) {
          if (quad) {
            lds4(ws + kk * ncols, wv);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) wv[e] = Num<T>::ld(ws[kk * ncols + e * cstep]);
          }
        };
        int kk = 0;
        for (; kk + 4 <= kn; kk += 4) {
          float wv[4][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) wrow(kk + q, wv[q]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 xv = *reinterpret_cast<const float4*>(x + r * ldi + k0 + kk);
            const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(xs[q], wv[q][e], acc[r][e]);
          }
        }
        for (; kk < kn; ++kk) {
          float wv[4];
          wrow(kk, wv);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float xk = x[r * ldi + k0 + kk];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(xk, wv[e], acc[r][e]);
          }
        }
      }
      __syncthreads();  // every thread is done with this buffer before slab s + 2 fills it
    }
    if (item < items) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + e * cstep < ncols) epi(r0 + r, c0 + e * cstep, acc[r][e]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a * b over one m16n8k16 tile: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NPW consecutive bf16 of one weight row, 2 * NPW-byte aligned, as 32-bit
// words (column e in half e % 2 of word e / 2): one vector load.
template <int NPW>
__device__ __forceinline__ void load_cols(const unsigned short* p, uint32_t (&wd)[(NPW + 1) / 2]) {
  if constexpr (NPW == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    wd[0] = v.x;
    wd[1] = v.y;
  } else {
    wd[0] = __ldg(p);
  }
}

// tile_mm's product on the tensor cores, for a bf16 W: warp-level mma.sync
// m16n8k16, bf16 operands, f32 accumulation.  The tile holds 32 rows; its
// first ceil(nrows/16) m16 tiles are computed (nrows <= 32), rows past nrows
// and k past K read as zero.  A warp owns a group of 8 * NPW consecutive
// columns as NPW n8 tiles, interleaved: column nn of tile j is group column
// NPW * nn + j, so the B fragment of lane (g, q) (column nn = g; k = 2q, 2q+1,
// 2q+8, 2q+9) is NPW consecutive bf16 of each of its four weight rows: one
// vector load per row, full 32-byte sectors across the warp (a group that
// runs past ncols, or a W not aligned for it, loads column by column).  Each
// B fragment serves both m16 tiles.  A fragments come from the f32 tile as
// float2 pairs packed to bf16 (exact: every call site's tile holds
// bf16-rounded values).  The loads of a k16 step carry no branches, so they
// are all in flight at once.  Fragment coordinates: row lane/4 (+8), k or
// column 2*(lane%4) (+1, +8, +9).  epi(r, c, acc) consumes each result with
// c < ncols, for every row of the computed m16 tiles.
template <int NPW, typename Epi>
__device__ __forceinline__ void tile_mma(const float* __restrict__ in, int ldi, int nrows, int K,
                                         const __nv_bfloat16* __restrict__ W, int ncols, Epi epi) {
  static_assert(NPW == 1 || NPW == 4, "a lane loads 1 or 4 columns");
  constexpr int NW = (NPW + 1) / 2;  // 32-bit words per lane and weight row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int mtiles = nrows > 16 ? 2 : 1;
  const unsigned short* w = reinterpret_cast<const unsigned short*>(W);
  const bool aligned = ncols % NPW == 0 && reinterpret_cast<uintptr_t>(W) % (2 * NPW) == 0;
  const float* row[2][2];  // [m16 tile][row g, row g + 8]
  bool row_ok[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = mt * 16 + rh * 8 + g;
      row[mt][rh] = in + r * ldi;
      row_ok[mt][rh] = r < nrows;
    }
  for (int base = warp * 8 * NPW; base < ncols; base += (blockDim.x / 32) * 8 * NPW) {
    const int col0 = base + NPW * g;  // this lane's B columns col0 .. col0 + NPW - 1
    const unsigned short* wcol = w + col0;
    float acc[2][NPW][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    // one k16 step at k0; FULL: the group lies inside ncols and W is aligned
    // (vector loads); RAGGED: the last step when 16 does not divide K
    auto step = [&](int k0, auto full_tag, auto ragged_tag) {
      constexpr bool FULL = decltype(full_tag)::value, RAGGED = decltype(ragged_tag)::value;
      uint32_t b[NPW][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + 2 * q + 8 * h;
        uint32_t wd[2][NW] = {};  // weight rows k and k + 1
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const unsigned short* p = wcol + (k + kk) * ncols;
          if constexpr (FULL) {
            if (!RAGGED || k + kk < K) load_cols<NPW>(p, wd[kk]);
          } else {
#pragma unroll
            for (int e = 0; e < NPW; ++e)
              if (col0 + e < ncols && (!RAGGED || k + kk < K))
                wd[kk][e / 2] |= (uint32_t)__ldg(p + e) << (16 * (e % 2));
          }
        }
#pragma unroll
        for (int j = 0; j < NPW; ++j)
          b[j][h] = __byte_perm(wd[0][j / 2], wd[1][j / 2], j % 2 ? 0x7632 : 0x5410);
      }
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = k0 + 2 * q + 8 * h;
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            uint32_t v = 0u;
            if (row_ok[mt][rh] && (!RAGGED || k < K)) {
              const float2 x = *reinterpret_cast<const float2*>(row[mt][rh] + k);
              v = pack_bf16x2(x.x, (!RAGGED || k + 1 < K) ? x.y : 0.f);
            }
            a[mt][2 * h + rh] = v;
          }
        }
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        mma_16816(acc[0][j], a[0], b[j][0], b[j][1]);
        if (mtiles > 1) mma_16816(acc[1][j], a[1], b[j][0], b[j][1]);  // warp-uniform
      }
    };
    auto run = [&](auto full_tag) {
      int k0 = 0;
      for (; k0 + 16 <= K; k0 += 16) step(k0, full_tag, std::false_type{});
      if (k0 < K) step(k0, full_tag, std::true_type{});
    };
    if (aligned && base + 8 * NPW <= ncols) {  // warp-uniform
      run(std::true_type{});
    } else {
      run(std::false_type{});
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= mtiles) continue;
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = mt * 16 + rh * 8 + g, c = base + NPW * (2 * q + e) + j;
            if (c < ncols) epi(r, c, acc[mt][j][2 * rh + e]);
          }
    }
  }
}

// The products with many columns (a stage's merged and gate products, the
// first GCP's scalar and gate products): on the tensor cores (tile_mma, NPW
// n8 tiles per warp) in the bf16 instantiation; on the FMA pipes (tile_mm,
// RPT rows per thread) in float32, whose products stay full f32 (no TF32).
template <int NPW, int RPT, typename T, typename Epi>
__device__ __forceinline__ void wide_mm(const float* in, int ldi, int nrows, int K, const T* W,
                                        int ncols, Epi epi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    tile_mma<NPW>(in, ldi, nrows, K, W, ncols, epi);
  } else {
    tile_mm<RPT>(in, ldi, nrows, K, W, ncols, epi);
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
// compute dtype is rounded at the same point, and the merged and gate
// products run on the tensor cores (wide_mm).  Starts and ends at a block
// barrier.  Shared by the message layer and the flat-row chain kernel.
template <int TR, typename T>
__device__ __forceinline__ void chain_stage(const ChainTile& t, int nrows, int S, int V, int Hc,
                                            const T* wcomb, const T* wsc, const T* bsc,
                                            const T* wubd, const T* wgc, const T* bgc) {
  static_assert(TR == 32, "tile_mma computes tiles of 32 rows");
  using NT = Num<T>;
  const int V3 = 3 * V, Wc = 3 * Hc + 27;
  tile_mm<8>(t.Vb, t.ldv, nrows, V3, wcomb, Wc,
             [&](int r, int c, float acc) { t.Hb[r * t.ldh + c] = acc; });
  __syncthreads();
  PHASE_MARK();
  norms_and_frames<TR, T>(t.Hb, t.ldh, t.FT, t.A + S, t.lda, Hc);
  __syncthreads();
  PHASE_MARK();
  wide_mm<4, 8>(t.A, t.lda, nrows, S + Hc + 9, wsc, S, [&](int r, int c, float acc) {
    const float s2 = acc + NT::ld(bsc[c]);
    t.X[r * t.ldx + c] = NT::rnd(s2 * sigmoid_f(s2));
  });
  __syncthreads();
  PHASE_MARK();
  wide_mm<1, 4>(t.X, t.ldx, nrows, S, wgc, V, [&](int r, int c, float acc) {
    t.Gt[r * t.ldg + c] = NT::rnd(sigmoid_f(acc + NT::ld(bgc[c])));
  });
  __syncthreads();
  PHASE_MARK();
  tile_mm<8>(t.Hb, t.ldh, nrows, 3 * Hc, wubd, V3, [&](int r, int c, float acc) {
    float* v = t.Vb + r * t.ldv + c;
    *v = NT::rnd(*v + NT::rnd(NT::rnd(acc) * t.Gt[r * t.ldg + c % V]));
  });
  for (int idx = threadIdx.x; idx < TR * S; idx += blockDim.x) {
    const int r = idx / S, c = idx % S;
    t.A[r * t.lda + c] = NT::rnd(t.A[r * t.lda + c] + t.X[r * t.ldx + c]);
  }
  __syncthreads();
  PHASE_MARK();
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
