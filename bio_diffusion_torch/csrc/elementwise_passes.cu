// Per-pass cost probe: one elementwise op repeated k times over an f32
// array, for Hopper (sm_90a).
//
// Replaces: scripts/bench_vpu_passes.py::main.build (a Pallas kernel that
// runs one of nine ops k times over [rows, 256] f32 blocks, to price the
// TPU vector unit's passes).  Here each element is loaded once, carried
// through k passes of the op in a register and stored once, so the slope of
// the launch time over k is the card's cost of one pass over the array.
//
// What bounds it on an H100, by class of op (cli/bench_passes.py::
// pass_bound_ms takes the largest of the three, from each op's SASS counts):
// - bytes, at small k: one launch reads and writes the array once (at the
//   default [90250, 256] shape 184.8 MB, 55 us at 3.35 TB/s);
// - issue slots: an SM sub-partition issues one warp instruction a clock to
//   a 32-lane FMA pipe, so add and mul (one FADD or FMUL a pass) lose a
//   pass's slot to every other instruction in the loop (counter, compare,
//   branch, tile bookkeeping), and exp, the sigmoids and silu (8 to 19
//   instructions a pass, 1 or 2 of them MUFU) are held by their FMA-pipe
//   work;
// - the 16-lane unit an SM that runs MUFU and the float conversions: tanh
//   (ex2 and rcp in 16 instructions, even with its issue slots), rsqrt
//   (FADD and MUFU.RSQ) and the bf16 round trip (F2F and a shift).
// A pass waits on the previous one's result, so with one element a thread
// only the other resident warps hide each op's latency.
//
// What the design does about it.
// - E = 8 independent elements a thread (two float4): one pass applies the
//   op to all E registers, so E independent chains issue back to back.
//   (E = 4 was within 3% of E = 8 on every op; PERF.md.)  One empty asm statement over all E registers ends each pass: the
//   compiler cannot fold the affine (add, mul) or idempotent (cast round
//   trip) chains across it.  8 passes a loop trip: the loop's own counter,
//   compare and branch are spread over 8 E ops.
// - A persistent grid (SMs x resident blocks an SM, from the occupancy API,
//   read once by the wrapper) walks tiles of THREADS x E elements, each
//   block taking its tiles in order from a counter of the launch (an atomic
//   add by one thread, issued a tile ahead).  Blocks that take tiles by a
//   fixed stride start together and stay in step, their warps reaching the
//   special-function unit and the memory at the same moments; on the H100
//   that was slower than the counter at every k, most for sigmoid_exp.
// - The next tile is copied in under the current tile's passes: one thread
//   issues a 1-D bulk copy (cp.async.bulk, the Hopper asynchronous copy) of
//   the tile after next into a two-stage shared-memory ring, completing on an
//   mbarrier, so the threads spend no registers and almost no issue slots on
//   the stream.  Stores go straight from registers as float4.  (A register
//   double buffer, each thread loading its next float4s before the passes,
//   was as fast or slower at k = 8 on every op; PERF.md.)
// - Any n and any 4-byte-aligned address: a scalar head up to the first
//   16-byte boundary, the float4 body in tiles, a scalar tail
//   (ops/passes.py::split_for_vectors computes the split; the ends run on
//   block 0, in the same pass order).
// The ops call the device functions the port's kernels call: expf (the
// sigmoid of message_layer_common.cuh), tanhf, rsqrtf and the bf16 rounding;
// no fast-math forms, so every element's result is the same bits whatever
// E, the tile or the grid.

#include "message_layer_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;  // passes a loop trip
constexpr int STAGES = 2;  // tiles in the shared-memory ring
constexpr int E = 8;  // elements a thread a tile
constexpr int V = E / 4;  // float4 a thread a tile
constexpr int TILE4 = THREADS * V;  // float4 a tile

// the op ids, in the order of bio_diffusion_torch/ops/passes.py::OPS
enum Op {
  TANH, EXP, SIGMOID_EXP, SIGMOID_TANH, SILU_TANH, ADD, MUL, RSQRT, CAST_ROUNDTRIP, NUM_OPS
};

template <int OP>
__device__ __forceinline__ float apply(float y) {
  if (OP == TANH) return tanhf(y);
  if (OP == EXP) return expf(y);
  if (OP == SIGMOID_EXP) return sigmoid_f(y);
  if (OP == SIGMOID_TANH) return 0.5f * (tanhf(0.5f * y) + 1.f);
  if (OP == SILU_TANH) return y * (0.5f * (tanhf(0.5f * y) + 1.f));
  if (OP == ADD) return y + 1.f;
  if (OP == MUL) return y * 1.0001f;
  if (OP == RSQRT) return rsqrtf(fabsf(y) + 1e-8f);
  return Num<__nv_bfloat16>::rnd(y);  // CAST_ROUNDTRIP
}

// the end of a pass over all of a thread's registers: opaque to the compiler
__device__ __forceinline__ void boundary(float (&y)[1]) { asm volatile("" : "+f"(y[0])); }
__device__ __forceinline__ void boundary(float (&y)[8]) {
  asm volatile("" : "+f"(y[0]), "+f"(y[1]), "+f"(y[2]), "+f"(y[3]), "+f"(y[4]), "+f"(y[5]), "+f"(y[6]),
               "+f"(y[7]));
}

// k passes of OP over R independent registers, UNROLL passes a trip
template <int OP, int R>
__device__ __forceinline__ void passes(float (&y)[R], int k) {
  int p = 0;
#pragma unroll 1
  for (; p + UNROLL <= k; p += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) y[r] = apply<OP>(y[r]);
      boundary(y);
    }
  }
#pragma unroll 1
  for (; p < k; ++p) {
#pragma unroll
    for (int r = 0; r < R; ++r) y[r] = apply<OP>(y[r]);
    boundary(y);
  }
}

// the scalar head [0, head) and tail [head + body, n), one element a thread
// of block 0
template <int OP>
__device__ __forceinline__ void scalar_ends(const float* x, float* out, long long n, long long head,
                                            long long body, int k) {
  const long long ends = n - body;
  if (blockIdx.x != 0 || threadIdx.x >= ends) return;
  const long long i = threadIdx.x < head ? threadIdx.x : body + threadIdx.x;
  float y[1] = {x[i]};
  passes<OP>(y, k);
  out[i] = y[0];
}

__device__ __forceinline__ void unpack(float4 v, float* y) {
  y[0] = v.x;
  y[1] = v.y;
  y[2] = v.z;
  y[3] = v.w;
}

// the index of this thread's float4 j of a tile (in the body below body4)
__device__ __forceinline__ long long slot(long long tile, int j) {
  return tile * TILE4 + threadIdx.x + j * THREADS;
}

__device__ __forceinline__ void store_tile(float4* ob, long long body4, long long tile, const float (&y)[E]) {
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (slot(tile, j) < body4)
      ob[slot(tile, j)] = make_float4(y[4 * j], y[4 * j + 1], y[4 * j + 2], y[4 * j + 3]);
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bulk copy of tile `tile` of the body into a ring stage; completes on `bar`
__device__ __forceinline__ void copy_tile(float4* stage, const float4* xb, long long body4, long long tile,
                                          uint64_t* bar) {
  const long long left = body4 - tile * TILE4;
  const uint32_t bytes = 16u * static_cast<uint32_t>(left < TILE4 ? left : TILE4);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(smem(stage)), "l"(xb + tile * TILE4), "r"(bytes), "r"(smem(bar))
               : "memory");
}

__device__ __forceinline__ void wait_tile(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}

// the next tile of the body for this block, in order from the launch's
// counter, or `tiles` once the counter has passed the last
__device__ __forceinline__ long long grab(unsigned long long* counter, long long tiles) {
  const long long t = (long long)atomicAdd(counter, 1ULL);
  return t < tiles ? t : tiles;
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
passes_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, long long head, long long body,
              int k, unsigned long long* __restrict__ counter) {
  scalar_ends<OP>(x, out, n, head, body, k);
  const float4* xb = reinterpret_cast<const float4*>(x + head);
  float4* ob = reinterpret_cast<float4*>(out + head);
  const long long body4 = body / 4;
  const long long tiles = (body4 + TILE4 - 1) / TILE4;
  // the block's i-th tile is tile_of[i % STAGES]: thread 0 takes tiles from
  // the counter STAGES ahead of the one the block computes, and stops at the
  // first past the end
  __shared__ long long tile_of[STAGES];
  // ring of STAGES tiles, filled by bulk copies issued by thread 0: stage
  // i % STAGES holds the block's i-th tile; once every thread has stored
  // its results (the stores read the registers the stage was loaded into),
  // the copy of tile i + STAGES goes into the same stage, ordered after
  // those reads by the barrier and an async-proxy fence
  __shared__ alignas(128) float4 ring[STAGES][TILE4];
  __shared__ alignas(8) uint64_t full[STAGES];
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int s = 0; s < STAGES; ++s) {
      t = t < tiles ? grab(counter, tiles) : tiles;
      tile_of[s] = t;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(&full[s])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      if (t < tiles) copy_tile(ring[s], xb, body4, t, &full[s]);
    }
  }
  __syncthreads();
  float y[E];
  for (int i = 0;; ++i) {
    const int s = i % STAGES;
    const long long t = tile_of[s];
    if (t >= tiles) break;
    // tile i + STAGES, taken now so that the atomic's round trip runs under
    // the passes
    long long t2 = tiles;
    if (threadIdx.x == 0 && tile_of[(i + STAGES - 1) % STAGES] < tiles) t2 = grab(counter, tiles);
    wait_tile(&full[s], (i / STAGES) & 1);
#pragma unroll
    for (int j = 0; j < V; ++j)
      unpack(slot(t, j) < body4 ? ring[s][threadIdx.x + j * THREADS] : make_float4(0.f, 0.f, 0.f, 0.f), y + 4 * j);
    passes<OP>(y, k);
    store_tile(ob, body4, t, y);
    __syncthreads();
    if (threadIdx.x == 0) {
      tile_of[s] = t2;
      if (t2 < tiles) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        copy_tile(ring[s], xb, body4, t2, &full[s]);
      }
    }
    __syncthreads();
  }
}

template <int OP>
int occupancy(int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, passes_kernel<OP>, THREADS, 0);
}

template <int OP>
int launch(const float* x, float* out, long long n, long long head, long long body, int k, int blocks,
           unsigned long long* counter, cudaStream_t stream) {
  const int err = (int)cudaMemsetAsync(counter, 0, sizeof(*counter), stream);
  if (err != 0) return err;
  passes_kernel<OP><<<blocks, THREADS, 0, stream>>>(x, out, n, head, body, k, counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the kernel for `op` resident on one SM of the current device,
// and the device's SMs; returns a cudaError_t code (0 on success).
int elementwise_passes_occupancy(int op, int* blocks_per_sm, int* sms) {
  if (op < 0 || op >= NUM_OPS) return (int)cudaErrorInvalidValue;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0) err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != 0) return err;
  switch (op) {
    case TANH: return occupancy<TANH>(blocks_per_sm);
    case EXP: return occupancy<EXP>(blocks_per_sm);
    case SIGMOID_EXP: return occupancy<SIGMOID_EXP>(blocks_per_sm);
    case SIGMOID_TANH: return occupancy<SIGMOID_TANH>(blocks_per_sm);
    case SILU_TANH: return occupancy<SILU_TANH>(blocks_per_sm);
    case ADD: return occupancy<ADD>(blocks_per_sm);
    case MUL: return occupancy<MUL>(blocks_per_sm);
    case RSQRT: return occupancy<RSQRT>(blocks_per_sm);
    default: return occupancy<CAST_ROUNDTRIP>(blocks_per_sm);
  }
}

// Element passes in one trip of the kernel's main loop: E registers times
// UNROLL passes (for reading its SASS).
int elementwise_passes_trip() { return E * UNROLL; }

// out = op applied k times to each of the n elements of x (device pointers,
// f32), on at most `blocks` blocks.  [0, head) and [head + body, n) are the
// scalar ends (at most 3 elements each), x + head and out + head 16-byte
// aligned and body a multiple of 4; `counter` is 8 bytes of device memory
// that the launch zeroes and takes its tiles from.  Returns a cudaError_t
// code (0 on success).
int elementwise_passes(int op, const void* x, void* out, long long n, long long head, long long body, int k,
                       int blocks, void* counter, void* stream) {
  if (n <= 0 || k < 0 || op < 0 || op >= NUM_OPS || blocks <= 0 || head < 0 || head > 3 || body < 0 ||
      body % 4 != 0 || n - head - body < 0 || n - head - body > 3 || counter == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (body > 0 && ((reinterpret_cast<uintptr_t>(xf + head) | reinterpret_cast<uintptr_t>(of + head)) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const long long tiles = (body / 4 + TILE4 - 1) / TILE4;
  if (blocks > tiles) blocks = tiles > 0 ? (int)tiles : 1;
  unsigned long long* c = static_cast<unsigned long long*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case TANH: return launch<TANH>(xf, of, n, head, body, k, blocks, c, s);
    case EXP: return launch<EXP>(xf, of, n, head, body, k, blocks, c, s);
    case SIGMOID_EXP: return launch<SIGMOID_EXP>(xf, of, n, head, body, k, blocks, c, s);
    case SIGMOID_TANH: return launch<SIGMOID_TANH>(xf, of, n, head, body, k, blocks, c, s);
    case SILU_TANH: return launch<SILU_TANH>(xf, of, n, head, body, k, blocks, c, s);
    case ADD: return launch<ADD>(xf, of, n, head, body, k, blocks, c, s);
    case MUL: return launch<MUL>(xf, of, n, head, body, k, blocks, c, s);
    case RSQRT: return launch<RSQRT>(xf, of, n, head, body, k, blocks, c, s);
    default: return launch<CAST_ROUNDTRIP>(xf, of, n, head, body, k, blocks, c, s);
  }
}

}  // extern "C"
