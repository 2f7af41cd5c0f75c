// Per-pass cost probe: one elementwise op repeated k times over an f32
// array, for Hopper (sm_90a).
//
// Replaces: scripts/bench_vpu_passes.py::main.build (a Pallas kernel that
// runs one of nine ops k times over [rows, 256] f32 blocks, to price the
// TPU vector unit's passes).  Here each element is loaded once, carried
// through k passes of the op in a register and stored once, so the slope of
// the launch time over k is the card's cost of one pass over the array.
//
// What bounds it on an H100.  One launch reads and writes the array once
// (at the default [90250, 256] shape 184.8 MB, ~55 us at 3.35 TB/s); each
// pass is one op per element, which runs on the FMA pipes (add, mul, the
// casts) or needs the special-function unit (exp, tanh, rsqrt).  At k = 104
// the passes, not the bytes, set the time, which is what the probe prices.
//
// What the design does about it.  Grid-stride over the flat array (any
// shape, no truncation to whole blocks), one element per thread per
// iteration, the k passes in a runtime loop of 8 passes per trip
// (`#pragma unroll 1` on the trips), with an empty asm statement on the value
// between passes so that nvcc cannot fold the affine (add, mul) or idempotent
// (cast round trip) chains into one op.
// The ops call the device functions the port's kernels call: expf (the
// sigmoid of message_layer_common.cuh), tanhf, rsqrtf and the bf16 rounding.

#include "message_layer_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;  // passes per loop trip

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

template <int OP>
__global__ void __launch_bounds__(THREADS)
passes_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, int k) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float y = x[i];
    int p = 0;
    // UNROLL passes per trip keep the loop's own instructions small beside the
    // op's; the empty asm is a pass boundary the compiler cannot see through
#pragma unroll 1
    for (; p + UNROLL <= k; p += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        y = apply<OP>(y);
        asm volatile("" : "+f"(y));
      }
    }
#pragma unroll 1
    for (; p < k; ++p) {
      y = apply<OP>(y);
      asm volatile("" : "+f"(y));
    }
    out[i] = y;
  }
}

template <int OP>
int launch(const float* x, float* out, long long n, int k, cudaStream_t stream) {
  const long long want = (n + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < (1 << 20) ? want : (1 << 20));
  passes_kernel<OP><<<blocks, THREADS, 0, stream>>>(x, out, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = op applied k times to each of the n elements of x (device pointers,
// f32); returns a cudaError_t code (0 on success).
int elementwise_passes(int op, const void* x, void* out, long long n, int k, void* stream) {
  if (n <= 0 || k < 0 || op < 0 || op >= NUM_OPS) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case TANH: return launch<TANH>(xf, of, n, k, s);
    case EXP: return launch<EXP>(xf, of, n, k, s);
    case SIGMOID_EXP: return launch<SIGMOID_EXP>(xf, of, n, k, s);
    case SIGMOID_TANH: return launch<SIGMOID_TANH>(xf, of, n, k, s);
    case SILU_TANH: return launch<SILU_TANH>(xf, of, n, k, s);
    case ADD: return launch<ADD>(xf, of, n, k, s);
    case MUL: return launch<MUL>(xf, of, n, k, s);
    case RSQRT: return launch<RSQRT>(xf, of, n, k, s);
    default: return launch<CAST_ROUNDTRIP>(xf, of, n, k, s);
  }
}

}  // extern "C"
