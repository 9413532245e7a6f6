// K5 qsq_quantize: the QSQ encoder.  w (K, N) f32 or bf16, grouped along K
// in groups of G -> Table II codes (K, N) uint8 and scales (K/G, N) f32:
//   alpha = sum(|w|) / (phi * G)                                   (Eq. 9)
//   code  = nearest level of w / alpha in {0, +-1, +-2, +-4}, capped by phi
//
// Replaces: src/repro/kernels/qsq_quantize.py:54 qsq_quantize
//           (_qsq_quantize_kernel, pallas_call at :73).
//
// Bound on an H100 (3.35 TB/s HBM): bytes.  Each value is read once (4 B
// for f32) and its code written once (1 B), plus one 4-byte scale per
// group; the work is a few compares and one division per value, far below
// the card's f32 rate.  The gradient compressor's eleven leaves of
// smollm-135m move about 1.03 GB per train step, a bound near 0.31 ms.
//
// Design (simple and right first): one thread per (group, column).  The
// flat thread index runs along N fastest, so neighbouring threads read
// neighbouring columns of the same row and every row read and code write
// coalesces.  A thread reads its G values down K once into registers
// (G a power of two up to 64 is a template parameter; any other G reads
// its group twice), sums |w| in plain K order, divides once for alpha
// (IEEE division: the build has no fast-math), then divides each value by
// alpha and applies the nearest-level thresholds 0.5 / 1.5 / 3.0 and the
// phi cap.  The plain version (kernels/ref.py qsq_quantize_ref) sums in the
// same order, so kernel and plain version agree bit for bit.  Every index
// is 64-bit and the grid is one-dimensional, so G = 2 over a 30-layer
// stack (53 M groups) fits.  The ragged edge is the last block's tail.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Nearest level of r capped at max_level -> Table II code: +1, +2, +4 ->
// 1, 2, 3; -1, -2, -4 -> 4, 5, 6; zero (and -0) -> 0.
__device__ __forceinline__ uint8_t table2_code(float r, int max_level) {
  const float a = fabsf(r);
  int mag = a < 0.5f ? 0 : (a < 1.5f ? 1 : (a < 3.0f ? 2 : 4));
  mag = min(mag, max_level);
  const int idx = mag == 4 ? 3 : mag;
  return (uint8_t)(r < 0.0f ? (idx > 0 ? idx + 3 : 0) : idx);
}

// GS > 0: the group size, known at compile time; GS == 0: runtime G.
template <typename T, int GS>
__global__ void __launch_bounds__(kThreads)
qsq_quantize_kernel(const T* __restrict__ w, uint8_t* __restrict__ codes,
                    float* __restrict__ scales, int64_t n_groups, int64_t N,
                    int G_rt, float denom, int max_level) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_groups * N) return;
  const int64_t g = t / N;
  const int64_t n = t - g * N;
  const int G = GS > 0 ? GS : G_rt;
  const int64_t base = g * G * N + n;

  float s = 0.0f;
  float alpha, safe;
  if constexpr (GS > 0) {
    float v[GS];
#pragma unroll
    for (int i = 0; i < GS; ++i) {
      v[i] = widen(w[base + i * N]);
      s += fabsf(v[i]);
    }
    alpha = s / denom;
    safe = alpha == 0.0f ? 1.0f : alpha;
#pragma unroll
    for (int i = 0; i < GS; ++i)
      codes[base + i * N] = table2_code(v[i] / safe, max_level);
  } else {
    for (int i = 0; i < G; ++i) s += fabsf(widen(w[base + i * N]));
    alpha = s / denom;
    safe = alpha == 0.0f ? 1.0f : alpha;
    for (int i = 0; i < G; ++i)
      codes[base + i * N] = table2_code(widen(w[base + i * N]) / safe, max_level);
  }
  scales[t] = alpha;
}

template <typename T>
void launch_t(const void* w, void* codes, void* scales, int64_t n_groups,
              int64_t N, int G, float denom, int max_level, int64_t blocks,
              cudaStream_t stream) {
  const T* wp = static_cast<const T*>(w);
  uint8_t* cp = static_cast<uint8_t*>(codes);
  float* sp = static_cast<float*>(scales);
#define QSQ_QUANT(GSV)                                                        \
  qsq_quantize_kernel<T, GSV><<<(unsigned)blocks, kThreads, 0, stream>>>(     \
      wp, cp, sp, n_groups, N, G, denom, max_level)
  switch (G) {
    case 1: QSQ_QUANT(1); break;
    case 2: QSQ_QUANT(2); break;
    case 4: QSQ_QUANT(4); break;
    case 8: QSQ_QUANT(8); break;
    case 16: QSQ_QUANT(16); break;
    case 32: QSQ_QUANT(32); break;
    case 64: QSQ_QUANT(64); break;
    default: QSQ_QUANT(0); break;
  }
#undef QSQ_QUANT
}

}  // namespace

// Returns -1 on operands the kernel does not take, else cudaGetLastError()
// right after the launch (0 on success).
extern "C" int qsq_quantize(const void* w, void* codes, void* scales, int K,
                            int N, int G, int phi, int w_bf16, void* stream) {
  if (K < 1 || N < 1 || G < 1 || K % G) return -1;
  if (phi != 1 && phi != 2 && phi != 4) return -1;
  const int64_t n_groups = K / G;
  const int64_t blocks = (n_groups * N + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return -1;
  // max level: phi 1, 2, 4 -> 1, 2, 4; denominator phi * G as one f32
  const float denom = (float)(phi * G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    launch_t<__nv_bfloat16>(w, codes, scales, n_groups, N, G, denom, phi,
                            blocks, s);
  else
    launch_t<float>(w, codes, scales, n_groups, N, G, denom, phi, blocks, s);
  return (int)cudaGetLastError();
}
