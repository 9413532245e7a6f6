// K1 qsq_matvec and K2 qsq_matvec_masked: the decode-shape GEMV
// x (M <= 16, K) @ decode(planes, scales) (K, N) -> (M, N) f32.  The
// tensor-core route also takes the GEMM wrappers' calls whose K is too long
// for 64 resident x rows (any M, one 16-row tile a block along grid y).
//
// Replaces: src/repro/kernels/qsq_matvec.py:183 qsq_matvec
//           (_qsq_matvec_kernel) and :119 qsq_matvec_masked
//           (_qsq_matvec_masked_kernel).
//
// Bound on an H100 (3.35 TB/s HBM): the packed weight stream.  Per launch
// the kernel must read (3 - demand_drop) * K/32 * N int32 plane words plus
// K/G * N f32 scales; x (M*K) and the output (M*N) are small.  smollm-135m's
// head (576 x 49152) is 17.7 MB, 5.3 us; the layer shapes are a few hundred
// KB, far below the ~5 us a launch costs, so there the latency chain of one
// call (launch, first DRAM touch, a few words, the cluster's reduction)
// sets the time.
//
// Design, for bf16 x (the served dtype): the tensor-core template in
// qsq_mma.cuh with one 16-row MMA tile (MT = 1), x as A, each thread
// decoding its own B fragment.  The launch plan (kernels/qsq.py
// launch_plan) splits K over 4 warps of a block and a thread-block cluster
// of up to 8 blocks, 8 columns a warp, so every layer shape puts 96-192
// blocks on the 132 SMs; the head runs a persistent grid, 16 columns a
// warp over all of K.  Partial sums add in a fixed order: warps of a block
// in warp order through shared memory, then rank 0 of the cluster adds the
// other ranks' sums, pushed into its shared memory, in rank order.  One
// launch, no workspace, no atomics.  K2 keeps one accumulator set per
// demanded variant (NP = 3 - demand_drop, a template) and each row takes
// its own; the decode of a variant clears whole plane words, so row m is
// bit for bit K1 on truncate(drop_m) (the same split, the same MMAs), and
// demand routing changes no bit.
//
// f32 x (the test configs) keeps the first kernel below: one thread per
// output column, FMAs in plain K order, x staged in shared memory.
//
// ptxas (sm_90a, sign-magnitude plane-major, the served case): 64-74
// registers at 8 columns a warp and 67-90 at 16, no spills; 192-208 bytes
// of static shared memory; dynamic shared memory per plan (x over the
// block's K range, 8-stage rings, cluster slots): 12-39 KB at the smollm
// shapes.
#include "qsq_common.cuh"
#include "qsq_mma.cuh"

namespace {

constexpr int kMMax = 16;    // dispatch.GEMV_M_MAX
constexpr int kThreads = 64;  // columns per block
constexpr int kChunk = 256;   // K values of x staged per pass

template <typename T, bool SM, bool PM, bool MASKED>
__global__ void __launch_bounds__(kThreads)
qsq_gemv_kernel(const T* __restrict__ x, const int32_t* __restrict__ planes,
                const float* __restrict__ scales,
                const int32_t* __restrict__ plane_mask, float* __restrict__ out,
                int M, int K, int N, int G, int n_planes, int demand_drop) {
  __shared__ float xs[kMMax * kChunk];
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < N;
  const int KW = K / 32;

  float acc[kMMax];
  int vsel[kMMax];
#pragma unroll
  for (int m = 0; m < kMMax; ++m) {
    acc[m] = 0.0f;
    vsel[m] = (MASKED && m < M) ? qsq::variant_of(plane_mask[m], demand_drop) : 0;
  }

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < M * kc; i += kThreads) {
      const int m = i / kc, kk = i - m * kc;
      xs[m * kChunk + kk] = qsq::to_f32(x[(size_t)m * K + k0 + kk]);
    }
    __syncthreads();
    if (!live) continue;
    for (int kw = k0 / 32; kw < (k0 + kc) / 32; ++kw) {
      uint32_t b0, b1, b2;
      qsq::load_words<PM>(planes, kw, n, KW, N, n_planes, b0, b1, b2);
      // G is a multiple of 16: a 32-code word spans at most two groups
      const float s_lo = scales[(size_t)((kw * 32) / G) * N + n];
      const float s_hi = scales[(size_t)((kw * 32 + 16) / G) * N + n];
      const float* xk = xs + (kw * 32 - k0);
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const uint32_t code = qsq::code_at(b0, b1, b2, j);
        const float s = j < 16 ? s_lo : s_hi;
        if (MASKED) {
          const float w0 = qsq::weight<T>(qsq::decode<SM>(code & 7u), s);
          const float w1 = qsq::weight<T>(qsq::decode<SM>(code & 6u), s);
          const float w2 = qsq::weight<T>(qsq::decode<SM>(code & 4u), s);
#pragma unroll
          for (int m = 0; m < kMMax; ++m) {
            if (m < M) {
              const int v = vsel[m];
              const float w = v == 0 ? w0 : (v == 1 ? w1 : (v == 2 ? w2 : 0.0f));
              acc[m] = fmaf(xk[m * kChunk + j], w, acc[m]);
            }
          }
        } else {
          const float w = qsq::weight<T>(qsq::decode<SM>(code), s);
#pragma unroll
          for (int m = 0; m < kMMax; ++m)
            if (m < M) acc[m] = fmaf(xk[m * kChunk + j], w, acc[m]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int m = 0; m < kMMax; ++m)
    if (m < M) out[(size_t)m * N + n] = acc[m];
}

template <typename T, bool MASKED>
void launch_t(const void* x, const void* planes, const void* scales,
              const void* plane_mask, void* out, int M, int K, int N, int G,
              int sign_mag, int plane_major, int n_planes, int demand_drop,
              cudaStream_t stream) {
  const dim3 grid((N + kThreads - 1) / kThreads);
  const T* xp = static_cast<const T*>(x);
  const int32_t* pp = static_cast<const int32_t*>(planes);
  const float* sp = static_cast<const float*>(scales);
  const int32_t* mp = static_cast<const int32_t*>(plane_mask);
  float* op = static_cast<float*>(out);
#define QSQ_GEMV(SMV, PMV)                                                   \
  qsq_gemv_kernel<T, SMV, PMV, MASKED><<<grid, kThreads, 0, stream>>>(       \
      xp, pp, sp, mp, op, M, K, N, G, n_planes, demand_drop)
  if (sign_mag && plane_major) QSQ_GEMV(true, true);
  else if (sign_mag) QSQ_GEMV(true, false);
  else if (plane_major) QSQ_GEMV(false, true);
  else QSQ_GEMV(false, false);
#undef QSQ_GEMV
}

template <bool MASKED>
int launch(const void* x, const void* planes, const void* scales,
           const void* plane_mask, void* out, int M, int K, int N, int G,
           int x_bf16, int sign_mag, int plane_major, int n_planes,
           int demand_drop, int nt, int wn, int wk, int cs, int persist,
           void* stream) {
  if (M < 1 || K % 32 || G % 16 || K % G) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The tensor-core route (qsq_mma.cuh): 16-row tiles, one a block along
  // grid y.  Any M: the GEMM wrappers take this route where K is too long
  // for the GEMM's 64 resident x rows (kernels/qsq.py launch_plan).
  if (x_bf16 && nt > 0) {
    qsq::mma::Args a = {};
    a.x = static_cast<const __nv_bfloat16*>(x);
    a.planes = static_cast<const int32_t*>(planes);
    a.scales = static_cast<const float*>(scales);
    a.plane_mask = static_cast<const int32_t*>(plane_mask);
    a.out = static_cast<float*>(out);
    a.M = M; a.K = K; a.N = N; a.G = G;
    a.wn = wn; a.wk = wk; a.cs = cs; a.persist = persist;
    a.demand_drop = demand_drop;
    if (nt == 1) return qsq::mma::launch<1, 1, MASKED>(a, n_planes, sign_mag, plane_major, s);
    if (nt == 2) return qsq::mma::launch<1, 2, MASKED>(a, n_planes, sign_mag, plane_major, s);
    return -1;
  }
  if (M > kMMax) return -1;
  if (x_bf16)  // a plan of the FMA route: x too large to stage in shared memory
    launch_t<__nv_bfloat16, MASKED>(x, planes, scales, plane_mask, out, M, K, N, G,
                                    sign_mag, plane_major, n_planes, demand_drop, s);
  else
    launch_t<float, MASKED>(x, planes, scales, plane_mask, out, M, K, N, G, sign_mag,
                            plane_major, n_planes, demand_drop, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qsq_matvec(const void* x, const void* planes, const void* scales,
                          void* out, int M, int K, int N, int G, int x_bf16,
                          int sign_mag, int plane_major, int n_planes, int nt,
                          int wn, int wk, int cs, int persist, void* stream) {
  return launch<false>(x, planes, scales, nullptr, out, M, K, N, G, x_bf16,
                       sign_mag, plane_major, n_planes, 0, nt, wn, wk, cs, persist,
                       stream);
}

extern "C" int qsq_matvec_masked(const void* x, const void* plane_mask,
                                 const void* planes, const void* scales,
                                 void* out, int M, int K, int N, int G,
                                 int x_bf16, int sign_mag, int plane_major,
                                 int demand_drop, int nt, int wn, int wk, int cs,
                                 int persist, void* stream) {
  return launch<true>(x, planes, scales, plane_mask, out, M, K, N, G, x_bf16,
                      sign_mag, plane_major, 3 - demand_drop, demand_drop, nt, wn,
                      wk, cs, persist, stream);
}
