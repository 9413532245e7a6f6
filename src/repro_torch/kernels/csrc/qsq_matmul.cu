// K3 qsq_matmul and K4 qsq_matmul_masked: the GEMM
// x (M > 16, K) @ decode(planes, scales) (K, N) -> (M, N) f32, the
// admission-prefill shape (M = max_prompt = 64).
//
// Replaces: src/repro/kernels/qsq_matmul.py:262 qsq_matmul
//           (_qsq_matmul_kernel) and :199 qsq_matmul_masked
//           (_qsq_matmul_masked_kernel).
//
// Bound on an H100: at M = 64 the work is 2*64*K*N operations against
// about 5 bits/weight of packed stream (3 planes + one f32 scale per 16
// weights) plus the bf16 x and the f32 output; with bf16 x the operations
// take 989 TFLOP/s on the tensor cores, so the packed bytes at 3.35 TB/s
// still bound it (576 x 49152 head: ~9 us of bytes against ~3.7 us of
// operations).  What holds the kernel back is neither: the decode of every
// code (per demanded variant) in integer instructions, and the occupancy
// that 100-128 registers a thread leave.
//
// Design, for bf16 x and G a multiple of 16: the tensor-core template in
// qsq_mma.cuh with a 64-row tile (MT = 4) through mma.sync m16n8k16 (not
// wgmma: its shared-memory operand descriptors were left for later work).
// Each thread decodes its B fragment in registers, x stays in shared
// memory, plane words and scales stream through per-warp cp.async rings.
// K splits over 4 warps and a cluster of up to 8 blocks with the K2
// fixed-order reduction; the head runs a persistent grid.  K4 sorts the
// tile's rows by variant (stable) and pads each variant's rows to whole
// 16-row tiles (at most 4 + NP - 1 tiles), so each tile takes one MMA, with
// its own variant's weights: row m is bit for bit K3 on truncate(drop_m),
// rows of no demanded variant are zero, and demand routing changes no bit.
//
// f32 x (the test configs), G not a multiple of 16, and an x too large to
// stage keep the first kernel below: 64x64 FMA tiles in plain K order.
//
// ptxas (sm_90a, sign-magnitude plane-major): K3 90-115 registers, K4
// 87-128 (capped at 128 by launch bounds for two blocks an SM; a few
// bytes of spill only in the Table II NP = 3 K4 instantiations), 208-272
// bytes of static shared memory; dynamic shared memory per plan: 34-86 KB
// at the smollm shapes.
#include "qsq_common.cuh"
#include "qsq_mma.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;  // one plane word of codes
constexpr int kThreads = 256;

template <typename T, bool SM, bool PM, bool MASKED>
__global__ void __launch_bounds__(kThreads)
qsq_gemm_kernel(const T* __restrict__ x, const int32_t* __restrict__ planes,
                const float* __restrict__ scales,
                const int32_t* __restrict__ plane_mask, float* __restrict__ out,
                int M, int K, int N, int G, int n_planes, int demand_drop) {
  constexpr int NV = MASKED ? 3 : 1;
  __shared__ float xs[kBM][kBK + 1];
  __shared__ float ws[NV][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int KW = K / 32;

  float acc[4][4];
  int vsel[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    vsel[i] = (MASKED && m < M) ? qsq::variant_of(plane_mask[m], demand_drop) : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  // weight-tile decode assignment: column c, a quarter of the 32 codes
  const int dc = tid % kBN, dq = tid / kBN;
  const int dn = n0 + dc;

  for (int kw = 0; kw < KW; ++kw) {
    const int k0 = kw * 32;
    __syncthreads();
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i - r * kBK;
      const int m = m0 + r;
      xs[r][kk] = m < M ? qsq::to_f32(x[(size_t)m * K + k0 + kk]) : 0.0f;
    }
    {
      uint32_t b0 = 0u, b1 = 0u, b2 = 0u;
      if (dn < N) qsq::load_words<PM>(planes, kw, dn, KW, N, n_planes, b0, b1, b2);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = dq * 8 + jj;
        const float s = dn < N ? scales[(size_t)((k0 + j) / G) * N + dn] : 0.0f;
        const uint32_t code = qsq::code_at(b0, b1, b2, j);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const uint32_t mask = MASKED ? qsq::mask_variant(v) : 7u;
          ws[v][j][dc] = dn < N ? qsq::weight<T>(qsq::decode<SM>(code & mask), s) : 0.0f;
        }
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = xs[ty + 16 * i][kk];
        const int v = MASKED ? vsel[i] : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float w = v >= 0 ? ws[v][kk][tx + 16 * j] : 0.0f;
          acc[i][j] = fmaf(a, w, acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <typename T, bool MASKED>
void launch_t(const void* x, const void* planes, const void* scales,
              const void* plane_mask, void* out, int M, int K, int N, int G,
              int sign_mag, int plane_major, int n_planes, int demand_drop,
              cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const T* xp = static_cast<const T*>(x);
  const int32_t* pp = static_cast<const int32_t*>(planes);
  const float* sp = static_cast<const float*>(scales);
  const int32_t* mp = static_cast<const int32_t*>(plane_mask);
  float* op = static_cast<float*>(out);
#define QSQ_GEMM(SMV, PMV)                                                   \
  qsq_gemm_kernel<T, SMV, PMV, MASKED><<<grid, kThreads, 0, stream>>>(       \
      xp, pp, sp, mp, op, M, K, N, G, n_planes, demand_drop)
  if (sign_mag && plane_major) QSQ_GEMM(true, true);
  else if (sign_mag) QSQ_GEMM(true, false);
  else if (plane_major) QSQ_GEMM(false, true);
  else QSQ_GEMM(false, false);
#undef QSQ_GEMM
}

template <bool MASKED>
int launch(const void* x, const void* planes, const void* scales,
           const void* plane_mask, void* out, int M, int K, int N, int G,
           int x_bf16, int sign_mag, int plane_major, int n_planes,
           int demand_drop, int nt, int wn, int wk, int cs, int persist,
           void* stream) {
  if (M < 1 || K % 32 || G < 1 || K % G) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && G % 16 == 0 && nt > 0) {  // the tensor-core route (qsq_mma.cuh), 64-row tiles
    qsq::mma::Args a = {};
    a.x = static_cast<const __nv_bfloat16*>(x);
    a.planes = static_cast<const int32_t*>(planes);
    a.scales = static_cast<const float*>(scales);
    a.plane_mask = static_cast<const int32_t*>(plane_mask);
    a.out = static_cast<float*>(out);
    a.M = M; a.K = K; a.N = N; a.G = G;
    a.wn = wn; a.wk = wk; a.cs = cs; a.persist = persist;
    a.demand_drop = demand_drop;
    if (nt == 1) return qsq::mma::launch<4, 1, MASKED>(a, n_planes, sign_mag, plane_major, s);
    if (nt == 2) return qsq::mma::launch<4, 2, MASKED>(a, n_planes, sign_mag, plane_major, s);
    return -1;
  }
  if (x_bf16)
    launch_t<__nv_bfloat16, MASKED>(x, planes, scales, plane_mask, out, M, K,
                                    N, G, sign_mag, plane_major, n_planes,
                                    demand_drop, s);
  else
    launch_t<float, MASKED>(x, planes, scales, plane_mask, out, M, K, N, G,
                            sign_mag, plane_major, n_planes, demand_drop, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qsq_matmul(const void* x, const void* planes, const void* scales,
                          void* out, int M, int K, int N, int G, int x_bf16,
                          int sign_mag, int plane_major, int n_planes, int nt,
                          int wn, int wk, int cs, int persist, void* stream) {
  return launch<false>(x, planes, scales, nullptr, out, M, K, N, G, x_bf16,
                       sign_mag, plane_major, n_planes, 0, nt, wn, wk, cs, persist,
                       stream);
}

extern "C" int qsq_matmul_masked(const void* x, const void* plane_mask,
                                 const void* planes, const void* scales,
                                 void* out, int M, int K, int N, int G,
                                 int x_bf16, int sign_mag, int plane_major,
                                 int demand_drop, int nt, int wn, int wk, int cs,
                                 int persist, void* stream) {
  return launch<true>(x, planes, scales, plane_mask, out, M, K, N, G, x_bf16,
                      sign_mag, plane_major, 3 - demand_drop, demand_drop, nt, wn,
                      wk, cs, persist, stream);
}
