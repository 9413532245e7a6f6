// The tensor-core kernel behind K1-K4 for bf16 x (qsq_matvec.cu,
// qsq_matmul.cu): out (M, N) f32 = x (M, K) bf16 @ decode(planes, scales).
//
// One template serves the GEMV (MT = 1: one 16-row tile, M <= 16) and the
// GEMM (MT = 4: a 64-row tile per warp).  Its parts:
//
//   Tensor cores.  mma.sync m16n8k16 bf16 -> f32 with x as the A operand
//     (16 rows by 16 k) and the decoded weight as B (16 k by 8 columns).
//     Each thread of a warp decodes exactly the weights of its own B
//     fragment in registers: column g = lane/4 of the 8-column tile and
//     the four codes 4t..4t+3 (t = lane%4) of each 16-code half of a plane
//     word.  The k order inside one MMA is permuted to match (MMA slot
//     2t, 2t+1, 2t+8, 2t+9 <- code 4t..4t+3), and the A fragment takes x
//     in the same permutation, so one 8-byte shared load gives it.
//   Decode.  A bf16 weight is bf16_rn(level * alpha) exactly as
//     qsq::weight<__nv_bfloat16> builds it: per (column, 16 codes) the
//     table {0, bf16(a), bf16(2a), bf16(4a)} is built once, and four codes
//     become two bf16x2 words with two byte permutes (prmt) and an XOR of
//     the sign bits.  A mask variant clears whole plane words, so only the
//     demanded variants are decoded (NP = planes read, a template).
//   Staging.  Each block owns BN = wn * NT * 8 columns, a 16*MT-row tile
//     and a K range; its warps split that range again (wk).  x over the
//     block's K range is loaded once into shared memory and stays there.
//     Each warp streams its own columns' plane words (NP planes) and two
//     scale rows per 32-code word through its own ring of cp.async stages
//     (16-byte copies; 4-byte copies where N % 4 or alignment forbids),
//     synchronising only within the warp, so the next words' loads overlap
//     this word's decode and MMAs.  A persistent launch (wide N) sizes the
//     grid to the blocks the card holds and hands 16-column groups to its
//     warps round robin, each over all of K.
//   Split K, fixed order.  The K words are cut into S = cs * wk slices
//     [s*KW/S, (s+1)*KW/S) (warp w of cluster rank r holds s = r*wk + w).
//     Each warp accumulates its slice word by word in K order; the warps
//     of a block add their partials through shared memory in warp order,
//     and the other ranks of the thread-block cluster push theirs into
//     rank 0's shared memory, which adds them in rank order.  One launch,
//     no workspace, no atomics.
//   Masked rows.  The masked GEMV keeps one f32 accumulator set per
//     demanded variant and each row takes its own; the masked GEMM sorts
//     the tile's rows by variant into tiles of one variant each.  An MMA
//     computes row m from A's row m and B alone, and the split and order
//     depend only on (M, K, N, G, x dtype), so row m is bit for bit the
//     unmasked kernel on planes truncated to the row's drop, and demand
//     routing (fewer planes, fewer variants) changes no bit.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "qsq_common.cuh"

namespace qsq {
namespace mma {

namespace cg = cooperative_groups;

// ring depth, in 32-code words: the GEMV's stages are small
__host__ __device__ constexpr int stages(int mt) { return mt == 1 ? 8 : 4; }
constexpr int kXStride = 48;      // bf16 per staged x row (32 + 16: conflict-free A loads)
constexpr int kMaxThreads = 256;  // 32 * wn * wk
constexpr int kMaxCluster = 8;    // portable cluster size
constexpr int kSmemAttr = 200 * 1024;

struct Args {
  const __nv_bfloat16* x;
  const int32_t* planes;
  const float* scales;
  const int32_t* plane_mask;
  float* out;
  int M, K, N, G;
  int wn, wk, cs;   // warps along N, warps along K (per block), blocks along K (per cluster)
  int demand_drop;  // the masked kernel decodes MASK_VARIANTS[demand_drop:]
  int vec;          // planes and scales take 16-byte copies
  int vec_x;        // x takes 16-byte copies
  int g_shift;      // log2(G) when G is a power of two, else -1
  int xs;           // bf16 per x row in shared memory: 32 * (longest block range) + 16
  int main_bytes;   // shared memory before the cluster's partial-sum slots
  int persist;      // 1: a grid sized to the card, column groups round robin
};

// Shared memory of one block: x rows (16 * mt) over the block's K range
// and each warp's ring (the warps' partial sums reuse it after the
// loop), then, in a cluster, rank 0's slots for the other ranks' sums.
__host__ __device__ inline size_t main_bytes(int mt, int tm, int nt, int np, int wn, int wk,
                                             int cs, int KW) {
  const size_t xs = 32 * ((KW + cs - 1) / cs) + 16;
  const size_t loop = 16 * mt * xs * 2 + (size_t)wn * wk * stages(mt) * (np + 2) * nt * 8 * 4;
  const size_t red = (size_t)(wk - 1) * 16 * tm * wn * nt * 8 * 4;
  const size_t m = loop > red ? loop : red;
  return (m + 15) / 16 * 16;
}

__host__ __device__ inline size_t smem_bytes(int mt, int tm, int nt, int np, int wn, int wk,
                                             int cs, int KW) {
  return main_bytes(mt, tm, nt, np, wn, wk, cs, KW) +
         (size_t)(cs - 1) * 16 * tm * wn * nt * 8 * 4;
}

// First word of slice s of S over KW words.
__host__ __device__ inline int slice_lo(int s, int S, int KW) {
  return (int)(((long long)s * KW) / S);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Bit i of a 4-bit n to bit 8i.
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

// The magnitudes of one 16-code group as two bf16x2 words, indexed by the
// magnitude index 0..3: {0, bf16(a)}, {bf16(2a), bf16(4a)}.
__device__ __forceinline__ void mag_table(float a, uint32_t& lo, uint32_t& hi) {
  __nv_bfloat162 l = __floats2bfloat162_rn(0.0f, a);
  __nv_bfloat162 h = __floats2bfloat162_rn(2.0f * a, 4.0f * a);
  lo = *reinterpret_cast<uint32_t*>(&l);
  hi = *reinterpret_cast<uint32_t*>(&h);
}

// Four codes (bit i of n0/n1/n2 = bit 0/1/2 of code i) to bf16x2 words
// (code 0, code 1) and (code 2, code 3).  Magnitude index mi and sign:
//   sign-magnitude  mi = c & 3,             negative iff bit 2 and mi != 0
//   Table II        mi = (c + (c >> 2)) & 3, negative iff bit 2 and c != 7
// so both give decode(c) * a rounded to bf16, +0 for a zero level.
template <bool SM>
__device__ __forceinline__ void decode4(uint32_t n0, uint32_t n1, uint32_t n2, uint32_t lo,
                                        uint32_t hi, uint32_t& w01, uint32_t& w23) {
  uint32_t mi, neg;
  if (SM) {
    mi = spread4(n0) + 2u * spread4(n1);
    neg = n2 & (n0 | n1);
  } else {
    mi = (spread4(n0) + 2u * spread4(n1) + spread4(n2)) & 0x03030303u;
    neg = n2 & ~(n0 & n1);
  }
  // byte i of sel: nibbles (2 mi_i, 2 mi_i + 1), the bytes of entry mi_i
  const uint32_t sel = mi * 0x22u + 0x10101010u;
  w01 = prmt(lo, hi, sel) ^ ((neg * 0x40008000u) & 0x80008000u);
  w23 = prmt(lo, hi, sel >> 16) ^ (((neg >> 2) * 0x40008000u) & 0x80008000u);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Output (i, j, e) of a row whose variant is vr: the masked GEMV keeps a
// set per variant and a row takes its own (a row of no variant: zero).
template <int NA, int TM, int NT>
__device__ __forceinline__ float pick(const float (&acc)[NA][TM][NT][4], int vr, int i, int j,
                                      int e) {
  if (NA == 1) return vr < 0 ? 0.0f : acc[0][i][j][e];
  float r = 0.0f;
#pragma unroll
  for (int v = 0; v < NA; ++v)
    if (vr == v) r = acc[v][i][j][e];
  return r;
}

template <int MT, int NT, int NP, bool MASKED, bool SM, bool PM>
__global__ void __launch_bounds__(kMaxThreads, MT > 1 ? 2 : 1) packed_mma_kernel(const Args a) {
  constexpr int NV = MASKED ? NP : 1;          // variants decoded: the demanded ones
  constexpr bool SORT = MASKED && MT > 1;       // the masked GEMM: one variant a tile
  constexpr int TM = SORT ? MT + NV - 1 : MT;   // 16-row MMA tiles
  constexpr int NA = MASKED && !SORT ? NV : 1;  // accumulator sets (masked GEMV: a variant each)
  constexpr int XR = 16 * TM;  // tile rows (positions); x itself has 16 * MT rows
  constexpr int kStages = stages(MT);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int8_t var_s[96];                // per tile row: its variant, -1 for none
  __shared__ uint8_t row_s[96];               // per tile row: the row of x (less m0), 255 for none
  __shared__ int8_t tvar_s[8];                // per tile: its variant, -1 for an empty tile
  __shared__ uint8_t dead_s[64];              // rows matching no demanded variant (sorted GEMM)
  __shared__ int ndead_s;
  cg::cluster_group cluster = cg::this_cluster();
  if (a.cs > 1) cluster_arrive();  // waited for before the first remote write

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn_i = warp % a.wn, wk_i = warp / a.wn;
  const int BN = a.wn * NT * 8;
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / a.cs) * BN;
  const int m0 = blockIdx.y * 16 * MT;
  const int KW = a.K / 32;
  const int S = a.cs * a.wk;
  const int my_lo = slice_lo(rank * a.wk + wk_i, S, KW);  // this warp's slice
  const int nw = slice_lo(rank * a.wk + wk_i + 1, S, KW) - my_lo;
  const int blo = slice_lo(rank * a.wk, S, KW);              // the block's range
  const int bwords = slice_lo(rank * a.wk + a.wk, S, KW) - blo;
  // the GEMV with M <= 8 never reads rows 8..15 of its tile
  const bool hi_rows = MT > 1 || a.M - m0 > 8;
  const int x_rows = hi_rows ? 16 * MT : 8;
  constexpr int CW = NT * 8;              // columns a warp owns
  constexpr int RING = (NP + 2) * CW;     // uint32 per ring stage: NP plane rows, 2 scale rows
  __nv_bfloat16* xsm = reinterpret_cast<__nv_bfloat16*>(smem);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + (size_t)16 * MT * a.xs * 2) +
                   (size_t)warp * kStages * RING;
  // Column groups of CW columns.  A persistent launch (cs = wk = 1, grid
  // sized to the card) hands the groups to its warps round robin, each over
  // all of K; otherwise a warp owns the one group its block gives it.  A
  // group is summed by one warp in K order either way.
  const int nwarp = blockDim.x >> 5;
  const int NG = (a.N + CW - 1) / CW;
  int gfirst = (blockIdx.x / a.cs) * a.wn + wn_i, gstep = 0, gcount = 1;
  if (a.persist) {
    gfirst = blockIdx.x * nwarp + warp;
    gstep = gridDim.x * nwarp;
    gcount = gfirst < NG ? (NG - 1 - gfirst) / gstep + 1 : 0;
  }

  // x over the block's K range, in row order, stays in shared memory for the
  // whole loop; its loads go out before the rows' variants are read
  for (int row = warp; row < x_rows; row += blockDim.x >> 5) {
    const bool live = m0 + row < a.M;
    const __nv_bfloat16* src = a.x + (size_t)(m0 + row) * a.K + blo * 32;
    __nv_bfloat16* dst = xsm + row * a.xs;
    for (int c = lane; c < bwords * 4; c += 32) {
      if (a.vec_x) {
        cp16(dst + 8 * c, live ? src + 8 * c : a.x, live ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[8 * c + e] = live ? src[8 * c + e] : __float2bfloat16(0.0f);
      }
    }
  }
  cp_commit();
  if (warp == 0) {
    for (int r = lane; r < XR; r += 32) var_s[r] = -1, row_s[r] = 255;
    __syncwarp();
    int vr[2];  // per row: its variant; -1 for none demanded, -2 past M
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h, m = m0 + r;
      int v = -2;
      if (r < 16 * MT && m < a.M) {
        v = 0;
        if (MASKED) {
          v = variant_of(a.plane_mask[m], a.demand_drop);
          v = v < 0 ? -1 : v - a.demand_drop;
        }
      }
      vr[h] = v;
    }
    if (SORT) {
      // The masked GEMM places each variant's rows (stably) in tiles of their
      // own, so every tile takes one MMA, with its variant's weights, and a
      // row's chain of MMAs is the unmasked kernel's on truncated planes.
      const unsigned below = (1u << lane) - 1u;
      int tile0 = 0;
#pragma unroll
      for (int b = 0; b < NV; ++b) {
        const unsigned b0 = __ballot_sync(0xffffffffu, vr[0] == b);
        const unsigned b1 = __ballot_sync(0xffffffffu, vr[1] == b);
        const int n = __popc(b0) + __popc(b1);
        if (vr[0] == b) {
          const int p = 16 * tile0 + __popc(b0 & below);
          row_s[p] = (uint8_t)lane, var_s[p] = (int8_t)b;
        }
        if (vr[1] == b) {
          const int p = 16 * tile0 + __popc(b0) + __popc(b1 & below);
          row_s[p] = (uint8_t)(lane + 32), var_s[p] = (int8_t)b;
        }
        if (lane < (n + 15) / 16) tvar_s[tile0 + lane] = (int8_t)b;
        tile0 += (n + 15) / 16;
      }
      if (lane >= tile0 && lane < TM) tvar_s[lane] = -1;
      const unsigned d0 = __ballot_sync(0xffffffffu, vr[0] == -1);
      const unsigned d1 = __ballot_sync(0xffffffffu, vr[1] == -1);
      if (vr[0] == -1) dead_s[__popc(d0 & below)] = (uint8_t)lane;
      if (vr[1] == -1) dead_s[__popc(d0) + __popc(d1 & below)] = (uint8_t)(lane + 32);
      if (lane == 0) ndead_s = __popc(d0) + __popc(d1);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        if (r < XR) row_s[r] = (uint8_t)r, var_s[r] = (int8_t)(vr[h] < 0 ? -1 : vr[h]);
      }
      __syncwarp();
      if (lane < TM) {  // a tile with no row to compute is skipped
        bool any = false;
        for (int r = 16 * lane; r < 16 * lane + 16; ++r) any |= var_s[r] >= 0;
        tvar_s[lane] = any ? 0 : -1;
      }
      if (lane == 0) ndead_s = 0;
    }
  }

  // each warp streams its own columns' plane words and scales, one 32-code
  // word a stage, through its own ring: no block barrier inside the loop
  auto load_word = [&](int slot, int n0w, int kw) {
    uint32_t* st = ring + slot * RING;
    for (int task = lane; task < (NP + 2) * (CW / 4); task += 32) {
      const int q = task / (CW / 4), c = task - q * (CW / 4);
      const int n = n0w + 4 * c;
      const uint32_t* row;
      if (q < NP) {  // plane q holds code bit 2 - q
        row = reinterpret_cast<const uint32_t*>(
            PM ? a.planes + ((size_t)q * KW + kw) * a.N
               : a.planes + ((size_t)kw * 3 + (2 - q)) * a.N);
      } else {  // the scale rows of the word's two 16-code halves
        const int k = kw * 32 + (q - NP) * 16;
        row = reinterpret_cast<const uint32_t*>(
            a.scales + (size_t)(a.g_shift >= 0 ? k >> a.g_shift : k / a.G) * a.N);
      }
      uint32_t* dst = st + q * CW + 4 * c;
      if (a.vec) {
        const int valid = min(4, a.N - n);
        cp16(dst, valid > 0 ? row + n : row, valid > 0 ? 4 * valid : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp4(dst + e, n + e < a.N ? row + n + e : row, n + e < a.N ? 4 : 0);
      }
    }
  };

  float acc[NA][TM][NT][4];
#pragma unroll
  for (int v = 0; v < NA; ++v)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[v][i][j][e] = 0.0f;

  // words in issue order: group lg, word lk of the warp's slice
  const int total = gcount * nw;
  int lg = 0, lk = 0;
  auto load_next = [&](int q) {
    if (q < total) load_word(q % kStages, (gfirst + lg * gstep) * CW, my_lo + lk);
    if (++lk == nw) lk = 0, ++lg;
    cp_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) load_next(st);
  cp_wait<kStages - 1>();  // this thread's share of x has landed ...
  __syncthreads();         // ... and every thread's

  // The variants to decode: those some tile (masked GEMM) or row (masked
  // GEMV) selects.  A tile's variant, and each thread's rows' variants.
  // Kept packed, for registers: the x rows behind this thread's A rows g
  // and g + 8 of tile i (16 bits each, as element offsets), and each tile's
  // variant (4 bits a tile, variant + 1, 0 for an empty tile).
  unsigned used = 1u, tvs = 0u;
  uint32_t arow[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    tvs |= (uint32_t)(tvar_s[i] + 1) << (4 * i);
    uint32_t off[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = 16 * i + g + 8 * hh;
      off[hh] = SORT ? (row_s[p] == 255 ? 0u : row_s[p]) : p;
    }
    arow[i] = off[0] | off[1] << 16;
  }
  auto tile_var = [&](int i) { return (int)(tvs >> (4 * i) & 0xFu) - 1; };
  if (MASKED) {
    used = 0u;
    if (SORT) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
        if (tile_var(i) >= 0) used |= 1u << tile_var(i);
    } else {
      for (int r = 0; r < XR; ++r)
        if (var_s[r] >= 0) used |= 1u << var_s[r];
    }
  }
  // The output of one column group: element (i, j, e) of tile row
  // position 16i + g (+8), and zeros for the rows of no demanded variant
  // (the GEMV and unmasked kernels zero them in place, the sorted GEMM
  // keeps them in a list).
  auto store_one = [&](int i, int j, int e, float v, int col0) {
    const int row = row_s[16 * i + g + 8 * (e >> 1)];
    const int m = m0 + row, n = col0 + 8 * j + 2 * t + (e & 1);
    if (row != 255 && m < a.M && n < a.N) a.out[(size_t)m * a.N + n] = v;
  };
  auto store_dead = [&](int col0) {
    if (!SORT || g != 0) return;
    for (int d = 0; d < ndead_s; ++d)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = col0 + 8 * j + 2 * t + e;
          if (n < a.N) a.out[(size_t)(m0 + dead_s[d]) * a.N + n] = 0.0f;
        }
  };

  for (int it = 0, cg_i = 0, ck = 0; it < total; ++it) {
    cp_wait<kStages - 2>();
    __syncwarp();  // word it is in the ring for every lane; slot it-1 is free
    load_next(it + kStages - 1);

    const uint32_t* ws = ring + (it % kStages) * RING;
    const __nv_bfloat16* xs = xsm + (my_lo + ck - blo) * 32;
    uint32_t bits[NT][3];
    float sc[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + g;
#pragma unroll
      for (int q = 0; q < 3; ++q) bits[j][q] = q < NP ? ws[q * CW + c] >> (4 * t) : 0u;
      sc[j][0] = __uint_as_float(ws[NP * CW + c]);
      sc[j][1] = __uint_as_float(ws[(NP + 1) * CW + c]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the word's two 16-code halves, in K order
      // B fragments of every variant in use, then each tile's A and MMAs
      uint32_t bq[NV][NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t nb2 = (bits[j][0] >> (16 * h)) & 0xFu;
        const uint32_t nb1 = (bits[j][1] >> (16 * h)) & 0xFu;
        const uint32_t nb0 = (bits[j][2] >> (16 * h)) & 0xFu;
        uint32_t lo, hi;
        mag_table(sc[j][h], lo, hi);
#pragma unroll
        for (int vi = 0; vi < NV; ++vi) {
          const int v = MASKED ? 3 - NP + vi : 0;  // variant v clears code bits below v
          bq[vi][j][0] = bq[vi][j][1] = 0u;  // sign-magnitude codes under 0b100: all +0
          if ((used >> vi & 1u) && (!SM || v < 2))
            decode4<SM>(v >= 1 ? 0u : nb0, v >= 2 ? 0u : nb1, nb2, lo, hi, bq[vi][j][0],
                        bq[vi][j][1]);
        }
      }
      const __nv_bfloat16* xk = xs + 16 * h + 4 * t;
      auto a_frag = [&](int i, uint32_t (&af)[4]) {  // A: x rows arow[i], k in this half
        const uint2 v0 = *reinterpret_cast<const uint2*>(xk + (arow[i] & 0xFFFFu) * a.xs);
        af[0] = v0.x;
        af[2] = v0.y;
        if (hi_rows) {
          const uint2 v1 = *reinterpret_cast<const uint2*>(xk + (arow[i] >> 16) * a.xs);
          af[1] = v1.x;
          af[3] = v1.y;
        } else {
          af[1] = af[3] = 0u;
        }
      };
      if (NA > 1) {  // the masked GEMV: every variant against the one tile
        uint32_t af[4];
        a_frag(0, af);
#pragma unroll
        for (int vi = 0; vi < NV; ++vi)
          if (used >> vi & 1u)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_bf16(acc[vi][0][j], af, bq[vi][j][0], bq[vi][j][1]);
      } else {  // each tile against its own variant's B, picked by selects
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int vi = tile_var(i);
          if (vi < 0) continue;
          uint32_t af[4];
          a_frag(i, af);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t b0 = bq[0][j][0], b1 = bq[0][j][1];
#pragma unroll
            for (int v = 1; v < NV; ++v)
              if (vi == v) b0 = bq[v][j][0], b1 = bq[v][j][1];
            mma_bf16(acc[0][i][j], af, b0, b1);
          }
        }
      }
    }
    if (++ck == nw) {  // a persistent warp's group is done: store it, start the next
      ck = 0;
      if (a.persist) {
        const int col0 = (gfirst + cg_i * gstep) * CW;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              store_one(i, j, e, pick(acc, var_s[16 * i + g + 8 * (e >> 1)], i, j, e), col0);
        store_dead(col0);
#pragma unroll
        for (int v = 0; v < NA; ++v)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[v][i][j][e] = 0.0f;
      }
      ++cg_i;
    }
  }
  cp_wait<0>();
  __syncthreads();  // shared memory holds the partial sums from here on
  if (a.persist) return;

  float res[TM][NT][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) res[i][j][e] = pick(acc, var_s[16 * i + g + 8 * (e >> 1)], i, j, e);

  float* red = reinterpret_cast<float*>(smem);
  const int tile = XR * BN;  // one partial-sum slot: the block's rows x columns
  auto at = [&](int slot, int i, int j, int e) -> int {
    return slot * tile + (16 * i + g + 8 * (e >> 1)) * BN + (wn_i * NT + j) * 8 + 2 * t + (e & 1);
  };
  if (a.wk > 1) {  // the block's warps, in warp (= K) order
    if (wk_i > 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[at(wk_i - 1, i, j, e)] = res[i][j][e];
    }
    __syncthreads();
    if (wk_i == 0) {
      for (int w = 1; w < a.wk; ++w)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) res[i][j][e] += red[at(w - 1, i, j, e)];
    }
  }
  if (a.cs > 1) {  // the cluster's blocks, in rank (= K) order, summed by rank 0
    // ranks 1.. write their partials into slots of rank 0's shared memory
    // (past the region rank 0 still uses); rank 0 adds them in rank order
    float* cslots = reinterpret_cast<float*>(smem + a.main_bytes);
    cluster_wait();  // every block of the cluster has started (arrived at entry)
    if (rank > 0 && wk_i == 0) {
      float* dst = cluster.map_shared_rank(cslots, 0) + (size_t)(rank - 1) * tile;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(dst + at(0, i, j, 2 * hh)) =
                make_float2(res[i][j][2 * hh], res[i][j][2 * hh + 1]);
    }
    cluster.sync();
    if (rank == 0 && wk_i == 0) {
      for (int r = 1; r < a.cs; ++r)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              res[i][j][e] += cslots[(size_t)(r - 1) * tile + at(0, i, j, e)];
    }
  }
  if (rank != 0 || wk_i != 0) return;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) store_one(i, j, e, res[i][j][e], gfirst * CW);
  store_dead(gfirst * CW);
}

template <int MT, int NT, int NP, bool MASKED, bool SM, bool PM>
cudaError_t launch_one(const Args& a, dim3 grid, int threads, size_t smem, cudaStream_t s) {
  auto* kern = packed_mma_kernel<MT, NT, NP, MASKED, SM, PM>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemAttr);
  if (attr != cudaSuccess) return attr;
  if (a.persist) {  // as many blocks as the card holds at once, at most one per group
    static int sms = 0;
    int dev = 0, per_sm = 0;
    if (!sms && (cudaGetDevice(&dev) != cudaSuccess ||
                 cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess))
      return cudaGetLastError();
    const cudaError_t occ =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (occ != cudaSuccess) return occ;
    grid.x = (unsigned)max(1, min((int)grid.x, sms * per_sm));
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = a.cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a);
}

template <int MT, int NT, bool MASKED, bool SM, bool PM>
cudaError_t launch_np(const Args& a, int np, dim3 grid, int threads, size_t smem,
                      cudaStream_t s) {
  switch (np) {
    case 1: return launch_one<MT, NT, 1, MASKED, SM, PM>(a, grid, threads, smem, s);
    case 2: return launch_one<MT, NT, 2, MASKED, SM, PM>(a, grid, threads, smem, s);
    default: return launch_one<MT, NT, 3, MASKED, SM, PM>(a, grid, threads, smem, s);
  }
}

// Validates the launch plan and launches; -1 for a plan the kernel does not
// take, else the CUDA error code (0 on success).
template <int MT, int NT, bool MASKED>
int launch(Args a, int np, int sign_mag, int plane_major, cudaStream_t s) {
  const int KW = a.K / 32;
  if (np < 1 || np > 3 || a.G % 16 || a.K % a.G) return -1;
  if (a.wn < 1 || a.wk < 1 || 32 * a.wn * a.wk > kMaxThreads || a.cs < 1 ||
      a.cs > kMaxCluster || a.cs * a.wk > KW || (a.persist && (a.cs != 1 || a.wk != 1)))
    return -1;
  const int bn = a.wn * NT * 8;
  const long long tiles = (a.N + bn - 1) / bn;
  const long long gx = tiles * a.cs;
  const long long gy = (a.M + 16 * MT - 1) / (16 * MT);
  if (gx > 0x7fffffffLL || gy > 65535) return -1;
  const int tm = MASKED && MT > 1 ? MT + np - 1 : MT;  // the kernel's TM
  const size_t smem = smem_bytes(MT, tm, NT, np, a.wn, a.wk, a.cs, KW);
  if (smem > (size_t)kSmemAttr) return -1;
  a.xs = 32 * ((KW + a.cs - 1) / a.cs) + 16;
  a.main_bytes = (int)main_bytes(MT, tm, NT, np, a.wn, a.wk, a.cs, KW);
  a.vec = (a.N % 4 == 0) &&
          (((uintptr_t)a.planes | (uintptr_t)a.scales) % 16 == 0);
  a.vec_x = (uintptr_t)a.x % 16 == 0;
  a.g_shift = (a.G & (a.G - 1)) ? -1 : __builtin_ctz((unsigned)a.G);
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const int threads = 32 * a.wn * a.wk;
  cudaError_t err;
  if (sign_mag && plane_major) err = launch_np<MT, NT, MASKED, true, true>(a, np, grid, threads, smem, s);
  else if (sign_mag) err = launch_np<MT, NT, MASKED, true, false>(a, np, grid, threads, smem, s);
  else if (plane_major) err = launch_np<MT, NT, MASKED, false, true>(a, np, grid, threads, smem, s);
  else err = launch_np<MT, NT, MASKED, false, false>(a, np, grid, threads, smem, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // namespace mma
}  // namespace qsq
