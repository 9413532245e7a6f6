// Device helpers shared by the packed-matmul kernels (qsq_matvec.cu,
// qsq_matmul.cu): the port of the JAX package's _decode_codes,
// _decode_codes_sm, _unpack_planes and _unpack_planes_major
// (src/repro/kernels/qsq_matmul.py:57-122).
//
// Layouts (int32 words, bit j of a word is code j of its 32-code group):
//   interleaved  planes (K/32, 3, N): word [kw][b][n] holds code bit b
//   plane-major  planes (3, K/32, N): word [p][kw][n] holds code bit 2-p
//                (MSB first); only the leading n_planes planes are read.
// Scales (K/G, N) f32, grouped along K.  Words are read as uint32 so a
// right shift never drags the sign bit into a code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qsq {

// The three per-row plane masks a quality tier can select
// (kernels/ref.py MASK_VARIANTS): drop 0, 1 or 2 LSB planes.
__device__ __forceinline__ uint32_t mask_variant(int v) {
  return v == 0 ? 7u : (v == 1 ? 6u : 4u);
}

// Table II: 0->0, 1->+1, 2->+2, 3->+4, 4->-1, 5->-2, 6->-4, 7->0.
__device__ __forceinline__ int decode_table2(uint32_t c) {
  c &= 7u;
  if (c >= 1u && c <= 3u) return 1 << (c - 1u);
  if (c >= 4u && c <= 6u) return -(1 << (c - 4u));
  return 0;
}

// Sign-magnitude (wire v2): bit 2 = sign, bits 1..0 = magnitude index.
// 0->0, 1->+1, 2->+2, 3->+4, 4->0, 5->-1, 6->-2, 7->-4.
__device__ __forceinline__ int decode_sm(uint32_t c) {
  const uint32_t mi = c & 3u;
  const int v = mi ? (1 << (mi - 1u)) : 0;
  return (c & 4u) ? -v : v;
}

template <bool SM>
__device__ __forceinline__ int decode(uint32_t c) {
  return SM ? decode_sm(c) : decode_table2(c);
}

// The three bit words (bit 0, bit 1, bit 2 of each code) of the 32-code
// group kw at column n.  Plane-major reads only the first n_planes planes;
// an absent plane contributes zero bits, exactly like a truncated stream.
template <bool PM>
__device__ __forceinline__ void load_words(const int32_t* __restrict__ planes,
                                           int kw, int n, int KW, int N,
                                           int n_planes, uint32_t& b0,
                                           uint32_t& b1, uint32_t& b2) {
  if (PM) {
    const size_t plane = (size_t)KW * N;
    const size_t off = (size_t)kw * N + n;
    b2 = n_planes > 0 ? (uint32_t)planes[off] : 0u;
    b1 = n_planes > 1 ? (uint32_t)planes[plane + off] : 0u;
    b0 = n_planes > 2 ? (uint32_t)planes[2 * plane + off] : 0u;
  } else {
    const size_t off = (size_t)kw * 3 * N + n;
    b0 = (uint32_t)planes[off];
    b1 = (uint32_t)planes[off + N];
    b2 = (uint32_t)planes[off + 2 * (size_t)N];
  }
}

__device__ __forceinline__ uint32_t code_at(uint32_t b0, uint32_t b1,
                                            uint32_t b2, int j) {
  return ((b0 >> j) & 1u) | (((b1 >> j) & 1u) << 1) | (((b2 >> j) & 1u) << 2);
}

// The weight as the reference builds it: the f32 product level * alpha,
// cast to x's dtype before the dot (bf16 x: round to bf16, then widen back
// so the product with x is exact in f32).
template <typename T>
__device__ __forceinline__ float weight(int level, float alpha);

template <>
__device__ __forceinline__ float weight<float>(int level, float alpha) {
  return (float)level * alpha;
}

template <>
__device__ __forceinline__ float weight<__nv_bfloat16>(int level, float alpha) {
  return __bfloat162float(__float2bfloat16_rn((float)level * alpha));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Index of a row's plane mask among the demanded variants
// MASK_VARIANTS[demand_drop:], or -1: such a row matches no demanded
// variant and its output row is zero (the reference's variant split).
__device__ __forceinline__ int variant_of(int32_t mask, int demand_drop) {
  for (int v = demand_drop; v < 3; ++v)
    if ((uint32_t)mask == mask_variant(v)) return v;
  return -1;
}

}  // namespace qsq
