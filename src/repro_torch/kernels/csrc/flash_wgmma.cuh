// The wgmma products the bfloat16 flash-attention kernels share: the
// forward (flash_attention_wgmma.cu) and the backward
// (flash_attention_wgmma_bwd.cu).  Header only.
//
// Every operand tile is a 128-byte-swizzled TMA tile of 64-wide chunks
// (hopper.cuh): an A tile has 64 rows, a B tile BK rows, each
// [DP / 64][rows][64].  A K-major B tile (rows = N, columns = K) feeds
// score_product; the same tile read MN-major (rows = K, columns = N, the
// transpose bit) feeds value_product, so one staged tile serves both
// (Q K^T and dS K in the dQ pass, K Q^T and dS^T Q in the dK pass).

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace flash_wgmma {

using bf16 = __nv_bfloat16;

constexpr int kRowsA = 64;   // rows of an A tile (one warpgroup's M)

// S (64 x BK) += A B^T over DP (chunks of 64, k16 steps); A and B K-major
template <int DP, int BK>
__device__ __forceinline__ void score_product(float (&s)[BK / 2],
                                              const bf16* as, const bf16* bs) {
#pragma unroll
  for (int ch = 0; ch < DP / 64; ++ch) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::desc_sw128(as + ch * kRowsA * 64 + kk * 16,
                                             16, 1024);
      const uint64_t db = hopper::desc_sw128(bs + ch * BK * 64 + kk * 16, 16,
                                             1024);
      const int acc = (ch | kk) != 0;
      if constexpr (BK == 128) {
        hopper::wgmma_ss_m64n128<0>(s, da, db, acc);
      } else {
        hopper::wgmma_ss_m64n64<0>(s, da, db, acc);
      }
    }
  }
}

// O += P B for one k16 slice, P as register A fragments
template <int DP>
__device__ __forceinline__ void value_step(float (&o)[DP / 2],
                                           const uint32_t (&p)[4],
                                           uint64_t db) {
  if constexpr (DP == 64) {
    hopper::wgmma_rs_m64n64<1>(o, p, db, 1);
  } else if constexpr (DP == 128) {
    hopper::wgmma_rs_m64n128<1>(o, p, db, 1);
  } else if constexpr (DP == 192) {
    hopper::wgmma_rs_m64n192<1>(o, p, db, 1);
  } else {
    hopper::wgmma_rs_m64n256<1>(o, p, db, 1);
  }
}

// O += P_hi B + P_lo B; B is the BK-row tile read MN-major
template <int DP, int BK>
__device__ __forceinline__ void value_product(
    float (&o)[DP / 2], const uint32_t (&hi)[BK / 16][4],
    const uint32_t (&lo)[BK / 16][4], const bf16* bs) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    const uint64_t db = hopper::desc_sw128(bs + kc * 16 * 64, BK * 128, 1024);
    value_step<DP>(o, hi[kc], db);
    value_step<DP>(o, lo[kc], db);
  }
}

// (a, b) = hi + lo, each a bfloat16 pair: hi rounds a and b, lo rounds
// what hi leaves (exact in float32)
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = hopper::pack_bf16x2(a - hf.x, b - hf.y);
}

// A 64 x BK float32 accumulator as hi + lo register A fragments of the
// next product (its N is that product's K)
template <int BK>
__device__ __forceinline__ void split_fragments(const float (&s)[BK / 2],
                                                uint32_t (&hi)[BK / 16][4],
                                                uint32_t (&lo)[BK / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split_bf16x2(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1], hi[kc][r],
                   lo[kc][r]);
    }
  }
}

}  // namespace flash_wgmma
