// Flash attention (forward) in bfloat16 on Hopper's tensor cores (sm_90a:
// TMA, mbarriers, wgmma), plain C interface.
//
//   flash_attention_wgmma_forward  replaces src/repro/kernels/
//                                  flash_attention.py _kernel /
//                                  flash_attention_pallas for bfloat16:
//                                  out = softmax(q k^T * scale + mask) v,
//                                  GQA (query head h reads KV head
//                                  h / (Hq / Hkv)), causal, an optional
//                                  sliding window, a ragged tail.
//
// q has Sq rows and k, v Skv keys; they differ only without a mask
// (cross-attention: whisper's decode token against its 1500 encoder frames;
// the wrapper refuses a causal or windowed call at Sq != Skv).  Query tiles
// run over Sq, key tiles and the K / V tensor maps over Skv, and keys at
// or past Skv are masked.
//
// q, k, v and out are bfloat16 (B, H, S, D) views with a contiguous last
// dimension and every other stride a multiple of 8 elements (TMA takes
// 16-byte strides), D % 8 == 0 and D <= 256: the wrapper
// (kernels/flash_attention.py) routes every other call to the SIMT kernel
// of flash_attention.cu.  The semantics are those of flash_attention.cu
// and the Pallas kernel: scores and the online softmax (running max m and
// sum l) in float32, the finite -1e30 mask, max(l, 1e-30) in the divide,
// rows and keys at or past S never read, tiles the Pallas predicate skips
// skipped.  P = exp(s - m) keeps its float32 precision for P V, as in the
// Pallas kernel: the tensor cores take bfloat16, so P is split into
// hi + lo, both bfloat16 (hi its leading 8 significant bits, lo the next
// 8), and P V is issued as two products into one float32 accumulator.
// Rounding P to bfloat16 alone moved qwen3-1.7b's bfloat16 prefill logits
// past the decode-against-prefill gate (91 of 303 872 logits beyond the
// 0.05 contract against 30 allowed); the split costs half again the
// products.  The rounded design stays built for DP = 128 with two heads a
// block (split_p = 0, which the wrapper never passes on its own): the
// smoke test times it beside the split and holds it to the tolerances
// as a control.
//
// What bounds it: at qwen3-1.7b's prefill, (4, 16, 2048, 128) causal with
// Hkv 8, a call does 69 GFLOP (4 B Hq D per unmasked (q, k) pair: 0.07 ms
// at 989 TFLOP/s) and moves 101 MB (0.03 ms at 3.35 TB/s): bound by
// operations, and only the tensor cores come near it; the exponentials
// (one per score, 16 a clock per SM) are the next limit.
//
// Design.  One block per (batch, KV head, 64 query rows, group of up to NC
// = 2 query heads sharing that KV head): warpgroup 0 is the producer and
// warpgroup 1 + c the consumer of query head c of the group, so each K and
// V tile comes from device memory once per pair of heads.  The producer's
// one thread loads the consumers' Q tiles once, then keeps a ring of 2
// stages of BK-key K and V tiles in flight by TMA (a "K full" and a "V
// full" barrier a stage, and an "empty" barrier back from the consumers).
// A consumer computes S = Q K^T with wgmma from shared memory (Q and K
// K-major), applies scale and mask in registers on the accumulator layout
// (the compares only on tiles that cross the diagonal, the window edge or
// S), runs the online softmax there (a row's 4 threads reduce with
// shuffles), splits P in place into the register A operands P_hi and P_lo
// and computes O += P_hi V + P_lo V with wgmma (V N-major: the transpose
// bit).  Heads are zero-padded in shared memory to DP, a multiple of 64
// (TMA fills the columns past D with zeros).  BK is 128 keys for
// DP <= 128 and 64 above, which keeps O, S, P_hi and P_lo of a consumer
// within the 240 registers it takes from the producer (setmaxnreg).  Query
// tiles run from the last to the first, so the longest causal blocks
// start first.  The output is stored from registers through its own
// strides: the LM writes straight into a (B, S, H, D) buffer.
//
// The entry returns cudaGetLastError() after its launch (or the error of
// building a tensor map); it launches on the stream it is given, allocates
// nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;         // query rows of a consumer
constexpr int kStages = 2;
constexpr int kMaxDim = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP, int BK, int NC>
struct Layout {
  static constexpr int kQ = kBQ * DP;           // elements a head
  static constexpr int kKV = BK * DP;           // elements a K or V tile
  static constexpr int kBytes =
      (NC * kQ + 2 * kStages * kKV) * 2 + (1 + 3 * kStages) * 8 + 1024;
  static constexpr int kThreads = 128 * (NC + 1);
};

// S += Q K^T over DP (chunks of 64, k16 steps)
template <int DP, int BK>
__device__ __forceinline__ void score_product(float (&s)[BK / 2],
                                              const bf16* qs, const bf16* ks) {
#pragma unroll
  for (int ch = 0; ch < DP / 64; ++ch) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::desc_sw128(qs + ch * kBQ * 64 + kk * 16, 16,
                                             1024);
      const uint64_t db = hopper::desc_sw128(ks + ch * BK * 64 + kk * 16, 16,
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

// O += P V for one k16 slice, P as register A fragments
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

// O += P_hi V + P_lo V (P_hi V alone without the split)
template <int DP, int BK, bool kSplitP>
__device__ __forceinline__ void value_product(
    float (&o)[DP / 2], const uint32_t (&hi)[BK / 16][4],
    const uint32_t (&lo)[BK / 16][4], const bf16* vs) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    const uint64_t db = hopper::desc_sw128(vs + kc * 16 * 64, BK * 128, 1024);
    value_step<DP>(o, hi[kc], db);
    if constexpr (kSplitP) value_step<DP>(o, lo[kc], db);
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

struct Params {
  bf16* out;
  long long os_b, os_h, os_s;   // out strides in elements
  int n_heads, n_kv_heads, group, head_blocks, seq, seq_kv, dim, causal;
  int window;
  float scale_log2;             // scale * log2(e)
};

template <int DP, int BK, int NC, bool kSplitP>
__global__ void __launch_bounds__(Layout<DP, BK, NC>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const Params prm) {
  using L = Layout<DP, BK, NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qs = reinterpret_cast<bf16*>(base);       // [NC][DP / 64][64][64]
  bf16* ks = qs + NC * L::kQ;                      // [stage][DP / 64][BK][64]
  bf16* vs = ks + kStages * L::kKV;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vs + kStages * L::kKV);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + kStages;
  uint64_t* empty = vfull + kStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int n_qt = (prm.seq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int hk = blockIdx.y / prm.head_blocks;
  const int h_first = (blockIdx.y % prm.head_blocks) * NC;   // in the group
  const int n_active = min(NC, prm.group - h_first);
  const int b = blockIdx.z;

  // the KV tiles the Pallas predicate keeps: causal k_start <= last query
  // row of the tile; window k_start + BK - 1 > q0 - window
  const int n_tiles = (prm.seq_kv + BK - 1) / BK;
  int t_end = n_tiles;
  if (prm.causal) t_end = min(n_tiles, (q0 + kBQ - 1) / BK + 1);
  int t_begin = 0;
  if (prm.window > 0) {
    const int lo = q0 - prm.window - BK + 2;   // least surviving k_start
    if (lo > 0) t_begin = (lo + BK - 1) / BK;
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&vfull[s], 1);
      hopper::mbar_init(&empty[s], n_active);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (NC == 2) hopper::setmaxnreg_dec<24>();
    if (tid == 0) {
      hopper::mbar_arrive_expect_tx(qfull, n_active * L::kQ * 2);
      for (int c = 0; c < n_active; ++c) {
        const int h = hk * prm.group + h_first + c;
#pragma unroll
        for (int ch = 0; ch < DP / 64; ++ch) {
          hopper::tma_load_4d(qs + c * L::kQ + ch * kBQ * 64, &qmap, qfull,
                              64 * ch, q0, h, b);
        }
      }
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin;
        const int s = i % kStages;
        if (i >= kStages) hopper::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        hopper::mbar_arrive_expect_tx(&kfull[s], L::kKV * 2);
#pragma unroll
        for (int ch = 0; ch < DP / 64; ++ch) {
          hopper::tma_load_4d(ks + s * L::kKV + ch * BK * 64, &kmap,
                              &kfull[s], 64 * ch, t * BK, hk, b);
        }
        hopper::mbar_arrive_expect_tx(&vfull[s], L::kKV * 2);
#pragma unroll
        for (int ch = 0; ch < DP / 64; ++ch) {
          hopper::tma_load_4d(vs + s * L::kKV + ch * BK * 64, &vmap,
                              &vfull[s], 64 * ch, t * BK, hk, b);
        }
      }
    }
    return;
  }

  if constexpr (NC == 2) hopper::setmaxnreg_inc<240>();
  const int c = wg - 1;
  if (c >= n_active) return;
  const int h = hk * prm.group + h_first + c;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int row0 = q0 + warp * 16 + g;   // rows row0 and row0 + 8
  const bf16* q_tile = qs + c * L::kQ;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums

  hopper::mbar_wait(qfull, 0);
  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin;
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = t * BK;

    float sc[BK / 2];
    hopper::mbar_wait(&kfull[s], parity);
    hopper::wgmma_fence();
    score_product<DP, BK>(sc, q_tile, ks + s * L::kKV);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // scale (into the log2 domain) and mask
    const bool edge = (prm.causal && k0 + BK - 1 > q0) ||
                      k0 + BK > prm.seq_kv ||
                      (prm.window > 0 && k0 <= q0 + kBQ - 1 - prm.window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = sc[4 * j + e] * prm.scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          bool keep = key < prm.seq_kv;
          if (prm.causal) keep = keep && key <= row;
          if (prm.window > 0) keep = keep && key > row - prm.window;
          v = keep ? v : kNegInf;
        }
        sc[4 * j + e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * j + e] - m[e >> 1]);
        sc[4 * j + e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j + 0] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (kSplitP) {
          split_bf16x2(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1],
                       p_hi[kc][r], p_lo[kc][r]);
        } else {
          p_hi[kc][r] = hopper::pack_bf16x2(sc[8 * kc + 2 * r],
                                            sc[8 * kc + 2 * r + 1]);
        }
      }
    }

    hopper::mbar_wait(&vfull[s], parity);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
    value_product<DP, BK, kSplitP>(o, p_hi, p_lo, vs + s * L::kKV);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (tid == 0) hopper::mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  bf16* out = prm.out + b * prm.os_b + h * prm.os_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= prm.seq) continue;
    bf16* dst = out + row * prm.os_s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t4;   // even; D % 8 == 0
      if (col < prm.dim) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
}

template <int DP, int BK, int NC, bool kSplitP = true>
cudaError_t launch(const CUtensorMap& qmap, const CUtensorMap& kmap,
                   const CUtensorMap& vmap, const Params& prm, int batch,
                   cudaStream_t stream) {
  using L = Layout<DP, BK, NC>;
  static int smem_done[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::allow_dynamic_smem(
      flash_attention_wgmma_kernel<DP, BK, NC, kSplitP>, L::kBytes,
      smem_done);
  if (err != cudaSuccess) return err;
  const dim3 grid((prm.seq + kBQ - 1) / kBQ,
                  prm.n_kv_heads * prm.head_blocks, batch);
  flash_attention_wgmma_kernel<DP, BK, NC, kSplitP>
      <<<grid, L::kThreads, L::kBytes, stream>>>(qmap, kmap, vmap, prm);
  return cudaGetLastError();
}

template <int NC>
cudaError_t dispatch(int dp, bool split_p, const CUtensorMap& qmap,
                     const CUtensorMap& kmap, const CUtensorMap& vmap,
                     const Params& prm, int batch, cudaStream_t stream) {
  if (!split_p) {
    if constexpr (NC == 2) {
      if (dp == 128) {
        return launch<128, 128, 2, false>(qmap, kmap, vmap, prm, batch,
                                          stream);
      }
    }
    return cudaErrorInvalidValue;
  }
  switch (dp) {
    case 64:
      return launch<64, 128, NC>(qmap, kmap, vmap, prm, batch, stream);
    case 128:
      return launch<128, 128, NC>(qmap, kmap, vmap, prm, batch, stream);
    case 192:
      return launch<192, 64, NC>(qmap, kmap, vmap, prm, batch, stream);
    case 256:
      return launch<256, 64, NC>(qmap, kmap, vmap, prm, batch, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, head, seq) for q, k, v and out in
// that order; the last dimension of each is contiguous.  window: 0 = none,
// else >= 1 keys.  seq: query rows, seq_kv: keys (equal when causal or
// windowed).  split_p: 1 = P V from P_hi + P_lo (the kernel), 0 = from
// P rounded to bfloat16 (only 64 < D <= 128 with Hq / Hkv >= 2).  Query
// tiles go on grid.x, (KV head, head block) on grid.y and the batch on
// grid.z (up to 65535 each: the wrapper checks).
int flash_attention_wgmma_forward(const void* q, const void* k, const void* v,
                                  void* out, const long long* strides,
                                  int batch, int n_heads, int n_kv_heads,
                                  int seq, int seq_kv, int dim, int causal,
                                  int window, int split_p, float scale,
                                  void* stream) {
  if (dim < 8 || dim > kMaxDim || dim % 8 || n_kv_heads < 1 ||
      n_heads % n_kv_heads != 0 || window < 0 || seq < 1 || seq_kv < 1 ||
      batch < 1 || (seq != seq_kv && (causal || window))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dp = (dim + 63) / 64 * 64;
  const int bk = dp <= 128 ? 128 : 64;
  const int group = n_heads / n_kv_heads;
  const int nc = group >= 2 ? 2 : 1;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int heads[3] = {n_heads, n_kv_heads, n_kv_heads};
  const int lens[3] = {seq, seq_kv, seq_kv};
  const uint32_t rows[3] = {static_cast<uint32_t>(kBQ),
                            static_cast<uint32_t>(bk),
                            static_cast<uint32_t>(bk)};
  for (int i = 0; i < 3; ++i) {
    const uint64_t dims[4] = {static_cast<uint64_t>(dim),
                              static_cast<uint64_t>(lens[i]),
                              static_cast<uint64_t>(heads[i]),
                              static_cast<uint64_t>(batch)};
    const uint64_t bytes[3] = {static_cast<uint64_t>(strides[3 * i + 2]) * 2,
                               static_cast<uint64_t>(strides[3 * i + 1]) * 2,
                               static_cast<uint64_t>(strides[3 * i]) * 2};
    const uint32_t box[4] = {64, rows[i], 1, 1};
    cudaError_t err = hopper::make_map_bf16(&maps[i], ptrs[i], 4, dims, bytes,
                                            box);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Params prm;
  prm.out = static_cast<bf16*>(out);
  prm.os_b = strides[9];
  prm.os_h = strides[10];
  prm.os_s = strides[11];
  prm.n_heads = n_heads;
  prm.n_kv_heads = n_kv_heads;
  prm.group = group;
  prm.head_blocks = (group + nc - 1) / nc;
  prm.seq = seq;
  prm.seq_kv = seq_kv;
  prm.dim = dim;
  prm.causal = causal;
  prm.window = window;
  prm.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool split = split_p != 0;
  cudaError_t err = nc == 2
      ? dispatch<2>(dp, split, maps[0], maps[1], maps[2], prm, batch, s)
      : dispatch<1>(dp, split, maps[0], maps[1], maps[2], prm, batch, s);
  return static_cast<int>(err);
}

}  // extern "C"
