// Flash attention's backward in bfloat16 on Hopper's tensor cores (sm_90a:
// TMA, mbarriers, wgmma), plain C interface.
//
//   flash_attention_wgmma_backward  dq, dk, dv of
//                                  out = softmax(q k^T * scale + mask) v
//                                  for a causal or unmasked call at
//                                  Sq == Skv, GQA (query head h reads KV
//                                  head h / (Hq / Hkv)), from the training
//                                  forward's row log-sum-exp and float32
//                                  output (flash_attention_wgmma.cu
//                                  flash_attention_wgmma_forward_train).
//
// It replaces no TPU kernel: the reference trains through XLA's autograd
// of its pure-XLA _chunked_attention (src/repro/models/attention.py), and
// its Pallas flash kernel has no backward.  The port's training attention
// (models/attention.py attn_apply(train=True)) reaches it through
// kernels/flash_attention.py FlashAttentionFn wherever the chunked form
// computes the true function (attn_train_route).
//
// Arithmetic, as the chunked form's float32 autograd:
//   S = q k^T, P = exp(S * scale - lse)      (recomputed from the lse)
//   dV = P^T dO,  dP = dO V^T,  D = rowsum(dO o O32)
//   dS = P o (dP - D),  dQ = dS K * scale,  dK = dS^T Q * scale
// dK and dV sum over the query heads of a KV head.  q, k, v and dO are
// bfloat16, so Q K^T and dO V^T are exact products summed in float32; P and
// dS are float32 and enter their products as hi + lo bfloat16 halves (as
// the forward's P V), two products into one float32 accumulator.  D uses
// the float32 output O32, the value the chunked form differentiates.
// Softmax, lse and D stay float32; dq, dk and dv are rounded to bfloat16
// once, from their float32 sums.
//
// What bounds it: at qwen3-1.7b's training shape, (4, 16, 8, 2048, 128)
// causal, the products come to 5 of the forward's Q K^T each (S twice, dP
// twice, dV, dK and dQ, the last three split) over the 2.1 M unmasked
// pairs a head: 20 D flops a pair, 344 GFLOP (0.35 ms at 989 TFLOP/s);
// the bytes (q, k, v, dO, O32, lse once, dq, dk, dv) are ~0.18 GB
// (0.05 ms): bound by operations.  The exponentials (two a score) are the
// next limit.
//
// Design.  Two kernels on the stream, deterministic (no atomics):
//
//   dq pass (flash_attention_wgmma_bwd_dq_kernel): one block per (batch,
//   64 query rows, KV head, group of up to NC = 2 query heads), warpgroup 0
//   the producer (Q and dO of each head once, then a 2-stage ring of 64-key
//   K and V tiles by TMA), warpgroup 1 + c the consumer of head c.  A
//   consumer first computes D for its 64 rows from dO and O32 (global
//   loads; it writes D for the dk/dv pass), then per key tile S = Q K^T and
//   dP = dO V^T (wgmma, shared memory), P and dS in registers on the
//   accumulator layout, and dQ += dS K (dS as hi + lo register A fragments,
//   K read MN-major).  Causal key tiles past the query tile are not
//   loaded.
//
//   dk/dv pass (flash_attention_wgmma_bwd_dkdv_kernel): one block per
//   (64 keys, KV head, batch), which holds K and V and walks the query
//   heads of its group and the query tiles at or after its keys (causal);
//   the producer keeps a 2-stage ring of Q, dO, lse and D tiles.  Two
//   consumer warpgroups split the work so that neither holds two
//   accumulators of DP columns (dp 256 leaves no registers for both):
//   warpgroup 1 computes S^T = K Q^T, P^T, and dV += P^T dO, and hands P^T
//   (float32) to warpgroup 2 through shared memory (two buffers, mbarriers
//   both ways); warpgroup 2 computes dP^T = V dO^T, dS^T = P^T o (dP^T -
//   D), and dK += dS^T Q.  Each does three products a tile.
//
// Heads are zero-padded to DP, a multiple of 64, as in the forward (TMA
// fills the columns past D with zeros).  lse and D are (B, Hq, rows) with
// rows a multiple of 64, so a tile's 64 values are one 256-byte bulk copy.
// Rows and keys at or past S are masked out of P and dS.  No window: the
// route leaves windowed calls on the chunked form.
//
// The entry returns cudaGetLastError() after its launches (or the error of
// building a tensor map); it launches on the stream it is given, allocates
// nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_wgmma.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash_wgmma::score_product;
using flash_wgmma::split_fragments;
using flash_wgmma::value_product;

constexpr int kT = 64;          // query rows and keys of a tile
constexpr int kStages = 2;
constexpr int kMaxDim = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* dout;              // for D
  const float* o32;              // contiguous (B, Hq, S, D)
  const float* lse;              // (B, Hq, rows)
  float* delta;                  // (B, Hq, rows), written by the dq pass
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long do_b, do_h, do_s;    // element strides
  long long dq_b, dq_h, dq_s;
  long long dk_b, dk_h, dk_s;
  long long dv_b, dv_h, dv_s;
  int n_heads, n_kv_heads, group, head_blocks, seq, rows, dim, causal;
  float scale, scale_log2;
};

__device__ __forceinline__ bool keep(const Params& prm, int row, int key) {
  return row < prm.seq && key < prm.seq && (!prm.causal || key <= row);
}

// ------------------------------------------------------------- dq pass

template <int DP, int NC>
struct DqLayout {
  static constexpr int kTile = kT * DP;          // elements of a tile
  static constexpr int kBytes = (2 * NC + 2 * kStages) * kTile * 2 +
                                NC * kT * 4 + (1 + 3 * kStages) * 8 + 1024;
  static constexpr int kThreads = 128 * (NC + 1);
};

template <int DP, int NC>
__global__ void __launch_bounds__(DqLayout<DP, NC>::kThreads, 1)
flash_attention_wgmma_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                                    const __grid_constant__ CUtensorMap kmap,
                                    const __grid_constant__ CUtensorMap vmap,
                                    const __grid_constant__ CUtensorMap domap,
                                    const Params prm) {
  using L = DqLayout<DP, NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qs = reinterpret_cast<bf16*>(base);        // [NC] tiles
  bf16* dos = qs + NC * L::kTile;                   // [NC]
  bf16* ks = dos + NC * L::kTile;                   // [stage]
  bf16* vs = ks + kStages * L::kTile;               // [stage]
  float* dsm = reinterpret_cast<float*>(vs + kStages * L::kTile);  // [NC][64]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(dsm + NC * kT);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + kStages;
  uint64_t* empty = vfull + kStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int n_qt = (prm.seq + kT - 1) / kT;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kT;
  const int hk = blockIdx.y / prm.head_blocks;
  const int h_first = (blockIdx.y % prm.head_blocks) * NC;
  const int n_active = min(NC, prm.group - h_first);
  const int b = blockIdx.z;
  const int n_tiles = prm.causal ? q0 / kT + 1 : n_qt;

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
      hopper::mbar_arrive_expect_tx(qfull, 2 * n_active * L::kTile * 2);
      for (int c = 0; c < n_active; ++c) {
        const int h = hk * prm.group + h_first + c;
#pragma unroll
        for (int ch = 0; ch < DP / 64; ++ch) {
          hopper::tma_load_4d(qs + c * L::kTile + ch * kT * 64, &qmap, qfull,
                              64 * ch, q0, h, b);
          hopper::tma_load_4d(dos + c * L::kTile + ch * kT * 64, &domap,
                              qfull, 64 * ch, q0, h, b);
        }
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) hopper::mbar_wait(&empty[s], (t / kStages - 1) & 1);
        hopper::mbar_arrive_expect_tx(&kfull[s], L::kTile * 2);
#pragma unroll
        for (int ch = 0; ch < DP / 64; ++ch) {
          hopper::tma_load_4d(ks + s * L::kTile + ch * kT * 64, &kmap,
                              &kfull[s], 64 * ch, t * kT, hk, b);
        }
        hopper::mbar_arrive_expect_tx(&vfull[s], L::kTile * 2);
#pragma unroll
        for (int ch = 0; ch < DP / 64; ++ch) {
          hopper::tma_load_4d(vs + s * L::kTile + ch * kT * 64, &vmap,
                              &vfull[s], 64 * ch, t * kT, hk, b);
        }
      }
    }
    return;
  }

  if constexpr (NC == 2) hopper::setmaxnreg_inc<240>();
  const int c = wg - 1;
  if (c >= n_active) return;
  const int h = hk * prm.group + h_first + c;
  const long long bh = static_cast<long long>(b) * prm.n_heads + h;

  // D = rowsum(dO o O32) for the tile's rows: two threads a row, half the
  // columns each (D % 8 == 0, so a half is whole float4 and bfloat16x4)
  {
    const int r = tid / 2;
    const int row = q0 + r;
    const int half = prm.dim / 2;
    const int c0 = (tid % 2) * half;
    float sum = 0.f;
    if (row < prm.seq) {
      const float* orow = prm.o32 + (bh * prm.seq + row) * prm.dim;
      const bf16* drow = prm.dout + b * prm.do_b + h * prm.do_h +
                         row * prm.do_s;
      for (int col = c0; col < c0 + half; col += 4) {
        const float4 o = *reinterpret_cast<const float4*>(orow + col);
        const uint2 raw = *reinterpret_cast<const uint2*>(drow + col);
        const float2 d01 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 d23 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        sum += o.x * d01.x + o.y * d01.y + o.z * d23.x + o.w * d23.y;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (tid % 2 == 0) {
      dsm[c * kT + r] = sum;
      prm.delta[bh * prm.rows + q0 + r] = sum;
    }
    hopper::named_barrier_sync(1 + c, 128);
  }

  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int row0 = q0 + warp * 16 + g;   // rows row0 and row0 + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < prm.seq ? prm.lse[bh * prm.rows + row] * kLog2e : 0.f;
    dlt[r] = dsm[c * kT + warp * 16 + g + 8 * r];
  }
  const bf16* q_tile = qs + c * L::kTile;
  const bf16* do_tile = dos + c * L::kTile;

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  hopper::mbar_wait(qfull, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int k0 = t * kT;

    float sc[kT / 2], dp[kT / 2];
    hopper::mbar_wait(&kfull[s], parity);
    hopper::wgmma_fence();
    score_product<DP, kT>(sc, q_tile, ks + s * L::kTile);
    hopper::wgmma_commit();
    hopper::mbar_wait(&vfull[s], parity);
    score_product<DP, kT>(dp, do_tile, vs + s * L::kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    const bool edge = (prm.causal && k0 + kT - 1 > q0) ||
                      k0 + kT > prm.seq || q0 + kT > prm.seq;
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = exp2f(sc[4 * j + e] * prm.scale_log2 - lse2[r]);
        float ds = p * (dp[4 * j + e] - dlt[r]);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          ds = keep(prm, row0 + 8 * r, key) ? ds : 0.f;
        }
        sc[4 * j + e] = ds;
      }
    }
    uint32_t hi[kT / 16][4], lo[kT / 16][4];
    split_fragments<kT>(sc, hi, lo);

    hopper::fence_regs(dq);
    hopper::wgmma_fence();
    value_product<DP, kT>(dq, hi, lo, ks + s * L::kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    if (tid == 0) hopper::mbar_arrive(&empty[s]);
  }

  bf16* out = prm.dq + b * prm.dq_b + h * prm.dq_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= prm.seq) continue;
    bf16* dst = out + row * prm.dq_s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < prm.dim) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            dq[4 * j + 2 * r] * prm.scale, dq[4 * j + 2 * r + 1] * prm.scale);
      }
    }
  }
}

// ---------------------------------------------------------- dk/dv pass

template <int DP>
struct DkvLayout {
  static constexpr int kTile = kT * DP;
  static constexpr int kPBuf = kT * kT;          // floats of a P^T buffer
  static constexpr int kBytes = (2 + 2 * kStages) * kTile * 2 +
                                2 * kPBuf * 4 + 2 * kStages * kT * 4 +
                                (1 + 2 * kStages + 4) * 8 + 1024;
  static constexpr int kThreads = 384;
};

template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, long long stride,
                                           const float (&acc)[DP / 2],
                                           float mul, int row0, int t4,
                                           const Params& prm) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= prm.seq) continue;
    bf16* dst = out + row * stride;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < prm.dim) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(DkvLayout<DP>::kThreads, 1)
flash_attention_wgmma_bwd_dkdv_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap, const Params prm) {
  using L = DkvLayout<DP>;
  static_assert(L::kBytes <= 232448, "dk/dv pass: shared memory");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* ks = reinterpret_cast<bf16*>(base);
  bf16* vs = ks + L::kTile;
  bf16* qs = vs + L::kTile;                         // [stage]
  bf16* dos = qs + kStages * L::kTile;              // [stage]
  float* pbuf = reinterpret_cast<float*>(dos + kStages * L::kTile);  // [2]
  float* lse_s = pbuf + 2 * L::kPBuf;               // [stage][64]
  float* dlt_s = lse_s + kStages * kT;              // [stage][64]
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(dlt_s + kStages * kT);
  uint64_t* qfull = kvfull + 1;
  uint64_t* empty = qfull + kStages;
  uint64_t* pfull = empty + kStages;
  uint64_t* pempty = pfull + 2;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int kt = blockIdx.x;
  const int k0 = kt * kT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_qt = (prm.seq + kT - 1) / kT;
  const int qt_begin = prm.causal ? kt : 0;
  const int per_head = n_qt - qt_begin;
  const int n_items = per_head * prm.group;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kvfull, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&qfull[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&pfull[i], 128);
      hopper::mbar_init(&pempty[i], 128);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();
    if (tid == 0) {
      hopper::mbar_arrive_expect_tx(kvfull, 2 * L::kTile * 2);
#pragma unroll
      for (int ch = 0; ch < DP / 64; ++ch) {
        hopper::tma_load_4d(ks + ch * kT * 64, &kmap, kvfull, 64 * ch, k0,
                            hk, b);
        hopper::tma_load_4d(vs + ch * kT * 64, &vmap, kvfull, 64 * ch, k0,
                            hk, b);
      }
      for (int i = 0; i < n_items; ++i) {
        const int s = i % kStages;
        const int h = hk * prm.group + i / per_head;
        const int q0 = (qt_begin + i % per_head) * kT;
        const long long row = (static_cast<long long>(b) * prm.n_heads + h) *
                              prm.rows + q0;
        if (i >= kStages) hopper::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        hopper::mbar_arrive_expect_tx(&qfull[s],
                                      2 * L::kTile * 2 + 2 * kT * 4);
#pragma unroll
        for (int ch = 0; ch < DP / 64; ++ch) {
          hopper::tma_load_4d(qs + s * L::kTile + ch * kT * 64, &qmap,
                              &qfull[s], 64 * ch, q0, h, b);
          hopper::tma_load_4d(dos + s * L::kTile + ch * kT * 64, &domap,
                              &qfull[s], 64 * ch, q0, h, b);
        }
        hopper::bulk_load_1d(lse_s + s * kT, prm.lse + row, kT * 4,
                             &qfull[s]);
        hopper::bulk_load_1d(dlt_s + s * kT, prm.delta + row, kT * 4,
                             &qfull[s]);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: key0, key0 + 8
  const bool dv_side = wg == 1;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  hopper::mbar_wait(kvfull, 0);
  for (int i = 0; i < n_items; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int q0 = (qt_begin + i % per_head) * kT;
    const int pb = i % 2;
    float* pt = pbuf + pb * L::kPBuf;
    const bool edge = (prm.causal && q0 < k0 + kT - 1) ||
                      k0 + kT > prm.seq || q0 + kT > prm.seq;

    float st[kT / 2];                    // S^T, then P^T (or dP^T, dS^T)
    hopper::mbar_wait(&qfull[s], parity);
    hopper::wgmma_fence();
    if (dv_side) {
      score_product<DP, kT>(st, ks, qs + s * L::kTile);
    } else {
      score_product<DP, kT>(st, vs, dos + s * L::kTile);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);

    const float* col_s = (dv_side ? lse_s : dlt_s) + s * kT;
    if (dv_side) {
      // P^T = exp(S^T * scale - lse[query]), handed to the dK side
      if (i >= 2) hopper::mbar_wait(&pempty[pb], ((i / 2) - 1) & 1);
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          float p = exp2f(st[4 * j + e] * prm.scale_log2 -
                          col_s[col] * kLog2e);
          if (edge) p = keep(prm, q0 + col, key0 + 8 * (e >> 1)) ? p : 0.f;
          st[4 * j + e] = p;
          pt[(4 * j + e) * 128 + tid] = p;
        }
      }
      hopper::mbar_arrive(&pfull[pb]);
    } else {
      // dS^T = P^T o (dP^T - D[query])
      hopper::mbar_wait(&pfull[pb], (i / 2) & 1);
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const float p = pt[(4 * j + e) * 128 + tid];
          st[4 * j + e] = p * (st[4 * j + e] - col_s[col]);
        }
      }
      hopper::mbar_arrive(&pempty[pb]);
    }
    uint32_t hi[kT / 16][4], lo[kT / 16][4];
    split_fragments<kT>(st, hi, lo);

    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    // dV += P^T dO, or dK += dS^T Q (dO and Q read MN-major)
    value_product<DP, kT>(acc, hi, lo,
                                (dv_side ? dos : qs) + s * L::kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (tid == 0) hopper::mbar_arrive(&empty[s]);
  }

  if (dv_side) {
    store_rows<DP>(prm.dv + b * prm.dv_b + hk * prm.dv_h, prm.dv_s, acc, 1.f,
                   key0, t4, prm);
  } else {
    store_rows<DP>(prm.dk + b * prm.dk_b + hk * prm.dk_h, prm.dk_s, acc,
                   prm.scale, key0, t4, prm);
  }
}

// ---------------------------------------------------------------- host

template <int DP, int NC>
cudaError_t launch_dq(const CUtensorMap* maps, const Params& prm, int batch,
                      cudaStream_t stream) {
  using L = DqLayout<DP, NC>;
  static int smem_done[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::allow_dynamic_smem(
      flash_attention_wgmma_bwd_dq_kernel<DP, NC>, L::kBytes, smem_done);
  if (err != cudaSuccess) return err;
  const dim3 grid((prm.seq + kT - 1) / kT, prm.n_kv_heads * prm.head_blocks,
                  batch);
  flash_attention_wgmma_bwd_dq_kernel<DP, NC>
      <<<grid, L::kThreads, L::kBytes, stream>>>(maps[0], maps[1], maps[2],
                                                 maps[3], prm);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkdv(const CUtensorMap* maps, const Params& prm,
                        int batch, cudaStream_t stream) {
  using L = DkvLayout<DP>;
  static int smem_done[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::allow_dynamic_smem(
      flash_attention_wgmma_bwd_dkdv_kernel<DP>, L::kBytes, smem_done);
  if (err != cudaSuccess) return err;
  const dim3 grid((prm.seq + kT - 1) / kT, prm.n_kv_heads, batch);
  flash_attention_wgmma_bwd_dkdv_kernel<DP>
      <<<grid, L::kThreads, L::kBytes, stream>>>(maps[0], maps[1], maps[2],
                                                 maps[3], prm);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_both(const CUtensorMap* maps, const Params& prm,
                        int batch, cudaStream_t stream) {
  // two query heads a dq block share its K and V tiles where they fit
  cudaError_t err = (DP <= 128 && prm.group >= 2)
      ? launch_dq<DP, (DP <= 128 ? 2 : 1)>(maps, prm, batch, stream)
      : launch_dq<DP, 1>(maps, prm, batch, stream);
  if (err != cudaSuccess) return err;
  return launch_dkdv<DP>(maps, prm, batch, stream);
}

}  // namespace

extern "C" {

// strides: 21 element strides, (batch, head, seq) for q, k, v, dout, dq,
// dk and dv in that order; the last dimension of each is contiguous and
// the first four are 16-byte aligned with 16-byte strides (TMA).  o32 is
// contiguous (B, Hq, S, D) float32; lse and delta are (B, Hq, rows)
// float32 with rows a multiple of 64 (delta is written here: D of every
// row, 0 past S).  Sq == Skv == seq.  The dq pass puts query tiles on
// grid.x, (KV head, head block) on grid.y and the batch on grid.z; the
// dk/dv pass key tiles, KV heads and the batch.
int flash_attention_wgmma_backward(const void* q, const void* k,
                                   const void* v, const void* o32,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   const long long* strides, int batch,
                                   int n_heads, int n_kv_heads, int seq,
                                   int rows, int dim, int causal, float scale,
                                   void* stream) {
  if (dim < 8 || dim > kMaxDim || dim % 8 || n_kv_heads < 1 ||
      n_heads % n_kv_heads != 0 || seq < 1 || batch < 1 || rows < seq ||
      rows % kT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = hopper::bind_device_of(q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dp = (dim + 63) / 64 * 64;
  const int group = n_heads / n_kv_heads;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  const int heads[4] = {n_heads, n_kv_heads, n_kv_heads, n_heads};
  for (int i = 0; i < 4; ++i) {
    const uint64_t dims[4] = {static_cast<uint64_t>(dim),
                              static_cast<uint64_t>(seq),
                              static_cast<uint64_t>(heads[i]),
                              static_cast<uint64_t>(batch)};
    const uint64_t bytes[3] = {static_cast<uint64_t>(strides[3 * i + 2]) * 2,
                               static_cast<uint64_t>(strides[3 * i + 1]) * 2,
                               static_cast<uint64_t>(strides[3 * i]) * 2};
    const uint32_t box[4] = {64, kT, 1, 1};
    err = hopper::make_map_bf16(&maps[i], ptrs[i], 4, dims, bytes, box);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Params prm;
  prm.dout = static_cast<const bf16*>(dout);
  prm.o32 = static_cast<const float*>(o32);
  prm.lse = static_cast<const float*>(lse);
  prm.delta = static_cast<float*>(delta);
  prm.dq = static_cast<bf16*>(dq);
  prm.dk = static_cast<bf16*>(dk);
  prm.dv = static_cast<bf16*>(dv);
  prm.do_b = strides[9];
  prm.do_h = strides[10];
  prm.do_s = strides[11];
  prm.dq_b = strides[12];
  prm.dq_h = strides[13];
  prm.dq_s = strides[14];
  prm.dk_b = strides[15];
  prm.dk_h = strides[16];
  prm.dk_s = strides[17];
  prm.dv_b = strides[18];
  prm.dv_h = strides[19];
  prm.dv_s = strides[20];
  prm.n_heads = n_heads;
  prm.n_kv_heads = n_kv_heads;
  prm.group = group;
  const int nc = (dp <= 128 && group >= 2) ? 2 : 1;
  prm.head_blocks = (group + nc - 1) / nc;
  prm.seq = seq;
  prm.rows = rows;
  prm.dim = dim;
  prm.causal = causal;
  prm.scale = scale;
  prm.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 64:
      err = launch_both<64>(maps, prm, batch, s);
      break;
    case 128:
      err = launch_both<128>(maps, prm, batch, s);
      break;
    case 192:
      err = launch_both<192>(maps, prm, batch, s);
      break;
    default:
      err = launch_both<256>(maps, prm, batch, s);
      break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
