// Flash attention (forward) in float32 on Hopper's tensor cores (sm_90a):
// each float32 product as three TF32 products, plain C interface.
//
//   flash_attention_tf32_forward  replaces src/repro/kernels/
//                                 flash_attention.py _kernel /
//                                 flash_attention_pallas for float32:
//                                 out = softmax(q k^T * scale + mask) v,
//                                 GQA (query head h reads KV head
//                                 h / (Hq / Hkv)), causal, an optional
//                                 sliding window, a ragged tail.
//
// q has Sq rows and k, v Skv keys; they differ only without a mask
// (cross-attention: whisper's 448 decoder tokens against its 1500 encoder
// frames; the wrapper refuses a causal or windowed call at Sq != Skv).
// Query tiles run over Sq, key tiles over Skv, and keys at or past Skv are
// masked and zero-filled.
//
// q, k, v and out are float32 (B, H, S, D) views with a contiguous last
// dimension, every other stride a multiple of 4 elements and 16-byte
// aligned starts (cp.async copies 16 bytes), D % 8 == 0 and D <= 256: the
// wrapper (kernels/flash_attention.py) sends every other float32 call to
// the SIMT kernel of flash_attention.cu.  The semantics are those of
// flash_attention.cu and the Pallas kernel: the online softmax (running
// max m and sum l), the exponentials and both accumulators in float32,
// the finite -1e30 mask (a fully masked first tile gets weights of 1 that
// the first tile with a valid key wipes exactly; -inf would give NaN),
// the divide by max(l, 1e-30), rows and keys at or past S never read (K
// and V rows past S are zero-filled: a zero weight times a stale NaN
// would not vanish), tiles the Pallas predicate skips skipped.
//
// Precision.  The tensor cores take TF32 (10 mantissa bits): one TF32
// product per float32 product leaves about 1e-3 relative, 100 times the
// float32 tolerance.  So each operand x is split into big = x rounded to
// TF32 (to nearest, ties away from zero: the cvt.rna rule, written as
// (bits + 0x1000) & ~0x1FFF) and small = x - big (exact in float32), and
// each product A B is issued as A_small B_big + A_big B_small + A_big B_big
// into one float32 accumulator.  small goes to mma as it is: mma reads a
// TF32 operand's top 19 bits, so small enters rounded toward zero (as in
// CUTLASS's 3xTF32 GEMMs; rounding it first costs time and changes no
// reading: FA_TF32_SMALL_RNA below).  That and the dropped
// A_small B_small leave about 2^-21 relative: float32-accurate
// (tests/test_torch_flash_attention.py emulates the splits on the CPU).
// Both products are split: S = Q K^T and O += P V, P straight from the S
// accumulator registers.
//
// What bounds it: at qwen3-1.7b's prefill shape, (4, 16, 2048, 128)
// causal with Hkv 8, a call does 68.7 GFLOP of float32 work (4 B Hq D per
// unmasked (q, k) pair), three times that on the tensor cores: 0.417 ms
// at the 495 TFLOP/s dense TF32 rate, against 0.060 ms for its 201 MB:
// bound by operations.  mma.sync (not wgmma) issues the products, and the
// splits, the softmax and the shared-memory fragment reads share the
// issue slots and the warps' latency with it.
//
// Design (FA2-style).  A block of NW warps owns one (batch, query head,
// BQ = 16 NW query rows) tile and walks the BK-key K / V tiles that
// survive the Pallas predicate in ascending order, the longest causal
// blocks first; each warp holds 16 rows.  Q is copied into shared memory
// once; K and V tiles go through a 2-stage cp.async ring, one barrier a
// tile, the next tile's copies issued right after it.  Tiles are stored
// raw and each warp splits the fragments it reads; storing them split
// would double their shared memory (no second stage at D = 128) and the
// bytes every warp reads from it.  Each warp runs
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32: S over D in k8 steps, the
// two A columns a thread feeds (t, t + 4) carrying dims (2t, 2t + 1) so Q
// and K fragments are 8-byte reads (the sum over d does not care which dim
// a column carries); P V over the tile's keys in k8 steps, where the S
// accumulator's columns (2t, 2t + 1) feed A columns (t, t + 4) as they
// stand and the V fragment reads take keys 2t and 2t + 1 to match (no
// shuffles).  Shared rows are padded to 8 mod 32 floats for Q and K (the
// 8-byte reads of a half-warp hit 32 banks) and 4 mod 32 for V (rows 2t,
// 2t + 1 of column g hit 32 banks).  Columns past D are zero in shared
// memory, so every loop runs to DP with no branch in it: a branch on D in
// the unrolled P V loop keeps the compiler from scheduling it as a whole
// (FA_TF32_PV_BRANCH below).
// Tile shapes, per DP = D rounded up to 64, 128 or 256:
//   DP  64: 8 warps (BQ 128), BK 64, 106 KB, two blocks an SM;
//   DP 128: 8 warps (BQ 128), BK 64, 202 KB, one block an SM;
//   DP 256: 4 warps (BQ 64),  BK 32, 197 KB (O takes 128 registers).
// The output is stored from registers through its own strides: the LM
// gets a (B, S, H, D) buffer and q, k, v are read through the strides of
// its transposed views, so the float32 route makes no copies.
//
// The entry returns cudaGetLastError() after its launch; it launches on
// the stream it is given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// Design knobs.  The library the wrapper builds takes every default;
// tools/flash_tf32_variants.py builds the other values (nvcc -D) to time
// the choice each undoes.
//   FA_TF32_SMALL_RNA   1: small rounded by the cvt.rna rule before mma
//   FA_TF32_S_BRANCH    1: S's k8 steps stop at D (a branch in the loop)
//   FA_TF32_PV_BRANCH   1: P V's column n-tiles past D skipped (a branch)
//   FA_TF32_EX2_APPROX  1: ex2.approx.ftz for the exponentials
//   FA_TF32_NW128, FA_TF32_BK128: warps a block, keys a K / V tile at DP 128
// and two that compute something else, to time what the splits and the
// second and third products cost:
//   FA_TF32_SPLIT       0: operands passed unsplit (big = small = x)
//   FA_TF32_PRODUCTS    1: A_big B_big alone
#ifndef FA_TF32_SMALL_RNA
#define FA_TF32_SMALL_RNA 0
#endif
#ifndef FA_TF32_S_BRANCH
#define FA_TF32_S_BRANCH 0
#endif
#ifndef FA_TF32_PV_BRANCH
#define FA_TF32_PV_BRANCH 0
#endif
#ifndef FA_TF32_EX2_APPROX
#define FA_TF32_EX2_APPROX 0
#endif
#ifndef FA_TF32_NW128
#define FA_TF32_NW128 8
#endif
#ifndef FA_TF32_BK128
#define FA_TF32_BK128 64
#endif
#ifndef FA_TF32_SPLIT
#define FA_TF32_SPLIT 1
#endif
#ifndef FA_TF32_PRODUCTS
#define FA_TF32_PRODUCTS 3
#endif

namespace {

constexpr int kMaxDim = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// NW warps of 16 query rows, BK keys a K / V tile, MINB blocks an SM
template <int DP>
struct Cfg;
template <>
struct Cfg<64> {
  static constexpr int NW = 8, BK = 64, MINB = 2;
};
template <>
struct Cfg<128> {
  static constexpr int NW = FA_TF32_NW128, BK = FA_TF32_BK128, MINB = 1;
};
template <>
struct Cfg<256> {
  static constexpr int NW = 4, BK = 32, MINB = 1;
};

template <int DP>
struct Layout {
  static constexpr int kBQ = 16 * Cfg<DP>::NW;
  static constexpr int kBK = Cfg<DP>::BK;
  static constexpr int kQK = DP + 8;      // Q and K row stride (floats)
  static constexpr int kVS = DP + 4;      // V row stride
  static constexpr int kQ = kBQ * kQK;
  static constexpr int kK = kBK * kQK;
  static constexpr int kStage = kK + kBK * kVS;
  static constexpr int kBytes = (kQ + 2 * kStage) * 4;
  static constexpr int kThreads = 32 * Cfg<DP>::NW;
};

// x rounded to TF32, to nearest with ties away from zero (cvt.rna)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small exactly, big a TF32 value; mma reads small's top 19 bits
// (small rounded toward zero), which leaves about 2^-21 |x| (see the top)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
#if !FA_TF32_SPLIT
  big = small = __float_as_uint(x);
#elif FA_TF32_SMALL_RNA
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
#else
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
#endif
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B in three TF32 products: A_small B_big + A_big B_small + A_big B_big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
#if FA_TF32_PRODUCTS == 3
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
#endif
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ float exp2_(float x) {
#if FA_TF32_EX2_APPROX
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
#endif
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(hopper::smem_u32(dst)), "l"(src),
                  "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + rows) of a (seq, dim) matrix (row stride ld elements)
// into dst (row stride sld), rows at or past seq zero-filled; columns at
// or past dim are not copied.
template <int THREADS>
__device__ __forceinline__ void load_rows(float* dst, int sld,
                                          const float* src, long long ld,
                                          int r0, int rows, int seq, int dim,
                                          int tid) {
  const int cpr = dim / 4;   // 16-byte chunks a row
  for (int c = tid; c < rows * cpr; c += THREADS) {
    const int r = c / cpr;
    const int col = (c - r * cpr) * 4;
    const bool valid = r0 + r < seq;
    cp_async16(dst + r * sld + col,
               valid ? src + (r0 + r) * ld + col : src, valid);
  }
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  long long qs_b, qs_h, qs_s, ks_b, ks_h, ks_s, vs_b, vs_h, vs_s;
  long long os_b, os_h, os_s;   // strides in elements
  int group, seq, seq_kv, dim, causal, window;
  float scale_log2;             // scale * log2(e)
};

template <int DP>
__global__ void __launch_bounds__(Layout<DP>::kThreads, Cfg<DP>::MINB)
flash_attention_tf32_kernel(const Params prm) {
  using L = Layout<DP>;
  constexpr int BK = L::kBK;
  constexpr int NT = BK / 8;   // key n-tiles of S = key k8 steps of P V
  constexpr int NO = DP / 8;   // column n-tiles of O
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][kQK]
  float* stages = qs + L::kQ;                   // [2][K [BK][kQK] | V]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int n_qt = (prm.seq + L::kBQ - 1) / L::kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * L::kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / prm.group;
  const float* qg = prm.q + b * prm.qs_b + h * prm.qs_h;
  const float* kg = prm.k + b * prm.ks_b + hk * prm.ks_h;
  const float* vg = prm.v + b * prm.vs_b + hk * prm.vs_h;

  // the KV tiles the Pallas predicate keeps: causal k_start <= last query
  // row of the tile; window k_start + BK - 1 > q0 - window
  const int n_tiles = (prm.seq_kv + BK - 1) / BK;
  int t_end = n_tiles;
  if (prm.causal) t_end = min(n_tiles, (q0 + L::kBQ - 1) / BK + 1);
  int t_begin = 0;
  if (prm.window > 0) {
    const int lo = q0 - prm.window - BK + 2;   // least surviving k_start
    if (lo > 0) t_begin = (lo + BK - 1) / BK;
  }

  load_rows<L::kThreads>(qs, L::kQK, qg, prm.qs_s, q0, L::kBQ, prm.seq,
                         prm.dim, tid);
  if (t_begin < t_end) {
    load_rows<L::kThreads>(stages, L::kQK, kg, prm.ks_s, t_begin * BK, BK,
                           prm.seq_kv, prm.dim, tid);
    load_rows<L::kThreads>(stages + L::kK, L::kVS, vg, prm.vs_s,
                           t_begin * BK, BK, prm.seq_kv, prm.dim, tid);
  }
  cp_async_commit();
  // Q, K and V columns past dim read as zeros (every k8 step of S and
  // every column n-tile of P V runs): Q rows, then both stages' K and V rows
  const int pad = DP - prm.dim;
  for (int c = tid; c < (L::kBQ + 4 * BK) * pad; c += L::kThreads) {
    const int r = c / pad;
    const int col = prm.dim + c % pad;
    if (r < L::kBQ) {
      qs[r * L::kQK + col] = 0.f;
    } else {
      const int sr = r - L::kBQ;   // stage, K or V, row
      float* st = stages + (sr / (2 * BK)) * L::kStage;
      const int kr = sr % (2 * BK);
      if (kr < BK) {
        st[kr * L::kQK + col] = 0.f;
      } else {
        st[L::kK + (kr - BK) * L::kVS + col] = 0.f;
      }
    }
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums
  const int row0 = q0 + warp * 16 + g;   // rows row0 and row0 + 8
  const float* qw = qs + (warp * 16 + g) * L::kQK + 2 * t;

  for (int tt = t_begin; tt < t_end; ++tt) {
    const int i = tt - t_begin;
    const float* ks = stages + (i & 1) * L::kStage;
    const float* vs = ks + L::kK;
    cp_async_wait_all();
    // this tile (and Q) landed for every thread, and every warp is done
    // with the previous tile, whose stage the next tile's copies refill
    __syncthreads();
    if (tt + 1 < t_end) {
      float* next = stages + ((i + 1) & 1) * L::kStage;
      load_rows<L::kThreads>(next, L::kQK, kg, prm.ks_s, (tt + 1) * BK, BK,
                             prm.seq_kv, prm.dim, tid);
      load_rows<L::kThreads>(next + L::kK, L::kVS, vg, prm.vs_s,
                             (tt + 1) * BK, BK, prm.seq_kv, prm.dim, tid);
      cp_async_commit();
    }
    const int k0 = tt * BK;

    // S = Q K^T: A columns t and t + 4 carry dims d0 + 2t and d0 + 2t + 1
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const float* kw = ks + g * L::kQK + 2 * t;
#pragma unroll
    for (int d0 = 0; d0 < DP; d0 += 8) {
#if FA_TF32_S_BRANCH
      if (d0 >= prm.dim) break;
#endif
      const float2 qa = *reinterpret_cast<const float2*>(qw + d0);
      const float2 qb = *reinterpret_cast<const float2*>(qw + 8 * L::kQK +
                                                         d0);
      uint32_t ab[4], as[4];
      split(qa.x, ab[0], as[0]);
      split(qb.x, ab[1], as[1]);
      split(qa.y, ab[2], as[2]);
      split(qb.y, ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 kv = *reinterpret_cast<const float2*>(
            kw + n * 8 * L::kQK + d0);
        uint32_t bb0, bs0, bb1, bs1;
        split(kv.x, bb0, bs0);
        split(kv.y, bb1, bs1);
        mma3(s[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }

    // scale (into the log2 domain) and mask; accumulator element e of
    // n-tile n is row row0 + 8 (e / 2), key k0 + 8 n + 2 t + (e % 2)
    const bool edge = (prm.causal && k0 + BK - 1 > q0) ||
                      k0 + BK > prm.seq_kv ||
                      (prm.window > 0 &&
                       k0 <= q0 + L::kBQ - 1 - prm.window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * prm.scale_log2;
        if (edge) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          bool keep = key < prm.seq_kv;
          if (prm.causal) keep = keep && key <= row;
          if (prm.window > 0) keep = keep && key > row - prm.window;
          x = keep ? x : kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2_(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V over the tile's keys in k8 steps j: A column t is key
    // 8 j + 2 t (accumulator elements 0 and 2), column t + 4 key
    // 8 j + 2 t + 1 (elements 1 and 3); B rows k = t, t + 4 read the same
    // keys of V, column n-tile n's column g
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t pb[4], ps[4];
      split(s[j][0], pb[0], ps[0]);
      split(s[j][2], pb[1], ps[1]);
      split(s[j][1], pb[2], ps[2]);
      split(s[j][3], pb[3], ps[3]);
      const float* vr = vs + (8 * j + 2 * t) * L::kVS + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
#if FA_TF32_PV_BRANCH
        if (8 * n >= prm.dim) continue;
#endif
        uint32_t bb0, bs0, bb1, bs1;
        split(vr[8 * n], bb0, bs0);
        split(vr[L::kVS + 8 * n], bb1, bs1);
        mma3(o[n], pb, ps, bb0, bb1, bs0, bs1);
      }
    }
  }
  cp_async_wait_all();

  float* out = prm.out + b * prm.os_b + h * prm.os_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= prm.seq) continue;
    float* dst = out + row * prm.os_s + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (8 * n < prm.dim) {
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(o[n][0 + 2 * r] / denom, o[n][1 + 2 * r] / denom);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const Params& prm, int n_heads, int batch,
                   cudaStream_t stream) {
  using L = Layout<DP>;
  static int smem_done[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::allow_dynamic_smem(
      flash_attention_tf32_kernel<DP>, L::kBytes, smem_done);
  if (err != cudaSuccess) return err;
  const dim3 grid((prm.seq + L::kBQ - 1) / L::kBQ, n_heads, batch);
  flash_attention_tf32_kernel<DP>
      <<<grid, L::kThreads, L::kBytes, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, head, seq) for q, k, v and out in
// that order; the last dimension of each is contiguous.  q, k and v start
// 16-byte aligned with their first three strides multiples of 4; out
// 8-byte aligned with even strides.  window: 0 = none, else >= 1 keys.
// seq: query rows, seq_kv: keys (equal when causal or windowed).
// Query tiles go on grid.x, heads on grid.y and the batch on grid.z (up
// to 65535 each: the wrapper checks).  8 <= dim <= 256, dim % 8 == 0,
// n_heads divisible by n_kv_heads.
int flash_attention_tf32_forward(const void* q, const void* k, const void* v,
                                 void* out, const long long* strides,
                                 int batch, int n_heads, int n_kv_heads,
                                 int seq, int seq_kv, int dim, int causal,
                                 int window, float scale, void* stream) {
  if (dim < 8 || dim > kMaxDim || dim % 8 || n_kv_heads < 1 ||
      n_heads % n_kv_heads != 0 || window < 0 || seq < 1 || seq_kv < 1 ||
      batch < 1 || (seq != seq_kv && (causal || window))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 || strides[3 * i] % 4 ||
        strides[3 * i + 1] % 4 || strides[3 * i + 2] % 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (reinterpret_cast<uintptr_t>(out) % 8 || strides[9] % 2 ||
      strides[10] % 2 || strides[11] % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  prm.q = static_cast<const float*>(q);
  prm.k = static_cast<const float*>(k);
  prm.v = static_cast<const float*>(v);
  prm.out = static_cast<float*>(out);
  prm.qs_b = strides[0];
  prm.qs_h = strides[1];
  prm.qs_s = strides[2];
  prm.ks_b = strides[3];
  prm.ks_h = strides[4];
  prm.ks_s = strides[5];
  prm.vs_b = strides[6];
  prm.vs_h = strides[7];
  prm.vs_s = strides[8];
  prm.os_b = strides[9];
  prm.os_h = strides[10];
  prm.os_s = strides[11];
  prm.group = n_heads / n_kv_heads;
  prm.seq = seq;
  prm.seq_kv = seq_kv;
  prm.dim = dim;
  prm.causal = causal;
  prm.window = window;
  prm.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim <= 64) return static_cast<int>(launch<64>(prm, n_heads, batch, s));
  if (dim <= 128) return static_cast<int>(launch<128>(prm, n_heads, batch, s));
  return static_cast<int>(launch<256>(prm, n_heads, batch, s));
}

}  // extern "C"
