// Blocked online-softmax attention forward for Hopper (sm_90a), plain C
// interface.
//
//   flash_attention_forward  replaces src/repro/kernels/flash_attention.py
//                            _kernel / flash_attention_pallas:
//                            out (B, Hq, Sq, D) = softmax(q k^T * scale +
//                            mask) v, with k and v (B, Hkv, Skv, D) shared
//                            by Hq / Hkv query heads (GQA), a causal mask,
//                            an optional sliding window and a ragged tail.
//
// Sq and Skv differ only without a mask (cross-attention: whisper's 448
// decoder tokens, or one decode token, against 1500 encoder frames; the
// wrapper refuses a causal or windowed call at Sq != Skv): query tiles run
// over Sq, key tiles over Skv, and keys at or past Skv are masked.
//
// q, k, v and out share one dtype (float32 or bfloat16) and are contiguous
// in the reference's (B, H, S, D) layout.  Every load is widened to float32
// and all arithmetic is float32, as the Pallas kernel casts its tiles; out
// is rounded to the inputs' dtype once, after the final division.
//
// Where it runs: the attention of every float32 prefill layer of the LM
// zoo (repro_torch.models.attention.attn_apply).  At qwen3-1.7b's prefill
// shape, (4, 16, 2048, 128) bf16 causal with Hkv 8, a call does about
// 69 GFLOP (4 B Hq D per unmasked (q, k) pair) and moves about 100 MB, so
// it is bound by operations: 0.07 ms at the 989 TFLOP/s bf16 tensor-core
// rate against 0.03 ms for the bytes.  This kernel runs its products in
// float32 on CUDA cores (67 TFLOP/s peak), so it cannot come near that
// bound.  The wrapper sends bfloat16 with head_dim % 8 == 0 to the
// tensor-core kernel of flash_attention_wgmma.cu instead; float32 (and
// any other bfloat16 head_dim) runs here.
//
// Design.  The TPU kernel's sequential KV grid axis, which carried
// (acc, m, l) in VMEM scratch from one grid step to the next, becomes a
// loop inside one block: a block owns one (batch, query head, 64-row query
// tile) and walks the 64-key tiles that survive the Pallas skip predicate
// (causal upper triangle, outside the window) in ascending order.  Each of
// the 256 threads owns 4 query rows x 4 keys of the score tile and 4 rows x
// 4 NG columns of the accumulator, so a row's running max m and sum l live
// in registers, replicated over the 16 threads that share the row and
// reduced with warp shuffles.  Q and K are held transposed in shared
// memory (d-major, padded rows) so both operands of the score product are
// read as float4 without bank conflicts; P goes to shared memory
// transposed for the P V product, and V reuses K's buffer.  Masked scores
// take the reference's finite NEG_INF = -1e30, never -inf: a row whose
// first surviving tile is fully masked gets exp(0) = 1 weights there, and
// its next tile with a valid key wipes them exactly (corr = exp(-1e30 - m)
// = 0), as on the TPU; -inf would give exp(-inf + inf) = NaN.  Rows and
// keys at or past S are never read (shared memory is zero-filled there and
// the keys masked), which replaces the Pallas kernel's zeroing of the
// padded tail.  The KV head of query head h is h / (Hq / Hkv); each head of
// a group reloads its K and V tiles and L2 serves the repeat.  Shared
// memory is (D' (64 + 4) * 2 + 64 (64 + 4)) floats, D' = D rounded up to 4:
// 87 KB at D = 128 (two blocks per SM), 157 KB at D = 256.
//
// The entry returns cudaGetLastError() after its launch; it launches on the
// stream it is given, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;       // 16 x 16: 4 rows x 4 keys a thread
constexpr int kPad = 4;             // keeps float4 rows aligned, spreads banks
constexpr int kQStride = kBlockQ + kPad;
constexpr int kKStride = kBlockK + kPad;
constexpr int kMaxDim = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Floats of the buffer that holds K^T (dp x kKStride), then V
// (kBlockK x (dp + kPad)).
__host__ __device__ __forceinline__ int kv_floats(int dp) {
  const int kt = dp * kKStride;
  const int vs = kBlockK * (dp + kPad);
  return kt > vs ? kt : vs;
}

__host__ __device__ __forceinline__ int smem_floats(int dp) {
  return dp * kQStride + kv_floats(dp) + kBlockK * kQStride;
}

// NG: float4 column groups of the accumulator per thread (D' <= 64 NG).
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int n_heads, int n_kv_heads, int seq, int seq_kv,
                       int dim, int dp, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [dp][kQStride]
  float* kv = qt + dp * kQStride;               // K^T [dp][kKStride] | V
  float* ps = kv + kv_floats(dp);               // P^T [kBlockK][kQStride]
  const int vstride = dp + kPad;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;    // query rows ty * 4 + i
  const int tx = tid & 15;    // keys tx * 4 + j; columns (tx + 16 g) * 4 + c
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const long long q_base = ((long long)b * n_heads + h) * seq * dim;
  const long long kv_base =
      ((long long)b * n_kv_heads + hk) * seq_kv * dim;

  for (int p = tid; p < kBlockQ * dp; p += kThreads) {
    const int r = p / dp;
    const int c = p - r * dp;
    const int s = q0 + r;
    qt[c * kQStride + r] =
        (s < seq && c < dim) ? to_float(q[q_base + (long long)s * dim + c])
                             : 0.f;
  }

  float m[4], l[4], acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  // The KV tiles the Pallas predicate keeps: causal k_start <= last query
  // row of the tile; window k_start + kBlockK - 1 > q0 - window.
  const int n_tiles = (seq_kv + kBlockK - 1) / kBlockK;
  int t_end = n_tiles;
  if (causal) {
    const int last = (q0 + kBlockQ - 1) / kBlockK + 1;
    t_end = last < n_tiles ? last : n_tiles;
  }
  int t_begin = 0;
  if (window > 0) {
    const int lo = q0 - window - kBlockK + 2;   // least surviving k_start
    if (lo > 0) t_begin = (lo + kBlockK - 1) / kBlockK;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();   // Q stored; the previous tile's P V reads are done
    for (int p = tid; p < kBlockK * dp; p += kThreads) {
      const int r = p / dp;
      const int c = p - r * dp;
      const int s = k0 + r;
      kv[c * kKStride + r] =
          (s < seq_kv && c < dim)
              ? to_float(k[kv_base + (long long)s * dim + c])
              : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < dim; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kQStride +
                                                        ty * 4);
      const float4 bk = *reinterpret_cast<const float4*>(kv + d * kKStride +
                                                         tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
    }

    float rmax[4], rsum[4], corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      rmax[i] = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        bool keep = kpos < seq_kv;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        sc[i][j] = keep ? sc[i][j] * scale : kNegInf;
        rmax[i] = fmaxf(rmax[i], sc[i][j]);
      }
    }
    // the 16 threads of a row are the lanes that differ in their low 4 bits
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], off));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], rmax[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      rsum[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rsum[i] += sc[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], off);
      l[i] = l[i] * corr[i] + rsum[i];
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tx * 4 + j) * kQStride + ty * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();   // K^T reads done, P stored

    for (int p = tid; p < kBlockK * dp; p += kThreads) {
      const int r = p / dp;
      const int c = p - r * dp;
      const int s = k0 + r;
      kv[r * vstride + c] =
          (s < seq_kv && c < dim)
              ? to_float(v[kv_base + (long long)s * dim + c])
              : 0.f;
    }
    __syncthreads();

    for (int kk = 0; kk < kBlockK; ++kk) {
      const float4 pr = *reinterpret_cast<const float4*>(ps + kk * kQStride +
                                                         ty * 4);
      const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int col = (tx + 16 * g) * 4;
        if (col < dp) {
          const float4 vv =
              *reinterpret_cast<const float4*>(kv + kk * vstride + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][g][0] = fmaf(pv[i], vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(pv[i], vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(pv[i], vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(pv[i], vv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= seq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = out + q_base + (long long)s * dim;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = (tx + 16 * g) * 4 + c;
        if (col < dim) store(row + col, acc[i][g][c] / denom);
      }
  }
}

template <typename T, int NG>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int n_heads, int n_kv_heads, int seq,
                   int seq_kv, int dim, int causal, int window, float scale,
                   cudaStream_t stream) {
  static int smem_done[hopper::kMaxDevices] = {};
  const int dp = (dim + 3) & ~3;
  const int smem = smem_floats(dp) * static_cast<int>(sizeof(float));
  cudaError_t err = hopper::allow_dynamic_smem(flash_attention_kernel<T, NG>,
                                               smem, smem_done);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, n_heads, batch);
  flash_attention_kernel<T, NG><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n_heads, n_kv_heads,
      seq, seq_kv, dim, dp, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int batch, int n_heads, int n_kv_heads, int seq,
                     int seq_kv, int dim, int causal, int window, float scale,
                     cudaStream_t stream) {
  const int dp = (dim + 3) & ~3;
  switch ((dp + 63) / 64) {
    case 1:
      return launch<T, 1>(q, k, v, out, batch, n_heads, n_kv_heads, seq,
                          seq_kv, dim, causal, window, scale, stream);
    case 2:
      return launch<T, 2>(q, k, v, out, batch, n_heads, n_kv_heads, seq,
                          seq_kv, dim, causal, window, scale, stream);
    case 3:
      return launch<T, 3>(q, k, v, out, batch, n_heads, n_kv_heads, seq,
                          seq_kv, dim, causal, window, scale, stream);
    case 4:
      return launch<T, 4>(q, k, v, out, batch, n_heads, n_kv_heads, seq,
                          seq_kv, dim, causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  window: 0 = none, else >= 1 keys.
// seq: query rows, seq_kv: keys (equal when causal or windowed).
// Query tiles go on grid.x, heads on grid.y and the batch on grid.z (up to
// 65535 each: the wrapper checks).  1 <= dim <= 256, n_heads divisible by
// n_kv_heads.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* out, int batch, int n_heads, int n_kv_heads,
                            int seq, int seq_kv, int dim, int causal,
                            int window, float scale, int dtype,
                            void* stream) {
  if (dim < 1 || dim > kMaxDim || n_kv_heads < 1 ||
      n_heads % n_kv_heads != 0 || window < 0 || seq_kv < 1 ||
      (seq != seq_kv && (causal || window))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(q, k, v, out, batch, n_heads, n_kv_heads, seq,
                          seq_kv, dim, causal, window, scale, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(q, k, v, out, batch, n_heads, n_kv_heads,
                                  seq, seq_kv, dim, causal, window, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
