// Fan-in-masked matrix product for Hopper (sm_90a), plain C interface.
//
//   masked_matmul_forward  replaces src/repro/kernels/masked_matmul.py
//                          _kernel / masked_matmul_pallas:
//                          out (M, N) = x (M, K) @ (w * mask) (K, N) + b (N,)
//
// x, w, mask, b and out share one dtype (float32 or bfloat16); the
// accumulator is float32 and out is rounded to the inputs' dtype once, after
// the bias, as in the Pallas kernel.  b may be null (zeros).  For bfloat16
// the product w * mask is rounded to bfloat16 before it is used, as the
// Pallas kernel multiplies the two tiles in their own dtype.
//
// Where it runs: every SparseLinear forward of LogicNet training, and the
// input gradient dx = dy @ (w * mask)^T of its backward (the wrapper passes
// the transposed operands).  At fpga4hep model A's widths (M = 256 rows,
// K, N <= 64) a call moves about 160 KB and does about 2 MFLOP, so it is
// bound by launch latency, far below either the 3.35 TB/s memory bound or
// the 67 TFLOP/s float32 CUDA-core rate.  At large shapes (4096^3) it is
// bound by operations: float32 must stay float32, so no tensor cores.
//
// Design: one block owns a 64 x 64 output tile (256 threads, 4 x 4 outputs
// each), walks K in 16-deep shared-memory tiles, applies the mask while it
// loads the w tile, and zeroes the ragged M, N and K edges itself, so no
// padding is ever read.  Each output keeps one float32 accumulator that
// takes k in ascending order with fmaf.  That order matters: the float
// path of a trained LogicNet then sums its nonzero fan-in terms in the same
// order as the truth-table generator, which walks each neuron's sorted
// fan-in indices, and adding the exact zeros of the masked-out weights
// changes nothing.  The TPU kernel padded to (128, 128, 512) MXU blocks;
// here small tiles keep enough blocks in flight for the small training
// shapes.  The wrapper sends bfloat16 with K and N multiples of 8 to the
// tensor-core kernel of masked_matmul_wgmma.cu instead; float32 (and any
// other bfloat16 shape) runs here.
//
// The entry returns cudaGetLastError() after its launch; it launches on the
// stream it is given, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kPerThreadM = 4;
constexpr int kPerThreadN = 4;
constexpr int kThreadsN = kTileN / kPerThreadN;                 // 16
constexpr int kThreads = (kTileM / kPerThreadM) * kThreadsN;    // 256

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// w * mask in the inputs' dtype, widened to float.
__device__ __forceinline__ float masked_weight(float w, float m) {
  return w * m;
}
__device__ __forceinline__ float masked_weight(__nv_bfloat16 w,
                                               __nv_bfloat16 m) {
  return __bfloat162float(
      __float2bfloat16_rn(__bfloat162float(w) * __bfloat162float(m)));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ mask, const T* __restrict__ b,
                     int m_dim, int n_dim, int k_dim, T* __restrict__ out) {
  // x tile stored k-major (xs[k][m]); +1 column keeps the transposing
  // stores free of bank conflicts
  __shared__ float xs[kTileK][kTileM + 1];
  __shared__ float ws[kTileK][kTileN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * kTileN;
  const int tm = tid / kThreadsN;   // rows tm + i * 16 of the tile
  const int tn = tid % kThreadsN;   // columns tn * 4 + j of the tile

  float acc[kPerThreadM][kPerThreadN];
#pragma unroll
  for (int i = 0; i < kPerThreadM; ++i)
#pragma unroll
    for (int j = 0; j < kPerThreadN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_dim; k0 += kTileK) {
    for (int p = tid; p < kTileM * kTileK; p += kThreads) {
      const int r = p / kTileK;
      const int c = p - r * kTileK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      xs[c][r] = (gm < m_dim && gk < k_dim)
                     ? to_float(x[static_cast<long long>(gm) * k_dim + gk])
                     : 0.f;
    }
    for (int p = tid; p < kTileK * kTileN; p += kThreads) {
      const int r = p / kTileN;
      const int c = p - r * kTileN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      float v = 0.f;
      if (gk < k_dim && gn < n_dim) {
        const long long i = static_cast<long long>(gk) * n_dim + gn;
        v = masked_weight(w[i], mask[i]);
      }
      ws[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[kPerThreadM];
      float bw[kPerThreadN];
#pragma unroll
      for (int i = 0; i < kPerThreadM; ++i) a[i] = xs[kk][tm + i * 16];
#pragma unroll
      for (int j = 0; j < kPerThreadN; ++j) bw[j] = ws[kk][tn * kPerThreadN + j];
#pragma unroll
      for (int i = 0; i < kPerThreadM; ++i)
#pragma unroll
        for (int j = 0; j < kPerThreadN; ++j)
          acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kPerThreadN; ++j) {
    const int gn = n0 + tn * kPerThreadN + j;
    if (gn >= n_dim) continue;
    const float bias = b != nullptr ? to_float(b[gn]) : 0.f;
#pragma unroll
    for (int i = 0; i < kPerThreadM; ++i) {
      const int gm = m0 + tm + i * 16;
      if (gm < m_dim) {
        store(out + static_cast<long long>(gm) * n_dim + gn, acc[i][j] + bias);
      }
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* mask, const void* b,
            int m_dim, int n_dim, int k_dim, void* out, cudaStream_t stream) {
  const dim3 grid((m_dim + kTileM - 1) / kTileM, (n_dim + kTileN - 1) / kTileN);
  masked_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(mask), static_cast<const T*>(b), m_dim, n_dim,
      k_dim, static_cast<T*>(out));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Rows go on grid.x (up to 2^31 - 1
// tiles), columns on grid.y (up to 65535 tiles of 64: the wrapper checks).
int masked_matmul_forward(const void* x, const void* w, const void* mask,
                          const void* b, int m_dim, int n_dim, int k_dim,
                          int dtype, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, mask, b, m_dim, n_dim, k_dim, out, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, mask, b, m_dim, n_dim, k_dim, out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
