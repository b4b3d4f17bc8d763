// The LogicNet-FFN's `wi` stage without grad in one launch on Hopper's
// tensor cores (sm_90a: TMA, mbarriers, wgmma), and its input quantizer as
// one elementwise pass; plain C interface.
//
//   masked_matmul_swiglu_quant_wgmma_forward
//       hq (M, N) = Q(silu(xq @ (w_gate * mask)) * (xq @ (w_up * mask)))
//       with every rounding of the composed path (models/layers.py
//       logicnet_ffn_apply with grad): each product rounded to bfloat16
//       from its float32 sum, SiLU in float32 as PyTorch's bfloat16 `silu`
//       computes it (x / (1 + expf(-x)), IEEE division) rounded to
//       bfloat16, the product of the two in float32 rounded to bfloat16,
//       then Q, rounded to bfloat16.
//   quant_relu_bf16_forward
//       out = Q(x) elementwise, bfloat16 in and out.
//
// Q is the QuantReLU of core/quantize.py in float32: the clip
// min(max(h, 0), max_val) (NaN passes, as torch.maximum / torch.minimum
// let it), an IEEE division by the float32 step, rintf (half to even, as
// torch.round), a product with the step, then + 0.0f, which is the STE's
// q + (x - x) in the forward and turns a -0 into +0.
//
// Neither replaces a TPU kernel: the reference leaves the SwiGLU and its
// quantizers to XLA's fusion of plain jnp around the Pallas masked matmul
// (src/repro/models/layers.py logicnet_ffn_apply).  They take the place
// of the composed path's ten-odd float32 elementwise passes over M x N
// and M x K (the gate and up products written and read back in bfloat16,
// casts, clip, divide, round, multiply, the STE's subtract and add).
//
// What bounds the fused kernel: at qwen3-1.7b's prefill (M 8192, K 2048,
// N 6144, fan-in-16 masks) it must move xq, w_gate, w_up, mask once and
// write hq (210 MB: 0.063 ms at 3.35 TB/s); the kept products are 0.4
// GFLOP, but the tensor cores do the dense 412 GFLOP (0.42 ms at 989
// TFLOP/s) as the plain masked matmul does, so it is bound by the dense
// products; the epilogue's expf and divisions come next (1.24 ms a call
// with IEEE divisions, 1.04 ms with the two passes below, 0.84 ms
// storing without the arithmetic, at 3 stages on an H100 SXM).
//
// Design: masked_matmul_wgmma.cu's, with the B side split between the two
// products.  One block owns 256 rows x 64 columns of hq and walks K in
// 64-deep steps through a ring of 4 shared-memory stages of 56 KB (the x
// tile K-major; w_gate[:, n0:n0+64] and w_up[:, n0:n0+64] as the two
// 64-wide chunks of one 128-wide N-major B tile; the one mask chunk
// mask[:, n0:n0+64] both share), all 128-byte swizzled by TMA.  Blocks
// walk the tiles in groups of 8 row tiles.  Warpgroup 0's one thread
// keeps the ring full (four TMA loads a stage); warpgroups 1 and 2 each
// own 128 rows: they multiply both chunks by the mask chunk in place
// (the two chunks and the mask chunk share one swizzled layout, so
// element i of either chunk takes element i of the mask), fence to the
// async proxy, meet at a named barrier and issue eight
// wgmma.m64n128k16 a step, exactly the plain kernel's instructions on a
// 128-wide tile.  In wgmma's accumulator layout the thread holding
// column c < 64 also holds column c + 64, so gate and up of one output
// sit in one thread's registers and the epilogue is register-local.  It
// takes two passes over a thread's 64 outputs: all of them without an
// IEEE division (swiglu_quant_fast, branch-free, so the compiler
// interleaves them), each flagged where its rounding could differ from
// the IEEE quotients', then the flagged pairs again with the composed
// path's arithmetic (swiglu_quant): a few in 10^4 outputs.  Four stages
// (224 KB) took 0.985 ms a call at M 8192 where three took 1.04.  TMA
// zero-fills the ragged M, N and K edges; the epilogue stores only rows
// < M and columns < N.
//
// What bounds the quantizer: it reads and writes M x K bfloat16 once
// (67 MB at M 8192, K 2048: 0.02 ms at 3.35 TB/s).  One thread takes
// eight elements as one 16-byte load and store, over a grid-stride loop;
// the tail past a multiple of 8 is taken one element a thread.
//
// The entries return cudaGetLastError() after their launch (or the error
// of building a tensor map); they launch on the stream they are given,
// allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 256;
constexpr int kBN = 64;                              // hq columns a block
constexpr int kBK = 64;
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kRowsPerConsumer = kBM / kConsumers;   // 128: two m64 tiles
constexpr int kGroupM = 8;                           // row tiles a group
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kXTile = kBM * kBK;                    // elements
constexpr int kWTile = kBK * 2 * kBN;                // gate and up chunks
constexpr int kMTile = kBK * kBN;                    // the shared mask chunk
constexpr int kStageBytes = (kXTile + kWTile + kMTile) * 2;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr int kN = 2 * kBN;       // the wgmma's N: gate and up side by side
// register 4 j + e holds column 8 j + 2 t + e % 2, so column c + kBN (up)
// sits kUp registers past column c (gate)
constexpr int kUp = 4 * (kBN / 8);

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  __nv_bfloat162 r = __hmul2(x, y);
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// QuantReLU's forward in float32 (see the top)
__device__ __forceinline__ float quant_relu(float h, float max_val,
                                            float step) {
  h = h < 0.f ? 0.f : h;
  h = h > max_val ? max_val : h;
  return __fadd_rn(__fmul_rn(rintf(__fdiv_rn(h, step)), step), 0.f);
}

// one output of the fused stage from the float32 sums of its two products,
// with the composed path's arithmetic (IEEE divisions)
__device__ __noinline__ float swiglu_quant(float gate, float up,
                                           float max_val, float step) {
  const float g = round_bf16(gate);
  const float act = round_bf16(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))));
  return quant_relu(round_bf16(__fmul_rn(act, round_bf16(up))), max_val,
                    step);
}

// The same output without an IEEE division, and `redo` set where it could
// differ from swiglu_quant's.  SiLU's quotient comes from __fdividef
// (within 2 ulp for a divisor below 2^126): its bfloat16 rounding can only
// differ from the IEEE quotient's when the float32 lies within 8 units of
// the low 16 bits' midpoint 0x8000, or the divisor is 2^126 or more (g
// below -87), or g is nonzero below 2^-100, or NaN.  Q's quotient comes
// as h * (1 / step) (within 2 ulp of the IEEE quotient), whose rintf can
// only differ where it lies within max(t, 1) 2^-19 (16 ulp) of a
// half-integer, or is NaN.
__device__ __forceinline__ float swiglu_quant_fast(float gate, float up,
                                                   float max_val, float step,
                                                   float inv_step,
                                                   bool& redo) {
  const float g = round_bf16(gate);
  const float d = __fadd_rn(1.f, expf(-g));
  const float q = __fdividef(g, d);
  const uint32_t low = __float_as_uint(q) & 0xFFFFu;
  redo |= (low - 0x7FF8u <= 16u) || !(d < 0x1p126f) ||
          (fabsf(g) < 0x1p-100f && g != 0.f);
  float h = round_bf16(__fmul_rn(round_bf16(q), round_bf16(up)));
  h = h < 0.f ? 0.f : h;
  h = h > max_val ? max_val : h;
  const float t = __fmul_rn(h, inv_step);
  const float k = rintf(t);
  redo |= !(fabsf(fabsf(t - k) - 0.5f) > fmaxf(t, 1.f) * 0x1p-19f);
  return __fadd_rn(__fmul_rn(k, step), 0.f);
}

__global__ void __launch_bounds__(kThreads, 1)
masked_matmul_swiglu_quant_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap gmap,
    const __grid_constant__ CUtensorMap umap,
    const __grid_constant__ CUtensorMap mmap, int m_dim, int n_dim,
    int k_dim, float max_val, float step, bf16* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* xs = reinterpret_cast<bf16*>(base);
  bf16* ws = xs + kStages * kXTile;
  bf16* ms = ws + kStages * kWTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(ms + kStages * kMTile);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  // tile order: groups of kGroupM row tiles, column-major inside a group
  const int m_tiles = (m_dim + kBM - 1) / kBM;
  const int n_tiles = (n_dim + kBN - 1) / kBN;
  const int per_group = kGroupM * n_tiles;
  const int group = blockIdx.x / per_group;
  const int first_m = group * kGroupM;
  const int group_m = min(kGroupM, m_tiles - first_m);
  const int in_group = blockIdx.x - group * per_group;
  const int m0 = (first_m + in_group % group_m) * kBM;
  const int n0 = (in_group / group_m) * kBN;
  const int k_tiles = (k_dim + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) {
          hopper::mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        }
        hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
        const int k0 = kt * kBK;
        hopper::tma_load_2d(xs + s * kXTile, &xmap, &full[s], k0, m0);
        hopper::tma_load_2d(ws + s * kWTile, &gmap, &full[s], n0, k0);
        hopper::tma_load_2d(ws + s * kWTile + kBK * kBN, &umap, &full[s], n0,
                            k0);
        hopper::tma_load_2d(ms + s * kMTile, &mmap, &full[s], n0, k0);
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 128 c .. 128 c + 127 of the tile
  hopper::setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int ct = threadIdx.x - 128;   // 0 .. 255 over both consumers
  float acc[2][kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[0][i] = acc[1][i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    // both chunks *= the mask chunk, in place, then to the async proxy
    uint4* wv = reinterpret_cast<uint4*>(ws + s * kWTile);
    const uint4* mv = reinterpret_cast<const uint4*>(ms + s * kMTile);
#pragma unroll
    for (int i = ct; i < kWTile / 8; i += 128 * kConsumers) {
      uint4 w = wv[i];
      const uint4 m = mv[i % (kMTile / 8)];
      w.x = bf16x2_mul(w.x, m.x);
      w.y = bf16x2_mul(w.y, m.y);
      w.z = bf16x2_mul(w.z, m.z);
      w.w = bf16x2_mul(w.w, m.w);
      wv[i] = w;
    }
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1, 128 * kConsumers);

    const bf16* a_tile = xs + s * kXTile + c * kRowsPerConsumer * kBK;
    const bf16* b_tile = ws + s * kWTile;
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = hopper::desc_sw128(b_tile + kk * 16 * 64,
                                             kBK * 128, 1024);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint64_t da = hopper::desc_sw128(
            a_tile + i * 64 * kBK + kk * 16, 16, 1024);
        hopper::wgmma_ss_m64n128<1>(acc[i], da, db, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    if (kt > 0 && tid == 0) hopper::mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc[0]);
  hopper::fence_regs(acc[1]);

  // registers 4 j + e, j < kBN / 8: gate; kUp further: up of the same
  // output.  Every output first by swiglu_quant_fast, unrolled without a
  // branch; then the rare pairs it cannot vouch for again by swiglu_quant.
  const float inv_step = 1.f / step;
  uint32_t res[2][kBN / 8][2];
  uint32_t redo = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 4 * j + 2 * h;
        bool again = false;
        const float v0 = swiglu_quant_fast(acc[i][e], acc[i][e + kUp],
                                           max_val, step, inv_step, again);
        const float v1 = swiglu_quant_fast(acc[i][e + 1],
                                           acc[i][e + 1 + kUp], max_val,
                                           step, inv_step, again);
        res[i][j][h] = hopper::pack_bf16x2(v0, v1);
        redo |= static_cast<uint32_t>(again) << ((i * kBN / 8 + j) * 2 + h);
      }
    }
  }
  if (redo != 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if ((redo >> ((i * kBN / 8 + j) * 2 + h)) & 1u) {
            const int e = 4 * j + 2 * h;
            res[i][j][h] = hopper::pack_bf16x2(
                swiglu_quant(acc[i][e], acc[i][e + kUp], max_val, step),
                swiglu_quant(acc[i][e + 1], acc[i][e + 1 + kUp], max_val,
                             step));
          }
        }
      }
    }
  }

  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int r0 = m0 + c * kRowsPerConsumer + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;   // even; N % 8 == 0, so col + 1 < N
    if (col >= n_dim) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 64 * i + 8 * h;
        if (r < m_dim) {
          *reinterpret_cast<uint32_t*>(
              out + static_cast<long long>(r) * n_dim + col) = res[i][j][h];
        }
      }
    }
  }
}

__global__ void quant_relu_bf16_kernel(const bf16* __restrict__ x,
                                       long long n, float max_val,
                                       float step, bf16* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long vecs = n / 8;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long v = first; v < vecs; v += stride) {
    uint4 w = xv[v];
    uint32_t* p = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<__nv_bfloat162*>(&p[q]));
      p[q] = hopper::pack_bf16x2(quant_relu(f.x, max_val, step),
                                 quant_relu(f.y, max_val, step));
    }
    ov[v] = w;
  }
  for (long long i = 8 * vecs + first; i < n; i += stride) {
    out[i] = __float2bfloat16_rn(
        quant_relu(__bfloat162float(x[i]), max_val, step));
  }
}

}  // namespace

extern "C" {

// bfloat16 only; 1 <= K, K % 8 == 0, N % 8 == 0, 16-byte aligned pointers
// (the wrapper checks).  All (256 x 64) tiles go on grid.x, up to
// 2^31 - 1 of them (the wrapper checks).
int masked_matmul_swiglu_quant_wgmma_forward(
    const void* x, const void* w_gate, const void* w_up, const void* mask,
    int m_dim, int n_dim, int k_dim, float max_val, float step, void* out,
    void* stream) {
  static int smem_done[hopper::kMaxDevices] = {};
  if (m_dim < 1 || n_dim < 1 || k_dim < 1 || n_dim % 8 || k_dim % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap, gmap, umap, mmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(k_dim),
                             static_cast<uint64_t>(m_dim)};
  const uint64_t xstrides[1] = {static_cast<uint64_t>(k_dim) * 2};
  const uint32_t xbox[2] = {kBK, kBM};
  const uint64_t wdims[2] = {static_cast<uint64_t>(n_dim),
                             static_cast<uint64_t>(k_dim)};
  const uint64_t wstrides[1] = {static_cast<uint64_t>(n_dim) * 2};
  const uint32_t wbox[2] = {kBN, kBK};
  cudaError_t err = hopper::make_map_bf16(&xmap, x, 2, xdims, xstrides, xbox);
  if (err == cudaSuccess) {
    err = hopper::make_map_bf16(&gmap, w_gate, 2, wdims, wstrides, wbox);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_bf16(&umap, w_up, 2, wdims, wstrides, wbox);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_bf16(&mmap, mask, 2, wdims, wstrides, wbox);
  }
  if (err == cudaSuccess) {
    err = hopper::allow_dynamic_smem(masked_matmul_swiglu_quant_wgmma_kernel,
                                     kSmemBytes, smem_done);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((m_dim + kBM - 1) / kBM) * ((n_dim + kBN - 1) / kBN));
  masked_matmul_swiglu_quant_wgmma_kernel<<<
      grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      xmap, gmap, umap, mmap, m_dim, n_dim, k_dim, max_val, step,
      static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// bfloat16, n >= 1 elements, 16-byte aligned pointers (the wrapper
// checks); at most 8 blocks an SM of the device's SMs, grid-stride.
int quant_relu_bf16_forward(const void* x, long long n, float max_val,
                            float step, void* out, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kBlock = 256;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n / 8 + kBlock - 1) / kBlock;
  const int blocks = static_cast<int>(
      want < 1 ? 1 : (want < 8LL * sms ? want : 8LL * sms));
  quant_relu_bf16_kernel<<<blocks, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), n, max_val, step, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
