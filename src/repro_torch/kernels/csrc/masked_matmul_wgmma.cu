// Fan-in-masked matrix product in bfloat16 on Hopper's tensor cores
// (sm_90a: TMA, mbarriers, wgmma), plain C interface.
//
//   masked_matmul_wgmma_forward  replaces src/repro/kernels/masked_matmul.py
//                                _kernel / masked_matmul_pallas for
//                                bfloat16 operands:
//                                out (M, N) = x (M, K) @ (w * mask) (K, N)
//                                             + b (N,)
//
// x, w, mask, b and out are bfloat16 and contiguous; K and N are multiples
// of 8 (TMA takes 16-byte global strides) and the pointers 16-byte aligned:
// the wrapper (kernels/masked_matmul.py) routes every other call to the
// SIMT kernel of masked_matmul.cu.  The product w * mask is rounded to
// bfloat16, as the Pallas kernel forms it in the operands' dtype (exact for
// a 0/1 mask); the accumulator is float32, the bias is added in float32 and
// out is rounded to bfloat16 once.  b may be null (zeros).
//
// What bounds it: at 4096^3 a call does 2 M nnz(mask) multiply-adds that
// count (a half mask: 69 GFLOP, 0.07 ms at 989 TFLOP/s) but the tensor
// cores do the dense 137 GFLOP, and it moves 134 MB (0.04 ms at
// 3.35 TB/s): bound by operations.  Shared-memory bandwidth comes next:
// the mask is applied on the tile in shared memory, which reads the w and
// mask tiles and writes w back once per K step, beside wgmma's own reads.
//
// Design.  One block owns a 256 x 128 output tile and walks K in 64-deep
// steps through a ring of 3 shared-memory stages (64 KB each: the x tile
// K-major, the w and mask tiles N-major, all 128-byte swizzled by TMA).
// The tile is tall because the mask doubles what the B side reads: 256
// rows halve the L2 traffic and the masking work per product against a
// 128 x 128 tile.  Blocks walk the tiles in groups of 8 row tiles, so one
// wave of blocks shares its x and w tiles in L2.  Warpgroup 0 is the
// producer: one thread waits for a stage to be empty, then issues its five
// TMA loads (x; w and mask as two 64-wide chunks each) against the stage's
// "full" barrier.  Warpgroups 1 and 2 are the consumers, each owning 128
// rows of the tile (two 64-row wgmma accumulators, 128 registers, taken
// from the producer by setmaxnreg).  When a stage is full, the 256
// consumer threads multiply its w tile by its mask tile in place (bfloat16
// x bfloat16, one rounding), fence the writes to the async proxy
// (fence.proxy.async: without it wgmma may read the unmasked weights) and
// meet at a named barrier; then each issues eight wgmma.m64n128k16 (B
// transposed: N-major) and, once the previous step's products have
// finished (wgmma.wait_group 1), hands that step's stage back to the
// producer.  The masking of one stage overlaps the products of the one
// before.  TMA zero-fills the ragged M, N and K edges, so no padding is
// ever read; the epilogue stores only rows < M and columns < N.
//
// The entry returns cudaGetLastError() after its launch (or the error of
// building a tensor map); it launches on the stream it is given, allocates
// nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 256;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kStages = 3;
constexpr int kConsumers = 2;
constexpr int kRowsPerConsumer = kBM / kConsumers;   // 128: two m64 tiles
constexpr int kGroupM = 8;                           // row tiles a group
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kXTile = kBM * kBK;                 // elements
constexpr int kWTile = kBK * kBN;                 // elements, 2 chunks
constexpr int kStageBytes = (kXTile + 2 * kWTile) * 2;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  __nv_bfloat162 r = __hmul2(x, y);
  return *reinterpret_cast<uint32_t*>(&r);
}

__global__ void __launch_bounds__(kThreads, 1)
masked_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const __grid_constant__ CUtensorMap mmap,
                           const bf16* __restrict__ b, int m_dim, int n_dim,
                           int k_dim, bf16* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* xs = reinterpret_cast<bf16*>(base);
  bf16* ws = xs + kStages * kXTile;
  bf16* ms = ws + kStages * kWTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(ms + kStages * kWTile);
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
#pragma unroll
        for (int c = 0; c < kBN / 64; ++c) {
          hopper::tma_load_2d(ws + s * kWTile + c * kBK * 64, &wmap, &full[s],
                              n0 + 64 * c, k0);
          hopper::tma_load_2d(ms + s * kWTile + c * kBK * 64, &mmap, &full[s],
                              n0 + 64 * c, k0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 128 c .. 128 c + 127 of the tile
  hopper::setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int ct = threadIdx.x - 128;   // 0 .. 255 over both consumers
  float acc[2][kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[0][i] = acc[1][i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    // w *= mask on this stage, in place, then hand it to the async proxy
    uint4* wv = reinterpret_cast<uint4*>(ws + s * kWTile);
    const uint4* mv = reinterpret_cast<const uint4*>(ms + s * kWTile);
#pragma unroll
    for (int i = ct; i < kWTile / 8; i += 128 * kConsumers) {
      uint4 w = wv[i];
      const uint4 m = mv[i];
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

  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int r0 = m0 + c * kRowsPerConsumer + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;   // even; N % 8 == 0, so col + 1 < N
    if (col >= n_dim) continue;
    float b0 = 0.f, b1 = 0.f;
    if (b != nullptr) {
      b0 = __bfloat162float(b[col]);
      b1 = __bfloat162float(b[col + 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 64 * i + 8 * h;
        if (r < m_dim) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<long long>(r) * n_dim + col) =
              __floats2bfloat162_rn(acc[i][4 * j + 2 * h] + b0,
                                    acc[i][4 * j + 2 * h + 1] + b1);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// bfloat16 only; 1 <= K, K % 8 == 0, N % 8 == 0, 16-byte aligned pointers
// (the wrapper checks).  All (256 x 128) tiles go on grid.x, up to
// 2^31 - 1 of them (the wrapper checks).
int masked_matmul_wgmma_forward(const void* x, const void* w, const void* mask,
                                const void* b, int m_dim, int n_dim,
                                int k_dim, void* out, void* stream) {
  static int smem_done[hopper::kMaxDevices] = {};
  if (m_dim < 1 || n_dim < 1 || k_dim < 1 || n_dim % 8 || k_dim % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap, wmap, mmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(k_dim),
                             static_cast<uint64_t>(m_dim)};
  const uint64_t xstrides[1] = {static_cast<uint64_t>(k_dim) * 2};
  const uint32_t xbox[2] = {kBK, kBM};
  const uint64_t wdims[2] = {static_cast<uint64_t>(n_dim),
                             static_cast<uint64_t>(k_dim)};
  const uint64_t wstrides[1] = {static_cast<uint64_t>(n_dim) * 2};
  const uint32_t wbox[2] = {64, kBK};
  cudaError_t err = hopper::make_map_bf16(&xmap, x, 2, xdims, xstrides, xbox);
  if (err == cudaSuccess) {
    err = hopper::make_map_bf16(&wmap, w, 2, wdims, wstrides, wbox);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_bf16(&mmap, mask, 2, wdims, wstrides, wbox);
  }
  if (err == cudaSuccess) {
    err = hopper::allow_dynamic_smem(masked_matmul_wgmma_kernel, kSmemBytes,
                                     smem_done);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((m_dim + kBM - 1) / kBM) * ((n_dim + kBN - 1) / kBN));
  masked_matmul_wgmma_kernel<<<grid, kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, mmap, static_cast<const bf16*>(b), m_dim, n_dim, k_dim,
      static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
