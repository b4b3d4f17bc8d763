// Float32 fan-in-masked matrix product on Hopper's CUDA cores (sm_90a),
// plain C interface.
//
//   masked_matmul_ffma_forward  replaces src/repro/kernels/masked_matmul.py
//                               _kernel / masked_matmul_pallas in float32:
//                               out (M, N) = x (M, K) @ (w * mask) (K, N) + b
//
// Arithmetic, the same as masked_matmul_forward's (masked_matmul.cu) bit for
// bit: w * mask is rounded to float32; each output has one float32
// accumulator, starting from 0, that takes k = 0 .. K - 1 in ascending order
// with fmaf; the bias (0 when b is null) is added after the chain.  That
// order keeps verify_tables exact (see masked_matmul.cu), so there is no
// split-K and no tensor core (not even 3xTF32): at 4096^3 the kernel is
// bound by the 67 TFLOP/s float32 FMA rate, and what this design changes is
// how the operands reach the FMAs.
//
// Design:
//   * Register tiles.  The large tile is 128 x 256 outputs a block, 256
//     threads of 8 x 16 accumulators laid out as 2 x 4 sub-tiles of 4 x 4,
//     64 rows / columns apart.  A warp covers 4 x 8 threads, so each k's
//     fragments are six 16-byte shared-memory reads (two of x, four of w)
//     without bank conflicts, feeding 128 FMAs.  One block an SM (206
//     registers a thread, no spills).  Of the tiles tools/ffma_tile_sweep.py
//     compares, it is the fastest at 4096^3 on an H100 80GB HBM3 at 700 W:
//     3.30 ms, against 3.98 ms for 128 x 128 tiles of 8 x 8 at 2 blocks an
//     SM (which spill under the 128-register cap) and 3.42 ms for 128 x 128
//     tiles of 8 x 16.
//   * Staging.  Each K tile (8 deep) is loaded with 16-byte global loads
//     (scalar ones where K or N is not a multiple of 4, or a pointer is not
//     16-byte aligned) into registers while the FMAs of the previous tile
//     run, then stored to the other of two shared-memory buffers: one
//     __syncthreads a tile.  x is stored k-major (xs[k][m], transposed on
//     the store), so a thread's x values of one k are one broadcast read;
//     the mask is multiplied into w on the store, once per element per
//     block.  Rows are padded by 4 floats and each warp's staging loads
//     cover 16 rows x 2 chunks of 4, so the transposing stores are free of
//     bank conflicts.
//   * Small shapes (fpga4hep model A: 256 x {16, 64} x 64, and the input
//     gradients).  The large tile gives 2 blocks; the small one, 32 x 32
//     outputs with 64 threads of 4 x 4 and a 64-deep K tile, gives 16, and
//     loads the whole K <= 64 panel in one round behind a single barrier.
//     The wrapper picks the tile (masked_matmul.py: masked_matmul_tile).
//   * Transposed operands.  With transposed != 0, w and mask are read as
//     (N, K) row-major and the product is x @ (w * mask)^T: the input
//     gradient dy @ (w * mask)^T of training needs no transposed copies.
//     Their tiles are staged like x's (rows along N, 16-byte loads along K)
//     and transposed on the store.
//   * Ragged M, N and K edges are zero-filled in shared memory, never read;
//     k beyond K inside the last tile adds fmaf(0, 0, acc) = acc (an
//     accumulator that starts at +0 never holds -0), and the small tile
//     skips such k in steps of 16.
//
// The entry returns cudaGetLastError() after its launch; it launches on the
// stream it is given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// BM x BN outputs a block, BK-deep K tiles, THM x THN threads each holding
// (BM / THM) x (BN / THN) outputs as 4 x 4 sub-tiles THM * 4 rows and
// THN * 4 columns apart.
template <int kBM, int kBN, int kBK, int kTHM, int kTHN, int kMinBlocks>
struct Tile {
  static constexpr int BM = kBM, BN = kBN, BK = kBK, THM = kTHM, THN = kTHN;
  static constexpr int kThreads = THM * THN;
  static constexpr int kBlocksPerSM = kMinBlocks;
  static constexpr int RM = BM / (THM * 4);   // sub-tiles a thread, rows
  static constexpr int RN = BN / (THN * 4);   // sub-tiles a thread, columns
  static constexpr int SM = BM + 4;           // shared row strides (floats):
  static constexpr int SN = BN + 4;           // 4 mod 32, 16-byte rows
  static constexpr int kXLoads = BM * BK / 4 / kThreads;   // float4 a thread
  static constexpr int kWLoads = BK * BN / 4 / kThreads;
  static constexpr int kStep = BK < 16 ? BK : 16;   // k unrolled at once
  static_assert(BM % 32 == 0 && BN % 32 == 0, "rows must keep SM = 4 mod 32");
  static_assert(BK % 8 == 0 && BK % kStep == 0, "staging takes chunk pairs");
  static_assert(THN % 8 == 0 && kThreads % 32 == 0, "warps are 4 x 8 threads");
  static_assert(RM * THM * 4 == BM && RN * THN * 4 == BN, "tile cover");
  static_assert(kXLoads * 4 * kThreads == BM * BK &&
                kWLoads * 4 * kThreads == BK * BN, "even staging");
};

using Large = Tile<128, 256, 8, 16, 16, 1>;    // 256 threads, 8 x 16 each
using Small = Tile<32, 32, 64, 8, 8, 1>;       // 64 threads, 4 x 4 each

// Elements [col, col + 4) of a row, zero past `cols` or when !row_ok.
__device__ __forceinline__ float4 load4(const float* __restrict__ row,
                                        bool row_ok, int col, int cols,
                                        bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!row_ok || col >= cols) return v;
  if (vec) return *reinterpret_cast<const float4*>(row + col);
  v.x = row[col];
  if (col + 1 < cols) v.y = row[col + 1];
  if (col + 2 < cols) v.z = row[col + 2];
  if (col + 3 < cols) v.w = row[col + 3];
  return v;
}

// Component i (a constant after unrolling) of v.
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Staging of a row panel: `rows` rows of a row-major matrix with `cols`
// columns, BK columns from k0.  Load i of thread t covers row r and chunk c
// (4 columns); a warp's 32 loads are 16 rows x 2 neighbouring chunks, so the
// global reads use whole 32-byte sectors and the transposing stores (row r
// to column r of rows 4c .. 4c + 3) hit 32 distinct banks.
template <int kRows>
__device__ __forceinline__ void panel_slot(int idx, int& r, int& c) {
  const int q = idx >> 1;
  r = q % kRows;
  c = 2 * (q / kRows) + (idx & 1);
}

template <class T, bool kTrans>
__global__ void __launch_bounds__(T::kThreads, T::kBlocksPerSM)
masked_matmul_ffma_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ mask,
                          const float* __restrict__ b, int m_dim, int n_dim,
                          int k_dim, int vec_x, int vec_w, int vec_out,
                          float* __restrict__ out) {
  __shared__ __align__(16) float xs[2][T::BK][T::SM];
  __shared__ __align__(16) float ws[2][T::BK][T::SN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp / (T::THN / 8)) * 4 + (lane >> 3);
  const int tx = (warp % (T::THN / 8)) * 8 + (lane & 7);
  // w (or its transpose) as rows of the staged panel: K rows of N columns,
  // or N rows of K columns
  const int w_cols = kTrans ? k_dim : n_dim;

  float4 xr[T::kXLoads], wr[T::kWLoads], mr[T::kWLoads];

  // global loads of the K tile at k0 into registers
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < T::kXLoads; ++i) {
      int r, c;
      panel_slot<T::BM>(tid + i * T::kThreads, r, c);
      const int gm = m0 + r;
      xr[i] = load4(x + static_cast<long long>(gm) * k_dim, gm < m_dim,
                    k0 + 4 * c, k_dim, vec_x);
    }
#pragma unroll
    for (int i = 0; i < T::kWLoads; ++i) {
      int r, c, row, col;
      if (kTrans) {
        panel_slot<T::BN>(tid + i * T::kThreads, r, c);
        row = n0 + r;
        col = k0 + 4 * c;
      } else {
        const int idx = tid + i * T::kThreads;
        row = k0 + idx / (T::BN / 4);
        col = n0 + 4 * (idx % (T::BN / 4));
      }
      const bool ok = row < (kTrans ? n_dim : k_dim);
      const long long off = static_cast<long long>(row) * w_cols;
      wr[i] = load4(w + off, ok, col, w_cols, vec_w);
      mr[i] = load4(mask + off, ok, col, w_cols, vec_w);
    }
  };

  // the registers into shared buffer `buf`: x transposed, w * mask
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < T::kXLoads; ++i) {
      int r, c;
      panel_slot<T::BM>(tid + i * T::kThreads, r, c);
      xs[buf][4 * c + 0][r] = xr[i].x;
      xs[buf][4 * c + 1][r] = xr[i].y;
      xs[buf][4 * c + 2][r] = xr[i].z;
      xs[buf][4 * c + 3][r] = xr[i].w;
    }
#pragma unroll
    for (int i = 0; i < T::kWLoads; ++i) {
      const float4 p = make_float4(wr[i].x * mr[i].x, wr[i].y * mr[i].y,
                                   wr[i].z * mr[i].z, wr[i].w * mr[i].w);
      if (kTrans) {
        int r, c;
        panel_slot<T::BN>(tid + i * T::kThreads, r, c);
        ws[buf][4 * c + 0][r] = p.x;
        ws[buf][4 * c + 1][r] = p.y;
        ws[buf][4 * c + 2][r] = p.z;
        ws[buf][4 * c + 3][r] = p.w;
      } else {
        const int idx = tid + i * T::kThreads;
        *reinterpret_cast<float4*>(
            &ws[buf][idx / (T::BN / 4)][4 * (idx % (T::BN / 4))]) = p;
      }
    }
  };

  float acc[T::RM * 4][T::RN * 4];
#pragma unroll
  for (int i = 0; i < T::RM * 4; ++i)
#pragma unroll
    for (int j = 0; j < T::RN * 4; ++j) acc[i][j] = 0.f;

  const int tiles = (k_dim + T::BK - 1) / T::BK;
  if (tiles > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < tiles;
    if (more) load((t + 1) * T::BK);   // in flight during the FMAs below
    const int kn = min(T::BK, k_dim - t * T::BK);
#pragma unroll
    for (int kq = 0; kq < T::BK; kq += T::kStep) {
      if (kq >= kn) break;   // only zeros past K: fmaf(0, 0, acc) == acc
#pragma unroll
      for (int kk = kq; kk < kq + T::kStep; ++kk) {
        float4 a[T::RM], bw[T::RN];
#pragma unroll
        for (int s = 0; s < T::RM; ++s)
          a[s] = *reinterpret_cast<const float4*>(
              &xs[cur][kk][ty * 4 + s * T::THM * 4]);
#pragma unroll
        for (int s = 0; s < T::RN; ++s)
          bw[s] = *reinterpret_cast<const float4*>(
              &ws[cur][kk][tx * 4 + s * T::THN * 4]);
#pragma unroll
        for (int i = 0; i < T::RM * 4; ++i)
#pragma unroll
          for (int j = 0; j < T::RN * 4; ++j)
            acc[i][j] = fmaf(at(a[i / 4], i % 4), at(bw[j / 4], j % 4),
                             acc[i][j]);
      }
    }
    if (more) {
      store(cur ^ 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int sn = 0; sn < T::RN; ++sn) {
    const int gn = n0 + tx * 4 + sn * T::THN * 4;
    if (gn >= n_dim) continue;
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bias[j] = (b != nullptr && gn + j < n_dim) ? b[gn + j] : 0.f;
#pragma unroll
    for (int sm = 0; sm < T::RM; ++sm) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gm = m0 + ty * 4 + sm * T::THM * 4 + i;
        if (gm >= m_dim) continue;
        const int row = sm * 4 + i, col = sn * 4;
        float* o = out + static_cast<long long>(gm) * n_dim + gn;
        if (vec_out) {
          *reinterpret_cast<float4*>(o) = make_float4(
              acc[row][col] + bias[0], acc[row][col + 1] + bias[1],
              acc[row][col + 2] + bias[2], acc[row][col + 3] + bias[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < n_dim) o[j] = acc[row][col + j] + bias[j];
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <class T>
void launch(const float* x, const float* w, const float* mask,
            const float* b, int m_dim, int n_dim, int k_dim, bool transposed,
            float* out, cudaStream_t stream) {
  const dim3 grid((m_dim + T::BM - 1) / T::BM, (n_dim + T::BN - 1) / T::BN);
  const int vec_x = k_dim % 4 == 0 && aligned16(x);
  const int vec_w = (transposed ? k_dim : n_dim) % 4 == 0 && aligned16(w) &&
                    aligned16(mask);
  const int vec_out = n_dim % 4 == 0 && aligned16(out);
  if (transposed) {
    masked_matmul_ffma_kernel<T, true><<<grid, T::kThreads, 0, stream>>>(
        x, w, mask, b, m_dim, n_dim, k_dim, vec_x, vec_w, vec_out, out);
  } else {
    masked_matmul_ffma_kernel<T, false><<<grid, T::kThreads, 0, stream>>>(
        x, w, mask, b, m_dim, n_dim, k_dim, vec_x, vec_w, vec_out, out);
  }
}

}  // namespace

extern "C" {

// transposed: 0 reads w and mask as (K, N), 1 as (N, K).  tile: 0 = 128 x
// 256 (256 threads), 1 = 32 x 32 (64 threads).  Rows go on grid.x (up to
// 2^31 - 1 tiles), columns on grid.y (up to 65535 tiles: the wrapper
// checks).
int masked_matmul_ffma_forward(const void* x, const void* w, const void* mask,
                               const void* b, int m_dim, int n_dim,
                               int k_dim, int transposed, int tile, void* out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* mf = static_cast<const float*>(mask);
  const auto* bf = static_cast<const float*>(b);
  auto* of = static_cast<float*>(out);
  if (tile == 0) {
    launch<Large>(xf, wf, mf, bf, m_dim, n_dim, k_dim, transposed != 0, of, s);
  } else if (tile == 1) {
    launch<Small>(xf, wf, mf, bf, m_dim, n_dim, k_dim, transposed != 0, of, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
