// LogicNets fused LUT-network kernels for Hopper (sm_90a) with the whole
// network's read-only state in shared memory, plain C interface.
//
//   lut_mixed_smem_forward    replaces src/repro/kernels/lut_network.py
//                             _mixed_kernel / lut_network_mixed_pallas
//                             (mixed-width slabs: per-element shifts and
//                             widths, a flat table slab with per-neuron
//                             offsets, final out_perm).
//   lut_uniform_smem_forward  replaces src/repro/kernels/lut_network.py
//                             _kernel / lut_network_pallas (row-stacked
//                             uniform slabs).
//
// Both are the route "smem" of kernels/lut_network.py; the first design
// (lut_kernels.cu, route "global") keeps the slabs no layout fits.
//
// What bounds them: per output code a few integer operations and one
// table read whose address depends on the data; the bytes a forward must
// move (codes in and out, the slabs once) are a fraction of a microsecond
// at model A's widths.  The first design read every slab word from global
// memory, and each layer's reads formed a dependent chain (layer_meta,
// then idx, then the activation, then row_meta and the table: about three
// round trips to L2 a layer), in 128 blocks at batch 4096.  So latency
// bounds them, and the design removes the global round trips:
//
//   * Staging.  Each block copies the network's read-only state into
//     shared memory once: the table slab as stored (int8 stays int8), one
//     packed word per (neuron, element) (fan-in index, shift and width:
//     the wrapper derives it once per slabs object), the mixed layout's
//     (offset, entries) per neuron, a per-layer table (row0, n_out,
//     fan_in, entries, stage) and out_perm.  One thread issues 1-D bulk
//     copies (cp.async.bulk ... mbarrier::complete_tx) stage by stage, one
//     mbarrier a stage, a stage being a group of consecutive layers (one
//     layer a stage up to kMaxStages layers), so layer 0 starts once its
//     own bytes have landed.  A source may sit at any byte offset: each
//     array's region in shared memory is shifted to agree with its source
//     modulo 16, its 16-byte aligned middle goes by bulk copy and the
//     ragged head and tail (under 16 bytes each) by threads.  A
//     deduplicated mixed slab can point a neuron at an earlier layer's
//     table rows: stage s copies the table bytes up to the furthest any
//     layer of stages 0..s reads, so a layer waits on its own stage only
//     (the wrapper's layout computes that schedule and checks it).  The
//     batch tile's codes are loaded while the copies are in flight.
//   * No global memory between layers.  An output code costs one packed
//     word, fan_in activation reads and one table read, all in shared
//     memory.  A fan-in index outside the layer's bus was mapped by the
//     wrapper to a column that stays 0, so no bound is checked here.
//   * Persistent blocks: min(tiles, SMs x resident blocks) blocks, each
//     staging once and walking batch tiles with the grid's stride; two
//     ping-pong activation buffers and a barrier between layers, as in
//     the first design.  Threads walk (row, neuron) without a division
//     per output.
//
// Semantics kept from the Pallas kernels (their one-hot gathers), as in
// lut_kernels.cu: a fan-in index outside the layer's input bus reads code
// 0; a table entry outside [0, n_entries) of its neuron yields 0; int8
// tables hold unsigned bytes and are widened as such; a shift of 32 or
// more, or negative, gives 0, and a width outside [0, 32) keeps every bit.
// The packed word encodes the last two: shift s' in bits 16-20 and width
// w' in bits 24-29 (w' = 32 keeps every bit, w' = 0 none, which is also
// how a shift outside [0, 32) is encoded).
//
// Each entry returns cudaGetLastError() after its launch; it launches on
// the stream it is given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kArrays = 5;
constexpr int kMaxStages = 8;
constexpr int kLayerCols = 5;      // row0, n_out, fan_in, n_entries, stage
constexpr int kPlanHead = 14;      // ints of the host plan before its stages
enum { kElems = 0, kRows = 1, kTable = 2, kLayers = 3, kPerm = 4 };

// The layout the wrapper computed (kernels/lut_network.py,
// fused_smem_layout): byte offsets of each array's region in shared
// memory, and for each stage the byte range [begin, end) of each array
// that the stage copies.
struct Plan {
  const unsigned char* src[kArrays];
  int dst[kArrays];
  int begin[kMaxStages][kArrays];
  int end[kMaxStages][kArrays];
  int n_layers, n_stages, fi_max, e_max, ld, tile_b, act_off, n_out;
};

// x & low_mask(n) for n in [0, 32]
__device__ __forceinline__ unsigned low_bits(unsigned x, unsigned n) {
  unsigned d;
  asm("bfe.u32 %0, %1, 0, %2;" : "=r"(d) : "r"(x), "r"(n));
  return d;
}

// Array a in shared memory: its region, shifted by its source's offset
// within 16 bytes so that the two agree modulo 16.
__device__ __forceinline__ unsigned char* staged(unsigned char* smem,
                                                 const Plan& p, int a) {
  return smem + p.dst[a] + (reinterpret_cast<uintptr_t>(p.src[a]) & 15);
}

// The 16-byte aligned middle [lo, hi) of bytes [b, e) of array a (lo == hi
// when it has none); the head [b, lo) and the tail [hi, e) are each under
// 16 bytes.
__device__ __forceinline__ void middle(const Plan& p, int a, int b, int e,
                                       int& lo, int& hi) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(p.src[a]);
  const int up = static_cast<int>(((s + b + 15) & ~uintptr_t(15)) - s);
  const int down = static_cast<int>(((s + e) & ~uintptr_t(15)) - s);
  lo = min(e, up);
  hi = max(lo, down);
}

// One thread: the stages' barriers, then each stage's middles by bulk copy
// on its barrier.
__device__ void issue_bulk(unsigned char* smem, uint64_t* bars,
                           const Plan& p) {
  for (int s = 0; s < p.n_stages; ++s) hopper::mbar_init(bars + s, 1);
  hopper::fence_mbar_init();
  for (int s = 0; s < p.n_stages; ++s) {
    int lo[kArrays], hi[kArrays];
    uint32_t bytes = 0;
#pragma unroll
    for (int a = 0; a < kArrays; ++a) {
      middle(p, a, p.begin[s][a], p.end[s][a], lo[a], hi[a]);
      bytes += hi[a] - lo[a];
    }
    hopper::mbar_arrive_expect_tx(bars + s, bytes);
#pragma unroll
    for (int a = 0; a < kArrays; ++a) {
      if (hi[a] > lo[a]) {
        hopper::bulk_load_1d(staged(smem, p, a) + lo[a], p.src[a] + lo[a],
                             hi[a] - lo[a], bars + s);
      }
    }
  }
}

// All threads: every stage's middles as 16-byte loads (the variant with
// one __syncthreads in place of the stages' barriers).
__device__ void copy_middles(unsigned char* smem, const Plan& p) {
  for (int s = 0; s < p.n_stages; ++s) {
    for (int a = 0; a < kArrays; ++a) {
      int lo, hi;
      middle(p, a, p.begin[s][a], p.end[s][a], lo, hi);
      const uint4* src = reinterpret_cast<const uint4*>(p.src[a] + lo);
      uint4* dst = reinterpret_cast<uint4*>(staged(smem, p, a) + lo);
      for (int i = threadIdx.x; i < (hi - lo) / 16; i += blockDim.x) {
        dst[i] = __ldg(src + i);
      }
    }
  }
}

// All threads: the heads and tails.  Slot (stage, array) has 32 threads'
// worth of bytes: j < 16 is its head's j-th byte, 16 <= j its tail's.
__device__ void copy_edges(unsigned char* smem, const Plan& p) {
  for (int i = threadIdx.x; i < p.n_stages * kArrays * 32; i += blockDim.x) {
    const int slot = i >> 5, j = i & 31;
    const int s = slot / kArrays, a = slot - s * kArrays;
    const int b = p.begin[s][a], e = p.end[s][a];
    int lo, hi;
    middle(p, a, b, e, lo, hi);
    const int pos = j < 16 ? b + j : hi + j - 16;
    if (pos < (j < 16 ? lo : e)) {
      staged(smem, p, a)[pos] = __ldg(p.src[a] + pos);
    }
  }
}

template <bool kMixed, bool kPacked, bool kBulk>
__global__ void __launch_bounds__(kMaxThreads)
fused_smem_kernel(const int* __restrict__ codes, int batch, int n_in,
                  int tile_rows, int* __restrict__ out,
                  const __grid_constant__ Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  if (kBulk) {
    if (threadIdx.x == 0) issue_bulk(smem, bars, p);
  } else {
    copy_middles(smem, p);
  }
  copy_edges(smem, p);
  const unsigned* elems =
      reinterpret_cast<const unsigned*>(staged(smem, p, kElems));
  const int* row_meta = reinterpret_cast<const int*>(staged(smem, p, kRows));
  const unsigned char* table = staged(smem, p, kTable);
  const int* layers = reinterpret_cast<const int*>(staged(smem, p, kLayers));
  const int* perm = reinterpret_cast<const int*>(staged(smem, p, kPerm));
  const int ld = p.ld, fi_max = p.fi_max, n_out = p.n_out;
  const int threads = blockDim.x;
  int* h = reinterpret_cast<int*>(smem + p.act_off);
  int* g = h + p.tile_b * ld;
  // column ld - 1 of both buffers stays 0: out-of-bus fan-in indices
  for (int r = threadIdx.x; r < p.tile_b; r += threads) {
    h[r * ld + ld - 1] = 0;
    g[r * ld + ld - 1] = 0;
  }
  const int n_tiles = (batch + tile_rows - 1) / tile_rows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b0 = tile * tile_rows;
    const int rows = min(tile_rows, batch - b0);
    const int* src = codes + static_cast<long long>(b0) * n_in;
    for (int i = threadIdx.x; i < rows * n_in; i += threads) {
      const int r = i / n_in;
      h[r * ld + i - r * n_in] = __ldg(src + i);
    }
    // publishes the codes, the edges and (first tile) the barriers' init
    __syncthreads();
    if (kBulk) hopper::mbar_wait(bars, 0);        // stage 0: the layer table
    for (int l = 0; l < p.n_layers; ++l) {
      const int* lt = layers + kLayerCols * l;
      const int row0 = lt[0], lo = lt[1], fi = lt[2];
      const unsigned n_e_layer = static_cast<unsigned>(lt[3]);
      if (kBulk) hopper::mbar_wait(bars + lt[4], 0);
      if (lo > 0) {
        // (r, o) walks p = threadIdx.x + i * threads as r = p / lo,
        // o = p % lo, with one division a layer
        const int step_r = threads / lo, step_o = threads - step_r * lo;
        int r = threadIdx.x / lo, o = threadIdx.x - r * lo;
        while (r < rows) {
          const int row = row0 + o;
          const unsigned* ew = elems + row * fi_max;
          const int* hr = h + r * ld;
          unsigned entry = 0;
          for (int k = 0; k < fi; ++k) {
            const unsigned w = ew[k];
            const unsigned code = static_cast<unsigned>(hr[w & 0xFFFFu]);
            entry += low_bits(code, w >> 24) << ((w >> 16) & 31u);
          }
          int off, n_e;
          if (kMixed) {
            off = row_meta[2 * row];
            n_e = row_meta[2 * row + 1];
          } else {
            off = row * p.e_max;
            n_e = static_cast<int>(n_e_layer);
          }
          int v = 0;
          if (entry < static_cast<unsigned>(n_e)) {
            const int pos = off + static_cast<int>(entry);
            v = kPacked ? static_cast<int>(table[pos])
                        : reinterpret_cast<const int*>(table)[pos];
          }
          g[r * ld + o] = v;
          r += step_r;
          o += step_o;
          if (o >= lo) {
            o -= lo;
            ++r;
          }
        }
      }
      __syncthreads();
      int* t = h;
      h = g;
      g = t;
    }
    int* dst = out + static_cast<long long>(b0) * n_out;
    for (int i = threadIdx.x; i < rows * n_out; i += threads) {
      const int r = i / n_out;
      dst[i] = h[r * ld + perm[i - r * n_out]];
    }
    // the next tile's codes go to the buffer this store does not read
    int* t = h;
    h = g;
    g = t;
  }
}

int sm_count(int dev) {
  static int cached[hopper::kMaxDevices] = {};
  if (dev < 0 || dev >= hopper::kMaxDevices) return 0;
  if (!cached[dev]) {
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  }
  return cached[dev];
}

cudaError_t make_plan(const int* plan, const void* const* src, Plan* p) {
  *p = Plan{};
  p->n_layers = plan[0];
  p->n_stages = plan[1];
  p->fi_max = plan[2];
  p->e_max = plan[3];
  p->ld = plan[4];
  p->tile_b = plan[5];
  p->act_off = plan[6];
  p->n_out = plan[8];
  if (p->n_stages < 1 || p->n_stages > kMaxStages) {
    return cudaErrorInvalidValue;
  }
  for (int a = 0; a < kArrays; ++a) {
    p->src[a] = static_cast<const unsigned char*>(src[a]);
    p->dst[a] = plan[9 + a];
  }
  for (int s = 0; s < p->n_stages; ++s) {
    for (int a = 0; a < kArrays; ++a) {
      p->begin[s][a] = plan[kPlanHead + 2 * (kArrays * s + a)];
      p->end[s][a] = plan[kPlanHead + 2 * (kArrays * s + a) + 1];
    }
  }
  return cudaSuccess;
}

// Launch on min(tiles, SMs x resident blocks) blocks; the dynamic
// shared-memory limit is raised once per device and the occupancy of the
// last (threads, bytes) asked is kept per device.
template <bool kMixed, bool kPacked, bool kBulk>
int launch(const Plan& p, int smem_bytes, const void* codes, int batch,
           int n_in, int threads, int tile_rows, void* out,
           cudaStream_t stream) {
  auto* kernel = fused_smem_kernel<kMixed, kPacked, kBulk>;
  static int allowed[hopper::kMaxDevices] = {};
  static int occ_key[hopper::kMaxDevices][2] = {};
  static int occ_blocks[hopper::kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = hopper::allow_dynamic_smem(kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  const bool cached = dev < hopper::kMaxDevices &&
                      occ_key[dev][0] == threads &&
                      occ_key[dev][1] == smem_bytes;
  if (cached) {
    blocks = occ_blocks[dev];
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem_bytes);
    if (err != cudaSuccess) return err;
    if (dev < hopper::kMaxDevices) {
      occ_key[dev][0] = threads;
      occ_key[dev][1] = smem_bytes;
      occ_blocks[dev] = blocks;
    }
  }
  const int n_tiles = (batch + tile_rows - 1) / tile_rows;
  const int grid = max(1, min(n_tiles, sm_count(dev) * blocks));
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const int*>(codes), batch, n_in, tile_rows,
      static_cast<int*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMixed>
int dispatch(const int* plan, const void* const* src, int packed, int bulk,
             const void* codes, int batch, int n_in, int threads,
             int tile_rows, void* out, void* stream) {
  Plan p;
  cudaError_t err = make_plan(plan, src, &p);
  if (err != cudaSuccess) return err;
  if (threads < 1 || threads > kMaxThreads || tile_rows < 1 ||
      tile_rows > p.tile_b) {
    return cudaErrorInvalidValue;
  }
  const int smem = plan[7];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed) {
    return bulk ? launch<kMixed, true, true>(p, smem, codes, batch, n_in,
                                             threads, tile_rows, out, s)
                : launch<kMixed, true, false>(p, smem, codes, batch, n_in,
                                              threads, tile_rows, out, s);
  }
  return bulk ? launch<kMixed, false, true>(p, smem, codes, batch, n_in,
                                            threads, tile_rows, out, s)
              : launch<kMixed, false, false>(p, smem, codes, batch, n_in,
                                             threads, tile_rows, out, s);
}

}  // namespace

extern "C" {

// plan: the host int32 array of kernels/lut_network.py's SmemLayout.plan
// (n_layers, n_stages, fi_max, e_max, ld, tile_b, act_off, smem bytes,
// n_out, the five regions' offsets, then per stage and array its byte
// range).  bulk = 0 stages by 16-byte loads of all threads behind one
// __syncthreads (the variant the bulk copy is timed against).
int lut_mixed_smem_forward(const void* codes, int batch, int n_in,
                           const void* elems, const void* row_meta,
                           const void* table, int packed, const void* layers,
                           const void* perm, const void* plan, int threads,
                           int tile_rows, int bulk, void* out, void* stream) {
  const void* src[kArrays] = {elems, row_meta, table, layers, perm};
  return dispatch<true>(static_cast<const int*>(plan), src, packed, bulk,
                        codes, batch, n_in, threads, tile_rows, out, stream);
}

int lut_uniform_smem_forward(const void* codes, int batch, int n_in,
                             const void* elems, const void* table, int packed,
                             const void* layers, const void* perm,
                             const void* plan, int threads, int tile_rows,
                             int bulk, void* out, void* stream) {
  const void* src[kArrays] = {elems, nullptr, table, layers, perm};
  return dispatch<false>(static_cast<const int*>(plan), src, packed, bulk,
                         codes, batch, n_in, threads, tile_rows, out, stream);
}

}  // extern "C"
