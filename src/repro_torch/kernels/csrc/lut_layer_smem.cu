// One LogicNets LUT layer for Hopper (sm_90a), launched as a programmatic
// dependent launch, plain C interface.
//
//   lut_layer_smem_forward  replaces src/repro/kernels/lut_lookup.py
//                           _kernel / lut_lookup_pallas: (B, I) int32 codes
//                           -> (B, O) int32 codes through (O, FI) fan-in
//                           indices and (O, E) int32 truth tables.
//
// It is the route "smem" (tables staged in shared memory) and the route
// "direct" (tables read in place) of kernels/lut_lookup.py, chosen there by
// lut_layer_route.
//
// What bounds it: bytes.  A launch must read its layer's (B, I) codes, its
// indices and its tables once and write its (B, O) codes once; per output
// it does a few integer operations.  At model A's widths that is 0.00004
// ms at batch 16 (the 128 KB of tables) and 0.0006 ms at batch 4096 (1.8
// MB of codes and tables), far below what one thread an output costs:
// three dependent round trips to L2 an output (index, code, table entry)
// and a plain launch that starts only once the previous layer's grid has
// drained.  So latency bounds the kernel, and
// the design removes round trips and overlaps what it can with the
// previous layer:
//
//   * Programmatic dependent launch.  The entry launches with
//     cudaLaunchKernelEx and programmatic stream serialization.  Before
//     griddepcontrol.wait a block touches only what no earlier kernel
//     writes: its neuron tile's indices and, route "smem", its tables (the
//     engine builds both once); and it lets its dependents launch
//     (griddepcontrol.launch_dependents) as soon as the wait is over.  So
//     the next layer's blocks load their indices and stage their tables
//     while this layer computes, and wait only for its codes.
//   * Codes through shared memory.  After the wait one thread copies the
//     block's batch tile of codes (rows [b0, b0 + tile_b), one contiguous
//     range) into shared memory with one 1-D bulk copy on an mbarrier: one
//     round trip to L2 however many rows, where a loop of loads by threads
//     costs one a load it cannot overlap.  Every fan-in code is read from
//     shared memory.  A block that walks several batch tiles keeps two
//     buffers and copies the next tile's codes while it computes this one.
//     The indices sit in shared memory with an index outside the bus, or
//     an element whose shift lies outside [0, 32), replaced by the sentinel
//     n_in (code 0), so no other bound is checked.
//   * Tables staged per neuron tile (route "smem").  A block owns a tile of
//     neurons, copies their table rows (one contiguous range) into shared
//     memory with one 1-D bulk copy before the wait, and walks batch tiles
//     with the grid's stride, so the rows it stages are read by every batch
//     row it serves, from shared memory: no global round trip is left
//     after the wait but the codes' copy.  Route "direct" reads each entry
//     in place (one more round trip; one or two outputs a thread) at large
//     batches, where every block group staging the layer's tables costs
//     more than it saves, or where one neuron's table alone passes the
//     budget.  A staged range's 16-byte aligned middle goes by bulk copy,
//     its ragged head and tail (under 16 bytes each) by threads.  The
//     wrapper keeps a block's shared memory within half of what an SM has,
//     so a layer's blocks and the next layer's fit on one SM together.
//   * A uint8 copy of tables whose entries all lie in [0, 256) (a quarter
//     of the bytes to stage) is the kernel's second instantiation; the
//     sweep measures it and no route takes it (PERF.md).
//
// Semantics kept from the Pallas kernel (its one-hot gathers), as in
// lut_kernels.cu: a fan-in index outside [0, n_in) reads code 0; an entry
// outside [0, n_entries) yields 0; shifts follow shl (a shift of 32 or
// more gives 0).
//
// The entry returns the launch's error, else cudaGetLastError(); it
// launches on the stream it is given, allocates nothing and does not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Shared memory of a block, in bytes from its start: three mbarriers (the
// tables', each codes buffer's) in 32 bytes, then (staged only) the neuron
// tile's table rows (elem bytes an entry), the tile's indices and n_buf
// buffers of a batch tile's codes; a staged range keeps 15 bytes of room to
// agree with its source modulo 16.  n_buf is 2 where a block walks more
// than one batch tile (the next tile's codes land while this one is
// computed), else 1.
// kernels/lut_lookup.py's layer_smem_bytes is the same sum.
struct Layout {
  int table, idx, codes, buf, bytes;
};

__host__ __device__ inline int round16(long long n) {
  return static_cast<int>((n + 15) & ~15LL);
}

__host__ __device__ inline Layout layout(int n_in, int fan_in,
                                         int n_entries, int elem, int tile_o,
                                         int tile_b, bool stage, int n_buf) {
  Layout l;
  l.table = 32;
  l.idx = l.table +
          (stage ? round16(1LL * elem * tile_o * n_entries + 15) : 0);
  l.codes = l.idx + round16(4LL * tile_o * fan_in);
  l.buf = round16(4LL * tile_b * n_in + 15);
  l.bytes = l.codes + n_buf * l.buf;
  return l;
}

// The 16-byte aligned middle [lo, hi) of `bytes` bytes at `src` (by bulk
// copy); the head [0, lo) and the tail [hi, bytes) are under 16 bytes each.
__device__ __forceinline__ void middle(const void* src, int bytes, int& lo,
                                       int& hi) {
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  lo = min(bytes, (16 - shift) & 15);
  hi = max(lo, ((shift + bytes) & ~15) - shift);
}

// One thread: the middle of `bytes` bytes from `src` to `dst` (which agree
// modulo 16) on `bar`, whose phase completes when they have landed.
__device__ __forceinline__ void issue_copy(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes, uint64_t* bar) {
  int lo, hi;
  middle(src, bytes, lo, hi);
  hopper::mbar_arrive_expect_tx(bar, hi - lo);
  if (hi > lo) hopper::bulk_load_1d(dst + lo, src + lo, hi - lo, bar);
}

// All threads: the head and tail of the same copy, a byte a thread,
// through L2 only (codes were written by the previous grid).
__device__ __forceinline__ void copy_edges(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes) {
  int lo, hi;
  middle(src, bytes, lo, hi);
  for (int p = threadIdx.x; p < 32; p += blockDim.x) {
    const int pos = p < 16 ? p : hi + p - 16;
    if (pos < (p < 16 ? lo : bytes)) dst[pos] = __ldcg(src + pos);
  }
}

__device__ __forceinline__ unsigned char* aligned_like(unsigned char* region,
                                                       const void* src) {
  return region + (reinterpret_cast<uintptr_t>(src) & 15);
}

// T: the table's entry type, int (as stored) or unsigned char (a copy of
// tables whose entries all lie in [0, 256), widened as unsigned).
template <bool kStage, typename T>
__global__ void __launch_bounds__(kMaxThreads)
layer_smem_kernel(const int* __restrict__ codes, int batch, int n_in,
                  const int* __restrict__ idx, int n_out, int fan_in,
                  const T* __restrict__ table, int n_entries, int bw_in,
                  int* __restrict__ out, int tile_o, int tile_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (batch + tile_b - 1) / tile_b;
  const int n_buf = n_tiles > static_cast<int>(gridDim.y) ? 2 : 1;
  const Layout lay =
      layout(n_in, fan_in, n_entries, static_cast<int>(sizeof(T)), tile_o,
             tile_b, kStage, n_buf);
  uint64_t* bar_tab = reinterpret_cast<uint64_t*>(smem);
  uint64_t* bar_codes = bar_tab + 1;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int o0 = blockIdx.x * tile_o;
  const int to = min(tile_o, n_out - o0);

  // -- before the wait: only the indices and tables, which no kernel of
  // this chain writes
  const unsigned char* tsrc = reinterpret_cast<const unsigned char*>(
      table + static_cast<long long>(o0) * n_entries);
  unsigned char* tdst = aligned_like(smem + lay.table, tsrc);
  const int tab_bytes = static_cast<int>(sizeof(T)) * to * n_entries;
  if (tid == 0) {
    hopper::mbar_init(bar_tab, 1);
    hopper::mbar_init(bar_codes, 1);
    hopper::mbar_init(bar_codes + 1, 1);
    hopper::fence_mbar_init();
    if (kStage) issue_copy(tdst, tsrc, tab_bytes, bar_tab);
  }
  if (kStage) copy_edges(tdst, tsrc, tab_bytes);
  const T* tab = reinterpret_cast<const T*>(tdst);
  int* sidx = reinterpret_cast<int*>(smem + lay.idx);
  const int* isrc = idx + static_cast<long long>(o0) * fan_in;
  for (int p = tid; p < to * fan_in; p += threads) {
    const int src = __ldg(isrc + p);
    const bool ok = static_cast<unsigned>(src) < static_cast<unsigned>(n_in) &&
                    static_cast<unsigned>(bw_in * (p % fan_in)) < 32u;
    sidx[p] = ok ? src : n_in;
  }

  // The previous layer's grid has completed and its writes are visible
  // after this wait.  No global write and no read of codes comes before
  // it: this layer's codes are what that grid writes, and the caching
  // allocator may have given this layer's output buffer the memory of a
  // tensor that grid is still reading.
  wait_for_prerequisites();
  // Dependents launch from here, so at most this layer and the next are
  // resident: a trigger at the start would let every queued layer launch
  // and stage its tables while this one works.
  launch_dependents();

  auto tile_src = [&](int t) {
    return reinterpret_cast<const unsigned char*>(
        codes + static_cast<long long>(t) * tile_b * n_in);
  };
  auto tile_bytes = [&](int t) {
    return 4 * min(tile_b, batch - t * tile_b) * n_in;
  };
  if (tid == 0 && static_cast<int>(blockIdx.y) < n_tiles) {
    const int t = blockIdx.y;
    issue_copy(aligned_like(smem + lay.codes, tile_src(t)), tile_src(t),
               tile_bytes(t), bar_codes);
  }
  // (r, o) walks p = tid + i * threads as r = p / to, o = p % to
  const int step_r = threads / to, step_o = threads - step_r * to;
  int i = 0;
  for (int t = blockIdx.y; t < n_tiles; t += gridDim.y, ++i) {
    const int b = i & 1;
    const int next = t + gridDim.y;
    if (tid == 0 && next < n_tiles) {
      // the other buffer was last read before the barrier that closed
      // the previous tile
      issue_copy(aligned_like(smem + lay.codes + (b ^ 1) * lay.buf,
                              tile_src(next)),
                 tile_src(next), tile_bytes(next), bar_codes + (b ^ 1));
    }
    const unsigned char* src = tile_src(t);
    unsigned char* buf = aligned_like(smem + lay.codes + b * lay.buf, src);
    copy_edges(buf, src, tile_bytes(t));
    // publishes the edges and the mbarriers' init
    __syncthreads();
    hopper::mbar_wait(bar_codes + b, (i >> 1) & 1);
    if (kStage) hopper::mbar_wait(bar_tab, 0);
    const int* h = reinterpret_cast<const int*>(buf);
    const int b0 = t * tile_b;
    const int rows = min(tile_b, batch - b0);
    int* dst = out + static_cast<long long>(b0) * n_out + o0;
    int r = tid / to, o = tid - r * to;
    while (r < rows) {
      const int* hr = h + r * n_in;
      const int* ir = sidx + o * fan_in;
      unsigned entry = 0;
      for (int k = 0; k < fan_in; ++k) {
        const int s = ir[k];
        const unsigned code = s < n_in ? static_cast<unsigned>(hr[s]) : 0u;
        entry += code << ((bw_in * k) & 31);
      }
      int v = 0;
      if (entry < static_cast<unsigned>(n_entries)) {
        v = static_cast<int>(
            kStage ? tab[o * n_entries + static_cast<int>(entry)]
                   : __ldg(table + static_cast<long long>(o0 + o) * n_entries +
                           entry));
      }
      dst[static_cast<long long>(r) * n_out + o] = v;
      r += step_r;
      o += step_o;
      if (o >= to) {
        o -= to;
        ++r;
      }
    }
    // the next tile but one reuses this buffer
    __syncthreads();
  }
  // a block with no batch tile exits only after its table copy has landed
  if (kStage && tid == 0) hopper::mbar_wait(bar_tab, 0);
}

template <bool kStage, typename T>
int launch(const void* codes, int batch, int n_in, const void* idx,
           int n_out, int fan_in, const void* table, int n_entries,
           int bw_in, void* out, int tile_o, int tile_b, int grid_b,
           int threads, int smem, cudaStream_t stream) {
  auto* kernel = layer_smem_kernel<kStage, T>;
  static int allowed[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::allow_dynamic_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_out + tile_o - 1) / tile_o, grid_b);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int*>(codes), batch, n_in,
      static_cast<const int*>(idx), n_out, fan_in,
      static_cast<const T*>(table), n_entries, bw_in,
      static_cast<int*>(out), tile_o, tile_b);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The dynamic shared memory a block takes at n_buf codes buffers (the
// wrapper's budget check reads the same sum from kernels/lut_lookup.py; a
// card test holds the two equal).
int lut_layer_smem_bytes(int n_in, int fan_in, int n_entries, int elem,
                         int tile_o, int tile_b, int stage, int n_buf) {
  return layout(n_in, fan_in, n_entries, elem, tile_o, tile_b, stage != 0,
                n_buf)
      .bytes;
}

// packed = 1: the table is uint8 (entries in [0, 256)), else int32.
// stage = 1: route "smem", 0: route "direct".  The grid is
// (ceil(n_out / tile_o), grid_b); block (x, y) serves neurons
// [x tile_o, (x + 1) tile_o) and batch tiles y, y + grid_b, ... of tile_b
// rows.  It launches with programmatic stream serialization and lets its
// dependents launch once its wait is over.
int lut_layer_smem_forward(const void* codes, int batch, int n_in,
                           const void* idx, int n_out, int fan_in,
                           const void* table, int n_entries, int packed,
                           int bw_in, void* out, int stage, int tile_o,
                           int tile_b, int grid_b, int threads,
                           void* stream) {
  if (batch < 1 || n_out < 1 || n_in < 0 || fan_in < 0 || n_entries < 0 ||
      tile_o < 1 || tile_b < 1 || grid_b < 1 || grid_b > 65535 ||
      threads < 32 || threads > kMaxThreads || threads % 32 ||
      tile_o > threads) {
    return cudaErrorInvalidValue;
  }
  const int n_tiles = (batch + tile_b - 1) / tile_b;
  if (grid_b > n_tiles) return cudaErrorInvalidValue;
  const int smem = layout(n_in, fan_in, n_entries, packed ? 1 : 4, tile_o,
                          tile_b, stage != 0, n_tiles > grid_b ? 2 : 1)
                       .bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage && packed) {
    return launch<true, unsigned char>(codes, batch, n_in, idx, n_out, fan_in,
                                       table, n_entries, bw_in, out, tile_o,
                                       tile_b, grid_b, threads, smem, s);
  }
  if (stage) {
    return launch<true, int>(codes, batch, n_in, idx, n_out, fan_in, table,
                             n_entries, bw_in, out, tile_o, tile_b, grid_b,
                             threads, smem, s);
  }
  if (packed) {
    return launch<false, unsigned char>(codes, batch, n_in, idx, n_out,
                                        fan_in, table, n_entries, bw_in, out,
                                        tile_o, tile_b, grid_b, threads, smem,
                                        s);
  }
  return launch<false, int>(codes, batch, n_in, idx, n_out, fan_in, table,
                            n_entries, bw_in, out, tile_o, tile_b, grid_b,
                            threads, smem, s);
}

}  // extern "C"
