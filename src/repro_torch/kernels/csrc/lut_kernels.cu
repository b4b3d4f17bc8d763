// LogicNets LUT inference kernels for Hopper (sm_90a), plain C interface.
//
// Three kernels, one per layout of a compiled LUT network.  The two fused
// ones are the first design, now the route "global" of
// kernels/lut_network.py: they serve only slabs whose shared-memory layout
// does not fit a block; every other call takes lut_fused_smem.cu (route
// "smem", the slabs staged in shared memory).
//
//   lut_mixed_forward    replaces src/repro/kernels/lut_network.py
//                        _mixed_kernel / lut_network_mixed_pallas: the fused
//                        whole network over compiler-exact mixed-width slabs
//                        (per-element shifts and widths, flat table slab with
//                        per-neuron offsets, final out_perm).
//   lut_uniform_forward  replaces src/repro/kernels/lut_network.py
//                        _kernel / lut_network_pallas: the fused whole
//                        network over row-stacked uniform slabs.
//   lut_layer_forward    replaces src/repro/kernels/lut_lookup.py
//                        _kernel / lut_lookup_pallas: one LUT layer.
//
// What bounds them: every output code costs a few integer ops and one
// table read whose address depends on the data.  The least work is the
// bytes of codes in, codes out and the slabs once, which at model A's
// widths (43 KB mixed slabs, 64 outputs a row) is far below what launch
// and latency cost, so these kernels are latency-bound.  The TPU kernels
// expressed both gathers as one-hot matmuls because a TPU has no fast lane
// gather; here a thread simply indexes.  Design: the fused kernels keep
// one batch tile's activations in shared memory for the whole network
// (two buffers, ping-pong, a barrier between layers), so no activation
// leaves the SM between layers, as on the FPGA and in the Pallas kernels.
// Slabs are read from global memory through the read-only path (staged
// in shared memory by lut_fused_smem.cu).
//
// Semantics kept from the Pallas kernels (their one-hot gathers):
//   * a fan-in index outside the layer's input bus reads code 0;
//   * a table entry outside [0, n_entries) of its neuron yields 0;
//   * int8-packed tables hold unsigned bytes and are widened as such;
//   * shifts and masks follow XLA: a shift of 32 or more, or negative,
//     gives 0.
// Each entry returns cudaGetLastError() after its launch; it launches on
// the stream it is given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kFusedThreads = 256;
constexpr int kLayerTileO = 32;
constexpr int kLayerTileB = 8;

__device__ __forceinline__ unsigned shl(unsigned x, int s) {
  return static_cast<unsigned>(s) < 32u ? x << s : 0u;
}

__device__ __forceinline__ unsigned low_mask(int w) {
  return static_cast<unsigned>(w) < 32u ? (1u << w) - 1u : 0xFFFFFFFFu;
}

__device__ __forceinline__ int read_table(const void* table, int packed,
                                          long long pos) {
  if (packed) {
    return static_cast<int>(
        __ldg(static_cast<const unsigned char*>(table) + pos));
  }
  return __ldg(static_cast<const int*>(table) + pos);
}

// Loads rows [b0, b0 + rows) of codes into the tile h (row stride ld).
__device__ __forceinline__ void load_tile(const int* __restrict__ codes,
                                          int b0, int rows, int n_in,
                                          int* h, int ld) {
  for (int p = threadIdx.x; p < rows * n_in; p += blockDim.x) {
    const int r = p / n_in;
    const int c = p - r * n_in;
    h[r * ld + c] = codes[static_cast<long long>(b0 + r) * n_in + c];
  }
}

__device__ __forceinline__ void store_tile(const int* h, int ld, int rows,
                                           const int* __restrict__ out_perm,
                                           int n_out, int b0,
                                           int* __restrict__ out) {
  for (int p = threadIdx.x; p < rows * n_out; p += blockDim.x) {
    const int r = p / n_out;
    const int j = p - r * n_out;
    out[static_cast<long long>(b0 + r) * n_out + j] =
        h[r * ld + __ldg(out_perm + j)];
  }
}

// layer_meta: (n_layers, 3) = row0, n_out, fan_in
// row_meta:   (sum O, 2)    = flat table offset, n_entries of that neuron
__global__ void __launch_bounds__(kFusedThreads)
mixed_kernel(const int* __restrict__ codes, int batch, int n_in,
             const int* __restrict__ idx, const int* __restrict__ shift,
             const int* __restrict__ width, int fi_max,
             const void* __restrict__ table, int packed,
             const int* __restrict__ row_meta,
             const int* __restrict__ layer_meta, int n_layers,
             const int* __restrict__ out_perm, int n_out, int tile_b,
             int ld, int* __restrict__ out) {
  extern __shared__ int smem[];
  int* h = smem;
  int* g = smem + tile_b * ld;
  const int b0 = blockIdx.x * tile_b;
  const int rows = min(tile_b, batch - b0);
  load_tile(codes, b0, rows, n_in, h, ld);
  __syncthreads();
  int bus = n_in;
  for (int l = 0; l < n_layers; ++l) {
    const int row0 = __ldg(layer_meta + 3 * l);
    const int lo = __ldg(layer_meta + 3 * l + 1);
    const int fi = __ldg(layer_meta + 3 * l + 2);
    for (int p = threadIdx.x; p < rows * lo; p += blockDim.x) {
      const int r = p / lo;
      const int o = p - r * lo;
      const int row = row0 + o;
      const int* hr = h + r * ld;
      unsigned entry = 0;
      for (int k = 0; k < fi; ++k) {
        const int j = row * fi_max + k;
        const int src = __ldg(idx + j);
        const int code =
            static_cast<unsigned>(src) < static_cast<unsigned>(bus) ? hr[src]
                                                                    : 0;
        entry += shl(static_cast<unsigned>(code) & low_mask(__ldg(width + j)),
                     __ldg(shift + j));
      }
      const int off = __ldg(row_meta + 2 * row);
      const int n_e = __ldg(row_meta + 2 * row + 1);
      g[r * ld + o] =
          entry < static_cast<unsigned>(n_e)
              ? read_table(table, packed, static_cast<long long>(off) + entry)
              : 0;
    }
    __syncthreads();
    int* t = h;
    h = g;
    g = t;
    bus = lo;
  }
  store_tile(h, ld, rows, out_perm, n_out, b0, out);
}

// layer_meta: (n_layers, 5) = row0, n_out, fan_in, n_entries, bw_in
__global__ void __launch_bounds__(kFusedThreads)
uniform_kernel(const int* __restrict__ codes, int batch, int n_in,
               const int* __restrict__ idx, int fi_max,
               const void* __restrict__ table, int e_max, int packed,
               const int* __restrict__ layer_meta, int n_layers,
               const int* __restrict__ out_perm, int n_out, int tile_b,
               int ld, int* __restrict__ out) {
  extern __shared__ int smem[];
  int* h = smem;
  int* g = smem + tile_b * ld;
  const int b0 = blockIdx.x * tile_b;
  const int rows = min(tile_b, batch - b0);
  load_tile(codes, b0, rows, n_in, h, ld);
  __syncthreads();
  int bus = n_in;
  for (int l = 0; l < n_layers; ++l) {
    const int row0 = __ldg(layer_meta + 5 * l);
    const int lo = __ldg(layer_meta + 5 * l + 1);
    const int fi = __ldg(layer_meta + 5 * l + 2);
    const int n_e = __ldg(layer_meta + 5 * l + 3);
    const int bw = __ldg(layer_meta + 5 * l + 4);
    for (int p = threadIdx.x; p < rows * lo; p += blockDim.x) {
      const int r = p / lo;
      const int o = p - r * lo;
      const int row = row0 + o;
      const int* hr = h + r * ld;
      unsigned entry = 0;
      for (int k = 0; k < fi; ++k) {
        const int src = __ldg(idx + row * fi_max + k);
        const int code =
            static_cast<unsigned>(src) < static_cast<unsigned>(bus) ? hr[src]
                                                                    : 0;
        entry += shl(static_cast<unsigned>(code), bw * k);
      }
      g[r * ld + o] =
          entry < static_cast<unsigned>(n_e)
              ? read_table(table, packed,
                           static_cast<long long>(row) * e_max + entry)
              : 0;
    }
    __syncthreads();
    int* t = h;
    h = g;
    g = t;
    bus = lo;
  }
  store_tile(h, ld, rows, out_perm, n_out, b0, out);
}

// One thread per output code: x indexes neurons, y batch rows.
__global__ void __launch_bounds__(kLayerTileO * kLayerTileB)
layer_kernel(const int* __restrict__ codes, int batch, int n_in,
             const int* __restrict__ idx, int n_out, int fan_in,
             const int* __restrict__ table, int n_entries, int bw_in,
             int* __restrict__ out) {
  const int o = blockIdx.y * kLayerTileO + threadIdx.x;
  const int b = blockIdx.x * kLayerTileB + threadIdx.y;
  if (o >= n_out || b >= batch) return;
  const int* cr = codes + static_cast<long long>(b) * n_in;
  unsigned entry = 0;
  for (int k = 0; k < fan_in; ++k) {
    const int src = __ldg(idx + o * fan_in + k);
    const int code =
        static_cast<unsigned>(src) < static_cast<unsigned>(n_in) ? __ldg(cr + src)
                                                                 : 0;
    entry += shl(static_cast<unsigned>(code), bw_in * k);
  }
  out[static_cast<long long>(b) * n_out + o] =
      entry < static_cast<unsigned>(n_entries)
          ? __ldg(table + static_cast<long long>(o) * n_entries + entry)
          : 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of the fused kernels: two (tile_b, ld) int32
// activation buffers.  The caller keeps it within the 48 KiB that needs no
// opt-in attribute.
int lut_mixed_forward(const void* codes, int batch, int n_in, const void* idx,
                      const void* shift, const void* width, int fi_max,
                      const void* table, int packed, const void* row_meta,
                      const void* layer_meta, int n_layers,
                      const void* out_perm, int n_out, int tile_b, int ld,
                      void* out, void* stream) {
  const int grid = (batch + tile_b - 1) / tile_b;
  const size_t smem = 2u * tile_b * ld * sizeof(int);
  mixed_kernel<<<grid, kFusedThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), batch, n_in,
      static_cast<const int*>(idx), static_cast<const int*>(shift),
      static_cast<const int*>(width), fi_max, table, packed,
      static_cast<const int*>(row_meta), static_cast<const int*>(layer_meta),
      n_layers, static_cast<const int*>(out_perm), n_out, tile_b, ld,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

int lut_uniform_forward(const void* codes, int batch, int n_in,
                        const void* idx, int fi_max, const void* table,
                        int e_max, int packed, const void* layer_meta,
                        int n_layers, const void* out_perm, int n_out,
                        int tile_b, int ld, void* out, void* stream) {
  const int grid = (batch + tile_b - 1) / tile_b;
  const size_t smem = 2u * tile_b * ld * sizeof(int);
  uniform_kernel<<<grid, kFusedThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), batch, n_in,
      static_cast<const int*>(idx), fi_max, table, e_max, packed,
      static_cast<const int*>(layer_meta), n_layers,
      static_cast<const int*>(out_perm), n_out, tile_b, ld,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

int lut_layer_forward(const void* codes, int batch, int n_in, const void* idx,
                      int n_out, int fan_in, const void* table, int n_entries,
                      int bw_in, void* out, void* stream) {
  const dim3 block(kLayerTileO, kLayerTileB);
  const dim3 grid((batch + kLayerTileB - 1) / kLayerTileB,
                  (n_out + kLayerTileO - 1) / kLayerTileO);
  layer_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), batch, n_in,
      static_cast<const int*>(idx), n_out, fan_in,
      static_cast<const int*>(table), n_entries, bw_in,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* lut_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
