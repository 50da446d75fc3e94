// One layer's partial contraction on a model axis: the sum of the weight
// rows of the spiking inputs, for the full input-spike vector against one
// output-column weight shard, for one step, with the reference tile skip.
//
// Replaces the TPU kernel repro/kernels/fused_snn.py::
// partial_contraction_pallas (body _partial_kernel, contraction
// _tiled_contraction).  Inputs: spikes x (B, n_in) uint8, the shard's
// enables en (B, n_out) uint8 and codes w (n_in, n_out) int16, B a
// multiple of 8 and both widths of 128.  Outputs: current (B, n_out) int32
// and skipped (B / 8,) int32, the 128x128 tile pairs skipped per 8-lane
// block (zeroed by the caller; this kernel adds to it).
//
// Function: with sparse_skip, a (K tile, N tile) pair is skipped when the
// block has no spike in the K tile or no enabled neuron in the N tile; a
// skipped pair adds nothing and counts once.  A dead N tile therefore
// leaves raw currents at 0 where the dense product would not.
//
// What bounds it on an H100: operations.  At the WIDE serving shard
// (1,024 lanes, 2048 -> 512, about 10% input spikes) the function moves
// about 6.5 MB (2 us at 3.35 TB/s) but executes about 110 M int32 adds
// (spikes x enabled columns), about 7 us at the INT32 rate.
//
// What the design does about it: one thread block per (8-lane batch
// block, 128-column N tile), one thread per column, 8 accumulators (one
// per lane) in registers.  Per 128-row K tile the block ballots its
// lanes' spikes into a list of the rows on which any lane spikes, each
// with its 8-bit lane mask, in shared memory; every thread then reads
// each listed weight row once (the 128 columns of a row are 256
// neighbouring bytes) and adds it to the lanes of the mask, with no
// multiplies.  So each weight a block needs is read once per step, not
// once per spiking lane.  The per-block skip count sums over N tiles with
// an integer atomicAdd, which is exact in any order.
#include "snn_stack_common.cuh"

#define PC_THREADS TILE  // one thread per column of the N tile

__global__ void __launch_bounds__(PC_THREADS)
partial_contraction_kernel(const uint8_t* __restrict__ x,
                           const uint8_t* __restrict__ en,
                           const int16_t* __restrict__ w,
                           int32_t* __restrict__ cur,
                           int32_t* __restrict__ skipped, int n_in,
                           int n_out, int sparse_skip) {
  __shared__ uint16_t rows[TILE];
  __shared__ uint8_t masks[TILE];
  __shared__ int warp_rows[PC_THREADS / 32];
  const int t = threadIdx.x;
  const int col = blockIdx.y * TILE + t;
  const size_t row0 = (size_t)blockIdx.x * BLOCK_B;

  bool e_any = false;
#pragma unroll
  for (int l = 0; l < BLOCK_B; ++l)
    e_any |= en[(row0 + l) * n_out + col] != 0;
  const bool n_live = __syncthreads_or(e_any) != 0;

  unsigned acc[BLOCK_B];
#pragma unroll
  for (int l = 0; l < BLOCK_B; ++l) acc[l] = 0u;
  const int nkt = n_in / TILE;
  int skips = 0;
  if (sparse_skip && !n_live) {
    skips = nkt;
  } else {
    for (int kt = 0; kt < nkt; ++kt) {
      const int n_rows = block_spike_rows(x, row0, n_in, kt * TILE, rows,
                                          masks, warp_rows);
      if (n_rows == 0) skips += 1;
      add_spike_rows(w, n_out, col, rows, masks, n_rows, acc);
      __syncthreads();  // the list is rewritten by the next K tile
    }
  }
#pragma unroll
  for (int l = 0; l < BLOCK_B; ++l)
    cur[(row0 + l) * n_out + col] = (int32_t)acc[l];
  if (t == 0 && sparse_skip && skips) atomicAdd(&skipped[blockIdx.x], skips);
}

// ---- C interface (loaded with ctypes) -------------------------------------
// ptrs: x (B, n_in) u8, en (B, n_out) u8, w (n_in, n_out) i16, cur (B, n_out)
//       i32, skipped (B / 8,) i32 (zero-filled), all contiguous;
// ints: B, n_in, n_out, sparse_skip.  Returns the cudaError_t of the launch.
extern "C" int repro_partial_contraction(const void* ptrs_v, int n_ptrs,
                                         const void* ints_v, int n_ints,
                                         void* stream) {
  void* const* ptrs = (void* const*)ptrs_v;
  const int* ints = (const int*)ints_v;
  if (n_ptrs != 5 || n_ints != 4) return (int)cudaErrorInvalidValue;
  const int B = ints[0], n_in = ints[1], n_out = ints[2];
  if (B <= 0 || B % BLOCK_B || n_in <= 0 || n_in % TILE || n_in > 65535 ||
      n_out <= 0 || n_out % TILE || n_out / TILE > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i)
    if (ptrs[i] == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid(B / BLOCK_B, n_out / TILE);
  partial_contraction_kernel<<<grid, PC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ptrs[0], (const uint8_t*)ptrs[1],
      (const int16_t*)ptrs[2], (int32_t*)ptrs[3], (int32_t*)ptrs[4], n_in,
      n_out, ints[3]);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
