// Spike x weight contraction: (B, K) {0,1} spikes times (K, N) int16 codes
// -> (B, N) int32, in one of two realisations that give the same bits.
//
// Replaces the TPU kernel repro/kernels/spike_matmul.py::
// spike_matmul_pallas (body _spike_mm_kernel), both of its modes:
//  * masked: the RTL datapath.  For each input row, acc += s ? w : 0, with
//    no multiplies; rows on which no lane of the block spikes are skipped
//    (the event-driven realisation).
//  * dot: the counterpart of the TPU's MXU branch, a tiled int32
//    multiply-accumulate: the block's spike tile sits in shared memory as
//    int32 and every thread multiplies it into its column of every row.
// Which one runs is read from a one-byte flag in device memory (non-zero =
// masked), so the density dispatch of kernels/ops.py::spike_matmul_op
// decides on the device, without a host round trip, as lax.cond does.
//
// What bounds it on an H100: operations.  At (1,024, 2048 -> 2048) the
// function moves 18.9 MB (5.6 us at 3.35 TB/s) and executes the adds of
// its spikes, 249 M at 5.8% density and 447 M at 10.4% (15 and 27 us at
// the INT32 rate).
//
// What the design does about it: one thread block per (8-lane batch
// block, 128-column tile), one thread per column, 8 accumulators in
// registers; each weight is read once per block (neighbouring threads on
// neighbouring columns) and the spike tile is shared through shared
// memory.  masked reads and adds only the rows some lane of the block
// spikes on (snn_stack_common.cuh's row lists); dot reads every row.
// B must be a multiple of 8 and K and N of 128 (the op pads).
#include "snn_stack_common.cuh"

#define SM_THREADS TILE  // one thread per column of the N tile

__global__ void __launch_bounds__(SM_THREADS)
spike_matmul_kernel(const uint8_t* __restrict__ s,
                    const int16_t* __restrict__ w, int32_t* __restrict__ out,
                    const uint8_t* __restrict__ masked_flag, int K, int N) {
  __shared__ uint16_t rows[TILE];
  __shared__ uint8_t masks[TILE];
  __shared__ int warp_rows[SM_THREADS / 32];
  __shared__ int s_tile[BLOCK_B][TILE];
  const int t = threadIdx.x;
  const int col = blockIdx.y * TILE + t;
  const size_t row0 = (size_t)blockIdx.x * BLOCK_B;
  const bool masked = *masked_flag != 0;

  unsigned acc[BLOCK_B];
#pragma unroll
  for (int l = 0; l < BLOCK_B; ++l) acc[l] = 0u;
  for (int k0 = 0; k0 < K; k0 += TILE) {
    if (masked) {
      const int n_rows = block_spike_rows(s, row0, K, k0, rows, masks,
                                          warp_rows);
      add_spike_rows(w, N, col, rows, masks, n_rows, acc);
    } else {
#pragma unroll
      for (int l = 0; l < BLOCK_B; ++l)
        s_tile[l][t] = s[(row0 + l) * K + k0 + t];
      __syncthreads();
      const int16_t* __restrict__ wcol = w + (size_t)k0 * N + col;
#pragma unroll 4
      for (int i = 0; i < TILE; ++i) {
        const unsigned wv = (unsigned)(int)__ldg(wcol + (size_t)i * N);
#pragma unroll
        for (int l = 0; l < BLOCK_B; ++l)
          acc[l] += (unsigned)s_tile[l][i] * wv;
      }
    }
    __syncthreads();  // the lists / the tile are rewritten next
  }
#pragma unroll
  for (int l = 0; l < BLOCK_B; ++l)
    out[(row0 + l) * N + col] = (int32_t)acc[l];
}

// ---- C interface (loaded with ctypes) -------------------------------------
// ptrs: s (B, K) u8, w (K, N) i16, out (B, N) i32, masked_flag (1 byte), all
//       contiguous on one device; ints: B, K, N.  Returns the cudaError_t
// of the launch.
extern "C" int repro_spike_matmul(const void* ptrs_v, int n_ptrs,
                                  const void* ints_v, int n_ints,
                                  void* stream) {
  void* const* ptrs = (void* const*)ptrs_v;
  const int* ints = (const int*)ints_v;
  if (n_ptrs != 4 || n_ints != 3) return (int)cudaErrorInvalidValue;
  const int B = ints[0], K = ints[1], N = ints[2];
  if (B <= 0 || B % BLOCK_B || K <= 0 || K % TILE || K > 65535 || N <= 0 ||
      N % TILE || N / TILE > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (ptrs[i] == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid(B / BLOCK_B, N / TILE);
  spike_matmul_kernel<<<grid, SM_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ptrs[0], (const int16_t*)ptrs[1], (int32_t*)ptrs[2],
      (const uint8_t*)ptrs[3], K, N);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
