// One integer LIF layer over a materialised spike train: T steps from
// fresh state (membranes at v_rest, every neuron enabled).
//
// Replaces the TPU kernel repro/kernels/lif_step.py::lif_forward_pallas
// (body _lif_kernel), the per-layer stage of the staged backend.  Inputs:
// spikes uint8 (T, B, K) and int16 weight codes (K, N); outputs: the
// fired spikes uint8 and the membrane trace int32, (T, B, N), and the
// final membrane (B, N).  It takes any int16 code, not only the paper's
// signed 9-bit range: this is the backend for wider codes.  The current
// accumulates in 32-bit two's complement with wraparound (unsigned adds),
// as the reference's int32 dot does.
//
// What bounds it on an H100: the int32 trace it writes (4 B per neuron per
// step per lane, 168 MB at T=20, B=1024, 2048->2048) against its executed
// adds (input spikes x enabled neurons), whichever the data makes larger:
// at a 10% input spike density the adds take longer at the INT32 rate.
//
// What the design does about it: one thread block per (8-lane batch block,
// 128-column tile), one warp per lane, each thread owning 4 columns whose
// membranes and enables sit in registers for all T steps.  Per step a warp
// turns its lane's spikes into a list of spiking input indices in shared
// memory (ballot + popc compaction, in chunks of KCHUNK inputs) and adds
// the int16 weight row segments of exactly those inputs: adds only.
// Neighbouring threads read and write neighbouring columns, so the weight
// reads and the trace and spike writes are coalesced.
#include "snn_stack_common.cuh"

#define LIF_BLOCK_B 8    // lanes per block, one warp each
#define KCHUNK 2048      // inputs listed per pass (8 x 4 KB of uint16)

struct LifParams {
  const uint8_t* spikes;  // (T, B, K)
  const int16_t* w;       // (K, N)
  uint8_t* spk_out;       // (T, B, N)
  int32_t* vtr;           // (T, B, N)
  int32_t* vfin;          // (B, N)
  int T, B, K, N, pruning;
  LifConsts lc;
};

__global__ void __launch_bounds__(32 * LIF_BLOCK_B)
lif_forward_kernel(const LifParams p) {
  __shared__ uint16_t list[LIF_BLOCK_B][KCHUNK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int row = blockIdx.y * LIF_BLOCK_B + warp;
  const int c0 = blockIdx.x * TILE;
  const size_t B = p.B, K = p.K, N = p.N;
  uint16_t* lst = list[warp];

  int v[4];
  bool en[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = p.lc.v_rest;
    en[j] = true;
  }
  for (int t = 0; t < p.T; ++t) {
    const uint8_t* s_row = p.spikes + ((size_t)t * B + row) * K;
    unsigned acc[4] = {0u, 0u, 0u, 0u};
    for (int k0 = 0; k0 < p.K; k0 += KCHUNK) {
      const int kn = min(KCHUNK, p.K - k0);
      int n = 0;
      for (int base = 0; base < kn; base += 32) {
        const int i = base + lane;
        const bool spk = i < kn && s_row[k0 + i] != 0;
        const unsigned m = __ballot_sync(FULL_MASK, spk);
        if (spk) lst[n + __popc(m & lt_mask)] = (uint16_t)i;
        n += __popc(m);
      }
      __syncwarp();
      const int16_t* wcol = p.w + (size_t)k0 * N + c0 + lane;
#pragma unroll 4
      for (int ii = 0; ii < n; ++ii) {
        const int16_t* wrow = wcol + (size_t)lst[ii] * N;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += (unsigned)(int)__ldg(wrow + 32 * j);
      }
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t o = ((size_t)t * B + row) * N + c0 + 32 * j + lane;
      bool fired;
      v[j] = lif_update(v[j], en[j] ? (int)acc[j] : 0, en[j], p.lc, &fired);
      p.spk_out[o] = fired ? 1 : 0;
      p.vtr[o] = v[j];
      if (p.pruning) en[j] = en[j] && !fired;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) p.vfin[row * N + c0 + 32 * j + lane] = v[j];
}

// ---- C interface (loaded with ctypes) -------------------------------------
// ptrs: spikes (T, B, K) u8, w (K, N) i16, spk_out (T, B, N) u8, vtr
//       (T, B, N) i32, vfin (B, N) i32, all contiguous;
// ints: T, B, K, N, decay_shift, v_th, v_rest, v_min, v_max, pruning.
// B must be a multiple of 8 and N of 128.  Returns the cudaError_t of the
// launch.
extern "C" int repro_lif_forward(const void* ptrs_v, int n_ptrs,
                                 const void* ints_v, int n_ints,
                                 void* stream) {
  void* const* ptrs = (void* const*)ptrs_v;
  const int* ints = (const int*)ints_v;
  if (n_ptrs != 5 || n_ints != 10) return (int)cudaErrorInvalidValue;
  LifParams p;
  p.spikes = (const uint8_t*)ptrs[0];
  p.w = (const int16_t*)ptrs[1];
  p.spk_out = (uint8_t*)ptrs[2];
  p.vtr = (int32_t*)ptrs[3];
  p.vfin = (int32_t*)ptrs[4];
  p.T = ints[0];
  p.B = ints[1];
  p.K = ints[2];
  p.N = ints[3];
  p.lc = {ints[4], ints[5], ints[6], ints[7], ints[8]};
  p.pruning = ints[9];
  if (p.T < 0 || p.B <= 0 || p.B % LIF_BLOCK_B != 0 || p.K < 0 ||
      p.N <= 0 || p.N % TILE != 0 || p.B / LIF_BLOCK_B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.N / TILE, p.B / LIF_BLOCK_B);
  lif_forward_kernel<<<grid, 32 * LIF_BLOCK_B, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
