// Spike x weight contraction: (B, K) uint8 spikes times (K, N) int16 codes
// -> (B, N) int32, in one of two realisations, on the int8 tensor cores.
//
// Replaces the TPU kernel repro/kernels/spike_matmul.py::
// spike_matmul_pallas (body _spike_mm_kernel), both of its modes:
//  * masked: the RTL datapath, acc += s ? w : 0 per input row, so a spike
//    is any non-zero byte and counts as 1;
//  * dot: the counterpart of the TPU's MXU branch, sum s * w with the
//    spike byte's value (a byte of 255 counts 255).
// Which one runs is read from a one-byte flag in device memory (non-zero =
// masked), so the density dispatch of kernels/ops.py::spike_matmul_op
// decides on the device, without a host round trip, as lax.cond does.
// Both give the same bits as the plain version: sum s * w, or sum [s != 0]
// * w, wrapped to int32.
//
// What bounds it on an H100: at (1,024, 2048 -> 2048) the function moves
// 18.9 MB (5.6 us at 3.35 TB/s).  As a dense product of the two byte
// planes of the codes (below) it does 2 * B * K * N * 2 = 17.2 G int8
// operations, 8.7 us at the 1,979 T/s int8 tensor-core rate; the executed
// adds alone (249 M at 5.8% spike density) would take 14.9 us at the
// INT32 rate.  So the tensor cores, not event-driven scalar adds, are the
// short way: operations bound it, at 8.7 us.
//
// Exactness, and why any int16 code is taken: the product runs on the
// byte planes of the codes, w = 256 * hi + lo, with s32 sums that wrap as
// int32 does (spike_mma.cuh).  The JAX op casts whatever integer codes it
// gets, so no int16 code is refused here (a 9-bit split such as the
// partial contraction's would be exact only on [-256, 255]).
//
// The design: a block owns 128 lanes x 128 columns, the tile of
// spike_mma.cuh (16 warps of 64 x 16, two s32 accumulator sets each): at
// 1,024 x 2048 -> 2048 that is 8 x 16 = 128 blocks, one wave on 132 SMs,
// reading 96 MB from L2 where 128 x 64 tiles would read 128 MB.  Each
// block walks K one 128-deep tile a stage through a 4-stage cp.async ring
// (48 KB a stage); rows past B are zero-filled.  Fragments come from
// shared memory by ldmatrix over swizzled rows, the codes split into
// their byte planes in registers (spike_mma.cuh).
//
// masked runs the same MMAs on the indicator of the spike tile: once its
// copies have landed, each thread rewrites its own pieces of the staged
// tile to [byte != 0], before the barrier that hands the stage to the
// MMAs.  So the two realisations differ by one pass over 32 bytes a
// thread a stage.
//
// Traps met or avoided:
//  * A is u8, not s8: a spike byte of 255 is 255 in dot (s.astype(int32)
//    in the JAX branch), and 1 in masked.
//  * Skipping empty K steps pays nothing here: at 5.8% density a 16-lane
//    x 32-deep step is empty with probability 0.942^512, so neither
//    realisation skips anything.
//  * nvcc 12.9 miscompiled a clamp-then-compare dispatch in the partial
//    contraction; the flag here is a plain byte compare.
//    __launch_bounds__ names a minimum of one block so that ptxas may use
//    128 registers, and A quads come from ldmatrix, not 16-byte loads.
//  * At that cap, 64-bit pointers derived from the operands and kept
//    live across the K loop spilled; the copies take 32-bit offsets from
//    the kernel's parameters instead, and the C entry checks the sizes.
//  * Edge shapes: B is a multiple of 8 and K and N of 128 (the op pads),
//    so only the lanes of a partial 128-lane tile need care: they are
//    zero-filled and not stored.
//
// What still holds it back (about 29 us masked and 26.5 us dot against the
// 8.7 us bound on an H100 at 700 W; PERF.md section 6 has the runs), as
// reckoned from the instruction mix, not measured by a profiler:
//  * shared-memory bandwidth: per 16 MMAs a warp reads 3 KB by ldmatrix
//    (2 KB of spikes, 1 KB of codes) and each stage lands 48 KB by
//    cp.async, about 240 B per MMA, near two SM clocks at 128 B a clock,
//    where the tensor cores could take one MMA a clock;
//  * one wave: all 128 blocks fill their rings together at the start and
//    write the 8 MB of results together at the end (2.5 us at 3.35 TB/s),
//    with no work to overlap either;
//  * masked pays its indicator pass, about 2.4 us, on the barrier's path.
// wgmma (operands read by the tensor cores from shared memory), TMA
// copies and a persistent grid that overlaps one tile's epilogue with the
// next tile's loads are the next steps; mma.sync was the smaller first
// one.
#include "spike_mma.cuh"

#define SM_STAGES 4
#define SM_SMEM (SM_STAGES * (int)sizeof(SmStage))

// 1 in each byte of x that is not 0, else 0.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) >> 7) & 0x01010101u;
}

__global__ void __launch_bounds__(SM_THREADS, 1)
    spike_matmul_kernel(const uint8_t* __restrict__ s,
                        const int16_t* __restrict__ w,
                        int32_t* __restrict__ out,
                        const uint8_t* __restrict__ masked_flag, int B, int K,
                        int N) {
  extern __shared__ __align__(16) uint8_t sm_smem[];
  SmStage* stage = (SmStage*)sm_smem;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * SM_BM, col0 = blockIdx.y * SM_BN;
  const int nkt = K / SM_BK;
  const bool masked = *masked_flag != 0;

  // The copies (spike_mma.cuh): offsets are 32-bit (the C entry checks
  // the sizes), so no derived 64-bit pointer stays live across the K loop.
  const SmCopy cp = sm_copy_init(t, row0, col0, B, K, N);
#pragma unroll
  for (int p = 0; p < SM_STAGES - 1; ++p) {
    if (p < nkt)
      sm_load<false>(stage[p], cp, s, w, (unsigned)p * SM_BK, K, N);
    cp_async_commit();
  }

  const int wm = warp >> 3, wn = warp & 7;
  const SmFrag f = sm_frag_init(warp, lane);
  SmAcc acc;
  sm_acc_zero(acc);

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<SM_STAGES - 2>();  // this thread's copies of kt landed
    SmStage& st = stage[kt % SM_STAGES];
    if (masked) {  // own pieces to [byte != 0]; the barrier publishes them
      uint8_t* own = &st.s[0][0] + cp.dst;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint4* v = (uint4*)(own + h * 64 * SM_BK);
        uint4 x = *v;
        x.x = nonzero_bytes(x.x);
        x.y = nonzero_bytes(x.y);
        x.z = nonzero_bytes(x.z);
        x.w = nonzero_bytes(x.w);
        *v = x;
      }
    }
    __syncthreads();  // stage kt is complete; stage kt - 1 is free to refill
    if (kt + SM_STAGES - 1 < nkt)
      sm_load<false>(stage[(kt + SM_STAGES - 1) % SM_STAGES], cp, s, w,
                     (unsigned)(kt + SM_STAGES - 1) * SM_BK, K, N);
    cp_async_commit();
    sm_stage_mma(acc, st, f);
  }
  cp_async_wait<0>();

  // (acc_hi << 8) + acc_lo in unsigned arithmetic (sm_combine).
#pragma unroll
  for (int mi = 0; mi < SM_MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + (wm * SM_MI + mi) * 16 + h * 8 + g;
      if (row >= B) continue;
      int32_t* o = out + (size_t)row * N + col0 + wn * 16 + 2 * tig;
#pragma unroll
      for (int ni = 0; ni < SM_NA; ++ni) {
        int v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          v[j] = sm_combine(acc[0][mi][ni][2 * h + j],
                            acc[1][mi][ni][2 * h + j]);
        *(int2*)(o + ni * 8) = make_int2(v[0], v[1]);
      }
    }
  }
}

// ---- C interface (loaded with ctypes) -------------------------------------
// ptrs: s (B, K) u8, w (K, N) i16, out (B, N) i32, masked_flag (1 byte), all
//       contiguous on one device, the first three 16-byte aligned;
// ints: B, K, N (B a multiple of 8, K and N of 128, (B + 128) * K and
// K * N below 2^32).  Returns the cudaError_t of the launch.
extern "C" int repro_spike_matmul(const void* ptrs_v, int n_ptrs,
                                  const void* ints_v, int n_ints,
                                  void* stream) {
  void* const* ptrs = (void* const*)ptrs_v;
  const int* ints = (const int*)ints_v;
  if (n_ptrs != 4 || n_ints != 3) return (int)cudaErrorInvalidValue;
  const int B = ints[0], K = ints[1], N = ints[2];
  if (B <= 0 || B % BLOCK_B || K <= 0 || K % TILE || N <= 0 || N % TILE ||
      N / SM_BN > 65535 || (long long)(B + SM_BM) * K >= (1ll << 32) ||
      (long long)K * N >= (1ll << 32))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (ptrs[i] == nullptr || (i < 3 && (uintptr_t)ptrs[i] % 16))
      return (int)cudaErrorInvalidValue;
  static int smem_cap[MAX_DEVICES] = {};
  cudaError_t e = raise_smem_cap((const void*)spike_matmul_kernel, SM_SMEM,
                                 smem_cap);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + SM_BM - 1) / SM_BM, N / SM_BN);
  spike_matmul_kernel<<<grid, SM_THREADS, SM_SMEM, (cudaStream_t)stream>>>(
      (const uint8_t*)ptrs[0], (const int16_t*)ptrs[1], (int32_t*)ptrs[2],
      (const uint8_t*)ptrs[3], B, K, N);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
