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
// Exactness, and why any int16 code is taken: each code splits as
// w = 256 * hi + lo with hi = w >> 8 (s8) and lo = w & 0xFF (u8).  The
// spikes are u8.  mma.sync runs .u8.s8 on hi and .u8.u8 on lo, each into
// s32 accumulators without .satfinite, so each sum is exact modulo 2^32,
// and (acc_hi << 8) + acc_lo in unsigned arithmetic is sum s * w modulo
// 2^32: the wrap the plain version applies.  The JAX op casts whatever
// integer codes it gets, so no int16 code is refused here (a 9-bit split
// such as the partial contraction's would be exact only on [-256, 255]).
//
// The design: a block owns 128 lanes x 128 columns (16 warps of 64 x 16,
// two along the lanes and eight along the columns, four per scheduler;
// each warp holds two s32 accumulator sets, hi and lo, of 4 x 2 m16n8k32
// tiles): at 1,024 x 2048 -> 2048 that is 8 x 16 = 128 blocks, one wave
// on 132 SMs, reading 96 MB from L2 where 128 x 64 tiles would read
// 128 MB.  Each block walks K one 128-deep tile a stage through a
// 4-stage cp.async ring (48 KB a stage: the spike tile, 128 rows of 128
// bytes, and the code tile, 128 K rows of 128 int16 codes); rows past B
// are zero-filled.  Fragments come from shared memory by
// ldmatrix, rows swizzled against bank conflicts:
//  * spikes (A, row-major, K contiguous): ldmatrix.x4 gives the four A
//    registers in MMA order; piece c of row r sits at c ^ (r % 8);
//  * codes (B): the MMA wants each column's K bytes contiguous, but the
//    codes are (K, N) with N contiguous, and ldmatrix transposes only
//    16-bit elements.  ldmatrix.x4.trans on the int16 tile gives thread
//    (g, t) of matrix j the codes of rows 2t and 2t + 1 of column g; the
//    lanes address the matrices' rows as K = {0, 1, 4, 5, 8, 9, 12, 13}
//    and {2, 3, 6, 7, 10, 11, 14, 15} (and 16 more), so two registers
//    hold K = 4t .. 4t + 3 of column g, as the B fragment orders them, and
//    two byte permutes split them into the hi and the lo register.  Piece
//    c of K row k sits at c ^ (((k >> 1) & 6) | (k & 1)), which is c ^
//    (lane % 8) for every ldmatrix address and puts the eight rows of a
//    matrix on eight bank groups.
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
#include "mma_common.cuh"
#include "snn_stack_common.cuh"

#define SM_THREADS 512  // 16 warps, 2 (lanes) x 8 (columns)
#define SM_BM 128       // lanes per block
#define SM_BN 128       // columns per block
#define SM_BK TILE      // K per stage: one K tile
#define SM_STAGES 4
#define SM_MI 4         // m16 tiles per warp: 64 lanes
#define SM_NA 2         // n8 tiles per warp: 16 columns
#define SM_WP (SM_BN * 2 / 16)         // 16-byte pieces per code row
#define SM_WROWS (SM_THREADS / SM_WP)  // code rows copied per pass

struct SmStage {
  uint8_t s[SM_BM][SM_BK];   // lane rows of 128 K bytes
  int16_t w[SM_BK][SM_BN];   // K rows of SM_BN codes
};
#define SM_SMEM (SM_STAGES * (int)sizeof(SmStage))

// 1 in each byte of x that is not 0, else 0.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) >> 7) & 0x01010101u;
}

// One stage of a warp's 64 x 16 tile: four k32 steps, each one
// ldmatrix.x4 per m16 tile of spikes and one ldmatrix.x4.trans per n8
// tile of codes, split into hi and lo, then one MMA per (plane, m16, n8).
// a_row is the shared address of this lane's first spike row, b_row its
// code row of the k32 step's first K (+ 32 rows a step), b_col0 the
// warp's first code piece, l7 this lane's swizzle.
__device__ __forceinline__ void sm_stage_mma(
    int (&acc)[2][SM_MI][SM_NA][4], unsigned a_row, unsigned b_row,
    int b_col0, int a_hi, int l7) {
#pragma unroll
  for (int kk = 0; kk < SM_BK / 32; ++kk) {
    unsigned a[SM_MI][4];
#pragma unroll
    for (int mi = 0; mi < SM_MI; ++mi)
      ldsm_x4(a[mi], a_row + mi * 16 * SM_BK + (((2 * kk + a_hi) ^ l7) << 4));
#pragma unroll
    for (int ni = 0; ni < SM_NA; ++ni) {
      unsigned r[4];
      ldsm_x4_trans(r, b_row + kk * 32 * (SM_BN * 2) +
                           (((b_col0 + ni) ^ l7) << 4));
      // r[0], r[1]: codes of K 4t .. 4t + 3 (two per register, low half
      // first), r[2], r[3] those of K 16 + 4t ..; byte 0 of a code is lo
      const unsigned hi0 = __byte_perm(r[0], r[1], 0x7531);
      const unsigned lo0 = __byte_perm(r[0], r[1], 0x6420);
      const unsigned hi1 = __byte_perm(r[2], r[3], 0x7531);
      const unsigned lo1 = __byte_perm(r[2], r[3], 0x6420);
#pragma unroll
      for (int mi = 0; mi < SM_MI; ++mi) {
        mma_u8s8(acc[0][mi][ni], a[mi], hi0, hi1);
        mma_u8u8(acc[1][mi][ni], a[mi], lo0, lo1);
      }
    }
  }
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

  // The copies: thread t moves 16-byte piece t % 8 of spike rows t / 8 and
  // t / 8 + 64 (a row past B is zero-filled and read from nowhere), and
  // piece t % SM_WP of code rows t / SM_WP + i * SM_WROWS, whose swizzle
  // is the same for every i.  Offsets are 32-bit (the C entry checks the
  // sizes), so no derived 64-bit pointer stays live across the K loop.
  const int piece = t & 7, rsub = t >> 3;
  const int dst = rsub * SM_BK + ((piece ^ (rsub & 7)) << 4);  // +64 alike
  const unsigned s_off = (unsigned)(row0 + rsub) * K + piece * 16;
  const bool oks0 = row0 + rsub < B, oks1 = row0 + rsub + 64 < B;
  const int wpc = t % SM_WP, wr = t / SM_WP;
  const int w_dst = wr * SM_BN + ((wpc ^ (((wr >> 1) & 6) | (wr & 1))) << 3);
  const unsigned w_off = (unsigned)wr * N + col0 + wpc * 8;
  auto load = [&](int kt, int buf) {
    const unsigned k = (unsigned)kt * SM_BK;
    uint8_t* ss = &stage[buf].s[0][0] + dst;
    cp_async16_zfill(ss, s + (oks0 ? s_off + k : 0u), oks0);
    cp_async16_zfill(ss + 64 * SM_BK, s + (oks1 ? s_off + 64u * K + k : 0u),
                     oks1);
    int16_t* sw = &stage[buf].w[0][0] + w_dst;
#pragma unroll
    for (int i = 0; i < SM_BK / SM_WROWS; ++i)
      cp_async16_zfill(sw + i * SM_WROWS * SM_BN,
                       w + (w_off + (k + i * SM_WROWS) * (unsigned)N), true);
  };
#pragma unroll
  for (int p = 0; p < SM_STAGES - 1; ++p) {
    if (p < nkt) load(p, p);
    cp_async_commit();
  }

  // Warp tile: lanes wm * 64 + [0, 64), columns wn * 16 + [0, 16).
  // ldmatrix rows: lane L addresses row L % 8 of matrix L / 8; for spikes
  // matrices 0-3 are (rows 0-7, 8-15) x (K bytes 0-15, 16-31) of an m16
  // tile, for codes K rows {0,1,4,5,8,9,12,13} + 2 * (L / 8 % 2) + 16 *
  // (L / 16) of an n8 tile's 16-byte column piece.
  const int wm = warp >> 3, wn = warp & 7;
  const int l7 = lane & 7, a_hi = lane >> 4;
  const int m = lane >> 3;
  const int b_k = 16 * (m >> 1) + 4 * (l7 >> 1) + (l7 & 1) + 2 * (m & 1);
  const unsigned a_off = (wm * SM_MI * 16 + l7 + (m & 1) * 8) * SM_BK;
  const unsigned b_off = b_k * (SM_BN * 2);
  const int b_col0 = wn * SM_NA;
  int acc[2][SM_MI][SM_NA][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mi = 0; mi < SM_MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < SM_NA; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][mi][ni][j] = 0;

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<SM_STAGES - 2>();  // this thread's copies of kt landed
    SmStage& st = stage[kt % SM_STAGES];
    if (masked) {  // own pieces to [byte != 0]; the barrier publishes them
      uint8_t* own = &st.s[0][0] + dst;
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
      load(kt + SM_STAGES - 1, (kt + SM_STAGES - 1) % SM_STAGES);
    cp_async_commit();
    const unsigned sx = (unsigned)__cvta_generic_to_shared(&st.s[0][0]);
    const unsigned sw = (unsigned)__cvta_generic_to_shared(&st.w[0][0]);
    sm_stage_mma(acc, sx + a_off, sw + b_off, b_col0, a_hi, l7);
  }
  cp_async_wait<0>();

  // (acc_hi << 8) + acc_lo in unsigned arithmetic.  Element j of an m16n8
  // tile sits at row g (j < 2) or g + 8, column 2 * tig + (j & 1).
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
          v[j] = (int)(((unsigned)acc[0][mi][ni][2 * h + j] << 8) +
                       (unsigned)acc[1][mi][ni][2 * h + j]);
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
