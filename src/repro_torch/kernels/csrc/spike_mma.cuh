// The int8 tensor-core tile shared by the spike matmul (spike_matmul.cu)
// and the staged LIF kernel (lif_step.cu): a block of 512 threads owns 128
// lanes x 128 columns of the product of u8 spike bytes (lanes x K, K
// contiguous) and int16 codes (K x N, N contiguous), accumulated in s32 on
// the tensor cores.
//
// Exactness for any int16 code: each code splits as w = 256 * hi + lo
// with hi = w >> 8 (s8) and lo = w & 0xFF (u8).  The spikes are u8 and
// count by value.  mma.sync runs .u8.s8 on hi and .u8.u8 on lo, each into
// s32 accumulators without .satfinite, so each sum is exact modulo 2^32,
// and (acc_hi << 8) + acc_lo in unsigned arithmetic (sm_combine) is
// sum s * w modulo 2^32: int32 wraparound.
//
// The tile: 16 warps of 64 lanes x 16 columns (two along the lanes, eight
// along the columns, four per scheduler); each warp holds two s32
// accumulator sets, hi and lo, of 4 x 2 m16n8k32 tiles.  A stage is one
// 128-deep K tile, 48 KB: the spike tile, 128 rows of 128 bytes, and the
// code tile, 128 K rows of 128 int16 codes, copied by cp.async (sm_load).
// Fragments come from shared memory by ldmatrix, rows swizzled against
// bank conflicts:
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
// Copies take 32-bit offsets from the kernel's parameters: at the
// 128-register cap of 512 threads, 64-bit pointers derived from the
// operands and kept live across the K loop spill.
#pragma once

#include "mma_common.cuh"
#include "snn_stack_common.cuh"

#define SM_THREADS 512  // 16 warps, 2 (lanes) x 8 (columns)
#define SM_BM 128       // lanes per block
#define SM_BN 128       // columns per block
#define SM_BK TILE      // K per stage: one K tile
#define SM_MI 4         // m16 tiles per warp: 64 lanes
#define SM_NA 2         // n8 tiles per warp: 16 columns
#define SM_WP (SM_BN * 2 / 16)         // 16-byte pieces per code row
#define SM_WROWS (SM_THREADS / SM_WP)  // code rows copied per pass

struct SmStage {
  uint8_t s[SM_BM][SM_BK];   // lane rows of 128 K bytes
  int16_t w[SM_BK][SM_BN];   // K rows of SM_BN codes
};

typedef int SmAcc[2][SM_MI][SM_NA][4];  // [hi, lo][m16][n8][element]

// This thread's copies: 16-byte piece `piece` of spike rows rsub and
// rsub + 64 of the block (a row past B is zero-filled and read from
// nowhere), and piece wpc of code rows wr + i * SM_WROWS, whose swizzle is
// the same for every i.  Shared offsets dst / w_dst, global element
// offsets s_off / w_off of the first K column and row.
struct SmCopy {
  int dst, w_dst, piece, wr;
  unsigned s_off, w_off;
  bool oks0, oks1;
};

__device__ __forceinline__ SmCopy sm_copy_init(int t, int row0, int col0,
                                               int B, int K, int N) {
  SmCopy c;
  c.piece = t & 7;
  const int rsub = t >> 3;
  c.dst = rsub * SM_BK + ((c.piece ^ (rsub & 7)) << 4);  // +64 rows alike
  c.s_off = (unsigned)(row0 + rsub) * K + c.piece * 16;
  c.oks0 = row0 + rsub < B;
  c.oks1 = row0 + rsub + 64 < B;
  const int wpc = t % SM_WP;
  c.wr = t / SM_WP;
  c.w_dst = c.wr * SM_BN + ((wpc ^ (((c.wr >> 1) & 6) | (c.wr & 1))) << 3);
  c.w_off = (unsigned)c.wr * N + col0 + wpc * 8;
  return c;
}

// Stage the K tile that starts at K column k.  With kTail, K is a
// multiple of 16 but maybe not of the tile, and the spike pieces and code
// rows from K on are zero-filled (cp.async src-size 0); without it K is a
// multiple of the tile.
template <bool kTail>
__device__ __forceinline__ void sm_load(SmStage& st, const SmCopy& c,
                                        const uint8_t* s, const int16_t* w,
                                        unsigned k, int K, int N) {
  const bool in_k = !kTail || k + c.piece * 16 < (unsigned)K;
  const bool ok0 = c.oks0 && in_k, ok1 = c.oks1 && in_k;
  uint8_t* ss = &st.s[0][0] + c.dst;
  cp_async16_zfill(ss, s + (ok0 ? c.s_off + k : 0u), ok0);
  cp_async16_zfill(ss + 64 * SM_BK, s + (ok1 ? c.s_off + 64u * K + k : 0u),
                   ok1);
  int16_t* sw = &st.w[0][0] + c.w_dst;
#pragma unroll
  for (int i = 0; i < SM_BK / SM_WROWS; ++i) {
    const bool ok = !kTail || k + c.wr + i * SM_WROWS < (unsigned)K;
    cp_async16_zfill(sw + i * SM_WROWS * SM_BN,
                     w + (ok ? c.w_off + (k + i * SM_WROWS) * (unsigned)N
                             : 0u),
                     ok);
  }
}

// This lane's ldmatrix addresses within a stage.  Warp tile: lanes wm * 64
// + [0, 64), columns wn * 16 + [0, 16).  Lane L addresses row L % 8 of
// matrix L / 8; for spikes matrices 0-3 are (rows 0-7, 8-15) x (K bytes
// 0-15, 16-31) of an m16 tile, for codes K rows {0,1,4,5,8,9,12,13} + 2 *
// (L / 8 % 2) + 16 * (L / 16) of an n8 tile's 16-byte column piece.
struct SmFrag {
  unsigned a_off, b_off;
  int b_col0, a_hi, l7;
};

__device__ __forceinline__ SmFrag sm_frag_init(int warp, int lane) {
  SmFrag f;
  const int wm = warp >> 3, wn = warp & 7, m = lane >> 3;
  f.l7 = lane & 7;
  f.a_hi = lane >> 4;
  const int b_k = 16 * (m >> 1) + 4 * (f.l7 >> 1) + (f.l7 & 1) + 2 * (m & 1);
  f.a_off = (wm * SM_MI * 16 + f.l7 + (m & 1) * 8) * SM_BK;
  f.b_off = b_k * (SM_BN * 2);
  f.b_col0 = wn * SM_NA;
  return f;
}

__device__ __forceinline__ void sm_acc_zero(SmAcc& acc) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mi = 0; mi < SM_MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < SM_NA; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][mi][ni][j] = 0;
}

// One stage of a warp's 64 x 16 tile: four k32 steps, each one
// ldmatrix.x4 per m16 tile of spikes and one ldmatrix.x4.trans per n8
// tile of codes, split into hi and lo, then one MMA per (plane, m16, n8).
__device__ __forceinline__ void sm_stage_mma(SmAcc& acc, const SmStage& st,
                                             const SmFrag& f) {
  const unsigned a_row =
      (unsigned)__cvta_generic_to_shared(&st.s[0][0]) + f.a_off;
  const unsigned b_row =
      (unsigned)__cvta_generic_to_shared(&st.w[0][0]) + f.b_off;
#pragma unroll
  for (int kk = 0; kk < SM_BK / 32; ++kk) {
    unsigned a[SM_MI][4];
#pragma unroll
    for (int mi = 0; mi < SM_MI; ++mi)
      ldsm_x4(a[mi],
              a_row + mi * 16 * SM_BK + (((2 * kk + f.a_hi) ^ f.l7) << 4));
#pragma unroll
    for (int ni = 0; ni < SM_NA; ++ni) {
      unsigned r[4];
      ldsm_x4_trans(r, b_row + kk * 32 * (SM_BN * 2) +
                           (((f.b_col0 + ni) ^ f.l7) << 4));
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

// sum s * w modulo 2^32 from the two planes' sums.  Element j of an m16n8
// tile sits at row g (j < 2) or g + 8, column 2 * tig + (j & 1), with g =
// lane / 4 and tig = lane % 4.
__device__ __forceinline__ int sm_combine(int hi, int lo) {
  return (int)(((unsigned)hi << 8) + (unsigned)lo);
}
