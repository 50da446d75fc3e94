// One layer's partial contraction on a model axis: the sum of the weight
// rows of the spiking inputs, for the full input-spike vector against one
// output-column weight shard, for one step, with the reference tile skip.
//
// Replaces the TPU kernel repro/kernels/fused_snn.py::
// partial_contraction_pallas (body _partial_kernel, contraction
// _tiled_contraction).  Inputs: spikes x (B, n_in) uint8 holding 0 or 1,
// the shard's enables en (B, n_out) uint8 and its codes as two int8
// planes wp (2, n_out, n_in), w = 2 * hi + lo with hi = wp[0] = w >> 1 and
// lo = wp[1] = w & 1, each column's K values contiguous.  B is a multiple
// of 8, both widths of 128.  Only the first n_valid columns of the shard
// are real; the planes are zero beyond them.  Outputs: current (B, n_out)
// int32 and skipped (B / 8,) int32, the 128x128 tile pairs skipped per
// 8-lane block (zeroed by the caller; this kernel adds to it).
//
// Function: with sparse_skip, a (K tile, N tile) pair is skipped when the
// 8-lane block has no spike in the K tile or no enabled neuron in the N
// tile; a skipped pair adds nothing and counts once.  A dead N tile
// therefore leaves the block's raw currents at 0 where the dense product
// would not.
//
// Why int8 tensor cores are exact here: every 9-bit code w in [-256, 255]
// splits into hi = w >> 1 in [-128, 127] and lo = w & 1 in {0, 1}, both
// int8, and spikes are 0 or 1.  mma.sync accumulates each plane's products
// in s32: |sum hi * x| <= 128 * n_in < 2^31 for any n_in the entry
// accepts, so neither sum rounds or overflows, and 2 * acc_hi + acc_lo
// (taken in unsigned arithmetic, so a sum would wrap as int32 does) is
// sum w * x exactly.
//
// What bounds it on an H100: at the WIDE serving shard (1,024 lanes,
// 2048 -> 512) the function moves about 6.8 MB (2.0 us at 3.35 TB/s) and,
// as a dense product of the two planes, does 2 * B * K * N * 2 = 4.29 G
// int8 operations (2.2 us at the 1,979 T/s int8 tensor-core rate): about
// 2.2 us in all.  The executed adds alone (spikes x columns) would take
// 6.7 us at the INT32 rate, so the tensor cores, not the event-driven
// scalar adds, are the short way.  At about 10% input density nearly every
// 32-deep K step of a 16-lane tile holds a spike, so skipping empty steps
// would save nothing and the kernel does the dense product.
//
// What the design does about it: a grid of B/BM x N/BN blocks reads the
// planes B/BM times and the spikes N/BN times from L2, so a block owns a
// large tile, 128 lanes x 64 columns (16 warps of 32 x 16, four per
// scheduler, each with two s32 accumulator sets, hi and lo, of 2 x 2
// m16n8k32 tiles): 32 MB from L2 at 1,024 x 2048 -> 512, where 64 x 64
// tiles read 50 MB.  While those tiles make fewer than one block per SM,
// K is split over the 2 to 8 blocks of a thread-block cluster (2 for a
// 512-column shard, so 128 blocks, one wave; 8 for the replicated head).
// Each block walks its slice one 128-deep K tile a stage through a 5-stage
// cp.async ring (32 KB a stage: the spike tile and both plane tiles); the
// enables' loads wait in registers until the loop ends.  Fragments come
// from shared memory by ldmatrix, rows swizzled (16-byte piece c of row r
// at piece c ^ (r % 8)) against bank conflicts, straight into the MMA's
// register order.  Each slice sends its partial tile to the cluster peer
// that owns those rows through distributed shared memory; after one
// cluster barrier every block sums its rows and writes every column of its
// tile: no atomics, no memset.  Only n8 tiles below ceil(n_valid / 8) * 8
// are loaded and multiplied; the rest of the output is written as 0.
//
// What still holds it back: each stage issues 2,048 16-byte cp.async per
// SM beside its ldmatrix and MMA issue, mma.sync int8 runs well under the
// tensor cores' peak, and the cluster epilogue and the caller's zeroing
// of the skip counts add a few microseconds.  Bulk (TMA) copies, wgmma
// and a persistent grid are the next steps.
//
// The tile skip at 8-lane granularity: an m16 fragment spans two 8-lane
// blocks, so a dead N tile is a per-(8-lane block, N tile) mask applied in
// the epilogue.  Each block that holds an N tile's first 64 columns counts
// its K slice's skips per 8-lane block: the slice's K tiles if the N tile
// is dead, else those K tiles less the ones in which a lane of the block
// spikes (from ballots over the staged spike tile); an integer atomicAdd
// sums the slices and N tiles.
//
// Why mma.sync and not wgmma: the whole function is about 2 us of work at
// the tensor cores' full rate, and the warp-level instruction needs no
// warpgroup-wide shared-memory layout or descriptors, so it was the
// smaller first step; at these tile sizes it is not what sets this
// kernel's time today.
//
// A trap met here: nvcc 12.9 compiled `n = clamp(x, 0, 2); if (n == 2) ..
// else if (n == 1) ..` so that the n == 2 branch never ran; the dispatch
// compares the column count directly.
#include <cooperative_groups.h>

#include "mma_common.cuh"
#include "snn_stack_common.cuh"

namespace cg = cooperative_groups;

#define PC_THREADS 512  // 16 warps, 4 (lanes) x 4 (columns)
#define PC_BM 128       // lanes per block
#define PC_BN 64        // columns per block: half an N tile
#define PC_BK TILE      // K bytes per stage: one K tile
#define PC_STAGES 5
#define PC_MAX_SPLIT 8  // K slices, the blocks of one cluster
#define PC_LB (PC_BM / BLOCK_B)  // 8-lane blocks per block
#define PC_LD (PC_BN + 4)        // ints per row of a received partial tile

// A stage: the spike tile and both plane tiles of one K tile, rows of 128
// bytes.  The 16-byte piece c of row r sits at piece c ^ (r % 8), so the
// eight rows of one ldmatrix 8x8 matrix touch all 32 banks once.  After
// the stages, each block holds the partial tiles its cluster peers send.
struct PcStage {
  uint8_t x[PC_BM][PC_BK];
  int8_t w[2][PC_BN][PC_BK];
};
#define PC_SMEM (PC_STAGES * (int)sizeof(PcStage) + PC_BM * PC_LD * 4)

// One stage of a warp's 32 x (8 * NA) tile: four k32 steps, each one
// ldmatrix.x4 per m16 tile of spikes (its four A registers in MMA order)
// and one per n8 tile of planes (hi's two B registers, then lo's), then
// one MMA per (plane, m16, n8).  a_row* / b_row* are the shared addresses
// of this lane's rows, a_hi / b_hi which 16-byte half of a k32 step it
// addresses, l7 its row's swizzle.
template <int NA>
__device__ __forceinline__ void pc_stage_mma(int (&acc)[2][2][2][4],
                                             unsigned a_row0, unsigned a_row1,
                                             unsigned b_row0, unsigned b_row1,
                                             int a_hi, int b_hi, int l7) {
#pragma unroll
  for (int kk = 0; kk < PC_BK / 32; ++kk) {
    unsigned a[2][4], b[2][4];
    ldsm_x4(a[0], a_row0 + (((2 * kk + a_hi) ^ l7) << 4));
    ldsm_x4(a[1], a_row1 + (((2 * kk + a_hi) ^ l7) << 4));
    ldsm_x4(b[0], b_row0 + (((2 * kk + b_hi) ^ l7) << 4));
    if (NA > 1) ldsm_x4(b[1], b_row1 + (((2 * kk + b_hi) ^ l7) << 4));
#pragma unroll
    for (int ni = 0; ni < NA; ++ni)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_s8(acc[p][mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                 b[ni][2 * p], b[ni][2 * p + 1]);
  }
}

__global__ void __launch_bounds__(PC_THREADS, 1)
    partial_contraction_kernel(const uint8_t* __restrict__ x,
                               const uint8_t* __restrict__ en,
                               const int8_t* __restrict__ wp,
                               int32_t* __restrict__ cur,
                               int32_t* __restrict__ skipped, int B,
                               int n_in, int n_out, int n_cols,
                               int sparse_skip) {
  extern __shared__ __align__(16) uint8_t pc_smem[];
  PcStage* stage = (PcStage*)pc_smem;
  int* recv = (int*)(pc_smem + PC_STAGES * sizeof(PcStage));
  __shared__ int live_n[PC_LB];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * PC_BM, col0 = blockIdx.y * PC_BN;
  const int nkt = n_in / TILE;
  const int kt0 = rank * nkt / split, kts = (rank + 1) * nkt / split - kt0;

  // The copies: thread t moves 16-byte piece t % 8 of spike rows t / 8 and
  // t / 8 + 64 and of plane row t / 8 of each plane; a row past B or
  // n_cols is filled with zeros and read from nowhere.
  const int piece = t & 7, rsub = t >> 3;
  const int dst = rsub * PC_BK + ((piece ^ (rsub & 7)) << 4);  // +64 alike
  const size_t step64 = (size_t)64 * n_in, plane = (size_t)n_out * n_in;
  const uint8_t* xb = x + (size_t)(row0 + rsub) * n_in + piece * 16;
  const int8_t* wb = wp + (size_t)(col0 + rsub) * n_in + piece * 16;
  const bool okx0 = row0 + rsub < B, okx1 = row0 + rsub + 64 < B;
  const bool okw = col0 + rsub < n_cols;
  auto load = [&](int s, int buf) {
    const size_t k = (size_t)(kt0 + s) * TILE;
    uint8_t* sx = &stage[buf].x[0][0] + dst;
    int8_t* sw = &stage[buf].w[0][0][0] + dst;
    cp_async16_zfill(sx, okx0 ? (const void*)(xb + k) : x, okx0);
    cp_async16_zfill(sx + 64 * PC_BK,
                     okx1 ? (const void*)(xb + step64 + k) : x, okx1);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      cp_async16_zfill(sw + p * PC_BN * PC_BK,
                       okw ? (const void*)(wb + p * plane + k) : wp, okw);
  };
#pragma unroll
  for (int s = 0; s < PC_STAGES - 1; ++s) {
    if (s < kts) load(s, s);
    cp_async_commit();
  }

  // The enables of this block's N tile, read now and tested after the K
  // loop: thread t reads a quarter of lane row t / 4, so warp w covers
  // 8-lane block w.
  const int nt0 = col0 / TILE * TILE;
  const bool counts_skips = sparse_skip && col0 == nt0;
  uint4 en_v[2] = {};
  if (sparse_skip && row0 + (t >> 2) < B) {
    const uint4* p = (const uint4*)(en + (size_t)(row0 + (t >> 2)) * n_out +
                                    nt0 + (t & 3) * 32);
    en_v[0] = __ldg(p);
    en_v[1] = __ldg(p + 1);
  }

  // Warp tile: lanes wm * 32 + [0, 32), columns wn * 16 + [0, 16); n8
  // tiles from n_cols on are neither loaded nor multiplied.
  const int wm = warp >> 2, wn = warp & 3;
  const int cols_left = n_cols - col0 - wn * 16;  // a multiple of 8
  // ldmatrix rows: lane L addresses row L % 8 of matrix L / 8; for spikes
  // matrices 0-3 are (rows 0-7, 8-15) x (K bytes 0-15, 16-31) of an m16
  // tile, for planes (hi, lo) x (K bytes 0-15, 16-31) of an n8 tile.
  const int l7 = lane & 7, a_hi = lane >> 4, b_hi = (lane >> 3) & 1;
  unsigned a_row[2], b_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a_row[i] = (wm * 32 + i * 16 + l7 + ((lane >> 3) & 1) * 8) * PC_BK;
    b_row[i] = ((lane >> 4) * PC_BN + wn * 16 + i * 8 + l7) * PC_BK;
  }
  int acc[2][2][2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][mi][ni][j] = 0;

  // live_k: K tiles of this slice in which 8-lane block `warp` spikes,
  // from the staged spike tile.
  int live_k = 0;
  for (int s = 0; s < kts; ++s) {
    cp_async_wait<PC_STAGES - 2>();
    __syncthreads();  // stage s has landed; stage s - 1 is free to refill
    if (s + PC_STAGES - 1 < kts)
      load(s + PC_STAGES - 1, (s + PC_STAGES - 1) % PC_STAGES);
    cp_async_commit();
    const PcStage& st = stage[s % PC_STAGES];

    if (counts_skips) {  // lane l reads piece l % 8 of rows 8w + l/8 + 4i
      unsigned any = 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 v = *(const uint4*)&st.x[8 * warp + (lane >> 3) + 4 * i]
                                           [(lane & 7) * 16];
        any |= v.x | v.y | v.z | v.w;
      }
      live_k += __any_sync(FULL_MASK, any != 0);
    }

    const unsigned sx = (unsigned)__cvta_generic_to_shared(&st.x[0][0]);
    const unsigned sw = (unsigned)__cvta_generic_to_shared(&st.w[0][0][0]);
    if (cols_left >= 16)
      pc_stage_mma<2>(acc, sx + a_row[0], sx + a_row[1], sw + b_row[0],
                      sw + b_row[1], a_hi, b_hi, l7);
    else if (cols_left >= 8)
      pc_stage_mma<1>(acc, sx + a_row[0], sx + a_row[1], sw + b_row[0],
                      sw + b_row[1], a_hi, b_hi, l7);
  }
  cp_async_wait<0>();

  {
    unsigned on = sparse_skip ? 0u : 1u;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      on |= en_v[i].x | en_v[i].y | en_v[i].z | en_v[i].w;
    const bool live = __any_sync(FULL_MASK, on != 0);
    if (lane == 0) live_n[warp] = live;
    const int c = live ? kts - live_k : kts;
    if (counts_skips && lane == 0 && row0 + warp * BLOCK_B < B && c)
      atomicAdd(&skipped[row0 / BLOCK_B + warp], c);
  }
  __syncthreads();

  // This slice's partial tile, 2 * acc_hi + acc_lo in unsigned arithmetic
  // and zero for a dead (8-lane block, N tile) pair, goes to the cluster
  // peer that owns its rows (rows rank' * R + [0, R) to peer rank', R =
  // 128 / split), into the slot of this slice.  Element j of an m16n8
  // tile sits at row g (j < 2) or g + 8, column 2 * tig + (j & 1); n8
  // tiles never multiplied send 0.
  const int R = PC_BM / split;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * 32 + mi * 16 + h * 8 + g;
      const bool live = live_n[rl / BLOCK_B] != 0;
      int* row = cluster.map_shared_rank(recv, rl / R) +
                 (rank * R + rl % R) * PC_LD + wn * 16 + 2 * tig;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        int v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const unsigned hi = (unsigned)acc[0][mi][ni][2 * h + j];
          const unsigned lo = (unsigned)acc[1][mi][ni][2 * h + j];
          v[j] = live ? (int)(2u * hi + lo) : 0;
        }
        *(int2*)(row + ni * 8) = make_int2(v[0], v[1]);
      }
    }
  }
  // Every slice has arrived: sum the slots of this block's rows in
  // unsigned arithmetic (exact in any order) and write them, every column
  // of the tile.  Nothing reads or writes a peer's memory after this.
  cluster.sync();
  for (int e = t; e < R * (PC_BN / 4); e += PC_THREADS) {
    const int r = e / (PC_BN / 4), c = e % (PC_BN / 4) * 4;
    uint4 sum = make_uint4(0, 0, 0, 0);
    for (int z = 0; z < split; ++z) {
      const uint4 v = *(const uint4*)&recv[(z * R + r) * PC_LD + c];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int row = row0 + rank * R + r;
    if (row < B) *(uint4*)&cur[(size_t)row * n_out + col0 + c] = sum;
  }
  // the last column tile also zeroes the columns no tile computes
  const int c_end = (blockIdx.y + 1) * PC_BN;
  if (blockIdx.y + 1 == gridDim.y && c_end < n_out) {
    const int w4 = (n_out - c_end) / 4;
    for (int e = t; e < R * w4; e += PC_THREADS) {
      const int row = row0 + rank * R + e / w4;
      if (row < B)
        *(uint4*)&cur[(size_t)row * n_out + c_end + e % w4 * 4] =
            make_uint4(0, 0, 0, 0);
    }
  }
}

// ---- C interface (loaded with ctypes) -------------------------------------
// ptrs: x (B, n_in) u8 of 0 / 1, en (B, n_out) u8, wp (2, n_out, n_in) i8,
//       cur (B, n_out) i32, skipped (B / 8,) i32 (zero-filled), all
//       contiguous and 16-byte aligned;
// ints: B, n_in, n_out, sparse_skip, n_valid (n_out - 128 < n_valid <=
//       n_out; the planes' columns from n_valid on are zero).
// Returns the cudaError_t of the launch.
extern "C" int repro_partial_contraction(const void* ptrs_v, int n_ptrs,
                                         const void* ints_v, int n_ints,
                                         void* stream) {
  void* const* ptrs = (void* const*)ptrs_v;
  const int* ints = (const int*)ints_v;
  if (n_ptrs != 5 || n_ints != 5) return (int)cudaErrorInvalidValue;
  const int B = ints[0], n_in = ints[1], n_out = ints[2], n_valid = ints[4];
  if (B <= 0 || B % BLOCK_B || n_in <= 0 || n_in % TILE || n_in > 65535 ||
      n_out <= 0 || n_out % TILE || n_valid <= n_out - TILE ||
      n_valid > n_out || n_out / TILE > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i)
    if (ptrs[i] == nullptr || (uintptr_t)ptrs[i] % 16)
      return (int)cudaErrorInvalidValue;
  const int n_cols = (n_valid + 7) / 8 * 8;
  static int smem_cap[MAX_DEVICES] = {};
  cudaError_t e = raise_smem_cap((const void*)partial_contraction_kernel,
                                 PC_SMEM, smem_cap);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  // Split K over a cluster of up to 8 blocks while the tiles make fewer
  // than one block per SM.
  const int col_tiles = (n_cols + PC_BN - 1) / PC_BN;
  const int tiles = (B + PC_BM - 1) / PC_BM * col_tiles;
  int split = 1;
  while (2 * split <= PC_MAX_SPLIT && 2 * split <= n_in / TILE &&
         2 * split * tiles <= sms)
    split *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + PC_BM - 1) / PC_BM, col_tiles, split);
  cfg.blockDim = dim3(PC_THREADS);
  cfg.dynamicSmemBytes = PC_SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = split;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, partial_contraction_kernel,
                         (const uint8_t*)ptrs[0], (const uint8_t*)ptrs[1],
                         (const int8_t*)ptrs[2], (int32_t*)ptrs[3],
                         (int32_t*)ptrs[4], B, n_in, n_out, n_cols, ints[3]);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
