// One integer LIF layer over a materialised spike train: T steps from
// fresh state (membranes at v_rest, every neuron enabled).
//
// Replaces the TPU kernel repro/kernels/lif_step.py::lif_forward_pallas
// (body _lif_kernel), the per-layer stage of the staged backend.  Inputs:
// spikes uint8 (T, B, K) and int16 weight codes (K, N); outputs: the
// fired spikes uint8 and the membrane trace int32, (T, B, N), and the
// final membrane (B, N).  Each step's current is sum s * w over the step's
// spike bytes by value, as the JAX body's dot of s_t.astype(int32) with
// the codes: a byte of 2 adds its code twice.  It takes any int16 code,
// not only the paper's signed 9-bit range: this is the backend for wider
// codes.  The current and the membrane add wrap in 32 bits, as the
// reference's int32 dot and add do.
//
// What bounds it on an H100: the contraction does not depend on the
// membranes (the JAX body takes the dense dot, then masks it with the
// enables), so each step is a dense (lanes x K) x (K x N) product and the
// LIF update an epilogue on it.  As a product of the codes' two byte
// planes on the int8 tensor cores that is 2 * T * B * K * N * 2
// operations: 343.6 G, 173.6 us at 1,979 T/s, at (T = 20, B = 1,024,
// 2048 -> 2048), against 80.1 us for the 268 MB the function moves (its
// int32 trace is most of them).  So the tensor cores bound it.
//
// The design: the tile of spike_mma.cuh, which the spike matmul uses too:
// a block of 16 warps owns 128 lanes x 128 columns for all T steps, each
// warp 64 x 16 with two s32 accumulator sets (hi and lo planes of the
// codes, split in registers, so any int16 code is exact).  The block walks
// (step, K tile) pairs in one flat sequence through a 3-stage cp.async
// ring (48 KB a stage), so the ring never drains between steps.  After a
// step's last K tile, the m16n8k32 accumulator layout gives each thread
// the same 32 (lane, column) positions at every step: it combines
// (acc_hi << 8) + acc_lo, applies lif_update (snn_stack_common.cuh) with
// its enables as bits of one register, keeps its membranes in shared
// memory (slot-major, 64 KB), and stores the step's spikes and trace.
//
// Narrow layers: where the 128 x 128 tiles make too few blocks for the
// card (the head of 784 -> 16384 -> 10 is K = 16,384 over one padded
// 128-column tile: 8 blocks for 20 steps of a 16,384-deep product), K is
// split over a thread-block cluster of 4 or 8 blocks, each a contiguous
// slice of K tiles.  At each step's end every slice sends its combined
// partial tile through distributed shared memory to the peer that owns
// those rows (128 / split rows a peer); after a cluster barrier each peer
// sums its rows' slices in unsigned arithmetic (exact in any order) and
// runs the LIF update on them, with coalesced 16-byte trace stores.  A
// split barrier (arrive after reading, wait before the next step's sends)
// keeps a peer from overwriting partials still being read.
//
// Where trouble was expected, and what the design does:
//  1. Narrow N over a long K: the cluster K split above, chosen at launch
//     from the cluster occupancy of the card.
//  2. K not a multiple of the K tile: the spike pieces and code rows from
//     K on are zero-filled in the ring (cp.async src-size 0); no copy of
//     the (T, B, K) train.  cp.async needs 16-byte aligned rows, so K is a
//     multiple of 16 (the op pads it only where it is not).
//  3. Lanes not a multiple of 128: rows past B are zero-filled and never
//     stored.
//  4. Registers: __launch_bounds__(512, 1), so ptxas may use 128; the
//     copies take 32-bit offsets within a step (the C entry checks the
//     sizes); the step's base is a 64-bit product taken per copy.
//  5. Wrap: neither plane's s32 sum saturates (no .satfinite), so a sum
//     over K > 65,536 full-scale codes wraps modulo 2^32 exactly as the
//     plain version's _wrap32 does.
//
// wgmma, TMA copies and one weight read serving several steps are the
// next steps; each step reads the block's codes again from L2.
#include <cooperative_groups.h>

#include "spike_mma.cuh"

namespace cg = cooperative_groups;

#define LIF_STAGES 3
#define LIF_SLOTS 32             // membranes per thread without a split
#define LIF_LD (SM_BN + 4)       // ints per row of a received partial tile
#define LIF_RING (LIF_STAGES * (int)sizeof(SmStage))

// Shared memory: the ring, then without a split each thread's 32
// membranes; with a split the partial tiles the peers send (128 rows) and
// the membranes of this block's 128 / split rows.
constexpr int lif_smem_bytes(int split) {
  return split == 1 ? LIF_RING + LIF_SLOTS * SM_THREADS * 4
                    : LIF_RING + SM_BM * LIF_LD * 4 +
                          SM_BM / split * SM_BN * 4;
}

struct LifParams {
  const uint8_t* spikes;  // (T, B, K)
  const int16_t* w;       // (K, N)
  uint8_t* spk_out;       // (T, B, N)
  int32_t* vtr;           // (T, B, N)
  int32_t* vfin;          // (B, N)
  int T, B, K, N, pruning;
  LifConsts lc;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One LIF update of an enabled-or-not neuron; clears its enable bit when
// it fires under pruning.
__device__ __forceinline__ int lif_bit(int v_old, int cur, unsigned& en,
                                       int bit, const LifConsts lc,
                                       int pruning, bool* fired) {
  const bool e = (en >> bit) & 1u;
  const int v = lif_update(v_old, e ? cur : 0, e, lc, fired);
  if (pruning && *fired) en &= ~(1u << bit);
  return v;
}

template <int kSplit>
__global__ void __launch_bounds__(SM_THREADS, 1)
    lif_forward_kernel(const __grid_constant__ LifParams p) {
  extern __shared__ __align__(16) uint8_t lif_smem[];
  SmStage* stage = (SmStage*)lif_smem;
  constexpr int R = SM_BM / kSplit;  // rows whose LIF update this block runs
  int* recv = (int*)(lif_smem + LIF_RING);                  // kSplit > 1
  int* vs = kSplit == 1 ? recv : recv + SM_BM * LIF_LD;     // membranes
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 3, wn = warp & 7;
  const int row0 = blockIdx.x * SM_BM, col0 = blockIdx.y * SM_BN;
  int rank = 0;
  if constexpr (kSplit > 1) rank = (int)cg::this_cluster().block_rank();
  const int nkt = (p.K + SM_BK - 1) / SM_BK;
  const int kt0 = rank * nkt / kSplit;
  const int kts = (rank + 1) * nkt / kSplit - kt0;  // this slice's K tiles
  const int total = p.T * kts;

  // Copies walk the (step, K tile) pairs of this slice in order, one
  // stage ahead of the ring's consumer by LIF_STAGES - 1.
  const SmCopy cp = sm_copy_init(t, row0, col0, p.B, p.K, p.N);
  int li = 0, lt = 0, lk = 0, lbuf = 0;
  auto fetch = [&]() {
    if (li < total) {
      sm_load<true>(stage[lbuf], cp, p.spikes + (size_t)lt * p.B * p.K, p.w,
                    (unsigned)(kt0 + lk) * SM_BK, p.K, p.N);
      if (++lk == kts) {
        lk = 0;
        ++lt;
      }
    }
    ++li;
    lbuf = lbuf + 1 == LIF_STAGES ? 0 : lbuf + 1;
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < LIF_STAGES - 1; ++s) fetch();

  if constexpr (kSplit == 1) {
#pragma unroll
    for (int slot = 0; slot < LIF_SLOTS; ++slot)
      vs[slot * SM_THREADS + t] = p.lc.v_rest;
  } else {
    for (int e = t; e < R * SM_BN; e += SM_THREADS) vs[e] = p.lc.v_rest;
    cg::this_cluster().sync();  // every peer runs: it takes remote writes
  }
  unsigned en = ~0u;  // bit i: this thread's i-th neuron is enabled

  const SmFrag f = sm_frag_init(warp, lane);
  int buf = 0;
  for (int step = 0; step < p.T; ++step) {
    SmAcc acc;
    sm_acc_zero(acc);
    for (int k = 0; k < kts; ++k) {
      cp_async_wait<LIF_STAGES - 2>();  // this thread's copies landed
      __syncthreads();  // the stage is complete; the one before it is free
      fetch();
      sm_stage_mma(acc, stage[buf], f);
      buf = buf + 1 == LIF_STAGES ? 0 : buf + 1;
    }

    if constexpr (kSplit == 1) {
      // Slot ((mi * 2 + h) * SM_NA + ni) * 2 + j is element 2 * h + j of
      // m16n8 tile (mi, ni): row g + 8 * h, column 2 * tig + j.
#pragma unroll
      for (int mi = 0; mi < SM_MI; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + (wm * SM_MI + mi) * 16 + h * 8 + g;
          const size_t o = ((size_t)step * p.B + row) * p.N + col0 +
                           wn * 16 + 2 * tig;
#pragma unroll
          for (int ni = 0; ni < SM_NA; ++ni) {
            int vn[2];
            unsigned fb = 0;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int slot = ((mi * 2 + h) * SM_NA + ni) * 2 + j;
              bool fired;
              vn[j] = lif_bit(vs[slot * SM_THREADS + t],
                              sm_combine(acc[0][mi][ni][2 * h + j],
                                         acc[1][mi][ni][2 * h + j]),
                              en, slot, p.lc, p.pruning, &fired);
              vs[slot * SM_THREADS + t] = vn[j];
              fb |= (unsigned)fired << (8 * j);
            }
            if (row < p.B) {
              *(int2*)(p.vtr + o + ni * 8) = make_int2(vn[0], vn[1]);
              *(uint16_t*)(p.spk_out + o + ni * 8) = (uint16_t)fb;
            }
          }
        }
      }
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      if (step > 0) cluster_wait();  // the peers have read step - 1's slices
      // This slice's partial of block row rl goes to peer rl / R, into the
      // slot of this slice: row rank * R + rl % R of its recv.
#pragma unroll
      for (int mi = 0; mi < SM_MI; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = (wm * SM_MI + mi) * 16 + h * 8 + g;
          int* dst = cluster.map_shared_rank(recv, rl / R) +
                     (rank * R + rl % R) * LIF_LD + wn * 16 + 2 * tig;
#pragma unroll
          for (int ni = 0; ni < SM_NA; ++ni)
            *(int2*)(dst + ni * 8) =
                make_int2(sm_combine(acc[0][mi][ni][2 * h],
                                     acc[1][mi][ni][2 * h]),
                          sm_combine(acc[0][mi][ni][2 * h + 1],
                                     acc[1][mi][ni][2 * h + 1]));
        }
      }
      cluster.sync();  // every slice has arrived
      // Rows rank * R + [0, R) of the block, four columns a thread a pass.
#pragma unroll
      for (int i = 0; i < R * SM_BN / 4 / SM_THREADS; ++i) {
        const int e = i * SM_THREADS + t;
        const int r = e / (SM_BN / 4), c = e % (SM_BN / 4) * 4;
        uint4 sum = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int z = 0; z < kSplit; ++z) {
          const uint4 v = *(const uint4*)&recv[(z * R + r) * LIF_LD + c];
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        int4 v = *(int4*)&vs[r * SM_BN + c];
        bool fd[4];
        v.x = lif_bit(v.x, (int)sum.x, en, 4 * i, p.lc,
                      p.pruning, &fd[0]);
        v.y = lif_bit(v.y, (int)sum.y, en, 4 * i + 1, p.lc,
                      p.pruning, &fd[1]);
        v.z = lif_bit(v.z, (int)sum.z, en, 4 * i + 2, p.lc,
                      p.pruning, &fd[2]);
        v.w = lif_bit(v.w, (int)sum.w, en, 4 * i + 3, p.lc,
                      p.pruning, &fd[3]);
        *(int4*)&vs[r * SM_BN + c] = v;
        const int row = row0 + rank * R + r;
        if (row < p.B) {
          const size_t o = ((size_t)step * p.B + row) * p.N + col0 + c;
          *(int4*)(p.vtr + o) = v;
          *(uint32_t*)(p.spk_out + o) =
              (unsigned)fd[0] | (unsigned)fd[1] << 8 |
              (unsigned)fd[2] << 16 | (unsigned)fd[3] << 24;
        }
      }
      cluster_arrive();  // done reading this step's slices
    }
  }
  cp_async_wait<0>();

  if constexpr (kSplit == 1) {
#pragma unroll
    for (int mi = 0; mi < SM_MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + (wm * SM_MI + mi) * 16 + h * 8 + g;
        if (row >= p.B) continue;
        int32_t* o = p.vfin + (size_t)row * p.N + col0 + wn * 16 + 2 * tig;
#pragma unroll
        for (int ni = 0; ni < SM_NA; ++ni) {
          const int slot = ((mi * 2 + h) * SM_NA + ni) * 2;
          *(int2*)(o + ni * 8) = make_int2(vs[slot * SM_THREADS + t],
                                           vs[(slot + 1) * SM_THREADS + t]);
        }
      }
  } else {
    if (p.T > 0) cluster_wait();  // pairs the last arrive; no peer reads on
    for (int e = t; e < R * SM_BN / 4; e += SM_THREADS) {
      const int r = e / (SM_BN / 4), c = e % (SM_BN / 4) * 4;
      const int row = row0 + rank * R + r;
      if (row < p.B)
        *(int4*)(p.vfin + (size_t)row * p.N + col0 + c) =
            *(const int4*)&vs[r * SM_BN + c];
    }
  }
}

// Let lif_forward_kernel<kSplit> use its shared memory on this device.
template <int kSplit>
static cudaError_t raise_cap() {
  static int smem_cap[MAX_DEVICES] = {};
  return raise_smem_cap((const void*)lif_forward_kernel<kSplit>,
                        lif_smem_bytes(kSplit), smem_cap);
}

// How many clusters of kSplit blocks the card holds at once.
template <int kSplit>
static cudaError_t clusters_that_fit(int* n) {
  cudaError_t e = raise_cap<kSplit>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, kSplit);
  cfg.blockDim = dim3(SM_THREADS);
  cfg.dynamicSmemBytes = lif_smem_bytes(kSplit);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = kSplit;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(
      n, (const void*)lif_forward_kernel<kSplit>, &cfg);
}

// The K split of a launch: the larger of 8 and 4 whose clusters all
// fit the card at once and leave every slice at least two K tiles a step,
// else 1.  The card's cluster occupancy is asked once per device and split.
static cudaError_t choose_split(int tiles, int nkt, int* split) {
  static std::mutex mu;
  static int fits[MAX_DEVICES][2] = {};  // clusters of 8 and 4 held, + 1
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  *split = 1;
  for (int i = 0; i < 2; ++i) {
    const int c = 8 >> i;
    if (nkt < 2 * c) continue;
    if (!fits[dev][i]) {
      int n = 0;
      err = c == 8 ? clusters_that_fit<8>(&n) : clusters_that_fit<4>(&n);
      if (err != cudaSuccess) return err;
      fits[dev][i] = n + 1;
    }
    if (tiles <= fits[dev][i] - 1) {
      *split = c;
      break;
    }
  }
  return cudaSuccess;
}

template <int kSplit>
static cudaError_t launch_split(const LifParams& p, cudaStream_t stream) {
  cudaError_t e = raise_cap<kSplit>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.B + SM_BM - 1) / SM_BM, p.N / SM_BN, kSplit);
  cfg.blockDim = dim3(SM_THREADS);
  cfg.dynamicSmemBytes = lif_smem_bytes(kSplit);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = kSplit;
  cfg.attrs = &attr;
  cfg.numAttrs = kSplit > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, lif_forward_kernel<kSplit>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---- C interface (loaded with ctypes) -------------------------------------
// ptrs: spikes (T, B, K) u8, w (K, N) i16, spk_out (T, B, N) u8, vtr
//       (T, B, N) i32, vfin (B, N) i32, all contiguous and 16-byte aligned;
// ints: T, B, K, N, decay_shift, v_th, v_rest, v_min, v_max, pruning.
// B must be a multiple of 8, K of 16 and N of 128, with (B + 128) * K and
// K * N below 2^32.  Returns the cudaError_t of the launch.
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
  if (p.T < 0 || p.B <= 0 || p.B % BLOCK_B || p.K < 0 || p.K % 16 ||
      p.N <= 0 || p.N % SM_BN || p.N / SM_BN > 65535 ||
      (long long)(p.B + SM_BM) * p.K >= (1ll << 32) ||
      (long long)p.K * p.N >= (1ll << 32))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i)
    if ((uintptr_t)ptrs[i] % 16) return (int)cudaErrorInvalidValue;
  const int tiles = (p.B + SM_BM - 1) / SM_BM * (p.N / SM_BN);
  int split = 1;
  cudaError_t e = choose_split(tiles, (p.K + SM_BK - 1) / SM_BK, &split);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  if (split == 8) return (int)launch_split<8>(p, s);
  if (split == 4) return (int)launch_split<4>(p, s);
  return (int)launch_split<1>(p, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
