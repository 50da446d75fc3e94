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
// The readout instantiation (kReadout), for the staged call: the same
// product and LIF update, and the call's readouts in the epilogue, so that
// nothing outside the kernels reads a (T, B, N) train.  Each thread keeps
// its neurons' peak membrane over T in shared memory beside the membranes
// (the ring drops to two stages to make room); without a split a slot's
// membrane and peak sit side by side, one 8-byte load and store a neuron.
// At each step's end the block tallies, over the valid rows (< b_valid)
// and columns (< n_valid), the fired neurons of each lane (the next
// layer's input spike count) and, under pruning, the enabled ones at the
// step's start, in shared memory per row, and per 8-lane block whether
// its 128-column tile holds a spike or an enabled neuron; the 16 column
// blocks of a row combine these by integer atomics in device memory
// (exact in any order).  Without a split the tallies alternate between
// two buffers by step, and four warps flush step s's after the next
// step's first ring barrier, so the epilogue adds no barrier.  The last
// layer also writes its trace, and at the end re-reads its own spike
// bytes (written by the same thread) for each neuron's count and first
// spike.  Hidden layers write no trace and no final membrane.
//
// wgmma, TMA copies and one weight read serving several steps are the
// next steps; each step reads the block's codes again from L2.
#include <cooperative_groups.h>

#include "spike_mma.cuh"

namespace cg = cooperative_groups;

#define LIF_SLOTS 32             // membranes per thread without a split
#define LIF_LD (SM_BN + 4)       // ints per row of a received partial tile
#define LIF_SCRATCH (2 * SM_BM + 1)  // readout tallies: 2 per row, flags

// Ring stages: three, or two where the peaks take the third's room.
__host__ __device__ constexpr int lif_stages(bool readout) {
  return readout ? 2 : 3;
}

// Shared memory: the ring, then without a split each thread's 32
// membranes; with a split the partial tiles the peers send (128 rows) and
// the membranes of this block's 128 / split rows.  The readout
// instantiation adds as many peaks as membranes and its tallies.
constexpr int lif_smem_bytes(int split, bool readout) {
  return lif_stages(readout) * (int)sizeof(SmStage) +
         (split == 1 ? 0 : SM_BM * LIF_LD * 4) +
         (split == 1 ? LIF_SLOTS * SM_THREADS : SM_BM / split * SM_BN) * 4 *
             (readout ? 2 : 1) +
         (readout ? 2 * LIF_SCRATCH * 4 : 0);
}

struct LifParams {
  const uint8_t* spikes;  // (T, B, K)
  const int16_t* w;       // (K, N)
  uint8_t* spk_out;       // (T, B, N)
  int32_t* vtr;           // (T, B, N); readout: null for a hidden layer
  int32_t* vfin;          // (B, N); readout: null for a hidden layer
  // readout only: outputs (B, N), and tallies added into (step, lane) rows
  // of stride ld and (step, 8-lane block) rows of stride ldb
  int32_t* vpeak;         // peak membrane over the window
  int32_t* cnt;           // spike count (last layer; else null)
  int32_t* first;         // first spike step, T if none (with cnt)
  int32_t* nspk;          // fired per (step, lane) (null: not tallied)
  int32_t* livek;         // column tiles with a spike per (step, block)
  int32_t* nen;           // enabled per (step, lane) (null without pruning)
  int32_t* liven;         // column tiles with an enabled neuron
  int T, B, K, N, pruning;
  int b_valid, n_valid, ld, ldb;
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

// Readout: one warp's part of a step's tile flags for 8-lane block q
// (bits q and 16 + q): f and e are this thread's fired and enabled valid
// neurons of one row of the block.
__device__ __forceinline__ void tally_block(int* scr, int q, unsigned f,
                                            unsigned e) {
  const bool af = __any_sync(FULL_MASK, f != 0);
  const bool ae = __any_sync(FULL_MASK, e != 0);
  if ((threadIdx.x & 31) == 0 && (af || ae))
    atomicOr((unsigned*)&scr[2 * SM_BM],
             (af ? 1u << q : 0u) | (ae ? 1u << (16 + q) : 0u));
}

// Readout: once every warp has tallied a step (after a barrier), add the
// shared tallies of this block's rows (row0 + [0, 128); with `rows` false
// only the flags) into device memory and clear them for reuse.
__device__ __forceinline__ void tally_flush(const LifParams& p, int* scr,
                                            int step, int row0, bool rows) {
  const int t = threadIdx.x;
  if (rows && t < SM_BM) {
    const int row = row0 + t, a = scr[t], b = scr[SM_BM + t];
    if (row < p.b_valid) {
      if (a && p.nspk) atomicAdd(p.nspk + (size_t)step * p.ld + row, a);
      if (b && p.nen) atomicAdd(p.nen + (size_t)step * p.ld + row, b);
    }
    scr[t] = 0;
    scr[SM_BM + t] = 0;
  }
  if (t < 32) {
    const unsigned f = scr[2 * SM_BM];
    __syncwarp();
    if (t == 0) scr[2 * SM_BM] = 0;
    if (t < SM_BM / BLOCK_B && row0 + t * BLOCK_B < p.b_valid) {
      const size_t o = (size_t)step * p.ldb + row0 / BLOCK_B + t;
      if (p.livek && ((f >> t) & 1u)) atomicAdd(p.livek + o, 1);
      if (p.liven && ((f >> (16 + t)) & 1u)) atomicAdd(p.liven + o, 1);
    }
  }
}

template <int kSplit, bool kReadout>
__global__ void __launch_bounds__(SM_THREADS, 1)
    lif_forward_kernel(const __grid_constant__ LifParams p) {
  constexpr int kStages = lif_stages(kReadout);
  extern __shared__ __align__(16) uint8_t lif_smem[];
  SmStage* stage = (SmStage*)lif_smem;
  constexpr int R = SM_BM / kSplit;  // rows whose LIF update this block runs
  constexpr int kMem = kSplit == 1 ? LIF_SLOTS * SM_THREADS : R * SM_BN;
  int* recv = (int*)(lif_smem + kStages * sizeof(SmStage));  // kSplit > 1
  int* vs = kSplit == 1 ? recv : recv + SM_BM * LIF_LD;     // membranes
  int* vp = vs + kMem;   // readout at a split: peaks, as the membranes
  // readout without a split: each slot's membrane and peak side by side
  int2* vpk = (int2*)vs;
  int* scr = vp + kMem;  // readout: 2 x LIF_SCRATCH tallies
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
  // stage ahead of the ring's consumer by kStages - 1.
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
    lbuf = lbuf + 1 == kStages ? 0 : lbuf + 1;
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch();

  if constexpr (kSplit == 1) {
#pragma unroll
    for (int slot = 0; slot < LIF_SLOTS; ++slot) {
      if constexpr (kReadout)
        vpk[slot * SM_THREADS + t] = make_int2(p.lc.v_rest, -2147483647 - 1);
      else
        vs[slot * SM_THREADS + t] = p.lc.v_rest;
    }
  } else {
    for (int e = t; e < R * SM_BN; e += SM_THREADS) {
      vs[e] = p.lc.v_rest;
      if constexpr (kReadout) vp[e] = (-2147483647 - 1);
    }
    cg::this_cluster().sync();  // every peer runs: it takes remote writes
  }
  if constexpr (kReadout) {
    for (int e = t; e < 2 * LIF_SCRATCH; e += SM_THREADS) scr[e] = 0;
    __syncthreads();
  }
  unsigned en = ~0u;  // bit i: this thread's i-th neuron is enabled
  // readout, without a split: bit 2 * ni + j, this thread's column of n8
  // tile ni, element j, is below n_valid
  unsigned vcol = 0;
  if constexpr (kReadout && kSplit == 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      vcol |= (unsigned)(col0 + wn * 16 + (c >> 1) * 8 + 2 * tig + (c & 1) <
                         p.n_valid)
              << c;
  }

  const SmFrag f = sm_frag_init(warp, lane);
  int buf = 0;
  for (int step = 0; step < p.T; ++step) {
    SmAcc acc;
    sm_acc_zero(acc);
    for (int k = 0; k < kts; ++k) {
      cp_async_wait<kStages - 2>();  // this thread's copies landed
      __syncthreads();  // the stage is complete; the one before it is free
      fetch();
      // readout without a split: every warp has tallied step - 1
      if constexpr (kReadout && kSplit == 1)
        if (k == 0 && step > 0)
          tally_flush(p, scr + ((step - 1) & 1) * LIF_SCRATCH, step - 1,
                      row0, true);
      sm_stage_mma(acc, stage[buf], f);
      buf = buf + 1 == kStages ? 0 : buf + 1;
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
          const unsigned en0 = en;  // readout: the enables at step start
          unsigned fm = 0;          // readout: bit 2 * ni + j fired
#pragma unroll
          for (int ni = 0; ni < SM_NA; ++ni) {
            int vn[2];
            unsigned fb = 0;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int slot = ((mi * 2 + h) * SM_NA + ni) * 2 + j;
              const int cur = sm_combine(acc[0][mi][ni][2 * h + j],
                                         acc[1][mi][ni][2 * h + j]);
              bool fired;
              if constexpr (kReadout) {
                int2 m = vpk[slot * SM_THREADS + t];
                vn[j] = lif_bit(m.x, cur, en, slot, p.lc, p.pruning, &fired);
                m.x = vn[j];
                m.y = max(m.y, vn[j]);
                vpk[slot * SM_THREADS + t] = m;
                fm |= (unsigned)fired << (2 * ni + j);
              } else {
                vn[j] = lif_bit(vs[slot * SM_THREADS + t], cur, en, slot,
                                p.lc, p.pruning, &fired);
                vs[slot * SM_THREADS + t] = vn[j];
              }
              fb |= (unsigned)fired << (8 * j);
            }
            if (row < p.B) {
              if (!kReadout || p.vtr)
                *(int2*)(p.vtr + o + ni * 8) = make_int2(vn[0], vn[1]);
              *(uint16_t*)(p.spk_out + o + ni * 8) = (uint16_t)fb;
            }
          }
          if constexpr (kReadout) {
            // the four threads of this row hold its 16 columns of the warp
            const bool live = row < p.b_valid;
            const unsigned fv = live ? fm & vcol : 0u;
            const unsigned ev =
                live ? (en0 >> (4 * (mi * 2 + h))) & 0xFu & vcol : 0u;
            const int rl = row - row0;
            int* sc = scr + (step & 1) * LIF_SCRATCH;
            int nf = __popc(fv);
            nf += __shfl_xor_sync(FULL_MASK, nf, 1);
            nf += __shfl_xor_sync(FULL_MASK, nf, 2);
            if (tig == 0 && nf) atomicAdd(&sc[rl], nf);
            if (p.pruning) {
              int ne = __popc(ev);
              ne += __shfl_xor_sync(FULL_MASK, ne, 1);
              ne += __shfl_xor_sync(FULL_MASK, ne, 2);
              if (tig == 0 && ne) atomicAdd(&sc[SM_BM + rl], ne);
            }
            tally_block(sc, rl / BLOCK_B, fv, ev);
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
        const unsigned en0 = en;  // readout: the enables at step start
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
          if (!kReadout || p.vtr) *(int4*)(p.vtr + o) = v;
          *(uint32_t*)(p.spk_out + o) =
              (unsigned)fd[0] | (unsigned)fd[1] << 8 |
              (unsigned)fd[2] << 16 | (unsigned)fd[3] << 24;
        }
        if constexpr (kReadout) {
          int4 pk = *(int4*)&vp[r * SM_BN + c];
          pk.x = max(pk.x, v.x);
          pk.y = max(pk.y, v.y);
          pk.z = max(pk.z, v.z);
          pk.w = max(pk.w, v.w);
          *(int4*)&vp[r * SM_BN + c] = pk;
          // this warp holds the whole of row r: 32 threads of 4 columns
          unsigned vm = 0;
#pragma unroll
          for (int z = 0; z < 4; ++z)
            vm |= (unsigned)(col0 + c + z < p.n_valid) << z;
          const bool live = row < p.b_valid;
          const unsigned fv =
              live ? ((unsigned)fd[0] | (unsigned)fd[1] << 1 |
                      (unsigned)fd[2] << 2 | (unsigned)fd[3] << 3) & vm
                   : 0u;
          const unsigned ev = live ? (en0 >> (4 * i)) & 0xFu & vm : 0u;
          const int nf = __reduce_add_sync(FULL_MASK, __popc(fv));
          if (lane == 0 && nf && p.nspk)
            atomicAdd(p.nspk + (size_t)step * p.ld + row, nf);
          if (p.pruning) {
            const int ne = __reduce_add_sync(FULL_MASK, __popc(ev));
            if (lane == 0 && ne && p.nen)
              atomicAdd(p.nen + (size_t)step * p.ld + row, ne);
          }
          tally_block(scr, (rank * R + r) / BLOCK_B, fv, ev);
        }
      }
      if constexpr (kReadout) {
        __syncthreads();  // every warp's flags are in
        tally_flush(p, scr, step, row0, false);
        __syncthreads();  // cleared before the next step's
      }
      cluster_arrive();  // done reading this step's slices
    }
  }
  cp_async_wait<0>();

  if constexpr (kSplit == 1) {
    if constexpr (kReadout) {
      __syncthreads();  // every warp has tallied the last step
      if (p.T > 0)
        tally_flush(p, scr + ((p.T - 1) & 1) * LIF_SCRATCH, p.T - 1, row0,
                    true);
    }
#pragma unroll
    for (int mi = 0; mi < SM_MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + (wm * SM_MI + mi) * 16 + h * 8 + g;
        if (row >= p.B) continue;
        const size_t o = (size_t)row * p.N + col0 + wn * 16 + 2 * tig;
#pragma unroll
        for (int ni = 0; ni < SM_NA; ++ni) {
          const int slot = ((mi * 2 + h) * SM_NA + ni) * 2;
          if constexpr (!kReadout)
            *(int2*)(p.vfin + o + ni * 8) =
                make_int2(vs[slot * SM_THREADS + t],
                          vs[(slot + 1) * SM_THREADS + t]);
          if constexpr (kReadout) {
            const int2 m0 = vpk[slot * SM_THREADS + t],
                       m1 = vpk[(slot + 1) * SM_THREADS + t];
            if (p.vfin) *(int2*)(p.vfin + o + ni * 8) = make_int2(m0.x, m1.x);
            *(int2*)(p.vpeak + o + ni * 8) = make_int2(m0.y, m1.y);
            if (p.cnt && ((vcol >> (2 * ni)) & 3u)) {
              int2 c = make_int2(0, 0), fs = make_int2(p.T, p.T);
              for (int s = 0; s < p.T; ++s) {
                const unsigned b = *(const uint16_t*)(
                    p.spk_out + (size_t)s * p.B * p.N + o + ni * 8);
                c.x += b & 0xFFu;
                c.y += b >> 8;
                if ((b & 0xFFu) && fs.x == p.T) fs.x = s;
                if ((b >> 8) && fs.y == p.T) fs.y = s;
              }
              *(int2*)(p.cnt + o + ni * 8) = c;
              *(int2*)(p.first + o + ni * 8) = fs;
            }
          }
        }
      }
  } else {
    if (p.T > 0) cluster_wait();  // pairs the last arrive; no peer reads on
    for (int e = t; e < R * SM_BN / 4; e += SM_THREADS) {
      const int r = e / (SM_BN / 4), c = e % (SM_BN / 4) * 4;
      const int row = row0 + rank * R + r;
      if (row >= p.B) continue;
      const size_t o = (size_t)row * p.N + col0 + c;
      if (!kReadout || p.vfin)
        *(int4*)(p.vfin + o) = *(const int4*)&vs[r * SM_BN + c];
      if constexpr (kReadout) {
        *(int4*)(p.vpeak + o) = *(const int4*)&vp[r * SM_BN + c];
        if (p.cnt && col0 + c < p.n_valid) {
          int4 n = make_int4(0, 0, 0, 0), fs = make_int4(p.T, p.T, p.T, p.T);
          for (int s = 0; s < p.T; ++s) {
            const unsigned b =
                *(const uint32_t*)(p.spk_out + (size_t)s * p.B * p.N + o);
            n.x += b & 0xFFu;
            n.y += (b >> 8) & 0xFFu;
            n.z += (b >> 16) & 0xFFu;
            n.w += b >> 24;
            if ((b & 0xFFu) && fs.x == p.T) fs.x = s;
            if (((b >> 8) & 0xFFu) && fs.y == p.T) fs.y = s;
            if (((b >> 16) & 0xFFu) && fs.z == p.T) fs.z = s;
            if ((b >> 24) && fs.w == p.T) fs.w = s;
          }
          *(int4*)(p.cnt + o) = n;
          *(int4*)(p.first + o) = fs;
        }
      }
    }
  }
}

// Let lif_forward_kernel<kSplit, kReadout> use its shared memory on this
// device.
template <int kSplit, bool kReadout>
static cudaError_t raise_cap() {
  static int smem_cap[MAX_DEVICES] = {};
  return raise_smem_cap((const void*)lif_forward_kernel<kSplit, kReadout>,
                        lif_smem_bytes(kSplit, kReadout), smem_cap);
}

// How many clusters of kSplit blocks the card holds at once (of the trace
// instantiation; the readout one takes less shared memory at a split).
template <int kSplit>
static cudaError_t clusters_that_fit(int* n) {
  cudaError_t e = raise_cap<kSplit, false>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, kSplit);
  cfg.blockDim = dim3(SM_THREADS);
  cfg.dynamicSmemBytes = lif_smem_bytes(kSplit, false);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = kSplit;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(
      n, (const void*)lif_forward_kernel<kSplit, false>, &cfg);
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

template <int kSplit, bool kReadout>
static cudaError_t launch_split(const LifParams& p, cudaStream_t stream) {
  cudaError_t e = raise_cap<kSplit, kReadout>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.B + SM_BM - 1) / SM_BM, p.N / SM_BN, kSplit);
  cfg.blockDim = dim3(SM_THREADS);
  cfg.dynamicSmemBytes = lif_smem_bytes(kSplit, kReadout);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = kSplit;
  cfg.attrs = &attr;
  cfg.numAttrs = kSplit > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, lif_forward_kernel<kSplit, kReadout>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kReadout>
static cudaError_t launch(const LifParams& p, int split, cudaStream_t s) {
  if (split == 8) return launch_split<8, kReadout>(p, s);
  if (split == 4) return launch_split<4, kReadout>(p, s);
  return launch_split<1, kReadout>(p, s);
}

// ---- C interface (loaded with ctypes) -------------------------------------
// The trace launch: ptrs spikes (T, B, K) u8, w (K, N) i16, spk_out
// (T, B, N) u8, vtr (T, B, N) i32, vfin (B, N) i32; ints T, B, K, N,
// decay_shift, v_th, v_rest, v_min, v_max, pruning.
// The readout launch: those five pointers (vtr and vfin may be null), then
// vpeak (B, N) i32, cnt and first (B, N) i32 (both or neither), nspk,
// livek, nen, liven (any may be null); those ten ints, then b_valid,
// n_valid, ld, ldb: nspk and nen are added into at step * ld + lane,
// livek and liven at step * ldb + lane / 8, for lanes below b_valid.
// All contiguous; the (B, N) and (T, B, N) operands 16-byte aligned.
// B must be a multiple of 8, K of 16 and N of 128, with (B + 128) * K and
// K * N below 2^32.  Returns the cudaError_t of the launch.
extern "C" int repro_lif_forward(const void* ptrs_v, int n_ptrs,
                                 const void* ints_v, int n_ints,
                                 void* stream) {
  void* const* ptrs = (void* const*)ptrs_v;
  const int* ints = (const int*)ints_v;
  const bool readout = n_ptrs == 12;
  if (!(n_ptrs == 5 && n_ints == 10) && !(readout && n_ints == 14))
    return (int)cudaErrorInvalidValue;
  LifParams p = {};
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
  const int n_big = readout ? 8 : 5;  // the operands read or written wide
  for (int i = 0; i < n_big; ++i)
    if ((uintptr_t)ptrs[i] % 16) return (int)cudaErrorInvalidValue;
  if (readout) {
    p.vpeak = (int32_t*)ptrs[5];
    p.cnt = (int32_t*)ptrs[6];
    p.first = (int32_t*)ptrs[7];
    p.nspk = (int32_t*)ptrs[8];
    p.livek = (int32_t*)ptrs[9];
    p.nen = (int32_t*)ptrs[10];
    p.liven = (int32_t*)ptrs[11];
    p.b_valid = ints[10];
    p.n_valid = ints[11];
    p.ld = ints[12];
    p.ldb = ints[13];
    for (int i = 8; i < 12; ++i)
      if ((uintptr_t)ptrs[i] % 4) return (int)cudaErrorInvalidValue;
    if (!p.vpeak || !p.cnt != !p.first || p.b_valid <= p.B - BLOCK_B ||
        p.b_valid > p.B || p.n_valid <= 0 || p.n_valid > p.N ||
        p.ld < p.B || p.ldb < p.B / BLOCK_B)
      return (int)cudaErrorInvalidValue;
  }
  const int tiles = (p.B + SM_BM - 1) / SM_BM * (p.N / SM_BN);
  int split = 1;
  cudaError_t e = choose_split(tiles, (p.K + SM_BK - 1) / SM_BK, &split);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(readout ? launch<true>(p, split, s) : launch<false>(p, split, s));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
