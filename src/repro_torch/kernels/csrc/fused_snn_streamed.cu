// Fused Poisson-encode -> integer LIF stack with the weights streamed from
// device memory, one launch per window chunk, its Sigma W.S on the int8
// tensor cores.
//
// Replaces the TPU kernel repro/kernels/fused_snn.py::fused_snn_stack_pallas
// with streamed=True (body _stack_kernel; the slab pipeline slab_dma /
// pre_k / read_tile and the contraction _tiled_contraction, gated and
// ungated).  It computes what the resident kernel (fused_snn_stack.cu)
// computes, with the same outputs, for stacks whose per-lane state does not
// fit one thread block's shared memory: SNN_CONFIG_WIDE (784->2048->2048->10)
// needs 413,984 B per 8-lane block in the resident layout.  Its weights
// arrive as the two int8 planes of kernels/fused_snn.py::pack_weights,
// (2, n_out, n_in) per layer, w = 2 * hi + lo, each column's K contiguous.
//
// What bounds it on an H100: operations.  At the serving shape (1,024
// lanes, chunk 4, 784->2048->2048->10) the dense product of the spikes with
// both planes is 2 * 1024 * (784 * 2048 + 2048 * 2048 + 2048 * 10) * 2 * 4
// = 95.4 G int8 operations, 48.2 us at 1,979 T/s; the function moves about
// 95 MB (28 us at 3.35 TB/s); its executed adds alone would take 156 us at
// the INT32 rate.  So the tensor cores, not event-driven adds, are the
// short way, and the weights (12.6 MB of planes) are read once per lane
// block per step from L2.
//
// Why int8 tensor cores are exact: every 9-bit code w in [-256, 255] is
// 2 * hi + lo with hi in [-128, 127] and lo in {0, 1}, and spikes are 0 or
// 1.  One s32 accumulator takes mma.sync m16n8k32 .u8.s8 of the doubled
// spikes (bytes 0 or 2) with hi and of the spikes with lo, so it holds
// sum 2 * hi * x + lo * x = sum w * x; |sum| <= 256 * n_in < 2^31.  The
// dense product equals the reference's skipped one: a skipped tile pair
// has no spike (adds 0) or no enabled neuron (its current is masked).
//
// The design:
//  * A thread-block cluster of CL CTAs owns 64 lanes; 16 clusters at 1,024
//    lanes.  CL (6 to 8) is chosen at launch for the fewest waves x passes
//    per CTA from how many clusters the card holds at once (an H100 holds
//    15 of 8, 17 of 6: WIDE runs in clusters of 6).  Each rank owns a
//    32-aligned slice of every hidden layer's columns; rank 0 keeps the
//    last layer (the 10-class head, which the gate reads) and takes no
//    hidden columns when that adds no 256-column pass to its peers.
//    Lane blocks of 64 read the planes 16 times a step at 1,024 lanes,
//    where 8-lane blocks would read them 128 times.
//  * Every CTA keeps its 64 lanes' input spikes of the current layer as
//    bitmaps in shared memory (ping-pong, one bit a neuron).  Per layer it
//    expands them once into the m16n8k32 A fragments (bytes 0 / 1, in the
//    K order of build_a's comment) in a 2-slot ring of 4-chunk K
//    blocks, one barrier per block, so that its 16 warps read each
//    fragment with one 16-byte shared load instead of each rebuilding it.
//  * Each warp computes 64 lanes x 16 columns a pass: 4 m16 x 2 n8 tiles,
//    one accumulator set.  Its B fragments are 16-byte loads straight from
//    the planes into registers (thread (g, t) reads bytes [16 t, 16 t +
//    16) of a 64-deep K chunk of column g), a chunk ahead, with an
//    L2::256B prefetch hint; no shared memory.  The pass (contraction and
//    epilogue) is one out-of-line function, so that the K loop has the
//    thread's registers to itself.
//  * A warp whose 16 columns hold no enabled neuron in the 64 lanes skips
//    its MMAs (exact: their current is masked); that is most of the padded
//    head.
//  * The LIF epilogue runs on the accumulators against v / v_peak, which
//    live in the launch's output tensors (step 0 reads the input tensors
//    and writes every output; later steps store what changed).  Where the
//    launch's shared memory has room for it (stacks up to about 3,000
//    columns wide, WIDE among them), each warp stages its 64 x 16
//    membranes and peaks into shared memory with cp.async before its K
//    loop, so their latency hides behind the MMAs; wider stacks read them
//    from device memory in the epilogue.  The two are two instantiations
//    of the kernel (kStaged), the host picking one per launch: on an H100
//    a runtime test in one kernel cost 5.7% at WIDE, and a stage size
//    known only at run time moved the later shared-memory offsets into
//    registers (1.2%).
//    Enables live as one bit a neuron in shared memory for the launch
//    (read from en_in once, written to en_out once).  Each neuron is
//    updated by one thread for the whole launch.  Fired bits go to the
//    CTA's own next-layer bitmap, then to every peer's through distributed
//    shared memory, then one cluster barrier.
//  * The encoder is split by input words over the ranks (PRNG state kept in
//    the output tensor st_out), each warp loading ST_ENC words' state and
//    pixels at once; its bitmap words travel like fired bits.
//  * Rank 0 counts each lane's input spikes and the K tiles with a spike per
//    8-lane block; each CTA sums its lanes' enabled counts and ORs its N
//    tiles with an enabled neuron locally, then adds them into rank 0's
//    shared memory once a layer (DSMEM atomics).  Rank 0 then writes the
//    telemetry (the reference's 8-lane, 128x128 geometry, whatever the
//    cluster), runs the stability gate (gate_step) and sends each lane's
//    active flag to its peers.
//
// Where trouble is likely:
//  1. Redefinitions: cp.async wrappers and MMAs come from mma_common.cuh;
//     this file defines none of its own.
//  2. The head and narrow layers: a layer of 128 padded columns is split
//     in 32-column slices (ranks past 4 get none), the last layer goes to
//     rank 0 alone, and a stack of 1 layer (784->10) runs on rank 0 while
//     its peers only encode.  Every warp of a CTA walks the same number of
//     passes, those past its columns only to build the ring and sync.
//  3. Lanes not a multiple of 64: the last cluster's rows from B on are
//     never loaded or stored; their bitmap rows stay 0 and their enables
//     read as 0, and telemetry covers exactly B / 8 blocks.
//  4. Registers: __launch_bounds__(512, 1) caps a thread at 128 registers.
//     With the pass inline, the kernel's loop state spilled inside the K
//     loop (1 KB); out of line, the pass function spills about 40 B and
//     the kernel body's spills sit outside the K loop.  Two instantiations
//     of the pass function called from one kernel spilled both (over
//     600 B each), so each kernel calls only its own.  The build phase
//     prints every function's count and spill.
//  5. The feasibility model: carve_streamed below and
//     kernels/fused_snn.py::stack_streamed_smem_bytes describe the same
//     carve-up (the 32 KB ring, enable bits for the most passes a cluster
//     of 6 gives, 2 x 64 lanes x the widest layer's bits of bitmaps, small
//     counters, then 128 KB of stages only if the launch gives room for
//     them), and the entry refuses a launch given less than the carve-up
//     without stages.  Without the stages K2 holds every stack with a head
//     of at most 128 columns that the slab kernel it replaced held (10,240
//     columns at one hidden layer, 7,168 at seven).
//  6. Latency chains: a loop that loads, computes and stores global memory
//     one element at a time runs at one memory latency per element, since
//     the compiler cannot hoist a load above a store that may alias it.
//     The first version's copy-in, encoder and epilogue took more than
//     half the launch that way; every such phase now batches its loads.
//
// What still holds it back (NVIDIA H100 80GB HBM3, 700 W, PERF.md): the
// planes' L2 traffic, 12.6 MB per cluster per step (805 MB a launch at
// 1,024 lanes), which both bounds the MMA loop and stretches every
// latency-bound phase (stage copy, encoder, stores, the gate); mma.sync's
// rate; the per-step round trip of v / v_peak through L2.  A larger lane
// block per weight read (TMA multicast across a cluster), wgmma and a
// persistent grid are the next steps.
#include <cooperative_groups.h>

#include "mma_common.cuh"
#include "snn_stack_common.cuh"

namespace cg = cooperative_groups;

extern __shared__ __align__(16) unsigned char k2_smem[];

#define ST_THREADS 512            // 16 warps
#define ST_WARPS (ST_THREADS / 32)
#define ST_BM 64                  // lanes per cluster
#define ST_LB (ST_BM / BLOCK_B)   // 8-lane blocks per cluster
#define ST_GROUP 16               // columns a warp computes per pass
#define ST_KC 64                  // K bytes per register chunk
#define ST_ENC 16                 // encoder elements a thread loads at once
#define ST_STAGE_INTS (2 * ST_BM * ST_GROUP)   // a warp's staged v, v_peak
#define ST_BK 4                   // chunks per block of the A-fragment ring
#define ST_AFRAGS 256             // (m16, k32, lane) fragments of a chunk
#define ST_RING_WORDS (2 * ST_BK * ST_AFRAGS * 4)
#define ST_SPAN (ST_WARPS * ST_GROUP)   // columns of one pass of the CTA
#define ST_MIN_CL 6               // cluster sizes a launch chooses from
#define ST_MAX_CL 8

struct StreamedSmem {
  int32_t* stage;   // (ST_WARPS, 2, ST_BM, ST_GROUP) staged v, v_peak, or
                    // null when the launch gives no room for it
  uint4* ring;      // (2, ST_BK, ST_AFRAGS) A fragments, two K blocks
  uint32_t* ebits;  // per layer (passes, ST_THREADS) enable bits
  uint32_t* bits;   // (2, ST_BM, stride) spike bitmaps, ping-pong
  int* nsp;         // (L, ST_BM) input spikes per lane (rank 0)
  int* nen;         // (L, ST_BM) enabled neurons per lane (rank 0)
  int* cx;          // (L, ST_LB) K tiles with a spike (rank 0)
  uint32_t* te;     // per layer (ST_LB, te_words) N-tile bits (rank 0)
  uint32_t* te_loc;  // the same, this CTA's, sent to rank 0 once a layer
  int* nen_loc;     // (ST_BM) this CTA's enabled counts
  int* act;         // (ST_BM) lane active this step
  int* steps;       // (ST_BM) rank 0
  int* gprev;       // (ST_BM) rank 0
  int* gstreak;     // (ST_BM) rank 0
};

// Words per bitmap row: the widest layer's, padded so that the stride is
// 2 mod 32 and the 8 rows x 2 words of one A-fragment load hit 16 banks.
__host__ __device__ inline int bitmap_stride(int widest) {
  const int words = widest / 32;
  return words + (34 - words % 32) % 32;
}

// Words of N-tile bits per 8-lane block for a layer of n columns.
__host__ __device__ inline int te_words(int n) { return (n / TILE + 31) / 32; }

// Word offset of layer l's N-tile bits (l = L: their total).
__host__ __device__ inline int te_offset(const StackParams& p, int l) {
  int off = 0;
  for (int q = 0; q < l; ++q) off += ST_LB * te_words(p.n[q]);
  return off;
}

__host__ __device__ inline int round32(int n) { return (n + 31) / 32 * 32; }

// Passes of a CTA over `per` columns of a layer (ST_SPAN a pass).
__host__ __device__ inline int passes(int per) {
  return (per + ST_SPAN - 1) / ST_SPAN;
}

// Columns per rank of a hidden layer of n columns in a cluster of cl, and
// the first rank that takes any: rank 0 (which keeps the last layer and
// the gate) takes none when that adds no pass to its peers.
__host__ __device__ inline int hidden_per(int n, int cl, int* first) {
  const int per = round32((n + cl - 1) / cl);
  *first = 0;
  if (cl > 1) {
    const int rest = round32((n + cl - 2) / (cl - 1));
    if (passes(rest) == passes(per)) {
      *first = 1;
      return rest;
    }
  }
  return per;
}

// Words of enable bits for layer l (one per thread and pass, for the most
// passes a hidden layer takes, in the smallest cluster, whose rank 0 sits
// out only when that adds no pass): the offset of layer l's words, or with
// l = L their total.
__host__ __device__ inline int en_offset(const StackParams& p, int l) {
  int off = 0;
  for (int q = 0; q < l; ++q)
    off += ST_THREADS * (q == p.L - 1 ? passes(p.n[q])
                         : passes(round32((p.n[q] + ST_MIN_CL - 1) /
                                          ST_MIN_CL)));
  return off;
}

// Shared-memory carve-up, with the stages first or without them; the
// same layout as stack_streamed_smem_bytes() in kernels/fused_snn.py.
// Returns the bytes it needs.
__host__ __device__ inline size_t carve_streamed(const StackParams& p,
                                                 unsigned char* base,
                                                 StreamedSmem* s,
                                                 bool staged) {
  int widest = p.k0;
  for (int l = 0; l < p.L; ++l) widest = p.n[l] > widest ? p.n[l] : widest;
  const size_t map = (size_t)ST_BM * bitmap_stride(widest);
  const size_t en = en_offset(p, p.L);
  const size_t rest = ST_RING_WORDS + en + 2 * map +
                      (size_t)p.L * (2 * ST_BM + ST_LB) +
                      2 * te_offset(p, p.L) + 5 * ST_BM;
  const size_t stage = staged ? (size_t)ST_WARPS * ST_STAGE_INTS : 0;
  const size_t words = stage + rest;
  if (base) {
    s->stage = stage ? (int32_t*)base : nullptr;
    s->ring = (uint4*)((uint32_t*)base + stage);
    s->ebits = (uint32_t*)base + stage + ST_RING_WORDS;
    uint32_t* w = (uint32_t*)base + stage + ST_RING_WORDS + en;
    s->bits = w;
    s->nsp = (int*)(w + 2 * map);
    s->nen = s->nsp + p.L * ST_BM;
    s->cx = s->nen + p.L * ST_BM;
    s->te = (uint32_t*)(s->cx + p.L * ST_LB);
    s->te_loc = s->te + te_offset(p, p.L);
    s->nen_loc = (int*)(s->te_loc + te_offset(p, p.L));
    s->act = s->nen_loc + ST_BM;
    s->steps = s->act + ST_BM;
    s->gprev = s->steps + ST_BM;
    s->gstreak = s->gprev + ST_BM;
  }
  return words * 4;
}

// Columns [*c0, *c1) of layer l that cluster rank `rank` of `cl` owns.
__device__ __forceinline__ void col_range(const StackParams& p, int l, int cl,
                                          int rank, int* c0, int* c1) {
  const int N = p.n[l];
  if (l == p.L - 1) {
    *c0 = 0;
    *c1 = rank == 0 ? N : 0;
    return;
  }
  int first;
  const int per = hidden_per(N, cl, &first);
  *c0 = rank < first ? 0 : min(N, (rank - first) * per);
  *c1 = rank < first ? 0 : min(N, *c0 + per);
}

// 16 read-only bytes of the weight planes, with a hint that L2 fetch the
// 256-byte block around them (the next chunk of the column is in it).
__device__ __forceinline__ uint4 ldg_plane(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// 4 bits -> 4 bytes of 0 / 1 (bit i to byte i).
__device__ __forceinline__ unsigned expand4(unsigned bits) {
  return ((bits & 0xFu) * 0x204081u) & 0x01010101u;
}

// Word offset of a shared-memory pointer from the base of the carve-up.
__device__ __forceinline__ int word_of(const void* at) {
  return (int)((const uint32_t*)at - (const uint32_t*)k2_smem);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Copy words [w0, w1) of the first `rows` rows of this CTA's bitmap `x`
// into the same place of every peer's.
__device__ __forceinline__ void send_words(cg::cluster_group& cluster,
                                           uint32_t* x, int stride, int rows,
                                           int w0, int w1) {
  const int nw = w1 - w0, cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  if (nw <= 0) return;
  for (int e = threadIdx.x; e < rows * nw; e += ST_THREADS) {
    const int off = (e / nw) * stride + w0 + e % nw;
    const uint32_t v = x[off];
    for (int q = 1; q < cl; ++q)
      cluster.map_shared_rank(x, (rank + q) % cl)[off] = v;
  }
}

// The A fragments of chunks [kc0, kc0 + n) of the CTA's 64 lanes into a
// ring slot, built by the whole CTA: entry ((c * 4 + mi) * 2 + s) * 32 +
// lane holds lane's registers (a0, a1, a2, a3) of m16 tile mi, k32 step s
// of chunk kc0 + c.  K order: a 16-byte B load covers two k32 steps, so
// chunk kc takes bits 64 kc + 16 tig + [0, 16) of rows g + 8 i, and k32
// step s takes bits 8 s + [0, 4) (registers 0, 1) and 8 s + [4, 8) (2, 3),
// which pair with the plane bytes 8 s + [0, 4) and [4, 8) of the 16.
__device__ __forceinline__ void build_a(uint4* slot, const uint32_t* xin,
                                        int stride, int kc0, int n) {
  for (int e = threadIdx.x; e < n * ST_AFRAGS; e += ST_THREADS) {
    const int ln = e & 31, st = (e >> 5) & 1, mi = (e >> 6) & 3;
    const int kc = kc0 + (e >> 8), g = ln >> 2, tig = ln & 3;
    const int w = 2 * kc + (tig >> 1), sh = (tig & 1) * 16 + 8 * st;
    const unsigned lo = xin[(16 * mi + g) * stride + w] >> sh;
    const unsigned hi = xin[(16 * mi + 8 + g) * stride + w] >> sh;
    slot[e] = make_uint4(expand4(lo), expand4(hi), expand4(lo >> 4),
                         expand4(hi >> 4));
  }
}

// Sigma W.S of a warp's 64 lanes x 16 columns over a layer's whole K with
// A from the ring: acc[mi][j] is the m16n8 tile of lanes 16 mi + [0, 16),
// columns cb + 8 j + [0, 8).  Every warp of the CTA calls it together (it
// holds barriers); `mma` false leaves acc alone but still builds and
// syncs.  B fragments are 16-byte loads straight from the planes into
// registers, a chunk ahead: `wl` the layer's planes, `plane` = N * K,
// `off` this thread's first byte (column cb + g, K 16 tig).
__device__ __forceinline__ void ring_contract(int (&acc)[4][2][4],
                                              const int8_t* __restrict__ wl,
                                              unsigned plane, unsigned off,
                                              unsigned col8, int nkc,
                                              uint4* ring, const uint32_t* xin,
                                              int stride, bool mma) {
  const int lane = threadIdx.x & 31;
  uint4 w[2][4];
  auto load = [&](uint4 (&d)[4], int kc) {
    const unsigned o = off + (unsigned)kc * ST_KC;
    d[0] = ldg_plane(wl + o);
    d[1] = ldg_plane(wl + o + plane);
    d[2] = ldg_plane(wl + o + col8);
    d[3] = ldg_plane(wl + o + col8 + plane);
  };
  const int nb = (nkc + ST_BK - 1) / ST_BK;
  build_a(ring, xin, stride, 0, min(ST_BK, nkc));
  if (mma) load(w[0], 0);
  __syncthreads();
  for (int b = 0; b < nb; ++b) {
    const int k0 = b * ST_BK;
    if (b + 1 < nb)
      build_a(ring + ((b + 1) & 1) * ST_BK * ST_AFRAGS, xin, stride,
              k0 + ST_BK, min(ST_BK, nkc - k0 - ST_BK));
    if (mma) {
      const uint4* slot = ring + (b & 1) * ST_BK * ST_AFRAGS + lane;
#pragma unroll
      for (int c = 0; c < ST_BK; ++c) {
        const int kc = k0 + c;   // kc & 1 == c & 1: ST_BK is even
        if (kc < nkc) {
          if (kc + 1 < nkc) load(w[(c + 1) & 1], kc + 1);
          const uint4(&d)[4] = w[c & 1];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const uint4 f = slot[((c * 4 + mi) * 2 + s) * 32];
              const unsigned a[4] = {f.x, f.y, f.z, f.w};
              const unsigned a2[4] = {f.x << 1, f.y << 1, f.z << 1,
                                      f.w << 1};
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const uint4& h = d[2 * j];
                const uint4& lw = d[2 * j + 1];
                mma_u8s8(acc[mi][j], a2, s ? h.z : h.x, s ? h.w : h.y);
                mma_u8s8(acc[mi][j], a, s ? lw.z : lw.x, s ? lw.w : lw.y);
              }
            }
          }
        }
      }
    }
    __syncthreads();   // slot b & 1 is free for block b + 2
  }
}

// One warp's pass over 64 lanes x 16 columns [cb, cb + 16) of layer l at
// step t: the contraction, then the LIF epilogue against the v / v_peak
// staged (by the caller's cp.async) at word `stage_w` of shared memory,
// or without kStaged read from the step's source tensors.
// Every warp of the CTA calls it together, those without columns (`cols`
// false) only to build the ring and sync.
// Returns the new enable bits.  Out of line so that the K loop has the
// thread's registers to itself: the caller's state is saved around the
// call once a pass, not spilled inside the loop.  Bitmaps, stage and the
// lane arrays come as word offsets into shared memory.
template <bool kStaged>
__device__ __noinline__ unsigned warp_pass(const StackParams& p, int t, int l,
                                           int cb, bool cols, int row0,
                                           int rows, int stride, unsigned emask,
                                           int xin_w, int xout_w, int stage_w,
                                           int act_w, int steps_w,
                                           int ring_w) {
  uint32_t* words = (uint32_t*)k2_smem;
  const uint32_t* xin = words + xin_w;
  uint32_t* xout = words + xout_w;
  const int32_t* stage = (const int32_t*)(words + stage_w);
  const int* act_s = (const int*)(words + act_w);
  const int* steps_s = (const int*)(words + steps_w);
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int L = p.L, B = p.B, nL = p.n[L - 1];
  const int K = l == 0 ? p.k0 : p.n[l - 1], N = p.n[l];
  const bool last = l == L - 1;
  int acc[4][2][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0;
  ring_contract(acc, (const int8_t*)p.w[l], (unsigned)N * K,
                (unsigned)(cb + g) * K + tig * 16, 8u * K, K / ST_KC,
                (uint4*)(words + ring_w), xin, stride,
                cols && __any_sync(FULL_MASK, emask != 0));
  if (!cols) return 0u;
  cp_async_wait<0>();
  __syncwarp();

  // LIF epilogue: element q of tile (mi, j) is row 16 mi + 8 (q / 2)
  // + g, column cb + 8 j + 2 tig + q % 2; step 0 writes every
  // neuron's v and v_peak, later steps those that changed
  int32_t* v_l = p.v_out[l];
  int32_t* vp_l = p.vp_out[l];
  const int32_t* v_src = t == 0 ? p.v_in[l] : v_l;
  const int32_t* vp_src = t == 0 ? p.vp_in[l] : vp_l;
  const LifConsts lc = {p.decay_shift, p.v_th, p.v_rest, p.v_min, p.v_max};
  const bool pruning = p.pruning != 0;
  unsigned enew = 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * mi + h, r = 8 * i + g;
      unsigned fb = 0;
      if (r < rows) {
        const int row = row0 + r;
        const bool act = act_s[r] != 0;
        const size_t ro = (size_t)row * N;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int sc = r * ST_GROUP + 8 * j + 2 * tig;
          const int col = cb + 8 * j + 2 * tig;
          const int2 v2 = kStaged ? *(const int2*)(stage + sc)
                                  : *(const int2*)(v_src + ro + col);
          const int2 p2 = kStaged
                              ? *(const int2*)(stage + ST_BM * ST_GROUP + sc)
                              : *(const int2*)(vp_src + ro + col);
          int vv[2] = {v2.x, v2.y}, pp[2] = {p2.x, p2.y};
          bool ee[2];
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const bool e = (emask >> (4 * i + 2 * j + b)) & 1u;
            bool fired;
            const int v_new = lif_update(
                vv[b], e ? acc[mi][j][2 * h + b] : 0, e, lc, &fired);
            ee[b] = e;
            if (act) {
              vv[b] = v_new;
              ee[b] = pruning ? (e && !fired) : e;
              pp[b] = max(pp[b], v_new);
            }
            enew |= (unsigned)ee[b] << (4 * i + 2 * j + b);
            fb |= (unsigned)fired << (8 * j + 2 * tig + b);
            if (last) {
              const size_t o = (size_t)row * nL + col + b;
              if (act && fired) {
                p.cnt_out[o] += 1;
                if (p.first_out[o] == p.window)
                  p.first_out[o] = steps_s[r];
              }
              p.vtr[((size_t)t * B + row) * nL + col + b] = vv[b];
            }
          }
          if (t == 0 || vv[0] != v2.x || vv[1] != v2.y)
            *(int2*)(v_l + ro + col) = make_int2(vv[0], vv[1]);
          if (t == 0 || pp[0] != p2.x || pp[1] != p2.y)
            *(int2*)(vp_l + ro + col) = make_int2(pp[0], pp[1]);
        }
      }
      if (!last) {
        fb |= __shfl_xor_sync(FULL_MASK, fb, 1);
        fb |= __shfl_xor_sync(FULL_MASK, fb, 2);
        if (tig == 0)
          ((uint16_t*)(xout + r * stride + cb / 32))[(cb >> 4) & 1] =
              (uint16_t)fb;
      }
    }
  }
  return enew;
}

// kStaged: the carve-up holds the v / v_peak stages (two kernels, so that
// the staged one carries no branch for it).
template <bool kStaged>
__global__ void __launch_bounds__(ST_THREADS, 1)
    fused_snn_streamed_kernel(const __grid_constant__ StackParams p) {
  StreamedSmem s;
  carve_streamed(p, k2_smem, &s, kStaged);
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int B = p.B, L = p.L, K0 = p.k0, nL = p.n[L - 1];
  const int row0 = (int)(blockIdx.x / cl) * ST_BM;
  const int rows = min(ST_BM, B - row0);   // lanes of this cluster
  int widest = K0;
  for (int l = 0; l < L; ++l) widest = max(widest, p.n[l]);
  const int stride = bitmap_stride(widest);
  const int map = ST_BM * stride;   // words of one bitmap
  // the encoder's input words
  const int kw0 = K0 / 32, wper = (kw0 + cl - 1) / cl;
  const int ew0 = min(kw0, rank * wper), ew1 = min(kw0, ew0 + wper);
  // this warp's staged v (then v_peak) of 64 lanes x 16 columns, if any
  int32_t* stage = kStaged ? s.stage + warp * ST_STAGE_INTS : nullptr;

  // ---- bitmaps and counters zeroed; rank 0 copies the readout registers
  //      in (every other carried state is read from its input tensor at
  //      step 0 and written to its output tensor every step) -------------
  for (int e = tid; e < 2 * map; e += ST_THREADS) s.bits[e] = 0u;
  {
    const int te = te_offset(p, L);
    for (int e = tid; e < 2 * te; e += ST_THREADS) s.te[e] = 0u;
    for (int e = tid; e < L * ST_BM; e += ST_THREADS) s.nen[e] = 0;
  }
  if (tid < ST_BM) {
    const bool in = tid < rows;
    const int row = row0 + tid;
    s.nen_loc[tid] = 0;
    s.act[tid] = in ? (p.gated ? (p.act_in[row] != 0) : 1) : 0;
    s.steps[tid] = in ? p.steps_in[row] : 0;
    s.gprev[tid] = in && p.gated ? p.gprev_in[row] : 0;
    s.gstreak[tid] = in && p.gated ? p.gstreak_in[row] : 0;
  }
  if (rank == 0) {
    const int n4 = rows * nL / 4;
    const int4* ci = (const int4*)(p.cnt_in + (size_t)row0 * nL);
    const int4* fi = (const int4*)(p.first_in + (size_t)row0 * nL);
    int4* co = (int4*)(p.cnt_out + (size_t)row0 * nL);
    int4* fo = (int4*)(p.first_out + (size_t)row0 * nL);
    for (int e = tid; e < n4; e += ST_THREADS) {
      const int4 c = ci[e], f = fi[e];
      co[e] = c;
      fo[e] = f;
    }
  }
  cluster.sync();   // every peer's shared memory is ready for remote writes
  int* nen0 = cluster.map_shared_rank(s.nen, 0);
  uint32_t* te0 = cluster.map_shared_rank(s.te, 0);

  for (int t = 0; t < p.chunk; ++t) {
    // ---- encoder: xorshift32 + 8-bit comparator -> this rank's words;
    //      warp w takes the (row, word) pairs w, w + 16, ... of the
    //      (rows, ew1 - ew0) slice, lane = bit, ST_ENC pairs loaded at once
    {
      const uint32_t* st_src = t == 0 ? p.st_in : p.st_out;
      const int nw = ew1 - ew0;
      int r = nw ? warp / nw : rows, wd = nw ? warp % nw : 0;
      while (r < rows) {
        uint32_t sv[ST_ENC];
        uint8_t pv[ST_ENC];
        int at[ST_ENC];   // (row << 16) | word, or -1 past the slice
#pragma unroll
        for (int u = 0; u < ST_ENC; ++u) {
          at[u] = -1;
          if (r < rows) {
            const size_t i =
                (size_t)(row0 + r) * K0 + (ew0 + wd) * 32 + lane;
            sv[u] = st_src[i];
            pv[u] = p.px[i];
            at[u] = (r << 16) | (ew0 + wd);
            for (wd += ST_WARPS; wd >= nw; wd -= nw) ++r;
          }
        }
#pragma unroll
        for (int u = 0; u < ST_ENC; ++u) {
          if (at[u] >= 0) {   // warp-uniform
            const int ru = at[u] >> 16, word = at[u] & 0xFFFF;
            const size_t i =
                (size_t)(row0 + ru) * K0 + (size_t)word * 32 + lane;
            const uint32_t rnd = xorshift32(sv[u]);
            p.st_out[i] = s.act[ru] ? rnd : sv[u];
            const unsigned m =
                __ballot_sync(FULL_MASK, pv[u] > (uint8_t)(rnd >> 24));
            if (lane == 0) s.bits[ru * stride + word] = m;
          }
        }
      }
      __syncthreads();
      send_words(cluster, s.bits, stride, rows, ew0, ew1);
      cluster.sync();
    }

    for (int l = 0; l < L; ++l) {
      const int K = l == 0 ? K0 : p.n[l - 1], N = p.n[l];
      const bool last = l == L - 1;
      const uint32_t* xin = s.bits + (l & 1) * map;
      uint32_t* xout = s.bits + ((l + 1) & 1) * map;
      int c0, c1;
      col_range(p, l, cl, rank, &c0, &c1);

      // rank 0: each lane's input spikes and each 8-lane block's K tiles
      // with a spike (the telemetry's tile-skip predicate)
      if (rank == 0) {
        for (int r = warp; r < rows; r += ST_WARPS) {
          int c = 0;
          for (int wd = lane; wd < K / 32; wd += 32)
            c += __popc(xin[r * stride + wd]);
          c = warp_sum(c);
          if (lane == 0) s.nsp[l * ST_BM + r] = c;
        }
        if (warp < ST_LB) {
          int cx = 0;
          for (int k0 = 0; k0 < K / TILE; k0 += 32) {
            const int kt = k0 + lane;
            unsigned any = 0;
            if (kt < K / TILE)
              for (int r = 8 * warp; r < 8 * warp + BLOCK_B; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q) any |= xin[r * stride + kt * 4 + q];
            cx += __popc(__ballot_sync(FULL_MASK, any != 0));
          }
          if (lane == 0) s.cx[l * ST_LB + warp] = cx;
        }
      }

      const int32_t* v_src = t == 0 ? p.v_in[l] : p.v_out[l];
      const int32_t* vp_src = t == 0 ? p.vp_in[l] : p.vp_out[l];
      uint32_t* te_l = s.te_loc + te_offset(p, l);
      uint32_t* eb = s.ebits + en_offset(p, l) + tid;   // + pass * 512
      // every warp walks the CTA's passes (the ring's barriers are shared);
      // a warp past the CTA's columns only builds and syncs
      const int np = (c1 - c0 + ST_SPAN - 1) / ST_SPAN;
      for (int k = 0; k < np; ++k, eb += ST_THREADS) {
        const int cb = c0 + warp * ST_GROUP + k * ST_SPAN;
        const bool cols = cb < c1;
        unsigned emask = 0;
        if (cols) {
          // the 64 x 16 membranes and peaks into the warp's stage: piece
          // k * 32 + lane is 16 bytes q of row r of v (w = 0) or v_peak
          // (w = 1); it lands while the K loop runs
          if (kStaged) {
#pragma unroll
            for (int k = 0; k < ST_STAGE_INTS / 4 / 32; ++k) {
              const int pc = k * 32 + lane;
              const int r = pc >> 3, w = (pc >> 2) & 1, q = pc & 3;
              const bool ok = r < rows;
              const int32_t* src = (w ? vp_src : v_src) +
                                   (size_t)(row0 + (ok ? r : 0)) * N + cb +
                                   4 * q;
              cp_async16_zfill(
                  stage + w * ST_BM * ST_GROUP + r * ST_GROUP + 4 * q, src,
                  ok);
            }
            cp_async_commit();
          }
          // enables of this thread's 32 neurons: bit 4 i + 2 j + b is row
          // 8 i + g, column cb + 8 j + 2 tig + b; read from en_in at step 0,
          // then kept in shared memory until the launch writes en_out
          if (t == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int r = 8 * i + g;
              if (r < rows) {
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                  const uint16_t e2 = *(const uint16_t*)(
                      p.en_in[l] + (size_t)(row0 + r) * N + cb + 8 * j +
                      2 * tig);
                  emask |= (unsigned)((e2 & 0xFF) != 0) << (4 * i + 2 * j);
                  emask |= (unsigned)((e2 >> 8) != 0) << (4 * i + 2 * j + 1);
                }
              }
            }
          } else {
            emask = *eb;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const unsigned bits = (emask >> (4 * i)) & 0xFu;
            int c = __popc(bits);
            c += __shfl_xor_sync(FULL_MASK, c, 1);
            c += __shfl_xor_sync(FULL_MASK, c, 2);
            if (tig == 0 && c) atomicAdd(&s.nen_loc[8 * i + g], c);
            if (__any_sync(FULL_MASK, bits != 0) && lane == 0) {
              const int nt = cb / TILE;
              atomicOr(te_l + i * te_words(N) + (nt >> 5), 1u << (nt & 31));
            }
          }
        }

        const unsigned en = warp_pass<kStaged>(
            p, t, l, cb, cols, row0, rows, stride, emask, word_of(xin),
            word_of(xout), kStaged ? word_of(stage) : 0, word_of(s.act),
            word_of(s.steps), word_of(s.ring));
        if (cols) *eb = en;
        __syncwarp();   // the stage is read before the next pass refills it
      }
      __syncthreads();   // this CTA's columns are updated and its fired
                         // words written
      if (tid < rows) {
        const int c = s.nen_loc[tid];
        s.nen_loc[tid] = 0;
        if (c) atomicAdd(nen0 + l * ST_BM + tid, c);
      }
      for (int e = tid; e < ST_LB * te_words(N); e += ST_THREADS) {
        const uint32_t v = te_l[e];
        if (v) {
          te_l[e] = 0u;
          atomicOr(te0 + te_offset(p, l) + e, v);
        }
      }
      if (!last) {
        send_words(cluster, xout, stride, rows, c0 / 32, c1 / 32);
        cluster.sync();
      }
    }
    __syncthreads();

    // ---- rank 0: telemetry, then the stability gate ----------------------
    if (rank == 0) {
      if (tid < rows) {
        const int row = row0 + tid;
        const bool act = s.act[tid] != 0;
        int adds_t = 0;
        for (int l = 0; l < L; ++l) {
          const int ns = s.nsp[l * ST_BM + tid], ne = s.nen[l * ST_BM + tid];
          s.nen[l * ST_BM + tid] = 0;
          adds_t += ns * ne;
          const size_t o = ((size_t)t * L + l) * B + row;
          p.tspk[o] = act ? ns : 0;
          p.ten[o] = act ? ne : 0;
        }
        p.adds[(size_t)t * B + row] = act ? adds_t : 0;
      }
      if (tid < L * ST_LB) {
        const int l = tid / ST_LB, b = tid % ST_LB, tw = te_words(p.n[l]);
        int ce = 0;
        for (int q = 0; q < tw; ++q) {
          uint32_t* word = s.te + te_offset(p, l) + b * tw + q;
          ce += __popc(*word);
          *word = 0u;
        }
        if (BLOCK_B * b < rows) {
          const int nkt = (l == 0 ? K0 : p.n[l - 1]) / TILE;
          const int nnt = p.n[l] / TILE;
          p.ttile[((size_t)t * L + l) * (B / BLOCK_B) + row0 / BLOCK_B + b] =
              p.sparse_skip ? nkt * nnt - s.cx[l * ST_LB + b] * ce : 0;
        }
      }
      __syncthreads();
      if (p.gated) {
        for (int r = warp; r < rows; r += ST_WARPS) {
          if (!s.act[r]) continue;
          const size_t o = (size_t)(row0 + r) * nL;
          int steps = s.steps[r], gprev = s.gprev[r], gstreak = s.gstreak[r];
          bool act = true;
          gate_step(p.cnt_out + o, p.first_out + o, p.v_out[L - 1] + o,
                    p.vp_out[L - 1] + o, nL, p.readout, p.window, p.patience,
                    lane, steps, act, gprev, gstreak);
          if (lane == 0) {
            s.steps[r] = steps;
            s.gprev[r] = gprev;
            s.gstreak[r] = gstreak;
            s.act[r] = act;
          }
        }
        __syncthreads();
        if (tid < rows)
          for (int q = 1; q < cl; ++q)
            cluster.map_shared_rank(s.act, q)[tid] = s.act[tid];
      } else if (tid < rows) {
        s.steps[tid] += 1;
      }
    }
    cluster.sync();   // act reached every peer; rank 0's counters are clear
  }

  // ---- the enables back to en_out; rank 0 writes each lane's counters ----
  for (int l = 0; l < L; ++l) {
    int c0, c1;
    col_range(p, l, cl, rank, &c0, &c1);
    const int N = p.n[l];
    const uint32_t* eb = s.ebits + en_offset(p, l) + tid;
    for (int cb = c0 + warp * ST_GROUP; cb < c1;
         cb += ST_SPAN, eb += ST_THREADS) {
      const unsigned m = *eb;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * i + g;
        if (r < rows)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *(uint16_t*)(p.en_out[l] + (size_t)(row0 + r) * N + cb + 8 * j +
                         2 * tig) =
                (uint16_t)(((m >> (4 * i + 2 * j)) & 1u) |
                           (((m >> (4 * i + 2 * j + 1)) & 1u) << 8));
      }
    }
  }
  if (rank == 0 && tid < rows) {
    const int row = row0 + tid;
    p.steps_out[row] = s.steps[tid];
    if (p.gated) {
      p.act_out[row] = s.act[tid];
      p.gprev_out[row] = s.gprev[tid];
      p.gstreak_out[row] = s.gstreak[tid];
    }
  }
}

// Cluster size for `clusters` clusters of `smem` bytes each whose widest
// hidden layer has `width` columns: the c in [ST_MIN_CL, ST_MAX_CL] with
// the least waves x passes per CTA, then the fewest waves, then the
// largest c, from how many such clusters the card holds at once.
// Remembered per kernel, device and shape.
template <bool kStaged>
static cudaError_t choose_cluster(int clusters, int smem, int width,
                                  int* cl_out) {
  static std::mutex mu;
  static int seen[MAX_DEVICES][3] = {};
  static int best[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  int* key = seen[dev];
  if (!(best[dev] && key[0] == clusters && key[1] == smem &&
        key[2] == width)) {
    long long cost = 0, cost_waves = 0;
    int cl = 0;
    for (int c = ST_MAX_CL; c >= ST_MIN_CL; --c) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(clusters * c);
      cfg.blockDim = dim3(ST_THREADS);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = c;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int n = 0;
      err = cudaOccupancyMaxActiveClusters(
          &n, fused_snn_streamed_kernel<kStaged>, &cfg);
      if (err != cudaSuccess) return err;
      if (n <= 0) continue;
      int first;
      const long long waves = (clusters + n - 1) / n;
      const long long work = waves * passes(hidden_per(width, c, &first));
      if (cl == 0 || work < cost || (work == cost && waves < cost_waves)) {
        cl = c;
        cost = work;
        cost_waves = waves;
      }
    }
    if (cl == 0) return cudaErrorInvalidConfiguration;
    key[0] = clusters;
    key[1] = smem;
    key[2] = width;
    best[dev] = cl;
  }
  *cl_out = best[dev];
  return cudaSuccess;
}

// The widest hidden layer (the last layer is rank 0's alone), 32 if none.
static int widest_hidden(const StackParams& p) {
  int w = 32;
  for (int l = 0; l + 1 < p.L; ++l) w = p.n[l] > w ? p.n[l] : w;
  return w;
}

template <bool kStaged>
static cudaError_t launch_streamed(const StackParams& p, cudaStream_t stream) {
  static int smem_cap[MAX_DEVICES] = {};
  cudaError_t err = raise_smem_cap(
      (const void*)fused_snn_streamed_kernel<kStaged>, p.smem_bytes, smem_cap);
  if (err != cudaSuccess) return err;
  const int clusters = (p.B + ST_BM - 1) / ST_BM;
  int cl = 0;
  err = choose_cluster<kStaged>(clusters, p.smem_bytes, widest_hidden(p), &cl);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cl);
  cfg.blockDim = dim3(ST_THREADS);
  cfg.dynamicSmemBytes = p.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_snn_streamed_kernel<kStaged>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- C interface (loaded with ctypes) -------------------------------------
// ptrs and ints as stack_params_from_c() in snn_stack_common.cuh reads them,
// except that each layer's weights are its int8 planes (2, n_out, n_in),
// 16-byte aligned, with 2 * n_out * n_in < 2^31.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int repro_fused_snn_streamed(const void* ptrs_v, int n_ptrs,
                                        const void* ints_v, int n_ints,
                                        void* stream) {
  StackParams p;
  cudaError_t err = stack_params_from_c(ptrs_v, n_ptrs, ints_v, n_ints, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.chunk < 1) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < p.L; ++l) {
    const long long k = l == 0 ? p.k0 : p.n[l - 1];
    if (((uintptr_t)p.w[l] & 15) != 0) return (int)cudaErrorMisalignedAddress;
    if (2 * k * p.n[l] >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  }
  // the stages when the launch's shared memory holds them with the rest
  const bool staged =
      carve_streamed(p, nullptr, nullptr, true) <= (size_t)p.smem_bytes;
  if (carve_streamed(p, nullptr, nullptr, staged) > (size_t)p.smem_bytes)
    return (int)cudaErrorInvalidValue;
  return (int)(staged ? launch_streamed<true>(p, (cudaStream_t)stream)
                      : launch_streamed<false>(p, (cudaStream_t)stream));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
