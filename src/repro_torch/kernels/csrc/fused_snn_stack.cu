// Fused Poisson-encode -> integer LIF stack, one launch per window chunk.
//
// Replaces the TPU kernel repro/kernels/fused_snn.py::fused_snn_stack_pallas
// (body _stack_kernel, resident mode, gated and ungated).  Per launch every
// batch lane advances `chunk` window steps: xorshift32 PRNG per pixel ->
// spike iff pixel > top byte -> for every layer the sum of the weight rows
// of the spiking inputs, enable mask, saturating add, shift leak, fire,
// reset, active pruning, peak-membrane max-fold -> final-layer spike counts
// and first-spike latch -> executed-add and telemetry counters -> (gated)
// the stability-gate readout that freezes retired lanes.  All state goes in
// and comes out, so k chunks equal one launch.
//
// What bounds it on an H100: bytes.  The work per launch is a few million
// int32 adds (spikes x enabled neurons), far under the card's integer
// rate, while every lane's state has to be read and written once per
// launch: at the serving shape (1024 lanes, 784->10, chunk 4) the function
// must move about 7.8 MB, 82% of it the per-pixel uint32 PRNG state (4 B
// per pixel per lane, in and out).  The kernel reads and writes the op's
// arrays at their real widths (k0 a multiple of 16, any layer width, any
// batch), so the launch moves what the function moves and no more.
//
// The design:
//  * One thread block of 512 threads per 8-lane batch block (the
//    telemetry's block), two warps (64 threads) per lane, one block per SM
//    (__launch_bounds__(512, 1): up to 128 registers a thread).
//  * Each thread holds 16 pixels of its lane for the whole launch, per
//    slot of 1,024 pixels (at most K1_SLOTS, so k0 <= 3,072): the 4-pixel
//    runs t + 64 q (q < 4), their PRNG words and pixels in registers.  A
//    warp's 16-byte load or store of PRNG state covers 512 contiguous
//    bytes; all of them are issued at the start, with every copy of the
//    per-lane state (cp.async), and stored once at the end.  The encoder
//    steps xorshift32 and compares in registers and appends the spiking
//    inputs to the lane's spike list in shared memory (uint16 indices; a
//    warp scan and one shared atomic per warp).
//  * Contraction by layer width.  The lane's 64 threads are S = 64 / G
//    partitions of G threads: G = 16 for N <= 16, 32 for N <= 128, each
//    thread adding the int16 codes of CK = 1, 2 or 4 columns (g + G k) for
//    every entry of its partition's contiguous share of the list, eight
//    entries per 16-byte shared load, eight rows' loads in flight; the
//    partitions' sums meet by warp shuffles and one shared-memory
//    hand-over from the second warp.  A wider layer has G = 64 (one
//    partition) and walks the list once per 256 columns.  A warp's gather
//    touches at most two rows, so at most two cache lines.  The codes are
//    read at their real width (784 x 10 x 2 B = 15.7 KB for the paper's
//    head).
//  * The LIF update runs on the thread that holds a column's sum, against
//    the lane's membranes, peaks and enables in shared memory; fired
//    neurons are ballots appended to the next layer's list, so hidden
//    spikes never leave shared memory.
//  * Gate and telemetry by warps: the lane's first warp runs the
//    first-index argmax by warp shuffles, for a head of <= 16 columns right
//    after its LIF update on the registers of the threads that own its
//    columns, else over shared memory (gate_step); per layer one of the
//    last warps (idle during the gate) counts the block's live 128 x 128
//    tile pairs from the flags by ballots; list lengths are the spike
//    counts, enabled counts are warp sums added into shared counters.
//  * The shared-memory layout is computed on the host and passed as a
//    kernel parameter of byte offsets, so that no table of section
//    pointers lives in local memory.
//
// Where it needs care:
//  1. Frozen lanes (gated, active false) draw their would-be spikes from
//     the unadvanced state and run the whole datapath: those spikes and
//     their enables set the block's tile flags, and their fired neurons
//     feed the next layer's list, as in the reference.  Only their state,
//     counters and per-lane telemetry (n_spk, n_en, adds) stay unchanged.
//     Skipping them would change tiles_skipped.
//  2. The shared-memory carve-up (carve() below) is stack_smem_bytes() in
//     kernels/fused_snn.py, which decides what `auto` sends here; it holds
//     every stack the earlier layout (pixels and PRNG state in shared
//     memory) held, and more (one hidden layer up to 2,176 columns).
//  3. Ragged widths: k0 is a multiple of 16 (the op pads it); a layer of
//     any width has masked column tails (a column past N neither loads nor
//     fires, and its ballot bit is 0) and ceil(N / 128) telemetry tiles.
//     A batch that is not a multiple of 8 leaves rows of the last block
//     zero-filled (no pixel, no state, no enable: they never spike) and
//     frozen; they are never stored.
//  4. Registers: 512 threads with a block minimum of 1 allow 128 a thread
//     (F-w); offsets in the loops are 32-bit (F-z).  One slot compiles
//     without spill; the nvcc report lists each slot count's.
//  5. Inputs and neurons are indexed in 16 bits: a layer holds at most
//     65,535 neurons.
//  6. The first-index argmax of a head narrower than a warp: a lane of the
//     warp with no column must lose every comparison (gate_step's
//     sentinel), or it would win a tie at 0 with index 0.
//  7. List entries land in an order that varies between runs; every sum
//     over them is exact in 32-bit wrapping arithmetic, so results do not.
#include "mma_common.cuh"
#include "snn_stack_common.cuh"

#define LANE_THREADS 64                       // threads per lane: two warps
#define K1_THREADS (BLOCK_B * LANE_THREADS)   // 512
#define RUNS_PER_SLOT 256                     // 4-pixel runs a lane's slot
                                              // holds: 16 pixels a thread
#define K1_SLOTS 3                            // slots a thread may hold
#define CK_MAX 4                              // columns per contraction thread
#define XCH_G 32                              // widest G handed over

// Shared-memory carve-up, as byte offsets into the dynamic shared memory;
// the same layout as stack_smem_bytes() in kernels/fused_snn.py.  The host
// computes it and passes it as a kernel parameter, so that the per-layer
// sections are found by a constant-bank load and not through a pointer
// table in local memory.
struct K1Layout {
  uint32_t v[MAX_LAYERS], vp[MAX_LAYERS], en[MAX_LAYERS];  // BLOCK_B x n_l
  uint32_t tx[MAX_LAYERS];  // per layer: K tiles with a spike in the block
  uint32_t te[MAX_LAYERS];  // per layer: N tiles with an enabled neuron
  uint32_t cnt, first;      // BLOCK_B x n_L
  uint32_t list[2];         // input spike lists, ping-pong: BLOCK_B x cap
  uint32_t xch;             // second warp's sums: BLOCK_B x 32 x CK_MAX
  uint32_t lane;            // per lane: active, steps, gate prev, streak
  uint32_t nsp;             // per layer and lane: list length (input spikes)
  uint32_t nen;             // per layer and lane: enabled neurons
  int cap;                  // entries of one lane's list: the widest input,
                            // rounded up to 8
  int n_flags;
  uint32_t bytes;
};

__host__ __device__ inline uint32_t align16(uint32_t x) {
  return (x + 15u) & ~15u;
}
__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ inline int layer_in(const StackParams& p, int l) {
  return l == 0 ? p.k0 : p.n[l - 1];
}

static K1Layout carve(const StackParams& p) {
  K1Layout y = {};
  uint32_t off = 0;
  auto take = [&](uint32_t bytes) {
    const uint32_t at = off;
    off += align16(bytes);
    return at;
  };
  const uint32_t bB = BLOCK_B;
  int cap = 0;
  for (int l = 0; l < p.L; ++l)
    if (layer_in(p, l) > cap) cap = layer_in(p, l);
  cap = (cap + 7) & ~7;   // 16-byte list rows, read 8 entries at a time
  const uint32_t nL = p.n[p.L - 1];
  for (int l = 0; l < p.L; ++l) {
    y.v[l] = take(bB * p.n[l] * 4);
    y.vp[l] = take(bB * p.n[l] * 4);
    y.en[l] = take(bB * p.n[l]);
  }
  y.cnt = take(bB * nL * 4);
  y.first = take(bB * nL * 4);
  y.list[0] = take(bB * cap * 2);
  y.list[1] = take(bB * cap * 2);
  y.xch = take(bB * XCH_G * CK_MAX * 4);
  y.lane = take(bB * 4 * 4);
  y.nsp = take(p.L * bB * 4);
  y.nen = take(p.L * bB * 4);
  int flags = 0;
  for (int l = 0; l < p.L; ++l) {
    y.tx[l] = off + 4 * flags;
    flags += ceil_div(layer_in(p, l), TILE);
    y.te[l] = off + 4 * flags;
    flags += ceil_div(p.n[l], TILE);
  }
  take(4 * flags);
  y.cap = cap;
  y.n_flags = flags;
  y.bytes = off;
  return y;
}

template <typename T>
__device__ __forceinline__ T* at(unsigned char* smem, uint32_t off) {
  return (T*)(smem + off);
}

// ---- block copies of the 8 lanes' rows -------------------------------------
// `n` bytes of global memory into shared memory by cp.async (16-byte pieces
// where the global address allows, else 4-byte ones; a tail of single
// bytes by plain loads), the rest of `total` zeroed.  The caller commits
// and waits, so that every copy of the load phase is in flight at once.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_in(unsigned char* dst,
                                        const unsigned char* src, int n,
                                        int total) {
  const int tid = threadIdx.x;
  int done = 0;
  if (((uintptr_t)src & 15) == 0) {
    done = n & ~15;
    for (int i = tid; i < (n >> 4); i += K1_THREADS)
      cp_async16_zfill(dst + 16 * i, src + 16 * i, true);
  }
  if (((uintptr_t)src & 3) == 0) {
    for (int i = (done >> 2) + tid; i < (n >> 2); i += K1_THREADS)
      cp_async4(dst + 4 * i, src + 4 * i);
    done = n & ~3;
  }
  for (int i = done + tid; i < n; i += K1_THREADS) dst[i] = __ldg(src + i);
  for (int i = n + tid; i < total; i += K1_THREADS) dst[i] = 0;
}

__device__ __forceinline__ void copy_out(unsigned char* dst,
                                         const unsigned char* src, int n) {
  const int tid = threadIdx.x;
  int done = 0;
  if (((uintptr_t)dst & 15) == 0) {
    done = n & ~15;
    for (int i = tid; i < (n >> 4); i += K1_THREADS)
      ((uint4*)dst)[i] = ((const uint4*)src)[i];
  } else if (((uintptr_t)dst & 3) == 0) {
    done = n & ~3;
    for (int i = tid; i < (n >> 2); i += K1_THREADS)
      ((uint32_t*)dst)[i] = ((const uint32_t*)src)[i];
  }
  for (int i = done + tid; i < n; i += K1_THREADS) dst[i] = src[i];
}

// ---- the encoder: one slot of 16 pixels ------------------------------------
// Four runs of 4 pixels (s[q], pw[q]): xorshift32 on each PRNG word; pixel
// byte b of pw[q] spikes iff it exceeds the new word's top byte (px > s >>
// 24, i.e. s < px << 24).  With ADVANCE the words keep their new values
// (an active lane); a frozen lane draws the same would-be spikes and keeps
// its words.  Returns 16 spike bits, bit 4 q + b for byte b of run q.
template <bool ADVANCE>
__device__ __forceinline__ uint32_t encode16(uint4 (&s)[4],
                                             const uint32_t (&pw)[4]) {
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t w[4] = {s[q].x, s[q].y, s[q].z, s[q].w};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t n = xorshift32(w[b]);
      bits |= (uint32_t)(n < (pw[q] >> (8 * b) << 24)) << (4 * q + b);
      w[b] = n;
    }
    if (ADVANCE) s[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return bits;
}

// Append `count` entries of this warp to a lane's list: returns this
// thread's first slot (a warp-wide exclusive scan, one shared atomic on the
// list's length).  Entries land in an order that varies between runs; the
// sums over them do not.
__device__ __forceinline__ int list_slot(int count, int32_t* len) {
  const int wl = threadIdx.x & 31;
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, o);
    if (wl >= o) incl += y;
  }
  const int total = __shfl_sync(FULL_MASK, incl, 31);
  int base = 0;
  if (wl == 0 && total) base = atomicAdd(len, total);
  return __shfl_sync(FULL_MASK, base, 0) + incl - count;
}

// The run (4 pixels, one uint4 of PRNG state) that thread lt of a lane
// holds as register q of slot j.
__device__ __forceinline__ int run_of(int j, int q, int lt) {
  return RUNS_PER_SLOT * j + LANE_THREADS * q + lt;
}

// ---- one layer: contraction, then the LIF update on the sums' owners -------
// Every thread of the block calls it (it holds block barriers).  The lane's
// input spikes are `lin` (its list) of `n_in` entries; its fired neurons
// are appended to `lout`, counted in `len_out`.
template <int CK>
__device__ __forceinline__ void run_layer(const StackParams& p,
                                          const K1Layout& y,
                                          unsigned char* smem, int l, int t,
                                          bool act, int steps, int row) {
  const int N = p.n[l];
  const bool last = l == p.L - 1;
  const int r = threadIdx.x / LANE_THREADS, lt = threadIdx.x % LANE_THREADS;
  const int wil = lt >> 5, wl = threadIdx.x & 31;
  const int G = N <= 16 ? 16 : N <= 128 ? 32 : 64;
  const int S = LANE_THREADS / G;
  const int g = lt & (G - 1), part = lt / G;
  const uint16_t* lin = at<uint16_t>(smem, y.list[l & 1]) + r * y.cap;
  uint16_t* lout = at<uint16_t>(smem, y.list[(l + 1) & 1]) + r * y.cap;
  const int n_in = at<int32_t>(smem, y.nsp)[l * BLOCK_B + r];
  int32_t* len_out = at<int32_t>(smem, y.nsp) + (l + 1) * BLOCK_B + r;
  const int16_t* __restrict__ W = p.w[l];
  int32_t* vr = at<int32_t>(smem, y.v[l]) + r * N;
  int32_t* vpr = at<int32_t>(smem, y.vp[l]) + r * N;
  uint8_t* enr = at<uint8_t>(smem, y.en[l]) + r * N;
  int* te = at<int>(smem, y.te[l]);
  int* tx_next = last ? nullptr : at<int>(smem, y.tx[l + 1]);
  const LifConsts lc = {p.decay_shift, p.v_th, p.v_rest, p.v_min, p.v_max};
  int nen = 0;

  for (int cbase = 0; cbase < N; cbase += CK * G) {
    int acc[CK];
    bool cok[CK];
#pragma unroll
    for (int k = 0; k < CK; ++k) {
      acc[k] = 0;
      cok[k] = cbase + g + G * k < N;
    }
    bool owner = true;
    // partition `part` takes the list entries [e0, e1), 8 per 16-byte
    // shared load; each entry's CK codes at 32-bit offsets from W
    const int per = ((n_in + S - 1) / S + 7) & ~7;
    const int e0 = part * per, e1 = min(n_in, e0 + per);
    const uint32_t col = cbase + g;
    for (int e = e0; e < e1; e += 8) {
      const uint4 q = *(const uint4*)(lin + e);
      const uint32_t pr[4] = {q.x, q.y, q.z, q.w};
      int val[8][CK];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const uint32_t off =
            (pr[u >> 1] >> (16 * (u & 1)) & 0xffffu) * N + col;
#pragma unroll
        for (int k = 0; k < CK; ++k)
          val[u][k] =
              (e + u < e1 && cok[k]) ? (int)__ldg(W + off + G * k) : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int k = 0; k < CK; ++k) acc[k] += val[u][k];
    }
    // the partitions' sums meet on the first G threads of the first warp
    if (G < LANE_THREADS) {
      for (int o = 16; o >= G; o >>= 1)
#pragma unroll
        for (int k = 0; k < CK; ++k)
          acc[k] += __shfl_down_sync(FULL_MASK, acc[k], o);
      int32_t* x = at<int32_t>(smem, y.xch) + (r * XCH_G + wl) * CK_MAX;
      if (wil == 1 && wl < G)
#pragma unroll
        for (int k = 0; k < CK; ++k) x[k] = acc[k];
      __syncthreads();
      owner = wil == 0 && wl < G;
      if (owner)
#pragma unroll
        for (int k = 0; k < CK; ++k) acc[k] += x[k];
    }
    // LIF on the owners
    unsigned eb[CK], fb[CK];
    int h_cnt = 0, h_first = 0, h_v = 0, h_vp = 0;   // a head column's state
#pragma unroll
    for (int k = 0; k < CK; ++k) {
      const int c = cbase + g + G * k;
      const bool valid = owner && cok[k];
      const bool e = valid && enr[c] != 0;
      bool fired = false;
      if (valid) {
        const int v_old = vr[c];
        const int v_new = lif_update(v_old, e ? acc[k] : 0, e, lc, &fired);
        if (act) {
          vr[c] = v_new;
          enr[c] = (p.pruning ? (e && !fired) : e) ? 1 : 0;
          vpr[c] = h_vp = max(vpr[c], v_new);
        }
        if (last) {
          int32_t* cnt = at<int32_t>(smem, y.cnt) + r * N;
          int32_t* first = at<int32_t>(smem, y.first) + r * N;
          if (act && fired) {
            cnt[c] += 1;
            if (first[c] == p.window) first[c] = steps;
          }
          h_cnt = cnt[c], h_first = first[c], h_v = v_new;
          if (row < p.B)
            p.vtr[((size_t)t * p.B + row) * N + c] = act ? v_new : v_old;
        }
      }
      eb[k] = __ballot_sync(FULL_MASK, e);
      fb[k] = __ballot_sync(FULL_MASK, fired);
    }
    // enabled counts, tile flags and the next layer's list, by the warps
    // that own columns: group k of this warp is G (<= 32) columns from
    // cbase + G k, or 32 from cbase + 32 wil + 64 k
    int n_fired = 0;
#pragma unroll
    for (int k = 0; k < CK; ++k) {
      nen += __popc(eb[k]);
      n_fired += __popc(fb[k]);
      const int w0 = G == LANE_THREADS ? cbase + 32 * wil + 64 * k
                                       : cbase + G * k;
      if (wl == 0 && eb[k]) te[w0 / TILE] = 1;
      if (wl == 0 && fb[k] && !last) tx_next[w0 / TILE] = 1;
    }
    if (CK == 1 && G == 16 && last && p.gated && act && wil == 0) {
      // the stability gate of a head of <= 16 columns, on its owners'
      // registers: column g on lane g of the lane's first warp
      const bool h = owner && cok[0];
      const bool has_spike = __any_sync(FULL_MASK, h && h_cnt > 0);
      const int pred = first_argmax_warp(
          h ? gate_score(p.readout, p.window, h_cnt, h_first, h_v, h_vp)
            : -2147483647 - 1,
          h ? g : 0x7fffffff);
      int32_t* ls = at<int32_t>(smem, y.lane) + 4 * r;
      int st_ = steps, gp = ls[2], gs = ls[3];
      bool a = true;
      gate_decide(pred, has_spike, p.window, p.patience, st_, a, gp, gs);
      if (wl == 0) ls[0] = a, ls[1] = st_, ls[2] = gp, ls[3] = gs;
    }
    if (!last) {
      int slot = 0;
      if (wl == 0 && n_fired) slot = atomicAdd(len_out, n_fired);
      slot = __shfl_sync(FULL_MASK, slot, 0);
      const unsigned below = (1u << wl) - 1u;
#pragma unroll
      for (int k = 0; k < CK; ++k) {
        if (fb[k] >> wl & 1u)
          lout[slot + __popc(fb[k] & below)] = (uint16_t)(cbase + g + G * k);
        slot += __popc(fb[k]);
      }
    }
  }
  if (wl == 0 && nen)
    atomicAdd(at<int32_t>(smem, y.nen) + l * BLOCK_B + r, nen);
  __syncthreads();
}

template <int NS>
__global__ void __launch_bounds__(K1_THREADS, 1)
fused_snn_stack_kernel(const StackParams p, const K1Layout y) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.L, K0 = p.k0, nL = p.n[L - 1];
  const int r = threadIdx.x / LANE_THREADS, lt = threadIdx.x % LANE_THREADS;
  const int wil = lt >> 5, wl = threadIdx.x & 31;
  const int row0 = blockIdx.x * BLOCK_B, row = row0 + r;
  const int rows = min(BLOCK_B, p.B - row0);
  const bool live = r < rows;
  const int nruns = K0 / 4;
  int32_t* lane_s = at<int32_t>(smem, y.lane) + 4 * r;
  int32_t* nsp_s = at<int32_t>(smem, y.nsp);
  int32_t* nen_s = at<int32_t>(smem, y.nen);

  // ---- load: every copy in flight at once --------------------------------
  // this thread's pixel runs: PRNG words and pixels into registers.  Run
  // (j, q) is the 4 pixels from 4 u, u = 256 j + 64 q + lt, so that each
  // load and store of a warp covers 512 contiguous bytes of PRNG state
  uint4 st[NS][4];
  uint32_t px[NS][4];
  {
    const uint4* st_row = (const uint4*)(p.st_in + (size_t)row * K0);
    const uint32_t* px_row = (const uint32_t*)(p.px + (size_t)row * K0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int u = run_of(j, q, lt);
        const bool have = live && u < nruns;
        st[j][q] = have ? __ldg(st_row + u) : make_uint4(0, 0, 0, 0);
        px[j][q] = have ? __ldg(px_row + u) : 0u;
      }
  }
  // the 8 lanes' membranes, peaks, enables, counts and latches
  for (int l = 0; l < L; ++l) {
    const int N = p.n[l];
    copy_in(smem + y.v[l],
            (const unsigned char*)(p.v_in[l] + (size_t)row0 * N),
            rows * N * 4, BLOCK_B * N * 4);
    copy_in(smem + y.vp[l],
            (const unsigned char*)(p.vp_in[l] + (size_t)row0 * N),
            rows * N * 4, BLOCK_B * N * 4);
    copy_in(smem + y.en[l], p.en_in[l] + (size_t)row0 * N, rows * N,
            BLOCK_B * N);
  }
  copy_in(smem + y.cnt, (const unsigned char*)(p.cnt_in + (size_t)row0 * nL),
          rows * nL * 4, BLOCK_B * nL * 4);
  copy_in(smem + y.first,
          (const unsigned char*)(p.first_in + (size_t)row0 * nL),
          rows * nL * 4, BLOCK_B * nL * 4);
  cp_async_commit();
  if (lt == 0) {
    lane_s[0] = live && (!p.gated || p.act_in[row] != 0);
    lane_s[1] = live ? p.steps_in[row] : 0;
    lane_s[2] = live && p.gated ? p.gprev_in[row] : 0;
    lane_s[3] = live && p.gated ? p.gstreak_in[row] : 0;
  }
  for (int i = threadIdx.x; i < 2 * L * BLOCK_B; i += K1_THREADS)
    nsp_s[i] = 0;     // nsp and nen are adjacent sections
  for (int i = threadIdx.x; i < y.n_flags; i += K1_THREADS)
    at<int>(smem, y.tx[0])[i] = 0;
  cp_async_wait<0>();
  __syncthreads();

  for (int t = 0; t < p.chunk; ++t) {
    const bool act = lane_s[0] != 0;
    const int steps = lane_s[1];

    // ---- encoder: xorshift32 + 8-bit comparator -> the lane's list -------
    uint32_t bits[NS];
    int count = 0;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      bits[j] = act ? encode16<true>(st[j], px[j])
                    : encode16<false>(st[j], px[j]);
      count += __popc(bits[j]);
#pragma unroll
      for (int q = 0; q < 4; ++q)   // a 128-pixel tile is 32 runs
        if (bits[j] >> (4 * q) & 0xfu)
          at<int>(smem, y.tx[0])[run_of(j, q, lt) / (TILE / 4)] = 1;
    }
    {
      uint16_t* lst = at<uint16_t>(smem, y.list[0]) + r * y.cap;
      int slot = list_slot(count, nsp_s + r);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        for (uint32_t b = bits[j]; b; b &= b - 1) {
          const int i = __ffs((int)b) - 1;   // byte i % 4 of run i / 4
          lst[slot++] = (uint16_t)(4 * run_of(j, i >> 2, lt) + (i & 3));
        }
    }
    __syncthreads();

    // ---- the layers: spike lists stay in shared memory between them ------
    for (int l = 0; l < L; ++l) {
      const int N = p.n[l];
      if (N <= 32)
        run_layer<1>(p, y, smem, l, t, act, steps, row);
      else if (N <= 64)
        run_layer<2>(p, y, smem, l, t, act, steps, row);
      else
        run_layer<4>(p, y, smem, l, t, act, steps, row);
    }

    // ---- per-lane records and the stability gate (the lane's first warp) -
    if (wil == 0) {
      if (lt == 0 && live) {
        int adds_t = 0;
#pragma unroll 1
        for (int l = 0; l < L; ++l) {
          const int ns = nsp_s[l * BLOCK_B + r], ne = nen_s[l * BLOCK_B + r];
          const size_t o = ((size_t)t * L + l) * p.B + row;
          p.tspk[o] = act ? ns : 0;
          p.ten[o] = act ? ne : 0;
          adds_t += ns * ne;
        }
        p.adds[(size_t)t * p.B + row] = act ? adds_t : 0;
      }
      __syncwarp();
      if (lt == 0) {
#pragma unroll 1
        for (int l = 0; l < L; ++l)
          nsp_s[l * BLOCK_B + r] = 0, nen_s[l * BLOCK_B + r] = 0;
      }
      if (p.gated) {
        if (act && nL > 16) {   // a narrower head's gate ran in run_layer
          int st_ = steps, gp = lane_s[2], gs = lane_s[3];
          bool a = true;
          gate_step(at<int32_t>(smem, y.cnt) + r * nL,
                    at<int32_t>(smem, y.first) + r * nL,
                    at<int32_t>(smem, y.v[L - 1]) + r * nL,
                    at<int32_t>(smem, y.vp[L - 1]) + r * nL, nL, p.readout,
                    p.window, p.patience, wl, st_, a, gp, gs);
          if (lt == 0) lane_s[0] = a, lane_s[1] = st_, lane_s[2] = gp,
                       lane_s[3] = gs;
        }
      } else if (lt == 0) {
        lane_s[1] = steps + 1;
      }
    }

    // ---- per-block telemetry: skipped 128x128 tile pairs, a warp a layer --
    // (the last warps, each a lane's second warp, idle during the gate)
    const int tw = K1_THREADS / 32 - 1 - (threadIdx.x >> 5);
    if (tw < L) {
      const int l = tw;
      const int nkt = ceil_div(layer_in(p, l), TILE);
      const int nnt = ceil_div(p.n[l], TILE);
      int* tx = at<int>(smem, y.tx[l]);
      int* te = at<int>(smem, y.te[l]);
      int cx = 0, ce = 0;
      for (int k0 = 0; k0 < nkt; k0 += 32) {
        const int k = k0 + wl;
        cx += __popc(__ballot_sync(FULL_MASK, k < nkt && tx[k] != 0));
        if (k < nkt) tx[k] = 0;
      }
      for (int k0 = 0; k0 < nnt; k0 += 32) {
        const int k = k0 + wl;
        ce += __popc(__ballot_sync(FULL_MASK, k < nnt && te[k] != 0));
        if (k < nnt) te[k] = 0;
      }
      if (wl == 0)
        p.ttile[((size_t)t * L + l) * gridDim.x + blockIdx.x] =
            p.sparse_skip ? nkt * nnt - cx * ce : 0;
    }
    __syncthreads();
  }

  // ---- write the carried state back ----------------------------------------
  if (live) {
    uint4* st_row = (uint4*)(p.st_out + (size_t)row * K0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (run_of(j, q, lt) < nruns) st_row[run_of(j, q, lt)] = st[j][q];
    if (lt == 0) {
      p.steps_out[row] = lane_s[1];
      if (p.gated) {
        p.act_out[row] = lane_s[0];
        p.gprev_out[row] = lane_s[2];
        p.gstreak_out[row] = lane_s[3];
      }
    }
  }
  for (int l = 0; l < L; ++l) {
    const int N = p.n[l];
    copy_out((unsigned char*)(p.v_out[l] + (size_t)row0 * N), smem + y.v[l],
             rows * N * 4);
    copy_out((unsigned char*)(p.vp_out[l] + (size_t)row0 * N), smem + y.vp[l],
             rows * N * 4);
    copy_out(p.en_out[l] + (size_t)row0 * N, smem + y.en[l], rows * N);
  }
  copy_out((unsigned char*)(p.cnt_out + (size_t)row0 * nL), smem + y.cnt,
           rows * nL * 4);
  copy_out((unsigned char*)(p.first_out + (size_t)row0 * nL), smem + y.first,
           rows * nL * 4);
}

// ---- C interface (loaded with ctypes) -------------------------------------
// ptrs and ints as stack_params_from_c() in snn_stack_common.cuh reads them,
// at real widths: any batch, k0 a multiple of 16 and at most K1_SLOTS *
// 1,024, layers of any width, each layer's weights the (n_in, n_out) int16
// codes with n_in * n_out < 2^31; pixels, PRNG state in and out 16-byte
// aligned.  Returns the cudaError_t of the launch (0 = launched).
template <int NS>
static cudaError_t launch_stack(const StackParams& p, const K1Layout& y,
                                cudaStream_t stream) {
  static int smem_cap[MAX_DEVICES] = {};
  cudaError_t err = raise_smem_cap((const void*)fused_snn_stack_kernel<NS>,
                                   p.smem_bytes, smem_cap);
  if (err != cudaSuccess) return err;
  fused_snn_stack_kernel<NS><<<ceil_div(p.B, BLOCK_B), K1_THREADS,
                               p.smem_bytes, stream>>>(p, y);
  return cudaGetLastError();
}

extern "C" int repro_fused_snn_stack(const void* ptrs_v, int n_ptrs,
                                     const void* ints_v, int n_ints,
                                     void* stream) {
  StackParams p;
  cudaError_t err =
      stack_params_from_c(ptrs_v, n_ptrs, ints_v, n_ints, &p, true);
  if (err != cudaSuccess) return (int)err;
  if (p.chunk < 1) return (int)cudaErrorInvalidValue;
  const int slots = ceil_div(p.k0 / 4, RUNS_PER_SLOT);
  if (slots > K1_SLOTS) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < p.L; ++l)
    if ((long long)layer_in(p, l) * p.n[l] >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)p.px | (uintptr_t)p.st_in | (uintptr_t)p.st_out) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const K1Layout y = carve(p);
  if (y.bytes > (uint32_t)p.smem_bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  err = slots <= 1 ? launch_stack<1>(p, y, st)
        : slots == 2 ? launch_stack<2>(p, y, st)
                     : launch_stack<3>(p, y, st);
  return (int)err;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
