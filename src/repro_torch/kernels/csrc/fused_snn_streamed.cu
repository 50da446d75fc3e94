// Fused Poisson-encode -> integer LIF stack with the weights streamed
// through shared memory, one launch per window chunk.
//
// Replaces the TPU kernel repro/kernels/fused_snn.py::fused_snn_stack_pallas
// with streamed=True (body _stack_kernel; the slab pipeline slab_dma /
// pre_k / read_tile, gated and ungated).  It computes what the resident
// kernel (fused_snn_stack.cu) computes, on the same operands with the same
// outputs, for stacks whose per-lane state does not fit one thread block's
// shared memory: SNN_CONFIG_WIDE (784->2048->2048->10) needs 413,984 B per
// 8-lane block in the resident layout, 1.78x what a block may use.
//
// What bounds it on an H100: operations, then bytes.  At the serving shape
// (1024 lanes, chunk 4) the function moves about 95 MB (the per-lane state
// in and out, 11.6 MB of int16 weights once), ~28 us at 3.35 TB/s, while
// its executed adds (spikes x enabled neurons, ~0.7 G per step at a 10%
// hidden spike density) take longer at the card's INT32 rate.  In the
// launch itself the weights are the traffic that grows: a kernel that has
// each lane gather its own weight rows reads 4 KB per spike per lane
// (lanes x spikes x width), and at 1024 lanes that is gigabytes per step.
//
// What the design does about it:
//  * One thread block per 8-lane batch block, one warp per lane, as in the
//    resident kernel.  Pixels, PRNG state (896 x 8 lanes x 5 B = 35 KB) and
//    the spike bitmaps stay in shared memory; the spike train never exists
//    in device memory.
//  * Membranes, enables and peaks of every layer, and the output counters,
//    live in the launch's own output tensors in global memory.  Each
//    element is owned by one thread for the whole launch (lane = warp,
//    column = lane mod 32), so accesses are coalesced, nothing races and
//    no state passes between blocks.
//  * Weights stream through shared memory in slabs of SLAB_ROWS rows x one
//    128-column tile of int16 codes, in a ring of STAGES slabs filled by
//    cp.async STAGES - 1 slabs ahead of the slab being added, so the copy
//    overlaps the adds.  A slab holds the rows of the block's UNION of
//    spiking inputs (the rows no lane of the block needs are never read),
//    and every lane of the block adds from the same slab, so the block
//    reads each weight at most once per step instead of once per lane's
//    spike.  Output tiles with no enabled neuron in the block are not
//    streamed (their current is masked to zero anyway).
//  * Adds only: each warp walks its own lane's positions in the union list
//    and adds those slab rows; no multiply, no matrix unit.
//  * The telemetry tile-skip count keeps the reference geometry (128x128
//    tile pairs per 8-lane block) from per-block tile flags.
#include "snn_stack_common.cuh"

#define SLAB_ROWS 64  // union rows per slab (64 x 128 int16 = 16 KB)
#define STAGES 3      // slabs in the shared-memory ring
#define CHUNKS_PER_ROW (TILE * 2 / 16)  // 16-byte copies per slab row

struct StreamedSmem {
  int16_t* slab;               // (STAGES, SLAB_ROWS, TILE) weight codes
  uint32_t* st;                // (bB, k0) PRNG state
  uint32_t* xa;                // (bB, widest/32) spike bitmaps, ping
  uint32_t* xb;                // (bB, widest/32) spike bitmaps, pong
  int* tx[MAX_LAYERS];         // K-tile has a spike in the block
  int* te[MAX_LAYERS];         // N-tile has an enabled neuron in the block
  int* livet;                  // output tiles streamed this layer
  int* misc;                   // [0] union size, [1] live tile count
  uint16_t* ulist;             // the block's union of spiking inputs
  uint16_t* pos;               // (bB, widest) each lane's union positions
  uint8_t* px;                 // (bB, k0) pixels
};

// Shared-memory carve-up; the same layout as stack_streamed_smem_bytes()
// in kernels/fused_snn.py.  Returns the bytes it needs.
__host__ __device__ inline size_t carve_streamed(const StackParams& p,
                                                 unsigned char* base,
                                                 StreamedSmem* s) {
  const size_t bB = p.bB;
  int widest = p.k0;
  for (int l = 0; l < p.L; ++l) widest = p.n[l] > widest ? p.n[l] : widest;
  const size_t words = widest / 32;
  size_t off = 0;
  if (base) s->slab = (int16_t*)(base + off);
  off += (size_t)STAGES * SLAB_ROWS * TILE * 2;
  if (base) s->st = (uint32_t*)(base + off);
  off += bB * p.k0 * 4;
  if (base) s->xa = (uint32_t*)(base + off);
  off += bB * words * 4;
  if (base) s->xb = (uint32_t*)(base + off);
  off += bB * words * 4;
  for (int l = 0; l < p.L; ++l) {
    if (base) s->tx[l] = (int*)(base + off);
    off += 4 * ((l == 0 ? p.k0 : p.n[l - 1]) / TILE);
    if (base) s->te[l] = (int*)(base + off);
    off += 4 * (p.n[l] / TILE);
  }
  if (base) s->livet = (int*)(base + off);
  off += 4 * (widest / TILE);
  if (base) s->misc = (int*)(base + off);
  off += 16;
  if (base) s->ulist = (uint16_t*)(base + off);
  off += (size_t)widest * 2;
  if (base) s->pos = (uint16_t*)(base + off);
  off += bB * widest * 2;
  if (base) s->px = (uint8_t*)(base + off);
  off += bB * p.k0;
  return off;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(32 * BLOCK_B)
fused_snn_streamed_kernel(const StackParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  StreamedSmem s;
  carve_streamed(p, smem, &s);

  const int L = p.L, K0 = p.k0, nL = p.n[L - 1];
  const LifConsts lc = {p.decay_shift, p.v_th, p.v_rest, p.v_min, p.v_max};
  const bool pruning = p.pruning != 0;
  const int window = p.window;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int row = blockIdx.x * p.bB + warp;   // this warp's batch lane
  const size_t B = p.B;
  int widest = K0;
  for (int l = 0; l < L; ++l) widest = p.n[l] > widest ? p.n[l] : widest;
  const int words = widest / 32;

  // ---- PRNG state and pixels into shared memory; the carried per-neuron
  //      state into the output tensors, where it stays ---------------------
  uint32_t* st_r = s.st + (size_t)warp * K0;
  uint8_t* px_r = s.px + (size_t)warp * K0;
  for (int i = lane; i < K0; i += 32) {
    st_r[i] = p.st_in[row * (size_t)K0 + i];
    px_r[i] = p.px[row * (size_t)K0 + i];
  }
  for (int l = 0; l < L; ++l) {
    const int N = p.n[l];
    for (int i = lane; i < N; i += 32) {
      const size_t idx = row * (size_t)N + i;
      p.v_out[l][idx] = p.v_in[l][idx];
      p.vp_out[l][idx] = p.vp_in[l][idx];
      p.en_out[l][idx] = p.en_in[l][idx];
    }
  }
  int32_t* cnt_r = p.cnt_out + row * (size_t)nL;
  int32_t* first_r = p.first_out + row * (size_t)nL;
  for (int i = lane; i < nL; i += 32) {
    cnt_r[i] = p.cnt_in[row * (size_t)nL + i];
    first_r[i] = p.first_in[row * (size_t)nL + i];
  }
  int steps = p.steps_in[row];
  bool act = p.gated ? p.act_in[row] != 0 : true;
  int gprev = p.gated ? p.gprev_in[row] : 0;
  int gstreak = p.gated ? p.gstreak_in[row] : 0;
  int n_flags = 0;
  for (int l = 0; l < L; ++l)
    n_flags += (l == 0 ? K0 : p.n[l - 1]) / TILE + p.n[l] / TILE;
  for (int i = threadIdx.x; i < n_flags; i += blockDim.x) s.tx[0][i] = 0;
  __syncthreads();

  for (int t = 0; t < p.chunk; ++t) {
    uint32_t* x_in = s.xa;    // every lane's input bitmap of this layer
    uint32_t* x_out = s.xb;   // every lane's fired bitmap of this layer

    // ---- encoder: xorshift32 + 8-bit comparator -> spike bitmap ---------
    int nsp = 0;
    for (int base = 0; base < K0; base += 32) {
      const int i = base + lane;
      const uint32_t r = xorshift32(st_r[i]);
      if (act) st_r[i] = r;
      const unsigned m = __ballot_sync(FULL_MASK, px_r[i] > (uint8_t)(r >> 24));
      if (lane == 0) x_in[warp * words + base / 32] = m;
      nsp += __popc(m);
    }

    int adds_t = 0;
    for (int l = 0; l < L; ++l) {
      const int K = l == 0 ? K0 : p.n[l - 1];
      const int N = p.n[l];
      const int kw = K / 32, n_tiles = N / TILE;
      const bool last = (l == L - 1);
      const int16_t* Wl = p.w[l];
      int32_t* v_l = p.v_out[l] + row * (size_t)N;
      int32_t* vp_l = p.vp_out[l] + row * (size_t)N;
      uint8_t* en_l = p.en_out[l] + row * (size_t)N;
      __syncthreads();   // every lane's input bitmap is written, and the
                         // previous layer's slabs are consumed

      // (a) warp 0: the block's union of spiking inputs, in row order, and
      //     the K-tile flags
      if (warp == 0) {
        int nu = 0;
        for (int w0 = 0; w0 < kw; w0 += 32) {
          const int wi = w0 + lane;
          uint32_t u = 0;
          if (wi < kw)
            for (int b = 0; b < p.bB; ++b) u |= x_in[b * words + wi];
          const int c = __popc(u);
          int incl = c;
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL_MASK, incl, o);
            if (lane >= o) incl += y;
          }
          int at = nu + incl - c;
          if (c) s.tx[l][wi / 4] = 1;
          while (u) {
            const int bit = __ffs(u) - 1;
            u &= u - 1;
            s.ulist[at++] = (uint16_t)(wi * 32 + bit);
          }
          nu += __shfl_sync(FULL_MASK, incl, 31);
        }
        if (lane == 0) s.misc[0] = nu;
      }
      // (b) every warp: its lane's enabled neurons and the N-tile flags
      int nen = 0;
      for (int c0 = 0; c0 < N; c0 += 32) {
        const unsigned em = __ballot_sync(FULL_MASK, en_l[c0 + lane] != 0);
        nen += __popc(em);
        if (em && lane == 0) s.te[l][c0 / TILE] = 1;
      }
      __syncthreads();
      const int nu = s.misc[0];
      const int ns = (nu + SLAB_ROWS - 1) / SLAB_ROWS;   // slabs per tile

      // (c) thread 0: the output tiles to stream; every warp: its lane's
      //     positions in the union list, in order
      if (threadIdx.x == 0) {
        int nlive = 0;
        if (ns > 0)
          for (int tt = 0; tt < n_tiles; ++tt)
            if (s.te[l][tt]) s.livet[nlive++] = tt;
        s.misc[1] = nlive;
      }
      uint16_t* pos_r = s.pos + (size_t)warp * widest;
      const uint32_t* xin_r = x_in + warp * words;
      int npos = 0;
      for (int u0 = 0; u0 < nu; u0 += 32) {
        const int u = u0 + lane;
        bool mine = false;
        if (u < nu) {
          const int r = s.ulist[u];
          mine = (xin_r[r >> 5] >> (r & 31)) & 1u;
        }
        const unsigned m = __ballot_sync(FULL_MASK, mine);
        if (mine) pos_r[npos + __popc(m & lt_mask)] = (uint16_t)u;
        npos += __popc(m);
      }
      __syncthreads();
      const int njobs = s.misc[1] * ns;   // (live tile, slab) pairs

      // One tile's LIF update for this lane; fired neurons go to the next
      // layer's bitmap, or to the counters on the last layer.
      int nfired = 0;
      auto update_tile = [&](int tt, const unsigned (&acc)[4]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tt * TILE + 32 * j + lane;
          const bool e = en_l[col] != 0;
          bool fired;
          const int v_new = lif_update(v_l[col], e ? (int)acc[j] : 0, e, lc,
                                       &fired);
          if (act) {
            v_l[col] = v_new;
            en_l[col] = (pruning ? (e && !fired) : e) ? 1 : 0;
            vp_l[col] = max(vp_l[col], v_new);
          }
          const unsigned fm = __ballot_sync(FULL_MASK, fired);
          if (last) {
            if (act && fired) {
              cnt_r[col] += 1;
              if (first_r[col] == window) first_r[col] = steps;
            }
          } else {
            if (lane == 0) x_out[warp * words + col / 32] = fm;
            nfired += __popc(fm);
          }
        }
      };

      // The copy of job j's slab: union rows [sl * SLAB_ROWS, ...) of
      // output tile livet[j / ns], into ring slot j % STAGES.
      auto fetch = [&](int j) {
        const int tt = s.livet[j / ns], u0 = (j % ns) * SLAB_ROWS;
        const int rows = min(SLAB_ROWS, nu - u0);
        int16_t* dst = s.slab + (size_t)(j % STAGES) * SLAB_ROWS * TILE;
        const int16_t* src = Wl + (size_t)tt * TILE;
        for (int q = threadIdx.x; q < rows * CHUNKS_PER_ROW; q += blockDim.x) {
          const int r = q / CHUNKS_PER_ROW, c = (q % CHUNKS_PER_ROW) * 8;
          cp_async16(dst + r * TILE + c, src + (size_t)s.ulist[u0 + r] * N + c);
        }
      };

      // (d) the slab pipeline over the live tiles
      for (int j = 0; j < STAGES - 1; ++j) {
        if (j < njobs) fetch(j);
        cp_async_commit();
      }
      unsigned acc[4] = {0u, 0u, 0u, 0u};
      int cur = 0;
      for (int j = 0; j < njobs; ++j) {
        cp_async_wait<STAGES - 2>();   // job j's slab has landed ...
        __syncthreads();               // ... for every thread, and slot
                                       // (j - 1) % STAGES is free again
        if (j + STAGES - 1 < njobs) fetch(j + STAGES - 1);
        cp_async_commit();
        const int sl = j % ns;
        if (sl == 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] = 0u;
          cur = 0;
        }
        const int u0 = sl * SLAB_ROWS, end = u0 + SLAB_ROWS;
        const int16_t* slab =
            s.slab + (size_t)(j % STAGES) * SLAB_ROWS * TILE + lane;
        for (; cur < npos && pos_r[cur] < end; ++cur) {
          const int16_t* wr = slab + (pos_r[cur] - u0) * TILE;
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] += (unsigned)(int)wr[32 * k];
        }
        if (sl == ns - 1) update_tile(s.livet[j / ns], acc);
      }
      // (e) tiles the pipeline did not visit get zero current
      const unsigned zero[4] = {0u, 0u, 0u, 0u};
      for (int tt = 0; tt < n_tiles; ++tt)
        if (ns == 0 || !s.te[l][tt]) update_tile(tt, zero);

      adds_t += nsp * nen;
      if (lane == 0) {
        const size_t o = ((size_t)t * L + l) * B + row;
        p.tspk[o] = act ? nsp : 0;
        p.ten[o] = act ? nen : 0;
      }
      uint32_t* tmp = x_in;
      x_in = x_out;
      x_out = tmp;
      nsp = nfired;
    }

    // ---- final-layer trace, energy counter and stability gate ------------
    const int32_t* vL = p.v_out[L - 1] + row * (size_t)nL;
    for (int i = lane; i < nL; i += 32)
      p.vtr[((size_t)t * B + row) * nL + i] = vL[i];
    if (lane == 0) p.adds[(size_t)t * B + row] = act ? adds_t : 0;
    if (p.gated) {
      if (act)
        gate_step(cnt_r, first_r, vL, p.vp_out[L - 1] + row * (size_t)nL, nL,
                  p.readout, p.window, p.patience, lane, steps, act, gprev,
                  gstreak);
    } else {
      steps += 1;
    }

    // ---- per-block telemetry: skipped 128x128 tile pairs -----------------
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int l = 0; l < L; ++l) {
        const int nkt = (l == 0 ? K0 : p.n[l - 1]) / TILE;
        const int nnt = p.n[l] / TILE;
        int cx = 0, ce = 0;
        for (int k = 0; k < nkt; ++k) {
          cx += s.tx[l][k];
          s.tx[l][k] = 0;
        }
        for (int k = 0; k < nnt; ++k) {
          ce += s.te[l][k];
          s.te[l][k] = 0;
        }
        p.ttile[((size_t)t * L + l) * gridDim.x + blockIdx.x] =
            p.sparse_skip ? nkt * nnt - cx * ce : 0;
      }
    }
    __syncthreads();
  }

  // ---- write the carried PRNG state and the lane's counters back -----------
  for (int i = lane; i < K0; i += 32) p.st_out[row * (size_t)K0 + i] = st_r[i];
  if (lane == 0) {
    p.steps_out[row] = steps;
    if (p.gated) {
      p.act_out[row] = act ? 1 : 0;
      p.gprev_out[row] = gprev;
      p.gstreak_out[row] = gstreak;
    }
  }
}

// ---- C interface (loaded with ctypes) -------------------------------------
// ptrs and ints as stack_params_from_c() in snn_stack_common.cuh reads them;
// the weights must be 16-byte aligned (cp.async copies 16 bytes).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int repro_fused_snn_streamed(const void* ptrs_v, int n_ptrs,
                                        const void* ints_v, int n_ints,
                                        void* stream) {
  StackParams p;
  cudaError_t err = stack_params_from_c(ptrs_v, n_ptrs, ints_v, n_ints, &p);
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < p.L; ++l)
    if (((uintptr_t)p.w[l] & 15) != 0) return (int)cudaErrorMisalignedAddress;
  if (carve_streamed(p, nullptr, nullptr) > (size_t)p.smem_bytes)
    return (int)cudaErrorInvalidValue;
  static int smem_cap[MAX_DEVICES] = {};
  err = raise_smem_cap((const void*)fused_snn_streamed_kernel, p.smem_bytes,
                       smem_cap);
  if (err != cudaSuccess) return (int)err;
  fused_snn_streamed_kernel<<<p.B / p.bB, 32 * p.bB, p.smem_bytes,
                              (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
