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
// per pixel per lane, in and out).  The launch moves about twice that,
// because its operands arrive padded (896 pixels, 128 output lanes).
//
// What the design does about it:
//  * The PRNG state and pixels are read into shared memory once per launch
//    and written back once; the spike train never exists in device memory.
//  * One thread block per 8-lane batch block, one warp per lane.  Per step
//    a warp turns its lane's pixels into an ordered list of spiking input
//    indices (ballot + popc compaction in shared memory) and accumulates
//    the int16 weight rows of exactly those inputs: the paper's adds-only
//    datapath.  Column groups of 32 neurons with no enabled neuron in the
//    lane are not read at all (their current is masked to zero anyway).
//    The fired neurons of a layer become the next layer's spike list, so
//    hidden-layer spikes never leave shared memory.
//  * Weights stay int16 in global memory (15.7 KB for the paper's 784->10
//    codes, L1/L2 resident); the stack never has to fit shared memory.
//  * Every op is per lane except the telemetry tile-skip count, which is
//    per block and uses the reference geometry (128x128 tile pairs, the
//    8-lane block), so no state passes between thread blocks.
#include "snn_stack_common.cuh"

// Shared-memory carve-up; the same layout as stack_smem_bytes() in
// kernels/fused_snn.py.  Returns the bytes it needs.
__host__ __device__ inline size_t carve(const StackParams& p,
                                        unsigned char* base,
                                        uint32_t** st, int32_t** v,
                                        int32_t** vp, int32_t** cnt,
                                        int32_t** first, uint16_t** list_a,
                                        uint16_t** list_b, uint8_t** px,
                                        uint8_t** en, int** tx, int** te) {
  const size_t bB = p.bB;
  int widest = p.k0;
  for (int l = 0; l < p.L; ++l) widest = p.n[l] > widest ? p.n[l] : widest;
  const int nL = p.n[p.L - 1];
  size_t off = 0;
  if (base) *st = (uint32_t*)(base + off);
  off += bB * p.k0 * 4;
  for (int l = 0; l < p.L; ++l) {
    if (base) v[l] = (int32_t*)(base + off);
    off += bB * p.n[l] * 4;
    if (base) vp[l] = (int32_t*)(base + off);
    off += bB * p.n[l] * 4;
  }
  if (base) *cnt = (int32_t*)(base + off);
  off += bB * nL * 4;
  if (base) *first = (int32_t*)(base + off);
  off += bB * nL * 4;
  if (base) *list_a = (uint16_t*)(base + off);
  off += bB * widest * 2;
  if (base) *list_b = (uint16_t*)(base + off);
  off += bB * widest * 2;
  if (base) *px = (uint8_t*)(base + off);
  off += bB * p.k0;
  for (int l = 0; l < p.L; ++l) {
    if (base) en[l] = (uint8_t*)(base + off);
    off += bB * p.n[l];
  }
  for (int l = 0; l < p.L; ++l) {
    if (base) tx[l] = (int*)(base + off);
    off += 4 * ((l == 0 ? p.k0 : p.n[l - 1]) / TILE);
    if (base) te[l] = (int*)(base + off);
    off += 4 * (p.n[l] / TILE);
  }
  return off;
}

__global__ void __launch_bounds__(32 * BLOCK_B)
fused_snn_stack_kernel(const StackParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* st;
  int32_t* v[MAX_LAYERS];
  int32_t* vp[MAX_LAYERS];
  int32_t* cnt;
  int32_t* first;
  uint16_t* list_a;
  uint16_t* list_b;
  uint8_t* px;
  uint8_t* en[MAX_LAYERS];
  int* tx[MAX_LAYERS];
  int* te[MAX_LAYERS];
  carve(p, smem, &st, v, vp, &cnt, &first, &list_a, &list_b, &px, en, tx,
        te);

  const int L = p.L, K0 = p.k0, nL = p.n[L - 1];
  const LifConsts lc = {p.decay_shift, p.v_th, p.v_rest, p.v_min, p.v_max};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int row = blockIdx.x * p.bB + warp;   // this warp's batch lane
  const size_t B = p.B;
  int widest = K0;
  for (int l = 0; l < L; ++l) widest = p.n[l] > widest ? p.n[l] : widest;

  // ---- load this lane's state into shared memory ------------------------
  uint32_t* st_r = st + (size_t)warp * K0;
  uint8_t* px_r = px + (size_t)warp * K0;
  for (int i = lane; i < K0; i += 32) {
    st_r[i] = p.st_in[row * (size_t)K0 + i];
    px_r[i] = p.px[row * (size_t)K0 + i];
  }
  for (int l = 0; l < L; ++l) {
    const int N = p.n[l];
    for (int i = lane; i < N; i += 32) {
      v[l][warp * N + i] = p.v_in[l][row * (size_t)N + i];
      vp[l][warp * N + i] = p.vp_in[l][row * (size_t)N + i];
      en[l][warp * N + i] = p.en_in[l][row * (size_t)N + i];
    }
  }
  int32_t* cnt_r = cnt + (size_t)warp * nL;
  int32_t* first_r = first + (size_t)warp * nL;
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
  for (int i = threadIdx.x; i < n_flags; i += blockDim.x) tx[0][i] = 0;
  __syncthreads();

  for (int t = 0; t < p.chunk; ++t) {
    uint16_t* lin = list_a + (size_t)warp * widest;
    uint16_t* lout = list_b + (size_t)warp * widest;

    // ---- encoder: xorshift32 + 8-bit comparator -> spike list -----------
    int nsp = 0;
    for (int base = 0; base < K0; base += 32) {
      const int i = base + lane;
      const uint32_t s = xorshift32(st_r[i]);
      if (act) st_r[i] = s;
      const bool spk = px_r[i] > (uint8_t)(s >> 24);
      const unsigned m = __ballot_sync(FULL_MASK, spk);
      if (spk) lin[nsp + __popc(m & lt_mask)] = (uint16_t)i;
      nsp += __popc(m);
      if (m && lane == 0) tx[0][base / TILE] = 1;
    }
    __syncwarp();

    // ---- layer loop: spikes stay in shared memory between layers --------
    int adds_t = 0;
    for (int l = 0; l < L; ++l) {
      const int N = p.n[l];
      const bool last = (l == L - 1);
      const int16_t* __restrict__ Wl = p.w[l];
      int32_t* v_r = v[l] + (size_t)warp * N;
      int32_t* vp_r = vp[l] + (size_t)warp * N;
      uint8_t* en_r = en[l] + (size_t)warp * N;
      int nen = 0, nfired = 0;
      for (int c0 = 0; c0 < N; c0 += TILE) {
        bool e[4];
        unsigned em[4];
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          e[j] = en_r[c0 + 32 * j + lane] != 0;
          em[j] = __ballot_sync(FULL_MASK, e[j]);
          nen += __popc(em[j]);
        }
        if ((em[0] | em[1] | em[2] | em[3]) && lane == 0)
          te[l][c0 / TILE] = 1;
        if (em[0] | em[1] | em[2] | em[3]) {
          const int16_t* wcol = Wl + c0 + lane;
#pragma unroll 4
          for (int ii = 0; ii < nsp; ++ii) {
            const int16_t* wrow = wcol + (size_t)lin[ii] * N;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (em[j]) acc[j] += __ldg(wrow + 32 * j);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + 32 * j + lane;
          bool fired;
          const int v_new = lif_update(v_r[col], e[j] ? acc[j] : 0, e[j], lc,
                                       &fired);
          const bool en_new = p.pruning ? (e[j] && !fired) : e[j];
          if (act) {
            v_r[col] = v_new;
            en_r[col] = en_new ? 1 : 0;
            vp_r[col] = max(vp_r[col], v_new);
          }
          const unsigned fm = __ballot_sync(FULL_MASK, fired);
          if (last) {
            if (act) {
              if (fired) {
                cnt_r[col] += 1;
                if (first_r[col] == p.window) first_r[col] = steps;
              }
            }
          } else {
            if (fired) lout[nfired + __popc(fm & lt_mask)] = (uint16_t)col;
            nfired += __popc(fm);
            if (fm && lane == 0) tx[l + 1][c0 / TILE] = 1;
          }
        }
      }
      adds_t += nsp * nen;
      if (lane == 0) {
        const size_t o = ((size_t)t * L + l) * B + row;
        p.tspk[o] = act ? nsp : 0;
        p.ten[o] = act ? nen : 0;
      }
      uint16_t* tmp = lin;
      lin = lout;
      lout = tmp;
      nsp = nfired;
      __syncwarp();
    }

    // ---- final-layer trace, energy counter and stability gate ------------
    int32_t* vL = v[L - 1] + (size_t)warp * nL;
    for (int i = lane; i < nL; i += 32)
      p.vtr[((size_t)t * B + row) * nL + i] = vL[i];
    if (lane == 0) p.adds[(size_t)t * B + row] = act ? adds_t : 0;
    __syncwarp();
    if (p.gated) {
      if (act)
        gate_step(cnt_r, first_r, vL, vp[L - 1] + (size_t)warp * nL, nL,
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
          cx += tx[l][k];
          tx[l][k] = 0;
        }
        for (int k = 0; k < nnt; ++k) {
          ce += te[l][k];
          te[l][k] = 0;
        }
        p.ttile[((size_t)t * L + l) * gridDim.x + blockIdx.x] =
            p.sparse_skip ? nkt * nnt - cx * ce : 0;
      }
    }
    __syncthreads();
  }

  // ---- write the carried state back --------------------------------------
  for (int i = lane; i < K0; i += 32) p.st_out[row * (size_t)K0 + i] = st_r[i];
  for (int l = 0; l < L; ++l) {
    const int N = p.n[l];
    for (int i = lane; i < N; i += 32) {
      p.v_out[l][row * (size_t)N + i] = v[l][warp * N + i];
      p.vp_out[l][row * (size_t)N + i] = vp[l][warp * N + i];
      p.en_out[l][row * (size_t)N + i] = en[l][warp * N + i];
    }
  }
  for (int i = lane; i < nL; i += 32) {
    p.cnt_out[row * (size_t)nL + i] = cnt_r[i];
    p.first_out[row * (size_t)nL + i] = first_r[i];
  }
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
// ptrs and ints as stack_params_from_c() in snn_stack_common.cuh reads them.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int repro_fused_snn_stack(const void* ptrs_v, int n_ptrs,
                                     const void* ints_v, int n_ints,
                                     void* stream) {
  StackParams p;
  cudaError_t err = stack_params_from_c(ptrs_v, n_ptrs, ints_v, n_ints, &p);
  if (err != cudaSuccess) return (int)err;
  const size_t need = carve(p, nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr);
  if (need > (size_t)p.smem_bytes) return (int)cudaErrorInvalidValue;
  static int smem_cap[MAX_DEVICES] = {};
  err = raise_smem_cap((const void*)fused_snn_stack_kernel, p.smem_bytes,
                       smem_cap);
  if (err != cudaSuccess) return (int)err;
  fused_snn_stack_kernel<<<p.B / p.bB, 32 * p.bB, p.smem_bytes,
                           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
