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
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include <mutex>

#define MAX_LAYERS 8
#define MAX_DEVICES 64
#define TILE 128
#define BLOCK_B 8  // lanes per thread block, one warp each: 256 threads
#define FULL_MASK 0xffffffffu

struct StackParams {
  const uint8_t* px;
  const uint32_t* st_in;
  const int32_t* cnt_in;
  const int32_t* first_in;
  const int32_t* steps_in;
  const int32_t* act_in;
  const int32_t* gprev_in;
  const int32_t* gstreak_in;
  uint32_t* st_out;
  int32_t* cnt_out;
  int32_t* first_out;
  int32_t* steps_out;
  int32_t* act_out;
  int32_t* gprev_out;
  int32_t* gstreak_out;
  int32_t* vtr;    // (chunk, B, nL)
  int32_t* adds;   // (chunk, B)
  int32_t* tspk;   // (chunk, L, B)
  int32_t* ten;    // (chunk, L, B)
  int32_t* ttile;  // (chunk, L, n_blocks)
  const int16_t* w[MAX_LAYERS];
  const int32_t* v_in[MAX_LAYERS];
  const uint8_t* en_in[MAX_LAYERS];
  const int32_t* vp_in[MAX_LAYERS];
  int32_t* v_out[MAX_LAYERS];
  uint8_t* en_out[MAX_LAYERS];
  int32_t* vp_out[MAX_LAYERS];
  int B, L, bB, chunk, window, decay_shift, v_th, v_rest, v_min, v_max;
  int pruning, gated, patience, readout, sparse_skip, smem_bytes, k0;
  int n[MAX_LAYERS];
};

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

__device__ inline int first_argmax_warp(int best_v, int best_i) {
  // warp-wide (value, index) max; ties go to the smaller index
  for (int o = 16; o > 0; o >>= 1) {
    const int ov = __shfl_down_sync(FULL_MASK, best_v, o);
    const int oi = __shfl_down_sync(FULL_MASK, best_i, o);
    if (ov > best_v || (ov == best_v && oi < best_i)) {
      best_v = ov;
      best_i = oi;
    }
  }
  return __shfl_sync(FULL_MASK, best_i, 0);
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
      uint32_t s = st_r[i];
      s ^= s << 13;
      s ^= s >> 17;
      s ^= s << 5;
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
          const int v_old = v_r[col];
          const int cur = e[j] ? acc[j] : 0;
          int v_int = (int)((unsigned)v_old + (unsigned)cur);
          v_int = v_int < p.v_min ? p.v_min : (v_int > p.v_max ? p.v_max
                                                                : v_int);
          const int v_leak = v_int - (v_int >> p.decay_shift);
          const bool fired = (v_leak >= p.v_th) && e[j];
          int v_new = fired ? p.v_rest : v_leak;
          v_new = e[j] ? v_new : v_old;
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
      if (act) {
        bool any = false;
        for (int i = lane; i < nL; i += 32) any |= cnt_r[i] > 0;
        const bool has_spike = __any_sync(FULL_MASK, any);
        int best_v = 0, best_i = 0;
        for (int i = lane; i < nL; i += 32) {
          int score;
          if (p.readout == 1) {          // first_spike
            const int large = 1 << 24;
            if (cnt_r[i] > 0) {
              score = large + (p.window - first_r[i]);
            } else {
              const int vv = vL[i];
              score = vv < -large + 1 ? -large + 1
                                      : (vv > large - 1 ? large - 1 : vv);
            }
          } else if (p.readout == 2) {   // membrane (peak)
            score = vp[L - 1][warp * nL + i];
          } else {                       // count
            score = cnt_r[i];
          }
          if (i == lane || score > best_v) {
            best_v = score;
            best_i = i;
          }
        }
        const int pred = first_argmax_warp(best_v, best_i);
        const int streak_raw = pred == gprev ? gstreak + 1 : 0;
        const bool done = streak_raw >= p.patience && has_spike;
        gprev = has_spike ? pred : -1;
        gstreak = has_spike ? streak_raw : 0;
        steps += 1;
        act = !done && steps < p.window;
      }
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
// ptrs: px, st_in, cnt_in, first_in, steps_in, act_in, gprev_in,
//       gstreak_in, st_out, cnt_out, first_out, steps_out, act_out,
//       gprev_out, gstreak_out, vtr, adds, tspk, ten, ttile, then per layer
//       w, v_in, en_in, vp_in, v_out, en_out, vp_out.
// ints: B, L, bB, chunk, window, decay_shift, v_th, v_rest, v_min, v_max,
//       pruning, gated, patience, readout, sparse_skip, smem_bytes, k0,
//       then n[0..L-1].
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int repro_fused_snn_stack(const void* ptrs_v, int n_ptrs,
                                     const void* ints_v, int n_ints,
                                     void* stream) {
  void* const* ptrs = (void* const*)ptrs_v;
  const int* ints = (const int*)ints_v;
  if (n_ints < 17) return (int)cudaErrorInvalidValue;
  StackParams p = {};
  p.B = ints[0];
  p.L = ints[1];
  if (p.L < 1 || p.L > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  if (n_ptrs != 20 + 7 * p.L || n_ints != 17 + p.L)
    return (int)cudaErrorInvalidValue;
  p.bB = ints[2];
  p.chunk = ints[3];
  p.window = ints[4];
  p.decay_shift = ints[5];
  p.v_th = ints[6];
  p.v_rest = ints[7];
  p.v_min = ints[8];
  p.v_max = ints[9];
  p.pruning = ints[10];
  p.gated = ints[11];
  p.patience = ints[12];
  p.readout = ints[13];
  p.sparse_skip = ints[14];
  p.smem_bytes = ints[15];
  p.k0 = ints[16];
  for (int l = 0; l < p.L; ++l) p.n[l] = ints[17 + l];
  if (p.bB != BLOCK_B || p.B % p.bB != 0 || p.B <= 0)
    return (int)cudaErrorInvalidValue;
  if (p.k0 % TILE != 0 || p.k0 > 65535) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < p.L; ++l)
    if (p.n[l] % TILE != 0 || p.n[l] > 65535)
      return (int)cudaErrorInvalidValue;
  if (p.gated && (ptrs[5] == nullptr || ptrs[12] == nullptr))
    return (int)cudaErrorInvalidValue;
  p.px = (const uint8_t*)ptrs[0];
  p.st_in = (const uint32_t*)ptrs[1];
  p.cnt_in = (const int32_t*)ptrs[2];
  p.first_in = (const int32_t*)ptrs[3];
  p.steps_in = (const int32_t*)ptrs[4];
  p.act_in = (const int32_t*)ptrs[5];
  p.gprev_in = (const int32_t*)ptrs[6];
  p.gstreak_in = (const int32_t*)ptrs[7];
  p.st_out = (uint32_t*)ptrs[8];
  p.cnt_out = (int32_t*)ptrs[9];
  p.first_out = (int32_t*)ptrs[10];
  p.steps_out = (int32_t*)ptrs[11];
  p.act_out = (int32_t*)ptrs[12];
  p.gprev_out = (int32_t*)ptrs[13];
  p.gstreak_out = (int32_t*)ptrs[14];
  p.vtr = (int32_t*)ptrs[15];
  p.adds = (int32_t*)ptrs[16];
  p.tspk = (int32_t*)ptrs[17];
  p.ten = (int32_t*)ptrs[18];
  p.ttile = (int32_t*)ptrs[19];
  for (int l = 0; l < p.L; ++l) {
    void* const* q = ptrs + 20 + 7 * l;
    p.w[l] = (const int16_t*)q[0];
    p.v_in[l] = (const int32_t*)q[1];
    p.en_in[l] = (const uint8_t*)q[2];
    p.vp_in[l] = (const int32_t*)q[3];
    p.v_out[l] = (int32_t*)q[4];
    p.en_out[l] = (uint8_t*)q[5];
    p.vp_out[l] = (int32_t*)q[6];
  }
  const size_t need = carve(p, nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr);
  if (need > (size_t)p.smem_bytes) return (int)cudaErrorInvalidValue;
  // Raise the kernel's dynamic shared-memory cap only when a launch asks
  // for more than any before it on this device.
  static std::mutex smem_mu;
  static int smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> hold(smem_mu);
    if (p.smem_bytes > smem_set[dev]) {
      err = cudaFuncSetAttribute(fused_snn_stack_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 p.smem_bytes);
      if (err != cudaSuccess) return (int)err;
      smem_set[dev] = p.smem_bytes;
    }
  }
  fused_snn_stack_kernel<<<p.B / p.bB, 32 * p.bB, p.smem_bytes,
                           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
