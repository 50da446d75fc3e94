// Pieces shared by the two encode->LIF stack kernels: the resident one
// (fused_snn_stack.cu) and the weight-streaming one (fused_snn_streamed.cu).
// Both compute the same function on the same operands (the weights as
// int16 codes for the first, as their two int8 planes for the second), so
// they share the parameter block, its unpacking from the C interface, and
// the per-lane arithmetic: the xorshift32 step, the integer LIF update, and
// the stability-gate readout with its first-index argmax.  The encoder
// (poisson_encode.cu) and LIF (lif_step.cu) kernels take the xorshift32
// step and the LIF update from here too, so every kernel runs one copy of
// the datapath's arithmetic.  The other tensor-core kernels
// (partial_contraction.cu, spike_matmul.cu) take its tile constants and
// raise_smem_cap.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define MAX_LAYERS 8
#define MAX_DEVICES 64
#define TILE 128
#define BLOCK_B 8  // lanes per batch block (the telemetry's block)
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
  const int16_t* w[MAX_LAYERS];   // codes; fused_snn_streamed: int8 planes
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

// ---- C interface ------------------------------------------------------------
// ptrs: px, st_in, cnt_in, first_in, steps_in, act_in, gprev_in,
//       gstreak_in, st_out, cnt_out, first_out, steps_out, act_out,
//       gprev_out, gstreak_out, vtr, adds, tspk, ten, ttile, then per layer
//       w, v_in, en_in, vp_in, v_out, en_out, vp_out.
// ints: B, L, bB, chunk, window, decay_shift, v_th, v_rest, v_min, v_max,
//       pruning, gated, patience, readout, sparse_skip, smem_bytes, k0,
//       then n[0..L-1].
// Fills *p; returns cudaErrorInvalidValue for anything the kernels refuse.
// With `real_widths` (the resident kernel) the batch is any positive count
// and the widths are the layers' own, k0 a multiple of 16; otherwise (the
// streamed kernel) the batch is a multiple of the 8-lane block and every
// width a multiple of TILE.
inline cudaError_t stack_params_from_c(const void* ptrs_v, int n_ptrs,
                                       const void* ints_v, int n_ints,
                                       StackParams* out,
                                       bool real_widths = false) {
  void* const* ptrs = (void* const*)ptrs_v;
  const int* ints = (const int*)ints_v;
  if (n_ints < 17) return cudaErrorInvalidValue;
  StackParams p = {};
  p.B = ints[0];
  p.L = ints[1];
  if (p.L < 1 || p.L > MAX_LAYERS) return cudaErrorInvalidValue;
  if (n_ptrs != 20 + 7 * p.L || n_ints != 17 + p.L)
    return cudaErrorInvalidValue;
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
  if (p.bB != BLOCK_B || p.B <= 0 || (!real_widths && p.B % p.bB != 0))
    return cudaErrorInvalidValue;
  const int k_mult = real_widths ? 16 : TILE, n_mult = real_widths ? 1 : TILE;
  if (p.k0 < k_mult || p.k0 % k_mult != 0 || p.k0 > 65535)
    return cudaErrorInvalidValue;
  for (int l = 0; l < p.L; ++l)
    if (p.n[l] < n_mult || p.n[l] % n_mult != 0 || p.n[l] > 65535)
      return cudaErrorInvalidValue;
  if (p.gated && (ptrs[5] == nullptr || ptrs[12] == nullptr))
    return cudaErrorInvalidValue;
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
  *out = p;
  return cudaSuccess;
}

// Raise `kernel`'s dynamic shared-memory cap only when a launch asks for
// more than any before it on this device; `cap` is that kernel's own
// per-device record.
inline cudaError_t raise_smem_cap(const void* kernel, int bytes,
                                  int (&cap)[MAX_DEVICES]) {
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  if (bytes > cap[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    cap[dev] = bytes;
  }
  return cudaSuccess;
}

// ---- per-lane arithmetic -----------------------------------------------------

__device__ __forceinline__ uint32_t xorshift32(uint32_t s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}

// The LIF constants, copied out of a parameter block into registers.
struct LifConsts {
  int decay_shift, v_th, v_rest, v_min, v_max;
};

// One neuron's integer LIF step: saturating add (the add wraps in 32 bits
// first, as the reference's int32 add does), shift leak, threshold fire,
// hard reset; a disabled neuron keeps its membrane and cannot fire.
__device__ __forceinline__ int lif_update(int v_old, int cur, bool e,
                                          const LifConsts c, bool* fired) {
  int v_int = (int)((unsigned)v_old + (unsigned)cur);
  v_int = v_int < c.v_min ? c.v_min : (v_int > c.v_max ? c.v_max : v_int);
  const int v_leak = v_int - (v_int >> c.decay_shift);
  *fired = (v_leak >= c.v_th) && e;
  const int v_new = *fired ? c.v_rest : v_leak;
  return e ? v_new : v_old;
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

// A final-layer column's readout score: its spike count (count), its
// first-spike time in an additive 2^24 tier above its membrane clipped to
// +-(2^24 - 1) (first_spike), or its peak membrane (membrane).
__device__ __forceinline__ int gate_score(int readout, int window, int cnt,
                                          int first, int v, int vp) {
  if (readout == 1) {            // first_spike
    const int large = 1 << 24;
    if (cnt > 0) return large + (window - first);
    return v < -large + 1 ? -large + 1 : (v > large - 1 ? large - 1 : v);
  }
  return readout == 2 ? vp : cnt;
}

// The streak update and retire decision of one gate step, from the warp's
// prediction and whether the lane has spiked at all.
__device__ __forceinline__ void gate_decide(int pred, bool has_spike,
                                            int window, int patience,
                                            int& steps, bool& act, int& gprev,
                                            int& gstreak) {
  const int streak_raw = pred == gprev ? gstreak + 1 : 0;
  const bool done = streak_raw >= patience && has_spike;
  gprev = has_spike ? pred : -1;
  gstreak = has_spike ? streak_raw : 0;
  steps += 1;
  act = !done && steps < window;
}

// One stability-gate step for an active lane, run by one warp: the
// prediction under the configured readout from the lane's final-layer
// counts, first-spike latch, membrane and peak membrane (each lane of the
// warp reads the columns i = lane, lane + 32, ...), then the streak update
// and the retire decision.
__device__ inline void gate_step(const int32_t* cnt, const int32_t* first,
                                 const int32_t* vL, const int32_t* vpL,
                                 int nL, int readout, int window, int patience,
                                 int lane, int& steps, bool& act, int& gprev,
                                 int& gstreak) {
  bool any = false;
  for (int i = lane; i < nL; i += 32) any |= cnt[i] > 0;
  const bool has_spike = __any_sync(FULL_MASK, any);
  // a lane with no column (nL < 32) loses every comparison, ties included
  int best_v = -2147483647 - 1, best_i = 0x7fffffff;
  for (int i = lane; i < nL; i += 32) {
    const int score = gate_score(readout, window, cnt[i], first[i], vL[i],
                                 vpL[i]);
    if (i == lane || score > best_v) {
      best_v = score;
      best_i = i;
    }
  }
  gate_decide(first_argmax_warp(best_v, best_i), has_spike, window, patience,
              steps, act, gprev, gstreak);
}
