// Poisson encoder over a whole window: T xorshift32 steps per pixel, a
// spike wherever the pixel exceeds the state's top byte, and the first
// layer's telemetry of the train it writes.
//
// Replaces the TPU kernel repro/kernels/poisson_encode.py::
// poisson_encode_pallas (body _encode_kernel).  Inputs: pixels uint8 and
// PRNG state uint32, (B, N); outputs: the spike train uint8 (T, B, N), the
// final state (B, N), and, added into zeroed int32 tallies, each (step,
// lane)'s spike count and each (step, 8-lane block)'s count of 128-pixel
// tiles holding a spike, so that nothing outside the kernel reads the train
// for them.
//
// What bounds it on an H100: bytes.  Per pixel it reads 5 B, writes T + 4 B
// and does 7 integer ops per step: at (T=20, B=1024, N=784) the function
// moves 23.3 MB, about 7 us at 3.35 TB/s, and its ops take a fraction of
// that at the INT32 rate.  The tallies add 4 B per (step, lane).
//
// What the design does about it: one warp per (lane, 128-pixel tile), a
// thread 4 neighbouring pixels of it, keeps their states in registers for
// all T steps, so each input is read once (a 4-byte and a 16-byte load)
// and each output written once (a 4-byte store per step, neighbouring
// threads on neighbouring addresses).  A block holds the 8 lanes of one
// telemetry block over one tile, and a row block's tiles run as
// neighbouring blocks: a 784-pixel row's tiles share 32-byte sectors,
// which L2 then merges before they go to memory (with the tiles far apart
// in the grid it wrote them back half-filled, and the kernel took 250 us
// in place of 135 at (20, 10,000, 784)).  Steps go in groups of 32: lane j
// keeps step j's count of its warp's spikes, the block exchanges them
// through shared memory, and thread (step, lane) adds its lane's count,
// and one thread a step the block's live tile, with an atomic into the
// tallies; so no window is too long for them.  Padded lanes have zero
// pixels and zero state; zero is the xorshift fixed point, so they stay
// zero and never spike.
#include "snn_stack_common.cuh"

__global__ void __launch_bounds__(32 * BLOCK_B)
poisson_encode_kernel(const uint8_t* __restrict__ px,
                      const uint32_t* __restrict__ st_in,
                      uint8_t* __restrict__ spikes,
                      uint32_t* __restrict__ st_out,
                      int32_t* __restrict__ nspk, int32_t* __restrict__ live,
                      int B, int N, int T, int ld, int ldb, int tiles) {
  __shared__ unsigned cnt[2][32][BLOCK_B];  // [group parity][step][warp]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a row block's tiles are neighbouring blocks, so the sectors two
  // tiles share are both written while L2 holds them
  const int blk = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int row = blk * BLOCK_B + warp;
  const int q = tile * TILE + lane * 4;
  const bool ok = row < B && q < N;  // N is a multiple of 4: all 4 or none
  const size_t at = (size_t)row * N + q;
  const size_t plane = (size_t)B * N;
  uchar4 x = make_uchar4(0, 0, 0, 0);
  uint4 s = make_uint4(0, 0, 0, 0);
  if (ok) {
    x = *(const uchar4*)(px + at);
    s = *(const uint4*)(st_in + at);
  }
  // after the barrier, thread (step, warp) = (threadIdx.x / 8, % 8)
  const int tt = threadIdx.x >> 3, tw = threadIdx.x & 7;
  for (int t0 = 0, g = 0; t0 < T; t0 += 32, g ^= 1) {
    const int steps = min(32, T - t0);
    unsigned mine = 0;
    for (int j = 0; j < steps; ++j) {
      s.x = xorshift32(s.x);
      s.y = xorshift32(s.y);
      s.z = xorshift32(s.z);
      s.w = xorshift32(s.w);
      uchar4 o;
      o.x = x.x > (s.x >> 24);
      o.y = x.y > (s.y >> 24);
      o.z = x.z > (s.z >> 24);
      o.w = x.w > (s.w >> 24);
      if (ok) *(uchar4*)(spikes + (size_t)(t0 + j) * plane + at) = o;
      const unsigned c = __reduce_add_sync(
          FULL_MASK, (unsigned)o.x + o.y + o.z + o.w);
      if (lane == j) mine = c;
    }
    cnt[g][lane][warp] = mine;  // 0 past the group's steps
    __syncthreads();
    // the buffer is next written two groups on, past the next barrier
    const unsigned c = cnt[g][tt][tw];
    if (c) atomicAdd(nspk + (size_t)(t0 + tt) * ld + blk * BLOCK_B + tw,
                     (int)c);
    const unsigned fired = __ballot_sync(FULL_MASK, c != 0);
    if (tw == 0 && ((fired >> (lane & ~7)) & 0xffu))
      atomicAdd(live + (size_t)(t0 + tt) * ldb + blk, 1);
  }
  if (ok) *(uint4*)(st_out + at) = s;
}

// ---- C interface (loaded with ctypes) -------------------------------------
// ptrs px (B, N) u8, st_in (B, N) u32, spikes (T, B, N) u8, st_out (B, N)
// u32, all contiguous, then nspk and live, zeroed int32 tallies added into
// at step * ld + lane and step * ldb + lane / 8; ints B, N, T, ld, ldb.  N
// must be a multiple of 4 and the state 16-byte aligned.  Returns the
// cudaError_t of the launch.
extern "C" int repro_poisson_encode(const void* ptrs_v, int n_ptrs,
                                    const void* ints_v, int n_ints,
                                    void* stream) {
  void* const* ptrs = (void* const*)ptrs_v;
  const int* ints = (const int*)ints_v;
  if (n_ptrs != 6 || n_ints != 5) return (int)cudaErrorInvalidValue;
  const int B = ints[0], N = ints[1], T = ints[2], ld = ints[3],
            ldb = ints[4];
  const int blocks = (B + BLOCK_B - 1) / BLOCK_B;
  const int tiles = (N + TILE - 1) / TILE;
  if (B <= 0 || N <= 0 || N % 4 || T < 0 ||
      (long long)blocks * tiles > 0x7fffffff || ld < B || ldb < blocks)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 6; ++i)
    if ((uintptr_t)ptrs[i] & (i == 1 || i == 3 ? 15 : 3))
      return (int)cudaErrorMisalignedAddress;
  poisson_encode_kernel<<<blocks * tiles, 32 * BLOCK_B, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)ptrs[0], (const uint32_t*)ptrs[1], (uint8_t*)ptrs[2],
      (uint32_t*)ptrs[3], (int32_t*)ptrs[4], (int32_t*)ptrs[5], B, N, T, ld,
      ldb, tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
