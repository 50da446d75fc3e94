// Poisson encoder over a whole window: T xorshift32 steps per pixel, a
// spike wherever the pixel exceeds the state's top byte.
//
// Replaces the TPU kernel repro/kernels/poisson_encode.py::
// poisson_encode_pallas (body _encode_kernel).  Inputs: pixels uint8 and
// PRNG state uint32, (B, N); outputs: the spike train uint8 (T, B, N) and
// the final state (B, N).
//
// What bounds it on an H100: bytes.  Per pixel it reads 5 B, writes T + 4 B
// and does 7 integer ops per step: at (T=20, B=1024, N=784) the function
// moves 23.3 MB, about 7 us at 3.35 TB/s, and its ops take a fraction of
// that at the INT32 rate.
//
// What the design does about it: one thread per 4 neighbouring pixels of
// one lane keeps their states in registers for all T steps, so each input
// is read once (a 4-byte and a 16-byte load) and each output written once
// (a 4-byte store per step, neighbouring threads on neighbouring
// addresses).  Padded lanes have zero pixels and zero state; zero is the
// xorshift fixed point, so they stay zero and never spike.
#include "snn_stack_common.cuh"

__global__ void __launch_bounds__(256)
poisson_encode_kernel(const uchar4* __restrict__ px,
                      const uint4* __restrict__ st_in,
                      uchar4* __restrict__ spikes, uint4* __restrict__ st_out,
                      int T, size_t n4) {
  const size_t q = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (q >= n4) return;
  const uchar4 x = px[q];
  uint4 s = st_in[q];
  for (int t = 0; t < T; ++t) {
    s.x = xorshift32(s.x);
    s.y = xorshift32(s.y);
    s.z = xorshift32(s.z);
    s.w = xorshift32(s.w);
    uchar4 o;
    o.x = x.x > (s.x >> 24);
    o.y = x.y > (s.y >> 24);
    o.z = x.z > (s.z >> 24);
    o.w = x.w > (s.w >> 24);
    spikes[(size_t)t * n4 + q] = o;
  }
  st_out[q] = s;
}

// ---- C interface (loaded with ctypes) -------------------------------------
// ptrs: px (B, N) u8, st_in (B, N) u32, spikes (T, B, N) u8, st_out (B, N)
//       u32, all contiguous; ints: B, N, T.  N must be a multiple of 4 and
// the state 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int repro_poisson_encode(const void* ptrs_v, int n_ptrs,
                                    const void* ints_v, int n_ints,
                                    void* stream) {
  void* const* ptrs = (void* const*)ptrs_v;
  const int* ints = (const int*)ints_v;
  if (n_ptrs != 4 || n_ints != 3) return (int)cudaErrorInvalidValue;
  const int B = ints[0], N = ints[1], T = ints[2];
  if (B <= 0 || N <= 0 || N % 4 != 0 || T < 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (((uintptr_t)ptrs[i] & ((i == 1 || i == 3) ? 15 : 3)) != 0)
      return (int)cudaErrorMisalignedAddress;
  const size_t n4 = (size_t)B * N / 4;
  const int threads = 256;
  const size_t blocks = (n4 + threads - 1) / threads;
  poisson_encode_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const uchar4*)ptrs[0], (const uint4*)ptrs[1], (uchar4*)ptrs[2],
      (uint4*)ptrs[3], T, n4);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
