// PTX wrappers shared by the kernels that run on the int8 tensor cores: the
// weight-streaming stack kernel (fused_snn_streamed.cu), the partial
// contraction (partial_contraction.cu), the spike matmul (spike_matmul.cu)
// and the staged LIF kernel (lif_step.cu).  cp.async copies of 16-byte pieces into shared memory,
// ldmatrix fragment loads, and mma.sync m16n8k32 with s32 accumulators in
// the three operand signednesses the kernels use.  None of the MMAs
// saturates (.satfinite is never given), so an s32 sum wraps modulo 2^32
// as the reference's int32 accumulation does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Copy 16 bytes from global src to shared dst; with valid false the 16
// bytes are zero-filled and src is not read.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane L gives the shared address of row L % 8 of
// matrix L / 8, and register j receives this thread's part of matrix j:
// row lane / 4, 16-bit columns 2 * (lane % 4) and 2 * (lane % 4) + 1.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The same, each matrix transposed: register j receives rows
// 2 * (lane % 4) (low half) and 2 * (lane % 4) + 1 (high half) of 16-bit
// column lane / 4 of matrix j.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a * b for one m16n8k32 tile: A (16 x 32, row) in a0..a3, B (32 x 8,
// col) in b0, b1, in the register order of the PTX ISA's fragment layout.
__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A unsigned bytes, B signed bytes.
__device__ __forceinline__ void mma_u8s8(int (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A and B unsigned bytes.
__device__ __forceinline__ void mma_u8u8(int (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
