// Warp-level tensor-core building blocks for Hopper (sm_90a), shared by the
// kernels that hold their tiles in registers: the bf16 cluster scan
// (lstm_stack.cu) and the attention cores (vit_attn.cu).
//
//   mma_bf16       one mma.sync m16n8k16 (bf16 operands, f32 accumulators)
//   ldmatrix_x4    four 8x8 bf16 matrices from shared memory into the
//                  fragment layout of mma.sync (.trans: each transposed)
//   cp_async*      asynchronous copies from device to shared memory, with
//                  zero fill where the source size is 0, and their groups
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): A (16 x 16,
// row-major) a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..), a[2] = (g, 2t+8..),
// a[3] = (g + 8, 2t+8..); B (16 x 8) b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..,
// n g); C (16 x 8) c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..2t+1). So
// the C fragments of two adjacent n8 tiles, rounded and packed in pairs, are
// the A fragment of a product over those 16 columns (`pack_bf16`).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

// the 32 bits at p (two bf16)
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a·b for one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// r[i] = this lane's pair of matrix i; lane l gives the address of row l % 8
// of matrix l / 8 (16-byte aligned)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// BYTES (4, 8 or 16) from src to dst, or zeros where valid is false (src is
// then not read, but must be a valid address)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace tc
