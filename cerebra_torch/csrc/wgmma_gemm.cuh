// A bf16 tensor-core matrix product for Hopper (sm_90a) on wgmma, fed by
// the Tensor Memory Accelerator: the body of the fused ViT half-blocks'
// dense products (vit_mlp.cu, K7 and K8; vit_attn.cu, K5 and K6), with the
// pair epilogues they share.
//
//   C(i, j) = sum_k A(i, k) B(k, j),  i < M, j < N, then epi on pairs of C
//   A(i, k) = A_MN ? A[k * lda + i] : A[i * lda + k]
//   B(k, j) = B_MN ? B[k * ldb + j] : B[j * ldb + k]
//
// (An operand is "K-major" where k is its contiguous index and "MN-major"
// where i or j is: fc1 and fc2 are y W1 and gh W2 with A K-major and B
// MN-major, dy = dhn W1^T has both K-major, dW = gh^T dn has both MN-major.)
//
// Design. A CTA of two warpgroups owns a 128 x 128 tile of C; warpgroup g
// owns rows 64 g .. 64 g + 63 and keeps its 64 x 128 f32 accumulators in
// registers (wgmma m64n128k16, both operands read from shared memory
// through descriptors). k runs in steps of 64 through a ring of STAGES
// stages: thread 0 asks the TMA for each stage's tiles (128-byte swizzle,
// the layout wgmma reads without bank conflicts; zero fill past the ragged
// edge of M, N and K), completion lands on the stage's "full" mbarrier, and
// each warpgroup frees the stage on its "empty" mbarrier once its products
// on it have retired, so the next STAGES - 1 steps' copies are in flight
// while one step's products run. The epilogue reads the accumulators from
// registers in pairs of adjacent columns and stores them paired where they
// are aligned.
//
// A launch may hold two problems of the same orientation (blockIdx.z) and
// split k into fixed chunks of whole steps (blockIdx.y), each written as its
// own partial: K8 runs dW1 and dW2 as one launch of split-row contractions.
// The TMA needs 16-byte aligned bases and row strides (ld % 8 == 0); a launch
// whose operands do not meet that returns cudaErrorInvalidValue.
//
// stack_contract, further down, is a second kernel on the same parts: two
// stacked MN-major A operands against one B and B's column sums, in one pass
// over B (K2/K2g's dW_ih, dW_hh and db).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;        // rows of a CTA's tile: two warpgroups of 64
constexpr int kBN = 128;        // columns of a CTA's tile
constexpr int kBK = 64;         // k step: one 128-byte swizzle row of bf16
constexpr int kThreads = 256;   // two warpgroups
constexpr int kTileBytes = kBM * kBK * 2;  // 16 KB, an A or B tile of a stage
constexpr int kBox = 64;        // rows or columns of one TMA box of an MN-major tile

// One problem of a launch: A and B as above, row strides lda and ldb.
struct Operands {
  const bf16* A;
  const bf16* B;
  int lda, ldb, M, N;
};

// ----------------------------------------------------------- epilogues
// epi(i, j, v0, v1, two): C(i, j) = v0 and, where two, C(i, j + 1) = v1.

// p[0] = v0 and, where two, p[1] = v1, as one store where p is aligned
__device__ __forceinline__ void store2(float* p, float v0, float v1, bool two) {
  if (two && ((uintptr_t)p & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (two) p[1] = v1;
  }
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1, bool two) {
  if (two && ((uintptr_t)p & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    if (two) p[1] = __float2bfloat16_rn(v1);
  }
}

__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const bf16* p) { return __bfloat162float(*p); }

// out (f32) = C
struct EpiF32 {
  float* out;
  int ld;
  __device__ void operator()(int i, int j, float v0, float v1, bool two) const {
    store2(out + (size_t)i * ld + j, v0, v1, two);
  }
};

// part[blockIdx.y][i][j] = C over chunk blockIdx.y of k
struct EpiPartial {
  float* part;
  int ld;
  size_t zstride;
  __device__ void operator()(int i, int j, float v0, float v1, bool two) const {
    store2(part + blockIdx.y * zstride + (size_t)i * ld + j, v0, v1, two);
  }
};

// out (CD) = C + bias (bias may be null), rounded to CD
template <typename CD>
struct EpiBiasRound {
  const CD* bias;
  CD* out;
  int ld;
  __device__ void operator()(int i, int j, float v0, float v1, bool two) const {
    if (bias) {
      v0 += ld_f(bias + j);
      if (two) v1 += ld_f(bias + j + 1);
    }
    store2(out + (size_t)i * ld + j, v0, v1, two);
  }
};

// out (SD) = x + s_i (C + bias), s_i = rs[i / rdiv] or 1: the residual add
// with the drop-path branch scale (one a row: rdiv 1, K7; one a sequence of
// rdiv rows: K5)
template <typename SD, typename CD>
struct EpiResidual {
  const SD* x;
  const CD* bias;
  const float* rs;
  int rdiv;
  SD* out;
  int ld;
  __device__ void operator()(int i, int j, float v0, float v1, bool two) const {
    const size_t o = (size_t)i * ld + j;
    const float s = rs ? rs[i / rdiv] : 1.f;
    float a = v0 + ld_f(bias + j), b = two ? v1 + ld_f(bias + j + 1) : 0.f;
    if (rs) a *= s, b *= s;
    store2(out + o, ld_f(x + o) + a, two ? ld_f(x + o + 1) + b : 0.f, two);
  }
};

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(tc::smem_addr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(tc::smem_addr(b)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(tc::smem_addr(b)) : "memory");
}

// wait until the phase of parity `parity` of barrier b has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(tc::smem_addr(b)), "r"(parity) : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA
// the box of `map` at (inner c0, outer c1) into shared memory at dst,
// completing on barrier b
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* b, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(tc::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_addr(b)),
         "r"(c0), "r"(c1)
      : "memory");
}

// the box of the rank-4 `map` at (c0, c1, c2, c3), innermost first, into
// shared memory at dst, completing on barrier b
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, uint64_t* b, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(tc::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_addr(b)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------- wgmma
// The descriptor of a 128-byte-swizzled operand tile at p (1024-byte
// aligned atoms of 8 rows of 128 bytes): lbo the byte stride between 64-wide
// blocks of an MN-major tile, sbo between groups of 8 rows.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = tc::smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A B for a 64 x 128 tile over k16: A and B from shared memory through
// their descriptors; TA / TB 1 where the operand is MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

#define CEREBRA_WG_D32                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),       \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),          \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),          \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),          \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A B for a 64 x 64 tile over k16, both operands from shared memory
// through their descriptors (B K-major), d overwritten where `acc` is 0.
// Accumulator layout (w = warp of the warpgroup, g = lane / 4, t = lane %
// 4): d[4 j + 2 h + e] is row 16 w + g + 8 h, column 8 j + 2 t + e, which
// is also the register A operand's layout over each 16 columns
// (mma_n64_rs), as in mma.sync's m16n8k16.
__device__ __forceinline__ void mma_n64_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31},\n"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : CEREBRA_WG_D32
      : "l"(da), "l"(db), "r"(acc));
}

// d += A B for a 64 x 64 tile over k16: A from registers (a[0..3], the
// m16n8k16 A fragment of this warp's 16 rows), B from shared memory,
// MN-major (its 64 columns contiguous a row of k)
__device__ __forceinline__ void mma_n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31},\n"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : CEREBRA_WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef CEREBRA_WG_D32

// d += (this warpgroup's 64 rows of the stage's A tile) (its B tile) over
// the kBK values of k: four k16 products. A tile: K-major, 128 rows of 128
// bytes; MN-major, two boxes of 64 columns x kBK rows. B tile: K-major,
// kBN rows of 128 bytes; MN-major, two boxes of 64 columns x kBK rows.
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void stage_mma(float (&d)[64], const bf16* As, const bf16* Bs, int g) {
  const char* a = reinterpret_cast<const char*>(As) + 8192 * g;
  const char* b = reinterpret_cast<const char*>(Bs);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t da = A_MN ? desc(a + 2048 * kk, 8192, 1024) : desc(a + 32 * kk, 16, 1024);
    const uint64_t db = B_MN ? desc(b + 2048 * kk, 8192, 1024) : desc(b + 32 * kk, 16, 1024);
    mma_n128<A_MN ? 1 : 0, B_MN ? 1 : 0>(d, da, db);
  }
}

// Start the TMA copies of one operand tile: K-major, one box (kBK x 128
// rows) at (k0, r0); MN-major, two boxes (64 x kBK rows) at (r0, k0) and
// (r0 + 64, k0).
template <bool MN>
__device__ __forceinline__ void load_operand(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                             int r0, int k0) {
  if (MN) {
    tma_load(dst, map, bar, r0, k0);
    tma_load(dst + kBox * kBK, map, bar, r0 + kBox, k0);
  } else {
    tma_load(dst, map, bar, k0, r0);
  }
}

struct Dims {
  int M, N;
};

template <int STAGES>
struct Smem {
  static constexpr int BYTES = STAGES * 2 * kTileBytes + 2 * STAGES * 8 + 1024;  // + alignment
};

// Grid (tiles of the larger problem, k chunks, problems); tile t is row tile
// t / (column tiles), column tile t % (column tiles), so neighbouring CTAs
// share A's rows. Chunk y covers k in [y kchunk, (y + 1) kchunk), kchunk a
// multiple of kBK (k_chunk).
template <bool A_MN, bool B_MN, int STAGES, int MINB, class Epi>
__global__ void __launch_bounds__(kThreads, MINB)
tma_gemm(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap b0,
         const __grid_constant__ CUtensorMap a1, const __grid_constant__ CUtensorMap b1,
         Dims p0, Dims p1, Epi e0, Epi e1, int K, int kchunk) {
  extern __shared__ unsigned char smraw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smraw) + 1023) & ~uintptr_t(1023));
  bf16* tiles = reinterpret_cast<bf16*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * 2 * kTileBytes);
  uint64_t* empty = full + STAGES;
  const bool second = blockIdx.z != 0;
  const Dims p = second ? p1 : p0;
  const CUtensorMap* ma = second ? &a1 : &a0;
  const CUtensorMap* mb = second ? &b1 : &b0;
  const int tn = (p.N + kBN - 1) / kBN, tm = (p.M + kBM - 1) / kBM;
  if ((int)blockIdx.x >= tm * tn) return;
  const int i0 = (blockIdx.x / tn) * kBM, j0 = (blockIdx.x % tn) * kBN;
  const int kb = blockIdx.y * kchunk, ke = min(K, kb + kchunk);
  const int nk = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;
  const int g = threadIdx.x / 128;
  constexpr int kStageElems = 2 * kTileBytes / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto produce = [&](int it) {  // thread 0: step it's copies into stage it % STAGES
    const int s = it % STAGES;
    bf16* st = tiles + s * kStageElems;
    mbar_expect_tx(&full[s], 2 * kTileBytes);
    load_operand<A_MN>(st, ma, &full[s], i0, kb + it * kBK);
    load_operand<B_MN>(st + kTileBytes / 2, mb, &full[s], j0, kb + it * kBK);
  };
  if (threadIdx.x == 0)
    for (int it = 0; it < STAGES && it < nk; ++it) produce(it);
  __syncwarp();  // wgmma is .aligned: warp 0 reconverges after thread 0's copies

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const bf16* st = tiles + s * kStageElems;
    fence_regs(d);
    wg_fence();
    stage_mma<A_MN, B_MN>(d, st, st + kTileBytes / 2, g);
    wg_commit();
    wg_wait<0>();
    fence_regs(d);
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && it + STAGES < nk) {
      mbar_wait(&empty[s], (it / STAGES) & 1);
      produce(it + STAGES);
    }
    __syncwarp();
  }

  const Epi epi = second ? e1 : e0;
  const int w = (threadIdx.x / 32) % 4, l = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 64 * g + 16 * w + l / 4 + 8 * h;
    if (i >= p.M) continue;
#pragma unroll
    for (int j8 = 0; j8 < kBN / 8; ++j8) {
      const int j = j0 + 8 * j8 + 2 * (l % 4);
      if (j < p.N) epi(i, j, d[4 * j8 + 2 * h], d[4 * j8 + 2 * h + 1], j + 1 < p.N);
    }
  }
}

// ------------------------------------------------ the stacked contraction
// C = [A0 | A1]^T B over k < K, all three MN-major (stored (K, width)): row
// r < M0 of C is sum_k A0[k][r] B[k][j]; row M0 + r (r < M1) is
// sum_k A1[k - shift][r] B[k][j], the rows of A1 before 0 zero; and, with
// `sums`, row M0 + M1 is sum_k B[k][j]. K2/K2g's products of one layer are
// this with A0 = inp, A1 = h, shift = B and B = dgates: dW_ih, dW_hh and db
// in one pass over dgates (lstm_stack.cu layer_products).
//
// Design. A CTA owns a 128-column tile of B (blockIdx.x), one chunk of k of
// whole kBK steps (blockIdx.y) and a group of kStackSlices 64-row slices of
// the stacked A (blockIdx.z): A0's slices, then A1's, each padded to 64 rows
// by the TMA's zero fill. One producer warp keeps a ring of kStackStages
// stages filled, each B's tile of one k step (two boxes of 64 columns x kBK
// rows) and the group's A slices of the same rows (a box each); A1's boxes
// start `shift` rows back, and the TMA fills rows before 0 with zeros, so the
// vanishing t = 0 term needs no case of its own. Consumer warpgroup g runs
// wgmma m64n128k16 on slice g into its registers; while those products run,
// each consumer thread of a group-0 CTA adds its 8 values of two columns of
// the stage's B tile in shared memory into f32 sums, so db takes no pass of
// its own over B. Each consumer warp frees the stage on its "empty" mbarrier
// once its products and reads are done. The epilogue writes the chunk's
// partial through epi (rows of the padding are not written); the caller adds
// the chunks in order. The column tiles of one chunk read the same A rows,
// so the tile (blockIdx.x) runs fastest: they run together, and all but the
// first read A from L2.
constexpr int kStackSlices = 4;                                   // consumer warpgroups
constexpr int kStackThreads = 128 * kStackSlices + 32;            // + the producer warp
constexpr int kStackStages = 4;
constexpr int kSliceBytes = kBox * kBK * 2;                       // 8 KB: an A slice of a stage
constexpr int kStackStageBytes = kTileBytes + kStackSlices * kSliceBytes;  // 48 KB
constexpr int kStackSmem =
    kStackStages * kStackStageBytes + 2 * kStackStages * 8 + 8 * kBN * 4 + 1024;  // + alignment

template <class Epi>
__global__ void __launch_bounds__(kStackThreads, 1)
stack_contract(const __grid_constant__ CUtensorMap ma0, const __grid_constant__ CUtensorMap ma1,
               const __grid_constant__ CUtensorMap mb, int M0, int M1, int N, int K, int shift,
               int kchunk, int sums, Epi epi) {
  extern __shared__ unsigned char smraw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smraw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStackStages * kStackStageBytes);
  uint64_t* empty = full + kStackStages;
  float(*red)[kBN] = reinterpret_cast<float(*)[kBN]>(empty + kStackStages);
  const int s0 = (M0 + kBox - 1) / kBox, slices = s0 + (M1 + kBox - 1) / kBox;
  const int first = blockIdx.z * kStackSlices, active = min(kStackSlices, slices - first);
  const int j0 = blockIdx.x * kBN, kb = blockIdx.y * kchunk, ke = min(K, kb + kchunk);
  const int nk = (ke - kb + kBK - 1) / kBK;
  const bool colsum = sums && blockIdx.z == 0;
  const int g = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStackStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kStackSlices);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (g == kStackSlices) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      const int bytes = kTileBytes + active * kSliceBytes;
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStackStages, k0 = kb + it * kBK;
        if (it >= kStackStages) mbar_wait(&empty[s], (it / kStackStages - 1) & 1);
        bf16* st = reinterpret_cast<bf16*>(base + s * kStackStageBytes);
        mbar_expect_tx(&full[s], bytes);
        load_operand<true>(st, &mb, &full[s], j0, k0);
        for (int q = 0; q < active; ++q) {
          bf16* dst = st + (kTileBytes + q * kSliceBytes) / 2;
          const int sl = first + q;
          if (sl < s0)
            tma_load(dst, &ma0, &full[s], sl * kBox, k0);
          else
            tma_load(dst, &ma1, &full[s], (sl - s0) * kBox, k0 - shift);
        }
      }
    }
    return;
  }

  // this thread's two columns 2 cp, 2 cp + 1 of B's tile and its rows
  // r, r + 8, ..., r + 56 of a stage: one 4-byte word a row in the
  // 128-byte swizzle (16-byte chunk c of row k sits at chunk c ^ (k % 8))
  const int cp = threadIdx.x % 64, r = threadIdx.x / 64;
  const int cs_at = (cp / 32) * (kTileBytes / 2) + r * 128 + ((((cp % 32) / 4) ^ r) * 16) +
                    (cp % 4) * 4;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  float cs0 = 0.f, cs1 = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStackStages;
    mbar_wait(&full[s], (it / kStackStages) & 1);
    const unsigned char* st = base + s * kStackStageBytes;
    // a warpgroup past the last slice multiplies a slice no copy fills and
    // writes nothing: no branch around the warpgroup-wide products
    fence_regs(d);
    wg_fence();
    stage_mma<true, true>(d, reinterpret_cast<const bf16*>(st + kTileBytes + g * kSliceBytes),
                          reinterpret_cast<const bf16*>(st), 0);
    wg_commit();
    if (colsum) {
#pragma unroll
      for (int q = 0; q < kBK / 8; ++q) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(st + cs_at + q * 1024);
        cs0 += __low2float(v);
        cs1 += __high2float(v);
      }
    }
    wg_wait<0>();
    fence_regs(d);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
  }

  if (g < active) {
    const int sl = first + g, w = (threadIdx.x / 32) % 4, l = threadIdx.x % 32;
    const int row0 = sl < s0 ? sl * kBox : M0 + (sl - s0) * kBox;  // C's row of the slice's first
    const int rows = sl < s0 ? M0 : M0 + M1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + 16 * w + l / 4 + 8 * h;
      if (i >= rows) continue;
#pragma unroll
      for (int j8 = 0; j8 < kBN / 8; ++j8) {
        const int j = j0 + 8 * j8 + 2 * (l % 4);
        if (j < N) epi(i, j, d[4 * j8 + 2 * h], d[4 * j8 + 2 * h + 1], j + 1 < N);
      }
    }
  }
  if (colsum) {  // the 8 row strands of each column, added in order
    red[r][2 * cp] = cs0;
    red[r][2 * cp + 1] = cs1;
    asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kStackSlices) : "memory");
    if (threadIdx.x < kBN && j0 + (int)threadIdx.x < N) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += red[q][threadIdx.x];
      epi(M0 + M1, j0 + threadIdx.x, sum, 0.f, false);
    }
  }
}

// ------------------------------------------------------------ host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no link
// against libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess && q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the card's SM count
inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!sms) sms = 132;
  }
  return sms;
}

// The TMA can read a row-major bf16 matrix with row stride ld (elements)
// from base p.
inline bool tma_ok(const void* p, int ld) { return ((uintptr_t)p & 15) == 0 && ld % 8 == 0; }

// A map of the row-major (rows, cols) bf16 matrix at p, row stride ld, in
// boxes of box_cols x box_rows with the 128-byte swizzle; zero fill outside.
inline int make_map(CUtensorMap* map, const void* p, int rows, int cols, int ld, int box_cols,
                    int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The map of operand A or B of a product: K-major, stored (rows, K) with
// boxes of kBK x box_rows rows; MN-major, stored (K, rows) with boxes of
// 64 x kBK.
inline int operand_map(CUtensorMap* map, const bf16* p, int ld, int rows, int K, bool mn,
                       int box_rows = 128) {
  return mn ? make_map(map, p, K, rows, ld, kBox, kBK)
            : make_map(map, p, rows, K, ld, kBK, box_rows);
}

inline int tiles(const Dims& d) { return ((d.M + kBM - 1) / kBM) * ((d.N + kBN - 1) / kBN); }

// Every operand of the launch can go through the TMA.
inline bool usable(const Operands& o0, const Operands* o1) {
  return tma_ok(o0.A, o0.lda) && tma_ok(o0.B, o0.ldb) &&
         (!o1 || (tma_ok(o1->A, o1->lda) && tma_ok(o1->B, o1->ldb)));
}

// k chunk of a product split `splits` ways: whole k steps, so only the last
// chunk is ragged
inline int k_chunk(int K, int splits) {
  const int c = (K + splits - 1) / splits;
  return (c + kBK - 1) / kBK * kBK;
}

// 3 stages of 32 KB: two CTAs an SM (90 registers a thread), so one CTA's
// ring fill and epilogue overlap the other's products
constexpr int kStages = 3, kMinBlocks = 2;

// One product (o1 null) or two of the same orientation, depth K, split
// `splits` ways along k; cudaErrorInvalidValue where an operand is not
// 16-byte aligned (usable).
template <bool A_MN, bool B_MN, class Epi>
int launch(const Operands& o0, const Operands* o1, Epi e0, Epi e1, int K, int splits,
           cudaStream_t st) {
  if (!usable(o0, o1)) return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  const Operands* op[2] = {&o0, o1 ? o1 : &o0};
  for (int q = 0; q < 2; ++q) {
    int rc = operand_map(&m[2 * q], op[q]->A, op[q]->lda, op[q]->M, K, A_MN);
    if (!rc) rc = operand_map(&m[2 * q + 1], op[q]->B, op[q]->ldb, op[q]->N, K, B_MN);
    if (rc) return rc;
  }
  auto kern = tma_gemm<A_MN, B_MN, kStages, kMinBlocks, Epi>;
  constexpr int smem = Smem<kStages>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const Dims d0{o0.M, o0.N}, d1{op[1]->M, op[1]->N};
  const int t = o1 ? max(tiles(d0), tiles(d1)) : tiles(d0);
  kern<<<dim3(t, splits, o1 ? 2 : 1), kThreads, smem, st>>>(m[0], m[1], m[2], m[3], d0, d1, e0,
                                                          e1, K, k_chunk(K, splits));
  return (int)cudaGetLastError();
}

// One stacked contraction (stack_contract) over K rows in chunks of kchunk
// rows (a multiple of kBK): a0 (K, M0), a1 (K, M1) shifted `shift` rows
// back, b (K, N); epi takes chunk blockIdx.y's partial of rows
// [0, M0 + M1 + (sums != 0)). cudaErrorInvalidValue where an operand is not
// 16-byte aligned (usable) or kchunk is not whole steps.
template <class Epi>
int launch_stack(const bf16* a0, int M0, const bf16* a1, int M1, int shift, const bf16* b, int N,
                 int K, int kchunk, int sums, Epi epi, cudaStream_t st) {
  if (!tma_ok(a0, M0) || !tma_ok(a1, M1) || !tma_ok(b, N) || K <= 0 || kchunk <= 0 ||
      kchunk % kBK)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[3];
  int rc = operand_map(&m[0], a0, M0, M0, K, true);
  if (!rc) rc = operand_map(&m[1], a1, M1, M1, K, true);
  if (!rc) rc = operand_map(&m[2], b, N, N, K, true);
  if (rc) return rc;
  auto kern = stack_contract<Epi>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kStackSmem);
  if (e != cudaSuccess) return (int)e;
  const int slices = (M0 + kBox - 1) / kBox + (M1 + kBox - 1) / kBox;
  const dim3 grid((N + kBN - 1) / kBN, (K + kchunk - 1) / kchunk,
                  (slices + kStackSlices - 1) / kStackSlices);
  kern<<<grid, kStackThreads, kStackSmem, st>>>(m[0], m[1], m[2], M0, M1, N, K, shift, kchunk,
                                                sums, epi);
  return (int)cudaGetLastError();
}

}  // namespace wg
