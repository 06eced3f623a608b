// Hopper (sm_90a) primitives as inline PTX, shared by the port's redesigned
// kernels: warpgroup MMA (wgmma) with shared-memory matrix descriptors in the
// 128-byte swizzle or none (`desc_plain`: row-shifted views), mbarriers, TMA
// tile and bulk loads (3-D maps of activations, 2-D maps of weights, 3-D
// (in, tap, out) maps of conv weights), the async-proxy fence, named
// barriers and register reallocation (setmaxnreg).
// Inline PTX keeps the build to seconds (no CuTe/CUTLASS headers).
//
// Layout convention. A "sub-tile" is 64 rows x 64 bf16 columns (8 KB): row r
// at byte r * 128, its 16-byte chunk c stored at chunk c ^ (r % 8), which is
// what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B and a {64, 64} box writes
// into a 1024-byte aligned destination. A tile of 64 rows x DK columns is
// DK / 64 sub-tiles back to back.
//  * K-major operand (the reduction runs along a row: Q, K in S = Q K^T):
//    k-step ks (16 columns) of the tile at `base` starts at
//    base + (ks / 4) * 8192 + (ks % 4) * 32; stride between 8-row groups
//    (SBO) 1024 bytes. `kmajor_desc`.
//  * MN-major operand (the reduction runs down the rows, the output column
//    along a row: V in O = P V): k-step kk (16 rows) of the output-column
//    block cb starts at base + cb * 8192 + kk * 2048; SBO (8-row groups along
//    the reduction) 1024 bytes, LBO (64-column blocks along N) 8192 bytes.
//    Used with the transpose bit. `mnmajor_desc`.
//
// The attention kernels' MMA shape is m64n64k16 (bf16 in, f32 accumulate); a
// wider output is covered by one accumulator of 32 registers per 64 columns.
// `wgmma_ss_k<N>` and `wgmma_rs_k<N>` are the K-major products at any N that
// is a multiple of 16 up to 128 (N / 2 accumulators a thread, the same layout
// with N / 8 n-tiles), for the conv GEMMs of the residual stack; `wgmma_ss_k`
// also at N = 192 and 256, for the conv-FFN. Accumulator
// layout (thread t of the warpgroup, i in [0, 32)): row 16 * (t / 32) +
// (t % 32) / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (t % 4) + i % 2,
// i.e. the m16n8 warp MMA's C fragment per warp, repeated over 8 n-tiles. The
// register A operand of an RS product uses the m16n8k16 warp MMA's A
// fragment per warp, so a score accumulator converts to it without shuffles.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The first 1024-byte boundary at or after p (a 128-byte swizzle atom).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// ---- mbarrier ------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}
// Arrive once and raise the barrier's expected transaction bytes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed. A fresh barrier
// counts its (virtual) preceding phase, parity 1, as completed. A wait that
// spins for seconds traps, so a protocol fault surfaces as a launch error
// instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, spins = 0;
  do {
    if (++spins == (1u << 30)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// Whether the phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// One arrival per warp on `bar` (lane 0), after the whole warp got here: a
// ring stage's release once the warp's products that read it have retired.
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// ---- TMA -----------------------------------------------------------------
// One box of a 3-D tensor map into shared memory; completion counts its bytes
// on `bar`. c0 is the innermost (column) coordinate.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// One box of a 2-D tensor map (`tma_map_bf16_2d`): c0 column, c1 row.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// `bytes` (a multiple of 16) of contiguous global memory, both ends 16-byte
// aligned.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (a wgmma that reads them by descriptor, a TMA store); a barrier
// after it publishes them to the other threads' products.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- named barriers (id 0 is __syncthreads) -------------------------------
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- register reallocation between warpgroups -----------------------------
// For kernels with a producer warpgroup. The training-attention kernels do
// not use it: ptxas held their consumer code to the entry count (168 at 384
// threads) regardless, so they run 256 threads and no producer warpgroup.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma ---------------------------------------------------------------
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}
// No swizzle (K-major, 8 x 16-byte core matrices): lbo the byte stride
// between the two core matrices of a k-step (along K), sbo between 8-row
// groups. With rows 16 bytes apart throughout (sbo = 128, a column-chunk-major
// buffer [K / 8][rows][8]), a view shifted by any number of rows is a base
// offset of 16 bytes a row.
__device__ __forceinline__ uint64_t desc_plain(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int ks) {
  return desc_sw128(base + (ks >> 2) * 8192 + (ks & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int cb, int kk) {
  return desc_sw128(base + cb * 8192 + kk * 2048, 8192, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of accumulator registers across an
// asynchronous MMA that owns them.
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FS2_WGMMA_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FS2_WGMMA_OUT32(d)                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d (+)= A B, A and B from shared memory (descriptors). TRANS_B = 1: B is
// MN-major. scale_d = 0 overwrites d.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FS2_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : FS2_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// d (+)= A B, A from registers (four bf16x2 words per thread, the m16n8k16 A
// fragment of the warp's 16 rows), B from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FS2_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : FS2_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// ---- wgmma at N = 16 .. 256 (the residual stack's and the FFN's convs) -----
// d (+)= A B for a 64 x N tile, N a multiple of 16 up to 128 (and 192, 256
// for `wgmma_ss_k`): N / 2 f32
// accumulators a thread in the layout above (n-tile ni at d[4 ni .. 4 ni + 3]).
// B is K-major from shared memory (`kmajor_desc`). `wgmma_ss_k`: A from
// shared memory, K-major, by a descriptor of any swizzle mode (`desc_plain`
// for a row-shifted view); `wgmma_rs_k`: A from registers (the m16n8k16 A
// fragment of the warp's 16 rows).
template <int N>
__device__ __forceinline__ void wgmma_ss_k(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t db, int scale_d);

// operand lists of 8 Q accumulators: "%0, ..., %(8Q - 1)" and d[0 .. 8Q - 1]
#define FS2_O8(d, b)                                                                   \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),          \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define FS2_ACC_S1 "%0, %1, %2, %3, %4, %5, %6, %7"
#define FS2_ACC_S2 FS2_ACC_S1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define FS2_ACC_S3 FS2_ACC_S2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define FS2_ACC_S4 FS2_ACC_S3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define FS2_ACC_S5 FS2_ACC_S4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define FS2_ACC_S6 FS2_ACC_S5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define FS2_ACC_S7 FS2_ACC_S6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define FS2_ACC_S8 FS2_ACC_S7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define FS2_ACC_S9 FS2_ACC_S8 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define FS2_ACC_S10 FS2_ACC_S9 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define FS2_ACC_S11 FS2_ACC_S10 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define FS2_ACC_S12 FS2_ACC_S11 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define FS2_ACC_S13 FS2_ACC_S12 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define FS2_ACC_S14 FS2_ACC_S13 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define FS2_ACC_S15 FS2_ACC_S14 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define FS2_ACC_S16 FS2_ACC_S15 ", %120, %121, %122, %123, %124, %125, %126, %127"
#define FS2_ACC_O1(d) FS2_O8(d, 0)
#define FS2_ACC_O2(d) FS2_ACC_O1(d), FS2_O8(d, 8)
#define FS2_ACC_O3(d) FS2_ACC_O2(d), FS2_O8(d, 16)
#define FS2_ACC_O4(d) FS2_ACC_O3(d), FS2_O8(d, 24)
#define FS2_ACC_O5(d) FS2_ACC_O4(d), FS2_O8(d, 32)
#define FS2_ACC_O6(d) FS2_ACC_O5(d), FS2_O8(d, 40)
#define FS2_ACC_O7(d) FS2_ACC_O6(d), FS2_O8(d, 48)
#define FS2_ACC_O8(d) FS2_ACC_O7(d), FS2_O8(d, 56)
#define FS2_ACC_O9(d) FS2_ACC_O8(d), FS2_O8(d, 64)
#define FS2_ACC_O10(d) FS2_ACC_O9(d), FS2_O8(d, 72)
#define FS2_ACC_O11(d) FS2_ACC_O10(d), FS2_O8(d, 80)
#define FS2_ACC_O12(d) FS2_ACC_O11(d), FS2_O8(d, 88)
#define FS2_ACC_O13(d) FS2_ACC_O12(d), FS2_O8(d, 96)
#define FS2_ACC_O14(d) FS2_ACC_O13(d), FS2_O8(d, 104)
#define FS2_ACC_O15(d) FS2_ACC_O14(d), FS2_O8(d, 112)
#define FS2_ACC_O16(d) FS2_ACC_O15(d), FS2_O8(d, 120)
#define FS2_WGMMA_SS_K(N, Q, IA, IB, IP)                                                    \
  template <>                                                                               \
  __device__ __forceinline__ void wgmma_ss_k<N>(float (&d)[N / 2], uint64_t da, uint64_t db, \
                                                int scale_d) {                              \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" #IP ", 0;\n"                         \
                 " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" FS2_ACC_S##Q \
                 "}, %" #IA ", %" #IB ", p, 1, 1, 0, 0;\n}\n"                                \
                 : FS2_ACC_O##Q(d)                                                          \
                 : "l"(da), "l"(db), "r"(scale_d));                                         \
  }
#define FS2_WGMMA_RS_K(N, Q, A0, A1, A2, A3, IB, IP)                                        \
  template <>                                                                               \
  __device__ __forceinline__ void wgmma_rs_k<N>(float (&d)[N / 2], const uint32_t (&a)[4],  \
                                                uint64_t db, int scale_d) {                 \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" #IP ", 0;\n"                         \
                 " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" FS2_ACC_S##Q \
                 "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #IB ", p, 1, 1, 0;\n}\n"  \
                 : FS2_ACC_O##Q(d)                                                          \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));     \
  }
FS2_WGMMA_SS_K(16, 1, 8, 9, 10)
FS2_WGMMA_SS_K(32, 2, 16, 17, 18)
FS2_WGMMA_SS_K(48, 3, 24, 25, 26)
FS2_WGMMA_SS_K(64, 4, 32, 33, 34)
FS2_WGMMA_SS_K(80, 5, 40, 41, 42)
FS2_WGMMA_SS_K(96, 6, 48, 49, 50)
FS2_WGMMA_SS_K(112, 7, 56, 57, 58)
FS2_WGMMA_SS_K(128, 8, 64, 65, 66)
FS2_WGMMA_SS_K(192, 12, 96, 97, 98)
FS2_WGMMA_SS_K(256, 16, 128, 129, 130)
FS2_WGMMA_RS_K(16, 1, 8, 9, 10, 11, 12, 13)
FS2_WGMMA_RS_K(32, 2, 16, 17, 18, 19, 20, 21)
FS2_WGMMA_RS_K(48, 3, 24, 25, 26, 27, 28, 29)
FS2_WGMMA_RS_K(64, 4, 32, 33, 34, 35, 36, 37)
FS2_WGMMA_RS_K(80, 5, 40, 41, 42, 43, 44, 45)
FS2_WGMMA_RS_K(96, 6, 48, 49, 50, 51, 52, 53)
FS2_WGMMA_RS_K(112, 7, 56, 57, 58, 59, 60, 61)
FS2_WGMMA_RS_K(128, 8, 64, 65, 66, 67, 68, 69)
#undef FS2_WGMMA_SS_K
#undef FS2_WGMMA_RS_K
#undef FS2_ACC_S1
#undef FS2_ACC_O1
#undef FS2_ACC_S2
#undef FS2_ACC_O2
#undef FS2_ACC_S3
#undef FS2_ACC_O3
#undef FS2_ACC_S4
#undef FS2_ACC_O4
#undef FS2_ACC_S5
#undef FS2_ACC_O5
#undef FS2_ACC_S6
#undef FS2_ACC_O6
#undef FS2_ACC_S7
#undef FS2_ACC_O7
#undef FS2_ACC_S8
#undef FS2_ACC_O8
#undef FS2_ACC_S9
#undef FS2_ACC_O9
#undef FS2_ACC_S10
#undef FS2_ACC_O10
#undef FS2_ACC_S11
#undef FS2_ACC_O11
#undef FS2_ACC_S12
#undef FS2_ACC_O12
#undef FS2_ACC_S13
#undef FS2_ACC_O13
#undef FS2_ACC_S14
#undef FS2_ACC_O14
#undef FS2_ACC_S15
#undef FS2_ACC_O15
#undef FS2_ACC_S16
#undef FS2_ACC_O16
#undef FS2_O8

#undef FS2_WGMMA_D32
#undef FS2_WGMMA_OUT32

// ---- host: tensor maps ------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// needs no -lcuda.
static inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// A bf16 3-D map over (cols, rows, planes), strides in elements, read in
// {64, 64, 1} boxes with the 128-byte swizzle; rows or columns past the
// extents read as zeros.
static inline cudaError_t tma_map_bf16(CUtensorMap* map, const void* base, uint64_t cols,
                                       uint64_t rows, uint64_t planes, uint64_t row_stride,
                                       uint64_t plane_stride) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  // the encoder needs a current context, which a thread that has made no
  // runtime call yet (autograd's backward thread) may not have
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {cols, rows, planes};
  const cuuint64_t strides[2] = {row_stride * 2, plane_stride * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 2-D map over a row-major matrix (cols, rows; row stride in
// elements), read in {64, box_rows} boxes with the 128-byte swizzle: a box
// lands as box_rows K-major rows of 128 bytes, `kmajor_desc`'s layout.
// Columns past `cols` read as zeros.
static inline cudaError_t tma_map_bf16_2d(CUtensorMap* map, const void* base, uint64_t cols,
                                          uint64_t rows, uint64_t row_stride,
                                          uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  int dev = 0;  // a current context, as in tma_map_bf16
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_stride * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 3-D map over conv weights laid out (out, tap, in), the input axis
// `cols` wide at a row stride of `ld` elements (ld >= cols): (cols, taps,
// rows), read in {64, 1, box_rows} boxes with the 128-byte swizzle, so the
// box at (c, j, n) is tap j's input columns c .. c + 63 of output rows n ..
// n + box_rows - 1 in `kmajor_desc`'s layout. Columns past `cols` and rows
// past `rows` read as zeros: each tap is zero-padded to the K step, and the
// weights need no padded copy.
static inline cudaError_t tma_map_bf16_taps(CUtensorMap* map, const void* base, uint64_t cols,
                                            uint64_t taps, uint64_t rows, uint64_t ld,
                                            uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  int dev = 0;  // a current context, as in tma_map_bf16
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {cols, taps, rows};
  const cuuint64_t strides[2] = {ld * 2, taps * ld * 2};
  const cuuint32_t box[3] = {64, 1, box_rows};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
