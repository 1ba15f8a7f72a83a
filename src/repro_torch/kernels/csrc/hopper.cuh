// Device helpers shared by the port's Hopper (sm_90a) kernels: type
// conversions, mbarriers, TMA and cp.async copies, wgmma shared-memory
// descriptors, and the wgmma and mma.sync instructions the kernels issue.
// Included by every csrc/*.cu; kernels/_build.py hashes it into every
// library's name.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// Two fp32 values rounded to T and packed into 32 bits, the first in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  const __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bits of two 16-bit values packed into 32, the first in the low half.
template <typename W>
__device__ __forceinline__ uint32_t bits2(W lo, W hi) {
  static_assert(sizeof(W) == 2, "16-bit values");
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&lo)) |
         static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&hi)) << 16;
}

// The exact three-piece bf16 split of an fp32 value: v == p0 + p1 + p2 in
// real arithmetic (each residual is exact in fp32, and three 8-bit
// significands with their signs cover fp32's 24), for every finite v whose
// last piece does not underflow (|v| above about 2^-110).
__device__ __forceinline__ void split3(float v, __nv_bfloat16& p0, __nv_bfloat16& p1,
                                       __nv_bfloat16& p2) {
  p0 = __float2bfloat16_rn(v);
  float r = v - __bfloat162float(p0);
  p1 = __float2bfloat16_rn(r);
  r -= __bfloat162float(p1);
  p2 = __float2bfloat16_rn(r);
}

// split3 of two values at once, each piece's pair packed as bf16x2 (a in
// the low half): one cvt.rn.bf16x2.f32 a piece, the same roundings.
__device__ __forceinline__ void split3x2(float a, float b, uint32_t (&p)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    p[k] = *reinterpret_cast<const uint32_t*>(&v);
    const float2 back = __bfloat1622float2(v);
    a -= back.x;
    b -= back.y;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of byte `x` (< 128) of row `y` in a 128-byte-swizzled tile whose
// base is 1024-byte aligned: the layout TMA's CU_TENSOR_MAP_SWIZZLE_128B
// writes, and wgmma's 128-byte-swizzle descriptors read.
__device__ __forceinline__ uint32_t swizzle128(int y, int x) {
  return y * 128 + ((((x >> 4) ^ y) & 7) << 4) + (x & 15);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of `bar` has completed.  A lost
// arrival would hang the card; after 10 s this traps instead, so the launch
// fails with an error the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

// One box of a 3-D tensor map into shared memory; completion counts bytes
// on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box from shared memory into a 3-D tensor map; the parts of the box
// outside the array are not written.
__device__ __forceinline__ void tma_store_3d(const void* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments a running wgmma reads from registers.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define ACC8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64 x 16) * B (16 x N), for N = 64, 160, 192 and 256, A and B from shared
// memory: A k-major (imm-trans-a = kTA = 0) or MN-major (1), B k-major
// (imm-trans-b = kTB = 0) or MN-major (1); the accumulators are overwritten
// where scale_d is 0.
// Accumulator i of thread (warp w, lane l) of the warpgroup is row
// 16 w + l / 4 + 8 (i / 2 % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
#define WGMMA_M64N64K16(TY)                                                               \
  asm volatile(                                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY "\n"                        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"          \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},\n" \
      " %32, %33, p, 1, 1, %35, %36;\n}\n"                                               \
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)                                              \
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB))

#define WGMMA_M64N256K16(TY)                                                                                \
  asm volatile(                                                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY "\n"                                         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"                            \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"                  \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"                  \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,\n"                  \
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,\n"                  \
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,\n"                  \
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,\n"      \
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},\n" \
      " %128, %129, p, 1, 1, %131, %132;\n}\n"                                                              \
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56),                       \
        ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)                   \
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB))

#define WGMMA_M64N160K16(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n160k16.f32." TY "." TY "\n"  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"  \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"  \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"  \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,\n"  \
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79},\n"  \
      " %80, %81, p, 1, 1, %83, %84;\n}\n"  \
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), ACC8(64), ACC8(72)  \
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB))

#define WGMMA_M64N192K16(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY "\n"  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"  \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"  \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"  \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,\n"  \
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,\n"  \
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},\n"  \
      " %96, %97, p, 1, 1, %99, %100;\n}\n"  \
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88)  \
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB))

// d (+)= A (64 x 16, from registers: warp w holds rows 16 w to 16 w + 15 as
// mma.m16n8k16's A fragment, as ldmatrix.x4 loads it) * B (16 x 128,
// MN-major in shared memory), bf16.
#define WGMMA_M64N128K16_RS(TY)                                                              \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY "\n"                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"             \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"   \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"   \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},\n"  \
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                          \
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)         \
      : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "l"(db), "r"(scale_d))

__device__ __forceinline__ void wgmma_rs_k16_n128_bf16(float (&d)[64], const uint32_t (&fa)[4],
                                                       uint64_t db, int scale_d) {
  WGMMA_M64N128K16_RS("bf16");
}

// Four 8 x 8 matrices of 16-bit values from shared memory, one row address
// a lane (lanes 8 m to 8 m + 7 address matrix m's rows).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Four 8 x 8 matrices of 16-bit values, each transposed on the way: lane l
// of the warp receives elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4)
// of each matrix as stored (rows at the addresses lanes 8 m to 8 m + 7 give).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Four 8 x 8 matrices of 16-bit values into shared memory, one row address
// a lane (lanes 8 m to 8 m + 7 address matrix m's rows); lane l gives
// elements (l / 4, 2 (l % 4)) and (l / 4, 2 (l % 4) + 1) of matrix m in r[m],
// the first in the low half: the layout of a wgmma accumulator's 8 x 8
// blocks, packed by pack2.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// The same, each matrix stored transposed: the row at the address lane
// 8 m + i gives holds column i of matrix m.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(
                   addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// c += A (16 x 16, row-major fragment) * B (16 x 8, column-major fragment)
// on the tensor cores, T = bf16 or fp16, fp32 accumulators.  Lane l = 4 g + t
// holds A rows g and g + 8, columns 2t, 2t + 1 (+ 8); B rows 2t, 2t + 1 (+ 8),
// column g; C rows g and g + 8, columns 2t and 2t + 1.
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    static_assert(std::is_same<T, __half>::value, "mma_16816 takes bf16 or fp16");
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// 16 bytes from global to shared memory without passing through registers,
// cached in L2 only; the last 16 - src_bytes bytes are written zero
// (src_bytes = 0 reads nothing).  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4 bytes from global to shared memory, through L1; the last 4 - src_bytes
// bytes are written zero.  Both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One wgmma m64nNk16 with T (bf16 or fp16) operands, N = 2 * (accumulators
// per thread); kTA and kTB are the instruction's imm-trans-a and imm-trans-b
// (1: the operand is MN-major in shared memory).
template <typename T, int NACC, int kTA = 0, int kTB = 1>
__device__ __forceinline__ void wgmma_k16(float (&d)[NACC], uint64_t da, uint64_t db,
                                          int scale_d) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(kBf16 || std::is_same<T, __half>::value, "wgmma takes bf16 or fp16 here");
  static_assert(NACC == 32 || NACC == 80 || NACC == 96 || NACC == 128,
                "N is 64, 160, 192 or 256");
  if constexpr (NACC == 32) {
    if constexpr (kBf16) {
      WGMMA_M64N64K16("bf16");
    } else {
      WGMMA_M64N64K16("f16");
    }
  } else if constexpr (NACC == 80) {
    if constexpr (kBf16) {
      WGMMA_M64N160K16("bf16");
    } else {
      WGMMA_M64N160K16("f16");
    }
  } else if constexpr (NACC == 96) {
    if constexpr (kBf16) {
      WGMMA_M64N192K16("bf16");
    } else {
      WGMMA_M64N192K16("f16");
    }
  } else {
    if constexpr (kBf16) {
      WGMMA_M64N256K16("bf16");
    } else {
      WGMMA_M64N256K16("f16");
    }
  }
}

}  // namespace
