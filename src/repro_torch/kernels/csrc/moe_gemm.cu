// Grouped expert GEMM (E, C, d) x (E, d, f) -> (E, C, f) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py:_kernel (:23, launched by
// pl.pallas_call at :61; reached through moe_gemm and ops.grouped_gemm): for
// every expert e,
//     out[e] = x[e] @ w[e]
// summed in fp32 and written in x's type (not the promoted type: the TPU
// kernel writes x.dtype, and so do these).  The TPU kernel's grid is
// (E, C/b_c, f/b_f, d/b_d) with the d axis innermost and sequential, carrying
// an fp32 scratch tile across it.  Here the d loop runs inside each program,
// so the accumulator stays in registers and no program depends on another.
//
// What bounds it: operations.  At the full width of Qwen3-MoE-235B-A22B's
// experts (E = 128, C = 640, d = 4096, f = 1536) a projection is 1.03 TFLOP
// against 2.5 GB: 1.04 ms at the bf16 tensor cores' 989 TFLOP/s, 0.76 ms at
// 3.35 TB/s.  Two kernels, picked by the wrapper before launch:
//
// expert_wgmma<T> (x and w both bf16 or both fp16, d and f multiples of 8,
// 16-byte aligned data): the tensor-core kernel the bound asks for.
//   - Operands come by TMA from 3-D tensor maps, x as {d, C, E} and w as
//     {f, d, E}, so a tile never reads across an expert and the ragged edges
//     of C, d and f arrive zero-filled.  A stage holds a 128 x 64 tile of x
//     (k-major, as x is stored) and a 64 x 256 tile of w, loaded as four
//     64 x 64 boxes; all are 128-byte swizzled.  w is read as it is stored,
//     f contiguous, as wgmma's MN-major B operand (transpose-B): no
//     transposed copy of w is made.
//   - Warp specialisation: one producer warpgroup (registers given up with
//     setmaxnreg) whose single thread keeps a ring of 3 stages (48 KB each)
//     in flight, guarded by "full" (TMA bytes) and "empty" (consumer warps)
//     mbarriers; two consumer warpgroups each own 64 rows of the 128 x 256
//     tile and run wgmma m64n256k16 with 128 fp32 accumulators a thread,
//     keeping one k-block's group in flight while the next is issued.  The
//     128 x 256 tile is the widest the registers hold, and moves the fewest
//     bytes from L2 per operation.
//   - Persistent walk: one block per SM steps through linear tile ids
//     (expert, row tile, column tile), expert-major, so the tiles of one
//     expert run at the same time and read its x[e] (5.2 MB) and w[e]
//     (12.6 MB) k-slice by k-slice from the 50 MB L2.
//   - Epilogue: each consumer rounds its fp32 sums once to T (the reference's
//     acc.astype(o.dtype)) into its own 32 KB of shared memory, as the
//     swizzled 64 x 64 boxes of a third tensor map, and one thread stores
//     them by TMA (clipped at the C and f edges) while the warpgroup starts
//     the next tile; the producer is already loading it.  Storing straight
//     from registers instead left the tensor cores idle longer at each tile's
//     end, which costs most where d is short (the down projection's 1536).
//   Why it keeps the reference's numbers: the TPU kernel casts the 16-bit
//   tiles to fp32 and dots them in fp32.  A product of two bf16 values
//   (8-bit significands) or two fp16 values (11-bit) is exact in fp32
//   (24 bits), so wgmma with fp32 accumulation forms the same sum, up to the
//   order of the additions.  fp32 inputs are another matter: TF32 would drop
//   about three digits, so they stay on the CUDA cores.
//
// expert_tiles<T, TO> (fp32, mixed inputs met at fp32, and 16-bit inputs the
// tensor maps cannot describe): fp32 FMAs on the CUDA cores.  A program owns
// a 128 x 128 output tile; its 16 x 16 threads each keep an 8 x 8 fp32
// accumulator (two 4-row by two 4-column quadrants, so each thread's
// shared-memory reads are 16-byte and conflict-free); the d loop stages a
// 128 x 16 slice of x (transposed) and a 16 x 128 slice of w in shared
// memory as fp32, and each element staged is used 128 times.  Edges are
// masked, so any (C, d, f) works; the wrapper keeps the TPU kernel's
// divisibility contract.
//
// The host side reaches libcuda's cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint, so the library links against the runtime alone.

#include <cuda.h>          // CUtensorMap and its enums; nothing of libcuda is linked
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled_v12000
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kSide = 16;             // threads per side of a program
constexpr int kTile = 128;            // output rows and columns per program
constexpr int kSliceD = 16;           // d per staged slice
constexpr int kHalf = kTile / 2;      // quadrant offset
constexpr int kMaxGridYZ = 65535;

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

// Program (blockIdx.x, blockIdx.y, blockIdx.z) owns columns
// [blockIdx.x * 128, +128) and rows [blockIdx.y * 128, +128) of expert
// blockIdx.z.  Thread (ty, tx) holds rows {ty*4 + i, 64 + ty*4 + i} and
// columns {tx*4 + j, 64 + tx*4 + j}, i, j < 4.
template <typename T, typename TO>
__global__ void __launch_bounds__(kSide* kSide)
    expert_tiles(const T* __restrict__ x, const T* __restrict__ w, TO* __restrict__ out,
                 int c, int d, int f) {
  __shared__ __align__(16) float x_s[kSliceD][kTile];  // x slice, transposed
  __shared__ __align__(16) float w_s[kSliceD][kTile];
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const T* xe = x + static_cast<int64_t>(e) * c * d;
  const T* we = w + static_cast<int64_t>(e) * d * f;
  const int t = threadIdx.x;
  const int tx = t % kSide;
  const int ty = t / kSide;
  // staging: thread t loads 8 consecutive d of x row t / 2, and 8
  // consecutive columns of w slice row t / 16
  const int xr = t / 2, xk = (t % 2) * 8;
  const int wk = t / kSide, wc = (t % kSide) * 8;
  const bool x_row_in = row0 + xr < c;
  const T* x_row = xe + static_cast<int64_t>(row0 + xr) * d;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < d; k0 += kSliceD) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int gk = k0 + xk + q;
      x_s[xk + q][xr] = (x_row_in && gk < d) ? to_f32(x_row[gk]) : 0.f;
    }
    const int gk = k0 + wk;
    const T* w_row = we + static_cast<int64_t>(gk) * f + col0 + wc;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      w_s[wk][wc + q] = (gk < d && col0 + wc + q < f) ? to_f32(w_row[q]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSliceD; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&x_s[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&x_s[k][kHalf + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&w_s[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&w_s[k][kHalf + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  TO* oe = out + static_cast<int64_t>(e) * c * f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? ty * 4 + i : kHalf + ty * 4 + i - 4);
    if (row >= c) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : kHalf + tx * 4 + j - 4);
      if (col < f) oe[static_cast<int64_t>(row) * f + col] = from_f32<TO>(acc[i][j]);
    }
  }
}

template <typename T, typename TO>
void launch(const void* x, const void* w, void* out, int e, int c, int d, int f,
            cudaStream_t stream) {
  const dim3 grid((f + kTile - 1) / kTile, (c + kTile - 1) / kTile, e);
  expert_tiles<T, TO><<<grid, kSide * kSide, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<TO*>(out), c, d, f);
}

// ---------------------------------------------------------------- expert_wgmma

constexpr int kWgBM = 128;  // tile rows: two consumer warpgroups of 64
constexpr int kWgBN = 256;  // tile columns: one wgmma m64n256k16 per k16 step
constexpr int kWgBK = 64;   // d per stage: one 128-byte swizzle row of 16-bit values
constexpr int kBox = 64;    // w and out move in boxes 64 columns (128 bytes) wide
constexpr int kABytes = kWgBM * kWgBK * 2;    // 16 KB of x per stage
constexpr int kBBytes = kWgBK * kWgBN * 2;    // 32 KB of w per stage
constexpr int kBoxBytes = 64 * kBox * 2;      // one 64-row box: 8 KB
constexpr int kOutBytes = 64 * kWgBN * 2;     // one consumer's 64 x 256 output
constexpr int kWgStages = 3;                  // what fits beside the two output buffers
constexpr int kWgThreads = 384;      // producer warpgroup, then two consumer warpgroups
constexpr int kConsumerWarps = 8;    // arrivals that free a stage
constexpr int kSwizzleAtom = 1024;   // 8 rows of 128 bytes: the swizzle's period
constexpr int kWgSmem =
    kSwizzleAtom + kWgStages * (kABytes + kBBytes) + 2 * kOutBytes + 2 * kWgStages * 8;
static_assert(kWgBN % kBox == 0 && kWgSmem <= 227 * 1024, "tile does not fit");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box from shared memory into a 3-D tensor map; the parts of the box
// outside the array are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
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

#define ACC8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64 x 16, k-major) * B (16 x 256, MN-major: imm-trans-b = 1); the
// accumulators are overwritten where scale_d is 0.
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
      " %128, %129, p, 1, 1, 0, 1;\n}\n"                                                                    \
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56),                       \
        ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)                   \
      : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_k16(float (&d)[kWgBN / 2], uint64_t da, uint64_t db,
                                          int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGMMA_M64N256K16("bf16");
  } else {
    WGMMA_M64N256K16("f16");
  }
}

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

// Block b walks tiles t = b, b + gridDim.x, ... of the n_experts x
// ceil(C/128) x ceil(f/256) grid, expert-major, then row tile, then column
// tile.
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    expert_wgmma(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap out_map, int n_experts, int c, int d,
                 int f) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kSwizzleAtom - 1) & ~uint32_t(kSwizzleAtom - 1);
  const uint32_t a_smem = base;                          // stages of x: 128 rows x 128 bytes
  const uint32_t b_smem = a_smem + kWgStages * kABytes;  // stages of w: 4 boxes of 64 x 128 B
  const uint32_t o_smem = b_smem + kWgStages * kBBytes;  // per consumer: 4 boxes of 64 x 128 B
  const uint32_t full = o_smem + 2 * kOutBytes;          // one mbarrier per stage
  const uint32_t empty = full + kWgStages * 8;
  const int n_tiles = (f + kWgBN - 1) / kWgBN;
  const int per_expert = ((c + kWgBM - 1) / kWgBM) * n_tiles;
  const int n_work = n_experts * per_expert;
  const int k_blocks = (d + kWgBK - 1) / kWgBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
        const int e = t / per_expert, r = t % per_expert;
        const int m0 = (r / n_tiles) * kWgBM, n0 = (r % n_tiles) * kWgBN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, kABytes + kBBytes);  // whole boxes, zero fill included
          tma_load_3d(a_smem + stage * kABytes, &x_map, bar, kb * kWgBK, m0, e);
#pragma unroll
          for (int j = 0; j < kWgBN / kBox; ++j) {
            tma_load_3d(b_smem + stage * kBBytes + j * kBoxBytes, &w_map, bar, n0 + j * kBox,
                        kb * kWgBK, e);
          }
          if (++stage == kWgStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups: rows [64 cw, +64) of every tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;  // issues this warpgroup's stores
    const uint32_t out_buf = o_smem + cw * kOutBytes;
    float acc[kWgBN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
      const int e = t / per_expert, r = t % per_expert;
      const int m0 = (r / n_tiles) * kWgBM, n0 = (r % n_tiles) * kWgBN;
      int held = -1;  // the stage the previous k-block's wgmma group still reads
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = a_smem + stage * kABytes + cw * (64 * 128);
        const uint32_t b = b_smem + stage * kBBytes;
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          // A: k-major, 8-row groups 1024 B apart, 16 k = 32 B further per step.
          // B: MN-major, 64-column boxes kBoxBytes apart, 8-row (k) groups
          // 1024 B apart, 16 k = 16 rows = 2048 B further per step.
          wgmma_k16<T>(acc, smem_desc(a + kk * 32, 16, 1024),
                       smem_desc(b + kk * 2048, kBoxBytes, 1024), kb > 0 || kk > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        fence_acc(acc);
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_acc(acc);
        // the previous group is done: its stage may be refilled
        if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);
        held = stage;
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);

      // Epilogue: round to T into this warpgroup's output buffer, laid out as
      // the 128-byte-swizzled 64 x 64 boxes of out_map, then one thread
      // stores the boxes by TMA while the warpgroup goes on to the next tile.
      // Accumulator i of thread (warp, lane) is row 16 warp + lane/4 + 8 (i/2 % 2),
      // column 8 (i/4) + 2 (lane % 4) + i % 2 of the warpgroup's 64 x 256 tile.
      if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");  // the buffer is free
#pragma unroll
      for (int j = 0; j < kWgBN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = warp * 16 + lane / 4 + 8 * h;  // row % 8 == lane / 4
          const uint32_t dst = out_buf + (j / 8) * kBoxBytes + row * 128 +
                               (((j % 8) ^ (lane / 4)) << 4) + (lane % 4) * 4;
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(dst),
                       "r"(pack2<T>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]))
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to TMA
      asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
      if (leader) {
#pragma unroll
        for (int j = 0; j < kWgBN / kBox; ++j) {
          tma_store_3d(&out_map, out_buf + j * kBoxBytes, n0 + j * kBox, m0 + 64 * cw, e);
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
    // the buffer must outlive the last store's reads
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A 3-D map of a contiguous (outer, mid, inner) array of 16-bit values, in
// {64, box_mid, 1} boxes (128 bytes wide) with the 128-byte swizzle; loads
// read zero outside the array and stores write nothing there.
bool encode_3d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, uint64_t inner,
               uint64_t mid, uint64_t outer, uint32_t box_mid) {
  const cuuint64_t dims[3] = {inner, mid, outer};
  const cuuint64_t strides[2] = {inner * 2, inner * mid * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {kBox, box_mid, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return tensor_map_encoder()(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch_wgmma(const void* x, const void* w, void* out, int e, int c, int d, int f,
                         CUtensorMapDataType type, cudaStream_t stream) {
  const int64_t work = static_cast<int64_t>(e) * ((c + kWgBM - 1) / kWgBM) *
                       ((f + kWgBN - 1) / kWgBN);
  if (work > INT_MAX) return cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap x_map, w_map, out_map;
  if (!encode_3d(&x_map, type, x, d, c, e, kWgBM) ||   // boxes of 128 rows x 64 d
      !encode_3d(&w_map, type, w, f, d, e, kWgBK) ||   // boxes of 64 d x 64 f
      !encode_3d(&out_map, type, out, f, c, e, 64)) {  // boxes of 64 rows x 64 f
    return cudaErrorInvalidValue;
  }
  // set on every launch, not once: the attribute belongs to the current
  // device's context, and a process may launch on more than one card
  cudaError_t err = cudaFuncSetAttribute(expert_wgmma<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(work < sms ? work : sms);
  expert_wgmma<T><<<grid, kWgThreads, kWgSmem, stream>>>(x_map, w_map, out_map, e, c, d, f);
  return cudaGetLastError();
}

}  // namespace

// expert_tiles.  in_dtype (x and w) and out_dtype: 0 = float32,
// 1 = bfloat16, 2 = float16.  The output type is x's; x and w share
// in_dtype, which differs from it only when mixed inputs met at float32.
// Returns cudaGetLastError() after the launch (0 on success); the wrapper
// raises on anything else.
extern "C" int repro_moe_gemm(const void* x, const void* w, void* out, int e, int c, int d,
                              int f, int in_dtype, int out_dtype, void* stream) {
  if (e < 0 || c < 0 || d < 0 || f < 0 || e > kMaxGridYZ ||
      (c + kTile - 1) / kTile > kMaxGridYZ || in_dtype < 0 || in_dtype > 2 ||
      out_dtype < 0 || out_dtype > 2 || (in_dtype != out_dtype && in_dtype != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e > 0 && c > 0 && f > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (in_dtype * 3 + out_dtype) {
      case 0:
        launch<float, float>(x, w, out, e, c, d, f, st);
        break;
      case 1:
        launch<float, __nv_bfloat16>(x, w, out, e, c, d, f, st);
        break;
      case 2:
        launch<float, __half>(x, w, out, e, c, d, f, st);
        break;
      case 4:
        launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, e, c, d, f, st);
        break;
      default:
        launch<__half, __half>(x, w, out, e, c, d, f, st);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// expert_wgmma.  in_dtype (x and w) and out_dtype both 1 = bfloat16 or
// both 2 = float16; d > 0, d and f multiples of 8 and x, w, out 16-byte
// aligned: a tensor map's base and strides are multiples of 16 bytes.
// Returns as repro_moe_gemm does.
extern "C" int repro_moe_gemm_wgmma(const void* x, const void* w, void* out, int e, int c,
                                    int d, int f, int in_dtype, int out_dtype, void* stream) {
  if (e < 0 || c < 0 || d <= 0 || f < 0 || d % 8 != 0 || f % 8 != 0 ||
      (in_dtype != 1 && in_dtype != 2) || out_dtype != in_dtype ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0 || c == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      in_dtype == 1 ? launch_wgmma<__nv_bfloat16>(x, w, out, e, c, d, f,
                                                  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st)
                    : launch_wgmma<__half>(x, w, out, e, c, d, f,
                                           CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st));
}
