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
// 3.35 TB/s.  Three routes, picked by the wrapper before launch:
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
//   about three digits; they take the next route.
//
// split3_bf16 then expert_split<TO> (fp32 x and w, and mixed inputs met at
// fp32; d and f multiples of 8): fp32-accurate products on the tensor cores.
//   - split3_bf16 writes each operand as three bf16 pieces, v == v0 + v1 + v2
//     exactly (hopper.cuh's split3), into fresh, aligned arrays: so an fp32
//     view a few bytes off alignment takes this route too.  It reads 4 bytes
//     and writes 6 per value: at the Qwen3-MoE up projection 4.56 GB read and
//     6.84 GB written, about 3.4 ms at 3.35 TB/s, inside the wrapper's time.
//   - expert_split runs the six products x_i w_j with i + j <= 2 per k16
//     step (the pieces' terms down to 2^-16 of x w; the rest are below
//     fp32's rounding), the five small ones into accumulators of their own.
//     x's three pieces go to wgmma from registers (ldmatrix, once each a
//     k16 step): read from shared memory by each product instead, A and B
//     together asked more than the 128 bytes a clock an SM's shared memory
//     gives at the tensor cores' rate, and the GEMM ran at about 55% of the
//     bf16 peak against about 80% from registers (chip_smoke.py, H100 80GB
//     HBM3 at 700 W).  Two pieces with three products would keep only 16
//     significant bits, which fails 1e-4 on long sums of N(0, 1) data; TF32
//     with three products has the same bound (3 at 494.7 against 6 at 989
//     TFLOP/s) but wgmma takes TF32 only with k-major B, which would need w
//     transposed.  The bound is the fp32-accurate peak: 6 bf16 products at
//     989 TFLOP/s, 1.031 TFLOP of fp32 work in 6.25 ms at Qwen3-MoE's width.
//   - Fusing the split into the GEMM's producer (fp32 tiles by TMA, split in
//     shared memory) would save the pass's traffic; it is not done yet.
//
// expert_tiles<T, TO> (fp32 or mixed inputs with d or f off a multiple of 8,
// and 16-bit inputs the tensor maps cannot describe): fp32 FMAs on the CUDA
// cores.  A program owns
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

#include "hopper.cuh"

namespace {

constexpr int kSide = 16;             // threads per side of a program
constexpr int kTile = 128;            // output rows and columns per program
constexpr int kSliceD = 16;           // d per staged slice
constexpr int kHalf = kTile / 2;      // quadrant offset
constexpr int kMaxGridYZ = 65535;

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
          wgmma_k16<T, kWgBN / 2>(acc, smem_desc(a + kk * 32, 16, 1024),
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

// ------------------------------------------------------ split3_bf16, expert_split

constexpr int kSpBN = 128;                   // tile columns: one wgmma m64n128k16 a product
constexpr int kSpStages = 2;                 // what fits: a stage holds six pieces
constexpr int kPieceA = kWgBM * kWgBK * 2;   // one piece of x per stage: 16 KB
constexpr int kPieceB = kWgBK * kSpBN * 2;   // one piece of w per stage, two boxes: 16 KB
constexpr int kSpStageBytes = 3 * (kPieceA + kPieceB);  // 96 KB
constexpr int kSpSmem = kSwizzleAtom + kSpStages * kSpStageBytes + 2 * kSpStages * 8;
static_assert(kSpBN % kBox == 0 && kSpSmem <= 227 * 1024, "split tile does not fit");
constexpr int kSplitThreads = 256;

// dst[k * n + i] = piece k of src[i] (split3), for i < n.  Four values a
// thread per step, 16-byte loads and 8-byte stores, where src is 16-byte
// aligned and n % 4 == 0; one value a step otherwise (an fp32 view that
// starts a few bytes into its buffer).
__global__ void __launch_bounds__(kSplitThreads)
    split3_bf16(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 && n % 4 == 0;
  const int64_t n_vec = vec ? n / 4 : 0;
  for (int64_t i = first; i < n_vec; i += stride) {
    const float4 v = reinterpret_cast<const float4*>(src)[i];
    uint32_t lo[3], hi[3];
    split3x2(v.x, v.y, lo);
    split3x2(v.z, v.w, hi);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      *reinterpret_cast<uint2*>(dst + k * n + 4 * i) = make_uint2(lo[k], hi[k]);
    }
  }
  for (int64_t i = 4 * n_vec + first; i < n; i += stride) {
    split3(src[i], dst[i], dst[n + i], dst[2 * n + i]);
  }
}

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float a, float b) {
  if constexpr (std::is_same<TO, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(p) = pack2<TO>(a, b);
  }
}

// fp32-accurate grouped GEMM on the tensor cores: x = x0 + x1 + x2 and
// w = w0 + w1 + w2 (split3_bf16), and
//     out[e] = sum over i + j <= 2 of x_i[e] @ w_j[e]
// in fp32 accumulators.  The five products with i + j >= 1 are about 2^-8 of
// the sum or smaller; they go first, into accumulators of their own (lo), and
// x0 w0 into hi, so the small terms are summed at their own scale; the two
// are added once, at the tile's end.  The terms left out (i + j >= 3) are
// below 2^-24 of the sum.
// The walk, the ring and the warp roles are expert_wgmma's, with 128 x 128
// tiles: the six pieces of a stage take 96 KB, so two stages fit.  Each
// consumer issues one wgmma group a k16 step, with x's pieces in registers
// (two sets, so a step's ldmatrix never overwrites fragments the running
// group still reads) and w's from the swizzled stage.  x's
// pieces are one (3E, C, d) array and w's one (3E, d, f) array, so piece k
// of expert e is slice k E + e of a 3-D tensor map.  The fp32 (or, for
// mixed inputs, 16-bit) result is written straight from the registers, its
// pairs of columns 8 or 4 bytes at a time, clipped at the C and f edges.
template <typename TO>
__global__ void __launch_bounds__(kWgThreads, 1)
    expert_split(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map, TO* __restrict__ out,
                 int n_experts, int c, int d, int f) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kSwizzleAtom - 1) & ~uint32_t(kSwizzleAtom - 1);
  const uint32_t full = base + kSpStages * kSpStageBytes;  // one mbarrier per stage
  const uint32_t empty = full + kSpStages * 8;
  const int n_tiles = (f + kSpBN - 1) / kSpBN;
  const int per_expert = ((c + kWgBM - 1) / kWgBM) * n_tiles;
  const int n_work = n_experts * per_expert;
  const int k_blocks = (d + kWgBK - 1) / kWgBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSpStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
        const int e = t / per_expert, r = t % per_expert;
        const int m0 = (r / n_tiles) * kWgBM, n0 = (r % n_tiles) * kSpBN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          const uint32_t s = base + stage * kSpStageBytes;
          mbar_expect_tx(bar, kSpStageBytes);  // whole boxes, zero fill included
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            tma_load_3d(s + i * kPieceA, &x_map, bar, kb * kWgBK, m0, i * n_experts + e);
#pragma unroll
            for (int j = 0; j < kSpBN / kBox; ++j) {
              tma_load_3d(s + 3 * kPieceA + i * kPieceB + j * kBoxBytes, &w_map, bar,
                          n0 + j * kBox, kb * kWgBK, i * n_experts + e);
            }
          }
          if (++stage == kSpStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    float hi[kSpBN / 2], lo[kSpBN / 2];
    uint32_t frag[2][3][4];  // x's pieces for two k16 steps: A from registers
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
      const int e = t / per_expert, r = t % per_expert;
      const int m0 = (r / n_tiles) * kWgBM, n0 = (r % n_tiles) * kSpBN;
      int held = -1;
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = base + stage * kSpStageBytes + cw * (64 * 128);
        const uint32_t b = base + stage * kSpStageBytes + 3 * kPieceA;
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          // one group a k16 step; at most the previous one is still running,
          // so the group that read this step's fragment registers is done
          wgmma_wait<1>();
          fence_acc(hi);
          fence_acc(lo);
          fence_regs(reinterpret_cast<uint32_t(&)[24]>(frag));
          // the previous k-block's last group is done: its stage may be refilled
          if (kk == 1 && held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);
          // x's three pieces for this k16 step, into registers once each
          // (16 rows of the warp, k in two 16-byte chunks of the swizzled rows)
          uint32_t(&fa)[3][4] = frag[kk & 1];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            ldmatrix_x4(fa[i], a + i * kPieceA +
                                   swizzle128(16 * warp + lane % 16, 32 * kk + 16 * (lane / 16)));
          }
          uint64_t db[3];  // w's pieces: descriptors as expert_wgmma's, 64-column boxes
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            db[j] = smem_desc(b + j * kPieceB + kk * 2048, kBoxBytes, 1024);
          }
          const int acc = kb > 0 || kk > 0;  // 0: the tile's first products overwrite
          wgmma_fence();
          wgmma_rs_k16_n128_bf16(lo, fa[2], db[0], acc);
          wgmma_rs_k16_n128_bf16(lo, fa[1], db[1], 1);
          wgmma_rs_k16_n128_bf16(lo, fa[0], db[2], 1);
          wgmma_rs_k16_n128_bf16(lo, fa[1], db[0], 1);
          wgmma_rs_k16_n128_bf16(lo, fa[0], db[1], 1);
          wgmma_rs_k16_n128_bf16(hi, fa[0], db[0], acc);
          wgmma_commit();
          fence_regs(reinterpret_cast<uint32_t(&)[24]>(frag));  // live until their group ends
        }
        fence_acc(hi);
        fence_acc(lo);
        held = stage;
        if (++stage == kSpStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(hi);
      fence_acc(lo);
      if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);
      // epilogue: hi + lo rounded once to TO, straight to global memory
      TO* oe = out + static_cast<int64_t>(e) * c * f;
      const int row0 = m0 + 64 * cw + 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < kSpBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);  // f % 8 == 0: col < f means col + 1 < f
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row < c && col < f) {
            const int i = 4 * j + 2 * h;
            store2<TO>(oe + static_cast<int64_t>(row) * f + col, hi[i] + lo[i],
                       hi[i + 1] + lo[i + 1]);
          }
        }
      }
    }
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

// The current device's SM count: a persistent kernel's grid.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
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
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(work < sms ? work : sms);
  expert_wgmma<T><<<grid, kWgThreads, kWgSmem, stream>>>(x_map, w_map, out_map, e, c, d, f);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_split(const void* xp, const void* wp, void* out, int e, int c, int d, int f,
                         cudaStream_t stream) {
  const int64_t work = static_cast<int64_t>(e) * ((c + kWgBM - 1) / kWgBM) *
                       ((f + kSpBN - 1) / kSpBN);
  if (work > INT_MAX || 3ll * e > INT_MAX) return cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap x_map, w_map;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_3d(&x_map, bf16, xp, d, c, 3ull * e, kWgBM) ||  // boxes of 128 rows x 64 d
      !encode_3d(&w_map, bf16, wp, f, d, 3ull * e, kWgBK)) {  // boxes of 64 d x 64 f
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(expert_split<TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSpSmem);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(work < sms ? work : sms);
  expert_split<TO><<<grid, kWgThreads, kSpSmem, stream>>>(x_map, w_map, static_cast<TO*>(out),
                                                          e, c, d, f);
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


// split3_bf16.  src: n float32 values; dst: 3 n bfloat16, the three pieces
// one after another (dst 16-byte aligned).  Returns as repro_moe_gemm does.
extern "C" int repro_split3_bf16(const void* src, void* dst, long long n, void* stream) {
  if (n < 0 || reinterpret_cast<uintptr_t>(dst) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const long long blocks = (n / 4 + kSplitThreads - 1) / kSplitThreads + 1;
    const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);  // then grid-stride
    split3_bf16<<<grid, kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<__nv_bfloat16*>(dst), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// expert_split.  xp: x's pieces, (3, E, C, d) bfloat16; wp: w's pieces,
// (3, E, d, f) bfloat16; out: (E, C, f) in out_dtype (0 = float32,
// 1 = bfloat16, 2 = float16).  d > 0, d and f multiples of 8, all three
// 16-byte aligned.  Returns as repro_moe_gemm does.
extern "C" int repro_moe_gemm_split(const void* xp, const void* wp, void* out, int e, int c,
                                    int d, int f, int out_dtype, void* stream) {
  if (e < 0 || c < 0 || d <= 0 || f < 0 || d % 8 != 0 || f % 8 != 0 || out_dtype < 0 ||
      out_dtype > 2 || reinterpret_cast<uintptr_t>(xp) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0 || c == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return static_cast<int>(launch_split<float>(xp, wp, out, e, c, d, f, st));
    case 1:
      return static_cast<int>(launch_split<__nv_bfloat16>(xp, wp, out, e, c, d, f, st));
    default:
      return static_cast<int>(launch_split<__half>(xp, wp, out, e, c, d, f, st));
  }
}
