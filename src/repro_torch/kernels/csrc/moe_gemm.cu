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
// 3.35 TB/s.  Two routes, picked by the wrapper before launch, and a stage
// in front of the first for inputs its tensor maps cannot describe:
//
// expert_wgmma<T> (x and w both bf16 or both fp16): the
// tensor-core kernel the bound asks for.
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
// fp32; any d and f): fp32-accurate products on the tensor cores.
//   - split3_bf16 writes each operand as three bf16 pieces, v == v0 + v1 + v2
//     exactly (hopper.cuh's split3), into fresh, aligned arrays whose rows
//     are padded to a multiple of 8 values with zeros (which split into
//     zeros): so an fp32 view a few bytes off alignment, and d or f off 8,
//     take this route too.  It reads 4 bytes
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
// stage16 (16-bit inputs a tensor map cannot describe: a base off 16 bytes,
// x with d off a multiple of 8, w with f off one): a tensor map's base and
// row pitch are multiples of 16 bytes, so the offending operand is copied
// once into a fresh buffer with an aligned base and a pitch of a multiple of
// 8 values, its tail zeroed, and expert_wgmma reads it through a map that
// keeps the true d and f (TMA zero-fills past them).  With f off 8 the
// output goes to such a pitched buffer too, and stage16 copies its f
// columns out.  A copy is bound by bytes, each value read and written once:
// at the Qwen3-MoE up projection with x 2 bytes off, 2 x 671 MB, 0.40 ms at
// 3.35 TB/s beside expert_wgmma's 1.04 ms bound.  A view off alignment
// whose rows stay whole is one flat copy, 16 bytes a thread: each thread
// reads the two aligned 16-byte chunks its 16 bytes straddle and
// funnel-shifts them into place.  Padded or cropped rows go 8 values a
// thread.  On an H100 80GB HBM3 at 700 W (chip_smoke.py) the copy takes
// 0.47 ms and the staged call 1.87 ms, against torch.bmm's 7.41 on the same
// view; expert_tiles, the fp32 FMAs on the CUDA cores these inputs took
// before, took 32.6 ms.
//
// The gradient (kernels/moe_gemm.py:GroupedGemm; the TPU kernel,
// repro/kernels/moe_gemm.py:moe_gemm (:44), has none: the reference trains
// its MoE through jnp.einsum, so these are held to jax.grad of that einsum
// and to the plain version) is two more grouped products a forward one:
//     dx[e] = dy[e] @ w[e]^T   (E, C, f) x (E, f, d) -> (E, C, d)
//     dw[e] = x[e]^T @ dy[e]   (E, d, C) x (E, C, f) -> (E, d, f)
// each a kernel of its own, designed for the shapes the training path
// gives it and reading every operand as stored (no transposed copy).  What
// bounds both: bytes.  At the training path's C = 320 (4 x 1024 tokens,
// top-8, capacity 1.25) and Qwen3-MoE's width each reads or writes the whole
// expert weight, 1.61 GB of 2.07 GB a product: 0.62 ms at 3.35 TB/s,
// against 0.52 ms of bf16 operations at 989 TFLOP/s.  So the tensor cores
// must stay busy about 85% of the time for the bytes to set the pace.
//
// expert_wgmma_dx<T>: computes dx^T[e] = w[e] @ dy[e]^T, m = d, k = f,
// n = C, and writes it transposed.  Run as dy @ w^T (m = C), a 128-row tile
// leaves, at C = 320, a third row tile whose second warpgroup multiplies 64
// zero rows through every k-block (20% more tensor-core work than needed),
// and three row tiles read each slice of w.  With m = d the rows are 32
// whole 128-row tiles; the columns are C in tiles of 160 (one wgmma
// m64n160k16 a k16 step, 80 accumulators a thread; a tile of all 320 would
// take 160, and the 168 registers ptxas grants a thread of a 384-thread
// block spilled them).  The two column tiles of a row
// tile run side by side, so w, the 1.61 GB operand, comes from device memory
// once and dy[e] (0.98 MB) from L2.  w is wgmma's k-major A (f contiguous)
// and dy its k-major B, both by TMA as for the forward; a stage is 128 x 64
// of w and 160 x 64 of dy (36 KB), five in the ring.  The epilogue writes
// each warpgroup's 64 d x 160 C block into dx's (E, C, d) layout through
// shared memory: stmatrix .trans turns each 8 x 8 accumulator block over,
// into 32-row chunks laid out as the output tensor map's 128-byte-swizzled
// boxes, two a warpgroup in turn, each stored by TMA while the next is
// written.  Ragged C and d arrive zero-filled and are clipped at the store.
//
// expert_wgmma_dw<T>: m = d, k = C, n = f, x read MN-major (imm-trans-a)
// and dy MN-major, as stored.  Its k is short (five 64-deep k-blocks at
// C = 320) and its output the size of the weights, so a 128 x 256 tile shared
// by both warpgroups would spend much of its time in an epilogue during which
// no wgmma runs, and read 240 KB of operands from L2 for each 64 KB it writes.
// Instead:
//   - dy's k-blocks for a 192-column block of f stay resident in shared
//     memory (5 x 24 KB at C = 320) while the block's 64-row tiles of d
//     stream past them, so a tile reads only its 40 KB of x from L2;
//   - each consumer warpgroup owns a 64 x 192 tile (wgmma m64n192k16, 96
//     accumulators a thread) with its own ring of x (5 x 8 KB: a whole
//     tile) and its own producer thread, so one's epilogue runs beside the
//     other's products rather than stopping the tensor cores; each warp
//     stores its own 16 rows (stmatrix into a swizzled box, a TMA store of
//     16 x 64), with no barrier across the warpgroup;
//   - what holds it back at C = 320: x.  With 120 KB of dy resident, a
//     consumer's ring holds one tile, so each tile's x loads wait out the
//     memory's latency (without its stores the kernel takes nearly as long,
//     and without its products too; one warpgroup alone runs m64n192k16
//     at the tensor cores' peak);
//   - each block takes (expert, f block) runs block-cyclically, then an
//     equal share of the pairs left, so the blocks finish together and the
//     blocks at work side by side read the same experts' x (from device
//     memory once, then from L2); a block reloads dy where its run changes,
//     each slot as soon as both consumers have done with it.
// Where C exceeds 320 the dy slots become a ring that both warpgroups read
// pair by pair.
// fp32 and mixed gradients take split3_bf16 (dy) and split3_bf16_t (w for
// dx, x for dw: the pieces written transposed, through a 32 x 32 tile in
// shared memory) and then expert_split unchanged.
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

// out[e] = A[e] @ B[e], (m, k) x (k, n) -> (m, n) for every expert e: A = x
// (E, C, d) k-major, B = w (E, d, f) MN-major; m = C, k = d, n = f.
// Block b walks tiles t = b, b + gridDim.x, ... of the n_experts x
// ceil(m/128) x ceil(n/256) grid, expert-major, then row tile, then column
// tile.
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    expert_wgmma(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const __grid_constant__ CUtensorMap out_map, int n_experts, int m, int k,
                 int n) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kSwizzleAtom - 1) & ~uint32_t(kSwizzleAtom - 1);
  const uint32_t a_smem = base;                          // stages of A: 128 rows x 128 bytes
  const uint32_t b_smem = a_smem + kWgStages * kABytes;  // stages of B: 4 boxes of 64 x 128 B
  const uint32_t o_smem = b_smem + kWgStages * kBBytes;  // per consumer: 4 boxes of 64 x 128 B
  const uint32_t full = o_smem + 2 * kOutBytes;          // one mbarrier per stage
  const uint32_t empty = full + kWgStages * 8;
  const int n_tiles = (n + kWgBN - 1) / kWgBN;
  const int per_expert = ((m + kWgBM - 1) / kWgBM) * n_tiles;
  const int n_work = n_experts * per_expert;
  const int k_blocks = (k + kWgBK - 1) / kWgBK;
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
          const uint32_t a_st = a_smem + stage * kABytes, b_st = b_smem + stage * kBBytes;
          tma_load_3d(a_st, &a_map, bar, kb * kWgBK, m0, e);  // one 64 k x 128 m box
#pragma unroll
          for (int j = 0; j < kWgBN / kBox; ++j) {  // four 64 n x 64 k boxes, n contiguous
            tma_load_3d(b_st + j * kBoxBytes, &b_map, bar, n0 + j * kBox, kb * kWgBK, e);
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
        // this warpgroup's 64 rows: 8 KB on
        const uint32_t a = a_smem + stage * kABytes + cw * kBoxBytes;
        const uint32_t b = b_smem + stage * kBBytes;
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          // A k-major: rows of 128 B (64 k), 8-row groups 1024 B apart, 16 k =
          // 32 B further per step.  B MN-major: 64-column boxes kBoxBytes
          // apart, 8-row (k) groups 1024 B apart, 16 k = 16 rows = 2048 B
          // further per step.
          const uint64_t da = smem_desc(a + kk * 32, 16, 1024);
          const uint64_t db = smem_desc(b + kk * 2048, kBoxBytes, 1024);
          wgmma_k16<T, kWgBN / 2>(acc, da, db, kb > 0 || kk > 0);
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

// ------------------------------------------------------------- expert_wgmma_dx

constexpr int kDxBN = 160;       // C columns a tile: one wgmma m64n160k16
constexpr int kDxStages = 5;     // what fits beside the output chunks
constexpr int kDxOutBufs = 2;    // output chunks, per consumer
constexpr int kDxChunk = 32;     // C rows an output store: 32 x 64 d, 4 KB
constexpr int kDxChunkBytes = kDxChunk * 128;

constexpr int kDxStage = kABytes + kDxBN * 128;  // 128 d x 64 f of w, 160 C x 64 f of dy
constexpr int kDxSmem =
    kSwizzleAtom + kDxStages * kDxStage + 2 * kDxOutBufs * kDxChunkBytes + 2 * kDxStages * 8;
static_assert(kDxStage % kSwizzleAtom == 0 && kDxBN % kDxChunk == 0 &&
                  kDxSmem <= 227 * 1024,
              "dx tile does not fit");

// The gradient of the TPU kernel repro/kernels/moe_gemm.py:moe_gemm (:44),
// which has none of its own (held to jax.grad of the reference's einsum).
// Bound at the training path's C = 320: bytes, 0.619 ms, against 0.521 ms of
// bf16 operations; what the design does about it is in the note at the top.
// dx[e] = dy[e] @ w[e]^T, computed as dx^T[e] = w[e] @ dy[e]^T: m = d (tiles
// of 128 rows, 64 a consumer warpgroup), k = f, n = C (tiles of 160
// columns, one wgmma).  Block b walks tiles t = b, b + gridDim.x, ... of
// the n_experts x ceil(d/128) x ceil(C/160) grid, expert-major, then row
// tile, then column tile: the column tiles of one row tile run side by side
// and read its w once from device memory.  A = w (E, d, f) and B = dy
// (E, C, f) are both k-major, as stored; the result goes out transposed
// (stmatrix .trans), as dx (E, C, d).
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    expert_wgmma_dx(const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap dy_map,
                    const __grid_constant__ CUtensorMap dx_map, int n_experts, int c, int d,
                    int f) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kSwizzleAtom - 1) & ~uint32_t(kSwizzleAtom - 1);
  const uint32_t o_smem = base + kDxStages * kDxStage;  // per consumer: its 4 KB chunks
  const uint32_t full = o_smem + 2 * kDxOutBufs * kDxChunkBytes;  // one mbarrier per stage
  const uint32_t empty = full + kDxStages * 8;
  const int c_tiles = (c + kDxBN - 1) / kDxBN;
  const int per_expert = ((d + kWgBM - 1) / kWgBM) * c_tiles;
  const int n_work = n_experts * per_expert;
  const int k_blocks = (f + kWgBK - 1) / kWgBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDxStages; ++s) {
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
        const int m0 = (r / c_tiles) * kWgBM, n0 = (r % c_tiles) * kDxBN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, kDxStage);  // whole boxes, zero fill included
          const uint32_t st = base + stage * kDxStage;
          tma_load_3d(st, &w_map, bar, kb * kWgBK, m0, e);             // 128 d x 64 f
          tma_load_3d(st + kABytes, &dy_map, bar, kb * kWgBK, n0, e);  // kDxBN C x 64 f
          if (++stage == kDxStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups: d rows [64 cw, +64) of every tile, all its C columns
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;  // issues this warpgroup's stores
    const uint32_t out_buf = o_smem + cw * kDxOutBufs * kDxChunkBytes;
    float acc[kDxBN / 2];
    int stage = 0, chunks = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
      const int e = t / per_expert, r = t % per_expert;
      const int m0 = (r / c_tiles) * kWgBM, n0 = (r % c_tiles) * kDxBN;
      int held = -1;  // the stage the previous k-block's wgmma group still reads
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = base + stage * kDxStage + cw * kBoxBytes;  // this warpgroup's 64 d
        const uint32_t b = base + stage * kDxStage + kABytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          // both k-major: rows of 128 B (64 f), 8-row groups 1024 B apart,
          // 16 f = 32 B further per step
          const uint64_t da = smem_desc(a + kk * 32, 16, 1024);
          const uint64_t db = smem_desc(b + kk * 32, 16, 1024);
          wgmma_k16<T, kDxBN / 2, 0, 0>(acc, da, db, kb > 0 || kk > 0);
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();
        fence_acc(acc);
        // the previous group is done: its stage may be refilled
        if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);
        held = stage;
        if (++stage == kDxStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);

      // Epilogue, 32 C columns at a time: round to T and turn each 8 x 8 block
      // over (stmatrix .trans) into a chunk laid out as a 128-byte-swizzled
      // box of dx_map (32 C rows of 64 d), then one thread stores it by TMA
      // while the warpgroup fills its other chunk.  Accumulator 4 j + 2 h + i
      // of thread (warp, lane) is d row 16 warp + lane/4 + 8 h, C column
      // 8 j + 2 (lane % 4) + i of the warpgroup's 64 x kDxBN block.
#pragma unroll
      for (int q = 0; q < kDxBN / kDxChunk; ++q) {
        const uint32_t buf = out_buf + (chunks % kDxOutBufs) * kDxChunkBytes;
        // the store that last read this chunk is done reading it
        if (leader) asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kDxOutBufs - 1) : "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
#pragma unroll
        for (int p = 0; p < kDxChunk / 16; ++p) {
          const int j = q * (kDxChunk / 8) + 2 * p;  // column blocks j and j + 1
          const uint32_t r[4] = {pack2<T>(acc[4 * j], acc[4 * j + 1]),
                                 pack2<T>(acc[4 * j + 2], acc[4 * j + 3]),
                                 pack2<T>(acc[4 * j + 4], acc[4 * j + 5]),
                                 pack2<T>(acc[4 * j + 6], acc[4 * j + 7])};
          // matrix lane / 8: d rows 8 (its parity) on, C columns 8 (its half) on
          const int m = lane / 8;
          const int row = 16 * p + 8 * (m >> 1) + lane % 8;  // C, in the chunk
          const int col16 = 2 * warp + (m & 1);               // d, in 16-byte units
          stmatrix_x4_trans(buf + row * 128 + ((col16 ^ (lane % 8)) << 4), r);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to TMA
        asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
        if (leader) {
          tma_store_3d(&dx_map, buf, m0 + 64 * cw, n0 + q * kDxChunk, e);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
        ++chunks;
      }
    }
    // the chunks must outlive the last stores' reads
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// ------------------------------------------------------------- expert_wgmma_dw

constexpr int kDwBN = 192;       // f columns a tile: one wgmma m64n192k16
constexpr int kDwBM = 64;        // d rows a tile: one consumer warpgroup's
constexpr int kDwSlots = 5;      // dy k-blocks held: all of C up to 320
constexpr int kDwAStages = 5;    // x's ring of 64 x 64 boxes, per consumer: a tile at C = 320
constexpr int kDwSlotBytes = kWgBK * kDwBN * 2;  // 64 C x 192 f: three 64 x 64 boxes
constexpr int kDwBarriers = 2 * kDwSlots + 4 * kDwAStages;
constexpr int kDwSmem = kSwizzleAtom + kDwSlots * kDwSlotBytes + 2 * kDwAStages * kBoxBytes +
                        2 * kBoxBytes + kDwBarriers * 8;
static_assert(kDwBN % kBox == 0 && kDwSmem <= 227 * 1024, "dw tiles do not fit");

// The other gradient of repro/kernels/moe_gemm.py:moe_gemm (:44), held like
// dx; bound at C = 320: bytes, 0.619 ms (1.61 GB of them its output), against
// 0.521 ms of bf16 operations; the design is in the note at the top.
// dw[e] = x[e]^T @ dy[e]: m = d, k = C, n = f; A = x (E, C, d) MN-major and
// B = dy (E, C, f) MN-major, as stored.  The work is a list of (expert, f
// block of 192, pair of 64-row d tiles), in that order, in runs of one
// (expert, f block) each.  Block b of G takes runs b, b + G, ... while every
// block has one, then an equal share of the pairs of the runs left: the
// blocks finish together, and the blocks running side by side work on the
// f blocks of the same few experts, so each x[e] tile is read from device
// memory once and from L2 by the others.  Consumer cw computes tile 2 p + cw
// of each pair p.  Where C <= 320 (resident) dy's k-blocks for a run are
// loaded once into the slots, else both consumers read every pair's
// k-blocks through the slots as a ring.  Producer warp 0 loads dy, warps 1
// and 2 each one consumer's x.
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    expert_wgmma_dw(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap dy_map,
                    const __grid_constant__ CUtensorMap dw_map, int n_experts, int c, int d,
                    int f) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kSwizzleAtom - 1) & ~uint32_t(kSwizzleAtom - 1);
  const uint32_t b_smem = base;                                // dy's slots
  const uint32_t a_smem = b_smem + kDwSlots * kDwSlotBytes;    // x's rings, one a consumer
  const uint32_t o_smem = a_smem + 2 * kDwAStages * kBoxBytes;  // an output box a consumer
  const uint32_t b_full = o_smem + 2 * kBoxBytes;
  const uint32_t b_empty = b_full + kDwSlots * 8;
  const uint32_t a_full = b_empty + kDwSlots * 8;  // [consumer][stage]
  const uint32_t a_empty = a_full + 2 * kDwAStages * 8;
  const int n_blocks = (f + kDwBN - 1) / kDwBN;
  const int pairs = (d + 2 * kDwBM - 1) / (2 * kDwBM);
  const int last_row = ((d - 1) / kDwBM) * kDwBM;  // an odd last tile recomputes the one before
  const int k_blocks = (c + kWgBK - 1) / kWgBK;
  const bool resident = k_blocks <= kDwSlots;
  // this block's ranges of the pair list: whole runs, then a share of the rest
  const int64_t runs = static_cast<int64_t>(n_experts) * n_blocks;
  const int64_t rounds = runs / gridDim.x;
  const int64_t rest = (runs - rounds * gridDim.x) * pairs;
  auto range = [&](int64_t i, int64_t& lo, int64_t& hi) {
    if (i < rounds) {
      lo = (blockIdx.x + i * gridDim.x) * pairs;
      hi = lo + pairs;
    } else {
      const int64_t first = rounds * gridDim.x * pairs;
      lo = first + rest * blockIdx.x / gridDim.x;
      hi = first + rest * (blockIdx.x + 1) / gridDim.x;
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwSlots; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, kConsumerWarps);
    }
    for (int s = 0; s < 2 * kDwAStages; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, kConsumerWarps / 2);  // one consumer's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0 && warp == 0) {
      // dy: each run's k-blocks once (resident), or each pair's
      int stage = 0;
      uint32_t phase = 0;
      int64_t held = -1, lo, hi;
      for (int64_t i = 0; i <= rounds; ++i) {
        for (range(i, lo, hi); lo < hi; ++lo) {
          const int64_t blk = lo / pairs;
          if (resident && blk == held) continue;
          held = blk;
          const int e = static_cast<int>(blk / n_blocks);
          const int n0 = static_cast<int>(blk % n_blocks) * kDwBN;
          for (int kb = 0; kb < k_blocks; ++kb) {
            mbar_wait(b_empty + 8 * stage, phase ^ 1);
            const uint32_t bar = b_full + 8 * stage;
            mbar_expect_tx(bar, kDwSlotBytes);  // whole boxes, zero fill included
#pragma unroll
            for (int j = 0; j < kDwBN / kBox; ++j) {  // 64 f x 64 C boxes, f contiguous
              tma_load_3d(b_smem + stage * kDwSlotBytes + j * kBoxBytes, &dy_map, bar,
                          n0 + j * kBox, kb * kWgBK, e);
            }
            if (++stage == kDwSlots) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else if (threadIdx.x % 32 == 0 && warp <= 2) {
      // x: the d tiles of consumer warp - 1
      const int cw = warp - 1;
      int stage = 0;
      uint32_t phase = 0;
      int64_t lo, hi;
      for (int64_t i = 0; i <= rounds; ++i) {
        for (range(i, lo, hi); lo < hi; ++lo) {
          const int e = static_cast<int>(lo / pairs / n_blocks);
          const int m0 = min(static_cast<int>(2 * (lo % pairs) + cw) * kDwBM, last_row);
          for (int kb = 0; kb < k_blocks; ++kb) {
            const uint32_t s = cw * kDwAStages + stage;
            mbar_wait(a_empty + 8 * s, phase ^ 1);
            mbar_expect_tx(a_full + 8 * s, kBoxBytes);
            tma_load_3d(a_smem + s * kBoxBytes, &x_map, a_full + 8 * s, m0, kb * kWgBK, e);
            if (++stage == kDwAStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    // this warp's 16 rows (2 KB) of its consumer's output box
    const uint32_t rows = o_smem + cw * kBoxBytes + warp * 16 * 128;
    float acc[kDwBN / 2];
    int a_stage = 0, b_stage = 0;
    uint32_t a_phase = 0, b_phase = 0;
    int64_t held_blk = -1, lo, hi;
    for (int64_t i = 0; i <= rounds; ++i) {
      for (range(i, lo, hi); lo < hi; ++lo) {
        const int64_t blk = lo / pairs;
        const int e = static_cast<int>(blk / n_blocks);
        const int n0 = static_cast<int>(blk % n_blocks) * kDwBN;
        const int m0 = min(static_cast<int>(2 * (lo % pairs) + cw) * kDwBM, last_row);
        if (resident && blk != held_blk) {
          if (held_blk >= 0) {  // the last run's k-blocks are behind us
            for (int kb = 0; kb < k_blocks; ++kb) {
              if (++b_stage == kDwSlots) {
                b_stage = 0;
                b_phase ^= 1;
              }
            }
          }
          held_blk = blk;
        }
        // free dy's slots as they are done with: every pair's where they are a
        // ring, the run's last pair's where they are resident
        const bool free_b = !resident || lo + 1 == hi || (lo + 1) / pairs != blk;
        int bs = b_stage;
        uint32_t bp = b_phase;
        int a_held = -1, b_held = -1;
        for (int kb = 0; kb < k_blocks; ++kb) {
          const uint32_t as = cw * kDwAStages + a_stage;
          mbar_wait(b_full + 8 * bs, bp);
          mbar_wait(a_full + 8 * as, a_phase);
          const uint32_t a = a_smem + as * kBoxBytes, b = b_smem + bs * kDwSlotBytes;
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kWgBK / 16; ++kk) {
            // both MN-major: 64-column (d or f) boxes kBoxBytes apart, 8-row (C)
            // groups 1024 B apart, 16 C = 16 rows = 2048 B further per step
            const uint64_t da = smem_desc(a + kk * 2048, kBoxBytes, 1024);
            const uint64_t db = smem_desc(b + kk * 2048, kBoxBytes, 1024);
            wgmma_k16<T, kDwBN / 2, 1, 1>(acc, da, db, kb > 0 || kk > 0);
          }
          wgmma_commit();
          fence_acc(acc);
          wgmma_wait<1>();
          fence_acc(acc);
          if (lane == 0) {
            if (a_held >= 0) mbar_arrive(a_empty + 8 * a_held);
            if (free_b && b_held >= 0) mbar_arrive(b_empty + 8 * b_held);
          }
          a_held = static_cast<int>(as);
          b_held = bs;
          if (++a_stage == kDwAStages) {
            a_stage = 0;
            a_phase ^= 1;
          }
          if (++bs == kDwSlots) {
            bs = 0;
            bp ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) {
          mbar_arrive(a_empty + 8 * a_held);
          if (free_b) mbar_arrive(b_empty + 8 * b_held);
        }
        if (!resident) {  // the next pair's k-blocks follow this one's
          b_stage = bs;
          b_phase = bp;
        }

        // Epilogue, 64 f columns at a time, each warp on its own 16 rows: round
        // to T into its quarter of a 128-byte-swizzled 64 x 64 box (stmatrix:
        // each lane's pair of columns is one 32-bit word of an 8 x 8 block),
        // and its lane 0 stores the quarter by TMA (dw_map's boxes are 16 rows
        // of 64) while the other consumer's products run: no barrier across
        // the warpgroup.  Accumulator 4 j + 2 h + i of thread (warp, lane) is
        // row 16 warp + lane/4 + 8 h, column 8 j + 2 (lane % 4) + i.
#pragma unroll
        for (int q = 0; q < kDwBN / kBox; ++q) {
          // the store that last read these rows is done reading them
          if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
          __syncwarp();
#pragma unroll
          for (int p = 0; p < kBox / 16; ++p) {
            const int j = q * (kBox / 8) + 2 * p;  // column blocks j and j + 1
            const uint32_t r[4] = {pack2<T>(acc[4 * j], acc[4 * j + 1]),
                                   pack2<T>(acc[4 * j + 2], acc[4 * j + 3]),
                                   pack2<T>(acc[4 * j + 4], acc[4 * j + 5]),
                                   pack2<T>(acc[4 * j + 6], acc[4 * j + 7])};
            const int m = lane / 8;
            const int row = 8 * (m & 1) + lane % 8;  // d, in the warp's 16 rows
            const int col16 = 2 * p + (m >> 1);      // f, in 16-byte units
            stmatrix_x4(rows + row * 128 + ((col16 ^ (lane % 8)) << 4), r);
          }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
          if (lane == 0) {
            tma_store_3d(&dw_map, rows, n0 + q * kBox, m0 + 16 * warp, e);
            asm volatile("cp.async.bulk.commit_group;" ::: "memory");
          }
        }
      }
    }
    if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
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

// src holds rows x cols values; dst three pieces of rows x pitch, one after
// another: dst[k n + r pitch + c] = piece k of src[r cols + c] (split3) for
// c < cols, and 0 for cols <= c < pitch, with n = rows pitch.  Unpadded
// (pitch == cols): four values a thread per step, 16-byte loads and 8-byte
// stores, where src is 16-byte aligned and n % 4 == 0, else one value a
// step (an fp32 view that starts a few bytes into its buffer).  Padded: one
// value a step.
__global__ void __launch_bounds__(kSplitThreads)
    split3_bf16(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst, int64_t rows,
                int cols, int pitch) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n = rows * pitch;
  if (cols != pitch) {
    for (int64_t i = first; i < n; i += stride) {
      const int c = static_cast<int>(i % pitch);
      const float v = c < cols ? src[(i / pitch) * cols + c] : 0.f;
      split3(v, dst[i], dst[n + i], dst[2 * n + i]);
    }
    return;
  }
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

// src holds batch x rows x cols values; dst three pieces of batch x cols x
// pitch, one after another: dst[k n + (b cols + c) pitch + r] = piece k of
// src[(b rows + r) cols + c] (split3) for r < rows, and 0 for rows <= r <
// pitch, with n = batch cols pitch.  split3_bf16 with the last two axes
// swapped on the way: the fp32 gradient products' operand that wgmma would
// read transposed (w for dx = dy w^T, x for dw = x^T dy) is written as
// pieces in the layout expert_split reads, so expert_split runs unchanged.
// Bound by bytes, like split3_bf16 (4 read and 6 written a value): each
// block moves a 32 x 32 tile through shared memory (padded a column
// against bank conflicts), so both the reads and the writes run along
// contiguous rows.
__global__ void __launch_bounds__(kSplitThreads)
    split3_bf16_t(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst, int rows,
                  int cols, int pitch) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32, b = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;  // 8 rows of 32 threads
  const float* s = src + static_cast<int64_t>(b) * rows * cols;
#pragma unroll
  for (int i = ty; i < 32; i += kSplitThreads / 32) {
    const int r = r0 + i, c = c0 + tx;
    tile[i][tx] = r < rows && c < cols ? s[static_cast<int64_t>(r) * cols + c] : 0.f;
  }
  __syncthreads();
  const int64_t n = static_cast<int64_t>(gridDim.z) * cols * pitch;
#pragma unroll
  for (int i = ty; i < 32; i += kSplitThreads / 32) {
    const int c = c0 + i, r = r0 + tx;
    if (c < cols && r < pitch) {
      const int64_t o = (static_cast<int64_t>(b) * cols + c) * pitch + r;
      split3(tile[tx][i], dst[o], dst[n + o], dst[2 * n + o]);
    }
  }
}

// ------------------------------------------------------------------ stage16

constexpr int kStageThreads = 256;

// dst[i] = src[i], i < n, 16-bit values: 8 a thread per step, src SHIFT
// bytes past 16-byte alignment and dst aligned.  Each thread reads the two
// aligned 16-byte chunks its source bytes straddle and funnel-shifts them
// into one 16-byte store.  (The second chunk's unused bytes may lie past
// the tensor's last value, never past its 16-byte granule.)
template <int SHIFT>
__device__ __forceinline__ void copy_flat(const uint16_t* __restrict__ src,
                                          uint16_t* __restrict__ dst, int64_t n) {
  const uint4* chunk =
      reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(src) - SHIFT);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n8 = n / 8;
  for (int64_t j = first; j < n8; j += stride) {
    uint4 v = chunk[j];
    if constexpr (SHIFT != 0) {
      const uint4 next = chunk[j + 1];
      const uint32_t w[8] = {v.x, v.y, v.z, v.w, next.x, next.y, next.z, next.w};
      constexpr int q = SHIFT / 4, bits = (SHIFT % 4) * 8;
      v = make_uint4(__funnelshift_r(w[q], w[q + 1], bits),
                     __funnelshift_r(w[q + 1], w[q + 2], bits),
                     __funnelshift_r(w[q + 2], w[q + 3], bits),
                     __funnelshift_r(w[q + 3], w[q + 4], bits));
    }
    reinterpret_cast<uint4*>(dst)[j] = v;
  }
  for (int64_t i = 8 * n8 + first; i < n; i += stride) dst[i] = src[i];
}

// dst[r dst_pitch + c] = src[r src_pitch + c] for c < min(src_pitch,
// dst_pitch), 0 for the rest of each dst row: 16-bit values.  Rows of the
// same pitch are one flat copy (copy_flat, where dst is 16-byte aligned);
// otherwise a thread writes 8 consecutive values of a dst row, as one
// 16-byte store where dst and dst_pitch allow.
__global__ void __launch_bounds__(kStageThreads)
    stage16(const uint16_t* __restrict__ src, uint16_t* __restrict__ dst, int64_t rows,
            int src_pitch, int dst_pitch) {
  if (src_pitch == dst_pitch && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    const int64_t n = rows * src_pitch;
    switch (reinterpret_cast<uintptr_t>(src) % 16) {  // even: 16-bit values
      case 0: copy_flat<0>(src, dst, n); break;
      case 2: copy_flat<2>(src, dst, n); break;
      case 4: copy_flat<4>(src, dst, n); break;
      case 6: copy_flat<6>(src, dst, n); break;
      case 8: copy_flat<8>(src, dst, n); break;
      case 10: copy_flat<10>(src, dst, n); break;
      case 12: copy_flat<12>(src, dst, n); break;
      default: copy_flat<14>(src, dst, n); break;
    }
    return;
  }
  const int cols = src_pitch < dst_pitch ? src_pitch : dst_pitch;
  const int per_row = (dst_pitch + 7) / 8;
  const bool vec = reinterpret_cast<uintptr_t>(dst) % 16 == 0 && dst_pitch % 8 == 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < rows * per_row; q += stride) {
    const int64_t r = q / per_row;
    const int c0 = static_cast<int>(q % per_row) * 8;
    const uint16_t* s = src + r * src_pitch + c0;
    uint16_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = c0 + e < cols ? s[e] : uint16_t(0);
    uint16_t* d = dst + r * dst_pitch + c0;
    if (vec) {
      *reinterpret_cast<uint4*>(d) =
          make_uint4(v[0] | uint32_t(v[1]) << 16, v[2] | uint32_t(v[3]) << 16,
                     v[4] | uint32_t(v[5]) << 16, v[6] | uint32_t(v[7]) << 16);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (c0 + e < dst_pitch) d[e] = v[e];
      }
    }
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
// group still reads) and w's from the swizzled stage.  x's pieces are one
// (3E, C, d) array and w's one (3E, d, f) array (rows padded to a multiple
// of 8 values), so piece k of expert e is slice k E + e of a 3-D tensor map.
// The fp32 (or, for mixed inputs, 16-bit) result is written straight from
// the registers, its pairs of columns 8 or 4 bytes at a time where f is
// even, one value at a time where it is odd, clipped at the C and f edges.
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
        const int col = n0 + 8 * j + 2 * (lane % 4);  // even
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row < c && col < f) {
            const int i = 4 * j + 2 * h;
            TO* p = oe + static_cast<int64_t>(row) * f + col;
            if (f % 2 == 0) {  // col + 1 < f, and p is 8 (or 4) bytes aligned
              store2<TO>(p, hi[i] + lo[i], hi[i + 1] + lo[i + 1]);
            } else {
              p[0] = from_f32<TO>(hi[i] + lo[i]);
              if (col + 1 < f) p[1] = from_f32<TO>(hi[i + 1] + lo[i + 1]);
            }
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

// A 3-D map of an (outer, mid, inner) array of 16-bit values whose rows are
// `pitch` values apart (pitch >= inner, a multiple of 8), in {64, box_mid, 1}
// boxes (128 bytes wide) with the 128-byte swizzle; loads read zero outside
// the array (past inner too) and stores write nothing there.
bool encode_3d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, uint64_t inner,
               uint64_t mid, uint64_t outer, uint32_t box_mid, uint64_t pitch) {
  const cuuint64_t dims[3] = {inner, mid, outer};
  const cuuint64_t strides[2] = {pitch * 2, pitch * mid * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {kBox, box_mid, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return tensor_map_encoder()(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (E, m, k), B (E, k, n) and out (E, m, n), rows ap, bp and op values apart.
template <typename T>
cudaError_t launch_wgmma(const void* a, const void* b, void* out, int e, int m, int k, int n,
                         int ap, int bp, int op, CUtensorMapDataType type, cudaStream_t stream) {
  const int64_t work = static_cast<int64_t>(e) * ((m + kWgBM - 1) / kWgBM) *
                       ((n + kWgBN - 1) / kWgBN);
  if (work > INT_MAX) return cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap a_map, b_map, out_map;
  if (!encode_3d(&a_map, type, a, k, m, e, kWgBM, ap) ||    // 128 m x 64 k
      !encode_3d(&b_map, type, b, n, k, e, kWgBK, bp) ||    // 64 k x 64 n
      !encode_3d(&out_map, type, out, n, m, e, 64, op)) {  // 64 m x 64 n
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
  expert_wgmma<T><<<grid, kWgThreads, kWgSmem, stream>>>(a_map, b_map, out_map, e, m, k, n);
  return cudaGetLastError();
}

// w (E, d, f), dy (E, C, f) and dx (E, C, d), rows wp, dyp and dxp values apart.
template <typename T>
cudaError_t launch_dx(const void* w, const void* dy, void* dx, int e, int c, int d, int f,
                      int wp, int dyp, int dxp, CUtensorMapDataType type, cudaStream_t stream) {
  const int64_t work = static_cast<int64_t>(e) * ((d + kWgBM - 1) / kWgBM) *
                       ((c + kDxBN - 1) / kDxBN);
  if (work > INT_MAX) return cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap w_map, dy_map, dx_map;
  if (!encode_3d(&w_map, type, w, f, d, e, kWgBM, wp) ||          // 128 d x 64 f
      !encode_3d(&dy_map, type, dy, f, c, e, kDxBN, dyp) ||       // 160 C x 64 f
      !encode_3d(&dx_map, type, dx, d, c, e, kDxChunk, dxp)) {  // 32 C x 64 d
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(expert_wgmma_dx<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDxSmem);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(work < sms ? work : sms);
  expert_wgmma_dx<T><<<grid, kWgThreads, kDxSmem, stream>>>(w_map, dy_map, dx_map, e, c, d, f);
  return cudaGetLastError();
}

// x (E, C, d), dy (E, C, f) and dw (E, d, f), rows xp, dyp and dwp values apart.
template <typename T>
cudaError_t launch_dw(const void* x, const void* dy, void* dw, int e, int c, int d, int f,
                      int xp, int dyp, int dwp, CUtensorMapDataType type, cudaStream_t stream) {
  const int64_t work = static_cast<int64_t>(e) * ((f + kDwBN - 1) / kDwBN) *
                       ((d + 2 * kDwBM - 1) / (2 * kDwBM));
  if (work > INT_MAX) return cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap x_map, dy_map, dw_map;
  if (!encode_3d(&x_map, type, x, d, c, e, kWgBK, xp) ||     // 64 C x 64 d
      !encode_3d(&dy_map, type, dy, f, c, e, kWgBK, dyp) ||  // 64 C x 64 f
      !encode_3d(&dw_map, type, dw, f, d, e, 16, dwp)) {     // 16 d x 64 f: a warp's
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(expert_wgmma_dw<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(work < sms ? work : sms);
  expert_wgmma_dw<T><<<grid, kWgThreads, kDwSmem, stream>>>(x_map, dy_map, dw_map, e, c, d, f);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_split(const void* xp, const void* wp, void* out, int e, int c, int d, int f,
                         int x_pitch, int w_pitch, cudaStream_t stream) {
  const int64_t work = static_cast<int64_t>(e) * ((c + kWgBM - 1) / kWgBM) *
                       ((f + kSpBN - 1) / kSpBN);
  if (work > INT_MAX || 3ll * e > INT_MAX) return cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap x_map, w_map;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_3d(&x_map, bf16, xp, d, c, 3ull * e, kWgBM, x_pitch) ||  // 128 rows x 64 d
      !encode_3d(&w_map, bf16, wp, f, d, 3ull * e, kWgBK, w_pitch)) {  // 64 d x 64 f
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

// Every entry point returns cudaErrorInvalidValue for arguments its kernel
// does not take, else cudaGetLastError() after the launch (0 on success);
// the wrapper raises on anything else.

// Pitches (values between rows) must be multiples of 8 and the bases 16-byte
// aligned: a tensor map's base and strides are multiples of 16 bytes.
static bool pitch_ok(int pitch, int extent) { return pitch % 8 == 0 && pitch >= extent; }

// expert_wgmma: out[e] = A[e] @ B[e], (m, k) x (k, n) -> (m, n): A (E, m,
// a_pitch), B (E, k, b_pitch), out (E, m, out_pitch); of each row the first
// k, n or n values are read or written.  in_dtype (A and B) and out_dtype
// both 1 = bfloat16 or both 2 = float16; k > 0.
extern "C" int repro_moe_gemm_wgmma(const void* a, const void* b, void* out, int e, int m,
                                    int k, int n, int a_pitch, int b_pitch, int out_pitch,
                                    int in_dtype, int out_dtype, void* stream) {
  if (e < 0 || m < 0 || k <= 0 || n < 0 || !pitch_ok(a_pitch, k) || !pitch_ok(b_pitch, n) ||
      !pitch_ok(out_pitch, n) || (in_dtype != 1 && in_dtype != 2) || out_dtype != in_dtype ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0 || m == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      in_dtype == 1
          ? launch_wgmma<__nv_bfloat16>(a, b, out, e, m, k, n, a_pitch, b_pitch, out_pitch,
                                        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st)
          : launch_wgmma<__half>(a, b, out, e, m, k, n, a_pitch, b_pitch, out_pitch,
                                 CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st));
}

// The gradient checks shared by expert_wgmma_dx and _dw: a is w (E, d,
// a_pitch) for dx and x (E, C, a_pitch) for dw, dy (E, C, dy_pitch), out dx
// (E, C, out_pitch) or dw (E, d, out_pitch); dtype 1 = bfloat16 or 2 =
// float16 for all three; the contraction (f for dx, C for dw) > 0.
static bool grad_args_ok(const void* a, const void* dy, void* out, int e, int c, int d, int f,
                         int a_row, int out_row, int a_pitch, int dy_pitch, int out_pitch,
                         int dtype) {
  return e >= 0 && c >= 0 && d >= 0 && f >= 0 && pitch_ok(a_pitch, a_row) &&
         pitch_ok(dy_pitch, f) && pitch_ok(out_pitch, out_row) && (dtype == 1 || dtype == 2) &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// expert_wgmma_dx: dx[e] = dy[e] @ w[e]^T.  w (E, d, w_pitch), dy (E, C,
// dy_pitch), dx (E, C, dx_pitch); f > 0.
extern "C" int repro_moe_gemm_dx(const void* w, const void* dy, void* dx, int e, int c, int d,
                                 int f, int w_pitch, int dy_pitch, int dx_pitch, int dtype,
                                 void* stream) {
  if (f <= 0 || !grad_args_ok(w, dy, dx, e, c, d, f, f, d, w_pitch, dy_pitch, dx_pitch, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0 || c == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1 ? launch_dx<__nv_bfloat16>(w, dy, dx, e, c, d, f, w_pitch, dy_pitch,
                                                dx_pitch, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st)
                 : launch_dx<__half>(w, dy, dx, e, c, d, f, w_pitch, dy_pitch, dx_pitch,
                                         CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st));
}

// expert_wgmma_dw: dw[e] = x[e]^T @ dy[e].  x (E, C, x_pitch), dy (E, C,
// dy_pitch), dw (E, d, dw_pitch); C > 0.
extern "C" int repro_moe_gemm_dw(const void* x, const void* dy, void* dw, int e, int c, int d,
                                 int f, int x_pitch, int dy_pitch, int dw_pitch, int dtype,
                                 void* stream) {
  if (c <= 0 || !grad_args_ok(x, dy, dw, e, c, d, f, d, f, x_pitch, dy_pitch, dw_pitch, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0 || d == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1 ? launch_dw<__nv_bfloat16>(x, dy, dw, e, c, d, f, x_pitch, dy_pitch, dw_pitch,
                                            CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st)
                 : launch_dw<__half>(x, dy, dw, e, c, d, f, x_pitch, dy_pitch, dw_pitch,
                                     CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st));
}

// split3_bf16.  src: rows x cols float32 values; dst: 3 x rows x pitch
// bfloat16, the three pieces one after another, 16-byte aligned; pitch >=
// cols.
extern "C" int repro_split3_bf16(const void* src, void* dst, long long rows, int cols,
                                 int pitch, void* stream) {
  if (rows < 0 || cols < 0 || pitch < cols || reinterpret_cast<uintptr_t>(dst) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = rows * pitch;
  if (n > 0) {
    const long long blocks = (n / 4 + kSplitThreads - 1) / kSplitThreads + 1;
    const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);  // then grid-stride
    split3_bf16<<<grid, kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<__nv_bfloat16*>(dst), rows, cols, pitch);
  }
  return static_cast<int>(cudaGetLastError());
}

// split3_bf16_t.  src: batch x rows x cols float32 values; dst: 3 x batch x
// cols x pitch bfloat16, the pieces transposed (split3_bf16_t above);
// pitch >= rows.
extern "C" int repro_split3_bf16_t(const void* src, void* dst, int batch, int rows, int cols,
                                   int pitch, void* stream) {
  if (batch < 0 || rows < 0 || cols < 0 || pitch < rows || batch > 65535 ||
      cols / 32 >= 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0 && cols > 0 && pitch > 0) {
    const dim3 grid((pitch + 31) / 32, (cols + 31) / 32, batch);
    split3_bf16_t<<<grid, kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<__nv_bfloat16*>(dst), rows, cols, pitch);
  }
  return static_cast<int>(cudaGetLastError());
}

// stage16.  src: rows x src_pitch 16-bit values (any 2-byte alignment); dst:
// rows x dst_pitch; copies min(src_pitch, dst_pitch) values a row and zeroes
// the rest of each dst row.
extern "C" int repro_stage16(const void* src, void* dst, long long rows, int src_pitch,
                             int dst_pitch, void* stream) {
  if (rows < 0 || src_pitch < 0 || dst_pitch < 0 || reinterpret_cast<uintptr_t>(src) % 2 != 0 ||
      reinterpret_cast<uintptr_t>(dst) % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = rows * dst_pitch;
  if (n > 0) {
    const long long blocks = (n / 8 + kStageThreads - 1) / kStageThreads + 1;
    const int grid = static_cast<int>(blocks < 8192 ? blocks : 8192);  // then grid-stride
    stage16<<<grid, kStageThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(src), static_cast<uint16_t*>(dst), rows, src_pitch,
        dst_pitch);
  }
  return static_cast<int>(cudaGetLastError());
}

// expert_split.  xp: x's pieces, (3, E, C, x_pitch) bfloat16; wp: w's
// pieces, (3, E, d, w_pitch) bfloat16; out: (E, C, f) in out_dtype
// (0 = float32, 1 = bfloat16, 2 = float16).  d > 0, all three 16-byte
// aligned.
extern "C" int repro_moe_gemm_split(const void* xp, const void* wp, void* out, int e, int c,
                                    int d, int f, int x_pitch, int w_pitch, int out_dtype,
                                    void* stream) {
  if (e < 0 || c < 0 || d <= 0 || f < 0 || !pitch_ok(x_pitch, d) || !pitch_ok(w_pitch, f) ||
      out_dtype < 0 ||
      out_dtype > 2 || reinterpret_cast<uintptr_t>(xp) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0 || c == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return static_cast<int>(launch_split<float>(xp, wp, out, e, c, d, f, x_pitch, w_pitch, st));
    case 1:
      return static_cast<int>(
          launch_split<__nv_bfloat16>(xp, wp, out, e, c, d, f, x_pitch, w_pitch, st));
    default:
      return static_cast<int>(launch_split<__half>(xp, wp, out, e, c, d, f, x_pitch, w_pitch, st));
  }
}
