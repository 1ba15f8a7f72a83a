// BSR x dense SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bsr_spmm.py:_kernel (reached through
// bsr_spmm and ops.spmm).  It computes
//     out[row tile R] = sum over blocks i in [row_start[R], row_start[R+1]) of
//                       blocks[i] @ dense[bcols[i] * bk : (bcols[i] + 1) * bk, :]
// for (bm, bk) blocks sorted by block-row, a dense (K, N) operand, and an
// (m_blocks * bm, N) result in the inputs' type.
//
// The TPU kernel walks the blocks on a sequential grid, revisits the output
// tile of a block-row on consecutive steps, initialises it on the first
// visit, and adds each block product into it in the *output* type.  A Hopper
// grid runs in parallel and in no order, so the host computes the block-row
// offsets once per call (repro_torch.kernels.bsr_spmm) and each output tile
// belongs to one warp or one program: it sums all of the row's blocks in
// fp32 registers and rounds once when it writes.  So a bf16 result is
// rounded once per element here, where the TPU kernel rounds once per block
// product; and every output tile is written by its owner, so a block-row
// with no blocks comes out zero without a separate fill (the TPU kernel
// needs ops.spmm to pad a zero block into it).
//
// What bounds it.  At the repo's AMG size (the n = 42 27-point operator
// tiled 8 x 8: 169,951 blocks in 9,261 block-rows, 17.5% fill, N = 256)
// each input read once is 0.10 GB in bf16 and 0.19 GB in fp32, and the fp32
// multiply-adds take 0.083 ms at the CUDA cores' 67 TFLOP/s.  But every
// block reads its own 8 x N slab of the dense operand: 0.70 GB (bf16) or
// 1.39 GB (fp32) gathered from L2, which the 50 MB L2 mostly serves (a slab
// is read by about 18 block-rows).  Keeping that gather in flight sets the
// pace: on an H100 80GB HBM3 at 700 W mma_rows gathers at 7.1 TB/s
// (0.098 ms) and warp_rows at 6.5 TB/s (0.215 ms; its FMAs alone would take
// about as long as its loads, and the two overlap imperfectly), per
// chip_smoke.py.  Three kernels, picked by the wrapper before launch
// (repro_torch.kernels.bsr_spmm.route):
//
// mma_rows<T> (bf16 and fp16, bm = 8, bk a multiple of 8): the transposed
// product on the tensor cores,
//     out_R^T (N x 8) = sum over k8 units v of  slab_v^T (N x 8) . A_v^T (8 x 8),
// where a unit is 8 columns of one block and its 8 dense rows.  The dense
// width goes in mma.sync.m16n8k16's M (16 columns a tile), the block's 8
// rows fill N = 8, and two consecutive units of the row fill one k16 step
// (a row with an odd unit count gets a zero half).  bf16 x bf16 and
// fp16 x fp16 products are exact in the fp32 accumulators, so the sum is the
// reference's up to order (the reference sums in fp32 too).
// warp_rows (fp32, bm = 8, bk a multiple of 8): fp32 FMAs on the CUDA cores
// (TF32 would drop about three digits), one unit a step.
// Both are one warp-level pipeline: a warp owns 128 columns of every
// n-th block-row (n such that the card holds all warps in one wave, three
// 4-warp programs an SM, so the warps sweep the rows together and the slabs
// they gather stay in L2) and walks their units as one stream.
// Its own ring of 4 stages in shared memory keeps the next three steps'
// dense slabs and block values in flight (cp.async, 16 bytes a lane, from
// L2 past L1, zero-filled past the row's last unit and past N) while
// it sums the current one; warps meet only at __syncwarp, so a warp never
// waits on another's rows.  mma_rows reads a step's two slabs into A
// fragments with ldmatrix.trans (the slab rows are N-major; their 16-byte
// chunks XOR-swizzled so the eight row addresses of a matrix hit distinct
// banks) and its block values as B fragments, one 4-byte load a lane each;
// warp_rows reads each lane's 4 columns of the 8 slab rows as float4 and
// the block's rows as broadcasts, 256 FMAs a step.  A lane holds 32 fp32
// sums in either (8 column tiles of 4, or 8 rows of 4 columns).  Inputs
// whose rows or bases are off 16 bytes (N off a multiple of 16 / sizeof(T),
// a view into a buffer) take the same kernels with synchronous element
// copies into the ring.
//
// block_rows<T> (every other block shape: bm other than 8, or bk off a
// multiple of 8): one program per (block-row, 256 columns, 8 rows of the
// block); each of its 128 threads owns 2 columns and the 8 rows, so it
// holds 16 fp32 sums; a block's slice of up to 32 columns is staged in
// shared memory transposed, and each dense element goes from device memory
// straight into a register and is used 8 times.  The port's first design:
// it walks one block at a time between two barriers with nothing in
// flight, so it follows the load latency (it took 0.41 ms in fp32 and 0.40
// in bf16 at 8 x 8, and takes 0.74 ms for the same operator tiled 12 x 12
// in fp32, on an H100 80GB HBM3 at 700 W, per chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

// the kernels, as the wrapper numbers them (repro_torch.kernels.bsr_spmm.KERNELS)
enum Kernel { kBlockRows = 0, kWarpRows = 1, kMmaRows = 2 };

// ---------------------------------------------------------------- block_rows

constexpr int kThreads = 128;
constexpr int kCols = 2;                     // columns per thread
constexpr int kTileN = kThreads * kCols;     // columns per program
constexpr int kRows = 8;                     // block rows per program
constexpr int kSliceK = 32;                  // block columns staged per step
constexpr int kMaxGridYZ = 65535;
static_assert(kRows == 8, "block_rows reads a row slice as two float4");

// Program (blockIdx.x, blockIdx.y, blockIdx.z) owns block-row blockIdx.x,
// columns [blockIdx.y * kTileN, +kTileN) and rows [blockIdx.z * kRows, +kRows)
// of that block-row.  Thread t holds columns col0 + t + kThreads * c.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_rows(const T* __restrict__ blocks, const int* __restrict__ row_start,
               const int* __restrict__ bcols, const T* __restrict__ dense,
               T* __restrict__ out, int bm, int bk, int n) {
  __shared__ __align__(16) float a_s[kSliceK][kRows];  // block slice, transposed
  const int row_block = blockIdx.x;
  const int col0 = blockIdx.y * kTileN + threadIdx.x;
  const int m0 = blockIdx.z * kRows;
  const int64_t block_size = static_cast<int64_t>(bm) * bk;
  float acc[kRows][kCols];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;
  }
  bool col_in[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) col_in[c] = col0 + kThreads * c < n;
  const int end = row_start[row_block + 1];
  for (int i = row_start[row_block]; i < end; ++i) {
    const T* blk = blocks + i * block_size;
    const T* d = dense + static_cast<int64_t>(bcols[i]) * bk * n + col0;
    for (int k0 = 0; k0 < bk; k0 += kSliceK) {
      __syncthreads();  // the previous slice has been read
      for (int idx = threadIdx.x; idx < kRows * kSliceK; idx += kThreads) {
        const int m = idx / kSliceK, k = idx % kSliceK;
        const int gm = m0 + m, gk = k0 + k;
        a_s[k][m] = (gm < bm && gk < bk) ? to_f32(blk[static_cast<int64_t>(gm) * bk + gk])
                                         : 0.f;
      }
      __syncthreads();
      const int kc = bk - k0 < kSliceK ? bk - k0 : kSliceK;
#pragma unroll 8
      for (int k = 0; k < kc; ++k) {
        const T* drow = d + static_cast<int64_t>(k0 + k) * n;
        float dv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) dv[c] = col_in[c] ? to_f32(drow[kThreads * c]) : 0.f;
        const float4 lo = *reinterpret_cast<const float4*>(&a_s[k][0]);
        const float4 hi = *reinterpret_cast<const float4*>(&a_s[k][4]);
        const float av[kRows] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[m][c] = fmaf(av[m], dv[c], acc[m][c]);
        }
      }
    }
  }
  T* o = out + (static_cast<int64_t>(row_block) * bm + m0) * n + col0;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    if (m0 + m >= bm) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (col_in[c]) o[static_cast<int64_t>(m) * n + kThreads * c] = from_f32<T>(acc[m][c]);
    }
  }
}

// ------------------------------------------------------ warp_rows, mma_rows

constexpr int kRingCols = 128;  // dense columns a warp
constexpr int kStages = 4;      // a warp's ring: 3 steps in flight while 1 is summed
constexpr int kRingWarps = 4;   // warps a program
constexpr int kPrograms = 3;    // programs an SM: what the shared memory holds
// (on the AMG SpMM, 2 to 8 stages, 2 to 6 programs an SM, or 256 columns a
// warp were within a few percent or slower: the gather's rate, not the
// bytes in flight, sets the pace)

// One warp's ring.  A step is kUnits k8 units: their dense slabs (8 rows of
// kRingCols values each, kRowBytes apart) then their 8 x 8 block values.
template <typename T>
struct Ring {
  static constexpr int kUnits = sizeof(T) == 2 ? 2 : 1;  // one k16 mma, or 8 fp32 k
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values a 16-byte chunk
  static constexpr int kRowBytes = kRingCols * static_cast<int>(sizeof(T));
  static constexpr int kRowChunks = kRowBytes / 16;
  static constexpr int kLaneChunks = 8 * kRowChunks / 32;  // a unit's slab, per lane
  static constexpr int kDenseBytes = kUnits * 8 * kRowBytes;
  static constexpr int kUnitABytes = 64 * static_cast<int>(sizeof(T));
  static constexpr int kStageBytes = kDenseBytes + kUnits * kUnitABytes;
  static constexpr int kWarpBytes = kStages * kStageBytes;
  static constexpr int kSmem = kRingWarps * kWarpBytes;
  static_assert(kPrograms * (kSmem + 1024) <= 228 * 1024, "the rings do not fit an SM");
};

// 16 bytes of shared memory at dst from the first n_in values at src, the
// rest zero.  VEC: by cp.async (n_in is 0 or a whole chunk, src 16-byte
// aligned; `safe` stands in for src when nothing is read).  Otherwise by
// plain loads and stores, done when this returns.
template <typename T, bool VEC>
__device__ __forceinline__ void copy16(uint8_t* dst, const T* src, int n_in, const T* safe) {
  if constexpr (VEC) {
    cp_async16(smem_u32(dst), n_in > 0 ? src : safe, n_in * static_cast<int>(sizeof(T)));
  } else {
    using Raw = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
    const Raw* s = reinterpret_cast<const Raw*>(src);
    Raw* d = reinterpret_cast<Raw*>(dst);
#pragma unroll
    for (int e = 0; e < Ring<T>::kPer; ++e) d[e] = e < n_in ? s[e] : Raw(0);
  }
}

// Byte offset of 16-byte chunk `chunk` of slab row `row` in a stage.  The
// 16-bit slabs are read by ldmatrix, 8 rows at one column: chunk c of row r
// goes to c ^ (r % 8) of its row, so those 8 rows hit 8 distinct bank groups
// while every row stays where its 128-byte lines fall (16 bytes of padding
// a row did the first too, but put cp.async's writes off the lines'
// alignment, and the gather ran markedly slower than fp32's).  fp32 rows
// are read by float4 a lane, in order: no swizzle.
template <typename T>
__device__ __forceinline__ int slab_offset(int row, int chunk) {
  if constexpr (sizeof(T) == 2) chunk ^= row % 8;
  return row * Ring<T>::kRowBytes + chunk * 16;
}

// Where a warp's stream of steps stands: block-row `row` of the warp's rows
// (every `stride`-th, below `end`); its next unit to load is columns
// [8 c, 8 c + 8) of block `blk`, and `left` units of the row remain.
struct Walk {
  int row, stride, end, blk, c, left;
};

// Stage the next step of `w` into `st` (nothing once the rows are done) and
// commit it as one cp.async group, so that groups and steps stay paired.
// Unit (blk, c) is columns [8 c, +8) of block blk (c < cpb = bk / 8) with
// dense rows bcols[blk] * bk + 8 c + [0, 8) at columns [n0, n0 + 128).
// `off` holds lane chunk i's offset from its slab's first value, j n + col.
template <typename T, bool VEC>
__device__ __forceinline__ void load_step(Walk& w, uint8_t* st, const T* __restrict__ blocks,
                                          const int* __restrict__ row_start,
                                          const int* __restrict__ bcols,
                                          const T* __restrict__ dense, int bk, int n, int n0,
                                          const int64_t (&off)[Ring<T>::kLaneChunks],
                                          int lane) {
  using R = Ring<T>;
  const int cpb = bk / 8;
  while (w.left <= 0 && w.row + w.stride < w.end) {
    w.row += w.stride;
    w.blk = row_start[w.row];
    w.left = (row_start[w.row + 1] - w.blk) * cpb;
    w.c = 0;
  }
  if (w.left > 0) {
#pragma unroll
    for (int v = 0; v < R::kUnits; ++v) {
      const bool valid = v < w.left;  // false: the zero half of an odd row
      const T* slab = dense + (valid ? static_cast<int64_t>(bcols[w.blk]) * bk + 8 * w.c : 0) * n;
#pragma unroll
      for (int i = 0; i < R::kLaneChunks; ++i) {
        const int q = lane + 32 * i;
        const int j = q / R::kRowChunks, chunk = q % R::kRowChunks;
        const int left = n - (n0 + chunk * R::kPer);  // VEC: n % kPer == 0, whole chunks
        const int n_in = !valid || left <= 0 ? 0 : VEC || left >= R::kPer ? R::kPer : left;
        copy16<T, VEC>(st + slab_offset<T>(v * 8 + j, chunk), slab + off[i], n_in, dense);
      }
      // the unit's 8 rows of 8 values: 8 x 8 x sizeof(T) bytes in 16-byte chunks
      constexpr int kAChunks = R::kUnitABytes / 16, kPerRow = kAChunks / 8;
      if (lane < kAChunks) {
        const int r = lane / kPerRow, h = lane % kPerRow;
        copy16<T, VEC>(st + R::kDenseBytes + v * R::kUnitABytes + lane * 16,
                       blocks + (static_cast<int64_t>(w.blk) * 8 + r) * bk + 8 * w.c + h * R::kPer,
                       valid ? R::kPer : 0, blocks);
      }
      if (valid && ++w.c == cpb) {
        w.c = 0;
        ++w.blk;
      }
    }
    w.left -= R::kUnits;
  }
  cp_async_commit();
}

// mma_rows: the step's two units as one k16 step of 8 column tiles; lane
// 4 g + t sums columns g and g + 8 of each 16-column tile, block rows 2t
// and 2t + 1.
template <typename T>
__device__ __forceinline__ void sum_step(float (&acc)[8][4], const uint8_t* st, int lane) {
  using R = Ring<T>;
  uint32_t b[2];  // B (k x block row): unit h's row lane / 4, values 2 (lane % 4) and + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    b[h] = *reinterpret_cast<const uint32_t*>(st + R::kDenseBytes + h * R::kUnitABytes + lane * 4);
  }
  // A (dense column x k): lanes 8 q to 8 q + 7 address slab rows 0-7 of unit
  // q / 2 at columns 8 (q % 2) + [0, 8) of the tile; .trans gives lane l
  // column l / 4, rows 2 (l % 4) and + 1 of each, as the fragment wants
  const uint32_t base = smem_u32(st);
  const int row = (lane / 16) * 8 + lane % 8, half = (lane / 8) % 2;
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) {
    uint32_t a[4];
    ldmatrix_x4_trans(a, base + slab_offset<T>(row, 2 * mt + half));
    mma_16816<T>(acc[mt], a, b);
  }
}

// warp_rows: one unit; lane l sums columns 4 l to 4 l + 3 of the 8 block rows.
template <>
__device__ __forceinline__ void sum_step<float>(float (&acc)[8][4], const uint8_t* st,
                                                int lane) {
  const float* d = reinterpret_cast<const float*>(st);
  const float* a = reinterpret_cast<const float*>(st + Ring<float>::kDenseBytes);
  float4 dv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) dv[k] = *reinterpret_cast<const float4*>(d + k * kRingCols + 4 * lane);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4 lo = *reinterpret_cast<const float4*>(a + 8 * r);  // one address: a broadcast
    const float4 hi = *reinterpret_cast<const float4*>(a + 8 * r + 4);
    const float av[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc[r][0] = fmaf(av[k], dv[k].x, acc[r][0]);
      acc[r][1] = fmaf(av[k], dv[k].y, acc[r][1]);
      acc[r][2] = fmaf(av[k], dv[k].z, acc[r][2]);
      acc[r][3] = fmaf(av[k], dv[k].w, acc[r][3]);
    }
  }
}

// The 8 x 128 output tile of block-row `row` at column n0, rounded once,
// from the sums as sum_step holds them.
template <typename T, bool VEC>
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], T* __restrict__ out,
                                           int row, int n, int n0, int lane) {
  T* o = out + static_cast<int64_t>(row) * 8 * n;
  const int g = lane / 4, t = lane % 4;
  const int64_t r0 = static_cast<int64_t>(2 * t) * n, r1 = r0 + n;
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) {
    const int col = n0 + 16 * mt + g;
    if (col < n) {
      o[r0 + col] = from_f32<T>(acc[mt][0]);
      o[r1 + col] = from_f32<T>(acc[mt][1]);
    }
    if (col + 8 < n) {
      o[r0 + col + 8] = from_f32<T>(acc[mt][2]);
      o[r1 + col + 8] = from_f32<T>(acc[mt][3]);
    }
  }
}

// warp_rows, VEC: n % 4 == 0, so a lane's 4 columns are in or out together
// and go as one float4.
template <>
__device__ __forceinline__ void store_rows<float, true>(const float (&acc)[8][4],
                                                        float* __restrict__ out, int row, int n,
                                                        int n0, int lane) {
  const int col = n0 + 4 * lane;
  if (col >= n) return;
  float* o = out + static_cast<int64_t>(row) * 8 * n + col;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    *reinterpret_cast<float4*>(o + static_cast<int64_t>(r) * n) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

template <>
__device__ __forceinline__ void store_rows<float, false>(const float (&acc)[8][4],
                                                         float* __restrict__ out, int row, int n,
                                                         int n0, int lane) {
  const int col = n0 + 4 * lane;
  float* o = out + static_cast<int64_t>(row) * 8 * n + col;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (col + c < n) o[static_cast<int64_t>(r) * n + c] = acc[r][c];
    }
  }
}

// Warp w of program b is warp g = 4 b + w of the grid: it owns dense columns
// [128 (g % n_tiles), +128) of block-rows g / n_tiles + i n_ranges.  So the
// grid's warps walk the block-rows together, front to back, and the dense
// rows they gather at any time are a window of the operand that the L2
// holds (each warp taking a contiguous run of rows instead spread the
// gather over the whole operand at once; in fp32, at 76 MB, that thrashed
// the 50 MB L2 and the slabs came from device memory).
template <typename T, bool VEC>
__device__ __forceinline__ void ring_rows(const T* __restrict__ blocks,
                                          const int* __restrict__ row_start,
                                          const int* __restrict__ bcols,
                                          const T* __restrict__ dense, T* __restrict__ out,
                                          int m_blocks, int bk, int n, int n_ranges) {
  using R = Ring<T>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int lane = threadIdx.x % 32;
  const int warp = blockIdx.x * kRingWarps + threadIdx.x / 32;
  const int n_tiles = (n + kRingCols - 1) / kRingCols;
  const int r0 = warp / n_tiles;
  if (r0 >= n_ranges) return;
  const int n0 = (warp % n_tiles) * kRingCols;
  uint8_t* ring = smem_raw + (threadIdx.x / 32) * R::kWarpBytes;
  int64_t off[R::kLaneChunks];  // lane chunk i: slab row j, column col
#pragma unroll
  for (int i = 0; i < R::kLaneChunks; ++i) {
    const int q = lane + 32 * i;
    off[i] = static_cast<int64_t>(q / R::kRowChunks) * n + n0 + (q % R::kRowChunks) * R::kPer;
  }
  Walk w{r0 - n_ranges, n_ranges, m_blocks, 0, 0, 0};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_step<T, VEC>(w, ring + s * R::kStageBytes, blocks, row_start, bcols, dense, bk, n, n0,
                      off, lane);
  }
  int step = 0;
  for (int row = r0; row < m_blocks; row += n_ranges) {
    const int units = (row_start[row + 1] - row_start[row]) * (bk / 8);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int u = 0; u < units; u += R::kUnits, ++step) {
      cp_async_wait<kStages - 2>();  // this lane's copies of `step` have landed
      __syncwarp();                  // and every lane's; all are done with step - 1
      load_step<T, VEC>(w, ring + ((step + kStages - 1) % kStages) * R::kStageBytes, blocks,
                        row_start, bcols, dense, bk, n, n0, off, lane);
      sum_step<T>(acc, ring + (step % kStages) * R::kStageBytes, lane);
    }
    store_rows<T, VEC>(acc, out, row, n, n0, lane);
  }
  cp_async_wait<0>();  // the walk is done: only empty groups are left
}

template <bool VEC>
__global__ void __launch_bounds__(kRingWarps * 32, kPrograms)
    warp_rows(const float* __restrict__ blocks, const int* __restrict__ row_start,
              const int* __restrict__ bcols, const float* __restrict__ dense,
              float* __restrict__ out, int m_blocks, int bk, int n, int n_ranges) {
  ring_rows<float, VEC>(blocks, row_start, bcols, dense, out, m_blocks, bk, n, n_ranges);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kRingWarps * 32, kPrograms)
    mma_rows(const T* __restrict__ blocks, const int* __restrict__ row_start,
             const int* __restrict__ bcols, const T* __restrict__ dense, T* __restrict__ out,
             int m_blocks, int bk, int n, int n_ranges) {
  ring_rows<T, VEC>(blocks, row_start, bcols, dense, out, m_blocks, bk, n, n_ranges);
}

struct Args {
  const void* blocks;
  const int* row_start;
  const int* bcols;
  const void* dense;
  void* out;
  int m_blocks, bm, bk, n;
  cudaStream_t stream;
};

template <typename T>
void launch_block_rows(const Args& g) {
  const dim3 grid(g.m_blocks, (g.n + kTileN - 1) / kTileN, (g.bm + kRows - 1) / kRows);
  block_rows<T><<<grid, kThreads, 0, g.stream>>>(
      static_cast<const T*>(g.blocks), g.row_start, g.bcols, static_cast<const T*>(g.dense),
      static_cast<T*>(g.out), g.bm, g.bk, g.n);
}

// One warp per 128 columns of every n_ranges-th block-row, with n_ranges
// such that every warp of the grid is resident at once (kPrograms an SM).
template <typename T, typename Fn>
void launch_ring(Fn kernel, const Args& g) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Ring<T>::kSmem) != cudaSuccess) {
    return;  // the error stays in cudaGetLastError() for the caller
  }
  const int64_t n_tiles = (g.n + kRingCols - 1) / kRingCols;
  const int64_t resident = static_cast<int64_t>(sms) * kPrograms * kRingWarps;
  const int64_t rows_per_warp = (g.m_blocks * n_tiles + resident - 1) / resident;
  const int64_t n_ranges = (g.m_blocks + rows_per_warp - 1) / rows_per_warp;
  const int64_t grid = (n_ranges * n_tiles + kRingWarps - 1) / kRingWarps;
  kernel<<<static_cast<unsigned>(grid), kRingWarps * 32, Ring<T>::kSmem, g.stream>>>(
      static_cast<const T*>(g.blocks), g.row_start, g.bcols, static_cast<const T*>(g.dense),
      static_cast<T*>(g.out), g.m_blocks, g.bk, g.n, static_cast<int>(n_ranges));
}

// 16-byte copies need the dense rows, the block rows' 8-value pieces and the
// bases on 16 bytes; the fp32 float4 stores need the output rows there too.
template <typename T>
bool vec_ok(const Args& g) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return (static_cast<int64_t>(g.n) * sizeof(T)) % 16 == 0 && aligned(g.blocks) &&
         aligned(g.dense) && aligned(g.out);
}

template <typename T>
int run(int kernel, const Args& g) {
  if (kernel == kBlockRows) {
    launch_block_rows<T>(g);
  } else if constexpr (std::is_same<T, float>::value) {
    vec_ok<T>(g) ? launch_ring<T>(warp_rows<true>, g) : launch_ring<T>(warp_rows<false>, g);
  } else {
    vec_ok<T>(g) ? launch_ring<T>(mma_rows<T, true>, g) : launch_ring<T>(mma_rows<T, false>, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches `kernel` on the shapes the wrapper's route gives it (0
// block_rows: bm != 8 or bk off a multiple of 8; 1 warp_rows: float32 with
// bm = 8 and bk a multiple of 8; 2 mma_rows: bfloat16 or float16 with bm = 8
// and bk a multiple of 8).  blocks: (nb, bm, bk) sorted by block-row;
// row_start: int32, m_blocks + 1 offsets into the blocks; bcols: int32 per
// block; dense: (K, n); out: (m_blocks * bm, n); dtype (all three):
// 0 = float32, 1 = bfloat16, 2 = float16.  Returns cudaErrorInvalidValue for
// a shape or type the kernel does not take, else cudaGetLastError() after
// the launch (0 on success); the wrapper raises on anything else.
extern "C" int repro_bsr_spmm(int kernel, const void* blocks, const void* row_start,
                              const void* bcols, const void* dense, void* out, int m_blocks,
                              int bm, int bk, int n, int dtype, void* stream) {
  if (m_blocks < 0 || bm < 1 || bk < 1 || n < 0 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool ring_shape = bm == 8 && bk % 8 == 0;
  switch (kernel) {
    case kBlockRows:
      if (ring_shape || (n + kTileN - 1) / kTileN > kMaxGridYZ ||
          (bm + kRows - 1) / kRows > kMaxGridYZ) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    case kWarpRows:
      if (!ring_shape || dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
      break;
    case kMmaRows:
      if (!ring_shape || dtype == 0) return static_cast<int>(cudaErrorInvalidValue);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m_blocks == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  const Args g{blocks, static_cast<const int*>(row_start), static_cast<const int*>(bcols), dense,
               out, m_blocks, bm, bk, n, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return run<float>(kernel, g);
    case 1:
      return run<__nv_bfloat16>(kernel, g);
    default:
      return run<__half>(kernel, g);
  }
}
