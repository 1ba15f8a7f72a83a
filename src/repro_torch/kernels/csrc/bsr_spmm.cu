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
// chip_smoke.py.  Four kernels, picked by the wrapper before launch
// (repro_torch.kernels.bsr_spmm.route), all one warp-level pipeline:
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
// warp_blocks (fp32) and mma_blocks<T> (bf16, fp16) take every other block
// shape (bm other than 8, or bk off a multiple of 8: 3 x 3 elasticity,
// 4 x 4 to 6 x 6 coupled flow and shells, 12 x 12, 32 x 32 tiles) on the
// same ring.  A warp's work item is (block-row, a group of up to 16 of its
// rows, 128 columns): ROWS rows a group, 4, 8, 12 or 16 for fp32 (a lane
// holds ROWS rows of its 4 columns, so 12 x 12 does no padded FMAs) and 8
// or 16 for 16-bit (one or two n8 tiles of the mma); rows past bm are never
// stored (16-bit zero-fills their block values, fp32 skips them), and a
// block with bm > 16 is gathered once a group, ceil(bm / 16) times.  bk goes in k8 units, the last one's rows
// past bk zero-filled by cp.async's source size (they read nothing from
// L2); fp32 sums only the first 4 rows of a unit that has 4 or fewer.
// Block values go into the ring by 4-byte cp.async (one fp32 value, or an
// aligned pair of 16-bit ones), so rows off 16 bytes (3 x 3 fp32, 12 x 12
// bf16) stay asynchronous; only 16-bit blocks with odd bk take plain
// loads.  fp32 lands them transposed, a unit's column k as ROWS values, and
// sums k by k: each k's ROWS x 4 multiply-adds are independent (summing
// row by row, as warp_rows does, chains 8 a sum, and ran markedly slower
// at 12 x 12).  They replace block_rows, the port's first design (one
// program per block-row, 256 columns and 8 rows of the block, one block
// between two barriers with nothing in flight, and a 12 x 12 block-row's
// slab gathered twice: 0.74 ms for the AMG operator tiled 12 x 12 in fp32
// on an H100 80GB HBM3 at 700 W, per chip_smoke.py).  There warp_blocks
// gathers its 1.48 GB at 3.9 TB/s (0.380 ms) and mma_blocks in bf16 at
// 4.8 TB/s (0.155 ms): a 12 x 12 block takes two fp32 steps (its 8 + 4
// columns) where an 8 x 8 one takes one, and issuing its 576 FMAs a lane,
// more than the gather, sets the pace.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

// the kernels, as the wrapper numbers them (repro_torch.kernels.bsr_spmm.KERNELS)
enum Kernel { kWarpRows = 0, kMmaRows = 1, kWarpBlocks = 2, kMmaBlocks = 3 };

constexpr int kRingCols = 128;  // dense columns a warp
constexpr int kStages = 4;      // a warp's ring: 3 steps in flight while 1 is summed
constexpr int kRingWarps = 4;   // warps a program
constexpr int kPrograms = 3;    // programs an SM: what the shared memory holds
// (on the AMG SpMM, 2 to 8 stages, 2 to 6 programs an SM, or 256 columns a
// warp were within a few percent or slower: the gather's rate, not the
// bytes in flight, sets the pace)

// How a unit's block values reach the ring.  kA16: 16-byte chunks (bm = 8,
// bk a multiple of 8: warp_rows and mma_rows).  kA4: 4-byte cp.async, one
// fp32 value or an aligned pair of 16-bit ones (warp_blocks, and
// mma_blocks with bk even).  kASync: plain loads (mma_blocks with bk odd).
// kA4 and kASync take any block shape.
enum ACopy { kA16 = 0, kA4 = 1, kASync = 2 };

// One warp's ring.  A step is kUnits k8 units: their dense slabs (8 rows of
// kRingCols values each, kRowBytes apart) then their block values, ROWS
// rows of 8.
template <typename T, int ROWS>
struct Ring {
  static constexpr int kUnits = sizeof(T) == 2 ? 2 : 1;  // one k16 mma, or 8 fp32 k
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values a 16-byte chunk
  static constexpr int kRowBytes = kRingCols * static_cast<int>(sizeof(T));
  static constexpr int kRowChunks = kRowBytes / 16;
  static constexpr int kLaneChunks = 8 * kRowChunks / 32;  // a unit's slab, per lane
  static constexpr int kDenseBytes = kUnits * 8 * kRowBytes;
  static constexpr int kUnitABytes = ROWS * 8 * static_cast<int>(sizeof(T));
  static constexpr int kStageBytes = kDenseBytes + kUnits * kUnitABytes;
  static constexpr int kWarpBytes = kStages * kStageBytes;
  static constexpr int kSmem = kRingWarps * kWarpBytes;
  static_assert(kPrograms * (kSmem + 1024) <= 228 * 1024, "the rings do not fit an SM");
  static_assert(sizeof(T) == 4 ? ROWS % 4 == 0 : ROWS % 8 == 0,
                "fp32 rows go in float4 pairs, 16-bit rows in n8 tiles");
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
    for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e) d[e] = e < n_in ? s[e] : Raw(0);
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
  return row * kRingCols * static_cast<int>(sizeof(T)) + chunk * 16;
}

// Where a warp's stream of steps stands: work item `item` of the warp's
// items (every `stride`-th, below `end`; item i is block-row i / groups,
// rows [ROWS (i % groups), +ROWS) of it); its next unit to load is columns
// [8 c, 8 c + 8) of block `blk`, and `left` units of the item remain.
struct Walk {
  int item, stride, end, blk, c, left;
};

// The block shape as the kernels take it: groups = ceil(bm / ROWS) work
// items a block-row.
struct Shape {
  int bm, bk, n, groups;
};

// Stage the next step of `w` into `st` (nothing once the rows are done) and
// commit it as one cp.async group, so that groups and steps stay paired.
// Unit (blk, c) is columns [8 c, +8) of block blk (c < cpb = ceil(bk / 8))
// with dense rows bcols[blk] * bk + 8 c + [0, 8) at columns [n0, n0 + 128);
// rows past bk are zero-filled.  `off` holds lane chunk i's offset from its
// slab's first value, j n + col.
template <typename T, int ROWS, bool VEC, int AC>
__device__ __forceinline__ void load_step(Walk& w, uint8_t* st, const T* __restrict__ blocks,
                                          const int* __restrict__ row_start,
                                          const int* __restrict__ bcols,
                                          const T* __restrict__ dense, const Shape& sh, int n0,
                                          const int64_t (&off)[Ring<T, ROWS>::kLaneChunks],
                                          int lane) {
  using R = Ring<T, ROWS>;
  constexpr bool kAny = AC != kA16;  // any block shape (else bm = 8, bk % 8 == 0)
  // fp32 on any shape sums 4 rows of a unit where only 4 or fewer are below
  // bk, and rows past bm into sums it never stores: the copies that no sum
  // reads are skipped (the tensor cores read every row of a k16 step, and
  // those past bk must be zeros: 0 x a stale Inf is NaN)
  constexpr bool kSkip = kAny && sizeof(T) == 4;
  const int bk = sh.bk, n = sh.n;
  const int cpb = kAny ? (bk + 7) / 8 : bk / 8;
  while (w.left <= 0 && w.item + w.stride < w.end) {
    w.item += w.stride;
    const int row = kAny ? w.item / sh.groups : w.item;
    w.blk = row_start[row];
    w.left = (row_start[row + 1] - w.blk) * cpb;
    w.c = 0;
  }
  if (w.left > 0) {
    const int row0 = kAny ? (w.item % sh.groups) * ROWS : 0;  // the group's first block row
#pragma unroll
    for (int v = 0; v < R::kUnits; ++v) {
      const bool valid = v < w.left;  // false: the zero half of an odd row
      const int k0 = 8 * w.c;
      const int k_rows = !valid ? 0 : kAny ? min(8, bk - k0) : 8;  // slab rows read
      const int k_used = kSkip && k_rows <= 4 ? 4 : 8;  // rows the sum reads (sum_step)
      const T* slab = dense + (valid ? static_cast<int64_t>(bcols[w.blk]) * bk + k0 : 0) * n;
#pragma unroll
      for (int i = 0; i < R::kLaneChunks; ++i) {
        const int q = lane + 32 * i;
        const int j = q / R::kRowChunks, chunk = q % R::kRowChunks;
        const int left = n - (n0 + chunk * R::kPer);  // VEC: n % kPer == 0, whole chunks
        const int n_in = j >= k_rows || left <= 0 ? 0 : VEC || left >= R::kPer ? R::kPer : left;
        if (j >= k_used) continue;  // read by no sum: no copy, no zeros
        copy16<T, VEC>(st + slab_offset<T>(v * 8 + j, chunk), slab + off[i], n_in, dense);
      }
      uint8_t* a_st = st + R::kDenseBytes + v * R::kUnitABytes;
      if constexpr (AC == kA16) {
        // the unit's 8 rows of 8 values: 8 x 8 x sizeof(T) bytes in 16-byte chunks
        constexpr int kAChunks = R::kUnitABytes / 16, kPerRow = kAChunks / 8;
        if (lane < kAChunks) {
          const int r = lane / kPerRow, h = lane % kPerRow;
          copy16<T, VEC>(a_st + lane * 16,
                         blocks + (static_cast<int64_t>(w.blk) * 8 + r) * bk + k0 + h * R::kPer,
                         valid ? R::kPer : 0, blocks);
        }
      } else {
        // the unit's ROWS rows of 8 values in 4-byte pieces, zero past bm and bk
        constexpr int kEl = 4 / static_cast<int>(sizeof(T));  // values a piece
        constexpr int kPiecesRow = 8 / kEl;
        constexpr int kPieces = ROWS * kPiecesRow;
        static_assert(kPieces % 32 == 0, "whole pieces a lane");
        const T* a_unit = blocks + (static_cast<int64_t>(w.blk) * sh.bm + row0) * bk + k0;
#pragma unroll
        for (int i = 0; i < kPieces / 32; ++i) {
          const int p = lane + 32 * i;
          const int r = p / kPiecesRow, kc = (p % kPiecesRow) * kEl;
          const int gm = row0 + r, kk = k0 + kc;
          const bool in = valid && gm < sh.bm && kk < bk;
          const T* src = a_unit + r * bk + kc;
          if constexpr (sizeof(T) == 4) {  // transposed: column kc, row r (sum_fp32_t)
            if (gm >= sh.bm || kc >= k_used) continue;
            cp_async4(smem_u32(a_st + (kc * ROWS + r) * 4), in ? src : blocks, in ? 4 : 0);
          } else if constexpr (AC == kA4) {  // bk even: a pair is in or out whole
            cp_async4(smem_u32(a_st + p * 4), in ? src : blocks, in ? 4 : 0);
          } else {  // 16-bit, bk odd: a pair's second value may be past bk
            const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
            const uint32_t lo = in ? s16[0] : 0u, hi = in && kk + 1 < bk ? s16[1] : 0u;
            *reinterpret_cast<uint32_t*>(a_st + p * 4) = lo | hi << 16;
          }
        }
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

// fp32: the first KR rows of a unit; lane l sums columns 4 l to 4 l + 3
// of the ROWS rows, in acc[row].
template <int ROWS, int KR>
__device__ __forceinline__ void sum_fp32(float (&acc)[ROWS][4], const uint8_t* st, int lane) {
  const float* d = reinterpret_cast<const float*>(st);
  const float* a = reinterpret_cast<const float*>(st + Ring<float, ROWS>::kDenseBytes);
  float4 dv[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    dv[k] = *reinterpret_cast<const float4*>(d + k * kRingCols + 4 * lane);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float4 lo = *reinterpret_cast<const float4*>(a + 8 * r);  // one address: a broadcast
    float4 hi = lo;
    if constexpr (KR > 4) hi = *reinterpret_cast<const float4*>(a + 8 * r + 4);
    const float av[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      acc[r][0] = fmaf(av[k], dv[k].x, acc[r][0]);
      acc[r][1] = fmaf(av[k], dv[k].y, acc[r][1]);
      acc[r][2] = fmaf(av[k], dv[k].z, acc[r][2]);
      acc[r][3] = fmaf(av[k], dv[k].w, acc[r][3]);
    }
  }
}

// warp_blocks: the first KR rows of a unit whose block values are stored
// transposed (column k's ROWS values together), k by k: each k's ROWS x 4
// multiply-adds are independent, and its block values are ROWS / 4
// broadcasts.
template <int ROWS, int KR>
__device__ __forceinline__ void sum_fp32_t(float (&acc)[ROWS][4], const uint8_t* st, int lane) {
  const float* d = reinterpret_cast<const float*>(st);
  const float* a = reinterpret_cast<const float*>(st + Ring<float, ROWS>::kDenseBytes);
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const float4 dv = *reinterpret_cast<const float4*>(d + k * kRingCols + 4 * lane);
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q) {
      const float4 av = *reinterpret_cast<const float4*>(a + k * ROWS + 4 * q);  // a broadcast
      const float v[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float(&c)[4] = acc[4 * q + i];
        c[0] = fmaf(v[i], dv.x, c[0]);
        c[1] = fmaf(v[i], dv.y, c[1]);
        c[2] = fmaf(v[i], dv.z, c[2]);
        c[3] = fmaf(v[i], dv.w, c[3]);
      }
    }
  }
}

// Sum one step into acc.  16-bit (mma_rows, mma_blocks): the step's two
// units as one k16 step of 8 column tiles times ROWS / 8 row tiles; lane
// 4 g + t sums columns g and g + 8 of each 16-column tile, rows 2t and
// 2t + 1 of each 8-row tile, in acc[mt * (ROWS / 8) + nt].  fp32
// (warp_rows, warp_blocks): one unit by sum_fp32 (warp_rows) or
// sum_fp32_t (warp_blocks), its first 4 rows only where k_rows <= 4 (the
// last unit of a block with bk % 8 in 1..4).
template <typename T, int ROWS, bool ANY>
__device__ __forceinline__ void sum_step(float (&acc)[ROWS][4], const uint8_t* st, int k_rows,
                                         int lane) {
  using R = Ring<T, ROWS>;
  if constexpr (sizeof(T) == 2) {
    constexpr int NT = ROWS / 8;
    // B (k x block row): unit h's row 8 nt + lane / 4, values 2 (lane % 4) and + 1
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        b[nt][h] = *reinterpret_cast<const uint32_t*>(st + R::kDenseBytes + h * R::kUnitABytes +
                                                      nt * 128 + lane * 4);
      }
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
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_16816<T>(acc[mt * NT + nt], a, b[nt]);
    }
  } else if constexpr (!ANY) {
    sum_fp32<ROWS, 8>(acc, st, lane);
  } else {
    // the last unit of a block with bk % 8 in 1..4 sums 4 rows, those past bk zero
    k_rows > 4 ? sum_fp32_t<ROWS, 8>(acc, st, lane) : sum_fp32_t<ROWS, 4>(acc, st, lane);
  }
}

// The first `rows` (<= ROWS) rows of the ROWS x 128 output tile whose first
// row is `out_row`, at column n0, rounded once, from the sums as sum_step
// holds them.  fp32 with VEC (n % 4 == 0): a lane's 4 columns are in or out
// together and go as one float4.
template <typename T, int ROWS, bool VEC>
__device__ __forceinline__ void store_rows(const float (&acc)[ROWS][4], T* __restrict__ out,
                                           int64_t out_row, int rows, int n, int n0, int lane) {
  if constexpr (sizeof(T) == 2) {
    constexpr int NT = ROWS / 8;
    T* o = out + out_row * n;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      const int col = n0 + 16 * mt + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * nt + 2 * t + h;
          if (r >= rows) continue;
          if (col < n) o[static_cast<int64_t>(r) * n + col] = from_f32<T>(acc[mt * NT + nt][h]);
          if (col + 8 < n) {
            o[static_cast<int64_t>(r) * n + col + 8] = from_f32<T>(acc[mt * NT + nt][2 + h]);
          }
        }
      }
    }
  } else {
    const int col = n0 + 4 * lane;
    if (VEC && col >= n) return;
    float* o = out + out_row * n + col;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rows) break;
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(o + static_cast<int64_t>(r) * n) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (col + c < n) o[static_cast<int64_t>(r) * n + c] = acc[r][c];
        }
      }
    }
  }
}

// Warp w of program b is warp g = 4 b + w of the grid: it owns dense columns
// [128 (g % n_tiles), +128) of work items g / n_tiles + i n_ranges.  So the
// grid's warps walk the block-rows together, front to back, and the dense
// rows they gather at any time are a window of the operand that the L2
// holds (each warp taking a contiguous run of rows instead spread the
// gather over the whole operand at once; in fp32, at 76 MB, that thrashed
// the 50 MB L2 and the slabs came from device memory).  The groups of one
// block-row are neighbouring items, so they gather its slabs together.
template <typename T, int ROWS, bool VEC, int AC>
__device__ __forceinline__ void ring_rows(const T* __restrict__ blocks,
                                          const int* __restrict__ row_start,
                                          const int* __restrict__ bcols,
                                          const T* __restrict__ dense, T* __restrict__ out,
                                          int m_blocks, const Shape& sh, int n_ranges) {
  using R = Ring<T, ROWS>;
  constexpr bool kAny = AC != kA16;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int lane = threadIdx.x % 32;
  const int warp = blockIdx.x * kRingWarps + threadIdx.x / 32;
  const int n = sh.n;
  const int n_tiles = (n + kRingCols - 1) / kRingCols;
  const int n_items = kAny ? m_blocks * sh.groups : m_blocks;
  const int r0 = warp / n_tiles;
  if (r0 >= n_ranges) return;
  const int n0 = (warp % n_tiles) * kRingCols;
  const int cpb = kAny ? (sh.bk + 7) / 8 : sh.bk / 8;
  uint8_t* ring = smem_raw + (threadIdx.x / 32) * R::kWarpBytes;
  int64_t off[R::kLaneChunks];  // lane chunk i: slab row j, column col
#pragma unroll
  for (int i = 0; i < R::kLaneChunks; ++i) {
    const int q = lane + 32 * i;
    off[i] = static_cast<int64_t>(q / R::kRowChunks) * n + n0 + (q % R::kRowChunks) * R::kPer;
  }
  Walk w{r0 - n_ranges, n_ranges, n_items, 0, 0, 0};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_step<T, ROWS, VEC, AC>(w, ring + s * R::kStageBytes, blocks, row_start, bcols, dense,
                                sh, n0, off, lane);
  }
  int step = 0;
  int c = 0;  // fp32: the k8 unit of its block that `step` sums
  for (int item = r0; item < n_items; item += n_ranges) {
    const int row = kAny ? item / sh.groups : item;
    const int row0 = kAny ? (item % sh.groups) * ROWS : 0;
    const int units = (row_start[row + 1] - row_start[row]) * cpb;
    float acc[ROWS][4];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int u = 0; u < units; u += R::kUnits, ++step) {
      cp_async_wait<kStages - 2>();  // this lane's copies of `step` have landed
      __syncwarp();                  // and every lane's; all are done with step - 1
      load_step<T, ROWS, VEC, AC>(w, ring + ((step + kStages - 1) % kStages) * R::kStageBytes,
                                  blocks, row_start, bcols, dense, sh, n0, off, lane);
      const int k_rows = kAny ? min(8, sh.bk - 8 * c) : 8;  // fp32: kUnits = 1
      if (kAny && ++c == cpb) c = 0;
      sum_step<T, ROWS, kAny>(acc, ring + (step % kStages) * R::kStageBytes, k_rows, lane);
    }
    const int64_t out_row = static_cast<int64_t>(row) * (kAny ? sh.bm : ROWS) + row0;
    store_rows<T, ROWS, VEC>(acc, out, out_row, kAny ? min(ROWS, sh.bm - row0) : ROWS, n, n0,
                             lane);
  }
  cp_async_wait<0>();  // the walk is done: only empty groups are left
}

#define RING_PARAMS                                                                      \
  const T *__restrict__ blocks, const int *__restrict__ row_start,                       \
      const int *__restrict__ bcols, const T *__restrict__ dense, T *__restrict__ out,   \
      int m_blocks, Shape sh, int n_ranges

// bm = 8, bk a multiple of 8: warp_rows (fp32) and mma_rows (bf16, fp16).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kRingWarps * 32, kPrograms) warp_rows(RING_PARAMS) {
  ring_rows<T, 8, VEC, kA16>(blocks, row_start, bcols, dense, out, m_blocks, sh, n_ranges);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kRingWarps * 32, kPrograms) mma_rows(RING_PARAMS) {
  ring_rows<T, 8, VEC, kA16>(blocks, row_start, bcols, dense, out, m_blocks, sh, n_ranges);
}

// Any other block shape: warp_blocks (fp32) and mma_blocks (bf16, fp16).
template <typename T, int ROWS, bool VEC>
__global__ void __launch_bounds__(kRingWarps * 32, kPrograms) warp_blocks(RING_PARAMS) {
  ring_rows<T, ROWS, VEC, kA4>(blocks, row_start, bcols, dense, out, m_blocks, sh, n_ranges);
}

template <typename T, int ROWS, bool VEC, int AC>
__global__ void __launch_bounds__(kRingWarps * 32, kPrograms) mma_blocks(RING_PARAMS) {
  ring_rows<T, ROWS, VEC, AC>(blocks, row_start, bcols, dense, out, m_blocks, sh, n_ranges);
}

#undef RING_PARAMS

struct Args {
  const void* blocks;
  const int* row_start;
  const int* bcols;
  const void* dense;
  void* out;
  int m_blocks, bm, bk, n;
  cudaStream_t stream;
};

// One warp per 128 columns of every n_ranges-th work item, with n_ranges
// such that every warp of the grid is resident at once (kPrograms an SM).
template <typename T, int ROWS, typename Fn>
void launch_ring(Fn kernel, const Args& g) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Ring<T, ROWS>::kSmem) != cudaSuccess) {
    return;  // the error stays in cudaGetLastError() for the caller
  }
  const Shape sh{g.bm, g.bk, g.n, (g.bm + ROWS - 1) / ROWS};
  const int64_t n_items = static_cast<int64_t>(g.m_blocks) * sh.groups;
  const int64_t n_tiles = (g.n + kRingCols - 1) / kRingCols;
  const int64_t resident = static_cast<int64_t>(sms) * kPrograms * kRingWarps;
  const int64_t items_per_warp = (n_items * n_tiles + resident - 1) / resident;
  const int64_t n_ranges = (n_items + items_per_warp - 1) / items_per_warp;
  const int64_t grid = (n_ranges * n_tiles + kRingWarps - 1) / kRingWarps;
  kernel<<<static_cast<unsigned>(grid), kRingWarps * 32, Ring<T, ROWS>::kSmem, g.stream>>>(
      static_cast<const T*>(g.blocks), g.row_start, g.bcols, static_cast<const T*>(g.dense),
      static_cast<T*>(g.out), g.m_blocks, sh, static_cast<int>(n_ranges));
}

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

// 16-byte slab copies need the dense rows and base on 16 bytes; fp32's
// float4 stores need the output there too.
template <typename T>
bool dense_vec(const Args& g) {
  return (static_cast<int64_t>(g.n) * sizeof(T)) % 16 == 0 && aligned(g.dense, 16) &&
         aligned(g.out, 16);
}

// The rows a work item holds: fp32 to a multiple of 4 up to 16, 16-bit to
// one or two n8 tiles; taller blocks go in groups of 16.
template <typename T>
int group_rows(int bm) {
  if constexpr (sizeof(T) == 4) {
    return bm <= 4 ? 4 : bm <= 8 ? 8 : bm <= 12 ? 12 : 16;
  } else {
    return bm <= 8 ? 8 : 16;
  }
}

template <typename T, int ROWS>
void launch_blocks(const Args& g, bool vec) {
  if constexpr (sizeof(T) == 4) {
    vec ? launch_ring<T, ROWS>(warp_blocks<T, ROWS, true>, g)
        : launch_ring<T, ROWS>(warp_blocks<T, ROWS, false>, g);
  } else {
    // 4-byte pairs need bk even and the blocks' base on 4 bytes
    const bool a4 = g.bk % 2 == 0 && aligned(g.blocks, 4);
    if (a4) {
      vec ? launch_ring<T, ROWS>(mma_blocks<T, ROWS, true, kA4>, g)
          : launch_ring<T, ROWS>(mma_blocks<T, ROWS, false, kA4>, g);
    } else {
      vec ? launch_ring<T, ROWS>(mma_blocks<T, ROWS, true, kASync>, g)
          : launch_ring<T, ROWS>(mma_blocks<T, ROWS, false, kASync>, g);
    }
  }
}

template <typename T>
int run(int kernel, const Args& g) {
  const bool vec = dense_vec<T>(g);
  if (kernel == kWarpRows || kernel == kMmaRows) {
    // block values in 16-byte chunks: the blocks' base on 16 bytes too
    const bool v = vec && aligned(g.blocks, 16);
    if constexpr (sizeof(T) == 4) {
      v ? launch_ring<T, 8>(warp_rows<T, true>, g) : launch_ring<T, 8>(warp_rows<T, false>, g);
    } else {
      v ? launch_ring<T, 8>(mma_rows<T, true>, g) : launch_ring<T, 8>(mma_rows<T, false>, g);
    }
  } else {
    switch (group_rows<T>(g.bm)) {
      case 4:
        if constexpr (sizeof(T) == 4) launch_blocks<T, 4>(g, vec);
        break;
      case 8:
        launch_blocks<T, 8>(g, vec);
        break;
      case 12:
        if constexpr (sizeof(T) == 4) launch_blocks<T, 12>(g, vec);
        break;
      default:
        launch_blocks<T, 16>(g, vec);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches `kernel` on the shapes the wrapper's route gives it (0 warp_rows:
// float32 with bm = 8 and bk a multiple of 8; 1 mma_rows: bfloat16 or
// float16 with bm = 8 and bk a multiple of 8; 2 warp_blocks: float32, any
// other shape; 3 mma_blocks: bfloat16 or float16, any other shape).
// blocks: (nb, bm, bk) sorted by block-row; row_start: int32, m_blocks + 1
// offsets into the blocks; bcols: int32 per block; dense: (K, n); out:
// (m_blocks * bm, n); dtype (all three): 0 = float32, 1 = bfloat16,
// 2 = float16.  Returns cudaErrorInvalidValue for a shape or type the
// kernel does not take, else cudaGetLastError() after the launch (0 on
// success); the wrapper raises on anything else.
extern "C" int repro_bsr_spmm(int kernel, const void* blocks, const void* row_start,
                              const void* bcols, const void* dense, void* out, int m_blocks,
                              int bm, int bk, int n, int dtype, void* stream) {
  if (m_blocks < 0 || bm < 1 || bk < 1 || n < 0 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool ring_shape = bm == 8 && bk % 8 == 0;
  const bool fp32 = dtype == 0;
  switch (kernel) {
    case kWarpRows:
      if (!ring_shape || !fp32) return static_cast<int>(cudaErrorInvalidValue);
      break;
    case kMmaRows:
      if (!ring_shape || fp32) return static_cast<int>(cudaErrorInvalidValue);
      break;
    case kWarpBlocks:
      if (ring_shape || !fp32) return static_cast<int>(cudaErrorInvalidValue);
      break;
    case kMmaBlocks:
      if (ring_shape || fp32) return static_cast<int>(cudaErrorInvalidValue);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  // work items (a block-row's groups of 4 or more rows) must count in an int
  if (static_cast<int64_t>(m_blocks) * ((bm + 3) / 4) > INT32_MAX) {
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
