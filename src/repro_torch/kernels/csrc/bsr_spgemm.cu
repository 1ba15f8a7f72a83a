// BSR x BSR SpGEMM over a pair list grouped into runs, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bsr_spgemm.py:_kernel (reached through
// _bsr_spgemm_jit, bsr_spgemm and bsr_spgemm_local).  It computes
//     C[run_c[r]] = sum over pairs i in [run_start[r], run_start[r+1]) of
//                   A[pair_a[i]] @ B[pair_b[i]]
// with (bm, bk) A blocks and (bk, bn) B blocks of any size, fp32
// accumulation, and the result written in the inputs' type.  The TPU kernel
// walks the pair list on a sequential grid and revisits one output tile per
// run of equal pair_c.  A Hopper grid runs in parallel and in no order, so
// the host hands over the run offsets once
// (repro_torch.kernels.bsr_spgemm.pair_runs), and every C tile of a run
// belongs to one warp or one program: no atomics, no cross-block reduction,
// and the same sum order on every call.  C blocks that no run touches keep
// the zeros the wrapper allocates (scalar_runs writes them itself).
//
// What bounds it: memory traffic and latency at small blocks, arithmetic at
// large ones.  Four kernels, one per regime, picked by the wrapper before
// launch (repro_torch.kernels.bsr_spgemm.route):
//   - scalar_runs, (1, 1, 1): bound by bytes (each pair reads its two
//     indices, 8 bytes, from device memory and two values, mostly from L2;
//     27-AP at n = 63: 28.9 M pairs in 2.9 M runs, ~300 MB), and by the
//     runs' uneven lengths: the MCL squares of the paper's Sec. 6.3 hold
//     hub runs of 200 to 500 pairs among runs of one or two.  So the work
//     is split by pairs, not by runs: each warp takes a fixed span of
//     pairs (one span for each warp the card holds at once) and owns the
//     runs that start in it, reading on past its end to finish its last.
//     The sum order is a run's own, whatever its place in the pair list,
//     so a run sums to the same bits in a batched launch (m copies of the
//     lists), in one rank's launch and in the one-process launch of all
//     ranks: a run is cut into groups of kGroup = 4 pairs from its start,
//     a lane adds a group's products in order, the groups of a piece (32
//     groups, 128 pairs, from the run's start) are summed within the warp
//     by shuffles (lane j adds lane j + 1, 2, 4, 8, 16 of its piece where
//     that lies in the piece; the sum ends on the piece's first lane), and
//     a run's pieces are added in order.  The warp walks its runs in
//     windows of 32 groups: a window starts on a piece's first pair, takes
//     that piece and then the whole runs after it whose groups fit in the
//     lanes left (one coalesced load of the next 32 run ends, a scan of
//     their group counts and a mask of where each run's lanes start,
//     __reduce_or_sync), so a run of one pair takes a lane and a hub run a
//     window a piece, carrying its sum so far in a register.  The next
//     window's run ends and C slots are in flight while this one is summed.
//     No atomics and nothing shared between warps.  Every C slot is written
//     (the zeros before each run by its owner, long gaps by the whole warp,
//     the slots after the last run by its owner), so the wrapper allocates
//     C without a fill.  Runs are non-empty and their C slots ascending, as
//     pair_runs makes them.  It replaces the first design, one thread a
//     run, whose warps waited on their longest run and whose lanes read
//     their indices 1 to 49 pairs apart.  Against it (PERF.md, by
//     tools/time_k1_scalar.py, one card and call): faster where runs are
//     long or launches small (27-AP n = 42 monoC, rank 0 of 27-PTAP,
//     MCL-dip 0.2), level at 27-AP n = 63, slower where runs average one
//     or two pairs over millions of runs (MCL-facebook at scale 1, the
//     batched LP lists): there a window holds 32 runs and little else, and
//     its scan, masks and shuffles cost more than one thread's short loop
//     did.  Tried and slower: a pair a lane (every pair through the shuffles), 8 pairs
//     a group, the next window's indices copied ahead by cp.async, and 32
//     registers a thread.
//   - warp_runs, bm, bn <= 16 and bk <= 16: bound by bytes (at b = 16 the
//     block16-4096 product moves 48 MB and does 0.36 GFLOP, 5 us on the CUDA
//     cores), and by latency: its 44,048 pairs fall into 32,207 runs, 1.4
//     pairs a run, so one program per run holds one dependent chain (run
//     offsets, pair indices, block loads, a 16 x 16 x 16 product) and little
//     else in flight.  Here a warp owns 2 consecutive runs and a program 4
//     warps (small programs spread the runs' uneven lengths over the SMs
//     best of the sizes tried): the warp reads its run offsets and C slots
//     in one coalesced load and its pair indices 32 at a time, and walks
//     its runs' pairs as one stream.  Each lane keeps one C row's 8 (or, up to 8 x 8, 2)
//     columns in fp32 registers and the A row it needs; the B block goes
//     through the warp's own 1 KB of shared memory.  While a pair is summed,
//     the next pair's A rows and B block (next run's too) are already in
//     flight in registers, as 16-byte loads where the rows allow.  A C block
//     is written 16 (or 8) bytes a lane, whole 32-byte sectors an
//     instruction.  Warps meet only at __syncwarp.  fp32 FMAs on the CUDA cores: the products
//     are exact as the reference's.
//   - mma_runs, max(bm, bn) > 32: bound by operations.  A program owns a
//     64 x 64 C tile of one run and one warpgroup sums the whole run in
//     fp32 wgmma accumulators (m64n64k16), 64 of k a step.  Each step's A
//     and B tiles are loaded into registers two steps ahead (two register
//     buffers, two shared-memory stages; their pair indices a step before
//     that, so no load waits on an index), then written in the
//     128-byte-swizzled layout wgmma reads while the tensor cores work on
//     the step before.  Every pair's blocks are read from L2 again (32 KB
//     a pair at 64 x 64 fp32), so keeping those reads in flight sets the
//     pace.  bf16 and fp16 tiles go in as
//     they are.  fp32 tiles are split on the way (hopper.cuh's split3:
//     v == v0 + v1 + v2 in bf16, exactly) and each k16 step runs the six
//     products x_i y_j with i + j <= 2, the five small ones into
//     accumulators of their own: fp32-accurate sums (two pieces would keep
//     16 significant bits and fail 1e-4 on runs of 20 N(0, 1) pairs).  The
//     bound is then the fp32-accurate tensor-core peak, 6 bf16 products at
//     989 TFLOP/s.
//   - tile_runs, everything else (a side of 17 to 32, or bk > 16 with bm
//     and bn at most 16): bound by operations in fp32 (the retiled-32
//     product: 75,424 pairs of 32 x 32 x 32 in 16,257 runs, 4.6 pairs a run;
//     its multiply-adds take 0.074 ms at 67 TFLOP/s, its pair reads 0.62
//     GB from L2).  A program is one warp and owns 2 consecutive runs (run
//     chunks in reverse, as warp_runs; one-warp programs let the block
//     scheduler even out the runs' uneven lengths, where 4-warp programs
//     waited on their slowest warp); the warp keeps a run's C tile,
//     SIDE x SIDE with SIDE = 16 or 32, in fp32 registers (32 sums a lane
//     at 32) and walks its runs' pairs as one stream of steps, a step being
//     one pair's k-slice of 128 bytes of A row (32 fp32 or 64 16-bit
//     values) and the matching B rows.  Its own ring of 2 stages in shared
//     memory (8 KB a stage at SIDE 32) keeps the next step's A and B
//     slices in flight by cp.async while it sums the current one (16 bytes
//     a lane where the rows allow, 4 otherwise; rows past bm and bk and
//     columns past bn zero-filled by the source size, reading nothing; a
//     step is 1,024 multiply-adds a lane at 32 x 32 x 32, long enough to
//     cover the copy: 3 stages, or 2 and 4 runs a warp, or 2 and 4 warps a
//     program were slower), and the pair indices come 32 at a time
//     a batch ahead, so no copy waits on an index; warps meet only at
//     __syncwarp.  fp32: FMAs on the CUDA cores, a lane holding SIDE / 8
//     rows by SIDE / 4 columns; A's 16-byte chunks are XOR-swizzled by the
//     reading lanes' row group so their float4 reads hit distinct banks, and
//     B rows are read as float4 broadcasts.  bf16 and fp16: mma.sync
//     m16n8k16 with fp32 accumulators (exact products), A by ldmatrix and B
//     by ldmatrix.trans from chunks swizzled for them.  C is written from
//     registers, 32 bytes a lane a row in fp32.  It replaces block_runs, the
//     port's first design (a program of 256 threads per run and C tile,
//     each pair staged in slices of 16 between two block-wide barriers, so
//     every pair was a dependent chain: 0.43 ms on the retiled-32 product,
//     H100 80GB HBM3 at 700 W, per chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kMaxTiles = 65535;  // gridDim.y
// the kernels, as the wrapper numbers them (repro_torch.kernels.bsr_spgemm.KERNELS)
enum Kernel { kScalar = 0, kWarp = 1, kTile = 2, kMma = 3 };
constexpr unsigned kAll = 0xffffffffu;

// ---------------------------------------------------------------- scalar_runs

constexpr int kScalarWarps = 4;        // warps a program
constexpr int kGroup = 4;              // pairs a lane adds in order, counted from its run's start
constexpr int kPiece = 32 * kGroup;    // pairs of a run summed as one piece: a group a lane
constexpr int kMinSpan = 64;           // fewest pairs a warp's span holds
constexpr int kShortGap = 64;          // C slots a lane zeroes alone before its run

// The first run whose start is >= q (run_start[n_runs] = n_pairs >= q), by
// a 32-way search of the warp: a few dependent loads for millions of runs.
__device__ __forceinline__ int first_run_at(const int* __restrict__ run_start, int n_runs, int q,
                                            int lane) {
  int lo = 0, hi = n_runs;  // the run is in [lo, hi]
  while (hi - lo > 32) {
    const int k = lo + static_cast<int>(static_cast<int64_t>(lane + 1) * (hi - lo) / 33);
    const int below = __popc(__ballot_sync(kAll, run_start[k] < q));
    const int k_lo = __shfl_sync(kAll, k, max(below - 1, 0));
    const int k_hi = __shfl_sync(kAll, k, min(below, 31));
    lo = below > 0 ? k_lo + 1 : lo;
    hi = below < 32 ? k_hi : hi;
  }
  const int k = lo + lane;
  return lo + __popc(__ballot_sync(kAll, k < hi && run_start[k] < q));
}

// Zeros into out[z0, z1) of every lane, written by the whole warp.
template <typename T>
__device__ __forceinline__ void zero_slots(T* __restrict__ out, int z0, int z1, int lane) {
  for (unsigned m = __ballot_sync(kAll, z1 > z0); m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const int lo = __shfl_sync(kAll, z0, src), hi = __shfl_sync(kAll, z1, src);
    for (int z = lo + lane; z < hi; z += 32) out[z] = from_f32<T>(0.f);
  }
}

// The end and C slot of run r0 + lane (INT_MAX and -1 past the last run).
__device__ __forceinline__ void load_runs(const int* __restrict__ run_start,
                                          const int* __restrict__ run_c, int r0, int n_runs,
                                          int lane, int& e, int& c) {
  const int r = r0 + lane;
  e = r < n_runs ? __ldg(run_start + r + 1) : INT_MAX;
  c = r < n_runs ? __ldg(run_c + r) : -1;
}

// (1, 1, 1).  Warp w owns the runs that start in its span [w span, (w + 1)
// span) and walks them in windows of 32 groups, a group a lane: a window
// starts at p0, the first pair of a piece of run r0 (start0: r0's first
// pair; carry: r0's pieces before p0, summed in order), takes that piece
// and then the whole runs after it whose groups fit in the lanes left.
// Lane k first holds the end and C slot of run r0 + k.
template <typename T>
__global__ void __launch_bounds__(kScalarWarps * 32)
    scalar_runs(const T* __restrict__ a, const T* __restrict__ b,
                const int* __restrict__ pair_a, const int* __restrict__ pair_b,
                const int* __restrict__ run_start, const int* __restrict__ run_c,
                T* __restrict__ out, int n_runs, int n_pairs, int n_c, int span) {
  const int lane = threadIdx.x % 32;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kScalarWarps + threadIdx.x / 32;
  if (w * span >= n_pairs) return;
  const int s0 = static_cast<int>(w * span);
  const int s1 = static_cast<int>(w * span + span < n_pairs ? w * span + span : n_pairs);
  int r0 = first_run_at(run_start, n_runs, s0, lane);
  if (r0 >= n_runs) return;
  int p0 = __ldg(run_start + r0);
  if (p0 >= s1) return;  // no run starts in the span
  const unsigned upto_lane = (2u << lane) - 1u;  // lanes 0..lane (all at 31)
  int start0 = p0;
  int prev_c = r0 > 0 ? __ldg(run_c + r0 - 1) : -1;  // the C slot of the run before r0
  float carry = 0.f;
  int e, c;
  load_runs(run_start, run_c, r0, n_runs, lane, e, c);
  for (;;) {
    // run r0 + k here: pairs [s, e) of it, its groups in this window (one
    // piece at most), for the runs this warp owns: r0 .. r0 + k_stop
    const unsigned stops = __ballot_sync(kAll, !(r0 + lane + 1 < n_runs && e < s1));
    const int k_stop = stops ? __ffs(stops) - 1 : 32;
    const int e_up = __shfl_up_sync(kAll, e, 1);
    const int s = lane ? e_up : p0;
    const bool owned = lane <= k_stop;
    const int groups = owned ? (min(e - s, kPiece) + kGroup - 1) / kGroup : 0;
    int upto = groups;  // the groups of runs r0 .. r0 + k
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int t = __shfl_up_sync(kAll, upto, off);
      if (lane >= off) upto += t;
    }
    // the window takes r0's piece and the runs after it whose groups fit
    // (a run longer than a piece never fits after another)
    const int last = __popc(__ballot_sync(kAll, owned && upto <= 32)) - 1;
    const int used = __shfl_sync(kAll, upto, last);
    const int e_last = __shfl_sync(kAll, e, last), s_last = __shfl_sync(kAll, s, last);
    const bool last_ends = e_last - s_last <= kPiece;  // else last == 0: r0 runs on
    const bool done = last == k_stop && last_ends;
    const int p1 = last_ends ? e_last : p0 + kPiece;
    const int r1 = last_ends ? r0 + last + 1 : r0;
    // the next window's runs, in flight while this one is summed
    int e1 = 0, c1 = 0;
    if (!done) load_runs(run_start, run_c, r1, n_runs, lane, e1, c1);
    // this lane's group: run r0 + m's group gi, pairs [q, q_end)
    const unsigned firsts = __reduce_or_sync(kAll, lane < last ? 1u << upto : 0u) | 1u;
    const unsigned mine = firsts & upto_lane;
    const int m = __popc(mine) - 1;
    const int gi = lane - (31 - __clz(mine));
    const int sm = __shfl_sync(kAll, s, m), em = __shfl_sync(kAll, e, m);
    const int len = __shfl_sync(kAll, groups, m);  // the piece's groups
    const bool in = lane < used;
    const int q = sm + kGroup * gi, q_end = min(em, q + kGroup);
    float v = 0.f;
    if (in) {
      int ia[kGroup], ib[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        ia[i] = q + i < q_end ? __ldcs(pair_a + q + i) : 0;
        ib[i] = q + i < q_end ? __ldcs(pair_b + q + i) : 0;
      }
      v = __fmul_rn(to_f32(a[ia[0]]), to_f32(b[ib[0]]));
#pragma unroll
      for (int i = 1; i < kGroup; ++i) {
        if (q + i < q_end) v = __fadd_rn(v, __fmul_rn(to_f32(a[ia[i]]), to_f32(b[ib[i]])));
      }
    }
    // the piece's sum, within the warp: lane gi adds lane gi + off of its piece
    const int longest = __reduce_max_sync(kAll, in ? len : 0);
    for (int off = 1; off < longest; off *= 2) {
      const float t = __shfl_down_sync(kAll, v, off);
      if (gi + off < len) v = __fadd_rn(v, t);
    }
    // a piece's first lane adds it to its run's sum and writes a run that ends
    const bool head = in && gi == 0;
    const bool opens = head && (m > 0 || p0 == start0);  // the run's first piece
    const float sum = head && !opens ? __fadd_rn(carry, v) : v;
    const int slot = __shfl_sync(kAll, c, m);
    const int c_before = __shfl_sync(kAll, c, max(m - 1, 0));
    const int before = m > 0 ? c_before : prev_c;
    if (head && em - sm <= kPiece) out[slot] = from_f32<T>(sum);
    // the zeros of the C slots between the run before and this one
    const bool long_gap = opens && slot - before > kShortGap;
    if (opens && !long_gap) {
      for (int z = before + 1; z < slot; ++z) out[z] = from_f32<T>(0.f);
    }
    if (__any_sync(kAll, long_gap)) {
      zero_slots(out, long_gap ? before + 1 : 0, long_gap ? slot : 0, lane);
    }
    const int c_last = __shfl_sync(kAll, c, last);
    if (done) {
      // the last run of all: the slots after it are its owner's
      if (r0 + last == n_runs - 1) zero_slots(out, lane ? 0 : c_last + 1, lane ? 0 : n_c, lane);
      return;
    }
    const float sum0 = __shfl_sync(kAll, sum, 0);
    if (last_ends) {  // the next window starts run r1
      start0 = p1;
      prev_c = c_last;
      carry = 0.f;
    } else {  // r0 runs on: its sum so far
      carry = sum0;
    }
    p0 = p1, r0 = r1, e = e1, c = c1;
  }
}

// ------------------------------------------------------------------ warp_runs

// N (2 or 4) consecutive fp32 sums rounded to T and stored at once (N
// elements of T, aligned to their size).
template <int N, typename T>
__device__ __forceinline__ void store_cols(T* dst, const float* v) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    }
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack2<T>(v[0], v[1]), pack2<T>(v[2], v[3]));
  } else {
    *reinterpret_cast<uint32_t*>(dst) = pack2<T>(v[0], v[1]);
  }
}

constexpr int kWarpRunsWarps = 4;  // warps a program
constexpr int kRunsPerWarp = 2;    // consecutive runs a warp owns
constexpr int kSmallK = 16;        // the largest bk warp_runs takes

// Warp w of program b owns runs [(4 c + w) 2, +2), c = gridDim.x - 1 - b.
// Lane l keeps row l / LPR of the C block (SIDE >= bm, bn) and CPL of its
// columns: at SIDE 16, [4 (l % 2), +4) and [8 + 4 (l % 2), +4), so that two
// neighbouring lanes' 16-byte stores fill whole 32-byte sectors; at SIDE 8,
// [2 (l % 4), +2).
// VEC: A rows and B blocks move in 16-byte vectors (rows of bk and of bn
// are whole vectors, data 16-byte aligned); else element by element.
template <typename T, int SIDE, bool VEC>
__global__ void __launch_bounds__(kWarpRunsWarps * 32)
    warp_runs(const T* __restrict__ a, const T* __restrict__ b,
              const int* __restrict__ pair_a, const int* __restrict__ pair_b,
              const int* __restrict__ run_start, const int* __restrict__ run_c,
              T* __restrict__ out, int n_runs, int bm, int bk, int bn) {
  constexpr int CPL = SIDE * SIDE / 32;  // C columns a lane: 8 (SIDE 16) or 2 (SIDE 8)
  constexpr int LPR = SIDE / CPL;        // lanes a C row
  constexpr int V = 16 / sizeof(T);      // elements a 16-byte vector
  // 16-byte registers that hold a lane's share of a B block (of <= 16 x SIDE)
  constexpr int NB = SIDE * sizeof(T) / 32 > 0 ? SIDE * sizeof(T) / 32 : 1;
  __shared__ __align__(16) float b_s[kWarpRunsWarps][kSmallK][SIDE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // programs start roughly in blockIdx order, and the last C slot (a
  // padding sink) may own the longest run: the last runs go first
  const int chunk = gridDim.x - 1 - blockIdx.x;
  const int r0 = (chunk * kWarpRunsWarps + warp) * kRunsPerWarp;
  if (r0 >= n_runs) return;
  const int nr = min(kRunsPerWarp, n_runs - r0);
  // the warp's run offsets and C slots: one coalesced load
  const int rs = lane <= nr ? run_start[r0 + lane] : 0;
  const int rc = lane < nr ? run_c[r0 + lane] : 0;
  const int p_end = __shfl_sync(kAll, rs, nr);
  const int row = lane / LPR;
  const int c0 = CPL == 8 ? 4 * (lane % 2) : (lane % LPR) * CPL;  // first column
  auto col = [&](int j) { return CPL == 8 ? c0 + 8 * (j / 4) + j % 4 : c0 + j; };
  const int64_t a_size = static_cast<int64_t>(bm) * bk;
  const int64_t b_size = static_cast<int64_t>(bk) * bn;
  const int a_vecs = bk / V, b_vecs = bk * bn / V, row_vecs = bn / V;  // VEC only
  float(&bw)[kSmallK][SIDE] = b_s[warp];

  int p = __shfl_sync(kAll, rs, 0);
  int idx_base = p, pa_l = 0, pb_l = 0;  // pair indices idx_base + lane
  uint4 a_raw[kSmallK * sizeof(T) / 16];  // the next pair's A row (bk <= 16 values)
  uint4 b_raw[NB];                        // the next pair's B block, this lane's share
  auto fetch_indices = [&]() {
    const int q = idx_base + lane;
    pa_l = q < p_end ? pair_a[q] : 0;
    pb_l = q < p_end ? pair_b[q] : 0;
  };
  // issue the loads of pair q's blocks (q - idx_base <= 32)
  auto fetch_blocks = [&](int q) {
    if (q - idx_base == 32) {
      idx_base = q;
      fetch_indices();
    }
    const T* a_blk = a + __shfl_sync(kAll, pa_l, q - idx_base) * a_size;
    const T* b_blk = b + __shfl_sync(kAll, pb_l, q - idx_base) * b_size;
    if constexpr (VEC) {
      const uint4* a_row = reinterpret_cast<const uint4*>(a_blk + row * bk);
#pragma unroll
      for (int v = 0; v < kSmallK * static_cast<int>(sizeof(T)) / 16; ++v) {
        if (row < bm && v < a_vecs) a_raw[v] = a_row[v];
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int v = lane + 32 * i;
        if (v < b_vecs) b_raw[i] = reinterpret_cast<const uint4*>(b_blk)[v];
      }
    } else {
      T* a_el = reinterpret_cast<T*>(a_raw);
      T* b_el = reinterpret_cast<T*>(b_raw);
#pragma unroll
      for (int k = 0; k < kSmallK; ++k) {
        if (row < bm && k < bk) a_el[k] = a_blk[row * bk + k];
      }
#pragma unroll
      for (int i = 0; i < SIDE / 2; ++i) {
        const int e = lane + 32 * i;
        if (e < b_size) b_el[i] = b_blk[e];
      }
    }
  };

  fetch_indices();
  fetch_blocks(p);
  int run = 0, run_end = __shfl_sync(kAll, rs, 1);
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  for (; p < p_end; ++p) {
    // stage the fetched pair: B into the warp's shared memory, A into fp32 registers
    __syncwarp();  // the previous pair's reads of bw are done
    const T* b_el = reinterpret_cast<const T*>(b_raw);
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int v = lane + 32 * i;
        if (v < b_vecs) {
          const int k = v / row_vecs, n = (v % row_vecs) * V;
#pragma unroll
          for (int q = 0; q < V; ++q) bw[k][n + q] = to_f32(b_el[i * V + q]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < SIDE / 2; ++i) {
        const int e = lane + 32 * i;
        if (e < b_size) bw[e / bn][e % bn] = to_f32(b_el[i]);
      }
    }
    float a_row[kSmallK];
    const T* a_el = reinterpret_cast<const T*>(a_raw);
#pragma unroll
    for (int k = 0; k < kSmallK; ++k) a_row[k] = to_f32(a_el[k]);
    __syncwarp();
    if (p + 1 < p_end) fetch_blocks(p + 1);  // in flight while this pair is summed
    if (row < bm) {
#pragma unroll
      for (int k = 0; k < kSmallK; ++k) {
        if (k < bk) {
          float bv[CPL];
          if constexpr (CPL == 8) {
            const float4 b0 = *reinterpret_cast<const float4*>(&bw[k][c0]);
            const float4 b1 = *reinterpret_cast<const float4*>(&bw[k][c0 + 8]);
            bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
            bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
          } else {
            const float2 b0 = *reinterpret_cast<const float2*>(&bw[k][c0]);
            bv[0] = b0.x, bv[1] = b0.y;
          }
#pragma unroll
          for (int j = 0; j < CPL; ++j) acc[j] = fmaf(a_row[k], bv[j], acc[j]);
        }
      }
    }
    if (p + 1 == run_end) {  // the run is summed: write its C block
      T* c = out + __shfl_sync(kAll, rc, run) * static_cast<int64_t>(bm) * bn + row * bn;
      if (row < bm && bn == SIDE) {  // whole rows: runs of 4 (or 2) columns at once
        constexpr int kRun = CPL == 8 ? 4 : 2;
#pragma unroll
        for (int j = 0; j < CPL; j += kRun) store_cols<kRun>(c + col(j), acc + j);
      } else if (row < bm) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          if (col(j) < bn) c[col(j)] = from_f32<T>(acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
      do {  // empty runs (none from pair_runs) keep their zeros
        ++run;
        run_end = __shfl_sync(kAll, rs, run + 1);
      } while (run < nr && run_end == p + 1);
    }
  }
}

// ------------------------------------------------------------------ tile_runs

constexpr int kTileRuns = 2;    // consecutive runs a program (one warp) owns
constexpr int kTileStages = 2;  // a warp's ring: 1 step in flight while 1 is summed
// (on the retiled-32 product, 1, 2 and 4 warps a program, 1 to 8 runs a
// warp and 2 or 3 stages were all within a fifth of each other; one warp,
// 2 runs and 2 stages the fastest)

// How tile_runs copies blocks into its ring: 16-byte cp.async (rows of bk
// and of bn on 16 bytes), 4-byte cp.async (fp32, or 16-bit pairs with bk
// and bn even), plain loads (16-bit with bk or bn odd).
enum TileCopy { kT16 = 0, kT4 = 1, kTSync = 2 };

// A program's (one warp's) ring for a C tile of SIDE x SIDE: 16 KB at
// SIDE 32, under the 48 KB a launch may ask for unattributed.  A stage holds
// a step: SIDE rows of kKs A values (128 bytes a row), then kKs rows of
// SIDE B values.
template <typename T, int SIDE>
struct Tile {
  static constexpr int kEs = static_cast<int>(sizeof(T));
  static constexpr int kKs = 128 / kEs;      // k a step
  static constexpr int kABytes = SIDE * 128;
  static constexpr int kBRowBytes = SIDE * kEs;
  static constexpr int kStageBytes = kABytes + kKs * kBRowBytes;
  static constexpr int kSmem = kTileStages * kStageBytes;
  static_assert(kSmem <= 48 * 1024, "the launch asks for no more shared memory");
  static constexpr int kAcc = SIDE * SIDE / 128;  // a lane's sums, in fours
  static constexpr int kRM = SIDE / 8, kCN = SIDE / 4;  // fp32: a lane's C rows, columns
  static constexpr int kMT = SIDE / 16, kNT = SIDE / 8;  // 16-bit: m16 and n8 tiles
};

// Byte offset of 16-byte chunk c of A row m in a stage.  fp32 rows are read
// as float4 by the lanes of 8 row groups (m / kRM) at one chunk, 16-bit rows
// by ldmatrix, 8 consecutive rows at one chunk: XOR the chunk with that key
// and those 8 reads hit 8 distinct bank groups.
template <typename T, int SIDE>
__device__ __forceinline__ int a_offset(int m, int c) {
  const int key = sizeof(T) == 4 ? m / Tile<T, SIDE>::kRM : m;
  return m * 128 + ((c ^ key) & 7) * 16;
}

// Byte offset of 16-byte chunk c of B row k in a stage.  fp32 rows are
// read in order (float4 broadcasts); 16-bit rows by ldmatrix.trans, 8
// consecutive rows at one chunk, so the chunk is XORed with the row's place
// among the rows whose bytes share a 128-byte line's banks.
template <typename T, int SIDE>
__device__ __forceinline__ int b_offset(int k, int c) {
  constexpr int kRB = Tile<T, SIDE>::kBRowBytes;
  if constexpr (sizeof(T) == 2) {
    constexpr int kLine = 128 / kRB, kChunks = kRB / 16;  // rows a line, chunks a row
    c ^= (k / kLine) % kChunks;
  }
  return Tile<T, SIDE>::kABytes + k * kRB + c * 16;
}

// 4 bytes at dst: the value (fp32) or pair (16-bit) at src where `in` (and,
// for kTSync, its second value where `in2`), else zero.
template <typename T, int CP>
__device__ __forceinline__ void copy_piece(uint8_t* dst, const T* src, bool in, bool in2,
                                           const T* safe) {
  if constexpr (CP == kT4) {
    cp_async4(smem_u32(dst), in ? src : safe, in ? 4 : 0);
  } else {
    const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
    const uint32_t lo = in ? s16[0] : 0u, hi = in2 ? s16[1] : 0u;
    *reinterpret_cast<uint32_t*>(dst) = lo | hi << 16;
  }
}

// One step into stage st: A rows [0, SIDE) at columns [k0, k0 + kKs) and B
// rows [k0, k0 + kKs) at columns [0, SIDE), zero past bm, bk and bn.
template <typename T, int SIDE, int CP>
__device__ __forceinline__ void copy_step(uint8_t* st, const T* a_blk, const T* b_blk, int k0,
                                          int bm, int bk, int bn, int lane) {
  using L = Tile<T, SIDE>;
  if constexpr (CP == kT16) {
    constexpr int kPer = 16 / L::kEs, kBChunks = L::kBRowBytes / 16;
#pragma unroll
    for (int i = 0; i < SIDE * 8 / 32; ++i) {  // A: SIDE rows of 8 chunks
      const int q = lane + 32 * i, m = q / 8, c = q % 8, kk = k0 + c * kPer;
      const bool in = m < bm && kk < bk;  // bk % kPer == 0: whole chunks
      cp_async16(smem_u32(st + a_offset<T, SIDE>(m, c)), in ? a_blk + m * bk + kk : a_blk,
                 in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < L::kKs * kBChunks / 32; ++i) {  // B: kKs rows of kBChunks
      const int q = lane + 32 * i, k = q / kBChunks, c = q % kBChunks, nn = c * kPer;
      const bool in = k0 + k < bk && nn < bn;
      cp_async16(smem_u32(st + b_offset<T, SIDE>(k, c)),
                 in ? b_blk + static_cast<int64_t>(k0 + k) * bn + nn : b_blk, in ? 16 : 0);
    }
  } else {
    constexpr int kEl = 4 / L::kEs, kBPieces = L::kBRowBytes / 4;  // values a piece, B row's pieces
#pragma unroll 4
    for (int m = 0; m < SIDE; ++m) {  // A: row m, piece `lane` (32 pieces a row)
      const int kk = k0 + lane * kEl;
      const bool in = m < bm && kk < bk;
      copy_piece<T, CP>(st + a_offset<T, SIDE>(m, lane / 4) + (lane % 4) * 4, a_blk + m * bk + kk,
                        in, in && kk + 1 < bk, a_blk);
    }
#pragma unroll 4
    for (int i = 0; i < L::kKs * kBPieces / 32; ++i) {
      const int q = lane + 32 * i, k = q / kBPieces, pp = q % kBPieces, nn = pp * kEl;
      const bool in = k0 + k < bk && nn < bn;
      copy_piece<T, CP>(st + b_offset<T, SIDE>(k, pp / 4) + (pp % 4) * 4,
                        b_blk + static_cast<int64_t>(k0 + k) * bn + nn, in, in && nn + 1 < bn,
                        b_blk);
    }
  }
}

// Where a warp's stream of steps stands: its next step to load is k-slice
// c of pair p (< end); lane l holds the indices of pair base + l, and of
// base + 32 + l in the *_next registers, loaded a batch ahead.
struct PairWalk {
  int p, c, end, base, pa, pb, pa_next, pb_next;
};

// Stage the next step of `w` into `st` (nothing once the pairs are done)
// and commit it as one cp.async group, so that groups and steps stay paired.
template <typename T, int SIDE, int CP>
__device__ __forceinline__ void load_tile_step(PairWalk& w, uint8_t* st, const T* __restrict__ a,
                                               const T* __restrict__ b,
                                               const int* __restrict__ pair_a,
                                               const int* __restrict__ pair_b, int bm, int bk,
                                               int bn, int cks, int lane) {
  if (w.p < w.end) {
    if (w.p - w.base == 32) {  // the next batch, and the one after it in flight
      w.base += 32;
      w.pa = w.pa_next;
      w.pb = w.pb_next;
      const int q = w.base + 32 + lane;
      w.pa_next = q < w.end ? pair_a[q] : 0;
      w.pb_next = q < w.end ? pair_b[q] : 0;
    }
    const int ia = __shfl_sync(kAll, w.pa, w.p - w.base);
    const int ib = __shfl_sync(kAll, w.pb, w.p - w.base);
    copy_step<T, SIDE, CP>(st, a + static_cast<int64_t>(ia) * bm * bk,
                           b + static_cast<int64_t>(ib) * bk * bn, w.c * Tile<T, SIDE>::kKs, bm, bk,
                           bn, lane);
    if (++w.c == cks) {
      w.c = 0;
      ++w.p;
    }
  }
  cp_async_commit();
}

// Sum the first k_valid k of a step into acc.  fp32: lane (ty, tx) =
// (l / 4, l % 4) sums rows ty kRM + i, columns tx kCN + j, in
// acc[(i kCN + j) / 4][j % 4].  16-bit: tile (mt, nt) in acc[mt kNT + nt] as
// mma.sync's C fragment.
// FULL: k_valid is kKs (every step but the last of a pair whose bk is off
// kKs), so the loop has no exit to keep loads from being hoisted.
template <typename T, int SIDE, bool FULL>
__device__ __forceinline__ void sum_tile_step(float (&acc)[Tile<T, SIDE>::kAcc][4],
                                              const uint8_t* st, int k_valid, int lane) {
  using L = Tile<T, SIDE>;
  if constexpr (sizeof(T) == 4) {
    constexpr int RM = L::kRM, CN = L::kCN;
    const int ty = lane / 4, tx = lane % 4;
#pragma unroll
    for (int kq = 0; kq < 8; ++kq) {  // 4 k a chunk
      if (!FULL && 4 * kq >= k_valid) break;
      float av[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(st + a_offset<T, SIDE>(ty * RM + i, kq));
        av[i][0] = v.x, av[i][1] = v.y, av[i][2] = v.z, av[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow =
            reinterpret_cast<const float*>(st + b_offset<T, SIDE>(4 * kq + kk, 0)) + tx * CN;
        float bv[CN];
#pragma unroll
        for (int j = 0; j < CN; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(brow + j);
          bv[j] = v.x, bv[j + 1] = v.y, bv[j + 2] = v.z, bv[j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            float& c = acc[(i * CN + j) / 4][j % 4];
            c = fmaf(av[i][kk], bv[j], c);
          }
        }
      }
    }
  } else {
    const uint32_t base = smem_u32(st);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // k16 steps
      if (!FULL && 16 * ks >= k_valid) break;
      uint32_t af[L::kMT][4];
#pragma unroll
      for (int mt = 0; mt < L::kMT; ++mt) {
        ldmatrix_x4(af[mt], base + a_offset<T, SIDE>(16 * mt + lane % 16, 2 * ks + lane / 16));
      }
      // lanes 8 q to 8 q + 7 address k rows 8 (q % 2) + [0, 8) at n chunk
      // 2 np + q / 2: the B fragments of n8 tiles 2 np and 2 np + 1
      const int krow = 16 * ks + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
      for (int np = 0; np < L::kNT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, base + b_offset<T, SIDE>(krow, 2 * np + lane / 16));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
        for (int mt = 0; mt < L::kMT; ++mt) {
          mma_16816<T>(acc[mt * L::kNT + 2 * np], af[mt], b0);
          mma_16816<T>(acc[mt * L::kNT + 2 * np + 1], af[mt], b1);
        }
      }
    }
  }
}

// The run's C block (bm x bn at c) from the sums as sum_tile_step holds
// them, rounded once.  vec: fp32 rows of bn % 4 == 0 on 16 bytes (a lane's
// four columns go as one float4: with its neighbour, whole 32-byte
// sectors), 16-bit rows of bn even on 4 bytes (pairs at once).
template <typename T, int SIDE>
__device__ __forceinline__ void store_tile(const float (&acc)[Tile<T, SIDE>::kAcc][4],
                                           T* __restrict__ c, int bm, int bn, bool vec,
                                           int lane) {
  using L = Tile<T, SIDE>;
  if constexpr (sizeof(T) == 4) {
    const int ty = lane / 4, tx = lane % 4;
#pragma unroll
    for (int i = 0; i < L::kRM; ++i) {
      const int row = ty * L::kRM + i;
      if (row >= bm) break;
#pragma unroll
      for (int j = 0; j < L::kCN; j += 4) {
        const int col = tx * L::kCN + j;
        const float* v = acc[(i * L::kCN + j) / 4];
        float* dst = c + static_cast<int64_t>(row) * bn + col;
        if (vec) {
          if (col < bn) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (col + e < bn) dst[e] = v[e];
          }
        }
      }
    }
  } else {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mt = 0; mt < L::kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < L::kNT; ++nt) {
        const float* v = acc[mt * L::kNT + nt];
        const int col = 8 * nt + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * mt + g + 8 * h;
          if (row >= bm || col >= bn) continue;
          T* dst = c + static_cast<int64_t>(row) * bn + col;
          if (vec) {
            *reinterpret_cast<uint32_t*>(dst) = pack2<T>(v[2 * h], v[2 * h + 1]);
          } else {
            dst[0] = from_f32<T>(v[2 * h]);
            if (col + 1 < bn) dst[1] = from_f32<T>(v[2 * h + 1]);
          }
        }
      }
    }
  }
}

// Program b, one warp, owns runs [c kTileRuns, +kTileRuns), c = gridDim.x -
// 1 - b (programs start roughly in blockIdx order, and the last C slot, a
// padding sink, may own the longest run: the last runs go first).  Its runs' pairs
// are consecutive, so it walks them as one stream of steps, kTileStages - 1
// of them in flight.
template <typename T, int SIDE, int CP>
__global__ void __launch_bounds__(32)
    tile_runs(const T* __restrict__ a, const T* __restrict__ b,
              const int* __restrict__ pair_a, const int* __restrict__ pair_b,
              const int* __restrict__ run_start, const int* __restrict__ run_c,
              T* __restrict__ out, int n_runs, int bm, int bk, int bn, int vec_out) {
  using L = Tile<T, SIDE>;
  extern __shared__ uint8_t smem_raw[];
  const int lane = threadIdx.x;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kTileRuns;
  const int nr = min(kTileRuns, n_runs - r0);
  // the warp's run offsets and C slots: one coalesced load
  const int rs = lane <= nr ? run_start[r0 + lane] : 0;
  const int rc = lane < nr ? run_c[r0 + lane] : 0;
  const int p_begin = __shfl_sync(kAll, rs, 0), p_end = __shfl_sync(kAll, rs, nr);
  const int cks = (bk + L::kKs - 1) / L::kKs;  // steps a pair
  uint8_t* ring = smem_raw;
  PairWalk w{p_begin, 0, p_end, p_begin, 0, 0, 0, 0};
  {
    const int q = p_begin + lane, q2 = q + 32;
    w.pa = q < p_end ? pair_a[q] : 0;
    w.pb = q < p_end ? pair_b[q] : 0;
    w.pa_next = q2 < p_end ? pair_a[q2] : 0;
    w.pb_next = q2 < p_end ? pair_b[q2] : 0;
  }
#pragma unroll
  for (int s = 0; s < kTileStages - 1; ++s) {
    load_tile_step<T, SIDE, CP>(w, ring + s * L::kStageBytes, a, b, pair_a, pair_b, bm, bk, bn,
                                cks, lane);
  }
  int step = 0;
  for (int run = 0; run < nr; ++run) {
    const int steps = (__shfl_sync(kAll, rs, run + 1) - __shfl_sync(kAll, rs, run)) * cks;
    float acc[L::kAcc][4];
#pragma unroll
    for (int i = 0; i < L::kAcc; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int u = 0; u < steps; ++u, ++step) {
      cp_async_wait<kTileStages - 2>();  // this lane's copies of `step` have landed
      __syncwarp();                      // and every lane's; all are done with step - 1
      load_tile_step<T, SIDE, CP>(w, ring + ((step + kTileStages - 1) % kTileStages) *
                                                L::kStageBytes,
                                  a, b, pair_a, pair_b, bm, bk, bn, cks, lane);
      const int k_valid = min(L::kKs, bk - (u % cks) * L::kKs);
      const uint8_t* st = ring + (step % kTileStages) * L::kStageBytes;
      if (k_valid == L::kKs) {
        sum_tile_step<T, SIDE, true>(acc, st, k_valid, lane);
      } else {
        sum_tile_step<T, SIDE, false>(acc, st, k_valid, lane);
      }
    }
    T* c = out + static_cast<int64_t>(__shfl_sync(kAll, rc, run)) * bm * bn;
    store_tile<T, SIDE>(acc, c, bm, bn, vec_out != 0, lane);
  }
  cp_async_wait<0>();  // the walk is done: only empty groups are left
}

// ------------------------------------------------------------------ mma_runs

constexpr int kMmaTile = 64;                     // C rows and columns a program owns
constexpr int kMmaK = 64;                        // k a step: one 128-byte row of bf16
constexpr int kMmaThreads = 128;                 // one warpgroup
constexpr int kMmaPiece = kMmaTile * kMmaK * 2;  // one 64 x 64 16-bit tile: 8 KB
constexpr int kSwizzleAtom = 1024;               // 8 rows of 128 bytes

// fp32 tiles go to the tensor cores as three bf16 pieces; 16-bit tiles as they are
template <typename T>
struct Pieces {
  using W = __nv_bfloat16;
  static constexpr int n = 3;
};
template <>
struct Pieces<__half> {
  using W = __half;
  static constexpr int n = 1;
};
template <>
struct Pieces<__nv_bfloat16> {
  using W = __nv_bfloat16;
  static constexpr int n = 1;
};

template <typename T>
constexpr int kMmaSmem = kSwizzleAtom + 2 * 2 * Pieces<T>::n * kMmaPiece;  // 2 stages of A, B

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint32_t x, uint32_t y) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};" ::"r"(addr), "r"(x), "r"(y) : "memory");
}

// Program (blockIdx.x, blockIdx.y) owns 64 x 64 C tile blockIdx.y of run
// blockIdx.x.  Step s covers pair s / kc_n and k [64 (s % kc_n), +64); its
// loads are issued two steps ahead, into one of two register buffers.
// Thread t loads groups g = t + 128 i, i < 8, of each step's tiles: four
// consecutive elements of row g / 16, columns 4 (g % 16) onwards; VEC when
// the four are one aligned vector (bk and bn multiples of 4).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
    mma_runs(const T* __restrict__ a, const T* __restrict__ b,
             const int* __restrict__ pair_a, const int* __restrict__ pair_b,
             const int* __restrict__ run_start, const int* __restrict__ run_c,
             T* __restrict__ out, int bm, int bk, int bn, int tiles_n) {
  using W = typename Pieces<T>::W;
  constexpr int NP = Pieces<T>::n;
  constexpr int kStage = 2 * NP * kMmaPiece;  // NP pieces of A, then NP of B
  using Vec = std::conditional_t<sizeof(T) == 4, uint4, uint2>;  // four elements, aligned
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kSwizzleAtom - 1) & ~uint32_t(kSwizzleAtom - 1);
  const int r = blockIdx.x;
  const int m0 = (blockIdx.y / tiles_n) * kMmaTile, n0 = (blockIdx.y % tiles_n) * kMmaTile;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int p_begin = run_start[r];
  const int kc_n = (bk + kMmaK - 1) / kMmaK;
  const int steps = (run_start[r + 1] - p_begin) * kc_n;
  const int64_t a_size = static_cast<int64_t>(bm) * bk;
  const int64_t b_size = static_cast<int64_t>(bk) * bn;
  const T zero = from_f32<T>(0.f);
  // the loads of two steps, four elements each: step s in buffer s % 2
  Vec a_reg[2][8], b_reg[2][8];
  using Buf0 = std::integral_constant<int, 0>;
  using Buf1 = std::integral_constant<int, 1>;

  // issue the loads of step s, whose pair indices are (ia, ib), into buffer `buf`
  auto load = [&](auto buf, int s, int ia, int ib) {
    constexpr int B = decltype(buf)::value;
    const int k0 = (s % kc_n) * kMmaK;
    const T* a_blk = a + ia * a_size;
    const T* b_blk = b + ib * b_size;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int g = t + kMmaThreads * i, y = g / 16, x = 4 * (g % 16);
      const int am = m0 + y, ak = k0 + x;  // A tile: rows of C, columns of k
      const int bk_row = k0 + y, bn_col = n0 + x;  // B tile: rows of k, columns of C
      if constexpr (VEC) {
        Vec va{}, vb{};
        if (am < bm && ak < bk) va = *reinterpret_cast<const Vec*>(a_blk + am * bk + ak);
        if (bk_row < bk && bn_col < bn) {
          vb = *reinterpret_cast<const Vec*>(b_blk + bk_row * bn + bn_col);
        }
        a_reg[B][i] = va;
        b_reg[B][i] = vb;
      } else {
        T* av = reinterpret_cast<T*>(&a_reg[B][i]);
        T* bv = reinterpret_cast<T*>(&b_reg[B][i]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          av[q] = am < bm && ak + q < bk ? a_blk[am * bk + ak + q] : zero;
          bv[q] = bk_row < bk && bn_col + q < bn ? b_blk[bk_row * bn + bn_col + q] : zero;
        }
      }
    }
  };
  // buffer `buf` into a stage, 128-byte swizzled: A k-major (row = C row),
  // B MN-major (row = k); fp32 split into its three pieces
  auto store = [&](auto buf, int stage) {
    constexpr int B = decltype(buf)::value;
    const uint32_t sa = base + stage * kStage, sb = sa + NP * kMmaPiece;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int g = t + kMmaThreads * i;
      const uint32_t off = swizzle128(g / 16, 8 * (g % 16));  // four 16-bit values
#pragma unroll
      for (int op = 0; op < 2; ++op) {
        const T* v = reinterpret_cast<const T*>(op == 0 ? &a_reg[B][i] : &b_reg[B][i]);
        const uint32_t dst = (op == 0 ? sa : sb) + off;
        if constexpr (NP == 3) {
          uint32_t lo[3], hi[3];
          split3x2(to_f32(v[0]), to_f32(v[1]), lo);
          split3x2(to_f32(v[2]), to_f32(v[3]), hi);
#pragma unroll
          for (int k = 0; k < 3; ++k) st_shared_v2(dst + k * kMmaPiece, lo[k], hi[k]);
        } else {
          st_shared_v2(dst, bits2(v[0], v[1]), bits2(v[2], v[3]));
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
  };

  float hi[32], lo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) hi[i] = lo[i] = 0.f;
  // pair indices of step s + 2, read a step before its loads need them
  int ia = 0, ib = 0;
  auto fetch_indices = [&](int s) {
    ia = pair_a[p_begin + s / kc_n];
    ib = pair_b[p_begin + s / kc_n];
  };
  // step s: its tiles sit in stage s % 2; step s + 1's loads have had a
  // whole step to arrive and are stored now; step s + 2's are issued
  auto step = [&](auto buf, int s) {
    if (s + 2 < steps) {
      load(buf, s + 2, ia, ib);
      if (s + 3 < steps) fetch_indices(s + 3);
    }
    const uint32_t sa = base + (s & 1) * kStage, sb = sa + NP * kMmaPiece;
    fence_acc(hi);
    fence_acc(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kMmaK / 16; ++kk) {
      uint64_t da[NP], db[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        da[i] = smem_desc(sa + i * kMmaPiece + kk * 32, 16, 1024);
        db[i] = smem_desc(sb + i * kMmaPiece + kk * 2048, kMmaPiece, 1024);
      }
      if constexpr (NP == 3) {  // the small terms first, into lo
        wgmma_k16<W, 32>(lo, da[2], db[0], 1);
        wgmma_k16<W, 32>(lo, da[1], db[1], 1);
        wgmma_k16<W, 32>(lo, da[0], db[2], 1);
        wgmma_k16<W, 32>(lo, da[1], db[0], 1);
        wgmma_k16<W, 32>(lo, da[0], db[1], 1);
      }
      wgmma_k16<W, 32>(hi, da[0], db[0], 1);
    }
    wgmma_commit();
    fence_acc(hi);
    fence_acc(lo);
    wgmma_wait<1>();  // step s - 1's products are done in this warp ...
    fence_acc(hi);
    fence_acc(lo);
    __syncthreads();  // ... and in every warp: its stage may be rewritten
    if (s + 1 < steps) store(std::integral_constant<int, 1 - decltype(buf)::value>{}, (s + 1) & 1);
    __syncthreads();
  };
  if (steps > 0) {
    load(Buf0{}, 0, pair_a[p_begin], pair_b[p_begin]);
    if (steps > 1) load(Buf1{}, 1, pair_a[p_begin + 1 / kc_n], pair_b[p_begin + 1 / kc_n]);
    if (steps > 2) fetch_indices(2);
    store(Buf0{}, 0);
  }
  __syncthreads();
  for (int s = 0; s < steps; s += 2) {  // unrolled by two: the buffers are registers
    step(Buf0{}, s);
    if (s + 1 < steps) step(Buf1{}, s + 1);
  }
  wgmma_wait<0>();
  fence_acc(hi);
  fence_acc(lo);
  // accumulator i: row 16 warp + lane / 4 + 8 (i / 2 % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
  T* c = out + run_c[r] * static_cast<int64_t>(bm) * bn;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = m0 + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    const int col = n0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    if (row < bm && col < bn) c[static_cast<int64_t>(row) * bn + col] = from_f32<T>(hi[i] + lo[i]);
  }
}

// ------------------------------------------------------------------ launchers

struct Args {
  const void* a;
  const void* b;
  const int* pa;
  const int* pb;
  const int* rs;
  const int* rc;
  void* out;
  int n_runs, n_pairs, n_c, bm, bk, bn;
  cudaStream_t stream;
};

template <typename T, int SIDE, bool VEC>
void launch_warp_side(const Args& g) {
  constexpr int runs = kWarpRunsWarps * kRunsPerWarp;
  warp_runs<T, SIDE, VEC><<<(g.n_runs + runs - 1) / runs, kWarpRunsWarps * 32, 0, g.stream>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b), g.pa, g.pb, g.rs, g.rc,
      static_cast<T*>(g.out), g.n_runs, g.bm, g.bk, g.bn);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// A span for each warp the card holds at once (one wave, every warp the
// same number of pairs), at least kMinSpan pairs.
template <typename T>
void launch_scalar(const Args& g) {
  static int resident[64];  // warps a device holds at once, by device (0: not asked yet)
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return;  // the error stays for the caller
  int warps = dev < 64 ? resident[dev] : 0;
  if (!warps) {
    int sms = 0, blocks = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, scalar_runs<T>,
                                                      kScalarWarps * 32, 0) != cudaSuccess) {
      return;
    }
    warps = std::max(1, sms * blocks * kScalarWarps);
    if (dev < 64) resident[dev] = warps;
  }
  const int span = std::max(kMinSpan, (g.n_pairs + warps - 1) / warps);
  const int spans = (g.n_pairs + span - 1) / span;
  scalar_runs<T><<<(spans + kScalarWarps - 1) / kScalarWarps, kScalarWarps * 32, 0, g.stream>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b), g.pa, g.pb, g.rs, g.rc,
      static_cast<T*>(g.out), g.n_runs, g.n_pairs, g.n_c, span);
}

template <typename T>
void launch_warp(const Args& g) {
  const int es = sizeof(T);
  const bool vec = (g.bk * es) % 16 == 0 && (g.bn * es) % 16 == 0 && aligned16(g.a) &&
                   aligned16(g.b);
  const bool side8 = g.bm <= 8 && g.bn <= 8;
  if (side8) {
    vec ? launch_warp_side<T, 8, true>(g) : launch_warp_side<T, 8, false>(g);
  } else {
    vec ? launch_warp_side<T, 16, true>(g) : launch_warp_side<T, 16, false>(g);
  }
}

template <typename T, int SIDE, int CP>
void launch_tile_side(const Args& g) {
  using L = Tile<T, SIDE>;
  const uintptr_t out_align = sizeof(T) == 4 ? 16 : 4;
  const bool vec_out = g.bn % (sizeof(T) == 4 ? 4 : 2) == 0 &&
                       reinterpret_cast<uintptr_t>(g.out) % out_align == 0;
  tile_runs<T, SIDE, CP><<<(g.n_runs + kTileRuns - 1) / kTileRuns, 32, L::kSmem, g.stream>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b), g.pa, g.pb, g.rs, g.rc,
      static_cast<T*>(g.out), g.n_runs, g.bm, g.bk, g.bn, vec_out);
}

template <typename T, int CP>
void launch_tile_cp(const Args& g) {
  g.bm <= 16 && g.bn <= 16 ? launch_tile_side<T, 16, CP>(g) : launch_tile_side<T, 32, CP>(g);
}

template <typename T>
void launch_tile(const Args& g) {
  const auto aligned = [](const void* p, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(p) % to == 0;
  };
  const int es = sizeof(T);
  if ((g.bk * es) % 16 == 0 && (g.bn * es) % 16 == 0 && aligned(g.a, 16) && aligned(g.b, 16)) {
    launch_tile_cp<T, kT16>(g);
  } else if constexpr (sizeof(T) == 4) {
    launch_tile_cp<T, kT4>(g);
  } else if (g.bk % 2 == 0 && g.bn % 2 == 0 && aligned(g.a, 4) && aligned(g.b, 4)) {
    launch_tile_cp<T, kT4>(g);
  } else {
    launch_tile_cp<T, kTSync>(g);
  }
}

template <typename T, bool VEC>
void launch_mma_vec(const Args& g) {
  const int tiles_n = (g.bn + kMmaTile - 1) / kMmaTile;
  const int tiles = ((g.bm + kMmaTile - 1) / kMmaTile) * tiles_n;
  // set on every launch: the attribute belongs to the current device's
  // context; a failure here stays in cudaGetLastError() for the caller
  if (cudaFuncSetAttribute(mma_runs<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMmaSmem<T>) != cudaSuccess) {
    return;
  }
  mma_runs<T, VEC><<<dim3(g.n_runs, tiles), kMmaThreads, kMmaSmem<T>, g.stream>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b), g.pa, g.pb, g.rs, g.rc,
      static_cast<T*>(g.out), g.bm, g.bk, g.bn, tiles_n);
}

template <typename T>
void launch_mma(const Args& g) {
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = g.bk % 4 == 0 && g.bn % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(g.a) % align == 0 &&
                   reinterpret_cast<uintptr_t>(g.b) % align == 0;
  vec ? launch_mma_vec<T, true>(g) : launch_mma_vec<T, false>(g);
}

template <typename T>
int run(int kernel, const Args& g) {
  switch (kernel) {
    case kScalar:
      launch_scalar<T>(g);
      break;
    case kWarp:
      launch_warp<T>(g);
      break;
    case kTile:
      launch_tile<T>(g);
      break;
    default:
      launch_mma<T>(g);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches `kernel` on the shapes the wrapper's route gives it (0
// scalar_runs: (1, 1, 1); 1 warp_runs: bm, bn, bk <= 16; 2 tile_runs: bm,
// bn <= 32 and some side over 16; 3 mma_runs: bm or bn over 32).  a: A blocks
// (n, bm, bk); b: B blocks (n, bk, bn); pair_a, pair_b: int32 per pair,
// n_pairs of them; run_start: int32, n_runs + 1 offsets into the pairs
// (repro_torch.kernels.bsr_spgemm.pair_runs: from 0 to n_pairs, each run
// non-empty); run_c: int32 C slot per run, ascending; out: C blocks (n_c,
// bm, bn), zeroed by the caller except for scalar_runs, which writes every
// slot; dtype (a, b and out): 0 = float32, 1 = bfloat16, 2 = float16.
// Returns cudaErrorInvalidValue for a shape the kernel does not take, else
// cudaGetLastError() after the launch (0 on success); the wrapper raises on
// anything else.
extern "C" int repro_bsr_spgemm(int kernel, const void* a, const void* b, const void* pair_a,
                                const void* pair_b, const void* run_start, const void* run_c,
                                void* out, int n_runs, int n_pairs, int n_c, int bm, int bk,
                                int bn, int dtype, void* stream) {
  if (n_runs < 0 || n_pairs < n_runs || n_c < 0 || bm < 1 || bk < 1 || bn < 1 || dtype < 0 ||
      dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile;  // the side of the square C tiles of one program (or warp)
  switch (kernel) {
    case kScalar:
      if (bm != 1 || bk != 1 || bn != 1) return static_cast<int>(cudaErrorInvalidValue);
      if (n_runs == 0) {  // no run: every C slot is zero
        return static_cast<int>(cudaMemsetAsync(out, 0, static_cast<size_t>(n_c) * (dtype ? 2 : 4),
                                                static_cast<cudaStream_t>(stream)));
      }
      tile = 1;
      break;
    case kWarp:
      if (bm > 16 || bn > 16 || bk > kSmallK) return static_cast<int>(cudaErrorInvalidValue);
      tile = 16;
      break;
    case kTile:
      if ((bm <= 16 && bn <= 16 && bk <= kSmallK) || bm > 32 || bn > 32) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      tile = 32;
      break;
    case kMma:
      if (bm <= 32 && bn <= 32) return static_cast<int>(cudaErrorInvalidValue);
      tile = kMmaTile;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<int64_t>((bm + tile - 1) / tile) * ((bn + tile - 1) / tile) > kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_runs == 0) return static_cast<int>(cudaGetLastError());
  const Args g{a, b, static_cast<const int*>(pair_a), static_cast<const int*>(pair_b),
               static_cast<const int*>(run_start), static_cast<const int*>(run_c), out, n_runs,
               n_pairs, n_c, bm, bk, bn, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return run<float>(kernel, g);
    case 1:
      return run<__nv_bfloat16>(kernel, g);
    default:
      return run<__half>(kernel, g);
  }
}
