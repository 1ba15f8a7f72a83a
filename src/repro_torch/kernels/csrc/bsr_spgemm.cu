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
// the zeros the wrapper allocates.
//
// What bounds it: memory traffic and latency at small blocks, arithmetic at
// large ones.  Four kernels, one per regime, picked by the wrapper before
// launch (repro_torch.kernels.bsr_spgemm.route):
//   - scalar_runs, (1, 1, 1): a scalar segment sum, one thread per run, many
//     runs per block; a run's indices are contiguous, so a thread streams
//     through them from L1 after the first miss.  Runs are short (about ten
//     pairs for an AMG Galerkin product), so a warp per run would idle most
//     lanes.
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
//   - block_runs, everything else (a side of 17 to 32, or bk > 16 with
//     bm and bn at most 16): program (r, t) owns C tile t of run r, a square
//     tile of SIDE * MT rows and columns, picked from the larger of bm and bn;
//     each thread keeps its MT x MT fp32 accumulators over the whole run,
//     and each pair's bk is walked in slices of SIDE staged in shared memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kScalarThreads = 256;
constexpr int kMaxTiles = 65535;  // gridDim.y
// the kernels, as the wrapper numbers them (repro_torch.kernels.bsr_spgemm.KERNELS)
enum Kernel { kScalar = 0, kWarp = 1, kBlock = 2, kMma = 3 };
constexpr unsigned kAll = 0xffffffffu;

// Programs of block_runs an SM should hold at once: with one element per
// thread the kernel waits on its block loads, so it needs every warp the SM
// can hold (2048 threads, which caps registers at 32 a thread); 32 x 32
// tiles (MT = 2) keep 64 registers for their accumulators.
template <int SIDE, int MT>
constexpr int kMinBlocks = MT == 1 ? 2048 / (SIDE * SIDE) : 4;

// (1, 1, 1): thread r sums run r.
template <typename T>
__global__ void scalar_runs(const T* __restrict__ a, const T* __restrict__ b,
                            const int* __restrict__ pair_a,
                            const int* __restrict__ pair_b,
                            const int* __restrict__ run_start,
                            const int* __restrict__ run_c, T* __restrict__ out,
                            int n_runs) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_runs) return;
  const int end = run_start[r + 1];
  float acc = 0.f;
  for (int i = run_start[r]; i < end; ++i) {
    acc = fmaf(to_f32(a[pair_a[i]]), to_f32(b[pair_b[i]]), acc);
  }
  out[run_c[r]] = from_f32<T>(acc);
}

// Any other shape: program (blockIdx.x, blockIdx.y) owns C tile blockIdx.y of
// run blockIdx.x, SIDE * MT rows and columns; thread (ty, tx) of its SIDE x
// SIDE threads holds rows ty + SIDE i and columns tx + SIDE j of that tile,
// i, j < MT.  A and B are staged in slices of SIDE along bk.
template <typename T, int SIDE, int MT>
__global__ void __launch_bounds__(SIDE* SIDE, kMinBlocks<SIDE, MT>)
    block_runs(const T* __restrict__ a, const T* __restrict__ b,
               const int* __restrict__ pair_a, const int* __restrict__ pair_b,
               const int* __restrict__ run_start, const int* __restrict__ run_c,
               T* __restrict__ out, int bm, int bk, int bn, int tiles_n) {
  constexpr int kTile = SIDE * MT;
  constexpr int kThreads = SIDE * SIDE;
  __shared__ float a_s[SIDE][kTile + 1];  // A slice, transposed
  __shared__ float b_s[SIDE][kTile];
  const int r = blockIdx.x;
  const int m0 = (blockIdx.y / tiles_n) * kTile;
  const int n0 = (blockIdx.y % tiles_n) * kTile;
  const int t = threadIdx.x;
  const int tx = t % SIDE;
  const int ty = t / SIDE;
  const int64_t a_size = static_cast<int64_t>(bm) * bk;
  const int64_t b_size = static_cast<int64_t>(bk) * bn;
  float acc[MT][MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[i][j] = 0.f;
  }
  const int end = run_start[r + 1];
  for (int p = run_start[r]; p < end; ++p) {
    const T* a_blk = a + pair_a[p] * a_size;
    const T* b_blk = b + pair_b[p] * b_size;
    for (int k0 = 0; k0 < bk; k0 += SIDE) {
#pragma unroll
      for (int q = 0; q < MT; ++q) {  // kTile x SIDE elements of A, MT per thread
        const int idx = t + q * kThreads;
        const int m = idx / SIDE, k = idx % SIDE;
        const int gm = m0 + m, gk = k0 + k;
        a_s[k][m] = (gm < bm && gk < bk) ? to_f32(a_blk[static_cast<int64_t>(gm) * bk + gk])
                                         : 0.f;
      }
#pragma unroll
      for (int q = 0; q < MT; ++q) {  // SIDE x kTile elements of B
        const int idx = t + q * kThreads;
        const int k = idx / kTile, n = idx % kTile;
        const int gk = k0 + k, gn = n0 + n;
        b_s[k][n] = (gk < bk && gn < bn) ? to_f32(b_blk[static_cast<int64_t>(gk) * bn + gn])
                                         : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < SIDE; ++k) {
        float av[MT], bv[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) av[i] = a_s[k][ty + SIDE * i];
#pragma unroll
        for (int j = 0; j < MT; ++j) bv[j] = b_s[k][tx + SIDE * j];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }
  T* c = out + run_c[r] * static_cast<int64_t>(bm) * bn;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = m0 + ty + SIDE * i;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int col = n0 + tx + SIDE * j;
      if (row < bm && col < bn) {
        c[static_cast<int64_t>(row) * bn + col] = from_f32<T>(acc[i][j]);
      }
    }
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
  int n_runs, bm, bk, bn;
  cudaStream_t stream;
};

template <typename T>
void launch_scalar(const Args& g) {
  const int grid = (g.n_runs + kScalarThreads - 1) / kScalarThreads;
  scalar_runs<T><<<grid, kScalarThreads, 0, g.stream>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b), g.pa, g.pb, g.rs, g.rc,
      static_cast<T*>(g.out), g.n_runs);
}

template <typename T, int SIDE, bool VEC>
void launch_warp_side(const Args& g) {
  constexpr int runs = kWarpRunsWarps * kRunsPerWarp;
  warp_runs<T, SIDE, VEC><<<(g.n_runs + runs - 1) / runs, kWarpRunsWarps * 32, 0, g.stream>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b), g.pa, g.pb, g.rs, g.rc,
      static_cast<T*>(g.out), g.n_runs, g.bm, g.bk, g.bn);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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

// The tile of block_runs for (bm, bn) (both at most 32), as SIDE * 10 + MT:
// one element per thread up to 16 x 16, then 2 x 2 per thread of 16 x 16.
int tile_kind(int bm, int bn) {
  const int side = bm > bn ? bm : bn;
  return side <= 8 ? 81 : side <= 16 ? 161 : 162;
}

template <typename T, int SIDE, int MT>
void launch_blocks(const Args& g) {
  constexpr int kTile = SIDE * MT;
  const int tiles_m = (g.bm + kTile - 1) / kTile;
  const int tiles_n = (g.bn + kTile - 1) / kTile;
  const dim3 grid(g.n_runs, tiles_m * tiles_n);
  block_runs<T, SIDE, MT><<<grid, SIDE * SIDE, 0, g.stream>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b), g.pa, g.pb, g.rs, g.rc,
      static_cast<T*>(g.out), g.bm, g.bk, g.bn, tiles_n);
}

template <typename T>
void launch_block(const Args& g) {
  switch (tile_kind(g.bm, g.bn)) {
    case 81:
      launch_blocks<T, 8, 1>(g);
      break;
    case 161:
      launch_blocks<T, 16, 1>(g);
      break;
    default:
      launch_blocks<T, 16, 2>(g);
      break;
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
    case kBlock:
      launch_block<T>(g);
      break;
    default:
      launch_mma<T>(g);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches `kernel` on the shapes the wrapper's route gives it (0
// scalar_runs: (1, 1, 1); 1 warp_runs: bm, bn, bk <= 16; 2 block_runs: bm,
// bn <= 32; 3 mma_runs: bm or bn over 32).  a: A blocks
// (n, bm, bk); b: B blocks (n, bk, bn); pair_a, pair_b: int32 per pair;
// run_start: int32, n_runs + 1 offsets into the pairs; run_c: int32 C slot
// per run; out: C blocks (n_c, bm, bn), zeroed by the caller; dtype (a, b
// and out): 0 = float32, 1 = bfloat16, 2 = float16.  Returns
// cudaErrorInvalidValue for a shape the kernel does not take, else
// cudaGetLastError() after the launch (0 on success); the wrapper raises on
// anything else.
extern "C" int repro_bsr_spgemm(int kernel, const void* a, const void* b, const void* pair_a,
                                const void* pair_b, const void* run_start, const void* run_c,
                                void* out, int n_runs, int bm, int bk, int bn, int dtype,
                                void* stream) {
  if (n_runs < 0 || bm < 1 || bk < 1 || bn < 1 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile;  // the side of the square C tiles of one thread block
  switch (kernel) {
    case kScalar:
      if (bm != 1 || bk != 1 || bn != 1) return static_cast<int>(cudaErrorInvalidValue);
      tile = 1;
      break;
    case kWarp:
      if (bm > 16 || bn > 16 || bk > kSmallK) return static_cast<int>(cudaErrorInvalidValue);
      tile = 16;
      break;
    case kBlock: {
      if (bm > 32 || bn > 32) return static_cast<int>(cudaErrorInvalidValue);
      const int kind = tile_kind(bm, bn);
      tile = (kind / 10) * (kind % 10);
      break;
    }
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
               bm, bk, bn, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return run<float>(kernel, g);
    case 1:
      return run<__nv_bfloat16>(kernel, g);
    default:
      return run<__half>(kernel, g);
  }
}
