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
// (repro_torch.kernels.bsr_spgemm.pair_runs) and one run belongs to one set
// of programs that split its C block into disjoint tiles: no atomics, no
// cross-block reduction, and the same sum order on every call.  C blocks
// that no run touches keep the zeros the wrapper allocates.
//
// What bounds it: memory traffic and latency at small blocks, arithmetic at
// large ones.
//   - (1, 1, 1) is a scalar segment sum: per pair two 4-byte indices and two
//     gathered values, one multiply-add.  One thread per run, many runs per
//     block; a run's indices are contiguous, so a thread streams through
//     them from L1 after the first miss.  Runs are short (about ten pairs
//     for an AMG Galerkin product), so a warp per run would idle most lanes.
//   - Every other shape: program (r, t) owns C tile t of run r, a square
//     tile of SIDE * MT rows and columns, picked from the larger of bm and
//     bn: 8 x 8 threads with one element each up to 8, 16 x 16 threads with
//     one element each up to 16, then 2 x 2 and 4 x 4 elements per thread
//     (edges masked).  Each thread keeps its MT x MT fp32 accumulators over
//     the whole run.  For each pair it walks bk in slices of SIDE, staging
//     the A slice (transposed, padded against bank conflicts) and the B
//     slice in shared memory, MT coalesced loads per thread.  Up to 16 this
//     is bound by the dependent block loads (one pair in flight per
//     program), so those instances are held to 32 registers and the SM runs
//     every warp it can hold; from 64 it is fp32 FMA work on the CUDA cores.
//     Tensor-core tiles (wgmma), TMA and packing several runs per program
//     are left for later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScalarThreads = 256;
constexpr int kMaxTiles = 65535;  // gridDim.y

// Programs of block_runs an SM should hold at once: with one element per
// thread the kernel waits on its block loads, so it needs every warp the SM
// can hold (2048 threads, which caps registers at 32 a thread); larger
// tiles keep 64 (MT = 2) or 128 (MT = 4) registers for their accumulators.
template <int SIDE, int MT>
constexpr int kMinBlocks = MT == 1 ? 2048 / (SIDE * SIDE) : MT == 2 ? 4 : 2;

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

// The tile of block_runs for (bm, bn), as SIDE * 10 + MT: one element per
// thread up to 16 x 16, then 2 x 2 and 4 x 4 per thread of 16 x 16.
int tile_kind(int bm, int bn) {
  const int side = bm > bn ? bm : bn;
  return side <= 8 ? 81 : side <= 16 ? 161 : side <= 32 ? 162 : 164;
}

template <typename T, int SIDE, int MT>
void launch_blocks(const T* a, const T* b, const int* pa, const int* pb, const int* rs,
                   const int* rc, T* out, int n_runs, int bm, int bk, int bn,
                   cudaStream_t stream) {
  constexpr int kTile = SIDE * MT;
  const int tiles_m = (bm + kTile - 1) / kTile;
  const int tiles_n = (bn + kTile - 1) / kTile;
  const dim3 grid(n_runs, tiles_m * tiles_n);
  block_runs<T, SIDE, MT><<<grid, SIDE * SIDE, 0, stream>>>(a, b, pa, pb, rs, rc, out, bm,
                                                            bk, bn, tiles_n);
}

template <typename T>
void launch(const void* a, const void* b, const int* pa, const int* pb, const int* rs,
            const int* rc, void* out, int n_runs, int bm, int bk, int bn,
            cudaStream_t stream) {
  const T* a_t = static_cast<const T*>(a);
  const T* b_t = static_cast<const T*>(b);
  T* out_t = static_cast<T*>(out);
  if (bm == 1 && bk == 1 && bn == 1) {
    const int grid = (n_runs + kScalarThreads - 1) / kScalarThreads;
    scalar_runs<T><<<grid, kScalarThreads, 0, stream>>>(a_t, b_t, pa, pb, rs, rc, out_t,
                                                        n_runs);
    return;
  }
  switch (tile_kind(bm, bn)) {
    case 81:
      launch_blocks<T, 8, 1>(a_t, b_t, pa, pb, rs, rc, out_t, n_runs, bm, bk, bn, stream);
      break;
    case 161:
      launch_blocks<T, 16, 1>(a_t, b_t, pa, pb, rs, rc, out_t, n_runs, bm, bk, bn, stream);
      break;
    case 162:
      launch_blocks<T, 16, 2>(a_t, b_t, pa, pb, rs, rc, out_t, n_runs, bm, bk, bn, stream);
      break;
    default:
      launch_blocks<T, 16, 4>(a_t, b_t, pa, pb, rs, rc, out_t, n_runs, bm, bk, bn, stream);
      break;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns cudaGetLastError()
// after the launch (0 on success); the wrapper raises on anything else.
extern "C" int repro_bsr_spgemm(const void* a, const void* b, const void* pair_a,
                                const void* pair_b, const void* run_start,
                                const void* run_c, void* out, int n_runs, int bm,
                                int bk, int bn, int dtype, void* stream) {
  if (n_runs < 0 || bm < 1 || bk < 1 || bn < 1 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kind = tile_kind(bm, bn);
  const int tile = (kind / 10) * (kind % 10);
  const int64_t tiles =
      static_cast<int64_t>((bm + tile - 1) / tile) * ((bn + tile - 1) / tile);
  if (tiles > kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  if (n_runs > 0) {
    const int* pa = static_cast<const int*>(pair_a);
    const int* pb = static_cast<const int*>(pair_b);
    const int* rs = static_cast<const int*>(run_start);
    const int* rc = static_cast<const int*>(run_c);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
      case 0:
        launch<float>(a, b, pa, pb, rs, rc, out, n_runs, bm, bk, bn, st);
        break;
      case 1:
        launch<__nv_bfloat16>(a, b, pa, pb, rs, rc, out, n_runs, bm, bk, bn, st);
        break;
      default:
        launch<__half>(a, b, pa, pb, rs, rc, out, n_runs, bm, bk, bn, st);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
