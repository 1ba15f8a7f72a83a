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
// offsets once per call (repro_torch.kernels.bsr_spmm) and one program owns
// one (block-row, column tile, row slice) of the output: it sums all of the
// row's blocks in fp32 registers and rounds once when it writes.  So a bf16
// result is rounded once per element here, where the TPU kernel rounds once
// per block product; and every output tile is written by its program, so a
// block-row with no blocks comes out zero without a separate fill (the TPU
// kernel needs ops.spmm to pad a zero block into it).
//
// What bounds it: at the repo's AMG size (8 x 8 blocks at 17.5% fill, N =
// 256) the fp32 multiply-adds (2 nb bm bk N) outweigh the bytes at the card's
// rates, and bf16 is bound by bytes.  The design keeps the FMAs fed: a
// program has 128 threads, each owning kCols columns (coalesced, 128 apart)
// and the kRows rows of its row slice, so it holds kRows x kCols fp32
// accumulators.  The block's slice of up to kSliceK columns is staged in
// shared memory transposed, so one 16-byte load hands a thread four rows of
// A; each dense element is read once per program, from device memory into a
// register, and used kRows times there (no thread shares it, so staging it
// in shared memory would add a copy without reuse).  Tensor-core tiles,
// several block-rows per program and double buffering are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 2;                     // columns per thread
constexpr int kTileN = kThreads * kCols;     // columns per program
constexpr int kRows = 8;                     // block rows per program
constexpr int kSliceK = 32;                  // block columns staged per step
constexpr int kMaxGridYZ = 65535;
static_assert(kRows == 8, "block_rows reads a row slice as two float4");

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

template <typename T>
void launch(const void* blocks, const int* row_start, const int* bcols, const void* dense,
            void* out, int m_blocks, int bm, int bk, int n, cudaStream_t stream) {
  const dim3 grid(m_blocks, (n + kTileN - 1) / kTileN, (bm + kRows - 1) / kRows);
  block_rows<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(blocks), row_start, bcols, static_cast<const T*>(dense),
      static_cast<T*>(out), bm, bk, n);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns cudaGetLastError()
// after the launch (0 on success); the wrapper raises on anything else.
extern "C" int repro_bsr_spmm(const void* blocks, const void* row_start, const void* bcols,
                              const void* dense, void* out, int m_blocks, int bm, int bk,
                              int n, int dtype, void* stream) {
  if (m_blocks < 0 || bm < 1 || bk < 1 || n < 0 || dtype < 0 || dtype > 2 ||
      (n + kTileN - 1) / kTileN > kMaxGridYZ || (bm + kRows - 1) / kRows > kMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m_blocks > 0 && n > 0) {
    const int* rs = static_cast<const int*>(row_start);
    const int* bc = static_cast<const int*>(bcols);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
      case 0:
        launch<float>(blocks, rs, bc, dense, out, m_blocks, bm, bk, n, st);
        break;
      case 1:
        launch<__nv_bfloat16>(blocks, rs, bc, dense, out, m_blocks, bm, bk, n, st);
        break;
      default:
        launch<__half>(blocks, rs, bc, dense, out, m_blocks, bm, bk, n, st);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
