// Grouped expert GEMM (E, C, d) x (E, d, f) -> (E, C, f) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py:_kernel (reached through
// moe_gemm and ops.grouped_gemm): for every expert e,
//     out[e] = x[e] @ w[e]
// summed in fp32 and written in x's type (not the promoted type: the TPU
// kernel writes x.dtype, and so does this one).  The TPU kernel's grid is
// (E, C/b_c, f/b_f, d/b_d) with the d axis innermost and sequential, carrying
// an fp32 scratch tile across it.  Here the grid is (f/128, C/128, E) and the
// d loop runs inside each program, so the accumulator stays in registers and
// no program depends on another.
//
// What bounds it: arithmetic.  At the full width of Qwen3-MoE-235B-A22B's
// experts (E = 128, C = 640, d = 4096, f = 1536) a projection is 1.03 TFLOP
// against 2.5 GB.  This first kernel does that arithmetic as fp32 FMAs on the
// CUDA cores, so it runs far below the bf16 tensor-core peak its bound is
// taken against: a program owns a 128 x 128 output tile; its 16 x 16 threads
// each keep an 8 x 8 fp32 accumulator (two 4-row by two 4-column quadrants, so
// each thread's shared-memory reads are 16-byte and conflict-free); the d
// loop stages a 128 x 16 slice of x (transposed) and a 16 x 128 slice of w in
// shared memory as fp32, and each element staged is used 128 times.  Edges
// are masked, so any (C, d, f) works; the wrapper keeps the TPU kernel's
// divisibility contract.  Tensor cores (mma.sync / wgmma), TMA and a
// multi-stage pipeline are the redesign's work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace

// in_dtype (x and w) and out_dtype: 0 = float32, 1 = bfloat16, 2 = float16.
// The output type is x's; x and w share in_dtype, which differs from it only
// when mixed inputs met at float32.  Returns cudaGetLastError() after the
// launch (0 on success); the wrapper raises on anything else.
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
