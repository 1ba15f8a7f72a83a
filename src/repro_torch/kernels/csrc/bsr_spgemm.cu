// BSR x BSR SpGEMM over a pair list grouped into runs, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bsr_spgemm.py:_kernel (reached through
// _bsr_spgemm_jit, bsr_spgemm and bsr_spgemm_local).  It computes
//     C[run_c[r]] = sum over pairs i in [run_start[r], run_start[r+1]) of
//                   A[pair_a[i]] @ B[pair_b[i]]
// with square b x b blocks, fp32 accumulation, and the result written in the
// inputs' type.  The TPU kernel walks the pair list on a sequential grid and
// revisits one output tile per run of equal pair_c.  A Hopper grid runs in
// parallel and in no order, so the host hands over the run offsets once
// (repro_torch.kernels.bsr_spgemm.pair_runs) and one program owns one run:
// no atomics, no cross-block reduction, and the same sum order on every
// call.  C blocks that no run touches keep the zeros the wrapper allocates.
//
// What bounds it: memory traffic and latency, not arithmetic.
//   - b = 1 is a scalar segment sum: per pair two 4-byte indices and two
//     gathered values, one multiply-add.  One thread per run, many runs per
//     block; a run's indices are contiguous, so a thread streams through
//     them from L1 after the first miss.  Runs are short (about ten pairs
//     for an AMG Galerkin product), so a warp per run would idle most lanes.
//   - b >= 2 (up to 32): one block per run with b*b threads.  The pair's A
//     and B blocks are staged in shared memory with one coalesced load per
//     thread, then each thread keeps one fp32 accumulator of C over the run
//     and over k.  At b = 16 this is still bound by the dependent block
//     loads (one pair in flight per block); tensor-core tiles (wgmma), TMA
//     and packing several runs per program are left for later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBlock = 32;
constexpr int kScalarThreads = 256;

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

// b = 1: thread r sums run r.
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

// b >= 2: block r owns run r; thread t holds C element (t / b, t % b).
template <typename T>
__global__ void block_runs(const T* __restrict__ a, const T* __restrict__ b,
                           const int* __restrict__ pair_a,
                           const int* __restrict__ pair_b,
                           const int* __restrict__ run_start,
                           const int* __restrict__ run_c, T* __restrict__ out,
                           int bs) {
  __shared__ float a_s[kMaxBlock * kMaxBlock];
  __shared__ float b_s[kMaxBlock * kMaxBlock];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int row = t / bs;
  const int col = t - row * bs;
  const int64_t bb = static_cast<int64_t>(bs) * bs;
  const int end = run_start[r + 1];
  float acc = 0.f;
  for (int i = run_start[r]; i < end; ++i) {
    a_s[t] = to_f32(a[pair_a[i] * bb + t]);
    b_s[t] = to_f32(b[pair_b[i] * bb + t]);
    __syncthreads();
    for (int k = 0; k < bs; ++k) {
      acc = fmaf(a_s[row * bs + k], b_s[k * bs + col], acc);
    }
    __syncthreads();
  }
  out[run_c[r] * bb + t] = from_f32<T>(acc);
}

template <typename T>
void launch(const void* a, const void* b, const int* pa, const int* pb,
            const int* rs, const int* rc, void* out, int n_runs, int block,
            cudaStream_t stream) {
  const T* a_t = static_cast<const T*>(a);
  const T* b_t = static_cast<const T*>(b);
  T* out_t = static_cast<T*>(out);
  if (block == 1) {
    const int grid = (n_runs + kScalarThreads - 1) / kScalarThreads;
    scalar_runs<T><<<grid, kScalarThreads, 0, stream>>>(a_t, b_t, pa, pb, rs, rc,
                                                        out_t, n_runs);
  } else {
    block_runs<T><<<n_runs, block * block, 0, stream>>>(a_t, b_t, pa, pb, rs, rc,
                                                        out_t, block);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns cudaGetLastError()
// after the launch (0 on success); the wrapper raises on anything else.
extern "C" int repro_bsr_spgemm(const void* a, const void* b, const void* pair_a,
                                const void* pair_b, const void* run_start,
                                const void* run_c, void* out, int n_runs,
                                int block, int dtype, void* stream) {
  if (n_runs < 0 || block < 1 || block > kMaxBlock || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_runs > 0) {
    const int* pa = static_cast<const int*>(pair_a);
    const int* pb = static_cast<const int*>(pair_b);
    const int* rs = static_cast<const int*>(run_start);
    const int* rc = static_cast<const int*>(run_c);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
      case 0:
        launch<float>(a, b, pa, pb, rs, rc, out, n_runs, block, st);
        break;
      case 1:
        launch<__nv_bfloat16>(a, b, pa, pb, rs, rc, out, n_runs, block, st);
        break;
      default:
        launch<__half>(a, b, pa, pb, rs, rc, out, n_runs, block, st);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
