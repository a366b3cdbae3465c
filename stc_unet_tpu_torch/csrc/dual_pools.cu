// Single-pass dual strip pool (P), for Hopper (sm_90a).
//
// It replaces the Pallas kernel of the CoordAtt probe,
// tools/probe_coordatt.py:100 _pools_pallas (kernel _dual_pool_kernel :89):
// x (N, H, W, C) -> (sum over W (N, H, C), sum over H (N, W, C)), both
// float32, from float32 or bfloat16 x. It is K1's function
// (csrc/coordatt_fused.cu stc_strip_pools) in the TPU probe's design: the
// TPU kernel walks H in order on its sequential grid and carries the sum over
// H of every column in its output block. Here one block takes one image and
// 32 channels and walks H in order itself; the carried column sums (W x 32
// f32, 32 KB at W = 256) live in shared memory. x is read once, with no
// second pass and no atomics. K1 instead cuts H into bands that run in
// parallel and adds the bands' column sums in an ordered second pass.
//
// What bounds it on an H100 SXM: bytes. At the probe's B=14 slide-tile
// stages it must read x once (bf16: 29.4 MB per stage) and write the two
// small outputs. The design leaves bandwidth on the table on purpose, as the
// probe's subject: a block's threads read 32 channels (64 bytes in bf16) per
// pixel, and there are only N * C / 32 blocks (56 at the 256^2 x 128 stage,
// under the 132 SMs).
//
// Layout: 256 threads, 8 warps; lane c is channel c0 + c. Warp w takes the
// columns w, w + 8, ...: it adds each pixel into the column's carried sum
// (one thread owns each (column, channel), so the sum over H runs in row
// order) and into its own part of the row's sum over W. The parts of 8 rows
// meet in shared memory, and a thread per (row, channel) adds its 8 parts in
// warp order. Every sum runs in a fixed order, so reruns are bit-identical.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 32;   // channels of a block
constexpr int kRows = 8;     // rows whose parts meet at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Grid (ceil(C / 32), N), 256 threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_pools(const T* __restrict__ x, float* __restrict__ sum_w,
           float* __restrict__ sum_h, int H, int W, int C) {
  extern __shared__ float smem[];
  float* col = smem;                  // W x 32: the sum over H so far
  float* part = col + W * kLanes;     // kRows x kWarps x 32: row parts
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kLanes + lane;
  const bool on = c < C;
  const int n = blockIdx.y;
  for (int w = warp; w < W; w += kWarps) col[w * kLanes + lane] = 0.f;
  const T* xn = x + (size_t)n * H * W * C;
  for (int h0 = 0; h0 < H; h0 += kRows) {
    const int rows = min(kRows, H - h0);
    for (int r = 0; r < rows; ++r) {
      const T* xr = xn + (size_t)(h0 + r) * W * C;
      float acc = 0.f;
      for (int w = warp; w < W; w += kWarps) {
        const float v = on ? to_f32(xr[(size_t)w * C + c]) : 0.f;
        acc += v;
        col[w * kLanes + lane] += v;
      }
      part[(r * kWarps + warp) * kLanes + lane] = acc;
    }
    __syncthreads();
    // thread (r, lane) of the first rows * 32 adds row r's parts in order
    if (threadIdx.x < rows * kLanes) {
      const int r = threadIdx.x >> 5;
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < kWarps; ++p)
        s += part[(r * kWarps + p) * kLanes + lane];
      if (on) sum_w[((size_t)n * H + h0 + r) * C + c] = s;
    }
    __syncthreads();  // the parts are free for the next rows
  }
  if (!on) return;
  for (int w = warp; w < W; w += kWarps)
    sum_h[((size_t)n * W + w) * C + c] = col[w * kLanes + lane];
}

size_t smem_bytes(int W) {
  return sizeof(float) * ((size_t)W * kLanes + kRows * kWarps * kLanes);
}

template <typename T>
int launch(const void* x, void* sum_w, void* sum_h, int N, int H, int W,
           int C, cudaStream_t s) {
  const size_t bytes = smem_bytes(W);
  const cudaError_t err = cudaFuncSetAttribute(
      dual_pools<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + kLanes - 1) / kLanes, N);
  dual_pools<T><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<float*>(sum_w),
      static_cast<float*>(sum_h), H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest W the kernel takes: its column sums fill the 227 KB of shared
// memory a block may have.
int stc_dual_pools_max_w() {
  return (int)((232448 - smem_bytes(0)) / (sizeof(float) * kLanes));
}

// x (N, H, W, C) contiguous, float32 (dtype 0) or bfloat16 (dtype 1);
// sum_w (N, H, C) and sum_h (N, W, C) contiguous float32.
int stc_dual_pools(const void* x, void* sum_w, void* sum_h, int dtype, int N,
                   int H, int W, int C, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 ||
      W > stc_dual_pools_max_w())
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, sum_w, sum_h, N, H, W, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, sum_w, sum_h, N, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
