// CoordAtt strip-pool, gate-add and gate-dots kernels for Hopper (sm_90a).
//
// They replace the Pallas kernels of stc_unet_tpu/ops/coordatt_fused.py:
//   K1  stc_strip_pools  <- _pools_call / _pools_kernel (public strip_pools)
//   K2  stc_gate_add     <- _gate_add_call / _gate_add_kernel (public gate_add)
//   K2b stc_gate_dots    <- _gate_dots_call / _gate_dots_kernel (the backward
//                           of gate_add)
//
// x (or do) is (N, H, W, C) and contiguous: the NHWC view of a channels_last
// NCHW tensor. Types: float32 (dtype 0) and bfloat16 (dtype 1).
//
// All three are bound by device-memory bytes, not by operations: K1 does
// two adds per element read (0.5 flop/byte in f32), K2 one multiply and one
// add per element read and written, K2b two multiply-adds per element of do
// read. The least time is the bytes moved over the 3.35 TB/s of an H100 SXM.
// What each design does about that bound:
//
// K1 reads x exactly once. The TPU kernel carried the sum over H across a
// sequential grid axis; Hopper's blocks run in no order, so one block takes
// (n, 32 channels, a band of 64 rows). Threads run along C, so a warp reads
// 32 neighbouring channels of one pixel (coalesced). Each thread owns 8
// rows of the band and sums them over all of W in registers, so the sum
// over W of every row is written once, complete. The sum over W is taken in
// chunks of 32 columns: each chunk is summed into a fresh partial that is
// then added to the row's total, so no sum adds more than 32 + W/32 terms
// one after another. The band's column sums go through shared memory into
// an f32 scratch (N, bands, W, C) -- 1/64 of x's elements -- and a second
// small pass adds the bands in order. With one band (H <= 64) the first
// pass writes the sum over H directly. No float atomics: every sum is taken
// in a fixed order, so the output is the same bit for bit from run to run.
//
// K2b is K1's design with the products in it: dh[n,h,c] = sum_w do*a_w is
// K1's row sum with each term scaled by a_w[n,w,c], and dw[n,w,c] =
// sum_h do*a_h its column sum with each term scaled by a_h[n,h,c]. A thread
// keeps a_h of its 8 rows in registers and reads a_w[n,w,c] once for its 8
// rows. do is read once; a_h and a_w are small and stay in L2. The products
// and sums are in f32, as the TPU kernel takes them, whatever do's type.
//
// K2 is one read of x and one write of out, with 16-byte vector loads and
// stores along C (4 floats or 8 bfloat16) and a scalar path when C or an
// address does not allow them. a_h and a_w are small and stay in L2. The
// roundings are JAX's: in bfloat16, p = bf16(f32(a_h) * f32(a_w)) and then
// out = bf16(f32(p) + f32(x)); in float32 the product and the sum are each
// rounded (no fused multiply-add), as two separate ops round them.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kPoolLanes = 32;    // channels per block (threadIdx.x)
constexpr int kPoolTy = 8;        // thread rows per block (threadIdx.y)
constexpr int kPoolRpt = 8;       // rows of the band owned by each thread
constexpr int kPoolBand = kPoolTy * kPoolRpt;  // 64 rows per block
constexpr int kPoolChunk = 32;    // columns per shared-memory round

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Pass 1 of K1 (kDots false) and of K2b (kDots true). Grid N * bands *
// ceil(C / 32) in that order, channel blocks fastest (a 1-D grid, so N may
// pass 65535); block (32, 8). K1: row_out = sum over W of x, col_out = the
// band's sum over H of x. K2b: x is do, row_out = sum over W of do * a_w,
// col_out = the band's sum over H of do * a_h.
template <typename T, bool kDots>
__global__ void __launch_bounds__(kPoolLanes * kPoolTy)
strip_band(const T* __restrict__ x, const T* __restrict__ a_h,
           const T* __restrict__ a_w, float* __restrict__ row_out,
           float* __restrict__ col_out, int bands, int H, int W, int C) {
  __shared__ float part[kPoolTy][kPoolChunk][kPoolLanes];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int cblocks = (C + kPoolLanes - 1) / kPoolLanes;
  const int64_t nb = blockIdx.x / cblocks;  // n * bands + band
  const int c0 = (int)(blockIdx.x - nb * cblocks) * kPoolLanes;
  const int c = c0 + tx;
  const int64_t n = nb / bands;
  const int band = (int)(nb - n * bands);
  const int h0 = band * kPoolBand;
  const bool c_ok = c < C;
  const int64_t row = (int64_t)W * C;
  const T* xn = x + n * H * row + c;

  float ah[kPoolRpt];
  float row_acc[kPoolRpt];
#pragma unroll
  for (int k = 0; k < kPoolRpt; ++k) {
    const int h = h0 + ty + k * kPoolTy;
    ah[k] = (kDots && c_ok && h < H) ? to_f32(a_h[(n * H + h) * C + c])
                                     : 0.f;
    row_acc[k] = 0.f;
  }

  for (int w0 = 0; w0 < W; w0 += kPoolChunk) {
    const int wn = min(kPoolChunk, W - w0);
    float chunk[kPoolRpt];
#pragma unroll
    for (int k = 0; k < kPoolRpt; ++k) chunk[k] = 0.f;
    for (int j = 0; j < wn; ++j) {
      const T* xw = xn + (int64_t)(w0 + j) * C;
      const float aw =
          (kDots && c_ok) ? to_f32(a_w[(n * W + w0 + j) * C + c]) : 1.f;
      float p = 0.f;
#pragma unroll
      for (int k = 0; k < kPoolRpt; ++k) {
        const int h = h0 + ty + k * kPoolTy;
        if (c_ok && h < H) {
          const float v = to_f32(xw[h * row]);
          if (kDots) {
            chunk[k] += v * aw;
            p += v * ah[k];
          } else {
            chunk[k] += v;
            p += v;
          }
        }
      }
      part[ty][j][tx] = p;
    }
#pragma unroll
    for (int k = 0; k < kPoolRpt; ++k) row_acc[k] += chunk[k];
    __syncthreads();
    // column sums of the band: wn columns x 32 channels, each over 8 rows
    for (int i = ty * kPoolLanes + tx; i < wn * kPoolLanes;
         i += kPoolTy * kPoolLanes) {
      const int j = i / kPoolLanes, l = i % kPoolLanes;
      if (c0 + l < C) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < kPoolTy; ++t) s += part[t][j][l];
        col_out[((n * bands + band) * W + w0 + j) * C + c0 + l] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kPoolRpt; ++k) {
    const int h = h0 + ty + k * kPoolTy;
    if (c_ok && h < H) row_out[(n * H + h) * C + c] = row_acc[k];
  }
}

// Pass 2 of K1 and K2b: out[n, w, c] = sum over bands, in band order.
__global__ void strip_bands(const float* __restrict__ part,
                            float* __restrict__ sum_h, int64_t wc, int bands,
                            int64_t total) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t n = i / wc;
    const float* p = part + n * bands * wc + (i - n * wc);
    float s = 0.f;
    for (int b = 0; b < bands; ++b) s += p[b * wc];
    sum_h[i] = s;
  }
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// K2. Grid (N * H): one block per row of x; threads step along the row in
// vectors of V elements (C % V == 0, so a vector never leaves a pixel).
template <typename T, int V>
__global__ void __launch_bounds__(256)
gate_add_rows(const T* __restrict__ x, const T* __restrict__ a_h,
              const T* __restrict__ a_w, T* __restrict__ out, int H, int W,
              int C) {
  using VecT = Vec<T, V>;
  const int64_t r = blockIdx.x;  // n * H + h
  const int64_t n = r / H;
  const int cv = C / V;
  const int row_vecs = W * cv;
  const VecT* xr = reinterpret_cast<const VecT*>(x + r * W * C);
  VecT* outr = reinterpret_cast<VecT*>(out + r * W * C);
  const VecT* ah = reinterpret_cast<const VecT*>(a_h + r * C);
  const VecT* aw = reinterpret_cast<const VecT*>(a_w + n * W * C);
  for (int j = threadIdx.x; j < row_vecs; j += blockDim.x) {
    const int w = j / cv, k = j - w * cv;
    const VecT xv = xr[j];
    const VecT hv = ah[k];
    const VecT wv = aw[w * cv + k];
    VecT o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const T p = from_f32<T>(__fmul_rn(to_f32(hv.v[e]), to_f32(wv.v[e])));
      o.v[e] = from_f32<T>(__fadd_rn(to_f32(p), to_f32(xv.v[e])));
    }
    outr[j] = o;
  }
}

// Whether a strip launch is refused: bands must be ceil(H / 64), and the
// grid of N * bands * ceil(C / 32) blocks within the launch limit.
bool bad_strip(int bands, int N, int H, int C) {
  return bands != (H + kPoolBand - 1) / kPoolBand ||
         (long long)N * bands * ((C + kPoolLanes - 1) / kPoolLanes) > INT_MAX;
}

// Both passes of K1 (kDots false) or K2b (kDots true).
template <typename T, bool kDots>
void launch_strip(const void* x, const void* a_h, const void* a_w,
                  void* row_out, void* col_out, void* scratch, int bands,
                  int N, int H, int W, int C, cudaStream_t s) {
  float* col = bands == 1 ? static_cast<float*>(col_out)
                          : static_cast<float*>(scratch);
  const dim3 grid(N * bands * ((C + kPoolLanes - 1) / kPoolLanes));
  const dim3 block(kPoolLanes, kPoolTy);
  strip_band<T, kDots><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(a_h),
      static_cast<const T*>(a_w), static_cast<float*>(row_out), col, bands,
      H, W, C);
  if (bands > 1) {
    const int64_t wc = (int64_t)W * C, total = (int64_t)N * wc;
    const int64_t want = (total + 255) / 256;
    const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
    strip_bands<<<blocks, 256, 0, s>>>(
        col, static_cast<float*>(col_out), wc, bands, total);
  }
}

template <typename T, int V>
void launch_gate_add(const void* x, const void* a_h, const void* a_w,
                     void* out, int N, int H, int W, int C, cudaStream_t s) {
  gate_add_rows<T, V><<<(unsigned)((int64_t)N * H), 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(a_h),
      static_cast<const T*>(a_w), static_cast<T*>(out), H, W, C);
}

}  // namespace

extern "C" {

// bands: ceil(H / 64), the caller's count of 64-row bands; it sizes the
// scratch (N, bands, W, C) f32 that the first pass fills when bands > 1.
// Any other count, or a grid past the launch limit (N * bands * ceil(C /
// 32) over 2^31 - 1 blocks), is refused with cudaErrorInvalidValue, before
// a launch.
int stc_strip_pools(const void* x, void* sum_w, void* sum_h, void* scratch,
                    int dtype, int bands, int N, int H, int W, int C,
                    void* stream) {
  if (bad_strip(bands, N, H, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_strip<float, false>(x, nullptr, nullptr, sum_w, sum_h, scratch,
                               bands, N, H, W, C, s);
  else
    launch_strip<__nv_bfloat16, false>(x, nullptr, nullptr, sum_w, sum_h,
                                       scratch, bands, N, H, W, C, s);
  return (int)cudaGetLastError();
}

// K2b: dh (N, H, C) and dw (N, W, C), both f32, from do (N, H, W, C) and
// a_h (N, H, C), a_w (N, W, C) in do's type. bands and scratch as for
// stc_strip_pools.
int stc_gate_dots(const void* d_out, const void* a_h, const void* a_w,
                  void* dh, void* dw, void* scratch, int dtype, int bands,
                  int N, int H, int W, int C, void* stream) {
  if (bad_strip(bands, N, H, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_strip<float, true>(d_out, a_h, a_w, dh, dw, scratch, bands, N, H,
                              W, C, s);
  else
    launch_strip<__nv_bfloat16, true>(d_out, a_h, a_w, dh, dw, scratch,
                                      bands, N, H, W, C, s);
  return (int)cudaGetLastError();
}

// vec: 1 for 16-byte vectors (C a multiple of 16 / itemsize and every
// pointer 16-byte aligned), 0 for the scalar path. N * H is the grid:
// past 2^31 - 1 rows it is refused.
int stc_gate_add(const void* x, const void* a_h, const void* a_w, void* out,
                 int dtype, int vec, int N, int H, int W, int C,
                 void* stream) {
  if ((long long)N * H > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec)
      launch_gate_add<float, 4>(x, a_h, a_w, out, N, H, W, C, s);
    else
      launch_gate_add<float, 1>(x, a_h, a_w, out, N, H, W, C, s);
  } else {
    if (vec)
      launch_gate_add<__nv_bfloat16, 8>(x, a_h, a_w, out, N, H, W, C, s);
    else
      launch_gate_add<__nv_bfloat16, 1>(x, a_h, a_w, out, N, H, W, C, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
