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
// K1 and K2b are one kernel, strip_band, which reads x exactly once, and a
// small second pass, strip_bands. The TPU kernel carried the sum over H
// across a sequential grid axis; Hopper's blocks run in no order, so the
// rows are cut into bands of 64 and a block takes one (image, band, channel
// tile).
//
// - Loads. A warp is 4 workers of 8 lanes. A worker reads 128 bytes of one
//   pixel of one row, one 16-byte vector a lane (8 bfloat16 or 4 floats of
//   a channel tile of 64 or 32 channels), so every load instruction of a
//   warp reads 4 whole 128-byte lines itself, whatever order the blocks run
//   in. Where C is not a multiple of the tile or a tensor is not 16-byte
//   aligned, the wrapper picks the same kernel with one element a lane.
// - Bytes in flight. A block of up to 16 warps owns the band's 64 rows, one
//   a worker, and each worker walks all of W along its row in groups of 8
//   pixels: the next group's loads are issued before the current group is
//   summed, so 8 to 16 vectors (128 to 256 bytes) a lane, 64 to 128 KB a
//   block, are in flight, across the block's barriers too. The 8 loads of a
//   group are issued and waited on together; a register ring that issued
//   each load as its register was read was slower at the same depth.
// - The sum over W (sum_w) is the worker's own: each lane adds its pixels
//   into a chunk partial of at most 32 pixels, which is then added to the
//   row's total, so no sum adds more than 32 + W/16 terms one after
//   another; the total is stored once, complete.
// - The sum over H (sum_h) of each pixel is added over the 4 workers of a
//   warp by shuffles (a reduce-scatter: each worker keeps a quarter of the
//   channels) and over the warps of the block through shared memory in warp
//   order, a chunk of 16 or 32 pixels at a time, and stored: to sum_h
//   itself when H is one band, else to an f32 scratch (N, bands, W, C), 1/64
//   of x's elements, which strip_bands adds in band order. Adding the bands
//   through distributed shared memory in a cluster of up to 8 blocks was
//   slower: with one 512-thread block an SM the card holds 15 clusters of 8
//   (30 of 4) at once, so the 16 (32) clusters of the train step's 512²
//   (256²) stage ran in two waves.
// - No float atomics: every sum is taken in a fixed order, so the output is
//   the same bit for bit from run to run.
//
// K2b is K1 with the products in it: dh[n,h,c] = sum_w do*a_w is K1's row
// sum with each term scaled by a_w[n,w,c], and dw[n,w,c] = sum_h do*a_h its
// column sum with each term scaled by a_h[n,h,c]. A lane keeps a_h of its
// row in registers for the whole walk; a_w of each chunk is staged in
// shared memory as f32, read one chunk ahead. do is read once; a_h and a_w
// are small and stay in L2. The products and sums are in f32, as the TPU
// kernel takes them, whatever do's type.
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

constexpr int kLanes = 8;        // lanes of a worker: 8 vectors of 16 bytes
constexpr int kSlots = 4;        // workers a warp, one row each
constexpr int kMaxWarps = 16;    // warps a block: bands of up to 64 rows
constexpr int kGroup = 8;        // pixels a lane loads at once
constexpr int kChunkFloats = 1024;  // a warp's column partials a chunk

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

// The raw type of V elements of T that one lane loads: a 16-byte vector,
// or one element on the scalar path.
template <typename T, int V> struct Raw;
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Raw<float, 1> { using type = float; };
template <> struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };

__device__ __forceinline__ void unpack(float4 r, float (&f)[4]) {
  f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
}
__device__ __forceinline__ void unpack(uint4 r, float (&f)[8]) {
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // the lower address is the lower half
    f[2 * k] = __uint_as_float(u[k] << 16);
    f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(float r, float (&f)[1]) { f[0] = r; }
__device__ __forceinline__ void unpack(unsigned short r, float (&f)[1]) {
  f[0] = __uint_as_float((unsigned)r << 16);
}

template <typename T, int V>
__device__ __forceinline__ typename Raw<T, V>::type load_raw(const T* p,
                                                             bool ok) {
  using R = typename Raw<T, V>::type;
  return ok ? __ldg(reinterpret_cast<const R*>(p)) : R{};
}

// Pixels a chunk: a warp's column partials of a chunk hold kChunkFloats
// floats, and a chunk is at most 32 pixels (the row sum's chunk).
template <int V>
constexpr int kChunkPixels =
    kChunkFloats / (kLanes * V) < 32 ? kChunkFloats / (kLanes * V) : 32;

// p (a worker's V column terms of one pixel) summed over the 4 workers of
// the warp, then stored to dst, the warp's partials of the pixel at this
// lane's first channel. For V >= 4 a reduce-scatter: after the exchange
// over worker bit 1 (lane ^ 16) each worker keeps half of the channels,
// after bit 0 (lane ^ 8) a quarter, which it stores; every channel is
// (w0 + w2) + (w1 + w3) or its mirror, the same bits.
template <int V>
__device__ __forceinline__ void slot_sum_store(const float (&p)[V], int slot,
                                               float* dst) {
  if constexpr (V == 1) {
    float s = p[0] + __shfl_xor_sync(0xffffffffu, p[0], 16);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    if (slot == 0) dst[0] = s;
  } else {
    constexpr int H1 = V / 2, H2 = V / 4;
    const bool b1 = slot & 2, b0 = slot & 1;
    float q[H1], r[H2];
#pragma unroll
    for (int k = 0; k < H1; ++k) {
      const float send = b1 ? p[k] : p[k + H1];
      q[k] = (b1 ? p[k + H1] : p[k]) +
             __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
    for (int k = 0; k < H2; ++k) {
      const float send = b0 ? q[k] : q[k + H2];
      r[k] = (b0 ? q[k + H2] : q[k]) + __shfl_xor_sync(0xffffffffu, send, 8);
    }
    dst += (b1 ? H1 : 0) + (b0 ? H2 : 0);
#pragma unroll
    for (int k = 0; k < H2; ++k) dst[k] = r[k];
  }
}

// E floats from or to p: 16-byte vectors where E is a multiple of 4 (p
// then 16-byte aligned), else one float.
template <int E>
__device__ __forceinline__ void load_floats(const float* p, float (&f)[E]) {
  if constexpr (E % 4) {
    f[0] = p[0];
  } else {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + e);
      f[e] = t.x; f[e + 1] = t.y; f[e + 2] = t.z; f[e + 3] = t.w;
    }
  }
}
template <int E>
__device__ __forceinline__ void store_floats(float* p, const float (&f)[E]) {
  if constexpr (E % 4) {
    p[0] = f[0];
  } else {
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(p + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

// The end of one chunk (pixels w0 .. w0 + ck): the warps' partials summed
// in warp order and stored to col (the chunk's first pixel at the tile's
// first channel, pixels C apart).
template <int V>
__device__ __forceinline__ void chunk_sums(const float* part,
                                           float* __restrict__ col,
                                           int warps, int ck, int c0,
                                           int C) {
  constexpr int CT = kLanes * V, CK = kChunkPixels<V>;
  constexpr int E = V == 1 ? 1 : 4;  // C is a multiple of CT when V > 1
  __syncthreads();
  for (int i = threadIdx.x * E; i < ck * CT; i += blockDim.x * E) {
    if (c0 + i % CT >= C) continue;
    float s[E] = {}, t[E];
    for (int q = 0; q < warps; ++q) {
      load_floats(part + q * CK * CT + i, t);
#pragma unroll
      for (int e = 0; e < E; ++e) s[e] += t[e];
    }
    store_floats(col + i / CT * C + i % CT, s);
  }
}

// The bytes of dynamic shared memory of a block of `warps` warps: the
// warps' partials of two chunks and (K2b) a_w of two chunks, all f32.
template <int V, bool kDots>
size_t strip_smem(int warps) {
  return ((size_t)2 * warps + (kDots ? 2 : 0)) * kChunkPixels<V> * kLanes *
         V * sizeof(float);
}

// Pass 1 of K1 (kDots false) and K2b (kDots true). A 1-D grid of N * bands
// * tiles blocks in that order, channel tiles fastest; a block of `warps`
// warps takes one band of 4 * warps rows. K1: row_out = sum over W of x,
// col_out[n, band] = the band's sum over H of x. K2b: x is do, row_out =
// sum over W of do * a_w, col_out[n, band] = the band's sum over H of do *
// a_h. col_out is (N, bands, W, C). Dynamic shared memory:
// strip_smem<V, kDots>(warps).
template <typename T, int V, bool kDots>
__global__ void __launch_bounds__(kMaxWarps * 32)
strip_band(const T* __restrict__ x, const T* __restrict__ a_h,
           const T* __restrict__ a_w, float* __restrict__ row_out,
           float* __restrict__ col_out, int bands, int tiles, int H, int W,
           int C) {
  using R = typename Raw<T, V>::type;
  constexpr int CT = kLanes * V, CK = kChunkPixels<V>, G = kGroup;
  static_assert(CK % G == 0, "a load group never spans two chunks");
  extern __shared__ float4 smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = lane / kLanes;
  float* part = reinterpret_cast<float*>(smem);  // [2][warps][CK][CT]
  float* aws = part + 2 * warps * CK * CT;        // K2b: [2][CK][CT]
  const int64_t nb = blockIdx.x / tiles;          // n * bands + band
  const int64_t n = nb / bands;
  const int band = (int)(nb - n * bands);
  const int c0 = (int)(blockIdx.x - nb * tiles) * CT;
  const int cl = (lane % kLanes) * V;  // the lane's first channel in the tile
  const bool c_ok = c0 + cl < C;
  const int c = c_ok ? c0 + cl : 0;
  const int h = band * warps * kSlots + warp * kSlots + slot;
  const bool live = c_ok && h < H;
  const int64_t nh = n * H + (h < H ? h : H - 1);
  const T* xr = x + nh * W * C + c;
  float* col = col_out + nb * W * C + c0;
  // K2b: a_w of a chunk (CK pixels of the tile, V elements a lane) goes
  // to shared memory as f32, read one chunk ahead into a register where
  // the block has a thread for each vector, else copied at the chunk's end
  const bool aw_ahead = blockDim.x >= CK * kLanes;
  auto aw_load = [&](int i, int w0) {
    const int w = w0 + i / kLanes, cc = c0 + (i % kLanes) * V;
    return load_raw<T, V>(
        a_w + (n * W + (w < W ? w : 0)) * C + (cc < C ? cc : 0),
        cc < C && w < W);
  };
  auto aw_store = [&](float* dst, int i, R r) {
    float f[V];
    unpack(r, f);
    store_floats(dst + (i / kLanes) * CT + (i % kLanes) * V, f);
  };
  if constexpr (kDots) {
    for (int i = threadIdx.x; i < CK * kLanes; i += blockDim.x)
      aw_store(aws, i, aw_load(i, 0));
    __syncthreads();
  }
  float ah[V], chunk[V], total[V];
  if constexpr (kDots) unpack(load_raw<T, V>(a_h + nh * C + c, live), ah);
#pragma unroll
  for (int v = 0; v < V; ++v) chunk[v] = total[v] = 0.f;
  R cur[G], nxt[G], aw_next{};
#pragma unroll
  for (int u = 0; u < G; ++u)
    cur[u] = load_raw<T, V>(xr + (int64_t)u * C, live && u < W);
  int parity = 0;
  for (int wg = 0; wg < W; wg += G) {
    // the next group's loads go out before this group is summed
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int w = wg + G + u;
      nxt[u] = load_raw<T, V>(xr + (int64_t)w * C, live && w < W);
    }
    const int next_w0 = wg / CK * CK + CK;  // the next chunk's first pixel
    if constexpr (kDots) {
      if (wg % CK == 0 && aw_ahead && threadIdx.x < CK * kLanes)
        aw_next = aw_load(threadIdx.x, next_w0);
    }
    const float* aw_cur = aws + parity * CK * CT + cl;
    float* my_part = part + (parity * warps + warp) * CK * CT + cl;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int w = wg + u;
      if (w >= W) break;
      float f[V], p[V];
      unpack(cur[u], f);
      if constexpr (kDots) {
        float aw[V];
        load_floats(aw_cur + (w % CK) * CT, aw);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          chunk[v] += f[v] * aw[v];
          p[v] = f[v] * ah[v];
        }
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          chunk[v] += f[v];
          p[v] = f[v];
        }
      }
      slot_sum_store<V>(p, slot, my_part + (w % CK) * CT);
    }
    const int w_end = min(wg + G, W);
    if (w_end % CK == 0 || w_end == W) {  // a chunk of CK pixels ends
#pragma unroll
      for (int v = 0; v < V; ++v) {
        total[v] += chunk[v];
        chunk[v] = 0.f;
      }
      if constexpr (kDots) {
        float* dst = aws + (parity ^ 1) * CK * CT;
        if (!aw_ahead) {
          for (int i = threadIdx.x; i < CK * kLanes; i += blockDim.x)
            aw_store(dst, i, aw_load(i, next_w0));
        } else if (threadIdx.x < CK * kLanes) {
          aw_store(dst, threadIdx.x, aw_next);
        }
      }
      const int w0 = (w_end - 1) / CK * CK;
      chunk_sums<V>(part + parity * warps * CK * CT, col + (int64_t)w0 * C,
                    warps, w_end - w0, c0, C);
      parity ^= 1;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) cur[u] = nxt[u];
  }
  if (live) store_floats(row_out + nh * C + c, total);
}

// Pass 2 of K1 and K2b: sum_h[n, w, c] = the sum over bands of part[n,
// band, w, c], in band order; E floats a thread (E = 4 where W * C is a
// multiple of 4).
template <int E>
__global__ void strip_bands(const float* __restrict__ part,
                            float* __restrict__ sum_h, int64_t wc, int bands,
                            int64_t total) {
  for (int64_t i = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) * E;
       i < total; i += (int64_t)gridDim.x * blockDim.x * E) {
    const int64_t n = i / wc;
    const float* p = part + n * bands * wc + (i - n * wc);
    float s[E] = {}, t[E];
    for (int b = 0; b < bands; ++b) {
      load_floats(p + b * wc, t);
#pragma unroll
      for (int e = 0; e < E; ++e) s[e] += t[e];
    }
    store_floats(sum_h + i, s);
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

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// Both passes of K1 (kDots false) or K2b (kDots true) with the caller's
// plan: blocks of `warps` warps, `bands` bands of 4 * warps rows; with more
// than one band, pass 1 writes the bands' column sums to scratch (N, bands,
// W, C) f32 and pass 2 adds them into col_out. A plan whose bands are not
// ceil(H / (4 * warps)), whose warps are out of range or whose grid passes
// the launch limit (N * bands * ceil(C / CT) over 2^31 - 1 blocks), or a
// vector path (V > 1) whose C is not a multiple of the tile or whose
// pointers are not 16-byte aligned, is refused with cudaErrorInvalidValue
// before a launch.
template <typename T, int V, bool kDots>
int launch_strip(const void* x, const void* a_h, const void* a_w,
                 void* row_out, void* col_out, void* scratch, int warps,
                 int bands, int N, int H, int W, int C, cudaStream_t s) {
  constexpr int CT = kLanes * V;
  const int tiles = (C + CT - 1) / CT;
  const long long blocks = (long long)N * bands * tiles;
  if (warps < 1 || warps > kMaxWarps ||
      bands != (H + warps * kSlots - 1) / (warps * kSlots) ||
      blocks > INT_MAX || (bands > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (V > 1 && (C % CT || misaligned(x) || misaligned(row_out) ||
                misaligned(col_out) || misaligned(scratch) ||
                (kDots && (misaligned(a_h) || misaligned(a_w)))))
    return (int)cudaErrorInvalidValue;
  const auto kernel = strip_band<T, V, kDots>;
  const size_t smem = strip_smem<V, kDots>(warps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  float* col = static_cast<float*>(bands > 1 ? scratch : col_out);
  kernel<<<(unsigned)blocks, warps * 32, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(a_h),
      static_cast<const T*>(a_w), static_cast<float*>(row_out), col, bands,
      tiles, H, W, C);
  if (bands > 1) {
    const int64_t wc = (int64_t)W * C, total = (int64_t)N * wc;
    const bool vec4 = wc % 4 == 0 && !misaligned(scratch) &&
                      !misaligned(col_out);
    const int64_t want = (total / (vec4 ? 4 : 1) + 255) / 256;
    const int grid = (int)(want < 132 * 16 ? want : 132 * 16);
    if (vec4)
      strip_bands<4><<<grid, 256, 0, s>>>(
          col, static_cast<float*>(col_out), wc, bands, total);
    else
      strip_bands<1><<<grid, 256, 0, s>>>(
          col, static_cast<float*>(col_out), wc, bands, total);
  }
  return (int)cudaGetLastError();
}

// K1 or K2b in x's type (dtype 0 float32, 1 bfloat16), on 16-byte vectors
// (vec 1) or one element a lane (vec 0).
template <bool kDots>
int strip_entry(const void* x, const void* a_h, const void* a_w,
                void* row_out, void* col_out, void* scratch, int dtype,
                int vec, int warps, int bands, int N, int H, int W, int C,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch_strip<float, 4, kDots>(x, a_h, a_w, row_out, col_out,
                                               scratch, warps, bands, N, H,
                                               W, C, s)
               : launch_strip<float, 1, kDots>(x, a_h, a_w, row_out, col_out,
                                               scratch, warps, bands, N, H,
                                               W, C, s);
  return vec ? launch_strip<__nv_bfloat16, 8, kDots>(
                   x, a_h, a_w, row_out, col_out, scratch, warps, bands, N,
                   H, W, C, s)
             : launch_strip<__nv_bfloat16, 1, kDots>(
                   x, a_h, a_w, row_out, col_out, scratch, warps, bands, N,
                   H, W, C, s);
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

// K1: sum_w (N, H, C) and sum_h (N, W, C), both f32, from x (N, H, W, C).
// The plan is the caller's (ops/coordatt_fused.py strip_plan): vec, warps
// a block and bands; scratch is (N, bands, W, C) f32 when bands > 1 (else
// unused). launch_strip says what it refuses.
int stc_strip_pools(const void* x, void* sum_w, void* sum_h, void* scratch,
                    int dtype, int vec, int warps, int bands, int N, int H,
                    int W, int C, void* stream) {
  return strip_entry<false>(x, nullptr, nullptr, sum_w, sum_h, scratch,
                            dtype, vec, warps, bands, N, H, W, C, stream);
}

// K2b: dh (N, H, C) and dw (N, W, C), both f32, from do (N, H, W, C) and
// a_h (N, H, C), a_w (N, W, C) in do's type. The plan and scratch as for
// stc_strip_pools.
int stc_gate_dots(const void* d_out, const void* a_h, const void* a_w,
                  void* dh, void* dw, void* scratch, int dtype, int vec,
                  int warps, int bands, int N, int H, int W, int C,
                  void* stream) {
  return strip_entry<true>(d_out, a_h, a_w, dh, dw, scratch, dtype, vec,
                           warps, bands, N, H, W, C, stream);
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
