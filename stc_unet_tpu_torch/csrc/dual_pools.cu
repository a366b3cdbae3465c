// Single-pass dual strip pool (P), for Hopper (sm_90a).
//
// It replaces the Pallas kernel of the CoordAtt probe,
// tools/probe_coordatt.py:100 _pools_pallas (kernel _dual_pool_kernel :89):
// x (N, H, W, C) -> (sum over W (N, H, C), sum over H (N, W, C)), both
// float32, from float32 or bfloat16 x. The TPU kernel takes row blocks in
// order on its sequential grid and carries the column sums in its output
// block. P keeps that character in a Hopper form: one kernel launch a call,
// x read from device memory once, and the sum over H carried on chip, the
// bands' column partials added inside the same launch. It computes K1's
// function (csrc/coordatt_fused.cu stc_strip_pools) but shares no code with
// it: K1 adds its bands in a second kernel.
//
// What bounds it on an H100 SXM: bytes. It does one add per element for
// each of the two sums, 1 flop a byte in bf16, and must read x once and
// write the two small f32 outputs: at the probe's B=14 bf16 stages 29 to
// 235 MB of x a stage, over 3.35 TB/s. What the design does about it:
//
// - Loads. A warp is 4 workers of 8 lanes. A worker reads the 128 bytes of
//   one pixel of its row in a channel tile, one 16-byte vector a lane (8
//   bfloat16 or 4 floats; a tile of 64 or 32 channels), so each warp load
//   takes 4 whole 128-byte lines. A lane walks W along its row in groups of
//   8 pixels and issues the next group's 8 loads before it adds the
//   current group: 8 to 16 vectors a lane, 64 to 128 KB a 16-warp block,
//   stay in flight. Where C is not a multiple of the tile or a pointer is
//   not 16-byte aligned, the plan (ops/dual_pools.py dual_plan) takes the
//   same kernel with one element a lane and tiles of 8 channels.
// - Parallelism over H. A block of up to 16 warps takes one band of 4 rows
//   a warp (at most 64 rows) of one (image, channel tile); the bands run in
//   parallel, N * tiles * bands blocks on a 1-D grid, bands fastest.
// - The sum over W is the lane's own, in registers: pixels into a chunk
//   (16 or 32 pixels), chunks into a run (32 chunks), runs into the total,
//   stored once: chains of at most 32 terms up to W of 16384 (bf16
//   vectors; 32768 otherwise), 64 up to twice that.
// - The sum over H, a chunk of W at a time: the 4 rows of a warp by
//   shuffles, (r0 + r2) + (r1 + r3), reduce-scattered so that each worker
//   keeps a quarter of the channels; the warps of the block in warp order
//   through shared memory (f32 partials of the chunk, two chunks deep, so
//   one barrier a chunk); then the bands, in band order, inside the launch
//   (the plan's `combine`):
//     one band  the block stores the chunk's sums to sum_h itself;
//     cluster   the bands of one (image, tile) are one thread-block cluster
//               (at most 8 blocks); each block puts its chunk sums in its
//               shared memory, and after a cluster barrier the blocks add
//               the bands' sums through distributed shared memory, each a
//               share of the chunk, and store them;
//     last      each band block stores its chunk sums to an f32 scratch
//               (N * tiles, bands, W, tile), then counts itself in an
//               integer counter of its (image, tile); the block that counts
//               last adds the bands' partials in band order, stores sum_h
//               and sets the counter back to 0. The counters are zeroed
//               once, when the wrapper allocates them.
//   The plan takes a cluster for 2 to 8 bands: at the probe's stages it
//   was 1 to 2 % faster than the last block, and the card holds all of
//   their clusters at once (30 of 4 blocks); past 8 bands, the last block.
//   W is taken a chunk at a time, so shared memory does not limit it. The
//   chains: 16 warps, then H / 64 bands (at most 64 up to H of 4096).
// - No float atomics: every sum is taken in a fixed order, so reruns are
//   bit-identical.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns a cudaError_t as an int.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 8;        // lanes of a worker: 8 vectors of 16 bytes
constexpr int kSlots = 4;        // workers a warp, one row each
constexpr int kMaxWarps = 16;    // warps a block: bands of up to 64 rows
constexpr int kGroup = 8;        // pixels a lane loads at once
constexpr int kChunkFloats = 1024;  // a warp's column partials a chunk
constexpr int kRunChunks = 32;   // chunks of the sum over W a run
constexpr int kMaxCluster = 8;   // bands a cluster (the portable size)
// how the bands' column sums meet (the plan's `combine`)
constexpr int kOneBand = 0, kCluster = 1, kLastBlock = 2;

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
// floats, and a chunk is at most 32 pixels.
template <int V>
constexpr int kChunkPixels =
    kChunkFloats / (kLanes * V) < 32 ? kChunkFloats / (kLanes * V) : 32;

// p (a worker's V column terms of one pixel) summed over the 4 workers of
// the warp, then stored to dst, the warp's partials of the pixel at this
// lane's first channel. For V >= 4 a reduce-scatter: after the exchange
// over worker bit 1 (lane ^ 16) each worker keeps half of the channels,
// after bit 0 (lane ^ 8) a quarter, which it stores; every channel is
// (r0 + r2) + (r1 + r3) or its mirror, the same bits.
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

__device__ __forceinline__ void add4(float4& s, float4 t) {
  s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
}

// Four sums of one pixel to sum_h at dst (channels c .. c + 3 of the
// tile): one 16-byte store on the vector path, else the ones below C
// (c_left = C - c).
template <int V>
__device__ __forceinline__ void put_out(float* dst, float4 s, int c_left) {
  if constexpr (V > 1) {
    *reinterpret_cast<float4*>(dst) = s;
  } else {
    if (c_left > 0) dst[0] = s.x;
    if (c_left > 1) dst[1] = s.y;
    if (c_left > 2) dst[2] = s.z;
    if (c_left > 3) dst[3] = s.w;
  }
}

// The end of one chunk of ck pixels: the block's warps' partials (part,
// [warps][CK][CT]) added in warp order, 4 floats a thread; put(i, s) takes
// the sums of element i (pixel i / CT, channel i % CT of the chunk).
template <int V, typename Put>
__device__ __forceinline__ void warp_sums(const float* part, int warps,
                                          int ck, Put put) {
  constexpr int CT = kLanes * V, CK = kChunkPixels<V>;
  for (int i = threadIdx.x * 4; i < ck * CT; i += blockDim.x * 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < warps; ++q)
      add4(s, *reinterpret_cast<const float4*>(part + q * CK * CT + i));
    put(i, s);
  }
}

// The bytes of dynamic shared memory of a block of `warps` warps: the
// warps' partials of two chunks and, in a cluster, the block's sums of two
// chunks, all f32.
template <int V>
size_t smem_bytes(int warps, int combine) {
  return ((size_t)2 * warps + (combine == kCluster ? 2 : 0)) *
         kChunkPixels<V> * kLanes * V * sizeof(float);
}

// P. A 1-D grid of N * tiles * bands blocks in that order, bands fastest;
// a block of `warps` warps takes one band of 4 * warps rows of one
// (image, channel tile). sum_w (N, H, C) and sum_h (N, W, C) f32. With
// kCombine kLastBlock, scratch holds (N * tiles, bands, W, CT) f32 and
// counters N * tiles zeros. Dynamic shared memory:
// smem_bytes<V>(warps, kCombine).
template <typename T, int V, int kCombine>
__global__ void __launch_bounds__(kMaxWarps * 32)
dual_band(const T* __restrict__ x, float* __restrict__ sum_w,
          float* __restrict__ sum_h, float* __restrict__ scratch,
          unsigned* __restrict__ counters, int bands, int tiles, int H,
          int W, int C) {
  using R = typename Raw<T, V>::type;
  constexpr int CT = kLanes * V, CK = kChunkPixels<V>, G = kGroup;
  static_assert(CK % G == 0, "a load group never spans two chunks");
  extern __shared__ float4 smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = lane / kLanes;
  float* part = reinterpret_cast<float*>(smem);  // [2][warps][CK][CT]
  float* mine = part + 2 * warps * CK * CT;       // cluster: [2][CK][CT]
  const int64_t nt = blockIdx.x / bands;          // n * tiles + tile
  const int band = (int)(blockIdx.x - nt * bands);
  const int64_t n = nt / tiles;
  const int c0 = (int)(nt - n * tiles) * CT;
  const int cl = (lane % kLanes) * V;  // the lane's first channel in the tile
  const bool c_ok = c0 + cl < C;
  const int c = c_ok ? c0 + cl : 0;
  const int h = (band * warps + warp) * kSlots + slot;
  const bool live = c_ok && h < H;
  const int64_t nh = n * H + (h < H ? h : H - 1);
  const T* xr = x + nh * W * C + c;
  float* out_h = sum_h + n * W * C + c0;  // pixel w, channel ct at w*C + ct
  float chunk[V], run[V], total[V];
#pragma unroll
  for (int v = 0; v < V; ++v) chunk[v] = run[v] = total[v] = 0.f;
  R cur[G], nxt[G];
#pragma unroll
  for (int u = 0; u < G; ++u)
    cur[u] = load_raw<T, V>(xr + (int64_t)u * C, live && u < W);
  int parity = 0, chunks = 0;
  for (int wg = 0; wg < W; wg += G) {
    // the next group's loads go out before this group is summed
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int w = wg + G + u;
      nxt[u] = load_raw<T, V>(xr + (int64_t)w * C, live && w < W);
    }
    float* my_part = part + (parity * warps + warp) * CK * CT + cl;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int w = wg + u;
      if (w >= W) break;
      float f[V];
      unpack(cur[u], f);
#pragma unroll
      for (int v = 0; v < V; ++v) chunk[v] += f[v];
      slot_sum_store<V>(f, slot, my_part + (w % CK) * CT);
    }
    const int w_end = min(wg + G, W);
    if (w_end % CK == 0 || w_end == W) {  // a chunk ends
      const bool run_ends = ++chunks == kRunChunks || w_end == W;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        run[v] += chunk[v];
        chunk[v] = 0.f;
        if (run_ends) {
          total[v] += run[v];
          run[v] = 0.f;
        }
      }
      if (run_ends) chunks = 0;
      const int w0 = (w_end - 1) / CK * CK, ck = w_end - w0;
      const float* p = part + parity * warps * CK * CT;
      __syncthreads();  // the warps' partials of the chunk are in
      if constexpr (kCombine == kOneBand) {
        warp_sums<V>(p, warps, ck, [&](int i, float4 s) {
          const int ct = i % CT;
          put_out<V>(out_h + (int64_t)(w0 + i / CT) * C + ct, s, C - c0 - ct);
        });
      } else if constexpr (kCombine == kLastBlock) {
        float* dst = scratch + ((nt * bands + band) * W + w0) * CT;
        warp_sums<V>(p, warps, ck, [&](int i, float4 s) {
          *reinterpret_cast<float4*>(dst + i) = s;
        });
      } else {
        float* buf = mine + parity * CK * CT;
        warp_sums<V>(p, warps, ck, [&](int i, float4 s) {
          *reinterpret_cast<float4*>(buf + i) = s;
        });
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();  // every band's sums of the chunk are in
        // block `band` of the cluster adds every bands-th 4 floats
        for (int i = (threadIdx.x * bands + band) * 4; i < ck * CT;
             i += bands * blockDim.x * 4) {
          float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int b = 0; b < bands; ++b)
            add4(s, *reinterpret_cast<const float4*>(
                        cluster.map_shared_rank(buf, b) + i));
          const int ct = i % CT;
          put_out<V>(out_h + (int64_t)(w0 + i / CT) * C + ct, s, C - c0 - ct);
        }
      }
      parity ^= 1;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) cur[u] = nxt[u];
  }
  if (live) {
    float* dst = sum_w + nh * C + c;
    if constexpr (V == 1) {
      dst[0] = total[0];
    } else {
#pragma unroll
      for (int v = 0; v < V; v += 4)
        *reinterpret_cast<float4*>(dst + v) =
            make_float4(total[v], total[v + 1], total[v + 2], total[v + 3]);
    }
  }
  if constexpr (kCombine == kCluster) {
    // no block leaves while another may still read its shared memory
    cg::this_cluster().sync();
  } else if constexpr (kCombine == kLastBlock) {
    __shared__ bool last;
    __threadfence();  // this block's scratch is visible before it counts
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(counters + nt, 1u) == (unsigned)bands - 1;
      if (last) counters[nt] = 0;  // every band has counted: ready again
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int64_t wct = (int64_t)W * CT;
    const float* src = scratch + nt * bands * wct;
    for (int64_t i = threadIdx.x * 4; i < wct; i += blockDim.x * 4) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int b = 0; b < bands; ++b)  // in band order
        add4(s, __ldcg(reinterpret_cast<const float4*>(src + b * wct + i)));
      const int64_t w = i / CT;
      const int ct = (int)(i - w * CT);
      put_out<V>(out_h + w * C + ct, s, C - c0 - ct);
    }
  }
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

template <typename T, int V, int kCombine>
cudaError_t set_smem(int warps, size_t* bytes) {
  *bytes = smem_bytes<V>(warps, kCombine);
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(dual_band<T, V, kCombine>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

// A launch of `blocks` blocks of `warps` warps in clusters of `cluster`
// consecutive blocks; used in place (cfg points at attr).
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  ClusterLaunch(unsigned blocks, int warps, size_t smem, int cluster,
                cudaStream_t s) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(warps * 32);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// The launch of a plan that plan_ok allows.
template <typename T, int V, int kCombine>
int launch(const void* x, void* sum_w, void* sum_h, void* scratch,
           void* counters, int warps, int bands, int N, int H, int W, int C,
           cudaStream_t s) {
  constexpr int CT = kLanes * V;
  const int tiles = (C + CT - 1) / CT;
  const unsigned blocks = (unsigned)((long long)N * tiles * bands);
  size_t smem;
  cudaError_t err = set_smem<T, V, kCombine>(warps, &smem);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = dual_band<T, V, kCombine>;
  const T* xt = static_cast<const T*>(x);
  float* sw = static_cast<float*>(sum_w);
  float* sh = static_cast<float*>(sum_h);
  float* sc = static_cast<float*>(scratch);
  unsigned* cnt = static_cast<unsigned*>(counters);
  if constexpr (kCombine == kCluster) {
    const ClusterLaunch cl(blocks, warps, smem, bands, s);
    err = cudaLaunchKernelEx(&cl.cfg, kernel, xt, sw, sh, sc, cnt, bands,
                             tiles, H, W, C);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<blocks, warps * 32, smem, s>>>(xt, sw, sh, sc, cnt, bands,
                                            tiles, H, W, C);
  }
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_combine(int combine, const void* x, void* sum_w, void* sum_h,
                   void* scratch, void* counters, int warps, int bands,
                   int N, int H, int W, int C, cudaStream_t s) {
  if (combine == kOneBand)
    return launch<T, V, kOneBand>(x, sum_w, sum_h, scratch, counters, warps,
                                  bands, N, H, W, C, s);
  if (combine == kCluster)
    return launch<T, V, kCluster>(x, sum_w, sum_h, scratch, counters, warps,
                                  bands, N, H, W, C, s);
  return launch<T, V, kLastBlock>(x, sum_w, sum_h, scratch, counters, warps,
                                  bands, N, H, W, C, s);
}

// Whether the plan is one the shape and the pointers allow: bands of 4 *
// warps rows (1 to 16 warps) that cover H, at most 2^31 - 1 blocks; one
// band with combine 0, 2 to 8 bands in a cluster (1), or 2 or more with a
// scratch and counters (2); on the vector path (vec 1) C a multiple of the
// tile and every pointer 16-byte aligned.
bool plan_ok(const void* x, const void* sum_w, const void* sum_h,
             const void* scratch, const void* counters, int dtype, int vec,
             int warps, int bands, int combine, int N, int H, int W, int C) {
  if (dtype != 0 && dtype != 1) return false;
  if (N < 1 || H < 1 || W < 1 || C < 1) return false;
  if (warps < 1 || warps > kMaxWarps ||
      bands != (H + warps * kSlots - 1) / (warps * kSlots))
    return false;
  const int ct = vec ? kLanes * (dtype == 0 ? 4 : 8) : kLanes;
  if ((long long)N * ((C + ct - 1) / ct) * bands > INT_MAX) return false;
  if (combine == kOneBand) {
    if (bands != 1) return false;
  } else if (combine == kCluster) {
    if (bands < 2 || bands > kMaxCluster) return false;
  } else if (combine == kLastBlock) {
    if (bands < 2 || scratch == nullptr || counters == nullptr) return false;
  } else {
    return false;
  }
  if (vec && (C % ct || misaligned(x) || misaligned(sum_w) ||
              misaligned(sum_h) ||
              (combine == kLastBlock && misaligned(scratch))))
    return false;
  return true;
}

template <typename T, int V>
int max_clusters(int warps, int cluster, int* out) {
  size_t smem;
  const cudaError_t err = set_smem<T, V, kCluster>(warps, &smem);
  if (err != cudaSuccess) return (int)err;
  const ClusterLaunch cl(cluster, warps, smem, cluster, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, dual_band<T, V, kCluster>,
                                             &cl.cfg);
}

}  // namespace

extern "C" {

// P: sum_w (N, H, C) and sum_h (N, W, C), both f32, from x (N, H, W, C)
// float32 (dtype 0) or bfloat16 (dtype 1), all contiguous. The plan is the
// caller's (ops/dual_pools.py dual_plan): vec, warps a block, bands and
// combine (0 one band, 1 a cluster of the bands, 2 the last band block);
// with combine 2, scratch is (N * tiles, bands, W, tile) f32 and counters
// N * tiles unsigned zeros, which the launch leaves zero (else both are
// unused). A plan that plan_ok refuses is not launched:
// cudaErrorInvalidValue.
int stc_dual_pools(const void* x, void* sum_w, void* sum_h, void* scratch,
                   void* counters, int dtype, int vec, int warps, int bands,
                   int combine, int N, int H, int W, int C, void* stream) {
  if (!plan_ok(x, sum_w, sum_h, scratch, counters, dtype, vec, warps, bands,
               combine, N, H, W, C))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch_combine<float, 4>(combine, x, sum_w, sum_h, scratch,
                                          counters, warps, bands, N, H, W,
                                          C, s)
               : launch_combine<float, 1>(combine, x, sum_w, sum_h, scratch,
                                          counters, warps, bands, N, H, W,
                                          C, s);
  return vec ? launch_combine<__nv_bfloat16, 8>(combine, x, sum_w, sum_h,
                                                scratch, counters, warps,
                                                bands, N, H, W, C, s)
             : launch_combine<__nv_bfloat16, 1>(combine, x, sum_w, sum_h,
                                                scratch, counters, warps,
                                                bands, N, H, W, C, s);
}

// The most clusters of `cluster` blocks of `warps` warps that the card
// holds at once (cudaOccupancyMaxActiveClusters) for P's cluster build of
// dtype and vec, into *out.
int stc_dual_pools_clusters(int dtype, int vec, int warps, int cluster,
                            int* out) {
  if (warps < 1 || warps > kMaxWarps || cluster < 1 ||
      cluster > kMaxCluster || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return vec ? max_clusters<float, 4>(warps, cluster, out)
               : max_clusters<float, 1>(warps, cluster, out);
  return vec ? max_clusters<__nv_bfloat16, 8>(warps, cluster, out)
             : max_clusters<__nv_bfloat16, 1>(warps, cluster, out);
}

}  // extern "C"
