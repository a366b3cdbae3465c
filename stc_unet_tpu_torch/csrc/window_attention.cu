// Relative window attention, forward (K3f) and backward (K3b), for Hopper
// (sm_90a).
//
// They replace the Pallas kernels of stc_unet_tpu/ops/window_attention.py:
//   K3f stc_window_attention_fwd <- _call_fwd / _fwd_kernel + _attn_core
//   K3b stc_window_attention_bwd <- _call_bwd / _bwd_kernel
//
// Per window w and head h, with q_h, k_h, v_h the (N, d) head slices of the
// packed (W, N, C = H*d) q, k, v and bias_h[n, m] = bias_e[n, h*N + m]:
//   out_h = dropout(softmax(q_h k_h^T * scale + bias_h)) v_h.
// q, k and v are rows of ld elements (ld >= C: they may be the thirds of one
// packed qkv row); out, do, dq, dk and dv are contiguous (W, N, C). Types:
// float32 (dtype 0) and bfloat16 (dtype 1). N <= 64, d in {2, 4, 8, 16}.
//
// The roundings are the TPU kernel's: q is multiplied by scale in q's type;
// the scores are f32 and take the f32 bias; the softmax is f32; attn is
// rounded to q's type before the dropout multiply (in q's type) and before
// the apply; the apply and every product of the backward sum in f32 and are
// rounded once. The stabiliser is the head's row max; the TPU kernel takes
// the max over all heads of the row, which is as valid and differs only by
// f32 rounding.
//
// Dropout. The TPU seeds its own generator per grid step; that cannot be
// matched bit for bit. Here element (w, h, n, m) keeps its attention weight
// when philox(((w*H + h)*N + n)*N + m) < thresh, with Philox4x32-10 keyed by
// the 64-bit seed (read from device memory) and the element's position as
// the counter (word 0 of the output). The backward draws the same bits, so
// the forward's mask is recomputed and never stored. The plain PyTorch
// version (ops/window_attention.py) computes the same generator.
//
// What bounds them on an H100 SXM. At B=8, 512^2 in bf16, the 28 calls of one
// forward move 0.97 GB (q, k, v read, out written: 0.29 ms at 3.35 TB/s) and
// take W*H*N^2 = 2.83e9 exponentials (0.68 ms at 16 per SM per clock, 132
// SMs at 1.98 GHz); their 31 GFLOP of dot products would take 0.46 ms at the
// f32 rate, 0.03 ms at the bf16 tensor-core rate. So K3f is bound by the
// exponentials. K3b recomputes the same exponentials and moves 7 tensors
// (1.70 GB, 0.51 ms): bound by the exponentials too, though its 78 GFLOP of
// f32 products (1.16 ms on the CUDA cores) bound this design.
//
// Design (a first version, right before fast). d is 2 to 16, below the bf16
// mma depth, so the dot products are CUDA-core FMAs. A block takes one head
// and a run of windows; a thread takes one query row n. K3f keeps the row's
// 64 scores in registers, so each exponential is taken once; k_h and v_h
// (N x d) go to shared memory as f32 and every thread reads the same row of
// them at a time (a broadcast). The head's N x N bias goes to shared memory
// once per block (a thread reading its own row of it from L1 would touch a
// cache line per lane). Blocks are ordered head-fastest, so the blocks of
// one window run together and its q, k, v rows are read from device memory
// about once.
//
// K3b has sums over the query rows (dk, dv, dbias) as well as over the key
// rows (dq). Each window's bias_h is staged in shared memory first. Phase
// 1, a thread per query row n, computes the row's attn and t = dattn * attn
// into two N x (N+1) f32 tiles in shared memory (the +1 keeps rows and
// columns free of bank conflicts), then ds and dq; the keep
// bit of each element goes into the sign of its attn entry (attn >= 0), so
// phase 2 needs no second draw. Phase 2, a thread per key row m, sums dk and
// dv over n from the tiles, and adds ds into its column of dbias, kept in
// registers across the block's windows. dbias is a sum over every window:
// Hopper's blocks run in no order, so each block takes a fixed chunk of
// windows and writes one f32 partial (N x N for its head) per chunk, and a
// second pass adds the chunks in order. No atomics: every sum is taken in a
// fixed order, so reruns are bit-identical.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 64;     // rows of a window (a thread per row)

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

// f32 -> T -> f32: the rounding of a value to T.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Word 0 of Philox4x32-10 at counter (lo, hi, 0, 0) under key (lo, hi).
__device__ __forceinline__ uint32_t philox(uint64_t ctr, uint64_t key) {
  uint32_t c0 = (uint32_t)ctr, c1 = (uint32_t)(ctr >> 32), c2 = 0u, c3 = 0u;
  uint32_t k0 = (uint32_t)key, k1 = (uint32_t)(key >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

struct Drop {
  int on;           // rate > 0
  uint32_t thresh;  // keep when the bits are below it
  float mult;       // 1 / keep, rounded to the tensors' type
};

// attn rounded to T, times the dropout multiplier in T; kept is the draw.
template <typename T>
__device__ __forceinline__ float used_weight(float attn, bool kept,
                                             const Drop& drop) {
  const float a = round_to<T>(attn);
  if (!drop.on) return a;
  return kept ? round_to<T>(a * drop.mult) : 0.f;
}

// bias_h (N x N, rows of N in bias_e) into dst (rows of N + 1), coalesced:
// neighbouring threads read neighbouring columns.
__device__ __forceinline__ void load_bias(const float* __restrict__ bias_e,
                                          float* dst, int N, int H, int h) {
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int r = i / N, c = i - r * N;
    dst[r * (N + 1) + c] = bias_e[(size_t)r * H * N + (size_t)h * N + c];
  }
}

// K3f. Grid (H, ceil(W / wpb)), block 32 or 64 threads (a thread per row).
template <typename T, int D>
__global__ void __launch_bounds__(kMaxN)
wa_fwd(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const float* __restrict__ bias_e,
       const int64_t* __restrict__ seed, T* __restrict__ out, int W, int N,
       int H, int ld, int wpb, float scale_q, Drop drop) {
  __shared__ float ks[kMaxN * D];
  __shared__ float vs[kMaxN * D];
  __shared__ float bs[kMaxN * (kMaxN + 1)];  // bias_h, rows of N + 1
  const int h = blockIdx.x;
  const int n = threadIdx.x;
  const int C = H * D;
  const int lds = N + 1;
  const int w_end = min(W, (int)(blockIdx.y + 1) * wpb);
  const uint64_t key = drop.on ? (uint64_t)seed[0] : 0ull;
  load_bias(bias_e, bs, N, H, h);  // the loop's first barrier publishes it
  for (int w = blockIdx.y * wpb; w < w_end; ++w) {
    const size_t in_row = ((size_t)w * N + n) * ld + (size_t)h * D;
    __syncthreads();  // the previous window is done with ks and vs
    if (n < N) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        ks[n * D + j] = to_f32(k[in_row + j]);
        vs[n * D + j] = to_f32(v[in_row + j]);
      }
    }
    __syncthreads();
    if (n >= N) continue;
    float qn[D];
#pragma unroll
    for (int j = 0; j < D; ++j)
      qn[j] = round_to<T>(to_f32(q[in_row + j]) * scale_q);
    float s[kMaxN];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int m = 0; m < kMaxN; ++m) {
      if (m < N) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) acc = fmaf(qn[j], ks[m * D + j], acc);
        s[m] = acc + bs[n * lds + m];
        mx = fmaxf(mx, s[m]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxN; ++m) {
      if (m < N) {
        s[m] = expf(s[m] - mx);
        sum += s[m];
      }
    }
    const float rec = 1.f / sum;
    const uint64_t ctr0 = (((uint64_t)w * H + h) * N + n) * N;
    float o[D];
#pragma unroll
    for (int j = 0; j < D; ++j) o[j] = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxN; ++m) {
      if (m < N) {
        const bool kept = drop.on && philox(ctr0 + m, key) < drop.thresh;
        const float a = used_weight<T>(s[m] * rec, kept, drop);
#pragma unroll
        for (int j = 0; j < D; ++j) o[j] = fmaf(a, vs[m * D + j], o[j]);
      }
    }
    const size_t out_row = ((size_t)w * N + n) * C + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < D; ++j) out[out_row + j] = from_f32<T>(o[j]);
  }
}

// K3b, pass 1. Grid (H, chunks), block 32 or 64 threads; block (h, c) takes
// windows [c * wpc, min(W, (c + 1) * wpc)) and writes its head's N x N
// partial of dbias into part[c] ((chunks, N, H*N) f32).
template <typename T, int D>
__global__ void __launch_bounds__(kMaxN)
wa_bwd(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const float* __restrict__ bias_e,
       const int64_t* __restrict__ seed, const T* __restrict__ dout,
       T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
       float* __restrict__ part, int W, int N, int H, int ld, int wpc,
       float scale_q, float scale, Drop drop) {
  extern __shared__ float smem[];
  float* qs = smem;               // q * scale in T, as f32 (N x D)
  float* ks = qs + kMaxN * D;
  float* vs = ks + kMaxN * D;
  float* dos = vs + kMaxN * D;
  float* at = dos + kMaxN * D;    // attn, its sign the keep bit (N x N+1)
  float* tt = at + kMaxN * (kMaxN + 1);  // t, then ds (N x N+1)
  const int lds = N + 1;
  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = H * D;
  const uint64_t key = drop.on ? (uint64_t)seed[0] : 0ull;
  float db[kMaxN];  // column tid of this block's dbias partial
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) db[i] = 0.f;
  const int w_end = min(W, (int)(blockIdx.y + 1) * wpc);
  for (int w = blockIdx.y * wpc; w < w_end; ++w) {
    __syncthreads();  // phase 2 of the previous window is done
    if (tid < N) {
      const size_t in_row = ((size_t)w * N + tid) * ld + (size_t)h * D;
      const size_t g_row = ((size_t)w * N + tid) * C + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        qs[tid * D + j] = round_to<T>(to_f32(q[in_row + j]) * scale_q);
        ks[tid * D + j] = to_f32(k[in_row + j]);
        vs[tid * D + j] = to_f32(v[in_row + j]);
        dos[tid * D + j] = to_f32(dout[g_row + j]);
      }
    }
    load_bias(bias_e, tt, N, H, h);  // tt holds bias_h until t overwrites it
    __syncthreads();
    // phase 1: thread tid is query row n
    if (tid < N) {
      const int n = tid;
      float* arow = at + n * lds;
      float* trow = tt + n * lds;
      float mx = -CUDART_INF_F;
      for (int m = 0; m < N; ++m) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j)
          acc = fmaf(qs[n * D + j], ks[m * D + j], acc);
        acc += trow[m];
        arow[m] = acc;
        mx = fmaxf(mx, acc);
      }
      float sum = 0.f;
      for (int m = 0; m < N; ++m) {
        const float e = expf(arow[m] - mx);
        arow[m] = e;
        sum += e;
      }
      const float rec = 1.f / sum;
      const uint64_t ctr0 = (((uint64_t)w * H + h) * N + n) * N;
      float rs = 0.f;
      for (int m = 0; m < N; ++m) {
        const float a = arow[m] * rec;
        float dat = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j)
          dat = fmaf(dos[n * D + j], vs[m * D + j], dat);
        bool kept = true;
        if (drop.on) {
          kept = philox(ctr0 + m, key) < drop.thresh;
          dat *= kept ? drop.mult : 0.f;
        }
        const float t = dat * a;
        arow[m] = kept ? a : -a;  // a >= 0: the sign carries the draw
        trow[m] = t;
        rs += t;
      }
      float dqa[D];
#pragma unroll
      for (int j = 0; j < D; ++j) dqa[j] = 0.f;
      for (int m = 0; m < N; ++m) {
        const float ds = trow[m] - fabsf(arow[m]) * rs;
        trow[m] = ds;
        const float dsb = round_to<T>(ds);
#pragma unroll
        for (int j = 0; j < D; ++j) dqa[j] = fmaf(dsb, ks[m * D + j], dqa[j]);
      }
      const size_t g_row = ((size_t)w * N + n) * C + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < D; ++j) dq[g_row + j] = from_f32<T>(dqa[j] * scale);
    }
    __syncthreads();
    // phase 2: thread tid is key row m
    if (tid < N) {
      const int m = tid;
      float dka[D], dva[D];
#pragma unroll
      for (int j = 0; j < D; ++j) dka[j] = dva[j] = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          const float ds = tt[n * lds + m];
          const float a = at[n * lds + m];
          db[n] += ds;
          const float dsb = round_to<T>(ds);
          const bool kept = !(__float_as_uint(a) >> 31);
          const float p = used_weight<T>(fabsf(a), kept, drop);
#pragma unroll
          for (int j = 0; j < D; ++j) {
            dka[j] = fmaf(dsb, qs[n * D + j], dka[j]);
            dva[j] = fmaf(p, dos[n * D + j], dva[j]);
          }
        }
      }
      const size_t g_row = ((size_t)w * N + m) * C + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        dk[g_row + j] = from_f32<T>(dka[j]);
        dv[g_row + j] = from_f32<T>(dva[j]);
      }
    }
  }
  if (tid < N) {
    float* dst = part + (size_t)blockIdx.y * N * H * N + (size_t)h * N + tid;
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) dst[(size_t)n * H * N] = db[n];
  }
}

// K3b, pass 2: dbias[i] = sum over chunks c, in order, of part[c][i].
__global__ void wa_dbias_sum(const float* __restrict__ part,
                             float* __restrict__ dbias, int chunks,
                             int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += part[(size_t)c * size + i];
  dbias[i] = acc;
}

int threads_for(int N) { return N <= 32 ? 32 : kMaxN; }

size_t bwd_smem(int D) {
  return sizeof(float) * (4 * kMaxN * D + 2 * kMaxN * (kMaxN + 1));
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* bias_e, const int64_t* seed, void* out, int W,
               int N, int H, int ld, float scale_q, Drop drop,
               cudaStream_t s) {
  // about 8192 blocks in all: a few windows a block at the widest stage
  const int wpb = max(1, (W * H) / 8192);
  dim3 grid(H, (W + wpb - 1) / wpb);
  wa_fwd<T, D><<<grid, threads_for(N), 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias_e, seed, static_cast<T*>(out), W, N, H,
      ld, wpb, scale_q, drop);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v,
               const float* bias_e, const int64_t* seed, const void* dout,
               void* dq, void* dk, void* dv, float* part, float* dbias,
               int W, int N, int H, int ld, int chunks, int wpc,
               float scale_q, float scale, Drop drop, cudaStream_t s) {
  const size_t bytes = bwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      wa_bwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  wa_bwd<T, D><<<dim3(H, chunks), threads_for(N), bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias_e, seed, static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), part,
      W, N, H, ld, wpc, scale_q, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = N * H * N;
  wa_dbias_sum<<<(size + 255) / 256, 256, 0, s>>>(part, dbias, chunks, size);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_for(int D, const void* q, const void* k, const void* v,
            const float* b, const int64_t* seed, void* out, int W, int N,
            int H, int ld, float scale_q, Drop drop, cudaStream_t s) {
#define STC_WA_FWD(d) \
  return launch_fwd<T, d>(q, k, v, b, seed, out, W, N, H, ld, scale_q, drop, s)
  switch (D) {
    case 2: STC_WA_FWD(2);
    case 4: STC_WA_FWD(4);
    case 8: STC_WA_FWD(8);
    case 16: STC_WA_FWD(16);
  }
#undef STC_WA_FWD
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_for(int D, const void* q, const void* k, const void* v,
            const float* b, const int64_t* seed, const void* dout, void* dq,
            void* dk, void* dv, float* part, float* dbias, int W, int N,
            int H, int ld, int chunks, int wpc, float scale_q, float scale,
            Drop drop, cudaStream_t s) {
#define STC_WA_BWD(d)                                                       \
  return launch_bwd<T, d>(q, k, v, b, seed, dout, dq, dk, dv, part, dbias, \
                          W, N, H, ld, chunks, wpc, scale_q, scale, drop, s)
  switch (D) {
    case 2: STC_WA_BWD(2);
    case 4: STC_WA_BWD(4);
    case 8: STC_WA_BWD(8);
    case 16: STC_WA_BWD(16);
  }
#undef STC_WA_BWD
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int W, int N, int H, int D, int ld) {
  return W < 1 || W > 65535 || N < 1 || N > kMaxN || H < 1 || H > 65535 ||
         D < 1 || ld < H * D;
}

}  // namespace

extern "C" {

// q, k, v: (W, N, ld) rows whose first H*D elements are the packed heads;
// bias_e (N, H*N) f32; seed one int64 on the device; out (W, N, H*D).
// scale_q is scale rounded to the tensors' type; dropout when dropout != 0:
// keep when the Philox bits are below thresh, kept weights times mult.
int stc_window_attention_fwd(const void* q, const void* k, const void* v,
                             const void* bias_e, const void* seed, void* out,
                             int dtype, int W, int N, int H, int D, int ld,
                             float scale_q, unsigned int thresh, float mult,
                             int dropout, void* stream) {
  if (bad_shape(W, N, H, D, ld)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop drop{dropout != 0, thresh, mult};
  const float* b = static_cast<const float*>(bias_e);
  const int64_t* sd = static_cast<const int64_t*>(seed);
  if (dtype == 0)
    return fwd_for<float>(D, q, k, v, b, sd, out, W, N, H, ld, scale_q, drop, s);
  if (dtype == 1)
    return fwd_for<__nv_bfloat16>(D, q, k, v, b, sd, out, W, N, H, ld,
                                  scale_q, drop, s);
  return (int)cudaErrorInvalidValue;
}

// As the forward, plus dout (W, N, H*D) contiguous; writes dq, dk, dv (W, N,
// H*D) and dbias (N, H*N) f32. part is an f32 scratch of (chunks, N, H*N):
// block (h, c) takes windows [c*wpc, (c+1)*wpc); chunks must be
// ceil(W / wpc), or the call is refused before a launch. scale is the f32
// scale of dq.
int stc_window_attention_bwd(const void* q, const void* k, const void* v,
                             const void* bias_e, const void* seed,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* part, void* dbias, int dtype, int W, int N,
                             int H, int D, int ld, int chunks, int wpc,
                             float scale_q, float scale, unsigned int thresh,
                             float mult, int dropout, void* stream) {
  if (bad_shape(W, N, H, D, ld) || wpc < 1 || chunks > 65535 ||
      chunks != (W + wpc - 1) / wpc)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop drop{dropout != 0, thresh, mult};
  const float* b = static_cast<const float*>(bias_e);
  const int64_t* sd = static_cast<const int64_t*>(seed);
  float* p = static_cast<float*>(part);
  float* db = static_cast<float*>(dbias);
  if (dtype == 0)
    return bwd_for<float>(D, q, k, v, b, sd, dout, dq, dk, dv, p, db, W, N, H,
                          ld, chunks, wpc, scale_q, scale, drop, s);
  if (dtype == 1)
    return bwd_for<__nv_bfloat16>(D, q, k, v, b, sd, dout, dq, dk, dv, p, db,
                                  W, N, H, ld, chunks, wpc, scale_q, scale,
                                  drop, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
