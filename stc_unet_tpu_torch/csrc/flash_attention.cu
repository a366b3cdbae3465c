// Flash attention: the forward (Lf) and its backward (Ldkv, Ldq), for Hopper
// (sm_90a).
//
// They replace the three Pallas kernels of JAX's library flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0), which the
// JAX STC-UNet calls with flash_attention=True
// (stc_unet_tpu/models/backbones/unet_backbone.py:146):
//   Lf   stc_flash_attention_fwd     <- _flash_attention_impl (:758)
//   Ldkv stc_flash_attention_bwd_dkv <- _flash_attention_bwd_dkv (:1121)
//   Ldq  stc_flash_attention_bwd_dq  <- _flash_attention_bwd_dq (:1456)
//
// Per batch n and head h, with q (Lq x d), k and v (Lk x d), all float32:
//   s = (q k^T) * scale,  o = softmax(s) v,  lse = log sum_m exp(s[:, m]);
// and for an output gradient do, with di = sum_j o * do (the wrapper forms
// it, as the library does outside its kernels) and p = exp(s - lse):
//   dv = p^T do,  ds = p * (do v^T - di) * scale,  dk = ds^T q,  dq = ds k.
// The scale multiplies the product, as the library does (not a divide).
// q, k, v and do are (N, H, L, d) with any element strides of N, H and L and
// a contiguous last axis (the model's are views of (N, L, H*d) rows); o,
// lse, dq, dk and dv are written contiguous. d is 1..256; Lq and Lk are any
// length: the TPU's multiple-of-128 blocks are a tiling of the library, not
// part of the function.
//
// What bounds them on an H100 SXM. The STC transformer has 2 heads of d =
// 256. At whole B=8 (x4: L = 4096, x5: L = 1024, 4 layers each) one
// forward's eight Lf calls take 2 L x L x d products each, 1.17e12 flop in
// all: 17.4 ms at the 67 TFLOP/s f32 rate outside the tensor cores, against
// 0.3 ms of exponentials and about 0.1 ms of bytes. So Lf is bound by its
// f32 products; Ldkv (4 products: s, dp, dv, dk) and Ldq (3: s, dp, dq) too.
// Every product is an f32 FMA, not TF32: the kernels are held to the CPU's
// f32 results.
//
// Design (a first version, right before fast): CUDA-core FMAs on tiles in
// shared memory. A block has 256 threads as 16 x 16 (ty, tx); each product
// C = A B over a tile gives thread (ty, tx) the rows ty + 16 i and the
// columns tx + 16 j of C, in registers (tile_fma). Along a row of C the
// threads of a half-warp read 16 neighbouring columns of B (unit or odd
// stride: no bank conflicts) and the two rows of A of a warp lie in other
// banks (odd row strides), so each shared load feeds 2 to 4 FMAs per value.
// The head dimension is padded to DP = 16 NC in shared memory, with NC in
// {1, 2, 4, 8, 16} chosen from d; the products over d stop at d.
//
// Lf: a block takes 64 query rows of one (n, h) and walks the keys in tiles
// of 32: s (64 x 32, 8 per thread), the online softmax (row max and sum over
// the 16 threads of a row by shuffles), then o += p v with o in registers
// (64 x DP, 4 x NC per thread). q stays in shared memory; k^T and then v
// take turns in one buffer (108 KB in all at d = 256). It never forms the
// L x L matrix and stores only o and lse. ptxas gives the kernels up to
// 163 registers a thread and no spills; above 128, an SM holds one block
// of 8 warps, too few to hide the shared-memory latency.
//
// Ldkv: a block takes 32 keys and walks the query tiles of 32 rows,
// recomputing p^T from k, q and lse and accumulating dv and dk (32 x DP
// each) in registers. Ldq: a block takes 32 query rows and walks the key
// tiles, accumulating dq. No atomics: every sum runs in a fixed order, so
// reruns are bit-identical.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16 threads: ty = tid / 16
constexpr int kFwdRows = 64;      // query rows of an Lf block
constexpr int kKeys = 32;         // keys of a tile (Lf, Ldq), of a Ldkv block
constexpr int kBwdRows = 32;      // query rows of a tile (Ldkv), of a Ldq block
constexpr int kPad = kKeys + 1;   // odd row stride of the 32-wide tiles

// One (N, H, L, d) input: its data and the element strides of N, H and L.
struct Rows {
  const float* p;
  long long sn, sh, sl;
};

__device__ __forceinline__ const float* head_of(const Rows& t, int n, int h) {
  return t.p + n * t.sn + h * t.sh;
}

// acc[i][j] += sum_{k < K} A(ty + 16 i, k) B(k, tx + 16 j), with A(r, k) at
// a[r * ar + k * ak] and B(k, c) at b[k * bk + c * bc] in shared memory.
template <int TM, int TN>
__device__ __forceinline__ void tile_fma(float (&acc)[TM][TN],
                                         const float* a, int ar, int ak,
                                         const float* b, int bk, int bc,
                                         int K, int ty, int tx) {
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a[(ty + 16 * i) * ar + k * ak];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b[k * bk + (tx + 16 * j) * bc];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// Rows r0 .. r0 + R - 1 of src (row stride sl) into dst[r * ld + j], j < DP,
// with zeros past row L or column d. Neighbouring threads take neighbouring
// columns: coalesced reads, conflict-free writes.
template <int DP>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long sl, int r0, int R, int L,
                                          int d) {
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP, j = i - r * DP;
    dst[r * ld + j] = (r0 + r < L && j < d) ? src[(r0 + r) * sl + j] : 0.f;
  }
}

// The same rows transposed, into dst[j * kPad + r] (R <= 32): the odd stride
// keeps the writes of a warp, 32 neighbouring j, in 32 banks.
template <int DP>
__device__ __forceinline__ void load_cols(float* dst, const float* src,
                                          long long sl, int r0, int R, int L,
                                          int d) {
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP, j = i - r * DP;
    dst[j * kPad + r] = (r0 + r < L && j < d) ? src[(r0 + r) * sl + j] : 0.f;
  }
}

// The max and the sum over the 16 threads of a half-warp (one row of a
// tile). The butterfly leaves the same value in every lane.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lf. Grid (ceil(Lq / 64), N * H), 256 threads.
template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd(Rows q, Rows k, Rows v, float* __restrict__ o,
          float* __restrict__ lse, int H, int Lq, int Lk, int d,
          float scale) {
  constexpr int DP = 16 * NC;
  extern __shared__ float smem[];
  float* qs = smem;                       // q: kFwdRows x (DP + 1)
  float* kv = qs + kFwdRows * (DP + 1);   // k^T: DP x kPad, then v: kKeys x DP
  float* ps = kv + DP * kPad;             // p: kFwdRows x kPad
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bh = blockIdx.y, n = bh / H, h = bh - n * H;
  const int q0 = blockIdx.x * kFwdRows;
  const float* kb = head_of(k, n, h);
  const float* vb = head_of(v, n, h);
  load_rows<DP>(qs, DP + 1, head_of(q, n, h), q.sl, q0, kFwdRows, Lq, d);
  float acc[4][NC], m[4], l[4];
  zero(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < Lk; k0 += kKeys) {
    __syncthreads();  // q is in; the previous tile is done with kv and ps
    load_cols<DP>(kv, kb, k.sl, k0, kKeys, Lk, d);
    __syncthreads();
    float s[4][2];
    zero(s);
    tile_fma<4, 2>(s, qs, DP + 1, 1, kv, kPad, 1, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = k0 + tx + 16 * j < Lk ? s[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      // key k0 < Lk is in every tile, so m_new is finite; on the first
      // tile m[i] = -inf and alpha = 0
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPad + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // k^T is no longer needed; p is in
    load_rows<DP>(kv, DP, vb, v.sl, k0, kKeys, Lk, d);
    __syncthreads();
    tile_fma<4, NC>(acc, ps, kPad, 1, kv, DP, 1, min(kKeys, Lk - k0), ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Lq) continue;
    const float inv = 1.f / l[i];
    float* orow = o + ((size_t)bh * Lq + r) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = tx + 16 * c;
      if (j < d) orow[j] = acc[i][c] * inv;
    }
    if (tx == 0) lse[(size_t)bh * Lq + r] = m[i] + logf(l[i]);
  }
}

// Ldkv. Grid (ceil(Lk / 32), N * H), 256 threads.
template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(Rows q, Rows k, Rows v, Rows dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              float* __restrict__ dk, float* __restrict__ dv, int H, int Lq,
              int Lk, int d, float scale) {
  constexpr int DP = 16 * NC;
  extern __shared__ float smem[];
  float* ks = smem;                     // k: kKeys x (DP + 1)
  float* vs = ks + kKeys * (DP + 1);    // v: kKeys x (DP + 1)
  float* qt = vs + kKeys * (DP + 1);    // q^T: DP x kPad
  float* dot = qt + DP * kPad;          // do^T: DP x kPad
  float* pt = dot + DP * kPad;          // p^T: kKeys x kPad
  float* dst = pt + kKeys * kPad;       // ds^T: kKeys x kPad
  float* ls = dst + kKeys * kPad;       // lse of the tile's rows
  float* dis = ls + kBwdRows;           // di of the tile's rows
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bh = blockIdx.y, n = bh / H, h = bh - n * H;
  const int k0 = blockIdx.x * kKeys;
  const float* qb = head_of(q, n, h);
  const float* dob = head_of(dout, n, h);
  load_rows<DP>(ks, DP + 1, head_of(k, n, h), k.sl, k0, kKeys, Lk, d);
  load_rows<DP>(vs, DP + 1, head_of(v, n, h), v.sl, k0, kKeys, Lk, d);
  float adk[2][NC], adv[2][NC];
  zero(adk);
  zero(adv);
  for (int q0 = 0; q0 < Lq; q0 += kBwdRows) {
    __syncthreads();  // the previous tile is done with qt, dot, pt, dst
    load_cols<DP>(qt, qb, q.sl, q0, kBwdRows, Lq, d);
    load_cols<DP>(dot, dob, dout.sl, q0, kBwdRows, Lq, d);
    if (threadIdx.x < kBwdRows) {
      const int r = q0 + threadIdx.x;
      ls[threadIdx.x] = r < Lq ? lse[(size_t)bh * Lq + r] : 0.f;
      dis[threadIdx.x] = r < Lq ? di[(size_t)bh * Lq + r] : 0.f;
    }
    __syncthreads();
    float s[2][2], dp[2][2];
    zero(s);
    zero(dp);
    tile_fma<2, 2>(s, ks, DP + 1, 1, qt, kPad, 1, d, ty, tx);    // s^T
    tile_fma<2, 2>(dp, vs, DP + 1, 1, dot, kPad, 1, d, ty, tx);  // dp^T
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const float p = q0 + c < Lq ? expf(s[i][j] * scale - ls[c]) : 0.f;
        pt[(ty + 16 * i) * kPad + c] = p;
        dst[(ty + 16 * i) * kPad + c] = p * (dp[i][j] - dis[c]) * scale;
      }
    __syncthreads();
    const int rows = min(kBwdRows, Lq - q0);
    tile_fma<2, NC>(adv, pt, kPad, 1, dot, 1, kPad, rows, ty, tx);  // p^T do
    tile_fma<2, NC>(adk, dst, kPad, 1, qt, 1, kPad, rows, ty, tx);  // ds^T q
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= Lk) continue;
    const size_t row = ((size_t)bh * Lk + r) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = tx + 16 * c;
      if (j < d) {
        dk[row + j] = adk[i][c];
        dv[row + j] = adv[i][c];
      }
    }
  }
}

// Ldq. Grid (ceil(Lq / 32), N * H), 256 threads.
template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(Rows q, Rows k, Rows v, Rows dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             float* __restrict__ dq, int H, int Lq, int Lk, int d,
             float scale) {
  constexpr int DP = 16 * NC;
  extern __shared__ float smem[];
  float* qs = smem;                        // q: kBwdRows x (DP + 1)
  float* dos = qs + kBwdRows * (DP + 1);   // do: kBwdRows x (DP + 1)
  float* kt = dos + kBwdRows * (DP + 1);   // k^T: DP x kPad
  float* vt = kt + DP * kPad;              // v^T: DP x kPad
  float* dss = vt + DP * kPad;             // ds: kBwdRows x kPad
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bh = blockIdx.y, n = bh / H, h = bh - n * H;
  const int q0 = blockIdx.x * kBwdRows;
  const float* kb = head_of(k, n, h);
  const float* vb = head_of(v, n, h);
  load_rows<DP>(qs, DP + 1, head_of(q, n, h), q.sl, q0, kBwdRows, Lq, d);
  load_rows<DP>(dos, DP + 1, head_of(dout, n, h), dout.sl, q0, kBwdRows, Lq,
                d);
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + ty + 16 * i;
    lr[i] = r < Lq ? lse[(size_t)bh * Lq + r] : 0.f;
    dr[i] = r < Lq ? di[(size_t)bh * Lq + r] : 0.f;
  }
  float acc[2][NC];
  zero(acc);
  for (int k0 = 0; k0 < Lk; k0 += kKeys) {
    __syncthreads();  // q and do are in; the previous tile is done
    load_cols<DP>(kt, kb, k.sl, k0, kKeys, Lk, d);
    load_cols<DP>(vt, vb, v.sl, k0, kKeys, Lk, d);
    __syncthreads();
    float s[2][2], dp[2][2];
    zero(s);
    zero(dp);
    tile_fma<2, 2>(s, qs, DP + 1, 1, kt, kPad, 1, d, ty, tx);
    tile_fma<2, 2>(dp, dos, DP + 1, 1, vt, kPad, 1, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const float p = k0 + c < Lk ? expf(s[i][j] * scale - lr[i]) : 0.f;
        dss[(ty + 16 * i) * kPad + c] = p * (dp[i][j] - dr[i]) * scale;
      }
    __syncthreads();
    tile_fma<2, NC>(acc, dss, kPad, 1, kt, 1, kPad, min(kKeys, Lk - k0), ty,
                    tx);  // ds k
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Lq) continue;
    float* row = dq + ((size_t)bh * Lq + r) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = tx + 16 * c;
      if (j < d) row[j] = acc[i][c];
    }
  }
}

size_t fwd_smem(int DP) {
  return sizeof(float) * (kFwdRows * (DP + 1) + DP * kPad + kFwdRows * kPad);
}

size_t dkv_smem(int DP) {
  return sizeof(float) * (2 * kKeys * (DP + 1) + 2 * DP * kPad +
                          2 * kKeys * kPad + 2 * kBwdRows);
}

size_t dq_smem(int DP) {
  return sizeof(float) * (2 * kBwdRows * (DP + 1) + 2 * DP * kPad +
                          kBwdRows * kPad);
}

// The instantiation for head dimension d: NC with d <= 16 NC, else 0.
int nc_for(int d) {
  if (d < 1) return 0;
  if (d <= 16) return 1;
  if (d <= 32) return 2;
  if (d <= 64) return 4;
  if (d <= 128) return 8;
  if (d <= 256) return 16;
  return 0;
}

bool bad_shape(int N, int H, int Lq, int Lk, int d) {
  return N < 1 || H < 1 || (long long)N * H > 65535 || Lq < 1 || Lk < 1 ||
         nc_for(d) == 0;
}

// Above 48 KB a kernel's dynamic shared memory must be allowed first.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NC>
int fwd(Rows q, Rows k, Rows v, float* o, float* lse, int N, int H, int Lq,
        int Lk, int d, float scale, cudaStream_t s) {
  const size_t bytes = fwd_smem(16 * NC);
  const int err = allow_smem(flash_fwd<NC>, bytes);
  if (err) return err;
  const dim3 grid((Lq + kFwdRows - 1) / kFwdRows, N * H);
  flash_fwd<NC><<<grid, kThreads, bytes, s>>>(q, k, v, o, lse, H, Lq, Lk, d,
                                              scale);
  return (int)cudaGetLastError();
}

template <int NC>
int dkv(Rows q, Rows k, Rows v, Rows dout, const float* lse, const float* di,
        float* dk, float* dv, int N, int H, int Lq, int Lk, int d,
        float scale, cudaStream_t s) {
  const size_t bytes = dkv_smem(16 * NC);
  const int err = allow_smem(flash_bwd_dkv<NC>, bytes);
  if (err) return err;
  const dim3 grid((Lk + kKeys - 1) / kKeys, N * H);
  flash_bwd_dkv<NC><<<grid, kThreads, bytes, s>>>(q, k, v, dout, lse, di, dk,
                                                  dv, H, Lq, Lk, d, scale);
  return (int)cudaGetLastError();
}

template <int NC>
int dq(Rows q, Rows k, Rows v, Rows dout, const float* lse, const float* di,
       float* dqp, int N, int H, int Lq, int Lk, int d, float scale,
       cudaStream_t s) {
  const size_t bytes = dq_smem(16 * NC);
  const int err = allow_smem(flash_bwd_dq<NC>, bytes);
  if (err) return err;
  const dim3 grid((Lq + kBwdRows - 1) / kBwdRows, N * H);
  flash_bwd_dq<NC><<<grid, kThreads, bytes, s>>>(q, k, v, dout, lse, di, dqp,
                                                 H, Lq, Lk, d, scale);
  return (int)cudaGetLastError();
}

#define STC_FA_DISPATCH(call) \
  switch (nc_for(d)) {        \
    case 1: return call(1);   \
    case 2: return call(2);   \
    case 4: return call(4);   \
    case 8: return call(8);   \
    case 16: return call(16); \
  }                           \
  return (int)cudaErrorInvalidValue;

Rows rows(const void* p, long long sn, long long sh, long long sl) {
  return Rows{static_cast<const float*>(p), sn, sh, sl};
}

}  // namespace

extern "C" {

// q (N, H, Lq, d), k and v (N, H, Lk, d): float32 with element strides
// (sn, sh, sl) and a contiguous last axis. Writes o (N, H, Lq, d) and lse
// (N, H, Lq), contiguous float32. scale multiplies q k^T.
int stc_flash_attention_fwd(const void* q, long long qsn, long long qsh,
                            long long qsl, const void* k, long long ksn,
                            long long ksh, long long ksl, const void* v,
                            long long vsn, long long vsh, long long vsl,
                            void* o, void* lse, int N, int H, int Lq, int Lk,
                            int d, float scale, void* stream) {
  if (bad_shape(N, H, Lq, Lk, d)) return (int)cudaErrorInvalidValue;
  const Rows rq = rows(q, qsn, qsh, qsl), rk = rows(k, ksn, ksh, ksl),
             rv = rows(v, vsn, vsh, vsl);
  float* op = static_cast<float*>(o);
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STC_FA_FWD(nc) fwd<nc>(rq, rk, rv, op, lp, N, H, Lq, Lk, d, scale, s)
  STC_FA_DISPATCH(STC_FA_FWD)
#undef STC_FA_FWD
}

// As the forward, plus do (N, H, Lq, d) with its strides, and lse and di
// (N, H, Lq) contiguous float32. Writes dk and dv (N, H, Lk, d), contiguous.
int stc_flash_attention_bwd_dkv(
    const void* q, long long qsn, long long qsh, long long qsl, const void* k,
    long long ksn, long long ksh, long long ksl, const void* v, long long vsn,
    long long vsh, long long vsl, const void* dout, long long dsn,
    long long dsh, long long dsl, const void* lse, const void* di, void* dk,
    void* dv, int N, int H, int Lq, int Lk, int d, float scale,
    void* stream) {
  if (bad_shape(N, H, Lq, Lk, d)) return (int)cudaErrorInvalidValue;
  const Rows rq = rows(q, qsn, qsh, qsl), rk = rows(k, ksn, ksh, ksl),
             rv = rows(v, vsn, vsh, vsl), rd = rows(dout, dsn, dsh, dsl);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(di);
  float* dkp = static_cast<float*>(dk);
  float* dvp = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STC_FA_DKV(nc) \
  dkv<nc>(rq, rk, rv, rd, lp, dp, dkp, dvp, N, H, Lq, Lk, d, scale, s)
  STC_FA_DISPATCH(STC_FA_DKV)
#undef STC_FA_DKV
}

// As Ldkv; writes dq (N, H, Lq, d), contiguous.
int stc_flash_attention_bwd_dq(
    const void* q, long long qsn, long long qsh, long long qsl, const void* k,
    long long ksn, long long ksh, long long ksl, const void* v, long long vsn,
    long long vsh, long long vsl, const void* dout, long long dsn,
    long long dsh, long long dsl, const void* lse, const void* di, void* dq_,
    int N, int H, int Lq, int Lk, int d, float scale, void* stream) {
  if (bad_shape(N, H, Lq, Lk, d)) return (int)cudaErrorInvalidValue;
  const Rows rq = rows(q, qsn, qsh, qsl), rk = rows(k, ksn, ksh, ksl),
             rv = rows(v, vsn, vsh, vsl), rd = rows(dout, dsn, dsh, dsl);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(di);
  float* dqp = static_cast<float*>(dq_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STC_FA_DQ(nc) \
  dq<nc>(rq, rk, rv, rd, lp, dp, dqp, N, H, Lq, Lk, d, scale, s)
  STC_FA_DISPATCH(STC_FA_DQ)
#undef STC_FA_DQ
}

}  // extern "C"
