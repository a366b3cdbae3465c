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
// Rounding points (the TPU kernel's): q is multiplied by scale in q's type;
// the scores are f32 and take the f32 bias; the stabiliser is the head's own
// row max (the TPU kernel takes the max over all heads of the row, which is
// as valid and differs only by f32 rounding); the softmax is f32; attn is
// rounded to q's type before the dropout multiply (in q's type) and before
// the apply; every product sums in f32 and is rounded once. dbias is f32,
// summed over all windows.
//
// Dropout draw map. Element (w, h, n, m) of the attention weights keeps its
// weight when its 32-bit draw is below thresh. The draw is word
//   ((n >> 3) & 1) * 2 + (m & 1)
// of Philox4x32-10 (Salmon et al., SC 2011) at the counter
//   (w*H + h) * 1024 + (n >> 4) * 256 + (n & 7) * 32 + (m >> 3) * 4
//                    + ((m >> 1) & 3)
// as the words (counter mod 2^32, counter >> 32, 0, 0), keyed by the 64-bit
// seed (read from device memory). Those four elements, rows n and n + 8 and
// columns m and m + 1 (n mod 16 < 8, m even), are the four values one
// thread holds of an MMA accumulator, so each Philox call feeds four
// weights. The backward draws the same words, so the forward's mask is
// recomputed, never stored. ops/window_attention.py (dropout_bits) computes
// the same map.
//
// Design. A block of 4 warps owns one head and a run of windows; warp i
// takes query rows 16 i .. 16 i + 15 of each window. Every product runs on
// the tensor cores by mma.sync m16n8k8: d is padded with zeros to 8 or 16
// (the products' depth over d, or their width), keys and rows past N are
// zeros, and scores past N are -inf. bf16 runs the bf16 MMA: a product of
// two bf16 values is exact in f32, and the MMA adds eight of them to an f32
// accumulator, so the kernel keeps the roundings above up to the order and
// rounding of f32 sums. Its sums round toward zero; no chain here is longer
// than eight steps (64 keys or rows), far from the drift that made the
// flash kernels sum long chains in pieces. float32 runs 3xTF32 on the TF32
// MMA: each operand is split into hi = tf32(x) to nearest and lo = x - hi,
// and a product is lo.hi + hi.lo + hi.hi, as csrc/flash_attention.cu does
// (its helpers are copied below, not shared, so that its build stays byte
// for byte as it was).
//
// Fragments (g = lane / 4, c = lane % 4). A thread holds, of an m16n8k8
// step, the pairs A[g][2c, 2c+1] and A[g+8][2c, 2c+1], the pair B[2c, 2c+1]
// [g] and the accumulator C[g][2c], C[g][2c+1], C[g+8][2c], C[g+8][2c+1]. A
// pair is two values of the type side by side (bf16: one register, the
// first in the low half). The bf16 MMA reads its operands so; the TF32 MMA,
// whose k index c is logical column 2c and k index c + 4 is 2c + 1, reads
// both operands through that one permutation of k, which leaves the
// product as it is. Either way a score tile's accumulator is the A operand
// of the next product's step: P goes from the scores to P.v, and ds to
// ds.k, in registers, as FlashAttention-2 does.
//
// K3f, per window: q (times scale, rounded) in A fragments; S = q k^T, 8
// tiles of 16 x 8, plus the head's bias, which each thread keeps in 32
// registers for the whole run; the row max and sum by quad shuffles; p =
// exp2(s log2 e - max log2 e) by ex2.approx (relative error about 2^-22,
// and the folded multiply adds about |max| 2^-24: both far inside the
// checks' rtol 1e-4 in f32, 2^-7 in bf16); p rounded and dropped; o = p v.
// q, k and v of the next window come into a second buffer in shared memory
// by cp.async (16, 8 or 4 bytes a copy, as the rows' alignment allows;
// element by element where they are only 2-byte aligned) while this window
// is computed. One barrier a window.
//
// K3b, per window, phase 1 (a warp per 16 query rows): S and p again, dp =
// do v^T with the same draws, ds = p (dp - rowsum(dp p)) in f32, added into
// the head's dbias partial (32 registers a thread for the whole chunk of
// windows), and dq = ds k scale. ds rounded to the type and the used weights
// go to shared memory once. Phase 2 (a warp per 16 key rows): dk = ds^T
// (q scale) and dv = p^T do, the transposed operands read by ldmatrix.trans
// in bf16. Each block takes a fixed chunk of windows and writes its head's
// N x N partial of dbias; a second pass adds the chunks in order. No
// atomics: every sum runs in a fixed order, so reruns are bit-identical.
//
// What bounds them on an H100 SXM. At B=8, 512^2 in bf16, the 28 calls of
// one forward move 0.97 GB (q, k, v read, out written: 0.29 ms at 3.35
// TB/s) and take W*H*N^2 = 2.83e9 exponentials (0.68 ms at 16 per SM per
// clock, 132 SMs at 1.98 GHz); their 31 GFLOP of products take 0.03 ms on
// the bf16 tensor cores. So K3f is bound by the exponentials. K3b takes the
// same exponentials and moves 7 tensors (1.70 GB, 0.51 ms): bound by the
// exponentials too. Beside each exponential the design issues about 7 f32
// operations in the forward (bias, max, scale and subtract, sum, reciprocal
// multiply, rounding) and about 15 in the backward, at 128 a clock against
// the exponential's 16: about the same time as the exponentials. Dropout
// adds a quarter of a Philox4x32-10 call (10 rounds of two 32-bit wide
// multiplies and two three-way xors) to each weight, counted in no bound.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxN = 64;           // rows of a window, padded
constexpr int kWarps = 4;           // a warp per 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

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

// The four words of Philox4x32-10 at counter (lo, hi, 0, 0) under the key
// words (k0, k1).
__device__ __forceinline__ uint4 philox4(uint64_t ctr, uint32_t k0,
                                         uint32_t k1) {
  uint32_t c0 = (uint32_t)ctr, c1 = (uint32_t)(ctr >> 32), c2 = 0u, c3 = 0u;
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
  return make_uint4(c0, c1, c2, c3);
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
  return kept ? round_to<T>(round_to<T>(attn) * drop.mult) : 0.f;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Products on the tensor cores
// ---------------------------------------------------------------------------

// From csrc/flash_attention.cu: x rounded to TF32 to nearest (ties away
// from zero), and x as hi + lo with lo = x - hi, which the MMA reads
// truncated to TF32.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&acc)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The pair type of T and the operations on pairs and fragments (see the
// header): pack two f32 values (rounded to T), load or store a pair, the
// MMA step acc += A B of A pairs (a0: rows g, a1: rows g + 8) and a B pair,
// and two transposed reads of a [k][n] tile X with rows of rs elements:
//   b_trans4: the B pairs (X[k0 + 8i + 2c][n0 + g], X[k0 + 8i + 2c + 1]
//             [n0 + g]) of four k8 steps i;
//   a_trans2: the A pairs of A[r][k] = X[k0 + k][m0 + r], two k8 steps i,
//             a[i][0] for rows g and a[i][1] for rows g + 8.
template <typename T> struct Ops;

template <> struct Ops<float> {
  using P = float2;
  static __device__ __forceinline__ P pack(float x, float y) {
    return make_float2(x, y);
  }
  static __device__ __forceinline__ P load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, P v) {
    *reinterpret_cast<float2*>(p) = v;
  }
  static __device__ __forceinline__ float2 unpack(P v) { return v; }
  // 3xTF32: the small terms first, then hi.hi
  static __device__ __forceinline__ void mma(float (&acc)[4], P a0, P a1,
                                             P b) {
    unsigned ah[4], al[4], bh[2], bl[2];
    split(a0.x, ah[0], al[0]);
    split(a1.x, ah[1], al[1]);
    split(a0.y, ah[2], al[2]);
    split(a1.y, ah[3], al[3]);
    split(b.x, bh[0], bl[0]);
    split(b.y, bh[1], bl[1]);
    mma_tf32(acc, al, bh);
    mma_tf32(acc, ah, bl);
    mma_tf32(acc, ah, bh);
  }
  static __device__ __forceinline__ void b_trans4(P (&b)[4], const float* x,
                                                  int rs, int k0, int n0,
                                                  int lane) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* p = x + (k0 + 8 * i + 2 * c) * rs + n0 + g;
      b[i] = make_float2(p[0], p[rs]);
    }
  }
  static __device__ __forceinline__ void a_trans2(P (&a)[2][2],
                                                  const float* x, int rs,
                                                  int k0, int m0, int lane) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* p = x + (k0 + 8 * i + 2 * c) * rs + m0 + g;
      a[i][0] = make_float2(p[0], p[rs]);
      a[i][1] = make_float2(p[8], p[rs + 8]);
    }
  }
};

template <> struct Ops<__nv_bfloat16> {
  using P = uint32_t;
  static __device__ __forceinline__ P pack(float x, float y) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);  // x low
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ P load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, P v) {
    *reinterpret_cast<uint32_t*>(p) = v;
  }
  static __device__ __forceinline__ float2 unpack(P v) {
    return make_float2(__uint_as_float(v << 16),
                       __uint_as_float(v & 0xffff0000u));
  }
  static __device__ __forceinline__ void mma(float (&acc)[4], P a0, P a1,
                                             P b) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
        : "r"(a0), "r"(a1), "r"(b));
  }
  // ldmatrix.trans: lane l gives the address of row l % 8 of 8 x 8 matrix
  // l / 8, and receives, of each matrix M, the pair (M[2c][g], M[2c+1][g])
  static __device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4],
                                                     const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  }
  static __device__ __forceinline__ void b_trans4(P (&b)[4],
                                                  const __nv_bfloat16* x,
                                                  int rs, int k0, int n0,
                                                  int lane) {
    ldsm4_trans(b, x + (k0 + 8 * (lane >> 3) + (lane & 7)) * rs + n0);
  }
  static __device__ __forceinline__ void a_trans2(P (&a)[2][2],
                                                  const __nv_bfloat16* x,
                                                  int rs, int k0, int m0,
                                                  int lane) {
    uint32_t r[4];
    ldsm4_trans(r, x + (k0 + 8 * (lane >> 4) + (lane & 7)) * rs + m0 +
                       8 * ((lane >> 3) & 1));
    a[0][0] = r[0];
    a[0][1] = r[1];
    a[1][0] = r[2];
    a[1][1] = r[3];
  }
};

// q times scale_q, rounded to T, as a pair.
template <typename T>
__device__ __forceinline__ typename Ops<T>::P scaled(typename Ops<T>::P p,
                                                    float scale_q) {
  const float2 f = Ops<T>::unpack(p);
  return Ops<T>::pack(f.x * scale_q, f.y * scale_q);
}

// ---------------------------------------------------------------------------
// Staging rows in shared memory
// ---------------------------------------------------------------------------

// A staged tile holds 64 rows of d (padded to 8 or 16) elements; its row
// stride keeps the pair reads (8 rows x 4 pairs a warp) and ldmatrix's
// 8 x 16-byte rows on distinct banks, and every row 16-byte aligned.
template <typename T, int D> struct Stage {
  static constexpr int kDp = D <= 8 ? 8 : 16;
  static constexpr int kRow =
      sizeof(T) == 2 ? (kDp == 8 ? 8 : 24) : (kDp == 8 ? 12 : 20);
  static constexpr int kTile = kMaxN * kRow;
};

// The 64 x 64 tiles of ds and of the used weights in K3b: rows of 72 bf16
// (144 bytes) or 68 f32, so that pair stores and ldmatrix (bf16) or
// column reads (f32) fall on distinct banks.
template <typename T> struct Probs {
  static constexpr int kRow = sizeof(T) == 2 ? 72 : 68;
};

template <int U>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = smem_addr(dst);
  if constexpr (U == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else if constexpr (U == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies rows 0 .. N-1 of src (d elements each, rows ld apart) into the
// staged tile dst, U bytes a cp.async; U = 0 copies element by element.
template <typename T, int D, int U>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int N,
                                          long long ld) {
  constexpr int kRow = Stage<T, D>::kRow;
  if constexpr (U == 0) {
    for (int i = threadIdx.x; i < N * D; i += kThreads) {
      const int r = i / D, j = i % D;
      dst[r * kRow + j] = src[r * ld + j];
    }
  } else if constexpr (D * (int)sizeof(T) >= U) {
    constexpr int kUnits = D * (int)sizeof(T) / U, kElems = U / sizeof(T);
    for (int i = threadIdx.x; i < N * kUnits; i += kThreads) {
      const int r = i / kUnits, u = i % kUnits;
      cp_async<U>(dst + r * kRow + u * kElems, src + r * ld + u * kElems);
    }
  }
}

// Starts the copy of head h of window w of x (rows of ld) into dst; vec is
// the copy's unit in bytes (16, 8 or 4), or 0.
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, const T* x, long long w,
                                      int N, int h, long long ld, int vec) {
  const T* src = x + w * N * ld + (long long)h * D;
  switch (vec) {
    case 16: copy_rows<T, D, 16>(dst, src, N, ld); break;
    case 8: copy_rows<T, D, 8>(dst, src, N, ld); break;
    case 4: copy_rows<T, D, 4>(dst, src, N, ld); break;
    default: copy_rows<T, D, 0>(dst, src, N, ld); break;
  }
}

// Zeros the block's shared memory (bytes a multiple of 16): the padding of
// d and the rows past N stay zero, since no copy writes them.
__device__ __forceinline__ void zero_smem(void* smem, int bytes) {
  uint4* p = static_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
    p[i] = make_uint4(0u, 0u, 0u, 0u);
}

// This thread's 32 values of bias_h, in the score tiles' accumulator
// layout (rows r0 and r0 + 8, columns 8t + 2c and + 1): -inf past N keys,
// 0 in rows past N.
__device__ __forceinline__ void load_bias(float (&b)[8][4],
                                          const float* __restrict__ bias_e,
                                          int N, int H, int h, int r0,
                                          int c) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = r0 + 8 * (e >> 1), m = 8 * t + 2 * c + (e & 1);
      b[t][e] = m >= N   ? -CUDART_INF_F
                : n >= N ? 0.f
                         : bias_e[(size_t)n * H * N + (size_t)h * N + m];
    }
}

// The scores of this warp's 16 rows against the 64 keys, plus the bias, as
// softmax weights attn (f32): S = (q scale) k^T from the A pairs qa.
template <typename T, int D>
__device__ __forceinline__ void softmax_rows(
    float (&x)[8][4], const typename Ops<T>::P (&qa)[Stage<T, D>::kDp / 8][2],
    const T* ks, const float (&bias)[8][4], int g, int c) {
  using O = Ops<T>;
  constexpr int KS = Stage<T, D>::kDp / 8, kRow = Stage<T, D>::kRow;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < KS; ++s)
      O::mma(acc, qa[s][0], qa[s][1],
             O::load(ks + (8 * t + g) * kRow + 8 * s + 2 * c));
#pragma unroll
    for (int e = 0; e < 4; ++e) x[t][e] = acc[e] + bias[t][e];
  }
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    m0 = fmaxf(m0, fmaxf(x[t][0], x[t][1]));
    m1 = fmaxf(m1, fmaxf(x[t][2], x[t][3]));
  }
  const float o0 = quad_max(m0) * kLog2e, o1 = quad_max(m1) * kLog2e;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    x[t][0] = ex2(fmaf(x[t][0], kLog2e, -o0));
    x[t][1] = ex2(fmaf(x[t][1], kLog2e, -o0));
    x[t][2] = ex2(fmaf(x[t][2], kLog2e, -o1));
    x[t][3] = ex2(fmaf(x[t][3], kLog2e, -o1));
    s0 += x[t][0] + x[t][1];
    s1 += x[t][2] + x[t][3];
  }
  const float rec0 = 1.f / quad_sum(s0), rec1 = 1.f / quad_sum(s1);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    x[t][0] *= rec0;
    x[t][1] *= rec0;
    x[t][2] *= rec1;
    x[t][3] *= rec1;
  }
}

// ---------------------------------------------------------------------------
// K3f. Grid (H, ceil(W / wpb)), 128 threads; block (h, y) takes windows
// [y wpb, min(W, (y + 1) wpb)).
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
wa_fwd(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const float* __restrict__ bias_e,
       const int64_t* __restrict__ seed, T* __restrict__ out, int W, int N,
       int H, int ld, int wpb, int vec, float scale_q, Drop drop) {
  using O = Ops<T>;
  using P = typename O::P;
  using S = Stage<T, D>;
  constexpr int KS = S::kDp / 8, kRow = S::kRow, kTile = S::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [buffer][q, k, v][64][kRow]
  zero_smem(smem, 2 * 3 * kTile * sizeof(T));
  const int h = blockIdx.x, lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = 16 * wp + g, r1 = r0 + 8;
  const long long C = (long long)H * D;
  const long long w_begin = (long long)blockIdx.y * wpb;
  const long long w_end = min((long long)W, w_begin + wpb);
  __syncthreads();  // the zeros are in place before a copy lands
  stage<T, D>(tiles, q, w_begin, N, h, ld, vec);
  stage<T, D>(tiles + kTile, k, w_begin, N, h, ld, vec);
  stage<T, D>(tiles + 2 * kTile, v, w_begin, N, h, ld, vec);
  cp_async_commit();
  // the bias and the seed load while the first window's copy is in flight
  float bias[8][4];
  load_bias(bias, bias_e, N, H, h, r0, c);
  uint32_t key0 = 0u, key1 = 0u;
  if (drop.on) {
    const uint64_t s = (uint64_t)seed[0];
    key0 = (uint32_t)s;
    key1 = (uint32_t)(s >> 32);
  }
  int buf = 0;
  for (long long w = w_begin; w < w_end; ++w, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this window is in; the other buffer is free
    if (w + 1 < w_end) {
      T* next = tiles + (buf ^ 1) * 3 * kTile;
      stage<T, D>(next, q, w + 1, N, h, ld, vec);
      stage<T, D>(next + kTile, k, w + 1, N, h, ld, vec);
      stage<T, D>(next + 2 * kTile, v, w + 1, N, h, ld, vec);
    }
    cp_async_commit();
    if (16 * wp >= N) continue;
    const T* qs = tiles + buf * 3 * kTile;
    const T* ks = qs + kTile;
    const T* vs = ks + kTile;
    P qa[KS][2];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      qa[s][0] = scaled<T>(O::load(qs + r0 * kRow + 8 * s + 2 * c), scale_q);
      qa[s][1] = scaled<T>(O::load(qs + r1 * kRow + 8 * s + 2 * c), scale_q);
    }
    float x[8][4];
    softmax_rows<T, D>(x, qa, ks, bias, g, c);
    P vb[KS][2][4];
#pragma unroll
    for (int nt = 0; nt < KS; ++nt) {
      O::b_trans4(vb[nt][0], vs, kRow, 0, 8 * nt, lane);
      O::b_trans4(vb[nt][1], vs, kRow, 32, 8 * nt, lane);
    }
    const uint64_t ctr = (((uint64_t)w * H + h) << 10) |
                         (uint64_t)((wp << 8) | (g << 5) | c);
    float o[KS][4];
#pragma unroll
    for (int nt = 0; nt < KS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float* a = x[t];
      if (drop.on) {
        const uint4 bits = philox4(ctr | (uint64_t)(t << 2), key0, key1);
        a[0] = used_weight<T>(a[0], bits.x < drop.thresh, drop);
        a[1] = used_weight<T>(a[1], bits.y < drop.thresh, drop);
        a[2] = used_weight<T>(a[2], bits.z < drop.thresh, drop);
        a[3] = used_weight<T>(a[3], bits.w < drop.thresh, drop);
      }
      const P pa0 = O::pack(a[0], a[1]), pa1 = O::pack(a[2], a[3]);
#pragma unroll
      for (int nt = 0; nt < KS; ++nt)
        O::mma(o[nt], pa0, pa1, vb[nt][t >> 2][t & 3]);
    }
    T* row0 = out + ((long long)w * N + r0) * C + (long long)h * D;
    T* row1 = row0 + 8 * C;
#pragma unroll
    for (int nt = 0; nt < KS; ++nt) {
      const int j = 8 * nt + 2 * c;
      if (j >= D) continue;
      if (r0 < N) O::store(row0 + j, O::pack(o[nt][0], o[nt][1]));
      if (r1 < N) O::store(row1 + j, O::pack(o[nt][2], o[nt][3]));
    }
  }
}

// ---------------------------------------------------------------------------
// K3b, pass 1. Grid (H, chunks), 128 threads; block (h, y) takes windows
// [y wpc, min(W, (y + 1) wpc)) and writes its head's N x N partial of dbias
// into part[y] ((chunks, N, H*N) f32).
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
wa_bwd(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const float* __restrict__ bias_e,
       const int64_t* __restrict__ seed, const T* __restrict__ dout,
       T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
       float* __restrict__ part, int W, int N, int H, int ld, int wpc,
       int vec, int vec_do, float scale_q, float scale, Drop drop) {
  using O = Ops<T>;
  using P = typename O::P;
  using S = Stage<T, D>;
  constexpr int KS = S::kDp / 8, kRow = S::kRow, kTile = S::kTile;
  constexpr int kProb = Probs<T>::kRow;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [buffer][q, k, v, do][64][kRow]
  T* dss = tiles + 2 * 4 * kTile;         // ds in T, [query row][key]
  T* pus = dss + kMaxN * kProb;           // the used weights, the same
  zero_smem(smem, (2 * 4 * kTile + 2 * kMaxN * kProb) * sizeof(T));
  const int h = blockIdx.x, lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = 16 * wp + g, r1 = r0 + 8;
  const bool rows = 16 * wp < N;  // this warp has a row (phase 1) or key
                                  // row (phase 2) below N
  const long long C = (long long)H * D;
  const long long w_begin = (long long)blockIdx.y * wpc;
  const long long w_end = min((long long)W, w_begin + wpc);
  __syncthreads();  // the zeros are in place before a copy lands
  stage<T, D>(tiles, q, w_begin, N, h, ld, vec);
  stage<T, D>(tiles + kTile, k, w_begin, N, h, ld, vec);
  stage<T, D>(tiles + 2 * kTile, v, w_begin, N, h, ld, vec);
  stage<T, D>(tiles + 3 * kTile, dout, w_begin, N, h, C, vec_do);
  cp_async_commit();
  // the bias and the seed load while the first window's copy is in flight
  float bias[8][4], db[8][4];
  load_bias(bias, bias_e, N, H, h, r0, c);
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[t][e] = 0.f;
  uint32_t key0 = 0u, key1 = 0u;
  if (drop.on) {
    const uint64_t s = (uint64_t)seed[0];
    key0 = (uint32_t)s;
    key1 = (uint32_t)(s >> 32);
  }
  int buf = 0;
  for (long long w = w_begin; w < w_end; ++w, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this window is in; the last one's phase 2 is done
    if (w + 1 < w_end) {
      T* next = tiles + (buf ^ 1) * 4 * kTile;
      stage<T, D>(next, q, w + 1, N, h, ld, vec);
      stage<T, D>(next + kTile, k, w + 1, N, h, ld, vec);
      stage<T, D>(next + 2 * kTile, v, w + 1, N, h, ld, vec);
      stage<T, D>(next + 3 * kTile, dout, w + 1, N, h, C, vec_do);
    }
    cp_async_commit();
    T* qs = tiles + buf * 4 * kTile;
    const T* ks = qs + kTile;
    const T* vs = ks + kTile;
    const T* dos = vs + kTile;
    // q * scale, rounded to T, in place: the scores' A and dk's B operand
    for (int i = threadIdx.x; i < N * D; i += kThreads) {
      T& e = qs[(i / D) * kRow + i % D];
      e = from_f32<T>(to_f32(e) * scale_q);
    }
    __syncthreads();
    // phase 1: this warp's 16 query rows
    if (rows) {
      P qa[KS][2], da[KS][2];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        qa[s][0] = O::load(qs + r0 * kRow + 8 * s + 2 * c);
        qa[s][1] = O::load(qs + r1 * kRow + 8 * s + 2 * c);
        da[s][0] = O::load(dos + r0 * kRow + 8 * s + 2 * c);
        da[s][1] = O::load(dos + r1 * kRow + 8 * s + 2 * c);
      }
      float at[8][4], tt[8][4];
      softmax_rows<T, D>(at, qa, ks, bias, g, c);
      const uint64_t ctr = (((uint64_t)w * H + h) << 10) |
                           (uint64_t)((wp << 8) | (g << 5) | c);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < KS; ++s)
          O::mma(dp, da[s][0], da[s][1],
                 O::load(vs + (8 * t + g) * kRow + 8 * s + 2 * c));
        float u[4] = {at[t][0], at[t][1], at[t][2], at[t][3]};
        if (drop.on) {
          const uint4 bits = philox4(ctr | (uint64_t)(t << 2), key0, key1);
          const bool kept[4] = {bits.x < drop.thresh, bits.y < drop.thresh,
                                bits.z < drop.thresh, bits.w < drop.thresh};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dp[e] = kept[e] ? dp[e] * drop.mult : 0.f;
            u[e] = used_weight<T>(u[e], kept[e], drop);
          }
        }
        O::store(pus + r0 * kProb + 8 * t + 2 * c, O::pack(u[0], u[1]));
        O::store(pus + r1 * kProb + 8 * t + 2 * c, O::pack(u[2], u[3]));
#pragma unroll
        for (int e = 0; e < 4; ++e) tt[t][e] = dp[e] * at[t][e];
        rs0 += tt[t][0] + tt[t][1];
        rs1 += tt[t][2] + tt[t][3];
      }
      rs0 = quad_sum(rs0);
      rs1 = quad_sum(rs1);
      P dsa[8][2];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[e] = tt[t][e] - at[t][e] * (e < 2 ? rs0 : rs1);
          db[t][e] += ds[e];
        }
        dsa[t][0] = O::pack(ds[0], ds[1]);
        dsa[t][1] = O::pack(ds[2], ds[3]);
        O::store(dss + r0 * kProb + 8 * t + 2 * c, dsa[t][0]);
        O::store(dss + r1 * kProb + 8 * t + 2 * c, dsa[t][1]);
      }
      // dq = ds k, times scale
      T* row0 = dq + ((long long)w * N + r0) * C + (long long)h * D;
      T* row1 = row0 + 8 * C;
#pragma unroll
      for (int nt = 0; nt < KS; ++nt) {
        P kb[2][4];
        O::b_trans4(kb[0], ks, kRow, 0, 8 * nt, lane);
        O::b_trans4(kb[1], ks, kRow, 32, 8 * nt, lane);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < 8; ++t)
          O::mma(acc, dsa[t][0], dsa[t][1], kb[t >> 2][t & 3]);
        const int j = 8 * nt + 2 * c;
        if (j >= D) continue;
        if (r0 < N) O::store(row0 + j, O::pack(acc[0] * scale, acc[1] * scale));
        if (r1 < N) O::store(row1 + j, O::pack(acc[2] * scale, acc[3] * scale));
      }
    }
    __syncthreads();  // ds and the used weights are in
    // phase 2: this warp's 16 key rows, r0 and r1 as key rows
    if (rows) {
      float dka[KS][4], dva[KS][4];
#pragma unroll
      for (int nt = 0; nt < KS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        P qb[KS][4], ob[KS][4];
#pragma unroll
        for (int nt = 0; nt < KS; ++nt) {
          O::b_trans4(qb[nt], qs, kRow, 32 * half, 8 * nt, lane);
          O::b_trans4(ob[nt], dos, kRow, 32 * half, 8 * nt, lane);
        }
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          P sa[2][2], pa[2][2];
          O::a_trans2(sa, dss, kProb, 32 * half + 16 * pr, 16 * wp, lane);
          O::a_trans2(pa, pus, kProb, 32 * half + 16 * pr, 16 * wp, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int nt = 0; nt < KS; ++nt) {
              O::mma(dka[nt], sa[i][0], sa[i][1], qb[nt][2 * pr + i]);
              O::mma(dva[nt], pa[i][0], pa[i][1], ob[nt][2 * pr + i]);
            }
        }
      }
      const long long off0 = ((long long)w * N + r0) * C + (long long)h * D;
#pragma unroll
      for (int nt = 0; nt < KS; ++nt) {
        const int j = 8 * nt + 2 * c;
        if (j >= D) continue;
        if (r0 < N) {
          O::store(dk + off0 + j, O::pack(dka[nt][0], dka[nt][1]));
          O::store(dv + off0 + j, O::pack(dva[nt][0], dva[nt][1]));
        }
        if (r1 < N) {
          O::store(dk + off0 + 8 * C + j, O::pack(dka[nt][2], dka[nt][3]));
          O::store(dv + off0 + 8 * C + j, O::pack(dva[nt][2], dva[nt][3]));
        }
      }
    }
  }
  float* dst = part + (size_t)blockIdx.y * N * H * N + (size_t)h * N;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = r0 + 8 * (e >> 1), m = 8 * t + 2 * c + (e & 1);
      if (n < N && m < N) dst[(size_t)n * H * N + m] = db[t][e];
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

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename T, int D> constexpr size_t fwd_smem() {
  return 2 * 3 * Stage<T, D>::kTile * sizeof(T);
}

template <typename T, int D> constexpr size_t bwd_smem() {
  return (2 * 4 * Stage<T, D>::kTile + 2 * kMaxN * Probs<T>::kRow) *
         sizeof(T);
}

// Raises a kernel's dynamic shared memory limit to bytes, once per device
// (a kernel's attribute is set per device; the call costs host time).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes,
                       std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The largest copy unit (16, 8 or 4 bytes) that divides a row's d elements,
// the row stride and every base address; 0 if none does.
int copy_unit(int D, int esize, long long ld, const void* const* ptrs,
              int n) {
  const long long row = (long long)D * esize, stride = ld * esize;
  for (int u = 16; u >= 4; u /= 2) {
    if (row % u || stride % u) continue;
    bool aligned = true;
    for (int i = 0; i < n; ++i)
      aligned = aligned && reinterpret_cast<uintptr_t>(ptrs[i]) % u == 0;
    if (aligned) return u;
  }
  return 0;
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* bias_e, const int64_t* seed, void* out, int W,
               int N, int H, int ld, float scale_q, Drop drop,
               cudaStream_t s) {
  // about 2048 blocks in all (4 waves at 4 blocks an SM), so that a block
  // takes a run of windows at the wide stages (32 at B=8's /4) and its
  // start (zeros, bias, the first copy) is paid once for them; grid.y
  // stays under 4096 for any W
  const int wpb = (int)max(1ll, (long long)W * H / 2048);
  const void* rows[3] = {q, k, v};
  const int vec = copy_unit(D, sizeof(T), ld, rows, 3);
  dim3 grid(H, (W + wpb - 1) / wpb);
  wa_fwd<T, D><<<grid, kThreads, fwd_smem<T, D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias_e, seed, static_cast<T*>(out), W, N, H,
      ld, wpb, vec, scale_q, drop);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v,
               const float* bias_e, const int64_t* seed, const void* dout,
               void* dq, void* dk, void* dv, float* part, float* dbias,
               int W, int N, int H, int ld, int chunks, int wpc,
               float scale_q, float scale, Drop drop, cudaStream_t s) {
  static std::atomic<unsigned long long> smem_set{0};
  constexpr size_t bytes = bwd_smem<T, D>();
  cudaError_t err = allow_smem(wa_bwd<T, D>, bytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const void* rows[3] = {q, k, v};
  const int vec = copy_unit(D, sizeof(T), ld, rows, 3);
  const int vec_do = copy_unit(D, sizeof(T), (long long)H * D, &dout, 1);
  wa_bwd<T, D><<<dim3(H, chunks), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias_e, seed, static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), part,
      W, N, H, ld, wpc, vec, vec_do, scale_q, scale, drop);
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

template <typename T>
int smem_for(int backward, int D) {
#define STC_WA_SMEM(d) \
  return (int)(backward ? bwd_smem<T, d>() : fwd_smem<T, d>())
  switch (D) {
    case 2: STC_WA_SMEM(2);
    case 4: STC_WA_SMEM(4);
    case 8: STC_WA_SMEM(8);
    case 16: STC_WA_SMEM(16);
  }
#undef STC_WA_SMEM
  return -1;
}

bool bad_shape(int W, int N, int H, int D, int ld) {
  return W < 1 || N < 1 || N > kMaxN || H < 1 || H > 65535 ||
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

// The dynamic shared memory, in bytes, of a block of K3f (backward = 0) or
// K3b (backward != 0) for dtype 0 (float32) or 1 (bfloat16) and head width
// D; -1 for a D or dtype with no kernel.
int stc_window_attention_smem(int backward, int dtype, int D) {
  if (dtype == 0) return smem_for<float>(backward, D);
  if (dtype == 1) return smem_for<__nv_bfloat16>(backward, D);
  return -1;
}

}  // extern "C"
