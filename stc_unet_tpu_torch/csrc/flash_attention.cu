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
// What bounds Lf on an H100 SXM. The STC transformer has 2 heads of d =
// 256. At whole B=8 (x4: L = 4096, x5: L = 1024, 4 layers each) one
// forward's eight Lf calls take 2 L x L x d products each, 1.17e12 flop in
// all: 17.4 ms at the 67 TFLOP/s f32 rate outside the tensor cores, against
// 0.3 ms of exponentials and about 0.1 ms of bytes. So Lf is bound by its
// f32 products. Every product is an f32 FMA, not TF32: the kernels are held
// to the CPU's f32 results.
//
// Lf's design (a first version, right before fast): CUDA-core FMAs on tiles
// in shared memory. A block has 256 threads as 16 x 16 (ty, tx); each
// product C = A B over a tile gives thread (ty, tx) the rows ty + 16 i and
// the columns tx + 16 j of C, in registers (tile_fma). Along a row of C the
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
// L x L matrix and stores only o and lse. ptxas gives it up to 163
// registers a thread and no spills; above 128, an SM holds one block of 8
// warps, too few to hide the shared-memory latency.
//
// Ldkv and Ldq, on the tensor cores. Ldkv runs 4 products a tile (s, dp,
// dv, dk), Ldq 3 (s, dp, dq): 2.34e12 and 1.75e12 flop per B=8 train step.
// Each is done in 3xTF32 (below), three TF32 products per f32 product, at
// the 495 TFLOP/s TF32 tensor-core rate: 14.2 and 10.6 ms per step. That is
// their bound; the exponentials (each kernel recomputes p, 1.1e9 a step at
// 16 per SM per clock) take about 0.3 ms, and their bytes about 0.5 ms.
//
// Why 3xTF32 and not TF32. TF32 keeps 10 mantissa bits. The kernels are
// held to f32 (rtol 1e-4, atol 1e-5 of the largest value) and so is the
// JAX reference; one TF32 product of ds k over 1024 keys misses that by
// about 20x, while the split lands within a few per cent of it, as plain
// f32 does (tests/test_torch_flash_attention.py emulates both). Each
// operand x is split as it is loaded from shared memory into hi = tf32(x)
// (to nearest) and lo = x - hi, and a product is lo.hi + hi.lo + hi.hi
// (CUTLASS's OpMultiplyAddFastF32). The split never depends on torch's
// TF32 flags. The MMA's own f32 sum rounds toward zero; over 4096 rows one
// chain of them (about 1500 sums, each off by up to 2^-24 of the total, all
// the same way) drifts to about 1e-4, so every 32 columns (scores) or 32
// rows (gradients) are summed in fresh accumulators and then added in f32.
//
// Their design. A block of 8 warps owns a tile of 32 keys (Ldkv) or 32
// query rows (Ldq), kept in shared memory (k and v, or q and do), and
// walks the other side in tiles of 32, streamed through a two-stage ring
// by cp.async (16 bytes a thread where the rows are 16-byte aligned,
// else 4; zero-filled past L and d), so the next tile is in flight while
// this one is multiplied. Every product is mma.sync m16n8k8 row.col: the
// score products s (k q^T in Ldkv, q k^T in Ldq) and dp take q, k, v and
// do as stored rows, warps 0-3 computing s and warps 4-7 dp, each an m16
// x n16 fragment over d. p = exp(s - lse) and ds = p (dp - di) scale are
// staged in shared memory (32 x 32 each) as the A operand of the
// gradient products, dv += p^T do and dk += ds^T q, or dq += ds k, which
// read do, q or k as [k][n] tiles. Each warp accumulates those over 32
// rows and every eighth column block of 8 in registers. Tiles are stored
// with an XOR swizzle of the column's bits 2-4 by the row, so that both
// the row-fragment reads (8 rows x 4 columns a warp) and the
// column-fragment reads (4 rows x 8 columns) hit 32 banks. d is padded
// with zeros to DP in {32, 64, 128, 256}, over which the products run. At
// d = 256 a block takes 205 KB of shared memory: one block of 8 warps an
// SM, two a scheduler, so up to 255 registers a thread and little to hide
// latency with; ptxas must report no spills (chip_smoke.py's build line).
// No atomics: every sum runs in a fixed order, so reruns are
// bit-identical.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16 threads: ty = tid / 16
constexpr int kFwdRows = 64;      // query rows of an Lf block
constexpr int kKeys = 32;         // keys of a tile (Lf, Ldq), of a Ldkv block
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

// ---------------------------------------------------------------------------
// Ldkv and Ldq: 3xTF32 mma.sync on tiles streamed by cp.async
// ---------------------------------------------------------------------------

constexpr int kTile = 32;   // keys of an Ldkv block, rows of an Ldq block,
                            // and the rows of every streamed tile
constexpr int kWarps = kThreads / 32;

// Tiles of ld floats a row (ld a multiple of 32) keep element (r, c) at
// r * ld + (c ^ swz(r)): bits 2-4 of the column are flipped by rows mod 8,
// so 8 rows x 4 columns and 4 rows x 8 columns each fall in 32 banks.
// Groups of 4 columns stay together, for 16-byte copies.
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }

__device__ __forceinline__ int at(int r, int c, int ld) {
  return r * ld + (c ^ swz(r));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of rows r0 .. r0 + 31 of src (row stride sl) into the
// swizzled tile dst (DP floats a row), zeros past row L or column d. With
// VEC, src's rows are 16-byte aligned and a thread copies 4 floats at once.
template <int DP, bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long sl, int r0, int L,
                                           int d) {
  constexpr int kChunks = DP / 4, kIters = kTile * kChunks / kThreads;
  if (VEC && d == DP && r0 + kTile <= L) {
    // a whole tile: thread i copies 4 floats at column 4 (i % kChunks) of
    // rows i / kChunks + it kThreads / kChunks
    constexpr int kStep = kThreads / kChunks;
    const int r = threadIdx.x / kChunks, c = (threadIdx.x % kChunks) * 4;
    const float* from = src + (r0 + r) * sl + c;
#pragma unroll
    for (int it = 0; it < kIters; ++it)
      cp_async16(dst + at(r + it * kStep, c, DP), from + it * kStep * sl, 16);
    return;
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = (i - r * kChunks) * 4;
    float* to = dst + at(r, c, DP);
    const bool in = r0 + r < L;
    const int n = in ? max(0, min(4, d - c)) : 0;
    const float* from = n ? src + (r0 + r) * sl + c : src;
    if (VEC) {
      cp_async16(to, from, 4 * n);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(to + e, e < n ? from + e : src, e < n ? 4 : 0);
    }
  }
}

// One row each of lse and di for rows r0 .. r0 + 31, zeros past L: threads
// 0-31 copy lse, 32-63 di.
__device__ __forceinline__ void stage_row_stats(float* ls, float* dis,
                                                const float* lse,
                                                const float* di, int r0,
                                                int L) {
  const int t = threadIdx.x & 31, r = r0 + t;
  const int bytes = r < L ? 4 : 0;
  const int off = r < L ? r : 0;
  if (threadIdx.x < 32) cp_async4(ls + t, lse + off, bytes);
  else if (threadIdx.x < 64) cp_async4(dis + t, di + off, bytes);
}

// x rounded to TF32's 10 mantissa bits, to nearest with ties away from
// zero (cvt.rna.tf32.f32's rounding, in two integer operations).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo: hi = x rounded to TF32, lo = x - hi (exact in f32), which
// the MMA reads as TF32 by dropping its low 13 bits. lo's rounding error is
// below 2^-21 |x|, well under the checks' 1e-4; rounding lo to nearest as
// well would cost two more operations for every element loaded.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// An m16n8k8 operand, split: A (16 x 8) in 4 registers a thread, B (8 x 8)
// in 2; lane = 4 g + c holds A(g, c), A(g + 8, c), A(g, c + 4),
// A(g + 8, c + 4) and B(c, g), B(c + 4, g).
struct FragA {
  unsigned hi[4], lo[4];
};
struct FragB {
  unsigned hi[2], lo[2];
};

// A lane's g and c, and the swizzle of its rows g (mod 8).
struct Lane {
  int g, c, xs;
};

__device__ __forceinline__ Lane lane_of() {
  const int l = threadIdx.x & 31;
  return Lane{l >> 2, l & 3, swz(l >> 2)};
}

// Fragment reads from swizzled tiles, at columns kc + 8 kk + ... with kc a
// multiple of 32 and rows m0 + ... with m0 a multiple of 8: the swizzle
// then only touches the part below 32, which is the same for every kc.
// A(m, k) = t(m0 + m, kc + 8 kk + k) of a [m][k] tile.
__device__ __forceinline__ void load_a(FragA& f, const float* t, int ld,
                                       int m0, int kc, int kk, Lane L) {
  const float* r = t + (m0 + L.g) * ld + kc;
  const int c0 = (8 * kk + L.c) ^ L.xs, c1 = (8 * kk + L.c + 4) ^ L.xs;
  split(r[c0], f.hi[0], f.lo[0]);
  split(r[8 * ld + c0], f.hi[1], f.lo[1]);
  split(r[c1], f.hi[2], f.lo[2]);
  split(r[8 * ld + c1], f.hi[3], f.lo[3]);
}

// B(k, n) = t(n0 + n, kc + 8 kk + k) of a [n][k] tile (B^T's rows).
__device__ __forceinline__ void load_b_nk(FragB& f, const float* t, int ld,
                                          int n0, int kc, int kk, Lane L) {
  const float* r = t + (n0 + L.g) * ld + kc;
  split(r[(8 * kk + L.c) ^ L.xs], f.hi[0], f.lo[0]);
  split(r[(8 * kk + L.c + 4) ^ L.xs], f.hi[1], f.lo[1]);
}

// B(k, n) = t(8 kk + k, n8 + n) of a [k][n] tile, n8 a multiple of 8: rows
// 8 kk + c and + 4 swizzle by 8 c and 8 c + 4.
__device__ __forceinline__ void load_b_kn(FragB& f, const float* t, int ld,
                                          int kk, int n8, Lane L) {
  const float* r = t + (8 * kk + L.c) * ld + (n8 & ~31);
  const int col = (n8 & 31) + L.g;
  split(r[col ^ (8 * L.c)], f.hi[0], f.lo[0]);
  split(r[4 * ld + (col ^ (8 * L.c + 4))], f.hi[1], f.lo[1]);
}

__device__ __forceinline__ void mma_tf32(float (&acc)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A B in 3xTF32: the small terms first, then hi.hi.
__device__ __forceinline__ void mma3(float (&acc)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(acc, a.lo, b.hi);
  mma_tf32(acc, a.hi, b.lo);
  mma_tf32(acc, a.hi, b.hi);
}

// A score tile (32 x 32) over the DP columns of two [32][DP] tiles (zeros
// past d):
// acc = A B^T for this warp's m16 x n16 fragment, rows m0.., columns
// n0 .. n0 + 15 (acc[j] the n8 block n0 + 8 j). The MMA's f32 sum rounds
// toward zero, so each 32 columns go to fresh accumulators, added to acc
// in f32 (round to nearest); the three terms of the split go to three, so
// that the MMAs of a step do not wait on each other.
template <int DP>
__device__ __forceinline__ void score_tile(float (&acc)[2][4], const float* a,
                                           const float* b, int m0, int n0,
                                           Lane L) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DP; kc += 32) {
    float hh[2][4] = {}, lh[2][4] = {}, hl[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragA fa;
      load_a(fa, a, DP, m0, kc, kk, L);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB fb;
        load_b_nk(fb, b, DP, n0 + 8 * j, kc, kk, L);
        mma_tf32(lh[j], fa.lo, fb.hi);
        mma_tf32(hl[j], fa.hi, fb.lo);
        mma_tf32(hh[j], fa.hi, fb.hi);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] += hh[j][e] + (lh[j][e] + hl[j][e]);
  }
}

// A warp takes the n8 blocks j = warp + 8 t, t < kBlocks<DP>, of a DP-wide
// gradient product: all of them at DP >= 64 (known at compile time), at
// DP = 32 only those with j < 4.
template <int DP>
constexpr int kBlocks = (DP / 8 + kWarps - 1) / kWarps;

template <int DP>
__device__ __forceinline__ bool owns(int j) {
  return DP / 8 == kWarps * kBlocks<DP> || j < DP / 8;
}

// A gradient product of one tile: acc[t][i] += A_i B over the tile's 32
// rows, A the swizzled 32 x 32 [m][k] tile and B the swizzled [k][n] tile
// (DP wide); this warp takes the n8 blocks w + 8 t, both m16 halves. The
// tile's sum is taken in fresh accumulators and added to acc in f32, so
// that the MMA's rounding toward zero does not pile up over the tiles.
template <int DP, int NT>
__device__ __forceinline__ void grad_tile(float (&acc)[NT][2][4],
                                          const float* a, const float* b,
                                          int warp, Lane L) {
  float part[NT][2][4] = {};
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    FragA fa[2];
    load_a(fa[0], a, kTile, 0, 0, kk, L);
    load_a(fa[1], a, kTile, 16, 0, kk, L);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (!owns<DP>(warp + kWarps * t)) continue;
      FragB fb;
      load_b_kn(fb, b, DP, kk, 8 * (warp + kWarps * t), L);
      mma3(part[t][0], fa[0], fb);
      mma3(part[t][1], fa[1], fb);
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][i][e] += part[t][i][e];
}

// Writes a warp's [32][DP] fragments of acc as rows r0 + m (m < 32, r0 + m
// < L) and columns < d of the contiguous (L, d) rows out.
template <int DP, int NT>
__device__ __forceinline__ void store_grad(const float (&acc)[NT][2][4],
                                           float* out, int r0, int L, int d,
                                           int warp, Lane ln) {
  const int g = ln.g, c = ln.c;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int j = warp + kWarps * t;
    if (!owns<DP>(j)) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 16 * i + g + (e >> 1) * 8;
        const int col = 8 * j + 2 * c + (e & 1);
        if (r < L && col < d) out[(size_t)r * d + col] = acc[t][i][e];
      }
  }
}

// Ldkv. Grid (ceil(Lk / 32), N * H), 256 threads.
template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tc(Rows q, Rows k, Rows v, Rows dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 float* __restrict__ dk, float* __restrict__ dv, int H,
                 int Lq, int Lk, int d, float scale) {
  constexpr int NT = kBlocks<DP>;
  constexpr int T = kTile * DP;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // k: [32][DP], resident
  float* vs = ks + T;                            // v: [32][DP], resident
  float* qst = vs + T;                           // q: 2 stages of [32][DP]
  float* dost = qst + 2 * T;                     // do: 2 stages
  float* pt = dost + 2 * T;                      // p^T: [32 keys][32 rows]
  float* dst = pt + kTile * kTile;               // dp^T, then ds^T
  float* lst = dst + kTile * kTile;              // lse: 2 stages of 32
  float* dist = lst + 2 * kTile;                 // di: 2 stages of 32
  const int warp = threadIdx.x >> 5;
  const Lane L = lane_of();
  const int bh = blockIdx.y, n = bh / H, h = bh - n * H;
  const int k0 = blockIdx.x * kTile;
  const float* qb = head_of(q, n, h);
  const float* dob = head_of(dout, n, h);
  const float* lb = lse + (size_t)bh * Lq;
  const float* db = di + (size_t)bh * Lq;
  stage_rows<DP, VEC>(ks, head_of(k, n, h), k.sl, k0, Lk, d);
  stage_rows<DP, VEC>(vs, head_of(v, n, h), v.sl, k0, Lk, d);
  stage_rows<DP, VEC>(qst, qb, q.sl, 0, Lq, d);
  stage_rows<DP, VEC>(dost, dob, dout.sl, 0, Lq, d);
  stage_row_stats(lst, dist, lb, db, 0, Lq);
  cp_async_commit();
  // warps 0-3: s^T = k q^T, warps 4-7: dp^T = v do^T; m16 x n16 each
  const bool is_dp = warp >= 4;
  const int m0 = (warp & 1) * 16, n0 = ((warp >> 1) & 1) * 16;
  float adk[NT][2][4] = {}, adv[NT][2][4] = {};
  for (int t = 0, q0 = 0; q0 < Lq; ++t, q0 += kTile) {
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    const int cur = t & 1, nxt = cur ^ 1;
    if (q0 + kTile < Lq) {
      stage_rows<DP, VEC>(qst + nxt * T, qb, q.sl, q0 + kTile, Lq, d);
      stage_rows<DP, VEC>(dost + nxt * T, dob, dout.sl, q0 + kTile, Lq, d);
      stage_row_stats(lst + nxt * kTile, dist + nxt * kTile, lb, db,
                      q0 + kTile, Lq);
      cp_async_commit();
    }
    const float* qs = qst + cur * T;
    const float* dos = dost + cur * T;
    const float* ls = lst + cur * kTile;
    const float* dis = dist + cur * kTile;
    float acc[2][4];
    score_tile<DP>(acc, is_dp ? vs : ks, is_dp ? dos : qs, m0, n0, L);
    const int g = L.g, c = L.c;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = m0 + g + (e >> 1) * 8;
        const int row = n0 + 8 * j + 2 * c + (e & 1);
        if (is_dp) {
          dst[at(key, row, kTile)] = acc[j][e];
        } else {
          pt[at(key, row, kTile)] =
              q0 + row < Lq ? expf(acc[j][e] * scale - ls[row]) : 0.f;
        }
      }
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int row = (i & (kTile - 1)) ^ swz(i / kTile);
      dst[i] = pt[i] * (dst[i] - dis[row]) * scale;
    }
    __syncthreads();
    grad_tile<DP, NT>(adv, pt, dos, warp, L);  // dv += p^T do
    grad_tile<DP, NT>(adk, dst, qs, warp, L);  // dk += ds^T q
  }
  float* dkb = dk + (size_t)bh * Lk * d;
  float* dvb = dv + (size_t)bh * Lk * d;
  store_grad<DP, NT>(adk, dkb, k0, Lk, d, warp, L);
  store_grad<DP, NT>(adv, dvb, k0, Lk, d, warp, L);
}

// Ldq. Grid (ceil(Lq / 32), N * H), 256 threads.
template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc(Rows q, Rows k, Rows v, Rows dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                float* __restrict__ dq, int H, int Lq, int Lk, int d,
                float scale) {
  constexpr int NT = kBlocks<DP>;
  constexpr int T = kTile * DP;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // q: [32][DP], resident
  float* dos = qs + T;                           // do: [32][DP], resident
  float* kst = dos + T;                          // k: 2 stages of [32][DP]
  float* vst = kst + 2 * T;                      // v: 2 stages
  float* ps = vst + 2 * T;                       // p: [32 rows][32 keys]
  float* dss = ps + kTile * kTile;               // dp, then ds
  float* ls = dss + kTile * kTile;               // lse of the block's rows
  float* dis = ls + kTile;                       // di of the block's rows
  const int warp = threadIdx.x >> 5;
  const Lane L = lane_of();
  const int bh = blockIdx.y, n = bh / H, h = bh - n * H;
  const int q0 = blockIdx.x * kTile;
  const float* kb = head_of(k, n, h);
  const float* vb = head_of(v, n, h);
  stage_rows<DP, VEC>(qs, head_of(q, n, h), q.sl, q0, Lq, d);
  stage_rows<DP, VEC>(dos, head_of(dout, n, h), dout.sl, q0, Lq, d);
  stage_row_stats(ls, dis, lse + (size_t)bh * Lq, di + (size_t)bh * Lq, q0,
                  Lq);
  stage_rows<DP, VEC>(kst, kb, k.sl, 0, Lk, d);
  stage_rows<DP, VEC>(vst, vb, v.sl, 0, Lk, d);
  cp_async_commit();
  // warps 0-3: s = q k^T, warps 4-7: dp = do v^T; m16 x n16 each
  const bool is_dp = warp >= 4;
  const int m0 = (warp & 1) * 16, n0 = ((warp >> 1) & 1) * 16;
  float adq[NT][2][4] = {};
  for (int t = 0, k0 = 0; k0 < Lk; ++t, k0 += kTile) {
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    const int cur = t & 1, nxt = cur ^ 1;
    if (k0 + kTile < Lk) {
      stage_rows<DP, VEC>(kst + nxt * T, kb, k.sl, k0 + kTile, Lk, d);
      stage_rows<DP, VEC>(vst + nxt * T, vb, v.sl, k0 + kTile, Lk, d);
      cp_async_commit();
    }
    const float* ks = kst + cur * T;
    const float* vs = vst + cur * T;
    float acc[2][4];
    score_tile<DP>(acc, is_dp ? dos : qs, is_dp ? vs : ks, m0, n0, L);
    const int g = L.g, c = L.c;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + g + (e >> 1) * 8;
        const int key = n0 + 8 * j + 2 * c + (e & 1);
        if (is_dp) {
          dss[at(row, key, kTile)] = acc[j][e];
        } else {
          ps[at(row, key, kTile)] =
              k0 + key < Lk ? expf(acc[j][e] * scale - ls[row]) : 0.f;
        }
      }
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads)
      dss[i] = ps[i] * (dss[i] - dis[i / kTile]) * scale;
    __syncthreads();
    grad_tile<DP, NT>(adq, dss, ks, warp, L);  // dq += ds k
  }
  store_grad<DP, NT>(adq, dq + (size_t)bh * Lq * d, q0, Lq, d, warp, L);
}

size_t fwd_smem(int DP) {
  return sizeof(float) * (kFwdRows * (DP + 1) + DP * kPad + kFwdRows * kPad);
}

// Ldkv's and Ldq's shared memory: two resident [32][DP] tiles, two stages
// of two streamed ones, the two 32 x 32 score tiles and 64 or 128 floats of
// lse and di (205 KB at DP = 256).
size_t dkv_smem(int DP) {
  return sizeof(float) *
         (6 * kTile * DP + 2 * kTile * kTile + 4 * kTile);
}

size_t dq_smem(int DP) {
  return sizeof(float) *
         (6 * kTile * DP + 2 * kTile * kTile + 2 * kTile);
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

// The backward's padded head width for d: 32, 64, 128 or 256 (the swizzle
// needs rows of at least 32 floats).
int dp_for(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// Whether every (N, H, L) row of t starts on 16 bytes, for 16-byte copies.
bool aligned16(const Rows& t) {
  return reinterpret_cast<unsigned long long>(t.p) % 16 == 0 &&
         t.sn % 4 == 0 && t.sh % 4 == 0 && t.sl % 4 == 0;
}

template <int DP, bool VEC>
int dkv_launch(Rows q, Rows k, Rows v, Rows dout, const float* lse,
               const float* di, float* dk, float* dv, int N, int H, int Lq,
               int Lk, int d, float scale, cudaStream_t s) {
  const size_t bytes = dkv_smem(DP);
  const int err = allow_smem(flash_bwd_dkv_tc<DP, VEC>, bytes);
  if (err) return err;
  const dim3 grid((Lk + kTile - 1) / kTile, N * H);
  flash_bwd_dkv_tc<DP, VEC><<<grid, kThreads, bytes, s>>>(
      q, k, v, dout, lse, di, dk, dv, H, Lq, Lk, d, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int dkv(Rows q, Rows k, Rows v, Rows dout, const float* lse, const float* di,
        float* dk, float* dv, int N, int H, int Lq, int Lk, int d,
        float scale, cudaStream_t s) {
  return aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)
             ? dkv_launch<DP, true>(q, k, v, dout, lse, di, dk, dv, N, H, Lq,
                                    Lk, d, scale, s)
             : dkv_launch<DP, false>(q, k, v, dout, lse, di, dk, dv, N, H,
                                     Lq, Lk, d, scale, s);
}

template <int DP, bool VEC>
int dq_launch(Rows q, Rows k, Rows v, Rows dout, const float* lse,
              const float* di, float* dqp, int N, int H, int Lq, int Lk,
              int d, float scale, cudaStream_t s) {
  const size_t bytes = dq_smem(DP);
  const int err = allow_smem(flash_bwd_dq_tc<DP, VEC>, bytes);
  if (err) return err;
  const dim3 grid((Lq + kTile - 1) / kTile, N * H);
  flash_bwd_dq_tc<DP, VEC><<<grid, kThreads, bytes, s>>>(
      q, k, v, dout, lse, di, dqp, H, Lq, Lk, d, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int dq(Rows q, Rows k, Rows v, Rows dout, const float* lse, const float* di,
       float* dqp, int N, int H, int Lq, int Lk, int d, float scale,
       cudaStream_t s) {
  return aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)
             ? dq_launch<DP, true>(q, k, v, dout, lse, di, dqp, N, H, Lq, Lk,
                                   d, scale, s)
             : dq_launch<DP, false>(q, k, v, dout, lse, di, dqp, N, H, Lq,
                                    Lk, d, scale, s);
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

#define STC_FA_BWD_DISPATCH(call) \
  switch (dp_for(d)) {            \
    case 32: return call(32);     \
    case 64: return call(64);     \
    case 128: return call(128);   \
    case 256: return call(256);   \
  }                               \
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
#define STC_FA_DKV(width) \
  dkv<width>(rq, rk, rv, rd, lp, dp, dkp, dvp, N, H, Lq, Lk, d, scale, s)
  STC_FA_BWD_DISPATCH(STC_FA_DKV)
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
#define STC_FA_DQ(width) \
  dq<width>(rq, rk, rv, rd, lp, dp, dqp, N, H, Lq, Lk, d, scale, s)
  STC_FA_BWD_DISPATCH(STC_FA_DQ)
#undef STC_FA_DQ
}

}  // extern "C"
