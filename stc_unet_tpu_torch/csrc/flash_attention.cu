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
// length: the TPU's multiple-of-128 blocks are a tiling of the library,
// not part of the function. Every launch is a 1-D grid of N * H * (row
// tiles) blocks, the tiles of one (n, h) next to each other (so that the
// blocks running together share their streamed rows in L2), up to 2^31 - 1.
//
// What bounds them on an H100 SXM. The STC transformer has 2 heads of d =
// 256. Lf runs 2 products a key tile (s, then p v), Ldkv 4 (s, dp, dv, dk),
// Ldq 3 (s, dp, dq): at whole B=8 (x4: L = 4096, x5: L = 1024, 4 layers
// each) 1.17e12 flop per forward, and 2.34e12 and 1.75e12 per train step.
// Each product is done in 3xTF32 (below), three TF32 products per f32
// product, at the 495 TFLOP/s TF32 tensor-core rate: 7.1, 14.2 and 10.6 ms.
// That is their bound; the exponentials (each kernel takes p, 1.1e9 a step
// at 16 per SM per clock) take about 0.3 ms, and their bytes about 0.1 to
// 0.5 ms.
//
// Why 3xTF32 and not TF32. TF32 keeps 10 mantissa bits. The kernels are
// held to f32 (rtol 1e-4, atol 1e-5 of the largest value) and so is the
// JAX reference; one TF32 product of ds k over 1024 keys misses that by
// about 20x, while the split lands within a few per cent of it, as plain
// f32 does (tests/test_torch_flash_attention.py emulates both). Each
// operand x is split as it is loaded from shared memory into hi = tf32(x)
// (to nearest) and lo = x - hi, and a product is lo.hi + hi.lo + hi.hi
// (CUTLASS's OpMultiplyAddFastF32). The split never depends on torch's
// TF32 flags. The MMA's own f32 sum rounds toward zero; over 4096 rows or
// keys one chain of them (about 1500 sums, each off by up to 2^-24 of the
// total, all the same way) drifts to about 1e-4, so every 32 columns
// (scores), 32 rows (gradients) or 32 keys (o) are summed in fresh
// accumulators and then added in f32.
//
// Every product is mma.sync m16n8k8 row.col on tiles in shared memory.
// Tiles are stored with an XOR swizzle of the column's bits 2-4 by the
// row, so that both the row-fragment reads (8 rows x 4 columns a warp) and
// the column-fragment reads (4 rows x 8 columns) hit 32 banks; d is padded
// with zeros to DP in {32, 64, 128, 256}, over which the products run.
// Streamed tiles of 32 rows go through a two-stage ring by cp.async (16
// bytes a thread where the rows are 16-byte aligned, else 4; zero-filled
// past L and d), so the next tile is in flight while this one is
// multiplied. Blocks have 8 warps; at DP = 256 a block takes 200 to 205 KB
// of shared memory, so an SM holds one, two warps a scheduler, and up to
// 255 registers a thread; ptxas must report no spills (chip_smoke.py's
// build line). It gives Lf and Ldkv 255 registers at DP = 256 and Ldq 236
// to 255 (113 to 221 at the narrower widths), and no spills.
//
// Lf's design. A block owns 64 query rows of one (n, h), kept in shared
// memory, and walks the keys in tiles of 32 (k and v through the ring).
// Warp w takes rows 16 (w / 2) .. + 15 and half w % 2: the 16 keys of
// that half of each score tile, and the DP / 2 columns of that half of o.
// Per tile: s = q k^T (an m16 x n16 fragment over DP, score_tile), the
// scale and the mask past Lk; the row max of each warp's 16 keys goes
// through shared memory to the other warp of the pair, so both take the
// same m_new and alpha = exp(m_old - m_new); p = exp(s - m_new) is staged
// in shared memory (64 x 32) as the A operand of p v; each warp keeps its
// own half's row sum l = l alpha + sum p, and the two halves are added
// once at the end. Each warp holds its 16 x DP/2 slice of o in registers
// (64 at DP = 256) and, for each 8 columns of it, sums the tile's p v in a
// fresh accumulator and then takes o = o alpha + part in f32 FMAs. It
// writes o / l and lse = m + log l. 200.5 KB of shared memory at DP = 256:
// q 64 KB, the k and v rings 128 KB, p 8 KB, the row exchange 0.5 KB.
//
// Ldkv and Ldq. A block owns a tile of 32 keys (Ldkv) or 32 query rows
// (Ldq), kept in shared memory (k and v, or q and do), and walks the other
// side in tiles of 32 through the ring. The score products s (k q^T in
// Ldkv, q k^T in Ldq) and dp take q, k, v and do as stored rows, warps 0-3
// computing s and warps 4-7 dp, each an m16 x n16 fragment over d. p =
// exp(s - lse) and ds = p (dp - di) scale are staged in shared memory (32
// x 32 each) as the A operand of the gradient products, dv += p^T do and
// dk += ds^T q, or dq += ds k, which read do, q or k as [k][n] tiles. Each
// warp accumulates those over 32 rows and every eighth column block of 8
// in registers. 205 KB of shared memory at DP = 256.
//
// No atomics: every sum runs in a fixed order, so reruns are
// bit-identical. Every entry point launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // keys of an Ldkv block, rows of an Ldq block,
                            // and the rows of every streamed tile
constexpr int kFwdRows = 64;      // query rows of an Lf block

// One (N, H, L, d) input: its data and the element strides of N, H and L.
struct Rows {
  const float* p;
  long long sn, sh, sl;
};

__device__ __forceinline__ const float* head_of(const Rows& t, int n, int h) {
  return t.p + n * t.sn + h * t.sh;
}

// ---------------------------------------------------------------------------
// 3xTF32 mma.sync on tiles streamed by cp.async
// ---------------------------------------------------------------------------

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

// Lf. Grid N * H * ceil(Lq / 64), 256 threads.
template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(Rows q, Rows k, Rows v, float* __restrict__ o,
             float* __restrict__ lse, int H, int Lq, int Lk, int d,
             float scale) {
  constexpr int T = kTile * DP;
  constexpr int NB = DP / 16;  // n8 blocks of this warp's half of o
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // q: [64][DP], resident
  float* kst = qs + 2 * T;                       // k: 2 stages of [32][DP]
  float* vst = kst + 2 * T;                      // v: 2 stages
  float* ps = vst + 2 * T;                       // p: [64 rows][32 keys]
  float* red = ps + kFwdRows * kTile;            // [half][row]: max, then l
  const int warp = threadIdx.x >> 5;
  const Lane L = lane_of();
  const int tiles = (Lq + kFwdRows - 1) / kFwdRows;
  const int bh = blockIdx.x / tiles, n = bh / H, h = bh - n * H;
  const int q0 = (blockIdx.x - bh * tiles) * kFwdRows;
  const float* qb = head_of(q, n, h);
  const float* kb = head_of(k, n, h);
  const float* vb = head_of(v, n, h);
  stage_rows<DP, VEC>(qs, qb, q.sl, q0, Lq, d);
  stage_rows<DP, VEC>(qs + T, qb, q.sl, q0 + kTile, Lq, d);
  stage_rows<DP, VEC>(kst, kb, k.sl, 0, Lk, d);
  stage_rows<DP, VEC>(vst, vb, v.sl, 0, Lk, d);
  cp_async_commit();
  // this warp: rows m0 + g and m0 + g + 8 (i = 0, 1) of the block; keys
  // n0 .. n0 + 15 of each tile; columns c0 .. c0 + DP/2 - 1 of o
  const int half = warp & 1;
  const int m0 = (warp >> 1) * 16, n0 = 16 * half, c0 = half * (DP / 2);
  float acc[NB][4] = {};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int t = 0, k0 = 0; k0 < Lk; ++t, k0 += kTile) {
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    const int cur = t & 1, nxt = cur ^ 1;
    const int k1 = k0 + kTile;
    if (k1 < Lk) {
      stage_rows<DP, VEC>(kst + nxt * T, kb, k.sl, k1, Lk, d);
      stage_rows<DP, VEC>(vst + nxt * T, vb, v.sl, k1, Lk, d);
      cp_async_commit();
    }
    const float* ks = kst + cur * T;
    const float* vs = vst + cur * T;
    float s[2][4];
    score_tile<DP>(s, qs, ks, m0, n0, L);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n0 + 8 * j + 2 * L.c + (e & 1);
        s[j][e] = key < Lk ? s[j][e] * scale : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    // the max over the 4 lanes of a row, then over the pair of warps; key
    // k0 < Lk is in every tile, so m_new is finite, and on the first tile
    // m = -inf gives alpha = 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if (L.c == 0) red[half * kFwdRows + m0 + L.g + 8 * i] = mx[i];
    }
    __syncthreads();
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + L.g + 8 * i;
      const float m_new = fmaxf(m[i], fmaxf(red[r], red[kFwdRows + r]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = expf(s[j][e] - m[i]);
        ps[at(m0 + L.g + 8 * i, n0 + 8 * j + 2 * L.c + (e & 1), kTile)] = p;
        sum[i] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
    __syncthreads();  // p is in
    // o = o alpha + p v: p (16 rows x 32 keys) as A, v as [k][n] tiles
    FragA fp[kTile / 8];
#pragma unroll
    for (int kk = 0; kk < kTile / 8; ++kk)
      load_a(fp[kk], ps, kTile, m0, 0, kk, L);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float part[4] = {};
#pragma unroll
      for (int kk = 0; kk < kTile / 8; ++kk) {
        FragB fb;
        load_b_kn(fb, vs, DP, kk, c0 + 8 * b, L);
        mma3(part, fp[kk], fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[b][e] = fmaf(acc[b][e], alpha[e >> 1], part[e]);
    }
  }
  // l: this warp's half plus the other's, in a fixed order
  __syncthreads();  // every warp is done with the last tile's row maxes
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (L.c == 0) red[half * kFwdRows + m0 + L.g + 8 * i] = l[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rb = m0 + L.g + 8 * i, r = q0 + rb;
    if (r >= Lq) continue;
    const float total = red[rb] + red[kFwdRows + rb];
    float* orow = o + ((size_t)bh * Lq + r) * d;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        const int col = c0 + 8 * b + 2 * L.c + (e & 1);
        if (col < d) orow[col] = acc[b][e] / total;
      }
    if (half == 0 && L.c == 0)
      lse[(size_t)bh * Lq + r] = m[i] + logf(total);
  }
}

// Ldkv. Grid N * H * ceil(Lk / 32), 256 threads.
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
  const int tiles = (Lk + kTile - 1) / kTile;
  const int bh = blockIdx.x / tiles, n = bh / H, h = bh - n * H;
  const int k0 = (blockIdx.x - bh * tiles) * kTile;
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

// Ldq. Grid N * H * ceil(Lq / 32), 256 threads.
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
  const int tiles = (Lq + kTile - 1) / kTile;
  const int bh = blockIdx.x / tiles, n = bh / H, h = bh - n * H;
  const int q0 = (blockIdx.x - bh * tiles) * kTile;
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

// Lf's shared memory: q, two stages of k and of v, p and the row exchange
// (200.5 KB at DP = 256).
size_t fwd_smem(int DP) {
  return sizeof(float) *
         (6 * kTile * DP + kFwdRows * kTile + 2 * kFwdRows);
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

// The padded head width for d: 32, 64, 128 or 256 (the swizzle needs rows
// of at least 32 floats).
int dp_for(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// The grids hold N * H * (tiles of 32 rows, at most) blocks, up to 2^31 - 1.
bool bad_shape(int N, int H, int Lq, int Lk, int d) {
  return N < 1 || H < 1 || Lq < 1 || Lk < 1 || d < 1 || d > 256 ||
         (long long)N * H * ((max(Lq, Lk) + kTile - 1) / kTile) > INT_MAX;
}

// Whether every (N, H, L) row of t starts on 16 bytes, for 16-byte copies.
bool aligned16(const Rows& t) {
  return reinterpret_cast<unsigned long long>(t.p) % 16 == 0 &&
         t.sn % 4 == 0 && t.sh % 4 == 0 && t.sl % 4 == 0;
}

// One launch of 256 threads with `bytes` of dynamic shared memory, allowed
// first (above 48 KB it must be).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), size_t bytes, dim3 grid,
           cudaStream_t s, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

#define STC_FA_DISPATCH(call) \
  switch (dp_for(d)) {        \
    case 32: return call(32);   \
    case 64: return call(64);   \
    case 128: return call(128); \
    case 256: return call(256); \
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
  const bool vec = aligned16(rq) && aligned16(rk) && aligned16(rv);
  const dim3 grid(N * H * ((Lq + kFwdRows - 1) / kFwdRows));
#define STC_FA_FWD(dp)                                                     \
  launch(vec ? flash_fwd_tc<dp, true> : flash_fwd_tc<dp, false>,           \
         fwd_smem(dp), grid, s, rq, rk, rv, op, lp, H, Lq, Lk, d, scale)
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
  const bool vec =
      aligned16(rq) && aligned16(rk) && aligned16(rv) && aligned16(rd);
  const dim3 grid(N * H * ((Lk + kTile - 1) / kTile));
#define STC_FA_DKV(width)                                                    \
  launch(vec ? flash_bwd_dkv_tc<width, true> : flash_bwd_dkv_tc<width, false>, \
         dkv_smem(width), grid, s, rq, rk, rv, rd, lp, dp, dkp, dvp, H, Lq,  \
         Lk, d, scale)
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
  const bool vec =
      aligned16(rq) && aligned16(rk) && aligned16(rv) && aligned16(rd);
  const dim3 grid(N * H * ((Lq + kTile - 1) / kTile));
#define STC_FA_DQ(width)                                                     \
  launch(vec ? flash_bwd_dq_tc<width, true> : flash_bwd_dq_tc<width, false>,  \
         dq_smem(width), grid, s, rq, rk, rv, rd, lp, dp, dqp, H, Lq, Lk, d, \
         scale)
  STC_FA_DISPATCH(STC_FA_DQ)
#undef STC_FA_DQ
}

}  // extern "C"
