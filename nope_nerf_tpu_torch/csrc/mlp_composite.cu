// Kernel A of the port: NeRF MLP + alpha compositing, forward and backward.
//
// Replaces the Pallas kernels of nope_nerf_tpu/ops/pallas/mlp_kernel.py:
//   forward  _make_fwd_composite_kernel (l.668), reached from
//            fused_mlp_composite -> _fused_mlp_composite_call (l.852);
//   backward _make_bwd_composite_kernel (l.702), reached from
//            _fused_mlp_composite_bwd (l.909).
//
// What bounds it on the H100: the trunk is ten (M x K) @ (K x N) products
// at M = rays * samples = 131,072 points and K, N <= 319 -- about 0.2 TFLOP
// for forward + backward, which the bf16 tensor cores finish in well under a
// millisecond at peak. The rest (encoding, heads, compositing, the encoding
// backward) is memory- and latency-bound elementwise work on per-point and
// per-ray tensors.
//
// Design (first, simple and correct; wgmma/TMA and cross-layer fusion are
// later work): the TPU kernel kept every activation in VMEM and recomputed
// the forward inside the backward. A block on this card has at most 227 KB of
// shared memory, which does not hold the 1.2 MB of weights, so each layer is
// its own tiled GEMM launch and the forward SAVES its bf16 activations
// (about 0.7 GB at the stock step) for the backward instead of recomputing.
//   * encode_points / encode_rows: pts = o + r*z, [x, sin 2^l x, cos 2^l x]
//     in f32 (full-precision sincosf), stored as bf16; directions encoded
//     once per ray.
//   * gemm_nn: C = epilogue(A1 @ B1 + A2 @ B2), bf16 x bf16 -> f32 on the
//     tensor cores (WMMA 16x16x16). Two A inputs so the skip concats
//     [h, enc] and [feat, denc] are never materialised; A2 may be indexed per
//     ray (row / S). Epilogue: + bias (f32), optional ReLU, optional ReLU
//     mask of a saved activation (backward), store bf16 or f32.
//   * gemm_tn: dW = X^T @ G as split-K partial sums over row chunks, then a
//     deterministic reduce pass (no float atomics, so runs repeat bitwise);
//     colsum does the same for the bias gradients.
//   * heads / composite: density and rgb heads (f32 raw outputs), head
//     activations, and the compositing scan one thread per ray, sequential
//     over the samples. The TPU layout tricks (selector matmuls, log-space
//     cumprod, triangular-matmul suffix sums) become plain loops.
//   * encode_bwd: one warp per ray; the encoding backward and the ray sums
//     that give d_origins, d_rays and d_dirs.
// Numerics follow the TPU kernel: bf16 operands, f32 accumulation, f32
// biases, activations rounded to bf16 after the epilogue, raw heads in f32,
// stable softplus, eps 1e-6 in the transmittance product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_bf16(float v) { return f32(to_bf16(v)); }

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(bf16* p, float v) { *p = to_bf16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// ---------------------------------------------------------------------------
// Positional encoding, forward.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void encode_one(const float p[3], int levels, bf16* out) {
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = to_bf16(p[c]);
  for (int l = 0; l < levels; ++l) {
    const float f = ldexpf(1.f, l);  // exact power of two
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s, co;
      sincosf(p[c] * f, &s, &co);
      out[3 * (1 + 2 * l) + c] = to_bf16(s);
      out[3 * (2 + 2 * l) + c] = to_bf16(co);
    }
  }
}

__global__ void encode_points_kernel(const float* __restrict__ o, const float* __restrict__ r,
                                     const float* __restrict__ z, bf16* __restrict__ enc,
                                     int ld, int n_rays, int n_samples, int levels) {
  const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (int64_t)n_rays * n_samples) return;
  const int64_t ray = m / n_samples;
  const float zz = z[m];
  float p[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = o[ray * 3 + c] + r[ray * 3 + c] * zz;
  encode_one(p, levels, enc + m * ld);
}

__global__ void encode_rows_kernel(const float* __restrict__ x, bf16* __restrict__ enc, int ld,
                                   int rows, int levels) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float p[3] = {x[i * 3], x[i * 3 + 1], x[i * 3 + 2]};
  encode_one(p, levels, enc + i * ld);
}

// ---------------------------------------------------------------------------
// Tiles for the GEMMs. A thread copies 8 consecutive elements of a row (one
// "chunk") global -> registers -> shared memory as bf16: one 16-byte load
// (two for f32) where the operand's base and row stride allow it, scalar
// loads with zero fill at ragged edges. The next tile's chunks are loaded
// into registers while the tensor cores work on the current tile.
// ---------------------------------------------------------------------------

constexpr int G_THREADS = 256;           // 8 warps
constexpr int G_BM = 128, G_BN = 128;    // output tile
constexpr int G_BK = 32;                 // reduction step
constexpr int G_ALD = G_BK + 8;          // bf16; rows stay 16-byte aligned and
constexpr int G_BLD = G_BN + 8;          //   fragments 32-byte aligned

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

template <typename T>
__device__ __forceinline__ bool vec_ok(const T* p, int ld) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         ld % (16 / static_cast<int>(sizeof(T))) == 0;
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(to_bf16(v));
}
__device__ __forceinline__ unsigned short bf16_bits(bf16 v) { return __bfloat16_as_ushort(v); }

// src[0 .. valid) of one row (valid in 0..8) as 8 bf16 in a uint4; the rest 0.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* src, int valid, bool vec) {
  union {
    uint4 u;
    unsigned short h[8];
  } out;
  if (vec && valid == 8) {
    if constexpr (sizeof(T) == 2) {
      out.u = *reinterpret_cast<const uint4*>(src);
    } else {
      const float4 a = *reinterpret_cast<const float4*>(src);
      const float4 b = *reinterpret_cast<const float4*>(src + 4);
      out.h[0] = bf16_bits(a.x); out.h[1] = bf16_bits(a.y);
      out.h[2] = bf16_bits(a.z); out.h[3] = bf16_bits(a.w);
      out.h[4] = bf16_bits(b.x); out.h[5] = bf16_bits(b.y);
      out.h[6] = bf16_bits(b.z); out.h[7] = bf16_bits(b.w);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) out.h[e] = e < valid ? bf16_bits(src[e]) : 0;
  }
  return out.u;
}

__device__ __forceinline__ int chunk_valid(bool row_ok, int limit, int col) {
  return row_ok ? max(0, min(8, limit - col)) : 0;
}

// Epilogue of one 16x16 accumulator fragment through a per-warp staging
// tile: each lane handles 8 consecutive columns of one row.
template <typename Fn>
__device__ __forceinline__ void frag_epilogue(const AccFrag& acc, float* stage, int row, int col,
                                              Fn fn) {
  wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) fn(row + r, col + c0 + e, stage[r * 16 + c0 + e]);
  __syncwarp();
}

// ---------------------------------------------------------------------------
// GEMM C = epilogue(A1 @ B1 + A2 @ B2). A row-major (any ld; A2 may be
// indexed per ray, row / a2_div), B row-major bf16 (K x n, ld), bf16 WMMA
// fragments, f32 accumulators. Block tile 128 x 128, 8 warps as 2 x 4, each
// warp 64 x 32. Epilogue: + bias (f32), optional ReLU, optional ReLU mask of
// a saved activation (backward), store bf16 or f32.
// ---------------------------------------------------------------------------

struct GemmNN {
  const void* a1; int lda1; int k1;
  const void* a2; int lda2; int k2; int a2_div;
  const bf16* b1; int ldb1;
  const bf16* b2; int ldb2;
  const float* bias; int relu;
  const bf16* mask; int ldm; int mask_cols;
  void* c; int ldc;
  int m, n;
};

template <typename TA1, typename TA2>
__device__ __forceinline__ void nn_load(const GemmNN& p, int kt, int kt1, int row0, int col0,
                                        bool va1, bool va2, bool vb1, bool vb2, uint4 (&sa)[2],
                                        uint4 (&sb)[2]) {
  const bool second = kt >= kt1;
  const int kbase = (second ? kt - kt1 : kt) * G_BK;
  const int K = second ? p.k2 : p.k1;
  const bf16* B = second ? p.b2 : p.b1;
  const int ldb = second ? p.ldb2 : p.ldb1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * G_THREADS;
    const int r = c >> 2, gk = kbase + ((c & 3) << 3);  // 4 chunks per A row
    const int gr = row0 + r;
    const int va = chunk_valid(gr < p.m, K, gk);
    if (second)
      sa[i] = load_chunk(static_cast<const TA2*>(p.a2) + (int64_t)(gr / p.a2_div) * p.lda2 + gk,
                         va, va2);
    else
      sa[i] = load_chunk(static_cast<const TA1*>(p.a1) + (int64_t)gr * p.lda1 + gk, va, va1);
    const int gkb = kbase + (c >> 4), gc = col0 + ((c & 15) << 3);  // 16 chunks per B row
    sb[i] = load_chunk(B + (int64_t)gkb * ldb + gc, chunk_valid(gkb < K, p.n, gc),
                       second ? vb2 : vb1);
  }
}

__device__ __forceinline__ void nn_store(bf16* As, bf16* Bs, const uint4 (&sa)[2],
                                         const uint4 (&sb)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * G_THREADS;
    *reinterpret_cast<uint4*>(As + (c >> 2) * G_ALD + ((c & 3) << 3)) = sa[i];
    *reinterpret_cast<uint4*>(Bs + (c >> 4) * G_BLD + ((c & 15) << 3)) = sb[i];
  }
}

template <typename TA1, typename TA2, typename TC>
__global__ void __launch_bounds__(G_THREADS) gemm_nn_kernel(GemmNN p) {
  __shared__ __align__(128) bf16 As[G_BM * G_ALD];
  __shared__ __align__(128) bf16 Bs[G_BK * G_BLD];
  __shared__ __align__(128) float stage[G_THREADS / 32][256];

  const int row0 = blockIdx.x * G_BM, col0 = blockIdx.y * G_BN;
  const int warp = threadIdx.x >> 5, wr = warp >> 2, wc = warp & 3;
  const bool va1 = vec_ok(static_cast<const TA1*>(p.a1), p.lda1);
  const bool va2 = vec_ok(static_cast<const TA2*>(p.a2), p.lda2);
  const bool vb1 = vec_ok(p.b1, p.ldb1), vb2 = vec_ok(p.b2, p.ldb2);

  AccFrag acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int kt1 = (p.k1 + G_BK - 1) / G_BK;
  const int kts = kt1 + (p.a2 ? (p.k2 + G_BK - 1) / G_BK : 0);
  uint4 sa[2], sb[2];
  nn_load<TA1, TA2>(p, 0, kt1, row0, col0, va1, va2, vb1, vb2, sa, sb);
  nn_store(As, Bs, sa, sb);
  __syncthreads();
  for (int kt = 0; kt < kts; ++kt) {
    if (kt + 1 < kts) nn_load<TA1, TA2>(p, kt + 1, kt1, row0, col0, va1, va2, vb1, vb2, sa, sb);
#pragma unroll
    for (int ks = 0; ks < G_BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + (wr * 64 + i * 16) * G_ALD + ks, G_ALD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + ks * G_BLD + wc * 32 + j * 16, G_BLD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (kt + 1 < kts) {
      nn_store(As, Bs, sa, sb);
      __syncthreads();
    }
  }

  TC* C = static_cast<TC*>(p.c);
  const auto store = [&](int gr, int gc, float v) {
    if (gr >= p.m || gc >= p.n) return;
    if (p.bias) v += p.bias[gc];
    if (p.relu) v = fmaxf(v, 0.f);
    if (p.mask && gc < p.mask_cols && !(f32(p.mask[(int64_t)gr * p.ldm + gc]) > 0.f)) v = 0.f;
    store_val(C + (int64_t)gr * p.ldc + gc, v);
  };
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      frag_epilogue(acc[i][j], stage[warp], row0 + wr * 64 + i * 16, col0 + wc * 32 + j * 16,
                    store);
}

// ---------------------------------------------------------------------------
// Weight-gradient GEMM: partial[split] = X[rows of split]^T @ G[rows of split]
// with X = [X1 | X2] (bf16; X2 may be indexed per ray, row / x2_div) and G
// f32 (rounded to bf16 on load, as the TPU kernel's dW operands). Output
// tile 128 (X columns) x 128 (G columns), 32 rows per step, 8 warps as
// 2 x 4. The splits are summed by reduce_splits in a fixed order.
// ---------------------------------------------------------------------------

struct GemmTN {
  const bf16* x1; int ldx1; int k1;
  const bf16* x2; int ldx2; int k2; int x2_div;
  const float* g; int ldg; int n;
  int m; int rows_per_split;
  float* partial;
};

__device__ __forceinline__ uint4 x_chunk(const GemmTN& p, int gm, int gi, bool vx1, bool vx2) {
  const int K = p.k1 + p.k2;
  if (gi + 8 <= p.k1) return load_chunk(p.x1 + (int64_t)gm * p.ldx1 + gi, 8, vx1);
  const int64_t row2 = (int64_t)(gm / p.x2_div) * p.ldx2;
  if (gi >= p.k1) return load_chunk(p.x2 + row2 + (gi - p.k1), min(8, K - gi), vx2);
  union {  // the chunk straddles the X1 | X2 boundary
    uint4 u;
    unsigned short h[8];
  } out;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int col = gi + e;
    out.h[e] = col < p.k1  ? bf16_bits(p.x1[(int64_t)gm * p.ldx1 + col])
               : col < K ? bf16_bits(p.x2[row2 + (col - p.k1)])
                         : 0;
  }
  return out.u;
}

__global__ void __launch_bounds__(G_THREADS) gemm_tn_kernel(GemmTN p) {
  __shared__ __align__(128) bf16 Xs[G_BK * G_BLD];
  __shared__ __align__(128) bf16 Gs[G_BK * G_BLD];
  __shared__ __align__(128) float stage[G_THREADS / 32][256];

  const int K = p.k1 + p.k2;
  const int i0 = blockIdx.x * G_BM, j0 = blockIdx.y * G_BN, split = blockIdx.z;
  const int mbeg = split * p.rows_per_split;
  const int mend = min(p.m, mbeg + p.rows_per_split);
  const int warp = threadIdx.x >> 5, wi = warp >> 2, wj = warp & 3;
  const bool vx1 = vec_ok(p.x1, p.ldx1);
  const bool vx2 = vec_ok(p.x2, p.ldx2) && p.k1 % 8 == 0;
  const bool vg = vec_ok(p.g, p.ldg);

  AccFrag acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 sx[2], sg[2];
  const auto load = [&](int mb) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = threadIdx.x + t * G_THREADS;
      const int gm = mb + (c >> 4), col = (c & 15) << 3;  // 16 chunks per row
      const bool row_ok = gm < mend;
      sx[t] = row_ok && i0 + col < K ? x_chunk(p, gm, i0 + col, vx1, vx2) : make_uint4(0, 0, 0, 0);
      sg[t] = load_chunk(p.g + (int64_t)gm * p.ldg + j0 + col, chunk_valid(row_ok, p.n, j0 + col),
                         vg);
    }
  };
  const auto store = [&]() {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = threadIdx.x + t * G_THREADS;
      const int off = (c >> 4) * G_BLD + ((c & 15) << 3);
      *reinterpret_cast<uint4*>(Xs + off) = sx[t];
      *reinterpret_cast<uint4*>(Gs + off) = sg[t];
    }
  };

  load(mbeg);
  store();
  __syncthreads();
  for (int mb = mbeg; mb < mend; mb += G_BK) {
    const bool more = mb + G_BK < mend;
    if (more) load(mb + G_BK);
#pragma unroll
    for (int ks = 0; ks < G_BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], Xs + ks * G_BLD + wi * 64 + i * 16, G_BLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Gs + ks * G_BLD + wj * 32 + j * 16, G_BLD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  float* out = p.partial + (int64_t)split * K * p.n;
  const auto put = [&](int gi, int gj, float v) {
    if (gi < K && gj < p.n) out[(int64_t)gi * p.n + gj] = v;
  };
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      frag_epilogue(acc[i][j], stage[warp], i0 + wi * 64 + i * 16, j0 + wj * 32 + j * 16, put);
}

// Column sums of an f32 (m x n, ld) matrix, split over row chunks.
__global__ void colsum_kernel(const float* __restrict__ g, int ldg, int n, int m,
                              int rows_per_split, float* __restrict__ partial) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int split = blockIdx.y;
  if (col >= n) return;
  const int mbeg = split * rows_per_split;
  const int mend = min(m, mbeg + rows_per_split);
  float s = 0.f;
  for (int r = mbeg; r < mend; ++r) s += g[(int64_t)r * ldg + col];
  partial[(int64_t)split * n + col] = s;
}

// out[i] = sum over splits of partial[s][i], in split order.
__global__ void reduce_splits_kernel(const float* __restrict__ partial, int splits,
                                     int64_t size, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(int64_t)k * size + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// Heads and compositing.
// raw (m, 4) f32 = [raw_sigma, raw_r, raw_g, raw_b]
// ---------------------------------------------------------------------------

__global__ void heads_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ hr,
                                 const bf16* __restrict__ wd, const float* __restrict__ bd,
                                 const bf16* __restrict__ wc, const float* __restrict__ bc,
                                 float* __restrict__ raw, int m, int d, int h2) {
  const int64_t pt = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pt >= m) return;  // warp-uniform
  const bf16* hp = h + pt * d;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s += f32(hp[k]) * f32(wd[k]);
  const bf16* q = hr + pt * h2;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  for (int k = lane; k < h2; k += 32) {
    const float v = f32(q[k]);
    c0 += v * f32(wc[k * 3]);
    c1 += v * f32(wc[k * 3 + 1]);
    c2 += v * f32(wc[k * 3 + 2]);
  }
  s = warp_sum(s);
  c0 = warp_sum(c0);
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  if (lane == 0) {
    raw[pt * 4] = s + bd[0];
    raw[pt * 4 + 1] = c0 + bc[0];
    raw[pt * 4 + 2] = c1 + bc[1];
    raw[pt * 4 + 3] = c2 + bc[2];
  }
}

struct CompositeFlags {
  int softplus_act, occ_alpha, dist_alpha, white_bg;
};

// post-activation density head (softplus/relu, optional occupancy alpha)
__device__ __forceinline__ float density_act(float raw_sigma, const CompositeFlags& f) {
  float d = f.softplus_act ? softplus(raw_sigma) : fmaxf(raw_sigma, 0.f);
  if (f.occ_alpha) d = 1.f - expf(-d);
  return d;
}

__device__ __forceinline__ float alpha_of(float d, float delta, int s, int n_samples,
                                          const CompositeFlags& f) {
  if (!f.dist_alpha) return d;
  return s == n_samples - 1 ? 1.f : 1.f - expf(-d * delta);
}

__global__ void composite_fwd_kernel(const float* __restrict__ raw, const float* __restrict__ z,
                                     const float* __restrict__ deltas, float* __restrict__ rgbv,
                                     float* __restrict__ dist, float* __restrict__ alpha_out,
                                     int n_rays, int n_samples, CompositeFlags f) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  float trans = 1.f, r = 0.f, g = 0.f, b = 0.f, dd = 0.f, wsum = 0.f;
  for (int s = 0; s < n_samples; ++s) {
    const int64_t m = (int64_t)ray * n_samples + s;
    const float* rw = raw + m * 4;
    const float alpha = alpha_of(density_act(rw[0], f), deltas[m], s, n_samples, f);
    const float w = alpha * trans;
    r += w * sigmoid(rw[1]);
    g += w * sigmoid(rw[2]);
    b += w * sigmoid(rw[3]);
    dd += w * z[m];
    wsum += w;
    alpha_out[m] = alpha;
    trans *= 1.f - alpha + 1e-6f;
  }
  if (f.white_bg) {
    r += 1.f - wsum;
    g += 1.f - wsum;
    b += 1.f - wsum;
  }
  rgbv[ray * 3] = r;
  rgbv[ray * 3 + 1] = g;
  rgbv[ray * 3 + 2] = b;
  dist[ray] = dd;
}

// Backward of compositing + head activations: cotangents of the raw heads.
// scratch: 4 x (n_samples x n_rays) f32, laid out sample-major so that
// neighbouring threads (rays) touch neighbouring addresses.
__global__ void composite_bwd_kernel(const float* __restrict__ raw, const float* __restrict__ z,
                                     const float* __restrict__ deltas,
                                     const float* __restrict__ g_rgbv,
                                     const float* __restrict__ g_dist,
                                     const float* __restrict__ g_alpha,
                                     float* __restrict__ scratch, float* __restrict__ g_raw,
                                     int n_rays, int n_samples, CompositeFlags f) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const int64_t plane = (int64_t)n_samples * n_rays;
  float* s_alpha = scratch;
  float* s_trans = scratch + plane;
  float* s_w = scratch + 2 * plane;
  float* s_gw = scratch + 3 * plane;
  const float gr = g_rgbv[ray * 3], gg = g_rgbv[ray * 3 + 1], gb = g_rgbv[ray * 3 + 2];
  const float gd = g_dist[ray];
  float trans = 1.f;
  for (int s = 0; s < n_samples; ++s) {
    const int64_t m = (int64_t)ray * n_samples + s;
    const float* rw = raw + m * 4;
    const float alpha = alpha_of(density_act(rw[0], f), deltas[m], s, n_samples, f);
    const float w = alpha * trans;
    float gw = gr * sigmoid(rw[1]) + gg * sigmoid(rw[2]) + gb * sigmoid(rw[3]) + gd * z[m];
    if (f.white_bg) gw -= gr + gg + gb;
    const int64_t k = (int64_t)s * n_rays + ray;
    s_alpha[k] = alpha;
    s_trans[k] = trans;
    s_w[k] = w;
    s_gw[k] = gw;
    trans *= 1.f - alpha + 1e-6f;
  }
  float rsum = 0.f;  // sum over later samples of gw * w
  for (int s = n_samples - 1; s >= 0; --s) {
    const int64_t m = (int64_t)ray * n_samples + s;
    const int64_t k = (int64_t)s * n_rays + ray;
    const float alpha = s_alpha[k], w = s_w[k], gw = s_gw[k];
    const float ga = gw * s_trans[k] - rsum / (1.f - alpha + 1e-6f) + g_alpha[m];
    rsum += gw * w;
    const float* rw = raw + m * 4;
    const float rs = rw[0];
    float g_sig;
    if (f.dist_alpha) {
      const float d = density_act(rs, f);
      g_sig = s == n_samples - 1 ? 0.f : ga * deltas[m] * expf(-d * deltas[m]);
    } else {
      g_sig = ga;
    }
    float dd = f.softplus_act ? sigmoid(rs) : (rs > 0.f ? 1.f : 0.f);
    if (f.occ_alpha) {
      const float d0 = f.softplus_act ? softplus(rs) : fmaxf(rs, 0.f);
      dd *= expf(-d0);
    }
    float* out = g_raw + m * 4;
    out[0] = g_sig * dd;
    const float sr = sigmoid(rw[1]), sg = sigmoid(rw[2]), sb = sigmoid(rw[3]);
    out[1] = w * gr * sr * (1.f - sr);
    out[2] = w * gg * sg * (1.f - sg);
    out[3] = w * gb * sb * (1.f - sb);
  }
}

// g_hr = relu_mask(hr) * (bf16(g_raw_rgb) @ bf16(wc)^T), f32 (m x h2).
__global__ void heads_bwd_kernel(const float* __restrict__ g_raw, const bf16* __restrict__ hr,
                                 const bf16* __restrict__ wc, float* __restrict__ g_hr, int m,
                                 int h2) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)m * h2) return;
  const int64_t pt = idx / h2;
  const int k = idx % h2;
  float v = 0.f;
  if (f32(hr[idx]) > 0.f) {
    const float* g = g_raw + pt * 4 + 1;
    v = round_bf16(g[0]) * f32(wc[k * 3]) + round_bf16(g[1]) * f32(wc[k * 3 + 1]) +
        round_bf16(g[2]) * f32(wc[k * 3 + 2]);
  }
  g_hr[idx] = v;
}

// ---------------------------------------------------------------------------
// Encoding backward + ray sums, one warp per ray.
//   ge1/ge2: two per-point summands of d(pos-enc) (ld1/ld2 row strides);
//   gd: per-point d(dir-enc), summed over the ray's samples first.
// ---------------------------------------------------------------------------

constexpr int MAX_ENC = 3 * (2 * 16 + 1);

__global__ void encode_bwd_kernel(const float* __restrict__ o, const float* __restrict__ r,
                                  const float* __restrict__ dirs, const float* __restrict__ z,
                                  const float* __restrict__ ge1, int ld1,
                                  const float* __restrict__ ge2, int ld2,
                                  const float* __restrict__ gd, int ldd, float* __restrict__ d_o,
                                  float* __restrict__ d_r, float* __restrict__ d_d, int n_rays,
                                  int n_samples, int l_pos, int l_dir) {
  const int64_t ray = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (ray >= n_rays) return;  // warp-uniform
  const int n_dir = 3 * (2 * l_dir + 1);
  float acc_o[3] = {0.f, 0.f, 0.f}, acc_r[3] = {0.f, 0.f, 0.f};
  float gds[MAX_ENC];
  for (int k = 0; k < n_dir; ++k) gds[k] = 0.f;
  for (int s = lane; s < n_samples; s += 32) {
    const int64_t m = ray * n_samples + s;
    const float zz = z[m];
    const float* g1 = ge1 + m * ld1;
    const float* g2 = ge2 + m * ld2;
    float dp[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) dp[c] = g1[c] + g2[c];
    for (int l = 0; l < l_pos; ++l) {
      const float f = ldexpf(1.f, l);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float p = o[ray * 3 + c] + r[ray * 3 + c] * zz;
        float sn, cs;
        sincosf(p * f, &sn, &cs);
        const int ks = 3 * (1 + 2 * l) + c, kc = 3 * (2 + 2 * l) + c;
        const float gs = g1[ks] + g2[ks], gc = g1[kc] + g2[kc];
        dp[c] += (gs * cs - gc * sn) * f;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc_o[c] += dp[c];
      acc_r[c] += dp[c] * zz;
    }
    const float* gdp = gd + m * ldd;
    for (int k = 0; k < n_dir; ++k) gds[k] += gdp[k];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc_o[c] = warp_sum(acc_o[c]);
    acc_r[c] = warp_sum(acc_r[c]);
  }
  for (int k = 0; k < n_dir; ++k) gds[k] = warp_sum(gds[k]);
  if (lane != 0) return;
  float dd[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d_o[ray * 3 + c] = acc_o[c];
    d_r[ray * 3 + c] = acc_r[c];
    dd[c] = gds[c];
  }
  for (int l = 0; l < l_dir; ++l) {
    const float f = ldexpf(1.f, l);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float sn, cs;
      sincosf(dirs[ray * 3 + c] * f, &sn, &cs);
      dd[c] += (gds[3 * (1 + 2 * l) + c] * cs - gds[3 * (2 + 2 * l) + c] * sn) * f;
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) d_d[ray * 3 + c] = dd[c];
}

inline unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

template <typename TA1, typename TA2>
void launch_nn_c(const GemmNN& p, int c_f32, dim3 grid, cudaStream_t st) {
  if (c_f32)
    gemm_nn_kernel<TA1, TA2, float><<<grid, G_THREADS, 0, st>>>(p);
  else
    gemm_nn_kernel<TA1, TA2, bf16><<<grid, G_THREADS, 0, st>>>(p);
}

template <typename TA1>
void launch_nn_a2(const GemmNN& p, int a2_f32, int c_f32, dim3 grid, cudaStream_t st) {
  if (a2_f32)
    launch_nn_c<TA1, float>(p, c_f32, grid, st);
  else
    launch_nn_c<TA1, bf16>(p, c_f32, grid, st);
}

}  // namespace

extern "C" {

int nnt_encode_fwd(const float* o, const float* r, const float* dirs, const float* z, void* enc,
                   int ld_enc, void* denc, int ld_denc, int n_rays, int n_samples, int l_pos,
                   int l_dir, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t m = (int64_t)n_rays * n_samples;
  encode_points_kernel<<<blocks_for(m, 256), 256, 0, st>>>(o, r, z, static_cast<bf16*>(enc),
                                                           ld_enc, n_rays, n_samples, l_pos);
  encode_rows_kernel<<<blocks_for(n_rays, 256), 256, 0, st>>>(dirs, static_cast<bf16*>(denc),
                                                              ld_denc, n_rays, l_dir);
  return static_cast<int>(cudaGetLastError());
}

int nnt_gemm_nn(const void* a1, int a1_f32, int lda1, int k1, const void* a2, int a2_f32,
                int lda2, int k2, int a2_div, const void* b1, int ldb1, const void* b2, int ldb2,
                const float* bias, int relu, const void* mask, int ldm, int mask_cols, void* c,
                int c_f32, int ldc, int m, int n, void* stream) {
  GemmNN p{a1, lda1, k1, a2, lda2, k2, a2_div < 1 ? 1 : a2_div,
           static_cast<const bf16*>(b1), ldb1, static_cast<const bf16*>(b2), ldb2, bias, relu,
           static_cast<const bf16*>(mask), ldm, mask_cols, c, ldc, m, n};
  dim3 grid(blocks_for(m, G_BM), blocks_for(n, G_BN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a1_f32)
    launch_nn_a2<float>(p, a2_f32, c_f32, grid, st);
  else
    launch_nn_a2<bf16>(p, a2_f32, c_f32, grid, st);
  return static_cast<int>(cudaGetLastError());
}

int nnt_gemm_tn(const void* x1, int ldx1, int k1, const void* x2, int ldx2, int k2, int x2_div,
                const float* g, int ldg, int n, int m, int rows_per_split, float* partial,
                void* stream) {
  if (rows_per_split % G_BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (m + rows_per_split - 1) / rows_per_split;
  GemmTN p{static_cast<const bf16*>(x1), ldx1, k1, static_cast<const bf16*>(x2), ldx2, k2,
           x2_div < 1 ? 1 : x2_div, g, ldg, n, m, rows_per_split, partial};
  dim3 grid(blocks_for(k1 + k2, G_BM), blocks_for(n, G_BN), splits);
  gemm_tn_kernel<<<grid, G_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int nnt_colsum(const float* g, int ldg, int n, int m, int rows_per_split, float* partial,
               void* stream) {
  const int splits = (m + rows_per_split - 1) / rows_per_split;
  dim3 grid(blocks_for(n, 128), splits);
  colsum_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(g, ldg, n, m,
                                                                     rows_per_split, partial);
  return static_cast<int>(cudaGetLastError());
}

int nnt_reduce_splits(const float* partial, int splits, int size, float* out, void* stream) {
  reduce_splits_kernel<<<blocks_for(size, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      partial, splits, size, out);
  return static_cast<int>(cudaGetLastError());
}

int nnt_heads_fwd(const void* h, const void* hr, const void* wd, const float* bd, const void* wc,
                  const float* bc, float* raw, int m, int d, int h2, void* stream) {
  heads_fwd_kernel<<<blocks_for((int64_t)m * 32, 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(hr), static_cast<const bf16*>(wd),
      bd, static_cast<const bf16*>(wc), bc, raw, m, d, h2);
  return static_cast<int>(cudaGetLastError());
}

int nnt_composite_fwd(const float* raw, const float* z, const float* deltas, float* rgbv,
                      float* dist, float* alpha, int n_rays, int n_samples, int softplus_act,
                      int occ_alpha, int dist_alpha, int white_bg, void* stream) {
  CompositeFlags f{softplus_act, occ_alpha, dist_alpha, white_bg};
  composite_fwd_kernel<<<blocks_for(n_rays, 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      raw, z, deltas, rgbv, dist, alpha, n_rays, n_samples, f);
  return static_cast<int>(cudaGetLastError());
}

int nnt_composite_bwd(const float* raw, const float* z, const float* deltas,
                      const float* g_rgbv, const float* g_dist, const float* g_alpha,
                      float* scratch, float* g_raw, int n_rays, int n_samples, int softplus_act,
                      int occ_alpha, int dist_alpha, int white_bg, void* stream) {
  CompositeFlags f{softplus_act, occ_alpha, dist_alpha, white_bg};
  composite_bwd_kernel<<<blocks_for(n_rays, 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      raw, z, deltas, g_rgbv, g_dist, g_alpha, scratch, g_raw, n_rays, n_samples, f);
  return static_cast<int>(cudaGetLastError());
}

int nnt_heads_bwd(const float* g_raw, const void* hr, const void* wc, float* g_hr, int m, int h2,
                  void* stream) {
  heads_bwd_kernel<<<blocks_for((int64_t)m * h2, 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      g_raw, static_cast<const bf16*>(hr), static_cast<const bf16*>(wc), g_hr, m, h2);
  return static_cast<int>(cudaGetLastError());
}

int nnt_encode_bwd(const float* o, const float* r, const float* dirs, const float* z,
                   const float* ge1, int ld1, const float* ge2, int ld2, const float* gd, int ldd,
                   float* d_o, float* d_r, float* d_d, int n_rays, int n_samples, int l_pos,
                   int l_dir, void* stream) {
  if (3 * (2 * l_dir + 1) > MAX_ENC) return static_cast<int>(cudaErrorInvalidValue);
  encode_bwd_kernel<<<blocks_for((int64_t)n_rays * 32, 128), 128, 0,
                      static_cast<cudaStream_t>(stream)>>>(o, r, dirs, z, ge1, ld1, ge2, ld2,
                                                           gd, ldd, d_o, d_r, d_d, n_rays,
                                                           n_samples, l_pos, l_dir);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
