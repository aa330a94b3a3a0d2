// Kernel B of the port: projection-guided banded Chamfer argmin.
//
// Replaces the Pallas kernel _band_kernel (nope_nerf_tpu/ops/pallas/
// chamfer_band.py:90), reached from nearest_idx_banded (l.133) through the
// pallas_call at l.179.
//
// Semantics: queries come in groups of qb consecutive rows; group g takes
// the argmin of the squared distance over the k_tiles * tile rows of Y that
// start at tile starts[g] (clamped to [0, n_tiles - k_tiles]). Rows of Y past
// its end count as the -1e5 sentinel row, as the JAX package pads Y. Ties go
// to the first occurrence (strict '<' in row order, like jnp.argmin); a query
// whose distances are all NaN or +inf keeps the band's first row. The
// distance is ((x0-y0)^2 + (x1-y1)^2) + (x2-y2)^2 with explicit round-to-
// nearest intrinsics, so that nvcc cannot contract it into FMAs: the plain
// version computes the same sum without FMAs, and a contraction would flip
// near-ties against it.
//
// What bounds it on the H100: FP32 issue. Each query scans k_tiles * 1024
// candidates (8192 at the stock step): 265 M point pairs for the 32,400-point
// clouds, twice per step, and at least 9 FP32 instructions a pair (3 sub,
// 3 mul, 2 add and a min). The clouds are 0.4 MB each.
//
// Design (band_argmin_split_kernel):
// * Q queries a thread (4), held in registers. A warp owns 32 * Q
//   consecutive queries; each candidate row is read once from shared memory
//   as one 16-byte broadcast (x, y, z, 0) and serves all Q of them.
// * The band is split across the SPLIT warps of a block (8): warp w
//   sweeps the w-th contiguous part of the band for the block's 32 * Q
//   queries. A block is 8 warps; the stock 32,400 queries make 254 blocks of
//   128, two resident per SM, so 16 warps share each SM's four schedulers.
//   Each warp stages its own rows in its own slice of shared memory (a
//   __syncwarp, no block barrier), so one warp's staging loads overlap the
//   other warps' sweeps; each warp also issues the loads of its next rows
//   before it sweeps the current ones (6% faster than loading after).
// * Fewer instructions a pair: over a chunk of CHUNK (16) candidates the
//   running minimum is one fminf a pair (fminf drops NaN, as '<' never picks
//   one); only a chunk whose minimum is below the best so far is recorded
//   (its start row). After the sweep the recorded chunk is scanned once more
//   for the first row whose distance, recomputed with the same intrinsics,
//   equals the minimum. The first chunk to reach the minimum, and the first
//   row in it, is the row the sequential strict '<' picks.
// * The block merges its warps' (min, row) pairs in band order with the same
//   strict '<': every part reports its first occurrence, and later parts hold
//   later rows (the argument of csrc/chamfer_exact.cu). One launch per call.
// * The ragged query tail is masked; no padded copy of X or Y is made.
//
// band_argmin_kernel is the kernel this design replaced (one query a thread,
// the whole band in order), kept as the bitwise oracle of the new kernel in
// chip_smoke.py and the card tests; it takes the sentinel-padded copies its
// wrapper makes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BAND_THREADS = 256;
constexpr int MAX_TILE = 1024;

__global__ void __launch_bounds__(BAND_THREADS)
    band_argmin_kernel(const float* __restrict__ xp, const float* __restrict__ yp,
                       const int* __restrict__ starts, int* __restrict__ out, int n_tiles,
                       int k_tiles, int tile, int qb) {
  __shared__ float ys[3][MAX_TILE];
  const int q = blockIdx.x * BAND_THREADS + threadIdx.x;
  const int group = (blockIdx.x * BAND_THREADS) / qb;
  const int start = min(max(starts[group], 0), max(n_tiles - k_tiles, 0));
  const float x0 = xp[q * 3], x1 = xp[q * 3 + 1], x2 = xp[q * 3 + 2];
  float best = INFINITY;
  int best_i = start * tile;
  for (int t = 0; t < k_tiles; ++t) {
    const int row0 = (start + t) * tile;
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += BAND_THREADS) {
      const float* y = yp + (size_t)(row0 + i) * 3;
      ys[0][i] = y[0];
      ys[1][i] = y[1];
      ys[2][i] = y[2];
    }
    __syncthreads();
    for (int i = 0; i < tile; ++i) {
      const float d0 = __fsub_rn(x0, ys[0][i]);
      const float d1 = __fsub_rn(x1, ys[1][i]);
      const float d2 = __fsub_rn(x2, ys[2][i]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                __fmul_rn(d2, d2));
      if (d < best) {
        best = d;
        best_i = row0 + i;
      }
    }
  }
  out[q] = best_i;
}

constexpr int Q = 4;                       // queries a thread
constexpr int SPLIT = 8;                   // warps a block, parts of the band
constexpr int CHUNK = 16;                  // candidates per fminf chunk
constexpr int QBLK = 32 * Q;               // queries per block
constexpr int SMEM_ROWS = 2048;            // float4 rows of shared memory: 32 KB
constexpr int BUF = SMEM_ROWS / SPLIT;     // rows a warp stages at a time
constexpr int PER_LANE = BUF / 32;
constexpr float X_SENTINEL = 1e5f;
constexpr float Y_SENTINEL = -1e5f;
static_assert(BUF % CHUNK == 0 && BUF % 32 == 0, "staging buffer");
static_assert(SPLIT * QBLK * 8 <= SMEM_ROWS * 16, "merge buffer");

__device__ __forceinline__ float sq_dist(const float* x, float y0, float y1, float y2) {
  const float d0 = __fsub_rn(x[0], y0);
  const float d1 = __fsub_rn(x[1], y1);
  const float d2 = __fsub_rn(x[2], y2);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
}

// row ``row`` of Y, or the sentinel row past its end
__device__ __forceinline__ void y_row(const float* __restrict__ y, int row, int n_y, float* v) {
  if (row < n_y) {
    v[0] = __ldg(y + 3 * (size_t)row);
    v[1] = __ldg(y + 3 * (size_t)row + 1);
    v[2] = __ldg(y + 3 * (size_t)row + 2);
  } else {
    v[0] = v[1] = v[2] = Y_SENTINEL;
  }
}

__global__ void __launch_bounds__(32 * SPLIT, 2)
    band_argmin_split_kernel(const float* __restrict__ x, const float* __restrict__ y,
                             const int* __restrict__ starts, int* __restrict__ out, int n_x,
                             int n_y, int n_tiles, int k_tiles, int tile, int qb) {
  __shared__ float4 smem[SMEM_ROWS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QBLK;
  const int start = min(max(starts[q0 / qb], 0), max(n_tiles - k_tiles, 0));
  const int len = k_tiles * tile / SPLIT;  // rows of the band this warp sweeps
  const int lo = start * tile + warp * len;
  float4* ys = smem + warp * BUF;

  float xq[Q][3], best[Q];
  int chunk[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int q = q0 + i * 32 + lane;
#pragma unroll
    for (int c = 0; c < 3; ++c) xq[i][c] = q < n_x ? __ldg(x + 3 * (size_t)q + c) : X_SENTINEL;
    best[i] = INFINITY;
    chunk[i] = -1;
  }

  // the warp's next rows, loaded while it sweeps the current ones
  float pre[PER_LANE][3];
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) y_row(y, lo + lane + 32 * t, n_y, pre[t]);
  for (int b0 = 0; b0 < len; b0 += BUF) {
    const int n = min(BUF, len - b0);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      if (lane + 32 * t < n) ys[lane + 32 * t] = make_float4(pre[t][0], pre[t][1], pre[t][2], 0.f);
    }
    __syncwarp();
    if (b0 + BUF < len) {
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) y_row(y, lo + b0 + BUF + lane + 32 * t, n_y, pre[t]);
    }
    for (int c = 0; c < n; c += CHUNK) {
      float m[Q];
      {
        const float4 v = ys[c];
#pragma unroll
        for (int i = 0; i < Q; ++i) m[i] = sq_dist(xq[i], v.x, v.y, v.z);
      }
#pragma unroll
      for (int j = 1; j < CHUNK; ++j) {
        const float4 v = ys[c + j];
#pragma unroll
        for (int i = 0; i < Q; ++i) m[i] = fminf(m[i], sq_dist(xq[i], v.x, v.y, v.z));
      }
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        if (m[i] < best[i]) {
          best[i] = m[i];
          chunk[i] = lo + b0 + c;
        }
      }
    }
  }

  // the first row of the recorded chunk at the minimum
  int idx[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    idx[i] = start * tile;
    if (chunk[i] >= 0) {
      for (int j = CHUNK - 1; j >= 0; --j) {
        float v[3];
        y_row(y, chunk[i] + j, n_y, v);
        if (sq_dist(xq[i], v[0], v[1], v[2]) == best[i]) idx[i] = chunk[i] + j;
      }
    }
  }

  // merge the warps' parts in band order
  __syncthreads();
  float* part_d = reinterpret_cast<float*>(smem);
  int* part_i = reinterpret_cast<int*>(smem) + SPLIT * QBLK;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    part_d[warp * QBLK + i * 32 + lane] = best[i];
    part_i[warp * QBLK + i * 32 + lane] = idx[i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < QBLK; t += 32 * SPLIT) {
    float b = INFINITY;
    int bi = start * tile;
    for (int s = 0; s < SPLIT; ++s) {
      if (part_d[s * QBLK + t] < b) {
        b = part_d[s * QBLK + t];
        bi = part_i[s * QBLK + t];
      }
    }
    if (q0 + t < n_x) out[q0 + t] = bi;
  }
}

}  // namespace

// The per-query kernel on sentinel-padded X (n_queries_padded rows, a multiple of
// qb) and Y (n_tiles * tile rows); the bitwise oracle of nnt_band_argmin_split.
extern "C" int nnt_band_argmin(const float* xp, const float* yp, const int* starts, int* out,
                               int n_queries_padded, int n_tiles, int k_tiles, int tile, int qb,
                               void* stream) {
  if (tile > MAX_TILE || qb % BAND_THREADS != 0 || n_queries_padded % qb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  band_argmin_kernel<<<n_queries_padded / BAND_THREADS, BAND_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(xp, yp, starts, out, n_tiles, k_tiles,
                                                            tile, qb);
  return static_cast<int>(cudaGetLastError());
}

// The main path's kernel on X (n_x, 3) and Y (n_y, 3) as they are: out gets
// n_x indices; starts has ceil(n_x / qb) entries; k_tiles <= n_tiles =
// ceil(n_y / tile).
extern "C" int nnt_band_argmin_split(const float* x, const float* y, const int* starts, int* out,
                                     int n_x, int n_y, int n_tiles, int k_tiles, int tile, int qb,
                                     void* stream) {
  if (n_x <= 0 || qb % QBLK != 0 || tile % (SPLIT * CHUNK) != 0 || k_tiles > n_tiles ||
      k_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  band_argmin_split_kernel<<<(n_x + QBLK - 1) / QBLK, 32 * SPLIT, 0,
                             static_cast<cudaStream_t>(stream)>>>(x, y, starts, out, n_x, n_y,
                                                                  n_tiles, k_tiles, tile, qb);
  return static_cast<int>(cudaGetLastError());
}
