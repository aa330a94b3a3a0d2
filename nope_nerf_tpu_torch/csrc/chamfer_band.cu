// Kernel B of the port: projection-guided banded Chamfer argmin.
//
// Replaces the Pallas kernel _band_kernel (nope_nerf_tpu/ops/pallas/
// chamfer_band.py:90), reached from nearest_idx_banded (l.133) through the
// pallas_call at l.179.
//
// Semantics: queries come in groups of qb consecutive rows; group g takes
// the argmin of the squared distance over the k_tiles * tile rows of Y that
// start at tile starts[g]. X is padded with +1e5 rows and Y with -1e5 rows
// by the caller, so padding never wins. Ties go to the first occurrence
// (strict '<' in row order, like jnp.argmin).
//
// What bounds it on the H100: arithmetic. Each query scans k_tiles * 1024
// candidates (8192 at the stock step), about 10 flops each: 0.27 G distance
// evaluations for the 32,400-point clouds, twice per step. Every Y row is
// read once per block and broadcast from shared memory to all threads.
//
// Design: one thread per query, 256 per block (a block never straddles a
// query group because qb is a multiple of 256). The block stages one tile of
// its band at a time in shared memory and each thread keeps a running
// (min, index). The distance is d0*d0 + d1*d1 + d2*d2 with explicit
// round-to-nearest intrinsics so that nvcc cannot contract it into FMAs:
// the plain version computes the same sum without FMAs, and a contraction
// would flip near-ties against it.

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

}  // namespace

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
