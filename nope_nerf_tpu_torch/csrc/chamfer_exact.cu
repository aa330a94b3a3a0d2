// Kernel D of the port: the exact Chamfer argmin, one direction per call.
//
// Replaces the Pallas kernel _make_kernel (nope_nerf_tpu/ops/pallas/
// chamfer_kernel.py:87), reached from nearest_idx_pallas (l.179) through
// _nearest_sweep's pallas_call (l.155).
//
// Semantics: for every query q, the first index j of the reduced cloud R
// minimising d = ((q0 - r0)^2 + (q1 - r1)^2) + (q2 - r2)^2, computed with
// round-to-nearest intrinsics so that nvcc cannot contract it into FMAs (a
// contraction flips near-ties against the plain version). The running
// (min, argmin) starts at (1e10, 0) and takes a candidate only when it is
// strictly smaller, as the TPU kernel's carry does (chamfer_kernel.py:97,
// 118-120): a query with no pair below 1e10 answers 0. Invalid points were
// moved to the +-1e5 sentinels by the caller, so they never win; the kernel
// masks the ragged edges itself and needs no padding.
//
// What bounds it on the H100: f32 ALU work. The stock exact step sweeps two
// 32,400-point clouds both ways: 2.1 G pairs of about 9 operations (3 sub,
// 3 mul, 2 add, 1 compare-select) -- some 0.6 ms at the card's 132 SMs x 128
// lanes. Memory is no limit: each block reads its slice of R once, 16 bytes a
// point, and broadcasts it from shared memory to all 256 threads.
//
// Design: one thread per query, 256 queries per block. 32,400 queries are
// only 127 blocks, far too few for 132 SMs that each hold 8 such blocks, so
// the reduced cloud is split across blockIdx.y (the wrapper picks about 8
// blocks per SM). A block stages its split 1024 points at a time in shared
// memory as float4 (one 16-byte broadcast load per pair), and each thread
// writes its split's (min, argmin). A second kernel merges the splits in
// order with the same strict '<': every split reports its first occurrence
// and later splits hold larger indices, so the merge keeps the global first
// occurrence, and a split that found nothing below 1e10 reports (1e10, 0),
// which never displaces anything.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EX_THREADS = 256;
constexpr int EX_TILE = 1024;
constexpr float EX_BIG = 1e10f;

__global__ void __launch_bounds__(EX_THREADS)
    exact_argmin_kernel(const float* __restrict__ q, int nq, const float* __restrict__ r, int nr,
                        int split_len, float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float4 rs[EX_TILE];
  const int qi = blockIdx.x * EX_THREADS + threadIdx.x;
  const int beg = blockIdx.y * split_len;
  const int end = min(nr, beg + split_len);
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  if (qi < nq) {
    x0 = q[(int64_t)qi * 3];
    x1 = q[(int64_t)qi * 3 + 1];
    x2 = q[(int64_t)qi * 3 + 2];
  }
  float best = EX_BIG;
  int best_i = 0;
  for (int t0 = beg; t0 < end; t0 += EX_TILE) {
    const int n = min(EX_TILE, end - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += EX_THREADS) {
      const float* p = r + (int64_t)(t0 + i) * 3;
      rs[i] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float4 y = rs[i];
      const float d0 = __fsub_rn(x0, y.x);
      const float d1 = __fsub_rn(x1, y.y);
      const float d2 = __fsub_rn(x2, y.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                __fmul_rn(d2, d2));
      if (d < best) {
        best = d;
        best_i = t0 + i;
      }
    }
  }
  if (qi < nq) {
    part_d[(int64_t)blockIdx.y * nq + qi] = best;
    part_i[(int64_t)blockIdx.y * nq + qi] = best_i;
  }
}

__global__ void merge_splits_kernel(const float* __restrict__ part_d,
                                    const int* __restrict__ part_i, int splits, int nq,
                                    int* __restrict__ out) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float best = part_d[qi];
  int best_i = part_i[qi];
  for (int s = 1; s < splits; ++s) {
    const float d = part_d[(int64_t)s * nq + qi];
    if (d < best) {
      best = d;
      best_i = part_i[(int64_t)s * nq + qi];
    }
  }
  out[qi] = best_i;
}

}  // namespace

// q (nq, 3), r (nr, 3) f32; part_d / part_i (ceil(nr / split_len), nq)
// scratch; out (nq,) int32 indices into r.
extern "C" int nnt_exact_argmin(const float* q, int nq, const float* r, int nr, int split_len,
                                float* part_d, int* part_i, int* out, void* stream) {
  if (nq <= 0 || nr <= 0 || split_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = (nr + split_len - 1) / split_len;
  dim3 grid((nq + EX_THREADS - 1) / EX_THREADS, splits);
  exact_argmin_kernel<<<grid, EX_THREADS, 0, st>>>(q, nq, r, nr, split_len, part_d, part_i);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_splits_kernel<<<(nq + 255) / 256, 256, 0, st>>>(part_d, part_i, splits, nq, out);
  return static_cast<int>(cudaGetLastError());
}
