// Kernels A and C of the port outside their fused forward
// (mlp_fused_fwd.cu) and their fused layer passes (mlp_fused_bwd.cu): Kernel
// A's compositing on the raw route, its compositing backward, its encoding
// backward with the ray sums and the per-ray direction half of rgb_layer's
// weight gradient; Kernel C's head-activation backward and encoding backward.
//
// Replaces the Pallas kernels of nope_nerf_tpu/ops/pallas/mlp_kernel.py:
//   A forward  _make_fwd_composite_kernel (l.668), reached from
//              fused_mlp_composite -> _fused_mlp_composite_call (l.852);
//   A backward _make_bwd_composite_kernel (l.702), reached from
//              _fused_mlp_composite_bwd (l.909);
//   C forward  _make_fwd_kernel (l.244), reached from fused_mlp ->
//              _fused_mlp_call (l.387);
//   C backward _make_bwd_kernel (l.258), reached from _fused_mlp_bwd ->
//              _fused_mlp_bwd_call (l.440).
// C is A without the ray expansion and the compositing: its direction
// encoding is per point, and two per-point entries replace A's per-ray ones
// in its backward: head_act_bwd (cotangents of rgb, density -> of the raw
// heads) and encode_points_bwd (encoding cotangents -> d_pts or d_dirs, no
// ray sums).
//
// What bounds it on the H100: the ten layer GEMMs live in the fused kernels;
// what is left here is memory- and latency-bound elementwise work on
// per-point and per-ray tensors.
//
// Design: the TPU kernel kept every activation in VMEM and recomputed the
// forward inside the backward. A block on this card has at most 227 KB of
// shared memory, which does not hold the 1.2 MB of weights, so the forward
// (mlp_fused_fwd.cu) SAVES its bf16 activations (about 0.7 GB at the stock
// step) for the backward (mlp_fused_bwd.cu, one pass per layer) instead of
// recomputing. This file holds the rest:
//   * composite_fwd: the head activations and the compositing scan one
//     thread per ray, sequential over the samples, for an S that does not
//     divide the fused forward's 128-point tile. The TPU layout tricks
//     (selector matmuls, log-space cumprod, triangular-matmul suffix sums)
//     become plain loops.
//   * composite_bwd_group: the compositing backward, one block per group of
//     rays, the per-point work parallel, only the two recurrences one
//     thread per ray.
//   * ray_sum + dir_wgrad: Kernel A's per-ray direction half of
//     rgb_layer's weight gradient; reduce_splits adds its split partial
//     sums in a fixed order (no float atomics, so runs repeat bitwise).
//   * encode_bwd_staged: the encoding backward and the ray sums that give
//     d_origins, d_rays and d_dirs, a block of two warps per ray sharing
//     coalesced loads of rows staged through shared memory.
// Numerics follow the TPU kernel: bf16 operands, f32 accumulation, f32
// biases, activations rounded to bf16 after the epilogue, raw heads in f32,
// stable softplus, eps 1e-6 in the transmittance product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// out[i] = sum over splits of partial[s][i] in a fixed order: a block of
// GROUPS warps owns 32 consecutive i; lane e of warp g sums splits g,
// g + GROUPS, ... of its i in order, and the group sums are added in group
// order. GROUPS loads in flight per output, not one: the partials are read
// at the rate of the memory, not of its latency. 128 splits or more take
// 32 groups, fewer 8.
template <int GROUPS>
__global__ void reduce_splits_kernel(const float* __restrict__ partial, int splits,
                                     int64_t size, float* __restrict__ out) {
  __shared__ float part[GROUPS][32];
  const int e = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * 32 + e;
  float s = 0.f;
  if (i < size)
    for (int k = g; k < splits; k += GROUPS) s += partial[(int64_t)k * size + i];
  part[g][e] = s;
  __syncthreads();
  if (g == 0 && i < size) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < GROUPS; ++k) total += part[k][e];
    out[i] = total;
  }
}

void reduce_splits(const float* partial, int splits, int64_t size, float* out, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((size + 31) / 32);
  if (splits >= 128)
    reduce_splits_kernel<32><<<blocks, 32 * 32, 0, st>>>(partial, splits, size, out);
  else
    reduce_splits_kernel<8><<<blocks, 32 * 8, 0, st>>>(partial, splits, size, out);
}

// ---------------------------------------------------------------------------
// Heads and compositing.
// raw (m, 4) f32 = [raw_sigma, raw_r, raw_g, raw_b]
// ---------------------------------------------------------------------------

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

// Backward of compositing + head activations: the cotangents of the raw
// heads, one block per group of `rays` whole rays (their rays * n_samples
// points are contiguous in raw, z, deltas, g_alpha and g_raw), in three
// phases over shared memory:
//   1. per point, all threads: raw as one float4, alpha and gw;
//   2. per ray, one thread each: the two recurrences, trans (before each
//      sample's factor) forward and the suffix sum rsum of gw * w (after
//      each sample) backward -- the only sequential work, one multiply or
//      one FMA a sample;
//   3. per point, all threads: ga, the activation derivatives and g_raw,
//      written as one float4.
// The recurrences run in the order of composite_bwd_reference
// (mlp_kernel.py): rsum's numerator is the recurrence, the division after
// it is per point. A ray's arrays are rows of stride ld = n_samples | 1
// (odd: the phase-2 threads hit distinct banks).
constexpr int CB_THREADS = 256;

__global__ void __launch_bounds__(CB_THREADS)
    composite_bwd_group_kernel(const float* __restrict__ raw, const float* __restrict__ z,
                               const float* __restrict__ deltas,
                               const float* __restrict__ g_rgbv,
                               const float* __restrict__ g_dist,
                               const float* __restrict__ g_alpha, float* __restrict__ g_raw,
                               int n_rays, int n_samples, int rays, CompositeFlags f) {
  extern __shared__ float sm[];
  const int S = n_samples, ld = S | 1;
  const int ray0 = blockIdx.x * rays;
  const int nr = min(rays, n_rays - ray0);
  const int np = nr * S;
  float* s_alpha = sm;
  float* s_gw = s_alpha + rays * ld;
  float* s_trans = s_gw + rays * ld;
  float* s_rsum = s_trans + rays * ld;
  float* s_cot = s_rsum + rays * ld;  // per ray: gr, gg, gb, gd
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    const int64_t ray = ray0 + i;
#pragma unroll
    for (int c = 0; c < 3; ++c) s_cot[4 * i + c] = g_rgbv[ray * 3 + c];
    s_cot[4 * i + 3] = g_dist[ray];
  }
  __syncthreads();
  const int64_t m0 = (int64_t)ray0 * S;
  const float4* raw4 = reinterpret_cast<const float4*>(raw) + m0;
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const int i = p / S, s = p - i * S;
    const int64_t m = m0 + p;
    const float4 rw = raw4[p];
    const float gr = s_cot[4 * i], gg = s_cot[4 * i + 1], gb = s_cot[4 * i + 2];
    const float gd = s_cot[4 * i + 3];
    const float alpha = alpha_of(density_act(rw.x, f), deltas[m], s, S, f);
    float gw = gr * sigmoid(rw.y) + gg * sigmoid(rw.z) + gb * sigmoid(rw.w) + gd * z[m];
    if (f.white_bg) gw -= gr + gg + gb;
    s_alpha[i * ld + s] = alpha;
    s_gw[i * ld + s] = gw;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    const float* a = s_alpha + i * ld;
    const float* g = s_gw + i * ld;
    float* t = s_trans + i * ld;
    float* r = s_rsum + i * ld;
    float trans = 1.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      t[s] = trans;
      trans *= 1.f - a[s] + 1e-6f;
    }
    float rsum = 0.f;  // sum over later samples of gw * w
#pragma unroll 8
    for (int s = S - 1; s >= 0; --s) {
      r[s] = rsum;
      const float w = a[s] * t[s];
      rsum += g[s] * w;
    }
  }
  __syncthreads();
  float4* out4 = reinterpret_cast<float4*>(g_raw) + m0;
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const int i = p / S, s = p - i * S;
    const int64_t m = m0 + p;
    const float4 rw = raw4[p];
    const float gr = s_cot[4 * i], gg = s_cot[4 * i + 1], gb = s_cot[4 * i + 2];
    const float alpha = s_alpha[i * ld + s], trans = s_trans[i * ld + s];
    const float gw = s_gw[i * ld + s], rsum = s_rsum[i * ld + s];
    const float w = alpha * trans;
    const float ga = gw * trans - rsum / (1.f - alpha + 1e-6f) + g_alpha[m];
    const float rs = rw.x;
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
    const float sr = sigmoid(rw.y), sg = sigmoid(rw.z), sb = sigmoid(rw.w);
    out4[p] = make_float4(g_sig * dd, w * gr * sr * (1.f - sr), w * gg * sg * (1.f - sg),
                          w * gb * sb * (1.f - sb));
  }
}

// Kernel A's direction half of rgb_layer's weight gradient. The direction
// encoding is per ray, so dW_dir = denc^T @ (the per-ray sums of g_hr):
// gsum (n_rays x n) f32 sums each ray's n_samples rows of the bf16 g in
// sample order, one thread per column; then partial[split] (k x n) =
// denc[rays of split]^T @ gsum[rays of split] in f32, `rays` rays per split,
// one thread per output, rays in order (reduce_splits adds the splits).

__global__ void ray_sum_kernel(const bf16* __restrict__ g, int ldg, int n, int n_samples,
                               float* __restrict__ gsum) {
  const int col = threadIdx.x, ray = blockIdx.x;
  if (col >= n) return;
  const bf16* p = g + (int64_t)ray * n_samples * ldg + col;
  float s = 0.f;
  for (int i = 0; i < n_samples; ++i) s += f32(p[(int64_t)i * ldg]);
  gsum[(int64_t)ray * n + col] = s;
}

__global__ void dir_wgrad_kernel(const bf16* __restrict__ denc, int ldd,
                                 const float* __restrict__ gsum, int n, int n_rays, int rays,
                                 float* __restrict__ partial) {
  const int col = threadIdx.x, k = blockIdx.x, split = blockIdx.y;
  if (col >= n) return;
  const int r1 = min(n_rays, (split + 1) * rays);
  float s = 0.f;
  for (int ray = split * rays; ray < r1; ++ray)
    s += f32(denc[(int64_t)ray * ldd + k]) * gsum[(int64_t)ray * n + col];
  partial[((int64_t)split * gridDim.x + k) * n + col] = s;
}

// ---------------------------------------------------------------------------
// Encoding backward + ray sums.
//   ge1/ge2: two per-point summands of d(pos-enc) (ld1/ld2 row strides);
//   gd: per-point d(dir-enc), summed over the ray's samples first.
// ---------------------------------------------------------------------------

constexpr int MAX_ENC = 3 * (2 * 16 + 1);

// pts = o + r * z rounded after the product and after the sum (no FMA), as
// PyTorch computes the points of the plain versions and of the per-point
// path: the top encoding frequency 2^9 would amplify a one-ulp difference.
__device__ __forceinline__ float expand(float o, float r, float z) {
  return __fadd_rn(o, __fmul_rn(r, z));
}

// Encoding backward + ray sums, one block of EB_WARPS warps per ray, with
// every load coalesced. The sums are taken as one warp per ray whose lane l
// owns samples l, l + 32, ... would take them (encode_bwd_reference's
// _lane_sums in mlp_kernel.py), while the block's warps share the loads and
// the sincos work:
//   1. the direction sums: thread (warp w, lane j) owns column k = j (+ 32
//      per group) of lanes i = w, w + EB_WARPS, ...: the partial part[i][k]
//      = gd[i][k] + gd[i + 32][k] + ... in sample order, each warp load one
//      row; warp 0 then replays warp_sum's butterfly on part[.][k] (lane 0's
//      operands at each stage);
//   2. the position part, EB_WARPS * 32 samples a round: warp w stages
//      rows 32 w .. 32 w + 31 of the round, ge1 + ge2 (float4 loads across
//      the columns), into shared memory, and lane l computes that sample's
//      dp from its row; warp 0's lane l then adds the round's dp of samples
//      l, l + 32, ... to its accumulators in sample order, and warp_sum
//      ends.
// Staged rows are 4 * ceil(n_pos / 4) + 1 floats apart (odd: lane l
// reading row l hits bank l + k); the round's dp are 3 floats apart. The
// direction partials wait in shared memory until the end, so their loads
// and the first round's overlap.
constexpr int EB_WARPS = 2;     // warps a ray (a block)
constexpr int EB_UNROLL = 8;    // float4 loads a lane has in flight per operand

__host__ __device__ inline int eb_row_floats(int n_pos) { return (n_pos + 3) / 4 * 4 + 1; }
__host__ __device__ inline int eb_smem_floats(int n_pos, int n_dir) {
  return EB_WARPS * 32 * (eb_row_floats(n_pos) + 3) + 33 * n_dir;
}

__global__ void __launch_bounds__(EB_WARPS * 32)
    encode_bwd_staged_kernel(const float* __restrict__ o, const float* __restrict__ r,
                             const float* __restrict__ dirs, const float* __restrict__ z,
                             const float* __restrict__ ge1, int ld1,
                             const float* __restrict__ ge2, int ld2,
                             const float* __restrict__ gd, int ldd, float* __restrict__ d_o,
                             float* __restrict__ d_r, float* __restrict__ d_d, int n_rays,
                             int n_samples, int l_pos, int l_dir) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t ray = blockIdx.x;
  const int n_pos = 3 * (2 * l_pos + 1), n_dir = 3 * (2 * l_dir + 1);
  const int q4 = (n_pos + 3) / 4, ldg = eb_row_floats(n_pos);
  float* rows = sm + warp * 32 * ldg;
  float* dps = sm + EB_WARPS * 32 * ldg;  // the round's dp [EB_WARPS * 32][3]
  float* part = dps + EB_WARPS * 32 * 3;  // direction partials [32][n_dir]
  float* gds = part + 32 * n_dir;
  const int S = n_samples;
  const int64_t m0 = ray * S;

  for (int k0 = 0; k0 < n_dir; k0 += 32) {
    const int k = k0 + lane;
    if (k < n_dir) {
#pragma unroll
      for (int i = warp; i < 32; i += EB_WARPS) {
        float p = 0.f;
#pragma unroll 4
        for (int s = i; s < S; s += 32) p += gd[(m0 + s) * ldd + k];
        part[i * n_dir + k] = p;
      }
    }
  }

  float ov[3], rv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ov[c] = o[ray * 3 + c];
    rv[c] = r[ray * 3 + c];
  }
  float acc_o[3] = {0.f, 0.f, 0.f}, acc_r[3] = {0.f, 0.f, 0.f};  // warp 0's
  for (int r0 = 0; r0 < S; r0 += EB_WARPS * 32) {
    const int c0 = r0 + warp * 32;
    const int n = max(0, min(32, S - c0));
    const int items = n * q4;  // float4 columns of the warp's rows
    for (int base = 0; base < items; base += 32 * EB_UNROLL) {
      float4 a[EB_UNROLL], b[EB_UNROLL];
#pragma unroll
      for (int u = 0; u < EB_UNROLL; ++u) {
        const int it = base + u * 32 + lane;
        if (it < items) {
          const int row = it / q4, q = it - row * q4;
          const int64_t m = m0 + c0 + row;
          a[u] = *reinterpret_cast<const float4*>(ge1 + m * ld1 + 4 * q);
          b[u] = *reinterpret_cast<const float4*>(ge2 + m * ld2 + 4 * q);
        }
      }
#pragma unroll
      for (int u = 0; u < EB_UNROLL; ++u) {
        const int it = base + u * 32 + lane;
        if (it < items) {
          const int row = it / q4, q = it - row * q4;
          float* dst = rows + row * ldg + 4 * q;
          dst[0] = a[u].x + b[u].x;
          dst[1] = a[u].y + b[u].y;
          dst[2] = a[u].z + b[u].z;
          dst[3] = a[u].w + b[u].w;
        }
      }
    }
    __syncwarp();
    if (lane < n) {
      const float zz = z[m0 + c0 + lane];
      const float* g = rows + lane * ldg;
      float dp[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) dp[c] = g[c];
      for (int l = 0; l < l_pos; ++l) {
        const float f = ldexpf(1.f, l);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float p = expand(ov[c], rv[c], zz);
          float sn, cs;
          sincosf(p * f, &sn, &cs);
          const int ks = 3 * (1 + 2 * l) + c, kc = 3 * (2 + 2 * l) + c;
          const float gs = g[ks], gc = g[kc];
          dp[c] += (gs * cs - gc * sn) * f;
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) dps[(warp * 32 + lane) * 3 + c] = dp[c];
    }
    __syncthreads();
    if (warp == 0) {
      for (int w = 0; w < EB_WARPS; ++w) {
        const int s = r0 + w * 32 + lane;
        if (s < S) {
          const float zz = z[m0 + s];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float dp = dps[(w * 32 + lane) * 3 + c];
            acc_o[c] += dp;
            acc_r[c] += dp * zz;
          }
        }
      }
    }
    __syncthreads();
  }
  if (warp != 0) return;
  for (int k0 = 0; k0 < n_dir; k0 += 32) {
    const int k = k0 + lane;
    if (k < n_dir) {
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = part[i * n_dir + k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < off; ++i) v[i] = v[i] + v[i + off];
      gds[k] = v[0];
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc_o[c] = warp_sum(acc_o[c]);
    acc_r[c] = warp_sum(acc_r[c]);
  }
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

// ---------------------------------------------------------------------------
// Kernel C's per-point entries.
// ---------------------------------------------------------------------------

// Cotangents of the raw heads from those of rgb and density (the TPU
// kernel's _act_bwd, mlp_kernel.py:228-241).
__global__ void head_act_bwd_kernel(const float* __restrict__ raw, const float* __restrict__ g_rgb,
                                    const float* __restrict__ g_density,
                                    float* __restrict__ g_raw, int m, CompositeFlags f) {
  const int64_t pt = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= m) return;
  const float* rw = raw + pt * 4;
  const float rs = rw[0];
  float dd = f.softplus_act ? sigmoid(rs) : (rs > 0.f ? 1.f : 0.f);
  if (f.occ_alpha) dd *= expf(-(f.softplus_act ? softplus(rs) : fmaxf(rs, 0.f)));
  float* out = g_raw + pt * 4;
  out[0] = g_density[pt] * dd;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float s = sigmoid(rw[1 + c]);
    out[1 + c] = g_rgb[pt * 3 + c] * s * (1.f - s);
  }
}

// d_x (rows, 3) from the cotangent of the encoding [x, sin 2^l x, cos 2^l x],
// given as the sum of two f32 summands (ge2 may be null), one thread per row.
__global__ void encode_points_bwd_kernel(const float* __restrict__ x,
                                         const float* __restrict__ ge1, int ld1,
                                         const float* __restrict__ ge2, int ld2,
                                         float* __restrict__ d_x, int rows, int levels) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const float* g1 = ge1 + i * ld1;
  const float* g2 = ge2 ? ge2 + i * ld2 : nullptr;
  const auto g = [&](int k) { return g2 ? g1[k] + g2[k] : g1[k]; };
  float dp[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) dp[c] = g(c);
  for (int l = 0; l < levels; ++l) {
    const float fr = ldexpf(1.f, l);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float sn, cs;
      sincosf(x[i * 3 + c] * fr, &sn, &cs);
      dp[c] += (g(3 * (1 + 2 * l) + c) * cs - g(3 * (2 + 2 * l) + c) * sn) * fr;
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) d_x[i * 3 + c] = dp[c];
}

inline unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int nnt_composite_fwd(const float* raw, const float* z, const float* deltas, float* rgbv,
                      float* dist, float* alpha, int n_rays, int n_samples, int softplus_act,
                      int occ_alpha, int dist_alpha, int white_bg, void* stream) {
  CompositeFlags f{softplus_act, occ_alpha, dist_alpha, white_bg};
  composite_fwd_kernel<<<blocks_for(n_rays, 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      raw, z, deltas, rgbv, dist, alpha, n_rays, n_samples, f);
  return static_cast<int>(cudaGetLastError());
}

// One block per `rays` rays (>= 1), 16 * (rays * (n_samples | 1) + rays)
// bytes of shared memory (at most the card's 227 KB opt-in); raw and
// g_raw 16-byte aligned.
int nnt_composite_bwd_group(const float* raw, const float* z, const float* deltas,
                            const float* g_rgbv, const float* g_dist, const float* g_alpha,
                            float* g_raw, int n_rays, int n_samples, int rays,
                            int softplus_act, int occ_alpha, int dist_alpha, int white_bg,
                            void* stream) {
  if (rays < 1 || n_samples < 1 || reinterpret_cast<uintptr_t>(raw) % 16 ||
      reinterpret_cast<uintptr_t>(g_raw) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return 0;
  CompositeFlags f{softplus_act, occ_alpha, dist_alpha, white_bg};
  const size_t smem = sizeof(float) * (4 * (size_t)rays * (n_samples | 1) + 4 * (size_t)rays);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(composite_bwd_group_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  composite_bwd_group_kernel<<<blocks_for(n_rays, rays), CB_THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      raw, z, deltas, g_rgbv, g_dist, g_alpha, g_raw, n_rays, n_samples, rays, f);
  return static_cast<int>(cudaGetLastError());
}

// dw (k x n) f32 = denc[:, :k]^T @ gsum with gsum (n_rays x n) the per-ray sums
// of g (n_rays * n_samples x n, row stride ldg, bf16); n <= 1024. Scratch: gsum
// (n_rays x n) and partial (ceil(n_rays / rays) x k x n), f32.
int nnt_dir_wgrad(const void* denc, int ldd, int k, const void* g, int ldg, int n, int n_rays,
                  int n_samples, int rays, float* gsum, float* partial, float* dw,
                  void* stream) {
  if (n > 1024 || rays < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0 || k <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = (n + 31) / 32 * 32;
  const int splits = (n_rays + rays - 1) / rays;
  ray_sum_kernel<<<n_rays, threads, 0, st>>>(static_cast<const bf16*>(g), ldg, n, n_samples, gsum);
  dir_wgrad_kernel<<<dim3(k, splits), threads, 0, st>>>(static_cast<const bf16*>(denc), ldd, gsum,
                                                        n, n_rays, rays, partial);
  reduce_splits(partial, splits, (int64_t)k * n, dw, st);
  return static_cast<int>(cudaGetLastError());
}

// ge1, ge2 16-byte aligned with row strides ld1, ld2 multiples of 4 floats
// (each row is read as ceil(n_pos / 4) float4, up to its padding);
// n_dir <= MAX_ENC.
int nnt_encode_bwd_staged(const float* o, const float* r, const float* dirs, const float* z,
                          const float* ge1, int ld1, const float* ge2, int ld2, const float* gd,
                          int ldd, float* d_o, float* d_r, float* d_d, int n_rays, int n_samples,
                          int l_pos, int l_dir, void* stream) {
  const int n_pos = 3 * (2 * l_pos + 1), n_dir = 3 * (2 * l_dir + 1);
  const int row = eb_row_floats(n_pos) - 1;  // the floats of a row's float4
  if (n_dir > MAX_ENC || l_pos < 0 || l_dir < 0 || n_samples < 1 || ld1 % 4 || ld2 % 4 ||
      ld1 < row || ld2 < row || reinterpret_cast<uintptr_t>(ge1) % 16 ||
      reinterpret_cast<uintptr_t>(ge2) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return 0;
  const int smem = static_cast<int>(sizeof(float)) * eb_smem_floats(n_pos, n_dir);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(encode_bwd_staged_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  encode_bwd_staged_kernel<<<n_rays, EB_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      o, r, dirs, z, ge1, ld1, ge2, ld2, gd, ldd, d_o, d_r, d_d, n_rays, n_samples, l_pos,
      l_dir);
  return static_cast<int>(cudaGetLastError());
}

int nnt_head_act_bwd(const float* raw, const float* g_rgb, const float* g_density, float* g_raw,
                     int m, int softplus_act, int occ_alpha, void* stream) {
  CompositeFlags f{softplus_act, occ_alpha, 0, 0};
  head_act_bwd_kernel<<<blocks_for(m, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      raw, g_rgb, g_density, g_raw, m, f);
  return static_cast<int>(cudaGetLastError());
}

int nnt_encode_points_bwd(const float* x, const float* ge1, int ld1, const float* ge2, int ld2,
                          float* d_x, int rows, int levels, void* stream) {
  encode_points_bwd_kernel<<<blocks_for(rows, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ge1, ld1, ge2, ld2, d_x, rows, levels);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
