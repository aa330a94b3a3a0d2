// The reference pair of the training step: the two point clouds of the pc
// loss, the rgb_s reprojection of the earlier frame into the later one, and
// Kernel B's band starts, forward in one launch and backward in two.
//
// Replaces no TPU kernel: XLA fused this stretch of the JAX step
// (nope_nerf_tpu/training/trainer.py, compute_loss's reference-image branch)
// by itself. On the card the same stretch as tensor code was ~357 small
// launches (4x4 inverses through getrf/trsm, a radix sort for the band
// starts' medians, f32 SIMT GEMMs for (N, 3) x (3, 3) products, fills and
// gathers) and about as many again in its autograd backward.
//
// What bounds it on the H100: bytes, and few of them. The forward reads two
// small depth maps and one small image (0.13 + 0.39 MB at the stock 135x240
// clouds) and writes two clouds, the reprojected image, the mask and copies
// of the pair's images (~1.7 MB); the backward reads the three cotangents
// (1.2 MB). Under a microsecond of traffic each way; what is left is launch
// latency and one block barrier chain per group.
//
// Design:
// * ref_pair_fwd_kernel, one block per group of QB = 1024 consecutive points
//   (the band groups of Kernel B's queries): thread 0 builds the pair's 4x4
//   algebra in shared memory (rigid_inv(c2w_ref), the relative pose picked
//   by the frame order, camera_mat's inverse by Gauss-Jordan elimination),
//   then each thread takes two points through the distortion, the near-limit
//   clamp, the backprojection, the rotation, the rgb_s projection and its
//   align-corners bilinear tap, and writes X, Y, rgb_pc1_proj and the mask.
//   With band starts, the two row hints of its points go to shared memory
//   (non-finite ones, and the rows past the cloud's end, as 3.4e38), a
//   bitonic sort of both 1024-key arrays finds each group's median of the
//   finite hints, and two threads write the group's start tiles.
// * ref_pair_bwd_kernel, one thread a point (the forward recomputed, nothing
//   saved but the inputs): each point's share of the 41 sums the gradients
//   need (the relative rotation and translation, the inverse camera's and the
//   camera's first three rows, the two frames' scale and shift, the scale of
//   scale_pcs), a fixed xor-shuffle tree in each warp and the block's warps
//   added in order into one row of partial sums per block.
//   ref_pair_bwd_final_kernel, one block: the rows added in a fixed order,
//   then thread 0 takes the sums back through the 4x4 algebra to c2w,
//   world_mat, c2w_ref, camera_mat and the four scale / shift scalars. No
//   float atomics: a rerun is bitwise the same.
// * Rounding: every value the plain version computes elementwise is computed
//   here with the same operations in the same order, with explicit
//   round-to-nearest intrinsics so that nvcc contracts nothing into an FMA.
//   The small products (the 4x4 matrices, (N, 4) x (4, 4), (N, 3) x (3, 3))
//   are FMA chains in index order, which need not be cuBLAS's order: with
//   the stock camera matrix's zeros the backprojection and projection are
//   exact in any order, the rotations may differ from the plain version in
//   the last bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int QB = 1024;           // points a group: chamfer_band.QB
constexpr int TILE = 1024;         // Y rows a band tile: chamfer_band.TILE
constexpr int FWD_THREADS = 512;   // two points a thread
constexpr int BWD_THREADS = 256;   // one point a thread
constexpr int NSUM = 41;           // sums of the backward
constexpr float BIG = 3.4e38f;     // band_start_tiles' stand-in for a non-finite hint

enum Flags {
  LEARN_DIST = 1,    // distortion.learn_distortion: the depths are distorted
  SHIFT_FIRST = 2,   // training.shift_first: (d + shift) * scale
  RGB = 4,           // the rgb_s reprojection
  DETACH_RGBS = 8,   // training.detach_rgbs_scale: rgb_s moves no depth
  SCALE_PCS = 16,    // training.scale_pcs: both clouds over the later scale
};

// the layout of the backward's sums
constexpr int S_R = 0;     // 9: d/dR_rel (row major)
constexpr int S_T = 9;     // 3: d/dt_rel
constexpr int S_TI = 12;   // 12: d/d inv(camera_mat), rows 0-2
constexpr int S_K = 24;    // 12: d/d camera_mat, rows 0-2 (the projection)
constexpr int S_SC1 = 36, S_SH1 = 37, S_SC2 = 38, S_SH2 = 39, S_S2 = 40;

struct Index {             // a frame or row index: on the device, or a host int
  const long long* dev;
  long long host;
};

struct Args {
  const float* dsm;        // (T, hs, ws) small depth maps
  const float* ism;        // (T, hs, ws, 3) small images, or null without RGB
  Index idx;               // the current frame (the frame order reads it)
  Index dcur, dref;        // rows of the current and the reference frame in dsm
  Index icur, iref;        // and in ism
  const float* c2w;        // the current frame's 4x4 c2w and world_mat,
  const float* world;      // the reference's c2w, camera_mat
  const float* c2w_ref;
  const float* cam;
  const float* sc_cur;     // the four distortion scalars
  const float* sh_cur;
  const float* sc_ref;
  const float* sh_ref;
  int hs, ws, num_cams, flags, k_band;   // k_band 0: no band starts
  float nl;                // training.nearest_limit
};

struct Setup {             // the pair's algebra, built once a block
  float T[16];             // inv(camera_mat)
  float K[16];             // camera_mat
  float R[9], t[3];        // the relative pose Rt_rel_12
  float sc1, sh1, sc2, sh2;
  int swap;
  const float* d1;         // the earlier and the later frame's depth map
  const float* d2;
  const float* img1;       // and image (RGB only)
  const float* img2;
};

__device__ __forceinline__ long long read_index(const Index& i) {
  return i.dev != nullptr ? *i.dev : i.host;
}

// C = A @ B for row-major 4x4 matrices, each entry an FMA chain in k order
__device__ void mat4_mul(const float* A, const float* B, float* C) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float acc = __fmul_rn(A[i * 4], B[j]);
      for (int k = 1; k < 4; ++k) acc = __fmaf_rn(A[i * 4 + k], B[k * 4 + j], acc);
      C[i * 4 + j] = acc;
    }
}

// [[R^T, -R^T t], [0, 0, 0, 1]] of a rigid [[R, t], [0, 0, 0, 1]]
__device__ void rigid_inv(const float* M, float* out) {
  for (int i = 0; i < 3; ++i) {
    float acc = __fmul_rn(M[i], M[3]);
    acc = __fmaf_rn(M[4 + i], M[7], acc);
    acc = __fmaf_rn(M[8 + i], M[11], acc);
    for (int j = 0; j < 3; ++j) out[i * 4 + j] = M[j * 4 + i];
    out[i * 4 + 3] = -acc;
  }
  out[12] = out[13] = out[14] = 0.f;
  out[15] = 1.f;
}

// inverse of a 4x4 by Gauss-Jordan elimination with partial pivoting; rows
// whose factor is 0 are left as they are, so a diagonal matrix (the stock
// camera's) inverts to its correctly rounded reciprocals
__device__ void inv4(const float* A, float* out) {
  float a[4][8];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      a[i][j] = A[i * 4 + j];
      a[i][4 + j] = i == j ? 1.f : 0.f;
    }
  for (int c = 0; c < 4; ++c) {
    int p = c;
    for (int r = c + 1; r < 4; ++r)
      if (fabsf(a[r][c]) > fabsf(a[p][c])) p = r;
    if (p != c)
      for (int j = 0; j < 8; ++j) {
        const float tmp = a[c][j];
        a[c][j] = a[p][j];
        a[p][j] = tmp;
      }
    const float piv = a[c][c];
    for (int j = 0; j < 8; ++j) a[c][j] = __fdiv_rn(a[c][j], piv);
    for (int r = 0; r < 4; ++r) {
      const float f = a[r][c];
      if (r == c || f == 0.f) continue;
      for (int j = 0; j < 8; ++j) a[r][j] = __fsub_rn(a[r][j], __fmul_rn(f, a[c][j]));
    }
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) out[i * 4 + j] = a[i][4 + j];
}

__device__ void build_setup(const Args& a, Setup& s) {
  const long long idx = read_index(a.idx);
  s.swap = idx >= a.num_cams - 1;   // the pair is (earlier = 1, later = 2)
  float ref_rt[16], rt[16];
  if (s.swap) {
    mat4_mul(a.world, a.c2w_ref, rt);
  } else {
    rigid_inv(a.c2w_ref, ref_rt);
    mat4_mul(ref_rt, a.c2w, rt);
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) s.R[i * 3 + j] = rt[i * 4 + j];
    s.t[i] = rt[i * 4 + 3];
  }
  for (int i = 0; i < 16; ++i) s.K[i] = a.cam[i];
  inv4(a.cam, s.T);
  const float sc_cur = *a.sc_cur, sh_cur = *a.sh_cur;
  const float sc_ref = *a.sc_ref, sh_ref = *a.sh_ref;
  s.sc1 = s.swap ? sc_ref : sc_cur;
  s.sh1 = s.swap ? sh_ref : sh_cur;
  s.sc2 = s.swap ? sc_cur : sc_ref;
  s.sh2 = s.swap ? sh_cur : sh_ref;
  const long long n = static_cast<long long>(a.hs) * a.ws;
  const float* dc = a.dsm + read_index(a.dcur) * n;
  const float* dr = a.dsm + read_index(a.dref) * n;
  s.d1 = s.swap ? dr : dc;
  s.d2 = s.swap ? dc : dr;
  if (a.ism != nullptr) {
    const float* ic = a.ism + read_index(a.icur) * n * 3;
    const float* ir = a.ism + read_index(a.iref) * n * 3;
    s.img1 = s.swap ? ir : ic;
    s.img2 = s.swap ? ic : ir;
  } else {
    s.img1 = s.img2 = nullptr;
  }
}

// row . [h0, h1, h2, h3], an FMA chain in index order
__device__ __forceinline__ float dot4(const float* row, float h0, float h1, float h2, float h3) {
  float acc = __fmul_rn(h0, row[0]);
  acc = __fmaf_rn(h1, row[1], acc);
  acc = __fmaf_rn(h2, row[2], acc);
  return __fmaf_rn(h3, row[3], acc);
}

__device__ __forceinline__ float distort(float raw, float sc, float sh, int flags) {
  if (!(flags & LEARN_DIST)) return raw;
  return (flags & SHIFT_FIRST) ? __fmul_rn(__fadd_rn(raw, sh), sc)
                               : __fadd_rn(__fmul_rn(raw, sc), sh);
}

struct Point {
  float px, py;            // arange_pixels' scaled pixel
  float raw1, raw2;        // the depth maps' values
  float pre1, pre2;        // distorted, before the clamp
  float h1[3], h2[3];      // [px d, py d, d] of each frame
  float pc1[3], pc2[3];    // the backprojected clouds
  float xu[3];             // pc1 @ R^T + t, before scale_pcs
};

__device__ void point_fwd(const Args& a, const Setup& s, int p, Point& f) {
  const int r = p / a.ws, c = p - r * a.ws;
  // scale * loc / (w - 1) - shift with scale 2, shift 1
  f.px = __fsub_rn(__fdiv_rn(__fmul_rn(2.f, static_cast<float>(c)), static_cast<float>(a.ws - 1)), 1.f);
  f.py = __fsub_rn(__fdiv_rn(__fmul_rn(2.f, static_cast<float>(r)), static_cast<float>(a.hs - 1)), 1.f);
  f.raw1 = s.d1[p];
  f.raw2 = s.d2[p];
  f.pre1 = distort(f.raw1, s.sc1, s.sh1, a.flags);
  f.pre2 = distort(f.raw2, s.sc2, s.sh2, a.flags);
  const float d1 = f.pre1 < a.nl ? a.nl : f.pre1;   // clamp_min, NaN kept
  const float d2 = f.pre2 < a.nl ? a.nl : f.pre2;
  f.h1[0] = __fmul_rn(f.px, d1);
  f.h1[1] = __fmul_rn(f.py, d1);
  f.h1[2] = d1;
  f.h2[0] = __fmul_rn(f.px, d2);
  f.h2[1] = __fmul_rn(f.py, d2);
  f.h2[2] = d2;
  for (int i = 0; i < 3; ++i) {
    f.pc1[i] = dot4(s.T + 4 * i, f.h1[0], f.h1[1], f.h1[2], 1.f);
    f.pc2[i] = dot4(s.T + 4 * i, f.h2[0], f.h2[1], f.h2[2], 1.f);
  }
  for (int i = 0; i < 3; ++i) {
    float acc = __fmul_rn(f.pc1[0], s.R[i * 3]);
    acc = __fmaf_rn(f.pc1[1], s.R[i * 3 + 1], acc);
    acc = __fmaf_rn(f.pc1[2], s.R[i * 3 + 2], acc);
    f.xu[i] = __fadd_rn(acc, s.t[i]);
  }
}

// rgb_s's camera-frame point: xu, or (nl, nl, nl) behind the near limit
__device__ __forceinline__ bool clamp_near(const float* xu, float nl, float* q) {
  const bool invalid = -xu[2] < nl;
  for (int i = 0; i < 3; ++i) q[i] = invalid ? nl : xu[i];
  return invalid;
}

// project_to_cam: xh = K[:3] . [q, 1], (x, y) = xh[:2] / xh[2]
__device__ __forceinline__ void project(const float* K, const float* q, float* xh, float& x,
                                        float& y) {
  for (int i = 0; i < 3; ++i) xh[i] = dot4(K + 4 * i, q[0], q[1], q[2], 1.f);
  x = __fdiv_rn(xh[0], xh[2]);
  y = __fdiv_rn(xh[1], xh[2]);
}

// the row of the (hs, ws) grid that a point projecting to y falls on
__device__ __forceinline__ float row_hint(const float* K, const float* q, int hs) {
  float xh[3], x, y;
  project(K, q, xh, x, y);
  return __fmul_rn(__fmul_rn(__fadd_rn(y, 1.f), 0.5f), static_cast<float>(hs - 1));
}

struct Taps {              // grid_sample's bilinear taps, align_corners
  float wx[2], wy[2];
  int xi[2], yi[2];        // clamped indices
  float inb[2][2];         // [x tap][y tap] inside the image
};

__device__ void bilinear_taps(float x, float y, int H, int W, Taps& t) {
  const float fx = __fmul_rn(__fdiv_rn(__fadd_rn(x, 1.f), 2.f), static_cast<float>(W - 1));
  const float fy = __fmul_rn(__fdiv_rn(__fadd_rn(y, 1.f), 2.f), static_cast<float>(H - 1));
  const float x0 = floorf(fx), y0 = floorf(fy);
  t.wx[1] = __fsub_rn(fx, x0);
  t.wy[1] = __fsub_rn(fy, y0);
  t.wx[0] = __fsub_rn(1.f, t.wx[1]);
  t.wy[0] = __fsub_rn(1.f, t.wy[1]);
  float xs[2] = {x0, x0 + 1.f}, ys[2] = {y0, y0 + 1.f};
  for (int k = 0; k < 2; ++k) {
    t.xi[k] = static_cast<int>(fminf(fmaxf(xs[k], 0.f), static_cast<float>(W - 1)));
    t.yi[k] = static_cast<int>(fminf(fmaxf(ys[k], 0.f), static_cast<float>(H - 1)));
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      t.inb[i][j] = (xs[i] >= 0.f && xs[i] < W && ys[j] >= 0.f && ys[j] < H) ? 1.f : 0.f;
}

__global__ void __launch_bounds__(FWD_THREADS)
ref_pair_fwd_kernel(Args a, float* __restrict__ X, float* __restrict__ Y, float* __restrict__ rgb,
                    float* __restrict__ valid, float* __restrict__ img1_out,
                    float* __restrict__ img2_out, int* __restrict__ starts) {
  __shared__ Setup s;
  __shared__ float keys[2][QB];
  __shared__ int n_fin[2];
  const int n = a.hs * a.ws;
  if (threadIdx.x == 0) {
    build_setup(a, s);
    n_fin[0] = n_fin[1] = 0;
  }
  __syncthreads();
  const int base = blockIdx.x * QB;
  const bool scale_pcs = a.flags & SCALE_PCS;
  int fin[2] = {0, 0};
  for (int j = 0; j < QB / FWD_THREADS; ++j) {
    const int l = threadIdx.x + j * FWD_THREADS, p = base + l;
    float hint[2] = {NAN, NAN};   // the rows past the cloud's end: NaN padding
    if (p < n) {
      Point f;
      point_fwd(a, s, p, f);
      for (int i = 0; i < 3; ++i) {
        X[p * 3 + i] = scale_pcs ? __fdiv_rn(f.xu[i], s.sc2) : f.xu[i];
        Y[p * 3 + i] = scale_pcs ? __fdiv_rn(f.pc2[i], s.sc2) : f.pc2[i];
      }
      if (a.flags & RGB) {
        float q[3], xh[3], x, y;
        clamp_near(f.xu, a.nl, q);
        project(s.K, q, xh, x, y);
        valid[p] = (fabsf(x) <= 1.f && fabsf(y) <= 1.f) ? 1.f : 0.f;
        Taps t;
        bilinear_taps(x, y, a.hs, a.ws, t);
        float out[3] = {0.f, 0.f, 0.f};
        for (int xk = 0; xk < 2; ++xk)
          for (int yk = 0; yk < 2; ++yk) {
            const float w = __fmul_rn(__fmul_rn(t.wx[xk], t.wy[yk]), t.inb[xk][yk]);
            const float* v = s.img2 + (t.yi[yk] * a.ws + t.xi[xk]) * 3;
            for (int ch = 0; ch < 3; ++ch) out[ch] = __fadd_rn(out[ch], __fmul_rn(v[ch], w));
          }
        for (int ch = 0; ch < 3; ++ch) rgb[p * 3 + ch] = out[ch];
      }
      if (a.k_band > 0) {
        // X's rows in Y's grid; Y's (q21 = (pc2 - t) @ R) in X's
        hint[0] = row_hint(s.K, f.xu, a.hs);
        float u[3], q21[3];
        for (int i = 0; i < 3; ++i) u[i] = __fsub_rn(f.pc2[i], s.t[i]);
        for (int k = 0; k < 3; ++k) {
          float acc = __fmul_rn(u[0], s.R[k]);
          acc = __fmaf_rn(u[1], s.R[3 + k], acc);
          q21[k] = __fmaf_rn(u[2], s.R[6 + k], acc);
        }
        hint[1] = row_hint(s.K, q21, a.hs);
      }
    }
    if (a.k_band > 0)
      for (int c = 0; c < 2; ++c) {
        const bool ok = isfinite(hint[c]);
        keys[c][l] = ok ? hint[c] : BIG;
        fin[c] += ok;
      }
  }
  if (a.k_band > 0) {
    atomicAdd(&n_fin[0], fin[0]);
    atomicAdd(&n_fin[1], fin[1]);
    __syncthreads();
    // bitonic sort of both key arrays, ascending
    for (int k = 2; k <= QB; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        const int t = threadIdx.x;
        const int i = 2 * t - (t & (j - 1)), m = i + j;
        const bool up = (i & k) == 0;
        for (int c = 0; c < 2; ++c) {
          const float lo = keys[c][i], hi = keys[c][m];
          if ((lo > hi) == up) {
            keys[c][i] = hi;
            keys[c][m] = lo;
          }
        }
        __syncthreads();
      }
    if (threadIdx.x < 2) {
      const int c = threadIdx.x, nf = n_fin[c];
      const int mi = min(max((nf - 1) >> 1, 0), QB - 1);   // (nf - 1) // 2, clamped
      const float med = nf > 0 ? keys[c][mi] : 0.f;
      const float centre = __fmul_rn(med, static_cast<float>(a.ws));
      const int n_tiles = (n + TILE - 1) / TILE;
      int st = static_cast<int>(rintf(__fdiv_rn(centre, static_cast<float>(TILE)))) - a.k_band / 2;
      st = min(max(st, 0), max(n_tiles - a.k_band, 0));
      starts[c * gridDim.x + blockIdx.x] = st;
    }
  }
  if (a.flags & RGB) {
    const int end = min(base + QB, n) * 3;
    for (int e = base * 3 + threadIdx.x; e < end; e += FWD_THREADS) {
      img1_out[e] = s.img1[e];
      if (img2_out != nullptr) img2_out[e] = s.img2[e];
    }
  }
}

// one point's share of the backward's sums
__device__ void point_bwd(const Args& a, const Setup& s, int p, const float* __restrict__ gX,
                          const float* __restrict__ gY, const float* __restrict__ gO,
                          float* acc) {
  Point f;
  point_fwd(a, s, p, f);
  float gxu[3], gp2[3], gp1[3];
  if (a.flags & SCALE_PCS) {
    const float s2 = s.sc2;
    float gs2 = 0.f;
    for (int i = 0; i < 3; ++i) {
      const float gx = gX[p * 3 + i], gy = gY[p * 3 + i];
      gxu[i] = gx / s2;
      gp2[i] = gy / s2;
      gs2 -= gx * (__fdiv_rn(f.xu[i], s2) / s2) + gy * (__fdiv_rn(f.pc2[i], s2) / s2);
    }
    acc[S_S2] += gs2;
  } else {
    for (int i = 0; i < 3; ++i) {
      gxu[i] = gX[p * 3 + i];
      gp2[i] = gY[p * 3 + i];
    }
  }
  // X = pc1 @ R^T + t
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) acc[S_R + i * 3 + j] += gxu[i] * f.pc1[j];
    acc[S_T + i] += gxu[i];
  }
  for (int j = 0; j < 3; ++j)
    gp1[j] = gxu[0] * s.R[j] + gxu[1] * s.R[3 + j] + gxu[2] * s.R[6 + j];
  if (a.flags & RGB) {
    float q[3], xh[3], x, y;
    const bool invalid = clamp_near(f.xu, a.nl, q);
    project(s.K, q, xh, x, y);
    Taps t;
    bilinear_taps(x, y, a.hs, a.ws, t);
    const float* g = gO + p * 3;
    float gwx[2] = {0.f, 0.f}, gwy[2] = {0.f, 0.f};
    for (int xk = 0; xk < 2; ++xk)
      for (int yk = 0; yk < 2; ++yk) {
        const float* v = s.img2 + (t.yi[yk] * a.ws + t.xi[xk]) * 3;
        const float gw = (g[0] * v[0] + g[1] * v[1] + g[2] * v[2]) * t.inb[xk][yk];
        gwx[xk] += gw * t.wy[yk];
        gwy[yk] += gw * t.wx[xk];
      }
    // fx = (x + 1) / 2 * (W - 1); wx1 = fx - floor(fx), wx0 = 1 - wx1
    const float gx = (gwx[1] - gwx[0]) * static_cast<float>(a.ws - 1) * 0.5f;
    const float gy = (gwy[1] - gwy[0]) * static_cast<float>(a.hs - 1) * 0.5f;
    const float gxh[3] = {gx / xh[2], gy / xh[2], -(gx * x + gy * y) / xh[2]};
    const float qh[4] = {q[0], q[1], q[2], 1.f};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 4; ++j) acc[S_K + i * 4 + j] += gxh[i] * qh[j];
    if (!invalid) {
      float gq[3];
      for (int j = 0; j < 3; ++j)
        gq[j] = gxh[0] * s.K[j] + gxh[1] * s.K[4 + j] + gxh[2] * s.K[8 + j];
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) acc[S_R + i * 3 + j] += gq[i] * f.pc1[j];
        acc[S_T + i] += gq[i];
      }
      if (!(a.flags & DETACH_RGBS))
        for (int j = 0; j < 3; ++j)
          gp1[j] += gq[0] * s.R[j] + gq[1] * s.R[3 + j] + gq[2] * s.R[6 + j];
    }
  }
  // pc = inv(camera_mat)[:3] . [px d, py d, d, 1], d = clamp_min(distorted, nl)
  const float* gps[2] = {gp1, gp2};
  const float* hrow[2] = {f.h1, f.h2};
  const float pre[2] = {f.pre1, f.pre2}, raw[2] = {f.raw1, f.raw2};
  const float sc[2] = {s.sc1, s.sc2}, sh[2] = {s.sh1, s.sh2};
  for (int c = 0; c < 2; ++c) {
    const float* gp = gps[c];
    const float* h = hrow[c];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) acc[S_TI + i * 4 + j] += gp[i] * h[j];
      acc[S_TI + i * 4 + 3] += gp[i];
    }
    float gh[3];
    for (int j = 0; j < 3; ++j)
      gh[j] = gp[0] * s.T[j] + gp[1] * s.T[4 + j] + gp[2] * s.T[8 + j];
    float gd = gh[0] * f.px + gh[1] * f.py + gh[2];
    if (!(pre[c] >= a.nl)) gd = 0.f;   // clamp_min passes where d >= nl
    if (a.flags & LEARN_DIST) {
      if (a.flags & SHIFT_FIRST) {
        acc[S_SC1 + 2 * c] += gd * __fadd_rn(raw[c], sh[c]);
        acc[S_SH1 + 2 * c] += gd * sc[c];
      } else {
        acc[S_SC1 + 2 * c] += gd * raw[c];
        acc[S_SH1 + 2 * c] += gd;
      }
    }
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
ref_pair_bwd_kernel(Args a, const float* __restrict__ gX, const float* __restrict__ gY,
                    const float* __restrict__ gO, float* __restrict__ partial) {
  __shared__ Setup s;
  __shared__ float warp_sums[BWD_THREADS / 32][NSUM];
  if (threadIdx.x == 0) build_setup(a, s);
  __syncthreads();
  float acc[NSUM];
#pragma unroll
  for (int v = 0; v < NSUM; ++v) acc[v] = 0.f;
  const int p = blockIdx.x * BWD_THREADS + threadIdx.x;
  if (p < a.hs * a.ws) point_bwd(a, s, p, gX, gY, gO, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NSUM; ++v) {
    float x = acc[v];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) warp_sums[warp][v] = x;
  }
  __syncthreads();
  if (threadIdx.x < NSUM) {
    float x = warp_sums[0][threadIdx.x];
    for (int w = 1; w < BWD_THREADS / 32; ++w) x += warp_sums[w][threadIdx.x];
    partial[blockIdx.x * NSUM + threadIdx.x] = x;
  }
}

constexpr int FINAL_WARPS = 16;

// G (4x4, row 3 zero) from the sums' rotation and translation
__device__ void rt_grad(const float* sum, float* G) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) G[i * 4 + j] = sum[S_R + i * 3 + j];
    G[i * 4 + 3] = sum[S_T + i];
  }
  G[12] = G[13] = G[14] = G[15] = 0.f;
}

// C = A @ B^T, C = A^T @ B (4x4, plain sums)
__device__ void mul_bt(const float* A, const float* B, float* C) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float x = 0.f;
      for (int k = 0; k < 4; ++k) x += A[i * 4 + k] * B[j * 4 + k];
      C[i * 4 + j] = x;
    }
}

__device__ void mul_at(const float* A, const float* B, float* C) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float x = 0.f;
      for (int k = 0; k < 4; ++k) x += A[k * 4 + i] * B[k * 4 + j];
      C[i * 4 + j] = x;
    }
}

// out: d/dc2w (16), d/dworld_mat (16), d/dc2w_ref (16), d/dscale_cur,
// d/dshift_cur, d/dscale_ref, d/dshift_ref, d/dcamera_mat (16)
__global__ void __launch_bounds__(32 * FINAL_WARPS)
ref_pair_bwd_final_kernel(Args a, const float* __restrict__ partial, int n_blocks,
                          float* __restrict__ out) {
  __shared__ float sum[NSUM];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int v = warp; v < NSUM; v += FINAL_WARPS) {
    float x = 0.f;
    for (int b = lane; b < n_blocks; b += 32) x += partial[b * NSUM + v];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) sum[v] = x;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  Setup s;
  build_setup(a, s);
  float G[16], gc2w[16], gworld[16], gref[16];
  rt_grad(sum, G);
  for (int i = 0; i < 16; ++i) gc2w[i] = gworld[i] = gref[i] = 0.f;
  if (s.swap) {
    // Rt = world_mat @ c2w_ref
    mul_bt(G, a.c2w_ref, gworld);
    mul_at(a.world, G, gref);
  } else {
    // Rt = rigid_inv(c2w_ref) @ c2w
    float ref_rt[16], g_rt[16];
    rigid_inv(a.c2w_ref, ref_rt);
    mul_bt(G, a.c2w, g_rt);
    mul_at(ref_rt, G, gc2w);
    // rigid_inv's [[R^T, -R^T t]]: R^T's gradient, then -R^T t's
    const float* M = a.c2w_ref;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) gref[i * 4 + j] = g_rt[j * 4 + i];
    for (int k = 0; k < 3; ++k) {
      float gt = 0.f;
      for (int i = 0; i < 3; ++i) {
        const float gb = -g_rt[i * 4 + 3];
        gref[k * 4 + i] += gb * M[k * 4 + 3];
        gt += M[k * 4 + i] * gb;
      }
      gref[k * 4 + 3] = gt;
    }
  }
  // scale_pcs' scale is the later frame's distortion scale
  const float g1[2] = {sum[S_SC1], sum[S_SH1]};
  const float g2[2] = {sum[S_SC2] + sum[S_S2], sum[S_SH2]};
  const float* gcur = s.swap ? g2 : g1;
  const float* gr = s.swap ? g1 : g2;
  // camera_mat: the projection's rows, and inv's -T^T dT T^T
  float dT[16], tmp[16], gk[16];
  for (int i = 0; i < 16; ++i) dT[i] = i < 12 ? sum[S_TI + i] : 0.f;
  mul_at(s.T, dT, tmp);    // T^T dT
  mul_bt(tmp, s.T, gk);    // (T^T dT) T^T
  for (int i = 0; i < 16; ++i) gk[i] = -gk[i] + (i < 12 ? sum[S_K + i] : 0.f);
  for (int i = 0; i < 16; ++i) {
    out[i] = gc2w[i];
    out[16 + i] = gworld[i];
    out[32 + i] = gref[i];
    out[52 + i] = gk[i];
  }
  out[48] = gcur[0];
  out[49] = gcur[1];
  out[50] = gr[0];
  out[51] = gr[1];
}

Args make_args(const float* dsm, const float* ism, const long long* idx_p, int idx_h,
               const long long* dcur_p, int dcur_h, const long long* dref_p, int dref_h,
               const long long* icur_p, int icur_h, const long long* iref_p, int iref_h,
               const float* c2w, const float* world, const float* c2w_ref, const float* cam,
               const float* sc_cur, const float* sh_cur, const float* sc_ref,
               const float* sh_ref, int hs, int ws, int num_cams, int flags, int k_band,
               float nl) {
  Args a;
  a.dsm = dsm;
  a.ism = ism;
  a.idx = {idx_p, idx_h};
  a.dcur = {dcur_p, dcur_h};
  a.dref = {dref_p, dref_h};
  a.icur = {icur_p, icur_h};
  a.iref = {iref_p, iref_h};
  a.c2w = c2w;
  a.world = world;
  a.c2w_ref = c2w_ref;
  a.cam = cam;
  a.sc_cur = sc_cur;
  a.sh_cur = sh_cur;
  a.sc_ref = sc_ref;
  a.sh_ref = sh_ref;
  a.hs = hs;
  a.ws = ws;
  a.num_cams = num_cams;
  a.flags = flags;
  a.k_band = k_band;
  a.nl = nl;
  return a;
}

bool bad_args(int hs, int ws, int flags, const float* ism) {
  return hs < 1 || ws < 1 || static_cast<long long>(hs) * ws > (1LL << 30) ||
         ((flags & RGB) && ism == nullptr);
}

}  // namespace

#define PAIR_PARAMS                                                                              \
  const float *dsm, const float *ism, const long long *idx_p, int idx_h,                        \
      const long long *dcur_p, int dcur_h, const long long *dref_p, int dref_h,                  \
      const long long *icur_p, int icur_h, const long long *iref_p, int iref_h,                  \
      const float *c2w, const float *world, const float *c2w_ref, const float *cam,              \
      const float *sc_cur, const float *sh_cur, const float *sc_ref, const float *sh_ref, int hs, \
      int ws, int num_cams, int flags, int k_band, float nl
#define PAIR_ARGS                                                                            \
  make_args(dsm, ism, idx_p, idx_h, dcur_p, dcur_h, dref_p, dref_h, icur_p, icur_h, iref_p, \
            iref_h, c2w, world, c2w_ref, cam, sc_cur, sh_cur, sc_ref, sh_ref, hs, ws, num_cams, \
            flags, k_band, nl)

// The forward: X, Y (n, 3); with RGB rgb (n, 3), valid (n,), img1 (n, 3) and,
// unless null, img2 (n, 3); with k_band > 0 starts (2, ceil(n / 1024)), the
// X groups' then the Y groups'. n = hs * ws.
extern "C" int nnt_ref_pair_fwd(PAIR_PARAMS, float* X, float* Y, float* rgb, float* valid,
                                float* img1, float* img2, int* starts, void* stream) {
  if (bad_args(hs, ws, flags, ism) || k_band < 0 ||
      ((flags & RGB) && (rgb == nullptr || valid == nullptr || img1 == nullptr)) ||
      (k_band > 0 && starts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (hs * ws + QB - 1) / QB;
  ref_pair_fwd_kernel<<<groups, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      PAIR_ARGS, X, Y, rgb, valid, img1, img2, starts);
  return static_cast<int>(cudaGetLastError());
}

// The backward from the cotangents of X, Y and (RGB) rgb: out (68 floats)
// as ref_pair_bwd_final_kernel lays it out; scratch ceil(n / 256) * 41
// floats (ops/kernels/ref_pair.py::_scratch_floats).
extern "C" int nnt_ref_pair_bwd(PAIR_PARAMS, const float* gX, const float* gY, const float* gO,
                                float* scratch, float* out, void* stream) {
  if (bad_args(hs, ws, flags, ism) || ((flags & RGB) && gO == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (hs * ws + BWD_THREADS - 1) / BWD_THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a = PAIR_ARGS;
  ref_pair_bwd_kernel<<<blocks, BWD_THREADS, 0, st>>>(a, gX, gY, gO, scratch);
  ref_pair_bwd_final_kernel<<<1, 32 * FINAL_WARPS, 0, st>>>(a, scratch, blocks, out);
  return static_cast<int>(cudaGetLastError());
}
