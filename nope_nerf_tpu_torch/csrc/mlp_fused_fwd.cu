// Kernels A and C forward on Hopper in one launch: the encodings, the ten
// layer GEMMs of the NeRF MLP with the activation tile in shared memory, the
// two heads, and the compositing (A) or the head activations (C).
//
// Replaces, per forward, the Pallas kernels of
// nope_nerf_tpu/ops/pallas/mlp_kernel.py
//   A forward  _make_fwd_composite_kernel (l.668), reached from
//              fused_mlp_composite -> _fused_mlp_composite_call (l.852);
//   C forward  _make_fwd_kernel (l.244), reached from fused_mlp ->
//              _fused_mlp_call (l.387);
// both over _fwd_chain (l.170). The TPU kernel keeps a point tile's
// encoding, trunk, skip concat, heads and compositing in VMEM, so its HBM
// traffic is the points in and the per-ray outputs out. The layer-by-layer
// forward this kernel takes over (encode_fwd, eleven gemm_sm90 launches,
// heads_fwd, composite_fwd) wrote and read every activation in device
// memory instead.
//
// What bounds it on the H100: without saves, the operations -- 2 M sum(K N)
// = 155.6 GFLOP at the stock M = 131,072 points, 0.157 ms at the bf16 peak;
// the points in and the outputs out are a few MB. With saves (a forward
// whose backward will run), the bytes: the eight trunk outputs, feat, hr,
// enc, denc and raw, ~657 MB at M = 131,072, 0.196 ms at 3.35 TB/s.
//
// Design: one persistent block per SM walks 128-point tiles (stride
// gridDim.x); two consumer warpgroups own 64 rows each; a producer
// warpgroup gives its registers to them (setmaxnreg) and one of its threads
// streams the weights.
//   * Encoding in the kernel: pts = o + r z (A: per-ray inputs, no FMA
//     contraction, as encode_points_kernel) or the given points (C);
//     [x, sin 2^l x, cos 2^l x] with f32 arguments, rounded to bf16, written
//     straight into shared memory in the 128-byte-swizzled K-major layout
//     wgmma reads (and TMA writes), zero past the true width. The position
//     encoding stays in its tile for trunk1_0's skip half; the direction
//     encoding (per point; A repeats its ray's) then takes the same tile for
//     rgb_layer's direction half.
//   * The chain in shared memory: one bf16 tile of 128 rows x D is the A
//     operand of every layer. Each warpgroup issues m64nDk16 wgmmas into a
//     D / 2-register f32 accumulator, one k-tile in flight; the epilogue adds
//     the f32 bias (staged in shared memory: global loads missed the L1 that
//     the tiles leave), takes the ReLU, rounds to bf16 and writes back over
//     the warpgroup's own rows once its products have retired -- the
//     operations, in their order, of gemm_sm90_kernel's epilogue, so every
//     activation is bitwise that of the layer-by-layer chain.
//   * trunk1_0 is two operand pairs (activation K = D, then the encoding,
//     K <= 63 -> 64 zero-filled), as gemm_fwd's a2. rgb_layer's direction
//     half (per point the f32 value the row-term GEMM gives per ray) and its
//     feature half run into accumulators of their own (one accumulator's
//     halves as the two operands made ptxas serialize the wgmmas), added as
//     gemm_fwd adds its row term: (acc + row term) + bias.
//   * Weights: the producer streams each layer's K-major (N x 64) k-tiles
//     through a 4-stage TMA + mbarrier ring (4 x 32 KB at D = 256); the
//     1.2 MB of weights stay in L2. Their 1.28 GB of L2 reads per forward at
//     M = 131,072 cost ~2% (no reload after a block's first tile ran 0.012
//     ms faster on the H100), so no cluster multicasts them.
//   * Heads: fc_density on trunk1_3's output and fc_rgb on hr, a warp per
//     point over the warp's own 16 rows, in heads_fwd_kernel's order (raw is
//     bitwise the layer-by-layer one).
//   * Compositing (A, 128 % S == 0): a tile holds 128 / S whole rays. Each
//     row's alpha and sigmoids are taken in parallel; once warpgroup 0's rows
//     are in, one thread of warpgroup 1 per ray runs composite_fwd_kernel's
//     scan in its operation order, so rgbv, dist and alpha are bitwise those
//     of composite_fwd. Any other S takes the raw route, chosen by shape in
//     the wrapper: this kernel writes raw and mlp_composite.cu's
//     composite_fwd runs after it.
//   * Saves only when a backward will read them: with `save`, TMA stores
//     (from the tile a layer just wrote; the issuing thread waits for the
//     read before the tile is overwritten) exactly what _chain_bwd reads, in
//     its shapes, dtypes and row strides, under an evict-first L2 policy
//     (without it the 657 MB of saves pushed the working set out of L2 and
//     the saving forward took 0.73 ms instead of 0.43). Without `save` (the
//     eval render, Phong's surface colour, any forward under no_grad) only
//     the outputs leave the SM.
//   * Tensor maps are __grid_constant__ parameters; nothing synchronises
//     with the host, so the launch is capturable in a CUDA graph.
// Shared memory at D = 256: 64 KB activation tile + 16 KB encoding tile +
// 128 KB ring + ~18 KB of biases, heads and compositing: one block per SM.

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;                  // points per tile
constexpr int ROW_BYTES = 128;           // one swizzle row: 64 bf16
constexpr int KB_BYTES = BM * ROW_BYTES;  // a 64-column k-block of a tile
constexpr int WG_ROWS = 64;              // rows per consumer warpgroup
constexpr int WG_BYTES = WG_ROWS * ROW_BYTES;
constexpr int CONSUMERS = 256;           // two warpgroups
// + a producer warpgroup, which gives its registers to the consumers
// (setmaxnreg); one of its threads issues the weight loads
constexpr int THREADS = CONSUMERS + 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STAGES = 4;

// weight tensor maps, in the order the ring streams them
enum { W_T00, W_T01, W_T02, W_T03, W_T10, W_T10E, W_T11, W_T12, W_T13, W_FEAT, W_RGBD, W_RGB,
       N_WMAPS };
// save tensor maps: the eight trunk outputs, feat, hr, enc, denc (C)
enum { S_ACT0 = 0, S_FEAT = 8, S_HR = 9, S_ENC = 10, S_DENC = 11, N_SMAPS = 12 };
// what a launch computes after the heads
enum { MODE_COMPOSITE = 0, MODE_RAW = 1, MODE_POINTS = 2 };

struct Maps {
  CUtensorMap w[N_WMAPS];
  CUtensorMap s[N_SMAPS];
};

struct Flags {
  int softplus_act, occ_alpha, dist_alpha, white_bg;
};

struct Args {
  const float* x0;      // A: origins (N, 3); C: points (M, 3)
  const float* x1;      // A: ray directions (N, 3)
  const float* dirs;    // A: view directions (N, 3); C: (M, 3)
  const float* z;       // A: (N, S)
  const float* deltas;  // A: (N, S)
  const float* bias[10];
  const bf16* wd;  // fc_density (D, 1)
  const float* bd;
  const bf16* wc;  // fc_rgb (D / 2, 3)
  const float* bc;
  float* out0;   // A: rgbv (N, 3); C: rgb (M, 3)
  float* out1;   // A: dist (N, 1); C: density (M, 1)
  float* alpha;  // A: (N, S)
  float* raw;    // (M, 4) or null
  bf16* denc_rays;  // A's saved per-ray direction encoding (N, ld_denc) or null
  int ld_denc;
  int m, n_rays, S, l_pos, l_dir, mode, save;
  Flags f;
};

template <int D>
struct Smem {
  static constexpr int KT = D / 64;  // k-tiles of a D-wide operand
  static constexpr int STAGE = D * ROW_BYTES;
  static constexpr int ACT = 0;
  static constexpr int ENC = KT * KB_BYTES;  // the position, then the direction encoding
  static constexpr int RING = ENC + KB_BYTES;
  static constexpr int RAW = RING + STAGES * STAGE;  // float4 [BM]
  static constexpr int COMP = RAW + BM * 16;         // float4 [2][BM]
  static constexpr int ZS = COMP + 2 * BM * 16;      // float [2][BM]
  static constexpr int WD = ZS + 2 * BM * 4;         // bf16 [D]
  static constexpr int WC = WD + D * 2;              // bf16 [D / 2][3]
  static constexpr int BIAS = (WC + 3 * (D / 2) * 2 + 15) / 16 * 16;  // f32 [9][D], [D / 2]
  static constexpr int BAR = BIAS + (9 * D + D / 2) * 4;
  static constexpr int BYTES = 1024 + BAR + 2 * STAGES * 8;
};

// ---------------------------------------------------------------------------
// PTX wrappers of this kernel (the shared ones are in sm90.cuh)
// ---------------------------------------------------------------------------

// with an evict-first L2 policy: the saves stream through L2 to device
// memory and leave the weights and the other SMs' lines in place
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int x, int y) {
  asm volatile(
      "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%2, %3}], [%1], pol;\n}\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y)
      : "memory");
}

// barrier 3 across the two consumer warpgroups: warpgroup 1 waits (sync)
// for warpgroup 0's rows, warpgroup 0 only signals (arrive)
__device__ __forceinline__ void pair_sync() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); }
__device__ __forceinline__ void pair_arrive() {
  asm volatile("bar.arrive 3, 256;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The weight ring: the producer's TMA loads and the consumers' k-tiles
// ---------------------------------------------------------------------------

struct Ring {
  uint32_t buf;  // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
  int stage;
  uint32_t phase;
  int held;  // the stage whose products may still be in flight, or -1
};

__device__ __forceinline__ void ring_advance(int& stage, uint32_t& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// One k-tile of a layer: wait for its weights, issue its four k16 products
// acc (+)= A (this warpgroup's 64 rows of the k-block at shared
// address `a`) @ B^T with B the stage's (N x 64) K-major weight k-tile, and
// release the previous k-tile's stage once its products have retired (one
// k-tile stays in flight). `zero`: the first k-tile of the accumulator.
template <int N, int STAGE>
__device__ __forceinline__ void mma_ktile(float (&acc)[N / 2], uint32_t a, Ring& ring, bool zero) {
  mbar_wait(smem_u32(ring.full + ring.stage), ring.phase);
  const uint32_t b = ring.buf + static_cast<uint32_t>(ring.stage * STAGE);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // 16 bf16 = 32 bytes along the swizzled row
    wgmma_bf16<0>(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32),
                       (zero && kk == 0) ? 0 : 1);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(acc);
  if (ring.held >= 0) mbar_arrive(smem_u32(ring.empty + ring.held));
  ring.held = ring.stage;
  ring_advance(ring.stage, ring.phase);
}

// the end of a layer's k-tiles: every product retired, the last stage free
template <int R>
__device__ __forceinline__ void mma_drain(float (&acc)[R], Ring& ring) {
  wgmma_wait<0>();
  fence_regs(acc);
  if (ring.held >= 0) mbar_arrive(smem_u32(ring.empty + ring.held));
  ring.held = -1;
}

// The producer thread: every tile's 39 (D = 256) weight k-tiles, in the
// order the consumers run the chain, each an (N x 64) box of a layer's
// K-major weight (N = D, or D / 2 for rgb_layer).
template <int D>
__device__ __forceinline__ void produce(const Maps& maps, int tiles, uint32_t buf, uint64_t* full,
                                        uint64_t* empty) {
  constexpr int KT = D / 64, STAGE = Smem<D>::STAGE;
  int stage = 0;
  uint32_t phase = 0;
  auto load = [&](int map, int kx, uint32_t bytes) {
    const uint32_t fb = smem_u32(full + stage);
    mbar_wait(smem_u32(empty + stage), phase ^ 1);  // the first pass is free
    mbar_expect_tx(fb, bytes);
    tma_load(buf + stage * STAGE, &maps.w[map], fb, kx, 0);
    ring_advance(stage, phase);
  };
  constexpr uint32_t FULL = D * ROW_BYTES, HALF = (D / 2) * ROW_BYTES;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    load(W_T00, 0, FULL);
    for (int map = W_T01; map <= W_T03; ++map)
      for (int j = 0; j < KT; ++j) load(map, 64 * j, FULL);
    for (int j = 0; j < KT; ++j) load(W_T10, 64 * j, FULL);
    load(W_T10E, 0, FULL);
    for (int map = W_T11; map <= W_FEAT; ++map)
      for (int j = 0; j < KT; ++j) load(map, 64 * j, FULL);
    load(W_RGBD, 0, HALF);
    for (int j = 0; j < KT; ++j) load(W_RGB, 64 * j, HALF);
  }
}

// ---------------------------------------------------------------------------
// Tiles in shared memory: byte offset of (row, col) of a 128-row bf16 tile
// stored as 64-column k-blocks of 128-byte rows, 16-byte chunk c of row r at
// chunk c ^ (r % 8) -- the layout of a 128-byte-swizzle TMA box and of a
// wgmma K-major operand.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int sw_off(int row, int col) {
  const int b = (col & 63) * 2;
  return (col >> 6) * KB_BYTES + row * ROW_BYTES + ((((b >> 4) ^ (row & 7)) << 4) | (b & 15));
}

__device__ __forceinline__ float tile_at(const uint8_t* tile, int row, int col) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + sw_off(row, col)));
}

// ---------------------------------------------------------------------------
// Encoding (encode_one of mlp_composite.cu, written into a tile)
// ---------------------------------------------------------------------------

// pts = o + r * z rounded after the product and after the sum (no FMA)
__device__ __forceinline__ float expand(float o, float r, float z) {
  return __fadd_rn(o, __fmul_rn(r, z));
}

// Half of one row's encoding [x, sin 2^l x, cos 2^l x] of p (levels levels)
// into the 64 columns of `tile`'s row: half 0 x and the lower levels, half 1
// the upper levels and zeros up to column 64. `out` (or null) receives the
// same bf16 values in a global row.
__device__ __forceinline__ void encode_half(const float (&p)[3], int levels, int half,
                                            uint8_t* tile, int row, bf16* out) {
  auto put = [&](int col, float v) {
    const bf16 h = __float2bfloat16_rn(v);
    *reinterpret_cast<bf16*>(tile + sw_off(row, col)) = h;
    if (out) out[col] = h;
  };
  const int split = (levels + 1) / 2;
  if (half == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) put(c, p[c]);
  }
  for (int l = half ? split : 0; l < (half ? levels : split); ++l) {
    const float f = ldexpf(1.f, l);  // exact power of two
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s, co;
      sincosf(p[c] * f, &s, &co);
      put(3 * (1 + 2 * l) + c, s);
      put(3 * (2 + 2 * l) + c, co);
    }
  }
  if (half == 1) {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int col = 3 * (2 * levels + 1); col < 64; ++col)
      *reinterpret_cast<bf16*>(tile + sw_off(row, col)) = zero;
  }
}

// zeros in half of a row's 64 columns (the rows past M)
__device__ __forceinline__ void zero_half(uint8_t* tile, int row, int half) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int col = 32 * half; col < 32 * half + 32; ++col)
    *reinterpret_cast<bf16*>(tile + sw_off(row, col)) = zero;
}

// One encoding of this warpgroup's 64 rows into `tile`, two threads a row:
// the position encoding (dir false) of o + r z (A) or the points (C), or
// the direction encoding (dir true) of the ray's (A) or the point's (C)
// view direction; A's saving forward also writes the direction encoding
// per ray, from the ray's first sample.
__device__ __forceinline__ void encode_rows(const Args& p, uint8_t* tile, bool dir, int wg, int t,
                                            int row0) {
  const int row = wg * WG_ROWS + (t >> 1), half = t & 1;
  const int m = row0 + row;
  if (m >= p.m) {
    zero_half(tile, row, half);
    return;
  }
  float x[3];
  bf16* out = nullptr;
  if (p.mode == MODE_POINTS) {
    const float* src = (dir ? p.dirs : p.x0) + static_cast<int64_t>(m) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = src[c];
  } else {
    const int ray = m / p.S;
    if (dir) {
#pragma unroll
      for (int c = 0; c < 3; ++c) x[c] = p.dirs[ray * 3 + c];
      if (p.denc_rays && m % p.S == 0) out = p.denc_rays + static_cast<int64_t>(ray) * p.ld_denc;
    } else {
      const float zz = p.z[m];
#pragma unroll
      for (int c = 0; c < 3; ++c) x[c] = expand(p.x0[ray * 3 + c], p.x1[ray * 3 + c], zz);
    }
  }
  encode_half(x, dir ? p.l_dir : p.l_pos, half, tile, row, out);
}

// ---------------------------------------------------------------------------
// Epilogues, heads, compositing
// ---------------------------------------------------------------------------

// out = act(acc + bias) rounded to bf16 into this warpgroup's rows of the
// activation tile, in gemm_sm90_kernel's order
template <int N, int R>
__device__ __forceinline__ void epilogue(const float (&acc)[R], const float* __restrict__ bias,
                                         bool relu, uint8_t* act, int wg, int t) {
  const int rl = wg * WG_ROWS + (t >> 5) * 16 + ((t & 31) >> 2);
  const int cq = (t & 3) * 2;
  // sw_off(rl + 8 h, 8 j + cq): column 8 j + cq is byte 2 cq of chunk j % 8
  // of k-block j / 8, and rows rl and rl + 8 swizzle alike
  uint8_t* row = act + rl * ROW_BYTES + 2 * cq;
  const int x = (rl & 7) << 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + cq);
    uint8_t* out = row + (j >> 3) * KB_BYTES + (((j & 7) << 4) ^ x);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      v0 += b.x;
      v1 += b.y;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * h * ROW_BYTES) = __floats2bfloat162_rn(v0, v1);
    }
  }
}


// A layer's epilogue in this warpgroup: wait until the last saves have read
// the tile and every warp's products have retired, write, make the writes
// visible to wgmma and TMA, and (with a map) save the warpgroup's rows.

template <int N, int R>
__device__ __forceinline__ void finish_layer(const float (&acc)[R], const float* bias, bool relu,
                                             uint8_t* act, const CUtensorMap* save, int wg,
                                             int t, int row0) {
  if (t == 0) bulk_wait_read();
  wg_barrier(1 + wg);
  epilogue<N>(acc, bias, relu, act, wg, t);
  fence_async_smem();
  wg_barrier(1 + wg);
  if (save && t == 0) {
#pragma unroll
    for (int kb = 0; kb < (N + 63) / 64; ++kb)
      tma_store(save, smem_u32(act + kb * KB_BYTES + wg * WG_BYTES), 64 * kb,
                row0 + wg * WG_ROWS);
    bulk_commit();
  }
}

// rgb_layer's epilogue: relu((rgb + dir) + bias), the feature half and the
// direction half (the row term) in accumulators of their own
template <int N>
__device__ __forceinline__ void finish_rgb(const float (&rgb)[N / 2], const float (&dir)[N / 2],
                                           const float* bias, uint8_t* act,
                                           const CUtensorMap* save, int wg, int t, int row0) {
  float sum[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = rgb[i] + dir[i];
  finish_layer<N>(sum, bias, true, act, save, wg, t, row0);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// raw_sigma of this warp's 16 rows = a13 @ wd + bd, as heads_fwd_kernel
template <int D>
__device__ __forceinline__ void density_head(const uint8_t* act, const bf16* wd, float bd,
                                             float4* raw, int row_base, int lane) {
  for (int i = 0; i < 16; ++i) {
    const int row = row_base + i;
    float s = 0.f;
    for (int k = lane; k < D; k += 32) s += tile_at(act, row, k) * __bfloat162float(wd[k]);
    s = warp_sum(s);
    if (lane == 0) raw[row].x = s + bd;
  }
}

// raw_rgb of this warp's 16 rows = hr @ wc + bc, as heads_fwd_kernel
template <int H2>
__device__ __forceinline__ void rgb_head(const uint8_t* act, const bf16* wc, const float* bc,
                                         float4* raw, int row_base, int lane) {
  for (int i = 0; i < 16; ++i) {
    const int row = row_base + i;
    float c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int k = lane; k < H2; k += 32) {
      const float v = tile_at(act, row, k);
      c0 += v * __bfloat162float(wc[k * 3]);
      c1 += v * __bfloat162float(wc[k * 3 + 1]);
      c2 += v * __bfloat162float(wc[k * 3 + 2]);
    }
    c0 = warp_sum(c0);
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
    if (lane == 0) {
      raw[row].y = c0 + bc[0];
      raw[row].z = c1 + bc[1];
      raw[row].w = c2 + bc[2];
    }
  }
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// post-activation density head (softplus/relu, optional occupancy alpha)
__device__ __forceinline__ float density_act(float raw_sigma, const Flags& f) {
  float d = f.softplus_act ? softplus(raw_sigma) : fmaxf(raw_sigma, 0.f);
  if (f.occ_alpha) d = 1.f - expf(-d);
  return d;
}

__device__ __forceinline__ float alpha_of(float d, float delta, int s, int n_samples,
                                          const Flags& f) {
  if (!f.dist_alpha) return d;
  return s == n_samples - 1 ? 1.f : 1.f - expf(-d * delta);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_fused_fwd_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args p) {
  using L = Smem<D>;
  constexpr int KT = L::KT, H2 = D / 2, STAGE = L::STAGE;
  constexpr int ACC = D / 2;  // f32 accumulators a thread: m64nD
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle needs 1024-byte-aligned tiles
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* act = base + L::ACT;
  uint8_t* enc = base + L::ENC;
  float4* raw_s = reinterpret_cast<float4*>(base + L::RAW);
  float4* comp_s = reinterpret_cast<float4*>(base + L::COMP);
  float* z_s = reinterpret_cast<float*>(base + L::ZS);
  bf16* wd_s = reinterpret_cast<bf16*>(base + L::WD);
  bf16* wc_s = reinterpret_cast<bf16*>(base + L::WC);
  float* bias_s = reinterpret_cast<float*>(base + L::BIAS);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* empty = full + STAGES;
  const int tiles = (p.m + BM - 1) / BM;

  for (int i = threadIdx.x; i < D; i += THREADS) wd_s[i] = p.wd[i];
  for (int i = threadIdx.x; i < 3 * H2; i += THREADS) wc_s[i] = p.wc[i];
  // the ten layers' biases, read by every epilogue
  for (int i = threadIdx.x; i < 9 * D + H2; i += THREADS) bias_s[i] = p.bias[i / D][i % D];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) produce<D>(maps, tiles, smem_u32(base + L::RING), full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp_rows = wg * WG_ROWS + (t >> 5) * 16, lane = t & 31;
  const uint32_t act_a = smem_u32(act) + wg * WG_BYTES;
  const uint32_t enc_a = smem_u32(enc) + wg * WG_BYTES;
  const float bd = p.bd[0];
  const bool save = p.save != 0;
  auto sv = [&](int i) { return save ? &maps.s[i] : nullptr; };
  Ring ring{smem_u32(base + L::RING), full, empty, 0, 0u, -1};

  int parity = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, parity ^= 1) {
    const int row0 = tile * BM;
    // the position encoding, once the last tile's saves have read the tile
    if (t == 0) bulk_wait_read();
    wg_barrier(1 + wg);
    encode_rows(p, enc, false, wg, t, row0);
    fence_async_smem();
    wg_barrier(1 + wg);
    if (save && t == 0) {
      tma_store(&maps.s[S_ENC], enc_a, 0, row0 + wg * WG_ROWS);
      bulk_commit();
    }

    // trunk0_0 .. trunk0_3 (the accumulators live from here to rgb_layer's
    // epilogue, none across the encoding)
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    mma_ktile<D, STAGE>(acc, enc_a, ring, true);
    mma_drain(acc, ring);
    finish_layer<D>(acc, bias_s, true, act, sv(S_ACT0), wg, t, row0);
#pragma unroll
    for (int l = 1; l < 4; ++l) {
#pragma unroll
      for (int j = 0; j < KT; ++j) mma_ktile<D, STAGE>(acc, act_a + j * KB_BYTES, ring, j == 0);
      mma_drain(acc, ring);
      finish_layer<D>(acc, bias_s + l * D, true, act, sv(S_ACT0 + l), wg, t,
                      row0);
    }
    // trunk1_0: [a03, enc] as two operand pairs; trunk1_1 .. trunk1_3
#pragma unroll
    for (int j = 0; j < KT; ++j) mma_ktile<D, STAGE>(acc, act_a + j * KB_BYTES, ring, j == 0);
    mma_ktile<D, STAGE>(acc, enc_a, ring, false);
    mma_drain(acc, ring);
    finish_layer<D>(acc, bias_s + 4 * D, true, act, sv(S_ACT0 + 4), wg, t,
                    row0);
    // the direction encoding into the encoding tile, which trunk1_0 and the
    // save (finish_layer waited for it) have read
    encode_rows(p, enc, true, wg, t, row0);
    fence_async_smem();
    wg_barrier(1 + wg);
    if (save && t == 0 && p.mode == MODE_POINTS) {
      tma_store(&maps.s[S_DENC], enc_a, 0, row0 + wg * WG_ROWS);
      bulk_commit();
    }
#pragma unroll
    for (int l = 5; l < 8; ++l) {
#pragma unroll
      for (int j = 0; j < KT; ++j) mma_ktile<D, STAGE>(acc, act_a + j * KB_BYTES, ring, j == 0);
      mma_drain(acc, ring);
      finish_layer<D>(acc, bias_s + l * D, true, act, sv(S_ACT0 + l), wg, t,
                      row0);
    }
    // fc_density on a13 (this warp's rows, which it wrote)
    density_head<D>(act, wd_s, bd, raw_s, warp_rows, lane);
    // fc_feature (no ReLU)
#pragma unroll
    for (int j = 0; j < KT; ++j) mma_ktile<D, STAGE>(acc, act_a + j * KB_BYTES, ring, j == 0);
    mma_drain(acc, ring);
    finish_layer<D>(acc, bias_s + 8 * D, false, act, sv(S_FEAT), wg, t, row0);
    // rgb_layer: the direction half and the feature half in accumulators
    // of their own
    {
      float dir[H2 / 2], rgb[H2 / 2];
#pragma unroll
      for (int i = 0; i < H2 / 2; ++i) dir[i] = rgb[i] = 0.f;
      mma_ktile<H2, STAGE>(dir, enc_a, ring, true);
#pragma unroll
      for (int j = 0; j < KT; ++j)
        mma_ktile<H2, STAGE>(rgb, act_a + j * KB_BYTES, ring, j == 0);
      mma_drain(rgb, ring);
      fence_regs(dir);
      finish_rgb<H2>(rgb, dir, bias_s + 9 * D, act, sv(S_HR), wg, t, row0);
    }
    rgb_head<H2>(act, wc_s, p.bc, raw_s, warp_rows, lane);
    __syncwarp();

    // per row: raw, and C's head activations or A's alpha and sigmoids
    const int row = warp_rows + lane, m = row0 + row;
    if (lane < 16 && m < p.m) {
      const float4 rw = raw_s[row];
      if (p.raw) *reinterpret_cast<float4*>(p.raw + static_cast<int64_t>(m) * 4) = rw;
      if (p.mode == MODE_POINTS) {
        p.out1[m] = density_act(rw.x, p.f);
        p.out0[static_cast<int64_t>(m) * 3] = sigmoid(rw.y);
        p.out0[static_cast<int64_t>(m) * 3 + 1] = sigmoid(rw.z);
        p.out0[static_cast<int64_t>(m) * 3 + 2] = sigmoid(rw.w);
      } else if (p.mode == MODE_COMPOSITE) {
        const float alpha = alpha_of(density_act(rw.x, p.f), p.deltas[m], m % p.S, p.S, p.f);
        p.alpha[m] = alpha;
        comp_s[parity * BM + row] = make_float4(alpha, sigmoid(rw.y), sigmoid(rw.z), sigmoid(rw.w));
        z_s[parity * BM + row] = p.z[m];
      }
    }
    if (p.mode == MODE_COMPOSITE && wg == 0) {
      pair_arrive();
    } else if (p.mode == MODE_COMPOSITE) {
      // once warpgroup 0's rows are in, one thread of warpgroup 1 per ray
      // scans its samples in composite_fwd_kernel's order
      pair_sync();
      const int rays = BM / p.S;
      if ((t * rays) % 128 == 0) {
        const int r = t * rays / 128, ray = row0 / p.S + r;
        if (ray < p.n_rays) {
          const float4* c4 = comp_s + parity * BM + r * p.S;
          const float* zr = z_s + parity * BM + r * p.S;
          float trans = 1.f, rr = 0.f, g = 0.f, b = 0.f, dd = 0.f, wsum = 0.f;
          for (int s = 0; s < p.S; ++s) {
            const float4 c = c4[s];
            const float w = c.x * trans;
            rr += w * c.y;
            g += w * c.z;
            b += w * c.w;
            dd += w * zr[s];
            wsum += w;
            trans *= 1.f - c.x + 1e-6f;
          }
          if (p.f.white_bg) {
            rr += 1.f - wsum;
            g += 1.f - wsum;
            b += 1.f - wsum;
          }
          p.out0[ray * 3] = rr;
          p.out0[ray * 3 + 1] = g;
          p.out0[ray * 3 + 2] = b;
          p.out1[ray] = dd;
        }
      }
    }
    __syncwarp();  // converged again for the next tile's wgmmas
  }
  if (t == 0) bulk_wait();
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A bf16 row-major 2D operand as mlp_kernel.tma_2d describes it: address,
// true width and rows in elements, row stride in bytes, box width and rows.
// The box is one 128-byte swizzle row wide and box_h rows deep.
bool encode(CUtensorMap* map, const long long* s, int box_h) {
  EncodeTiledFn fn = encode_tiled();
  const void* ptr = reinterpret_cast<const void*>(static_cast<uintptr_t>(s[0]));
  const long long width = s[1], rows = s[2], stride = s[3], box_w = s[4], bh = s[5];
  if (fn == nullptr || ptr == nullptr || width <= 0 || rows <= 0 || box_w * 2 != ROW_BYTES ||
      bh != box_h || stride % 16 != 0 || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 ||
      width * 2 > stride)
    return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(bh)};
  const cuuint32_t elem[2] = {1, 1};
  // OOB_FILL_NONE fills the box outside the tensor with zeros
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const Maps& maps, const Args& a, cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  static_assert(smem <= 232448, "shared memory");
  auto kernel = mlp_fused_fwd_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (a.m + BM - 1) / BM;
  kernel<<<tiles < sms ? tiles : sms, THREADS, smem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The fused forward of Kernels A and C (see the head of this file).
//   specs: (N_WMAPS + N_SMAPS) x 6 int64 tensor-map arguments (address,
//     width, rows, row stride in bytes, box width, box rows): the weights'
//     K-major k-tile maps in ring order (box rows D, or D / 2 for rgb_layer's
//     two), then the saves (box rows 64; address 0 for none).
//   ptrs: x0, x1, dirs, z, deltas, the ten GEMM layers' biases, wd, bd, wc,
//     bc, out0, out1, alpha, raw, denc_rays (0 for an unused one).
//   ints: D, M, rays, S, l_pos, l_dir, mode, save, softplus, occ_alpha,
//     dist_alpha, white_bg, ld_denc.
// Returns a cudaError (cudaErrorInvalidValue for arguments the kernel cannot
// take).
int nnt_mlp_fused_fwd(const long long* specs, const unsigned long long* ptrs, const int* ints,
                      void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int D = ints[0];
  Args a{};
  a.m = ints[1];
  a.n_rays = ints[2];
  a.S = ints[3];
  a.l_pos = ints[4];
  a.l_dir = ints[5];
  a.mode = ints[6];
  a.save = ints[7];
  a.f = Flags{ints[8], ints[9], ints[10], ints[11]};
  a.ld_denc = ints[12];
  if (a.m <= 0) return 0;
  auto fptr = [&](int i) { return reinterpret_cast<float*>(static_cast<uintptr_t>(ptrs[i])); };
  auto bptr = [&](int i) { return reinterpret_cast<bf16*>(static_cast<uintptr_t>(ptrs[i])); };
  a.x0 = fptr(0);
  a.x1 = fptr(1);
  a.dirs = fptr(2);
  a.z = fptr(3);
  a.deltas = fptr(4);
  for (int i = 0; i < 10; ++i) a.bias[i] = fptr(5 + i);
  a.wd = bptr(15);
  a.bd = fptr(16);
  a.wc = bptr(17);
  a.bc = fptr(18);
  a.out0 = fptr(19);
  a.out1 = fptr(20);
  a.alpha = fptr(21);
  a.raw = fptr(22);
  a.denc_rays = bptr(23);
  const int n_pos = 3 * (2 * a.l_pos + 1), n_dir = 3 * (2 * a.l_dir + 1);
  if ((D != 64 && D != 128 && D != 256) || a.l_pos < 0 || a.l_dir < 0 || n_pos > 64 ||
      n_dir > 64 || a.S < 1 || a.mode < MODE_COMPOSITE || a.mode > MODE_POINTS)
    return bad;
  if (a.x0 == nullptr || a.dirs == nullptr || a.wd == nullptr || a.bd == nullptr ||
      a.wc == nullptr || a.bc == nullptr)
    return bad;
  for (int i = 0; i < 10; ++i)
    if (a.bias[i] == nullptr) return bad;
  if (a.mode == MODE_POINTS) {
    if (a.out0 == nullptr || a.out1 == nullptr || a.S != 1 || (a.save && a.raw == nullptr))
      return bad;
  } else {
    if (a.x1 == nullptr || a.z == nullptr || a.deltas == nullptr ||
        static_cast<long long>(a.n_rays) * a.S != a.m || (a.save && a.denc_rays == nullptr))
      return bad;
    if (a.mode == MODE_COMPOSITE &&
        (BM % a.S != 0 || a.out0 == nullptr || a.out1 == nullptr || a.alpha == nullptr))
      return bad;
    if (a.mode == MODE_RAW && a.raw == nullptr) return bad;
  }
  Maps maps;
  for (int i = 0; i < N_WMAPS; ++i)
    if (!encode(&maps.w[i], specs + 6 * i, i >= W_RGBD ? D / 2 : D)) return bad;
  for (int i = 0; i < N_SMAPS; ++i) {
    const long long* s = specs + 6 * (N_WMAPS + i);
    const bool needed = a.save && (i != S_DENC || a.mode == MODE_POINTS);
    if (needed) {
      if (!encode(&maps.s[i], s, WG_ROWS)) return bad;
    } else {
      maps.s[i] = maps.w[0];  // never read
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(maps, a, st);
    case 128: return launch<128>(maps, a, st);
    case 256: return launch<256>(maps, a, st);
  }
  return bad;
}

}  // extern "C"
