// Kernels A and C's input-only backward on Hopper in one launch: the rgb
// head's backward and the input gradients of the ten layers of the NeRF MLP,
// the cotangent of a tile of rows kept on chip from g_raw down to the
// encodings' cotangents.
//
// Replaces, when no weight needs a gradient (test-time pose optimisation),
// the input-gradient half of the Pallas kernels of
// nope_nerf_tpu/ops/pallas/mlp_kernel.py
//   A backward _make_bwd_composite_kernel (l.702), reached from
//              _fused_mlp_composite_bwd (l.909);
//   C backward _make_bwd_kernel (l.258), reached from _fused_mlp_bwd ->
//              _fused_mlp_bwd_call (l.440).
// A backward that computes weight gradients keeps heads_bwd_fused and the
// ten passes of mlp_fused_bwd.cu, which reduce each weight gradient across
// blocks; this kernel has nothing to reduce and shares no code with them.
//
// It computes mlp_kernel._chain_bwd(..., weight_grads=False) row by row:
//   g_hr   = bf16(mask(hr) * (bf16(g_raw[:, 1:4]) @ fc_rgb^T))
//   g_denc = g_hr @ W_rgb[D:]^T (f32), g_feat = bf16(g_hr @ W_rgb[:D]^T)
//   g_13   = bf16(mask(a_7) * (g_feat @ W_feat^T + bf16(g_raw[:, 0]) wd^T))
//   down the trunk g_{j-1} = bf16(mask(a_{j-1}) * (g_j @ W_j^T)); trunk1_0
//   also gives g_enc_skip = g @ W_10[D:]^T and trunk0_0 g_enc (both f32)
// with every rounding where the passes put it (f32 sums, the rank-1 term,
// the mask, then bf16) and each product's k16 steps in the passes' order, so
// the three encoding cotangents are bitwise those of the ten passes.
//
// What bounds it on the H100 (the pose step: M = 131,072, D = 256): the
// bytes -- the eight trunk outputs and hr read for the masks (571 MB) and
// g_raw (2 MB), the f32 encoding cotangents written (80 MB): ~650 MB, 0.195
// ms at 3.35 TB/s -- against the 155.6 GFLOP of the forward's products,
// 0.157 ms at the bf16 peak. The passes wrote each layer's 67 MB cotangent
// and read it straight back, nine times.
//
// Design: the fused forward's (mlp_fused_fwd.cu) -- one persistent block per
// SM walks 128-row tiles; two warpgroups own 64 rows of a tile each and take
// turns on the tensor cores (named barriers 4 and 5), a turn a run of one
// layer's k-tiles, drained under the other's turn.
//   * The cotangent stays in registers. The m64nD f32 accumulator is masked
//     and rounded in place and packed to bf16 in pairs: that is the next
//     layer's A operand as wgmma reads A from registers (the fragment of an
//     accumulator's 16 columns is a k-step's A, as FlashAttention-3 feeds P
//     to its second product), so no cotangent is stored or fenced anywhere.
//     At D = 256 a thread holds 128 accumulator and 64 A registers.
//   * Weights: each layer's rows as mlp_kernel._padded keeps them
//     (untransposed (fan_in, fan_out): the input gradient's B is K-major as
//     it is, nothing transposed), streamed per tile as (N x 64) k-tiles
//     through a 128 KB ring on TMA and mbarriers, both warpgroups reading
//     each stage; warpgroup 1's first thread refills a stage once both have
//     released it. A turn holds at most the ring's stages.
//   * Masks: each warpgroup's 64 rows of the saved output that masks the
//     next epilogue (a trunk output, or hr with the rows of g_raw) land by
//     TMA in the warpgroup's own shared buffer, issued once the epilogue
//     that read the last one is done -- a layer's turns of both warpgroups
//     before it is read -- and are read with ldmatrix in the accumulator's
//     fragment layout. A warpgroup's rows wholly past M load nothing.
//   * The encodings' parts (rgb_layer's direction rows, trunk1_0's skip
//     rows, trunk0_0) are m64n64 turns of their own into the first 32
//     accumulator registers, stored f32 from registers; the layers' boxes
//     of 64 rows zero-fill rows past n_pos / n_dir.
//   * The rgb head's backward is CUDA-core work on the tile's hr and g_raw,
//     written into the first A registers, in heads_bwd_fused's order.
//   * Rows past M load as zeros and are never stored.
// Shared memory at D = 256: the 128 KB ring, 2 x 32 KB of masks, 4.5 KB of
// g_raw rows and head weights, the barriers: ~198 KB.

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;                           // rows per tile
constexpr int WG_ROWS = 64;                       // rows per warpgroup
constexpr int ROW_BYTES = 128;                    // one swizzle row: 64 bf16
constexpr int BOX_BYTES = WG_ROWS * ROW_BYTES;    // a 64 x 64 bf16 box of a warpgroup's rows
constexpr int THREADS = 256;                      // two warpgroups, no producer warp
constexpr int RING_BYTES = 128 * 1024;            // (D x 64) stages: 4 at D = 256, 16 at 64
constexpr int ENC_N = 64;                         // an encoding's part: n_pos, n_dir <= 64

// weight k-tile maps, in the order the ring streams them
enum { W_RGBD, W_RGB, W_FEAT, W_T13, W_T12, W_T11, W_T10E, W_T10, W_T03, W_T02, W_T01, W_T00,
       N_WMAPS };
// mask maps: the eight trunk outputs (a_0 .. a_7), then hr
enum { M_HR = 8, N_MMAPS = 9 };

struct Maps {
  CUtensorMap w[N_WMAPS];
  CUtensorMap mask[N_MMAPS];
  CUtensorMap graw;  // g_raw (M, 4) f32, 64-row boxes
};

struct Args {
  const bf16* wd;  // fc_density (D)
  const bf16* wc;  // fc_rgb (D / 2, 3)
  float* g_denc;   // (M, n_dir), row stride ld_denc
  float* g_skip;   // (M, n_pos), row stride ld_skip
  float* g_enc;    // (M, n_pos), row stride ld_enc
  int ld_denc, ld_skip, ld_enc;
  int m, n_pos, n_dir;
};

template <int D>
struct Smem {
  static constexpr int KT = D / 64;            // k-tiles of a D-wide cotangent
  static constexpr int H2 = D / 2;
  static constexpr int KH = (H2 + 63) / 64;    // k-tiles of g_hr
  static constexpr int STAGE = D * ROW_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int PER_TILE = 2 * KH + 10 * KT;  // a tile's weight k-tiles
  static constexpr int RING = 0;
  static constexpr int MASK = RING + RING_BYTES;           // [2 warpgroups][KT boxes]
  static constexpr int GRAW = MASK + 2 * KT * BOX_BYTES;   // float4 [BM]
  static constexpr int WD = GRAW + BM * 16;                // f32 [D]
  static constexpr int WC = WD + D * 4;                    // f32 [3][H2]
  static constexpr int BAR = WC + 3 * H2 * 4;
  static constexpr int BYTES = 1024 + BAR + (2 * STAGES + 2) * 8;
};

// The tensor cores' turn, barriers 4 (warpgroup 0's) and 5 (warpgroup 1's),
// as in mlp_fused_fwd.cu
__device__ __forceinline__ void turn_take(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(4 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(5 - wg) : "memory");
}

// ---------------------------------------------------------------------------
// The weight ring
// ---------------------------------------------------------------------------

// A block's weight stream is each of its tiles' PER_TILE k-tiles in the
// order the turns consume them; position x lives in stage x % STAGES.
struct Ring {
  uint32_t buf;  // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
  const Maps* maps;
  int total;    // positions of this block's stream
  int pos;      // the next position to consume
  int held;     // the position whose products may still be in flight, or -1
  bool loader;  // this thread refills the stages (warpgroup 1's first)
};

// Load position x (if any) into its stage once both warpgroups have released
// position x - STAGES there: a (rows x 64) box of a layer's K-major rows,
// rows D, or 64 for an encoding's part.
template <int D>
__device__ __forceinline__ void ring_load(const Ring& ring, int x) {
  using L = Smem<D>;
  if (x >= ring.total) return;
  int i = x % L::PER_TILE, map, j;
  if (i < 2 * L::KH) {
    map = W_RGBD + i / L::KH;
    j = i % L::KH;
  } else {
    i -= 2 * L::KH;
    map = W_FEAT + i / L::KT;
    j = i % L::KT;
  }
  const int rows = (map == W_RGBD || map == W_T10E || map == W_T00) ? ENC_N : D;
  const int s = x % L::STAGES;
  const uint32_t fb = smem_u32(ring.full + s);
  mbar_wait(smem_u32(ring.empty + s), ((x / L::STAGES) & 1) ^ 1);  // the first pass is free
  mbar_expect_tx(fb, rows * ROW_BYTES);
  tma_load(ring.buf + s * L::STAGE, &ring.maps->w[map], fb, 64 * j, 0);
}

// release the held position's stage; the loader refills it STAGES on
template <int D>
__device__ __forceinline__ void ring_release(Ring& ring) {
  if (ring.held < 0) return;
  mbar_arrive(smem_u32(ring.empty + ring.held % Smem<D>::STAGES));
  if (ring.loader) ring_load<D>(ring, ring.held + Smem<D>::STAGES);
}

template <int A>
__device__ __forceinline__ void fence_a(uint32_t (&a)[A]) {
#pragma unroll
  for (int i = 0; i < A; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// k-tile J (and the ones after it) of a product over K with A in registers:
// wait for the weights, issue its k16 steps acc (+)= a[16 J + 4 kk ..] @ B^T
// with B the stage's (N x 64) K-major k-tile, and release the previous
// k-tile's stage once its products have retired (one k-tile in flight)
template <int N, int D, int K, int J, int R, int A>
__device__ __forceinline__ void mma_ktiles(float (&acc)[R], uint32_t (&a)[A], Ring& ring) {
  constexpr int STAGES = Smem<D>::STAGES;
  constexpr int KS = (K - 64 * J) / 16 < 4 ? (K - 64 * J) / 16 : 4;
  static_assert(16 * J + 4 * KS <= A, "A registers");
  const int s = ring.pos % STAGES;
  mbar_wait(smem_u32(ring.full + s), (ring.pos / STAGES) & 1);
  const uint32_t b = ring.buf + static_cast<uint32_t>(s * Smem<D>::STAGE);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)  // 16 bf16 = 32 bytes along the swizzled row
    wgmma_bf16_rs<N>(acc, a[16 * J + 4 * kk], a[16 * J + 4 * kk + 1], a[16 * J + 4 * kk + 2],
                     a[16 * J + 4 * kk + 3], sw128_desc(b + kk * 32), (J == 0 && kk == 0) ? 0 : 1);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(acc);
  ring_release<D>(ring);
  ring.held = ring.pos++;
  if constexpr (64 * (J + 1) < K) mma_ktiles<N, D, K, J + 1>(acc, a, ring);
}

// A turn: this warpgroup's product acc = a (64 x K) @ (the layer's N x K
// rows)^T, the turn taken before its k-tiles are issued and passed once they
// are, then every product retired (and every stage released: the other's
// next turn may need them all) under the other's turn
template <int N, int D, int K, int R, int A>
__device__ __forceinline__ void turn(float (&acc)[R], uint32_t (&a)[A], Ring& ring, int wg) {
  turn_take(wg);
  mma_ktiles<N, D, K, 0>(acc, a, ring);
  turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_a(a);  // the products have read the A registers
  ring_release<D>(ring);
  ring.held = -1;
}

// ---------------------------------------------------------------------------
// Epilogues: accumulator fragments (thread t of a warpgroup: for each
// 8-column block j, acc[4 j], acc[4 j + 1] at row 16 (t / 32) + (t % 32) / 4,
// columns 8 j + 2 (t % 4) + {0, 1}, and acc[4 j + 2 ..] eight rows below)
// into the next product's A registers: a[4 i + q] = the bf16 pair of
// acc[8 i + 2 q], acc[8 i + 2 q + 1]
// ---------------------------------------------------------------------------

// a and b rounded to bf16, a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The saved values at this thread's fragment of k-step i (columns 16 i ..
// 16 i + 15) from a warpgroup's buffer of 64-column boxes (128-byte
// swizzle: 16-byte chunk c of row r at c ^ (r % 8)): r[q] holds the pair of
// a[4 i + q]. Lane L addresses row L % 8 + 8 ((L / 8) % 2) of its warp's 16
// rows in column block 2 i + L / 16.
__device__ __forceinline__ void load_frag(uint32_t buf, int lrow, int lblk, int i,
                                          uint32_t (&r)[4]) {
  const int cb = 2 * i + lblk;
  ldmatrix_x4(buf + (cb >> 3) * BOX_BYTES + lrow * ROW_BYTES + (((cb & 7) ^ (lrow & 7)) << 4), r);
}

// g_hr into a[0 .. H2 / 4): relu_mask(hr) * (bf16(g_raw[:, 1:4]) @ wc^T),
// in heads_bwd_fused_kernel's order; wc here f32 [3][H2], gr the bf16-rounded
// g_raw[:, 1:4] of this thread's two rows
template <int H2, int A>
__device__ __forceinline__ void heads_bwd(uint32_t (&a)[A], uint32_t hbuf, int lrow, int lblk,
                                          const float* wc, const float (&gr)[2][3], int cq) {
#pragma unroll
  for (int i = 0; i < H2 / 16; ++i) {
    uint32_t h[4];
    load_frag(hbuf, lrow, lblk, i, h);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 16 * i + 8 * (q >> 1) + cq, r = q & 1;
      const float2 w0 = *reinterpret_cast<const float2*>(wc + col);
      const float2 w1 = *reinterpret_cast<const float2*>(wc + H2 + col);
      const float2 w2 = *reinterpret_cast<const float2*>(wc + 2 * H2 + col);
      const float v0 =
          lo_bf16(h[q]) > 0.f ? gr[r][0] * w0.x + gr[r][1] * w1.x + gr[r][2] * w2.x : 0.f;
      const float v1 =
          hi_bf16(h[q]) > 0.f ? gr[r][0] * w0.y + gr[r][1] * w1.y + gr[r][2] * w2.y : 0.f;
      a[4 * i + q] = pack_bf16(v0, v1);
    }
  }
}

// a = bf16(acc) (g_feat: rgb_layer's feature rows, no mask)
template <int R, int A>
__device__ __forceinline__ void pack_acc(const float (&acc)[R], uint32_t (&a)[A]) {
#pragma unroll
  for (int p = 0; p < R / 2; ++p) a[p] = pack_bf16(acc[2 * p], acc[2 * p + 1]);
}

// a = bf16(mask(acc [+ gs wd^T])), the mask the saved output in `mbuf` > 0
// (the pass's epilogue: the rank-1 term -- exact products of two bf16 --
// after the sums, then the mask, then the rounding)
template <int R, int A>
__device__ __forceinline__ void mask_acc(const float (&acc)[R], uint32_t (&a)[A], uint32_t mbuf,
                                         int lrow, int lblk, bool rank1, const float* wd,
                                         const float (&gs)[2], int cq) {
#pragma unroll
  for (int i = 0; i < R / 8; ++i) {
    uint32_t m[4];
    load_frag(mbuf, lrow, lblk, i, m);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v0 = acc[8 * i + 2 * q], v1 = acc[8 * i + 2 * q + 1];
      if (rank1) {
        const float2 w = *reinterpret_cast<const float2*>(wd + 16 * i + 8 * (q >> 1) + cq);
        v0 += gs[q & 1] * w.x;
        v1 += gs[q & 1] * w.y;
      }
      if (!(lo_bf16(m[q]) > 0.f)) v0 = 0.f;
      if (!(hi_bf16(m[q]) > 0.f)) v1 = 0.f;
      a[4 * i + q] = pack_bf16(v0, v1);
    }
  }
}

// an encoding's cotangent: the first 64 columns (acc[0 .. 31]) of this
// thread's rows `row` and row + 8, f32, the columns below n and rows below m
template <int R>
__device__ __forceinline__ void store_f32(const float (&acc)[R], float* out, int ld, int n, int m,
                                          int row, int cq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= m) continue;
    float* o = out + static_cast<int64_t>(r) * ld;
#pragma unroll
    for (int j = 0; j < ENC_N / 8; ++j) {
      const int c = 8 * j + cq;
      if (c + 1 < n)
        *reinterpret_cast<float2*>(o + c) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      else if (c < n)
        o[c] = acc[4 * j + 2 * h];
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_input_bwd_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args p) {
  using L = Smem<D>;
  constexpr int KT = L::KT, H2 = L::H2, KH = L::KH, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle needs 1024-byte-aligned buffers
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const float4* graw_s = reinterpret_cast<const float4*>(base + L::GRAW);
  float* wd_s = reinterpret_cast<float*>(base + L::WD);
  float* wc_s = reinterpret_cast<float*>(base + L::WC);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* mfull = empty + STAGES;  // one a warpgroup: its masks' loads
  const int tiles = (p.m + BM - 1) / BM;

  for (int i = threadIdx.x; i < D; i += THREADS) wd_s[i] = __bfloat162float(p.wd[i]);
  for (int i = threadIdx.x; i < 3 * H2; i += THREADS)
    wc_s[(i % 3) * H2 + i / 3] = __bfloat162float(p.wc[i]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), THREADS);
    }
    mbar_init(smem_u32(mfull), 1);
    mbar_init(smem_u32(mfull + 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, lane = t & 31;
  const int rl = (t >> 5) * 16 + (lane >> 2), cq = (lane & 3) * 2;
  const int lrow = (t >> 5) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, lblk = lane >> 4;
  const uint32_t mbuf = smem_u32(base + L::MASK + wg * KT * BOX_BYTES);
  const uint32_t mbar = smem_u32(mfull + wg);
  const uint32_t graw_a = smem_u32(graw_s + wg * WG_ROWS);
  // this block's tiles: blockIdx.x, + gridDim.x, ...
  const int my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  Ring ring{smem_u32(base + L::RING), full, empty, &maps, my_tiles * L::PER_TILE, 0, -1,
            wg == 1 && t == 0};
  if (ring.loader) {
    for (int x = 0; x < STAGES; ++x) ring_load<D>(ring, x);
  }

  // this warpgroup's 64 rows of a mask (boxes of 64 columns), by its first
  // thread; with `graw` also their rows of g_raw. Rows wholly past M load
  // nothing (the phase completes on the arrival alone).
  auto load_mask = [&](int map, int boxes, int row0, bool graw) {
    const int y = row0 + wg * WG_ROWS;
    if (y >= p.m) {
      mbar_arrive(mbar);
      return;
    }
    mbar_expect_tx(mbar, boxes * BOX_BYTES + (graw ? WG_ROWS * 16 : 0));
    for (int b = 0; b < boxes; ++b) tma_load(mbuf + b * BOX_BYTES, &maps.mask[map], mbar, 64 * b, y);
    if (graw) tma_load(graw_a, &maps.graw, mbar, 0, y);
  };
  uint32_t mphase = 0;
  auto mask_wait = [&]() {
    mbar_wait(mbar, mphase);
    mphase ^= 1;
  };

  if (t == 0) load_mask(M_HR, KH, blockIdx.x * BM, true);
  if (wg == 1) turn_pass(wg);  // warpgroup 0 takes the first turn
  float acc[D / 2];
  uint32_t a[D / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) a[i] = 0u;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * BM, row = row0 + wg * WG_ROWS + rl;
    // the rgb head's backward from hr and g_raw
    mask_wait();
    float gr[2][3], gs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 g = graw_s[wg * WG_ROWS + rl + 8 * h];
      gs[h] = round_bf16(g.x);
      gr[h][0] = round_bf16(g.y);
      gr[h][1] = round_bf16(g.z);
      gr[h][2] = round_bf16(g.w);
    }
    heads_bwd<H2>(a, mbuf, lrow, lblk, wc_s, gr, cq);
    wg_barrier(1 + wg);  // the warpgroup is done with hr and g_raw
    if (t == 0) load_mask(7, KT, row0, false);
    // rgb_layer: the direction rows (g_denc), then the feature rows (g_feat)
    turn<ENC_N, D, H2>(acc, a, ring, wg);
    store_f32(acc, p.g_denc, p.ld_denc, p.n_dir, p.m, row, cq);
    turn<D, D, H2>(acc, a, ring, wg);
    pack_acc(acc, a);
    // fc_feature with fc_density's rank-1 term (l = 0), then trunk1_3 ..
    // trunk0_1, each masked by the saved output below it, a_{7 - l}
#pragma unroll 1
    for (int l = 0; l < 8; ++l) {
      if (l == 4) {  // trunk1_0's skip rows: the position encoding's cotangent
        turn<ENC_N, D, D>(acc, a, ring, wg);
        store_f32(acc, p.g_skip, p.ld_skip, p.n_pos, p.m, row, cq);
      }
      turn<D, D, D>(acc, a, ring, wg);
      mask_wait();
      mask_acc(acc, a, mbuf, lrow, lblk, l == 0, wd_s, gs, cq);
      wg_barrier(1 + wg);  // the warpgroup is done with the mask
      if (t == 0) {
        if (l < 7)
          load_mask(6 - l, KT, row0, false);
        else if (tile + gridDim.x < tiles)
          load_mask(M_HR, KH, row0 + gridDim.x * BM, true);
      }
    }
    // trunk0_0: the position encoding's cotangent
    turn<ENC_N, D, D>(acc, a, ring, wg);
    store_f32(acc, p.g_enc, p.ld_enc, p.n_pos, p.m, row, cq);
  }
  if (wg == 0) turn_take(wg);  // warpgroup 1's last turn_pass
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A row-major 2D operand as mlp_kernel.tma_2d describes it: address, true
// width and rows in elements, row stride in bytes, box width and rows. bf16
// boxes are one 128-byte swizzle row wide; g_raw's (f32) one 16-byte row of
// four values, unswizzled.
bool encode(CUtensorMap* map, const long long* s, bool f32, int box_h) {
  EncodeTiledFn fn = encode_tiled();
  const int es = f32 ? 4 : 2;
  const void* ptr = reinterpret_cast<const void*>(static_cast<uintptr_t>(s[0]));
  const long long width = s[1], rows = s[2], stride = s[3], box_w = s[4], bh = s[5];
  if (fn == nullptr || ptr == nullptr || width <= 0 || rows <= 0 ||
      box_w * es != (f32 ? 16 : ROW_BYTES) || bh != box_h || stride % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || width * es > stride)
    return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(bh)};
  const cuuint32_t elem[2] = {1, 1};
  // OOB_FILL_NONE fills the box outside the tensor with zeros
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const Maps& maps, const Args& a, cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  static_assert(smem <= 232448, "shared memory");
  auto kernel = mlp_input_bwd_kernel<D>;
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

// The input-only backward of Kernels A and C (see the head of this file).
//   specs: (N_WMAPS + N_MMAPS + 1) x 6 int64 tensor-map arguments (address,
//     width, rows, row stride in bytes, box width, box rows): the weights'
//     K-major k-tile maps in ring order (box rows D, or 64 for an encoding's
//     rows), the eight trunk outputs and hr (box rows 64), g_raw (box 4 x 64).
//   ptrs: wd, wc, g_denc, g_skip, g_enc.
//   ints: D, M, n_pos, n_dir, ld_denc, ld_skip, ld_enc.
// Returns a cudaError (cudaErrorInvalidValue for arguments the kernel cannot
// take).
int nnt_mlp_input_bwd(const long long* specs, const unsigned long long* ptrs, const int* ints,
                      void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int D = ints[0], H2 = D / 2;
  Args a{};
  a.m = ints[1];
  a.n_pos = ints[2];
  a.n_dir = ints[3];
  a.ld_denc = ints[4];
  a.ld_skip = ints[5];
  a.ld_enc = ints[6];
  if (a.m <= 0) return 0;
  a.wd = reinterpret_cast<const bf16*>(static_cast<uintptr_t>(ptrs[0]));
  a.wc = reinterpret_cast<const bf16*>(static_cast<uintptr_t>(ptrs[1]));
  a.g_denc = reinterpret_cast<float*>(static_cast<uintptr_t>(ptrs[2]));
  a.g_skip = reinterpret_cast<float*>(static_cast<uintptr_t>(ptrs[3]));
  a.g_enc = reinterpret_cast<float*>(static_cast<uintptr_t>(ptrs[4]));
  if ((D != 64 && D != 128 && D != 256) || a.n_pos < 1 || a.n_pos > ENC_N || a.n_dir < 1 ||
      a.n_dir > ENC_N || a.ld_denc < a.n_dir || a.ld_skip < a.n_pos || a.ld_enc < a.n_pos ||
      (a.ld_denc | a.ld_skip | a.ld_enc) % 2 || a.wd == nullptr || a.wc == nullptr ||
      a.g_denc == nullptr || a.g_skip == nullptr || a.g_enc == nullptr ||
      reinterpret_cast<uintptr_t>(a.g_denc) % 8 || reinterpret_cast<uintptr_t>(a.g_skip) % 8 ||
      reinterpret_cast<uintptr_t>(a.g_enc) % 8)
    return bad;
  // each weight map's (width, rows): rgb_layer's rows are H2 wide
  Maps maps;
  for (int i = 0; i < N_WMAPS; ++i) {
    const long long* s = specs + 6 * i;
    const bool enc = i == W_RGBD || i == W_T10E || i == W_T00;
    const long long width = i <= W_RGB ? H2 : D;
    const long long rows = i == W_RGBD ? a.n_dir : enc ? a.n_pos : D;
    if (!encode(&maps.w[i], s, false, enc ? ENC_N : D) || s[1] != width || s[2] != rows)
      return bad;
  }
  for (int i = 0; i < N_MMAPS; ++i) {
    const long long* s = specs + 6 * (N_WMAPS + i);
    if (!encode(&maps.mask[i], s, false, WG_ROWS) || s[1] != (i == M_HR ? H2 : D) ||
        s[2] != a.m)
      return bad;
  }
  const long long* sg = specs + 6 * (N_WMAPS + N_MMAPS);
  if (!encode(&maps.graw, sg, true, WG_ROWS) || sg[1] != 4 || sg[2] != a.m || sg[3] != 16)
    return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(maps, a, st);
    case 128: return launch<128>(maps, a, st);
    case 256: return launch<256>(maps, a, st);
  }
  return bad;
}

}  // extern "C"
