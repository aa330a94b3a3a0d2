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
// gridDim.x); two warpgroups own 64 rows of a tile each and take turns on
// the tensor cores (a ping-pong, as CUTLASS's pingpong schedule and
// FlashAttention-3's inter-warpgroup overlap).
//   * Turns: named barriers 4 and 5 hand the tensor cores from one
//     warpgroup to the other. A turn is a run of one layer's k-tiles: the
//     warpgroup waits for its turn, issues them, hands the turn over and
//     only then retires its last products. While one warpgroup's wgmmas run,
//     the other runs its CUDA-core work: its last layer's epilogue and save,
//     the encodings, the heads and the compositing scan. Each warpgroup
//     reads and writes only its own rows of every tile in shared memory, so
//     the weights and the compositing are all that joins them; warpgroup 1
//     runs a turn behind warpgroup 0. A turn holds at most the ring's stages
//     (trunk1_0's encoding half and rgb_layer's direction half are turns of
//     their own: at D = 256 five k-tiles would not fit four stages) and ends
//     with its products retired, so the other's next turn can always load
//     what it needs: no turn waits on a stage the other still holds.
//   * 256 threads, no producer warp: a block of 288 or 384 threads is
//     allocated registers as 384 (168 a thread, whatever setmaxnreg later
//     gives the consumers), so ptxas spilled and an epilogue with a 256-wide
//     layer's 128 accumulator registers live had none left to overlap its
//     loads. At 256 threads a thread may hold 255.
//   * Weights: each tile's 3 + 9 D / 64 (N x 64) k-tiles of the layers'
//     K-major weights stream through a ring of 128 KB of (D x 64) stages (4
//     at D = 256, 8 at 128, 16 at 64) on TMA loads and mbarriers; the 1.2 MB
//     of weights stay in L2 and both warpgroups read each stage. Warpgroup
//     1, which is done with a stage last, refills it: its first thread loads
//     the k-tile STAGES on as soon as both have released the stage.
//   * Code size: the trunk is a loop over its layers and a turn a loop over
//     its k-tiles, so one epilogue and one k-tile body serve every layer.
//     Unrolled, the kernel was 171 KB of code a tile's pass ran through.
//   * Encoding in the kernel: pts = o + r z (A: per-ray inputs, no FMA
//     contraction, as encode_points_kernel) or the given points (C);
//     [x, sin 2^l x, cos 2^l x] with f32 arguments, rounded to bf16, written
//     straight into shared memory in the 128-byte-swizzled K-major layout
//     wgmma reads (and TMA writes), zero past the true width; two threads a
//     row, a warp on one half of 32 rows. Its inputs are loaded a tile (the
//     position) or half a tile (the direction) before it. The position
//     encoding stays in its tile for trunk1_0's skip half; the direction
//     encoding (per point; A repeats its ray's) then takes the same tile for
//     rgb_layer's direction half.
//   * The chain in shared memory: one bf16 tile of 128 rows x D is the A
//     operand of every layer. Each warpgroup issues m64nDk16 wgmmas into a
//     D / 2-register f32 accumulator, one k-tile in flight; the epilogue adds
//     the f32 bias (staged in shared memory, every value loaded before the
//     first write), takes the ReLU, rounds to bf16 and writes back over the
//     warpgroup's own rows once its products have retired -- the
//     operations, in their order, of gemm_sm90_kernel's epilogue, so every
//     activation is bitwise that of the layer-by-layer chain.
//   * trunk1_0 is two operand pairs (activation K = D, then the encoding,
//     K <= 63 -> 64 zero-filled), as gemm_fwd's a2. rgb_layer's direction
//     half (per point the f32 value the row-term GEMM gives per ray) and its
//     feature half run into accumulators of their own (one accumulator's
//     halves as the two operands made ptxas serialize the wgmmas), added as
//     gemm_fwd adds its row term: (acc + row term) + bias.
//   * Heads: fc_density on trunk1_3's output and fc_rgb on hr, a warp per
//     point over the warp's own 16 rows, in heads_fwd_kernel's order (raw is
//     bitwise the layer-by-layer one); the 16 rows' loads first, then their
//     shuffles.
//   * Compositing (A, 128 % S == 0): a tile holds 128 / S whole rays. Each
//     row's alpha and sigmoids are taken in parallel, then one thread per
//     ray runs composite_fwd_kernel's scan in its operation order, so rgbv,
//     dist and alpha are bitwise those of composite_fwd: a warpgroup scans
//     the rays in its rows, and at S = 128 warpgroup 0 scans the first 64
//     samples and hands its running sums to warpgroup 1 for the rest. Any
//     other S takes the raw route, chosen by shape in the wrapper: this
//     kernel writes raw and mlp_composite.cu's composite_fwd runs after it.
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
// Shared memory at D = 256, 229,728 of the 232,448 bytes a block may have:
// the 64 KB activation tile, the 16 KB encoding tile, the 128 KB ring, 9.5
// KB of biases, 1.3 KB of head weights, 4.5 KB for the heads' raw outputs
// and the compositing, the barriers and up to 1 KB to align the tiles. A
// second activation tile (64 KB, for two tiles a block) does not fit; a
// ring of fewer stages would leave a turn of a 256-wide layer no room.

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;                  // points per tile
constexpr int ROW_BYTES = 128;           // one swizzle row: 64 bf16
constexpr int KB_BYTES = BM * ROW_BYTES;  // a 64-column k-block of a tile
constexpr int WG_ROWS = 64;              // rows per consumer warpgroup
constexpr int WG_BYTES = WG_ROWS * ROW_BYTES;
// two warpgroups and no producer warp: at 256 threads a thread may hold
// 255 registers. ptxas allocates a block of 288 or 384 threads (a producer
// warp or warpgroup beside them) as 384, 168 registers a thread, whatever
// setmaxnreg gives the consumers at run time: it then spills, and an
// epilogue with the 128 accumulator registers of a 256-wide layer live has
// no register left to overlap its bias loads.
constexpr int THREADS = 256;
// the weight ring: 128 KB of (D x 64) k-tile stages, one 256-wide layer at
// D = 256 (4 stages), two at 128 (8), four at 64 (16)
constexpr int RING_BYTES = 128 * 1024;
template <int D>
constexpr int stages() {
  return RING_BYTES / (D * ROW_BYTES);
}

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
  static constexpr int STAGES = stages<D>();
  static constexpr int ACT = 0;
  static constexpr int ENC = KT * KB_BYTES;  // the position, then the direction encoding
  static constexpr int RING = ENC + KB_BYTES;
  static constexpr int RAW = RING + RING_BYTES;      // float4 [BM]
  static constexpr int COMP = RAW + BM * 16;         // float4 [BM]
  static constexpr int ZS = COMP + BM * 16;          // float [BM]
  static constexpr int SCAN = ZS + BM * 4;           // Scan
  static constexpr int WD = SCAN + 32;               // bf16 [D]
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

// barrier 3 across the two warpgroups: warpgroup 1 waits (sync) for
// warpgroup 0's running sums over a 128-sample ray's first 64 samples,
// warpgroup 0 only signals (arrive)
__device__ __forceinline__ void pair_sync() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); }
__device__ __forceinline__ void pair_arrive() {
  asm volatile("bar.arrive 3, 256;\n" ::: "memory");
}

// The tensor cores' turn, barriers 4 (warpgroup 0's) and 5 (warpgroup 1's):
// a warpgroup waits for its turn before it issues a run of k-tiles and
// hands the turn to the other once they are issued, so the two issue their
// wgmmas in alternation and each runs its CUDA-core work under the other's
__device__ __forceinline__ void turn_take(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(4 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(5 - wg) : "memory");
}

// ---------------------------------------------------------------------------
// The weight ring: the consumers' k-tiles and the TMA loads that refill it
// ---------------------------------------------------------------------------

// A block's weight stream is each of its tiles' 3 + 9 KT k-tiles (39 at
// D = 256) in the order the turns consume them; position x of the stream
// lives in stage x % STAGES.
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

// Load position x (if any) into its stage, once both warpgroups have
// released position x - STAGES there: an (N x 64) box of a layer's K-major
// weight, N = D, or D / 2 for rgb_layer's two halves.
template <int D>
__device__ __forceinline__ void ring_load(const Ring& ring, int x) {
  constexpr int KT = D / 64, STAGES = Smem<D>::STAGES;
  if (x >= ring.total) return;
  int i = x % (3 + 9 * KT), map, j = 0;
  if (i == 0) {
    map = W_T00;
  } else if ((i -= 1) < 3 * KT) {
    map = W_T01 + i / KT;  // trunk0_1 .. trunk0_3
    j = i % KT;
  } else if ((i -= 3 * KT) < KT) {
    map = W_T10;
    j = i;
  } else if ((i -= KT) == 0) {
    map = W_T10E;
  } else if ((i -= 1) < 4 * KT) {
    map = W_T11 + i / KT;  // trunk1_1 .. trunk1_3, fc_feature
    j = i % KT;
  } else if ((i -= 4 * KT) == 0) {
    map = W_RGBD;
  } else {
    map = W_RGB;
    j = i - 1;
  }
  const int s = x % STAGES;
  const uint32_t fb = smem_u32(ring.full + s);
  mbar_wait(smem_u32(ring.empty + s), ((x / STAGES) & 1) ^ 1);  // the first pass is free
  mbar_expect_tx(fb, (map >= W_RGBD ? D / 2 : D) * ROW_BYTES);
  tma_load(ring.buf + s * Smem<D>::STAGE, &ring.maps->w[map], fb, 64 * j, 0);
}

// release the held position's stage; the loader refills it STAGES on
template <int D>
__device__ __forceinline__ void ring_release(Ring& ring) {
  if (ring.held < 0) return;
  mbar_arrive(smem_u32(ring.empty + ring.held % Smem<D>::STAGES));
  if (ring.loader) ring_load<D>(ring, ring.held + Smem<D>::STAGES);
}

// One k-tile of a layer: wait for its weights, issue its four k16 products
// acc (+)= A (this warpgroup's 64 rows of the k-block at shared
// address `a`) @ B^T with B the stage's (N x 64) K-major weight k-tile, and
// release the previous k-tile's stage once its products have retired (one
// k-tile stays in flight). `zero`: the first k-tile of the accumulator.
template <int N, int D>
__device__ __forceinline__ void mma_ktile(float (&acc)[N / 2], uint32_t a, Ring& ring, bool zero) {
  constexpr int STAGES = Smem<D>::STAGES;
  const int s = ring.pos % STAGES;
  mbar_wait(smem_u32(ring.full + s), (ring.pos / STAGES) & 1);
  const uint32_t b = ring.buf + static_cast<uint32_t>(s * Smem<D>::STAGE);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // 16 bf16 = 32 bytes along the swizzled row
    wgmma_bf16<0>(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32),
                       (zero && kk == 0) ? 0 : 1);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(acc);
  ring_release<D>(ring);
  ring.held = ring.pos++;
}

// the end of a run of k-tiles: every product retired, the last stage free
template <int D, int R>
__device__ __forceinline__ void mma_drain(float (&acc)[R], Ring& ring) {
  wgmma_wait<0>();
  fence_regs(acc);
  ring_release<D>(ring);
  ring.held = -1;
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

// Columns 32 half .. 32 half + 31 of one row's encoding [x, sin 2^l x,
// cos 2^l x] of p (levels levels; zero past the true width 3 (2 levels + 1))
// into `tile`'s row. `out` (or null) receives the same bf16 values of the
// true width in a global row. Level 4, whose columns straddle column 32, is
// taken in both halves.
__device__ __forceinline__ void encode_half(const float (&p)[3], int levels, int half,
                                            uint8_t* tile, int row, bf16* out) {
  const int c0 = 32 * half, n = 3 * (2 * levels + 1);
  auto put = [&](int col, float v) {
    if (col < c0 || col >= c0 + 32) return;
    const bf16 h = __float2bfloat16_rn(v);
    *reinterpret_cast<bf16*>(tile + sw_off(row, col)) = h;
    if (out) out[col] = h;
  };
  if (half == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) put(c, p[c]);
  }
  const int hi = half ? levels : min(levels, 5);
#pragma unroll 1
  for (int l = half ? 4 : 0; l < hi; ++l) {
    const float f = ldexpf(1.f, l);  // exact power of two
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s, co;
      sincosf(p[c] * f, &s, &co);
      put(3 * (1 + 2 * l) + c, s);
      put(3 * (2 + 2 * l) + c, co);
    }
  }
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int col = max(n, c0); col < c0 + 32; ++col)
    *reinterpret_cast<bf16*>(tile + sw_off(row, col)) = zero;
}

// zeros in half of a row's 64 columns (the rows past M)
__device__ __forceinline__ void zero_half(uint8_t* tile, int row, int half) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<uint4*>(tile + sw_off(row, 32 * half + 8 * k)) = make_uint4(0, 0, 0, 0);
}

// The inputs of one row's encoding, loaded a phase or a tile before it is
// taken so that their latency passes under other work: the position
// encoding's o, r and z of the row's ray and sample (A) or its point (C),
// the direction encoding's view direction
struct EncIn {
  float v[7];
};

__device__ __forceinline__ int enc_row(int wg, int t) { return wg * WG_ROWS + (t & 63); }

__device__ __forceinline__ EncIn enc_load(const Args& p, bool dir, int m) {
  EncIn in{};
  if (m >= p.m) return in;
  if (p.mode == MODE_POINTS) {
    const float* src = (dir ? p.dirs : p.x0) + static_cast<int64_t>(m) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) in.v[c] = src[c];
  } else {
    const int ray = m / p.S;
#pragma unroll
    for (int c = 0; c < 3; ++c) in.v[c] = (dir ? p.dirs : p.x0)[ray * 3 + c];
    if (!dir) {
#pragma unroll
      for (int c = 0; c < 3; ++c) in.v[3 + c] = p.x1[ray * 3 + c];
      in.v[6] = p.z[m];
    }
  }
  return in;
}

// One encoding of this warpgroup's 64 rows into `tile`, two threads a row
// (warps 0, 1 of the warpgroup columns 0 .. 31 of its rows, warps 2, 3
// columns 32 .. 63, so no warp diverges on its half): the position
// encoding (dir false) of o + r z (A) or the points (C), or the direction
// encoding (dir true) of the ray's (A) or the point's (C) view direction;
// A's saving forward also writes the direction encoding per ray, from the
// ray's first sample. `in`: enc_load's inputs of this thread's row.
__device__ __forceinline__ void encode_rows(const Args& p, uint8_t* tile, bool dir, int wg, int t,
                                            int row0, const EncIn& in) {
  const int row = enc_row(wg, t), half = t >> 6;
  const int m = row0 + row;
  if (m >= p.m) {
    zero_half(tile, row, half);
    return;
  }
  float x[3];
  bf16* out = nullptr;
  if (p.mode != MODE_POINTS && dir && p.denc_rays && m % p.S == 0)
    out = p.denc_rays + static_cast<int64_t>(m / p.S) * p.ld_denc;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    x[c] = p.mode != MODE_POINTS && !dir ? expand(in.v[c], in.v[3 + c], in.v[6]) : in.v[c];
  encode_half(x, dir ? p.l_dir : p.l_pos, half, tile, row, out);
}

// ---------------------------------------------------------------------------
// Epilogues, heads, compositing
// ---------------------------------------------------------------------------

// a and b rounded to bf16, a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// out = act(acc + bias) rounded to bf16 into this warpgroup's rows of the
// activation tile, in gemm_sm90_kernel's order. A thread's values are the
// accumulator fragment: for each 8-column block j, columns 8 j + cq, + 1 of
// rows rl and rl + 8 -- the fragment of two 8 x 8 matrices that stmatrix
// stores, four a time.
template <int N, int R>
__device__ __forceinline__ void epilogue(const float (&acc)[R], const float* __restrict__ bias,
                                         bool relu, uint8_t* act, int wg, int t) {
  const int lane = t & 31, cq = (lane & 3) * 2;
  // lane L addresses row L % 8 + 8 ((L / 8) % 2) of the warp's 16 rows in
  // column block j + L / 16
  const int r = wg * WG_ROWS + (t >> 5) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t row = smem_u32(act) + r * ROW_BYTES;
  const int x = r & 7, jl = lane >> 4;
  // every bias first: a load may not pass a store to the tile, and one at
  // a time each would wait out its latency
  float2 bj[N / 8];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) bj[j] = *reinterpret_cast<const float2*>(bias + j * 8 + cq);
  auto val = [&](int i, float b) {
    const float v = acc[i] + b;
    return relu ? fmaxf(v, 0.f) : v;
  };
#pragma unroll
  for (int j = 0; j < N / 8; j += 2) {
    uint32_t q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // blocks j, j + 1; rows rl, rl + 8
      const int jj = j + (k >> 1), h = k & 1;
      q[k] = pack_bf16(val(4 * jj + 2 * h, bj[jj].x), val(4 * jj + 2 * h + 1, bj[jj].y));
    }
    const int cb = j + jl;
    stmatrix_x4(row + (cb >> 3) * KB_BYTES + (((cb & 7) ^ x) << 4), q[0], q[1], q[2], q[3]);
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

// raw_sigma of this warp's 16 rows = a13 @ wd + bd, as heads_fwd_kernel:
// lane l sums its columns l, l + 32, ... in order, then the warp's
// butterfly. The 16 rows' sums are independent: all loads first, then the
// shuffles, then the stores, so their latencies overlap.
template <int D>
__device__ __forceinline__ void density_head(const uint8_t* act, const bf16* wd, float bd,
                                             float4* raw, int row_base, int lane) {
  constexpr int Q = D / 32;
  float w[Q], s[16];
#pragma unroll
  for (int q = 0; q < Q; ++q) w[q] = __bfloat162float(wd[lane + 32 * q]);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) s[i] += tile_at(act, row_base + i, lane + 32 * q) * w[q];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = warp_sum(s[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) raw[row_base + i].x = s[i] + bd;
  }
}

// raw_rgb of this warp's 16 rows = hr @ wc + bc, as heads_fwd_kernel, in
// the order of density_head
template <int H2>
__device__ __forceinline__ void rgb_head(const uint8_t* act, const bf16* wc, const float* bc,
                                         float4* raw, int row_base, int lane) {
  constexpr int Q = H2 / 32;
  float w[Q][3], c[16][3];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int j = 0; j < 3; ++j) w[q][j] = __bfloat162float(wc[(lane + 32 * q) * 3 + j]);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c[i][j] = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float v = tile_at(act, row_base + i, lane + 32 * q);
#pragma unroll
      for (int j = 0; j < 3; ++j) c[i][j] += v * w[q][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) c[i][j] = warp_sum(c[i][j]);
  if (lane == 0) {
    const float b0 = bc[0], b1 = bc[1], b2 = bc[2];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      raw[row_base + i].y = c[i][0] + b0;
      raw[row_base + i].z = c[i][1] + b1;
      raw[row_base + i].w = c[i][2] + b2;
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

// composite_fwd_kernel's running sums over a ray's samples
struct Scan {
  float trans, r, g, b, d, w;
};

// n more samples of a ray into its running sums, in composite_fwd_kernel's
// operation order
__device__ __forceinline__ void scan_rows(const float4* c4, const float* z, int n, Scan& s) {
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const float4 c = c4[i];
    const float w = c.x * s.trans;
    s.r += w * c.y;
    s.g += w * c.z;
    s.b += w * c.w;
    s.d += w * z[i];
    s.w += w;
    s.trans *= 1.f - c.x + 1e-6f;
  }
}

__device__ __forceinline__ void write_ray(const Args& p, int ray, Scan s) {
  if (p.f.white_bg) {
    s.r += 1.f - s.w;
    s.g += 1.f - s.w;
    s.b += 1.f - s.w;
  }
  p.out0[ray * 3] = s.r;
  p.out0[ray * 3 + 1] = s.g;
  p.out0[ray * 3 + 2] = s.b;
  p.out1[ray] = s.d;
}

// The compositing of a tile's rays (A, 128 % S == 0) from each row's alpha
// and sigmoids in comp / z, one thread per ray. A ray of S <= 64 samples
// lies in one warpgroup's rows and that warpgroup scans it; at S = 128 (the
// tile one ray) warpgroup 0 scans the first 64 samples and hands its sums
// to warpgroup 1, which scans the rest -- one sequence of operations, in
// order, split between two threads.
__device__ __forceinline__ void composite(const Args& p, const float4* comp, const float* z,
                                          Scan* handoff, int wg, int t, int row0) {
  const Scan start{1.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (p.S <= WG_ROWS) {
    wg_barrier(1 + wg);  // the warpgroup's rows are in
    const int rays = WG_ROWS / p.S;
    if ((t * rays) % 128 == 0) {
      const int first = wg * WG_ROWS + t * rays / 128 * p.S, ray = (row0 + first) / p.S;
      if (ray < p.n_rays) {
        Scan s = start;
        scan_rows(comp + first, z + first, p.S, s);
        write_ray(p, ray, s);
      }
    }
  } else if (wg == 0) {
    wg_barrier(1);
    if (t == 0) {
      Scan s = start;
      scan_rows(comp, z, WG_ROWS, s);
      *handoff = s;
    }
    pair_arrive();
  } else {
    pair_sync();  // warpgroup 1's rows and warpgroup 0's sums are in
    if (t == 0) {
      Scan s = *handoff;
      scan_rows(comp + WG_ROWS, z + WG_ROWS, WG_ROWS, s);
      write_ray(p, row0 / p.S, s);
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_fused_fwd_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args p) {
  using L = Smem<D>;
  constexpr int KT = L::KT, H2 = D / 2, STAGES = L::STAGES;
  constexpr int ACC = D / 2;  // f32 accumulators a thread: m64nD
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle needs 1024-byte-aligned tiles
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* act = base + L::ACT;
  uint8_t* enc = base + L::ENC;
  float4* raw_s = reinterpret_cast<float4*>(base + L::RAW);
  float4* comp_s = reinterpret_cast<float4*>(base + L::COMP);
  float* z_s = reinterpret_cast<float*>(base + L::ZS);
  Scan* scan_s = reinterpret_cast<Scan*>(base + L::SCAN);
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
      mbar_init(smem_u32(empty + s), THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp_rows = wg * WG_ROWS + (t >> 5) * 16, lane = t & 31;
  const uint32_t act_a = smem_u32(act) + wg * WG_BYTES;
  const uint32_t enc_a = smem_u32(enc) + wg * WG_BYTES;
  const float bd = p.bd[0];
  const bool save = p.save != 0;
  auto sv = [&](int i) { return save ? &maps.s[i] : nullptr; };
  // this block's tiles: blockIdx.x, + gridDim.x, ...
  const int my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  Ring ring{smem_u32(base + L::RING), full, empty, &maps, my_tiles * (3 + 9 * KT), 0, -1,
            wg == 1 && t == 0};
  if (ring.loader) {
    for (int x = 0; x < STAGES; ++x) ring_load<D>(ring, x);
  }

  // a turn: this warpgroup's first n k-tiles of an operand at shared
  // address `a` into `acc`, the turn taken before and passed once they are
  // issued, then their products retired under the other's turn (every
  // stage released: the other's next turn may need them all)
  auto turn = [&](auto& acc, uint32_t a, int n, bool zero) {
    constexpr int N = 2 * sizeof(acc) / sizeof(float);
    turn_take(wg);
#pragma unroll 1
    for (int j = 0; j < n; ++j) mma_ktile<N, D>(acc, a + j * KB_BYTES, ring, zero && j == 0);
    turn_pass(wg);
    mma_drain<D>(acc, ring);
  };
  if (wg == 1) turn_pass(wg);  // warpgroup 0 takes the first turn
  const int erow = enc_row(wg, t);
  EncIn pos_in = enc_load(p, false, blockIdx.x * BM + erow);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * BM;
    // this tile's direction and the next tile's position inputs, in flight
    // from here to their encodings
    const EncIn dir_in = enc_load(p, true, row0 + erow);
    const EncIn next_in = tile + gridDim.x < tiles
                              ? enc_load(p, false, row0 + gridDim.x * BM + erow)
                              : EncIn{};
    // the position encoding, once the last tile's saves have read the tile
    if (t == 0) bulk_wait_read();
    wg_barrier(1 + wg);
    encode_rows(p, enc, false, wg, t, row0, pos_in);
    pos_in = next_in;
    fence_async_smem();
    wg_barrier(1 + wg);
    if (save && t == 0) {
      tma_store(&maps.s[S_ENC], enc_a, 0, row0 + wg * WG_ROWS);
      bulk_commit();
    }

    // the trunk, a layer an iteration: trunk0_0 on the encoding, trunk0_1
    // .. trunk1_3 on the activation tile, trunk1_0 also on the encoding (a
    // second turn: at D = 256 five k-tiles would not fit the ring's four
    // stages). The accumulators live from here to fc_feature's epilogue.
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int l = 0; l < 8; ++l) {
      if (l == 0) {
        turn(acc, enc_a, 1, true);
      } else {
        turn(acc, act_a, KT, true);
        if (l == 4) turn(acc, enc_a, 1, false);
      }
      finish_layer<D>(acc, bias_s + l * D, true, act, sv(S_ACT0 + l), wg, t, row0);
      if (l == 4) {
        // the direction encoding into the encoding tile, which trunk1_0
        // and the save (finish_layer waited for it) have read
        encode_rows(p, enc, true, wg, t, row0, dir_in);
        fence_async_smem();
        wg_barrier(1 + wg);
        if (save && t == 0 && p.mode == MODE_POINTS) {
          tma_store(&maps.s[S_DENC], enc_a, 0, row0 + wg * WG_ROWS);
          bulk_commit();
        }
      }
    }
    // fc_density on a13 (this warp's rows, which it wrote)
    density_head<D>(act, wd_s, bd, raw_s, warp_rows, lane);
    // fc_feature (no ReLU)
    turn(acc, act_a, KT, true);
    finish_layer<D>(acc, bias_s + 8 * D, false, act, sv(S_FEAT), wg, t, row0);
    // rgb_layer: the direction half and the feature half in accumulators
    // of their own, a turn each (five k-tiles would not fit four stages)
    {
      float dir[H2 / 2], rgb[H2 / 2];
#pragma unroll
      for (int i = 0; i < H2 / 2; ++i) dir[i] = rgb[i] = 0.f;
      turn(dir, enc_a, 1, true);
      turn(rgb, act_a, KT, true);
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
        comp_s[row] = make_float4(alpha, sigmoid(rw.y), sigmoid(rw.z), sigmoid(rw.w));
        z_s[row] = p.z[m];
      }
    }
    if (p.mode == MODE_COMPOSITE) composite(p, comp_s, z_s, scan_s, wg, t, row0);
    __syncwarp();  // converged again for the next tile's wgmmas
  }
  if (wg == 0) turn_take(wg);  // warpgroup 1's last turn_pass
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
