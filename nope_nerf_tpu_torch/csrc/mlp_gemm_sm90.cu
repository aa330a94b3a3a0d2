// The layer GEMMs of Kernels A and C on Hopper, forward and backward: TMA
// loads, an mbarrier ring and wgmma.
//
//   forward        C (M x N) = act(A1 @ B1 [+ A2 @ B2] [+ rowterm[row / div]] [+ bias])
//   input grad     C (M x N) = mask(G @ W^T [+ bf16(gsig) wd^T]), + column sums
//   weight grad    dW (K_in x N) = X^T @ G, split over M
//
// Operands bf16, f32 accumulators; bias, rowterm and the column sums f32.
//
// Serves the GEMMs inside the bodies of four Pallas kernels of
// nope_nerf_tpu/ops/pallas/mlp_kernel.py: _make_fwd_composite_kernel (l.668,
// Kernel A forward), _make_fwd_kernel (l.244, Kernel C forward),
// _make_bwd_composite_kernel (l.702, Kernel A backward) and _make_bwd_kernel
// (l.258, Kernel C backward). The forwards run the same chain
// (nope_nerf_tpu_torch/ops/kernels/mlp_kernel.py::_chain_fwd): trunk0_0 (K
// 63), six 256 x 256 layers, trunk1_0 (K 256 + 63: A2 is the position
// encoding, so the skip concat is never built), fc_feature, and rgb_layer (N
// 128), whose direction half is a per-ray row term rowterm = denc @
// W_rgb[D:] computed once per ray by this kernel with an f32 output and added
// in the epilogue of the per-point GEMM (a TMA box cannot index rows by
// row / S). The backwards ran the same chain backward (now
// mlp_kernel._chain_bwd_layered): twelve input-gradient GEMMs and eleven (A)
// or twelve (C) weight-gradient GEMMs. Since mlp_fused_fwd.cu and
// mlp_fused_bwd.cu no path runs these GEMMs; chip_smoke.py times them beside
// the fused kernels.
//
// What bounds it on the H100: one layer at K = N = 256 does 2KN / (2K + 2N) =
// 128 FLOP per byte of activations in and out, under the card's ~295 FLOP/B
// ridge, so each layer GEMM is memory-bound: at M = 131,072 it reads and
// writes 2 x 67 MB, 40 us at 3.35 TB/s (60 us for an input gradient that
// also reads its ReLU mask). The design streams the activations once at the
// memory rate and keeps the tensor cores out of the way:
//   * BM = 128 rows per tile as two consumer warpgroups of m64, BN = the
//     whole N (so each A tile is read from memory once), BK = 64 bf16 (one
//     128-byte swizzle row).
//   * One producer warp issues TMA loads of the A and B k-tiles into a ring of
//     3 (N = 256) or 4 stages, signalled by mbarriers with the expected byte
//     counts; consumers release a stage through a second mbarrier. The
//     weights (<= 160 KB per layer) stay in the 50 MB L2, so re-reading them
//     per tile costs L2 bandwidth, not memory bandwidth.
//   * Persistent grid: a block walks the M tiles with stride gridDim.x; the
//     producer runs ahead into the next tile while the consumers finish the
//     epilogue of this one.
//   * wgmma.mma_async m64nNk16, A and B read from shared memory through
//     128-byte-swizzle descriptors. The forward's B is the K-major (N x K)
//     transposed weight (mlp_kernel._padded_t); the input gradient's B is the
//     untransposed weight (fan_in x fan_out rows are already N x K,
//     mlp_kernel._padded), so neither direction transposes anything on the
//     card.
//   * Epilogue: + rowterm, + bias, ReLU (forward) or the rank-1 term and the
//     ReLU mask (input gradient), round, written swizzled into a shared
//     staging tile and stored with TMA (128-byte rows, no scalar stores); TMA
//     clips the rows past M. The row term (N <= 128) is loaded into registers
//     before the tile's k-loop, which hides its latency; the mask is a TMA
//     load into the staging tile itself, issued after the tile's first
//     k-tile, so it costs its bytes and no registers.
//   * The backward keeps its cotangents bf16 (each rounded after its ReLU
//     mask, where the reference rounds it on entering a matmul), which halves
//     their bytes and makes them TMA operands; the bias gradients are the f32
//     column sums of the masked values, taken in the epilogue before the
//     rounding. The weight gradient reads its two bf16 operands as 64-row
//     boxes down M and feeds them to wgmma MN-major (the transpose bits).
//   * Widths that are not multiples of 64 (K 63, 27): each tensor map gets
//     the true width with the padded row stride, so TMA zero-fills the box's
//     missing columns and never reads the padding (uninitialised in the
//     encodings: NaN x 0 would be NaN). Rows past M load as zeros, so they add
//     nothing to a column sum or a weight gradient.
// No atomics: two runs give bitwise equal outputs (the split sums are added
// in a fixed order by reduce_splits in mlp_composite.cu).

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;         // rows per tile: two consumer warpgroups x 64
constexpr int BK = 64;          // bf16 per k-tile: one 128-byte swizzle row
constexpr int ROW_BYTES = 128;  // every box is 128 bytes wide
constexpr int WG_ROWS = 64;     // rows per consumer warpgroup (the store box)
constexpr int CONSUMERS = 256;  // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int A_BYTES = BM * BK * 2;

template <int BN>
struct Tile {
  static constexpr int STAGES = BN > 128 ? 3 : 4;
  static constexpr int B_BYTES = BN * BK * 2;
};

// staging bytes of one warpgroup's (64 x BN) output: whole 64 x 128-byte boxes
template <int BN, typename TC>
struct Store {
  static constexpr int BOX_COLS = ROW_BYTES / static_cast<int>(sizeof(TC));
  static constexpr int BOXES = (BN + BOX_COLS - 1) / BOX_COLS;
  static constexpr int WG_BYTES = BOXES * WG_ROWS * ROW_BYTES;
};

template <int BN, typename TC>
constexpr int smem_bytes() {
  return 1024 + Tile<BN>::STAGES * (A_BYTES + Tile<BN>::B_BYTES) + 2 * Store<BN, TC>::WG_BYTES +
         2 * Tile<BN>::STAGES * 8;
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int x, int y) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(x), "r"(y)
               : "memory");
}

// The producer thread of the row-tile kernels (forward and input gradient):
// keeps the ring full across the block's tiles (stride gridDim.x), A from a1
// for the first kt1 k-tiles and from a2 for the kt2 after, B alike.
template <int STAGES, int B_BYTES>
__device__ __forceinline__ void produce_tiles(const CUtensorMap* a1, const CUtensorMap* a2,
                                              const CUtensorMap* b1, const CUtensorMap* b2,
                                              int kt1, int kt2, int tiles, uint8_t* sa, uint8_t* sb,
                                              uint64_t* full, uint64_t* empty) {
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int kt = 0; kt < kt1 + kt2; ++kt) {
      const uint32_t fb = smem_u32(full + stage);
      mbar_wait(smem_u32(empty + stage), phase ^ 1);  // the first pass is free
      mbar_expect_tx(fb, A_BYTES + B_BYTES);
      const bool second = kt >= kt1;
      const int kx = (second ? kt - kt1 : kt) * BK;
      tma_load(smem_u32(sa + stage * A_BYTES), second ? a2 : a1, fb, kx, tile * BM);
      tma_load(smem_u32(sb + stage * B_BYTES), second ? b2 : b1, fb, kx, 0);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// One tile's k-loop in consumer warpgroup wg: acc = (its 64 rows of A) @ B^T
// over kts k-tiles of the ring. `after_first` runs once, when the first
// k-tile's products have landed (the input-gradient GEMM issues its mask
// load there).
template <int BN, int STAGES, int B_BYTES, typename Hook>
__device__ __forceinline__ void consume_tile(float (&acc)[BN / 2], int kts, const uint8_t* sa,
                                             const uint8_t* sb, uint64_t* full, uint64_t* empty,
                                             int wg, int& stage, uint32_t& phase,
                                             Hook after_first) {
  for (int kt = 0; kt < kts; ++kt) {
    mbar_wait(smem_u32(full + stage), phase);
    const uint32_t a = smem_u32(sa + stage * A_BYTES + wg * WG_ROWS * ROW_BYTES);
    const uint32_t b = smem_u32(sb + stage * B_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // 16 bf16 = 32 bytes along the swizzled row
      wgmma_bf16<0>(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32), (kt | kk) != 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    mbar_arrive(smem_u32(empty + stage));
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    if (kt == 0) after_first();
  }
}

// two neighbouring outputs (row, col), (row, col + 1) of a warpgroup's tile,
// written where a 128-byte-swizzle TMA store box reads them: 16-byte chunk c
// of row r sits at chunk c ^ (r % 8)
__device__ __forceinline__ uint8_t* staged(uint8_t* tile, int row, int byte_col) {
  const int box = byte_col / ROW_BYTES, b = byte_col % ROW_BYTES;
  return tile + box * (WG_ROWS * ROW_BYTES) + row * ROW_BYTES + ((((b >> 4) ^ (row & 7)) << 4) | (b & 15));
}
__device__ __forceinline__ void store_pair(uint8_t* tile, int row, int col, float v0, float v1,
                                           bf16*) {
  *reinterpret_cast<__nv_bfloat162*>(staged(tile, row, col * 2)) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(uint8_t* tile, int row, int col, float v0, float v1,
                                           float*) {
  *reinterpret_cast<float2*>(staged(tile, row, col * 4)) = make_float2(v0, v1);
}

struct Epilogue {
  const float* bias;     // (N,) or null
  const float* rowterm;  // (rows, ld_rowterm) f32, row index row / row_div; or null
  int ld_rowterm;
  int row_div;
  int relu;
  int m;
};

// The row term where thread t's outputs need it: v[h][j] at row
// row0 + 16 (t / 32) + (t % 32) / 4 + 8 h, columns 8 j + 2 (t % 4) + {0, 1};
// zeros past row m.
template <int R>
__device__ __forceinline__ void load_rowterm(float2 (&v)[2][R], const Epilogue& ep, int row0,
                                             int t) {
  const int rl = (t >> 5) * 16 + ((t & 31) >> 2);
  const int cq = (t & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + rl + 8 * h;
    const float* p =
        gr < ep.m ? ep.rowterm + static_cast<int64_t>(gr / ep.row_div) * ep.ld_rowterm : nullptr;
#pragma unroll
    for (int j = 0; j < R; ++j)
      v[h][j] = p ? *reinterpret_cast<const float2*>(p + j * 8 + cq) : make_float2(0.f, 0.f);
  }
}

// The row term rides in registers beside the accumulators, loaded before a
// tile's k-loop so that its latency hides behind it. That fits up to
// N = 128 (rgb_layer's width); the entry takes no row term for wider tiles.
template <int BN>
struct RowTerm {
  static constexpr bool ON = BN <= 128;
  static constexpr int R = ON ? BN / 8 : 1;
};

// out = act((acc + rowterm) + bias), in the order of the plain version
template <int BN, typename TC>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2],
                                         const float2 (&rt)[2][RowTerm<BN>::R], uint8_t* tile,
                                         const Epilogue& ep, int t) {
  const int rl = (t >> 5) * 16 + ((t & 31) >> 2);
  const int cq = (t & 3) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + cq;
    float2 b = make_float2(0.f, 0.f);
    if (ep.bias) b = *reinterpret_cast<const float2*>(ep.bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (RowTerm<BN>::ON) {
        if (ep.rowterm) {
          v0 += rt[h][j].x;
          v1 += rt[h][j].y;
        }
      }
      if (ep.bias) {
        v0 += b.x;
        v1 += b.y;
      }
      if (ep.relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      store_pair(tile, rl + 8 * h, col, v0, v1, static_cast<TC*>(nullptr));
    }
  }
}

template <int BN, typename TC>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a1,
                     const __grid_constant__ CUtensorMap map_a2,
                     const __grid_constant__ CUtensorMap map_b1,
                     const __grid_constant__ CUtensorMap map_b2,
                     const __grid_constant__ CUtensorMap map_c, int kt1, int kt2, int tiles,
                     Epilogue ep) {
  constexpr int STAGES = Tile<BN>::STAGES;
  constexpr int B_BYTES = Tile<BN>::B_BYTES;
  using St = Store<BN, TC>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle needs 1024-byte-aligned buffers
  uint8_t* sa = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sb = sa + STAGES * A_BYTES;
  uint8_t* sc = sb + STAGES * B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sc + 2 * St::WG_BYTES);
  uint64_t* empty = full + STAGES;
  const int kts = kt1 + kt2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer: one thread keeps the ring full, running ahead across tiles
    if (threadIdx.x == CONSUMERS)
      produce_tiles<STAGES, B_BYTES>(&map_a1, &map_a2, &map_b1, &map_b2, kt1, kt2, tiles, sa, sb,
                                     full, empty);
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  uint8_t* my_c = sc + wg * St::WG_BYTES;
  int stage = 0;
  uint32_t phase = 0;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  float2 rowterm[2][RowTerm<BN>::R];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * BM + wg * WG_ROWS;
    if constexpr (RowTerm<BN>::ON) {
      if (ep.rowterm) load_rowterm(rowterm, ep, row0, t);
    }
    consume_tile<BN, STAGES, B_BYTES>(acc, kts, sa, sb, full, empty, wg, stage, phase, [] {});
    if (t == 0) bulk_wait_read();  // the last tile's store has left the staging tile
    wg_barrier(1 + wg);
    epilogue<BN, TC>(acc, rowterm, my_c, ep, t);
    fence_async_smem();
    wg_barrier(1 + wg);
    if (t == 0) {
#pragma unroll
      for (int box = 0; box < St::BOXES; ++box)
        tma_store(&map_c, smem_u32(my_c + box * WG_ROWS * ROW_BYTES), box * St::BOX_COLS, row0);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait();
}

// ---------------------------------------------------------------------------
// The input-gradient GEMM of the backward:
//   C (M x N) = mask(A @ B^T [+ bf16(gsig[row]) * wd[col]])
// A the bf16 cotangent (M x fan_out), B the layer's bf16 weight (fan_in x
// fan_out rows: already the K-major N x K operand), mask zeroing the outputs
// whose saved bf16 activation is <= 0 (the ReLU of the layer below), the
// rank-1 term fc_density's share of d(a13) taken in f32; C bf16 (the next
// cotangent) or f32 (an encoding's). Optionally the f32 column sums of the
// masked values before rounding (the bias gradient of the layer below):
// each warp reduces its 16 rows with a shuffle reduce-scatter, each
// warpgroup its four warps through shared memory and its tiles in
// registers, in a fixed order, into colsum[2 blockIdx.x + wg];
// reduce_splits adds those rows. The rank-1 columns wd are staged in shared
// memory once per block.
// ---------------------------------------------------------------------------

struct Dgrad {
  const float* gsig;  // rank-1 rows (row stride ld_gsig), or null
  int ld_gsig;
  const bf16* wd;     // rank-1 columns (N,)
  float* colsum;      // (2 gridDim.x, BN) f32, or null
  int mask;           // the mask map is read
  int m;
};

template <int BN, typename TC>
constexpr int dgrad_smem_bytes() {
  return smem_bytes<BN, TC>() + 2 * 4 * BN * 4 + BN * 2 + 2 * 8;
}

// The column sums of a warp's 16 rows over four consecutive 8-column blocks:
// x[2 jj + e] is this lane's (two rows') share of column col0 + 8 jj +
// 2 (lane % 4) + e, and lanes lane ^ 4, ^ 8, ^ 16 hold the same columns. A
// reduce-scatter over those eight lanes (7 shuffles) leaves each lane the sum
// of one column, which it writes: all 32 columns, no divergent store.
__device__ __forceinline__ void warp_colsum32(const float (&x)[8], float* warp_sums, int col0,
                                              int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float y[4], z[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y[i] = (b4 ? x[i + 4] : x[i]) + __shfl_xor_sync(0xffffffffu, b4 ? x[i] : x[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    z[i] = (b3 ? y[i + 2] : y[i]) + __shfl_xor_sync(0xffffffffu, b3 ? y[i] : y[i + 2], 8);
  const float v = (b2 ? z[1] : z[0]) + __shfl_xor_sync(0xffffffffu, b2 ? z[0] : z[1], 4);
  const int item = (b4 ? 4 : 0) + (b3 ? 2 : 0) + (b2 ? 1 : 0);  // jj = item / 2, e = item % 2
  warp_sums[col0 + 8 * (item >> 1) + 2 * (lane & 3) + (item & 1)] = v;
}

template <int BN, typename TC>
__device__ __forceinline__ void dgrad_epilogue(const float (&acc)[BN / 2], const float (&gs)[2],
                                               const bf16* wd, uint8_t* tile, float* warp_sums,
                                               const Dgrad& ep, int t) {
  const int rl = (t >> 5) * 16 + ((t & 31) >> 2);
  const int cq = (t & 3) * 2;
#pragma unroll
  for (int q = 0; q < BN / 32; ++q) {
    float x[8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * q + jj, col = j * 8 + cq;
      float2 w = make_float2(0.f, 0.f);
      if (ep.gsig) w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wd + col));
      x[2 * jj] = x[2 * jj + 1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (ep.gsig) {  // the products of two bf16 are exact in f32
          v0 += gs[h] * w.x;
          v1 += gs[h] * w.y;
        }
        if constexpr (sizeof(TC) == 2) {
          if (ep.mask) {  // the activation sits where this output goes
            const __nv_bfloat162 a =
                *reinterpret_cast<const __nv_bfloat162*>(staged(tile, rl + 8 * h, col * 2));
            if (!(__low2float(a) > 0.f)) v0 = 0.f;
            if (!(__high2float(a) > 0.f)) v1 = 0.f;
          }
        }
        x[2 * jj] += v0;
        x[2 * jj + 1] += v1;
        store_pair(tile, rl + 8 * h, col, v0, v1, static_cast<TC*>(nullptr));
      }
    }
    if (ep.colsum) warp_colsum32(x, warp_sums, 32 * q, t & 31);
  }
}

template <int BN, typename TC>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_dgrad_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const __grid_constant__ CUtensorMap map_c,
                      const __grid_constant__ CUtensorMap map_mask, int kts, int tiles, Dgrad ep) {
  constexpr int STAGES = Tile<BN>::STAGES;
  constexpr int B_BYTES = Tile<BN>::B_BYTES;
  constexpr int RUN = (BN + 127) / 128;  // running column sums per thread
  using St = Store<BN, TC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sb = sa + STAGES * A_BYTES;
  uint8_t* sc = sb + STAGES * B_BYTES;
  float* sums = reinterpret_cast<float*>(sc + 2 * St::WG_BYTES);  // [wg][warp][BN]
  bf16* s_wd = reinterpret_cast<bf16*>(sums + 2 * 4 * BN);         // the rank-1 columns
  uint64_t* full = reinterpret_cast<uint64_t*>(s_wd + BN);
  uint64_t* empty = full + STAGES;
  uint64_t* mask_full = empty + STAGES;  // one per consumer warpgroup

  if (ep.gsig)
    for (int c = threadIdx.x; c < BN; c += THREADS) s_wd[c] = ep.wd[c];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), CONSUMERS);
    }
    mbar_init(smem_u32(mask_full), 1);
    mbar_init(smem_u32(mask_full + 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS)
      produce_tiles<STAGES, B_BYTES>(&map_a, &map_a, &map_b, &map_b, kts, 0, tiles, sa, sb, full,
                                     empty);
    return;
  }

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  uint8_t* my_c = sc + wg * St::WG_BYTES;
  float* wg_sums = sums + wg * 4 * BN;
  const uint32_t mbar = smem_u32(mask_full + wg);
  const CUtensorMap* mask_map = &map_mask;
  int stage = 0;
  uint32_t phase = 0, mask_phase = 0;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  float run[RUN];
#pragma unroll
  for (int i = 0; i < RUN; ++i) run[i] = 0.f;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * BM + wg * WG_ROWS;
    float gs[2] = {0.f, 0.f};
    if (ep.gsig) {  // rows past M add nothing
      const int rl = (t >> 5) * 16 + ((t & 31) >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + rl + 8 * h;
        if (gr < ep.m)
          gs[h] = __bfloat162float(
              __float2bfloat16_rn(ep.gsig[static_cast<int64_t>(gr) * ep.ld_gsig]));
      }
    }
    // the mask tile loads into this warpgroup's staging tile once the last
    // tile's store has read it, behind the remaining k-tiles
    consume_tile<BN, STAGES, B_BYTES>(acc, kts, sa, sb, full, empty, wg, stage, phase, [&] {
      if (ep.mask && t == 0) {
        bulk_wait_read();
        mbar_expect_tx(mbar, St::BOXES * WG_ROWS * ROW_BYTES);
        for (int box = 0; box < St::BOXES; ++box)
          tma_load(smem_u32(my_c + box * WG_ROWS * ROW_BYTES), mask_map, mbar,
                   box * St::BOX_COLS, row0);
      }
    });
    if (ep.mask) {
      mbar_wait(mbar, mask_phase);
      mask_phase ^= 1;
    } else if (t == 0) {
      bulk_wait_read();  // the last tile's store has left the staging tile
    }
    wg_barrier(1 + wg);
    dgrad_epilogue<BN, TC>(acc, gs, s_wd, my_c, wg_sums + (t >> 5) * BN, ep, t);
    fence_async_smem();
    wg_barrier(1 + wg);
    if (t == 0) {
#pragma unroll
      for (int box = 0; box < St::BOXES; ++box)
        tma_store(&map_c, smem_u32(my_c + box * WG_ROWS * ROW_BYTES), box * St::BOX_COLS, row0);
      bulk_commit();
    }
    if (ep.colsum) {  // this tile's four warps, in order
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        const int c = t + 128 * i;
        if (c < BN) {
          const float* s = wg_sums + c;
          run[i] += ((s[0] + s[BN]) + s[2 * BN]) + s[3 * BN];
        }
      }
    }
  }
  if (ep.colsum) {
    float* out = ep.colsum + static_cast<int64_t>(2 * blockIdx.x + wg) * BN;
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (t + 128 * i < BN) out[t + 128 * i] = run[i];
  }
  if (t == 0) bulk_wait();
}

// ---------------------------------------------------------------------------
// The weight-gradient GEMM of the backward:
//   partial[split] (K_in x N) = X[rows of split]^T @ G[rows of split]
// X the saved bf16 activation (M x K_in), G the bf16 cotangent (M x N). Both
// operands arrive as TMA boxes of 64 M-rows by 128 bytes and feed wgmma as
// MN-major tiles (the transpose bits), so nothing is transposed in memory.
// A block owns 128 rows of dW (two warpgroups x m64; a second warpgroup past
// K_in reads the first one's box and writes nothing) and all N <= 256
// columns, and sums a contiguous range of M in 64-row chunks through a
// 4-stage ring. Blocks are laid out split-major, so the K_in / 128 blocks that
// read the same G rows run side by side and the second read hits L2. About
// one block per SM; the split partials are summed by reduce_splits in split
// order, so reruns are bitwise equal.
// ---------------------------------------------------------------------------

constexpr int WG_CHUNK = 64;  // M rows per ring stage
constexpr int WG_STAGES = 4;

template <int BN>
struct Wgrad {
  static constexpr int X_BYTES = 2 * WG_CHUNK * ROW_BYTES;         // one box per warpgroup
  static constexpr int G_BYTES = (BN / 64) * WG_CHUNK * ROW_BYTES;  // 64 columns per box
  static constexpr int SMEM = 1024 + WG_STAGES * (X_BYTES + G_BYTES) + 2 * WG_STAGES * 8;
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_wgrad_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_g, int k_tiles, int rows_per_split,
                      int m, int k_in, int n, float* __restrict__ partial) {
  using W = Wgrad<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sx = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sg = sx + WG_STAGES * W::X_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sg + WG_STAGES * W::G_BYTES);
  uint64_t* empty = full + WG_STAGES;
  const int kt = blockIdx.x % k_tiles, split = blockIdx.x / k_tiles;
  const int r0 = split * rows_per_split;
  const int chunks = min(rows_per_split, m - r0 + WG_CHUNK - 1) / WG_CHUNK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      const int x0 = kt * 2 * WG_ROWS;
      const int x1 = x0 + WG_ROWS < k_in ? x0 + WG_ROWS : x0;  // never a box wholly past K_in
      int stage = 0;
      uint32_t phase = 0;
      for (int c = 0; c < chunks; ++c) {
        const uint32_t fb = smem_u32(full + stage);
        const int row = r0 + c * WG_CHUNK;
        mbar_wait(smem_u32(empty + stage), phase ^ 1);
        mbar_expect_tx(fb, W::X_BYTES + W::G_BYTES);
        uint8_t* x = sx + stage * W::X_BYTES;
        tma_load(smem_u32(x), &map_x, fb, x0, row);
        tma_load(smem_u32(x + WG_CHUNK * ROW_BYTES), &map_x, fb, x1, row);
#pragma unroll
        for (int box = 0; box < BN / 64; ++box)
          tma_load(smem_u32(sg + stage * W::G_BYTES + box * WG_CHUNK * ROW_BYTES), &map_g, fb,
                   box * 64, row);
        if (++stage == WG_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < chunks; ++c) {
    mbar_wait(smem_u32(full + stage), phase);
    const uint32_t a = smem_u32(sx + stage * W::X_BYTES + wg * WG_CHUNK * ROW_BYTES);
    const uint32_t b = smem_u32(sg + stage * W::G_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_CHUNK / 16; ++kk)  // 16 rows = two 8-row groups of 1024 bytes
      wgmma_bf16<1>(acc, sw128_mn_desc(a + kk * 2048, WG_CHUNK * ROW_BYTES),
                    sw128_mn_desc(b + kk * 2048, WG_CHUNK * ROW_BYTES), (c | kk) != 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    mbar_arrive(smem_u32(empty + stage));
    if (++stage == WG_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  const int rl = (t >> 5) * 16 + ((t & 31) >> 2);
  const int cq = (t & 3) * 2;
  float* out = partial + static_cast<int64_t>(split) * k_in * n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kt * 2 * WG_ROWS + wg * WG_ROWS + rl + 8 * h;
    if (row >= k_in) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + cq;
      if (col < n)
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(row) * n + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and the launch.
// ---------------------------------------------------------------------------

// a row-major 2D operand as the Python side describes it
// (mlp_kernel.tma_2d): base address, true width and rows in elements, row
// stride in bytes, box width and rows in elements
struct MapSpec {
  const void* ptr;
  int width, rows, stride, box_w, box_h;
};

bool encode(CUtensorMap* map, const MapSpec& s, bool f32, int box_h) {
  EncodeTiledFn fn = encode_tiled();
  const int es = f32 ? 4 : 2;
  if (fn == nullptr || s.ptr == nullptr || s.width <= 0 || s.rows <= 0 || s.box_w * es != ROW_BYTES ||
      s.box_h != box_h || s.stride % 16 != 0 || reinterpret_cast<uintptr_t>(s.ptr) % 16 != 0 ||
      static_cast<int64_t>(s.width) * es > s.stride)
    return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(s.width), static_cast<cuuint64_t>(s.rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(s.stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(s.box_w), static_cast<cuuint32_t>(s.box_h)};
  const cuuint32_t elem[2] = {1, 1};
  // OOB_FILL_NONE fills the box outside the tensor with zeros
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(s.ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, typename TC>
int launch(const CUtensorMap* maps, int kt1, int kt2, int m, const Epilogue& ep,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN, TC>();
  auto kernel = gemm_sm90_kernel<BN, TC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (m + BM - 1) / BM;
  const int grid = tiles < sms ? tiles : sms;
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], kt1, kt2,
                                          tiles, ep);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, typename TC>
int launch_dgrad(const CUtensorMap* maps, int kts, int m, int grid, const Dgrad& ep,
                 cudaStream_t stream) {
  constexpr int smem = dgrad_smem_bytes<BN, TC>();
  static_assert(smem <= 232448, "shared memory");
  auto kernel = gemm_dgrad_kernel<BN, TC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (m + BM - 1) / BM;
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], kts, tiles, ep);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_wgrad(const CUtensorMap* maps, int k_tiles, int splits, int rows_per_split, int m,
                 int k_in, int n, float* partial, cudaStream_t stream) {
  constexpr int smem = Wgrad<BN>::SMEM;
  static_assert(smem <= 232448, "shared memory");
  auto kernel = gemm_wgrad_kernel<BN>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<k_tiles * splits, THREADS, smem, stream>>>(maps[0], maps[1], k_tiles, rows_per_split,
                                                      m, k_in, n, partial);
  return static_cast<int>(cudaGetLastError());
}

// the tile width a bf16 (32 ... 256) or f32 (32 ... 128) output n wide runs at;
// 0 if none holds it
int tile_width(int n, bool f32) {
  for (int w = 32; w <= (f32 ? 128 : 256); w *= 2)
    if (n <= w) return w;
  return 0;
}

}  // namespace

extern "C" {

// C = act(A1 @ B1^T [+ A2 @ B2^T] [+ rowterm[row / row_div]] [+ bias]) with B1, B2 the
// K-major (N x K) weights. Each operand is a MapSpec (see above); a2 / b2 null
// for one input. N is c's width: 32, 64, 128 or 256 (bf16 c) or 32, 64, 128
// (f32 c); a row term needs N <= 128. Returns a cudaError
// (cudaErrorInvalidValue for an operand the kernel cannot take).
int nnt_gemm_sm90(const void* a1, int a1_w, int a1_rows, int a1_stride, int a1_bw, int a1_bh,
                  const void* a2, int a2_w, int a2_rows, int a2_stride, int a2_bw, int a2_bh,
                  const void* b1, int b1_w, int b1_rows, int b1_stride, int b1_bw, int b1_bh,
                  const void* b2, int b2_w, int b2_rows, int b2_stride, int b2_bw, int b2_bh,
                  void* c, int c_w, int c_rows, int c_stride, int c_bw, int c_bh, int c_f32,
                  const float* bias, int relu, const float* rowterm, int ld_rowterm, int row_div,
                  void* stream) {
  const MapSpec sa1{a1, a1_w, a1_rows, a1_stride, a1_bw, a1_bh};
  const MapSpec sa2{a2, a2_w, a2_rows, a2_stride, a2_bw, a2_bh};
  const MapSpec sb1{b1, b1_w, b1_rows, b1_stride, b1_bw, b1_bh};
  const MapSpec sb2{b2, b2_w, b2_rows, b2_stride, b2_bw, b2_bh};
  const MapSpec sc{c, c_w, c_rows, c_stride, c_bw, c_bh};
  const int m = c_rows, n = c_w;
  const bool two = a2 != nullptr;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  if (a1_rows != m || b1_rows != n || b1_w != a1_w || (two && (a2_rows != m || b2_rows != n ||
                                                               b2_w != a2_w || b2 == nullptr)))
    return bad;
  if (row_div < 1 || (rowterm && (n > 128 || ld_rowterm % 2 ||
                                  reinterpret_cast<uintptr_t>(rowterm) % 8)))
    return bad;
  CUtensorMap maps[5];
  if (!encode(&maps[0], sa1, false, BM) || !encode(&maps[2], sb1, false, n) ||
      !encode(&maps[4], sc, c_f32 != 0, WG_ROWS))
    return bad;
  if (two) {
    if (!encode(&maps[1], sa2, false, BM) || !encode(&maps[3], sb2, false, n)) return bad;
  } else {
    maps[1] = maps[0];
    maps[3] = maps[2];
  }
  const int kt1 = (a1_w + BK - 1) / BK, kt2 = two ? (a2_w + BK - 1) / BK : 0;
  const Epilogue ep{bias, rowterm, ld_rowterm, row_div, relu, m};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c_f32) {
    switch (n) {
      case 32: return launch<32, float>(maps, kt1, kt2, m, ep, st);
      case 64: return launch<64, float>(maps, kt1, kt2, m, ep, st);
      case 128: return launch<128, float>(maps, kt1, kt2, m, ep, st);
    }
  } else {
    switch (n) {
      case 32: return launch<32, bf16>(maps, kt1, kt2, m, ep, st);
      case 64: return launch<64, bf16>(maps, kt1, kt2, m, ep, st);
      case 128: return launch<128, bf16>(maps, kt1, kt2, m, ep, st);
      case 256: return launch<256, bf16>(maps, kt1, kt2, m, ep, st);
    }
  }
  return bad;
}

// Input gradient: C = mask(A @ B^T [+ bf16(gsig[row * ld_gsig]) * wd[col]]),
// A the bf16 cotangent (M x K), B the bf16 weight rows (N x K, K-major), C bf16
// (N <= 256) or f32 (N <= 128) M x N, each a MapSpec (B's box as deep as the
// tile width N rounds up to); `mask` (null for none) the bf16 M x N
// activation whose entries <= 0 zero the output (bf16 C, N a tile width).
// `grid` persistent blocks (1 ... ceil(M / 128)) walk the 128-row tiles;
// with `colsum`, its 2 grid rows of N f32 receive the column sums of the
// values before rounding (N a tile width). wd: N bf16.
int nnt_gemm_dgrad(const void* a, int a_w, int a_rows, int a_stride, int a_bw, int a_bh,
                   const void* b, int b_w, int b_rows, int b_stride, int b_bw, int b_bh,
                   void* c, int c_w, int c_rows, int c_stride, int c_bw, int c_bh, int c_f32,
                   const void* mask, int k_w, int k_rows, int k_stride, int k_bw, int k_bh,
                   const float* gsig, int ld_gsig, const void* wd, float* colsum, int grid,
                   void* stream) {
  const int m = c_rows, n = c_w;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  const int bn = tile_width(n, c_f32 != 0);
  if (bn == 0 || a_rows != m || b_w != a_w || b_rows != n || grid < 1 || grid > (m + BM - 1) / BM)
    return bad;
  if (mask && (c_f32 || k_w != n || k_rows != m || n != bn)) return bad;
  if ((colsum && n != bn) ||
      (gsig && (wd == nullptr || n != bn || ld_gsig < 1 || reinterpret_cast<uintptr_t>(wd) % 4)))
    return bad;
  CUtensorMap maps[4];
  if (!encode(&maps[0], MapSpec{a, a_w, a_rows, a_stride, a_bw, a_bh}, false, BM) ||
      !encode(&maps[1], MapSpec{b, b_w, b_rows, b_stride, b_bw, b_bh}, false, bn) ||
      !encode(&maps[2], MapSpec{c, c_w, c_rows, c_stride, c_bw, c_bh}, c_f32 != 0, WG_ROWS))
    return bad;
  if (mask) {
    if (!encode(&maps[3], MapSpec{mask, k_w, k_rows, k_stride, k_bw, k_bh}, false, WG_ROWS))
      return bad;
  } else {
    maps[3] = maps[2];
  }
  const int kts = (a_w + BK - 1) / BK;
  const Dgrad ep{gsig, ld_gsig, static_cast<const bf16*>(wd), colsum, mask != nullptr, m};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c_f32) {
    switch (bn) {
      case 32: return launch_dgrad<32, float>(maps, kts, m, grid, ep, st);
      case 64: return launch_dgrad<64, float>(maps, kts, m, grid, ep, st);
      case 128: return launch_dgrad<128, float>(maps, kts, m, grid, ep, st);
    }
  } else {
    switch (bn) {
      case 32: return launch_dgrad<32, bf16>(maps, kts, m, grid, ep, st);
      case 64: return launch_dgrad<64, bf16>(maps, kts, m, grid, ep, st);
      case 128: return launch_dgrad<128, bf16>(maps, kts, m, grid, ep, st);
      case 256: return launch_dgrad<256, bf16>(maps, kts, m, grid, ep, st);
    }
  }
  return bad;
}

// Weight gradient: partial[s] (K_in x N, f32) = X[rows of s]^T @ G[rows of s],
// s = 0 .. ceil(M / rows_per_split) - 1 (rows_per_split a multiple of 64), X the
// bf16 M x K_in activation and G the bf16 M x N cotangent (N a multiple of 8,
// <= 256), both MapSpecs with 64-row boxes.
int nnt_gemm_wgrad(const void* x, int x_w, int x_rows, int x_stride, int x_bw, int x_bh,
                   const void* g, int g_w, int g_rows, int g_stride, int g_bw, int g_bh,
                   int rows_per_split, float* partial, void* stream) {
  const int m = x_rows, k_in = x_w, n = g_w;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  if (g_rows != m || rows_per_split <= 0 || rows_per_split % WG_CHUNK || n % 8 || n > 256 ||
      partial == nullptr)
    return bad;
  CUtensorMap maps[2];
  if (!encode(&maps[0], MapSpec{x, x_w, x_rows, x_stride, x_bw, x_bh}, false, WG_CHUNK) ||
      !encode(&maps[1], MapSpec{g, g_w, g_rows, g_stride, g_bw, g_bh}, false, WG_CHUNK))
    return bad;
  const int k_tiles = (k_in + 2 * WG_ROWS - 1) / (2 * WG_ROWS);
  const int splits = (m + rows_per_split - 1) / rows_per_split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 64) return launch_wgrad<64>(maps, k_tiles, splits, rows_per_split, m, k_in, n, partial, st);
  if (n <= 128)
    return launch_wgrad<128>(maps, k_tiles, splits, rows_per_split, m, k_in, n, partial, st);
  return launch_wgrad<256>(maps, k_tiles, splits, rows_per_split, m, k_in, n, partial, st);
}

}  // extern "C"
