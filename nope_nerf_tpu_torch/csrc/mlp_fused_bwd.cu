// Kernels A and C backward on Hopper: each layer's input gradient and weight
// gradient in one pass over its cotangent and its saved input.
//
// Replaces, per backward, the Pallas kernels of
// nope_nerf_tpu/ops/pallas/mlp_kernel.py
//   A backward _make_bwd_composite_kernel (l.702), reached from
//              _fused_mlp_composite_bwd (l.909);
//   C backward _make_bwd_kernel (l.258), reached from _fused_mlp_bwd ->
//              _fused_mlp_bwd_call (l.440);
// both over the same chain backward
// (nope_nerf_tpu_torch/ops/kernels/mlp_kernel.py::_chain_bwd). The TPU
// kernel walks the ray tiles in order and accumulates every dW in an output
// block that stays resident across its sequential grid. Here the blocks run
// in parallel, so each weight gradient is a cross-block reduction: every
// block sums its own rows into registers and writes one partial, and one
// launch at the end of the backward (reduce_segments) adds the partials of
// every layer in a fixed order. No atomics: reruns are bitwise equal.
//
// One launch per layer j with weight W_j (fan_in x fan_out = N), cotangent
// g_j (M x N, bf16, already masked) and saved input a_{j-1} (M x fan_in,
// bf16) computes
//   g_{j-1} = bf16(mask(a_{j-1}) * (g_j W_j^T [+ bf16(gsig) wd^T]))   input gradient
//   colsum  = the f32 column sums of g_{j-1} before rounding             bias of layer j-1
//   dW_j    = a_{j-1}^T g_j, f32                                          weight gradient
// (and for fc_feature, fc_density's dW = a13^T bf16(g_raw[:, 0]) from the
// same a13 tile). A layer's input may be two groups of columns -- trunk1_0's
// [a03 | enc], rgb_layer's [feat | denc] -- each with its own input-gradient
// output (bf16 cotangent or the f32 cotangent of an encoding) and its own
// rows of dW.
//
// What bounds it on the H100: a 256 x 256 layer at M = 131,072 reads g_j and
// a_{j-1} and writes g_{j-1}, 201 MB, 60 us at 3.35 TB/s, against 34 GFLOP,
// 35 us at the bf16 peak: bytes. The layer-by-layer chain read g_j and
// a_{j-1} twice (once for the input gradient, once for the weight
// gradient): 335 MB.
//
// Design: the weight gradient's fan_in x N f32 accumulator does not fit one
// block's registers at fan_in = N = 256 (256 KB), so the blocks split fan_in:
//   * A block owns one 64-column slice of fan_in, for both outputs: that
//     slice of g_{j-1} (a 64-wide input-gradient tile, masked by the same
//     slice of a_{j-1}) and those 64 rows of dW_j, which it accumulates in
//     registers over a contiguous range of 128-row tiles. The grid is
//     (row splits) x (slices), the slices of a split side by side, so the
//     g_j tile they all read comes from memory once and from L2 for the
//     others; about one block per SM. (Measured on the H100 and dropped: a
//     cluster of the slices with the g_j tile multicast into it, whose
//     refills wait for the slowest block of the cluster, and 64-row tiles in
//     a deeper ring, whose warpgroups then run in step: both slower.)
//   * The block's 64 rows of W_j (K-major: already fan_in x fan_out rows, as
//     mlp_kernel._padded stores them) are loaded once and stay in shared
//     memory. One producer thread streams each tile's g_j (128 rows x N) and
//     a_{j-1} slice (128 x 64) by TMA into a 2-4-stage mbarrier ring.
//   * Two consumer warpgroups of 64 rows each: the input gradient is an
//     m64n64 wgmma chain over N (A = the g_j rows, K-major), committed first;
//     the weight gradient's wgmmas (A = the a_{j-1} slice, B = g_j, both
//     MN-major: the transpose bits, nothing is transposed in memory) are
//     committed after it and run while the epilogue of the input gradient
//     (rank-1 term, mask read from the a_{j-1} tile in shared memory, column
//     sums in registers, bf16 or f32 rounding, TMA store) runs. For N >= 128
//     warpgroup w owns dW columns [w N / 2, (w + 1) N / 2) over all 128 rows
//     of a tile (64 registers a thread at N = 256); for N <= 64 each
//     warpgroup sums its own 64 rows into a 64-wide accumulator and the two
//     are added (warpgroup 0's + warpgroup 1's) at the end. Every block of a
//     launch that takes weight gradients issues their wgmmas, needed or not:
//     under a branch ptxas serializes every wgmma of the kernel.
//   * With the weight gradient off (test-time pose optimisation) the same
//     launch runs the input gradient alone, so its outputs are bitwise those
//     of the full backward.
//   * Widths that are not multiples of 64 (encodings 63, 27): the maps carry
//     the true widths, TMA zero-fills the boxes past them and clips the
//     stores; rows past M load as zeros and add nothing to any sum.
// Shared memory at N = 256: 32 KB of W_j + 2 x 80 KB ring + 32 KB of output
// staging: one block per SM.
//
// Also here: heads_bwd_fused, the rgb head's backward with the heads'
// weight-gradient work folded in (the first cotangent g_hr, rgb_layer's
// bias, fc_rgb's dW and the two heads' biases from one read of g_raw and hr),
// and reduce_segments, the one split reduction at the end of a backward.

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;          // rows per tile
constexpr int F = 64;            // fan_in columns per block
constexpr int ROW_BYTES = 128;   // every box is one 128-byte swizzle row wide
constexpr int WG_ROWS = 64;      // rows per consumer warpgroup
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int SMEM_MAX = 232448;
constexpr int G_BOX = BM * ROW_BYTES;       // a 64-column box of a 128-row tile
constexpr int X_BYTES = G_BOX;              // the a_{j-1} slice of a tile
constexpr int W_BOX = F * ROW_BYTES;        // a 64-column box of the W_j slice
constexpr int OUT_WG = 2 * WG_ROWS * ROW_BYTES;  // a warpgroup's output: 1 bf16 or 2 f32 boxes

template <int N>
struct Pass {
  static constexpr int BOXES = (N + 63) / 64;
  static constexpr int G_BYTES = BOXES * G_BOX;
  static constexpr int STAGE = G_BYTES + X_BYTES;
  static constexpr int W_BYTES = BOXES * W_BOX;
  static constexpr int FIXED = 1024 + W_BYTES + 2 * OUT_WG + 256;
  static constexpr int FIT = (SMEM_MAX - FIXED) / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static constexpr bool COL_SPLIT = N >= 128;        // see the head of the file
  static constexpr int WN = COL_SPLIT ? N / 2 : 64;  // dW accumulator width
};

struct Group {
  int k;       // true width of the group's columns of the layer's input
  int slices;  // ceil(k / 64) blocks
  int f32;     // its input gradient is f32 (an encoding's), else bf16
  int mask;    // masked by its activation (group 0 only)
  int wgrad;   // its rows of dW are computed
  int row0;    // its first row of dW
};

struct Args {
  Group grp[2];
  int groups;
  int n, m, tiles, tiles_per_split;
  int dw_rows;             // rows of one split's dW partial
  float* dw_partial;       // (splits, dw_rows, n), or null: no weight gradient
  float* colsum_partial;   // (splits, grp[0].k), or null
  float* rowdot_partial;   // (splits, grp[0].k): a^T bf16(gsig), or null
  const float* gsig;       // rank-1 rows (row stride ld_gsig), or null
  int ld_gsig;
  const bf16* wd;          // rank-1 columns (grp[0].k)
};

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int x, int y) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(x), "r"(y)
               : "memory");
}

// barrier 3 across the two consumer warpgroups
__device__ __forceinline__ void pair_sync() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); }

// byte offset of (row, byte column) in a tile stored as boxes of 128-byte
// rows, `box` bytes apart: 16-byte chunk c of row r at chunk c ^ (r % 8)
__device__ __forceinline__ int sw_at(int row, int byte_col, int box) {
  const int b = byte_col & 127;
  return (byte_col >> 7) * box + row * ROW_BYTES + ((((b >> 4) ^ (row & 7)) << 4) | (b & 15));
}

// the sum of v over the eight lanes that hold the same columns (lane bits
// 2-4); every lane ends with the same value
__device__ __forceinline__ float lane_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// A block's per-column sums (colsum, rowdot) over its rows, in a fixed
// order: lanes, then the eight warps in order through shared memory; written
// as row `split` of a (splits, k) partial.
__device__ __forceinline__ void write_col_sums(float (&v)[16], float* red, float* partial,
                                               int split, int k, int col0, int tid) {
  const int warp = tid >> 5, lane = tid & 31, cq = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = lane_sum(v[i]);
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[warp * F + 8 * j + cq] = v[2 * j];
      red[warp * F + 8 * j + cq + 1] = v[2 * j + 1];
    }
  }
  pair_sync();
  if (tid < F && col0 + tid < k) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w * F + tid];
    partial[static_cast<int64_t>(split) * k + col0 + tid] = s;
  }
}

// The two consumer warpgroups of mlp_fused_bwd_kernel: every tile's input
// gradient (and its epilogue) and weight-gradient products, then the
// block's partial sums.
template <int N, bool WGRAD>
__device__ __forceinline__ void consume(const Args& a, const Group& G, uint8_t* sw, uint8_t* ring,
                                        uint8_t* sout, uint64_t* full, uint64_t* empty,
                                        uint64_t* wbar, bool wgrad, bool rank1, bool rowdot,
                                        bool colsum, bool mask, const CUtensorMap* map_o, int col0,
                                        int split, int t0, int t1) {
  using P = Pass<N>;
  constexpr int STAGES = P::STAGES;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int rl = (t >> 5) * 16 + ((t & 31) >> 2), cq = (t & 3) * 2;
  uint8_t* my_out = sout + wg * OUT_WG;
  const uint32_t w_addr = smem_u32(sw);
  float acc_w[P::WN / 2];
#pragma unroll
  for (int i = 0; i < P::WN / 2; ++i) acc_w[i] = 0.f;
  float csum[16], rdot[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) csum[i] = rdot[i] = 0.f;
  mbar_wait(smem_u32(wbar), 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int tile = t0; tile < t1; ++tile) {
    mbar_wait(smem_u32(full + stage), phase);
    uint8_t* st = ring + stage * P::STAGE;
    const uint32_t g_addr = smem_u32(st), x_addr = smem_u32(st + P::G_BYTES);
    const uint8_t* xs = st + P::G_BYTES;

    // input gradient: (this warpgroup's 64 rows of g_j) @ (the W_j slice)^T
    float acc_d[32];
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < P::BOXES; ++b)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 bf16 = 32 bytes along the swizzled row
        wgmma_bf16<0>(acc_d, sw128_desc(g_addr + b * G_BOX + wg * WG_ROWS * ROW_BYTES + kk * 32),
                      sw128_desc(w_addr + b * W_BOX + kk * 32), (b | kk) != 0);
    wgmma_commit();
    // weight gradient: (the a_{j-1} slice)^T @ g_j, down the tile's rows.
    // Issued by every block of a launch that takes weight gradients, needed
    // or not (a block without one discards them): a wgmma under a branch is
    // serialized by ptxas.
    if constexpr (WGRAD) {
      if constexpr (P::COL_SPLIT) {
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)  // 16 rows = two 8-row groups of 1024 bytes
          wgmma_bf16<1>(acc_w, sw128_mn_desc(x_addr + kk * 2048, G_BOX),
                        sw128_mn_desc(g_addr + wg * (P::WN / 64) * G_BOX + kk * 2048, G_BOX), 1);
      } else {
#pragma unroll
        for (int kk = 0; kk < WG_ROWS / 16; ++kk)
          wgmma_bf16<1>(acc_w, sw128_mn_desc(x_addr + wg * WG_ROWS * ROW_BYTES + kk * 2048, G_BOX),
                        sw128_mn_desc(g_addr + wg * WG_ROWS * ROW_BYTES + kk * 2048, G_BOX), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(acc_d);

    // epilogue, while the weight gradient's products run
    const int row0 = tile * BM + wg * WG_ROWS;
    float gs[2] = {0.f, 0.f};
    if (rank1) {  // rows past M add nothing
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + rl + 8 * h;
        if (gr < a.m)
          gs[h] = __bfloat162float(
              __float2bfloat16_rn(a.gsig[static_cast<int64_t>(gr) * a.ld_gsig]));
      }
    }
    if (t == 0) bulk_wait_read();  // the last tile's store has left the staging tile
    wg_barrier(1 + wg);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + cq;
      float2 w = make_float2(0.f, 0.f);
      if (rank1 && col0 + col < G.k)
        w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.wd + col0 + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rl + 8 * h;
        float v0 = acc_d[4 * j + 2 * h], v1 = acc_d[4 * j + 2 * h + 1];
        if (rank1) {  // the products of two bf16 are exact in f32
          v0 += gs[h] * w.x;
          v1 += gs[h] * w.y;
        }
        if (mask || rowdot) {  // the activation sits where this output goes
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              xs + sw_at(wg * WG_ROWS + r, col * 2, X_BYTES)));
          if (mask) {
            if (!(x.x > 0.f)) v0 = 0.f;
            if (!(x.y > 0.f)) v1 = 0.f;
          }
          if (rowdot) {
            rdot[2 * j] += x.x * gs[h];
            rdot[2 * j + 1] += x.y * gs[h];
          }
        }
        if (colsum) {
          csum[2 * j] += v0;
          csum[2 * j + 1] += v1;
        }
        if (G.f32)
          *reinterpret_cast<float2*>(my_out + sw_at(r, col * 4, WG_ROWS * ROW_BYTES)) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(my_out + sw_at(r, col * 2, WG_ROWS * ROW_BYTES)) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
    fence_async_smem();
    wg_barrier(1 + wg);
    if (t == 0) {
      const int box_cols = G.f32 ? 32 : 64;
      for (int b = 0; b < (G.f32 ? 2 : 1); ++b)
        if (col0 + b * box_cols < G.k && row0 < a.m)  // never a box wholly outside
          tma_store(map_o, smem_u32(my_out + b * WG_ROWS * ROW_BYTES), col0 + b * box_cols, row0);
      bulk_commit();
    }
    if constexpr (WGRAD) {
      wgmma_wait<0>();
      fence_regs(acc_w);
    }
    mbar_arrive(smem_u32(empty + stage));  // this tile's products and mask reads are done
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (t == 0) bulk_wait();
  if (!(wgrad || colsum || rowdot)) return;  // uniform across the block

  // the partials: the ring is free once both warpgroups are past their last
  // tile
  pair_sync();
  float* red = reinterpret_cast<float*>(ring);
  if (wgrad) {
    if constexpr (!P::COL_SPLIT) {  // warpgroup 0's rows + warpgroup 1's
      if (wg == 1)
#pragma unroll
        for (int i = 0; i < P::WN / 2; ++i) red[i * 128 + t] = acc_w[i];
      pair_sync();
      if (wg == 0)
#pragma unroll
        for (int i = 0; i < P::WN / 2; ++i) acc_w[i] += red[i * 128 + t];
    }
    if (P::COL_SPLIT || wg == 0) {
      float* out = a.dw_partial + static_cast<int64_t>(split) * a.dw_rows * a.n;
      const int c0 = P::COL_SPLIT ? wg * P::WN : 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = col0 + rl + 8 * h;
        if (r >= G.k) continue;
        float* orow = out + static_cast<int64_t>(G.row0 + r) * a.n;
#pragma unroll
        for (int j = 0; j < P::WN / 8; ++j) {
          const int c = c0 + 8 * j + cq;
          if (c < a.n)
            *reinterpret_cast<float2*>(orow + c) =
                make_float2(acc_w[4 * j + 2 * h], acc_w[4 * j + 2 * h + 1]);
        }
      }
    }
  }
  // red[4096 ...]: the column sums' warp rows, after the dW rows above
  if (colsum) write_col_sums(csum, red + 4096, a.colsum_partial, split, G.k, col0, threadIdx.x);
  if (rowdot) {
    if (colsum) pair_sync();  // the column sums have read their rows
    write_col_sums(rdot, red + 4096, a.rowdot_partial, split, G.k, col0, threadIdx.x);
  }
}

template <int N, bool WGRAD>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_fused_bwd_kernel(const __grid_constant__ CUtensorMap map_g,
                         const __grid_constant__ CUtensorMap map_x0,
                         const __grid_constant__ CUtensorMap map_x1,
                         const __grid_constant__ CUtensorMap map_w0,
                         const __grid_constant__ CUtensorMap map_w1,
                         const __grid_constant__ CUtensorMap map_o0,
                         const __grid_constant__ CUtensorMap map_o1,
                         const __grid_constant__ Args a) {
  using P = Pass<N>;
  constexpr int STAGES = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle needs 1024-byte-aligned buffers
  uint8_t* sw = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = sw + P::W_BYTES;
  uint8_t* sout = ring + STAGES * P::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sout + 2 * OUT_WG);
  uint64_t* empty = full + STAGES;
  uint64_t* wbar = empty + STAGES;

  const int slices = a.grp[0].slices + (a.groups > 1 ? a.grp[1].slices : 0);
  const int slice = blockIdx.x % slices, split = blockIdx.x / slices;
  const int gi = slice < a.grp[0].slices ? 0 : 1;
  const Group& G = a.grp[gi];
  const int col0 = (gi == 0 ? slice : slice - a.grp[0].slices) * F;
  const bool wgrad = a.dw_partial != nullptr && G.wgrad;
  const bool rank1 = gi == 0 && a.gsig != nullptr;
  const bool rowdot = rank1 && a.rowdot_partial != nullptr;
  const bool colsum = gi == 0 && a.colsum_partial != nullptr;
  const bool mask = G.mask != 0;
  const bool load_x = mask || wgrad || rowdot;
  const CUtensorMap* map_x = gi ? &map_x1 : &map_x0;
  const CUtensorMap* map_w = gi ? &map_w1 : &map_w0;
  const CUtensorMap* map_o = gi ? &map_o1 : &map_o0;
  const int t0 = split * a.tiles_per_split;
  const int t1 = min(a.tiles, t0 + a.tiles_per_split);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), CONSUMERS);
    }
    mbar_init(smem_u32(wbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      // the block's rows of W_j, once; then every tile's g_j and a_{j-1} slice
      mbar_expect_tx(smem_u32(wbar), P::W_BYTES);
#pragma unroll
      for (int b = 0; b < P::BOXES; ++b)
        tma_load(smem_u32(sw + b * W_BOX), map_w, smem_u32(wbar), b * 64, col0);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = t0; tile < t1; ++tile) {
        const uint32_t fb = smem_u32(full + stage);
        uint8_t* st = ring + stage * P::STAGE;
        mbar_wait(smem_u32(empty + stage), phase ^ 1);  // the first pass is free
        mbar_expect_tx(fb, P::G_BYTES + (load_x ? X_BYTES : 0));
#pragma unroll
        for (int b = 0; b < P::BOXES; ++b)
          tma_load(smem_u32(st + b * G_BOX), &map_g, fb, b * 64, tile * BM);
        if (load_x) tma_load(smem_u32(st + P::G_BYTES), map_x, fb, col0, tile * BM);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  consume<N, WGRAD>(a, G, sw, ring, sout, full, empty, wbar, wgrad, rank1, rowdot, colsum, mask,
                    map_o, col0, split, t0, t1);
}


// ---------------------------------------------------------------------------
// The rgb head's backward with the heads' weight-gradient work:
//   g_hr = relu_mask(hr) * (bf16(g_raw[:, 1:4]) @ bf16(wc)^T), bf16 (m x h2)
// and, with partials, per block of `rows` rows: the f32 column sums of g_hr
// before rounding (rgb_layer's bias), hr^T bf16(g_raw[:, 1:4]) (fc_rgb's dW,
// h2 x 3) and g_raw's column sums (the two heads' biases, 4). A thread owns
// two columns of a row group; the row groups' sums are added in group order
// through shared memory. Bound by the bytes of hr and g_hr.
// ---------------------------------------------------------------------------

constexpr int HB_THREADS = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(HB_THREADS)
    heads_bwd_fused_kernel(const float* __restrict__ g_raw, const bf16* __restrict__ hr, int ld_hr,
                           const bf16* __restrict__ wc, bf16* __restrict__ g_hr, int ld_ghr, int m,
                           int h2, int rows, float* __restrict__ p_bias, float* __restrict__ p_dw,
                           float* __restrict__ p_heads) {
  __shared__ float red[HB_THREADS][12];
  const int pairs = h2 / 2, groups = HB_THREADS / pairs;
  const int p = threadIdx.x % pairs, grp = threadIdx.x / pairs;
  const bool sums = p_bias != nullptr;
  float acc[12] = {};  // column sums (2), dW (2 x 3), the heads' sums (4, p == 0)
  if (grp < groups) {
    float w[2][3];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < 3; ++c) w[e][c] = __bfloat162float(wc[(2 * p + e) * 3 + c]);
    const int r1 = min(m, (blockIdx.x + 1) * rows);
#pragma unroll 4
    for (int r = blockIdx.x * rows + grp; r < r1; r += groups) {
      const float4 g = *reinterpret_cast<const float4*>(g_raw + static_cast<int64_t>(r) * 4);
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(hr + static_cast<int64_t>(r) * ld_hr + 2 * p));
      const float gr[3] = {round_bf16(g.y), round_bf16(g.z), round_bf16(g.w)};
      const float hv[2] = {h.x, h.y};
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)  // heads_bwd_kernel's order
        v[e] = hv[e] > 0.f ? gr[0] * w[e][0] + gr[1] * w[e][1] + gr[2] * w[e][2] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(g_hr + static_cast<int64_t>(r) * ld_ghr + 2 * p) =
          __floats2bfloat162_rn(v[0], v[1]);
      if (sums) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[e] += v[e];
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[2 + 3 * e + c] += hv[e] * gr[c];
        }
        if (p == 0) {
          acc[8] += g.x;
          acc[9] += g.y;
          acc[10] += g.z;
          acc[11] += g.w;
        }
      }
    }
  }
  if (!sums) return;
#pragma unroll
  for (int i = 0; i < 12; ++i) red[threadIdx.x][i] = acc[i];
  __syncthreads();
  if (threadIdx.x >= pairs) return;
  float s[12] = {};
  for (int q = 0; q < groups; ++q)
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] += red[q * pairs + p][i];
  const int64_t b = blockIdx.x;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    p_bias[b * h2 + 2 * p + e] = s[e];
#pragma unroll
    for (int c = 0; c < 3; ++c) p_dw[(b * h2 + 2 * p + e) * 3 + c] = s[2 + 3 * e + c];
  }
  if (p == 0) {
    for (int q = 0; q < groups; ++q)
#pragma unroll
      for (int i = 8; i < 12; ++i) s[i] += red[q * pairs][i];
#pragma unroll
    for (int i = 0; i < 4; ++i) p_heads[b * 4 + i] = s[8 + i];
  }
}

// ---------------------------------------------------------------------------
// The split reduction of a backward: for each segment, out[i] = the sum over
// s = 0 .. splits - 1 of partial[s * stride + i], in a fixed order. A block
// of GROUPS warps owns 32 consecutive outputs of one segment; lane e of warp
// q sums splits q, q + GROUPS, ... of its output in order, and the warps'
// sums are added in warp order.
// ---------------------------------------------------------------------------

constexpr int MAX_SEGMENTS = 32;
constexpr int GROUPS = 8;

struct Segment {
  const float* partial;
  float* out;
  int64_t stride;
  int splits, size, block0;
};

struct Segments {
  Segment s[MAX_SEGMENTS];
  int count;
};

__global__ void __launch_bounds__(32 * GROUPS)
    reduce_segments_kernel(const __grid_constant__ Segments segs) {
  __shared__ float part[GROUPS][32];
  int k = 0;
  while (k + 1 < segs.count && static_cast<int>(blockIdx.x) >= segs.s[k + 1].block0) ++k;
  const Segment& sg = segs.s[k];
  const int e = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int i = (blockIdx.x - sg.block0) * 32 + e;
  float s = 0.f;
  if (i < sg.size)
#pragma unroll 4
    for (int p = q; p < sg.splits; p += GROUPS) s += sg.partial[p * sg.stride + i];
  part[q][e] = s;
  __syncthreads();
  if (q == 0 && i < sg.size) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < GROUPS; ++w) total += part[w][e];
    sg.out[i] = total;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A row-major 2D operand as mlp_kernel.tma_2d describes it: address, true
// width and rows in elements, row stride in bytes, box width and rows. The
// box is one 128-byte swizzle row wide and box_h rows deep.
bool encode(CUtensorMap* map, const long long* s, bool f32, int box_h) {
  EncodeTiledFn fn = encode_tiled();
  const int es = f32 ? 4 : 2;
  const void* ptr = reinterpret_cast<const void*>(static_cast<uintptr_t>(s[0]));
  const long long width = s[1], rows = s[2], stride = s[3], box_w = s[4], bh = s[5];
  if (fn == nullptr || ptr == nullptr || width <= 0 || rows <= 0 || box_w * es != ROW_BYTES ||
      bh != box_h || stride % 16 != 0 || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 ||
      width * es > stride)
    return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(bh)};
  const cuuint32_t elem[2] = {1, 1};
  // OOB_FILL_NONE fills the box outside the tensor with zeros
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N, bool WGRAD>
int launch(const CUtensorMap* maps, const Args& a, int grid, cudaStream_t stream) {
  constexpr int smem = Pass<N>::SMEM;
  static_assert(smem <= SMEM_MAX, "shared memory");
  auto kernel = mlp_fused_bwd_kernel<N, WGRAD>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
                                          maps[6], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One layer's fused backward pass (see the head of this file).
//   specs: 7 x 6 int64 tensor-map arguments (address, width, rows, row
//     stride in bytes, box width, box rows): g (box rows 128), x0, x1 (128),
//     w0, w1 (64), out0, out1 (64); address 0 for an absent one (x of a
//     group that neither masks nor takes a weight gradient; group 1).
//   ptrs: dw_partial, colsum_partial, rowdot_partial, gsig, wd (0: none).
//   ints: n, m, splits, tiles_per_split, ld_gsig, dw_rows, then per group
//     k, f32, mask, wgrad (k = 0: no group 1).
// Returns a cudaError (cudaErrorInvalidValue for arguments the kernel cannot
// take).
int nnt_mlp_fused_bwd(const long long* specs, const unsigned long long* ptrs, const int* ints,
                      void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.n = ints[0];
  a.m = ints[1];
  const int splits = ints[2];
  a.tiles_per_split = ints[3];
  a.ld_gsig = ints[4];
  a.dw_rows = ints[5];
  a.dw_partial = reinterpret_cast<float*>(static_cast<uintptr_t>(ptrs[0]));
  a.colsum_partial = reinterpret_cast<float*>(static_cast<uintptr_t>(ptrs[1]));
  a.rowdot_partial = reinterpret_cast<float*>(static_cast<uintptr_t>(ptrs[2]));
  a.gsig = reinterpret_cast<const float*>(static_cast<uintptr_t>(ptrs[3]));
  a.wd = reinterpret_cast<const bf16*>(static_cast<uintptr_t>(ptrs[4]));
  if (a.m <= 0) return 0;
  a.tiles = (a.m + BM - 1) / BM;
  a.groups = ints[10] > 0 ? 2 : 1;
  int slices = 0;
  for (int g = 0; g < a.groups; ++g) {
    const int* gi = ints + 6 + 4 * g;
    Group& G = a.grp[g];
    G = Group{gi[0], (gi[0] + F - 1) / F, gi[1], gi[2], gi[3], g == 0 ? 0 : a.grp[0].k};
    slices += G.slices;
    const bool has_x = specs[6 * (1 + g)] != 0;
    if (G.k <= 0 || (G.mask && (G.f32 || g != 0 || !has_x)) ||
        (G.wgrad && (!has_x || a.dw_partial == nullptr)))
      return bad;
  }
  if (splits < 1 || a.tiles_per_split < 1 ||
      static_cast<long long>(splits) * a.tiles_per_split < a.tiles ||
      static_cast<long long>(splits - 1) * a.tiles_per_split >= a.tiles ||
      (a.dw_partial && a.dw_rows < a.grp[0].k + (a.groups > 1 ? a.grp[1].k : 0)) ||
      (a.colsum_partial && a.grp[0].f32) ||
      (a.gsig && (a.wd == nullptr || a.ld_gsig < 1 || reinterpret_cast<uintptr_t>(a.wd) % 4)) ||
      (a.rowdot_partial && (a.gsig == nullptr || specs[6] == 0)))
    return bad;
  // g, x0, x1, w0, w1, out0, out1
  CUtensorMap maps[7];
  if (!encode(&maps[0], specs, false, BM) || specs[1] != a.n || specs[2] != a.m) return bad;
  for (int g = 0; g < 2; ++g) {
    const long long* sx = specs + 6 * (1 + g);
    const long long* sw = specs + 6 * (3 + g);
    const long long* so = specs + 6 * (5 + g);
    if (g >= a.groups) {
      maps[1 + g] = maps[3 + g] = maps[5 + g] = maps[0];  // never read
      continue;
    }
    const Group& G = a.grp[g];
    if (sx[0] == 0)
      maps[1 + g] = maps[0];  // never read
    else if (!encode(&maps[1 + g], sx, false, BM) || sx[1] != G.k || sx[2] != a.m)
      return bad;
    if (!encode(&maps[3 + g], sw, false, F) || sw[1] != a.n || sw[2] != G.k) return bad;
    if (!encode(&maps[5 + g], so, G.f32 != 0, WG_ROWS) || so[1] != G.k || so[2] != a.m)
      return bad;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = splits * slices;
  const bool w = a.dw_partial != nullptr;
  switch (a.n) {
    case 32: return w ? launch<32, true>(maps, a, grid, st) : launch<32, false>(maps, a, grid, st);
    case 64: return w ? launch<64, true>(maps, a, grid, st) : launch<64, false>(maps, a, grid, st);
    case 128:
      return w ? launch<128, true>(maps, a, grid, st) : launch<128, false>(maps, a, grid, st);
    case 256:
      return w ? launch<256, true>(maps, a, grid, st) : launch<256, false>(maps, a, grid, st);
  }
  return bad;
}

// The rgb head's backward (see heads_bwd_fused_kernel): g_hr bf16 (m x h2,
// row stride ld_ghr), from g_raw (m x 4 f32, contiguous), hr (m x h2 bf16,
// row stride ld_hr) and wc (h2 x 3 bf16); h2 even, h2 / 2 dividing 256.
// With p_bias (ceil(m / rows) x h2), p_dw (ceil(m / rows) x h2 x 3) and
// p_heads (ceil(m / rows) x 4) the per-block partial sums, else null.
int nnt_heads_bwd_fused(const float* g_raw, const void* hr, int ld_hr, const void* wc, void* g_hr,
                        int ld_ghr, int m, int h2, int rows, float* p_bias, float* p_dw,
                        float* p_heads, void* stream) {
  if (h2 < 2 || h2 % 2 || HB_THREADS % (h2 / 2) || rows < 1 || ld_hr % 2 || ld_ghr % 2 ||
      reinterpret_cast<uintptr_t>(g_raw) % 16 || ((p_bias == nullptr) != (p_dw == nullptr)) ||
      ((p_bias == nullptr) != (p_heads == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  heads_bwd_fused_kernel<<<(m + rows - 1) / rows, HB_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      g_raw, static_cast<const bf16*>(hr), ld_hr, static_cast<const bf16*>(wc),
      static_cast<bf16*>(g_hr), ld_ghr, m, h2, rows, p_bias, p_dw, p_heads);
  return static_cast<int>(cudaGetLastError());
}

// out_i (size_i f32) = the sum over s < splits_i of partial_i[s * stride_i ...],
// for `count` <= 32 segments, in one launch.
int nnt_reduce_segments(const unsigned long long* partials, const unsigned long long* outs,
                        const long long* strides, const int* splits, const int* sizes, int count,
                        void* stream) {
  if (count < 0 || count > MAX_SEGMENTS) return static_cast<int>(cudaErrorInvalidValue);
  Segments segs{};
  int blocks = 0;
  for (int k = 0; k < count; ++k) {
    if (partials[k] == 0 || outs[k] == 0 || splits[k] < 1 || sizes[k] < 1 ||
        strides[k] < sizes[k])
      return static_cast<int>(cudaErrorInvalidValue);
    segs.s[k] = Segment{reinterpret_cast<const float*>(static_cast<uintptr_t>(partials[k])),
                        reinterpret_cast<float*>(static_cast<uintptr_t>(outs[k])), strides[k],
                        splits[k], sizes[k], blocks};
    blocks += (sizes[k] + 31) / 32;
  }
  segs.count = count;
  if (blocks == 0) return 0;
  reduce_segments_kernel<<<blocks, 32 * GROUPS, 0, static_cast<cudaStream_t>(stream)>>>(segs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
