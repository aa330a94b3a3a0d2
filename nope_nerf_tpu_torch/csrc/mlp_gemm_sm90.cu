// The forward GEMMs of Kernels A and C on Hopper: TMA loads, an mbarrier
// ring and wgmma, one persistent block per SM.
//
//   C (M x N) = act(A1 @ B1 [+ A2 @ B2] [+ rowterm[row / div]] [+ bias])
//
// A1, A2, B1, B2 bf16; f32 accumulators; bias and rowterm f32; act ReLU or
// the identity; C bf16 (the activations) or f32 (the row term itself).
//
// Serves the GEMMs inside the bodies of two Pallas kernels of
// nope_nerf_tpu/ops/pallas/mlp_kernel.py: _make_fwd_composite_kernel (l.668,
// Kernel A forward) and _make_fwd_kernel (l.244, Kernel C forward). Both run
// the same chain (nope_nerf_tpu_torch/ops/kernels/mlp_kernel.py::_chain_fwd):
// trunk0_0 (K 63), six 256 x 256 layers, trunk1_0 (K 256 + 63: A2 is the
// position encoding, so the skip concat is never built), fc_feature, and
// rgb_layer (N 128), whose direction half is a per-ray row term
// rowterm = denc @ W_rgb[D:] computed once per ray by this kernel with an f32
// output and added in the epilogue of the per-point GEMM (a TMA box cannot
// index rows by row / S).
//
// What bounds it on the H100: one layer at K = N = 256 does 2KN / (2K + 2N) =
// 128 FLOP per byte of activations in and out, under the card's ~295 FLOP/B
// ridge, so each layer GEMM is memory-bound: at M = 131,072 it reads and
// writes 2 x 67 MB, 40 us at 3.35 TB/s. The design streams the activations
// once at the memory rate and keeps the tensor cores out of the way:
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
//     128-byte-swizzle descriptors. B is the K-major (N x K) transposed
//     weight, zero-padded to a 16-byte row stride (mlp_kernel._padded_t).
//   * Epilogue: + rowterm, + bias, ReLU, round, written swizzled into a
//     shared staging tile and stored with TMA (128-byte rows, no scalar
//     stores); TMA clips the rows past M. The row term (N <= 128) is loaded
//     into registers before the tile's k-loop, which hides its latency.
//   * Widths that are not multiples of 64 (K 63, 27): each tensor map gets
//     the true width with the padded row stride, so TMA zero-fills the box's
//     missing columns and never reads the padding (uninitialised in the
//     encodings: NaN x 0 would be NaN). Rows past M load as zeros.
// No atomics: two runs give bitwise equal outputs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// spin until the phase of the given parity has completed; a phase that never
// completes (a pipeline fault) traps after ~2^30 polls instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 30)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int x, int y) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(x), "r"(y)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// make this thread's shared-memory writes visible to the TMA (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier of one consumer warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// shared-memory matrix descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (the layout a TMA load
// with CU_TENSOR_MAP_SWIZZLE_128B writes into a 1024-byte-aligned buffer).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// D (64 x N, f32, N / 2 registers a thread) (+)= A (64 x 16) @ B (16 x N);
// acc 0 overwrites D. Thread t of the warpgroup holds, for each 8-column
// block j, d[4j], d[4j+1] at row 16 (t / 32) + (t % 32) / 4, columns
// 8j + 2 (t % 4) + {0, 1}, and d[4j+2], d[4j+3] eight rows below.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

// keep the compiler from moving accumulator reads across the wgmma wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
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
    if (threadIdx.x == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int kt = 0; kt < kts; ++kt) {
          const uint32_t fb = smem_u32(full + stage);
          mbar_wait(smem_u32(empty + stage), phase ^ 1);  // the first pass is free
          mbar_expect_tx(fb, A_BYTES + B_BYTES);
          const bool second = kt >= kt1;
          const int kx = (second ? kt - kt1 : kt) * BK;
          tma_load(smem_u32(sa + stage * A_BYTES), second ? &map_a2 : &map_a1, fb, kx, tile * BM);
          tma_load(smem_u32(sb + stage * B_BYTES), second ? &map_b2 : &map_b1, fb, kx, 0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
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
    for (int kt = 0; kt < kts; ++kt) {
      mbar_wait(smem_u32(full + stage), phase);
      const uint32_t a = smem_u32(sa + stage * A_BYTES + wg * WG_ROWS * ROW_BYTES);
      const uint32_t b = smem_u32(sb + stage * B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 bf16 = 32 bytes along the swizzled row
        wgmma_bf16<BN>(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32), (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      mbar_arrive(smem_u32(empty + stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
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
// Host side: tensor maps and the launch.
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API function: reach it through the
// runtime's entry-point query, so the library needs no -lcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

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

}  // extern "C"
