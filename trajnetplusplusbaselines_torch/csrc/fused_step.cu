// Fused D-LSTM step for Hopper (sm_90a): directional grid pooling, input
// embedding, grid embedding, LSTM cell, Hidden2Normal and the masked state
// update in one launch.
//
// Replaces the Pallas TPU kernel trajnetplusplusbaselines_tpu/ops/pallas/
// fused_step.py:_kernel (:52, launched by fused_dlstm_step).  It computes what
// that kernel computes, in the port's scene-major layout: every tensor is
// [S, A, F] contiguous, flattened to S*A agent rows, and A is taken at run
// time (any A >= 1).
//
// What bounds it.  Per agent row the step is 303,868 multiply-adds, almost
// all of them in three products: the grid embedding [288]x[288,256] and the
// gates [320]x[320,512] + [128]x[128,512].  In f32 on CUDA cores that is
// 74 us at 8,192 rows (67 TFLOP/s); the h/c traffic is ~5 us.  So the bound
// is arithmetic, and the design moves it onto the tensor cores and keeps the
// weights, read again by every row tile, out of the way:
//
// - Tensor cores at f32 accuracy.  All three products run as wgmma
//   m64nNk8 tf32 with f32 accumulation, error-compensated: each operand is
//   split into a TF32 high part and the f32 remainder (rounded to TF32 by
//   the tensor core), and the sum takes a_lo*b_hi + a_hi*b_lo + a_hi*b_hi.
//   The dropped a_lo*b_lo and the remainders' rounding are ~2^-21 of each
//   product, at f32's own level.  A comes from registers, split there; B is
//   K-major in shared memory (tf32 wgmma has no transpose), without swizzle
//   (core matrices of 8 rows x 16 bytes: 128 bytes between K neighbours,
//   KS / 4 * 128 between 8-row groups).  Hidden2Normal ([128]x[128,5]) and
//   the input embedding (K=2) stay on CUDA cores.
// - A cluster of CLUSTER = 2 blocks per 64-row tile.  Block r owns hidden
//   units [64r, 64r+64) and the pooled columns [128r, 128r+128); within it
//   two warpgroups split both in halves (wgmma m64n128 for the gates,
//   m64n64 for the grid embedding).  Each warpgroup's gate columns are
//   ordered once, on the host, so that a thread's accumulators hold the
//   four gates i/f/g/o of its units: the LSTM pointwise stage needs no
//   exchange.  The pooled columns go to both blocks of the cluster through
//   distributed shared memory, and Hidden2Normal's partial sums over each
//   block's units are reduced the same way, so the grid embedding is not
//   recomputed per block.  Why 2 and not 4: a block takes ~215 KB of shared
//   memory, so one per SM, and a cluster's blocks must share a GPC, so
//   clusters of 4 leave SMs idle that clusters of 2 use.  8,192 rows are 512
//   blocks in clusters of 4 and 256, 2 waves on 132 SMs, in clusters of 2,
//   blocks that do twice the products and the same latency-bound rest.
//   The CLI's 512 rows make 16 blocks.
// - Weights in flight.  The host packs each warpgroup's weights, hi and lo
//   parts, into one stream of K slices of KS in the order the kernel
//   consumes them (the grid-embedding chunks, then the gate chunks), laid
//   out as wgmma reads them.  One thread per warpgroup keeps STAGES chunks
//   in flight with cp.async.bulk into a ring of shared-memory stages, each
//   completing on an mbarrier; the first STAGES are issued before the grid
//   is built, so they load under it.  Two wgmma groups are in flight per
//   warpgroup: a chunk's products run while the next chunk's A fragments
//   are loaded and split and the chunk before it is refilled (the A
//   registers alternate between two sets).  The chunk loops are unrolled,
//   so no wgmma sits on a branch (ptxas would serialise them).  L2 reads of
//   the weights are 2.4 MB per 64-row tile (hi and lo), 1/16 of the old
//   16-row tiles' per row.
// - The rest of a block's time is latency, at 8 warps per SM: the grid is
//   filled with `constant` and each neighbour that won its cell writes it,
//   one pass over the (row, neighbour) pairs where the grid stage's gather
//   passes over every cell (the same cells and values); the old hidden
//   state is loaded into registers first and stored where the winner array
//   was; the tile's presence, velocities, gate biases and Hidden2Normal
//   rows are staged in shared memory; the old cell state is loaded under
//   the products; sigmoid and tanh use __expf and __fdividef (~3e-7
//   absolute).
// - Shared memory (~215 KB): the stages, the activations x = [emb 64 |
//   pooled 256] and h (stride +4 floats: no bank conflicts on the A
//   fragments), and the grid aliased with x: it is dead once the grid
//   embedding is done, and a cluster barrier orders that before any block
//   writes pooled columns into it.  The winner array lies behind the grid,
//   in space that h takes after the build.

// Exactness of the grid: the cell index is (pos_j - pos_i) / cell_side + n/2
// with IEEE division, in that order (the __f*_rn intrinsics are never
// contracted or rewritten), so neighbours on a cell boundary land in the same
// cell as in the plain version.  Build without --use_fast_math.
//
// The grid stage alone (directional_grid_kernel) takes the grid's side n at
// run time, up to GRID_MAX_N, and the `front` offset, so it serves every
// directional grid of the LSTM family: a pool_size sub-division is the same
// grid at side n * pool_size and cell side cell_side / pool_size, and the
// blur and the pool_size sum run on its output in PyTorch.  Its winner array
// is dynamic shared memory of ROWS * n * n ints (64 KB at GRID_MAX_N).  The
// fused step keeps its compiled widths below: its matmuls depend on them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int N = 12;              // grid side
constexpr int G = N * N;           // cells per channel
constexpr int GRID_DIM = 2 * G;    // directional grid, channel-major
constexpr int EMB = 64;            // embedding_dim (62 linear + 2 zero tags)
constexpr int EMB_LIN = EMB - 2;
constexpr int POOL = 256;          // grid embedding width
constexpr int IN = EMB + POOL;     // LSTM input width
constexpr int H = 128;             // hidden_dim
constexpr int NORMAL = 5;
constexpr int THREADS = 256;
constexpr int GRID_MAX_N = 32;     // largest grid side of the grid stage alone

// the grid stage alone: agent rows per block
constexpr int ROWS = 16;
constexpr size_t GRID_SMEM_MAX_BYTES = sizeof(int) * ROWS * GRID_MAX_N * GRID_MAX_N;

// the fused step
constexpr int TILE = 64;                          // agent rows per block: one wgmma M
constexpr int CLUSTER = 2;                        // blocks per row tile
constexpr int WGS = THREADS / 128;                // warpgroups per block
constexpr int PARTS = CLUSTER * WGS;              // warpgroups per row tile
constexpr int UNITS = H / PARTS;                  // hidden units per warpgroup
constexpr int GATE_N = 4 * UNITS;                 // gate columns per warpgroup
constexpr int POOL_N = POOL / PARTS;              // pooled columns per warpgroup
constexpr int KS = 16;                            // K of one weight chunk
constexpr int GRID_CHUNKS = GRID_DIM / KS;
constexpr int GATE_CHUNKS = (IN + H) / KS;
constexpr int IN_CHUNKS = IN / KS;                // gate chunks that read x, the rest read h
constexpr int CHUNKS = GRID_CHUNKS + GATE_CHUNKS;
constexpr int GRID_CHUNK_FLOATS = 2 * POOL_N * KS;  // hi and lo
constexpr int GATE_CHUNK_FLOATS = 2 * GATE_N * KS;
constexpr int STREAM_FLOATS = GRID_CHUNKS * GRID_CHUNK_FLOATS + GATE_CHUNKS * GATE_CHUNK_FLOATS;
constexpr int STAGES = 3;
constexpr int STAGE_FLOATS = GATE_CHUNK_FLOATS;
constexpr int X_STRIDE = IN + 4;                  // activations, +4: conflict-free A fragments
constexpr int XH_STRIDE = H + 4;
constexpr int GRID_STRIDE = GRID_DIM + 4;
constexpr int RANK_ROWS = TILE / CLUSTER;         // rows whose Hidden2Normal a block finishes
constexpr int PART_FLOATS = PARTS * RANK_ROWS * NORMAL;  // Hidden2Normal partial sums

// shared memory of the fused kernel, in floats from its start
constexpr int SM_STAGES = 0;
constexpr int SM_X = SM_STAGES + WGS * STAGES * STAGE_FLOATS;
constexpr int SM_XH = SM_X + TILE * X_STRIDE;
constexpr int SM_PART = SM_XH + TILE * XH_STRIDE;
constexpr int SM_VEL = SM_PART + PART_FLOATS;
constexpr int SM_PRESENT = SM_VEL + 2 * TILE;
constexpr int SM_WSM = SM_PRESENT + TILE / 4;
constexpr int SM_BARS = SM_WSM + (4 + NORMAL) * UNITS * WGS;
constexpr int SM_WINNER = SM_X + TILE * GRID_STRIDE;  // behind the grid, which aliases x
constexpr size_t FUSED_SMEM_BYTES = sizeof(float) * SM_BARS + sizeof(uint64_t) * WGS * STAGES;
constexpr int H_LOADS = TILE * H / 4 / THREADS;   // float4 loads of h per thread
constexpr int MAX_DEVICES = 64;    // devices the shared-memory opt-in is tracked for

static_assert(THREADS % 128 == 0 && RANK_ROWS % 16 == 0,
              "Hidden2Normal: a warp's rows go to one rank");
static_assert(GRID_CHUNK_FLOATS <= STAGE_FLOATS, "a grid-embedding chunk fits a stage");
static_assert(UNITS % 4 == 0 && (POOL_N == 64 || POOL_N == 128) && (GATE_N == 64 || GATE_N == 128),
              "wgmma N of 64 or 128; 4 units per column group pair");
static_assert(GRID_DIM % KS == 0 && IN % KS == 0 && H % KS == 0 && KS % 8 == 0, "K in chunks");
static_assert(TILE * GRID_STRIDE <= TILE * X_STRIDE, "the grid fits in x");
static_assert(SM_WINNER + TILE * G <= SM_PART, "the winner array fits behind the grid");
static_assert(SM_XH >= SM_X + TILE * GRID_STRIDE, "h does not overlap the grid");
static_assert(SM_X % 4 == 0 && SM_XH % 4 == 0 && SM_WINNER % 4 == 0 && SM_BARS % 2 == 0
              && GRID_STRIDE % 4 == 0 && (TILE * G) % 4 == 0, "alignment");
static_assert(FUSED_SMEM_BYTES <= 232448, "227 KB of shared memory per block");
static_assert(STAGES <= CHUNKS, "ring");
static_assert((TILE * H / 4) % THREADS == 0, "h in whole float4 loads per thread");

struct Scene {
  const float* obs1;   // [S*A, 2]
  const float* obs2;   // [S*A, 2]
  const uint8_t* p1;   // [S*A]
  const uint8_t* p2;   // [S*A]
  int rows;            // S*A
  int a;
  float cell_side;
  float constant;
};

// The grid's geometry: side n and the offset added to the cell coordinates
// (n/2 on both axes, or n/2 and 0 for a grid in front of the agent).
struct Geom {
  int n;
  float half_x;
  float half_y;
};

// Where neighbour j (flat row rj) writes in the grid of agent i (flat row ri),
// and whether the write is in range (else it writes `constant` into cell 0).
__device__ __forceinline__ int write_cell(const Scene& sc, const Geom& gm, int ri, int rj,
                                          bool* in_range) {
  float ox = __fadd_rn(__fdiv_rn(__fsub_rn(sc.obs2[2 * rj], sc.obs2[2 * ri]), sc.cell_side), gm.half_x);
  float oy = __fadd_rn(__fdiv_rn(__fsub_rn(sc.obs2[2 * rj + 1], sc.obs2[2 * ri + 1]), sc.cell_side), gm.half_y);
  const float n = (float)gm.n;
  bool ok = sc.p2[ri] && sc.p2[rj] && ox >= 0.0f && ox < n && oy >= 0.0f && oy < n;
  *in_range = ok;
  // trunc equals floor here: negative values are out of range
  return ok ? (int)ox * gm.n + (int)oy : 0;
}

// The relative velocity of neighbour rw in agent row's grid, zero unless
// both are present at t-1 and t.
__device__ __forceinline__ float2 rel_velocity(const Scene& sc, int row, int rw) {
  bool both = sc.p1[row] && sc.p2[row] && sc.p1[rw] && sc.p2[rw];
  if (!both) return make_float2(0.0f, 0.0f);
  return make_float2(__fsub_rn(__fsub_rn(sc.obs2[2 * rw], sc.obs1[2 * rw]),
                               __fsub_rn(sc.obs2[2 * row], sc.obs1[2 * row])),
                     __fsub_rn(__fsub_rn(sc.obs2[2 * rw + 1], sc.obs1[2 * rw + 1]),
                               __fsub_rn(sc.obs2[2 * row + 1], sc.obs1[2 * row + 1])));
}

// Last write wins: winner[r * n * n + cell] becomes the highest j that
// writes the cell in row row0 + r's grid, for R rows; it is -1 before, and
// stays so where no neighbour writes.  Ends with __syncthreads.
template <int R>
__device__ __forceinline__ void scatter_winners(const Scene& sc, const Geom& gm, int row0,
                                                int* winner) {
  const int g_cells = gm.n * gm.n;
  // every non-self neighbour writes; the highest j wins the cell
  for (int idx = threadIdx.x; idx < R * sc.a; idx += blockDim.x) {
    int r = idx / sc.a, j = idx - (idx / sc.a) * sc.a;
    int row = row0 + r;
    if (row >= sc.rows) continue;
    int i = row % sc.a;
    if (j == i) continue;
    bool in_range;
    int cell = write_cell(sc, gm, row, row - i + j, &in_range);
    atomicMax(&winner[r * g_cells + cell], j);
  }
  __syncthreads();
}

// Builds the directional grids of rows [row0, row0 + rows_out) into out
// (row-major [rows_out, 2 * n * n], channel-major within a row); winner is
// shared scratch of ROWS * n * n ints.  Every (row, cell) gathers its
// winner's value, or `constant` where no neighbour wrote; rows past the end
// of the scene batch get `constant` everywhere.
__device__ __forceinline__ void build_grid(const Scene& sc, const Geom& gm, int row0, int* winner,
                                           float* out, int rows_out) {
  const int g_cells = gm.n * gm.n;
  for (int idx = threadIdx.x; idx < ROWS * g_cells; idx += blockDim.x) winner[idx] = -1;
  __syncthreads();
  scatter_winners<ROWS>(sc, gm, row0, winner);
  for (int idx = threadIdx.x; idx < rows_out * g_cells; idx += blockDim.x) {
    int r = idx / g_cells, g = idx - (idx / g_cells) * g_cells;
    int row = row0 + r;
    float vx = sc.constant, vy = sc.constant;
    int w = winner[idx];
    if (row < sc.rows && w >= 0) {
      int i = row % sc.a;
      int rw = row - i + w;
      bool in_range;
      write_cell(sc, gm, row, rw, &in_range);
      if (in_range) {
        float2 v = rel_velocity(sc, row, rw);
        vx = v.x;
        vy = v.y;
      }
    }
    out[r * 2 * g_cells + g] = vx;
    out[r * 2 * g_cells + g_cells + g] = vy;
  }
  __syncthreads();
}

// The grid stage alone: grid_out [S*A, 2 * n * n], written straight to
// device memory (neighbouring threads write neighbouring cells).
__global__ void __launch_bounds__(THREADS) directional_grid_kernel(Scene sc, Geom gm,
                                                                   float* grid_out) {
  extern __shared__ float smem[];
  int* winner = reinterpret_cast<int*>(smem);  // [ROWS, n * n]
  int row0 = blockIdx.x * ROWS;
  int rows_out = min(ROWS, sc.rows - row0);
  build_grid(sc, gm, row0, winner, grid_out + (size_t)row0 * 2 * gm.n * gm.n, rows_out);
}

// ------------------------------------------------ Hopper primitives (PTX)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits for the barrier's phase of `parity` to complete; traps instead of
// hanging if it never does.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (++spins > (1u << 28)) __trap();
  } while (!done);
}

// One thread: a bulk copy of `bytes` from global into shared memory that
// completes the barrier's current phase.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Descriptor of a K-major, unswizzled B tile in shared memory: 128 bytes
// between core matrices along K, KS / 4 * 128 between 8-row groups (a
// group holds the chunk's KS / 4 core matrices along K).
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  constexpr uint64_t LBO = 128, SBO = (KS / 4) * 128;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) | ((SBO >> 4) << 32);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma
template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int NA>
__device__ __forceinline__ void wgmma(float (&d)[NA], const uint32_t (&a)[4], uint64_t desc) {
  static_assert(NA == 32 || NA == 64, "m64n64 or m64n128");
  if constexpr (NA == 32) wgmma_n64(d, a, desc);
  else wgmma_n128(d, a, desc);
}

constexpr int STEPS = KS / 8;  // wgmma K steps per chunk

// One chunk of this thread's A fragments as loaded: the mma.m16n8k8 layout,
// rows 16w + lane/4 (+8) and columns lane%4 (+4) of each K step of 8.
struct AChunk {
  float v[STEPS][4];
};

// The same fragments split for 3xTF32: hi = tf32(a), lo = a - hi.
struct ASplit {
  uint32_t hi[STEPS][4], lo[STEPS][4];
};

// Where a chunk's A columns are: rows at p + r * stride, from column k0.
struct ASrc {
  const float* p;
  int stride;
  int k0;
};

__device__ __forceinline__ void load_a(AChunk& f, ASrc a, int warp, int lane) {
  const float* r0 = a.p + (16 * warp + lane / 4) * a.stride + a.k0 + lane % 4;
  const float* r1 = r0 + 8 * a.stride;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    f.v[s][0] = r0[8 * s];
    f.v[s][1] = r1[8 * s];
    f.v[s][2] = r0[8 * s + 4];
    f.v[s][3] = r1[8 * s + 4];
  }
}

__device__ __forceinline__ void split_a(const AChunk& f, ASplit& a) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a.hi[s][i] = tf32_rna(f.v[s][i]);
      a.lo[s][i] = __float_as_uint(f.v[s][i] - __uint_as_float(a.hi[s][i]));
    }
}

// acc[64 x NN] += A_chunk @ B_chunk^T in 3xTF32, issued as one wgmma group
// and not waited for.  The chunk holds B's hi part then its lo part, each
// [NN/8][KS/4][8][4] (wgmma's core matrices); a K step of 8 is 2 core
// matrices, 64 floats further along.
template <int NA>
__device__ __forceinline__ void issue_chunk(float (&acc)[NA], const ASplit& a, const float* chunk) {
  const float* b_hi = chunk;
  const float* b_lo = chunk + 2 * NA * KS;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    wgmma(acc, a.lo[s], b_desc(b_hi + 64 * s));
    wgmma(acc, a.hi[s], b_desc(b_lo + 64 * s));
    wgmma(acc, a.hi[s], b_desc(b_hi + 64 * s));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

struct Weights {
  const float* w_emb;    // [2, EMB_LIN]
  const float* b_emb;    // [EMB_LIN]
  const float* w_pack;   // [PARTS, STREAM_FLOATS]: grid embedding and gates, see the head
  const float* b_grid;   // [POOL]
  const float* b_gates;  // [4H] = b_ih + b_hh, gate-major (i, f, g, o)
  const float* w_h2n;    // [H, NORMAL]
  const float* b_h2n;    // [NORMAL]
};

// Chunk c of a warpgroup's weight stream: its offset and its size.
__device__ __forceinline__ int chunk_offset(int c) {
  return c < GRID_CHUNKS ? c * GRID_CHUNK_FLOATS
                         : GRID_CHUNKS * GRID_CHUNK_FLOATS + (c - GRID_CHUNKS) * GATE_CHUNK_FLOATS;
}
__device__ __forceinline__ uint32_t chunk_bytes(int c) {
  return sizeof(float) * (c < GRID_CHUNKS ? GRID_CHUNK_FLOATS : GATE_CHUNK_FLOATS);
}

// A warpgroup's ring of STAGES shared-memory stages over its weight stream:
// chunk c lands in stage c % STAGES, completing that stage's barrier.
struct Ring {
  float* buf;
  uint64_t* full;
  const float* stream;
  int wg;

  __device__ __forceinline__ float* stage(int c) const { return buf + (c % STAGES) * STAGE_FLOATS; }
  __device__ __forceinline__ void load(int c) const {
    bulk_load(stage(c), stream + chunk_offset(c), chunk_bytes(c), &full[c % STAGES]);
  }
  __device__ __forceinline__ void wait(int c) const {
    mbar_wait(&full[c % STAGES], (c / STAGES) & 1);
  }
  // once every warp of the warpgroup is past the wgmmas of chunk c, its
  // stage takes chunk c + STAGES
  __device__ __forceinline__ void release(int c) const {
    asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
    if (threadIdx.x % 128 == 0 && c + STAGES < CHUNKS) load(c + STAGES);
  }
};

// One chunk of gemm(): split its A fragments (loaded the step before) into
// split[B], issue its wgmmas, load the next chunk's A fragments, and once
// the previous chunk's wgmmas are done, release that chunk's stage.  Two
// groups in flight: B alternates, so that the registers of the group still
// running are not touched.
template <int B, int NA, typename ASrcOf>
__device__ __forceinline__ void gemm_step(float (&acc)[NA], const Ring& ring, int c, int c0, int c1,
                                          ASrcOf a_src, AChunk& raw, ASplit (&split)[2],
                                          int warp, int lane) {
  split_a(raw, split[B]);
  ring.wait(c);
  issue_chunk(acc, split[B], ring.stage(c));
  if (c + 1 < c1) load_a(raw, a_src(c + 1 - c0), warp, lane);
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  if (c > c0) ring.release(c - 1);
}

// acc[64 x 2 NA] += A @ B over the ring's chunks [C0, C1); the A columns of
// chunk c are at a_src(c - C0).  Unrolled: every branch on c is decided at
// compile time, so no wgmma sits on a divergent path.
template <int C0, int C1, int NA, typename ASrcOf>
__device__ __forceinline__ void gemm(float (&acc)[NA], const Ring& ring, ASrcOf a_src, int warp,
                                     int lane) {
  AChunk raw;
  ASplit split[2];
  load_a(raw, a_src(0), warp, lane);
  fence_acc(acc);
#pragma unroll
  for (int c = C0; c < C1; ++c) {
    if ((c - C0) % 2 == 0) gemm_step<0>(acc, ring, c, C0, C1, a_src, raw, split, warp, lane);
    else gemm_step<1>(acc, ring, c, C0, C1, a_src, raw, split, warp, lane);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  ring.release(C1 - 1);
}

// The fused step's grid of rows [row0, row0 + TILE), row r at out + r *
// GRID_STRIDE, already filled with `constant`: each neighbour that won its
// cell in scatter_winners writes its value there.  The same cells and
// values as build_grid's gather.
__device__ __forceinline__ void write_winners(const Scene& sc, int row0, const int* winner,
                                              float* out) {
  const Geom gm{N, 0.5f * N, 0.5f * N};
  for (int idx = threadIdx.x; idx < TILE * sc.a; idx += blockDim.x) {
    int r = idx / sc.a, j = idx - (idx / sc.a) * sc.a;
    int row = row0 + r;
    if (row >= sc.rows) continue;
    int i = row % sc.a;
    if (j == i) continue;
    bool in_range;
    int cell = write_cell(sc, gm, row, row - i + j, &in_range);
    if (winner[r * G + cell] != j) continue;
    float2 v = in_range ? rel_velocity(sc, row, row - i + j)
                        : make_float2(sc.constant, sc.constant);
    out[r * GRID_STRIDE + cell] = v.x;
    out[r * GRID_STRIDE + G + cell] = v.y;
  }
}

__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) { return 2.0f * sigmoid_fast(2.0f * x) - 1.0f; }

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1) fused_step_kernel(
    Scene sc, Weights wt, const float* __restrict__ h, const float* __restrict__ c,
    float* __restrict__ h_out, float* __restrict__ c_out, float* __restrict__ normal,
    uint8_t* __restrict__ mask_out) {
  extern __shared__ __align__(128) float smem[];
  float* x = smem + SM_X;                 // [TILE, X_STRIDE]: emb(62) | tags(2) | pooled(256)
  float* grid = smem + SM_X;              // [TILE, GRID_STRIDE], until the grid embedding is done
  int* winner = reinterpret_cast<int*>(smem + SM_WINNER);  // [TILE, G], while the grid is built
  float* xh = smem + SM_XH;               // [TILE, XH_STRIDE] old hidden state
  float* part = smem + SM_PART;           // [PARTS, RANK_ROWS, NORMAL]
  float* vel = smem + SM_VEL;             // [TILE, 2] masked velocity
  uint8_t* present = reinterpret_cast<uint8_t*>(smem + SM_PRESENT);  // [TILE] at t-1 and t
  // this block's units: gate biases [4, UNITS * WGS], then w_h2n [UNITS * WGS, NORMAL]
  float* wsm = smem + SM_WSM;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + SM_BARS);  // [WGS, STAGES]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int wg = t / 128, warp = (t % 128) / 32, lane = t % 32;
  const int part_id = rank * WGS + wg;   // this warpgroup's share of the tile's columns
  const int row0 = (blockIdx.x / CLUSTER) * TILE;
  const int valid_rows = min(TILE, sc.rows - row0);
  const Ring ring{smem + SM_STAGES + wg * STAGES * STAGE_FLOATS, bars + wg * STAGES,
                  wt.w_pack + (size_t)part_id * STREAM_FLOATS, wg};

  // the old hidden state, loaded now and stored once the grid is built
  float4 h_old[H_LOADS];
#pragma unroll
  for (int i = 0; i < H_LOADS; ++i) {
    int idx = t + i * THREADS, r = idx / (H / 4), k4 = idx - r * (H / 4);
    const float4* h4 = reinterpret_cast<const float4*>(h);
    h_old[i] = r < valid_rows ? h4[(size_t)(row0 + r) * (H / 4) + k4]
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  if (t == 0) {
    for (int i = 0; i < WGS * STAGES; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t % 128 == 0)
    for (int cc = 0; cc < STAGES; ++cc) ring.load(cc);

  // the tile's rows: presence at t-1 and t, and the masked velocity
  if (t < TILE) {
    int row = row0 + t;
    bool m = t < valid_rows && sc.p1[row] && sc.p2[row];
    present[t] = m;
    vel[2 * t] = m ? sc.obs2[2 * row] - sc.obs1[2 * row] : 0.0f;
    vel[2 * t + 1] = m ? sc.obs2[2 * row + 1] - sc.obs1[2 * row + 1] : 0.0f;
  }

  // the grid: `constant` everywhere, then the winners' values
  {
    const float4 k4 = make_float4(sc.constant, sc.constant, sc.constant, sc.constant);
    for (int idx = t; idx < TILE * GRID_DIM / 4; idx += THREADS) {
      int r = idx / (GRID_DIM / 4), k = idx - r * (GRID_DIM / 4);
      *reinterpret_cast<float4*>(grid + r * GRID_STRIDE + 4 * k) = k4;
    }
    for (int idx = t; idx < TILE * G / 4; idx += THREADS)
      reinterpret_cast<int4*>(winner)[idx] = make_int4(-1, -1, -1, -1);
  }
  // this block's gate biases and Hidden2Normal rows, read after the products
  for (int idx = t; idx < 4 * UNITS * WGS + NORMAL * UNITS * WGS; idx += THREADS) {
    int u0 = rank * UNITS * WGS;
    wsm[idx] = idx < 4 * UNITS * WGS
                   ? wt.b_gates[(idx / (UNITS * WGS)) * H + u0 + idx % (UNITS * WGS)]
                   : wt.w_h2n[u0 * NORMAL + idx - 4 * UNITS * WGS];
  }
  __syncthreads();
  // the compiled grid: constant geometry, so the inlined loops fold it
  scatter_winners<TILE>(sc, Geom{N, 0.5f * N, 0.5f * N}, row0, winner);
  write_winners(sc, row0, winner, grid);
  // the winner array is dead: the old hidden state takes its place
  __syncthreads();
#pragma unroll
  for (int i = 0; i < H_LOADS; ++i) {
    int idx = t + i * THREADS, r = idx / (H / 4), k4 = idx - r * (H / 4);
    *reinterpret_cast<float4*>(xh + r * XH_STRIDE + 4 * k4) = h_old[i];
  }

  // grid embedding: this warpgroup's POOL_N pooled columns
  float pooled[POOL_N / 2];
#pragma unroll
  for (int i = 0; i < POOL_N / 2; ++i) pooled[i] = 0.0f;
  gemm<0, GRID_CHUNKS>(pooled, ring, [&](int k) { return ASrc{grid, GRID_STRIDE, k * KS}; },
                       warp, lane);

  // Accumulator layout of m64nN: pooled[4j + 2e + b] is row 16 * warp +
  // lane / 4 + 8e, column 8j + 2 * (lane % 4) + b.
  const int rl0 = 16 * warp + lane / 4;  // this thread's two local rows: rl0, rl0 + 8
  const int q = lane % 4;
  cluster.sync();  // every block of the cluster is done with its grid: x may be written
  {
    float* dst[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) dst[r] = cluster.map_shared_rank(x, r);
#pragma unroll
    for (int j = 0; j < POOL_N / 8; ++j) {
      int col = part_id * POOL_N + 8 * j + 2 * q;  // pooled column
      float b0 = wt.b_grid[col], b1 = wt.b_grid[col + 1];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float2 v = make_float2(fmaxf(pooled[4 * j + 2 * e] + b0, 0.0f),
                               fmaxf(pooled[4 * j + 2 * e + 1] + b1, 0.0f));
        int off = (rl0 + 8 * e) * X_STRIDE + EMB + col;
#pragma unroll
        for (int r = 0; r < CLUSTER; ++r) *reinterpret_cast<float2*>(dst[r] + off) = v;
      }
    }
  }
  // the input embedding relu(4 * vel @ W + b) | 0 0, where the grid was:
  // thread t takes column t % EMB of every fourth row
  {
    const int k = t % EMB;
    float w0 = 0.0f, w1 = 0.0f, b = 0.0f;
    if (k < EMB_LIN) {
      w0 = wt.w_emb[k];
      w1 = wt.w_emb[EMB_LIN + k];
      b = wt.b_emb[k];
    }
    for (int r = t / EMB; r < TILE; r += THREADS / EMB) {
      float vx = vel[2 * r], vy = vel[2 * r + 1];
      x[r * X_STRIDE + k] = k < EMB_LIN && r < valid_rows
                                ? fmaxf(b + 4.0f * vx * w0 + 4.0f * vy * w1, 0.0f) : 0.0f;
    }
  }
  cluster.sync();  // x holds every pooled column of the tile

  // gates: [x | h] @ [W_ih; W_hh] for this warpgroup's GATE_N columns.  The
  // old cell state of this thread's rows and units, loaded under the
  // products: unit part_id * UNITS + 4p + q of rows rl0 and rl0 + 8.
  float c_old[UNITS / 4][2];
#pragma unroll
  for (int p = 0; p < UNITS / 4; ++p)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      c_old[p][e] = rl0 + 8 * e < valid_rows
                        ? c[(size_t)(row0 + rl0 + 8 * e) * H + part_id * UNITS + 4 * p + q] : 0.0f;
  float gates[GATE_N / 2];
#pragma unroll
  for (int i = 0; i < GATE_N / 2; ++i) gates[i] = 0.0f;
  gemm<GRID_CHUNKS, CHUNKS>(gates, ring, [&](int k) {
    return k < IN_CHUNKS ? ASrc{x, X_STRIDE, k * KS} : ASrc{xh, XH_STRIDE, (k - IN_CHUNKS) * KS};
  }, warp, lane);

  // LSTM pointwise and the masked update.  Columns 16p + 8e' + 2q + b of
  // the warpgroup are gate 2e' + b of unit 4p + q (the host's order), so
  // gates[8p + 4e' + 2e + b] is that gate of row rl0 + 8e.
  float head[2][NORMAL];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int o = 0; o < NORMAL; ++o) head[e][o] = 0.0f;
#pragma unroll
  for (int p = 0; p < UNITS / 4; ++p) {
    const int u = part_id * UNITS + 4 * p + q;
    const int ub = wg * UNITS + 4 * p + q;  // the unit within this block's
    const float bi = wsm[ub], bf = wsm[UNITS * WGS + ub];
    const float bg = wsm[2 * UNITS * WGS + ub], bo = wsm[3 * UNITS * WGS + ub];
    const float* w2n = wsm + 4 * UNITS * WGS + ub * NORMAL;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int rl = rl0 + 8 * e, row = row0 + rl, g0 = 8 * p + 2 * e;
      float c_new = sigmoid_fast(gates[g0 + 1] + bf) * c_old[p][e]
                    + sigmoid_fast(gates[g0] + bi) * tanh_fast(gates[g0 + 4] + bg);
      float h_new = sigmoid_fast(gates[g0 + 5] + bo) * tanh_fast(c_new);
      if (rl < valid_rows) {
        // the masked update keeps the old state where the agent is not
        // present at both t-1 and t
        bool m = present[rl];
        h_out[(size_t)row * H + u] = m ? h_new : xh[rl * XH_STRIDE + u];
        c_out[(size_t)row * H + u] = m ? c_new : c_old[p][e];
      }
      // Hidden2Normal reads the unmasked new state
#pragma unroll
      for (int o = 0; o < NORMAL; ++o) head[e][o] = fmaf(h_new, w2n[o], head[e][o]);
    }
  }

  // Hidden2Normal: sum over the quad's units, then send each row's partial
  // sum over this warpgroup's units to the block that finishes the row:
  // rank r takes rows [RANK_ROWS r, RANK_ROWS (r + 1)), warp w's 16 rows
  // among them
  {
    const int dst_rank = 16 * warp / RANK_ROWS;
    float* dst = cluster.map_shared_rank(part, dst_rank);
    const int rr0 = 16 * warp - RANK_ROWS * dst_rank + lane / 4;  // row rl0 there
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 0; o < NORMAL; ++o) {
        float v = head[e][o];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) dst[(part_id * RANK_ROWS + rr0 + 8 * e) * NORMAL + o] = v;
      }
  }
  cluster.sync();  // every partial sum has arrived; no block reads another's memory after this
  for (int idx = t; idx < RANK_ROWS * NORMAL; idx += THREADS) {
    int r = idx / NORMAL, o = idx - (idx / NORMAL) * NORMAL;
    int rl = rank * RANK_ROWS + r, row = row0 + rl;
    if (rl >= valid_rows) continue;
    float acc = wt.b_h2n[o];
    for (int src = 0; src < PARTS; ++src) acc += part[(src * RANK_ROWS + r) * NORMAL + o];
    float v = o < 2 ? acc : (o < 4 ? 0.01f + 0.2f * sigmoid_fast(acc) : 0.7f * sigmoid_fast(acc));
    bool m = present[rl];
    normal[(size_t)row * NORMAL + o] = m ? v : 0.0f;
    if (o == 0) mask_out[row] = m ? 1 : 0;
  }
}

// Above 48 KB of dynamic shared memory only after opting in, once per device.
cudaError_t opt_in(const void* kernel, size_t bytes, bool* opted_in) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// All tensors [S, A, F] contiguous on the current device; present masks are
// one byte per agent (torch.bool).  Returns cudaGetLastError() after launch.

// grid_out [S, A, 2 * n * n] for 1 <= n <= GRID_MAX_N; `front` puts the
// agent on the grid's edge (offsets n/2 and 0) instead of its centre.
int dlstm_directional_grid(const float* obs1, const float* obs2, const uint8_t* p1,
                           const uint8_t* p2, float* grid_out, int s, int a, int n,
                           float cell_side, int front, float constant, void* stream) {
  if (n < 1 || n > GRID_MAX_N) return (int)cudaErrorInvalidValue;
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in((const void*)directional_grid_kernel, GRID_SMEM_MAX_BYTES, opted_in);
  if (err != cudaSuccess) return (int)err;
  Scene sc{obs1, obs2, p1, p2, s * a, a, cell_side, constant};
  Geom gm{n, 0.5f * n, front ? 0.0f : 0.5f * n};
  int blocks = (sc.rows + ROWS - 1) / ROWS;
  size_t smem = sizeof(int) * ROWS * n * n;
  directional_grid_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(sc, gm, grid_out);
  return (int)cudaGetLastError();
}

// w_pack: the packed weight streams (ops/cuda/fused_step.pack_weights), read
// by bulk copies, and h, read by 16-byte loads: both 16-byte aligned.
int dlstm_fused_step(const float* obs1, const float* obs2, const uint8_t* p1,
                     const uint8_t* p2, const float* h, const float* c,
                     const float* w_emb, const float* b_emb, const float* w_pack,
                     const float* b_grid, const float* b_gates, const float* w_h2n,
                     const float* b_h2n, float* h_out, float* c_out, float* normal,
                     uint8_t* mask_out, int s, int a, float cell_side, float constant,
                     void* stream) {
  if (reinterpret_cast<uintptr_t>(w_pack) % 16 != 0 || reinterpret_cast<uintptr_t>(h) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  static bool opted_in[MAX_DEVICES] = {};
  cudaError_t err = opt_in((const void*)fused_step_kernel, FUSED_SMEM_BYTES, opted_in);
  if (err != cudaSuccess) return (int)err;
  Scene sc{obs1, obs2, p1, p2, s * a, a, cell_side, constant};
  Weights wt{w_emb, b_emb, w_pack, b_grid, b_gates, w_h2n, b_h2n};
  int blocks = CLUSTER * ((sc.rows + TILE - 1) / TILE);
  fused_step_kernel<<<blocks, THREADS, FUSED_SMEM_BYTES, (cudaStream_t)stream>>>(
      sc, wt, h, c, h_out, c_out, normal, mask_out);
  return (int)cudaGetLastError();
}

// Compile-time widths of the fused step, the grid stage's largest side and
// the layout of the packed weights, so the binding can check them against
// the model and pack for this build.
int dlstm_kernel_dims(int* out) {
  out[0] = N;
  out[1] = EMB;
  out[2] = POOL;
  out[3] = H;
  out[4] = GRID_MAX_N;
  out[5] = CLUSTER;
  out[6] = WGS;
  out[7] = KS;
  return 0;
}

}  // extern "C"
