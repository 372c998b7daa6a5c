// The per-step work of the flagship's train step, for Hopper (sm_90a): six
// kernels behind ops/cuda/fused_train.py's FusedTrainRollout (the
// teacher-forced rollout under autograd; the gate product in
// fused_train_cell, the carried dh's in fused_train_cell_backward, the grid
// embedding's in fused_train_in, the once-a-rollout dx and weight-gradient
// products run by torch.mm) and FusedPredictionLoss (the trainer's loss).
//
// Replaces no TPU kernel.  The JAX package differentiates its rollout with
// jax.grad, and XLA fuses each step's elementwise ops; under PyTorch's
// autograd the same work was ~100 kernels a step forward and backward, each
// at launch scale at batch 8 (64 rows), so a train step's time was their
// number.  These kernels do a step's work in at most two launches forward
// (the encoder's input rows take one launch for all its steps) and one
// backward, plus one launch a rollout:
//
// - fused_train_in_kernel (once a decoder step, once for all the encoder's
//   steps): the step's input row [relu(4 vel W_emb + b_emb) | 0, 0 |
//   relu(grid W_grid + b_grid) | . | 1] into the stack xh, vel = (obs2 -
//   obs1) * mask, the K = 2 product on the CUDA cores; [4 vel, 1] and the
//   mask saved.  The grid embedding is formed from the grid's occupied
//   cells: the directional grid puts each other agent into at most one cell
//   (out of range into cell 0), so a row holds at most 2 (A - 1) non-zero
//   entries of its G = 2 n^2 (14 of 288 for the flagship's train batch),
//   and the dense [rows, G] x [G, P] product does more than 20 times the
//   work.  A warp per (row, part): part 0 writes the embedding, the tag
//   and ones columns, v4 and the mask; each other part owns 32 CPL of the
//   P pool columns (CPL a launch parameter, `dlstm_train_in`).  A pool
//   warp loads its row of the grid in 16-byte loads (up to four a lane in
//   flight), compacts the non-zero entries into shared memory as (index,
//   value) pairs in ascending index order (a ballot per entry slot and a
//   prefix over the lanes), then each
//   lane sums value * W_grid[index, column] over the list for its CPL
//   columns (rows of W_grid read coalesced, from L2), adds b_grid and
//   applies the relu.  The list's length bounds the loop, so a denser row
//   (larger A, up to all G entries) is computed the same way, only longer.
//   Skipping an exact zero (-0.0 included) changes the sum only by the
//   sign of a zero, for finite W_grid; a NaN entry is not zero and is kept.
// - fused_train_cell_kernel (once a step): the gates xh W_cell ([W_ih;
//   W_hh; b_ih + b_hh], K = E + P + H + 1: 449 for the flagship, the ones
//   column carrying the bias), the LSTM cell, the masked update of h and c,
//   Hidden2Normal ([H] x [H, 5] a row), its head (0.01 + 0.2 sigmoid, 0.7
//   sigmoid), the masked normal, the output position and, on the decoder's
//   teacher-forcing chain, the primary's own position and validity.  A
//   block takes a tile of TR rows (4, 8 or 16, by rows:
//   fused_train.cell_tile_rows) and a slice of U = 16 hidden units (32
//   above 128 units) with all four gate columns of each, so the cell needs
//   nothing of another block.  It keeps the tile's xh rows whole in shared
//   memory (cp.async) and streams its slice of W_cell, packed once a
//   rollout so that a slice's 64 K rows are one contiguous run
//   (fused_train.cell_pack: one bulk copy a stage, on an mbarrier), through
//   a ring of NST stages, NST - 1 ahead of the one summed (8 at 4 and 8
//   rows of 16 units: the flagship's whole K in flight; else 4); each
//   thread sums 4 rows x 4 gate columns in
//   f32 FFMA over every KS-th quad of K of a stage, a stage's share added
//   to the running sum (two short chains: nearer the exact sum than a
//   cuBLAS f32 product at every case measured), and the KS groups' sums are
//   added in group order.  Everything the cell reads besides the gates is
//   read before the product, so that its trips to memory overlap it.
//   (Issuing the slice's rows by cp.async, 16 bytes a thread, kept the
//   block's threads from the sums for most of the product on an H100.)  The
//   slices of a row tile are one cluster (at most 8, so at most 256 units):
//   each block sums its units' share of Hidden2Normal (a butterfly over the
//   row's lanes) into rank 0's shared memory with an arrival on an mbarrier
//   there, before its own stores; rank 0 adds the ranks in rank order and
//   writes the head.
// - fused_train_cell_backward_kernel (once a step): the same step backward
//   from the step's gradients of rel_pred and pred and the carried dh, dc,
//   dh first taking step g + 1's dg_next W_hh_next^T (K = 4H: 512 for the
//   flagship) for the block's units: the gates' gradient, the raw head's
//   (Hidden2Normal's backward, the product with W_h2n^T per unit), the
//   carried dh where the agent is absent and dc.  A block per tile of TR
//   rows and U units: its rows of dg_next and its units' rows of W_hh_next
//   all in flight at once (cp.async, a group per 128 gate columns, each
//   summed as it lands, its inputs of the step read before), each thread 2
//   rows x 2 units over every KS-th quad of gate columns, the groups added
//   in group order; every block makes its rows' 5-wide head gradient
//   itself, so no block waits on another.
// - fused_train_in_backward_kernel (once a rollout): both relu masks on the
//   gradient of every step's x, in place.  A block per tile of 16 rows, a
//   warp per row, its lanes walking the row in float4 of dx; no division.
// - fused_train_loss_kernel and fused_train_loss_backward_kernel (once a
//   train step each): the trainer's mixture NLL of the primaries' last 12
//   normals (losses.prediction_loss: ~70 small ops forward and ~170
//   backward under autograd), its masked mean in one block sized to the
//   entries (fused_train.loss_threads), summed by warp shuffles; its
//   gradient with respect to the whole rel_pred written in one pass, in
//   float4 where the agents are a multiple of 4, a thread a float4 in
//   blocks of 128 (12 for the train step's 1,520): a unit that holds no
//   primary float is stored as zeros with no load before it, the
//   primary's are loaded and scaled by their own threads.
//
// What bounds them.  The cell kernels: by the card's peaks, the forward's
// operations (2 R (E + P + H + 1) 4H FLOP: 29.4 M at 64 rows, 0.44 us at 67
// TFLOP/s in f32, beside ~1.3 MB) and the backward's bytes (~0.86 MB at 64
// rows, 0.26 us, beside 8.5 M FLOP); at 64 rows both are far from either,
// bound by the latency of their trips to memory and of their sums.  At 64
// rows the forward is 64 blocks, each reading 130 KB of W_cell and xh from
// L2 (8.3 MB in all): the design keeps the tile's K in flight at once and
// sums in registers, with no second pass and no split of K across blocks.
// The other kernels: bytes, a handful of operations per byte, each at
// launch scale at 64 rows, where what is left beside the launch is the
// latency of their trips to memory and of their dependent chains.  The
// loss (96 entries for the train batch, 1.4 KB) once loaded its scene's
// mask, then that entry's normal behind it, ran ~20 IEEE divisions an entry
// and summed over a 256-slot tree of 8 barriers: now every load of an entry
// is issued before any branch, four reciprocals stand for most divisions,
// and the sums take two warp butterflies and one barrier.  The relu masks
// need xh's x part read and the elements they zero written (~2.4 MB at
// 1,216 rows, about half the elements zeroed); they once took a thread an
// element and a 64-bit division by the row's width (not a power of two) to
// find its row, storing only the zeros: now a warp walks a row in float4
// of dx, its row's base formed once, and writes each float4 whole, so it
// reads dx too (4.7 MB moved).  The loss's backward writes d_rel whole
// (24 KB at the train step, 3.1 MB at 12,288 entries: ~1.0 us) and reads
// dvals; at the train step a launch and one trip to memory set its time,
// so no store of a zero waits on a load or a 64-bit division, and a
// thread stores one float4: blocks that store several units a thread
// drain the train step's stores through fewer SMs, and took longer.
// fused_train_in's bytes are its rows of the grid
// and of xh and the rows of W_grid that the occupied cells name (1 KB each
// at P = 256): ~0.2-0.4 MB at 64 rows.  No atomic sums: every sum runs in a
// fixed order, so two runs, and a CUDA graph replay and an eager step, give
// the same bits.  Widths (embedding, grid, pool, hidden up to 256 and rows
// of xh up to 2,048) come at run time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CELL_THREADS = 256;  // a cell kernel's block
constexpr int CELL_KC = 64;  // the forward's K (columns of xh) a stage of its ring
constexpr int CELL_BACK_KC = 128;  // the backward's gate columns a copy group
constexpr int CELL_MAX_CLUSTER = 8;  // the forward's blocks a row tile (portable cluster size)
constexpr int CELL_MAX_LD = 2048;  // the forward's xh row (x, h and 1): its tile stays resident
constexpr int MAX_BLOCKS = 4096;  // a grid-stride kernel's blocks at most
constexpr int LOSS_MAX_THREADS = 1024;  // the loss's one block (a multiple of 32)
constexpr int IB_WARPS = 8;  // the relu masks' block: a row a warp at a time
constexpr int IB_RPT = 2;  // rows a warp takes: a tile of 16 rows a block
constexpr int IB_UNITS = 3;  // float4 of a row a lane has in flight (80 a flagship row)
constexpr int LB_THREADS = 128;  // the loss backward's block, a unit a thread
constexpr float INV_TWO_PI = 0.15915494309189535f;

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float relu(float x) { return x > 0.f ? x : 0.f; }

// Part 0 of a row: the velocity embedding, the tag and ones columns, v4
// and the mask.
__device__ void train_in_head(const float* __restrict__ obs1, const float* __restrict__ obs2,
                              const uint8_t* __restrict__ p1, const uint8_t* __restrict__ p2,
                              const float* __restrict__ w_emb, const float* __restrict__ b_emb,
                              float* __restrict__ row, float* __restrict__ v4,
                              uint8_t* __restrict__ mask, int r, int lin, int ld, int lane) {
  const bool m = p1[r] && p2[r];
  const float fm = m ? 1.f : 0.f;
  const float vx = (obs2[2 * r] - obs1[2 * r]) * fm * 4.f;
  const float vy = (obs2[2 * r + 1] - obs1[2 * r + 1]) * fm * 4.f;
  for (int col = lane; col < lin; col += 32) {
    row[col] = relu(fmaf(vy, w_emb[lin + col], vx * w_emb[col]) + b_emb[col]);
  }
  if (lane < 2) row[lin + lane] = 0.f;
  if (lane == 0) {
    row[ld - 1] = 1.f;
    v4[3 * r] = vx;
    v4[3 * r + 1] = vy;
    v4[3 * r + 2] = 1.f;
    mask[r] = m;
  }
}

// A warp per (row, part), `warps` a block; `vec`: every row of the grid
// starts on 16 bytes (G % 4 == 0 and an aligned base).
template <int CPL>
__global__ void fused_train_in_kernel(const float* __restrict__ obs1,
                                      const float* __restrict__ obs2,
                                      const uint8_t* __restrict__ p1,
                                      const uint8_t* __restrict__ p2,
                                      const float* __restrict__ grid,
                                      const float* __restrict__ w_emb,
                                      const float* __restrict__ b_emb,
                                      const float* __restrict__ w_grid,
                                      const float* __restrict__ b_grid, float* __restrict__ xh,
                                      float* __restrict__ v4, uint8_t* __restrict__ mask,
                                      int rows, int lin, int g, int pool, int ld, bool vec) {
  extern __shared__ unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int parts = 1 + (pool + 32 * CPL - 1) / (32 * CPL);
  const long w = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (w >= static_cast<long>(rows) * parts) return;  // a whole warp
  const int r = static_cast<int>(w / parts), part = static_cast<int>(w % parts);
  float* row = xh + static_cast<long>(r) * ld;
  if (part == 0) {
    train_in_head(obs1, obs2, p1, p2, w_emb, b_emb, row, v4, mask, r, lin, ld, lane);
    return;
  }
  const int c0 = (part - 1) * 32 * CPL + lane;
  float bias[CPL];  // read first: no load below waits on it
#pragma unroll
  for (int j = 0; j < CPL; ++j) bias[j] = c0 + 32 * j < pool ? b_grid[c0 + 32 * j] : 0.f;
  // this warp's list: G (index, value) slots
  int* idx = reinterpret_cast<int*>(smem) + warp * 2 * g;
  float* val = reinterpret_cast<float*>(idx + g);
  const float* grow = grid + static_cast<long>(r) * g;
  const unsigned below = (1u << lane) - 1u;
  int n = 0;  // entries listed so far, the same in every lane
  for (int base = 0; base < g; base += 4 * 128) {
    // up to four 16-byte loads a lane in flight, then their compaction
    float v[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k0 = base + 128 * c + 4 * lane;
      if (vec && k0 < g) {
        const float4 q = *reinterpret_cast<const float4*>(grow + k0);
        v[c][0] = q.x;
        v[c][1] = q.y;
        v[c][2] = q.z;
        v[c][3] = q.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[c][i] = k0 + i < g ? grow[k0 + i] : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k0 = base + 128 * c + 4 * lane;
      int before = 0, total = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned ballot = __ballot_sync(0xffffffffu, v[c][i] != 0.f);
        before += __popc(ballot & below);
        total += __popc(ballot);
      }
      int at = n + before;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (v[c][i] != 0.f) {
          idx[at] = k0 + i;
          val[at] = v[c][i];
          ++at;
        }
      }
      n += total;
    }
  }
  __syncwarp();
  // each lane's CPL columns, summed over the list in ascending order (a
  // deeper unroll, or all of a batch's loads ahead of its multiply-adds,
  // took more registers and was no faster on an H100)
  const float* wcol = w_grid + c0;
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < n; ++e) {
    const float x = val[e];
    const float* wr = wcol + static_cast<long>(idx[e]) * pool;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (c0 + 32 * j < pool) acc[j] = fmaf(x, wr[32 * j], acc[j]);
    }
  }
  float* out = row + lin + 2;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int col = c0 + 32 * j;
    if (col < pool) out[col] = relu(acc[j] + bias[j]);
  }
}

// cp.async of 4 or 16 bytes into shared memory, zero-filled where `ok` is
// false (nothing is read then: `src` only has to be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most `pending` (0 .. 7) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait_at_most(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
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
                 : "=r"(done)
                 : "r"(smem_u32(bar)), "r"(parity)
                 : "memory");
    if (++spins > (1u << 28)) __trap();
  } while (!done);
}

// One thread: a bulk copy of `bytes` (a multiple of 16, both addresses on
// 16 bytes) from global into shared memory that completes the barrier's
// current phase.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The address of `p`'s counterpart in the shared memory of the cluster's
// block `rank`, and an arrival there that releases this thread's writes
// to the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void remote_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// mbar_wait for a phase completed by arrivals from across the cluster
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(smem_u32(bar)), "r"(parity)
                 : "memory");
    if (++spins > (1u << 28)) __trap();
  } while (!done);
}

// The forward cell kernel's tile: TR rows of xh by the 4 U gate columns of
// U hidden units (gate-major: column q is gate q / U of unit q % U), each
// thread 4 rows by 4 columns of one K group; KS groups split a stage's K in
// quads and their sums are added in group order.  Shared memory holds the
// tile's xh rows whole, [TR][XF] (XF = the chunks' K + 4: rows 4 banks
// apart), then the ring: a stage the slice's W_cell rows of a chunk, [KC]
// [NC], one bulk copy of the packed slice (fused_train.cell_pack).
template <int TR, int U>
struct CellTile {
  static constexpr int NC = 4 * U;
  static constexpr int GROUP = TR * U / 4;
  static constexpr int KS = CELL_THREADS / GROUP;
  static constexpr int STAGE = CELL_KC * NC;  // floats
  static_assert(TR % 4 == 0 && U % 4 == 0 && CELL_THREADS % GROUP == 0 &&
                    (CELL_KC / 4) % KS == 0,
                "a 4 x 4 thread tile and whole K groups of quads");
  static_assert(TR * U <= CELL_THREADS, "a thread per (row, unit) in the epilogue");
};

// floats of the forward cell kernel's shared memory at row length ld
template <int TR, int U, int NST>
constexpr int cell_smem_floats(int ld) {
  return TR * ((ld + CELL_KC - 1) / CELL_KC * CELL_KC + 4) + NST * CellTile<TR, U>::STAGE;
}

// One stage of the gates: this thread's 4 rows x 4 gate columns over every
// KS-th quad of the stage's K, summed apart and then added to `acc` (two
// short chains); PART: the last stage, whose W rows past `kn` are stale.
template <int TR, int U, bool PART>
__device__ __forceinline__ void cell_stage_sum(const float* xc, const float* ws, int xf, int kn,
                                               int group, int rq, int cq, float (&acc)[4][4]) {
  using T = CellTile<TR, U>;
  float sum[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sum[a][b] = 0.f;
#pragma unroll
  for (int i = 0; i < CELL_KC / 4 / T::KS; ++i) {
    const int k4 = 4 * (i * T::KS + group);
    float4 x[4], w[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x[a] = *reinterpret_cast<const float4*>(xc + (4 * rq + a) * xf + k4);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = !PART || k4 + q < kn
                 ? *reinterpret_cast<const float4*>(ws + (k4 + q) * T::NC + 4 * cq)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float xv[4] = {x[a].x, x[a].y, x[a].z, x[a].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sum[a][0] = fmaf(xv[q], w[q].x, sum[a][0]);
        sum[a][1] = fmaf(xv[q], w[q].y, sum[a][1]);
        sum[a][2] = fmaf(xv[q], w[q].z, sum[a][2]);
        sum[a][3] = fmaf(xv[q], w[q].w, sum[a][3]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] += sum[a][b];
}

// Block (x, y): rows [TR x, TR x + TR) and units [U y, U y + U); the
// blocks of a row tile are one cluster, rank y.  w_pack: [slices][ld][4][U].
template <int TR, int U, int NST>
__global__ void __launch_bounds__(CELL_THREADS, 1) fused_train_cell_kernel(
    const float* __restrict__ xh, const float* __restrict__ w_pack, const float* __restrict__ c,
    const uint8_t* __restrict__ mask, const float* __restrict__ obs2,
    const float* __restrict__ w_h2n, const float* __restrict__ b_h2n,
    float* __restrict__ xh_next, float* __restrict__ c_next, float* __restrict__ act,
    float* __restrict__ tc, float* __restrict__ sig, float* __restrict__ rel,
    float* __restrict__ pred, float* __restrict__ chain_xy, uint8_t* __restrict__ chain_mask,
    int rows, int agents, int hidden, int ld) {
  using T = CellTile<TR, U>;
  constexpr int NC = T::NC, GROUP = T::GROUP, KS = T::KS, STAGE = T::STAGE;
  constexpr int ISSUER = CELL_THREADS - 32;  // lane 0 of the last warp
  extern __shared__ __align__(128) float cell_smem[];  // xh rows, the ring; the groups' sums
  __shared__ float part[CELL_MAX_CLUSTER * TR * 5];  // rank 0's: each rank's head sums
  __shared__ __align__(8) uint64_t full[NST];  // a stage's W rows have landed
  __shared__ __align__(8) uint64_t heads;  // rank 0's: every rank's sums have landed
  cg::cluster_group cluster = cg::this_cluster();

  const int t = threadIdx.x, row0 = blockIdx.x * TR, u0 = blockIdx.y * U;
  const int chunks = (ld + CELL_KC - 1) / CELL_KC, xf = chunks * CELL_KC + 4;
  float* xs = cell_smem;              // [TR][xf]
  float* ring = cell_smem + TR * xf;  // NST x [KC][NC]
  const float* w_slice = w_pack + static_cast<long>(blockIdx.y) * ld * NC;
  auto load = [&](int ch) {  // one thread: a chunk's W rows by one bulk copy
    const int k0 = ch * CELL_KC, kn = min(CELL_KC, ld - k0);
    bulk_load(ring + (ch % NST) * STAGE, w_slice + static_cast<long>(k0) * NC,
              static_cast<uint32_t>(kn * NC * sizeof(float)), &full[ch % NST]);
  };
  if (t == ISSUER) {
    for (int i = 0; i < NST; ++i) mbar_init(&full[i], 1);
    if (blockIdx.y == 0) mbar_init(&heads, TR * gridDim.y);  // a writer a row and rank
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int ch = 0; ch < NST - 1 && ch < chunks; ++ch) load(ch);  // NST - 1 ahead
  }
  // every block of the cluster starts, and rank 0's `heads` is set (the
  // fence above releases it), before any rank writes to rank 0
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the tile's xh rows, whole, by cp.async (zero past the rows and past ld;
  // 16-byte loads of each row's aligned middle, a thread's issued before
  // its stores, took longer on an H100)
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const bool row_ok = row0 + i < rows;
    const float* src = xh + static_cast<long>(row0 + i) * ld;
    for (int k = t; k < xf; k += CELL_THREADS) {
      const bool ok = row_ok && k < ld;
      cp_async4(xs + i * xf + k, ok ? src + k : xh, ok);
    }
  }
  cp_async_commit();

  // the epilogue's inputs, read first so that their trips to memory overlap
  // the product's: a thread per (row, unit), and in rank 0 a thread per row
  const int row = t / U, u = t % U, j = u0 + u, r = row0 + row;
  const int x_width = ld - hidden - 1;
  const bool mine = t < TR * U && r < rows && j < hidden;
  bool m = false;
  float c_old = 0.f, h_old = 0.f, w_head[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (mine) {
    m = mask[r];
    c_old = c[static_cast<long>(r) * hidden + j];
    h_old = xh[static_cast<long>(r) * ld + x_width + j];
#pragma unroll
    for (int k = 0; k < 5; ++k) w_head[k] = w_h2n[5 * j + k];
  }
  const int rr = row0 + t;
  const bool head_row = blockIdx.y == 0 && t < TR && rr < rows;
  bool m_row = false;
  float b_head[5] = {0.f, 0.f, 0.f, 0.f, 0.f}, o_x = 0.f, o_y = 0.f;
  if (head_row) {
    m_row = mask[rr];
#pragma unroll
    for (int k = 0; k < 5; ++k) b_head[k] = b_h2n[k];
    o_x = obs2[2 * rr];
    o_y = obs2[2 * rr + 1];
  }
  // the gates: a ring of NST stages, NST - 1 chunks in flight ahead of the
  // one summed
  cp_async_wait<0>();
  __syncthreads();  // the xh rows have landed; the barriers are initialised
  const int group = t / GROUP, rq = (t % GROUP) / (NC / 4), cq = (t % GROUP) % (NC / 4);
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 1
  for (int ch = 0; ch < chunks; ++ch) {
    mbar_wait(&full[ch % NST], (ch / NST) & 1);
    __syncthreads();  // chunk ch has arrived; chunk ch - 1's stage is free
    if (t == ISSUER && ch + NST - 1 < chunks) load(ch + NST - 1);
    const float* xc = xs + ch * CELL_KC;
    const float* ws = ring + (ch % NST) * STAGE;
    const int kn = min(CELL_KC, ld - ch * CELL_KC);
    if (kn == CELL_KC) {
      cell_stage_sum<TR, U, false>(xc, ws, xf, kn, group, rq, cq, acc);
    } else {
      cell_stage_sum<TR, U, true>(xc, ws, xf, kn, group, rq, cq, acc);
    }
  }
  __syncthreads();  // every stage read: the ring becomes the groups' sums [KS][TR][NC]
  float* red = ring;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    *reinterpret_cast<float4*>(red + (group * TR + 4 * rq + a) * NC + 4 * cq) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
  __syncthreads();

  // the cell: a thread per (row, unit), as before the product moved in
  float head[5] = {0.f, 0.f, 0.f, 0.f, 0.f}, act4[4] = {0.f, 0.f, 0.f, 0.f};
  float cn = 0.f, th = 0.f, hn = 0.f;
  if (mine) {
    float gate[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < KS; ++k) s += red[(k * TR + row) * NC + q * U + u];
      gate[q] = s;
    }
    act4[0] = sigmoidf(gate[0]);
    act4[1] = sigmoidf(gate[1]);
    act4[2] = tanhf(gate[2]);
    act4[3] = sigmoidf(gate[3]);
    cn = act4[1] * c_old + act4[0] * act4[2];
    th = tanhf(cn);
    hn = act4[3] * th;
#pragma unroll
    for (int k = 0; k < 5; ++k) head[k] = hn * w_head[k];
  }
  // Hidden2Normal: the row's sum over this block's units (a butterfly over
  // the U lanes of the row), sent to rank 0 with an arrival on its `heads`
  // that releases it, before this thread's stores below (which the arrival
  // would otherwise wait for)
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (t < TR * U) {
#pragma unroll
    for (int off = U / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < 5; ++k) head[k] += __shfl_xor_sync(0xffffffffu, head[k], off);
    }
    if (u == 0) {
      float* dst = cluster.map_shared_rank(part, 0) + (blockIdx.y * TR + row) * 5;
#pragma unroll
      for (int k = 0; k < 5; ++k) dst[k] = head[k];
      remote_arrive(cluster_addr(&heads, 0));
    }
  }
  if (mine) {
    const long at = static_cast<long>(r) * hidden;
    float* a_row = act + 4 * at;
    xh_next[static_cast<long>(r) * ld + x_width + j] = m ? hn : h_old;
    c_next[at + j] = m ? cn : c_old;
#pragma unroll
    for (int q = 0; q < 4; ++q) a_row[q * hidden + j] = act4[q];
    tc[at + j] = th;
  }
  if (!head_row) return;
  // rank 0, a thread per row: the ranks' sums in rank order, the head
  mbar_wait_cluster(&heads, 0);
  float sum[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) sum[k] = part[t * 5 + k];
  for (int src = 1; src < static_cast<int>(gridDim.y); ++src) {
#pragma unroll
    for (int k = 0; k < 5; ++k) sum[k] += part[(src * TR + t) * 5 + k];
  }
  const float fm = m_row ? 1.f : 0.f;
  float s[3], normal[5];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = sigmoidf(sum[2 + k] + b_head[2 + k]);
  normal[0] = (sum[0] + b_head[0]) * fm;
  normal[1] = (sum[1] + b_head[1]) * fm;
  normal[2] = (0.01f + 0.2f * s[0]) * fm;
  normal[3] = (0.01f + 0.2f * s[1]) * fm;
  normal[4] = (0.7f * s[2]) * fm;
#pragma unroll
  for (int k = 0; k < 5; ++k) rel[5 * rr + k] = normal[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) sig[3 * rr + k] = s[k];
  xh_next[static_cast<long>(rr) * ld + ld - 1] = 1.f;  // the ones column
  const float px = (o_x + normal[0]) * fm, py = (o_y + normal[1]) * fm;
  pred[2 * rr] = px;
  pred[2 * rr + 1] = py;
  if (chain_xy != nullptr && rr % agents == 0) {  // the primary's lane two steps on
    chain_xy[2 * rr] = px;
    chain_xy[2 * rr + 1] = py;
    chain_mask[rr] = m_row;
  }
}

// Block (x, y): rows [TR x, TR x + TR) and units [U y, U y + U); each
// thread 2 rows by 2 units of one K group (rows i and i + TR / 2, units j
// and j + U / 2, so that a warp's 16-byte reads fall in distinct banks);
// KS groups split the 4H gate columns in quads, added in group order.
template <int TR, int U>
__global__ void __launch_bounds__(CELL_THREADS) fused_train_cell_backward_kernel(
    const float* __restrict__ d_rel, const float* __restrict__ d_pred,
    const uint8_t* __restrict__ mask, const float* __restrict__ sig,
    const float* __restrict__ act, const float* __restrict__ tc, const float* __restrict__ c,
    const float* __restrict__ w_h2n, const float* __restrict__ dg_next,
    const float* __restrict__ w_hh_next, float* __restrict__ dh, float* __restrict__ dc,
    float* __restrict__ dg, float* __restrict__ draw, int rows, int hidden) {
  constexpr int GROUP = TR * U / 4, KS = CELL_THREADS / GROUP;
  static_assert(TR % 2 == 0 && U % 2 == 0 && CELL_THREADS % GROUP == 0 && TR * U <= CELL_THREADS,
                "a 2 x 2 thread tile, whole K groups, a thread per (row, unit)");
  extern __shared__ __align__(16) float cell_smem[];  // dg_next's, W_hh_next's rows; the sums
  const int t = threadIdx.x, row0 = blockIdx.x * TR, u0 = blockIdx.y * U;
  const int g4 = 4 * hidden, lds = g4 + 4;  // a padded row: rows 4 banks apart
  const int row = t / U, u = t % U, j = u0 + u, r = row0 + row;
  // this thread's (row, unit) inputs, read first so that their trips to
  // memory overlap the product's
  const bool mine = t < TR * U && r < rows && j < hidden;
  const long at = static_cast<long>(r) * hidden;
  bool m = false;
  float dn[5] = {0.f, 0.f, 0.f, 0.f, 0.f}, w_head[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float s3[3] = {0.f, 0.f, 0.f}, a4[4] = {0.f, 0.f, 0.f, 0.f};
  float th = 0.f, c_in = 0.f, dh_old = 0.f, dc_old = 0.f;
  if (mine) {
    m = mask[r];
    const float fm = m ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < 5; ++k) dn[k] = d_rel[5 * r + k];
    if (d_pred != nullptr) {
      dn[0] += d_pred[2 * r] * fm;
      dn[1] += d_pred[2 * r + 1] * fm;
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) dn[k] *= fm;
#pragma unroll
    for (int k = 0; k < 3; ++k) s3[k] = sig[3 * r + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) a4[q] = act[4 * at + q * hidden + j];
#pragma unroll
    for (int k = 0; k < 5; ++k) w_head[k] = w_h2n[5 * j + k];
    th = tc[at + j];
    c_in = c[at + j];
    dh_old = dh[at + j];
    dc_old = dc[at + j];
  }
  float gemm = 0.f;  // this thread's (row, unit) of dg_next W_hh_next^T
  if (dg_next != nullptr) {
    float* as = cell_smem;             // [TR][lds]
    float* bs = cell_smem + TR * lds;  // [U][lds]
    const int chunks = (g4 + CELL_BACK_KC - 1) / CELL_BACK_KC;  // at most 8
    for (int ch = 0; ch < chunks; ++ch) {  // every chunk in flight, a group each
      const int k0 = ch * CELL_BACK_KC, width = min(CELL_BACK_KC, g4 - k0);
      for (int e = t; e < (TR + U) * width / 4; e += CELL_THREADS) {
        const int i = e / (width / 4), k = k0 + 4 * (e % (width / 4));
        const bool is_a = i < TR;
        const int src_row = is_a ? row0 + i : u0 + i - TR;
        const bool ok = src_row < (is_a ? rows : hidden);
        const float* base = is_a ? dg_next : w_hh_next;
        float* dst = cell_smem + i * lds + k;
        cp_async16(dst, ok ? base + static_cast<long>(src_row) * g4 + k : base, ok);
      }
      cp_async_commit();
    }
    const int group = t / GROUP, rp = (t % GROUP) / (U / 2), up = (t % GROUP) % (U / 2);
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int ch = 0; ch < chunks; ++ch) {
      cp_async_wait_at_most(chunks - 1 - ch);
      __syncthreads();
      const int q1 = min(g4, (ch + 1) * CELL_BACK_KC) / 4;
      float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // the chunk's share, then the whole's
      for (int q = ch * CELL_BACK_KC / 4 + group; q < q1; q += KS) {
        float4 a[2], b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i] = *reinterpret_cast<const float4*>(as + (rp + i * TR / 2) * lds + 4 * q);
          b[i] = *reinterpret_cast<const float4*>(bs + (up + i * U / 2) * lds + 4 * q);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float v = sum[i][k];
            v = fmaf(a[i].x, b[k].x, v);
            v = fmaf(a[i].y, b[k].y, v);
            v = fmaf(a[i].z, b[k].z, v);
            v = fmaf(a[i].w, b[k].w, v);
            sum[i][k] = v;
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < 2; ++k) acc[i][k] += sum[i][k];
    }
    __syncthreads();  // every row read: the rows become the groups' sums [KS][TR][U]
    float* red = cell_smem;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        red[(group * TR + rp + i * TR / 2) * U + up + k * U / 2] = acc[i][k];
    __syncthreads();
    if (t < TR * U) {
#pragma unroll
      for (int k = 0; k < KS; ++k) gemm += red[(k * TR + row) * U + u];
    }
  }
  if (!mine) return;
  // the raw head's gradient, 5 values a row, made by every thread
  float dr[5];
  dr[0] = dn[0];
  dr[1] = dn[1];
  dr[2] = dn[2] * 0.2f * s3[0] * (1.f - s3[0]);
  dr[3] = dn[3] * 0.2f * s3[1] * (1.f - s3[1]);
  dr[4] = dn[4] * 0.7f * s3[2] * (1.f - s3[2]);
  if (j == 0) {
#pragma unroll
    for (int k = 0; k < 5; ++k) draw[5 * r + k] = dr[k];
  }
  float* g_row = dg + 4 * at;
  const float dh_in = dg_next != nullptr ? dh_old + gemm : dh_old;
  if (!m) {  // h and c kept: the carried gradients pass, the gates get none
    g_row[j] = g_row[hidden + j] = g_row[2 * hidden + j] = g_row[3 * hidden + j] = 0.f;
    dh[at + j] = dh_in;
    return;
  }
  float dhn = dh_in;
#pragma unroll
  for (int k = 0; k < 5; ++k) dhn = fmaf(dr[k], w_head[k], dhn);
  const float si = a4[0], sf = a4[1], tg = a4[2], so = a4[3];
  const float dcn = dc_old + dhn * so * (1.f - th * th);
  g_row[j] = dcn * tg * si * (1.f - si);
  g_row[hidden + j] = dcn * c_in * sf * (1.f - sf);
  g_row[2 * hidden + j] = dcn * si * (1.f - tg * tg);
  g_row[3 * hidden + j] = dhn * th * so * (1.f - so);
  dc[at + j] = dcn * sf;
  dh[at + j] = 0.f;
}

// The forward cell kernel over row tiles of TR rows by ceil(hidden / U)
// hidden slices, the slices of a tile one cluster; its ring's shared memory
// above 48 KB, so the attribute is set at each launch.
template <int TR, int U, int NST>
cudaError_t launch_train_cell(const float* xh, const float* w_pack, const float* c,
                              const uint8_t* mask, const float* obs2, const float* w_h2n,
                              const float* b_h2n, float* xh_next, float* c_next, float* act,
                              float* tc, float* sig, float* rel, float* pred, float* chain_xy,
                              uint8_t* chain_mask, int rows, int agents, int hidden, int ld,
                              cudaStream_t stream) {
  const int slices = (hidden + U - 1) / U;
  const size_t smem = static_cast<size_t>(cell_smem_floats<TR, U, NST>(ld)) * sizeof(float);
  auto kernel = fused_train_cell_kernel<TR, U, NST>;
  cudaError_t status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            static_cast<int>(smem));
  if (status != cudaSuccess) return status;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = slices;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>((rows + TR - 1) / TR), slices, 1);
  config.blockDim = dim3(CELL_THREADS, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, xh, w_pack, c, mask, obs2, w_h2n, b_h2n, xh_next,
                            c_next, act, tc, sig, rel, pred, chain_xy, chain_mask, rows, agents,
                            hidden, ld);
}

// The backward cell kernel over the same tiles, no cluster; shared memory
// for the product's rows only where there is a product.
template <int TR, int U>
cudaError_t launch_train_cell_backward(const float* d_rel, const float* d_pred,
                                       const uint8_t* mask, const float* sig, const float* act,
                                       const float* tc, const float* c, const float* w_h2n,
                                       const float* dg_next, const float* w_hh_next, float* dh,
                                       float* dc, float* dg, float* draw, int rows, int hidden,
                                       cudaStream_t stream) {
  const int rows_smem = (TR + U) * (4 * hidden + 4), sums = CELL_THREADS * 4;  // KS TR U
  const int floats = rows_smem > sums ? rows_smem : sums;
  const size_t smem = dg_next == nullptr ? 0 : static_cast<size_t>(floats) * sizeof(float);
  auto kernel = fused_train_cell_backward_kernel<TR, U>;
  cudaError_t status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            static_cast<int>(smem));
  if (status != cudaSuccess) return status;
  const dim3 grid(static_cast<unsigned>((rows + TR - 1) / TR), (hidden + U - 1) / U);
  kernel<<<grid, CELL_THREADS, smem, stream>>>(d_rel, d_pred, mask, sig, act, tc, c, w_h2n,
                                                dg_next, w_hh_next, dh, dc, dg, draw, rows,
                                                hidden);
  return cudaSuccess;
}

// The relu masks: a block per tile of IB_WARPS * IB_RPT rows, warp w
// taking rows w and w + IB_WARPS of it.  A warp's lanes walk its rows'
// units (float4 of dx where VEC: the width a multiple of 4 and dx on 16
// bytes; else floats) IB_UNITS apart in a row, every load of a pass issued
// before its stores, so that a lane has IB_UNITS units of each of its two
// rows in flight (2 or 3 of a flagship row's 80 float4).  A unit is written
// whole with the select applied (NaN in xh is not positive, as in
// torch.where(x > 0, ...)).  xh is read float by float: a flagship row of
// xh is 449 floats.  Offsets within a row are 32-bit; a row's bases are
// formed once.  16 rows a tile: on an H100 the fastest of 8, 16 and 32 at
// a flagship rollout's 1,216 rows, level with them at 155,648 (PERF.md).
template <bool VEC>
__global__ void __launch_bounds__(32 * IB_WARPS)
    fused_train_in_backward_kernel(float* __restrict__ dx, const float* __restrict__ xh, int n,
                                   int width, int ld) {
  const int units = VEC ? width / 4 : width;
  float* drow[IB_RPT];
  const float* xrow[IB_RPT];
  bool live[IB_RPT];
#pragma unroll
  for (int k = 0; k < IB_RPT; ++k) {
    const int r = static_cast<int>((blockIdx.x * IB_RPT + k) * IB_WARPS + threadIdx.y);
    live[k] = r < n;
    drow[k] = dx + static_cast<size_t>(live[k] ? r : 0) * width;
    xrow[k] = xh + static_cast<size_t>(live[k] ? r : 0) * ld;
  }
  for (int j0 = threadIdx.x; j0 < units; j0 += 32 * IB_UNITS) {
    float4 v[IB_RPT][IB_UNITS], x[IB_RPT][IB_UNITS];
#pragma unroll
    for (int k = 0; k < IB_RPT; ++k) {
#pragma unroll
      for (int i = 0; i < IB_UNITS; ++i) {
        const int j = j0 + 32 * i;
        if (!live[k] || j >= units) continue;
        if (VEC) {
          v[k][i] = reinterpret_cast<const float4*>(drow[k])[j];
          const float* xs = xrow[k] + 4 * j;
          x[k][i] = make_float4(xs[0], xs[1], xs[2], xs[3]);
        } else {
          v[k][i].x = drow[k][j];
          x[k][i].x = xrow[k][j];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < IB_RPT; ++k) {
#pragma unroll
      for (int i = 0; i < IB_UNITS; ++i) {
        const int j = j0 + 32 * i;
        if (!live[k] || j >= units) continue;
        const float4 a = v[k][i], b = x[k][i];
        if (VEC) {
          reinterpret_cast<float4*>(drow[k])[j] =
              make_float4(b.x > 0.f ? a.x : 0.f, b.y > 0.f ? a.y : 0.f, b.z > 0.f ? a.z : 0.f,
                          b.w > 0.f ? a.w : 0.f);
        } else {
          drow[k][j] = b.x > 0.f ? a.x : 0.f;
        }
      }
    }
  }
}

// The mixture NLL -log(0.01 + 0.2 N(mu, 3) + 0.79 N(mu, sigma, rho)) of one
// entry (in: mu1, mu2, s1, s2, rho) at (x, y), and its gradient.  The
// Gaussian's exponent keeps the plain version's four divisions and its
// rounding, with no contraction (the __f*_rn intrinsics): exp carries an
// error of its argument into the density times the argument's size (up to
// ~1e-6 of the gradient's largest at the train batch's normals with a
// reciprocal there).  Every other quotient multiplies by one of four
// reciprocals (of s1, s2, q and the density), so that a chain holds four
// divisions and four reciprocals, not ~20 divisions.
__device__ __forceinline__ void nll_and_grad(const float in[5], float x, float y, float* value,
                                             float d[5]) {
  const float mu1 = in[0], mu2 = in[1], s1 = in[2], s2 = in[3], rho = in[4];
  const float n1 = x - mu1, n2 = y - mu2;
  // the exponent, as the plain version rounds it
  const float a = __fdiv_rn(n1, s1), b = __fdiv_rn(n2, s2);
  const float q = __fsub_rn(1.f, __fmul_rn(rho, rho));
  const float z = __fsub_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                            __fdiv_rn(__fmul_rn(__fmul_rn(2.f * rho, n1), n2), __fmul_rn(s1, s2)));
  const float arg = __fdiv_rn(-z, 2.f * q);
  // the rest by reciprocals
  const float rs1 = __frcp_rn(s1), rs2 = __frcp_rn(s2), rq = __frcp_rn(q);
  const float g_bg = expf((n1 * n1 + n2 * n2) * (-1.f / 18.f)) * (INV_TWO_PI / 9.f);
  const float g = expf(arg) * (rs1 * rs2 * sqrtf(rq) * INV_TWO_PI);
  const float density = 0.01f + 0.2f * g_bg + 0.79f * g;
  const float rd = __frcp_rn(density);
  const float c_bg = -0.2f * g_bg * rd, c = -0.79f * g * rd;
  const float amb = a - rho * b, bma = b - rho * a;
  *value = -logf(density);
  d[0] = c_bg * n1 * (1.f / 9.f) + c * amb * rs1 * rq;
  d[1] = c_bg * n2 * (1.f / 9.f) + c * bma * rs2 * rq;
  d[2] = c * (a * amb * rq - 1.f) * rs1;
  d[3] = c * (b * bma * rq - 1.f) * rs2;
  d[4] = c * (a * b * rq - rho * z * rq * rq + rho * rq);
}

// The sum of v over a warp by a butterfly: every lane gets the same bits,
// in the same order in every run.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int lane_mask = 16; lane_mask > 0; lane_mask >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, lane_mask);
  }
  return v;
}

// One block of blockDim.x threads (a multiple of 32 up to LOSS_MAX_THREADS,
// fused_train.loss_threads): entry e = (t, s) of the primaries' last p
// steps, a thread each, strided over the threads above 1,024.  A thread issues
// all of its entry's loads before any branch (its scene's mask, its normal
// and its target, in bounds whatever the mask) and then selects the unit
// normal at the origin in a masked scene, as the plain version does.  Its
// dvals are five consecutive floats, a warp's 640 contiguous bytes (timed
// faster on an H100 than staging a chunk's run through shared memory and
// storing it coalesced, which adds a barrier a chunk).  The value and the
// count are summed by a warp butterfly, the warps' partials passed through
// shared memory after one barrier and added by warp 0's butterfly: a fixed
// order, no atomics.
__global__ void __launch_bounds__(LOSS_MAX_THREADS)
    fused_train_loss_kernel(const float* __restrict__ rel, const float* __restrict__ targets,
                            const uint8_t* __restrict__ scene_mask, float* __restrict__ loss,
                            float* __restrict__ count, float* __restrict__ dvals, int t_all, int p,
                            int s, int a) {
  __shared__ float warp_sums[LOSS_MAX_THREADS / 32];
  __shared__ int warp_counts[LOSS_MAX_THREADS / 32];
  const int tid = threadIdx.x, threads = blockDim.x, entries = p * s;
  float sum = 0.f;
  int n = 0;
  for (int e = tid; e < entries; e += threads) {
    const unsigned t = static_cast<unsigned>(e) / static_cast<unsigned>(s);
    const int sc = e - static_cast<int>(t) * s;
    const float* r = rel + (static_cast<size_t>(t_all - p + t) * s + sc) * a * 5;
    const bool m = scene_mask[sc];
    float in[5] = {r[0], r[1], r[2], r[3], r[4]};
    float x = targets[2 * e], y = targets[2 * e + 1];
    if (!m) {
      in[0] = in[1] = in[4] = x = y = 0.f;
      in[2] = in[3] = 1.f;
    }
    float value, d[5];
    nll_and_grad(in, x, y, &value, d);
#pragma unroll
    for (int k = 0; k < 5; ++k) dvals[5 * static_cast<size_t>(e) + k] = m ? d[k] : 0.f;
    sum += m ? value : 0.f;
    n += m;
  }
  sum = warp_sum(sum);
  n = warp_sum(n);
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    warp_sums[warp] = sum;
    warp_counts[warp] = n;
  }
  __syncthreads();
  if (warp == 0) {
    const bool held = lane < threads / 32;
    sum = warp_sum(held ? warp_sums[lane] : 0.f);
    n = warp_sum(held ? warp_counts[lane] : 0);
    if (lane == 0) {
      *count = static_cast<float>(n);
      *loss = sum / fmaxf(static_cast<float>(n), 1.f);
    }
  }
}

// d_rel [t_all, s, a, 5]: d_loss / max(count, 1) times dvals at the
// primaries' last p steps, zero elsewhere, as units of float4 (VEC: a % 4
// == 0, d_rel on 16 bytes) or of one float, a thread a unit (grid-strided
// beyond MAX_BLOCKS blocks).  The first `zeros` units are the steps before
// the last p, one zero range; then a row of `width` units a (step, scene)
// of the last p, in dvals' order, whose first PRIMARY units hold the
// primary's 5 floats (VEC: its first four, then its fifth beside three
// zeros of agent 1) and whose others are zero.  A thread whose unit holds
// no primary float stores its zeros with no load before them; only a
// thread of a primary unit loads d_loss, count and its dvals, and stores
// them scaled, so each unit has one writer.  All index math is 32-bit (the
// launch refuses more than INT32_MAX floats): one unsigned division by
// `width` for a unit of the last p steps.  The scale and the products round
// as the plain version's: an IEEE division, then one multiplication.
template <bool VEC>
__global__ void __launch_bounds__(LB_THREADS)
    fused_train_loss_backward_kernel(const float* __restrict__ d_loss,
                                     const float* __restrict__ dvals,
                                     const float* __restrict__ count, float* __restrict__ d_rel,
                                     unsigned zeros, unsigned total, unsigned width) {
  constexpr unsigned PRIMARY = VEC ? 2 : 5;
  for (unsigned i = blockIdx.x * LB_THREADS + threadIdx.x; i < total;
       i += gridDim.x * LB_THREADS) {
    unsigned row = 0, k = PRIMARY;  // k < PRIMARY: the unit's place among the primary's
    if (i >= zeros) {
      row = (i - zeros) / width;
      k = i - zeros - row * width;
    }
    if (k >= PRIMARY) {
      if (VEC) {
        reinterpret_cast<float4*>(d_rel)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        d_rel[i] = 0.f;
      }
      continue;
    }
    const float* d = dvals + 5 * row + (VEC ? 4 * k : k);
    const bool four = VEC && k == 0;  // the primary's first four floats, else one
    const float dl = *d_loss, n = *count;
    float4 v = make_float4(d[0], 0.f, 0.f, 0.f);
    if (four) v = make_float4(v.x, d[1], d[2], d[3]);
    const float scale = __fdiv_rn(dl, fmaxf(n, 1.f));
    const float4 out = make_float4(__fmul_rn(v.x, scale), four ? __fmul_rn(v.y, scale) : 0.f,
                                   four ? __fmul_rn(v.z, scale) : 0.f,
                                   four ? __fmul_rn(v.w, scale) : 0.f);
    if (VEC) {
      reinterpret_cast<float4*>(d_rel)[i] = out;
    } else {
      d_rel[i] = out.x;
    }
  }
}

}  // namespace

extern "C" {

// Every tensor contiguous float32 (masks one byte a row, torch.bool) on
// the current device; each returns cudaGetLastError() after its launch.

// obs1, obs2 [rows, 2]; p1, p2, mask [rows]; grid [rows, g]; w_emb [2,
// lin]; b_emb [lin]; w_grid [g, pool]; b_grid [pool]; xh [rows, ld] (ld >
// lin + 2 + pool); v4 [rows, 3].  cols_per_lane (1, 2, 4 or 8): the pool
// columns a lane of a pool warp owns, so a row takes 1 + pool / (32
// cols_per_lane) warps.
int dlstm_train_in(const float* obs1, const float* obs2, const uint8_t* p1, const uint8_t* p2,
                   const float* grid, const float* w_emb, const float* b_emb,
                   const float* w_grid, const float* b_grid, float* xh, float* v4,
                   uint8_t* mask, int rows, int lin, int g, int pool, int ld, int cols_per_lane,
                   void* stream) {
  // 4 warps a block, fewer where a wide grid's lists would pass 48 KB (G
  // is at most 2 * 32^2, 16 KB a list)
  const int list_bytes = 2 * g * static_cast<int>(sizeof(float));
  int warps = 4;
  while (warps > 1 && warps * list_bytes > 48 * 1024) --warps;
  const long parts = 1 + (pool + 32L * cols_per_lane - 1) / (32L * cols_per_lane);
  const long blocks = (static_cast<long>(rows) * parts + warps - 1) / warps;
  const bool vec = g % 4 == 0 && reinterpret_cast<uintptr_t>(grid) % 16 == 0;
  const size_t smem = static_cast<size_t>(warps) * list_bytes;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_dims(static_cast<unsigned>(blocks));
#define TRAIN_IN_LAUNCH(CPL)                                                                 \
  fused_train_in_kernel<CPL><<<grid_dims, 32 * warps, smem, st>>>(                           \
      obs1, obs2, p1, p2, grid, w_emb, b_emb, w_grid, b_grid, xh, v4, mask, rows, lin, g, \
      pool, ld, vec)
  switch (cols_per_lane) {
    case 1: TRAIN_IN_LAUNCH(1); break;
    case 2: TRAIN_IN_LAUNCH(2); break;
    case 4: TRAIN_IN_LAUNCH(4); break;
    case 8: TRAIN_IN_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRAIN_IN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// xh, xh_next [rows, ld], h at ld - hidden - 1 and the ones column last;
// w_pack [slices][ld][4][units]: [W_ih; W_hh; b_ih + b_hh] a slice's gate
// columns a row, on 16 bytes (fused_train.cell_pack); act [rows, 4 hidden];
// c, c_next, tc [rows, hidden]; mask [rows]; obs2, pred [rows, 2]; w_h2n
// [hidden, 5]; b_h2n [5]; sig [rows, 3]; rel [rows, 5]; chain_xy [rows, 2]
// and chain_mask [rows] (the primary every `agents` rows) or null.
// (units, tile_rows): (16, 4), (16, 8), (16, 16) or (32, 8), hidden at most
// CELL_MAX_CLUSTER units.
int dlstm_train_cell(const float* xh, const float* w_pack, const float* c, const uint8_t* mask,
                     const float* obs2, const float* w_h2n, const float* b_h2n, float* xh_next,
                     float* c_next, float* act, float* tc, float* sig, float* rel, float* pred,
                     float* chain_xy, uint8_t* chain_mask, int rows, int agents, int hidden,
                     int ld, int units, int tile_rows, void* stream) {
  if (hidden < 1 || hidden > CELL_MAX_CLUSTER * units || ld <= hidden + 1 ||
      ld > CELL_MAX_LD || reinterpret_cast<uintptr_t>(w_pack) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TRAIN_CELL_LAUNCH(TR, U, NST)                                                          \
  launch_train_cell<TR, U, NST>(xh, w_pack, c, mask, obs2, w_h2n, b_h2n, xh_next, c_next, act, \
                                tc, sig, rel, pred, chain_xy, chain_mask, rows, agents, hidden,  \
                                ld, st)
  // the whole K of a 64-K-wide stage ring in flight where it fits
  cudaError_t status = cudaErrorInvalidValue;
  if (units == 16 && tile_rows == 4) {
    status = TRAIN_CELL_LAUNCH(4, 16, 8);
  } else if (units == 16 && tile_rows == 8) {
    status = TRAIN_CELL_LAUNCH(8, 16, 8);
  } else if (units == 16 && tile_rows == 16) {
    status = TRAIN_CELL_LAUNCH(16, 16, 4);
  } else if (units == 32 && tile_rows == 8) {
    status = TRAIN_CELL_LAUNCH(8, 32, 4);
  }
#undef TRAIN_CELL_LAUNCH
  return static_cast<int>(status != cudaSuccess ? status : cudaGetLastError());
}

// d_rel, draw [rows, 5]; d_pred [rows, 2] or null; mask [rows]; sig [rows,
// 3]; act, dg [rows, 4 hidden]; tc, c, dh, dc [rows, hidden]; w_h2n
// [hidden, 5]; dg_next [rows, 4 hidden] (step g + 1's gates' gradient) and
// w_hh_next [hidden, 4 hidden] (rows of step g + 1's w_cell), both on 16
// bytes, or both null at the last step.  dh and dc updated in place.
// (units, tile_rows) as the forward's.
int dlstm_train_cell_backward(const float* d_rel, const float* d_pred, const uint8_t* mask,
                              const float* sig, const float* act, const float* tc,
                              const float* c, const float* w_h2n, const float* dg_next,
                              const float* w_hh_next, float* dh, float* dc, float* dg,
                              float* draw, int rows, int hidden, int units, int tile_rows,
                              void* stream) {
  if (hidden < 1 || hidden > CELL_MAX_CLUSTER * units ||
      (dg_next == nullptr) != (w_hh_next == nullptr) ||
      (reinterpret_cast<uintptr_t>(dg_next) | reinterpret_cast<uintptr_t>(w_hh_next)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TRAIN_CELL_BACKWARD_LAUNCH(TR, U)                                                      \
  launch_train_cell_backward<TR, U>(d_rel, d_pred, mask, sig, act, tc, c, w_h2n, dg_next,      \
                                    w_hh_next, dh, dc, dg, draw, rows, hidden, st)
  cudaError_t status = cudaErrorInvalidValue;
  if (units == 16 && tile_rows == 4) {
    status = TRAIN_CELL_BACKWARD_LAUNCH(4, 16);
  } else if (units == 16 && tile_rows == 8) {
    status = TRAIN_CELL_BACKWARD_LAUNCH(8, 16);
  } else if (units == 16 && tile_rows == 16) {
    status = TRAIN_CELL_BACKWARD_LAUNCH(16, 16);
  } else if (units == 32 && tile_rows == 8) {
    status = TRAIN_CELL_BACKWARD_LAUNCH(8, 32);
  }
#undef TRAIN_CELL_BACKWARD_LAUNCH
  return static_cast<int>(status != cudaSuccess ? status : cudaGetLastError());
}

// dx [n, width] in place; xh [n, ld], ld >= width.
int dlstm_train_in_backward(float* dx, const float* xh, int n, int width, int ld,
                            void* stream) {
  if (n < 1 || width < 1 || ld < width) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = IB_WARPS * IB_RPT;
  const dim3 grid(static_cast<unsigned>((n + tile - 1) / tile)), block(32, IB_WARPS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width % 4 == 0 && reinterpret_cast<uintptr_t>(dx) % 16 == 0) {
    fused_train_in_backward_kernel<true><<<grid, block, 0, st>>>(dx, xh, n, width, ld);
  } else {
    fused_train_in_backward_kernel<false><<<grid, block, 0, st>>>(dx, xh, n, width, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

// rel [t_all, s, a, 5]; targets [p, s, 2]; scene_mask [s]; loss, count
// one float each; dvals [p, s, 5].  threads: the block's, a multiple of 32
// up to LOSS_MAX_THREADS (fused_train.loss_threads).
int dlstm_train_loss(const float* rel, const float* targets, const uint8_t* scene_mask,
                     float* loss, float* count, float* dvals, int t_all, int p, int s, int a,
                     int threads, void* stream) {
  if (threads < 32 || threads > LOSS_MAX_THREADS || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fused_train_loss_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rel, targets, scene_mask, loss, count, dvals, t_all, p, s, a);
  return static_cast<int>(cudaGetLastError());
}

// d_loss, count one float each; dvals [p, s, 5]; d_rel [t_all, s, a, 5],
// at most INT32_MAX floats.
int dlstm_train_loss_backward(const float* d_loss, const float* dvals, const float* count,
                              float* d_rel, int t_all, int p, int s, int a, void* stream) {
  const long long floats = static_cast<long long>(t_all) * s * a * 5;
  if (t_all < 1 || p < 1 || p > t_all || s < 1 || a < 1 || floats > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = a % 4 == 0 && reinterpret_cast<uintptr_t>(d_rel) % 16 == 0;
  const unsigned unit = vec ? 4 : 1, row = 5u * static_cast<unsigned>(a);
  const unsigned total = static_cast<unsigned>(floats) / unit;
  const unsigned zeros = static_cast<unsigned>(t_all - p) * static_cast<unsigned>(s) * row / unit;
  const unsigned blocks = (total + LB_THREADS - 1) / LB_THREADS;
  const dim3 grid(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    fused_train_loss_backward_kernel<true>
        <<<grid, LB_THREADS, 0, st>>>(d_loss, dvals, count, d_rel, zeros, total, row / unit);
  } else {
    fused_train_loss_backward_kernel<false>
        <<<grid, LB_THREADS, 0, st>>>(d_loss, dvals, count, d_rel, zeros, total, row / unit);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
