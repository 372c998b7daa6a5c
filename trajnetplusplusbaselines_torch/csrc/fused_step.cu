// Fused D-LSTM step for Hopper (sm_90a): directional grid pooling, input
// embedding, grid embedding, LSTM cell, Hidden2Normal and the masked state
// update in one launch.
//
// Replaces the Pallas TPU kernel trajnetplusplusbaselines_tpu/ops/pallas/
// fused_step.py:_kernel (launched by fused_dlstm_step).  It computes what that
// kernel computes, in the port's scene-major layout: every tensor is
// [S, A, F] contiguous, flattened to S*A agent rows, and A is taken at run
// time (any A >= 1).
//
// Design.  A block owns ROWS consecutive agent rows.  The 12x12x2 grid of
// each row is built in shared memory by the winner reduction of the JAX
// package's _winner_reduce: every (row, j != i) pair does atomicMax of j into
// the cell it writes, then every (row, cell) gathers the winner's value, or
// `constant` where no neighbour wrote.  The grid never reaches device memory.
// The three matrix products ([288]x[288,256], [320]x[320,512],
// [128]x[128,512]) are CUDA-core FMAs: thread t owns output column t, loops
// over k, reads the weights from global memory (all of them, ~1.2 MB f32,
// stay resident in L2) and accumulates all rows of the block in registers.
// Each hidden unit's four gates belong to one thread, so the LSTM pointwise
// stage needs no exchange.
//
// What bounds it: L2 reads of the weights (each block streams all 1.2 MB
// once for its ROWS rows) and f32 FMAs on CUDA cores; no tensor cores yet.
// The tensor-core version (wgmma, bf16) is later work.
//
// Exactness of the grid: the cell index is (pos_j - pos_i) / cell_side + n/2
// with IEEE division, in that order (the __f*_rn intrinsics are never
// contracted or rewritten), so neighbours on a cell boundary land in the same
// cell as in the plain version.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 12;              // grid side
constexpr int G = N * N;           // cells per channel
constexpr int GRID_DIM = 2 * G;    // directional grid, channel-major
constexpr int EMB = 64;            // embedding_dim (62 linear + 2 zero tags)
constexpr int EMB_LIN = EMB - 2;
constexpr int POOL = 256;          // grid embedding width
constexpr int IN = EMB + POOL;     // LSTM input width
constexpr int H = 128;             // hidden_dim
constexpr int GATES = 4 * H;
constexpr int NORMAL = 5;
constexpr int ROWS = 16;           // agent rows per block
constexpr int THREADS = 256;
constexpr int HALF_ROWS = ROWS / 2;

static_assert(THREADS == POOL, "one thread per grid-embedding column");
static_assert(THREADS == 2 * H, "two threads per hidden unit");

// shared memory of the fused kernel, in floats / ints
constexpr int SMEM_INP = ROWS * IN;
constexpr int SMEM_GRID = ROWS * GRID_DIM;
constexpr int SMEM_H = ROWS * H;
constexpr int SMEM_WINNER = ROWS * G;
constexpr size_t FUSED_SMEM_BYTES =
    sizeof(float) * (SMEM_INP + SMEM_GRID + 2 * SMEM_H) + sizeof(int) * SMEM_WINNER;
constexpr int MAX_DEVICES = 64;    // devices the shared-memory opt-in is tracked for

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

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// Where neighbour j (flat row rj) writes in the grid of agent i (flat row ri),
// and whether the write is in range (else it writes `constant` into cell 0).
__device__ __forceinline__ int write_cell(const Scene& sc, int ri, int rj, bool* in_range) {
  const float half_n = 0.5f * N;
  float ox = __fadd_rn(__fdiv_rn(__fsub_rn(sc.obs2[2 * rj], sc.obs2[2 * ri]), sc.cell_side), half_n);
  float oy = __fadd_rn(__fdiv_rn(__fsub_rn(sc.obs2[2 * rj + 1], sc.obs2[2 * ri + 1]), sc.cell_side), half_n);
  bool ok = sc.p2[ri] && sc.p2[rj] && ox >= 0.0f && ox < (float)N && oy >= 0.0f && oy < (float)N;
  *in_range = ok;
  // trunc equals floor here: negative values are out of range
  return ok ? (int)ox * N + (int)oy : 0;
}

// Builds the directional grids of rows [row0, row0 + ROWS) into out
// (row-major [ROWS, GRID_DIM]); winner is shared scratch of ROWS * G ints.
// Rows past the end get `constant` everywhere.
__device__ void build_grid(const Scene& sc, int row0, int* winner, float* out) {
  for (int idx = threadIdx.x; idx < ROWS * G; idx += blockDim.x) winner[idx] = -1;
  __syncthreads();

  // every non-self neighbour writes; the highest j wins the cell
  for (int idx = threadIdx.x; idx < ROWS * sc.a; idx += blockDim.x) {
    int r = idx / sc.a, j = idx - (idx / sc.a) * sc.a;
    int row = row0 + r;
    if (row >= sc.rows) continue;
    int i = row % sc.a;
    if (j == i) continue;
    bool in_range;
    int cell = write_cell(sc, row, row - i + j, &in_range);
    atomicMax(&winner[r * G + cell], j);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < ROWS * G; idx += blockDim.x) {
    int r = idx / G, g = idx - (idx / G) * G;
    int row = row0 + r;
    float vx = sc.constant, vy = sc.constant;
    int w = winner[idx];
    if (row < sc.rows && w >= 0) {
      int i = row % sc.a;
      int rw = row - i + w;
      bool in_range;
      write_cell(sc, row, rw, &in_range);
      if (in_range) {
        // relative velocity, zero unless both are present at t-1 and t
        bool both = sc.p1[row] && sc.p2[row] && sc.p1[rw] && sc.p2[rw];
        vx = both ? __fsub_rn(__fsub_rn(sc.obs2[2 * rw], sc.obs1[2 * rw]),
                              __fsub_rn(sc.obs2[2 * row], sc.obs1[2 * row])) : 0.0f;
        vy = both ? __fsub_rn(__fsub_rn(sc.obs2[2 * rw + 1], sc.obs1[2 * rw + 1]),
                              __fsub_rn(sc.obs2[2 * row + 1], sc.obs1[2 * row + 1])) : 0.0f;
      }
    }
    out[r * GRID_DIM + g] = vx;
    out[r * GRID_DIM + G + g] = vy;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) directional_grid_kernel(Scene sc, float* grid_out) {
  __shared__ int winner[ROWS * G];
  __shared__ float grid[ROWS * GRID_DIM];
  int row0 = blockIdx.x * ROWS;
  build_grid(sc, row0, winner, grid);
  for (int idx = threadIdx.x; idx < ROWS * GRID_DIM; idx += blockDim.x) {
    int row = row0 + idx / GRID_DIM;
    if (row < sc.rows) grid_out[(size_t)row0 * GRID_DIM + idx] = grid[idx];
  }
}

struct Weights {
  const float* w_emb;    // [2, EMB_LIN]
  const float* b_emb;    // [EMB_LIN]
  const float* w_grid;   // [GRID_DIM, POOL]
  const float* b_grid;   // [POOL]
  const float* w_ih;     // [IN, GATES]
  const float* w_hh;     // [H, GATES]
  const float* b_gates;  // [GATES] = b_ih + b_hh
  const float* w_h2n;    // [H, NORMAL]
  const float* b_h2n;    // [NORMAL]
};

__global__ void __launch_bounds__(THREADS) fused_step_kernel(
    Scene sc, Weights wt, const float* __restrict__ h, const float* __restrict__ c,
    float* __restrict__ h_out, float* __restrict__ c_out, float* __restrict__ normal,
    uint8_t* __restrict__ mask_out) {
  extern __shared__ float smem[];
  float* inp = smem;                      // [ROWS, IN]: emb(62) | tags(2) | pooled(256)
  float* grid = inp + SMEM_INP;           // [ROWS, GRID_DIM]
  float* hs = grid + SMEM_GRID;           // [ROWS, H] old hidden state
  float* hn = hs + SMEM_H;                // [ROWS, H] new hidden state, unmasked
  int* winner = (int*)(hn + SMEM_H);      // [ROWS, G]

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;

  // old hidden state and the input embedding relu(4 * vel @ W + b) | 0 0
  for (int idx = t; idx < ROWS * H; idx += blockDim.x) {
    int row = row0 + idx / H;
    hs[idx] = row < sc.rows ? h[(size_t)row0 * H + idx] : 0.0f;
  }
  for (int idx = t; idx < ROWS * EMB; idx += blockDim.x) {
    int r = idx / EMB, k = idx - (idx / EMB) * EMB;
    int row = row0 + r;
    float v = 0.0f;
    if (row < sc.rows && k < EMB_LIN) {
      bool m = sc.p1[row] && sc.p2[row];
      float vx = m ? sc.obs2[2 * row] - sc.obs1[2 * row] : 0.0f;
      float vy = m ? sc.obs2[2 * row + 1] - sc.obs1[2 * row + 1] : 0.0f;
      v = fmaxf(wt.b_emb[k] + 4.0f * vx * wt.w_emb[k] + 4.0f * vy * wt.w_emb[EMB_LIN + k], 0.0f);
    }
    inp[r * IN + k] = v;
  }

  build_grid(sc, row0, winner, grid);  // ends with __syncthreads

  // grid embedding: relu(grid @ W_grid + b), thread t owns column t
  {
    float acc[ROWS];
    float b = wt.b_grid[t];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = b;
    for (int k = 0; k < GRID_DIM; ++k) {
      float w = wt.w_grid[k * POOL + t];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(grid[r * GRID_DIM + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) inp[r * IN + EMB + t] = fmaxf(acc[r], 0.0f);
  }
  __syncthreads();

  // LSTM gates: thread t owns hidden unit u for half of the block's rows
  const int u = t % H;
  const int rbase = (t / H) * HALF_ROWS;
  {
    float ai[HALF_ROWS], af[HALF_ROWS], ag[HALF_ROWS], ao[HALF_ROWS];
#pragma unroll
    for (int r = 0; r < HALF_ROWS; ++r) {
      ai[r] = wt.b_gates[u];
      af[r] = wt.b_gates[H + u];
      ag[r] = wt.b_gates[2 * H + u];
      ao[r] = wt.b_gates[3 * H + u];
    }
    for (int k = 0; k < IN; ++k) {
      const float* w = wt.w_ih + k * GATES + u;
      float wi = w[0], wf = w[H], wg = w[2 * H], wo = w[3 * H];
#pragma unroll
      for (int r = 0; r < HALF_ROWS; ++r) {
        float x = inp[(rbase + r) * IN + k];
        ai[r] = fmaf(x, wi, ai[r]);
        af[r] = fmaf(x, wf, af[r]);
        ag[r] = fmaf(x, wg, ag[r]);
        ao[r] = fmaf(x, wo, ao[r]);
      }
    }
    for (int k = 0; k < H; ++k) {
      const float* w = wt.w_hh + k * GATES + u;
      float wi = w[0], wf = w[H], wg = w[2 * H], wo = w[3 * H];
#pragma unroll
      for (int r = 0; r < HALF_ROWS; ++r) {
        float x = hs[(rbase + r) * H + k];
        ai[r] = fmaf(x, wi, ai[r]);
        af[r] = fmaf(x, wf, af[r]);
        ag[r] = fmaf(x, wg, ag[r]);
        ao[r] = fmaf(x, wo, ao[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < HALF_ROWS; ++r) {
      int row = row0 + rbase + r;
      float c_old = row < sc.rows ? c[(size_t)row * H + u] : 0.0f;
      float c_new = sigmoidf(af[r]) * c_old + sigmoidf(ai[r]) * tanhf(ag[r]);
      float h_new = sigmoidf(ao[r]) * tanhf(c_new);
      hn[(rbase + r) * H + u] = h_new;
      if (row < sc.rows) {
        // the masked update keeps the old state where the agent is not
        // present at both t-1 and t
        bool m = sc.p1[row] && sc.p2[row];
        h_out[(size_t)row * H + u] = m ? h_new : hs[(rbase + r) * H + u];
        c_out[(size_t)row * H + u] = m ? c_new : c_old;
      }
    }
  }
  __syncthreads();

  // Hidden2Normal on the unmasked new state, zeroed where masked
  for (int idx = t; idx < ROWS * NORMAL; idx += blockDim.x) {
    int r = idx / NORMAL, o = idx - (idx / NORMAL) * NORMAL;
    int row = row0 + r;
    if (row >= sc.rows) continue;
    float acc = wt.b_h2n[o];
    for (int k = 0; k < H; ++k) acc = fmaf(hn[r * H + k], wt.w_h2n[k * NORMAL + o], acc);
    float v = o < 2 ? acc : (o < 4 ? 0.01f + 0.2f * sigmoidf(acc) : 0.7f * sigmoidf(acc));
    bool m = sc.p1[row] && sc.p2[row];
    normal[(size_t)row * NORMAL + o] = m ? v : 0.0f;
    if (o == 0) mask_out[row] = m ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// All tensors [S, A, F] contiguous on the current device; present masks are
// one byte per agent (torch.bool).  Returns cudaGetLastError() after launch.
int dlstm_directional_grid(const float* obs1, const float* obs2, const uint8_t* p1,
                           const uint8_t* p2, float* grid_out, int s, int a,
                           float cell_side, float constant, void* stream) {
  Scene sc{obs1, obs2, p1, p2, s * a, a, cell_side, constant};
  int blocks = (sc.rows + ROWS - 1) / ROWS;
  directional_grid_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(sc, grid_out);
  return (int)cudaGetLastError();
}

int dlstm_fused_step(const float* obs1, const float* obs2, const uint8_t* p1,
                     const uint8_t* p2, const float* h, const float* c,
                     const float* w_emb, const float* b_emb, const float* w_grid,
                     const float* b_grid, const float* w_ih, const float* w_hh,
                     const float* b_gates, const float* w_h2n, const float* b_h2n,
                     float* h_out, float* c_out, float* normal, uint8_t* mask_out,
                     int s, int a, float cell_side, float constant, void* stream) {
  // above 48 KB of shared memory only after opting in, once per device
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)FUSED_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  Scene sc{obs1, obs2, p1, p2, s * a, a, cell_side, constant};
  Weights wt{w_emb, b_emb, w_grid, b_grid, w_ih, w_hh, b_gates, w_h2n, b_h2n};
  int blocks = (sc.rows + ROWS - 1) / ROWS;
  fused_step_kernel<<<blocks, THREADS, FUSED_SMEM_BYTES, (cudaStream_t)stream>>>(
      sc, wt, h, c, h_out, c_out, normal, mask_out);
  return (int)cudaGetLastError();
}

// Compile-time widths, so the binding can check them against the model.
int dlstm_kernel_dims(int* out) {
  out[0] = N;
  out[1] = EMB;
  out[2] = POOL;
  out[3] = H;
  return 0;
}

}  // extern "C"
