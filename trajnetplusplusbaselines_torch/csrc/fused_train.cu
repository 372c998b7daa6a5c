// The elementwise work of the flagship's train step, for Hopper (sm_90a):
// six kernels behind ops/cuda/fused_train.py's FusedTrainRollout (the
// teacher-forced rollout under autograd; its gate, dh and weight-gradient
// products run by torch.mm, the grid embedding's in fused_train_in) and
// FusedPredictionLoss (the trainer's loss).
//
// Replaces no TPU kernel.  The JAX package differentiates its rollout with
// jax.grad, and XLA fuses each step's elementwise ops; under PyTorch's
// autograd the same work was ~100 kernels a step forward and backward, each
// at launch scale at batch 8 (64 rows), so a train step's time was their
// number.  These kernels do a step's elementwise work in at most two
// launches forward (the encoder's input rows take one launch for all its
// steps) and one backward, plus one launch a rollout:
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
// - fused_train_cell_kernel (once a step): the LSTM cell from the gates'
//   pre-activations (bias included), the masked update of h and c,
//   Hidden2Normal ([H] x [H, 5] a row, a warp reducing it in a fixed order),
//   its head (0.01 + 0.2 sigmoid, 0.7 sigmoid), the masked normal, the
//   output position and, on the decoder's teacher-forcing chain, the
//   primary's own position and validity.  A block per row, a thread per
//   unit.
// - fused_train_cell_backward_kernel (once a step): the same step backward
//   from the step's gradients of rel_pred and pred and the carried dh, dc:
//   the gates' gradient, the raw head's (Hidden2Normal's backward, the
//   product with W_h2n^T per unit), the carried dh where the agent is
//   absent and dc.  A block per row, a thread per unit.
// - fused_train_in_backward_kernel (once a rollout): both relu masks on the
//   gradient of every step's x, in place.  A thread per element.
// - fused_train_loss_kernel and fused_train_loss_backward_kernel (once a
//   train step each): the trainer's mixture NLL of the primaries' last 12
//   normals (losses.prediction_loss: ~70 small ops forward and ~170
//   backward under autograd), its masked mean in one block, its gradient
//   with respect to the whole rel_pred written in one pass.
//
// What bounds them: bytes.  A cell kernel reads the gates and c and writes
// h, c, the activations and tanh(c) (~48 H bytes a row: ~6 KB at H = 128);
// a handful of operations per byte.  At the train step's 64 rows that is
// ~0.4 MB, 0.12 us at 3.35 TB/s, far under a launch's own ~2 us: at that
// size each kernel costs a launch, so the design cuts launches (~100 a step
// and ~240 a loss), not bytes.  fused_train_in's bytes are its rows of
// the grid and of xh and the rows of W_grid that the occupied cells name
// (1 KB each at P = 256): ~0.2-0.4 MB at 64 rows.  No atomics: every sum
// runs in a fixed order, so two runs, and a CUDA graph replay and an eager
// step, give the same bits.  Widths (embedding, grid, pool, hidden) come
// at run time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ELEMENT_THREADS = 256;
constexpr int ROW_THREADS = 128;  // a cell kernel's block: one row, its units strided
constexpr int MAX_BLOCKS = 4096;  // a grid-stride kernel's blocks at most
constexpr int LOSS_THREADS = 256;  // the loss's one block (a power of two)
constexpr float TWO_PI = 6.283185307179586f;

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float relu(float x) { return x > 0.f ? x : 0.f; }

int element_blocks(long total) {
  long blocks = (total + ELEMENT_THREADS - 1) / ELEMENT_THREADS;
  return static_cast<int>(blocks < MAX_BLOCKS ? (blocks > 0 ? blocks : 1) : MAX_BLOCKS);
}

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

__global__ void fused_train_cell_kernel(
    const float* __restrict__ gates, const float* __restrict__ xh, const float* __restrict__ c,
    const uint8_t* __restrict__ mask, const float* __restrict__ obs2,
    const float* __restrict__ w_h2n, const float* __restrict__ b_h2n,
    float* __restrict__ xh_next, float* __restrict__ c_next, float* __restrict__ act,
    float* __restrict__ tc, float* __restrict__ sig, float* __restrict__ rel,
    float* __restrict__ pred, float* __restrict__ chain_xy, uint8_t* __restrict__ chain_mask,
    int agents, int hidden, int ld) {
  extern __shared__ float h_new[];  // [hidden]: h' of this row, for Hidden2Normal
  const int r = blockIdx.x, x_width = ld - hidden - 1;
  const bool m = mask[r];
  const float* g_row = gates + static_cast<long>(r) * 4 * hidden;
  const float* h_row = xh + static_cast<long>(r) * ld + x_width;
  float* h_out = xh_next + static_cast<long>(r) * ld + x_width;
  float* a_row = act + static_cast<long>(r) * 4 * hidden;
  const long at = static_cast<long>(r) * hidden;
  for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
    const float si = sigmoidf(g_row[j]), sf = sigmoidf(g_row[hidden + j]);
    const float tg = tanhf(g_row[2 * hidden + j]), so = sigmoidf(g_row[3 * hidden + j]);
    const float c_old = c[at + j];
    const float cn = sf * c_old + si * tg;
    const float t = tanhf(cn);
    const float hn = so * t;
    h_new[j] = hn;
    h_out[j] = m ? hn : h_row[j];
    c_next[at + j] = m ? cn : c_old;
    a_row[j] = si;
    a_row[hidden + j] = sf;
    a_row[2 * hidden + j] = tg;
    a_row[3 * hidden + j] = so;
    tc[at + j] = t;
  }
  if (threadIdx.x == 0) h_out[hidden] = 1.f;  // the ones column
  __syncthreads();
  if (threadIdx.x >= 32) return;
  // Hidden2Normal: warp 0, lane l summing units l, l + 32, ..., then a
  // butterfly over the lanes (the same order on every run)
  const int lane = threadIdx.x;
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = lane; j < hidden; j += 32) {
    const float h = h_new[j];
#pragma unroll
    for (int k = 0; k < 5; ++k) acc[k] = fmaf(h, w_h2n[5 * j + k], acc[k]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 5; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
  if (lane != 0) return;
  const float fm = m ? 1.f : 0.f;
  float s[3], normal[5];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = sigmoidf(acc[2 + k] + b_h2n[2 + k]);
  normal[0] = (acc[0] + b_h2n[0]) * fm;
  normal[1] = (acc[1] + b_h2n[1]) * fm;
  normal[2] = (0.01f + 0.2f * s[0]) * fm;
  normal[3] = (0.01f + 0.2f * s[1]) * fm;
  normal[4] = (0.7f * s[2]) * fm;
#pragma unroll
  for (int k = 0; k < 5; ++k) rel[5 * r + k] = normal[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) sig[3 * r + k] = s[k];
  const float px = (obs2[2 * r] + normal[0]) * fm, py = (obs2[2 * r + 1] + normal[1]) * fm;
  pred[2 * r] = px;
  pred[2 * r + 1] = py;
  if (chain_xy != nullptr && r % agents == 0) {  // the primary's lane two steps on
    chain_xy[2 * r] = px;
    chain_xy[2 * r + 1] = py;
    chain_mask[r] = m;
  }
}

__global__ void fused_train_cell_backward_kernel(
    const float* __restrict__ d_rel, const float* __restrict__ d_pred,
    const uint8_t* __restrict__ mask, const float* __restrict__ sig,
    const float* __restrict__ act, const float* __restrict__ tc, const float* __restrict__ c,
    const float* __restrict__ w_h2n, const float* __restrict__ dh_gemm, float* __restrict__ dh,
    float* __restrict__ dc, float* __restrict__ dg, float* __restrict__ draw, int hidden) {
  const int r = blockIdx.x;
  const bool m = mask[r];
  const float fm = m ? 1.f : 0.f;
  // the raw head's gradient, 5 values a row, made by every thread
  float dn[5], dr[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) dn[k] = d_rel[5 * r + k];
  if (d_pred != nullptr) {
    dn[0] += d_pred[2 * r] * fm;
    dn[1] += d_pred[2 * r + 1] * fm;
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) dn[k] *= fm;
  const float s0 = sig[3 * r], s1 = sig[3 * r + 1], s2 = sig[3 * r + 2];
  dr[0] = dn[0];
  dr[1] = dn[1];
  dr[2] = dn[2] * 0.2f * s0 * (1.f - s0);
  dr[3] = dn[3] * 0.2f * s1 * (1.f - s1);
  dr[4] = dn[4] * 0.7f * s2 * (1.f - s2);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 5; ++k) draw[5 * r + k] = dr[k];
  }
  const long at = static_cast<long>(r) * hidden;
  const float* a_row = act + 4 * at;
  float* g_row = dg + 4 * at;
  for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
    const float dh_in = dh_gemm != nullptr ? dh[at + j] + dh_gemm[at + j] : dh[at + j];
    if (!m) {  // h and c kept: the carried gradients pass, the gates get none
      g_row[j] = g_row[hidden + j] = g_row[2 * hidden + j] = g_row[3 * hidden + j] = 0.f;
      dh[at + j] = dh_in;
      continue;
    }
    float dhn = dh_in;
#pragma unroll
    for (int k = 0; k < 5; ++k) dhn = fmaf(dr[k], w_h2n[5 * j + k], dhn);
    const float si = a_row[j], sf = a_row[hidden + j], tg = a_row[2 * hidden + j];
    const float so = a_row[3 * hidden + j], t = tc[at + j];
    const float dcn = dc[at + j] + dhn * so * (1.f - t * t);
    g_row[j] = dcn * tg * si * (1.f - si);
    g_row[hidden + j] = dcn * c[at + j] * sf * (1.f - sf);
    g_row[2 * hidden + j] = dcn * si * (1.f - tg * tg);
    g_row[3 * hidden + j] = dhn * t * so * (1.f - so);
    dc[at + j] = dcn * sf;
    dh[at + j] = 0.f;
  }
}

__global__ void fused_train_in_backward_kernel(float* __restrict__ dx,
                                               const float* __restrict__ xh, int n, int width,
                                               int ld) {
  const long total = static_cast<long>(n) * width;
  for (long idx = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<long>(gridDim.x) * blockDim.x) {
    const long r = idx / width;
    if (!(xh[r * ld + idx % width] > 0.f)) dx[idx] = 0.f;
  }
}

// The mixture NLL -log(0.01 + 0.2 N(mu, 3) + 0.79 N(mu, sigma, rho)) of one
// entry (in: mu1, mu2, s1, s2, rho) at (x, y), and its gradient.
__device__ void nll_and_grad(const float in[5], float x, float y, float* value, float d[5]) {
  const float mu1 = in[0], mu2 = in[1], s1 = in[2], s2 = in[3], rho = in[4];
  const float n1 = x - mu1, n2 = y - mu2;
  const float g_bg = expf(-((n1 / 3.f) * (n1 / 3.f) + (n2 / 3.f) * (n2 / 3.f)) / 2.f) /
                     (TWO_PI * 9.f);
  const float a = n1 / s1, b = n2 / s2, q = 1.f - rho * rho;
  const float z = a * a + b * b - 2.f * rho * n1 * n2 / (s1 * s2);
  const float g = expf(-z / (2.f * q)) / (TWO_PI * s1 * s2 * sqrtf(q));
  const float density = 0.01f + 0.2f * g_bg + 0.79f * g;
  const float c_bg = -0.2f * g_bg / density, c = -0.79f * g / density;
  *value = -logf(density);
  d[0] = c_bg * n1 / 9.f + c * (a - rho * b) / (s1 * q);
  d[1] = c_bg * n2 / 9.f + c * (b - rho * a) / (s2 * q);
  d[2] = c * (a * (a - rho * b) / q - 1.f) / s1;
  d[3] = c * (b * (b - rho * a) / q - 1.f) / s2;
  d[4] = c * (a * b / q - rho * z / (q * q) + rho / q);
}

// One block: entry e = (t, s) of the primaries' last p steps, strided over
// the threads; each writes its gradient, then a tree over the threads in a
// fixed order sums the values and the count.  A masked scene reads the unit
// normal at the origin and contributes nothing.
__global__ void fused_train_loss_kernel(const float* __restrict__ rel,
                                        const float* __restrict__ targets,
                                        const uint8_t* __restrict__ scene_mask,
                                        float* __restrict__ loss, float* __restrict__ count,
                                        float* __restrict__ dvals, int t_all, int p, int s,
                                        int a) {
  __shared__ float sums[LOSS_THREADS], counts[LOSS_THREADS];
  float sum = 0.f, n = 0.f;
  for (int e = threadIdx.x; e < p * s; e += blockDim.x) {
    const int t = e / s, sc = e % s;
    const bool m = scene_mask[sc];
    float in[5] = {0.f, 0.f, 1.f, 1.f, 0.f}, x = 0.f, y = 0.f, value, d[5];
    if (m) {
      const float* r = rel + ((static_cast<long>(t_all - p + t) * s + sc) * a) * 5;
#pragma unroll
      for (int k = 0; k < 5; ++k) in[k] = r[k];
      x = targets[2 * e];
      y = targets[2 * e + 1];
    }
    nll_and_grad(in, x, y, &value, d);
#pragma unroll
    for (int k = 0; k < 5; ++k) dvals[5 * e + k] = m ? d[k] : 0.f;
    if (m) {
      sum += value;
      n += 1.f;
    }
  }
  sums[threadIdx.x] = sum;
  counts[threadIdx.x] = n;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      sums[threadIdx.x] += sums[threadIdx.x + half];
      counts[threadIdx.x] += counts[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *count = counts[0];
    *loss = sums[0] / fmaxf(counts[0], 1.f);
  }
}

// d_rel [t_all, s, a, 5]: d_loss / max(count, 1) times dvals at the
// primaries' last p steps, zero elsewhere.
__global__ void fused_train_loss_backward_kernel(const float* __restrict__ d_loss,
                                                 const float* __restrict__ dvals,
                                                 const float* __restrict__ count,
                                                 float* __restrict__ d_rel, int t_all, int p,
                                                 int s, int a) {
  const float scale = *d_loss / fmaxf(*count, 1.f);
  const long total = static_cast<long>(t_all) * s * a * 5;
  for (long idx = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<long>(gridDim.x) * blockDim.x) {
    const long row = idx / 5;
    const int agent = static_cast<int>(row % a), sc = static_cast<int>((row / a) % s);
    const int t = static_cast<int>(row / (static_cast<long>(a) * s)) - (t_all - p);
    d_rel[idx] = agent == 0 && t >= 0 ? dvals[5 * (static_cast<long>(t) * s + sc) + idx % 5] *
                                            scale
                                      : 0.f;
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

// gates, act [rows, 4 hidden]; xh, xh_next [rows, ld], h at ld - hidden - 1;
// c, c_next, tc [rows, hidden]; mask [rows]; obs2, pred [rows, 2]; w_h2n
// [hidden, 5]; b_h2n [5]; sig [rows, 3]; rel [rows, 5]; chain_xy [rows, 2]
// and chain_mask [rows] (the primary every `agents` rows) or null.
int dlstm_train_cell(const float* gates, const float* xh, const float* c, const uint8_t* mask,
                     const float* obs2, const float* w_h2n, const float* b_h2n, float* xh_next,
                     float* c_next, float* act, float* tc, float* sig, float* rel, float* pred,
                     float* chain_xy, uint8_t* chain_mask, int rows, int agents, int hidden,
                     int ld, void* stream) {
  fused_train_cell_kernel<<<rows, ROW_THREADS, hidden * sizeof(float),
                            static_cast<cudaStream_t>(stream)>>>(
      gates, xh, c, mask, obs2, w_h2n, b_h2n, xh_next, c_next, act, tc, sig, rel, pred,
      chain_xy, chain_mask, agents, hidden, ld);
  return static_cast<int>(cudaGetLastError());
}

// d_rel, draw [rows, 5]; d_pred [rows, 2] or null; mask [rows]; sig [rows,
// 3]; act, dg [rows, 4 hidden]; tc, c, dh, dc [rows, hidden]; dh_gemm
// [rows, hidden] or null; w_h2n [hidden, 5].  dh and dc updated in place.
int dlstm_train_cell_backward(const float* d_rel, const float* d_pred, const uint8_t* mask,
                              const float* sig, const float* act, const float* tc,
                              const float* c, const float* w_h2n, const float* dh_gemm,
                              float* dh, float* dc, float* dg, float* draw, int rows,
                              int hidden, void* stream) {
  fused_train_cell_backward_kernel<<<rows, ROW_THREADS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      d_rel, d_pred, mask, sig, act, tc, c, w_h2n, dh_gemm, dh, dc, dg, draw, hidden);
  return static_cast<int>(cudaGetLastError());
}

// dx [n, width] in place; xh [n, ld], ld >= width.
int dlstm_train_in_backward(float* dx, const float* xh, int n, int width, int ld,
                            void* stream) {
  fused_train_in_backward_kernel<<<element_blocks(static_cast<long>(n) * width),
                                   ELEMENT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      dx, xh, n, width, ld);
  return static_cast<int>(cudaGetLastError());
}

// rel [t_all, s, a, 5]; targets [p, s, 2]; scene_mask [s]; loss, count
// one float each; dvals [p, s, 5].
int dlstm_train_loss(const float* rel, const float* targets, const uint8_t* scene_mask,
                     float* loss, float* count, float* dvals, int t_all, int p, int s, int a,
                     void* stream) {
  fused_train_loss_kernel<<<1, LOSS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rel, targets, scene_mask, loss, count, dvals, t_all, p, s, a);
  return static_cast<int>(cudaGetLastError());
}

// d_loss, count one float each; dvals [p, s, 5]; d_rel [t_all, s, a, 5].
int dlstm_train_loss_backward(const float* d_loss, const float* dvals, const float* count,
                              float* d_rel, int t_all, int p, int s, int a, void* stream) {
  fused_train_loss_backward_kernel<<<element_blocks(static_cast<long>(t_all) * s * a * 5),
                                     ELEMENT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      d_loss, dvals, count, d_rel, t_all, p, s, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
