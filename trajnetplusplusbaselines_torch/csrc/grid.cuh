// What the fused step (fused_step.cu) and the grid stage alone
// (directional_grid.cu) share: the scene's inputs, the grid's geometry, the
// cell and value rules of the directional grid, and the shared-memory opt-in.
//
// Exactness of the grid: the cell index is (pos_j - pos_i) / cell_side + n/2
// with IEEE division, in that order (the __f*_rn intrinsics are never
// contracted or rewritten), so neighbours on a cell boundary land in the same
// cell as in the plain version.  Build without --use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GRID_MAX_N = 32;     // largest grid side of the grid stage alone
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

// The grid's geometry: side n and the offset added to the cell coordinates
// (n/2 on both axes, or n/2 and 0 for a grid in front of the agent).
struct Geom {
  int n;
  float half_x;
  float half_y;
};

// The cell at (ox, oy), in cells from the grid's corner, and whether the
// write is in range: both agents present at t (`visible`) and inside the
// grid.  Out of range the neighbour writes `constant` into cell 0.
__device__ __forceinline__ int cell_at(const Geom& gm, float ox, float oy, bool visible,
                                       bool* in_range) {
  const float n = (float)gm.n;
  bool ok = visible && ox >= 0.0f && ox < n && oy >= 0.0f && oy < n;
  *in_range = ok;
  // trunc equals floor here: negative values are out of range
  return ok ? (int)ox * gm.n + (int)oy : 0;
}

// The cell of neighbour j, at (xj, yj), in the grid of agent i, at (xi, yi):
// (pos_j - pos_i) / cell_side + (half_x, half_y).
__device__ __forceinline__ int grid_cell(const Geom& gm, float cell_side, float xi, float yi,
                                         float xj, float yj, bool visible, bool* in_range) {
  return cell_at(gm, __fadd_rn(__fdiv_rn(__fsub_rn(xj, xi), cell_side), gm.half_x),
                 __fadd_rn(__fdiv_rn(__fsub_rn(yj, yi), cell_side), gm.half_y), visible,
                 in_range);
}

// Where neighbour j (flat row rj) writes in the grid of agent i (flat row ri).
__device__ __forceinline__ int write_cell(const Scene& sc, const Geom& gm, int ri, int rj,
                                          bool* in_range) {
  return grid_cell(gm, sc.cell_side, sc.obs2[2 * ri], sc.obs2[2 * ri + 1], sc.obs2[2 * rj],
                   sc.obs2[2 * rj + 1], sc.p2[ri] && sc.p2[rj], in_range);
}

// An agent's velocity, obs2 - obs1.
__device__ __forceinline__ float2 velocity(float x1, float y1, float x2, float y2) {
  return make_float2(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

// Neighbour j's velocity relative to agent i's.
__device__ __forceinline__ float2 velocity_difference(float2 vi, float2 vj) {
  return make_float2(__fsub_rn(vj.x, vi.x), __fsub_rn(vj.y, vi.y));
}

// The relative velocity of neighbour rw in agent row's grid, zero unless
// both are present at t-1 and t.
__device__ __forceinline__ float2 rel_velocity(const Scene& sc, int row, int rw) {
  bool both = sc.p1[row] && sc.p2[row] && sc.p1[rw] && sc.p2[rw];
  if (!both) return make_float2(0.0f, 0.0f);
  return velocity_difference(
      velocity(sc.obs1[2 * row], sc.obs1[2 * row + 1], sc.obs2[2 * row], sc.obs2[2 * row + 1]),
      velocity(sc.obs1[2 * rw], sc.obs1[2 * rw + 1], sc.obs2[2 * rw], sc.obs2[2 * rw + 1]));
}

// Above 48 KB of dynamic shared memory only after opting in, once per device.
inline cudaError_t opt_in(const void* kernel, size_t bytes, bool* opted_in) {
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
