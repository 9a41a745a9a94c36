// box_hits: the grasp filter's collision gate, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel catgrasp_tpu/ops/collision.py:box_hits
// (body _kernel).  For each world->grasp transform t_inv[p] and each static
// lateral +y offset a: is any valid cloud point, moved into grasp frame p,
// within `margin` of the inside of any static box shifted by a?
//
// What bounds it on an H100: operations.  Every (pose, point) pair costs a
// 3x4 transform (9 FMAs) plus the interval tests; HBM traffic is one read of
// the P transforms and one (P, A) byte write, so at the filter's shapes
// (P = 254,848 poses, C up to 4,096 points) the kernel does ~1e9 pair tests
// per launch against ~18 MB of memory traffic.  Tensor cores do not help: the
// "matmul" is 3x4 by 4xC per pose, so it stays on the f32 FMA pipes.
//
// Design, and what it does about that bound:
//  * one thread per pose keeps its 3x4 transform and an A-bit hit mask in
//    registers; nothing of size P x C is ever written;
//  * a block of 256 poses walks the cloud in 1,024-point tiles staged in
//    shared memory (12 KB), so each point is read from HBM once per block;
//  * the x/z interval tests are offset-independent and run once per box; the
//    offset loop only repeats the y test;
//  * a thread stops as soon as all A bits are set, and the block leaves the
//    cloud loop once all its threads have (common on the background cloud,
//    where most poses collide early);
//  * masked points arrive as the 1e6 sentinel (written by the wrapper), which
//    lands outside every box, so the inner loop carries no mask.
// The transform is f32 FMAs; the port holds it to the CPU f32 result.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_BOXES 4
#define MAX_OFFSETS 8
#define POSE_BLOCK 256
#define PTS_TILE 1024

struct BoxHitsArgs {
  int n_boxes;
  int n_offsets;
  float margin;
  float center[MAX_BOXES * 3];
  float half[MAX_BOXES * 3];
  float offset[MAX_OFFSETS];
};

__global__ void __launch_bounds__(POSE_BLOCK)
box_hits_kernel(const float* __restrict__ t_inv, const float* __restrict__ cloud,
                int P, int C, BoxHitsArgs a, uint8_t* __restrict__ out) {
  __shared__ float s_pts[PTS_TILE * 3];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < P;
  float r[12];
  if (live) {
    const float* T = t_inv + (size_t)p * 16;
#pragma unroll
    for (int k = 0; k < 12; ++k) r[k] = T[k];
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) r[k] = 0.f;
  }
  const unsigned full = (1u << a.n_offsets) - 1u;
  unsigned hit = 0u;

  for (int c0 = 0; c0 < C; c0 += PTS_TILE) {
    // block-uniform exit once every pose of the block has all its bits; the
    // barrier also keeps the tile below from being overwritten while in use
    if (__syncthreads_and(!live || hit == full)) break;
    const int n = min(PTS_TILE, C - c0);
    for (int k = threadIdx.x; k < n * 3; k += blockDim.x)
      s_pts[k] = cloud[(size_t)c0 * 3 + k];
    __syncthreads();
    if (!live || hit == full) continue;
    for (int j = 0; j < n; ++j) {
      const float px = s_pts[3 * j], py = s_pts[3 * j + 1], pz = s_pts[3 * j + 2];
      const float x = fmaf(r[2], pz, fmaf(r[1], py, fmaf(r[0], px, r[3])));
      const float y = fmaf(r[6], pz, fmaf(r[5], py, fmaf(r[4], px, r[7])));
      const float z = fmaf(r[10], pz, fmaf(r[9], py, fmaf(r[8], px, r[11])));
      for (int b = 0; b < a.n_boxes; ++b) {
        if (fabsf(x - a.center[3 * b]) - a.half[3 * b] < a.margin &&
            fabsf(z - a.center[3 * b + 2]) - a.half[3 * b + 2] < a.margin) {
          const float yb = y - a.center[3 * b + 1];
          for (int o = 0; o < a.n_offsets; ++o)
            if (fabsf(yb - a.offset[o]) - a.half[3 * b + 1] < a.margin) hit |= 1u << o;
        }
      }
      if (hit == full) break;
    }
  }
  if (live)
    for (int o = 0; o < a.n_offsets; ++o) out[(size_t)p * a.n_offsets + o] = (hit >> o) & 1u;
}

extern "C" int box_hits_launch(const float* t_inv, const float* cloud, int P, int C,
                               int n_boxes, const float* centers, const float* halves,
                               int n_offsets, const float* offsets, float margin,
                               uint8_t* out, void* stream) {
  if (n_boxes < 1 || n_boxes > MAX_BOXES || n_offsets < 1 || n_offsets > MAX_OFFSETS)
    return (int)cudaErrorInvalidValue;
  BoxHitsArgs a;
  a.n_boxes = n_boxes;
  a.n_offsets = n_offsets;
  a.margin = margin;
  for (int k = 0; k < n_boxes * 3; ++k) {
    a.center[k] = centers[k];
    a.half[k] = halves[k];
  }
  for (int k = n_boxes * 3; k < MAX_BOXES * 3; ++k) a.center[k] = a.half[k] = 0.f;
  for (int o = 0; o < MAX_OFFSETS; ++o) a.offset[o] = o < n_offsets ? offsets[o] : 0.f;
  if (P > 0) {
    const int grid = (P + POSE_BLOCK - 1) / POSE_BLOCK;
    box_hits_kernel<<<grid, POSE_BLOCK, 0, (cudaStream_t)stream>>>(t_inv, cloud, P, C, a, out);
  }
  return (int)cudaGetLastError();
}
