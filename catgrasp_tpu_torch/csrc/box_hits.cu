// box_hits: the grasp filter's collision gate, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel catgrasp_tpu/ops/collision.py:box_hits
// (body _kernel).  For each world->grasp transform t_inv[p], each approach
// depth d (a +x shift of the boxes) and each lateral +y offset a: is any valid
// cloud point, moved into grasp frame p, within `margin` of the inside of any
// static box shifted by (d, a)?  The TPU kernel answers one depth a call; a
// depth is to x what an offset is to y, so here one launch answers all D
// depths from one transform of the cloud and returns (P, D, A).
//
// What bounds it on an H100: operations.  Every (pose, point) pair costs a
// 3x4 transform (9 FMAs) plus the interval tests; HBM traffic is one read of
// the P transforms and one (P, D, A) byte write, so at the filter's shapes
// (P = 254,848 poses, C up to 4,096 points) a launch does ~1e9 pair tests
// against ~25 MB of memory traffic.  Tensor cores do not help: the "matmul"
// is 3x4 by 4xC per pose, so it stays on the f32 FMA pipes.  A pose needs its
// points only until all D x A bits are set, so the work depends on the data,
// and what a design loses is lanes that idle while a neighbour still works.
//
// Design, and what it does about that bound:
//  * counts known at compile time: the kernel is instantiated for the
//    (boxes, offsets, depths) the port uses (1 or 3; 1 or 7; 1 or 4).  The
//    boxes travel as a __grid_constant__ struct, so after unrolling every
//    centre and half extent is a constant-bank operand of its instruction.
//    Any other counts (up to 4 boxes, 8 offsets, 4 depths: the domain of the
//    TPU kernel's wrapper) take one more instantiation, <0, 0, 0>, whose
//    loops read their counts from the struct;
//  * a point is rejected cheaply: per box one z interval, one y interval
//    widened by the largest offset and one x interval widened over the
//    depths (each widened by 1e-5 m, far over the f32 rounding of the exact
//    tests), as three predicates and one branch.  Only a point that passes
//    runs the exact per-offset y tests and per-depth x tests, which are the
//    single-depth kernel's expressions unchanged, so results do not move;
//  * points on the lanes: a warp owns 32 poses (their transforms parked in
//    shared memory, each lane keeping its own pose's D x A bit mask) and walks
//    the cloud in chunks of 128 points, 4 a lane, read as one 16-byte load
//    each (points are padded to 4 floats and to whole chunks by the wrapper).
//    For every pose still unfinished the 32 lanes transform and test their 4
//    points, one __reduce_or_sync gathers the bits, and a ballot rebuilds the
//    list of unfinished poses after each chunk.  Every lane works as long as
//    the warp has a pose left, whatever the poses' exits; a pose wastes at
//    most one chunk past its last needed point.  No block barrier;
//  * masked points and the padding carry the 1e6 sentinel, which lands
//    outside every box, so the inner loop has no mask.
// The transform is the same chain of f32 FMAs as before; the port holds it to
// the CPU f32 result.
//
// Tried and dropped:
//  * one thread a pose with the block's unfinished poses compacted between
//    256-point tiles (ballot + prefix sum, warps past the live count leave):
//    on an H100 at 700 W it took 0.8479 ms against this design's 0.5523 ms for
//    one filter call's gate on the eval's inputs, and 0.3883 against
//    0.3317 ms at the entry point's shapes;
//  * tiles of 1,024 points with a block-wide exit only (the earlier design:
//    lanes idled behind the slowest pose of their warp).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_BOXES 4
#define MAX_OFFSETS 8
#define MAX_DEPTHS 4  // MAX_DEPTHS * MAX_OFFSETS bits fill the 32-bit mask
#define FULL_MASK 0xffffffffu
#define WIDEN 1e-5f  // added to the widened intervals of the cheap rejection

#define WARPS 4  // warps a block, each with its own 32 poses
#define PTS_PER_LANE 4
#define CHUNK (32 * PTS_PER_LANE)

struct BoxArgs {
  int n_boxes, n_offsets, n_depths;  // read by the <0, 0, 0> instantiation only
  float margin;
  float cx[MAX_DEPTHS][MAX_BOXES];  // box centre x at each depth
  float cy[MAX_BOXES], cz[MAX_BOXES];
  float hx[MAX_BOXES], hy[MAX_BOXES], hz[MAX_BOXES];
  float x_mid[MAX_BOXES], x_reach[MAX_BOXES];  // x interval widened over the depths
  float y_reach[MAX_BOXES];                    // y half extent widened by the largest offset
  float off[MAX_OFFSETS];
};

// The D x A bits (bit d * A + a) that one grasp-frame point sets.  Template
// counts of 0 stand for the counts in the struct.
template <int K0, int A0, int D0>
__device__ __forceinline__ unsigned point_bits(float x, float y, float z, const BoxArgs& a) {
  const int K = K0 ? K0 : a.n_boxes, A = A0 ? A0 : a.n_offsets, D = D0 ? D0 : a.n_depths;
  unsigned m = 0u;
#pragma unroll
  for (int b = 0; b < K; ++b) {
    const float yb = y - a.cy[b];
    const bool near = (fabsf(z - a.cz[b]) - a.hz[b] < a.margin)
                      & (fabsf(yb) - a.y_reach[b] < a.margin)
                      & (fabsf(x - a.x_mid[b]) - a.x_reach[b] < a.margin);
    if (near) {
      unsigned ym = 0u;
#pragma unroll
      for (int o = 0; o < A; ++o)
        if (fabsf(yb - a.off[o]) - a.hy[b] < a.margin) ym |= 1u << o;
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (fabsf(x - a.cx[d][b]) - a.hx[b] < a.margin) m |= ym << (d * A);
    }
  }
  return m;
}

template <int K, int A, int D>
__device__ __forceinline__ unsigned pose_point_bits(const float4& r0, const float4& r1,
                                                    const float4& r2, const float4& q,
                                                    const BoxArgs& a) {
  const float x = fmaf(r0.z, q.z, fmaf(r0.y, q.y, fmaf(r0.x, q.x, r0.w)));
  const float y = fmaf(r1.z, q.z, fmaf(r1.y, q.y, fmaf(r1.x, q.x, r1.w)));
  const float z = fmaf(r2.z, q.z, fmaf(r2.y, q.y, fmaf(r2.x, q.x, r2.w)));
  return point_bits<K, A, D>(x, y, z, a);
}

template <int K, int A, int D>
__global__ void __launch_bounds__(WARPS * 32)
box_hits_kernel(const float4* __restrict__ t_inv, const float4* __restrict__ pts, int P,
                int C, const __grid_constant__ BoxArgs a, uint8_t* __restrict__ out) {
  __shared__ float4 s_t[WARPS][32][3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = (blockIdx.x * WARPS + warp) * 32 + lane;
  const int n_bits = K ? D * A : a.n_depths * a.n_offsets;
  const unsigned full = FULL_MASK >> (32 - n_bits);
  if (p < P) {
#pragma unroll
    for (int r = 0; r < 3; ++r) s_t[warp][lane][r] = t_inv[(size_t)p * 4 + r];
  }
  __syncwarp();
  unsigned hit = 0u;
  unsigned live = __ballot_sync(FULL_MASK, p < P);
  for (int c0 = 0; c0 < C && live; c0 += CHUNK) {
    float4 q[PTS_PER_LANE];
#pragma unroll
    for (int i = 0; i < PTS_PER_LANE; ++i) q[i] = pts[c0 + i * 32 + lane];
    for (unsigned m = live; m; m &= m - 1u) {  // uniform over the warp
      const int k = __ffs(m) - 1;
      const float4 r0 = s_t[warp][k][0], r1 = s_t[warp][k][1], r2 = s_t[warp][k][2];
      unsigned bits = 0u;
#pragma unroll
      for (int i = 0; i < PTS_PER_LANE; ++i) bits |= pose_point_bits<K, A, D>(r0, r1, r2, q[i], a);
      bits = __reduce_or_sync(FULL_MASK, bits);
      if (lane == k) hit |= bits;
    }
    live = __ballot_sync(FULL_MASK, p < P && hit != full);
  }
  if (p < P) {
    uint8_t* o = out + (size_t)p * n_bits;
#pragma unroll
    for (int k = 0; k < n_bits; ++k) o[k] = (hit >> k) & 1u;
  }
}

// t_inv (P, 4, 4) f32; pts (C, 4) f32 with C a multiple of 128, masked points
// and padding at the sentinel; centers, halves (n_boxes, 3) at depth 0;
// centers_x (n_depths, n_boxes): the boxes' centre x at each depth;
// out (P, n_depths, n_offsets) bytes.  Host pointers for the small tables.
extern "C" int box_hits_launch(const float* t_inv, const float* pts, int P, int C, int n_boxes,
                               const float* centers, const float* halves, int n_offsets,
                               const float* offsets, int n_depths, const float* centers_x,
                               float margin, uint8_t* out, void* stream) {
  if (n_boxes < 1 || n_boxes > MAX_BOXES || n_offsets < 1 || n_offsets > MAX_OFFSETS
      || n_depths < 1 || n_depths > MAX_DEPTHS || C % CHUNK != 0)
    return (int)cudaErrorInvalidValue;
  BoxArgs a = {};
  a.n_boxes = n_boxes;
  a.n_offsets = n_offsets;
  a.n_depths = n_depths;
  a.margin = margin;
  float reach_y = 0.f;
  for (int o = 0; o < n_offsets; ++o) {
    a.off[o] = offsets[o];
    reach_y = fmaxf(reach_y, fabsf(offsets[o]));
  }
  for (int b = 0; b < n_boxes; ++b) {
    a.cy[b] = centers[3 * b + 1];
    a.cz[b] = centers[3 * b + 2];
    a.hx[b] = halves[3 * b];
    a.hy[b] = halves[3 * b + 1];
    a.hz[b] = halves[3 * b + 2];
    float lo = centers_x[b], hi = centers_x[b];
    for (int d = 0; d < n_depths; ++d) {
      a.cx[d][b] = centers_x[d * n_boxes + b];
      lo = fminf(lo, a.cx[d][b]);
      hi = fmaxf(hi, a.cx[d][b]);
    }
    a.x_mid[b] = 0.5f * (lo + hi);
    a.x_reach[b] = a.hx[b] + 0.5f * (hi - lo) + WIDEN;
    a.y_reach[b] = a.hy[b] + reach_y + WIDEN;
  }
  if (P > 0) {
    const float4* t4 = reinterpret_cast<const float4*>(t_inv);
    const float4* p4 = reinterpret_cast<const float4*>(pts);
    const int grid = (P + WARPS * 32 - 1) / (WARPS * 32);
    cudaStream_t s = (cudaStream_t)stream;
    bool launched = false;
#define VARIANT(K, A, D)                                                              \
  if (n_boxes == K && n_offsets == A && n_depths == D) {                              \
    box_hits_kernel<K, A, D><<<grid, WARPS * 32, 0, s>>>(t4, p4, P, C, a, out);       \
    launched = true;                                                                  \
  }
    VARIANT(1, 1, 1) VARIANT(1, 1, 4) VARIANT(1, 7, 1) VARIANT(1, 7, 4)
    VARIANT(3, 1, 1) VARIANT(3, 1, 4) VARIANT(3, 7, 1) VARIANT(3, 7, 4)
#undef VARIANT
    if (!launched) box_hits_kernel<0, 0, 0><<<grid, WARPS * 32, 0, s>>>(t4, p4, P, C, a, out);
  }
  return (int)cudaGetLastError();
}
