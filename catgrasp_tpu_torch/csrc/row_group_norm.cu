// row_group_norm: the seg head's GroupNorm + ReLU, forward and backward, over
// rows that are each their own sample, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the head's norm
// (catgrasp_tpu/nn/voxelnet.py, flax's GroupNorm on one scene's (N, 64)) to
// XLA.  It was added because torch's group norm takes its 1-d path on such
// rows (spatial size 1), whose gamma/beta backward launches ceil(C / 32) = 2
// blocks that each walk every row: 46 ms a training step at the seg net's
// 110 x 20,000 points, with separate passes around it for the affine, the
// ReLU and their backward.
//
// y = relu((x - mean) * rstd * gamma + beta) on x (M, 64) f32 in 8 groups of
// 8 channels, each (row, group) normalised alone: the mean, then the mean of
// squared deviations (biased), rstd = 1 / sqrt(var + eps), all in f32.
//
// What bounds it on an H100: bytes.  The forward reads x and writes y (512 B a
// row), the backward reads x and dy and writes dx (768 B a row): at M = 2.2 M,
// 1.13 GB and 1.69 GB, 0.34 and 0.50 ms at 3.35 TB/s.  A (row, group) needs
// only its own 8 values, so its statistics live in registers.
//
// Design, and what it does about that bound:
//  * a thread a (row, group), its 8 values two 16-byte loads; neighbouring
//    threads hold neighbouring groups, so a warp reads 4 whole rows, 1 KB in
//    one piece, and writes them back the same way;
//  * the backward saves nothing but x: it recomputes the statistics, x_hat and
//    the forward's y by the same code (rounding fixed by the _rn intrinsics),
//    so its ReLU mask is the forward's bit for bit;
//  * dgamma and dbeta sum over all rows: a grid of as many blocks as the card
//    holds at once strides over the rows, each thread keeping one group for
//    the whole walk, its sums in registers; the block reduces them in a fixed
//    order into one column of partials, and a second kernel sums each
//    partial row over the blocks in a fixed order.  No atomics: two calls on
//    the same inputs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHANNELS 64
#define GROUPS 8
#define CPG 8  // channels a group
#define THREADS 256
#define WARPS (THREADS / 32)
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ void load8(const float* __restrict__ p, long long item, float v[CPG]) {
  const float4* q = reinterpret_cast<const float4*>(p) + 2 * item;
  const float4 a = __ldg(q), b = __ldg(q + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* __restrict__ p, long long item, const float v[CPG]) {
  float4* q = reinterpret_cast<float4*>(p) + 2 * item;
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The group's mean and 1 / sqrt(biased variance + eps), two passes in f32.
__device__ __forceinline__ void moments(const float v[CPG], float eps, float& mean, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CPG; ++k) s = __fadd_rn(s, v[k]);
  mean = __fmul_rn(s, 1.f / CPG);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < CPG; ++k) {
    const float d = __fsub_rn(v[k], mean);
    ss = __fmaf_rn(d, d, ss);
  }
  rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(ss, 1.f / CPG), eps)));
}

// x_hat and the affine output before the ReLU, the one expression both
// kernels use.
__device__ __forceinline__ float affine(float x, float mean, float rstd, float gamma, float beta,
                                        float& x_hat) {
  x_hat = __fmul_rn(__fsub_rn(x, mean), rstd);
  return __fmaf_rn(x_hat, gamma, beta);
}

__global__ void __launch_bounds__(THREADS)
row_gn_fwd(const float* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, float eps, long long items, float* __restrict__ y) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= items) return;
  const int c0 = (int)(i % GROUPS) * CPG;
  float v[CPG], gam[CPG], bet[CPG], o[CPG];
  load8(x, i, v);
  load8(gamma + c0, 0, gam);
  load8(beta + c0, 0, bet);
  float mean, rstd;
  moments(v, eps, mean, rstd);
#pragma unroll
  for (int k = 0; k < CPG; ++k) {
    float x_hat;
    const float a = affine(v[k], mean, rstd, gam[k], bet[k], x_hat);
    o[k] = a <= 0.f ? 0.f : a;  // torch's relu: NaN passes
  }
  store8(y, i, o);
}

// dx for every (row, group); per block, sum_rows(g x_hat) and sum_rows(g) a
// channel into partials[(which * CHANNELS + c) * n_blocks + block], which 0
// for dgamma and 1 for dbeta.  g = dy where the forward's y > 0.
__global__ void __launch_bounds__(THREADS)
row_gn_bwd(const float* __restrict__ x, const float* __restrict__ dy,
           const float* __restrict__ gamma, const float* __restrict__ beta, float eps,
           long long items, float* __restrict__ dx, float* __restrict__ partials) {
  __shared__ float s_sum[WARPS][GROUPS][2 * CPG];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = threadIdx.x % GROUPS;  // fixed: the block and the stride are whole rows
  float gam[CPG], bet[CPG], dgam[CPG], dbet[CPG];
  load8(gamma + grp * CPG, 0, gam);
  load8(beta + grp * CPG, 0, bet);
#pragma unroll
  for (int k = 0; k < CPG; ++k) dgam[k] = dbet[k] = 0.f;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < items; i += stride) {
    float v[CPG], d[CPG], xh[CPG], gg[CPG];
    load8(x, i, v);
    load8(dy, i, d);
    float mean, rstd;
    moments(v, eps, mean, rstd);
    float sum_gg = 0.f, sum_ggx = 0.f;
#pragma unroll
    for (int k = 0; k < CPG; ++k) {
      const float a = affine(v[k], mean, rstd, gam[k], bet[k], xh[k]);
      const float g = a <= 0.f ? 0.f : d[k];  // torch's threshold_backward
      dbet[k] = __fadd_rn(dbet[k], g);
      dgam[k] = __fmaf_rn(g, xh[k], dgam[k]);
      gg[k] = __fmul_rn(g, gam[k]);
      sum_gg = __fadd_rn(sum_gg, gg[k]);
      sum_ggx = __fmaf_rn(gg[k], xh[k], sum_ggx);
    }
    const float mean_gg = __fmul_rn(sum_gg, 1.f / CPG), mean_ggx = __fmul_rn(sum_ggx, 1.f / CPG);
#pragma unroll
    for (int k = 0; k < CPG; ++k)
      d[k] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(gg[k], mean_gg), __fmul_rn(xh[k], mean_ggx)));
    store8(dx, i, d);
  }
  // lanes l, l + 8, l + 16, l + 24 hold the same group
#pragma unroll
  for (int k = 0; k < CPG; ++k) {
#pragma unroll
    for (int off = GROUPS; off < 32; off <<= 1) {
      dgam[k] = __fadd_rn(dgam[k], __shfl_xor_sync(FULL_MASK, dgam[k], off));
      dbet[k] = __fadd_rn(dbet[k], __shfl_xor_sync(FULL_MASK, dbet[k], off));
    }
  }
  if (lane < GROUPS) {
#pragma unroll
    for (int k = 0; k < CPG; ++k) {
      s_sum[warp][lane][k] = dgam[k];
      s_sum[warp][lane][CPG + k] = dbet[k];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * CHANNELS) {
    const int which = threadIdx.x / CHANNELS, c = threadIdx.x % CHANNELS;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, s_sum[w][c / CPG][which * CPG + c % CPG]);
    partials[(long long)threadIdx.x * gridDim.x + blockIdx.x] = s;
  }
}

// The sum of partials[r, :n_blocks] for the 2 * CHANNELS rows r, into dgamma
// (r < CHANNELS) and dbeta; one warp a row: lanes stride over the blocks,
// then a butterfly.
__global__ void __launch_bounds__(THREADS)
row_gn_sum_partials(const float* __restrict__ partials, int n_blocks,
                    float* __restrict__ dgamma, float* __restrict__ dbeta) {
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= 2 * CHANNELS) return;  // uniform over the warp
  const float* p = partials + (long long)r * n_blocks;
  float s = 0.f;
  for (int b = lane; b < n_blocks; b += 32) s = __fadd_rn(s, p[b]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(FULL_MASK, s, off));
  if (lane == 0) (r < CHANNELS ? dgamma : dbeta)[r % CHANNELS] = s;
}

// How many blocks of the backward one SM holds at once; 0 on success.
extern "C" int row_group_norm_bwd_blocks_per_sm(int* n) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, row_gn_bwd, THREADS, 0);
}

// x, y (M, 64) f32, gamma, beta (64,), all 16-byte aligned.
extern "C" int row_group_norm_fwd_launch(const float* x, const float* gamma, const float* beta,
                                         float eps, long long rows, float* y, void* stream) {
  const long long items = rows * GROUPS;
  if (items <= 0) return (int)cudaErrorInvalidValue;
  const long long grid = (items + THREADS - 1) / THREADS;
  row_gn_fwd<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(x, gamma, beta, eps, items, y);
  return (int)cudaGetLastError();
}

// x, dy, dx (M, 64) f32; partials (2, 64, n_blocks) f32 scratch; dgamma,
// dbeta (64,) f32.  Two launches: the rows, then the sums.
extern "C" int row_group_norm_bwd_launch(const float* x, const float* dy, const float* gamma,
                                         const float* beta, float eps, long long rows,
                                         int n_blocks, float* dx, float* partials,
                                         float* dgamma, float* dbeta, void* stream) {
  const long long items = rows * GROUPS;
  if (items <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  row_gn_bwd<<<n_blocks, THREADS, 0, s>>>(x, dy, gamma, beta, eps, items, dx, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_gn_sum_partials<<<(2 * CHANNELS + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      partials, n_blocks, dgamma, dbeta);
  return (int)cudaGetLastError();
}
