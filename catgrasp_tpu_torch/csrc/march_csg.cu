// march_csg: the renderer's sphere-trace loop, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel catgrasp_tpu/ops/render_march.py:march_csg
// (body _march_kernel).  Per ray, from the camera origin along d_w: start at
// t = 0.05, take at most n_steps steps of max(phi, hit_eps/2), stop when
// phi < hit_eps or t >= tmax.  phi is the min over the tile's visible bodies
// of scale * CSG distance (<= 4 slots of box, z-cylinder or z-hex-prism,
// combined by union or subtraction) and over the enabled env boxes.
//
// What bounds it on an H100: operations.  The inputs are ~16 bytes a ray and
// the output 4, so 196,608 rays move ~4 MB; the work is up to 64 steps x
// (bodies x ~4 slot SDFs + env boxes), all f32 ALU work with square roots,
// and no matrix product that tensor cores could take.
//
// Design, and what it does about that bound:
//  * one thread per ray loops over its steps with t in a register; a ray
//    that has converged leaves its loop (no tile-wide exit is needed: the
//    warp scheduler retires finished threads);
//  * the conservative cone-versus-bounding-sphere cull runs in PyTorch before
//    the launch, per 256-ray tile (one block), and hands the block a
//    compacted list of the bodies its rays can hit, so a ray evaluates the
//    1-4 bodies near it instead of all N;
//  * the block stages its visible bodies (position, R^T, scale and 1/scale,
//    slot types, ops, parameters and offsets) and the env boxes in shared
//    memory once, so the step loop reads no global memory;
//  * a slot evaluates only the primitive its type names; the SDF formulas are
//    those of catgrasp_tpu/geom/csg.py and render_march.py, 1e-18 terms
//    included.

#include <cuda_runtime.h>

#define MAX_BODIES 32
#define MAX_ENV 16
#define BODY_F 38  // pos 3, R^T 9, scale, 1/scale, params 12, offsets 12
#define BODY_I 8   // slot types 4, slot ops 4
#define ENV_F 15   // center 3, R^T 9, half 3
#define TILE 256

#define T_NONE 0
#define T_BOX 1
#define T_CYL 2

__device__ __forceinline__ float sgnf(float x) { return (float)((x > 0.f) - (x < 0.f)); }

__device__ __forceinline__ float box_d(float px, float py, float pz, float hx, float hy, float hz) {
  const float qx = fabsf(px) - hx, qy = fabsf(py) - hy, qz = fabsf(pz) - hz;
  const float ox = fmaxf(qx, 0.f), oy = fmaxf(qy, 0.f), oz = fmaxf(qz, 0.f);
  const float outn = sqrtf(ox * ox + oy * oy + oz * oz + 1e-18f);
  return outn + fminf(fmaxf(qx, fmaxf(qy, qz)), 0.f);
}

__device__ __forceinline__ float cyl_d(float px, float py, float pz, float r, float hh) {
  const float dxy = sqrtf(px * px + py * py + 1e-18f) - r;
  const float dz = fabsf(pz) - hh;
  const float ox = fmaxf(dxy, 0.f), oz = fmaxf(dz, 0.f);
  return sqrtf(ox * ox + oz * oz + 1e-18f) + fminf(fmaxf(dxy, dz), 0.f);
}

__device__ __forceinline__ float hex_d(float px, float py, float pz, float apothem, float hh) {
  const float kx = -0.8660254037844387f, ky = 0.5f, kz = 0.57735f;
  float ax = fabsf(px), ay = fabsf(py);
  const float az = fabsf(pz);
  const float dot2 = fminf(kx * ax + ky * ay, 0.f);
  ax = ax - 2.f * dot2 * kx;
  ay = ay - 2.f * dot2 * ky;
  const float lx = ax - fminf(fmaxf(ax, -kz * apothem), kz * apothem);
  const float ly = ay - apothem;
  const float dx = sqrtf(lx * lx + ly * ly + 1e-18f) * sgnf(ay - apothem);
  const float dz = az - hh;
  const float ox = fmaxf(dx, 0.f), oz = fmaxf(dz, 0.f);
  return sqrtf(ox * ox + oz * oz + 1e-18f) + fminf(fmaxf(dx, dz), 0.f);
}

__global__ void __launch_bounds__(TILE)
march_csg_kernel(const float* __restrict__ d_w, const float* __restrict__ tmax_in, int P,
                 const float* __restrict__ origin,
                 const float* __restrict__ body_f, const int* __restrict__ body_i, int N,
                 const float* __restrict__ env_f, const int* __restrict__ env_on, int M,
                 const int* __restrict__ visidx, const int* __restrict__ visn,
                 int n_steps, float hit_eps, float* __restrict__ t_out) {
  __shared__ float sbf[MAX_BODIES * BODY_F];
  __shared__ int sbi[MAX_BODIES * BODY_I];
  __shared__ float sef[MAX_ENV * ENV_F];
  __shared__ int seo[MAX_ENV];
  const int tile = blockIdx.x;
  const int nv = visn[tile];
  for (int k = threadIdx.x; k < nv * BODY_F; k += blockDim.x) {
    const int b = visidx[tile * N + k / BODY_F];
    sbf[k] = body_f[b * BODY_F + k % BODY_F];
  }
  for (int k = threadIdx.x; k < nv * BODY_I; k += blockDim.x) {
    const int b = visidx[tile * N + k / BODY_I];
    sbi[k] = body_i[b * BODY_I + k % BODY_I];
  }
  for (int k = threadIdx.x; k < M * ENV_F; k += blockDim.x) sef[k] = env_f[k];
  for (int k = threadIdx.x; k < M; k += blockDim.x) seo[k] = env_on[k];
  __syncthreads();

  const int i = tile * TILE + threadIdx.x;
  if (i >= P) return;
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const float dx = d_w[3 * i], dy = d_w[3 * i + 1], dz = d_w[3 * i + 2];
  const float tmax = tmax_in[i];
  float t = 0.05f;
  for (int step = 0; step < n_steps; ++step) {
    const float x = ox + t * dx, y = oy + t * dy, z = oz + t * dz;
    float phi = 1e9f;
    for (int k = 0; k < nv; ++k) {
      const float* f = sbf + k * BODY_F;
      const int* c = sbi + k * BODY_I;
      const float rx = x - f[0], ry = y - f[1], rz = z - f[2];
      const float inv_s = f[13];
      // local = R^T (x - pos) / scale  (f[3..11] holds R^T row-major)
      const float px = (f[3] * rx + f[4] * ry + f[5] * rz) * inv_s;
      const float py = (f[6] * rx + f[7] * ry + f[8] * rz) * inv_s;
      const float pz = (f[9] * rx + f[10] * ry + f[11] * rz) * inv_s;
      float d = 1e9f;
      for (int s = 0; s < 4; ++s) {
        const int tcode = c[s];
        if (tcode == T_NONE) continue;
        const float* par = f + 14 + 3 * s;
        const float* off = f + 26 + 3 * s;
        const float qx = px - off[0], qy = py - off[1], qz = pz - off[2];
        const float ds = tcode == T_BOX ? box_d(qx, qy, qz, par[0], par[1], par[2])
                         : tcode == T_CYL ? cyl_d(qx, qy, qz, par[0], par[1])
                                          : hex_d(qx, qy, qz, par[0], par[1]);
        d = c[4 + s] > 0 ? fminf(d, ds) : fmaxf(d, -ds);
      }
      phi = fminf(phi, d * f[12]);
    }
    for (int m = 0; m < M; ++m) {
      if (!seo[m]) continue;
      const float* e = sef + m * ENV_F;
      const float rx = x - e[0], ry = y - e[1], rz = z - e[2];
      const float px = e[3] * rx + e[4] * ry + e[5] * rz;
      const float py = e[6] * rx + e[7] * ry + e[8] * rz;
      const float pz = e[9] * rx + e[10] * ry + e[11] * rz;
      phi = fminf(phi, box_d(px, py, pz, e[12], e[13], e[14]));
    }
    if (phi < hit_eps || t >= tmax) break;
    t = fminf(t + fmaxf(phi, hit_eps * 0.5f), tmax);
  }
  t_out[i] = t;
}

extern "C" int march_csg_launch(const float* d_w, const float* tmax, int P,
                                const float* origin,
                                const float* body_f, const int* body_i, int N,
                                const float* env_f, const int* env_on, int M,
                                const int* visidx, const int* visn,
                                int n_steps, float hit_eps, float* t_out, void* stream) {
  if (N < 1 || N > MAX_BODIES || M < 0 || M > MAX_ENV) return (int)cudaErrorInvalidValue;
  if (P > 0) {
    const int grid = (P + TILE - 1) / TILE;
    march_csg_kernel<<<grid, TILE, 0, (cudaStream_t)stream>>>(
        d_w, tmax, P, origin, body_f, body_i, N, env_f, env_on, M, visidx, visn,
        n_steps, hit_eps, t_out);
  }
  return (int)cudaGetLastError();
}
