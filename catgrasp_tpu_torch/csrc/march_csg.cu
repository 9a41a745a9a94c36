// march_csg: the renderer's sphere-trace loop, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel catgrasp_tpu/ops/render_march.py:march_csg
// (body _march_kernel; under vmap a (B, P) batch in one pallas_call).  Per
// ray, from the camera origin along d_w: start at t = 0.05, take at most
// n_steps steps of max(phi, hit_eps/2), stop when phi < hit_eps or
// t >= tmax.  phi is the min over the tile's visible bodies of scale * CSG
// distance (<= 4 slots of box, z-cylinder or z-hex-prism, combined by union
// or subtraction) and over the enabled env boxes.
//
// What bounds it on an H100: operations.  The inputs are ~16 bytes a ray and
// the output 4, so a 384x512 frame moves ~4 MB; the work is up to 64 steps x
// (bodies x ~4 slot SDFs + env boxes), all f32 ALU work with square roots,
// and no matrix product that tensor cores could take.  One frame is too
// little work to reach that bound: most rays converge in ~10 steps, a
// seventh of the time is the block prologue and a quarter the few rays that
// take up to 64 steps, one after another (~0.3 us a step on 8x8 tiles).
//
// Design, and what it does about that bound:
//  * one launch marches a whole batch of scenes seen by one camera: the grid
//    is (tiles, scenes), a block marches one tile of one scene;
//  * a tile is a rectangle of pixels (8x8 for an image; a bare ray set is a
//    1 x P image in 1 x 256 strips).  A small square tile's rays span a
//    narrow cone, so its cull keeps only the bodies near it, and small blocks
//    keep the slow rays' blocks short; a ragged tile at the image's edge
//    marches only its valid pixels;
//  * the block builds everything it needs from the scene's tensors as the
//    caller holds them (no packing kernel ahead of it): its threads sum the
//    tile's ray directions and take the smallest cosine to their normalised
//    sum (warp shuffles, then the warps' partials in a fixed order); the lanes
//    of warp 0 each take one body, run the conservative cone-versus-bounding-
//    sphere test of ops/render_march.py:tile_visibility (the same 1e-3 and
//    1e-4 slacks), and the visible ones, kept in index order by a ballot and a
//    prefix count, write their rows (position, R^T of the normalised
//    quaternion, scale, 1/scale, the slot row of their shape) to shared
//    memory as float4s; the lanes of warp 1 do the same for the enabled env
//    boxes;
//  * the step loop then reads only shared memory and the ray's own registers;
//    a slot evaluates only the primitive its type names; the SDF formulas are
//    those of catgrasp_tpu/geom/csg.py and render_march.py, 1e-18 terms
//    included;
//  * one thread a ray: a block has as many threads as its tile has rays
//    (at least two warps for the prologue; 64 for 8x8, 256 for a strip), and
//    a thread steps its ray until it converges and leaves.
//
// Tried and dropped (each time, with its run, in PERF.md, K2's tiles and
// designs tried; NVIDIA H100 80GB HBM3 at 700 W): 16x16, 8x16, 16x8, 8x32,
// 32x8 and 32x32 tiles, and 256-ray strips; a per-block ray pool (fewer
// threads than the tile has rays; a lane whose ray converged takes the
// tile's next one from a shared counter, Aila and Laine's persistent
// "while-while" traversal); two rays a thread evaluated side by side;
// register caps of 40 and 32; skipping the rotation of axis-aligned env
// boxes; unrolling the env loop by 4.  Rows as float4s were kept for their
// fewer loads (within 1% of plain floats).
//
// A second entry point runs the same staging and writes the cull lists out
// (march_csg_cull_kernel), so that they can be held against the plain cull.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_BODIES 32
#define MAX_ENV 16
#define MAX_SLOTS 4
#define MAX_RAYS 256  // rays of a tile, one a thread
// rows in shared memory, in float4s, so that a step reads them 16 bytes a load:
// body: (pos, scale) (R^T row 0, 1/scale) (R^T row 1, 0) (R^T row 2, 0), then
//       per slot (offset, param 0) (param 1, param 2, type, op)
// env box: (center, half x) (R^T row 0, half y) (R^T row 1, half z) (R^T row 2, 0)
#define BODY_V (4 + 2 * MAX_SLOTS)
#define ENV_V 4

#define T_NONE 0
#define T_BOX 1
#define T_CYL 2

struct MarchArgs {
  // the rays of one camera
  const float* d_w;   // (P, 3)
  const float* tmax;  // (P,)
  const float* o_w;   // (3,), element k at o_w[k * o_stride]
  long long o_stride;
  // the scenes, (B, N, ...) as the caller holds them
  const float* pos;
  const float* quat;
  const uint8_t* active;
  const float* scale;
  const void* shape_id;  // int64 (sid64 = 1) or int32
  // the shape library, (K, S, ...)
  const int* types;
  const int* ops;
  const float* prm;
  const float* off;
  const float* radius;
  // env boxes, (M, ...)
  const float* e_center;
  const float* e_quat;
  const float* e_half;
  const uint8_t* e_enabled;
  // outputs: t (B, P); the cull lists (B, n_tiles, N) and counts (cull launch)
  float* t_out;
  int* cull_idx;
  int* cull_n;
  int sid64, P, H, W, th, tw, tiles_x, n_tiles, N, S, M, n_steps;
  float hit_eps;
};

struct Stage {
  float4 bv[MAX_BODIES * BODY_V];
  float4 ev[MAX_ENV * ENV_V];
  int bidx[MAX_BODIES];
  float red[MAX_RAYS / 32 * 4];  // per warp: direction sum 3, min cosine 1
  int nv, ne;
};

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

// R^T, row-major, of the rotation of the normalised quaternion (w, x, y, z),
// as core/transforms.py:quat_to_matrix builds R
__device__ __forceinline__ void rotation_t(const float* q, float* rt) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + 1e-12f;
  const float w = q[0] / n, x = q[1] / n, y = q[2] / n, z = q[3] / n;
  rt[0] = 1.f - 2.f * (y * y + z * z);
  rt[3] = 2.f * (x * y - w * z);
  rt[6] = 2.f * (x * z + w * y);
  rt[1] = 2.f * (x * y + w * z);
  rt[4] = 1.f - 2.f * (x * x + z * z);
  rt[7] = 2.f * (y * z - w * x);
  rt[2] = 2.f * (x * z - w * y);
  rt[5] = 2.f * (y * z + w * x);
  rt[8] = 1.f - 2.f * (x * x + y * y);
}

// the tile's origin pixel and its valid extent (a ragged tile at the edge)
__device__ __forceinline__ void tile_extent(const MarchArgs& a, int tile, int& y0, int& x0,
                                            int& hv, int& wv) {
  const int ty = tile / a.tiles_x;
  y0 = ty * a.th;
  x0 = (tile - ty * a.tiles_x) * a.tw;
  hv = min(a.th, a.H - y0);
  wv = min(a.tw, a.W - x0);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block prologue: the tile's cone, the cull, and the visible bodies' and
// enabled env boxes' rows in shared memory.  Ends in a block barrier.
__device__ void stage_tile(const MarchArgs& a, int b, int tile, Stage& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  int y0, x0, hv, wv;
  tile_extent(a, tile, y0, x0, hv, wv);
  const int R = hv * wv;
  const float ox = a.o_w[0], oy = a.o_w[a.o_stride], oz = a.o_w[2 * a.o_stride];

  // the cone's axis: the normalised sum of the tile's ray directions
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int r = tid; r < R; r += blockDim.x) {
    const int p = (y0 + r / wv) * a.W + x0 + r % wv;
    sx += a.d_w[3 * p];
    sy += a.d_w[3 * p + 1];
    sz += a.d_w[3 * p + 2];
  }
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  sz = warp_sum(sz);
  if (lane == 0) {
    s.red[4 * warp] = sx;
    s.red[4 * warp + 1] = sy;
    s.red[4 * warp + 2] = sz;
  }
  __syncthreads();
  float mx = 0.f, my = 0.f, mz = 0.f;
  for (int w = 0; w < nw; ++w) {
    mx += s.red[4 * w];
    my += s.red[4 * w + 1];
    mz += s.red[4 * w + 2];
  }
  const float mn = sqrtf(mx * mx + my * my + mz * mz);
  mx = mx / mn;
  my = my / mn;
  mz = mz / mn;
  // its half-angle: the smallest cosine of a ray to the axis
  float cmin = 2.f;
  for (int r = tid; r < R; r += blockDim.x) {
    const int p = (y0 + r / wv) * a.W + x0 + r % wv;
    cmin = fminf(cmin, a.d_w[3 * p] * mx + a.d_w[3 * p + 1] * my + a.d_w[3 * p + 2] * mz);
  }
  cmin = warp_min(cmin);
  if (lane == 0) s.red[4 * warp + 3] = cmin;
  __syncthreads();
  float cos_t = s.red[3];
  for (int w = 1; w < nw; ++w) cos_t = fminf(cos_t, s.red[4 * w + 3]);
  cos_t = fminf(fmaxf(cos_t, -1.f), 1.f);
  const float sin_t = sqrtf(fmaxf(1.f - cos_t * cos_t, 0.f));

  if (warp == 0) {
    // lane j: body j against the cone (catgrasp_tpu/ops/render_march.py:_tile_visibility)
    bool vis = false;
    long long j = 0;
    long long sid = 0;
    float px = 0.f, py = 0.f, pz = 0.f, scl = 1.f;
    if (lane < a.N) {
      j = (long long)b * a.N + lane;
      sid = a.sid64 ? ((const long long*)a.shape_id)[j] : (long long)((const int*)a.shape_id)[j];
      px = a.pos[3 * j];
      py = a.pos[3 * j + 1];
      pz = a.pos[3 * j + 2];
      scl = a.scale[j];
      const float cx = px - ox, cy = py - oy, cz = pz - oz;
      const float dist = sqrtf(cx * cx + cy * cy + cz * cz);
      const float r = a.radius[sid] * scl + 1e-3f;
      const bool inside = dist <= r;
      const float safe = fmaxf(dist, 1e-9f);
      const float sin_b = fminf(fmaxf(r / safe, 0.f), 1.f);
      const float cos_b = sqrtf(fmaxf(1.f - sin_b * sin_b, 0.f));
      const float cos_u = mx * (cx / safe) + my * (cy / safe) + mz * (cz / safe);
      const float thresh = cos_t * cos_b - sin_t * sin_b;
      vis = ((cos_u >= thresh - 1e-4f) || inside) && a.active[j] != 0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, vis);
    if (vis) {
      const int slot = __popc(m & ((1u << lane) - 1u));
      float4* f = s.bv + slot * BODY_V;
      float rt[9];
      rotation_t(a.quat + 4 * j, rt);
      const float inv_s = 1.f / scl;
      f[0] = make_float4(px, py, pz, scl);
      f[1] = make_float4(rt[0], rt[1], rt[2], inv_s);
      f[2] = make_float4(rt[3], rt[4], rt[5], 0.f);
      f[3] = make_float4(rt[6], rt[7], rt[8], 0.f);
      for (int k = 0; k < MAX_SLOTS; ++k) {
        const long long g = sid * a.S + k;
        if (k < a.S) {
          f[4 + 2 * k] = make_float4(a.off[3 * g], a.off[3 * g + 1], a.off[3 * g + 2],
                                     a.prm[3 * g]);
          f[5 + 2 * k] = make_float4(a.prm[3 * g + 1], a.prm[3 * g + 2], (float)a.types[g],
                                     (float)a.ops[g]);
        } else {
          f[4 + 2 * k] = make_float4(0.f, 0.f, 0.f, 0.f);
          f[5 + 2 * k] = make_float4(0.f, 0.f, (float)T_NONE, 1.f);
        }
      }
      s.bidx[slot] = lane;
    }
    if (lane == 0) s.nv = __popc(m);
  } else if (warp == 1) {
    // lane m: env box m, kept when enabled
    const bool on = lane < a.M && a.e_enabled[lane] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, on);
    if (on) {
      float4* e = s.ev + __popc(m & ((1u << lane) - 1u)) * ENV_V;
      const float* c = a.e_center + 3 * lane;
      const float* h = a.e_half + 3 * lane;
      float rt[9];
      rotation_t(a.e_quat + 4 * lane, rt);
      e[0] = make_float4(c[0], c[1], c[2], h[0]);
      e[1] = make_float4(rt[0], rt[1], rt[2], h[1]);
      e[2] = make_float4(rt[3], rt[4], rt[5], h[2]);
      e[3] = make_float4(rt[6], rt[7], rt[8], 0.f);
    }
    if (lane == 0) s.ne = __popc(m);
  }
  __syncthreads();
}

__device__ __forceinline__ float scene_phi(const Stage& s, int nv, int ne, float x, float y,
                                           float z) {
  float phi = 1e9f;
  for (int k = 0; k < nv; ++k) {
    const float4* f = s.bv + k * BODY_V;
    const float4 h = f[0], r0 = f[1], r1 = f[2], r2 = f[3];
    const float rx = x - h.x, ry = y - h.y, rz = z - h.z;
    // local = R^T (x - pos) / scale
    const float px = (r0.x * rx + r0.y * ry + r0.z * rz) * r0.w;
    const float py = (r1.x * rx + r1.y * ry + r1.z * rz) * r0.w;
    const float pz = (r2.x * rx + r2.y * ry + r2.z * rz) * r0.w;
    float d = 1e9f;
#pragma unroll
    for (int sl = 0; sl < MAX_SLOTS; ++sl) {
      const float4 pb = f[5 + 2 * sl];  // param 1, param 2, type, op
      if (pb.z == (float)T_NONE) continue;
      const float4 oa = f[4 + 2 * sl];  // offset, param 0
      const float qx = px - oa.x, qy = py - oa.y, qz = pz - oa.z;
      const float ds = pb.z == (float)T_BOX ? box_d(qx, qy, qz, oa.w, pb.x, pb.y)
                       : pb.z == (float)T_CYL ? cyl_d(qx, qy, qz, oa.w, pb.x)
                                              : hex_d(qx, qy, qz, oa.w, pb.x);
      d = pb.w > 0.f ? fminf(d, ds) : fmaxf(d, -ds);
    }
    phi = fminf(phi, d * h.w);
  }
  for (int m = 0; m < ne; ++m) {
    const float4* e = s.ev + m * ENV_V;
    const float4 c = e[0], r0 = e[1], r1 = e[2], r2 = e[3];
    const float rx = x - c.x, ry = y - c.y, rz = z - c.z;
    const float px = r0.x * rx + r0.y * ry + r0.z * rz;
    const float py = r1.x * rx + r1.y * ry + r1.z * rz;
    const float pz = r2.x * rx + r2.y * ry + r2.z * rz;
    phi = fminf(phi, box_d(px, py, pz, c.w, r0.w, r1.w));
  }
  return phi;
}

__global__ void __launch_bounds__(MAX_RAYS) march_csg_kernel(const MarchArgs a) {
  __shared__ Stage s;
  const int tile = blockIdx.x, b = blockIdx.y;
  stage_tile(a, b, tile, s);
  int y0, x0, hv, wv;
  tile_extent(a, tile, y0, x0, hv, wv);
  const int r = threadIdx.x;
  if (r >= hv * wv) return;
  const int p = (y0 + r / wv) * a.W + x0 + r % wv;
  const float dx = a.d_w[3 * p], dy = a.d_w[3 * p + 1], dz = a.d_w[3 * p + 2];
  const float tm = a.tmax[p];
  const float ox = a.o_w[0], oy = a.o_w[a.o_stride], oz = a.o_w[2 * a.o_stride];
  const float eps = a.hit_eps;
  const int nv = s.nv, ne = s.ne;
  float t = 0.05f;
  for (int k = 0; k < a.n_steps; ++k) {
    const float phi = scene_phi(s, nv, ne, ox + t * dx, oy + t * dy, oz + t * dz);
    if (phi < eps || t >= tm) break;
    t = fminf(t + fmaxf(phi, eps * 0.5f), tm);
  }
  a.t_out[(long long)b * a.P + p] = t;
}

__global__ void __launch_bounds__(MAX_RAYS) march_csg_cull_kernel(const MarchArgs a) {
  __shared__ Stage s;
  stage_tile(a, blockIdx.y, blockIdx.x, s);
  const long long row = (long long)blockIdx.y * a.n_tiles + blockIdx.x;
  if ((int)threadIdx.x < s.nv) a.cull_idx[row * a.N + threadIdx.x] = s.bidx[threadIdx.x];
  if (threadIdx.x == 0) a.cull_n[row] = s.nv;
}

// One launch over B scenes: t (cull_only = 0), or the cull lists alone.  A
// block is one tile of one scene, one thread a ray.
extern "C" int march_csg_launch(const MarchArgs* a, int B, int cull_only, void* stream) {
  if (a->N < 1 || a->N > MAX_BODIES || a->M < 0 || a->M > MAX_ENV || a->S < 0 ||
      a->S > MAX_SLOTS || a->th < 1 || a->tw < 1 || a->th * a->tw > MAX_RAYS || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int rays = (a->th * a->tw + 31) / 32 * 32, threads = rays < 64 ? 64 : rays;
  if (B > 0 && a->n_tiles > 0) {
    const dim3 grid(a->n_tiles, B);
    if (cull_only)
      march_csg_cull_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(*a);
    else
      march_csg_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}
