// fused_rollout: n_steps of free-pile physics a scene with the state on chip,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel catgrasp_tpu/ops/fused_rollout.py:rollout_fused
// (body _make_kernel).  Per scene and step: gravity on the dynamic bodies;
// narrowphase of every surface point of every active body against every other
// active body's CSG (<= 4 slots of box, z-cylinder or z-hex-prism, union or
// subtraction, scaled) and every env box, giving phi, the world normal and
// the normal effective mass K_n; n_iter Jacobi split-impulse iterations (a
// real channel: normal impulse against the approach plus friction relaxed by
// 0.5 and clamped to the mu * jn cone; a pseudo channel: Baumgarte bias
// 0.2 / dt * (penetration - 2e-4), normal only, moves positions this step and
// is discarded; both averaged over the contacts a body takes part in);
// damping; semi-implicit Euler with a normalised quaternion update.  phi and
// the normal are rounded to bf16 (nearest even) after K_n and the contact
// counts were taken from their f32 values, as the TPU kernel stores them.
//
// What bounds it on an H100: operations.  A scene reads 13 floats a body and
// its constants once and writes 13 floats a body once, while every step
// tests ~N*N*P point-body pairs and runs up to 4 iterations over the pairs in
// contact: all f32 ALU work with square roots and divisions, no matrix
// product a tensor core could take.  Contacts are rare (a handful of ~4,800
// pairs a scene-step while a pile falls), so what a design must not do is pay
// the full CSG evaluation, the solver or a barrier for a pair, a body or a
// step that has no contact.
//
// The kernel is bound by latency, not by instruction slots or bytes: a step is a
// chain of short dependent phases, and its time falls with the blocks an SM
// holds (1 block an SM took twice the time of 3, which is what 64 registers a
// thread allow at 320 threads).
//
// Design:
//  * one block a scene, one thread a (body, surface point) pair, the step
//    loop inside the kernel, the state in shared memory between steps;
//  * inactive bodies cost nothing: the block's threads map onto the scene's
//    active bodies only (a compacted list staged at the start) and the warps
//    past the last active pair leave before the first step; the barriers
//    count the threads that stayed.  An inactive body's state is copied
//    through while the scene is staged;
//  * "no contact" is decided cheaply: a point is tested against a body's
//    bounding sphere (worked out from its union slots while staging, 0.1%
//    and 1 um wider than the CSG) and against an env box's faces (q_max > 0
//    means phi > 0; the test allows 1 um) in a first pass without a branch,
//    so that the loads of several colliders are in flight together.  Only a
//    pair that passes runs the CSG evaluation, the same arithmetic as before
//    in the same order, so results are those of the untested evaluation;
//  * the solver runs only when the scene has a contact this step (one
//    block-wide vote, folded into the barrier after the narrowphase), visits
//    only the colliders some lane of the warp touches, and sums and applies
//    only for bodies with a contact; what it skips adds exact zeros;
//  * contact storage is sized by contacts: a thread keeps its first 2
//    contacts of a step (phi and normal as 4 x bf16, K_n as f32) in shared
//    memory and recomputes any further one in each iteration from the poses,
//    which do not move within a step.  Nothing is dropped and nothing can
//    overflow; the dense [collider][thread] slabs are gone;
//  * the per-call gathers are part of the staging: surface points and CSG
//    rows by shape id, inverse mass and inertia, env rotation matrices (with
//    unfused multiplies and adds, as the plain version rounds them);
//  * per-body phases are folded and spread: a body's warp sums its 12 impulse
//    totals on 12 lanes; the 6 linear ones are applied by their own lanes and
//    each angular triple by one lane (shuffles bring it the triple); after
//    the last iteration lane 0 goes straight on to damping, integration and
//    the next step's gravity, rotation and world inverse inertia;
//  * sums are deterministic and in the earlier design's order: a thread adds its
//    own colliders in order, a body's points are added in point order from a
//    shared scratch (only lanes in contact write a row, packed in lane order
//    by a per-warp lane mask), the reaction on body j is a warp butterfly
//    followed by an ordered pass over the warps' partial sums; the contact
//    counts are integers.  No float atomics anywhere: two runs give the same
//    bits, and on the same input they are the earlier design's bits.
//
// Block barriers a step: 2 when the scene has no body-body contact (where P
// divides 32, so that a warp holds whole bodies; else: no contact at all),
// otherwise 1 + 2 n_iter (9 at n_iter = 4; the earlier design had 2 + 3 n_iter).
//   A  after the per-body phase: the narrowphase reads every body's pose,
//      rotation and inverse inertia, and adds to the zeroed counts;
//   B  after the narrowphase (it carries the vote): the iterations read the
//      counts and the lane masks; the per-body phase may move the poses;
//   C  in each iteration after the impulses: the sums read every warp's
//      scratch rows and partial sums;
//   D  after each iteration but the last: the next one reads the velocities
//      just applied.  After the last, barrier A of the next step serves.
// Without a body-body contact no warp reads what another wrote inside the
// solver (a body's points, sums and velocities are its own warp's, the env
// does not move), so C and D shrink to __syncwarp and a warp without a
// contact skips the solver.
//
// Tried and dropped (times in PERF.md): several scenes packed into a block so
// that every warp of it is live (the scenes then wait for each other at every
// barrier: a third slower on settled piles); more blocks an SM through a
// tighter register limit (40 or 32 registers spill in the solver and lose
// more than the blocks gain), fewer through none (118 registers, 1 block an
// SM, twice the time); the re-evaluation out of line (no fewer spills); 1 or
// 4 kept contacts a thread (within 5% of 2); rotation and inertia entries on
// separate lanes (nine different formulas on one warp serialise); a per-warp
// contact list with a capacity (it needs a flag read back by the host to
// raise on overflow, a synchronisation a call; the re-evaluation needs none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define T_NONE 0
#define T_BOX 1
#define T_CYL 2

#define MAX_SLOTS 4
#define MAX_COLLIDERS 32
#define MAX_THREADS 512
#define MIN_BLOCKS 2     // blocks an SM the compiler keeps registers for
#define CACHED 2         // contacts a thread keeps a step; further ones are recomputed
#define ENV_F 19    // center 3, half 3, R 9 (row-major), velocity 3, friction
#define STATE_F 13  // pos 3, quat 4, linvel 3, angvel 3
#define FULL 0xffffffffu
#define SLOP 2e-4f
#define FRICTION_RELAX 0.5f
#define STATIC_MASS 1e8f
#define FAR_AWAY 1e6f

// per-body working state in shared memory
#define POS 0
#define QUAT 3
#define LIN 7
#define ANG 10
#define PLIN 13
#define PANG 16
#define ROT 19  // R, row-major
#define IW 28   // world inverse inertia: 00 01 02 11 12 22
#define BS 34
// per-body constants in shared memory
#define C_DYN 0
#define C_INVM 1
#define C_INVI 2
#define C_FRIC 5
#define C_SCL 6
#define C_INVS 7
#define C_RAD2 8  // squared radius of the bounding sphere, world units
#define BC 9
#define ACC 12  // lin xyz, torque xyz for the real and the pseudo channel
#define SCRATCH_STRIDE 13  // odd, so a body's points fall into different banks

struct RolloutArgs {
  // state and parameters, (B, N, ...) as the caller holds them
  const float *pos, *quat, *lin, *ang;
  const uint8_t* active;
  const long long* shape_id;
  const float *scale, *mass, *inertia, *friction;
  // shape library, (K, ...)
  const float* surf;
  const int *types, *ops;
  const float *prm, *off;
  // env boxes, (M, ...)
  const float *e_center, *e_half, *e_quat, *e_vel, *e_friction;
  const uint8_t* e_enabled;
  float *o_pos, *o_quat, *o_lin, *o_ang;
  int N, P, S, M, K, n_steps, n_iter;
  float dt, g_dt, inv_dt_b, lin_keep, ang_keep;
};

// what the phases share of a scene's shared memory
struct Scene {
  float *bs, *bc, *cf, *ev;
  int* ci;
  int N, S;
};

__host__ __device__ inline int block_threads(int N, int P) { return (N * P + 31) / 32 * 32; }

__host__ __device__ inline long long smem_bytes(int N, int P, int S, int M) {
  const long long T = block_threads(N, P), nw = T / 32;
  long long floats = CACHED * T            // cached K_n
                     + T * SCRATCH_STRIDE  // own-body scratch
                     + nw * N * ACC        // reaction partial sums
                     + N * BS + N * BC + N * 6 * S + M * ENV_F;
  long long ints = N * 2 * S + 2 * N + 2 * nw + N + 1;
  return CACHED * T * 8 + 4 * (floats + ints);
}

__device__ __forceinline__ float sgnf(float x) { return (float)((x > 0.f) - (x < 0.f)); }

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
         | ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ float bf16_lo(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  for (int k = 0; k < n; ++k) m &= m - 1u;
  return __ffs(m) - 1;
}

// ---- primitive SDF + outward normal (catgrasp_tpu/ops/fused_rollout.py
// _box_sdfn_l, _cyl_sdfn_l, _hex_sdfn_l): sign(0) = 0, epsilons as written ----

__device__ __forceinline__ float box_sdfn(float px, float py, float pz, float hx, float hy,
                                          float hz, float& nx, float& ny, float& nz) {
  const float qx = fabsf(px) - hx, qy = fabsf(py) - hy, qz = fabsf(pz) - hz;
  const float ox = fmaxf(qx, 0.f), oy = fmaxf(qy, 0.f), oz = fmaxf(qz, 0.f);
  const float d_out = sqrtf(ox * ox + oy * oy + oz * oz + 1e-18f);
  const float qmax = fmaxf(qx, fmaxf(qy, qz));
  const float inv_do = 1.0f / d_out;
  const bool outside = (qx > 0.f) | (qy > 0.f) | (qz > 0.f);
  nx = (outside ? ox * inv_do : (qx >= qmax ? 1.f : 0.f)) * sgnf(px);
  ny = (outside ? oy * inv_do : (qy >= qmax ? 1.f : 0.f)) * sgnf(py);
  nz = (outside ? oz * inv_do : (qz >= qmax ? 1.f : 0.f)) * sgnf(pz);
  return d_out + fminf(qmax, 0.f);
}

__device__ __forceinline__ float cyl_sdfn(float px, float py, float pz, float r, float hh,
                                          float& nx, float& ny, float& nz) {
  const float rxy = sqrtf(px * px + py * py + 1e-18f);
  const float inv_rxy = 1.0f / rxy;
  const float dxy = rxy - r;
  const float dz = fabsf(pz) - hh;
  const float ox = fmaxf(dxy, 0.f), oz = fmaxf(dz, 0.f);
  const float d_out = sqrtf(ox * ox + oz * oz + 1e-18f);
  const float d_in = fminf(fmaxf(dxy, dz), 0.f);
  const float inv_do = 1.0f / d_out;
  const bool out = (ox + oz) > 0.f;
  const float wr = out ? ox * inv_do : (dxy > dz ? 1.f : 0.f);
  const float wz = out ? oz * inv_do : (dxy <= dz ? 1.f : 0.f);
  nx = wr * px * inv_rxy;
  ny = wr * py * inv_rxy;
  nz = wz * sgnf(pz);
  return (out ? d_out : 0.f) + d_in;
}

__device__ __forceinline__ float hex_sdfn(float px0, float py0, float pz0, float ap, float hh,
                                          float& nx, float& ny, float& nz) {
  const float kx = -0.8660254037844387f, ky = 0.5f, kz = 0.57735f;
  const float s1 = sgnf(px0), s2 = sgnf(py0), sz = sgnf(pz0);
  const float px = fabsf(px0), py = fabsf(py0), pz = fabsf(pz0);
  const float dot = kx * px + ky * py;
  const bool folded = dot < 0.f;
  const float mdot = fminf(dot, 0.f);
  const float px2 = px - 2.0f * mdot * kx;
  const float py2 = py - 2.0f * mdot * ky;
  const float lim = kz * ap;
  const float clipped = fminf(fmaxf(px2, -lim), lim);
  const float lx = px2 - clipped;
  const float ly = py2 - ap;
  const float llen = sqrtf(lx * lx + ly * ly + 1e-18f);
  const float side = sgnf(py2 - ap);
  const float dx = llen * side;
  const float dz = pz - hh;
  const float active = (px2 != clipped) ? 1.f : 0.f;
  const float inv_ll = 1.0f / llen;
  float gx = side * lx * inv_ll * active;
  float gy = side * ly * inv_ll;
  const float kg = kx * gx + ky * gy;
  if (folded) {
    gx = gx - 2.0f * kx * kg;
    gy = gy - 2.0f * ky * kg;
  }
  const float ox = fmaxf(dx, 0.f), oz = fmaxf(dz, 0.f);
  const float d_out = sqrtf(ox * ox + oz * oz + 1e-18f);
  const bool outside = (ox + oz) > 0.f;
  const float d_in = fminf(fmaxf(dx, dz), 0.f);
  const float inv_do = 1.0f / d_out;
  const float w2d = outside ? ox * inv_do : (dx > dz ? 1.f : 0.f);
  const float wz = outside ? oz * inv_do : (dx <= dz ? 1.f : 0.f);
  const float ax = w2d * s1 * gx, ay = w2d * s2 * gy, az = wz * sz;
  const float gn = rsqrtf(ax * ax + ay * ay + az * az + 1e-18f);
  nx = ax * gn;
  ny = ay * gn;
  nz = az * gn;
  return (outside ? d_out : 0.f) + d_in;
}

// CSG distance and outward normal in a body's unit-scale frame; a slot
// evaluates only the primitive its type names (_csg_evaln_l selects the same
// value among all three).
__device__ __forceinline__ float csg_evaln(float lx, float ly, float lz, const int* types,
                                           const int* ops, const float* prm, const float* off,
                                           int S, float& nx, float& ny, float& nz) {
  float d = 1e9f;
  nx = ny = nz = 0.f;
  for (int s = 0; s < S; ++s) {
    const int t = types[s];
    if (t == T_NONE) continue;
    const float px = lx - off[3 * s], py = ly - off[3 * s + 1], pz = lz - off[3 * s + 2];
    const float* q = prm + 3 * s;
    float sx, sy, sz;
    const float ds = t == T_BOX   ? box_sdfn(px, py, pz, q[0], q[1], q[2], sx, sy, sz)
                     : t == T_CYL ? cyl_sdfn(px, py, pz, q[0], q[1], sx, sy, sz)
                                  : hex_sdfn(px, py, pz, q[0], q[1], sx, sy, sz);
    if (ops[s] > 0) {
      if (ds < d) { nx = sx; ny = sy; nz = sz; }
      d = fminf(d, ds);
    } else {
      if (-ds > d) { nx = -sx; ny = -sy; nz = -sz; }
      d = fmaxf(d, -ds);
    }
  }
  const float gn = rsqrtf(nx * nx + ny * ny + nz * nz + 1e-18f);
  nx *= gn;
  ny *= gn;
  nz *= gn;
  return d;
}

// Radius about the body's origin, unit scale, of a sphere that holds the CSG:
// the farthest reach of its union slots (a subtraction only removes).  The
// hex prism's corner lies at apothem * sqrt(1 + 0.57735^2) < 1.1548 apothem.
__device__ float csg_bound_radius(const int* types, const int* ops, const float* prm,
                                  const float* off, int S) {
  float r = 0.f;
  for (int s = 0; s < S; ++s) {
    const int t = types[s];
    if (t == T_NONE || ops[s] <= 0) continue;
    const float* q = prm + 3 * s;
    const float* o = off + 3 * s;
    const float a = t == T_BOX ? q[0] : t == T_CYL ? q[0] : 1.1548f * q[0];
    const float b = t == T_BOX ? q[1] : 0.f;
    const float c = t == T_BOX ? q[2] : q[1];
    r = fmaxf(r, sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2]) + sqrtf(a * a + b * b + c * c));
  }
  return r;
}

// y = I_world^-1 x for the symmetric matrix stored as 00 01 02 11 12 22
__device__ __forceinline__ void apply_iw(const float* I, float tx, float ty, float tz, float& ox,
                                         float& oy, float& oz) {
  ox = I[0] * tx + I[1] * ty + I[2] * tz;
  oy = I[1] * tx + I[3] * ty + I[4] * tz;
  oz = I[2] * tx + I[4] * ty + I[5] * tz;
}

// phi, world normal and K_n (all f32, before the rounding) of the point
// (wx, wy, wz) of body i, lever arm (rix, riy, riz), against collider j;
// false when the pair is not in contact (phi >= 0).  The caller has already
// dropped the pairs that a bounding sphere or an env box's faces rule out.
__device__ __forceinline__ bool eval_pair(const Scene& sc, int i, int j, float wx, float wy,
                                          float wz, float rix, float riy, float riz, float& phi,
                                          float& nx, float& ny, float& nz, float& kn) {
  const int N = sc.N, S = sc.S;
  const float* bi = sc.bs + i * BS;
  const float* bj = sc.bs + j * BS;  // read only where j < N
  if (j < N) {
    const float* bcj = sc.bc + j * BC;
    const float* Rj = bj + ROT;
    const float rx = wx - bj[POS], ry = wy - bj[POS + 1], rz = wz - bj[POS + 2];
    const float inv_s = bcj[C_INVS];
    const float lx = (Rj[0] * rx + Rj[3] * ry + Rj[6] * rz) * inv_s;
    const float ly = (Rj[1] * rx + Rj[4] * ry + Rj[7] * rz) * inv_s;
    const float lz = (Rj[2] * rx + Rj[5] * ry + Rj[8] * rz) * inv_s;
    float gx, gy, gz;
    phi = csg_evaln(lx, ly, lz, sc.ci + j * 2 * S, sc.ci + j * 2 * S + S, sc.cf + j * 6 * S,
                    sc.cf + j * 6 * S + 3 * S, S, gx, gy, gz) * bcj[C_SCL];
    if (!(phi < 0.f)) return false;
    nx = Rj[0] * gx + Rj[1] * gy + Rj[2] * gz;
    ny = Rj[3] * gx + Rj[4] * gy + Rj[5] * gz;
    nz = Rj[6] * gx + Rj[7] * gy + Rj[8] * gz;
  } else {
    const float* e = sc.ev + (j - N) * ENV_F;
    const float* Re = e + 6;
    const float rx = wx - e[0], ry = wy - e[1], rz = wz - e[2];
    const float lx = Re[0] * rx + Re[3] * ry + Re[6] * rz;
    const float ly = Re[1] * rx + Re[4] * ry + Re[7] * rz;
    const float lz = Re[2] * rx + Re[5] * ry + Re[8] * rz;
    const float qx = fabsf(lx) - e[3], qy = fabsf(ly) - e[4], qz = fabsf(lz) - e[5];
    const float qmax = fmaxf(qx, fmaxf(qy, qz));
    if (qmax > 0.f) return false;  // outside a face: phi = d_out > 0
    const float ox = fmaxf(qx, 0.f), oy = fmaxf(qy, 0.f), oz = fmaxf(qz, 0.f);
    const float d_out = sqrtf(ox * ox + oy * oy + oz * oz + 1e-18f);
    phi = d_out + fminf(qmax, 0.f);
    if (!(phi < 0.f)) return false;
    const bool outside = qmax > 0.f;
    const float inv_do = 1.0f / d_out;
    float ax = outside ? ox * inv_do * sgnf(lx) : (qx >= qmax ? sgnf(lx) : 0.f);
    float ay = outside ? oy * inv_do * sgnf(ly) : (qy >= qmax ? sgnf(ly) : 0.f);
    float az = outside ? oz * inv_do * sgnf(lz) : (qz >= qmax ? sgnf(lz) : 0.f);
    const float gn = rsqrtf(ax * ax + ay * ay + az * az + 1e-12f);
    ax *= gn; ay *= gn; az *= gn;
    nx = Re[0] * ax + Re[1] * ay + Re[2] * az;
    ny = Re[3] * ax + Re[4] * ay + Re[5] * az;
    nz = Re[6] * ax + Re[7] * ay + Re[8] * az;
  }
  // K_n from the f32 normal
  const float cx = riy * nz - riz * ny, cy = riz * nx - rix * nz, cz = rix * ny - riy * nx;
  float ax, ay, az;
  apply_iw(bi + IW, cx, cy, cz, ax, ay, az);
  kn = sc.bc[i * BC + C_INVM];
  const float term_i = cx * ax + cy * ay + cz * az;
  if (j < N) {
    const float rjx = wx - bj[POS], rjy = wy - bj[POS + 1], rjz = wz - bj[POS + 2];
    const float jx = rjy * nz - rjz * ny, jy = rjz * nx - rjx * nz, jz = rjx * ny - rjy * nx;
    float bx, by, bz;
    apply_iw(bj + IW, jx, jy, jz, bx, by, bz);
    kn = kn + sc.bc[j * BC + C_INVM] + term_i + (jx * bx + jy * by + jz * bz);
  } else {
    kn = kn + term_i;
  }
  kn = fmaxf(kn, 1e-9f);
  return true;
}

// start of a step for one body: gravity kick, rotation, world inverse inertia
__device__ __forceinline__ void body_begin_step(float* __restrict__ s,
                                                const float* __restrict__ c, float g_dt) {
  if (c[C_DYN] > 0.f) s[LIN + 2] += g_dt;
  const float w = s[QUAT], x = s[QUAT + 1], y = s[QUAT + 2], z = s[QUAT + 3];
  float* R = s + ROT;
  R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - z * w); R[2] = 2 * (x * z + y * w);
  R[3] = 2 * (x * y + z * w); R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - x * w);
  R[6] = 2 * (x * z - y * w); R[7] = 2 * (y * z + x * w); R[8] = 1 - 2 * (x * x + y * y);
  const float* iI = c + C_INVI;
  float* I = s + IW;
  int n = 0;
  for (int a = 0; a < 3; ++a)
    for (int b = a; b < 3; ++b)
      I[n++] = R[3 * a] * iI[0] * R[3 * b] + R[3 * a + 1] * iI[1] * R[3 * b + 1]
               + R[3 * a + 2] * iI[2] * R[3 * b + 2];
  for (int k = 0; k < 6; ++k) s[PLIN + k] = 0.f;
}

// end of a step for one body: damping, static zeroing, integration
__device__ __forceinline__ void body_end_step(float* __restrict__ s, const float* __restrict__ c,
                                              float dt, float lin_keep, float ang_keep) {
  if (c[C_DYN] > 0.f) {
    for (int k = 0; k < 3; ++k) {
      s[LIN + k] *= lin_keep;
      s[ANG + k] *= ang_keep;
      // positions integrate real + pseudo velocities; only the real ones
      // persist into the next step (split impulse)
      s[POS + k] += (s[LIN + k] + s[PLIN + k]) * dt;
    }
    const float ox = s[ANG] + s[PANG], oy = s[ANG + 1] + s[PANG + 1],
                oz = s[ANG + 2] + s[PANG + 2];
    const float qw = s[QUAT], qx = s[QUAT + 1], qy = s[QUAT + 2], qz = s[QUAT + 3];
    const float nqw = qw + 0.5f * dt * (-ox * qx - oy * qy - oz * qz);
    const float nqx = qx + 0.5f * dt * (ox * qw + oy * qz - oz * qy);
    const float nqy = qy + 0.5f * dt * (-ox * qz + oy * qw + oz * qx);
    const float nqz = qz + 0.5f * dt * (ox * qy - oy * qx + oz * qw);
    const float inv_n = rsqrtf(nqw * nqw + nqx * nqx + nqy * nqy + nqz * nqz + 1e-12f);
    s[QUAT] = nqw * inv_n; s[QUAT + 1] = nqx * inv_n;
    s[QUAT + 2] = nqy * inv_n; s[QUAT + 3] = nqz * inv_n;
  } else {
    for (int k = 0; k < 6; ++k) s[LIN + k] = 0.f;
  }
}

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
fused_rollout_kernel(const __grid_constant__ RolloutArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = T >> 5;
  const int N = a.N, P = a.P, S = a.S, M = a.M;
  const size_t sN = (size_t)blockIdx.x * N;  // the scene's first body

  uint2* cache_pn = reinterpret_cast<uint2*>(smem_raw);          // [CACHED][T] phi|nx, ny|nz
  float* cache_kn = reinterpret_cast<float*>(cache_pn + CACHED * T);  // [CACHED][T]
  float* scratch = cache_kn + CACHED * T;                        // [T][SCRATCH_STRIDE]
  float* partial = scratch + T * SCRATCH_STRIDE;                 // [nwarps][N][ACC]
  Scene sc;
  sc.N = N;
  sc.S = S;
  sc.bs = partial + nwarps * N * ACC;                            // [N][BS]
  sc.bc = sc.bs + N * BS;                                        // [N][BC]
  sc.cf = sc.bc + N * BC;                                        // [N][6S] params, offsets
  sc.ev = sc.cf + N * 6 * S;                                     // [M][ENV_F]
  sc.ci = reinterpret_cast<int*>(sc.ev + M * ENV_F);             // [N][2S] types, ops
  int* cnt = sc.ci + N * 2 * S;                                  // [2][N] contacts as i, as j
  unsigned* flags = reinterpret_cast<unsigned*>(cnt + 2 * N);    // [nwarps] bodies j reduced
  unsigned* cmask = flags + nwarps;                              // [nwarps] lanes in contact
  int* alist = reinterpret_cast<int*>(cmask + nwarps);           // [N] the active bodies
  unsigned* amask_p = reinterpret_cast<unsigned*>(alist + N);    // their bit mask
  float *bs = sc.bs, *bc = sc.bc;

  // ---- stage the scene: state, per-body constants, CSG rows by shape id,
  // env boxes; an inactive body's state goes straight through ----
  if (warp == 0) {
    const unsigned m = __ballot_sync(FULL, lane < N && a.active[sN + lane] != 0);
    if (lane == 0) *amask_p = m;
  }
  for (int k = tid; k < N * STATE_F; k += T) {
    const int b = k / STATE_F, f = k % STATE_F;
    const size_t g = sN + b;
    const bool on = a.active[g] != 0;
    float v;
    if (f < 3) {
      v = a.pos[g * 3 + f];
      if (!on) a.o_pos[g * 3 + f] = v;
    } else if (f < 7) {
      v = a.quat[g * 4 + f - 3];
      if (!on) a.o_quat[g * 4 + f - 3] = v;
    } else if (f < 10) {
      v = a.lin[g * 3 + f - 7];
      if (!on) a.o_lin[g * 3 + f - 7] = v;
    } else {
      v = a.ang[g * 3 + f - 10];
      if (!on) a.o_ang[g * 3 + f - 10] = v;
    }
    bs[b * BS + f] = v;
  }
  for (int k = tid; k < N * S; k += T) {
    const int b = k / S, s = k % S;
    // an id outside the library reads the nearest shape, as a JAX gather clamps
    const int sid = min(max((int)a.shape_id[sN + b], 0), a.K - 1);
    sc.ci[b * 2 * S + s] = a.types[sid * S + s];
    sc.ci[b * 2 * S + S + s] = a.ops[sid * S + s];
    for (int c = 0; c < 3; ++c) {
      sc.cf[b * 6 * S + 3 * s + c] = a.prm[(sid * S + s) * 3 + c];
      sc.cf[b * 6 * S + 3 * S + 3 * s + c] = a.off[(sid * S + s) * 3 + c];
    }
  }
  if (tid < N) {
    const size_t g = sN + tid;
    float* c = bc + tid * BC;
    const float mass = a.mass[g], scale = a.scale[g];
    const bool dyn = a.active[g] != 0 && mass < STATIC_MASS;
    c[C_DYN] = dyn ? 1.f : 0.f;
    c[C_INVM] = dyn ? 1.0f / mass : 0.f;
    for (int k = 0; k < 3; ++k) c[C_INVI + k] = dyn ? 1.0f / a.inertia[g * 3 + k] : 0.f;
    c[C_FRIC] = a.friction[g];
    c[C_SCL] = scale;
    c[C_INVS] = 1.0f / scale;
    const int sid = min(max((int)a.shape_id[g], 0), a.K - 1);
    const float r = csg_bound_radius(a.types + sid * S, a.ops + sid * S, a.prm + sid * S * 3,
                                     a.off + sid * S * 3, S) * scale * 1.001f + 1e-6f;
    c[C_RAD2] = r * r;
    cnt[tid] = 0;
    cnt[N + tid] = 0;
  }
  if (tid < M) {
    float* e = sc.ev + tid * ENV_F;
    const bool on = a.e_enabled[tid] != 0;
    for (int k = 0; k < 3; ++k) {
      e[k] = on ? a.e_center[tid * 3 + k] : FAR_AWAY;
      e[3 + k] = a.e_half[tid * 3 + k];
      e[15 + k] = on ? a.e_vel[tid * 3 + k] : 0.f;
    }
    e[18] = a.e_friction[tid];
    // rotation of the normalised quaternion, each product and sum rounded on
    // its own (no fused multiply-add), as the plain version computes it
    const float* q = a.e_quat + tid * 4;
    const float nrm = __fadd_rn(
        sqrtf(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(q[0], q[0]), __fmul_rn(q[1], q[1])),
                                  __fmul_rn(q[2], q[2])), __fmul_rn(q[3], q[3]))), 1e-12f);
    const float w = q[0] / nrm, x = q[1] / nrm, y = q[2] / nrm, z = q[3] / nrm;
#define PR(u, v) __fmul_rn(u, v)
    float* R = e + 6;
    R[0] = __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(PR(y, y), PR(z, z))));
    R[1] = __fmul_rn(2.f, __fsub_rn(PR(x, y), PR(w, z)));
    R[2] = __fmul_rn(2.f, __fadd_rn(PR(x, z), PR(w, y)));
    R[3] = __fmul_rn(2.f, __fadd_rn(PR(x, y), PR(w, z)));
    R[4] = __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(PR(x, x), PR(z, z))));
    R[5] = __fmul_rn(2.f, __fsub_rn(PR(y, z), PR(w, x)));
    R[6] = __fmul_rn(2.f, __fsub_rn(PR(x, z), PR(w, y)));
    R[7] = __fmul_rn(2.f, __fadd_rn(PR(y, z), PR(w, x)));
    R[8] = __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(PR(x, x), PR(y, y))));
#undef PR
  }
  __syncthreads();

  // ---- the block's threads cover the active bodies only ----
  const unsigned amask = *amask_p;
  const int na = __popc(amask), n_pairs = na * P;
  if (warp * 32 >= n_pairs) return;  // whole warps leave; barriers count the rest
  const int n_live = ((n_pairs + 31) >> 5) << 5, nlw = n_live >> 5;
  const bool is_pair = tid < n_pairs;
  const int slot = is_pair ? tid / P : 0;
  const int i = nth_set_bit(amask, slot);
  if (tid < na) alist[tid] = nth_set_bit(amask, tid);
  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (is_pair) {
    const int sid = min(max((int)a.shape_id[sN + i], 0), a.K - 1);
    const float* sp = a.surf + ((size_t)sid * P + (tid - slot * P)) * 3;
    const float scale = bc[i * BC + C_SCL];
    sx = __fmul_rn(sp[0], scale); sy = __fmul_rn(sp[1], scale); sz = __fmul_rn(sp[2], scale);
  }
  const float* bi = bs + i * BS;
  const float* bci = bc + i * BC;
  // per-body phases: a body is served by the warp that holds its first point
  const int sl0 = (warp * 32 + P - 1) / P;
#define FOR_MY_BODIES(sl) for (int sl = sl0; sl < na && ((sl * P) >> 5) == warp; ++sl)
  // with whole bodies in every warp (P divides 32) a step without a
  // body-body contact needs no block barrier inside the solver
  const bool warp_local = (32 % P) == 0;
  const unsigned body_bits = N >= 32 ? FULL : (1u << N) - 1u;
  if (a.n_steps > 0 && lane == 0)
    FOR_MY_BODIES(sl) {
      const int b = nth_set_bit(amask, sl);
      body_begin_step(bs + b * BS, bc + b * BC, a.g_dt);
    }
  __syncthreads();  // A

  for (int step = 0; step < a.n_steps; ++step) {
    // ---- narrowphase: this thread's point against every collider ----
    unsigned bits = 0;
    float wx = 0.f, wy = 0.f, wz = 0.f, rix = 0.f, riy = 0.f, riz = 0.f;
    if (is_pair) {
      const float* R = bi + ROT;
      wx = bi[POS] + (R[0] * sx + R[1] * sy + R[2] * sz);
      wy = bi[POS + 1] + (R[3] * sx + R[4] * sy + R[5] * sz);
      wz = bi[POS + 2] + (R[6] * sx + R[7] * sy + R[8] * sz);
      rix = wx - bi[POS]; riy = wy - bi[POS + 1]; riz = wz - bi[POS + 2];
      int mine = 0;
      // first which colliders the point can touch at all, without a branch so
      // that the loads of several colliders are in flight together: inside a
      // body's bounding sphere, within 1 um of the inside of an env box
      unsigned cand = 0u;
#pragma unroll 4
      for (int c = 0; c < na; ++c) {
        const int j = alist[c];
        const float* bj = bs + j * BS;
        const float rx = wx - bj[POS], ry = wy - bj[POS + 1], rz = wz - bj[POS + 2];
        cand |= (unsigned)!(rx * rx + ry * ry + rz * rz > bc[j * BC + C_RAD2]) << j;
      }
      cand &= ~(1u << i);
#pragma unroll 4
      for (int m = 0; m < M; ++m) {
        const float* e = sc.ev + m * ENV_F;
        const float* Re = e + 6;
        const float rx = wx - e[0], ry = wy - e[1], rz = wz - e[2];
        const float qx = fabsf(Re[0] * rx + Re[3] * ry + Re[6] * rz) - e[3];
        const float qy = fabsf(Re[1] * rx + Re[4] * ry + Re[7] * rz) - e[4];
        const float qz = fabsf(Re[2] * rx + Re[5] * ry + Re[8] * rz) - e[5];
        cand |= (unsigned)!(fmaxf(qx, fmaxf(qy, qz)) > 1e-6f) << (N + m);
      }
      // then the full evaluation of those, in collider order
      for (; cand; cand &= cand - 1u) {
        const int j = __ffs(cand) - 1;
        float phi, nx, ny, nz, kn;
        if (!eval_pair(sc, i, j, wx, wy, wz, rix, riy, riz, phi, nx, ny, nz, kn)) continue;
        // in contact (f32 phi < 0): count, then round
        ++mine;
        if (j < N) atomicAdd(&cnt[N + j], 1);
        const uint2 pk = make_uint2(pack_bf16(phi, nx), pack_bf16(ny, nz));
        if (bf16_lo(pk.x) < 0.f) {
          const int k = __popc(bits);
          if (k < CACHED) {
            cache_pn[k * T + tid] = pk;
            cache_kn[k * T + tid] = kn;
          }
          bits |= 1u << j;
        }
      }
      if (mine) atomicAdd(&cnt[i], mine);
    }
    const unsigned wmask = __reduce_or_sync(FULL, bits);  // colliders this warp touches
    const unsigned lanes_in = __ballot_sync(FULL, bits != 0u);
    if (lane == 0) cmask[warp] = lanes_in;
    // B, with the vote: is there a body-body contact in the scene (or, where
    // bodies straddle warps, any contact)?  Then the iterations synchronise
    // the block; else every warp with a contact iterates on its own
    const bool vote = __syncthreads_or(warp_local ? (bits & body_bits) != 0u : bits != 0u);
    const bool block_wide = vote || !warp_local;
    const int n_iter = (vote || (warp_local && wmask != 0u)) ? a.n_iter : 0;

    // ---- Jacobi iterations over the pairs in contact ----
    for (int it = 0; it < n_iter; ++it) {
      float acc[ACC];
#pragma unroll
      for (int k = 0; k < ACC; ++k) acc[k] = 0.f;
      unsigned wflag = 0;
      int seen = 0;  // this thread's contacts visited so far, in collider order
      for (unsigned wm = wmask; wm; wm &= wm - 1u) {  // uniform over the warp
        const int j = __ffs(wm) - 1;
        const bool c = (bits >> j) & 1u;
        float v[ACC];
#pragma unroll
        for (int k = 0; k < ACC; ++k) v[k] = 0.f;
        if (c) {
          uint2 pk;
          float kn;
          if (seen < CACHED) {
            pk = cache_pn[seen * T + tid];
            kn = cache_kn[seen * T + tid];
          } else {
            float f_phi, f_nx, f_ny, f_nz;
            eval_pair(sc, i, j, wx, wy, wz, rix, riy, riz, f_phi, f_nx, f_ny, f_nz, kn);
            pk = make_uint2(pack_bf16(f_phi, f_nx), pack_bf16(f_ny, f_nz));
          }
          ++seen;
          const float phi = bf16_lo(pk.x), nx = bf16_hi(pk.x), ny = bf16_lo(pk.y),
                      nz = bf16_hi(pk.y);
          const float pen = fmaxf(-phi, 0.f);
          const float bias = a.inv_dt_b * fmaxf(pen - SLOP, 0.f);
          const float* li = bi + LIN;   // lin 0..2, ang 3..5, plin 6..8, pang 9..11
          // contact-point velocity of i, real and pseudo channel
          float rvx = li[0] + li[4] * riz - li[5] * riy;
          float rvy = li[1] + li[5] * rix - li[3] * riz;
          float rvz = li[2] + li[3] * riy - li[4] * rix;
          float pvx = li[6] + li[10] * riz - li[11] * riy;
          float pvy = li[7] + li[11] * rix - li[9] * riz;
          float pvz = li[8] + li[9] * riy - li[10] * rix;
          float mu, rjx = 0.f, rjy = 0.f, rjz = 0.f;
          if (j < N) {
            const float* bj = bs + j * BS;
            const float* lj = bj + LIN;
            rjx = wx - bj[POS]; rjy = wy - bj[POS + 1]; rjz = wz - bj[POS + 2];
            rvx -= lj[0] + lj[4] * rjz - lj[5] * rjy;
            rvy -= lj[1] + lj[5] * rjx - lj[3] * rjz;
            rvz -= lj[2] + lj[3] * rjy - lj[4] * rjx;
            pvx -= lj[6] + lj[10] * rjz - lj[11] * rjy;
            pvy -= lj[7] + lj[11] * rjx - lj[9] * rjz;
            pvz -= lj[8] + lj[9] * rjy - lj[10] * rjx;
            mu = bci[C_FRIC] * bc[j * BC + C_FRIC];
          } else {
            const float* e = sc.ev + (j - N) * ENV_F;
            rvx -= e[15]; rvy -= e[16]; rvz -= e[17];  // the env carries no pseudo velocity
            mu = bci[C_FRIC] * e[18];
          }
          // real channel: normal impulse against the approach, relaxed friction
          // clamped to the cone
          const float v_n = rvx * nx + rvy * ny + rvz * nz;
          const float jn = fmaxf(-v_n / kn, 0.f);
          const float tx = rvx - v_n * nx, ty = rvy - v_n * ny, tz = rvz - v_n * nz;
          const float vt = sqrtf(tx * tx + ty * ty + tz * tz + 1e-18f);
          const float jt = fminf(FRICTION_RELAX * vt / kn, mu * jn);
          const float inv_vt = 1.0f / (vt + 1e-9f);
          const float irx = jn * nx - jt * tx * inv_vt;
          const float iry = jn * ny - jt * ty * inv_vt;
          const float irz = jn * nz - jt * tz * inv_vt;
          // pseudo channel: normal only, driven by the bias
          const float p_n = pvx * nx + pvy * ny + pvz * nz;
          const float jp = fmaxf((-p_n + bias) / kn, 0.f);
          const float ipx = jp * nx, ipy = jp * ny, ipz = jp * nz;
          acc[0] += irx; acc[1] += iry; acc[2] += irz;
          acc[3] += riy * irz - riz * iry;
          acc[4] += riz * irx - rix * irz;
          acc[5] += rix * iry - riy * irx;
          acc[6] += ipx; acc[7] += ipy; acc[8] += ipz;
          acc[9] += riy * ipz - riz * ipy;
          acc[10] += riz * ipx - rix * ipz;
          acc[11] += rix * ipy - riy * ipx;
          // reaction on body j: the impulse is on i, so minus on j
          v[0] = -irx; v[1] = -iry; v[2] = -irz;
          v[3] = -(rjy * irz - rjz * iry);
          v[4] = -(rjz * irx - rjx * irz);
          v[5] = -(rjx * iry - rjy * irx);
          v[6] = -ipx; v[7] = -ipy; v[8] = -ipz;
          v[9] = -(rjy * ipz - rjz * ipy);
          v[10] = -(rjz * ipx - rjx * ipz);
          v[11] = -(rjx * ipy - rjy * ipx);
        }
        if (j < N) {
#pragma unroll
          for (int k = 0; k < ACC; ++k) {
            float x = v[k];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
            v[k] = x;
          }
          if (lane == 0) {
#pragma unroll
            for (int k = 0; k < ACC; ++k) partial[(warp * N + j) * ACC + k] = v[k];
            wflag |= 1u << j;
          }
        }
      }
      if (lane == 0) flags[warp] = wflag;
      if (bits != 0u) {  // rows of a warp's lanes in contact, packed in lane order
        float* row = scratch + (warp * 32 + __popc(lanes_in & ((1u << lane) - 1u))) * SCRATCH_STRIDE;
#pragma unroll
        for (int k = 0; k < ACC; ++k) row[k] = acc[k];
      }
      if (block_wide) __syncthreads(); else __syncwarp();  // C

      // per body with a contact: ordered sums on 12 lanes (its own points in
      // point order, then the warps' reactions on it), each applied by its
      // lane, averaged over the contacts the body takes part in
      FOR_MY_BODIES(sl) {
        const int b = alist[sl];
        const int n_contacts = cnt[b] + cnt[N + b];
        if (n_contacts == 0) continue;  // uniform over the warp
        float sum = 0.f;
        if (lane < ACC) {
          const int t0 = sl * P, t1 = t0 + P;
          for (int w = t0 >> 5; w <= (t1 - 1) >> 5; ++w) {
            // the body's rows among warp w's packed rows: [r0, r1)
            const int lo = max(t0 - w * 32, 0), hi = min(t1 - w * 32, 32);
            const unsigned cm = cmask[w];
            const int r0 = __popc(cm & ((1u << lo) - 1u));
            const int r1 = __popc(hi == 32 ? cm : cm & ((1u << hi) - 1u));
            const float* row = scratch + w * 32 * SCRATCH_STRIDE + lane;
#pragma unroll 4
            for (int r = r0; r < r1; ++r) sum += row[r * SCRATCH_STRIDE];
          }
          if (block_wide) {
            // a warp without a reaction on b adds an exact zero, so that the
            // loads need no branch and overlap
#pragma unroll 4
            for (int w = 0; w < nlw; ++w) {
              const float pv = partial[(w * N + b) * ACC + lane];
              sum += ((flags[w] >> b) & 1u) ? pv : 0.f;
            }
          }
        }
        // lane 3g + a holds total a of group g (0 lin, 1 ang, 2 plin, 3 pang).
        // A linear total is applied by its own lane, scaled by 1/m; an angular
        // group by its first lane, all three rows of the world inverse inertia
        // as apply_iw writes them (spread over three lanes the compiler fuses
        // the row's products in another order and the last bits move)
        const int grp = lane / 3, ax = lane - 3 * grp;
        const float tx = __shfl_sync(FULL, sum, 3 * grp), ty = __shfl_sync(FULL, sum, 3 * grp + 1),
                    tz = __shfl_sync(FULL, sum, 3 * grp + 2);
        if (lane < ACC) {
          float* s = bs + b * BS;
          const float scale = 1.0f / fmaxf((float)n_contacts, 1.0f);
          if (grp & 1) {
            if (ax == 0) {
              float ox, oy, oz;
              float* o = s + (grp == 1 ? ANG : PANG);
              apply_iw(s + IW, tx, ty, tz, ox, oy, oz);
              o[0] += ox * scale; o[1] += oy * scale; o[2] += oz * scale;
            }
          } else {
            const float sm = scale * bc[b * BC + C_INVM];
            s[(grp == 0 ? LIN : PLIN) + ax] += sum * sm;
          }
        }
        __syncwarp();  // lane 0 goes on with these velocities
      }
      if (it + 1 < n_iter) {
        if (block_wide) __syncthreads(); else __syncwarp();  // D
      }
    }

    // ---- per body: damping and integration, then the next step's start ----
    if (lane == 0)
      FOR_MY_BODIES(sl) {
        const int b = alist[sl];
        body_end_step(bs + b * BS, bc + b * BC, a.dt, a.lin_keep, a.ang_keep);
        if (step + 1 < a.n_steps) body_begin_step(bs + b * BS, bc + b * BC, a.g_dt);
        cnt[b] = 0;
        cnt[N + b] = 0;
      }
    __syncthreads();  // A
  }
#undef FOR_MY_BODIES
  for (int k = tid; k < na * STATE_F; k += n_live) {
    const int b = alist[k / STATE_F], f = k % STATE_F;
    const size_t g = sN + b;
    const float v = bs[b * BS + f];
    if (f < 3) a.o_pos[g * 3 + f] = v;
    else if (f < 7) a.o_quat[g * 4 + f - 3] = v;
    else if (f < 10) a.o_lin[g * 3 + f - 7] = v;
    else a.o_ang[g * 3 + f - 10] = v;
  }
}

extern "C" long long fused_rollout_smem_bytes(int N, int P, int S, int M) {
  return smem_bytes(N, P, S, M);
}

// Blocks of this launch that fit one SM at once (registers and shared memory).
extern "C" int fused_rollout_blocks_per_sm(int N, int P, int S, int M) {
  const int smem = (int)smem_bytes(N, P, S, M);
  if (cudaFuncSetAttribute(fused_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_rollout_kernel,
                                                    block_threads(N, P), smem) != cudaSuccess)
    return -1;
  return blocks;
}

extern "C" int fused_rollout_launch(const RolloutArgs* args, int B, void* stream) {
  const RolloutArgs& a = *args;
  if (B < 1 || a.N < 1 || a.P < 1 || a.S < 1 || a.S > MAX_SLOTS || a.M < 0 || a.K < 1
      || a.N + a.M > MAX_COLLIDERS || a.N * a.P > MAX_THREADS || a.n_steps < 0 || a.n_iter < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(a.N, a.P, a.S, a.M);
  cudaError_t err = cudaFuncSetAttribute(fused_rollout_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_rollout_kernel<<<B, block_threads(a.N, a.P), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
