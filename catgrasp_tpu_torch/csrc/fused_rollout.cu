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
// its constants once and writes 13 floats a body once (~25 KB at 10 bodies x
// 32 points), while every step evaluates ~N*N*P CSG distances with normals
// and up to 4 iterations over the pairs in contact: all f32 ALU work with
// square roots and divisions, no matrix product a tensor core could take.
//
// Design, and what it does about that bound:
//  * one block per scene, one thread per (body, surface point) pair, the
//    whole step loop inside the kernel: the state never leaves shared memory
//    between steps, and ragged batches are just the grid size;
//  * a thread loops over its point's colliders, so each slab entry (phi,
//    normal as 4 x bf16, K_n as f32, laid out [collider][thread]) is written
//    and read by one thread only, free of bank conflicts; a pair's contact
//    flags (rounded phi < 0) live in a 32-bit register mask;
//  * the work follows the data: inactive bodies and self pairs are skipped, a
//    slot evaluates only the primitive its type names, K_n and the slabs are
//    filled only for pairs in contact, and the iterations visit only the set
//    bits (a pair out of contact contributes exact zeros in the TPU kernel);
//  * Jacobi, not Gauss-Seidel: an iteration reads the velocities of its
//    start from shared memory, accumulates, and applies after a barrier;
//  * sums are deterministic: a thread adds its own colliders in order, a
//    body's points are added in order from a shared scratch, the reaction on
//    body j is a warp butterfly followed by an ordered pass over the warps'
//    partial sums; the contact counts are integers (shared-memory atomics on
//    integers do not depend on order).  No float atomics anywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define T_NONE 0
#define T_BOX 1
#define T_CYL 2

#define MAX_SLOTS 4
#define MAX_COLLIDERS 32
#define MAX_THREADS 512  // a block; leaves the compiler 128 registers a thread
#define BODY_IN 8   // active, dynamic, 1/mass, 1/inertia xyz, friction, scale
#define ENV_F 19    // center 3, half 3, R 9 (row-major), velocity 3, friction
#define STATE_F 13  // pos 3, quat 4, linvel 3, angvel 3
#define FULL 0xffffffffu
#define SLOP 2e-4f
#define FRICTION_RELAX 0.5f

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
#define C_ACT 0
#define C_DYN 1
#define C_INVM 2
#define C_INVI 3
#define C_FRIC 6
#define C_SCL 7
#define C_INVS 8
#define BC 9
#define ACC 12  // lin xyz, torque xyz for the real and the pseudo channel
#define SCRATCH_STRIDE 13  // odd, so a body's points fall into different banks

__host__ __device__ inline int block_threads(int N, int P) { return (N * P + 31) / 32 * 32; }

__host__ __device__ inline long long smem_bytes(int N, int P, int S, int M) {
  const long long T = block_threads(N, P), nw = T / 32, mt = N + M;
  long long floats = mt * T              // K_n slab
                     + T * SCRATCH_STRIDE  // own-body scratch
                     + nw * N * ACC        // reaction partial sums
                     + N * ACC             // totals
                     + N * BS + N * BC + N * 6 * S + M * ENV_F;
  long long ints = N * 2 * S + 2 * N + nw;
  return mt * T * 8 + 4 * (floats + ints);
}

__device__ __forceinline__ float sgnf(float x) { return (float)((x > 0.f) - (x < 0.f)); }

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
         | ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ float bf16_lo(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

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

// y = I_world^-1 x for the symmetric matrix stored as 00 01 02 11 12 22
__device__ __forceinline__ void apply_iw(const float* I, float tx, float ty, float tz, float& ox,
                                         float& oy, float& oz) {
  ox = I[0] * tx + I[1] * ty + I[2] * tz;
  oy = I[1] * tx + I[3] * ty + I[4] * tz;
  oz = I[2] * tx + I[4] * ty + I[5] * tz;
}

__global__ void __launch_bounds__(MAX_THREADS)
fused_rollout_kernel(const float* __restrict__ s_in, const float* __restrict__ body,
                     const float* __restrict__ surf, const int* __restrict__ csg_i,
                     const float* __restrict__ csg_f, const float* __restrict__ env,
                     int N, int P, int S, int M, int n_steps, int n_iter, float dt, float g_dt,
                     float inv_dt_b, float lin_keep, float ang_keep, float* __restrict__ s_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = T >> 5, NP = N * P, M_tot = N + M;
  const int scene = blockIdx.x;

  uint2* slab_pn = reinterpret_cast<uint2*>(smem_raw);         // [M_tot][T] phi|nx, ny|nz
  float* slab_kn = reinterpret_cast<float*>(slab_pn + M_tot * T);  // [M_tot][T]
  float* scratch = slab_kn + M_tot * T;                        // [T][SCRATCH_STRIDE]
  float* partial = scratch + T * SCRATCH_STRIDE;               // [nwarps][N][ACC]
  float* tot = partial + nwarps * N * ACC;                     // [N][ACC]
  float* bs = tot + N * ACC;                                   // [N][BS]
  float* bc = bs + N * BS;                                     // [N][BC]
  float* cf = bc + N * BC;                                     // [N][6S] params, offsets
  float* ev = cf + N * 6 * S;                                  // [M][ENV_F]
  int* ci = reinterpret_cast<int*>(ev + M * ENV_F);            // [N][2S] types, ops
  int* cnt = ci + N * 2 * S;                                   // [2][N] contacts as i, as j
  unsigned* flags = reinterpret_cast<unsigned*>(cnt + 2 * N);  // [nwarps] bodies j reduced

  // ---- stage the scene ----
  for (int k = tid; k < N * STATE_F; k += T)
    bs[(k / STATE_F) * BS + k % STATE_F] = s_in[(size_t)scene * N * STATE_F + k];
  for (int k = tid; k < N * BODY_IN; k += T)
    bc[(k / BODY_IN) * BC + k % BODY_IN] = body[(size_t)scene * N * BODY_IN + k];
  for (int k = tid; k < N * 6 * S; k += T) cf[k] = csg_f[(size_t)scene * N * 6 * S + k];
  for (int k = tid; k < N * 2 * S; k += T) ci[k] = csg_i[(size_t)scene * N * 2 * S + k];
  for (int k = tid; k < M * ENV_F; k += T) ev[k] = env[k];
  __syncthreads();
  if (tid < N) bc[tid * BC + C_INVS] = 1.0f / bc[tid * BC + C_SCL];

  const bool is_pair = tid < NP;
  const int i = is_pair ? tid / P : 0;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (is_pair) {
    const float* sp = surf + ((size_t)scene * NP + tid) * 3;
    sx = sp[0]; sy = sp[1]; sz = sp[2];
  }
  const float* bi = bs + i * BS;
  const float* bci = bc + i * BC;

  for (int step = 0; step < n_steps; ++step) {
    // ---- per body: gravity kick, rotation, world inverse inertia ----
    if (tid < N) {
      float* s = bs + tid * BS;
      const float* c = bc + tid * BC;
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
      cnt[tid] = 0;
      cnt[N + tid] = 0;
    }
    __syncthreads();

    // ---- narrowphase: this thread's point against every collider ----
    unsigned bits = 0;
    float wx = 0.f, wy = 0.f, wz = 0.f, rix = 0.f, riy = 0.f, riz = 0.f;
    if (is_pair && bci[C_ACT] > 0.f) {
      const float* R = bi + ROT;
      wx = bi[POS] + (R[0] * sx + R[1] * sy + R[2] * sz);
      wy = bi[POS + 1] + (R[3] * sx + R[4] * sy + R[5] * sz);
      wz = bi[POS + 2] + (R[6] * sx + R[7] * sy + R[8] * sz);
      rix = wx - bi[POS]; riy = wy - bi[POS + 1]; riz = wz - bi[POS + 2];
      int mine = 0;
      for (int j = 0; j < M_tot; ++j) {
        float phi, nx, ny, nz;
        const float* bj = bs + j * BS;  // read only where j < N
        if (j < N) {
          const float* bcj = bc + j * BC;
          if (j == i || !(bcj[C_ACT] > 0.f)) continue;
          const float* Rj = bj + ROT;
          const float rx = wx - bj[POS], ry = wy - bj[POS + 1], rz = wz - bj[POS + 2];
          const float inv_s = bcj[C_INVS];
          const float lx = (Rj[0] * rx + Rj[3] * ry + Rj[6] * rz) * inv_s;
          const float ly = (Rj[1] * rx + Rj[4] * ry + Rj[7] * rz) * inv_s;
          const float lz = (Rj[2] * rx + Rj[5] * ry + Rj[8] * rz) * inv_s;
          float gx, gy, gz;
          phi = csg_evaln(lx, ly, lz, ci + j * 2 * S, ci + j * 2 * S + S, cf + j * 6 * S,
                          cf + j * 6 * S + 3 * S, S, gx, gy, gz) * bcj[C_SCL];
          if (!(phi < 0.f)) continue;
          nx = Rj[0] * gx + Rj[1] * gy + Rj[2] * gz;
          ny = Rj[3] * gx + Rj[4] * gy + Rj[5] * gz;
          nz = Rj[6] * gx + Rj[7] * gy + Rj[8] * gz;
          atomicAdd(&cnt[N + j], 1);
        } else {
          const float* e = ev + (j - N) * ENV_F;
          const float* Re = e + 6;
          const float rx = wx - e[0], ry = wy - e[1], rz = wz - e[2];
          const float lx = Re[0] * rx + Re[3] * ry + Re[6] * rz;
          const float ly = Re[1] * rx + Re[4] * ry + Re[7] * rz;
          const float lz = Re[2] * rx + Re[5] * ry + Re[8] * rz;
          const float qx = fabsf(lx) - e[3], qy = fabsf(ly) - e[4], qz = fabsf(lz) - e[5];
          const float ox = fmaxf(qx, 0.f), oy = fmaxf(qy, 0.f), oz = fmaxf(qz, 0.f);
          const float d_out = sqrtf(ox * ox + oy * oy + oz * oz + 1e-18f);
          const float qmax = fmaxf(qx, fmaxf(qy, qz));
          phi = d_out + fminf(qmax, 0.f);
          if (!(phi < 0.f)) continue;
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
        // in contact (f32 phi < 0): count, K_n from the f32 normal, then round
        ++mine;
        const float cx = riy * nz - riz * ny, cy = riz * nx - rix * nz, cz = rix * ny - riy * nx;
        float ax, ay, az;
        apply_iw(bi + IW, cx, cy, cz, ax, ay, az);
        float kn = bci[C_INVM];
        const float term_i = cx * ax + cy * ay + cz * az;
        if (j < N) {
          const float rjx = wx - bj[POS], rjy = wy - bj[POS + 1], rjz = wz - bj[POS + 2];
          const float jx = rjy * nz - rjz * ny, jy = rjz * nx - rjx * nz,
                      jz = rjx * ny - rjy * nx;
          float bx, by, bz;
          apply_iw(bj + IW, jx, jy, jz, bx, by, bz);
          kn = kn + bc[j * BC + C_INVM] + term_i + (jx * bx + jy * by + jz * bz);
        } else {
          kn = kn + term_i;
        }
        const uint2 pk = make_uint2(pack_bf16(phi, nx), pack_bf16(ny, nz));
        slab_pn[j * T + tid] = pk;
        slab_kn[j * T + tid] = fmaxf(kn, 1e-9f);
        if (bf16_lo(pk.x) < 0.f) bits |= 1u << j;
      }
      if (mine) atomicAdd(&cnt[i], mine);
    }
    __syncthreads();

    // ---- Jacobi iterations over the pairs in contact ----
    for (int it = 0; it < n_iter; ++it) {
      float acc[ACC];
#pragma unroll
      for (int k = 0; k < ACC; ++k) acc[k] = 0.f;
      unsigned wflag = 0;
      for (int j = 0; j < M_tot; ++j) {
        const bool c = (bits >> j) & 1u;
        if (!__any_sync(FULL, c)) continue;  // uniform over the warp
        float v[ACC];
#pragma unroll
        for (int k = 0; k < ACC; ++k) v[k] = 0.f;
        if (c) {
          const uint2 pk = slab_pn[j * T + tid];
          const float phi = bf16_lo(pk.x), nx = bf16_hi(pk.x), ny = bf16_lo(pk.y),
                      nz = bf16_hi(pk.y);
          const float kn = slab_kn[j * T + tid];
          const float pen = fmaxf(-phi, 0.f);
          const float bias = inv_dt_b * fmaxf(pen - SLOP, 0.f);
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
            const float* e = ev + (j - N) * ENV_F;
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
      if (is_pair && cnt[i] > 0) {
#pragma unroll
        for (int k = 0; k < ACC; ++k) scratch[tid * SCRATCH_STRIDE + k] = acc[k];
      }
      __syncthreads();

      // ordered sums per body: its own points, then the warps' reactions on it
      for (int k = tid; k < N * ACC; k += T) {
        const int b = k / ACC, c = k % ACC;
        float s = 0.f;
        if (cnt[b] > 0)
          for (int p = 0; p < P; ++p) s += scratch[(b * P + p) * SCRATCH_STRIDE + c];
        for (int w = 0; w < nwarps; ++w)
          if ((flags[w] >> b) & 1u) s += partial[(w * N + b) * ACC + c];
        tot[k] = s;
      }
      __syncthreads();

      // apply, averaged over the contacts the body takes part in
      if (tid < N) {
        float* s = bs + tid * BS;
        const float* t = tot + tid * ACC;
        const float scale = 1.0f / fmaxf((float)(cnt[tid] + cnt[N + tid]), 1.0f);
        const float sm = scale * bc[tid * BC + C_INVM];
        float ax, ay, az;
        s[LIN] += t[0] * sm; s[LIN + 1] += t[1] * sm; s[LIN + 2] += t[2] * sm;
        apply_iw(s + IW, t[3], t[4], t[5], ax, ay, az);
        s[ANG] += ax * scale; s[ANG + 1] += ay * scale; s[ANG + 2] += az * scale;
        s[PLIN] += t[6] * sm; s[PLIN + 1] += t[7] * sm; s[PLIN + 2] += t[8] * sm;
        apply_iw(s + IW, t[9], t[10], t[11], ax, ay, az);
        s[PANG] += ax * scale; s[PANG + 1] += ay * scale; s[PANG + 2] += az * scale;
      }
      // the next iteration reads these velocities; after the last one only
      // the body's own thread goes on with them
      if (it + 1 < n_iter) __syncthreads();
    }

    // ---- damping, static zeroing, integration (the body's own thread) ----
    if (tid < N) {
      float* s = bs + tid * BS;
      if (bc[tid * BC + C_DYN] > 0.f) {
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
    // no barrier here: the next step starts with the same thread on the same
    // body and ends that phase with one
  }
  __syncthreads();
  for (int k = tid; k < N * STATE_F; k += T)
    s_out[(size_t)scene * N * STATE_F + k] = bs[(k / STATE_F) * BS + k % STATE_F];
}

extern "C" long long fused_rollout_smem_bytes(int N, int P, int S, int M) {
  return smem_bytes(N, P, S, M);
}

extern "C" int fused_rollout_launch(const float* s_in, const float* body, const float* surf,
                                    const int* csg_i, const float* csg_f, const float* env,
                                    int B, int N, int P, int S, int M, int n_steps, int n_iter,
                                    float dt, float g_dt, float inv_dt_b, float lin_keep,
                                    float ang_keep, float* s_out, void* stream) {
  if (B < 1 || N < 1 || P < 1 || S < 1 || S > MAX_SLOTS || M < 0 || N + M > MAX_COLLIDERS
      || N * P > MAX_THREADS || n_steps < 0 || n_iter < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(N, P, S, M);
  cudaError_t err = cudaFuncSetAttribute(fused_rollout_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_rollout_kernel<<<B, block_threads(N, P), smem, (cudaStream_t)stream>>>(
      s_in, body, surf, csg_i, csg_f, env, N, P, S, M, n_steps, n_iter, dt, g_dt, inv_dt_b,
      lin_keep, ang_keep, s_out);
  return (int)cudaGetLastError();
}
