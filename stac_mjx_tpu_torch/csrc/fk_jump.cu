// Forward kinematics of F frames in one launch, for Hopper (sm_90a): qpos
// (F, nq) -> xpos (F, nbody, 3), xquat (F, nbody, 4), site_xpos (F, nsite, 3),
// xanchor (F, njnt, 3), xaxis (F, njnt, 3).
//
// Replaces no TPU kernel. The JAX package's FK is jnp code that XLA fuses
// (stac_mjx_tpu/models/kinematics.py make_fk_jump: pointer doubling over
// the body tree). Its PyTorch twin, stac_mjx_tpu_torch/models/kinematics.py
// make_fk_jump, stays the plain body for the CPU and for the backward under
// autograd; as the card's forward it launched ~200 small gathers and
// elementwise kernels a pass, each reading and writing (F, nbody, .) tensors
// in device memory.
//
// Semantics (MuJoCo's mj_kinematics, as the plain body computes them):
// free joints take the frame from qpos (normalised); ball, hinge and slide
// joints compose about the joint anchor, hinge and slide displacements
// measured from qpos0; xanchor / xaxis follow the plain body's conventions,
// a free joint's anchor being its qpos translation and its axis the raw
// local axis; a site is xpos[body] + rotate(xquat[body], site_pos); the
// world body is the identity. Each body's quaternion is normalised as the
// body is composed (MuJoCo's order), and its children compose with the
// normalised one; the plain body normalises once, after the doubling. The
// two agree to rounding (tests/test_torch_fk_kernel.py holds the bound).
//
// What bounds it on an H100: bytes. A pass reads qpos (nq floats a frame)
// and writes 7 nbody + 3 nsite + 6 njnt floats a frame: 5.3 KB for the
// tethered fly (nbody 68, njnt 102, nsite 45, nq 102), 1.5 KB for the
// first-party critter, against ~19 kFLOP (the fly) of quaternion
// arithmetic, ~4 FLOP a byte, far under the card's fp32 balance.
//
// Design: one warp per frame, kWarps frames a block, no block barrier.
//  - The warp reads its qpos row once, coalesced, into its own shared
//    memory, and keeps the frame's whole state there: body frames, joint
//    anchors and axes, sites, laid out as the outputs are (1.9 KB of body
//    frames and 5.3 KB in all for the fly in float32).
//  - Local pass, bodies across the lanes: each body's transform relative
//    to its parent (body offset, then its joint slots in order) and its
//    joints' anchors and axes in the parent's frame.
//  - Tree pass, one depth level at a time, the level's bodies across the
//    lanes, a __syncwarp between levels: frame[b] = frame[parent] . local[b],
//    then the quaternion normalised. Depth 9 for the fly, 5 for the critter.
//  - Joints and sites across the lanes, from the finished body frames.
//  - Every output row written from shared memory with consecutive lanes on
//    consecutive addresses: a frame's rows are contiguous in each output.
//  So each output byte is written once and each input byte read once;
//  nothing of a frame round-trips through device memory.
//  - Tables, not code, carry the body: one compiled kernel reads a small
//    int32 table (kinematics.fk_table: per body its parent, depth and joint
//    slots; the bodies by level; per joint its body and type; per site its
//    body), built once per topology and uploaded once; the model's numbers
//    (body_pos, body_quat, jnt_pos, jnt_axis, qpos0, site_pos) are read
//    each launch from the tensors the caller passes, so an m-phase's new
//    site_pos and a CUDA graph's static copies are what it reads.
//  - Control flow depends on the topology alone, no frame reads another's
//    data and nothing is atomic: a frame's outputs are bitwise the same in
//    any batch.
//  - Templated on float and double. The frame's state must fit a warp's
//    share of the block's shared memory (kMaxFrameBytes): the fly needs
//    5.3 KB (float) and 10.6 KB (double) of its 56.75 KB; a larger body is
//    refused (cudaErrorInvalidValue), and the wrapper raises first.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;                        // frames a block
constexpr int kMaxBlockBytes = 232448;           // an H100 block's shared memory
constexpr int kMaxFrameBytes = kMaxBlockBytes / kWarps;
constexpr int kNone = 4;                         // kinematics.JNT_NONE
constexpr int kFree = 0, kSlide = 2, kHinge = 3;  // kinematics.JNT_*; 1 is ball

struct Dims {
  int nbody, njnt, nsite, nq, nslot, nlevel;
};

template <typename T>
struct Params {
  const T* body_pos;   // (nbody, 3)
  const T* body_quat;  // (nbody, 4)
  const T* jnt_pos;    // (njnt, 3)
  const T* jnt_axis;   // (njnt, 3)
  const T* qpos0;      // (nq,)
  const T* site_pos;   // (nsite, 3)
};

template <typename T>
struct Outputs {
  T* xpos;       // (F, nbody, 3)
  T* xquat;      // (F, nbody, 4)
  T* site_xpos;  // (F, nsite, 3)
  T* xanchor;    // (F, njnt, 3)
  T* xaxis;      // (F, njnt, 3)
};

__host__ __device__ inline int frame_elems(const Dims& d) {
  return d.nq + 7 * d.nbody + 6 * d.njnt + 3 * d.nsite;
}

// ops/quat.py's formulas, term for term.
template <typename T>
__device__ inline void cross(const T* u, const T* v, T* out) {
  out[0] = u[1] * v[2] - u[2] * v[1];
  out[1] = u[2] * v[0] - u[0] * v[2];
  out[2] = u[0] * v[1] - u[1] * v[0];
}

// v + 2 (w (u x v) + u x (u x v))
template <typename T>
__device__ inline void rotate(const T* q, const T* v, T* out) {
  T uv[3], uuv[3];
  cross(q + 1, v, uv);
  cross(q + 1, uv, uuv);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = v[c] + T(2) * (q[0] * uv[c] + uuv[c]);
}

template <typename T>
__device__ inline void qmul(const T* a, const T* b, T* out) {
  const T w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  const T x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  const T y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  const T z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  out[0] = w, out[1] = x, out[2] = y, out[3] = z;
}

// mju_normalize4: a norm under mjMINVAL (1e-15) gives the identity.
template <typename T>
__device__ inline void normalize(T* q) {
  const T n2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  if (n2 < T(1e-30)) {
    q[0] = T(1), q[1] = q[2] = q[3] = T(0);
    return;
  }
  const T n = sqrt(n2);
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = q[c] / n;
}

__device__ inline void sin_cos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ inline void sin_cos(double x, double* s, double* c) { sincos(x, s, c); }

template <typename T>
__device__ inline void load3(const T* p, T* v) {
  v[0] = __ldg(p), v[1] = __ldg(p + 1), v[2] = __ldg(p + 2);
}

template <typename T>
__device__ inline void copy_out(T* __restrict__ dst, const T* src, int n, int lane) {
  for (int i = lane; i < n; i += 32) dst[i] = src[i];
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fk_jump_kernel(const int* __restrict__ tab, Dims d, Params<T> p, const T* __restrict__ qpos,
               Outputs<T> out, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t f = (int64_t)blockIdx.x * kWarps + warp;
  if (f >= F) return;

  T* qp = reinterpret_cast<T*>(smem) + (size_t)warp * frame_elems(d);
  T* pos = qp + d.nq;            // (nbody, 3)
  T* quat = pos + 3 * d.nbody;   // (nbody, 4)
  T* site = quat + 4 * d.nbody;  // (nsite, 3)
  T* anc = site + 3 * d.nsite;   // (njnt, 3): parent frame, then world
  T* axs = anc + 3 * d.njnt;     // (njnt, 3)

  const int bcols = 2 + 3 * d.nslot;
  const int* order = tab + d.nbody * bcols;  // bodies 1.. by depth level
  const int* level_start = order + (d.nbody - 1);
  const int* jrows = level_start + d.nlevel + 1;  // (njnt, 2): body, type
  const int* site_body = jrows + 2 * d.njnt;

  copy_out(qp, qpos + f * d.nq, d.nq, lane);
  __syncwarp();

  // Local pass: each body relative to its parent.
  for (int b = lane; b < d.nbody; b += 32) {
    T t[3] = {T(0), T(0), T(0)}, q[4] = {T(1), T(0), T(0), T(0)};
    if (b > 0) {
      load3(p.body_pos + 3 * b, t);
#pragma unroll
      for (int c = 0; c < 4; ++c) q[c] = __ldg(p.body_quat + 4 * b + c);
      const int* row = tab + b * bcols + 2;
      for (int s = 0; s < d.nslot; ++s) {
        const int type = __ldg(row + 3 * s);
        if (type == kNone) break;  // a body's slots are packed
        const int qa = __ldg(row + 3 * s + 1);
        const int j = __ldg(row + 3 * s + 2);
        T jpos[3], axis[3];
        load3(p.jnt_pos + 3 * j, jpos);
        load3(p.jnt_axis + 3 * j, axis);
        if (type == kFree) {
          // The frame from qpos; anchor = its translation, axis = the raw axis.
#pragma unroll
          for (int c = 0; c < 3; ++c) t[c] = qp[qa + c], anc[3 * j + c] = t[c], axs[3 * j + c] = axis[c];
#pragma unroll
          for (int c = 0; c < 4; ++c) q[c] = qp[qa + 3 + c];
          normalize(q);
          continue;
        }
        // Anchor and axis in the parent's frame, from the frame before the joint.
        T rj[3], aw[3];
        rotate(q, jpos, rj);
        rotate(q, axis, aw);
#pragma unroll
        for (int c = 0; c < 3; ++c) anc[3 * j + c] = t[c] + rj[c], axs[3 * j + c] = aw[c];
        if (type == kSlide) {
          const T dq = qp[qa] - __ldg(p.qpos0 + qa);
#pragma unroll
          for (int c = 0; c < 3; ++c) t[c] = t[c] + aw[c] * dq;
          continue;
        }
        T local[4];
        if (type == kHinge) {
          const T dq = qp[qa] - __ldg(p.qpos0 + qa);
          T s_, c_;
          sin_cos(T(0.5) * dq, &s_, &c_);
          local[0] = c_;
#pragma unroll
          for (int c = 0; c < 3; ++c) local[1 + c] = axis[c] * s_;
        } else {  // ball
#pragma unroll
          for (int c = 0; c < 4; ++c) local[c] = qp[qa + c];
          normalize(local);
        }
        T turned[4], rt[3];
        qmul(q, local, turned);
        rotate(turned, jpos, rt);
#pragma unroll
        for (int c = 0; c < 3; ++c) t[c] = anc[3 * j + c] - rt[c];
#pragma unroll
        for (int c = 0; c < 4; ++c) q[c] = turned[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) pos[3 * b + c] = t[c];
#pragma unroll
    for (int c = 0; c < 4; ++c) quat[4 * b + c] = q[c];
  }
  __syncwarp();

  // Tree pass: a level's parents are final before the level is composed.
  for (int l = 0; l < d.nlevel; ++l) {
    const int end = __ldg(level_start + l + 1);
    for (int i = __ldg(level_start + l) + lane; i < end; i += 32) {
      const int b = __ldg(order + i);
      const int pa = __ldg(tab + b * bcols);
      T rt[3], qw[4];
      rotate(quat + 4 * pa, pos + 3 * b, rt);
      qmul(quat + 4 * pa, quat + 4 * b, qw);
      normalize(qw);
#pragma unroll
      for (int c = 0; c < 3; ++c) pos[3 * b + c] = pos[3 * pa + c] + rt[c];
#pragma unroll
      for (int c = 0; c < 4; ++c) quat[4 * b + c] = qw[c];
    }
    __syncwarp();
  }

  // Joints: anchors and axes to the world through the parent's frame (a
  // free joint keeps its own).
  for (int j = lane; j < d.njnt; j += 32) {
    if (__ldg(jrows + 2 * j + 1) == kFree) continue;
    const int pa = __ldg(tab + __ldg(jrows + 2 * j) * bcols);
    T ra[3], rx[3];
    rotate(quat + 4 * pa, anc + 3 * j, ra);
    rotate(quat + 4 * pa, axs + 3 * j, rx);
#pragma unroll
    for (int c = 0; c < 3; ++c) anc[3 * j + c] = pos[3 * pa + c] + ra[c], axs[3 * j + c] = rx[c];
  }
  // Sites.
  for (int s = lane; s < d.nsite; s += 32) {
    const int b = __ldg(site_body + s);
    T sp[3], rs[3];
    load3(p.site_pos + 3 * s, sp);
    rotate(quat + 4 * b, sp, rs);
#pragma unroll
    for (int c = 0; c < 3; ++c) site[3 * s + c] = pos[3 * b + c] + rs[c];
  }
  __syncwarp();

  copy_out(out.xpos + f * 3 * d.nbody, pos, 3 * d.nbody, lane);
  copy_out(out.xquat + f * 4 * d.nbody, quat, 4 * d.nbody, lane);
  copy_out(out.site_xpos + f * 3 * d.nsite, site, 3 * d.nsite, lane);
  if (d.njnt > 0) {
    copy_out(out.xanchor + f * 3 * d.njnt, anc, 3 * d.njnt, lane);
    copy_out(out.xaxis + f * 3 * d.njnt, axs, 3 * d.njnt, lane);
  }
}

template <typename T>
int launch(const int* tab, int nbody, int njnt, int nsite, int nq, int nslot, int nlevel,
           const T* qpos, const T* body_pos, const T* body_quat, const T* jnt_pos, const T* jnt_axis,
           const T* qpos0, const T* site_pos, T* xpos, T* xquat, T* site_xpos, T* xanchor, T* xaxis,
           int F, void* stream) {
  if (F == 0) return 0;
  const Dims d{nbody, njnt, nsite, nq, nslot, nlevel};
  if (F < 0 || nbody < 1 || njnt < 0 || nsite < 0 || nq < 0 || nslot < 1 || nlevel < 0 ||
      (size_t)frame_elems(d) * sizeof(T) > (size_t)kMaxFrameBytes)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(kWarps * frame_elems(d) * sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fk_jump_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Params<T> p{body_pos, body_quat, jnt_pos, jnt_axis, qpos0, site_pos};
  const Outputs<T> out{xpos, xquat, site_xpos, xanchor, xaxis};
  const int grid = (int)(((int64_t)F + kWarps - 1) / kWarps);
  fk_jump_kernel<T><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(tab, d, p, qpos, out, F);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest frame state the kernel takes, in bytes (nq + 7 nbody + 6 njnt
// + 3 nsite elements of the dtype).
extern "C" int fk_jump_max_frame_bytes() { return kMaxFrameBytes; }

// tab: kinematics.fk_table's int32 table on the device; every array
// contiguous on the device in one dtype; xanchor / xaxis may be null when
// njnt is 0. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
#define FK_JUMP_ENTRY(NAME, T)                                                                     \
  extern "C" int NAME(const int* tab, int nbody, int njnt, int nsite, int nq, int nslot,         \
                      int nlevel, const T* qpos, const T* body_pos, const T* body_quat,          \
                      const T* jnt_pos, const T* jnt_axis, const T* qpos0, const T* site_pos,    \
                      T* xpos, T* xquat, T* site_xpos, T* xanchor, T* xaxis, int F, void* stream) { \
    return launch<T>(tab, nbody, njnt, nsite, nq, nslot, nlevel, qpos, body_pos, body_quat,       \
                     jnt_pos, jnt_axis, qpos0, site_pos, xpos, xquat, site_xpos, xanchor, xaxis, \
                     F, stream);                                                                   \
  }

FK_JUMP_ENTRY(fk_jump_f32, float)
FK_JUMP_ENTRY(fk_jump_f64, double)
