// Kernel B: the fused sphere-sphere Hertz-Mindlin force pass, in three
// forms that share one device function per contact row (hertz_row):
//   B        fused_hertz_kernel, each row gathers both owners' records;
//   B-ub     fused_hertz_ub_kernel, the B owners' records come from a
//            per-block unique list staged in shared memory;
//   B-extras either launch with the three per-contact query outputs
//            (force, torque-only force, contact point) written as well.
//
// Replaces dem_engine_tpu/ops/pallas_force.py fused_hertz_pass
// (_make_kernel, math in _hertz_rows_real) with its `extras` and `ub`
// variants. fused_step_ss runs that kernel twice per step on the TPU:
// once over the own_a-sorted layout and once over the own_b-sorted copy,
// because a TPU grid reduces one owner side per pass.
//
// What bounds it on the H100: device-memory traffic. Per contact row it
// streams 64 B of statics (field-major, coalesced), 16 B of wildcards in
// and 16 B out, writes two 24 B wrench rows, and gathers two 64 B
// kinematic records (B: one per owner and row; rows of one A owner are
// adjacent, so those mostly hit in L2): ~150 B streamed plus the gathers
// against ~200 flops. The extras add 36 B written per row.
//
// Design: one thread per contact row of the own_a-sorted table computes the
// contact ONCE and writes both sides' wrench rows [force, body-frame
// torque]; kernel A (segred.cu) sums them per owner. The TPU kernel's
// one-hot matrix-unit fetch/reduce, bf16x3 split, owner-block grid with
// shared-chunk double visits, double-buffered DMA and B-sorted wildcard
// copy are not carried over: a gather is a plain load here, and computing
// each contact once halves the arithmetic and the statics traffic.
//
// B-ub keeps what the TPU `ub` variant keeps out of device memory: the
// per-contact random gather of the B record becomes one gather per
// distinct (block, B owner). On this card that saves no device-memory
// bytes: krec (262,145 owners x 64 B = 16.8 MB) fits in the 50 MB L2, so
// kernel B's gathers are already L2 hits, and B-ub is bounded like B, by
// the rows' streamed statics, wildcards and outputs. What it must not do is
// add latency in front of them. Its first form did: one block per 128 A
// owners ran two binary searches of own_a, filled 40 KB of shared memory
// and synchronised before its first row, and dead-tail blocks searched
// again. The design now: persistent CTAs (three per SM, 256 threads) walk
// the owner blocks, CTA c taking blocks c, c + G, c + 2G, ... so that the
// CTAs stream neighbouring rows of the field-major arrays at any moment, as
// kernel B's grid does (a contiguous range per CTA read 8 % slower). Each
// block's rows [blk_start[b], blk_start[b+1]) come from the lists launch
// (csrc/uniq_layout.cu) instead of a search. A two-stage shared-memory
// ring holds a block's unique B records (the first kStageB = 384 list
// slots, 24 KB, copied only where a slot holds an owner); block b + G's
// records arrive by cp.async while block b's rows run, and
// cp.async.wait_group plus one barrier per block gate them. A records come
// through L1: a block's rows share its 128 A owners (staging them as well
// read the same). A row whose rank is past kStageB (the bed's blocks hold
// at most 319 distinct B owners) reads its record through L2. Each CTA
// first zeroes its share of the dead tail [blk_start[NB], cap), while its
// first block's copies land. Both kernels run hertz_row on bit-equal
// records, so their outputs are bit-equal. B-ub still trails B (0.145
// against 0.128 ms of device time on the API's table, H100 80GB HBM3 at
// 700 W), and not for its row shares: giving each CTA an equal share of
// rows in 256-row chunks, with a tagged ring of blocks, read slower (0.154
// against 0.144 ms in one run). The barrier per block is untested as the
// cause.
//
// The math follows dem_engine_tpu/models/hertz.py with the refresh-time
// premix of forces.finalize_table (m_eff, t_col_eff, E_eff, G_eff, beta in
// the statics). IEEE sqrt and division (no --use_fast_math); FMA
// contraction is allowed, so results differ from the plain version in the
// last bits (owner wrench tolerance 2e-4, wildcards 1e-3).

#include <cuda_runtime.h>

// build-time switches of B-ub (tools/redesign_variants.py builds others)
#ifndef UB_STAGE_B
#define UB_STAGE_B 384  // unique B records staged per owner block
#endif
#ifndef UB_THREADS
#define UB_THREADS 256  // threads of a persistent CTA
#endif
#ifndef UB_CTAS_PER_SM
#define UB_CTAS_PER_SM 3  // persistent CTAs per SM
#endif

namespace {

constexpr float kTiny = 1e-12f;
constexpr float kTwoSqrt56 = 1.8257418583505538f;  // 2 * sqrt(5/6)
constexpr float kTwoThirds = 0.6666666666666666f;
constexpr int kFstatW = 16;
constexpr int kOB = 128;         // A owners per block of B-ub
constexpr int kStageB = UB_STAGE_B;        // unique B records staged per block
constexpr int kUbThreads = UB_THREADS;     // threads of a persistent B-ub CTA
constexpr int kUbCtasPerSM = UB_CTAS_PER_SM;  // persistent B-ub CTAs per SM

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
// body -> global: t = 2 (q_v x v); v + w t + q_v x t
__device__ __forceinline__ V3 rot(float w, V3 qv, V3 v) {
  V3 t = cross(qv, v) * 2.0f;
  return v + t * w + cross(qv, t);
}
__device__ __forceinline__ V3 rot_inv(float w, V3 qv, V3 v) {
  return rot(w, -qv, v);
}

struct Kin {
  V3 vox, loc, vel, omg;  // omg is world-frame
  float qw;
  V3 qv;
};

// a 16-float kinematic record: vox(3) loc(3) quat(4) vel(3) omg(3)
__device__ __forceinline__ Kin make_kin(float4 a, float4 b, float4 c,
                                        float4 d) {
  Kin k;
  k.vox = v3(a.x, a.y, a.z);
  k.loc = v3(a.w, b.x, b.y);
  k.qw = b.z;
  k.qv = v3(b.w, c.x, c.y);
  k.vel = v3(c.z, c.w, d.x);
  k.omg = v3(d.y, d.z, d.w);
  return k;
}

__device__ __forceinline__ Kin load_kin(const float* __restrict__ krec,
                                        int owner) {
  const float4* r = reinterpret_cast<const float4*>(krec) + 4LL * owner;
  return make_kin(__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3));
}

__device__ __forceinline__ Kin smem_kin(const float4* r) {
  return make_kin(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ void store6(float* __restrict__ p, V3 a, V3 b) {
  p[0] = a.x; p[1] = a.y; p[2] = a.z;
  p[3] = b.x; p[4] = b.y; p[5] = b.z;
}

__device__ __forceinline__ void store3(float* __restrict__ p, V3 a) {
  p[0] = a.x; p[1] = a.y; p[2] = a.z;
}

// Per-row outputs: the wrench rows and wildcards always, the three query
// rows when ext_f is not null (ext_t and ext_cp then are not null either).
struct Outs {
  float* rec_a;
  float* rec_b;
  float* wc_out;
  float* ext_f;
  float* ext_t;
  float* ext_cp;
};

__device__ __forceinline__ void store_dead(const Outs& o, long long j,
                                           int cap, int with_friction) {
  const V3 zero = v3(0.f, 0.f, 0.f);
  store6(o.rec_a + 6 * j, zero, zero);
  store6(o.rec_b + 6 * j, zero, zero);
  if (with_friction) {
#pragma unroll
    for (int k = 0; k < 4; ++k) o.wc_out[(long long)k * cap + j] = 0.f;
  }
  if (o.ext_f) {
    store3(o.ext_f + 3 * j, zero);
    store3(o.ext_t + 3 * j, zero);
    store3(o.ext_cp + 3 * j, zero);
  }
}

// One live contact row: statics s, owner records A and B, the row's
// wildcards (ignored without friction). Writes every output of row j.
__device__ __forceinline__ void hertz_row(const float (&s)[kFstatW],
                                          const Kin& A, const Kin& B,
                                          float w0, float w1, float w2,
                                          float w3, float h, float vs,
                                          int with_friction, const Outs& o,
                                          long long j, int cap) {
  const V3 zero = v3(0.f, 0.f, 0.f);
  const float radA = s[1], radB = s[8];
  const V3 relA = v3(s[2], s[3], s[4]), relB = v3(s[5], s[6], s[7]);
  const float m_eff = s[9], t_col_eff = s[10];
  const float E_eff = s[11], G_eff = s[12], beta = s[13];
  const float mu = s[14], Crr = s[15];

  // B position relative to owner A's CoM (exact voxel-int difference)
  const V3 d = (B.vox - A.vox) * vs + (B.loc - A.loc);
  const V3 rel_a = rot(A.qw, A.qv, relA);
  const V3 pos_b = d + rot(B.qw, B.qv, relB);

  // narrow phase
  const V3 dd = rel_a - pos_b;
  const float dist = sqrtf(dot(dd, dd));
  const float safe = fmaxf(dist, kTiny);
  const V3 b2a = dd * (1.0f / safe);
  const float overlap = radA + radB - dist;
  const V3 cp = pos_b + b2a * (radB - overlap * 0.5f);
  const V3 cp_b = cp - d;
  const bool in_contact = overlap > 0.f;
  const float ovl = fmaxf(overlap, 0.f);

  // contact-point velocities: omg rides world-frame, one cross product
  const V3 va = cross(A.omg, cp);
  const V3 vb = cross(B.omg, cp_b);
  const V3 vel_b2a = (A.vel + va) - (B.vel + vb);
  const float proj = dot(vel_b2a, b2a);
  const V3 vrel_tan = vel_b2a - b2a * proj;

  const float r_eff = radA * radB / fmaxf(radA + radB, kTiny);
  const float sqrt_Rd = sqrtf(ovl * r_eff);
  const float Sn = 2.0f * E_eff * sqrt_Rd;
  const float k_n = kTwoThirds * Sn;
  const float gamma_n = kTwoSqrt56 * beta * sqrtf(Sn * m_eff);
  const float f_n = k_n * ovl + gamma_n * proj;
  V3 force = b2a * f_n;
  V3 torque_only = zero;

  if (with_friction) {
    V3 dtan = v3(w0, w1, w2);
    dtan = dtan + vrel_tan * h;
    const float disp_proj = dot(dtan, b2a);
    dtan = dtan - b2a * disp_proj;
    const float dtime = w3 + h;

    // rolling resistance past the premixed collision time
    const bool past = dtime > t_col_eff;
    const V3 v_rot = vb - va;
    const float v_rot_mag = sqrtf(dot(v_rot, v_rot));
    const float f_mag = sqrtf(dot(force, force));
    if (Crr > 0.f && past && v_rot_mag > kTiny) {
      torque_only = v_rot * (Crr * f_mag / fmaxf(v_rot_mag, kTiny));
    }

    // tangential force with the Coulomb clamp
    const float kt = 8.0f * G_eff * sqrt_Rd;
    const float gt = -kTwoSqrt56 * beta * sqrtf(m_eff * kt);
    V3 tf = dtan * (-kt) - vrel_tan * gt;
    const float ft = sqrtf(dot(tf, tf));
    const float ft_max = f_mag * mu;
    const bool clamp = (ft > ft_max) && (ft > kTiny);
    const float scl = clamp ? ft_max / fmaxf(ft, kTiny) : 1.0f;
    tf = (ft > kTiny) ? tf * scl : zero;
    if (clamp) {
      dtan = (tf + vrel_tan * gt) * (-1.0f / (kt > kTiny ? kt : 1.0f));
    }
    if (mu > 0.f) force = force + tf;
    const bool keep = in_contact;
    o.wc_out[j] = keep ? dtan.x : 0.f;
    o.wc_out[(long long)cap + j] = keep ? dtan.y : 0.f;
    o.wc_out[2LL * cap + j] = keep ? dtan.z : 0.f;
    o.wc_out[3LL * cap + j] = keep ? dtime : 0.f;
  }

  if (!in_contact) {
    force = zero;
    torque_only = zero;
  }
  const V3 f_tot = force + torque_only;
  const V3 tq_a = rot_inv(A.qw, A.qv, cross(cp, f_tot));
  const V3 tq_b = rot_inv(B.qw, B.qv, cross(cp_b, -f_tot));
  store6(o.rec_a + 6 * j, force, tq_a);
  store6(o.rec_b + 6 * j, -force, tq_b);
  if (o.ext_f) {
    // the contact point rides for every live row, margin pairs included
    store3(o.ext_f + 3 * j, force);
    store3(o.ext_t + 3 * j, torque_only);
    store3(o.ext_cp + 3 * j, cp);
  }
}

__device__ __forceinline__ void load_row(const float* __restrict__ fstat,
                                         int cap, long long j,
                                         float (&s)[kFstatW]) {
#pragma unroll
  for (int k = 0; k < kFstatW; ++k) s[k] = fstat[(long long)k * cap + j];
}

__global__ void fused_hertz_kernel(
    const float* __restrict__ fstat, int cap, const float* __restrict__ wx,
    const float* __restrict__ wy, const float* __restrict__ wz,
    const float* __restrict__ wt, const float* __restrict__ krec,
    const int* __restrict__ own_b, float h, float vs, int with_friction,
    Outs o) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap) return;
  float s[kFstatW];
  load_row(fstat, cap, j, s);
  if (!(s[0] >= 0.f)) {  // dead row
    store_dead(o, j, cap, with_friction);
    return;
  }
  const Kin A = load_kin(krec, (int)s[0]);
  const Kin B = load_kin(krec, own_b[j]);
  float w0 = 0.f, w1 = 0.f, w2 = 0.f, w3 = 0.f;
  if (with_friction) {
    w0 = wx[j]; w1 = wy[j]; w2 = wz[j]; w3 = wt[j];
  }
  hertz_row(s, A, B, w0, w1, w2, w3, h, vs, with_friction, o, j, cap);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct UbStage {
  float4 b[4 * kStageB];  // the block's first kStageB unique B records
};

// list slots a thread copies into a stage: slot (tid / 4) + kListStride k
constexpr int kListStride = kUbThreads / 4;
constexpr int kListPer = kStageB / kListStride;

// issue the cp.async copies of the B records of the list slots `lv` (one
// per kListStride-th slot from this thread's) into `st`, skipping empty
// slots
__device__ __forceinline__ void ub_stage(UbStage& st,
                                         const float4* __restrict__ k4,
                                         int n_owners,
                                         const int (&lv)[kListPer]) {
#pragma unroll
  for (int k = 0; k < kListPer; ++k) {
    const int t = threadIdx.x + k * kUbThreads;
    if (lv[k] < n_owners) cp_async16(&st.b[t], k4 + 4LL * lv[k] + (t & 3));
  }
  cp_async_commit();
}

__device__ __forceinline__ void ub_list(const int* __restrict__ uniq,
                                        int blk, int ub, int n_list,
                                        int n_owners, int (&lv)[kListPer]) {
#pragma unroll
  for (int k = 0; k < kListPer; ++k) {
    const int e = (threadIdx.x >> 2) + k * kListStride;
    lv[k] = e < n_list ? __ldg(uniq + (long long)blk * ub + e) : n_owners;
  }
}

__global__ void __launch_bounds__(kUbThreads, kUbCtasPerSM)
fused_hertz_ub_kernel(
    const float* __restrict__ fstat, int cap, const float* __restrict__ wx,
    const float* __restrict__ wy, const float* __restrict__ wz,
    const float* __restrict__ wt, const float* __restrict__ krec,
    int n_owners, const int* __restrict__ blk_start,
    const float* __restrict__ uidx, const int* __restrict__ uniq, int ub,
    int n_blocks, float h, float vs, int with_friction, Outs o) {
  extern __shared__ float4 smem[];
  UbStage* stage = reinterpret_cast<UbStage*>(smem);
  const float4* k4 = reinterpret_cast<const float4*>(krec);
  const int c = blockIdx.x, G = gridDim.x;  // CTA c: blocks c, c + G, ...
  const int n_list = min(ub, kStageB);
  int lv[kListPer];
  if (c < n_blocks) {
    ub_list(uniq, c, ub, n_list, n_owners, lv);
    ub_stage(stage[0], k4, n_owners, lv);
  }
  // this CTA's share of the dead tail, while the first copies land
  const long long stride = (long long)G * kUbThreads;
  for (long long j = __ldg(blk_start + n_blocks) +
                     (long long)blockIdx.x * kUbThreads + threadIdx.x;
       j < cap; j += stride) {
    store_dead(o, j, cap, with_friction);
  }
  for (int b = c, i = 0; b < n_blocks; b += G, ++i) {
    const bool more = b + G < n_blocks;
    if (more) ub_list(uniq, b + G, ub, n_list, n_owners, lv);
    const int lo = __ldg(blk_start + b), hi = __ldg(blk_start + b + 1);
    cp_async_wait_all();
    __syncthreads();  // block b staged; every thread is done with the last
    if (more) ub_stage(stage[(i + 1) & 1], k4, n_owners, lv);
    const UbStage& st = stage[i & 1];
    for (long long j = lo + threadIdx.x; j < hi; j += kUbThreads) {
      float s[kFstatW];
      load_row(fstat, cap, j, s);
      const Kin A = load_kin(krec, (int)s[0]);  // rows share A owners: L1
      const int u = (int)__ldg(uidx + j);
      const Kin B = u < kStageB
                        ? smem_kin(st.b + 4 * u)
                        : load_kin(krec, __ldg(uniq + (long long)b * ub + u));
      float w0 = 0.f, w1 = 0.f, w2 = 0.f, w3 = 0.f;
      if (with_friction) {
        w0 = wx[j]; w1 = wy[j]; w2 = wz[j]; w3 = wt[j];
      }
      hertz_row(s, A, B, w0, w1, w2, w3, h, vs, with_friction, o, j, cap);
    }
  }
}

}  // namespace

extern "C" int dem_fused_hertz(const float* fstat, int cap, const float* wx,
                               const float* wy, const float* wz,
                               const float* wt, const float* krec,
                               const int* own_b, float h, float voxel_size,
                               int with_friction, float* rec_a, float* rec_b,
                               float* wc_out, float* ext_f, float* ext_t,
                               float* ext_cp, void* stream) {
  if (cap > 0) {
    const int threads = 256;
    const int blocks = (int)((cap + threads - 1) / threads);
    const Outs o{rec_a, rec_b, wc_out, ext_f, ext_t, ext_cp};
    fused_hertz_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        fstat, cap, wx, wy, wz, wt, krec, own_b, h, voxel_size,
        with_friction, o);
  }
  return (int)cudaGetLastError();
}

extern "C" int dem_fused_hertz_ub(const float* fstat, int cap,
                                  const float* wx, const float* wy,
                                  const float* wz, const float* wt,
                                  const float* krec, int n_owners,
                                  const int* blk_start, const float* uidx,
                                  const int* uniq, int ub, float h,
                                  float voxel_size, int with_friction,
                                  float* rec_a, float* rec_b, float* wc_out,
                                  float* ext_f, float* ext_t, float* ext_cp,
                                  void* stream) {
  static int n_sm = 0;  // the launches' device, queried once per process
  if (cap > 0 && n_owners > 0) {
    const int smem = (int)(2 * sizeof(UbStage));
    if (n_sm == 0) {
      int dev = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess) {
        e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
      }
      if (e == cudaSuccess) {
        e = cudaFuncSetAttribute(fused_hertz_ub_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      }
      if (e != cudaSuccess) {
        n_sm = 0;
        return (int)e;
      }
    }
    const int n_blocks = (n_owners + kOB - 1) / kOB;
    const int ctas = n_blocks < kUbCtasPerSM * n_sm ? n_blocks
                                                    : kUbCtasPerSM * n_sm;
    const Outs o{rec_a, rec_b, wc_out, ext_f, ext_t, ext_cp};
    fused_hertz_ub_kernel<<<ctas, kUbThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        fstat, cap, wx, wy, wz, wt, krec, n_owners, blk_start, uidx, uniq,
        ub, n_blocks, h, voxel_size, with_friction, o);
  }
  return (int)cudaGetLastError();
}
