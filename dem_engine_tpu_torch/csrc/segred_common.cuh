// Shared device code of the owner-segment sums (kernels A and D): a wrench
// row as three float2, its warp shuffles, the segmented warp scan over rows
// grouped by owner, and the three-atomic flush of one owner's partial sum.

#pragma once

#include <cuda_runtime.h>

// Build-time switches. The defaults are the kernels as they ship; only
// tools/segred_variants.py sets another value, to time what a part costs.
#ifndef SEGRED_ATOMICS  // 2: float2 atomics, 1: scalar, 0: none (wrong sums)
#define SEGRED_ATOMICS 2
#endif
#ifndef SEGRED_SCAN_REACH  // how far the scan's rounds reach
#define SEGRED_SCAN_REACH __reduce_max_sync(kFull, dist)
#endif

namespace segred {

constexpr unsigned kFull = 0xffffffffu;

struct Row6 {
  float2 a, b, c;  // [fx fy] [fz tx] [ty tz]
};

__device__ __forceinline__ Row6 zero_row() {
  return Row6{make_float2(0.f, 0.f), make_float2(0.f, 0.f),
              make_float2(0.f, 0.f)};
}

__device__ __forceinline__ void add_row(Row6& x, const Row6& y) {
  x.a.x += y.a.x;
  x.a.y += y.a.y;
  x.b.x += y.b.x;
  x.b.y += y.b.y;
  x.c.x += y.c.x;
  x.c.y += y.c.y;
}

// Row `src` of a (rows, 6) f32 array whose base is 8-byte aligned: rows are
// 24 B, so each float2 of a row is aligned.
__device__ __forceinline__ Row6 load_row(const float* __restrict__ rec,
                                         long long src) {
  const float2* r = reinterpret_cast<const float2*>(rec + src * 6);
  return Row6{__ldg(r), __ldg(r + 1), __ldg(r + 2)};
}

__device__ __forceinline__ Row6 shfl_up_row(const Row6& v, int off) {
  Row6 o;
  o.a.x = __shfl_up_sync(kFull, v.a.x, off);
  o.a.y = __shfl_up_sync(kFull, v.a.y, off);
  o.b.x = __shfl_up_sync(kFull, v.b.x, off);
  o.b.y = __shfl_up_sync(kFull, v.b.y, off);
  o.c.x = __shfl_up_sync(kFull, v.c.x, off);
  o.c.y = __shfl_up_sync(kFull, v.c.y, off);
  return o;
}

__device__ __forceinline__ Row6 shfl_row(const Row6& v, int src_lane) {
  Row6 o;
  o.a.x = __shfl_sync(kFull, v.a.x, src_lane);
  o.a.y = __shfl_sync(kFull, v.a.y, src_lane);
  o.b.x = __shfl_sync(kFull, v.b.x, src_lane);
  o.b.y = __shfl_sync(kFull, v.b.y, src_lane);
  o.c.x = __shfl_sync(kFull, v.c.x, src_lane);
  o.c.y = __shfl_sync(kFull, v.c.y, src_lane);
  return o;
}

// Segmented inclusive scan over the 32 rows a warp holds, one per lane.
// Lanes with equal `id` are contiguous (rows grouped by owner); a lane
// with id < 0 holds no row. On return the last lane of each run holds the
// run's sum, and the result says whether this lane is such a last lane.
// The run heads come from one ballot, so a lane knows its distance to its
// head without comparing ids in every round, and the rounds stop at the
// longest run of the step: three rounds for the bed's ~7 rows per owner,
// five only where one owner fills the step.
__device__ __forceinline__ bool seg_scan(int id, int lane, Row6& v) {
  const int prev = __shfl_up_sync(kFull, id, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != id);
  const int head = 31 - __clz(heads & (kFull >> (31 - lane)));
  const int dist = id >= 0 ? lane - head : 0;
  const int reach = SEGRED_SCAN_REACH;
  for (int off = 1; off <= reach; off <<= 1) {
    const Row6 o = shfl_up_row(v, off);
    if (dist >= off) add_row(v, o);
  }
  return lane == 31 || ((heads >> 1 >> lane) & 1u);
}

// out[owner] += v with three float2 atomics (sm_90 adds a float2 in one
// instruction; `out` is 8-byte aligned and its rows are 24 B).
__device__ __forceinline__ void atomic_add_row(float* out, int owner,
                                               const Row6& v) {
#if SEGRED_ATOMICS == 2
  float2* p = reinterpret_cast<float2*>(out + (long long)owner * 6);
  atomicAdd(p, v.a);
  atomicAdd(p + 1, v.b);
  atomicAdd(p + 2, v.c);
#elif SEGRED_ATOMICS == 1
  float* p = out + (long long)owner * 6;
  const float x[6] = {v.a.x, v.a.y, v.b.x, v.b.y, v.c.x, v.c.y};
  for (int k = 0; k < 6; ++k) atomicAdd(p + k, x[k]);
#else  // keeps the sums alive for the compiler, adds nothing
  if (v.a.x == 1234.5f) atomicAdd(out + (long long)owner * 6, v.a.x);
#endif
}

}  // namespace segred
