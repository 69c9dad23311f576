// Kernel A: owner-segment wrench sums of one contact table, both sides in
// one launch: rows (cap, 6) grouped by owner -> out (n_owners, 6).
//
// Replaces dem_engine_tpu/ops/pallas_segred.py seg_sum_sorted_blocks
// (_make_block_kernel), which sums owner-sorted rows by one-hot matmuls
// over blocks of 512 owners on the TPU's matrix unit; the caller there
// (ops/forces.py reduce_wrench_segment) runs it once per side and adds.
//
// What bounds it on the H100: device-memory bandwidth. Per live row it
// reads 24 B of wrench + 4 B of owner id (+ 4 B of perm index on the B
// side, whose 24 B row is gathered); per dead row 4 B; per owner it adds
// 24 B. The arithmetic is 6 adds per row.
//
// Design, and what each part is for on this card:
// - One launch per table. The first blocks of the grid sum the A side
//   (rec_a under own_a), the rest the B side (rec_b[perm_b] under
//   own_b_sorted), into the same output with atomics. The caller zeroes
//   the output once per step (zero_out on the step's first table) and
//   the second table adds onto it, so a step is one memset and two
//   launches.
// - One warp per span of 256 contiguous rows, in 4 groups of 2 steps of
//   32 rows. The rows of a whole group are requested before any is used
//   (6 float2 loads per lane in flight), and the next group's ids and
//   perm entries are requested before this group's scan, so a warp waits
//   for device memory once per group, not two or three times per step.
//   Short spans and many warps beat long ones: a warp's steps depend on
//   each other, and at 1,024 rows per warp the same code took a fifth
//   longer on the bed's SS table (tools/segred_variants.py).
// - A step whose ids are all dead does no scan, and a warp stops at its
//   first group that starts with an all-dead step: dead rows trail the
//   live ones on both sides. forces.finalize_table sorts both orders with
//   dead rows last, ContactTable.grown appends dead rows and
//   ContactTable.shrunk keeps the head; the wrapper states it as the
//   contract. On the bed 1.3M of 3.1M rows are dead, and the stop is worth
//   4 us of the SS table's 63 (tools/segred_variants.py). Dead rows
//   anywhere else in a span (a dead step after a live one, a tail that
//   begins inside a group) are skipped by the ballot alone.
// - Within a step, segred::seg_scan sums each owner's rows (equal ids are
//   contiguous). The last lane of a run flushes it with three float2
//   atomics. The run open at lane 31 is carried into the next step only
//   where that step begins with the same owner, which the prefetched ids
//   tell, so an ordinary owner (a few rows) costs one flush.
// - The run that reaches the end of a warp's span is not flushed by the
//   warp: the 8 warps of a block hold 2,048 contiguous rows, and one more
//   scan over their 8 span-end runs joins those of one owner. The floor
//   plane, which holds every row of its table's B side, costs one flush
//   per 2,048 rows.
// Atomics make the order of float additions vary from run to run
// (tolerance 1e-5 of the largest |sum| against the float64 sum).

#include <cuda_runtime.h>

#include "segred_common.cuh"

namespace {

using segred::kFull;
using segred::Row6;

// Build-time switches, as in segred_common.cuh: the defaults ship.
#ifndef SEGRED_WARPS
#define SEGRED_WARPS 8
#endif
#ifndef SEGRED_STEPS
#define SEGRED_STEPS 2
#endif
#ifndef SEGRED_GROUPS
#define SEGRED_GROUPS 4
#endif
#ifndef SEGRED_BLOCK_MERGE  // 0: a warp flushes its span-end run itself
#define SEGRED_BLOCK_MERGE 1
#endif
#ifndef SEGRED_EARLY_STOP  // 0: a warp walks its whole span
#define SEGRED_EARLY_STOP 1
#endif

constexpr int kWarpsPerBlock = SEGRED_WARPS;
constexpr int kSteps = SEGRED_STEPS;    // 32-row steps loaded together
constexpr int kGroups = SEGRED_GROUPS;  // groups per warp
constexpr long long kSpan = 32LL * kSteps * kGroups;

struct Side {
  const float* rec;
  const int* ids;
  const int* perm;  // null: row j reads rec[j]
  int cap;
};

// Owner id (-1 where dead or past the end) and source row of the rows
// base + 32 s + lane.
__device__ __forceinline__ void load_keys(const Side& sd, long long base,
                                          int lane, int n_owners,
                                          int (&id)[kSteps],
                                          int (&src)[kSteps]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long long row = base + s * 32 + lane;
    int raw = -1, from = 0;
    if (row < sd.cap) {
      raw = __ldg(sd.ids + row);
      from = sd.perm ? __ldg(sd.perm + row) : (int)row;
    }
    id[s] = (unsigned)raw < (unsigned)n_owners ? raw : -1;
    src[s] = from;
  }
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    seg_sum_pair_kernel(Side side_a, Side side_b, long long warps_a,
                        int n_owners, float* __restrict__ out) {
  __shared__ int tail_id[kWarpsPerBlock];
  __shared__ Row6 tail[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp_in_block = threadIdx.x >> 5;
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + warp_in_block;
  const bool first = warp < warps_a;  // uniform over the block
  const Side sd = first ? side_a : side_b;
  const long long span0 = (first ? warp : warp - warps_a) * kSpan;

  // the run that reaches the last row of this warp's span, kept by lane 31
  int my_tail_id = -1;
  Row6 my_tail = segred::zero_row();
  if (span0 < sd.cap) {
    int id[kSteps], src[kSteps];
    load_keys(sd, span0, lane, n_owners, id, src);
    bool open = false;  // lane 31's run of the previous step goes on here
    Row6 carry = segred::zero_row();
    for (int g = 0; g < kGroups; ++g) {
      unsigned live[kSteps];
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        live[s] = __ballot_sync(kFull, id[s] >= 0);
#if SEGRED_EARLY_STOP
      if (live[0] == 0) break;  // dead rows trail: nothing live follows
#endif
      Row6 v[kSteps];
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        v[s] = id[s] >= 0 ? segred::load_row(sd.rec, src[s])
                          : segred::zero_row();
      int id_next[kSteps], src_next[kSteps];
      const bool last_group = g + 1 == kGroups;
      if (!last_group) {
        load_keys(sd, span0 + (long long)(g + 1) * 32 * kSteps, lane,
                  n_owners, id_next, src_next);
      } else {
#pragma unroll
        for (int s = 0; s < kSteps; ++s) id_next[s] = -1, src_next[s] = 0;
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (live[s] == 0) continue;
        // a run is left open only where the next row has its owner, so
        // lane 0 of the next step takes it up
        if (open && lane == 0) segred::add_row(v[s], carry);
        const bool last_of_run = segred::seg_scan(id[s], lane, v[s]);
        const int id31 = __shfl_sync(kFull, id[s], 31);
        const int after = __shfl_sync(
            kFull, s + 1 < kSteps ? id[s + 1] : id_next[0], 0);
        open = id31 >= 0 && id31 == after;
        const bool span_end = SEGRED_BLOCK_MERGE && last_group &&
                              s + 1 == kSteps && lane == 31;
        if (id[s] >= 0 && span_end) {
          my_tail_id = id[s];
          my_tail = v[s];
        } else if (id[s] >= 0 && last_of_run && !(open && lane == 31)) {
          segred::atomic_add_row(out, id[s], v[s]);
        }
        if (open) carry = segred::shfl_row(v[s], 31);
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        id[s] = id_next[s], src[s] = src_next[s];
    }
  }
  // The runs that reach their spans' ends meet here: the block's spans are
  // contiguous rows of one side, so equal ids of neighbouring warps are
  // one run (a span between two such ends is that owner's throughout),
  // and one more scan over the warps' tails flushes it once per block.
  if (lane == 31) {
    tail_id[warp_in_block] = my_tail_id;
    tail[warp_in_block] = my_tail;
  }
  __syncthreads();
  if (warp_in_block == 0) {
    const bool has = lane < kWarpsPerBlock;
    const int id = has ? tail_id[lane] : -1;
    Row6 v = has ? tail[lane] : segred::zero_row();
    if (segred::seg_scan(id, lane, v) && id >= 0)
      segred::atomic_add_row(out, id, v);
  }
}

long long warps_of(int cap) { return (cap + kSpan - 1) / kSpan; }

}  // namespace

// Sums side A (rec_a under ids_a) and side B (rec_b under ids_b) into out
// (n_owners, 6); either side may have cap 0, and either perm may be null.
// With zero_out the output is zeroed first, else the sums add onto it.
extern "C" int dem_seg_sum_pair(const float* rec_a, const int* ids_a,
                                const int* perm_a, int cap_a,
                                const float* rec_b, const int* ids_b,
                                const int* perm_b, int cap_b, int n_owners,
                                float* out, int zero_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (zero_out)
    cudaMemsetAsync(out, 0, sizeof(float) * 6 * (size_t)n_owners, s);
  // side A's warps fill whole blocks, so a block serves one side
  const long long warps_a =
      (warps_of(cap_a) + kWarpsPerBlock - 1) / kWarpsPerBlock * kWarpsPerBlock;
  const long long warps = warps_a + warps_of(cap_b);
  if (warps > 0) {
    const int blocks = (int)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
    seg_sum_pair_kernel<<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
        Side{rec_a, ids_a, perm_a, cap_a}, Side{rec_b, ids_b, perm_b, cap_b},
        warps_a, n_owners, out);
  }
  return (int)cudaGetLastError();
}
