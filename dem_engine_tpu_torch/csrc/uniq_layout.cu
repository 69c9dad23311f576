// The lists launch: kernel B-ub's per-block unique-fetch lists, built once
// per refresh for both owner-sorted layouts of the SS table.
//
// Replaces dem_engine_tpu/ops/forces.py _uniq_layout (XLA in the JAX
// package: a global sort of a (block, other owner) key over every row,
// then cumsum, cummax and scatters), which the JAX package runs once per
// layout. The port ran that tensor code twice per refresh too, ~10 ms at
// 262,144 clumps, more than kernel B-ub saves in K = 25 steps.
//
// What bounds it on the H100: issue, not bytes. The bytes are small (each
// live row's two owner ids, perm_b and one gather in the B layout; uidx
// and the lists out: ~25 MB at 1.8M rows, 8 us at 3.35 TB/s), but each
// block's distinct other owners come from a sort: 4,098 bitonic sorts of
// ~1,024 keys, 55 compare-exchange steps each with a barrier (0.22 ms at
// 262,144 owners; a warp merging each block's runs, its first form, took
// 0.37 ms, one dependent step per distinct owner).
//
// Design: one CTA per (layout, block of OB = 128 owners). Rows are sorted
// by (own, other), so a block's rows are one contiguous range; three warps
// find its ends (and the first dead row) by 32-ary searches of the own ids,
// ~5 rounds of one load per lane instead of ~22 dependent loads. The CTA
// loads the range's (other owner, row) keys into shared memory, sorts them
// (bitonic, up to kSort rows), flags each first occurrence of an other owner
// and scans the flags: a row's rank is its other owner's position among the
// block's distinct ones in ascending order, as _uniq_layout ranks them. The
// A layout writes uidx = min(rank, ub - 1), the list slot of each distinct
// owner while rank < ub, and n_owners in the slots past the block's count.
// A block of more than kSort rows takes a slower path in the same CTA: warp
// 0 merges the block's per-owner runs (each sorted by the other owner)
// through L2, taking the warp's least head per step. The B layout
// (own_b_sorted against own_a[perm_b]) only counts: the step computes each
// contact once from the A layout, but uniq_max covers both layouts, as the
// JAX package's two-pass kernel needs, so that OVF_UNIQ rises on the same
// scenes. The A-layout CTAs also write the block row starts (blk_start,
// NB + 1 entries, the last being the first dead row) that kernel B-ub reads
// instead of searching, and zero the dead rows' uidx. Every CTA takes its
// count into uniq_max by one atomicMax; the C entry zeroes that word first
// (a 4-byte memset), so the lists cost one memset and one launch per
// refresh and share no state between launches: two launches on two streams
// overlap safely.

#include <cuda_runtime.h>

#include <climits>

#ifndef LISTS_SORT
#define LISTS_SORT 2048  // rows a CTA sorts in shared memory
#endif

namespace {

constexpr int kOB = 128;       // owners per block (ops/fused_force.py OB)
constexpr int kThreads = 256;  // threads of a CTA
constexpr int kSort = LISTS_SORT;
constexpr unsigned kInf = 0xffffffffu;
constexpr unsigned long long kPad = ~0ull;  // sorts after every key

struct Task {
  const int* own;    // reducing-side owner per row (sorted)
  const int* oth;    // other-side owner per row (A layout), or
  const int* perm;   // through perm into own_a (B layout, oth == nullptr)
  const int* own_a;
  bool a_side;
};

// own id of row j as the sort saw it: dead A rows (-1) sort last
__device__ __forceinline__ int own_key(const Task& t, int j) {
  const int v = __ldg(t.own + j);
  return (t.a_side && v < 0) ? INT_MAX : v;
}

__device__ __forceinline__ unsigned other_of(const Task& t, int j) {
  return t.oth ? (unsigned)__ldg(t.oth + j)
               : (unsigned)__ldg(t.own_a + __ldg(t.perm + j));
}

// first row whose key is >= key, by one warp: each round samples 32 evenly
// spaced rows of [lo, hi) and keeps the interval between the last sample
// below the key and the first one not below it
__device__ int warp_lower_bound(const Task& t, int cap, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = cap;  // rows < lo are below the key, rows >= hi are not
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = min(lo + (lane + 1) * step - 1, hi - 1);
    const int c =
        __popc(__ballot_sync(0xffffffffu, own_key(t, p) < key));
    const int lo2 = c ? min(lo + c * step - 1, hi - 1) + 1 : lo;
    hi = c < 32 ? min(lo + (c + 1) * step - 1, hi - 1) : hi;
    lo = lo2;
  }
  const bool below = lo + lane < hi && own_key(t, lo + lane) < key;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// the slower path, warp 0 alone, for a block of more rows than kSort: merge
// its per-owner runs, four owners a lane; each step takes the warp's least
// head, the block's next distinct other owner. Returns the distinct count.
__device__ int merge_runs(const Task& t, int r_lo, int count, int lo_own,
                          int ub, float* __restrict__ uidx,
                          int* __restrict__ uniq_blk, int* seg) {
  const int lane = threadIdx.x & 31;
  for (int o = lane; o < 2 * kOB; o += 32) seg[o] = 0;
  __syncwarp();
  for (int i = lane; i < count; i += 32) {  // run start, then run end
    const int j = r_lo + i;
    const int me = __ldg(t.own + j);
    if (i == 0 || __ldg(t.own + j - 1) != me) seg[me - lo_own] = i;
    if (i == count - 1 || __ldg(t.own + j + 1) != me) {
      seg[kOB + me - lo_own] = i + 1;
    }
  }
  __syncwarp();
  int p[4], e[4];
  unsigned h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p[k] = seg[lane + 32 * k];
    e[k] = seg[kOB + lane + 32 * k];
    h[k] = p[k] < e[k] ? other_of(t, r_lo + p[k]) : kInf;
  }
  int r = 0;
  while (true) {
    const unsigned m = __reduce_min_sync(
        0xffffffffu, min(min(h[0], h[1]), min(h[2], h[3])));
    if (m == kInf) break;
    const float rank = (float)min(r, ub - 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      while (h[k] == m) {
        if (t.a_side) uidx[r_lo + p[k]] = rank;
        ++p[k];
        h[k] = p[k] < e[k] ? other_of(t, r_lo + p[k]) : kInf;
      }
    }
    if (t.a_side && lane == 0 && r < ub) uniq_blk[r] = (int)m;
    ++r;
  }
  return r;
}

// inclusive scan of v over the CTA; *total gets the CTA's sum
__device__ __forceinline__ int cta_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? s_warp[w] : 0;
    all += s_warp[w];
  }
  __syncthreads();  // s_warp is reused by the next call
  *total = all;
  return before + v;
}

__global__ void __launch_bounds__(kThreads)
uniq_layout_kernel(const int* __restrict__ own_a,
                   const int* __restrict__ own_b,
                   const int* __restrict__ own_b_sorted,
                   const int* __restrict__ perm_b, int cap, int n_owners,
                   int n_blocks, int ub, float* __restrict__ uidx,
                   int* __restrict__ uniq, int* __restrict__ blk_start,
                   int* __restrict__ umax) {
  __shared__ unsigned long long s_key[kSort];  // (other << 32) | local row
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_rng[3];
  __shared__ int s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int task = blockIdx.x;
  const bool a_side = task < n_blocks;
  const Task t{a_side ? own_a : own_b_sorted, a_side ? own_b : nullptr,
               perm_b, own_a, a_side};
  const int blk = a_side ? task : task - n_blocks;
  const int lo_own = blk * kOB;
  const int hi_own = min(lo_own + kOB, n_owners);
  int* uniq_blk = uniq + (long long)blk * ub;

  if (warp < (a_side ? 3 : 2)) {
    const int r = warp_lower_bound(
        t, cap, warp == 0 ? lo_own : warp == 1 ? hi_own : n_owners);
    if (lane == 0) s_rng[warp] = r;
  }
  __syncthreads();
  const int r_lo = s_rng[0], r_hi = s_rng[1];
  const int count = r_hi - r_lo;
  if (a_side) {
    if (tid == 0) {
      blk_start[blk] = r_lo;
      if (blk == n_blocks - 1) blk_start[n_blocks] = r_hi;
    }
    for (long long j = s_rng[2] + (long long)blk * kThreads + tid; j < cap;
         j += (long long)n_blocks * kThreads) {
      uidx[j] = 0.f;
    }
  }

  int distinct = 0;
  if (count <= kSort) {
    int n_pow2 = 1;
    while (n_pow2 < count) n_pow2 <<= 1;
    for (int i = tid; i < n_pow2; i += kThreads) {
      s_key[i] = i < count
                     ? ((unsigned long long)other_of(t, r_lo + i) << 32) | i
                     : kPad;
    }
    __syncthreads();
    for (int k = 2; k <= n_pow2; k <<= 1) {  // bitonic sort, ascending
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < n_pow2; i += kThreads) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const unsigned long long a = s_key[i], b = s_key[ixj];
            if ((a > b) == ((i & k) == 0)) {
              s_key[i] = b;
              s_key[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    // rank = distinct other owners up to and including this row's, less 1
    for (int base = 0; base < count; base += kThreads) {
      const int i = base + tid;
      const unsigned long long key = i < count ? s_key[i] : kPad;
      const unsigned other = (unsigned)(key >> 32);
      const bool first =
          i < count && (i == 0 || (unsigned)(s_key[i - 1] >> 32) != other);
      int total;
      const int rank = distinct + cta_scan(first, s_warp, &total) - 1;
      if (a_side && i < count) {
        uidx[r_lo + (int)(unsigned)key] = (float)min(rank, ub - 1);
        if (first && rank < ub) uniq_blk[rank] = (int)other;
      }
      distinct += total;
    }
  } else {
    if (warp == 0) {
      const int r = merge_runs(t, r_lo, count, lo_own, ub, uidx, uniq_blk,
                               reinterpret_cast<int*>(s_key));
      if (lane == 0) s_count = r;
    }
    __syncthreads();
    distinct = s_count;
  }
  if (a_side) {
    for (int s = distinct + tid; s < ub; s += kThreads) uniq_blk[s] = n_owners;
  }

  if (tid == 0) atomicMax(umax, distinct);
}

}  // namespace

extern "C" int dem_uniq_layout(const int* own_a, const int* own_b,
                               const int* own_b_sorted, const int* perm_b,
                               int cap, int n_owners, int ub, float* uidx,
                               int* uniq, int* blk_start, int* umax,
                               void* stream) {
  if (n_owners <= 0 || ub <= 0) return (int)cudaErrorInvalidValue;
  const int n_blocks = (n_owners + kOB - 1) / kOB;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(umax, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  uniq_layout_kernel<<<2 * n_blocks, kThreads, 0, st>>>(
      own_a, own_b, own_b_sorted, perm_b, cap, n_owners, n_blocks, ub, uidx,
      uniq, blk_start, umax);
  return (int)cudaGetLastError();
}
