// Kernel C: sphere-sphere pair search over the bin-sorted sphere table.
//
// Replaces dem_engine_tpu/ops/pallas_sweep3.py sweep_v3 (_make_kernel)
// together with its XLA decode_hits: on the TPU a tile of sorted spheres
// scans a fixed window of the table staged in VMEM, emits 64-bit hit masks
// per half-shell run, and a separate decode compacts them into pairs. The
// fixed window and the 64-bit masks are why that kernel can overflow
// (OVF_PALLAS_WIN, OVF_BIN_OCC); nothing here has either limit.
//
// What bounds it on the H100: neither bytes nor flops (the table is 38 MB
// at 786,432 spheres, 11 us at 3.35 TB/s; the distance tests are ~10 flops
// per candidate) but latency and issue: ~50 candidates per sphere, each
// found and tested by dependent steps. Its first form ran two launches with
// a scan and a host read of the grid between them, and each sphere did 9
// binary searches of the whole sorted table (~20 dependent loads each),
// twice.
//
// Design: one launch of CTAs of kTile consecutive sorted spheres, one
// thread per sphere. Spheres are in flat-bin order and the half shell
// (self bin + 13 forward neighbours) is 5 runs of consecutive flat bins
// (same row dx 0..+1, the row above dx -1..+1, three rows of the z+1
// layer), each at a fixed flat offset from the sphere's own bin, so each
// run of the whole tile lies in one contiguous slot interval, its window.
// The 10 window ends are found by one warp each, a 32-ary search of ~5
// rounds, not by 9 binary searches per sphere. The windows' records (split
// into [x, y, z, reach] and [owner, family, id] so that a candidate out of
// reach reads 16 bytes) and bin ids are staged in shared memory, up to kWin
// slots; a window past that reads its remainder through L2, so there is no
// window limit. Where the tile spans at most kBins - 2 bins, each window
// gets a table of its bins' first slots, so a sphere finds each run's
// bounds in two shared loads; otherwise by binary search in the staged
// bin ids. Each sphere tests its candidates from shared
// memory and keeps its first kHits hits there. A block-wide exclusive scan
// of the hit counts gives each sphere its offset in the tile; an
// order-preserving single-pass scan across tiles (decoupled look-back;
// CTAs take tiles in order from an atomic ticket, so a tile's predecessors
// are all running and the look-back cannot deadlock) gives the tile its
// global offset. A sphere then writes its hits there (dropped past `cap`,
// still counted), testing its runs once more only if it had more than
// kHits. The tile that takes the last ticket writes the total count. The
// wrapper's buffer (both pair columns, the tile status words, the ticket,
// the count) is set to -1 by one memset before the launch: the pair
// table's unused rows, "no status yet", and the ticket before the first
// tile. Rows, runs and slots are visited in the order of the plain slot
// sweep (binning.sweep_table), so the two produce the same table row for
// row. Shared memory: 512 staged slots, 5 tables of 513 bins and 8 hits
// for each of 256 spheres, ~37 KB a CTA (tools/redesign_variants.py times
// the other choices).
//
// A row is real when its sorted bin is not the sentinel (binning.
// SENTINEL_BIN): padding rows and, in a member table (the two classes of
// the two-class CD), the spheres left out sort into the table's tail with
// that bin, id S and reach -1e30. A tile counts its real rows with one
// __syncthreads_count, takes its bins and windows from them alone, and
// the window searches never reach the tail, whose bin is above every key.
//
// The hit test must give the same bit as the plain version: the squared
// distance is (dx*dx + dy*dy) + dz*dz with every product and sum rounded
// (__fmul_rn/__fadd_rn, so no FMA contraction), as the tensor code
// computes it.

#include <cuda_runtime.h>

#include <climits>

// build-time switches (tools/redesign_variants.py builds other values; the
// wrapper sizes the tile status words by dem_sweep_tile)
#ifndef SWEEP_TILE
#define SWEEP_TILE 256
#endif
#ifndef SWEEP_WIN
#define SWEEP_WIN 512
#endif
#ifndef SWEEP_BINS
#define SWEEP_BINS 512  // bins of a window's start table; 0: no table
#endif
#ifndef SWEEP_HITS
#define SWEEP_HITS 8
#endif

namespace {

constexpr int kTile = SWEEP_TILE;  // sorted spheres (threads) per CTA
constexpr int kWin = SWEEP_WIN;    // window slots staged in shared memory
constexpr int kHits = SWEEP_HITS;  // hits a sphere keeps in shared memory
constexpr int kBins = SWEEP_BINS;  // bins a window's start table covers
constexpr unsigned kNoStatus = 0xffffffffu;  // the memset's status flag
constexpr int kSentinelBin = INT_MAX;  // binning.SENTINEL_BIN
constexpr unsigned kAggregate = 1u, kInclusive = 2u;
__constant__ int kRunDy[5] = {0, 1, -1, 0, 1};
__constant__ int kRunDz[5] = {0, 0, 1, 1, 1};

__device__ __forceinline__ int clamp_key(long long v) {
  return (int)max((long long)INT_MIN + 1, min(v, (long long)INT_MAX - 1));
}

// first slot whose bin is >= key (kUpper: > key), by one warp: each round
// samples 32 evenly spaced slots of [lo, hi) and keeps the interval between
// the last sample below the key and the first one not below it; ~5 rounds
// of one load a lane over the bed's 786,432 slots, not ~20 dependent loads
template <bool kUpper>
__device__ int warp_bound(const int* __restrict__ a, int n, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // slots < lo are below the key, slots >= hi are not
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = min(lo + (lane + 1) * step - 1, hi - 1);
    const int v = __ldg(a + p);
    const int c = __popc(__ballot_sync(0xffffffffu, kUpper ? v <= key
                                                           : v < key));
    const int lo2 = c ? min(lo + c * step - 1, hi - 1) + 1 : lo;
    hi = c < 32 ? min(lo + (c + 1) * step - 1, hi - 1) : hi;
    lo = lo2;
  }
  bool below = false;
  if (lo + lane < hi) {
    const int v = __ldg(a + lo + lane);
    below = kUpper ? v <= key : v < key;
  }
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// one half-shell run's window: global slots [lo, hi), the first `stg`
// staged at `base` in shared memory; its bins lie in [blo, blo + n_bins)
struct Win {
  int lo, hi, base, stg, blo;
};

struct Shared {
  float4 pos[kWin];   // the staged records' [x, y, z, reach]
  float4 meta[kWin];  // and [owner, family, id, 0]
  int bin[kWin];
  // with a table: start[r][b - blo] is run r's first slot whose bin >= b
  int start[5][kBins + 1];
  int hit[kHits * kTile];  // hit i of thread t at [i * kTile + t]
  Win win[5];
  int warp_sum[kTile / 32];
  int tile, prefix;
};

__device__ __forceinline__ int bin_at(const Shared& sh, const Win& w,
                                      const int* __restrict__ gbin,
                                      int slot) {
  const int i = slot - w.lo;
  return i < w.stg ? sh.bin[w.base + i] : __ldg(gbin + slot);
}

// first slot of the window whose bin is >= key (upper: > key)
template <bool kUpper>
__device__ int win_search(const Shared& sh, const Win& w,
                          const int* __restrict__ gbin, int key) {
  int lo = w.lo, hi = w.hi;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int b = bin_at(sh, w, gbin, mid);
    if (kUpper ? b <= key : b < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct Me {
  float px, py, pz, reach, own;
  int fam_row, id;
};

// visit the hits of one run's slots [s0, s1) in slot order
template <class F>
__device__ __forceinline__ void run_hits(const Shared& sh, const Win& w,
                                         const float4* __restrict__ rec,
                                         const unsigned char* __restrict__ fam,
                                         const Me& me, int s0, int s1,
                                         F&& on_hit) {
  for (int slot = s0; slot < s1; ++slot) {
    const int i = slot - w.lo;
    const bool staged = i < w.stg;
    const float4 c0 = staged ? sh.pos[w.base + i] : __ldg(rec + 2LL * slot);
    const float dx = me.px - c0.x, dy = me.py - c0.y, dz = me.pz - c0.z;
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    const float rr = me.reach + c0.w;
    if (!(d2 < __fmul_rn(rr, rr))) continue;
    // owner, family and id only for the few candidates within reach
    const float4 c1 = staged ? sh.meta[w.base + i]
                             : __ldg(rec + 2LL * slot + 1);
    if (c1.x == me.own) continue;
    if (!fam[me.fam_row + (int)c1.y]) continue;
    on_hit((int)c1.z);
  }
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned flag, int value) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      ((unsigned long long)flag << 32) | (unsigned)value;
}

// warp 0 of tile `tile` > 0: the sum of every earlier tile's hits
__device__ int look_back(const unsigned long long* status, int tile) {
  const int lane = threadIdx.x & 31;
  int prefix = 0;
  for (int j = tile - 1;; j -= 32) {
    const int idx = j - lane;
    unsigned long long v = (unsigned long long)kInclusive << 32;
    if (idx >= 0) {
      do {
        v = load_status(status + idx);
      } while ((unsigned)(v >> 32) == kNoStatus);
    }
    const unsigned inc =
        __ballot_sync(0xffffffffu, (unsigned)(v >> 32) == kInclusive);
    // lanes up to the nearest tile that knows its inclusive prefix
    const int stop = inc ? __ffs(inc) - 1 : 31;
    int val = lane <= stop ? (int)(unsigned)v : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) val += __shfl_xor_sync(0xffffffffu, val, o);
    prefix += val;
    if (inc) return prefix;
  }
}

__global__ void __launch_bounds__(kTile)
sweep_kernel(const float4* __restrict__ rec, const int* __restrict__ sbin,
             const int* __restrict__ idx3,
             const unsigned char* __restrict__ fam,
             const int* __restrict__ nbp, int spad, int n_spheres, int cap,
             int n_tiles, int* __restrict__ outA, int* __restrict__ outB,
             unsigned long long* __restrict__ status, int* __restrict__ ticket,
             int* __restrict__ count) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) sh.tile = atomicAdd(ticket, 1) + 1;  // the memset left -1
  __syncthreads();
  const int tile = sh.tile;
  const int k0 = tile * kTile;
  // the tile's real rows: those of a real bin. The sentinel bin sorts
  // last, so padding and the spheres a member table leaves out form the
  // table's tail and a tile's real rows are its first ones
  const int k_lim = min(n_spheres, spad);
  const int k_end = k0 + __syncthreads_count(
      k0 + tid < k_lim && __ldg(sbin + k0 + tid) != kSentinelBin);
  const int nb0 = __ldg(nbp), nb1 = __ldg(nbp + 1), nb2 = __ldg(nbp + 2);

  // the 5 windows' 10 ends (run 0 starts at the tile's first sphere)
  const int b_first = k0 < k_end ? __ldg(sbin + k0) : 0;
  const int b_last = k0 < k_end ? __ldg(sbin + k_end - 1) : 0;
  // every window spans the tile's bins and one more each side, offset;
  // in 64 bits, so that no pair of bins can overflow the difference
  const long long span = (long long)b_last - b_first + 3;
  const bool table = kBins > 0 && span <= kBins;
  const int n_bins = table ? (int)span : 0;
  if (k0 < k_end) {
    for (int e = warp; e < 10; e += kTile / 32) {  // one warp an end
      const int r = e >> 1;
      const long long off =
          (long long)kRunDy[r] * nb0 + (long long)kRunDz[r] * nb0 * nb1;
      int v = k0;
      if (e & 1) {
        v = warp_bound<true>(sbin, spad, clamp_key(b_last + off + 1));
      } else if (r > 0) {
        v = warp_bound<false>(sbin, spad, clamp_key(b_first + off - 1));
      }
      if (lane == 0) (e & 1 ? sh.win[r].hi : sh.win[r].lo) = v;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int used = 0;
    for (int r = 0; r < 5; ++r) {
      Win& w = sh.win[r];
      if (k0 >= k_end) w.lo = w.hi = 0;
      w.hi = max(w.hi, w.lo);
      w.base = used;
      w.stg = min(w.hi - w.lo, kWin - used);
      w.blo = b_first + kRunDy[r] * nb0 + kRunDz[r] * nb0 * nb1 - 1;
      used += w.stg;
    }
  }
  __syncthreads();
  for (int r = 0; r < 5; ++r) {
    const Win w = sh.win[r];
    for (int i = tid; i < w.stg; i += kTile) {
      const long long slot = (long long)w.lo + i;
      sh.pos[w.base + i] = __ldg(rec + 2 * slot);
      sh.meta[w.base + i] = __ldg(rec + 2 * slot + 1);
      sh.bin[w.base + i] = __ldg(sbin + slot);
    }
  }
  __syncthreads();
  if (table) {
    // slot lo + i starts the bins after its predecessor's, up to its own
    for (int r = 0; r < 5; ++r) {
      const Win w = sh.win[r];
      const int n_w = w.hi - w.lo;
      for (int i = tid; i <= n_w; i += kTile) {
        const int prev = i == 0 ? w.blo - 1 : bin_at(sh, w, sbin, w.lo + i - 1);
        const int cur = i == n_w ? w.blo + n_bins : bin_at(sh, w, sbin, w.lo + i);
        for (int b = prev + 1; b <= cur; ++b) sh.start[r][b - w.blo] = w.lo + i;
      }
    }
    __syncthreads();
  }

  // each sphere's runs: bounds by search in the staged bin ids, then its
  // candidates
  const int k = k0 + tid;
  const bool mine = k < k_end;
  int s0[5], s1[5];
  Me me{};
  int n = 0;
  if (mine) {
    const float4 m0 = __ldg(rec + 2LL * k), m1 = __ldg(rec + 2LL * k + 1);
    me = Me{m0.x, m0.y, m0.z, m0.w, m1.x, (int)m1.y * 256, (int)m1.z};
    const int ix = __ldg(idx3 + 3LL * k), iy = __ldg(idx3 + 3LL * k + 1);
    const int iz = __ldg(idx3 + 3LL * k + 2);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      s0[r] = s1[r] = 0;
      const int ty = iy + kRunDy[r], tz = iz + kRunDz[r];
      if (ty < 0 || ty >= nb1 || tz >= nb2) continue;
      const int row = (tz * nb1 + ty) * nb0;
      const Win& w = sh.win[r];
      // run 0 starts in the sphere's own bin, after the sphere itself
      const int b0 = row + max(ix - 1, 0), b1 = row + min(ix + 1, nb0 - 1);
      if (table) {
        s0[r] = r == 0 ? k + 1 : sh.start[r][b0 - w.blo];
        s1[r] = sh.start[r][b1 + 1 - w.blo];
      } else {
        s0[r] = r == 0 ? k + 1 : win_search<false>(sh, w, sbin, b0);
        s1[r] = win_search<true>(sh, w, sbin, b1);
      }
      run_hits(sh, w, rec, fam, me, s0[r], s1[r], [&](int cid) {
        if (n < kHits) sh.hit[n * kTile + tid] = cid;
        ++n;
      });
    }
  }

  // the tile's exclusive scan of the hit counts
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) sh.warp_sum[warp] = incl;
  __syncthreads();
  int before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kTile / 32; ++w) {
    before += w < warp ? sh.warp_sum[w] : 0;
    agg += sh.warp_sum[w];
  }
  // the tile's offset: publish the aggregate, look back, publish the
  // inclusive prefix
  if (warp == 0) {
    int prefix = 0;
    if (tile > 0) {
      if (lane == 0) store_status(status + tile, kAggregate, agg);
      prefix = look_back(status, tile);
    }
    if (lane == 0) {
      store_status(status + tile, kInclusive, prefix + agg);
      sh.prefix = prefix;
      if (tile == n_tiles - 1) *count = prefix + agg;
    }
  }
  __syncthreads();

  const int base = sh.prefix + before + incl - n;
  auto emit = [&](int i, int cid) {
    const int p = base + i;
    if (p < cap) {
      outA[p] = min(me.id, cid);
      outB[p] = max(me.id, cid);
    }
  };
  if (n <= kHits) {
    for (int i = 0; i < n; ++i) emit(i, sh.hit[i * kTile + tid]);
  } else {
    int i = 0;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      run_hits(sh, sh.win[r], rec, fam, me, s0[r], s1[r],
               [&](int cid) { emit(i++, cid); });
    }
  }
}

}  // namespace

// sorted spheres per tile: a search of spad slots takes
// max(1, ceil(spad / tile)) tiles, and its buffer two i32 status words each
extern "C" int dem_sweep_tile() { return kTile; }

extern "C" int dem_sweep(const float* rec, const int* sorted_bin,
                         const int* idx3, const unsigned char* fam_mask,
                         const int* nb, int spad, int n_spheres, int cap,
                         int* buf, void* stream) {
  const int n_tiles = spad > kTile ? (spad + kTile - 1) / kTile : 1;
  // buf: outA (cap), outB (cap), status (n_tiles u64), ticket, count
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t words = 2 * (size_t)cap + 2 * (size_t)n_tiles + 2;
  const cudaError_t e = cudaMemsetAsync(buf, 0xff, words * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  int* status = buf + 2 * (size_t)cap;
  int* ticket = status + 2 * (size_t)n_tiles;
  sweep_kernel<<<n_tiles, kTile, 0, st>>>(
      reinterpret_cast<const float4*>(rec), sorted_bin, idx3, fam_mask, nb,
      spad, n_spheres, cap, n_tiles, buf, buf + cap,
      reinterpret_cast<unsigned long long*>(status), ticket, ticket + 1);
  return (int)cudaGetLastError();
}
