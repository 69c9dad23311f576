// Kernel D: sorted segment sum in an owner window per row tile, with a
// spill flag ((cap, 6) rows -> (n_owners, 6), plus one byte).
//
// Replaces dem_engine_tpu/ops/pallas_segred.py seg_sum_sorted (v1,
// _make_kernel): per TILE-row tile of owner-sorted rows, a one-hot matmul
// against an OWIN-owner window based at b0 = min(floor(min live id / 128)
// * 128, n_pad - OWIN), accumulated into a resident output; a row whose
// owner lies past the window raises the spill flag and adds nothing (the
// caller then falls back, as the JAX function's contract says).
//
// What bounds it on the H100: by bytes, device-memory bandwidth as for
// kernel A (4 B of owner id per row, 24 B of wrench per summed row, 24 B
// per owner written). At the sizes it meets (thousands of rows) the bytes
// take microseconds, and every further launch around the kernel (a memset
// of the output, one of the flag, a compare to read it) costs more than
// they do.
//
// Design: ONE cooperative launch, nothing else on the stream.
// - Phase 1, all blocks: zero the (n_owners, 6) output with 16-byte stores
//   and clear the flag. grid.sync() (cooperative groups; since CUDA 11 the
//   grid barrier needs no relocatable device code, so the kernel links
//   into the plain shared library). The grid is the smaller of what the
//   card keeps resident (occupancy, asked once per window size) and what
//   the zeroing and the tiles can use.
// - Phase 2, grid-stride over tiles: the block finds its window base with
//   a warp min and one shared atomicMin per warp. Each warp then sums its
//   32 contiguous rows by owner with segred::seg_scan and adds one partial
//   per owner run to the (OWIN x 6) window in shared memory: one shared
//   add per run and warp, where a thread per row would make six atomics
//   per row on the same few slots. The spill predicate is ORed across the
//   block; the window's nonzero float2 slots go to the output with
//   float2 atomics (adjacent tiles share owners at their edges).
// The TPU's matrix-unit one-hot product and its VMEM-resident (8, n_pad)
// output are not carried over. Atomics make the summation order vary from
// run to run (tolerance against the float64 sum, 1e-5 relative).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "segred_common.cuh"

namespace cg = cooperative_groups;

namespace {

using segred::kFull;
using segred::Row6;

constexpr int kThreads = 256;
constexpr int kMaxWindowBytes = 48 * 1024;  // static limit of a block

__global__ void __launch_bounds__(kThreads)
    seg_sum_v1_kernel(const float* __restrict__ rec,
                      const int* __restrict__ ids, int cap, int n_owners,
                      int tile, int owin, int n_pad, int n_tiles,
                      float* __restrict__ out,
                      unsigned char* __restrict__ spill) {
  extern __shared__ float2 acc2[];  // owin * 3: the window, rows of 6 f32
  float* acc = reinterpret_cast<float*>(acc2);
  __shared__ int bmin;
  const int lane = threadIdx.x & 31;

  // phase 1: out = 0, flag = 0
  const size_t n_f = (size_t)n_owners * 6;
  const size_t n_f4 = n_f / 4;
  float4* out4 = reinterpret_cast<float4*>(out);
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n_f4;
       i += stride)
    out4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (blockIdx.x == 0) {
    for (size_t i = n_f4 * 4 + threadIdx.x; i < n_f; i += kThreads)
      out[i] = 0.f;
    if (threadIdx.x == 0) *spill = 0;
  }
  cg::this_grid().sync();

  // phase 2: the tiles
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long t0 = (long long)t * tile;
    for (int i = threadIdx.x; i < owin * 6; i += kThreads) acc[i] = 0.f;
    if (threadIdx.x == 0) bmin = n_owners;
    __syncthreads();
    int local = n_owners;
    for (int r = threadIdx.x; r < tile; r += kThreads) {
      const long long row = t0 + r;
      if (row < cap) {
        const int id = ids[row];
        if ((unsigned)id < (unsigned)n_owners) local = min(local, id);
      }
    }
    local = __reduce_min_sync(kFull, local);
    if (lane == 0) atomicMin(&bmin, local);
    __syncthreads();
    const int b0 = min((bmin / 128) * 128, n_pad - owin);
    int sp = 0;
    // every thread takes every pass (the scan shuffles across the warp);
    // a warp's 32 rows of a pass are contiguous
    for (int r0 = 0; r0 < tile; r0 += kThreads) {
      const int r = r0 + threadIdx.x;
      const long long row = t0 + r;
      int rel = -1;  // window slot of this lane's row, -1: adds nothing
      Row6 v = segred::zero_row();
      if (r < tile && row < cap) {
        const int id = ids[row];
        if ((unsigned)id < (unsigned)n_owners) {
          if (id - b0 >= owin) {
            sp = 1;
          } else if (id >= b0) {
            rel = id - b0;
            v = segred::load_row(rec, row);
          }
        }
      }
      if (segred::seg_scan(rel, lane, v) && rel >= 0) {
        float* slot = acc + rel * 6;
        atomicAdd(slot + 0, v.a.x);
        atomicAdd(slot + 1, v.a.y);
        atomicAdd(slot + 2, v.b.x);
        atomicAdd(slot + 3, v.b.y);
        atomicAdd(slot + 4, v.c.x);
        atomicAdd(slot + 5, v.c.y);
      }
    }
    // every block that spills stores the same 1: no atomic needed
    if (__syncthreads_or(sp) && threadIdx.x == 0) *spill = 1;
    float2* out2 = reinterpret_cast<float2*>(out);
    for (int i = threadIdx.x; i < owin * 3; i += kThreads) {
      const float2 w = acc2[i];
      const int owner = b0 + i / 3;
      if ((w.x != 0.f || w.y != 0.f) && owner < n_owners)
        atomicAdd(out2 + (size_t)owner * 3 + i % 3, w);
    }
    __syncthreads();  // the next tile of this block reuses acc and bmin
  }
}

// Blocks of this kernel the card keeps resident with a window of `smem`
// bytes. Asked once per window size; a second thread asking at the same
// time writes the same values.
int resident_blocks(size_t smem) {
  static size_t known_smem = 0;
  static int known = 0;
  if (known == 0 || known_smem != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_sum_v1_kernel,
                                                  kThreads, smem);
    known = sms * per_sm;
    known_smem = smem;
  }
  return known;
}

}  // namespace

// out must be 16-byte aligned (phase 1 stores float4); spill is one byte,
// 0 or 1 on return (a torch.bool).
extern "C" int dem_seg_sum_v1(const float* rec, const int* ids, int cap,
                              int n_owners, int tile, int owin, float* out,
                              unsigned char* spill, void* stream) {
  const size_t smem = sizeof(float) * 6 * (size_t)owin;
  if (tile <= 0 || owin <= 0 || smem > kMaxWindowBytes)
    return (int)cudaErrorInvalidValue;
  int n_pad = ((n_owners + 1 + owin + 127) / 128) * 128;
  int n_tiles = (int)(((long long)cap + tile - 1) / tile);
  // enough blocks for the tiles and for ~4 float4 stores per thread of
  // the zeroing, no more than are resident together (the grid barrier
  // needs them all running)
  const long long zero_blocks =
      ((long long)n_owners * 6 / 4 + 4LL * kThreads - 1) / (4LL * kThreads);
  const int resident = resident_blocks(smem);
  if (resident <= 0) return (int)cudaErrorLaunchOutOfResources;
  long long want = n_tiles > zero_blocks ? n_tiles : zero_blocks;
  if (want < 1) want = 1;
  const int blocks = (int)(want < resident ? want : resident);
  void* args[] = {&rec, &ids, &cap, &n_owners, &tile, &owin,
                  &n_pad, &n_tiles, &out, &spill};
  const cudaError_t refused = cudaLaunchCooperativeKernel(
      (void*)seg_sum_v1_kernel, dim3(blocks), dim3(kThreads), args, smem,
      static_cast<cudaStream_t>(stream));
  return refused != cudaSuccess ? (int)refused : (int)cudaGetLastError();
}
