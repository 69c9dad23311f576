// Kernel D: sorted segment sum in an owner window per row tile, with a
// spill flag ((cap, 6) rows -> (n_owners, 6), plus one int).
//
// Replaces dem_engine_tpu/ops/pallas_segred.py seg_sum_sorted (v1,
// _make_kernel): per TILE-row tile of owner-sorted rows, a one-hot matmul
// against an OWIN-owner window based at b0 = min(floor(min live id / 128)
// * 128, n_pad - OWIN), accumulated into a resident output; a row whose
// owner lies past the window raises the spill flag and adds nothing (the
// caller then falls back, as the JAX function's contract says).
//
// What bounds it on the H100: device-memory bandwidth, as for kernel A:
// 4 B of owner id per row, 24 B of wrench per summed row, 24 B per owner
// written; 6 adds per row.
//
// Design: one block per tile. The block finds its window base with a
// shared-memory atomicMin over the live ids, accumulates its rows into an
// (OWIN x 6) f32 window in shared memory with shared atomics (rows are
// sorted, so neighbouring threads mostly hit one owner's slots), ORs the
// spill predicate across the block, and adds the window's nonzero slots
// into the output with global atomics (adjacent tiles share owners at
// their edges). The TPU's matrix-unit one-hot product and its
// VMEM-resident (8, n_pad) output are not carried over: a shared-memory
// atomic is the cheap scatter here. Atomics make the summation order vary
// from run to run (tolerance against the float64 sum, 1e-5 relative).

#include <cuda_runtime.h>

namespace {

__global__ void seg_sum_v1_kernel(const float* __restrict__ rec,
                                  const int* __restrict__ ids, int cap,
                                  int n_owners, int tile, int owin,
                                  int n_pad, float* __restrict__ out,
                                  int* __restrict__ spill) {
  extern __shared__ float acc[];  // owin * 6
  __shared__ int bmin;
  const long long t0 = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < owin * 6; i += blockDim.x) acc[i] = 0.f;
  if (threadIdx.x == 0) bmin = n_owners;
  __syncthreads();
  int local = n_owners;
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const long long row = t0 + r;
    if (row < cap) {
      const int id = ids[row];
      if (id >= 0 && id < n_owners) local = min(local, id);
    }
  }
  atomicMin(&bmin, local);
  __syncthreads();
  const int b0 = min((bmin / 128) * 128, n_pad - owin);
  int sp = 0;
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const long long row = t0 + r;
    if (row >= cap) break;
    const int id = ids[row];
    if (id < 0 || id >= n_owners) continue;
    const int rel = id - b0;
    if (rel >= owin) {
      sp = 1;
      continue;
    }
    if (rel < 0) continue;
    const float* src = rec + row * 6;
#pragma unroll
    for (int c = 0; c < 6; ++c) atomicAdd(acc + rel * 6 + c, src[c]);
  }
  if (__syncthreads_or(sp) && threadIdx.x == 0) atomicOr(spill, 1);
  for (int i = threadIdx.x; i < owin * 6; i += blockDim.x) {
    const float v = acc[i];
    const int owner = b0 + i / 6;
    if (v != 0.f && owner < n_owners) atomicAdd(out + owner * 6 + i % 6, v);
  }
}

}  // namespace

extern "C" int dem_seg_sum_v1(const float* rec, const int* ids, int cap,
                              int n_owners, int tile, int owin, float* out,
                              int* spill, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, sizeof(float) * 6 * (size_t)n_owners, s);
  cudaMemsetAsync(spill, 0, sizeof(int), s);
  if (cap > 0) {
    const int n_pad = ((n_owners + 1 + owin + 127) / 128) * 128;
    const int blocks = (int)((cap + tile - 1) / tile);
    const size_t smem = sizeof(float) * 6 * (size_t)owin;
    seg_sum_v1_kernel<<<blocks, 256, smem, s>>>(rec, ids, cap, n_owners, tile,
                                                owin, n_pad, out, spill);
  }
  return (int)cudaGetLastError();
}
