// Hash-grid table-gradient scatter-add, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mlinerf_tpu/ops/hashgrid_pallas.py::_scatter_kernel_flat, driven by
// scatter_add_rows there. It is the backward of the row gather in
// mlinerf_tpu_torch/ops/hashgrid_scatter.py (TakeRows), so it runs once per
// differentiable hash-grid level lookup of a training step.
//
// What it computes: out[idx[i], :] += vals[i, :] for every i with
// 0 <= idx[i] < s. Rows outside the table are dropped (padding uses them).
// out is [s, f] float32 and arrives zeroed: the caller allocates it.
//
// What bounds it on an H100: the function reads n*(4f+4) bytes and writes
// s*f*4 bytes. At the stage-a shapes (n = 4,194,304 rows, f = 8, s = 2^19)
// that is about 168 MB, 0.05 ms at 3.35 TB/s. The real limit is the rate at
// which L2 absorbs float32 atomic adds: n*f atomics land on s*f addresses, so
// rows collide, and each atomic is a read-modify-write in L2. The table of
// one level (at most 16 MB in f32) stays resident in the 50 MB L2.
//
// What the design does about it: one thread per (row, feature) element in a
// grid-stride loop. Neighbouring threads read neighbouring floats of vals
// (coalesced loads), and the f features of one row go to f neighbouring
// addresses (one 32-byte L2 sector per row for f = 8). The result of
// atomicAdd is unused, so it compiles to a fire-and-forget reduction (RED)
// that does not wait for L2. The TPU kernel's design does not carry over:
// its VMEM accumulator, 128-lane packing and serial grid exist because a TPU
// core walks the grid in order; here blocks run in parallel and the L2
// atomics take the accumulator's place. Vectorised reductions
// (red.global.add.v4.f32) and warp-level merging of duplicate rows are left
// for later work.

#include <cuda_runtime.h>

namespace {

__global__ void scatter_add_rows_kernel(const int* __restrict__ idx,
                                        const float* __restrict__ vals,
                                        float* __restrict__ out,
                                        long long n, int f, long long s) {
  const long long total = n * f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long i = e / f;
    const int j = (int)(e - i * f);
    const int r = __ldg(idx + i);
    if (r >= 0 && (long long)r < s) {
      atomicAdd(out + (long long)r * f + j, __ldg(vals + e));
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream`, allocates
// nothing and does not synchronise. Returns the cudaError_t of the launch.
extern "C" int scatter_add_rows_f32(const int* idx, const float* vals, float* out,
                                    long long n, int f, long long s,
                                    cudaStream_t stream) {
  if (n <= 0 || f <= 0) return (int)cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long total = n * (long long)f;
  long long blocks = (total + threads - 1) / threads;
  // Enough blocks to fill every SM several times over; the grid-stride
  // loop covers the rest.
  const long long max_blocks = (long long)sms * 32;
  if (blocks > max_blocks) blocks = max_blocks;
  scatter_add_rows_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(idx, vals, out, n, f, s);
  return (int)cudaGetLastError();
}
