// Hash-grid table-gradient scatter-add, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mlinerf_tpu/ops/hashgrid_pallas.py::_scatter_kernel_flat, driven by
// scatter_add_rows there. It is the backward of the row gather in
// mlinerf_tpu_torch/ops/hashgrid_scatter.py (TakeRows), so it runs once per
// differentiable hash-grid level lookup of a training step: 32 launches per
// stage-a step (16 levels x the centre and the 4-tap evaluations).
//
// What it computes: out[idx[i], :] += vals[i, :] for every i with
// 0 <= idx[i] < s; rows outside the table are dropped. vals is [n, f] in
// float32 or bf16 (bf16 -> f32 is exact); out is [s, f] float32, arrives
// zeroed (the caller allocates it) and every sum is taken in float32. f
// divides 128.
//
// What bounds it on an H100: the function reads n*(f*bytes(vals)+4) bytes and
// writes s*f*4. A stage-a step's 32 launches (n = 1,048,576 or 4,194,304
// rows, f = 8, bf16 vals, s from 33^3 to 2^19) move about 2.1 GB: 0.63 ms at
// 3.35 TB/s. The table of one level (at most 16 MB in f32) stays in the 50 MB
// L2, so the reductions do not reach DRAM; what they cost is L2 requests,
// one for each 32-byte sector that a warp instruction touches.
//
// What the design does about it:
//  * Rows, not elements. A lane owns one row of f = 8 (for larger f, an
//    8-wide chunk of one): one 16-byte load of bf16 vals (two of f32),
//    widened to f32 in registers. The bf16 cotangent is read as it is, so no
//    f32 copy of it is written and read back.
//  * Runs merged in the warp. The training path's indices come in runs: the 4
//    taps of a point, and neighbouring samples of a ray at coarse levels, hit
//    the same rows. Each row is compared with the row before it
//    (__shfl_up_sync); a warp whose ballot shows no repeat goes straight to
//    its reductions, otherwise a segmented shuffle reduction sums each run
//    into its first row and only that row reduces into L2. Dropped rows never
//    join a run and issue nothing. Merging repeats that are not adjacent
//    (a tap that crosses into the next cell) with __match_any_sync was
//    tried and cost the warp more than it saved in L2.
//  * Whole-sector vector reductions. A run's sum goes to L2 as
//    red.global.add.v4.f32, which compiles to one REDG.E.ADD.F32x4 per 16
//    bytes. Lanes 2k and 2k+1 first trade halves of their rows, so that each
//    warp instruction covers 16 whole sectors instead of half of 32. For f
//    of 1 or 2 the same kernel issues scalar reductions.
// The TPU kernel's design does not carry over: its VMEM accumulator, 128-lane
// packing and serial grid exist because a TPU core walks the grid in order;
// here blocks run in parallel and L2 reductions take the accumulator's place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
// Values a lane owns: one 32-byte sector of a float32 row, read in one
// 16-byte load from bf16 vals.
constexpr int kLaneValues = 8;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// V consecutive values of a row, widened to float32. The loads are streaming
// (ld.global.cs, evict first), so the inputs passing through L2 do not push
// out the table that the reductions hit.
template <int V>
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 q = __ldcs(reinterpret_cast<const float4*>(p + k));
      v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
    }
  } else if constexpr (V == 2) {
    const float2 q = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void load_chunk(const uint16_t* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
    v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
    v[4] = bf16_lo(q.z); v[5] = bf16_hi(q.z); v[6] = bf16_lo(q.w); v[7] = bf16_hi(q.w);
  } else if constexpr (V == 4) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
  } else if constexpr (V == 2) {
    const uint32_t q = __ldcs(reinterpret_cast<const unsigned int*>(p));
    v[0] = bf16_lo(q); v[1] = bf16_hi(q);
  } else {
    v[0] = bf16_lo(__ldcs(reinterpret_cast<const unsigned short*>(p)));
  }
}

// out[0:V] += v, as V/4 vector reductions or V scalar ones. The result is
// unused, so the scalar atomicAdd also compiles to a reduction (RED).
template <int V>
__device__ __forceinline__ void reduce_chunk(float* out, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                   :: "l"(__cvta_generic_to_global(out + k)),
                      "f"(v[k]), "f"(v[k + 1]), "f"(v[k + 2]), "f"(v[k + 3])
                   : "memory");
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) atomicAdd(out + k, v[k]);
  }
}

// Sums each run of equal rows among a warp's rows into the run's first row,
// whose key stays; the key of every other row of a run becomes -1.
template <int V>
__device__ __forceinline__ void merge_runs(int& key, float (&v)[V], int row, int row_lane,
                                           int lanes_per_row, unsigned row_starts) {
  const int prev = __shfl_up_sync(kFullMask, key, lanes_per_row);
  const bool repeat = key >= 0 && row > 0 && prev == key;
  const unsigned repeats = __ballot_sync(kFullMask, repeat);
  if (!repeats) return;
  // A run ends at the next row that is not a repeat.
  const unsigned heads = row_starts & ~repeats;
  const unsigned later = heads & ~((2u << row_lane) - 1u);
  const int run_end = later ? __ffs(later) - 1 : 32;
  // Segmented suffix sums: after the pass at distance d (in lanes), a row
  // holds the sum of the next 2d / lanes_per_row rows of its run.
  for (int d = lanes_per_row; d < 32; d <<= 1) {
    const bool take = row_lane + d < run_end;
    if (!__any_sync(kFullMask, take)) break;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float o = __shfl_down_sync(kFullMask, v[k], d);
      if (take) v[k] += o;
    }
  }
  if (repeat) key = -1;
}

// The heads' reductions of a warp. With V == 8 each lane holds one 32-byte
// L2 sector of a row; lanes 2k and 2k+1 trade halves so that each vector
// reduction instruction covers whole sectors (two lanes, one sector) rather
// than half of 32 sectors.
template <int V>
__device__ __forceinline__ void reduce_heads(float* out, long long at, const float (&v)[V], int lane) {
  if constexpr (V == 8) {
    const int odd = lane & 1;
    const long long other_at = __shfl_xor_sync(kFullMask, at, 1);
    // The even lane sends the second half of its sector and the odd lane the
    // first half of its own; each then holds its half of both sectors.
    float to_even[4], to_odd[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float theirs = __shfl_xor_sync(kFullMask, odd ? v[k] : v[4 + k], 1);
      to_even[k] = odd ? theirs : v[k];
      to_odd[k] = odd ? v[4 + k] : theirs;
    }
    const long long even_at = odd ? other_at : at, odd_at = odd ? at : other_at;
    if (even_at >= 0) reduce_chunk<4>(out + even_at + 4 * odd, to_even);
    if (odd_at >= 0) reduce_chunk<4>(out + odd_at + 4 * odd, to_odd);
  } else {
    if (at >= 0) reduce_chunk<V>(out + at, v);
  }
}

// A warp takes 32 / (f / V) consecutive rows per pass; the f / V lanes of a
// row each own V of its features. T is float, or uint16_t holding bf16 bits.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const int* __restrict__ idx, const T* __restrict__ vals,
                        float* __restrict__ out, long long n, int f, long long s) {
  const int lane = threadIdx.x & 31;
  const int lanes_per_row = f / V;  // a power of two, at most 16
  const int rows_per_pass = 32 / lanes_per_row;
  const int chunk = lane & (lanes_per_row - 1);
  const int row_lane = lane - chunk;  // the row's first lane
  const int row = row_lane / lanes_per_row;
  // Bit l set for each lane l that starts a row.
  const unsigned row_starts = kFullMask / ((1u << lanes_per_row) - 1u);
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long base = ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * rows_per_pass;
       base < n; base += warps * rows_per_pass) {
    const long long i = base + row;
    int key = -1;  // the table row, or -1 where the row is dropped or past n
    float v[V];
    if (i < n) {
      // Both loads issue before either is used; a dropped row's values are
      // read but never summed.
      const int r = __ldcs(idx + i);
      load_chunk<V>(vals + i * f + chunk * V, v);
      if (r >= 0 && (long long)r < s) key = r;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = 0.0f;
    }
    merge_runs<V>(key, v, row, row_lane, lanes_per_row, row_starts);
    reduce_heads<V>(out, key >= 0 ? (long long)key * f + chunk * V : -1, v, lane);
  }
}

template <typename T>
int launch(const int* idx, const T* vals, float* out, long long n, int f, long long s,
           cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (f <= 0 || 128 % f != 0) return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int v = f < kLaneValues ? f : kLaneValues;
  const long long rows_per_pass = 32 / (f / v);
  const long long passes = (n + rows_per_pass - 1) / rows_per_pass;
  long long blocks = (passes + kThreads / 32 - 1) / (kThreads / 32);
  // Enough blocks to fill every SM; the grid-stride loop covers the rest.
  const long long max_blocks = (long long)sms * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  const dim3 grid((unsigned int)blocks);
  switch (v) {
    case 8: scatter_add_rows_kernel<T, 8><<<grid, kThreads, 0, stream>>>(idx, vals, out, n, f, s); break;
    case 4: scatter_add_rows_kernel<T, 4><<<grid, kThreads, 0, stream>>>(idx, vals, out, n, f, s); break;
    case 2: scatter_add_rows_kernel<T, 2><<<grid, kThreads, 0, stream>>>(idx, vals, out, n, f, s); break;
    default: scatter_add_rows_kernel<T, 1><<<grid, kThreads, 0, stream>>>(idx, vals, out, n, f, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes, one per type of vals. Each
// launches on `stream`, allocates nothing and does not synchronise. Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for an f that does not
// divide 128).
extern "C" int scatter_add_rows_f32(const int* idx, const float* vals, float* out,
                                    long long n, int f, long long s, cudaStream_t stream) {
  return launch<float>(idx, vals, out, n, f, s, stream);
}

extern "C" int scatter_add_rows_bf16(const int* idx, const uint16_t* vals, float* out,
                                     long long n, int f, long long s, cudaStream_t stream) {
  return launch<uint16_t>(idx, vals, out, n, f, s, stream);
}
