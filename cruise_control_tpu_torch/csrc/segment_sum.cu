// Segment sum for Hopper (sm_90a): out[s, c] = sum over r with ids[r] == s of values[r, c].
//
// Replaces the JAX package's two Pallas TPU kernels, segment_sum_pallas (flat one-hot
// MXU contraction, S <= 2048) and segment_sum_radix (two-digit one-hot, S <= 16384),
// both in cruise_control_tpu/ops/segments.py.  One source serves any S and any C.
// Ids outside [0, S) are dropped.
//
// Two paths, both deterministic:
//
//  * seg_sum_f32 (float inputs): one warp owns one segment and walks the replica axis
//    in index order, so every output is the left-to-right f32 sum of its rows -- the
//    same rounding as a sequential CPU scatter-add, on every run.  The block stages a
//    tile of ids in shared memory once for its 8 warps; each warp ballots its segment
//    over 32 ids at a time and lane c adds column c of each hit in order.  Full f32
//    adds, no tensor cores, no TF32.
//
//  * seg_sum_i32 (integer and bool inputs, cast to int32 by the wrapper): one int32
//    atomicAdd per (row, column).  Integer addition is associative, so the result is
//    exact whatever order the atomics land in.
//
// Bound on the card: at the solver's shapes (R = 30,000 rows, C <= 4, S = 128) the
// kernel reads R*(C+1)*4 B, about 600 KB, and writes S*C*4 B -- well under a
// microsecond of HBM time.  Launch latency and the serial per-segment walk bound it;
// the float path trades parallelism for a fixed summation order.  The caller
// allocates the output; the kernels allocate nothing and launch on the given stream.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 2048;  // ids staged in shared memory per pass (8 KB)

__global__ void __launch_bounds__(kThreads)
seg_sum_f32(const float* __restrict__ values, const int* __restrict__ ids,
            float* __restrict__ out, int rows, int cols, int segments) {
  __shared__ int tile_ids[kTile];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kWarps + warp;
  const int col = blockIdx.y * 32 + lane;
  const bool seg_ok = seg < segments;  // uniform across the warp
  float acc = 0.0f;
  for (int base = 0; base < rows; base += kTile) {
    const int n = min(kTile, rows - base);
    for (int i = threadIdx.x; i < n; i += kThreads) tile_ids[i] = ids[base + i];
    __syncthreads();
    if (seg_ok) {
      for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        unsigned hits = __ballot_sync(0xffffffffu, j < n && tile_ids[j] == seg);
        while (hits) {
          const int k = __ffs(hits) - 1;
          hits &= hits - 1;
          if (col < cols) acc += values[(size_t)(base + j0 + k) * cols + col];
        }
      }
    }
    __syncthreads();
  }
  if (seg_ok && col < cols) out[(size_t)seg * cols + col] = acc;
}

__global__ void __launch_bounds__(kThreads)
seg_sum_i32(const int* __restrict__ values, const int* __restrict__ ids,
            int* __restrict__ out, int rows, int cols, int segments) {
  const long long total = (long long)rows * cols;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int r = (int)(i / cols);
    const int c = (int)(i - (long long)r * cols);
    const int s = ids[r];
    if (s >= 0 && s < segments) atomicAdd(&out[(size_t)s * cols + c], values[i]);
  }
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers; `stream` is a
// cudaStream_t.  Each returns cudaGetLastError() after its launch (0 on success).

extern "C" int cc_segment_sum_f32(const void* values, const void* ids, void* out,
                                  int rows, int cols, int segments, void* stream) {
  if (rows < 0 || cols <= 0 || segments <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((segments + kWarps - 1) / kWarps, (cols + 31) / 32);
  seg_sum_f32<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)values, (const int*)ids, (float*)out, rows, cols, segments);
  return (int)cudaGetLastError();
}

// `out` must hold zeros on entry (the wrapper passes torch.zeros).
extern "C" int cc_segment_sum_i32(const void* values, const void* ids, void* out,
                                  int rows, int cols, int segments, void* stream) {
  if (rows <= 0 || cols <= 0 || segments <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)rows * cols;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  seg_sum_i32<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)values, (const int*)ids, (int*)out, rows, cols, segments);
  return (int)cudaGetLastError();
}
