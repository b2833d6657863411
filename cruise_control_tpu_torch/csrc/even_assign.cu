// One replica position of the kafka-assigner placement mode for Hopper (sm_90a).
//
// Replaces the per-position lax.scan of the JAX package's kafka-assigner mode,
// cruise_control_tpu/analyzer/kafka_assigner.py:_assign_position (the scan at :111).  That
// is not a Pallas kernel: XLA compiles the scan into one device loop over partitions.  In
// eager PyTorch the same loop is P dependent steps of about ten small ops each (30,000
// steps at 10,000 partitions and RF 3), so it becomes this one launch per position.
//
// What a pass computes, partition by partition in index order (a sequential greedy: each
// partition reads the counts the previous one left):
//   if rf[p] > pos and the partition's topic is not excluded:
//     the brokers chosen[p, 0 .. pos-1] are barred, and so are their racks;
//     b = the lexicographic (counts[b], b) minimum over eligible brokers that are not barred
//         by broker or rack, else (every rack used: fewer racks than RF) over eligible
//         brokers not barred by broker, else none;
//     if b exists: counts[b] += 1;  chosen[p, pos] = b (or -1)
//   else chosen[p, pos] = -1.
// Integer-only, so it equals its plain version (ops/assign.py) exactly.
//
// Design.  The chain is serial, so the pass is one block, and what bounds it is the latency
// of one block-wide argmin per partition, P of them in a row; the bytes (about 30 bytes a
// partition) and the compares (2 x B a partition) are small.  So:
//  * each thread owns PER brokers (PER = 4 up to 4,096 brokers, doubling above): their
//    counts, racks and eligibility live in registers for the whole pass, and only the
//    owner of the winning broker updates its count -- no shared or global traffic for the
//    counts inside the loop;
//  * the partitions come in tiles of up to 1,024: one cooperative load puts each tile's
//    earlier picks (chosen[p, 0..pos-1]) and their racks into shared memory, so the serial
//    loop never waits on device memory;
//  * the two argmins (strict and relaxed) pack (count, id) into one 64-bit key each and
//    reduce with warp shuffles; above one warp, one shared-memory step (double-buffered, so
//    one __syncthreads a partition) and a second shuffle round give every thread the
//    winner.  One warp (up to 128 brokers) needs no barrier at all.
//  * a stack of clusters (the solver's lane form: the JAX package vmaps the placement over
//    its lanes) is one launch with one block a lane: block l reads and writes lane l's
//    rows of every buffer (each buffer is lanes x its one-lane size, lane-major), so the
//    lanes' serial chains run side by side on the SMs.  Every lane runs the same position
//    pass; a lane whose replication factor is lower places nothing at the extra positions
//    (its rf[p] <= pos), as in the JAX package, whose position loop has one static bound.
// The caller allocates nothing for the kernel; it updates counts and column pos of chosen in
// place, on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;
constexpr int kMaxThreads = 1024;
constexpr int kMaxTile = 1024;          // partitions staged at once
constexpr int kStageInts = 12288;       // 48 KB of staged picks a tile at most
constexpr int kMaxBrokers = 64 * kMaxThreads;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(kFull, v, o);
    v = w < v ? w : v;
  }
  return v;
}

template <int PER>
__global__ void __launch_bounds__(kMaxThreads)
even_assign_pass(int* __restrict__ counts, int* __restrict__ chosen, const int* __restrict__ rf,
                 const unsigned char* __restrict__ excluded, const int* __restrict__ rack,
                 const unsigned char* __restrict__ eligible, int partitions, int brokers,
                 int max_rf, int pos, int tile) {
  const size_t cl = blockIdx.x;  // this block's cluster (lane) of the stack
  counts += cl * brokers;
  chosen += cl * partitions * max_rf;
  rf += cl * partitions;
  excluded += cl * partitions;
  rack += cl * brokers;
  eligible += cl * brokers;
  extern __shared__ int stage[];  // [tile] active flags, [tile][pos] brokers, [tile][pos] racks
  __shared__ unsigned long long red[2][2][32];  // [buffer][strict, relaxed][warp]
  int* s_active = stage;
  int* s_prev_b = stage + tile;
  int* s_prev_r = s_prev_b + tile * pos;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;

  int my_b[PER], cnt[PER], my_rack[PER];
  bool my_el[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int b = tid + k * nthreads;
    const bool in = b < brokers;
    my_b[k] = b;
    cnt[k] = in ? counts[b] : 0;
    my_rack[k] = in ? rack[b] : -1;
    my_el[k] = in && eligible[b];
  }

  int buf = 0;
  for (int p0 = 0; p0 < partitions; p0 += tile) {
    const int n = min(tile, partitions - p0);
    __syncthreads();  // every thread is done with the previous tile's stage
    for (int t = tid; t < n; t += nthreads) {
      const int p = p0 + t;
      s_active[t] = rf[p] > pos && !excluded[p];
    }
    for (int i = tid; i < n * pos; i += nthreads) {
      const int t = i / pos, j = i - t * pos;
      const int b = chosen[(size_t)(p0 + t) * max_rf + j];
      s_prev_b[i] = b;
      s_prev_r[i] = b >= 0 ? rack[b] : -1;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const size_t out = (size_t)(p0 + t) * max_rf + pos;
      if (!s_active[t]) {  // uniform: every thread reads the same flag
        if (tid == 0) chosen[out] = -1;
        continue;
      }
      const int* pb = s_prev_b + t * pos;
      const int* pr = s_prev_r + t * pos;
      unsigned long long ks = kNone, kr = kNone;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        bool ban_b = !my_el[k], ban_r = false;
        for (int j = 0; j < pos; ++j) {
          ban_b |= pb[j] == my_b[k];
          ban_r |= pr[j] == my_rack[k];
        }
        const unsigned long long key =
            ban_b ? kNone : ((unsigned long long)(unsigned)cnt[k] << 32) | (unsigned)my_b[k];
        kr = key < kr ? key : kr;
        if (!ban_r) ks = key < ks ? key : ks;
      }
      ks = warp_min(ks);
      kr = warp_min(kr);
      if (nwarps > 1) {
        if (lane == 0) {
          red[buf][0][warp] = ks;
          red[buf][1][warp] = kr;
        }
        __syncthreads();
        ks = warp_min(lane < nwarps ? red[buf][0][lane] : kNone);
        kr = warp_min(lane < nwarps ? red[buf][1][lane] : kNone);
        buf ^= 1;  // the next partition writes the other buffer while this one is read
      }
      const unsigned long long key = ks != kNone ? ks : kr;
      const int pick = key != kNone ? (int)(unsigned)(key & 0xffffffffu) : -1;
#pragma unroll
      for (int k = 0; k < PER; ++k) cnt[k] += my_b[k] == pick;
      if (tid == 0) chosen[out] = pick;
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (my_b[k] < brokers) counts[my_b[k]] = cnt[k];
}

}  // namespace

// Plain C entry point for ctypes: one array of int64 arguments -- counts, chosen, rf,
// excluded, rack, eligible (device pointers: int32 [lanes, brokers], int32 [lanes,
// partitions, max_rf], int32 [lanes, partitions], bool [lanes, partitions], int32 [lanes,
// brokers], bool [lanes, brokers]), partitions, brokers, max_rf, pos, stream, lanes (1 for
// one cluster).  Returns 0 or the CUDA error of the launch.
extern "C" int cc_even_assign(const long long* args) {
  int* counts = (int*)args[0];
  int* chosen = (int*)args[1];
  const int* rf = (const int*)args[2];
  const unsigned char* excluded = (const unsigned char*)args[3];
  const int* rack = (const int*)args[4];
  const unsigned char* eligible = (const unsigned char*)args[5];
  const int partitions = (int)args[6], brokers = (int)args[7];
  const int max_rf = (int)args[8], pos = (int)args[9];
  cudaStream_t st = (cudaStream_t)args[10];
  const int lanes = (int)args[11];
  if (partitions < 0 || brokers <= 0 || brokers > kMaxBrokers || pos < 0 || pos >= max_rf ||
      lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  if (partitions == 0) return 0;
  int per = 4;
  while (per * kMaxThreads < brokers) per *= 2;
  const int threads = max(32, ((brokers + per - 1) / per + 31) / 32 * 32);
  const int tile = max(1, min(kMaxTile, kStageInts / (1 + 2 * pos)));
  const size_t smem = (size_t)tile * (1 + 2 * pos) * sizeof(int);
#define CC_PASS(P)                                                                      \
  even_assign_pass<P><<<lanes, threads, smem, st>>>(counts, chosen, rf, excluded, rack,      \
                                                eligible, partitions, brokers, max_rf, pos, \
                                                tile)
  switch (per) {
    case 4: CC_PASS(4); break;
    case 8: CC_PASS(8); break;
    case 16: CC_PASS(16); break;
    case 32: CC_PASS(32); break;
    default: CC_PASS(64); break;
  }
#undef CC_PASS
  return (int)cudaGetLastError();
}
