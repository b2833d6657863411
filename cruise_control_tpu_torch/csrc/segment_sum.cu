// Segment sums for Hopper (sm_90a): out[s, c] = sum over r with ids[r] == s of values[r, c].
//
// Replaces the JAX package's two Pallas TPU kernels, segment_sum_pallas (flat one-hot
// MXU contraction, S <= 2048) and segment_sum_radix (two-digit one-hot, S <= 16384),
// both in cruise_control_tpu/ops/segments.py.  One source serves any S and any number of
// columns.  Ids outside [0, S) are dropped.  A call takes several value tensors ("fields",
// each [R] or [R, k], contiguous) under one id vector; a field is float32, int32 or a byte
// type (bool, uint8), and integer fields sum into int32.
//
// Two entry points, both deterministic:
//
//  * cc_segment_sums, the fixed-order path (any float field).  Every float output is the
//    left-to-right f32 sum of its rows in row order -- bitwise the sequential CPU
//    scatter-add, on every launch.  No float atomics, no tensor cores, no FMA.  Four
//    kernels, enqueued by one host call, make a stable counting sort and then walk it.
//    The rows are cut into blocks in row order; the block count comes from the rows and
//    the card (two blocks an SM when there are rows enough), not from the segment count:
//      group_count: a block's 8 warps take its rows 32 at a time.  Lanes with equal ids
//        are found with ballots (one per id bit: __match_any_sync is slow when many warps
//        of one SM run it); the lowest lane of each group adds the group's size to the
//        block's counter for that segment in shared memory (integer atomics).  Each block
//        writes its per-segment counts: blocks x S ints.
//      group_offsets: one block per 32 segments scans the counts in block order within
//        each segment (in place: a block's count becomes its rows of that segment in the
//        blocks before it) and the last block to finish scans the segment totals in
//        segment order into each segment's first position.  Integers, so exact in any
//        schedule.
//      group_scatter: each block counts its warps' rows again into a counter a segment a
//        warp in shared memory, adds its own block's offsets and the segment starts to
//        make each warp's cursors, then writes every column of each row to its place:
//        sorted[c][position], a segment's rows contiguous and in ascending row order.
//        Shared memory (224 KB) sets the warps: 8 up to S = 7,168, 3 at S = 16,384.
//      group_walk: one warp per (segment, 32 columns); lane c streams column c of the
//        segment's sorted rows and adds them in order, the next 64 rows in flight while
//        it adds the current 64, so the serial add chain overlaps the loads.  Integer
//        columns add as int32 in the same pass.
//    Work is O(R * C + S * blocks) instead of the O(R * S / 32) compares of a scan per
//    segment.  The count kernel's counters live in shared memory, which holds 28,672
//    segments a pass at two scatter warps; above that the call takes the segment range in
//    chunks of that size, one pass of the four kernels each (every pass reads all rows and
//    keeps its chunk's).
//  * cc_segment_counts, the integer path (integer fields only): exact int32 sums.  Block g
//    owns a range of segments: it reads every id, adds its own rows' values into a shared
//    memory histogram with shared atomics (exact in any order) and stores its bins.  Every
//    output element is written once, so there is no memset and no device-memory atomic.
//
// Bound on the card: at the solver's shapes (R = 30,000 rows, S = 128 brokers, 4 to 11
// columns) a call reads R * (4 + 4 * C) bytes, about 0.6-1.4 MB, and writes S * C * 4 bytes:
// under half a microsecond of HBM time, and the adds never bind.  What bounds the
// fixed-order path is latency: four dependent kernels of a few dependent memory round
// trips each, the scatter's 4-byte stores to scattered places, and in the walk the
// longest segment's serial add chain (one segment holding all R rows is R dependent
// adds).  The caller allocates outputs and scratch; nothing here allocates, and every
// launch goes to the caller's stream.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxFields = 16;
constexpr int kMaxCols = 64;
constexpr int kGroup = 32;            // columns one walk warp carries
constexpr int kWalk = 64;             // rows a walk lane has in flight
constexpr int kGroupThreads = 256;    // the count and scatter blocks: 8 warps
constexpr int kThreads = 1024;        // the integer blocks
constexpr int kIdsAhead = 2;          // id loads a grouping warp keeps in flight
constexpr int kMaxTiles = 264;        // blocks of a fixed-order pass: two an SM of an H100
constexpr int kMinRows = 64;          // rows a scatter warp has at least (2 steps)
constexpr int kMoveCols = 8;          // columns a scatter lane has in flight
constexpr int kSmemBytes = 229376;    // dynamic shared memory a block asks for (224 KB)
constexpr int kSmemInts = kSmemBytes / 4;
constexpr int kPassSegments = kSmemInts / 2;  // segments one fixed-order pass holds (28,672)
constexpr int kMaxDevices = 64;

enum FieldType { kF32 = 0, kI32 = 1, kU8 = 2 };

// Kernel parameter (read in place: __grid_constant__): the fields of one call, and
// their columns flattened.
struct Fields {
  const void* src[kMaxFields];
  void* dst[kMaxFields];
  int width[kMaxFields];
  int type[kMaxFields];
  unsigned char col_field[kMaxCols];
  unsigned char col_sub[kMaxCols];
  int ncols;
};

__device__ __forceinline__ unsigned load_col(const Fields& f, int c, int r) {
  const int fi = f.col_field[c];
  const size_t i = (size_t)r * f.width[fi] + f.col_sub[c];
  switch (f.type[fi]) {
    case kF32: return __float_as_uint(static_cast<const float*>(f.src[fi])[i]);
    case kI32: return (unsigned)static_cast<const int*>(f.src[fi])[i];
    default: return (unsigned)static_cast<const unsigned char*>(f.src[fi])[i];
  }
}

__device__ __forceinline__ bool in_range(int s, int segments) {
  return (unsigned)s < (unsigned)segments;
}

// Exclusive scan of a[0, n) in place by the whole block; returns the total.  Each thread
// scans a contiguous run; a shuffle scan over the runs joins them.  `a` is in global
// memory and was written by other blocks, so it is read through L2 (__ldcg).
__device__ int block_exclusive_scan(int* a, int n, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int first = min(n, tid * per), last = min(n, first + per);
  int sum = 0;
  for (int i = first; i < last; ++i) sum += __ldcg(a + i);
  int x = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = (warp > 0 ? warp_sums[warp - 1] : 0) + x - sum;
  const int total = warp_sums[nwarps - 1];
  for (int i = first; i < last; ++i) {
    const int v = __ldcg(a + i);
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// How a pass of a fixed-order call is cut: it sums segments [base, base + segments).
// Block t of `tiles` owns rows [t * block_rows, (t + 1) * block_rows); in the scatter its
// `warps` warps own `span` consecutive rows each, in order (the count kernel splits the
// block's rows over all its 8 warps).  `kbits` bits distinguish the segments.
struct Grouping {
  int rows, base, segments, tiles, warps, block_rows, span, kbits;
};

// The plan of one pass: blocks from the rows and the card (two a streaming
// multiprocessor, at least kMinRows rows a scatter warp), scatter warps from shared memory
// (one counter a segment a warp).
Grouping plan_pass(int rows, int base, int segments, int sms) {
  Grouping g;
  g.rows = rows;
  g.base = base;
  g.segments = segments;
  g.kbits = 0;
  while (g.kbits < 31 && (segments - 1) >> g.kbits) ++g.kbits;
  g.warps = max(1, min(kGroupThreads / 32, kSmemInts / segments));
  const int max_tiles = max(1, min(kMaxTiles, 2 * sms));
  const int per_block = g.warps * kMinRows;
  g.tiles = max(1, min((rows + per_block - 1) / per_block, max_tiles));
  g.block_rows = max(32, ((rows + g.tiles - 1) / g.tiles + 31) / 32 * 32);
  g.tiles = max(1, (rows + g.block_rows - 1) / g.block_rows);
  g.span = ((g.block_rows + g.warps - 1) / g.warps + 31) / 32 * 32;
  return g;
}

// Row r's segment relative to the pass (out of range when it is not in the pass's).
__device__ __forceinline__ int local_id(const int* __restrict__ ids, int r, const Grouping& g) {
  return (int)((unsigned)ids[r] - (unsigned)g.base);
}

// Lanes holding the same valid id, without __match_any_sync (slow when many warps of one
// SM run it): one ballot of validity and one per id bit.
__device__ __forceinline__ unsigned peers_of(int s, bool ok, int kbits) {
  unsigned m = __ballot_sync(kFull, ok);
  for (int b = 0; b < kbits; ++b) {
    const bool bit = (s >> b) & 1;
    const unsigned bb = __ballot_sync(kFull, bit);
    m &= bit ? bb : ~bb;
  }
  return m;
}

// A warp's pass over rows [begin, end), 32 at a time in row order: `visit(s, peers, r)`
// for every row with an in-range id.  Ids are loaded kIdsAhead steps ahead.
template <typename Visit>
__device__ __forceinline__ void warp_rows(const int* __restrict__ ids, const Grouping& g,
                                          int begin, int end, Visit visit) {
  const int lane = threadIdx.x & 31;
  for (int base = begin; base < end; base += 32 * kIdsAhead) {
    int sv[kIdsAhead];
#pragma unroll
    for (int k = 0; k < kIdsAhead; ++k) {
      const int r = base + 32 * k + lane;
      sv[k] = r < end ? local_id(ids, r, g) : -1;
    }
#pragma unroll
    for (int k = 0; k < kIdsAhead; ++k) {
      if (base + 32 * k >= end) break;  // warp-uniform
      const bool ok = in_range(sv[k], g.segments);
      const unsigned peers = peers_of(ok ? sv[k] : 0, ok, g.kbits);
      if (ok) visit(sv[k], peers, base + 32 * k + lane);
      __syncwarp();
    }
  }
}

// The rows [begin, end) of warp `w` of `nwarps` sharing block t's rows.
__device__ __forceinline__ void warp_range(const Grouping& g, int w, int span, int* begin,
                                           int* end) {
  const int b0 = blockIdx.x * g.block_rows;
  const int b1 = min(g.rows, b0 + g.block_rows);
  *begin = min(b1, b0 + w * span);
  *end = min(b1, *begin + span);
}

// Count: hist[t * segments + s] = rows of block t in segment s.  The block's 8 warps add
// into one shared counter a segment (exact integer atomics: only the block's total is
// kept).  Block 0 also clears the offsets kernel's ticket (the kernels of a stream run in
// order, so the last call's offsets kernel is done).
__global__ void __launch_bounds__(kGroupThreads)
group_count(const int* __restrict__ ids, const Grouping g, int* __restrict__ hist,
            unsigned* __restrict__ ticket) {
  extern __shared__ int smem[];  // [segment]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0u;
  for (int i = threadIdx.x; i < g.segments; i += blockDim.x) smem[i] = 0;
  __syncthreads();
  const int span = ((g.block_rows + kGroupThreads / 32 - 1) / (kGroupThreads / 32) + 31) / 32 * 32;
  int begin, end;
  warp_range(g, warp, span, &begin, &end);
  warp_rows(ids, g, begin, end, [&](int s, unsigned peers, int) {
    if (lane == __ffs(peers) - 1) atomicAdd(&smem[s], __popc(peers));
  });
  __syncthreads();
  int* h = hist + (size_t)blockIdx.x * g.segments;
  for (int s = threadIdx.x; s < g.segments; s += blockDim.x) h[s] = smem[s];
}

// Offsets: block j takes segments [32 j, 32 j + 32), lane = segment, and its 8 warps split
// the blocks of the count kernel into 8 runs in block order.  Each (block, segment) count
// becomes, in place, the rows of that segment in the blocks before it; each segment's
// total goes to seg_start.  The last block to finish (a ticket taken after a fence) then
// scans the totals in segment order: seg_start[s] = first sorted position of segment s,
// seg_start[segments] = rows kept.  Integers only, so exact in any schedule.
__global__ void __launch_bounds__(kGroupThreads)
group_offsets(const Grouping g, int* __restrict__ hist, int* __restrict__ seg_start,
              unsigned* __restrict__ ticket) {
  constexpr int kParts = kGroupThreads / 32;
  __shared__ int part[kParts][32];
  __shared__ int warp_sums[32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, p = threadIdx.x >> 5;
  const int s = blockIdx.x * 32 + lane;
  const bool ok = s < g.segments;
  const int per = (g.tiles + kParts - 1) / kParts;
  const int u0 = min(g.tiles, p * per), u1 = min(g.tiles, u0 + per);
  int sum = 0;
  if (ok) {
    int u = u0;
    for (; u + 8 <= u1; u += 8) {
      int h[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) h[k] = hist[(size_t)(u + k) * g.segments + s];
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += h[k];
    }
    for (; u < u1; ++u) sum += hist[(size_t)u * g.segments + s];
  }
  part[p][lane] = sum;
  __syncthreads();
  int run = 0;
  for (int q = 0; q < p; ++q) run += part[q][lane];
  if (ok) {
    if (p == 0) {
      int total = 0;
      for (int q = 0; q < kParts; ++q) total += part[q][lane];
      seg_start[s] = total;
    }
    for (int u = u0; u < u1; ++u) {
      int* h = hist + (size_t)u * g.segments + s;
      const int c = *h;
      *h = run;
      run += c;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int kept = block_exclusive_scan(seg_start, g.segments, warp_sums);
  if (threadIdx.x == 0) seg_start[g.segments] = kept;
}

// Scatter: block t counts its warps' rows of each segment again (in shared memory, a
// counter a segment a warp), turns the counts into cursors -- the segment's first
// position, plus its rows in the blocks before (group_offsets), plus its rows in the
// warps before -- and writes every column of every row to its place in the segment's
// list: sorted[c * rows + position], each segment's rows in ascending row order.  It
// reads only its own block's offsets.  This warp's first ids and values are loaded
// before the counting, so they are in flight while it runs.
__global__ void __launch_bounds__(kGroupThreads)
group_scatter(const int* __restrict__ ids, const Grouping g, const int* __restrict__ hist,
              const int* __restrict__ seg_start, const __grid_constant__ Fields f,
              unsigned* __restrict__ sorted) {
  extern __shared__ int cur[];  // [segment][warp]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool mover = warp < g.warps;
  int begin = 0, end = 0;
  if (mover) warp_range(g, warp, g.span, &begin, &end);
  int sv[kIdsAhead];
  unsigned v[kIdsAhead][kMoveCols];
  auto load_ids = [&](int base) {
#pragma unroll
    for (int k = 0; k < kIdsAhead; ++k) {
      const int r = base + 32 * k + lane;
      sv[k] = r < end ? local_id(ids, r, g) : -1;
    }
  };
  auto load_values = [&](int base, int c0) {
#pragma unroll
    for (int k = 0; k < kIdsAhead; ++k)
#pragma unroll
      for (int u = 0; u < kMoveCols; ++u)
        if (base + 32 * k + lane < end && c0 + u < f.ncols)
          v[k][u] = load_col(f, c0 + u, base + 32 * k + lane);
  };
  if (mover) {
    load_ids(begin);
    load_values(begin, 0);
  }
  for (int i = threadIdx.x; i < g.segments * g.warps; i += blockDim.x) cur[i] = 0;
  __syncthreads();
  if (mover) {
    warp_rows(ids, g, begin, end, [&](int s, unsigned peers, int) {
      if (lane == __ffs(peers) - 1) cur[s * g.warps + warp] += __popc(peers);
    });
  }
  __syncthreads();
  const int* off = hist + (size_t)blockIdx.x * g.segments;
  for (int s = threadIdx.x; s < g.segments; s += blockDim.x) {
    int run = seg_start[s] + off[s];
    for (int w = 0; w < g.warps; ++w) {
      const int c = cur[s * g.warps + w];
      cur[s * g.warps + w] = run;
      run += c;
    }
  }
  __syncthreads();
  if (!mover) return;
  // kIdsAhead steps at a time: first every row's position (in row order), then the
  // columns, kMoveCols at a time with every step's loads in flight together
  const unsigned below = (1u << lane) - 1u;
  for (int base = begin; base < end; base += 32 * kIdsAhead) {
    if (base != begin) load_ids(base);
    int pos[kIdsAhead];
#pragma unroll
    for (int k = 0; k < kIdsAhead; ++k) {
      const int s = sv[k];
      const bool ok = in_range(s, g.segments);
      const unsigned peers = peers_of(ok ? s : 0, ok, g.kbits);
      pos[k] = -1;
      if (ok) {
        int* c = cur + s * g.warps + warp;
        pos[k] = *c + __popc(peers & below);
        __syncwarp(peers);
        if (lane == __ffs(peers) - 1) *c += __popc(peers);
      }
      __syncwarp();
    }
    for (int c0 = 0; c0 < f.ncols; c0 += kMoveCols) {
      if (base != begin || c0 != 0) load_values(base, c0);
#pragma unroll
      for (int k = 0; k < kIdsAhead; ++k)
#pragma unroll
        for (int u = 0; u < kMoveCols; ++u)
          if (pos[k] >= 0 && c0 + u < f.ncols) sorted[(size_t)(c0 + u) * g.rows + pos[k]] = v[k][u];
    }
  }
}

// Walk: one warp per (segment, group of kGroup columns); lane c streams column c of the
// segment's sorted rows and adds them in order, the next kWalk rows in flight while it
// adds the current ones.
__global__ void __launch_bounds__(32)
group_walk(const unsigned* __restrict__ sorted, int rows, int base_segment,
           const int* __restrict__ seg_start, const __grid_constant__ Fields f) {
  const int lane = threadIdx.x;
  const int c = blockIdx.y * kGroup + lane;
  if (lane >= kGroup || c >= f.ncols) return;
  const int s = blockIdx.x;
  const int begin = seg_start[s], end = seg_start[s + 1];
  const unsigned* p = sorted + (size_t)c * rows;
  const int fi = f.col_field[c];
  const bool is_float = f.type[fi] == kF32;
  float facc = 0.0f;
  int iacc = 0;
  unsigned a[kWalk], b[kWalk];
  auto fetch = [&](unsigned(&x)[kWalk], int k0) {
#pragma unroll
    for (int j = 0; j < kWalk; ++j) x[j] = k0 + j < end ? p[k0 + j] : 0u;
  };
  auto add = [&](const unsigned(&x)[kWalk], int n) {
    if (is_float) {
      if (n >= kWalk) {
#pragma unroll
        for (int j = 0; j < kWalk; ++j) facc += __uint_as_float(x[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kWalk; ++j)
          if (j < n) facc += __uint_as_float(x[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kWalk; ++j) iacc += (int)x[j];  // zero past the end
    }
  };
  fetch(a, begin);
  for (int base = begin; base < end; base += 2 * kWalk) {
    fetch(b, base + kWalk);
    add(a, end - base);
    if (base + kWalk >= end) break;
    fetch(a, base + 2 * kWalk);
    add(b, end - base - kWalk);
  }
  const size_t o = (size_t)(base_segment + s) * f.width[fi] + f.col_sub[c];
  if (is_float) static_cast<float*>(f.dst[fi])[o] = facc;
  else static_cast<int*>(f.dst[fi])[o] = iacc;
}

// Integer path: block g owns segments [g * span, (g + 1) * span).  It reads every id,
// adds the values of its own rows into a shared-memory histogram, and stores its bins:
// every output element is written once, by one block -- no memset, no device atomics.
__global__ void __launch_bounds__(kThreads)
int_sums(const int* __restrict__ ids, int rows, int segments, int span,
         const __grid_constant__ Fields f) {
  extern __shared__ int bins[];  // [column][span]
  const int s0 = blockIdx.x * span;
  const int s1 = min(segments, s0 + span);
  const int nb = f.ncols * span;
  for (int i = threadIdx.x; i < nb; i += kThreads) bins[i] = 0;
  __syncthreads();
  constexpr int kUnroll = 8;
  for (int r0 = threadIdx.x; r0 < rows; r0 += kThreads * kUnroll) {
    int sv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kThreads;
      sv[u] = r < rows ? ids[r] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (sv[u] < s0 || sv[u] >= s1) continue;
      const int r = r0 + u * kThreads;
      for (int c = 0; c < f.ncols; ++c) {
        const int v = (int)load_col(f, c, r);
        if (v) atomicAdd(&bins[c * span + sv[u] - s0], v);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    const int c = i / span, s = s0 + i - c * span;
    if (s >= s1) continue;
    const int fi = f.col_field[c];
    static_cast<int*>(f.dst[fi])[(size_t)s * f.width[fi] + f.col_sub[c]] = bins[i];
  }
}

// spec holds 4 int64 per field: source pointer, output pointer, width, FieldType.
int read_fields(const long long* spec, int nfields, bool ints_only, Fields* f) {
  if (nfields <= 0 || nfields > kMaxFields) return (int)cudaErrorInvalidValue;
  f->ncols = 0;
  for (int i = 0; i < nfields; ++i) {
    const long long* q = spec + 4 * i;
    const int width = (int)q[2], type = (int)q[3];
    if (width <= 0 || type < kF32 || type > kU8 || (ints_only && type == kF32) ||
        f->ncols + width > kMaxCols)
      return (int)cudaErrorInvalidValue;
    f->src[i] = (const void*)q[0];
    f->dst[i] = (void*)q[1];
    f->width[i] = width;
    f->type[i] = type;
    for (int c = 0; c < width; ++c) {
      f->col_field[f->ncols] = (unsigned char)i;
      f->col_sub[f->ncols] = (unsigned char)c;
      ++f->ncols;
    }
  }
  return 0;
}

// The kernels that may ask for more than 48 KB of dynamic shared memory, once per process.
int allow_large_smem() {
  static int err = -1;
  if (err < 0) {
    err = (int)cudaFuncSetAttribute(group_count, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kSmemBytes);
    if (!err)
      err = (int)cudaFuncSetAttribute(group_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kSmemBytes);
    if (!err)
      err = (int)cudaFuncSetAttribute(int_sums, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kSmemBytes);
  }
  return err;
}

// Streaming multiprocessors of the current device, read once a device.
int current_sms(int* sms) {
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= kMaxDevices)
    return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (!cache[dev]) {
    err = (int)cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err) return err;
  }
  *sms = cache[dev];
  return 0;
}

}  // namespace

// Plain C entry points for ctypes.  Each takes one array of int64 arguments (one ctypes
// argument converts fastest) and returns 0 or the first CUDA error of its launches.
// Pointers are device pointers; the stream is a cudaStream_t.  Every output element is
// written (empty segments get 0).  A field is 4 int64: source, output, width, FieldType.

// Fixed-order sums.  args: ids, rows, segments, stream, scratch, scratch_ints, nfields,
// fields.  With P = min(segments, 28,672), the scratch holds at least
// rows * columns + 264 * P + P + 2 int32.
extern "C" int cc_segment_sums(const long long* args) {
  const void* ids = (const void*)args[0];
  const int rows = (int)args[1], segments = (int)args[2];
  cudaStream_t st = (cudaStream_t)args[3];
  void* scratch = (void*)args[4];
  const long long scratch_ints = args[5];
  if (rows < 0 || segments <= 0) return (int)cudaErrorInvalidValue;
  Fields f;
  int err = read_fields(args + 7, (int)args[6], false, &f);
  if (err || (err = allow_large_smem())) return err;
  const int pass = min(segments, kPassSegments);
  if ((long long)rows * f.ncols + (long long)kMaxTiles * pass + pass + 2 > scratch_ints)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  if ((err = current_sms(&sms))) return err;
  unsigned* sorted = static_cast<unsigned*>(scratch);
  int* hist = reinterpret_cast<int*>(sorted + (size_t)rows * f.ncols);
  int* seg_start = hist + (size_t)kMaxTiles * pass;
  unsigned* ticket = reinterpret_cast<unsigned*>(seg_start + pass + 1);
  const int* id = static_cast<const int*>(ids);
  // one pass per kPassSegments segments: the count kernel keeps a counter a segment, the
  // scatter one a segment a warp, in shared memory
  for (int base = 0; base < segments; base += kPassSegments) {
    const Grouping g = plan_pass(rows, base, min(kPassSegments, segments - base), sms);
    const size_t per_segment = (size_t)g.segments * sizeof(int);
    group_count<<<g.tiles, kGroupThreads, per_segment, st>>>(id, g, hist, ticket);
    if ((err = (int)cudaGetLastError())) return err;
    group_offsets<<<(g.segments + 31) / 32, kGroupThreads, 0, st>>>(g, hist, seg_start, ticket);
    if ((err = (int)cudaGetLastError())) return err;
    group_scatter<<<g.tiles, kGroupThreads, per_segment * g.warps, st>>>(id, g, hist, seg_start,
                                                                          f, sorted);
    if ((err = (int)cudaGetLastError())) return err;
    const dim3 grid(g.segments, (f.ncols + kGroup - 1) / kGroup);
    group_walk<<<grid, 32, 0, st>>>(sorted, rows, base, seg_start, f);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

// The plan of a fixed-order call on the current device, as cc_segment_sums launches it.
// args: rows, segments.  out: passes, and the first pass's blocks, scatter warps a block,
// rows a block.
extern "C" int cc_segment_sums_plan(const long long* args, long long* out) {
  const int rows = (int)args[0], segments = (int)args[1];
  if (rows < 0 || segments <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = current_sms(&sms);
  if (err) return err;
  const Grouping g = plan_pass(rows, 0, min(kPassSegments, segments), sms);
  out[0] = (segments + kPassSegments - 1) / kPassSegments;
  out[1] = g.tiles;
  out[2] = g.warps;
  out[3] = g.block_rows;
  return 0;
}

// Exact integer sums.  args: ids, rows, segments, stream, nfields, fields.
extern "C" int cc_segment_counts(const long long* args) {
  const void* ids = (const void*)args[0];
  const int rows = (int)args[1], segments = (int)args[2];
  if (rows < 0 || segments <= 0) return (int)cudaErrorInvalidValue;
  Fields f;
  int err = read_fields(args + 5, (int)args[4], true, &f);
  if (err || (err = allow_large_smem())) return err;
  // about 256 bins a block, at most 132 blocks, as few more as shared memory needs
  const long long bins = (long long)f.ncols * segments;
  long long blocks = (bins + 255) / 256;
  if (blocks > 132) blocks = 132;
  const long long need = (segments + kSmemInts / f.ncols - 1) / (kSmemInts / f.ncols);
  if (blocks < need) blocks = need;
  const int span = (int)((segments + blocks - 1) / blocks);
  blocks = (segments + span - 1) / span;
  int_sums<<<(unsigned)blocks, kThreads, (size_t)f.ncols * span * sizeof(int),
             (cudaStream_t)args[3]>>>(static_cast<const int*>(ids), rows, segments, span, f);
  return (int)cudaGetLastError();
}
