// Segment sums for Hopper (sm_90a): out[s, c] = sum over r with ids[r] == s of values[r, c].
//
// Replaces the JAX package's two Pallas TPU kernels, segment_sum_pallas (flat one-hot
// MXU contraction, S <= 2048) and segment_sum_radix (two-digit one-hot, S <= 16384),
// both in cruise_control_tpu/ops/segments.py.  One source serves any S and any number of
// columns.  Ids outside [0, S) are dropped.  A call takes several value tensors ("fields",
// each [R] or [R, k], contiguous) under one id vector; a field is float32, int32 or a byte
// type (bool, uint8), and integer fields sum into int32.
//
// Two entry points, both deterministic, each with two routes chosen from the shape (the
// plan entry points report the route; a caller may force one to measure the other):
//
//  * cc_segment_sums, the fixed-order path (any float field).  Every float output is the
//    left-to-right f32 sum of its rows in row order -- bitwise the sequential CPU
//    scatter-add, on every launch.  No float atomics, no tensor cores, no FMA.  Both
//    routes make a stable grouping of the rows by segment and then walk it.  The rows are
//    cut into blocks in row order; the block count comes from the rows and the card (two
//    blocks an SM when there are rows enough), not from the segment count.
//    - one_pass (S <= 28,672 segments, unless the call has 400,000+ rows and either
//      more than 2,048 segments or 3+ fields): a counting sort on the segment itself.
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
//        Shared memory (224 KB) sets the warps: 8 up to S = 7,168, fewer above, so large
//        calls above 2,048 segments take the digits route.
//      group_walk: one warp per (segment, 32 columns); lane c streams column c of the
//        segment's sorted rows and adds them in order, the next 64 rows in flight while
//        it adds the current 64, so the serial add chain overlaps the loads.  Integer
//        columns add as int32 in the same pass.
//    - digits (the other calls): a stable LSD radix sort of (key, row) pairs, key = the
//      id, or S for a dropped id, in digits of at most 8 bits (2 up to 65,535 segments,
//      3 up to 16.7M).  Each digit pass is radix_count (a block's digit counts, 256 counters in
//      shared memory, so 8 warps whatever S is; blocks of 2,048 pairs, so that many are
//      in flight), radix_offsets (a block a digit scans its counts over the blocks; the
//      last block scans the digit totals) and radix_scatter (a stable scatter of the key
//      and the row index, rows ranked within a warp by ballots).  Stable passes keep
//      each segment's rows in ascending row order.  seg_bounds finds each segment's first
//      position by binary search in the sorted keys, gather_sorted writes every column in
//      that order (a thread a row, so the scattered reads run in parallel), and
//      group_walk adds each segment's rows as on the one_pass route: no pass depends on
//      S, and a segment holding most rows streams them contiguously.  A call of 3+
//      fields first packs each row's columns together (pack_rows), so the gather reads a
//      row from one or two sectors, not one a field.
//    Work is O(R * C + S * blocks) (one_pass) or O(R * (digits + C) + S log R) (digits).
//  * cc_segment_counts, the integer path (integer fields only): exact int32 sums.  The
//    output is zeroed on the stream (a memset), then blocks own ROW ranges and read each
//    id and value once:
//    - direct: every row adds its values into the output with int32 device atomics.
//    - shared (C * S fits a block's shared memory and rows outnumber bins
//      kSharedRowsPerBin to one): a block adds its rows into a private histogram of all
//      C * S bins with shared atomics, then adds its nonzero bins into the output.
//    Integer addition gives the same bits in any order, so both are exact on every
//    launch.  No float atomics anywhere.
//
// Bound on the card: a call reads R * (4 + bytes of a row's values) and writes S * C * 4
// bytes.  At the solver's shapes (R = 30,000 rows, S = 128 brokers, 4 to 11 columns) that
// is under half a microsecond of HBM time, and what bounds the fixed-order path is
// latency: dependent kernels of a few dependent memory round trips each, and in the walk
// the longest segment's serial add chain (one segment holding all R rows is R dependent
// adds).  At the scale ladder's shapes (3M rows, 16,384-60,032 segments) the digits
// route's sort moves 8 bytes a row a digit, and its gather reads a row's columns where
// the row lies (one or two sectors a row packed, else one a field) before the walk
// streams them.  The integer path's floor is the zeroing of S * C outputs (262 MB at
// config #4's topic tables) and one atomic a nonzero value.
// The caller allocates outputs and scratch; nothing here allocates, and every launch
// goes to the caller's stream.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxFields = 16;
constexpr int kMaxCols = 64;
constexpr int kGroup = 32;            // columns one walk warp carries
constexpr int kWalk = 64;             // rows a walk lane has in flight
constexpr int kGroupThreads = 256;    // the count and scatter blocks: 8 warps
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kThreads = 1024;        // the shared-histogram integer blocks
constexpr int kDirectThreads = 256;   // the direct integer blocks
constexpr int kDirectUnroll = 4;      // rows a direct thread has in flight
constexpr int kIdsAhead = 2;          // id loads a grouping warp keeps in flight
constexpr int kMaxTiles = 264;        // blocks of a fixed-order pass: two an SM of an H100
constexpr int kMinRows = 64;          // rows a scatter warp has at least (2 steps)
constexpr int kMoveCols = 8;          // columns a scatter lane has in flight
constexpr int kSmemBytes = 229376;    // dynamic shared memory a block asks for (224 KB)
constexpr int kSmemInts = kSmemBytes / 4;
constexpr int kPassSegments = kSmemInts / 2;  // segments one_pass could hold at all (28,672)
constexpr int kOnePassSegments = 2048;        // the fixed-order crossover (with kDigitsRows)
constexpr int kDigitBits = 8;                 // most bits a radix digit takes
constexpr int kBins = 1 << kDigitBits;
constexpr int kRadixWarpRows = 256;           // pairs a radix warp ranks (4 x 64)
constexpr int kRadixTile = kGroupWarps * kRadixWarpRows;  // pairs a radix block takes
constexpr int kPackFields = 3;                // fields from which the gather reads packed rows
constexpr int kPackRows = 256;                // rows a pack_rows block stages (a thread a row)
constexpr int kPackBytes = kPackRows * kMaxCols * 4;  // its shared memory at most (64 KB)
constexpr int kDigitsRows = 400000;           // rows from which a call may take digits
constexpr int kSharedRowsPerBin = 4;          // the integer crossover: shared at or above
constexpr int kMaxDevices = 64;
static_assert(kGroupThreads >= kBins, "radix_scatter gives each digit a thread");

enum FieldType { kF32 = 0, kI32 = 1, kU8 = 2 };
enum SumsRoute { kOnePass = 1, kDigits = 2 };
enum CountsRoute { kDirect = 1, kShared = 2 };

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

__device__ __forceinline__ int* int_dst(const Fields& f, int c, int s) {
  const int fi = f.col_field[c];
  return static_cast<int*>(f.dst[fi]) + (size_t)s * f.width[fi] + f.col_sub[c];
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

// How a fixed-order call's rows are cut: it groups them into `segments` groups (on the
// digits route the plan keeps its radix blocks here: a digit's values as the groups).
// Block t of `tiles` owns rows [t * block_rows, (t + 1) * block_rows); in the scatter its
// `warps` warps own `span` consecutive rows each, in order (the one_pass count kernel
// splits the block's rows over all its 8 warps).  `kbits` bits distinguish the groups.
struct Grouping {
  int rows, segments, tiles, warps, block_rows, span, kbits;
};

// The one_pass cut of a call: blocks from the rows and the card (two a streaming
// multiprocessor, at least kMinRows rows a scatter warp), scatter warps from shared memory
// (one counter a segment a warp).
Grouping plan_pass(int rows, int segments, int sms) {
  Grouping g;
  g.rows = rows;
  g.segments = segments;
  g.kbits = 0;
  while (g.kbits < 31 && (segments - 1) >> g.kbits) ++g.kbits;
  g.warps = max(1, min(kGroupWarps, kSmemInts / segments));
  const int max_tiles = max(1, min(kMaxTiles, 2 * sms));
  const int per_block = g.warps * kMinRows;
  g.tiles = max(1, min((rows + per_block - 1) / per_block, max_tiles));
  g.block_rows = max(32, ((rows + g.tiles - 1) / g.tiles + 31) / 32 * 32);
  g.tiles = max(1, (rows + g.block_rows - 1) / g.block_rows);
  g.span = ((g.block_rows + g.warps - 1) / g.warps + 31) / 32 * 32;
  return g;
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
      sv[k] = r < end ? ids[r] : -1;
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
  const int span = ((g.block_rows + kGroupWarps - 1) / kGroupWarps + 31) / 32 * 32;
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
// becomes, in place, the rows of that segment in the blocks before it; each segment's total
// goes to seg_start.  The last block to finish (a ticket taken after a fence) then scans
// the totals in segment order: seg_start[s] = first sorted position of segment s,
// seg_start[segments] = rows kept.  Integers only, so exact in any schedule.
__global__ void __launch_bounds__(kGroupThreads)
group_offsets(const Grouping g, int* __restrict__ hist, int* __restrict__ seg_start,
              unsigned* __restrict__ ticket) {
  constexpr int kParts = kGroupWarps;
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
      sv[k] = r < end ? ids[r] : -1;
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
group_walk(const unsigned* __restrict__ sorted, int rows, const int* __restrict__ seg_start,
           const __grid_constant__ Fields f) {
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
  const size_t o = (size_t)s * f.width[fi] + f.col_sub[c];
  if (is_float) static_cast<float*>(f.dst[fi])[o] = facc;
  else static_cast<int*>(f.dst[fi])[o] = iacc;
}

// -- the digits route ------------------------------------------------------------------

// One digit pass of the radix sort over `rows` (key, row) pairs: digit = (key >> shift)
// & (2^bits - 1).  Pass 0 reads the caller's ids (key = the id, or `segments` for a
// dropped one; row = the index); later passes read the last pass's pairs.
struct Radix {
  int rows, tiles;  // block t of `tiles` takes pairs [t * kRadixTile, (t + 1) * kRadixTile)
  int segments, shift, bits;
  const int* ids;
  const int* keys_in;
  const int* rows_in;
  int* keys_out;
  int* rows_out;
};

__device__ __forceinline__ int radix_key(const Radix& p, int i) {
  if (p.ids) {
    const int s = __ldg(p.ids + i);
    return in_range(s, p.segments) ? s : p.segments;
  }
  return p.keys_in[i];
}

// A warp's pass over pairs [begin, end), 32 at a time in order: `visit(key, digit,
// peers, row)` for each, peers being the lanes of the same digit.  Keys (and with
// `kRows` the row indices) are loaded kIdsAhead steps ahead.
template <bool kRows, typename Visit>
__device__ __forceinline__ void radix_walk(const Radix& p, int begin, int end, Visit visit) {
  const int lane = threadIdx.x & 31;
  const int mask = (1 << p.bits) - 1;
  for (int base = begin; base < end; base += 32 * kIdsAhead) {
    int kv[kIdsAhead], rv[kIdsAhead];
#pragma unroll
    for (int k = 0; k < kIdsAhead; ++k) {
      const int i = base + 32 * k + lane;
      kv[k] = i < end ? radix_key(p, i) : -1;
      rv[k] = kRows && i < end ? (p.ids ? i : p.rows_in[i]) : 0;
    }
#pragma unroll
    for (int k = 0; k < kIdsAhead; ++k) {
      if (base + 32 * k >= end) break;  // warp-uniform
      const bool ok = kv[k] >= 0;
      const int d = ok ? (kv[k] >> p.shift) & mask : 0;
      const unsigned peers = peers_of(d, ok, p.bits);
      if (ok) visit(kv[k], d, peers, rv[k]);
      __syncwarp();
    }
  }
}

// The pairs [begin, end) of warp `warp` of a radix block: kRadixWarpRows each, in order.
__device__ __forceinline__ void radix_range(const Radix& p, int warp, int* begin, int* end) {
  *begin = min(p.rows, (int)blockIdx.x * kRadixTile + warp * kRadixWarpRows);
  *end = min(p.rows, *begin + kRadixWarpRows);
}

// A digit pass's counts, digit-major: hist[d * tiles + t] = pairs of block t with digit d.
// Small blocks (kRadixTile pairs), so that many are in flight: a warp's ranking is a
// chain of dependent steps.  Block 0 clears radix_offsets' ticket.
__global__ void __launch_bounds__(kGroupThreads)
radix_count(const Radix p, int* __restrict__ hist, unsigned* __restrict__ ticket) {
  __shared__ int cnt[kBins];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bins = 1 << p.bits;
  if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0u;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  int begin, end;
  radix_range(p, warp, &begin, &end);
  radix_walk<false>(p, begin, end, [&](int, int d, unsigned peers, int) {
    if (lane == __ffs(peers) - 1) atomicAdd(&cnt[d], __popc(peers));
  });
  __syncthreads();
  for (int d = threadIdx.x; d < bins; d += blockDim.x) hist[(size_t)d * p.tiles + blockIdx.x] = cnt[d];
}

// A digit pass's offsets: block d scans digit d's counts over the blocks in block order
// (in place: a block's count becomes the pairs of digit d in the blocks before it) and
// keeps the digit's total; the last block to finish (a ticket taken after a fence) scans
// the totals in digit order: digit_start[d] = first position of digit d.  Integers only,
// so exact in any schedule.
__global__ void __launch_bounds__(kGroupThreads)
radix_offsets(int* __restrict__ hist, int tiles, int* __restrict__ digit_start,
              unsigned* __restrict__ ticket) {
  __shared__ int warp_sums[32];
  __shared__ bool last;
  const int total = block_exclusive_scan(hist + (size_t)blockIdx.x * tiles, tiles, warp_sums);
  if (threadIdx.x == 0) digit_start[blockIdx.x] = total;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int all = block_exclusive_scan(digit_start, gridDim.x, warp_sums);
  if (threadIdx.x == 0) digit_start[gridDim.x] = all;
}

// Exclusive scan of one value a thread over the block (at most 32 warps); returns this
// thread's prefix.
__device__ __forceinline__ int block_prefix(int x, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int y = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int z = __shfl_up_sync(kFull, y, d);
    if (lane >= d) y += z;
  }
  if (lane == 31) warp_sums[warp] = y;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int z = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += z;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int out = (warp > 0 ? warp_sums[warp - 1] : 0) + y - x;
  __syncthreads();
  return out;
}

// A digit pass's stable scatter: block t counts its warps' pairs of each digit again (a
// counter a digit a warp), ranks every pair within the block (digit, then warp, then
// lane order) into shared memory, then writes the block's pairs in that order: a
// digit's pairs of the block go to consecutive positions from the digit's start plus
// the block's offset (radix_offsets), so neighbouring threads store to neighbouring
// addresses.
__global__ void __launch_bounds__(kGroupThreads)
radix_scatter(const Radix p, const int* __restrict__ hist, const int* __restrict__ digit_start) {
  __shared__ int cur[kBins * kGroupWarps];  // [digit][warp]
  __shared__ int base[kBins];               // global position of the digit's first pair, less its local one
  __shared__ int skey[kRadixTile], srow[kRadixTile];
  __shared__ int warp_sums[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bins = 1 << p.bits, mask = bins - 1;
  for (int i = threadIdx.x; i < bins * kGroupWarps; i += blockDim.x) cur[i] = 0;
  __syncthreads();
  int begin, end;
  radix_range(p, warp, &begin, &end);
  radix_walk<false>(p, begin, end, [&](int, int d, unsigned peers, int) {
    if (lane == __ffs(peers) - 1) cur[d * kGroupWarps + warp] += __popc(peers);
  });
  __syncthreads();
  // thread d: the digit's pairs in the block, their first local position, then each
  // warp's local cursor (kGroupThreads >= kBins)
  const int d = threadIdx.x;
  int total = 0;
  if (d < bins) {
#pragma unroll
    for (int w = 0; w < kGroupWarps; ++w) total += cur[d * kGroupWarps + w];
  }
  const int local = block_prefix(total, warp_sums);
  if (d < bins) {
    base[d] = digit_start[d] + hist[(size_t)d * p.tiles + blockIdx.x] - local;
    int run = local;
#pragma unroll
    for (int w = 0; w < kGroupWarps; ++w) {
      const int c = cur[d * kGroupWarps + w];
      cur[d * kGroupWarps + w] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  radix_walk<true>(p, begin, end, [&](int key, int dg, unsigned peers, int row) {
    int* c = cur + dg * kGroupWarps + warp;
    const int pos = *c + __popc(peers & below);
    __syncwarp(peers);
    if (lane == __ffs(peers) - 1) *c += __popc(peers);
    skey[pos] = key;
    srow[pos] = row;
  });
  __syncthreads();
  const int n = min(kRadixTile, p.rows - (int)blockIdx.x * kRadixTile);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int key = skey[i];
    const int pos = base[(key >> p.shift) & mask] + i;
    p.keys_out[pos] = key;
    p.rows_out[pos] = srow[i];
  }
}

// seg_start[s] = first position of a key >= s in the sorted keys, for s in [0, segments]:
// each segment's rows are [seg_start[s], seg_start[s + 1]), and seg_start[segments] is
// the rows kept (dropped ids sort last, as key `segments`).
__global__ void __launch_bounds__(256)
seg_bounds(const int* __restrict__ keys, int rows, int segments, int* __restrict__ seg_start) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s <= segments; s += gridDim.x * blockDim.x) {
    int lo = 0, hi = rows;
    while (lo < hi) {
      const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
      if (keys[mid] < s) lo = mid + 1;
      else hi = mid;
    }
    seg_start[s] = lo;
  }
}

// The digits route's gather: position k of the sorted order takes row order[k]'s columns,
// sorted[c * rows + k], for the kept positions (seg_start[segments] of them), so that
// group_walk streams each segment's rows contiguously.  A thread a position, its
// columns' loads in flight together (from the packed rows where the call packed them);
// neighbouring threads store to neighbouring addresses.
__global__ void __launch_bounds__(256)
gather_sorted(const int* __restrict__ order, const int* __restrict__ kept_at, int rows,
              const unsigned* __restrict__ packed, const __grid_constant__ Fields f,
              unsigned* __restrict__ sorted) {
  const int kept = *kept_at;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < kept; k += gridDim.x * blockDim.x) {
    const int r = order[k];
    if (packed) {
      for (int c = 0; c < f.ncols; ++c) sorted[(size_t)c * rows + k] = packed[(size_t)r * f.ncols + c];
    } else {
      for (int c = 0; c < f.ncols; ++c) sorted[(size_t)c * rows + k] = load_col(f, c, r);
    }
  }
}

// A call of many fields packs each row's columns together before the walk, so that the
// walk reads a row's columns from one or two sectors and not from a sector a field:
// packed[r * ncols + c].  A block stages kPackRows rows in shared memory: thread t reads
// row r0 + t a column at a time (neighbouring threads, neighbouring rows), and the block
// writes the packed rows as one contiguous run.
__global__ void __launch_bounds__(kPackRows)
pack_rows(int rows, const __grid_constant__ Fields f, unsigned* __restrict__ packed) {
  extern __shared__ unsigned tile[];  // [row][column]
  const int nc = f.ncols;
  for (int r0 = blockIdx.x * kPackRows; r0 < rows; r0 += gridDim.x * kPackRows) {
    const int n = min(kPackRows, rows - r0);
    if ((int)threadIdx.x < n)
      for (int c = 0; c < nc; ++c) tile[threadIdx.x * nc + c] = load_col(f, c, r0 + threadIdx.x);
    __syncthreads();
    unsigned* out = packed + (size_t)r0 * nc;
    for (int i = threadIdx.x; i < n * nc; i += blockDim.x) out[i] = tile[i];
    __syncthreads();
  }
}

// -- the integer path ------------------------------------------------------------------

// Direct: every row adds its nonzero values into the (zeroed) output with int32 device
// atomics.  Each id and value is read once.
__global__ void __launch_bounds__(kDirectThreads)
int_direct(const int* __restrict__ ids, int rows, int segments, const __grid_constant__ Fields f) {
  const int stride = gridDim.x * blockDim.x;
  for (int r0 = blockIdx.x * blockDim.x + threadIdx.x; r0 < rows; r0 += stride * kDirectUnroll) {
    int sv[kDirectUnroll];
#pragma unroll
    for (int u = 0; u < kDirectUnroll; ++u) {
      const int r = r0 + u * stride;
      sv[u] = r < rows ? __ldg(ids + r) : -1;
    }
#pragma unroll
    for (int u = 0; u < kDirectUnroll; ++u) {
      if (!in_range(sv[u], segments)) continue;
      const int r = r0 + u * stride;
      for (int c = 0; c < f.ncols; ++c) {
        const int v = (int)load_col(f, c, r);
        if (v) atomicAdd(int_dst(f, c, sv[u]), v);
      }
    }
  }
}

// Shared: block g owns rows [g * block_rows, (g + 1) * block_rows) and adds them into a
// private histogram of every (column, segment) bin in shared memory, then adds its
// nonzero bins into the (zeroed) output with int32 device atomics.
__global__ void __launch_bounds__(kThreads)
int_shared(const int* __restrict__ ids, int rows, int segments, int block_rows,
           const __grid_constant__ Fields f) {
  extern __shared__ int bins[];  // [column][segment]
  const int nb = f.ncols * segments;
  for (int i = threadIdx.x; i < nb; i += kThreads) bins[i] = 0;
  __syncthreads();
  const int r0 = blockIdx.x * block_rows;
  const int r1 = min(rows, r0 + block_rows);
  constexpr int kUnroll = 4;
  for (int rb = r0 + threadIdx.x; rb < r1; rb += kThreads * kUnroll) {
    int sv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rb + u * kThreads;
      sv[u] = r < r1 ? __ldg(ids + r) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!in_range(sv[u], segments)) continue;
      const int r = rb + u * kThreads;
      for (int c = 0; c < f.ncols; ++c) {
        const int v = (int)load_col(f, c, r);
        if (v) atomicAdd(&bins[c * segments + sv[u]], v);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    const int v = bins[i];
    if (!v) continue;
    const int c = i / segments;
    atomicAdd(int_dst(f, c, i - c * segments), v);
  }
}

// -- host side -------------------------------------------------------------------------

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
      err = (int)cudaFuncSetAttribute(int_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kSmemBytes);
    if (!err)
      err = (int)cudaFuncSetAttribute(pack_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kPackBytes);
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

// The plan of a fixed-order call: the route (forced, or from S), the digits, the block
// cut and the scratch it needs.  route 0 when a forced route cannot take the call.
// On digits, g holds the radix blocks: tiles of kRadixTile pairs, 8 warps, and `pack`
// says whether the walk reads packed rows (kPackFields fields or more).
struct SumsPlan {
  int route, digits, bits, pack;
  Grouping g;
  long long scratch_ints;
};

SumsPlan plan_sums(int rows, int segments, int ncols, int nfields, int force, int sms) {
  SumsPlan p;
  const bool digits = segments > kPassSegments ||
                      (rows >= kDigitsRows && (segments > kOnePassSegments || nfields >= kPackFields));
  p.route = force ? force : (digits ? kDigits : kOnePass);
  if (p.route == kOnePass) {
    if (segments > kPassSegments) p.route = 0;
    p.digits = 0;
    p.bits = 0;
    p.pack = 0;
    p.g = plan_pass(rows, min(segments, kPassSegments), sms);
    p.scratch_ints = (long long)rows * ncols + (long long)(kMaxTiles + 1) * segments + 2;
  } else {
    int kbits = 0;  // bits of the largest key, `segments` (a dropped id)
    while (kbits < 31 && (segments >> kbits)) ++kbits;
    p.digits = (kbits + kDigitBits - 1) / kDigitBits;
    p.bits = (kbits + p.digits - 1) / p.digits;
    p.pack = nfields >= kPackFields;
    p.g.rows = rows;
    p.g.segments = 1 << p.bits;
    p.g.kbits = p.bits;
    p.g.tiles = max(1, (int)(((long long)rows + kRadixTile - 1) / kRadixTile));
    p.g.warps = kGroupWarps;
    p.g.block_rows = kRadixTile;
    p.g.span = kRadixWarpRows;
    p.scratch_ints = 4LL * rows + (long long)kBins * p.g.tiles + kBins + 2 + segments + 1 +
                     (p.pack ? 2LL : 1LL) * rows * ncols;
  }
  return p;
}

// The integer path's plan: the route and its blocks.
struct CountsPlan {
  int route, blocks, block_rows;
};

CountsPlan plan_counts(int rows, int segments, int ncols, int force, int sms) {
  CountsPlan p;
  const long long bins = (long long)ncols * segments;
  const bool fits = bins <= kSmemInts;
  p.route = force ? force : (fits && rows >= kSharedRowsPerBin * bins ? kShared : kDirect);
  if (p.route == kShared) {
    if (!fits) p.route = 0;
    // each block at least kSharedRowsPerBin rows a bin, so the flush stays the smaller
    // part; at most two blocks an SM
    const long long blocks = rows / ((long long)kSharedRowsPerBin * bins);
    p.blocks = blocks < 1 ? 1 : (blocks > 2 * sms ? 2 * sms : (int)blocks);
    p.block_rows = max(1, (rows + p.blocks - 1) / p.blocks);
    p.blocks = max(1, (rows + p.block_rows - 1) / p.block_rows);
  } else {
    const int per = kDirectThreads * kDirectUnroll;
    p.blocks = max(1, min(8 * sms, (int)(((long long)rows + per - 1) / per)));
    p.block_rows = 0;
  }
  return p;
}

}  // namespace

// Plain C entry points for ctypes.  Each takes one array of int64 arguments (one ctypes
// argument converts fastest) and returns 0 or the first CUDA error of its launches.
// Pointers are device pointers; the stream is a cudaStream_t.  Every output element is
// written (empty segments get 0).  A field is 4 int64: source, output, width, FieldType.
// `force` is 0 (the plan's route) or a route: 1 one_pass / direct, 2 digits / shared.

// Fixed-order sums.  args: ids, rows, segments, stream, scratch, scratch_ints, force,
// nfields, fields.  The scratch holds at least the plan's scratch_ints int32: one_pass
// rows * columns + 265 * segments + 2, digits 4 * rows + 264 * 256 + 258 + segments + 1.
extern "C" int cc_segment_sums(const long long* args) {
  const int* ids = (const int*)args[0];
  const int rows = (int)args[1], segments = (int)args[2];
  cudaStream_t st = (cudaStream_t)args[3];
  int* scratch = (int*)args[4];
  const long long scratch_ints = args[5];
  const int force = (int)args[6];
  if (rows < 0 || segments <= 0 || force < 0 || force > kDigits) return (int)cudaErrorInvalidValue;
  Fields f;
  int err = read_fields(args + 8, (int)args[7], false, &f);
  if (err || (err = allow_large_smem())) return err;
  int sms = 0;
  if ((err = current_sms(&sms))) return err;
  const SumsPlan plan = plan_sums(rows, segments, f.ncols, (int)args[7], force, sms);
  if (!plan.route || plan.scratch_ints > scratch_ints) return (int)cudaErrorInvalidValue;
  const Grouping& g = plan.g;
  if (plan.route == kOnePass) {
    unsigned* sorted = reinterpret_cast<unsigned*>(scratch);
    int* hist = scratch + (size_t)rows * f.ncols;
    int* seg_start = hist + (size_t)kMaxTiles * segments;
    unsigned* ticket = reinterpret_cast<unsigned*>(seg_start + segments + 1);
    const size_t per_segment = (size_t)segments * sizeof(int);
    group_count<<<g.tiles, kGroupThreads, per_segment, st>>>(ids, g, hist, ticket);
    if ((err = (int)cudaGetLastError())) return err;
    group_offsets<<<(segments + 31) / 32, kGroupThreads, 0, st>>>(g, hist, seg_start, ticket);
    if ((err = (int)cudaGetLastError())) return err;
    group_scatter<<<g.tiles, kGroupThreads, per_segment * g.warps, st>>>(ids, g, hist, seg_start,
                                                                          f, sorted);
    if ((err = (int)cudaGetLastError())) return err;
    const dim3 grid(segments, (f.ncols + kGroup - 1) / kGroup);
    group_walk<<<grid, 32, 0, st>>>(sorted, rows, seg_start, f);
    return (int)cudaGetLastError();
  }
  // digits: (key, row) pairs ping-pong between two buffers, one digit pass each
  int* keys[2] = {scratch, scratch + rows};
  int* order[2] = {scratch + 2 * (size_t)rows, scratch + 3 * (size_t)rows};
  int* hist = scratch + 4 * (size_t)rows;
  int* digit_start = hist + (size_t)kBins * g.tiles;
  unsigned* ticket = reinterpret_cast<unsigned*>(digit_start + kBins + 1);
  int* seg_start = digit_start + kBins + 2;
  unsigned* sorted = reinterpret_cast<unsigned*>(seg_start + segments + 1);
  unsigned* packed = plan.pack ? sorted + (size_t)rows * f.ncols : nullptr;
  if (packed && rows) {
    pack_rows<<<max(1, min(8 * sms, (rows + kPackRows - 1) / kPackRows)), kPackRows,
                (size_t)kPackRows * f.ncols * sizeof(unsigned), st>>>(rows, f, packed);
    if ((err = (int)cudaGetLastError())) return err;
  }
  for (int d = 0; d < plan.digits; ++d) {
    Radix p;
    p.rows = rows;
    p.tiles = g.tiles;
    p.segments = segments;
    p.shift = d * plan.bits;
    p.bits = plan.bits;
    p.ids = d == 0 ? ids : nullptr;
    p.keys_in = d == 0 ? nullptr : keys[(d - 1) & 1];
    p.rows_in = d == 0 ? nullptr : order[(d - 1) & 1];
    p.keys_out = keys[d & 1];
    p.rows_out = order[d & 1];
    radix_count<<<g.tiles, kGroupThreads, 0, st>>>(p, hist, ticket);
    if ((err = (int)cudaGetLastError())) return err;
    radix_offsets<<<g.segments, kGroupThreads, 0, st>>>(hist, g.tiles, digit_start, ticket);
    if ((err = (int)cudaGetLastError())) return err;
    radix_scatter<<<g.tiles, kGroupThreads, 0, st>>>(p, hist, digit_start);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const int last = (plan.digits - 1) & 1;
  const int bound_blocks = max(1, min(8 * sms, (segments + 1 + 255) / 256));
  seg_bounds<<<bound_blocks, 256, 0, st>>>(keys[last], rows, segments, seg_start);
  if ((err = (int)cudaGetLastError())) return err;
  if (rows) {
    gather_sorted<<<max(1, min(16 * sms, (rows + 255) / 256)), 256, 0, st>>>(
        order[last], seg_start + segments, rows, packed, f, sorted);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const dim3 grid(segments, (f.ncols + kGroup - 1) / kGroup);
  group_walk<<<grid, 32, 0, st>>>(sorted, rows, seg_start, f);
  return (int)cudaGetLastError();
}

// The plan of a fixed-order call on the current device, as cc_segment_sums launches it.
// args: rows, segments, columns, fields, force.  out: route (0 when a forced route cannot
// take the call), digits, blocks, scatter warps a block, rows a block, scratch int32,
// whether the walk reads packed rows.
extern "C" int cc_segment_sums_plan(const long long* args, long long* out) {
  const int rows = (int)args[0], segments = (int)args[1], ncols = (int)args[2];
  const int nfields = (int)args[3], force = (int)args[4];
  if (rows < 0 || segments <= 0 || ncols <= 0 || nfields <= 0 || force < 0 || force > kDigits)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = current_sms(&sms);
  if (err) return err;
  const SumsPlan p = plan_sums(rows, segments, ncols, nfields, force, sms);
  out[0] = p.route;
  out[1] = p.digits;
  out[2] = p.g.tiles;
  out[3] = p.g.warps;
  out[4] = p.g.block_rows;
  out[5] = p.scratch_ints;
  out[6] = p.pack;
  return 0;
}

// Exact integer sums.  args: ids, rows, segments, stream, force, nfields, fields.  The
// outputs are zeroed first (one memset a run of adjacent outputs).
extern "C" int cc_segment_counts(const long long* args) {
  const int* ids = (const int*)args[0];
  const int rows = (int)args[1], segments = (int)args[2];
  cudaStream_t st = (cudaStream_t)args[3];
  const int force = (int)args[4];
  if (rows < 0 || segments <= 0 || force < 0 || force > kShared) return (int)cudaErrorInvalidValue;
  Fields f;
  int err = read_fields(args + 6, (int)args[5], true, &f);
  if (err || (err = allow_large_smem())) return err;
  int sms = 0;
  if ((err = current_sms(&sms))) return err;
  const CountsPlan plan = plan_counts(rows, segments, f.ncols, force, sms);
  if (!plan.route) return (int)cudaErrorInvalidValue;
  const long long nfields = args[5];
  for (int i = 0; i < nfields;) {
    char* start = static_cast<char*>(f.dst[i]);
    size_t bytes = 0;
    for (; i < nfields && static_cast<char*>(f.dst[i]) == start + bytes; ++i)
      bytes += (size_t)segments * f.width[i] * sizeof(int);
    if ((err = (int)cudaMemsetAsync(start, 0, bytes, st))) return err;
  }
  if (rows == 0) return 0;
  if (plan.route == kShared) {
    int_shared<<<plan.blocks, kThreads, (size_t)f.ncols * segments * sizeof(int), st>>>(
        ids, rows, segments, plan.block_rows, f);
  } else {
    int_direct<<<plan.blocks, kDirectThreads, 0, st>>>(ids, rows, segments, f);
  }
  return (int)cudaGetLastError();
}

// The plan of an integer call on the current device.  args: rows, segments, columns,
// force.  out: route (0 when a forced route cannot take the call), blocks.
extern "C" int cc_segment_counts_plan(const long long* args, long long* out) {
  const int rows = (int)args[0], segments = (int)args[1], ncols = (int)args[2];
  const int force = (int)args[3];
  if (rows < 0 || segments <= 0 || ncols <= 0 || force < 0 || force > kShared)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = current_sms(&sms);
  if (err) return err;
  const CountsPlan p = plan_counts(rows, segments, ncols, force, sms);
  out[0] = p.route;
  out[1] = p.blocks;
  return 0;
}
