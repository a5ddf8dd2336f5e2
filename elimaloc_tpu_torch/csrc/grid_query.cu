// Kernel Y: the hash grid's one-shot queries (K13) — kernel Q's query entry
// redesigned for the H100.
//
// Replaces elimaloc_tpu/map/grid.py:query_nearest_point (:181),
// query_nearest_point_cov (:211), query_nearest_voxel_cov (:233) and
// query_all_voxel_cov (:254), each with its lookup (:153). Its reference is
// kernel Q's query entry (hash_correspond.cu: hash_query_kernel, one thread
// a query walking the 27 probe windows and up to 27 x M points one after
// another), which launches on no path and which Y equals bit for bit on
// every output: rows, slots, valid flags, targets, means, covariances, with
// the same null-output skips.
//
// What held Q back: a downsampled scan's queries (18,944 at the headline)
// are 148 CTAs of one thread a query on 132 SMs, each thread a chain of
// dependent loads (27 probe windows, then each voxel's points), neighbouring
// lanes reading different voxels. Y gives each query a warp (P2P, GICP, VGICP; 8 queries
// a CTA of 256 threads), or a group of 8 lanes (AVGICP: lane 8 g + o, o < 7,
// holds face voxel o of the warp's query g; 4 queries a warp, 32 a CTA):
//   1. every lane reads the query and forms its voxel floor(q / voxel)
//      (IEEE division, as Q); lane o < 27 forms neighbour o's coords in
//      OFFSETS_27 order (OFFSETS_7 for AVGICP), runs its probe window with
//      hash.cuh's lookup (unchanged) and reads the row's count: the 27
//      probe windows in parallel;
//   2. P2P and GICP: the counts' warp prefix sum numbers the neighbourhood's
//      candidates j = 0 .. total - 1 in (offset, slot) order. In round t the
//      warp reads candidates t .. t + 31, lane l candidate t + l: its voxel
//      is the first lane whose inclusive prefix exceeds j (a binary search of
//      5 shuffles), its slot j minus that voxel's exclusive prefix. A
//      voxel's candidates are consecutive slots, so a round reads each
//      voxel's points as one contiguous run. The walk takes ceil(total /
//      32) rounds, not one per occupied voxel as a voxel-by-voxel walk
//      (the lanes over one voxel's slots at a time) would.
//      d2 = (dx dx + dy dy) + dz dz with no FMA (sq_dist's arithmetic in
//      hash_correspond.cuh); each lane keeps its first strict minimum, and
//      a butterfly of shuffles takes the lexicographic minimum of (d2, j),
//      which is the sequential first strict minimum in (offset, slot)
//      order, as nearest_point keeps it. A NaN or +inf distance is never
//      kept; with none kept the result is offset 0's row, slot 0 and +inf;
//   3. VGICP: lane o's distance to its occupied voxel's mean, then the
//      lexicographic minimum of (d2, o) (nearest_voxel's first minimum);
//   4. AVGICP: each lane its own pair: occupied, within max_dist, and its
//      mean / covariance or the substitutes;
//   5. the outputs in parallel: lanes 0-8 the 9 covariance floats, 9-11 the
//      mean, 12-14 the target, 15, 16, 17 row, slot and valid. AVGICP: each
//      lane stages its pair's in shared memory, and the CTA writes its 224
//      pairs' rows, slots, flags, covariances, means (and targets) as
//      contiguous runs (written lane by lane at a 36-byte stride, the
//      kernel took 0.0209 ms on the H100, staged 0.0079; PERF.md §6).
// Every float operation is one of Q's with the same rounding (exact
// __fmul_rn / __fadd_rn / __fsub_rn, comparisons, copies), so Y needs no
// shared compiled copy of Q's device functions: it keeps its own copy of
// the search.
//
// Bound: bytes. Per query its 12 B in, its probe windows (8 B a slot), its
// neighbours' counts (4 B) and points (12 B each; VGICP / AVGICP: the means)
// and its match's payload, each distinct voxel read once, and the outputs;
// ~9 operations a candidate, ~40 a lookup.
//
// The launch floor: launch_floor_kernel does nothing; its device time is
// the floor under any launch (measured beside Q's lookup entry).
#include "common.cuh"
#include "hash.cuh"

using namespace elm;

namespace {

constexpr int kQueryCta = 256;                       // threads a CTA
constexpr int kWarpQueries = kQueryCta / 32;         // P2P / GICP / VGICP: a warp a query
constexpr int kPairLanes = 8;                        // AVGICP: lanes a query (7 used)
constexpr int kPairQueries = kQueryCta / kPairLanes;  // AVGICP queries a CTA
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;                    // no candidate kept
enum Method { kP2P = 0, kGICP = 1, kVGICP = 2, kAVGICP = 3 };

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// (p - q) . (p - q) as ((dx dx + dy dy) + dz dz), each step IEEE-rounded
__device__ __forceinline__ float dist2(const float* p, const float* q) {
  const float d0 = sub(p[0], q[0]), d1 = sub(p[1], q[1]), d2 = sub(p[2], q[2]);
  return add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2));
}

// The row of the neighbour voxel ``o`` of ``qv`` (OFFSETS_7 with ``seven``,
// else OFFSETS_27).
__device__ __forceinline__ int neighbour_row(const HashGrid& g, const int* qv, int o,
                                             bool seven) {
  int d[3], c[3];
  if (seven) {
    offset7(o, d);
  } else {
    offset27(o, d);
  }
  for (int k = 0; k < 3; ++k) c[k] = qv[k] + d[k];
  return lookup(g, c);
}

// The first lane w whose inclusive prefix ``incl`` (non-decreasing over the
// lanes) exceeds j, for j below lane 31's: a binary search of 5 shuffles,
// each lane its own j. Every lane of the warp must call it.
__device__ __forceinline__ int owner(int incl, int j) {
  int lo = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    if (__shfl_sync(kFull, incl, lo + s - 1) <= j) lo += s;
  return lo;
}

// The warp's lexicographic minimum of (d2, j), on every lane.
__device__ __forceinline__ void warp_argmin(float& d2, int& j) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float od = __shfl_xor_sync(kFull, d2, s);
    const int oj = __shfl_xor_sync(kFull, j, s);
    if (od < d2 || (od == d2 && oj < j)) {
      d2 = od;
      j = oj;
    }
  }
}

__device__ __forceinline__ void load_query(const float* queries, int i, const HashGrid& g,
                                           float* q, int* qv) {
  for (int k = 0; k < 3; ++k) q[k] = queries[3 * (size_t)i + k];
  for (int k = 0; k < 3; ++k) qv[k] = (int)floorf(q[k] / g.voxel);
}

// P2P, GICP, VGICP: one warp a query (``kWarpQueries`` a CTA).
template <int kMethod>
__global__ void __launch_bounds__(kQueryCta) grid_query_kernel(
    const HashGrid g, const float* __restrict__ queries, int n,
    const float* __restrict__ max_dist, int* __restrict__ rows_out,
    int* __restrict__ slots_out, bool* __restrict__ valid_out, float* __restrict__ tgt_out,
    float* __restrict__ mean_out, float* __restrict__ cov_out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpQueries + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp
  float q[3];
  int qv[3];
  load_query(queries, i, g, q, qv);
  const float md = max_dist[0];
  const float md2 = mul(md, md);
  const int row = lane < 27 ? neighbour_row(g, qv, lane, false) : g.sentinel;
  const int cnt = max(g.counts[row], 0);  // the sentinel's is 0

  float bd = inf();
  int bj = kNone;
  int incl = 0, excl = 0;
  if (kMethod == kVGICP) {
    if (lane < 27 && cnt > 0) {
      const float dd = dist2(g.vmean + (size_t)row * 3, q);
      if (dd < bd) {
        bd = dd;
        bj = lane;
      }
    }
  } else {
    incl = lane < 27 ? cnt : 0;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += u;
    }
    excl = incl - (lane < 27 ? cnt : 0);
    const int total = __shfl_sync(kFull, incl, 31);
    for (int t = 0; t < total; t += 32) {
      const int j = t + lane;
      const int o = owner(incl, j);
      const int orow = __shfl_sync(kFull, row, o);
      const int oexcl = __shfl_sync(kFull, excl, o);
      if (j < total) {
        const float dd = dist2(g.points + ((size_t)orow * g.m + (j - oexcl)) * 3, q);
        if (dd < bd) {
          bd = dd;
          bj = j;
        }
      }
    }
  }
  warp_argmin(bd, bj);  // warp-uniform from here
  int brow = __shfl_sync(kFull, row, 0), bslot = 0;
  if (bj != kNone) {
    if (kMethod == kVGICP) {
      brow = __shfl_sync(kFull, row, bj);
    } else {
      const int o = owner(incl, bj);
      brow = __shfl_sync(kFull, row, o);
      bslot = bj - __shfl_sync(kFull, excl, o);
    }
  }
  const bool near = bd < md2;
  const size_t pt = (size_t)brow * g.m + bslot;
  if (lane < 9) {
    if (cov_out != nullptr) {
      float c = (lane % 4 == 0) ? 1.0f : 0.0f;
      if (near) c = kMethod == kGICP ? g.pcov[pt * 9 + lane] : g.vcov[(size_t)brow * 9 + lane];
      cov_out[(size_t)i * 9 + lane] = c;
    }
  } else if (lane < 12) {
    if (mean_out != nullptr) {
      const int k = lane - 9;
      float v = q[k];
      if (near) v = kMethod == kGICP ? g.pmean[pt * 3 + k] : g.vmean[(size_t)brow * 3 + k];
      mean_out[(size_t)i * 3 + k] = v;
    }
  } else if (lane < 15) {
    if (tgt_out != nullptr) {
      const int k = lane - 12;
      tgt_out[(size_t)i * 3 + k] = near ? g.points[pt * 3 + k] : q[k];
    }
  } else if (lane == 15) {
    if (rows_out != nullptr) rows_out[i] = brow;
  } else if (lane == 16) {
    if (slots_out != nullptr) slots_out[i] = bslot;
  } else if (lane == 17) {
    if (valid_out != nullptr) valid_out[i] = near;
  }
}

// AVGICP: lane 8 g + o (o < 7) holds query g's face voxel o; the CTA's
// pair outputs (32 queries x 7 pairs, at i * 7 + o) are staged in shared
// memory, then written as contiguous runs by the whole CTA.
__global__ void __launch_bounds__(kQueryCta) grid_query_pairs_kernel(
    const HashGrid g, const float* __restrict__ queries, int n,
    const float* __restrict__ max_dist, int* __restrict__ rows_out,
    int* __restrict__ slots_out, bool* __restrict__ valid_out, float* __restrict__ tgt_out,
    float* __restrict__ mean_out, float* __restrict__ cov_out) {
  constexpr int kPairs = kPairQueries * 7;
  __shared__ float s_cov[kPairs * 9];
  __shared__ float s_mean[kPairs * 3];
  __shared__ float s_tgt[kPairs * 3];
  __shared__ int s_row[kPairs];
  __shared__ bool s_valid[kPairs];
  const int o = threadIdx.x % kPairLanes;
  const int qi = threadIdx.x / kPairLanes;
  const int i0 = blockIdx.x * kPairQueries;
  const int i = i0 + qi;
  if (i < n && o < 7) {
    float q[3];
    int qv[3];
    load_query(queries, i, g, q, qv);
    const float md = max_dist[0];
    const float md2 = mul(md, md);
    const int row = neighbour_row(g, qv, o, true);
    const bool near = g.counts[row] > 0 && dist2(g.vmean + (size_t)row * 3, q) < md2;
    const int at = qi * 7 + o;
    const size_t pt = (size_t)row * g.m;
    s_row[at] = row;
    s_valid[at] = near;
    if (tgt_out != nullptr)
      for (int k = 0; k < 3; ++k) s_tgt[at * 3 + k] = near ? g.points[pt * 3 + k] : q[k];
    if (mean_out != nullptr)
      for (int k = 0; k < 3; ++k) s_mean[at * 3 + k] = near ? g.vmean[(size_t)row * 3 + k] : q[k];
    if (cov_out != nullptr)
      for (int k = 0; k < 9; ++k)
        s_cov[at * 9 + k] = near ? g.vcov[(size_t)row * 9 + k] : ((k % 4 == 0) ? 1.0f : 0.0f);
  }
  __syncthreads();
  const int pairs = (min(n, i0 + kPairQueries) - i0) * 7;
  const size_t base = (size_t)i0 * 7;
  for (int e = threadIdx.x; e < pairs; e += kQueryCta) {
    if (rows_out != nullptr) rows_out[base + e] = s_row[e];
    if (slots_out != nullptr) slots_out[base + e] = 0;
    if (valid_out != nullptr) valid_out[base + e] = s_valid[e];
  }
  if (cov_out != nullptr)
    for (int e = threadIdx.x; e < pairs * 9; e += kQueryCta) cov_out[base * 9 + e] = s_cov[e];
  if (mean_out != nullptr)
    for (int e = threadIdx.x; e < pairs * 3; e += kQueryCta) mean_out[base * 3 + e] = s_mean[e];
  if (tgt_out != nullptr)
    for (int e = threadIdx.x; e < pairs * 3; e += kQueryCta) tgt_out[base * 3 + e] = s_tgt[e];
}

__global__ void launch_floor_kernel() {}

}  // namespace

// The four grid queries on ``n`` world queries [n, 3] (``method``: 0 P2P, 1
// GICP, 2 VGICP, 3 AVGICP); the outputs as elm_hash_query's, null ones
// skipped.
extern "C" int elm_grid_query(
    const int* table, const int* table_fp, int table_size, int max_probe, int sentinel,
    const float* points, int m, const int* counts, const float* pcov, const float* pmean,
    const float* vmean, const float* vcov, float voxel, const float* queries, int n,
    const float* max_dist, int method, int* rows_out, int* slots_out, bool* valid_out,
    float* tgt_out, float* mean_out, float* cov_out, cudaStream_t stream) {
  const HashGrid g{table, table_fp, table_size, max_probe, sentinel, points, m,
                   counts, pcov, pmean, vmean, vcov, voxel};
  if (method < kP2P || method > kAVGICP) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  if (method == kAVGICP) {
    grid_query_pairs_kernel<<<(n + kPairQueries - 1) / kPairQueries, kQueryCta, 0, stream>>>(
        g, queries, n, max_dist, rows_out, slots_out, valid_out, tgt_out, mean_out, cov_out);
  } else {
    const auto kernel = method == kP2P    ? grid_query_kernel<kP2P>
                        : method == kGICP ? grid_query_kernel<kGICP>
                                          : grid_query_kernel<kVGICP>;
    kernel<<<(n + kWarpQueries - 1) / kWarpQueries, kQueryCta, 0, stream>>>(
        g, queries, n, max_dist, rows_out, slots_out, valid_out, tgt_out, mean_out, cov_out);
  }
  return (int)cudaGetLastError();
}

// One launch of an empty kernel (the launch floor).
extern "C" int elm_launch_floor(cudaStream_t stream) {
  launch_floor_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}
