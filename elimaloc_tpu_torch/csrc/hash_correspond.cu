// Kernel Q: the hash-grid backend (K13) — the correspondence search of one
// GN iteration fused with its Gauss-Newton partial sums, plus a query-only
// entry and a lookup entry.
//
// Replaces elimaloc_tpu/map/grid.py:lookup (:153, with _hash / _fingerprint
// :144-150), the four queries query_nearest_point (:181),
// query_nearest_point_cov (:211), query_nearest_voxel_cov (:233) and
// query_all_voxel_cov (:254), and register/icp.py:_iteration (:429) with
// the method tails _p2p_tail (:283), _gicp_tail (:324), _voxcov_tail (:354)
// and _avg_voxcov_tail (:381). On the TPU each query is a masked gather of
// its whole probe window and of the 27 neighbour voxels' M points
// ([N, 27, M, 3]), an argmin over them, then the tails as einsums over
// [N] rows. On Hopper one thread owns one source point:
//   1. q = R s + t in the fixed order ((R0 s0 + R1 s1) + R2 s2) + t
//      (common.cuh: pose_query) and its voxel floor(q / voxel) (IEEE
//      division);
//   2. the 27 neighbour voxels (AVGICP: the 7 face-adjacent ones) in the
//      offset order of OFFSETS_27 / OFFSETS_7, each looked up by its probe
//      window (hash.cuh: lookup; exact uint32 arithmetic);
//   3. the method's search: P2P and GICP scan the points of each voxel
//      (up to its count; the rest are +inf by the MapGrid's padding) in
//      (offset, slot) order and keep the first strict minimum of
//      d2 = (dx dx + dy dy) + dz dz, with no FMA (equal to the plain
//      version bit for bit); an empty neighbourhood gives offset 0's row
//      and slot 0, as argmin does. VGICP: the first minimum over the
//      occupied voxels' means. AVGICP: each of the 7 voxels that is
//      occupied and within max_dist;
//   4. a match is valid within max_dist and where the source point is;
//      the method's row tail (common.cuh: p2p_row, gicp_row, vgicp_row,
//      avgicp_pair / avgicp_finish), the substitutes of an invalid match
//      as in grid.py (identity covariance, the query as mean). The radar
//      form (use_radar_cov) reads the row's radar covariance in query
//      order [N, 3, 3] (kernel P's output) and is its own template
//      instantiation; every row of the scan, valid or not, forms its M
//      there, as the plain sums over all N rows do;
//   5. each CTA sums its threads' rows in thread order into its partials
//      (18 for P2P in kernel A's layout, 44 in E/F/G's), and
//      reduce_partials_kernel reduces them in a fixed order (no float
//      atomics), so kernel M consumes the sums unchanged.
// The query-only entry runs steps 1-3 on world queries and writes the four
// queries' per-query outputs (rows, slots, valid flags, targets, means,
// covariances); the lookup entry maps voxel coords to rows.
//
// Bound: bytes. Per source point and GN iteration: up to 27 probe windows
// (8 B a slot), the neighbour voxels' counts and points (12 B a point) —
// ~27 x M x 12 B at most, ~10 KB at M = 30 — and the match's covariance
// and mean (48 B; 84 B with radar); ~6 operations per candidate and ~300
// per matched row. One thread per point leaves the gathers latency-bound;
// a warp per point is a later design.
#include "common.cuh"
#include "hash.cuh"

using namespace elm;

namespace {

constexpr int kHashThreads = 128;
constexpr int kP2PSums = 18;
enum Method { kP2P = 0, kGICP = 1, kVGICP = 2, kAVGICP = 3 };

struct Nearest {
  int row, slot;
  float d2;
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float sq_dist(const float* p, const float* q) {
  const float d0 = sub(p[0], q[0]), d1 = sub(p[1], q[1]), d2 = sub(p[2], q[2]);
  return add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2));
}

__device__ __forceinline__ int neighbour(const HashGrid& g, const int* qv, int o, bool seven) {
  int d[3], c[3];
  if (seven) {
    offset7(o, d);
  } else {
    offset27(o, d);
  }
  for (int i = 0; i < 3; ++i) c[i] = qv[i] + d[i];
  return lookup(g, c);
}

// The nearest map point of the 27-voxel neighbourhood (grid.py:181-208).
__device__ __forceinline__ Nearest nearest_point(const HashGrid& g, const float* q,
                                                 const int* qv) {
  Nearest b{0, 0, inf()};
  for (int o = 0; o < 27; ++o) {
    const int row = neighbour(g, qv, o, false);
    if (o == 0) b.row = row;
    const float* p = g.points + (size_t)row * g.m * 3;
    const int cnt = g.counts[row];
    for (int k = 0; k < cnt; ++k) {
      const float dd = sq_dist(p + 3 * k, q);
      if (dd < b.d2) {
        b.d2 = dd;
        b.row = row;
        b.slot = k;
      }
    }
  }
  return b;
}

// The neighbourhood voxel whose mean is nearest (grid.py:233-251).
__device__ __forceinline__ Nearest nearest_voxel(const HashGrid& g, const float* q,
                                                 const int* qv) {
  Nearest b{0, 0, inf()};
  for (int o = 0; o < 27; ++o) {
    const int row = neighbour(g, qv, o, false);
    if (o == 0) b.row = row;
    if (g.counts[row] <= 0) continue;
    const float dd = sq_dist(g.vmean + (size_t)row * 3, q);
    if (dd < b.d2) {
      b.d2 = dd;
      b.row = row;
    }
  }
  return b;
}

__device__ __forceinline__ void identity(float* C) {
  for (int k = 0; k < 9; ++k) C[k] = (k % 4 == 0) ? 1.0f : 0.0f;
}

__device__ __forceinline__ void copy(const float* from, int n, float* to) {
  for (int k = 0; k < n; ++k) to[k] = from[k];
}

template <int kMethod, bool kRadar>
__global__ void __launch_bounds__(kHashThreads) hash_search_kernel(
    const HashGrid g, const float* __restrict__ src, const bool* __restrict__ valid, int n,
    const float* __restrict__ pose, const float* __restrict__ max_dist,
    const float* __restrict__ radar, float* __restrict__ partials) {
  constexpr int kParts = kMethod == kP2P ? kP2PSums : kGnSums;
  __shared__ float part[kHashThreads * kParts];
  const int i = blockIdx.x * kHashThreads + threadIdx.x;
  float* pr = part + threadIdx.x * kParts;
  for (int k = 0; k < kParts; ++k) pr[k] = 0.0f;
  if (i < n) {
    SlotQuery u;
    pose_query(u, pose, src + 3 * (size_t)i, g.voxel);
    u.row = i;
    u.live = true;  // every row reaches the tails (the radar form's masked M)
    const bool live = valid[i];
    const float md = max_dist[0];
    const float md2 = mul(md, md);
    if (kMethod == kP2P || kMethod == kGICP) {
      const Nearest b = nearest_point(g, u.q, u.qv);
      const bool near = b.d2 < md2;
      const size_t at = (size_t)b.row * g.m + b.slot;
      if (kMethod == kP2P) {
        if (near && live) p2p_row(u, g.points + at * 3, md, pr);
      } else {
        float C[9], mu[3] = {u.q[0], u.q[1], u.q[2]};
        identity(C);
        if (near) {
          copy(g.pcov + at * 9, 9, C);
          copy(g.pmean + at * 3, 3, mu);
        }
        gicp_row<kRadar>(u, near && live, C, mu, md, radar, pr);
      }
    } else if (kMethod == kVGICP) {
      const Nearest b = nearest_voxel(g, u.q, u.qv);
      const bool near = b.d2 < md2;
      float C[9], mu[3] = {u.q[0], u.q[1], u.q[2]};
      identity(C);
      if (near) {
        copy(g.vcov + (size_t)b.row * 9, 9, C);
        copy(g.vmean + (size_t)b.row * 3, 3, mu);
      }
      vgicp_row<kRadar>(u, near && live, C, mu, md, radar, pr);
    } else {
      AvgAcc acc = avg_acc();
      for (int o = 0; o < 7; ++o) {
        const int row = neighbour(g, u.qv, o, true);
        float C[9], mu[3] = {u.q[0], u.q[1], u.q[2]};
        float d[3] = {0.0f, 0.0f, 0.0f}, d2 = 0.0f;
        bool near = false;
        identity(C);
        if (g.counts[row] > 0) {
          const float* vm = g.vmean + (size_t)row * 3;
          for (int k = 0; k < 3; ++k) d[k] = sub(vm[k], u.q[k]);
          d2 = add(add(mul(d[0], d[0]), mul(d[1], d[1])), mul(d[2], d[2]));
          near = d2 < md2;
        }
        if (near) {
          copy(g.vcov + (size_t)row * 9, 9, C);
          copy(g.vmean + (size_t)row * 3, 3, mu);
        }
        avgicp_pair<kRadar>(u, near && live, C, mu, d, d2, md, radar, acc, pr);
      }
      avgicp_finish<kRadar>(u, acc, pr);
    }
  }
  __syncthreads();
  slot_partials(part, kHashThreads, kParts, partials + (size_t)blockIdx.x * kParts);
}

// Per-query outputs of the four grid queries (``k`` = 1 row per query, 7
// for AVGICP): rows, slots (0 for the voxel queries), valid flags, the
// matched point (P2P, GICP; the query where invalid), the mean (GICP: the
// point's neighbourhood mean; VGICP / AVGICP: the voxel mean) and the
// covariance (identity where invalid). Null outputs are skipped.
template <int kMethod>
__global__ void __launch_bounds__(kHashThreads) hash_query_kernel(
    const HashGrid g, const float* __restrict__ queries, int n,
    const float* __restrict__ max_dist, int* __restrict__ rows_out,
    int* __restrict__ slots_out, bool* __restrict__ valid_out, float* __restrict__ tgt_out,
    float* __restrict__ mean_out, float* __restrict__ cov_out) {
  const int i = blockIdx.x * kHashThreads + threadIdx.x;
  if (i >= n) return;
  const float q[3] = {queries[3 * (size_t)i], queries[3 * (size_t)i + 1],
                      queries[3 * (size_t)i + 2]};
  int qv[3];
  for (int k = 0; k < 3; ++k) qv[k] = (int)floorf(q[k] / g.voxel);
  const float md = max_dist[0];
  const float md2 = mul(md, md);
  const int pairs = kMethod == kAVGICP ? 7 : 1;
  for (int o = 0; o < pairs; ++o) {
    Nearest b;
    bool near;
    if (kMethod == kAVGICP) {
      b = Nearest{neighbour(g, qv, o, true), 0, inf()};
      near = g.counts[b.row] > 0 && sq_dist(g.vmean + (size_t)b.row * 3, q) < md2;
    } else {
      b = kMethod == kVGICP ? nearest_voxel(g, q, qv) : nearest_point(g, q, qv);
      near = b.d2 < md2;
    }
    const size_t at = (size_t)i * pairs + o;
    const size_t pt = (size_t)b.row * g.m + b.slot;
    if (rows_out != nullptr) rows_out[at] = b.row;
    if (slots_out != nullptr) slots_out[at] = b.slot;
    if (valid_out != nullptr) valid_out[at] = near;
    if (tgt_out != nullptr) copy(near ? g.points + pt * 3 : q, 3, tgt_out + at * 3);
    if (mean_out != nullptr) {
      const float* m = kMethod == kGICP ? g.pmean + pt * 3 : g.vmean + (size_t)b.row * 3;
      copy(near ? m : q, 3, mean_out + at * 3);
    }
    if (cov_out != nullptr) {
      float C[9];
      identity(C);
      if (near) copy(kMethod == kGICP ? g.pcov + pt * 9 : g.vcov + (size_t)b.row * 9, 9, C);
      copy(C, 9, cov_out + at * 9);
    }
  }
}

__global__ void __launch_bounds__(kHashThreads) hash_lookup_kernel(
    const HashGrid g, const int* __restrict__ coords, int n, int* __restrict__ rows_out) {
  const int i = blockIdx.x * kHashThreads + threadIdx.x;
  if (i < n) rows_out[i] = lookup(g, coords + 3 * (size_t)i);
}

HashGrid make_grid(const int* table, const int* table_fp, int table_size, int max_probe,
                   int sentinel, const float* points, int m, const int* counts,
                   const float* pcov, const float* pmean, const float* vmean,
                   const float* vcov, float voxel) {
  return HashGrid{table, table_fp, table_size, max_probe, sentinel, points, m,
                  counts, pcov, pmean, vmean, vcov, voxel};
}

int blocks_for(int n) { return (n + kHashThreads - 1) / kHashThreads; }

template <int kMethod, bool kRadar>
void launch_search(const HashGrid& g, const float* src, const bool* valid, int n,
                   const float* pose, const float* max_dist, const float* radar,
                   float* partials, cudaStream_t stream) {
  hash_search_kernel<kMethod, kRadar><<<blocks_for(n), kHashThreads, 0, stream>>>(
      g, src, valid, n, pose, max_dist, radar, partials);
}

}  // namespace

// One GN iteration's search + reduction: ``sums`` [18] (P2P) or [44];
// ``partials`` [ceil(n / 128), 18 or 44] scratch; ``radar`` [n, 3, 3] or
// null (the radar form; ignored for P2P).
extern "C" int elm_hash_search_reduce(
    const int* table, const int* table_fp, int table_size, int max_probe, int sentinel,
    const float* points, int m, const int* counts, const float* pcov, const float* pmean,
    const float* vmean, const float* vcov, float voxel, const float* src, const bool* valid,
    int n, const float* pose, const float* max_dist, const float* radar, int method,
    float* partials, float* sums, cudaStream_t stream) {
  const HashGrid g = make_grid(table, table_fp, table_size, max_probe, sentinel, points, m,
                               counts, pcov, pmean, vmean, vcov, voxel);
  const bool r = radar != nullptr;
  if (n > 0) {
    switch (method) {
      case kP2P:
        launch_search<kP2P, false>(g, src, valid, n, pose, max_dist, nullptr, partials, stream);
        break;
      case kGICP:
        (r ? launch_search<kGICP, true> : launch_search<kGICP, false>)(
            g, src, valid, n, pose, max_dist, radar, partials, stream);
        break;
      case kVGICP:
        (r ? launch_search<kVGICP, true> : launch_search<kVGICP, false>)(
            g, src, valid, n, pose, max_dist, radar, partials, stream);
        break;
      case kAVGICP:
        (r ? launch_search<kAVGICP, true> : launch_search<kAVGICP, false>)(
            g, src, valid, n, pose, max_dist, radar, partials, stream);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  reduce_partials_kernel<<<1, kThreads, 0, stream>>>(
      partials, n > 0 ? blocks_for(n) : 0, method == kP2P ? kP2PSums : kGnSums, sums);
  return (int)cudaGetLastError();
}

// The four grid queries on ``n`` world queries (``method`` as above).
extern "C" int elm_hash_query(
    const int* table, const int* table_fp, int table_size, int max_probe, int sentinel,
    const float* points, int m, const int* counts, const float* pcov, const float* pmean,
    const float* vmean, const float* vcov, float voxel, const float* queries, int n,
    const float* max_dist, int method, int* rows_out, int* slots_out, bool* valid_out,
    float* tgt_out, float* mean_out, float* cov_out, cudaStream_t stream) {
  const HashGrid g = make_grid(table, table_fp, table_size, max_probe, sentinel, points, m,
                               counts, pcov, pmean, vmean, vcov, voxel);
  if (method < kP2P || method > kAVGICP) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const auto kernel = method == kP2P     ? hash_query_kernel<kP2P>
                      : method == kGICP  ? hash_query_kernel<kGICP>
                      : method == kVGICP ? hash_query_kernel<kVGICP>
                                         : hash_query_kernel<kAVGICP>;
  kernel<<<blocks_for(n), kHashThreads, 0, stream>>>(g, queries, n, max_dist, rows_out,
                                                     slots_out, valid_out, tgt_out, mean_out,
                                                     cov_out);
  return (int)cudaGetLastError();
}

// Voxel coords [n, 3] -> voxel rows [n] (misses: the sentinel).
extern "C" int elm_hash_lookup(const int* table, const int* table_fp, int table_size,
                               int max_probe, int sentinel, const int* coords, int n,
                               int* rows_out, cudaStream_t stream) {
  const HashGrid g = make_grid(table, table_fp, table_size, max_probe, sentinel, nullptr, 0,
                               nullptr, nullptr, nullptr, nullptr, nullptr, 1.0f);
  if (n > 0)
    hash_lookup_kernel<<<blocks_for(n), kHashThreads, 0, stream>>>(g, coords, n, rows_out);
  return (int)cudaGetLastError();
}
