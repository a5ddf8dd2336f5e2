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
//
// The fused entry (hash_search_kernel) is the one-iteration reference the
// hash loop below is held to.
//
// The hash backend's registration loop on the card (hash_register_kernel):
// kernels Q and M as one cooperative launch per registration (K13 + K3 and
// the loop around them), for every method and radar form.
//
// Replaces elimaloc_tpu/register/icp.py:run_register's lax.while_loop
// (:588-821) on the hash backend: every iteration's grid search from the
// current pose + GN partials (icp.py:_iteration :429 with the grid queries
// map/grid.py:181, 209, 228, 251 and the tails :283, :324, :354, :381; the
// radar forms :331-333, 361-363, 459-467), the fixed-order reduction, the LM
// step and the termination test, with the same trip count and carry. The
// host loop it replaces on the card was three launches (kernel Q's search,
// reduce_partials_kernel, kernel M) and one stop-flag readback per
// iteration.
//
// Design: gn_loop.cuh's loop (a cooperative grid of min(S, co-resident
// CTAs) CTAs, slots from an alternating atomic counter, the columns reduced
// one a CTA in reduce_partials_kernel's order, M's step out of line on CTA
// 0, the stop flag after the last grid.sync()) around kernel Q's body
// (hash_correspond.cuh: hash_block, whose per-point body hash_point is one
// __noinline__ copy in this translation unit, called by Q's fused entry and
// the loop alike, so both round alike instruction for instruction). A slot
// is one block of kHashThreads = 128 points, so the partials are Q's
// [ceil(N / 128), 18 or 44] rows in block order; a CTA has Q's 128 threads
// and forms the reduction's 256 lanes two a thread. Each method and radar
// form is its own instantiation (Q's templates), its grid sized with
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; the shared memory is Q's
// 128 x 18 or 44 rows (9 or 22.5 KB static), which the reduction reuses.
// GICP exports local_cov (M's gicp flag). The result equals the
// three-launch chain's bit for bit.
// Lanes: one launch serves a fleet frame's B registrations
// (replay_fused_fleet's vmap of run_register, elimaloc_tpu/parallel/
// sharding.py:256-281) through gn_loop_lanes (gn_loop.cuh), as the tile
// loops' lane forms do: a slot is a (lane, 128-point block) pair, B x
// ceil(N / 128) of them handed out over the lanes still iterating; each
// lane's scan, mask, total and radar rows at its lane stride, its carry,
// flags and iteration count field-major; each lane's LM step on one CTA.
// Every method and radar form has a lane instantiation of its own (eight),
// around the same __noinline__ hash_point, so each lane equals its
// single-lane launch bit for bit. A fleet frame of more than kMaxLanes
// lanes is launched in parts by the wrapper.
// Bound: as kernel Q's per iteration (bytes: the probe windows, the
// neighbour voxels' points or means, the match payloads), times the
// iterations; grid.sync and the serial LM step are latency.
#include "gn_loop.cuh"
#include "hash_correspond.cuh"

namespace {

template <int kMethod, bool kRadar>
__global__ void __launch_bounds__(kHashThreads) hash_search_kernel(
    const HashGrid g, const float* __restrict__ src, const bool* __restrict__ valid, int n,
    const float* __restrict__ pose, const float* __restrict__ max_dist,
    const float* __restrict__ radar, float* __restrict__ partials) {
  constexpr int kParts = kMethod == kP2P ? kP2PSums : kGnSums;
  __shared__ float part[kHashThreads * kParts];
  hash_block<kMethod, kRadar>(blockIdx.x, g, src, valid, n, pose, max_dist, radar, part,
                              partials);
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


// One block of kernel Q at the staged pose: gn_loop_lanes' ``slots(lane,
// block, pose)``, lane ``lane``'s scan, mask, radar rows and partial rows at
// its lane stride (src [B, n, 3], valid [B, n], radar [B, n, 3, 3],
// partials [B, rows, 18 or 44]); gn_loop's ``slots(block, pose)`` (one
// registration) is lane 0.
template <int kMethod, bool kRadar>
struct HashSlots {
  HashGrid g;
  const float* src;
  const bool* valid;
  int n, rows;
  const float* max_dist;
  const float* radar;
  float* partials;
  float* part;
  __device__ __forceinline__ void operator()(int lane, int block, const float* pose) const {
    constexpr int kParts = kMethod == kP2P ? kP2PSums : kGnSums;
    const size_t at = (size_t)lane * n;
    hash_block<kMethod, kRadar>(block, g, src + 3 * at, valid + at, n, pose, max_dist,
                                kRadar ? radar + 9 * at : radar, part,
                                partials + (size_t)lane * rows * kParts);
  }
  __device__ __forceinline__ void operator()(int block, const float* pose) const {
    (*this)(0, block, pose);
  }
};

// The hash loop of ``kMethod`` (its radar form with kRadar), one
// registration on gn_loop or, with kLanes, a fleet frame's on
// gn_loop_lanes: each its own instantiation around the one __noinline__
// hash_point, so a one-lane launch keeps the single loop's registers and
// every lane rounds as the single loop does.
template <int kMethod, bool kRadar, bool kLanes>
__global__ void __launch_bounds__(kHashThreads) hash_register_kernel(
    const HashGrid g, const float* __restrict__ src, const bool* __restrict__ valid, int n,
    const float* __restrict__ max_dist, const float* __restrict__ radar, const GnLoop loop) {
  constexpr int kParts = kMethod == kP2P ? kP2PSums : kGnSums;
  __shared__ float part[kHashThreads * kParts];
  const HashSlots<kMethod, kRadar> slots{g,      src,      valid,         n,   loop.rows,
                                         max_dist, radar, loop.partials, part};
  const int blocks = (n + kHashThreads - 1) / kHashThreads;
  if constexpr (kLanes)
    gn_loop_lanes(loop, blocks, slots, part);
  else
    gn_loop(loop, blocks, slots, part);
}

template <bool kLanes>
const void* loop_kernel_of(int method, bool radar) {
  switch (method) {
    case kP2P:
      return (const void*)hash_register_kernel<kP2P, false, kLanes>;
    case kGICP:
      return radar ? (const void*)hash_register_kernel<kGICP, true, kLanes>
                   : (const void*)hash_register_kernel<kGICP, false, kLanes>;
    case kVGICP:
      return radar ? (const void*)hash_register_kernel<kVGICP, true, kLanes>
                   : (const void*)hash_register_kernel<kVGICP, false, kLanes>;
    case kAVGICP:
      return radar ? (const void*)hash_register_kernel<kAVGICP, true, kLanes>
                   : (const void*)hash_register_kernel<kAVGICP, false, kLanes>;
    default:
      return nullptr;
  }
}

// The instantiation of ``method`` (its radar form with ``radar``; P2P has
// none; the lane form with ``lanes`` > 1), or null.
const void* loop_kernel(int method, bool radar, int lanes) {
  return lanes > 1 ? loop_kernel_of<true>(method, radar) : loop_kernel_of<false>(method, radar);
}

// The co-residency cache key of an instantiation (< 16).
int loop_key(int method, bool radar, int lanes) {
  return 8 * (int)(lanes > 1) + 2 * method + (int)radar;
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

// The co-resident CTAs of the loop kernel of ``method`` (its radar form
// with ``radar`` != 0, its lane form with ``lanes`` > 1) on the current
// device.
extern "C" int elm_hash_register_capacity(int method, int radar, int lanes, int* ctas) {
  const bool r = radar != 0 && method != kP2P;
  const void* kernel = loop_kernel(method, r, lanes);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return co_resident(kernel, kHashThreads, 0, 0, loop_key(method, r, lanes), ctas);
}

// ``lanes`` registrations (1 <= lanes <= kMaxLanes), each lane's inputs and
// outputs at its lane stride: src [lanes, n, 3], valid [lanes, n], pose
// [lanes, 4, 4], fitness [lanes], local_cov [lanes, 6, 6], total [lanes],
// ``radar`` [lanes, n, 3, 3] or null (the radar form; ignored for P2P).
// carry: pose [lanes, 4, 4], local_cov [lanes, 6, 6], fitness [lanes],
// overlap [lanes]; flags: stop [lanes], failed [lanes]; iterations: int32
// [lanes]. Scratch: partials [lanes, max(ceil(n / 128), 1), 18 (P2P) or
// 44], sums [lanes, 18 or 44], counters [2]. One lane is the single loop.
extern "C" int elm_hash_register(
    const int* table, const int* table_fp, int table_size, int max_probe, int sentinel,
    const float* points, int m, const int* counts, const float* pcov, const float* pmean,
    const float* vmean, const float* vcov, float voxel, const float* src, const bool* valid,
    int n, const float* pose, const float* fitness, const float* local_cov,
    const float* total, const float* max_dist, const float* min_overlap_ratio,
    const float* lm_lambda, const float* termination_threshold, int max_iteration,
    const float* radar, int method, int lanes, float* partials, float* sums, int* counters,
    float* carry, bool* flags, int* iterations, cudaStream_t stream) {
  if (lanes < 1 || lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  const bool r = radar != nullptr && method != kP2P;
  const void* kernel = loop_kernel(method, r, lanes);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const HashGrid g{table, table_fp, table_size, max_probe, sentinel, points, m,
                   counts, pcov, pmean, vmean, vcov, voxel};
  const float* rad = r ? radar : nullptr;
  const int blocks = (n + kHashThreads - 1) / kHashThreads;
  const GnLoop loop{pose, fitness, local_cov, total, min_overlap_ratio, lm_lambda,
                    termination_threshold, max_iteration, method == kP2P ? kP2PSums : kGnSums,
                    method == kGICP ? 1 : 0, partials, sums, counters, carry, flags,
                    iterations, lanes, blocks > 1 ? blocks : 1};
  void* args[] = {(void*)&g, &src, &valid, &n, &max_dist, &rad, (void*)&loop};
  return launch_loop(kernel, blocks * lanes, kHashThreads, 0, 0, loop_key(method, r, lanes),
                     args, stream);
}
