// Kernel C: first-point-per-voxel downsample with a static output budget.
//
// Replaces elimaloc_tpu/map/grid.py:voxel_downsample (:271) and _mix (:127),
// the latter as hash.cuh's mix with the table seed.
// The TPU form sorts a tuple of eight lanes through XLA's sort because
// payload gathers are scalar-core-bound there. On Hopper the whole function
// is one launch of one 16-CTA cluster (sort.cuh):
//   1. per point, the mixed 32-bit voxel key (0xFFFFFFFF for invalid rows,
//      valid keys clamped to 0xFFFFFFFE) and its index;
//   2. the stable 4-pass radix sort of sort.cuh — stability is part of the
//      semantics, "first" means first in input order;
//   3. a sorted element is kept when it is valid (its key is not
//      0xFFFFFFFF) and its voxel coords differ from its sorted
//      predecessor's (coords, not keys: a rare hash collision must not
//      swallow a voxel, grid.py:290-296);
//   4. the kept points are compacted by a cluster-wide scan: each CTA counts
//      the kept points of its stripe of the sorted order (4 consecutive
//      elements a thread), the counts meet in distributed shared memory, and
//      a block scan per chunk places them;
//   5. ``out`` is written in full (zeros past the kept count), ``out_valid``
//      and the kept count clamped to the budget.
// Bound: latency (sort.cuh); the bytes are ~1 MB at the headline 26,215
// points.
// Lanes: a fleet frame (replay_fused_fleet's vmap, elimaloc_tpu/parallel/
// sharding.py:256-281) launches one cluster a lane (sort.cuh cluster_lane),
// each on its lane's points, scratch and outputs at their lane strides; the
// clusters share nothing, so they may run in waves. One lane is the single
// launch.
#include "hash.cuh"
#include "sort.cuh"

namespace {

constexpr uint32_t kInvalidKey = 0xFFFFFFFFu;

__global__ void __launch_bounds__(elm::kSortThreads)
voxel_downsample_kernel(const float* __restrict__ points, const bool* __restrict__ valid,
                        int n, const float* __restrict__ voxel, int out_size,
                        uint32_t* k0, int* v0, uint32_t* k1, int* v1,
                        float* __restrict__ out, bool* __restrict__ out_valid,
                        long long* __restrict__ kept_out) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  elm::SortShared& sm = *reinterpret_cast<elm::SortShared*>(smem_raw);
  // this cluster's lane: its inputs, scratch (4 n ints a lane) and outputs
  const size_t l = elm::cluster_lane();
  points += 3 * n * l;
  valid += n * l;
  k0 += 4 * n * l;
  v0 += 4 * n * l;
  k1 += 4 * n * l;
  v1 += 4 * n * l;
  out += 3 * (size_t)out_size * l;
  out_valid += (size_t)out_size * l;
  kept_out += l;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const float v = voxel[0];
  int lo, hi;
  elm::sort_stripe(n, rank, &lo, &hi);

  // 1. keys of this CTA's stripe of the input
#pragma unroll 4
  for (int i = lo + tid; i < hi; i += elm::kSortThreads) {
    const int3 c = elm::voxel_of(points + 3 * i, v);
    const int cc[3] = {c.x, c.y, c.z};
    const uint32_t h = min(elm::mix(cc, elm::kHashSeed), 0xFFFFFFFEu);
    k0[i] = valid[i] ? h : kInvalidKey;
    v0[i] = i;
  }
  // 2. the sort
  uint32_t* ks;
  int* vs;
  elm::cluster_sort(k0, v0, k1, v1, n, 4, sm, &ks, &vs);

  // 3. keep flags of kSortItems consecutive sorted elements from i0 (one
  // thread's run of a chunk; the run's predecessor is read once), kept in
  // the sort's free scratch half for the compaction
  constexpr int kItems = elm::kSortItems;
  int* keep = reinterpret_cast<int*>(ks == k0 ? k1 : k0);
  int mine = 0;
  for (int b = lo; b < hi; b += elm::kSortChunk) {
    const int i0 = b + tid * kItems;
    if (i0 >= hi) continue;
    int3 prev = i0 > 0 ? elm::voxel_of(points + 3 * vs[i0 - 1], v) : make_int3(0, 0, 0);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = i0 + j;
      if (i < hi) {
        const int3 c = elm::voxel_of(points + 3 * vs[i], v);
        const bool first = i == 0 || c.x != prev.x || c.y != prev.y || c.z != prev.z;
        keep[i] = first && ks[i] != kInvalidKey ? 1 : 0;
        mine += keep[i];
        prev = c;
      }
    }
  }
  // 4. cluster-wide scan of the kept counts, then the compaction
  int all;
  elm::block_scan(mine, elm::AddOp(), sm.scan, &all);
  elm::cluster_exclusive(all, 0, sm);
  const int total = sm.total[0];
  int carry = sm.offset[0];
  for (int b = lo; b < hi; b += elm::kSortChunk) {
    const int i0 = b + tid * kItems;
    int flag[kItems];
    int count = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      flag[j] = i0 + j < hi ? keep[i0 + j] : 0;
      count += flag[j];
    }
    int chunk;
    int r = carry + elm::block_scan(count, elm::AddOp(), sm.scan, &chunk) - count;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (!flag[j]) continue;
      if (r < out_size) {
        const int p = vs[i0 + j];
        out[3 * r] = points[3 * p];
        out[3 * r + 1] = points[3 * p + 1];
        out[3 * r + 2] = points[3 * p + 2];
      }
      ++r;
    }
    carry += chunk;
  }
  // 5. the rest of the budget
  int olo, ohi;
  elm::sort_stripe(out_size, rank, &olo, &ohi);
  for (int j = olo + tid; j < ohi; j += elm::kSortThreads) {
    if (j >= total) {
      out[3 * j] = 0.0f;
      out[3 * j + 1] = 0.0f;
      out[3 * j + 2] = 0.0f;
    }
    out_valid[j] = j < total;
  }
  if (rank == 0 && tid == 0) kept_out[0] = total < out_size ? total : out_size;
  cluster.sync();  // no CTA leaves while another may still read its count
}

bool g_checked = false;

}  // namespace

// scratch: 4 * n int32 (the sort's two key and two index halves). ``lanes``
// scans of n points, one cluster each: points [lanes, n, 3], valid
// [lanes, n], scratch 4 n int32 a lane, out [lanes, out_size, 3],
// out_valid [lanes, out_size], kept [lanes].
extern "C" int elm_voxel_downsample(const float* points, const bool* valid, int n,
                                    const float* voxel, int out_size, int lanes, int* scratch,
                                    float* out, bool* out_valid, long long* kept,
                                    cudaStream_t stream) {
  uint32_t* k0 = reinterpret_cast<uint32_t*>(scratch);
  const size_t smem = sizeof(elm::SortShared);
  return elm::launch_cluster(voxel_downsample_kernel, smem, smem, &g_checked, stream, lanes,
                             points, valid, n, voxel, out_size, k0, scratch + n,
                             k0 + 2 * (size_t)n, scratch + 3 * (size_t)n, out, out_valid,
                             kept);
}
