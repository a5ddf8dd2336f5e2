// Kernel B: tile-slot assignment of the scan's queries.
//
// Replaces elimaloc_tpu/map/tiles.py:assign_slots (:577). The TPU form
// carries eight payload lanes through XLA's sort and scatters with one-hot
// friendly index math because gathers are scalar-core-bound there. On
// Hopper the whole function is one launch of one 16-CTA cluster (sort.cuh):
//   1. per query, the voxel coords and the tile id (edge clamp, in-reach
//      test; out-of-reach and invalid rows get the sentinel tile T, which
//      sorts last), and each CTA's count of queries per tile;
//   2. the stable radix sort of sort.cuh on the tile id (ceil(bits(T) / 8)
//      passes: 2 at the headline, T = 4096);
//   3. the slots by per-tile arithmetic in place of JAX's per-element
//      cummax and cumsum (tiles.py:613-621): count[t], start[t] its
//      exclusive scan, slots[t] = ceil(count[t] / qb), base[t] their
//      exclusive scan; sorted element i of tile t has rank i - start[t],
//      slot base[t] + rank / qb and position rank % qb, and is usable when
//      slot < S and t != T. Each CTA owns a stripe of the tiles: it sums
//      their counts over the CTAs' partial counts and scans them, and the
//      stripes' sums meet in distributed shared memory. The tables (partial
//      counts, start, base; T + 1 entries each) lie in shared memory when
//      T + 1 <= kSharedTiles, else in a global scratch of the wrapper's;
//      other CTAs read a tile's start and base from its owner;
//   4. the scatter: each usable query into its (slot, position), the first
//      of a slot writes the slot's tile, and every entry no query takes
//      gets its fill (0 / 0 / false / n / T), so the outputs need no fill
//      launch; the dropped queries are summed in CTA 0.
// Bound: latency (sort.cuh); the bytes are well under 1 MB.
// Lanes: a fleet frame (replay_fused_fleet's vmap, elimaloc_tpu/parallel/
// sharding.py:256-281) launches one cluster a lane (sort.cuh cluster_lane)
// on the shared tile geometry, each on its lane's queries, scratch, global
// tables and outputs (``dropped`` a lane) at their lane strides; the
// clusters share nothing, so they may run in waves. One lane is the single
// launch.
#include "sort.cuh"

namespace {

// per-tile tables in shared memory up to this many tiles (T + 1)
constexpr int kSharedTiles = 8192;

__global__ void __launch_bounds__(elm::kSortThreads)
assign_slots_kernel(const float* __restrict__ q, const bool* __restrict__ valid, int n,
                    float voxel, float tile_size, int tv, int tx0, int ty0, int tx_dim,
                    int ty_dim, int qb, int s, int passes, uint32_t* k0, int* v0,
                    uint32_t* k1, int* v1, int* gtab, float* __restrict__ qbuf,
                    int* __restrict__ qvox, bool* __restrict__ qmask,
                    int* __restrict__ qidx, int* __restrict__ slot_tile,
                    long long* __restrict__ dropped) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  elm::SortShared& sm = *reinterpret_cast<elm::SortShared*>(smem_raw);
  const int t_sent = tx_dim * ty_dim;
  const int nt = t_sent + 1;  // table entries: tiles 0..T
  {  // this cluster's lane: its queries, scratch, tables and outputs
    const size_t l = elm::cluster_lane(), f = (size_t)s * qb * l;
    q += 3 * (size_t)n * l;
    valid += (size_t)n * l;
    k0 += 4 * (size_t)n * l;
    v0 += 4 * (size_t)n * l;
    k1 += 4 * (size_t)n * l;
    v1 += 4 * (size_t)n * l;
    if (gtab != nullptr) gtab += (size_t)elm::kSortCtas * 3 * nt * l;
    qbuf += 3 * f;
    qvox += 3 * f;
    qmask += f;
    qidx += f;
    slot_tile += (size_t)s * l;
    dropped += l;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // this CTA's tables: its per-tile counts, then start and base
  int* part = gtab ? gtab + (size_t)rank * 3 * nt
                   : reinterpret_cast<int*>(smem_raw + sizeof(elm::SortShared));
  int* start = part + nt;
  int* base = start + nt;
  int lo, hi;
  elm::sort_stripe(n, rank, &lo, &hi);

  // 1. tile keys of this CTA's stripe of the input, and its tile counts
  for (int j = tid; j < nt; j += elm::kSortThreads) part[j] = 0;
  __syncthreads();
  for (int b = lo; b < hi; b += elm::kSortChunk) {
    int tile[elm::kSortItems];
#pragma unroll
    for (int j = 0; j < elm::kSortItems; ++j) {
      const int i = elm::chunk_index(b, j);
      tile[j] = -1;
      if (i < hi) {
        const int3 c = elm::voxel_of(q + 3 * i, voxel);
        int tx = (int)floorf(q[3 * i] / tile_size) - tx0;
        int ty = (int)floorf(q[3 * i + 1] / tile_size) - ty0;
        const bool in_reach = c.x >= tx0 * tv - 1 && c.x <= (tx0 + tx_dim) * tv &&
                              c.y >= ty0 * tv - 1 && c.y <= (ty0 + ty_dim) * tv;
        tx = tx < 0 ? 0 : (tx > tx_dim - 1 ? tx_dim - 1 : tx);
        ty = ty < 0 ? 0 : (ty > ty_dim - 1 ? ty_dim - 1 : ty);
        tile[j] = (valid[i] && in_reach) ? tx * ty_dim + ty : t_sent;
        k0[i] = (uint32_t)tile[j];
        v0[i] = i;
      }
    }
#pragma unroll
    for (int j = 0; j < elm::kSortItems; ++j) {
      const unsigned peers = __match_any_sync(0xffffffffu, tile[j]);
      if (tile[j] >= 0 && (peers & ((1u << lane) - 1u)) == 0)
        atomicAdd(&part[tile[j]], __popc(peers));
    }
  }
  // 2. the sort (its first cluster.sync publishes the counts too)
  uint32_t* ks;
  int* vs;
  elm::cluster_sort(k0, v0, k1, v1, n, passes, sm, &ks, &vs);

  // 3. count, start and base per tile. CTA r owns the stripe [tlo, thi) of
  // the T + 1 tiles: it sums the cluster's counts of its tiles and scans
  // them, the stripes' sums meet in distributed shared memory, and its
  // tables hold start and base of its tiles (``at`` finds a tile's owner)
  int tlo, thi;
  elm::sort_stripe(t_sent + 1, rank, &tlo, &thi);
  const int per_tile = (t_sent + elm::kSortCtas) / elm::kSortCtas;
  auto table_of = [&](int r) -> int* {
    return gtab ? gtab + (size_t)r * 3 * nt : cluster.map_shared_rank(part, r);
  };
  auto at = [&](int k, int t) -> int {  // start (k = 1) or base (k = 2) of tile t
    return t > t_sent ? n : table_of(t / per_tile)[k * nt + t];
  };
  int c_carry = 0, s_carry = 0;
  for (int b = tlo; b < thi; b += elm::kSortThreads) {
    const int t = b + tid;
    int c = 0;
    if (t < thi)
      for (int r = 0; r < elm::kSortCtas; ++r) c += table_of(r)[t];
    const int slots = t < t_sent ? (c + qb - 1) / qb : 0;
    int c_chunk, s_chunk;
    const int st = c_carry + elm::block_scan(c, elm::AddOp(), sm.scan, &c_chunk) - c;
    const int bt = s_carry + elm::block_scan(slots, elm::AddOp(), sm.scan, &s_chunk) - slots;
    if (t < thi) {
      start[t] = st;
      base[t] = bt;
    }
    c_carry += c_chunk;
    s_carry += s_chunk;
  }
  if (tid == 0) sm.drop = 0;
  elm::cluster_exclusive(c_carry, s_carry, sm);
  for (int t = tlo + tid; t < thi; t += elm::kSortThreads) {
    start[t] += sm.offset[0];
    base[t] += sm.offset[1];
  }
  cluster.sync();  // every CTA's tables are complete

  // 4a. each sorted query of this CTA's stripe into its slot
  int drop = 0;
#pragma unroll 4
  for (int i = lo + tid; i < hi; i += elm::kSortThreads) {
    const int t = (int)ks[i];
    if (t >= t_sent) continue;
    const int r = i - at(1, t);
    const int slot = at(2, t) + r / qb;
    if (slot >= s) {
      ++drop;
      continue;
    }
    const int pos = r % qb;
    const int f = slot * qb + pos;
    const int p = vs[i];
    const int3 c = elm::voxel_of(q + 3 * p, voxel);
    qbuf[3 * f] = q[3 * p];
    qbuf[3 * f + 1] = q[3 * p + 1];
    qbuf[3 * f + 2] = q[3 * p + 2];
    qvox[3 * f] = c.x;
    qvox[3 * f + 1] = c.y;
    qvox[3 * f + 2] = c.z;
    qmask[f] = true;
    qidx[f] = p;
    if (pos == 0) slot_tile[slot] = t;
  }
  auto fill = [&](int f) {
    qbuf[3 * f] = 0.0f;
    qbuf[3 * f + 1] = 0.0f;
    qbuf[3 * f + 2] = 0.0f;
    qvox[3 * f] = 0;
    qvox[3 * f + 1] = 0;
    qvox[3 * f + 2] = 0;
    qmask[f] = false;
    qidx[f] = n;
  };
  // 4b. the unused tail of the last slot of each tile this CTA owns
  const int tend = thi < t_sent ? thi : t_sent;
  for (int j = tid; j < (tend - tlo) * qb; j += elm::kSortThreads) {
    const int t = tlo + j / qb, pos = j % qb;
    const int c = at(1, t + 1) - start[t];
    if (c % qb == 0 || pos < c % qb) continue;
    const int slot = base[t] + (c - 1) / qb;
    if (slot < s) fill(slot * qb + pos);
  }
  // 4c. the slots no tile opened (this CTA's share)
  const int opened = at(2, t_sent);
  const int used = opened < s ? opened : s;
  int flo, fhi;
  elm::sort_stripe((s - used) * qb, rank, &flo, &fhi);
  for (int f = used * qb + flo + tid; f < used * qb + fhi; f += elm::kSortThreads) fill(f);
  elm::sort_stripe(s - used, rank, &flo, &fhi);
  for (int j = used + flo + tid; j < used + fhi; j += elm::kSortThreads) slot_tile[j] = t_sent;
  // the dropped queries, summed in CTA 0
  int all;
  elm::block_scan(drop, elm::AddOp(), sm.scan, &all);
  if (tid == 0 && all) atomicAdd(cluster.map_shared_rank(&sm.drop, 0), all);
  cluster.sync();  // no CTA leaves while another may still read its tables
  if (rank == 0 && tid == 0) dropped[0] = sm.drop;
}

bool g_checked = false;

}  // namespace

// scratch: 4 * n int32 (the sort's two key and two index halves); table:
// null when T + 1 <= kSharedTiles, else kSortCtas * 3 * (T + 1) int32.
// ``lanes`` scans of n queries, one cluster each: q [lanes, n, 3], valid
// [lanes, n], scratch and table a lane's size each at its lane stride,
// qbuf, qvox [lanes, s, qb, 3], qmask, qidx [lanes, s, qb], slot_tile
// [lanes, s], dropped [lanes].
extern "C" int elm_assign_slots(const float* q, const bool* valid, int n, float voxel,
                                float tile_size, int tv, int tx0, int ty0, int tx_dim,
                                int ty_dim, int qb, int s, int lanes, int* scratch, int* table,
                                float* qbuf, int* qvox, bool* qmask, int* qidx,
                                int* slot_tile, long long* dropped, cudaStream_t stream) {
  const int t_sent = tx_dim * ty_dim;
  const bool shared = t_sent + 1 <= kSharedTiles;
  if (!shared && table == nullptr) return (int)cudaErrorInvalidValue;
  int bits = 0;
  while (bits < 32 && ((unsigned)t_sent >> bits) != 0) ++bits;
  const int passes = bits < 8 ? 1 : (bits + 7) / 8;
  const size_t sort_smem = sizeof(elm::SortShared);
  const size_t max_smem = sort_smem + 3 * sizeof(int) * (size_t)kSharedTiles;
  const size_t smem = shared ? sort_smem + 3 * sizeof(int) * (size_t)(t_sent + 1) : sort_smem;
  uint32_t* k0 = reinterpret_cast<uint32_t*>(scratch);
  return elm::launch_cluster(assign_slots_kernel, smem, max_smem, &g_checked, stream, lanes,
                             q, valid, n, voxel, tile_size, tv, tx0, ty0, tx_dim, ty_dim, qb,
                             s, passes, k0, scratch + n, k0 + 2 * (size_t)n,
                             scratch + 3 * (size_t)n, shared ? nullptr : table, qbuf, qvox,
                             qmask, qidx, slot_tile, dropped);
}
