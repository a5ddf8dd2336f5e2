// Kernel B: tile-slot assignment of the scan's queries.
//
// Replaces elimaloc_tpu/map/tiles.py:assign_slots (:577). The TPU form
// carries eight payload lanes through XLA's sort and scatters with one-hot
// friendly index math because gathers are scalar-core-bound there. On
// Hopper: (1) a per-query kernel computes the voxel coords and the tile id
// (edge clamp, in-reach test; out-of-reach and invalid rows get the sentinel
// tile) as an int64 sort key; (2) torch.sort(stable=True) orders the keys;
// (3) one CTA walks the sorted order in 1024-element chunks: segment starts
// by a block max-scan (cummax), the rank inside the tile, a new slot every
// QB queries, the slot number by a block sum-scan — both scans carry their
// offset across chunks — and scatters query, voxel coords, mask, original
// index and the slot's tile into the [S, QB] buffers, counting the queries
// that overflow the slot budget. Bound: launch latency and the serial chunk
// walk (~19k queries = 19 chunks); the bytes are well under 1 MB.
#include "common.cuh"

namespace {

__global__ void tile_keys_kernel(const float* __restrict__ q,
                                 const bool* __restrict__ valid, int n,
                                 float voxel, float tile_size, int tv, int tx0,
                                 int ty0, int tx_dim, int ty_dim,
                                 int* __restrict__ qv,
                                 long long* __restrict__ tile) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = q[3 * i], y = q[3 * i + 1], z = q[3 * i + 2];
  const int vx = (int)floorf(x / voxel);
  const int vy = (int)floorf(y / voxel);
  const int vz = (int)floorf(z / voxel);
  qv[3 * i] = vx;
  qv[3 * i + 1] = vy;
  qv[3 * i + 2] = vz;
  int tx = (int)floorf(x / tile_size) - tx0;
  int ty = (int)floorf(y / tile_size) - ty0;
  const bool in_reach = vx >= tx0 * tv - 1 && vx <= (tx0 + tx_dim) * tv &&
                        vy >= ty0 * tv - 1 && vy <= (ty0 + ty_dim) * tv;
  tx = tx < 0 ? 0 : (tx > tx_dim - 1 ? tx_dim - 1 : tx);
  ty = ty < 0 ? 0 : (ty > ty_dim - 1 ? ty_dim - 1 : ty);
  tile[i] = (valid[i] && in_reach) ? (long long)(tx * ty_dim + ty)
                                   : (long long)(tx_dim * ty_dim);
}

__global__ void assign_scatter_kernel(
    const float* __restrict__ q, const int* __restrict__ qv,
    const long long* __restrict__ perm, const long long* __restrict__ st, int n,
    int qb, int s, long long t_sent, float* __restrict__ qbuf,
    int* __restrict__ qvox, bool* __restrict__ qmask, int* __restrict__ qidx,
    int* __restrict__ slot_tile, long long* __restrict__ dropped) {
  __shared__ int sh[32];
  int seg_carry = 0;   // last segment start seen (cummax carry)
  int slot_carry = 0;  // slots opened so far (cumsum carry)
  int drop_carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool in = i < n;
    const bool first = in && (i == 0 || st[i] != st[i - 1]);
    int total;
    int seg = elm::block_scan(first ? i : 0, elm::MaxOp(), sh, &total);
    seg = seg > seg_carry ? seg : seg_carry;
    const int rank = i - seg;
    const int new_slot = (in && (first || rank % qb == 0)) ? 1 : 0;
    int opened;
    const int slot = slot_carry + elm::block_scan(new_slot, elm::AddOp(), sh, &opened) - 1;
    const bool real = in && st[i] != t_sent;
    const bool usable = real && slot < s;
    int n_drop;
    elm::block_scan((real && !usable) ? 1 : 0, elm::AddOp(), sh, &n_drop);
    if (usable) {
      const long long p = perm[i];
      const int flat = slot * qb + rank % qb;
      qbuf[3 * flat] = q[3 * p];
      qbuf[3 * flat + 1] = q[3 * p + 1];
      qbuf[3 * flat + 2] = q[3 * p + 2];
      qvox[3 * flat] = qv[3 * p];
      qvox[3 * flat + 1] = qv[3 * p + 1];
      qvox[3 * flat + 2] = qv[3 * p + 2];
      qmask[flat] = true;
      qidx[flat] = (int)p;
      if (new_slot) slot_tile[slot] = (int)st[i];
    }
    seg_carry = total > seg_carry ? total : seg_carry;
    slot_carry += opened;
    drop_carry += n_drop;
  }
  if (threadIdx.x == 0) dropped[0] = drop_carry;
}

}  // namespace

extern "C" int elm_tile_keys(const float* q, const bool* valid, int n, float voxel,
                             float tile_size, int tv, int tx0, int ty0,
                             int tx_dim, int ty_dim, int* qv, long long* tile,
                             cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    tile_keys_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        q, valid, n, voxel, tile_size, tv, tx0, ty0, tx_dim, ty_dim, qv, tile);
  }
  return (int)cudaGetLastError();
}

extern "C" int elm_assign_scatter(const float* q, const int* qv,
                                  const long long* perm, const long long* st,
                                  int n, int qb, int s, long long t_sent,
                                  float* qbuf, int* qvox, bool* qmask, int* qidx,
                                  int* slot_tile, long long* dropped,
                                  cudaStream_t stream) {
  assign_scatter_kernel<<<1, 1024, 0, stream>>>(q, qv, perm, st, n, qb, s, t_sent,
                                                qbuf, qvox, qmask, qidx,
                                                slot_tile, dropped);
  return (int)cudaGetLastError();
}
