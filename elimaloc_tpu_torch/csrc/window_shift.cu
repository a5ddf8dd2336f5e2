// Kernel N: the incremental shift of a resident map window (K14).
//
// Replaces elimaloc_tpu/map/tiles.py:_shift_window_impl (:511) as
// shift_window (:546) drives it from the runtime's window management: a
// window of T + 1 halo rows (T = nx * ny tiles, row T the sentinel) in up to
// six tensors moves by (dx, dy) tiles. New row i * ny + j copies old row
// (i + dx) * ny + (j + dy) where that lies inside the window and the sentinel
// row otherwise; then payload row k (the entering rows that
// HostTileMap.crop_entering_rows cut from the host map) overwrites row
// dst_rows[k] where dst_rows[k] <= T (pad entries point past the sentinel
// and are dropped). On the TPU this is one row gather (``a[src]``) and one
// row scatter (``.at[dst].set(mode="drop")``) per tensor.
//
// Bound: bytes. Every output row is one copied source row (~52 KB a row on
// the headline window, ~32 MB a window), nothing is computed. Design: one
// launch moves all six tensors through a pointer table, as kernel J does.
// The grid is (destination row, tensor): each CTA picks its source (an old
// row, the sentinel or a payload row) and copies it in 4-byte words, since
// rows are not 16-byte multiples (8,532 B for points at 711 per row). The
// payload index of a row comes from the CTA's own scan of dst_rows (at most
// 3 (nx + ny) entries), so no inverse table is built or uploaded. The kernel
// writes new tensors: the old window may still serve frames queued on
// another stream.
#include <cuda_runtime.h>

namespace {

constexpr int kShiftThreads = 256;
constexpr int kMaxTensors = 6;

// Per tensor: the old window [T+1, row], the new one, the payload
// [r_pad, row], and the row length in 4-byte words.
struct ShiftTable {
  const unsigned* base[kMaxTensors];
  unsigned* out[kMaxTensors];
  const unsigned* payload[kMaxTensors];
  long long row_words[kMaxTensors];
};

__global__ void __launch_bounds__(kShiftThreads)
    shift_window_kernel(ShiftTable tab, int nx, int ny, int dx, int dy,
                        const int* __restrict__ dst_rows, int r_pad) {
  __shared__ int s_k;
  const int row = blockIdx.x;  // destination row, 0..T
  const int f = blockIdx.y;    // tensor
  const int t = nx * ny;
  if (threadIdx.x == 0) s_k = -1;
  __syncthreads();
  for (int k = threadIdx.x; k < r_pad; k += blockDim.x)
    if (dst_rows[k] == row) atomicMax(&s_k, k);  // entering rows are distinct
  __syncthreads();
  const int k = s_k;
  const long long w = tab.row_words[f];
  const unsigned* src;
  if (k >= 0) {
    src = tab.payload[f] + (long long)k * w;
  } else {
    int s = t;  // the sentinel row: vacated rows and the sentinel itself
    if (row < t) {
      const int i = row / ny + dx, j = row % ny + dy;
      if (i >= 0 && i < nx && j >= 0 && j < ny) s = i * ny + j;
    }
    src = tab.base[f] + (long long)s * w;
  }
  unsigned* dst = tab.out[f] + (long long)row * w;
  for (long long c = threadIdx.x; c < w; c += blockDim.x) dst[c] = src[c];
}

}  // namespace

// base, out, payload: n_tensors device pointers each; row_words: n_tensors
// host ints; dst_rows: r_pad device int32.
extern "C" int elm_shift_window(void* const* base, void* const* out, void* const* payload,
                                const int* row_words, int n_tensors, int nx, int ny, int dx,
                                int dy, const int* dst_rows, int r_pad, cudaStream_t stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors) return (int)cudaErrorInvalidValue;
  ShiftTable tab;
  for (int f = 0; f < n_tensors; ++f) {
    tab.base[f] = (const unsigned*)base[f];
    tab.out[f] = (unsigned*)out[f];
    tab.payload[f] = (const unsigned*)payload[f];
    tab.row_words[f] = row_words[f];
  }
  const dim3 grid(nx * ny + 1, n_tensors);
  shift_window_kernel<<<grid, kShiftThreads, 0, stream>>>(tab, nx, ny, dx, dy, dst_rows, r_pad);
  return (int)cudaGetLastError();
}
