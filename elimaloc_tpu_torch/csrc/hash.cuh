// The hash grid's voxel lookup (K13, elimaloc_tpu/map/grid.py:127-178) as
// device functions, for kernel Q (hash_correspond.cu).
//
// Exact uint32 arithmetic: the chained mix + fmix32 of the builder
// (map/builder.py:_mix_coords), the table slot h = mix & (T - 1), the
// fingerprint (a second seed; 0 becomes 1, since 0 marks an empty slot).
// The table and its fingerprints are extended by max_probe entries, so the
// probe window h .. h + max_probe - 1 never wraps.
#pragma once

#include <stdint.h>

namespace elm {

constexpr uint32_t kHashSeed = 0x9E3779B1u;
constexpr uint32_t kFingerprintSeed = 0x51ED270Bu;

// The voxel offsets of the two neighbourhoods, in map/grid.py's order:
// OFFSETS_27 (i, j, k each over -1, 0, 1, k fastest) and OFFSETS_7 (centre,
// then +x, -x, +y, -y, +z, -z).
__device__ __forceinline__ void offset27(int o, int* d) {
  d[0] = o / 9 - 1;
  d[1] = (o / 3) % 3 - 1;
  d[2] = o % 3 - 1;
}

__device__ __forceinline__ void offset7(int o, int* d) {
  d[0] = d[1] = d[2] = 0;
  if (o > 0) d[(o - 1) / 2] = (o & 1) ? 1 : -1;
}

__device__ __forceinline__ uint32_t mix(const int* c, uint32_t seed) {
  uint32_t h = seed ^ ((uint32_t)c[0] * 0x85EBCA6Bu);
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  h = h ^ ((uint32_t)c[1] * 0x27D4EB2Fu);
  h = (h ^ (h >> 13)) * 0x165667B1u;
  h = h ^ ((uint32_t)c[2] * 0x9E3779B1u);
  h = h ^ (h >> 16);
  h = h * 0x7FEB352Du;
  h = h ^ (h >> 15);
  h = h * 0x846CA68Bu;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t hash_slot(const int* c, int table_size) {
  return mix(c, kHashSeed) & (uint32_t)(table_size - 1);
}

__device__ __forceinline__ uint32_t fingerprint(const int* c) {
  const uint32_t fp = mix(c, kFingerprintSeed);
  return fp == 0u ? 1u : fp;
}

// The device map of kernel Q (map/grid.py:MapGrid), passed by value.
struct HashGrid {
  const int* table;     // [T + P] voxel row or -1
  const int* table_fp;  // [T + P] the uint32 fingerprints' bits
  int table_size, max_probe, sentinel;
  const float* points;  // [V + 1, m, 3], +inf past each voxel's count
  int m;
  const int* counts;    // [V + 1], 0 for the sentinel
  const float* pcov;    // [V + 1, m, 3, 3] or null
  const float* pmean;   // [V + 1, m, 3] or null
  const float* vmean;   // [V + 1, 3]
  const float* vcov;    // [V + 1, 3, 3]
  float voxel;
};

// Voxel coords -> voxel row, a miss the sentinel: the first slot of the
// probe window whose fingerprint matches, unless an empty slot (row < 0)
// comes first (std::unordered_map find; the cumsum / argmax resolve of
// grid.py:172-178).
__device__ __forceinline__ int lookup(const HashGrid& g, const int* c) {
  const uint32_t h = hash_slot(c, g.table_size);
  const uint32_t fp = fingerprint(c);
  for (int k = 0; k < g.max_probe; ++k) {
    const int row = g.table[h + k];
    if (row < 0) return g.sentinel;
    if ((uint32_t)g.table_fp[h + k] == fp) return row;
  }
  return g.sentinel;
}

}  // namespace elm
