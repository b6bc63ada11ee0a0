// Native graph-construction kernels for gossipprotocol_tpu.
//
// The reference has no native components (SURVEY.md §2: 100% managed F#),
// but this framework targets 10M+-node graphs where host-side topology
// assembly in numpy (np.unique over ~160M keys) dominates end-to-end
// startup. These kernels replace the two hot paths:
//
//   * csr_build  — canonical symmetric CSR from an edge list via counting
//     sort + per-row sort/dedup: O(E + Σ d log d) instead of a global
//     O(E log E) sort.
//   * ba_edges   — chunked Barabási–Albert preferential attachment,
//     draw-for-draw identical to the numpy implementation in
//     topology/builders.py (same splitmix64 stream, same chunk schedule),
//     so both backends produce bitwise-identical graphs.
//
// Exposed extern "C" for ctypes; no Python headers needed.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

static inline uint64_t splitmix64(uint64_t seed, uint64_t counter) {
  // Must match gossipprotocol_tpu/utils/prng.py exactly.
  uint64_t x = seed + (counter + 1) * 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

extern "C" {

// Canonical symmetric CSR with self-loop drop and per-row dedup.
// Inputs: e undirected edges (src[i], dst[i]).
// Outputs: offsets[n+1] (int64), indices (int32, caller-allocated with
// capacity 2*e). Returns nnz (directed entry count), or -1 on bad input.
int64_t csr_build(int64_t n, int64_t e, const int64_t* src,
                  const int64_t* dst, int64_t* offsets, int32_t* indices) {
  if (n <= 0 || e < 0) return -1;
  if (n > INT32_MAX) return -1;  // indices are int32; refuse, don't corrupt
  std::vector<int64_t> counts(static_cast<size_t>(n) + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    int64_t s = src[i], d = dst[i];
    if (s == d) continue;
    if (s < 0 || s >= n || d < 0 || d >= n) return -1;
    ++counts[s];
    ++counts[d];
  }
  // offsets = prefix sum (with possible duplicates still in place)
  offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) offsets[i + 1] = offsets[i] + counts[i];
  std::vector<int64_t> cursor(offsets, offsets + n);
  for (int64_t i = 0; i < e; ++i) {
    int64_t s = src[i], d = dst[i];
    if (s == d) continue;
    indices[cursor[s]++] = static_cast<int32_t>(d);
    indices[cursor[d]++] = static_cast<int32_t>(s);
  }
  // per-row sort + dedup, compacting forward in place
  int64_t write = 0;
  int64_t row_start = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t row_end = offsets[i + 1];
    std::sort(indices + row_start, indices + row_end);
    int64_t new_start = write;
    int32_t prev = -1;
    for (int64_t k = row_start; k < row_end; ++k) {
      if (indices[k] != prev) {
        prev = indices[k];
        indices[write++] = prev;
      }
    }
    offsets[i] = new_start;
    row_start = row_end;
  }
  offsets[n] = write;
  return write;
}

// Chunked Barabási–Albert graph; returns number of edges written, or -1.
// src/dst must have capacity (m+1)*m/2 + (n-m-1)*m.
int64_t ba_edges(int64_t n, int32_t m, uint64_t seed, int64_t* src,
                 int64_t* dst) {
  if (n < m + 1 || m <= 0) return -1;
  std::vector<int64_t> endpoints;
  endpoints.reserve(static_cast<size_t>(2 * n) * m);
  int64_t ne = 0;
  // seed clique, row-major upper triangle — matches np.triu_indices order;
  // endpoints appended as [all i] then [all j], matching the numpy concat
  for (int64_t i = 0; i <= m; ++i)
    for (int64_t j = i + 1; j <= m; ++j) {
      src[ne] = i;
      dst[ne] = j;
      ++ne;
    }
  for (int64_t k = 0; k < ne; ++k) endpoints.push_back(src[k]);
  for (int64_t k = 0; k < ne; ++k) endpoints.push_back(dst[k]);

  int64_t start = m + 1;
  int64_t chunk = std::max<int64_t>(1024, (n - start) / 64);
  if (chunk < 1) chunk = 1;
  uint64_t draw_counter = 0;
  std::vector<int64_t> chunk_src, chunk_dst;
  while (start < n) {
    int64_t stop = std::min(start + chunk, n);
    uint64_t ep_len = endpoints.size();
    chunk_src.clear();
    chunk_dst.clear();
    for (int64_t node = start; node < stop; ++node) {
      for (int32_t j = 0; j < m; ++j) {
        int64_t draw =
            endpoints[splitmix64(seed, draw_counter++) % ep_len];
        src[ne] = node;
        dst[ne] = draw;
        ++ne;
        chunk_src.push_back(node);
        chunk_dst.push_back(draw);
      }
    }
    endpoints.insert(endpoints.end(), chunk_src.begin(), chunk_src.end());
    endpoints.insert(endpoints.end(), chunk_dst.begin(), chunk_dst.end());
    start = stop;
  }
  return ne;
}

}  // extern "C"
