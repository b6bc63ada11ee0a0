// Fold trees of the degree-class reduce, shared by the per-round fold
// kernels (csrc/classops.cu) and the K-round kernel (csrc/megakernel.cu).
//
// Both replay the TPU lane-roll fold (`acc + roll(acc, -sh)`, sh = 2, 4,
// ...) op for op, so the port stays bitwise equal to the JAX package.
// IEEE addition is commutative but not associative: any other grouping
// changes the last bits.
#pragma once

#include "common.cuh"

// Small class (2c <= 128 lanes, runs of c interleaved (s, w) pairs): the
// offset, inside its class region, of the first value that packed output
// `o` folds (output o is lane p = o % (128 / c) of row o / (128 / c); its
// run starts at lane (p >> 1) * 2c, and p & 1 picks s or w).
template <int C>
__device__ __forceinline__ long long small_run_base(long long o) {
  constexpr int OUT_LANES = GOSSIP_LANES / C;
  const int p = static_cast<int>(o % OUT_LANES);
  return (o / OUT_LANES) * GOSSIP_LANES + (p >> 1) * 2 * C + (p & 1);
}

// The roll tree over the C values of one stream of one run: `load(j)`
// gives the j-th value (2j lanes past the run base). Level by level,
// v[j] = v[j] + v[j + sh] for sh = 1, 2, ..., C/2: the lane-roll by 2*sh
// adds the block that starts sh values to the right. C = 1 is a copy.
template <int C, class Load>
__device__ __forceinline__ float fold_small(Load load) {
  float v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = load(j);
#pragma unroll
  for (int sh = 1; sh < C; sh *= 2) {
#pragma unroll
    for (int j = 0; j < C; j += 2 * sh) v[j] = v[j] + v[j + sh];
  }
  return v[0];
}

// Split class (2c > 128): the full 128-lane roll fold of one row by one
// warp. Lane t holds lanes 4t..4t+3 of the row; it adds a[4t] + a[4t+2]
// and a[4t+1] + a[4t+3] (the sh = 2 level), then __shfl_down_sync with
// offsets 1, 2, ..., 16 — at every level (left block) + (right block) in
// index order, which is the roll tree. Lane 0 returns the row's (s, w).
__device__ __forceinline__ float2 fold_row_warp(float4 a) {
  float s = a.x + a.z;
  float w = a.y + a.w;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    s = s + __shfl_down_sync(0xffffffffu, s, off);
    w = w + __shfl_down_sync(0xffffffffu, w, off);
  }
  return make_float2(s, w);
}
