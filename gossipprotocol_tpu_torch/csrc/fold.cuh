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

// Left fold a[0] + a[1] + ... + a[m-1] in index order by one warp, shared
// by the split fold (csrc/classops.cu) and the K-round kernel's split
// classes and global mean (csrc/megakernel.cu): acc = a[0], then
// acc = acc + a[j] for j = 1, 2, ... — begun at a[0], never at +0 (+0 +
// -0 is +0, so a fold from +0 would turn an all -0 sum into +0).
//
// The adds are the only dependent chain — m adds per stream, one add's
// latency each, the floor of this fold — so the values must reach the
// adding lanes faster than that. The warp loads DEPTH chunks of 32 floats
// (16 pairs each) per group, one group ahead of the fold (the split fold
// takes DEPTH = 16: 256 dependent adds per group against one L2 round
// trip), and writes each group into its shared-memory stage split by
// stream: s values in the first half, w values in the second. Even lanes
// then fold the s stream and odd lanes the w stream, reading four values
// per 16-byte load (a broadcast: one address per half) several loads
// ahead, so the adds run back to back. The values were written by other
// blocks of the same launch, so they are read from L2 (__ldcg).
//
// `stage`: LEFT_FOLD_STAGE(DEPTH) floats of shared memory for this warp,
// 16-byte aligned. Call with the whole warp; returns the sum in every
// lane (m = 0 gives +0).
#define LEFT_FOLD_STAGE(DEPTH) (32 * (DEPTH) + 4)
constexpr int LEFT_FOLD_AHEAD = 4;  // stage loads in flight (DEPTH >= 1)

__device__ __forceinline__ float left_fold_load(const float* f, long long n,
                                                long long i) {
  return i < n ? __ldcg(f + i) : 0.f;
}

// Adds the first `len` of the HALF values at `mine` to acc in order (all
// HALF unless RAGGED), skipping value 0 when `first` (acc's start). In a
// whole group the loads run LEFT_FOLD_AHEAD loads (4 adds each) ahead of
// the adds, past the shared-memory latency.
template <int HALF, bool RAGGED>
__device__ __forceinline__ float left_fold_stage(const float4* mine, int len,
                                                 bool first, float acc) {
  if constexpr (RAGGED) {  // the last group, once per fold: no pipelining
    for (int i = 0; 4 * i < len; ++i) {
      const float4 v = mine[i];
      if (i != 0 || !first) acc = acc + v.x;
      if (4 * i + 1 < len) acc = acc + v.y;
      if (4 * i + 2 < len) acc = acc + v.z;
      if (4 * i + 3 < len) acc = acc + v.w;
    }
    return acc;
  } else {
    float4 ring[LEFT_FOLD_AHEAD];
#pragma unroll
    for (int i = 0; i < LEFT_FOLD_AHEAD; ++i) ring[i] = mine[i];
#pragma unroll
    for (int i = 0; i < HALF / 4; ++i) {
      const float4 v = ring[i % LEFT_FOLD_AHEAD];
      if (i + LEFT_FOLD_AHEAD < HALF / 4) {
        ring[i % LEFT_FOLD_AHEAD] = mine[i + LEFT_FOLD_AHEAD];
      }
      if (i != 0 || !first) acc = acc + v.x;
      acc = acc + v.y;
      acc = acc + v.z;
      acc = acc + v.w;
    }
    return acc;
  }
}

template <int DEPTH>
__device__ __forceinline__ float2 warp_left_fold(const float2* a, long long m,
                                                 int lane, float* stage) {
  constexpr int GROUP = 32 * DEPTH;  // floats per group
  constexpr int HALF = 16 * DEPTH;   // values per stream per group
  // the w half starts 4 floats past HALF, off the s half's banks
  constexpr int W_AT = HALF + 4;
  const float* f = reinterpret_cast<const float*>(a);
  const long long n = 2 * m;
  const int odd = lane & 1;
  const float4* mine =
      reinterpret_cast<const float4*>(stage + (odd ? W_AT : 0));
  float* put = stage + (odd ? W_AT : 0) + (lane >> 1);
  float cur[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    cur[d] = left_fold_load(f, n, 32 * d + lane);
  }
  float acc = 0.f;
  for (long long g = 0; g < n; g += GROUP) {
    float nxt[DEPTH];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      nxt[d] = left_fold_load(f, n, g + GROUP + 32 * d + lane);
    }
    __syncwarp();  // the previous group's reads are done
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) put[16 * d] = cur[d];
    __syncwarp();
    const int len = static_cast<int>(  // values per stream in this group
        min(m - g / 2, static_cast<long long>(HALF)));
    if (g == 0) acc = stage[odd ? W_AT : 0];  // s_0 / w_0
    if (len == HALF) {
      acc = left_fold_stage<HALF, false>(mine, len, g == 0, acc);
    } else {
      acc = left_fold_stage<HALF, true>(mine, len, g == 0, acc);
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) cur[d] = nxt[d];
  }
  return make_float2(__shfl_sync(0xffffffffu, acc, 0),
                     __shfl_sync(0xffffffffu, acc, 1));
}
