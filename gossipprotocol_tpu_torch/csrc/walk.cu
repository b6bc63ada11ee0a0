// The reference walk's chunk of hops in one launch, for Hopper (sm_90a).
//
// No Pallas kernel computes the walk, so this kernel replaces none: it is
// the port's counterpart of the JAX package's on-device lax.while_loop
// over pushsum_walk_round (gossipprotocol_tpu/protocols/walk.py:122-177).
// Under --semantics reference push-sum is ONE token walking the graph, a
// hop a round; the plain version (protocols/walk.py walk_chunk_plain) runs
// each hop as ~30 small PyTorch operations issued from the host, which
// leaves the card idle between them.
//
// Hop r, bit for bit as the plain version computes it:
//   - key fold_in(base_key, r), split in two (either
//     jax_threefry_partitionable setting), the two 32-bit words of
//     jax.random.randint — threefry-2x32 in native uint32;
//   - the neighbour: randint_from_words(hi, lo, span) with span =
//     max(degree[cur], 1) on a table (dense row or CSR, the CSR slot clipped
//     to [0, E - 1] as JAX's gather clamps it), or n - 1 then +1 if >= cur on
//     the implicit complete graph;
//   - a converged receiver relays the message untouched; any other takes
//     the halves (s_t + msg_s) * 0.5, (w_t + msg_w) * 0.5, advances its
//     streak, converges at streak >= streak_target, and the halves travel
//     on; the ratio is s / max(w, 1e-30) as an IEEE division either way;
//   - the hop counter and the settled count advance while settled <
//     quorum, and the launch returns once the quorum is met; a holder with
//     no neighbour (a trapped token) counts the hop and changes nothing.
//
// Bound on this card: latency. The hops are serial — each depends on where
// the token stands — and a hop is two dependent L2 loads (the holder's
// table entry, then the receiver's state together with its degree and row
// start, which the next hop needs) plus the draw's uint32 divisions. The
// whole walk state at 1M nodes (~45 MB) stays in the 50 MB L2. Bytes and
// operations are negligible against that chain (chip_smoke.py phase (l)
// times a pointer chase through an L2-resident array for the floor).
// Design: one block; the words of a hop depend on r alone, so the block's
// warps 1-7 hash the next tile of 1,024 hops' words into shared memory
// while thread 0 walks the current tile (two buffers, one barrier a tile).
// No [hops, spans] draw table goes to device memory. No fast math and
// --fmad=false (ops/build.py): the two adds, the halving multiply and the
// division round as the plain version's do, subnormals kept.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int WALK_THREADS = 256;
constexpr int WALK_TILE = 1024;   // hops whose words one buffer holds

// neighbour layouts (ops/walk.py WalkLayout.layout)
constexpr int LAYOUT_FULL = 0;
constexpr int LAYOUT_DENSE = 1;
constexpr int LAYOUT_CSR = 2;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry-2x32, 20 rounds, of the counter (x0, x1) under (k0, k1)
// (protocols/sampling.py threefry2x32_words)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// randint_words(fold_in(base, r)): the draw's (higher, lower) words
__device__ __forceinline__ void hop_words(uint32_t b0, uint32_t b1,
                                          uint32_t r, bool partitionable,
                                          uint32_t& hi, uint32_t& lo) {
  uint32_t a0 = 0, a1 = r;            // fold_in: the counter (0, r)
  threefry2x32(b0, b1, a0, a1);
  uint32_t key0[2], key1[2];          // split(key)
  if (partitionable) {                // counters (0, 0) and (0, 1)
    uint32_t p0 = 0, p1 = 0, q0 = 0, q1 = 1;
    threefry2x32(a0, a1, p0, p1);
    threefry2x32(a0, a1, q0, q1);
    key0[0] = p0; key0[1] = p1;
    key1[0] = q0; key1[1] = q1;
  } else {                            // counters (0, 2) and (1, 3); the
    uint32_t p0 = 0, p1 = 2, q0 = 1, q1 = 3;   // first words make key 0
    threefry2x32(a0, a1, p0, p1);
    threefry2x32(a0, a1, q0, q1);
    key0[0] = p0; key0[1] = q0;
    key1[0] = p1; key1[1] = q1;
  }
  uint32_t h0 = 0, h1 = 0, l0 = 0, l1 = 0;      // each key's 32 bits
  threefry2x32(key0[0], key0[1], h0, h1);
  threefry2x32(key1[0], key1[1], l0, l1);
  hi = partitionable ? (h0 ^ h1) : h0;
  lo = partitionable ? (l0 ^ l1) : l0;
}

// randint_from_words for span >= 1, every product and sum wrapped to uint32
__device__ __forceinline__ uint32_t draw_in(uint32_t hi, uint32_t lo,
                                            uint32_t span) {
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  uint32_t off = (hi % span) * mult;
  off += lo % span;
  return off % span;
}

// s / max(w, 1e-30) as torch.clamp does it (a NaN weight stays NaN)
__device__ __forceinline__ float walk_ratio(float s, float w) {
  return s / (w < 1e-30f ? 1e-30f : w);
}

__device__ __forceinline__ void fill_words(uint32_t* hi, uint32_t* lo,
                                           long long first, long long hops,
                                           uint32_t r0, uint32_t b0,
                                           uint32_t b1, bool partitionable,
                                           int t0, int stride) {
  const long long count = hops - first < WALK_TILE ? hops - first
                                                   : WALK_TILE;
  for (int k = t0; k < count; k += stride) {
    hop_words(b0, b1, r0 + static_cast<uint32_t>(first + k), partitionable,
              hi[k], lo[k]);
  }
}

__global__ void __launch_bounds__(WALK_THREADS) walk_chunk_kernel(
    float* __restrict__ s, float* __restrict__ w, float* __restrict__ ratio,
    int* __restrict__ streak, unsigned char* __restrict__ conv,
    const int* __restrict__ degree, const long long* __restrict__ starts,
    const int* __restrict__ flat, int* round_io, int* cur_io,
    float* msg_s_io, float* msg_w_io, int* settled_io,
    const long long* __restrict__ key, long long n, long long flat_len,
    int row_width, int layout, long long hops, int quorum,
    int streak_target, int partitionable) {
  __shared__ uint32_t sh_hi[2][WALK_TILE];
  __shared__ uint32_t sh_lo[2][WALK_TILE];
  // stop flags by tile parity: thread 0 writes slot t & 1 in tile t, and
  // every thread reads it after the barrier, before tile t + 1
  __shared__ int sh_stop[2];
  const int tid = threadIdx.x;
  const uint32_t b0 = static_cast<uint32_t>(key[0]);
  const uint32_t b1 = static_cast<uint32_t>(key[1]);
  const int r_start = *round_io;
  const uint32_t r0 = static_cast<uint32_t>(r_start);
  const bool part = partitionable != 0;
  const long long tiles = (hops + WALK_TILE - 1) / WALK_TILE;

  // the walker's registers (thread 0)
  int cur = 0, rnd = r_start, settled = 0, deg_cur = 0;
  long long start_cur = 0;
  float msg_s = 0.f, msg_w = 0.f;
  if (tid == 0) {
    cur = *cur_io;
    settled = *settled_io;
    msg_s = *msg_s_io;
    msg_w = *msg_w_io;
    if (layout != LAYOUT_FULL) deg_cur = __ldg(degree + cur);
    if (layout == LAYOUT_CSR) start_cur = __ldg(starts + cur);
    sh_stop[1] = (settled >= quorum) || tiles == 0;
  }
  fill_words(sh_hi[0], sh_lo[0], 0, hops, r0, b0, b1, part, tid,
             WALK_THREADS);
  __syncthreads();

  for (long long t = 0; !sh_stop[(t + 1) & 1]; ++t) {
    const int buf = static_cast<int>(t & 1);
    if (tid == 0) {
      const long long first = t * WALK_TILE;
      const int count = static_cast<int>(
          hops - first < WALK_TILE ? hops - first : WALK_TILE);
      for (int k = 0; k < count && settled < quorum; ++k) {
        ++rnd;                               // an active hop is counted
        const uint32_t hi = sh_hi[buf][k], lo = sh_lo[buf][k];
        int tgt;
        if (layout == LAYOUT_FULL) {
          if (n < 2) continue;
          const uint32_t off = draw_in(hi, lo, static_cast<uint32_t>(n - 1));
          tgt = static_cast<int>(off + (off >= static_cast<uint32_t>(cur)));
        } else {
          if (deg_cur <= 0) continue;        // trapped: nothing else moves
          const uint32_t j = draw_in(hi, lo, static_cast<uint32_t>(deg_cur));
          long long p;
          if (layout == LAYOUT_DENSE) {
            p = static_cast<long long>(cur) * row_width + j;
          } else {
            p = start_cur + j;
            p = p < 0 ? 0 : (p > flat_len - 1 ? flat_len - 1 : p);
          }
          tgt = __ldg(flat + p);
        }
        // the receiver's state, and what the next hop needs of it
        const unsigned char c_t = conv[tgt];
        const float s_t = s[tgt];
        const float w_t = w[tgt];
        const int k_t = streak[tgt];
        int deg_next = 0;
        long long start_next = 0;
        if (layout != LAYOUT_FULL) deg_next = __ldg(degree + tgt);
        if (layout == LAYOUT_CSR) start_next = __ldg(starts + tgt);
        if (c_t) {                           // relay: the message moves on
          ratio[tgt] = walk_ratio(s_t, w_t);
        } else {
          const float hs = (s_t + msg_s) * 0.5f;
          const float hw = (w_t + msg_w) * 0.5f;
          s[tgt] = hs;
          w[tgt] = hw;
          ratio[tgt] = walk_ratio(hs, hw);
          const int count_t = k_t + 1;
          streak[tgt] = count_t;
          if (count_t >= streak_target) {
            conv[tgt] = 1;
            ++settled;
          }
          msg_s = hs;
          msg_w = hw;
        }
        cur = tgt;
        deg_cur = deg_next;
        start_cur = start_next;
      }
      sh_stop[buf] = (settled >= quorum) || (t + 1 >= tiles);
    } else if (tid >= 32 && t + 1 < tiles) {
      fill_words(sh_hi[buf ^ 1], sh_lo[buf ^ 1], (t + 1) * WALK_TILE, hops,
                 r0, b0, b1, part, tid - 32, WALK_THREADS - 32);
    }
    __syncthreads();
  }
  if (tid == 0) {
    *round_io = rnd;
    *cur_io = cur;
    *msg_s_io = msg_s;
    *msg_w_io = msg_w;
    *settled_io = settled;
  }
}

// A dependent-load chain through an L2-resident array: the latency floor
// of one walk hop's loads (chip_smoke.py phase (l)). One thread follows
// next[] for `steps` loads and writes where it ended (so none is elided).
__global__ void pointer_chase_kernel(const int* __restrict__ next,
                                     long long steps, int* __restrict__ out) {
  int i = 0;
  for (long long k = 0; k < steps; ++k) i = next[i];
  *out = i;
}

}  // namespace

GOSSIP_EXPORT const char* gossip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

GOSSIP_EXPORT int gossip_walk_chunk(
    float* s, float* w, float* ratio, int* streak, unsigned char* conv,
    const int* degree, const long long* starts, const int* flat,
    int* round_io, int* cur_io, float* msg_s, float* msg_w, int* settled,
    const long long* key, long long n, long long flat_len, int row_width,
    int layout, long long hops, int quorum, int streak_target,
    int partitionable, void* stream) {
  walk_chunk_kernel<<<1, WALK_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      s, w, ratio, streak, conv, degree, starts, flat, round_io, cur_io,
      msg_s, msg_w, settled, key, n, flat_len, row_width, layout, hops,
      quorum, streak_target, partitionable);
  return static_cast<int>(cudaGetLastError());
}

GOSSIP_EXPORT int gossip_pointer_chase(const int* next, long long steps,
                                       int* out, void* stream) {
  pointer_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      next, steps, out);
  return static_cast<int>(cudaGetLastError());
}
