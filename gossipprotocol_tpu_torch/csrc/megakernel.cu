// The K-round megakernel of diffusion push-sum, for Hopper (sm_90a).
//
// Replaces gossipprotocol_tpu/ops/megakernel.py:279 (make_megakernel_round's
// pallas_call): K whole protocol rounds per launch —
//
//   share = (s, w) / (deg + 1)  ->  gather-pre  ->  class folds
//   ->  gather-out  ->  s' = s - share*deg + in  ->  predicate, streak
//
// with the supervisor predicate tested before every round; once it holds
// the kernel stops, so the state is bitwise the per-round trajectory and
// `executed` counts only the rounds run (the kernel adds it to `round`).
//
// The TPU kept the whole round in one core's VMEM. Here the round spans
// every SM: ONE persistent cooperative launch of one 1,024-thread block
// per SM, its phases separated by a grid-wide barrier.
//
// What bounds it on this card. By the book, bytes: the pair table and the
// state, ~0.02 ms a round at imp3D 512,000. In fact every gathered value
// is one random load from L2, and the fold of a round is bound by those
// (chip_smoke.py phase (e) prints the phase split; PERF.md row 9). So
// the design cuts gathered lanes and the bytes around them:
//   - the gather sources are kept (s, w)-interleaved, one float2 per node
//     (`xp2`, `yp2`), so one 8-byte load serves both streams of a pair.
//     The plans' pair structure makes that exact: gather-pre pair k reads
//     (u, n + u) or the zero slot twice, gather-out node i reads
//     (2r, 2r + 1) or the zero slot twice (ops/megakernel.py checks both
//     tables once and derives the compact `pre_node` [pairs] and
//     `out_rank` [n] tables the kernel reads; the values gathered are
//     the very floats the plans gather, so the result is bitwise theirs);
//   - the fold reads `pre_node` (half the plan's bytes) with 16-byte
//     loads asking L2 to keep it between rounds, four pairs a lane, a warp
//     128 pairs (a unit) per load, the next unit's loads in flight, and
//     folds each run across the lanes that hold it with shuffles (the roll
//     tree, csrc/fold.cuh order);
//   - the state of each thread's nodes stays in shared memory for the
//     launch (read in the prologue, written back at the end), so a round
//     moves only the gather sources through L2. Where it does not fit
//     (MK_NODE_FIELDS * 4 bytes a node slot: above about 811,000 nodes on
//     132 SMs, which only a raised resident bound admits; the capacity
//     planner asks gossip_megakernel_state_in_smem) the launcher
//     takes the SMEM_STATE = false instantiation, which reads and writes
//     the state in device memory in place, in the same order;
//   - work: the small classes' units go out in chunks of one unit per
//     warp, the first half of the chunks round robin over the blocks (a
//     chunk's warps fold neighbouring runs, whose sources share lines),
//     the second half to whichever block asks next (one atomic a chunk),
//     which evens out blocks that run slower;
//   - the gathers are plain (L1-cached) loads of data written inside the
//     launch: the grid barrier's gpu-scope release/acquire orders them and
//     the acquire invalidates the SM's L1 (CCTL.IVALL), as a
//     cooperative-groups grid sync does. (`__ldg`/`.nc` is never used for
//     such data.)
//
// Per round: (1) the fold: hub (split) rows first, spread over every warp
// of the grid, each warp folding two rows and adding them to the slot's
// arrival counter (acq_rel); the warp that completes a slot left-folds its
// q partials at once (warp_left_fold, ascending j) while the other warps
// go on to the small classes; barrier; (2) the done test on the previous
// round's per-block converged counts (double-buffered by round parity, so
// a block's new count never overwrites one another block is reading);
// (3) gather-out and the update, which also writes the next round's
// shares into `xp2` (so no separate share pass: a prologue writes the
// first round's); under the global predicate, the per-block sums, a
// barrier, the mean and the second node pass; barrier. Two grid barriers
// a round under either predicate, split classes or not. A frozen exit has
// written scratch only.
//
// Bitwise rules: s' = fadd(fma(-share, deg, s), in) — the single rounding
// of s - share*deg that XLA on the CPU computes (the port's plain version
// replays it exactly in float64, protocols/diffusion.py _keep); IEEE
// division (__fdiv_rn) for 1/(deg+1), s'/max(w', 1e-30) and the mean; no
// float atomics. The block partials of the global mean are folded in block
// order by every block, so the mean is deterministic — not torch.sum's
// order, but only `near` reads it (ops/megakernel.py kernel_order_mean
// replays it); s, w and ratio never depend on it. Built with --fmad=false
// and without fast math: no contraction beyond the explicit fma,
// denormals kept.
//
// A second instantiation (PROBE) records clock64 stamps per block at every
// phase boundary and barrier, for the phase split that chip_smoke.py and
// utils/profiling.py print; the CLI launches the plain one.
#include <type_traits>

#include "fold.cuh"

namespace {

constexpr int MK_THREADS = 1024;
constexpr int MK_WARPS = MK_THREADS / 32;
// one block per SM (at most 64 registers a thread) fixes the cooperative
// grid at the SM count, and with it the block order in which the global
// mean's partial sums are folded
constexpr int MK_MIN_BLOCKS = 1;
// chunks of 16 pairs the split classes' left fold loads ahead
// (csrc/fold.cuh), within the register bound above
constexpr int MK_FOLD_DEPTH = 8;
constexpr unsigned FULL = 0xffffffffu;
// class-table rows staged in shared memory (power_law 500,000 has 17)
constexpr int MK_MAX_CLASSES = 32;
// node state held in shared memory: s, w, ratio, deg, streak, conv, rank
constexpr int MK_NODE_FIELDS = 7;

// columns of the class table (int32 [ncls, K_COLS], built by
// ops/megakernel.py): pair offset, slot capacity, q (0: small class),
// packed-output prefix, split-partial prefix, arrival-counter prefix, the
// prefix of the class's work units among its kind and their count
enum {
  K_C = 0, K_NC, K_START, K_CAP, K_Q, K_OUT_AT, K_PART_AT, K_ARR_AT,
  K_UNIT_AT, K_UNITS, K_COLS
};

// probe stamps per block: globaltimer and clock64 at entry and exit, the
// prologue's end and barrier, then PROBE_EVENTS per round
constexpr int PROBE_HEAD = 6;
constexpr int PROBE_EVENTS = 6;

struct MkParams {
  float* s;              // [rp * 128] state, updated at the launch's end
  float* w;
  float* ratio;
  int* streak;
  int* conv;
  int* round;            // scalar: += the rounds this launch ran
  const float* deg;      // [n] f32 degree
  const int* pre_node;   // [pairs] source node of each fold pair (n: zero)
  const int* out_rank;   // [n] packed fold output of each node (nu: zero)
  float2* xp2;           // [n + 1] (share_s, share_w); [n] = 0
  float2* yp2;           // [nu + 1] packed (in_s, in_w); [nu] = 0
  float2* part;          // split-class row partials, [r * q + j] per class
  unsigned* arrived;     // split-class arrival counters, 0 between rounds
  float2* red;           // [grid] per-block (sum s, sum w)
  int* cnt;              // [2 * grid] per-block converged counts, by parity
  unsigned* bar;         // barrier word
  unsigned long long* work;  // [2] chunk counters, by round parity
  unsigned long long* stamps;  // PROBE only
  const int* classes;
  int ncls;
  long long split_units; // work units of the split classes (2 rows each)
  long long small_units; // work units of the small classes (128 pairs)
  long long n;
  long long nu;
  int nodes_per_thread;  // ceil(n / (grid * MK_THREADS))
  int k;
  float eps;
  float tol;
  int streak_target;
  int global_pred;
  long long quorum;      // < 0: every row converged
};

// A barrier wait takes microseconds; one this long (~10-20 s at the
// card's clocks) means a block never arrived, and the kernel traps with
// an error instead of hanging the card.
constexpr long long BARRIER_TIMEOUT_CYCLES = 1LL << 35;

__device__ __forceinline__ unsigned atom_add_release_gpu(unsigned* p,
                                                         unsigned v) {
  unsigned old;
  asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned atom_add_acq_rel_gpu(unsigned* p,
                                                         unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned ld_relaxed_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Grid-wide barrier on one word, without a reset: thread 0 of every block
// adds 1, block 0 adds 2^31 - (grid - 1), so the word's top bit flips
// exactly when the last block arrives; the others spin until it differs
// from the value they saw. A block that runs ahead into the next barrier
// adds below the top bit, so it cannot flip it back under a waiting one.
// The arrival releases the block's writes (the block barrier before it
// orders them), the fence after the spin acquires everyone's, and the
// block barrier after passes that on to the block's threads.
template <bool PROBE>
__device__ __forceinline__ void grid_sync(unsigned* bar,
                                          unsigned long long* st) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (PROBE) st[0] = clock64();
    const unsigned inc =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    const unsigned old = atom_add_release_gpu(bar, inc);
    const long long t0 = clock64();
    while (((ld_relaxed_gpu(bar) ^ old) & 0x80000000u) == 0) {
      if (clock64() - t0 > BARRIER_TIMEOUT_CYCLES) __trap();
    }
    fence_acq_rel_gpu();
    if (PROBE) st[1] = clock64();
  }
  __syncthreads();
}

// Sum of one int per thread over the block (exact: any order).
__device__ __forceinline__ int block_count(int v, int* s_warp) {
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < MK_WARPS; ++i) t += s_warp[i];
  }
  __syncthreads();
  return t;  // meaningful in thread 0
}

// One (s, w) pair per thread summed over the block in a fixed order:
// shuffle tree within each warp, then the warps in order (thread 0).
__device__ __forceinline__ float2 block_sum2(float2 v, float2* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x = v.x + __shfl_down_sync(FULL, v.x, off);
    v.y = v.y + __shfl_down_sync(FULL, v.y, off);
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 t = s_warp[0];
  if (threadIdx.x == 0) {
    for (int i = 1; i < MK_WARPS; ++i) {
      t.x = t.x + s_warp[i].x;
      t.y = t.y + s_warp[i].y;
    }
  }
  __syncthreads();
  return t;  // meaningful in thread 0
}

// Four pair sources: read-only, out of the L1 (which holds the gather
// sources), and kept in L2 between rounds (evict last).
__device__ __forceinline__ int4 load_ids(const int* p) {
  unsigned long long pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  int4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 "
      "{%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 shfl_down2(float2 v, int off) {
  return make_float2(__shfl_down_sync(FULL, v.x, off),
                     __shfl_down_sync(FULL, v.y, off));
}

// The (s, w) shares of the four pairs in `ids` (plain loads: written in
// this launch, ordered by the last grid barrier).
__device__ __forceinline__ void gather4(const float2* xp2, int4 ids,
                                        float2 (&v)[4]) {
  v[0] = xp2[ids.x];
  v[1] = xp2[ids.y];
  v[2] = xp2[ids.z];
  v[3] = xp2[ids.w];
}

// Small class, unit u: pairs 128u..128u+127 of the class, lane L holding
// pairs 4L..4L+3 (their sources in `ids`), so a run of C pairs spans
// G = C/4 lanes (C >= 4) and folds with the roll tree of fold_small: the
// lane's two sh = 1 adds and its sh = 2 add, then shuffles at lane offsets
// 1, 2, ..., G/2 (sh = 4, ..., C/2), each (left block) + (right block).
// C = 2 folds two runs per lane, C = 1 copies four. Runs at or past n_c
// (the region's padding) are not written.
template <int C>
__device__ __forceinline__ void fold_small_unit(const MkParams& p,
                                                const int* cls, long long u,
                                                int4 ids, int lane) {
  const long long n_c = cls[K_NC];
  float2* out = p.yp2 + cls[K_OUT_AT] / 2;
  float2 v[4];
  gather4(p.xp2, ids, v);
  const long long pair0 = u * 128 + lane * 4;
  if constexpr (C == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (pair0 + i < n_c) out[pair0 + i] = v[i];
    }
  } else if constexpr (C == 2) {
    const long long r = pair0 / 2;
    if (r < n_c) out[r] = add2(v[0], v[1]);
    if (r + 1 < n_c) out[r + 1] = add2(v[2], v[3]);
  } else {
    constexpr int G = C / 4;
    float2 t = add2(add2(v[0], v[1]), add2(v[2], v[3]));
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      const float2 o = shfl_down2(t, off);
      t = add2(t, o);
    }
    const long long r = pair0 / C;
    if ((lane & (G - 1)) == 0 && r < n_c) out[r] = t;
  }
}

__device__ __forceinline__ void fold_small(const MkParams& p, const int* cls,
                                           long long u, int4 ids, int lane) {
  switch (cls[K_C]) {
    case 1: fold_small_unit<1>(p, cls, u, ids, lane); break;
    case 2: fold_small_unit<2>(p, cls, u, ids, lane); break;
    case 4: fold_small_unit<4>(p, cls, u, ids, lane); break;
    case 8: fold_small_unit<8>(p, cls, u, ids, lane); break;
    case 16: fold_small_unit<16>(p, cls, u, ids, lane); break;
    case 32: fold_small_unit<32>(p, cls, u, ids, lane); break;
    case 64: fold_small_unit<64>(p, cls, u, ids, lane); break;
    default: __trap();  // the host builds only these classes
  }
}

// the class of unit u of one kind (split: q > 0, or small), searched from
// class k on (a warp's units of a kind only increase within a round)
template <bool SPLIT>
__device__ __forceinline__ int class_of(const int* classes, int k,
                                        long long u) {
  while ((classes[k * K_COLS + K_Q] != 0) != SPLIT
         || u >= classes[k * K_COLS + K_UNIT_AT]
                     + classes[k * K_COLS + K_UNITS]) {
    ++k;
  }
  return k;
}

// the lane's four pair sources of small unit u (numbered over all the
// small classes) of class `cls`
__device__ __forceinline__ const int* unit_nodes(const MkParams& p,
                                                 const int* cls, long long u,
                                                 int lane) {
  return p.pre_node + cls[K_START] + (u - cls[K_UNIT_AT]) * 128 + lane * 4;
}

// Split class, unit u: rows k = 2u and 2u + 1 of the slot-major order
// (k = r*q + j, row j*cap + r of the region), one per half-warp, four
// pairs a lane. Each half folds its row with the roll tree of
// fold_row_warp (pairs 4l..4l+3 locally, then lane offsets 1..8) and
// writes part[k]; the warp then adds 2 to the slot's arrival counter, and
// the warp that completes the slot left-folds its q partials in ascending
// j into the packed output, and resets the counter for the next round.
__device__ __forceinline__ void fold_split_unit(const MkParams& p,
                                                const int* cls, long long u,
                                                int lane, float* stage) {
  const int q = cls[K_Q];
  const long long cap = cls[K_CAP];
  const int half = lane >> 4;
  const long long k = 2 * u + half;
  const long long r = k / q;
  const long long j = k - r * q;
  const int* ids = p.pre_node + cls[K_START] + (j * cap + r) * 64;
  float2 v[4];
  gather4(p.xp2, load_ids(ids + (lane & 15) * 4), v);
  float2 t = add2(add2(v[0], v[1]), add2(v[2], v[3]));
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    const float2 o = shfl_down2(t, off);
    t = add2(t, o);
  }
  float2* part = p.part + cls[K_PART_AT] + r * q;
  if ((lane & 15) == 0) part[j] = t;
  __syncwarp();
  bool last = q == 2;  // the unit is the whole slot: no counter
  if (!last) {
    unsigned got = 0;
    if (lane == 0) {
      got = atom_add_acq_rel_gpu(p.arrived + cls[K_ARR_AT] + r, 2u) + 2u;
    }
    last = __shfl_sync(FULL, got, 0) == static_cast<unsigned>(q);
  }
  if (last) {
    const float2 acc = warp_left_fold<MK_FOLD_DEPTH>(part, q, lane, stage);
    if (lane == 0) {
      p.yp2[cls[K_OUT_AT] / 2 + r] = acc;
      if (q != 2) p.arrived[cls[K_ARR_AT] + r] = 0u;
    }
  }
}

// The fold phase. The split units first, over every warp of the grid;
// then the small units in chunks of MK_WARPS (one unit per warp): chunks
// below half go round robin, chunk c to block c % grid, each warp's unit
// sources loaded one unit ahead; the rest go, one chunk at a time, to
// whichever block asks next (thread 0 asks for the next chunk while the
// warps fold this one). `ctr` is 0 when the phase starts.
__device__ __forceinline__ void fold_phase(const MkParams& p,
                                           const int* classes, int lane,
                                           long long gwarp, long long nwarps,
                                           float* stage,
                                           unsigned long long* ctr,
                                           long long* s_next) {
  const int warp = threadIdx.x >> 5;
  const long long nb = gridDim.x;
  int ks = 0, kq = 0;
  for (long long v = gwarp; v < p.split_units; v += nwarps) {
    ks = class_of<true>(classes, ks, v);
    const int* cls = classes + ks * K_COLS;
    fold_split_unit(p, cls, v - cls[K_UNIT_AT], lane, stage);
  }

  const long long nchunks = (p.small_units + MK_WARPS - 1) / MK_WARPS;
  const long long cstat = nchunks - nchunks / 2;
  const long long end = min(cstat * MK_WARPS, p.small_units);
  const long long step = nb * MK_WARPS;
  long long u = blockIdx.x * static_cast<long long>(MK_WARPS) + warp;
  if (u < end) {
    kq = class_of<false>(classes, kq, u);
    int4 cur = load_ids(unit_nodes(p, classes + kq * K_COLS, u, lane));
    for (; u < end; u += step) {
      const int* cls = classes + kq * K_COLS;
      int4 nxt = cur;
      int kn = kq;
      if (u + step < end) {
        kn = class_of<false>(classes, kq, u + step);
        nxt = load_ids(unit_nodes(p, classes + kn * K_COLS, u + step, lane));
      }
      fold_small(p, cls, u - cls[K_UNIT_AT], cur, lane);
      cur = nxt;
      kq = kn;
    }
  }

  if (threadIdx.x == 0) {
    s_next[0] = cstat + static_cast<long long>(atomicAdd(ctr, 1ull));
  }
  __syncthreads();
  for (int par = 0;; par ^= 1) {
    const long long c = s_next[par];
    if (c >= nchunks) break;
    if (threadIdx.x == 0) {
      s_next[par ^ 1] = cstat + static_cast<long long>(atomicAdd(ctr, 1ull));
    }
    const long long v = c * MK_WARPS + warp;
    if (v < p.small_units) {
      kq = class_of<false>(classes, kq, v);
      const int* cls = classes + kq * K_COLS;
      fold_small(p, cls, v - cls[K_UNIT_AT],
                 load_ids(unit_nodes(p, cls, v, lane)), lane);
    }
    __syncthreads();  // s_next[par] is read by all before it is rewritten
  }
}

template <bool PROBE, bool SMEM_STATE>
__global__ void __launch_bounds__(MK_THREADS, MK_MIN_BLOCKS)
megakernel(const MkParams p) {
  __shared__ int s_count[MK_WARPS];
  __shared__ float2 s_sum[MK_WARPS];
  __shared__ long long s_total;
  __shared__ long long s_next[2];
  __shared__ __align__(16)
      float s_stage[MK_WARPS][LEFT_FOLD_STAGE(MK_FOLD_DEPTH)];
  __shared__ float s_mean;
  __shared__ int s_classes[MK_MAX_CLASSES * K_COLS];
  // the state of this thread's nodes i = gtid + t * gstride: at slot
  // t * MK_THREADS + threadIdx.x of each field in shared memory, or (not
  // SMEM_STATE) at slot i of the state in device memory
  using slot_t = typename std::conditional<SMEM_STATE, int, long long>::type;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  float* ss = p.s;
  float* sw = p.w;
  float* sr = p.ratio;
  const float* sd = p.deg;
  int* sk = p.streak;
  int* sc = p.conv;
  const int* so = p.out_rank;
  float* s_deg = nullptr;  // SMEM_STATE: the prologue's copies of deg and
  int* s_rank = nullptr;   // out_rank
  if constexpr (SMEM_STATE) {
    const int field = p.nodes_per_thread * MK_THREADS;
    ss = reinterpret_cast<float*>(s_dyn);
    sw = ss + field;
    sr = sw + field;
    s_deg = sr + field;
    sk = reinterpret_cast<int*>(s_deg + field);
    sc = sk + field;
    s_rank = sc + field;
    sd = s_deg;
    so = s_rank;
  }

  const unsigned nb = gridDim.x;
  const long long gtid = blockIdx.x * static_cast<long long>(MK_THREADS)
                         + threadIdx.x;
  const long long gstride = static_cast<long long>(nb) * MK_THREADS;
  const int lane = threadIdx.x & 31;
  const long long gwarp = gtid >> 5;
  const long long nwarps = gstride >> 5;
  const long long n = p.n;
  float* stage = s_stage[threadIdx.x >> 5];
  unsigned long long* st = nullptr;
  if (PROBE) {
    st = p.stamps + blockIdx.x * static_cast<long long>(
                        PROBE_HEAD + PROBE_EVENTS * p.k);
    if (threadIdx.x == 0) {
      st[0] = global_ns();
      st[2] = clock64();
    }
  }
  const int* classes = p.classes;
  if (p.ncls <= MK_MAX_CLASSES) {
    for (int i = threadIdx.x; i < p.ncls * K_COLS; i += MK_THREADS) {
      s_classes[i] = p.classes[i];
    }
    classes = s_classes;
  }

  // prologue: the zero slots, the state into shared memory (SMEM_STATE),
  // the first round's shares and the converged rows at entry (parity 0).
  // Every
  // node-indexed loop below uses this same partition (i = gtid + t *
  // gstride), so a thread only ever reads state that it wrote itself.
  if (gtid == 0) {
    p.xp2[n] = make_float2(0.f, 0.f);
    p.yp2[p.nu] = make_float2(0.f, 0.f);
    p.work[0] = 0ull;
  }
  int conv_rows = 0;
  for (int t = 0;; ++t) {
    const long long i = gtid + t * gstride;
    if (i >= n) break;
    const float d = __ldg(p.deg + i);
    const float inv = __fdiv_rn(1.f, __fadd_rn(d, 1.f));
    const float s0 = p.s[i];
    const float w0 = p.w[i];
    const int c0 = p.conv[i];
    p.xp2[i] = make_float2(__fmul_rn(s0, inv), __fmul_rn(w0, inv));
    conv_rows += c0 != 0;
    if constexpr (SMEM_STATE) {
      const int slot = t * MK_THREADS + threadIdx.x;
      ss[slot] = s0;
      sw[slot] = w0;
      sr[slot] = p.ratio[i];
      s_deg[slot] = d;
      sk[slot] = p.streak[i];
      sc[slot] = c0;
      s_rank[slot] = __ldg(p.out_rank + i);
    }
  }
  conv_rows = block_count(conv_rows, s_count);
  if (threadIdx.x == 0) p.cnt[blockIdx.x] = conv_rows;
  grid_sync<PROBE>(p.bar, PROBE ? st + 4 : nullptr);

  int executed = 0;
  for (int r = 0; r < p.k; ++r) {
    unsigned long long* ev = PROBE ? st + PROBE_HEAD + PROBE_EVENTS * r
                                   : nullptr;
    if (PROBE && threadIdx.x == 0) ev[0] = clock64();
    // (1) gather-pre fused into the class folds (scratch only)
    fold_phase(p, classes, lane, gwarp, nwarps, stage, p.work + (r & 1),
               s_next);
    grid_sync<PROBE>(p.bar, PROBE ? ev + 1 : nullptr);

    // (2) done test on the counts of the state after the previous round
    const int* cnt_in = p.cnt + (r & 1) * nb;
    if (threadIdx.x < 32) {
      long long t = 0;
      for (long long b = lane; b < nb; b += 32) t += __ldcg(cnt_in + b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        t += __shfl_down_sync(FULL, t, off);
      if (lane == 0) s_total = t;
    }
    __syncthreads();
    const long long total = s_total;
    if (p.quorum < 0 ? total >= n : total >= p.quorum) break;
    ++executed;
    // the next round's chunk counter (this round's fold is over everywhere)
    if (gtid == 0) p.work[(r + 1) & 1] = 0ull;

    // (3) gather-out, the update and the next round's shares
    float2 local = make_float2(0.f, 0.f);
    conv_rows = 0;
    for (int t = 0;; ++t) {
      const long long i = gtid + t * gstride;
      if (i >= n) break;
      const slot_t slot = SMEM_STATE ? t * MK_THREADS + threadIdx.x : i;
      const float d = sd[slot];
      const float inv = __fdiv_rn(1.f, __fadd_rn(d, 1.f));
      const float s0 = ss[slot];
      const float w0 = sw[slot];
      const float2 in = p.yp2[so[slot]];
      const float s1 = __fadd_rn(__fmaf_rn(-__fmul_rn(s0, inv), d, s0), in.x);
      const float w1 = __fadd_rn(__fmaf_rn(-__fmul_rn(w0, inv), d, w0), in.y);
      const float ratio1 = __fdiv_rn(s1, w1 < 1e-30f ? 1e-30f : w1);
      p.xp2[i] = make_float2(__fmul_rn(s1, inv), __fmul_rn(w1, inv));
      if (p.global_pred) {
        local.x = local.x + s1;
        local.y = local.y + w1;
      } else {
        const bool near = fabsf(__fsub_rn(ratio1, sr[slot])) <= p.eps;
        const int st_i = near ? sk[slot] + 1 : 0;
        const int cv = sc[slot] | (st_i >= p.streak_target ? 1 : 0);
        sk[slot] = st_i;
        sc[slot] = cv;
        conv_rows += cv != 0;
      }
      ss[slot] = s1;
      sw[slot] = w1;
      sr[slot] = ratio1;
    }
    int* cnt_out = p.cnt + ((r + 1) & 1) * nb;
    if (p.global_pred) {
      local = block_sum2(local, s_sum);
      if (threadIdx.x == 0) p.red[blockIdx.x] = local;
      grid_sync<PROBE>(p.bar, PROBE ? ev + 3 : nullptr);
      if (threadIdx.x < 32) {
        const float2 tot = warp_left_fold<MK_FOLD_DEPTH>(p.red, nb, lane,
                                                        s_stage[0]);
        if (lane == 0)
          s_mean = __fdiv_rn(tot.x, tot.y < 1e-30f ? 1e-30f : tot.y);
      }
      __syncthreads();
      const float mean = s_mean;
      for (int t = 0;; ++t) {
        const long long i = gtid + t * gstride;
        if (i >= n) break;
        const slot_t slot = SMEM_STATE ? t * MK_THREADS + threadIdx.x : i;
        const bool near = fabsf(__fsub_rn(sr[slot], mean)) <= p.tol;
        const int st_i = near ? sk[slot] + 1 : 0;
        const int cv = st_i >= p.streak_target ? 1 : 0;  // non-sticky
        sk[slot] = st_i;
        sc[slot] = cv;
        conv_rows += cv;
      }
      conv_rows = block_count(conv_rows, s_count);
      if (threadIdx.x == 0) {
        cnt_out[blockIdx.x] = conv_rows;
        if (PROBE) ev[5] = clock64();
      }
    } else {
      conv_rows = block_count(conv_rows, s_count);
      if (threadIdx.x == 0) cnt_out[blockIdx.x] = conv_rows;
      grid_sync<PROBE>(p.bar, PROBE ? ev + 3 : nullptr);
      if (PROBE && threadIdx.x == 0) ev[5] = ev[4];
    }
  }
  // epilogue: the state back to device memory (a launch that ran no
  // round leaves it untouched; without SMEM_STATE it is there already)
  if (SMEM_STATE && executed) {
    for (int t = 0;; ++t) {
      const long long i = gtid + t * gstride;
      if (i >= n) break;
      const int slot = t * MK_THREADS + threadIdx.x;
      p.s[i] = ss[slot];
      p.w[i] = sw[slot];
      p.ratio[i] = sr[slot];
      p.streak[i] = sk[slot];
      p.conv[i] = sc[slot];
    }
  }
  if (gtid == 0) *p.round += executed;
  if (PROBE && threadIdx.x == 0) {
    st[1] = global_ns();
    st[3] = clock64();
  }
}

}  // namespace

GOSSIP_EXPORT const char* gossip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The largest grid that the cooperative launch accepts on the current
// device: co-resident blocks per SM times the SM count.
GOSSIP_EXPORT int gossip_megakernel_max_grid(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // with no dynamic shared memory: the launcher takes the state-in-shared-
  // memory instantiations only where they stay co-resident at this grid
  const void* fns[] = {
      reinterpret_cast<const void*>(megakernel<false, true>),
      reinterpret_cast<const void*>(megakernel<true, true>),
      reinterpret_cast<const void*>(megakernel<false, false>),
      reinterpret_cast<const void*>(megakernel<true, false>)};
  int least = 0;
  for (int f = 0; f < 4; ++f) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[f],
                                                      MK_THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    least = f == 0 ? per_sm : min(least, per_sm);
  }
  *out = least * sms;
  return 0;
}

namespace {

// The instantiation of one launch (`probe` or plain) and its dynamic
// shared memory: the state in shared memory where its `dyn` bytes fit
// beside the kernel's static shared memory and leave `grid` blocks
// co-resident; else the state in device memory, with none.
cudaError_t pick_kernel(bool probe, size_t dyn, int grid, const void** fn,
                        size_t* fn_dyn) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const void* smem_fn =
      probe ? reinterpret_cast<const void*>(megakernel<true, true>)
            : reinterpret_cast<const void*>(megakernel<false, true>);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, smem_fn);
  if (e != cudaSuccess) return e;
  if (dyn + fa.sharedSizeBytes <= static_cast<size_t>(optin)) {
    e = cudaFuncSetAttribute(smem_fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
    int per_sm = 0;
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, smem_fn,
                                                        MK_THREADS, dyn);
    }
    if (e != cudaSuccess) return e;
    if (static_cast<long long>(per_sm) * sms >= grid) {
      *fn = smem_fn;
      *fn_dyn = dyn;
      return cudaSuccess;
    }
  }
  *fn = probe ? reinterpret_cast<const void*>(megakernel<true, false>)
              : reinterpret_cast<const void*>(megakernel<false, false>);
  *fn_dyn = 0;
  return cudaSuccess;
}

// Each thread's node slots of an `n`-node launch on `grid` blocks, and the
// dynamic shared memory that the state in shared memory takes for them.
int nodes_per_thread(long long n, int grid) {
  const long long per = static_cast<long long>(grid) * MK_THREADS;
  return static_cast<int>((n + per - 1) / per);
}

size_t state_smem_bytes(int per_thread) {
  return static_cast<size_t>(per_thread) * MK_THREADS * MK_NODE_FIELDS * 4;
}

}  // namespace

// Whether a launch over `n` nodes on `grid` blocks keeps the node state in
// shared memory on the current device: the launcher's own choice
// (pick_kernel), asked without launching.
GOSSIP_EXPORT int gossip_megakernel_state_in_smem(long long n, int grid,
                                                  int* out) {
  const void* fn = nullptr;
  size_t fn_dyn = 0;
  cudaError_t e = pick_kernel(
      false, state_smem_bytes(nodes_per_thread(n, grid)), grid, &fn,
      &fn_dyn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *out = fn == reinterpret_cast<const void*>(megakernel<false, true>);
  return 0;
}

// stamps: null for the plain kernel; else the probe's buffer of
// grid * (6 + 6 * k) u64 (PROBE_HEAD, PROBE_EVENTS). The node state takes
// MK_NODE_FIELDS * 4 bytes of dynamic shared memory per node slot where
// it fits (pick_kernel); else it stays in device memory. On the current
// device; grid at most gossip_megakernel_max_grid's.
GOSSIP_EXPORT int gossip_megakernel(
    float* s, float* w, float* ratio, int* streak, int* conv, int* round,
    const float* deg, const int* pre_node, const int* out_rank,
    float* xp2, float* yp2, float* part, int* arrived, float* red, int* cnt,
    int* bar, long long* work, unsigned long long* stamps,
    const int* classes, int ncls, long long split_units,
    long long small_units, long long n, long long nu, int k, float eps,
    float tol, int streak_target, int global_pred, long long quorum,
    int grid, void* stream) {
  MkParams p;
  p.s = s;
  p.w = w;
  p.ratio = ratio;
  p.streak = streak;
  p.conv = conv;
  p.round = round;
  p.deg = deg;
  p.pre_node = pre_node;
  p.out_rank = out_rank;
  p.xp2 = reinterpret_cast<float2*>(xp2);
  p.yp2 = reinterpret_cast<float2*>(yp2);
  p.part = reinterpret_cast<float2*>(part);
  p.arrived = reinterpret_cast<unsigned*>(arrived);
  p.red = reinterpret_cast<float2*>(red);
  p.cnt = cnt;
  p.bar = reinterpret_cast<unsigned*>(bar);
  p.work = reinterpret_cast<unsigned long long*>(work);
  p.stamps = stamps;
  p.classes = classes;
  p.ncls = ncls;
  p.split_units = split_units;
  p.small_units = small_units;
  p.n = n;
  p.nu = nu;
  p.k = k;
  p.eps = eps;
  p.tol = tol;
  p.streak_target = streak_target;
  p.global_pred = global_pred;
  p.quorum = quorum;
  p.nodes_per_thread = nodes_per_thread(n, grid);
  const size_t dyn = state_smem_bytes(p.nodes_per_thread);
  const void* fn = nullptr;
  size_t fn_dyn = 0;
  cudaError_t e = pick_kernel(stamps != nullptr, dyn, grid, &fn, &fn_dyn);
  if (e == cudaSuccess) {
    void* args[] = {&p};
    e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(MK_THREADS), args,
                                    fn_dyn,
                                    static_cast<cudaStream_t>(stream));
  }
  cudaGetLastError();  // a refused launch leaves no sticky error behind
  return static_cast<int>(e);
}
