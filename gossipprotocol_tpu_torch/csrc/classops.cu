// Degree-class fold kernels of the fanout-all deliveries, the expand
// kernels of the routed delivery and the two node-major hub kernels, for
// Hopper (sm_90a).
//
// The only arithmetic of `--delivery pallas` is these folds, and the port
// is held bitwise to the JAX package's Pallas kernels, so each kernel
// replays the fixed pairwise tree of the TPU's lane-roll fold
// (`acc + roll(acc, -sh)`, sh = 2, 4, ...) op for op. IEEE addition is
// commutative but not associative: any other grouping (a warp reduction
// in another order, atomics, `torch.sum`) changes the last bits.
// Compiled without --use_fast_math and with --fmad=false: no
// flush-to-zero of denormals, no contraction.
#include "fold.cuh"

namespace {

// class_reduce_small — replaces gossipprotocol_tpu/ops/classops.py:96
// (class_reduce_small's pallas_call).
//
// Input: f32 [rows * 128], runs of 2c lanes holding c interleaved (s, w)
// pairs; output: f32 [rows * 128 / c], each run's (s, w) sums packed left.
// One thread per output value (one run, one of s|w): it loads the c values
// of its stream (stride 2) and folds them in registers, level by level,
// `v[j] = v[j] + v[j + sh]` for sh = 1, 2, ..., c/2 — exactly the roll
// tree (the lane-roll by 2*sh adds the block that starts sh values to the
// right). c = 1 is a copy (the roll loop of the TPU kernel does not run).
//
// Bound on this card: bytes (each input value read once, each output
// written once; (c-1)/c adds per input value, far below the f32 rate).
// The design keeps the whole fold in registers; neighbouring threads read
// neighbouring runs, so a warp's loads cover one contiguous span of the
// region (strided within it, served from L1 after the first touch).
template <int C>
__global__ void reduce_small_kernel(const float* __restrict__ x,
                                    float* __restrict__ out,
                                    long long n_out) {
  const long long o = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (o >= n_out) return;
  const float* base = x + small_run_base<C>(o);
  out[o] = fold_small<C>([&](int j) { return __ldg(base + 2 * j); });
}

// class_reduce_split — replaces gossipprotocol_tpu/ops/classops.py:183
// (class_reduce_split's pallas_call; the function at :140).
//
// Input: f32 [q * cap * 128], row j*cap + r holding node slot r's j-th
// 64-pair chunk; output: f32 [2 * cap]. Per row, the full 128-lane roll
// fold gives an (s, w) partial; the q partials of a node then add as a
// left fold in ascending j: acc = p_0, acc = acc + p_1, ...
//
// The TPU kernel carried that sum across sequential grid steps in j. The
// widest hub classes have few node slots (cap 8 with q = 2,048 on a
// 1M-node power-law graph), so one block per slot would leave most of the
// 132 SMs idle. One launch, two phases:
//   1. the q*cap rows, taken slot-major (k = r*q + j), are spread over
//      blocks of SPLIT_ROWS rows: each warp loads its SPLIT_ROWS_PER_WARP
//      rows first (that many 16-byte loads per lane in flight, read
//      evict-first: each row is read once), then folds each with
//      fold_row_warp (the roll tree) and
//      writes the partial to part[k] — the scratch [cap, q], so a slot's
//      partials lie contiguous;
//   2. after a barrier, every block adds, per slot it touched, its row
//      count to the slot's arrival counter with an acq_rel atomic: it
//      releases the block's partials (the barrier orders them before
//      it) and acquires the other blocks'. (Two __threadfence()s around
//      a relaxed atomicAdd order the same, and timed slower.) The block
//      that brings a slot's count to q is the last to finish its rows:
//      it resets the counter to 0 (so the next launch on the stream
//      needs no memset) and left-folds the slot's q partials with
//      warp_left_fold (csrc/fold.cuh), one warp per slot.
// (fold_rows_and_arrive, shared with reduce_big_kernel; a slot whose
// rows all lie in one block takes no counter.)
// A slot with q >= SPLIT_ROWS is spread over q/SPLIT_ROWS blocks and
// folded in whichever SM finishes it last; small q packs whole slots into
// one block, which folds them itself.
//
// Bound on this card: bytes (each value read once, one add per value).
// What remains beyond it: the ascending-j fold is q dependent adds per
// stream, which the bitwise contract forbids reassociating; at q = 2,048
// that chain, not the bytes, sets the kernel's time (PERF.md).
constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_WARPS = SPLIT_THREADS / 32;
constexpr int SPLIT_ROWS = 64;  // rows per block
constexpr int SPLIT_ROWS_PER_WARP = SPLIT_ROWS / SPLIT_WARPS;
// chunks of 16 pairs the slot's fold loads ahead (csrc/fold.cuh)
constexpr int SPLIT_FOLD_DEPTH = 16;

__device__ __forceinline__ unsigned int atomic_add_acq_rel(unsigned int* p,
                                                          unsigned int v) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Phases 1 and 2 of a spread fold, shared by the split and the node-major
// hub reduce: the block folds rows k0..k1-1 of a node-contiguous order
// (k = node*q + j; row k at x + row_of(k)*128) into part[k], then makes
// one arrival per node it touched. Returns the number of nodes whose
// rows this block finished last; their offsets from k0/q are in s_done.
// The caller's threads all call it (it holds two block barriers).
template <class RowOf>
__device__ __forceinline__ int fold_rows_and_arrive(
    const float* __restrict__ x, RowOf row_of, float2* __restrict__ part,
    unsigned int* __restrict__ arrived, long long k0, long long k1, int q,
    int* s_done, int* s_ndone) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) *s_ndone = 0;

  // 1. the row folds
  const long long kw = k0 + warp * SPLIT_ROWS_PER_WARP;
  float4 a[SPLIT_ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < SPLIT_ROWS_PER_WARP; ++i) {
    const long long k = kw + i;
    if (k < k1) {
      a[i] = __ldcs(reinterpret_cast<const float4*>(
                        x + row_of(k) * GOSSIP_LANES) + lane);
    }
  }
#pragma unroll
  for (int i = 0; i < SPLIT_ROWS_PER_WARP; ++i) {
    if (kw + i < k1) {  // warp-uniform: the whole warp shuffles
      const float2 p = fold_row_warp(a[i]);
      if (lane == 0) part[kw + i] = p;
    }
  }
  __syncthreads();

  // 2. arrivals; the last block of a node folds it. A node whose rows
  // all lie in this block needs no counter (it stays 0): the barriers
  // make the block's own partials visible to all its threads
  const long long r0 = k0 / q;
  const int nslots = static_cast<int>((k1 - 1) / q - r0 + 1);
  if (threadIdx.x < nslots) {
    const long long r = r0 + threadIdx.x;
    const unsigned int rows = static_cast<unsigned int>(
        min(k1, (r + 1) * q) - max(k0, r * q));
    const unsigned int uq = static_cast<unsigned int>(q);
    if (rows == uq || atomic_add_acq_rel(arrived + r, rows) + rows == uq) {
      if (rows != uq) arrived[r] = 0;
      s_done[atomicAdd(s_ndone, 1)] = static_cast<int>(threadIdx.x);
    }
  }
  __syncthreads();
  // the other blocks' partials: acquired by the arrival and this
  // barrier, read from L2 (the point of coherence) by __ldcg
  return *s_ndone;
}

__global__ void __launch_bounds__(SPLIT_THREADS)
reduce_split_kernel(const float* __restrict__ x, float* __restrict__ out,
                    float2* __restrict__ part,
                    unsigned int* __restrict__ arrived, long long cap,
                    int q) {
  __shared__ int s_done[SPLIT_ROWS];  // slots (offsets from r0) to fold here
  __shared__ int s_ndone;
  __shared__ __align__(16)
      float s_stage[SPLIT_WARPS][LEFT_FOLD_STAGE(SPLIT_FOLD_DEPTH)];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long k0 = blockIdx.x * static_cast<long long>(SPLIT_ROWS);
  const long long k1 = min(k0 + SPLIT_ROWS, cap * q);
  // slot-major k = r*q + j is row j*cap + r of the sub-class-major region
  const int ndone = fold_rows_and_arrive(
      x, [=](long long k) { return (k % q) * cap + k / q; }, part, arrived,
      k0, k1, q, s_done, &s_ndone);
  const long long r0 = k0 / q;
  for (int i = warp; i < ndone; i += SPLIT_WARPS) {
    const long long r = r0 + s_done[i];
    const float2 acc = warp_left_fold<SPLIT_FOLD_DEPTH>(part + r * q, q, lane,
                                                       s_stage[warp]);
    if (lane == 0) {
      out[2 * r] = acc.x;
      out[2 * r + 1] = acc.y;
    }
  }
}

// class_expand_small — replaces gossipprotocol_tpu/ops/classops.py:129
// (class_expand_small's pallas_call).
//
// Input: f32 [rows * 128 / c], each row's packed (s, w) pairs; output:
// f32 [rows * 128], output lane j of a row reading packed lane
// 2*(j / 2c) + j%2 of the same row (each pair replicated across its
// 2c-lane run; c = 1 is a copy). One thread per four output lanes, one
// 16-byte store; the packed row is read through L1.
//
// Bound on this card: bytes (each packed value read once, each output
// written once; no arithmetic).
template <int C>
__global__ void expand_small_kernel(const float* __restrict__ packed,
                                    float4* __restrict__ out,
                                    long long n4) {
  const long long o = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (o >= n4) return;
  const float* src = packed + (o >> 5) * (GOSSIP_LANES / C);
  const int j = static_cast<int>(o & 31) * 4;
  float v[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    v[l] = __ldg(src + 2 * ((j + l) / (2 * C)) + ((j + l) & 1));
  }
  out[o] = make_float4(v[0], v[1], v[2], v[3]);
}

// class_expand_split — replaces gossipprotocol_tpu/ops/classops.py:216
// (class_expand_split's pallas_call).
//
// Input: f32 [2 * cap] packed (s, w) per node slot; output f32
// [q * cap * 128], row j*cap + r carrying node slot r's s on its even and
// w on its odd lanes (q = 2c/128 sub-class rows per node: 2,048 for the
// c = 131,072 hub class of a 1M-node power-law graph). One thread per
// four output lanes. Bound on this card: bytes (the output is 64*q times
// the input; the input stays in L1/L2).
__global__ void expand_split_kernel(const float2* __restrict__ packed,
                                    float4* __restrict__ out, long long cap,
                                    long long n4) {
  const long long o = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (o >= n4) return;
  const float2 p = __ldg(packed + (o >> 5) % cap);
  out[o] = make_float4(p.x, p.y, p.x, p.y);
}

// class_reduce_big — replaces gossipprotocol_tpu/ops/classops.py:228
// (class_reduce_big's pallas_call, :265).
//
// Input: f32 [n_c * q * 128], node-major: node i owns rows i*q .. i*q+q-1
// (q = 2c/128); output: f32 [2 * n_c]. The TPU kernel runs one grid step
// per (node, block of qb = min(q, 1024) rows): it folds every row with the
// 128-lane roll tree, sums lanes 0 and 1 of the block's rows with
// `jnp.sum(acc[:, :2], axis=0)`, and adds the block partials in ascending
// block order. That sum is compiled by XLA, which on the CPU rewrites a
// reduction longer than 32 into windows of 32 (the rows padded with zeros
// to whole windows, half the padding, rounded down, in front): each window
// is a left fold from 0, then the window sums are a left fold from 0 —
// the order the JAX package's interpret mode runs and the port replays.
// (Zero padding adds nothing to a sum begun at +0, so only the shift of
// the window bounds by the leading padding is replayed.)
//
// The split design of reduce_split_kernel, in node-major order: the n_c*q
// rows spread over blocks of SPLIT_ROWS (fold_rows_and_arrive: row folds
// into the scratch part[node*q + j], one arrival per node), and the last
// block to finish a node folds its partials. The widest hub class has a
// handful of nodes (8 slots of 2,048 rows at power_law 1M), so one block
// per node would leave most of the 132 SMs idle. The fold's dependent
// chain is short: every window is a left fold of at most 32 values, so
// one thread per window (its up to 32 partials loaded from L2 at once),
// then one thread per row block for the window sums, then one thread per
// node for the ascending block carry. A block that finishes several nodes
// (small q) folds them all in the same passes.
//
// Bound on this card: bytes (each value read once; one add per value).
constexpr int BIGQ = 1024;
constexpr int BIG_WINDOW = 32;

__global__ void __launch_bounds__(SPLIT_THREADS)
reduce_big_kernel(const float* __restrict__ x, float* __restrict__ out,
                  float2* __restrict__ part,
                  unsigned int* __restrict__ arrived, long long n_c, int q) {
  __shared__ int s_done[SPLIT_ROWS];  // nodes (offsets from r0) to fold here
  __shared__ int s_ndone;
  __shared__ float2 s_win[SPLIT_THREADS];
  __shared__ float2 s_blk[SPLIT_THREADS];
  const int t = static_cast<int>(threadIdx.x);
  const long long k0 = blockIdx.x * static_cast<long long>(SPLIT_ROWS);
  const long long k1 = min(k0 + SPLIT_ROWS, n_c * q);
  const int ndone = fold_rows_and_arrive(
      x, [](long long k) { return k; }, part, arrived, k0, k1, q, s_done,
      &s_ndone);
  if (ndone == 0) return;  // block-uniform
  const long long r0 = k0 / q;
  const int qb = min(q, BIGQ);
  const int nblk = q / qb;
  const int nwin = qb <= BIG_WINDOW ? 1 : (qb + BIG_WINDOW - 1) / BIG_WINDOW;
  const int width = qb <= BIG_WINDOW ? qb : BIG_WINDOW;
  const int lo = (nwin * width - qb) / 2;  // leading padding
  // units (node d, row block b), u = d*nblk + b, nwin windows each; a pass
  // takes as many whole units as there are threads for their windows
  const int per_pass = SPLIT_THREADS / nwin;
  const int units = ndone * nblk;
  float2 acc = make_float2(0.f, 0.f);  // node t's sum, for t < ndone
  for (int u0 = 0; u0 < units; u0 += per_pass) {
    const int nu = min(per_pass, units - u0);
    if (t < nu * nwin) {  // window w of unit u0 + t/nwin: a left fold from 0
      const int u = u0 + t / nwin;
      const int w = t - (t / nwin) * nwin;
      const long long node = r0 + s_done[u / nblk];
      const float2* p = part + node * q
                        + static_cast<long long>(u % nblk) * qb;
      const int i0 = max(w * width - lo, 0);
      const int len = min((w + 1) * width - lo, qb) - i0;
      float2 v[BIG_WINDOW];
#pragma unroll
      for (int i = 0; i < BIG_WINDOW; ++i) {
        v[i] = i < len ? __ldcg(p + i0 + i) : make_float2(0.f, 0.f);
      }
      float s = 0.f, sw = 0.f;
#pragma unroll
      for (int i = 0; i < BIG_WINDOW; ++i) {
        if (i < len) {
          s = s + v[i].x;
          sw = sw + v[i].y;
        }
      }
      s_win[t] = make_float2(s, sw);
    }
    __syncthreads();
    if (t < nu) {  // the windows of unit u0 + t: a left fold from 0
      float s = 0.f, sw = 0.f;
      for (int w = 0; w < nwin; ++w) {
        s = s + s_win[t * nwin + w].x;
        sw = sw + s_win[t * nwin + w].y;
      }
      s_blk[t] = make_float2(s, sw);
    }
    __syncthreads();
    if (t < ndone) {  // node t's units of this pass, in ascending block order
      const int u1 = min(u0 + nu, (t + 1) * nblk);
      for (int u = max(u0, t * nblk); u < u1; ++u) {
        const float2 b = s_blk[u - u0];
        if (u == t * nblk) {
          acc = b;
        } else {
          acc.x = acc.x + b.x;
          acc.y = acc.y + b.y;
        }
      }
    }
    __syncthreads();  // s_win and s_blk are refilled by the next pass
  }
  if (t < ndone) {
    const long long node = r0 + s_done[t];
    out[2 * node] = acc.x;
    out[2 * node + 1] = acc.y;
  }
}

// class_expand_big — replaces gossipprotocol_tpu/ops/classops.py:280
// (class_expand_big's pallas_call, :302).
//
// Input: f32 [2 * n_c] packed (s, w) per node; output f32 [n_c * q * 128],
// node i's q rows carrying its s on the even and its w on the odd lanes:
// float4 o of the output is (s, w, s, w) of node o / 32q. Bound on this
// card: bytes written (the output is 64q times the input, which stays in
// L1/L2). An exact copy.
//
// At most one full wave of EXPAND_BIG_THREADS-thread blocks walks the
// output grid-stride, one float4 a thread a step, stored evict-first
// (__stcs: nothing here reads the output again); the wrapper picks the
// grid (ops/classops.py expand_big_geometry). What costs is the writes
// (a memset of the same bytes is the floor) and, before the first of
// them, the pair's trip from L2, so a thread's prologue is kept to a few
// instructions: where q is a power of two (every hub class the deliveries
// form) the node is o >> log2(32q); otherwise it is carried from step to
// step by increments the launcher computes, after one 32-bit division a
// thread. No division per store either way. (The old kernel paid a 64-bit
// division before each store; 2, 4 and 8 stores a thread, with one pair
// load per node they met, ran slower: PERF.md §6 row 6.)
constexpr int EXPAND_BIG_THREADS = 128;

template <bool POW2>
__global__ void __launch_bounds__(EXPAND_BIG_THREADS)
expand_big_kernel(const float2* __restrict__ pairs, float4* __restrict__ out,
                  long long n4, int shift, long long span,
                  long long step_nodes, long long step_rem) {
  // below 2^31: the grid is at most one wave
  const unsigned first = blockIdx.x * EXPAND_BIG_THREADS + threadIdx.x;
  const long long step =
      static_cast<long long>(gridDim.x) * EXPAND_BIG_THREADS;
  long long node = 0;
  long long rem = 0;
  if (!POW2) {
    // a span of 2^31 or more holds every first float4 in node 0
    const unsigned span32 = span < 0x80000000LL
                                ? static_cast<unsigned>(span) : 0x80000000u;
    node = first / span32;
    rem = first % span32;
  }
  for (long long o = first; o < n4; o += step) {
    const float2 p = __ldg(pairs + (POW2 ? o >> shift : node));
    __stcs(out + o, make_float4(p.x, p.y, p.x, p.y));
    if (!POW2) {
      node += step_nodes;
      rem += step_rem;
      if (rem >= span) {
        rem -= span;
        ++node;
      }
    }
  }
}

constexpr int EXPAND_THREADS = 256;

template <int C>
cudaError_t launch_expand_small(const float* packed, float* out,
                                long long rows, cudaStream_t stream) {
  const long long n4 = rows * (GOSSIP_LANES / 4);
  expand_small_kernel<C>
      <<<gossip_blocks(n4, EXPAND_THREADS), EXPAND_THREADS, 0, stream>>>(
          packed, reinterpret_cast<float4*>(out), n4);
  return cudaGetLastError();
}

constexpr int SMALL_THREADS = 256;

template <int C>
cudaError_t launch_small(const float* x, float* out, long long rows,
                         cudaStream_t stream) {
  const long long n_out = rows * GOSSIP_LANES / C;
  reduce_small_kernel<C>
      <<<gossip_blocks(n_out, SMALL_THREADS), SMALL_THREADS, 0, stream>>>(
          x, out, n_out);
  return cudaGetLastError();
}

}  // namespace

GOSSIP_EXPORT const char* gossip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

GOSSIP_EXPORT int gossip_class_reduce_small(const float* x, float* out,
                                            long long rows, int c,
                                            void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return launch_small<1>(x, out, rows, s);
    case 2: return launch_small<2>(x, out, rows, s);
    case 4: return launch_small<4>(x, out, rows, s);
    case 8: return launch_small<8>(x, out, rows, s);
    case 16: return launch_small<16>(x, out, rows, s);
    case 32: return launch_small<32>(x, out, rows, s);
    case 64: return launch_small<64>(x, out, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// part: f32 scratch [2 * cap * q]; arrived: int32 [cap], all 0 on entry
// and left all 0 by the launch
GOSSIP_EXPORT int gossip_class_reduce_split(const float* x, float* out,
                                            float* part, int* arrived,
                                            long long cap, int q,
                                            void* stream) {
  if (cap == 0) return 0;
  if (q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = gossip_blocks(cap * q, SPLIT_ROWS);
  reduce_split_kernel<<<static_cast<unsigned int>(blocks), SPLIT_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, out, reinterpret_cast<float2*>(part),
      reinterpret_cast<unsigned int*>(arrived), cap, q);
  return static_cast<int>(cudaGetLastError());
}

GOSSIP_EXPORT int gossip_class_expand_small(const float* packed, float* out,
                                            long long rows, int c,
                                            void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return launch_expand_small<1>(packed, out, rows, s);
    case 2: return launch_expand_small<2>(packed, out, rows, s);
    case 4: return launch_expand_small<4>(packed, out, rows, s);
    case 8: return launch_expand_small<8>(packed, out, rows, s);
    case 16: return launch_expand_small<16>(packed, out, rows, s);
    case 32: return launch_expand_small<32>(packed, out, rows, s);
    case 64: return launch_expand_small<64>(packed, out, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

GOSSIP_EXPORT int gossip_class_expand_split(const float* packed, float* out,
                                            long long cap, int q,
                                            void* stream) {
  if (cap == 0) return 0;
  const long long n4 = static_cast<long long>(q) * cap * (GOSSIP_LANES / 4);
  expand_split_kernel<<<gossip_blocks(n4, EXPAND_THREADS), EXPAND_THREADS,
                        0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(packed),
      reinterpret_cast<float4*>(out), cap, n4);
  return static_cast<int>(cudaGetLastError());
}

// part: f32 scratch [2 * n_c * q]; arrived: int32 [n_c], all 0 on entry
// and left all 0 by the launch
GOSSIP_EXPORT int gossip_class_reduce_big(const float* x, float* out,
                                          float* part, int* arrived,
                                          long long n_c, int q,
                                          void* stream) {
  if (n_c == 0) return 0;
  if (q < 1 || (q > BIGQ && q % BIGQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = gossip_blocks(n_c * q, SPLIT_ROWS);
  reduce_big_kernel<<<static_cast<unsigned int>(blocks), SPLIT_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, out, reinterpret_cast<float2*>(part),
      reinterpret_cast<unsigned int*>(arrived), n_c, q);
  return static_cast<int>(cudaGetLastError());
}

// blocks from ops/classops.py expand_big_geometry
GOSSIP_EXPORT int gossip_class_expand_big(const float* pairs, float* out,
                                          long long n_c, int q,
                                          long long blocks, void* stream) {
  if (n_c == 0) return 0;
  if (q < 1 || blocks < 1 || blocks * EXPAND_BIG_THREADS > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long span = 32LL * q;  // float4 of a node
  const long long step = blocks * EXPAND_BIG_THREADS;
  const auto grid = static_cast<unsigned int>(blocks);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pv = reinterpret_cast<const float2*>(pairs);
  auto* ov = reinterpret_cast<float4*>(out);
  if ((q & (q - 1)) == 0) {
    int shift = 5;
    while ((1LL << shift) < span) ++shift;
    expand_big_kernel<true><<<grid, EXPAND_BIG_THREADS, 0, s>>>(
        pv, ov, n_c * span, shift, span, 0, 0);
  } else {
    expand_big_kernel<false><<<grid, EXPAND_BIG_THREADS, 0, s>>>(
        pv, ov, n_c * span, 0, span, step / span, step % span);
  }
  return static_cast<int>(cudaGetLastError());
}
