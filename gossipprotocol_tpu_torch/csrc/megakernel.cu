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
// every SM: ONE persistent cooperative launch (as many blocks as can be
// co-resident), its phases separated by a grid-wide barrier, the state
// updated in place. The barrier is a generation-counting one on two global
// words (arrivals, generation); the cooperative launch guarantees that
// every block is resident, so spinning cannot deadlock.
//
// Per round: (1) every thread writes the shares of its nodes into the
// padded gather-pre source `xp` ([share_s | share_w | +0.0 tail]);
// barrier; done test; (2) the gather-pre is fused into the fold: each fold
// thread reads its run's lanes through idx_pre and folds them with the
// exact roll tree (csrc/fold.cuh); split classes write per-row partials,
// then (after a barrier) one warp per node slot left-folds its q partials
// in ascending j (warp_left_fold, csrc/fold.cuh, shared with the split
// fold of csrc/classops.cu); each class's packed output lands at its
// prefix offset in `yp`; barrier; (3) gather-out and the update. The
// predicate "global" adds per-block partial sums of s and w, a barrier,
// and the mean. (4) Each block counts its converged rows; the next round's
// done test sums the counts after its first barrier.
//
// Bitwise rules: s' = fadd(fma(-share, deg, s), in) — the single rounding
// of s - share*deg that XLA on the CPU computes (the port's plain version
// replays it exactly in float64, protocols/diffusion.py _keep); IEEE
// division (__fdiv_rn) for 1/(deg+1), s'/max(w', 1e-30) and the mean; no
// float atomics. The block partials of the global mean are folded in block
// order by every block, so the mean is deterministic — not torch.sum's
// order, but only `near` reads it; s, w and ratio never depend on it.
// Built with --fmad=false and without fast math: no contraction beyond
// the explicit fma, denormals kept.
//
// Bound on this card: bytes. A round streams idx_pre + idx_out (int32)
// and reads and writes the state — about 70 MB at imp3D 512,000 nodes
// (idx_pre alone 41 MB), ~0.02 ms at 3.35 TB/s; the gather sources (at
// most 4 MB each under the resident plan) stay in the 50 MB L2. On top
// of that each round pays a fixed cost of 2-4 grid barriers (3-5 under
// the global predicate). The design pays the launch and the host's
// per-round enqueue once per K rounds, keeps the sources in L2 between
// phases, reads the index tables with 16-byte coalesced loads where a row
// is folded whole, and exits a frozen launch after one barrier.
#include "fold.cuh"

namespace {

constexpr int MK_THREADS = 256;
constexpr int MK_WARPS = MK_THREADS / 32;
// Four co-resident blocks per SM (at most 64 registers a thread) fix the
// cooperative grid at 4 x the SM count, and with it the block order in
// which the global mean's partial sums are folded.
constexpr int MK_MIN_BLOCKS = 4;
// chunks of 16 pairs the split classes' left fold loads ahead
// (csrc/fold.cuh), within the register bound above
constexpr int MK_FOLD_DEPTH = 4;
constexpr unsigned FULL = 0xffffffffu;

// columns of the class table (int32 [ncls, 8], built by ops/megakernel.py)
enum { K_C = 0, K_NC, K_START, K_CAP, K_Q, K_OUT_AT, K_PART_AT, K_COLS = 8 };

struct MkParams {
  float* s;              // [rp * 128] state, updated in place
  float* w;
  float* ratio;
  int* streak;
  int* conv;
  int* round;            // scalar: += the rounds this launch ran
  const float* deg;      // [n] f32 degree
  const int* idx_pre;    // [tiles_pre * 1024] resident gather-pre plan
  const int* idx_out;    // [tiles_out * 1024] resident gather-out plan
  float* xp;             // [xp_len] gather-pre source
  float* yp;             // [yp_len] gather-out source
  float2* part;          // split-class row partials, [r * q + j] per class
  float2* red;           // [grid] per-block (sum s, sum w)
  int* cnt;              // [grid] per-block converged-row counts
  unsigned int* bar;     // [2] barrier: arrivals, generation
  const int* classes;
  int ncls;
  int has_split;
  long long n;
  long long xp_len;
  long long yp_len;
  long long y_len;       // 2 * nu: the packed fold outputs
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

// Grid-wide barrier. Thread 0 of each block arrives on `bar[0]`; the last
// to arrive resets it and advances the generation `bar[1]`, on which the
// others spin. The fences order every block's writes before the barrier
// against every read after it (data written inside the launch is read
// with __ldcg, from L2, never from a stale L1 line).
__device__ __forceinline__ void grid_sync(unsigned int* bar, unsigned nb) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nb - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long t0 = clock64();
      while (*gen == g) {
        __nanosleep(32);
        if (clock64() - t0 > BARRIER_TIMEOUT_CYCLES) __trap();
      }
    }
    __threadfence();
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

// Small class: one thread per packed output, its c values gathered
// through idx_pre and folded with the roll tree.
template <int C>
__device__ __forceinline__ void fold_small_class(const MkParams& p,
                                                 const int* cls,
                                                 long long gtid,
                                                 long long gstride) {
  const long long items = 2LL * cls[K_NC];
  const int* ib = p.idx_pre + 2LL * cls[K_START];
  float* out = p.yp + cls[K_OUT_AT];
  const float* xp = p.xp;
  for (long long o = gtid; o < items; o += gstride) {
    const int* ir = ib + small_run_base<C>(o);
    out[o] = fold_small<C>(
        [&](int j) { return __ldcg(xp + __ldg(ir + 2 * j)); });
  }
}

__device__ void fold_small_dispatch(const MkParams& p, const int* cls,
                                    long long gtid, long long gstride) {
  switch (cls[K_C]) {
    case 1: fold_small_class<1>(p, cls, gtid, gstride); break;
    case 2: fold_small_class<2>(p, cls, gtid, gstride); break;
    case 4: fold_small_class<4>(p, cls, gtid, gstride); break;
    case 8: fold_small_class<8>(p, cls, gtid, gstride); break;
    case 16: fold_small_class<16>(p, cls, gtid, gstride); break;
    case 32: fold_small_class<32>(p, cls, gtid, gstride); break;
    case 64: fold_small_class<64>(p, cls, gtid, gstride); break;
    default: __trap();  // the host builds only these classes
  }
}

__global__ void __launch_bounds__(MK_THREADS, MK_MIN_BLOCKS)
megakernel(const MkParams p) {
  __shared__ int s_count[MK_WARPS];
  __shared__ float2 s_sum[MK_WARPS];
  __shared__ long long s_total;
  __shared__ __align__(16)
      float s_stage[MK_WARPS][LEFT_FOLD_STAGE(MK_FOLD_DEPTH)];
  __shared__ float s_mean;
  const unsigned nb = gridDim.x;
  const long long gtid = blockIdx.x * static_cast<long long>(MK_THREADS)
                         + threadIdx.x;
  const long long gstride = static_cast<long long>(nb) * MK_THREADS;
  const int lane = threadIdx.x & 31;
  const long long gwarp = gtid >> 5;
  const long long nwarps = gstride >> 5;
  const long long n = p.n;

  // the sources' zero tails (never written by a round)
  for (long long i = 2 * n + gtid; i < p.xp_len; i += gstride) p.xp[i] = 0.f;
  for (long long i = p.y_len + gtid; i < p.yp_len; i += gstride) p.yp[i] = 0.f;

  // converged rows at entry, for the first done test. Every node-indexed
  // loop below uses this same partition (i = gtid + t * gstride), so a
  // thread only ever reads state that it wrote itself.
  int conv_rows = 0;
  for (long long i = gtid; i < n; i += gstride) conv_rows += p.conv[i] != 0;
  conv_rows = block_count(conv_rows, s_count);
  if (threadIdx.x == 0) p.cnt[blockIdx.x] = conv_rows;

  int executed = 0;
  for (int r = 0; r < p.k; ++r) {
    // (1) shares. Written before the done test (which needs the barrier
    // below anyway): a frozen exit has then written scratch only.
    for (long long i = gtid; i < n; i += gstride) {
      const float d = __ldg(p.deg + i);
      const float inv = __fdiv_rn(1.f, __fadd_rn(d, 1.f));
      p.xp[i] = __fmul_rn(p.s[i], inv);
      p.xp[n + i] = __fmul_rn(p.w[i], inv);
    }
    grid_sync(p.bar, nb);

    // done test: the per-block counts, written after the previous round's
    // fold barrier and overwritten only after this round's, summed alike
    // by every block
    if (threadIdx.x < 32) {
      long long t = 0;
      for (long long b = lane; b < nb; b += 32) t += __ldcg(p.cnt + b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        t += __shfl_down_sync(FULL, t, off);
      if (lane == 0) s_total = t;
    }
    __syncthreads();
    const long long total = s_total;
    if (p.quorum < 0 ? total >= n : total >= p.quorum) break;
    ++executed;

    // (2) gather-pre fused into the class folds
    for (int k = 0; k < p.ncls; ++k) {
      const int* cls = p.classes + k * K_COLS;
      const int q = cls[K_Q];
      if (q == 0) {
        fold_small_dispatch(p, cls, gtid, gstride);
        continue;
      }
      const long long n_c = cls[K_NC];
      const long long cap = cls[K_CAP];
      const int* ib = p.idx_pre + 2LL * cls[K_START];
      float2* part = p.part + cls[K_PART_AT];
      for (long long wi = gwarp; wi < q * n_c; wi += nwarps) {
        const long long j = wi / n_c;
        const long long rr = wi - j * n_c;
        const int4 ix = __ldg(reinterpret_cast<const int4*>(
                                  ib + (j * cap + rr) * GOSSIP_LANES) + lane);
        float4 a;
        a.x = __ldcg(p.xp + ix.x);
        a.y = __ldcg(p.xp + ix.y);
        a.z = __ldcg(p.xp + ix.z);
        a.w = __ldcg(p.xp + ix.w);
        const float2 pr = fold_row_warp(a);
        if (lane == 0) part[rr * q + j] = pr;
      }
    }
    grid_sync(p.bar, nb);
    if (p.has_split) {
      for (int k = 0; k < p.ncls; ++k) {
        const int* cls = p.classes + k * K_COLS;
        const int q = cls[K_Q];
        if (q == 0) continue;
        const long long n_c = cls[K_NC];
        const float2* part = p.part + cls[K_PART_AT];
        float* out = p.yp + cls[K_OUT_AT];
        for (long long rr = gwarp; rr < n_c; rr += nwarps) {
          const float2 acc = warp_left_fold<MK_FOLD_DEPTH>(
              part + rr * q, q, lane, s_stage[threadIdx.x >> 5]);
          if (lane == 0) {
            out[2 * rr] = acc.x;
            out[2 * rr + 1] = acc.y;
          }
        }
      }
      grid_sync(p.bar, nb);
    }

    // (3) gather-out and the update
    float2 local = make_float2(0.f, 0.f);
    conv_rows = 0;
    for (long long i = gtid; i < n; i += gstride) {
      const float d = __ldg(p.deg + i);
      const float inv = __fdiv_rn(1.f, __fadd_rn(d, 1.f));
      const float s0 = p.s[i];
      const float w0 = p.w[i];
      const float in_s = __ldcg(p.yp + __ldg(p.idx_out + i));
      const float in_w = __ldcg(p.yp + __ldg(p.idx_out + n + i));
      const float s1 = __fadd_rn(__fmaf_rn(-__fmul_rn(s0, inv), d, s0), in_s);
      const float w1 = __fadd_rn(__fmaf_rn(-__fmul_rn(w0, inv), d, w0), in_w);
      const float ratio1 = __fdiv_rn(s1, w1 < 1e-30f ? 1e-30f : w1);
      p.s[i] = s1;
      p.w[i] = w1;
      if (p.global_pred) {
        p.ratio[i] = ratio1;
        local.x = local.x + s1;
        local.y = local.y + w1;
      } else {
        const bool near = fabsf(__fsub_rn(ratio1, p.ratio[i])) <= p.eps;
        const int st = near ? p.streak[i] + 1 : 0;
        const int cv = p.conv[i] | (st >= p.streak_target ? 1 : 0);
        p.ratio[i] = ratio1;
        p.streak[i] = st;
        p.conv[i] = cv;
        conv_rows += cv != 0;
      }
    }
    if (p.global_pred) {
      local = block_sum2(local, s_sum);
      if (threadIdx.x == 0) p.red[blockIdx.x] = local;
      grid_sync(p.bar, nb);
      if (threadIdx.x < 32) {
        const float2 tot = warp_left_fold<MK_FOLD_DEPTH>(p.red, nb, lane,
                                                        s_stage[0]);
        if (lane == 0)
          s_mean = __fdiv_rn(tot.x, tot.y < 1e-30f ? 1e-30f : tot.y);
      }
      __syncthreads();
      const float mean = s_mean;
      for (long long i = gtid; i < n; i += gstride) {
        const bool near = fabsf(__fsub_rn(p.ratio[i], mean)) <= p.tol;
        const int st = near ? p.streak[i] + 1 : 0;
        const int cv = st >= p.streak_target ? 1 : 0;  // non-sticky
        p.streak[i] = st;
        p.conv[i] = cv;
        conv_rows += cv;
      }
    }
    conv_rows = block_count(conv_rows, s_count);
    if (threadIdx.x == 0) p.cnt[blockIdx.x] = conv_rows;
  }
  if (gtid == 0) *p.round += executed;
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
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, megakernel,
                                                    MK_THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *out = per_sm * sms;
  return 0;
}

GOSSIP_EXPORT int gossip_megakernel(
    float* s, float* w, float* ratio, int* streak, int* conv, int* round,
    const float* deg, const int* idx_pre, const int* idx_out,
    float* xp, long long xp_len, float* yp, long long yp_len,
    long long y_len, float* part, float* red, int* cnt, unsigned int* bar,
    const int* classes, int ncls, int has_split, long long n, int k,
    float eps, float tol, int streak_target, int global_pred,
    long long quorum, int grid, void* stream) {
  MkParams p;
  p.s = s;
  p.w = w;
  p.ratio = ratio;
  p.streak = streak;
  p.conv = conv;
  p.round = round;
  p.deg = deg;
  p.idx_pre = idx_pre;
  p.idx_out = idx_out;
  p.xp = xp;
  p.yp = yp;
  p.part = reinterpret_cast<float2*>(part);
  p.red = reinterpret_cast<float2*>(red);
  p.cnt = cnt;
  p.bar = bar;
  p.classes = classes;
  p.ncls = ncls;
  p.has_split = has_split;
  p.n = n;
  p.xp_len = xp_len;
  p.yp_len = yp_len;
  p.y_len = y_len;
  p.k = k;
  p.eps = eps;
  p.tol = tol;
  p.streak_target = streak_target;
  p.global_pred = global_pred;
  p.quorum = quorum;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(megakernel), dim3(grid), dim3(MK_THREADS),
      args, 0, static_cast<cudaStream_t>(stream));
  cudaGetLastError();  // a refused launch leaves no sticky error behind
  return static_cast<int>(e);
}
