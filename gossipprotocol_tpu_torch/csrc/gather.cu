// Tile gathers of the fused gather delivery, for Hopper (sm_90a).
//
// Both compute out[e] = x[src[e]] for one composed copy-chain of the
// delivery (ops/pallasdelivery.py). `x` is the padded source view
// [src_rows * 128] whose tail past the real source reads +0.0, and the
// plan tables are the JAX package's byte for byte. Pure data movement:
// bitwise equal to the plain indexing by construction.
#include "common.cuh"

namespace {

constexpr int TILE = 8 * GOSSIP_LANES;  // outputs per plan tile

// _gather_resident — replaces gossipprotocol_tpu/ops/pallasdelivery.py:115
// (the resident-source pallas_call).
//
// The TPU kernel pinned the whole source in VMEM; here the source (at most
// 8192 rows = 4 MB under the plan's resident threshold) stays in the 50 MB
// L2 after its first touch. One thread per four outputs: a 16-byte index
// load, four cached source loads, one 16-byte store.
//
// Bound on this card: bytes (index read + output write dominate; the
// source is read from DRAM about once). The design keeps every DRAM
// access 16-byte wide and coalesced; only the source loads scatter, and
// they hit L2: each is one random 4-byte read of a 32-byte L2 sector,
// which the bytes bound does not see (chip_smoke.py phase (b) measures
// that ceiling, `bound_l2`, over uniformly random indices; PERF.md row 10
// keeps the times of the other designs tried, none faster).
__global__ void gather_resident_kernel(const float* __restrict__ x,
                                       const int4* __restrict__ idx,
                                       float4* __restrict__ out,
                                       long long n4) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= n4) return;
  const int4 k = __ldg(idx + i);
  float4 v;
  v.x = __ldg(x + k.x);
  v.y = __ldg(x + k.y);
  v.z = __ldg(x + k.z);
  v.w = __ldg(x + k.w);
  out[i] = v;
}

// _gather_bucket — replaces gossipprotocol_tpu/ops/pallasdelivery.py:153
// (the bucketed DMA-staging pallas_call; the function at :129).
//
// Per destination tile t of 1024 outputs, the plan lists the sorted
// distinct source rows rows[t, :R] and slab-local indices lidx (row
// position * 128 + lane). The TPU kernel DMA'd all R rows into one
// [R, 128] VMEM slab. This card needs no slab: the gathered source (2n
// floats and a zero tail, about 8 MB at 1M nodes) stays in the 50 MB L2,
// and staging whole 512-byte rows for the few lanes a tile reads from
// each moved ~R * 512 B through shared memory per 4 KB of output. So a
// block stages only the tile's row table, and each output is one L2 read:
//   - 256 threads, four outputs each: one 16-byte load of lidx; the
//     block's max row position gives need = max(lidx >> 7) + 1 <= r_cap
//     <= 1024 (a tile has at most 1024 distinct rows);
//   - rows[t, :need] (at most 4 KB) lands in shared memory by cp.async,
//     16 bytes a thread;
//   - out = x[rows_s[li >> 7] * 128 + (li & 127)] through the read-only
//     path (__ldg), one 16-byte store.
// Where the call's stream of lidx, rows and output outgrows half the L2
// (HINTS, set by the wrapper from the card's L2 size: ~240 MB at 1M
// nodes' gather_pre), it is read and written evict-first (__ldcs, an
// L2::evict_first cp.async policy, __stcs), so it does not push the source
// out of L2; a smaller stream keeps the default policy, and its output
// stays in L2 for the kernel that reads it next.
//
// One block per tile. (A persistent grid walking the tiles with the next
// tile's table in flight measured 3.9 % slower on gather_pre; PERF.md.)
//
// Bound on this card: bytes — lidx in, the table entries the tile reads,
// the output out; the source is read from device memory about once and
// then from L2. What it costs beyond that: one random 4-byte L2 read per
// output (a 32-byte sector each).
constexpr int BUCKET_THREADS = TILE / 4;
constexpr int BUCKET_WARPS = BUCKET_THREADS / 32;

__device__ __forceinline__ unsigned long long l2_evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// rows[:n] (n int32, the table row 16-byte aligned) into shared memory,
// one 16-byte cp.async per thread, then waits for the block's copies
template <bool HINTS>
__device__ __forceinline__ void stage_rows(int* dst, const int* src,
                                           int n) {
  if (static_cast<int>(threadIdx.x) * 4 < n) {
    const unsigned s = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + threadIdx.x * 4));
    if (HINTS) {
      asm volatile(
          "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
          :: "r"(s), "l"(src + threadIdx.x * 4),
             "l"(l2_evict_first_policy()) : "memory");
    } else {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(s), "l"(src + threadIdx.x * 4) : "memory");
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// the tile's distinct-row count from its lidx (block-wide max; one
// barrier)
__device__ __forceinline__ int tile_need(int4 li, int* s_max, int r_cap) {
  int m = max(max(li.x, li.y), max(li.z, li.w)) >> 7;
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = m;
  __syncthreads();
  int need = s_max[0];
#pragma unroll
  for (int w = 1; w < BUCKET_WARPS; ++w) need = max(need, s_max[w]);
  return min(need + 1, r_cap);
}

template <bool HINTS>
__global__ void __launch_bounds__(BUCKET_THREADS)
gather_bucket_kernel(const float* __restrict__ x,
                     const int* __restrict__ rows,
                     const int4* __restrict__ lidx,
                     float4* __restrict__ out, int r_cap) {
  __shared__ __align__(16) int s_rows[TILE];
  __shared__ int s_max[BUCKET_WARPS];
  const long long t = blockIdx.x;
  const long long i = t * BUCKET_THREADS + threadIdx.x;
  const int4 li = HINTS ? __ldcs(lidx + i) : __ldg(lidx + i);
  stage_rows<HINTS>(s_rows, rows + t * r_cap, tile_need(li, s_max, r_cap));
  float4 v;
  v.x = __ldg(x + static_cast<long long>(s_rows[li.x >> 7]) * GOSSIP_LANES
              + (li.x & 127));
  v.y = __ldg(x + static_cast<long long>(s_rows[li.y >> 7]) * GOSSIP_LANES
              + (li.y & 127));
  v.z = __ldg(x + static_cast<long long>(s_rows[li.z >> 7]) * GOSSIP_LANES
              + (li.z & 127));
  v.w = __ldg(x + static_cast<long long>(s_rows[li.w >> 7]) * GOSSIP_LANES
              + (li.w & 127));
  if (HINTS) {
    __stcs(out + i, v);
  } else {
    out[i] = v;
  }
}

constexpr int RESIDENT_THREADS = 256;

}  // namespace

GOSSIP_EXPORT const char* gossip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

GOSSIP_EXPORT int gossip_gather_resident(const float* x, const int* idx,
                                         float* out, long long n,
                                         void* stream) {
  // n: output count, a whole number of 1024-value tiles
  const long long n4 = n / 4;
  if (n4 == 0) return 0;
  gather_resident_kernel<<<gossip_blocks(n4, RESIDENT_THREADS),
                           RESIDENT_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<const int4*>(idx), reinterpret_cast<float4*>(out),
      n4);
  return static_cast<int>(cudaGetLastError());
}

// hints: evict-first loads and stores of the stream (0 or 1)
GOSSIP_EXPORT int gossip_gather_bucket(const float* x, const int* rows,
                                       const int* lidx, float* out,
                                       long long tiles, int r_cap,
                                       int hints, void* stream) {
  if (tiles == 0) return 0;
  if (r_cap < 1 || r_cap > TILE || r_cap % 4 || tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int g = static_cast<unsigned int>(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* li = reinterpret_cast<const int4*>(lidx);
  float4* o = reinterpret_cast<float4*>(out);
  if (hints) {
    gather_bucket_kernel<true><<<g, BUCKET_THREADS, 0, s>>>(
        x, rows, li, o, r_cap);
  } else {
    gather_bucket_kernel<false><<<g, BUCKET_THREADS, 0, s>>>(
        x, rows, li, o, r_cap);
  }
  return static_cast<int>(cudaGetLastError());
}
