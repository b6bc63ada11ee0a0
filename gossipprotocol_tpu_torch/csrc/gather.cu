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
// they hit L2.
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
// (the bucketed DMA-staging pallas_call).
//
// Per destination tile t of 1024 outputs, the plan lists the sorted
// distinct source rows rows[t, :R] and slab-local indices lidx (row
// position * 128 + lane). The TPU kernel DMA'd all R rows into one
// [R, 128] VMEM slab; R reaches ~1016 rows (508 KB) at 1M nodes, past
// the 227 KB of shared memory a Hopper block can hold. So one block per
// tile stages the rows in chunks of BUCKET_CHUNK rows (32 KB of shared
// memory) with coalesced 16-byte loads, and after each chunk every output
// whose row position falls in that chunk takes its value from the slab.
// Each output is written exactly once, after the last chunk. Rows past
// the tile's own distinct count (table padding) are never staged: the
// block first takes the max row position over its lidx.
//
// Bound on this card: bytes. What it costs beyond the bound: every staged
// row is 512 B for the few lanes the tile reads from it, so a tile moves
// about R * 512 B from L2 for 4 KB of output. Recorded in PERF.md.
constexpr int BUCKET_THREADS = 256;
constexpr int BUCKET_CHUNK = 64;
constexpr int PER_THREAD = TILE / BUCKET_THREADS;
constexpr int ROW_VEC = GOSSIP_LANES / 4;  // float4 per source row

__global__ void __launch_bounds__(BUCKET_THREADS)
gather_bucket_kernel(const float* __restrict__ x,
                     const int* __restrict__ rows,
                     const int* __restrict__ lidx,
                     float* __restrict__ out, int r_cap) {
  __shared__ float4 slab[BUCKET_CHUNK * ROW_VEC];
  __shared__ int need;
  const long long t = blockIdx.x;
  const int* lt = lidx + t * TILE;
  int li[PER_THREAD];
  float v[PER_THREAD];
  int mx = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    li[k] = __ldg(lt + threadIdx.x + k * BUCKET_THREADS);
    v[k] = 0.f;
    mx = max(mx, li[k] >> 7);
  }
  if (threadIdx.x == 0) need = 0;
  __syncthreads();
  mx = __reduce_max_sync(0xffffffffu, mx);
  if ((threadIdx.x & 31) == 0) atomicMax(&need, mx + 1);
  __syncthreads();
  const int n_rows = min(need, r_cap);
  const int* rt = rows + t * r_cap;
  const float* sf = reinterpret_cast<const float*>(slab);
  for (int k0 = 0; k0 < n_rows; k0 += BUCKET_CHUNK) {
    const int nr = min(BUCKET_CHUNK, n_rows - k0);
    for (int e = threadIdx.x; e < nr * ROW_VEC; e += BUCKET_THREADS) {
      const long long src_row = __ldg(rt + k0 + e / ROW_VEC);
      slab[e] = __ldg(reinterpret_cast<const float4*>(
                          x + src_row * GOSSIP_LANES) + e % ROW_VEC);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int pos = (li[k] >> 7) - k0;
      if (pos >= 0 && pos < nr) v[k] = sf[pos * GOSSIP_LANES + (li[k] & 127)];
    }
    __syncthreads();
  }
  float* ot = out + t * TILE;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) ot[threadIdx.x + k * BUCKET_THREADS] = v[k];
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

GOSSIP_EXPORT int gossip_gather_bucket(const float* x, const int* rows,
                                       const int* lidx, float* out,
                                       long long tiles, int r_cap,
                                       void* stream) {
  if (tiles == 0) return 0;
  gather_bucket_kernel<<<static_cast<unsigned int>(tiles), BUCKET_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, rows, lidx, out, r_cap);
  return static_cast<int>(cudaGetLastError());
}
