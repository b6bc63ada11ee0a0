// Clos routing passes of the routed delivery (`--delivery routed`), for
// Hopper (sm_90a).
//
// A routing plan (gossipprotocol_tpu_torch/ops/plan.py) moves f32 values
// through radix stages and one final K-merge; every pass applies, per
// [128,128] tile, the 3-stage Clos route the TPU kernel spelled as three
// lane gathers and two transposes:
//     a = G(x, i1);  b = G(a^T, i2);  y = G(b^T, i3).
// Composed, that is one gather per output element: with m = i3[r][c] and
// j = i2[m][r],  y[r][c] = x[j][ i1[j][m] ].  These kernels read the
// route that way and never materialise a or b.
//
// Index planes arrive in the JAX package's device format (the plan cache
// shares its files): unit-2 planes pair-halved and transposed, [3][64][128]
// int8, decoding as
//     i1[r][c] = S0[c>>1][r] + (c&1),  i2[j][r] = S1[j>>1][r],
//     i3[r][c] = S2[c>>1][r] + (c&1);
// unit-1 planes [3][128][128] holding i1, i2, i3 directly. Values are
// 0..127 (the widened 126 + 1 included), read as signed bytes.
//
// Only values move, no arithmetic: each kernel equals its plain PyTorch
// version (ops/exec.py) bitwise, NaN payloads and signed zeros included.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int ROUTE_THREADS = 512;
constexpr int TILE_F32 = GOSSIP_LANES * GOSSIP_LANES;
constexpr int PER_THREAD = TILE_F32 / ROUTE_THREADS;  // 32 outputs each
constexpr int TILE_BYTES = TILE_F32 * 4;
// S2 is stored [q][r]; the output loop reads it with lanes along c, so it
// is staged transposed, T2[r][q], at an odd byte pitch that spreads the
// transposing byte stores over the banks.
constexpr int T2_PITCH = 65;
constexpr int MT_PITCH = 17;  // the final masks, staged transposed alike
constexpr int MASK_BYTES = 16 * GOSSIP_LANES;

template <int UNIT>
__host__ __device__ constexpr int plane_width() {
  return UNIT == 2 ? 64 : GOSSIP_LANES;
}

// stored bytes of one tile's three planes
template <int UNIT>
__host__ __device__ constexpr long long plane_bytes() {
  return 3LL * plane_width<UNIT>() * GOSSIP_LANES;
}

// shared-memory bytes of one tile's planes as staged
template <int UNIT>
__host__ __device__ constexpr int plane_smem() {
  return UNIT == 2 ? 2 * 64 * GOSSIP_LANES + GOSSIP_LANES * T2_PITCH
                   : 3 * GOSSIP_LANES * GOSSIP_LANES;
}

__device__ __forceinline__ void load_tile(float* xs, const float* x) {
  const float4* src = reinterpret_cast<const float4*>(x);
  float4* dst = reinterpret_cast<float4*>(xs);
  for (int k = threadIdx.x; k < TILE_F32 / 4; k += ROUTE_THREADS) {
    dst[k] = __ldg(src + k);
  }
}

// bytes [q][r] (16-row-aligned source, rows of 128) -> dst[r*pitch + q]
__device__ __forceinline__ void load_transposed(int8_t* dst, int pitch,
                                                const int8_t* src,
                                                int rows) {
  const char4* s4 = reinterpret_cast<const char4*>(src);
  for (int k = threadIdx.x; k < rows * GOSSIP_LANES / 4;
       k += ROUTE_THREADS) {
    const char4 v = __ldg(s4 + k);
    const int q = k >> 5;
    const int r0 = (k & 31) * 4;
    dst[(r0 + 0) * pitch + q] = v.x;
    dst[(r0 + 1) * pitch + q] = v.y;
    dst[(r0 + 2) * pitch + q] = v.z;
    dst[(r0 + 3) * pitch + q] = v.w;
  }
}

template <int UNIT>
__device__ __forceinline__ void load_planes(int8_t* sp, const int8_t* g) {
  // planes stored contiguously: unit 2 copies S0 and S1 as they are and
  // transposes S2; unit 1 copies all three
  constexpr int direct = UNIT == 2 ? 2 * 64 * GOSSIP_LANES
                                   : 3 * GOSSIP_LANES * GOSSIP_LANES;
  const int4* src = reinterpret_cast<const int4*>(g);
  int4* dst = reinterpret_cast<int4*>(sp);
  for (int k = threadIdx.x; k < direct / 16; k += ROUTE_THREADS) {
    dst[k] = __ldg(src + k);
  }
  if (UNIT == 2) {
    load_transposed(sp + direct, T2_PITCH, g + direct, 64);
  }
}

// one output element of the route of the staged tile
template <int UNIT>
__device__ __forceinline__ float route_elem(const float* xs,
                                            const int8_t* sp, int r,
                                            int c) {
  int j, col;
  if (UNIT == 2) {
    const int8_t* s0 = sp;
    const int8_t* s1 = sp + 64 * GOSSIP_LANES;
    const int8_t* t2 = sp + 2 * 64 * GOSSIP_LANES;
    const int m = t2[r * T2_PITCH + (c >> 1)] + (c & 1);
    j = s1[((m >> 1) << 7) + r];
    col = s0[((m >> 1) << 7) + j] + (m & 1);
  } else {
    const int8_t* i1 = sp;
    const int8_t* i2 = sp + TILE_F32;
    const int8_t* i3 = sp + 2 * TILE_F32;
    const int m = i3[(r << 7) + c];
    j = i2[(m << 7) + r];
    col = i1[(j << 7) + m];
  }
  return xs[(j << 7) + col];
}

// _stage_call — replaces gossipprotocol_tpu/ops/exec.py:154 (the stage's
// pallas_call).
//
// Input: f32 [p*tau_in][128][128] tiles, int8 planes [p*tau_in][o][3][..];
// output: the staging slab f32 [p][b][tau_slab][cr][128]. Tile t = p*tau_in
// + i routes through o Clos permutations; their 128-row results,
// concatenated and cut to b*cr rows, land as
// staging[p][bucket][i][0:cr] = rows[bucket*cr : (bucket+1)*cr]. Rows
// i >= tau_in of the slab are never written (no final mask reads them).
//
// One block per (tile, o): it stages the 64 KB tile and the o-th planes
// (24 KB at unit 2, 48 KB at unit 1; stored transposed, so read straight
// from global memory with lanes along c they would not coalesce) in
// shared memory, then each thread produces outputs with the lanes along
// c, so every warp writes 128 contiguous bytes of a slab row.
//
// Bound on this card: bytes (tiles and planes read once, slab rows
// written once; no arithmetic). Three dependent shared-memory byte reads
// and one f32 read per element; TMA and a deeper pipeline wait for a
// later change.
template <int UNIT>
__global__ void __launch_bounds__(ROUTE_THREADS)
route_stage_kernel(const float* __restrict__ x,
                   const int8_t* __restrict__ idx, float* __restrict__ out,
                   int o_count, int b, int cr, int tau_in, int tau_slab) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  int8_t* sp = reinterpret_cast<int8_t*>(smem + TILE_BYTES);
  const long long blk = blockIdx.x;
  const long long t = blk / o_count;
  const int oi = static_cast<int>(blk - t * o_count);
  load_tile(xs, x + t * TILE_F32);
  load_planes<UNIT>(sp, idx + blk * plane_bytes<UNIT>());
  __syncthreads();
  const int row0 = oi * GOSSIP_LANES;
  const int nrows = min(GOSSIP_LANES, b * cr - row0);
  const long long p = t / tau_in;
  const long long i = t - p * tau_in;
  for (int e = threadIdx.x; e < nrows * GOSSIP_LANES; e += ROUTE_THREADS) {
    const int r = e >> 7;
    const int c = e & 127;
    const int big_r = row0 + r;
    const int bucket = big_r / cr;
    const int rr = big_r - bucket * cr;
    const long long dst =
        ((((p * b + bucket) * tau_slab + i) * cr + rr) << 7) + c;
    out[dst] = route_elem<UNIT>(xs, sp, r, c);
  }
}

// _final_call — replaces gossipprotocol_tpu/ops/exec.py:193 (the final
// pass's pallas_call).
//
// Input: f32 [nt_out*k][128][128] (output tile f's region is its k stacked
// staging tiles), int8 planes [nt_out][k][3][..], uint8 masks
// [nt_out][k][16][128] (bit c&7 of byte [c>>3][r] selects slot (r, c));
// output f32 [nt_out][128][128]. For kk = 0..k-1 in ascending order,
// acc = where(bit, route(region[kk]), acc) from +0.0: the last kk whose
// bit is set wins, a slot with no set bit reads +0.0.
//
// One block per output tile; each thread keeps its 32 accumulators in
// registers across the k merges and routes only the slots whose bit is
// set. Bound on this card: bytes.
template <int UNIT>
__global__ void __launch_bounds__(ROUTE_THREADS)
route_final_kernel(const float* __restrict__ x,
                   const int8_t* __restrict__ idx,
                   const int8_t* __restrict__ mask, float* __restrict__ out,
                   int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  int8_t* sp = reinterpret_cast<int8_t*>(smem + TILE_BYTES);
  const uint8_t* mt =
      reinterpret_cast<const uint8_t*>(sp + plane_smem<UNIT>());
  const long long f = blockIdx.x;
  float acc[PER_THREAD];
#pragma unroll
  for (int ii = 0; ii < PER_THREAD; ++ii) acc[ii] = 0.0f;
  for (int kk = 0; kk < k; ++kk) {
    const long long src = f * k + kk;
    if (kk) __syncthreads();  // the previous merge is done with smem
    load_tile(xs, x + src * TILE_F32);
    load_planes<UNIT>(sp, idx + src * plane_bytes<UNIT>());
    load_transposed(sp + plane_smem<UNIT>(), MT_PITCH,
                    mask + src * MASK_BYTES, 16);
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < PER_THREAD; ++ii) {
      const int e = ii * ROUTE_THREADS + threadIdx.x;
      const int r = e >> 7;
      const int c = e & 127;
      if ((mt[r * MT_PITCH + (c >> 3)] >> (c & 7)) & 1) {
        acc[ii] = route_elem<UNIT>(xs, sp, r, c);
      }
    }
  }
  float* o = out + f * TILE_F32;
#pragma unroll
  for (int ii = 0; ii < PER_THREAD; ++ii) {
    o[ii * ROUTE_THREADS + threadIdx.x] = acc[ii];
  }
}

template <int UNIT>
cudaError_t launch_stage(const float* x, const int8_t* idx, float* out,
                         long long tiles, int o, int b, int cr, int tau_in,
                         int tau_slab, cudaStream_t stream) {
  constexpr int smem = TILE_BYTES + plane_smem<UNIT>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        route_stage_kernel<UNIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  route_stage_kernel<UNIT><<<static_cast<unsigned int>(tiles * o),
                             ROUTE_THREADS, smem, stream>>>(
      x, idx, out, o, b, cr, tau_in, tau_slab);
  return cudaGetLastError();
}

template <int UNIT>
cudaError_t launch_final(const float* x, const int8_t* idx,
                         const int8_t* mask, float* out, long long nt_out,
                         int k, cudaStream_t stream) {
  constexpr int smem = TILE_BYTES + plane_smem<UNIT>() + GOSSIP_LANES * MT_PITCH;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        route_final_kernel<UNIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  route_final_kernel<UNIT><<<static_cast<unsigned int>(nt_out),
                             ROUTE_THREADS, smem, stream>>>(
      x, idx, mask, out, k);
  return cudaGetLastError();
}

}  // namespace

GOSSIP_EXPORT const char* gossip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

GOSSIP_EXPORT int gossip_route_stage(const float* x, const int8_t* idx,
                                     float* out, long long tiles, int o,
                                     int b, int cr, int tau_in,
                                     int tau_slab, int unit, void* stream) {
  if (tiles == 0) return 0;
  if (o < 1 || b < 1 || cr < 1 || tau_in < 1 || tau_slab < tau_in ||
      static_cast<long long>(o) * GOSSIP_LANES < static_cast<long long>(b) * cr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 1: return launch_stage<1>(x, idx, out, tiles, o, b, cr, tau_in,
                                   tau_slab, s);
    case 2: return launch_stage<2>(x, idx, out, tiles, o, b, cr, tau_in,
                                   tau_slab, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

GOSSIP_EXPORT int gossip_route_final(const float* x, const int8_t* idx,
                                     const int8_t* mask, float* out,
                                     long long nt_out, int k, int unit,
                                     void* stream) {
  if (nt_out == 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 1: return launch_final<1>(x, idx, mask, out, nt_out, k, s);
    case 2: return launch_final<2>(x, idx, mask, out, nt_out, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
