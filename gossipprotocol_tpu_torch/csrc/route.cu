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

// bytes [q][r] (16-row-aligned source, rows of 128) -> dst[r*pitch + q],
// by THREADS threads, from global memory (read-only path) or from shared
template <int THREADS = ROUTE_THREADS, bool GLOBAL = true>
__device__ __forceinline__ void load_transposed(int8_t* dst, int pitch,
                                                const int8_t* src,
                                                int rows) {
  const char4* s4 = reinterpret_cast<const char4*>(src);
  for (int k = threadIdx.x; k < rows * GOSSIP_LANES / 4; k += THREADS) {
    const char4 v = GLOBAL ? __ldg(s4 + k) : s4[k];
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
// Bound on this card: bytes (the k staging tiles, their planes and masks
// read once, the output tile written once; no arithmetic).
//
// What held the first kernel (one block per tile, staging each 64 KB
// tile and its planes, then routing) back: a block's loads never
// overlapped its route, two blocks per SM, five waves with a quarter-full
// last one; and the route read i2 as S1[m>>1][r] with the lanes of a
// warp along c, so r is fixed and m random: the lanes hit one bank at a
// 128-byte stride, a replay per distinct m>>1. This kernel stages every
// plane that is read at a fixed r r-major (S1 transposed as S2 and the
// masks already were), so the route's byte reads are conflict-light.
// (The stage kernel keeps the old layout: it is not redesigned here.)
//
// Staged plane layout (FinalPlanes): unit 2: a = S0 [64][128] as stored,
// b = S1T [128][65] (S1T[r][h] = S1[h][r]), c = T2 [128][65]; unit 1:
// a = i1 [128][128] as stored, b = i2T [128][129], c = i3 as stored.
constexpr int I2T_PITCH = 129;

struct FinalPlanes {
  const int8_t* a;
  const int8_t* b;
  const int8_t* c;
};

// bytes of the transposed planes b (and c at unit 2) as staged
template <int UNIT>
__host__ __device__ constexpr int final_t_bytes() {
  return UNIT == 2 ? 2 * GOSSIP_LANES * T2_PITCH
                   : GOSSIP_LANES * I2T_PITCH;
}

// the source slot j*128 + col of output slot (r, c) of one route
template <int UNIT>
__device__ __forceinline__ int final_src(const FinalPlanes& p, int r,
                                         int c) {
  if (UNIT == 2) {
    const int m = p.c[r * T2_PITCH + (c >> 1)] + (c & 1);
    const int j = p.b[r * T2_PITCH + (m >> 1)];
    return (j << 7) + p.a[((m >> 1) << 7) + j] + (m & 1);
  } else {
    const int m = p.c[(r << 7) + c];
    const int j = p.b[r * I2T_PITCH + m];
    return (j << 7) + p.a[(j << 7) + m];
  }
}

// the transposed planes of planes g staged as stored: S1, S2 (unit 2) or
// i2 (unit 1) into tb (and tc = tb + 128*65 at unit 2)
template <int UNIT, int THREADS>
__device__ __forceinline__ void transpose_final_planes(int8_t* tb,
                                                       const int8_t* g) {
  if (UNIT == 2) {
    load_transposed<THREADS, false>(tb, T2_PITCH, g + 64 * GOSSIP_LANES, 64);
    load_transposed<THREADS, false>(tb + GOSSIP_LANES * T2_PITCH, T2_PITCH,
                                    g + 2 * 64 * GOSSIP_LANES, 64);
  } else {
    load_transposed<THREADS, false>(tb, I2T_PITCH, g + TILE_F32,
                                    GOSSIP_LANES);
  }
}

__device__ __forceinline__ bool final_bit(const uint8_t* mt, int r, int c) {
  return (mt[r * MT_PITCH + (c >> 3)] >> (c & 7)) & 1;
}

// The kernel: a persistent grid (one block of PIPE_THREADS per SM) walks
// its output tiles f = blockIdx.x, + gridDim.x, ..., each as k steps
// (f, kk). Each step's staging tile, planes and masks (92 KB at unit 2,
// contiguous in global memory: three 1-D bulk copies, TMA, with mbarrier
// completion) land in a ring of pipe_stages<UNIT>() stages, issued by one
// thread a step ahead, so step n + 1 lands while step n routes from
// shared memory. Per step: wait for the stage, transpose S1, S2 (or i2) and the
// masks into one r-major area, route the selected slots into register
// accumulators, write the tile after its last kk, and refill the stage
// with step n + S. Unit 1's stage (114 KB) fits the ring only once, so
// there it loads and routes in turn.
constexpr int PIPE_THREADS = 1024;
constexpr int PIPE_PER_THREAD = TILE_F32 / PIPE_THREADS;  // 16 outputs

template <int UNIT>
__host__ __device__ constexpr int pipe_stages() {
  return UNIT == 2 ? 2 : 1;
}

template <int UNIT>
__host__ __device__ constexpr int pipe_stage_bytes() {
  return TILE_BYTES + static_cast<int>(plane_bytes<UNIT>()) + MASK_BYTES;
}

// [stages | transposed planes | MT | mbarriers]
template <int UNIT>
__host__ __device__ constexpr int pipe_bar_offset() {
  return (pipe_stages<UNIT>() * pipe_stage_bytes<UNIT>()
          + final_t_bytes<UNIT>() + GOSSIP_LANES * MT_PITCH + 15) / 16 * 16;
}

template <int UNIT>
__host__ __device__ constexpr int pipe_smem() {
  return pipe_bar_offset<UNIT>() + 8 * pipe_stages<UNIT>();
}

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// one thread: expect `bytes` on bar and copy them in (16-byte aligned,
// sizes multiples of 16)
__device__ __forceinline__ void mbar_expect(uint64_t* bar,
                                            unsigned int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wait for the phase of bar with this parity to complete; a copy that
// never lands traps (a launch error) after ~10 s instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                          unsigned int parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned int ok;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (ok) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

template <int UNIT>
__device__ __forceinline__ void pipe_issue(unsigned char* st, uint64_t* bar,
                                           const float* x,
                                           const int8_t* idx,
                                           const int8_t* mask,
                                           long long src) {
  constexpr unsigned int pb = static_cast<unsigned int>(plane_bytes<UNIT>());
  mbar_expect(bar, pipe_stage_bytes<UNIT>());
  bulk_load(st, x + src * TILE_F32, TILE_BYTES, bar);
  bulk_load(st + TILE_BYTES, idx + src * plane_bytes<UNIT>(), pb, bar);
  bulk_load(st + TILE_BYTES + pb, mask + src * MASK_BYTES, MASK_BYTES, bar);
}

template <int UNIT>
__global__ void __launch_bounds__(PIPE_THREADS, 1)
route_final_pipe_kernel(const float* __restrict__ x,
                        const int8_t* __restrict__ idx,
                        const int8_t* __restrict__ mask,
                        float* __restrict__ out, long long nt_out, int k) {
  constexpr int S = pipe_stages<UNIT>();
  constexpr int SB = pipe_stage_bytes<UNIT>();
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* tb = reinterpret_cast<int8_t*>(smem + S * SB);
  int8_t* mt = tb + final_t_bytes<UNIT>();
  const uint8_t* bits = reinterpret_cast<const uint8_t*>(mt);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + pipe_bar_offset<UNIT>());
  const long long grid = gridDim.x;
  const long long nsteps = ((nt_out - 1 - blockIdx.x) / grid + 1) * k;
  // step n: output tile blockIdx.x + (n / k) * grid, merge kk = n % k
  auto src_of = [&](long long n) {
    return (blockIdx.x + (n / k) * grid) * k + n % k;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long n = 0; n < S && n < nsteps; ++n) {
      pipe_issue<UNIT>(smem + n * SB, bar + n, x, idx, mask, src_of(n));
    }
  }
  __syncthreads();
  float acc[PIPE_PER_THREAD];
  for (long long n = 0; n < nsteps; ++n) {
    const int s = static_cast<int>(n % S);
    unsigned char* st = smem + s * SB;
    const int8_t* planes = reinterpret_cast<const int8_t*>(st + TILE_BYTES);
    const int kk = static_cast<int>(n % k);
    mbar_wait(bar + s, static_cast<unsigned int>((n / S) & 1));
    transpose_final_planes<UNIT, PIPE_THREADS>(tb, planes);
    load_transposed<PIPE_THREADS, false>(mt, MT_PITCH,
                                         planes + plane_bytes<UNIT>(), 16);
    __syncthreads();
    const FinalPlanes p{planes, tb,
                        UNIT == 2 ? tb + GOSSIP_LANES * T2_PITCH
                                  : planes + 2 * TILE_F32};
    const float* xs = reinterpret_cast<const float*>(st);
    if (kk == 0) {
#pragma unroll
      for (int ii = 0; ii < PIPE_PER_THREAD; ++ii) acc[ii] = 0.0f;
    }
#pragma unroll
    for (int ii = 0; ii < PIPE_PER_THREAD; ++ii) {
      const int e = ii * PIPE_THREADS + threadIdx.x;
      const int r = e >> 7;
      const int c = e & 127;
      if (final_bit(bits, r, c)) acc[ii] = xs[final_src<UNIT>(p, r, c)];
    }
    if (kk == k - 1) {
      float* o = out + (blockIdx.x + (n / k) * grid) * TILE_F32;
#pragma unroll
      for (int ii = 0; ii < PIPE_PER_THREAD; ++ii) {
        o[ii * PIPE_THREADS + threadIdx.x] = acc[ii];
      }
    }
    __syncthreads();  // the stage and the transposed area are free
    if (threadIdx.x == 0 && n + S < nsteps) {
      pipe_issue<UNIT>(st, bar + s, x, idx, mask, src_of(n + S));
    }
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

// the final pass: a grid of min(nt_out, SMs) blocks, the SM count and
// the shared-memory attribute read once per device
constexpr int MAX_DEVICES = 64;

template <int UNIT>
cudaError_t launch_final(const float* x, const int8_t* idx,
                         const int8_t* mask, float* out, long long nt_out,
                         int k, int device, cudaStream_t stream) {
  static int sms[MAX_DEVICES] = {};  // 0: not yet configured
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!sms[device]) {
    int n = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &n, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(route_final_pipe_kernel<UNIT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               pipe_smem<UNIT>());
    }
    if (e != cudaSuccess) return e;
    sms[device] = n;
  }
  const long long grid = nt_out < sms[device] ? nt_out : sms[device];
  route_final_pipe_kernel<UNIT><<<static_cast<unsigned int>(grid),
                                  PIPE_THREADS, pipe_smem<UNIT>(),
                                  stream>>>(x, idx, mask, out, nt_out, k);
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

// device: the CUDA device of the tensors and of stream
GOSSIP_EXPORT int gossip_route_final(const float* x, const int8_t* idx,
                                     const int8_t* mask, float* out,
                                     long long nt_out, int k, int unit,
                                     int device, void* stream) {
  if (nt_out == 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 1: return launch_final<1>(x, idx, mask, out, nt_out, k, device, s);
    case 2: return launch_final<2>(x, idx, mask, out, nt_out, k, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
