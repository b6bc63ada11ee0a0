// Kernels of the three measurement probes, for Hopper (sm_90a).
//
// Each replaces pallas_calls of the JAX package's probe scripts
// (experiments/slab_probe.py, route_probe.py, tile_perm_probe.py): exact
// x2 scalings, a strided slab write and gathers. Nothing is summed, so
// each is bitwise equal to its plain PyTorch version
// (gossipprotocol_tpu_torch/ops/probes.py). Bound on this card: bytes;
// every kernel keeps its device-memory traffic in coalesced 16-byte
// accesses, and only gathered loads scatter (within a row, a small array
// or a tile held in shared memory).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROW4 = GOSSIP_LANES / 4;  // float4 per 128-lane row

__device__ __forceinline__ float4 twice(float4 v) {
  v.x *= 2.f;
  v.y *= 2.f;
  v.z *= 2.f;
  v.w *= 2.f;
  return v;
}

// slab_kernel and contig_kernel — replace experiments/slab_probe.py:73
// (strided slab write) and :94 (contiguous write).
//
// x [T, 128, 128]; output row (b, t, c) = 2 * x[t, b*CR + c] for the first
// B*CR rows of each tile, laid out bucket-major [B, T, CR, 128]
// (BUCKET_MAJOR) or tile-major [T, B, CR, 128]. The TPU kernel wrote, per
// tile, B strided runs of CR rows; here one thread per float4 of output,
// in output order, so the writes are coalesced and each warp reads one
// contiguous 512-byte source row. The strided layout costs the reads,
// not the writes.
template <bool BUCKET_MAJOR>
__global__ void slab_kernel(const float4* __restrict__ x,
                            float4* __restrict__ out, int tiles, int buckets,
                            int cr, long long n4) {
  const long long o = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (o >= n4) return;
  const int l4 = static_cast<int>(o % ROW4);
  long long row = o / ROW4;
  const int c = static_cast<int>(row % cr);
  row /= cr;
  long long t, b;
  if (BUCKET_MAJOR) {
    t = row % tiles;
    b = row / tiles;
  } else {
    b = row % buckets;
    t = row / buckets;
  }
  const long long src = (t * GOSSIP_LANES + b * cr + c) * ROW4 + l4;
  out[o] = twice(__ldg(x + src));
}

// copy_kernel — replaces experiments/route_probe.py:158 (one VMEM-resident
// block of 2-16 MB) and :240 (the grid stream copy, 1,024-row blocks).
//
// y = 2 * x as one flat walk of n4 float4, one float4 a thread a step. The
// TPU's tile was its VMEM block and means nothing here, so it does not
// shape the grid (the wrapper still validates it). The card has no
// block-resident counterpart of VMEM: a 2-16 MB array simply lives in the
// 50 MB L2 after its first touch, and 64 MiB does not, so the two calls
// give the L2-resident copy rate and the device-memory stream ceiling.
// The wrapper picks the geometry by size (ops/probes.py scale2_geometry):
// - resident (x and y fit in L2 together): a grid of at most one full wave
//   (eight 256-thread blocks an SM) walking the array grid-stride, plain
//   loads, so x stays in L2 for the next call;
// - streamed: one block per 256 float4 (no stride, no tail of long
//   blocks) and evict-first loads: x is not read again either.
// Stores are evict-first in both: y is not read again by the copy.
// (A persistent grid through a four-stage ring of TMA bulk copies, the
// grid-stride walk at 64 MiB, and 2-8 float4 a thread all ran slower on
// the H100: PERF.md §6 rows 15 and 19.)
template <bool STREAM>
__global__ void __launch_bounds__(THREADS)
scale2_kernel(const float4* __restrict__ x, float4* __restrict__ y,
              long long n4) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = blockIdx.x * static_cast<long long>(THREADS)
                     + threadIdx.x;
       i < n4; i += step) {
    __stcs(y + i, twice(STREAM ? __ldcs(x + i) : __ldg(x + i)));
  }
}

// g0 — replaces experiments/route_probe.py:180, take_along_axis on axis 0
// (the TPU's sublane gather): out[r, c] = x[idx[r, c], c] over [rows, 128].
// Bound on this card: random L2 reads, one 32-byte sector fetched for each
// 4-byte output, and the L1's misses in flight.
//
// A block owns a band of 16 columns (GATHER_BAND4 float4: 64 bytes of
// every row) and a chunk of output rows; the wrapper sizes the chunks so
// that the GATHER_BANDS x chunks blocks fill the SMs in one wave
// (ops/probes.py gather_rows_geometry). An SM's random reads then stay
// inside one band, a 256 KB strip of the source, instead of the whole 2 MB,
// so they touch fewer distinct sectors. A thread keeps two float4 of
// outputs (eight random loads) in flight. (Staging the band or a piece of the source in shared
// memory — by TMA boxes, multicast to a cluster, or plain loads — and
// narrower or wider bands all ran slower: PERF.md §6 row 16.)
constexpr int GATHER_THREADS = 512;
constexpr int GATHER_BAND4 = 4;                       // float4 of a band
constexpr int GATHER_BANDS = ROW4 / GATHER_BAND4;     // 8
constexpr int GATHER_UNROLL = 2;

__global__ void __launch_bounds__(GATHER_THREADS)
gather_rows_kernel(const float* __restrict__ x, const int4* __restrict__ idx,
                   float4* __restrict__ out, int rows, int chunk_rows) {
  const int band4 = (blockIdx.x % GATHER_BANDS) * GATHER_BAND4;
  const int r0 = (blockIdx.x / GATHER_BANDS) * chunk_rows;
  const int n = (min(rows, r0 + chunk_rows) - r0) * GATHER_BAND4;
  for (int e0 = threadIdx.x; e0 < n;
       e0 += GATHER_UNROLL * GATHER_THREADS) {
    long long o[GATHER_UNROLL];
    int4 k[GATHER_UNROLL];
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; ++u) {
      const int e = e0 + u * GATHER_THREADS;
      o[u] = static_cast<long long>(r0 + e / GATHER_BAND4) * ROW4 + band4
             + e % GATHER_BAND4;
      if (e < n) k[u] = __ldg(idx + o[u]);
    }
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; ++u) {
      if (e0 + u * GATHER_THREADS < n) {
        const float* col = x + (o[u] % ROW4) * 4;
        float4 v;
        v.x = __ldg(col + static_cast<long long>(k[u].x) * GOSSIP_LANES);
        v.y = __ldg(col + static_cast<long long>(k[u].y) * GOSSIP_LANES + 1);
        v.z = __ldg(col + static_cast<long long>(k[u].z) * GOSSIP_LANES + 2);
        v.w = __ldg(col + static_cast<long long>(k[u].w) * GOSSIP_LANES + 3);
        out[o[u]] = v;
      }
    }
  }
}

// g1 and grid_call — replace experiments/route_probe.py:202 (the lane
// gather on axis 1 of [128, cols]) and :216 (the same per tile of
// [T, 4096, 128]): out[..., r, c] = x[..., r, idx[..., r, c]] over rows of
// `cols` lanes. Bound on this card: bytes (x, idx and out each crossed
// once); at the probe's small shapes, the launch and the memory round
// trips before the first store.
//
// A block owns whole rows, `rows_per_block` of them, with the thread
// count picked on the host (ops/probes.py gather_lanes_geometry):
// - a row longer than a warp's 32 float4 (512 lanes, 4,096) is staged:
//   the block loads its rows with coalesced 16-byte loads issued together
//   with its coalesced int4 index loads, so one memory round trip serves
//   both, stores them to shared memory, and gathers there. Each row thus
//   crosses from L2 once (the old one-thread-per-float4 grid spread a
//   16 KB row over four SMs, each pulling it through its own L1 by random
//   4-byte reads, and made every output wait on two dependent trips).
//   Random lanes conflict about 3.3-3.5 ways a warp request in shared
//   memory (probes/route_probe.py lane_gather_wavefronts replays them),
//   below the bytes' time at these sizes;
// - a row of at most 32 float4 (128 lanes: the tiled call) is one warp's
//   outputs, and the warp's random reads touch only its four 128-byte
//   lines, which L1 serves after the first miss: it is read in place
//   (STAGED false), groups of rows a block, and staging would only add a
//   barrier;
// - a row longer than a block's shared memory is read in place too, one
//   row a block.
// A thread holds UNROLL float4 in registers: one where a block has a
// thread for each float4, LANES_UNROLL of a long row. It carries the row
// of its float4 from step to step: no division per output. (Staging by
// cp.async or by one TMA bulk copy a block, a row's outputs split over two
// or four blocks, other rows and threads a block, and staging 128-lane
// rows all ran slower or no faster on the H100: PERF.md §6 rows 17, 18.)
constexpr int LANES_UNROLL = 4;
constexpr int MAX_DEVICES = 64;

template <typename Load>
__device__ __forceinline__ float4 pick_lanes(int4 k, Load at) {
  float4 v;
  v.x = at(k.x);
  v.y = at(k.y);
  v.z = at(k.z);
  v.w = at(k.w);
  return v;
}

template <int UNROLL, bool STAGED>
__global__ void gather_lanes_kernel(const float* __restrict__ x,
                                    const int4* __restrict__ idx,
                                    float4* __restrict__ out,
                                    long long rows, int cols,
                                    int rows_per_block) {
  extern __shared__ __align__(16) float xs[];
  const int c4 = cols / 4;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long base = r0 * c4;
  const int n = static_cast<int>(
      min(static_cast<long long>(rows_per_block), rows - r0)) * c4;
  const int4* ib = idx + base;
  const float4* xb = reinterpret_cast<const float4*>(x) + base;
  float4* xs4 = reinterpret_cast<float4*>(xs);
  float4* ob = out + base;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  // every load of the thread's first UNROLL float4 is issued before
  // anything waits on one
  int4 k[UNROLL];
  float4 v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (t + u * nt < n) {
      k[u] = __ldg(ib + t + u * nt);
      if (STAGED) v[u] = __ldg(xb + t + u * nt);
    }
  }
  if (STAGED) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t + u * nt < n) xs4[t + u * nt] = v[u];
    }
    for (int e = t + UNROLL * nt; e < n; e += nt) xs4[e] = __ldg(xb + e);
    __syncthreads();
  }
  const float* src = STAGED ? xs : x + r0 * cols;
  // the row of float4 e = t + u*nt, and its float4 within the row, carried
  // from step to step by the fixed increment nt
  int r = t / c4;
  int c = t - r * c4;
  const int dr = nt / c4;
  const int dc = nt - dr * c4;
  auto gather = [&](int4 kk) {
    const float* row = src + r * cols;
    const float4 g = pick_lanes(kk, [&](int j) {
      return STAGED ? row[j] : __ldg(row + j);
    });
    r += dr;
    c += dc;
    if (c >= c4) {
      c -= c4;
      ++r;
    }
    return g;
  };
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (t + u * nt < n) ob[t + u * nt] = gather(k[u]);
  }
  for (int e = t + UNROLL * nt; e < n; e += nt) ob[e] = gather(__ldg(ib + e));
}

// the instantiations: one float4 a thread or several, staged or in place
template <bool STAGED>
cudaError_t launch_lanes(const float* x, const int4* idx, float4* out,
                         long long rows, int cols, int rows_per_block,
                         int threads, long long blocks, size_t smem,
                         cudaStream_t s) {
  const auto grid = static_cast<unsigned int>(blocks);
  if (threads >= static_cast<long long>(rows_per_block) * (cols / 4))
    gather_lanes_kernel<1, STAGED><<<grid, threads, smem, s>>>(
        x, idx, out, rows, cols, rows_per_block);
  else
    gather_lanes_kernel<LANES_UNROLL, STAGED><<<grid, threads, smem, s>>>(
        x, idx, out, rows, cols, rows_per_block);
  return cudaGetLastError();
}

// the largest dynamic shared memory a block may opt into on `device`,
// opted into by both staged instantiations
cudaError_t opt_in_lanes(int device, int* most) {
  cudaError_t e = cudaDeviceGetAttribute(
      most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gather_lanes_kernel<1, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *most);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gather_lanes_kernel<LANES_UNROLL, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *most);
  }
  return e;
}

// kern — replaces experiments/tile_perm_probe.py:141, an arbitrary
// permutation of each [128, 128] f32 tile as lane gather (idx1),
// transpose, lane gather (idx2), transpose, lane gather (idx3).
//
// The three gathers and two transposes compose into one read per output,
// as csrc/route.cu composes the Clos stage: with k = idx3[r, c] and
// r2 = idx2[k, r], Y[r, c] = X[r2, idx1[r2, k]]. The tile (64 KB) and the
// idx1 and idx2 planes (16 KB each, int8) are staged in shared memory;
// idx3 is read and Y written in row order, coalesced 16-byte accesses.
// Indices are signed bytes whose values lie in 0..127. Bound on this
// card: bytes (11 a tile element).
//
// What limits it is shared memory. A warp's 32 lanes share the output row
// r and read idx2[k, r] at 32 distinct k: row-major, those bytes lie 128
// apart, 32 words of one bank, a 32-way conflict on every read. So idx2
// is staged transposed, s2T[r * 128 + k] = idx2[k, r]: the warp's bytes
// then lie in one 128-byte row, 32 banks, and the pick's three reads cost
// about 3,800 wavefronts a tile instead of about 19,700 (the replay in
// probes/tile_perm_probe.py pick_wavefronts). The transposing pass moves
// 4 x 4 byte blocks with a diagonal lane map, conflict-free both ways.
//
// One block of 512 threads per tile stages the tile and both planes with
// 16-byte loads (unrolled, so each thread has all 12 of its loads in
// flight before it stores any), transposes idx2, and picks. 112 KB of
// shared memory, two blocks an SM: one block's loads overlap the other's
// picks. (A persistent grid walking tiles through a two-stage ring of TMA
// bulk copies, and this kernel with its loads as bulk copies, both ran
// 1-3 % slower on the H100: PERF.md §6 row 20.)
constexpr int PERM_THREADS = 512;
constexpr int TILE_ELEMS = GOSSIP_LANES * GOSSIP_LANES;
constexpr int PERM_SMEM = TILE_ELEMS * 4 + 3 * TILE_ELEMS;

__device__ __forceinline__ float perm_pick(const float* xs,
                                           const signed char* s1,
                                           const signed char* s2t, int k,
                                           int r) {
  const int r2 = s2t[r * GOSSIP_LANES + k];
  return xs[r2 * GOSSIP_LANES + s1[r2 * GOSSIP_LANES + k]];
}

// s2 [k][r] (row-major, shared) -> s2t[r][k]: block b of the 32 x 32
// grid of 4 x 4 byte blocks is (kb, q) with q = b % 32 and
// kb = (q + b / 32) % 32, so a warp's reads (rows 4kb + i, word q) and
// writes (rows 4q + j, word kb) each land in 32 distinct banks
__device__ __forceinline__ void transpose_idx2(signed char* s2t,
                                               const signed char* s2) {
  const unsigned* src = reinterpret_cast<const unsigned*>(s2);
  unsigned* dst = reinterpret_cast<unsigned*>(s2t);
  constexpr int W = GOSSIP_LANES / 4;  // words a row
  for (int b = threadIdx.x; b < W * W; b += PERM_THREADS) {
    const int q = b % W;
    const int kb = (q + b / W) % W;
    const unsigned a0 = src[(4 * kb + 0) * W + q];
    const unsigned a1 = src[(4 * kb + 1) * W + q];
    const unsigned a2 = src[(4 * kb + 2) * W + q];
    const unsigned a3 = src[(4 * kb + 3) * W + q];
    // byte j of a_i is s2[4kb + i][4q + j]; byte i of word j is the same
    const unsigned t0 = __byte_perm(a0, a1, 0x5140);
    const unsigned t1 = __byte_perm(a0, a1, 0x7362);
    const unsigned t2 = __byte_perm(a2, a3, 0x5140);
    const unsigned t3 = __byte_perm(a2, a3, 0x7362);
    dst[(4 * q + 0) * W + kb] = __byte_perm(t0, t2, 0x5410);
    dst[(4 * q + 1) * W + kb] = __byte_perm(t0, t2, 0x7632);
    dst[(4 * q + 2) * W + kb] = __byte_perm(t1, t3, 0x5410);
    dst[(4 * q + 3) * W + kb] = __byte_perm(t1, t3, 0x7632);
  }
}

__global__ void __launch_bounds__(PERM_THREADS)
tile_perm_kernel(const float* __restrict__ x, const signed char* __restrict__ i1,
                 const signed char* __restrict__ i2,
                 const signed char* __restrict__ i3, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  signed char* s1 = reinterpret_cast<signed char*>(xs + TILE_ELEMS);
  signed char* s2 = s1 + TILE_ELEMS;
  signed char* s2t = s2 + TILE_ELEMS;
  const long long base = blockIdx.x * static_cast<long long>(TILE_ELEMS);
  const float4* xt = reinterpret_cast<const float4*>(x + base);
#pragma unroll
  for (int i = 0; i < TILE_ELEMS / 4 / PERM_THREADS; ++i) {
    const int e = i * PERM_THREADS + threadIdx.x;
    reinterpret_cast<float4*>(xs)[e] = __ldg(xt + e);
  }
  const int4* a1 = reinterpret_cast<const int4*>(i1 + base);
  const int4* a2 = reinterpret_cast<const int4*>(i2 + base);
#pragma unroll
  for (int i = 0; i < TILE_ELEMS / 16 / PERM_THREADS; ++i) {
    const int e = i * PERM_THREADS + threadIdx.x;
    reinterpret_cast<int4*>(s1)[e] = __ldg(a1 + e);
    reinterpret_cast<int4*>(s2)[e] = __ldg(a2 + e);
  }
  __syncthreads();
  transpose_idx2(s2t, s2);
  __syncthreads();
  const char4* a3 = reinterpret_cast<const char4*>(i3 + base);
  float4* ot = reinterpret_cast<float4*>(out + base);
  for (int e = threadIdx.x; e < TILE_ELEMS / 4; e += PERM_THREADS) {
    const char4 k = __ldg(a3 + e);
    const int r = e / ROW4;
    float4 v;
    v.x = perm_pick(xs, s1, s2t, k.x, r);
    v.y = perm_pick(xs, s1, s2t, k.y, r);
    v.z = perm_pick(xs, s1, s2t, k.z, r);
    v.w = perm_pick(xs, s1, s2t, k.w, r);
    ot[e] = v;
  }
}

}  // namespace

GOSSIP_EXPORT const char* gossip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

GOSSIP_EXPORT int gossip_probe_slab(const float* x, float* out, int tiles,
                                    int buckets, int cr, int bucket_major,
                                    void* stream) {
  const long long n4 = static_cast<long long>(buckets) * tiles * cr * ROW4;
  if (n4 == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xv = reinterpret_cast<const float4*>(x);
  auto* ov = reinterpret_cast<float4*>(out);
  if (bucket_major)
    slab_kernel<true><<<gossip_blocks(n4, THREADS), THREADS, 0, s>>>(
        xv, ov, tiles, buckets, cr, n4);
  else
    slab_kernel<false><<<gossip_blocks(n4, THREADS), THREADS, 0, s>>>(
        xv, ov, tiles, buckets, cr, n4);
  return static_cast<int>(cudaGetLastError());
}

// n: a multiple of 4 floats; blocks and stream (0 or 1) from
// ops/probes.py scale2_geometry
GOSSIP_EXPORT int gossip_probe_scale2(const float* x, float* y, long long n,
                                      long long blocks, int stream_hints,
                                      void* stream) {
  const long long n4 = n / 4;
  if (n4 == 0) return 0;
  if (blocks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xv = reinterpret_cast<const float4*>(x);
  auto* yv = reinterpret_cast<float4*>(y);
  const auto grid = static_cast<unsigned int>(blocks);
  if (stream_hints)
    scale2_kernel<true><<<grid, THREADS, 0, s>>>(xv, yv, n4);
  else
    scale2_kernel<false><<<grid, THREADS, 0, s>>>(xv, yv, n4);
  return static_cast<int>(cudaGetLastError());
}

// chunk_rows from ops/probes.py gather_rows_geometry
GOSSIP_EXPORT int gossip_probe_gather_rows(const float* x, const int* idx,
                                           float* out, int rows,
                                           int chunk_rows, void* stream) {
  if (rows == 0) return 0;
  if (chunk_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      (static_cast<long long>(rows) + chunk_rows - 1) / chunk_rows
      * GATHER_BANDS;
  gather_rows_kernel<<<static_cast<unsigned int>(blocks), GATHER_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<const int4*>(idx), reinterpret_cast<float4*>(out),
      rows, chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

// rows_per_block, threads and staged from ops/probes.py
// gather_lanes_geometry; device: the CUDA device of the tensors and of
// stream (its shared-memory opt-in is set once)
GOSSIP_EXPORT int gossip_probe_gather_lanes(const float* x, const int* idx,
                                            float* out, long long rows,
                                            int cols, int rows_per_block,
                                            int threads, int staged,
                                            int device, void* stream) {
  if (rows == 0) return 0;
  if (cols < 4 || cols % 4 || rows_per_block < 1 || threads < 32 ||
      threads > 1024 || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int smem_max[MAX_DEVICES] = {};  // 0: not yet opted in
  if (device < 0 || device >= MAX_DEVICES) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const long long smem =
      staged ? static_cast<long long>(rows_per_block) * cols * 4 : 0;
  if (staged && !smem_max[device]) {
    int most = 0;
    const cudaError_t e = opt_in_lanes(device, &most);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_max[device] = most;
  }
  if (staged && smem > smem_max[device]) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* iv = reinterpret_cast<const int4*>(idx);
  auto* ov = reinterpret_cast<float4*>(out);
  return static_cast<int>(
      staged ? launch_lanes<true>(x, iv, ov, rows, cols, rows_per_block,
                                  threads, blocks,
                                  static_cast<size_t>(smem), s)
             : launch_lanes<false>(x, iv, ov, rows, cols, rows_per_block,
                                   threads, blocks, 0, s));
}

GOSSIP_EXPORT int gossip_probe_tile_perm(const float* x, const signed char* i1,
                                         const signed char* i2,
                                         const signed char* i3, float* out,
                                         long long tiles, void* stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_perm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PERM_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  if (tiles == 0) return 0;
  tile_perm_kernel<<<static_cast<unsigned int>(tiles), PERM_THREADS,
                     PERM_SMEM, static_cast<cudaStream_t>(stream)>>>(
      x, i1, i2, i3, out);
  return static_cast<int>(cudaGetLastError());
}
