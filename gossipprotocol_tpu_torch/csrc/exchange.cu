// Sharded push-design edge-share exchange, for Hopper (sm_90a).
//
// pallas_exchange — replaces gossipprotocol_tpu/ops/pallasdelivery.py:491
// (the pallas_call at :542 over _exchange_kernel :434 and
// _exchange_overlap_kernel :456).
//
// Every shard s holds a slab of S rows (row d: the edge shares it sends to
// shard d) and every shard d receives an output of S rows (row s: what
// shard s sent it): out_d[s] = slab_s[d]. The TPU kernel pushed each row
// to its destination chip with a remote DMA; here the shards' buffers
// live on one card and each (s, d) row is a copy between two device
// buffers. The buffers need not be one tensor: the launcher takes a table
// of S source and S destination base pointers, passed by value in the
// kernel's parameter space (no per-call upload). Later the same table can
// carry peer pointers of other cards.
//
// The copy is byte-oriented, so one kernel serves the f32 slab, the bf16
// and int8 wires and the int8 wire's [S, 1] f32 scales: 16-byte vectors
// where source and destination share their alignment within 16 bytes,
// bytes at the unaligned head and the tail (a bf16 or int8 row need not
// be 16-byte aligned). It writes every byte of its output; the padding
// slots of a block arrive as the exact zeros the sender's final routing
// pass wrote.
//
// Two schedules, as on the TPU, each one launch: ring = 0 copies the S*S
// rows in (s, d) order (the TPU kernel started every copy, then waited for
// all); ring = 1 keeps the JAX ring's order, step o moving row
// s -> (s + o) % S for every s. The blocks take (step, shard, chunk) units
// with the step most significant, so the card dispatches step 0's copies
// first. The TPU ring overlapped one step's remote DMAs with the next; on
// one card there is nothing to overlap (ShardPushDelivery.receive needs
// every incoming row before plan_recv), and what one launch gains over
// one launch per step is a single ramp and tail instead of S. Both
// schedules run the same copy and move the same bytes; only the map from
// block to (s, d) differs.
//
// Bound on this card: bytes (each row read once and written once; no
// arithmetic).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_SHARDS = 64;
constexpr int EXCHANGE_THREADS = 256;
constexpr int VEC_PER_THREAD = 4;   // 16-byte vectors per thread per pass

struct PtrTable {
  const unsigned char* src[MAX_SHARDS];
  unsigned char* dst[MAX_SHARDS];
};

__global__ void exchange_kernel(const __grid_constant__ PtrTable t, int ns,
                                long long row_bytes, int ring) {
  // blockIdx.y: (s, d) = (y / ns, y % ns), or ring step o = y / ns moving
  // shard s = y % ns's row to d = (s + o) % ns
  const int hi = blockIdx.y / ns, lo = blockIdx.y % ns;
  const int s = ring ? lo : hi;
  const int d = ring ? (lo + hi) % ns : lo;
  const unsigned char* src = t.src[s] + static_cast<long long>(d) * row_bytes;
  unsigned char* dst = t.dst[d] + static_cast<long long>(s) * row_bytes;
  const unsigned sa = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src) & 15);
  const unsigned da = static_cast<unsigned>(reinterpret_cast<uintptr_t>(dst) & 15);
  long long head = row_bytes, nvec = 0;  // misaligned ends: bytes only
  if (sa == da) {
    head = (16 - sa) & 15;
    if (head > row_bytes) head = row_bytes;
    nvec = (row_bytes - head) / 16;
  }
  const long long tail = head + nvec * 16;
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  for (long long i = tid; i < nvec; i += stride) dv[i] = sv[i];
  for (long long i = tid; i < head; i += stride) dst[i] = src[i];
  for (long long i = tail + tid; i < row_bytes; i += stride) dst[i] = src[i];
}

}  // namespace

GOSSIP_EXPORT const char* gossip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// src, dst: ns base pointers each (shard s's slab [ns, row], shard d's
// output [ns, row]); row_bytes: bytes per row; ring: 0 for the (s, d)
// order, 1 for the ring's step order. One launch either way.
GOSSIP_EXPORT int gossip_exchange(void* const* src, void* const* dst,
                                  int ns, long long row_bytes, int ring,
                                  void* stream) {
  if (ns < 1 || ns > MAX_SHARDS || (ring != 0 && ring != 1) || row_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_bytes == 0) return 0;
  PtrTable t;
  for (int i = 0; i < ns; ++i) {
    t.src[i] = static_cast<const unsigned char*>(src[i]);
    t.dst[i] = static_cast<unsigned char*>(dst[i]);
  }
  for (int i = ns; i < MAX_SHARDS; ++i) {
    t.src[i] = nullptr;
    t.dst[i] = nullptr;
  }
  const long long per_block = static_cast<long long>(EXCHANGE_THREADS)
                              * VEC_PER_THREAD * 16;
  long long gx = (row_bytes + per_block - 1) / per_block;
  if (gx < 1) gx = 1;
  if (gx > 65535) gx = 65535;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(ns * ns));
  exchange_kernel<<<grid, EXCHANGE_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(t, ns, row_bytes,
                                                         ring);
  return static_cast<int>(cudaGetLastError());
}
