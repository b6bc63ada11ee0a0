// Shared helpers of the port's CUDA kernels (plain C interface, loaded
// with ctypes by gossipprotocol_tpu_torch/ops/build.py).
#pragma once

#include <cuda_runtime.h>

#define GOSSIP_LANES 128

// Every exported launcher returns cudaGetLastError() right after its
// launch, so a refused launch (bad grid, too much shared memory) is
// raised by the Python wrapper instead of passing silently.
#define GOSSIP_EXPORT extern "C" __attribute__((visibility("default")))

static inline unsigned int gossip_blocks(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}
