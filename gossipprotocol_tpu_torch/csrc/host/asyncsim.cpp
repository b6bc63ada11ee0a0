// Asynchronous reference-semantics oracle.
//
// A compact discrete-event simulator of the *actor* execution model the
// reference uses (SURVEY.md §3.2-3.3), built from its documented behavior
// — not a translation of its code. It exists so tests can cross-validate
// the bulk-synchronous TPU engine's semantic claims against an
// asynchronous execution of the same rules:
//
//   * async_gossip — each node that has heard the rumor repeatedly sends
//     it to a uniform-random neighbor (the reference's Process1 self-loop,
//     mailbox-fair round-robin dispatch); receivers stop being targets
//     once converged (sender-side dict check); a node converges on its
//     k-th hearing. A global keep-alive source re-injects the rumor into
//     random unconverged nodes (Actor2). Returns total message events
//     until global convergence.
//
//   * async_pushsum_walk — the reference's accidental single-token random
//     walk (SURVEY.md §2.4.2): one (s, w) message hops between nodes; a
//     node "converges" on its 2nd receipt (broken always-zero delta with
//     count initialized to 1); converged nodes relay. Returns hops until
//     every node has converged — i.e. the 2-cover time of the walk.
//
// Event counts stand in for the reference's wall-clock: its dispatcher
// throughput is roughly constant, so time ∝ events. Tests assert the
// qualitative orderings the reference's Report.pdf shows
// (full < imp3D <= 3D << line).

#include <cstddef>
#include <cstdint>
#include <vector>

static inline uint64_t splitmix64(uint64_t seed, uint64_t counter) {
  uint64_t x = seed + (counter + 1) * 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

namespace {
struct Rng {
  uint64_t seed;
  uint64_t ctr = 0;
  uint64_t next(uint64_t bound) { return splitmix64(seed, ctr++) % bound; }
};
}  // namespace

extern "C" {

int64_t async_gossip_cost(int64_t n, const int64_t* offsets,
                          const int32_t* indices, uint64_t seed,
                          int32_t threshold, int64_t start_node,
                          int64_t max_events, int32_t threads,
                          int64_t* out_cost);

// Returns message events to global convergence, or -1 if max_events hit.
// One implementation serves both entry points: the cost integral below is
// free to compute, and a single copy keeps the RNG streams in lockstep by
// construction (the calibration pipeline relies on the event counts of
// the two entry points matching exactly).
int64_t async_gossip(int64_t n, const int64_t* offsets, const int32_t* indices,
                     uint64_t seed, int32_t threshold, int64_t start_node,
                     int64_t max_events) {
  int64_t cost = 0;
  return async_gossip_cost(n, offsets, indices, seed, threshold, start_node,
                           max_events, 1, &cost);
}

// Gossip with the dispatcher-cost model (VERDICT r3 #5): same event
// semantics as async_gossip, but also integrates a virtual wall-clock.
// One sweep = one round-robin pass of the dispatcher over runnable
// actors; with `threads` worker threads a sweep that executes e events
// costs max(e, threads) thread-time units / threads of wall time — a
// saturated dispatcher (e >> threads, the full topology) advances
// events/threads per unit, while a starved one (line gossip: only the
// rumor frontier is runnable) pays full per-event latency. Writes the
// integrated cost (sum of max(sweep_events, threads), i.e. wall time in
// units of per-event service time x threads) to *out_cost and returns
// total events (or -1 if max_events hit).
int64_t async_gossip_cost(int64_t n, const int64_t* offsets,
                          const int32_t* indices, uint64_t seed,
                          int32_t threshold, int64_t start_node,
                          int64_t max_events, int32_t threads,
                          int64_t* out_cost) {
  std::vector<int32_t> hits(n, 0);
  std::vector<uint8_t> heard(n, 0), converged(n, 0);
  std::vector<int64_t> active;
  Rng rng{seed};

  heard[start_node] = 1;
  active.push_back(start_node);
  int64_t n_converged = 0, events = 0, sweeps = 0, cost = 0;

  while (n_converged < n && events < max_events && sweeps++ < max_events) {
    int64_t sweep_events = 0;
    for (int64_t k = 0; k < static_cast<int64_t>(active.size()); ++k) {
      int64_t i = active[k];
      if (converged[i] && hits[i] >= threshold) {
        active[k] = active.back();
        active.pop_back();
        --k;
        continue;
      }
      int64_t deg = offsets[i + 1] - offsets[i];
      if (deg == 0) continue;
      int64_t j = indices[offsets[i] + rng.next(deg)];
      ++events;
      ++sweep_events;
      if (converged[j]) continue;
      ++hits[j];
      if (!heard[j]) {
        heard[j] = 1;
        active.push_back(j);
      }
      if (hits[j] >= threshold && !converged[j]) {
        converged[j] = 1;
        ++n_converged;
      }
    }
    if (n_converged < n) {
      int64_t tries = 0;
      while (tries++ < 8) {
        int64_t j = static_cast<int64_t>(rng.next(n));
        if (converged[j]) continue;
        ++events;
        ++sweep_events;
        ++hits[j];
        if (!heard[j]) {
          heard[j] = 1;
          active.push_back(j);
        }
        if (hits[j] >= threshold) {
          converged[j] = 1;
          ++n_converged;
        }
        break;
      }
    }
    cost += sweep_events > threads ? sweep_events
                                   : static_cast<int64_t>(threads);
  }
  *out_cost = cost;
  return n_converged >= n ? events : -1;
}

// Returns hops until every node converged (2nd receipt), or -1.
int64_t async_pushsum_walk(int64_t n, const int64_t* offsets,
                           const int32_t* indices, uint64_t seed,
                           int64_t start_node, int64_t max_hops) {
  std::vector<int32_t> receipts(n, 0);
  Rng rng{seed};
  int64_t cur = start_node, n_converged = 0, hops = 0;

  while (n_converged < n && hops < max_hops) {
    int64_t deg = offsets[cur + 1] - offsets[cur];
    if (deg == 0) return -1;  // walk trapped — disconnected graph
    cur = indices[offsets[cur] + rng.next(deg)];
    ++hops;
    if (++receipts[cur] == 2) ++n_converged;  // count starts at 1,
                                              // converges at "count = 3"
  }
  return n_converged >= n ? hops : -1;
}

}  // extern "C"
