// Euler-split edge coloring for the routed-delivery plan compiler.
//
// The TPU delivery kernel (gossipprotocol_tpu/ops/) applies an arbitrary
// static permutation to [128,128] tiles as three lane-gathers and two
// transposes (3-stage Clos).  Routing a tile permutation through that
// network is exactly a proper edge coloring of the n-regular bipartite
// multigraph  src_row -> dst_row  with n colors (Konig).  This file
// implements the classic Euler-split construction: repeatedly orient an
// Euler circuit and split the edges into two d/2-regular halves until
// each leaf is a perfect matching, which gets one color.  O(E log n)
// per tile; n must be a power of two.
//
// The numpy fallback in gossipprotocol_tpu/ops/clos.py implements the
// same algorithm; tests assert both produce proper colorings (colors are
// not required to match bit-for-bit — any proper coloring routes).
//
// Exposed C ABI:
//   route_color_tiles(T, n, deg, src, dst, color)
//     T      : number of tiles
//     n      : switch width (colors); left/right vertices are n rows
//     deg    : per-row degree (= edges per tile / n), power of two
//     src,dst: int32[T * n * deg]  row ids in [0, n)
//     color  : int32[T * n * deg]  out, in [0, deg)
//   returns 0 on success, nonzero on malformed input.

#include <algorithm>
#include <cstdint>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// Iterative Euler-split coloring, re-laid as level sweeps over two
// ping-pong id buffers (replacing the earlier recursive spelling): a
// regular multigraph splits into EXACT halves at every level, so
// segment boundaries are static (segment s of level l covers ids
// [s*E/2^l, (s+1)*E/2^l)) and the final level's segments are perfect
// matchings — color = segment index.  No per-recursion allocation,
// sequential writes; measured ~3x the recursive version on the 1-core
// host (1.6 ms vs ~5-7 ms per 8192-unit tile).
struct IterSplitter {
  int n = 0;
  std::vector<int32_t> head_;  // 2n vertices
  std::vector<int32_t> nxt_;   // 2 entries per edge of one segment
  std::vector<int32_t> stack_;
  std::vector<uint8_t> used_;
  std::vector<int32_t> a_, b_;  // ping-pong id buffers [E]

  void color_tile(const int32_t* src, const int32_t* dst, int deg,
                  int32_t* color) {
    const int E = n * deg;
    a_.resize(E);
    b_.resize(E);
    for (int k = 0; k < E; ++k) a_[k] = k;
    int levels = 0;
    for (int d = deg; d > 1; d >>= 1) ++levels;
    std::vector<int32_t>* cur = &a_;
    std::vector<int32_t>* nxt_buf = &b_;
    int seg_len = E;
    for (int lvl = 0; lvl < levels; ++lvl, seg_len >>= 1) {
      const int segs = E / seg_len;
      for (int s = 0; s < segs; ++s) {
        const int32_t* ids = cur->data() + s * seg_len;
        int32_t* left = nxt_buf->data() + s * seg_len;
        int32_t* right = left + seg_len / 2;
        int nl = 0, nr = 0;
        head_.assign(2 * n, -1);
        nxt_.resize(2 * seg_len);
        // incidence entry 2k   = edge ids[k] seen from its left vertex
        // incidence entry 2k+1 = edge ids[k] seen from its right vertex
        for (int k = 0; k < seg_len; ++k) {
          const int32_t e = ids[k];
          const int u = src[e];
          const int v = n + dst[e];
          nxt_[2 * k] = head_[u];
          head_[u] = 2 * k;
          nxt_[2 * k + 1] = head_[v];
          head_[v] = 2 * k + 1;
        }
        used_.assign(seg_len, 0);
        // Hierholzer over every component; all degrees even by
        // regularity — each closed excursion departs left exactly as
        // often as right, so the halves come out exact.
        for (int start = 0; start < 2 * n; ++start) {
          if (head_[start] < 0) continue;
          stack_.clear();
          stack_.push_back(start);
          while (!stack_.empty()) {
            const int vtx = stack_.back();
            int ent = head_[vtx];
            while (ent >= 0 && used_[ent >> 1]) ent = nxt_[ent];
            head_[vtx] = ent;  // path compression over used entries
            if (ent < 0) {
              stack_.pop_back();
              continue;
            }
            const int k = ent >> 1;
            used_[k] = 1;
            const bool from_left = (ent & 1) == 0;
            const int32_t e = ids[k];
            if (from_left) {
              left[nl++] = e;
              stack_.push_back(n + dst[e]);
            } else {
              right[nr++] = e;
              stack_.push_back(src[e]);
            }
          }
        }
        (void)nl;
        (void)nr;  // == seg_len / 2 each, by regularity
      }
      std::swap(cur, nxt_buf);
    }
    // final segments are perfect matchings: color = segment index
    const int match = E / deg;  // == n
    for (int k = 0; k < E; ++k) {
      color[(*cur)[k]] = static_cast<int32_t>(k / match);
    }
  }
};

}  // namespace

extern "C" int64_t route_color_tiles(int64_t T, int32_t n, int32_t deg,
                                     const int32_t* src, const int32_t* dst,
                                     int32_t* color) {
  if (n <= 0 || deg <= 0 || (deg & (deg - 1)) != 0) return 1;
  const int64_t epr = static_cast<int64_t>(n) * deg;  // edges per tile
#if defined(_OPENMP)
#pragma omp parallel
#endif
  {
    IterSplitter s;  // per-thread scratch reused across tiles
    s.n = n;
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 8)
#endif
    for (int64_t t = 0; t < T; ++t) {
      s.color_tile(src + t * epr, dst + t * epr, deg, color + t * epr);
    }
  }
  return 0;
}

// Fused tile router: bijection completion + coloring + Clos index
// assembly in one native pass.  The plan compiler (ops/plan.py) spent
// ~45% of its single-core host time in the numpy spelling of exactly
// this loop chain — fancy-indexed scatters over [T, U] int64 temporaries
// at ~15 ns/element (measured, 1M-node profile); this emits the int8
// index triples directly at memory speed.
//
//   route_tiles_full(T, unit, perms, idx)
//     perms : int64[T * U]  (U = 16384/unit) — per tile, output unit
//             slot k receives input unit slot perms[k]; -1 slots are
//             don't-care and are completed to a bijection internally
//             (pairing unused sources with -1 slots in order, exactly
//             ops/plan.py::_complete_bijections' fill rule)
//     idx   : int8[T * 3 * 128 * 128] out — stacked (idx1, idx2, idx3)
//             f32-lane gather triples in ops/clos.py's convention
//   returns 0 on success, nonzero on malformed input (a non-injective
//   real entry set, or an entry out of range).
extern "C" int64_t route_tiles_full(int64_t T, int32_t unit,
                                    const int64_t* perms, int8_t* idx) {
  if (unit <= 0 || 128 % unit != 0) return 1;
  const int n = 128;
  const int upr = n / unit;                       // units per row
  const int64_t U = static_cast<int64_t>(n) * upr;  // units per tile
  int64_t err = 0;
#if defined(_OPENMP)
#pragma omp parallel reduction(| : err)
#endif
  {
    // per-thread scratch reused across tiles (the per-tile allocation
    // churn was measurable in the route_color_tiles profile)
    std::vector<int64_t> p(U);
    std::vector<uint8_t> used(U);
    std::vector<int32_t> srow(U), drow(U), color(U);
    IterSplitter s;
    s.n = n;
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 4)
#endif
    for (int64_t t = 0; t < T; ++t) {
      const int64_t* pt = perms + t * U;
      // complete the bijection: mark used sources, then fill -1 slots
      // with free sources in ascending order (both scans are in slot /
      // source order, matching the numpy fill rule)
      std::fill(used.begin(), used.end(), uint8_t{0});
      bool bad = false;
      for (int64_t k = 0; k < U; ++k) {
        const int64_t v = pt[k];
        if (v >= 0) {
          if (v >= U || used[v]) { bad = true; break; }
          used[v] = 1;
        }
      }
      if (bad) {
        err = 1;
        continue;
      }
      int64_t free_src = 0;
      for (int64_t k = 0; k < U; ++k) {
        int64_t v = pt[k];
        if (v < 0) {
          while (used[free_src]) ++free_src;
          v = free_src;
          used[free_src] = 1;
        }
        p[k] = v;
        srow[k] = static_cast<int32_t>(v / upr);
        drow[k] = static_cast<int32_t>(k / upr);
      }
      // proper upr-edge-coloring of the srow -> drow multigraph
      s.color_tile(srow.data(), drow.data(), upr, color.data());
      // assemble the three gather index planes (f32-lane granularity)
      int8_t* i1 = idx + t * 3 * n * n;
      int8_t* i2 = i1 + n * n;
      int8_t* i3 = i2 + n * n;
      std::fill(i1, i1 + 3 * n * n, int8_t{0});
      for (int64_t k = 0; k < U; ++k) {
        const int sr = srow[k];
        const int sc = static_cast<int>(p[k] % upr);
        const int dr = drow[k];
        const int dc = static_cast<int>(k % upr);
        const int c = color[k];
        for (int j = 0; j < unit; ++j) {
          i1[sr * n + c * unit + j] = static_cast<int8_t>(sc * unit + j);
          i3[dr * n + dc * unit + j] = static_cast<int8_t>(c * unit + j);
          // stage 2 runs on A.T: lane-major [lane, row] plane
          i2[(c * unit + j) * n + dr] = static_cast<int8_t>(sr);
        }
      }
    }
  }
  return err;
}

// Worker-process OpenMP clamp: the shard-build pool forks W workers
// that would each inherit the parent's thread count and oversubscribe
// the host; each worker calls this once with cpu_count/W.  Thread count
// never changes results (all parallel writes here are disjoint and the
// reductions are exact integer max/or/sum).
extern "C" void set_native_threads(int32_t n) {
#if defined(_OPENMP)
  if (n > 0) omp_set_num_threads(n);
#else
  (void)n;
#endif
}

// Stage-planner hot loops for the radix compiler (ops/plan.py).  The
// numpy spelling spent each stage in an O(F log F) combined-key argsort
// plus fancy-indexed scatters; these two entry points replace it with a
// counting pass over the inverse position map (O(F + slots), parallel
// over tiles) and a fused placement pass (parallel over flows).  Both
// are exact mirrors of the numpy fallback — the plans must come out
// bitwise identical either way (asserted in tests/test_native.py).
//
//   plan_stage_count(F, t_grid, u, b, pos, bucket, rank, max_run)
//     F      : flows
//     t_grid : tiles in the current layout (every pos < t_grid * u)
//     u      : unit slots per tile
//     b      : buckets (radix) at this stage
//     pos    : int64[F]  current unit positions, distinct
//     bucket : int32[F]  destination bucket per flow, in [0, b)
//     rank   : int32[F]  out — rank of each flow within its
//              (tile, bucket) run, counted in ascending-pos order.
//              A tile's slots are contiguous in pos space, so scanning
//              slots ascending within each tile assigns exactly the
//              order numpy's stable argsort by (tile*b + bucket, pos)
//              does.
//     max_run: int64 out — longest run, in units
//   returns 0 on success, 1 on out-of-range input, 2 on duplicate pos.
extern "C" int64_t plan_stage_count(int64_t F, int64_t t_grid, int32_t u,
                                    int32_t b, const int64_t* pos,
                                    const int32_t* bucket, int32_t* rank,
                                    int64_t* max_run) {
  if (u <= 0 || b <= 0 || t_grid < 0 || F < 0) return 1;
  const int64_t slots = t_grid * u;
  std::vector<int64_t> inv(slots);
  int64_t err = 0;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t s = 0; s < slots; ++s) inv[s] = -1;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) reduction(| : err)
#endif
  for (int64_t f = 0; f < F; ++f) {
    const int64_t p = pos[f];
    if (p < 0 || p >= slots || bucket[f] < 0 || bucket[f] >= b) {
      err = 1;
      continue;
    }
    inv[p] = f;  // duplicates overwrite; caught by the seen-count below
  }
  if (err) return err;
  int64_t mx = 0, seen = 0;
#if defined(_OPENMP)
#pragma omp parallel reduction(max : mx) reduction(+ : seen)
#endif
  {
    std::vector<int32_t> cnt(b);
#if defined(_OPENMP)
#pragma omp for schedule(static)
#endif
    for (int64_t t = 0; t < t_grid; ++t) {
      std::fill(cnt.begin(), cnt.end(), 0);
      const int64_t base = t * u;
      for (int64_t s = 0; s < u; ++s) {
        const int64_t f = inv[base + s];
        if (f < 0) continue;
        rank[f] = cnt[bucket[f]]++;
        ++seen;
      }
      for (int32_t k = 0; k < b; ++k) {
        if (cnt[k] > mx) mx = cnt[k];
      }
    }
  }
  if (seen != F) return 2;
  *max_run = mx;
  return 0;
}

//   plan_stage_place(F, u, unit, b, cr, o, tau_in, tau_slab,
//                    pos, bucket, rank, new_pos, perm)
//     new_pos: int64[F] out — each flow's position in the staging slab
//     perm   : int64[t_grid * o * u] or null — per-(tile, o) output-slot
//              permutation, caller pre-filled with -1 (null skips it:
//              the geometry-only passes need new_pos alone).  Every
//              flow writes a distinct perm slot (distinct (bucket,
//              rank) within a tile), so the flow loop is race-free.
//   returns 0 on success, nonzero on malformed geometry.
extern "C" int64_t plan_stage_place(int64_t F, int32_t u, int32_t unit,
                                    int32_t b, int32_t cr, int32_t o,
                                    int32_t tau_in, int32_t tau_slab,
                                    const int64_t* pos,
                                    const int32_t* bucket,
                                    const int32_t* rank, int64_t* new_pos,
                                    int64_t* perm) {
  if (u <= 0 || unit <= 0 || 128 % unit != 0 || cr <= 0 || tau_in <= 0 ||
      b <= 0 || o <= 0 || tau_slab <= 0) {
    return 1;
  }
  const int32_t upr = 128 / unit;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t f = 0; f < F; ++f) {
    const int64_t tile = pos[f] / u;
    const int32_t rr = rank[f] / upr;
    const int32_t rm = rank[f] % upr;
    const int64_t reg = tile / tau_in;
    const int64_t tir = tile - reg * tau_in;
    new_pos[f] =
        (((reg * b + bucket[f]) * tau_slab + tir) * cr + rr) * upr + rm;
    if (perm) {
      const int64_t out_slot =
          (static_cast<int64_t>(bucket[f]) * cr + rr) * upr + rm;
      perm[tile * o * u + out_slot] = pos[f] % u;
    }
  }
  return 0;
}
