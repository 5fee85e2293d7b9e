// Native host runtime: exact-semantics sequential graph construction and
// multithreaded batch search over the SAME padded adjacency arrays the device
// programs use.
//
// Role (mirrors the reference's Rust core, reference/src/index/nsw.rs):
// the early phase of index construction is latency-bound pointer chasing —
// the reference builds its first 50,000 points sequentially "to not generate
// a truly horrible graph" (nsw.rs:234). That phase maps terribly onto a GPU
// (one dependent search per insert) and perfectly onto a CPU, so this module
// implements it natively:
//
//   * beam search  == nsw::search (nsw.rs:133-184): min-heap candidates,
//     bounded max-heap result beam, generation-stamped visited set (the
//     GenerationSet idea, generationset.rs, done at full width)
//   * select_neighbors heuristic == nsw.rs:11-33 (ascending pop, keep e iff
//     dist(e, every kept r) > dist(e, q), stop at m)
//   * insert == insert_point/insert_neighbors (nsw.rs:60-131) including the
//     degree-cap re-prune and post-prune re-add; the cap is W-1 so the
//     re-add stays inside the fixed row width
//   * host_knns == Index::knns (src/index/mod.rs:27-43): std::thread pool
//     over the query batch — the rayon par_iter analogue for host fallback
//
// Distances: metric 0 = Hamming over packed uint32 words (sketch.rs:19-29),
// metric 1 = squared L2 over int32 coordinates (examples/main.rs:7-11).
//
// C ABI only; bound from Python via ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <utility>
#include <vector>

namespace {

struct HostGraph {
  int32_t* adj;   // [cap, W] row-major, -1 = empty slot
  int32_t* deg;   // [cap]
  int64_t cap;
  int32_t W;

  int32_t* row(int64_t v) const { return adj + v * W; }
};

using DistId = std::pair<int32_t, int32_t>;  // (distance, id)

struct Hamming {
  const uint32_t* pts;
  int32_t words;
  inline int32_t operator()(int64_t a, const uint32_t* q) const {
    const uint32_t* p = pts + a * words;
    int32_t s = 0;
    int32_t i = 0;
    for (; i + 2 <= words; i += 2) {
      uint64_t x, y;
      std::memcpy(&x, p + i, 8);
      std::memcpy(&y, q + i, 8);
      s += __builtin_popcountll(x ^ y);
    }
    for (; i < words; ++i) s += __builtin_popcount(p[i] ^ q[i]);
    return s;
  }
  const uint32_t* point(int64_t a) const { return pts + a * words; }
};

struct SqL2 {
  const int32_t* pts;
  int32_t words;  // dimensionality
  inline int32_t operator()(int64_t a, const int32_t* q) const {
    const int32_t* p = pts + a * words;
    int64_t s = 0;
    for (int32_t i = 0; i < words; ++i) {
      int64_t d = (int64_t)p[i] - q[i];
      s += d * d;
    }
    return (int32_t)std::min<int64_t>(s, INT32_MAX);
  }
  const int32_t* point(int64_t a) const { return pts + a * words; }
};

// Generation-stamped visited set (generationset.rs:6-62 done at u32 width —
// no wraparound staleness until 2^32 generations).
struct Visited {
  std::vector<uint32_t> stamp;
  uint32_t gen = 0;
  void reset(int64_t n) {
    if ((int64_t)stamp.size() < n) stamp.assign(n, 0);
    ++gen;
  }
  bool test_and_set(int64_t v) {
    if (stamp[v] == gen) return true;
    stamp[v] = gen;
    return false;
  }
};

// nsw::search (nsw.rs:133-184), exact semantics: unbounded candidate heap,
// ef-bounded result beam, prune rule e_dist >= worst && |w| >= ef.
template <typename Dist, typename Q>
void search(const HostGraph& g, const Dist& dist, const Q* q, int ef,
            int32_t ep, Visited& vis, int64_t n,
            std::vector<DistId>& out /*ascending*/) {
  vis.reset(n);
  int32_t d0 = dist(ep, q);
  vis.test_and_set(ep);

  // cands: min-heap via greater; w: max-heap (worst on top)
  std::priority_queue<DistId, std::vector<DistId>, std::greater<DistId>> cands;
  std::priority_queue<DistId> w;
  cands.push({d0, ep});
  w.push({d0, ep});

  while (!cands.empty()) {
    DistId c = cands.top();
    if (c.first > w.top().first) break;
    cands.pop();
    const int32_t* nbrs = g.row(c.second);
    for (int32_t j = 0; j < g.W; ++j) {
      int32_t e = nbrs[j];
      if (e < 0) continue;
      if (vis.test_and_set(e)) continue;
      int32_t de = dist(e, q);
      if (de >= w.top().first && (int)w.size() >= ef) continue;
      cands.push({de, e});
      w.push({de, e});
      if ((int)w.size() > ef) w.pop();
    }
  }
  out.clear();
  out.reserve(w.size());
  while (!w.empty()) {
    out.push_back(w.top());
    w.pop();
  }
  std::sort(out.begin(), out.end());
}

// select_neighbors heuristic (nsw.rs:11-33): candidates ascending; keep e
// iff dist(e, every kept r) > e.distance; stop at m.
template <typename Dist>
void select_neighbors(const Dist& dist, const std::vector<DistId>& cand_asc,
                      int m, std::vector<DistId>& kept) {
  kept.clear();
  for (const auto& e : cand_asc) {
    if ((int)kept.size() >= m) break;
    bool ok = true;
    for (const auto& r : kept) {
      if (dist(e.second, dist.point(r.second)) <= e.first) {
        ok = false;
        break;
      }
    }
    if (ok) kept.push_back(e);
  }
}

template <typename Dist>
void add_edge(HostGraph& g, int32_t v, int32_t w_) {
  if (v < 0 || w_ < 0 || v >= g.cap || w_ >= g.cap) return;
  int32_t* r = g.row(v);
  for (int32_t j = 0; j < g.deg[v]; ++j)
    if (r[j] == w_) return;  // HashSet semantics: no duplicate edges
  if (g.deg[v] < g.W) r[g.deg[v]++] = w_;
}

// insert_neighbors (nsw.rs:94-131): undirected edge adds, degree-cap prune
// (select_neighbors at the cap over the neighborhood), then re-add the new
// edge. Cap = W-1 so the re-add fits the fixed row width.
template <typename Dist>
void insert_neighbors(HostGraph& g, const Dist& dist, int32_t v,
                      const std::vector<DistId>& nbrs,
                      std::vector<DistId>& scratch,
                      std::vector<DistId>& kept) {
  for (const auto& e : nbrs) {
    add_edge<Dist>(g, v, e.second);
    add_edge<Dist>(g, e.second, v);
  }
  int m_max = g.W - 1;
  for (const auto& en : nbrs) {
    int32_t e = en.second;
    if (g.deg[e] <= m_max) continue;
    scratch.clear();
    const int32_t* r = g.row(e);
    const auto* ep_pt = dist.point(e);
    for (int32_t j = 0; j < g.deg[e]; ++j)
      scratch.push_back({dist(r[j], ep_pt), r[j]});
    std::sort(scratch.begin(), scratch.end());
    select_neighbors(dist, scratch, m_max, kept);
    int32_t* row = g.row(e);
    std::fill(row, row + g.W, -1);
    g.deg[e] = 0;
    for (const auto& k : kept) row[g.deg[e]++] = k.second;
    add_edge<Dist>(g, e, v);  // re-add (nsw.rs:129)
    add_edge<Dist>(g, v, e);
  }
}

template <typename Dist, typename Q>
int64_t build_range(const Dist& dist, HostGraph& g, int64_t n0, int64_t n1,
                    int m, int efc, int32_t ep) {
  Visited vis;
  std::vector<DistId> beam, kept, scratch;
  for (int64_t i = n0; i < n1; ++i) {
    const Q* q = dist.point(i);
    search(g, dist, q, efc, ep, vis, n1, beam);
    // candidates exclude the point itself (it is unreachable: edgeless)
    select_neighbors(dist, beam, m, kept);
    std::vector<DistId> nbrs = kept;
    insert_neighbors(g, dist, (int32_t)i, nbrs, scratch, kept);
  }
  return n1 - n0;
}

// Distance adapter for hierarchy layers: layer slot -> base point via the
// node_ids map, so the generic search/select/insert templates run unchanged
// on level graphs (the reference's SimpleGraph<(P, Idx)> layers,
// hnsw.rs:9-10, as array views).
template <typename Base, typename Q>
struct LevelDist {
  Base base;
  const int32_t* node_ids;
  int32_t words;  // query stride (same as base)
  inline int32_t operator()(int64_t a, const Q* q) const {
    return base(node_ids[a], q);
  }
  const Q* point(int64_t a) const { return base.point(node_ids[a]); }
};

// Full-hierarchy sequential insert — IndexBuilder::add for HNSW
// (hnsw.rs:183-244): per-point level (pre-drawn by the caller so the level
// RNG stream lives in one place), greedy ef=1 descent through layers above
// the draw, insert_idx per layer top->down, then the base insert. One
// deliberate deviation, documented in docs/PARITY.md: the reference chains
// entry points across layers in the WRONG index space (a layer-l neighbor
// Idx is reused as a layer-(l-1) entry, hnsw.rs:220-231); here descent
// follows the down pointer of the nearest selected neighbor.
template <typename Dist, typename Q>
int64_t build_hnsw_range(const Dist& dist, HostGraph& base, int64_t n0,
                         int64_t n1, int m, int efc, const int32_t* draws,
                         int32_t max_levels, const int64_t* level_caps,
                         std::vector<HostGraph>& lgraphs,
                         std::vector<int32_t*>& lnode_ids,
                         std::vector<int32_t*>& ldown, int64_t* level_ns,
                         int64_t* ep_io) {
  Visited vis;
  std::vector<DistId> beam, kept, scratch;
  int32_t n_layers = 0;
  for (int32_t l = 0; l < max_levels; ++l)
    if (level_ns[l] > 0) n_layers = l + 1;
  int64_t ep = *ep_io;

  for (int64_t i = n0; i < n1; ++i) {
    const Q* q = dist.point(i);
    int32_t L = std::min<int32_t>(draws[i], max_levels);
    // register in layers [0, L): node_ids = base id, down = slot below
    std::vector<int64_t> slots(L, -1);
    for (int32_t l = 0; l < L; ++l) {
      if (level_ns[l] >= level_caps[l]) {  // out of preallocated rows:
        L = l;                             // clamp the draw (caps carry 8x
        slots.resize(L);                   // headroom; effectively unreached)
        break;
      }
      int64_t s = level_ns[l]++;
      lnode_ids[l][s] = (int32_t)i;
      ldown[l][s] = (int32_t)(l == 0 ? i : slots[l - 1]);
      slots[l] = s;
    }
    int32_t old_layers = n_layers;
    if (L > n_layers) n_layers = L;

    // greedy descent from the old top through layers [L, old_layers)
    int64_t cur = ep;  // slot in layer old_layers-1, or base id if none
    for (int32_t l = old_layers - 1; l >= L; --l) {
      LevelDist<Dist, Q> ld{dist, lnode_ids[l], dist.words};
      search(lgraphs[l], ld, q, 1, (int32_t)cur, vis, level_ns[l], beam);
      cur = ldown[l][beam.front().second];
    }

    // insert_idx per occupied layer, top -> down (hnsw.rs:220-231); layers
    // at or above old_layers hold only this point (no peers to link yet)
    for (int32_t l = std::min<int32_t>(L, old_layers) - 1; l >= 0; --l) {
      LevelDist<Dist, Q> ld{dist, lnode_ids[l], dist.words};
      search(lgraphs[l], ld, q, efc, (int32_t)cur, vis, level_ns[l], beam);
      select_neighbors(ld, beam, m, kept);
      std::vector<DistId> nbrs = kept;
      insert_neighbors(lgraphs[l], ld, (int32_t)slots[l], nbrs, scratch,
                       kept);
      cur = ldown[l][nbrs.front().second];
    }

    // base insert (hnsw.rs:234-243)
    search(base, dist, q, efc, (int32_t)cur, vis, n1, beam);
    select_neighbors(dist, beam, m, kept);
    std::vector<DistId> nbrs = kept;
    insert_neighbors(base, dist, (int32_t)i, nbrs, scratch, kept);

    if (L > old_layers) ep = slots[L - 1];  // new top level: new entry point
  }
  *ep_io = ep;
  return n1 - n0;
}

template <typename Dist, typename Q>
void knns(const Dist& dist, const HostGraph& g, int64_t n, const Q* queries,
          int64_t nq, int k, int ef, const int32_t* eps, int32_t ep_scalar,
          int threads, int32_t* out_ids, int32_t* out_dists) {
  if (threads <= 0) threads = std::thread::hardware_concurrency();
  threads = std::max(1, std::min<int>(threads, 64));
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    Visited vis;
    std::vector<DistId> beam;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= nq) break;
      const Q* q = queries + i * dist.words;
      int32_t ep = eps ? eps[i] : ep_scalar;
      search(g, dist, q, std::max(ef, k), ep, vis, n, beam);
      for (int j = 0; j < k; ++j) {
        if (j < (int)beam.size()) {
          out_dists[i * k + j] = beam[j].first;
          out_ids[i * k + j] = beam[j].second;
        } else {
          out_dists[i * k + j] = INT32_MAX;
          out_ids[i * k + j] = INT32_MAX;
        }
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

int32_t hnsw_host_abi_version() { return 3; }

// Hamming distance of two packed-u32 sketches (golden-test hook).
int32_t hnsw_host_hamming(const uint32_t* a, const uint32_t* b, int32_t words) {
  Hamming d{a, words};
  return d(0, b);
}

// Sequentially insert points [n0, n1) into the graph with exact reference
// insert semantics. metric: 0 = hamming(u32), 1 = squared L2 (int32).
// Returns the number of points inserted, or -1 on bad arguments.
int64_t hnsw_host_build(const void* points, int32_t words, int32_t metric,
                        int32_t* adj, int32_t* deg, int64_t cap, int32_t W,
                        int64_t n0, int64_t n1, int32_t m, int32_t efc,
                        int32_t ep) {
  if (n1 > cap || n0 < 0 || n0 > n1 || W <= 0 || words <= 0) return -1;
  HostGraph g{adj, deg, cap, W};
  if (metric == 0) {
    Hamming d{(const uint32_t*)points, words};
    return build_range<Hamming, uint32_t>(d, g, n0, n1, m, efc, ep);
  } else if (metric == 1) {
    SqL2 d{(const int32_t*)points, words};
    return build_range<SqL2, int32_t>(d, g, n0, n1, m, efc, ep);
  }
  return -1;
}

// Full-hierarchy sequential HNSW build (IndexBuilder::add semantics,
// hnsw.rs:183-244). ``draws`` holds the caller's per-point level draws (the
// deterministic RNG stream lives in Python). Level arrays are CONCATENATED
// buffers: level l's rows start at sum(level_caps[:l]) (adj: * W).
// ``level_ns`` carries node counts in/out; ``ep_io`` the entry slot in the
// top level (a base id while no levels exist). Returns inserts done, -1 on
// bad arguments.
int64_t hnsw_host_build_hnsw(const void* points, int32_t words,
                             int32_t metric, int32_t* adj, int32_t* deg,
                             int64_t cap, int32_t W, int64_t n0, int64_t n1,
                             int32_t m, int32_t efc, const int32_t* draws,
                             int32_t max_levels, const int64_t* level_caps,
                             int32_t* lvl_node_ids, int32_t* lvl_down,
                             int32_t* lvl_adj, int32_t* lvl_deg,
                             int64_t* level_ns, int64_t* ep_io) {
  if (n1 > cap || n0 < 0 || n0 > n1 || W <= 0 || words <= 0 ||
      max_levels < 0)
    return -1;
  HostGraph base{adj, deg, cap, W};
  std::vector<HostGraph> lgraphs;
  std::vector<int32_t*> lnode_ids, ldown;
  int64_t off = 0;
  for (int32_t l = 0; l < max_levels; ++l) {
    lgraphs.push_back({lvl_adj + off * W, lvl_deg + off, level_caps[l], W});
    lnode_ids.push_back(lvl_node_ids + off);
    ldown.push_back(lvl_down + off);
    off += level_caps[l];
  }
  if (metric == 0) {
    Hamming d{(const uint32_t*)points, words};
    return build_hnsw_range<Hamming, uint32_t>(
        d, base, n0, n1, m, efc, draws, max_levels, level_caps, lgraphs,
        lnode_ids, ldown, level_ns, ep_io);
  } else if (metric == 1) {
    SqL2 d{(const int32_t*)points, words};
    return build_hnsw_range<SqL2, int32_t>(
        d, base, n0, n1, m, efc, draws, max_levels, level_caps, lgraphs,
        lnode_ids, ldown, level_ns, ep_io);
  }
  return -1;
}

// Multithreaded batch k-NN over the padded-array graph (host fallback /
// oracle). out_ids/out_dists are [nq, k]; missing slots get INT32_MAX.
// ``eps`` (nullable int32[nq]) gives a per-query entry point — the hook the
// HNSW level-descent chain needs (hnsw.rs:285-293); when null, the scalar
// ``ep`` seeds every query.
int64_t hnsw_host_knns_eps(const void* points, int32_t words, int32_t metric,
                           const int32_t* adj, const int32_t* deg,
                           int64_t cap, int32_t W, int64_t n,
                           const void* queries, int64_t nq, int32_t k,
                           int32_t ef, const int32_t* eps, int32_t ep,
                           int32_t threads, int32_t* out_ids,
                           int32_t* out_dists) {
  HostGraph g{(int32_t*)adj, (int32_t*)deg, cap, W};
  if (metric == 0) {
    Hamming d{(const uint32_t*)points, words};
    knns<Hamming, uint32_t>(d, g, n, (const uint32_t*)queries, nq, k, ef,
                            eps, ep, threads, out_ids, out_dists);
  } else if (metric == 1) {
    SqL2 d{(const int32_t*)points, words};
    knns<SqL2, int32_t>(d, g, n, (const int32_t*)queries, nq, k, ef, eps, ep,
                        threads, out_ids, out_dists);
  } else {
    return -1;
  }
  return nq;
}

int64_t hnsw_host_knns(const void* points, int32_t words, int32_t metric,
                       const int32_t* adj, const int32_t* deg, int64_t cap,
                       int32_t W, int64_t n, const void* queries, int64_t nq,
                       int32_t k, int32_t ef, int32_t ep, int32_t threads,
                       int32_t* out_ids, int32_t* out_dists) {
  return hnsw_host_knns_eps(points, words, metric, adj, deg, cap, W, n,
                            queries, nq, k, ef, nullptr, ep, threads,
                            out_ids, out_dists);
}

// Exact brute-force k-NN on the host (small-scale oracle).
int64_t hnsw_host_bruteforce(const void* points, int32_t words,
                             int32_t metric, int64_t n, const void* queries,
                             int64_t nq, int32_t k, int32_t threads,
                             int32_t* out_ids, int32_t* out_dists) {
  if (threads <= 0) threads = std::thread::hardware_concurrency();
  // Blocked scan: a worker claims a BLOCK of queries and streams the
  // whole point array once for it. The query-outer loop read the points
  // nq times (2.6 TB at 10M x 2048 — memory-bound for minutes); a 64-query
  // block (8 KB, L1-resident) makes the scan compute-bound.
  constexpr int64_t QB = 64;
  std::atomic<int64_t> next(0);
  auto run = [&](auto dist) {
    using QT = std::remove_const_t<std::remove_pointer_t<decltype(dist.point(0))>>;
    auto worker = [&]() {
      std::vector<std::vector<DistId>> heaps(QB);
      for (;;) {
        int64_t q0 = next.fetch_add(1) * QB;
        if (q0 >= nq) break;
        int64_t qn = std::min<int64_t>(QB, nq - q0);
        for (auto& h : heaps) h.clear();
        for (int64_t v = 0; v < n; ++v) {
          for (int64_t j = 0; j < qn; ++j) {
            const QT* q = (const QT*)queries + (q0 + j) * words;
            int32_t dv = dist(v, q);
            auto& heap = heaps[j];
            if ((int)heap.size() < k) {
              heap.push_back({dv, (int32_t)v});
              std::push_heap(heap.begin(), heap.end());
            } else if (DistId{dv, (int32_t)v} < heap.front()) {
              std::pop_heap(heap.begin(), heap.end());
              heap.back() = {dv, (int32_t)v};
              std::push_heap(heap.begin(), heap.end());
            }
          }
        }
        for (int64_t j = 0; j < qn; ++j) {
          auto& heap = heaps[j];
          std::sort_heap(heap.begin(), heap.end());
          int64_t i = q0 + j;
          for (int t = 0; t < k; ++t) {
            if (t < (int)heap.size()) {
              out_dists[i * k + t] = heap[t].first;
              out_ids[i * k + t] = heap[t].second;
            } else {
              out_dists[i * k + t] = INT32_MAX;
              out_ids[i * k + t] = INT32_MAX;
            }
          }
        }
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < std::max(1, std::min<int>(threads, 64)); ++t)
      pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  };
  if (metric == 0) run(Hamming{(const uint32_t*)points, words});
  else if (metric == 1) run(SqL2{(const int32_t*)points, words});
  else return -1;
  return nq;
}

}  // extern "C"
