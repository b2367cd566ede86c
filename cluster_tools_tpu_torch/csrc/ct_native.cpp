// Host C++ rung of cluster_tools_tpu_torch: union-find, GAEC, the
// count-weighted edge-feature merge, the mutex-watershed constraint loop,
// Kernighan-Lin, round-based parallel contraction, the exact squared EDT
// and the bucket-queue seeded watershed.
//
// A copy of the JAX package's native/ct_native.cpp with the same arithmetic,
// so both libraries give the same labels and float64 sums bit for bit.
// Built with g++ (ISO C++17, -O3, no fast-math, so no floating-point
// contraction) by cluster_tools_tpu_torch/build.py and bound with ctypes in
// cluster_tools_tpu_torch/native.py.  C ABI only; arrays are raw pointers
// from numpy.  No function keeps static or shared mutable state: callers
// run them from several threads at once.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// path-halving find over an int64 parent array
inline int64_t find_root(std::vector<int64_t>& parent, int64_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];
    x = parent[x];
  }
  return x;
}

}  // namespace

extern "C" {

// Union-find over equivalence pairs; writes, for every label in
// [0, n_labels), the minimum label of its component — the same contract as
// the Python union_find_host.  Returns 0 on success.
int ct_union_find(const int64_t* pairs, int64_t n_pairs, int64_t n_labels,
                  int64_t* out_roots) {
  std::vector<int64_t> parent(n_labels);
  for (int64_t i = 0; i < n_labels; ++i) parent[i] = i;
  for (int64_t i = 0; i < n_pairs; ++i) {
    int64_t u = pairs[2 * i], v = pairs[2 * i + 1];
    if (u < 0 || v < 0 || u >= n_labels || v >= n_labels) continue;
    int64_t ru = find_root(parent, u), rv = find_root(parent, v);
    if (ru == rv) continue;
    // union by min so roots are component minima without a second pass
    if (ru < rv)
      parent[rv] = ru;
    else
      parent[ru] = rv;
  }
  for (int64_t i = 0; i < n_labels; ++i) out_roots[i] = find_root(parent, i);
  return 0;
}

// Greedy additive edge contraction (GAEC).  edges: [n_edges, 2] int64,
// costs: [n_edges] double.  Writes consecutive labels 0..k-1 to out_labels
// [n_nodes].  Matches the Python greedy_additive (ops/multicut.py) —
// contract the highest-cost edge while > stop_cost, parallel edges add.
int ct_greedy_additive(int64_t n_nodes, const int64_t* edges,
                       const double* costs, int64_t n_edges, double stop_cost,
                       int64_t* out_labels) {
  std::vector<int64_t> parent(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;
  std::vector<std::unordered_map<int64_t, double>> nbrs(n_nodes);
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t u = edges[2 * i], v = edges[2 * i + 1];
    if (u == v || u < 0 || v < 0 || u >= n_nodes || v >= n_nodes) continue;
    nbrs[u][v] += costs[i];
    nbrs[v][u] = nbrs[u][v];
  }
  struct Entry {
    double w;
    int64_t u, v;
    // deterministic tie-break on equal costs: the smallest (u, v) pair
    // pops first, matching Python heapq's (-w, u, v) tuple order so the
    // two paths contract in the same documented order across platforms
    bool operator<(const Entry& o) const {
      if (w != o.w) return w < o.w;
      if (u != o.u) return u > o.u;
      return v > o.v;
    }
  };
  std::priority_queue<Entry> heap;
  for (int64_t u = 0; u < n_nodes; ++u)
    for (auto& kv : nbrs[u])
      if (u < kv.first) heap.push({kv.second, u, kv.first});

  while (!heap.empty()) {
    Entry e = heap.top();
    heap.pop();
    if (e.w <= stop_cost) break;
    int64_t ru = find_root(parent, e.u), rv = find_root(parent, e.v);
    if (ru == rv) continue;
    auto it = nbrs[ru].find(rv);
    if (it == nbrs[ru].end() || it->second != e.w) continue;  // stale
    if (nbrs[ru].size() < nbrs[rv].size()) std::swap(ru, rv);
    parent[rv] = ru;
    nbrs[ru].erase(rv);
    for (auto& kv : nbrs[rv]) {
      int64_t x = kv.first;
      if (x == ru) continue;
      double nw = nbrs[ru][x] + kv.second;  // default 0.0 + w
      nbrs[ru][x] = nw;
      nbrs[x][ru] = nw;
      nbrs[x].erase(rv);
      if (nw > stop_cost) heap.push({nw, ru, x});
    }
    nbrs[rv].clear();
  }

  // consecutive relabeling of roots, ordered by root id (matches
  // np.unique(roots, return_inverse=True))
  std::vector<int64_t> roots(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) roots[i] = find_root(parent, i);
  std::vector<int64_t> sorted_roots;
  sorted_roots.reserve(n_nodes);
  {
    std::vector<bool> is_root(n_nodes, false);
    for (int64_t i = 0; i < n_nodes; ++i) is_root[roots[i]] = true;
    for (int64_t i = 0; i < n_nodes; ++i)
      if (is_root[i]) sorted_roots.push_back(i);
  }
  std::unordered_map<int64_t, int64_t> dense;
  dense.reserve(sorted_roots.size() * 2);
  for (size_t i = 0; i < sorted_roots.size(); ++i)
    dense[sorted_roots[i]] = static_cast<int64_t>(i);
  for (int64_t i = 0; i < n_nodes; ++i) out_labels[i] = dense[roots[i]];
  return 0;
}

// Merge per-block edge features onto a global lexsorted edge table.
// pairs: [m, 2] uint64 (lo, hi); feats: [m, 5] double rows
// (mean, min, max, count, variance); table: [k, 2] uint64 lexsorted unique
// edges.  Returns the number of pairs not found in the table.
// Streaming (Chan) combine: `means` carries the running count-weighted
// mean, `m2s` the running second moment about it (var * n).  Avoids
// reconstructing E[x^2] = var + mean^2, whose float cancellation loses
// several digits of merged variance for large-mean data.
int64_t ct_merge_edge_features(const uint64_t* pairs, const double* feats,
                               int64_t m, const uint64_t* table, int64_t k,
                               double* means, double* m2s, double* mins,
                               double* maxs, double* counts) {
  int64_t unmatched = 0;
  for (int64_t i = 0; i < m; ++i) {
    uint64_t lo = pairs[2 * i], hi = pairs[2 * i + 1];
    int64_t a = 0, b = k;
    while (a < b) {
      int64_t mid = (a + b) / 2;
      uint64_t tl = table[2 * mid], th = table[2 * mid + 1];
      if (tl < lo || (tl == lo && th < hi))
        a = mid + 1;
      else
        b = mid;
    }
    if (a >= k || table[2 * a] != lo || table[2 * a + 1] != hi) {
      ++unmatched;
      continue;
    }
    double mean = feats[5 * i], mn = feats[5 * i + 1], mx = feats[5 * i + 2],
           cnt = feats[5 * i + 3], var = feats[5 * i + 4];
    if (cnt <= 0) continue;
    double na = counts[a], ntot = na + cnt;
    double delta = mean - means[a];
    means[a] += delta * cnt / ntot;
    m2s[a] += var * cnt + delta * delta * na * cnt / ntot;
    if (mn < mins[a]) mins[a] = mn;
    if (mx > maxs[a]) maxs[a] = mx;
    counts[a] = ntot;
  }
  return unmatched;
}

// Mutex watershed constraint loop (Wolf et al.; the affogato capability,
// SURVEY.md §2b).  Edges arrive PRE-SORTED by decreasing priority via
// `order` (numpy argsort on the host — the regular, vectorizable part).
// Attractive edges union their endpoint clusters unless a mutex forbids
// it; repulsive edges install a mutex between the clusters.  Mutex sets
// merge small-into-large.  Writes per-node component roots to out_roots.
int ct_mutex_watershed(int64_t n_nodes, const int64_t* u, const int64_t* v,
                       const uint8_t* is_attractive, const int64_t* order,
                       int64_t n_edges, int64_t* out_roots) {
  std::vector<int64_t> parent(n_nodes);
  std::vector<int8_t> rank(n_nodes, 0);
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;
  // per-root mutex partners; roots without constraints hold no entry
  std::unordered_map<int64_t, std::unordered_set<int64_t>> mutexes;

  auto has_mutex = [&](int64_t ra, int64_t rb) {
    auto it = mutexes.find(ra);
    return it != mutexes.end() && it->second.count(rb) > 0;
  };

  for (int64_t k = 0; k < n_edges; ++k) {
    const int64_t e = order[k];
    int64_t ru = find_root(parent, u[e]);
    int64_t rv = find_root(parent, v[e]);
    if (ru == rv) continue;
    if (is_attractive[e]) {
      // check against the smaller mutex set
      auto iu = mutexes.find(ru), iv = mutexes.find(rv);
      size_t su = iu == mutexes.end() ? 0 : iu->second.size();
      size_t sv = iv == mutexes.end() ? 0 : iv->second.size();
      if (su <= sv ? has_mutex(ru, rv) : has_mutex(rv, ru)) continue;
      // union by rank
      if (rank[ru] < rank[rv]) std::swap(ru, rv);
      else if (rank[ru] == rank[rv]) ++rank[ru];
      parent[rv] = ru;
      // fold rv's mutex set into ru's (small set moves), updating partners
      auto ib = mutexes.find(rv);
      if (ib != mutexes.end()) {
        auto moved = std::move(ib->second);
        mutexes.erase(ib);
        auto& ma = mutexes[ru];
        for (int64_t x : moved) {
          auto ix = mutexes.find(x);
          if (ix != mutexes.end()) {
            ix->second.erase(rv);
            ix->second.insert(ru);
          }
          ma.insert(x);
        }
      }
    } else {
      mutexes[ru].insert(rv);
      mutexes[rv].insert(ru);
    }
  }
  for (int64_t i = 0; i < n_nodes; ++i) out_roots[i] = find_root(parent, i);
  return 0;
}

// Kernighan-Lin multicut refinement (Keuper et al.'s KLj scheme) — the
// native port of ops/multicut.py::kernighan_lin's sweep, kept operation-
// for-operation parallel so the two paths can be parity-tested:
// per adjacent-partition pair, build the gain sequence (every member
// tentatively flipped once, best-gain-first, negative gains included),
// apply the best positive prefix or the outright join, whichever is better.
// labels: in = initial partition (e.g. GAEC), out = refined; returns the
// number of outer sweeps executed.
int ct_kernighan_lin(int64_t n_nodes, const int64_t* edges,
                     const double* costs, int64_t n_edges, int64_t* labels,
                     int64_t max_outer, double epsilon) {
  // CSR adjacency (both directions, original edge order preserved)
  std::vector<int64_t> deg(n_nodes, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t u = edges[2 * e], v = edges[2 * e + 1];
    if (u == v) continue;
    ++deg[u];
    ++deg[v];
  }
  std::vector<int64_t> off(n_nodes + 1, 0);
  for (int64_t i = 0; i < n_nodes; ++i) off[i + 1] = off[i] + deg[i];
  std::vector<int64_t> nbr(off[n_nodes]);
  std::vector<double> wgt(off[n_nodes]);
  {
    std::vector<int64_t> pos(off.begin(), off.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e) {
      int64_t u = edges[2 * e], v = edges[2 * e + 1];
      if (u == v) continue;
      nbr[pos[u]] = v;
      wgt[pos[u]++] = costs[e];
      nbr[pos[v]] = u;
      wgt[pos[v]++] = costs[e];
    }
  }

  // scratch reused across pairs: node -> index within the current pair
  // (-1 = not in pair), sized once
  std::vector<int64_t> in_pair(n_nodes, -1);

  for (int64_t outer = 0; outer < max_outer; ++outer) {
    // members per label, rebuilt each sweep and maintained across pairs
    std::unordered_map<int64_t, std::vector<int64_t>> members;
    for (int64_t i = 0; i < n_nodes; ++i) members[labels[i]].push_back(i);

    // adjacent label pairs from the current cut, sorted for determinism
    std::vector<std::pair<int64_t, int64_t>> pairs;
    {
      std::unordered_set<uint64_t> seen;
      for (int64_t e = 0; e < n_edges; ++e) {
        int64_t lu = labels[edges[2 * e]], lv = labels[edges[2 * e + 1]];
        if (lu == lv) continue;
        int64_t a = lu < lv ? lu : lv, b = lu < lv ? lv : lu;
        uint64_t key = (static_cast<uint64_t>(a) << 32) ^
                       static_cast<uint64_t>(b & 0xffffffff);
        if (seen.insert(key).second) pairs.emplace_back(a, b);
      }
      std::sort(pairs.begin(), pairs.end());
    }

    double improved = 0.0;
    for (auto [la, lb] : pairs) {
      auto ita = members.find(la);
      auto itb = members.find(lb);
      if (ita == members.end() || itb == members.end()) continue;
      std::vector<int64_t>& va = ita->second;
      std::vector<int64_t>& vb = itb->second;
      if (va.empty() || vb.empty()) continue;

      const int64_t ka = static_cast<int64_t>(va.size());
      const int64_t k = ka + static_cast<int64_t>(vb.size());
      std::vector<int64_t> mem;
      mem.reserve(k);
      mem.insert(mem.end(), va.begin(), va.end());
      mem.insert(mem.end(), vb.begin(), vb.end());
      for (int64_t i = 0; i < k; ++i) in_pair[mem[i]] = i;
      std::vector<int8_t> side(k);
      for (int64_t i = 0; i < k; ++i) side[i] = i < ka ? 0 : 1;

      // D[i] = gain of flipping member i; cut_ab = join gain
      std::vector<double> d(k, 0.0);
      double cut_ab = 0.0;
      for (int64_t i = 0; i < k; ++i) {
        int64_t u = mem[i];
        for (int64_t p = off[u]; p < off[u + 1]; ++p) {
          int64_t j = in_pair[nbr[p]];
          if (j < 0) continue;
          if (side[j] == side[i]) {
            d[i] -= wgt[p];
          } else {
            d[i] += wgt[p];
            if (i < j) cut_ab += wgt[p];
          }
        }
      }
      const double join_gain = cut_ab;

      // tentative sequence, rolled back to the best prefix.  Lazy max-heap
      // ordered by (gain desc, index asc) — identical pop order to a linear
      // argmax scan (numpy's first-max tie-break), O(k log k) instead of
      // O(k^2) so giant partitions stay tractable; stale entries (gain no
      // longer current) are skipped on pop.
      std::vector<char> moved(k, 0);
      std::vector<int64_t> order;
      order.reserve(k);
      using HeapEntry = std::pair<double, int64_t>;  // (gain, -index)
      std::priority_queue<HeapEntry> heap;
      for (int64_t i = 0; i < k; ++i) heap.emplace(d[i], -i);
      double cum = 0.0, best_gain = -1e300;
      int64_t best_k = 0;
      for (int64_t step = 0; step < k; ++step) {
        int64_t best_i = -1;
        while (true) {
          HeapEntry top = heap.top();
          heap.pop();
          int64_t i = -top.second;
          if (!moved[i] && top.first == d[i]) {
            best_i = i;
            break;
          }
        }
        moved[best_i] = 1;
        order.push_back(best_i);
        cum += d[best_i];
        if (cum > best_gain) {
          best_gain = cum;
          best_k = step + 1;
        }
        int64_t u = mem[best_i];
        int8_t old_side = side[best_i];
        side[best_i] = 1 - old_side;
        for (int64_t p = off[u]; p < off[u + 1]; ++p) {
          int64_t j = in_pair[nbr[p]];
          if (j < 0 || moved[j]) continue;
          d[j] += side[j] == old_side ? 2.0 * wgt[p] : -2.0 * wgt[p];
          heap.emplace(d[j], -j);
        }
      }

      // member lists stay sorted by node id so the A-then-B member order
      // (and with it every float accumulation and argmax tie-break) matches
      // the Python path's np.where-derived lists exactly
      if (join_gain > best_gain && join_gain > epsilon) {
        for (int64_t u : vb) labels[u] = la;
        const int64_t mid = static_cast<int64_t>(va.size());
        va.insert(va.end(), vb.begin(), vb.end());
        std::inplace_merge(va.begin(), va.begin() + mid, va.end());
        vb.clear();
        improved += join_gain;
      } else if (best_gain > epsilon && best_k != k) {
        // (flipping ALL nodes is a relabeling no-op — skip, as in Python)
        for (int64_t s = 0; s < best_k; ++s) {
          int64_t u = mem[order[s]];
          labels[u] = labels[u] == la ? lb : la;
        }
        va.clear();
        vb.clear();
        for (int64_t i = 0; i < k; ++i)
          (labels[mem[i]] == la ? va : vb).push_back(mem[i]);
        std::sort(va.begin(), va.end());
        std::sort(vb.begin(), vb.end());
        improved += best_gain;
      }
      for (int64_t i = 0; i < k; ++i) in_pair[mem[i]] = -1;
    }
    if (improved <= epsilon) return static_cast<int>(outer + 1);
  }
  return static_cast<int>(max_outer);
}

// Round-based parallel edge contraction (ops/contraction.py's native twin,
// kept operation-for-operation parallel with the numpy reference so the two
// are bit-identical in float64): each round every node picks its best
// incident contractible edge (max priority, smallest edge id on ties —
// after canonical re-aggregation edge ids are the (lo, hi)-lexsorted row
// order, so the tie-break is a documented total order), mutually-selected
// pairs contract (a matching — depth-1 parents), endpoints remap and
// parallel edges merge by stable-order accumulation (the same summation
// order as numpy's bincount over the original edge sequence).
//
// edges: [m, 2] int64; payload: [m, k] double columns summed on merge
// (k == 1: GAEC cost = priority; k == 2: (weight*size, size), priority =
// ratio).  mode_max != 0 contracts while priority > threshold, else while
// priority < threshold.  Writes consecutive labels 0..c-1 to out_labels.
int ct_parallel_contract(int64_t n_nodes, const int64_t* edges,
                         const double* payload, int64_t m, int64_t k,
                         int mode_max, double threshold,
                         int64_t* out_labels) {
  const double sign = mode_max ? 1.0 : -1.0;
  const double thr = sign * threshold;

  std::vector<int64_t> u, v;
  std::vector<double> pay;  // row-major [n_edges, k]
  u.reserve(m);
  v.reserve(m);
  pay.reserve(m * k);

  // canonicalize + merge parallel edges: stable sort of row indices by
  // (lo, hi), then accumulate payload in ORIGINAL edge order per group
  // (numpy bincount order, so float sums match the reference exactly)
  auto dedup = [&](std::vector<int64_t>& eu, std::vector<int64_t>& ev,
                   std::vector<double>& ep) {
    const int64_t n = static_cast<int64_t>(eu.size());
    std::vector<int64_t> idx;
    idx.reserve(n);
    for (int64_t i = 0; i < n; ++i)
      if (eu[i] != ev[i]) idx.push_back(i);
    std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
      int64_t la = std::min(eu[a], ev[a]), ha = std::max(eu[a], ev[a]);
      int64_t lb = std::min(eu[b], ev[b]), hb = std::max(eu[b], ev[b]);
      return la < lb || (la == lb && ha < hb);
    });
    // group id per original row, groups in (lo, hi) order
    std::vector<int64_t> group(n, -1);
    std::vector<int64_t> glo, ghi;
    int64_t g = -1;
    int64_t prev_lo = -1, prev_hi = -1;
    for (int64_t i : idx) {
      int64_t lo = std::min(eu[i], ev[i]), hi = std::max(eu[i], ev[i]);
      if (lo != prev_lo || hi != prev_hi) {
        ++g;
        glo.push_back(lo);
        ghi.push_back(hi);
        prev_lo = lo;
        prev_hi = hi;
      }
      group[i] = g;
    }
    std::vector<double> gpay((g + 1) * k, 0.0);
    for (int64_t i = 0; i < n; ++i) {
      if (group[i] < 0) continue;  // self edge
      for (int64_t c = 0; c < k; ++c) gpay[group[i] * k + c] += ep[i * k + c];
    }
    eu.swap(glo);
    ev.swap(ghi);
    ep.swap(gpay);
  };

  {
    std::vector<int64_t> eu(m), ev(m);
    std::vector<double> ep(m * k);
    for (int64_t i = 0; i < m; ++i) {
      eu[i] = edges[2 * i];
      ev[i] = edges[2 * i + 1];
      for (int64_t c = 0; c < k; ++c) ep[i * k + c] = payload[i * k + c];
    }
    dedup(eu, ev, ep);
    u.swap(eu);
    v.swap(ev);
    pay.swap(ep);
  }

  std::vector<int64_t> labels(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) labels[i] = i;
  std::vector<double> best_p(n_nodes);
  std::vector<int64_t> best_e(n_nodes), root(n_nodes);
  std::vector<double> prio;

  while (!u.empty()) {
    const int64_t ne = static_cast<int64_t>(u.size());
    prio.assign(ne, 0.0);
    bool any_elig = false;
    for (int64_t e = 0; e < ne; ++e) {
      double p = k == 1 ? pay[e * k]
                        : pay[e * k] / std::max(pay[e * k + 1], 1e-300);
      prio[e] = sign * p;
      any_elig |= prio[e] > thr;
    }
    if (!any_elig) break;
    std::fill(best_p.begin(), best_p.end(), -1e300);
    for (int64_t e = 0; e < ne; ++e) {
      if (prio[e] <= thr) continue;
      best_p[u[e]] = std::max(best_p[u[e]], prio[e]);
      best_p[v[e]] = std::max(best_p[v[e]], prio[e]);
    }
    std::fill(best_e.begin(), best_e.end(), ne);
    for (int64_t e = 0; e < ne; ++e) {
      if (prio[e] <= thr) continue;
      if (prio[e] == best_p[u[e]]) best_e[u[e]] = std::min(best_e[u[e]], e);
      if (prio[e] == best_p[v[e]]) best_e[v[e]] = std::min(best_e[v[e]], e);
    }
    for (int64_t i = 0; i < n_nodes; ++i) root[i] = i;
    for (int64_t e = 0; e < ne; ++e)
      if (prio[e] > thr && best_e[u[e]] == e && best_e[v[e]] == e)
        root[v[e]] = u[e];  // matching: depth-1 parents
    for (int64_t i = 0; i < n_nodes; ++i) labels[i] = root[labels[i]];
    for (int64_t e = 0; e < ne; ++e) {
      u[e] = root[u[e]];
      v[e] = root[v[e]];
    }
    dedup(u, v, pay);
  }

  // consecutive relabel, root-id ascending (np.unique semantics)
  std::vector<int64_t> dense(n_nodes, -1);
  for (int64_t i = 0; i < n_nodes; ++i) dense[labels[i]] = -2;  // mark roots
  int64_t next = 0;
  for (int64_t r = 0; r < n_nodes; ++r)
    if (dense[r] == -2) dense[r] = next++;
  for (int64_t i = 0; i < n_nodes; ++i) out_labels[i] = dense[labels[i]];
  return 0;
}

// Exact squared Euclidean distance transform of a 3-D binary mask
// (distance from each foreground voxel to the nearest background voxel,
// anisotropic sampling, optional cap), Felzenszwalb-Huttenlocher
// separable lower-envelope — O(n) per axis.  The host twin of the device
// EDT (ops/edt.py); scipy's generic kd-tree-free EDT runs ~2M vox/s
// where this runs tens of M vox/s, which is what lets the shipped host
// pipeline beat the reference-equivalent scipy baseline (bench.py).
//
// fg: [nz*ny*nx] uint8 (1 = foreground), out: float32 squared distances
// (0 on background).  sz/sy/sx: per-axis voxel size.  cap_sq > 0 clips
// the result (matching the device kernels' capped transform).
int ct_edt_sq(const uint8_t* fg, int64_t nz, int64_t ny, int64_t nx,
              double sz, double sy, double sx, double cap_sq, float* out) {
  const int64_t n = nz * ny * nx;
  const double kInf = 1e30;
  std::vector<double> f(n);
  // pass 1 (x, contiguous): two-sweep 1-D distance in voxel units
  for (int64_t zy = 0; zy < nz * ny; ++zy) {
    const uint8_t* row = fg + zy * nx;
    double* o = f.data() + zy * nx;
    double d = kInf;
    for (int64_t i = 0; i < nx; ++i) {
      d = row[i] ? d + 1.0 : 0.0;
      o[i] = d;
    }
    d = kInf;
    for (int64_t i = nx - 1; i >= 0; --i) {
      d = row[i] ? std::min(o[i], d + 1.0) : 0.0;
      o[i] = d;
      if (d >= kInf) d = kInf;  // keep all-foreground rows saturated
    }
    for (int64_t i = 0; i < nx; ++i)
      o[i] = o[i] >= kInf ? kInf : o[i] * sx * o[i] * sx;
  }
  // passes 2/3 (y then z): lower envelope of parabolas over the current
  // squared distances, strided access gathered into a scratch line
  auto envelope_pass = [&](int64_t len, int64_t stride, double s,
                           double* line, double* dist, int64_t* vx,
                           double* zx, double* base) {
    for (int64_t i = 0; i < len; ++i) line[i] = base[i * stride];
    // parabolas with saturated (kInf) bases never win — build the
    // envelope over finite entries only; if none exist the line is
    // unreachable in-plane and a later pass (or the cap) resolves it
    int64_t q0 = 0;
    while (q0 < len && line[q0] >= kInf) ++q0;
    if (q0 == len) return;
    int64_t k = 0;
    vx[0] = q0;
    zx[0] = -kInf;
    zx[1] = kInf;
    const double s2 = s * s;
    for (int64_t q = q0 + 1; q < len; ++q) {
      if (line[q] >= kInf) continue;
      const double qq = static_cast<double>(q);
      while (true) {
        const double vq = static_cast<double>(vx[k]);
        const double inter =
            (line[q] - line[vx[k]] + s2 * (qq * qq - vq * vq)) /
            (2.0 * s2 * (qq - vq));
        if (inter <= zx[k]) {  // zx[0] = -inf: never pops the last vertex
          --k;
          continue;
        }
        ++k;
        vx[k] = q;
        zx[k] = inter;
        zx[k + 1] = kInf;
        break;
      }
    }
    int64_t j = 0;
    for (int64_t q = 0; q < len; ++q) {
      const double qq = static_cast<double>(q);
      while (zx[j + 1] < qq) ++j;
      const double dv = qq - static_cast<double>(vx[j]);
      dist[q] = s2 * dv * dv + line[vx[j]];
    }
    for (int64_t i = 0; i < len; ++i) base[i * stride] = dist[i];
  };
  {
    const int64_t len = ny > nz ? ny : nz;
    std::vector<double> line(len), dist(len), zx(len + 1);
    std::vector<int64_t> vx(len);
    for (int64_t z = 0; z < nz; ++z)
      for (int64_t x = 0; x < nx; ++x)
        envelope_pass(ny, nx, sy, line.data(), dist.data(), vx.data(),
                      zx.data(), f.data() + z * ny * nx + x);
    for (int64_t y = 0; y < ny; ++y)
      for (int64_t x = 0; x < nx; ++x)
        envelope_pass(nz, ny * nx, sz, line.data(), dist.data(), vx.data(),
                      zx.data(), f.data() + y * nx + x);
  }
  for (int64_t i = 0; i < n; ++i) {
    double d = fg[i] ? f[i] : 0.0;
    if (cap_sq > 0.0 && d > cap_sq) d = cap_sq;
    out[i] = static_cast<float>(d >= kInf ? (cap_sq > 0 ? cap_sq : kInf) : d);
  }
  return 0;
}

// Seeded watershed by 256-level bucket-queue priority flood,
// 6-connectivity — the host twin of the device MSF watershed
// (ops/tile_ws.py) and the replacement for scipy's watershed_ift in the
// shipped host pipeline (same uint8 priority map, ~10x the throughput).
// A voxel is claimed by the first neighbor popped at the lowest
// priority; ties resolve FIFO within a level, matching the device
// kernel's deterministic lex-min flavor closely enough for the
// segmentation oracles (semantic, not bit-exact, twin — ops/host.py).
//
// hmap: [n] uint8 priorities; fg: [n] uint8 mask; labels: int32 in-out
// (in: seeds > 0, 0 = unassigned; out: flooded labels, 0 outside fg).
int ct_ws_flood(const uint8_t* hmap, const uint8_t* fg, int32_t* labels,
                int64_t nz, int64_t ny, int64_t nx) {
  const int64_t n = nz * ny * nx;
  std::vector<std::vector<int64_t>> bucket(256);
  // head index per bucket: pops are FIFO and nothing is ever re-pushed
  // at a lower level (priority = max(level, hmap[nb]) is monotone)
  std::vector<size_t> head(256, 0);
  for (int64_t i = 0; i < n; ++i)
    if (labels[i] > 0 && fg[i]) bucket[hmap[i]].push_back(i);
  const int64_t sy_ = nx, sz_ = ny * nx;
  for (int lev = 0; lev < 256; ++lev) {
    auto& b = bucket[lev];
    while (head[lev] < b.size()) {
      const int64_t v = b[head[lev]++];
      const int32_t lab = labels[v];
      const int64_t z = v / sz_, y = (v / sy_) % ny, x = v % nx;
      const int64_t nb6[6] = {z > 0 ? v - sz_ : -1, z < nz - 1 ? v + sz_ : -1,
                              y > 0 ? v - sy_ : -1, y < ny - 1 ? v + sy_ : -1,
                              x > 0 ? v - 1 : -1,   x < nx - 1 ? v + 1 : -1};
      for (int k = 0; k < 6; ++k) {
        const int64_t u = nb6[k];
        if (u < 0 || labels[u] != 0 || !fg[u]) continue;
        labels[u] = lab;
        const int p = hmap[u] > lev ? hmap[u] : lev;
        bucket[p].push_back(u);
      }
    }
    b.clear();
    b.shrink_to_fit();
  }
  for (int64_t i = 0; i < n; ++i)
    if (!fg[i]) labels[i] = 0;
  return 0;
}

}  // extern "C"
