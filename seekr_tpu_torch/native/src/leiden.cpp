// seekr_tpu native Leiden community detection.
//
// C++ replacement for the libleidenalg/python-igraph stack the reference
// delegates to (seekr/kmer_leiden.py:106-146).  Implements the Leiden
// algorithm (Traag, Waltman, van Eck 2019): fast local moving with a work
// queue, constrained refinement inside communities, graph aggregation, and
// iteration to convergence — with the six quality functions the reference
// exposes: Modularity, RBConfiguration, RBER, CPM, Surprise, Significance.
//
// Exposed as a C ABI for ctypes; no external dependencies.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <random>
#include <string>
#include <vector>

namespace {

using std::int32_t;
using std::int64_t;

enum class Quality {
  kModularity,
  kRBConfig,
  kRBER,
  kCPM,
  kSurprise,
  kSignificance,
};

struct Graph {
  int64_t n = 0;
  std::vector<int64_t> off;    // CSR offsets [n+1]
  std::vector<int64_t> adj;    // neighbor ids (self excluded)
  std::vector<double> w;       // neighbor edge weights
  std::vector<double> self_w;  // self-loop weight per node
  std::vector<double> strength;  // sum of incident weights, self-loop *2
  std::vector<int64_t> size;     // number of original nodes represented
  double total_w = 0;            // sum of edge weights (each edge once)
  int64_t total_size = 0;        // number of original nodes

  void finalize() {
    strength.assign(n, 0.0);
    total_w = 0;
    for (int64_t v = 0; v < n; ++v) {
      double s = 2.0 * self_w[v];
      for (int64_t e = off[v]; e < off[v + 1]; ++e) s += w[e];
      strength[v] = s;
      total_w += self_w[v];
    }
    for (size_t e = 0; e < w.size(); ++e) total_w += 0.5 * w[e];
    total_size = 0;
    for (int64_t v = 0; v < n; ++v) total_size += size[v];
  }
};

// Community bookkeeping for one level.
struct Partition {
  std::vector<int64_t> comm;       // node -> community
  std::vector<double> comm_K;      // sum of member strengths
  std::vector<int64_t> comm_size;  // sum of member sizes (original nodes)
  std::vector<int64_t> comm_nodes; // number of member (level) nodes
  std::vector<double> comm_in;     // total internal edge weight (incl. selfs)
  std::vector<int64_t> free_slots; // lazily-maintained emptied communities
  double m_in = 0;                 // global internal weight
  double pairs_in = 0;             // sum over c of size_c*(size_c-1)/2

  void init_singletons(const Graph& g) {
    comm.resize(g.n);
    comm_K.assign(g.n, 0.0);
    comm_size.assign(g.n, 0);
    comm_nodes.assign(g.n, 0);
    comm_in.assign(g.n, 0.0);
    free_slots.clear();
    m_in = 0;
    pairs_in = 0;
    for (int64_t v = 0; v < g.n; ++v) {
      comm[v] = v;
      comm_K[v] = g.strength[v];
      comm_size[v] = g.size[v];
      comm_nodes[v] = 1;
      comm_in[v] = g.self_w[v];
      m_in += g.self_w[v];
      pairs_in += 0.5 * double(g.size[v]) * double(g.size[v] - 1);
    }
  }

  // Remove v from its community entirely (a removed node belongs to no
  // community: neither its cross pairs nor its own internal size-pairs and
  // self-loop weight are counted until insert()).
  void remove(const Graph& g, int64_t v, double w_v_comm) {
    int64_t c = comm[v];
    comm_K[c] -= g.strength[v];
    int64_t s = g.size[v];
    pairs_in -= double(s) * double(comm_size[c] - s);  // cross pairs
    pairs_in -= 0.5 * double(s) * double(s - 1);       // intra pairs of v
    comm_size[c] -= s;
    comm_nodes[c] -= 1;
    if (comm_nodes[c] == 0) free_slots.push_back(c);  // lazy: may refill
    comm_in[c] -= w_v_comm + g.self_w[v];
    m_in -= w_v_comm + g.self_w[v];
    comm[v] = -1;
  }

  void insert(const Graph& g, int64_t v, int64_t c, double w_v_c) {
    comm[v] = c;
    comm_K[c] += g.strength[v];
    int64_t s = g.size[v];
    pairs_in += double(s) * double(comm_size[c]);  // cross pairs
    pairs_in += 0.5 * double(s) * double(s - 1);   // intra pairs of v
    comm_size[c] += s;
    comm_nodes[c] += 1;
    comm_in[c] += w_v_c + g.self_w[v];
    m_in += w_v_c + g.self_w[v];
  }
};

double xlogy(double x, double y) { return x > 0 ? x * std::log(y) : 0.0; }

// KL divergence of Bernoulli(q) from Bernoulli(p).
double kl(double q, double p) {
  q = std::min(std::max(q, 0.0), 1.0);
  p = std::min(std::max(p, 1e-15), 1.0 - 1e-15);
  double r = 0;
  if (q > 0) r += q * std::log(q / p);
  if (q < 1) r += (1 - q) * std::log((1 - q) / (1 - p));
  return r;
}

class Leiden {
 public:
  Leiden(Quality q, double gamma, uint64_t seed)
      : quality_(q), gamma_(gamma), rng_(seed) {}

  double significance_comm(const Graph& g, double e_c, int64_t size_c) const {
    double pairs_c = 0.5 * double(size_c) * double(size_c - 1);
    if (pairs_c <= 0) return 0;
    double npairs = 0.5 * double(g.total_size) * double(g.total_size - 1);
    double p = npairs > 0 ? g.total_w / npairs : 0;
    return pairs_c * kl(e_c / pairs_c, p);
  }

  // Gain of inserting node v (already removed) into community c, relative to
  // leaving v in its own empty community.
  double gain(const Graph& g, const Partition& p, int64_t v, int64_t c,
              double w_v_c) const {
    switch (quality_) {
      case Quality::kModularity: {
        double m2 = 2.0 * g.total_w;
        if (m2 <= 0) return 0;
        return w_v_c - g.strength[v] * p.comm_K[c] / m2;
      }
      case Quality::kRBConfig: {
        double m2 = 2.0 * g.total_w;
        if (m2 <= 0) return 0;
        return w_v_c - gamma_ * g.strength[v] * p.comm_K[c] / m2;
      }
      case Quality::kRBER: {
        double npairs = 0.5 * double(g.total_size) * double(g.total_size - 1);
        double dens = npairs > 0 ? g.total_w / npairs : 0;
        return w_v_c - gamma_ * dens * double(g.size[v]) * double(p.comm_size[c]);
      }
      case Quality::kCPM:
        return w_v_c - gamma_ * double(g.size[v]) * double(p.comm_size[c]);
      case Quality::kSurprise: {
        // baseline: v alone as its own community (keeps its self-loops and
        // intra-size pairs); candidate: v joins c.
        double m = g.total_w;
        if (m <= 0) return 0;
        double npairs = 0.5 * double(g.total_size) * double(g.total_size - 1);
        double intra_v = 0.5 * double(g.size[v]) * double(g.size[v] - 1);
        double m_alone = p.m_in + g.self_w[v];
        double pairs_alone = p.pairs_in + intra_v;
        double base = m * kl(m_alone / m, npairs > 0 ? pairs_alone / npairs : 0);
        double m_in2 = m_alone + w_v_c;
        double pairs2 = pairs_alone + double(g.size[v]) * double(p.comm_size[c]);
        double now = m * kl(m_in2 / m, npairs > 0 ? pairs2 / npairs : 0);
        return now - base;
      }
      case Quality::kSignificance: {
        double before = significance_comm(g, p.comm_in[c], p.comm_size[c]) +
                        significance_comm(g, g.self_w[v], g.size[v]);
        double after = significance_comm(g, p.comm_in[c] + w_v_c + g.self_w[v],
                                         p.comm_size[c] + g.size[v]);
        return after - before;
      }
    }
    return 0;
  }

  // Fast local move phase. Returns number of moves performed.
  int64_t move_nodes(const Graph& g, Partition& p) {
    std::vector<int64_t> order(g.n);
    for (int64_t i = 0; i < g.n; ++i) order[i] = i;
    std::shuffle(order.begin(), order.end(), rng_);
    std::deque<int64_t> queue(order.begin(), order.end());
    std::vector<char> in_queue(g.n, 1);

    std::vector<double> w_to(g.n, 0.0);  // scratch: weight to community
    std::vector<int64_t> touched;
    int64_t n_moves = 0;

    while (!queue.empty()) {
      int64_t v = queue.front();
      queue.pop_front();
      in_queue[v] = 0;

      touched.clear();
      for (int64_t e = g.off[v]; e < g.off[v + 1]; ++e) {
        int64_t c = p.comm[g.adj[e]];
        if (w_to[c] == 0.0) touched.push_back(c);
        w_to[c] += g.w[e];
      }
      int64_t c_old = p.comm[v];
      double w_old = w_to[c_old];
      p.remove(g, v, w_old);

      // candidate: stay alone (gain 0) vs every neighboring community;
      // prefer the old community on ties to avoid oscillation
      int64_t best_c = -1;
      double best_gain = 0.0;
      double gain_old = 0.0;
      for (int64_t c : touched) {
        double gn = gain(g, p, v, c, w_to[c]);
        if (c == c_old) gain_old = gn;
        if (gn > best_gain + 1e-12) {
          best_gain = gn;
          best_c = c;
        }
      }
      if (best_c != -1 && w_old > 0 && best_gain <= gain_old + 1e-12) {
        best_c = c_old;
      }
      if (best_c == -1) {
        // empty community: reuse v's own slot (guaranteed empty only if v
        // was a singleton; otherwise find a free community id)
        best_c = (p.comm_nodes[c_old] == 0) ? c_old : free_comm(p);
      }
      p.insert(g, v, best_c, w_to[best_c]);

      if (best_c != c_old) {
        ++n_moves;
        for (int64_t e = g.off[v]; e < g.off[v + 1]; ++e) {
          int64_t u = g.adj[e];
          if (p.comm[u] != best_c && !in_queue[u]) {
            queue.push_back(u);
            in_queue[u] = 1;
          }
        }
      }
      for (int64_t c : touched) w_to[c] = 0.0;
      w_to[best_c] = 0.0;
    }
    return n_moves;
  }

  // Refinement: merge singletons within each community of `p`.
  // Produces the refined partition used for aggregation.
  void refine(const Graph& g, const Partition& p, Partition& refined) {
    refined.init_singletons(g);
    std::vector<int64_t> order(g.n);
    for (int64_t i = 0; i < g.n; ++i) order[i] = i;
    std::shuffle(order.begin(), order.end(), rng_);

    std::vector<double> w_to(g.n, 0.0);
    std::vector<int64_t> touched;

    for (int64_t v : order) {
      if (refined.comm_nodes[refined.comm[v]] > 1) continue;  // already merged
      touched.clear();
      for (int64_t e = g.off[v]; e < g.off[v + 1]; ++e) {
        int64_t u = g.adj[e];
        if (p.comm[u] != p.comm[v]) continue;  // constrained to community
        int64_t c = refined.comm[u];
        if (c == refined.comm[v]) continue;
        if (w_to[c] == 0.0) touched.push_back(c);
        w_to[c] += g.w[e];
      }
      if (touched.empty()) continue;
      int64_t c_self = refined.comm[v];
      refined.remove(g, v, 0.0);
      int64_t best_c = -1;
      double best_gain = 0.0;
      for (int64_t c : touched) {
        double gn = gain(g, refined, v, c, w_to[c]);
        if (gn > best_gain + 1e-12) {
          best_gain = gn;
          best_c = c;
        }
      }
      if (best_c == -1) best_c = c_self;
      refined.insert(g, v, best_c, best_c == c_self ? 0.0 : w_to[best_c]);
      for (int64_t c : touched) w_to[c] = 0.0;
    }
  }

  // Collapse graph on refined partition; map old membership onto aggregate.
  static Graph aggregate(const Graph& g, const Partition& refined,
                         const Partition& p, std::vector<int64_t>& node_of,
                         std::vector<int64_t>& agg_init_comm) {
    // compact community ids
    std::vector<int64_t> new_id(g.n, -1);
    int64_t nc = 0;
    for (int64_t v = 0; v < g.n; ++v) {
      int64_t c = refined.comm[v];
      if (new_id[c] == -1) new_id[c] = nc++;
    }
    node_of.resize(g.n);
    for (int64_t v = 0; v < g.n; ++v) node_of[v] = new_id[refined.comm[v]];

    Graph a;
    a.n = nc;
    a.self_w.assign(nc, 0.0);
    a.size.assign(nc, 0);
    agg_init_comm.assign(nc, -1);
    for (int64_t v = 0; v < g.n; ++v) {
      int64_t c = node_of[v];
      a.size[c] += g.size[v];
      a.self_w[c] += g.self_w[v];
      agg_init_comm[c] = p.comm[v];
    }
    // accumulate cross edges with a hash-free two-pass (map per node)
    std::vector<std::vector<std::pair<int64_t, double>>> buckets(nc);
    for (int64_t v = 0; v < g.n; ++v) {
      int64_t cv = node_of[v];
      for (int64_t e = g.off[v]; e < g.off[v + 1]; ++e) {
        int64_t cu = node_of[g.adj[e]];
        if (cu == cv) {
          a.self_w[cv] += 0.5 * g.w[e];  // each internal edge seen twice
        } else {
          buckets[cv].emplace_back(cu, g.w[e]);
        }
      }
    }
    a.off.assign(nc + 1, 0);
    for (int64_t c = 0; c < nc; ++c) {
      auto& b = buckets[c];
      std::sort(b.begin(), b.end());
      // merge duplicates
      size_t out = 0;
      for (size_t i = 0; i < b.size();) {
        int64_t u = b[i].first;
        double s = 0;
        while (i < b.size() && b[i].first == u) s += b[i++].second;
        b[out++] = {u, s};
      }
      b.resize(out);
      a.off[c + 1] = a.off[c] + int64_t(out);
    }
    a.adj.resize(a.off[nc]);
    a.w.resize(a.off[nc]);
    for (int64_t c = 0; c < nc; ++c) {
      int64_t base = a.off[c];
      for (size_t i = 0; i < buckets[c].size(); ++i) {
        a.adj[base + int64_t(i)] = buckets[c][i].first;
        a.w[base + int64_t(i)] = buckets[c][i].second;
      }
    }
    a.finalize();
    return a;
  }

  // Full Leiden loop; returns membership (compacted) for the original nodes.
  std::vector<int32_t> run(Graph g, int max_iters = 100) {
    int64_t n0 = g.n;
    std::vector<int64_t> map_to_orig(n0);
    for (int64_t i = 0; i < n0; ++i) map_to_orig[i] = i;
    std::vector<int64_t> final_comm(n0);

    Partition p;
    p.init_singletons(g);

    for (int iter = 0; iter < max_iters; ++iter) {
      int64_t moves = move_nodes(g, p);
      bool done = (moves == 0) || (count_comms(p, g.n) == g.n);
      if (done) break;

      Partition refined;
      refine(g, p, refined);
      std::vector<int64_t> node_of, agg_init;
      Graph a = aggregate(g, refined, p, node_of, agg_init);
      if (a.n == g.n) break;  // refinement didn't collapse anything

      // remap original-node tracking through this level
      for (int64_t i = 0; i < n0; ++i) map_to_orig[i] = node_of[map_to_orig[i]];

      // compact the carried-over community ids into [0, a.n)
      int64_t prev_n = g.n;
      std::vector<int64_t> remap(prev_n, -1);
      int64_t nc = 0;
      g = std::move(a);
      p.comm.assign(g.n, 0);
      for (int64_t v = 0; v < g.n; ++v) {
        if (remap[agg_init[v]] == -1) remap[agg_init[v]] = nc++;
        p.comm[v] = remap[agg_init[v]];
      }
      rebuild_aggregates(g, p);
    }

    for (int64_t i = 0; i < n0; ++i) final_comm[i] = p.comm[map_to_orig[i]];
    return compact(final_comm);
  }

 private:
  static int64_t count_comms(const Partition& p, int64_t n) {
    int64_t c = 0;
    for (int64_t v = 0; v < n; ++v)
      if (p.comm_nodes[v] > 0) ++c;
    return c;
  }

  static int64_t free_comm(Partition& p) {
    // pop lazily-recorded empty slots (a slot may have been refilled
    // since it was pushed; skip those) — O(1) amortized instead of the
    // O(n) scan that made the local-move phase O(n^2) worst case
    while (!p.free_slots.empty()) {
      int64_t c = p.free_slots.back();
      p.free_slots.pop_back();
      if (p.comm_nodes[c] == 0) return c;
    }
    for (size_t c = 0; c < p.comm_nodes.size(); ++c)  // safety fallback
      if (p.comm_nodes[c] == 0) return int64_t(c);
    return int64_t(p.comm_nodes.size() - 1);  // unreachable for n>=1
  }

  void rebuild_aggregates(const Graph& g, Partition& p) {
    p.comm_K.assign(g.n, 0.0);
    p.comm_size.assign(g.n, 0);
    p.comm_nodes.assign(g.n, 0);
    p.comm_in.assign(g.n, 0.0);
    p.m_in = 0;
    p.pairs_in = 0;
    for (int64_t v = 0; v < g.n; ++v) {
      int64_t c = p.comm[v];
      p.comm_K[c] += g.strength[v];
      p.comm_size[c] += g.size[v];
      p.comm_nodes[c] += 1;
      p.comm_in[c] += g.self_w[v];
      p.m_in += g.self_w[v];
    }
    for (int64_t v = 0; v < g.n; ++v) {
      int64_t c = p.comm[v];
      for (int64_t e = g.off[v]; e < g.off[v + 1]; ++e) {
        if (p.comm[g.adj[e]] == c) {
          p.comm_in[c] += 0.5 * g.w[e];
          p.m_in += 0.5 * g.w[e];
        }
      }
    }
    for (int64_t c = 0; c < g.n; ++c) {
      double s = double(p.comm_size[c]);
      p.pairs_in += 0.5 * s * (s - 1);
    }
    p.free_slots.clear();
    for (int64_t c = 0; c < g.n; ++c)
      if (p.comm_nodes[c] == 0) p.free_slots.push_back(c);
  }

  static std::vector<int32_t> compact(const std::vector<int64_t>& comm) {
    std::vector<int64_t> remap(comm.size(), -1);
    std::vector<int32_t> out(comm.size());
    int32_t next = 0;
    for (size_t i = 0; i < comm.size(); ++i) {
      int64_t c = comm[i];
      if (remap[c] == -1) remap[c] = next++;
      out[i] = int32_t(remap[c]);
    }
    return out;
  }

  Quality quality_;
  double gamma_;
  std::mt19937_64 rng_;
};

bool parse_quality(const char* s, Quality* out) {
  std::string q(s);
  if (q == "modularity" || q == "ModularityVertexPartition") *out = Quality::kModularity;
  else if (q == "rbconfig" || q == "RBConfigurationVertexPartition") *out = Quality::kRBConfig;
  else if (q == "rber" || q == "RBERVertexPartition") *out = Quality::kRBER;
  else if (q == "cpm" || q == "CPMVertexPartition") *out = Quality::kCPM;
  else if (q == "surprise" || q == "SurpriseVertexPartition") *out = Quality::kSurprise;
  else if (q == "significance" || q == "SignificanceVertexPartition") *out = Quality::kSignificance;
  else return false;
  return true;
}

}  // namespace

extern "C" {

// Undirected graph as an edge list (each edge once, u != v allowed to repeat
// as self loops). Writes per-node community ids (compacted, 0-based) into
// membership_out [n_nodes]. Returns the number of communities, -1 on
// invalid arguments, or -4 on an internal failure (CSR allocation for a
// hundreds-of-millions-edge list): exceptions must not cross the C ABI.
int64_t seekr_leiden(int64_t n_nodes, int64_t n_edges, const int64_t* src,
                     const int64_t* dst, const double* weight,
                     const char* quality, double resolution, int64_t seed,
                     int32_t* membership_out) {
  if (n_nodes <= 0 || n_edges < 0 || !membership_out || !quality) return -1;
  if (n_edges > 0 && (!src || !dst)) return -1;
  Quality q;
  if (!parse_quality(quality, &q)) return -1;
  try {

  // build CSR (symmetrize)
  Graph g;
  g.n = n_nodes;
  g.self_w.assign(n_nodes, 0.0);
  g.size.assign(n_nodes, 1);
  std::vector<int64_t> deg(n_nodes, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t u = src[e], v = dst[e];
    if (u < 0 || u >= n_nodes || v < 0 || v >= n_nodes) return -1;
    if (u == v) {
      g.self_w[u] += weight ? weight[e] : 1.0;
    } else {
      ++deg[u];
      ++deg[v];
    }
  }
  g.off.assign(n_nodes + 1, 0);
  for (int64_t v = 0; v < n_nodes; ++v) g.off[v + 1] = g.off[v] + deg[v];
  g.adj.resize(g.off[n_nodes]);
  g.w.resize(g.off[n_nodes]);
  std::vector<int64_t> fill(n_nodes, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t u = src[e], v = dst[e];
    if (u == v) continue;
    double ww = weight ? weight[e] : 1.0;
    g.adj[g.off[u] + fill[u]] = v;
    g.w[g.off[u] + fill[u]] = ww;
    ++fill[u];
    g.adj[g.off[v] + fill[v]] = u;
    g.w[g.off[v] + fill[v]] = ww;
    ++fill[v];
  }
  g.finalize();

  uint64_t rng_seed = seed >= 0 ? uint64_t(seed) : std::random_device{}();
  Leiden leiden(q, resolution, rng_seed);
  std::vector<int32_t> membership = leiden.run(std::move(g));
  std::memcpy(membership_out, membership.data(),
              sizeof(int32_t) * size_t(n_nodes));
  int32_t nc = 0;
  for (int64_t v = 0; v < n_nodes; ++v) nc = std::max(nc, membership[v]);
  return nc + 1;
  } catch (...) {
    return -4;
  }
}

}  // extern "C"
