// graphlet_orbits.cpp — native 4-node graphlet orbit counter.
//
// Clean-room replacement for the reference's vendored ORCA executable
// (ccsd/src/evaluation/orca/orca.cpp), providing identical per-node counts
// for the 15 node orbits of the 2-, 3- and 4-node graphlets (Przulj's
// numbering, the convention the reference's "orca node 4" output uses):
//
//   size 2: 0 = edge endpoint (degree)
//   size 3: 1 = P3 end, 2 = P3 middle, 3 = triangle
//   size 4: 4 = P4 end, 5 = P4 middle, 6 = claw leaf, 7 = claw center,
//           8 = C4, 9 = paw pendant, 10 = paw triangle (far),
//           11 = paw triangle (attached), 12 = diamond deg-2,
//           13 = diamond deg-3, 14 = K4
//
// Also provides the full 73-orbit "node 5" mode (orbits 15-72, the 21
// connected 5-node graphlets): 5-subgraphs are classified through a
// 1024-entry lookup table over their 10-bit edge mask (orbit5_table.inc,
// regenerated by tools/gen_orbit5_table.py from the standard Przulj
// numbering).
//
// Algorithm: ESU (Wernicke, FANMOD) enumeration of every connected induced
// subgraph of size <= 4 (or <= 5) exactly once, classified by its internal
// degree sequence (sizes 3-4) or the mask table (size 5).  For the dataset
// sizes here (n <= ~500, sparse) this is fast and obviously correct;
// cross-checked against a brute-force Python oracle and reference-ORCA
// golden outputs in tests/eval/test_orbits.py.
//
// Exposed both as a C shared-library entry point (ctypes) and as a CLI with
// the same contract the reference drives ORCA with:
//   graphlet_orbits node {4|5} <edge-list-file> std
// printing "orbit counts:" then one line of 15 (or 73) counts per node.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_set>
#include <vector>

#include "orbit5_table.inc"

namespace {

struct Graph {
  int n;
  std::vector<std::vector<int>> adj;           // sorted neighbor lists
  std::vector<std::unordered_set<int64_t>> dummy;
  std::unordered_set<int64_t> edges;           // u * n + v, u < v

  bool connected(int u, int v) const {
    if (u > v) std::swap(u, v);
    return edges.count(static_cast<int64_t>(u) * n + v) != 0;
  }
};

typedef long long ll;

// classify a connected induced subgraph given internal degrees, add counts
void classify3(const Graph& g, const int s[3], ll* out, int stride) {
  int deg[3] = {0, 0, 0};
  int edges = 0;
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (g.connected(s[i], s[j])) { ++deg[i]; ++deg[j]; ++edges; }
  if (edges == 2) {          // path P3
    for (int i = 0; i < 3; ++i) out[s[i] * stride + (deg[i] == 2 ? 2 : 1)]++;
  } else {                   // triangle (edges == 3)
    for (int i = 0; i < 3; ++i) out[s[i] * stride + 3]++;
  }
}

void classify4(const Graph& g, const int s[4], ll* out, int stride) {
  int deg[4] = {0, 0, 0, 0};
  int edges = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = i + 1; j < 4; ++j)
      if (g.connected(s[i], s[j])) { ++deg[i]; ++deg[j]; ++edges; }
  switch (edges) {
    case 3: {
      // P4 (1,1,2,2) or claw (1,1,1,3)
      int maxd = std::max(std::max(deg[0], deg[1]), std::max(deg[2], deg[3]));
      if (maxd == 2) {       // path
        for (int i = 0; i < 4; ++i) out[s[i] * stride + (deg[i] == 2 ? 5 : 4)]++;
      } else {               // claw
        for (int i = 0; i < 4; ++i) out[s[i] * stride + (deg[i] == 3 ? 7 : 6)]++;
      }
      break;
    }
    case 4: {
      // C4 (2,2,2,2) or paw (1,2,2,3)
      int maxd = std::max(std::max(deg[0], deg[1]), std::max(deg[2], deg[3]));
      if (maxd == 2) {       // cycle
        for (int i = 0; i < 4; ++i) out[s[i] * stride + 8]++;
      } else {               // paw: pendant=1 -> 9, attached(3) -> 11, others -> 10
        for (int i = 0; i < 4; ++i) {
          int orbit = deg[i] == 1 ? 9 : (deg[i] == 3 ? 11 : 10);
          out[s[i] * stride + orbit]++;
        }
      }
      break;
    }
    case 5: {                // diamond (2,2,3,3)
      for (int i = 0; i < 4; ++i) out[s[i] * stride + (deg[i] == 3 ? 13 : 12)]++;
      break;
    }
    default: {               // 6 edges: K4
      for (int i = 0; i < 4; ++i) out[s[i] * stride + 14]++;
      break;
    }
  }
}

// size-5 classification: 10-bit edge mask over local position pairs in
// lexicographic order -> per-position orbit id from the generated table.
void classify5(const Graph& g, const int s[5], ll* out, int stride) {
  int mask = 0, bi = 0;
  for (int i = 0; i < 5; ++i)
    for (int j = i + 1; j < 5; ++j, ++bi)
      if (g.connected(s[i], s[j])) mask |= 1 << bi;
  const signed char* orb = ORB5[mask];
  for (int i = 0; i < 5; ++i) out[s[i] * stride + orb[i]]++;
}

// ESU: extend subgraph `sub` (size k) with extension set `ext`; every
// connected induced subgraph containing root v (all members > v except v)
// is produced exactly once.
void extend(const Graph& g, int root, std::vector<int>& sub,
            std::vector<int>& ext, std::vector<char>& in_sub_or_nbr,
            ll* out, size_t target, int stride) {
  while (!ext.empty()) {
    int w = ext.back();
    ext.pop_back();
    sub.push_back(w);
    if (sub.size() == 3) {
      int s[3] = {sub[0], sub[1], sub[2]};
      classify3(g, s, out, stride);
    } else if (sub.size() == 4) {
      int s[4] = {sub[0], sub[1], sub[2], sub[3]};
      classify4(g, s, out, stride);
    } else if (sub.size() == 5) {
      int s[5] = {sub[0], sub[1], sub[2], sub[3], sub[4]};
      classify5(g, s, out, stride);
    }
    if (sub.size() < target) {
      // new extension: ext' = ext U { u in N(w) : u > root, u not in
      // N(sub before w) and not in sub }
      std::vector<int> newly;
      for (int u : g.adj[w]) {
        if (u > root && !in_sub_or_nbr[u]) {
          newly.push_back(u);
          in_sub_or_nbr[u] = 1;
        }
      }
      std::vector<int> ext2(ext);
      for (int u : newly) ext2.push_back(u);
      extend(g, root, sub, ext2, in_sub_or_nbr, out, target, stride);
      for (int u : newly) in_sub_or_nbr[u] = 0;
    }
    sub.pop_back();
  }
}

void count_all(const Graph& g, ll* out, int graphlet_size) {
  const int stride = graphlet_size == 5 ? 73 : 15;
  std::memset(out, 0, sizeof(ll) * g.n * stride);
  // orbit 0: degree
  for (int v = 0; v < g.n; ++v) out[v * stride + 0] = (ll)g.adj[v].size();
  std::vector<char> mark(g.n, 0);
  for (int v = 0; v < g.n; ++v) {
    std::vector<int> sub{v};
    std::vector<int> ext;
    mark.assign(g.n, 0);
    mark[v] = 1;
    for (int u : g.adj[v])
      if (u > v) { ext.push_back(u); mark[u] = 1; }
    extend(g, v, sub, ext, mark, out, graphlet_size, stride);
  }
}

Graph build(int n, int m, const int* eu, const int* ev) {
  Graph g;
  g.n = n;
  g.adj.assign(n, {});
  for (int i = 0; i < m; ++i) {
    int u = eu[i], v = ev[i];
    if (u == v) continue;
    if (g.connected(u, v)) continue;
    int a = std::min(u, v), b = std::max(u, v);
    g.edges.insert(static_cast<int64_t>(a) * n + b);
    g.adj[u].push_back(v);
    g.adj[v].push_back(u);
  }
  for (auto& nb : g.adj) std::sort(nb.begin(), nb.end());
  return g;
}

}  // namespace

extern "C" {

// out must hold n*15 int64 entries (row-major per node).
void count_orbits(int n, int m, const int* edges_u, const int* edges_v,
                  ll* out) {
  Graph g = build(n, m, edges_u, edges_v);
  count_all(g, out, 4);
}

// full "node 5" mode: out must hold n*73 int64 entries (orbits 0-72).
void count_orbits5(int n, int m, const int* edges_u, const int* edges_v,
                   ll* out) {
  Graph g = build(n, m, edges_u, edges_v);
  count_all(g, out, 5);
}

}  // extern "C"

#ifdef ORBITS_MAIN
int main(int argc, char** argv) {
  // CLI contract: graphlet_orbits node {4|5} <file> std
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: %s node {4|5} <edge-list-file> std\n", argv[0]);
    return 1;
  }
  const int size = std::atoi(argv[2]);
  const int stride = size == 5 ? 73 : 15;
  FILE* f = std::fopen(argv[3], "r");
  if (!f) { std::fprintf(stderr, "cannot open %s\n", argv[3]); return 1; }
  int n, m;
  if (std::fscanf(f, "%d %d", &n, &m) != 2) return 1;
  std::vector<int> eu(m), ev(m);
  for (int i = 0; i < m; ++i)
    if (std::fscanf(f, "%d %d", &eu[i], &ev[i]) != 2) return 1;
  std::fclose(f);
  std::vector<ll> out(static_cast<size_t>(n) * stride);
  if (size == 5)
    count_orbits5(n, m, eu.data(), ev.data(), out.data());
  else
    count_orbits(n, m, eu.data(), ev.data(), out.data());
  std::printf("orbit counts: \n");
  for (int v = 0; v < n; ++v) {
    for (int o = 0; o < stride; ++o)
      std::printf(o ? " %lld" : "%lld", out[v * stride + o]);
    std::printf("\n");
  }
  return 0;
}
#endif
