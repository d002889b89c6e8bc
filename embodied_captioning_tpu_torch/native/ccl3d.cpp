// Native host-side code of the port: a copy of the JAX package's
// native/ccl3d.cpp, built by mapping/components.py into native/build/.
//
// connected_components_26: 26-connectivity multilabel connected components
// over a 3D int32 grid (cc3d semantics). Two-pass union-find with path
// compression.
//
// astar_2d: grid A* for agents/planner.py.
//
// A plain C ABI shared library, loaded with ctypes. No Python headers.

#include <cmath>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  int32_t make() {
    parent.push_back(static_cast<int32_t>(parent.size()));
    return parent.back();
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[b < a ? a : b] = (b < a ? b : a);
  }
};

}  // namespace

extern "C" {

// labels: [X*Y*Z] row-major (x outer, z inner) input values, 0 = background.
// out:    [X*Y*Z] component labels, 1..n (0 = background).
// Returns n, the number of components. Adjacent voxels join one component
// iff they hold the same nonzero value (cc3d multilabel semantics).
int32_t connected_components_26(const int32_t* labels, int32_t* out,
                                int32_t X, int32_t Y, int32_t Z) {
  const int64_t n_vox = static_cast<int64_t>(X) * Y * Z;
  std::vector<int32_t> comp(n_vox, 0);
  UnionFind uf;
  uf.make();  // slot 0 = background

  auto idx = [Y, Z](int32_t x, int32_t y, int32_t z) -> int64_t {
    return (static_cast<int64_t>(x) * Y + y) * Z + z;
  };

  // Scan order x, y, z: for each voxel, look at the 13 already-visited
  // neighbors (half of the 26-neighborhood).
  static const int8_t NB[13][3] = {
      {-1, -1, -1}, {-1, -1, 0}, {-1, -1, 1}, {-1, 0, -1}, {-1, 0, 0},
      {-1, 0, 1},   {-1, 1, -1}, {-1, 1, 0},  {-1, 1, 1},  {0, -1, -1},
      {0, -1, 0},   {0, -1, 1},  {0, 0, -1}};

  for (int32_t x = 0; x < X; ++x) {
    for (int32_t y = 0; y < Y; ++y) {
      for (int32_t z = 0; z < Z; ++z) {
        const int64_t i = idx(x, y, z);
        const int32_t v = labels[i];
        if (v == 0) continue;
        int32_t assigned = 0;
        for (const auto& d : NB) {
          const int32_t nx = x + d[0], ny = y + d[1], nz = z + d[2];
          if (nx < 0 || ny < 0 || nz < 0 || nx >= X || ny >= Y || nz >= Z)
            continue;
          const int64_t j = idx(nx, ny, nz);
          if (labels[j] != v) continue;
          const int32_t cj = comp[j];
          if (cj == 0) continue;
          if (assigned == 0) {
            assigned = cj;
          } else if (assigned != cj) {
            uf.unite(assigned, cj);
          }
        }
        if (assigned == 0) assigned = uf.make();
        comp[i] = assigned;
      }
    }
  }

  // Relabel roots to 1..n.
  std::vector<int32_t> remap(uf.parent.size(), 0);
  int32_t next = 0;
  for (int64_t i = 0; i < n_vox; ++i) {
    if (comp[i] == 0) {
      out[i] = 0;
      continue;
    }
    const int32_t root = uf.find(comp[i]);
    if (remap[root] == 0) remap[root] = ++next;
    out[i] = remap[root];
  }
  return next;
}

// Grid A* shortest path on a 2D traversibility map with euclidean heuristic
// and 8-connectivity (the planner's backend; see agents/planner.py).
// grid: [H*W] uint8, nonzero = traversable. start/goal: (row, col).
// out_path: caller-allocated [max_len*2] int32, filled with (row, col) pairs
// from start to goal. Returns path length in nodes, 0 if unreachable.
int32_t astar_2d(const uint8_t* grid, int32_t H, int32_t W, int32_t sr,
                 int32_t sc, int32_t gr, int32_t gc, int32_t* out_path,
                 int32_t max_len) {
  if (sr < 0 || sc < 0 || gr < 0 || gc < 0 || sr >= H || sc >= W ||
      gr >= H || gc >= W)
    return 0;
  const int64_t n = static_cast<int64_t>(H) * W;
  std::vector<float> g(n, 1e30f);
  std::vector<int32_t> came(n, -1);
  auto h = [gr, gc](int32_t r, int32_t c) {
    const float dr = static_cast<float>(r - gr), dc = static_cast<float>(c - gc);
    return std::sqrt(dr * dr + dc * dc);
  };
  using Node = std::pair<float, int32_t>;
  std::priority_queue<Node, std::vector<Node>, std::greater<Node>> open;
  const int32_t s = sr * W + sc;
  g[s] = 0.f;
  open.push({h(sr, sc), s});
  static const int8_t D[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                                 {0, 1},   {1, -1}, {1, 0},  {1, 1}};
  while (!open.empty()) {
    const auto [f, cur] = open.top();
    open.pop();
    const int32_t r = cur / W, c = cur % W;
    if (r == gr && c == gc) break;
    if (f > g[cur] + h(r, c) + 1e-5f) continue;
    for (const auto& d : D) {
      const int32_t nr = r + d[0], nc = c + d[1];
      if (nr < 0 || nc < 0 || nr >= H || nc >= W) continue;
      const int32_t ni = nr * W + nc;
      if (!grid[ni]) continue;
      const float step = (d[0] != 0 && d[1] != 0) ? 1.41421356f : 1.0f;
      const float ng = g[cur] + step;
      if (ng < g[ni]) {
        g[ni] = ng;
        came[ni] = cur;
        open.push({ng + h(nr, nc), ni});
      }
    }
  }
  const int32_t goal = gr * W + gc;
  if (g[goal] >= 1e29f) return 0;
  // walk back
  std::vector<int32_t> rev;
  for (int32_t cur = goal; cur != -1; cur = came[cur]) rev.push_back(cur);
  int32_t len = static_cast<int32_t>(rev.size());
  if (len > max_len) len = max_len;
  for (int32_t i = 0; i < len; ++i) {
    const int32_t node = rev[rev.size() - 1 - i];
    out_path[2 * i] = node / W;
    out_path[2 * i + 1] = node % W;
  }
  return len;
}

}  // extern "C"
