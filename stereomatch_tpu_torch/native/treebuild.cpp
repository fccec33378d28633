// Host-side segment-forest builder for the 3DMST backend.
//
// Native (C++) equivalent of the reference's graph/tree construction stack:
//   - Felzenszwalb segmentation with the c/|C| adaptive threshold
//     (reference: include/segment-graph.h:54-89 semantics, re-derived)
//   - small-component merge (reference: src/Stereo3DMST.cpp:293-307)
//   - per-component join-forest = Kruskal MST (edges processed in ascending
//     weight order), flattened to parent/weight arrays instead of
//     Boost adjacency lists (reference: src/Stereo3DMST.cpp:434-522)
//   - NEW for the TPU formulation: segment-contiguous DFS (Euler tour)
//     numbering with weighted-depth splitting at `delta` (= gamma * path
//     weight), so the TPU-side tree filter can run as prefix sums with
//     exp-factorized path weights that stay in fp32 range. Contributions
//     across a split are <= exp(-delta) (~4e-18 at delta=40) — numerically
//     zero in the reference's own accumulation.
//
// Performance notes (this stage is on the per-frame critical path; at
// 2048x1536 it walks 3.1M pixels / 6.3M edges):
//   - edges live in SoA arrays and are sorted by a 3-pass LSD radix over
//     the float bit patterns (valid for the non-negative L1 weights, and
//     stable, so raster order still breaks ties like stable_sort did);
//   - DSU roots are materialized once after the merges and reused for the
//     component-id and inter-tree-pair passes;
//   - segment assignment and Euler numbering happen in ONE traversal
//     (round 1 walked every tree twice).
//
// Exposed via ctypes (see native/__init__.py). Pure arrays in/out; no
// OpenCV/Boost dependencies.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

struct DSU {
  std::vector<int32_t> parent;
  std::vector<int32_t> rank_;
  std::vector<int32_t> size_;
  explicit DSU(int n) : parent(n), rank_(n, 0), size_(n, 1) {
    for (int i = 0; i < n; i++) parent[i] = i;
  }
  int find(int x) {
    int r = x;
    while (parent[r] != r) r = parent[r];
    while (parent[x] != r) {
      int nxt = parent[x];
      parent[x] = r;
      x = nxt;
    }
    return r;
  }
  // returns new root
  int join(int a, int b) {
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    size_[a] += size_[b];
    if (rank_[a] == rank_[b]) rank_[a]++;
    return a;
  }
};

// stable LSD radix sort of indices by non-negative float keys (bit
// patterns of non-negative IEEE floats sort like the floats themselves)
void radix_sort_indices(const std::vector<float>& keys,
                        std::vector<int32_t>& order) {
  const size_t m = keys.size();
  order.resize(m);
  for (size_t i = 0; i < m; i++) order[i] = (int32_t)i;
  std::vector<int32_t> tmp(m);
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(keys.data());
  for (int shift = 0; shift < 32; shift += 11) {
    const uint32_t mask = (shift == 22) ? 0x3ff : 0x7ff;
    const int buckets = (int)mask + 1;
    std::vector<int64_t> count(buckets + 1, 0);
    for (size_t i = 0; i < m; i++)
      count[((bits[order[i]] >> shift) & mask) + 1]++;
    for (int b = 0; b < buckets; b++) count[b + 1] += count[b];
    for (size_t i = 0; i < m; i++)
      tmp[count[(bits[order[i]] >> shift) & mask]++] = order[i];
    order.swap(tmp);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, negative on error (-1: adjacency capacity exceeded).
// All output arrays must be pre-allocated by the caller:
//   pixel_of_node, parent_node, in_pos, out_pos, seg_id, tree_id,
//   node_of_pixel: int32[N];  w_exp, rel_gd: float[N]
//   tree_start: int32[N+1]; adj_start: int32[N+1]; adj_list: int32[adj_cap]
//   out_counts: int32[3] -> {num_trees, num_segments, num_adj}
int build_forest(int height, int width,
                 const float* wr,  // (H, W-1) horizontal edge weights
                 const float* wd,  // (H-1, W) vertical edge weights
                 float c, int min_size, float gamma, float delta,
                 int32_t* pixel_of_node, int32_t* parent_node, float* w_exp,
                 float* rel_gd, int32_t* in_pos, int32_t* out_pos,
                 int32_t* seg_id, int32_t* tree_id, int32_t* node_of_pixel,
                 int32_t* tree_start, int32_t* adj_start, int32_t* adj_list,
                 int64_t adj_cap, int32_t* out_counts) {
  const int64_t n = (int64_t)height * width;
  const int64_t num_edges =
      (int64_t)height * (width - 1) + (int64_t)(height - 1) * width;

  // ---- collect 4-neighbor edges, SoA, raster right+down order
  // (reference: src/Stereo3DMST.cpp:242-282) ----
  std::vector<int32_t> ea, eb;
  std::vector<float> ew;
  ea.reserve(num_edges);
  eb.reserve(num_edges);
  ew.reserve(num_edges);
  for (int y = 0; y < height; y++) {
    for (int x = 0; x < width; x++) {
      const int32_t p = y * width + x;
      if (x < width - 1) {
        ea.push_back(p);
        eb.push_back(p + 1);
        ew.push_back(wr[(int64_t)y * (width - 1) + x]);
      }
      if (y < height - 1) {
        ea.push_back(p);
        eb.push_back(p + width);
        ew.push_back(wd[(int64_t)y * width + x]);
      }
    }
  }

  // ascending weight, stable (raster order breaks ties deterministically)
  std::vector<int32_t> order;
  radix_sort_indices(ew, order);

  // ---- Felzenszwalb: join when w <= min(thr_a, thr_b); thr = w + c/|C| ----
  DSU dsu((int)n);
  std::vector<float> thr(n, c);
  std::vector<uint8_t> is_tree_edge(ew.size(), 0);
  for (size_t k = 0; k < order.size(); k++) {
    const int32_t i = order[k];
    int a = dsu.find(ea[i]);
    int b = dsu.find(eb[i]);
    if (a != b && ew[i] <= thr[a] && ew[i] <= thr[b]) {
      int r = dsu.join(a, b);
      thr[r] = ew[i] + c / dsu.size_[r];
      is_tree_edge[i] = 1;
    }
  }

  // ---- merge small components (same ascending order; reference's loop
  // runs over the sorted edge array, Stereo3DMST.cpp:293-307) ----
  const int msize = std::max(2, min_size);
  for (size_t k = 0; k < order.size(); k++) {
    const int32_t i = order[k];
    int a = dsu.find(ea[i]);
    int b = dsu.find(eb[i]);
    if (a != b && (dsu.size_[a] < msize || dsu.size_[b] < msize)) {
      dsu.join(a, b);
      is_tree_edge[i] = 1;
    }
  }

  // materialize final roots once (reused below)
  std::vector<int32_t> root_of(n);
  for (int64_t i = 0; i < n; i++) root_of[i] = dsu.find((int)i);

  // ---- forest adjacency (CSR over pixels, tree edges only) ----
  std::vector<int32_t> deg(n, 0);
  for (size_t i = 0; i < ew.size(); i++) {
    if (is_tree_edge[i]) {
      deg[ea[i]]++;
      deg[eb[i]]++;
    }
  }
  std::vector<int64_t> adj_off(n + 1, 0);
  for (int64_t i = 0; i < n; i++) adj_off[i + 1] = adj_off[i] + deg[i];
  std::vector<int32_t> nbr(adj_off[n]);
  std::vector<float> nbr_w(adj_off[n]);
  {
    std::vector<int64_t> fill(adj_off.begin(), adj_off.end() - 1);
    for (size_t i = 0; i < ew.size(); i++) {
      if (!is_tree_edge[i]) continue;
      nbr[fill[ea[i]]] = eb[i];
      nbr_w[fill[ea[i]]++] = ew[i];
      nbr[fill[eb[i]]] = ea[i];
      nbr_w[fill[eb[i]]++] = ew[i];
    }
  }

  // ---- component ids in raster-first-occurrence order (reference cc_ids,
  // Stereo3DMST.cpp:341-369); root of each tree = its first (min) pixel ----
  std::vector<int32_t> cc_of_root(n, -1);
  std::vector<int32_t> tree_root_pixel;
  for (int64_t i = 0; i < n; i++) {
    int r = root_of[i];
    if (cc_of_root[r] < 0) {
      cc_of_root[r] = (int32_t)tree_root_pixel.size();
      tree_root_pixel.push_back((int32_t)i);
    }
  }
  const int num_trees = (int)tree_root_pixel.size();

  // ---- single traversal: per-tree queue of segment roots, per-segment
  // DFS emitting node order + Euler events; children whose weighted depth
  // would exceed `delta` become NEW segment roots (appended to the queue)
  // instead of being descended into. Round 1 did this as two full
  // traversals (assignment, then numbering). ----
  std::vector<int32_t> parent_pix(n, -1);
  std::vector<float> parent_w(n, 0.f);
  std::vector<float> gdepth(n, 0.f);  // gamma*depth within segment
  std::vector<int32_t> seg_root_pixel;
  std::vector<int32_t> seg_tree;

  int64_t next_node = 0;
  int64_t next_euler = 0;
  std::vector<std::pair<int32_t, int32_t>> dfs;  // (pixel, state 0=enter)
  dfs.reserve(1 << 16);

  for (int t = 0; t < num_trees; t++) {
    const int32_t troot = tree_root_pixel[t];
    parent_pix[troot] = troot;
    gdepth[troot] = 0.f;
    size_t s = seg_root_pixel.size();
    seg_root_pixel.push_back(troot);
    seg_tree.push_back(t);
    for (; s < seg_root_pixel.size(); s++) {  // queue grows during the loop
      const int32_t sroot = seg_root_pixel[s];
      dfs.emplace_back(sroot, 0);
      while (!dfs.empty()) {
        auto [p, state] = dfs.back();
        dfs.pop_back();
        if (state == 1) {
          out_pos[node_of_pixel[p]] = (int32_t)next_euler++;
          continue;
        }
        const int32_t node = (int32_t)next_node++;
        node_of_pixel[p] = node;
        pixel_of_node[node] = p;
        in_pos[node] = (int32_t)next_euler++;
        seg_id[node] = (int32_t)s;
        tree_id[node] = t;
        rel_gd[node] = gdepth[p];
        if (p == sroot) {
          if (p == troot) {
            parent_node[node] = node;  // tree root
            w_exp[node] = 0.f;
          } else {
            parent_node[node] = node_of_pixel[parent_pix[p]];  // cut parent
            w_exp[node] = std::exp(-gamma * parent_w[p]);
          }
        } else {
          parent_node[node] = node_of_pixel[parent_pix[p]];
          w_exp[node] = std::exp(-gamma * parent_w[p]);
        }
        dfs.emplace_back(p, 1);  // schedule exit
        for (int64_t k = adj_off[p]; k < adj_off[p + 1]; k++) {
          const int32_t q = nbr[k];
          if (q == parent_pix[p] || parent_pix[q] >= 0) continue;
          parent_pix[q] = p;
          parent_w[q] = nbr_w[k];
          const float gd = gdepth[p] + gamma * nbr_w[k];
          if (gd > delta) {  // start a new segment at q, visit later
            gdepth[q] = 0.f;
            seg_root_pixel.push_back(q);
            seg_tree.push_back(t);
          } else {
            gdepth[q] = gd;
            dfs.emplace_back(q, 0);
          }
        }
      }
    }
  }
  const int num_segments = (int)seg_root_pixel.size();

  // ---- tree node ranges (trees are contiguous in node order) ----
  {
    std::vector<int32_t> tcount(num_trees, 0);
    for (int64_t i = 0; i < n; i++) tcount[tree_id[i]]++;
    tree_start[0] = 0;
    for (int t = 0; t < num_trees; t++)
      tree_start[t + 1] = tree_start[t] + tcount[t];
  }

  // ---- inter-tree adjacency (reference tree_g, Stereo3DMST.cpp:377-384):
  // unique (tree, tree) pairs from image edges crossing components ----
  std::vector<int64_t> pairs;
  pairs.reserve(1 << 16);
  for (size_t i = 0; i < ew.size(); i++) {
    int ca = cc_of_root[root_of[ea[i]]];
    int cb = cc_of_root[root_of[eb[i]]];
    if (ca != cb) {
      pairs.push_back(((int64_t)std::min(ca, cb) << 32) |
                      (uint32_t)std::max(ca, cb));
    }
  }
  std::sort(pairs.begin(), pairs.end());
  pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());

  // directed CSR over trees
  std::vector<int32_t> adeg(num_trees, 0);
  for (int64_t pr : pairs) {
    adeg[(int32_t)(pr >> 32)]++;
    adeg[(int32_t)(pr & 0xffffffff)]++;
  }
  adj_start[0] = 0;
  for (int t = 0; t < num_trees; t++) adj_start[t + 1] = adj_start[t] + adeg[t];
  if ((int64_t)adj_start[num_trees] > adj_cap) return -1;
  {
    std::vector<int32_t> fill(adj_start, adj_start + num_trees);
    for (int64_t pr : pairs) {
      int32_t a = (int32_t)(pr >> 32), b = (int32_t)(pr & 0xffffffff);
      adj_list[fill[a]++] = b;
      adj_list[fill[b]++] = a;
    }
  }

  out_counts[0] = num_trees;
  out_counts[1] = num_segments;
  out_counts[2] = adj_start[num_trees];
  return 0;
}

}  // extern "C"
