// Maximum-clique solver for PCM loop gating.
//
// Native twin of the reference's vendored fast_max-clique_finder
// (`pairwise_consistency_maximization/third_parties/fast_max-clique_
// finder/src/findClique.cpp` exact branch-and-bound, `findCliqueHeu.cpp`
// heuristic — Pattabiraman et al., "Fast Algorithms for the Maximum
// Clique Problem on Massive Graphs"). The consistency graphs PCM
// produces are small (tens of loops), so the exact solver is the
// default here; the greedy+local-search heuristic covers pathological
// sizes. Exposed as a C ABI for ctypes (no pybind11 in the image).
//
// Build: see Makefile (produces libmrslam_native.so).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <random>

namespace {

struct Graph {
    int n;
    std::vector<std::vector<int>> adj;     // adjacency lists
    std::vector<std::vector<uint8_t>> mat; // dense adjacency
};

Graph build_graph(const uint8_t* adj, int n) {
    Graph g;
    g.n = n;
    g.adj.resize(n);
    g.mat.assign(n, std::vector<uint8_t>(n, 0));
    for (int i = 0; i < n; ++i) {
        for (int j = 0; j < n; ++j) {
            if (i != j && adj[i * n + j] && adj[j * n + i]) {
                g.mat[i][j] = 1;
                if (j > i) {
                    g.adj[i].push_back(j);
                    g.adj[j].push_back(i);
                }
            }
        }
    }
    return g;
}

// Exact branch-and-bound with greedy-coloring bound (Tomita-style).
struct Exact {
    const Graph& g;
    std::vector<int> best;
    std::vector<int> cur;
    long long budget;  // node-expansion budget; fall back if exceeded
    bool exceeded = false;

    explicit Exact(const Graph& gr, long long budget_) : g(gr), budget(budget_) {}

    // order candidates by coloring; returns (vertices, colors)
    void color_sort(std::vector<int>& cand, std::vector<int>& colors) {
        std::vector<std::vector<int>> classes;
        for (int v : cand) {
            bool placed = false;
            for (auto& cls : classes) {
                bool ok = true;
                for (int u : cls)
                    if (g.mat[v][u]) { ok = false; break; }
                if (ok) { cls.push_back(v); placed = true; break; }
            }
            if (!placed) classes.push_back({v});
        }
        cand.clear();
        colors.clear();
        for (size_t c = 0; c < classes.size(); ++c)
            for (int v : classes[c]) {
                cand.push_back(v);
                colors.push_back(static_cast<int>(c) + 1);
            }
    }

    void expand(std::vector<int>& cand) {
        if (--budget < 0) { exceeded = true; return; }
        std::vector<int> colors;
        color_sort(cand, colors);
        while (!cand.empty() && !exceeded) {
            int v = cand.back();
            int c = colors.back();
            cand.pop_back();
            colors.pop_back();
            if (cur.size() + c <= best.size()) return;  // bound
            cur.push_back(v);
            std::vector<int> next;
            for (int u : cand)
                if (g.mat[v][u]) next.push_back(u);
            if (next.empty()) {
                if (cur.size() > best.size()) best = cur;
            } else {
                expand(next);
            }
            cur.pop_back();
        }
    }

    void run() {
        std::vector<int> cand(g.n);
        for (int i = 0; i < g.n; ++i) cand[i] = i;
        // degeneracy-ish ordering: ascending degree improves pruning
        std::sort(cand.begin(), cand.end(), [&](int a, int b) {
            return g.adj[a].size() < g.adj[b].size();
        });
        expand(cand);
    }
};

// Greedy heuristic with randomized restarts (findCliqueHeu flavour).
std::vector<int> heuristic(const Graph& g, int restarts, uint64_t seed) {
    std::mt19937_64 rng(seed);
    std::vector<int> best;
    std::vector<int> order(g.n);
    for (int i = 0; i < g.n; ++i) order[i] = i;
    for (int it = 0; it < restarts; ++it) {
        if (it == 0) {
            std::sort(order.begin(), order.end(), [&](int a, int b) {
                return g.adj[a].size() > g.adj[b].size();
            });
        } else {
            std::shuffle(order.begin(), order.end(), rng);
        }
        std::vector<int> clique;
        std::vector<uint8_t> cand(g.n, 1);
        for (int v : order) {
            if (!cand[v]) continue;
            clique.push_back(v);
            for (int u = 0; u < g.n; ++u)
                if (!g.mat[v][u]) cand[u] = 0;
        }
        if (clique.size() > best.size()) best = clique;
    }
    return best;
}

}  // namespace

extern "C" {

// adj: row-major n*n 0/1 matrix. out: caller-allocated n ints.
// Returns clique size. mode 0 = exact (budgeted, falls back to
// heuristic on budget exhaustion), 1 = heuristic only.
int mrslam_max_clique(const uint8_t* adj, int n, int mode, int* out) {
    if (n <= 0) return 0;
    Graph g = build_graph(adj, n);
    std::vector<int> result;
    if (mode == 0) {
        Exact ex(g, 5'000'000);
        ex.run();
        result = ex.best;
        if (ex.exceeded) {
            auto h = heuristic(g, 64, 1234);
            if (h.size() > result.size()) result = h;
        }
    } else {
        result = heuristic(g, 64, 1234);
    }
    std::sort(result.begin(), result.end());
    for (size_t i = 0; i < result.size(); ++i) out[i] = result[i];
    return static_cast<int>(result.size());
}

}  // extern "C"
