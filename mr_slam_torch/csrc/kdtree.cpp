// Incremental kd-tree over descriptor vectors.
//
// Native twin of the reference's custom insertion-capable kd-tree used
// for the DiSCO descriptor database (`Mapping/src/global_manager/src/
// kdtree.cpp` / `include/global_manager/kdtree.h:53-59`:
// kdtree_init(dim)/insert/build/knn_search/knn_result). The reference
// rebuilds the tree on every query (`global_manager.cpp:1002`); here
// inserts append to a brute-force tail and the tree is rebuilt only
// when the tail outgrows a fraction of the built portion, so amortized
// insert is O(1) and queries stay exact.
//
// Split dimension = max-spread over the node's point set (better than
// cycling dims for high-d descriptors); leaves hold small buckets and
// are scanned linearly. Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <vector>
#include <queue>
#include <algorithm>
#include <limits>
#include <cmath>

namespace {

struct Node {
    int split_dim = -1;          // -1 => leaf
    float split_val = 0.f;
    int left = -1, right = -1;   // children (node indices)
    int begin = 0, end = 0;      // leaf: range into `order`
};

struct KdTree {
    int dim;
    std::vector<float> data;     // size * dim, row-major
    std::vector<int> order;      // permutation of built points
    std::vector<Node> nodes;
    int built = 0;               // number of points covered by `nodes`
    int root = -1;
    static constexpr int kLeaf = 16;

    int size() const { return (int)(data.size() / dim); }
    const float* pt(int i) const { return data.data() + (size_t)i * dim; }

    int build_range(int begin, int end) {
        int id = (int)nodes.size();
        nodes.emplace_back();
        if (end - begin <= kLeaf) {
            nodes[id].begin = begin;
            nodes[id].end = end;
            return id;
        }
        // max-spread split dimension over this range
        int best_d = 0;
        float best_spread = -1.f;
        for (int d = 0; d < dim; ++d) {
            float lo = std::numeric_limits<float>::max(), hi = -lo;
            for (int i = begin; i < end; ++i) {
                float v = pt(order[i])[d];
                lo = std::min(lo, v);
                hi = std::max(hi, v);
            }
            if (hi - lo > best_spread) { best_spread = hi - lo; best_d = d; }
        }
        if (best_spread <= 0.f) {  // all identical -> leaf
            nodes[id].begin = begin;
            nodes[id].end = end;
            return id;
        }
        int mid = (begin + end) / 2;
        std::nth_element(
            order.begin() + begin, order.begin() + mid, order.begin() + end,
            [&](int a, int b) { return pt(a)[best_d] < pt(b)[best_d]; });
        Node n;
        n.split_dim = best_d;
        n.split_val = pt(order[mid])[best_d];
        nodes[id] = n;
        int l = build_range(begin, mid);
        int r = build_range(mid, end);
        nodes[id].left = l;
        nodes[id].right = r;
        return id;
    }

    void rebuild() {
        built = size();
        order.resize(built);
        for (int i = 0; i < built; ++i) order[i] = i;
        nodes.clear();
        root = built ? build_range(0, built) : -1;
    }

    void insert(const float* v) {
        data.insert(data.end(), v, v + dim);
        int tail = size() - built;
        if (tail > std::max(64, built / 4)) rebuild();
    }

    float dist2(const float* a, const float* b) const {
        float s = 0.f;
        for (int d = 0; d < dim; ++d) { float e = a[d] - b[d]; s += e * e; }
        return s;
    }

    // bounded max-heap of (dist2, index)
    using Heap = std::priority_queue<std::pair<float, int>>;

    void consider(Heap& heap, int k, const float* q, int idx) const {
        float d2 = dist2(q, pt(idx));
        if ((int)heap.size() < k) heap.emplace(d2, idx);
        else if (d2 < heap.top().first) { heap.pop(); heap.emplace(d2, idx); }
    }

    void search(Heap& heap, int k, const float* q, int node) const {
        const Node& n = nodes[node];
        if (n.split_dim < 0) {
            for (int i = n.begin; i < n.end; ++i) consider(heap, k, q, order[i]);
            return;
        }
        float diff = q[n.split_dim] - n.split_val;
        int near = diff < 0.f ? n.left : n.right;
        int far = diff < 0.f ? n.right : n.left;
        search(heap, k, q, near);
        if ((int)heap.size() < k || diff * diff < heap.top().first)
            search(heap, k, q, far);
    }

    int knn(const float* q, int k, int* out_idx, float* out_dist) const {
        Heap heap;
        if (root >= 0) search(heap, k, q, root);
        for (int i = built; i < size(); ++i) consider(heap, k, q, i);
        int m = (int)heap.size();
        for (int i = m - 1; i >= 0; --i) {
            out_idx[i] = heap.top().second;
            out_dist[i] = std::sqrt(heap.top().first);
            heap.pop();
        }
        return m;
    }
};

}  // namespace

extern "C" {

void* mrslam_kdtree_create(int dim) {
    if (dim <= 0) return nullptr;
    auto* t = new KdTree();
    t->dim = dim;
    return t;
}

int mrslam_kdtree_insert(void* h, const float* vec) {
    auto* t = static_cast<KdTree*>(h);
    t->insert(vec);
    return t->size() - 1;
}

int mrslam_kdtree_size(void* h) { return static_cast<KdTree*>(h)->size(); }

int mrslam_kdtree_knn(void* h, const float* query, int k, int* out_idx,
                      float* out_dist) {
    auto* t = static_cast<KdTree*>(h);
    if (k <= 0 || t->size() == 0) return 0;
    k = std::min(k, t->size());
    return t->knn(query, k, out_idx, out_dist);
}

void mrslam_kdtree_destroy(void* h) { delete static_cast<KdTree*>(h); }

}  // extern "C"
