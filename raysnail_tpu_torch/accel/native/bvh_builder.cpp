// Native binned-SAH BVH builder for raysnail-tpu.
//
// Produces the exact linearized skip-link layout of accel/bvh.py
// (DFS pre-order nodes, left child = node+1, miss links, LEAF_SIZE-padded
// primitive order) — the host-side build stage that the reference does with
// a recursive trait-object tree (src/hittable/collection/bvh.rs:47-112),
// reimplemented natively for large meshes.
//
// Build: g++ -O3 -march=native -shared -fPIC bvh_builder.cpp -o libbvh.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr int N_BINS = 16;

struct Node {
    float bb_min[3], bb_max[3];
    int left = -1, right = -1;          // node indices, -1 for leaf
    std::vector<int> prims;             // leaf primitives
};

struct Builder {
    const float* pmin;
    const float* pmax;
    std::vector<float> centroid;
    std::vector<Node> nodes;
    int leaf_size;

    int build(std::vector<int>& ids, int begin, int end) {
        int me = (int)nodes.size();
        nodes.emplace_back();
        float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
        for (int i = begin; i < end; ++i) {
            const int p = ids[i];
            for (int a = 0; a < 3; ++a) {
                lo[a] = std::min(lo[a], pmin[3 * p + a]);
                hi[a] = std::max(hi[a], pmax[3 * p + a]);
            }
        }
        for (int a = 0; a < 3; ++a) { nodes[me].bb_min[a] = lo[a]; nodes[me].bb_max[a] = hi[a]; }

        const int n = end - begin;
        if (n <= leaf_size) {
            nodes[me].prims.assign(ids.begin() + begin, ids.begin() + end);
            return me;
        }

        // centroid bounds
        float clo[3] = {1e30f, 1e30f, 1e30f}, chi[3] = {-1e30f, -1e30f, -1e30f};
        for (int i = begin; i < end; ++i) {
            const float* c = &centroid[3 * ids[i]];
            for (int a = 0; a < 3; ++a) {
                clo[a] = std::min(clo[a], c[a]);
                chi[a] = std::max(chi[a], c[a]);
            }
        }
        int axis = 0;
        float ext[3];
        for (int a = 0; a < 3; ++a) ext[a] = chi[a] - clo[a];
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int mid;
        if (ext[axis] <= 1e-12f) {
            mid = begin + n / 2;
        } else {
            // binned SAH
            float bin_lo[N_BINS][3], bin_hi[N_BINS][3];
            int bin_cnt[N_BINS] = {0};
            for (int b = 0; b < N_BINS; ++b)
                for (int a = 0; a < 3; ++a) { bin_lo[b][a] = 1e30f; bin_hi[b][a] = -1e30f; }
            const float inv = N_BINS / ext[axis];
            auto bin_of = [&](int p) {
                int b = (int)((centroid[3 * p + axis] - clo[axis]) * inv);
                return std::min(std::max(b, 0), N_BINS - 1);
            };
            for (int i = begin; i < end; ++i) {
                const int p = ids[i];
                const int b = bin_of(p);
                ++bin_cnt[b];
                for (int a = 0; a < 3; ++a) {
                    bin_lo[b][a] = std::min(bin_lo[b][a], pmin[3 * p + a]);
                    bin_hi[b][a] = std::max(bin_hi[b][a], pmax[3 * p + a]);
                }
            }
            auto area = [](const float* l, const float* h) {
                float d0 = std::max(h[0] - l[0], 0.0f);
                float d1 = std::max(h[1] - l[1], 0.0f);
                float d2 = std::max(h[2] - l[2], 0.0f);
                return 2.0f * (d0 * d1 + d1 * d2 + d0 * d2);
            };
            float pre_a[N_BINS], suf_a[N_BINS];
            int pre_n[N_BINS];
            float acc_lo[3], acc_hi[3];
            for (int a = 0; a < 3; ++a) { acc_lo[a] = 1e30f; acc_hi[a] = -1e30f; }
            int cnt = 0;
            for (int b = 0; b < N_BINS; ++b) {
                for (int a = 0; a < 3; ++a) {
                    acc_lo[a] = std::min(acc_lo[a], bin_lo[b][a]);
                    acc_hi[a] = std::max(acc_hi[a], bin_hi[b][a]);
                }
                cnt += bin_cnt[b];
                pre_a[b] = area(acc_lo, acc_hi);
                pre_n[b] = cnt;
            }
            for (int a = 0; a < 3; ++a) { acc_lo[a] = 1e30f; acc_hi[a] = -1e30f; }
            for (int b = N_BINS - 1; b >= 0; --b) {
                for (int a = 0; a < 3; ++a) {
                    acc_lo[a] = std::min(acc_lo[a], bin_lo[b][a]);
                    acc_hi[a] = std::max(acc_hi[a], bin_hi[b][a]);
                }
                suf_a[b] = area(acc_lo, acc_hi);
            }
            float best_cost = std::numeric_limits<float>::infinity();
            int best_split = -1;
            for (int s = 1; s < N_BINS; ++s) {
                const int nl = pre_n[s - 1], nr = n - nl;
                if (nl == 0 || nr == 0) continue;
                const float cost = nl * pre_a[s - 1] + nr * suf_a[s];
                if (cost < best_cost) { best_cost = cost; best_split = s; }
            }
            if (best_split < 0) {
                std::nth_element(ids.begin() + begin, ids.begin() + begin + n / 2,
                                 ids.begin() + end, [&](int x, int y) {
                                     return centroid[3 * x + axis] < centroid[3 * y + axis];
                                 });
                mid = begin + n / 2;
            } else {
                auto it = std::partition(ids.begin() + begin, ids.begin() + end,
                                         [&](int p) { return bin_of(p) < best_split; });
                mid = (int)(it - ids.begin());
                if (mid == begin || mid == end) mid = begin + n / 2;
            }
        }
        const int l = build(ids, begin, mid);
        const int r = build(ids, mid, end);
        nodes[me].left = l;
        nodes[me].right = r;
        return me;
    }
};

}  // namespace

extern "C" int raysnail_build_bvh(
    const float* bb_min, const float* bb_max, int n_prims, int leaf_size,
    float* out_bb_min, float* out_bb_max, int* out_first, int* out_count,
    int* out_miss, int* out_prim_order, int max_nodes, int max_prims,
    int* out_sizes /* [n_nodes, n_prims_padded] */) {
    if (n_prims <= 0) return -1;
    Builder b;
    b.pmin = bb_min;
    b.pmax = bb_max;
    b.leaf_size = leaf_size;
    b.centroid.resize(3 * (size_t)n_prims);
    for (int p = 0; p < n_prims; ++p)
        for (int a = 0; a < 3; ++a)
            b.centroid[3 * p + a] = 0.5f * (bb_min[3 * p + a] + bb_max[3 * p + a]);

    std::vector<int> ids(n_prims);
    for (int i = 0; i < n_prims; ++i) ids[i] = i;
    b.nodes.reserve(2 * (size_t)n_prims);
    b.build(ids, 0, n_prims);

    const int m = (int)b.nodes.size();
    if (m > max_nodes) return -2;

    // fill outputs; nodes are already in DFS pre-order (build() numbers
    // parent before children, left before right)
    int prim_cursor = 0;
    // miss links: iterative DFS carrying the miss target
    std::vector<std::pair<int, int>> stack;  // (node, miss)
    stack.emplace_back(0, m);
    while (!stack.empty()) {
        auto [i, miss] = stack.back();
        stack.pop_back();
        const Node& nd = b.nodes[i];
        for (int a = 0; a < 3; ++a) {
            out_bb_min[3 * i + a] = nd.bb_min[a];
            out_bb_max[3 * i + a] = nd.bb_max[a];
        }
        out_miss[i] = miss;
        if (nd.left < 0) {
            const int cnt = (int)nd.prims.size();
            int padded = ((cnt + leaf_size - 1) / leaf_size) * leaf_size;
            if (padded == 0) padded = leaf_size;
            if (prim_cursor + padded > max_prims) return -3;
            out_first[i] = prim_cursor;
            out_count[i] = padded;
            for (int k = 0; k < padded; ++k)
                out_prim_order[prim_cursor + k] = k < cnt ? nd.prims[k] : -1;
            prim_cursor += padded;
        } else {
            out_first[i] = 0;
            out_count[i] = 0;
            // push right first so left is processed next (stack order)
            stack.emplace_back(nd.right, miss);
            stack.emplace_back(nd.left, nd.right);
        }
    }
    out_sizes[0] = m;
    out_sizes[1] = prim_cursor;
    return 0;
}
