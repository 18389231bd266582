// HNSW approximate nearest-neighbor index (C++17, C ABI for ctypes).
//
// Native replacement for the hnswlib dependency the reference's retrieval
// subsystem leans on (reference: 06_fit_knn_tree.py:150-166,
// lib/pose_database.py:99-146): hierarchical navigable small-world graph
// with l2 and cosine spaces, ef-bounded beam search, and the neighbor-
// selection heuristic from Malkov & Yashunin (Algorithm 4).
//
// The port's copy of stlpose_tpu/native/hnsw.cpp (code unchanged).
// Build: g++ -O3 -std=c++17 -fPIC -Wall -march=native -shared, at first use,
// into stlpose_tpu_torch/_build/ (stlpose_tpu_torch/retrieval/hnsw.py).
// Python binding: stlpose_tpu_torch/retrieval/hnsw.py (ctypes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

struct Pair {
    float dist;
    int32_t id;
};
struct Nearer {   // min-heap on dist
    bool operator()(const Pair& a, const Pair& b) const { return a.dist > b.dist; }
};
struct Farther {  // max-heap on dist
    bool operator()(const Pair& a, const Pair& b) const { return a.dist < b.dist; }
};

class HnswIndex {
  public:
    HnswIndex(int space, int dim, int max_elements, int M, int ef_construction)
        : space_(space), dim_(dim), max_elements_(max_elements),
          M_(M), M0_(2 * M), ef_construction_(ef_construction),
          mult_(1.0 / std::log(1.0 * M)), rng_(100), ef_(10),
          entry_(-1), max_level_(-1) {
        data_.reserve(static_cast<size_t>(max_elements) * dim);
        labels_.reserve(max_elements);
    }

    int space_;
    int dim_;
    int max_elements_;
    int M_, M0_;
    int ef_construction_;
    double mult_;
    std::mt19937 rng_;
    int ef_;
    int entry_;
    int max_level_;

    std::vector<float> data_;                   // n * dim
    std::vector<float> norms_;                  // per-node L2 norm (cosine)
    std::vector<int32_t> labels_;
    std::vector<int> levels_;
    // links_[level][node] = neighbor list
    std::vector<std::vector<std::vector<int32_t>>> links_;

    int size() const { return static_cast<int>(labels_.size()); }

    float dist(const float* a, const float* b, float na, float nb) const {
        float dot = 0.f, l2 = 0.f;
        for (int i = 0; i < dim_; ++i) {
            float d = a[i] - b[i];
            l2 += d * d;
            dot += a[i] * b[i];
        }
        if (space_ == 0) return l2;                       // l2
        float denom = na * nb;
        if (denom <= 1e-30f) return 1.0f;
        return 1.0f - dot / denom;                        // cosine distance
    }

    float node_dist(const float* q, float qn, int id) const {
        return dist(q, &data_[static_cast<size_t>(id) * dim_], qn,
                    space_ == 1 ? norms_[id] : 1.f);
    }

    int random_level() {
        std::uniform_real_distribution<double> u(0.0, 1.0);
        double r = u(rng_);
        if (r < 1e-12) r = 1e-12;
        return static_cast<int>(-std::log(r) * mult_);
    }

    // greedy 1-best descent at one level
    int greedy_step(const float* q, float qn, int start, int level) const {
        int cur = start;
        float cur_d = node_dist(q, qn, cur);
        bool changed = true;
        while (changed) {
            changed = false;
            for (int32_t nb : links_[level][cur]) {
                float d = node_dist(q, qn, nb);
                if (d < cur_d) { cur_d = d; cur = nb; changed = true; }
            }
        }
        return cur;
    }

    // ef-bounded beam search at one level; returns candidates (unsorted heap
    // content, nearest-first after sort)
    std::vector<Pair> search_layer(const float* q, float qn, int entry,
                                   int level, int ef) const {
        std::vector<uint8_t> visited(size(), 0);
        std::priority_queue<Pair, std::vector<Pair>, Nearer> cand;
        std::priority_queue<Pair, std::vector<Pair>, Farther> best;
        float d0 = node_dist(q, qn, entry);
        cand.push({d0, entry});
        best.push({d0, entry});
        visited[entry] = 1;
        while (!cand.empty()) {
            Pair c = cand.top();
            if (c.dist > best.top().dist && static_cast<int>(best.size()) >= ef)
                break;
            cand.pop();
            for (int32_t nb : links_[level][c.id]) {
                if (visited[nb]) continue;
                visited[nb] = 1;
                float d = node_dist(q, qn, nb);
                if (static_cast<int>(best.size()) < ef || d < best.top().dist) {
                    cand.push({d, nb});
                    best.push({d, nb});
                    if (static_cast<int>(best.size()) > ef) best.pop();
                }
            }
        }
        std::vector<Pair> out;
        out.reserve(best.size());
        while (!best.empty()) { out.push_back(best.top()); best.pop(); }
        std::sort(out.begin(), out.end(),
                  [](const Pair& a, const Pair& b) { return a.dist < b.dist; });
        return out;
    }

    // neighbor-selection heuristic (keep candidates closer to q than to any
    // already-selected neighbor)
    std::vector<int32_t> select_neighbors(const std::vector<Pair>& cands,
                                          int M) const {
        std::vector<int32_t> out;
        for (const Pair& c : cands) {
            if (static_cast<int>(out.size()) >= M) break;
            bool ok = true;
            const float* cv = &data_[static_cast<size_t>(c.id) * dim_];
            float cn = space_ == 1 ? norms_[c.id] : 1.f;
            for (int32_t s : out) {
                float d_cs = dist(cv, &data_[static_cast<size_t>(s) * dim_],
                                  cn, space_ == 1 ? norms_[s] : 1.f);
                if (d_cs < c.dist) { ok = false; break; }
            }
            if (ok) out.push_back(c.id);
        }
        // backfill with remaining closest if the heuristic was too strict
        if (static_cast<int>(out.size()) < M) {
            for (const Pair& c : cands) {
                if (static_cast<int>(out.size()) >= M) break;
                if (std::find(out.begin(), out.end(), c.id) == out.end())
                    out.push_back(c.id);
            }
        }
        return out;
    }

    void prune(int node, int level, int maxM) {
        auto& lst = links_[level][node];
        if (static_cast<int>(lst.size()) <= maxM) return;
        const float* v = &data_[static_cast<size_t>(node) * dim_];
        float vn = space_ == 1 ? norms_[node] : 1.f;
        std::vector<Pair> cands;
        cands.reserve(lst.size());
        for (int32_t nb : lst)
            cands.push_back({node_dist(v, vn, nb), nb});
        std::sort(cands.begin(), cands.end(),
                  [](const Pair& a, const Pair& b) { return a.dist < b.dist; });
        lst = select_neighbors(cands, maxM);
    }

    void add(const float* v, int32_t label) {
        int id = size();
        data_.insert(data_.end(), v, v + dim_);
        labels_.push_back(label);
        if (space_ == 1) {
            float n = 0.f;
            for (int i = 0; i < dim_; ++i) n += v[i] * v[i];
            norms_.push_back(std::sqrt(n));
        }
        int level = random_level();
        levels_.push_back(level);
        while (static_cast<int>(links_.size()) <= level)
            links_.emplace_back();
        for (int l = 0; l <= level; ++l)
            links_[l].resize(size());

        if (entry_ < 0) { entry_ = id; max_level_ = level; return; }
        // make sure every level container can index all nodes
        for (auto& lv : links_) lv.resize(size());

        float qn = space_ == 1 ? norms_[id] : 1.f;
        int cur = entry_;
        for (int l = max_level_; l > level; --l)
            cur = greedy_step(v, qn, cur, l);
        for (int l = std::min(level, max_level_); l >= 0; --l) {
            auto cands = search_layer(v, qn, cur, l, ef_construction_);
            int maxM = (l == 0) ? M0_ : M_;
            auto nbs = select_neighbors(cands, M_);
            for (int32_t nb : nbs) {
                links_[l][id].push_back(nb);
                links_[l][nb].push_back(id);
                prune(nb, l, maxM);
            }
            if (!cands.empty()) cur = cands[0].id;
        }
        if (level > max_level_) { max_level_ = level; entry_ = id; }
    }

    void query(const float* q, int k, int32_t* out_ids, float* out_d) const {
        float qn = 1.f;
        if (space_ == 1) {
            float n = 0.f;
            for (int i = 0; i < dim_; ++i) n += q[i] * q[i];
            qn = std::sqrt(n);
        }
        int cur = entry_;
        for (int l = max_level_; l > 0; --l)
            cur = greedy_step(q, qn, cur, l);
        auto res = search_layer(q, qn, cur, 0, std::max(ef_, k));
        int n = std::min(k, static_cast<int>(res.size()));
        for (int i = 0; i < n; ++i) {
            out_ids[i] = labels_[res[i].id];
            out_d[i] = res[i].dist;
        }
        for (int i = n; i < k; ++i) { out_ids[i] = -1; out_d[i] = 1e30f; }
    }

    bool save(const char* path) const {
        FILE* f = std::fopen(path, "wb");
        if (!f) return false;
        int32_t header[7] = {0x48534e57, space_, dim_, max_elements_, M_,
                             ef_construction_, size()};
        std::fwrite(header, sizeof(int32_t), 7, f);
        int32_t meta[2] = {entry_, max_level_};
        std::fwrite(meta, sizeof(int32_t), 2, f);
        std::fwrite(labels_.data(), sizeof(int32_t), labels_.size(), f);
        std::fwrite(levels_.data(), sizeof(int), levels_.size(), f);
        std::fwrite(data_.data(), sizeof(float), data_.size(), f);
        int32_t n_levels = static_cast<int32_t>(links_.size());
        std::fwrite(&n_levels, sizeof(int32_t), 1, f);
        for (const auto& lv : links_) {
            int32_t n_nodes = static_cast<int32_t>(lv.size());
            std::fwrite(&n_nodes, sizeof(int32_t), 1, f);
            for (const auto& lst : lv) {
                int32_t m = static_cast<int32_t>(lst.size());
                std::fwrite(&m, sizeof(int32_t), 1, f);
                std::fwrite(lst.data(), sizeof(int32_t), m, f);
            }
        }
        std::fclose(f);
        return true;
    }

    static HnswIndex* load(const char* path) {
        FILE* f = std::fopen(path, "rb");
        if (!f) return nullptr;
        int32_t header[7];
        if (std::fread(header, sizeof(int32_t), 7, f) != 7 ||
            header[0] != 0x48534e57) { std::fclose(f); return nullptr; }
        auto* idx = new HnswIndex(header[1], header[2], header[3], header[4],
                                  header[5]);
        int n = header[6];
        int32_t meta[2];
        std::fread(meta, sizeof(int32_t), 2, f);
        idx->entry_ = meta[0];
        idx->max_level_ = meta[1];
        idx->labels_.resize(n);
        std::fread(idx->labels_.data(), sizeof(int32_t), n, f);
        idx->levels_.resize(n);
        std::fread(idx->levels_.data(), sizeof(int), n, f);
        idx->data_.resize(static_cast<size_t>(n) * idx->dim_);
        std::fread(idx->data_.data(), sizeof(float),
                   idx->data_.size(), f);
        if (idx->space_ == 1) {
            idx->norms_.resize(n);
            for (int i = 0; i < n; ++i) {
                float s = 0.f;
                const float* v = &idx->data_[static_cast<size_t>(i) * idx->dim_];
                for (int d = 0; d < idx->dim_; ++d) s += v[d] * v[d];
                idx->norms_[i] = std::sqrt(s);
            }
        }
        int32_t n_levels;
        std::fread(&n_levels, sizeof(int32_t), 1, f);
        idx->links_.resize(n_levels);
        for (auto& lv : idx->links_) {
            int32_t n_nodes;
            std::fread(&n_nodes, sizeof(int32_t), 1, f);
            lv.resize(n_nodes);
            for (auto& lst : lv) {
                int32_t m;
                std::fread(&m, sizeof(int32_t), 1, f);
                lst.resize(m);
                std::fread(lst.data(), sizeof(int32_t), m, f);
            }
        }
        std::fclose(f);
        return idx;
    }
};

}  // namespace

extern "C" {

void* hnsw_create(int space, int dim, int max_elements, int M,
                  int ef_construction) {
    return new HnswIndex(space, dim, max_elements, M, ef_construction);
}

void hnsw_free(void* h) { delete static_cast<HnswIndex*>(h); }

void hnsw_set_ef(void* h, int ef) { static_cast<HnswIndex*>(h)->ef_ = ef; }

int hnsw_size(void* h) { return static_cast<HnswIndex*>(h)->size(); }

void hnsw_add_items(void* h, const float* data, const int32_t* labels,
                    int n) {
    auto* idx = static_cast<HnswIndex*>(h);
    for (int i = 0; i < n; ++i)
        idx->add(data + static_cast<size_t>(i) * idx->dim_, labels[i]);
}

void hnsw_knn_query(void* h, const float* queries, int nq, int k,
                    int32_t* out_ids, float* out_d) {
    auto* idx = static_cast<HnswIndex*>(h);
    for (int i = 0; i < nq; ++i)
        idx->query(queries + static_cast<size_t>(i) * idx->dim_, k,
                   out_ids + static_cast<size_t>(i) * k,
                   out_d + static_cast<size_t>(i) * k);
}

int hnsw_save(void* h, const char* path) {
    return static_cast<HnswIndex*>(h)->save(path) ? 0 : 1;
}

void* hnsw_load(const char* path) { return HnswIndex::load(path); }

}  // extern "C"
