// Parameter-server table core (C++, ctypes ABI).
//
// Reference: paddle/fluid/distributed/table/common_dense_table.cc and
// common_sparse_table.cc — dense parameter arrays and a sharded hash
// sparse-embedding table with the optimizer rule applied server-side.
// This is a fresh implementation for the TPU framework: same capability
// (pull/push with sgd/adam/sum rules, init-on-miss, save/load), no brpc —
// transport lives in Python; the hot row math and the hash sharding are
// native here.
//
// Built at first use by paddle_tpu_torch/framework/native.py (g++; the
// library goes to build/paddle_tpu_torch/, named by a hash of this file).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

enum class Rule { kSum, kSGD, kAdam };

Rule parse_rule(const char* r) {
  if (!r) return Rule::kSGD;
  std::string s(r);
  if (s == "adam") return Rule::kAdam;
  if (s == "sum") return Rule::kSum;
  return Rule::kSGD;
}

struct AdamState {
  std::vector<float> m1, m2;
  int64_t step = 0;
};

struct DenseTable {
  std::vector<float> data;
  AdamState adam;
  Rule rule;
  float lr;
  std::mutex mu;

  DenseTable(int64_t size, Rule r, float lr_) : data(size, 0.f), rule(r),
                                                lr(lr_) {
    if (rule == Rule::kAdam) {
      adam.m1.assign(size, 0.f);
      adam.m2.assign(size, 0.f);
    }
  }

  void push(const float* grad, int64_t n) {
    std::lock_guard<std::mutex> g(mu);
    n = std::min<int64_t>(n, data.size());
    switch (rule) {
      case Rule::kSum:
        for (int64_t i = 0; i < n; ++i) data[i] += grad[i];
        break;
      case Rule::kSGD:
        for (int64_t i = 0; i < n; ++i) data[i] -= lr * grad[i];
        break;
      case Rule::kAdam: {
        adam.step++;
        const float b1 = 0.9f, b2 = 0.999f, eps = 1e-8f;
        const float c1 = 1.f - std::pow(b1, (float)adam.step);
        const float c2 = 1.f - std::pow(b2, (float)adam.step);
        for (int64_t i = 0; i < n; ++i) {
          adam.m1[i] = b1 * adam.m1[i] + (1 - b1) * grad[i];
          adam.m2[i] = b2 * adam.m2[i] + (1 - b2) * grad[i] * grad[i];
          data[i] -= lr * (adam.m1[i] / c1) /
                     (std::sqrt(adam.m2[i] / c2) + eps);
        }
        break;
      }
    }
  }
};

struct SparseRow {
  std::vector<float> w;
  std::vector<float> m1, m2;  // adam moments (lazily sized)
  int64_t step = 0;
};

// Sharded hash table: 16 shards, per-shard lock (reference
// common_sparse_table bucketing).
struct SparseTable {
  static constexpr int kShards = 16;
  int64_t dim;
  Rule rule;
  float lr;
  float init_range;
  std::mt19937 seed_gen;
  std::unordered_map<int64_t, SparseRow> shards[kShards];
  std::mutex mus[kShards];

  SparseTable(int64_t d, Rule r, float lr_, float ir, uint32_t seed)
      : dim(d), rule(r), lr(lr_), init_range(ir), seed_gen(seed) {}

  int shard_of(int64_t id) const {
    return (int)(((uint64_t)id * 0x9E3779B97F4A7C15ull) >> 60) & (kShards - 1);
  }

  SparseRow& row(int64_t id) {
    int s = shard_of(id);
    auto it = shards[s].find(id);
    if (it == shards[s].end()) {
      SparseRow r;
      r.w.resize(dim);
      // deterministic per-id init (uniform in [-init_range, init_range])
      std::mt19937 gen((uint32_t)(id * 2654435761u) ^ seed_gen());
      std::uniform_real_distribution<float> dist(-init_range, init_range);
      std::mt19937 gen2((uint32_t)(id * 2654435761u));
      for (int64_t i = 0; i < dim; ++i) r.w[i] = dist(gen2);
      it = shards[s].emplace(id, std::move(r)).first;
    }
    return it->second;
  }

  void pull(const int64_t* ids, int64_t n, float* out) {
    for (int64_t i = 0; i < n; ++i) {
      int s = shard_of(ids[i]);
      std::lock_guard<std::mutex> g(mus[s]);
      SparseRow& r = row(ids[i]);
      std::memcpy(out + i * dim, r.w.data(), dim * sizeof(float));
    }
  }

  void push(const int64_t* ids, int64_t n, const float* grads) {
    const float b1 = 0.9f, b2 = 0.999f, eps = 1e-8f;
    for (int64_t i = 0; i < n; ++i) {
      int s = shard_of(ids[i]);
      std::lock_guard<std::mutex> g(mus[s]);
      SparseRow& r = row(ids[i]);
      const float* gr = grads + i * dim;
      switch (rule) {
        case Rule::kSum:
          for (int64_t j = 0; j < dim; ++j) r.w[j] += gr[j];
          break;
        case Rule::kSGD:
          for (int64_t j = 0; j < dim; ++j) r.w[j] -= lr * gr[j];
          break;
        case Rule::kAdam: {
          if (r.m1.empty()) {
            r.m1.assign(dim, 0.f);
            r.m2.assign(dim, 0.f);
          }
          r.step++;
          const float c1 = 1.f - std::pow(b1, (float)r.step);
          const float c2 = 1.f - std::pow(b2, (float)r.step);
          for (int64_t j = 0; j < dim; ++j) {
            r.m1[j] = b1 * r.m1[j] + (1 - b1) * gr[j];
            r.m2[j] = b2 * r.m2[j] + (1 - b2) * gr[j] * gr[j];
            r.w[j] -= lr * (r.m1[j] / c1) / (std::sqrt(r.m2[j] / c2) + eps);
          }
          break;
        }
      }
    }
  }

  int64_t size() const {
    int64_t n = 0;
    for (int s = 0; s < kShards; ++s) n += shards[s].size();
    return n;
  }

  int64_t save(const char* path) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    int64_t n = size();
    std::fwrite(&n, sizeof(n), 1, f);
    std::fwrite(&dim, sizeof(dim), 1, f);
    for (int s = 0; s < kShards; ++s) {
      for (auto& kv : shards[s]) {
        std::fwrite(&kv.first, sizeof(int64_t), 1, f);
        std::fwrite(kv.second.w.data(), sizeof(float), dim, f);
      }
    }
    std::fclose(f);
    return n;
  }

  int64_t load(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t n = 0, d = 0;
    if (std::fread(&n, sizeof(n), 1, f) != 1 ||
        std::fread(&d, sizeof(d), 1, f) != 1 || d != dim) {
      std::fclose(f);
      return -1;
    }
    for (int64_t i = 0; i < n; ++i) {
      int64_t id;
      if (std::fread(&id, sizeof(id), 1, f) != 1) break;
      SparseRow r;
      r.w.resize(dim);
      if (std::fread(r.w.data(), sizeof(float), dim, f) != (size_t)dim)
        break;
      int s = shard_of(id);
      shards[s][id] = std::move(r);
    }
    std::fclose(f);
    return n;
  }
};

}  // namespace

extern "C" {

void* dense_table_create(int64_t size, const char* rule, float lr) {
  return new DenseTable(size, parse_rule(rule), lr);
}

void dense_table_destroy(void* t) { delete (DenseTable*)t; }

void dense_table_pull(void* t, float* out, int64_t n) {
  auto* dt = (DenseTable*)t;
  std::lock_guard<std::mutex> g(dt->mu);
  std::memcpy(out, dt->data.data(),
              std::min<int64_t>(n, dt->data.size()) * sizeof(float));
}

void dense_table_push(void* t, const float* grad, int64_t n) {
  ((DenseTable*)t)->push(grad, n);
}

void dense_table_set(void* t, const float* vals, int64_t n) {
  auto* dt = (DenseTable*)t;
  std::lock_guard<std::mutex> g(dt->mu);
  std::memcpy(dt->data.data(), vals,
              std::min<int64_t>(n, dt->data.size()) * sizeof(float));
}

void* sparse_table_create(int64_t dim, const char* rule, float lr,
                          float init_range, uint32_t seed) {
  return new SparseTable(dim, parse_rule(rule), lr, init_range, seed);
}

void sparse_table_destroy(void* t) { delete (SparseTable*)t; }

void sparse_table_pull(void* t, const int64_t* ids, int64_t n, float* out) {
  ((SparseTable*)t)->pull(ids, n, out);
}

void sparse_table_push(void* t, const int64_t* ids, int64_t n,
                       const float* grads) {
  ((SparseTable*)t)->push(ids, n, grads);
}

int64_t sparse_table_size(void* t) { return ((SparseTable*)t)->size(); }

int64_t sparse_table_save(void* t, const char* path) {
  return ((SparseTable*)t)->save(path);
}

int64_t sparse_table_load(void* t, const char* path) {
  return ((SparseTable*)t)->load(path);
}

}  // extern "C"
