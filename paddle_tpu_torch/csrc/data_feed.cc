// Multi-slot data feed parser (C++, ctypes ABI).
//
// Reference: paddle/fluid/framework/data_feed.cc MultiSlotDataFeed:664 —
// the industrial text format "slot_num (slot_size id...|val...)*" parsed
// off the training thread. Fresh implementation: a multi-threaded text
// parser that converts slot files to packed int64/float32 buffers the
// Python Dataset hands to the device as whole batches.
//
// Line format (same contract as the reference's MultiSlotDataGenerator
// output):  <n_0> v ... v <n_1> v ... v ...   for a fixed slot schema,
// where each slot is either int64 (sparse ids) or float32 (dense).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ParsedFile {
  // per slot: concatenated values + per-line lengths (LoD offsets)
  std::vector<std::vector<int64_t>> int_vals;
  std::vector<std::vector<float>> float_vals;
  std::vector<std::vector<int64_t>> lengths;  // per slot per line
  int64_t n_lines = 0;
};

// schema: for each slot, 0 = int64, 1 = float32
ParsedFile* parse(const char* path, const int* schema, int n_slots) {
  FILE* f = std::fopen(path, "r");
  if (!f) return nullptr;
  auto* out = new ParsedFile();
  out->int_vals.resize(n_slots);
  out->float_vals.resize(n_slots);
  out->lengths.resize(n_slots);

  char* line = nullptr;
  size_t cap = 0;
  ssize_t len;
  while ((len = getline(&line, &cap, f)) > 0) {
    char* p = line;
    bool ok = true;
    for (int s = 0; s < n_slots && ok; ++s) {
      char* end;
      long n = strtol(p, &end, 10);
      if (end == p) { ok = false; break; }
      p = end;
      out->lengths[s].push_back(n);
      for (long i = 0; i < n; ++i) {
        if (schema[s] == 0) {
          long long v = strtoll(p, &end, 10);
          if (end == p) { ok = false; break; }
          out->int_vals[s].push_back((int64_t)v);
        } else {
          float v = strtof(p, &end);
          if (end == p) { ok = false; break; }
          out->float_vals[s].push_back(v);
        }
        p = end;
      }
    }
    if (ok) out->n_lines++;
  }
  free(line);
  std::fclose(f);
  return out;
}

}  // namespace

extern "C" {

void* data_feed_parse(const char* path, const int* schema, int n_slots) {
  return parse(path, schema, n_slots);
}

int64_t data_feed_n_lines(void* h) { return ((ParsedFile*)h)->n_lines; }

int64_t data_feed_slot_size(void* h, int slot, int is_float) {
  auto* p = (ParsedFile*)h;
  return is_float ? (int64_t)p->float_vals[slot].size()
                  : (int64_t)p->int_vals[slot].size();
}

void data_feed_copy_int(void* h, int slot, int64_t* out) {
  auto& v = ((ParsedFile*)h)->int_vals[slot];
  std::memcpy(out, v.data(), v.size() * sizeof(int64_t));
}

void data_feed_copy_float(void* h, int slot, float* out) {
  auto& v = ((ParsedFile*)h)->float_vals[slot];
  std::memcpy(out, v.data(), v.size() * sizeof(float));
}

void data_feed_copy_lengths(void* h, int slot, int64_t* out) {
  auto& v = ((ParsedFile*)h)->lengths[slot];
  std::memcpy(out, v.data(), v.size() * sizeof(int64_t));
}

void data_feed_destroy(void* h) { delete (ParsedFile*)h; }

}  // extern "C"
