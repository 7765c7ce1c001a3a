// Fast JSON reader for reference-format documents.
//
// The reference vendors rapidjson (src/rapidjson/) and parses every
// problem file through it (DwnNetwork/ScenarioTree/Forecaster/
// SmpcConfiguration ctors).  This is the counterpart for the JAX
// framework's data layer: a single-pass parser specialised for the flat
// {"key": [numbers...], "key": "string"} documents the formats use,
// ~10-30x faster than Python's json module on MB-scale scenario trees.
//
// C API (ctypes-friendly):
//   jf_parse(path)              -> handle (0 on failure)
//   jf_num_keys(h)              -> number of members
//   jf_key_name(h, i)           -> member name (borrowed pointer)
//   jf_array_len(h, key)        -> element count (-1 if not an array)
//   jf_get_array(h, key, out)   -> copy values into double* out
//   jf_get_string(h, key)       -> borrowed char* ("" if absent)
//   jf_free(h)

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Value {
  std::vector<double> numbers;
  std::string str;
  bool is_array = false;
};

struct Document {
  std::vector<std::string> order;
  std::unordered_map<std::string, Value> members;
};

class Parser {
 public:
  explicit Parser(const char* data, size_t n) : p_(data), end_(data + n) {}

  bool parse(Document* doc) {
    skip_ws();
    if (!expect('{')) return false;
    skip_ws();
    if (peek() == '}') return true;
    while (true) {
      skip_ws();
      std::string key;
      if (!parse_string(&key)) return false;
      skip_ws();
      if (!expect(':')) return false;
      skip_ws();
      Value v;
      if (!parse_value(&v)) return false;
      doc->order.push_back(key);
      doc->members.emplace(std::move(key), std::move(v));
      skip_ws();
      char c = next();
      if (c == ',') continue;
      if (c == '}') return true;
      return false;
    }
  }

 private:
  const char* p_;
  const char* end_;

  char peek() const { return p_ < end_ ? *p_ : '\0'; }
  char next() { return p_ < end_ ? *p_++ : '\0'; }
  bool expect(char c) { return next() == c; }
  void skip_ws() {
    while (p_ < end_ && (unsigned char)*p_ <= ' ') ++p_;
  }

  bool parse_string(std::string* out) {
    if (!expect('"')) return false;
    const char* start = p_;
    while (p_ < end_ && *p_ != '"') {
      if (*p_ == '\\') ++p_;
      ++p_;
    }
    if (p_ >= end_) return false;
    out->assign(start, p_ - start);
    ++p_;  // closing quote
    return true;
  }

  bool parse_number(double* out) {
    char* endp = nullptr;
    *out = strtod(p_, &endp);
    if (endp == p_) return false;
    p_ = endp;
    return true;
  }

  bool parse_value(Value* v) {
    skip_ws();
    char c = peek();
    if (c == '[') {
      ++p_;
      v->is_array = true;
      skip_ws();
      if (peek() == ']') {
        ++p_;
        return true;
      }
      while (true) {
        skip_ws();
        double d;
        if (!parse_number(&d)) return false;
        v->numbers.push_back(d);
        skip_ws();
        char t = next();
        if (t == ',') continue;
        if (t == ']') return true;
        return false;
      }
    }
    if (c == '"') return parse_string(&v->str);
    // bare number / true / false / null (numbers only in practice)
    if (c == 't') { p_ += 4; v->numbers.push_back(1); return true; }
    if (c == 'f') { p_ += 5; v->numbers.push_back(0); return true; }
    if (c == 'n') { p_ += 4; return true; }
    double d;
    if (!parse_number(&d)) return false;
    v->numbers.push_back(d);
    return true;
  }
};

}  // namespace

extern "C" {

void* jf_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize((size_t)n);
  if (fread(&buf[0], 1, (size_t)n, f) != (size_t)n) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  auto* doc = new Document();
  Parser parser(buf.data(), buf.size());
  if (!parser.parse(doc)) {
    delete doc;
    return nullptr;
  }
  return doc;
}

int64_t jf_num_keys(void* h) {
  return (int64_t)((Document*)h)->order.size();
}

const char* jf_key_name(void* h, int64_t i) {
  auto* doc = (Document*)h;
  if (i < 0 || i >= (int64_t)doc->order.size()) return "";
  return doc->order[(size_t)i].c_str();
}

int64_t jf_array_len(void* h, const char* key) {
  auto* doc = (Document*)h;
  auto it = doc->members.find(key);
  if (it == doc->members.end()) return -1;
  if (!it->second.is_array && it->second.numbers.empty()) return -1;
  return (int64_t)it->second.numbers.size();
}

int64_t jf_get_array(void* h, const char* key, double* out) {
  auto* doc = (Document*)h;
  auto it = doc->members.find(key);
  if (it == doc->members.end()) return -1;
  const auto& v = it->second.numbers;
  memcpy(out, v.data(), v.size() * sizeof(double));
  return (int64_t)v.size();
}

const char* jf_get_string(void* h, const char* key) {
  auto* doc = (Document*)h;
  auto it = doc->members.find(key);
  if (it == doc->members.end()) return "";
  return it->second.str.c_str();
}

void jf_free(void* h) { delete (Document*)h; }

// ---------------------------------------------------------------------
// Scenario-tree fan-layout preprocessing (counterpart of the pointer
// bookkeeping in src/Engine.cu:200-221 and the host-side tree walks).
// All ids 0-based; ancestor[root] = -1.

// node_of_slot: (N*ns) out, rep: (N*ns) out.  Returns 0 on success,
// 1 if the leaf ordering makes a node's slots non-contiguous.
int64_t tree_fan_layout(const int32_t* ancestor, const int32_t* stage,
                        const int32_t* leaves, int64_t n_nodes,
                        int64_t N, int64_t ns, int32_t* node_of_slot,
                        uint8_t* rep) {
  (void)stage;
  (void)n_nodes;
  for (int64_t i = 0; i < ns; ++i) {
    int32_t node = leaves[i];
    for (int64_t s = N - 1; s >= 0; --s) {
      node_of_slot[s * ns + i] = node;
      node = ancestor[node];
    }
  }
  for (int64_t s = 0; s < N; ++s) {
    const int32_t* row = node_of_slot + s * ns;
    rep[s * ns] = 1;
    for (int64_t i = 1; i < ns; ++i) {
      rep[s * ns + i] = (uint8_t)(row[i] != row[i - 1]);
      // contiguity: a node id may not reappear after a change
      if (row[i] != row[i - 1]) {
        for (int64_t j = 0; j < i - 1; ++j) {
          if (row[j] == row[i]) return 1;
        }
      }
    }
  }
  return 0;
}

// Dense one-hot aggregation matrix C_s (ns x ns) for the handoff from
// stage s to s-1: C[i, j] = 1 when slot j at stage s is the
// representative slot of a child of the node at stage s-1 slot i.
void tree_prefix_agg(const int32_t* ancestor, const int32_t* node_of_slot,
                     const uint8_t* rep, int64_t ns, int64_t s,
                     float* C) {
  const int32_t* row_s = node_of_slot + s * ns;
  const int32_t* row_p = node_of_slot + (s - 1) * ns;
  const uint8_t* rep_s = rep + s * ns;
  memset(C, 0, sizeof(float) * (size_t)(ns * ns));
  for (int64_t i = 0; i < ns; ++i) {
    for (int64_t j = 0; j < ns; ++j) {
      if (rep_s[j] && ancestor[row_s[j]] == row_p[i]) {
        C[i * ns + j] = 1.0f;
      }
    }
  }
}

}  // extern "C"
