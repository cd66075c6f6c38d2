// Native CSV input pipeline: parse + feature-encode, multithreaded.
//
// The port's copy of rectpu/io/native/csv_loader.cc: the replacement for the
// reference's tf.data C++ CSV kernels (TextLineDataset/decode_csv/
// map(parallel=8), reference trainers/ml_100k.py:44-58): the whole file is read once, rows are split across a
// thread pool, and each row is parsed (RFC-4180 quoting) and encoded straight
// to dense global feature ids + label — the device-ready layout — so the
// per-step host work during training is zero.
//
// The feature schema arrives as a line-oriented spec built by
// rectpu_torch/io/native/csv_bridge.py from the FeatureSet:
//   hash:<col>:<buckets>:<int|str>
//   vocab:<col>:<num_oov>:<v1,v2,...>
//   bucket:<col>:<b1,b2,...>
//   identity:<col>:<num_buckets>
//   numeric:<col>
//   label:<col>:<cutoff>
// Encoding semantics are identical to rectpu_torch/features/schema.py (held
// against rectpu's pandas loader in tests/test_torch_native.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

extern "C" uint64_t rectpu_fingerprint64(const char* s, size_t len);

namespace {

struct StringPiece {
  const char* data;
  size_t len;
  std::string str() const { return std::string(data, len); }
  bool empty() const { return len == 0; }
};

enum class Kind { kHash, kVocab, kBucket, kIdentity, kNumeric, kLabel };

struct FeatureSpec {
  Kind kind;
  std::string column;
  int col_index = -1;
  bool int_input = false;           // hash: stringify-an-int semantics
  int64_t buckets = 0;              // hash/identity bucket count
  int64_t num_oov = 1;              // vocab
  std::vector<std::string> vocab;   // vocab
  std::vector<double> boundaries;   // bucket
  double cutoff = 5;                // label
  int64_t offset = 0;               // global id offset (cumulative)

  int64_t bucket_count() const {
    switch (kind) {
      case Kind::kHash:
      case Kind::kIdentity:
        return buckets;
      case Kind::kVocab:
        return static_cast<int64_t>(vocab.size()) + num_oov;
      case Kind::kBucket:
        return static_cast<int64_t>(boundaries.size()) + 1;
      default:
        return 0;
    }
  }
};

struct CsvFile {
  std::string buffer;
  std::vector<size_t> row_starts;  // offsets of data rows (header excluded)
  std::vector<std::string> header;
  std::string error;
  int num_threads = 8;
};

std::vector<std::string> split(const std::string& s, char sep) {
  std::vector<std::string> out;
  size_t start = 0;
  for (size_t i = 0; i <= s.size(); ++i) {
    if (i == s.size() || s[i] == sep) {
      out.push_back(s.substr(start, i - start));
      start = i + 1;
    }
  }
  return out;
}

// Split one CSV record (quoted fields supported). Fields that contain escaped
// quotes are unescaped into `scratch` (rare path); plain fields are zero-copy.
void split_csv_row(const char* p, const char* end, std::vector<StringPiece>* out,
                   std::vector<std::string>* scratch) {
  out->clear();
  scratch->clear();
  while (p <= end) {
    if (p < end && *p == '"') {
      ++p;
      const char* field_start = p;
      bool has_escape = false;
      while (p < end) {
        if (*p == '"') {
          if (p + 1 < end && p[1] == '"') {
            has_escape = true;
            p += 2;
          } else {
            break;
          }
        } else {
          ++p;
        }
      }
      if (!has_escape) {
        out->push_back({field_start, static_cast<size_t>(p - field_start)});
      } else {
        scratch->emplace_back();
        std::string& s = scratch->back();
        for (const char* q = field_start; q < p; ++q) {
          s.push_back(*q);
          if (*q == '"') ++q;  // collapse ""
        }
        out->push_back({s.data(), s.size()});
      }
      if (p < end) ++p;  // closing quote
      if (p < end && *p == ',') {
        ++p;
        if (p == end) out->push_back({p, 0});  // trailing empty field
      } else {
        break;
      }
    } else {
      const char* field_start = p;
      while (p < end && *p != ',') ++p;
      out->push_back({field_start, static_cast<size_t>(p - field_start)});
      if (p < end) {
        ++p;  // skip comma
        if (p == end) out->push_back({p, 0});
      } else {
        break;
      }
    }
  }
}

double parse_double(const StringPiece& f, double dflt) {
  if (f.empty()) return dflt;
  char buf[64];
  size_t n = std::min(f.len, sizeof(buf) - 1);
  std::memcpy(buf, f.data, n);
  buf[n] = 0;
  char* endp = nullptr;
  double v = std::strtod(buf, &endp);
  return endp == buf ? dflt : v;
}

int64_t parse_int(const StringPiece& f, int64_t dflt) {
  double v = parse_double(f, static_cast<double>(dflt));
  return static_cast<int64_t>(v);
}

int32_t encode_one(const FeatureSpec& spec, const StringPiece& field) {
  switch (spec.kind) {
    case Kind::kHash: {
      if (spec.int_input) {
        // TF as_string(int) semantics: normalize through an integer parse
        char buf[24];
        int len = std::snprintf(buf, sizeof(buf), "%lld",
                                static_cast<long long>(parse_int(field, 0)));
        return static_cast<int32_t>(rectpu_fingerprint64(buf, len) %
                                    static_cast<uint64_t>(spec.buckets));
      }
      const char* d = field.empty() ? "null" : field.data;
      size_t n = field.empty() ? 4 : field.len;
      return static_cast<int32_t>(rectpu_fingerprint64(d, n) %
                                  static_cast<uint64_t>(spec.buckets));
    }
    case Kind::kVocab: {
      std::string v = field.empty() ? "null" : field.str();
      for (size_t i = 0; i < spec.vocab.size(); ++i) {
        if (spec.vocab[i] == v) return static_cast<int32_t>(i);
      }
      return static_cast<int32_t>(
          spec.vocab.size() +
          rectpu_fingerprint64(v.data(), v.size()) % static_cast<uint64_t>(spec.num_oov));
    }
    case Kind::kBucket: {
      double v = parse_double(field, 0.0);
      // searchsorted(boundaries, v, side='right')
      int32_t idx = static_cast<int32_t>(
          std::upper_bound(spec.boundaries.begin(), spec.boundaries.end(), v) -
          spec.boundaries.begin());
      return idx;
    }
    case Kind::kIdentity: {
      int64_t v = parse_int(field, 0);
      if (v < 0) v = 0;
      if (v >= spec.buckets) v = spec.buckets - 1;
      return static_cast<int32_t>(v);
    }
    default:
      return 0;
  }
}

}  // namespace

static void rectpu_csv_index(CsvFile* f);

extern "C" void* rectpu_csv_open(const char* path, int num_threads) {
  auto* f = new CsvFile();
  f->num_threads = num_threads > 0 ? num_threads : 8;
  std::ifstream in(path, std::ios::binary);
  if (!in) {
    f->error = "cannot open file";
    return f;
  }
  in.seekg(0, std::ios::end);
  f->buffer.resize(static_cast<size_t>(in.tellg()));
  in.seekg(0);
  in.read(&f->buffer[0], f->buffer.size());
  rectpu_csv_index(f);
  return f;
}

// Streaming entry: parse a window of CSV bytes already in memory (header
// line included) — the out-of-core loader (io/loader.StreamingCsvDataset)
// reads chunk byte-ranges and encodes them through this without the file
// ever being resident.
extern "C" void* rectpu_csv_open_mem(const char* data, int64_t len,
                                     int num_threads) {
  auto* f = new CsvFile();
  f->num_threads = num_threads > 0 ? num_threads : 8;
  f->buffer.assign(data, static_cast<size_t>(len));
  rectpu_csv_index(f);
  return f;
}

static void rectpu_csv_index(CsvFile* f) {
  const std::string& b = f->buffer;
  size_t pos = 0;
  // header line
  size_t eol = b.find('\n');
  if (eol == std::string::npos) {
    f->error = "no header";
    return;
  }
  std::string header_line = b.substr(0, eol);
  if (!header_line.empty() && header_line.back() == '\r') header_line.pop_back();
  f->header = split(header_line, ',');
  pos = eol + 1;
  // data row offsets (quote-aware: newlines inside quoted fields stay in-row)
  bool in_quotes = false;
  size_t row_start = pos;
  for (size_t i = pos; i < b.size(); ++i) {
    char c = b[i];
    if (c == '"') {
      in_quotes = !in_quotes;
    } else if (c == '\n' && !in_quotes) {
      if (i > row_start) f->row_starts.push_back(row_start);
      row_start = i + 1;
    }
  }
  if (row_start < b.size()) f->row_starts.push_back(row_start);
}

extern "C" int64_t rectpu_csv_rows(void* h) {
  return static_cast<CsvFile*>(h)->row_starts.size();
}

extern "C" const char* rectpu_csv_error(void* h) {
  auto* f = static_cast<CsvFile*>(h);
  return f->error.empty() ? nullptr : f->error.c_str();
}

extern "C" void rectpu_csv_free(void* h) { delete static_cast<CsvFile*>(h); }

extern "C" int rectpu_csv_encode(void* h, const char* spec_text, int32_t* out_ids,
                                 float* out_num, float* out_labels) {
  auto* f = static_cast<CsvFile*>(h);
  if (!f->error.empty()) return 1;

  // parse spec
  std::vector<FeatureSpec> cats, nums;
  FeatureSpec label;
  bool has_label = false;
  for (const std::string& line : split(std::string(spec_text), '\n')) {
    if (line.empty()) continue;
    auto parts = split(line, ':');
    FeatureSpec s;
    s.column = parts[1];
    if (parts[0] == "hash") {
      s.kind = Kind::kHash;
      s.buckets = std::stoll(parts[2]);
      s.int_input = parts.size() > 3 && parts[3] == "int";
      cats.push_back(s);
    } else if (parts[0] == "vocab") {
      s.kind = Kind::kVocab;
      s.num_oov = std::stoll(parts[2]);
      s.vocab = split(parts[3], ',');
      cats.push_back(s);
    } else if (parts[0] == "bucket") {
      s.kind = Kind::kBucket;
      for (const auto& x : split(parts[2], ',')) s.boundaries.push_back(std::stod(x));
      cats.push_back(s);
    } else if (parts[0] == "identity") {
      s.kind = Kind::kIdentity;
      s.buckets = std::stoll(parts[2]);
      cats.push_back(s);
    } else if (parts[0] == "numeric") {
      s.kind = Kind::kNumeric;
      nums.push_back(s);
    } else if (parts[0] == "label") {
      s.kind = Kind::kLabel;
      s.cutoff = std::stod(parts[2]);
      label = s;
      has_label = true;
    } else {
      f->error = "unknown spec kind: " + parts[0];
      return 1;
    }
  }
  // global-id offsets, cumulative in spec order (matches FeatureSet.offsets)
  int64_t off = 0;
  for (auto& s : cats) {
    s.offset = off;
    off += s.bucket_count();
  }
  // resolve column indices
  auto col_of = [&](const std::string& name) -> int {
    for (size_t i = 0; i < f->header.size(); ++i)
      if (f->header[i] == name) return static_cast<int>(i);
    return -1;
  };
  for (auto* group : {&cats, &nums}) {
    for (auto& s : *group) {
      s.col_index = col_of(s.column);
      if (s.col_index < 0 && s.kind != Kind::kIdentity) {
        // missing column: defaults apply (index stays -1)
      }
    }
  }
  if (has_label) {
    label.col_index = col_of(label.column);
    if (label.col_index < 0) {
      f->error = "label column not found: " + label.column;
      return 1;
    }
  }

  const int64_t rows = static_cast<int64_t>(f->row_starts.size());
  const size_t n_cat = cats.size();
  const size_t n_num = nums.size();
  const char* base = f->buffer.data();
  const char* buf_end = base + f->buffer.size();

  auto worker = [&](int64_t lo, int64_t hi) {
    std::vector<StringPiece> fields;
    std::vector<std::string> scratch;
    fields.reserve(f->header.size() + 4);
    StringPiece empty{nullptr, 0};
    for (int64_t r = lo; r < hi; ++r) {
      const char* p = base + f->row_starts[r];
      const char* end =
          (r + 1 < rows) ? base + f->row_starts[r + 1] - 1 : buf_end;
      while (end > p && (end[-1] == '\n' || end[-1] == '\r')) --end;
      split_csv_row(p, end, &fields, &scratch);
      auto get = [&](int idx) -> const StringPiece& {
        return (idx >= 0 && idx < static_cast<int>(fields.size())) ? fields[idx]
                                                                   : empty;
      };
      for (size_t c = 0; c < n_cat; ++c) {
        out_ids[r * n_cat + c] =
            encode_one(cats[c], get(cats[c].col_index)) +
            static_cast<int32_t>(cats[c].offset);
      }
      for (size_t c = 0; c < n_num; ++c) {
        out_num[r * n_num + c] =
            static_cast<float>(parse_double(get(nums[c].col_index), 0.0));
      }
      if (has_label) {
        out_labels[r] =
            parse_double(get(label.col_index), 0.0) >= label.cutoff ? 1.0f : 0.0f;
      }
    }
  };

  int nt = std::max(1, std::min<int>(f->num_threads, static_cast<int>(rows / 1024) + 1));
  if (nt == 1) {
    worker(0, rows);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (rows + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t lo = t * chunk;
      int64_t hi = std::min(rows, lo + chunk);
      if (lo < hi) threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  return 0;
}
