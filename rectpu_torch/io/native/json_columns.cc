// Native JSON request-body -> columnar arrays for the serving hot path: the
// port's copy of rectpu/io/native/json_columns.cc.
//
// The HTTP serving contract (reference: gcloud ml-engine predict request
// shape, reference scripts/mle_deploy.sh + README usage) is
//   {"instances": [{"user_id": 1, "gender": "F", ...}, ...]}
// The Python path (json.loads + per-key list comprehension + np.asarray)
// creates ~rows*cols PyObjects per request; at batch 4096 that conversion
// was the measured encode floor of rectpu's server.
// This parser goes straight from the request bytes to column buffers:
// int64 / float64 vectors and fixed-stride NUL-padded byte columns (the
// exact S-dtype layout rectpu_hash_strings_fixed consumes).
//
// json.loads is the path of malformed and unusual bodies, not of common
// ones: the native parser also covers
//   - any batch size (it always did — rows are dynamic),
//   - backslash escapes incl. \uXXXX with surrogate pairs (decoded to
//     UTF-8, byte-identical to Python's str handling downstream),
//   - non-ASCII UTF-8 strings (passed through raw — the hash consumes
//     exactly the bytes Python's str.encode('utf-8') would produce),
//   - true/false values (int64 1/0 — numpy bool arrays encode identically),
//   - extra scalar-valued top-level keys in any order (TF-serving's
//     "signature_name" rides along), with "instances" anywhere.
// Still DELIBERATELY bailing to the json.loads path (which defines
// behavior, including error semantics): nested values, mixed
// string/number columns, ragged/inconsistent instance keys, null, lone
// surrogates / \u0000 / trailing NUL (S-dtype cannot carry them), malformed
// bodies.

#include <charconv>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Column {
  std::string name;
  // 0 = int64, 1 = float64, 2 = bytes
  int kind = 0;
  std::vector<int64_t> ints;
  std::vector<double> floats;
  // byte columns: (offset, len); offset >= 0 indexes the copied body
  // buffer, offset < 0 encodes -(extra_offset+1) into the escape arena
  std::vector<std::pair<int64_t, int32_t>> spans;
  int64_t max_len = 1;  // S-dtype itemsize is at least 1
  int64_t last_row = -1;
};

struct JsonColumns {
  std::string buf;    // owned copy of the request body
  std::string extra;  // decoded escaped strings (offset-stable arena)
  std::string error;
  std::vector<Column> cols;
  int64_t rows = 0;
};

struct Parser {
  const char* p;
  const char* end;
  JsonColumns* out;

  bool fail(const char* msg) {
    if (out->error.empty()) out->error = msg;
    return false;
  }

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
  }

  bool expect(char c) {
    skip_ws();
    if (p >= end || *p != c) return fail("unexpected token");
    p++;
    return true;
  }

  const char* span_ptr(int64_t off) const {
    return off >= 0 ? out->buf.data() + off : out->extra.data() + (-off - 1);
  }

  static void push_utf8(std::string* s, uint32_t cp) {
    if (cp < 0x80) {
      s->push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
      s->push_back(static_cast<char>(0xC0 | (cp >> 6)));
      s->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      s->push_back(static_cast<char>(0xE0 | (cp >> 12)));
      s->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      s->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
      s->push_back(static_cast<char>(0xF0 | (cp >> 18)));
      s->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
      s->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      s->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
  }

  bool parse_hex4(uint32_t* v) {
    if (end - p < 4) return fail("truncated \\u escape");
    uint32_t r = 0;
    for (int i = 0; i < 4; i++) {
      char c = p[i];
      uint32_t d;
      if (c >= '0' && c <= '9') d = c - '0';
      else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
      else return fail("bad \\u escape");
      r = (r << 4) | d;
    }
    p += 4;
    *v = r;
    return true;
  }

  // Parse a JSON string. Unescaped strings return a span into `buf`;
  // strings with escapes are decoded (UTF-8) into the `extra` arena and
  // return a negative-offset span. Non-ASCII bytes pass through raw.
  bool parse_string(int64_t* off, int32_t* len) {
    skip_ws();
    if (p >= end || *p != '"') return fail("expected string");
    p++;
    const char* start = p;
    // fast scan: no escape, no control char
    while (p < end && *p != '"' && *p != '\\'
           && static_cast<unsigned char>(*p) >= 0x20)
      p++;
    if (p < end && *p == '"') {
      *off = start - out->buf.data();
      *len = static_cast<int32_t>(p - start);
      p++;
      return true;
    }
    if (p >= end) return fail("unterminated string");
    if (static_cast<unsigned char>(*p) < 0x20) return fail("control char in string");
    // slow path: decode into the arena
    std::string dec(start, static_cast<size_t>(p - start));
    while (p < end) {
      unsigned char c = static_cast<unsigned char>(*p);
      if (c == '"') {
        p++;
        if (dec.size() > static_cast<size_t>(INT32_MAX)) return fail("string too long");
        if (!dec.empty() && dec.back() == '\0')
          return fail("trailing NUL (S-dtype cannot carry it; fallback)");
        *off = -(static_cast<int64_t>(out->extra.size()) + 1);
        *len = static_cast<int32_t>(dec.size());
        out->extra.append(dec);
        return true;
      }
      if (c == '\\') {
        p++;
        if (p >= end) return fail("truncated escape");
        char e = *p;
        p++;
        switch (e) {
          case '"': dec.push_back('"'); break;
          case '\\': dec.push_back('\\'); break;
          case '/': dec.push_back('/'); break;
          case 'b': dec.push_back('\b'); break;
          case 'f': dec.push_back('\f'); break;
          case 'n': dec.push_back('\n'); break;
          case 'r': dec.push_back('\r'); break;
          case 't': dec.push_back('\t'); break;
          case 'u': {
            uint32_t cp;
            if (!parse_hex4(&cp)) return false;
            if (cp >= 0xD800 && cp <= 0xDBFF) {
              // surrogate pair
              if (end - p < 2 || p[0] != '\\' || p[1] != 'u')
                return fail("lone surrogate (fallback)");
              p += 2;
              uint32_t lo;
              if (!parse_hex4(&lo)) return false;
              if (lo < 0xDC00 || lo > 0xDFFF)
                return fail("lone surrogate (fallback)");
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
              return fail("lone surrogate (fallback)");
            }
            if (cp == 0) return fail("\\u0000 (S-dtype cannot carry NUL; fallback)");
            push_utf8(&dec, cp);
            break;
          }
          default:
            return fail("bad escape");
        }
        continue;
      }
      if (c < 0x20) return fail("control char in string");
      dec.push_back(static_cast<char>(c));
      p++;
    }
    return fail("unterminated string");
  }

  bool push_int(Column* col, int64_t v, int64_t row) {
    if (col->kind == 2) return fail("mixed string/number column (fallback)");
    if (col->kind == 1)
      col->floats.push_back(static_cast<double>(v));
    else
      col->ints.push_back(v);
    col->last_row = row;
    return true;
  }

  // Number token: [-]digits[.digits][eE...]; from_chars for exactness.
  bool parse_number(Column* col, int64_t row) {
    skip_ws();
    const char* start = p;
    if (p < end && *p == '-') p++;
    bool is_float = false;
    while (p < end) {
      char c = *p;
      if (c >= '0' && c <= '9') { p++; continue; }
      if (c == '.' || c == 'e' || c == 'E' || c == '+' || c == '-') {
        if (c == '.' || c == 'e' || c == 'E') is_float = true;
        // '+'/'-' only valid inside an exponent; from_chars validates
        if (!is_float && (c == '+' || c == '-')) break;
        p++;
        continue;
      }
      break;
    }
    if (p == start) return fail("expected number");
    if (col->kind == 2) return fail("mixed string/number column (fallback)");
    if (is_float && col->kind == 0) {
      // promote the column: ints seen so far become doubles
      col->kind = 1;
      col->floats.reserve(col->ints.size());
      for (int64_t v : col->ints) col->floats.push_back(static_cast<double>(v));
      col->ints.clear();
    }
    if (col->kind == 1) {
      double v;
      auto r = std::from_chars(start, p, v);
      if (r.ec != std::errc() || r.ptr != p) return fail("bad float literal");
      col->floats.push_back(v);
    } else {
      int64_t v;
      auto r = std::from_chars(start, p, v);
      if (r.ec != std::errc() || r.ptr != p)
        return fail(is_float ? "bad float literal" : "int overflow (fallback)");
      col->ints.push_back(v);
    }
    col->last_row = row;
    return true;
  }

  bool literal(const char* word, int64_t n) {
    if (end - p < n || memcmp(p, word, static_cast<size_t>(n)) != 0)
      return fail("unsupported value type (fallback)");
    p += n;
    return true;
  }

  Column* find_col(const char* name, int32_t len, size_t hint) {
    auto& cols = out->cols;
    if (hint < cols.size() && cols[hint].name.size() == static_cast<size_t>(len)
        && memcmp(cols[hint].name.data(), name, len) == 0)
      return &cols[hint];
    for (auto& c : cols)
      if (c.name.size() == static_cast<size_t>(len)
          && memcmp(c.name.data(), name, len) == 0)
        return &c;
    return nullptr;
  }

  bool parse_instance(int64_t row) {
    if (!expect('{')) return false;
    skip_ws();
    size_t filled = 0;
    if (p < end && *p == '}') { p++; goto done; }
    while (true) {
      int64_t koff; int32_t klen;
      if (!parse_string(&koff, &klen)) return false;
      if (!expect(':')) return false;
      // span_ptr stays valid until the NEXT parse_string (the arena only
      // grows then); col->name copies immediately below
      const char* kname = span_ptr(koff);
      Column* col;
      if (row == 0) {
        if (find_col(kname, klen, filled) != nullptr)
          return fail("duplicate key");
        out->cols.emplace_back();
        col = &out->cols.back();
        col->name.assign(kname, klen);
      } else {
        col = find_col(kname, klen, filled);
        if (col == nullptr) return fail("inconsistent instance keys (fallback)");
        if (col->last_row == row) return fail("duplicate key");
      }
      skip_ws();
      if (p >= end) return fail("truncated body");
      if (*p == '"') {
        int64_t voff; int32_t vlen;
        if (!parse_string(&voff, &vlen)) return false;
        if (row == 0 && col->spans.empty() && col->ints.empty()
            && col->floats.empty()) {
          col->kind = 2;
        } else if (col->kind != 2) {
          return fail("mixed string/number column (fallback)");
        }
        col->spans.emplace_back(voff, vlen);
        if (vlen > col->max_len) col->max_len = vlen;
        col->last_row = row;
      } else if ((*p >= '0' && *p <= '9') || *p == '-') {
        if (!parse_number(col, row)) return false;
      } else if (*p == 't') {
        if (!literal("true", 4) || !push_int(col, 1, row)) return false;
      } else if (*p == 'f') {
        if (!literal("false", 5) || !push_int(col, 0, row)) return false;
      } else {
        return fail("unsupported value type (fallback)");
      }
      filled++;
      skip_ws();
      if (p < end && *p == ',') { p++; continue; }
      if (p < end && *p == '}') { p++; break; }
      return fail("unexpected token in instance");
    }
  done:
    if (row == 0) return true;
    if (filled != out->cols.size())
      return fail("inconsistent instance keys (fallback)");
    return true;
  }

  bool parse_instances_array() {
    if (!expect('[')) return false;
    skip_ws();
    if (p < end && *p == ']') {
      p++;
      return true;
    }
    int64_t row = 0;
    while (true) {
      if (!parse_instance(row)) return false;
      row++;
      skip_ws();
      if (p < end && *p == ',') { p++; continue; }
      if (p < end && *p == ']') { p++; break; }
      return fail("unexpected token in instances array");
    }
    out->rows = row;
    return true;
  }

  // Skip an extra top-level key's SCALAR value (e.g. "signature_name":
  // "serving_default"). Nested values bail to the fallback.
  bool skip_scalar() {
    skip_ws();
    if (p >= end) return fail("truncated body");
    if (*p == '"') {
      int64_t off; int32_t len;
      return parse_string(&off, &len);
    }
    if ((*p >= '0' && *p <= '9') || *p == '-') {
      const char* start = p;
      if (*p == '-') p++;
      while (p < end && ((*p >= '0' && *p <= '9') || *p == '.' || *p == 'e'
                         || *p == 'E' || *p == '+' || *p == '-'))
        p++;
      return p != start || fail("expected number");
    }
    if (*p == 't') return literal("true", 4);
    if (*p == 'f') return literal("false", 5);
    if (*p == 'n') return literal("null", 4);
    return fail("unsupported extra-key value (fallback)");
  }

  bool parse_body() {
    if (!expect('{')) return false;
    bool saw_instances = false;
    skip_ws();
    if (p < end && *p == '}') {
      p++;
    } else {
      while (true) {
        int64_t koff; int32_t klen;
        if (!parse_string(&koff, &klen)) return false;
        bool is_instances =
            klen == 9 && memcmp(span_ptr(koff), "instances", 9) == 0;
        if (!expect(':')) return false;
        if (is_instances) {
          if (saw_instances) return fail("duplicate instances key");
          if (!parse_instances_array()) return false;
          saw_instances = true;
        } else {
          if (!skip_scalar()) return false;
        }
        skip_ws();
        if (p < end && *p == ',') { p++; continue; }
        if (p < end && *p == '}') { p++; break; }
        return fail("unexpected token at top level");
      }
    }
    if (!saw_instances) return fail("no instances key (fallback)");
    skip_ws();
    if (p != end) return fail("trailing bytes");
    return true;
  }
};

}  // namespace

extern "C" void* rectpu_json_parse(const char* data, int64_t len) {
  auto* h = new JsonColumns();
  h->buf.assign(data, static_cast<size_t>(len));
  Parser parser{h->buf.data(), h->buf.data() + h->buf.size(), h};
  if (!parser.parse_body() && h->error.empty()) h->error = "parse error";
  return h;
}

extern "C" const char* rectpu_json_error(void* h) {
  auto* j = static_cast<JsonColumns*>(h);
  return j->error.empty() ? nullptr : j->error.c_str();
}

extern "C" int64_t rectpu_json_rows(void* h) {
  return static_cast<JsonColumns*>(h)->rows;
}

extern "C" int64_t rectpu_json_cols(void* h) {
  return static_cast<int64_t>(static_cast<JsonColumns*>(h)->cols.size());
}

// name_out points into the handle (valid until rectpu_json_free);
// kind: 0 int64, 1 float64, 2 bytes (stride = itemsize of the S column).
extern "C" int rectpu_json_col_info(void* h, int64_t i, const char** name_out,
                                    int64_t* name_len, int64_t* kind_out,
                                    int64_t* stride_out) {
  auto* j = static_cast<JsonColumns*>(h);
  if (i < 0 || i >= static_cast<int64_t>(j->cols.size())) return -1;
  const Column& c = j->cols[static_cast<size_t>(i)];
  *name_out = c.name.data();
  *name_len = static_cast<int64_t>(c.name.size());
  *kind_out = c.kind;
  *stride_out = c.max_len;
  return 0;
}

// out must hold rows*8 bytes (kinds 0/1) or rows*stride bytes, PRE-ZEROED
// for byte columns (NUL padding).
extern "C" int rectpu_json_col_copy(void* h, int64_t i, void* out) {
  auto* j = static_cast<JsonColumns*>(h);
  if (i < 0 || i >= static_cast<int64_t>(j->cols.size())) return -1;
  const Column& c = j->cols[static_cast<size_t>(i)];
  if (c.kind == 0) {
    memcpy(out, c.ints.data(), c.ints.size() * sizeof(int64_t));
  } else if (c.kind == 1) {
    memcpy(out, c.floats.data(), c.floats.size() * sizeof(double));
  } else {
    char* dst = static_cast<char*>(out);
    for (size_t r = 0; r < c.spans.size(); r++) {
      const auto& s = c.spans[r];
      const char* src = s.first >= 0 ? j->buf.data() + s.first
                                     : j->extra.data() + (-s.first - 1);
      memcpy(dst + r * c.max_len, src, static_cast<size_t>(s.second));
    }
  }
  return 0;
}

extern "C" void rectpu_json_free(void* h) { delete static_cast<JsonColumns*>(h); }
