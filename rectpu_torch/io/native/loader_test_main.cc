// Standalone native-loader test binary, a copy of rectpu's
// (rectpu/io/native/loader_test_main.cc), built with the port's three
// sources under ASan+UBSan and under TSan (tests/test_torch_native_sanitizers.py):
// generates a CSV with quoting/missing edge cases, parses+encodes it across
// threads, and checks invariants. Exercises the same code paths the Python
// bindings use, so the sanitizer runs cover the production parser.
//
//   loader_test [scratch.csv]
//
// The one change from rectpu's copy: the scratch CSV's path may be given, so
// that runs in parallel (rectpu's binary among them) do not share a file.

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

extern "C" {
uint64_t rectpu_fingerprint64(const char* s, size_t len);
void rectpu_hash_ints(const int64_t* vals, size_t n, int64_t buckets, int32_t* out);
void rectpu_hash_strings_fixed(const char* buf, int64_t itemsize, size_t n,
                               int64_t buckets, int32_t* out);
void* rectpu_csv_open(const char* path, int num_threads);
int64_t rectpu_csv_rows(void* h);
const char* rectpu_csv_error(void* h);
int rectpu_csv_encode(void* h, const char* spec, int32_t* out_ids, float* out_num,
                      float* out_labels);
void rectpu_csv_free(void* h);
void* rectpu_json_parse(const char* data, int64_t len);
const char* rectpu_json_error(void* h);
int64_t rectpu_json_rows(void* h);
int64_t rectpu_json_cols(void* h);
int rectpu_json_col_info(void* h, int64_t i, const char** name_out,
                         int64_t* name_len, int64_t* kind_out, int64_t* stride_out);
int rectpu_json_col_copy(void* h, int64_t i, void* out);
void rectpu_json_free(void* h);
}

int main(int argc, char** argv) {
  const char* path = argc > 1 ? argv[1] : "/tmp/rectpu_loader_test.csv";
  {
    std::ofstream f(path);
    f << "user_id,item_id,rating,age,gender,occupation,zipcode,release_year,title,action\n";
    for (int i = 0; i < 5000; ++i) {
      f << (i % 943 + 1) << "," << (i % 1682 + 1) << "," << (i % 5 + 1) << ","
        << (i % 60 + 10) << "," << (i % 2 ? "M" : "F") << ",job" << (i % 7)
        << ",0" << (i % 9999) << "," << (1930 + i % 68) << ",\"Movie, \"\"q\"\" ("
        << i << ")\"," << (i % 2) << "\n";
    }
    // edge rows: missing fields, empty strings
    f << "1,2,5,,,,,,x,\n";
  }

  // hashing determinism across calls
  uint64_t h1 = rectpu_fingerprint64("technician", 10);
  uint64_t h2 = rectpu_fingerprint64("technician", 10);
  assert(h1 == h2);
  int64_t vals[3] = {1, -5, 1234567};
  int32_t hout[3];
  rectpu_hash_ints(vals, 3, 997, hout);
  for (int i = 0; i < 3; ++i) assert(hout[i] >= 0 && hout[i] < 997);

  // fixed-stride variant: NUL-padded rows, incl. a full-width one (no pad —
  // the length scan must stop at itemsize, the ASan-sensitive edge)
  char fixed[3 * 4] = {'a', 'b', '\0', '\0',
                       '\0', '\0', '\0', '\0',
                       'w', 'x', 'y', 'z'};
  int32_t fout[3];
  rectpu_hash_strings_fixed(fixed, 4, 3, 997, fout);
  assert(fout[0] == static_cast<int32_t>(rectpu_fingerprint64("ab", 2) % 997));
  assert(fout[1] == static_cast<int32_t>(rectpu_fingerprint64("", 0) % 997));
  assert(fout[2] == static_cast<int32_t>(rectpu_fingerprint64("wxyz", 4) % 997));

  const char* spec =
      "hash:user_id:1000:int\n"
      "hash:item_id:2000:int\n"
      "bucket:age:15.0,25.0,35.0,45.0,55.0,65.0\n"
      "vocab:gender:1:F,M\n"
      "hash:occupation:50:str\n"
      "hash:zipcode:1000:str\n"
      "bucket:release_year:1930.0,1940.0,1950.0,1960.0,1970.0,1980.0,1990.0\n"
      "identity:action:2\n"
      "numeric:age\n"
      "label:rating:5";

  for (int threads : {1, 8}) {
    void* h = rectpu_csv_open(path, threads);
    assert(rectpu_csv_error(h) == nullptr);
    int64_t rows = rectpu_csv_rows(h);
    assert(rows == 5001);
    const int n_cat = 8;
    std::vector<int32_t> ids(rows * n_cat);
    std::vector<float> nums(rows);
    std::vector<float> labels(rows);
    int rc = rectpu_csv_encode(h, spec, ids.data(), nums.data(), labels.data());
    assert(rc == 0);
    // invariants: ids in global ranges; labels binary; numeric passthrough
    int64_t offs[] = {0, 1000, 3000, 3007, 3010, 3060, 4060, 4068};
    int64_t sizes[] = {1000, 2000, 7, 3, 50, 1000, 8, 2};
    for (int64_t r = 0; r < rows; ++r) {
      for (int c = 0; c < n_cat; ++c) {
        int32_t v = ids[r * n_cat + c];
        assert(v >= offs[c] && v < offs[c] + sizes[c]);
      }
      assert(labels[r] == 0.0f || labels[r] == 1.0f);
    }
    assert(nums[0] == 10.0f);
    // edge row: empty gender -> OOV bucket 2 within the vocab field
    assert(ids[5000 * n_cat + 3] - offs[3] == 2);
    rectpu_csv_free(h);
  }
  std::remove(path);

  // ---- JSON request-column parser (json_columns.cc) ----
  {
    std::string body = "{\"instances\": [";
    for (int i = 0; i < 500; ++i) {
      if (i) body += ",";
      body += "{\"user_id\": " + std::to_string(i) +
              ", \"zipcode\": \"0" + std::to_string(i % 9999) +
              "\", \"score\": " + std::to_string(i) + ".25}";
    }
    body += "]}";
    void* j = rectpu_json_parse(body.data(), static_cast<int64_t>(body.size()));
    assert(rectpu_json_error(j) == nullptr);
    assert(rectpu_json_rows(j) == 500);
    assert(rectpu_json_cols(j) == 3);
    const char* name; int64_t nlen, kind, stride;
    assert(rectpu_json_col_info(j, 0, &name, &nlen, &kind, &stride) == 0);
    assert(nlen == 7 && memcmp(name, "user_id", 7) == 0 && kind == 0);
    std::vector<int64_t> uid(500);
    assert(rectpu_json_col_copy(j, 0, uid.data()) == 0);
    assert(uid[0] == 0 && uid[499] == 499);
    assert(rectpu_json_col_info(j, 1, &name, &nlen, &kind, &stride) == 0);
    assert(kind == 2 && stride == 4);  // longest zipcode is "0499"
    std::vector<char> zc(500 * stride, 0);
    assert(rectpu_json_col_copy(j, 1, zc.data()) == 0);
    assert(memcmp(zc.data(), "00\0\0", 4) == 0);
    assert(rectpu_json_col_info(j, 2, &name, &nlen, &kind, &stride) == 0);
    assert(kind == 1);
    rectpu_json_free(j);

    // malformed/unsupported bodies must error, never crash — including
    // every truncation of a valid body (ASan end-of-buffer coverage)
    const char* bad[] = {
        "", "{", "[]", "{\"x\": 1}", "not json",
        "{\"instances\": [{\"a\": [1]}]}",
        "{\"instances\": [{\"a\": true}]}",
        "{\"instances\": [{\"a\": \"caf\xc3\xa9\"}]}",
        "{\"instances\": [{\"a\": \"x\\n\"}]}",
        "{\"instances\": [{\"a\": 1}, {\"b\": 2}]}",
        "{\"instances\": [{\"a\": 1, \"a\": 2}]}",
        "{\"instances\": [{\"a\": 99999999999999999999}]}",
        "{\"instances\": []} ",
    };
    for (const char* b : bad) {
      void* jh = rectpu_json_parse(b, static_cast<int64_t>(strlen(b)));
      if (strcmp(b, "{\"instances\": []} ") != 0)  // trailing ws is valid-ish
        (void)rectpu_json_error(jh);               // just must not crash
      rectpu_json_free(jh);
    }
    for (size_t cut = 0; cut < body.size(); cut += 7) {
      void* jh = rectpu_json_parse(body.data(), static_cast<int64_t>(cut));
      (void)rectpu_json_error(jh);
      rectpu_json_free(jh);
    }
  }

  std::puts("loader_test ok");
  return 0;
}
