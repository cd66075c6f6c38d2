// FarmHash-style Fingerprint64: the port's copy of rectpu/io/native/farmhash.cc,
// byte-identical to the Python fingerprint of rectpu_torch/features/hashing.py
// (tests/test_torch_native.py holds the buckets against rectpu's). Provides the
// stable bucket hashing of the native CSV encoder and of hash_bucket, with the
// semantics of TF's categorical_column_with_hash_bucket (reference
// trainers/ml_100k.py:19-30).

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr uint64_t k0 = 0xc3a5c85c97cb3127ULL;
constexpr uint64_t k1 = 0xb492b66fbe98f273ULL;
constexpr uint64_t k2 = 0x9ae16a3b2f90404fULL;

inline uint64_t Fetch64(const char* p) {
  uint64_t r;
  std::memcpy(&r, p, sizeof(r));
  return r;  // little-endian hosts only (x86/arm)
}

inline uint32_t Fetch32(const char* p) {
  uint32_t r;
  std::memcpy(&r, p, sizeof(r));
  return r;
}

inline uint64_t Rotate(uint64_t v, int s) {
  return s == 0 ? v : (v >> s) | (v << (64 - s));
}

inline uint64_t ShiftMix(uint64_t v) { return v ^ (v >> 47); }

inline uint64_t HashLen16(uint64_t u, uint64_t v, uint64_t mul) {
  uint64_t a = (u ^ v) * mul;
  a ^= a >> 47;
  uint64_t b = (v ^ a) * mul;
  b ^= b >> 47;
  return b * mul;
}

uint64_t HashLen0to16(const char* s, size_t len) {
  if (len >= 8) {
    uint64_t mul = k2 + len * 2;
    uint64_t a = Fetch64(s) + k2;
    uint64_t b = Fetch64(s + len - 8);
    uint64_t c = Rotate(b, 37) * mul + a;
    uint64_t d = (Rotate(a, 25) + b) * mul;
    return HashLen16(c, d, mul);
  }
  if (len >= 4) {
    uint64_t mul = k2 + len * 2;
    uint64_t a = Fetch32(s);
    return HashLen16(len + (a << 3), Fetch32(s + len - 4), mul);
  }
  if (len > 0) {
    uint8_t a = s[0], b = s[len >> 1], c = s[len - 1];
    uint32_t y = static_cast<uint32_t>(a) + (static_cast<uint32_t>(b) << 8);
    uint32_t z = static_cast<uint32_t>(len) + (static_cast<uint32_t>(c) << 2);
    return ShiftMix(y * k2 ^ z * k0) * k2;
  }
  return k2;
}

uint64_t HashLen17to32(const char* s, size_t len) {
  uint64_t mul = k2 + len * 2;
  uint64_t a = Fetch64(s) * k1;
  uint64_t b = Fetch64(s + 8);
  uint64_t c = Fetch64(s + len - 8) * mul;
  uint64_t d = Fetch64(s + len - 16) * k2;
  return HashLen16(Rotate(a + b, 43) + Rotate(c, 30) + d,
                   a + Rotate(b + k2, 18) + c, mul);
}

uint64_t HashLen33to64(const char* s, size_t len) {
  uint64_t mul = k2 + len * 2;
  uint64_t a = Fetch64(s) * k2;
  uint64_t b = Fetch64(s + 8);
  uint64_t c = Fetch64(s + len - 8) * mul;
  uint64_t d = Fetch64(s + len - 16) * k2;
  uint64_t y = Rotate(a + b, 43) + Rotate(c, 30) + d;
  uint64_t z = HashLen16(y, a + Rotate(b + k2, 18) + c, mul);
  uint64_t e = Fetch64(s + 16) * mul;
  uint64_t f = Fetch64(s + 24);
  uint64_t g = (y + Fetch64(s + len - 32)) * mul;
  uint64_t h = (z + Fetch64(s + len - 24)) * mul;
  return HashLen16(Rotate(e + f, 43) + Rotate(g, 30) + h,
                   e + Rotate(f + a, 18) + g, mul);
}

struct U128 {
  uint64_t first, second;
};

inline U128 WeakHashLen32WithSeeds(uint64_t w, uint64_t x, uint64_t y, uint64_t z,
                                   uint64_t a, uint64_t b) {
  a += w;
  b = Rotate(b + a + z, 21);
  uint64_t c = a;
  a += x;
  a += y;
  b += Rotate(a, 44);
  return {a + z, b + c};
}

inline U128 WeakHashLen32WithSeeds(const char* s, uint64_t a, uint64_t b) {
  return WeakHashLen32WithSeeds(Fetch64(s), Fetch64(s + 8), Fetch64(s + 16),
                                Fetch64(s + 24), a, b);
}

uint64_t Hash64Long(const char* s, size_t len) {
  const uint64_t seed = 81;
  uint64_t x = seed;
  uint64_t y = seed * k1 + 113;
  uint64_t z = ShiftMix(y * k2 + 113) * k2;
  U128 v = {0, 0};
  U128 w = {0, 0};
  x = x * k2 + Fetch64(s);

  const char* end = s + ((len - 1) / 64) * 64;
  const char* last64 = end + ((len - 1) & 63) - 63;
  do {
    x = Rotate(x + y + v.first + Fetch64(s + 8), 37) * k1;
    y = Rotate(y + v.second + Fetch64(s + 48), 42) * k1;
    x ^= w.second;
    y += v.first + Fetch64(s + 40);
    z = Rotate(z + w.first, 33) * k1;
    v = WeakHashLen32WithSeeds(s, v.second * k1, x + w.first);
    w = WeakHashLen32WithSeeds(s + 32, z + w.second, y + Fetch64(s + 16));
    uint64_t t = z;
    z = x;
    x = t;
    s += 64;
  } while (s != end);
  uint64_t mul = k1 + ((z & 0xff) << 1);
  s = last64;
  w.first += ((len - 1) & 63);
  v.first += w.first;
  w.first += v.first;
  x = Rotate(x + y + v.first + Fetch64(s + 8), 37) * mul;
  y = Rotate(y + v.second + Fetch64(s + 48), 42) * mul;
  x ^= w.second * 9;
  y += v.first * 9 + Fetch64(s + 40);
  z = Rotate(z + w.first, 33) * mul;
  v = WeakHashLen32WithSeeds(s, v.second * mul, x + w.first);
  w = WeakHashLen32WithSeeds(s + 32, z + w.second, y + Fetch64(s + 16));
  uint64_t t = z;
  z = x;
  x = t;
  return HashLen16(HashLen16(v.first, w.first, mul) + ShiftMix(y) * k0 + z,
                   HashLen16(v.second, w.second, mul) + x, mul);
}

}  // namespace

extern "C" uint64_t rectpu_fingerprint64(const char* s, size_t len) {
  if (len <= 16) return HashLen0to16(s, len);
  if (len <= 32) return HashLen17to32(s, len);
  if (len <= 64) return HashLen33to64(s, len);
  return Hash64Long(s, len);
}

extern "C" void rectpu_hash_strings(const char** vals, size_t n, int64_t buckets,
                                    int32_t* out) {
  for (size_t i = 0; i < n; ++i) {
    out[i] = static_cast<int32_t>(
        rectpu_fingerprint64(vals[i], std::strlen(vals[i])) %
        static_cast<uint64_t>(buckets));
  }
}

// Fixed-stride variant for numpy S-dtype arrays: element i lives at
// buf + i*itemsize, NUL-padded to itemsize (strings with EMBEDDED NULs are
// not representable — callers fall back to rectpu_hash_strings for those).
extern "C" void rectpu_hash_strings_fixed(const char* buf, int64_t itemsize,
                                          size_t n, int64_t buckets,
                                          int32_t* out) {
  for (size_t i = 0; i < n; ++i) {
    const char* p = buf + i * itemsize;
    size_t len = 0;
    while (len < static_cast<size_t>(itemsize) && p[len] != '\0') ++len;
    out[i] = static_cast<int32_t>(rectpu_fingerprint64(p, len) %
                                  static_cast<uint64_t>(buckets));
  }
}

// decimal itoa without the snprintf format-machinery overhead (~4x faster
// per element; this sits on the serving request-encode hot path)
static inline int fast_i64toa(int64_t v, char* buf) {
  char tmp[20];
  int t = 0;
  uint64_t u = v < 0 ? static_cast<uint64_t>(-(v + 1)) + 1 : static_cast<uint64_t>(v);
  do {
    tmp[t++] = static_cast<char>('0' + u % 10);
    u /= 10;
  } while (u);
  int len = 0;
  if (v < 0) buf[len++] = '-';
  while (t) buf[len++] = tmp[--t];
  return len;
}

extern "C" void rectpu_hash_ints(const int64_t* vals, size_t n, int64_t buckets,
                                 int32_t* out) {
  char buf[24];
  for (size_t i = 0; i < n; ++i) {
    int len = fast_i64toa(vals[i], buf);
    out[i] = static_cast<int32_t>(rectpu_fingerprint64(buf, len) %
                                  static_cast<uint64_t>(buckets));
  }
}
