// Native text IO for tpulbm_torch, with a C ABI for ctypes
// (tpulbm_torch/io/native.py): the reference's output files (write_values,
// d2q9-bgk.c:1034-1143) and its obstacle-list parser (d2q9-bgk.c:912-957).
//
// Every value the writers print is a float32 widened to double, printed as
// "%.12E". stdio formats a double in multi-precision arithmetic, several
// hundred ns a value; put_e12 gives the same bytes in 128-bit integer
// arithmetic. A float32 is m * 2^e with m < 2^24, so its 13 significant
// digits are floor(m * 5^k * 2^(e+k)) for k = 12 - E (E the decimal
// exponent), and the bits shifted out are the exact remainder, rounded half
// to even as glibc rounds in the default rounding mode. What would leave
// 128 bits (subnormals, |v| < 1e-32, |v| >= 1e13), NaN and Inf take a slow
// path (std::to_chars, and snprintf for NaN and Inf); the writers return
// how many values took it. +-0 is exact on the fast path.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>

namespace {

using u128 = unsigned __int128;

constexpr uint64_t kTen12 = 1000000000000ull;
constexpr uint64_t kTen13 = 10 * kTen12;
constexpr int kMaxK = 44;  // m * 5^44 < 2^24 * 2^102.2 fits 128 bits

struct Tables {
  u128 pow5[kMaxK + 1] = {};
  char pairs[200] = {};  // "00" "01" ... "99"
  constexpr Tables() {
    pow5[0] = 1;
    for (int k = 1; k <= kMaxK; ++k) pow5[k] = pow5[k - 1] * 5;
    for (int i = 0; i < 100; ++i) {
      pairs[2 * i] = char('0' + i / 10);
      pairs[2 * i + 1] = char('0' + i % 10);
    }
  }
};
constexpr Tables kT;

// The 13 significant digits of m * 2^e (normal float32: 2^23 <= m < 2^24),
// rounded half to even, as n in [10^12, 10^13), and its decimal exponent
// E. False outside 1e-32 <= v < 1e13 (E in [-32, 12], k = 12 - E in
// [0, kMaxK]), where m * 5^k would leave 128 bits or k < 0.
bool digits13(uint32_t m, int e, uint64_t& n, int& exp10) {
  // floor((e + 23) * log10 2), exact over every float32 exponent: E or
  // E - 1. Raised to -32, it stays at most E wherever E >= -32.
  int ex = ((e + 23) * 78913) >> 18;
  if (ex < 12 - kMaxK) ex = 12 - kMaxK;
  for (int tries = 0; tries < 2; ++tries) {
    const int k = 12 - ex;
    if (k < 0) return false;
    const u128 x = u128(m) * kT.pow5[k];
    const int s = -(e + k);  // at most 149 - 44: a shift inside 128 bits
    u128 q, rem = 0, half = 0;
    if (s <= 0) {
      q = x << -s;  // v * 10^k < 10^14: exact, nothing shifted out
    } else {
      q = x >> s;
      rem = x & ((u128(1) << s) - 1);
      half = u128(1) << (s - 1);
    }
    if (q >= kTen13) {  // the estimate was E - 1
      ++ex;
      continue;
    }
    if (q < kTen12) return false;  // E < -32
    n = uint64_t(q);
    if (rem > half || (rem == half && s > 0 && (n & 1))) ++n;
    if (n == kTen13) {  // rounded up into the next decade
      n = kTen12;
      ++ex;
    }
    exp10 = ex;
    return true;
  }
  return false;
}

char* put6(char* p, uint32_t v) {  // v < 10^6, six digits
  const uint32_t a = v / 10000, b = v % 10000;
  std::memcpy(p, kT.pairs + 2 * a, 2);
  std::memcpy(p + 2, kT.pairs + 2 * (b / 100), 2);
  std::memcpy(p + 4, kT.pairs + 2 * (b % 100), 2);
  return p + 6;
}

// printf's own text of (double)f: Inf and NaN ("INF", "-NAN") as glibc
// spells them.
char* put_e12_slow(char* p, float f) {
  const double v = f;
  if (!std::isfinite(v)) return p + std::snprintf(p, 32, "%.12E", v);
  char* end =
      std::to_chars(p, p + 32, v, std::chars_format::scientific, 12).ptr;
  for (char* c = p; c != end; ++c)
    if (*c == 'e') *c = 'E';
  return end;
}

// Writes printf("%.12E", (double)f) at p (at most 32 bytes) and returns its
// end; counts a value that took the slow path in slow.
char* put_e12(char* p, float f, long long& slow) {
  uint32_t bits;
  std::memcpy(&bits, &f, sizeof bits);
  const uint32_t biased = (bits >> 23) & 0xff, frac = bits & 0x7fffff;
  if (biased == 0 && frac == 0) {  // +-0, exact
    if (bits >> 31) *p++ = '-';
    std::memcpy(p, "0.000000000000E+00", 18);
    return p + 18;
  }
  uint64_t n;
  int ex;
  if (biased == 0 || biased == 0xff ||
      !digits13(frac | (1u << 23), int(biased) - 150, n, ex)) {
    ++slow;
    return put_e12_slow(p, f);
  }
  if (bits >> 31) *p++ = '-';
  const uint64_t rest = n % kTen12;
  *p++ = char('0' + n / kTen12);
  *p++ = '.';
  p = put6(p, uint32_t(rest / 1000000));
  p = put6(p, uint32_t(rest % 1000000));
  *p++ = 'E';
  *p++ = ex < 0 ? '-' : '+';
  std::memcpy(p, kT.pairs + 2 * (ex < 0 ? -ex : ex), 2);  // |ex| <= 32 here
  return p + 2;
}

char* put_int(char* p, int v) { return std::to_chars(p, p + 11, v).ptr; }

// A file opened "w" that takes its text a line at a time into one buffer
// and hands the buffer to stdio whole, with one fwrite for files that fit.
class TextFile {
 public:
  static constexpr size_t kLine = 256;  // > any one line of either file
  explicit TextFile(const char* path) : fp_(std::fopen(path, "w")) {}
  ~TextFile() {
    if (fp_) std::fclose(fp_);
  }
  bool is_open() const { return fp_ != nullptr; }
  // Where the next line of at most kLine bytes goes; done(end) takes it.
  char* line() {
    if (kBuf - len_ < kLine) flush();
    return buf_.get() + len_;
  }
  void done(const char* end) { len_ = size_t(end - buf_.get()); }
  // Writes the rest and closes; false if any write or the close failed.
  bool close() {
    flush();
    const bool ok = std::fclose(fp_) == 0 && ok_;
    fp_ = nullptr;
    return ok;
  }

 private:
  static constexpr size_t kBuf = size_t(1) << 22;
  void flush() {
    if (len_ && std::fwrite(buf_.get(), 1, len_, fp_) != len_) ok_ = false;
    len_ = 0;
  }
  FILE* fp_;
  std::unique_ptr<char[]> buf_{new char[kBuf]};
  size_t len_ = 0;
  bool ok_ = true;
};

}  // namespace

extern "C" {

// Writes final_state.dat: "%d %d %.12E %.12E %.12E %.12E %d\n" per cell,
// y-major ascending (matches d2q9-bgk.c:1115 and the rank-ordered append of
// :1049-1122, which is global-row ordered by construction). Returns -1 on
// failure, else the number of values formatted on the slow path.
long long tpulbm_write_final_state(const char* path, int nx, int ny,
                                   const float* u_x, const float* u_y,
                                   const float* u, const float* pressure,
                                   const int* obstacles) {
  TextFile out(path);
  if (!out.is_open()) return -1;
  const float* const cols[] = {u_x, u_y, u, pressure};
  long long slow = 0;
  for (int yy = 0; yy < ny; ++yy) {
    const long row = (long)yy * nx;
    for (int xx = 0; xx < nx; ++xx) {
      const long i = row + xx;
      char* p = put_int(out.line(), xx);
      *p++ = ' ';
      p = put_int(p, yy);
      for (const float* a : cols) {
        *p++ = ' ';
        p = put_e12(p, a[i], slow);
      }
      *p++ = ' ';
      p = put_int(p, obstacles[i]);
      *p++ = '\n';
      out.done(p);
    }
  }
  return out.close() ? slow : -1;
}

// Writes av_vels.dat: "%d:\t%.12E\n" per step (d2q9-bgk.c:1136). Returns as
// tpulbm_write_final_state.
long long tpulbm_write_av_vels(const char* path, int n, const float* av_vels) {
  TextFile out(path);
  if (!out.is_open()) return -1;
  long long slow = 0;
  for (int i = 0; i < n; ++i) {
    char* p = put_int(out.line(), i);
    *p++ = ':';
    *p++ = '\t';
    p = put_e12(p, av_vels[i], slow);
    *p++ = '\n';
    out.done(p);
  }
  return out.close() ? slow : -1;
}

// Parses the sparse "x y 1" obstacle list into a dense int32 grid; returns
// the number of free cells, or -1 on error. Duplicate entries count once
// (d2q9-bgk.c:945-947).
long long tpulbm_read_obstacles(const char* path, int nx, int ny,
                                int* mask_out) {
  FILE* fp = fopen(path, "r");
  if (!fp) return -1;
  memset(mask_out, 0, sizeof(int) * (size_t)nx * (size_t)ny);
  long long num_free = (long long)nx * ny;
  int xx, yy, blocked;
  int rc;
  while ((rc = fscanf(fp, "%d %d %d", &xx, &yy, &blocked)) != EOF) {
    if (rc != 3 || blocked != 1 || xx < 0 || xx >= nx || yy < 0 || yy >= ny) {
      fclose(fp);
      return -1;
    }
    long idx = (long)yy * nx + xx;
    if (!mask_out[idx]) --num_free;
    mask_out[idx] = 1;
  }
  fclose(fp);
  return num_free;
}

}  // extern "C"
