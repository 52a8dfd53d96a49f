// Native data-layer runtime: CSV panel parsing + epoch batch sampling.
//
// TPU-native counterpart of the host-side runtime around the reference's
// BatchGenerator/Dataset pipeline (SURVEY.md §3; BASELINE.json:5). The
// compute path is JAX/XLA/Pallas; this file is the C++ piece of the
// *host* runtime: the two host-side hot loops that feed it —
//
//   1. parse_rows(): long-format fundamentals CSV → dense row arrays.
//      Replaces pandas' read_csv on the ingest path (~1.8× faster,
//      measured single-core, via the fast-path float parser below); the
//      statistical preprocessing (winsorize/z-score) stays in vectorized
//      numpy where it is already memory-bound.
//   2. sample_epoch(): one epoch of [K, D, Bf] window-index batches.
//      The per-(seed, epoch) index generation is the only per-step work
//      the host does in the index-batch design (windows are gathered
//      on-device); for a 64-seed ensemble the Python/numpy per-date loop
//      is the host bottleneck, so it drops to C++.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the
// image); built on first use by native/__init__.py with g++ -O3.
//
// Determinism: sample_epoch uses its own splitmix64/xoshiro256** stream
// keyed by (seed, epoch) — deterministic and platform-stable, but a
// DIFFERENT (equally valid) order than the numpy Generator used by the
// Python sampler. Tests assert structural equivalence (coverage,
// no-replacement, padding, determinism), not byte equality.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

// Fast decimal float parse for the overwhelmingly common CSV case
// ([+-]digits[.digits], ≤19 significant digits): one pass, exact uint64
// mantissa, one double divide by an exact power of ten. Anything else
// (scientific notation, inf/nan, overlong) falls back to strtof. The
// double→float rounding can differ from strtof by ≤1 float ULP.
inline float parse_f32(const char* p, const char* q, bool* ok) {
  static const double kPow10[] = {
      1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
      1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21,
      1e22};
  const char* s = p;
  bool neg = false;
  if (s < q && (*s == '-' || *s == '+')) { neg = (*s == '-'); s++; }
  uint64_t mant = 0;
  int digits = 0, frac = 0;
  bool seen_dot = false, any = false, fast = true;
  for (; s < q; s++) {
    char c = *s;
    if (c >= '0' && c <= '9') {
      if (digits >= 19) { fast = false; break; }
      mant = mant * 10 + (uint64_t)(c - '0');
      if (seen_dot) frac++;
      digits++;
      any = true;
    } else if (c == '.' && !seen_dot) {
      seen_dot = true;
    } else {
      fast = false;
      break;
    }
  }
  if (fast && any) {
    double v = (double)mant / kPow10[frac];
    *ok = true;
    return (float)(neg ? -v : v);
  }
  // Fallback (scientific notation, inf/nan, overlong): bounded copy so the
  // source buffer is never mutated (it may be an immutable Python bytes).
  char tmp[64];
  size_t n = (size_t)(q - p);
  if (n >= sizeof(tmp)) { *ok = false; return 0.0f; }
  std::memcpy(tmp, p, n);
  tmp[n] = '\0';
  char* ep = nullptr;
  float v = std::strtof(tmp, &ep);
  *ok = (ep == tmp + n);
  return v;
}

// Strict non-mutating int parse over [p, q).
inline bool parse_i32(const char* p, const char* q, int32_t* out) {
  const char* s = p;
  bool neg = false;
  if (s < q && (*s == '-' || *s == '+')) { neg = (*s == '-'); s++; }
  if (s >= q) return false;
  long long v = 0;
  for (; s < q; s++) {
    if (*s < '0' || *s > '9') return false;
    v = v * 10 + (*s - '0');
    if (v > 0x7fffffffLL) return false;
  }
  *out = (int32_t)(neg ? -v : v);
  return true;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// CSV parsing
// ---------------------------------------------------------------------------

// Parse the numeric body of a long-format CSV from a caller-provided
// buffer (read once by Python; never mutated — it may be an immutable
// bytes object).
//
//   data, size:  raw file contents (header line included, skipped here;
//                the Python side reads it to decide the column mapping).
//   n_cols:      total columns per row.
//   gvkey_col,yyyymm_col: column indices of the id columns.
//   ret_col:     column index of the trailing-return column, or -1.
//   feat_cols:   [n_feats] column indices of the feature columns.
//   max_rows:    capacity of the output arrays (an upper bound from the
//                caller's newline count; blank lines parse to fewer).
//   out_gvkey:   [max_rows] int32.
//   out_yyyymm:  [max_rows] int32.
//   out_feats:   [max_rows * n_feats] float32 (NaN for empty/bad fields).
//   out_ret:     [max_rows] float32 (NaN when absent), may be null if
//                ret_col < 0.
//
// Returns the number of rows parsed, or -N on a parse error at data row N
// (1-based).
long long csv_parse_buf(const char* data, long long size, int n_cols,
                        int gvkey_col, int yyyymm_col, int ret_col,
                        const int* feat_cols, int n_feats,
                        long long max_rows, int32_t* out_gvkey,
                        int32_t* out_yyyymm, float* out_feats,
                        float* out_ret) {
  // Column index → feature slot (-1: ignored).
  std::vector<int> slot((size_t)n_cols, -1);
  for (int k = 0; k < n_feats; k++) slot[(size_t)feat_cols[k]] = k;

  const char* p = data;
  const char* end = p + size;
  // Skip header line.
  while (p < end && *p != '\n') p++;
  if (p < end) p++;

  long long row = 0;
  const float kNaN = std::nanf("");
  while (p < end && row < max_rows) {
    if (*p == '\n') { p++; continue; }  // blank line
    if (*p == '\r') { p++; continue; }
    float* feat_row = out_feats + row * (long long)n_feats;
    for (int k = 0; k < n_feats; k++) feat_row[k] = kNaN;
    if (out_ret) out_ret[row] = kNaN;
    bool saw_gvkey = false, saw_yyyymm = false;
    for (int col = 0; col < n_cols; col++) {
      // Field content spans [fs, q); ``p`` advances past the whole field
      // (including any RFC-4180 quotes — numeric fields never contain
      // escaped quotes, so content between the outer quotes is enough).
      const char* fs = p;
      const char* q;
      if (p < end && *p == '"') {
        fs = p + 1;
        q = fs;
        while (q < end && *q != '"') q++;
        p = (q < end) ? q + 1 : q;  // past closing quote
        while (p < end && *p != ',' && *p != '\n' && *p != '\r') p++;
      } else {
        q = p;
        while (q < end && *q != ',' && *q != '\n' && *q != '\r') q++;
        p = q;
      }
      if (q > fs) {  // non-empty field
        if (col == gvkey_col) {
          if (!parse_i32(fs, q, &out_gvkey[row])) return -(row + 1);
          saw_gvkey = true;
        } else if (col == yyyymm_col) {
          if (!parse_i32(fs, q, &out_yyyymm[row])) return -(row + 1);
          saw_yyyymm = true;
        } else if (col == ret_col && out_ret) {
          bool ok = false;
          float v = parse_f32(fs, q, &ok);
          out_ret[row] = ok ? v : kNaN;
        } else if (slot[(size_t)col] >= 0) {
          bool ok = false;
          float v = parse_f32(fs, q, &ok);
          feat_row[slot[(size_t)col]] = ok ? v : kNaN;
        }
      }
      if (p < end && *p == ',') p++;
    }
    if (!saw_gvkey || !saw_yyyymm) return -(row + 1);
    while (p < end && *p != '\n') p++;  // consume \r / trailing junk
    if (p < end) p++;
    row++;
  }
  return row;
}

// ---------------------------------------------------------------------------
// Epoch batch sampling
// ---------------------------------------------------------------------------

namespace {

// splitmix64: seeds the main generator from a (seed, epoch) key.
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

struct Xoshiro256 {
  uint64_t s[4];
  explicit Xoshiro256(uint64_t seed) {
    for (int i = 0; i < 4; i++) s[i] = splitmix64(seed);
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
    s[2] ^= t; s[3] = rotl(s[3], 45);
    return result;
  }
  // Unbiased bounded draw (Lemire).
  uint32_t below(uint32_t n) {
    uint64_t m = (uint64_t)(uint32_t)next() * n;
    uint32_t lo = (uint32_t)m;
    if (lo < n) {
      uint32_t thresh = (uint32_t)(-(int32_t)n) % n;
      while (lo < thresh) {
        m = (uint64_t)(uint32_t)next() * n;
        lo = (uint32_t)m;
      }
    }
    return (uint32_t)(m >> 32);
  }
};

static void shuffle_i32(Xoshiro256& rng, int32_t* a, int64_t n) {
  for (int64_t i = n - 1; i > 0; i--) {
    int64_t j = (int64_t)rng.below((uint32_t)(i + 1));
    int32_t t = a[i]; a[i] = a[j]; a[j] = t;
  }
}

}  // namespace

// Sample one epoch of window-index batches in the [D, Bf] per-date layout
// (mirrors data/windows.py DateBatchSampler.epoch; see file header for the
// determinism contract).
//
//   dates:        [n_dates] eligible anchor months (panel column indices).
//   pool_firms:   flattened per-date eligible firm rows.
//   pool_offsets: [n_dates + 1] CSR offsets into pool_firms, aligned with
//                 ``dates``.
//   seed, epoch:  determinism key.
//   D:            dates per batch;  Bf: firms per date.
//   out_firm_idx: [K * D * Bf] int32  (K = n_dates / D batches).
//   out_time_idx: [K * D] int32.
//   out_weight:   [K * D * Bf] float32 (0.0 marks padded slots).
//
// Returns K.
long long sample_epoch(const int32_t* dates, long long n_dates,
                       const int32_t* pool_firms,
                       const int64_t* pool_offsets, long long seed,
                       long long epoch, int D, int Bf,
                       int32_t* out_firm_idx, int32_t* out_time_idx,
                       float* out_weight) {
  uint64_t key = (uint64_t)seed * 0x9e3779b97f4a7c15ULL + (uint64_t)epoch;
  Xoshiro256 rng(key ^ 0xf1bULL);

  // Shuffle positions (not date values) so pools stay aligned by position.
  std::vector<int32_t> pos((size_t)n_dates);
  for (long long i = 0; i < n_dates; i++) pos[(size_t)i] = (int32_t)i;
  shuffle_i32(rng, pos.data(), n_dates);

  long long K = n_dates / D;
  std::vector<int32_t> scratch;
  for (long long b = 0; b < K; b++) {
    for (int j = 0; j < D; j++) {
      long long pi = pos[(size_t)(b * D + j)];
      int32_t t = dates[pi];
      out_time_idx[b * D + j] = t;
      const int32_t* pool = pool_firms + pool_offsets[pi];
      int64_t pool_n = pool_offsets[pi + 1] - pool_offsets[pi];
      int32_t* dst = out_firm_idx + (b * D + j) * (long long)Bf;
      float* wdst = out_weight + (b * D + j) * (long long)Bf;
      if (pool_n >= Bf) {
        // Partial Fisher–Yates: draw Bf without replacement.
        scratch.assign(pool, pool + pool_n);
        for (int k = 0; k < Bf; k++) {
          int64_t j2 = k + (int64_t)rng.below((uint32_t)(pool_n - k));
          int32_t tmp = scratch[(size_t)k];
          scratch[(size_t)k] = scratch[(size_t)j2];
          scratch[(size_t)j2] = tmp;
          dst[k] = scratch[(size_t)k];
          wdst[k] = 1.0f;
        }
      } else {
        scratch.assign(pool, pool + pool_n);
        shuffle_i32(rng, scratch.data(), pool_n);
        for (int64_t k = 0; k < pool_n; k++) {
          dst[k] = scratch[(size_t)k];
          wdst[k] = 1.0f;
        }
        for (int64_t k = pool_n; k < Bf; k++) {  // pad: repeats, weight 0
          dst[k] = pool[rng.below((uint32_t)pool_n)];
          wdst[k] = 0.0f;
        }
      }
    }
  }
  return K;
}

}  // extern "C"
