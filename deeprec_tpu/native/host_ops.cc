// Native host ops for the deeprec_tpu input pipeline.
//
// Rebuild of the reference's host-side C++ hot paths:
//   * fused CSV feature parsing   (core/kernels/trans_csv_ali_ops.cc:282-959
//                                  TransCsvID2Sparse/KV2Dense/ToDense)
//   * id dedup                    (core/kernels/unique_ali_op.cc:47 UniqueAliOp)
//   * string/categorical hashing  (the categorical_column hash step that
//                                  feeds EmbeddingVariables)
//
// These run on the host's CPU between steps, overlapped with device
// compute by the prefetch stage; they must be allocation-light and
// branch-predictable.  Plain C ABI, loaded via ctypes (no pybind11 in
// this image).  All buffers are caller-allocated numpy arrays.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Hashing: splitmix64 finalizer — the same family the device-side
// bucket hash uses (utils/keys.py), full-width 64-bit on host.
// ---------------------------------------------------------------------------

static inline uint64_t mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

void drt_hash64(const int64_t* in, int64_t n, uint64_t salt, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = (int64_t)mix64((uint64_t)in[i] ^ salt);
  }
}

// FNV-1a over bytes, then mix64. offsets has n+1 entries into buf.
void drt_hash_bytes(const char* buf, const int64_t* offsets, int64_t n,
                    uint64_t salt, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t h = 0xCBF29CE484222325ull ^ salt;
    for (int64_t p = offsets[i]; p < offsets[i + 1]; ++p) {
      h = (h ^ (uint8_t)buf[p]) * 0x100000001B3ull;
    }
    out[i] = (int64_t)mix64(h);
  }
}

// ---------------------------------------------------------------------------
// Unique (UniqueAliOp analog): open-addressing map sized 2*next_pow2(n).
// Returns n_unique. uniq[n], inverse[n] (int32), counts[n] (int32) are
// caller-allocated at full length n; entries past n_unique are untouched.
// ---------------------------------------------------------------------------

int64_t drt_unique_i64(const int64_t* ids, int64_t n, int64_t* uniq,
                       int32_t* inverse, int32_t* counts) {
  if (n == 0) return 0;
  uint64_t cap = 1;
  while (cap < (uint64_t)(n * 2)) cap <<= 1;
  const uint64_t mask = cap - 1;
  // slot -> (key, unique index); kEmpty marks free.
  std::vector<int64_t> keys(cap);
  std::vector<int32_t> vals(cap, -1);
  int64_t n_unique = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = ids[i];
    uint64_t p = mix64((uint64_t)k) & mask;
    for (;;) {
      if (vals[p] < 0) {
        keys[p] = k;
        vals[p] = (int32_t)n_unique;
        uniq[n_unique] = k;
        counts[n_unique] = 1;
        inverse[i] = (int32_t)n_unique;
        ++n_unique;
        break;
      }
      if (keys[p] == k) {
        inverse[i] = vals[p];
        ++counts[vals[p]];
        break;
      }
      p = (p + 1) & mask;
    }
  }
  return n_unique;
}

// ---------------------------------------------------------------------------
// Criteo-Kaggle TSV fast path: label \t I1..I13 \t C1..C26 (hex).
// Missing numeric -> 0; ints optionally log-compressed
// (sign(x)*log1p(|x|), the modelzoo transform).  Categorical tokens are
// parsed as hex (string-hash fallback for non-hex tokens) and offset
// per-field (field << 40) so fields don't collide in shared tables;
// empty token -> id 0 of the field.
// Returns rows parsed (<= max_rows). consumed gets the byte count of
// whole lines consumed, so callers can carry partial tails.
// ---------------------------------------------------------------------------

static inline double parse_float(const char* s, const char* e) {
  // Fast float: sign, integral, fraction. Criteo ints have no exponent.
  if (s >= e) return 0.0;
  bool neg = false;
  if (*s == '-') { neg = true; ++s; }
  double v = 0.0;
  while (s < e && *s >= '0' && *s <= '9') v = v * 10.0 + (*s++ - '0');
  if (s < e && *s == '.') {
    ++s;
    double f = 0.1;
    while (s < e && *s >= '0' && *s <= '9') { v += (*s++ - '0') * f; f *= 0.1; }
  }
  return neg ? -v : v;
}

static inline int64_t parse_cat_token(const char* s, const char* e) {
  // Hex fast path (real Criteo tokens are 8 hex chars).  Tokens with
  // any non-hex char fall back to FNV-1a + mix64 (the hash_bytes
  // scheme), so arbitrary strings still get distinct ids — the
  // categorical_column_with_hash_bucket behavior.  Both results are
  // masked to 40 bits so the per-field (field << 40) offset below
  // stays collision-free.
  const uint64_t kMask40 = (1ull << 40) - 1;
  uint64_t v = 0;
  const char* p = s;
  for (; p < e; ++p) {
    const char c = *p;
    uint64_t d;
    if (c >= '0' && c <= '9') d = (uint64_t)(c - '0');
    else if (c >= 'a' && c <= 'f') d = (uint64_t)(c - 'a' + 10);
    else if (c >= 'A' && c <= 'F') d = (uint64_t)(c - 'A' + 10);
    else break;
    v = (v << 4) | d;
  }
  if (p == e) return (int64_t)(v & kMask40);
  uint64_t h = 0xCBF29CE484222325ull;
  for (p = s; p < e; ++p) h = (h ^ (uint8_t)*p) * 0x100000001B3ull;
  return (int64_t)(mix64(h) & kMask40);
}

int64_t drt_parse_criteo(const char* buf, int64_t len, int64_t max_rows,
                         int log_transform, float* labels, float* dense13,
                         int64_t* cats26, int64_t* consumed) {
  const int kInt = 13, kCat = 26;
  int64_t row = 0;
  const char* p = buf;
  const char* end = buf + len;
  const char* line_start = p;
  while (row < max_rows && p < end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    const char* le = nl ? nl : end;
    if (!nl && consumed) break;  // partial tail: let caller re-feed it
    // field 0: label
    const char* f = line_start;
    const char* t = (const char*)memchr(f, '\t', (size_t)(le - f));
    const char* fe = t ? t : le;
    labels[row] = (float)parse_float(f, fe);
    f = t ? t + 1 : le;
    for (int i = 0; i < kInt; ++i) {
      t = f < le ? (const char*)memchr(f, '\t', (size_t)(le - f)) : nullptr;
      fe = t ? t : le;
      double v = parse_float(f, fe);
      if (log_transform) {
        double a = v < 0 ? -v : v;
        double lg = a > 0 ? __builtin_log1p(a) : 0.0;
        v = v < 0 ? -lg : lg;
      }
      dense13[row * kInt + i] = (float)v;
      f = t ? t + 1 : le;
    }
    for (int i = 0; i < kCat; ++i) {
      t = f < le ? (const char*)memchr(f, '\t', (size_t)(le - f)) : nullptr;
      fe = t ? t : le;
      int64_t h = (f < fe) ? parse_cat_token(f, fe) : 0;
      cats26[row * kCat + i] = h + ((int64_t)i << 40);
      f = t ? t + 1 : le;
    }
    ++row;
    p = nl ? nl + 1 : end;
    line_start = p;
  }
  if (consumed) *consumed = (int64_t)(line_start - buf);
  return row;
}

// ---------------------------------------------------------------------------
// TransCsvID2Dense analog: rows of fields (field_delim-separated), each
// field an id list (list_delim-separated decimal ids).  Output is the
// padded-dense [max_rows, ncols, max_len] int64 matrix the framework's
// SparseIds batches use; pad fills unused tail. row_lens[r*ncols+c]
// gets the real length (clipped at max_len; overflow ids drop).
// ---------------------------------------------------------------------------

static inline int64_t parse_dec(const char* s, const char* e) {
  bool neg = false;
  if (s < e && *s == '-') { neg = true; ++s; }
  int64_t v = 0;
  while (s < e && *s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
  return neg ? -v : v;
}

int64_t drt_parse_idlist(const char* buf, int64_t len, char field_delim,
                         char list_delim, int64_t max_rows, int64_t ncols,
                         int64_t max_len, int64_t pad, int64_t* out,
                         int32_t* row_lens) {
  int64_t row = 0;
  const char* p = buf;
  const char* end = buf + len;
  for (int64_t i = 0; i < max_rows * ncols * max_len; ++i) out[i] = pad;
  while (row < max_rows && p < end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    const char* le = nl ? nl : end;
    const char* f = p;
    for (int64_t c = 0; c < ncols; ++c) {
      const char* t = f < le
          ? (const char*)memchr(f, field_delim, (size_t)(le - f)) : nullptr;
      const char* fe = t ? t : le;
      int64_t k = 0;
      const char* s = f;
      while (s < fe) {
        const char* d = (const char*)memchr(s, list_delim, (size_t)(fe - s));
        const char* se = d ? d : fe;
        if (se > s && k < max_len) {
          out[(row * ncols + c) * max_len + k] = parse_dec(s, se);
          ++k;
        }
        s = d ? d + 1 : fe;
      }
      row_lens[row * ncols + c] = (int32_t)k;
      f = t ? t + 1 : le;
    }
    ++row;
    p = nl ? nl + 1 : end;
  }
  return row;
}

// ---------------------------------------------------------------------------
// TransCsvKV2Dense analog: each field is "k:v|k:v|..." — scatter v into
// column k of a [max_rows, ncols] dense float matrix (later k wins,
// matching the reference's overwrite semantics).
// ---------------------------------------------------------------------------

int64_t drt_parse_kvlist(const char* buf, int64_t len, char field_delim,
                         char list_delim, char kv_delim, int64_t max_rows,
                         int64_t ncols, float* out) {
  int64_t row = 0;
  const char* p = buf;
  const char* end = buf + len;
  memset(out, 0, sizeof(float) * (size_t)(max_rows * ncols));
  while (row < max_rows && p < end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    const char* le = nl ? nl : end;
    const char* s = p;
    while (s < le) {
      const char* d = (const char*)memchr(s, list_delim, (size_t)(le - s));
      const char* d2 = (const char*)memchr(s, field_delim, (size_t)(le - s));
      const char* se = d ? d : le;
      if (d2 && d2 < se) se = d2;  // field delim also terminates a pair
      const char* colon = (const char*)memchr(s, kv_delim, (size_t)(se - s));
      if (colon) {
        int64_t k = parse_dec(s, colon);
        double v = parse_float(colon + 1, se);
        if (k >= 0 && k < ncols) out[row * ncols + k] = (float)v;
      }
      s = se + 1;
    }
    ++row;
    p = nl ? nl + 1 : end;
  }
  return row;
}

// ---------------------------------------------------------------------------
// Fused batch assembly for EV lookups: hash + per-field offset + unique
// in one pass over a [rows, ncols] id matrix — what the Python pipeline
// does with three numpy passes. Emits the deduped id list + int32
// inverse/counts ready for device upload.
// ---------------------------------------------------------------------------

int64_t drt_hash_offset_unique(const int64_t* ids, int64_t rows,
                               int64_t ncols, uint64_t salt, int hash,
                               int64_t* uniq, int32_t* inverse,
                               int32_t* counts) {
  const int64_t n = rows * ncols;
  std::vector<int64_t> tmp((size_t)n);
  for (int64_t r = 0; r < rows; ++r) {
    for (int64_t c = 0; c < ncols; ++c) {
      int64_t v = ids[r * ncols + c];
      if (hash) v = (int64_t)mix64((uint64_t)v ^ salt);
      tmp[(size_t)(r * ncols + c)] = v + (c << 40);
    }
  }
  return drt_unique_i64(tmp.data(), n, uniq, inverse, counts);
}

}  // extern "C"
