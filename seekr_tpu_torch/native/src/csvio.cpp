// Fast CSV emission for float32 matrices (seekr artifact writer).
//
// The labeled counts CSV is the dominant cost of a GENCODE-scale CLI run:
// pandas needs ~43 s for the 13k x 4096 (527 MB) artifact while the
// entire count+normalize+Pearson compute takes 35 ms on the TPU.  This
// writer formats rows in parallel and streams them in order.
//
// mode 0 reproduces pandas' float32 to_csv bytes exactly: numpy's
// shortest round-trip digits (std::to_chars scientific yields the same
// digit string) presented positionally for 1e-4 <= |v| < 1e16 and
// scientifically outside, integral values suffixed with ".0", NaN as an
// empty cell, +/-inf as "inf"/"-inf" (validated byte-for-byte against
// pandas in tests/test_native.py).
// mode 1 reproduces np.savetxt(fmt="%1.6f").

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace {

// pandas/numpy-compatible shortest repr of a float32 (numpy repr) or
// float64 (Python repr — what DataFrame.to_csv writes); appends to s.
// Same digit/threshold rules for both widths (verified differentially
// in tests/test_fast_csv.py): shortest round-trip digits, scientific
// iff |v| < 1e-4 or >= 1e16, NaN as an empty cell.
template <typename T>
void fmt_pandas(T v, std::string& s) {
  if (std::isnan(v)) return;  // pandas writes an empty cell for NaN
  if (std::isinf(v)) {
    s += (v < 0) ? "-inf" : "inf";
    return;
  }
  if (v == T(0)) {
    s += std::signbit(v) ? "-0.0" : "0.0";
    return;
  }
  // shortest round-trip digits via scientific form: "-d.ddddde±XX"
  char buf[48];
  auto r = std::to_chars(buf, buf + sizeof(buf), v,
                         std::chars_format::scientific);
  *r.ptr = '\0';
  const char* p = buf;
  bool neg = (*p == '-');
  if (neg) ++p;
  char digits[32];
  int nd = 0;
  digits[nd++] = *p++;           // leading digit
  if (*p == '.') {
    ++p;
    while (*p != 'e') digits[nd++] = *p++;
  }
  ++p;                            // skip 'e'
  int exp10 = std::atoi(p);       // signed exponent

  double av = std::fabs((double)v);
  bool scientific = (av < 1e-4) || (av >= 1e16);
  if (neg) s += '-';
  if (scientific) {
    s += digits[0];
    if (nd > 1) {
      s += '.';
      s.append(digits + 1, nd - 1);
    }
    s += 'e';
    s += (exp10 < 0) ? '-' : '+';
    int ae = exp10 < 0 ? -exp10 : exp10;
    if (ae < 10) s += '0';
    s += std::to_string(ae);
  } else if (exp10 >= nd - 1) {
    // integral: all digits, zero-pad to the decimal point, append .0
    s.append(digits, nd);
    s.append(size_t(exp10 - (nd - 1)), '0');
    s += ".0";
  } else if (exp10 >= 0) {
    s.append(digits, exp10 + 1);
    s += '.';
    s.append(digits + exp10 + 1, nd - exp10 - 1);
  } else {
    s += "0.";
    s.append(size_t(-exp10 - 1), '0');
    s.append(digits, nd);
  }
}

void fmt_fixed6(float v, std::string& s) {
  char buf[48];
  int n = std::snprintf(buf, sizeof(buf), "%1.6f", (double)v);
  s.append(buf, size_t(n));
}

template <typename T>
void format_rows(const T* data, int64_t cols, int64_t row0, int64_t row1,
                 const char* const* row_label_cells, int32_t mode,
                 std::string& out) {
  out.clear();
  out.reserve(size_t(row1 - row0) * size_t(cols) * 12);
  for (int64_t r = row0; r < row1; ++r) {
    const T* row = data + r * cols;
    if (row_label_cells) {
      out += row_label_cells[r];
      for (int64_t c = 0; c < cols; ++c) {
        out += ',';
        if (mode == 0) fmt_pandas(row[c], out);
        else fmt_fixed6(float(row[c]), out);
      }
    } else {
      for (int64_t c = 0; c < cols; ++c) {
        if (c) out += ',';
        if (mode == 0) fmt_pandas(row[c], out);
        else fmt_fixed6(float(row[c]), out);
      }
    }
    out += '\n';
  }
}

}  // namespace

template <typename T>
int64_t write_csv_impl(const char* path, const T* data,
                       int64_t rows, int64_t cols,
                       const char* header_line,
                       const char* const* row_label_cells,
                       int32_t mode, int32_t append) {
  if (!path || (!data && rows * cols > 0) || rows < 0 || cols < 0) return -1;
  if (mode != 0 && mode != 1) return -1;
  std::FILE* f = std::fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  bool ok = true;
  if (header_line && *header_line)
    ok = std::fwrite(header_line, 1, std::strlen(header_line), f) ==
         std::strlen(header_line);

  try {
  const int64_t chunk = 256;  // rows per formatting task (~10 MB of text)
  int64_t n_threads = std::min<int64_t>(
      std::max<int64_t>(1, std::thread::hardware_concurrency()),
      std::max<int64_t>((rows + chunk - 1) / chunk, 1));
  std::vector<std::string> bufs(static_cast<size_t>(n_threads));
  std::vector<char> worker_ok(static_cast<size_t>(n_threads), 1);
  // waves of n_threads chunks: format in parallel, write in order
  for (int64_t wave = 0; ok && wave * chunk * n_threads < rows; ++wave) {
    int64_t base = wave * chunk * n_threads;
    std::vector<std::thread> ts;
    int64_t live = 0;
    try {
      for (int64_t t = 0; t < n_threads; ++t) {
        int64_t r0 = base + t * chunk;
        if (r0 >= rows) break;
        int64_t r1 = std::min(rows, r0 + chunk);
        ++live;
        ts.emplace_back([&, t, r0, r1] {
          // exceptions (bad_alloc) must not escape a thread entry — that
          // would std::terminate the process instead of returning -1
          try {
            format_rows(data, cols, r0, r1, row_label_cells, mode,
                        bufs[size_t(t)]);
          } catch (...) {
            worker_ok[size_t(t)] = 0;
          }
        });
      }
    } catch (...) {
      // spawn failed mid-wave: join what launched (a joinable thread's
      // destructor would std::terminate), then abort the write
      ok = false;
    }
    for (auto& th : ts) th.join();
    for (int64_t t = 0; ok && t < live; ++t) {
      if (!worker_ok[size_t(t)]) { ok = false; break; }
      const std::string& b = bufs[size_t(t)];
      ok = std::fwrite(b.data(), 1, b.size(), f) == b.size();
    }
  }
  ok = (std::fclose(f) == 0) && ok;
  return ok ? 0 : -1;
  } catch (...) {
    std::fclose(f);
    return -1;
  }
}

extern "C" {

// Writes ``header_line`` (verbatim, may be NULL) then one line per row:
// optional pre-quoted label cell + comma-joined formatted values.
// ``append`` != 0 opens the file in append mode (streamed row blocks).
// Returns 0 on success, -1 on invalid arguments or IO failure.
int64_t seekr_write_csv_f32(const char* path, const float* data,
                            int64_t rows, int64_t cols,
                            const char* header_line,
                            const char* const* row_label_cells,
                            int32_t mode, int32_t append) {
  return write_csv_impl(path, data, rows, cols, header_line,
                        row_label_cells, mode, append);
}

// float64 flavor (pandas/Python repr bytes; mode 0 only — the %1.6f
// savetxt format is a float32 artifact contract).
int64_t seekr_write_csv_f64(const char* path, const double* data,
                            int64_t rows, int64_t cols,
                            const char* header_line,
                            const char* const* row_label_cells,
                            int32_t append) {
  return write_csv_impl(path, data, rows, cols, header_line,
                        row_label_cells, /*mode=*/0, append);
}

}  // extern "C"

// ---------------------------------------------------------------- reading

namespace {

struct CsvFile {
  std::string raw;                    // whole file
  std::vector<const char*> line_ptr;  // start of each data line (after header)
  std::vector<int64_t> line_len;
  int64_t header_len = 0;             // bytes of the first line (no \n)
  int64_t rows = 0;
  int64_t cols = 0;                   // numeric columns (excludes label cell)
  std::vector<std::string> labels;    // raw (still-quoted) label cells
};

// scan one line's label cell: bytes up to the first comma OUTSIDE quotes
int64_t label_cell_end(const char* p, int64_t n) {
  bool in_q = false;
  for (int64_t i = 0; i < n; ++i) {
    if (p[i] == '"') in_q = !in_q;
    else if (p[i] == ',' && !in_q) return i;
  }
  return n;
}

bool parse_rows(CsvFile* f, float* data, int64_t r0, int64_t r1) {
  for (int64_t r = r0; r < r1; ++r) {
    const char* p = f->line_ptr[size_t(r)];
    int64_t n = f->line_len[size_t(r)];
    int64_t le = label_cell_end(p, n);
    f->labels[size_t(r)].assign(p, size_t(le));
    const char* q = p + le;
    const char* end = p + n;
    float* out = data + r * f->cols;
    for (int64_t c = 0; c < f->cols; ++c) {
      if (q >= end || *q != ',') return false;
      ++q;
      if (q == end || *q == ',') {  // empty cell = NaN (pandas convention)
        out[c] = std::nanf("");
        continue;
      }
      // from_chars: locale-free, correctly-rounded SINGLE-precision parse
      // — exactly recovers a float32 from its shortest repr (strtof is
      // ~15x slower through glibc locale machinery; strtod-then-cast
      // double-rounds and can be 1 ulp off).  Spec accepts inf/nan but
      // not a leading '+', which this package's writer never emits.
      auto res = std::from_chars(q, end, out[c]);
      if (res.ec != std::errc() || res.ptr == q) return false;
      q = res.ptr;
    }
    if (q != end) return false;  // trailing junk / too many cells
  }
  return true;
}

}  // namespace

extern "C" {

// Parses a labeled float CSV (the artifact format this package writes):
// one header line, then one label cell + `cols` numeric cells per line.
// Returns an opaque handle or NULL on parse failure.
void* seekr_csv_open(const char* path) try {
  if (!path) return nullptr;
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return nullptr;
  std::unique_ptr<CsvFile> fu(new CsvFile());
  CsvFile* f = fu.get();
  std::fseek(fp, 0, SEEK_END);
  long sz = std::ftell(fp);  // -1 for pipes/fifos -> caller falls back
  std::fseek(fp, 0, SEEK_SET);
  if (sz <= 0) { std::fclose(fp); return nullptr; }
  f->raw.resize(size_t(sz));
  bool ok = std::fread(&f->raw[0], 1, size_t(sz), fp) == size_t(sz);
  std::fclose(fp);
  if (!ok) return nullptr;

  // split lines (tolerate missing trailing newline; skip empty last line)
  const char* p = f->raw.data();
  const char* end = p + f->raw.size();
  const char* nl = static_cast<const char*>(memchr(p, '\n', size_t(end - p)));
  if (!nl) return nullptr;
  f->header_len = nl - p;
  for (const char* s = nl + 1; s < end;) {
    const char* e = static_cast<const char*>(memchr(s, '\n', size_t(end - s)));
    if (!e) e = end;
    if (e > s) {
      f->line_ptr.push_back(s);
      f->line_len.push_back(e - s);
    }
    s = e + 1;
  }
  f->rows = int64_t(f->line_ptr.size());

  // column count from the header: commas outside quotes
  {
    bool in_q = false;
    int64_t commas = 0;
    for (int64_t i = 0; i < f->header_len; ++i) {
      char ch = f->raw[size_t(i)];
      if (ch == '"') in_q = !in_q;
      else if (ch == ',' && !in_q) ++commas;
    }
    f->cols = commas;  // first header cell is the (empty) index name
  }
  if (f->cols <= 0) return nullptr;
  f->labels.resize(size_t(f->rows));
  return fu.release();
} catch (...) {
  // exceptions (bad_alloc, length_error) must not cross the C ABI —
  // NULL routes the caller to the pandas fallback
  return nullptr;
}

int64_t seekr_csv_rows(void* h) { return h ? static_cast<CsvFile*>(h)->rows : -1; }
int64_t seekr_csv_cols(void* h) { return h ? static_cast<CsvFile*>(h)->cols : -1; }

int64_t seekr_csv_header_len(void* h) {
  return h ? static_cast<CsvFile*>(h)->header_len : -1;
}

int64_t seekr_csv_header(void* h, char* out, int64_t cap) {
  if (!h || !out) return -1;
  auto f = static_cast<CsvFile*>(h);
  if (cap < f->header_len) return -1;
  std::memcpy(out, f->raw.data(), size_t(f->header_len));
  return f->header_len;
}

int64_t seekr_csv_label_len(void* h, int64_t r) {
  auto f = static_cast<CsvFile*>(h);
  if (!f || r < 0 || r >= f->rows) return -1;
  return int64_t(f->labels[size_t(r)].size());
}

int64_t seekr_csv_label(void* h, int64_t r, char* out, int64_t cap) {
  auto f = static_cast<CsvFile*>(h);
  if (!f || !out || r < 0 || r >= f->rows) return -1;
  const std::string& s = f->labels[size_t(r)];
  if (cap < int64_t(s.size())) return -1;
  std::memcpy(out, s.data(), s.size());
  return int64_t(s.size());
}

// Parses all numeric cells directly into ``out`` [rows, cols] (parallel)
// and materializes the label cells.  Call before the label accessors.
int64_t seekr_csv_data(void* h, float* out) {
  auto f = static_cast<CsvFile*>(h);
  if (!f || !out) return -1;
  try {
  int64_t n_threads = std::min<int64_t>(
      std::max<int64_t>(1, std::thread::hardware_concurrency()),
      std::max<int64_t>(f->rows, 1));
  std::vector<std::thread> ts;
  std::vector<char> oks(static_cast<size_t>(n_threads), 1);
  int64_t per = (f->rows + n_threads - 1) / n_threads;
  bool spawn_ok = true;
  try {
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t r0 = t * per, r1 = std::min(f->rows, r0 + per);
      if (r0 >= r1) break;
      ts.emplace_back([f, out, r0, r1, t, &oks] {
        try {
          oks[size_t(t)] = parse_rows(f, out, r0, r1) ? 1 : 0;
        } catch (...) {
          oks[size_t(t)] = 0;
        }
      });
    }
  } catch (...) {
    spawn_ok = false;  // join what launched before reporting failure
  }
  for (auto& th : ts) th.join();
  if (!spawn_ok) return -1;
  for (char okf : oks)
    if (!okf) return -1;
  return 0;
  } catch (...) {
    return -1;
  }
}

void seekr_csv_close(void* h) { delete static_cast<CsvFile*>(h); }

}  // extern "C"
