// seekr_tpu native FASTA reader + 2-bit encoder.
//
// Host-side data loader for the TPU pipeline: parses FASTA (header lines,
// multi-line sequences joined, case-insensitive — semantics of the reference
// reader, seekr/fasta_reader.py:41-63), and encodes bases to the engine's
// digit alphabet A=0 G=1 T=2 C=3 (column order of itertools.product("AGTC"),
// reference kmer_counts.py:100,121-122), any other byte = 4 (invalid).
//
// The parser is a single pass over the whole file buffer; batch encoding
// into a caller-allocated padded [m, Lpad] int8 matrix is multithreaded.
// Exposed as a C ABI for ctypes; no external dependencies.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

#include "host_parallel.h"

namespace {

using std::int64_t;

struct FastaFile {
  std::vector<std::string> headers;  // includes leading '>'
  std::vector<std::string> seqs;     // joined, uppercased
};

signed char kDigit[256];

struct DigitInit {
  DigitInit() {
    // uppercase only: lowercase (soft-masked) bases are INVALID, matching
    // the reference's uppercase-keyed k-mer map (parsed file sequences are
    // uppercased before they reach this table; raw-string encodes must
    // agree with the Python LUT in io/encode.py)
    std::memset(kDigit, 4, sizeof(kDigit));
    kDigit[(unsigned char)'A'] = 0;
    kDigit[(unsigned char)'G'] = 1;
    kDigit[(unsigned char)'T'] = 2;
    kDigit[(unsigned char)'C'] = 3;
  }
} digit_init;

}  // namespace

extern "C" {

// Parse a FASTA file. Returns an opaque handle, or nullptr on IO error
// or allocation failure (a multi-GB input on a constrained host must
// make the caller fall back to the Python reader, not let bad_alloc
// cross the C ABI and terminate the process).
void* seekr_fasta_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  try {
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {  // unseekable (FIFO/stdin): caller falls back to Python
    std::fclose(f);
    return nullptr;
  }
  std::fseek(f, 0, SEEK_SET);
  std::string buf(size_t(size), '\0');
  if (size > 0 && std::fread(&buf[0], 1, size_t(size), f) != size_t(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);
  f = nullptr;

  auto owned = std::make_unique<FastaFile>();
  auto* ff = owned.get();
  std::string cur_seq;
  bool have_record = false;
  size_t pos = 0;
  while (pos < buf.size()) {
    size_t eol = buf.find('\n', pos);
    size_t end = (eol == std::string::npos) ? buf.size() : eol;
    // strip the same ASCII whitespace set as Python str.strip()
    // (incl. the file/group/record/unit separators \x1c-\x1f, which
    // str.isspace() counts; non-ASCII whitespace like NBSP cannot be
    // handled byte-wise — the Python-side safety gate routes non-ASCII
    // files to the canonical reader)
    auto is_ws = [](char c) {
      return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f' ||
             (c >= '\x1c' && c <= '\x1f');
    };
    size_t b = pos, e = end;
    while (e > b && is_ws(buf[e - 1])) --e;
    while (b < e && is_ws(buf[b])) ++b;
    if (b < e) {
      if (buf[b] == '>') {
        if (have_record) ff->seqs.push_back(std::move(cur_seq));
        cur_seq.clear();
        ff->headers.emplace_back(buf, b, e - b);
        have_record = true;
      } else {
        size_t off = cur_seq.size();
        cur_seq.resize(off + (e - b));
        for (size_t i = b; i < e; ++i) {
          char ch = buf[i];
          cur_seq[off + (i - b)] =
              (ch >= 'a' && ch <= 'z') ? char(ch - ('a' - 'A')) : ch;
        }
      }
    }
    pos = end + 1;
  }
  if (have_record) ff->seqs.push_back(std::move(cur_seq));
  return owned.release();
  } catch (...) {
    if (f) std::fclose(f);
    return nullptr;
  }
}

void seekr_fasta_close(void* h) { delete static_cast<FastaFile*>(h); }

int64_t seekr_fasta_num_seqs(void* h) {
  return int64_t(static_cast<FastaFile*>(h)->seqs.size());
}

int64_t seekr_fasta_seq_len(void* h, int64_t i) {
  auto* ff = static_cast<FastaFile*>(h);
  if (i < 0 || size_t(i) >= ff->seqs.size()) return -1;
  return int64_t(ff->seqs[size_t(i)].size());
}

int64_t seekr_fasta_header_len(void* h, int64_t i) {
  auto* ff = static_cast<FastaFile*>(h);
  if (i < 0 || size_t(i) >= ff->headers.size()) return -1;
  return int64_t(ff->headers[size_t(i)].size());
}

// Copy header i (with leading '>') into buf; returns bytes written.
int64_t seekr_fasta_header(void* h, int64_t i, char* buf, int64_t bufsize) {
  auto* ff = static_cast<FastaFile*>(h);
  if (i < 0 || size_t(i) >= ff->headers.size()) return -1;
  const std::string& s = ff->headers[size_t(i)];
  int64_t n = std::min<int64_t>(bufsize, int64_t(s.size()));
  std::memcpy(buf, s.data(), size_t(n));
  return n;
}

// Copy uppercased sequence i into buf; returns bytes written.
int64_t seekr_fasta_seq(void* h, int64_t i, char* buf, int64_t bufsize) {
  auto* ff = static_cast<FastaFile*>(h);
  if (i < 0 || size_t(i) >= ff->seqs.size()) return -1;
  const std::string& s = ff->seqs[size_t(i)];
  int64_t n = std::min<int64_t>(bufsize, int64_t(s.size()));
  std::memcpy(buf, s.data(), size_t(n));
  return n;
}

// Encode selected sequences into a padded [m, lpad] int8 digit matrix
// (A=0 G=1 T=2 C=3, other=4; rows padded with 4). Rows longer than lpad are
// truncated. Multithreaded over rows. Returns 0 on success.
int64_t seekr_fasta_encode_batch(void* h, const int64_t* ids, int64_t m,
                                 int64_t lpad, int8_t* out) {
  auto* ff = static_cast<FastaFile*>(h);
  for (int64_t r = 0; r < m; ++r) {
    if (ids[r] < 0 || size_t(ids[r]) >= ff->seqs.size()) return -1;
  }
  try {
    const int64_t n_threads = std::min<int64_t>(
        seekr_host::pick_threads(m, 1), std::max<int64_t>(m, 1));
    seekr_host::run_parallel(n_threads, [&](int64_t t) {
      for (int64_t r = t; r < m; r += n_threads) {
        const std::string& s = ff->seqs[size_t(ids[r])];
        int8_t* row = out + r * lpad;
        int64_t n = std::min<int64_t>(lpad, int64_t(s.size()));
        for (int64_t i = 0; i < n; ++i) {
          row[i] = kDigit[(unsigned char)s[size_t(i)]];
        }
        if (n < lpad) std::memset(row + n, 4, size_t(lpad - n));
      }
    });
    return 0;
  } catch (...) {
    return -4;
  }
}

// Standalone encoder for one raw string (used when sequences come from
// Python rather than a file).
void seekr_encode_string(const char* seq, int64_t n, int8_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = kDigit[(unsigned char)seq[i]];
}

// Multithreaded host k-mer counter: counts-per-kb rows straight from the
// parsed file into a caller-allocated [num_seqs, 4^k] float32 matrix.
// Semantics identical to the engine (reference seekr/kmer_counts.py:140-151):
// rolling 2-bit window code, windows containing non-AGTC bases skipped, all
// windows in the denominator.  This is the CPU fallback that still beats
// the reference's per-window Python dict loop by ~2 orders of magnitude.
// Returns 0 on success, -1 for invalid k.
int64_t seekr_fasta_count_kmers(void* h, int64_t k, float* out) {
  if (k < 1 || k > 12) return -1;  // 4^12 columns = 64 MB/row cap
  auto* ff = static_cast<FastaFile*>(h);
  const int64_t n_cols = int64_t(1) << (2 * k);
  const uint64_t mask = uint64_t(n_cols - 1);
  const int64_t m = int64_t(ff->seqs.size());

  try {
  int64_t n_threads = std::min<int64_t>(
      std::max<int64_t>(1, std::thread::hardware_concurrency()), std::max<int64_t>(m, 1));
  // per-thread scratch is 4*4^k bytes (64 MB at k=12); cap the THREAD
  // COUNT so total transient scratch stays <= ~512 MB on many-core hosts
  const int64_t scratch_per_thread = int64_t(4) * n_cols;
  const int64_t scratch_budget = int64_t(512) << 20;
  n_threads = std::min<int64_t>(
      n_threads, std::max<int64_t>(1, scratch_budget / scratch_per_thread));
  auto worker = [&](int64_t t) {
    // sparse accumulation: rows touch at most w distinct codes, usually
    // far fewer than 4^k, so only touched bins are scaled and re-zeroed;
    // the dense output row is cleared with one memset.  uint32 bins keep
    // per-thread scratch at 4*4^k bytes (64 MB at the k=12 cap); a single
    // sequence cannot exceed 2^32 windows of one k-mer in practice.
    std::vector<uint32_t> row(static_cast<size_t>(n_cols), 0);
    std::vector<int64_t> touched;
    for (int64_t s = t; s < m; s += n_threads) {
      const std::string& seq = ff->seqs[size_t(s)];
      float* out_row = out + s * n_cols;
      int64_t n = int64_t(seq.size());
      int64_t w = n - k + 1;
      std::memset(out_row, 0, size_t(n_cols) * sizeof(float));
      if (w < 1) continue;
      touched.clear();
      uint64_t code = 0;
      int64_t run = 0;  // consecutive valid bases ending here
      for (int64_t i = 0; i < n; ++i) {
        signed char d = kDigit[(unsigned char)seq[size_t(i)]];
        if (d >= 4) {
          run = 0;
          code = 0;
        } else {
          code = ((code << 2) | uint64_t(d)) & mask;
          if (++run >= k) {
            if (row[size_t(code)]++ == 0) touched.push_back(int64_t(code));
          }
        }
      }
      double scale = 1000.0 / double(w);
      for (int64_t c : touched) {
        out_row[c] = float(double(row[size_t(c)]) * scale);
        row[size_t(c)] = 0;
      }
    }
  };
  seekr_host::run_parallel(n_threads, worker);
  return 0;
  } catch (...) {
    return -4;
  }
}

}  // extern "C"
