// SDPA sparse-format (.dat-s) tokenizer for hdsdp_tpu_torch.
//
// Native counterpart of the pure-Python parser in hdsdp_tpu_torch/io/sdpa.py
// and a copy of the JAX package's tokenizer (hdsdp_tpu/native/sdpa_parser.cpp),
// changed to read the file line by line as the Python parser does and to
// report every malformed input with a message instead of stopping early:
//
//   * leading lines that are blank or start with '*' or '"' are comments;
//   * the first data line holds m, the next the number of blocks;
//   * the block dimensions follow, over as many lines as they need
//     ({ } ( ) ' , are separators), then the m values of b likewise; each
//     list ends its last line;
//   * every further line is one entry <con> <blk> <i> <j> <val> (1-based
//     blk, i, j; text after '#' is ignored, blank lines are skipped), up to
//     a line holding "BEGIN.COMMENT";
//   * entries with |val| < 1e-12 (or NaN) are dropped (ref
//     hdsdp_file_io.c:224-230).
//
// Numbers are read with strtod and the four indices truncated to integers,
// as numpy's loadtxt + astype(int64) does.  Exported through a C ABI
// consumed by hdsdp_tpu_torch/native/sdpa_native.py via ctypes.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 (sdpa_native.build).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr double kTinyEntry = 1e-12;

struct SdpaFile {
  int32_t m = 0;
  std::vector<int32_t> dims;  // as written: negative = LP block
  std::vector<double> b;
  std::vector<int32_t> con, blk, row, col;
  std::vector<double> val;
};

struct Lines {
  const char* p;
  const char* end;
  long lineno = 0;
  // [b, e) of the next line without its '\n'; false at the end of the text
  bool next(const char*& b, const char*& e) {
    if (p >= end) return false;
    b = p;
    while (p < end && *p != '\n') ++p;
    e = p;
    if (p < end) ++p;
    ++lineno;
    return true;
  }
};

inline bool is_sep(char c) {
  return std::isspace(static_cast<unsigned char>(c)) || c == ',' || c == '{' ||
         c == '}' || c == '(' || c == ')' || c == '\'';
}

inline bool blank(const char* b, const char* e) {
  for (; b < e; ++b)
    if (!std::isspace(static_cast<unsigned char>(*b))) return false;
  return true;
}

// strtod at b: the number must end at e or at a separator (whitespace, and
// in the header also the punctuation of is_sep).  The text buffer is
// NUL-terminated and strtod stops at '\n' and '#', so it never reads a
// number across the end of the line.
bool read_number(const char*& b, const char* e, bool header, double& v) {
  char* stop = nullptr;
  v = std::strtod(b, &stop);
  if (stop == b || stop > e) return false;
  if (stop < e && !(header ? is_sep(*stop) : std::isspace(static_cast<unsigned char>(*stop))))
    return false;
  b = stop;
  return true;
}

void fail(char* err, int errlen, long lineno, const char* what) {
  if (err && errlen > 0)
    std::snprintf(err, static_cast<size_t>(errlen), "line %ld: %s", lineno, what);
}

// Reads `count` numbers of a header list that may span lines.
bool read_list(Lines& in, size_t count, std::vector<double>& out, char* err,
               int errlen, const char* what) {
  const char *b, *e;
  while (out.size() < count) {
    if (!in.next(b, e)) {
      fail(err, errlen, in.lineno, what);
      return false;
    }
    while (b < e) {
      while (b < e && is_sep(*b)) ++b;
      if (b >= e) break;
      double v;
      if (!read_number(b, e, true, v)) {
        fail(err, errlen, in.lineno, what);
        return false;
      }
      out.push_back(v);
    }
  }
  out.resize(count);
  return true;
}

SdpaFile* parse(const char* path, char* err, int errlen) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    if (err && errlen > 0)
      std::snprintf(err, static_cast<size_t>(errlen), "cannot open %s", path);
    return nullptr;
  }
  std::string buf;
  char chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof chunk, f)) > 0) buf.append(chunk, got);
  std::fclose(f);

  Lines in{buf.data(), buf.data() + buf.size()};
  const char *b, *e;
  // comments, then m and the number of blocks: the first token of a line
  do {
    if (!in.next(b, e)) {
      fail(err, errlen, in.lineno, "no header");
      return nullptr;
    }
  } while (blank(b, e) || *b == '*' || *b == '"');
  int64_t head[2];
  for (int i = 0; i < 2; ++i) {
    if (i == 1 && !in.next(b, e)) {
      fail(err, errlen, in.lineno, "missing the number of blocks");
      return nullptr;
    }
    while (b < e && std::isspace(static_cast<unsigned char>(*b))) ++b;
    char* stop = nullptr;
    std::string tok(b, e);
    head[i] = std::strtoll(tok.c_str(), &stop, 10);
    if (stop == tok.c_str() ||
        (*stop != '\0' && !std::isspace(static_cast<unsigned char>(*stop)))) {
      fail(err, errlen, in.lineno, i == 0 ? "bad m" : "bad number of blocks");
      return nullptr;
    }
  }
  if (head[0] < 0 || head[1] <= 0) {
    fail(err, errlen, in.lineno, "bad m or number of blocks");
    return nullptr;
  }

  auto file = new SdpaFile();
  file->m = static_cast<int32_t>(head[0]);
  std::vector<double> nums;
  if (!read_list(in, static_cast<size_t>(head[1]), nums, err, errlen,
                 "bad or missing block dimensions")) {
    delete file;
    return nullptr;
  }
  for (double d : nums) file->dims.push_back(static_cast<int32_t>(d));
  nums.clear();
  if (!read_list(in, static_cast<size_t>(file->m), nums, err, errlen,
                 "bad or missing values of b")) {
    delete file;
    return nullptr;
  }
  file->b = nums;

  // entry body: <con> <blk> <i> <j> <val>, 1-based blk/i/j
  size_t guess = buf.size() / 24 + 16;
  file->con.reserve(guess);
  file->blk.reserve(guess);
  file->row.reserve(guess);
  file->col.reserve(guess);
  file->val.reserve(guess);
  while (in.next(b, e)) {
    const char* hash = static_cast<const char*>(std::memchr(b, '#', e - b));
    if (hash) e = hash;
    static const char kCut[] = "BEGIN.COMMENT";
    if (std::search(b, e, kCut, kCut + sizeof kCut - 1) != e) break;
    if (blank(b, e)) continue;
    double v[5];
    int n = 0;
    while (true) {
      while (b < e && std::isspace(static_cast<unsigned char>(*b))) ++b;
      if (b >= e) break;
      if (n == 5 || !read_number(b, e, false, v[n])) {
        fail(err, errlen, in.lineno, "malformed SDPA entry line");
        delete file;
        return nullptr;
      }
      ++n;
    }
    if (n != 5) {
      fail(err, errlen, in.lineno, "malformed SDPA entry line");
      delete file;
      return nullptr;
    }
    if (!(std::fabs(v[4]) >= kTinyEntry)) continue;
    file->con.push_back(static_cast<int32_t>(static_cast<int64_t>(v[0])));
    file->blk.push_back(static_cast<int32_t>(static_cast<int64_t>(v[1]) - 1));
    file->row.push_back(static_cast<int32_t>(static_cast<int64_t>(v[2]) - 1));
    file->col.push_back(static_cast<int32_t>(static_cast<int64_t>(v[3]) - 1));
    file->val.push_back(v[4]);
  }
  return file;
}

}  // namespace

extern "C" {

void* hdsdp_sdpa_parse(const char* path, char* err, int errlen) {
  return parse(path, err, errlen);
}

int32_t hdsdp_sdpa_m(void* h) { return static_cast<SdpaFile*>(h)->m; }

int32_t hdsdp_sdpa_nblocks(void* h) {
  return static_cast<int32_t>(static_cast<SdpaFile*>(h)->dims.size());
}

int64_t hdsdp_sdpa_nnz(void* h) {
  return static_cast<int64_t>(static_cast<SdpaFile*>(h)->val.size());
}

void hdsdp_sdpa_export(void* h, int32_t* dims, double* b, int32_t* con,
                       int32_t* blk, int32_t* row, int32_t* col, double* val) {
  auto* f = static_cast<SdpaFile*>(h);
  std::memcpy(dims, f->dims.data(), f->dims.size() * sizeof(int32_t));
  std::memcpy(b, f->b.data(), f->b.size() * sizeof(double));
  std::memcpy(con, f->con.data(), f->con.size() * sizeof(int32_t));
  std::memcpy(blk, f->blk.data(), f->blk.size() * sizeof(int32_t));
  std::memcpy(row, f->row.data(), f->row.size() * sizeof(int32_t));
  std::memcpy(col, f->col.data(), f->col.size() * sizeof(int32_t));
  std::memcpy(val, f->val.data(), f->val.size() * sizeof(double));
}

void hdsdp_sdpa_free(void* h) { delete static_cast<SdpaFile*>(h); }

}  // extern "C"
