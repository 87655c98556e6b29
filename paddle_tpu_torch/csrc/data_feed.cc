// Host MultiSlot text parser of the PyTorch port (not a device kernel).
//
// Counterpart of paddle_tpu/native/src/data_feed.cc (reference
// paddle/fluid/framework/data_feed.cc, MultiSlotDataFeed::
// ParseOneInstance): each line holds, per slot, a count followed by that
// many values (float slots or uint64 id slots).  The parse loop is the
// JAX package's, line for line; the interface is plain C, so the library
// builds with g++ alone (paddle_tpu_torch/native/build.py build_host)
// and Python loads it with ctypes (paddle_tpu_torch/native/__init__.py):
//
//   void* pt_multislot_parse(data, len, types, err, err_cap, n_lines)
//       -> a handle, or NULL with the error message in err;
//   int64_t pt_multislot_count(handle, slot)   values held by one slot;
//   void pt_multislot_copy(handle, slot, values, lod)
//       copies the slot's values (float32 or uint64) and its n_lines + 1
//       cumulative offsets into the caller's arrays;
//   void pt_multislot_free(handle).

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <string>
#include <vector>

namespace {

struct SlotBuf {
  char type;                     // 'f' float32, 'u' uint64
  std::vector<float> fvals;
  std::vector<uint64_t> uvals;
  std::vector<int64_t> lod;      // cumulative offsets, starts at 0
};

// The python fallback tokenizes on whitespace, so a numeric token must
// be consumed in full; strtox stopping mid-token ("3.5" as count) is a
// parse error, not a value.
inline bool is_tok_ws(char c) {
  // every separator python bytes.split() honors (minus '\n', the line
  // delimiter handled above this level)
  return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

inline bool at_token_boundary(const char* c) {
  return *c == '\0' || is_tok_ws(*c);
}

// Parse one buffer of '\n'-separated lines into per-slot value/lod
// buffers.  Returns false + sets err on malformed input.
//
// Each line is copied into a reusable NUL-terminated scratch string so
// strtox can neither run past the logical buffer end (the caller's
// buffer is not NUL-terminated) nor steal tokens across line
// boundaries: a short line is an error, never silent data corruption.
bool parse_buffer(const char* data, int64_t len,
                  std::vector<SlotBuf>& slots, std::string& err,
                  int64_t* n_lines_out) {
  const char* p = data;
  const char* end = data + len;
  int64_t n_lines = 0;
  std::string line;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (line_end == nullptr) line_end = end;
    // skip blank lines, including CRLF/whitespace-only ones (parity with
    // the python fallback's token-split semantics)
    const char* first = p;
    while (first < line_end && is_tok_ws(*first)) ++first;
    if (first < line_end) {
      // an embedded NUL would silently truncate the NUL-terminated
      // scratch copy; the python fallback errors on such tokens — reject
      if (memchr(p, '\0', static_cast<size_t>(line_end - p)) != nullptr) {
        err = "bad value (embedded NUL) at line " + std::to_string(n_lines);
        return false;
      }
      line.assign(p, static_cast<size_t>(line_end - p));
      const char* q = line.c_str();
      for (auto& slot : slots) {
        // parse count.  strtoll alone would accept partial tokens
        // ("3.5" -> 3) the python fallback rejects, so every numeric
        // token must end at whitespace/NUL (token-boundary parity).
        char* next = nullptr;
        long long cnt = strtoll(q, &next, 10);
        if (next == q || cnt < 0 || !at_token_boundary(next)) {
          err = "bad slot count at line " + std::to_string(n_lines);
          return false;
        }
        q = next;
        for (long long i = 0; i < cnt; ++i) {
          if (slot.type == 'f') {
            // python float() rejects C99 hex-float literals strtof
            // accepts; keep the two paths agreeing on what is malformed
            const char* t = q;
            while (is_tok_ws(*t)) ++t;
            if (*t == '+' || *t == '-') ++t;
            if (t[0] == '0' && (t[1] == 'x' || t[1] == 'X')) {
              err = "bad float value at line " + std::to_string(n_lines);
              return false;
            }
            float v = strtof(q, &next);
            if (next == q || !at_token_boundary(next) ||
                memchr(q, '(', static_cast<size_t>(next - q)) != nullptr) {
              // '(' only appears in C99 NAN(n-char-seq), which python
              // float() rejects
              err = "bad float value at line " + std::to_string(n_lines);
              return false;
            }
            slot.fvals.push_back(v);
          } else {
            // out-of-range ids saturate in strtoull but wrap in python's
            // int & mask — reject in both paths instead (errno check
            // here, magnitude check in the fallback)
            errno = 0;
            unsigned long long v = strtoull(q, &next, 10);
            if (next == q || !at_token_boundary(next) || errno == ERANGE) {
              err = "bad id value at line " + std::to_string(n_lines);
              return false;
            }
            slot.uvals.push_back(static_cast<uint64_t>(v));
          }
          q = next;
        }
        slot.lod.push_back(slot.type == 'f'
                               ? static_cast<int64_t>(slot.fvals.size())
                               : static_cast<int64_t>(slot.uvals.size()));
      }
      // trailing tokens mean the line held more data than the slot
      // spec describes — reject, don't silently drop
      while (is_tok_ws(*q)) ++q;
      if (*q != '\0') {
        err = "trailing tokens at line " + std::to_string(n_lines);
        return false;
      }
      ++n_lines;
    }
    p = line_end + 1;
  }
  *n_lines_out = n_lines;
  return true;
}

struct Parsed {
  std::vector<SlotBuf> slots;
  int64_t n_lines = 0;
};

}  // namespace

extern "C" {

void* pt_multislot_parse(const char* data, int64_t len, const char* types,
                         char* err, int64_t err_cap, int64_t* n_lines) {
  auto set_err = [&](const std::string& msg) {
    if (err_cap > 0) {
      const size_t n = std::min(msg.size(), static_cast<size_t>(err_cap - 1));
      std::memcpy(err, msg.data(), n);
      err[n] = '\0';
    }
  };
  Parsed* out = new Parsed();
  for (const char* t = types; *t; ++t) {
    if (*t != 'f' && *t != 'u') {
      set_err(std::string("slot type must be 'f' or 'u', got '") + *t + "'");
      delete out;
      return nullptr;
    }
    SlotBuf s;
    s.type = *t;
    s.lod.push_back(0);
    out->slots.push_back(std::move(s));
  }
  std::string msg;
  if (!parse_buffer(data, len, out->slots, msg, &out->n_lines)) {
    set_err(msg);
    delete out;
    return nullptr;
  }
  *n_lines = out->n_lines;
  return out;
}

int64_t pt_multislot_count(void* handle, int slot) {
  const SlotBuf& s = static_cast<Parsed*>(handle)->slots[slot];
  return s.type == 'f' ? static_cast<int64_t>(s.fvals.size())
                       : static_cast<int64_t>(s.uvals.size());
}

void pt_multislot_copy(void* handle, int slot, void* values, int64_t* lod) {
  const SlotBuf& s = static_cast<Parsed*>(handle)->slots[slot];
  if (s.type == 'f') {
    if (!s.fvals.empty())
      std::memcpy(values, s.fvals.data(), s.fvals.size() * sizeof(float));
  } else if (!s.uvals.empty()) {
    std::memcpy(values, s.uvals.data(), s.uvals.size() * sizeof(uint64_t));
  }
  std::memcpy(lod, s.lod.data(), s.lod.size() * sizeof(int64_t));
}

void pt_multislot_free(void* handle) { delete static_cast<Parsed*>(handle); }

}  // extern "C"
