// Host-side batch detokenizer.
//
// Device kernels return fixed-width int32 token arrays (deepest-first
// traceback order) plus per-read counts; turning tens of thousands of those
// into Python strings is host work on the serving path.  This replaces the
// per-read Python join loop with one C++ pass over the batch.
//
// The reference's equivalent work happens in Rust (suffix-tree traceback +
// String building, reference src/search.rs:285-300); here traceback
// already happened on device, so only label->char mapping remains.
//
// Build: g++ -O3 -shared -fPIC -o libdetok.so detok.cpp   (see build.py)

#include <cstdint>

extern "C" {

// Reverse + map label ids to single ASCII chars.
//   labels_rev: [B, Tmax] int32, label ids (0-based, i.e. alphabet row - 1),
//               deepest-first; counts: [B] valid lengths.
//   lut: ASCII char per label id (lut[l] for label l, blank excluded).
//   out: [B * Tmax] char buffer; out_offsets: [B + 1] prefix offsets.
void detok_reverse_ascii(const int32_t* labels_rev, const int32_t* counts,
                         int64_t B, int64_t Tmax, const char* lut,
                         int64_t lut_len, char* out, int64_t* out_offsets) {
  int64_t pos = 0;
  out_offsets[0] = 0;
  for (int64_t b = 0; b < B; ++b) {
    const int32_t* row = labels_rev + b * Tmax;
    int64_t n = counts[b];
    if (n < 0) n = 0;
    if (n > Tmax) n = Tmax;
    for (int64_t j = n - 1; j >= 0; --j) {
      int32_t l = row[j];
      out[pos++] = (l >= 0 && l < lut_len) ? lut[l] : '?';
    }
    out_offsets[b + 1] = pos;
  }
}

// Map label ids (already in reading order, e.g. viterbi tokens) to chars.
//   tokens: [B, Tmax] int32 of 1-based alphabet rows; counts: [B].
void detok_forward_ascii(const int32_t* tokens, const int32_t* counts,
                         int64_t B, int64_t Tmax, const char* lut,
                         int64_t lut_len, char* out, int64_t* out_offsets) {
  int64_t pos = 0;
  out_offsets[0] = 0;
  for (int64_t b = 0; b < B; ++b) {
    const int32_t* row = tokens + b * Tmax;
    int64_t n = counts[b];
    if (n < 0) n = 0;
    if (n > Tmax) n = Tmax;
    for (int64_t j = 0; j < n; ++j) {
      int32_t l = row[j];
      out[pos++] = (l >= 0 && l < lut_len) ? lut[l] : '?';
    }
    out_offsets[b + 1] = pos;
  }
}

// Phred integers -> ASCII quality chars (+33), forward order.
void qstring_ascii(const uint32_t* qints, const int32_t* counts, int64_t B,
                   int64_t Tmax, char* out, int64_t* out_offsets) {
  int64_t pos = 0;
  out_offsets[0] = 0;
  for (int64_t b = 0; b < B; ++b) {
    const uint32_t* row = qints + b * Tmax;
    int64_t n = counts[b];
    if (n < 0) n = 0;
    if (n > Tmax) n = Tmax;
    for (int64_t j = 0; j < n; ++j) {
      uint32_t q = row[j] + 33u;
      out[pos++] = q < 127u ? static_cast<char>(q) : '~';
    }
    out_offsets[b + 1] = pos;
  }
}

}  // extern "C"
