// Native Levenshtein edit distance for WER/CER scoring.
//
// The reference reaches native code for this through the `editdistance`
// PyPI C++ extension (reference: src/util.py:124); here we provide our own
// minimal implementation, loaded from Python via ctypes (no pybind11).
//
// Two entry points:
//   levenshtein_i64: distance between two int64 token sequences.
//   levenshtein_batch_i64: batched distances, used to score a whole decode
//     batch with one call (avoids per-utterance FFI overhead).
//
// Standard two-row DP, O(min(m,n)) memory.

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

int64_t levenshtein_i64(const int64_t* a, int64_t la,
                        const int64_t* b, int64_t lb) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  // Keep the shorter sequence as the DP row.
  if (lb > la) {
    std::swap(a, b);
    std::swap(la, lb);
  }
  std::vector<int64_t> row(static_cast<size_t>(lb) + 1);
  for (int64_t j = 0; j <= lb; ++j) row[static_cast<size_t>(j)] = j;
  for (int64_t i = 1; i <= la; ++i) {
    int64_t prev_diag = row[0];
    row[0] = i;
    for (int64_t j = 1; j <= lb; ++j) {
      int64_t cur = row[static_cast<size_t>(j)];
      int64_t cost = (a[i - 1] == b[j - 1]) ? 0 : 1;
      row[static_cast<size_t>(j)] =
          std::min({row[static_cast<size_t>(j)] + 1,
                    row[static_cast<size_t>(j - 1)] + 1, prev_diag + cost});
      prev_diag = cur;
    }
  }
  return row[static_cast<size_t>(lb)];
}

// Flattened batch: sequences are concatenated; offsets give starts.
void levenshtein_batch_i64(const int64_t* a_flat, const int64_t* a_off,
                           const int64_t* b_flat, const int64_t* b_off,
                           int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = levenshtein_i64(a_flat + a_off[i], a_off[i + 1] - a_off[i],
                             b_flat + b_off[i], b_off[i + 1] - b_off[i]);
  }
}

}  // extern "C"
