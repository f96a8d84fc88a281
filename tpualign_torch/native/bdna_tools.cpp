// Host C++ support of the PyTorch/CUDA port (tpualign_torch): its own copy
// of the functions it needs from the JAX package's native/bdna_tools.cpp,
// with the same C signatures, arithmetic and tie order.
//
//   * the full-table walks traceback_native (pair scoring, int32 table) and
//     traceback_flex_native (a substitution matrix or pair scoring, int64
//     table): the leaves of the port's alignment trees, its Smith-Waterman
//     windows and its full-table route, on several threads (ctypes releases
//     the interpreter lock during a call);
//   * the row-scan scorers align_score_native, affine_score_native and
//     score_flex_native: an independent CPU oracle (the CLI's
//     `bench --check native`);
//   * bdna_generate and bdna_validate: corpus tools.
//
// Built with the system g++ at first use and loaded with ctypes by
// tpualign_torch/utils/native.py.  No Python headers needed.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// --- corpus tools ----------------------------------------------------------

// xoshiro256** - tiny, fast, seedable PRNG for base generation
static inline uint64_t rotl(uint64_t x, int k) {
  return (x << k) | (x >> (64 - k));
}

struct Xoshiro {
  uint64_t s[4];
  explicit Xoshiro(uint64_t seed) {
    // splitmix64 expansion
    for (int i = 0; i < 4; ++i) {
      seed += 0x9e3779b97f4a7c15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  uint64_t next() {
    uint64_t r = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
    s[2] ^= t; s[3] = rotl(s[3], 45);
    return r;
  }
};

// Fill `out` with `len` random base codes 1..4.
void bdna_generate(uint64_t seed, int64_t len, int8_t* out) {
  Xoshiro rng(seed);
  int64_t i = 0;
  for (; i + 32 <= len; i += 32) {
    uint64_t r = rng.next();
    for (int k = 0; k < 32; ++k) {
      out[i + k] = (int8_t)(1 + ((r >> (2 * k)) & 3));
    }
  }
  if (i < len) {
    uint64_t r = rng.next();
    for (int k = 0; i < len; ++i, ++k) {
      out[i] = (int8_t)(1 + ((r >> (2 * k)) & 3));
    }
  }
}

// Return index of first byte outside 0..4, or -1 if all valid.
int64_t bdna_validate(const int8_t* seq, int64_t len) {
  for (int64_t i = 0; i < len; ++i) {
    if (seq[i] < 0 || seq[i] > 4) return i;
  }
  return -1;
}

// --- independent scorer (validation oracle) --------------------------------

// Row-scan alignment score in O(M) memory.
//   mode 0: global (Needleman-Wunsch)  — boundaries i*gap / j*gap
//   mode 1: local  (Smith-Waterman)    — zero floor, max over all cells
// Semantics identical to the reference serial kernel: tie order is irrelevant
// for the score; int64 accumulators keep any scoring config exact.
int64_t align_score_native(const int8_t* s1, int64_t m,
                           const int8_t* s2, int64_t n,
                           int64_t match, int64_t mismatch, int64_t gap,
                           int mode) {
  if (m <= 0 || n <= 0) {
    return mode == 1 ? 0 : (int64_t)(m + n) * gap;
  }
  std::vector<int64_t> row((size_t)m + 1);
  const bool local = (mode == 1);
  for (int64_t j = 0; j <= m; ++j) row[(size_t)j] = local ? 0 : j * gap;
  int64_t best = 0;
  for (int64_t i = 1; i <= n; ++i) {
    int64_t diag = row[0];                     // H[i-1][j-1]
    int64_t left = local ? 0 : i * gap;        // H[i][j-1], starts at column 0
    row[0] = left;
    const int8_t c2 = s2[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t up = row[(size_t)j];       // H[i-1][j]
      int64_t v = diag + (s1[j - 1] == c2 ? match : mismatch);
      v = std::max(v, up + gap);
      v = std::max(v, left + gap);
      if (local) {
        v = std::max<int64_t>(v, 0);
        best = std::max(best, v);
      }
      diag = up;
      row[(size_t)j] = v;
      left = v;
    }
  }
  return local ? best : row[(size_t)m];
}

// Affine-gap (Gotoh) row-scan score in O(M) memory: a run of L gap
// columns costs open + L*ext (both <= 0).  Sequential three-row
// recurrence — an independent verifier for the affine engines.
//   mode 0: global, boundaries H(0,j) = open + j*ext;  mode 1: local.
int64_t affine_score_native(const int8_t* s1, int64_t m,
                            const int8_t* s2, int64_t n,
                            int64_t match, int64_t mismatch,
                            int64_t open_, int64_t ext, int mode) {
  const bool local = (mode == 1);
  if (m <= 0 || n <= 0) {
    if (local || m + n == 0) return 0;
    return open_ + (int64_t)(m + n) * ext;
  }
  const int64_t NEG = INT64_MIN / 4;
  std::vector<int64_t> H((size_t)m + 1), F((size_t)m + 1, NEG);
  for (int64_t j = 0; j <= m; ++j)
    H[(size_t)j] = (local || j == 0) ? 0 : open_ + j * ext;
  int64_t best = 0;
  for (int64_t i = 1; i <= n; ++i) {
    int64_t diag = H[0];
    int64_t e = NEG;                            // E[i][0]
    H[0] = local ? 0 : open_ + i * ext;
    const int8_t c2 = s2[i - 1];
    int64_t left = H[0];
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t up = H[(size_t)j];
      F[(size_t)j] = std::max(up + open_, F[(size_t)j]) + ext;
      e = std::max(left + open_, e) + ext;
      int64_t v = diag + (s1[j - 1] == c2 ? match : mismatch);
      v = std::max(v, std::max(e, F[(size_t)j]));
      if (local) {
        v = std::max<int64_t>(v, 0);
        best = std::max(best, v);
      }
      diag = up;
      H[(size_t)j] = v;
      left = v;
    }
  }
  return local ? best : H[(size_t)m];
}

// Full-table fill + traceback walk. Writes the edit path (from the END;
// caller reverses) into ops_out as 0 = diag, 1 = up (gap in s1), 2 = left
// (gap in s2); returns the path length and the score via score_out.
// score_out[1], score_out[2] receive the path's START cell (i, j) — for
// global mode always (0, 0); for local mode the cell where the walk
// stopped, which callers need to render the matched substrings.
// Tie order diag > up > left, SW start = row-major-first maximum cell and
// stop at the first zero — byte-identical to ops/oracle.py:traceback.
// Caller guarantees (m+1)*(n+1) cells fit memory and scores fit int32.
int64_t traceback_native(const int8_t* s1, int64_t m,
                         const int8_t* s2, int64_t n,
                         int64_t match, int64_t mismatch, int64_t gap,
                         int mode, int64_t* score_out, int8_t* ops_out) {
  const bool local = (mode == 1);
  const int64_t W = m + 1;
  std::vector<int32_t> H((size_t)((n + 1) * W));
  for (int64_t j = 0; j <= m; ++j) H[(size_t)j] = (int32_t)(local ? 0 : j * gap);
  for (int64_t i = 1; i <= n; ++i) {
    int32_t* cur = &H[(size_t)(i * W)];
    const int32_t* prev = &H[(size_t)((i - 1) * W)];
    cur[0] = (int32_t)(local ? 0 : i * gap);
    const int8_t c2 = s2[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      int32_t v = prev[j - 1] + (int32_t)(s1[j - 1] == c2 ? match : mismatch);
      v = std::max(v, prev[j] + (int32_t)gap);
      v = std::max(v, cur[j - 1] + (int32_t)gap);
      if (local) v = std::max(v, 0);
      cur[j] = v;
    }
  }
  int64_t i = n, j = m;
  if (local) {
    int32_t best = 0;
    i = 0; j = 0;
    for (int64_t ii = 0; ii <= n; ++ii)
      for (int64_t jj = 0; jj <= m; ++jj)
        if (H[(size_t)(ii * W + jj)] > best) {  // strict: first occurrence wins
          best = H[(size_t)(ii * W + jj)];
          i = ii; j = jj;
        }
  }
  *score_out = H[(size_t)(i * W + j)];
  int64_t len = 0;
  while (i > 0 || j > 0) {
    const int32_t h = H[(size_t)(i * W + j)];
    if (local && h == 0) break;
    if (i > 0 && j > 0 &&
        h == H[(size_t)((i - 1) * W + j - 1)] +
                 (int32_t)(s1[j - 1] == s2[i - 1] ? match : mismatch)) {
      ops_out[len++] = 0; --i; --j;
    } else if (i > 0 && h == H[(size_t)((i - 1) * W + j)] + (int32_t)gap) {
      ops_out[len++] = 1; --i;
    } else if (j > 0 && h == H[(size_t)(i * W + j - 1)] + (int32_t)gap) {
      ops_out[len++] = 2; --j;
    } else {
      return -1;  // broken table; the caller raises
    }
  }
  score_out[1] = i;
  score_out[2] = j;
  return len;
}

// Matrix-aware full-table fill + traceback walk: the leaf walker for
// matrix-scored global/local cores recovered by the device k-way splits
// (ops/band_align.py), and for pairs whose scores may pass int32.  Same contract as traceback_native with a
// substitution matrix (mat[a*K+b], int64, or nullptr for pair scoring):
// ops path from the END (0 diag / 1 up / 2 left), returns length, score and
// start cell via score_out.  Tie order diag > up > left, identical to
// ops/oracle.py:traceback.  int64 table: any matrix magnitude stays exact.
int64_t traceback_flex_native(const int8_t* s1, int64_t m,
                              const int8_t* s2, int64_t n,
                              const int64_t* mat, int64_t k,
                              int64_t match, int64_t mismatch, int64_t gap,
                              int mode, int64_t* score_out, int8_t* ops_out) {
  const bool local = (mode == 1);
  const int64_t W = m + 1;
  std::vector<int64_t> H((size_t)((n + 1) * W));
  for (int64_t j = 0; j <= m; ++j) H[(size_t)j] = local ? 0 : j * gap;
  for (int64_t i = 1; i <= n; ++i) {
    int64_t* cur = &H[(size_t)(i * W)];
    const int64_t* prev = &H[(size_t)((i - 1) * W)];
    cur[0] = local ? 0 : i * gap;
    const int8_t c2 = s2[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      const int8_t c1 = s1[j - 1];
      const int64_t sub = mat ? mat[(size_t)((int64_t)c1 * k + c2)]
                              : (c1 == c2 ? match : mismatch);
      int64_t v = prev[j - 1] + sub;
      v = std::max(v, prev[j] + gap);
      v = std::max(v, cur[j - 1] + gap);
      if (local) v = std::max<int64_t>(v, 0);
      cur[j] = v;
    }
  }
  int64_t i = n, j = m;
  if (local) {
    int64_t best = 0;
    i = 0; j = 0;
    for (int64_t ii = 0; ii <= n; ++ii)
      for (int64_t jj = 0; jj <= m; ++jj)
        if (H[(size_t)(ii * W + jj)] > best) {  // strict: first occurrence
          best = H[(size_t)(ii * W + jj)];
          i = ii; j = jj;
        }
  }
  *score_out = H[(size_t)(i * W + j)];
  int64_t len = 0;
  while (i > 0 || j > 0) {
    const int64_t h = H[(size_t)(i * W + j)];
    if (local && h == 0) break;
    int64_t sub = 0;
    if (i > 0 && j > 0) {
      const int8_t c1 = s1[j - 1], c2 = s2[i - 1];
      sub = mat ? mat[(size_t)((int64_t)c1 * k + c2)]
                : (c1 == c2 ? match : mismatch);
    }
    if (i > 0 && j > 0 && h == H[(size_t)((i - 1) * W + j - 1)] + sub) {
      ops_out[len++] = 0; --i; --j;
    } else if (i > 0 && h == H[(size_t)((i - 1) * W + j)] + gap) {
      ops_out[len++] = 1; --i;
    } else if (j > 0 && h == H[(size_t)(i * W + j - 1)] + gap) {
      ops_out[len++] = 2; --j;
    } else {
      return -1;  // broken table; the caller raises
    }
  }
  score_out[1] = i;
  score_out[2] = j;
  return len;
}

// Unified flexible row-scan scorer: substitution matrix, linear or affine
// (Gotoh) gaps, four alignment modes — the independent verifier for the
// matrix/semiglobal capabilities of the engines.
//   mat:  K*K row-major int64 matrix indexed by symbol code (mat[a*K+b]
//         scores s1-code a against s2-code b), or nullptr to use
//         match/mismatch pair scoring.
//   mode: 0 global, 1 local (SW), 2 semiglobal (both sequences' end gaps
//         free; score = max over last row + last column), 3 infix (all of
//         s2 aligned inside s1; s1 end gaps free; score = max over last
//         row).
// O(m) memory; int64 accumulators keep any scoring config exact.
int64_t score_flex_native(const int8_t* s1, int64_t m,
                          const int8_t* s2, int64_t n,
                          const int64_t* mat, int64_t k,
                          int64_t match, int64_t mismatch, int64_t gap,
                          int64_t open_, int64_t ext,
                          int affine, int mode) {
  const bool local = (mode == 1);
  const bool zero_row = local || mode == 2 || mode == 3;  // H(0, j) = 0
  const bool zero_col = local || mode == 2;               // H(i, 0) = 0
  const int64_t NEG = INT64_MIN / 4;
  std::vector<int64_t> H((size_t)m + 1), F;
  if (affine) F.assign((size_t)m + 1, NEG);
  for (int64_t j = 0; j <= m; ++j) {
    H[(size_t)j] = zero_row || j == 0
                       ? 0
                       : (affine ? open_ + j * ext : j * gap);
  }
  int64_t best = 0;                 // local running max
  int64_t best_col = H[(size_t)m];  // last-column running max (ends-free)
  for (int64_t i = 1; i <= n; ++i) {
    int64_t diag = H[0];
    H[0] = zero_col ? 0 : (affine ? open_ + i * ext : i * gap);
    int64_t left = H[0];
    int64_t e = NEG;
    const int8_t c2 = s2[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t up = H[(size_t)j];
      const int8_t c1 = s1[j - 1];
      const int64_t sub =
          mat ? mat[(size_t)((int64_t)c1 * k + c2)]
              : (c1 == c2 ? match : mismatch);
      int64_t v;
      if (affine) {
        F[(size_t)j] = std::max(up + open_, F[(size_t)j]) + ext;
        e = std::max(left + open_, e) + ext;
        v = std::max(diag + sub, std::max(e, F[(size_t)j]));
      } else {
        v = std::max(diag + sub, std::max(up, left) + gap);
      }
      if (local) {
        v = std::max<int64_t>(v, 0);
        best = std::max(best, v);
      }
      diag = up;
      H[(size_t)j] = v;
      left = v;
    }
    best_col = std::max(best_col, H[(size_t)m]);
  }
  if (local) return best;
  if (mode == 2 || mode == 3) {
    int64_t row_best = H[0];
    for (int64_t j = 1; j <= m; ++j) row_best = std::max(row_best, H[(size_t)j]);
    return mode == 2 ? std::max(row_best, best_col) : row_best;
  }
  return H[(size_t)m];
}

}  // extern "C"
