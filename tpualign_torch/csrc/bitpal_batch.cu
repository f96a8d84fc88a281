// Bit-parallel Needleman-Wunsch fill of a batch of pairs under the scoring
// family (1, 0, -g), g = 1..7, one thread block per pair, the whole batch
// in one launch.
//
// Replaces the TPU kernel tpualign/ops/bitpal.py:_batch_kernel_body (K5),
// which fills same-bucket pairs interleaved in one row block.  Contract,
// word for word the same as batch_fill_plain in tpualign_torch/ops/bitpal.py:
//
//   in:  texts   (P, m_cap)       int8, pair p's text in texts[p][0..mt[p])
//                                 (codes 0..4; other codes match nothing)
//        mts     (P,)             int64, text lengths in 1..m_cap
//        eq      (P, 5, nw)       uint64, bit b of eq[p][c][w] set iff
//                                 query_p[64w+b] == c; rows past the
//                                 pair's query match nothing
//        g                        the reduced gap weight, 1..7
//   out: planes  (P, B, nw)       uint64, pair p's final column v(i, mt[p])
//                                 as B bit planes of enc = v + g, B = bit
//                                 length of 2g + 1, over all nw words
//
// The rows past a pair's query match nothing and lie below its last row;
// deltas flow down only, so they never reach the pair's rows, and every
// pair of the batch shares nw and one geometry.  Their planes are still
// defined (the same wavefront runs over them), so kernel and plain version
// compare word for word there too.
//
// Schedule: block p runs bitpal_gfill_kernel's schedule (bitpal_gfill.cu)
// on pair p: thread t owns words [t*K, t*K+K), keeps their B planes in
// registers, computes column j = d - t at step d and hands the B-bit h_out
// of its last word to thread t+1 through a parity double buffer in shared
// memory, one __syncthreads() per step, mt[p] + blockDim.x - 1 steps.
//
// What the TPU layout does and this one does not: the TPU interleaves the
// pairs in one row block so that one step advances them all, with one
// shared sublane roll, a per-pair row-0 patch, a column-major text packed
// 8 pairs to a word and pend rings.  Here the pairs are independent
// blocks, so the card's scheduler spreads them over its 132 SMs.
//
// What bounds it: each block issues every word step of its pair (about 25
// 64-bit integer operations at g = 1, twice that at B = 3..4) plus a block
// barrier per column; a batch of P pairs uses min(P, 132 x resident
// blocks) SMs, and the longest pair sets the time of a small batch.

#include "bitpal_step.cuh"

namespace {

template <int K, int B>
__global__ void __launch_bounds__(kMaxThreads)
    bitpal_batch_kernel(const int8_t* __restrict__ texts, int64_t m_cap,
                        const int64_t* __restrict__ mts,
                        const u64* __restrict__ eq, int nw, int vmax,
                        u64* __restrict__ planes) {
  __shared__ uint8_t hand[2][kMaxThreads];
  const int64_t p = blockIdx.x;
  const int8_t* text = texts + p * m_cap;
  const int64_t mt = mts[p];
  const u64* peq = eq + p * kAlphabet * nw;
  const int t = threadIdx.x;
  const int w0 = t * K;
  u64 V[K][B];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int b = 0; b < B; ++b) V[i][b] = 0;  // column 0: v = -g, enc 0
  }
  u64 vm[B];
#pragma unroll
  for (int b = 0; b < B; ++b) vm[b] = ((vmax >> b) & 1) ? ~0ull : 0ull;

  const int64_t steps = mt + blockDim.x - 1;
  for (int64_t d = 1; d <= steps; ++d) {
    const int64_t j = d - t;
    if (j >= 1 && j <= mt) {
      const int c = text[j - 1];
      // word 0's h_top is the top boundary h = -g: enc 0
      const unsigned h = t > 0 ? hand[(d - 1) & 1][t - 1] : 0u;
      u64 u[B];
#pragma unroll
      for (int b = 0; b < B; ++b) u[b] = (h >> b) & 1;
      const bool known = c >= 0 && c < kAlphabet;
      const u64* e = peq + (known ? c : 0) * static_cast<int64_t>(nw) + w0;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const u64 E = (known && w0 + i < nw) ? e[i] : 0;
        u64 U[B];
        if constexpr (B == 2) {
          plane_step(E, V[i][0], V[i][1], u[0], u[1], U[0], U[1]);
        } else {
          g_plane_step<B>(E, V[i], u, vm, U);
        }
      }
      unsigned hv = 0;
#pragma unroll
      for (int b = 0; b < B; ++b) hv |= static_cast<unsigned>(u[b]) << b;
      hand[d & 1][t] = static_cast<uint8_t>(hv);
    }
    __syncthreads();
  }
  u64* out = planes + p * B * nw;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (w0 + i < nw) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        out[b * static_cast<int64_t>(nw) + w0 + i] = V[i][b];
      }
    }
  }
}

struct BatchArgs {
  const int8_t* texts;
  int64_t m_cap;
  const int64_t* mts;
  const u64* eq;
  int nw;
  int vmax;
  u64* planes;
};

template <int B>
int launch_k(int k, int pairs, int threads, cudaStream_t s,
             const BatchArgs& a) {
  switch (k) {
#define BATCH_CASE(K)                                                        \
  case K:                                                                    \
    bitpal_batch_kernel<K, B><<<pairs, threads, 0, s>>>(                     \
        a.texts, a.m_cap, a.mts, a.eq, a.nw, a.vmax, a.planes);              \
    break;
    BATCH_CASE(1)
    BATCH_CASE(2)
    BATCH_CASE(4)
    BATCH_CASE(8)
    BATCH_CASE(16)
#undef BATCH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5's contract: launches one block of `threads` threads of k words each
// (threads * k >= nw, threads <= 1024, k in {1, 2, 4, 8, 16}) per pair on
// `stream`, `pairs` blocks in all; writes the B final planes of pair p to
// planes[p] (B, nw).  Returns the cudaError_t of the launch; the fill
// itself runs asynchronously.
extern "C" int bitpal_batch_fill(const void* texts, int64_t m_cap,
                                 const void* mts, const void* eq, int pairs,
                                 int nw, int g, int k, int threads,
                                 void* planes, void* stream) {
  if (g < 1 || g > kMaxG || pairs < 1 || m_cap < 1 || nw < 1 ||
      threads < 1 || threads > kMaxThreads ||
      static_cast<int64_t>(threads) * k < nw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BatchArgs a{static_cast<const int8_t*>(texts), m_cap,
                    static_cast<const int64_t*>(mts),
                    static_cast<const u64*>(eq), nw, 2 * g + 1,
                    static_cast<u64*>(planes)};
  auto s = static_cast<cudaStream_t>(stream);
  // B = bit length of vmax = 2g + 1
  if (g == 1) return launch_k<2>(k, pairs, threads, s, a);
  if (g <= 3) return launch_k<3>(k, pairs, threads, s, a);
  return launch_k<4>(k, pairs, threads, s, a);
}
