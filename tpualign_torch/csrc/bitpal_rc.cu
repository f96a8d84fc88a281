// Bit-parallel (1, 0, -g) fills whose words trail each other by one step:
// the g = 1 fill at RC = 2..4 text columns a step, and resumable chunks of
// it and of the one-column fill at any g.
//
// Replaces three contracts of tpualign/ops/bitpal.py:
//   _rc_kernel_body       (K3a): the g = 1 final column, rc columns a step;
//   _rc_chunk_kernel_body (K3b): K3a resumed over a chunk of steps, its
//                                state carried in and out;
//   _chunk_kernel_body    (K4):  the state in and out of the g-family chunk
//                                (word 0's h_top the constant boundary, as
//                                _score_chunked_fn passes it; the upstream
//                                stream and the tail capture of the sharded
//                                pipeline are not part of this port).
// Contract, word for word the same as _wave_plain in
// tpualign_torch/ops/bitpal.py (fill_rc_plain, chunk_plain):
//
//   in:  text     (mt,)     int8, codes 0..4 (other codes match nothing),
//                           the whole text: a step reads the columns its
//                           words' windows cover
//        eq       (5, nw)   uint64, bit b of eq[c][w] set iff
//                           query[64w+b] == c
//        t0, t1             the steps t0+1 .. t1 to run
//        v_in     (B, nw)   uint64, the planes of the state in (chunks)
//        h_in     (nw,)     uint8, the hand-offs of the state in (chunks)
//   out: v_out    (B, nw)   uint64, the planes after step t1: at the last
//                           step, the final column's v(i, mt) as B planes
//                           of enc = v + g
//        h_out    (nw,)     uint8 (chunks): each word's h_out enc at step
//                           t1, RC columns of B bits, column c at bit c*B
//
// Schedule: word w at step t advances its window s = t - 1 - w, columns
// RC*s + 1 .. RC*s + RC in turn, each column's h_top the h_out word w - 1
// produced for it one step earlier (K3a's in-lane stagger: a word trails
// its predecessor by one step, so one synchronisation covers RC columns);
// word 0's h_top is the top boundary h = -g, enc 0.  Columns outside
// 1..mt leave the planes as they are.  A fill runs ceil(mt/RC) + nw - 1
// steps; a chunk's state is every word's planes and last hand-off, so any
// split of the steps gives the one launch's planes.
//
// Thread t owns words [t*K, t*K + K) with their planes and last hand-offs
// in registers.  Word i of a thread takes word i-1's hand-off of the last
// step from a register, so a thread's K words are independent within a
// step; word 0 takes the last word of thread t-1's through __shfl_up_sync,
// and lane 0 of a warp from lane 31 of the warp before through a parity
// buffer in shared memory, one __syncthreads() a step.  A block of one
// warp has no block barrier.  Each word reads its own text bytes, a step
// ahead, and its match planes from global memory (the TPU kernel passed
// chars through its hand-off pack because its text lay in SMEM).
//
// What bounds it: one SM issues every word-column step (about 25 64-bit
// integer operations at g = 1, twice that at B = 3..4, plus a text byte
// and a match-plane load); the other SMs idle.  At RC > 1 the barrier and
// the shuffle are paid once for RC columns.  At K = 16 the planes do not
// fit the 64 registers a thread has under 1024 threads and spill.

#include "bitpal_step.cuh"

namespace {

// The one body of the three entries: steps t0+1 .. t1 from the state in
// (CHUNK) or from the column-0 boundary.
template <int RC, int B, int K, bool CHUNK>
__device__ __forceinline__ void wave(const int8_t* __restrict__ text,
                                     const u64* __restrict__ eq, int64_t mt,
                                     int nw, int vmax, int64_t t0, int64_t t1,
                                     const u64* __restrict__ v_in,
                                     const uint8_t* __restrict__ h_in,
                                     u64* __restrict__ v_out,
                                     uint8_t* __restrict__ h_out) {
  __shared__ unsigned xbuf[2][kMaxThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool multi = blockDim.x > 32;
  const int w0 = tid * K;
  u64 V[K][B];
  unsigned hp[K];  // each word's hand-off of the last step
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const bool real = w0 + i < nw;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      V[i][b] = (CHUNK && real) ? v_in[b * static_cast<int64_t>(nw) + w0 + i] : 0;
    }
    hp[i] = (CHUNK && real) ? h_in[w0 + i] : 0u;
  }
  u64 vm[B];
#pragma unroll
  for (int b = 0; b < B; ++b) vm[b] = ((vmax >> b) & 1) ? ~0ull : 0ull;
  // byte c of codes(t, i): the code of word i's column c at step t,
  // kAlphabet where it matches nothing (outside 1..mt, past the words, or
  // not a code 0..4)
  auto codes = [&](int64_t t, int i) {
    const int w = w0 + i;
    unsigned packed = 0;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int64_t col = RC * (t - 1 - w) + c + 1;
      int code = (col >= 1 && col <= mt && w < nw) ? text[col - 1] : kAlphabet;
      code = (code >= 0 && code < kAlphabet) ? code : kAlphabet;
      packed |= static_cast<unsigned>(code) << (8 * c);
    }
    return packed;
  };
  unsigned cur[K];
#pragma unroll
  for (int i = 0; i < K; ++i) cur[i] = codes(t0 + 1, i);
  unsigned hv = hp[K - 1];
  if (multi) {
    if (lane == 31) xbuf[t0 & 1][warp] = hv;
    __syncthreads();
  }
  for (int64_t t = t0 + 1; t <= t1; ++t) {
    // the next step's text, read while this step computes: the critical
    // path keeps one match-plane load a word, not a text load before it
    unsigned nxt[K];
#pragma unroll
    for (int i = 0; i < K; ++i) nxt[i] = codes(t + 1, i);
    unsigned hin = __shfl_up_sync(0xffffffffu, hv, 1);
    if (lane == 0) hin = warp == 0 ? 0u : xbuf[(t - 1) & 1][warp - 1];
    // last word first, so that word i still finds word i-1's hand-off of
    // the last step in hp[i-1]
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      const int w = w0 + i;
      const unsigned h = i ? hp[i - 1] : hin;
      const int64_t base = RC * (t - 1 - w);  // the column before the window
      u64 Es[RC];
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const unsigned code = (cur[i] >> (8 * c)) & 0xffu;
        Es[c] = code < kAlphabet ? eq[code * static_cast<int64_t>(nw) + w] : 0;
      }
      unsigned hn = 0;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int64_t col = base + c + 1;
        const bool live = col >= 1 && col <= mt;
        const u64 E = Es[c];
        u64 u[B], U[B], Vn[B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          u[b] = (h >> (c * B + b)) & 1;
          Vn[b] = V[i][b];
        }
        if constexpr (B == 2) {
          plane_step(E, Vn[0], Vn[1], u[0], u[1], U[0], U[1]);
        } else {
          g_plane_step<B>(E, Vn, u, vm, U);
        }
#pragma unroll
        for (int b = 0; b < B; ++b) {
          V[i][b] = live ? Vn[b] : V[i][b];
          hn |= static_cast<unsigned>(u[b]) << (c * B + b);
        }
      }
      hp[i] = hn;
    }
#pragma unroll
    for (int i = 0; i < K; ++i) cur[i] = nxt[i];
    hv = hp[K - 1];
    if (multi) {
      if (lane == 31) xbuf[t & 1][warp] = hv;
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (w0 + i < nw) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        v_out[b * static_cast<int64_t>(nw) + w0 + i] = V[i][b];
      }
      if (CHUNK) h_out[w0 + i] = static_cast<uint8_t>(hp[i]);
    }
  }
}

struct FillArgs {
  const int8_t* text;
  const u64* eq;
  int64_t mt;
  int nw;
  u64* planes;
};

struct ChunkArgs {
  const int8_t* text;
  const u64* eq;
  int64_t mt;
  int nw;
  int vmax;
  int64_t t0;
  int64_t t1;
  const u64* v_in;
  const uint8_t* h_in;
  u64* v_out;
  uint8_t* h_out;
};

// K3a's port: g = 1, RC columns a step, from the boundary to the end.
template <int RC, int K>
__global__ void __launch_bounds__(kMaxThreads) bitpal_rc_kernel(const FillArgs a) {
  const int64_t steps = (a.mt + RC - 1) / RC + a.nw - 1;
  wave<RC, 2, K, false>(a.text, a.eq, a.mt, a.nw, 3, 0, steps, nullptr, nullptr, a.planes,
                        nullptr);
}

// K3b's port (RC > 1, B = 2) and K4's state in and out (RC = 1): one chunk.
template <int RC, int B, int K>
__global__ void __launch_bounds__(kMaxThreads) bitpal_chunk_kernel(const ChunkArgs a) {
  wave<RC, B, K, true>(a.text, a.eq, a.mt, a.nw, a.vmax, a.t0, a.t1, a.v_in, a.h_in,
                       a.v_out, a.h_out);
}

bool bad_geometry(int nw, int k, int threads) {
  return nw < 1 || threads < 32 || threads > kMaxThreads || threads % 32 ||
         static_cast<int64_t>(threads) * k < nw;
}

template <int RC>
int launch_fill(int k, int threads, cudaStream_t s, const FillArgs& a) {
  switch (k) {
#define RC_CASE(K)                                            \
  case K:                                                     \
    bitpal_rc_kernel<RC, K><<<1, threads, 0, s>>>(a);         \
    break;
    RC_CASE(1)
    RC_CASE(2)
    RC_CASE(4)
    RC_CASE(8)
    RC_CASE(16)
#undef RC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int RC, int B>
int launch_chunk(int k, int threads, cudaStream_t s, const ChunkArgs& a) {
  switch (k) {
#define CHUNK_CASE(K)                                         \
  case K:                                                     \
    bitpal_chunk_kernel<RC, B, K><<<1, threads, 0, s>>>(a);   \
    break;
    CHUNK_CASE(1)
    CHUNK_CASE(2)
    CHUNK_CASE(4)
    CHUNK_CASE(8)
    CHUNK_CASE(16)
#undef CHUNK_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3a's contract: launches the g = 1 fill at rc = 2..4 columns a step on
// `stream` with `threads` threads (a multiple of 32, up to 1024) of k words
// each (k in {1, 2, 4, 8, 16}, threads * k >= nw); writes the two final
// planes to `planes` (2, nw).  Returns the cudaError_t of the launch; the
// fill itself runs asynchronously.
extern "C" int bitpal_rc_fill(const void* text, const void* eq, int64_t mt, int nw, int rc,
                              int k, int threads, void* planes, void* stream) {
  if (bad_geometry(nw, k, threads) || mt < 0) return static_cast<int>(cudaErrorInvalidValue);
  const FillArgs a{static_cast<const int8_t*>(text), static_cast<const u64*>(eq), mt, nw,
                   static_cast<u64*>(planes)};
  auto s = static_cast<cudaStream_t>(stream);
  if (rc == 2) return launch_fill<2>(k, threads, s, a);
  if (rc == 3) return launch_fill<3>(k, threads, s, a);
  if (rc == 4) return launch_fill<4>(k, threads, s, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3b's contract: steps t0+1 .. t0+t_steps of K3a's fill at rc = 2..4 from
// the state (v_in (2, nw), h_in (nw,)); writes the state after them to
// (v_out, h_out).  Geometry as bitpal_rc_fill's.
extern "C" int bitpal_rc_chunk(const void* text, const void* eq, int64_t mt, int nw, int rc,
                               int k, int threads, int64_t t0, int64_t t_steps,
                               const void* v_in, const void* h_in, void* v_out, void* h_out,
                               void* stream) {
  if (bad_geometry(nw, k, threads) || mt < 0 || t0 < 0 || t_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ChunkArgs a{static_cast<const int8_t*>(text), static_cast<const u64*>(eq), mt, nw, 3,
                    t0, t0 + t_steps, static_cast<const u64*>(v_in),
                    static_cast<const uint8_t*>(h_in), static_cast<u64*>(v_out),
                    static_cast<uint8_t*>(h_out)};
  auto s = static_cast<cudaStream_t>(stream);
  if (rc == 2) return launch_chunk<2, 2>(k, threads, s, a);
  if (rc == 3) return launch_chunk<3, 2>(k, threads, s, a);
  if (rc == 4) return launch_chunk<4, 2>(k, threads, s, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4's state in and out: steps t0+1 .. t0+t_steps of the (1, 0, -g) fill
// at one column a step, g = 1..7, from the state (v_in (B, nw), h_in (nw,))
// to (v_out, h_out), B = bit length of 2g + 1.  Geometry as
// bitpal_rc_fill's.
extern "C" int bitpal_gfill_chunk(const void* text, const void* eq, int64_t mt, int nw, int g,
                                  int k, int threads, int64_t t0, int64_t t_steps,
                                  const void* v_in, const void* h_in, void* v_out,
                                  void* h_out, void* stream) {
  if (bad_geometry(nw, k, threads) || mt < 0 || t0 < 0 || t_steps < 1 || g < 1 ||
      g > kMaxG) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ChunkArgs a{static_cast<const int8_t*>(text), static_cast<const u64*>(eq), mt, nw,
                    2 * g + 1, t0, t0 + t_steps, static_cast<const u64*>(v_in),
                    static_cast<const uint8_t*>(h_in), static_cast<u64*>(v_out),
                    static_cast<uint8_t*>(h_out)};
  auto s = static_cast<cudaStream_t>(stream);
  if (g == 1) return launch_chunk<1, 2>(k, threads, s, a);
  if (g <= 3) return launch_chunk<1, 3>(k, threads, s, a);
  return launch_chunk<1, 4>(k, threads, s, a);
}
