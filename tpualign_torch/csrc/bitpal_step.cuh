// The g = 1 column step of the bit-parallel fill, shared by bitpal_fill.cu
// (the K1 port) and bitpal_gfill.cu (the K2 and K4 ports), so that both
// run the same algebra at the reference's scoring (1, 0, -1).

#pragma once

#include <cstdint>

namespace bitpal {

typedef unsigned long long u64;

constexpr int kMaxThreads = 1024;
constexpr int kAlphabet = 5;

// One column step of one word.  (b0, b1): the word's vertical-delta planes
// (enc = v + 1), updated in place.  (u0, u1): enc of the horizontal delta
// entering the top row; on return, enc of the h_out leaving the bottom row.
// (U0, U1): on return, enc of the h_out of every row of the word, the
// horizontal delta H(i, j) - H(i, j-1) that a capture reads.  Carries out of
// bit 63 are dropped: the bottom row's promotion reaches the next word
// through h_out, not through the add.
__device__ __forceinline__ void plane_step(u64 E, u64& b0, u64& b1, u64& u0,
                                           u64& u1, u64& U0, u64& U1) {
  const u64 vm1 = ~b0 & ~b1;  // v = -1
  const u64 received = (vm1 + (E & vm1) + (u0 & u1)) ^ vm1;
  const u64 P = E | (b0 & b1) | received;  // promotion bit
  U0 = (P & ~b0) | (~P & b0 & ~b1);
  U1 = (P & ~b1) | (~P & vm1);
  const u64 U0i = (U0 << 1) | u0;
  const u64 U1i = (U1 << 1) | u1;
  b0 = U0i ^ P;
  b1 = ~(U0i ^ U1i) ^ (U0i & P);
  u0 = U0 >> 63;
  u1 = U1 >> 63;
}

}  // namespace bitpal
