// One column step of the bit-parallel (1, 0, -g) fill over one 64-bit word
// of query rows, shared by bitpal_gfill.cu (one pair: K1's, K2's and K4's
// ports) and bitpal_batch.cu (a batch of pairs, one block each: K5's
// port).  bitpal_gfill.cu states the planes' contract and derivation.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxThreads = 1024;
constexpr int kAlphabet = 5;
constexpr int kMaxG = 7;

// One g = 1 column step of one word.  (b0, b1): the word's vertical-delta
// planes (enc = v + 1), updated in place.  (u0, u1): enc of the horizontal
// delta entering the top row; on return, enc of the h_out leaving the
// bottom row.  (U0, U1): on return, enc of the h_out of every row of the
// word, the horizontal delta H(i, j) - H(i, j-1) that a capture reads.
// Carries out of bit 63 are dropped: the bottom row's promotion reaches the
// next word through h_out, not through the add.
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

// x += c (mod 2^B), c a constant given as B planes of all ones or zeros.
template <int B>
__device__ __forceinline__ void add_const(u64 (&x)[B], const u64 (&c)[B]) {
  u64 carry = 0;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const u64 s = x[b] ^ c[b] ^ carry;
    carry = (x[b] & c[b]) | (carry & (x[b] ^ c[b]));
    x[b] = s;
  }
}

// x += p (mod 2^B), p a single bit plane.
template <int B>
__device__ __forceinline__ void add_bit(u64 (&x)[B], u64 p) {
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const u64 s = x[b] ^ p;
    p &= x[b];
    x[b] = s;
  }
}

// One column step of one word under (1, 0, -g), g >= 2: the port of
// tpualign/ops/bitpal.py:_g_plane_step with 64-bit words.  V: the word's B
// vertical-delta planes, updated in place.  u: enc bits (0 or 1) of the
// h_top entering the top row; on return, of the h_out leaving the bottom
// row.  vm: vmax = 2g + 1 as B planes of all ones or zeros.  U: on return,
// the B planes of every row's h_out enc.
template <int B>
__device__ __forceinline__ void g_plane_step(u64 E, u64 (&V)[B], u64 (&u)[B],
                                             const u64 (&vm)[B],
                                             u64 (&U)[B]) {
  u64 is0 = ~0ull;    // enc_v == 0, i.e. v = -g
  u64 ismax = ~0ull;  // enc_v == vmax, i.e. v = 1 + g
  u64 cin = 1;        // h_top == 1 + g: the promotion enters from above
#pragma unroll
  for (int b = 0; b < B; ++b) {
    U[b] = ~V[b];
    is0 &= U[b];
    ismax &= V[b] ^ ~vm[b];
    cin &= u[b] ^ ~vm[b];
  }
  const u64 received = (is0 + (E & is0) + (cin & 1)) ^ is0;
  const u64 P = E | ismax | received;  // promotion bit
  // h_out enc = vmax + ~enc_v + P = 2g - enc_v + P (mod 2^B)
  add_const<B>(U, vm);
  add_bit<B>(U, P);
  // v_out enc = 2g - enc_h_in + P, h_in = every row's h_out shifted down
  // one row, the word's h_top entering row 0
#pragma unroll
  for (int b = 0; b < B; ++b) V[b] = ~((U[b] << 1) | u[b]);
  add_const<B>(V, vm);
  add_bit<B>(V, P);
#pragma unroll
  for (int b = 0; b < B; ++b) u[b] = U[b] >> 63;
}

}  // namespace
