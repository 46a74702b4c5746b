// Keccak-f[1600] as device functions, one thread per state: the
// permutation of K2 (mask_limbs.cu, as a loop over its rounds), K5
// (permute.cu) and K6 (sponge_planes.cu, unrolled). K1 (sponge.cu) holds a
// state across a warp and takes only the round constants and rotl64 from
// here.
//
// Replaces the permutation body of dilithium_tpu/ops/keccak.py
// (_round_soa / _f1600_soa, run by the Pallas kernels of
// dilithium_tpu/ops/keccak_pallas.py). The TPU has no 64-bit integers, so
// the JAX package splits every lane into two uint32 halves; Hopper's
// integer units rotate 64-bit values in two funnel shifts, so here each
// of the 25 lanes is one uint64_t. The loops inside a round are fully
// unrolled with constant indices, which keeps the state in registers.
#pragma once

#include <cstdint>

namespace dk {

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));  // n in [1, 63]
}

#define DK_KECCAK_ROUND_CONSTANTS                                              \
  0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,        \
      0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,    \
      0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,    \
      0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,    \
      0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,    \
      0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,    \
      0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,    \
      0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL

namespace {
__constant__ uint64_t kRoundConstants[24] = {DK_KECCAK_ROUND_CONSTANTS};
}  // namespace

// One round of Keccak-f[1600] with round constant rc.
__device__ __forceinline__ void keccak_round(uint64_t st[25], uint64_t rc) {
  // rho offsets and pi lane order along the pi cycle starting at lane 1
  const int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                        27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  const int piln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                        15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
  uint64_t bc[5];
  // theta
#pragma unroll
  for (int i = 0; i < 5; ++i)
    bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const uint64_t t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
#pragma unroll
    for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
  }
  // rho + pi
  uint64_t t = st[1];
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int j = piln[i];
    const uint64_t tmp = st[j];
    st[j] = rotl64(t, rotc[i]);
    t = tmp;
  }
  // chi
#pragma unroll
  for (int j = 0; j < 25; j += 5) {
#pragma unroll
    for (int i = 0; i < 5; ++i) bc[i] = st[j + i];
#pragma unroll
    for (int i = 0; i < 5; ++i) st[j + i] ^= (~bc[(i + 1) % 5]) & bc[(i + 2) % 5];
  }
  // iota
  st[0] ^= rc;
}

// Keccak-f[1600], all 24 rounds unrolled: some 4,300 instructions of
// straight-line code (K5, K6).
__device__ __forceinline__ void keccakf(uint64_t st[25]) {
  const uint64_t rc[24] = {DK_KECCAK_ROUND_CONSTANTS};
#pragma unroll
  for (int r = 0; r < 24; ++r) keccak_round(st, rc[r]);
}

// Keccak-f[1600] as a loop of 6 steps of 4 rounds, the round constants
// from constant memory: a kernel that permutes many times in series keeps
// its code within the SM's instruction cache (4 rounds a step measured a
// little faster than 1, 2 or 8 in K2).
__device__ __forceinline__ void keccakf_loop(uint64_t st[25]) {
#pragma unroll 1
  for (int r = 0; r < 24; r += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) keccak_round(st, kRoundConstants[r + u]);
  }
}

// Little-endian 64-bit load from a byte pointer of any alignment.
__device__ __forceinline__ uint64_t load_le64(const uint8_t* p) {
  uint64_t v = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) v |= uint64_t(p[k]) << (8 * k);
  return v;
}

}  // namespace dk
