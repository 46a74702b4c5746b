// K3: SampleInBall, one warp per message.
//
// Replaces dilithium_tpu/ops/ball_pallas.py::sample_in_ball_words
// (_kernel), run in every round of the one-key signer on the
// SHAKE256(c_tilde) stream.
//
// Stream semantics (pq-crystals poly_challenge): bytes 0..7 are 64 sign
// bits, little-endian; each later byte j is a candidate position for the
// Fisher-Yates step i = 256 - tau + cnt and is taken iff j <= i; on take
// c[i] = c[j], then c[j] = +-1 by sign bit cnt. If the stream runs out
// before tau takes, ok is 0 and the missing steps swap with j = 0, as the
// JAX package's kernel and plain path do.
//
// Bound on the card: bytes (the 1 KB int32 row written per message), but
// at the signer's W = 768 what costs time is the latency of one message's
// dependent steps. The design spreads them over a warp:
//   - 768 warps (4 a block) fill all 132 SMs; the row is loaded coalesced
//     into a 272-byte slice of shared memory per warp, as 32-bit words
//     where the row is 4-byte aligned and as bytes otherwise;
//   - the walk takes 32 candidate bytes at a time, one per lane. Byte j
//     at lane l is taken iff j <= 256 - tau + cnt0 + (takes of lanes < l),
//     cnt0 the count before the chunk. That condition is monotone in the
//     count and lane l depends only on lanes before it, so iterating
//     T <- ballot(j <= 256 - tau + cnt0 + popc(T & lanes below)) from
//     T = ballot(j <= 256 - tau + cnt0) reaches the sequential answer
//     (only bytes in the band (256 - tau + cnt0, 255] can take more than
//     one pass). Takes whose step reaches tau come after the walk's end
//     and are dropped. A taken lane writes its j to the step's slot;
//   - c is K7's two bit planes (csrc/ball_bitplane.cu), nz (c[r] != 0) and
//     sg (c[r] = -1), dealt over the warp: lane l holds c[8l .. 8l+7] as
//     the low two bytes of one register. Every lane runs each of the tau
//     swaps: one shuffle reads c[j] from lane j >> 3, lane i >> 3 writes it
//     at i, then lane j >> 3 writes +-1 at j. A chain of one shuffle and a
//     few integer ops a step; the same swaps on lane 0 over the planes in
//     eight 64-bit registers took 12.0 us at B = 768 and 123 us at B =
//     16384 against 5.6 and 39.0 us (PERF.md, NVIDIA H100 80GB HBM3);
//   - lane l then writes its 8 coefficients as two int4 stores, so each
//     warp store covers the row's 1 KB.
// Output int32 [B, 256] canonical in {0, 1, q - 1} and ok one byte (0 or
// 1) per row, written straight into the caller's bool tensor.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 8380417;
constexpr int kWarps = 4;    // messages a block
constexpr int kStage = 272;  // bytes staged per message: the signer's 2 SHAKE256 blocks
constexpr int kNoTake = 1 << 16;  // candidate past the row's end: never a valid take

__global__ void __launch_bounds__(kWarps * 32)
    ball_kernel(const uint8_t* __restrict__ stream, int32_t* __restrict__ c_out,
                uint8_t* __restrict__ ok_out, int batch, int tau, int nbytes) {
  __shared__ __align__(16) uint8_t rows[kWarps][kStage];
  __shared__ uint8_t steps[kWarps][64];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= batch) return;  // the whole warp; no block-wide barrier follows

  const uint8_t* row = stream + size_t(b) * nbytes;
  uint8_t* sb = rows[warp];
  const int staged = min(nbytes, kStage);
  int by_word = 0;
  if ((reinterpret_cast<uintptr_t>(row) & 3) == 0) {
    by_word = staged & ~3;
    for (int w = lane; w < by_word / 4; w += 32)
      reinterpret_cast<uint32_t*>(sb)[w] = reinterpret_cast<const uint32_t*>(row)[w];
  }
  for (int k = by_word + lane; k < staged; k += 32) sb[k] = row[k];
  __syncwarp();

  // the walk, 32 candidates a chunk; cnt is warp-uniform
  const unsigned below = (1u << lane) - 1u;
  uint8_t* jpos = steps[warp];
  int cnt = 0;
  for (int start = 8; start < nbytes && cnt < tau; start += 32) {
    const int pos = start + lane;
    const int j = pos >= nbytes ? kNoTake : pos < kStage ? sb[pos] : row[pos];
    const int lim = 256 - tau + cnt;
    unsigned taken = __ballot_sync(~0u, j <= lim);
    for (;;) {
      const unsigned next = __ballot_sync(~0u, j <= lim + __popc(taken & below));
      if (next == taken) break;
      taken = next;
    }
    const int step = cnt + __popc(taken & below);
    if (((taken >> lane) & 1u) && step < tau) jpos[step] = uint8_t(j);
    cnt = min(cnt + __popc(taken), tau);
  }
  __syncwarp();

  // lane l holds c[8l + e] as bit e (nz) and bit 8 + e (sg) of `mine`
  const uint64_t signs = reinterpret_cast<const uint64_t*>(sb)[0];
  uint32_t mine = 0;
  for (int t = 0; t < tau; ++t) {
    const int j = t < cnt ? jpos[t] : 0;
    const int i = 256 - tau + t;
    const uint32_t cj = (__shfl_sync(~0u, mine, j >> 3) >> (j & 7)) & 0x101u;
    if (lane == (i >> 3)) mine = (mine & ~(0x101u << (i & 7))) | (cj << (i & 7));
    if (lane == (j >> 3))
      mine = (mine & ~(0x100u << (j & 7))) | ((1u | uint32_t((signs >> t) & 1ull) << 8) << (j & 7));
  }
  if (lane == 0) ok_out[b] = cnt >= tau ? 1 : 0;

  int4* o = reinterpret_cast<int4*>(c_out + size_t(b) * 256) + 2 * lane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 4 * h + e;
      v[e] = (mine >> r) & 1u ? ((mine >> (8 + r)) & 1u ? kQ - 1 : 1) : 0;
    }
    o[h] = make_int4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

extern "C" int dk_ball(const void* stream_bytes, void* c, void* ok,
                       int batch, int tau, int nbytes, void* stream) {
  if (batch > 0) {
    const int blocks = (batch + kWarps - 1) / kWarps;
    ball_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(stream_bytes), static_cast<int32_t*>(c),
        static_cast<uint8_t*>(ok), batch, tau, nbytes);
  }
  return int(cudaGetLastError());
}
