// K1: batched Keccak sponge (SHAKE128/256, SHA3-256/512), one warp per
// message, one lane of the Keccak state per thread.
//
// Replaces dilithium_tpu/ops/keccak_pallas.py::shake_words_folded
// (_xof_kernel): every SHAKE/SHA3 on the one-key signing path runs here
// (keygen's seed expansion, ExpandA, ExpandS and tr; rhoprime; c_tilde;
// the SampleInBall stream). The standalone permutation f1600_folded is
// K5 (permute.cu).
//
// Bound on the card: integer work, some 4,300 32-bit instructions a
// permutation, is the bound only where a batch fills the card. Each round
// of the signer runs two small batches, W = 768 messages: c_tilde absorbs
// 832 bytes (7 permutations in series), the SampleInBall stream squeezes
// 272 (2). There the chain of permutations in series sets the time. With
// one thread per message, W = 768 is 24 warps, and a lone warp issues a
// permutation's ~4,300 integer instructions at 16 lanes a clock: c_tilde
// took 67.6 us on an H100 80GB HBM3 at 700 W with the per-thread state and
// the I/O staged through shared memory with 16-byte copies, 79.0 us with
// the per-thread state and byte-wise I/O (tools/kernel_ab.py).
//
// Design. Thread x + 5y of a warp holds lane A[x][y] as one uint64_t
// (threads 25-31 compute on junk and are never read), so W = 768 is 768
// warps on all 132 SMs and each instruction does one lane's work. theta's
// column parities and its D, and the lanes rho and pi move into chi's
// three inputs, come from other threads through __shfl_sync: 9 64-bit
// shuffles a round in three dependent steps, sources fixed per thread.
// Absorbing, thread w below the rate in lanes (17, 21 or 9) loads lane w
// of the rate block, so a warp's loads cover the block's contiguous bytes
// (8-byte loads where the row is 8-aligned, bytes otherwise), applies
// pad10*1 on the fly, and loads the next block before permuting this one.
// Squeezing, thread w stores lane w the same way. No shared memory; 2
// warps a block. On the same card: c_tilde 19.8 us, the ball stream
// 7.6 us (per-thread with staged I/O: 67.6 and 32.0).
//
// What is left: the shuffles. A permutation issues 432 of them and the SM
// issues one a clock, so where a batch fills the card this design loses
// to the per-thread one: rhoprime [16384, 96] -> 64 takes 34.1 us against
// 13.7 us (per-thread, staged I/O) and 24.8 us (per-thread, byte-wise).
// rhoprime runs once a queue, c_tilde and the stream every round.
#include <cuda_runtime.h>

#include <cstdint>

#include "keccak.cuh"

namespace {

constexpr int kWarps = 2;  // messages a block

// rho offset of lane x + 5y
__constant__ int kRho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                             25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

// pi moves lane A[x][y] to B[y][2x + 3y], so B[X][Y] is lane
// ((X + 3Y) mod 5) + 5X of A.
__device__ __forceinline__ int pi_source(int x, int y) { return (x + 3 * y) % 5 + 5 * x; }

// Where thread x + 5y reads: the other four lanes of its column (theta),
// lanes x-1 and x+1 of its row (theta's D), and the lanes of A that pi
// moves onto B[x][y], B[x+1][y] and B[x+2][y] (chi).
struct Sources {
  int col[4], xm1, xp1, pi[3], rho;
  uint64_t lane0;  // all ones on thread 0 (iota), else 0
};

__device__ __forceinline__ Sources sources(int t) {
  Sources s;
  if (t >= 25) t = 0;  // threads 25-31 follow lane 0's pattern; their values are unused
  const int x = t % 5, y = t / 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) s.col[k] = (t + 5 * (k + 1)) % 25;
  s.xm1 = (x + 4) % 5 + 5 * y;
  s.xp1 = (x + 1) % 5 + 5 * y;
#pragma unroll
  for (int k = 0; k < 3; ++k) s.pi[k] = pi_source((x + k) % 5, y);
  s.rho = kRho[t];
  s.lane0 = threadIdx.x % 32 == 0 ? ~uint64_t(0) : 0;
  return s;
}

__device__ __forceinline__ uint64_t shfl(uint64_t v, int src) {
  return __shfl_sync(0xFFFFFFFFu, v, src);
}

// Rotate left by r in [0, 63], r different on each thread.
__device__ __forceinline__ uint64_t rotl_var(uint64_t v, int r) {
  uint32_t lo = uint32_t(v), hi = uint32_t(v >> 32);
  if (r & 32) {
    const uint32_t t = lo;
    lo = hi;
    hi = t;
  }
  return uint64_t(__funnelshift_l(lo, hi, r)) << 32 | __funnelshift_l(hi, lo, r);
}

// Keccak-f[1600] on the warp's state, lane a of it on this thread: three
// steps of shuffles a round (theta's column, theta's D, rho-pi-chi).
__device__ __forceinline__ uint64_t keccakf_warp(uint64_t a, const Sources& s) {
  const uint64_t rc[24] = {DK_KECCAK_ROUND_CONSTANTS};
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    const uint64_t c = a ^ shfl(a, s.col[0]) ^ shfl(a, s.col[1]) ^ shfl(a, s.col[2]) ^
                       shfl(a, s.col[3]);
    a ^= shfl(c, s.xm1) ^ dk::rotl64(shfl(c, s.xp1), 1);
    const uint64_t rho = rotl_var(a, s.rho);
    a = shfl(rho, s.pi[0]) ^ (~shfl(rho, s.pi[1]) & shfl(rho, s.pi[2]));
    a ^= rc[r] & s.lane0;
  }
  return a;
}

// Lane bytes [off, off + 8) of the padded message m (msg_len bytes, pad10*1
// to padded bytes with the domain byte); 8-byte load when aligned.
__device__ __forceinline__ uint64_t load_lane(const uint8_t* m, int off, int msg_len,
                                              int padded, int domain, bool aligned8) {
  uint64_t lane = 0;
  if (off + 8 <= msg_len && aligned8) {
    lane = __ldg(reinterpret_cast<const unsigned long long*>(m + off));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (off + k < msg_len) lane |= uint64_t(__ldg(m + off + k)) << (8 * k);
    if (off <= msg_len && msg_len - off < 8) lane ^= uint64_t(domain) << (8 * (msg_len - off));
  }
  if (off + 8 == padded) lane ^= uint64_t(0x80) << 56;
  return lane;
}

__global__ void __launch_bounds__(32 * kWarps)
sponge_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int batch,
              int msg_len, int out_bytes, int rate, int domain) {
  const int b = blockIdx.x * kWarps + threadIdx.x / 32;
  if (b >= batch) return;  // the whole warp
  const int t = threadIdx.x % 32;
  const Sources s = sources(t);
  const int rate_w = rate / 8;
  const int nblk = msg_len / rate + 1;  // pad10*1 adds at least one byte
  const int padded = nblk * rate;
  const bool absorbs = t < rate_w;

  const uint8_t* m = in + size_t(b) * msg_len;
  const bool m_aligned = (reinterpret_cast<uintptr_t>(m) & 7) == 0;
  uint64_t a = 0;
  uint64_t next = absorbs ? load_lane(m, 8 * t, msg_len, padded, domain, m_aligned) : 0;
  for (int blk = 0; blk < nblk; ++blk) {
    a ^= next;
    if (absorbs && blk + 1 < nblk)
      next = load_lane(m, (blk + 1) * rate + 8 * t, msg_len, padded, domain, m_aligned);
    a = keccakf_warp(a, s);
  }

  uint8_t* o = out + size_t(b) * out_bytes;
  const bool o_aligned = (reinterpret_cast<uintptr_t>(o) & 7) == 0;
  for (int pos = 0;;) {
    const int off = pos + 8 * t;
    if (absorbs && off < out_bytes) {
      if (off + 8 <= out_bytes && o_aligned) {
        *reinterpret_cast<uint64_t*>(o + off) = a;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (off + k < out_bytes) o[off + k] = uint8_t(a >> (8 * k));
      }
    }
    pos += rate;
    if (pos >= out_bytes) break;
    a = keccakf_warp(a, s);
  }
}

}  // namespace

extern "C" int dk_sponge(const void* in, void* out, int batch, int msg_len,
                         int out_bytes, int rate, int domain, void* stream) {
  if (batch > 0) {
    sponge_kernel<<<(batch + kWarps - 1) / kWarps, 32 * kWarps, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), batch,
        msg_len, out_bytes, rate, domain);
  }
  return int(cudaGetLastError());
}
