// K1: batched Keccak sponge (SHAKE128/256, SHA3-256/512), one thread per
// message.
//
// Replaces dilithium_tpu/ops/keccak_pallas.py::shake_words_folded
// (_xof_kernel): every SHAKE/SHA3 on the one-key signing path runs here
// (keygen's seed expansion, ExpandA, ExpandS and tr; rhoprime; c_tilde;
// the SampleInBall stream). The standalone permutation f1600_folded is
// K5 (permute.cu).
//
// Bound on the card: integer ALU work of the permutation at large batch
// (~3k 64-bit ops per permutation), and launch latency at the signer's
// batch (W = 768 messages is 6 blocks of 128 threads, a few percent of
// the 132 SMs). Design: the 25-lane state lives in registers for the
// whole absorb/squeeze (the rate loops are unrolled to the largest rate,
// 21 lanes, with a runtime guard, so every state index is a constant);
// pad10*1 is applied on the fly while reading the raw message, so the
// wrapper passes the messages as they are, batch-major [B, msg_len], and
// gets batch-major bytes [B, out_bytes] back. Byte-wise global loads and
// stores are uncoalesced; staging a block's messages through shared
// memory is the obvious later step.
#include <cuda_runtime.h>

#include <cstdint>

#include "keccak.cuh"

namespace {

constexpr int kMaxRateLanes = 21;  // SHAKE128: 168-byte rate

__global__ void sponge_kernel(const uint8_t* __restrict__ in,
                              uint8_t* __restrict__ out, int batch,
                              int msg_len, int out_bytes, int rate,
                              int domain) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uint8_t* m = in + size_t(b) * msg_len;
  uint8_t* o = out + size_t(b) * out_bytes;
  const int rate_w = rate / 8;
  const int nblk = msg_len / rate + 1;  // pad10*1 adds at least one byte
  const int padded = nblk * rate;

  uint64_t st[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) st[k] = 0;

  for (int blk = 0; blk < nblk; ++blk) {
    const int base = blk * rate;
#pragma unroll
    for (int w = 0; w < kMaxRateLanes; ++w) {
      if (w < rate_w) {
        const int off = base + 8 * w;
        uint64_t lane = 0;
        if (off + 8 <= msg_len) {
          lane = dk::load_le64(m + off);
        } else {
          for (int k = 0; k < 8; ++k) {
            const int i = off + k;
            uint32_t v = i < msg_len ? m[i] : 0u;
            if (i == msg_len) v ^= uint32_t(domain);
            if (i == padded - 1) v ^= 0x80u;
            lane |= uint64_t(v) << (8 * k);
          }
        }
        st[w] ^= lane;
      }
    }
    dk::keccakf(st);
  }

  int pos = 0;
  while (true) {
#pragma unroll
    for (int w = 0; w < kMaxRateLanes; ++w) {
      if (w < rate_w) {
        const uint64_t lane = st[w];
        for (int k = 0; k < 8; ++k) {
          if (pos + k < out_bytes) o[pos + k] = uint8_t(lane >> (8 * k));
        }
        pos += 8;
      }
    }
    if (pos >= out_bytes) break;
    dk::keccakf(st);
  }
}

}  // namespace

extern "C" int dk_sponge(const void* in, void* out, int batch, int msg_len,
                         int out_bytes, int rate, int domain, void* stream) {
  if (batch > 0) {
    const int threads = 128;
    const int blocks = (batch + threads - 1) / threads;
    sponge_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), batch,
        msg_len, out_bytes, rate, domain);
  }
  return int(cudaGetLastError());
}
