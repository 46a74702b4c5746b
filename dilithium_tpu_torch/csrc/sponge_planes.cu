// K6: SHAKE absorb + squeeze over pre-padded word planes, writing the
// squeezed words batch-major; one thread per column (message).
//
// Replaces tools/xof_exp.py::shake_words_batchmajor (_xof_kernel_bm, line
// 68): K1's sponge in the TPU A/B rig's "B" form, which reads the padded
// message as 32-bit word planes and writes [B, out_words] rows.
//
// Input: uint32 planes [n_in_words, B], pad10*1 already applied (by
// planes_for in dilithium_tpu_torch/tools/xof_exp.py); words 2k and
// 2k + 1 of absorb block blk are planes blk * 2 * rate_w + 2k and 2k + 1,
// the low and high halves of rate lane k. Output: uint32 [B, out_words], word j =
// stream bytes 4j..4j+3 little-endian.
//
// Bound on the card: integer operations (the permutations, some 4,300
// 32-bit instructions each, against 4 bytes read or written per word).
// Design: one thread owns its 25-lane state in registers (dk::keccakf);
// absorb reads word w of column b at w * B + b, so a warp's loads are
// coalesced across messages (K1 gives each message a warp and reads its
// row's lanes side by side instead); the
// rate loops are unrolled to the largest rate with a runtime guard so every
// state index is constant. The batch-major squeeze stores are strided
// across a warp (out_words * 4 bytes apart); staging them through shared
// memory is left to a later change.
#include <cuda_runtime.h>

#include <cstdint>

#include "keccak.cuh"

namespace {

constexpr int kMaxRateLanes = 21;  // SHAKE128: 168-byte rate

__global__ void sponge_planes_kernel(const uint32_t* __restrict__ planes,
                                     uint32_t* __restrict__ out, int batch,
                                     int n_in_words, int out_words,
                                     int rate_w) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int nblk = n_in_words / (2 * rate_w);
  uint32_t* o = out + size_t(b) * out_words;

  uint64_t st[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) st[k] = 0;

  for (int blk = 0; blk < nblk; ++blk) {
    const uint32_t* p = planes + size_t(blk) * 2 * rate_w * batch + b;
#pragma unroll
    for (int w = 0; w < kMaxRateLanes; ++w) {
      if (w < rate_w) {
        const uint64_t lo = p[size_t(2 * w) * batch];
        const uint64_t hi = p[size_t(2 * w + 1) * batch];
        st[w] ^= lo | (hi << 32);
      }
    }
    dk::keccakf(st);
  }

  int pos = 0;
  while (true) {
#pragma unroll
    for (int w = 0; w < kMaxRateLanes; ++w) {
      if (w < rate_w) {
        if (pos < out_words) o[pos] = uint32_t(st[w]);
        if (pos + 1 < out_words) o[pos + 1] = uint32_t(st[w] >> 32);
        pos += 2;
      }
    }
    if (pos >= out_words) break;
    dk::keccakf(st);
  }
}

}  // namespace

extern "C" int dk_sponge_planes(const void* planes, void* out, int batch,
                                int n_in_words, int out_words, int rate_w,
                                void* stream) {
  if (batch > 0) {
    const int threads = 128;
    const int blocks = (batch + threads - 1) / threads;
    sponge_planes_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(planes), static_cast<uint32_t*>(out),
        batch, n_in_words, out_words, rate_w);
  }
  return int(cudaGetLastError());
}
