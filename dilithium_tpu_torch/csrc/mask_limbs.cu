// K2: fused ExpandMask -> int8 limbs, one thread per (message b, poly l).
//
// Replaces dilithium_tpu/ops/keccak_pallas.py::mask_limbs_folded
// (_xof_mask_limb_kernel), reached from sampling.expand_mask_limbs in
// every round of the one-key signer.
//
// Each thread builds rhoprime[b] || le16(kappa[b] + l) (66 bytes, one
// SHAKE256 block), squeezes 5 blocks, slices gamma1_bits-bit values r,
// centres y = gamma1 - r and splits y into balanced base-256 digits
// y = d0 + 256*d1 + 65536*d2, d in [-128, 127]. It writes
// out[d, b, l*256 + j] (int8 [3, W, L*256], row-major): the left operand
// of the y -> w int8 GEMMs, so y never exists in device memory as words
// or as int32.
//
// Bound on the card: the 6 Keccak permutations per thread (integer ALU)
// and, after them, 768 single-byte stores per thread 256 bytes apart
// (uncoalesced). Design: the state stays in registers; the squeezed
// stream (85 lanes) goes to thread-local memory, which the L1 serves.
// Staging a block's limbs in shared memory for coalesced stores is the
// obvious later step.
#include <cuda_runtime.h>

#include <cstdint>

#include "keccak.cuh"

namespace {

constexpr int kRateLanes = 17;  // SHAKE256: 136-byte rate
constexpr int kOutBlocks = 5;   // ceil(640 / 136): covers 18- and 20-bit y

__global__ void mask_limbs_kernel(const uint8_t* __restrict__ rhoprime,
                                  const int32_t* __restrict__ kappa,
                                  int8_t* __restrict__ out, int W, int L,
                                  int gamma1_bits, int gamma1) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= W * L) return;
  const int b = idx / L;
  const int l = idx % L;

  uint64_t st[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) st[k] = 0;
  const uint8_t* rp = rhoprime + size_t(b) * 64;
#pragma unroll
  for (int w = 0; w < 8; ++w) st[w] = dk::load_le64(rp + 8 * w);
  const uint32_t nonce = uint32_t(kappa[b] + l) & 0xFFFFu;
  st[8] = uint64_t(nonce) | (uint64_t(0x1F) << 16);  // bytes 64..66
  st[16] = uint64_t(0x80) << 56;                      // byte 135
  dk::keccakf(st);

  uint64_t buf[kOutBlocks * kRateLanes];
  for (int blk = 0; blk < kOutBlocks; ++blk) {
#pragma unroll
    for (int w = 0; w < kRateLanes; ++w) buf[blk * kRateLanes + w] = st[w];
    if (blk + 1 < kOutBlocks) dk::keccakf(st);
  }

  const uint64_t mask = (uint64_t(1) << gamma1_bits) - 1;
  const size_t plane = size_t(W) * L * 256;
  int8_t* o = out + size_t(b) * L * 256 + size_t(l) * 256;
  for (int j = 0; j < 256; ++j) {
    const int bit = gamma1_bits * j;
    const int w = bit >> 6;
    const int sh = bit & 63;
    uint64_t r = buf[w] >> sh;
    if (sh + gamma1_bits > 64) r |= buf[w + 1] << (64 - sh);
    const int32_t y = gamma1 - int32_t(r & mask);
    const int32_t d0 = ((y + 128) & 255) - 128;
    const int32_t y1 = (y - d0) >> 8;
    const int32_t d1 = ((y1 + 128) & 255) - 128;
    const int32_t d2 = (y1 - d1) >> 8;
    o[j] = int8_t(d0);
    o[plane + j] = int8_t(d1);
    o[2 * plane + j] = int8_t(d2);
  }
}

}  // namespace

extern "C" int dk_mask_limbs(const void* rhoprime, const void* kappa,
                             void* out, int W, int L, int gamma1_bits,
                             int gamma1, void* stream) {
  if (W > 0) {
    const int threads = 128;
    const int blocks = (W * L + threads - 1) / threads;
    mask_limbs_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rhoprime),
        static_cast<const int32_t*>(kappa), static_cast<int8_t*>(out), W, L,
        gamma1_bits, gamma1);
  }
  return int(cudaGetLastError());
}
