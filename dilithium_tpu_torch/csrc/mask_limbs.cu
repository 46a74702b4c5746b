// K2: fused ExpandMask -> int8 limbs, one thread per (message b, poly l)
// for the permutations, one warp per poly for the unpack.
//
// Replaces dilithium_tpu/ops/keccak_pallas.py::mask_limbs_folded
// (_xof_mask_limb_kernel), reached from sampling.expand_mask_limbs in
// every round of the one-key signer.
//
// Each state absorbs rhoprime[b] || le16(kappa[b] + l) (66 bytes, one
// SHAKE256 block) and squeezes 5 blocks; the gamma1_bits-bit values r of
// the stream are centred, y = gamma1 - r, and split into balanced base-256
// digits y = d0 + 256*d1 + 65536*d2, d in [-128, 127]. The kernel writes
// out[d, b, l*256 + j] (int8 [3, W, L*256], row-major): the left operand
// of the y -> w int8 GEMMs, so y never exists in device memory as words
// or as int32.
//
// Bound on the card: the 5 Keccak permutations a state in series (integer
// ALU; W x L = 3840 states at the signer's W = 768, L = 5). The first
// design added 768 single-byte stores a thread, 256 bytes apart between
// neighbouring threads, and kept the squeezed stream in an 85-word stack
// array indexed at run time (local memory), on 30 blocks of 128 threads:
// 168.2 us on an H100 80GB HBM3 at 700 W (tools/kernel_ab.py).
//
// Design. The permutation stays one thread per state: 3840 states are
// enough warps to spread over the card once blocks are small, and one
// lane of the state per thread would trade the chain of 5 permutations
// for ~432 warp shuffles each, which the SM issues one a clock. A block
// takes 32 states, so W = 768, L = 5 is 120 blocks on 120 SMs; its first
// warp runs their permutations and writes each state's 85 squeezed words
// to its row in shared memory (85 is odd, so a warp's 64-bit writes at one
// offset hit distinct banks). Then the block's 4 warps, one on each of the
// SM's 4 schedulers, unpack the 32 polys, each warp one poly at a time:
// lane i takes coefficients 8i..8i+7, i.e. gamma1_bits bytes of the row
// (three 64-bit words), splits each into its three digits, packs each
// digit's eight int8 into one 64-bit word and stores it, so a warp writes
// 256 contiguous bytes of each plane a poly. gamma1_bits (18 or 20) is a
// template parameter, so every bit position in the unpack is a constant.
//
// The permutation runs as a loop of 4 rounds a step (dk::keccakf_loop). Fully unrolled, each inlined permutation is ~4,300
// instructions of straight-line code, far more than the SM's instruction
// cache holds: on the same card the kernel took 43.7 us alone and 63.7 us
// a round in the signing path (tools/round_profile.py), where the other
// kernels of the round evict its code from L2; looped, 28.6 us alone and
// 28.6 us a round. What is left is the permutation chain itself: five
// permutations on a lone warp.
#include <cuda_runtime.h>

#include <cstdint>

#include "keccak.cuh"

namespace {

constexpr int kStates = 32;     // states a block: its first warp permutes them
constexpr int kWarps = 4;       // warps a block: all four unpack
constexpr int kRateLanes = 17;  // SHAKE256: 136-byte rate
constexpr int kOutBlocks = 5;   // ceil(640 / 136): covers 18- and 20-bit y
constexpr int kRowWords = kOutBlocks * kRateLanes;  // 85, odd

template <int kBits>
__global__ void __launch_bounds__(32 * kWarps)
mask_limbs_kernel(const uint8_t* __restrict__ rhoprime, const int32_t* __restrict__ kappa,
                  int8_t* __restrict__ out, int W, int L, int gamma1) {
  __shared__ uint64_t rows[kStates * kRowWords];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first = blockIdx.x * kStates;  // the block's first state
  const int states = W * L;

  if (warp == 0 && first + lane < states) {
    const int b = (first + lane) / L;
    const int l = (first + lane) % L;
    uint64_t st[25];
#pragma unroll
    for (int k = 0; k < 25; ++k) st[k] = 0;
    const uint8_t* rp = rhoprime + size_t(b) * 64;
#pragma unroll
    for (int w = 0; w < 8; ++w) st[w] = dk::load_le64(rp + 8 * w);
    const uint32_t nonce = uint32_t(kappa[b] + l) & 0xFFFFu;
    st[8] = uint64_t(nonce) | (uint64_t(0x1F) << 16);  // bytes 64..66
    st[16] = uint64_t(0x80) << 56;                      // byte 135
    dk::keccakf_loop(st);
    uint64_t* row = rows + lane * kRowWords;
#pragma unroll 1
    for (int blk = 0; blk < kOutBlocks; ++blk) {
#pragma unroll
      for (int w = 0; w < kRateLanes; ++w) row[blk * kRateLanes + w] = st[w];
      if (blk + 1 < kOutBlocks) dk::keccakf_loop(st);
    }
  }
  __syncthreads();

  // Lane i's 8 coefficients are bits [8 kBits i, 8 kBits (i + 1)) of the
  // stream: kBits bytes from byte kBits * i, inside three 64-bit words.
  const int w0 = (kBits * lane) >> 3;
  const int sh = 8 * ((kBits * lane) & 7);
  const uint64_t mask = (uint64_t(1) << kBits) - 1;
  const size_t plane = size_t(states) * 256;
  for (int s = warp; s < kStates && first + s < states; s += kWarps) {
    const uint64_t* row = rows + s * kRowWords;
    uint64_t x[3] = {row[w0], row[w0 + 1], row[w0 + 2]};
    if (sh) {
      x[0] = (x[0] >> sh) | (x[1] << (64 - sh));
      x[1] = (x[1] >> sh) | (x[2] << (64 - sh));
      x[2] >>= sh;
    }
    uint64_t limb[3] = {0, 0, 0};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int bit = kBits * k, w = bit >> 6, bsh = bit & 63;
      uint64_t r = x[w] >> bsh;
      if (bsh + kBits > 64) r |= x[w + 1 < 3 ? w + 1 : 2] << (64 - bsh);
      const int32_t y = gamma1 - int32_t(r & mask);
      const int32_t d0 = ((y + 128) & 255) - 128;
      const int32_t y1 = (y - d0) >> 8;
      const int32_t d1 = ((y1 + 128) & 255) - 128;
      const int32_t d2 = (y1 - d1) >> 8;
      limb[0] |= uint64_t(uint8_t(d0)) << (8 * k);
      limb[1] |= uint64_t(uint8_t(d1)) << (8 * k);
      limb[2] |= uint64_t(uint8_t(d2)) << (8 * k);
    }
    // state first + s is (b, l) with b * L + l = first + s: its row of
    // each plane starts at byte (first + s) * 256
    uint64_t* o = reinterpret_cast<uint64_t*>(out + size_t(first + s) * 256) + lane;
    o[0] = limb[0];
    o[plane / 8] = limb[1];
    o[plane / 4] = limb[2];
  }
}

}  // namespace

extern "C" int dk_mask_limbs(const void* rhoprime, const void* kappa,
                             void* out, int W, int L, int gamma1_bits,
                             int gamma1, void* stream) {
  if (W > 0) {
    const int blocks = (W * L + kStates - 1) / kStates;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint8_t* rp = static_cast<const uint8_t*>(rhoprime);
    const int32_t* kp = static_cast<const int32_t*>(kappa);
    int8_t* o = static_cast<int8_t*>(out);
    if (gamma1_bits == 18)
      mask_limbs_kernel<18><<<blocks, 32 * kWarps, 0, s>>>(rp, kp, o, W, L, gamma1);
    else if (gamma1_bits == 20)
      mask_limbs_kernel<20><<<blocks, 32 * kWarps, 0, s>>>(rp, kp, o, W, L, gamma1);
    else
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
