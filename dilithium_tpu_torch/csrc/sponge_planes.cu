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
// the low and high halves of rate lane k. Output: uint32 [B, out_words],
// word j = stream bytes 4j..4j+3 little-endian.
//
// Bound on the card: integer operations (the permutations, some 4,300
// 32-bit instructions each, against 4 bytes read or written per word).
// A scheduler's INT32 pipe issues a warp's instruction every two clocks,
// and a message's permutations run in series, so the time is that of the
// busiest of the card's 4 x 132 warp schedulers. Two forms:
//   - the thread form: a thread owns one message's 25 lanes in registers,
//     so a permutation issues no shuffle; word w of a warp's 32 messages
//     is one coalesced 128-byte load (w * B + b);
//   - the pair form: two threads a message, thread h holding bits
//     32h..32h+31 of every lane, 16 messages a warp; a 64-bit rotate is one
//     shuffle for the partner's half and one funnel shift, the same on
//     both threads, so the words need no conversion. It has twice the
//     warps at half the work each, plus 29 shuffles a round.
// The launch takes the form whose busiest scheduler carries less work
// (pair_form_first): at [20480], 640 thread warps leave 112 schedulers
// with two warps and the rest with one, where 1280 pair warps put two or
// three half-size chains on each; at [3840] (120 warps) the pair form
// halves each lone warp's chain; at 16384 messages and up the thread form
// spreads evenly and the shuffles make the pair form the slower one.
// Both forms:
//   - one call site of the permutation, a loop of 6 steps of 4 rounds, for
//     absorb and squeeze alike: a fully unrolled copy for each (~140 KB of
//     code) misses the instruction cache, with nothing to hide it at one
//     or two warps a scheduler;
//   - every squeezed rate block is staged through a per-warp tile of
//     shared memory (each lane's words on distinct banks) and written row
//     by row by consecutive lanes, so a warp store covers whole 128-byte
//     lines of one output row, where the first design's lanes each wrote
//     their own row, out_words * 4 bytes apart (32 sectors a store);
//   - 2 warps a block and no block-wide barrier.
#include <cuda_runtime.h>

#include <cstdint>

#include "device.cuh"
#include "keccak.cuh"

namespace {

constexpr int kMaxRateLanes = 21;  // SHAKE128: 168-byte rate
constexpr int kWarps = 2;          // warps a block
constexpr int kPitch = 2 * kMaxRateLanes + 1;  // words a staged row (odd)

// A warp writes its staged [rows, nw] tile (row pitch `pitch` words) to
// rows of `o`, out_words apart: element q = r * nw + c goes to lane q % 32,
// so consecutive lanes write consecutive words of a row; (r, c) steps by
// 32 elements without a division in the loop.
__device__ __forceinline__ void write_tile(const uint32_t* tile, int pitch, int rows, int nw,
                                           uint32_t* o, int out_words, int lane) {
  int r = lane / nw, c = lane - r * nw;
  const int dr = 32 / nw, dc = 32 - dr * nw;
  while (r < rows) {
    o[size_t(r) * out_words + c] = tile[r * pitch + c];
    r += dr;
    c += dc;
    if (c >= nw) {
      c -= nw;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    sponge_planes_kernel(const uint32_t* __restrict__ planes,
                         uint32_t* __restrict__ out, int batch,
                         int n_in_words, int out_words, int rate_w) {
  __shared__ uint32_t stage[kWarps][32 * kPitch];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * 32;  // the warp's first message
  if (row0 >= batch) return;  // the whole warp; only warp barriers follow
  const int rows = min(32, batch - row0);
  const int b = row0 + lane;
  const bool live = lane < rows;
  uint32_t* tile = stage[warp];

  const int blk_words = 2 * rate_w;
  const int nblk = n_in_words / blk_words;
  const int nsq = (out_words + blk_words - 1) / blk_words;

  uint64_t st[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) st[k] = 0;

  // iteration it absorbs block it (it < nblk) or squeezes block it - nblk;
  // a permutation follows every iteration but the last
  for (int it = 0;; ++it) {
    if (it < nblk) {
      if (live) {
        const uint32_t* p = planes + size_t(it) * blk_words * batch + b;
#pragma unroll
        for (int w = 0; w < kMaxRateLanes; ++w) {
          if (w < rate_w) {
            const uint64_t lo = p[size_t(2 * w) * batch];
            const uint64_t hi = p[size_t(2 * w + 1) * batch];
            st[w] ^= lo | (hi << 32);
          }
        }
      }
    } else {
      const int pos = (it - nblk) * blk_words;  // first output word of the block
      const int nw = min(blk_words, out_words - pos);
#pragma unroll
      for (int w = 0; w < kMaxRateLanes; ++w) {
        if (w < rate_w) {
          tile[lane * kPitch + 2 * w] = uint32_t(st[w]);
          tile[lane * kPitch + 2 * w + 1] = uint32_t(st[w] >> 32);
        }
      }
      __syncwarp();
      write_tile(tile, kPitch, rows, nw, out + size_t(row0) * out_words + pos, out_words, lane);
      if (it + 1 == nblk + nsq) break;
      __syncwarp();  // the tile is read before the next block overwrites it
    }
    dk::keccakf_loop(st);
  }
}

// The same sponge with two threads a message: thread h of a lane pair
// holds half h (bits 32h..32h+31) of each of the 25 lanes, so a warp
// carries 16 messages. A 64-bit rotate is one shuffle for the partner's
// half and one funnel shift, the same on both threads.
__device__ __forceinline__ uint32_t rotl_half(uint32_t mine, uint32_t other, int n) {
  return n < 32 ? __funnelshift_l(other, mine, n) : __funnelshift_l(mine, other, n - 32);
}

__device__ __forceinline__ void keccak_round_half(uint32_t st[25], uint32_t rc) {
  const int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                        27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  const int piln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                        15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
  uint32_t bc[5], ob[5], other[25];
#pragma unroll
  for (int i = 0; i < 5; ++i) bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
#pragma unroll
  for (int i = 0; i < 5; ++i) ob[i] = __shfl_xor_sync(0xffffffffu, bc[i], 1);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const uint32_t t = bc[(i + 4) % 5] ^ rotl_half(bc[(i + 1) % 5], ob[(i + 1) % 5], 1);
#pragma unroll
    for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
  }
#pragma unroll
  for (int k = 1; k < 25; ++k) other[k] = __shfl_xor_sync(0xffffffffu, st[k], 1);
  uint32_t t = st[1], to = other[1];
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int j = piln[i];
    const uint32_t tmp = st[j], tmpo = other[j];
    st[j] = rotl_half(t, to, rotc[i]);
    t = tmp;
    to = tmpo;
  }
#pragma unroll
  for (int j = 0; j < 25; j += 5) {
#pragma unroll
    for (int i = 0; i < 5; ++i) bc[i] = st[j + i];
#pragma unroll
    for (int i = 0; i < 5; ++i) st[j + i] ^= (~bc[(i + 1) % 5]) & bc[(i + 2) % 5];
  }
  st[0] ^= rc;
}

constexpr int kPairPitch = 2 * kMaxRateLanes + 4;  // 46 = 2 x odd: lane 2m + h on bank 46m + h

__global__ void __launch_bounds__(kWarps * 32)
    sponge_planes_pair_kernel(const uint32_t* __restrict__ planes,
                              uint32_t* __restrict__ out, int batch,
                              int n_in_words, int out_words, int rate_w) {
  __shared__ uint32_t stage[kWarps][16 * kPairPitch];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = lane & 1;
  const int row0 = (blockIdx.x * kWarps + warp) * 16;  // the warp's first message
  if (row0 >= batch) return;  // the whole warp; only warp barriers and shuffles follow
  const int rows = min(16, batch - row0);
  const int m = lane >> 1;  // the lane's message in the warp
  const bool live = m < rows;
  uint32_t* tile = stage[warp];

  const int blk_words = 2 * rate_w;
  const int nblk = n_in_words / blk_words;
  const int nsq = (out_words + blk_words - 1) / blk_words;

  uint32_t st[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) st[k] = 0;

  for (int it = 0;; ++it) {
    if (it < nblk) {
      if (live) {
        const uint32_t* p = planes + (size_t(it) * blk_words + h) * batch + row0 + m;
#pragma unroll
        for (int w = 0; w < kMaxRateLanes; ++w) {
          if (w < rate_w) st[w] ^= p[size_t(2 * w) * batch];
        }
      }
    } else {
      const int pos = (it - nblk) * blk_words;
      const int nw = min(blk_words, out_words - pos);
#pragma unroll
      for (int w = 0; w < kMaxRateLanes; ++w) {
        if (w < rate_w) tile[m * kPairPitch + 2 * w + h] = st[w];
      }
      __syncwarp();
      write_tile(tile, kPairPitch, rows, nw, out + size_t(row0) * out_words + pos, out_words, lane);
      if (it + 1 == nblk + nsq) break;
      __syncwarp();
    }
#pragma unroll 1
    for (int r = 0; r < 24; r += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint64_t rc = dk::kRoundConstants[r + u];
        keccak_round_half(st, h ? uint32_t(rc >> 32) : uint32_t(rc));
      }
    }
  }
}

}  // namespace

// True where the pair form should finish first: its warps carry half a
// message's work and ~10% more for the shuffles, and a scheduler's load is
// the warps it carries, so the pair form wins where the thread form leaves
// schedulers unevenly loaded ([20480] is 640 warps for 528 schedulers, 1280
// pair warps) or idle, and loses where both spread evenly ([16384]: 512).
static bool pair_form_first(int batch) {
  const long sched = 4L * dk::sm_count();  // warp schedulers on the card
  const long thread_warps = (batch + 31L) / 32, pair_warps = (batch + 15L) / 16;
  return ((pair_warps + sched - 1) / sched) * 11 < ((thread_warps + sched - 1) / sched) * 20;
}

// The form dk_sponge_planes launches at this batch on the current device:
// 1 for the pair form, 0 for the thread form.
extern "C" int dk_sponge_planes_form(int batch) { return batch > 0 && pair_form_first(batch); }

extern "C" int dk_sponge_planes(const void* planes, void* out, int batch,
                                int n_in_words, int out_words, int rate_w,
                                void* stream) {
  if (batch > 0 && out_words > 0 && pair_form_first(batch)) {
    const int per_block = kWarps * 16;
    const int blocks = (batch + per_block - 1) / per_block;
    sponge_planes_pair_kernel<<<blocks, kWarps * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(planes), static_cast<uint32_t*>(out),
        batch, n_in_words, out_words, rate_w);
  } else if (batch > 0 && out_words > 0) {
    const int per_block = kWarps * 32;
    const int blocks = (batch + per_block - 1) / per_block;
    sponge_planes_kernel<<<blocks, per_block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(planes), static_cast<uint32_t*>(out),
        batch, n_in_words, out_words, rate_w);
  }
  return int(cudaGetLastError());
}
