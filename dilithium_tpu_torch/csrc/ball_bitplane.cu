// K7: SampleInBall with the challenge polynomial held as two 256-bit
// planes (nonzero, sign); one thread per message for the walk, one warp
// per row for the output.
//
// Replaces tools/ball_exp.py::_call with _kernel_v1 (line 102): the "V1"
// side of the TPU A/B rig for SampleInBall, K3's function in another
// representation of c. Same contract as K3 (csrc/ball.cu): stream bytes
// 0..7 are 64 sign bits, each later byte j is taken for Fisher-Yates step
// i = 256 - tau + cnt iff j <= i; on a take c[i] = c[j], then c[j] = +-1
// by sign bit cnt (in that order, so j == i resolves to +-1); steps the
// stream did not fill use j = 0 and report ok = 0. Output int32 [B, 256]
// canonical in {0, 1, q - 1} and ok one byte (0 or 1) per row, written
// straight into the caller's bool tensor.
//
// Representation: coefficient r is bit r & 31 of word r >> 5 of nz (set
// when c[r] != 0) and of sg (set when c[r] = -1), the eight (nz, sg) word
// pairs of a message side by side in shared memory, indexed by j >> 5,
// where the first design picked one of four 64-bit registers by a select
// chain (~30 integer operations a take). c[i] is 0 before step i (earlier
// steps wrote only positions below i), so the copy c[i] = c[j] is an OR,
// and sg is set only where nz is, so c[j] = +-1 flips sg by a known XOR.
//
// Bound on the card: bytes (the 1 KB int32 row written per message
// dominates the stream bytes a walk reads, about 62 of 272 at level 3,
// and the walk's few hundred integer steps). A thread's walk is a chain of dependent steps, so the kernel
// runs as its phases in series: stage, scan, swaps, then the writes. Design:
//   - a block of 64 messages (2 warps) stages kWindow bytes of each of its
//     rows at a time in shared memory, with coalesced 16-byte loads (4-byte
//     or 1-byte loads where the rows are not so aligned), at a pitch of an
//     odd number of 16-byte units, so that a warp's 16-byte reads at one
//     offset of 32 rows fall on distinct banks in each quarter-warp. A walk
//     at tau <= 60 almost always ends in the first window; the block stages
//     the next window of every row only while one of its rows still walks,
//     so a long walk (a no-take row) costs its block one more round of
//     coalesced loads, not a chain of byte loads from device memory;
//   - the scan: each thread reads its window 16 bytes at a time and
//     stores every byte to slot cnt of its own 80-byte record, taken or
//     not, so a byte's step is a store, a compare and an add with no
//     branch; a chunk with no byte at or below the limit (a no-take row's
//     255s) is passed in one step. (Written as a lambda with a guarded
//     store, the same scan compiled to a branch a byte and a recomputed
//     shared-memory address a take, and made the stress rows' block the
//     kernel's slowest by far.)
//   - the tau swaps then run on the planes, the same number of steps on
//     every lane of the warp: a step needs only c[j]'s two bits, read from
//     the word pair loaded one step ahead and corrected by the previous
//     step's writes (j equal to its j or its i), and issues its four bit
//     updates as shared-memory atomics that nothing waits on, where a
//     read, modify and write of the words in turn (a load, a store, the
//     next load) put a memory round trip on every step;
//   - the output: each warp writes its 32 rows one at a time, lane l
//     coefficients 4l..4l+3 and 128+4l..128+4l+3 as two int4 stores, so
//     each store instruction writes 512 contiguous bytes, where the
//     first design's lanes each wrote their own row (32 rows a store).
// What is left: the writes start only when the walks end. Loading the
// next step's whole words and forwarding them through selects, in place
// of its two bits, made the chain longer on the card, not shorter.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 8380417;
constexpr int kWarps = 2;                // warps a block
constexpr int kThreads = kWarps * 32;    // messages a block
constexpr int kWindow = 144;  // stream bytes staged a row at a time: 272 in two
constexpr int kRowPitch = kWindow;  // 9 x 16 bytes: an odd count of 16-byte units
constexpr int kStepPitch = 80;           // bytes of recorded j a message (64 + 16 pad)
constexpr int kPairPitch = 9;            // uint2 a message's planes (8 + 1 pad)

__device__ __forceinline__ uint32_t byte_of(uint4 v, int k) {
  const uint32_t w = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
  return (w >> (8 * (k & 3))) & 255u;
}

// Coefficients sh..sh+3 of a (nz, sg) word pair as int32 {0, 1, q - 1}.
// sg is set only where nz is, so nz ^ sg marks the +1 coefficients.
__device__ __forceinline__ int4 coefs4(uint2 p, int sh) {
  const uint32_t s = (p.y >> sh) & 15u, one = ((p.x >> sh) & 15u) ^ s;
  return make_int4(int((one & 1u) + (s & 1u) * (kQ - 1)), int(((one >> 1) & 1u) + ((s >> 1) & 1u) * (kQ - 1)),
                   int(((one >> 2) & 1u) + ((s >> 2) & 1u) * (kQ - 1)), int((one >> 3) + (s >> 3) * (kQ - 1)));
}

__global__ void __launch_bounds__(kThreads)
    ball_bitplane_kernel(const uint8_t* __restrict__ stream,
                         int32_t* __restrict__ c_out,
                         uint8_t* __restrict__ ok_out, int batch, int tau,
                         int nbytes, int vec) {
  __shared__ __align__(16) uint8_t win[kThreads * kRowPitch];
  __shared__ __align__(16) uint8_t steps[kThreads * kStepPitch];
  __shared__ uint2 planes[kThreads * kPairPitch];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kThreads;
  const int b = row0 + tid;
  const bool live = b < batch;
  const uint8_t* sj = steps + tid * kStepPitch;
  uint2* pl = planes + tid * kPairPitch;
#pragma unroll
  for (int k = 0; k < 8; ++k) pl[k] = make_uint2(0, 0);

  // the scan, one window of every row at a time. Byte j is taken iff
  // j - base <= cnt. Every byte is stored to slot cnt of the thread's
  // steps, taken or not (the next byte overwrites a rejected one), so a
  // byte costs a store, a compare and an add, without a branch. tau is
  // checked once a 16-byte chunk; takes past it land in the slot's slack
  // and the clamp after the chunk drops them.
  const int base = 256 - tau;
  const int slot = tid * kStepPitch;
  int cnt = 0;
  uint64_t signs = 0;
  for (int w0 = 0;; w0 += kWindow) {
    const int wlen = min(kWindow, nbytes - w0);  // a multiple of vec
    const int units = wlen / vec;
    for (int q = tid; q < kThreads * units; q += kThreads) {
      const int r = q / units, u = q - r * units;
      if (row0 + r < batch) {
        const uint8_t* src = stream + size_t(row0 + r) * nbytes + w0 + u * vec;
        uint8_t* dst = win + r * kRowPitch + u * vec;
        if (vec == 16) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else if (vec == 4) {
          *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
        } else {
          *dst = *src;
        }
      }
    }
    __syncthreads();
    if (live && cnt < tau) {
      const uint8_t* row = win + tid * kRowPitch;
      const int n16 = wlen / 16;
      int ch = 0, first = 0;
      if (w0 == 0) {  // bytes 0..7 are the signs
        const uint2 sb = *reinterpret_cast<const uint2*>(row);
        signs = uint64_t(sb.x) | (uint64_t(sb.y) << 32);
        first = 8;
        if (n16 > 0) {
          const uint4 v = *reinterpret_cast<const uint4*>(row);
#pragma unroll
          for (int k = 8; k < 16; ++k) {
            const int j = int(byte_of(v, k));
            steps[slot + cnt] = uint8_t(j);
            cnt += j - base <= cnt;
          }
          ch = 1;
        }
      }
      for (; ch < n16 && cnt < tau; ++ch) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * ch);
        // no byte above the limit base + cnt is taken, and without a take
        // the limit stays: a chunk of such bytes is passed in one step
        const uint32_t lim = 0x01010101u * uint32_t(min(base + cnt, 255));
        if ((__vcmpgtu4(v.x, lim) & __vcmpgtu4(v.y, lim) & __vcmpgtu4(v.z, lim) & __vcmpgtu4(v.w, lim)) == ~0u) continue;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int j = int(byte_of(v, k));
          steps[slot + cnt] = uint8_t(j);
          cnt += j - base <= cnt;
        }
        cnt = min(cnt, tau);
      }
      cnt = min(cnt, tau);
      for (int k = max(16 * n16, first); k < wlen && cnt < tau; ++k) {
        const int j = row[k];
        steps[slot + cnt] = uint8_t(j);
        cnt += j - base <= cnt;
      }
    }
    // the next window only while a row of the block still needs one; the
    // barrier also keeps this window until every row has read it
    if (!__syncthreads_or(live && cnt < tau && w0 + wlen < nbytes)) break;
  }

  if (live) {
    ok_out[b] = cnt >= tau ? 1 : 0;
    // the swaps, 16 recorded j a read; steps past cnt use j = 0. A step
    // needs two bits of c[j]: nonzero and sign. The word pair holding them
    // is loaded one step ahead, before the previous step's updates are
    // issued, and that step's effect on the two bits is forwarded; the
    // updates are shared-memory atomics nothing waits on, so no memory
    // round trip lies on the chain from step to step.
    uint32_t* words = reinterpret_cast<uint32_t*>(pl);  // nz of word k at 2k, sg at 2k + 1
    int j = cnt > 0 ? sj[0] : 0;
    uint2 cur = pl[j >> 5];
    int pj = -1, pi = -1;               // the previous step's j and i
    uint32_t pnz = 0, psg = 0, ps = 0;  // its c[j] bits before it, and its sign
    for (int t0 = 0; t0 < tau; t0 += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(sj + t0);
      const uint4 vn = *reinterpret_cast<const uint4*>(sj + t0 + 16);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int t = t0 + k;
        if (t < tau) {
          const int i = base + t, bj = j & 31, bi = i & 31;
          const uint32_t s = uint32_t(signs >> t) & 1u;
          const bool at_pj = j == pj, at_pi = j == pi && pnz;  // c[j] last written there
          const uint32_t nz = at_pj || at_pi ? 1u : (cur.x >> bj) & 1u;
          const uint32_t sg = at_pj ? ps : at_pi ? psg : (cur.y >> bj) & 1u;
          const int jn = t + 1 < cnt ? int(k < 15 ? byte_of(v, k + 1) : byte_of(vn, 0)) : 0;
          cur = pl[jn >> 5];
          // c[i] = c[j] (c[i] is 0), then c[j] = +-1 (sg is set only where nz is)
          atomicOr(words + 2 * (i >> 5), nz << bi);
          atomicOr(words + 2 * (i >> 5) + 1, (nz & sg) << bi);
          atomicOr(words + 2 * (j >> 5), 1u << bj);
          atomicXor(words + 2 * (j >> 5) + 1, (sg ^ s) << bj);
          pj = j;
          pi = i;
          pnz = nz;
          psg = sg;
          ps = s;
          j = jn;
        }
      }
    }
  }
  __syncwarp();

  // the output: the warp's rows one at a time, 512 contiguous bytes a store
  const int wrow = tid & ~31;  // the warp's first message in the block
  const int nrows = min(32, batch - row0 - wrow);
  const int sh = 4 * (lane & 7);
#pragma unroll 4
  for (int r = 0; r < nrows; ++r) {
    const uint2* p = planes + (wrow + r) * kPairPitch;
    int4* o = reinterpret_cast<int4*>(c_out + size_t(row0 + wrow + r) * 256);
    o[lane] = coefs4(p[lane >> 3], sh);
    o[32 + lane] = coefs4(p[4 + (lane >> 3)], sh);
  }
}

}  // namespace

extern "C" int dk_ball_bitplane(const void* stream_bytes, void* c, void* ok,
                                int batch, int tau, int nbytes, void* stream) {
  if (batch > 0) {
    // the widest load that every staged row allows
    const uintptr_t addr = reinterpret_cast<uintptr_t>(stream_bytes);
    const int vec = (addr % 16 == 0 && nbytes % 16 == 0) ? 16
                    : (addr % 4 == 0 && nbytes % 4 == 0) ? 4
                                                          : 1;
    const int blocks = (batch + kThreads - 1) / kThreads;
    ball_bitplane_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(stream_bytes), static_cast<int32_t*>(c),
        static_cast<uint8_t*>(ok), batch, tau, nbytes, vec);
  }
  return int(cudaGetLastError());
}
