// K7: SampleInBall with the challenge polynomial held as two 256-bit
// planes (nonzero, sign); one thread per message.
//
// Replaces tools/ball_exp.py::_call with _kernel_v1 (line 102): the "V1"
// side of the TPU A/B rig for SampleInBall, K3's function in another
// representation of c. Same contract as K3 (csrc/ball.cu): stream bytes
// 0..7 are 64 sign bits, each later byte j is taken for Fisher-Yates step
// i = 256 - tau + cnt iff j <= i; on a take c[i] = c[j], then c[j] = +-1
// by sign bit cnt (in that order, so j == i resolves to +-1); steps the
// stream did not fill use j = 0 and report ok = 0. Output int32 [B, 256]
// canonical in {0, 1, q - 1}, ok uint8 [B].
//
// Representation: coefficient r is bit r & 63 of word r >> 6 of nz (set
// when c[r] != 0) and of sg (set when c[r] = -1). The TPU kernel kept
// eight 32-bit rows; an array indexed by the runtime j >> 5 would go to
// local memory here, so each plane is four uint64_t registers and a read
// or write at j is a select chain over the four (the third option, a
// 64-byte slice of shared memory per thread, costs a shared-memory round
// trip on every step of the serial walk). Because tau <= 64, every
// i = 256 - tau + cnt lies in [192, 255], so the c[i] write always lands
// in word 3 at bit i - 192 and needs no select.
//
// Bound on the card: bytes (the 1 KB int32 row written per message
// dominates the ~270-byte stream read and the few hundred integer steps of
// the walk). The walk is serial per thread and its byte loads are
// uncoalesced; the output is written as 16-byte vectors.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 8380417;

__device__ __forceinline__ uint64_t pick(const uint64_t w[4], int k) {
  uint64_t v = w[0];
  v = k == 1 ? w[1] : v;
  v = k == 2 ? w[2] : v;
  v = k == 3 ? w[3] : v;
  return v;
}

// Fisher-Yates step: c[i] = c[j] (i in [192, 255]), then c[j] = +-1.
__device__ __forceinline__ void place(uint64_t nz[4], uint64_t sg[4], int i,
                                      int j, uint64_t neg) {
  const int wj = j >> 6;
  const int bj = j & 63;
  const int bi = i - 192;
  const uint64_t nzj = (pick(nz, wj) >> bj) & 1ull;
  const uint64_t sgj = (pick(sg, wj) >> bj) & 1ull;
  nz[3] = (nz[3] & ~(1ull << bi)) | (nzj << bi);
  sg[3] = (sg[3] & ~(1ull << bi)) | (sgj << bi);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t m = k == wj ? (1ull << bj) : 0ull;
    nz[k] |= m;
    sg[k] = (sg[k] & ~m) | (neg ? m : 0ull);
  }
}

__global__ void ball_bitplane_kernel(const uint8_t* __restrict__ stream,
                                     int32_t* __restrict__ c_out,
                                     uint8_t* __restrict__ ok_out, int batch,
                                     int tau, int nbytes) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uint8_t* s = stream + size_t(b) * nbytes;
  uint64_t signs = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) signs |= uint64_t(s[k]) << (8 * k);

  uint64_t nz[4] = {0, 0, 0, 0};
  uint64_t sg[4] = {0, 0, 0, 0};
  int cnt = 0;
  for (int pos = 8; pos < nbytes && cnt < tau; ++pos) {
    const int j = s[pos];
    const int i = 256 - tau + cnt;
    if (j <= i) {
      place(nz, sg, i, j, (signs >> cnt) & 1ull);
      ++cnt;
    }
  }
  ok_out[b] = cnt >= tau ? 1 : 0;
  for (; cnt < tau; ++cnt) place(nz, sg, 256 - tau + cnt, 0, (signs >> cnt) & 1ull);

  int4* o = reinterpret_cast<int4*>(c_out + size_t(b) * 256);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      int v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * g + e;
        const bool n = (nz[k] >> r) & 1ull;
        const bool m = (sg[k] >> r) & 1ull;
        v[e] = n ? (m ? kQ - 1 : 1) : 0;
      }
      o[16 * k + g] = make_int4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

extern "C" int dk_ball_bitplane(const void* stream_bytes, void* c, void* ok,
                                int batch, int tau, int nbytes, void* stream) {
  if (batch > 0) {
    const int threads = 128;
    const int blocks = (batch + threads - 1) / threads;
    ball_bitplane_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(stream_bytes), static_cast<int32_t*>(c),
        static_cast<uint8_t*>(ok), batch, tau, nbytes);
  }
  return int(cudaGetLastError());
}
