// K3: SampleInBall, one thread per message.
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
// Bound on the card: the serial walk (up to 264 dependent steps per
// thread) and latency of its shared-memory accesses; the work is tiny.
// Design: the TPU kernel had no gather, so it emulated each swap with
// one-hot selects over all 256 coefficients; here each thread keeps its
// polynomial as 256 int8 in shared memory (column layout, coefficient j of
// thread t at j * blockDim + t; 128 threads x 256 B = 32 KB per block) and
// swaps by direct indexing, interleaving the walk with the swaps.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 8380417;
constexpr int kThreads = 128;

__global__ void ball_kernel(const uint8_t* __restrict__ stream,
                            int32_t* __restrict__ c_out,
                            uint8_t* __restrict__ ok_out, int batch, int tau,
                            int nbytes) {
  __shared__ int8_t poly[256 * kThreads];
  const int t = threadIdx.x;
  const int b = blockIdx.x * blockDim.x + t;
  if (b >= batch) return;  // no block-wide barrier follows
  int8_t* c = poly + t;
  for (int j = 0; j < 256; ++j) c[j * kThreads] = 0;

  const uint8_t* s = stream + size_t(b) * nbytes;
  uint64_t signs = 0;
  for (int k = 0; k < 8; ++k) signs |= uint64_t(s[k]) << (8 * k);

  int cnt = 0;
  for (int pos = 8; pos < nbytes && cnt < tau; ++pos) {
    const int j = s[pos];
    const int i = 256 - tau + cnt;
    if (j <= i) {
      c[i * kThreads] = c[j * kThreads];
      c[j * kThreads] = int8_t(1 - 2 * int((signs >> cnt) & 1));
      ++cnt;
    }
  }
  ok_out[b] = cnt >= tau ? 1 : 0;
  for (; cnt < tau; ++cnt) {
    c[(256 - tau + cnt) * kThreads] = c[0];
    c[0] = int8_t(1 - 2 * int((signs >> cnt) & 1));
  }

  int32_t* o = c_out + size_t(b) * 256;
  for (int j = 0; j < 256; ++j) {
    const int v = c[j * kThreads];
    o[j] = v < 0 ? kQ - 1 : v;
  }
}

}  // namespace

extern "C" int dk_ball(const void* stream_bytes, void* c, void* ok,
                       int batch, int tau, int nbytes, void* stream) {
  if (batch > 0) {
    const int blocks = (batch + kThreads - 1) / kThreads;
    ball_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(stream_bytes), static_cast<int32_t*>(c),
        static_cast<uint8_t*>(ok), batch, tau, nbytes);
  }
  return int(cudaGetLastError());
}
