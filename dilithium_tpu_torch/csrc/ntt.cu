// K4: 256-point forward / inverse NTT mod q = 8380417, one thread block
// per polynomial.
//
// Replaces dilithium_tpu/ops/ntt_pallas.py::ntt / invntt (_fwd_kernel,
// _inv_kernel, _run_stages): keygen's NTT(s1) and INTT(t), and the
// operator build's INTT of A_hat.
//
// 128 threads hold the 256 coefficients in shared memory and each does one
// butterfly per stage, with __syncthreads() between the 8 stages. Twiddles
// come from a [4, 256] table (forward zeta, its Shoup companion
// floor(zeta * 2^32 / q), inverse zeta, companion) indexed as the JAX
// package's tables are built (ops/ntt.py:_build_tables): forward stage
// with half-length len uses zeta[128/len + block], inverse uses
// -zeta[256/len - 1 - block]. Multiplies are Shoup's: one __umulhi and two
// low products give a * z - floor(a * zs / 2^32) * q in [0, 2q), and a
// conditional subtract finishes. The inverse ends with one Shoup multiply
// by the scale (256^-1 or 256^-1 * R, whichever the caller passes).
// Every value is an exact canonical residue, so the output is
// bit-identical to ops/ntt.py.
//
// Bound on the card: at the path's sizes (5 to 30 polynomials) launch
// latency; at large batch the shared-memory traffic of the 8 stages.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kQ = 8380417u;

__device__ __forceinline__ uint32_t csubq(uint32_t a) {
  return a >= kQ ? a - kQ : a;
}

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t z,
                                              uint32_t zs) {
  const uint32_t est = __umulhi(a, zs);
  return csubq(a * z - est * kQ);
}

template <bool kInverse>
__global__ void ntt_kernel(const int32_t* __restrict__ in,
                           int32_t* __restrict__ out,
                           const uint32_t* __restrict__ ztab, uint32_t g,
                           uint32_t gs) {
  __shared__ uint32_t x[256];
  const int t = threadIdx.x;  // 0..127
  const int32_t* src = in + size_t(blockIdx.x) * 256;
  x[t] = uint32_t(src[t]);
  x[t + 128] = uint32_t(src[t + 128]);
  __syncthreads();

  if (!kInverse) {
#pragma unroll
    for (int len = 128; len >= 1; len >>= 1) {
      const int blk = t / len;
      const int j = blk * 2 * len + (t % len);
      const int k = 128 / len + blk;
      const uint32_t a = x[j];
      const uint32_t tt = shoup_mul(x[j + len], ztab[k], ztab[256 + k]);
      x[j] = csubq(a + tt);
      x[j + len] = csubq(a + kQ - tt);
      __syncthreads();
    }
  } else {
#pragma unroll
    for (int len = 1; len <= 128; len <<= 1) {
      const int blk = t / len;
      const int j = blk * 2 * len + (t % len);
      const int k = 256 / len - 1 - blk;
      const uint32_t a = x[j];
      const uint32_t b = x[j + len];
      x[j] = csubq(a + b);
      x[j + len] = shoup_mul(csubq(a + kQ - b), ztab[512 + k], ztab[768 + k]);
      __syncthreads();
    }
    x[t] = shoup_mul(x[t], g, gs);
    x[t + 128] = shoup_mul(x[t + 128], g, gs);
    __syncthreads();
  }

  int32_t* dst = out + size_t(blockIdx.x) * 256;
  dst[t] = int32_t(x[t]);
  dst[t + 128] = int32_t(x[t + 128]);
}

}  // namespace

extern "C" int dk_ntt(const void* in, void* out, int batch, const void* ztab,
                      int inverse, uint32_t g, uint32_t gs, void* stream) {
  if (batch > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* src = static_cast<const int32_t*>(in);
    int32_t* dst = static_cast<int32_t*>(out);
    const uint32_t* z = static_cast<const uint32_t*>(ztab);
    if (inverse)
      ntt_kernel<true><<<batch, 128, 0, s>>>(src, dst, z, g, gs);
    else
      ntt_kernel<false><<<batch, 128, 0, s>>>(src, dst, z, g, gs);
  }
  return int(cudaGetLastError());
}
