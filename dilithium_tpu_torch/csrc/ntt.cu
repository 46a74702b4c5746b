// K4: 256-point forward / inverse NTT mod q = 8380417, one warp per
// polynomial with its coefficients in registers.
//
// Replaces dilithium_tpu/ops/ntt_pallas.py::ntt / invntt (_fwd_kernel,
// _inv_kernel, _run_stages): keygen's NTT(s1) and INTT(t), and the
// operator build's INTT of A_hat.
//
// Twiddles come from a [4, 256] table (forward zeta, its Shoup companion
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
// latency; at large batch the bytes (2 KB a polynomial) and the integer
// work of the 1024 butterflies come within 10% of each other. Two kernels,
// chosen by batch (PERF.md has the sweep, NVIDIA H100 80GB HBM3):
//   - up to kSmallBatch polynomials, block_ntt_kernel: one 128-thread block
//     a polynomial, the coefficients in shared memory, one butterfly a
//     thread a stage with __syncthreads() between the 8 stages. Each
//     polynomial gets an SM of its own, so its latency is all that counts
//     (2.6-3.1 us a call up to 512 polynomials, against 2.8-3.3 us for the
//     warp kernel, which packs 8 polynomials into an SM's issue slots);
//   - above that, warp_ntt_kernel: one warp a polynomial, 8 coefficients a
//     lane in registers. A block runs 8 warps and stages the direction's
//     twiddles with their companions (2 KB) into shared memory once, then
//     each warp walks the batch a polynomial at a time. Coefficient j's
//     index bits are b7..b0: layout A puts b7 b6 b5 in the register index
//     (lane l holds l + 32 m), layout B b4 b3 b2, layout C b2 b1 b0 (lane l
//     holds 8 l .. 8 l + 7). A stage whose pair distance is a register bit
//     runs in registers. The forward runs distances 128, 64, 32 in A, 16,
//     8, 4 in B and 2, 1 in C; the inverse the mirror order (C, B, A), then
//     the scale. Between layouts the warp exchanges once through its own
//     1 KB of shared memory under __syncwarp(): two exchanges a transform
//     and no block barrier. Shared memory holds coefficient j at
//     j ^ (((j >> 5) & 7) << 2), so every exchange's 32-bit (A, B) and
//     16-byte (C) accesses are free of bank conflicts. Global I/O is
//     coalesced: layout C moves 8 coefficients a lane as two 16-byte
//     accesses (a warp covers the polynomial's 1 KB), layout A one 128-byte
//     line a warp access; the forward loads in A and stores in C, the
//     inverse loads in C and stores in A.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr uint32_t kQ = 8380417u;
constexpr int kWarps = 8;  // polynomials in flight a block of warp_ntt_kernel
constexpr int kSmallBatch = 512;  // up to here block_ntt_kernel

__device__ __forceinline__ uint32_t csubq(uint32_t a) {
  return a >= kQ ? a - kQ : a;
}

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t z,
                                              uint32_t zs) {
  const uint32_t est = __umulhi(a, zs);
  return csubq(a * z - est * kQ);
}

// one 128-thread block a polynomial, the coefficients in shared memory
template <bool kInverse>
__global__ void block_ntt_kernel(const int32_t* __restrict__ in,
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

// lowest index bit a layout keeps in the register index
__host__ __device__ constexpr int low_bit(int layout) {
  return layout == 0 ? 5 : layout == 1 ? 2 : 0;
}

// coefficient held by lane in register r
template <int kLayout>
__device__ __forceinline__ int coeff(int lane, int r) {
  if (kLayout == 0) return 32 * r + lane;
  if (kLayout == 1) return 32 * (lane >> 2) + 4 * r + (lane & 3);
  return 8 * lane + r;
}

// shared-memory word of coefficient j
__device__ __forceinline__ int swz(int j) { return j ^ (((j >> 5) & 7) << 2); }

// forward (Cooley-Tukey) stage of half-length 2^kLog
template <int kLayout, int kLog>
__device__ __forceinline__ void fwd_stage(uint32_t x[8], int lane,
                                          const uint2* tw) {
  constexpr int h = 1 << (kLog - low_bit(kLayout));
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r & h) continue;
    const uint2 z = tw[(128 >> kLog) + (coeff<kLayout>(lane, r) >> (kLog + 1))];
    const uint32_t t = shoup_mul(x[r + h], z.x, z.y);
    x[r + h] = csubq(x[r] + kQ - t);
    x[r] = csubq(x[r] + t);
  }
}

// inverse (Gentleman-Sande) stage of half-length 2^kLog
template <int kLayout, int kLog>
__device__ __forceinline__ void inv_stage(uint32_t x[8], int lane,
                                          const uint2* tw) {
  constexpr int h = 1 << (kLog - low_bit(kLayout));
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r & h) continue;
    const uint2 z = tw[(256 >> kLog) - 1 - (coeff<kLayout>(lane, r) >> (kLog + 1))];
    const uint32_t a = x[r];
    const uint32_t b = x[r + h];
    x[r] = csubq(a + b);
    x[r + h] = shoup_mul(csubq(a + kQ - b), z.x, z.y);
  }
}

// re-deal the warp's coefficients from layout kFrom to kTo through s
template <int kFrom, int kTo>
__device__ __forceinline__ void exchange(uint32_t x[8], int lane, uint32_t* s) {
  __syncwarp();  // every lane is done reading s
  if (kFrom == 2) {
    *reinterpret_cast<uint4*>(s + swz(8 * lane)) = make_uint4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<uint4*>(s + swz(8 * lane + 4)) = make_uint4(x[4], x[5], x[6], x[7]);
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r) s[swz(coeff<kFrom>(lane, r))] = x[r];
  }
  __syncwarp();
  if (kTo == 2) {
    const uint4 lo = *reinterpret_cast<const uint4*>(s + swz(8 * lane));
    const uint4 hi = *reinterpret_cast<const uint4*>(s + swz(8 * lane + 4));
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = s[swz(coeff<kTo>(lane, r))];
  }
}

template <bool kInverse>
__global__ void __launch_bounds__(kWarps * 32)
    warp_ntt_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                    int batch, const uint32_t* __restrict__ ztab, uint32_t g,
                    uint32_t gs) {
  __shared__ uint2 tw[256];
  __shared__ __align__(16) uint32_t xs[kWarps][256];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* zeta = ztab + (kInverse ? 512 : 0);
  for (int k = threadIdx.x; k < 256; k += blockDim.x) tw[k] = make_uint2(zeta[k], zeta[256 + k]);
  __syncthreads();

  uint32_t* s = xs[warp];
  for (int p = blockIdx.x * kWarps + warp; p < batch; p += gridDim.x * kWarps) {
    const int32_t* src = in + size_t(p) * 256;
    int32_t* dst = out + size_t(p) * 256;
    uint32_t x[8];
    if (!kInverse) {
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = uint32_t(src[32 * r + lane]);
      fwd_stage<0, 7>(x, lane, tw);
      fwd_stage<0, 6>(x, lane, tw);
      fwd_stage<0, 5>(x, lane, tw);
      exchange<0, 1>(x, lane, s);
      fwd_stage<1, 4>(x, lane, tw);
      fwd_stage<1, 3>(x, lane, tw);
      fwd_stage<1, 2>(x, lane, tw);
      exchange<1, 2>(x, lane, s);
      fwd_stage<2, 1>(x, lane, tw);
      fwd_stage<2, 0>(x, lane, tw);
      int4* o = reinterpret_cast<int4*>(dst) + 2 * lane;
      o[0] = make_int4(int(x[0]), int(x[1]), int(x[2]), int(x[3]));
      o[1] = make_int4(int(x[4]), int(x[5]), int(x[6]), int(x[7]));
    } else {
      const int4* i4 = reinterpret_cast<const int4*>(src) + 2 * lane;
      const int4 lo = i4[0];
      const int4 hi = i4[1];
      x[0] = uint32_t(lo.x); x[1] = uint32_t(lo.y); x[2] = uint32_t(lo.z); x[3] = uint32_t(lo.w);
      x[4] = uint32_t(hi.x); x[5] = uint32_t(hi.y); x[6] = uint32_t(hi.z); x[7] = uint32_t(hi.w);
      inv_stage<2, 0>(x, lane, tw);
      inv_stage<2, 1>(x, lane, tw);
      exchange<2, 1>(x, lane, s);
      inv_stage<1, 2>(x, lane, tw);
      inv_stage<1, 3>(x, lane, tw);
      inv_stage<1, 4>(x, lane, tw);
      exchange<1, 0>(x, lane, s);
      inv_stage<0, 5>(x, lane, tw);
      inv_stage<0, 6>(x, lane, tw);
      inv_stage<0, 7>(x, lane, tw);
#pragma unroll
      for (int r = 0; r < 8; ++r) dst[32 * r + lane] = int32_t(shoup_mul(x[r], g, gs));
    }
  }
}

// warp_ntt_kernel's blocks for a batch: one per kWarps polynomials, at
// most as many as the current device keeps resident at once (each block
// then walks the batch). The resident count is looked up once a device
// and kept in a table indexed by the device (0 = not yet looked up).
constexpr int kMaxDevices = 64;

template <bool kInverse>
int grid_for(int batch) {
  static std::atomic<int> resident[kMaxDevices];  // zero-initialised (static storage)
  int dev = 0;
  cudaGetDevice(&dev);
  int res = dev < kMaxDevices ? resident[dev].load(std::memory_order_relaxed) : 0;
  if (res == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, warp_ntt_kernel<kInverse>, kWarps * 32, 0);
    res = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) resident[dev].store(res, std::memory_order_relaxed);
  }
  const int need = (batch + kWarps - 1) / kWarps;
  return need < res ? need : res;
}

}  // namespace

extern "C" int dk_ntt(const void* in, void* out, int batch, const void* ztab,
                      int inverse, uint32_t g, uint32_t gs, void* stream) {
  if (batch > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* src = static_cast<const int32_t*>(in);
    int32_t* dst = static_cast<int32_t*>(out);
    const uint32_t* z = static_cast<const uint32_t*>(ztab);
    if (batch <= kSmallBatch && inverse)
      block_ntt_kernel<true><<<batch, 128, 0, s>>>(src, dst, z, g, gs);
    else if (batch <= kSmallBatch)
      block_ntt_kernel<false><<<batch, 128, 0, s>>>(src, dst, z, g, gs);
    else if (inverse)
      warp_ntt_kernel<true><<<grid_for<true>(batch), kWarps * 32, 0, s>>>(src, dst, batch, z, g, gs);
    else
      warp_ntt_kernel<false><<<grid_for<false>(batch), kWarps * 32, 0, s>>>(src, dst, batch, z, g, gs);
  }
  return int(cudaGetLastError());
}
