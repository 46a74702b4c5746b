// K5: one Keccak-f[1600] permutation per state, one thread per state.
//
// Replaces dilithium_tpu/ops/keccak_pallas.py::f1600_folded (_kernel,
// line 43; f1600_lists at line 68 wraps it): the standalone permutation
// the kernel micro-bench times (bench_kernels.py:84).
//
// Layouts: lane k of state b is read from and written to
// base[b * state_stride + k * lane_stride] as 64-bit words. The batch-major
// form [B, 25] has (state_stride, lane_stride) = (25, 1); the plane form
// [25, B], the counterpart of the TPU kernel's folded lane planes, has
// (1, B). In the plane form neighbouring threads touch neighbouring
// addresses, so each lane's load and store is coalesced; in the
// batch-major form a warp's 32 loads of one lane are 200 bytes apart.
//
// Bound on the card: integer operations. A permutation is some 4,300
// 32-bit logic and funnel-shift instructions against 400 bytes of state
// moved, so even the strided form is far below the memory roofline.
// Design: the 25 lanes live in registers for all 24 rounds (dk::keccakf,
// shared with K6, fully unrolled with constant indices); the batch tail is
// masked, so any B works.
#include <cuda_runtime.h>

#include <cstdint>

#include "keccak.cuh"

namespace {

__global__ void permute_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out, int batch,
                               long long state_stride, long long lane_stride) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uint64_t* src = in + b * state_stride;
  uint64_t* dst = out + b * state_stride;
  uint64_t st[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) st[k] = src[k * lane_stride];
  dk::keccakf(st);
#pragma unroll
  for (int k = 0; k < 25; ++k) dst[k * lane_stride] = st[k];
}

}  // namespace

extern "C" int dk_permute(const void* in, void* out, int batch,
                          long long state_stride, long long lane_stride,
                          void* stream) {
  if (batch > 0) {
    const int threads = 128;
    const int blocks = (batch + threads - 1) / threads;
    permute_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), batch,
        state_stride, lane_stride);
  }
  return int(cudaGetLastError());
}
