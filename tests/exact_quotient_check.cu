// Every f32 numerator through exact_quotient() (the X-Trans grad kernel's
// division by a stage-2 denominator, raweditor_tpu_torch/csrc/
// exact_quotient.cuh) against the IEEE quotient x / d on the card: all
// 2^32 bit patterns for one denominator a launch. Not part of the port's
// kernel library: tests/test_torch_cuda.py builds it on its own, with the
// library's nvcc flags and the package's csrc/ on the include path.

#include <cstdint>
#include <cuda_runtime.h>

#include "exact_quotient.cuh"

namespace {

// counts[0]: inputs whose quotients differ in their bits (two NaNs of any
// payload count as equal); counts[1]: of the equal ones, NaN pairs whose
// bits differ. first: one differing input's bits.
__global__ void check_every_f32(float d, unsigned long long* counts,
                                unsigned* first) {
  const float rcp = __frcp_rn(d);
  unsigned long long bad = 0, nan_bits = 0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t u = blockIdx.x * static_cast<uint64_t>(blockDim.x) +
                    threadIdx.x;
       u < (1ull << 32); u += stride) {
    const float x = __uint_as_float(static_cast<unsigned>(u));
    const float want = x / d;
    const float got = exact_quotient(x, d, rcp);
    if (__float_as_uint(got) == __float_as_uint(want)) continue;
    if (got != got && want != want) {
      ++nan_bits;
      continue;
    }
    ++bad;
    *first = static_cast<unsigned>(u);
  }
  if (bad) atomicAdd(counts, bad);
  if (nan_bits) atomicAdd(counts + 1, nan_bits);
}

}  // namespace

// counts: two u64 on the device, zeroed by the caller; first: one u32 on
// the device. Launches on ``stream`` and returns the cudaGetLastError()
// code.
extern "C" int rtt_exact_quotient_check(float d, void* counts, void* first,
                                        void* stream) {
  check_every_f32<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      d, static_cast<unsigned long long*>(counts),
      static_cast<unsigned*>(first));
  return static_cast<int>(cudaGetLastError());
}
