// Exhaustive check of duplex_core.cuh's exp_f32 / log1p_f32 against the CUDA
// math library's expf / log1pf: every one of the 2^32 float bit patterns
// goes through both, and a result that differs in any bit counts (two NaNs
// count as equal: no payload reaches an output of the duplex kernels).  The
// duplex kernels are bit for bit equal to their plain PyTorch versions only
// while both counts are 0, so the smoke run fails otherwise: a toolkit whose
// expf or log1pf computes differently shows here first.

#include "duplex_core.cuh"

namespace {

__device__ __forceinline__ bool differs(float a, float b) {
  return !(isnan(a) && isnan(b)) && __float_as_uint(a) != __float_as_uint(b);
}

__global__ void math_check_kernel(unsigned long long* out) {
  unsigned long long bad_exp = 0, bad_log1p = 0;
  const unsigned long long n = 1ull << 32;
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const float x = __uint_as_float((unsigned)i);
    bad_exp += differs(duplex::exp_f32(x), expf(x));
    bad_log1p += differs(duplex::log1p_f32(x), log1pf(x));
  }
  if (bad_exp) atomicAdd(out, bad_exp);
  if (bad_log1p) atomicAdd(out + 1, bad_log1p);
}

}  // namespace

extern "C" {

// Count, over all 2^32 float arguments, the results of exp_f32 and log1p_f32
// that differ from expf and log1pf: out[0], out[1] (device memory, zeroed by
// the caller).  Returns the launch's cudaError_t.
int ctc_duplex_math_check_launch(unsigned long long* out, void* stream) {
  math_check_kernel<<<1056, 256, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
