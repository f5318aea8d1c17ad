// Per-row dynamic window: out[n, x] = src'[n, starts[n] + x] for
// lo <= x < hi[n], else fill, where src' is src or, with `reverse`, src
// read right to left (src'[n, s] = src[n, W - 1 - s]).
//
// Replaces seqalib_tpu/ops/strip_pallas.py::_row_window, the Pallas kernel
// that cuts the pass-2 reversed prefixes and the pass-3 [qs:qe] x [ts:te]
// windows out of the padded letter arrays.
//
// Bound on the H100: pure data movement, 8 bytes of device memory traffic
// per output element (one int32 read, one written) and no arithmetic; at
// the main path's shapes (512 rows of 1-2 K int32) it is a few MB, so it
// is launch-latency bound, not bandwidth bound.
//
// Design: one thread per output element, neighbouring threads on
// neighbouring x, so reads and writes coalesce (a reversed read walks the
// same lines downwards).  The TPU kernel needed a lane-aligned superset
// load (its callers kept starts + L + 128 <= W); a GPU thread loads one
// word at any offset, so that rule is gone.  The read is masked to [0, W)
// all the same.  Since the call is bound by launch latency, the range
// check stays off the host: given an error word, thread n also checks row
// n's used range [starts + lo, starts + min(hi, L)) against [0, W) and
// records the first bad row with atomicMin, and the caller reads the word
// at a host copy it makes anyway.  The reversed read replaces the
// torch.flip copy of the source that the pass-2 windows would need.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void row_window_kernel(const int32_t* __restrict__ src, int N, int W,
                                  const int32_t* __restrict__ starts,
                                  const int32_t* __restrict__ hi,
                                  int32_t* __restrict__ out, int L, int lo,
                                  int fill, int reverse, int32_t* err) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (err != nullptr && idx < (size_t)N) {  // the range check of row idx
    const long long s0 = starts[idx];
    const long long top = s0 + min(hi[idx], L);
    if (top > s0 + lo && (s0 + lo < 0 || top > W)) atomicMin(err, (int)idx);
  }
  if (idx >= (size_t)N * L) return;
  const int n = (int)(idx / L);
  const int x = (int)(idx - (size_t)n * L);
  const long long s = (long long)starts[n] + x;
  int v = fill;
  if (x >= lo && x < hi[n] && s >= 0 && s < W)
    v = src[(size_t)n * W + (reverse ? W - 1 - s : s)];
  out[idx] = v;
}

}  // namespace

extern "C" int seqalib_row_window(const int32_t* src, int N, int W,
                                  const int32_t* starts, const int32_t* hi,
                                  int32_t* out, int L, int lo, int fill,
                                  int reverse, int32_t* err, void* stream) {
  const size_t total = (size_t)N * L > (size_t)N ? (size_t)N * L : (size_t)N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  row_window_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      src, N, W, starts, hi, out, L, lo, fill, reverse, err);
  return (int)cudaGetLastError();
}

// Text of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* seqalib_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
