// Traceback walk over the strip fill's pointer stream.
//
// Replaces seqalib_tpu/ops/strip_pallas.py::strip_walk_range.  Each walker
// runs the H/E/F state machine from its start cell (qlen, tlen) in state H,
// emits one op per step, and stops at i < 1 or j < 1 (no read there: the
// host prepends the implicit all-I or all-D boundary run) or at a STOP
// pointer in state H.
//
// Bound on the H100: memory latency.  A step reads one pointer byte whose
// address depends on the previous step, so a walker is a chain of
// dependent loads (~qlen + tlen of them); the bytes read are a vanishing
// share of the pointer stream and bandwidth does not matter.
//
// Design: one thread per pair, walking serially; many pairs in flight hide
// each other's latency.  The TPU kernel swept strips and diagonals in
// descending order so that every pointer block was read once into VMEM,
// and capped a launch at 512 pairs (BCAP) for VMEM's sake; a GPU thread
// reads any byte directly, so neither carries over.  Ops are written from
// the back of the pair's row: ascending order is start -> end, and the
// unused front stays 255.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kStateH = 0;
constexpr int kStateE = 1;
constexpr int kStateF = 2;

template <bool AFFINE>
__global__ void strip_walk_kernel(const uint8_t* __restrict__ P, int rows,
                                  int cols, int32_t* __restrict__ iv,
                                  int32_t* __restrict__ jv,
                                  int32_t* __restrict__ stv,
                                  int32_t* __restrict__ donev,
                                  uint8_t* __restrict__ ops, int ops_len,
                                  int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = iv[b], j = jv[b], st = stv[b], done = donev[b];
  const uint8_t* Pb = P + (size_t)b * rows * cols;
  uint8_t* ob = ops + (size_t)b * ops_len;
  int pos = ops_len;  // the wrapper guarantees ops_len >= i + j
  while (!done) {
    if (i < 1 || j < 1) {
      done = 1;
      break;
    }
    const int byte = Pb[(size_t)(i - 1) * cols + (j - 1)];
    const int ph = byte & 3;
    const bool in_h = st == kStateH;
    if (in_h && ph == kPtrStop) {
      done = 1;
      break;
    }
    const bool act_m = in_h && ph == kPtrDiag;
    const bool act_i = (in_h && ph == kPtrUp) || st == kStateF;
    ob[--pos] = act_m ? kOpM : (act_i ? kOpI : kOpD);
    if (AFFINE) {
      const bool ext_e = (byte >> 2) & 1;
      const bool ext_f = (byte >> 3) & 1;
      st = act_m ? kStateH
                 : (act_i ? (ext_f ? kStateF : kStateH)
                          : (ext_e ? kStateE : kStateH));
    }
    i -= (act_m || act_i) ? 1 : 0;
    j -= act_i ? 0 : 1;  // M and D consume the target
  }
  iv[b] = i;
  jv[b] = j;
  stv[b] = st;
  donev[b] = done;
}

}  // namespace

extern "C" int seqalib_strip_walk(const uint8_t* P, int rows, int cols,
                                  int32_t* iv, int32_t* jv, int32_t* stv,
                                  int32_t* donev, uint8_t* ops, int ops_len,
                                  int B, int affine, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (affine)
    strip_walk_kernel<true><<<blocks, threads, 0, s>>>(P, rows, cols, iv, jv,
                                                       stv, donev, ops,
                                                       ops_len, B);
  else
    strip_walk_kernel<false><<<blocks, threads, 0, s>>>(P, rows, cols, iv, jv,
                                                        stv, donev, ops,
                                                        ops_len, B);
  return (int)cudaGetLastError();
}
