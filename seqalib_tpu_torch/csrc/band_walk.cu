// Banded traceback walk over one super-block of packed pointer nibbles.
//
// Replaces seqalib_tpu/ops/banded_pallas.py::band_walk_range (packed=True,
// with the banded-SP i_floor handoff).  ops/band_walk.py's docstring states
// the layout.  Each walker runs the H/E/F state machine from its cell
// (i, j): on the diagonal k = i + j it reads the nibble of slot
// clamp(i - ihat(k), 0, Wp - 1), stops at a STOP pointer in state H, and
// otherwise emits one op and steps back (M: two diagonals, I or D: one).
// Every diagonal of the block gets a column: the op, or 255.  Before the
// read on every diagonal a walker on a row <= i_floor is marked done: in
// banded SP, local row 0 is the block above's last row (-1 never stops).
//
// Bound on the H100: memory latency.  A walker's reads are a chain of
// dependent byte loads from a block of up to 192 MB, one per op; the bytes
// read and written are a vanishing share of the block, so bandwidth does
// not matter.
//
// Design: one thread per pair, descending the block's diagonals serially;
// the other pairs' walks hide each other's latency.  The TPU kernel walked
// one diagonal per grid step for the whole batch and picked each pair's
// byte out of a (B, Wp) row with a lane mask-reduce; a GPU thread reads its
// byte directly.  The walker state stays on the device between
// super-blocks, so the host never waits on a block.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kStateH = 0;
constexpr int kStateE = 1;
constexpr int kStateF = 2;
constexpr uint8_t kOpNone = 255;

__global__ void band_walk_kernel(const uint8_t* __restrict__ ptr, int KW,
                                 int B, int Wp, int k0, int dhi,
                                 int i_floor, int32_t* __restrict__ iv,
                                 int32_t* __restrict__ jv,
                                 int32_t* __restrict__ stv,
                                 int32_t* __restrict__ donev,
                                 uint8_t* __restrict__ ops) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = iv[b], j = jv[b], st = stv[b], done = donev[b];
  uint8_t* ob = ops + (size_t)b * KW;
  for (int x = KW - 1; x >= 0; --x) {
    const int k = k0 + x;
    uint8_t op = kOpNone;
    if (i <= i_floor) done = 1;
    if (!done && i + j == k) {
      const int p = min(max(i - ihat(k, dhi), 0), Wp - 1);
      const int byte = ptr[((size_t)(x >> 1) * B + b) * Wp + p];
      const int nib = (byte >> (4 * (x & 1))) & 15;
      const int ph = nib & 3;
      const bool in_h = st == kStateH;
      if (in_h && ph == kPtrStop) {
        done = 1;
      } else {
        const bool act_m = in_h && ph == kPtrDiag;
        const bool act_i = (in_h && ph == kPtrUp) || st == kStateF;
        const bool ext_e = (nib >> 2) & 1;
        const bool ext_f = (nib >> 3) & 1;
        op = act_m ? kOpM : (act_i ? kOpI : kOpD);
        st = act_m ? kStateH
                   : (act_i ? (ext_f ? kStateF : kStateH)
                            : (ext_e ? kStateE : kStateH));
        i -= (act_m || act_i) ? 1 : 0;
        j -= act_i ? 0 : 1;  // M and D consume the target
      }
    }
    ob[x] = op;
  }
  iv[b] = i;
  jv[b] = j;
  stv[b] = st;
  donev[b] = done;
}

}  // namespace

extern "C" int seqalib_band_walk(const uint8_t* ptr, int KW, int B, int Wp,
                                 int k0, int dhi, int i_floor, int32_t* iv,
                                 int32_t* jv, int32_t* stv, int32_t* donev,
                                 uint8_t* ops, void* stream) {
  const int threads = 64;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  band_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      ptr, KW, B, Wp, k0, dhi, i_floor, iv, jv, stv, donev, ops);
  return (int)cudaGetLastError();
}
