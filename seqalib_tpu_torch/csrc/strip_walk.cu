// Traceback walk over the strip fill's pointer stream, writing each pair's
// CIGAR text.
//
// Replaces seqalib_tpu/ops/strip_pallas.py::strip_walk_range together with
// the host encoding of its op matrix (_cigars_from_ops).  Each walker runs
// the H/E/F state machine from its start cell (i, j) in its start state,
// takes one op per step, and stops at i < 1 or j < 1 or at a STOP pointer
// in state H.  ops/strip_walk.py's docstring states the outputs: the final
// states, and the CIGAR (the boundary run the walk stopped at, then the ops
// walked, run-length encoded) right-aligned in the pair's text row.
//
// Bound on the H100: the latency of one walker's chain of steps.  A step
// reads one pointer byte whose address depends on the step before, and
// the bytes read and written are a vanishing share of P, so the time is the
// longest walk's steps times the latency of one.
//
// Design: one warp per pair, every lane running the same walk (its reads
// are broadcasts from shared memory, and the warp stays converged for the
// copies).  Since i and j only fall, every cell the walk reads in its next
// kTile steps lies in the kTile x kTile block of rows [i - kTile, i) x
// columns [j - kTile, j).  The warp stages such a block, clamped at row and
// column 0, with 16-byte cp.async copies from device memory to shared
// memory, and waits for it: a row starts at any phase of a 16-byte segment
// (the row stride is odd), so each row is copied from the segment at or
// below its first byte, and the walker adds the row's phase to its column.
// Every kTile steps the walker anchors the next block where it stands.
// The copy is not overlapped with the walk: it is short against kTile
// dependent steps.
// A step is one shared-memory load at a 32-bit address, the decode, and the
// address of the next byte, which is loaded before the step's bookkeeping;
// the byte above (a_up) is tracked beside it, so that a row's phase is off
// that chain.  The walker keeps the current op and its length in
// registers; a finished run waits in a lane's register (run k of a batch in
// lane k), and every 32 runs the warp writes them together from the back of
// the pair's text row (each the letter, then its digits, least significant
// first; a prefix sum over the lanes places them), so that formatting
// digits stays out of the steps.  At the end the first run merged with the
// boundary run, then nchar and the state.  A start cell outside P (i > R or
// j > C) walks nothing and gets nchar = -1: the range check is deferred to
// the caller's host copy.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kStateH = 0;
constexpr int kStateE = 1;
constexpr int kStateF = 2;
constexpr int kBadStart = -1;
constexpr int kTile = 32;  // steps between two staged blocks, and their side

// Bytes per staged row: kTile bytes from any phase of a 16-byte segment.
constexpr int kPitch = 16 * (kTile / 16 + 1);

// Stage block rows [ai - kTile, ai) x columns [aj - kTile, aj), both
// clamped at 0, of the pair whose P starts at Pb: buffer row rr holds P row
// ai - 1 - rr from the 16-byte segment at or below its column
// max(0, aj - kTile) on.  The copies are committed as one group and not
// waited for.  Bytes past the end of P (Pend) are not read.
__device__ __forceinline__ void stage(uint8_t* sb, const uint8_t* Pb, int C, int ai, int aj,
                                      const uint8_t* Pend, int lane) {
  constexpr int kSegs = kPitch / 16;
  const int rows = min(kTile, ai);
  const int clo = max(0, aj - kTile);
  const int w = aj - clo;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sb);
  for (int e = lane; e < rows * kSegs; e += 32) {
    const int rr = e / kSegs;
    const int s = e - rr * kSegs;
    const uint8_t* first = Pb + (size_t)(ai - 1 - rr) * C + clo;
    const int ph = (int)((uintptr_t)first & 15);
    if (16 * s >= ph + w) continue;  // past the row's last byte
    const uint8_t* src = first - ph + 16 * s;
    const long long left = Pend - src;
    cp_async_16(base + rr * kPitch + 16 * s, src, left < 16 ? (int)left : 16);
  }
  cp_async_commit();
}

template <bool AFFINE>
__global__ void __launch_bounds__(32)
    strip_walk_kernel(const uint8_t* __restrict__ P, int R, int C, int B,
                      const int32_t* __restrict__ iv, const int32_t* __restrict__ jv,
                      const int32_t* __restrict__ stv, const int32_t* __restrict__ donev,
                      uint8_t* __restrict__ text, int L, int32_t* __restrict__ nchar,
                      int32_t* __restrict__ out) {
  // a block with a row of slack (and 16 bytes before it): the byte loaded
  // ahead of the last step in a block may lie outside it
  __shared__ __align__(16) uint8_t raw[16 + (kTile + 1) * kPitch];
  uint8_t* buf = raw + 16;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  int i = iv[b], j = jv[b], st = stv[b], done = donev[b];
  if (i > R || j > C) {
    if (lane == 0) {
      nchar[b] = kBadStart;
      out[b] = i;
      out[B + b] = j;
      out[2 * B + b] = st;
      out[3 * B + b] = done;
    }
    return;
  }
  Text tx{text + (size_t)b * L, L, 0, 0, lane};
  int run_op = -1, run_len = 0;
  if (!done && (i < 1 || j < 1)) done = 1;
  if (!done) {
    const uint8_t* Pb = P + (size_t)b * R * C;
    const uint8_t* Pend = P + (size_t)B * R * C;
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(buf);
    int ai = i, aj = j;  // the staged block's anchor
    stage(buf, Pb, C, ai, aj, Pend, lane);
    cp_async_wait_all();
    __syncwarp();
    for (;;) {
      // up to kTile steps in buf: P row i - 1 is its row ai - i, whose
      // bytes start at the phase (v & 15) of the row's first column clo;
      // a is the shared address of the byte of (i - 1, j - 1), a_up that of
      // (i - 2, j - 1), and the next step's byte is loaded before the run
      // bookkeeping of this one
      const int clo = max(0, aj - kTile);
      uint32_t v = (uint32_t)(uintptr_t)(Pb + (size_t)(i - 1) * C + clo);
      uint32_t a = base + (ai - i) * kPitch + (j - 1 - clo) + (v & 15);
      uint32_t a_up = a + kPitch + ((v - C) & 15) - (v & 15);
      int byte = lds_u8(a);
      for (int s = 0; s < kTile; ++s) {
        // the rise from the row above to the one above it
        const uint32_t rise = kPitch + ((v - 2 * C) & 15) - ((v - C) & 15);
        const int ph = byte & 3;
        const bool in_h = st == kStateH;
        const bool act_m = in_h && ph == kPtrDiag;
        const bool act_i = (in_h && ph == kPtrUp) || st == kStateF;
        const bool up = act_m || act_i;
        const int left = act_i ? 0 : 1;  // M and D consume the target
        const uint32_t a_next = act_i ? a_up : (act_m ? a_up - 1 : a - 1);
        const int next = lds_u8(a_next);
        if (in_h && ph == kPtrStop) {
          done = 1;
          break;
        }
        a = a_next;
        a_up = up ? a + rise : a_up - 1;
        v -= up ? C : 0u;
        const int op = act_m ? kOpM : (act_i ? kOpI : kOpD);
        if (AFFINE) {
          const bool ext_e = (byte >> 2) & 1;
          const bool ext_f = (byte >> 3) & 1;
          st = act_m ? kStateH
                     : (act_i ? (ext_f ? kStateF : kStateH) : (ext_e ? kStateE : kStateH));
        }
        byte = next;
        i -= up;
        j -= left;
        tx.push(run_op, run_len, op != run_op && run_len > 0);
        run_len = op == run_op ? run_len + 1 : 1;
        run_op = op;
        if (i < 1 || j < 1) {
          done = 1;
          break;
        }
      }
      if (done) break;
      __syncwarp();  // every lane has read the block before it is overwritten
      ai = i;
      aj = j;
      stage(buf, Pb, C, ai, aj, Pend, lane);
      cp_async_wait_all();
      __syncwarp();
    }
  }
  // the boundary run the walk stopped at comes first and merges with the
  // first run walked when their ops agree
  const int head_op = i > 0 ? kOpI : kOpD;
  const int head_len = i > 0 ? i : max(j, 0);
  if (run_len && head_len && head_op == run_op) {
    run_len += head_len;
  } else if (head_len) {
    tx.push(run_op, run_len, run_len > 0);
    run_op = head_op;
    run_len = head_len;
  }
  tx.push(run_op, run_len, run_len > 0);
  tx.flush();
  if (lane == 0) {
    nchar[b] = L - tx.pos;
    out[b] = i;
    out[B + b] = j;
    out[2 * B + b] = st;
    out[3 * B + b] = done;
  }
}

}  // namespace

// P must be 16-byte aligned; L >= 2 * (R + C) + 12 (ops/strip_walk.py's
// text_width).
extern "C" int seqalib_strip_walk(const uint8_t* P, int R, int C, const int32_t* iv,
                                  const int32_t* jv, const int32_t* stv,
                                  const int32_t* donev, uint8_t* text, int L,
                                  int32_t* nchar, int32_t* out, int B, int affine,
                                  void* stream) {
  if (B < 1 || ((uintptr_t)P & 15)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (affine)
    strip_walk_kernel<true><<<B, 32, 0, s>>>(P, R, C, B, iv, jv, stv, donev, text, L, nchar,
                                             out);
  else
    strip_walk_kernel<false><<<B, 32, 0, s>>>(P, R, C, B, iv, jv, stv, donev, text, L, nchar,
                                              out);
  return (int)cudaGetLastError();
}
