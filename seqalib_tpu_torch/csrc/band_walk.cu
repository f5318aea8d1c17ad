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
// Bound on the H100: the latency of one walker's chain of steps.  Each
// step depends on the byte the step before chose, and the bytes read and
// written are a vanishing share of the block (a few µs of HBM time), so
// the time is the number of steps times the latency of one.
//
// Design: one CTA per pair.  Warp 0's lane 0 walks; warps 1.. stage the
// packed bytes the walker is about to read into shared memory, a chunk of
// kChunk byte rows (2 * kChunk diagonals) at a time, double-buffered: while
// the walker reads chunk c from shared memory (~30 cycles a step instead
// of a dependent L2/HBM load), the stagers copy chunk c + 1.  A walker's
// slot moves by at most one per diagonal, so a chunk is staged as a window
// of kWindow slots centred on the walker's slot at the start of the chunk
// before (2 * 2 * kChunk slots of drift at most); the whole row when Wp <=
// kWindow.  A read outside the window (never, by that bound) falls back to
// global memory.  The stagers copy 16 bytes a load, so that a chunk is
// about one round trip to memory, under the walker's time for it.  One
// __syncthreads per chunk.  A pair that is done (or
// outside the block) fills its ops row with 255 and exits at once: in
// banded SP one pair of a relay group is live.  The walker visits only the
// diagonals it stands on; the ops row is prefilled with 255 by all threads
// (coalesced) before the walk.  The walker state stays on the device
// between super-blocks, so the host never waits on a block.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kStateH = 0;
constexpr int kStateE = 1;
constexpr int kStateF = 2;
constexpr uint8_t kOpNone = 255;
constexpr int kThreads = 128;  // warp 0 walks, warps 1-3 stage
constexpr int kChunk = 32;     // byte rows (2 diagonals each) per chunk
constexpr int kWindow = 384;   // slots staged per byte row (config 4's 256, banded SP's 384)

__global__ void __launch_bounds__(kThreads)
    band_walk_kernel(const uint8_t* __restrict__ ptr, int KW, int B, int Wp,
                     int k0, int dhi, int i_floor, int32_t* __restrict__ iv,
                     int32_t* __restrict__ jv, int32_t* __restrict__ stv,
                     int32_t* __restrict__ donev, uint8_t* __restrict__ ops) {
  __shared__ __align__(16) uint8_t buf[2][kChunk][kWindow];
  // per chunk parity: the walker's slot at the start of the chunk, and
  // whether the walk ended in it (two copies, so that the walker's write
  // for chunk c + 1 never meets a read of chunk c's)
  __shared__ int start_slot[2], stop[2];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  uint8_t* ob = ops + (size_t)b * KW;
  for (int x = tid; x < KW; x += kThreads) ob[x] = kOpNone;

  int i = iv[b], j = jv[b], st = stv[b], done = donev[b];
  if (KW > 0 && i <= i_floor) done = 1;  // the test on the top diagonal
  const int x0 = i + j - k0;  // the walker's diagonal in the block
  if (done || x0 < 0 || x0 >= KW) {
    if (tid == 0) donev[b] = done;
    return;
  }
  const int WW = min(Wp, kWindow);
  const size_t rowstride = (size_t)B * Wp;
  const uint8_t* pb = ptr + (size_t)b * Wp;  // byte row r at pb + r * rowstride
  // 16-byte copies where the rows allow them (Wp a multiple of 16: every
  // caller's), byte copies otherwise
  const bool vec = Wp % 16 == 0 && ((uintptr_t)ptr & 15) == 0;
  const int kb = k0 - dhi + 1;  // ihat(k0 + x) = max(0, floor((x + kb) / 2))
  auto slot_of = [&](int x) { return min(max(i - max(0, floordiv2(x + kb)), 0), Wp - 1); };
  auto window_at = [&](int p) {
    const int w = min(max(p - WW / 2, 0), Wp - WW);
    return vec ? w & ~15 : w;
  };
  // byte rows (r_hi - kChunk, r_hi] (those >= 0), slots [wlo, wlo + WW)
  auto stage = [&](int c, int r_hi, int wlo) {
    const int n = vec ? WW / 16 : WW;  // copies per row
    for (int e = tid - 32; e < kChunk * n; e += kThreads - 32) {
      const int rr = e / n, s = e - rr * n;
      const int r = r_hi - rr;
      if (r < 0) continue;
      const uint8_t* src = pb + (size_t)r * rowstride + wlo;
      if (vec)
        reinterpret_cast<uint4*>(buf[c][rr])[s] = __ldg(reinterpret_cast<const uint4*>(src) + s);
      else
        buf[c][rr][s] = __ldg(src + s);
    }
  };
  const int r_top = x0 >> 1;
  int wlo = window_at(slot_of(x0));  // the current chunk's window
  if (tid >= 32) stage(0, r_top, wlo);
  if (tid == 0) start_slot[0] = slot_of(x0);
  __syncthreads();
  int x = x0;
  for (int c = 0;; ++c) {
    const int r_hi = r_top - c * kChunk;  // this chunk's byte rows
    const int r_lo = r_hi - kChunk + 1;
    // chunk c + 1 is staged around the walker's slot at the start of chunk c
    const int wnext = window_at(start_slot[c & 1]);
    if (tid == 0) {
      // the staged byte of row r, slot p at shared address at0 - r * kWindow + p
      const uint32_t at0 =
          (uint32_t)__cvta_generic_to_shared(&buf[c & 1][0][0]) + r_hi * kWindow - wlo;
      while (!done && x >= 0 && (x >> 1) >= r_lo) {
        const int p = slot_of(x);
        const int r = x >> 1;
        const int s = p - wlo;
        int byte;
        if (__builtin_expect((unsigned)s < (unsigned)WW, 1)) {
          unsigned short v;
          asm volatile("ld.shared.u8 %0, [%1];" : "=h"(v) : "r"(at0 - r * kWindow + p));
          byte = v;
        } else {
          byte = pb[(size_t)r * rowstride + p];
        }
        const int nib = (byte >> (4 * (x & 1))) & 15;
        const int ph = nib & 3;
        const bool in_h = st == kStateH;
        if (in_h && ph == kPtrStop) {
          done = 1;
          break;
        }
        const bool act_m = in_h && ph == kPtrDiag;
        const bool act_i = (in_h && ph == kPtrUp) || st == kStateF;
        const bool ext_e = (nib >> 2) & 1;
        const bool ext_f = (nib >> 3) & 1;
        ob[x] = act_m ? kOpM : (act_i ? kOpI : kOpD);
        st = act_m ? kStateH
                   : (act_i ? (ext_f ? kStateF : kStateH)
                            : (ext_e ? kStateE : kStateH));
        i -= (act_m || act_i) ? 1 : 0;
        j -= act_i ? 0 : 1;  // M and D consume the target
        // the floor test on the next diagonal, if the block has one
        if (x >= 1 && i <= i_floor) done = 1;
        x = i + j - k0;
      }
      stop[c & 1] = done || x < 0 || r_lo <= 0;
      start_slot[(c + 1) & 1] = x >= 0 ? slot_of(x) : 0;
    } else if (tid >= 32 && r_lo > 0) {
      stage((c + 1) & 1, r_lo - 1, wnext);
    }
    __syncthreads();  // chunk c + 1 is staged; the walker is through chunk c
    if (stop[c & 1]) break;
    wlo = wnext;
  }
  if (tid == 0) {
    iv[b] = i;
    jv[b] = j;
    stv[b] = st;
    donev[b] = done;
  }
}

}  // namespace

extern "C" int seqalib_band_walk(const uint8_t* ptr, int KW, int B, int Wp,
                                 int k0, int dhi, int i_floor, int32_t* iv,
                                 int32_t* jv, int32_t* stv, int32_t* donev,
                                 uint8_t* ops, void* stream) {
  if (B < 1 || Wp < 1) return (int)cudaErrorInvalidValue;
  band_walk_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      ptr, KW, B, Wp, k0, dhi, i_floor, iv, jv, stv, donev, ops);
  return (int)cudaGetLastError();
}
