// Traceback walk over the wavefront fill's pointer stream, writing each
// pair's CIGAR text.
//
// A kernel of the port with no Pallas counterpart: it replaces the host
// walks of the JAX package's wide-table route, the native C++ walker
// (seqalib_tpu/native/__init__.py::walk_to_cigars, called from
// seqalib_tpu/ops/wavefront_pallas.py::pallas_bucket) and its NumPy
// fallback (_host_traceback_affine), and the XLA route's on-device walk
// (seqalib_tpu/ops/wavefront_xla.py::_global_walk, both branches).  The walk reads
// P[k, b, i] (K, B, Np) uint8, the byte of cell (i, j = k - i) that
// csrc/wavefront_fill.cu writes, from (i, j) = (qlen_b, tlen_b) in state H,
// runs the affine H/E/F state machine one op per step, and stops at a STOP
// pointer in state H.  The linear variant (LINEAR, for the linear-gap
// fills of backend="xla") reads only a byte's two pointer bits, so it never
// leaves state H: the JAX package's _host_traceback_linear.  The stream holds the bytes of row 0 and column 0, so
// the walk reaches (0, 0) through them: there is no implicit boundary run.
// ops/wavefront_walk.py's docstring states the outputs: the CIGAR, walked
// ops run-length encoded in start -> end order and right-aligned in the
// pair's text row, its length, and the final (i, j, st, done).
//
// Bound on the H100: the latency of the walker's chain of steps.  A step
// reads one pointer byte whose address depends on the step before; the
// stream (151 MB at the route's B=64 x 1 000, band 64) is three times the
// 50 MB L2, and successive bytes lie on diagonals B * Np bytes apart, so a
// load straight from device memory costs a DRAM latency a step.
//
// Design: one warp per pair, every lane running the same walk (its reads
// are broadcasts from shared memory, and the warp stays converged for the
// copies and the text).  In kSteps steps from (i0, j0) the walk reads cells
// with i in [i0 - kSteps + 1, i0] on diagonals [k0 - 2 kSteps + 2, k0],
// k0 = i0 + j0, since every step takes i + j down by 1 or 2 and i by 0 or
// 1.  The warp stages that tile: kRows diagonals, each the kPitch bytes
// from the 16-byte segment at or below slot i0 - kSteps + 1 (Np is a
// multiple of 16 and P 16-byte aligned, so a segment that starts inside a
// stream row ends inside it), with one round of 16-byte cp.async copies,
// and waits for it.  Tile row r holds diagonal k0 - r, so a step's byte
// moves by a constant in shared memory: M by 2 rows less a byte, I by a row
// less a byte, D by a row.  Every kSteps steps the warp stages the tile
// where the walker stands.  Finished runs are written by the Text of
// common.cuh (as strip_walk.cu writes them).  A start cell outside the
// stream (i or j < 0, i >= Np or i + j >= K) walks nothing and gets
// nchar = -1: the range check is deferred to the caller's host copy.  A
// walk that would leave the matrix (i or j < 0; the fill's streams never
// lead there) stops there with done = 0.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kStateH = 0;
constexpr int kStateE = 1;
constexpr int kStateF = 2;
constexpr int kBadStart = -1;
constexpr int kSteps = 32;          // steps between two staged tiles
constexpr int kRows = 2 * kSteps;   // diagonals of a tile (2 kSteps - 1 read)
constexpr int kSegs = 3;            // 16-byte segments of a tile row
constexpr int kPitch = 16 * kSegs;  // kSteps slots from any phase of a segment

// Stage the tile of the walker at (k0 = i + j, slots from ilo on, ilo a
// multiple of 16): tile row r holds P[k0 - r, b, ilo : ilo + kPitch] where
// k0 - r >= 0 and the segment starts below Np.  Committed as one group.
__device__ __forceinline__ void stage(uint8_t* sb, const uint8_t* P, int B, int Np, int b,
                                      int k0, int ilo, int lane) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sb);
  for (int e = lane; e < kRows * kSegs; e += 32) {
    const int r = e / kSegs;
    const int c = ilo + 16 * (e - r * kSegs);
    const int k = k0 - r;
    if (k < 0 || c >= Np) continue;
    cp_async_16(base + r * kPitch + (c - ilo), P + ((size_t)k * B + b) * Np + c, 16);
  }
  cp_async_commit();
}

template <bool LINEAR>
__global__ void __launch_bounds__(32)
    wavefront_walk_kernel(const uint8_t* __restrict__ P, int K, int B, int Np,
                          const int32_t* __restrict__ iv, const int32_t* __restrict__ jv,
                          uint8_t* __restrict__ text, int L, int32_t* __restrict__ nchar,
                          int32_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t buf[kRows * kPitch];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  int i = iv[b], j = jv[b], st = kStateH, done = 0;
  if (i < 0 || j < 0 || i >= Np || i + j >= K) {
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
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(buf);
  bool left = false;  // the walk left the matrix
  for (;;) {
    const int ilo = max(0, i - (kSteps - 1)) & ~15;
    stage(buf, P, B, Np, b, i + j, ilo, lane);
    cp_async_wait_all();
    __syncwarp();
    uint32_t a = base + (i - ilo);  // the byte of (i, j): tile row 0
    for (int s = 0; s < kSteps; ++s) {
      const int byte = LINEAR ? lds_u8(a) & 3 : lds_u8(a);
      const int ph = byte & 3;
      const bool in_h = st == kStateH;
      if (in_h && ph == kPtrStop) {
        done = 1;
        break;
      }
      const bool act_m = in_h && ph == kPtrDiag;
      const bool act_i = !act_m && ((in_h && ph == kPtrUp) || st == kStateF);
      const bool ext_e = (byte >> 2) & 1;
      const bool ext_f = (byte >> 3) & 1;
      st = act_m ? kStateH
                 : (act_i ? (ext_f ? kStateF : kStateH) : (ext_e ? kStateE : kStateH));
      const int op = act_m ? kOpM : (act_i ? kOpI : kOpD);
      i -= act_m || act_i;
      j -= !act_i;  // M and D consume the target
      a += act_m ? 2 * kPitch - 1 : (act_i ? kPitch - 1 : kPitch);
      tx.push(run_op, run_len, op != run_op && run_len > 0);
      run_len = op == run_op ? run_len + 1 : 1;
      run_op = op;
      if (i < 0 || j < 0) {
        left = true;
        break;
      }
    }
    if (done || left) break;
    __syncwarp();  // every lane has read the tile before it is overwritten
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

// P (K, B, Np) must be 16-byte aligned with Np a multiple of 16;
// L >= 2 * K (ops/wavefront_walk.py's text_width); linear: the linear variant.
extern "C" int seqalib_wavefront_walk(const uint8_t* P, int K, int B, int Np,
                                      const int32_t* iv, const int32_t* jv, uint8_t* text,
                                      int L, int32_t* nchar, int32_t* out, int linear,
                                      void* stream) {
  if (B < 1 || K < 1 || (Np & 15) || ((uintptr_t)P & 15)) return (int)cudaErrorInvalidValue;
  auto kernel = linear ? wavefront_walk_kernel<true> : wavefront_walk_kernel<false>;
  kernel<<<B, 32, 0, (cudaStream_t)stream>>>(P, K, B, Np, iv, jv, text, L, nchar, out);
  return (int)cudaGetLastError();
}
