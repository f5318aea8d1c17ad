// Traceback walk over one batch of the long pair's pointer tiles
// (ops/sp_walk.py), writing the ops it walks and where it stopped.
//
// Replaces no Pallas kernel: it replaces the host walk of the JAX package's
// nw_affine_align_sp (seqalib_tpu/parallel/band_pipeline.py:562-597), which
// copies every recomputed pointer tile to the host to read one byte a step.
// Here the batch stays on the card; a 20-byte header and a byte an op come
// back.
//
// Bound on the H100: the latency of one walker's chain of dependent steps.
// The bytes it reads are a vanishing share of the batch, so the time is the
// steps walked times the latency of one, plus a staging round trip to
// device memory every kSteps steps.
//
// Design: one warp per walk (strip_walk.cu's), every lane running the same
// walk, so that its reads are broadcasts from shared memory and the warp
// stays converged for the copies.  Since i and j only fall, the cells the
// walk reads in its next kSteps steps are among the kSteps x kSteps cells
// (i - a, j - b), a, b in [0, kSteps).  The warp stages them in shared
// memory, lane l the column b = l: it finds the tile and slot of its cell
// (i, j - l) once (left of a tile's column 1 lies the next tile, at the same
// slot), and from one row to the one above its byte lies a slot lower (C - 1
// past slot 0) and a byte back in the folded layout (ops/sp_tile.py), so
// each of its kSteps loads costs an add and a compare.  A lone warp pays
// for every instruction it issues: staging the block by slots instead
// (neighbouring lanes on neighbouring bytes, coalesced) takes ~27
// instructions a load and measured 2.2x slower a call.  The loads of a
// block go to registers, all issued before any is stored to shared memory,
// so the block costs one round trip.  Cells above the block top or left of the batch are not
// loaded: the walk stops before it reads them.  A step is then one
// shared-memory load at an address that moves by a row, a column or both;
// lane s keeps the op of step s, and the warp stores a block's ops with one
// coalesced store.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kStateH = 0;
constexpr int kStateE = 1;
constexpr int kStateF = 2;
// steps between two staged blocks: a lane's column of the block, and its op
constexpr int kSteps = 32;
static_assert(kSteps == 32, "a lane stages one column of the block");
constexpr int kHeader = 5;  // int32: end i, end j, end state, ops walked, error

__global__ void __launch_bounds__(32)
    sp_walk_kernel(const uint8_t* __restrict__ P, int K, int C, int rows, int i, int j,
                   int st, int i0, int j0, int32_t* __restrict__ head,
                   uint8_t* __restrict__ ops) {
  __shared__ uint8_t win[kSteps * kSteps];  // cell (i - a, j - b) at a * kSteps + b
  const int lane = threadIdx.x;
  const int lo = j0 - (K - 1) * C;  // the batch's left edge
  const size_t tile = (size_t)C * rows;
  int n = 0, err = 0;
  while (i > i0 && j > lo && !err) {
    // the walker's tile g, its column c (1-based) and row p (0-based)
    const int g = (j0 + C - j) / C;
    const int c = j - (j0 - g * C);
    const int p = i - i0 - 1;
    // lane l stages column offset b = l, row offsets a = 0 .. kSteps - 1:
    // the tile gl and slot sl of its cell (i, j - l), then a row up a load
    int cl = c - lane, gl = g;
    while (cl < 1) {
      cl += C;
      ++gl;
    }
    const bool in_batch = gl < K;  // column j - l lies right of the batch's left edge
    int sl = (p + cl - 1) % C;
    const uint8_t* src = P + (size_t)(in_batch ? gl : 0) * tile + (size_t)sl * rows + p;
    uint32_t v[kSteps];
#pragma unroll
    for (int a = 0; a < kSteps; ++a) {
      v[a] = 0;
      if (in_batch && a <= p) v[a] = __ldg(src);
      src -= rows + 1;
      if (sl == 0) src += tile;
      sl = sl == 0 ? C - 1 : sl - 1;
    }
#pragma unroll
    for (int a = 0; a < kSteps; ++a) win[a * kSteps + lane] = (uint8_t)v[a];
    __syncwarp();
    int w = 0;  // the window address of the walker's cell
    int taken = 0, mine = 0;
    for (; taken < kSteps; ++taken) {
      if (i <= i0 || j <= lo) break;
      const int byte = win[w];
      const int ph = byte & 3;
      const bool in_h = st == kStateH;
      if (in_h && ph == kPtrStop) {
        err = 1;
        break;
      }
      const bool act_m = in_h && ph == kPtrDiag;
      const bool act_i = (in_h && ph == kPtrUp) || st == kStateF;
      const bool up = act_m || act_i;
      const int op = act_m ? kOpM : (act_i ? kOpI : kOpD);
      const bool ext_e = (byte >> 2) & 1;
      const bool ext_f = (byte >> 3) & 1;
      st = act_m ? kStateH : (act_i ? (ext_f ? kStateF : kStateH) : (ext_e ? kStateE : kStateH));
      i -= up;
      j -= !act_i;
      w += (up ? kSteps : 0) + (act_i ? 0 : 1);
      mine = lane == taken ? op : mine;
    }
    if (lane < taken) ops[n + lane] = (uint8_t)mine;
    n += taken;
    __syncwarp();  // every lane has read the block before it is overwritten
  }
  if (lane == 0) {
    head[0] = i;
    head[1] = j;
    head[2] = st;
    head[3] = n;
    head[4] = err;
  }
}

}  // namespace

// P is K tiles of (C, rows) bytes; out holds the kHeader int32 fields, then
// room for rows + K * C ops (ops/sp_walk.py's out_bytes), and starts 4-byte
// aligned.  The start cell lies in the batch (the wrapper checks it).
extern "C" int seqalib_sp_walk(const uint8_t* P, int K, int C, int rows, int i, int j, int st,
                               int i0, int j0, uint8_t* out, void* stream) {
  if (K < 1 || C < 1 || rows < 1 || ((uintptr_t)out & 3)) return (int)cudaErrorInvalidValue;
  sp_walk_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(P, K, C, rows, i, j, st, i0, j0,
                                                     (int32_t*)out, out + 4 * kHeader);
  return (int)cudaGetLastError();
}
