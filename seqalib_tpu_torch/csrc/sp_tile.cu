// One R x C Gotoh tile of ONE long pair, for the sequence-parallel
// pipeline (parallel/band_pipeline.py).
//
// Replaces seqalib_tpu/ops/sp_tile_pallas.py::_sp_tile_kernel (launched by
// sp_tile), and the XLA scans of band_pipeline.py::_tile_scan that the JAX
// package runs for the same tile in local mode and for the pointer tile of
// its traceback.  ops/sp_tile.py's docstring states the boundary protocol
// and every output.  Modes:
//   kTileGlobal  global Gotoh, capture of cell (n, m) by the tile that owns
//                column m (the Pallas kernel);
//   kTileLocal   Smith-Waterman: H clamped at 0, running max over every
//                cell with row <= n and column <= m;
//   kTilePtr     the global recurrence, emitting each cell's pointer byte
//                PTR_* | ext_e << 2 | ext_f << 3 at [(r + c - 1) % C][r]
//                of a (C, R) tile: the anti-diagonal r + c - 1 folded
//                modulo C, so the bytes of one substep are one contiguous
//                run (one store per warp; a row-major tile costs each warp
//                32 lines per substep) and the tile holds R x C bytes.
// Tie-breaks are the oracle's: DIAG > UP(F) > LEFT(E), extend >= open.
//
// Bound on the H100: latency.  A tile is one dependent wavefront of
// R + C - 1 anti-diagonals per strip; a cell needs ~12 integer operations
// (~45 issued instructions with addresses and shared-memory traffic, which
// set a substep's time on the SM's four schedulers) and the tile reads
// and writes O(R + C) words (the pointer mode writes one byte per cell),
// far below the memory and ALU rates.  One long pair at one device is a
// chain of tiles, each one CTA on one SM.
//
// Design: one CTA per tile, one thread per row of a strip of blockDim
// rows (the TPU's flat SUB x 128 strip).  Thread p computes column
// c = k - p + 1 at substep k, so its left neighbour is its own previous
// cell (registers), and the up and diagonal neighbours are thread p - 1's
// cells of the two substeps before: the up one comes through a
// double-buffered shared-memory row, the diagonal one is the up value the
// thread read one substep earlier.  One __syncthreads closes a substep.
// The row above the strip (H and F, corner first) and the tile's target
// letters sit in shared memory; the strip's last row overwrites that row
// in place as it goes (column c is rewritten RB - 1 substeps after thread
// 0 read it), so the next strip starts from it, its corner refreshed to
// H(last row, j0), as the Pallas kernel does with its scratch rows.  Slots
// outside the tile (c < 1 or c > C) are skipped: they never feed a cell of
// the tile.  Letters are looked up in a shared-memory table; the TPU's
// packed-nibble profile, lane rolls and sublane carries are not needed.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kSpNeg = -(1 << 28);  // ops/sp_tile.py NEG
constexpr int kTileGlobal = 0;
constexpr int kTileLocal = 1;
constexpr int kTilePtr = 2;

struct TileArgs {
  const int32_t* qb;    // (R,) query letters of the block
  const int32_t* tk;    // (C + 1,) tk[c] = letter of column j0 + c
  const int32_t* htop;  // (C + 1,) H of row i0, corner first
  const int32_t* ftop;  // (C,) F of row i0 at columns j0 + 1 ..
  const int32_t* hcol;  // (R,) H of column j0
  const int32_t* ecol;  // (R,) E of column j0
  const int32_t* cap_in;  // (1,)
  const int32_t* table;   // (NT, NT) or null: match / mismatch
  int NT;
  int match;
  int mismatch;
  int R, C;
  int i0, j0;  // rows i0 + 1 .., columns j0 + 1 ..
  int n, m;    // capture cell / local bounds
  int gap_open;
  int gap_extend;
  int32_t* hbot;      // (C,)
  int32_t* fbot;      // (C,)
  int32_t* hcol_out;  // (R,)
  int32_t* ecol_out;  // (R,)
  int32_t* cap_out;   // (1,)
  uint8_t* ptr;       // (C, R) or null
};

template <int MODE>
__global__ void __launch_bounds__(1024) sp_tile_kernel(const TileArgs a) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t warp_best[32];
  const int C = a.C;
  const int RB = blockDim.x;
  int32_t* top_h = smem;           // C + 1: H of the row above the strip
  int32_t* top_f = top_h + C + 1;  // C + 1: F of that row (index c)
  int32_t* tl = top_f + C + 1;     // C + 1: target letters
  int32_t* xh = tl + C + 1;        // 2 * RB: H handed from row p to p + 1
  int32_t* xf = xh + 2 * RB;       // 2 * RB: F likewise
  int32_t* tab = xf + 2 * RB;      // NT * NT

  const int p = threadIdx.x;
  const bool use_tab = a.table != nullptr;
  const int NT = a.NT;
  const unsigned last = (unsigned)(NT - 1);
  for (int x = p; x <= C; x += RB) {
    top_h[x] = a.htop[x];
    top_f[x] = x >= 1 ? a.ftop[x - 1] : kSpNeg;
    const int t = a.tk[x];
    tl[x] = use_tab ? (int)min((unsigned)t, last) : t;
  }
  if (use_tab)
    for (int x = p; x < NT * NT; x += RB) tab[x] = a.table[x];
  __syncthreads();

  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  int best = kSpNeg;
  for (int r0 = 0; r0 < a.R; r0 += RB) {
    const int L = min(RB, a.R - r0);  // rows of this strip
    const int r = r0 + p;
    const bool row = p < L;
    int qc = 0, hl = 0, el = 0, hd = 0;
    int slot = r0 % C;  // (k + r0) % C: the pointer row of substep k
    if (row) {
      qc = a.qb[r];
      if (use_tab) qc = (int)min((unsigned)qc, last);
      hl = a.hcol[r];  // H, E of column j0: the left neighbours of c = 1
      el = a.ecol[r];
      hd = p == 0 ? top_h[0] : a.hcol[r - 1];  // the diagonal of c = 1
    }
    const int i = a.i0 + r + 1;  // global row
    int cur = 0;
    for (int k = 0; k < L + C - 1; ++k) {
      const int c = k - p + 1;
      if (row && c >= 1 && c <= C) {
        int uh, uf;  // H, F of (r - 1, c)
        if (p == 0) {
          uh = top_h[c];
          uf = top_f[c];
        } else {
          uh = xh[(cur ^ 1) * RB + p - 1];
          uf = xf[(cur ^ 1) * RB + p - 1];
        }
        const int tc = tl[c];
        const int s = use_tab ? tab[qc * NT + tc] : (qc == tc ? a.match : a.mismatch);
        const int e_ext = el + e, e_opn = hl + oe;
        const int f_ext = uf + e, f_opn = uh + oe;
        const int E = max(e_ext, e_opn);
        const int F = max(f_ext, f_opn);
        const int dv = hd + s;
        int H = max(dv, max(E, F));
        if (MODE == kTileLocal) H = max(H, 0);
        if (MODE == kTilePtr) {
          int b = dv == H ? kPtrDiag : (F == H ? kPtrUp : kPtrLeft);
          b |= (e_ext >= e_opn ? 4 : 0) | (f_ext >= f_opn ? 8 : 0);
          a.ptr[(size_t)slot * a.R + r] = (uint8_t)b;
        }
        const int j = a.j0 + c;
        const bool hit = MODE == kTileLocal ? (i <= a.n && j <= a.m)
                                            : (i == a.n && j == a.m);
        if (hit) best = max(best, H);
        if (c == C) {
          a.hcol_out[r] = H;
          a.ecol_out[r] = E;
        }
        if (p == L - 1) {  // the next strip's top row, in place
          top_h[c] = H;
          top_f[c] = F;
        }
        xh[cur * RB + p] = H;
        xf[cur * RB + p] = F;
        hl = H;
        el = E;
        hd = uh;
      }
      __syncthreads();  // the substep is complete before the next reads it
      cur ^= 1;
      if (++slot == C) slot = 0;
    }
    if (p == 0) top_h[0] = a.hcol[r0 + L - 1];  // the next strip's corner
    __syncthreads();
  }

  for (int c = 1 + p; c <= C; c += RB) {
    a.hbot[c - 1] = top_h[c];
    a.fbot[c - 1] = top_f[c];
  }
  for (int o = 16; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(kFull, best, o));
  if ((p & 31) == 0) warp_best[p >> 5] = best;
  __syncthreads();
  if (p == 0) {
    int v = a.cap_in[0];
    for (int w = 0; w < RB / 32; ++w) v = max(v, warp_best[w]);
    a.cap_out[0] = v;
  }
}

template <int MODE>
int launch(const TileArgs& a, int strip, cudaStream_t stream) {
  const size_t words = 3 * (size_t)(a.C + 1) + 4 * (size_t)strip +
                       (a.table ? (size_t)a.NT * a.NT : 0);
  const size_t smem = words * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        sp_tile_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  sp_tile_kernel<MODE><<<1, strip, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seqalib_sp_tile(
    const int32_t* qb, const int32_t* tk, const int32_t* htop,
    const int32_t* ftop, const int32_t* hcol, const int32_t* ecol,
    const int32_t* cap_in, const int32_t* table, int NT, int match,
    int mismatch, int R, int C, int i0, int j0, int n, int m, int gap_open,
    int gap_extend, int mode, int strip, int32_t* hbot, int32_t* fbot,
    int32_t* hcol_out, int32_t* ecol_out, int32_t* cap_out, uint8_t* ptr,
    void* stream) {
  if (strip < 32 || strip > 1024 || strip % 32 != 0 || R < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const TileArgs a{qb,       tk,   htop,     ftop,       hcol,     ecol,
                   cap_in,   table, NT,      match,      mismatch, R,
                   C,        i0,   j0,       n,          m,        gap_open,
                   gap_extend, hbot, fbot,   hcol_out,   ecol_out, cap_out,
                   ptr};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kTileGlobal:
      return launch<kTileGlobal>(a, strip, s);
    case kTileLocal:
      return launch<kTileLocal>(a, strip, s);
    case kTilePtr:
      return launch<kTilePtr>(a, strip, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
