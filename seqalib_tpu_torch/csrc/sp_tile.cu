// Gotoh tiles of ONE long pair, for the sequence-parallel pipeline
// (parallel/band_pipeline.py): a run of T consecutive tiles of one row
// block in one launch, or K independent pointer tiles of one block.
//
// Replaces seqalib_tpu/ops/sp_tile_pallas.py::_sp_tile_kernel (launched by
// sp_tile), and the XLA scans of band_pipeline.py::_tile_scan that the JAX
// package runs for the same tile in local mode and for the pointer tile of
// its traceback.  ops/sp_tile.py's docstring states the boundary protocol
// and every output.  Modes:
//   kTileGlobal  global Gotoh, capture of cell (n, m) (the Pallas kernel);
//   kTileLocal   Smith-Waterman: H clamped at 0, running max over every
//                cell with row <= n and column <= m;
//   kTilePtr     the global recurrence, emitting each cell's pointer byte
//                PTR_* | ext_e << 2 | ext_f << 3 at [(r + c - 1) % C][r]
//                of a (C, R) tile: the anti-diagonal r + c - 1 folded
//                modulo C, so the bytes of one substep are one contiguous
//                run and the tile holds R x C bytes.
// Tie-breaks are the oracle's: DIAG > UP(F) > LEFT(E), extend >= open.
//
// A run of T tiles of C columns is one R x (T * C) sweep: tile t + 1's
// left boundary is tile t's right column, and its top row is the run's,
// so the kernel sweeps W = T * C columns and writes the right column of
// every C-th one.  A pointer batch is G tiles side by side (tile g starts
// at column j0 - g * C), each from its own boundaries.
//
// Bound on the H100: latency.  An R x W sweep is a dependent wavefront of
// R + W - 1 anti-diagonals; a cell needs ~12 integer operations and the
// sweep reads and writes O(R + W) words (a byte per cell in kTilePtr), far
// below the memory and ALU rates.  The first version ran each tile as one
// CTA of 1024 threads on one SM, one tile after another, one barrier of
// 1024 threads per substep: 1 of 132 SMs did the whole pair.
//
// Design: a row-strip wavefront across CTAs.  A tile's R rows are cut into
// strips of RB rows (blockDim, a multiple of 32); each CTA owns one strip
// and sweeps all W columns, one thread per row: thread p computes column
// c = k - p + 1 at substep k, its left neighbour its own previous cell,
// the up and diagonal ones thread p - 1's through a double-buffered
// shared row, one __syncthreads of RB threads per substep.  A strip's top
// row is the bottom row of the strip above, handed over through global
// memory: the bottom thread stores H and F of each column, and every
// kChunk columns publishes its progress word with st.release; warp 0 of
// the strip below waits on that word with ld.acquire before it copies the
// next kChunk columns of the row into shared memory for thread 0.  So the
// strips run as a pipeline, strip s about RB + kChunk substeps behind
// strip s - 1, and an R x W sweep takes ~W + (R / RB) (RB + kChunk)
// substeps on ~R / RB SMs.  A CTA takes its (tile, strip) from an atomic
// ticket in launch order, not from blockIdx: it only ever waits on a
// strip whose CTA took an earlier ticket and so already runs, so the grid
// cannot deadlock at any residency.  The target letters come through a
// ring in shared memory, a kChunk of columns ahead of use, and each thread
// reads the next substep's letter before the barrier, so that no substep
// waits on a load for its score.  Scores are looked up in a shared-memory
// table; the capture and the tile's right columns are found by a compare
// with a per-thread bound and a column counter.
//
// Measured on the H100 (tools/sp_tile_sweep.py): a lone strip of 128 rows
// takes ~250 ns (~500 cycles) a substep, each further strip ~180 substeps.
// A substep is some 150 instructions (the recurrence, the checks of
// which threads and columns are live, captures and column outputs,
// address arithmetic), and with one warp per scheduler their latencies do
// not overlap (the script's --ablate times the loop without each piece).
// A warp-synchronous variant (rows handed down the lanes by shuffles, no
// block barrier, a loader warp for the row above) was no faster a substep
// and lagged more, so the barrier is not what bounds it; a leaner loop for
// the columns where every thread is live is the next step.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kSpNeg = -(1 << 28);  // ops/sp_tile.py NEG
constexpr int kTileGlobal = 0;
constexpr int kTileLocal = 1;
constexpr int kTilePtr = 2;
constexpr int kMaxRB = 1024;
constexpr int kChunk = 32;  // columns per hand-off between strips
constexpr int kRing = 2048;  // target letters kept in shared memory: > kMaxRB + kChunk

struct RunArgs {
  const int32_t* qb;    // (R,) query letters: row i0 + 1 + r at [r]
  const int32_t* tk;    // letters: column jt + x at [x]
  const int32_t* htop;  // (G, W + 1) H of row i0, corner first
  const int32_t* ftop;  // (G, W) F of row i0
  const int32_t* hcol;  // (G, R) H of each tile's left column
  const int32_t* ecol;  // (G, R) E of it
  const int32_t* table;  // (NT, NT) or null: match / mismatch
  int NT;
  int match;
  int mismatch;
  int R, W, C, G;  // rows, columns swept, tile width, tiles
  int i0, j0, jt;  // tile g covers columns j0 - g * C + 1 .. + W
  int n, m;        // capture cell / local bounds
  int gap_open;
  int gap_extend;
  int nstrip;      // strips per tile: ceil(R / blockDim)
  int32_t* hbot;   // (G, W)
  int32_t* fbot;   // (G, W)
  int32_t* hcols;  // (W / C, R): H of every C-th column (all_cols, G = 1),
  int32_t* ecols;  // else (G, R): of each tile's last; E likewise
  int all_cols;
  int32_t* cap;  // (1,) max-merged with atomicMax
  uint8_t* ptr;  // (G, C, R) or null
  int32_t* xh;   // (G, nstrip - 1, W): bottom H of every strip but the last
  int32_t* xf;
  int32_t* sync;  // [0] ticket, [1 + g * nstrip + s] columns strip s published
};

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

template <int MODE>
__global__ void __launch_bounds__(kMaxRB) sp_run_kernel(const RunArgs a) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t top_h[kChunk], top_f[kChunk];  // thread 0's row above
  __shared__ int32_t letters[kRing];  // column c's target letter at [c % kRing]
  __shared__ int32_t warp_best[kMaxRB / 32];
  __shared__ int ticket;
  const int RB = blockDim.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  int32_t* xh = smem;          // 2 * RB: H handed from row p to p + 1
  int32_t* xf = xh + 2 * RB;   // 2 * RB: F likewise
  int32_t* tab = xf + 2 * RB;  // NT * NT
  if (p == 0) ticket = atomicAdd(a.sync, 1);
  const bool use_tab = a.table != nullptr;
  const int NT = a.NT;
  const unsigned last = (unsigned)(NT - 1);
  if (use_tab)
    for (int x = p; x < NT * NT; x += RB) tab[x] = a.table[x];
  __syncthreads();

  const int g = ticket / a.nstrip;
  const int s = ticket - g * a.nstrip;
  const int R = a.R, W = a.W, C = a.C;
  const int r0 = s * RB;
  const int L = min(RB, R - r0);  // rows of this strip
  const int32_t* htop = a.htop + (size_t)g * (W + 1);
  const int32_t* ftop = a.ftop + (size_t)g * W;
  const int32_t* hcol = a.hcol + (size_t)g * R;
  const int32_t* ecol = a.ecol + (size_t)g * R;
  const int j0 = a.j0 - g * C;
  const int32_t* tk = a.tk + (j0 - a.jt);  // letter of column j0 + c at [c]
  // the row above (strip s - 1's bottom) and this strip's bottom row
  const size_t xrow = (size_t)g * (a.nstrip - 1);
  const int32_t* up_h = s > 0 ? a.xh + (xrow + s - 1) * W : nullptr;
  const int32_t* up_f = s > 0 ? a.xf + (xrow + s - 1) * W : nullptr;
  const bool bottom = s == a.nstrip - 1;
  int32_t* dn_h = bottom ? a.hbot + (size_t)g * W : a.xh + (xrow + s) * W;
  int32_t* dn_f = bottom ? a.fbot + (size_t)g * W : a.xf + (xrow + s) * W;
  const int32_t* up_done = a.sync + 1 + (size_t)g * a.nstrip + s - 1;
  int32_t* my_done = a.sync + 1 + (size_t)g * a.nstrip + s;
  uint8_t* ptr = MODE == kTilePtr ? a.ptr + (size_t)g * C * R : nullptr;

  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  const int r = r0 + p;
  const bool row = p < L;
  int qc = 0, hl = 0, el = 0, hd = 0;
  if (row) {
    qc = a.qb[r];
    if (use_tab) qc = (int)min((unsigned)qc, last);
    hl = hcol[r];  // H, E of column j0: the left neighbours of c = 1
    el = ecol[r];
    hd = r == 0 ? htop[0] : hcol[r - 1];  // the diagonal of c = 1
  }
  const int i = a.i0 + r + 1;  // global row
  // the capture's columns in this row: global the one cell (n, m), local
  // every cell with row <= n and column <= m
  const int cap_c = !row ? -1
                    : (MODE == kTileLocal ? (i <= a.n ? a.m - j0 : 0)
                                          : (i == a.n ? a.m - j0 : -1));
  int best = kSpNeg;
  int slot = r0 % C;  // (k + r0) % C: the pointer row of substep k
  int ct = 0;         // the thread's column within its tile
  int cur = 0;
  // target letters go into the ring a chunk ahead of use: warp 0 puts in
  // columns k + 33 .. k + 64 at substep k (the first chunk here), and each
  // thread reads its next substep's letter before the barrier
  auto stage_letters = [&](int c0) {
    const int col = c0 + lane;
    if (col <= W) {
      const int t = __ldg(tk + col);
      letters[col & (kRing - 1)] = use_tab ? (int)min((unsigned)t, last) : t;
    }
  };
  if (p < 32) stage_letters(1);
  __syncthreads();
  int tc = letters[(1 - p) & (kRing - 1)];  // the letter of column k - p + 1
#pragma unroll 2  // the loop's bookkeeping shared by two substeps
  for (int k = 0; k < L + W - 1; ++k) {
    if (p < 32 && k < W && k % kChunk == 0) {
      // warp 0 brings thread 0's row above for the next kChunk columns,
      // c = k + 1 .., and the letters of the kChunk columns after them
      const int cend = min(k + kChunk, W);
      const int col = k + 1 + lane;
      stage_letters(k + kChunk + 1);
      if (s > 0) {
        while (ld_acquire(up_done) < cend) {
        }
        if (col <= cend) {
          top_h[lane] = __ldcg(up_h + col - 1);
          top_f[lane] = __ldcg(up_f + col - 1);
        }
      } else if (col <= cend) {
        top_h[lane] = htop[col];
        top_f[lane] = ftop[col - 1];
      }
      __syncwarp();
    }
    const int c = k - p + 1;
    if (row && c >= 1 && c <= W) {
      int uh, uf;  // H, F of (r - 1, c)
      if (p == 0) {
        uh = top_h[k % kChunk];
        uf = top_f[k % kChunk];
      } else {
        uh = xh[(cur ^ 1) * RB + p - 1];
        uf = xf[(cur ^ 1) * RB + p - 1];
      }
      const int sc = use_tab ? tab[qc * NT + tc] : (qc == tc ? a.match : a.mismatch);
      const int e_ext = el + e, e_opn = hl + oe;
      const int f_ext = uf + e, f_opn = uh + oe;
      const int E = max(e_ext, e_opn);
      const int F = max(f_ext, f_opn);
      const int dv = hd + sc;
      int H = max(dv, max(E, F));
      if (MODE == kTileLocal) H = max(H, 0);
      if (MODE == kTilePtr) {
        int b = dv == H ? kPtrDiag : (F == H ? kPtrUp : kPtrLeft);
        b |= (e_ext >= e_opn ? 4 : 0) | (f_ext >= f_opn ? 8 : 0);
        ptr[(size_t)slot * R + r] = (uint8_t)b;
      }
      if (MODE == kTileLocal ? c <= cap_c : c == cap_c) best = max(best, H);
      if (++ct == C) ct = 0;
      if (a.all_cols ? ct == 0 : c == W) {  // a tile's right column
        const size_t o = (size_t)(a.all_cols ? c / C - 1 : g) * R;
        a.hcols[o + r] = H;
        a.ecols[o + r] = E;
      }
      if (p == L - 1) {  // the strip's bottom row, published every kChunk
        dn_h[c - 1] = H;
        dn_f[c - 1] = F;
        if (!bottom && (c % kChunk == 0 || c == W)) st_release(my_done, c);
      }
      xh[cur * RB + p] = H;
      xf[cur * RB + p] = F;
      hl = H;
      el = E;
      hd = uh;
    }
    tc = letters[(k + 2 - p) & (kRing - 1)];  // the next substep's
    __syncthreads();  // the substep is complete before the next reads it
    cur ^= 1;
    if (++slot == C) slot = 0;
  }

  for (int o = 16; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(kFull, best, o));
  if (lane == 0) warp_best[p >> 5] = best;
  __syncthreads();
  if (p == 0) {
    int v = kSpNeg;
    for (int w = 0; w < RB / 32; ++w) v = max(v, warp_best[w]);
    if (v > kSpNeg) atomicMax(a.cap, v);
  }
}

template <int MODE>
int launch(const RunArgs& a, int strip, cudaStream_t stream) {
  const size_t words = 4 * (size_t)strip + (a.table ? (size_t)a.NT * a.NT : 0);
  const size_t smem = words * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        sp_run_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  sp_run_kernel<MODE><<<a.G * a.nstrip, strip, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch: G tiles of R rows x W columns each, strips of `strip` rows.
// `sync` must hold 1 + G * ceil(R / strip) zeros; `xh`/`xf` G * (ceil(R /
// strip) - 1) * W words each.
extern "C" int seqalib_sp_run(
    const int32_t* qb, const int32_t* tk, const int32_t* htop, const int32_t* ftop,
    const int32_t* hcol, const int32_t* ecol, const int32_t* table, int NT, int match,
    int mismatch, int R, int W, int C, int G, int i0, int j0, int jt, int n, int m,
    int gap_open, int gap_extend, int mode, int strip, int32_t* hbot, int32_t* fbot,
    int32_t* hcols, int32_t* ecols, int all_cols, int32_t* cap, uint8_t* ptr,
    int32_t* xh, int32_t* xf, int32_t* sync, void* stream) {
  if (strip < 32 || strip > kMaxRB || strip % 32 != 0 || R < 1 || C < 1 || G < 1 ||
      W < 1 || (all_cols && (W % C != 0 || G != 1)) || (mode == kTilePtr && W != C))
    return (int)cudaErrorInvalidValue;
  const int nstrip = (R + strip - 1) / strip;
  const RunArgs a{qb,     tk,         htop,  ftop,   hcol,  ecol,     table, NT,
                  match,  mismatch,   R,     W,      C,     G,        i0,    j0,
                  jt,     n,          m,     gap_open, gap_extend, nstrip, hbot, fbot,
                  hcols,  ecols,      all_cols, cap, ptr,   xh,       xf,    sync};
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
