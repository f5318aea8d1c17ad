// Full-matrix anti-diagonal wavefront in every mode of the TPU kernel:
// global or local, affine or linear gaps, with a band mask or none, with
// every cell's pointer or score-only (local score-only with start
// propagation).
//
// Replaces seqalib_tpu/ops/wavefront_pallas.py::_fill_kernel (launched by
// _fill).  Two routes reach it: pallas_bucket's banded branch for
// substitution tables outside the packed-nibble range (global, affine,
// band mask) and backend="xla" (ops/wavefront_xla.py: unbanded global and
// local fills, linear or affine, and global banded ones).
// ops/wavefront.py's docstring states the layout, the inputs, the outputs
// and the departures from the TPU kernel.
// Tie-breaks are the oracle's: DIAG > UP(F) > LEFT(E), extend >= open.
//
// Bound on the H100: the cells' integer operations (5-15 a cell by mode,
// chip_smoke.py's OPS_PER_CELL) along each pair's chain of anti-diagonals,
// and in pointer mode the K x B x Np bytes of the pointer stream.  The TPU
// kernel computes every slot of every diagonal (a TPU works on whole
// vectors); a kernel here computes only what an output reads.  Five
// kernels, by mode (ops/wavefront.py::fill_kernel):
//
// - wf_strip_kernel<LOCAL, AFFINE>: every unbanded score-only fill (the
//   "xla" route's local pass (a), its global score-only calls).  No output
//   reads a slot outside the valid box: the per-row bests are taken over
//   1 <= i <= qlen, 1 <= j <= tlen, i + j < K, the score at (qlen, tlen).
//   So it computes the box alone, rows 1 .. min(qlen, Np - 1) and columns
//   0 .. min(tlen, K - 1), with strip_fill.cu's design: one CTA of W warps
//   per pair (ops/wavefront.py::wavefront_strip_warps), warp w running
//   strips w, w + W, ... of 32 rows, a lane per row; at step k lane p
//   computes cell (i0 + p + 1, k - p), its up and diagonal neighbours (H,
//   F and in local mode their start cells) from lane p - 1 by shuffles,
//   its left one in its own registers; lane 0 reads the row above from a
//   ring of kStripRing columns in shared memory that the warp above's lane
//   31 writes and publishes with st.release / ld.acquire counters (round r,
//   column c is counter r * S + c: a ring slot reused across rounds cannot
//   race); warp W - 1 hands its bottom row to warp 0 of the next round
//   through a wrap row (shared memory while it fits, else the global
//   scratch `rows`).  State and the row's best, its first k and its start
//   stay in registers; a row's bests are written once, when its strip
//   ends.  Boundaries are the window kernel's: local edges 0 (a STOP
//   starting at the cell), global linear k * e, global affine a gap's
//   o + e + (x - 1) * max(e, o + e) (the TPU kernel derives column 0 from
//   the slots with j < 0, which agree while they stay below it:
//   ops/wavefront.py); E of column 0 is -inf.  The window kernel it replaces for
//   these modes (a thread per slot of all Np, a barrier and global letter
//   loads per diagonal, the bests read and written in global memory) took
//   14.18 ms for config 3's pass (a) on an H100 80GB HBM3 at 700 W; this
//   design 1.09 ms against its 0.449 ms bound: a strip's steps form a
//   chain, local affine mode issues ~40 instructions a step (17 global
//   affine), and the start propagation (two more shuffles and their
//   selects) takes about a quarter of its time, the hand-off between warps
//   another.  The start cell and the best are chosen by selects: as a
//   branch they made the compiler check every shuffle for divergence
//   (1.29 ms).
// - wf_strip_ptr_kernel<AFFINE>: every unbanded global fill with pointers
//   (the "xla" route's global fills with CIGARs, linear or affine, and its
//   local pass (c)).  Here every byte of the (K, B, Np) stream is an
//   output, the slots with j < 0, i > qlen and j > tlen included, and the
//   slots with j < 0 form a closed DP seeded at -2^30 (target letter 0)
//   that global affine mode's column 0 reads (its E, extend bit and
//   diagonal): so it computes every slot of every diagonal, in order, with
//   the strip design turned to diagonals: one CTA of W <= 8 warps per pair
//   (ops/wavefront.py::wavefront_strip_ptr_warps), warp w running strips w,
//   w + W, ... of 32 slots, a lane per slot, all lanes of a strip on one
//   diagonal at each step (lane p on cell (i0 + p, k - i0 - p)), so that a
//   strip's 32 bytes of a diagonal are one contiguous store; up and
//   diagonal neighbours by shuffles, the left one in registers, the slot
//   above a strip from the strip above through a ring (a wrap row, two in
//   turns, between rounds), as wf_strip_kernel hands columns over.  Chunks
//   of 32 diagonals run with no checks where every j < 0 (one letter
//   score a lane: target letter 0) or every j >= 1 (linear row 0 by a
//   select on strip 0); column 0, the last partial chunk and the score's
//   cell take a checked loop; a strip of 32 live slots stores with no
//   predicate, through a pointer stepped a diagonal at a time, and its
//   waits pause between polls.  Its boundaries, origin, sentinel letters
//   and -2^30 seeds are wavefront_fill_ref's, line for line.  The window
//   kernel it replaces for these modes (a thread per slot, a barrier and
//   global letter loads per diagonal) took 1.385-1.389 ms for config 3's
//   pass (c) and 0.522-0.526 ms for config 1 on an H100 80GB HBM3 at 700 W;
//   this design ~0.41 and ~0.15 ms against bounds of 0.071 and 0.031 (the
//   stream's bytes): a step issues ~32 instructions affine, ~22 linear,
//   and without the stream's stores the fill takes ~0.29 / 0.11 ms
//   (PERF.md).
// - wf_far_kernel, pointer mode with a band only: the pointer byte of every
//   slot whose inputs are all -inf (d = k - 2i outside [dlo - 1, dhi + 1]
//   of a band) depends on its letters alone (the far rule of each mode,
//   ops/wavefront.py::wavefront_far_bytes_ref; global affine:
//     (s >= max(e, o + e) ? DIAG : UP) | (e >= o + e) << 2 | (e >= o + e) << 3),
//   written for every (k, b, i) with no DP state; a CTA stages a rule table
//   (one byte per letter pair) and the target letters of its tile of
//   diagonals and slots in shared memory, each thread keeps 16 slots' query
//   rows in registers and stores 16 bytes at a time.  It moves the stream's
//   bytes (151 MB at the wide-table shape, K 2049 x B 64 x Np 1152).
// - wf_band_kernel<PTR>, the banded global affine window (the wide-table
//   route): wf_window_kernel's design and loop for that mode, taking an
//   argument struct of only the fields it reads (BandArgs: 2.4% / 6.8%
//   faster, pointers / score-only, than the same loop given WfArgs).
// - wf_window_kernel<LOCAL, AFFINE, BANDED, PTR>, every other mode (local
//   pointers with no band, a band in local or linear mode; no entry point
//   launches them), one CTA per pair: only
//   the slots i in [lo(k), hi(k)], d
//   in [dlo - 1, dhi + 1] (about band + |delta| / 2 + 2 of them), or every
//   slot with no band (then there is no far pass: the window writes every
//   byte), carry state; it writes their bytes and captures H(qlen, tlen),
//   or in local mode updates each valid cell's slot best (bv, bk, bs in
//   global memory, one owner per slot and diagonal).  One thread per
//   window slot (at most 1024, looping past that); the slot rows sit in a
//   ring of R >= window + 2 slots indexed by i mod R (rows read at slot
//   i - 1 double buffered, the others in place: 3 linear, 6 affine, twice
//   that for the start cells of banded local score-only), in shared memory
//   while it fits, else in the global scratch `rows`; one barrier per
//   diagonal.  Any band (up to every slot) and any delta fit: the ring
//   grows with the window, never capped.
// Letters are scored from a shared-memory table whose sentinel entries
// score as the TPU kernel's route scored them.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kFarThreads = 256;
constexpr int kFarRun = 16;          // slots per thread in wf_far_kernel
constexpr int kFarK = 64;            // diagonals per CTA in wf_far_kernel

struct WfArgs {
  const int32_t* qpad;  // (B, Np) query letters, slot i at [i]
  int Np;
  const int32_t* tk;  // (B, Kw) target letters, column j at [j]
  int Kw;
  const int32_t* qlen;  // (B,)
  const int32_t* tlen;
  const int32_t* table;  // (NT, NT)
  int NT;
  int B;
  int K;  // diagonals [0, K)
  int band;
  int gap_open;
  int gap_extend;
  int local;   // mode flags, as the window kernel's template arguments
  int affine;
  int banded;
  int stride;      // local score-only: a start cell packs as i * stride + j
  int32_t* score;  // (B,) out (global): H(qlen, tlen); zeroed by the wrapper
  int32_t* bv;     // (B, Np) out (local): slot bests, first k, start; zeroed
  int32_t* bk;
  int32_t* bs;     // or null (local with pointers)
  uint8_t* ptr;    // (K, B, Np) or null
  int R;           // ring slots of the window, a power of 2
  int32_t* rows;   // (B, rows, R) scratch of the ring, or null (shared)
};

// a CTA: kFarK diagonals x G * kFarRun slots; thread t takes the run of
// slots t % G on every (blockDim / G)-th diagonal from t / G
__global__ void __launch_bounds__(kFarThreads) wf_far_kernel(const WfArgs a, int nkc,
                                                             int nic, int G) {
  extern __shared__ __align__(16) uint8_t fsm[];
  const int NT = a.NT;
  const int TI = G * kFarRun;
  uint8_t* rule = fsm;                         // NT * NT
  uint8_t* tw = fsm + ((NT * NT + 15) & ~15);  // TI + kFarK - 1
  const int ic = blockIdx.x % nic;
  const int rest = blockIdx.x / nic;
  const int kc = rest % nkc;
  const int b = rest / nkc;
  const int k0 = kc * kFarK;
  const int i0c = ic * TI;
  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  // -inf neighbours: the diagonal move wins on s >= the gaps' best (UP on
  // a tie of the two gaps); a local best is <= 0: STOP
  const int thr = a.affine ? max(e, oe) : e;
  const int ext = a.affine && e >= oe ? 12 : 0;
  const bool glin = !a.local && !a.affine;  // row 0 LEFT, column 0 UP
  const unsigned last = (unsigned)(NT - 1);
  for (int x = threadIdx.x; x < NT * NT; x += blockDim.x) {
    rule[x] = (uint8_t)((a.local ? kPtrStop : (a.table[x] >= thr ? kPtrDiag : kPtrUp)) | ext);
  }
  // target letters of columns [jb, jb + TI + kFarK - 1)
  const int jb = k0 - i0c - TI + 1;
  const int32_t* tb = a.tk + (size_t)b * a.Kw;
  for (int x = threadIdx.x; x < TI + kFarK - 1; x += blockDim.x) {
    const int j = jb + x;
    tw[x] = (uint8_t)(j < 0 ? 0u : (j < a.Kw ? min((unsigned)__ldg(tb + j), last) : last));
  }
  __syncthreads();
  const int rows = blockDim.x / G;
  const int r0 = threadIdx.x / G;
  const int i = i0c + kFarRun * (threadIdx.x - r0 * G);
  if (r0 >= rows || i >= a.Np) return;
  const int32_t* qb = a.qpad + (size_t)b * a.Np;
  int qo[kFarRun];
#pragma unroll
  for (int x = 0; x < kFarRun; ++x) {
    qo[x] = i + x < a.Np ? (int)min((unsigned)__ldg(qb + i + x), last) * NT : 0;
  }
  const bool whole = (a.Np & 15) == 0;  // 16-byte aligned runs
  const int k1 = min(k0 + kFarK, a.K);
  for (int k = k0 + r0; k < k1; k += rows) {
    const uint8_t* tx = tw + (k - i - jb);  // column k - i - x at tx[-x]
    uint32_t word[kFarRun / 4];
#pragma unroll
    for (int w = 0; w < kFarRun / 4; ++w) {
      uint32_t v = 0;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int x = 4 * w + y;
        v |= (uint32_t)rule[qo[x] + tx[-x]] << (8 * y);
      }
      word[w] = v;
    }
    // the boundary bytes: the origin, and global linear's row 0 and column 0
    if (i == 0 || (glin && k >= i && k < i + kFarRun)) {
#pragma unroll
      for (int x = 0; x < kFarRun; ++x) {
        const int sh = 8 * (x & 3);
        uint32_t v = (word[x >> 2] >> sh) & 0xffu;
        if (glin && k > 0 && i + x == 0) v = kPtrLeft;
        if (glin && k > 0 && i + x == k) v = kPtrUp;
        if (k == 0 && i + x == 0) v = (uint32_t)(kPtrStop | ext);
        word[x >> 2] = (word[x >> 2] & ~(0xffu << sh)) | (v << sh);
      }
    }
    uint8_t* out = a.ptr + ((size_t)k * a.B + b) * a.Np + i;
    if (whole) {
      *reinterpret_cast<uint4*>(out) = make_uint4(word[0], word[1], word[2], word[3]);
    } else {
      for (int x = 0; x < kFarRun && i + x < a.Np; ++x) {
        out[x] = (uint8_t)(word[x >> 2] >> (8 * (x & 3)));
      }
    }
  }
}

// the pair's band: dlo <= j - i <= dhi
struct Band {
  int qlen, tlen, dlo, dhi, fin;
  template <class Args>
  __device__ Band(const Args& a, int b) {
    qlen = a.qlen[b];
    tlen = a.tlen[b];
    const int delta = tlen - qlen;
    dlo = min(0, delta) - a.band;
    dhi = max(0, delta) + a.band;
    fin = qlen + tlen;
  }
  // the window: slots with k - 2i in [dlo - 1, dhi + 1]
  __device__ int lo(int k) const { return max(0, floordiv2(k - dhi)); }
  __device__ int hi(int k) const { return floordiv2(k - dlo + 1); }
};

// slot rows of the window's ring (ops/wavefront.py::window_rows)
template <bool LOCAL, bool AFFINE, bool PTR>
__host__ __device__ constexpr int ring_rows() {
  return (AFFINE ? 6 : 3) * (LOCAL && !PTR ? 2 : 1);
}

template <bool LOCAL, bool AFFINE, bool BANDED, bool PTR>
__global__ void __launch_bounds__(1024) wf_window_kernel(const WfArgs a) {
  constexpr bool TRACK = LOCAL && !PTR;  // start propagation
  extern __shared__ int32_t smem[];
  const int NT = a.NT;
  const int Np = a.Np;
  const int R = a.R;
  const int b = blockIdx.x;
  const int nthr = blockDim.x;
  const unsigned last = (unsigned)(NT - 1);
  int32_t* tab = smem;
  int32_t* st = a.rows ? a.rows + (size_t)b * ring_rows<LOCAL, AFFINE, PTR>() * R
                       : tab + NT * NT;
  // rows read at slot i - 1 are double buffered (alternating diagonals),
  // the others are read and written at the own slot
  int32_t* Hb = st;          // 2 rows: H
  int32_t* Ur = st + 2 * R;  // H(k - 2) at slot i - 1, kept at slot i
  int32_t* Fb = st + 3 * R;  // affine, 2 rows: F
  int32_t* Er = st + 5 * R;  // affine: E
  int32_t* S = st + (AFFINE ? 6 : 3) * R;
  int32_t* SHb = S;          // local score-only, 2 rows: start cell of H
  int32_t* SUr = S + 2 * R;  // start cell of Ur
  int32_t* SFb = S + 3 * R;  // affine, 2 rows: start cell of F
  int32_t* SEr = S + 5 * R;  // affine: start cell of E
  for (int x = threadIdx.x; x < NT * NT; x += nthr) tab[x] = a.table[x];
  __syncthreads();

  const Band bd(a, b);
  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  const int32_t* qb = a.qpad + (size_t)b * Np;
  const int32_t* tb = a.tk + (size_t)b * a.Kw;
  int32_t* bvb = LOCAL ? a.bv + (size_t)b * Np : nullptr;
  int32_t* bkb = LOCAL ? a.bk + (size_t)b * Np : nullptr;
  int32_t* bsb = TRACK ? a.bs + (size_t)b * Np : nullptr;
  int plo = 0, phi = -1;  // the previous diagonal's window
  for (int k = 0; k < a.K; ++k) {
    const int ilo = BANDED ? bd.lo(k) : 0;
    const int ihi = BANDED ? min(Np - 1, bd.hi(k)) : Np - 1;
    const int cur = k & 1;
    const int32_t* H1 = Hb + (cur ^ 1) * R;
    const int32_t* F1 = Fb + (cur ^ 1) * R;
    const int32_t* SH1 = SHb + (cur ^ 1) * R;
    const int32_t* SF1 = SFb + (cur ^ 1) * R;
    int32_t* Hn = Hb + cur * R;
    int32_t* Fn = Fb + cur * R;
    int32_t* SHn = SHb + cur * R;
    int32_t* SFn = SFb + cur * R;
    uint8_t* out = PTR ? a.ptr + ((size_t)k * a.B + b) * Np : nullptr;
    for (int i = ilo + threadIdx.x; i <= ihi; i += nthr) {
      const int r = i & (R - 1);
      const int rd = (i - 1) & (R - 1);
      const bool in1 = i >= plo && i <= phi;          // slot i on k - 1
      const bool in0 = i - 1 >= plo && i - 1 <= phi;  // slot i - 1 on k - 1
      const int j = k - i;
      const unsigned qc = min((unsigned)__ldg(qb + i), last);
      const unsigned tc = j < 0 ? 0u : min((unsigned)__ldg(tb + j), last);
      // loads in this order: on an H100 the banded global affine fill ran
      // ~10% faster than with H(i, j - 1) and the diagonal's read first
      const int Hu = in0 ? H1[rd] : kNegInf;  // (i - 1, j)
      const int Fu = AFFINE && in0 ? F1[rd] : kNegInf;
      const int sc = tab[qc * NT + tc];
      const int Hd = in1 ? Ur[r] : kNegInf;  // (i - 1, j - 1)
      const int Hl = in1 ? H1[r] : kNegInf;  // (i, j - 1)
      const int El = AFFINE && in1 ? Er[r] : kNegInf;
      const int d = Hd + sc;
      int E = 0, F = 0, best, p;
      bool ext_e = false, ext_f = false;
      if (AFFINE) {
        E = __vibmax_s32(El + e, Hl + oe, &ext_e);
        F = __vibmax_s32(Fu + e, Hu + oe, &ext_f);
        best = __vimax3_s32(d, F, E);
        p = d == best ? kPtrDiag : (F == best ? kPtrUp : kPtrLeft);
      } else {
        const int u = Hu + e, l = Hl + e;
        best = __vimax3_s32(d, u, l);
        p = d == best ? kPtrDiag : (u == best ? kPtrUp : kPtrLeft);
      }
      int H = best;
      if (LOCAL && best <= 0) {
        H = 0;
        p = kPtrStop;
      }
      // boundaries: i == 0 is cell (0, k), i == k cell (k, 0)
      const bool edge = i == 0 || i == k;
      if (!AFFINE && edge) {
        H = LOCAL ? 0 : k * e;
        p = LOCAL || k == 0 ? kPtrStop : (i == 0 ? kPtrLeft : kPtrUp);
      }
      if (AFFINE && ((LOCAL && edge) || (k == 0 && i == 0))) {
        H = 0;
        p = kPtrStop;
      }
      if (AFFINE && LOCAL && i == k) E = kNegInf;  // the oracle's E of column 0
      int sh = 0;
      if (TRACK) {
        const int sh1 = in1 ? SH1[r] : 0;    // start of (i, j - 1)
        const int shu = in0 ? SH1[rd] : 0;   // start of (i - 1, j)
        const int shd = in1 ? SUr[r] : 0;    // start of (i - 1, j - 1)
        if (AFFINE) {
          const int se = ext_e ? (in1 ? SEr[r] : 0) : sh1;
          const int sf = ext_f ? (in0 ? SF1[rd] : 0) : shu;
          sh = p == kPtrDiag ? shd : (p == kPtrUp ? sf : se);
          SEr[r] = se;
          SFn[r] = sf;
        } else {
          sh = p == kPtrDiag ? shd : (p == kPtrUp ? shu : sh1);
        }
        if (p == kPtrStop) sh = i * a.stride + j;
        SHn[r] = sh;
        SUr[r] = shu;
      }
      if (BANDED) {
        const int dkj = k - 2 * i;
        if (dkj < bd.dlo || dkj > bd.dhi) H = E = F = kNegInf;
      }
      Hn[r] = H;
      if (AFFINE) {
        Fn[r] = F;
        Er[r] = E;
      }
      Ur[r] = Hu;
      if (PTR) out[i] = (uint8_t)(p | (ext_e ? 4 : 0) | (ext_f ? 8 : 0));
      if (LOCAL) {
        if (i >= 1 && i <= bd.qlen && j >= 1 && j <= bd.tlen && H > bvb[i]) {
          bvb[i] = H;
          bkb[i] = k;
          if (TRACK) bsb[i] = sh;
        }
      } else if (k == bd.fin && i == bd.qlen) {
        a.score[b] = H;
      }
    }
    plo = ilo;
    phi = ihi;
    __syncthreads();  // the diagonal is complete before the next reads it
  }
}

// ---- the banded global affine window (the wide-table route) --------------

// Its own kernel argument, only the fields it reads: passed the whole
// WfArgs (every mode's fields), the same loop ran 2.4% (pointers) and 6.8%
// (score-only) slower on an H100 80GB HBM3 at 700 W, in turns.
struct BandArgs {
  const int32_t* qpad;  // (B, Np) query letters, slot i at [i]
  int Np;
  const int32_t* tk;  // (B, Kw) target letters, column j at [j]
  int Kw;
  const int32_t* qlen;  // (B,)
  const int32_t* tlen;
  const int32_t* table;  // (NT, NT)
  int NT;
  int B;
  int K;  // diagonals [0, K)
  int band;
  int gap_open;
  int gap_extend;
  int32_t* score;  // (B,) out: H(qlen, tlen); zeroed by the wrapper
  uint8_t* ptr;    // (K, B, Np) or null
  int R;           // ring slots of the window, a power of 2
  int32_t* rows;   // (B, 6, R) scratch of the ring, or null (shared)
};

// one cell of slot i on diagonal k from its inputs; returns H, sets E, F
// and the pointer byte (taken before the mask, as the TPU kernel's)
struct BandCell {
  int H, E, F, p;
  __device__ __forceinline__ BandCell(int k, int i, const Band& bd, int sc, int Hd, int Hl,
                                      int El, int Hu, int Fu, int e, int oe) {
    bool ext_e, ext_f;
    E = __vibmax_s32(El + e, Hl + oe, &ext_e);
    F = __vibmax_s32(Fu + e, Hu + oe, &ext_f);
    const int d = Hd + sc;
    const int best = __vimax3_s32(d, F, E);
    H = best;
    p = d == best ? kPtrDiag : (F == best ? kPtrUp : kPtrLeft);
    if (k == 0 && i == 0) {
      H = 0;
      p = kPtrStop;
    }
    p |= (ext_e ? 4 : 0) | (ext_f ? 8 : 0);
    const int dkj = k - 2 * i;
    if (dkj < bd.dlo || dkj > bd.dhi) H = E = F = kNegInf;
  }
};

template <bool PTR>
__global__ void __launch_bounds__(1024) wf_band_kernel(const BandArgs a) {
  extern __shared__ int32_t smem[];
  const int NT = a.NT;
  const int Np = a.Np;
  const int R = a.R;
  const int b = blockIdx.x;
  const int nthr = blockDim.x;
  const unsigned last = (unsigned)(NT - 1);
  int32_t* tab = smem;
  int32_t* st = a.rows ? a.rows + (size_t)b * 6 * R : tab + NT * NT;
  int32_t* Hb = st;          // 2 rows: H of the diagonals, alternating
  int32_t* Fb = st + 2 * R;  // 2 rows: F likewise
  int32_t* Er = st + 4 * R;  // E of the previous diagonal (own slot)
  int32_t* Ur = st + 5 * R;  // H(k - 2) at slot i - 1 (own slot)
  for (int x = threadIdx.x; x < NT * NT; x += nthr) tab[x] = a.table[x];
  __syncthreads();

  const Band bd(a, b);
  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  const int32_t* qb = a.qpad + (size_t)b * Np;
  const int32_t* tb = a.tk + (size_t)b * a.Kw;
  int plo = 0, phi = -1;  // the previous diagonal's window
  for (int k = 0; k < a.K; ++k) {
    const int ilo = bd.lo(k);
    const int ihi = min(Np - 1, bd.hi(k));
    const int cur = k & 1;
    const int32_t* H1 = Hb + (cur ^ 1) * R;
    const int32_t* F1 = Fb + (cur ^ 1) * R;
    int32_t* Hn = Hb + cur * R;
    int32_t* Fn = Fb + cur * R;
    uint8_t* out = PTR ? a.ptr + ((size_t)k * a.B + b) * Np : nullptr;
    for (int i = ilo + threadIdx.x; i <= ihi; i += nthr) {
      const int r = i & (R - 1);
      const int rd = (i - 1) & (R - 1);
      const bool in1 = i >= plo && i <= phi;          // slot i on k - 1
      const bool in0 = i - 1 >= plo && i - 1 <= phi;  // slot i - 1 on k - 1
      const int j = k - i;
      const unsigned qc = min((unsigned)__ldg(qb + i), last);
      const unsigned tc = j < 0 ? 0u : min((unsigned)__ldg(tb + j), last);
      const int Hu = in0 ? H1[rd] : kNegInf;
      const int Fu = in0 ? F1[rd] : kNegInf;
      const BandCell c(k, i, bd, tab[qc * NT + tc], in1 ? Ur[r] : kNegInf,
                       in1 ? H1[r] : kNegInf, in1 ? Er[r] : kNegInf, Hu, Fu, e, oe);
      Hn[r] = c.H;
      Fn[r] = c.F;
      Er[r] = c.E;
      Ur[r] = Hu;
      if (PTR) out[i] = (uint8_t)c.p;
      if (k == bd.fin && i == bd.qlen) a.score[b] = c.H;
    }
    plo = ilo;
    phi = ihi;
    __syncthreads();  // the diagonal is complete before the next reads it
  }
}

// ---- the unbanded score-only fills: pipelined strip warps ----------------

constexpr int kStripMaxWarps = 16;  // ops/wavefront.py: STRIP_MAX_WARPS
constexpr int kStripRing = 256;     // ops/wavefront.py: STRIP_RING, a power of 2, >= 96

// what lane 0 of a strip reads of the row above, at one column: H, F and,
// in local mode, their start cells
struct Up {
  int H, F, SH, SF;
};

// a column of a strip's bottom row as the strip below reads it: 8 bytes
// (H and F; local linear H and its start), 16 in local affine mode
template <bool LOCAL, bool AFFINE>
struct StripCol {
  using T = int2;
  static __device__ __forceinline__ T pack(int H, int F, int SH, int) {
    return make_int2(H, LOCAL ? SH : F);
  }
  static __device__ __forceinline__ Up unpack(T v) {
    return LOCAL ? Up{v.x, kNegInf, v.y, 0} : Up{v.x, v.y, 0, 0};
  }
};
template <>
struct StripCol<true, true> {
  using T = int4;
  static __device__ __forceinline__ T pack(int H, int F, int SH, int SF) {
    return make_int4(H, F, SH, SF);
  }
  static __device__ __forceinline__ Up unpack(T v) { return Up{v.x, v.y, v.z, v.w}; }
};

// H of the global boundary cell (x, 0) or (0, x): the gaps of x letters
template <bool AFFINE>
__device__ __forceinline__ int boundary(int x, int e, int oe) {
  return AFFINE ? (x == 0 ? 0 : oe + (x - 1) * max(e, oe)) : x * e;
}

// cols: the columns [0, cols) the letters and the wrap row hold; the
// kernel computes columns up to min(tlen, K - 1, cols - 1)
template <bool LOCAL, bool AFFINE>
__global__ void __launch_bounds__(kStripMaxWarps * 32)
    wf_strip_kernel(const WfArgs a, int cols, int stage_letters) {
  using Col = StripCol<LOCAL, AFFINE>;
  using T = typename Col::T;
  constexpr int kWords = sizeof(T) / 4;
  extern __shared__ __align__(16) int32_t smem[];
  const int W = blockDim.x >> 5;
  const int NT = a.NT;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  // shared layout: rings, [wrap row], table, counters, [letters]
  T* ring = reinterpret_cast<T*>(smem);  // (W - 1) x kStripRing
  int32_t* p32 = smem + kWords * (W - 1) * kStripRing;
  T* full;
  if (a.rows == nullptr) {
    full = reinterpret_cast<T*>(p32);
    p32 += kWords * cols;
  } else {
    full = reinterpret_cast<T*>(a.rows) + (size_t)b * cols;
  }
  int32_t* tab = p32;
  p32 += NT * NT;
  unsigned* cnt = reinterpret_cast<unsigned*>(p32);
  p32 += kStripMaxWarps;
  const int32_t* tb = a.tk + (size_t)b * a.Kw;
  const int32_t* tl = stage_letters ? p32 : tb;

  const int qlen = a.qlen[b];
  const int tlen = a.tlen[b];
  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  const unsigned last = (unsigned)(NT - 1);
  // the columns computed, and the rows: every cell with j >= 1 and
  // i + j < K lies in [1, n] x [1, m]
  const int m = min(min(tlen, a.K - 1), cols - 1);
  const int n = min(min(qlen, a.Np - 1), a.K - 2);
  for (int x = tid; x < NT * NT; x += blockDim.x) tab[x] = a.table[x];
  if (stage_letters) {
    for (int x = tid; x <= m; x += blockDim.x) p32[x] = tb[x];
  }
  if (tid < kStripMaxWarps) cnt[tid] = 0;
  // DP row 0 for warp 0's first strip: local H = 0 (a STOP: its start is
  // the cell), global the boundary; F is -inf on row 0
  for (int j = tid; j <= m; j += blockDim.x) {
    full[j] = Col::pack(LOCAL ? 0 : boundary<AFFINE>(j, e, oe), kNegInf, j, 0);
  }
  if (!LOCAL && tid == 0 && (qlen == 0 || tlen == 0) && qlen + tlen < a.K && qlen < a.Np) {
    a.score[b] = boundary<AFFINE>(qlen + tlen, e, oe);  // a cell of row 0 or column 0
  }
  __syncthreads();

  const int lane = tid & 31;
  const int w = tid >> 5;
  const int nstrips = m > 0 && n > 0 ? (n + 31) >> 5 : 0;
  const unsigned mp1 = (unsigned)m + 1;
  // a round's share of the counters: columns [0, m] rounded up to whole
  // rings, so that counter value x of a ring's stream sits in slot x mod kStripRing
  const unsigned rstride = (mp1 + kStripRing - 1) & ~(unsigned)(kStripRing - 1);
  const int32_t* qb = a.qpad + (size_t)b * a.Np;
  // the row above comes from warp w - 1's ring, or (warp 0) the wrap row;
  // the bottom row goes to this warp's ring, or (warp W - 1) the wrap row
  const T* src = w == 0 ? full : ring + (w - 1) * kStripRing;
  const unsigned smask = w == 0 ? ~0u : (unsigned)(kStripRing - 1);
  T* dst = w == W - 1 ? full : ring + w * kStripRing;
  const unsigned dmask = w == W - 1 ? ~0u : (unsigned)(kStripRing - 1);
  const unsigned* up_cnt = cnt + (w == 0 ? W - 1 : w - 1);
  const unsigned* down_cnt = cnt + (w + 1 < W ? w + 1 : w);

  unsigned round = 0;
  for (int s = w; s < nstrips; s += W, ++round) {
    const int i = (s << 5) + lane + 1;
    const bool row_ok = i <= n;
    const int32_t* srow = tab + (row_ok ? min((unsigned)qb[i], last) : last) * NT;
    const int hcol = LOCAL ? 0 : boundary<AFFINE>(i, e, oe);  // H(i, 0)
    // at step k lane p holds cell (i, k - p), i + j = k + kbase: a STOP
    // starts at sbase + k, a best's diagonal is kbase + k
    const int kbase = (s << 5) + 1;
    const int sbase = i * a.stride - lane;
    const int mrow = min(m, a.K - 1 - i);             // this lane's last column
    const int mfast = min(m, a.K - 2 - (s << 5));     // every lane's last column
    const bool down = s + 1 < nstrips;  // a strip below reads this bottom row
    const bool put = down && lane == 31;
    // ring slots are reused: wait on the warp below (not for the wrap row)
    const bool backpressure = down && w + 1 < W;
    const unsigned mine = round * rstride;  // this strip's column 0 in counter units
    const unsigned above = w == 0 ? mine - rstride : mine;  // the strip above's
    int H = hcol, E = kNegInf, F = kNegInf;  // of (i, j - 1)
    int Hd = 0;                              // H(i - 1, j - 1)
    int SH = 0, SE = 0, SF = 0;              // local: start cells of H, E, F of (i, j - 1)
    int SHd = 0;                             // local: start cell of H(i - 1, j - 1)
    int bv = 0, bk = 0, bs = 0;              // local: the row's best, its k, its start

    // one cell (i, k - lane) of the valid columns at step k: neighbours
    // above, letter t
    auto cell = [&](int k, Up u, unsigned t) {
      const int d = Hd + srow[min(t, last)];
      int up, left;
      bool ext_e = false, ext_f = false;
      if (AFFINE) {
        E = __vibmax_s32(E + e, H + oe, &ext_e);
        F = __vibmax_s32(u.F + e, u.H + oe, &ext_f);
        up = F;
        left = E;
      } else {
        up = u.H + e;
        left = H + e;
      }
      const int best = __vimax3_s32(d, up, left);
      if (LOCAL) {
        // the start follows the pointer (DIAG > UP > LEFT), a gap's
        // start its extend bit; a STOP starts at the cell
        const int se = AFFINE && ext_e ? SE : SH;
        const int sf = AFFINE && ext_f ? u.SF : u.SH;
        // as selects: a branch here costs every shuffle a divergence check
        int sh = up == best ? sf : se;
        sh = d == best ? SHd : sh;
        sh = best <= 0 ? sbase + k : sh;
        SE = se;
        SF = sf;
        SH = sh;
        H = max(best, 0);
        // strict: the first k reaching the best; rows past n update too
        // and are never written
        const bool upd = H > bv;
        bv = upd ? H : bv;
        bk = upd ? kbase + k : bk;
        bs = upd ? sh : bs;
      } else {
        H = best;
      }
      Hd = u.H;
      SHd = u.SH;
    };
    auto from_above = [&]() {
      return Up{__shfl_up_sync(kFull, H, 1), AFFINE ? __shfl_up_sync(kFull, F, 1) : 0,
                LOCAL ? __shfl_up_sync(kFull, SH, 1) : 0,
                LOCAL && AFFINE ? __shfl_up_sync(kFull, SF, 1) : 0};
    };

    for (int c0 = 0; c0 < m + 32; c0 += 32) {
      // the row above's columns [c0, c0 + 32) are published
      wait_for(up_cnt, above + min((unsigned)c0 + 32, mp1));
      // lane 31 writes columns up to c0: the warp below has read c0 - kStripRing
      if (backpressure) wait_for(down_cnt, mine + (unsigned)(c0 - kStripRing + 1));
      if (c0 >= 32 && c0 + 31 <= mfast) {
        // every lane on a valid column for all 32 steps: no checks
        const T* sc = src + ((unsigned)c0 & smask);
        T* d_lo = dst + ((unsigned)(c0 - 32) & dmask) + 1;  // columns c0 - 31 + u
        T* d_hi = dst + ((unsigned)c0 & dmask);             // column c0
        const int32_t* tc = tl + (c0 - lane);
#pragma unroll
        for (int u = 0; u < 32; ++u) {
          Up v = from_above();
          if (lane == 0) v = Col::unpack(sc[u]);
          cell(c0 + u, v, (unsigned)tc[u]);
          if (put) {
            if (u < 31) d_lo[u] = Col::pack(H, F, SH, SF);
            else *d_hi = Col::pack(H, F, SH, SF);
          }
        }
      } else {
#pragma unroll 1
        for (int k = c0; k < c0 + 32; ++k) {
          const int j = k - lane;
          Up v = from_above();
          if (lane == 0 && k <= m) v = Col::unpack(src[(unsigned)k & smask]);
          if (j >= 1 && j <= mrow) {
            cell(k, v, (unsigned)tl[j]);
          } else {
            Hd = v.H;
            SHd = v.SH;
            if (j == 0) {  // column 0: the boundary, E = -inf (the oracle's)
              H = hcol;
              E = kNegInf;
              F = kNegInf;
              SH = sbase + k;
            }
          }
          if (put && j >= 0 && j <= m) dst[(unsigned)j & dmask] = Col::pack(H, F, SH, SF);
        }
      }
      // lane 31 has finished columns [0, c0]: publish them (its own stores
      // are ordered before the release)
      if (lane == 31) st_release_cta(cnt + w, mine + min((unsigned)c0 + 1, mp1));
    }
    // the strip is done: the whole round's share, so that the warp above may
    // reuse every ring slot of it
    if (lane == 31) st_release_cta(cnt + w, mine + rstride);
    if (LOCAL) {
      if (row_ok) {  // written once; a row that never beat 0 writes the zeros
        const size_t at = (size_t)b * a.Np + i;
        a.bv[at] = bv;
        a.bk[at] = bk;
        a.bs[at] = bs;
      }
    } else if (row_ok && i == qlen && tlen <= mrow) {
      a.score[b] = H;  // H(qlen, tlen): the lane's last column is tlen
    }
  }
}

// ---- the unbanded global fills with pointers: pipelined strip warps over
// every slot ----------------------------------------------------------------

constexpr int kPtrMaxWarps = 8;  // ops/wavefront.py: STRIP_PTR_MAX_WARPS

// what a strip hands the strip below at one diagonal: its last slot's H
// and, affine, F
struct HF {
  int H, F;
};
template <bool AFFINE>
struct PtrCol {
  using T = int2;
  static __device__ __forceinline__ T pack(int H, int F) { return make_int2(H, F); }
  static __device__ __forceinline__ HF unpack(T v) { return HF{v.x, v.y}; }
};
template <>
struct PtrCol<false> {
  using T = int;
  static __device__ __forceinline__ T pack(int H, int) { return H; }
  static __device__ __forceinline__ HF unpack(T v) { return HF{v, kNegInf}; }
};

// chunks of 32 diagonals of a strip, by what their cells need
enum ChunkKind { kJunk, kInner, kInnerRow0 };

// wait_for with a pause between polls, so that a waiting warp leaves its
// issue slots to the warps that compute (on an H100 80GB HBM3 at 700 W:
// 1.7% faster at config 3's pass (c), 6% at config 1)
__device__ __forceinline__ void wait_for_pausing(const unsigned* cnt, unsigned want) {
  while ((int)(ld_acquire_cta(cnt) - want) < 0) __nanosleep(64);
}

// One CTA of W warps per pair; warp w takes strips w, w + W, ... of 32
// slots, a lane per slot; a strip runs every diagonal k in [0, K), all
// its lanes on one diagonal at each step (lane p on cell (i0 + p,
// k - i0 - p)), so that its 32 pointer bytes of a diagonal are
// contiguous.  A lane's left neighbour is its own previous cell, its up
// and diagonal ones lane p - 1's by shuffles; lane 0 reads the slot above
// from the strip above: its last lane's H (and F) at diagonal x, handed
// over at index x + 1 of a ring of kStripRing entries in shared memory
// (index 0 is -inf: diagonal -1), published in chunks of 32 diagonals with
// st.release / ld.acquire counters (round r, index x is counter
// r * rstride + x, rstride >= K + 1 a multiple of kStripRing); warp W - 1
// hands its last lane to warp 0 of the next round through a wrap row of
// K + 1 entries, two of them used in turns by the rounds (shared memory
// while they fit, else the global scratch `rows`).  Round 0's warp 0
// reads the slot above slot 0: -inf.  stage_letters: the target letters
// in shared memory, else read from tk.
template <bool AFFINE>
__global__ void __launch_bounds__(kPtrMaxWarps * 32)
    wf_strip_ptr_kernel(const WfArgs a, int stage_letters) {
  using Col = PtrCol<AFFINE>;
  using T = typename Col::T;
  constexpr int kWords = sizeof(T) / 4;
  extern __shared__ __align__(16) int32_t smem[];
  const int W = blockDim.x >> 5;
  const int NT = a.NT;
  const int Np = a.Np;
  const int K = a.K;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int span = K + 1;  // entries of a wrap row
  // shared layout: rings, [two wrap rows], table, counters, [letters]
  T* ring = reinterpret_cast<T*>(smem);  // (W - 1) x kStripRing
  int32_t* p32 = smem + kWords * (W - 1) * kStripRing;
  T* wrap;
  if (a.rows == nullptr) {
    wrap = reinterpret_cast<T*>(p32);
    p32 += kWords * 2 * span;
  } else {
    wrap = reinterpret_cast<T*>(a.rows) + (size_t)b * 2 * span;
  }
  int32_t* tab = p32;
  p32 += NT * NT;
  unsigned* cnt = reinterpret_cast<unsigned*>(p32);
  p32 += kStripMaxWarps;
  const int32_t* tb = a.tk + (size_t)b * a.Kw;
  const int32_t* tl = stage_letters ? p32 : tb;
  for (int x = tid; x < NT * NT; x += blockDim.x) tab[x] = a.table[x];
  if (stage_letters) {
    for (int x = tid; x < K; x += blockDim.x) p32[x] = tb[x];
  }
  if (tid < kStripMaxWarps) cnt[tid] = 0;
  // the row round 0's warp 0 reads: the slots above slot 0, -inf
  for (int x = tid; x < span; x += blockDim.x) wrap[span + x] = Col::pack(kNegInf, kNegInf);
  __syncthreads();

  const int lane = tid & 31;
  const int w = tid >> 5;
  const int nstrips = (Np + 31) >> 5;
  const int qlen = a.qlen[b];
  const int fin = qlen + a.tlen[b];
  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  const unsigned last = (unsigned)(NT - 1);
  const unsigned rstride = ((unsigned)span + kStripRing - 1) & ~(unsigned)(kStripRing - 1);
  const size_t dstride = (size_t)a.B * Np;  // stream bytes from one diagonal to the next
  const int32_t* qb = a.qpad + (size_t)b * Np;
  const unsigned smask = w == 0 ? ~0u : (unsigned)(kStripRing - 1);
  const unsigned dmask = w == W - 1 ? ~0u : (unsigned)(kStripRing - 1);
  const unsigned* up_cnt = cnt + (w == 0 ? W - 1 : w - 1);
  const unsigned* down_cnt = cnt + (w + 1 < W ? w + 1 : w);

  unsigned round = 0;
  for (int s = w; s < nstrips; s += W, ++round) {
    const int i0 = s << 5;
    const int i = i0 + lane;
    const bool live = i < Np;  // a slot of the stream
    const bool all_live = i0 + 32 <= Np;  // every lane's
    const int32_t* srow = tab + (live ? min((unsigned)qb[i], last) : last) * NT;
    const int s0 = srow[0];  // a slot with j < 0 scores target letter 0
    const bool down = s + 1 < nstrips;  // a strip below reads this last lane
    const bool put = down && lane == 31;
    // ring entries are reused: wait on the warp below (not for a wrap row)
    const bool backpressure = down && w + 1 < W;
    const unsigned mine = round * rstride;  // this strip's diagonal 0 in counter units
    const unsigned above = w == 0 ? mine - rstride : mine;  // the strip above's
    // warp 0 reads the wrap row warp W - 1 wrote a round before, which
    // writes round r's into row r mod 2
    const T* src = w == 0 ? wrap + ((round + 1) & 1) * span : ring + (w - 1) * kStripRing;
    T* dst = w == W - 1 ? wrap + (round & 1) * span : ring + w * kStripRing;
    // the chunk holding H(qlen, tlen), the score, on this strip
    const int cap_c0 = qlen >= i0 && qlen < i0 + 32 && fin < K ? fin & ~31 : -1;
    uint8_t* out = a.ptr + (size_t)b * Np + i;
    int H = kNegInf, E = kNegInf, F = kNegInf;  // of (i, j - 1)
    int Hd = kNegInf;                           // H(i - 1, j - 1)

    // one cell from its up neighbour v and its letter score sc: H, E, F
    // and the diagonal neighbour of the next move; returns the pointer byte
    auto cell = [&](HF v, int sc) {
      const int d = Hd + sc;
      int up, left;
      bool ext_e = false, ext_f = false;
      if (AFFINE) {
        E = __vibmax_s32(E + e, H + oe, &ext_e);
        F = __vibmax_s32(v.F + e, v.H + oe, &ext_f);
        up = F;
        left = E;
      } else {
        up = v.H + e;
        left = H + e;
      }
      const int best = __vimax3_s32(d, up, left);
      // as selects: DIAG > UP > LEFT
      int p = up == best ? kPtrUp : kPtrLeft;
      p = d == best ? kPtrDiag : p;
      H = best;
      Hd = v.H;
      return p | (ext_e ? 4 : 0) | (ext_f ? 8 : 0);
    };
    auto from_above = [&]() {
      return HF{__shfl_up_sync(kFull, H, 1), AFFINE ? __shfl_up_sync(kFull, F, 1) : kNegInf};
    };
    // 32 diagonals from c0 whose cells need no boundary check: kJunk every
    // j < 0 (target letter 0), kInner every j >= 1, kInnerRow0 that on
    // strip 0 in linear mode (slot 0 is row 0: H = k * e, LEFT); every:
    // each lane a slot of the stream.  The stream pointer steps by one
    // diagonal a step (as u * dstride it took ~5 instructions a step)
    auto chunk = [&](auto kind, auto every, int c0) {
      constexpr int KIND = decltype(kind)::value;
      constexpr bool ALL = decltype(every)::value;
      const T* sc = src + ((unsigned)c0 & smask);
      T* d_lo = dst + ((unsigned)(c0 + 1) & dmask);  // indices c0 + 1 + u, u < 31
      T* d_hi = dst + ((unsigned)(c0 + 32) & dmask);
      const int32_t* tc = tl + (c0 - i);  // the letter of column c0 + u - i at tc[u]
      uint8_t* o = out + (size_t)c0 * dstride;
      const int ke = c0 * e;
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        HF v = from_above();
        if (lane == 0) v = Col::unpack(sc[u]);
        const int sc_u = KIND == kJunk ? s0 : srow[min((unsigned)tc[u], last)];
        int byte = cell(v, sc_u);
        if constexpr (KIND == kInnerRow0) {
          H = lane == 0 ? ke + u * e : H;
          byte = lane == 0 ? kPtrLeft : byte;
        }
        if (ALL || live) *o = (uint8_t)byte;
        o += dstride;
        if (put) {
          if (u < 31) d_lo[u] = Col::pack(H, F);
          else *d_hi = Col::pack(H, F);
        }
      }
    };

    for (int c0 = 0; c0 < K; c0 += 32) {
      const int c1 = min(c0 + 32, K);
      // the strip above has handed over indices [c0, c1): its chunk c0
      wait_for_pausing(up_cnt, above + (unsigned)c1);
      // lane 31 writes indices up to c0 + 32 over those 256 before, which
      // the warp below reads through its chunk c0 - 224
      if (backpressure) wait_for_pausing(down_cnt, mine + (unsigned)(c0 + 64 - kStripRing));
      if (put && c0 == 0) dst[0] = Col::pack(kNegInf, kNegInf);  // diagonal -1
      // a strip of 32 live slots stores with no predicate: as a branch it
      // cost every step a convergence barrier
      auto run = [&](auto kind) {
        if (all_live) {
          chunk(kind, std::true_type{}, c0);
        } else {
          chunk(kind, std::false_type{}, c0);
        }
      };
      if (c1 - c0 == 32 && c0 + 32 <= i0) {
        run(std::integral_constant<int, kJunk>{});
      } else if (c1 - c0 == 32 && c0 >= i0 + 32 && c0 != cap_c0) {
        if (!AFFINE && s == 0) {
          run(std::integral_constant<int, kInnerRow0>{});
        } else {
          run(std::integral_constant<int, kInner>{});
        }
      } else {  // column 0, the last diagonals, the score's cell: every check
#pragma unroll 1
        for (int k = c0; k < c1; ++k) {
          const int j = k - i;
          HF v = from_above();
          if (lane == 0) v = Col::unpack(src[(unsigned)k & smask]);
          const int sc_k = j < 0 ? s0 : srow[min((unsigned)tl[max(j, 0)], last)];
          int byte = cell(v, sc_k);
          if (AFFINE) {
            if (k == 0 && i == 0) {  // the origin
              H = 0;
              byte = kPtrStop | (byte & 12);
            }
          } else if (i == 0 || j == 0) {  // row 0 and column 0: k * e
            H = k * e;
            byte = k == 0 ? kPtrStop : (i == 0 ? kPtrLeft : kPtrUp);
          }
          if (k == fin && i == qlen) a.score[b] = H;
          if (live) out[(size_t)k * dstride] = (uint8_t)byte;
          if (put) dst[(unsigned)(k + 1) & dmask] = Col::pack(H, F);
        }
      }
      // lane 31 has handed over indices [0, c1]: publish them (its own
      // stores are ordered before the release)
      if (lane == 31) st_release_cta(cnt + w, mine + (unsigned)c1);
    }
    // the strip is done: the whole round's share, so that the warp above
    // may reuse every ring entry of it
    if (lane == 31) st_release_cta(cnt + w, mine + rstride);
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// the strip kernel's launch: ops/wavefront.py::wavefront_strip_geometry
struct StripLaunch {
  int warps, cols, stage_letters, smem;
};

template <bool LOCAL, bool AFFINE>
int launch_strip(const WfArgs& a, const StripLaunch& sl, cudaStream_t stream) {
  auto kernel = wf_strip_kernel<LOCAL, AFFINE>;
  const int rc = set_smem((const void*)kernel, (size_t)sl.smem);
  if (rc) return rc;
  kernel<<<a.B, sl.warps * 32, sl.smem, stream>>>(a, sl.cols, sl.stage_letters);
  return (int)cudaGetLastError();
}

template <bool AFFINE>
int launch_strip_ptr(const WfArgs& a, const StripLaunch& sl, cudaStream_t stream) {
  auto kernel = wf_strip_ptr_kernel<AFFINE>;
  const int rc = set_smem((const void*)kernel, (size_t)sl.smem);
  if (rc) return rc;
  kernel<<<a.B, sl.warps * 32, sl.smem, stream>>>(a, sl.stage_letters);
  return (int)cudaGetLastError();
}

template <bool PTR>
int launch_band(const WfArgs& w, cudaStream_t stream) {
  const BandArgs a{w.qpad, w.Np, w.tk,       w.Kw,         w.qlen,  w.tlen, w.table, w.NT, w.B,
                   w.K,    w.band, w.gap_open, w.gap_extend, w.score, w.ptr,  w.R,     w.rows};
  const size_t smem = (size_t)a.NT * a.NT * sizeof(int32_t) +
                      (a.rows ? 0 : 6 * (size_t)a.R * sizeof(int32_t));
  const int rc = set_smem((const void*)wf_band_kernel<PTR>, smem);
  if (rc) return rc;
  // one thread per window slot, at most 1024
  const int threads = min(1024, (min(a.R, a.Np) + 31) / 32 * 32);
  wf_band_kernel<PTR><<<a.B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool LOCAL, bool AFFINE, bool BANDED, bool PTR>
int launch_window(const WfArgs& a, cudaStream_t stream) {
  auto kernel = wf_window_kernel<LOCAL, AFFINE, BANDED, PTR>;
  const size_t smem = (size_t)a.NT * a.NT * sizeof(int32_t) +
                      (a.rows ? 0 : (size_t)ring_rows<LOCAL, AFFINE, PTR>() * a.R *
                                        sizeof(int32_t));
  const int rc = set_smem((const void*)kernel, smem);
  if (rc) return rc;
  // one thread per window slot, at most 1024
  const int threads = min(1024, (min(a.R, a.Np) + 31) / 32 * 32);
  kernel<<<a.B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the kernel for the mode flags (local, affine, banded, pointers), chosen
// one flag at a time: the strip kernel with no band and no pointers, the
// pointer strip kernel for global pointers with no band, the band kernel
// for the banded global affine window, else the window kernel
template <bool... F>
int run_fill(const WfArgs& a, const StripLaunch& sl, cudaStream_t stream) {
  constexpr int n = sizeof...(F);
  if constexpr (n == 4) {
    constexpr bool flags[] = {F...};
    if constexpr (!flags[2] && !flags[3]) {  // no band, no pointers
      return launch_strip<flags[0], flags[1]>(a, sl, stream);
    } else if constexpr (!flags[0] && !flags[2]) {  // global, no band, pointers
      return launch_strip_ptr<flags[1]>(a, sl, stream);
    } else if constexpr (!flags[0] && flags[1] && flags[2]) {
      return launch_band<flags[3]>(a, stream);
    } else {
      return launch_window<F...>(a, stream);
    }
  } else {
    const bool flag = n == 0 ? a.local : n == 1 ? a.affine : n == 2 ? a.banded : a.ptr != nullptr;
    return flag ? run_fill<F..., true>(a, sl, stream) : run_fill<F..., false>(a, sl, stream);
  }
}

}  // namespace

// Window kernels (a band, or local pointers): R, the window's ring, a
// power of 2 >= the widest window + 2; rows: its global scratch, or null
// (shared memory); ops/wavefront.py::window_ring picks them.  The strip
// kernel (no band, score-only): warps per pair, cols columns of letters
// and wrap row, letters staged or not, smem_bytes of dynamic shared
// memory, rows the wrap row's global scratch (B, cols, 16 or 8 bytes) or
// null; ops/wavefront.py::wavefront_strip_geometry picks them.  The
// pointer strip kernel (global, no band, pointers): warps, letters staged
// or not, smem_bytes, rows the two wrap rows' global scratch (B, 2,
// K + 1, 8 or 4 bytes) or null; ops/wavefront.py::
// wavefront_strip_ptr_geometry picks them.  Local mode writes
// bv, bk (and bs score-only), global mode score; the wrapper zeroes them.
extern "C" int seqalib_wavefront_fill(
    const int32_t* qpad, int Np, const int32_t* tk, int Kw,
    const int32_t* qlen, const int32_t* tlen, const int32_t* table, int NT,
    int B, int K, int band, int gap_open, int gap_extend, int local, int affine,
    int banded, int stride, int32_t* score, int32_t* bv, int32_t* bk, int32_t* bs,
    uint8_t* ptr, int R, int32_t* rows, int warps, int cols, int stage_letters,
    int smem_bytes, void* stream) {
  const bool strip = !banded && !ptr;
  const bool strip_ptr = !banded && ptr && !local;
  if (Np < 1 || K < 1 || K > Kw || (local ? !bv || !bk || (!ptr && !bs) : !score) ||
      (strip       ? warps < 1 || warps > kStripMaxWarps || cols < 1 || cols > Kw
       : strip_ptr ? warps < 1 || warps > kPtrMaxWarps
                   : R < 2 || (R & (R - 1)) != 0 || (!banded && R < Np + 2)))
    return (int)cudaErrorInvalidValue;
  const WfArgs a{qpad,       Np,    tk,     Kw,     qlen,   tlen,  table, NT,  B,
                 K,          band,  gap_open, gap_extend, local, affine, banded,
                 stride,     score, bv,     bk,     bs,     ptr,   R,     rows};
  const StripLaunch sl{warps, cols, stage_letters, smem_bytes};
  cudaStream_t s = (cudaStream_t)stream;
  if (ptr && banded) {  // the far bytes first; the window kernel overwrites its own
    // G runs of kFarRun slots side by side: the slots of a diagonal, at
    // most one per thread
    const int G = min(kFarThreads, (Np + kFarRun - 1) / kFarRun);
    const int nkc = (K + kFarK - 1) / kFarK;
    const int nic = (Np + G * kFarRun - 1) / (G * kFarRun);
    const size_t smem = ((NT * NT + 15) & ~15) + G * kFarRun + kFarK - 1;
    wf_far_kernel<<<(unsigned)((size_t)B * nkc * nic), kFarThreads, smem, s>>>(a, nkc, nic,
                                                                                G);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return run_fill(a, sl, s);
}
