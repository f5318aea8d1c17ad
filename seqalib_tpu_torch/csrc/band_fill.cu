// Banded affine-gap fill over anti-diagonals with O(band) slot state.
//
// Replaces seqalib_tpu/ops/banded_pallas.py::_band_kernel (launched by
// band_fill_range) in three modes; ops/band_fill.py's docstring states
// the geometry and every output:
//   kFill   masked band fill, final-cell capture, optional state
//           checkpoints every CK diagonals (config-4 fill);
//   kPtr    the same fill resumed from a checkpoint, emitting pointer
//           nibbles two diagonals per byte (config-4 traceback recompute);
//   kEmode  the TPU's `emode`: no mask, per-slot first maximum (BV, BK) and
//           the tie_safe edge bound EV (local alignment's pass 2).
// In kFill and kPtr a banded sequence-parallel row block (the TPU's `bh`/`bf`
// and `want_bout`, parallel/banded_sp.py) resumes from the block above: on
// every diagonal k <= dhi slot 0 (local row 0) takes H and F from the
// boundary streams after the mask and the origin, and row `bout_row` is
// captured, one (H, F) store per diagonal, into column k - 2 * bout_row.
// Tie-breaks are the oracle's: DIAG > UP(F) > LEFT(E), extend >= open.
//
// Bound on the H100: the instructions of one diagonal, not memory or
// integer throughput.  A cell needs ~25 integer operations and reads two
// letters and one table word, but every diagonal depends on the two before
// it, so a pair is a chain of K steps, and a step costs each thread the
// recurrence, the band mask, its letters' loads and table lookups, the
// neighbour exchange and a barrier: ~150-230 instructions.  With one CTA of
// 8-12 warps per SM (config 4, banded SP) the latency of that chain sets
// the pace; with ~16 warps per SM (pass 2's 512 pairs) the SM's issue rate
// does.  tools/band_fill_ablation.py puts the barrier at 4-18% of a step
// and the letter loads at 13-26%; fewer threads with 4 slots each were
// slower at Wp 256-384, with 2 slots each no faster overall.
//
// Design: one CTA per pair, thread t owning the S adjacent slots
// [t*S, t*S + S) (S by Wp: 1 up to Wp 512, then 2, 4, 8, 16, so that a CTA
// has at most 512 threads; blockDim is rounded up to whole warps and the
// slots past Wp - 1 are idle; above Wp 8192, band_fill_wide_kernel below).  H(k-1), H(k-2), E(k-1), F(k-1) of a
// thread's slots, the kEmode BV/BK/EV and the pending kPtr nibble stay in
// registers.  Since d1 = ihat(k) - ihat(k-1) and d2 = ihat(k) - ihat(k-2)
// depend on k alone, a slot's neighbours p-1 and p+1 are the same shift
// for every thread: inside a warp they come by __shfl_up_sync /
// __shfl_down_sync, across warps through a double-buffered edge array in
// shared memory (per warp the H, E of its first slot and the H, F of its
// last), one __syncthreads per diagonal.  H(k-2)'s neighbours are the
// H(k-1) neighbours of the step before, kept in registers.  The slots wrap
// around Wp as the TPU's lane rolls do (slot Wp - 1 <-> slot 0, through
// two more shared words), so every slot, junk included, holds the TPU
// kernel's value.  The next diagonal's letters are loaded with __ldg at the
// top of a step and looked up in the shared-memory score table before the
// barrier, off the recurrence's chain; so is the next boundary word of a
// resumed block.  What only a resumed block needs (injection, capture) is
// compiled in only for it (RELAY), per-pair pointers are set up once, and
// the rare stores (checkpoints, capture, final cell) sit under conditions
// that hold for the whole diagonal.  The TPU's clamp/dyn/steady phase
// split, its NSUB unrolling, letter streaming and batch padding change no
// value and are not carried over.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kFill = 0;
constexpr int kPtr = 1;
constexpr int kEmode = 2;
constexpr int kMaxThreads = 512;
constexpr int kEdge = 4;  // words per warp and buffer: H, E first; H, F last
// emode's floor for H (ops/band_fill.py EMODE_FLOOR).  emode fills every slot
// of its window unmasked, cells past the pair included: there H sinks by a
// gap or a mismatch a diagonal, and at scores near int32's range (|o| + (n +
// m) max(|e|, |s|) up to 2^29) a window of a few hundred diagonals took it
// below -2^31, where it wrapped.  Floored, H >= -1.5 * 2^30, so E and F stay
// above it by at most |o + e| + |e| and a diagonal by |s| (each < 2^29): no
// sum wraps.  A cell of the pair never comes near the floor (its value is at
// least -2^29), nor does any cell at the usual scales: no output changes there.
constexpr int kEmodeFloor = -(1 << 30) - (1 << 29);

struct BandArgs {
  const int32_t* qk;  // (B, q_width) letters, row i at [i]
  int q_width;
  const int32_t* tk;  // (B, t_width) letters, column j at [j]
  int t_width;
  const int32_t* qlen;  // (B,)
  const int32_t* tlen;
  const int32_t* dlo_p;  // (B,) per-pair band bounds on j - i
  const int32_t* dhi_p;
  const int32_t* table;  // (NT, NT)
  int NT;
  int B;
  int Wp;
  int k0, k1;  // diagonals [k0, k1)
  int K;       // the capture needs k < K
  int dhi;     // the bucket's band top: slot geometry
  int gap_open;
  int gap_extend;
  int CK;  // checkpoint spacing (kFill), 0 = none
  int tie_safe;
  int smax;
  int32_t* state;  // (NS, B, Wp) in/out: H1, H2, E, F[, BV, BK]
  int32_t* score;  // (B, Wp) in/out: capture (kFill) or EV (kEmode)
  int32_t* ckpt;   // (NC, 4, B, Wp) or null
  uint8_t* ptr;    // ((k1 - k0) / 2, B, Wp) or null
  const int32_t* bh;  // (B, Wb) boundary H and F injected at slot 0, or null
  const int32_t* bf;
  int Wb;
  int32_t* bout;  // (2, B, Wbo) capture of row bout_row, or null
  int Wbo;
  int bout_row;
  int32_t* scratch;  // (B, 7, Wp): the wide variant's slot rows, or null
};

// RELAY: a resumed row block (bh/bf and/or bout given), so that the
// other launches issue none of its per-diagonal work
template <int MODE, int S, bool RELAY>
__global__ void __launch_bounds__(kMaxThreads) band_fill_kernel(const BandArgs a) {
  extern __shared__ int32_t smem[];
  const int Wp = a.Wp;
  const int NT = a.NT;
  const int nwarp = blockDim.x >> 5;
  // per buffer: kEdge words per warp, then H, F of slot Wp - 1
  const int ebuf = nwarp * kEdge + 2;
  int32_t* tab = smem;            // NT * NT
  int32_t* edge = tab + NT * NT;  // [2][ebuf]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  for (int x = tid; x < NT * NT; x += blockDim.x) tab[x] = a.table[x];

  const int base = tid * S;     // the thread's first slot
  const int tl = (Wp - 1) / S;  // the thread that owns slot Wp - 1
  // the local slot whose right neighbour lies in another thread: the next
  // thread's first slot, or slot 0 for slot Wp - 1
  const int Lt = tid == tl ? Wp - 1 - base : S - 1;
  const bool live = base < Wp;
  // where the thread's neighbours across its edges come from after a
  // barrier: the next warp's first slot (slot 0 for slot Wp - 1), the
  // previous warp's last slot (slot Wp - 1 for slot 0); every thread reads
  // (most at offset 0, a broadcast) and keeps what it needs, without a branch
  const bool r_edge = tid == tl || (lane == 31 && warp + 1 < nwarp);
  const bool l_edge = tid == 0 || (lane == 0 && warp > 0);
  const int r_off = tid == tl ? 0 : (r_edge ? (warp + 1) * kEdge : 0);
  const int l_off = tid == 0 ? nwarp * kEdge : (l_edge ? (warp - 1) * kEdge + 2 : 0);
  const size_t plane = (size_t)a.B * Wp;
  const size_t row = (size_t)b * Wp;

  int h1[S], h2[S], e1[S], f1[S], bv[S], bk[S], ev[S], lo[S], sc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int p = base + s;
    const bool in = p < Wp;
    h1[s] = in ? a.state[row + p] : kNegInf;               // H(k0 - 1)
    h2[s] = in ? a.state[plane + row + p] : kNegInf;       // H(k0 - 2)
    e1[s] = in ? a.state[2 * plane + row + p] : kNegInf;
    f1[s] = in ? a.state[3 * plane + row + p] : kNegInf;
    if (MODE == kEmode) {
      bv[s] = in ? a.state[4 * plane + row + p] : kNegInf;
      bk[s] = in ? a.state[5 * plane + row + p] : 0;
      ev[s] = in ? a.score[row + p] : kNegInf;
    }
    lo[s] = 0;
  }
  // neighbours across the thread's edges: left of its first slot, right of
  // its last (both around the ring)
  int lnH1 = kNegInf, rnH1 = kNegInf, rnE1 = kNegInf, lnF1 = kNegInf;
  int lnH2 = kNegInf, rnH2 = kNegInf;
  if (live) {
    const int pl = base == 0 ? Wp - 1 : base - 1;
    const int pr = base + Lt + 1 >= Wp ? 0 : base + Lt + 1;
    lnH1 = a.state[row + pl];
    rnH1 = a.state[row + pr];
    lnH2 = a.state[plane + row + pl];
    rnH2 = a.state[plane + row + pr];
    rnE1 = a.state[2 * plane + row + pr];
    lnF1 = a.state[3 * plane + row + pl];
  }

  const int qlen = a.qlen[b];
  const int tlen = a.tlen[b];
  const int dlov = a.dlo_p[b];
  const int dhiv = a.dhi_p[b];
  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  const unsigned last = (unsigned)(NT - 1);
  const int32_t* qb = a.qk + (size_t)b * a.q_width;
  const int32_t* tb = a.tk + (size_t)b * a.t_width;
  // letters of slot s on diagonal k: query row i, target column j (a
  // negative column reads letter 0, past the arrays letter NT - 1)
  unsigned qn[S], tn[S];
  auto fetch = [&](int k, int ih) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = ih + base + s;
      const int j = k - i;
      unsigned qv = last, tv = 0;  // predicated loads, no branch
      if (i < a.q_width) qv = (unsigned)__ldg(qb + i);
      const bool tin = (unsigned)j < (unsigned)a.t_width;
      if (tin) tv = (unsigned)__ldg(tb + j);
      qn[s] = qv;
      tn[s] = tin ? tv : (j < 0 ? 0u : last);
    }
  };
  // ihat of diagonals k - 2, k - 1, k, k + 1, rotated along the loop
  int ih2 = ihat(a.k0 - 2, a.dhi), ih1 = ihat(a.k0 - 1, a.dhi);
  int ih = ihat(a.k0, a.dhi);
  fetch(a.k0, ih);
  __syncthreads();  // the table is in
#pragma unroll
  for (int s = 0; s < S; ++s) sc[s] = tab[min(qn[s], last) * NT + min(tn[s], last)];

  const bool inject = RELAY && a.bh != nullptr;
  const int32_t* bhp = inject ? a.bh + (size_t)b * a.Wb : nullptr;
  const int32_t* bfp = inject ? a.bf + (size_t)b * a.Wb : nullptr;
  int32_t* bo_h = RELAY && a.bout != nullptr ? a.bout + (size_t)b * a.Wbo : nullptr;
  int32_t* bo_f = bo_h != nullptr ? bo_h + (size_t)a.B * a.Wbo : nullptr;
  int32_t* score_row = a.score + row;
  uint8_t* ptr_row = MODE == kPtr ? a.ptr + row : nullptr;  // advances a plane per 2 diagonals
  int bhc = 0, bfc = 0;  // the boundary words of the current diagonal
  if (inject && a.k0 <= a.dhi) {
    bhc = bhp[min(a.k0, a.Wb - 1)];
    bfc = bfp[min(a.k0, a.Wb - 1)];
  }
  int ck_left = 0;  // diagonals to the next checkpoint
  int32_t* ck = a.ckpt != nullptr ? a.ckpt + row : nullptr;  // the next checkpoint
  for (int k = a.k0; k < a.k1; ++k) {
    if (MODE == kFill && a.CK > 0) {
      if (ck_left == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int p = base + s;
          if (p < Wp) {
            ck[p] = h1[s];
            ck[plane + p] = h2[s];
            ck[2 * plane + p] = e1[s];
            ck[3 * plane + p] = f1[s];
          }
        }
        ck += 4 * plane;
        ck_left = a.CK;
      }
      --ck_left;
    }
    const int ihn = ihat(k + 1, a.dhi);
    fetch(k + 1, ihn);  // the next diagonal's letters, used before the barrier
    int bhn = 0, bfn = 0;
    if (inject && k + 1 <= a.dhi) {  // every thread: a broadcast, no branch
      bhn = bhp[min(k + 1, a.Wb - 1)];
      bfn = bfp[min(k + 1, a.Wb - 1)];
    }

    const int d1 = ih - ih1;  // 0 or 1
    const int d2 = ih - ih2;  // 0, 1 or 2
    // boundary capture: column bx of bout takes slot pcap's H and F
    const int bx = k - 2 * a.bout_row;
    const int pcap = a.bout_row - ih;
    const bool cap = bo_h != nullptr && bx >= 0 && bx < a.Wbo;
    const bool cap_in = cap && pcap >= 0 && pcap < Wp;
    if (cap && !cap_in && tid == 0) {  // no slot: 0, as the TPU
      bo_h[bx] = 0;
      bo_f[bx] = 0;
    }
    const int r = k - a.k0;
    const bool k_origin = k == 0;
    const bool k_inject = inject && k <= a.dhi;
    const bool k_final = MODE == kFill && k == qlen + tlen && k < a.K;
    const bool k_edge = MODE == kEmode && a.tie_safe && k > a.dhi;
    int hn[S], en[S], fn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int p = base + s;
      const int sn = s + 1 < S ? s + 1 : s;  // static indices of the
      const int sp = s > 0 ? s - 1 : 0;      // neighbours inside the thread
      const int hR = s == Lt ? rnH1 : h1[sn];
      const int eR = s == Lt ? rnE1 : e1[sn];
      const int hL = s == 0 ? lnH1 : h1[sp];
      const int fL = s == 0 ? lnF1 : f1[sp];
      // left (p + d1), up (p + d1 - 1), diagonal (p + d2 - 1)
      const int Hl = d1 ? hR : h1[s];
      const int El = d1 ? eR : e1[s];
      const int Hu = d1 ? h1[s] : hL;
      const int Fu = d1 ? f1[s] : fL;
      const int Hd = d2 == 1 ? h2[s]
                             : (d2 == 0 ? (s == 0 ? lnH2 : h2[sp])
                                        : (s == Lt ? rnH2 : h2[sn]));
      const int i = ih + p;
      const int j = k - i;
      const int e_ext = El + e, e_opn = Hl + oe;
      const int f_ext = Fu + e, f_opn = Hu + oe;
      int E = max(e_ext, e_opn);
      int F = max(f_ext, f_opn);
      const int d = Hd + sc[s];
      const int best = max(max(d, F), E);
      const bool origin = k_origin && i == 0;
      int H;
      if (MODE == kEmode) {
        H = origin ? 0 : max(best, kEmodeFloor);
        if (p == Wp - 1) H = E = F = kNegInf;
        if (H > bv[s]) {  // strict: the first maximum of the slot
          bv[s] = H;
          bk[s] = k;
        }
        if (a.tie_safe) {
          const int cand = (p == 0 && k_edge) ? E : (p == Wp - 2 ? F : kNegInf);
          ev[s] = max(ev[s], cand - a.smax * i);
        }
      } else {
        if (MODE == kPtr) {  // from the unmasked values, as the TPU kernel
          int nib = origin ? kPtrStop
                           : (d == best ? kPtrDiag
                                        : (F == best ? kPtrUp : kPtrLeft));
          nib |= (e_ext >= e_opn ? 4 : 0) | (f_ext >= f_opn ? 8 : 0);
          if ((r & 1) == 0) {
            lo[s] = nib;
          } else if (p < Wp) {
            ptr_row[p] = (uint8_t)(lo[s] | (nib << 4));
          }
        }
        const int dkj = j - i;
        const bool ok = dkj >= dlov && dkj <= dhiv && i <= qlen && j >= 0 &&
                        j <= tlen && !origin;
        H = origin ? 0 : (ok ? best : kNegInf);
        if (!ok) E = F = kNegInf;
        if (k_inject && p == 0) {  // local row 0
          H = bhc;
          F = bfc;
        }
      }
      hn[s] = H;
      en[s] = E;
      fn[s] = F;
    }
    // rare stores, under conditions that hold for the whole diagonal
    if (cap_in) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (base + s == pcap) {
          bo_h[bx] = hn[s];
          bo_f[bx] = fn[s];
        }
      }
    }
    if (k_final) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int p = base + s;
        if (ih + p == qlen && p < Wp) score_row[p] = max(score_row[p], hn[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      h2[s] = h1[s];
      h1[s] = hn[s];
      e1[s] = en[s];
      f1[s] = fn[s];
      sc[s] = tab[min(qn[s], last) * NT + min(tn[s], last)];
    }
    if (MODE == kPtr && (r & 1)) ptr_row += plane;
    lnH2 = lnH1;
    rnH2 = rnH1;
    ih2 = ih1;
    ih1 = ih;
    ih = ihn;
    bhc = bhn;
    bfc = bfn;
    // the new diagonal's neighbours: inside the warp by shuffles, across
    // warps and around the ring through shared memory
    rnH1 = __shfl_down_sync(kFull, h1[0], 1);
    rnE1 = __shfl_down_sync(kFull, e1[0], 1);
    lnH1 = __shfl_up_sync(kFull, h1[S - 1], 1);
    lnF1 = __shfl_up_sync(kFull, f1[S - 1], 1);
    int32_t* eg = edge + (k & 1) * ebuf;
    if (lane == 0) {
      eg[warp * kEdge] = h1[0];
      eg[warp * kEdge + 1] = e1[0];
    }
    if (lane == 31) {
      eg[warp * kEdge + 2] = h1[S - 1];
      eg[warp * kEdge + 3] = f1[S - 1];
    }
    if (tid == tl) {  // slot Wp - 1, local index Lt
      int wh = h1[0], wf = f1[0];
#pragma unroll
      for (int s = 1; s < S; ++s) {
        if (s == Lt) {
          wh = h1[s];
          wf = f1[s];
        }
      }
      eg[nwarp * kEdge] = wh;
      eg[nwarp * kEdge + 1] = wf;
    }
    __syncthreads();  // the diagonal's edges are out before the next reads them
    const int xh = eg[r_off], xe = eg[r_off + 1];
    const int yh = eg[l_off], yf = eg[l_off + 1];
    rnH1 = r_edge ? xh : rnH1;
    rnE1 = r_edge ? xe : rnE1;
    lnH1 = l_edge ? yh : lnH1;
    lnF1 = l_edge ? yf : lnF1;
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int p = base + s;
    if (p < Wp) {
      a.state[row + p] = h1[s];
      a.state[plane + row + p] = h2[s];
      a.state[2 * plane + row + p] = e1[s];
      a.state[3 * plane + row + p] = f1[s];
      if (MODE == kEmode) {
        a.state[4 * plane + row + p] = bv[s];
        a.state[5 * plane + row + p] = bk[s];
        a.score[row + p] = ev[s];
      }
    }
  }
}

// The wide variant, for Wp > kMaxThreads * 16 (slots the registers cannot
// hold): the same recurrence, in the same order, with the slot rows in
// global memory (a.scratch, per pair H at k, k-1, k-2 and E, F at k, k-1,
// rotated; ~450 KB a pair at Wp 16384, L2-resident), the emode BV/BK/EV in
// `state`/`score` and the pending pointer nibble in the pointer byte itself.
// One CTA of kWideThreads per pair, slot p on thread p % kWideThreads; a
// diagonal reads only the two before it, so one __syncthreads closes it.
// Slow (every neighbour is an L1/L2 load) but with no cap on Wp.
constexpr int kWideThreads = 1024;
constexpr int kSlotsMax = 16;  // the register variant's most slots per thread

template <int MODE, bool RELAY>
__global__ void __launch_bounds__(kWideThreads) band_fill_wide_kernel(const BandArgs a) {
  extern __shared__ int32_t smem[];
  const int Wp = a.Wp;
  const int NT = a.NT;
  int32_t* tab = smem;  // NT * NT
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  for (int x = tid; x < NT * NT; x += blockDim.x) tab[x] = a.table[x];
  const size_t plane = (size_t)a.B * Wp;
  const size_t row = (size_t)b * Wp;
  int32_t* H = a.scratch + (size_t)b * 7 * Wp;  // 3 rows: H at r mod 3
  int32_t* Ev = H + 3 * (size_t)Wp;             // 2 rows: E at r mod 2
  int32_t* Fv = Ev + 2 * (size_t)Wp;            // 2 rows: F at r mod 2
  // the rows of relative diagonal r = k - k0 (r >= -3)
  auto hrow = [&](int r) { return H + (size_t)((r + 3) % 3) * Wp; };
  auto erow = [&](int r) { return Ev + (size_t)((r + 2) & 1) * Wp; };
  auto frow = [&](int r) { return Fv + (size_t)((r + 2) & 1) * Wp; };
  for (int p = tid; p < Wp; p += blockDim.x) {
    hrow(-1)[p] = a.state[row + p];
    hrow(-2)[p] = a.state[plane + row + p];
    erow(-1)[p] = a.state[2 * plane + row + p];
    frow(-1)[p] = a.state[3 * plane + row + p];
  }
  __syncthreads();

  const int qlen = a.qlen[b];
  const int tlen = a.tlen[b];
  const int dlov = a.dlo_p[b];
  const int dhiv = a.dhi_p[b];
  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  const unsigned last = (unsigned)(NT - 1);
  const int32_t* qb = a.qk + (size_t)b * a.q_width;
  const int32_t* tb = a.tk + (size_t)b * a.t_width;
  const bool inject = RELAY && a.bh != nullptr;
  const int32_t* bhp = inject ? a.bh + (size_t)b * a.Wb : nullptr;
  const int32_t* bfp = inject ? a.bf + (size_t)b * a.Wb : nullptr;
  int32_t* bo_h = RELAY && a.bout != nullptr ? a.bout + (size_t)b * a.Wbo : nullptr;
  int32_t* bo_f = bo_h != nullptr ? bo_h + (size_t)a.B * a.Wbo : nullptr;
  int32_t* score_row = a.score + row;
  int32_t* bv_row = MODE == kEmode ? a.state + 4 * plane + row : nullptr;
  int32_t* bk_row = MODE == kEmode ? a.state + 5 * plane + row : nullptr;
  for (int k = a.k0; k < a.k1; ++k) {
    const int r = k - a.k0;
    const int32_t* h1 = hrow(r - 1);
    const int32_t* h2 = hrow(r - 2);
    const int32_t* e1 = erow(r - 1);
    const int32_t* f1 = frow(r - 1);
    int32_t* hk = hrow(r);
    int32_t* ek = erow(r);
    int32_t* fk = frow(r);
    if (MODE == kFill && a.CK > 0 && r % a.CK == 0) {
      int32_t* ck = a.ckpt + (size_t)(r / a.CK) * 4 * plane + row;
      for (int p = tid; p < Wp; p += blockDim.x) {
        ck[p] = h1[p];
        ck[plane + p] = h2[p];
        ck[2 * plane + p] = e1[p];
        ck[3 * plane + p] = f1[p];
      }
    }
    const int ih = ihat(k, a.dhi);
    const int d1 = ih - ihat(k - 1, a.dhi);
    const int d2 = ih - ihat(k - 2, a.dhi);
    const int bx = k - 2 * a.bout_row;
    const int pcap = a.bout_row - ih;
    const bool cap = bo_h != nullptr && bx >= 0 && bx < a.Wbo;
    const bool cap_in = cap && pcap >= 0 && pcap < Wp;
    if (cap && !cap_in && tid == 0) {
      bo_h[bx] = 0;
      bo_f[bx] = 0;
    }
    const bool k_origin = k == 0;
    const bool k_inject = inject && k <= a.dhi;
    const int bhc = k_inject ? bhp[min(k, a.Wb - 1)] : 0;
    const int bfc = k_inject ? bfp[min(k, a.Wb - 1)] : 0;
    const bool k_final = MODE == kFill && k == qlen + tlen && k < a.K;
    const bool k_edge = MODE == kEmode && a.tie_safe && k > a.dhi;
    uint8_t* ptr_row = MODE == kPtr ? a.ptr + (size_t)(r >> 1) * plane + row : nullptr;
#pragma unroll 4
    for (int p = tid; p < Wp; p += blockDim.x) {
      const int pr = p + 1 == Wp ? 0 : p + 1;  // the ring, as the TPU's lane rolls
      const int pl = p == 0 ? Wp - 1 : p - 1;
      const int xl = d1 ? pr : p;  // left (p + d1), up (p + d1 - 1)
      const int xu = d1 ? p : pl;
      const int xd = d2 == 1 ? p : (d2 == 0 ? pl : pr);  // diagonal (p + d2 - 1)
      const int Hl = h1[xl], El = e1[xl];
      const int Hu = h1[xu], Fu = f1[xu];
      const int Hd = h2[xd];
      const int i = ih + p;
      const int j = k - i;
      const unsigned qv = i < a.q_width ? (unsigned)__ldg(qb + i) : last;
      const unsigned tv = (unsigned)j < (unsigned)a.t_width ? (unsigned)__ldg(tb + j)
                                                            : (j < 0 ? 0u : last);
      const int sc = tab[min(qv, last) * NT + min(tv, last)];
      const int e_ext = El + e, e_opn = Hl + oe;
      const int f_ext = Fu + e, f_opn = Hu + oe;
      int E = max(e_ext, e_opn);
      int F = max(f_ext, f_opn);
      const int d = Hd + sc;
      const int best = max(max(d, F), E);
      const bool origin = k_origin && i == 0;
      int Hn;
      if (MODE == kEmode) {
        Hn = origin ? 0 : max(best, kEmodeFloor);
        if (p == Wp - 1) Hn = E = F = kNegInf;
        if (Hn > bv_row[p]) {  // strict: the first maximum of the slot
          bv_row[p] = Hn;
          bk_row[p] = k;
        }
        if (a.tie_safe) {
          const int cand = (p == 0 && k_edge) ? E : (p == Wp - 2 ? F : kNegInf);
          score_row[p] = max(score_row[p], cand - a.smax * i);
        }
      } else {
        if (MODE == kPtr) {  // from the unmasked values, as the TPU kernel
          int nib = origin ? kPtrStop
                           : (d == best ? kPtrDiag : (F == best ? kPtrUp : kPtrLeft));
          nib |= (e_ext >= e_opn ? 4 : 0) | (f_ext >= f_opn ? 8 : 0);
          ptr_row[p] = (uint8_t)((r & 1) ? (ptr_row[p] | (nib << 4)) : nib);
        }
        const int dkj = j - i;
        const bool ok = dkj >= dlov && dkj <= dhiv && i <= qlen && j >= 0 &&
                        j <= tlen && !origin;
        Hn = origin ? 0 : (ok ? best : kNegInf);
        if (!ok) E = F = kNegInf;
        if (k_inject && p == 0) {  // local row 0
          Hn = bhc;
          F = bfc;
        }
        if (cap_in && p == pcap) {
          bo_h[bx] = Hn;
          bo_f[bx] = F;
        }
        if (k_final && i == qlen) score_row[p] = max(score_row[p], Hn);
      }
      hk[p] = Hn;
      ek[p] = E;
      fk[p] = F;
    }
    __syncthreads();  // the diagonal is out before the next reads it
  }
  const int rl = a.k1 - a.k0 - 1;  // the last diagonal
  for (int p = tid; p < Wp; p += blockDim.x) {
    a.state[row + p] = hrow(rl)[p];
    a.state[plane + row + p] = hrow(rl - 1)[p];
    a.state[2 * plane + row + p] = erow(rl)[p];
    a.state[3 * plane + row + p] = frow(rl)[p];
  }
}

template <int MODE>
int launch_wide(const BandArgs& a, cudaStream_t stream) {
  if (a.scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a.NT * a.NT * sizeof(int32_t);
  if (MODE != kEmode && (a.bh != nullptr || a.bout != nullptr))
    band_fill_wide_kernel<MODE, true><<<a.B, kWideThreads, smem, stream>>>(a);
  else
    band_fill_wide_kernel<MODE, false><<<a.B, kWideThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE, int S>
int launch_s(const BandArgs& a, cudaStream_t stream) {
  const int threads = ((a.Wp + S - 1) / S + 31) / 32 * 32;
  const size_t smem = ((size_t)a.NT * a.NT + 2 * ((threads / 32) * kEdge + 2)) * sizeof(int32_t);
  if (MODE != kEmode && (a.bh != nullptr || a.bout != nullptr))
    band_fill_kernel<MODE, S, true><<<a.B, threads, smem, stream>>>(a);
  else
    band_fill_kernel<MODE, S, false><<<a.B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// S slots per thread: at most 512 threads a CTA
template <int MODE>
int launch(const BandArgs& a, cudaStream_t stream) {
  if (a.Wp <= kMaxThreads) return launch_s<MODE, 1>(a, stream);
  if (a.Wp <= 2 * kMaxThreads) return launch_s<MODE, 2>(a, stream);
  if (a.Wp <= 4 * kMaxThreads) return launch_s<MODE, 4>(a, stream);
  if (a.Wp <= 8 * kMaxThreads) return launch_s<MODE, 8>(a, stream);
  if (a.Wp <= kSlotsMax * kMaxThreads) return launch_s<MODE, kSlotsMax>(a, stream);
  return launch_wide<MODE>(a, stream);
}

}  // namespace

extern "C" int seqalib_band_fill(
    const int32_t* qk, int q_width, const int32_t* tk, int t_width,
    const int32_t* qlen, const int32_t* tlen, const int32_t* dlo_p,
    const int32_t* dhi_p, const int32_t* table, int NT, int B, int Wp, int k0,
    int k1, int K, int dhi, int gap_open, int gap_extend, int mode, int CK,
    int tie_safe, int smax, int32_t* state, int32_t* score, int32_t* ckpt,
    uint8_t* ptr, const int32_t* bh, const int32_t* bf, int Wb, int32_t* bout,
    int Wbo, int bout_row, int32_t* scratch, void* stream) {
  if ((bh != nullptr && Wb < 1) || (bout != nullptr && (Wbo < 1 || bout_row < 0)))
    return (int)cudaErrorInvalidValue;
  const BandArgs a{qk,    q_width, tk,       t_width,    qlen,  tlen,     dlo_p,
                   dhi_p, table,   NT,       B,          Wp,    k0,       k1,
                   K,     dhi,     gap_open, gap_extend, CK,    tie_safe, smax,
                   state, score,   ckpt,     ptr,        bh,    bf,       Wb,
                   bout,  Wbo,     bout_row, scratch};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kFill:
      return launch<kFill>(a, s);
    case kPtr:
      return launch<kPtr>(a, s);
    case kEmode:
      return launch<kEmode>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
