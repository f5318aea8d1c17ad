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
// and the one departure from the TPU kernel (E of column 0 is -inf in
// local affine mode, as in the oracle).
// Tie-breaks are the oracle's: DIAG > UP(F) > LEFT(E), extend >= open.
//
// Bound on the H100: the chain of K = n + m + 1 anti-diagonals of each
// pair (one barrier each), and in pointer mode the K x B x Np bytes of the
// pointer stream.
// The TPU kernel computes every slot of every diagonal; the first port did
// too, one CTA of up to 1024 threads per pair, a barrier and global letter
// loads per diagonal (~0.97 us each at the wide-table shape, where only
// ~66 of 1024 slots lie in the band).
//
// Design.  A slot i of diagonal k (cell (i, k - i)) reads, from the
// diagonals before, only slots whose d = k - 2i differs from its own by at
// most one; with a band, every slot with d outside [dlo, dhi] is masked to
// -inf.  So a slot with d outside [dlo - 1, dhi + 1] has only -inf inputs,
// and its pointer byte depends on its letters alone (the far rule of each
// mode, ops/wavefront.py::wavefront_far_bytes_ref; global affine:
//   (s >= max(e, o + e) ? DIAG : UP) | (e >= o + e) << 2 | (e >= o + e) << 3).
// Two kernels therefore write a banded fill's output, one after the other
// on the caller's stream:
// - wf_far_kernel, pointer mode with a band only: that byte for every
//   (k, b, i), no DP state; a CTA stages a rule table (one byte per letter
//   pair) and the target letters of its tile of diagonals and slots in
//   shared memory, each thread keeps 16 slots' query rows in registers and
//   stores 16 bytes at a time.  It moves the stream's bytes (151 MB at the
//   wide-table shape, K 2049 x B 64 x Np 1152).
// - wf_window_kernel<LOCAL, AFFINE, BANDED, PTR>, one CTA per pair: only
//   the slots i in [lo(k), hi(k)], d in [dlo - 1, dhi + 1] (about band +
//   |delta| / 2 + 2 of them), or every slot with no band (then there is no
//   far pass: the window writes every byte), carry state; it writes their
//   bytes and captures H(qlen, tlen), or in local mode updates each valid
//   cell's slot best (bv, bk, bs in global memory, one owner per slot and
//   diagonal).  One thread per window slot (at most 1024, looping past
//   that); the slot rows sit in a ring of R >= window + 2 slots indexed by
//   i mod R (rows read at slot i - 1 double buffered, the others in
//   place: 3 linear, 6 affine, twice that for the start cells of local
//   score-only), in shared memory while it fits, else in the global
//   scratch `rows`; one barrier per diagonal.  Any band (up to every
//   slot) and any delta fit: the ring grows with the window, never capped.
// Letters are scored from a shared-memory table whose sentinel entries
// score as the TPU kernel's route scored them.
#include <cuda_runtime.h>

#include <cstdint>

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
  __device__ Band(const WfArgs& a, int b) {
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

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
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

// the window kernel's instance for the mode flags, chosen one flag at a time
template <bool... F>
int run_window(const WfArgs& a, cudaStream_t stream) {
  constexpr int n = sizeof...(F);
  if constexpr (n == 4) {
    return launch_window<F...>(a, stream);
  } else {
    const bool flag = n == 0 ? a.local : n == 1 ? a.affine : n == 2 ? a.banded : a.ptr != nullptr;
    return flag ? run_window<F..., true>(a, stream) : run_window<F..., false>(a, stream);
  }
}

}  // namespace

// R: the window's ring, a power of 2 >= the widest window + 2; rows: its
// global scratch, or null (shared memory); ops/wavefront.py::window_ring
// picks them.  Local mode writes bv, bk (and bs score-only), global mode
// score; the wrapper zeroes them.
extern "C" int seqalib_wavefront_fill(
    const int32_t* qpad, int Np, const int32_t* tk, int Kw,
    const int32_t* qlen, const int32_t* tlen, const int32_t* table, int NT,
    int B, int K, int band, int gap_open, int gap_extend, int local, int affine,
    int banded, int stride, int32_t* score, int32_t* bv, int32_t* bk, int32_t* bs,
    uint8_t* ptr, int R, int32_t* rows, void* stream) {
  if (Np < 1 || K < 1 || K > Kw || R < 2 || (R & (R - 1)) != 0 ||
      (local ? !bv || !bk || (!ptr && !bs) : !score) || (!banded && R < Np + 2))
    return (int)cudaErrorInvalidValue;
  const WfArgs a{qpad,       Np,    tk,     Kw,     qlen,   tlen,  table, NT,  B,
                 K,          band,  gap_open, gap_extend, local, affine, banded,
                 stride,     score, bv,     bk,     bs,     ptr,   R,     rows};
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
  return run_window(a, s);
}
