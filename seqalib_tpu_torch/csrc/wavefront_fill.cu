// Full-matrix anti-diagonal wavefront, global affine with a band mask:
// the score of cell (qlen, tlen) and, optionally, every cell's pointer.
//
// Replaces seqalib_tpu/ops/wavefront_pallas.py::_fill_kernel (launched by
// _fill) in the modes the JAX package reaches with it: pallas_bucket's
// banded branch for substitution tables outside the packed-nibble range,
// global, affine, band mask, with pointers or score-only.  Local mode with
// start propagation, linear gaps and unbanded fills are not reached by any
// entry point and not ported.  ops/wavefront.py's docstring states the
// layout, the inputs and the outputs.
// Tie-breaks are the oracle's: DIAG > UP(F) > LEFT(E), extend >= open.
//
// Bound on the H100: the chain of K = n + m + 1 anti-diagonals of each
// pair (~0.27 us a diagonal for the window, one barrier each), and in
// pointer mode the K x B x Np bytes of the pointer stream.
// The TPU kernel computes every slot of every diagonal; the first port did
// too, one CTA of up to 1024 threads per pair, a barrier and global letter
// loads per diagonal (~0.97 us each at the wide-table shape, where only
// ~66 of 1024 slots lie in the band).
//
// Design.  A slot i of diagonal k (cell (i, k - i)) reads, from the
// diagonals before, only slots whose d = k - 2i differs from its own by at
// most one; every slot with d outside [dlo, dhi] is masked to -inf.  So a
// slot with d outside [dlo - 1, dhi + 1] has only -inf inputs, and its
// pointer byte depends on its letters alone:
//   (s >= max(e, o + e) ? DIAG : UP) | (e >= o + e) << 2 | (e >= o + e) << 3.
// Two kernels therefore write the output, one after the other on the
// caller's stream:
// - wf_far_kernel, pointer mode only: that byte for every (k, b, i), no DP
//   state; a CTA stages a rule table (one byte per letter pair) and the
//   target letters of its tile of diagonals and slots in shared memory,
//   each thread keeps 16 slots' query rows in registers and stores 16
//   bytes at a time.  It moves the stream's bytes (151 MB at the
//   wide-table shape, K 2049 x B 64 x Np 1152).
// - wf_window_kernel, one CTA per pair: only the slots i in [lo(k), hi(k)],
//   d in [dlo - 1, dhi + 1] (about band + |delta| / 2 + 2 of them) carry
//   state; it overwrites their bytes and captures H(qlen, tlen).  One
//   thread per window slot (at most 1024, looping past that); the slot
//   rows sit in a ring of R >= window + 2 slots indexed by i mod R (H and
//   F double buffered, E and the shifted H in place), in shared memory
//   while it fits, else in the global scratch `rows`; one barrier per
//   diagonal.  Any band (up to every slot) and any delta fit: the ring
//   grows with the window, never capped.
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
  int32_t* score;  // (B,) out: H(qlen, tlen); zeroed by the wrapper
  uint8_t* ptr;    // (K, B, Np) or null
  int R;           // ring slots of the window, a power of 2
  int32_t* rows;   // (B, 6, R) scratch of the ring, or null (shared)
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
  const int thr = max(e, oe);
  const int ext = e >= oe ? 12 : 0;
  const unsigned last = (unsigned)(NT - 1);
  for (int x = threadIdx.x; x < NT * NT; x += blockDim.x) {
    rule[x] = (uint8_t)((a.table[x] >= thr ? kPtrDiag : kPtrUp) | ext);
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
    if (k == 0 && i == 0) word[0] = (word[0] & ~0xffu) | (uint32_t)(kPtrStop | ext);
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

// one cell of slot i on diagonal k from its inputs; returns H, sets E, F
// and the pointer byte (taken before the mask, as the TPU kernel's)
struct Cell {
  int H, E, F, p;
  __device__ __forceinline__ Cell(int k, int i, const Band& bd, int sc, int Hd,
                                  int Hl, int El, int Hu, int Fu, int e, int oe) {
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
__global__ void __launch_bounds__(1024) wf_window_kernel(const WfArgs a) {
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
      const Cell c(k, i, bd, tab[qc * NT + tc], in1 ? Ur[r] : kNegInf,
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

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <bool PTR>
int launch_window(const WfArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.NT * a.NT * sizeof(int32_t) +
                      (a.rows ? 0 : 6 * (size_t)a.R * sizeof(int32_t));
  const int rc = set_smem((const void*)wf_window_kernel<PTR>, smem);
  if (rc) return rc;
  // one thread per window slot, at most 1024
  const int threads = min(1024, (min(a.R, a.Np) + 31) / 32 * 32);
  wf_window_kernel<PTR><<<a.B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// R: the window's ring, a power of 2 >= the widest window + 2; rows: its
// global scratch, or null (shared memory); ops/wavefront.py::window_ring
// picks them
extern "C" int seqalib_wavefront_fill(
    const int32_t* qpad, int Np, const int32_t* tk, int Kw,
    const int32_t* qlen, const int32_t* tlen, const int32_t* table, int NT,
    int B, int K, int band, int gap_open, int gap_extend, int32_t* score,
    uint8_t* ptr, int R, int32_t* rows, void* stream) {
  if (Np < 1 || K < 1 || K > Kw || R < 2 || (R & (R - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const WfArgs a{qpad, Np, tk,       Kw,         qlen,  tlen, table, NT, B,
                 K,    band, gap_open, gap_extend, score, ptr,  R,     rows};
  cudaStream_t s = (cudaStream_t)stream;
  if (ptr) {  // the far bytes first; the window kernel overwrites its own
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
    return launch_window<true>(a, s);
  }
  return launch_window<false>(a, s);
}
