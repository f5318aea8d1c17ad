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
// Bound on the H100: latency.  Each pair is a chain of K = n + m + 1
// anti-diagonals; a cell costs ~15 integer operations, reads two letters
// and a table word, and in pointer mode writes one byte (K x Np bytes per
// pair, the one large output).  The TPU kernel computes every slot of every
// diagonal, the ones outside the band and the matrix included, and so does
// this one: the junk slots with j < 0 feed the extend bits of column 0, and
// the CPU tests hold every pointer byte the walk can read to the TPU's.
//
// Design: one CTA per pair; thread x computes slots x, x + blockDim, ...
// (Np can exceed a CTA's threads).  The slot rows live in shared memory
// while they fit (else in a global scratch buffer, through the same
// pointer): H and F of the previous diagonal, double-buffered so that one
// __syncthreads closes a diagonal; E and the shifted H of two diagonals back
// are read and written only by the slot's own thread, in place.  Letters
// are read by index and scored from a shared-memory table whose sentinel
// entries score as the TPU kernel's route scored them; the TPU's rolling
// target window, bf16 profile banks and sublane gathers are not needed.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

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
  int32_t* rows;   // (B, 6, Np) scratch, or null: rows in shared memory
};

template <bool PTR>
__global__ void __launch_bounds__(1024) wavefront_fill_kernel(const WfArgs a) {
  extern __shared__ int32_t smem[];
  const int NT = a.NT;
  const int Np = a.Np;
  const int b = blockIdx.x;
  const int nthr = blockDim.x;
  int32_t* tab = smem;
  int32_t* st = a.rows ? a.rows + (size_t)b * 6 * Np : tab + NT * NT;
  int32_t* Hb = st;           // 2 rows: H of the diagonals, alternating
  int32_t* Fb = st + 2 * Np;  // 2 rows: F likewise
  int32_t* Er = st + 4 * Np;  // E of the previous diagonal (own slot)
  int32_t* Sr = st + 5 * Np;  // H(k - 2) at slot i - 1 (own slot)

  for (int x = threadIdx.x; x < NT * NT; x += nthr) tab[x] = a.table[x];
  for (int i = threadIdx.x; i < Np; i += nthr) {
    Hb[Np + i] = kNegInf;  // the previous diagonal of k = 0 is row 1
    Fb[Np + i] = kNegInf;
    Er[i] = kNegInf;
    Sr[i] = kNegInf;
  }
  __syncthreads();

  const int qlen = a.qlen[b];
  const int tlen = a.tlen[b];
  const int delta = tlen - qlen;
  const int dlo = min(0, delta) - a.band;
  const int dhi = max(0, delta) + a.band;
  const int fin = qlen + tlen;
  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  const unsigned last = (unsigned)(NT - 1);
  const int32_t* qb = a.qpad + (size_t)b * Np;
  const int32_t* tb = a.tk + (size_t)b * a.Kw;
  for (int k = 0; k < a.K; ++k) {
    const int cur = k & 1;
    const int32_t* H1 = Hb + (cur ^ 1) * Np;
    const int32_t* F1 = Fb + (cur ^ 1) * Np;
    int32_t* Hn = Hb + cur * Np;
    int32_t* Fn = Fb + cur * Np;
    for (int i = threadIdx.x; i < Np; i += nthr) {
      const int j = k - i;
      const unsigned qc = min((unsigned)qb[i], last);
      const unsigned tc = j < 0 ? 0u : min((unsigned)tb[j], last);
      const int s = tab[qc * NT + tc];
      const int hl = H1[i];                      // (i, j - 1)
      const int hu = i > 0 ? H1[i - 1] : kNegInf;  // (i - 1, j)
      const int fu = i > 0 ? F1[i - 1] : kNegInf;
      const int d = Sr[i] + s;  // (i - 1, j - 1) + s
      const int e_ext = Er[i] + e, e_opn = hl + oe;
      const int f_ext = fu + e, f_opn = hu + oe;
      int E = max(e_ext, e_opn);
      int F = max(f_ext, f_opn);
      const int best = max(max(d, F), E);
      int H = best;
      int p = d == best ? kPtrDiag : (F == best ? kPtrUp : kPtrLeft);
      if (k == 0 && i == 0) {
        H = 0;
        p = kPtrStop;
      }
      const int dkj = k - 2 * i;
      if (dkj < dlo || dkj > dhi) H = E = F = kNegInf;
      if (k == fin && i == qlen) a.score[b] = H;
      if (PTR) {
        p |= (e_ext >= e_opn ? 4 : 0) | (f_ext >= f_opn ? 8 : 0);
        a.ptr[((size_t)k * a.B + b) * Np + i] = (uint8_t)p;
      }
      Hn[i] = H;
      Fn[i] = F;
      Er[i] = E;
      Sr[i] = hu;
    }
    __syncthreads();  // the diagonal is complete before the next reads it
  }
}

template <bool PTR>
int launch(const WfArgs& a, cudaStream_t stream) {
  size_t words = (size_t)a.NT * a.NT;
  if (!a.rows) words += 6 * (size_t)a.Np;
  const size_t smem = words * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        wavefront_fill_kernel<PTR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int threads = min(1024, (a.Np + 31) / 32 * 32);
  wavefront_fill_kernel<PTR><<<a.B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seqalib_wavefront_fill(
    const int32_t* qpad, int Np, const int32_t* tk, int Kw,
    const int32_t* qlen, const int32_t* tlen, const int32_t* table, int NT,
    int B, int K, int band, int gap_open, int gap_extend, int32_t* score,
    uint8_t* ptr, int32_t* rows, void* stream) {
  if (Np < 1 || K < 1 || K > Kw) return (int)cudaErrorInvalidValue;
  const WfArgs a{qpad, Np,   tk,       Kw,         qlen,  tlen,
                 table, NT,  B,        K,          band,  gap_open,
                 gap_extend, score, ptr, rows};
  cudaStream_t s = (cudaStream_t)stream;
  return ptr ? launch<true>(a, s) : launch<false>(a, s);
}
