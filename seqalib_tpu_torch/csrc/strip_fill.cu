// Strip-tiled Smith-Waterman / Needleman-Wunsch fill, linear or affine gaps.
//
// Replaces seqalib_tpu/ops/strip_pallas.py::_strip_kernel (launched by
// _strip_fill), in its three modes:
//   kLocal   local fill tracking the canonical end cell (pass 1), optional
//            pointer stream with STOP at cells whose best is <= 0;
//   kExtend  the TPU's `emode`: global-recurrence boundaries, no zero clamp,
//            argmax tracking (pass 2, the anchored reverse extension);
//   kGlobal  the TPU's `gmode`: captures H(qlen, tlen), optional pointer
//            stream (global alignment and pass 3).
// Tie-breaks are the oracle's: DIAG > UP(F) > LEFT(E), extend >= open, and
// the best cell is the first maximum in (i, j) scan order.
//
// Bound on the H100: not memory.  A cell costs ~15 integer operations and,
// with pointers, one byte written; the anti-diagonal recurrence makes every
// step depend on the previous one, so one warp's time is a chain of
// shuffle + max latencies (~strips * (tlen + 32) steps).  With one warp per
// pair, the main path's B=512 gives ~4 warps per SM: the card is latency
// bound and far from its integer throughput.
//
// Design: one warp per pair, one lane per query row.  Strips of 32 rows run
// in sequence inside the warp; at step k lane p computes cell
// (i0 + p + 1, k - p), so the up and diagonal neighbours come from lane
// p - 1 by __shfl_up_sync and the left one stays in the lane's registers.
// The bottom row of a strip (H and F) passes to the next strip through a
// per-pair row buffer in global memory (hrow/frow); lane 0 reads it in
// 32-column blocks, one coalesced load per 32 steps, then takes one word
// per step by shuffle.  The TPU's packed-nibble profile existed because the
// TPU has no gathers; here the substitution table sits in shared memory and
// every table, scalar or BLOSUM62, is a lookup (letters >= A1, the padding
// sentinels, score kSentScore).  Only cells of the valid box
// 1 <= i <= qlen, 1 <= j <= tlen are computed, tracked or stored.  A warp
// reduction under the canonical rule (max score, then min i*(mq+1)+j)
// ends the local and extension modes.
//
// Pointer layout: dense (B, q_width, t_width - 1) bytes, cell (i, j) at
// [b, i - 1, j - 1]; bits 0-1 PTR_*, bit 2 E-extend, bit 3 F-extend.  Only
// the valid box is written.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kWarpsPerBlock = 4;

struct FillArgs {
  const int32_t* q;      // (B, q_width) query letters, row i at [i - 1]
  int q_width;
  const int32_t* t2;     // (B, t_width) target letters, column j at [j]
  int t_width;
  const int32_t* qlen;   // (B,)
  const int32_t* tlen;   // (B,)
  const int32_t* table;  // (A1, A1)
  int A1;
  int B;
  int mq;                // key stride is mq + 1
  int gap_open;
  int gap_extend;
  int32_t* hrow;         // (B, t_width) scratch: bottom row H of the strip
  int32_t* frow;         // (B, t_width) scratch: bottom row F (affine)
  uint8_t* ptr;          // (B, q_width, t_width - 1) or null
  int32_t* bv;           // (B,) best score / captured H(qlen, tlen)
  int32_t* bk;           // (B,) key of the best cell (0 in kGlobal)
};

template <int MODE, bool AFFINE, bool WANT_PTR>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    strip_fill_kernel(const FillArgs a) {
  extern __shared__ int32_t tab[];  // (A1 + 1)^2, sentinel row/column last
  const int A2 = a.A1 + 1;
  for (int x = threadIdx.x; x < A2 * A2; x += blockDim.x) {
    const int r = x / A2;
    const int c = x - r * A2;
    tab[x] = (r < a.A1 && c < a.A1) ? a.table[r * a.A1 + c] : kSentScore;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= a.B) return;  // uniform across the warp
  const int n = a.qlen[b];
  const int m = a.tlen[b];
  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  const int go = AFFINE ? a.gap_open : 0;
  const int stride = a.mq + 1;
  const unsigned sent = (unsigned)a.A1;
  const int32_t* qb = a.q + (size_t)b * a.q_width;
  const int32_t* tb = a.t2 + (size_t)b * a.t_width;
  int32_t* Hrow = a.hrow + (size_t)b * a.t_width;
  int32_t* Frow = a.frow + (size_t)b * a.t_width;
  const size_t pcols = (size_t)(a.t_width - 1);
  uint8_t* Pb = WANT_PTR ? a.ptr + (size_t)b * a.q_width * pcols : nullptr;

  // DP row 0: local H = 0; global/extension H(0, j) = [o +] j*e, H(0,0) = 0.
  // F is -inf on row 0 in every mode.
  for (int j = lane; j <= m; j += 32) {
    Hrow[j] = (MODE == kLocal || j == 0) ? 0 : go + j * e;
    if (AFFINE) Frow[j] = kNegInf;
  }
  __syncwarp();

  int best = 0, bkey = 0, cap = 0;
  for (int i0 = 0; m > 0 && i0 < n; i0 += 32) {
    const int i = i0 + lane + 1;
    const bool row_ok = i <= n;
    const unsigned ql = row_ok ? (unsigned)qb[i - 1] : sent;
    const int32_t* srow = tab + min(ql, sent) * A2;
    const int hcol = (MODE == kLocal) ? 0 : go + i * e;  // H(i, 0)
    int H = hcol;            // H(i, j - 1)
    int E = kNegInf;         // E(i, j - 1)
    int F = kNegInf;         // F(i, j - 1)
    int Hdiag = 0;           // H(i - 1, j - 1)
    unsigned W = sent;       // letter of column j
    int tfeed = 0, hfeed = 0, ffeed = kNegInf;
    for (int k = 0; k < m + 32; ++k) {
      if ((k & 31) == 0) {
        // this strip's lane 31 writes column c at step c + 31, so the
        // block [k, k + 32) still holds the previous strip's bottom row
        const int x = k + lane;
        tfeed = x <= m ? tb[x] : (int)sent;
        hfeed = x <= m ? Hrow[x] : 0;
        if (AFFINE) ffeed = x <= m ? Frow[x] : kNegInf;
      }
      const int src = k & 31;
      int Hup = __shfl_up_sync(kFull, H, 1);  // H(i - 1, j)
      int Fup = AFFINE ? __shfl_up_sync(kFull, F, 1) : 0;
      unsigned Wn = __shfl_up_sync(kFull, W, 1);
      const int fh = __shfl_sync(kFull, hfeed, src);
      const int ff = AFFINE ? __shfl_sync(kFull, ffeed, src) : 0;
      const unsigned ft = (unsigned)__shfl_sync(kFull, tfeed, src);
      if (lane == 0) {
        Hup = fh;
        Fup = ff;
        Wn = ft;
      }
      W = Wn;
      const int Hd = Hdiag;
      Hdiag = Hup;
      const int j = k - lane;
      if (j >= 1 && j <= m) {
        const int d = Hd + srow[min(W, sent)];
        int up, left;
        bool ext_e = false, ext_f = false;
        if (AFFINE) {
          const int e_ext = E + e, e_opn = H + oe;
          const int f_ext = Fup + e, f_opn = Hup + oe;
          E = max(e_ext, e_opn);
          F = max(f_ext, f_opn);
          ext_e = e_ext >= e_opn;
          ext_f = f_ext >= f_opn;
          up = F;
          left = E;
        } else {
          up = Hup + e;
          left = H + e;
        }
        const int bestv = max(d, max(up, left));
        H = (MODE == kLocal) ? max(bestv, 0) : bestv;
        if (row_ok) {
          if (WANT_PTR) {
            int p = d == bestv ? kPtrDiag : (up == bestv ? kPtrUp : kPtrLeft);
            if (MODE == kLocal && bestv <= 0) p = kPtrStop;
            if (AFFINE) p |= (ext_e ? 4 : 0) | (ext_f ? 8 : 0);
            Pb[(size_t)(i - 1) * pcols + (j - 1)] = (uint8_t)p;
          }
          if (MODE == kGlobal) {
            if (i == n && j == m) cap = H;
          } else if (H > best) {  // strict: first max in scan order
            best = H;
            bkey = i * stride + j;
          }
        }
      } else if (j == 0) {
        H = hcol;
        E = kNegInf;
        F = kNegInf;
      }
      if (lane == 31 && j >= 0 && j <= m) {
        Hrow[j] = H;
        if (AFFINE) Frow[j] = F;
      }
    }
    __syncwarp();  // the bottom row is complete before the next strip reads it
  }

  if (MODE == kGlobal) {
    cap = __shfl_sync(kFull, cap, n >= 1 ? (n - 1) & 31 : 0);
    if (lane == 0) {
      a.bv[b] = (n >= 1 && m >= 1) ? cap : 0;
      a.bk[b] = 0;
    }
  } else {
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_down_sync(kFull, best, off);
      const int ok = __shfl_down_sync(kFull, bkey, off);
      if (ob > best || (ob == best && ok < bkey)) {
        best = ob;
        bkey = ok;
      }
    }
    if (lane == 0) {
      a.bv[b] = best;
      a.bk[b] = bkey;
    }
  }
}

template <int MODE, bool AFFINE, bool WANT_PTR>
void launch(const FillArgs& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)((a.B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = (size_t)(a.A1 + 1) * (a.A1 + 1) * sizeof(int32_t);
  strip_fill_kernel<MODE, AFFINE, WANT_PTR>
      <<<grid, kWarpsPerBlock * 32, smem, stream>>>(a);
}

template <int MODE>
void launch_mode(const FillArgs& a, bool affine, bool want_ptr,
                 cudaStream_t stream) {
  if (affine) {
    if (want_ptr) launch<MODE, true, true>(a, stream);
    else launch<MODE, true, false>(a, stream);
  } else {
    if (want_ptr) launch<MODE, false, true>(a, stream);
    else launch<MODE, false, false>(a, stream);
  }
}

}  // namespace

extern "C" int seqalib_strip_fill(const int32_t* q, int q_width,
                                  const int32_t* t2, int t_width,
                                  const int32_t* qlen, const int32_t* tlen,
                                  const int32_t* table, int A1, int B, int mq,
                                  int gap_open, int gap_extend, int affine,
                                  int mode, int32_t* hrow, int32_t* frow,
                                  uint8_t* ptr, int32_t* bv, int32_t* bk,
                                  void* stream) {
  const FillArgs a{q,  q_width,  t2,         t_width, qlen, tlen,
                   table, A1, B, mq,  gap_open, gap_extend, hrow, frow,
                   ptr, bv,  bk};
  const bool want_ptr = ptr != nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kLocal:
      launch_mode<kLocal>(a, affine != 0, want_ptr, s);
      break;
    case kExtend:
      launch_mode<kExtend>(a, affine != 0, want_ptr, s);
      break;
    case kGlobal:
      launch_mode<kGlobal>(a, affine != 0, want_ptr, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
