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
// Bound on the H100: latency, not memory or integer throughput.  A cell
// costs ~25 integer operations and reads two letters and one table word;
// the state never leaves shared memory.  Every diagonal depends on the two
// before it, so one pair is a chain of K steps, each a warp sync plus a
// few shared-memory round trips over Wp/32 slots per lane.  With one warp
// per pair, config 4's B=64 fills 64 of the 132 SMs with one warp each.
//
// Design: one warp (one block) per pair.  The slot rows H(k), H(k-1),
// H(k-2) rotate through three shared-memory buffers and E, F through two;
// lane l computes slots l, l+32, ... and a __syncwarp closes each diagonal.
// Neighbour slots wrap around Wp, as the TPU's circular lane rolls do (the
// wrap brings in a slot that is NEG_INF or a cell that is thrown away), so
// every slot, junk included, holds the TPU kernel's value.  The TPU slid
// letter windows and a packed-nibble profile along the band because it has
// no gathers; here each slot reads its two letters by index and looks the
// score up in a shared-memory table whose sentinel entries score as the
// TPU kernel scored its sentinels.  The TPU's clamp/dyn/steady phase split,
// its NSUB unrolling, letter streaming and batch padding change no value
// and are not carried over.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kFill = 0;
constexpr int kPtr = 1;
constexpr int kEmode = 2;

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
};

// offset of bout's F plane
__device__ __forceinline__ size_t plane_bo(const BandArgs& a) {
  return (size_t)a.B * a.Wbo;
}

template <int MODE>
__global__ void __launch_bounds__(32) band_fill_kernel(const BandArgs a) {
  extern __shared__ int32_t smem[];
  const int Wp = a.Wp;
  const int NT = a.NT;
  int32_t* tab = smem;          // NT * NT
  int32_t* Hb = tab + NT * NT;  // 3 rows: H at k, k-1, k-2 (rotating)
  int32_t* Eb = Hb + 3 * Wp;    // 2 rows
  int32_t* Fb = Eb + 2 * Wp;    // 2 rows
  int32_t* BV = Fb + 2 * Wp;    // kEmode: BV, BK, EV
  int32_t* BK = BV + Wp;
  int32_t* EV = BK + Wp;
  uint8_t* lo = reinterpret_cast<uint8_t*>(BV);  // kPtr: pending nibbles

  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  for (int x = lane; x < NT * NT; x += 32) tab[x] = a.table[x];
  const size_t plane = (size_t)a.B * Wp;
  const size_t row = (size_t)b * Wp;
  for (int p = lane; p < Wp; p += 32) {
    Hb[Wp + p] = a.state[row + p];                // H(k0 - 1)
    Hb[2 * Wp + p] = a.state[plane + row + p];    // H(k0 - 2)
    Eb[p] = a.state[2 * plane + row + p];
    Fb[p] = a.state[3 * plane + row + p];
    if (MODE == kEmode) {
      BV[p] = a.state[4 * plane + row + p];
      BK[p] = a.state[5 * plane + row + p];
      EV[p] = a.score[row + p];
    }
  }
  __syncwarp();

  const int qlen = a.qlen[b];
  const int tlen = a.tlen[b];
  const int dlov = a.dlo_p[b];
  const int dhiv = a.dhi_p[b];
  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  const unsigned last = (unsigned)(NT - 1);
  const int32_t* qb = a.qk + (size_t)b * a.q_width;
  const int32_t* tb = a.tk + (size_t)b * a.t_width;
  int hn = 0, h1 = 1, h2 = 2, ec = 0;  // buffer indices
  for (int k = a.k0; k < a.k1; ++k) {
    if (MODE == kFill && a.CK > 0 && (k - a.k0) % a.CK == 0) {
      int32_t* ck = a.ckpt + (size_t)((k - a.k0) / a.CK) * 4 * plane + row;
      for (int p = lane; p < Wp; p += 32) {
        ck[p] = Hb[h1 * Wp + p];
        ck[plane + p] = Hb[h2 * Wp + p];
        ck[2 * plane + p] = Eb[ec * Wp + p];
        ck[3 * plane + p] = Fb[ec * Wp + p];
      }
    }
    const int ih = ihat(k, a.dhi);
    const int d1 = ih - ihat(k - 1, a.dhi);  // 0 or 1
    const int d2 = ih - ihat(k - 2, a.dhi);  // 0, 1 or 2
    const int32_t* H1 = Hb + h1 * Wp;
    const int32_t* H2 = Hb + h2 * Wp;
    const int32_t* E1 = Eb + ec * Wp;
    const int32_t* F1 = Fb + ec * Wp;
    int32_t* Hn = Hb + hn * Wp;
    int32_t* En = Eb + (ec ^ 1) * Wp;
    int32_t* Fn = Fb + (ec ^ 1) * Wp;
    // boundary capture: column bx of bout takes slot pcap's H and F
    const int bx = k - 2 * a.bout_row;
    const int pcap = a.bout_row - ih;
    const bool cap = MODE != kEmode && a.bout != nullptr && bx >= 0 && bx < a.Wbo;
    if (cap && lane == 0 && (pcap < 0 || pcap >= Wp)) {  // no slot: 0, as the TPU
      a.bout[(size_t)b * a.Wbo + bx] = 0;
      a.bout[plane_bo(a) + (size_t)b * a.Wbo + bx] = 0;
    }
    for (int p = lane; p < Wp; p += 32) {
      int pl = p + d1;  // left: (p + d1) mod Wp
      if (pl >= Wp) pl -= Wp;
      int pu = pl - 1;  // up: (p + d1 - 1) mod Wp
      if (pu < 0) pu += Wp;
      int pd = p + d2 - 1;  // diagonal: (p + d2 - 1) mod Wp
      if (pd < 0) pd += Wp;
      if (pd >= Wp) pd -= Wp;
      const int i = ih + p;
      const int j = k - i;
      const unsigned qc = i < a.q_width ? min((unsigned)qb[i], last) : last;
      const unsigned tc =
          j < 0 ? 0u : (j < a.t_width ? min((unsigned)tb[j], last) : last);
      const int s = tab[qc * NT + tc];
      const int e_ext = E1[pl] + e, e_opn = H1[pl] + oe;
      const int f_ext = F1[pu] + e, f_opn = H1[pu] + oe;
      int E = max(e_ext, e_opn);
      int F = max(f_ext, f_opn);
      const int d = H2[pd] + s;
      const int best = max(max(d, F), E);
      const bool origin = k == 0 && i == 0;
      int H;
      if (MODE == kEmode) {
        H = origin ? 0 : best;
        if (p == Wp - 1) H = E = F = kNegInf;
        if (H > BV[p]) {  // strict: the first maximum of the slot
          BV[p] = H;
          BK[p] = k;
        }
        if (a.tie_safe) {
          const int cand =
              (p == 0 && k > a.dhi) ? E : (p == Wp - 2 ? F : kNegInf);
          EV[p] = max(EV[p], cand - a.smax * i);
        }
      } else {
        if (MODE == kPtr) {  // from the unmasked values, as the TPU kernel
          int nib = origin ? kPtrStop
                           : (d == best ? kPtrDiag
                                        : (F == best ? kPtrUp : kPtrLeft));
          nib |= (e_ext >= e_opn ? 4 : 0) | (f_ext >= f_opn ? 8 : 0);
          const int r = k - a.k0;
          if ((r & 1) == 0) {
            lo[p] = (uint8_t)nib;
          } else {
            a.ptr[((size_t)(r >> 1) * a.B + b) * Wp + p] =
                (uint8_t)(lo[p] | (nib << 4));
          }
        }
        const int dkj = j - i;
        const bool ok = dkj >= dlov && dkj <= dhiv && i <= qlen && j >= 0 &&
                        j <= tlen && !origin;
        H = origin ? 0 : (ok ? best : kNegInf);
        if (!ok) E = F = kNegInf;
        if (a.bh != nullptr && p == 0 && k <= a.dhi) {  // local row 0
          const size_t x = (size_t)b * a.Wb + min(k, a.Wb - 1);
          H = a.bh[x];
          F = a.bf[x];
        }
        if (cap && p == pcap) {
          a.bout[(size_t)b * a.Wbo + bx] = H;
          a.bout[plane_bo(a) + (size_t)b * a.Wbo + bx] = F;
        }
        if (MODE == kFill && k == qlen + tlen && i == qlen && k < a.K)
          a.score[row + p] = max(a.score[row + p], H);
      }
      Hn[p] = H;
      En[p] = E;
      Fn[p] = F;
    }
    __syncwarp();  // the diagonal is complete before the next reads it
    const int t = h2;
    h2 = h1;
    h1 = hn;
    hn = t;
    ec ^= 1;
  }

  for (int p = lane; p < Wp; p += 32) {
    a.state[row + p] = Hb[h1 * Wp + p];
    a.state[plane + row + p] = Hb[h2 * Wp + p];
    a.state[2 * plane + row + p] = Eb[ec * Wp + p];
    a.state[3 * plane + row + p] = Fb[ec * Wp + p];
    if (MODE == kEmode) {
      a.state[4 * plane + row + p] = BV[p];
      a.state[5 * plane + row + p] = BK[p];
      a.score[row + p] = EV[p];
    }
  }
}

template <int MODE>
int launch(const BandArgs& a, cudaStream_t stream) {
  size_t words = (size_t)a.NT * a.NT + 7 * (size_t)a.Wp;
  if (MODE == kEmode) words += 3 * (size_t)a.Wp;
  if (MODE == kPtr) words += ((size_t)a.Wp + 3) / 4;
  const size_t smem = words * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        band_fill_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  band_fill_kernel<MODE><<<a.B, 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seqalib_band_fill(
    const int32_t* qk, int q_width, const int32_t* tk, int t_width,
    const int32_t* qlen, const int32_t* tlen, const int32_t* dlo_p,
    const int32_t* dhi_p, const int32_t* table, int NT, int B, int Wp, int k0,
    int k1, int K, int dhi, int gap_open, int gap_extend, int mode, int CK,
    int tie_safe, int smax, int32_t* state, int32_t* score, int32_t* ckpt,
    uint8_t* ptr, const int32_t* bh, const int32_t* bf, int Wb, int32_t* bout,
    int Wbo, int bout_row, void* stream) {
  if ((bh != nullptr && Wb < 1) || (bout != nullptr && (Wbo < 1 || bout_row < 0)))
    return (int)cudaErrorInvalidValue;
  const BandArgs a{qk,    q_width, tk,       t_width,    qlen,  tlen,     dlo_p,
                   dhi_p, table,   NT,       B,          Wp,    k0,       k1,
                   K,     dhi,     gap_open, gap_extend, CK,    tie_safe, smax,
                   state, score,   ckpt,     ptr,        bh,    bf,       Wb,
                   bout,  Wbo,     bout_row};
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
