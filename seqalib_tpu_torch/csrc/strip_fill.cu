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
// Bound on the H100: not memory.  A cell costs ~11-13 integer operations
// and, with pointers, one byte written; the anti-diagonal recurrence makes
// every step of a strip depend on the one before, so a strip is a chain of
// tlen + 32 steps (~105 cycles a step for a warp alone).  The first
// version ran one warp per pair, its strips one after another (~33 800
// dependent steps per 1024^2 pair) and at B=512 ~4 warps per SM: nothing
// hid the chain's latency (4.58 ms for config 3's pass 1 on an H100 80GB
// HBM3 at 700 W; this design 0.76-0.97 ms, against 0.35 ms for its integer
// operations: a step issues ~20 instructions, and neither fewer of them
// nor fewer shared-memory operations made it faster).
//
// Design: one CTA per pair, W warps (ops/strip_fill.py::strip_warps picks
// W from the query width).  Warp w runs strips w, w + W, w + 2W, ... of the
// pair, one lane per query row: at step k lane p computes cell
// (i0 + p + 1, k - p), its up and diagonal neighbours from lane p - 1 by
// __shfl_up_sync, its left one in its own registers.  Lane 0 takes the
// row above (H and F, one 8-byte load) from shared memory: the bottom row
// of strip s - 1, which warp w - 1's lane 31 stores a column per step
// into a ring of kRing columns.  Each warp publishes the columns of its
// bottom row it has finished, every 32 steps, with st.release.cta on a
// counter in shared memory; the warp below waits on it with ld.acquire
// before each chunk of 32 columns, and a warp waits on the counter of the
// warp below before it overwrites ring slots that warp has not read.  The
// counters run on across the rounds (round r, column c is r * S + c, S =
// tlen + 1 rounded up to whole rings, and a finished strip publishes its
// whole share), so counter value x sits in ring slot x mod kRing and one
// comparison covers both.  Warp W - 1's bottom row goes to
// warp 0 of the next round through a full row (in shared memory while it
// fits, else in the global scratch `rows`), which the chain of strips
// keeps from being overwritten before it is read.  All W warps are
// resident together, so a wait never waits on a warp that does not run.
// A pair thus takes ~ceil(strips / W) * (tlen + 32) steps plus ~64 steps
// per warp of pipeline fill, and B=512 pairs put ~31 warps on each SM.
// A step is kept short: the chunks whose 32 steps have every lane inside
// the matrix run unrolled with no column checks, constant offsets into
// the ring, letter and pointer rows, and no shuffles for lane 0's
// neighbour or the letters (the target letters are staged once in shared
// memory, each lane reads its own); Hopper's DPX instructions give each
// max with its extend bit (__vibmax_s32) and the three-way max
// (__vimax3_s32); the best cell is tracked as (value, step) and keyed once
// per strip; gmode's H(qlen, tlen) is the final H of the lane holding row
// qlen.  The substitution table sits in shared memory with a sentinel row
// and column (letters >= A1 score kSentScore).  Only cells of the valid
// box 1 <= i <= qlen, 1 <= j <= tlen are tracked or stored; the rows past
// qlen of the last strip compute values nobody reads.  A reduction over
// the lanes, then the warps, under the canonical rule (max score, then min
// i*(mq+1)+j) ends the local and extension modes.
//
// Pointer layout: dense (B, q_width, t_width - 1) bytes, cell (i, j) at
// [b, i - 1, j - 1]; bits 0-1 PTR_*, bit 2 E-extend, bit 3 F-extend.  Only
// the valid box is written.  In an unrolled chunk a lane's 32 cells are 32
// consecutive bytes of its own row: it gathers them into 4-byte words and
// stores each word once it is whole (the row stride is odd, so a run's
// first and last bytes may fall in words shared with the chunks around it:
// those go out one by one); the checked chunks store a byte a cell.  The
// 32 lanes write 32 rows, so a byte a step made each store instruction 32
// scattered partial writes: words took config 1's fill (B=512 256^2,
// pointers) from 0.71 to 0.38 ms on an H100 80GB HBM3 at 700 W.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kMaxWarps = 8;   // ops/strip_fill.py: MAX_WARPS
constexpr int kRing = 256;     // ring columns between warps: a power of 2, >= 96

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
  int stage_letters;     // target letters staged in shared memory
  int32_t* rows;         // (B, t_width, 2) scratch: the wrap row, or null
                         // (then it lives in shared memory)
  uint8_t* ptr;          // (B, q_width, t_width - 1) or null
  int32_t* bv;           // (B,) best score / captured H(qlen, tlen)
  int32_t* bk;           // (B,) key of the best cell (0 in kGlobal)
};

template <int MODE, bool AFFINE, bool WANT_PTR>
__global__ void __launch_bounds__(kMaxWarps * 32)
    strip_fill_kernel(const FillArgs a) {
  extern __shared__ __align__(16) int32_t smem[];
  const int W = blockDim.x >> 5;
  const int A2 = a.A1 + 1;
  const int tw = a.t_width;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  // shared layout: rings, [wrap row], table, counters, reduction, [letters]
  int2* ring = reinterpret_cast<int2*>(smem);  // (W - 1) x kRing
  int32_t* p32 = smem + 2 * (W - 1) * kRing;
  int2* full;
  if (a.rows == nullptr) {
    full = reinterpret_cast<int2*>(p32);
    p32 += 2 * tw;
  } else {
    full = reinterpret_cast<int2*>(a.rows) + (size_t)b * tw;
  }
  int32_t* tab = p32;
  p32 += A2 * A2;
  unsigned* cnt = reinterpret_cast<unsigned*>(p32);
  p32 += kMaxWarps;
  int32_t* red = p32;
  p32 += 2 * kMaxWarps;
  const int32_t* tb = a.t2 + (size_t)b * tw;
  const int32_t* tl = a.stage_letters ? p32 : tb;

  const int n = a.qlen[b];
  const int m = a.tlen[b];
  const int e = a.gap_extend;
  const int oe = a.gap_open + a.gap_extend;
  const int go = AFFINE ? a.gap_open : 0;
  const unsigned sent = (unsigned)a.A1;
  for (int x = tid; x < A2 * A2; x += blockDim.x) {
    const int r = x / A2;
    const int c = x - r * A2;
    tab[x] = (r < a.A1 && c < a.A1) ? a.table[r * a.A1 + c] : kSentScore;
  }
  if (a.stage_letters) {
    for (int x = tid; x < tw; x += blockDim.x) p32[x] = tb[x];
  }
  if (tid < kMaxWarps) cnt[tid] = 0;
  // DP row 0 for warp 0's first strip: local H = 0; global/extension
  // H(0, j) = [o +] j*e, H(0, 0) = 0; F is -inf on row 0 in every mode
  for (int j = tid; j <= m; j += blockDim.x) {
    full[j] = make_int2((MODE == kLocal || j == 0) ? 0 : go + j * e, kNegInf);
  }
  __syncthreads();

  const int lane = tid & 31;
  const int w = tid >> 5;
  const int nstrips = m > 0 ? (n + 31) >> 5 : 0;
  const unsigned mp1 = (unsigned)m + 1;
  // a round's share of the counters: columns [0, m] rounded up to whole
  // rings, so that counter value x of a ring's stream sits in slot x mod kRing
  const unsigned rstride = (mp1 + kRing - 1) & ~(unsigned)(kRing - 1);
  const int stride = a.mq + 1;
  const int32_t* qb = a.q + (size_t)b * a.q_width;
  const size_t pcols = (size_t)(tw - 1);
  // the row above comes from warp w - 1's ring, or (warp 0) the wrap row;
  // the bottom row goes to this warp's ring, or (warp W - 1) the wrap row
  const int2* src = w == 0 ? full : ring + (w - 1) * kRing;
  const unsigned smask = w == 0 ? ~0u : (unsigned)(kRing - 1);
  int2* dst = w == W - 1 ? full : ring + w * kRing;
  const unsigned dmask = w == W - 1 ? ~0u : (unsigned)(kRing - 1);
  const unsigned* up_cnt = cnt + (w == 0 ? W - 1 : w - 1);
  const unsigned* down_cnt = cnt + (w + 1 < W ? w + 1 : w);

  int best = 0, bkey = 0;
  unsigned round = 0;
  for (int s = w; s < nstrips; s += W, ++round) {
    const int i = (s << 5) + lane + 1;
    const bool row_ok = i <= n;
    const unsigned ql = row_ok ? min((unsigned)qb[i - 1], sent) : sent;
    const int32_t* srow = tab + ql * A2;
    const int hcol = (MODE == kLocal) ? 0 : go + i * e;  // H(i, 0)
    const bool down = s + 1 < nstrips;  // a strip below reads this bottom row
    const bool put = down && lane == 31;
    // ring slots are reused: wait on the warp below (not for the wrap row)
    const bool backpressure = down && w + 1 < W;
    const unsigned mine = round * rstride;  // this strip's column 0 in counter units
    const unsigned above = w == 0 ? mine - rstride : mine;  // the strip above's
    uint8_t* prow = nullptr;  // column j at prow[j]
    if (WANT_PTR && row_ok) prow = a.ptr + ((size_t)b * a.q_width + (i - 1)) * pcols - 1;
    int H = hcol;    // H(i, j - 1)
    int E = kNegInf; // E(i, j - 1)
    int F = kNegInf; // F(i, j - 1)
    int Hdiag = 0;   // H(i - 1, j - 1)
    int sbest = best, sk = -1;  // this strip's best (value, step)

    // one cell of the valid columns: step k, neighbours above, letter t
    // returns the cell's pointer byte (0 without pointers)
    auto cell = [&](int k, int Hup, int Fup, unsigned t) -> int {
      const int d = Hdiag + srow[min(t, sent)];
      Hdiag = Hup;
      int up, left, bestv;
      bool ext_e = false, ext_f = false;
      if (AFFINE) {
        E = __vibmax_s32(E + e, H + oe, &ext_e);
        F = __vibmax_s32(Fup + e, Hup + oe, &ext_f);
        up = F;
        left = E;
      } else {
        up = Hup + e;
        left = H + e;
      }
      bestv = __vimax3_s32(d, up, left);
      H = (MODE == kLocal) ? max(bestv, 0) : bestv;
      int p = 0;
      if (WANT_PTR) {
        p = d == bestv ? kPtrDiag : (up == bestv ? kPtrUp : kPtrLeft);
        if (MODE == kLocal && bestv <= 0) p = kPtrStop;
        if (AFFINE) p |= (ext_e ? 4 : 0) | (ext_f ? 8 : 0);
      }
      if (MODE != kGlobal && H > sbest) {  // strict: first max in scan order
        sbest = H;
        sk = k;
      }
      return p;
    };

    for (int c0 = 0; c0 < m + 32; c0 += 32) {
      // the row above's columns [c0, c0 + 32) are published
      wait_for(up_cnt, above + min((unsigned)c0 + 32, mp1));
      // lane 31 writes columns up to c0: the warp below has read c0 - kRing
      if (backpressure) wait_for(down_cnt, mine + (unsigned)(c0 - kRing + 1));
      if (c0 >= 32 && c0 + 31 <= m) {
        // every lane inside the matrix for all 32 steps: no checks
        const int2* sc = src + ((unsigned)c0 & smask);
        int2* d_lo = dst + ((unsigned)(c0 - 32) & dmask) + 1;  // columns c0 - 31 + u
        int2* d_hi = dst + ((unsigned)c0 & dmask);             // column c0
        const int32_t* tc = tl + (c0 - lane);
        // the lane's 32 bytes pc[0..31] go out as aligned words, the head
        // and tail bytes of an unaligned run one by one
        uint8_t* pc = WANT_PTR ? prow + (c0 - lane) : nullptr;
        const unsigned ph = WANT_PTR ? (unsigned)(uintptr_t)pc & 3u : 0u;
        uint32_t acc = 0;
#pragma unroll
        for (int u = 0; u < 32; ++u) {
          int Hup = __shfl_up_sync(kFull, H, 1);   // H(i - 1, j)
          int Fup = AFFINE ? __shfl_up_sync(kFull, F, 1) : 0;
          if (lane == 0) {
            const int2 v = sc[u];
            Hup = v.x;
            Fup = v.y;
          }
          const int p = cell(c0 + u, Hup, Fup, (unsigned)tc[u]);
          if (WANT_PTR) {
            const unsigned pos = (ph + u) & 3u;
            acc |= (uint32_t)p << (8 * pos);
            if (pos == 3 && row_ok) {
              if (u >= 3) {
                *reinterpret_cast<uint32_t*>(pc + u - 3) = acc;
              } else {  // the head: bytes 0..u of the run
                for (int x = 0; x <= u; ++x) pc[x] = (uint8_t)(acc >> (8 * (ph + x)));
              }
            }
            if (pos == 3) acc = 0;
          }
          if (put) {
            if (u < 31) d_lo[u] = make_int2(H, F);
            else *d_hi = make_int2(H, F);
          }
        }
        if (WANT_PTR && row_ok) {  // the tail: bytes past the last whole word
          const int last = (int)((ph + 31) & 3u);
          if (last != 3) {
            for (int x = 0; x <= last; ++x) pc[31 - last + x] = (uint8_t)(acc >> (8 * x));
          }
        }
      } else {
#pragma unroll 1
        for (int k = c0; k < c0 + 32; ++k) {
          const int j = k - lane;
          int Hup = __shfl_up_sync(kFull, H, 1);
          int Fup = AFFINE ? __shfl_up_sync(kFull, F, 1) : 0;
          if (lane == 0 && k <= m) {
            const int2 v = src[(unsigned)k & smask];
            Hup = v.x;
            Fup = v.y;
          }
          if (j >= 1 && j <= m) {
            const int p = cell(k, Hup, Fup, (unsigned)tl[j]);
            if (WANT_PTR && row_ok) prow[j] = (uint8_t)p;
          } else {
            Hdiag = Hup;
            if (j == 0) {
              H = hcol;
              E = kNegInf;
              F = kNegInf;
            }
          }
          if (put && j >= 0 && j <= m) dst[(unsigned)j & dmask] = make_int2(H, F);
        }
      }
      // lane 31 has finished columns [0, c0]: publish them (its own stores
      // are ordered before the release)
      if (lane == 31) st_release_cta(cnt + w, mine + min((unsigned)c0 + 1, mp1));
    }
    // the strip is done: the whole round's share, so that the warp above may
    // reuse every ring slot of it
    if (lane == 31) st_release_cta(cnt + w, mine + rstride);
    if (MODE == kGlobal) {
      // after the strip a lane's H is H(i, m)
      if (i == n) a.bv[b] = H;
    } else if (row_ok && sk >= 0) {
      best = sbest;
      bkey = i * stride + (sk - lane);
    }
  }

  if (MODE != kGlobal) {
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_down_sync(kFull, best, off);
      const int ok = __shfl_down_sync(kFull, bkey, off);
      if (ob > best || (ob == best && ok < bkey)) {
        best = ob;
        bkey = ok;
      }
    }
    if (lane == 0) {
      red[2 * w] = best;
      red[2 * w + 1] = bkey;
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (MODE == kGlobal) {
      if (nstrips == 0) a.bv[b] = 0;
      a.bk[b] = 0;
    } else {
      best = red[0];
      bkey = red[1];
      for (int x = 1; x < W; ++x) {
        const int ob = red[2 * x], ok = red[2 * x + 1];
        if (ob > best || (ob == best && ok < bkey)) {
          best = ob;
          bkey = ok;
        }
      }
      a.bv[b] = best;
      a.bk[b] = bkey;
    }
  }
}

template <int MODE, bool AFFINE, bool WANT_PTR>
int launch(const FillArgs& a, int warps, size_t smem, cudaStream_t stream) {
  auto kernel = strip_fill_kernel<MODE, AFFINE, WANT_PTR>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<a.B, warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE, bool WANT_PTR>
int launch_gaps(const FillArgs& a, bool affine, int warps, size_t smem,
                cudaStream_t stream) {
  return affine ? launch<MODE, true, WANT_PTR>(a, warps, smem, stream)
                : launch<MODE, false, WANT_PTR>(a, warps, smem, stream);
}

}  // namespace

// smem_bytes: the dynamic shared memory of the layout above, computed by
// ops/strip_fill.py::strip_smem (rows == null puts the wrap row there)
extern "C" int seqalib_strip_fill(const int32_t* q, int q_width,
                                  const int32_t* t2, int t_width,
                                  const int32_t* qlen, const int32_t* tlen,
                                  const int32_t* table, int A1, int B, int mq,
                                  int gap_open, int gap_extend, int affine,
                                  int mode, int warps, int stage_letters,
                                  int smem_bytes, int32_t* rows, uint8_t* ptr,
                                  int32_t* bv, int32_t* bk, void* stream) {
  if (warps < 1 || warps > kMaxWarps || t_width < 1) return (int)cudaErrorInvalidValue;
  const FillArgs a{q,  q_width, t2,       t_width,    qlen,          tlen, table,
                   A1, B,       mq,       gap_open,   gap_extend, stage_letters,
                   rows, ptr,   bv,       bk};
  const bool want_ptr = ptr != nullptr;
  const bool aff = affine != 0;
  const size_t smem = (size_t)smem_bytes;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kLocal:
      return want_ptr ? launch_gaps<kLocal, true>(a, aff, warps, smem, s)
                      : launch_gaps<kLocal, false>(a, aff, warps, smem, s);
    case kExtend:
      if (want_ptr) return (int)cudaErrorInvalidValue;
      return launch_gaps<kExtend, false>(a, aff, warps, smem, s);
    case kGlobal:
      return want_ptr ? launch_gaps<kGlobal, true>(a, aff, warps, smem, s)
                      : launch_gaps<kGlobal, false>(a, aff, warps, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
