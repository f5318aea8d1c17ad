// Constants and helpers shared by the seqalib_tpu_torch kernels.  The
// values mirror seqalib_tpu_torch/types.py (NEG_INF, PTR_*) and
// seqalib_tpu_torch/utils/cigar.py (OP_*).
#pragma once

#include <cstdint>

namespace seqalib {

constexpr int kNegInf = -(1 << 30);
// score of a padding sentinel letter (index >= A1); scoring.SENT_SCORE
constexpr int kSentScore = -64;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kPtrStop = 0;
constexpr int kPtrDiag = 1;
constexpr int kPtrUp = 2;
constexpr int kPtrLeft = 3;

constexpr uint8_t kOpM = 0;
constexpr uint8_t kOpI = 1;
constexpr uint8_t kOpD = 2;

// strip_fill modes (ops/strip_fill.py MODES: local, emode, gmode)
constexpr int kLocal = 0;
constexpr int kExtend = 1;
constexpr int kGlobal = 2;

// floor(x / 2) for negative x too (C++ division truncates)
__device__ __forceinline__ int floordiv2(int x) { return (x - (x < 0)) / 2; }

// first band row on anti-diagonal k of a band whose top diagonal is dhi
// (ops/band_fill.py: ihat)
__device__ __forceinline__ int ihat(int k, int dhi) {
  return max(0, floordiv2(k - dhi + 1));
}

// ---- shared by the two strip fills (strip_fill.cu, wavefront_fill.cu):
// the counters a warp publishes its finished columns on ------------------

__device__ __forceinline__ unsigned ld_acquire_cta(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.cta.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(unsigned* p, unsigned v) {
  asm volatile("st.release.cta.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// spin until the counter has reached `want` (the counters wrap around
// 2^32; a difference is what is compared)
__device__ __forceinline__ void wait_for(const unsigned* cnt, unsigned want) {
  while ((int)(ld_acquire_cta(cnt) - want) < 0) {
  }
}

// ---- shared by the two walks that write CIGAR text (strip_walk.cu,
// wavefront_walk.cu) ------------------------------------------------------

__device__ __forceinline__ void cp_async_16(uint32_t dst, const uint8_t* src, int n) {
  // n < 16 copies the first n bytes and zero-fills the rest
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int lds_u8(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=h"(v) : "r"(addr));
  return v;
}

// A pair's CIGAR text row, written from the back by a warp whose lanes all
// walk the same path.  Finished runs wait one per lane (run k of a batch in
// lane k, packed as len << 2 | op) and are written 32 at a time by the
// whole warp, so that formatting their digits stays out of the walker's
// chain of steps.
struct Text {
  uint8_t* row;
  int pos;   // the first byte written so far (every lane)
  int held;  // runs waiting
  int mine;  // lane k: the k-th run waiting
  int lane;

  // the run (op, n) waits in lane `held` if it `ends`, without a branch
  // but every 32nd run
  __device__ __forceinline__ void push(int op, int n, bool ends) {
    mine = lane == held && ends ? n << 2 | op : mine;
    held += ends;
    if (held == 32) flush();
  }
  // each waiting run as its letter, then its digits from the least
  // significant, written back to back from pos down in the order pushed
  __device__ __forceinline__ void flush() {
    const bool has = lane < held;
    int n = mine >> 2;
    int chars = 2;  // the letter and the first digit
    for (int x = n; x >= 10; x /= 10) ++chars;
    chars = has ? chars : 0;
    int upto = chars;  // inclusive prefix sum over the lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, upto, d);
      if (lane >= d) upto += y;
    }
    if (has) {
      int at = pos - upto + chars - 1;  // the run's last byte
      const int op = mine & 3;
      row[at] = op == kOpM ? 'M' : (op == kOpI ? 'I' : 'D');
      do {
        row[--at] = '0' + n % 10;
        n /= 10;
      } while (n);
    }
    pos -= __shfl_sync(kFull, upto, 31);
    held = 0;
  }
};

}  // namespace seqalib
