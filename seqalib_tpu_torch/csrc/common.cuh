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

}  // namespace seqalib
