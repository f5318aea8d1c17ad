// Constants shared by the seqalib_tpu_torch kernels.  The values mirror
// seqalib_tpu/types.py (NEG_INF, PTR_*) and seqalib_tpu/utils/cigar.py
// (OP_*), which the Python side of the port imports.
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

}  // namespace seqalib
