// CIGAR text of the banded walk's op rows (ops/band_cigar.py), written on
// the card.
//
// Replaces no Pallas kernel: it replaces a host step of models/banded.py,
// the op matrix's copy to the host (the ops of every diagonal, half of them
// padding: 31 MB for 132 reads of 100 kb) and the run-length encoding there
// (utils/cigar.py op_rows_to_cigars, a Python string a run).  Here the rows
// stay on the card and only the text comes back, right-aligned in its row as
// strip_walk and wavefront_walk write theirs (common.cuh, Text), so that
// strip_walk.cigars_from_text decodes all three.
//
// Bound on the H100: bytes.  Each op byte is read once and each character
// written once (132 rows of ~238 000 ops and ~20 KB of text: ~10 µs at
// 3.35 TB/s); the scans are a few hundred cycles a tile.
//
// Design: one CTA per row (a row holds ~120 000 ops in ~5 000 runs), which
// reads its row in tiles of 16 bytes a thread and scans it from its end, the
// alignment's last op first.  So the text is written from the back of its
// row in one pass, with no counting pass before: the runs met first are the
// CIGAR's last.  Per tile, two block-wide scans (CUB's BlockScan):
//   1. over the threads' non-pad ops, a run summary (first and last op,
//      count, the last run start after the first op), which tells each
//      thread the op before its bytes and where the run holding it started;
//   2. over the characters of the runs each thread closes (a run closes at
//      the next run's first op), the thread's text offset.
// Each scan's prefix callback carries the summary and the offset from tile
// to tile, so a run may span any number of threads and tiles.  The run open
// at the row's start (the alignment's first) closes after the last tile.
// The next tile's bytes are loaded before the current one is scanned.
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace seqalib;

constexpr int kThreads = 256;
constexpr int kBytes = 16;  // ops a thread reads a tile: one 16-byte load
constexpr int kTile = kThreads * kBytes;
constexpr unsigned kPad = 255;  // utils/cigar.py OP_PAD

// The non-pad ops of a stretch of a row, in the order scanned.
struct Runs {
  int first;  // its first op, -1 for none
  int last;   // its last op, -1 for none
  int count;  // its ops
  int start;  // the index of its last op that differs from the op before it, -1 for none
};

__device__ __forceinline__ Runs no_runs() { return Runs{-1, -1, 0, -1}; }

struct Join {
  __device__ __forceinline__ Runs operator()(const Runs& a, const Runs& b) const {
    if (b.count == 0) return a;
    if (a.count == 0) return b;
    const int start = b.start >= 0 ? a.count + b.start : (b.first != a.last ? a.count : a.start);
    return Runs{a.first, b.last, a.count + b.count, start};
  }
};

// the prefix of each tile's scans: what the tiles before it held
struct CarryRuns {
  Runs sofar;
  __device__ Runs operator()(const Runs& tile) {
    const Runs before = sofar;
    sofar = Join()(sofar, tile);
    return before;
  }
};

struct CarryChars {
  int sofar;
  __device__ int operator()(int tile) {
    const int before = sofar;
    sofar += tile;
    return before;
  }
};

__device__ __forceinline__ int digits(int n) {
  int d = 1;
  for (; n >= 10; n /= 10) ++d;
  return d;
}

// a run's text, its digits then its letter, ending just before `end`
__device__ __forceinline__ void put_run(uint8_t* end, int op, int n) {
  *--end = op == kOpM ? 'M' : (op == kOpI ? 'I' : 'D');
  do {
    *--end = '0' + n % 10;
    n /= 10;
  } while (n);
}

// the thread's 16 ops of the tile in scan order (from the row's end): byte j
// of the result is column hi - j, OP_PAD left of column 0
template <bool kAligned>
__device__ __forceinline__ uint4 load_ops(const uint8_t* __restrict__ row, int hi) {
  if (kAligned) {  // the row and its width are 16-byte multiples: all or none in the row
    if (hi < kBytes - 1) return make_uint4(~0u, ~0u, ~0u, ~0u);
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + hi - (kBytes - 1)));
    return make_uint4(__byte_perm(w.w, 0, 0x0123), __byte_perm(w.z, 0, 0x0123),
                      __byte_perm(w.y, 0, 0x0123), __byte_perm(w.x, 0, 0x0123));
  }
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = hi - 4 * q - k;
      w[q] |= (c >= 0 ? (uint32_t)__ldg(row + c) : kPad) << (8 * k);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int op_at(const uint4& v, int j) {
  const uint32_t w = j < 4 ? v.x : (j < 8 ? v.y : (j < 12 ? v.z : v.w));
  return (w >> (8 * (j & 3))) & 0xff;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
    band_cigar_kernel(const uint8_t* __restrict__ ops, int KW, uint8_t* __restrict__ text,
                      int L, int32_t* __restrict__ nchar) {
  using ScanRuns = cub::BlockScan<Runs, kThreads>;
  using ScanChars = cub::BlockScan<int, kThreads>;
  __shared__ typename ScanRuns::TempStorage runs_tmp;
  __shared__ typename ScanChars::TempStorage chars_tmp;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* row = ops + (size_t)b * KW;
  uint8_t* const end = text + (size_t)b * L + L;  // the text is written back from here
  CarryRuns carry_runs{no_runs()};
  CarryChars carry_chars{0};
  const int tiles = (KW + kTile - 1) / kTile;
  uint4 next = load_ops<kAligned>(row, KW - 1 - tid * kBytes);
  for (int t = 0; t < tiles; ++t) {
    const uint4 v = next;
    if (t + 1 < tiles) next = load_ops<kAligned>(row, KW - 1 - (t + 1) * kTile - tid * kBytes);
    Runs mine = no_runs();
#pragma unroll
    for (int j = 0; j < kBytes; ++j) {
      const int op = op_at(v, j);
      if (op == kPad) continue;
      if (mine.count == 0) {
        mine.first = op;
      } else if (op != mine.last) {
        mine.start = mine.count;
      }
      mine.last = op;
      ++mine.count;
    }
    Runs before;
    ScanRuns(runs_tmp).ExclusiveScan(mine, before, Join(), carry_runs);
    // the runs this thread closes: the one open before it at its first op
    // that differs, then each of its own but its last
    const int first_op = before.last;
    const int first_start = before.start >= 0 ? before.start : 0;
    int op = first_op, at = first_start, g = before.count, chars = 0;
#pragma unroll
    for (int j = 0; j < kBytes; ++j) {
      const int o = op_at(v, j);
      if (o == kPad) continue;
      if (op >= 0 && o != op) {
        chars += digits(g - at) + 1;
        at = g;
      }
      op = o;
      ++g;
    }
    int offset;
    ScanChars(chars_tmp).ExclusiveSum(chars, offset, carry_chars);
    if (chars) {
      uint8_t* pos = end - offset;
      op = first_op, at = first_start, g = before.count;
#pragma unroll
      for (int j = 0; j < kBytes; ++j) {
        const int o = op_at(v, j);
        if (o == kPad) continue;
        if (op >= 0 && o != op) {
          put_run(pos, op, g - at);
          pos -= digits(g - at) + 1;
          at = g;
        }
        op = o;
        ++g;
      }
    }
    __syncthreads();  // the scans' storage is used again by the next tile
  }
  if (tid == 0) {  // thread 0's callbacks hold the whole row
    const Runs all = carry_runs.sofar;
    int n = carry_chars.sofar;
    if (all.count) {
      const int len = all.count - (all.start >= 0 ? all.start : 0);
      put_run(end - n, all.last, len);
      n += digits(len) + 1;
    }
    nchar[b] = n;
  }
}

}  // namespace

extern "C" int seqalib_band_cigar(const uint8_t* ops, int B, int KW, uint8_t* text, int L,
                                  int32_t* nchar, void* stream) {
  if (B < 1 || KW < 0 || L < 2 * KW) return (int)cudaErrorInvalidValue;
  const bool aligned = KW % kBytes == 0 && ((uintptr_t)ops % kBytes) == 0;
  if (aligned) {
    band_cigar_kernel<true><<<B, kThreads, 0, (cudaStream_t)stream>>>(ops, KW, text, L, nchar);
  } else {
    band_cigar_kernel<false><<<B, kThreads, 0, (cudaStream_t)stream>>>(ops, KW, text, L, nchar);
  }
  return (int)cudaGetLastError();
}
