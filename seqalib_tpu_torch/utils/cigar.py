"""CIGAR codec.

M = both consumed (match or mismatch), I = query consumed (gap in target),
D = target consumed (gap in query): SAM semantics with query = rows,
target = reference.  Kernels emit fixed-width op arrays (the op codes
below, padded with OP_PAD); this module run-length-encodes them to
strings and back.

The op codes, ``ops_to_cigar``, ``cigar_to_ops``, ``cigar_consumed``,
``transpose_cigar`` and ``rescore_global_affine`` are copies of the JAX
package's (``rescore_global_affine`` of ``parallel/band_pipeline.py``), held
to it by ``tests/test_torch_copies.py``.  The port's own: the walkers'
states ``ST_*``, ``op_rows_to_cigars`` (a whole op matrix at once), and the
CIGAR text its kernels write: each CIGAR in ASCII at the end of its row of
``text`` (B, W) uint8, its length in ``nchar`` (``BAD_START``: the walk
started outside its pointers), built by ``pack_text`` on the host and
decoded by ``cigars_from_text``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..telemetry import count_d2h

OP_M = 0
OP_I = 1
OP_D = 2
OP_PAD = 255

OP_CHARS = "MID"
_CHAR_TO_OP = {c: i for i, c in enumerate(OP_CHARS)}

ST_H, ST_E, ST_F = 0, 1, 2
BAD_START = -1  # nchar of a walk whose start cell lies outside its pointers


def ops_to_cigar(ops: Sequence[int]) -> str:
    """Run-length-encode a sequence of op codes (query-to-target order)."""
    out: List[str] = []
    run_op = -1
    run_len = 0
    for op in ops:
        op = int(op)
        if op == OP_PAD:
            break
        if op == run_op:
            run_len += 1
        else:
            if run_len:
                out.append(f"{run_len}{OP_CHARS[run_op]}")
            run_op = op
            run_len = 1
    if run_len:
        out.append(f"{run_len}{OP_CHARS[run_op]}")
    return "".join(out)


def cigar_to_ops(cigar: str) -> List[int]:
    ops: List[int] = []
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            if ch not in _CHAR_TO_OP or num == 0:
                raise ValueError(f"bad CIGAR {cigar!r}")
            ops.extend([_CHAR_TO_OP[ch]] * num)
            num = 0
    if num:
        raise ValueError(f"trailing count in CIGAR {cigar!r}")
    return ops


def cigar_consumed(cigar: str) -> Tuple[int, int]:
    """(query_consumed, target_consumed) lengths implied by a CIGAR."""
    q = t = 0
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            if ch == "M":
                q += num
                t += num
            elif ch == "I":
                q += num
            elif ch == "D":
                t += num
            else:
                raise ValueError(f"bad CIGAR op {ch!r}")
            num = 0
    return q, t


def transpose_cigar(cigar: str) -> str:
    """CIGAR of the alignment with query and target swapped (I <-> D)."""
    return cigar.translate(str.maketrans("ID", "DI"))


def _merge_runs(rows, ops, lens):
    """Join neighbouring runs of the same row and op."""
    new = np.ones(rows.size, bool)
    new[1:] = (rows[1:] != rows[:-1]) | (ops[1:] != ops[:-1])
    starts = np.flatnonzero(new)
    return rows[starts], ops[starts], np.add.reduceat(lens, starts) if starts.size else lens


def op_rows_to_cigars(ops: np.ndarray, head_op=None, head_len=None) -> List[str]:
    """CIGARs of the rows of a (B, L) op matrix, ``OP_PAD`` slots skipped
    wherever they stand; row b may start with a run of ``head_len[b]``
    ops ``head_op[b]``.  The runs of all rows are found with NumPy at
    once, so Python steps once per run and once per row."""
    ops = np.asarray(ops)
    keep = ops != OP_PAD
    vals = ops[keep]  # every row's ops, row after row
    ends = np.cumsum(keep.sum(axis=1))
    new = np.ones(vals.size, bool)
    np.not_equal(vals[1:], vals[:-1], out=new[1:])
    new[ends[ends < vals.size]] = True  # a row's first op starts a run
    starts = np.flatnonzero(new)
    rows = np.searchsorted(ends, starts, side="right")
    run_ops = vals[starts].astype(np.int64)
    run_lens = np.diff(starts, append=vals.size)
    if head_len is not None:
        hr = np.flatnonzero(np.asarray(head_len) > 0)
        rows = np.concatenate([hr, rows])
        run_ops = np.concatenate([np.asarray(head_op, np.int64)[hr], run_ops])
        run_lens = np.concatenate([np.asarray(head_len, np.int64)[hr], run_lens])
        order = np.argsort(rows, kind="stable")  # each head before its row
        rows, run_ops, run_lens = _merge_runs(rows[order], run_ops[order], run_lens[order])
    pieces = [f"{n}{OP_CHARS[op]}" for n, op in zip(run_lens.tolist(), run_ops.tolist())]
    bounds = np.searchsorted(rows, np.arange(ops.shape[0] + 1)).tolist()
    return ["".join(pieces[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def bad_start(b: int):
    """The error of a walk whose pair b started outside its pointers."""
    return ValueError(f"walk: pair {b}'s start cell lies outside P")


def pack_text(strings, W: int):
    """``(text, nchar)`` as NumPy arrays: each string in ASCII at the end of
    its row of ``text`` (B, W) uint8 (zeros before it), and its length."""
    text = np.zeros((len(strings), W), np.uint8)
    nchar = np.empty(len(strings), np.int32)
    for b, s in enumerate(strings):
        nchar[b] = len(s)
        text[b, W - len(s):] = np.frombuffer(s.encode("ascii"), np.uint8)
    return text, nchar


def cigars_from_text(text, nchar) -> list[str]:
    """The CIGARs of a walk from its ``text`` tensor and its ``nchar``,
    best already on the host (a device tensor costs one more copy): copies
    only the last max(nchar) bytes of the text rows, and decodes one slice
    per pair.  Raises ``ValueError`` when a pair's start cell lay outside
    its pointers."""
    nchar = torch.as_tensor(nchar)
    n = nchar.tolist()
    if min(n, default=0) < 0:
        raise bad_start(n.index(BAD_START))
    W = max(n, default=0)
    tail = text[:, text.shape[1] - W:].contiguous()
    raw = tail.cpu().numpy().tobytes()
    count_d2h(nchar, tail)
    return [raw[(b + 1) * W - x: (b + 1) * W].decode("ascii") for b, x in enumerate(n)]


def rescore_global_affine(q, t, ops, sp) -> int:
    """Score a global alignment given as a CIGAR op list (verification)."""
    if sp.matrix is not None:
        tbl = np.asarray(sp.substitution_matrix())
        _subst = lambda a, b: int(tbl[a, b])  # noqa: E731
    else:
        _subst = lambda a, b: sp.match if a == b else sp.mismatch  # noqa: E731
    i = j = s = 0
    prev = None
    for op in ops:
        if op == OP_M:
            s += _subst(int(q[i]), int(t[j]))
            i += 1
            j += 1
        else:
            s += sp.gap_extend + (sp.gap_open if op != prev else 0)
            if op == OP_I:
                i += 1
            else:
                j += 1
        prev = op
    if i != len(q) or j != len(t):  # survives python -O
        raise RuntimeError("CIGAR must consume both sequences")
    return s
