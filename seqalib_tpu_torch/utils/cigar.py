"""CIGAR codec.

M = both consumed (match or mismatch), I = query consumed (gap in target),
D = target consumed (gap in query): SAM semantics with query = rows,
target = reference.  Kernels emit fixed-width op arrays (the op codes
below, padded with OP_PAD); this module run-length-encodes them to
strings and back.  Everything but ``op_rows_to_cigars`` is a copy of the
JAX package's ``seqalib_tpu/utils/cigar.py``; ``op_rows_to_cigars``
encodes a whole op matrix at once (the port's engines call it) and is held
equal to ``ops_to_cigar`` by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

OP_M = 0
OP_I = 1
OP_D = 2
OP_PAD = 255

OP_CHARS = "MID"
_CHAR_TO_OP = {c: i for i, c in enumerate(OP_CHARS)}


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
