"""The one traffic generator: batches of letter-code sequences from a seed
and a traffic file's parameters.

A traffic file (``traffic/<name>.json``) gives:

* ``alphabet``: letters are drawn uniformly from codes ``0 .. alphabet - 1``
  (4 for DNA; 20 for the amino acids, the first 20 letters of a protein
  matrix's header);
* ``length``: the query's length, a number or a range ``[lo, hi]`` drawn
  uniformly a query;
* ``batch``: queries a call; ``targets``: targets a call (``batch`` unless
  given); ``pool``: distinct batches, cycled through the window;
  ``check``: pairs of the pool, drawn from the seed, whose every answer in
  the window is compared with the reference;
* ``target``: ``"mutate"`` (the default: target ``k`` is query ``k``
  changed) or ``"random"`` (unrelated letters, ``target_length`` a number
  or a range);
* for ``"mutate"``, in this order: ``substitution_rate``: each letter
  changed, with this chance, to another letter; ``indel_rate``: at each
  letter, with this chance, an insertion (share ``insertion_share``, 0.5
  unless given) or a deletion, of a length drawn from ``indel_length``
  ``[lo, hi]``; ``edits``: then ``{"op": "delete"|"insert", "length": k}``,
  each at a place drawn uniformly from the target as it stands;
* ``request``: the call and what it answers (``drive.py``).

The same seed gives the same batches.  Fixed lengths and edits give every
seed the same sizes; the substitutions and the places of the edits vary
from pair to pair, so that each pair has its own score and alignment: a
program that answered one pair for another is caught.  Long reads against
their template with substitutions is the generator of the port's CLI config
4 (BASELINE.json:10), and the three edits of the genome pair are
``tools/profile_port.py``'s SP pair, there at fixed places and with exactly
``length // 50`` substitutions.
"""

from __future__ import annotations

import numpy as np


def _length(rng, spec) -> int:
    """A length: the number itself, or one drawn from ``[lo, hi]``."""
    if isinstance(spec, int):
        return spec
    lo, hi = spec
    return int(rng.integers(int(lo), int(hi) + 1))


def _indels(rng, t: np.ndarray, traffic: dict) -> np.ndarray:
    """``t`` with an indel at each letter with chance ``indel_rate``."""
    alphabet = int(traffic["alphabet"])
    at = np.flatnonzero(rng.random(len(t)) < float(traffic["indel_rate"]))
    insert = rng.random(len(at)) < float(traffic.get("insertion_share", 0.5))
    lo, hi = traffic["indel_length"]
    k = rng.integers(int(lo), int(hi) + 1, len(at))
    letters = rng.integers(0, alphabet, int(k[insert].sum()))
    pieces, cursor, used = [], 0, 0
    for p, ins, n in zip(at.tolist(), insert.tolist(), k.tolist()):
        if p < cursor:  # inside the last deletion
            continue
        pieces.append(t[cursor:p])
        if ins:
            pieces.append(letters[used: used + n])
            used += n
            cursor = p
        else:
            cursor = p + n
    pieces.append(t[cursor:])
    return np.concatenate(pieces)


def target_of(rng, q: np.ndarray | None, traffic: dict) -> np.ndarray:
    """The target: unrelated letters, or query ``q`` changed by
    substitutions, then indels, then the fixed edits."""
    alphabet = int(traffic["alphabet"])
    if traffic.get("target", "mutate") == "random":
        return rng.integers(0, alphabet, _length(rng, traffic["target_length"])).astype(np.uint8)
    t = q.copy()
    idx = np.flatnonzero(rng.random(len(q)) < float(traffic.get("substitution_rate", 0)))
    t[idx] = (t[idx] + 1 + rng.integers(0, alphabet - 1, len(idx))) % alphabet
    if traffic.get("indel_rate", 0):
        t = _indels(rng, t, traffic)
    for edit in traffic.get("edits", []):
        k = int(edit["length"])
        if edit["op"] == "delete":
            at = int(rng.integers(0, len(t) - k + 1))
            t = np.delete(t, np.arange(at, at + k))
        elif edit["op"] == "insert":
            at = int(rng.integers(0, len(t) + 1))
            t = np.insert(t, at, rng.integers(0, alphabet, k))
        else:
            raise ValueError(f"unknown edit {edit['op']!r}")
    return t.astype(np.uint8)


def sizes(traffic: dict) -> tuple[int, int]:
    """(queries, targets) a call."""
    nq = int(traffic["batch"])
    nt = int(traffic.get("targets", nq))
    if nt != nq and traffic.get("target", "mutate") != "random":
        raise ValueError("a mutated target needs its query: targets must equal batch")
    return nq, nt


def pool(seed: int, traffic: dict):
    """``traffic["pool"]`` batches: a list of (queries, targets) lists."""
    rng = np.random.default_rng(seed)
    alphabet = int(traffic["alphabet"])
    nq, nt = sizes(traffic)
    out = []
    for _ in range(int(traffic["pool"])):
        qs, ts = [], []
        for k in range(max(nq, nt)):
            q = None
            if k < nq:
                q = rng.integers(0, alphabet, _length(rng, traffic["length"])).astype(np.uint8)
                qs.append(q)
            if k < nt:
                ts.append(target_of(rng, q, traffic))
        out.append((qs, ts))
    return out


def check_sample(seed: int, traffic: dict, pairs_per_batch: int):
    """The (batch, pair) places whose answers are compared, drawn from the
    seed apart from the pairs themselves; ``pair`` indexes a call's
    answers."""
    n_pool = int(traffic["pool"])
    k = min(int(traffic["check"]), n_pool * pairs_per_batch)
    rng = np.random.default_rng([seed, 1])
    flat = sorted(rng.choice(n_pool * pairs_per_batch, k, replace=False).tolist())
    return [(x // pairs_per_batch, x % pairs_per_batch) for x in flat]
