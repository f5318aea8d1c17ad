"""The JAX package behind ``seqalib_tpu_torch.sweep.PortAPI``'s methods, for
the port's sweep and property tests (``tests/test_torch_sweep.py``,
``tests/test_torch_properties.py``): the same draws and identity checks
run through either package.  JAX is imported inside each method, so that
a run of those files on the card, where only their ``cuda`` cases run,
needs no JAX."""

from seqalib_tpu_torch import sweep


class JaxAPI:
    """``sweep.PortAPI``'s methods on the JAX package (imported here, so
    that the card's run of this file needs no JAX).  The strip route runs
    JAX's ``"xla"`` backend, or its ``"pallas"`` one with ``pallas``; calls
    are kept, so that routes asking the same call share it."""

    def __init__(self, pallas=False):
        self.pallas = pallas
        self.calls = {}

    @staticmethod
    def scoring(sp):
        from seqalib_tpu.types import ScoringParams

        return ScoringParams(match=sp.match, mismatch=sp.mismatch, gap_open=sp.gap_open,
                             gap_extend=sp.gap_extend, matrix=sp.matrix)

    @staticmethod
    def mesh():
        import jax

        from seqalib_tpu.parallel import band_pipeline

        return band_pipeline.make_band_mesh(jax.devices()[: sweep.MESH])

    def _kept(self, key, fn):
        if key not in self.calls:
            self.calls[key] = fn()
        return self.calls[key]

    def align_batch(self, qs, ts, sp, mode, backend="strip", **kw):
        import seqalib_tpu.api as sa_api

        if backend in ("strip", "pallas"):
            backend = "pallas" if self.pallas else "xla"
        key = ("batch", tuple(q.tobytes() for q in qs), tuple(t.tobytes() for t in ts),
               sp.gap_open, sp.gap_extend, sp.match, mode, backend, tuple(sorted(kw.items())))
        return self._kept(key, lambda: sa_api.align_batch(qs, ts, scoring=sp, mode=mode,
                                                           backend=backend, **kw))

    def align(self, q, t, sp, mode, **kw):
        import seqalib_tpu as sa

        return sa.align(q, t, sp, mode=mode, **kw)

    def align_all_vs_all(self, reads, refs, sp, mode):
        import seqalib_tpu as sa

        return sa.align_all_vs_all(reads, refs, scoring=sp, mode=mode, backend="xla",
                                   chunk_pairs=4)

    def sp(self, name, *args, **kw):
        import seqalib_tpu as sa

        return getattr(sa, name)(*args, **kw)
