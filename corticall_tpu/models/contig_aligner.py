"""Whole-contig aligner — the lastz replacement (LastzAligner.java:15-29).

The reference shells out to lastz for whole-contig placements in NAHR
analyses.  Here the same role is a production command (AlignContigs) built
on the framework's own stack: exact-seed chaining (IndexedReference) picks
candidate windows per contig, the batched banded Smith-Waterman scan
(ops/sw_device.banded_sw_scores) scores EVERY candidate of EVERY contig in
one device dispatch per batch, and only each contig's winning candidates
are Gotoh-tracebacked on the host for cigars.

The device pre-score runs when device.gpu_available() (or use_device=True);
on the CPU every candidate goes straight to the host traceback.
"""

from __future__ import annotations

import numpy as np

from .. import kmer as km


# the single compiled device shape (see align_contigs step 2) and the
# smallest batch worth one device dispatch
DEV_Q = 4096
DEV_S = 8192
DEV_BAND = 512
MIN_DEVICE_BATCH = 8


def _pow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 << max(n - 1, 0).bit_length()


def align_contigs(queries: dict, references: dict, band: int = 512,
                  max_chains: int = 8, use_device: bool | None = None,
                  stats: dict | None = None) -> dict:
    """{query_name: [Alignment...]} per contig across ALL references.

    queries: {name: sequence}; references: {ref_name: IndexedReference}.
    band: SW band for both the device pre-score and the host window
    extension (512 = the lastz-class whole-contig configuration).
    """
    if use_device is None:
        from ..device import gpu_available
        use_device = gpu_available()

    # 1. seed-chain candidates per (query, reference)
    cand: dict = {qn: [] for qn in queries}
    for qn, qseq in queries.items():
        for rn, ir in references.items():
            for name, neg, r0, window in ir.candidate_windows(
                    qseq, max_chains=max_chains, band=band):
                cand[qn].append((ir, rn, name, neg, r0, window))

    # 2. batched device pre-score at one (DEV_Q, DEV_S) shape, the batch
    # padded to a power of two: every distinct program shape costs a
    # compile, so the whole Call stage compiles a handful of programs (kept
    # by the persistent compile cache) and each batch is one dispatch.
    # Pre-scored: every query with several candidates whose query and
    # windows all fit the shape; engaged only when that batch is big enough
    # to amortize the dispatch.  Per pre-scored query only candidates within
    # drop_ratio of its device-best go to host traceback; every other query
    # keeps all its candidates.
    survivors: dict = {qn: list(range(len(cand[qn]))) for qn in cand}
    n_scored = 0
    items = [(qn, ci) for qn in cand
             if len(cand[qn]) > 1 and len(queries[qn]) <= DEV_Q
             and all(len(c[5]) <= DEV_S for c in cand[qn])
             for ci in range(len(cand[qn]))]
    if use_device and len(items) >= MIN_DEVICE_BATCH:
        from ..ops import sw_device as swd
        import jax.numpy as jnp

        qs_list, ws_list = [], []
        for qn, ci in items:
            ir, rn, name, neg, r0, window = cand[qn][ci]
            qseq = queries[qn]
            qs_list.append(km.revcomp(qseq) if neg else qseq)
            ws_list.append(window)
        pad = [""] * (_pow2(len(items)) - len(items))
        qcodes = swd.codes_batch(qs_list + pad, DEV_Q)
        wcodes = swd.codes_batch(ws_list + pad, DEV_S)
        sc, _, _ = swd.banded_sw_scores(
            jnp.asarray(qcodes), jnp.asarray(wcodes), band=DEV_BAND)
        sc = np.asarray(sc)
        n_scored = len(items)
        scores = {key: float(s) for key, s in zip(items, sc)}
        for qn in {qn for qn, _ in items}:
            ss = [scores[(qn, ci)] for ci in range(len(cand[qn]))]
            best = max(ss)
            keep = [ci for ci, s in enumerate(ss) if s >= 0.8 * best]
            # length-aware guard: final ranking is by alignment LENGTH
            # desc then NM asc (rank/sortAlignments parity), so a long,
            # diverged placement (the one a mosaic/NAHR contig needs) must
            # not be pruned just because a short exact repeat hit out-scores
            # it — also keep any candidate whose window span exceeds the
            # longest score-surviving window
            max_span = max((len(cand[qn][ci][5]) for ci in keep), default=0)
            keep += [ci for ci in range(len(cand[qn]))
                     if ci not in keep and len(cand[qn][ci][5]) > max_span]
            survivors[qn] = sorted(keep)

    # 3. host traceback of the surviving candidates only
    out: dict = {}
    for qn in cand:
        alignments = []
        for ci in survivors[qn]:
            ir, rn, name, neg, r0, window = cand[qn][ci]
            a = ir.extend_window(queries[qn], name, neg, r0, window)
            if a is not None:
                a.reference = rn
                alignments.append(a)
        if alignments:
            type(next(iter(references.values()))).rank(alignments)
        out[qn] = alignments
    if stats is not None:
        stats["device_scored_windows"] = n_scored
        stats["host_tracebacks"] = sum(len(v) for v in survivors.values())
    return out
