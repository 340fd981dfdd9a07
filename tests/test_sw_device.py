"""Device banded SW vs host Gotoh oracle."""

import numpy as np
import pytest

from corticall_tpu.models.sw import SmithWaterman
from corticall_tpu.ops import sw_device as swd


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _cases(rng, n_cases, qlen=120, slen=150, max_shift=20):
    qs, ss = [], []
    for _ in range(n_cases):
        s = _genome(rng, slen)
        shift = int(rng.integers(0, max_shift))
        q = s[shift:shift + qlen]
        kind = rng.integers(0, 4)
        if kind == 1 and len(q) > 40:        # SNP
            p = int(rng.integers(10, len(q) - 10))
            q = q[:p] + "ACGT"[("ACGT".index(q[p]) + 1) % 4] + q[p + 1:]
        elif kind == 2 and len(q) > 40:      # deletion in query
            p = int(rng.integers(10, len(q) - 15))
            q = q[:p] + q[p + 4:]
        elif kind == 3 and len(q) > 40:      # insertion in query
            p = int(rng.integers(10, len(q) - 10))
            q = q[:p] + _genome(rng, 5) + q[p:]
        qs.append(q)
        ss.append(s)
    return qs, ss


def _oracle_scores(qs, ss):
    sw = SmithWaterman()
    return [sw.align_detailed(q, s)["score"] for q, s in zip(qs, ss)]


def test_banded_scan_matches_gotoh():
    rng = np.random.default_rng(101)
    qs, ss = _cases(rng, 24)
    qmax = max(len(q) for q in qs)
    smax = max(len(s) for s in ss)
    qc = swd.codes_batch(qs, qmax)
    sc = swd.codes_batch(ss, smax)
    score, qe, se = swd.banded_sw_scores(qc, sc, band=128)
    want = _oracle_scores(qs, ss)
    np.testing.assert_allclose(np.asarray(score), want, rtol=0, atol=1e-4)


def test_banded_end_positions():
    # perfect match: ends at (len(q), shift + len(q))
    rng = np.random.default_rng(103)
    s = _genome(rng, 200)
    q = s[30:130]
    qc = swd.codes_batch([q], len(q))
    sc = swd.codes_batch([s], len(s))
    score, qe, se = swd.banded_sw_scores(qc, sc, band=128)
    assert float(score[0]) == 100 * 5.0
    assert int(qe[0]) == 100
    assert int(se[0]) == 130


def test_zero_column_paths_not_lost():
    # regression: a local alignment starting at subject position 0 on a query
    # row > 0 reaches the virtual zero column diagonally; the band-window
    # layout used to mask that column to -inf and lose the path
    rng = np.random.default_rng(104)
    s = _genome(rng, 80)
    q = "TTTTTT" + s[:40]  # best path starts at (q=6, s=0)
    qc = swd.codes_batch([q], len(q))
    sc = swd.codes_batch([s], len(s))
    score, qe, se = swd.banded_sw_scores(qc, sc, band=128)
    assert float(score[0]) == 40 * 5.0


@pytest.mark.parametrize("band,n_cases", [(64, 24), (128, 13), (512, 24),
                                          (512, 7)])
def test_banded_scan_matches_gotoh_ends(band, n_cases):
    # scores AND end positions equal the full-matrix Gotoh's (both break
    # ties by earliest row, then lowest column); odd batches included
    rng = np.random.default_rng(200 + band + n_cases)
    qs, ss = _cases(rng, n_cases)
    qc = swd.codes_batch(qs, max(len(q) for q in qs))
    sc = swd.codes_batch(ss, max(len(s) for s in ss))
    score, qe, se = swd.banded_sw_scores(qc, sc, band=band)
    sw = SmithWaterman()
    want = [sw.align_detailed(q, s) for q, s in zip(qs, ss)]
    np.testing.assert_array_equal(np.asarray(score),
                                  [w["score"] for w in want])
    np.testing.assert_array_equal(np.asarray(qe), [w["qend"] for w in want])
    np.testing.assert_array_equal(np.asarray(se), [w["send"] for w in want])


@pytest.mark.parametrize("q,s,want", [
    # one query motif, two equal-scoring subject copies on the same rows:
    # the lowest band cell (leftmost subject copy) wins
    ("ACGTTGCAAC", "ACGTTGCAAC" + "GGGGG" + "ACGTTGCAAC", (50.0, 10, 10)),
    # two query copies, one subject copy: the earliest row wins
    ("ACGTTGCAAC" + "GGGGG" + "ACGTTGCAAC", "ACGTTGCAAC", (50.0, 10, 10)),
])
def test_banded_scan_tie_breaking(q, s, want):
    qc = swd.codes_batch([q], len(q))
    sc = swd.codes_batch([s], len(s))
    score, qe, se = swd.banded_sw_scores(qc, sc, band=64)
    assert (float(score[0]), int(qe[0]), int(se[0])) == want
