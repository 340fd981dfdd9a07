"""The one device-selection rule (device.gpu_available) and the routes it
drives: a GPU backend selects device Tesserae and the device banded-SW
pre-score, the CPU keeps the host oracles, and a chosen device route that
fails raises instead of falling back."""

import jax
import numpy as np
import pytest

from corticall_tpu import device, kmer as km
from corticall_tpu.caller.call import Caller
from corticall_tpu.models import contig_aligner as ca
from corticall_tpu.models.reference_index import IndexedReference
from corticall_tpu.models.tesserae import Tesserae
from corticall_tpu.ops import sw_device as swd
from corticall_tpu.ops import tesserae_jax
from corticall_tpu.ops.tesserae_jax import TesseraeDevice


@pytest.fixture
def backend(monkeypatch, request):
    """Fake JAX's default backend; computation still runs on the CPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: request.param)
    return request.param


@pytest.fixture
def small_device_shape(monkeypatch):
    # the aligner's single device shape, cut so the scan runs quickly here
    monkeypatch.setattr(ca, "DEV_Q", 1024)
    monkeypatch.setattr(ca, "DEV_S", 1024)
    monkeypatch.setattr(ca, "DEV_BAND", 128)


def _repeat_reference():
    """A reference with a duplicated 1.5 kb segment (one copy carrying a
    few SNPs) and queries from it: every query has two candidate windows,
    so 8 queries make a 16-window device batch."""
    rng = np.random.default_rng(41)
    seg = "".join(rng.choice(list("ACGT"), 1500))
    seg2 = list(seg)
    for p in rng.integers(0, 1500, 12):
        seg2[p] = "ACGT"[("ACGT".index(seg2[p]) + 1) % 4]
    flank = ["".join(rng.choice(list("ACGT"), 3000)) for _ in range(3)]
    ref = flank[0] + seg + flank[1] + "".join(seg2) + flank[2]
    queries = {}
    for i, a in enumerate(range(50, 1500 - 650, 100)):
        q = seg[a:a + 600]
        queries[f"q{i}"] = km.revcomp(q) if i % 2 else q
    return queries, {"mom": IndexedReference({"chr1": ref})}


def _placements(out):
    return {qn: [(a.reference, a.contig, a.start, a.end, a.negative, a.cigar,
                  a.nm, a.mapq) for a in als] for qn, als in out.items()}


@pytest.mark.parametrize("backend,want", [("gpu", True), ("cpu", False)],
                         indirect=["backend"])
def test_gpu_available_follows_backend(backend, want):
    assert device.gpu_available() is want


@pytest.mark.parametrize("backend,want", [("gpu", TesseraeDevice),
                                          ("cpu", Tesserae)],
                         indirect=["backend"])
def test_auto_tesserae_route(backend, want):
    ma = Caller._make_tesserae("auto", 0.35, 0.90, 6e-4, 1e-3)
    assert type(ma) is want


@pytest.mark.parametrize("backend,device_windows", [("gpu", True),
                                                    ("cpu", False)],
                         indirect=["backend"])
def test_auto_sw_prescore_route(backend, device_windows, small_device_shape):
    queries, refs = _repeat_reference()
    stats: dict = {}
    ca.align_contigs(queries, refs, band=64, stats=stats)
    assert (stats["device_scored_windows"] > 0) is device_windows


@pytest.mark.parametrize("backend", ["gpu"], indirect=True)
def test_device_sw_failure_raises(backend, small_device_shape, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("device kernel failed")
    monkeypatch.setattr(swd, "banded_sw_scores", broken)
    queries, refs = _repeat_reference()
    with pytest.raises(RuntimeError, match="device kernel failed"):
        ca.align_contigs(queries, refs, band=64)


@pytest.mark.parametrize("backend", ["gpu"], indirect=True)
def test_device_tesserae_failure_raises(backend, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("device kernel failed")
    monkeypatch.setattr(tesserae_jax, "_tesserae_full", broken)
    ma = Caller._make_tesserae("auto", 0.35, 0.90, 6e-4, 1e-3)
    with pytest.raises(RuntimeError, match="device kernel failed"):
        ma.align("GTAGGCGAGATGACGCCAT", {"t0": "GTAGGCGAGTCCCGTTTATA",
                                        "t1": "CCACAGAAGATGACGCCATT"})


@pytest.mark.parametrize("with_long", [False, True])
def test_align_contigs_device_prescore_matches_host(small_device_shape,
                                                    with_long):
    """use_device=True runs the scan pre-score here on the CPU and must
    place every contig exactly as the host-only path does.  A query longer
    than the device shape keeps all its candidates, unscored, without
    taking the rest of the batch off the device."""
    queries, refs = _repeat_reference()
    if with_long:
        queries["long"] = queries["q0"] + queries["q2"][:500]
    stats: dict = {}
    dev = ca.align_contigs(queries, refs, band=64, use_device=True,
                           stats=stats)
    host = ca.align_contigs(queries, refs, band=64, use_device=False)
    assert stats["device_scored_windows"] == 16
    assert _placements(dev) == _placements(host)
    assert all(dev.values())


@pytest.mark.parametrize("n,want", [(1, 1), (8, 8), (9, 16), (16, 16)])
def test_prescore_batch_pads_to_power_of_two(n, want):
    assert ca._pow2(n) == want


@pytest.mark.gpu
def test_gpu_routes_on_card(gpu_device):
    """On a real GPU, "auto" takes both device routes at the aligner's own
    shape and places every contig as the host-only path does."""
    assert device.gpu_available()
    ma = Caller._make_tesserae("auto", 0.35, 0.90, 6e-4, 1e-3)
    assert type(ma) is TesseraeDevice
    queries, refs = _repeat_reference()
    stats: dict = {}
    dev = ca.align_contigs(queries, refs, band=64, stats=stats)
    host = ca.align_contigs(queries, refs, band=64, use_device=False)
    assert stats["device_scored_windows"] == 16
    assert _placements(dev) == _placements(host)
