"""Smoke run of the DNM pipeline on one GPU, at the sizes users run.

    python chip_smoke.py

One process, one card.  It exits non-zero, and prints no result, when JAX
finds no GPU (there is no CPU fallback) or when this file is run without the
rest of the repository.  Phases:

  A  device: backend, card name and power limit, compile-cache location.
  B  flagship-size state on the card: the joined k=47, 3-colour graph of the
     21 Mbp, 14-chromosome simulated P. falciparum cross of demo_pf_cross.py
     (built from haplotypes), its jump table built on the device, 1M seed
     lookups checked against CortexGraph.find_record on a 16k sample, and
     262,144 jump walks (max_walk 2000) whose decoded extensions on a
     4,096-lane sample must equal the native C++ walker's bit for bit.
  C  the pipeline through pipeline.run_pipeline (reads mode of
     demo_pf_cross.py: k=47, 20x reads at 0.2% error, read and reference
     links, all prefilters, Partition, Call, FilterCalls) on one 2 Mbp
     chromosome with the device routes forced, then Partition and Call
     again on the host routes from the same stage files: partitions must be
     byte-identical and the VCFs identical, except for records that a
     rerun with only Tesserae on the device reproduces (boundary shifts of
     the float32 DP), which are printed.
  D  kernels at real widths against their references: device Tesserae vs
     the host oracle on 32 recombinant two-template sections of 1-16 kb
     (same segments, each boundary within 1 base or inside a tied overlap,
     llk within 1e-4 relative: float32 on the device, float64 on the host),
     and the banded-SW scan vs host Gotoh at
     the contig aligner's shape on 64 pairs (scores and end positions
     exactly equal), plus the scan's timings at the aligner shape and at
     8192 pairs x 1024 bases, band 128.

Every phase raises on failure.  The last line of standard output is one
JSON object naming the device; nothing is printed there unless every phase
passed.  Set JAX_PLATFORMS=cuda so that a broken CUDA plugin raises instead
of leaving JAX on the CPU.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 47
MAX_WALK = 2000


def log(*a):
    print(*a, flush=True)


def _timed(fn, reps: int = 3):
    """(first-call seconds including compile, median steady seconds)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts))


def _genome_kmers(seqs, n: int, rng) -> np.ndarray:
    """n random k-mers (uint8[n, K] codes) drawn from the given sequences."""
    from corticall_tpu import kmer as km
    codes = [km.string_to_codes_permissive(s) for s in seqs]
    which = rng.integers(0, len(codes), n)
    out = np.empty((n, K), dtype=np.uint8)
    for ci, c in enumerate(codes):
        sel = np.flatnonzero(which == ci)
        starts = rng.integers(0, len(c) - K, len(sel))
        out[sel] = c[starts[:, None] + np.arange(K)[None, :]]
    return out


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
def phase_a() -> dict:
    import jax
    dev = jax.devices()[0]
    log(f"[A] card: {_card()}")
    log(f"[A] jax: platform={dev.platform} device_kind={dev.device_kind} "
        f"count={len(jax.devices())} version={jax.__version__}")
    log(f"[A] compile cache: {jax.config.jax_compilation_cache_dir}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def build_cross_graph(mbp: float, n_chroms: int, seed: int = 42):
    """The demo's seeded cross (make_cross + simulate_haploid_child) and
    its joined k=47 kid/mom/dad graph, built from haplotypes."""
    from demo_pf_cross import make_cross
    from corticall_tpu import build, simulate as sim
    from corticall_tpu.commands import core
    rng = np.random.default_rng(seed)
    mom, dad = make_cross(rng, mbp, n_chroms, 0.003)
    res = sim.simulate_haploid_child(mom, dad, parents=("mom", "dad"),
                                     mu=2.0, num_variants=40, k=K, seed=7)
    gs = [build.build_graph_from_reads(list(seqs.values()), K, name)
          for name, seqs in (("kid", res["child"]), ("mom", mom),
                             ("dad", dad))]
    return core.join(gs), res["child"]


def phase_b(mbp: float = 21.0, n_chroms: int = 14, n_lookups: int = 1 << 20,
            n_check: int = 16384, n_walks: int = 262144,
            n_walk_check: int = 4096, gather_ab=None) -> None:
    import jax
    import jax.numpy as jnp
    from corticall_tpu import kmer as km, native as nat
    from corticall_tpu.ops import cuckoo as ck, walk_np as wnp

    t0 = time.perf_counter()
    g, child = build_cross_graph(mbp, n_chroms)
    log(f"[B] graph: {mbp} Mbp x {n_chroms} chromosomes, k={K}, "
        f"{g.num_colors} colours, {g.num_records} records, host build "
        f"{time.perf_counter() - t0:.1f} s")

    edges = g.edges[:, 0]
    t0 = time.perf_counter()
    jt = ck.build_jump_table(g.kmers, edges, K)
    jax.block_until_ready((jt.rows, jt.buckets))
    log(f"[B] jump table built on device in {time.perf_counter() - t0:.1f} s "
        f"(rows {jt.rows.nbytes / 2**30:.2f} GiB, buckets "
        f"{jt.buckets.nbytes / 2**30:.2f} GiB)")

    # 1M lookups: 3/4 k-mers of the child genome, 1/4 random (mostly absent)
    rng = np.random.default_rng(5)
    n_rand = n_lookups // 4
    codes = np.concatenate([
        _genome_kmers(list(child.values()), n_lookups - n_rand, rng),
        rng.integers(0, 4, (n_rand, K), dtype=np.uint8)])
    seeds = jnp.asarray(km.pack_codes(codes, K))
    first, steady = _timed(lambda: ck._jump_seed_rows(jt.buckets, seeds, K))
    rows = np.asarray(ck._jump_seed_rows(jt.buckets, seeds, K))
    sample = rng.choice(n_lookups, n_check, replace=False)
    want = np.array([g.find_record(codes[i]) for i in sample])
    got = np.where(rows[sample] >= 0, rows[sample] >> 1, -1)
    if not np.array_equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"[B] {bad}/{n_check} lookups differ from "
                             "CortexGraph.find_record")
    log(f"[B] {n_lookups} lookups: first call {first:.2f} s, steady "
        f"{steady * 1e3:.1f} ms; {n_check} sampled match find_record "
        f"({int((want >= 0).sum())} hits, {int((want < 0).sum())} misses)")

    # 262,144 jump walks from random records of the kid colour
    wrng = np.random.default_rng(11)
    recs = wrng.choice(g.num_records, n_walks, replace=False)
    walk_seeds = jnp.asarray(g.kmers[recs])
    seed_rows = ck._jump_seed_rows(jt.buckets, walk_seeds, K)
    first, steady = _timed(
        lambda: ck._jump_walk(jt.rows, seed_rows, MAX_WALK))
    state, _ = ck._jump_walk(jt.rows, seed_rows, MAX_WALK)
    steps = int(np.asarray(state[2]).sum())
    log(f"[B] {n_walks} jump walks, max_walk {MAX_WALK}: first call "
        f"{first:.2f} s (compile included), steady {steady:.4f} s, "
        f"{steps} steps, {steps / steady:.4g} steps/s device-resident")
    if gather_ab is not None:
        gather_ab(jt, seed_rows)

    packed, cyc, wsteps, sat, _, _ = ck.walk_forward_jumps(
        jt.buckets, jt.rows, walk_seeds, K, MAX_WALK)
    t0 = time.perf_counter()
    nt = nat.WalkTableNative(g.kmers, edges, K)
    check = np.arange(n_walk_check)
    nb, ncy, nst = nt.walk(g.kmers[recs[check]], MAX_WALK)
    native_s = time.perf_counter() - t0
    for i in check:
        s = g.kmer_string(int(recs[i]))
        dev_ext = wnp.replay_jump_walk(s, packed[i], int(wsteps[i]), MAX_WALK)
        nat_ext = wnp.replay_walk(s, nb[:int(nst[i]), i], bool(ncy[i]),
                                  MAX_WALK)
        if dev_ext != nat_ext:
            raise AssertionError(f"[B] walk {i} (record {recs[i]}) differs "
                                 "from the native walker")
    log(f"[B] {n_walk_check} sampled walk extensions bit-identical to "
        f"native.WalkTableNative (native table + walks {native_s:.1f} s; "
        f"{int(cyc.sum())} cycled, {int(sat.sum())} saturated lanes of "
        f"{n_walks})")
    st = jax.devices()[0].memory_stats() or {}
    log(f"[B] device memory: in use {st.get('bytes_in_use', 0) / 2**30:.2f} "
        f"GiB, peak {st.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB, "
        f"limit {st.get('bytes_limit', 0) / 2**30:.2f} GiB")


# ---------------------------------------------------------------------------
_RERUN = ("partition", "trim", "call", "filter_calls")
_OUTPUTS = ("partitions.fa", "partitions.trimmed.fa", "calls.vcf",
            "accounting.txt", "calls.filtered.vcf", "partition.ckpt.npz")


def _rerun_copy(src: str, dst: str, stages=_RERUN) -> None:
    """dst = src's stage files with `stages` (and their outputs) dropped,
    so run_pipeline recomputes exactly those stages."""
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "state.json")) as f:
        state = json.load(f)
    for name in stages:
        state["stages"].pop(name, None)
    with open(os.path.join(dst, "state.json"), "w") as f:
        json.dump(state, f)
    outputs = _OUTPUTS if "partition" in stages else _OUTPUTS[2:5]
    for name in outputs:
        p = os.path.join(dst, name)
        if os.path.exists(p):
            os.unlink(p)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _vcf_records(workdir: str, name: str) -> list:
    return [x for x in _read(os.path.join(workdir, name)).decode()
            .splitlines() if not x.startswith("#")]


def phase_c(mbp: float = 2.0, n_dnms: int = 20, coverage: float = 20.0,
            workroot: str | None = None) -> None:
    from demo_pf_cross import make_cross, evaluate
    from corticall_tpu import pipeline as pl, simulate as sim
    from corticall_tpu.commands import core
    from corticall_tpu.models import contig_aligner as ca
    from corticall_tpu.models.reference_index import IndexedReference

    log(f"[C] reads-mode pipeline on one {mbp} Mbp chromosome (the flagship "
        "is 21 Mbp x 14; cut to one chromosome for the smoke's time), with "
        "8 paralog families of 8 x 1 kb copies so that contigs have several "
        "candidate loci for the banded-SW pre-score")
    t0 = time.perf_counter()
    rng = np.random.default_rng(42)
    # kb-scale dispersed paralogs (the rif/stevor gene-family scale): with
    # the demo's 75 bp repeat units every target places uniquely and the
    # pre-score has nothing to rank
    mom, dad = make_cross(rng, mbp, 1, 0.003, repeat_copies=8,
                          repeat_len=1000)
    res = sim.simulate_haploid_child(mom, dad, parents=("mom", "dad"),
                                     mu=2.0, num_variants=n_dnms, k=K, seed=7)
    reads = {
        "kid": sim.simulate_reads(list(res["child"].values()), coverage,
                                  150, 0.002, seed=11),
        "mom": sim.simulate_reads(list(mom.values()), coverage, 150, 0.002,
                                  seed=12),
        "dad": sim.simulate_reads(list(dad.values()), coverage, 150, 0.002,
                                  seed=13),
    }
    refs = {"mom": IndexedReference(mom), "dad": IndexedReference(dad)}
    log(f"[C] simulate cross + reads: {time.perf_counter() - t0:.1f} s")

    def run(workdir, tesserae, partition, prescore):
        """One run_pipeline with each device route on or off."""
        core._NATIVE_LINK_THRESHOLD = -1 if partition == "device" else saved[0]
        ca.MIN_DEVICE_BATCH = 1 if prescore == "device" else 1 << 62
        t0 = time.perf_counter()
        out = pl.run_pipeline(
            workdir, reads, child="kid", parents=["mom", "dad"],
            references=refs, k=K, min_coverage=2, max_walk=MAX_WALK,
            caller_opts={"tesserae": tesserae})
        return out, time.perf_counter() - t0

    saved = core._NATIVE_LINK_THRESHOLD, ca.MIN_DEVICE_BATCH
    with tempfile.TemporaryDirectory(
            prefix=".chip_smoke_", dir=workroot or os.path.dirname(
                os.path.abspath(__file__))) as root:
        dev_dir = os.path.join(root, "device")
        host_dir = os.path.join(root, "host")
        try:
            # device routes: jump-table Partition, device Tesserae, and the
            # banded-SW pre-score for every multi-candidate batch; then the
            # host routes (native linked walker, host Tesserae, no
            # pre-score) from the same stage files
            dev, dev_s = run(dev_dir, "device", "device", "device")
            _rerun_copy(dev_dir, host_dir)
            host, host_s = run(host_dir, "host", "host", "host")
        finally:
            core._NATIVE_LINK_THRESHOLD, ca.MIN_DEVICE_BATCH = saved

        stats, hstats = dev["stats"], host["stats"]
        log(f"[C] device-route pipeline {dev_s:.1f} s; stage seconds: "
            + json.dumps(dev["stages"]))
        log(f"[C] host-route rerun (partition, trim, call, filter_calls) "
            f"{host_s:.1f} s; stage seconds: "
            + json.dumps({s: host["stages"][s] for s in _RERUN}))
        part = stats["partition"]
        call = stats["call"]
        log(f"[C] partition: walk_kernel={part.get('walk_kernel')} "
            f"(host route: {hstats['partition'].get('walk_kernel')}), "
            f"{part.get('partitions')} partitions, device steps "
            f"{part.get('device_steps')}, link replays "
            f"{part.get('link_replays')}")
        log(f"[C] call: SW windows scored on device "
            f"{call['contig_aligner'].get('device_scored_windows', 0)}, "
            f"Tesserae sections device/host "
            f"{call['tesserae']['device_sections']}/"
            f"{call['tesserae']['host_sections']} "
            f"(host route: {hstats['call']['tesserae']})")
        log(f"[C] call breakdown (device routes): "
            + json.dumps(call.get("call_breakdown", {})))
        ev = evaluate(dev["variants"], res["truth_vcf"], mom, dad, K,
                      recombs=res.get("recombs"))
        log(f"[C] recall vs simulated truth: strict "
            f"{ev['strict_recovered']}/{len(res['truth_vcf'])}, kmer-Venn "
            f"{json.dumps(ev['kmer_venn'])}; calls {len(dev['variants'])}, "
            f"after FilterCalls {len(dev['filtered_variants'])}")

        if part.get("walk_kernel") != "jump_table":
            raise AssertionError("[C] Partition did not take the device route")
        if call["tesserae"]["device_sections"] == 0:
            raise AssertionError("[C] no Tesserae section ran on the device")
        if not call["contig_aligner"].get("device_scored_windows"):
            raise AssertionError("[C] no SW window was scored on the device")
        for name in ("partitions.fa", "partitions.trimmed.fa"):
            if _read(os.path.join(dev_dir, name)) != _read(
                    os.path.join(host_dir, name)):
                raise AssertionError(f"[C] {name} differs between device "
                                     "and host routes")
        log("[C] partitions byte-identical between device and host routes")

        differ = [name for name in ("calls.vcf", "calls.filtered.vcf")
                  if _vcf_records(dev_dir, name)
                  != _vcf_records(host_dir, name)]
        if differ:
            # Attribute the difference: rerun Call from the host stage
            # files with only Tesserae on the device.  If that reproduces
            # the device-route VCFs exactly, the Partition and SW routes
            # change nothing and every differing record is a Tesserae
            # boundary shift (float32 on the device, float64 on the host).
            mixed_dir = os.path.join(root, "tesserae_only")
            _rerun_copy(host_dir, mixed_dir, ("call", "filter_calls"))
            try:
                run(mixed_dir, "device", "host", "host")
            finally:
                core._NATIVE_LINK_THRESHOLD, ca.MIN_DEVICE_BATCH = saved
            for name in differ:
                a = _vcf_records(dev_dir, name)
                b = _vcf_records(host_dir, name)
                only_dev = [x for x in a if x not in b]
                only_host = [x for x in b if x not in a]
                log(f"[C] {name}: {len(only_dev)} of {len(a)} device-route "
                    "records differ from the host route's; device-only, "
                    "then host-only (POS REF ALT):")
                for x in only_dev + only_host:
                    f = x.split("\t")
                    log(f"      {f[1]} {f[3]} {f[4]}")
                if _vcf_records(mixed_dir, name) != a:
                    raise AssertionError(
                        f"[C] {name} differs between device and host routes "
                        "beyond Tesserae: host partitions + host SW + device "
                        "Tesserae do not reproduce the device-route VCF")
            log(f"[C] {', '.join(differ)}: every difference is a Tesserae "
                "boundary shift (host partitions + host SW + device "
                "Tesserae reproduce the device-route VCFs exactly)")
        for name in ("calls.vcf", "calls.filtered.vcf"):
            if name not in differ:
                log(f"[C] {name} identical between device and host routes "
                    f"({len(_vcf_records(dev_dir, name))} records)")


# ---------------------------------------------------------------------------
def _random_genome(rng, n: int) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes(
    ).decode()


def _tied(query: str, targets: dict, a: int, b: int) -> bool:
    """Whether a segment boundary may sit at query position a or b with
    the same likelihood: they differ by at most one base (the tolerance of
    tests/test_tesserae_device.py), or every query base between them
    matches every template, so the switch point is a tie that float32 (the
    device) and float64 (the host) rounding may break differently.  The
    sections here are gap-free, so template and query positions agree."""
    lo, hi = min(a, b), max(a, b)
    return hi - lo <= 1 or all(
        query[p] == t[p] for t in targets.values() for p in range(lo, hi))


def phase_d_tesserae(lengths=None) -> None:
    from corticall_tpu.models.tesserae import Tesserae
    from corticall_tpu.ops.tesserae_jax import TesseraeDevice

    if lengths is None:
        # 30 sections over 1-4 kb (the device's DP buckets) and two longer
        # ones that the device's HBM budget routes to the host oracle
        lengths = [int(x) for x in np.geomspace(1000, 4096, 30)] + [
            8000, 16000]
    rng = np.random.default_rng(17)
    ma = TesseraeDevice()
    n_dev = n_host = 0
    dev_s = host_s = 0.0
    worst_llk = 0.0
    shifted = worst_shift = 0
    for i, n in enumerate(lengths):
        t0, t1 = _random_genome(rng, n), _random_genome(rng, n)
        a, b = sorted(rng.integers(n // 8, n - n // 8, 2))
        query = t0[:a] + t1[a:b] + t0[b:]
        targets = {"t0": t0, "t1": t1}
        before = ma.host_sections
        t = time.perf_counter()
        dev = ma.align(query, targets)
        dt = time.perf_counter() - t
        if ma.host_sections > before:
            # the DP ran in the host oracle itself: nothing to compare
            n_host += 1
            continue
        n_dev += 1
        dev_s += dt
        host_ma = Tesserae(ma.del_, ma.eps, ma.rho, ma.term)
        t = time.perf_counter()
        host = host_ma.align(query, targets)
        host_s += time.perf_counter() - t
        if dev[0][1].replace("-", "") != host[0][1].replace("-", ""):
            raise AssertionError(f"[D] Tesserae section {i}: query differs")
        if len(dev) != len(host):
            raise AssertionError(f"[D] Tesserae section {i} ({n} bp): "
                                 f"{len(dev)} vs {len(host)} segments")
        for (dn, _, (da, db)), (hn, _, (ha, hb)) in zip(dev[1:], host[1:]):
            if dn != hn or not (_tied(query, targets, da, ha)
                                and _tied(query, targets, db + 1, hb + 1)):
                raise AssertionError(
                    f"[D] Tesserae section {i} ({n} bp): segment {dn} "
                    f"{(da, db)} vs host {hn} {(ha, hb)}")
            if max(abs(da - ha), abs(db - hb)):
                shifted += 1
                worst_shift = max(worst_shift, abs(da - ha), abs(db - hb))
        rel = abs(ma.llk - host_ma.llk) / abs(host_ma.llk)
        worst_llk = max(worst_llk, rel)
        if rel >= 1e-4:
            raise AssertionError(f"[D] Tesserae section {i}: llk relative "
                                 f"difference {rel:.3g}")
    log(f"[D] Tesserae: {n_dev} sections on the device match the host "
        f"oracle (same segments; {shifted} boundaries shifted, by at most "
        f"{worst_shift} bases, each within a tied overlap; worst llk "
        f"relative difference {worst_llk:.3g}); {n_host} routed to the host "
        f"by the HBM budget; "
        f"device {dev_s:.1f} s (compile {ma.compile_s:.1f} s) vs host "
        f"{host_s:.1f} s on the same sections")


def phase_d_sw(n_pairs: int = 64, shape=None) -> None:
    import jax.numpy as jnp
    from corticall_tpu.models import contig_aligner as ca
    from corticall_tpu.models.sw import SmithWaterman
    from corticall_tpu.ops import sw_device as swd

    qmax, smax, band = shape or (ca.DEV_Q, ca.DEV_S, ca.DEV_BAND)
    rng = np.random.default_rng(23)
    ref = _random_genome(rng, 400_000)
    qs, ws = [], []
    for _ in range(n_pairs):
        n = int(rng.integers(qmax // 8, qmax + 1))
        lo = int(rng.integers(band, len(ref) - n - band))
        f0, f1 = (int(x) for x in rng.integers(0, band // 3, 2))
        w = ref[lo - f0:lo + n + f1][:smax]
        q = list(ref[lo:lo + n])
        for p in rng.integers(0, n, n // 100):          # ~1% substitutions
            q[p] = "ACGT"[("ACGT".index(q[p]) + 1) % 4]
        q = "".join(q)
        p = int(rng.integers(n // 4, n // 2))           # one small indel each
        q = q[:p] + q[p + 3:] if rng.random() < 0.5 else q[:p] + "TTA" + q[p:]
        qs.append(q[:qmax])
        ws.append(w)
    qc = jnp.asarray(swd.codes_batch(qs, qmax))
    sc = jnp.asarray(swd.codes_batch(ws, smax))
    score, qe, se = (np.asarray(x) for x in
                     swd.banded_sw_scores(qc, sc, band=band))
    sw = SmithWaterman()
    t0 = time.perf_counter()
    want = [sw.align_detailed(q, w) for q, w in zip(qs, ws)]
    host_s = time.perf_counter() - t0
    for i, wnt in enumerate(want):
        got = (float(score[i]), int(qe[i]), int(se[i]))
        ref_t = (wnt["score"], wnt["qend"], wnt["send"])
        if got != ref_t:
            raise AssertionError(f"[D] SW pair {i}: scan {got} vs Gotoh "
                                 f"{ref_t}")
    log(f"[D] banded SW scan at ({qmax}, {smax}, band {band}): {n_pairs} "
        f"pairs match host Gotoh exactly (score, query end, subject end); "
        f"host Gotoh {host_s:.1f} s")


def phase_d_sw_timings(shapes=None) -> None:
    import jax.numpy as jnp
    from corticall_tpu.models import contig_aligner as ca
    from corticall_tpu.ops import sw_device as swd

    shapes = shapes or [(64, ca.DEV_Q, ca.DEV_S, ca.DEV_BAND),
                        (512, ca.DEV_Q, ca.DEV_S, ca.DEV_BAND),
                        (8192, 1024, 1024, 128)]
    rng = np.random.default_rng(13)
    for b, qn, sn, band in shapes:
        q = jnp.asarray(rng.integers(0, 4, (b, qn)).astype(np.int32))
        s = jnp.asarray(rng.integers(0, 4, (b, sn)).astype(np.int32))
        first, steady = _timed(
            lambda: swd.banded_sw_scores(q, s, band=band))
        log(f"[D] banded_sw_scores B={b} Q={qn} S={sn} band={band}: first "
            f"call {first:.2f} s, steady {steady * 1e3:.1f} ms, "
            f"{b * qn * band / steady / 1e9:.2f} GCUPS (band cells)")


# ---------------------------------------------------------------------------
def main() -> int:
    t_start = time.perf_counter()
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX backend is {backend!r}, not 'gpu'; this "
              "smoke run needs a GPU and has no CPU fallback",
              file=sys.stderr)
        return 2
    try:
        import corticall_tpu  # noqa: F401
        import demo_pf_cross  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    device = phase_a()
    t = time.perf_counter()
    phase_b()
    log(f"[B] phase seconds: {time.perf_counter() - t:.1f}")
    t = time.perf_counter()
    phase_c()
    log(f"[C] phase seconds: {time.perf_counter() - t:.1f}")
    t = time.perf_counter()
    phase_d_tesserae()
    phase_d_sw()
    phase_d_sw_timings()
    log(f"[D] phase seconds: {time.perf_counter() - t:.1f}")
    log(f"total wall seconds: {time.perf_counter() - t_start:.1f}")
    log(_card())
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
