"""Headline benchmark: batched k-mer traversal steps/sec on one chip.

Metric per BASELINE.json: "k-mer traversal steps/sec/chip".  The reference
publishes no throughput numbers and its Java jar cannot run here (no JVM), so
vs_baseline is calibrated against the repo's own single-threaded C++ walker
(native.py walk_forward_host: packed-word keys, open-addressing lookup —
a Java-class or better stand-in for TraversalEngine.java:241-279 /
CortexGraph.java:272-317; a good host core, so the multiple is honest, not
inflated by Python overhead).  The pure-Python transliteration of the Java
loop (string kmers + per-step searchsorted) is ALSO timed and reported as
vs_python for the record.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "vs_python",
"device": {platform, kind, count, card, power_limit}, ...}.  It needs a GPU
whose peak bandwidth is in HBM_PEAK_BYTES_S; anywhere else it raises rather
than report CPU numbers under device names.
"""

import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

# Peak device-memory bandwidth by jax device_kind, for the roofline share of
# the walk's gathers.  Source: NVIDIA H100 data sheet (SXM part, 80 GB HBM3,
# 3.35 TB/s).  A device missing here is an error, not a default.
HBM_PEAK_BYTES_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def device_info() -> dict:
    """The device the numbers are taken on: JAX's view plus nvidia-smi's
    card name and power limit (a card capped below its maximum runs slower
    under load)."""
    import subprocess
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench.py needs a GPU; JAX found {dev.platform}")
    if dev.device_kind not in HBM_PEAK_BYTES_S:
        raise RuntimeError(f"no peak bandwidth known for {dev.device_kind!r}")
    card, power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.splitlines()[0].split(", ")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card, "power_limit": power}


def build_bench_graph(k: int, n_bases: int, seed: int = 7):
    from corticall_tpu import fixtures
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), n_bases))
    # child shares the parents' genome with a sprinkle of private variants
    child = list(genome)
    for pos in rng.integers(k, n_bases - k, size=max(4, n_bases // 250_000)):
        child[pos] = "ACGT"[(ord(child[pos]) + 1) % 4]
    child = "".join(child)
    g = fixtures.build_graph({"kid": [child], "mom": [genome], "dad": [genome]}, k)
    return g, genome


def host_baseline_steps_per_sec(g, seeds, max_steps: int = 64) -> float:
    """Reference-style walk: one vertex at a time, binary-search lookup."""
    from corticall_tpu import kmer as km
    from corticall_tpu import graph as gr

    t0 = time.perf_counter()
    steps = 0
    for seed in seeds:
        sk = seed
        for _ in range(max_steps):
            rec = g.find_record(sk)          # canonicalize + searchsorted
            if rec < 0:
                break
            canon = g.kmer_string(rec)
            flipped = canon != sk
            e = int(g.edges[rec, 0])
            prev_mask, next_mask = gr.edges_to_masks(np.uint8(e), flipped)
            nm = int(next_mask)
            n = bin(nm).count("1")
            if n != 1:
                break
            b = (nm & -nm).bit_length() - 1
            sk = sk[1:] + "ACGT"[b]
            steps += 1
    dt = time.perf_counter() - t0
    return steps / dt if dt > 0 else 0.0


def main():
    import jax
    import jax.numpy as jnp
    from corticall_tpu import kmer as km
    from corticall_tpu.ops import cuckoo as ck

    device = device_info()
    k = int(os.environ.get("BENCH_K", "47"))
    n_bases = int(os.environ.get("BENCH_BASES", "2000000"))
    b = int(os.environ.get("BENCH_WALKS", "262144"))
    t = int(os.environ.get("BENCH_STEPS", "256"))
    # jump-kernel walk cap for the timed batches.  Production Partition runs
    # max_walk=20000 (commands/cli.py); 2000 here keeps one timed call at
    # ~0.5 GB of emitted bases while exercising the same per-iteration code
    # (the kernel's cost is per JUMP_MAX-base iteration either way)
    tj = int(os.environ.get("BENCH_STEPS_JUMP", "2000"))

    g, genome = build_bench_graph(k, n_bases)
    # primary-biased narrow-bucket cuckoo table: the single-step walk kernel
    # reads ONE 8-word bucket row per step and only the ~10% of steps whose
    # key lives in its secondary bucket spend a second speculative iteration
    # (ops/cuckoo.py build_walk_table/walk_forward_spec)
    ct = ck.build_walk_table(g.kmers, g.edges[:, 0])
    buckets = jnp.asarray(ct.buckets)

    rng = np.random.default_rng(11)
    starts = rng.integers(0, len(genome) - k, size=b)
    seed_strs = [genome[i:i + k] for i in starts]
    seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(seed_strs), k))

    # warmup / compile (int() forces the device->host sync)
    bases, cycled, steps = ck.walk_forward_spec(buckets, seeds, k, t)
    int(np.asarray(steps).sum())

    n_iters = 5
    t0 = time.perf_counter()
    total_emitted = 0
    for _ in range(n_iters):
        bases, cycled, steps = ck.walk_forward_spec(buckets, seeds, k, t)
        total_emitted += int(np.asarray(steps).sum())
    dt = time.perf_counter() - t0
    spec_sps = total_emitted / dt
    spec_rows = b * ck.spec_iters(t) * n_iters
    spec_row_bytes = buckets.shape[1] * 4
    spec_gbs = spec_rows * spec_row_bytes / dt / 1e9

    # jump-table kernel (pointer-chased unitig runs): after one seed lookup,
    # each iteration is a single directly-addressed 16 B gather — no hashing,
    # no key compares, no stalls (ops/cuckoo.py JumpTable).  This times the
    # PRODUCTION entry (seed resolution + jump walk + packed-emission
    # layout — everything commands/core's device branches dispatch), with
    # the result left DEVICE-RESIDENT and the timing synced on an 8-byte
    # device-side reduction, which XLA cannot return before the walk
    # completes.  The host-materialized rate is reported below.
    jt_t0 = time.perf_counter()
    jt = ck.build_jump_table(g.kmers, g.edges[:, 0], k)

    @partial(jax.jit, static_argnames=("k", "tj"))
    def _prod_walk(buckets, rows, seeds, k: int, tj: int):
        st, packed = ck._jump_walk(
            rows, ck._jump_seed_rows(buckets, seeds, k), tj)
        # reduce BOTH outputs on device: forces the full walk and the
        # packed-emission layout, returns 8 bytes
        return st[2].sum(), packed.astype(jnp.uint32).sum()

    es, ps = _prod_walk(jt.buckets, jt.rows, seeds, k, tj)
    int(np.asarray(es))                    # build + compile + sync barrier
    jt_build_first_s = time.perf_counter() - jt_t0
    # warm build: the rebuild still uploads keys + placement and runs the
    # full device pointer-doubling, without the one-time compiles
    jt_t0 = time.perf_counter()
    jt = ck.build_jump_table(g.kmers, g.edges[:, 0], k)
    int(np.asarray(jt.rows[0]))
    jt_build_s = time.perf_counter() - jt_t0

    emitted_call = int(np.asarray(es))
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        es, ps = _prod_walk(jt.buckets, jt.rows, seeds, k, tj)
        int(np.asarray(es))
        times.append(time.perf_counter() - t0)
    dt_med = sorted(times)[len(times) // 2]
    dt_min = min(times)
    device_sps = emitted_call / dt_med
    iters_used = ck.jump_iters(tj)
    total_rows = iters_used * b
    run_row_bytes = 16                     # flat rows: 4 uint32 words each
    run_gbs = total_rows * run_row_bytes / dt_med / 1e9
    run_bytes_per_step = total_rows * run_row_bytes / max(emitted_call, 1)

    # the host-materializing wrapper (walk_forward_jumps — what
    # commands/core's host consumers call), INCLUDING pulling the packed
    # bases to the host
    t0 = time.perf_counter()
    o = ck.walk_forward_jumps(jt.buckets, jt.rows, seeds, k, tj)
    mat_dt = time.perf_counter() - t0
    mat_sps = int(o[2].sum()) / mat_dt

    # calibrated baseline: the C++ single-thread walker (table prebuilt,
    # walk-only timing) — a Java-class-or-better host core
    from corticall_tpu import native as nat
    native_sps = None
    if nat.available():
        n_nat = int(os.environ.get("BENCH_NATIVE_SEEDS", "16384"))
        nt = nat.WalkTableNative(g.kmers, g.edges[:, 0], k)
        nat_seeds = np.asarray(km.pack_codes(
            km.strings_to_codes(seed_strs[:n_nat]), k))
        nt.walk(nat_seeds[:64], t)  # warm the code path
        t0 = time.perf_counter()
        _, _, nsteps = nt.walk(nat_seeds, t)
        native_dt = time.perf_counter() - t0
        native_sps = int(nsteps.sum()) / native_dt if native_dt > 0 else None

    # pure-Python transliteration of the Java loop, for the record
    n_base_seeds = int(os.environ.get("BENCH_BASELINE_SEEDS", "64"))
    host_sps = host_baseline_steps_per_sec(g, seed_strs[:n_base_seeds], max_steps=t)

    # banded Smith-Waterman (ops/sw_device.py::banded_sw_scores, the XLA
    # scan the contig aligner's device pre-score runs): GCUPS on a
    # production-shaped batch (band 128, the label_targets/flank-realignment
    # configuration).  Cells = B x Q x band — only band cells are computed.
    from corticall_tpu.ops import sw_device as swd
    bq, qn, band = (int(os.environ.get("BENCH_SW_PAIRS", "8192")),
                    int(os.environ.get("BENCH_SW_QLEN", "1024")),
                    int(os.environ.get("BENCH_SW_BAND", "128")))
    rng2 = np.random.default_rng(13)
    qs = jnp.asarray(rng2.integers(0, 4, (bq, qn)).astype(np.int32))
    ss = jnp.asarray(rng2.integers(0, 4, (bq, qn)).astype(np.int32))
    fn = partial(swd.banded_sw_scores, band=band)
    jax.block_until_ready(fn(qs, ss))           # compile
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(qs, ss))
    dt = (time.perf_counter() - t0) / iters
    sw_gcups = round(bq * qn * band / dt / 1e9, 2)

    print(json.dumps({
        "metric": "kmer_traversal_steps_per_sec_per_chip",
        "value": round(device_sps),
        "unit": "steps/s",
        "vs_baseline": round(device_sps / native_sps, 2) if native_sps
        else (round(device_sps / host_sps, 2) if host_sps else None),
        "vs_python": round(device_sps / host_sps, 2) if host_sps else None,
        "walk_kernel": "jump_table",
        "timing_median_s": round(dt_med, 4),
        "timing_min_s": round(dt_min, 4),
        "timing_spread": round(max(times) / dt_min, 2),
        "sync_bytes": 8,
        "walk_single_step_sps": round(spec_sps),
        "walk_materialized_sps": round(mat_sps),
        "jump_table_build_s": round(jt_build_s, 1),
        "jump_table_build_first_s": round(jt_build_first_s, 1),
        "hbm_bytes_per_step": round(run_bytes_per_step, 1),
        "hbm_gather_gb_s": round(run_gbs, 2),
        "hbm_gather_gb_s_single_step": round(spec_gbs, 2),
        "hbm_utilization_pct": round(
            100 * run_gbs * 1e9 / HBM_PEAK_BYTES_S[device["kind"]], 2),
        "sw_gcups": sw_gcups,
        "sw_kernel": "lax_scan",
        "device": device,
    }))


if __name__ == "__main__":
    main()
