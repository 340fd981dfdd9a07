"""Measure the device graph-build path vs the native host core.

Times, on real read sets:
  - native C++ counting core (build.count_kmers host path)
  - ops/build_device.count_kmers_device (XLA sort + segment reduce)
and the primitive rates that bound ANY device build on the device:
  - XLA lax.sort rows/s at the chunk shape (the current path's bound)
  - XLA scatter-add/scatter-min updates/s (the bound for a hash-accumulate
    build that would sort only uniques)
  - measured h2d transfer rate (the upload floor: ~2 bits/base)

Prints one JSON line with a routing conclusion derived from the numbers.

Env: BD_MBP (default 4), BD_COVERAGE (20), BD_K (47).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from demo_pf_cross import make_cross
    from corticall_tpu import simulate as sim, build as bd
    from corticall_tpu.ops import build_device as bdd

    mbp = float(os.environ.get("BD_MBP", "4"))
    cov = float(os.environ.get("BD_COVERAGE", "20"))
    k = int(os.environ.get("BD_K", "47"))

    rng = np.random.default_rng(42)
    mom, _dad = make_cross(rng, mbp, max(2, int(mbp)), 0.003)
    reads = sim.simulate_reads(list(mom.values()), cov, 150, 0.002, seed=12)
    n_bases = sum(len(r) for r in reads)

    from corticall_tpu import native as nat
    host_kind = "native_cpp" if nat.available() else "numpy"
    t0 = time.perf_counter()
    if nat.available():
        hk, hc, hi, ho = nat.count_kmers_native(reads, k)
    else:
        hk, hc, hi, ho = bd.count_kmers(reads, k)
    host_s = time.perf_counter() - t0

    # device path: first call pays compiles; a second call is the steady
    # state (the pipeline warms compiles asynchronously)
    t0 = time.perf_counter()
    dk, dc, di, do = bdd.count_kmers_device(reads, k)
    dev_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dk, dc, di, do = bdd.count_kmers_device(reads, k)
    dev_s = time.perf_counter() - t0
    identical = (np.array_equal(hk, dk) and np.array_equal(hc, dc)
                 and np.array_equal(hi, di) and np.array_equal(ho, do))

    # primitive rates
    N = 1 << 24
    T = 1 << 22
    r2 = np.random.default_rng(0)
    idx = jnp.asarray(r2.integers(0, T, N).astype(np.int32))
    vals = jnp.asarray(r2.integers(0, 255, N).astype(np.uint32))

    def rate(f):
        int(np.asarray(f(idx, vals)))
        t0 = time.perf_counter()
        for _ in range(3):
            int(np.asarray(f(idx, vals)))
        return N / ((time.perf_counter() - t0) / 3)

    scat = rate(jax.jit(
        lambda i, v: jnp.zeros(T, jnp.uint32).at[i].add(v).sum()))
    gath = rate(jax.jit(
        lambda i, v: (jnp.arange(T, dtype=jnp.uint32)[i] ^ v).sum()))

    @jax.jit
    def dosort(i, v):
        # three DISTINCT random key operands + one payload (the count
        # path's shape); identical keys would make the sort trivial
        k1 = v * jnp.uint32(2654435761)
        k2 = v ^ (v >> 13)
        out = jax.lax.sort([v, k1, k2, i.astype(jnp.uint32)], num_keys=3)
        return out[0].sum()
    sortr = rate(dosort)

    # h2d rate on a 32 MB payload
    pay = np.zeros(8 << 20, np.uint32)
    t0 = time.perf_counter()
    d = jnp.asarray(pay)
    int(np.asarray(d[0]))
    h2d = pay.nbytes / (time.perf_counter() - t0) / 1e6

    dev_rate = n_bases / dev_s
    host_rate = n_bases / host_s
    print(json.dumps({
        "metric": "graph_build_device_vs_native",
        "genome_mbp": mbp, "coverage": cov, "k": k,
        "read_bases": n_bases, "unique_kmers": int(len(hk)),
        "bit_identical": bool(identical),
        "host_kind": host_kind,
        "native_s": round(host_s, 2),
        "device_s": round(dev_s, 2),
        "device_first_s": round(dev_first_s, 2),
        "native_mbases_s": round(host_rate / 1e6, 2),
        "device_mbases_s": round(dev_rate / 1e6, 2),
        "speedup_device": round(host_s / dev_s, 2),
        "xla_sort_rows_s": round(sortr),
        "xla_scatter_add_s": round(scat),
        "xla_gather_s": round(gath),
        "h2d_mb_s": round(h2d, 1),
        "conclusion": (
            "device build is the measured-faster default" if dev_s < host_s
            else "host-native build remains the default: XLA sort "
                 f"({sortr/1e6:.0f}M rows/s) bounds the current device path "
                 f"and scatter-add ({scat/1e6:.0f}M updates/s) bounds a "
                 "hash-accumulate redesign to roughly native speed BEFORE "
                 "the read upload (2 bits/base at the measured "
                 f"{h2d:.1f} MB/s h2d)"),
    }))


if __name__ == "__main__":
    main()
