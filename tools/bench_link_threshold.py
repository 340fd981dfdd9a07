"""Measure the native-C++ linked walker vs the device jump+filter path
across seed batch sizes.

_NATIVE_LINK_THRESHOLD (commands/core.py) routes linked Partition to the
C++ exact walker below a seed count and to the device jump-table path
(link-free jump walks + exact linked replay of link-touching walks) above
it.  This tool times both strategies on a Pf-scale graph + real threaded
links at several seed counts and prints one JSON line per point so the
crossover is chosen from data.

Both timings EXCLUDE the one-time jump-table build/compile (reported
separately): in the production pipeline the table build amortizes across
the whole Partition stage and, on rigs with a working compile cache,
across runs.

Usage:
  PF_WORKDIR=/tmp/pf2_work python tools/bench_link_threshold.py
The workdir must contain joined.ctx and kid.ctp.bgz (a completed
reads-mode demo run).  Runs on whatever backend jax selects.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from corticall_tpu import graph as gr, kmer as km, native as nat
    from corticall_tpu.io import ctx as ctxio, links as lkio
    from corticall_tpu.ops import cuckoo as cko
    from corticall_tpu.ops import walk_np as wnp
    import jax
    import jax.numpy as jnp

    wd = os.environ.get("PF_WORKDIR", "/tmp/pf2_work")
    sizes = [int(s) for s in os.environ.get(
        "LINKBENCH_SIZES", "1024,4096,16384,65536").split(",")]
    num_steps = int(os.environ.get("LINKBENCH_STEPS", "2000"))

    g = gr.CortexGraph(ctxio.read_ctx(os.path.join(wd, "joined.ctx")))
    links = [lkio.open_links(os.path.join(wd, "kid.ctp.bgz"))]
    child = g.color_for_sample("kid")
    k = g.kmer_size
    rng = np.random.default_rng(3)

    # seeds: child-covered kmers (uniform sample; same walk work per seed
    # class as Partition's ROI seeds)
    cov = g.coverages[:, child] > 0
    idx_all = np.nonzero(cov)[0]
    picks = rng.choice(idx_all, size=max(sizes), replace=False)
    all_seeds = [g.kmer_string(int(i)) for i in picks]
    all_rc = [km.revcomp(s) for s in all_seeds]

    t0 = time.perf_counter()
    native = nat.LinksWalkerNative(g, [child], links)
    native_build = time.perf_counter() - t0

    from corticall_tpu.commands.core import link_kmer_flags
    t0 = time.perf_counter()
    jt = cko.build_jump_table(g.kmers, g.edges[:, child], k,
                              flags=link_kmer_flags(g, links))
    jax.block_until_ready(jt.rows)
    jump_build = time.perf_counter() - t0

    def device_assemble(seeds, rcs):
        f_seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(seeds), k))
        r_seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(rcs), k))
        fpk, fcy, fst, fsat, ftch, fej = cko.walk_forward_jumps(
            jt.buckets, jt.rows, f_seeds, k, num_steps)
        rpk, rcy, rst, rsat, rtch, rej = cko.walk_forward_jumps(
            jt.buckets, jt.rows, r_seeds, k, num_steps)
        fwds = wnp.jump_extensions_batch(seeds, fpk, fst, fcy, fsat,
                                         num_steps)
        backs = wnp.jump_extensions_batch(rcs, rpk, rst, rcy, rsat,
                                          num_steps)
        relink = [i for i in range(len(seeds))
                  if (ftch[i] and (fej[i] or fcy[i] or fsat[i]))
                  or (rtch[i] and (rej[i] or rcy[i] or rsat[i]))]
        total = sum(len(f) + len(b) for f, b in zip(fwds, backs))
        if relink:
            f, _ = native.walk([seeds[i] for i in relink], num_steps)
            bk, _ = native.walk([rcs[i] for i in relink], num_steps)
        return total, len(relink)

    # warm both paths (device compile excluded from timings)
    device_assemble(all_seeds[:256], all_rc[:256])
    native.walk(all_seeds[:64], num_steps)

    rows = []
    for n in sizes:
        seeds, rcs = all_seeds[:n], all_rc[:n]
        t0 = time.perf_counter()
        nb, _ = native.walk(seeds, num_steps)
        nr, _ = native.walk(rcs, num_steps)
        t_nat = time.perf_counter() - t0
        nat_bases = sum(len(s) for s in nb) + sum(len(s) for s in nr)

        t0 = time.perf_counter()
        total, n_relink = device_assemble(seeds, rcs)
        t_dev = time.perf_counter() - t0

        row = {
            "seeds": n,
            "native_s": round(t_nat, 3),
            "device_s": round(t_dev, 3),
            "native_bases_per_s": round(nat_bases / t_nat),
            "device_link_replays": n_relink,
            "speedup_device": round(t_nat / t_dev, 2),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    out = {
        "metric": "linked_walk_device_vs_native",
        "graph_records": g.num_records,
        "num_steps": num_steps,
        "native_build_s": round(native_build, 1),
        "jump_table_build_s": round(jump_build, 1),
        "rows": rows,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
