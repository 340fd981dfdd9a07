"""Two-process jax.distributed dryrun of the sharded execution suite.

The round-2 build validated graph sharding on a single-process virtual mesh
only; this tool runs the REAL multi-host path (SURVEY §2.4 comm-backend row,
BASELINE.json ≥80% scaling at 2+ hosts is its perf target):

  launcher (this script, no args)
    - builds a trio fixture graph + links, writes real .ctx/.ctp.bgz files
    - computes oracle contigs (host numpy walker), linked contigs
      (single-device link kernel) and ROI counts
    - spawns N worker processes and checks their assertions

  worker (argv: worker <pid> <nprocs> <port> <workdir>)
    - jax.distributed.initialize over localhost, CPU devices + gloo
      collectives, 4 virtual devices per process -> one global 8-device mesh
    - per-host BYTE-RANGE graph loading: each process reads only its record
      slice (io.ctx.read_ctx_range) — no host materializes the whole graph
    - device-side record redistribution: records ride one capacity-bounded
      all_to_all from the reading host to their hash-owning shard (the same
      routing pattern the lookups use), then each host builds cuckoo tables
      for ITS shards only
    - runs sharded walks (make_sharded_walk_run), FindROIs and link-assisted
      walks (make_sharded_linked_walk_run) over the cross-process mesh and
      asserts bit-identical results against the launcher's oracles

Usage: python tools/dryrun_multihost.py [--processes 2]
Prints one JSON line with the results.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K = 17
NUM_STEPS = 256
SEED_COUNT = 64


def _fixture(workdir: str) -> dict:
    """Build the fixture + oracles (runs in the launcher, single process)."""
    import numpy as np
    from corticall_tpu import fixtures, kmer as km
    from corticall_tpu.commands import core
    from corticall_tpu.io import ctx as ctxio, links as lkio
    from corticall_tpu.ops import walk_np as wnp
    from corticall_tpu.ops.walk_links import LinkedWalker

    rng = np.random.default_rng(77)
    genome = "".join(rng.choice(list("ACGT"), 6000))
    rep = "".join(rng.choice(list("ACGT"), 60))
    child = (genome[:2000] + rep + genome[2000:4000] + rep + genome[4000:]
             + "TGACGTAGGC")
    g = fixtures.build_graph(
        {"kid": [child], "mom": [genome], "dad": [genome]}, K)
    ctx_path = os.path.join(workdir, "mh_graph.ctx")
    ctxio.write_ctx(ctx_path, g.data)
    links = lkio.build_links(g, {"kid": [child[1500:2600], child[3500:4600]]},
                             "kid")
    links_path = os.path.join(workdir, "mh_links.ctp.bgz")
    lkio.write_links_indexed(links_path, links, source="kid")

    starts = rng.integers(0, len(child) - K, size=SEED_COUNT)
    seeds = [child[i:i + K] for i in starts]

    # oracle 1: plain walks via the host numpy walker
    bases, cycled, _ = wnp.walk_forward_np(
        g, [0], km.strings_to_codes(seeds), NUM_STEPS)
    rc = [km.revcomp(s) for s in seeds]
    rbases, rcycled, _ = wnp.walk_forward_np(
        g, [0], km.strings_to_codes(rc), NUM_STEPS)
    contigs = {}
    for i, s in enumerate(seeds):
        fwd = wnp.replay_walk(s, bases.T[i], bool(cycled[i]), NUM_STEPS)
        back = wnp.replay_walk(rc[i], rbases.T[i], bool(rcycled[i]), NUM_STEPS)
        contigs[s] = (km.revcomp(back) if back else "") + s + fwd

    # oracle 2: ROIs
    rois = core.find_rois(g, "kid", ["mom", "dad"])
    roi_strs = sorted(rois.kmer_string(i) for i in range(rois.num_records))

    # oracle 3: linked walks via the single-device link kernel
    lw = LinkedWalker(g, [0], [links])
    linked_want, _, ljn = lw.assemble(roi_strs, num_steps=NUM_STEPS)

    spec = {
        "ctx": ctx_path, "links": links_path, "k": K,
        "seeds": seeds, "contigs": contigs,
        "rois": roi_strs,
        "linked": dict(zip(roi_strs, linked_want)),
        "linked_junctions": int(ljn.sum()),
    }
    with open(os.path.join(workdir, "mh_spec.json"), "w") as f:
        json.dump(spec, f)
    return spec


def _worker(pid: int, nprocs: int, port: int, workdir: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(f"localhost:{port}", num_processes=nprocs,
                               process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    import jax.experimental.multihost_utils as mhu
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from corticall_tpu import graph as gr, kmer as km
    from corticall_tpu.io import ctx as ctxio, links as lkio
    from corticall_tpu.ops import walk_np as wnp
    from corticall_tpu.ops import cuckoo as ck
    from corticall_tpu.ops.walk_links import decode_linked_walk
    from corticall_tpu.parallel import mesh as pm

    with open(os.path.join(workdir, "mh_spec.json")) as f:
        spec = json.load(f)
    k = spec["k"]

    devs = jax.devices()
    n_dev = len(devs)
    n_loc = len(jax.local_devices())
    assert n_dev == nprocs * n_loc
    mesh = Mesh(np.array(devs), (pm.AXIS,))
    shard1 = NamedSharding(mesh, P(pm.AXIS))

    # ---- per-host byte-range load -------------------------------------------
    n_rec = ctxio.ctx_num_records(spec["ctx"])
    lo = pid * n_rec // nprocs
    hi = (pid + 1) * n_rec // nprocs
    data = ctxio.read_ctx_range(spec["ctx"], lo, hi - lo)
    w = data.kmers.shape[1]
    c = data.coverages.shape[1]

    # ---- device-side record redistribution to hash owners ------------------
    owner = (pm.routing_hash_np(data.kmers) % np.uint32(n_dev)).astype(np.int64)
    f_cols = w + c + c + 2                     # kmer, cov, edges, valid, owner
    mine = hi - lo
    # split my slice across my local devices
    per_dev_rows = [(mine * (j + 1) // n_loc) - (mine * j // n_loc)
                    for j in range(n_loc)]
    m_loc = -(-n_rec // n_dev) + 8             # uniform split ceiling
    local_pay = np.zeros((n_loc, m_loc, f_cols), dtype=np.uint32)
    pos = 0
    counts_loc = np.zeros((n_loc, n_dev), dtype=np.int32)
    for j, rows in enumerate(per_dev_rows):
        sl = slice(pos, pos + rows)
        local_pay[j, :rows, :w] = data.kmers[sl]
        local_pay[j, :rows, w:w + c] = data.coverages[sl]
        local_pay[j, :rows, w + c:w + 2 * c] = data.edges[sl]
        local_pay[j, :rows, -2] = 1
        local_pay[j, :rows, -1] = owner[sl]
        local_pay[j, rows:, -1] = n_dev        # padding sorts last
        counts_loc[j] = np.bincount(owner[sl], minlength=n_dev)
        pos += rows

    counts_all = np.asarray(mhu.process_allgather(counts_loc, tiled=True))
    cap = int(counts_all.max()) + 1
    shard_totals = counts_all.sum(axis=0)      # records per owning shard

    X = jax.make_array_from_process_local_data(shard1, local_pay)

    def exchange(x):
        x = x[0]
        own = x[:, -1].astype(jnp.int32)
        order = jnp.argsort(own)
        xs = x[order]
        owns = own[order]
        ids = jnp.arange(n_dev, dtype=jnp.int32)
        starts = jnp.searchsorted(owns, ids)
        cnt = jnp.searchsorted(owns, ids, side="right") - starts
        xp = jnp.concatenate([xs, jnp.zeros_like(xs)], axis=0)

        def bucket(s):
            sl = jax.lax.dynamic_slice(xp, (starts[s], 0), (cap, xp.shape[1]))
            valid = (jnp.arange(cap) < cnt[s])[:, None]
            return jnp.where(valid, sl, 0)

        send = jnp.stack([bucket(s) for s in range(n_dev)])
        recv = jax.lax.all_to_all(send, pm.AXIS, split_axis=0, concat_axis=0,
                                  tiled=False)
        return recv.reshape(1, n_dev * cap, x.shape[1])

    ex = jax.jit(jax.shard_map(exchange, mesh=mesh, in_specs=P(pm.AXIS),
                               out_specs=P(pm.AXIS)))
    owned = ex(X)

    # ---- per-host table builds over owned shards ----------------------------
    n_max = max(int(shard_totals.max()), 1)
    nb = 4
    while nb * ck.BUCKET_SIZE * 0.5 < n_max:
        nb *= 2
    kmers_l = np.zeros((n_loc, n_max, w), dtype=np.uint32)
    edges_l = np.zeros((n_loc, n_max, c), dtype=np.uint8)
    covs_l = np.zeros((n_loc, n_max, c), dtype=np.uint32)
    buckets_l = np.zeros((n_loc, nb, ck.BUCKET_SIZE * (w + 1)), dtype=np.uint32)
    my_shards = []
    for sh in owned.addressable_shards:
        d = sh.index[0].start if isinstance(sh.index[0], slice) else sh.index[0]
        rows = np.asarray(sh.data)[0]
        rows = rows[rows[:, -2] == 1]
        assert ((pm.routing_hash_np(np.ascontiguousarray(rows[:, :w]))
                 % np.uint32(n_dev)) == d % n_dev).all(), "mis-routed records"
        j = d - pid * n_loc
        ns = rows.shape[0]
        assert ns == shard_totals[d], (d, ns, shard_totals[d])
        kmers_l[j, :ns] = rows[:, :w]
        covs_l[j, :ns] = rows[:, w:w + c]
        edges_l[j, :ns] = rows[:, w + c:w + 2 * c].astype(np.uint8)
        if ns:
            t = ck.build_cuckoo(np.ascontiguousarray(rows[:, :w]),
                                np.arange(ns, dtype=np.uint32) + 1,
                                num_buckets=nb)
            buckets_l[j] = t.buckets
        my_shards.append(int(d))

    def to_global(local):
        return jax.make_array_from_process_local_data(shard1, local)

    sg = pm.ShardedGraph(
        kmer_size=k, num_shards=n_dev,
        kmers=to_global(kmers_l), edges=to_global(edges_l),
        coverages=to_global(covs_l), buckets=to_global(buckets_l),
        counts=shard_totals.astype(np.int64))

    # ---- sharded walks across the process boundary --------------------------
    seeds = spec["seeds"]
    rc = [km.revcomp(s) for s in seeds]

    def run_walks(strs):
        b = len(strs)
        pad = (-b) % n_dev
        padded = strs + [strs[0]] * pad
        packed = km.pack_codes(km.strings_to_codes(padded), k)
        bl = len(padded) // nprocs
        local = packed[pid * bl:(pid + 1) * bl]
        garr = jax.make_array_from_process_local_data(shard1, local)
        act = jax.make_array_from_process_local_data(
            shard1, np.ones(bl, dtype=bool))
        run = pm.make_sharded_walk_run(mesh, sg, [0], k, NUM_STEPS)
        with mesh:
            bases, cycled, steps = run(garr, act)
        bases = np.asarray(mhu.process_allgather(bases, tiled=True))
        cycled = np.asarray(mhu.process_allgather(cycled, tiled=True))
        return bases.T[:b], cycled[:b]

    fb, fc = run_walks(seeds)
    rb, rcy = run_walks(rc)
    n_ok = 0
    for i, s in enumerate(seeds):
        fwd = wnp.replay_walk(s, fb[i], bool(fc[i]), NUM_STEPS)
        back = wnp.replay_walk(rc[i], rb[i], bool(rcy[i]), NUM_STEPS)
        got = (km.revcomp(back) if back else "") + s + fwd
        assert got == spec["contigs"][s], (s, got[:60], spec["contigs"][s][:60])
        n_ok += 1

    # ---- sharded FindROIs ----------------------------------------------------
    roi_run = pm.make_sharded_find_rois(mesh, sg, child_color=0,
                                        parent_colors=[1, 2])
    with mesh:
        mask, total = roi_run()
    assert int(np.asarray(mhu.process_allgather(total, tiled=True)).ravel()[0]
               ) == len(spec["rois"])
    roi_set = set(spec["rois"])
    for sh in mask.addressable_shards:
        d = sh.index[0].start
        j = d - pid * n_loc
        got_k = kmers_l[j][np.asarray(sh.data)[0]]
        for row in got_k:
            ks = km.words_row_to_string(row, k)
            assert min(ks, km.revcomp(ks)) in roi_set

    # ---- sharded link-assisted walks ----------------------------------------
    # links are small next to the graph; ShardedLinks keeps the full-load
    # path (each host slices the pool for its shards)
    full = gr.CortexGraph(ctxio.read_ctx(spec["ctx"]))
    links = lkio.open_links(spec["links"])
    sg_full = pm.ShardedGraph.from_graph(full, n_dev)
    sl = pm.ShardedLinks.from_graph(full, [links], n_dev,
                                    n_max=sg_full.kmers.shape[1])

    def loc_rows(arr):
        a = np.asarray(arr)
        return a[pid * n_loc:(pid + 1) * n_loc]

    sg2 = pm.ShardedGraph(
        kmer_size=k, num_shards=n_dev,
        kmers=jax.make_array_from_process_local_data(shard1, loc_rows(sg_full.kmers)),
        edges=jax.make_array_from_process_local_data(shard1, loc_rows(sg_full.edges)),
        coverages=jax.make_array_from_process_local_data(shard1, loc_rows(sg_full.coverages)),
        buckets=jax.make_array_from_process_local_data(shard1, loc_rows(sg_full.buckets)),
        counts=sg_full.counts)
    sl2 = pm.ShardedLinks(
        offsets=jax.make_array_from_process_local_data(shard1, loc_rows(sl.offsets)),
        choices=jax.make_array_from_process_local_data(shard1, loc_rows(sl.choices)),
        lengths=jax.make_array_from_process_local_data(shard1, loc_rows(sl.lengths)),
        forward=jax.make_array_from_process_local_data(shard1, loc_rows(sl.forward)),
        truncated=sl.truncated)

    lrun = pm.make_sharded_linked_walk_run(mesh, sg2, sl2, [0], k, NUM_STEPS)

    def run_linked(strs):
        b = len(strs)
        pad = (-b) % n_dev
        padded = strs + [strs[0]] * pad
        packed = km.pack_codes(km.strings_to_codes(padded), k)
        bl = len(padded) // nprocs
        garr = jax.make_array_from_process_local_data(
            shard1, packed[pid * bl:(pid + 1) * bl])
        act = jax.make_array_from_process_local_data(
            shard1, np.ones(bl, dtype=bool))
        with mesh:
            em, of, jn = lrun(garr, act)
        em = np.asarray(mhu.process_allgather(em, tiled=True)).T[:b]
        of = np.asarray(mhu.process_allgather(of, tiled=True))[:b]
        jn = np.asarray(mhu.process_allgather(jn, tiled=True))[:b]
        return em, of, jn

    roi_strs = spec["rois"]
    rcl = [km.revcomp(s) for s in roi_strs]
    fe, fo, fj = run_linked(roi_strs)
    re_, ro, rj = run_linked(rcl)
    assert not (fo.any() or ro.any()), "link-store overflow in dryrun fixture"
    n_link_ok = 0
    for i, s in enumerate(roi_strs):
        fwd = decode_linked_walk(s, fe[i], NUM_STEPS)
        back = decode_linked_walk(rcl[i], re_[i], NUM_STEPS)
        got = (km.revcomp(back) if back else "") + s + fwd
        assert got == spec["linked"][s], (s, got[:60])
        n_link_ok += 1
    junctions = int(fj.sum() + rj.sum())
    assert junctions == spec["linked_junctions"], (
        junctions, spec["linked_junctions"])

    mhu.sync_global_devices("dryrun_multihost done")
    print(json.dumps({
        "worker": pid, "ok": True, "global_devices": n_dev,
        "local_devices": n_loc, "records_read": int(hi - lo),
        "records_total": int(n_rec), "exchange_cap": cap,
        "contigs_identical": n_ok, "rois": len(spec["rois"]),
        "linked_identical": n_link_ok, "link_junctions": junctions,
    }), flush=True)


def main() -> None:
    nprocs = 2
    if "--processes" in sys.argv:
        nprocs = int(sys.argv[sys.argv.index("--processes") + 1])
    import tempfile
    workdir = tempfile.mkdtemp(prefix="mh_dryrun_")
    import jax
    jax.config.update("jax_platforms", "cpu")
    _fixture(workdir)
    port = 23400 + os.getpid() % 1000
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), "worker",
         str(i), str(nprocs), str(port), workdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(nprocs)]
    outs = [p.communicate(timeout=900) for p in procs]
    results = []
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            sys.stderr.write(f"worker {i} FAILED rc={p.returncode}\n{err[-4000:]}\n")
            sys.exit(1)
        results.append(json.loads(out.strip().splitlines()[-1]))
    print(json.dumps({
        "metric": "multihost_dryrun",
        "processes": nprocs,
        "global_devices": results[0]["global_devices"],
        "per_host_byte_range_records": [r["records_read"] for r in results],
        "contigs_identical": results[0]["contigs_identical"],
        "rois": results[0]["rois"],
        "linked_identical": results[0]["linked_identical"],
        "link_junctions": results[0]["link_junctions"],
        "ok": all(r["ok"] for r in results),
    }))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                sys.argv[5])
    else:
        main()
