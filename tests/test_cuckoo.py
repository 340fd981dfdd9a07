"""Cuckoo (bucketized two-choice) walk table vs the linear-probe table."""

import numpy as np
import pytest
import jax.numpy as jnp

from corticall_tpu import fixtures, kmer as km
from corticall_tpu.ops import cuckoo as ck, hashtable as ht, walk as wk


def _graph(seed, n, k):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), n))
    return fixtures.build_graph({"s": [genome]}, k), genome, rng


def test_cuckoo_build_places_every_key():
    g, _, _ = _graph(5, 30000, 21)
    ct = ck.build_cuckoo(g.kmers, g.edges[:, 0])
    tags = ct.buckets.reshape(ct.num_buckets, ck.BUCKET_SIZE, ct.words + 1)[..., -1]
    assert int((tags >= 0x80000000).sum()) == g.num_records


def test_cuckoo_lookup_hit_and_miss():
    g, genome, rng = _graph(6, 20000, 31)
    k = 31
    ct = ck.build_cuckoo(g.kmers, g.edges[:, 0])
    buckets = jnp.asarray(ct.buckets)
    # hits: canonical kmers from the graph -> payload == edge byte
    idx = rng.integers(0, g.num_records, size=200)
    canon = jnp.asarray(g.kmers[idx])
    pay = np.asarray(ck.lookup_payload(buckets, canon, ct.words))
    np.testing.assert_array_equal(pay, g.edges[idx, 0].astype(np.uint32))
    # misses: random kmers (canonicalized) almost surely absent
    rnd = ["".join(rng.choice(list("ACGT"), k)) for _ in range(50)]
    rnd = [s for s in rnd if g.find_record(s) < 0]
    canon_m = jnp.asarray(km.pack_codes(
        km.strings_to_codes([min(s, km.revcomp(s)) for s in rnd]), k))
    assert not np.asarray(ck.lookup_payload(buckets, canon_m, ct.words)).any()


def test_cuckoo_walk_matches_fused():
    for k in (15, 47):
        g, genome, rng = _graph(k, 40000, k)
        table = ht.build(g.kmers, load_factor=0.25)
        entries = jnp.asarray(table.build_walk_entries(g.kmers, g.edges[:, 0]))
        ct = ck.build_cuckoo(g.kmers, g.edges[:, 0])
        buckets = jnp.asarray(ct.buckets)
        starts = rng.integers(0, 40000 - k, size=128)
        seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(
            [genome[i:i + k] for i in starts]), k))
        fb, fc, fs = wk.walk_forward_fused(entries, seeds, k, table.max_probe, 150)
        cb, cc, cs = ck.walk_forward_cuckoo(buckets, seeds, k, 150)
        np.testing.assert_array_equal(np.asarray(fb), np.asarray(cb))
        np.testing.assert_array_equal(np.asarray(fc), np.asarray(cc))
        np.testing.assert_array_equal(np.asarray(fs), np.asarray(cs))


def test_cuckoo_high_load():
    # eviction path must engage and still place everything at load ~0.9
    g, _, _ = _graph(9, 60000, 17)
    ct = ck.build_cuckoo(g.kmers, g.edges[:, 0], load_factor=0.9)
    tags = ct.buckets.reshape(ct.num_buckets, ck.BUCKET_SIZE, ct.words + 1)[..., -1]
    assert int((tags >= 0x80000000).sum()) == g.num_records


def test_walk_np_matches_cuckoo():
    from corticall_tpu.ops import walk_np as wnp
    for k in (15, 47):
        g, genome, rng = _graph(100 + k, 30000, k)
        ct = ck.build_cuckoo(g.kmers, g.edges[:, 0])
        buckets = jnp.asarray(ct.buckets)
        starts = rng.integers(0, 30000 - k, size=96)
        seed_strs = [genome[i:i + k] for i in starts]
        seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(seed_strs), k))
        cb, cc, cs = ck.walk_forward_cuckoo(buckets, seeds, k, 120)
        nb, nc, ns = wnp.walk_forward_np(g, [0], km.strings_to_codes(seed_strs), 120)
        np.testing.assert_array_equal(np.asarray(cb), nb)
        np.testing.assert_array_equal(np.asarray(cc), nc)
        np.testing.assert_array_equal(np.asarray(cs), ns)


def test_build_walk_table_bs2_places_every_key_primary_biased():
    g, _, _ = _graph(12, 30000, 21)
    ct = ck.build_walk_table(g.kmers, g.edges[:, 0])
    assert ct.bucket_size == 2
    tags = ct.buckets.reshape(ct.num_buckets, 2, ct.words + 1)[..., -1]
    assert int((tags >= 0x80000000).sum()) == g.num_records
    # primary-biased build approaches the balls-in-bins bound (~0.896 @ load .5)
    assert ct.primary_fraction > 0.85


def test_lookup_payload_bucket_size_agnostic():
    g, genome, rng = _graph(13, 20000, 31)
    ct2 = ck.build_walk_table(g.kmers, g.edges[:, 0])
    ct4 = ck.build_cuckoo(g.kmers, g.edges[:, 0])
    idx = rng.integers(0, g.num_records, size=300)
    canon = jnp.asarray(g.kmers[idx])
    p2 = np.asarray(ck.lookup_payload(jnp.asarray(ct2.buckets), canon, ct2.words))
    p4 = np.asarray(ck.lookup_payload(jnp.asarray(ct4.buckets), canon, ct4.words))
    np.testing.assert_array_equal(p2, p4)
    np.testing.assert_array_equal(p2, g.edges[idx, 0].astype(np.uint32))


def test_walk_spec_matches_two_probe():
    """Speculative single-probe walks decode to the same contigs, cycle flags
    and step counts as the always-two-probe kernel (stall slots are -1 and
    skipped by replay_walk)."""
    for k in (15, 47):
        g, genome, rng = _graph(200 + k, 30000, k)
        ct = ck.build_walk_table(g.kmers, g.edges[:, 0])
        buckets = jnp.asarray(ct.buckets)
        ct4 = ck.build_cuckoo(g.kmers, g.edges[:, 0])
        b4 = jnp.asarray(ct4.buckets)
        starts = rng.integers(0, 30000 - k, size=96)
        seed_strs = [genome[i:i + k] for i in starts]
        seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(seed_strs), k))
        sb, sc, ss = ck.walk_forward_spec(buckets, seeds, k, 120)
        ob, oc, os_ = ck.walk_forward_cuckoo(b4, seeds, k, 120)
        np.testing.assert_array_equal(np.asarray(sc), np.asarray(oc))
        np.testing.assert_array_equal(np.asarray(ss), np.asarray(os_))
        sb, ob = np.asarray(sb).T, np.asarray(ob).T
        for i, s in enumerate(seed_strs):
            assert (wk.replay_walk(s, sb[i], bool(np.asarray(sc)[i]), 120)
                    == wk.replay_walk(s, ob[i], bool(np.asarray(oc)[i]), 120))


def test_walk_spec_cycle_detection():
    k = 21
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), 600))
    cyc = genome + genome[:k]  # circular chromosome
    g = fixtures.build_graph({"s": [cyc]}, k)
    ct = ck.build_walk_table(g.kmers, g.edges[:, 0])
    seeds = jnp.asarray(km.pack_codes(km.strings_to_codes([cyc[:k]]), k))
    sb, sc, ss = ck.walk_forward_spec(jnp.asarray(ct.buckets), seeds, k, 3000)
    assert bool(np.asarray(sc)[0])
    ext = wk.replay_walk(cyc[:k], np.asarray(sb).T[0], True, 3000)
    # reference seen-set semantics: one full lap plus one base (the seed kmer
    # itself is never in the seen set, so the walk re-enters it once)
    assert (cyc[:k] + ext) in (genome + genome + genome)
    assert len(ext) == len(genome) + 1


def test_walk_spec_caps_emission_at_num_steps():
    g, genome, rng = _graph(14, 20000, 31)
    ct = ck.build_walk_table(g.kmers, g.edges[:, 0])
    starts = rng.integers(0, 10000, size=32)
    seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(
        [genome[i:i + 31] for i in starts]), 31))
    _, _, ss = ck.walk_forward_spec(jnp.asarray(ct.buckets), seeds, 31, 7)
    assert int(np.asarray(ss).max()) == 7 and int(np.asarray(ss).min()) >= 0


def test_walk_spec_chunked_matches_one_shot():
    g, genome, rng = _graph(15, 25000, 31)
    ct = ck.build_walk_table(g.kmers, g.edges[:, 0])
    buckets = jnp.asarray(ct.buckets)
    starts = rng.integers(0, 25000 - 31, size=64)
    seed_strs = [genome[i:i + 31] for i in starts]
    seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(seed_strs), 31))
    ob, oc, os_ = ck.walk_forward_spec(buckets, seeds, 31, 300)
    cb, cc, cs = ck.walk_forward_spec_chunked(buckets, seeds, 31, 300, chunk=37)
    np.testing.assert_array_equal(np.asarray(oc), cc)
    np.testing.assert_array_equal(np.asarray(os_), cs)
    ob = np.asarray(ob).T
    cbt = cb.T
    for i, s in enumerate(seed_strs):
        assert (wk.replay_walk(s, ob[i], bool(np.asarray(oc)[i]), 300)
                == wk.replay_walk(s, cbt[i], bool(cc[i]), 300))
    # early exit engaged: the emitted stream is shorter than the full scan
    # whenever all walks die before the cap
    assert cb.shape[0] <= ck.spec_iters(300)


# ---------------------------------------------------------------------------
# run table: unitig-lookahead jump walks
# ---------------------------------------------------------------------------

def test_shift_append_multi_matches_repeated():
    from corticall_tpu.ops import kmer_jax as kj
    import jax.numpy as jnp2
    rng = np.random.default_rng(0)
    for k in (5, 16, 21, 31, 33, 47, 63):
        strs = ["".join(rng.choice(list("ACGT"), k)) for _ in range(48)]
        words = jnp2.asarray(km.pack_codes(km.strings_to_codes(strs), k))
        bases = rng.integers(0, 4, (48, 24)).astype(np.uint32)
        m = rng.integers(0, 25, 48).astype(np.int32)
        hi24 = np.zeros(48, np.uint32)
        lo24 = np.zeros(48, np.uint32)
        for j in range(12):
            hi24 |= bases[:, j] << (22 - 2 * j)
            lo24 |= bases[:, 12 + j] << (22 - 2 * j)
        out = kj.shift_append_multi(words, jnp2.asarray(hi24),
                                    jnp2.asarray(lo24), jnp2.asarray(m), k)
        exp = words
        for step in range(24):
            nxt = kj.shift_append(exp, jnp2.asarray(bases[:, step]), k)
            exp = jnp2.where((jnp2.asarray(m) > step)[:, None], nxt, exp)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(exp))


def test_run_table_matches_spec_on_linear_graph():
    from corticall_tpu.ops import walk_np as wnp
    for k in (15, 47):
        g, genome, rng = _graph(300 + k, 30000, k)
        rt = ck.build_run_table(g.kmers, g.edges[:, 0], k)
        ct = ck.build_walk_table(g.kmers, g.edges[:, 0])
        starts = rng.integers(0, 30000 - k, size=96)
        seed_strs = [genome[i:i + k] for i in starts]
        seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(seed_strs), k))
        w0, w1, rcy, rs = ck.walk_forward_runs(
            jnp.asarray(rt.buckets), jnp.asarray(rt.runs), seeds, k, 120)
        sb, sc, ss = ck.walk_forward_spec(jnp.asarray(ct.buckets), seeds, k, 120)
        # acyclic walks emit identical step counts
        np.testing.assert_array_equal(np.asarray(rs), np.asarray(ss))
        w0t, w1t = np.asarray(w0).T, np.asarray(w1).T
        sbt = np.asarray(sb).T
        for i, s in enumerate(seed_strs):
            assert (wnp.replay_run_walk(s, w0t[i], w1t[i], 120)
                    == wk.replay_walk(s, sbt[i], bool(np.asarray(sc)[i]), 120))


def test_run_table_circular_chromosome():
    from corticall_tpu.ops import walk_np as wnp
    k = 21
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), 600))
    cyc = genome + genome[:k]
    g = fixtures.build_graph({"s": [cyc]}, k)
    rt = ck.build_run_table(g.kmers, g.edges[:, 0], k)
    seeds = jnp.asarray(km.pack_codes(km.strings_to_codes([cyc[:k]]), k))
    w0, w1, rcy, rs = ck.walk_forward_runs(
        jnp.asarray(rt.buckets), jnp.asarray(rt.runs), seeds, k, 3000)
    assert bool(np.asarray(rcy)[0])
    ext = wnp.replay_run_walk(cyc[:k], np.asarray(w0).T[0],
                              np.asarray(w1).T[0], 3000)
    # reference seen-set semantics: one full lap plus one base
    assert (cyc[:k] + ext) in (genome + genome + genome)
    assert len(ext) == len(genome) + 1


def test_run_table_short_cycles_and_junctions():
    from corticall_tpu.ops import walk_np as wnp
    k = 5
    cases = {
        "fig1": "ACTGATTTCGATGCGATGCGATGCCACGGTGG",  # junction stop
        "homopolymer": "TTGCA" + "A" * 30 + "CGTAC",  # self-loop kmer
    }
    # tiny cycle: circular 8-mer chromosome at k=5
    tiny = "ACGTGCTT"
    cases["tiny_cycle"] = tiny + tiny[:k]
    for name, hap in cases.items():
        g = fixtures.build_graph({"s": [hap]}, k)
        rt = ck.build_run_table(g.kmers, g.edges[:, 0], k)
        ct = ck.build_walk_table(g.kmers, g.edges[:, 0])
        seed_strs = sorted({hap[i:i + k] for i in range(len(hap) - k + 1)})
        seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(seed_strs), k))
        w0, w1, rcy, rs = ck.walk_forward_runs(
            jnp.asarray(rt.buckets), jnp.asarray(rt.runs), seeds, k, 200)
        sb, sc, ss = ck.walk_forward_spec(jnp.asarray(ct.buckets), seeds, k, 200)
        w0t, w1t, sbt = np.asarray(w0).T, np.asarray(w1).T, np.asarray(sb).T
        for i, s in enumerate(seed_strs):
            got = wnp.replay_run_walk(s, w0t[i], w1t[i], 200)
            want = wk.replay_walk(s, sbt[i], bool(np.asarray(sc)[i]), 200)
            assert got == want, (name, s, got, want)


def test_run_table_cap_and_chunked():
    from corticall_tpu.ops import walk_np as wnp
    g, genome, rng = _graph(17, 25000, 31)
    rt = ck.build_run_table(g.kmers, g.edges[:, 0], 31)
    starts = rng.integers(0, 25000 - 31, size=64)
    seed_strs = [genome[i:i + 31] for i in starts]
    seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(seed_strs), 31))
    # cap: emitted steps stop exactly at num_steps (mid-run clamping)
    w0, w1, rcy, rs = ck.walk_forward_runs(
        jnp.asarray(rt.buckets), jnp.asarray(rt.runs), seeds, 31, 7)
    assert int(np.asarray(rs).max()) == 7
    # chunked driver == one-shot
    o0, o1, ocy, os_ = ck.walk_forward_runs(
        jnp.asarray(rt.buckets), jnp.asarray(rt.runs), seeds, 31, 300)
    c0, c1, ccy, cs = ck.walk_forward_runs_chunked(
        jnp.asarray(rt.buckets), jnp.asarray(rt.runs), seeds, 31, 300, chunk=13)
    np.testing.assert_array_equal(np.asarray(ocy), ccy)
    np.testing.assert_array_equal(np.asarray(os_), cs)
    o0t, o1t, c0t, c1t = (np.asarray(o0).T, np.asarray(o1).T, c0.T, c1.T)
    for i, s in enumerate(seed_strs):
        assert (wnp.replay_run_walk(s, o0t[i], o1t[i], 300)
                == wnp.replay_run_walk(s, c0t[i], c1t[i], 300))


def test_jump_table_matches_run_table():
    """Pointer-jumping kernel == run-table kernel: same steps, cycle flags,
    and replayed contigs on a branchy two-sample graph, across caps that
    clamp mid-run and caps that let walks die naturally."""
    from corticall_tpu.ops import walk_np as wnp
    rng = np.random.default_rng(23)
    genome = "".join(rng.choice(list("ACGT"), 24000))
    child = list(genome)
    for pos in rng.integers(31, 24000 - 31, size=40):
        child[pos] = "ACGT"[(ord(child[pos]) + 1) % 4]
    g = fixtures.build_graph({"kid": ["".join(child)], "mom": [genome]}, 31)

    rt = ck.build_run_table(g.kmers, g.edges[:, 0], 31)
    jt = ck.build_jump_table(g.kmers, g.edges[:, 0], 31)
    starts = rng.integers(0, 24000 - 31, size=96)
    seed_strs = [genome[i:i + 31] for i in starts]
    seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(seed_strs), 31))

    for cap in (7, 300):
        o0, o1, ocy, os_ = ck.walk_forward_runs(
            jnp.asarray(rt.buckets), jnp.asarray(rt.runs), seeds, 31, cap)
        packed, jcy, js, _, _, _ = ck.walk_forward_jumps(
            jt.buckets, jt.rows, seeds, 31, cap)
        np.testing.assert_array_equal(np.asarray(os_), js)
        np.testing.assert_array_equal(np.asarray(ocy), jcy)
        o0t, o1t = np.asarray(o0).T, np.asarray(o1).T
        for i, s in enumerate(seed_strs):
            assert (wnp.replay_run_walk(s, o0t[i], o1t[i], cap)
                    == wnp.replay_jump_walk(s, packed[i], int(js[i]), cap))


def test_jump_table_missing_seed_inactive():
    g, genome, rng = _graph(29, 20000, 31)
    jt = ck.build_jump_table(g.kmers, g.edges[:, 0], 31)
    missing = "A" * 31
    seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(
        [genome[:31], missing]), 31))
    packed, cy, steps, sat, _, _ = ck.walk_forward_jumps(
        jt.buckets, jt.rows, seeds, 31, 50)
    assert steps[1] == 0 and not cy[1]
    assert steps[0] > 0


def test_jump_table_cycles():
    """Cyclic graphs through the jump kernel (the run-table cycle cases):
    cycle lengths that are and are not multiples of JUMP_MAX, plus a cycle
    whose jump period exceeds the cap — that lane must be flagged
    `saturated` and its replayed contig must still be the exact seen-set
    answer (jump-stride Brent misses cycles with period
    L/gcd(L, JUMP_MAX) > cap/JUMP_MAX jumps)."""
    from corticall_tpu.ops import walk_np as wnp
    k = 31
    rng = np.random.default_rng(5)
    cases = {}
    # cycle lengths with varying gcd vs JUMP_MAX (32): 616 -> period 77
    # jumps, 600 -> 75, 90 -> 45; all must end as cycled or saturated
    cases["cycle_616"] = "".join(rng.choice(list("ACGT"), 616))
    cases["cycle_600"] = "".join(rng.choice(list("ACGT"), 600))
    cases["cycle_90"] = "".join(rng.choice(list("ACGT"), 90))
    for name, cyc in cases.items():
        hap = cyc + cyc[:k]                    # circular chromosome
        g = fixtures.build_graph({"s": [hap]}, k)
        if g.num_records != len(cyc):
            continue                           # rare collision; skip case
        ct = ck.build_walk_table(g.kmers, g.edges[:, 0])
        jt = ck.build_jump_table(g.kmers, g.edges[:, 0], k)
        seed_strs = [hap[:k], hap[7:7 + k]]
        seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(seed_strs), k))
        for cap in (3000, len(cyc) + 50):
            packed, jcy, js, jsat, _, _ = ck.walk_forward_jumps(
                jt.buckets, jt.rows, seeds, k, cap)
            sb, sc, ss = ck.walk_forward_spec_chunked(
                jnp.asarray(ct.buckets), seeds, k, cap)
            sbt = np.asarray(sb).T
            for i, s in enumerate(seed_strs):
                got = wnp.replay_jump_walk(s, packed[i], int(js[i]), cap)
                want = wk.replay_walk(s, sbt[i], bool(sc[i]), cap)
                assert got == want, (name, cap, s)
                # every lane is on a cycle: it must be either detected
                # (cycled) or flagged potentially-cyclic (saturated)
                assert bool(jcy[i]) or bool(jsat[i]), (name, cap, s)


def _gather_rows_tiled(flat, idx, size):
    """Reference: the 128-word-tile gather with a one-hot row select."""
    per = 128 // size
    t = flat.reshape(-1, 128)[idx // per].reshape(-1, per, size)
    onehot = (jnp.arange(per)[None, :] == (idx % per)[:, None])
    return (t * onehot[:, :, None].astype(t.dtype)).sum(axis=1)


@pytest.mark.parametrize("size", [4, 8])
def test_gather_rows_matches_tiled_select(size):
    rng = np.random.default_rng(size)
    flat = rng.integers(0, 2**32, 128 * 64, dtype=np.uint32)
    idx = rng.integers(0, len(flat) // size, 1000).astype(np.int32)
    got = np.asarray(ck._gather_rows(jnp.asarray(flat), jnp.asarray(idx),
                                     size))
    np.testing.assert_array_equal(got, flat.reshape(-1, size)[idx])
    np.testing.assert_array_equal(
        got, np.asarray(_gather_rows_tiled(jnp.asarray(flat),
                                           jnp.asarray(idx), size)))
