"""End-to-end Call pipeline tests on simulated trios."""

import numpy as np
import pytest

from corticall_tpu import fixtures, kmer as km
from corticall_tpu.commands import core
from corticall_tpu.caller.call import Caller
from corticall_tpu.models.reference_index import IndexedReference


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def make_trio(child_seq, parent_seq, k=21):
    g = fixtures.build_graph(
        {"kid": [child_seq], "mom": [parent_seq], "dad": [parent_seq]}, k)
    rois = core.find_rois(g, "kid", ["mom", "dad"])
    parts = core.partition(g, rois)
    # references are keyed by background sample name (the WDL's `-R name:fa`)
    ir = IndexedReference({"chr1": parent_seq})
    refs = {"mom": ir, "dad": ir}
    return g, rois, parts, refs


def run_caller(child_seq, parent_seq, k=21):
    g, rois, parts, refs = make_trio(child_seq, parent_seq, k)
    assert rois.num_records > 0, "no novel kmers in scenario"
    assert parts, "no partitions"
    caller = Caller(g, rois, parts, backgrounds=["mom", "dad"], references=refs)
    variants, _ = caller.call()
    return variants, rois, parts


def test_call_snp():
    rng = np.random.default_rng(17)
    parent = _genome(rng, 1500)
    pos = 700
    alt = "ACGT"[("ACGT".index(parent[pos]) + 1) % 4]
    child = parent[:pos] + alt + parent[pos + 1:]

    variants, rois, parts = run_caller(child, parent)
    assert len(variants) >= 1
    snps = [v for v in variants if v.is_snp()]
    assert len(snps) == 1
    v = snps[0]
    assert v.alleles[0] == parent[pos]
    assert v.alleles[1] == alt
    # lifted to reference coordinates: chr1, 1-based position of the SNP
    assert v.chrom == "chr1"
    assert v.start == pos + 1
    assert v.get_attr("CALL_FUNC") == "smallBubble"


def test_call_insertion():
    rng = np.random.default_rng(23)
    parent = _genome(rng, 1500)
    pos = 800
    ins = "TGACGTA"
    child = parent[:pos] + ins + parent[pos:]

    variants, _, _ = run_caller(child, parent)
    assert len(variants) >= 1
    indels = [v for v in variants
              if not v.is_symbolic() and len(v.alleles[1]) > len(v.alleles[0])]
    assert len(indels) >= 1
    v = indels[0]
    # indel placement may be shifted by the aligner; length is exact
    assert len(v.alleles[1]) - len(v.alleles[0]) == len(ins)
    assert v.chrom == "chr1"


def test_call_deletion():
    rng = np.random.default_rng(29)
    parent = _genome(rng, 1500)
    child = parent[:600] + parent[609:]  # 9bp deletion

    variants, _, _ = run_caller(child, parent)
    dels = [v for v in variants
            if not v.is_symbolic() and len(v.alleles[0]) > len(v.alleles[1])]
    assert len(dels) >= 1
    v = dels[0]
    assert len(v.alleles[0]) - len(v.alleles[1]) == 9
    assert v.chrom == "chr1"


def test_call_no_variants_on_identical_trio():
    rng = np.random.default_rng(31)
    parent = _genome(rng, 800)
    g = fixtures.build_graph({"kid": [parent], "mom": [parent], "dad": [parent]}, 21)
    rois = core.find_rois(g, "kid", ["mom", "dad"])
    assert rois.num_records == 0


def test_write_outputs(tmp_path):
    rng = np.random.default_rng(37)
    parent = _genome(rng, 1200)
    pos = 500
    alt = "ACGT"[("ACGT".index(parent[pos]) + 2) % 4]
    child = parent[:pos] + alt + parent[pos + 1:]

    g, rois, parts, refs = make_trio(child, parent)
    caller = Caller(g, rois, parts, backgrounds=["mom", "dad"], references=refs)
    vcf = tmp_path / "calls.vcf"
    acct = tmp_path / "acct.txt"
    final, acct_map = caller.write_outputs(vcf, acct)

    text = vcf.read_text()
    assert text.startswith("##fileformat=VCF")
    assert "chr1" in text
    lines = [l for l in text.splitlines() if not l.startswith("#")]
    assert len(lines) == len(final) >= 1
    # accounting: every ROI kmer assigned to a call or absent
    acct_text = acct.read_text().splitlines()
    assert len(acct_text) == rois.num_records
    assert any("CC" in line for line in acct_text)


def test_call_mnp_decomposition_reconstructs_haplotype():
    """An MNP may legally decompose into adjacent indels under affine-gap
    scoring; the calls must jointly reconstruct the child haplotype."""
    from corticall_tpu import evaluation as ev
    rng = np.random.default_rng(71)
    parent = _genome(rng, 2000)
    pos, L = 900, 6
    old = parent[pos:pos + L]
    alt = "".join("ACGT"[("ACGT".index(c) + 2) % 4] for c in old)
    child = parent[:pos] + alt + parent[pos + L:]
    variants, _, _ = run_caller(child, parent, k=47)
    calls = [{"chrom": v.chrom, "pos": v.start, "ref": v.alleles[0],
              "alt": v.alleles[1], "info": {}} for v in variants
             if not v.is_symbolic()]
    truth = [{"chrom": "chr1", "pos": pos + 1, "ref": old, "alt": alt,
              "info": {"TYPE": "MNP"}}]
    venn = ev.evaluate_calls(truth, calls, {"chr1": parent}, 47,
                             combine_window=100)
    assert venn["tp"] == 1


def test_call_inversion():
    rng = np.random.default_rng(29)
    parent = _genome(rng, 2000)
    pos, L = 1000, 60
    inv = km.revcomp(parent[pos:pos + L])
    child = parent[:pos] + inv + parent[pos + L:]
    variants, _, _ = run_caller(child, parent, k=31)
    assert variants, "inversion produced no calls"
    # the inverted haplotype must be recoverable from the emitted calls
    from corticall_tpu import evaluation as ev
    calls = [{"chrom": v.chrom, "pos": v.start, "ref": v.alleles[0],
              "alt": v.alleles[1], "info": {}} for v in variants
             if not v.is_symbolic()]
    truth = [{"chrom": "chr1", "pos": pos + 1, "ref": parent[pos:pos + L],
              "alt": inv, "info": {"TYPE": "INV"}}]
    venn = ev.evaluate_calls(truth, calls, {"chr1": parent}, 31,
                             combine_window=200)
    got_symbolic = any(v.is_symbolic() for v in variants)
    assert venn["tp"] == 1 or got_symbolic


def test_call_multiple_variants_one_chromosome():
    rng = np.random.default_rng(31)
    parent = _genome(rng, 4000)
    p1, p2 = 1000, 3000
    a1 = "ACGT"[("ACGT".index(parent[p1]) + 1) % 4]
    ins = "TTGACAG"
    child = (parent[:p1] + a1 + parent[p1 + 1:p2] + ins + parent[p2:])
    variants, _, _ = run_caller(child, parent, k=31)
    snps = [v for v in variants if v.is_snp()]
    assert any(v.start == p1 + 1 and v.alleles[1] == a1 for v in snps)
    indels = [v for v in variants if not v.is_symbolic()
              and len(v.alleles[1]) - len(v.alleles[0]) == len(ins)]
    assert indels, "insertion missing"


def test_device_tesserae_identical_vcf():
    """Caller(tesserae="device") — the device mosaic-alignment path
    (ops/tesserae_jax, shape-bucketed) — must emit exactly the same variants
    as the host oracle on a multi-variant scenario."""
    rng = np.random.default_rng(29)
    parent = _genome(rng, 3000)
    child = (parent[:600] + "T" + parent[601:]          # SNP-ish
             )
    child = child[:1500] + "TGACGTAGGC" + child[1500:]  # 10bp insertion
    child = child[:2400] + child[2420:]                 # 20bp deletion

    g, rois, parts, refs = make_trio(child, parent)
    outs = {}
    for mode in ("host", "device"):
        caller = Caller(g, rois, parts, backgrounds=["mom", "dad"],
                        references=refs, tesserae=mode)
        variants, _ = caller.call()
        outs[mode] = [(v.chrom, v.start, tuple(v.alleles),
                       sorted(v.filters), v.get_attr("CALL_FUNC"))
                      for v in variants]
    assert outs["host"] == outs["device"] and outs["host"]


def test_filter_calls_fdr(tmp_path):
    """FilterCalls: the manuscript FDR protocol (caller/filter.py) over a
    written VCF — NOVEL_KMERS emission, <5-kmer rejection, BND mate/
    multi-breakend handling, CLI round trip."""
    from corticall_tpu.caller.filter import filter_calls
    from corticall_tpu.caller.variants import Variant, read_vcf, write_vcf

    def v(chrom, pos, alleles, nk, id_=None, **attrs):
        var = Variant(chrom, pos, pos, alleles, id_=id_,
                      attributes={"NOVEL_KMERS": nk, **attrs})
        if not var.is_symbolic():
            var.compute_end_from_alleles()
        return var

    snv_strong = v("chr1", 100, ["A", "C"], 8)
    snv_weak = v("chr1", 300, ["G", "T"], 2)
    # lone breakend pair (one pair = no multi-breakend support)
    b0 = v("chr1", 500, ["A", "A[chr2:9]["], 9, id_="b0",
           SVTYPE="BND", MATEID="b1", PARTITION_NAME="p1")
    b1 = v("chr1", 600, ["C", "]chr2:5]C"], 9, id_="b1",
           SVTYPE="BND", MATEID="b0", PARTITION_NAME="p1")
    # double pair in one partition (NAHR-grade support)
    quad = [v("chr2", 100 + i, ["A", "A[chr3:1["], 9, id_=f"q{i}",
              SVTYPE="BND", MATEID=f"q{i ^ 1}", PARTITION_NAME="p2")
            for i in range(4)]
    # strong BND pair whose mate fails the kmer rule -> both drop
    m0 = v("chr3", 100, ["A", "A[chr4:1["], 9, id_="m0",
           SVTYPE="BND", MATEID="m1", PARTITION_NAME="p3")
    m1 = v("chr3", 200, ["C", "]chr4:2]C"], 1, id_="m1",
           SVTYPE="BND", MATEID="m0", PARTITION_NAME="p3")
    m2 = [v("chr3", 300 + i, ["A", "A[chr4:9["], 9, id_=f"n{i}",
            SVTYPE="BND", MATEID=f"n{i ^ 1}", PARTITION_NAME="p3")
          for i in range(2)]

    allv = [snv_strong, snv_weak, b0, b1, *quad, m0, m1, *m2]
    kept, rejected = filter_calls(allv)
    kept_ids = {(x.chrom, x.start) for x in kept}
    assert ("chr1", 100) in kept_ids          # strong SNV survives
    assert ("chr1", 300) not in kept_ids      # <5 novel kmers
    assert ("chr1", 500) not in kept_ids      # lone pair: no NAHR support
    for i in range(4):
        assert ("chr2", 100 + i) in kept_ids  # double pair survives
    assert ("chr3", 100) not in kept_ids      # mate failed the kmer rule
    assert ("chr3", 200) not in kept_ids
    # mate-following must not resurrect: without the NAHR rule the lone
    # pair survives but the weak-mate pair still drops
    kept2, _ = filter_calls(allv, require_nahr_multibreakend=False)
    ids2 = {(x.chrom, x.start) for x in kept2}
    assert ("chr1", 500) in ids2 and ("chr3", 100) not in ids2

    # VCF round trip: NOVEL_KMERS arrives as a string and still filters
    p = tmp_path / "calls.vcf"
    write_vcf(p, allv, [("chr1", 1000), ("chr2", 1000), ("chr3", 1000)])
    rt, sd = read_vcf(p)
    assert sd[0] == ("chr1", 1000) and len(rt) == len(allv)
    kept3, _ = filter_calls(rt)
    assert {(x.chrom, x.start) for x in kept3} == kept_ids


def test_write_outputs_emits_novel_kmers(tmp_path):
    rng = np.random.default_rng(41)
    parent = _genome(rng, 1200)
    pos = 500
    alt = "ACGT"[("ACGT".index(parent[pos]) + 2) % 4]
    child = parent[:pos] + alt + parent[pos + 1:]
    g, rois, parts, refs = make_trio(child, parent)
    caller = Caller(g, rois, parts, backgrounds=["mom", "dad"],
                    references=refs)
    final, _ = caller.write_outputs(tmp_path / "c.vcf", tmp_path / "a.txt")
    assert final and all(int(v.get_attr("NOVEL_KMERS", 0)) > 0
                         for v in final)
    assert "NOVEL_KMERS=" in (tmp_path / "c.vcf").read_text()


def test_filter_calls_reciprocal_nahr_and_inherited(tmp_path):
    """(a) Lone breakend pairs with RECIPROCAL bracket support (an NAHR
    insertion's region-side and donor-side partitions) survive the
    multi-breakend rule; (b) calls whose predicted haplotype exists in a
    parental draft are rejected as inherited (parent-dropout FP class)."""
    from corticall_tpu.caller.filter import filter_calls, inherited_in_references
    from corticall_tpu.caller.variants import Variant
    from corticall_tpu.models.reference_index import IndexedReference
    import numpy as np

    def v(chrom, pos, alleles, nk, id_=None, **attrs):
        var = Variant(chrom, pos, pos, alleles, id_=id_,
                      attributes={"NOVEL_KMERS": nk, **attrs})
        if not var.is_symbolic():
            var.compute_end_from_alleles()
        return var

    # region-side pair at ~857400 pointing to 611900-612700; donor-side
    # pair at ~612300 pointing to 857200-857900 -> mutual support
    r0 = v("chr1", 857406, ["G", "]mom:chr1:611909-612671:+:246]G"], 9,
           id_="r0", SVTYPE="BND", MATEID="r1", PARTITION_NAME="pA")
    r1 = v("chr1", 857565, ["G", "G[mom:chr1:611907-612673:+:159["], 9,
           id_="r1", SVTYPE="BND", MATEID="r0", PARTITION_NAME="pA")
    d0 = v("chr1", 612267, ["A", "A[mom:chr1:856803-857565:+:245["], 9,
           id_="d0", SVTYPE="BND", MATEID="d1", PARTITION_NAME="pB")
    d1 = v("chr1", 612426, ["T", "]mom:chr1:857206-857972:+:160]T"], 9,
           id_="d1", SVTYPE="BND", MATEID="d0", PARTITION_NAME="pB")
    # unrelated lone pair: bracket points nowhere reciprocal
    l0 = v("chr2", 100, ["A", "A[mom:chr2:5000-5600:+:10["], 9,
           id_="l0", SVTYPE="BND", MATEID="l1", PARTITION_NAME="pC")
    l1 = v("chr2", 240, ["C", "]mom:chr2:5100-5700:+:20]C"], 9,
           id_="l1", SVTYPE="BND", MATEID="l0", PARTITION_NAME="pC")
    kept, rej = filter_calls([r0, r1, d0, d1, l0, l1])
    ids = {x.id_ for x in kept}
    assert {"r0", "r1", "d0", "d1"} <= ids
    assert "l0" not in ids and "l1" not in ids

    # inherited-haplotype rejection
    rng = np.random.default_rng(3)
    mom = "".join(rng.choice(list("ACGT"), 3000))
    # dad carries A->T at 1500 relative to mom
    dad = mom[:1500] + ("T" if mom[1500] != "T" else "A") + mom[1501:]
    refs = {"mom": IndexedReference({"c1": mom}),
            "dad": IndexedReference({"c1": dad})}
    # call reports dad's allele against the mom frame: inherited, not DNM
    inh = v("c1", 1501, [mom[1500], dad[1500]], 30, BACKGROUND="mom")
    dnm_base = "G" if "G" not in (mom[1500], dad[1500]) else "C"
    dnm = v("c1", 1501, [mom[1500], dnm_base], 30, BACKGROUND="mom")
    assert inherited_in_references(inh, refs)
    assert not inherited_in_references(dnm, refs)
    kept2, _ = filter_calls([inh, dnm], references=refs)
    assert [x.alleles[1] for x in kept2] == [dnm_base]


def test_rolling_window_hashes_match_kmer_hash_codes():
    from corticall_tpu.caller.call import (_rolling_window_hashes,
                                           _kmer_hash_codes)
    from corticall_tpu import kmer as km
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 300).astype(np.uint8)
    k = 21
    hf, hr = _rolling_window_hashes(codes, k)
    wins = km.kmerize_codes(codes, k)
    assert np.array_equal(hf, _kmer_hash_codes(wins))
    rc = np.stack([(3 - w)[::-1] for w in wins])
    assert np.array_equal(hr, _kmer_hash_codes(rc))


def test_batch_link_touch_matches_per_seed_membership():
    from corticall_tpu.caller.call import (_batch_link_touch,
                                           _kmer_hash_codes)
    from corticall_tpu import kmer as km
    rng = np.random.default_rng(1)
    k = 15
    paths = ["".join(rng.choice(list("ACGT"), rng.integers(k, 120)))
             for _ in range(40)]
    key_kmers = [p[3:3 + k] for p in paths[::4]]     # every 4th path touched
    canon = [min(s, km.revcomp(s)) for s in key_kmers]
    link_keys = np.unique(_kmer_hash_codes(km.strings_to_codes(canon)))
    got = _batch_link_touch(paths, k, link_keys)

    for i, p in enumerate(paths):
        codes = km.string_to_codes_permissive(p)
        wins = km.kmerize_codes(codes, k)
        cn, _ = km.canonicalize_codes(wins)
        h = _kmer_hash_codes(cn)
        pos = np.minimum(np.searchsorted(link_keys, h), len(link_keys) - 1)
        want = bool(np.any(link_keys[pos] == h))
        if want:
            assert got[i], i          # false negatives impossible
    assert got[::4].all()


def test_batch_replay_exts_matches_replay_walk():
    from corticall_tpu.caller.call import _batch_replay_exts
    from corticall_tpu.ops.walk_np import replay_walk
    rng = np.random.default_rng(2)
    k, T = 9, 40
    seeds, rows, cyc = [], [], []
    for i in range(30):
        seeds.append("".join(rng.choice(list("ACGT"), k)))
        n = int(rng.integers(0, T + 1))
        row = np.full(T, -1, np.int8)
        row[:n] = rng.integers(0, 4, n)
        rows.append(row)
        cyc.append(bool(rng.random() < 0.3))
    bases2d = np.stack(rows)
    cycled = np.asarray(cyc)
    for cap in (5, T):
        got = _batch_replay_exts(seeds, bases2d, cycled, cap)
        want = [replay_walk(s, bases2d[i], bool(cycled[i]), cap)
                for i, s in enumerate(seeds)]
        assert got == want, cap
