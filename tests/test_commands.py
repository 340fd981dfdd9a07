"""Command-layer tests: graph algebra, ROI discovery, prefilters, Partition, CLI."""

import subprocess
import sys
import os

import numpy as np

from corticall_tpu import fixtures, graph as gr, kmer as km
from corticall_tpu.commands import core


def trio(k=5):
    return fixtures.build_graph({
        "kid": ["AGTTCTGATCTGGGCTATGGCTA"],   # has novel stretch ATGGCTA
        "mom": ["AGTTCTGATCTGGGCTATATGCT"],
        "dad": ["AGTTCGAATCTGGGCTATATGCT"],
    }, k)


def test_join_matches_multicolor_build():
    g1 = fixtures.build_graph({"a": ["AGTTCTGATCT"]}, 5)
    g2 = fixtures.build_graph({"b": ["TCTGGGCTATA"]}, 5)
    joined = core.join([g1, g2])
    direct = fixtures.build_graph({"a": ["AGTTCTGATCT"], "b": ["TCTGGGCTATA"]}, 5)
    assert joined.sample_names == ["a", "b"]
    assert set(joined.record_strings()) == set(direct.record_strings())


def test_remove_subtracts_kmers():
    g1 = fixtures.build_graph({"a": ["AGTTCTGATCT"]}, 5)
    g2 = fixtures.build_graph({"b": ["GTTCTG"]}, 5)  # kmers GTTCT, TTCTG
    out = core.remove(g1, [g2])
    kept = {out.kmer_string(i) for i in range(out.num_records)}
    removed = {g2.kmer_string(i) for i in range(g2.num_records)}
    allk = {g1.kmer_string(i) for i in range(g1.num_records)}
    assert kept == allk - removed
    assert out.sample_names == ["a"]


def test_find_rois():
    g = trio()
    rois = core.find_rois(g, "kid", ["mom", "dad"])
    assert rois.num_colors == 1
    assert rois.sample_names == ["kid"]
    # novel kmers = kid kmers absent from both parents
    kid, mom, dad = (fixtures.build_graph({"s": [h]}, 5) for h in
                     ("AGTTCTGATCTGGGCTATGGCTA", "AGTTCTGATCTGGGCTATATGCT",
                      "AGTTCGAATCTGGGCTATATGCT"))
    kidset = {kid.kmer_string(i) for i in range(kid.num_records)}
    momset = {mom.kmer_string(i) for i in range(mom.num_records)}
    dadset = {dad.kmer_string(i) for i in range(dad.num_records)}
    expect = kidset - momset - dadset
    got = {rois.kmer_string(i) for i in range(rois.num_records)}
    assert got == expect
    assert len(got) > 0


def test_find_low_coverage():
    g = fixtures.build_graph({"s": ["AAAAAA", "CCGGTT"]}, 3)
    roi = core.subset_colors(g, [0], np.ones(g.num_records, dtype=bool))
    out = core.find_low_coverage(roi, min_coverage=2)
    # AAA covered 4x, CCG 2x (CCG + canonical(CGG)); AAC and ACC excluded
    excluded = {out.kmer_string(i) for i in range(out.num_records)}
    assert excluded == {"AAC", "ACC"}


def test_find_shared():
    g = fixtures.build_graph({
        "kid": ["AGTTCTGATCTGGGCTATGGCTA"],
        "mom": ["AGTTCTGATCTGGGCTATATGCT"],
        "dad": ["AGTTCGAATCTGGGCTATATGCT"],
        "sib": ["CTATGGCTA"],   # shares part of kid's novel stretch
    }, 5)
    rois = core.find_rois(g, "kid", ["mom", "dad"])
    shared = core.find_shared(g, rois, ["mom", "dad"])
    got = {shared.kmer_string(i) for i in range(shared.num_records)}
    sib = fixtures.build_graph({"s": ["CTATGGCTA"]}, 5)
    sibset = {sib.kmer_string(i) for i in range(sib.num_records)}
    roiset = {rois.kmer_string(i) for i in range(rois.num_records)}
    assert got == roiset & sibset
    assert got  # non-empty


def test_find_tips_excludes_dead_end_chain():
    # kid has a novel tail hanging off the shared path (dead end at right)
    g = fixtures.build_graph({
        "kid": ["AGTTCTGATCTGG", "TCTGGACACACGT"],
        "mom": ["AGTTCTGATCTGG"],
    }, 5)
    rois = core.find_rois(g, "kid", ["mom"])
    tips = core.find_tips(g, rois, ["mom"])
    assert tips.num_records > 0
    tipset = {tips.kmer_string(i) for i in range(tips.num_records)}
    roiset = {rois.kmer_string(i) for i in range(rois.num_records)}
    assert tipset <= roiset


def test_partition_groups_novels():
    g = trio()
    rois = core.find_rois(g, "kid", ["mom", "dad"])
    parts = core.partition(g, rois)
    assert len(parts) >= 1
    # all novel kmers must appear in some partition contig
    roiset = {rois.kmer_string(i) for i in range(rois.num_records)}
    covered = set()
    for header, contig in parts:
        assert header.startswith("partition")
        for j in range(len(contig) - 4):
            sk = contig[j:j + 5]
            covered.add(min(sk, km.revcomp(sk)))
    assert roiset <= covered


def test_cli_roundtrip(tmp_path):
    g = trio()
    gp = tmp_path / "trio.ctx"
    g.save(gp)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(*args):
        return subprocess.run([sys.executable, "-m", "corticall_tpu", *args],
                              capture_output=True, text=True, env=env, cwd=repo)

    rois = tmp_path / "rois.ctx"
    r = run("FindROIs", "-g", str(gp), "-c", "kid", "-p", "mom", "-p", "dad",
            "-o", str(rois))
    assert r.returncode == 0, r.stderr
    assert rois.exists()

    r = run("View", "-g", str(rois))
    assert r.returncode == 0, r.stderr
    assert len(r.stdout.strip().splitlines()) == gr.CortexGraph.load(rois).num_records

    parts = tmp_path / "parts.fa"
    r = run("Partition", "-g", str(gp), "-r", str(rois), "-o", str(parts))
    assert r.returncode == 0, r.stderr
    text = parts.read_text()
    assert text.startswith(">partition0")

    r = run("CovStats", "-g", str(gp))
    assert r.returncode == 0 and "kid" in r.stdout


def test_find_unanchored():
    import numpy as np
    from corticall_tpu.models.reference_index import IndexedReference
    rng = np.random.default_rng(71)
    parent = "".join(rng.choice(list("ACGT"), 800))
    # child has a placeable SNP and a free-floating unplaceable fragment
    pos = 400
    alt = "ACGT"[("ACGT".index(parent[pos]) + 1) % 4]
    floating = "".join(rng.choice(list("ACGT"), 120))
    child_seqs = [parent[:pos] + alt + parent[pos + 1:], floating]
    g = fixtures.build_graph({"kid": child_seqs, "mom": [parent], "dad": [parent]}, 21)
    rois = core.find_rois(g, "kid", ["mom", "dad"])
    lookups = {"mom": IndexedReference({"chr1": parent})}
    out = core.find_unanchored(g, rois, ["mom", "dad"], lookups)
    excluded = {out.kmer_string(i) for i in range(out.num_records)}
    # the floating fragment's kmers are excluded; the SNP chain is anchored
    float_kmers = set()
    for i in range(len(floating) - 21 + 1):
        sk = floating[i:i + 21]
        float_kmers.add(min(sk, km.revcomp(sk)))
    roiset = {rois.kmer_string(i) for i in range(rois.num_records)}
    assert excluded == roiset & float_kmers
    assert len(excluded) > 0
    snp_kmers = roiset - float_kmers
    assert snp_kmers and not (snp_kmers & excluded)


def test_indexlinks_cli(tmp_path):
    import subprocess, sys, os
    from corticall_tpu.io import links as lk
    haplotypes = {"test": ["ACTGATTTCGATGCGATGCGATGCCACGGTGG"]}
    reads = {"test": ["TTTCGATGCGATGCGATGCCACG"]}
    g = fixtures.build_graph(haplotypes, 5)
    links = lk.build_links(g, reads, "test")
    p = tmp_path / "t.ctp.gz"
    lk.write_links(p, links)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "corticall_tpu", "IndexLinks",
                        "-l", str(p), "-s", "srcX"],
                       capture_output=True, text=True, env=env, cwd=repo)
    assert r.returncode == 0, r.stderr
    bgz = tmp_path / "t.ctp.bgz"
    assert bgz.exists() and (tmp_path / "t.ctp.bgz.idx").exists()
    ra = lk.open_links(bgz)
    assert ra.source == "srcX"
    assert set(ra.index) == set(links.records)


def test_cli_explore_show_novel(tmp_path):
    g = trio()
    gp = tmp_path / "trio.ctx"
    g.save(gp)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(*args):
        return subprocess.run([sys.executable, "-m", "corticall_tpu", *args],
                              capture_output=True, text=True, env=env, cwd=repo)

    kid = "AGTTCTGATCTGGGCTATGGCTA"
    r = run("Explore", "-g", str(gp), "-s", "kid",
            "-b", kid[:5], "-e", kid[10:15], "-o", "-")
    assert r.returncode == 0, r.stderr
    contig = r.stdout.strip()
    assert kid[:5] in contig and kid[10:15] in contig and contig in kid

    rois = tmp_path / "rois.ctx"
    parts = tmp_path / "parts.fa"
    assert run("FindROIs", "-g", str(gp), "-c", "kid", "-p", "mom",
               "-p", "dad", "-o", str(rois)).returncode == 0
    assert run("Partition", "-g", str(gp), "-r", str(rois),
               "-o", str(parts)).returncode == 0
    r = run("ShowNovelKmers", "-c", str(parts), "-r", str(rois),
            "-g", str(gp), "-o", "-")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("partition")
    assert any(" True " in l for l in lines[1:])

    # probe: nonexistent sample must fail with a clear error, not traceback
    r = run("Explore", "-g", str(gp), "-s", "nobody",
            "-b", kid[:5], "-e", kid[10:15])
    assert r.returncode != 0
