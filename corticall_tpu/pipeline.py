"""Pipeline — L6 orchestration: the production stage order as a resumable run.

The reference orchestrates its pipeline with Cromwell WDL
(cromwell/wdl/Simulate.wdl): per-sample `mccortex build/clean/inferedges`
(:620-666), read threading into links + IndexLinks (:666-713), Join (:760),
FindROIs (:804), the prefilter chain FindOrphans/FindTips/FindDust/
FindLowCoverage/FindLowComplexity (:847-1063), RemoveKmers (:1064),
Partition (:1107) and Call (:1331-1430) — every intermediate materialized to
GCS, which is also its checkpoint story (SURVEY §5).

This module is the in-process equivalent: one `run_pipeline` call executes the
same stage order against the same on-disk artifact formats (.ctx, .ctp.bgz +
.idx, FASTA, VCF), records per-stage wall-clock + stats in `state.json`, and
resumes by skipping any stage whose artifact is already on disk with a
matching state entry.  Killing the process at any point and re-running with
the same workdir continues from the first incomplete stage.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from . import build as bd
from . import graph as gr
from .commands import core
from .io import ctx as ctxio
from .io import fasta as faio
from .io import links as lkio

STATE_FILE = "state.json"


class _State:
    def __init__(self, workdir: str, resume: bool):
        self.path = os.path.join(workdir, STATE_FILE)
        self.data: dict = {"stages": {}}
        if resume and os.path.exists(self.path):
            with open(self.path) as f:
                self.data = json.load(f)

    def done(self, name: str) -> bool:
        return name in self.data["stages"]

    def mark(self, name: str, seconds: float, stats: dict | None = None) -> None:
        self.data["stages"][name] = {
            "seconds": round(seconds, 3), **({"stats": stats} if stats else {})}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.data, f, indent=1)
        os.replace(tmp, self.path)

    def stats(self, name: str) -> dict:
        return self.data["stages"].get(name, {}).get("stats", {})

    def seconds(self, name: str) -> float:
        return self.data["stages"].get(name, {}).get("seconds", 0.0)


def _read_graph(path: str) -> gr.CortexGraph:
    return gr.CortexGraph(ctxio.read_ctx(path))


def _write_fasta_list(path: str, records: list) -> None:
    with open(path, "w") as f:
        for header, seq in records:
            f.write(f">{header}\n{seq}\n")


def _read_fasta_list(path: str) -> list:
    return faio.read_fasta_full_headers(path)


class Pipeline:
    """Resumable staged runner.  Each stage writes its artifact(s) into
    `workdir`; a stage re-runs only if its artifact or state entry is missing.
    """

    def __init__(self, workdir: str, resume: bool = True, log=None):
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        self.state = _State(workdir, resume)
        self.log = log or (lambda *a: None)

    def path(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def stage(self, name: str, artifacts: list, compute, load):
        """Run `compute()` unless every artifact exists and the state says
        the stage completed; in that case `load()` re-materializes results."""
        paths = [self.path(a) for a in artifacts]
        if self.state.done(name) and all(os.path.exists(p) for p in paths):
            self.log(f"[pipeline] {name}: resume (cached)")
            return load(*paths)
        t0 = time.perf_counter()
        result, stats = compute(*paths)
        self.state.mark(name, time.perf_counter() - t0, stats)
        self.log(f"[pipeline] {name}: {self.state.seconds(name)} s")
        return result


def run_pipeline(workdir: str, reads_by_sample: dict, child: str,
                 parents: list, references=None, k: int = 47,
                 min_coverage: int = 2, tip_length: int | None = None,
                 link_samples=None, prefilter: bool = True,
                 lowcov_min: int | str = "auto", max_walk: int = 2000,
                 trim_margin: int = 500, resume: bool = True,
                 caller_opts: dict | None = None, log=None,
                 clean: bool = True, prefilters=None,
                 thread_refs: bool = True,
                 shared_graphs: dict | None = None) -> dict:
    """Execute the full production pipeline from reads to VCF.

    reads_by_sample: {sample: list_of_read_strings} (child first or any
    order; `child`/`parents` name the colors).  references:
    {parent: IndexedReference} for target labelling + coordinate liftover.
    shared_graphs: {sample: CortexGraph} of pre-built cleaned graphs (the
    cross-scatter's shared parents — run_cross_pipeline builds each parent
    once and fans progeny out over it, ProcessPfCross.wdl:41-209's role).
    Returns a dict with the graph, rois, partitions, variants, per-stage
    timings and stats (see keys below).
    """
    pl = Pipeline(workdir, resume=resume, log=log)
    samples = [child] + list(parents)
    link_samples = list(link_samples if link_samples is not None else samples)
    prefilters = list(prefilters if prefilters is not None
                      else ("orphans", "tips", "dust", "lowcov", "lowcomplexity"))

    # ---- per-sample build + clean (mccortex build/clean/inferedges) -------
    cleaned: dict = {}
    for s in samples:
        if shared_graphs and s in shared_graphs:
            cleaned[s] = shared_graphs[s]     # built once by the scatter
            continue
        def compute(path, s=s):
            g = bd.build_graph_from_reads(reads_by_sample[s], k, s)
            raw_records = g.num_records
            if clean:
                g = bd.clean_graph(g, min_coverage=min_coverage,
                                   tip_length=tip_length)
            ctxio.write_ctx(path, g.data)
            return g, {"raw_records": raw_records,
                       "clean_records": g.num_records}
        cleaned[s] = pl.stage(f"build_clean_{s}", [f"{s}.clean.ctx"],
                              compute, _read_graph)

    # ---- join (commands/utils/Join.java; WDL Join :760) --------------------
    def compute_join(path):
        g = core.join([cleaned[s] for s in samples])
        ctxio.write_ctx(path, g.data)
        return g, {"records": g.num_records}
    joined = pl.stage("join", ["joined.ctx"], compute_join, _read_graph)

    # ---- thread reads -> indexed links (ThreadReads + IndexLinks :666-713) -
    links: list = []
    for s in link_samples:
        def compute(path_bgz, s=s):
            ld = lkio.merge_prefix_links(
                bd.thread_reads(joined, reads_by_sample[s], s))
            lkio.write_links_indexed(path_bgz, ld, source=f"{s}.reads")
            return ld, {"kmers_with_links": len(ld)}
        links.append(pl.stage(
            f"thread_{s}", [f"{s}.ctp.bgz"], compute,
            lambda p: lkio.open_links(p)))

    # ---- thread references -> indexed links (ThreadRef :714-760) -----------
    # The WDL threads each parent reference FASTA through the child's graph
    # and hands the resulting link sets to Partition and Call alongside the
    # read links — reference-assisted walks (README capability #4).
    if thread_refs and references:
        for name, ref in references.items():
            def compute(path_bgz, name=name, ref=ref):
                # threaded along the child color (mccortex threads into the
                # child's ctx); the reference identity is the link *source*
                ld = lkio.merge_prefix_links(bd.thread_reads(
                    joined, list(ref.seqs.values()), child))
                ld.source = name
                lkio.write_links_indexed(path_bgz, ld, source=name)
                return ld, {"kmers_with_links": len(ld)}
            links.append(pl.stage(
                f"thread_ref_{name}", [f"ref_{name}.ctp.bgz"], compute,
                lambda p: lkio.open_links(p)))

    # ---- FindROIs (:804) ----------------------------------------------------
    def compute_rois(path):
        r = core.find_rois(joined, child, parents)
        ctxio.write_ctx(path, r.data)
        return r, {"rois": r.num_records}
    rois = pl.stage("find_rois", ["rois.ctx"], compute_rois, _read_graph)

    # ---- prefilter chain + Remove (:847-1064) -------------------------------
    if prefilter and rois.num_records:
        def compute_pf(path):
            excluded = []
            per = {}
            if "orphans" in prefilters:
                e = core.find_orphans(joined, rois, parents)
                per["orphans"] = e.num_records
                excluded.append(e)
            if "tips" in prefilters:
                # the WDL runs FindTips without links (Simulate.wdl:890-904)
                e = core.find_tips(joined, rois, parents)
                per["tips"] = e.num_records
                excluded.append(e)
            if "dust" in prefilters:
                e = core.find_dust(joined, rois, parents)
                per["dust"] = e.num_records
                excluded.append(e)
            if "lowcov" in prefilters:
                m = (core.adaptive_lowcov_threshold(joined, child)
                     if lowcov_min == "auto" else lowcov_min)
                e = core.find_low_coverage(rois, min_coverage=m)
                per["lowcov"] = e.num_records
                per["lowcov_threshold"] = m
                excluded.append(e)
            if "lowcomplexity" in prefilters:
                e = core.find_low_complexity(joined, rois, parents)
                per["lowcomplexity"] = e.num_records
                excluded.append(e)
            out = core.remove(rois, [e for e in excluded if e.num_records])
            ctxio.write_ctx(path, out.data)
            # per-filter counts overlap (a kmer can be both a tip and
            # low-coverage), so the union is reported explicitly and the
            # accounting reconciles: kept = roi_before - excluded_union
            return out, {"excluded": per,
                         "excluded_union": rois.num_records - out.num_records,
                         "roi_before": rois.num_records,
                         "kept": out.num_records,
                         "removed": rois.num_records - out.num_records}
        rois = pl.stage("prefilter", ["rois.filtered.ctx"],
                        compute_pf, _read_graph)

    # ---- Partition with links (:1107; Partition.java) ----------------------
    def compute_partition(path):
        stats: dict = {}
        parts = core.partition(joined, rois, links=links, max_walk=max_walk,
                               stats=stats,
                               checkpoint=pl.path("partition.ckpt.npz"))
        _write_fasta_list(path, parts)
        stats["partitions"] = len(parts)
        return parts, stats
    parts = pl.stage("partition", ["partitions.fa"],
                     compute_partition, _read_fasta_list)

    # ---- TrimPartitions -----------------------------------------------------
    def compute_trim(path):
        from . import evaluation as ev
        roi_set = {rois.kmer_string(i) for i in range(rois.num_records)}
        trimmed = ev.trim_partitions(parts, roi_set, k, margin=trim_margin)
        _write_fasta_list(path, trimmed)
        return trimmed, {"partitions": len(trimmed)}
    parts_t = pl.stage("trim", ["partitions.trimmed.fa"],
                       compute_trim, _read_fasta_list)

    # ---- Call with links (:1331-1430; Call.java) ----------------------------
    def compute_call(vcf_path, acct_path):
        from .caller.call import Caller
        caller = Caller(joined, rois, parts_t, backgrounds=list(parents),
                        references=references or {}, links=links,
                        **(caller_opts or {}))
        variants, _ = caller.write_outputs(vcf_path, acct_path)
        breakdown = {name: round(dt, 3)
                     for name, dt in sorted(caller.timer.sections.items(),
                                            key=lambda kv: -kv[1])}
        if breakdown:
            pl.log(f"[pipeline] call breakdown: {breakdown}")
        return variants, {"calls": len(variants), "call_breakdown": breakdown,
                          "contig_aligner": dict(caller.align_stats),
                          "tesserae": dict(caller.tesserae_stats)}
    variants = pl.stage(
        "call", ["calls.vcf", "accounting.txt"], compute_call,
        lambda vp, ap: _load_vcf_variants(vp))

    # ---- FilterCalls: the manuscript FDR protocol (caller/filter.py) -------
    def compute_filter(path):
        from .caller.filter import filter_calls
        from .caller.variants import write_vcf
        # the coverage threshold stays off by default: the inherited-
        # haplotype check below catches the parent-dropout FP class
        # without risking true low-coverage STR events (FilterCalls
        # exposes --min_novel_coverage for noisier data)
        mnc = 0
        kept, rejected = filter_calls(variants, min_novel_coverage=mnc,
                                      references=references)
        sd, seen = [], set()
        for rid, ir in (references or {}).items():
            for name, seq in ir.seqs.items():
                if name not in seen:
                    sd.append((name, len(seq)))
                    seen.add(name)
            if f"{rid}_unknown" not in seen:
                sd.append((f"{rid}_unknown", len(parts_t)))
                seen.add(f"{rid}_unknown")
        write_vcf(path, kept, sd)
        return kept, {"input_calls": len(variants), "kept": len(kept),
                      "rejected": len(rejected),
                      "min_novel_coverage": mnc}
    filtered = pl.stage("filter_calls", ["calls.filtered.vcf"],
                        compute_filter, _load_vcf_variants)

    return {
        "graph": joined, "rois": rois, "links": links,
        "partitions": parts_t, "variants": variants,
        "filtered_variants": filtered,
        "stages": {n: pl.state.seconds(n) for n in pl.state.data["stages"]},
        "stats": {n: pl.state.stats(n) for n in pl.state.data["stages"]},
        "workdir": workdir,
    }


def run_cross_pipeline(workdir: str, parent_reads: dict, progeny_reads: dict,
                       parents: list, references=None, log=None,
                       **opts) -> dict:
    """Multi-sample scatter over a cross: the reference's production unit
    (ProcessPfCross.wdl:41-209, Simulate.wdl:27-120 — N progeny scattered
    over shared parents, one Cromwell task per sample).

    Each parent graph is built+cleaned ONCE in the shared workdir, then
    every progeny sample runs the full per-child pipeline (join, link
    threading, FindROIs, prefilters, Partition, Call, FilterCalls) in its
    own subdirectory against the shared parent graphs.  Returns per-sample
    results plus the shared/per-child timing split so the reuse is a
    measured number, not a claim.
    """
    t_all = time.perf_counter()
    pl = Pipeline(workdir, resume=opts.get("resume", True), log=log)
    k = opts.get("k", 47)
    min_coverage = opts.get("min_coverage", 2)
    tip_length = opts.get("tip_length")
    clean = opts.get("clean", True)

    shared: dict = {}
    for s in parents:
        def compute(path, s=s):
            g = bd.build_graph_from_reads(parent_reads[s], k, s)
            raw = g.num_records
            if clean:
                g = bd.clean_graph(g, min_coverage=min_coverage,
                                   tip_length=tip_length)
            ctxio.write_ctx(path, g.data)
            return g, {"raw_records": raw, "clean_records": g.num_records}
        shared[s] = pl.stage(f"build_clean_{s}", [f"{s}.clean.ctx"],
                             compute, _read_graph)
    shared_s = round(time.perf_counter() - t_all, 2)

    per_sample: dict = {}
    child_opts = {kk: vv for kk, vv in opts.items()}
    for child in progeny_reads:
        t0 = time.perf_counter()
        res = run_pipeline(
            os.path.join(workdir, child),
            {child: progeny_reads[child], **parent_reads},
            child, list(parents), references=references, log=log,
            shared_graphs=shared, **child_opts)
        res["wallclock_s"] = round(time.perf_counter() - t0, 2)
        per_sample[child] = res

    return {
        "parents": {s: {"records": shared[s].num_records} for s in parents},
        "shared_parent_build_s": shared_s,
        "per_sample": per_sample,
        "progeny": list(progeny_reads),
        "total_s": round(time.perf_counter() - t_all, 2),
    }


def _load_vcf_variants(vcf_path: str) -> list:
    """Re-materialize Variant objects from a pipeline-written VCF (resume)."""
    from .caller.variants import Variant
    out = []
    with open(vcf_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            chrom, pos, _, ref, alt = fields[:5]
            filt = fields[6] if len(fields) > 6 else "."
            v = Variant(chrom, int(pos), 0, [ref] + alt.split(","))
            if not v.is_symbolic():
                v.compute_end_from_alleles()
            for kv in (fields[7].split(";") if len(fields) > 7 else []):
                if "=" in kv:
                    kk, vv = kv.split("=", 1)
                    v.attr(kk, vv)
            if filt not in (".", "PASS"):
                v.filters.update(filt.split(";"))
            out.append(v)
    return out
