"""Command-line interface: `python -m corticall_tpu <Command> [args]`.

Mirrors the reference's CLI surface (`java -jar corticall.jar <Command>`,
Main.java:40-64 + per-command @Argument flags) so WDL pipelines can swap the
jar for this module.  Flag names match the Java fullName/shortName pairs.
"""

from __future__ import annotations

import argparse
import json
import sys

from .. import graph as gr
from ..io import ctx as ctxio
from ..io import links as lkio
from . import core


def _load_links(paths):
    return [lkio.read_links(p) for p in (paths or [])]


def cmd_join(args):
    graphs = [gr.CortexGraph.load(p) for p in args.graph]
    core.join(graphs).save(args.out)


def cmd_remove(args):
    primary = gr.CortexGraph.load(args.graph)
    secondaries = [gr.CortexGraph.load(p) for p in args.secondary]
    core.remove(primary, secondaries).save(args.out)


def cmd_find_rois(args):
    g = gr.CortexGraph.load(args.graph)
    core.find_rois(g, args.child, args.parents).save(args.out)


def cmd_find_low_coverage(args):
    roi = gr.CortexGraph.load(args.roi)
    core.find_low_coverage(roi, args.minCoverage).save(args.out)


def cmd_find_dust(args):
    g = gr.CortexGraph.load(args.graph)
    roi = gr.CortexGraph.load(args.roi)
    core.find_dust(g, roi, args.parents).save(args.out)


def cmd_find_low_complexity(args):
    g = gr.CortexGraph.load(args.graph)
    roi = gr.CortexGraph.load(args.roi)
    core.find_low_complexity(g, roi, args.parents, args.crThreshold).save(args.out)


def cmd_find_shared(args):
    g = gr.CortexGraph.load(args.graph)
    roi = gr.CortexGraph.load(args.roi)
    core.find_shared(g, roi, args.parents, args.ignore or []).save(args.out)


def cmd_find_tips(args):
    g = gr.CortexGraph.load(args.graph)
    roi = gr.CortexGraph.load(args.roi)
    core.find_tips(g, roi, args.parents, _load_links(args.links)).save(args.out)


def cmd_find_orphans(args):
    g = gr.CortexGraph.load(args.graph)
    roi = gr.CortexGraph.load(args.roi)
    core.find_orphans(g, roi, args.parents).save(args.out)


def cmd_partition(args):
    g = gr.CortexGraph.load(args.graph)
    roi = gr.CortexGraph.load(args.roi)
    parts = core.partition(g, roi, _load_links(args.links), args.linkNovels)
    with _out_stream(args.out) as f:
        for header, contig in parts:
            f.write(f">{header}\n{contig}\n")


def cmd_view(args):
    g = gr.CortexGraph.load(args.graph)
    with _out_stream(args.out) as f:
        if args.headerOnly:
            h = g.header
            f.write(f"file: {args.graph}\nversion: {h.version}\nkmer size: {h.kmer_size}\n"
                    f"kmer containers: {h.kmer_containers}\ncolors: {h.num_colors}\n"
                    f"records: {g.num_records}\n")
            for c, color in enumerate(h.colors):
                f.write(f"-- color {c}: {color.sample_name}\n")
        elif args.record:
            for seq in args.record:
                k = g.kmer_size
                for i in range(len(seq) - k + 1):
                    sk = seq[i:i + k]
                    rec = g.find_record(sk)
                    if rec >= 0:
                        f.write(g.record_string(rec) + "\n")
                    else:
                        f.write(f"{sk}: missing\n")
        else:
            for i in range(g.num_records):
                f.write(g.record_string(i) + "\n")


def cmd_head(args):
    g = gr.CortexGraph.load(args.graph)
    with _out_stream(args.out) as f:
        for i in range(min(args.n, g.num_records)):
            f.write(g.record_string(i) + "\n")


def cmd_tail(args):
    g = gr.CortexGraph.load(args.graph)
    with _out_stream(args.out) as f:
        for i in range(max(0, g.num_records - args.n), g.num_records):
            f.write(g.record_string(i) + "\n")


def cmd_covstats(args):
    g = gr.CortexGraph.load(args.graph)
    with _out_stream(args.out) as f:
        f.write("color\tsample\tnum_kmers\ttotal_coverage\tmean_coverage\n")
        import numpy as np
        for c in range(g.num_colors):
            cov = g.coverages[:, c]
            nk = int((cov > 0).sum())
            tot = int(cov.sum())
            f.write(f"{c}\t{g.sample_name(c)}\t{nk}\t{tot}\t"
                    f"{tot / nk if nk else 0:.2f}\n")


def cmd_sort(args):
    from .. import kmer as km
    g = gr.CortexGraph.load(args.graph)
    kmers, cov, edges = gr.sort_records(g.kmers, g.coverages, g.edges, g.kmer_size)
    data = ctxio.CtxData(g.header, kmers, cov, edges,
                         km.words_to_bytes_be(kmers, g.kmer_size))
    gr.CortexGraph(data).save(args.out)


def cmd_index_links(args):
    """`.ctp.gz` -> `.ctp.bgz` + binary `.idx` (IndexLinks.java parity)."""
    data = lkio.read_links(args.links)
    out = args.out or str(args.links).replace(".ctp.gz", ".ctp.bgz")
    lkio.write_links_indexed(out, data, source=args.source)


def cmd_index_reference(args):
    from ..models.reference_index import IndexedReference
    IndexedReference.create_index(args.reference, *(args.source or ["unknown"]))


def cmd_find_unanchored(args):
    from ..models.reference_index import IndexedReference
    g = gr.CortexGraph.load(args.graph)
    roi = gr.CortexGraph.load(args.roi)
    lookups = {}
    for spec in args.drafts:
        name, path = spec.split(":", 1)
        lookups[name] = IndexedReference(path)
    core.find_unanchored(g, roi, args.parents, lookups,
                         _load_links(args.links)).save(args.out)


def cmd_find_contamination(args):
    from ..models.reference_index import IndexedReference
    g = gr.CortexGraph.load(args.graph)
    roi = gr.CortexGraph.load(args.roi)
    contam = gr.CortexGraph.load(args.contamination)
    lookups = {}
    for spec in args.drafts:
        name, path = spec.split(":", 1)
        lookups[name] = IndexedReference(path)
    core.find_contamination(g, roi, args.parents, contam, lookups,
                            _load_links(args.links)).save(args.out)


def cmd_build(args):
    from .. import build as bd
    from ..io import reads as rdio

    def seqs():
        for p in args.reads:
            yield from rdio.read_sequences(p)

    g = bd.build_graph_from_reads(seqs(), args.kmerSize, args.sample)
    g.save(args.out)


def cmd_clean(args):
    from .. import build as bd
    g = gr.CortexGraph.load(args.graph)
    bd.clean_graph(g, args.minCoverage).save(args.out)


def cmd_infer_edges(args):
    from .. import build as bd
    g = gr.CortexGraph.load(args.graph)
    bd.infer_edges(g).save(args.out)


def cmd_thread(args):
    from .. import build as bd
    from ..io import reads as rdio

    g = gr.CortexGraph.load(args.graph)

    def seqs():
        for p in args.reads:
            yield from rdio.read_sequences(p)

    links = bd.thread_reads(g, seqs(), args.sample or g.sample_name(0))
    lkio.write_links(args.out, links)


def cmd_annotate_calls(args):
    from . import more
    from .. import evaluation as ev
    from ..caller.variants import Variant, write_vcf
    from ..io import fasta as faio
    from ..io import gff as gffio

    rows = ev.read_vcf(args.vcf)
    bed = []
    if args.accessory:
        with open(args.accessory) as f:
            for line in f:
                p = line.split("\t")
                if len(p) >= 3:
                    bed.append((p[0], int(p[1]) + 1, int(p[2])))
    genes = gffio.GFF3()
    for p in (args.genes or []):
        genes.records.extend(gffio.GFF3(p).records)
    repeats = gffio.GFF3()
    for p in (args.repeatmasks or []):
        repeats.records.extend(gffio.GFF3(p).records)
    partitions = faio.read_fasta_full_headers(args.partitions)
    rois = gr.CortexGraph.load(args.rois)
    annotated = more.annotate_calls(rows, bed, genes, repeats, partitions, rois)
    variants = [Variant(chrom=r["chrom"], start=r["pos"],
                        alleles=[r["ref"], r["alt"]], id_=r["id"],
                        attributes=r["info"]).compute_end_from_alleles()
                for r in annotated]
    contigs = sorted({r["chrom"] for r in annotated})
    write_vcf(args.out, variants, [(c, 0) for c in contigs])


def cmd_compile_feature_table(args):
    from . import more
    from ..io import fasta as faio
    g = gr.CortexGraph.load(args.graph)
    rois = gr.CortexGraph.load(args.rois)
    features = {}
    for spec in (args.feature or []):
        name, path = spec.split(":", 1)
        features[name] = gr.CortexGraph.load(path)
    contigs = faio.read_fasta_full_headers(args.contigs)
    truth = gr.CortexGraph.load(args.roisTruth)
    rows = more.compile_feature_table(g, rois, features, contigs, truth)
    with _out_stream(args.out) as f:
        if rows:
            cols = list(rows[0].keys())
            f.write("\t".join(cols) + "\n")
            for row in rows:
                f.write("\t".join(row.get(c, "") for c in cols) + "\n")


def cmd_visual_cortex(args):
    """Start the graph visualizer server against a joined graph (+optional
    ROIs) and block — commands/visualizer/VisualCortex equivalent.  The
    page offers kmer-neighborhood search; /stats and /search serve JSON."""
    import sys as _sys
    import time as _time
    from ..visualizer import GraphVisualizer
    g = gr.CortexGraph.load(args.graph)
    rois = gr.CortexGraph.load(args.rois) if args.rois else None
    v = GraphVisualizer(port=args.port, graph=g, rois=rois)
    print(f"visualizer listening on http://127.0.0.1:{v.port}/",
          file=_sys.stderr)
    if args.seed:
        print(json.dumps(v.search(args.seed.upper(), args.radius)))
        if args.once:
            v.shutdown()
            return
    try:
        while True:
            _time.sleep(3600)
    except KeyboardInterrupt:
        v.shutdown()


def cmd_send_to_visualizer(args):
    """Walk a subgraph around a seed and POST it to a running visualizer —
    commands/visualizer/SendToVisualizer equivalent."""
    import urllib.request
    from ..traversal import TraversalConfig, TraversalEngine
    from ..traversal.stopping import ExplorationStopper
    from ..visualizer import subgraph_to_json
    g = gr.CortexGraph.load(args.graph)
    e = TraversalEngine(TraversalConfig(
        graph=g, traversal_colors=list(range(g.num_colors)),
        stopping_rule=ExplorationStopper, max_branch_length=args.radius))
    sub = e.dfs(args.seed.upper())
    payload = subgraph_to_json(sub, g, None, name=f"seed {args.seed}")
    req = urllib.request.Request(
        f"http://127.0.0.1:{args.port}/post",
        data=json.dumps(payload).encode(), method="POST")
    urllib.request.urlopen(req)
    print(json.dumps({"sent_vertices": len(payload["vertices"]),
                      "sent_edges": len(payload["edges"])}))


def cmd_explore(args):
    from . import more
    from ..io import links as lkio
    g = gr.CortexGraph.load(args.graph)
    links_list = [lkio.open_links(p) for p in (args.links or [])]
    contig = more.explore(g, links_list, args.sample, args.begin, args.end)
    with _out_stream(args.out) as f:
        f.write(contig + "\n")


def cmd_simulate_recomb_between_vars(args):
    """Surface parity with the reference's manuscript helper, which ships an
    EMPTY execute() body (commands/paper/SimulateRecombBetweenVars.java:12-15)
    — it opens its output stream and writes nothing."""
    if args.out != "-":
        open(args.out, "w").close()


def cmd_show_novel_kmers(args):
    from . import more
    from ..io import fasta as faio
    g = gr.CortexGraph.load(args.graph)
    rois = gr.CortexGraph.load(args.rois)
    contigs = faio.read_fasta_full_headers(args.contigs)
    with _out_stream(args.out) as f:
        for line in more.show_novel_kmers(contigs, rois, g):
            f.write(line + "\n")


def cmd_evaluate_rois(args):
    from . import more
    from ..io import table as tblio
    rois = gr.CortexGraph.load(args.rois)
    rows = list(tblio.TableReader(args.kmerTable))
    stats = more.evaluate_rois(rois, rows)
    with _out_stream(args.out) as f:
        for key, v in stats.items():
            f.write(f"{key}\t{v}\n")


def cmd_inheritance_to_matrix(args):
    from . import more
    from ..io import table as tblio
    rows = list(tblio.TableReader(args.table))
    mat = more.inheritance_to_matrix(rows, args.child)
    with _out_stream(args.out) as f:
        for r in mat:
            f.write("\t".join(r) + "\n")


def cmd_inheritance_to_circos(args):
    from . import more
    from ..io import table as tblio
    rows = list(tblio.TableReader(args.table))
    tracks = more.inheritance_to_circos_tracks(rows, args.child)
    for child, lines in tracks.items():
        with open(f"{args.outPrefix}.{child}.track", "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))


def cmd_vcf_to_inheritance_track(args):
    from . import more
    from .. import evaluation as ev
    rows = ev.read_vcf(args.vcf)
    with _out_stream(args.out) as f:
        for line in more.vcf_to_inheritance_track(rows):
            f.write(line + "\n")


def cmd_index_bam(args):
    from .. import kmer_index as ki
    ki.index_bam(args.bam, args.kmerSize)


def cmd_query_index(args):
    from .. import kmer_index as ki
    idx = ki.KmerIndexFile(args.bam, args.kmerSize)
    with _out_stream(args.out) as f:
        for rec in idx.query_reads(args.kmer):
            f.write(f"@{rec['name']}\n{rec['seq']}\n")


def cmd_print_index(args):
    from .. import kmer_index as ki
    idx = ki.KmerIndexFile(args.bam, args.kmerSize)
    with _out_stream(args.out) as f:
        for i in range(len(idx)):
            from .. import kmer as km2
            words = km2.disk_to_words(idx.records["kmer"][i:i + 1], idx.k)
            sk = km2.codes_to_string(km2.unpack_words(words[0], idx.k))
            f.write(f"{sk}\t{int(idx.records['start'][i])}\t"
                    f"{int(idx.records['end'][i])}\n")


def cmd_collect_reads(args):
    from .. import kmer_index as ki
    roi = gr.CortexGraph.load(args.roi)
    idx = ki.KmerIndexFile(args.bam, roi.kmer_size)
    seen = set()
    with _out_stream(args.out) as f:
        for i in range(roi.num_records):
            for rec in idx.query_reads(roi.kmer_string(i)):
                key = (rec["name"], rec["seq"])
                if key not in seen:
                    seen.add(key)
                    f.write(f">{rec['name']}\n{rec['seq']}\n")


def cmd_assembly_quality(args):
    from .. import quality
    from ..models.reference_index import IndexedReference
    eval_g = gr.CortexGraph.load(args.eval)
    comp_g = gr.CortexGraph.load(args.comp)
    ref = IndexedReference(args.evalRef)
    q = quality.compute_assembly_quality(eval_g, comp_g, ref)
    with _out_stream(args.out) as f:
        f.write(f"{q}\n")


def cmd_range(args):
    g = gr.CortexGraph.load(args.graph)
    with _out_stream(args.out) as f:
        for i in range(args.start, min(args.end, g.num_records)):
            f.write(g.record_string(i) + "\n")


def cmd_recover_excluded(args):
    from . import extra
    g = gr.CortexGraph.load(args.graph)
    dirty = gr.CortexGraph.load(args.dirty)
    extra.recover_excluded_kmers(g, dirty).save(args.out)


def cmd_compare_rois(args):
    from . import extra
    truth = gr.CortexGraph.load(args.truth)
    ev = gr.CortexGraph.load(args.eval)
    res = extra.compare_rois(truth, ev)
    with _out_stream(args.out) as f:
        f.write(f"t={res['t']} e={res['e']} pt={res['pt']} "
                f"pe={res['pe']} o={res['o']}\n")


def cmd_combine_contigs(args):
    from . import extra
    from ..io import fasta as faio
    contigs = faio.read_fasta_full_headers(args.contigs)
    partitions = faio.read_fasta_full_headers(args.partitions)
    roi = gr.CortexGraph.load(args.roi)
    with _out_stream(args.out) as f:
        for header, seq in extra.combine_contigs(contigs, partitions, roi):
            f.write(f">{header}\n{seq}\n")


def cmd_filter_partitions(args):
    from . import extra
    from ..io import fasta as faio
    contigs = faio.read_fasta_full_headers(args.contigs)
    roi = gr.CortexGraph.load(args.roi)
    with _out_stream(args.out) as f:
        for header, seq in extra.filter_partitions(contigs, roi,
                                                   args.novel_kmer_threshold):
            f.write(f">{header}\n{seq}\n")


def cmd_align_contigs(args):
    """Whole-contig alignment — the lastz replacement
    (models/contig_aligner.py; LastzAligner.java:15-29 role).  Emits a TSV
    of placements: contig, reference, chrom, start, end, strand, score,
    mapq, NM, cigar."""
    import json as _json
    import sys as _sys
    from ..io import fasta as faio
    from ..models.contig_aligner import align_contigs
    from ..models.reference_index import IndexedReference
    contigs = dict(faio.read_fasta(args.contigs))
    references = {}
    for spec in args.references:
        name, path = spec.split(":", 1)
        references[name] = IndexedReference(dict(faio.read_fasta(path)))
    stats: dict = {}
    out = align_contigs(contigs, references, band=args.band, stats=stats)
    with _out_stream(args.out) as f:
        f.write("#contig\treference\tchrom\tstart\tend\tstrand\tscore"
                "\tmapq\tnm\tcigar\n")
        for qn in out:
            for a in out[qn]:
                f.write("\t".join([
                    qn, getattr(a, "reference", "?"), a.contig,
                    str(a.start), str(a.end), "-" if a.negative else "+",
                    f"{a.score:g}", str(a.mapq), str(a.nm), a.cigar,
                ]) + "\n")
    print(_json.dumps({"contigs": len(contigs),
                       "aligned": sum(1 for q in out if out[q]), **stats}),
          file=_sys.stderr)


def cmd_filter_calls(args):
    """The manuscript's FDR protocol over a Call VCF (the reference ships
    FilterCalls as an empty stub, FilterCalls.java:10-21; the rule lives in
    the manuscript Methods — see caller/filter.py)."""
    import json as _json
    import sys as _sys
    from ..caller.filter import filter_calls
    from ..caller.variants import read_vcf, write_vcf
    variants, seq_dict = read_vcf(args.vcf)
    references = {}
    for spec in (args.references or []):
        name, path = spec.split(":", 1)
        from ..models.reference_index import IndexedReference
        from ..io import fasta as faio
        references[name] = IndexedReference(dict(faio.read_fasta(path)))
    kept, rejected = filter_calls(
        variants, min_novel_kmers=args.min_novel_kmers,
        require_nahr_multibreakend=not args.no_nahr_rule,
        min_novel_coverage=args.min_novel_coverage,
        references=references or None)
    write_vcf(args.out, kept, seq_dict)
    print(_json.dumps({"input_calls": len(variants), "kept": len(kept),
                       "rejected": len(rejected),
                       "min_novel_kmers": args.min_novel_kmers}),
          file=_sys.stderr)


def cmd_coverage(args):
    from . import extra
    from ..io import fasta as faio
    g = gr.CortexGraph.load(args.graph)
    contigs = faio.read_fasta_full_headers(args.contigs)
    with _out_stream(args.out) as f:
        f.write("contig\tkmer\tindex\tcoverage\n")
        for row in extra.coverage_table(g, contigs, args.sample):
            f.write("\t".join(str(x) for x in row) + "\n")


def cmd_sim_to_vcf(args):
    from . import extra
    from ..caller.variants import write_vcf
    from ..io import table as tblio
    from ..models.reference_index import IndexedReference
    rows = list(tblio.TableReader(args.sim))
    backgrounds = {}
    for spec in args.backgrounds:
        name, path = spec.split(":", 1)
        backgrounds[name] = IndexedReference(path)
    variants = extra.sim_to_vcf(rows, backgrounds)
    sd = []
    for ir in backgrounds.values():
        sd.extend((n, len(s)) for n, s in ir.seqs.items())
    write_vcf(args.out, variants, sd)


def cmd_to_gfa1(args):
    from ..io import fasta as faio
    from ..io import gfa as gfaio
    g = gr.CortexGraph.load(args.graph)
    contigs = faio.read_fasta(args.fasta)
    gfaio.write_gfa1(args.out, g, contigs, args.sampleName)


def cmd_vcf_to_kmers(args):
    from .. import evaluation as ev
    from ..io import fasta as faio
    variants = ev.read_vcf(args.vcf)
    ref = faio.read_fasta(args.reference)
    with _out_stream(args.out) as f:
        for row in ev.vcf_to_kmers(variants, ref, args.kmerSize):
            f.write("\t".join(str(x) for x in row) + "\n")


def cmd_evaluate_calls(args):
    from .. import evaluation as ev
    from ..io import fasta as faio
    truth = ev.read_vcf(args.truth)
    calls = ev.read_vcf(args.calls)
    ref = faio.read_fasta(args.reference)
    res = ev.evaluate_calls(truth, calls, ref, args.kmerSize, args.minNovelKmers)
    with _out_stream(args.out) as f:
        f.write(f"num_truth\t{res['num_truth']}\n"
                f"num_calls\t{res['num_calls']}\n"
                f"tp\t{res['tp']}\nfn\t{res['fn']}\nfp\t{res['fp']}\n")
        for vtype, d in sorted(res["by_type"].items()):
            f.write(f"type:{vtype}\ttp={d['tp']}\tfn={d['fn']}\n")


def cmd_trim_partitions(args):
    from .. import evaluation as ev
    from ..io import fasta as faio
    roi = gr.CortexGraph.load(args.rois)
    rois = {roi.kmer_string(i) for i in range(roi.num_records)}
    parts = faio.read_fasta_full_headers(args.partitions)
    with _out_stream(args.out) as f:
        for header, seq in ev.trim_partitions(parts, rois, roi.kmer_size, args.margin):
            f.write(f">{header}\n{seq}\n")


def cmd_count_novels_in_partitions(args):
    from .. import evaluation as ev
    from ..io import fasta as faio
    roi = gr.CortexGraph.load(args.roi)
    rois = {roi.kmer_string(i) for i in range(roi.num_records)}
    parts = faio.read_fasta_full_headers(args.contigs)
    with _out_stream(args.out) as f:
        f.write("partitionName\tpartitionLength\tnovelKmers\n")
        for name, length, novel in ev.count_novel_kmers_in_partitions(
                parts, rois, roi.kmer_size):
            f.write(f"{name}\t{length}\t{novel}\n")


def cmd_compute_inheritance(args):
    from .. import inheritance as inh
    from ..models.reference_index import IndexedReference

    g = gr.CortexGraph.load(args.graph)
    references = {}
    for spec in args.references:
        name, path = spec.split(":", 1)
        references[name] = IndexedReference(path)
    parents = {}
    for spec in args.parent:
        name, sample = spec.split(":", 1)
        parents[name] = sample
    rows = inh.compute_inheritance(g, references, parents, args.child, args.ref)
    with _out_stream(args.out) as f:
        if rows:
            cols = list(rows[0].keys())
            f.write("\t".join(cols) + "\n")
            for row in rows:
                f.write("\t".join(str(row.get(c, "")) for c in cols) + "\n")


def cmd_simulate(args):
    from .. import simulate as sim
    from ..io import fasta as faio
    from ..caller.variants import write_vcf

    ref1 = faio.read_fasta(args.ref1)
    ref2 = faio.read_fasta(args.ref2)
    res = sim.simulate_haploid_child(
        ref1, ref2, parents=args.parents, mu=args.mu,
        num_variants=args.numVariants, k=args.kmerSize, seed=args.seed)
    faio.write_fasta(args.out, res["child"])
    sim.write_tables(res, args.variantsOut, args.kmersOut)
    sd = [(n, len(s)) for n, s in list(ref1.items()) + list(ref2.items())]
    write_vcf(args.truthOut, res["truth_vcf"], sd)


def cmd_call(args):
    from ..caller.call import Caller
    from ..io import fasta as faio
    from ..models.reference_index import IndexedReference

    g = gr.CortexGraph.load(args.graph)
    rois = gr.CortexGraph.load(args.rois)
    partitions = faio.read_fasta_full_headers(args.partitions)
    references = {}
    for spec in (args.references or []):
        name, path = spec.split(":", 1)
        references[name] = IndexedReference(path)
    caller = Caller(
        g, rois, partitions, backgrounds=args.backgrounds,
        references=references, links=_load_links(args.links),
        partition_names=args.partitionName,
        del_=args.del_, eps=args.eps, rho=args.rho, term=args.term,
        window=args.window, split_distance=args.distance,
        logger=lambda *a: print(*a, file=sys.stderr),
    )
    caller.write_outputs(args.out, args.accountingOut)


class _out_stream:
    def __init__(self, path):
        self.path = path

    def __enter__(self):
        self.f = sys.stdout if self.path in (None, "-") else open(self.path, "w")
        return self.f

    def __exit__(self, *a):
        if self.f is not sys.stdout:
            self.f.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="corticall_tpu",
                                description="Accelerator-native Corticall")
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, fn, **kwargs):
        sp = sub.add_parser(name, **kwargs)
        sp.set_defaults(fn=fn)
        return sp

    sp = add("Join", cmd_join, help="merge graphs into a multi-color graph")
    sp.add_argument("--graph", "-g", action="append", required=True)
    sp.add_argument("--out", "-o", required=True)

    sp = add("Remove", cmd_remove, help="subtract secondary graphs' kmers")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--secondary", "-s", action="append", required=True)
    sp.add_argument("--out", "-o", required=True)

    sp = add("FindROIs", cmd_find_rois, help="find candidate de novo kmers")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--parents", "-p", action="append", required=True)
    sp.add_argument("--child", "-c", required=True)
    sp.add_argument("--out", "-o", required=True)

    for name, fn, extra in (
        ("FindLowCoverage", cmd_find_low_coverage, "mincov"),
        ("FindDust", cmd_find_dust, "gp"),
        ("FindLowComplexity", cmd_find_low_complexity, "thresh"),
        ("FindShared", cmd_find_shared, "ignore"),
        ("FindTips", cmd_find_tips, "links"),
        ("FindOrphans", cmd_find_orphans, "gp"),
    ):
        sp = add(name, fn, help=f"prefilter: {name}")
        sp.add_argument("--roi", "-r", required=True)
        sp.add_argument("--out", "-o", required=True)
        if name != "FindLowCoverage":
            sp.add_argument("--graph", "-g", required=True)
            sp.add_argument("--parents", "-p", action="append", required=True)
        if extra == "mincov":
            sp.add_argument("--minCoverage", "-m", type=int, default=10)
        if extra == "thresh":
            sp.add_argument("--crThreshold", "-t", type=float, default=0.70)
        if extra == "ignore":
            sp.add_argument("--ignore", "-i", action="append")
        if extra == "links":
            sp.add_argument("--links", "-l", action="append")

    sp = add("Partition", cmd_partition, help="group novel kmers into contigs")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--roi", "-r", required=True)
    sp.add_argument("--links", "-l", action="append")
    sp.add_argument("--linkNovels", "-ln", action="store_true")
    sp.add_argument("--out", "-o", default="-")

    sp = add("View", cmd_view, help="print graph records")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--record", "-r", action="append")
    sp.add_argument("--headerOnly", "-H", action="store_true")
    sp.add_argument("--out", "-o", default="-")

    sp = add("Head", cmd_head, help="first n records")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("-n", type=int, default=10)
    sp.add_argument("--out", "-o", default="-")

    sp = add("Tail", cmd_tail, help="last n records")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("-n", type=int, default=10)
    sp.add_argument("--out", "-o", default="-")

    sp = add("CovStats", cmd_covstats, help="coverage statistics per color")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("Sort", cmd_sort, help="sort records by canonical kmer")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--out", "-o", required=True)

    sp = add("IndexLinks", cmd_index_links,
             help="convert .ctp.gz to bgzip + binary index")
    sp.add_argument("--links", "-l", required=True)
    sp.add_argument("--source", "-s", required=True)
    sp.add_argument("--out", "-o")

    sp = add("IndexReference", cmd_index_reference,
             help="write the .sources sidecar for a reference FASTA")
    sp.add_argument("--reference", "-r", required=True)
    sp.add_argument("--source", "-s", action="append")

    sp = add("FindUnanchored", cmd_find_unanchored,
             help="prefilter: novel chains unplaceable on any draft")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--roi", "-r", required=True)
    sp.add_argument("--parents", "-p", action="append", required=True)
    sp.add_argument("--drafts", "-d", action="append", required=True,
                    help="name:fasta pairs")
    sp.add_argument("--links", "-l", action="append")
    sp.add_argument("--out", "-o", required=True)

    sp = add("FindContamination", cmd_find_contamination,
             help="prefilter: contaminant chains")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--roi", "-r", required=True)
    sp.add_argument("--parents", "-p", action="append", required=True)
    sp.add_argument("--contamination", "-contam", required=True)
    sp.add_argument("--drafts", "-d", action="append", required=True)
    sp.add_argument("--links", "-l", action="append")
    sp.add_argument("--out", "-o", required=True)

    sp = add("Build", cmd_build, help="build a graph from reads (mccortex build)")
    sp.add_argument("--reads", "-1", action="append", required=True)
    sp.add_argument("--kmerSize", "-k", type=int, required=True)
    sp.add_argument("--sample", "-s", required=True)
    sp.add_argument("--out", "-o", required=True)

    sp = add("Clean", cmd_clean, help="coverage/tip cleaning (mccortex clean)")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--minCoverage", "-m", type=int, default=2)
    sp.add_argument("--out", "-o", required=True)

    sp = add("InferEdges", cmd_infer_edges, help="add edges between adjacent kmers")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--out", "-o", required=True)

    sp = add("Thread", cmd_thread, help="thread reads into link annotations")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--reads", "-1", action="append", required=True)
    sp.add_argument("--sample", "-s")
    sp.add_argument("--out", "-o", required=True)

    sp = add("AnnotateCalls", cmd_annotate_calls,
             help="annotate calls with regions/genes/repeats/partition stats")
    sp.add_argument("--vcf", "-v", required=True)
    sp.add_argument("--accessory", "-a", help="BED of accessory regions")
    sp.add_argument("--genes", "-gff", action="append")
    sp.add_argument("--repeatmasks", "-rm", action="append")
    sp.add_argument("--partitions", "-p", required=True)
    sp.add_argument("--rois", "-r", required=True)
    sp.add_argument("--out", "-o", required=True)

    sp = add("VisualCortex", cmd_visual_cortex,
             help="start the graph visualizer HTTP server")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--rois", "-r", default=None)
    sp.add_argument("--port", "-p", type=int, default=0)
    sp.add_argument("--seed", "-s", default=None,
                    help="print this kmer's neighborhood JSON at startup")
    sp.add_argument("--radius", type=int, default=25)
    sp.add_argument("--once", action="store_true",
                    help="exit after printing the seed neighborhood")

    sp = add("SendToVisualizer", cmd_send_to_visualizer,
             help="POST a seed neighborhood to a running visualizer")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--seed", "-s", required=True)
    sp.add_argument("--port", "-p", type=int, required=True)
    sp.add_argument("--radius", type=int, default=25)

    sp = add("Explore", cmd_explore,
             help="DFS walk between two kmers in one sample's color")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--links", "-l", action="append")
    sp.add_argument("--sample", "-s", required=True)
    sp.add_argument("--begin", "-b", required=True)
    sp.add_argument("--end", "-e", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("SimulateRecombBetweenVars", cmd_simulate_recomb_between_vars,
             help="manuscript helper (the reference ships this command with "
                  "an empty execute(); commands/paper/"
                  "SimulateRecombBetweenVars.java:12-15 — surface parity)")
    sp.add_argument("--out", "-o", default="-")

    sp = add("ShowNovelKmers", cmd_show_novel_kmers,
             help="per-contig-kmer novelty/record listing")
    sp.add_argument("--contigs", "-c", required=True)
    sp.add_argument("--rois", "-r", required=True)
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("CompileFeatureTable", cmd_compile_feature_table,
             help="per-novel-kmer feature table for FDR modelling")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--rois", "-r", required=True)
    sp.add_argument("--feature", "-f", action="append", help="name:ctx pairs")
    sp.add_argument("--contigs", "-c", required=True)
    sp.add_argument("--roisTruth", "-rt", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("EvaluateROIs", cmd_evaluate_rois,
             help="found-vs-simulated novel kmer concordance")
    sp.add_argument("--rois", "-r", required=True)
    sp.add_argument("--kmerTable", "-k", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("InheritanceToMatrix", cmd_inheritance_to_matrix,
             help="inheritance table -> site x child matrix")
    sp.add_argument("--table", "-t", required=True)
    sp.add_argument("--child", "-c", action="append", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("InheritanceToCircosTracks", cmd_inheritance_to_circos,
             help="inheritance table -> per-child circos tracks")
    sp.add_argument("--table", "-t", required=True)
    sp.add_argument("--child", "-c", action="append", required=True)
    sp.add_argument("--outPrefix", "-o", required=True)

    sp = add("VCFToInheritanceTrack", cmd_vcf_to_inheritance_track,
             help="VCF -> inheritance track lines")
    sp.add_argument("--vcf", "-v", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("IndexBam", cmd_index_bam, help="build a kmer->read index for a BAM")
    sp.add_argument("--bam", "-b", required=True)
    sp.add_argument("--kmerSize", "-k", type=int, required=True)

    sp = add("QueryIndex", cmd_query_index, help="fetch reads containing a kmer")
    sp.add_argument("--bam", "-b", required=True)
    sp.add_argument("--kmerSize", "-k", type=int, required=True)
    sp.add_argument("--kmer", "-s", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("PrintIndex", cmd_print_index, help="dump a kmer index")
    sp.add_argument("--bam", "-b", required=True)
    sp.add_argument("--kmerSize", "-k", type=int, required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("CollectReads", cmd_collect_reads,
             help="collect reads containing ROI kmers")
    sp.add_argument("--bam", "-b", required=True)
    sp.add_argument("--roi", "-r", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("ComputeAssemblyQuality", cmd_assembly_quality,
             help="Phred-style assembly quality vs a truth graph")
    sp.add_argument("--eval", "-e", required=True)
    sp.add_argument("--comp", "-c", required=True)
    sp.add_argument("--evalRef", "-r", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("Range", cmd_range, help="print a record index range")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--start", "-s", type=int, default=0)
    sp.add_argument("--end", "-e", type=int, default=0)
    sp.add_argument("--out", "-o", default="-")

    sp = add("RecoverExcludedKmers", cmd_recover_excluded,
             help="re-admit cleaned-away child kmers present in the dirty graph")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--dirty", "-d", required=True)
    sp.add_argument("--out", "-o", required=True)

    sp = add("CompareROIs", cmd_compare_rois, help="truth/eval ROI Venn")
    sp.add_argument("--truth", "-t", required=True)
    sp.add_argument("--eval", "-e", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("CombineContigs", cmd_combine_contigs,
             help="extend contigs with best-overlap partitions")
    sp.add_argument("--contigs", "-c", required=True)
    sp.add_argument("--partitions", "-p", required=True)
    sp.add_argument("--roi", "-r", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("FilterPartitions", cmd_filter_partitions,
             help="drop weakly-supported partitions")
    sp.add_argument("--contigs", "-c", required=True)
    sp.add_argument("--roi", "-r", required=True)
    sp.add_argument("--novel_kmer_threshold", "-nt", type=int, default=5)
    sp.add_argument("--out", "-o", default="-")

    sp = add("AlignContigs", cmd_align_contigs,
             help="whole-contig alignment to drafts (lastz replacement)")
    sp.add_argument("--contigs", "-c", required=True)
    sp.add_argument("--references", "-R", action="append", required=True,
                    help="name:fasta drafts")
    sp.add_argument("--band", "-B", type=int, default=512)
    sp.add_argument("--out", "-o", default="-")

    sp = add("FilterCalls", cmd_filter_calls,
             help="manuscript FDR filter: reject events with <N novel kmers")
    sp.add_argument("--vcf", "-v", required=True)
    sp.add_argument("--min_novel_kmers", "-m", type=int, default=5)
    sp.add_argument("--min_novel_coverage", "-mc", type=int, default=0,
                    help="reject events whose median novel-kmer coverage "
                         "is below this (0 = off; depth-relative noise "
                         "guard, see caller/filter.py)")
    sp.add_argument("--no_nahr_rule", action="store_true",
                    help="keep lone breakend pairs (skip the multi-breakend "
                          "NAHR requirement)")
    sp.add_argument("--references", "-R", action="append",
                    help="name:fasta parental drafts; calls whose variant "
                         "haplotype occurs exactly in a draft are rejected "
                         "as inherited (parent-graph coverage dropouts)")
    sp.add_argument("--out", "-o", required=True)

    sp = add("Coverage", cmd_coverage, help="per-kmer coverage along contigs")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--contigs", "-c", required=True)
    sp.add_argument("--sample", "-s", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("SimToVCF", cmd_sim_to_vcf, help="simulation truth table -> VCF")
    sp.add_argument("--sim", "-s", required=True)
    sp.add_argument("--backgrounds", "-b", action="append", required=True,
                    help="name:fasta pairs")
    sp.add_argument("--out", "-o", required=True)

    sp = add("ToGfa1", cmd_to_gfa1, help="export contigs + overlaps as GFA1")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--fasta", "-f", required=True)
    sp.add_argument("--sampleName", "-s")
    sp.add_argument("--out", "-o", required=True)

    sp = add("VCFToKmers", cmd_vcf_to_kmers, help="emit alt-haplotype kmers per variant")
    sp.add_argument("--vcf", "-v", required=True)
    sp.add_argument("--reference", "-R", required=True)
    sp.add_argument("--kmerSize", "-k", type=int, default=63)
    sp.add_argument("--out", "-o", default="-")

    sp = add("EvaluateCalls", cmd_evaluate_calls,
             help="kmer-Venn concordance of calls vs truth VCF")
    sp.add_argument("--truth", "-t", required=True)
    sp.add_argument("--calls", "-c", required=True)
    sp.add_argument("--reference", "-R", required=True)
    sp.add_argument("--kmerSize", "-k", type=int, default=47)
    sp.add_argument("--minNovelKmers", "-m", type=int, default=1)
    sp.add_argument("--out", "-o", default="-")

    sp = add("TrimPartitions", cmd_trim_partitions,
             help="crop partitions to novel span +- margin")
    sp.add_argument("--partitions", "-p", required=True)
    sp.add_argument("--rois", "-r", required=True)
    sp.add_argument("--margin", "-m", type=int, default=500)
    sp.add_argument("--out", "-o", default="-")

    sp = add("CountNovelKmersInPartitions", cmd_count_novels_in_partitions,
             help="novel kmers per partition contig")
    sp.add_argument("--contigs", "-c", required=True)
    sp.add_argument("--roi", "-r", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("ComputeInheritance", cmd_compute_inheritance,
             help="paint per-child parental-allele inheritance")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--references", "-r", action="append", required=True,
                    help="name:fasta pairs")
    sp.add_argument("--parent", "-p", action="append", required=True,
                    help="refName:sampleName pairs")
    sp.add_argument("--child", "-c", action="append", required=True)
    sp.add_argument("--ref", "-rn", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = add("SimulateHaploidChild", cmd_simulate,
             help="simulate a recombinant child with de novo variants")
    sp.add_argument("--parents", "-p", nargs=2, default=["parent1", "parent2"])
    sp.add_argument("--ref1", "-r1", required=True)
    sp.add_argument("--ref2", "-r2", required=True)
    sp.add_argument("--mu", "-m", type=float, default=2.0)
    sp.add_argument("--seed", "-s", type=int, default=0)
    sp.add_argument("--numVariants", "-v", type=int, default=3)
    sp.add_argument("--kmerSize", "-k", type=int, default=47)
    sp.add_argument("--out", "-o", required=True)
    sp.add_argument("--variantsOut", "-vo", required=True)
    sp.add_argument("--kmersOut", "-ko", required=True)
    sp.add_argument("--truthOut", "-to", required=True)

    sp = add("Call", cmd_call, help="call DNMs in a pedigree graph")
    sp.add_argument("--graph", "-g", required=True)
    sp.add_argument("--rois", "-r", required=True)
    sp.add_argument("--partitions", "-p", required=True)
    sp.add_argument("--backgrounds", "-b", action="append", required=True)
    sp.add_argument("--references", "-R", action="append",
                    help="name:fasta pairs")
    sp.add_argument("--links", "-l", action="append")
    sp.add_argument("--partitionName", "-pn", action="append")
    sp.add_argument("--del", dest="del_", type=float, default=0.35)
    sp.add_argument("--eps", type=float, default=0.90)
    sp.add_argument("--rho", type=float, default=6e-4)
    sp.add_argument("--term", type=float, default=0.001)
    sp.add_argument("--window", "-w", type=int, default=200)
    sp.add_argument("--distance", "-d", type=int, default=2000)
    sp.add_argument("--disableInversions", "-noinv", action="store_true")
    sp.add_argument("--out", "-o", required=True)
    sp.add_argument("--accountingOut", "-ao", required=True)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    except (ValueError, FileNotFoundError) as e:
        # user-input errors: one clear line, no traceback (Module.java-style)
        print(f"error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # output piped into head/less and closed early — not an error
        import os
        try:
            sys.stdout.close()
        except Exception:
            pass
        os._exit(0)
    return 0
