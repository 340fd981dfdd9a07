"""Coverage-robustness sweep: run the reads-mode
pipeline at 10/15/20/30x on the 0.6 Mbp cross and record ROI recall / venn.
Writes SWEEP_r03.json at the repo root."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

rows = []
for cov in (10, 15, 20, 30):
    env = dict(os.environ, PF_MBP="0.6", PF_CHROMS="2", PF_DNMS="8",
               PF_COVERAGE=str(cov), PF_WORKDIR=f"/tmp/pf_sweep_{cov}")
    subprocess.run(["rm", "-rf", f"/tmp/pf_sweep_{cov}"], check=True)
    p = subprocess.run([sys.executable, os.path.join(REPO, "demo_pf_cross.py")],
                       env=env, capture_output=True, text=True, timeout=1800)
    if p.returncode != 0:
        rows.append({"coverage": cov, "error": p.stderr[-500:]})
        continue
    out = json.loads(p.stdout.strip().splitlines()[-1])
    rows.append({
        "coverage": cov,
        "roi_tp": out["roi_tp"], "roi_fn": out["roi_fn"],
        "kmer_venn": out["kmer_venn"],
        "venn_by_type": out["venn_by_type"],
        "fp_after_fdr": out["fp_after_fdr_and_crossover_accounting"],
        "lowcov_threshold": out["prefilter"].get("lowcov_threshold"),
        "calls": out["calls"],
        "total_pipeline_s": out["total_pipeline_s"],
    })
    print(json.dumps(rows[-1]), flush=True)

with open(os.path.join(REPO, "SWEEP_r03.json"), "w") as f:
    json.dump({"config": "0.6 Mbp, 2 chroms, 8 DNMs, k=47, reads+links+prefilters",
               "rows": rows}, f, indent=1)
print("done")
