"""Weak-scaling sweep of the sharded walk engine on a virtual CPU mesh.

Per-device problem size is held fixed (genome bases and walk batch scale
with the device count) while the mesh grows 1 -> 8, so perfect scaling is
flat steps/s/device.  Runs each point in a fresh subprocess with
xla_force_host_platform_device_count=n.  Writes SCALING_r{N}.json.

Caveat recorded in the artifact: virtual CPU devices share one socket, so
collective cost is memcpy, not ICI; the sweep validates sharding overheads
(routing, all_to_all buffers, per-shard tables), not interconnect roofline.

Usage: python tools/weak_scaling.py [out.json]
"""

import json
import os
import subprocess
import sys

_CHILD = r"""
import json, os, sys, time
import numpy as np
n = int(sys.argv[1])
sys.path.insert(0, sys.argv[2])
# XLA_FLAGS comes from the parent env; the platform is pinned to the CPU via
# config (backends initialize lazily)
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax.sharding import Mesh
from corticall_tpu import fixtures, kmer as km
from corticall_tpu.parallel import mesh as pm

K = 31
BASES_PER_DEV = 200_000
BATCH_PER_DEV = 4096
STEPS = 256

rng = np.random.default_rng(42)
genome = "".join(rng.choice(list("ACGT"), BASES_PER_DEV * n))
g = fixtures.build_graph({"kid": [genome]}, K)
sg = pm.ShardedGraph.from_graph(g, n)
mesh = Mesh(np.array(jax.devices()[:n]), (pm.AXIS,))
run = pm.make_sharded_walk_run(mesh, sg, [0], K, STEPS)

b = BATCH_PER_DEV * n
starts = rng.integers(0, len(genome) - K, size=b)
seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(
    [genome[i:i + K] for i in starts]), K))
active = jnp.ones(b, bool)

bases, cycled, steps = run(seeds, active)          # compile
int(np.asarray(steps).sum())
iters = 3
t0 = time.perf_counter()
tot = 0
for _ in range(iters):
    bases, cycled, steps = run(seeds, active)
    tot += int(np.asarray(steps).sum())
dt = time.perf_counter() - t0
print(json.dumps({
    "devices": n, "records": g.num_records, "batch": b,
    "steps_per_s": round(tot / dt),
    "steps_per_s_per_device": round(tot / dt / n)}))
"""


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "SCALING_r03.json"
    rows = []
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for n in (1, 2, 4, 8):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + f" --xla_force_host_platform_device_count={n}")
        r = subprocess.run([sys.executable, "-c", _CHILD, str(n), root],
                           capture_output=True, text=True, cwd=root, env=env)
        line = [l for l in r.stdout.splitlines() if l.startswith("{")]
        if not line:
            print(r.stdout[-2000:], r.stderr[-2000:])
            raise SystemExit(f"point n={n} failed rc={r.returncode}")
        row = json.loads(line[-1])
        rows.append(row)
        print(json.dumps(row), flush=True)
    base = rows[0]["steps_per_s_per_device"]
    for row in rows:
        row["efficiency"] = round(row["steps_per_s_per_device"] / base, 3)
    out = {
        "metric": "sharded_walk_weak_scaling",
        "mesh": "virtual CPU devices (one host; collectives are memcpy, "
                "not ICI — validates sharding overheads, not interconnect). "
                "CAVEAT: all virtual devices share this host's physical "
                "cores (single-device XLA already uses them all), so "
                "per-device throughput is compute-starved ~n/cores x before "
                "any sharding overhead; treat rows as a correctness+overhead "
                "record, not a scaling projection.  Real projection requires "
                "real chips (the driver dryrun validates the sharded program "
                "compiles+executes; MULTIHOST artifacts validate 2-process "
                "jax.distributed execution).",
        "host_physical_cores": os.cpu_count(),
        "per_device": {"bases": 200_000, "batch": 4096, "steps": 256},
        "rows": rows,
    }
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"wrote": out_path,
                      "efficiency_at_8": rows[-1]["efficiency"]}))


if __name__ == "__main__":
    main()
