"""Device-resident graph and the rule that picks device routes.

The device counterpart of graph.CortexGraph: records live in HBM as packed
uint32 kmer words, per-color coverage and edge bytes, plus an open-addressing
slot table for O(1) random access (BASELINE.json north_star: "binary-search
random access replaced by vectorized gather lookups").
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from . import graph as gr
from .ops import hashtable as ht


def gpu_available() -> bool:
    """True when JAX's default backend is a GPU.

    The one device-selection rule: routes left on "auto" (the Caller's
    Tesserae DP, the contig aligner's banded-SW pre-score) run on the device
    exactly when this holds, and keep their host oracles on the CPU.  A
    route chosen here that then fails raises; nothing falls back."""
    return jax.default_backend() == "gpu"


@dataclass
class DeviceGraph:
    kmer_size: int
    num_colors: int
    kmers: jnp.ndarray      # uint32[N, W] canonical, record order
    coverages: jnp.ndarray  # uint32[N, C]
    edges: jnp.ndarray      # uint8[N, C]
    slots: jnp.ndarray      # int32[M] hash slots -> record index
    max_probe: int
    sample_names: tuple = ()
    _walk_tables: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def num_records(self) -> int:
        return self.kmers.shape[0]

    @classmethod
    def from_graph(cls, g: gr.CortexGraph) -> "DeviceGraph":
        table = ht.build(g.kmers)
        return cls(
            kmer_size=g.kmer_size,
            num_colors=g.num_colors,
            kmers=jnp.asarray(g.kmers),
            coverages=jnp.asarray(g.coverages),
            edges=jnp.asarray(g.edges),
            slots=jnp.asarray(table.slots),
            max_probe=table.max_probe,
            sample_names=tuple(g.sample_names),
        )

    @classmethod
    def from_arrays(cls, kmer_size: int, kmers: np.ndarray, coverages: np.ndarray,
                    edges: np.ndarray, sample_names=()) -> "DeviceGraph":
        table = ht.build(kmers)
        return cls(kmer_size, coverages.shape[1], jnp.asarray(kmers),
                   jnp.asarray(coverages), jnp.asarray(edges),
                   jnp.asarray(table.slots), table.max_probe, tuple(sample_names))

    def find_records(self, canon_queries: jnp.ndarray) -> jnp.ndarray:
        """uint32[B, W] canonical kmers -> int32[B] record indices (-1 miss)."""
        return ht.lookup(self.slots, self.kmers, canon_queries, self.max_probe)

    def combined_edges(self, colors) -> jnp.ndarray:
        """OR of per-color edge bytes over a traversal color set -> uint8[N].

        Union-over-colors neighbor semantics (TraversalEngine.java:152-157).
        """
        e = self.edges[:, list(colors)]
        out = e[:, 0]
        for i in range(1, e.shape[1]):
            out = out | e[:, i]
        return out

    def combined_coverage(self, colors) -> jnp.ndarray:
        """uint32[N] total coverage over a color set."""
        return self.coverages[:, list(colors)].sum(axis=1, dtype=jnp.uint32)

    def walk_buckets(self, colors) -> jnp.ndarray:
        """Cuckoo walk table for a traversal color set, cached per color set:
        uint32[NB, 2*(W+1)] primary-biased bucket rows with the combined edge
        byte fused into each entry's tag (ops/cuckoo.py build_walk_table) —
        the one-row-per-step fast path for batched walks (walk_forward_spec)."""
        key = tuple(colors)
        if key not in self._walk_tables:
            from .ops import cuckoo as ck
            edges = np.asarray(self.combined_edges(key))
            ct = ck.build_walk_table(np.asarray(self.kmers), edges)
            self._walk_tables[key] = jnp.asarray(ct.buckets)
        return self._walk_tables[key]
