"""Open-addressing k-mer hash table: vectorized host build, device lookup.

Replaces the reference's per-kmer binary search over the mmap'd record section
(CortexGraph.java:272-317, the #1 hot loop) with O(1) expected-probe gathers:

- build (numpy): linear-probe insertion of all N canonical kmers at once,
  batched rounds — each round claims free slots for every still-unplaced kmer
  in parallel; losers re-probe.  Load factor 0.7, power-of-two table.
- lookup (jax): vectorized probe loop — per query a gather of the slot's
  record index and key words, compare, advance; bounded by the true max probe
  length measured at build time, so the fori_loop trip count is exact.

The same uint32 hash (kmer_jax.hash_words) is computed identically in numpy
here and in jax on device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import kmer_jax as kj


def _np_mix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def np_hash_words(words: np.ndarray) -> np.ndarray:
    """numpy twin of kmer_jax.hash_words (bit-identical)."""
    h = np.full(words.shape[:-1], 0x811C9DC5, dtype=np.uint32)
    for i in range(words.shape[-1]):
        h = _np_mix32(h ^ words[..., i].astype(np.uint32)) * np.uint32(0x01000193)
    return _np_mix32(h)


@dataclass
class HashTable:
    """slots: int32[M] record index or -1; keys are the graph's kmers array.

    entries: uint32[M, W+1] interleaved (key words..., record index + 1) with
    0 in the last lane marking an empty slot — lets the device probe with a
    single gather per slot instead of two dependent ones (slot -> key)."""
    slots: np.ndarray
    max_probe: int
    table_bits: int
    entries: np.ndarray | None = None

    @property
    def size(self) -> int:
        return self.slots.shape[0]

    def build_entries(self, kmers: np.ndarray) -> np.ndarray:
        m = self.slots.shape[0]
        w = kmers.shape[1]
        entries = np.zeros((m, w + 1), dtype=np.uint32)
        occ = self.slots >= 0
        idx = self.slots[occ]
        entries[occ, :w] = kmers[idx]
        entries[occ, w] = idx.astype(np.uint32) + 1
        self.entries = entries
        return entries

    def build_walk_entries(self, kmers: np.ndarray, payload: np.ndarray) -> np.ndarray:
        """Entries carrying an arbitrary uint8/uint32 payload (e.g. the
        combined edge byte) instead of the record index: last lane =
        0x80000000 | payload for occupied slots, 0 for empty.  A walk step
        then needs exactly ONE gather per probe and none afterwards."""
        m = self.slots.shape[0]
        w = kmers.shape[1]
        entries = np.zeros((m, w + 1), dtype=np.uint32)
        occ = self.slots >= 0
        idx = self.slots[occ]
        entries[occ, :w] = kmers[idx]
        entries[occ, w] = np.uint32(0x80000000) | payload[idx].astype(np.uint32)
        return entries


def build(kmers: np.ndarray, load_factor: float = 0.7,
          table_size: int | None = None) -> HashTable:
    """kmers: uint32[N, W] canonical packed kmers (unique).

    table_size, if given, must be a power of two > N (used to build shard
    tables at a common size)."""
    n = kmers.shape[0]
    if table_size is not None:
        m = table_size
        assert m & (m - 1) == 0 and m > n
    else:
        m = 16
        while m * load_factor < max(n, 1):
            m *= 2
    mask = np.uint32(m - 1)

    slots = np.full(m, -1, dtype=np.int32)
    h = np_hash_words(kmers) & mask
    pending = np.arange(n, dtype=np.int64)
    cur = h.astype(np.uint32)
    probe = 0
    while pending.size:
        s = cur[pending]
        free = slots[s] == -1
        # first pending kmer targeting each free slot wins this round
        order = np.argsort(s, kind="stable")
        s_sorted = s[order]
        first_of_slot = np.ones(len(s_sorted), dtype=bool)
        first_of_slot[1:] = s_sorted[1:] != s_sorted[:-1]
        winner_sorted = first_of_slot & free[order]
        winner = np.zeros(len(s), dtype=bool)
        winner[order] = winner_sorted
        slots[s[winner]] = pending[winner].astype(np.int32)
        pending = pending[~winner]
        cur[pending] = (cur[pending] + np.uint32(1)) & mask
        probe += 1
        if probe > m:
            raise RuntimeError("hash table build failed to converge")
    return HashTable(slots=slots, max_probe=max(probe, 1), table_bits=int(m).bit_length() - 1)


@partial(jax.jit, static_argnames=("max_probe",))
def lookup(slots: jnp.ndarray, keys: jnp.ndarray, queries: jnp.ndarray,
           max_probe: int) -> jnp.ndarray:
    """Device lookup.  slots: int32[M]; keys: uint32[N, W] (canonical kmers, in
    record order); queries: uint32[B, W] canonical kmers.  -> int32[B] record
    indices (-1 miss)."""
    m = slots.shape[0]
    mask = jnp.uint32(m - 1)
    h = kj.hash_words(queries) & mask

    # derive the carry from the queries so its sharding/varying-axis type is
    # stable under shard_map (a literal jnp.full would be axis-invariant and
    # mismatch the loop body's output type)
    zero = (h & jnp.uint32(0)).astype(jnp.int32)
    found = zero - 1
    resolved = zero > 0

    def body(state):
        p, found, resolved = state
        slot = (h + p.astype(jnp.uint32)) & mask
        idx = slots[slot.astype(jnp.int32)]
        key = keys[jnp.maximum(idx, 0)]
        match = (idx >= 0) & jnp.all(key == queries, axis=-1)
        empty = idx < 0
        found = jnp.where(~resolved & match, idx, found)
        resolved = resolved | match | empty
        return p + 1, found, resolved

    def cond(state):
        p, _, resolved = state
        return (p < max_probe) & ~jnp.all(resolved)

    _, found, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), found, resolved))
    return found


@partial(jax.jit, static_argnames=("max_probe", "probes_per_round"))
def lookup_fused(entries: jnp.ndarray, queries: jnp.ndarray, max_probe: int,
                 probes_per_round: int = 4) -> jnp.ndarray:
    """Single-gather probing over interleaved (key, idx+1) entries.

    entries: uint32[M, W+1] (HashTable.build_entries); queries: uint32[B, W]
    canonical kmers -> int32[B] record indices (-1 miss).  Each round gathers
    `probes_per_round` consecutive slots at once, shortening the dependent-
    gather chain that dominates probe latency.
    """
    m = entries.shape[0]
    w = queries.shape[1]
    mask = jnp.uint32(m - 1)
    h = kj.hash_words(queries) & mask

    zero = (h & jnp.uint32(0)).astype(jnp.int32)
    found = zero - 1
    resolved = zero > 0
    rounds = (max_probe + probes_per_round - 1) // probes_per_round

    def body(state):
        r, found, resolved = state
        base = h + (r * probes_per_round).astype(jnp.uint32)
        for p in range(probes_per_round):
            slot = ((base + np.uint32(p)) & mask).astype(jnp.int32)
            e = entries[slot]                       # [B, W+1] one gather
            idx = e[:, w].astype(jnp.int32) - 1
            match = (idx >= 0) & jnp.all(e[:, :w] == queries, axis=-1)
            empty = idx < 0
            found = jnp.where(~resolved & match, idx, found)
            resolved = resolved | match | empty
        return r + 1, found, resolved

    def cond(state):
        r, _, resolved = state
        return (r < rounds) & ~jnp.all(resolved)

    _, found, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), found, resolved))
    return found
