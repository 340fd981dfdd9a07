"""Batched frontier walk kernel: thousands of contig walks per device step.

The batched device reformulation of the reference's one-vertex-at-a-time cursor
(TraversalEngine.java:241-319, ContigStopper semantics): every walk advances
one de Bruijn step per fused device iteration — canonicalize, hash-probe,
edge-byte decode, single-successor test, shift-append — entirely in uint32
vector lanes, batched over B walks.

Cycle handling: the reference stops when the single successor was already
seen this walk (unbounded host hash set, TraversalEngine.java:262).  A batched
kernel cannot afford per-walk sets, so walks carry O(1) Brent cycle-detection
state; a detected cycle may overshoot by up to one cycle length, and the host
trims the emitted bases back to the first revisit (`trim_walk_bases`), which
reproduces the reference's stopping point exactly.

A backward walk from seed S equals the forward walk from revcomp(S) (the edge
encoding is orientation-symmetric), so one forward kernel serves both
directions; `assemble_batch` composes them into full bidirectional contigs.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import kmer_jax as kj
from . import hashtable as ht
from .walk_np import replay_walk  # noqa: F401 (host-only; re-exported)
from .. import kmer as km


@partial(jax.jit, static_argnames=("k", "max_probe", "num_steps"))
def walk_forward(slots, keys, edges_combined, seeds, k: int, max_probe: int,
                 num_steps: int):
    """Advance B forward walks num_steps de Bruijn steps.

    slots: int32[M]; keys: uint32[N, W]; edges_combined: uint8[N] (OR of the
    traversal colors' edge bytes); seeds: uint32[B, W] walk-orientation kmers.

    Returns (bases int8[num_steps, B] emitted next-base codes (-1 = walk
    ended), cycled bool[B] walks that ended via cycle detection, steps int32[B]
    number of bases emitted per walk).
    """

    def step(state, _):
        cur, active, saved, power, lam = state
        canon, flipped = kj.canonicalize_words(cur, k)
        idx = ht.lookup(slots, keys, canon, max_probe)
        e = jnp.where(idx >= 0, edges_combined[jnp.maximum(idx, 0)], 0).astype(jnp.uint32)
        next_mask = jnp.where(flipped, e >> 4, e & 0xF).astype(jnp.uint32)
        n = kj.popcount4(next_mask)
        base = kj.lowest_set_base(next_mask)
        nxt = kj.shift_append(cur, base.astype(jnp.uint32), k)

        single = (n == 1) & (idx >= 0)
        is_cycle = jnp.all(nxt == saved, axis=-1) & single & active

        advance = active & single & ~is_cycle
        emitted = jnp.where(advance, base, -1).astype(jnp.int8)

        # Brent teleport: when power == lam, move the anchor to the current head
        teleport = (power == lam) & advance
        saved = jnp.where(teleport[:, None], nxt, saved)
        power = jnp.where(teleport, power * 2, power)
        lam = jnp.where(teleport, 0, lam)
        lam = jnp.where(advance, lam + 1, lam)

        cur = jnp.where(advance[:, None], nxt, cur)
        new_active = advance
        return (cur, new_active, saved, power, lam), (emitted, is_cycle)

    b = seeds.shape[0]
    init = (
        seeds,
        jnp.ones(b, dtype=bool),
        seeds,                       # Brent anchor starts at the seed
        jnp.ones(b, dtype=jnp.int32),
        jnp.zeros(b, dtype=jnp.int32),
    )
    (_, active, *_), (bases, cycles) = jax.lax.scan(step, init, None, length=num_steps)
    cycled = jnp.any(cycles, axis=0)
    steps = (bases >= 0).sum(axis=0).astype(jnp.int32)
    return bases, cycled, steps


@partial(jax.jit, static_argnames=("k", "max_probe", "num_steps", "probes_per_round"))
def walk_forward_fused(walk_entries, seeds, k: int, max_probe: int,
                       num_steps: int, probes_per_round: int = 4):
    """walk_forward with the edge byte fused into the hash entry
    (HashTable.build_walk_entries): one gather per probe, none after —
    the minimal-memory-traffic formulation of the de Bruijn step."""
    m = walk_entries.shape[0]
    w = seeds.shape[1]
    mask = jnp.uint32(m - 1)
    rounds = (max_probe + probes_per_round - 1) // probes_per_round

    def lookup_edges(canon):
        h = kj.hash_words(canon) & mask
        zero = (h & jnp.uint32(0)).astype(jnp.uint32)
        payload = zero          # 0 = miss
        resolved = zero > 0

        def body(state):
            r, payload, resolved = state
            base = h + (r * probes_per_round).astype(jnp.uint32)
            for p in range(probes_per_round):
                slot = ((base + np.uint32(p)) & mask).astype(jnp.int32)
                e = walk_entries[slot]
                tag = e[:, w]
                match = (tag >= jnp.uint32(0x80000000)) & jnp.all(
                    e[:, :w] == canon, axis=-1)
                empty = tag == 0
                payload = jnp.where(~resolved & match,
                                    tag & jnp.uint32(0x7FFFFFFF), payload)
                resolved = resolved | match | empty
            return r + 1, payload, resolved

        def cond(state):
            r, _, resolved = state
            return (r < rounds) & ~jnp.all(resolved)

        _, payload, resolved = jax.lax.while_loop(
            cond, body, (jnp.int32(0), payload, resolved))
        return payload, resolved

    def step(state, _):
        cur, active, saved, power, lam = state
        canon, flipped = kj.canonicalize_words(cur, k)
        e, _ = lookup_edges(canon)  # payload 0 = miss or edgeless; both end the walk
        next_mask = jnp.where(flipped, e >> 4, e & 0xF).astype(jnp.uint32)
        n = kj.popcount4(next_mask)
        base = kj.lowest_set_base(next_mask)
        nxt = kj.shift_append(cur, base.astype(jnp.uint32), k)

        single = n == 1
        is_cycle = jnp.all(nxt == saved, axis=-1) & single & active
        advance = active & single & ~is_cycle
        emitted = jnp.where(advance, base, -1).astype(jnp.int8)

        teleport = (power == lam) & advance
        saved = jnp.where(teleport[:, None], nxt, saved)
        power = jnp.where(teleport, power * 2, power)
        lam = jnp.where(teleport, 0, lam)
        lam = jnp.where(advance, lam + 1, lam)

        cur = jnp.where(advance[:, None], nxt, cur)
        return (cur, advance, saved, power, lam), (emitted, is_cycle)

    b = seeds.shape[0]
    init = (seeds, jnp.ones(b, dtype=bool), seeds,
            jnp.ones(b, dtype=jnp.int32), jnp.zeros(b, dtype=jnp.int32))
    (_, active, *_), (bases, cycles) = jax.lax.scan(step, init, None, length=num_steps)
    cycled = jnp.any(cycles, axis=0)
    steps = (bases >= 0).sum(axis=0).astype(jnp.int32)
    return bases, cycled, steps


def assemble_batch(dg, colors, seeds: list[str], num_steps: int = 1024) -> list[str]:
    """Bidirectional contig per seed (ContigStopper semantics, no links):
    the device analog of TraversalEngine.assemble (TraversalEngine.java:112-145).
    Uses the primary-biased narrow-bucket cuckoo table + speculative
    single-row-per-step walk kernel (ops/cuckoo.py walk_forward_spec), the
    fastest lookup backend; emitted walks decode bit-identically to
    walk_forward/_fused (replay_walk skips the interleaved -1 stall slots).
    """
    from . import cuckoo as ck
    k = dg.kmer_size
    buckets = dg.walk_buckets(colors)
    fwd_seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(seeds), k))
    rc_strings = [km.revcomp(s) for s in seeds]
    rev_seeds = jnp.asarray(km.pack_codes(km.strings_to_codes(rc_strings), k))

    fb, fc, _ = ck.walk_forward_spec_chunked(buckets, fwd_seeds, k, num_steps)
    rb, rc_, _ = ck.walk_forward_spec_chunked(buckets, rev_seeds, k, num_steps)
    fb = fb.T  # [B, T]
    rb = rb.T
    rc_c = rc_

    out = []
    for i, seed in enumerate(seeds):
        fwd_ext = replay_walk(seed, fb[i], bool(fc[i]), num_steps)
        back_ext = replay_walk(rc_strings[i], rb[i], bool(rc_c[i]), num_steps)
        prefix = km.revcomp(back_ext) if back_ext else ""
        out.append(prefix + seed + fwd_ext)
    return out
