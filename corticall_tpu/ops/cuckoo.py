"""Bucketized two-choice (cuckoo) k-mer hash table for the walk hot loop.

The linear-probing table (`ops/hashtable.py`) resolves a query in ~1 probe at
load 0.25 but still needs a `while_loop` over probe rounds plus an
all-resolved reduction per round, and each round is a dependent HBM gather.
This table removes the loop entirely: every key lives in one of TWO candidate
buckets of BUCKET_SIZE entries, so a lookup is ONE gather (both bucket rows,
stacked) followed by pure vector compares — a fixed two-row read per query,
no data-dependent control flow.  Build-time eviction (classic bucketized
cuckoo hashing) guarantees placement; at load 0.5 with bucket size 4 the
batched greedy pass places >99.9% of keys and the serial eviction walk
handles the rest.

Replaces the same reference hot loop as hashtable.py: the per-kmer binary
search over the sorted record section (CortexGraph.java:272-317) driven by
TraversalEngine.java:241-279.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import kmer_jax as kj
from .hashtable import np_hash_words, _np_mix32

BUCKET_SIZE = 4
_GOLDEN = 0x9E3779B9


def _np_h2(h: np.ndarray) -> np.ndarray:
    return _np_mix32(h ^ np.uint32(_GOLDEN))


def _jnp_h2(h: jnp.ndarray) -> jnp.ndarray:
    return kj.mix32(h ^ jnp.uint32(_GOLDEN))


@dataclass
class CuckooTable:
    """buckets: uint32[NB, bucket_size*(W+1)] — each row holds bucket_size
    interleaved (key words..., tag) entries; tag = 0x80000000 | payload for
    occupied entries, 0 for empty."""
    buckets: np.ndarray
    nb_bits: int
    words: int
    bucket_size: int = BUCKET_SIZE
    entry_words: int = 0           # W+1 (+P extra words for run tables)
    primary_fraction: float = 0.0  # keys resident in their h1 bucket

    @property
    def num_buckets(self) -> int:
        return self.buckets.shape[0]


def _place(kmers: np.ndarray, load_factor: float,
           num_buckets: int | None, bucket_size: int,
           primary_bias: bool):
    """Cuckoo placement: -> (nb, bucket_of int64[N], pos_of int32[N], h1)."""
    n, w = kmers.shape
    if num_buckets is not None:
        nb = num_buckets
        assert nb & (nb - 1) == 0 and nb * bucket_size >= n
    else:
        nb = 4
        while nb * bucket_size * load_factor < max(n, 1):
            nb *= 2
    mask = np.uint32(nb - 1)

    h = np_hash_words(kmers)
    h1 = (h & mask).astype(np.int64)
    h2 = (_np_h2(h) & mask).astype(np.int64)

    counts = np.zeros(nb, dtype=np.int32)
    bucket_of = np.full(n, -1, dtype=np.int64)
    pos_of = np.full(n, -1, dtype=np.int32)

    pending = np.arange(n, dtype=np.int64)
    while pending.size:
        c1 = counts[h1[pending]]
        c2 = counts[h2[pending]]
        if primary_bias:
            t = np.where(c1 < bucket_size, h1[pending], h2[pending])
        else:
            t = np.where(c2 < c1, h2[pending], h1[pending])
        cap = bucket_size - counts[t]
        # rank pending keys within each proposed bucket; first `cap` win
        order = np.argsort(t, kind="stable")
        ts = t[order]
        first = np.ones(len(ts), dtype=bool)
        first[1:] = ts[1:] != ts[:-1]
        grp_start = np.maximum.accumulate(np.where(first, np.arange(len(ts)), 0))
        rank = np.arange(len(ts)) - grp_start
        win_sorted = rank < cap[order]
        winner = np.zeros(len(t), dtype=bool)
        winner[order] = win_sorted
        if not winner.any():
            break  # both buckets full for every pending key -> evictions
        wk_keys = pending[winner]
        wt = t[winner]
        wr = np.zeros(len(t), dtype=np.int64)
        wr[order] = rank
        bucket_of[wk_keys] = wt
        pos_of[wk_keys] = (counts[wt] + wr[winner]).astype(np.int32)
        np.add.at(counts, wt, 1)
        pending = pending[~winner]

    # serial eviction walk for the stragglers (load 0.5 -> a handful at most);
    # a vectorized (bucket, pos) -> key occupancy array keeps this phase
    # O(stragglers), not O(N)
    if pending.size:
        occ = np.full((nb, bucket_size), -1, dtype=np.int64)
        placed = np.nonzero(bucket_of >= 0)[0]
        occ[bucket_of[placed], pos_of[placed]] = placed
        rng = np.random.default_rng(0)
        for ki in pending:
            key = int(ki)
            b = int(h1[key])
            for _ in range(10000):
                c = int(counts[b])
                if c < bucket_size:
                    occ[b, c] = key
                    bucket_of[key] = b
                    pos_of[key] = c
                    counts[b] += 1
                    break
                vp = int(rng.integers(0, bucket_size))
                victim = int(occ[b, vp])
                occ[b, vp] = key
                bucket_of[key] = b
                pos_of[key] = vp
                key = victim
                b = int(h2[key]) if int(h1[key]) == b else int(h1[key])
            else:
                raise RuntimeError("cuckoo build failed; lower load_factor")

    return nb, bucket_of, pos_of, h1


def build_cuckoo(kmers: np.ndarray, payload: np.ndarray,
                 load_factor: float = 0.5,
                 num_buckets: int | None = None,
                 bucket_size: int = BUCKET_SIZE,
                 primary_bias: bool = False,
                 extra: np.ndarray | None = None) -> CuckooTable:
    """kmers: uint32[N, W] unique canonical kmers; payload: uint[N] (< 2^31),
    e.g. the combined edge byte for walk tables.  num_buckets (power of two)
    fixes the table size — used to build per-shard tables at a common size.

    primary_bias places each key in its h1 bucket whenever it has room (rather
    than the emptier of the two), so that a speculative first-probe lookup
    (walk_forward_spec) hits h1 for the vast majority of keys; the achieved
    fraction is reported in `primary_fraction`.

    extra: uint32[N, P] additional per-entry words stored after the tag
    (entry stride becomes W+1+P) — used by the run table."""
    n, w = kmers.shape
    p = 0 if extra is None else extra.shape[1]
    nb, bucket_of, pos_of, h1 = _place(
        kmers, load_factor, num_buckets, bucket_size, primary_bias)
    ew = w + 1 + p
    buckets = np.zeros((nb, bucket_size * ew), dtype=np.uint32)
    col = pos_of * ew
    rows = bucket_of
    for wi in range(w):
        buckets[rows, col + wi] = kmers[:, wi]
    buckets[rows, col + w] = np.uint32(0x80000000) | payload.astype(np.uint32)
    for pi in range(p):
        buckets[rows, col + w + 1 + pi] = extra[:, pi]
    return CuckooTable(buckets=buckets, nb_bits=int(nb).bit_length() - 1,
                       words=w, bucket_size=bucket_size,
                       entry_words=ew,
                       primary_fraction=float((bucket_of == h1).mean()) if n else 1.0)


def build_walk_table(kmers: np.ndarray, edges: np.ndarray,
                     load_factor: float = 0.5) -> CuckooTable:
    """The preferred table for walk kernels: bucket size 2 (8-word rows,
    half the bytes of the 16-word default per gathered row) built
    primary-biased so the speculative first probe of walk_forward_spec
    resolves ~90%+ of steps with a single gathered row."""
    return build_cuckoo(kmers, edges, load_factor=load_factor,
                        bucket_size=2, primary_bias=True)


def lookup_payload(buckets: jnp.ndarray, canon: jnp.ndarray, w: int) -> jnp.ndarray:
    """One-gather lookup: canon uint32[B, W] canonical kmers -> uint32[B]
    payload (0 = miss).  Fixed cost: a single [2B]-row gather + compares.
    Bucket size is derived from the row width, so tables of any bucket_size
    (build_cuckoo / build_walk_table) share this lookup."""
    nb = buckets.shape[0]
    bs = buckets.shape[1] // (w + 1)
    mask = jnp.uint32(nb - 1)
    h = kj.hash_words(canon)
    idx = jnp.concatenate([h & mask, _jnp_h2(h) & mask]).astype(jnp.int32)
    rows = buckets[idx]                                   # [2B, BS*(W+1)]
    rows = rows.reshape(2, canon.shape[0], bs, w + 1)
    tag = rows[..., w]                                    # [2, B, BS]
    match = (tag >= jnp.uint32(0x80000000)) & jnp.all(
        rows[..., :w] == canon[None, :, None, :], axis=-1)
    return jnp.max(jnp.where(match, tag & jnp.uint32(0x7FFFFFFF), 0),
                   axis=(0, 2))


@partial(jax.jit, static_argnames=("k", "num_steps"))
def walk_forward_cuckoo(buckets, seeds, k: int, num_steps: int):
    """walk.walk_forward_fused with the cuckoo one-gather lookup: same
    emitted bases / Brent cycle flags / step counts, no probe loop at all."""
    w = seeds.shape[1]

    def step(state, _):
        cur, active, saved, power, lam = state
        canon, flipped = kj.canonicalize_words(cur, k)
        e = lookup_payload(buckets, canon, w)
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
    (_, active, *_), (bases, cycles) = jax.lax.scan(step, init, None,
                                                    length=num_steps)
    cycled = jnp.any(cycles, axis=0)
    steps = (bases >= 0).sum(axis=0).astype(jnp.int32)
    return bases, cycled, steps


def spec_iters(num_steps: int) -> int:
    """Scan length for walk_forward_spec: emitted steps plus slack for the
    speculative second-probe stalls (primary-biased tables stall on <10% of
    steps; a 25% + 32 margin makes truncation of a capped walk vanishingly
    rare — and only walks longer than num_steps can be affected at all)."""
    return num_steps + num_steps // 4 + 32


def _spec_step_fn(buckets, k: int, num_steps: int, bs: int, mask):
    """One speculative walk iteration (shared by the one-shot scan kernel and
    the chunked early-exit driver).  State: (cur, probe, active, emitcnt,
    cycled, saved, power, lam)."""
    w = buckets.shape[1] // bs - 1

    def step(state, _):
        cur, probe, active, emitcnt, cycled, saved, power, lam = state
        canon, flipped = kj.canonicalize_words(cur, k)
        h = kj.hash_words(canon)
        idx = jnp.where(probe, _jnp_h2(h) & mask, h & mask).astype(jnp.int32)
        rows = buckets[idx].reshape(cur.shape[0], bs, w + 1)
        tag = rows[..., w]
        match = (tag >= jnp.uint32(0x80000000)) & jnp.all(
            rows[..., :w] == canon[:, None, :], axis=-1)
        found = jnp.any(match, axis=1)
        e = jnp.max(jnp.where(match, tag & jnp.uint32(0x7FFFFFFF), 0), axis=1)

        next_mask = jnp.where(flipped, e >> 4, e & 0xF).astype(jnp.uint32)
        n = kj.popcount4(next_mask)
        base = kj.lowest_set_base(next_mask)
        nxt = kj.shift_append(cur, base.astype(jnp.uint32), k)

        single = found & (n == 1)
        is_cycle = jnp.all(nxt == saved, axis=-1) & single & active
        advance = active & single & ~is_cycle & (emitcnt < num_steps)
        stall = active & ~found & ~probe
        emitted = jnp.where(advance, base, -1).astype(jnp.int8)

        teleport = (power == lam) & advance
        saved = jnp.where(teleport[:, None], nxt, saved)
        power = jnp.where(teleport, power * 2, power)
        lam = jnp.where(teleport, 0, lam)
        lam = jnp.where(advance, lam + 1, lam)

        cur = jnp.where(advance[:, None], nxt, cur)
        return (cur, stall, advance | stall, emitcnt + advance.astype(jnp.int32),
                cycled | is_cycle, saved, power, lam), emitted

    return step


def _spec_init(seeds):
    b = seeds.shape[0]
    return (seeds, jnp.zeros(b, dtype=bool), jnp.ones(b, dtype=bool),
            jnp.zeros(b, dtype=jnp.int32), jnp.zeros(b, dtype=bool), seeds,
            jnp.ones(b, dtype=jnp.int32), jnp.zeros(b, dtype=jnp.int32))


@partial(jax.jit, static_argnames=("k", "num_steps"))
def walk_forward_spec(buckets, seeds, k: int, num_steps: int):
    """walk_forward_cuckoo with speculative single-probe lookups.

    Random gathers are bound by the number of rows read more than by their
    bytes.  The two-choice lookup always reads
    both candidate buckets (2 rows/step); here each scan iteration reads ONE
    row — the h1 bucket first, and only lanes that miss spend a second
    iteration probing h2 (`probe` flag).  On a primary-biased table
    (build_walk_table) ~90%+ of steps resolve on the first probe, cutting
    gathered rows per emitted base to ~1.1.

    Same outputs as walk_forward_cuckoo: (bases int8[T, B] with -1 on stall /
    ended iterations interleaved — consumers already skip negatives
    (walk.replay_walk), cycled bool[B], steps int32[B] capped at num_steps).
    T = spec_iters(num_steps) > num_steps; a walk emits num_steps bases as
    long as its stall count fits the slack.
    """
    w = seeds.shape[1]
    bs = buckets.shape[1] // (w + 1)
    mask = jnp.uint32(buckets.shape[0] - 1)
    step = _spec_step_fn(buckets, k, num_steps, bs, mask)
    (_, _, _, emitcnt, cycled, *_), bases = jax.lax.scan(
        step, _spec_init(seeds), None, length=spec_iters(num_steps))
    return bases, cycled, emitcnt


@partial(jax.jit, static_argnames=("k", "num_steps", "chunk_len"))
def _spec_chunk(buckets, state, k: int, num_steps: int, chunk_len: int):
    w = state[0].shape[1]
    bs = buckets.shape[1] // (w + 1)
    mask = jnp.uint32(buckets.shape[0] - 1)
    step = _spec_step_fn(buckets, k, num_steps, bs, mask)
    state, bases = jax.lax.scan(step, state, None, length=chunk_len)
    return state, bases, state[2].any()


@partial(jax.jit, static_argnames=("k", "num_steps", "chunk_len", "sub"))
def _spec_chunk_device(buckets, state, k: int, num_steps: int,
                       chunk_len: int, sub: int):
    """A chunk of speculative-walk iterations with DEVICE-side early exit:
    a lax.while_loop over `sub`-length scans, so the whole chunk is ONE
    dispatch and dead lanes stop costing gathers at `sub` granularity —
    no host round-trip per sub-chunk.  Unexecuted iterations stay -1 in the
    output (consumers already skip negative base codes)."""
    w = state[0].shape[1]
    bs = buckets.shape[1] // (w + 1)
    mask = jnp.uint32(buckets.shape[0] - 1)
    step = _spec_step_fn(buckets, k, num_steps, bs, mask)
    n_sub = -(-chunk_len // sub)
    out = jnp.full((n_sub * sub, state[0].shape[0]), -1, jnp.int8)

    def cond(c):
        i, st, _ = c
        return (i < n_sub) & st[2].any()

    def body(c):
        i, st, out = c
        st, bases = jax.lax.scan(step, st, None, length=sub)
        out = jax.lax.dynamic_update_slice(out, bases, (i * sub, 0))
        return (i + 1, st, out)

    i, state, out = jax.lax.while_loop(
        cond, body, (jnp.int32(0), state, out))
    return state, out, state[2].any(), i * sub


# ---------------------------------------------------------------------------
# run table: unitig-lookahead walks — many bases per gathered row
# ---------------------------------------------------------------------------
# The walk kernels above emit one base per gathered row, and random gathers
# are bound by their row rate far below HBM bandwidth.  The run table
# amortizes each gather over a unitig run: every entry stores, for both
# orientations, the next up-to-24 bases the walk automaton would emit from
# that kmer (computed at build time BY the base kernel, so run semantics are
# exactly walk semantics — runs end where the walk would end: branch,
# dead-end, missing neighbor, or builder-side Brent cycle detection, which is
# flagged).  The jump kernel gathers one row, emits the whole run, and lands
# the cursor run-length kmers ahead via shift_append_multi.  Exactness is
# preserved through the replay contract (ops/walk_np.replay_run_walk): the
# recorded bases always cover at least one full lap of any cycle, and the
# host replay applies the reference's seen-set rule to the recorded path.

RUN_MAX = 24
_RUN_WORDS = 4   # fwd0, fwd1, rev0, rev1


def _pack_runs(bases: np.ndarray, cycled: np.ndarray,
               steps: np.ndarray) -> np.ndarray:
    """Builder-walk recordings -> packed run words uint32[B, 2].

    word0: bits 23..0 = bases b0..b11 big-endian (b0 at bits 23..22),
           bits 29..24 = run length, bit 31 = builder-detected cycle.
    word1: bits 23..0 = bases b12..b23."""
    t, b = np.nonzero(bases >= 0)
    valid = bases >= 0
    pos = (np.cumsum(valid, axis=0) - 1)[t, b]
    code = bases[t, b].astype(np.uint32)
    n = bases.shape[1]
    w0 = np.zeros(n, np.uint32)
    w1 = np.zeros(n, np.uint32)
    lo = pos < 12
    np.bitwise_or.at(w0, b[lo], code[lo] << (22 - 2 * pos[lo]))
    np.bitwise_or.at(w1, b[~lo], code[~lo] << (46 - 2 * pos[~lo]))
    w0 |= steps.astype(np.uint32) << 24
    w0 |= cycled.astype(np.uint32) << 31
    return np.stack([w0, w1], axis=1)


@dataclass
class RunTable:
    """Key table + parallel run pool, SPLIT into two narrow arrays: the
    kernel reads keys and runs as two 8-word (32 B) gathers at the same
    bucket index instead of one 16-word gather.  `buckets` is exactly a
    build_walk_table layout (bs=2, primary-biased); `runs[b, e*4:(e+1)*4]` =
    (fwd0, fwd1, rev0, rev1) for entry e of bucket b."""
    buckets: np.ndarray      # uint32[NB, 2*(W+1)]
    runs: np.ndarray         # uint32[NB, 2*4]
    nb_bits: int
    words: int
    bucket_size: int = 2
    primary_fraction: float = 0.0


def build_run_table(kmers: np.ndarray, edges: np.ndarray, k: int,
                    load_factor: float = 0.5,
                    chunk: int = 262144) -> RunTable:
    """Walk table with per-entry unitig runs.  Runs are recorded by the base
    speculative kernel itself (walk_forward_spec_chunked with
    num_steps=RUN_MAX) from every kmer in both orientations, so they inherit
    its exact step semantics."""
    n, w = kmers.shape
    nb, bucket_of, pos_of, h1 = _place(kmers, load_factor, None, 2, True)
    buckets = np.zeros((nb, 2 * (w + 1)), dtype=np.uint32)
    col = pos_of * (w + 1)
    for wi in range(w):
        buckets[bucket_of, col + wi] = kmers[:, wi]
    buckets[bucket_of, col + w] = np.uint32(0x80000000) | edges.astype(np.uint32)

    dev_buckets = jnp.asarray(buckets)

    def record(seed_words: np.ndarray) -> np.ndarray:
        out = np.zeros((seed_words.shape[0], 2), np.uint32)
        for lo in range(0, seed_words.shape[0], chunk):
            sl = jnp.asarray(np.ascontiguousarray(seed_words[lo:lo + chunk]))
            bases, cycled, steps = walk_forward_spec_chunked(
                dev_buckets, sl, k, RUN_MAX)
            out[lo:lo + chunk] = _pack_runs(bases, cycled, steps)
        return out

    fwd = record(kmers)
    rev = record(np.asarray(kj.revcomp_words(jnp.asarray(kmers), k)))
    runs = np.zeros((nb, 2 * 4), dtype=np.uint32)
    rcol = pos_of * 4
    runs[bucket_of, rcol + 0] = fwd[:, 0]
    runs[bucket_of, rcol + 1] = fwd[:, 1]
    runs[bucket_of, rcol + 2] = rev[:, 0]
    runs[bucket_of, rcol + 3] = rev[:, 1]
    return RunTable(buckets=buckets, runs=runs,
                    nb_bits=int(nb).bit_length() - 1, words=w,
                    primary_fraction=float((bucket_of == h1).mean()) if n else 1.0)


def run_iters(num_steps: int) -> int:
    """Scan length ceiling for walk_forward_runs: worst case every run has
    length 1 (maximally branchy graph), so the guarantee matches
    spec_iters.  The chunked driver early-exits as soon as all lanes retire —
    on linear graphs that is ~num_steps/RUN_MAX iterations, not this bound."""
    return spec_iters(num_steps)


def _run_step_fn(buckets, runs, k: int, num_steps: int, bs: int, mask):
    """One run-jump iteration.  State mirrors _spec_step_fn.  Keys and runs
    are gathered as two narrow (8-word) rows at the same bucket index — see
    RunTable."""
    w = buckets.shape[1] // bs - 1

    def step(state, _):
        cur, probe, active, emitcnt, cycled, saved, power, lam = state
        canon, flipped = kj.canonicalize_words(cur, k)
        h = kj.hash_words(canon)
        idx = jnp.where(probe, _jnp_h2(h) & mask, h & mask).astype(jnp.int32)
        rows = buckets[idx].reshape(cur.shape[0], bs, w + 1)
        tag = rows[..., w]
        match = (tag >= jnp.uint32(0x80000000)) & jnp.all(
            rows[..., :w] == canon[:, None, :], axis=-1)
        found = jnp.any(match, axis=1)
        rrows = runs[idx].reshape(cur.shape[0], bs, 4)

        def pick(c):
            return jnp.max(jnp.where(match, rrows[..., c], 0), axis=1)
        r0 = jnp.where(flipped, pick(2), pick(0))
        r1 = jnp.where(flipped, pick(3), pick(1))
        run_len = ((r0 >> jnp.uint32(24)) & jnp.uint32(0x3F)).astype(jnp.int32)
        run_cyc = (r0 >> jnp.uint32(31)) != 0

        m = jnp.minimum(run_len, num_steps - emitcnt)
        emit = active & found & (m > 0)
        mm = jnp.where(emit, m, 0)
        hi24 = r0 & jnp.uint32(0x00FFFFFF)
        lo24 = r1 & jnp.uint32(0x00FFFFFF)
        nxt = kj.shift_append_multi(cur, hi24, lo24, mm, k)

        # jump-granularity Brent: a jump landing on the anchor closes a lap.
        # Unlike the single-step kernel we DO emit the final run — the replay
        # needs those bases to cover the lap when the jump cycle is short.
        is_cycle = emit & jnp.all(nxt == saved, axis=-1)
        full = emit & (m == run_len)
        ends_cycle = (full & run_cyc) | (active & found & (run_len == 0) & run_cyc)
        advance = (full & ~run_cyc & ~is_cycle
                   & (emitcnt + mm < num_steps))
        stall = active & ~found & ~probe

        e0 = jnp.where(emit, (hi24 | (mm.astype(jnp.uint32) << 24)),
                       jnp.uint32(0))
        e1 = jnp.where(emit, lo24, jnp.uint32(0))

        teleport = (power == lam) & advance
        saved = jnp.where(teleport[:, None], nxt, saved)
        power = jnp.where(teleport, power * 2, power)
        lam = jnp.where(teleport, 0, lam)
        lam = jnp.where(advance, lam + 1, lam)

        cur = jnp.where(advance[:, None], nxt, cur)
        return (cur, stall, advance | stall, emitcnt + mm,
                cycled | is_cycle | ends_cycle, saved, power, lam), (e0, e1)

    return step


@partial(jax.jit, static_argnames=("k", "num_steps", "chunk_len"))
def _run_chunk(buckets, runs, state, k: int, num_steps: int, chunk_len: int):
    w = state[0].shape[1]
    bs = buckets.shape[1] // (w + 1)
    mask = jnp.uint32(buckets.shape[0] - 1)
    step = _run_step_fn(buckets, runs, k, num_steps, bs, mask)
    state, out = jax.lax.scan(step, state, None, length=chunk_len)
    return state, out, state[2].any()


@partial(jax.jit, static_argnames=("k", "num_steps", "chunk_len", "sub"))
def _run_chunk_device(buckets, runs, state, k: int, num_steps: int,
                      chunk_len: int, sub: int):
    """Run-jump twin of _spec_chunk_device: one dispatch covering up to
    `chunk_len` iterations, early-exiting on device at `sub` granularity.
    Unexecuted iterations stay 0 in the run words (run length 0 = no
    bases, which decode_runs/replay_run_walk already treat as empty)."""
    w = state[0].shape[1]
    bs = buckets.shape[1] // (w + 1)
    mask = jnp.uint32(buckets.shape[0] - 1)
    step = _run_step_fn(buckets, runs, k, num_steps, bs, mask)
    n_sub = -(-chunk_len // sub)
    b = state[0].shape[0]
    out0 = jnp.zeros((n_sub * sub, b), jnp.uint32)
    out1 = jnp.zeros((n_sub * sub, b), jnp.uint32)

    def cond(c):
        i, st, _, _ = c
        return (i < n_sub) & st[2].any()

    def body(c):
        i, st, out0, out1 = c
        st, (w0, w1) = jax.lax.scan(step, st, None, length=sub)
        out0 = jax.lax.dynamic_update_slice(out0, w0, (i * sub, 0))
        out1 = jax.lax.dynamic_update_slice(out1, w1, (i * sub, 0))
        return (i + 1, st, out0, out1)

    i, state, out0, out1 = jax.lax.while_loop(
        cond, body, (jnp.int32(0), state, out0, out1))
    return state, (out0, out1), state[2].any(), i * sub


@partial(jax.jit, static_argnames=("k", "num_steps"))
def walk_forward_runs(buckets, runs, seeds, k: int, num_steps: int):
    """Run-table walk: (run_w0 u32[T, B], run_w1 u32[T, B], cycled bool[B],
    steps int32[B]).  Each iteration emits a whole unitig run (<= RUN_MAX
    bases, length in bits 29..24 of run_w0); decode with
    ops/walk_np.decode_runs / replay with replay_run_walk.  steps is capped
    at num_steps exactly like walk_forward_spec."""
    w = seeds.shape[1]
    bs = buckets.shape[1] // (w + 1)
    mask = jnp.uint32(buckets.shape[0] - 1)
    step = _run_step_fn(buckets, runs, k, num_steps, bs, mask)
    (_, _, _, emitcnt, cycled, *_), (w0, w1) = jax.lax.scan(
        step, _spec_init(seeds), None, length=run_iters(num_steps))
    return w0, w1, cycled, emitcnt


def walk_forward_runs_chunked(buckets, runs, seeds, k: int, num_steps: int,
                              chunk: int = 512, sub: int = 8):
    """walk_forward_runs with early exit (the run twin of
    walk_forward_spec_chunked).  Each host-level chunk is ONE device
    dispatch that internally while-loops over `sub`-length scans and stops
    when every lane retires, so the host round-trip cost is paid once per
    `chunk` iterations instead of once per `sub`."""
    state = _spec_init(seeds)
    total = run_iters(num_steps)
    out0, out1 = [], []
    done = 0
    while done < total:
        length = min(chunk, total - done)
        se = sub if length % sub == 0 else length
        state, (w0, w1), any_active, _ = _run_chunk_device(
            buckets, runs, state, k, num_steps, length, se)
        out0.append(np.asarray(w0)[:length])
        out1.append(np.asarray(w1)[:length])
        done += length
        if not bool(np.asarray(any_active)):
            break
    return (np.concatenate(out0, axis=0), np.concatenate(out1, axis=0),
            np.asarray(state[4]), np.asarray(state[3]))


# ---------------------------------------------------------------------------
# jump table: pointer-chased unitig runs — one direct 16 B gather per jump
# ---------------------------------------------------------------------------
# The run table still pays a full hash lookup per jump (canonicalize + hash +
# two 32 B rows + key compares, with ~10% stall iterations for secondary
# buckets).  The jump table removes ALL of it: each (kmer, orientation) owns a
# row in a dense [2N, 4]-word array holding its packed run AND the row index
# of the kmer the run lands on, computed at build time.  After one initial
# hash lookup for the seed, every jump is a single directly-addressed 16 B
# gather — no canonicalization, no hashing, no key compares, no stalls — and
# Brent cycle detection compares row ids (a bijection onto oriented kmers)
# instead of 96-bit cursors.  Emissions use the identical packed-run format,
# so decode_runs/replay_run_walk consume both kernels unchanged.
#
# BUILD is pointer doubling, fully on device (no recorded walks, no scans):
# one single-step pass computes every row's successor (dense edge read + one
# hash resolve of the landing kmer), then log2(JUMP_MAX) compose passes each
# double the run length — run[r] = run[r] ++ run[dest[r]].  With JUMP_MAX a
# power of two the composition is exact: a full run always has length 2^s at
# stage s, so the landing row after concatenation is exactly the landed run's
# own pointer, never a mid-run cursor.  Every composed run is a prefix of the
# true walk from its row, which is all replay_jump_walk's seen-set
# replay needs for host-oracle-exact contigs.  ~6 vectorized passes replace
# an 87-iteration recorded-walk builder and its scan-kernel compiles.

_JUMP_END = np.uint32(0xFFFFFFFF)   # run ends the walk (branch/dead-end)

# bases per jump row.  A power of two (doubling exactness, see above); the
# (hi, lo) 64-bit linear packing holds exactly 32 two-bit bases, so 32
# uses the pair fully.
JUMP_MAX = 32


def _gather_rows(flat: jnp.ndarray, idx: jnp.ndarray, size: int):
    """[B, size] logical rows of a FLAT array read as [len // size, size]:
    one direct `size`-word row gather per lane (16 B for a jump row, 32 B
    for a bucket row)."""
    return flat.reshape(-1, size)[idx]


@dataclass
class JumpTable:
    """rows: uint32[2N*4] FLAT — row 2*i+d at [4*(2i+d), 4*(2i+d)+4) =
    (hi, lo, next_row, meta) for kmer
    i in orientation d (0 = as stored/canonical, 1 = revcomp).  (hi, lo)
    hold the run bases LINEARLY packed big-endian: base p at bits (62-2p)
    of the 64-bit pair (hi bits 30-2p for p<16, lo bits 30-2(p-16) for
    p>=16); meta bits 5..0 = run length, bit 31 = builder-detected cycle.
    next_row = _JUMP_END unless the run is a full JUMP_MAX-base unitig run,
    in which case it is the row id of the landing cursor.  `buckets` is a
    build_cuckoo(kmers, ids) table used once per walk to resolve the seed
    to its row.  Because every non-final jump emits exactly JUMP_MAX bases,
    a walk's emissions concatenate contiguously — the walker returns ONE
    [B, 2T] packed array at ~2 bits per base, so pulling walks to the host
    moves ~bases/4 bytes.

    Both `rows` and `buckets` are stored FLAT (1-D); lookups and jumps view
    them as [2N, 4] / [NB, 8] rows (_gather_rows).

    Capacity: row ids are 2*payload+orientation carried as int32, capping
    the graph at 2^30 kmers (vs the cuckoo payload's 2^31) — ample for the
    Pf-scale target (~24M records) but NOT for human-scale graphs (~2.5G
    kmers at k=47); those need uint32 row arithmetic plus a separate active
    mask, or graph sharding (parallel/mesh.py).

    Cycle caveat: Brent detection here compares row ids at jump
    (JUMP_MAX-base) stride, so a cycle of length L is detected after
    L/gcd(L,JUMP_MAX) jumps —
    within the step cap for short cycles, but a long cycle whose period
    exceeds cap/JUMP_MAX jumps saturates `steps` at the cap with
    cycled=False.  walk_forward_jumps therefore reports
    cap-saturated lanes as potentially cyclic (`cycled | (steps ==
    num_steps)` would over-flag; instead consumers get the separate
    `saturated` mask) and replayed contigs stay exact regardless because
    replay_jump_walk applies the reference seen-set rule to the
    recorded bases."""
    buckets: np.ndarray
    rows: np.ndarray
    words: int


def _pair_shr(hi: jnp.ndarray, lo: jnp.ndarray, s: jnp.ndarray):
    """Logical right shift of a 64-bit value held as (hi, lo) uint32 pairs
    by s in [0, 64) — uint64 is unavailable without x64 mode."""
    s = s.astype(jnp.uint32)
    big = s >= 32
    sm = jnp.where(big, s - 32, s)                       # [0, 32)
    # carry = hi << (32 - sm) without UB at sm == 0
    carry = jnp.where(sm > 0, hi << ((32 - sm) & 31), 0)
    lo2 = jnp.where(big, hi >> sm, (lo >> sm) | carry)
    hi2 = jnp.where(big, 0, hi >> sm)
    return hi2.astype(jnp.uint32), lo2.astype(jnp.uint32)


def _lookup_flat_chunked(flat, canon, w: int, chunk: int = 1 << 19):
    """lookup_payload_tag_flat in bounded chunks, so the whole-graph landing
    resolve in _jump_stage0 holds a bounded gathered-row intermediate."""
    n = canon.shape[0]
    if n <= chunk:
        return lookup_payload_tag_flat(flat, canon, w)
    npad = -(-n // chunk) * chunk
    cpad = jnp.concatenate(
        [canon, jnp.zeros((npad - n, canon.shape[1]), canon.dtype)])
    cc = cpad.reshape(-1, chunk, canon.shape[1])
    pay, tag = jax.lax.map(
        lambda c: lookup_payload_tag_flat(flat, c, w), cc)
    return pay.reshape(-1)[:n], tag.reshape(-1)[:n]


def _jump_stage0(kmers_dev, edges_dev, flags_dev, ct_buckets, k: int,
                 d: int):
    """Single-step successor for every kmer row in ONE orientation
    (d=0: stored/canonical, out-edges from the low nibble; d=1: revcomp,
    high nibble).  One jit per orientation keeps the flagship-scale peak
    under HBM (a fused fwd+rev program held both pipelines live and
    exceeded 15.75G by ~260M at 23.7M records).

    Returns per-row (hi, lo, length, cyc, flag, endj, ptr) where (hi, lo)
    hold the run bases in LINEAR packing — base p at bits (62-2p) of the
    64-bit pair — and ptr is the successor row id (or _JUMP_END).  The
    edge byte comes from the dense edges array (no hash); only the
    LANDING kmer needs one (chunked) lookup.  `flag` starts as the
    per-kmer attribute bit (flags_dev — e.g. "this kmer carries link
    records") and compose ORs it along runs, so a walked lane knows
    whether ANY kmer on its path has the attribute without any host-side
    hashing."""
    n, w = kmers_dev.shape
    e = edges_dev.astype(jnp.uint32)
    cur = kmers_dev if d == 0 else kj.revcomp_words(kmers_dev, k)
    next_mask = (e & 0xF) if d == 0 else (e >> 4)

    nm = kj.popcount4(next_mask)
    base = kj.lowest_set_base(next_mask)
    nxt = kj.shift_append(cur, base.astype(jnp.uint32), k)
    single = nm == 1
    canon, fl2 = kj.canonicalize_words(nxt, k)
    pay, present = _lookup_flat_chunked(ct_buckets, canon, w)
    dest = (2 * pay + fl2.astype(jnp.uint32)).astype(jnp.uint32)
    own = (2 * jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(d))
    self_loop = single & present & (dest == own)
    length = jnp.where(single & ~self_loop, 1, 0).astype(jnp.uint32)
    cyc = self_loop
    ptr = jnp.where(single & present & ~self_loop, dest, _JUMP_END)
    hi = jnp.where(length > 0, base.astype(jnp.uint32) << 30, 0)
    lo = jnp.zeros_like(hi)
    # stop cause bit: this kmer is a JUNCTION (out-degree >= 2) in the
    # walk orientation — the one stop class links can alter (a link-free
    # walk stops at its FIRST junction, so mid-path junctions never
    # occur; dead-ends and missing neighbors are link-immune)
    endj = nm >= 2
    return hi, lo, length, cyc, flags_dev, endj, ptr


_jump_stage0_jit = partial(jax.jit, static_argnames=("k", "d"))(_jump_stage0)


@jax.jit
def _jump_compose(hi, lo, length, cyc, flag, endj, ptr):
    """One doubling pass: rows holding a FULL run (of the current stage
    size) with a live pointer append their destination's run.  Exactness
    invariant maintained across passes: ptr != END  <=>  the run is full
    and continuing, so the landed pointer is never a mid-run cursor."""
    own = jnp.arange(hi.shape[0], dtype=jnp.uint32)
    live = ptr != _JUMP_END
    d = jnp.where(live, ptr, 0)
    bhi, blo = hi[d], lo[d]
    blen, bcyc, bflag, bendj, bptr = (length[d], cyc[d], flag[d], endj[d],
                                      ptr[d])
    shi, slo = _pair_shr(bhi, blo, 2 * length)
    nhi = jnp.where(live, hi | shi, hi)
    nlo = jnp.where(live, lo | slo, lo)
    nlen = jnp.where(live, length + blen, length)
    nptr = jnp.where(live, bptr, ptr)
    nflag = flag | (live & bflag)
    nendj = jnp.where(live, bendj, endj)     # the stop cause is b's
    # cycle closed within the composed run: destination chain returned to
    # this row (catches cycle lengths dividing the stage size)
    ncyc = jnp.where(live, bcyc | (bptr == own), cyc)
    nptr = jnp.where(ncyc, _JUMP_END, nptr)
    return nhi, nlo, nlen, ncyc, nflag, nendj, nptr


@jax.jit
def _jump_pack_rows(hi, lo, length, cyc, flag, endj, ptr):
    meta = (length | (endj.astype(jnp.uint32) << 29)
            | (flag.astype(jnp.uint32) << 30)
            | (cyc.astype(jnp.uint32) << 31))
    # FLAT interleaved output (see JumpTable): strided 1-D writes
    n = hi.shape[0]
    flat = jnp.zeros(4 * n, jnp.uint32)
    return (flat.at[0::4].set(hi).at[1::4].set(lo)
            .at[2::4].set(ptr).at[3::4].set(meta))


def _jump_rows_device(kmers_dev, edges_dev, flags_dev, ct_buckets, k: int):
    """Small jitted programs instead of one fused giant: stage0 compiles
    once per shape bucket and the SAME compiled compose program runs all
    log2(JUMP_MAX) doubling passes — compilation is charged per program,
    so splitting cuts compile wall-clock while adding only ~7 cheap
    dispatches."""
    fh, fl, fn, fc, ff, fj, fp = _jump_stage0_jit(
        kmers_dev, edges_dev, flags_dev, ct_buckets, k, 0)
    rh, rl, rn, rc, rf, rj, rp = _jump_stage0_jit(
        kmers_dev, edges_dev, flags_dev, ct_buckets, k, 1)

    def interleave(a, b):
        # strided 1-D writes into the flat row-interleaved layout
        out = jnp.zeros(2 * a.shape[0], a.dtype)
        return out.at[0::2].set(a).at[1::2].set(b)

    hi, lo = interleave(fh, rh), interleave(fl, rl)
    length, cyc, flag, endj, ptr = (
        interleave(fn, rn), interleave(fc, rc), interleave(ff, rf),
        interleave(fj, rj), interleave(fp, rp))
    stage = 1
    while stage < JUMP_MAX:
        hi, lo, length, cyc, flag, endj, ptr = _jump_compose(
            hi, lo, length, cyc, flag, endj, ptr)
        stage *= 2
    return _jump_pack_rows(hi, lo, length, cyc, flag, endj, ptr)


def _pow2_pad(n: int, lo: int = 4096) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@partial(jax.jit, static_argnames=("nb",))
def _scatter_buckets(kd, entry_idx, nb: int):
    """Build the bs=2 cuckoo bucket array ON DEVICE, FLAT
    (uint32[NB*2*(w+1)]), from the uploaded keys and the host-computed
    placement (entry_idx = bucket*2 + pos): w+1 unique-index 1-D scatters.
    Uploading (bucket, pos) as one int32[N] moves ~4 B/key host->device
    vs ~24 B/key for a materialized bucket array."""
    n, w = kd.shape
    assert w <= 3, "flat bucket layout holds keys of up to 3 words"
    tag = jnp.uint32(0x80000000) | jnp.arange(n, dtype=jnp.uint32)
    # fixed entry stride 4 (keys at 0..w-1, tag at slot 3) so a bucket row
    # is exactly 8 words
    flat = jnp.zeros(nb * 8, jnp.uint32)
    base = entry_idx * 4
    for j in range(w):
        flat = flat.at[base + j].set(kd[:, j], unique_indices=True)
    return flat.at[base + 3].set(tag, unique_indices=True)


@partial(jax.jit, static_argnames=("npad",))
def _pad_build_inputs(kd, ed, fd, npad: int):
    """Pad build inputs to the power-of-two row count on DEVICE (pad rows
    duplicate row 0; unreachable — see build_jump_table)."""
    n = kd.shape[0]
    if npad == n:
        return kd, ed, fd
    pk = jnp.concatenate(
        [kd, jnp.broadcast_to(kd[:1], (npad - n, kd.shape[1]))])
    pe = jnp.concatenate([ed, jnp.zeros(npad - n, ed.dtype)])
    pf = jnp.concatenate([fd, jnp.zeros(npad - n, jnp.bool_)])
    return pk, pe, pf


def build_jump_table(kmers: np.ndarray, edges: np.ndarray, k: int,
                     load_factor: float = 0.5,
                     chunk: int = 262144,
                     flags: np.ndarray | None = None) -> JumpTable:
    """Pointer-doubling jump-table build, fully on device (see the section
    comment).  `rows` and `buckets` are returned as DEVICE arrays — the
    walker consumes them in place; nothing round-trips through the host.
    Inputs are padded to power-of-two row counts so arbitrary graph sizes
    share a handful of compiled programs (pad rows duplicate row 0; they
    are unreachable — seed resolution and dest pointers only ever produce
    real ids from the hash table).  `chunk` is accepted for backward
    compatibility and unused.

    Transfer-minimized: only the raw keys/edges/flags and a 4 B/key
    placement vector cross the host->device link (the bucket array and all
    padding are constructed on device), and the uploads are issued BEFORE
    the host cuckoo placement runs so the transfer overlaps it.

    flags: optional bool[N] per-kmer attribute (e.g. "carries link
    records"); the build ORs it along runs and the walker ORs it along
    walks, so walk_forward_jumps' `touched` output reports, per lane,
    whether any kmer on its path carried the attribute — with no host
    hashing (the linked-Partition filter)."""
    n, w = kmers.shape
    if flags is None:
        flags = np.zeros(n, dtype=bool)
    # async uploads first; the host placement below overlaps the transfer
    kd = jnp.asarray(np.ascontiguousarray(kmers))
    ed = jnp.asarray(np.ascontiguousarray(edges.astype(np.uint8)))
    fd = jnp.asarray(np.ascontiguousarray(flags.astype(bool)))
    nb, bucket_of, pos_of, _h1 = _place(kmers, load_factor, None, 2, True)
    entry_idx = jnp.asarray((bucket_of * 2 + pos_of).astype(np.int32))
    ct_buckets = _scatter_buckets(kd, entry_idx, nb)
    npad = _pow2_pad(n)
    rows = _jump_rows_device(*_pad_build_inputs(kd, ed, fd, npad),
                             ct_buckets, k)
    return JumpTable(buckets=ct_buckets, rows=rows, words=w)


@partial(jax.jit, static_argnames=("k",))
def _jump_seed_rows(buckets, seeds, k: int):
    """Resolve seed cursors to jump-table row ids (int32; negative = not in
    graph).  One two-probe lookup — the only hashing a jump walk ever does.
    Accepts the jump table's FLAT bucket layout or the legacy 2-D one."""
    w = seeds.shape[1]
    canon, flipped = kj.canonicalize_words(seeds, k)
    if buckets.ndim == 1:
        payload, tag = lookup_payload_tag_flat(buckets, canon, w)
    else:
        payload, tag = lookup_payload_tag(buckets, canon, w)
    row = (2 * payload.astype(jnp.int32)) + flipped.astype(jnp.int32)
    return jnp.where(tag, row, -1)


def lookup_payload_tag_flat(flat: jnp.ndarray, canon: jnp.ndarray, w: int):
    """lookup_payload_tag over the FLAT bs=2 bucket layout (fixed 4-word
    entry stride: keys at 0..w-1, tag at slot 3; 8-word bucket rows): one
    32 B row gather per candidate bucket + vector compares."""
    nb = flat.shape[0] // 8
    mask = jnp.uint32(nb - 1)
    h = kj.hash_words(canon)
    idx = jnp.concatenate([h & mask, _jnp_h2(h) & mask]).astype(jnp.int32)
    rows = _gather_rows(flat, idx, 8)
    rows = rows.reshape(2, canon.shape[0], 2, 4)
    tag = rows[..., 3]
    match = (tag >= jnp.uint32(0x80000000)) & jnp.all(
        rows[..., :w] == canon[None, :, None, :], axis=-1)
    payload = jnp.max(jnp.where(match, tag & jnp.uint32(0x7FFFFFFF), 0),
                      axis=(0, 2))
    return payload, jnp.any(match, axis=(0, 2))


def lookup_payload_tag(buckets: jnp.ndarray, canon: jnp.ndarray, w: int):
    """(payload uint32[B], present bool[B]) from ONE two-row gather — the
    fused form of lookup_payload + lookup_tag for callers that need both
    (payload 0 is a valid id, so presence needs its own bit)."""
    nb = buckets.shape[0]
    bs = buckets.shape[1] // (w + 1)
    mask = jnp.uint32(nb - 1)
    h = kj.hash_words(canon)
    idx = jnp.concatenate([h & mask, _jnp_h2(h) & mask]).astype(jnp.int32)
    rows = buckets[idx].reshape(2, canon.shape[0], bs, w + 1)
    tag = rows[..., w]
    match = (tag >= jnp.uint32(0x80000000)) & jnp.all(
        rows[..., :w] == canon[None, :, None, :], axis=-1)
    payload = jnp.max(jnp.where(match, tag & jnp.uint32(0x7FFFFFFF), 0),
                      axis=(0, 2))
    return payload, jnp.any(match, axis=(0, 2))


def lookup_tag(buckets: jnp.ndarray, canon: jnp.ndarray, w: int) -> jnp.ndarray:
    """Presence bit of the two-choice lookup (payload 0 is a valid id)."""
    return lookup_payload_tag(buckets, canon, w)[1]


def _jump_step_fn(rows, num_steps: int):
    """One pointer jump.  State: (row, active, emitcnt, cycled, saved,
    power, lam, touched, endj) — row/saved are int32 row ids; touched ORs
    the build-time flag bit along the walk, endj records whether the lane
    stopped at a junction.  Emits the jump's (hi, lo) linear-packed bases,
    masked to the emitted count when the step cap clamps a run mid-jump."""

    def step(state, _):
        (row, active, emitcnt, cycled, saved, power, lam, touched,
         endj) = state
        r = _gather_rows(rows, jnp.maximum(row, 0), 4)      # [B, 4]
        hi, lo, ptr, meta = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
        run_len = (meta & jnp.uint32(0x3F)).astype(jnp.int32)
        run_cyc = (meta >> jnp.uint32(31)) != 0
        touched = touched | (active & (((meta >> jnp.uint32(30)) & 1) != 0))
        # stop cause of the lane = the endj bit of its final gathered row
        endj = jnp.where(active, ((meta >> jnp.uint32(29)) & 1) != 0, endj)

        m = jnp.minimum(run_len, num_steps - emitcnt)
        emit = active & (m > 0)
        mm = jnp.where(emit, m, 0)

        nxt = ptr.astype(jnp.int32)
        has_next = emit & (m == run_len) & (ptr != _JUMP_END) & ~run_cyc
        is_cycle = has_next & (nxt == saved)
        # builder-detected cycles: flag when the full run is emitted, and
        # also for zero-length immediately-cycling rows (run kernel parity)
        ends_cycle = (emit & run_cyc & (m == run_len)) | (
            active & run_cyc & (run_len == 0))
        advance = has_next & ~is_cycle & (emitcnt + mm < num_steps)

        # keep only the first mm bases (top 2*mm bits of the 64-bit pair) —
        # a no-op except when the cap clamps the final jump
        keep = (2 * mm).astype(jnp.uint32)
        hi_mask = jnp.where(keep >= 32, jnp.uint32(0xFFFFFFFF),
                            jnp.where(keep > 0,
                                      jnp.uint32(0xFFFFFFFF)
                                      << ((32 - keep) & 31), 0))
        lo_keep = jnp.where(keep > 32, keep - 32, 0)
        lo_mask = jnp.where(lo_keep >= 32, jnp.uint32(0xFFFFFFFF),
                            jnp.where(lo_keep > 0,
                                      jnp.uint32(0xFFFFFFFF)
                                      << ((32 - lo_keep) & 31), 0))
        e_hi = jnp.where(emit, hi & hi_mask, 0)
        e_lo = jnp.where(emit, lo & lo_mask, 0)

        teleport = (power == lam) & advance
        saved = jnp.where(teleport, nxt, saved)
        power = jnp.where(teleport, power * 2, power)
        lam = jnp.where(teleport, 0, lam)
        lam = jnp.where(advance, lam + 1, lam)

        row = jnp.where(advance, nxt, row)
        return (row, advance, emitcnt + mm,
                cycled | is_cycle | ends_cycle, saved, power, lam,
                touched, endj), (e_hi, e_lo)

    return step


def _jump_init(seed_rows):
    b = seed_rows.shape[0]
    return (seed_rows, seed_rows >= 0, jnp.zeros(b, jnp.int32),
            jnp.zeros(b, bool), seed_rows, jnp.ones(b, jnp.int32),
            jnp.zeros(b, jnp.int32), jnp.zeros(b, bool),
            jnp.zeros(b, bool))


def jump_iters(num_steps: int) -> int:
    """Iteration ceiling.  A jump row carries a live pointer ONLY when its
    run is a full JUMP_MAX-base unitig run (partial runs end the walk), so
    every non-final jump emits exactly JUMP_MAX bases: a walk needs at most
    ceil(num_steps / JUMP_MAX) full jumps plus one final partial jump.  The
    tight bound matters doubly — fewer early-exit checks on device AND a
    [T, B] output small enough that materializing the run words for replay
    costs ~bases/4 bytes instead of dominating wall-clock."""
    return -(-num_steps // JUMP_MAX) + 2


@partial(jax.jit, static_argnames=("num_steps",))
def _jump_walk(rows, seed_rows, num_steps: int):
    """The whole jump walk as ONE plain scan of jump_iters(num_steps)
    iterations.  With the tight iteration bound (every non-final jump emits
    JUMP_MAX bases) an early-exit while_loop would save at most a few
    percent of gathers while compiling a larger while(scan(...)) program;
    a flat scan with a 4-word gather body is the simplest program to
    compile and run.

    Returns (state, packed uint32[B, 2T]): per-lane linear 2-bit base
    packing — lane words [h0, l0, h1, l1, ...] concatenate contiguously
    because non-final jumps are always full."""
    step = _jump_step_fn(rows, num_steps)
    state, (o_hi, o_lo) = jax.lax.scan(
        step, _jump_init(seed_rows), None, length=jump_iters(num_steps))
    packed = jnp.stack([o_hi.T, o_lo.T], axis=-1).reshape(
        seed_rows.shape[0], -1)
    return state, packed


def walk_forward_jumps(buckets, rows, seeds, k: int, num_steps: int):
    """Jump-table walk — the production walk entry point.  Returns
    (packed uint32[B, 2T], cycled bool[B], steps int32[B], saturated
    bool[B], touched bool[B], ends_junction bool[B]): per-lane linearly
    packed emitted bases (2 bits each, big-endian; decode with
    ops/walk_np.decode_jump_packed / replay with replay_jump_walk).
    `touched` is True when any kmer on the lane's walked path carried the
    build-time flag bit (see build_jump_table's `flags` — the
    linked-Partition filter), including the stop kmer.  `ends_junction` is
    True when the lane stopped AT a junction (out-degree >= 2) — the only
    stop class links can alter besides cycles, since a link-free walk
    stops at its first junction (dead ends and missing neighbors are
    link-immune).

    `saturated` marks lanes still active when `steps` hit the num_steps cap:
    the lane may sit on an undetected cycle (jump-stride Brent needs
    L/gcd(L, JUMP_MAX) jumps to close a cycle of length L — see the
    JumpTable docstring), so `cycled` is only authoritative for
    non-saturated lanes.  Replayed contigs are exact either way
    (replay_jump_walk applies the reference seen-set rule).

    Lanes are padded to power-of-two batch sizes (inactive pad rows) so
    arbitrary seed counts share compiled programs — every distinct shape
    costs a fresh compile otherwise."""
    b = seeds.shape[0]
    bpad = _pow2_pad(b, 256)
    if bpad != b:
        seeds = jnp.concatenate(
            [seeds, jnp.repeat(seeds[:1], bpad - b, axis=0)])
    seed_rows = _jump_seed_rows(buckets, seeds, k)
    if bpad != b:
        seed_rows = seed_rows.at[b:].set(-1)     # pad lanes start inactive
    state, packed = _jump_walk(rows, seed_rows, num_steps)
    steps = np.asarray(state[2])[:b]
    saturated = (steps >= num_steps) & ~np.asarray(state[3])[:b]
    return (np.asarray(packed)[:b], np.asarray(state[3])[:b], steps,
            saturated, np.asarray(state[7])[:b], np.asarray(state[8])[:b])


def walk_forward_spec_chunked(buckets, seeds, k: int, num_steps: int,
                              chunk: int = 2048, sub: int = 64):
    """walk_forward_spec with early exit.

    Production walks run under a large safety cap (Partition defaults to a
    40 kb contig bound) but most walks die at their first junction, so a
    fixed-length scan wastes almost all its iterations on dead lanes.  Each
    host-level chunk here is ONE device dispatch (_spec_chunk_device) that
    internally while-loops over `sub`-length scans with a device-side
    all-lanes-retired exit; the host checks liveness once per `chunk`
    iterations.  Dead-lane compute stops at `sub` granularity while host
    sync latency is paid ~num_steps/chunk times.  Returns the same (bases [T, B], cycled, steps);
    T <= spec_iters(num_steps) rounded up to the executed sub-chunks, with
    unexecuted rows filled -1 (consumers skip negative codes).
    """
    state = _spec_init(seeds)
    total = spec_iters(num_steps)
    out = []
    done = 0
    while done < total:
        length = min(chunk, total - done)
        se = sub if length % sub == 0 else length
        state, bases, any_active, _ = _spec_chunk_device(
            buckets, state, k, num_steps, length, se)
        out.append(np.asarray(bases)[:length])
        done += length
        if not bool(np.asarray(any_active)):
            break
    cycled, emitcnt = state[4], state[3]
    return (np.concatenate(out, axis=0), np.asarray(cycled),
            np.asarray(emitcnt))
