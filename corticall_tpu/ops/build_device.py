"""Device graph construction: packed read streams -> sorted unique canonical
kmer table with coverage + edge masks, via XLA sort + segment reduction.

The McCortex-build replacement's DEVICE path (SURVEY §2.3: "2-bit pack
reads, device radix-sort k-mers, segment-reduce coverage/edges", replacing
`mccortex build -m 10G -k 47`, Simulate.wdl:620-666).  The host packs reads
at 2 bits/base plus a validity bitmap (so a chunk uploads near the
information floor); the device
extracts every window by bit arithmetic, derives window validity with one
cumsum, canonicalizes, sorts (lax.sort, multi-word lexicographic keys), and
segment-reduces coverage (sum) and edge masks (per-bit max == OR).  Chunks
merge into an on-device accumulator by concat+sort+reduce; only the final
table is transferred.  Output is bit-identical to the host/native counting
path (tests/test_build_device.py).

Chunking: reads are joined with k-long 'N' separators, so every chunk
boundary falls inside a separator and windows crossing it are invalid by
construction.  Sequences longer than a chunk are split into overlapping
pieces with an explicit window-ownership bitmap (each window counted by
exactly one piece; edge masks see the true neighbor bases through the
overlap).

It ships validated-but-not-default (CORTICALL_DEVICE_BUILD=1 or
build_graph_from_reads(use_device=True)): the single-thread C++ core
(native.py) is the default counting path until a chip measurement shows
this one faster end to end (not measured on the GPU yet).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import kmer_jax as kj
from .. import kmer as km

_SENT = np.uint32(0xFFFFFFFF)


def pack_stream(codes: np.ndarray) -> np.ndarray:
    """uint8 base codes (values 0..3) -> uint32 words, base p at bits
    (30 - 2*(p % 16)) of word p//16."""
    n = len(codes)
    npad = -(-n // 16) * 16
    c = np.zeros(npad, dtype=np.uint32)
    c[:n] = codes
    c = c.reshape(-1, 16)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    return (c << shifts[None, :]).astype(np.uint32).sum(axis=1,
                                                        dtype=np.uint32)


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """bool[n] -> uint32 words, bit i at bit (i % 32) of word i//32."""
    b = np.packbits(bits, bitorder="little")
    pad = -(-len(bits) // 32) * 4
    return np.pad(b, (0, pad - len(b))).view(np.uint32)


def _extract_base(stream, pos):
    q = (pos >> 4).astype(jnp.int32)
    r = (pos & 15).astype(jnp.uint32)
    return (stream[q] >> (jnp.uint32(30) - 2 * r)) & 3


@partial(jax.jit, static_argnames=("k", "n_windows"))
def _extract_windows(stream, base_valid_words, own_words, k: int,
                     n_windows: int):
    """Per-window packed canonical kmer + coverage + edge masks.

    base_valid_words: packed bool per stream base (ACGT and inside a read);
    own_words: packed bool per window (this chunk/piece owns it).  Window
    validity = owned AND all k bases valid (one cumsum)."""
    w = km.words_per_kmer(k)
    i = jnp.arange(n_windows, dtype=jnp.int32)

    def bit(words, idx):
        return ((words[idx >> 5] >> (idx & 31).astype(jnp.uint32)) & 1) != 0

    base_ok = bit(base_valid_words, i)            # stream base i valid
    bad = (~base_ok).astype(jnp.int32)
    bad_ps = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(bad)])
    # all k bases [i, i+k) valid <=> no invalid base in the range
    ik = jnp.minimum(i + k, n_windows)
    allk = (bad_ps[ik] - bad_ps[i]) == 0
    allk = allk & (i + k <= n_windows)
    valid = allk & bit(own_words, i)

    r = (2 * i & 31).astype(jnp.uint32)
    regs = []
    for j in range(w):
        q = (2 * i + 32 * j) >> 5
        hi = stream[jnp.minimum(q, stream.shape[0] - 1)]
        lo = stream[jnp.minimum(q + 1, stream.shape[0] - 1)]
        word = jnp.where(r > 0, (hi << r) | (lo >> ((32 - r) & 31)), hi)
        regs.append(word)
    s = 32 * w - 2 * k
    if s:
        out = []
        for j in range(w):
            word = regs[j] >> jnp.uint32(s)
            if j > 0:
                word = word | (regs[j - 1] << jnp.uint32(32 - s))
            out.append(word)
        regs = out
    regs[0] = regs[0] & kj.top_word_mask(k)
    windows = jnp.stack(regs, axis=1)

    canon, flipped = kj.canonicalize_words(windows, k)

    has_prev = valid & bit(base_valid_words, jnp.maximum(i - 1, 0)) & (i > 0)
    has_next = valid & bit(base_valid_words,
                           jnp.minimum(i + k, n_windows - 1)) & (
        i + k < n_windows)
    prev_b = _extract_base(stream, jnp.maximum(i - 1, 0))
    next_b = _extract_base(stream, jnp.minimum(i + k, n_windows - 1))
    fwd = ~flipped
    in_m = (jnp.where(fwd & has_prev, jnp.uint32(1) << prev_b, 0)
            | jnp.where(flipped & has_next, jnp.uint32(1) << (3 - next_b), 0))
    out_m = (jnp.where(fwd & has_next, jnp.uint32(1) << next_b, 0)
             | jnp.where(flipped & has_prev, jnp.uint32(1) << (3 - prev_b), 0))

    # invalid windows get the all-ones sentinel key (unreachable for a real
    # canonical kmer: all-T canonicalizes to all-A) and zero contributions
    canon = jnp.where(valid[:, None], canon, _SENT)
    cov = valid.astype(jnp.uint32)
    in_m = jnp.where(valid, in_m, 0)
    out_m = jnp.where(valid, out_m, 0)
    return canon, cov, in_m, out_m


@partial(jax.jit, static_argnames=("w",))
def _sort_reduce(keys, cov, in_m, out_m, w: int):
    """Sort rows lexicographically by the w key words and reduce equal-key
    segments: coverage sums, masks OR (per-bit segment max).  Returns
    (keys, cov, in_m, out_m, n_unique) with uniques packed at the front
    (tail rows hold the sentinel with zero coverage)."""
    ops = [keys[:, j] for j in range(w)] + [cov, in_m, out_m]
    sorted_ops = jax.lax.sort(ops, num_keys=w)
    sk = jnp.stack(sorted_ops[:w], axis=1)
    cov_s, in_s, out_s = sorted_ops[w], sorted_ops[w + 1], sorted_ops[w + 2]

    neq = jnp.ones(sk.shape[0], bool).at[1:].set(
        jnp.any(sk[1:] != sk[:-1], axis=1))
    seg = jnp.cumsum(neq) - 1
    n = sk.shape[0]
    ucov = jax.ops.segment_sum(cov_s, seg, num_segments=n)
    uin = jnp.zeros(n, jnp.uint32)
    uout = jnp.zeros(n, jnp.uint32)
    for b in range(4):
        uin = uin | (jax.ops.segment_max((in_s >> b) & 1, seg,
                                         num_segments=n) << b)
        uout = uout | (jax.ops.segment_max((out_s >> b) & 1, seg,
                                           num_segments=n) << b)
    ukeys = jnp.full_like(sk, jnp.uint32(_SENT)).at[seg].set(sk)
    n_unique = seg[-1] + 1
    return ukeys, ucov, uin, uout, n_unique


def _pow2(n: int, lo: int = 1 << 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class DeviceCounter:
    """Streaming kmer counter with an on-device sorted accumulator."""

    def __init__(self, k: int, chunk_bases: int = 1 << 25):
        self.k = k
        self.w = km.words_per_kmer(k)
        self.chunk_bases = chunk_bases
        self.acc = None
        self._reads: list = []
        self._pending = 0

    def add(self, seq: str) -> None:
        k, c = self.k, self.chunk_bases
        if len(seq) < k:
            return
        if len(seq) + k >= c:
            self._flush_reads()
            # long sequence: overlapping pieces, explicit window ownership
            stride = c - 2 * k
            for a in range(0, len(seq), stride):
                lo = max(0, a - 1)
                piece = seq[lo:a + c - k]
                own = np.zeros(len(piece), dtype=bool)
                o0 = a - lo
                o1 = min(a + stride, len(seq) - k + 1) - lo
                own[o0:max(o0, o1)] = True
                if own.any():
                    self._count_piece(piece, own)
                if a + stride >= len(seq) - k + 1:
                    break
            return
        if self._pending + len(seq) + k > c:
            self._flush_reads()
        self._reads.append(seq)
        self._pending += len(seq) + k

    def _flush_reads(self) -> None:
        if not self._reads:
            return
        joined = ("N" * self.k).join(self._reads)
        self._reads, self._pending = [], 0
        self._count_piece(joined, None)

    def _count_piece(self, seq: str, own: np.ndarray | None) -> None:
        c = self.chunk_bases
        codes = km.string_to_codes_permissive(seq)
        n = len(codes)
        base_valid = codes <= 3
        if own is None:
            own = np.ones(n, dtype=bool)
        pad = c - n
        if pad < 0:
            raise ValueError("piece exceeds chunk_bases")
        codes = np.concatenate([np.minimum(codes, 3).astype(np.uint8),
                                np.zeros(pad, np.uint8)])
        base_valid = np.concatenate([base_valid, np.zeros(pad, bool)])
        own = np.concatenate([own, np.zeros(pad, bool)])
        keys, cov, in_m, out_m = _extract_windows(
            jnp.asarray(pack_stream(codes)),
            jnp.asarray(_pack_bits(base_valid)),
            jnp.asarray(_pack_bits(own)), self.k, c)
        uk, uc, ui, uo, nu = _sort_reduce(keys, cov, in_m, out_m, self.w)
        self._merge(uk, uc, ui, uo, int(nu))

    def _merge(self, keys, cov, in_m, out_m, nu: int) -> None:
        cap = _pow2(nu)
        new = (keys[:cap], cov[:cap], in_m[:cap], out_m[:cap])
        if self.acc is None:
            self.acc = new
            self.acc_n = nu
            return
        ak, ac, ai, ao = self.acc
        mk = jnp.concatenate([ak, new[0]])
        mc = jnp.concatenate([ac, new[1]])
        mi = jnp.concatenate([ai, new[2]])
        mo = jnp.concatenate([ao, new[3]])
        uk, uc, ui, uo, nu2 = _sort_reduce(mk, mc, mi, mo, self.w)
        n2 = int(nu2)
        cap2 = _pow2(n2)
        self.acc = (uk[:cap2], uc[:cap2], ui[:cap2], uo[:cap2])
        self.acc_n = n2

    def finish(self):
        """-> (kmers uint32[N, w], cov uint32[N], in uint8[N], out uint8[N]),
        sorted unique canonical, sentinel rows dropped.  Coverage saturates
        at uint32 (the host path clamps identically)."""
        self._flush_reads()
        if self.acc is None:
            return (np.zeros((0, self.w), np.uint32), np.zeros(0, np.uint32),
                    np.zeros(0, np.uint8), np.zeros(0, np.uint8))
        uk, uc, ui, uo = self.acc
        keys = np.asarray(uk)
        cov = np.asarray(uc)
        in_m = np.asarray(ui).astype(np.uint8)
        out_m = np.asarray(uo).astype(np.uint8)
        real = (cov > 0) & ~np.all(keys == _SENT, axis=1)
        return keys[real], cov[real], in_m[real], out_m[real]


def count_kmers_device(sequences, k: int, chunk_bases: int = 1 << 25):
    """Device twin of build.count_kmers: same outputs, bit-identical."""
    c = DeviceCounter(k, chunk_bases)
    for seq in sequences:
        c.add(seq)
    return c.finish()
