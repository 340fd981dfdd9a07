"""Device-side packed k-mer operations (jax, uint32 lanes).

The device counterpart of kmer.py: all ops work on 2-bit-packed
uint32[..., W] kmer words (W = ceil(k/16), right-aligned, word 0 most
significant — see kmer.py for the layout).  32-bit lanes only: no strings,
no uint64 (x64 mode stays off), no data-dependent shapes.

Replaces the reference's per-kmer ASCII round-trips (CortexRecord string
decode on every neighbor probe, TraversalUtils.java:510-558) with pure bit
arithmetic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

import numpy as _np

U32 = jnp.uint32
# NB: these stay host (numpy) scalars, not jnp arrays.  A module-level
# jnp.uint32(...) is a COMMITTED device array, and a jit that captures it
# as a closure constant embeds a device buffer in every program instead of
# an inline literal.
_M33 = _np.uint32(0x33333333)
_M0F = _np.uint32(0x0F0F0F0F)
_MFF = _np.uint32(0x00FF00FF)


def _words(k: int) -> int:
    return (k + 15) // 16


def top_word_mask(k: int) -> jnp.ndarray:
    """Mask for the (partially filled) most-significant word."""
    w = _words(k)
    used = 2 * k - 32 * (w - 1)  # bits used in word 0, in (0, 32]
    return U32(0xFFFFFFFF) if used >= 32 else U32((1 << used) - 1)


def reverse_pairs32(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the sixteen 2-bit groups within each uint32."""
    x = ((x & _M33) << 2) | ((x >> 2) & _M33)
    x = ((x & _M0F) << 4) | ((x >> 4) & _M0F)
    x = ((x & _MFF) << 8) | ((x >> 8) & _MFF)
    x = (x << 16) | (x >> 16)
    return x


def revcomp_words(words: jnp.ndarray, k: int) -> jnp.ndarray:
    """Reverse complement of packed kmers: complement (= bitwise NOT of every
    2-bit code) + reverse base order + realign right."""
    w = _words(k)
    comp = (~words).astype(U32)
    rev = reverse_pairs32(comp)[..., ::-1]  # value now left-aligned in W*32 bits
    s = 32 * w - 2 * k                      # right realignment shift, in [0, 32)
    if s == 0:
        out = rev
    else:
        carry = jnp.concatenate(
            [jnp.zeros_like(rev[..., :1]), rev[..., :-1]], axis=-1)
        out = (rev >> U32(s)) | (carry << U32(32 - s))
    # mask the top word (complement may have set bits above the kmer)
    mask = jnp.concatenate(
        [jnp.full_like(out[..., :1], top_word_mask(k)),
         jnp.full_like(out[..., 1:], U32(0xFFFFFFFF))], axis=-1)
    return out & mask


def lex_less(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a < b under big-to-little word tuple comparison. a, b: uint32[..., W]."""
    w = a.shape[-1]
    lt = jnp.zeros(a.shape[:-1], dtype=bool)
    decided = jnp.zeros(a.shape[:-1], dtype=bool)
    for i in range(w):
        ai, bi = a[..., i], b[..., i]
        lt = jnp.where(~decided & (ai < bi), True, lt)
        decided = decided | (ai != bi)
    return lt


def canonicalize_words(words: jnp.ndarray, k: int):
    """(canonical words, flipped) — alphanumerically-lowest orientation."""
    rc = revcomp_words(words, k)
    flipped = lex_less(rc, words)
    canon = jnp.where(flipped[..., None], rc, words)
    return canon, flipped


def shift_append(words: jnp.ndarray, base: jnp.ndarray, k: int) -> jnp.ndarray:
    """Next kmer: drop the first base, append `base` (uint32[...]) at the end."""
    carry = jnp.concatenate(
        [words[..., 1:], jnp.zeros_like(words[..., :1])], axis=-1)
    out = (words << U32(2)) | (carry >> U32(30))
    out = out.at[..., -1].set((words[..., -1] << U32(2)) | base.astype(U32))
    mask = jnp.concatenate(
        [jnp.full_like(out[..., :1], top_word_mask(k)),
         jnp.full_like(out[..., 1:], U32(0xFFFFFFFF))], axis=-1)
    return out & mask


def _shl32(x: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """x << n with n possibly >= 32 (result 0) — XLA shifts are undefined
    past the bit width, so clamp the amount and select."""
    return jnp.where(n >= U32(32), U32(0), x << (n & U32(31)))


def _shr32(x: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(n >= U32(32), U32(0), x >> (n & U32(31)))


def shift_append_multi(words: jnp.ndarray, hi24: jnp.ndarray,
                       lo24: jnp.ndarray, m: jnp.ndarray,
                       k: int) -> jnp.ndarray:
    """Append m (per-lane, 0..24) bases in one step — equivalent to m
    repetitions of shift_append.  The bases arrive packed big-endian in two
    24-bit fields: hi24 holds b0..b11 (b0 in bits 23..22), lo24 holds
    b12..b23; only the first m are appended.  This is the jump primitive of
    the run-table walk kernel (ops/cuckoo.walk_forward_runs): one gathered
    unitig run advances the cursor m k-mers.
    """
    w = words.shape[-1]
    s = (2 * m).astype(U32)[..., None]           # shift in bits, [..., 1]
    # 48-bit appended field F: b0 at bits 47..46
    f_hi = (hi24 >> U32(8)).astype(U32)                       # bits 47..32
    f_lo = (((hi24 & U32(0xFF)) << U32(24)) | lo24).astype(U32)  # bits 31..0
    r = U32(48) - s[..., 0]
    a_lo = jnp.where(r < U32(32),
                     _shr32(f_lo, r) | _shl32(f_hi, U32(32) - r),
                     _shr32(f_hi, r - U32(32)))
    a_hi = jnp.where(r < U32(32), _shr32(f_hi, r), U32(0))

    # multi-word left shift of the kmer by s bits (s <= 48)
    cols = []
    for i in range(w):
        v = _shl32(words[..., i], s[..., 0])
        if i + 1 < w:
            v = v | jnp.where(s[..., 0] >= U32(32),
                              _shl32(words[..., i + 1], s[..., 0] - U32(32)),
                              _shr32(words[..., i + 1], U32(32) - s[..., 0]))
        if i + 2 < w:
            v = v | _shr32(words[..., i + 2], U32(64) - s[..., 0])
        cols.append(v)
    cols[w - 1] = cols[w - 1] | a_lo
    if w >= 2:
        cols[w - 2] = cols[w - 2] | a_hi
    out = jnp.stack(cols, axis=-1)
    mask = jnp.concatenate(
        [jnp.full_like(out[..., :1], top_word_mask(k)),
         jnp.full_like(out[..., 1:], U32(0xFFFFFFFF))], axis=-1)
    return out & mask


def shift_prepend(words: jnp.ndarray, base: jnp.ndarray, k: int) -> jnp.ndarray:
    """Prev kmer: drop the last base, prepend `base` at the front."""
    w = words.shape[-1]
    carry = jnp.concatenate(
        [jnp.zeros_like(words[..., :1]), words[..., :-1]], axis=-1)
    out = (words >> U32(2)) | (carry << U32(30))
    p = 2 * (k - 1)
    wi = w - 1 - p // 32
    out = out.at[..., wi].set(out[..., wi] | (base.astype(U32) << U32(p % 32)))
    return out


def first_base(words: jnp.ndarray, k: int) -> jnp.ndarray:
    """Code of the first (5'-most) base."""
    w = words.shape[-1]
    p = 2 * (k - 1)
    return (words[..., w - 1 - p // 32] >> U32(p % 32)) & U32(3)


def last_base(words: jnp.ndarray) -> jnp.ndarray:
    return words[..., -1] & U32(3)


# ---------------------------------------------------------------------------
# hashing (identical in numpy, see ops/hashtable.py)
# ---------------------------------------------------------------------------

def mix32(x: jnp.ndarray) -> jnp.ndarray:
    """Murmur3-style finalizer avalanche on uint32."""
    x = x ^ (x >> U32(16))
    x = x * U32(0x7FEB352D)
    x = x ^ (x >> U32(15))
    x = x * U32(0x846CA68B)
    x = x ^ (x >> U32(16))
    return x


def hash_words(words: jnp.ndarray) -> jnp.ndarray:
    """uint32[..., W] -> uint32[...] hash (word-order sensitive)."""
    h = jnp.full(words.shape[:-1], U32(0x811C9DC5))
    for i in range(words.shape[-1]):
        h = mix32(h ^ words[..., i]) * U32(0x01000193)
    return mix32(h)


def popcount4(mask: jnp.ndarray) -> jnp.ndarray:
    """Population count of a 4-bit base mask."""
    m = mask.astype(jnp.int32)
    return (m & 1) + ((m >> 1) & 1) + ((m >> 2) & 1) + ((m >> 3) & 1)


def lowest_set_base(mask: jnp.ndarray) -> jnp.ndarray:
    """Index (0-3) of the lowest set bit of a base mask (undefined if 0)."""
    m = mask.astype(jnp.int32)
    return jnp.where(m & 1, 0, jnp.where(m & 2, 1, jnp.where(m & 4, 2, 3))).astype(jnp.int32)
