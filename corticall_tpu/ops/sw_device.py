"""Batched banded Smith-Waterman on device (a jax scan over query rows).

The bwa-mem-replacement extension stage at scale: B alignments advance in
lockstep, one query row per step, the band held as the minor array axis.
Affine horizontal gaps are computed in closed form per row — a max-plus
prefix scan with constant extension (E[c] = max_{t<c} H[t] - open -
(c-t)*ext) — which captures every gap run in a single pass, so no Farrar
lazy-F loop is needed.

`banded_sw_scores` is validated against the host Gotoh oracle
(models/sw.py) and returns the best local score and its (query, subject)
end position; cigars for surviving candidates come from the host Gotoh on
the banded window.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..models.sw import GAP_EXTEND, GAP_OPEN, MATCH, MISMATCH

NEG = -1e30


def _pad_subject(s_codes, qmax: int, band: int):
    """Pad so row i reads padded[:, i : i+band] (subject cols i-half..i+half-1)."""
    b, smax = s_codes.shape
    half = band // 2
    width = qmax + band
    out = jnp.full((b, width), 4, dtype=s_codes.dtype)
    out = jax.lax.dynamic_update_slice(out, s_codes[:, :min(smax, width - half)],
                                       (0, half))
    return out


def _row_update(h_prev, f_prev, qc_i, s_win, jj, smax, cc):
    """One query row of the banded recurrence.  h_prev/f_prev/s_win:
    [B, W]; jj: subject columns of this row's band cells; cc: float iota
    [1, W]."""
    b, w = h_prev.shape
    valid = (jj >= 0) & (jj < smax)
    # the virtual zero column (jj == -1) must read 0, not NEG: it is the
    # diagonal feed for next row's j == 0 cells (a local alignment may start
    # at subject position 0 on any query row)
    fill = jnp.where(jj == -1, 0.0, NEG)
    sub = jnp.where((qc_i[:, None] == s_win) & (qc_i[:, None] < 4), MATCH, MISMATCH)

    neg_col = jnp.full((b, 1), NEG, h_prev.dtype)
    shift_up = jnp.concatenate([h_prev[:, 1:], neg_col], axis=1)
    f = jnp.maximum(
        jnp.concatenate([f_prev[:, 1:], neg_col], axis=1) - GAP_EXTEND,
        shift_up - GAP_OPEN - GAP_EXTEND)
    h = jnp.maximum(jnp.maximum(h_prev + sub, f), 0.0)
    h = jnp.where(valid, h, fill)

    # E[c] = max_{t<c}(h[t] - open - (c-t)*ext) = max_t(h[t] + ext*t) - ext*c - open
    adj = jnp.where(valid, h, NEG) + GAP_EXTEND * cc
    run = jax.lax.cummax(adj, axis=1)
    run_prev = jnp.concatenate([neg_col, run[:, :-1]], axis=1)
    e = run_prev - GAP_EXTEND * cc - GAP_OPEN
    h = jnp.where(valid, jnp.maximum(jnp.maximum(h, e), 0.0), fill)
    return h, f


@partial(jax.jit, static_argnames=("band",))
def banded_sw_scores(q_codes, s_codes, band: int = 128):
    """q_codes/s_codes: int32[B, QMAX]/[B, SMAX] (4 = pad/N).

    Returns (score f32[B], q_end i32[B], s_end i32[B]): best local-alignment
    cell inside the band, ends 1-based inclusive.
    """
    bsz, qmax = q_codes.shape
    smax = s_codes.shape[1]
    w = band
    half = band // 2
    s_pad = _pad_subject(s_codes, qmax, band)
    cc = jnp.arange(w, dtype=jnp.float32)[None, :]
    lane = jnp.arange(w, dtype=jnp.int32)

    def step(carry, i):
        h_prev, f_prev, best, bq, bs = carry
        qc_i = jnp.where(i < qmax, q_codes[:, jnp.minimum(i, qmax - 1)], 4)
        s_win = jax.lax.dynamic_slice(s_pad, (0, i), (bsz, w))
        jj = i - half + lane
        h, f = _row_update(h_prev, f_prev, qc_i, s_win, jj[None, :], smax, cc)
        row_best = jnp.max(h, axis=1)
        row_arg = jnp.argmax(h, axis=1).astype(jnp.int32)
        improved = row_best > best
        best = jnp.where(improved, row_best, best)
        bq = jnp.where(improved, i + 1, bq)
        bs = jnp.where(improved, i - half + row_arg + 1, bs)
        return (h, f, best, bq, bs), None

    jj0 = -half + lane
    h0 = jnp.broadcast_to(jnp.where(jj0 >= 0, 0.0, NEG), (bsz, w))
    f0 = jnp.full((bsz, w), NEG)
    init = (h0, f0, jnp.zeros(bsz), jnp.zeros(bsz, jnp.int32),
            jnp.zeros(bsz, jnp.int32))
    (_, _, best, bq, bs), _ = jax.lax.scan(step, init, jnp.arange(qmax))
    return best, bq, bs


def codes_batch(strings, width: int) -> np.ndarray:
    """Pack strings into int32[B, width] codes padded with 4."""
    from .. import kmer as km
    out = np.full((len(strings), width), 4, dtype=np.int32)
    for i, s in enumerate(strings):
        c = km.string_to_codes_permissive(s)[:width]
        out[i, :len(c)] = c
    return out
