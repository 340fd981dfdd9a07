"""Device Tesserae: the mosaic alignment DP as a jax scan over query positions.

The host oracle (models/tesserae.py) runs one vectorized numpy step per query
position; here the whole DP is a single `lax.scan` compiled by XLA — per step
a handful of fused [S, L+1] vector ops plus a cummax prefix scan for the
delete state — with the packed traceback emitted as scan outputs.  Traceback
decoding and segment reconstruction stay on host (O(L), trivial).

Batching over independent sections (the Call pipeline aligns many trimmed
queries per partition) is a vmap over this function.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..models import tesserae as tz

SMALL = -1e32
M, I, D = 1, 2, 3


@partial(jax.jit, static_argnames=("s_count", "width"))
def _tesserae_scan(q_codes, t_codes, valid, params, s_count: int, width: int,
                   q_len=None):
    """q_codes: int32[L1pad]; t_codes: int32[S, width-1]; valid: bool[S, width-1].

    params: (ldel, leps, lrho, lpiM, lpiI, lmm, lgm, ldm, lsize_l) float32[9]
    plus emission tables lsm float32[5,5], lsi float32[5] appended by caller.

    q_len (dynamic int32, default = L1pad): the real query length.  The scan
    always runs L1pad-1 steps but freezes all carries once i >= q_len, so one
    compiled kernel serves every query length in a shape bucket — the
    production Caller pads (q, width, s_count) to buckets to avoid a
    recompile per section (Call.java sections vary freely in size).

    Returns per-column packed tracebacks tb_m/tb_i/tb_d int32[L1pad-1, S,
    width] (rows past q_len-1 are garbage) and final (who, state, pos, max_r)
    frozen at column q_len.
    """
    (ldel, leps, lrho, lpiM, lpiI, lmm, lgm, ldm, lsize_l), lsm, lsi = params

    seq_ids = jnp.arange(1, s_count + 1, dtype=jnp.int32)[:, None]
    jj = jnp.arange(width, dtype=jnp.int32)[None, :]
    jpos = jnp.maximum(jj - 1, 0)
    vmask = jnp.concatenate(
        [jnp.zeros((s_count, 1), bool), valid], axis=1)

    def pack(who, state, pos):
        return (who << 25) | (state << 23) | pos

    def delete_scan(vm, min_j):
        adj = vm - leps * jj.astype(vm.dtype)
        adj = jnp.where(jj >= min_j - 1, adj, SMALL)
        run = jax.lax.cummax(adj, axis=1)
        run_prev = jnp.concatenate(
            [jnp.full((s_count, 1), SMALL, vm.dtype), run[:, :-1]], axis=1)
        vd = ldel + leps * (jj - 1).astype(vm.dtype) + run_prev
        vd = jnp.where(jj >= min_j, vd, SMALL)
        m_branch = jnp.concatenate(
            [jnp.full((s_count, 1), SMALL, vm.dtype), vm[:, :-1]], axis=1) + ldel
        d_branch = jnp.concatenate(
            [jnp.full((s_count, 1), SMALL, vm.dtype), vd[:, :-1]], axis=1) + leps
        state = jnp.where(m_branch >= d_branch, M, D).astype(jnp.int32)
        return vd, state

    def column_max(vm, vi):
        vmv = jnp.where(vmask, vm, SMALL)
        viv = jnp.where(vmask, vi, SMALL)
        inter = jnp.stack([vmv, viv], axis=2).reshape(s_count, -1)
        flat = jnp.argmax(inter)
        best = inter.reshape(-1)[flat]
        s_idx, rem = flat // (width * 2), flat % (width * 2)
        j, st = rem // 2, rem % 2
        return (s_idx + 1).astype(jnp.int32), jnp.where(st == 0, M, I).astype(jnp.int32), \
            j.astype(jnp.int32), best

    # column 1
    em0 = lsm[q_codes[0], t_codes]                        # [S, width-1]
    vm = jnp.full((s_count, width), SMALL)
    vi = jnp.full((s_count, width), SMALL)
    vm = vm.at[:, 1:].set(jnp.where(valid, lpiM - lsize_l + em0, SMALL))
    vi = vi.at[:, 1:].set(jnp.where(valid, lpiI - lsize_l + lsi[q_codes[0]], SMALL))
    vd, state_d = delete_scan(vm, 1)
    tb_d1 = pack(seq_ids, state_d, jpos)
    who, state, pos, max_r = column_max(vm, vi)

    l1 = q_codes.shape[0]
    if q_len is None:
        q_len = jnp.int32(l1)

    def step(carry, qc):
        vm, vi, vd, who, state, pos, max_r, i = carry
        live = i < q_len
        em = lsm[qc, t_codes]
        neg_col = jnp.full((s_count, 1), SMALL)

        cand = jnp.stack([
            jnp.concatenate([neg_col, vm[:, :-1]], axis=1) + lmm,
            jnp.concatenate([neg_col, vi[:, :-1]], axis=1) + lgm,
            jnp.concatenate([neg_col, vd[:, :-1]], axis=1) + ldm,
        ])
        local_arg = jnp.argmax(cand, axis=0)
        local_val = jnp.max(cand, axis=0)
        recomb = max_r + lrho + lpiM - lsize_l
        use_local = local_val > recomb
        nvm = jnp.where(use_local, local_val, recomb)
        tb_rec = pack(who, state, pos)
        tbm = jnp.where(use_local,
                        pack(seq_ids, (local_arg + 1).astype(jnp.int32), jpos),
                        tb_rec)
        nvm = nvm.at[:, 1:].set(jnp.where(valid, nvm[:, 1:] + em, SMALL))
        nvm = nvm.at[:, 0].set(SMALL)

        cand_i = jnp.stack([vm + ldel, vi + leps])
        arg_i = jnp.argmax(cand_i, axis=0)
        val_i = jnp.max(cand_i, axis=0)
        recomb_i = max_r + lrho + lpiI - lsize_l
        use_local_i = val_i > recomb_i
        nvi = jnp.where(use_local_i, val_i, recomb_i)
        tbi = jnp.where(use_local_i,
                        pack(seq_ids, (arg_i + 1).astype(jnp.int32), jj),
                        tb_rec)
        nvi = nvi.at[:, 1:].set(jnp.where(valid, nvi[:, 1:] + lsi[qc], SMALL))
        nvi = nvi.at[:, 0].set(SMALL)

        is_last = i >= q_len - 1
        nvd, state_d = delete_scan(nvm, 2)
        nvd = jnp.where(is_last, jnp.full_like(nvd, SMALL), nvd)
        tbd = pack(seq_ids, state_d, jpos)

        nwho, nstate, npos, nmax = column_max(nvm, nvi)
        # freeze everything once the real query is consumed (bucket padding)
        nvm = jnp.where(live, nvm, vm)
        nvi = jnp.where(live, nvi, vi)
        nvd = jnp.where(live, nvd, vd)
        nwho = jnp.where(live, nwho, who)
        nstate = jnp.where(live, nstate, state)
        npos = jnp.where(live, npos, pos)
        nmax = jnp.where(live, nmax, max_r)
        return (nvm, nvi, nvd, nwho, nstate, npos, nmax, i + 1), (tbm, tbi, tbd)

    carry0 = (vm, vi, vd, who, state, pos, max_r, jnp.int32(1))
    carry, (tbm_s, tbi_s, tbd_s) = jax.lax.scan(step, carry0, q_codes[1:])
    _, _, _, who_f, state_f, pos_f, max_f, _ = carry
    return tb_d1, tbm_s, tbi_s, tbd_s, who_f, state_f, pos_f, max_f


@jax.jit
def _tesserae_traceback(tb_d1, tbm_s, tbi_s, tbd_s, who, state, pos, q_len):
    """Walk the packed traceback ON DEVICE and return just the visited cells.

    The tb arrays are O(L*S*W) — materializing them on host costs a transfer
    of hundreds of MB per section (the profiled Call spent 10x more time in
    that transfer than in the DP).  The path itself is O(L + W) cells; this
    while_loop reproduces the host walk exactly (including the zero-packed
    column-1 M/I rows whose decode terminates the loop) and ships only
    cells int32[cap, 3] + count back.
    """
    width = tb_d1.shape[1]
    l1pad = tbm_s.shape[0] + 1
    cap = l1pad + width + 4

    cells0 = jnp.zeros((cap, 3), jnp.int32)
    cells0 = cells0.at[0].set(jnp.stack([who, state, pos]))

    def read(pt, who_, state_, pos_):
        r = jnp.maximum(pt - 2, 0)
        row_m = jnp.where(pt >= 2, tbm_s[r, who_ - 1, pos_], 0)
        row_i = jnp.where(pt >= 2, tbi_s[r, who_ - 1, pos_], 0)
        row_d = jnp.where(pt >= 2, tbd_s[r, who_ - 1, pos_],
                          tb_d1[who_ - 1, pos_])
        return jnp.where(state_ == M, row_m,
                         jnp.where(state_ == I, row_i, row_d))

    def cond(st):
        pt, _, _, _, n, _ = st
        return (pt >= 1) & (n < cap)

    def body(st):
        pt, who_, state_, pos_, n, cells = st
        tb = read(pt, who_, state_, pos_)
        who_n = tb >> 25
        state_n = (tb >> 23) & 3
        pos_n = tb & ((1 << 23) - 1)
        cells = cells.at[n].set(jnp.stack([who_n, state_n, pos_n]))
        pt = jnp.where(state_ != D, pt - 1, pt)
        return (pt, who_n, state_n, pos_n, n + 1, cells)

    _, _, _, _, n, cells = jax.lax.while_loop(
        cond, body, (q_len, who, state, pos, jnp.int32(1), cells0))
    return cells, n


@partial(jax.jit, static_argnames=("s_count", "width"))
def _tesserae_full(q_codes, t_codes, valid, params, s_count: int, width: int,
                   q_len):
    """Scan + traceback fused into one dispatch.

    Each blocking device→host sync pays a full round-trip, so returning
    (max_r, cells, n) from one jitted call lets align() fetch everything
    with a single device_get instead of three serialized syncs per align.
    """
    tb_d1, tbm_s, tbi_s, tbd_s, who, state, pos, max_r = _tesserae_scan(
        q_codes, t_codes, valid, params, s_count, width, q_len=q_len)
    cells, n = _tesserae_traceback(
        tb_d1, tbm_s, tbi_s, tbd_s, who, state, pos, q_len)
    return max_r, cells, n


def _bucket(n: int, lo: int = 64) -> int:
    """Shape bucket: next power of two at least lo — bounds the number of
    distinct compiles across arbitrarily-sized Call sections."""
    b = lo
    while b < n:
        b *= 2
    return b


class TesseraeDevice(tz.Tesserae):
    """Tesserae with the DP on device; traceback + segments on host.

    Produces the same segment output as the host oracle (validated in tests);
    tiny float tie-break differences are possible in principle but the
    tie-break ordering rules are identical.  Shapes are padded to power-of-two
    buckets (query length rides the scan as a dynamic arg) so the whole Call
    run costs a handful of compiles, not one per section.
    """

    # per-instance phase accounting: first call per (s_count, size) bucket
    # is charged to compile_s (compilation dominates it), later calls to
    # dispatch_s — the Call stage reports both so the device phase is
    # attributable.  device_sections / host_sections count the sections the
    # DP ran on the device and those HBM_BUDGET_BYTES routed to the host.
    compile_s = 0.0
    dispatch_s = 0.0
    device_sections = 0
    host_sections = 0

    # HBM budget for one section's DP+traceback state.  The fused kernel
    # holds ~4 int32 [s, W, Q] traceback arrays live; a pathological section
    # (e.g. a 32 kb query against 16 long targets) can demand tens of GB —
    # such sections fall back to the exact host oracle instead of OOMing the
    # chip (observed: s32[32767,16,32769] = 69 GB would-be allocation).
    HBM_BUDGET_BYTES = 2 << 30

    def align(self, query: str, targets: dict) -> list:
        if not targets or not query:
            raise ValueError("Tesserae.align requires a non-empty query and targets")
        import time as _time
        t_start = _time.perf_counter()
        names = list(targets.keys())
        seqs = [targets[n] for n in names]
        s_count = _bucket(len(seqs), 2)
        l1 = len(query)
        est_maxl = _bucket(max([l1] + [len(t) for t in seqs]))
        bucket_key = (s_count, est_maxl)
        if not hasattr(self, "_buckets_seen"):
            self._buckets_seen = set()
            self.compile_s = 0.0
            self.dispatch_s = 0.0
        est_bytes = 4 * 4 * (s_count + 1) * (est_maxl + 1) * (est_maxl + 1)
        if est_bytes > self.HBM_BUDGET_BYTES:
            self.host_sections += 1
            host = tz.Tesserae(self.del_, self.eps, self.rho, self.term)
            out = host.align(query, targets)
            self.llk = host.llk
            self.combined_llk += host.llk
            return out
        self.device_sections += 1
        # one shared size bucket for query padding and target width: sections
        # pair similar-length child/parent haplotypes, so coupling the two
        # dims costs little padding and halves the number of distinct
        # compiled kernels (keyed on (s_count, size) instead of
        # (s_count, qpad, maxl)) — compile time, not DP time, dominates the
        # Call stage's device phase
        maxl = _bucket(max([l1] + [len(t) for t in seqs]))
        qpad = maxl
        width = maxl + 1

        q = np.zeros(qpad, dtype=np.int32)
        q[:l1] = tz._seq_codes(query)
        q = jnp.asarray(q)
        t_codes = np.zeros((s_count, maxl), dtype=np.int32)
        t_len = np.zeros(s_count, dtype=np.int64)
        t_len[:len(seqs)] = [len(t) for t in seqs]
        for si, t in enumerate(seqs):
            t_codes[si, :len(t)] = tz._seq_codes(t)
        valid = (np.arange(1, maxl + 1)[None, :] <= t_len[:, None])

        size_l = float(t_len.sum())
        pi_m = 0.75
        scal = jnp.asarray([
            math.log(self.del_), math.log(self.eps), math.log(self.rho),
            math.log(pi_m), math.log(1 - pi_m),
            math.log(1 - 2 * self.del_ - self.rho - self.term),
            math.log(1 - self.eps - self.rho - self.term),
            math.log(1 - self.eps), math.log(size_l),
        ])
        params = (tuple(scal), jnp.asarray(np.log(tz.EMISS_MATCH_NT)),
                  jnp.asarray(np.log(tz.EMISS_GAP_NT)))

        # one dispatch, one sync: scan + device traceback fused, and the
        # O(L*S*W) tb arrays never leave HBM — only (llk, path, count)
        max_r, cells_arr, n = jax.device_get(_tesserae_full(
            q, jnp.asarray(t_codes), jnp.asarray(valid), params, s_count,
            width, jnp.int32(l1)))

        self.llk = float(max_r) + math.log(self.term)
        self.combined_llk += self.llk

        dt = _time.perf_counter() - t_start
        if bucket_key in self._buckets_seen:
            self.dispatch_s += dt
        else:
            self._buckets_seen.add(bucket_key)
            self.compile_s += dt

        n = int(n)
        cells = [tuple(int(x) for x in row) for row in cells_arr[:n - 1]]
        cells.reverse()
        return self._build_path(query, names, seqs, cells)
