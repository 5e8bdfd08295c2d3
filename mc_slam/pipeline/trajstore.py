"""Device-resident per-frame trajectory log.

The reference records one relative pose per tracked frame on the host
(mlRelativeFramePoses + reference-KF list, src/Tracking.cpp:1123-1134,
composed against final keyframe poses at save time, src/System.cpp:434-491).
A host list of device scalars would cost one blocking D2H round trip per
frame, so the rows live in fixed-size device buffers instead: the fused frame step
returns the row as device handles, the host appends the handle to a small
pending list, and every CHUNK frames ONE jitted program scatters the block
into the big buffers. The host never blocks; the only pulls are one per
buffer at save/rescale/reparent time (keyframe-rate or once per run).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

CHUNK = 64


@partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def _flush(Prel, Rrel, Pabs, Rabs, idx0, rows):
    """Scatter CHUNK pending rows into the big buffers at row idx0."""
    pr = jnp.stack([r[0] for r in rows])
    rr = jnp.stack([r[1] for r in rows])
    pa = jnp.stack([r[2] for r in rows])
    ra = jnp.stack([r[3] for r in rows])
    Prel = jax.lax.dynamic_update_slice(Prel, pr, (idx0, 0))
    Rrel = jax.lax.dynamic_update_slice(Rrel, rr, (idx0, 0, 0))
    Pabs = jax.lax.dynamic_update_slice(Pabs, pa, (idx0, 0))
    Rabs = jax.lax.dynamic_update_slice(Rabs, ra, (idx0, 0, 0))
    return Prel, Rrel, Pabs, Rabs


@partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def _write_one(Prel, Rrel, Pabs, Rabs, i, row):
    return (Prel.at[i].set(row[0]), Rrel.at[i].set(row[1]),
            Pabs.at[i].set(row[2]), Rabs.at[i].set(row[3]))


@partial(jax.jit, donate_argnums=(0, 2))
def _scale_p(Prel, s_rel, Pabs, s_abs):
    return Prel * s_rel, Pabs * s_abs


@partial(jax.jit, donate_argnums=(0, 1))
def _reparent(Prel, Rrel, mask, P_hk, R_hk):
    """Recompose rows (mask) from a culled anchor into its heir's frame:
    P' = P_hk + R_hk @ P, R' = R_hk @ R (KeyFrame::SetBadFlag parenting)."""
    P2 = P_hk + (R_hk @ Prel[..., None])[..., 0]
    R2 = R_hk @ Rrel
    sel = mask[:, None]
    return (jnp.where(sel, P2, Prel),
            jnp.where(sel[..., None], R2, Rrel))


class TrajStore:
    def __init__(self, cap: int = 1 << 14):
        assert cap % CHUNK == 0
        self.cap = cap
        self._alloc()
        self.pend: list = []          # device row handles awaiting flush
        self.meta: list = []          # (t, anchor_slot, anchor_kid) per row
        self.archive: list = []       # host np blocks from overflowed buffers

    def _alloc(self):
        self.Prel = jnp.zeros((self.cap, 3), jnp.float32)
        self.Rrel = jnp.tile(jnp.eye(3, dtype=jnp.float32), (self.cap, 1, 1))
        self.Pabs = jnp.zeros((self.cap, 3), jnp.float32)
        self.Rabs = jnp.tile(jnp.eye(3, dtype=jnp.float32), (self.cap, 1, 1))

    def __len__(self):
        return len(self.meta)

    @property
    def _n_dev(self):
        return len(self.meta) - sum(b[0].shape[0] for b in self.archive)

    def append(self, row, t, anchor_slot, anchor_kid):
        """row: (P_rel, R_rel, P_abs, R_abs) device handles."""
        self.pend.append(row)
        self.meta.append((t, anchor_slot, anchor_kid))
        if len(self.pend) == CHUNK:
            self._flush_pend()

    def pop_last(self):
        """Discard the most recent row (frame turned out LOST at harvest)."""
        if self.pend:
            self.pend.pop()
            self.meta.pop()

    def truncate(self, n_keep: int):
        """Drop every row at index >= n_keep (a LOST frame invalidates all
        rows dispatched after it). Device-buffer rows are overwritten
        positionally by subsequent appends."""
        drop = len(self.meta) - n_keep
        if drop <= 0:
            return
        for _ in range(min(drop, len(self.pend))):
            self.pend.pop()
        del self.meta[n_keep:]

    def replace_at(self, i: int, row):
        """Replace row i (a host-side fallback re-solved that frame)."""
        total = len(self.meta)
        pend_start = total - len(self.pend)
        if i >= pend_start:
            self.pend[i - pend_start] = row
        else:
            # device row index = meta index - number of archived rows
            n_arch = len(self.meta) - self._n_dev
            di = jnp.asarray(i - n_arch, jnp.int32)
            self.Prel, self.Rrel, self.Pabs, self.Rabs = _write_one(
                self.Prel, self.Rrel, self.Pabs, self.Rabs, di, row)

    def replace_last(self, row):
        """Replace the most recent row (host-side fallback re-solved it)."""
        self.replace_at(len(self.meta) - 1, row)

    def _flush_pend(self):
        n = len(self.pend)
        if not n:
            return
        idx0 = self._n_dev - n
        if idx0 + CHUNK > self.cap:
            # buffer full: archive to host and restart the device buffer
            self.archive.append((np.asarray(self.Prel[:idx0]),
                                 np.asarray(self.Rrel[:idx0]),
                                 np.asarray(self.Pabs[:idx0]),
                                 np.asarray(self.Rabs[:idx0])))
            self._alloc()
            idx0 = 0
            # meta bookkeeping is positional; _n_dev now counts from 0 again
        rows = list(self.pend)
        if n < CHUNK:           # final partial flush: pad with the last row
            rows = rows + [rows[-1]] * (CHUNK - n)
        self.Prel, self.Rrel, self.Pabs, self.Rabs = _flush(
            self.Prel, self.Rrel, self.Pabs, self.Rabs,
            jnp.asarray(idx0, jnp.int32), tuple(rows))
        self.pend = []

    def flush(self):
        self._flush_pend()

    def rescale(self, s: float):
        """Multiply every recorded translation by s (VI-init metric rescale,
        Map::UpdateScale analog for the saved-frame list)."""
        self.flush()
        sj = jnp.asarray(s, jnp.float32)
        self.Prel, self.Pabs = _scale_p(self.Prel, sj, self.Pabs, sj)
        self.archive = [(p * s, r, pa * s, ra)
                        for (p, r, pa, ra) in self.archive]

    def reparent(self, slot: int, kid: int, heir: int, heir_kid: int,
                 P_hk: np.ndarray, R_hk: np.ndarray):
        """Re-anchor rows whose anchor keyframe (slot, kid) was culled onto
        its heir: compose the stored relative pose through the heir frame."""
        self.flush()
        hit = [i for i, (_, k, kd) in enumerate(self.meta)
               if k == slot and kd == kid]
        if not hit:
            return
        n_arch = sum(b[0].shape[0] for b in self.archive)
        mask = np.zeros(self.cap, bool)
        for i in hit:
            if i >= n_arch:
                mask[i - n_arch] = True
            else:       # row lives in a host archive block
                off = i
                for bi, b in enumerate(self.archive):
                    if off < b[0].shape[0]:
                        p, r, pa, ra = b
                        p[off] = P_hk + R_hk @ p[off]
                        r[off] = R_hk @ r[off]
                        break
                    off -= b[0].shape[0]
            self.meta[i] = (self.meta[i][0], heir, heir_kid)
        if mask.any():
            self.Prel, self.Rrel = _reparent(
                self.Prel, self.Rrel, jnp.asarray(mask),
                jnp.asarray(P_hk, jnp.float32), jnp.asarray(R_hk, jnp.float32))

    def compose(self, kf_P, kf_R, kf_id, kf_active):
        """[(t, P, R)] composed against FINAL keyframe poses; rows whose
        anchor died keep their track-time absolute pose."""
        self.flush()
        blocks = self.archive + [(np.asarray(self.Prel), np.asarray(self.Rrel),
                                  np.asarray(self.Pabs), np.asarray(self.Rabs))]
        prel = np.concatenate([b[0] for b in blocks])
        rrel = np.concatenate([b[1] for b in blocks])
        pabs = np.concatenate([b[2] for b in blocks])
        rabs = np.concatenate([b[3] for b in blocks])
        out = []
        for i, (t, k, kid) in enumerate(self.meta):
            if k >= 0 and kf_active[k] and kf_id[k] == kid:
                out.append((t, kf_P[k] + kf_R[k] @ prel[i], kf_R[k] @ rrel[i]))
            else:
                out.append((t, pabs[i], rabs[i]))
        return out
