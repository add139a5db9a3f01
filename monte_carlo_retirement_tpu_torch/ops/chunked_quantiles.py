"""Exact quantiles over data too large to hold at once: additive-count
bisection driven from the host.

The port's copy of the JAX package's ``ops/chunked_quantiles.py`` (which
imports only numpy; the port imports nothing of the JAX package). The
chunked runner (``engine/runner.py::Engine._run_banded``) simulates a run
larger than the device's path budget in chunks and must reduce the per-year
percentile tables over ALL paths while holding one chunk's yearly series at
a time. Quantile selection needs only ``count(x <= v)``, which is additive
across chunks, and a chunk is cheap to re-simulate deterministically (the
kernels' global-block Philox stream makes chunk ``c``'s paths a pure
function of (seed, block offset)). So the k-th order statistic over all
paths falls out of a host-driven search over the float32 ordered-key space:

  * Round: every unresolved (column, rank) splits its key interval into
    ``E`` sub-intervals. One pass over the chunks (re-simulate, count on the
    device, accumulate on the host) gives exact global counts at every edge;
    each target rank picks the sub-interval its count crossing lies in.
  * One final pass fetches the ceil neighbour: count-at-floor plus the
    smallest entry above the floor, both additive, for the interpolation.

The tables equal ``ops/quantiles.py::quantiles_percol`` on the same data:
the search returns the smallest ordered key whose ``count(x <= key)``
reaches the target rank (the floor order statistic, as a value; -0.0 and
+0.0 compare equal and either may come out), and :meth:`BandSearch.
interpolate` applies ``quantiles_percol``'s own arithmetic: the float32 rank
``h = f32(q) * f32(n_valid - 1)``, ``hi = min(lo + 1, n_valid - 1)`` and
numpy's two-branch lerp, with no zero-band snap (the JAX package's snap
mirrors its TPU's denormal-flushing compares; torch compares exactly).
:func:`snap_zero_band` is that snap, for callers that want JAX's answer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_SIGN = np.uint32(0x80000000)
# Ordered keys of the two infinities: every finite float (and nothing
# else — the NaN code space lies outside) maps strictly between them, so
# intervals clipped to this range always decode to comparable floats.
KEY_NEG_INF = np.uint32(0x007FFFFF)  # fold of 0xFF800000 (-inf)
KEY_POS_INF = np.uint32(0xFF800000)  # fold of 0x7F800000 (+inf)


def encode_keys(x: np.ndarray) -> np.ndarray:
    """float32 -> ordered uint32 key."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return np.where(bits & _SIGN, ~bits, bits | _SIGN)


def decode_keys(keys: np.ndarray) -> np.ndarray:
    """Ordered uint32 key -> float32 (inverse of :func:`encode_keys`)."""
    keys = np.asarray(keys, dtype=np.uint32)
    was_neg = (keys & _SIGN) == 0
    bits = np.where(was_neg, ~keys, keys ^ _SIGN)
    return np.ascontiguousarray(bits).view(np.float32)


def snap_zero_band(out: np.ndarray) -> np.ndarray:
    """Collapse subnormal-magnitude float32 results (and -0.0) to +0.0:
    the JAX package's numpy snap (its device compares read every key of
    the subnormal band as 0.0, so the band's exact answer is zero)."""
    return np.where(
        np.abs(out) < np.finfo(np.float32).tiny,
        np.zeros((), np.float32), out,
    )


class BandSearch:
    """Multi-round exact order-statistic search over chunk-streamed data.

    The caller owns the data passes; this object owns the bookkeeping::

        search = BandSearch(qs_parts, n_valid_parts, edges_per_rank=E)
        while not search.resolved:
            edges = search.edges()           # list of (C_i, K_i*E) f32
            counts = 0
            for chunk in chunks:             # re-simulate + count
                counts += count_le(chunk, edges)
            search.update(counts)            # pick sub-intervals
        v_lo = search.floor_values()         # list of (C_i, K_i) f32
        cnt_le, gt_min = accumulate over chunks at v_lo
        tables = search.interpolate(cnt_le, gt_min)   # list of (K_i, C_i)

    The counts must use the compare semantics of the final consumer:
    masked entries (withdrawal-rate NaNs) count as +inf, as in
    ``ops/stats.series_summary``.
    """

    def __init__(
        self,
        qs_parts: Sequence[np.ndarray],
        n_valid_parts: Sequence[np.ndarray],
        edges_per_rank: int = 32,
    ):
        if edges_per_rank < 2:
            raise ValueError("edges_per_rank must be >= 2")
        self._E = int(edges_per_rank)
        self._shapes = []
        h_all, nv_all = [], []
        for qs, n_valid in zip(qs_parts, n_valid_parts):
            qs = np.asarray(qs, dtype=np.float32)
            n_valid = np.asarray(n_valid, dtype=np.int64)
            C, K = n_valid.shape[0], qs.shape[0]
            self._shapes.append((C, K))
            # quantiles_percol's rank: an f32 product of f32(q) and
            # f32(n_valid - 1).
            nv_f = np.maximum(n_valid - 1, 0).astype(np.float32)
            h = (qs[None, :] * nv_f[:, None]).astype(np.float32)
            h_all.append(h.reshape(-1))
            nv_all.append(np.broadcast_to(n_valid[:, None], (C, K)).reshape(-1))
        h = np.concatenate(h_all)
        self._n_valid = np.concatenate(nv_all)
        self._last = np.maximum(self._n_valid - 1, 0)
        # floor(h) never exceeds n_valid - 1 for q < 1 (and for q = 1 on an
        # unmasked column, where quantiles_percol's own clamp gives the same).
        self._lo_rank = np.minimum(np.floor(h).astype(np.int64), self._last)
        self._frac = (h - self._lo_rank.astype(np.float32)).astype(np.float32)
        self._need = self._lo_rank + 1
        n_total = h.shape[0]
        self._lo = np.full(n_total, np.uint64(KEY_NEG_INF), dtype=np.uint64)
        self._hi = np.full(n_total, np.uint64(KEY_POS_INF), dtype=np.uint64)
        self.rounds = 0

    # -- optional warm start ---------------------------------------------
    def seed_intervals(
        self,
        lo_parts: Sequence[np.ndarray],
        hi_parts: Sequence[np.ndarray],
    ) -> None:
        """Shrink the initial search intervals to a caller-proven bracket.

        ``lo_parts``/``hi_parts`` are per-part ``(C_i, K_i)`` float32 VALUES
        with the containment guarantee ``count(x <= v) < need`` for every v
        strictly below ``lo`` (in key order) and ``count(x <= hi) >= need``
        — e.g. the min/max over chunks of per-chunk order statistics at
        margin-padded ranks (see :func:`bracket_ranks`; the chunked runner's
        use). Seeding never changes the answer (the search converges to the
        same smallest satisfying key from any containing interval); it only
        removes rounds. Entries with an inverted bracket (all-empty columns,
        where per-chunk statistics degenerate to +inf/-inf) fall back to the
        full unseeded interval. Must be called before the first
        :meth:`update`.
        """
        if self.rounds:
            raise RuntimeError("seed_intervals() after the search started")
        lo_flat, hi_flat = [], []
        for (C, K), lo, hi in zip(self._shapes, lo_parts, hi_parts):
            lo = np.asarray(lo, dtype=np.float32)
            hi = np.asarray(hi, dtype=np.float32)
            if lo.shape != (C, K) or hi.shape != (C, K):
                raise ValueError(
                    f"bracket shape {lo.shape}/{hi.shape} != part {(C, K)}"
                )
            lo_flat.append(encode_keys(lo).reshape(-1))
            hi_flat.append(encode_keys(hi).reshape(-1))
        lo_k = np.concatenate(lo_flat).astype(np.uint64)
        hi_k = np.concatenate(hi_flat).astype(np.uint64)
        lo_k = np.clip(lo_k, np.uint64(KEY_NEG_INF), np.uint64(KEY_POS_INF))
        hi_k = np.clip(hi_k, np.uint64(KEY_NEG_INF), np.uint64(KEY_POS_INF))
        bad = lo_k > hi_k
        self._lo = np.where(bad, np.uint64(KEY_NEG_INF), lo_k)
        self._hi = np.where(bad, np.uint64(KEY_POS_INF), hi_k)

    # -- round protocol -------------------------------------------------
    @property
    def resolved(self) -> bool:
        return bool(np.all(self._lo == self._hi))

    def _flat_edges(self) -> np.ndarray:
        """(n_total, E) uint64 probe keys: p_m = lo + span*m//E (p_0=lo)."""
        span = self._hi - self._lo
        m = np.arange(self._E, dtype=np.uint64)
        return self._lo[:, None] + (span[:, None] * m[None, :]) // np.uint64(
            self._E
        )

    def edges(self) -> list[np.ndarray]:
        """Per-part probe VALUES for the count pass, (C_i, K_i*E) float32
        (resolved entries repeat their answer; extra counts are ignored by
        :meth:`update`)."""
        probes = decode_keys(self._flat_edges().astype(np.uint32))
        out, at = [], 0
        for C, K in self._shapes:
            n = C * K
            out.append(probes[at: at + n].reshape(C, K * self._E))
            at += n
        return out

    def update(self, counts: Sequence[np.ndarray]) -> None:
        """Consume one full pass's accumulated counts (per part,
        (C_i, K_i*E) int) and shrink every interval."""
        flat = np.concatenate(
            [
                np.asarray(c, dtype=np.int64).reshape(C * K, self._E)
                for c, (C, K) in zip(counts, self._shapes)
            ]
        )
        probes = self._flat_edges()
        hit = flat >= self._need[:, None]  # monotone along the probe axis
        first = np.argmax(hit, axis=1)  # first satisfying probe (0 if none)
        any_hit = hit[np.arange(hit.shape[0]), first]
        act = self._lo != self._hi
        rows = np.arange(probes.shape[0])
        # No probe reached the target: the answer is past the last probe.
        new_lo = np.where(
            any_hit,
            np.where(
                first > 0,
                probes[rows, np.maximum(first - 1, 0)] + np.uint64(1),
                self._lo,
            ),
            probes[:, -1] + np.uint64(1),
        )
        new_hi = np.where(any_hit, probes[rows, first], self._hi)
        self._lo = np.where(act, new_lo, self._lo)
        self._hi = np.where(act, new_hi, self._hi)
        self.rounds += 1
        if self.rounds > 64:  # at least one bit per round; cannot happen
            raise RuntimeError("band search failed to converge")

    # -- finish protocol ------------------------------------------------
    def floor_values(self) -> list[np.ndarray]:
        """After resolution: the floor order statistics, (C_i, K_i) f32."""
        if not self.resolved:
            raise RuntimeError("floor_values() before the search resolved")
        vals = decode_keys(self._lo.astype(np.uint32))
        out, at = [], 0
        for C, K in self._shapes:
            n = C * K
            out.append(vals[at: at + n].reshape(C, K))
            at += n
        return out

    def interpolate(
        self,
        cnt_le_parts: Sequence[np.ndarray],
        gt_min_parts: Sequence[np.ndarray],
    ) -> list[np.ndarray]:
        """The final (K_i, C_i) tables from the ceil pass's accumulated
        count-at-floor and min-above-floor, with ``quantiles_percol``'s
        arithmetic: the ceil rank ``min(lo + 1, n_valid - 1)``, its value
        the floor's when the floor value repeats (count-at-floor reaches
        lo + 2) and the smallest entry above the floor otherwise; then
        ``a + (b-a)*t``, or ``b - (b-a)*(1-t)`` from t >= 0.5 on, in
        float32; NaN for a column without valid entries."""
        v_lo_parts = self.floor_values()
        out, at = [], 0
        one = np.float32(1.0)
        for (C, K), a, cnt_le, gt_min in zip(
            self._shapes, v_lo_parts, cnt_le_parts, gt_min_parts
        ):
            n = C * K
            lo_rank = self._lo_rank[at: at + n].reshape(C, K)
            t = self._frac[at: at + n].reshape(C, K)
            last = self._last[at: at + n].reshape(C, K)
            n_valid = self._n_valid[at: at + n].reshape(C, K)
            at += n
            dup = np.asarray(cnt_le, np.int64) >= lo_rank + 2
            b = np.where(dup, a, np.asarray(gt_min, np.float32))
            b = np.where(lo_rank < last, b, a).astype(np.float32)
            # errstate: a discarded branch may compute inf - inf.
            with np.errstate(invalid="ignore", over="ignore"):
                diff = b - a
                v = np.where(t >= np.float32(0.5), b - diff * (one - t),
                             a + diff * t).astype(np.float32)
            v = np.where(n_valid > 0, v, np.float32(np.nan))
            out.append(v.T.astype(np.float32))
        return out


def bracket_ranks(
    qs: np.ndarray, n_valid: np.ndarray, margin: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-chunk 0-indexed ranks whose order statistics bracket the GLOBAL
    order statistic the BandSearch targets.

    For global rank ``need_g = floor(q*(nv_g-1)) + 1`` over C chunks with
    per-chunk valid counts ``nv_c`` (``nv_g = sum nv_c``), let ``x_c(k)``
    be chunk c's k-th (0-indexed) smallest valid entry under the count
    semantics of the search, and::

        lo_c = clamp(floor(q*(nv_c-1)) - margin, 0, nv_c-1)
        hi_c = clamp(ceil (q*(nv_c-1)) + margin, 0, nv_c-1)

    Then with ``margin >= C + 8`` (absorbing every f32-rounding discrepancy
    between this h and the search's own f32 h):

      * Upper containment: ``count_g(max_c x_c(hi_c)) >= sum_c
        min(h_c+1, nv_c) >= h_g - q*(C-1) + C >= need_g`` — at the max
        every chunk counts at least its own bracketed rank (or its whole
        valid set when clamped), and ``C*(1-q) + q >= 1`` closes the gap.
      * Lower containment: for any v strictly below ``min_c x_c(lo_c)``,
        ``count_c(v) <= lo_c`` per chunk, and ``sum_c floor(h_c) <=
        floor(sum_c h_c) <= floor(h_g)`` (floor superadditivity), so
        ``count_g(v) < need_g`` once the margin eats the f32 error.

    Chunks with ``nv_c = 0`` contribute nothing to either count; the runner
    excludes their (degenerate +inf) statistics from the min/max — dropping
    them from the sums above only strengthens both inequalities.

    Returns ``(lo, hi)`` int64 arrays of shape ``(C_cols, K)`` — 0 where
    ``nv = 0`` (callers mask those columns out).
    """
    qs = np.asarray(qs, dtype=np.float64)
    nv = np.asarray(n_valid, dtype=np.int64)
    h = qs[None, :] * np.maximum(nv - 1, 0)[:, None].astype(np.float64)
    top = np.maximum(nv - 1, 0)[:, None]
    lo = np.clip(np.floor(h).astype(np.int64) - margin, 0, top)
    hi = np.clip(np.ceil(h).astype(np.int64) + margin, 0, top)
    return lo, hi


def exact_quantiles_chunked(
    chunks: Sequence[np.ndarray],
    qs,
    valids: Optional[Sequence[Optional[np.ndarray]]] = None,
    edges_per_rank: int = 32,
    seed_brackets: bool = False,
) -> np.ndarray:
    """Reference driver over in-memory numpy chunks (the tests' reference).

    Equal to ``quantiles_percol`` of the concatenated chunks (masked entries
    sort as +inf) — but touching one chunk at a time, the access pattern
    the chunked runner uses on the device. Returns (Q, C).

    ``seed_brackets=True`` warm-starts the search from per-chunk order
    statistics at :func:`bracket_ranks` ranks, the construction the chunked
    runner applies on the device; the tables are the same either way, only
    the round count changes.
    """
    if valids is None:
        valids = [None] * len(chunks)
    masked = [
        np.where(v, c, np.float32(np.inf)).astype(np.float32)
        if v is not None else np.asarray(c, np.float32)
        for c, v in zip(chunks, valids)
    ]
    n_valid = sum(
        (v.sum(axis=0) if v is not None else
         np.full(c.shape[1], c.shape[0], dtype=np.int64))
        for c, v in zip(chunks, valids)
    )
    qs = np.asarray(qs, np.float32)
    search = BandSearch([qs], [np.asarray(n_valid)], edges_per_rank)
    if seed_brackets:
        margin = len(chunks) + 8
        lo_acc = hi_acc = None
        for x, v in zip(masked, valids):
            nv_c = (
                v.sum(axis=0).astype(np.int64) if v is not None
                else np.full(x.shape[1], x.shape[0], dtype=np.int64)
            )
            lo_r, hi_r = bracket_ranks(qs, nv_c, margin)
            srt = np.sort(x, axis=0)
            cols = np.arange(x.shape[1])[:, None]
            lo_v, hi_v = srt[lo_r, cols], srt[hi_r, cols]
            empty = nv_c == 0
            lo_v = np.where(empty[:, None], np.float32(np.inf), lo_v)
            hi_v = np.where(empty[:, None], np.float32(-np.inf), hi_v)
            lo_acc = lo_v if lo_acc is None else np.minimum(lo_acc, lo_v)
            hi_acc = hi_v if hi_acc is None else np.maximum(hi_acc, hi_v)
        search.seed_intervals([lo_acc], [hi_acc])
    while not search.resolved:
        edges = search.edges()[0]
        total = np.zeros(edges.shape, dtype=np.int64)
        for x in masked:
            total += (x[:, :, None] <= edges[None, :, :]).sum(axis=0)
        search.update([total])
    (v_lo,) = search.floor_values()
    cnt_le = np.zeros(v_lo.shape, dtype=np.int64)
    gt_min = np.full(v_lo.shape, np.float32(np.inf))
    for x in masked:
        le = x[:, :, None] <= v_lo[None, :, :]
        cnt_le += le.sum(axis=0)
        gt_min = np.minimum(
            gt_min, np.where(le, np.float32(np.inf), x[:, :, None]).min(axis=0)
        )
    return search.interpolate([cnt_le], [gt_min])[0]
