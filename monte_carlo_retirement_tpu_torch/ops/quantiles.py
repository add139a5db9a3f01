"""Exact ``np.percentile`` / ``np.nanpercentile`` over the path axis, in torch.

Same contract as the JAX package's ``ops/quantiles.py`` (lines 1-33): order
statistics with linear interpolation between the two neighbouring ranks,
masked entries sort as +inf and are never selected, a column without valid
entries gives NaN. Built on ``torch.sort`` plus ``gather`` along each
column (``torch.quantile`` refuses inputs above 16M elements, and a
1M x 121 trajectory table is 121M). Columns are sorted as rows of the
transposed table, so an (n, C) view of a contiguous (C, n) series — the
kernels' layout — sorts without a copy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def sorted_columns(
    x: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The columns of an (n, C) table sorted along the path axis, as rows
    of a (C, n) table, masked entries as +inf; and each column's valid
    count (C,)."""
    xt = x.t()  # (C, n)
    if valid is None:
        n_valid = torch.full((xt.shape[0],), xt.shape[1], dtype=torch.int64,
                             device=x.device)
        return torch.sort(xt, dim=1).values, n_valid
    vt = valid.t()
    return torch.sort(torch.where(vt, xt, torch.inf), dim=1).values, vt.sum(dim=1)


def quantiles_percol(
    x: torch.Tensor,
    qmat: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[c, k] = np.(nan)percentile(x[:, c], qmat[c, k] * 100)``.

    x: (n, C) values, finite where valid. qmat: (C, K) fractions in [0, 1].
    valid: optional (n, C) mask. Returns (C, K); NaN where a column has no
    valid entry.
    """
    if x.ndim != 2 or qmat.ndim != 2 or qmat.shape[0] != x.shape[1]:
        raise ValueError(
            f"expected x (n, C) and qmat (C, K); got {tuple(x.shape)} / "
            f"{tuple(qmat.shape)}"
        )
    sorted_x, n_valid = sorted_columns(x, valid)
    n = sorted_x.shape[1]
    qmat = torch.as_tensor(qmat, dtype=x.dtype, device=x.device)
    last = torch.clamp(n_valid - 1, min=0)[:, None]  # (C, 1)
    h = qmat * last.to(x.dtype)
    lo = torch.clamp(torch.floor(h).to(torch.int64), max=n - 1)
    hi = torch.minimum(lo + 1, last)
    t = h - lo.to(x.dtype)
    a = torch.gather(sorted_x, 1, lo)
    b = torch.gather(sorted_x, 1, hi)
    # numpy's _lerp: a + (b-a)*t, or b - (b-a)*(1-t) from t >= 0.5 on.
    diff = b - a
    out = torch.where(t >= 0.5, b - diff * (1.0 - t), a + diff * t)
    return torch.where((n_valid > 0)[:, None], out, torch.nan)


# Per-chunk passes of the chunked run's exact quantiles
# (ops/chunked_quantiles.py): each sorts the chunk's columns once and reads
# what it needs by binary search or gather, so no (n, C, edges) compare
# table is ever materialised. Masked entries count as +inf, as above.


def count_le(x: torch.Tensor, edges: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``count(x[:, c] <= edges[c, j])`` of an (n, C) chunk for (C, E)
    edges: (C, E) int64."""
    srt, _ = sorted_columns(x, valid)
    edges = torch.as_tensor(edges, dtype=x.dtype, device=x.device)
    return torch.searchsorted(srt.contiguous(), edges.contiguous(), right=True)


def ceil_stats(x: torch.Tensor, v: torch.Tensor,
               valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Count-at-floor and smallest entry above the floor per (column,
    rank) of an (n, C) chunk for (C, K) floor values ``v``: the (C, K)
    int64 ``count(x <= v)`` and the (C, K) minimum of the entries > v
    (+inf where none)."""
    srt, _ = sorted_columns(x, valid)
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device).contiguous()
    n = srt.shape[1]
    cnt = torch.searchsorted(srt.contiguous(), v, right=True)
    above = torch.gather(srt, 1, torch.clamp(cnt, max=n - 1))
    return cnt, torch.where(cnt < n, above, torch.inf)


def floor_values(x: torch.Tensor, ranks: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The order statistics of an (n, C) chunk at (C, K) 0-indexed
    ``ranks`` per column: (C, K)."""
    srt, _ = sorted_columns(x, valid)
    ranks = torch.as_tensor(ranks, dtype=torch.int64, device=x.device)
    return torch.gather(srt, 1, ranks)


def exact_quantiles(
    x: torch.Tensor,
    qs: Sequence[float],
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``np.percentile(x, qs*100, axis=0)`` (or ``nanpercentile`` through
    ``valid``) of an (n, C) table. Returns (Q, C)."""
    q = torch.as_tensor(qs, dtype=x.dtype, device=x.device)
    qmat = q[None, :].expand(x.shape[1], -1)
    return quantiles_percol(x, qmat, valid).t()


def snap_zero_band(out: torch.Tensor) -> torch.Tensor:
    """Subnormal-magnitude results (and -0.0) as +0.0: the JAX package's
    ``_snap_zero_band``. Its compares run with subnormals read as zero, so
    a result in that band is zero there; the names below that JAX's
    ``ops/quantiles.py`` exports give the same answer."""
    tiny = torch.finfo(out.dtype).tiny
    return torch.where(out.abs() < tiny, torch.zeros((), dtype=out.dtype,
                                                     device=out.device), out)


def order_statistics(x: torch.Tensor, ranks: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact order statistics along axis 0 (JAX ``order_statistics``).

    x: (n, C) values, finite where valid. ranks: (C, K) 0-indexed ranks
    within each column's valid entries (rank 0 the smallest). valid:
    optional (n, C) mask; invalid entries sort last and are never
    selected. Returns (C, K) in ``x``'s dtype, NaN where a rank is at or
    beyond the column's valid count."""
    if x.ndim != 2 or ranks.ndim != 2 or x.shape[1] != ranks.shape[0]:
        raise ValueError(
            f"expected x (n, C) and ranks (C, K); got {tuple(x.shape)} / "
            f"{tuple(ranks.shape)}"
        )
    srt, n_valid = sorted_columns(x, valid)
    ranks = torch.as_tensor(ranks, dtype=torch.int64, device=x.device)
    vals = torch.gather(srt, 1, torch.clamp(ranks, 0, x.shape[0] - 1))
    out = torch.where(ranks < n_valid[:, None], vals, torch.nan)
    return snap_zero_band(out)


def exact_quantiles_parts(parts: Sequence[torch.Tensor], qs: Sequence[float],
                          valids: Optional[Sequence] = None
                          ) -> List[torch.Tensor]:
    """:func:`exact_quantiles` of several (n, C_i) column groups at shared
    fractions ``qs``, with optional per-part masks (``None`` entries
    allowed): a list of (Q, C_i) tables, zero band snapped as JAX's."""
    if valids is None:
        valids = [None] * len(parts)
    return [snap_zero_band(exact_quantiles(x, qs, valid))
            for x, valid in zip(parts, valids)]


def masked_median(x: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Median over the valid entries of a vector (``np.percentile`` 50;
    NaN when none is valid)."""
    out = exact_quantiles_parts([x[:, None]], [0.5],
                                [None if valid is None else valid[:, None]])
    return out[0][0, 0]


def upper_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``sorted(x[valid])[count // 2]`` — the element the dashboard's
    client-side histogram labels as the median (no interpolation); NaN when
    no entry is valid. Stays on ``x``'s device (no host sync)."""
    n_valid = valid.sum()
    ordered = torch.sort(torch.where(valid, x, torch.inf)).values
    pick = ordered[torch.clamp(n_valid // 2, max=x.shape[0] - 1)]
    return torch.where(n_valid > 0, pick, torch.nan)
