"""The kernels' roofline: the least time any implementation could take.

The operations are the essential operations of ``configs/<config>.json``
(``opcount.py``), priced at one issue slot each: 128 per SM per clock on
the card's 132 SMs at 1980 MHz. The bytes are each input read once and
each output written once, at 3.35 TB/s. The floor is the larger of the
two; a kernel's share is the floor over its device time, so no
implementation with the same outputs can read above 100%.

Where the work depends on the data, a path that ends ruined counts one
retirement month (the month it fails) and a surviving path every month;
a path-month's draw counts once however many rows share it.
"""

from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM (80 GB HBM3), dense rates at the 700 W limit.
SMS = 132
CLOCK_HZ = 1.98e9
ISSUE_PER_SM_CLOCK = 128
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = SMS * CLOCK_HZ * ISSUE_PER_SM_CLOCK
FLOAT = 4
MONTHS = 12


def floor_s(ops: float, nbytes: float) -> float:
    return max(ops / OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def rows_work(ess: Dict[str, float], months: Sequence[int], survivors: Sequence[int],
              n: int, years: int) -> Dict[str, float]:
    """Operations and bytes of one probe or grid launch: rows at working
    months ``months`` over ``n`` paths, ``survivors`` of each row."""
    ret = [s * MONTHS * years + (n - s) for s in survivors]
    draws = max(n * w + r for w, r in zip(months, ret))
    ops = draws * (ess["draw"] + ess["factors"])
    ops += sum(n * w * ess["accumulation"] + r * ess["retirement"]
               for w, r in zip(months, ret))
    nbytes = len(months) * (2 * n * FLOAT + 8)
    return {"ops": ops, "bytes": nbytes}


def full_work(ess: Dict[str, float], months: int, survivors: int, n: int,
              years: int, traj_len: int) -> Dict[str, float]:
    """Operations and bytes of one full-statistics launch (one row,
    tracked): seven per-path vectors, two (L, n) series and the (R, n)
    withdrawal rates written once."""
    ret = survivors * MONTHS * years + (n - survivors)
    draws = n * months + ret
    ops = draws * (ess["draw"] + ess["factors"])
    ops += n * months * ess["tracked_accumulation"] + ret * ess["tracked_retirement"]
    nbytes = n * FLOAT * (7 + 2 * traj_len + years)
    return {"ops": ops, "bytes": nbytes}
