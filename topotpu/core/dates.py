"""Day-grid metadata.

Parity target: ``twx/utils/util_dates.py::get_days_metadata`` (SURVEY.md §2.17)
— a struct of YMD/YDAY/MONTH/YEAR arrays for a date range, used everywhere the
pipeline needs day->month mapping (daily-anomaly recombination, infill windows).

Note: this is host-side metadata; the device-facing products are the
small integer arrays (``month_idx``, ``year``) that index static-shape day axes.
"""

from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass(frozen=True)
class DaysMetadata:
    """Vectorized calendar over [start, end] inclusive, daily step."""

    ymd: np.ndarray        # (ndays,) int32 YYYYMMDD
    year: np.ndarray       # (ndays,) int32
    month: np.ndarray      # (ndays,) int32 1..12
    day: np.ndarray        # (ndays,) int32 1..31
    yday: np.ndarray       # (ndays,) int32 1..366
    month_idx: np.ndarray  # (ndays,) int32 0..11  (device-facing)
    date64: np.ndarray     # (ndays,) datetime64[D]

    @property
    def ndays(self) -> int:
        return int(self.ymd.shape[0])

    @property
    def years(self) -> np.ndarray:
        return np.unique(self.year)

    def mask_year(self, year: int) -> np.ndarray:
        return self.year == year

    def mask_month(self, month: int) -> np.ndarray:
        """month is 1-based, matching the reference's MONTH attribute."""
        return self.month == month

    def day_to_norm_index(self) -> np.ndarray:
        """(ndays,) index into a (..., 12) monthly-normal axis."""
        return self.month_idx


def get_days_metadata(start: str | np.datetime64, end: str | np.datetime64) -> DaysMetadata:
    """Build DaysMetadata for [start, end] inclusive.

    Accepts 'YYYY-MM-DD' strings or datetime64. Mirrors the reference's
    get_days_metadata contract (inclusive range, daily step).
    """
    d0 = np.datetime64(start, "D")
    d1 = np.datetime64(end, "D")
    if d1 < d0:
        raise ValueError(f"end {d1} precedes start {d0}")
    dates = np.arange(d0, d1 + np.timedelta64(1, "D"), dtype="datetime64[D]")
    ydates = dates.astype("datetime64[Y]")
    year = (ydates.astype(int) + 1970).astype(np.int32)
    month = ((dates.astype("datetime64[M]").astype(int) % 12) + 1).astype(np.int32)
    day = ((dates - dates.astype("datetime64[M]")).astype(int) + 1).astype(np.int32)
    yday = ((dates - ydates).astype(int) + 1).astype(np.int32)
    ymd = (year * 10000 + month * 100 + day).astype(np.int32)
    return DaysMetadata(
        ymd=ymd,
        year=year,
        month=month,
        day=day,
        yday=yday,
        month_idx=(month - 1).astype(np.int32),
        date64=dates,
    )


def ymd_to_date64(ymd: int) -> np.datetime64:
    y, rem = divmod(int(ymd), 10000)
    m, d = divmod(rem, 100)
    return np.datetime64(f"{y:04d}-{m:02d}-{d:02d}", "D")
