"""Queue-depth forecasters behind one protocol, on torch tensors.

The port's copy of ``kube_sqs_autoscaler_tpu/forecast/forecasters.py``.
Each forecaster's math is a plain function over the fixed-shape
``(times, depths, n)`` snapshot a :class:`~.history.DepthHistory`
produces, on tensors of an explicit device (the forecaster classes put the
snapshot on theirs: the card unless they are asked for the CPU).

The three families cover the classical trend spectrum:

- **EWMA** — exponentially weighted level, flat extrapolation.
- **Holt** — double exponential smoothing (level + trend), linear
  extrapolation ``level + trend * steps(horizon)``.
- **Windowed least squares** — exact line fit over the last ``window``
  samples against *actual* sample times, linear extrapolation.

All predictions are clamped to ``>= 0`` (queue depth is nonnegative).

The reference runs EWMA and Holt as masked ``lax.scan`` recurrences over
the ring's capacity.  The EWMA level is a closed form here: a weighted sum
of the ``n`` valid samples, weights and sum in float64, the level
float32 (a handful of launches).  Holt runs the reference's float32
recurrence step by step over the ``n`` valid samples (nine launches a
sample): its trend can cancel its level, and there the float32 rounding
of the scan is part of the value.  The least-squares fit runs the
reference's float32 sums over the window.  A forecast is one upload of
the snapshot and one read of its result.

Each function has a batched form over ``[B, C]`` snapshots with a
per-row ``n`` (``*_rows``, what the compiled twins run), and the live
single-snapshot function is that form with one row: every sum is a
:func:`tree_sum` of elementwise operations, so a row gives the same bits
alone and inside a batch, on either device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from ..device import resolve_device

F32 = torch.float32
F64 = torch.float64


@runtime_checkable
class Forecaster(Protocol):
    """Predicts queue depth ``horizon`` seconds past the newest sample."""

    name: str

    def predict(
        self, times: np.ndarray, depths: np.ndarray, n: int, horizon: float
    ) -> float:
        """Forecast depth at ``times[n-1] + horizon`` from the first ``n``
        (chronological) samples of fixed-shape ``times``/``depths``."""
        ...


def _f32(value: float) -> float:
    """``value`` rounded to float32, as the reference's weak-typed
    scalars are inside its float32 programs."""
    return float(np.float32(value))


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension as a pairwise tree of elementwise adds
    (zero-padded to a power of two).  The grouping depends only on the
    last dimension's length, never on the number of rows or the device,
    so a row's sum is the same bits in a batch of one and of thousands
    (a library reduction picks its order from the shape)."""
    width = x.shape[-1]
    size = 1
    while size < width:
        size *= 2
    if size != width:
        x = torch.nn.functional.pad(x, (0, size - width))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


@functools.lru_cache(maxsize=64)
def _ewma_powers(alpha: float, capacity: int) -> np.ndarray:
    """``keep**k`` for ``k = capacity - 1 .. 0`` in float64 (``keep = 1 -
    alpha`` in float32): entry ``j`` is what a sample ``capacity - 1 - j``
    samples before the newest is worth."""
    keep = _f32(np.float32(1.0) - np.float32(alpha))
    return keep ** np.arange(capacity - 1, -1, -1, dtype=np.float64)


def ewma_tables(alphas, capacity: int, device: torch.device):
    """One row per alpha: ``(alpha64 [B], powers [B, capacity])``, float64
    on ``device`` in one upload (:func:`ewma_level_rows`'s weights)."""
    alphas = [_f32(a) for a in alphas]
    table = np.concatenate(
        [np.asarray(alphas, np.float64)[:, None],
         np.stack([_ewma_powers(a, capacity) for a in alphas])], axis=1)
    table = torch.as_tensor(table, dtype=F64, device=device)
    return table[:, 0], table[:, 1:]


def ewma_level_rows(depths: torch.Tensor, n: torch.Tensor,
                    alpha64: torch.Tensor,
                    powers: torch.Tensor) -> torch.Tensor:
    """EWMA levels of ``[B, C]`` snapshots after each row's first ``n``
    entries (0 where ``n`` is 0), float32 ``[B]``.  The first sample sets
    the level; each later one moves it by ``alpha`` toward itself.  A
    closed form: the float64 weighted sum of the valid samples, summed by
    :func:`tree_sum` over the capacity."""
    capacity = depths.shape[1]
    idx = torch.arange(capacity, device=depths.device)
    valid = idx[None, :] < n[:, None]
    source = ((capacity - n)[:, None] + idx[None, :]).clamp(max=capacity - 1)
    weights = powers.gather(1, source)
    d = depths.to(F64)
    first = weights[:, 0] * d[:, 0]
    later = torch.where(valid & (idx[None, :] > 0),
                        (alpha64[:, None] * weights) * d,
                        torch.zeros((), dtype=F64, device=d.device))
    level = (first + tree_sum(later)).to(F32)
    return torch.where(n > 0, level, torch.zeros_like(level))


def holt_rows(times: torch.Tensor, depths: torch.Tensor, n: torch.Tensor,
              n_max: int, horizon: torch.Tensor, alpha: torch.Tensor,
              beta: torch.Tensor) -> torch.Tensor:
    """Holt level+trend over each row's first ``n`` entries, extrapolated
    ``horizon`` (float32 ``[B]``; every argument a ``[B]`` or ``[B, C]``
    tensor but ``n_max``, a host bound on ``n``).

    The float32 recurrence runs step by step over ``i < n_max``; a row
    whose ``n`` is reached keeps its state (``torch.where``, so the valid
    steps are the same float32 operations in any batch).  The trend is
    per *sample step*; the horizon converts to steps via the mean
    observed inter-sample interval.  ``times`` must be centered on the
    newest sample (:func:`_center_times`)."""
    zero = torch.zeros((), dtype=F32, device=depths.device)
    a = alpha[:, None]
    keep_level = 1.0 - alpha
    keep_trend = 1.0 - beta
    pulled = a * depths
    level = depths[:, 0]
    trend = torch.zeros_like(level)
    for i in range(1, n_max):
        # level and trend are sequential: a closed form (exact in
        # float64) differs from the float32 recurrence by more than the
        # forecast's tolerance where a drain's trend cancels its level
        new_level = pulled[:, i] + keep_level * (level + trend)
        new_trend = beta * (new_level - level) + keep_trend * trend
        valid = n > i
        level = torch.where(valid, new_level, level)
        trend = torch.where(valid, new_trend, trend)
    level = torch.where(n > 0, level, zero)
    trend = torch.where(n > 0, trend, zero)
    last = (n - 1).clamp(min=0)
    t_last = times.gather(1, last[:, None])[:, 0]
    mean_dt = (t_last - times[:, 0]) / (n - 1).clamp(min=1).to(F32)
    steps = torch.where(mean_dt > 0, horizon / mean_dt, zero)
    return torch.clamp(level + trend * steps, min=0.0)


def lstsq_fit_rows(times: torch.Tensor, depths: torch.Tensor,
                   n: torch.Tensor, window: torch.Tensor, width: int):
    """Normal-equations core of the windowed line fit, in float32, per
    row: ``(slope, intercept, depth_last, degenerate)``, each ``[B]``.
    The last ``min(window, n)`` samples are gathered into a block of
    ``width`` (a host bound on ``window``) ending at the newest sample
    and summed by :func:`tree_sum`."""
    last = (n - 1).clamp(min=0)
    start = (n - window).clamp(min=0)
    pos = (n - width)[:, None] + torch.arange(width, device=n.device)
    take = (pos >= start[:, None]) & (pos >= 0)
    pos = pos.clamp(min=0)
    t_last = times.gather(1, last[:, None])
    zero = torch.zeros((), dtype=F32, device=depths.device)
    x = torch.where(take, times.gather(1, pos) - t_last, zero)
    y = torch.where(take, depths.gather(1, pos), zero)
    count = (n - start).to(F32)
    sx = tree_sum(x)
    sy = tree_sum(y)
    sxx = tree_sum(x * x)
    sxy = tree_sum(x * y)
    denom = count * sxx - sx * sx
    depth_last = depths.gather(1, last[:, None])[:, 0]
    degenerate = denom.abs() < 1e-9  # < 2 samples or coincident times
    safe_denom = torch.where(degenerate, torch.ones_like(denom), denom)
    slope = (count * sxy - sx * sy) / safe_denom
    intercept = (sy - slope * sx) / count.clamp(min=1.0)
    return slope, intercept, depth_last, degenerate


def lstsq_rows(times, depths, n, horizon, window, width):
    """Line fit over each row's last ``min(window, n)`` samples,
    extrapolated ``horizon`` past the newest (centered ``times``, so the
    prediction is ``intercept + slope * horizon``)."""
    slope, intercept, depth_last, degenerate = lstsq_fit_rows(
        times, depths, n, window, width)
    fit = intercept + slope * horizon
    return torch.clamp(torch.where(degenerate, depth_last, fit), min=0.0)


def lstsq_slope_rows(times, depths, n, window, width):
    """Fitted depth trend (msg/s) per row; zero while degenerate."""
    slope, _, _, degenerate = lstsq_fit_rows(times, depths, n, window, width)
    return torch.where(degenerate, torch.zeros_like(slope), slope)


def one_row(device: torch.device, *values):
    """Host scalars as ``[1]`` tensors on ``device``, in one upload:
    integers as int64, the rest float32 (every value is a float32 or an
    integer, both exact through float64)."""
    row = torch.tensor([float(v) for v in values], dtype=F64).to(device)
    return [row[i:i + 1].to(torch.int64 if isinstance(v, (int, np.integer))
                            else F32)
            for i, v in enumerate(values)]


def ewma_level(depths: torch.Tensor, n: int, alpha: float) -> torch.Tensor:
    """The EWMA level of one snapshot (:func:`ewma_level_rows` with one
    row), a float32 scalar on ``depths``' device."""
    alpha64, powers = ewma_tables([alpha], depths.shape[0], depths.device)
    (n_t,) = one_row(depths.device, int(n))
    return ewma_level_rows(depths[None], n_t, alpha64, powers)[0]


def holt_forecast(
    times: torch.Tensor,
    depths: torch.Tensor,
    n: int,
    horizon: float,
    alpha: float,
    beta: float,
) -> torch.Tensor:
    """Holt over one snapshot (:func:`holt_rows` with one row), a float32
    scalar on the tensors' device."""
    n_t, h, a, b = one_row(depths.device, int(n), _f32(horizon),
                            _f32(alpha), _f32(beta))
    return holt_rows(times[None], depths[None], n_t, int(n), h, a, b)[0]


def lstsq_forecast(
    times: torch.Tensor,
    depths: torch.Tensor,
    n: int,
    horizon: float,
    window: int,
) -> torch.Tensor:
    """The windowed line fit over one snapshot (:func:`lstsq_rows` with
    one row), a float32 scalar."""
    n_t, h, w = one_row(depths.device, int(n), _f32(horizon), int(window))
    return lstsq_rows(times[None], depths[None], n_t, h, w, int(window))[0]


def lstsq_slope(times: torch.Tensor, depths: torch.Tensor, n: int,
                window: int) -> torch.Tensor:
    """Fitted depth trend (msg/s) of one snapshot; zero while degenerate
    (< 2 samples or coincident times)."""
    n_t, w = one_row(depths.device, int(n), int(window))
    return lstsq_slope_rows(times[None], depths[None], n_t, w,
                            int(window))[0]


def _center_times(times: np.ndarray, n: int) -> np.ndarray:
    """Times relative to the newest sample, in float64 on the host BEFORE
    the float32 cast.  Raw ``time.monotonic()`` stamps grow unboundedly
    (seconds since boot); at ~1e8 s float32 spacing is 8 s, which silently
    corrupts 5 s poll intervals.  Centered deltas are small and exact."""
    times = np.asarray(times, dtype=np.float64)
    return times - times[max(n - 1, 0)]


def snapshot_tensors(times: np.ndarray | None, depths: np.ndarray, n: int,
                     device: torch.device):
    """A history snapshot as the float32 tensors the functions take, on
    ``device``: centered times (``None`` when not given) and depths, in
    one upload."""
    depths = np.asarray(depths, dtype=np.float32)
    if times is None:
        return None, torch.as_tensor(depths, device=device)
    both = np.stack([_center_times(times, n).astype(np.float32), depths])
    both = torch.as_tensor(both, device=device)
    return both[0], both[1]


@dataclass(frozen=True)
class EwmaForecaster:
    """Flat extrapolation of an exponentially weighted level."""

    alpha: float = 0.3
    name: str = "ewma"
    device: str = "cuda"

    def predict(self, times, depths, n, horizon) -> float:
        del times, horizon  # EWMA's forecast is horizon-independent
        _, d = snapshot_tensors(None, depths, n, resolve_device(self.device))
        return float(max(0.0, float(ewma_level(d, n, self.alpha))))


@dataclass(frozen=True)
class HoltForecaster:
    """Double exponential smoothing: level + trend, linear extrapolation."""

    alpha: float = 0.5
    beta: float = 0.3
    name: str = "holt"
    device: str = "cuda"

    def predict(self, times, depths, n, horizon) -> float:
        t, d = snapshot_tensors(times, depths, n, resolve_device(self.device))
        return float(holt_forecast(t, d, n, horizon, self.alpha, self.beta))


@dataclass(frozen=True)
class LeastSquaresForecaster:
    """Exact line fit over the last ``window`` samples' actual times."""

    window: int = 12
    name: str = "lstsq"
    device: str = "cuda"

    def predict(self, times, depths, n, horizon) -> float:
        t, d = snapshot_tensors(times, depths, n, resolve_device(self.device))
        return float(lstsq_forecast(t, d, n, horizon, self.window))


_FORECASTERS = {
    "ewma": EwmaForecaster,
    "holt": HoltForecaster,
    "lstsq": LeastSquaresForecaster,
}

FORECASTER_NAMES: tuple[str, ...] = tuple(_FORECASTERS)


def make_forecaster(name: str, **params) -> Forecaster:
    """Build a forecaster by CLI name (``ewma``/``holt``/``lstsq``);
    ``device=`` picks where it runs (``"cuda"`` by default)."""
    try:
        cls = _FORECASTERS[name]
    except KeyError:
        raise ValueError(
            f"unknown forecaster {name!r}; choose from {FORECASTER_NAMES}"
        ) from None
    return cls(**params)
