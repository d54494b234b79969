"""The arithmetic the metric readers share (``metrics/<name>.py`` each
call one of these on the run's record).  Shares are in percent; a reader
that finds nothing to read returns None."""

from __future__ import annotations

from typing import Optional

# kernels by name in the trace: the edge chains' forwards and backwards
FWD_KERNELS = r"\bedge_chain_(mma|wgmma)\b"
BWD_KERNELS = r"\bedge_chain_bwd_"


def rate(run, work: str) -> Optional[float]:
    """Work of the whole window over its whole host-clock length."""
    if work not in run.work or run.window_s <= 0:
        return None
    return run.work[work] / run.window_s


def roofline(run, pattern: str, least_s: Optional[float]) -> Optional[float]:
    """The kernels' least time (operations at the precision's peak or
    bytes at the memory bandwidth, whichever is longer) over their device
    time in the traced sub-window."""
    if run.trace is None or not least_s:
        return None
    spent = run.trace.kernel_seconds(pattern)
    return 100.0 * least_s / spent if spent > 0 else None


def mfu(run) -> Optional[float]:
    """Model FLOPs of the untraced part of a traced run over its time, at
    the peak of the configuration's precision."""
    if not run.peak_flops or run.untraced_s <= 0 or run.untraced_flops <= 0:
        return None
    return 100.0 * run.untraced_flops / run.untraced_s / run.peak_flops


def idle_share(run) -> Optional[float]:
    """Share of the traced sub-window with nothing running on the card."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def launches_per_step(run) -> Optional[float]:
    """Runtime kernel and graph launch calls per traced step."""
    if run.trace is None or run.traced_steps <= 0:
        return None
    return run.trace.launches() / run.traced_steps


def span_share(run, name: str) -> Optional[float]:
    """Share of the traced sub-window's host clock inside the program's
    span ``name`` (a ``record_function`` range)."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    spent = run.trace.span_seconds(name)
    return 100.0 * spent / run.trace.window_s if spent > 0 else None
