"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

Only CUDA activity is recorded (no CPU ops), so the program's host threads
run as they do untraced. The trace is aligned with the host clock by two
marker kernels (``torch.cuda._sleep``, a ``spin_kernel``) launched right
after a device synchronise at the window's start and end: host time ``t``
maps to trace time ``marker_start + (t - t_marker)``.

Reductions, all over the traced window:
- ``busy_s``: the union of kernel, copy and set intervals;
- ``kernel_s``: the sum of kernel durations (copies and sets left out);
- ``d2h_s`` / ``h2d_s``: the sums of device-to-host / host-to-device copies;
- ``top_ops``: device time by name, largest first;
- ``idle_gaps``: the longest stretches with nothing on the device, each
  named by the benchmark span the host was in when it began.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

MARKER = "spin_kernel"
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def union_length(intervals: List[Tuple[float, float]]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], start: float, end: float
         ) -> List[Tuple[float, float]]:
    """The stretches of ``[start, end]`` that no interval covers."""
    out = []
    cursor = start
    for s, e in sorted(intervals):
        if e <= cursor:
            continue
        if s > cursor:
            out.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        out.append((cursor, end))
    return [(s, e) for s, e in out if e > s]


class DeviceWindow:
    """A profiler session (``open`` / ``close``) and, inside it, the traced
    window between ``start()`` and ``stop()``; then ``reduce(name_at)``
    with ``name_at(host_time) -> span name``. ``start`` opens the session
    where it is not open yet."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None

    def _mark(self) -> float:
        import torch

        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            t = time.perf_counter()
            torch.cuda._sleep(1000)
        return t

    def open(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def start(self) -> None:
        if self.prof is None:
            self.open()
        self.t0 = self._mark()

    def stop(self) -> None:
        self.t1 = self._mark()

    def close(self) -> None:
        import torch

        torch.cuda.synchronize(self.device)
        self.prof.stop()

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def _raw(self) -> List[Tuple[str, float, float]]:
        """Every device event the session recorded, ``(name, start_s,
        end_s)`` on the trace's clock."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns() * 1e-9
            out.append((e.name(), start, start + e.duration_ns() * 1e-9))
        return out

    def events(self) -> List[Tuple[str, float, float]]:
        """Device events ``(name, start_s, end_s)`` on the host clock."""
        raw = self._raw()
        marks = sorted(s for n, s, _ in raw if MARKER in n)
        if len(marks) < 2:
            raise RuntimeError(
                f"device trace: found {len(marks)} marker kernels, need 2 "
                f"({len(raw)} device events)")
        offset = self.t0 - marks[-2]   # host = trace + offset, at the window's start
        return [(n, s + offset, e + offset) for n, s, e in raw if MARKER not in n]

    def reduce(self, name_at: Callable[[float], str], top: int = 10) -> dict:
        raw = self.events()
        evs = [(n, max(s, self.t0), min(e, self.t1)) for n, s, e in raw]
        evs = [(n, s, e) for n, s, e in evs if e > s]
        intervals = [(s, e) for _, s, e in evs]
        busy = union_length(intervals)
        kernels = [(n, s, e) for n, s, e in evs if not n.startswith(COPY_PREFIXES)]
        by_name = {}
        for n, s, e in evs:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps(intervals, self.t0, self.t1), key=lambda g: g[0] - g[1])
        copies = {kind: sum(e - s for n, s, e in evs if kind in n)
                  for kind in ("DtoH", "HtoD")}
        return {
            "window_s": self.window_s,
            "d2h_s": copies["DtoH"],
            "h2d_s": copies["HtoD"],
            "busy_s": busy,
            "kernel_s": sum(e - s for _, s, e in kernels),
            "n_kernels": len(kernels),
            "n_device_events": len(raw),
            "top_ops": [[n[:160], secs] for n, secs in top_ops],
            "idle_gaps": [[name_at(s), e - s] for s, e in idle[:top]],
            "t0": self.t0,
            "t1": self.t1,
        }

