"""The profiler's trace of the measured window, reduced to what the
per-layer metrics read.

The window's batches are marked on the host (``BATCH``); every device
operation (kernel, copy, set) is clipped to those spans, so the gaps between
batches, where the harness stages the next inputs, count neither as busy nor
as idle.  Busy time is the union of a device's operation spans (the
arithmetic of ``runtime/profile.py:trace_run`` in the program, kept here as
a copy); the blind-rotation kernels are told apart by their names.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["BATCH", "BLIND_ROTATION_KERNELS", "Trace", "reduce_profile",
           "union_s"]

BATCH = "bench_h100.batch"
# The fused blind rotations of ops/csrc: K1, K2 and the small-N K1.
BLIND_ROTATION_KERNELS = ("k1_kernel", "k2_kernel", "k1s_kernel")
TOP = 10
NAME_CHARS = 96


def is_blind_rotation(name: str) -> bool:
    return any(k in name for k in BLIND_ROTATION_KERNELS)


def short(name: str) -> str:
    """A device operation's name as the breakdown gives it: without
    ``void`` and cut to NAME_CHARS characters."""
    name = name[5:] if name.startswith("void ") else name
    return name[:NAME_CHARS]


def _clip(spans, windows):
    out = []
    for a, b in spans:
        for w0, w1 in windows:
            lo, hi = max(a, w0), min(b, w1)
            if hi > lo:
                out.append((lo, hi))
    return out


def _merge(spans):
    merged: list[list[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def union_s(spans) -> float:
    """Seconds covered by µs spans."""
    return sum(b - a for a, b in _merge(spans)) / 1e6


@dataclass
class Trace:
    """A traced window: its batch spans (µs, host clock of the profiler)
    and, per device index, the device operations within them."""
    windows: list
    ops: dict = field(default_factory=dict)       # device -> [(name, a, b)]
    host: list = field(default_factory=list)      # [(name, a, b)] host ops

    @property
    def window_s(self) -> float:
        return sum(b - a for a, b in self.windows) / 1e6

    def busy_s(self, device) -> float:
        return union_s((a, b) for _, a, b in self.ops.get(device, ()))

    def rotation_s(self, device) -> float:
        return union_s((a, b) for n, a, b in self.ops.get(device, ())
                       if is_blind_rotation(n))

    def devices(self) -> list:
        return sorted(self.ops)

    def device_ops(self) -> list:
        """[name, seconds] of the operations that took most device time,
        over all devices."""
        per = defaultdict(float)
        for ops in self.ops.values():
            for n, a, b in ops:
                per[short(n)] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(per.items(),
                                          key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """[name, seconds] of the longest spans inside the batches in which
        a device ran nothing, each named by the innermost host operation
        running when it began (or "host")."""
        gaps = []
        for dev, ops in self.ops.items():
            for w0, w1 in self.windows:
                t = w0
                for a, b in _merge((a, b) for _, a, b in ops
                                   if b > w0 and a < w1):
                    if a > t:
                        gaps.append((a - t, t))
                    t = max(t, b)
                if w1 > t:
                    gaps.append((w1 - t, t))
        out = []
        for length, start in sorted(gaps, reverse=True)[:TOP]:
            inner = [(a, n) for n, a, b in self.host if a <= start < b]
            out.append([max(inner)[1] if inner else "host", length / 1e6])
        return out


def reduce_profile(prof) -> Trace:
    """A ``torch.profiler.profile`` of the window (CPU and CUDA activity)
    -> :class:`Trace`."""
    from torch.autograd import DeviceType

    windows, host, dev_ops = [], [], defaultdict(list)
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.name == BATCH:
            # the marker is also recorded as a range on the device
            if e.device_type != DeviceType.CUDA:
                windows.append((a, b))
        elif e.device_type == DeviceType.CUDA:
            dev_ops[e.device_index].append((e.name, a, b))
        else:
            host.append((e.name, a, b))
    windows.sort()
    ops = {}
    for dev, evs in dev_ops.items():
        clipped = []
        for n, a, b in evs:
            clipped += [(n, lo, hi) for lo, hi in _clip([(a, b)], windows)]
        if clipped:
            ops[dev] = clipped
    host = [(n, a, b) for n, a, b in host
            if any(a < w1 and b > w0 for w0, w1 in windows)]
    return Trace(windows, ops, host)
