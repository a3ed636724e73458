"""The traced window: ``torch.profiler`` read into the numbers the
per-layer metrics take.  It records the device's timeline alone (kernels,
copies and their times) and no host operators, the least cost to the host;
the harness prints the same number of frames' untraced wall time beside it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Trace:
    """What the metrics read.  Times in seconds."""

    steps: int
    window_s: float
    device_ops: list  # (name, start_s, end_s, is_kernel), sorted by start
    copies_s: list  # wall seconds of each frame's synchronised host copy
    counters: dict  # program counters over the window
    yardstick: dict  # the cell's frozen operation and byte counts

    @property
    def kernels(self):
        return [op for op in self.device_ops if op[3]]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the device intervals)."""
        busy, end = 0.0, float("-inf")
        for _, a, b, _ in self.device_ops:
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        return busy


def profiler(device: torch.device):
    """The profiler of the traced window: the device's timeline alone (on a
    CPU device, which has none, the host's operators)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    return profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])


def read(prof, steps: int, window_s: float, copies_s, counters, yardstick) -> Trace:
    """The traced window's device operations (name, start_s, end_s,
    is_kernel), sorted by start; a span's annotation on the device is no
    operation."""
    from torch.autograd import DeviceType

    ops = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        ops.append((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6,
                    not e.name.startswith(("Memcpy", "Memset"))))
    ops.sort(key=lambda op: op[1])
    return Trace(steps=steps, window_s=window_s, device_ops=ops, copies_s=list(copies_s),
                 counters=counters, yardstick=yardstick)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the operation that followed each (what the device waited to be given)."""
    by_name: dict = {}
    for name, a, b, _ in trace.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps: dict = {}
    end = None
    for name, a, b, _ in trace.device_ops:
        if end is not None and a > end:
            label = "before " + name[:100]
            gaps[label] = gaps.get(label, 0.0) + (a - end)
        end = b if end is None else max(end, b)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}
