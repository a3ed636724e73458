"""The program's spans read against a traced window's device timeline.

Input, all in one clock (seconds from the profiler's trace start, as
``tracing.Trace``): the device operations with the host time of the API
call that launched each (:func:`device_ops`), the program's spans (name,
parent index, start, end, step; ``tpufem_torch.metrics.Span`` in seconds),
and the window's bounds.  Each operation is put down to the innermost span
open at its launch; each idle stretch of the device, to the innermost
spans open on the host during it, by overlap, and where none is open to
"outside the program" (the caller's own work between program calls).

The functions named as metrics return None where the window holds nothing
for them (no spans: the precision control, or a program without them).
"""

from __future__ import annotations

import bisect
import dataclasses

OUTSIDE = "outside the program"
LAUNCHES = ("k2.launch", "k3.launch")
DIVGRAD = ("div", "grad")
RUN = "stokes.run"


@dataclasses.dataclass
class Spanned:
    """A traced window with the program's spans.  Times in seconds."""

    steps: int
    window: tuple  # (start_s, end_s)
    ops: list  # (name, start_s, end_s, is_kernel, launch_s or None), sorted by start
    spans: list  # (name, parent, start_s, end_s, step), in the order they were entered
    setup: list = dataclasses.field(default_factory=list)  # the set-up's spans, same form
    counters: dict = dataclasses.field(default_factory=dict)
    calls: list = dataclasses.field(default_factory=list)  # host API records (name, start_s, end_s)

    def __post_init__(self):
        self.owner = innermost(self.spans, [op[4] for op in self.ops])
        self._paths = {}

    def path(self, i: int) -> str:
        """"stokes.run/step/pressure_solve/k3.launch" for span ``i``;
        ``OUTSIDE`` for -1."""
        if i < 0:
            return OUTSIDE
        if i not in self._paths:
            name, parent = self.spans[i][0], self.spans[i][1]
            self._paths[i] = name if parent < 0 else self.path(parent) + "/" + name
        return self._paths[i]

    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def device_ops(prof):
    """The profiler's device operations (kernels, copies and sets; a span's
    annotation on the device is none) with the launch time of each, paired
    by correlation id with the runtime or driver API record that launched
    it, and those API records → (ops, calls, trace_start_ns, shifts_s);
    times in seconds from the trace's start, which is at
    ``trace_start_ns`` in ``time.time_ns()``'s clock.

    The API records and the program's spans share the host's clock; the
    device's timestamps, converted to it, can run early by up to
    milliseconds, and jump within a window (H100 windows read kernels 0.3
    and 3.9 ms before the calls that launched them).  So the device's
    times are moved stretch by stretch between the host's
    synchronisations, each stretch by its least lead of an operation's
    start over its launch where that is negative (``shifts_s``, one a
    stretch, 0 where no operation starts before its launch).  Each
    stretch opens on a device the synchronise left idle, so its first
    operations start within microseconds of their launch."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    launch, device, calls = {}, [], []
    for e in results.events():
        if e.is_user_annotation():
            continue
        if e.device_type() == DeviceType.CUDA:
            device.append(e)
        elif e.name().startswith("cu"):  # cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...
            start, end = (e.start_ns() - t0) / 1e9, (e.end_ns() - t0) / 1e9
            calls.append((e.name(), start, end))
            cid = e.correlation_id()
            launch[cid] = min(launch.get(cid, start), start)
    ops = [(e.name(), (e.start_ns() - t0) / 1e9, (e.end_ns() - t0) / 1e9,
            not e.name().startswith(("Memcpy", "Memset")), launch.get(e.correlation_id()))
           for e in device]
    calls.sort(key=lambda c: c[1])
    syncs = [c[1] for c in calls if "ynchronize" in c[0]]
    stretch = [bisect.bisect(syncs, op[4]) if op[4] is not None else None for op in ops]
    shifts = {}
    for op, k in zip(ops, stretch):
        if k is not None:
            shifts[k] = min(shifts.get(k, 0.0), op[1] - op[4])
    moved, shift = [], 0.0  # no launch record: the shift of the operation before it
    for op, k in sorted(zip(ops, stretch), key=lambda pair: pair[0][1]):
        shift = shifts[k] if k is not None else shift
        moved.append((op[0], op[1] - shift, op[2] - shift, op[3], op[4]))
    moved.sort(key=lambda op: op[1])
    return moved, calls, t0, [shifts[k] for k in sorted(shifts)]


def from_ns(spans, t0_ns: int) -> list:
    """``tpufem_torch.metrics.Span`` tuples → (name, parent, start_s,
    end_s, step) in seconds from ``t0_ns``."""
    return [(s[0], s[1], (s[2] - t0_ns) / 1e9, (s[3] - t0_ns) / 1e9, s[4]) for s in spans]


def innermost(spans, times) -> list:
    """For each time (or None), the index of the innermost span open at it,
    -1 where none is.  Spans nest, in the order they were entered."""
    out = [-1] * len(times)
    order = sorted((t, q) for q, t in enumerate(times) if t is not None)
    stack, j = [], 0
    for t, q in order:
        while j < len(spans) and spans[j][2] <= t:
            while stack and spans[stack[-1]][3] < spans[j][2]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]][3] < t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


def segments(spans, start: float, end: float) -> list:
    """[start, end] cut where the innermost open span changes → (a, b,
    span index or -1), in order."""
    cuts = sorted({start, end} | {t for s in spans for t in (s[2], s[3]) if start < t < end})
    mids = [(a + b) / 2 for a, b in zip(cuts, cuts[1:])]
    owners = innermost(spans, mids)
    out = []
    for a, b, i in zip(cuts, cuts[1:], owners):
        if out and out[-1][2] == i:
            out[-1] = (out[-1][0], b, i)
        else:
            out.append((a, b, i))
    return out


def idle(sp: Spanned) -> list:
    """The device's idle stretches inside the window → (a, b, name of the
    operation that follows, or None at the window's end)."""
    w0, w1 = sp.window
    gaps, end = [], w0
    for name, a, b, _, _ in sp.ops:
        if b <= w0 or a >= w1:
            continue
        if a > end:
            gaps.append((end, a, name))
        end = max(end, b)
    if end < w1:
        gaps.append((end, w1, None))
    return gaps


def idle_split(sp: Spanned) -> tuple[dict, dict]:
    """Each idle stretch split across the spans open on the host during it,
    by overlap → ({span path or OUTSIDE: seconds}, {"in PATH, before OP":
    seconds})."""
    by_path, labelled = {}, {}
    segs = segments(sp.spans, *sp.window)
    k = 0
    for a, b, follower in idle(sp):
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < b:
            s0, s1, i = segs[j]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                path = sp.path(i)
                by_path[path] = by_path.get(path, 0.0) + part
                where = f"in {path}" if i >= 0 else OUTSIDE
                label = f"{where}, before {follower[:80] if follower else 'the window end'}"
                labelled[label] = labelled.get(label, 0.0) + part
            j += 1
    return by_path, labelled


def _within(path: str, names) -> bool:
    return any(n in path.split("/") for n in names)


def kernel_s_by_path(sp: Spanned) -> dict:
    """Kernel device seconds by the path of the span each was launched in."""
    out = {}
    for op, i in zip(sp.ops, sp.owner):
        if op[3]:
            path = sp.path(i)
            out[path] = out.get(path, 0.0) + op[2] - op[1]
    return out


def _kernel_ms_per_step(sp: Spanned, keep) -> float | None:
    if not sp.spans:
        return None
    total = sum(s for path, s in kernel_s_by_path(sp).items() if keep(path))
    return 1e3 * total / sp.steps


def host_enqueue_ms(sp: Spanned) -> float | None:
    """Host wall milliseconds inside ``stokes.run`` spans a step."""
    runs = [s[3] - s[2] for s in sp.spans if s[0] == RUN]
    return 1e3 * sum(runs) / sp.steps if runs else None


def enqueue_idle_pct(sp: Spanned) -> float | None:
    """Share of the window's wall time in which the device was idle while
    a program span was open on the host."""
    if not sp.spans:
        return None
    by_path, _ = idle_split(sp)
    inside = sum(s for path, s in by_path.items() if path != OUTSIDE)
    return 100.0 * inside / sp.window_s()


def divgrad_ms_per_step(sp: Spanned) -> float | None:
    """Kernel device milliseconds a step launched in ``div`` and ``grad``
    spans."""
    return _kernel_ms_per_step(sp, lambda path: _within(path, DIVGRAD))


def glue_ms_per_step(sp: Spanned) -> float | None:
    """Kernel device milliseconds a step launched in ``stokes.run`` but
    outside the K2/K3 launches and ``div``/``grad``: the step's plain-torch
    work."""
    return _kernel_ms_per_step(sp, lambda path: path.split("/")[0] == RUN
                               and not _within(path, LAUNCHES + DIVGRAD))


def k2_ms_per_step(sp: Spanned) -> float | None:
    """Kernel device milliseconds a step launched in ``k2.launch`` spans."""
    return _kernel_ms_per_step(sp, lambda path: _within(path, ("k2.launch",)))


def visc_iters(sp: Spanned) -> float | None:
    """K2's iterations a viscous solve: the viscous solver's counter over
    the window ÷ the window's ``viscous_solve`` spans."""
    iters = sp.counters.get("visc_iters")
    solves = sum(1 for s in sp.spans if s[0] == "viscous_solve")
    return iters / solves if iters is not None and solves else None


def problem_build_s(sp: Spanned) -> float | None:
    """Seconds of the set-up's ``StokesProblem.build`` span."""
    builds = [s[3] - s[2] for s in sp.setup if s[0] == "StokesProblem.build"]
    return sum(builds) if builds else None


METRICS = {f.__name__: f for f in (host_enqueue_ms, enqueue_idle_pct, divgrad_ms_per_step,
                                   glue_ms_per_step, visc_iters, problem_build_s)}


def host_self(spans, top: int = 10) -> list:
    """[path, seconds] of the spans with most host self time (a span's
    duration less its children's), summed by path."""
    if not spans:
        return []
    sp = Spanned(steps=1, window=(0.0, 0.0), ops=[], spans=spans)
    own = [s[3] - s[2] for s in spans]
    for s in spans:
        if s[1] >= 0:
            own[s[1]] -= s[3] - s[2]
    by_path = {}
    for i, t in enumerate(own):
        by_path[sp.path(i)] = by_path.get(sp.path(i), 0.0) + t
    return [[p, t] for p, t in sorted(by_path.items(), key=lambda kv: -kv[1])[:top]]


def breakdown(sp: Spanned, top: int = 10) -> dict:
    """The device operations that took most time (as ``tracing.breakdown``),
    the idle gaps summed by the host spans open during each and the
    operation that followed, and the spans with most host self time."""
    by_name = {}
    for name, a, b, _, _ in sp.ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    _, labelled = idle_split(sp)
    gaps = sorted(labelled.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps],
            "host_self": host_self(sp.spans, top)}
