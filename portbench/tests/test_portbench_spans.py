"""``spans.py``, the program's spans read against the device timeline, on a
hand-built window: operations put down to the span open at their launch,
idle gaps split across the host spans open during them, each metric, and
None where the window has no spans; on the card, the grid kernels of a
real traced window against the launch spans that launched them."""

import json
import subprocess
import sys

import pytest
import tiny

from portbench import spans

ROOT = tiny.ROOT

# (name, parent, start_s, end_s, step): one step of a run
SPANS = [
    ("stokes.run", -1, 0.0, 10.0, -1),
    ("step", 0, 1.0, 9.0, 0),
    ("viscous_solve", 1, 1.0, 3.0, 0),
    ("k2.launch", 2, 2.0, 2.5, 0),
    ("div", 1, 3.0, 4.0, 0),
    ("pressure_solve", 1, 4.0, 7.0, 0),
    ("k3.launch", 5, 5.0, 6.0, 0),
    ("grad", 1, 7.0, 8.0, 0),
]
# (name, start_s, end_s, is_kernel, launch_s or None), sorted by start
OPS = [
    ("rhs", 1.6, 2.0, True, 1.5),
    ("viscous_cg_kernel", 2.6, 3.6, True, 2.2),
    ("div_kernel", 3.6, 4.2, True, 3.5),
    ("merge", 4.5, 5.0, True, 4.2),
    ("pressure_cg_kernel", 5.5, 6.5, True, 5.2),
    ("grad_kernel", 7.5, 7.9, True, 7.2),
    ("unpaired", 8.5, 8.6, True, None),
    ("Memcpy DtoH", 10.5, 11.0, False, 10.2),
]
SETUP = [("StokesProblem.build", -1, 0.0, 40.0, -1), ("gridify", 0, 1.0, 2.0, -1)]


def window(**kw):
    args = dict(steps=1, window=(0.0, 12.0), ops=OPS, spans=SPANS, setup=SETUP,
                counters={"visc_iters": 3})
    args.update(kw)
    return spans.Spanned(**args)


def test_ops_put_down_to_the_span_open_at_their_launch():
    sp = window()
    assert [sp.path(i) for i in sp.owner] == [
        "stokes.run/step/viscous_solve", "stokes.run/step/viscous_solve/k2.launch",
        "stokes.run/step/div", "stokes.run/step/pressure_solve",
        "stokes.run/step/pressure_solve/k3.launch", "stokes.run/step/grad",
        spans.OUTSIDE, spans.OUTSIDE]
    assert spans.innermost(SPANS, [0.5, 9.5, 2.0, 2.5, 11.0]) == [0, 0, 3, 3, -1]


def test_a_gap_across_two_host_spans_is_split_by_overlap():
    by_path, labelled = spans.idle_split(window())
    want = {"stokes.run": 2.0, "stokes.run/step/viscous_solve": 0.7,
            "stokes.run/step/viscous_solve/k2.launch": 0.5,
            "stokes.run/step/pressure_solve": 0.8,
            "stokes.run/step/pressure_solve/k3.launch": 0.5, "stokes.run/step/grad": 0.6,
            "stokes.run/step": 0.9, spans.OUTSIDE: 1.5}
    assert by_path == pytest.approx(want)
    assert sum(by_path.values()) == pytest.approx(12.0 - 4.5)  # the window less the busy time
    # the first gap, [0, 1.6], lies 1.0 in the run and 0.6 in the viscous solve
    assert labelled["in stokes.run, before rhs"] == pytest.approx(1.0)
    assert labelled["in stokes.run/step/viscous_solve, before rhs"] == pytest.approx(0.6)
    assert labelled[f"{spans.OUTSIDE}, before the window end"] == pytest.approx(1.0)


def test_metrics_of_the_window():
    sp = window()
    assert spans.host_enqueue_ms(sp) == pytest.approx(10_000.0)
    assert spans.enqueue_idle_pct(sp) == pytest.approx(100.0 * 6.0 / 12.0)
    assert spans.divgrad_ms_per_step(sp) == pytest.approx(1000.0)
    assert spans.glue_ms_per_step(sp) == pytest.approx(900.0)  # rhs and merge, not "unpaired"
    assert spans.k2_ms_per_step(sp) == pytest.approx(1000.0)
    assert spans.visc_iters(sp) == pytest.approx(3.0)
    assert spans.problem_build_s(sp) == pytest.approx(40.0)
    two = window(steps=2)
    assert spans.divgrad_ms_per_step(two) == pytest.approx(500.0)


def test_none_without_spans():
    """As under the precision control, which records no spans, or a
    program without them."""
    sp = window(spans=[], setup=[], counters={})
    assert all(f(sp) is None for f in spans.METRICS.values())
    assert spans.breakdown(sp)["host_self"] == []
    assert spans.idle_split(sp)[0] == pytest.approx({spans.OUTSIDE: 7.5})


def test_breakdown_and_host_self():
    out = spans.breakdown(window(), top=3)
    assert list(out) == ["device_ops", "idle_gaps", "host_self"]
    assert out["device_ops"][0] == ["viscous_cg_kernel", pytest.approx(1.0)]
    assert len(out["idle_gaps"]) == 3
    assert [gap[1] for gap in out["idle_gaps"]] == pytest.approx([1.0, 1.0, 1.0])
    assert {gap[0] for gap in out["idle_gaps"]} == {
        "in stokes.run, before rhs", "in stokes.run, before Memcpy DtoH",
        f"{spans.OUTSIDE}, before the window end"}
    self_time = dict(spans.host_self(SPANS))
    assert self_time == pytest.approx({
        "stokes.run": 2.0, "stokes.run/step": 1.0, "stokes.run/step/viscous_solve": 1.5,
        "stokes.run/step/viscous_solve/k2.launch": 0.5, "stokes.run/step/div": 1.0,
        "stokes.run/step/pressure_solve": 2.0, "stokes.run/step/pressure_solve/k3.launch": 1.0,
        "stokes.run/step/grad": 1.0})


class _Event:
    """A profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, device, start, end, cid, annotation=False):
        self._v = (name, device, start, end, cid, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_device_ops_pair_launches_and_move_the_device_clock_onto_the_hosts():
    """Each device operation takes the start of the API call with its
    correlation id; the device's times move, stretch by stretch between
    the host's synchronisations, so that none starts before its launch
    (here the device clock reads 300 µs early, then 2 ms early after the
    synchronise at 3 ms; after the one at 5 ms it is right)."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    cpu, cuda, t0 = DeviceType.CPU, DeviceType.CUDA, 10_000_000
    events = [
        _Event("cudaLaunchKernel", cpu, t0 + 1000_000, t0 + 1005_000, 7),
        _Event("k", cuda, t0 + 710_000, t0 + 900_000, 7),
        _Event("cudaMemcpyAsync", cpu, t0 + 2000_000, t0 + 2020_000, 8),
        _Event("Memcpy HtoD (Pageable -> Device)", cuda, t0 + 1720_000, t0 + 1730_000, 8),
        _Event("stokes.run", cuda, t0, t0 + 3000_000, 9, annotation=True),
        _Event("aten::mul", cpu, t0 + 100, t0 + 200, 7),
        _Event("orphan", cuda, t0 + 2500_000, t0 + 2600_000, 11),
        _Event("cudaDeviceSynchronize", cpu, t0 + 3000_000, t0 + 3100_000, 12),
        _Event("cudaLaunchKernel", cpu, t0 + 4000_000, t0 + 4005_000, 13),
        _Event("late", cuda, t0 + 2010_000, t0 + 2050_000, 13),
        _Event("cudaLaunchKernel", cpu, t0 + 4100_000, t0 + 4105_000, 14),
        _Event("later", cuda, t0 + 2150_000, t0 + 2160_000, 14),
        _Event("cudaStreamSynchronize", cpu, t0 + 5000_000, t0 + 5010_000, 15),
        _Event("cudaLaunchKernel", cpu, t0 + 6000_000, t0 + 6005_000, 16),
        _Event("last", cuda, t0 + 6020_000, t0 + 6030_000, 16),
    ]
    results = SimpleNamespace(trace_start_ns=lambda: t0, events=lambda: events)
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))
    ops, calls, start, shifts = spans.device_ops(prof)
    assert start == t0 and shifts == pytest.approx([-290e-6, -1990e-6, 0.0])
    assert [(op[0], op[3]) for op in ops] == [
        ("k", True), ("Memcpy HtoD (Pageable -> Device)", False), ("late", True),
        ("later", True), ("orphan", True), ("last", True)]
    assert ops[0][1:3] == pytest.approx((1000e-6, 1190e-6))  # starts as it is launched
    assert ops[0][4] == pytest.approx(1000e-6) and ops[1][4] == pytest.approx(2000e-6)
    assert ops[1][1:3] == pytest.approx((2010e-6, 2020e-6))
    assert ops[2][1:3] == pytest.approx((4000e-6, 4040e-6))
    assert ops[3][1:3] == pytest.approx((4140e-6, 4150e-6))
    # no launch record: the shift of the operation before it on the device
    assert ops[4][4] is None and ops[4][1] == pytest.approx(4490e-6)
    assert ops[5][1:3] == pytest.approx((6020e-6, 6030e-6))  # 20 µs after its launch: kept
    assert [c[0] for c in calls] == ["cudaLaunchKernel", "cudaMemcpyAsync",
                                     "cudaDeviceSynchronize", "cudaLaunchKernel",
                                     "cudaLaunchKernel", "cudaStreamSynchronize",
                                     "cudaLaunchKernel"]


def test_segments_merge_runs_of_one_span():
    assert spans.segments(SPANS[:1], -1.0, 11.0) == [(-1.0, 0.0, -1), (0.0, 10.0, 0),
                                                     (10.0, 11.0, -1)]


@pytest.mark.card
def test_grid_kernels_lie_in_their_launch_spans_on_the_card(card):
    """A traced window of ``stokes_1m.steady`` with the spans on: every
    kernel of ``grid_cg.cu`` put down to the ``k2.launch``/``k3.launch``
    span that launched it, starting after the span opened."""
    out = subprocess.run([sys.executable, "span_window.py", "--workload", "stokes_1m.steady",
                          "--seed", "2147484999"], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    c = line["checks"]
    assert c["grid_kernels"] > 0
    assert c["grid_kernels_in_their_launch_span"] == c["grid_kernels"]
    assert c["grid_kernel_start_after_span_start_min_us"] >= 0
