"""The attribution of ``harness/spans.py`` on synthetic intervals (idle by the
innermost span through its middle, unless its next operation was launched
before it began; a device operation by the innermost span that holds its
launch on its launching thread, else on the main thread), the host's work
as a span's shortest call times its calls,
the new readers' entries, and (A) and (B) through a tiny cell on the CPU."""

import json

import pytest

from conftest import HERE
from harness import cells, spans

MAIN, AUTOGRAD = 1, 7
NEW = ["runner_host_ms", "metric_wait_ms", "window_host_ms", "replay_launch_ms",
       "runner_idle_share", "window_idle_share", "render_fwd_ms", "render_bwd_ms", "adam_ms",
       "k3_path_ms"]


def index():
    """A window 0-100 on the main thread: schedules 0-10, the call 10-80
    (draws 10-20, replay 20-70), the fetch 80-90; on autograd's thread the
    fused op's backward 40-50 inside the main thread's step.grad 30-60."""
    return spans.SpanIndex({
        MAIN: [(0, 100, "runner.window"), (0, 10, "runner.schedules"), (10, 80, "window.call"),
               (10, 20, "window.draws"), (20, 70, "window.replay"), (80, 90, "runner.fetch"),
               (30, 60, "step.grad")],
        AUTOGRAD: [(40, 50, "op.fd_bwd")]})


def test_innermost_span_is_the_latest_that_holds_the_time():
    ix = index()
    assert ix.at(MAIN, 5) == "runner.schedules"
    assert ix.at(MAIN, 15) == "window.draws"
    assert ix.at(MAIN, 25) == "window.replay"
    assert ix.at(MAIN, 35) == "step.grad"
    assert ix.at(MAIN, 75) == "window.call"  # the replay ended at 70
    assert ix.at(MAIN, 95) == "runner.window"
    assert ix.at(MAIN, 150) is None and ix.at(AUTOGRAD, 30) is None and ix.at(99, 5) is None


def busy(*intervals):
    """Device operations (start, end, ready, correlation), each launched as
    it starts (the device waited for the launch), each its own launch."""
    return [(s, e, s, i) for i, (s, e) in enumerate(intervals)]


def test_idle_pieces_are_the_uncovered_stretches():
    assert spans.idle_pieces(busy((10, 20), (15, 30), (40, 50)), 0, 60) == [
        (0, 10, False), (30, 40, False), (50, 60, False)]
    assert spans.idle_pieces(busy((0, 60)), 0, 60) == []
    assert spans.idle_pieces(busy((-5, 5), (55, 70)), 0, 60) == [(5, 55, False)]
    assert spans.idle_pieces([], 0, 60) == [(0, 60, False)]
    # ready when the stretch began; one launch on both sides (the first operation
    # ends last, so the stretch at 30 follows it); ready unknown
    assert spans.idle_pieces([(10, 20, 5, 1), (15, 30, 0, 2), (40, 50, 30, 3)], 0, 60) == [
        (0, 10, False), (30, 40, True), (50, 60, False)]
    assert spans.idle_pieces([(0, 30, 0, 7), (5, 10, 0, 8), (40, 50, 45, 7)], 0, 50) == [
        (30, 40, True)]
    assert spans.idle_pieces([(0, 10, 0, 1), (20, 30, None, 2)], 0, 30) == [(10, 20, False)]


def test_idle_goes_to_the_span_through_its_middle():
    # device busy 2-8 and 12-74 and 76-100: idle 0-2 (schedules), 8-12 (middle 10:
    # the call starts there, its draws too: the latest start wins), 74-76 (the call)
    every, small = spans.attribute_idle(busy((2, 8), (12, 74), (76, 100)), 0, 100, index(),
                                        MAIN)
    assert every == {"runner.schedules": 2.0, "window.draws": 4.0, "window.call": 2.0}
    assert small == every  # all under 10 us
    every, small = spans.attribute_idle(busy((0, 81)), 0, 100, index(), MAIN)
    assert every == {"runner.window": 19.0} and small == {}  # middle 90.5: after the fetch


def test_idle_before_work_already_launched_is_the_devices_own():
    # the replay (host 20-70) launches a graph (correlation 9) whose call returns at 95;
    # its kernels run 30-40, 41-60 and 62-90: the gaps at 40 and 60 lie inside the graph
    # and are the device's; the first (25-30) waits on the launch, the last on the host
    ops = [(30, 40, 95, 9), (41, 60, 95, 9), (62, 90, 95, 9), (0, 25, 0, 1)]
    every, small = spans.attribute_idle(ops, 0, 100, index(), MAIN)
    assert every == {"window.replay": 5.0, spans.QUEUED: 3.0, "runner.window": 10.0}
    # the next graph was launched (returned at 24) before the gap at 25 began
    every, _ = spans.attribute_idle([(0, 25, 0, 1), (30, 40, 24, 2)], 0, 40, index(), MAIN)
    assert every == {spans.QUEUED: 5.0}
    # a launch that returns only after the gap began, or is not known: the middle rule
    for ready in (26, None):
        every, _ = spans.attribute_idle([(0, 25, 0, 1), (30, 40, ready, 2)], 0, 40, index(),
                                        MAIN)
        assert every == {"window.replay": 5.0}


def test_idle_while_the_profiler_takes_a_buffer_is_the_profilers():
    ix = spans.SpanIndex({MAIN: index()._by[MAIN][1] + [(80, 88, spans.PROFILER)]})
    every, _ = spans.attribute_idle(busy((0, 81)), 0, 90, ix, MAIN)
    assert every == {spans.PROFILER: 9.0}  # middle 85.5: in the fetch, in the request


def test_events_are_split_into_operations_spans_launches_and_overhead():
    from torch.autograd import DeviceType

    class Ev:  # a kineto event of a torch without ``activity_type``
        def __init__(self, name, dev, s, d, corr=0, link=0, thread=MAIN):
            self.v = (name, dev, s * 1000, d * 1000, corr, link, thread)

        def name(self): return self.v[0]
        def device_type(self): return self.v[1]
        def start_ns(self): return self.v[2]
        def duration_ns(self): return self.v[3]
        def correlation_id(self): return self.v[4]
        def linked_correlation_id(self): return self.v[5]
        def start_thread_id(self): return self.v[6]

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    raw = [Ev("runner.window", cpu, 0, 100, corr=1), Ev("runner.window", gpu, 5, 90),
           Ev("aten::mul", cpu, 10, 2, corr=2), Ev("cudaLaunchKernel", cpu, 11, 1, corr=3),
           Ev("mul_kernel", gpu, 20, 4, corr=3, link=2),
           Ev(spans.BUFFER_REQUEST, cpu, 40, 3)]

    class Prof:
        class profiler:
            class kineto_results:
                events = staticmethod(lambda: raw)

    ev = spans.events_of(Prof)
    assert ev.device == [(20.0, 24.0, 3, 2)]  # the span's device-side range is left out
    assert ev.spans == {MAIN: [(0.0, 100.0, "runner.window")]}
    assert ev.launches == {3: (11.0, 12.0, MAIN)}
    assert ev.overhead == {MAIN: [(40.0, 43.0, spans.PROFILER)]}
    assert set(ev.ops) == {1, 2}


def test_a_stretch_outside_every_span_is_no_span():
    every, _ = spans.attribute_idle(busy((0, 10)), 0, 200, index(), MAIN)
    assert every == {spans.NO_SPAN: 190.0}


def test_the_work_of_a_span_is_its_shortest_call_times_its_calls():
    class R:  # (A) of 10 steps: 10 replays, the first 2 ms, the others waiting
        steps_a = 10
        host = {"window.replay": {"calls": 10, "total_ns": 2e6 + 9 * 20e6,
                                  "self_ns": 2e6 + 9 * 20e6, "min_ns": 2e6},
                "window.call": {"calls": 1, "total_ns": 200e6, "self_ns": 5e6,
                                "min_ns": 200e6}}

    ctx = Ctx(runner=None)
    ctx.port_spans = R()
    assert spans.host_ms(ctx, ("window.replay",), "work") == pytest.approx(2.0)
    assert spans.host_ms(ctx, ("window.replay",), "total") == pytest.approx(18.2)
    assert spans.host_ms(ctx, ("window.call",), "self") == pytest.approx(0.5)
    assert cells.load_reader("replay_launch_ms", HERE).read(ctx) == pytest.approx(2.0)
    assert cells.load_reader("window_host_ms", HERE).read(ctx) == pytest.approx(0.5)


def test_ops_go_to_their_launching_thread_else_the_main_thread():
    ops = [(100, 104, MAIN, 5),  # launched in the schedules
           (100, 110, AUTOGRAD, 45),  # K2, on autograd's thread inside op.fd_bwd
           (110, 113, AUTOGRAD, 55),  # backward outside op.fd_bwd: main's step.grad
           (113, 114, None, 25),  # no launching thread known: main's replay
           (114, 116, MAIN, 150)]  # launched outside every span
    us, n = spans.attribute_ops(ops, index(), MAIN)
    assert us == {"runner.schedules": 4, "op.fd_bwd": 10, "step.grad": 3, "window.replay": 1,
                  spans.NO_SPAN: 2}
    assert n == {"runner.schedules": 1, "op.fd_bwd": 1, "step.grad": 1, "window.replay": 1,
                 spans.NO_SPAN: 1}


def test_a_launch_is_the_runtime_call_on_the_linked_ops_thread():
    ev = spans.Events(ops={11: (40.0, AUTOGRAD)}, launches={500: (41.5, 42.0, 3)})
    assert spans.launch_of(ev, 500, 11, 99.0) == (AUTOGRAD, 41.5)
    assert spans.launch_of(ev, 500, 0, 99.0) == (3, 41.5)  # not linked: the call's thread
    assert spans.launch_of(ev, 501, 11, 99.0) == (AUTOGRAD, 40.0)  # no call: the op's start
    assert spans.launch_of(ev, 501, 12, 99.0) == (None, 99.0)


def test_operations_belong_to_the_window_that_launched_them():
    """A device clock some microseconds late: the first window's last kernel
    (its graph launched at 40) starts after the second window began, the
    second's last (launched at 195) after it ended. Each still counts in the
    window that launched it."""
    spans_ = {MAIN: [(0, 100, "runner.window"), (20, 70, "window.replay"),
                     (100, 200, "runner.window"), (110, 150, "step.render"),
                     (150, 200, "step.adam")]}
    spans_[MAIN] += [(150 + i, 151 + i, "step.adam") for i in range(spans.EAGER_STEPS - 1)]
    ev = spans.Events(
        device=[(30, 60, 1, 0), (62, 101, 1, 0), (101, 104, 1, 0), (121, 130, 2, 12),
                (201, 205, 3, 13)],
        spans=spans_, ops={12: (120.0, MAIN), 13: (194.0, MAIN)},
        launches={1: (40.0, 45.0, MAIN), 2: (120.5, 121.0, MAIN), 3: (195.0, 196.0, MAIN)})
    out = spans.Reading(steps_b=1)
    spans._read_trace(out, ev, replayed=True)
    assert out.replay_busy_us == 72.0  # 30-60 and 62-104
    assert out.idle_us == {"runner.window": 30.0, spans.QUEUED: 2.0}
    assert out.eager_ops == 2 and out.eager_us == {"step.render": 9.0, "step.adam": 4.0}


def test_the_new_metrics_are_appended_with_their_cells():
    bench = cells.load_benchmark()
    names = [m["name"] for m in bench["per_layer"]]
    assert names[:5] == ["kernels_per_step", "device_idle_share", "step_mfu", "fd_fwd_roofline",
                         "fd_bwd_roofline"]
    assert names[5:5 + len(NEW)] == NEW
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"], bench)
        got = [m.name for m in cell.per_layer if m.name in NEW]
        if cell.workload.get("scans", 1) > 1:  # MultiScanRunner.train has no runner.* spans
            assert got == []
            continue
        if w["name"] == "dtu.periodic":  # its traced windows are dtu.stage1's, read there
            assert got == []
            continue
        assert got == [n for n in NEW if n != "k3_path_ms" or w["name"] == "dtu.finetune"]
        for n in got:
            assert callable(cells.load_reader(n).read)


class Ctx:
    def __init__(self, runner):
        self.runner = runner


@pytest.mark.parametrize("cell_name", ["tiny.stage1", "tiny.finetune"])
def test_a_and_b_run_on_the_cpu(tiny_bench, tmp_path, capsys, cell_name):
    """On the CPU the window's units run eagerly, so no host number is read;
    the profiled eager steps find no device operation. The runs complete,
    the readers return None, and tracing is off after."""
    import torch

    from harness import session
    from neuraludf_tpu_torch.utils import trace as port

    cell = cells.load_cell(cell_name, here=tiny_bench)
    setup = session.build(cell, 2**31 + 5, torch.device("cpu"), str(tmp_path),
                          cache=tmp_path / "scenes")
    ctx = Ctx(setup.runner)
    before = setup.runner.iter_step
    r = spans.measured(ctx)
    assert spans.measured(ctx) is r  # once a run
    assert setup.runner.iter_step == before + 2 * session.WINDOW + spans.EAGER_STEPS
    assert r.host is None and r.notes["counts_a"] == {"window.eager_units": session.WINDOW}
    assert r.idle_us is None and r.eager_us is None
    for name in NEW:
        assert cells.load_reader(name, HERE).read(ctx) is None, name
    assert not port.enabled() and port.snapshot() == {"spans": {}, "counts": {}}
    line = capsys.readouterr().err.strip().splitlines()[-1]
    assert line.startswith("spans ") and json.loads(line[6:])["steps"] == [50, 50, 0]


def test_a_program_without_spans_reads_none(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "neuraludf_tpu_torch.utils.trace", None)  # import fails
    ctx = Ctx(runner=None)
    assert spans.measured(ctx) is None
    for name in NEW:
        assert cells.load_reader(name, HERE).read(ctx) is None, name
