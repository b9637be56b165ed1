"""The port's spans and counters (``neuraludf_tpu_torch/utils/trace.py``) and
where the training records them, on the CPU at a tiny size: off, a span is
one shared no-op and nothing is recorded; on, spans nest, their self time
leaves out their children, counters add up; a ``Runner.train`` records the
runner's, the window's and the step's spans with the counts a window asks
for, and under ``torch.profiler`` they are nested ``record_function``
events; the multi-scan runner's ``train``, the same loop, records the
same. Also the reported rate of ``Runner.train`` and of the multi-scan
runner, which counts from the previous report only."""

import logging
import time

import pytest
import torch

from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch.data.synthetic import generate_scene
from neuraludf_tpu_torch.parallel.multi_scan import MultiScanRunner
from neuraludf_tpu_torch.train import runner as trunner
from neuraludf_tpu_torch.utils import trace

W = 4  # the window: report_freq divides every other frequency


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_trace") / "sphere"
    generate_scene(str(d), kind="sphere", n_views=4, H=24, W=32, focal=40.0)
    return str(d)


def tiny_cfg(scene_dir, exp_dir, end_iter, report_freq=W):
    return tconfig.from_dict({
        "general": {"base_exp_dir": exp_dir, "expname": "trace"},
        "dataset": {"data_dir": scene_dir, "dataset_name": "general"},
        "train": {"end_iter": end_iter, "batch_size": 8, "warm_up_end": 10, "anneal_end": 20,
                  "fix_geo_end": 2, "save_freq": 1000, "val_freq": 1000,
                  "val_mesh_freq": 1000, "report_freq": report_freq},
        "model": {
            "nerf": {"D": 2, "W": 16, "multires": 2, "multires_view": 1, "skips": [0]},
            "udf_network": {"d_out": 9, "d_hidden": 16, "n_layers": 3, "skip_in": [2],
                            "multires": 2},
            "rendering_network": {"d_feature": 8, "d_hidden": 16, "n_layers": 2},
            "udf_renderer": {"n_samples": 8, "n_importance": 4, "n_outside": 4,
                             "up_sample_steps": 2, "perturb": 1.0},
        },
    })


def test_off_records_nothing_and_shares_one_object():
    assert not trace.enabled()
    a, b = trace.span("runner.window"), trace.span("step.render")
    assert a is b is trace.OFF
    with trace.span("runner.window"):
        trace.count("window.replays", 3)
    assert trace.snapshot() == {"spans": {}, "counts": {}}


def test_spans_nest_and_self_time_leaves_out_children():
    trace.enable()
    with trace.span("outer"):
        time.sleep(0.02)
        for _ in range(2):
            with trace.span("inner"):
                time.sleep(0.03)
    trace.disable()
    spans = trace.snapshot()["spans"]
    outer, inner = spans["outer"], spans["inner"]
    assert (outer["calls"], inner["calls"]) == (1, 2)
    assert inner["total_ns"] == inner["self_ns"] >= 0.06e9
    assert outer["self_ns"] >= 0.02e9
    assert outer["total_ns"] - outer["self_ns"] == inner["total_ns"]
    assert outer["min_ns"] == outer["total_ns"]
    assert 0.03e9 <= inner["min_ns"] <= inner["total_ns"] / 2


def test_the_shortest_call_is_kept_apart_from_the_total():
    trace.enable()
    for pause in (0.06, 0.005, 0.05):
        with trace.span("call"):
            time.sleep(pause)
    trace.disable()
    agg = trace.snapshot()["spans"]["call"]
    assert agg["calls"] == 3 and 0.005e9 <= agg["min_ns"] < 0.05e9
    assert agg["total_ns"] - agg["min_ns"] >= 0.11e9


def test_counters_add_and_reset():
    trace.enable()
    trace.count("window.replays")
    trace.count("window.replays", 4)
    trace.count("window.captures")
    assert trace.snapshot()["counts"] == {"window.replays": 5, "window.captures": 1}
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counts": {}}


def test_a_span_on_another_thread_keeps_its_own_stack():
    import threading

    def side():
        with trace.span("side"):
            pass

    trace.enable()
    with trace.span("main"):
        t = threading.Thread(target=side)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    spans = trace.snapshot()["spans"]
    assert spans["side"]["calls"] == 1
    assert spans["main"]["self_ns"] == spans["main"]["total_ns"]  # side is no child of main


RUNNER_SPANS = {"runner.window": 1, "runner.schedules": 2, "runner.fetch": 1, "runner.log": 1,
                "runner.periodic": 1, "window.call": 1, "window.draws": W}
STEP_SPANS = ("step.sample", "step.render", "step.loss", "step.grad", "step.adam")


@pytest.mark.parametrize("windows", [1, 2])
def test_runner_train_records_each_layer_a_window(scene_dir, tmp_path, windows):
    r = trunner.Runner(tiny_cfg(scene_dir, str(tmp_path), end_iter=windows * W), device="cpu")
    trace.enable()
    r.train()
    trace.disable()
    snap = trace.snapshot()
    calls = {k: v["calls"] for k, v in snap["spans"].items()}
    want = {k: n * windows for k, n in RUNNER_SPANS.items()}
    want.update({k: W * windows for k in STEP_SPANS})
    assert calls == want  # no op.* on the CPU: the fused op and K3 are off there
    # on the CPU the window's units run eagerly; no graph is captured or replayed
    assert snap["counts"] == {"window.eager_units": W * windows}
    for name, agg in snap["spans"].items():
        assert 0 <= agg["self_ns"] <= agg["total_ns"], name
    spans = snap["spans"]
    children = sum(spans[k]["total_ns"] for k in (
        "runner.schedules", "runner.fetch", "runner.log", "runner.periodic", "window.call"))
    # both schedule spans (the views, and in _train_window the rest) are the window's children
    assert spans["runner.window"]["total_ns"] - spans["runner.window"]["self_ns"] == children


@pytest.mark.parametrize("windows", [1, 2])
def test_multi_scan_train_records_the_runner_spans_a_window(scene_dir, tmp_path, windows):
    """MultiScanRunner.train runs Runner.train's loop and window: the same
    runner and window spans a window, every scan's step spans an iteration,
    one eager unit an iteration of both scans."""
    cfg = tiny_cfg(scene_dir, str(tmp_path / "single"), end_iter=windows * W)
    ms = MultiScanRunner(cfg, [scene_dir, scene_dir], case_names=["a", "b"],
                         out_dir=str(tmp_path / "ms"), device="cpu")
    trace.enable()
    ms.train()
    trace.disable()
    snap = trace.snapshot()
    calls = {k: v["calls"] for k, v in snap["spans"].items()}
    want = {k: n * windows for k, n in RUNNER_SPANS.items()}
    want.update({k: 2 * W * windows for k in STEP_SPANS})
    assert calls == want
    assert snap["counts"] == {"window.eager_units": W * windows}
    spans = snap["spans"]
    children = sum(spans[k]["total_ns"] for k in (
        "runner.schedules", "runner.fetch", "runner.log", "runner.periodic", "window.call"))
    assert spans["runner.window"]["total_ns"] - spans["runner.window"]["self_ns"] == children


def test_a_short_window_steps_eagerly_under_the_runner(scene_dir, tmp_path):
    """A window shorter than W takes the eager path: step spans without a
    window.call, and no window counter."""
    r = trunner.Runner(tiny_cfg(scene_dir, str(tmp_path), end_iter=3), device="cpu")
    trace.enable()
    r.train()
    trace.disable()
    snap = trace.snapshot()
    assert "window.call" not in snap["spans"] and snap["counts"] == {}
    assert {k: snap["spans"][k]["calls"] for k in STEP_SPANS} == {k: 3 for k in STEP_SPANS}
    assert snap["spans"]["runner.window"]["calls"] == 1


def test_the_fused_op_records_its_forward_and_backward(scene_dir, tmp_path):
    """op.fd_fwd at the op's entry, op.fd_bwd in its autograd backward (its
    explicit plain version on the CPU)."""
    from neuraludf_tpu_torch.ops import fused_distance as fd

    cfg = tiny_cfg(scene_dir, str(tmp_path), end_iter=W)
    r = trunner.Runner(cfg, device="cpu")
    x = torch.rand((16, 3)) - 0.5
    trace.enable()
    u, f, g = fd.distance_value_feat_grad_fused(r.params["udf"], x, cfg.model.udf_network)
    (u.sum() + f.sum() + g.sum()).backward()
    trace.disable()
    spans = trace.snapshot()["spans"]
    assert spans["op.fd_fwd"]["calls"] == spans["op.fd_bwd"]["calls"] == 1


def test_spans_are_nested_record_function_events(scene_dir, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    r = trunner.Runner(tiny_cfg(scene_dir, str(tmp_path), end_iter=W), device="cpu")
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.train()
    trace.disable()
    events = [e for e in prof.events() if e.name.split(".")[0] in ("runner", "window", "step")]
    names = [e.name for e in events]
    for name, n in {**RUNNER_SPANS, **{k: W for k in STEP_SPANS}}.items():
        assert names.count(name) == n, name

    def ancestors(e):
        out, p = [], e.cpu_parent
        while p is not None:
            out.append(p.name)
            p = p.cpu_parent
        return out

    render = next(e for e in events if e.name == "step.render")
    assert {"window.call", "runner.window"} <= set(ancestors(render))
    draws = next(e for e in events if e.name == "window.draws")
    assert ancestors(draws)[:2] == ["window.call", "runner.window"]
    window = next(e for e in events if e.name == "runner.window")
    for e in events:
        if e is not window:
            assert window.time_range.start <= e.time_range.start <= e.time_range.end \
                <= window.time_range.end, e.name


def test_iter_rate_counts_from_the_previous_report(monkeypatch):
    clock = iter([100.0, 104.0, 106.0])
    monkeypatch.setattr(trunner.time, "time", lambda: next(clock))
    rate, mark = trunner.iter_rate(None, 100)  # the first report: warm-up and capture
    assert rate is None and mark == (100, 100.0)
    rate, mark = trunner.iter_rate(mark, 200)
    assert rate == pytest.approx(25.0) and mark == (200, 104.0)
    rate, mark = trunner.iter_rate(mark, 300)
    assert rate == pytest.approx(50.0)
    assert trunner.rate_text(None) == "first report"
    assert trunner.rate_text(12.345) == "12.3 it/s"


def rates(caplog):
    return [rec.getMessage().rsplit("(", 1)[1] for rec in caplog.records
            if rec.getMessage().startswith("iter ")]


def test_runner_reports_the_rate_since_its_previous_report(scene_dir, tmp_path, caplog):
    r = trunner.Runner(tiny_cfg(scene_dir, str(tmp_path), end_iter=3 * W, report_freq=W),
                       device="cpu")
    with caplog.at_level(logging.INFO, logger=trunner.log.name):
        r.train()
    got = rates(caplog)
    assert got[0] == "first report)" and len(got) == 3
    assert all(g.endswith(" it/s)") and float(g.split()[0]) > 0 for g in got[1:])


def test_multi_scan_reports_the_rate_since_its_previous_report(scene_dir, tmp_path, caplog):
    from neuraludf_tpu_torch.parallel import multi_scan

    cfg = tiny_cfg(scene_dir, str(tmp_path / "single"), end_iter=3 * W, report_freq=W)
    ms = MultiScanRunner(cfg, [scene_dir, scene_dir], case_names=["a", "b"],
                         out_dir=str(tmp_path / "ms"), device="cpu")
    with caplog.at_level(logging.INFO, logger=multi_scan.log.name):
        ms.train()
    got = rates(caplog)
    assert got[0] == "first report)" and len(got) == 3
    assert all(g.endswith(" it/s)") and float(g.split()[0]) > 0 for g in got[1:])
