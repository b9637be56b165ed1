"""The yardstick's counts against hand counts, and the trace reduction."""

import importlib.util
import math

import pytest

from conftest import HERE
import models
from harness import counts, trace
from reference import config as ref_config

ROOT = HERE.parent


def dtu_cfg():
    return ref_config.load(str(HERE / "configs" / "dtu.conf"))


def garment_cfg():
    return ref_config.load(str(HERE / "configs" / "garment.conf"))


def test_udf_net_counts_by_hand():
    u = dtu_cfg().model.udf_network
    # 39 = 3 (1 + 2 x 6) inputs; layer 3 feeds the skip: 256 - 39 = 217 outputs
    assert counts.udf_widths(u) == [(39, 256), (256, 256), (256, 256), (256, 217), (256, 256),
                                    (256, 256), (256, 256), (256, 256), (256, 257)]
    full = 39 * 256 + 6 * 256 * 256 + 256 * 217 + 256 * 257
    p = counts.udf_passes(u)
    assert p == {"full": full, "one_col": full - 256 * 257 + 256, "no_col": full - 256 * 257}
    k = counts.fd_macs(u)
    assert k["K1"] == full + p["one_col"]
    assert k["K2"] == (full + p["no_col"]) + (p["one_col"] + full) + (full + p["one_col"])
    assert counts.udf_weights(u) == sum(a * b + b for a, b in counts.udf_widths(u))


def test_k1_k2_count_equals_chip_smoke_default_count():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from neuraludf_tpu_torch import config as port_config

    u_port = port_config.load(str(HERE / "configs" / "dtu.conf")).model.udf_network
    theirs = smoke.kernel_flops(u_port, 58368, "default")
    u = dtu_cfg().model.udf_network
    assert 2.0 * 58368 * counts.fd_macs(u)["K1"] == theirs["K1"]
    assert 2.0 * 58368 * counts.fd_macs(u)["K2"] == theirs["K2"]


def test_samples_rows_and_step_by_hand():
    d, g = dtu_cfg(), garment_cfg()
    m = models.load(models.DEFAULT)
    # classical: 5 rounds of 50 // 5 = 10, the last one not evaluated
    assert m.samples_per_ray(d.model.udf_renderer) == {"fg": 114, "valued": 104,
                                                            "nerf": 146}
    # mix: 6 rounds of 80 // 6 = 13, the last one not evaluated; no background
    assert m.samples_per_ray(g.model.udf_renderer) == {"fg": 142, "valued": 129,
                                                            "nerf": 0}
    assert m.fd_rows(d) == 58368 and m.fd_rows(g) == 72704
    # NeRF++: PE of 4 inputs at 10 frequencies = 84, skip after layer 4
    nerf = counts.nerf_widths(d.model.nerf)
    assert nerf == [(84, 256)] + [(256, 256)] * 4 + [(340, 256), (256, 256), (256, 256),
                                                     (256, 1), (256, 256), (283, 128),
                                                     (128, 3)]
    # colour: base 259 -> 128 x4 -> 3; main 128 + 3 + 27 = 158 -> 128 x4 -> 3 + 10
    col = m.color_widths(d.model.rendering_network)
    assert col == [(259, 128), (128, 128), (128, 128), (128, 128), (128, 3),
                   (158, 128), (128, 128), (128, 128), (128, 128), (128, 13)]
    s = m.step_flops(d)
    fwd_nerf = sum(a * b for a, b in nerf)
    assert s["nerf"] == 2.0 * 512 * 146 * (3 * fwd_nerf - 84 * 256)
    assert s["color"] == 2.0 * 512 * 114 * 3 * sum(a * b for a, b in col)
    assert s["upsampling"] == 2.0 * 512 * 104 * counts.udf_passes(d.model.udf_network)["one_col"]
    assert math.isclose(s["total"], sum(v for k, v in s.items() if k != "total"))
    assert m.step_flops(g)["nerf"] == 0.0
    # the DTU step is about 830 GFLOP, the garment step about 700
    assert 8.2e11 < s["total"] < 8.4e11
    assert 6.9e11 < m.step_flops(g)["total"] < 7.1e11


def test_bytes_and_roofline():
    u = dtu_cfg().model.udf_network
    b = counts.fd_bytes(u, 1000)
    n_w = counts.udf_weights(u) * 4
    assert b["K1"] == 1000 * 3 * 4 + n_w + 1000 * 260 * 4
    assert b["K2"] == 2 * 1000 * 3 * 4 + 1000 * 260 * 4 + 2 * n_w
    assert counts.roofline_s(989e12, 0, "default") == pytest.approx(1.0)
    assert counts.roofline_s(0, 3.35e12, "default") == pytest.approx(1.0)
    assert counts.roofline_s(67e12, 0, "highest") == pytest.approx(1.0)


@pytest.mark.parametrize("intervals, union, gaps", [
    ([(0, 10), (5, 15), (20, 30)], 25, [(15, 20)]),
    ([(0, 10), (2, 3), (10, 12)], 12, []),
    ([(5, 6)], 1, []),
    ([(0, 1), (2, 3), (4, 5)], 3, [(1, 2), (3, 4)]),
])
def test_union_not_sum(intervals, union, gaps):
    assert trace.union_length(intervals) == union
    assert trace.gaps(intervals) == gaps
