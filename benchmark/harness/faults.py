"""Faults planted under the timed path, to show that ``correct`` sees them.

Each planter replaces one function of the port by a broken one through
``put(module, name, value)`` (``setattr`` by default; a test passes
``monkeypatch.setattr`` so that the port is restored after it):

* ``half_batch``: half of every batch left out, the loss's means taken
  over the rest (the batch's second half is its first half again);
* ``unchanged``: a step that leaves the parameters and the optimizer state
  as they were;
* ``k2_layer``: K2, the distance network's backward, returns the middle
  layer's weight and bias cotangents doubled (layer ``n_layers // 2``:
  ``lin4`` of the 8x256 net), as a cotangent doubled inside the sweep
  would leave one layer's weight gradient;
* ``crossed_scans``: in a campaign's window, scan 1's step body reads scan
  0's scene (its images, masks and cameras) in place of its own.

``calibrate.py`` reads them on the card and ``tests/test_faults.py`` on the
CPU; the benchmark's own runs plant none. ``CONTROL`` is the pair of types
the control rounds to.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def half_batch(put: Callable = setattr) -> None:
    from neuraludf_tpu_torch.train import step as port_step

    original = port_step.sample_random_rays

    def halved(*args, **kwargs):
        out = original(*args, **kwargs)
        for key, t in out.items():
            if t is not None:
                half = t.shape[0] // 2
                out[key] = torch.cat([t[:half], t[:t.shape[0] - half]])
        return out

    put(port_step, "sample_random_rays", halved)


def unchanged(put: Callable = setattr) -> None:
    from neuraludf_tpu_torch.train import step as port_step

    put(port_step, "adam_step", lambda *a, **k: None)
    put(port_step, "flat_adam_step", lambda *a, **k: None)


class _DoubledCotangent(torch.autograd.Function):
    """The identity forward; twice the cotangent backward."""

    @staticmethod
    def forward(ctx, t):
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return 2.0 * g


def k2_layer(put: Callable = setattr) -> None:
    from neuraludf_tpu_torch.nets import fields

    original = fields.distance_value_and_gradient

    def doubled(params, x, cfg):
        key = f"lin{cfg.n_layers // 2}"
        layer = {name: _DoubledCotangent.apply(t) for name, t in params[key].items()}
        return original({**params, key: layer}, x, cfg)

    put(fields, "distance_value_and_gradient", doubled)


def crossed_scans(put: Callable = setattr) -> None:
    from neuraludf_tpu_torch.parallel import multi_scan

    original = multi_scan.MultiScanWindow._unit

    def crossed(self, params, opt_state, scene):
        return original(self, params, opt_state, {**scene, 1: scene[0]})

    put(multi_scan.MultiScanWindow, "_unit", crossed)


# the control's types: the plain reference in the port's place with every
# network product's operands in e4m3 and its cotangents in e5m2 (fp8
# training's pair; the step below the configurations' bf16 operands)
CONTROL = (torch.float8_e4m3fn, torch.float8_e5m2)

FAULTS: Dict[str, Callable] = {"half_batch": half_batch, "unchanged": unchanged,
                               "k2_layer": k2_layer, "crossed_scans": crossed_scans}
