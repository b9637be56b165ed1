"""Faults planted under the timed path, to show that ``correct`` sees them.

Each planter replaces one function of the port by a broken one through
``put(owner, name, value)`` (``setattr`` by default; a test passes
``monkeypatch.setattr`` so that the port is restored after it). Where in
the port each fault goes is the model's (``models/<m>.py``
``FAULT_SITES``: the port's module and the attribute's path in it):

* ``half_batch`` (site ``rays``): half of every batch left out, the
  loss's means taken over the rest (the batch's second half is its first
  half again);
* ``unchanged`` (sites ``adam``): a step that leaves the parameters and the
  optimizer state as they were;
* ``k2_layer`` (site ``distance``): K2, the distance network's backward,
  returns the middle layer's weight and bias cotangents doubled (layer
  ``n_layers // 2``: ``lin4`` of the 8x256 net), as a cotangent doubled
  inside the sweep would leave one layer's weight gradient;
* ``crossed_scans`` (site ``scan_unit``): in a campaign's window, scan 1's
  step body reads scan 0's scene (its images, masks and cameras) in place
  of its own;
* ``moved_mesh`` (site ``classic_mesh``): the classic marching cubes of the
  runner's validation mesh returns its vertices half a grid step off along
  x, an answer altered where it is produced;
* ``moved_udf_mesh`` (site ``udf_mesh``): the MeshUDF extraction returns its
  vertices half a grid step off along x (its grid spans [-1, 1] at the
  call's ``resolution``);
* ``altered_image`` (site ``image_rows``): the validation render's colour
  and blended colour come out 1/32 brighter (8 levels of the written
  image).

``calibrate.py`` reads them on the card and ``tests/test_faults.py`` on the
CPU; the benchmark's own runs plant none. ``CONTROL`` is the pair of types
the control rounds to.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch


def site(model, name: str) -> Tuple[Any, str, Any]:
    """(owner, attribute, its value) of the model's fault site ``name``
    (or of one (module, path) pair)."""
    module, path = model.FAULT_SITES[name] if isinstance(name, str) else name
    owner = importlib.import_module(module)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr, getattr(owner, attr)


def half_batch(model, put: Callable = setattr) -> None:
    owner, attr, original = site(model, "rays")

    def halved(*args, **kwargs):
        out = original(*args, **kwargs)
        for key, t in out.items():
            if t is not None:
                half = t.shape[0] // 2
                out[key] = torch.cat([t[:half], t[:t.shape[0] - half]])
        return out

    put(owner, attr, halved)


def unchanged(model, put: Callable = setattr) -> None:
    for pair in model.FAULT_SITES["adam"]:
        owner, attr, _ = site(model, pair)
        put(owner, attr, lambda *a, **k: None)


class _DoubledCotangent(torch.autograd.Function):
    """The identity forward; twice the cotangent backward."""

    @staticmethod
    def forward(ctx, t):
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return 2.0 * g


def k2_layer(model, put: Callable = setattr) -> None:
    owner, attr, original = site(model, "distance")

    def doubled(params, x, cfg):
        key = f"lin{cfg.n_layers // 2}"
        layer = {name: _DoubledCotangent.apply(t) for name, t in params[key].items()}
        return original({**params, key: layer}, x, cfg)

    put(owner, attr, doubled)


def crossed_scans(model, put: Callable = setattr) -> None:
    owner, attr, original = site(model, "scan_unit")

    def crossed(self, params, opt_state, scene):
        return original(self, params, opt_state, {**scene, 1: scene[0]})

    put(owner, attr, crossed)


def moved_mesh(model, put: Callable = setattr) -> None:
    owner, attr, original = site(model, "classic_mesh")

    def moved(*args, **kwargs):
        verts, faces = original(*args, **kwargs)
        return verts + np.asarray([0.5, 0.0, 0.0], verts.dtype), faces

    put(owner, attr, moved)


def moved_udf_mesh(model, put: Callable = setattr) -> None:
    owner, attr, original = site(model, "udf_mesh")

    def moved(*args, **kwargs):
        verts, faces = original(*args, **kwargs)
        step = 1.0 / (kwargs.get("resolution", 128) - 1)  # half of 2 / (resolution - 1)
        return verts + np.asarray([step, 0.0, 0.0], verts.dtype), faces

    put(owner, attr, moved)


def altered_image(model, put: Callable = setattr) -> None:
    owner, attr, original = site(model, "image_rows")

    def altered(ret):
        rows = original(ret).clone()
        rows[:, :6] += 1.0 / 32.0
        return rows

    put(owner, attr, staticmethod(altered))


# the control's types: the plain reference in the port's place with every
# network product's operands in e4m3 and its cotangents in e5m2 (fp8
# training's pair; the step below the configurations' bf16 operands)
CONTROL = (torch.float8_e4m3fn, torch.float8_e5m2)

FAULTS: Dict[str, Callable] = {"half_batch": half_batch, "unchanged": unchanged,
                               "k2_layer": k2_layer, "crossed_scans": crossed_scans,
                               "moved_mesh": moved_mesh, "moved_udf_mesh": moved_udf_mesh,
                               "altered_image": altered_image}
