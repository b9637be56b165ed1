"""The comparison that decides ``correct``.

Set-up drives the port's own training object from the seed through its
first steps, through the window's own call, and keeps what the plain
reference needs to follow the first ``FOLLOW`` of them: each step's loss,
the optimizer's first moments after step 1 and the parameters after step
``FOLLOW``. The reference then runs the same steps from the same start on
the same draws, views and schedules, and seven numbers are worked out (in a
campaign for each scan on its own, and each number's worst scan is what is
judged); a cell's ``limits`` name those it compares:

* ``loss_gap``: the largest |loss - loss_ref| / |loss_ref| over the steps;
* ``eikonal_gap``: the same for the eikonal term alone (the loss's part
  that reads K1's spatial gradient and no discrete choice: no top-k, no
  dropped patches);
* ``udf_gap``: the same for the mean distance over a step's samples
  (``udf_mean``: K1's value at every sample the renderer reads);
* ``color_gap``: the same for the colour term alone (the rendered colour's
  L1 against the pixels, before any blending: no top-k, no dropped
  patches either; in a finetune the total loss's pixel and patch terms
  round far enough under bf16 to hide half a batch, this term does not);
* ``grad_gap``: the first gradient as the optimizer got it, worked out from
  the first moment after step 1, g = (m_1 - beta1 m_0) / (1 - beta1); for
  each leaf the gap between its norm and the reference's, over the larger
  of the reference leaf's norm and the median leaf's; the median over the
  leaves;
* ``udf_grad_gap``: the same gap of the first gradient per layer of the
  distance network (the model's ``DISTANCE_NET``; a layer's ``v``, ``g``
  and ``b`` together: the weight cotangents that K2 writes), over the
  larger of the reference layer's norm and the median layer's; the worst layer. The median over all
  leaves cannot see K2 alone: its leaves are under half of them in a DTU
  cell, and a layer's leaves together are steadier than its smallest one;
* ``change_gap``: the same gap for the norm of each leaf's change over the
  steps, p_FOLLOW - p_0, over the leaves the reference moves.

A gap of the worst leaf instead of the median one is ruled by single small
leaves that the bf16 tier rounds far from f32 without a fault (the weight
norm's scale of the distance head, whose gradient is a cancelling sum; the
background NeRF where its density sits at ReLU's threshold), and so are
the loss's discrete choices in a blending step; ``PERF.md`` gives those
readings.

A cell whose measured window runs the runner's periodic actions adds the
numbers of that crossing (``crossing_numbers``): the meshes'
(``harness.meshes``: ``mesh_gap``, ``udf_mesh_gap``) and the validation
image's (``harness.images``: ``image_gap``).

Leaves whose reference gradient is under a thousandth of the median
leaf's (those Adam moves by round-off alone, or that are not trained) are
left out of ``grad_gap`` and ``change_gap``, by that rule and never by
name.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

FOLLOW = 3  # steps the reference follows
BETA1 = 0.9  # Adam's first-moment decay, as the configuration's optimizer has it
NOUGHT = 1e-3  # a leaf's gradient under this share of the median leaf's counts as nought


def flat_leaves(tree, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) of a nested dict, in sorted key order."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.extend(flat_leaves(val, path + (key,)))
        else:
            out.append((path + (key,), val))
    return out


def put(tree, path: Tuple[str, ...], value) -> None:
    """tree[path[0]][path[1]]... = value, making the dicts on the way."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def moments(opt_state) -> Dict[tuple, torch.Tensor]:
    """The first moment of every leaf of an Adam state {leaf: {m, v, t}}."""
    out = {}
    for path, t in flat_leaves(opt_state):
        if path[-1] == "m":
            out[path[:-1]] = t.detach().clone()
    return out


def snapshot_params(params) -> Dict[tuple, torch.Tensor]:
    return {path: t.detach().clone() for path, t in flat_leaves(params)}


def readings(losses, m0, m1, p0, pN) -> Dict[str, object]:
    """What one side gives the comparison: its FOLLOW losses, each leaf's
    first-gradient norm and change norm."""
    grads = {k: float(torch.linalg.vector_norm(((m1[k] - BETA1 * m0[k]) / (1 - BETA1)).double()))
             for k in m1}
    change = {k: float(torch.linalg.vector_norm((pN[k].double() - p0[k].double())))
              for k in pN}
    return {"losses": [float(v) for v in losses], "grads": grads, "change": change}


def _median(vals) -> float:
    vals = sorted(vals)
    n = len(vals)
    return 0.0 if n == 0 else (vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2]))


def _gap(a: float, b: float, floor: float) -> float:
    den = max(abs(b), floor)
    if den == 0.0:
        return 0.0 if a == b else float("inf")
    return abs(a - b) / den


def leaf_gaps(side: Dict[str, object], ref: Dict[str, object], top: int = 6) -> Dict[str, list]:
    """The worst leaves of each gap, with both sides' norms: for a look at
    what a reading comes from."""
    g_ref, c_ref = ref["grads"], ref["change"]
    med = _median(g_ref.values())
    kept = [k for k in g_ref if g_ref[k] >= NOUGHT * med]
    g_med = _median([g_ref[k] for k in kept])
    c_med = _median([c_ref[k] for k in kept])
    out = {}
    for name, s, r, m in (("grad", side["grads"], g_ref, g_med),
                          ("change", side["change"], c_ref, c_med)):
        rows = sorted(((_gap(s[k], r[k], m), "/".join(k), s[k], r[k]) for k in kept),
                      reverse=True)[:top]
        out[name] = [[g, k, a, b] for g, k, a, b in rows] + [["median", m]]
    return out


def layer_norms(grads: Dict[tuple, float], net: str) -> Dict[tuple, float]:
    """The norm of each layer's gradient of the network ``net`` (a subtree
    of the parameters), from its leaves' norms (the norm of the leaves
    together)."""
    out: Dict[tuple, float] = {}
    for path, v in grads.items():
        if path[0] == net:
            out[path[:2]] = out.get(path[:2], 0.0) + v * v
    return {k: v ** 0.5 for k, v in out.items()}


def compare(side: Dict[str, object], ref: Dict[str, object], model) -> Dict[str, float]:
    """The seven numbers (module docstring) of ``side`` against ``ref``; the
    model (``models/<m>.py``) names the step's terms (``TERMS``) and the
    distance network (``DISTANCE_NET``)."""
    lg = max(_gap(a, b, 0.0) for a, b in zip(side["losses"], ref["losses"]))
    keys = [model.TERMS[n] for n in ("eikonal_gap", "udf_gap", "color_gap")]
    eik, udf, col = (max(_gap(s[key], r[key], 0.0) for s, r in zip(side["terms"], ref["terms"]))
                     for key in keys)
    if any(v != v for v in side["losses"]):  # a NaN loss is never close
        lg = eik = udf = col = float("inf")
    g_ref, c_ref = ref["grads"], ref["change"]
    kept = [k for k in g_ref if g_ref[k] >= NOUGHT * _median(g_ref.values())]
    g_med = _median([g_ref[k] for k in kept])
    gg = _median([_gap(side["grads"][k], g_ref[k], g_med) for k in kept])
    moved = [k for k in kept if c_ref[k] > 0.0]
    c_med = _median([c_ref[k] for k in moved])
    cg = _median([_gap(side["change"][k], c_ref[k], c_med) for k in moved])
    net = model.DISTANCE_NET
    l_ref, l_side = layer_norms(g_ref, net), layer_norms(side["grads"], net)
    l_med = _median(l_ref.values())
    ug = max((_gap(l_side[k], l_ref[k], l_med) for k in l_ref), default=0.0)
    return {"loss_gap": lg, "eikonal_gap": eik, "udf_gap": udf, "color_gap": col,
            "grad_gap": gg, "udf_grad_gap": ug, "change_gap": cg}


def compare_scans(sides, refs, model) -> Tuple[Dict[str, float], Dict[str, int]]:
    """The seven numbers of each scan's side against its reference, and of
    each number the worst scan's value (the largest; NaN is worst) and that
    scan's index."""
    per = [compare(s, r, model) for s, r in zip(sides, refs)]
    rank = lambda v: float("inf") if v != v else v
    worst = {k: max(range(len(per)), key=lambda i: rank(per[i][k])) for k in per[0]}
    return {k: per[i][k] for k, i in worst.items()}, worst


def crossing_numbers(model, cfg, event, scene_dir, device) -> Dict[str, float]:
    """The numbers of one crossing (an event of ``session.Periodic``): the
    meshes' where it wrote meshes, the validation image's where it rendered
    one."""
    from . import images, meshes

    out: Dict[str, float] = {}
    if "val_mesh_freq" in event["hits"]:
        out.update(meshes.gaps(model, cfg, event, scene_dir, device))
    if "val_freq" in event["hits"]:
        out.update(images.gaps(model, cfg, event, scene_dir, device))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a NaN or a missing number is not)."""
    return all(name in numbers and numbers[name] <= lim for name, lim in limits.items())
