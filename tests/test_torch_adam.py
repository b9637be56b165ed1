"""The Adam kernel's entry point (``ops/adam.py`` ``fused_adam``) and the
updates that call it (``train/optim.py`` ``adam_step``, ``flat_adam_step``).

On the CPU: CPU tensors take the plain bodies (the kernel's launch count
stays), and the entry point refuses a table it cannot launch: a mixed
device, a tensor that is not float32, one that is not contiguous, a
gradient shaped unlike its parameter. On the card (marked ``card``, skipped
without one): ``chip_smoke.check_adam``, the kernel against the plain
update on the DTU tree over 20 steps and 5 replays of a captured graph."""

import numpy as np
import pytest
import torch

from neuraludf_tpu_torch.config import BetaNetworkConfig
from neuraludf_tpu_torch.ops.adam import AdamLeaf, fused_adam, table_device
from neuraludf_tpu_torch.train import optim


def small_tree(rng):
    """The three lr groups, a weight-norm layer, the gated scalars."""
    mk = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32))
    return {"udf": {"lin0": {"v": mk(39, 17), "g": mk(17), "b": mk(17)}},
            "color": {"lin0": {"v": mk(9, 8), "b": mk(8)}},
            "nerf": {"lin0": {"w": mk(5, 7), "b": mk(7)}},
            "variance": {"variance": mk(1)},
            "beta": {"beta": mk(1), "gamma": mk(1), "zeta": mk(1)}}


@pytest.mark.parametrize("update, plain", [("adam_step", "adam_step_plain"),
                                           ("flat_adam_step", "flat_adam_step_plain")])
def test_cpu_tensors_take_the_plain_body(update, plain):
    """Four steps through the dispatching update against its plain body on
    the same tree (one leaf without a gradient; variance and beta gated on
    after two steps and one): equal bit for bit, and no launch counted."""
    rng = np.random.RandomState(3)
    tree = small_tree(rng)
    clone = lambda t: {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in t.items()}
    p_a, p_b = tree, clone(tree)
    s_a, s_b = optim.init_adam_state(p_a), optim.init_adam_state(p_b)
    bcfg = BetaNetworkConfig(requires_grad_gamma=False, requires_grad_zeta=True)
    lr_fn = optim.make_lr_fn(torch.tensor(1e-3), torch.tensor(5e-4), 1e-4)
    launched = fused_adam.launches
    for step in range(4):
        fn = optim.make_trainable_fn(bcfg, torch.tensor(float(step >= 2)), float(step >= 1))
        g = {path: torch.tensor(rng.randn(*p.shape).astype(np.float32))
             for path, p in optim.leaves(p_a)}
        g[("nerf", "lin0", "b")] = None
        getattr(optim, update)(p_a, g, s_a, lr_fn, fn)
        getattr(optim, plain)(p_b, g, s_b, lr_fn, fn)
    assert fused_adam.launches == launched
    for tree_a, tree_b in ((p_a, p_b), (s_a, s_b)):
        for (path, a), (_, b) in zip(optim.leaves(tree_a), optim.leaves(tree_b)):
            assert torch.equal(a, b), path


def one_leaf(**change):
    p = torch.zeros(4, 6)
    leaf = AdamLeaf(p, torch.ones_like(p), torch.zeros_like(p), torch.zeros_like(p),
                    torch.zeros(()), 1e-3, 1.0)
    return leaf._replace(**change)


@pytest.mark.parametrize("change, message", [
    ({"g": torch.ones(4, 6, device="meta")}, "g on meta"),
    ({"lr": torch.tensor(1e-3, device="meta")}, "lr on meta"),
    ({"p": torch.zeros(4, 6, dtype=torch.float64)}, "p must be a contiguous float32"),
    ({"v": torch.zeros(4, 6, dtype=torch.bfloat16)}, "v must be a contiguous float32"),
    ({"p": torch.zeros(6, 4).t()}, "p must be a contiguous float32"),
    ({"g": torch.ones(6, 4).t()}, "g must be a contiguous float32"),
    ({"m": torch.zeros(4, 5)}, "m of shape"),
    ({"g": torch.ones(24)}, "g of shape"),
    ({"tr": torch.ones(2)}, "tr must hold one element"),
])
def test_the_entry_refuses_what_the_kernel_does_not_take(change, message):
    """A mixed device, a leaf tensor that is not float32 or not contiguous,
    a gradient or moment of another shape, a trainability of two elements:
    ValueError before anything is launched or updated, on every device."""
    table = [one_leaf(), one_leaf(**change)]
    launched = fused_adam.launches
    with pytest.raises(ValueError, match=message):
        fused_adam(table)
    assert fused_adam.launches == launched
    with pytest.raises(ValueError, match=message):
        optim.adam_step({"a": table[0].p, "b": table[1].p}, {("a",): table[0].g,
                                                             ("b",): table[1].g},
                        {"a": {"m": table[0].m, "v": table[0].v, "t": table[0].t},
                         "b": {"m": table[1].m, "v": table[1].v, "t": table[1].t}},
                        lambda path: table[0].lr if path == ("a",) else table[1].lr,
                        lambda path: table[0].tr if path == ("a",) else table[1].tr)


def test_a_table_of_cpu_tensors_is_on_the_cpu():
    assert table_device([one_leaf(), one_leaf(g=None, lr=torch.tensor(2e-3))]).type == "cpu"
    assert fused_adam([one_leaf()]) is False


@pytest.mark.card
def test_the_kernel_matches_the_plain_update_on_the_card():
    """``chip_smoke.check_adam`` (it raises on a step count that differs or
    p, m, v more than ``TOL_ADAM_ULPS`` apart, in 20 steps and in 5 replays
    of a captured graph)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    out = chip_smoke.check_adam(torch.device("cuda:0"))
    assert out["leaves"] == 85 and out["launches"] == 2 * chip_smoke.ADAM_STEPS
