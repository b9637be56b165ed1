"""The port's flat Adam (``train/optim.py`` ``flat_adam_step``) against its
per-leaf Adam and against the JAX package's ``flat_adam_step`` (the
counterpart of ``tests/test_optim.py::test_flat_adam_matches_tree``), and a
training window with the flat Adam against one with the per-leaf Adam (the
counterpart of ``tests/test_scan_unroll.py::test_flat_adam_window_trajectory``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraludf_tpu.config import BetaNetworkConfig as JBetaConfig
from neuraludf_tpu.train import optim as joptim
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch.config import BetaNetworkConfig
from neuraludf_tpu_torch.train import optim as toptim
from neuraludf_tpu_torch.train.runner import Runner
from test_torch_step import scene_dir  # noqa: F401
from test_torch_window import assert_same_state, small_raw, window_inputs

N_STEPS = 4


def mixed_tree(rng):
    """A real-shaped tree: the three lr groups, weight-norm leaves, and the
    scalars whose trainability is gated at run time or by the config."""
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    return {
        "udf": {"lin0": {"v": mk(39, 256), "g": mk(256), "b": mk(256)},
                "lin1": {"v": mk(256, 257), "g": mk(257), "b": mk(257)}},
        "color": {"lin0": {"v": mk(259, 128), "b": mk(128)}},
        "nerf": {"lin0": {"v": mk(84, 64), "b": mk(64)}},
        "variance": {"variance": mk(1)},
        "beta": {"beta": mk(1), "gamma": mk(1), "zeta": mk(1)},
    }


def torch_tree(tree):
    return {k: torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def steps(rng, params):
    """Per step: gradients (one leaf without a gradient, as autograd gives
    None for an unused leaf) and the trainability of variance and beta
    (variance switched on after two steps, beta after one, as the runner's
    state machine may)."""
    out = []
    for step in range(N_STEPS):
        grads = {path: rng.randn(*p.shape).astype(np.float32)
                 for path, p in toptim.leaves(params)}
        grads[("nerf", "lin0", "b")] = None
        out.append((grads, float(step >= 2), float(step >= 1)))
    return out


@pytest.mark.parametrize("scalars", ["floats", "tensors"])
def test_flat_adam_matches_tree_bit_for_bit(scalars):
    """Four steps of the flat Adam and of the per-leaf Adam on one tree:
    the same parameters and the same per-leaf m, v, t, bit for bit, with the
    learning rates and trainabilities as floats or as 0-dim tensors (a
    schedule row's entries)."""
    rng = np.random.RandomState(1)
    tree = mixed_tree(rng)
    bcfg = BetaNetworkConfig(requires_grad_gamma=False, requires_grad_zeta=True)
    as_scalar = (lambda v: v) if scalars == "floats" else (lambda v: torch.tensor(v))
    p_tree, p_flat = torch_tree(tree), torch_tree(tree)
    s_tree, s_flat = toptim.init_adam_state(p_tree), toptim.init_adam_state(p_flat)
    lr_fn = toptim.make_lr_fn(as_scalar(1e-3), as_scalar(5e-4), as_scalar(1e-4))
    for grads, var_tr, beta_tr in steps(rng, p_tree):
        fn = toptim.make_trainable_fn(bcfg, as_scalar(var_tr), as_scalar(beta_tr))
        g = {path: None if v is None else torch.tensor(v) for path, v in grads.items()}
        toptim.adam_step(p_tree, g, s_tree, lr_fn, fn)
        toptim.flat_adam_step(p_flat, g, s_flat, lr_fn, fn)
    for tree_a, tree_b in ((p_tree, p_flat), (s_tree, s_flat)):
        for (path, a), (path_b, b) in zip(toptim.leaves(tree_a), toptim.leaves(tree_b)):
            assert path == path_b
            assert torch.equal(a, b), path
    # the gating held: gamma never moved, variance trained two steps, beta three
    assert torch.equal(p_flat["beta"]["gamma"], torch.tensor(tree["beta"]["gamma"]))
    assert float(s_flat["variance"]["variance"]["t"]) == 2.0
    assert float(s_flat["beta"]["beta"]["t"]) == 3.0
    assert float(s_flat["udf"]["lin0"]["v"]["t"]) == N_STEPS


def test_flat_adam_matches_jax_flat_adam():
    """The same four steps against the JAX package's flat_adam_step: f32 on
    both sides in the same order of operations; XLA's CPU code may contract
    a product and a sum into one FMA and computes the bias corrections on
    the concatenated vector, so elements may land an ulp or two apart (rtol
    2.5e-7, the Adam tolerance of tests/test_torch_step.py). The step counts
    agree exactly."""
    rng = np.random.RandomState(2)
    tree = mixed_tree(rng)
    bcfg_t = BetaNetworkConfig(requires_grad_gamma=False, requires_grad_zeta=True)
    bcfg_j = JBetaConfig(requires_grad_gamma=False, requires_grad_zeta=True)
    p_t = torch_tree(tree)
    s_t = toptim.init_adam_state(p_t)
    p_j = jax.tree_util.tree_map(jnp.asarray, tree)
    s_j = joptim.init_adam_state(p_j)
    for grads, var_tr, beta_tr in steps(rng, p_t):
        g_t = {path: None if v is None else torch.tensor(v) for path, v in grads.items()}
        toptim.flat_adam_step(p_t, g_t, s_t, toptim.make_lr_fn(1e-3, 5e-4, 1e-4),
                              toptim.make_trainable_fn(bcfg_t, var_tr, beta_tr))
        g_j = jax.tree_util.tree_map(jnp.zeros_like, p_j)
        for path, v in grads.items():
            if v is not None:
                node = g_j
                for key in path[:-1]:
                    node = node[key]
                node[path[-1]] = jnp.asarray(v)
        p_j, s_j = joptim.flat_adam_step(p_j, g_j, s_j, joptim.make_lr_fn(1e-3, 5e-4, 1e-4),
                                         joptim.make_trainable_fn(bcfg_j, var_tr, beta_tr))
    for tree_t, tree_j in ((p_t, p_j), (s_t, s_j)):
        for path, aj in toptim.leaves(jax.tree_util.tree_map(np.asarray, tree_j)):
            at = toptim.get_path(tree_t, path).numpy()
            if path[-1] == "t":
                np.testing.assert_array_equal(at, aj, err_msg=str(path))
            else:
                np.testing.assert_allclose(at, aj, rtol=2.5e-7, atol=0, err_msg=str(path))


def test_flat_adam_window_matches_tree_window(scene_dir, tmp_path):  # noqa: F811
    """A window of 4 training steps with ``train.flat_adam`` against the
    same with the per-leaf Adam, from one initialisation and generator seed:
    the metric rows and the trained state agree bit for bit (the update is
    the same per element; JAX's flat window agrees only to rtol 2e-4, its
    fusion boundaries differ)."""
    out = []
    for flat in (False, True):
        cfg = tconfig.from_dict(small_raw(scene_dir, str(tmp_path / str(flat)), end_iter=4,
                                          freq=4))
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, flat_adam=flat))
        runner = Runner(cfg, device="cpu", seed=5)
        _, rows, idxs = window_inputs(runner, 4)
        m = runner._get_window_fn(False, 4)(runner.params, runner.opt_state,
                                            runner.dataset.scene, idxs, runner.generator, rows)
        out.append((m, runner))
    (m_tree, r_tree), (m_flat, r_flat) = out
    assert torch.equal(m_tree, m_flat)
    assert_same_state(r_tree, r_flat)
