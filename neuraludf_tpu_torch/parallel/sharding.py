"""Ray data parallelism over a ``torch.distributed`` process group
(counterpart of ``neuraludf_tpu/parallel/sharding.py``).

Each process renders ``batch_size / world`` rays of every batch, one process
per card. The JAX package's step is one SPMD program over a device mesh, so
its loss is the single-device loss of the whole batch; the same holds here:

* every process draws the whole batch from one generator state (pixels,
  render noise: ``step.draw_noise``, the body's order) and keeps its rows;
* the batch reductions inside the renderer (the mean sample distance, the
  eikonal and sparsity means, the strip sampler's coverage) and the per-ray
  outputs that the loss reads are all-gathered, differentiably
  (``gather_rows``), so that every process computes the loss of the whole
  batch: the masked colour means, the patch loss's global top-k and the
  metrics are the single step's;
* the backward of a gather keeps the process's own rows, so each process's
  parameter gradient is its rays' share, and their sum over the processes
  (one all-reduce of one flat buffer, in ``flat_adam_step``'s layout) is the
  gradient of the whole batch; every process then makes the same Adam
  update, and the parameters stay identical.

On a CUDA device the training window captures the step with its collectives
into the step's CUDA graph (NCCL supports capture); on the CPU it runs
eagerly over gloo. ``shard_grid_query`` splits a grid query's points over
the processes and all-gathers the slices.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from ..config import Config
from ..render.renderer import UDFRenderer
from ..train.optim import leaves
from ..train.step import Grads, RayShard, TrainWindow, build_step_body


class _GatherRows(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps this process's slice of
    the cotangent (every process computes the same loss from the gathered
    tensor, so its cotangent is the same everywhere and nothing is summed)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        xm = x.movedim(dim, 0).contiguous()
        parts = [torch.empty_like(xm) for _ in range(world)]
        dist.all_gather(parts, xm, group=group)
        ctx.dim, ctx.rank, ctx.n = dim, rank, xm.shape[0]
        return torch.cat(parts).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def gather_rows(group=None) -> Callable[..., torch.Tensor]:
    """gather(t, dim=0): the slices of t of every process of ``group``
    joined along ``dim`` in rank order, differentiably."""
    return lambda t, dim=0: _GatherRows.apply(t, dim, group)


def all_reduce_grads(grads: Grads, params: Dict, group=None) -> Grads:
    """The parameter gradients summed over the processes of ``group`` by one
    all-reduce of one flat buffer (the leaves in ``optim.leaves`` order, a
    missing gradient as zeros); returns views of that buffer by leaf."""
    paths, ps = zip(*leaves(params))
    flat = torch.cat([(grads.get(path) if grads.get(path) is not None
                       else torch.zeros_like(p)).reshape(-1) for path, p in zip(paths, ps)])
    dist.all_reduce(flat, group=group)
    return {path: x.view_as(p) for path, x, p in zip(paths, flat.split([p.numel() for p in ps]),
                                                     ps)}


def ray_shard(cfg: Config, group=None) -> RayShard:
    """This process's share of every batch over ``group`` (the default
    group unless given). The batch must divide by the world size."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if cfg.train.batch_size % world != 0:
        raise ValueError(f"batch {cfg.train.batch_size} does not divide by the world size "
                         f"{world}")
    return RayShard(rank, world, gather_rows(group),
                    lambda grads, params: all_reduce_grads(grads, params, group))


def build_parallel_train_step(cfg: Config, renderer: UDFRenderer, group=None, *,
                              blending: bool = False) -> Callable:
    """step(params, opt_state, scene, img_idx, sched, generator=None,
    noise=None) -> metrics of the whole batch, the counterpart of
    ``step.build_step_body`` over the processes of ``group``: every process
    passes the same state, view, schedule and generator state (or draws),
    renders its rows and makes the same update in place."""
    return build_step_body(cfg, renderer, blending=blending, shard=ray_shard(cfg, group))


def build_parallel_train_window(cfg: Config, renderer: UDFRenderer, group=None, *,
                                blending: bool = False, window: int,
                                unroll: int = 1) -> TrainWindow:
    """``window`` ray-parallel iterations a call: ``step.build_train_window``
    over ``build_parallel_train_step``'s body (on a CUDA device one CUDA
    graph of ``unroll`` bodies, their all-gathers and all-reduces inside
    it). Drop the window before destroying the process group: NCCL keeps
    a communicator while a graph holding its collectives lives, and
    ``destroy_process_group`` then never returns."""
    return TrainWindow(cfg, build_parallel_train_step(cfg, renderer, group, blending=blending),
                       window, unroll)


def shard_grid_query(fn: Callable, group=None) -> Callable:
    """wrapped(params, pts [N, 3]) = fn(params, pts): each process of
    ``group`` evaluates fn on its slice of the points (the last one padded
    with copies of the last point) and the slices are all-gathered."""

    def wrapped(params, pts: torch.Tensor) -> torch.Tensor:
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        n = pts.shape[0]
        per = -(-n // world)
        padded = torch.cat([pts, pts[-1:].expand(per * world - n, -1)])
        out = fn(params, padded[rank * per:(rank + 1) * per]).contiguous()
        parts = [torch.empty_like(out) for _ in range(world)]
        dist.all_gather(parts, out, group=group)
        return torch.cat(parts)[:n]

    return wrapped

