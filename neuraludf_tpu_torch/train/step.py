"""The training step: ray sampling → render → losses → Adam (counterpart of
``neuraludf_tpu/train/step.py``).

``build_loss_fn`` gives the total loss and the 19 ``METRIC_KEYS`` of one
iteration; ``build_step_body`` adds the backward pass and the Adam update
(``adam_step``, or ``flat_adam_step`` with ``cfg.train.flat_adam``: on a
CUDA device both are the Adam kernel of ``ops/adam.py``).
Built with ``blending=True`` they render the pixel and patch blending
branches of the finetune and add their losses. A body takes its view as an
int or a 0-dim device tensor, and its schedule values as a row of
``schedules.SCHEDULE_KEYS`` (or a dict of floats). The random draws of an
iteration (pixels ``px``/``py`` and the render noise ``t_rand``/``t_r``)
come from a ``torch.Generator`` or are given in ``noise``; ``draw_noise``
makes them outside the body, as the body would.

``build_train_window`` runs ``window`` iterations a call, the counterpart of
the JAX package's ``lax.scan`` window: on a CUDA device as replays of one
CUDA graph of ``unroll`` step bodies over static buffers, into which each
replay's draws, views and schedule rows are copied first; on the CPU the
same bodies run eagerly on the same buffers. The same ``TrainWindow``
runs S independent scans at once (``parallel.multi_scan``), one graph
holding the step bodies of every scan.

A body built with a ``RayShard`` renders only its process's slice of the
batch and forms the loss of the whole batch (``parallel.sharding``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch

from ..config import Config
from ..data.dataset import draw_pixels, near_far_from_sphere, ref_src_info, sample_random_rays
from ..losses.color import ColorLossWeights, bce_mask_loss, color_loss, psnr
from ..render.projector import camera_inverse
from ..render.renderer import Gather, RenderOptions, UDFRenderer, no_gather, uniform_draw
from ..utils.trace import count, span
from .optim import adam_step, flat_adam_step, leaves, make_lr_fn, make_trainable_fn
from .schedules import SCHEDULE_KEYS, unpack_row

Params = Dict[str, Any]
Schedule = Union[torch.Tensor, Mapping[str, Any]]
Noise = Dict[str, torch.Tensor]
Grads = Dict[tuple, Optional[torch.Tensor]]

METRIC_KEYS: List[str] = [
    "loss", "color_total_loss", "color_base_loss", "color_loss",
    "color_pixel_loss", "color_patch_loss", "mask_loss", "gradient_error",
    "gradient_error_near_surface", "sparse_error", "psnr", "variance",
    "beta", "gamma", "udf_min", "udf_mean", "weight_sum", "weight_sum_fg_bg",
    "blend_strip_cover",
]


# the render outputs a loss reads per ray: a ray-parallel loss joins them
PER_RAY = ("color_base", "color", "color_pixel", "patch_colors", "patch_mask", "weight_sum",
           "weight_sum_fg_bg", "udf")


@dataclass(frozen=True)
class RayShard:
    """Process ``rank`` of ``world`` renders rows [rank * B / world, (rank +
    1) * B / world) of every batch; ``gather(t, dim=0)`` joins the slices of
    all processes into the whole batch's t (differentiably), and
    ``reduce_grads(grads, params)`` sums the parameter gradients over them."""
    rank: int
    world: int
    gather: Gather
    reduce_grads: Callable[[Grads, Dict[str, Any]], Grads]

    def rows(self, batch: int) -> slice:
        n = batch // self.world
        return slice(self.rank * n, (self.rank + 1) * n)


def build_loss_fn(cfg: Config, renderer: UDFRenderer, *, blending: bool = False,
                  shard: Optional[RayShard] = None) -> Callable:
    """loss_fn(params, scene, img_idx, sched, generator=None, noise=None)
    -> (total loss, metrics dict of 0-dim tensors). ``blending`` turns on the
    pixel and patch blending branches whose configured weight is positive.
    ``sched`` is a schedule row or a dict of SCHEDULE_KEYS. A ``u_mask`` in
    ``noise`` draws 3/4 of the batch from the view's mask (``draw_noise``).

    With ``shard`` every process draws the whole batch (from ``noise``, or
    ``draw_noise`` from ``generator``), renders its rows, joins the per-ray
    outputs and computes the loss of the whole batch: the patch loss's
    top-k, the masked means and the metrics are the single step's."""
    tcfg, ccfg = cfg.train, cfg.color_loss
    use_mask_loss = tcfg.mask_weight > 0
    h_patch = ccfg.h_patch_size
    opts = RenderOptions(perturb=cfg.model.udf_renderer.perturb > 0,
                         pixel_blending=blending and ccfg.color_pixel_weight > 0,
                         patch_blending=blending and ccfg.color_patch_weight > 0)
    if opts.patch_blending and cfg.model.udf_renderer.h_patch_size != h_patch:
        # the patch size is configured in two places; they must agree or the
        # warped and the ground-truth patches differ in shape
        raise ValueError("model.udf_renderer.h_patch_size must equal color_loss.h_patch_size "
                         f"({cfg.model.udf_renderer.h_patch_size} != {h_patch})")

    def loss_fn(params: Params, scene, img_idx, sched: Schedule,
                generator: Optional[torch.Generator] = None, noise: Optional[Noise] = None):
        if shard is not None and not noise:
            noise = draw_noise(cfg, scene, generator)
        noise = noise or {}
        if isinstance(sched, torch.Tensor):
            sched = unpack_row(sched)
        with span("step.sample"):
            sample = sample_random_rays(scene, img_idx, tcfg.batch_size, generator=generator,
                                        px=noise.get("px"), py=noise.get("py"),
                                        u_mask=noise.get("u_mask"),
                                        crop_patch=opts.patch_blending, h_patch_size=h_patch)
            data = sample["rays"]
            true_rgb, mask = data[:, 6:9], data[:, 9:10]
            mask = (mask > 0.5).to(torch.float32)
            rows = slice(None) if shard is None else shard.rows(tcfg.batch_size)
            rays_o, rays_d = data[rows, :3], data[rows, 3:6]
            near, far = near_far_from_sphere(rays_o, rays_d)
            render_noise = {key: noise[key][rows] if key == "t_rand" else noise[key]
                            for key in ("t_rand", "t_r") if key in noise}

            blending_inputs = None
            if opts.pixel_blending or opts.patch_blending:
                ref_c2w, src_c2ws, src_intr, src_images = ref_src_info(scene, img_idx)
                blending_inputs = {
                    "color_maps": src_images,
                    "w2cs": camera_inverse(src_c2ws),
                    "intrinsics": src_intr,
                    "query_c2w": ref_c2w,
                    "rays_uv": sample["rays_ndc_uv"][rows] if opts.patch_blending else None,
                    "img_index": None,
                }

        with span("step.render"):
            ret = renderer.render(
                params, rays_o, rays_d, near, far, generator=generator, noise=render_noise,
                cos_anneal_ratio=sched["cos_anneal_ratio"],
                flip_saturation=sched["flip_saturation"],
                background_rgb=(torch.ones((1, 3), device=rays_o.device)
                                if tcfg.use_white_bkgd else None),
                blending=blending_inputs, opts=opts,
                gather=no_gather if shard is None else shard.gather)
            if shard is not None:
                ret.update({key: shard.gather(ret[key]) for key in PER_RAY
                            if ret[key] is not None})

        with span("step.loss"):
            weight_sum = ret["weight_sum"]
            patch_mask = None
            if ret["patch_colors"] is not None:
                patch_mask = (ret["patch_mask"][:, None]
                              * (weight_sum > 0.5).to(torch.float32)) > 0.0
            pixel_mask = mask if use_mask_loss else None
            weights = ColorLossWeights(color_base=sched["color_base_weight"],
                                       color=sched["color_weight"],
                                       color_pixel=sched["color_pixel_weight"],
                                       color_patch=sched["color_patch_weight"])
            closs = color_loss(weights, ret["color_base"], ret["color"], true_rgb,
                               ret["color_pixel"], pixel_mask, ret["patch_colors"],
                               sample["rays_patch_color"], patch_mask,
                               patch_loss_type=ccfg.patch_loss_type, h_patch_size=h_patch)

            mask_l = bce_mask_loss(weight_sum, mask)
            total = (closs["loss"]
                     + mask_l * sched["mask_weight"]
                     + ret["gradient_error_near_surface"] * sched["igr_ns_weight"]
                     + ret["sparse_error"] * sched["sparse_weight"]
                     + ret["gradient_error"] * sched["igr_weight"])

            with torch.no_grad():
                mask_sum = mask.sum() + 1e-5
                ray_mask = (mask[:, 0] > 0.5).to(torch.float32)
                udf_min_per_ray = ret["udf"].min(dim=1).values
                udf_min = (torch.sum(udf_min_per_ray * ray_mask)
                           / torch.clamp(ray_mask.sum(), min=1.0))
                metrics = {
                    "loss": total,
                    "color_total_loss": closs["loss"],
                    "color_base_loss": closs["color_base_loss"],
                    "color_loss": closs["color_loss"],
                    "color_pixel_loss": closs["color_pixel_loss"],
                    "color_patch_loss": closs["color_patch_loss"],
                    "mask_loss": mask_l,
                    "gradient_error": ret["gradient_error"],
                    "gradient_error_near_surface": ret["gradient_error_near_surface"],
                    "sparse_error": ret["sparse_error"],
                    "psnr": psnr(ret["color"], true_rgb, mask),
                    "variance": torch.mean(ret["variance"]),
                    "beta": torch.mean(ret["beta"]),
                    "gamma": torch.mean(ret["gamma"]),
                    "udf_min": udf_min,
                    "udf_mean": torch.mean(ret["udf"]),
                    "weight_sum": torch.sum(ret["weight_sum"] * mask) / mask_sum,
                    "weight_sum_fg_bg": torch.sum(ret["weight_sum_fg_bg"] * mask) / mask_sum,
                    "blend_strip_cover": ret["blend_strip_cover"],
                }
                metrics = {k: v.detach().reshape(()) for k, v in metrics.items()}
        return total, metrics

    return loss_fn


def param_grads(total: torch.Tensor, params: Params) -> Dict[tuple, torch.Tensor]:
    """d total / d leaf for every parameter leaf (None where unused)."""
    paths, tensors = zip(*leaves(params))
    with span("step.grad"):
        grads = torch.autograd.grad(total, tensors, allow_unused=True)
    return dict(zip(paths, grads))


def build_step_body(cfg: Config, renderer: UDFRenderer, *, blending: bool = False,
                    shard: Optional[RayShard] = None) -> Callable:
    """body(params, opt_state, scene, img_idx, sched, generator=None,
    noise=None) -> metrics; updates params and opt_state in place. With
    ``shard`` the loss is ``build_loss_fn``'s of the whole batch, and the
    parameter gradients are summed over the processes before the update."""
    loss_fn = build_loss_fn(cfg, renderer, blending=blending, shard=shard)
    bcfg = cfg.model.beta_network
    adam = flat_adam_step if cfg.train.flat_adam else adam_step

    def body(params, opt_state, scene, img_idx, sched: Schedule, generator=None, noise=None):
        if isinstance(sched, torch.Tensor):
            sched = unpack_row(sched)
        total, metrics = loss_fn(params, scene, img_idx, sched, generator, noise)
        grads = param_grads(total, params)
        if shard is not None:
            grads = shard.reduce_grads(grads, params)
        lr_fn = make_lr_fn(sched["lr_geo"], sched["lr_main"], sched["lr_main"])
        trainable_fn = make_trainable_fn(bcfg, sched["variance_trainable"],
                                         sched["beta_trainable"])
        with span("step.adam"):
            adam(params, grads, opt_state, lr_fn, trainable_fn)
        return metrics

    return body


def draw_noise(cfg: Config, scene, generator: torch.Generator,
               importance_sample: bool = False) -> Noise:
    """One iteration's draws, in the order, shapes and on the devices in
    which the step body makes them when ``noise`` is not given (pixels, then
    the render's z perturbation and outside jitter), so that a run fed from
    here consumes the generator as an eager run does. With
    ``importance_sample`` the pixel draws hold ``u_mask``, which puts 3/4 of
    the batch in the view's mask (``data.dataset.draw_pixels``)."""
    rcfg, batch = cfg.model.udf_renderer, cfg.train.batch_size
    noise = draw_pixels(scene, batch, generator, importance_sample)
    dev = scene["images"].device
    if rcfg.perturb > 0:
        noise["t_rand"] = uniform_draw((batch, 1), generator, dev, torch.float32) - 0.5
        if rcfg.n_outside > 0:
            noise["t_r"] = uniform_draw((rcfg.n_outside,), generator, dev, torch.float32)
    return noise


def launch_counters() -> tuple:
    """The kernel entry points whose ``launches`` count the kernels a step
    launches (K1, K2, K3, the Adam update, K4's forward and backward, K5 and
    its pack), and the counts of K1's and K2's routes."""
    from ..ops import adam, fused_distance, nerf_mlp, strip_sample

    k1, k2 = fused_distance.fused_forward, fused_distance.fused_backward
    return (k1, k2, strip_sample.strip_sample, adam.fused_adam, nerf_mlp.nerf_forward,
            nerf_mlp.nerf_backward, fused_distance.fused_value, fused_distance.value_pack,
            *k1.routes.values(), *k2.routes.values())


N_WARMUP = 2  # eager units of a window's bodies before their capture


class TrainWindow:
    """``window`` iterations of ``n_scans`` independent scans a call over
    static buffers (``build_train_window``; S > 1 in ``parallel.multi_scan``).

    A unit is ``unroll`` consecutive step bodies of every scan. On a CUDA
    device the first ``N_WARMUP`` units run eagerly on a side stream (real
    iterations: capture executes nothing, so none is skipped or repeated),
    then one unit is captured into a ``torch.cuda.CUDAGraph`` and every
    later unit is a replay of it. Where S > 1 each scan's bodies run on a
    branch stream of their own, forked from the unit's stream and joined to
    it, so that the scans' small kernels overlap (the branches cannot share
    memory: PERF.md §5). A scan's kernels see the same inputs in the same
    order whatever S is, so its results are its one-scan window's, bit for
    bit. The graph holds the addresses of the parameters, optimizer states
    and scenes; when the caller hands over other tensors it is dropped and
    captured again after a new warm-up. A capture that fails raises. The
    kernels' launch counts, which Python advances once at capture, advance
    by the capture's count at every replay."""

    def __init__(self, cfg: Config, body: Callable, window: int, unroll: int, n_scans: int = 1):
        if unroll < 1 or window % unroll != 0:
            raise ValueError(f"unroll {unroll} must divide window {window}")
        self.cfg, self.body, self.window, self.unroll = cfg, body, window, unroll
        self.n_scans = n_scans
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.bound: Optional[tuple] = None
        self.warm = 0
        self.per_replay: List[tuple] = []
        self.stream = None
        self.branches: Optional[List[torch.cuda.Stream]] = None
        self.static: Optional[Dict[str, Any]] = None

    def __call__(self, params: Params, opt_state: Params, scene, img_idxs: torch.Tensor,
                 generator: Optional[torch.Generator], scheds: torch.Tensor,
                 noise: Optional[Sequence[Noise]] = None) -> torch.Tensor:
        """One scan: img_idxs [window] and scheds [window, len(SCHEDULE_KEYS)];
        ``noise`` (one dict a step) replaces the draws from ``generator``.
        Returns the metric rows [window, len(METRIC_KEYS)] on the device."""
        return self.call_scans([params], [opt_state], [scene], img_idxs[:, None], [generator],
                               scheds[:, None], noise)[:, 0]

    def call_scans(self, params: Sequence[Params], opt_states: Sequence[Params],
                   scenes: Sequence[Dict[str, torch.Tensor]], img_idxs: torch.Tensor,
                   generators: Sequence[Optional[torch.Generator]], scheds: torch.Tensor,
                   noise: Optional[Sequence[Sequence[Noise]]] = None) -> torch.Tensor:
        """S scans: img_idxs [window, S] and scheds [window, S,
        len(SCHEDULE_KEYS)] on the scenes' device; ``noise[j][i]``, scan i's
        draws at step j (a dict for one scan), read just before step j runs,
        replaces the draws from ``generators[i]``. Returns the metric rows
        [window, S, len(METRIC_KEYS)] on the device; the parameters and
        optimizer states are updated in place."""
        k, u, S = self.window, self.unroll, self.n_scans
        if (not len(params) == len(opt_states) == len(scenes) == len(generators) == S
                or tuple(img_idxs.shape) != (k, S)
                or tuple(scheds.shape) != (k, S, len(SCHEDULE_KEYS))
                or (noise is not None and len(noise) != k)):
            raise ValueError(f"a window of {k} steps of {S} scans takes {S} parameter sets, "
                             f"optimizer states, scenes and generators, img_idxs [{k}, {S}], "
                             f"scheds [{k}, {S}, {len(SCHEDULE_KEYS)}] and {k} draws; got "
                             f"{tuple(img_idxs.shape)} and {tuple(scheds.shape)}")
        with span("window.call"):
            dev = scenes[0]["images"].device
            rows = torch.empty((k, S, len(METRIC_KEYS)), dtype=torch.float32, device=dev)
            trees = [dict(enumerate(xs)) for xs in (params, opt_states, scenes)]
            for r in range(0, k, u):
                with span("window.draws"):
                    # each scan consumes its own generator in its steps' order
                    draws = [[draw_noise(self.cfg, sc, g) for sc, g in zip(scenes, generators)]
                             if noise is None else noise[r + j] for j in range(u)]
                    draws = [[d] if isinstance(d, Mapping) else d for d in draws]
                    st = self._buffers(draws, dev)
                    for step, bufs in zip(draws, st["noise"]):
                        for d, buf in zip(step, bufs, strict=True):
                            if d.keys() != buf.keys():
                                raise ValueError(f"draws {sorted(d)} differ from the window's "
                                                 f"{sorted(buf)}")
                            for key, t in d.items():
                                buf[key].copy_(t)
                    st["idx"].copy_(img_idxs[r:r + u])
                    st["sched"].copy_(scheds[r:r + u])
                self._run(*trees, dev)
                rows[r:r + u].copy_(st["rows"])
            return rows

    def _buffers(self, draws: Sequence[Sequence[Noise]], dev) -> Dict[str, Any]:
        if self.static is None:
            u, S = self.unroll, self.n_scans
            self.static = {
                "noise": [[{key: torch.empty_like(t, device=dev) for key, t in d.items()}
                           for d in step] for step in draws],
                "idx": torch.zeros((u, S), dtype=torch.long, device=dev),
                "sched": torch.zeros((u, S, len(SCHEDULE_KEYS)), dtype=torch.float32, device=dev),
                "rows": torch.zeros((u, S, len(METRIC_KEYS)), dtype=torch.float32, device=dev),
            }
        return self.static

    def _unit(self, params, opt_state, scene) -> None:
        """params, opt_state, scene: scan -> that scan's tree."""
        st = self.static
        dev = st["idx"].device
        fork = dev.type == "cuda" and self.n_scans > 1
        if fork:
            main = torch.cuda.current_stream(dev)
            if self.branches is None:
                self.branches = [torch.cuda.Stream(dev) for _ in range(self.n_scans)]
        for i in range(self.n_scans):
            if fork:
                self.branches[i].wait_stream(main)
            with torch.cuda.stream(self.branches[i]) if fork else contextlib.nullcontext():
                rows = [self.body(params[i], opt_state[i], scene[i], st["idx"][j, i],
                                  st["sched"][j, i], noise=st["noise"][j][i])
                        for j in range(self.unroll)]
                st["rows"][:, i].copy_(torch.stack(
                    [torch.stack([m[name] for name in METRIC_KEYS]) for m in rows]))
        if fork:
            for side in self.branches:
                main.wait_stream(side)

    def _run(self, params, opt_state, scene, dev) -> None:
        if dev.type != "cuda":
            count("window.eager_units")
            self._unit(params, opt_state, scene)
            return
        bound = tuple(t.data_ptr() for trees in (params, opt_state, scene)
                      for tree in trees.values() for _, t in leaves(tree))
        if self.graph is not None and bound != self.bound:
            self.graph, self.warm = None, 0  # captured over tensors that were replaced
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        if self.graph is None and self.warm < N_WARMUP:
            main = torch.cuda.current_stream(dev)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                self._unit(params, opt_state, scene)
            main.wait_stream(self.stream)
            self.warm += 1
            count("window.eager_units")
            return
        if self.graph is None:
            self._capture(params, opt_state, scene, bound)
        with span("window.replay"):
            self.graph.replay()
        count("window.replays")
        for kernel, n in self.per_replay:
            kernel.launches += n

    def _capture(self, params, opt_state, scene, bound) -> None:
        kernels = launch_counters()
        before = [kernel.launches for kernel in kernels]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            self._unit(params, opt_state, scene)
        self.per_replay = [(kernel, kernel.launches - n) for kernel, n in zip(kernels, before)]
        for kernel, n in zip(kernels, before):  # the capture launched nothing
            kernel.launches = n
        self.graph, self.bound = graph, bound
        count("window.captures")


def build_train_window(cfg: Config, renderer: UDFRenderer, *, blending: bool, window: int,
                       unroll: int = 1) -> TrainWindow:
    """window_fn(params, opt_state, scene, img_idxs, generator, scheds,
    noise=None) -> metric rows [window, len(METRIC_KEYS)]: ``window``
    iterations of one scan, ``unroll`` step bodies a graph (see
    ``TrainWindow``). ``unroll`` must divide ``window``."""
    return TrainWindow(cfg, build_step_body(cfg, renderer, blending=blending), window, unroll)
