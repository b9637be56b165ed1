"""The NeRF++ background MLP as one hand-written sweep, forward and
backward: kernel pair K4 (``csrc/nerf_mlp.cu``).

``nets/fields.py`` ``background_nerf_apply`` evaluates the background model
at every outside sample of a step (512 rays x 146 samples in a DTU step).
On CUDA tensors, for the network the kernels take (``nerf_kernel_takes``:
the published DTU NeRF++, 8 x 256 with a skip after layer 4, view
directions, 10 and 4 encoding frequencies) and at the "bf16" precision
policy of ``nets/mlp.py``, it calls ``nerf_apply``: the forward sweep
(``nerf_forward``), and under autograd ``NerfMLP``, whose backward is the
backward sweep (``nerf_backward``). Every other network, every CPU tensor,
a ``pts`` or ``views`` that requires grad and any other precision policy
keep the plain PyTorch chain.

The kernels round every product's operands to bf16 and sum in f32; biases
are added in f32 and the weight cotangents summed in f32 (the plain chain
on the card also rounds each product's output, and its weight cotangents,
to bf16). ``explicit_forward`` and ``explicit_backward`` are those
roundings written out in torch, for the tests and for ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..config import NeRFConfig
from ..nets.embedder import positional_encoding
from ..utils.trace import count
from . import build

# the layers in the kernels' order, and their (d_in, d_out)
LAYERS = (("pts", "lin0"), ("pts", "lin1"), ("pts", "lin2"), ("pts", "lin3"), ("pts", "lin4"),
          ("pts", "lin5"), ("pts", "lin6"), ("pts", "lin7"), ("feature",), ("views", "lin0"),
          ("alpha",), ("rgb",))
SHAPES = ((84, 256), (256, 256), (256, 256), (256, 256), (256, 256), (340, 256), (256, 256),
          (256, 256), (256, 256), (283, 128), (256, 1), (128, 3))
PE_DIM = 84  # the pts encoding's width: 4 x (1 + 2 x 10)
FEAT, VIEWS, ALPHA, RGB = 8, 9, 10, 11


def nerf_kernel_takes(cfg: NeRFConfig) -> bool:
    """Whether K4 takes this background network: the published DTU NeRF++
    (D = 8, W = 256, skips [4], view directions, d_in 4, d_in_view 3,
    multires 10 and multires_view 4), which the kernels are written for."""
    return (cfg.D == 8 and cfg.W == 256 and tuple(cfg.skips) == (4,) and cfg.use_viewdirs
            and cfg.d_in == 4 and cfg.d_in_view == 3 and cfg.multires == 10
            and cfg.multires_view == 4)


def layer_params(params) -> Optional[Tuple[List[torch.Tensor], List[torch.Tensor]]]:
    """(weights, biases) in ``LAYERS`` order, or None where a layer is not a
    plain {w, b} of the kernels' shape."""
    ws, bs = [], []
    for path, shape in zip(LAYERS, SHAPES):
        p = params
        for key in path:
            p = p.get(key) if isinstance(p, dict) else None
        if not isinstance(p, dict) or "w" not in p or "b" not in p:
            return None
        if tuple(p["w"].shape) != shape or tuple(p["b"].shape) != shape[1:]:
            return None
        ws.append(p["w"])
        bs.append(p["b"])
    return ws, bs


# ----------------------------------------------------------------------
# the kernels' roundings in torch
# ----------------------------------------------------------------------


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with bf16 operands and f32 sums, as the kernels' products."""
    return _bf16(x) @ _bf16(w)


def _forward_parts(pts, views, ws, bs):
    e = positional_encoding(pts, 10)
    ins, pre = [], []
    h = e
    for i in range(8):
        inp = torch.cat([e, h], -1) if i == 5 else h
        a = _mm(inp, ws[i]) + bs[i]
        ins.append(inp)
        pre.append(a)
        h = torch.relu(a)
    raw = _mm(h, ws[ALPHA]) + bs[ALPHA]
    vin = torch.cat([_mm(h, ws[FEAT]) + bs[FEAT], positional_encoding(views, 4)], -1)
    av = _mm(vin, ws[VIEWS]) + bs[VIEWS]
    hv = torch.relu(av)
    rgb = _mm(hv, ws[RGB]) + bs[RGB]
    return raw, rgb, (ins, pre, h, vin, av, hv)


def explicit_forward(pts, views, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor]):
    """K4's forward in torch: (raw [N,1], rgb [N,3])."""
    raw, rgb, _ = _forward_parts(pts, views, ws, bs)
    return raw, rgb


def explicit_backward(pts, views, ws, bs, d_raw, d_rgb):
    """K4's backward in torch: (weight cotangents, bias cotangents) in
    ``LAYERS`` order. Each product takes the cotangent and the weight in
    bf16; the masks are the forward's pre-activations > 0."""
    _, _, (ins, pre, h7, vin, av, hv) = _forward_parts(pts, views, ws, bs)
    dws: List[Optional[torch.Tensor]] = [None] * len(LAYERS)
    dbs: List[Optional[torch.Tensor]] = [None] * len(LAYERS)
    g_v = _mm(d_rgb, ws[RGB].T) * (av > 0)
    dws[RGB], dbs[RGB] = _mm(hv.T, d_rgb), d_rgb.sum(0)
    dws[ALPHA], dbs[ALPHA] = _mm(h7.T, d_raw), d_raw.sum(0)
    dws[VIEWS], dbs[VIEWS] = _mm(vin.T, g_v), g_v.sum(0)
    g_f = _mm(g_v, ws[VIEWS][:256].T)
    dws[FEAT], dbs[FEAT] = _mm(h7.T, g_f), g_f.sum(0)
    g = (_mm(g_f, ws[FEAT].T) + _mm(d_raw, ws[ALPHA].T)) * (pre[7] > 0)
    for l in reversed(range(8)):
        dws[l], dbs[l] = _mm(ins[l].T, g), g.sum(0)
        if l > 0:
            back = _mm(g, ws[l].T)
            g = (back[:, PE_DIM:] if l == 5 else back) * (pre[l - 1] > 0)
    return dws, dbs


# ----------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """csrc/nerf_mlp.cu, built at first use, with its argument types."""
    lib = build.load("nerf_mlp")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.nerf_scratch_bytes.argtypes = [I, I]
    lib.nerf_scratch_bytes.restype = ctypes.c_size_t
    lib.nerf_param_count.argtypes = []
    lib.nerf_param_count.restype = ctypes.c_long
    lib.nerf_forward.argtypes = [P, P, P, P, I, P, P, I, P, P]
    lib.nerf_forward.restype = I
    lib.nerf_backward.argtypes = [P, I, P, P, P, P, P, P]
    lib.nerf_backward.restype = I
    if lib.nerf_param_count() != sum((d_in + 1) * d_out for d_in, d_out in SHAPES):
        raise RuntimeError("csrc/nerf_mlp.cu lays out other layers than ops/nerf_mlp.py's SHAPES")
    return lib


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 tensor on {device}, got {t.dtype} "
                         f"on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _pointers(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _check_layers(ws, bs, dev) -> None:
    for i, (w, b, shape) in enumerate(zip(ws, bs, SHAPES)):
        _check(w, f"{'.'.join(LAYERS[i])}.w", shape, dev)
        _check(b, f"{'.'.join(LAYERS[i])}.b", shape[1:], dev)


class _Forward:
    """K4's forward launcher with its launch count (one per call: the
    weights' pack and the sweep)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, pts, views, ws, bs, save: bool):
        """(raw [N,1], rgb [N,3], scratch): with ``save`` the scratch holds
        what ``nerf_backward`` reads. Raises ValueError on a tensor that is
        not a contiguous float32 CUDA tensor of the kernels' shapes."""
        if pts.device.type != "cuda":
            raise ValueError(f"K4 launches on CUDA tensors only, got {pts.device}")
        dev, n = pts.device, pts.shape[0]
        if n == 0:
            raise ValueError("K4 takes at least one row")
        _check(pts, "pts", (n, 4), dev)
        _check(views, "views", (n, 3), dev)
        _check_layers(ws, bs, dev)
        raw = torch.empty((n, 1), dtype=torch.float32, device=dev)
        rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
        lib = library()
        with torch.cuda.device(dev):
            scratch = torch.empty(lib.nerf_scratch_bytes(n, int(save)), dtype=torch.uint8,
                                  device=dev)
            rc = lib.nerf_forward(pts.data_ptr(), views.data_ptr(), _pointers(ws), _pointers(bs),
                                  n, raw.data_ptr(), rgb.data_ptr(), int(save),
                                  scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            self.launches += 1
        count("op.nerf_fwd")
        if rc != 0:
            raise RuntimeError(f"nerf_forward failed: CUDA error {rc}")
        return raw, rgb, scratch


class _Backward:
    """K4's backward launcher with its launch count (one per call: the
    sweep, the weight cotangents' GEMM and their reduction)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, ws, n: int, d_raw, d_rgb, fwd_scratch):
        """Every layer's (W̄, b̄) in ``LAYERS`` order, views of one buffer."""
        dev = d_raw.device
        if dev.type != "cuda":
            raise ValueError(f"K4 launches on CUDA tensors only, got {dev}")
        _check(d_raw, "d_raw", (n, 1), dev)
        _check(d_rgb, "d_rgb", (n, 3), dev)
        for i, (w, shape) in enumerate(zip(ws, SHAPES)):
            _check(w, f"{'.'.join(LAYERS[i])}.w", shape, dev)
        lib = library()
        out = torch.empty(lib.nerf_param_count(), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            scratch = torch.empty(lib.nerf_scratch_bytes(n, 2), dtype=torch.uint8, device=dev)
            rc = lib.nerf_backward(_pointers(ws), n, d_raw.data_ptr(), d_rgb.data_ptr(),
                                   fwd_scratch.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
            self.launches += 1
        count("op.nerf_bwd")
        if rc != 0:
            raise RuntimeError(f"nerf_backward failed: CUDA error {rc}")
        grads, o = [], 0
        for d_in, d_out in SHAPES:
            grads.append(out[o:o + d_in * d_out].view(d_in, d_out))
            o += d_in * d_out
            grads.append(out[o:o + d_out])
            o += d_out
        return grads[0::2], grads[1::2]


nerf_forward = _Forward()
nerf_backward = _Backward()


class NerfMLP(torch.autograd.Function):
    """(raw, rgb) = K4 forward(pts, views, W, b); backward = K4 backward.
    No cotangent flows to pts or views."""

    @staticmethod
    def forward(ctx, pts, views, *wb):
        n_l = len(LAYERS)
        raw, rgb, scratch = nerf_forward(pts, views, wb[:n_l], wb[n_l:], save=True)
        ctx.scratch, ctx.n = scratch, pts.shape[0]
        ctx.save_for_backward(*wb[:n_l])
        return raw, rgb

    @staticmethod
    @once_differentiable
    def backward(ctx, d_raw, d_rgb):
        dws, dbs = nerf_backward(list(ctx.saved_tensors), ctx.n, d_raw.contiguous(),
                                 d_rgb.contiguous(), ctx.scratch)
        ctx.scratch = None
        return (None, None, *dws, *dbs)


def nerf_apply(ws, bs, pts: torch.Tensor, views: torch.Tensor):
    """(raw [N,1], rgb [N,3]) through K4: forward alone where no gradient is
    wanted (the validation renders), else through ``NerfMLP``. The rows are
    made contiguous first (a single ray's view directions are an expanded
    view)."""
    pts, views = pts.contiguous(), views.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*ws, *bs)):
        return NerfMLP.apply(pts, views, *ws, *bs)
    raw, rgb, _ = nerf_forward(pts, views, ws, bs, save=False)
    return raw, rgb
