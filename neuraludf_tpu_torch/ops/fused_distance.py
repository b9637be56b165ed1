"""Fused distance-field value + feature + spatial gradient, and its
second-order VJP: kernels K1 and K2 (``csrc/fused_distance.cu``).

Counterpart of ``neuraludf_tpu/ops/fused_distance.py``. The training step
evaluates the UDF MLP at every sample point and needs (udf, feature,
∇udf) plus the VJP through all three (the eikonal term makes it second
order). ``FusedDistance`` wraps the two CUDA kernels in one autograd
Function: forward = K1, backward = K2. Weight norm stays outside, in torch
(``effective_weights``), where its VJP is cheap [256×256] math.

Beside the kernels live two plain versions of the same function:

* **autograd**: ``distance_field_apply`` + ``autograd.grad(create_graph=True)``
  (``plain_autograd``);
* **explicit**: the kernels' own formulas written out in torch on the same
  padded layout (``explicit_forward`` / ``explicit_backward``): a forward
  sweep, a tangent sweep seeded with t_e = s·J_PE·ḡ, and a reverse pass with
  two cotangents (ā for the primals, γ for the tangents).

The Function takes the explicit version only for tensors on the CPU; a
CUDA tensor launches the kernels or raises.

Tiers (``cfg.fused_precision``): "highest" = f32 operands on the CUDA cores;
"default" = bf16 operands with f32 accumulation on the tensor cores. There
the kernels also keep what the reverse sweep reads back from the forward one
in bf16: sigma(100 a) and, for K2, q = 100 sigma (1 - sigma) t_a. The explicit
version rounds its matmul operands and these two to bf16 the same way, so it
stays the kernels' arithmetic step by step. The "default" kernels take the
widths they were written for (``default_tier_takes``); another net raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..config import UDFNetworkConfig
from ..nets import fields
from ..nets.mlp import softplus100, weight
from . import build

TILE = 64  # the kernels' column tile; every padded width is a multiple
ROW_TILE = {"highest": 64, "default": 128}  # rows are padded to the tier's row tile
# split-K partial sums of the weight cotangent ("default": 20 output tiles x 13
# splits are two waves of blocks on 132 SMs)
W_SPLITS = {"highest": 64, "default": 13}
SWEEP_WIDTH = 256  # hidden width of the "default" kernels' sweeps
HEADS = {"abs": 0, "square": 1, "sdf": 2}
TIERS = ("default", "highest")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


# ----------------------------------------------------------------------
# switches
# ----------------------------------------------------------------------


def fused_enabled(cfg: UDFNetworkConfig, device: torch.device) -> bool:
    """cfg.fused_core: 'auto' = the kernels on CUDA, the plain path on the
    CPU; 'on' = the kernels (raises on the CPU); 'off' = the plain path."""
    flag = (cfg.fused_core or "auto").lower()
    if flag == "off":
        return False
    if flag == "on":
        if torch.device(device).type != "cuda":
            raise RuntimeError("fused_core='on' needs a CUDA device; use 'auto' or 'off' on the CPU")
        return True
    if flag != "auto":
        raise ValueError(f"fused_core must be auto|on|off, got {cfg.fused_core!r}")
    return torch.device(device).type == "cuda"


def precision_tier(cfg: UDFNetworkConfig) -> str:
    tier = (cfg.fused_precision or "default").lower()
    if tier == "high":
        raise NotImplementedError(
            "fused_precision='high' (bf16x3) is not ported yet (ROADMAP: slice 1, open item 3)"
        )
    if tier not in TIERS:
        raise ValueError(f"fused_precision must be one of {TIERS}, got {tier!r}")
    return tier


# ----------------------------------------------------------------------
# padded layout, shared by the kernels and the explicit plain version
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class Layout:
    """Per linear layer l: the input is [h-part | e-part]; h is the previous
    layer's output padded to ``kh[l]``, e the embedding padded to ``pe_w``
    (layer 0 and skip layers only). ``kp[l]``/``np_[l]`` are the padded
    input/output widths, ``h_true``/``n_true`` the unpadded ones."""

    d0: int
    pe_w: int
    multires: int
    scale: float
    head: str
    d_out: int
    kp: Tuple[int, ...]
    np_: Tuple[int, ...]
    kh: Tuple[int, ...]
    skip: Tuple[bool, ...]
    h_true: Tuple[int, ...]
    n_true: Tuple[int, ...]

    @property
    def n_layers(self) -> int:
        return len(self.kp)

    def alpha(self, l: int) -> float:
        return 1.0 / math.sqrt(2.0) if self.skip[l] else 1.0

    def dims(self) -> List[int]:
        out = []
        for l in range(self.n_layers):
            out += [self.kp[l], self.np_[l], self.kh[l], int(self.skip[l])]
        return out

    def w_offsets(self) -> List[int]:
        offs, o = [], 0
        for l in range(self.n_layers):
            offs.append(o)
            o += self.kp[l] * self.np_[l]
        return offs + [o]

    def b_offsets(self) -> List[int]:
        offs, o = [], 0
        for l in range(self.n_layers):
            offs.append(o)
            o += self.np_[l]
        return offs + [o]

    def views(self, wflat: torch.Tensor, bflat: torch.Tensor):
        wo, bo = self.w_offsets(), self.b_offsets()
        ws = [wflat[wo[l]:wo[l + 1]].view(self.kp[l], self.np_[l]) for l in range(self.n_layers)]
        bs = [bflat[bo[l]:bo[l + 1]] for l in range(self.n_layers)]
        return ws, bs


@functools.lru_cache(maxsize=None)
def layout_for(cfg: UDFNetworkConfig) -> Layout:
    if 0 in cfg.skip_in:
        raise ValueError("a skip connection into layer 0 is not supported by the fused kernels")
    if cfg.udf_type not in HEADS:
        raise ValueError(f"udf_type {cfg.udf_type!r}")
    dims, d0 = fields.distance_dims(cfg)
    n_lin = cfg.n_layers + 1
    pe_w = _round_up(d0, TILE)
    kp, np_, kh, skip, h_true, n_true = [], [], [], [], [], []
    for l in range(n_lin):
        out = dims[l + 1] - d0 if (l + 1) in cfg.skip_in else dims[l + 1]
        n_true.append(out)
        np_.append(_round_up(out, TILE))
        sk = l in cfg.skip_in
        skip.append(sk)
        if l == 0:
            kh.append(0)
            h_true.append(0)
            kp.append(pe_w)
        else:
            kh.append(np_[l - 1])
            h_true.append(n_true[l - 1])
            kp.append(np_[l - 1] + (pe_w if sk else 0))
    return Layout(d0, pe_w, cfg.multires, float(cfg.scale), cfg.udf_type, cfg.d_out,
                  tuple(kp), tuple(np_), tuple(kh), tuple(skip), tuple(h_true), tuple(n_true))


def default_tier_takes(lay: Layout) -> bool:
    """Whether the "default" kernels take this net: their sweeps are written
    for a 64-wide embedding, 256-wide hidden layers (skips anywhere but into
    the head) and a head padded to 320 columns, at most 16 linear layers."""
    n = lay.n_layers
    return (2 <= n <= 16 and lay.pe_w == TILE and not lay.skip[-1]
            and all(w == SWEEP_WIDTH for w in lay.np_[:-1])
            and lay.np_[-1] == SWEEP_WIDTH + TILE)


def _row_map(lay: Layout, l: int):
    """(true row slices, padded row starts) of layer l's weight."""
    if l == 0:
        return [(0, lay.d0, 0)]
    parts = [(0, lay.h_true[l], 0)]
    if lay.skip[l]:
        parts.append((lay.h_true[l], lay.h_true[l] + lay.d0, lay.kh[l]))
    return parts


def pack(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], lay: Layout):
    """Zero-padded flat weight and bias buffers in the kernels' layout."""
    dev = ws[0].device
    wflat = torch.zeros(lay.w_offsets()[-1], dtype=torch.float32, device=dev)
    bflat = torch.zeros(lay.b_offsets()[-1], dtype=torch.float32, device=dev)
    wv, bv = lay.views(wflat, bflat)
    for l in range(lay.n_layers):
        n = lay.n_true[l]
        for r0, r1, p0 in _row_map(lay, l):
            wv[l][p0:p0 + r1 - r0, :n] = ws[l][r0:r1]
        bv[l][:n] = bs[l]
    return wflat, bflat


def unpack(wflat: torch.Tensor, bflat: torch.Tensor, lay: Layout):
    """Inverse of ``pack``: true-shaped weight and bias lists."""
    wv, bv = lay.views(wflat, bflat)
    ws, bs = [], []
    for l in range(lay.n_layers):
        n = lay.n_true[l]
        ws.append(torch.cat([wv[l][p0:p0 + r1 - r0, :n] for r0, r1, p0 in _row_map(lay, l)], 0))
        bs.append(bv[l][:n])
    return ws, bs


def effective_weights(params, cfg: UDFNetworkConfig):
    """Weight-norm layers resolved to plain (W [d_in,d_out], b) lists."""
    n_lin = cfg.n_layers + 1
    return ([weight(params[f"lin{l}"]) for l in range(n_lin)],
            [params[f"lin{l}"]["b"] for l in range(n_lin)])


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------


def plain_autograd(x, ws, bs, cfg: UDFNetworkConfig):
    """distance_field_apply + autograd.grad(create_graph=True) on effective
    weights; differentiable again through every output."""
    params = {f"lin{l}": {"w": w, "b": b} for l, (w, b) in enumerate(zip(ws, bs))}
    return fields.distance_value_and_gradient_plain(params, x, cfg)


def _stored(t: torch.Tensor, tier: str) -> torch.Tensor:
    """A value as the kernels keep it between sweeps: bf16 at tier "default"."""
    return t.to(torch.bfloat16).float() if tier == "default" else t


def _mm(a: torch.Tensor, b: torch.Tensor, tier: str) -> torch.Tensor:
    # the kernels' bf16 operands, f32 accumulation
    return _stored(a, tier) @ _stored(b, tier)


def _pe(x: torch.Tensor, lay: Layout):
    """Embedding e and its first and second derivatives along the
    coordinate each column depends on (column j depends on y[j % 3])."""
    y = x * lay.scale
    e, d1, d2 = [y], [torch.ones_like(y)], [torch.zeros_like(y)]
    for k in range(lay.multires):
        f = float(2.0 ** k)
        sn, cs = torch.sin(y * f), torch.cos(y * f)
        e += [sn, cs]
        d1 += [f * cs, -f * sn]
        d2 += [-f * f * sn, -f * f * cs]
    pad = lambda t: torch.nn.functional.pad(torch.cat(t, -1), (0, lay.pe_w - lay.d0))
    return pad(e), pad(d1), pad(d2)


def _coord_sum(t: torch.Tensor, lay: Layout) -> torch.Tensor:
    """Sum the embedding columns of each coordinate: [N, pe_w] -> [N, 3]."""
    return t[:, :lay.d0].reshape(t.shape[0], lay.d0 // 3, 3).sum(1)


def _head(raw, lay: Layout):
    """(phi(raw)/s, phi'(raw)/s, phi''/s); sign(0) = 0 like JAX's abs."""
    s = lay.scale
    if lay.head == "abs":
        return raw.abs() / s, torch.sign(raw) / s, 0.0
    if lay.head == "square":
        return raw * raw / s, 2.0 * raw / s, 2.0 / s
    return raw / s, torch.ones_like(raw) / s, 0.0


def _sweep(e, W, B, lay: Layout, tier: str, te=None):
    """Forward sweep; with te, also the tangent sweep. Returns the inputs and
    pre-activations of every layer (and their tangents)."""
    ins, acts, tins, tacts = [], [], [], []
    h = th = None
    for l in range(lay.n_layers):
        if l == 0:
            inp, tin = e, te
        elif lay.skip[l]:
            inp = torch.cat([h, e], -1)
            tin = torch.cat([th, te], -1) if te is not None else None
        else:
            inp, tin = h, th
        a = lay.alpha(l) * _mm(inp, W[l], tier) + B[l]
        ins.append(inp)
        acts.append(a)
        h = softplus100(a)
        if te is not None:
            ta = lay.alpha(l) * _mm(tin, W[l], tier)
            tins.append(tin)
            tacts.append(ta)
            th = torch.sigmoid(100.0 * a) * ta
    return ins, acts, tins, tacts


def explicit_forward(x, wflat, bflat, lay: Layout, tier: str):
    """K1's formulas in torch: (udf [N,1], feat [N,d_out-1], grad [N,3])."""
    W, B = lay.views(wflat, bflat)
    e, d1, _ = _pe(x, lay)
    _, acts, _, _ = _sweep(e, W, B, lay, tier)
    raw = acts[-1][:, 0]
    udf, c, _ = _head(raw, lay)
    g = torch.zeros_like(acts[-1])
    g[:, 0] = c
    eps = torch.zeros_like(e)
    for l in reversed(range(lay.n_layers)):
        d = lay.alpha(l) * _mm(g, W[l].T, tier)
        kh = lay.kh[l]
        eps = eps + d[:, kh:] if d.shape[1] > kh else eps
        if l > 0:
            g = _stored(torch.sigmoid(100.0 * acts[l - 1]), tier) * d[:, :kh]
    grad = lay.scale * _coord_sum(d1 * eps, lay)
    return udf[:, None], acts[-1][:, 1:lay.d_out], grad


def explicit_backward(x, wflat, bflat, lay: Layout, tier: str, ubar, fbar, gbar):
    """K2's formulas in torch: the VJP of (udf, feat, grad) with cotangents
    (ubar, fbar, gbar). Returns (x̄, W̄ flat, b̄ flat) in the padded layout."""
    W, B = lay.views(wflat, bflat)
    s = lay.scale
    e, d1, d2 = _pe(x, lay)
    cols = torch.arange(lay.pe_w, device=x.device) % 3
    te = s * d1 * gbar[:, cols]
    ins, acts, tins, tacts = _sweep(e, W, B, lay, tier, te)
    raw, tan0 = acts[-1][:, 0], tacts[-1][:, 0]
    _, c, d2phi = _head(raw, lay)
    abar = torch.zeros_like(acts[-1])
    abar[:, 0] = ubar[:, 0] * c + d2phi * tan0
    abar[:, 1:lay.d_out] = fbar
    gam = torch.zeros_like(acts[-1])
    gam[:, 0] = c
    ebar, eps = torch.zeros_like(e), torch.zeros_like(e)
    wbar, bbar = torch.zeros_like(wflat), torch.zeros_like(bflat)
    Wb, Bb = lay.views(wbar, bbar)
    for l in reversed(range(lay.n_layers)):
        al = lay.alpha(l)
        Wb[l].copy_(al * (_mm(ins[l].T, abar, tier) + _mm(tins[l].T, gam, tier)))
        Bb[l].copy_(abar.sum(0))
        dg = al * _mm(gam, W[l].T, tier)
        da = al * _mm(abar, W[l].T, tier)
        kh = lay.kh[l]
        if dg.shape[1] > kh:
            eps = eps + dg[:, kh:]
            ebar = ebar + da[:, kh:]
        if l > 0:
            sg = torch.sigmoid(100.0 * acts[l - 1])
            q = _stored(100.0 * sg * (1.0 - sg) * tacts[l - 1], tier)
            sg = _stored(sg, tier)
            abar = sg * da[:, :kh] + q * dg[:, :kh]
            gam = sg * dg[:, :kh]
    xbar = s * _coord_sum(d1 * ebar, lay) + s * s * gbar * _coord_sum(d2 * eps, lay)
    return xbar, wbar, bbar


# ----------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """csrc/fused_distance.cu, built at first use, with its argument types."""
    lib = build.load("fused_distance")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fd_scratch_bytes.argtypes = [I, P, I, I, I, I, I, I]
    lib.fd_scratch_bytes.restype = ctypes.c_size_t
    lib.fd_forward.argtypes = [P, P, P, I, P, I, I, F, I, I, I, I, P, P, P, P, P]
    lib.fd_forward.restype = I
    lib.fd_backward.argtypes = [P, P, P, I, P, I, I, F, I, I, I, I, P, P, P, P, P, P, P, I, P]
    lib.fd_backward.restype = I
    return lib


def _check(t: torch.Tensor, name: str, shape, device):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 tensor on {device}, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t.contiguous()
    out = torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


class _Kernel:
    """A kernel's launcher with its launch count (one per launch)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def _common(self, x, wflat, bflat, lay: Layout, tier: str):
        if x.device.type != "cuda":
            raise ValueError(f"{self.name} launches on CUDA tensors only, got {x.device}")
        if tier not in TIERS:
            raise ValueError(f"tier {tier!r}")
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"x: expected [N, 3], got {tuple(x.shape)}")
        _check(x, "x", x.shape, x.device)
        _check(wflat, "wflat", (lay.w_offsets()[-1],), x.device)
        _check(bflat, "bflat", (lay.b_offsets()[-1],), x.device)
        if tier == "default" and not default_tier_takes(lay):
            raise ValueError(
                f"{self.name}: the 'default' kernels take a {TILE}-wide embedding, "
                f"{SWEEP_WIDTH}-wide hidden layers and a head of {SWEEP_WIDTH + 1} to "
                f"{SWEEP_WIDTH + TILE} outputs; use fused_precision='highest' for {lay}")
        dims = (ctypes.c_int * (4 * lay.n_layers))(*lay.dims())
        rows = _round_up(x.shape[0], ROW_TILE[tier])
        return dims, rows

    def _scratch(self, lay: Layout, dims, rows: int, tier: str, backward: bool, dev):
        """The call's scratch buffer; call with dev current (the size
        depends on the card's SM count)."""
        n = library().fd_scratch_bytes(lay.n_layers, ctypes.addressof(dims), lay.pe_w,
                                       lay.multires, rows, int(backward), W_SPLITS[tier],
                                       int(tier == "default"))
        if n == 0:
            raise ValueError(f"{self.name}: layout rejected by the kernel: {lay}")
        return torch.empty(n, dtype=torch.uint8, device=dev)

    @staticmethod
    def _raise_on(rc: int, name: str):
        if rc != 0:
            raise RuntimeError(f"{name} failed: CUDA error {rc}")


class _ForwardKernel(_Kernel):
    def __call__(self, x, wflat, bflat, lay: Layout, tier: str):
        dims, rows = self._common(x, wflat, bflat, lay, tier)
        lib = library()
        n, dev = x.shape[0], x.device
        xp = _pad_rows(x, rows)
        udf = torch.empty((rows, 1), dtype=torch.float32, device=dev)
        feat = torch.empty((rows, lay.d_out - 1), dtype=torch.float32, device=dev)
        grad = torch.empty((rows, 3), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            scratch = self._scratch(lay, dims, rows, tier, False, dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fd_forward(
                xp.data_ptr(), wflat.data_ptr(), bflat.data_ptr(), lay.n_layers,
                ctypes.addressof(dims), lay.pe_w, lay.multires, lay.scale, HEADS[lay.head],
                lay.d_out, rows, int(tier == "default"), udf.data_ptr(), feat.data_ptr(),
                grad.data_ptr(), scratch.data_ptr(), stream,
            )
            self.launches += 1
        self._raise_on(rc, self.name)
        return udf[:n], feat[:n], grad[:n]


class _BackwardKernel(_Kernel):
    def __call__(self, x, wflat, bflat, lay: Layout, tier: str, ubar, fbar, gbar):
        dims, rows = self._common(x, wflat, bflat, lay, tier)
        lib = library()
        n, dev = x.shape[0], x.device
        for t, name, w in ((ubar, "ubar", 1), (fbar, "fbar", lay.d_out - 1), (gbar, "gbar", 3)):
            _check(t, name, (n, w), dev)
        xp, up, fp, gp = (_pad_rows(t, rows) for t in (x, ubar, fbar, gbar))
        xbar = torch.empty((rows, 3), dtype=torch.float32, device=dev)
        wbar = torch.empty_like(wflat)
        bbar = torch.empty_like(bflat)
        with torch.cuda.device(dev):
            scratch = self._scratch(lay, dims, rows, tier, True, dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fd_backward(
                xp.data_ptr(), wflat.data_ptr(), bflat.data_ptr(), lay.n_layers,
                ctypes.addressof(dims), lay.pe_w, lay.multires, lay.scale, HEADS[lay.head],
                lay.d_out, rows, int(tier == "default"), up.data_ptr(), fp.data_ptr(),
                gp.data_ptr(), xbar.data_ptr(), wbar.data_ptr(), bbar.data_ptr(),
                scratch.data_ptr(), W_SPLITS[tier], stream,
            )
            self.launches += 1
        self._raise_on(rc, self.name)
        return xbar[:n], wbar, bbar


fused_forward = _ForwardKernel("fused_distance_fwd")  # K1
fused_backward = _BackwardKernel("fused_distance_bwd")  # K2


# ----------------------------------------------------------------------
# autograd Function and entry point
# ----------------------------------------------------------------------


class FusedDistance(torch.autograd.Function):
    """(udf, feat, grad) = K1(x, W, b); backward = K2. CPU tensors take the
    explicit plain version."""

    @staticmethod
    def forward(ctx, x, lay: Layout, tier: str, *wb):
        n_w = len(wb) // 2
        wflat, bflat = pack(wb[:n_w], wb[n_w:], lay)
        xc = x.detach().contiguous()
        if x.is_cuda:
            out = fused_forward(xc, wflat, bflat, lay, tier)
        else:
            out = explicit_forward(xc, wflat, bflat, lay, tier)
        ctx.save_for_backward(xc, wflat, bflat)
        ctx.lay, ctx.tier = lay, tier
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ubar, fbar, gbar):
        x, wflat, bflat = ctx.saved_tensors
        lay, tier = ctx.lay, ctx.tier
        ubar, fbar, gbar = (t.contiguous() for t in (ubar, fbar, gbar))
        if x.is_cuda:
            xbar, wbar, bbar = fused_backward(x, wflat, bflat, lay, tier, ubar, fbar, gbar)
        else:
            xbar, wbar, bbar = explicit_backward(x, wflat, bflat, lay, tier, ubar, fbar, gbar)
        ws, bs = unpack(wbar, bbar, lay)
        return (xbar, None, None, *ws, *bs)


def distance_value_feat_grad_fused(params, x: torch.Tensor, cfg: UDFNetworkConfig):
    """Drop-in fused replacement for fields.distance_value_and_gradient, at
    the tier cfg.fused_precision names."""
    ws, bs = effective_weights(params, cfg)
    return FusedDistance.apply(x, layout_for(cfg), precision_tier(cfg), *ws, *bs)
