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

K5 (``sampling_distance_fn``, the up-sampling's value-only queries) is
K1's forward sweep at tier "default" with nothing kept for a reverse pass
and only the head's column 0: udf alone, for the no-grad rounds that decide
where samples land. Its pack resolves the weight norm once a render
(``value_pack``); each pass is one launch (``fused_value``). Where
``value_kernel_takes`` refuses (the CPU, ``fused_core = "off"``, a
"sampling" policy other than "bf16", a net the sweeps do not take) the
passes keep the plain chain; where it takes the net, a CUDA pass launches
K5 or raises. ``explicit_value`` is K5's roundings in torch.

Tiers (``cfg.fused_precision``), with the JAX package's ``_DOTS``:

* "highest": every product at f32 accuracy; nothing is kept in bf16. Two
  routes, chosen by the net's shape before the launch (``highest_route``):
  on the nets the "default" sweeps take, "tf32x3", the sweeps' design on
  the tensor cores with each operand split into tf32 hi = rna(v) and lo =
  rna(v - hi) and three passes lo hi + hi lo + hi hi (``tf32x3_mm`` is its
  plain version); on any other net, "gemm", f32 GEMMs on the CUDA cores.
* "high": bf16x3, as the TPU kernel's ``_dot3`` runs on the MXU, on route
  "bf16x3" (the sweeps' design with bf16 passes; ``bf16x3_mm`` and
  ``bf16x3_rev`` are its plain products). Every pass
  rounds both operands to bf16 and accumulates in f32. A product of an
  activation or a tangent t with W splits both: (t_hi W_hi + t_hi W_lo) +
  t_lo W_hi, hi = bf16(v) and lo = bf16(v - hi). A product of a cotangent g
  with W^T (the gradient sweep, the reverse sweep) is what JAX's transpose
  of that makes: P + bf16((S + P) - P) with P = bf16(g) W_hi^T and S =
  bf16(g) W_lo^T, so g itself is kept in bf16 and so is the W_lo part's sum.
  The weight cotangent is H + bf16((L + H) - H), H = [in; t_in]_hi^T
  bf16([abar; gamma]) and L the same with the lo parts. sigma(100 a), q and
  every other value stay f32, as in the TPU kernel.
* "default": bf16 operands with f32 accumulation on the tensor cores, one
  pass. There the kernels also keep what the reverse sweep reads back from
  the forward one in bf16: sigma(100 a) and, for K2, q = 100 sigma (1 -
  sigma) t_a.

The explicit version rounds its operands and those values in the same
places, so it stays the kernels' arithmetic step by step; given "tf32x3"
for the tier, it runs the 3xTF32 route's products (the tests use that; no
caller on the main path does). The "default" and "high" kernels take the
widths the "default" sweeps were written for (``default_tier_takes``);
another net raises there and runs at "highest".
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
from ..nets import fields, mlp
from ..nets.mlp import softplus100, weight
from ..utils.trace import count, span
from . import build

TILE = 64  # the kernels' column tile; every padded width is a multiple
# how a call runs (the kernels' ROUTE_* constants): the bf16 sweeps
# ("default"), the bf16x3 sweeps ("high"), the 3xTF32 sweeps and the f32
# CUDA-core GEMMs ("highest")
ROUTE_CODE = {"gemm": 0, "sweep": 1, "bf16x3": 2, "tf32x3": 3}
ROUTES = tuple(ROUTE_CODE)
ROW_TILE = {"gemm": 64, "sweep": 128, "bf16x3": 64, "tf32x3": 64}  # rows are padded to the route's tile
# split-K partial sums of the weight cotangent ("sweep": 20 output tiles x
# 13 splits are two waves of blocks on 132 SMs; "tf32x3" and "bf16x3": 38
# tiles x 24, 6.9 waves, so that the last wave is nearly full)
W_SPLITS = {"gemm": 64, "sweep": 13, "bf16x3": 24, "tf32x3": 24}
SWEEP_WIDTH = 256  # hidden width of the sweeps
HEADS = {"abs": 0, "square": 1, "sdf": 2}
TIERS = ("default", "high", "highest")


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


def highest_route(lay: Layout) -> str:
    """The route of tier "highest" for this net: the 3xTF32 sweeps where
    the "default" sweeps take its widths, else the f32 CUDA-core GEMMs."""
    return "tf32x3" if default_tier_takes(lay) else "gemm"


def route_for(lay: Layout, tier: str) -> str:
    """The route a call at ``tier`` takes on this net; raises where the
    tier's kernels do not take it."""
    if tier == "highest":
        return highest_route(lay)
    if tier not in TIERS:
        raise ValueError(f"tier {tier!r}")
    if not default_tier_takes(lay):
        raise ValueError(
            f"the '{tier}' kernels take a {TILE}-wide embedding, {SWEEP_WIDTH}-wide hidden "
            f"layers and a head of {SWEEP_WIDTH + 1} to {SWEEP_WIDTH + TILE} outputs; use "
            f"fused_precision='highest' for {lay}")
    return "sweep" if tier == "default" else "bf16x3"


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


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _stored(t: torch.Tensor, tier: str) -> torch.Tensor:
    """A value as the kernels keep it between sweeps: bf16 at tier "default"."""
    return _bf16(t) if tier == "default" else t


def tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to tf32 (10 fraction bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32``: on the bits, add half of the 13 dropped bits to
    the magnitude and clear them (a carry moves the exponent, subnormals
    round the same way). NaN stays NaN."""
    bits = t.contiguous().view(torch.int32)
    out = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(t), t, out)


def split_tf32(t: torch.Tensor):
    """(hi, lo) of the 3xTF32 route: hi = rna(t), lo = rna(t - hi)."""
    hi = tf32(t)
    return hi, tf32(t - hi)


def tf32x3_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the "tf32x3" kernels run it: both operands split, three
    passes with f32 sums, the small terms first (lo hi + hi lo + hi hi); lo
    lo is dropped."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm(a: torch.Tensor, b: torch.Tensor, tier: str) -> torch.Tensor:
    # one pass: the kernels' bf16 operands ("default"), f32 accumulation
    if tier == "tf32x3":
        return tf32x3_mm(a, b)
    return _stored(a, tier) @ _stored(b, tier)


def _split(t: torch.Tensor):
    """(hi, lo) of bf16x3: hi = bf16(t); lo = t - hi, rounded by its pass."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def bf16x3_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the "bf16x3" kernels run a forward product: both operands
    split, three passes with f32 sums, the small terms first (lo hi + hi lo +
    hi hi) into one accumulator; lo lo is dropped. JAX's _dot3 adds the same
    three passes in another order."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def bf16x3_rev(g: torch.Tensor, b: torch.Tensor):
    """(P, S) of a cotangent g times b as the "bf16x3" kernels keep them, in
    two accumulators: P = bf16(g) b_hi, S = bf16(g) b_lo. The product is
    ``dot3_sum(P, S)``."""
    bh, bl = _split(b)
    gh = _bf16(g)
    return gh @ bh, gh @ bl


def dot3_sum(p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """P + bf16((S + P) - P): JAX's transpose of _dot3's cast of W, through
    which the W_lo part's sum passes."""
    return p + _bf16((s + p) - p)


def _fwd_mm(inp: torch.Tensor, W: torch.Tensor, alpha: float, tier: str) -> torch.Tensor:
    """alpha inp W of an activation or a tangent. At "high" the scaled input
    is split (JAX divides the skip concat before its _dot3)."""
    if tier != "high":
        return alpha * _mm(inp, W, tier)
    xh, xl = _split(alpha * inp)
    wh, wl = _split(W)
    return (xh @ wh + xh @ wl) + xl @ wh


def _rev_mm(g: torch.Tensor, W: torch.Tensor, alpha: float, tier: str) -> torch.Tensor:
    """alpha g W^T of a cotangent g. At "high", JAX's transpose of _dot3:
    P + bf16((S + P) - P), the cotangent in bf16 (the cast's transpose)."""
    if tier != "high":
        return alpha * _mm(g, W.T, tier)
    wh, wl = _split(W)
    gh = _bf16(g)
    p = gh @ wh.T
    return alpha * dot3_sum(p, gh @ wl.T)


def _w_mm(ins, tins, abar, gam, alpha: float, tier: str) -> torch.Tensor:
    """W̄ = alpha [in; t_in]^T [abar; gamma]. At "high": H + bf16((L + H) -
    H), the transpose of _dot3's W split over both rows of uses."""
    if tier != "high":
        return alpha * (_mm(ins.T, abar, tier) + _mm(tins.T, gam, tier))
    xh, xl = _split(alpha * torch.cat([ins, tins], 0))
    g = _bf16(torch.cat([abar, gam], 0))
    return dot3_sum(xh.T @ g, xl.T @ g)


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
        a = _fwd_mm(inp, W[l], lay.alpha(l), tier) + B[l]
        ins.append(inp)
        acts.append(a)
        h = softplus100(a)
        if te is not None:
            ta = _fwd_mm(tin, W[l], lay.alpha(l), tier)
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
        d = _rev_mm(g, W[l], lay.alpha(l), tier)
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
        Wb[l].copy_(_w_mm(ins[l], tins[l], abar, gam, al, tier))
        Bb[l].copy_(abar.sum(0))
        dg = _rev_mm(gam, W[l], al, tier)
        da = _rev_mm(abar, W[l], al, tier)
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
    lib.fd_scratch_bytes.argtypes = [I, P, I, I, I, I, I, I, I]
    lib.fd_scratch_bytes.restype = ctypes.c_size_t
    lib.fd_forward.argtypes = [P, P, P, I, P, I, I, F, I, I, I, I, P, P, P, P, P]
    lib.fd_forward.restype = I
    lib.fd_backward.argtypes = [P, P, P, I, P, I, I, F, I, I, I, I, P, P, P, P, P, P, P, I, P]
    lib.fd_backward.restype = I
    lib.fd_value_pack_bytes.argtypes = [I, P, I, I]
    lib.fd_value_pack_bytes.restype = ctypes.c_size_t
    lib.fd_value_pack.argtypes = [I, P, P, I, I, I, P, P, P, P, P]
    lib.fd_value_pack.restype = I
    lib.fd_value.argtypes = [P, I, I, P, I, I, F, I, P, P, P]
    lib.fd_value.restype = I
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


class RouteCount:
    """The launches of one route of a kernel."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


class _Kernel:
    """A kernel's launcher with its launch count (one per launch) and one
    count per route (``routes``)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.routes = {r: RouteCount(f"{name}/{r}") for r in ROUTES}

    def _common(self, x, wflat, bflat, lay: Layout, tier: str):
        if x.device.type != "cuda":
            raise ValueError(f"{self.name} launches on CUDA tensors only, got {x.device}")
        route = route_for(lay, tier)
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"x: expected [N, 3], got {tuple(x.shape)}")
        _check(x, "x", x.shape, x.device)
        _check(wflat, "wflat", (lay.w_offsets()[-1],), x.device)
        _check(bflat, "bflat", (lay.b_offsets()[-1],), x.device)
        dims = (ctypes.c_int * (4 * lay.n_layers))(*lay.dims())
        rows = _round_up(x.shape[0], ROW_TILE[route])
        return dims, rows, route

    def _scratch(self, lay: Layout, dims, rows: int, route: str, backward: bool, dev):
        """The call's scratch buffer; call with dev current (the size
        depends on the card's SM count)."""
        n = library().fd_scratch_bytes(lay.n_layers, ctypes.addressof(dims), lay.pe_w,
                                       lay.multires, rows, int(backward), W_SPLITS[route],
                                       lay.d_out, ROUTE_CODE[route])
        if n == 0:
            raise ValueError(f"{self.name}: layout rejected by the kernel's {route} route: {lay}")
        return torch.empty(n, dtype=torch.uint8, device=dev)

    def _count(self, route: str):
        self.launches += 1
        self.routes[route].launches += 1

    @staticmethod
    def _raise_on(rc: int, name: str):
        if rc != 0:
            raise RuntimeError(f"{name} failed: CUDA error {rc}")


class _ForwardKernel(_Kernel):
    def __call__(self, x, wflat, bflat, lay: Layout, tier: str):
        dims, rows, route = self._common(x, wflat, bflat, lay, tier)
        lib = library()
        n, dev = x.shape[0], x.device
        xp = _pad_rows(x, rows)
        udf = torch.empty((rows, 1), dtype=torch.float32, device=dev)
        feat = torch.empty((rows, lay.d_out - 1), dtype=torch.float32, device=dev)
        grad = torch.empty((rows, 3), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            scratch = self._scratch(lay, dims, rows, route, False, dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fd_forward(
                xp.data_ptr(), wflat.data_ptr(), bflat.data_ptr(), lay.n_layers,
                ctypes.addressof(dims), lay.pe_w, lay.multires, lay.scale, HEADS[lay.head],
                lay.d_out, rows, ROUTE_CODE[route], udf.data_ptr(), feat.data_ptr(),
                grad.data_ptr(), scratch.data_ptr(), stream,
            )
            self._count(route)
        self._raise_on(rc, self.name)
        return udf[:n], feat[:n], grad[:n]


class _BackwardKernel(_Kernel):
    def __call__(self, x, wflat, bflat, lay: Layout, tier: str, ubar, fbar, gbar):
        dims, rows, route = self._common(x, wflat, bflat, lay, tier)
        lib = library()
        n, dev = x.shape[0], x.device
        for t, name, w in ((ubar, "ubar", 1), (fbar, "fbar", lay.d_out - 1), (gbar, "gbar", 3)):
            _check(t, name, (n, w), dev)
        xp, up, fp, gp = (_pad_rows(t, rows) for t in (x, ubar, fbar, gbar))
        xbar = torch.empty((rows, 3), dtype=torch.float32, device=dev)
        wbar = torch.empty_like(wflat)
        bbar = torch.empty_like(bflat)
        with torch.cuda.device(dev):
            scratch = self._scratch(lay, dims, rows, route, True, dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fd_backward(
                xp.data_ptr(), wflat.data_ptr(), bflat.data_ptr(), lay.n_layers,
                ctypes.addressof(dims), lay.pe_w, lay.multires, lay.scale, HEADS[lay.head],
                lay.d_out, rows, ROUTE_CODE[route], up.data_ptr(), fp.data_ptr(),
                gp.data_ptr(), xbar.data_ptr(), wbar.data_ptr(), bbar.data_ptr(),
                scratch.data_ptr(), W_SPLITS[route], stream,
            )
            self._count(route)
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
        with span("op.fd_bwd"):
            x, wflat, bflat = ctx.saved_tensors
            lay, tier = ctx.lay, ctx.tier
            ubar, fbar, gbar = (t.contiguous() for t in (ubar, fbar, gbar))
            if x.is_cuda:
                xbar, wbar, bbar = fused_backward(x, wflat, bflat, lay, tier, ubar, fbar, gbar)
            else:
                xbar, wbar, bbar = explicit_backward(x, wflat, bflat, lay, tier, ubar, fbar,
                                                     gbar)
            ws, bs = unpack(wbar, bbar, lay)
        return (xbar, None, None, *ws, *bs)


def distance_value_feat_grad_fused(params, x: torch.Tensor, cfg: UDFNetworkConfig):
    """Drop-in fused replacement for fields.distance_value_and_gradient, at
    the tier cfg.fused_precision names."""
    with span("op.fd_fwd"):
        ws, bs = effective_weights(params, cfg)
        return FusedDistance.apply(x, layout_for(cfg), precision_tier(cfg), *ws, *bs)


# ----------------------------------------------------------------------
# K5: the value-only pass of the up-sampling
# ----------------------------------------------------------------------


def value_kernel_takes(cfg: UDFNetworkConfig, device) -> bool:
    """Whether the up-sampling's distance queries on ``device`` go through
    K5: a CUDA device, ``fused_enabled``, the "sampling" policy of
    ``nets/mlp.py`` at "bf16" (the benchmark's f32 witness sets it to
    "highest"), and 3-d points into a net the "default" sweeps take."""
    if torch.device(device).type != "cuda" or mlp.PRECISION_POLICY["sampling"] != "bf16":
        return False
    if not fused_enabled(cfg, device) or cfg.d_in != 3 or 0 in cfg.skip_in:
        return False
    return cfg.udf_type in HEADS and default_tier_takes(layout_for(cfg))


def value_layers(params, cfg: UDFNetworkConfig, device):
    """[(v or W, g or None, b)] of every linear layer as contiguous float32
    tensors on ``device`` at the layout's true widths (a strided leaf is
    copied); ValueError for a tree K5 cannot read."""
    lay = layout_for(cfg)
    device = torch.device(device)
    out = []
    for l in range(lay.n_layers):
        p = params.get(f"lin{l}")
        if not isinstance(p, dict) or "b" not in p or ("v" in p) == ("w" in p):
            got = sorted(p) if isinstance(p, dict) else type(p).__name__
            raise ValueError(f"lin{l}: expected the leaves (v, g, b) or (w, b), got {got}")
        d_in = lay.h_true[l] + (lay.d0 if l == 0 or lay.skip[l] else 0)
        n = lay.n_true[l]
        names = ("v", "g", "b") if "v" in p else ("w", None, "b")
        leaves = []
        for name, shape in zip(names, ((d_in, n), (n,), (n,))):
            if name is None:
                leaves.append(None)
                continue
            t = p[name]
            if t.device == device and t.dtype == torch.float32:
                t = t.contiguous()
            _check(t, f"lin{l}.{name}", shape, device)
            leaves.append(t)
        out.append(tuple(leaves))
    return out


def explicit_value(x, params, cfg: UDFNetworkConfig):
    """K5's formulas in torch: udf [N] with every product's operands in
    bf16 and f32 sums, the biases and softplus100 in f32, and of the head
    its column 0 alone (K1's value at tier "default")."""
    lay = layout_for(cfg)
    W, B = lay.views(*pack(*effective_weights(params, cfg), lay))
    e, _, _ = _pe(x, lay)
    h = e
    for l in range(lay.n_layers - 1):
        inp = torch.cat([h, e], -1) if lay.skip[l] else (e if l == 0 else h)
        h = softplus100(_fwd_mm(inp, W[l], lay.alpha(l), "default") + B[l])
    raw = (_bf16(h) @ _bf16(W[-1][:, :1]))[:, 0] + B[-1][0]
    return _head(raw, lay)[0]


class _ValuePack:
    """K5's weight pack (``value_pack_kernel``) with its launch count."""

    def __init__(self):
        self.launches = 0

    def __call__(self, layers, lay: Layout) -> torch.Tensor:
        """The bf16 W^T slices, the head's column and the f32 biases of
        ``layers`` (``value_layers``) in one uint8 buffer."""
        dev = layers[0][0].device
        if dev.type != "cuda":
            raise ValueError(f"K5 launches on CUDA tensors only, got {dev}")
        lib = library()
        dims = (ctypes.c_int * (4 * lay.n_layers))(*lay.dims())
        n = lib.fd_value_pack_bytes(lay.n_layers, ctypes.addressof(dims), lay.pe_w, lay.multires)
        if n == 0:
            raise ValueError(f"K5 does not take this net: {lay}")
        n_true = (ctypes.c_int * lay.n_layers)(*lay.n_true)
        ptrs = [(ctypes.c_void_p * lay.n_layers)(*(t.data_ptr() if t is not None else None
                                                   for t in col)) for col in zip(*layers)]
        with torch.cuda.device(dev):
            packed = torch.empty(n, dtype=torch.uint8, device=dev)
            rc = lib.fd_value_pack(
                lay.n_layers, ctypes.addressof(dims), ctypes.addressof(n_true), lay.d0, lay.pe_w,
                lay.multires, *(ctypes.addressof(p) for p in ptrs), packed.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            self.launches += 1
        if rc != 0:
            raise RuntimeError(f"fd_value_pack failed: CUDA error {rc}")
        return packed


class _Value:
    """K5 (``value_kernel``) with its launch count: one a pass."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, packed: torch.Tensor, lay: Layout) -> torch.Tensor:
        """udf [N] at the points x [N, 3]; the kernel chooses its tile (64
        or 128 rows) from N."""
        if x.device.type != "cuda":
            raise ValueError(f"K5 launches on CUDA tensors only, got {x.device}")
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"x: expected [N, 3], got {tuple(x.shape)}")
        _check(x, "x", x.shape, x.device)
        dev, n = x.device, x.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=dev)
        if n == 0:
            return out
        dims = (ctypes.c_int * (4 * lay.n_layers))(*lay.dims())
        with torch.cuda.device(dev):
            rc = library().fd_value(
                x.data_ptr(), n, lay.n_layers, ctypes.addressof(dims), lay.pe_w, lay.multires,
                lay.scale, HEADS[lay.head], packed.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            self.launches += 1
        if rc != 0:
            raise RuntimeError(f"fd_value failed: CUDA error {rc}")
        return out


value_pack = _ValuePack()  # K5's pack, once a render
fused_value = _Value()  # K5


def sampling_distance_fn(params, cfg: UDFNetworkConfig):
    """pts [N, 3] -> udf [N]: the up-sampling's value-only distance queries
    of one render. Where ``value_kernel_takes``, K5, the weights packed at
    the first call and reused by every later one (a tree or points it cannot
    read raise ValueError); else the plain chain at the "sampling" policy
    (``fields.distance_value``)."""
    packed: List[torch.Tensor] = []

    def udf(pts: torch.Tensor) -> torch.Tensor:
        if value_kernel_takes(cfg, pts.device):
            lay = layout_for(cfg)
            if not packed:
                packed.append(value_pack(value_layers(params, cfg, pts.device), lay))
            count("op.fd_value")
            return fused_value(pts.contiguous(), packed[0], lay)
        if pts.is_cuda:
            count("fd_value.plain")
        return fields.distance_value(params, pts, cfg, role="sampling")[:, 0]

    return udf
