"""The port's warp sampler (``ops/strip_sample.py``, the plain version of
kernel K3) against the JAX package's ``strip_sample_reference`` (exact f32
gathers), its Pallas kernel in interpret mode, and ``F.grid_sample`` with
border padding. On the CPU ``strip_sample`` takes the plain version; the
CUDA kernel itself is held against it on the card by ``chip_smoke.py``.

Images are one strip exactly (64 x 256), so the TPU kernel has no escapes
and its mask is the in-image mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neuraludf_tpu.ops import strip_sample as jss
from neuraludf_tpu_torch.ops import strip_sample as tss

H, W = 64, 256

# Plain version against strip_sample_reference: both are f32 bilinear
# gathers, but the reference goes through normalised coordinates
# (2x/(W-1) - 1 and back), which moves a position by up to ~3e-5 px at
# x ~ 255; on smooth images (slope <= 0.02 per pixel, like a rendered
# photograph) that is under 1e-6 in colour. On white-noise images (slope up
# to 1 per pixel) the same shift shows in full: 5e-5.
TOL_REFERENCE = {"smooth": 1e-6, "noise": 5e-5}
# against the Pallas kernel, which rounds images and column weights to bf16:
# the bound the JAX package's own test holds it to
TOL_PALLAS = 5e-3
# against F.grid_sample(border): it also normalises and un-normalises
TOL_LIBRARY = 5e-5


def make_images(kind, v, seed):
    rng = np.random.RandomState(seed)
    if kind == "noise":
        return rng.rand(v, 3, H, W).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi, (v, 3, 1, 1))
    freq = rng.uniform(0.01, 0.03, (v, 3, 1, 1))
    return (0.5 + 0.25 * np.sin(freq * xx + phase) + 0.2 * np.cos(freq * yy - phase)
            ).astype(np.float32)


def clustered_positions(v, nw, p, seed):
    """Clusters that fit the one strip, like the warp positions of one ray."""
    rng = np.random.RandomState(seed)
    cx = rng.uniform(30.0, W - 30.0, (v, nw, 1))
    cy = rng.uniform(10.0, H - 10.0, (v, nw, 1))
    gx = cx + rng.uniform(-25.0, 25.0, (v, nw, p))
    gy = cy + rng.uniform(-9.0, 9.0, (v, nw, p))
    return gx.astype(np.float32), gy.astype(np.float32)


def library_sample(images, gx, gy):
    """The one PyTorch call that computes the same function."""
    v, _, h, w = images.shape
    grid = torch.stack([2.0 * gx / (w - 1) - 1.0, 2.0 * gy / (h - 1) - 1.0], dim=-1)
    out = F.grid_sample(images, grid, mode="bilinear", padding_mode="border",
                        align_corners=True)  # [V, 3, NW, P]
    return out.permute(0, 2, 1, 3)


# P and NW that are not multiples of the TPU tiles (128 lanes, 16 strips)
@pytest.mark.parametrize("kind,v,nw,p", [("smooth", 2, 6, 128), ("smooth", 3, 5, 52),
                                         ("noise", 2, 7, 130), ("noise", 1, 16, 26)])
def test_plain_matches_jax_reference_and_library(kind, v, nw, p):
    imgs = make_images(kind, v, 0)
    gx, gy = clustered_positions(v, nw, p, 1)
    # a few positions off the image and on its borders
    gx[0, 0, :4] = [-3.0, 0.0, W - 1.0, W + 2.5]
    gy[0, 0, 4:8] = [-0.5, 0.0, H - 1.0, H + 7.0]
    # the reference reads channels 0-2 of a 4-channel image; handed f32 here
    # (prepare_images would round to bf16 for the TPU kernel)
    imgs4 = jnp.pad(jnp.asarray(imgs), ((0, 0), (0, 1), (0, 0), (0, 0)))
    ref, ref_mask = jss.strip_sample_reference(imgs4, jnp.asarray(gx), jnp.asarray(gy))
    out, mask = tss.strip_sample_plain(*map(torch.tensor, (imgs, gx, gy)))
    assert out.shape == (v, nw, 3, p) and out.dtype == torch.float32
    assert mask.shape == (v, nw, p) and mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert not mask[0, 0, 0] and mask[0, 0, 1] and mask[0, 0, 2] and not mask[0, 0, 3]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL_REFERENCE[kind])
    lib = library_sample(*map(torch.tensor, (imgs, gx, gy)))
    np.testing.assert_allclose(out.numpy(), lib.numpy(), rtol=0, atol=TOL_LIBRARY)


def test_plain_matches_pallas_kernel_in_interpret_mode():
    v, nw, p = 2, 6, 128
    imgs = make_images("noise", v, 2)
    gx, gy = clustered_positions(v, nw, p, 3)
    imgs4 = jss.prepare_images(jnp.asarray(imgs))
    ker, in_strip = jss.strip_sample(imgs4, jnp.asarray(gx), jnp.asarray(gy), interpret=True)
    out, mask = tss.strip_sample(*map(torch.tensor, (imgs, gx, gy)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(in_strip))
    assert bool(mask.all())
    np.testing.assert_allclose(out.numpy(), np.asarray(ker), rtol=0, atol=TOL_PALLAS)


def test_border_huge_and_nan_positions():
    imgs = torch.tensor(make_images("noise", 1, 4))
    nan = float("nan")
    gx = torch.tensor([[[0.0, W - 1.0, W - 1.0, 17.25, 1e11, -1e11, nan, 5.0, W - 1.0 + 1e-3]]])
    gy = torch.tensor([[[0.0, H - 1.0, 3.5, H - 1.0, 10.0, -1e11, 4.0, nan, 2.0]]])
    out, mask = tss.strip_sample(imgs, gx, gy)
    assert mask[0, 0].tolist() == [True, True, True, True, False, False, False, False, False]
    assert bool(torch.isfinite(out).all())
    im = imgs[0]
    # exact texels at the corners; the last column and row are read, never column W or row H
    torch.testing.assert_close(out[0, 0, :, 0], im[:, 0, 0])
    torch.testing.assert_close(out[0, 0, :, 1], im[:, H - 1, W - 1])
    torch.testing.assert_close(out[0, 0, :, 2], 0.5 * (im[:, 3, W - 1] + im[:, 4, W - 1]))
    torch.testing.assert_close(out[0, 0, :, 3],
                               0.75 * im[:, H - 1, 17] + 0.25 * im[:, H - 1, 18])
    # huge positions clamp to the border; a NaN coordinate samples as 0
    torch.testing.assert_close(out[0, 0, :, 4], im[:, 10, W - 1])
    torch.testing.assert_close(out[0, 0, :, 5], im[:, 0, 0])
    torch.testing.assert_close(out[0, 0, :, 6], im[:, 4, 0])
    torch.testing.assert_close(out[0, 0, :, 7], im[:, 0, 5])
    # where the mask is true the library call agrees, borders included
    lib = library_sample(imgs, gx, gy)
    m = mask[:, :, None, :].expand_as(out)
    np.testing.assert_allclose(out[m].numpy(), lib[m].numpy(), rtol=0, atol=TOL_LIBRARY)


def test_wrapper_on_cpu_counts_no_launch_and_checks_its_inputs():
    imgs = torch.tensor(make_images("smooth", 2, 5))
    gx, gy = map(torch.tensor, clustered_positions(2, 3, 10, 6))
    before = tss.strip_sample.launches
    out, mask = tss.strip_sample(imgs, gx, gy)
    assert tss.strip_sample.launches == before  # a CPU tensor launches no kernel
    ref, ref_mask = tss.strip_sample_plain(imgs, gx, gy)
    assert torch.equal(out, ref) and torch.equal(mask, ref_mask)
    # the channel-first view of a channel-last tensor samples alike
    out_cl, _ = tss.strip_sample(imgs.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2), gx, gy)
    assert torch.equal(out_cl, out)
    # positions carry no gradient
    g = gx.clone().requires_grad_(True)
    assert not tss.strip_sample(imgs, g, gy)[0].requires_grad
    with pytest.raises(ValueError, match="images"):
        tss.strip_sample(imgs[:, :2], gx, gy)
    with pytest.raises(ValueError, match="gx, gy"):
        tss.strip_sample(imgs, gx[:1], gy[:1])
    with pytest.raises(ValueError, match="float32"):
        tss.strip_sample(imgs, gx.double(), gy)
