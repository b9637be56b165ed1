"""The port's warps against the JAX package's on the CPU: the zeros-padding
bilinear sampler (``ops/interp.py``), the pixel and patch warp positions and
colours (``render/projector.py``) and the per-view colour blending
(``nets/fields.py`` ``color_blend``), on the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraludf_tpu.nets import fields as jfields
from neuraludf_tpu.ops import interp as jinterp
from neuraludf_tpu.render import projector as jproj
from neuraludf_tpu_torch.nets import fields as tfields
from neuraludf_tpu_torch.ops import interp as tinterp
from neuraludf_tpu_torch.render import projector as tproj

H, W = 48, 56
# f32 on both sides. Positions are a few tens of pixels, so an ulp is ~4e-6 px
# and the projection chains a dozen products; colours of white-noise images
# follow the positions one to one.
TOL_POS = 2e-4  # pixels
TOL_COLOR = 2e-4
# a float position within this of a bound of its mask may fall on either side
BOUND_EPS = 1e-3


def make_cameras(n_views=4, seed=0, focal=35.0):
    """Cameras on an arc of radius 2 that look at the origin."""
    rng = np.random.RandomState(seed)
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = focal
    intr[0, 2], intr[1, 2] = W / 2, H / 2
    c2ws = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views * 0.15 + 0.1
        loc = np.array([2.0 * np.sin(ang), 0.15 * i, -2.0 * np.cos(ang)], np.float32)
        fwd = -loc / np.linalg.norm(loc)
        right = np.cross(np.array([0, 1, 0], np.float32), fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(fwd, right), fwd, loc
        c2ws.append(c2w)
    imgs = rng.rand(n_views, 3, H, W).astype(np.float32)
    return imgs, np.stack([intr] * n_views), np.stack(c2ws)


def both(fn_j, fn_t, *arrays):
    out_j = fn_j(*[jnp.asarray(a) for a in arrays])
    out_t = fn_t(*[torch.tensor(a) for a in arrays])
    return out_j, out_t


def test_build_patch_offset():
    for h in (1, 2, 5):
        np.testing.assert_array_equal(tproj.build_patch_offset(h), jproj.build_patch_offset(h))
    assert tproj.build_patch_offset(5).shape == (121, 2)


@pytest.mark.parametrize("channels_last", [True, False])
def test_interp_matches_jax(channels_last):
    rng = np.random.RandomState(1)
    img = rng.rand(3, H, W).astype(np.float32)
    # inside, on the borders, and outside (zeros padding), two leading axes
    grid = rng.uniform(-1.3, 1.3, (5, 9, 2)).astype(np.float32)
    grid[0, :4] = [[-1, -1], [1, 1], [1, -1], [0.999, 2.0]]
    out_j, out_t = both(lambda i, g: jinterp.grid_sample_2d(i, g, channels_last=channels_last),
                        lambda i, g: tinterp.grid_sample_2d(i, g, channels_last=channels_last),
                        img, grid)
    assert out_t.shape == ((5, 9, 3) if channels_last else (3, 5, 9))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
    xy_j, xy_t = both(
        lambda i, x, y: jinterp.grid_sample_2d_xy(i, x, y, channels_last=channels_last),
        lambda i, x, y: tinterp.grid_sample_2d_xy(i, x, y, channels_last=channels_last),
        img, grid[..., 0], grid[..., 1])
    np.testing.assert_allclose(xy_t.numpy(), np.asarray(xy_j), atol=1e-5)
    assert torch.equal(xy_t, out_t)
    assert float(np.abs(np.asarray(out_j)).min()) == 0.0  # some samples fell outside


def away_from(values, bounds):
    """True where a value is farther than BOUND_EPS from every bound."""
    return np.all([np.abs(values - b) > BOUND_EPS for b in bounds], axis=0)


def test_pixel_warp_matches_jax():
    imgs, intrinsics, c2ws = make_cameras()
    w2cs = np.linalg.inv(c2ws)
    pts = np.random.RandomState(2).uniform(-1.6, 1.6, (5, 7, 3)).astype(np.float32)
    pj, pt = jproj.PatchProjector(2), tproj.PatchProjector(2)

    (gx_j, gy_j, ok_j), (gx_t, gy_t, ok_t) = both(
        lambda p, k, w: pj.pixel_warp_positions(p, k, w, (H, W)),
        lambda p, k, w: pt.pixel_warp_positions(p, k, w, (H, W)), pts, intrinsics, w2cs)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), atol=TOL_POS)
    np.testing.assert_allclose(gy_t.numpy(), np.asarray(gy_j), atol=TOL_POS)
    firm = away_from(np.asarray(gx_j), (0.0, W - 1.0)) & away_from(np.asarray(gy_j), (0.0, H - 1.0))
    np.testing.assert_array_equal(ok_t.numpy()[firm], np.asarray(ok_j)[firm])
    assert 0 < np.asarray(ok_j).sum() < ok_j.size  # both sides of the frame are hit

    (col_j, m_j), (col_t, m_t) = both(pj.pixel_warp, pt.pixel_warp, pts, imgs, intrinsics, w2cs)
    assert col_t.shape == (5, 7, 4, 3) and m_t.shape == (5, 7, 4)
    firm = firm.transpose(1, 2, 0)
    np.testing.assert_array_equal(m_t.numpy()[firm], np.asarray(m_j)[firm])
    np.testing.assert_allclose(col_t.numpy()[firm], np.asarray(col_j)[firm], atol=TOL_COLOR)


def patch_inputs(seed=3, batch=6, samples=5):
    rng = np.random.RandomState(seed)
    imgs, intrinsics, c2ws = make_cameras(seed=seed)
    ref_c2w = np.eye(4, dtype=np.float32)
    ref_c2w[:3, 3] = [0, 0, -2.0]
    pts = rng.uniform(-0.4, 0.4, (batch, samples, 3)).astype(np.float32)
    normals = rng.randn(batch, samples, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    # a plane through the reference camera (d1 = 0: the sign rule and the
    # fronto-parallel fallback) and planes that face it
    to_cam = ref_c2w[:3, 3] - pts[0, 0]
    normals[0, 0] = np.cross(to_cam, [0.0, 1.0, 0.0]) / np.linalg.norm(
        np.cross(to_cam, [0.0, 1.0, 0.0]))
    normals[1] = [0.0, 0.0, -1.0]
    uv = rng.uniform(-0.5, 0.5, (batch, 2)).astype(np.float32)
    return imgs, intrinsics, c2ws, ref_c2w, pts, normals, uv


def test_patch_warp_matches_jax():
    imgs, intrinsics, c2ws, ref_c2w, pts, normals, uv = patch_inputs()
    h = 2
    pj, pt = jproj.PatchProjector(h), tproj.PatchProjector(h)

    (gx_j, gy_j, m_j), (gx_t, gy_t, m_t) = both(
        lambda p, u, n, k0, k, r, c: pj.patch_warp_positions(p, u, n, (H, W), k0, k, r, c,
                                                             detach_normal=True),
        lambda p, u, n, k0, k, r, c: pt.patch_warp_positions(p, u, n, (H, W), k0, k, r, c,
                                                             detach_normal=True),
        pts, uv, normals, intrinsics[0], intrinsics, ref_c2w, c2ws)
    assert gx_t.shape == (4, 6, 5, 25) and m_t.shape == (4, 6, 5, 25)
    gx_ref, gy_ref = np.asarray(gx_j), np.asarray(gy_j)
    # positions of degenerate planes reach 1e4 px and more: compare relative there
    np.testing.assert_allclose(gx_t.numpy(), gx_ref, atol=TOL_POS, rtol=1e-4)
    np.testing.assert_allclose(gy_t.numpy(), gy_ref, atol=TOL_POS, rtol=1e-4)
    firm = away_from(gx_ref, (h, W - h)) & away_from(gy_ref, (h, H - h))
    np.testing.assert_array_equal(m_t.numpy()[firm], np.asarray(m_j)[firm])
    assert 0 < np.asarray(m_j).sum() < m_j.size

    # both branches of the plane coefficient are taken: recompute valid_hom's
    # first condition for the plane through the camera
    R_ref = np.linalg.inv(ref_c2w)
    d1 = (normals @ R_ref[:3, :3].T * (pts @ R_ref[:3, :3].T + R_ref[:3, 3])).sum(-1)
    assert (np.abs(d1) <= pt.plane_dist_thresh).any() and (np.abs(d1) > 0.01).any()

    (col_j, cm_j), (col_t, cm_t) = both(
        lambda p, u, n, i, k0, k, r, c: pj.patch_warp(p, u, n, i, k0, k, r, c, detach_normal=True),
        lambda p, u, n, i, k0, k, r, c: pt.patch_warp(p, u, n, i, k0, k, r, c, detach_normal=True),
        pts, uv, normals, imgs, intrinsics[0], intrinsics, ref_c2w, c2ws)
    assert col_t.shape == (6, 5, 4, 3, 25) and cm_t.shape == (6, 5, 4, 25)
    np.testing.assert_array_equal(cm_t.numpy(), m_t.permute(1, 2, 0, 3).numpy())
    # colours where the position is in the frame and well conditioned
    ok = (np.asarray(cm_j) & firm.transpose(1, 2, 0, 3))[:, :, :, None, :]
    ok = np.broadcast_to(ok, col_t.shape)
    np.testing.assert_allclose(col_t.numpy()[ok], np.asarray(col_j)[ok], atol=TOL_COLOR)
    assert bool(torch.isfinite(col_t).all())


@pytest.mark.parametrize("with_index", [False, True])
def test_color_blend_matches_jax(with_index):
    rng = np.random.RandomState(4)
    b, s, v, npx, n_cand = 3, 4, 3, 9, 6
    logits = rng.randn(b, s, n_cand).astype(np.float32)
    pix_c = rng.rand(b, s, v, 3).astype(np.float32)
    pix_m = rng.rand(b, s, v) > 0.3
    pix_m[0, 0] = False  # no view sees this sample
    patch_c = rng.rand(b, s, v, 3, npx).astype(np.float32)
    patch_m = rng.rand(b, s, v, npx) > 0.05
    patch_m[1, 1] = True
    idx = np.array([4, 0, 2], np.int32) if with_index else None
    out_j = jfields.color_blend(jnp.asarray(logits), None if idx is None else jnp.asarray(idx),
                                jnp.asarray(pix_c), jnp.asarray(pix_m), jnp.asarray(patch_c),
                                jnp.asarray(patch_m))
    out_t = tfields.color_blend(torch.tensor(logits), None if idx is None else torch.tensor(idx),
                                torch.tensor(pix_c), torch.tensor(pix_m), torch.tensor(patch_c),
                                torch.tensor(patch_m))
    for a, b_ in zip(out_t, out_j):
        assert tuple(a.shape) == tuple(b_.shape)
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=1e-6)
    # one kind at a time
    only_pix = tfields.color_blend(torch.tensor(logits), None, torch.tensor(pix_c),
                                   torch.tensor(pix_m))
    assert only_pix[2] is None and only_pix[3] is None and only_pix[0].shape == (b, s, 3)
    only_patch = tfields.color_blend(torch.tensor(logits), None, pts_patch_color=torch.tensor(
        patch_c), pts_patch_mask=torch.tensor(patch_m))
    assert only_patch[0] is None and only_patch[2].shape == (b, s, 3, npx)
