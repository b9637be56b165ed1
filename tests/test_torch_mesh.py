"""The port's mesh extraction (``neuraludf_tpu_torch/mesh``) against
``neuraludf_tpu.mesh`` on the CPU, at small resolutions and narrow nets.

Parameters come from the JAX initialisers and are converted with
``convert.py``; grids are numpy draws from a seed. Tolerances, per test:

* engines: the same grid through both libraries gives bit-identical meshes
  (the same sources, built with the same g++ flags);
* grids: atol 1e-5 on values, 1e-4 on normals (f32 on both sides, matmuls
  summed in another order); band masks equal except within 1e-6 of 2·voxel;
* meshes: geometry, not enumeration (a value that differs by an ulp can
  reorder the sign-vote BFS): face counts within 3%, mean nearest-vertex
  distance below voxel/100, maximum below voxel;
* ``differentiable_vertices``: values atol 1e-5, gradients 1e-4 of each
  leaf's largest entry;
* ``process.*`` and PLY bytes: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.mesh import grid as jgrid
from neuraludf_tpu.mesh import mc as jmc
from neuraludf_tpu.mesh import meshudf as jmeshudf
from neuraludf_tpu.mesh import ply as jply
from neuraludf_tpu.mesh import process as jprocess
from neuraludf_tpu.nets import fields as jfields
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.mesh import build as tbuild
from neuraludf_tpu_torch.mesh import grid as tgrid
from neuraludf_tpu_torch.mesh import mc as tmc
from neuraludf_tpu_torch.mesh import meshudf as tmeshudf
from neuraludf_tpu_torch.mesh import ply as tply
from neuraludf_tpu_torch.mesh import process as tprocess

ATOL_VALUE, ATOL_NORMAL = 1e-5, 1e-4

NETS = {
    "plain": dict(d_out=17, d_hidden=16, n_layers=3, skip_in=(), multires=2),
    "skip": dict(d_out=17, d_hidden=24, n_layers=4, skip_in=(2,), multires=3),
    "sdf": dict(d_out=17, d_hidden=16, n_layers=3, skip_in=(), multires=2, udf_type="sdf",
                inside_outside=True),
}


def nets(name, seed=0):
    """(JAX cfg, port cfg, JAX params {"udf"}, port params {"udf"})."""
    jc, tc = jconfig.UDFNetworkConfig(**NETS[name]), tconfig.UDFNetworkConfig(**NETS[name])
    pj = {"udf": jfields.init_distance_field(jax.random.PRNGKey(seed), jc)}
    return jc, tc, pj, {"udf": convert.params_from_jax(to_np(pj["udf"]))}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def seeded_grid(n=40, seed=0):
    """The UDF of a sphere of radius 0.5 with seeded noise, and the negated
    normalized gradients of the noise-free field, also with noise."""
    rng = np.random.RandomState(seed)
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    r = np.linalg.norm(g, axis=-1)
    udf = np.abs(r - 0.5) + 0.003 * rng.rand(n, n, n)
    grads = -np.sign(r - 0.5)[..., None] * g / np.maximum(r[..., None], 1e-9)
    grads = grads + 0.05 * rng.randn(n, n, n, 3)
    grads /= np.linalg.norm(grads, axis=-1, keepdims=True)
    return udf.astype(np.float32), grads.astype(np.float32), r.astype(np.float32) - 0.5


def geometry_close(va, fa, vb, fb, voxel):
    assert len(fa) > 100 and abs(len(fa) - len(fb)) <= 0.03 * len(fb), (len(fa), len(fb))
    for x, y in ((va, vb), (vb, va)):
        d = cKDTree(y).query(x, k=1)[0]
        assert d.mean() < voxel / 100 and d.max() < voxel, (d.mean(), d.max())


# --------------------------------------------------------------------------
# the C++ engine
# --------------------------------------------------------------------------

def test_engine_is_built_into_build_dir():
    lib = tbuild.ensure_built()
    assert lib.parent.name == "mesh" and lib.parent.parent.name == "build"
    assert lib.name.startswith("libudf_mc_") and lib.suffix == ".so"
    for name in tbuild.SOURCES + tbuild.HEADERS:  # a copy of the JAX package's sources
        assert (tbuild.CSRC / name).read_bytes() == (
            tbuild.Path(jmc.__file__).parent / "csrc" / name).read_bytes()


@pytest.mark.parametrize("algorithm", ["tets", "lewiner"])
def test_engines_bit_identical(algorithm):
    udf, grads, sdf = seeded_grid()
    voxel = 2.0 / 39
    vj, fj = jmc.marching_cubes_udf(udf, grads, voxel, algorithm=algorithm)
    vt, ft = tmc.marching_cubes_udf(udf, grads, voxel, algorithm=algorithm)
    assert len(fj) > 1000
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    cj = jmc.marching_cubes_classic(sdf, 0.01, algorithm=algorithm)
    ct = tmc.marching_cubes_classic(sdf, 0.01, algorithm=algorithm)
    assert len(cj[1]) > 1000
    np.testing.assert_array_equal(ct[0], cj[0])
    np.testing.assert_array_equal(ct[1], cj[1])


def test_engine_rejects_bad_input():
    udf, grads, _ = seeded_grid(8)
    with pytest.raises(ValueError, match="algorithm"):
        tmc.marching_cubes_udf(udf, grads, 0.1, algorithm="mc33")
    with pytest.raises(ValueError, match="grads"):
        tmc.marching_cubes_udf(udf, grads[:-1], 0.1)
    with pytest.raises(ValueError, match="3-D"):
        tmc.marching_cubes_classic(udf[0], 0.0)


# --------------------------------------------------------------------------
# grids
# --------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["plain", "skip", "sdf"])
def test_grids_match_jax(net):
    jc, tc, pj, pt = nets(net, seed=1)
    signed = net == "sdf"
    bmin, bmax = np.array([-0.9, -1.0, -0.8], np.float32), np.array([1.0, 0.7, 0.9], np.float32)
    for s in sorted({False, signed}):
        np.testing.assert_allclose(tgrid.extract_fields(pt, tc, bmin, bmax, 23, signed=s),
                                   jgrid.extract_fields(pj, jc, bmin, bmax, 23, signed=s),
                                   atol=ATOL_VALUE, rtol=0)
    np.testing.assert_allclose(tgrid.extract_gradient_fields(pt, tc, bmin, bmax, 17),
                               jgrid.extract_gradient_fields(pj, jc, bmin, bmax, 17),
                               atol=ATOL_NORMAL, rtol=0)
    pts = np.random.RandomState(2).uniform(-1, 1, (1000, 3)).astype(np.float32)
    np.testing.assert_allclose(tgrid.query_udf_at(pt, tc, pts, signed),
                               jgrid.query_udf_at(pj, jc, pts, signed), atol=ATOL_VALUE, rtol=0)

    N = 48
    ut, nt = tgrid.udf_and_normals_grid(pt, tc, N, signed)
    uj, nj = jgrid.udf_and_normals_grid(pj, jc, N, signed)
    np.testing.assert_allclose(ut, uj, atol=ATOL_VALUE, rtol=0)
    band_t, band_j = np.any(nt != 0, -1), np.any(nj != 0, -1)
    assert band_j.sum() > 1000
    at_edge = np.abs(uj - 2 * (2.0 / (N - 1))) < 1e-6
    assert np.array_equal(band_t | at_edge, band_j | at_edge)
    both = band_t & band_j
    np.testing.assert_allclose(nt[both], nj[both], atol=ATOL_NORMAL, rtol=0)
    assert ut.shape == (N, N, N) and nt.shape == (N, N, N, 3)


def test_grid_chunks_cover_every_point(monkeypatch):
    """A fill spread over several chunks, the last one partial, gives the
    fill of one chunk (to 1e-6: the CPU's matmul blocks by row count)."""
    _, tc, _, pt = nets("plain")
    whole = tgrid.udf_and_normals_grid(pt, tc, 21)
    monkeypatch.setattr(tgrid, "CHUNK", 1000)
    parts = tgrid.udf_and_normals_grid(pt, tc, 21)
    for a, b in zip(parts, whole):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert np.array_equal(np.any(parts[1] != 0, -1), np.any(whole[1] != 0, -1))


# --------------------------------------------------------------------------
# MeshUDF
# --------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["tets", "lewiner"])
@pytest.mark.parametrize("refine", [True, False])
def test_get_mesh_udf_matches_jax(algorithm, refine):
    jc, tc, pj, pt = nets("plain")
    res = 40
    vj, fj = jmeshudf.get_mesh_udf(pj, jc, resolution=res, refine=refine, algorithm=algorithm)
    timings = {}
    vt, ft = tmeshudf.get_mesh_udf(pt, tc, resolution=res, refine=refine, algorithm=algorithm,
                                   timings=timings)
    assert vt.dtype == np.float32 and ft.dtype == np.int32
    assert set(timings) == {"grid", "mc", "filter", "cleanup", "smooth", "refine"}
    geometry_close(vt, ft, vj, fj, 2.0 / (res - 1))


def test_get_mesh_udf_signed_matches_jax():
    jc, tc, pj, pt = nets("sdf")
    vj, fj = jmeshudf.get_mesh_udf(pj, jc, resolution=40, signed=True)
    vt, ft = tmeshudf.get_mesh_udf(pt, tc, resolution=40, signed=True)
    geometry_close(vt, ft, vj, fj, 2.0 / 39)


def test_incremental_extraction_matches_full():
    """The port's incremental extraction against its own full fill: the
    same surface on an unchanged field, and close to it after a 1e-3 drift
    of every parameter. The cache carries over from call to call."""
    _, tc, _, pt = nets("plain")
    res = 40
    voxel = 2.0 / (res - 1)
    cache = {}
    v0, f0 = tmeshudf.get_mesh_udf(pt, tc, resolution=res, cache=cache)
    assert cache["incr_count"] == 0 and cache["indices"] is not None
    v1, f1 = tmeshudf.get_mesh_udf(pt, tc, resolution=res, cache=cache)
    assert cache["incr_count"] == 1 and cache["udf"].size == res ** 3
    geometry_close(v1, f1, v0, f0, voxel)

    gen = torch.Generator().manual_seed(1)
    drift = {"udf": {k: {n: t.detach() + 1e-3 * torch.randn(t.shape, generator=gen)
                         for n, t in d.items()} for k, d in pt["udf"].items()}}
    vi, fi = tmeshudf.get_mesh_udf(drift, tc, resolution=res, cache=cache)
    assert cache["incr_count"] == 2  # the third call is incremental too
    vf, ff = tmeshudf.get_mesh_udf(drift, tc, resolution=res)
    d = cKDTree(vf).query(vi, k=1)[0]
    assert d.mean() < voxel / 4, float(d.mean())


def test_incremental_refill_guards():
    _, tc, _, pt = nets("plain")
    N = 24
    udf, nrm, cache = tgrid.udf_and_normals_grid_incremental(pt, tc, N)
    full_udf, full_nrm = tgrid.udf_and_normals_grid(pt, tc, N)
    np.testing.assert_array_equal(udf, full_udf)
    np.testing.assert_array_equal(nrm, full_nrm)
    band = np.flatnonzero(np.any(full_nrm != 0, -1))
    cache["indices"] = band
    _, nrm1, c1 = tgrid.udf_and_normals_grid_incremental(pt, tc, N, cache)
    assert c1 is cache and cache["incr_count"] == 1
    np.testing.assert_allclose(nrm1, full_nrm, atol=1e-6, rtol=0)
    # every call a refill
    _, _, c2 = tgrid.udf_and_normals_grid_incremental(pt, tc, N, cache, full_refill_every=1)
    assert c2 is not cache and c2["incr_count"] == 0
    # a field that moved by more than the band covers is filled again
    cache["udf"][band] += 1.0
    _, _, c3 = tgrid.udf_and_normals_grid_incremental(pt, tc, N, cache)
    assert c3 is not cache and c3["incr_count"] == 0


def open_mesh(pj, jc):
    """A closed MeshUDF mesh of the JAX field with its top cut off."""
    verts, faces = jmeshudf.get_mesh_udf(pj, jc, resolution=32, refine=False)
    faces = faces[verts[faces].mean(axis=1)[:, 2] < 0.2]
    return jprocess.remove_unreferenced(verts, faces)


@pytest.mark.parametrize("border_gradients", [False, True])
def test_differentiable_vertices_match_jax(border_gradients):
    jc, tc, pj, pt = nets("plain")
    verts, faces = open_mesh(pj, jc)
    assert len(jprocess.boundary_edges(faces)) > 10

    def mean_y(p):
        nv = jmeshudf.differentiable_vertices(p["udf"], jc, verts, faces,
                                              border_gradients=border_gradients)
        return jnp.mean(nv[:, 1]), nv

    (val_j, nv_j), grads_j = jax.value_and_grad(mean_y, has_aux=True)(pj)
    nv_t = tmeshudf.differentiable_vertices(pt["udf"], tc, verts, faces,
                                            border_gradients=border_gradients)
    val_t = nv_t[:, 1].mean()
    val_t.backward()
    np.testing.assert_allclose(nv_t.detach().numpy(), np.asarray(nv_j), atol=ATOL_VALUE, rtol=0)
    assert float(val_t.detach()) == pytest.approx(float(val_j), abs=ATOL_VALUE)
    for layer, leaves in to_np(grads_j["udf"]).items():
        for name, gj in leaves.items():
            gt = pt["udf"][layer][name].grad.numpy()
            assert np.abs(gj).max() > 0
            np.testing.assert_allclose(gt, gj, atol=1e-4 * np.abs(gj).max(), rtol=0,
                                       err_msg=f"{layer}/{name}")


def test_border_term_routes_gradient_only():
    """The border term is zero in value and changes the gradient."""
    jc, tc, pj, pt = nets("plain")
    verts, faces = open_mesh(pj, jc)
    grads = []
    for border in (False, True):
        p = convert.params_from_jax(to_np(pj["udf"]))
        nv = tmeshudf.differentiable_vertices(p, tc, verts, faces, border_gradients=border)
        nv[:, 1].mean().backward()
        grads.append((nv.detach(), p["lin0"]["v"].grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=0, rtol=0)
    assert not torch.allclose(grads[0][1], grads[1][1])


def test_next_update_indices_matches_jax():
    verts = np.random.RandomState(3).uniform(-1.1, 1.1, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmeshudf.next_update_indices(verts, 33),
                                  jmeshudf.next_update_indices(verts, 33))


# --------------------------------------------------------------------------
# host processing and PLY
# --------------------------------------------------------------------------

def random_mesh(seed=0):
    """Vertices on a coarse lattice (so some coincide) and faces with
    repeated indices, zero areas, duplicates and open borders."""
    rng = np.random.RandomState(seed)
    verts = (rng.randint(0, 6, (300, 3)) / 5.0).astype(np.float32)
    faces = rng.randint(0, 300, (600, 3)).astype(np.int32)
    faces[:20, 1] = faces[:20, 0]
    faces[20:40] = faces[40:60][:, ::-1]
    return verts, faces


def closed_mesh():
    udf, grads, _ = seeded_grid(24)
    verts, faces = tmc.marching_cubes_udf(udf, grads, 2.0 / 23)
    return verts * (2.0 / 23) - 1.0, faces


PROCESS_CASES = {
    "merge_duplicate_vertices": lambda m, v, f: m.merge_duplicate_vertices(v, f),
    "remove_bad_faces": lambda m, v, f: m.remove_bad_faces(v, f),
    "remove_unreferenced": lambda m, v, f: m.remove_unreferenced(v, f),
    "boundary_edges": lambda m, v, f: m.boundary_edges(f),
    "fill_single_triangle_holes": lambda m, v, f: m.fill_single_triangle_holes(v, f),
    "process_until_stable": lambda m, v, f: m.process_until_stable(v, f),
    "smooth_borders": lambda m, v, f: m.smooth_borders(v, f),
    "vertex_normals": lambda m, v, f: m.vertex_normals(v, f),
}


@pytest.mark.parametrize("name", sorted(PROCESS_CASES))
def test_process_matches_jax(name):
    fn = PROCESS_CASES[name]
    for verts, faces in (random_mesh(), closed_mesh()):
        out_t, out_j = fn(tprocess, verts, faces), fn(jprocess, verts, faces)
        out_t = out_t if isinstance(out_t, tuple) else (out_t,)
        out_j = out_j if isinstance(out_j, tuple) else (out_j,)
        for a, b in zip(out_t, out_j):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_export_ply_bytes_match_jax(tmp_path):
    verts, faces = closed_mesh()
    pt, pj = tmp_path / "t.ply", tmp_path / "j.ply"
    tply.export_ply(str(pt), verts, faces)
    jply.export_ply(str(pj), verts, faces)
    assert pt.read_bytes() == pj.read_bytes()
    v, f = tply.load_ply(str(pt))
    np.testing.assert_array_equal(v, verts.astype(np.float32))
    np.testing.assert_array_equal(f, faces)
