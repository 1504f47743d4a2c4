"""The port's clustering slice and native codec against the JAX package, on
the CPU: k-means (``cluster/kmeans.py``), region growing
(``cluster/region_growing.py``), both CLIs, and the ctypes bindings of
``native/gsplat_native.cpp`` (``io/native.py``). The same numpy arrays,
made from a seed, go to both packages; each test states its tolerance.
"""

import numpy as np
import pytest
import torch

from gsplat_tpu.cli import kmeans as jkmeans_cli
from gsplat_tpu.cli import region_growing as jrg_cli
from gsplat_tpu.cluster import kmeans as jkm
from gsplat_tpu.cluster import region_growing as jrg
from gsplat_tpu.io import native as jnative
from gsplat_tpu.io import ply as jply
from gsplat_tpu.io import splat_format as jsplat
from gsplat_tpu.io import synthetic as jsynthetic
from gsplat_tpu.scene import GaussianScene as JScene
from gsplat_tpu.scene import color_to_dc
from gsplat_tpu_torch.cli import kmeans as tkmeans_cli
from gsplat_tpu_torch.cli import region_growing as trg_cli
from gsplat_tpu_torch.cluster import kmeans as tkm
from gsplat_tpu_torch.cluster import region_growing as trg
from gsplat_tpu_torch.io import native as tnative
from gsplat_tpu_torch.io import ply as tply
from gsplat_tpu_torch.io import splat_format as tsplat
from gsplat_tpu_torch.scene import FIELDS, scene_from_numpy

torch.set_num_threads(2)

CPU = "cpu"


def _port(jscene):
    s = jscene.to_numpy()
    return scene_from_numpy(**{f: np.asarray(getattr(s, f)) for f in FIELDS},
                            device=CPU)


def _blobs(seps=3.0, n_per=60, k=4, seed=0):
    """tests/test_cluster.py's blob scene."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, 3)) * seps
    means = np.concatenate(
        [c + 0.1 * rng.normal(size=(n_per, 3)) for c in centers])
    n = means.shape[0]
    quats = np.zeros((n, 4))
    quats[:, 0] = 1
    return JScene.create(
        means, np.full((n, 3), -3.0), quats, np.full(n, 2.0),
        color_to_dc(rng.uniform(size=(n, 3)))[:, None, :]), k


def _two_spheres():
    """tests/test_cluster.py::test_region_growing_separates_two_spheres'
    scene."""
    a = jsynthetic.sphere_scene(250, radius=1.0, seed=11, scale=0.01)
    b = jsynthetic.sphere_scene(250, radius=1.0, seed=12, scale=0.01)
    means = np.concatenate([a.to_numpy().means,
                            b.to_numpy().means + np.array([5.0, 0, 0])])
    n = means.shape[0]
    quats = np.zeros((n, 4))
    quats[:, 0] = 1
    return JScene.create(means, np.full((n, 3), -4.0), quats,
                         np.full(n, 2.0), np.zeros((n, 1, 3)))


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------


def _assert_kmeans_equal(t, j):
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=0, atol=1e-5)
    assert t.iterations == int(j.iterations)
    assert abs(t.shift - float(j.shift)) <= 1e-5 * max(1.0, float(j.shift))


@pytest.mark.parametrize("case", ["blobs xyz, init", "blobs color, seed 3",
                                  "random color, seed 0"])
def test_kmeans_matches_jax(case):
    if case.startswith("random"):
        js, k = jsynthetic.random_scene(500, seed=5), 6
    else:
        js, k = _blobs(seed=1)
    color = "color" in case
    jf = jkm.scene_features(js, with_color=color)
    tf = tkm.scene_features(_port(js), with_color=color)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    kw = dict(max_iter=50 if "init" in case else 10,
              seed=3 if "seed 3" in case else 0)
    if "init" in case:
        kw["init_centroids"] = np.asarray(jf)[[0, 60, 120, 180]]
    _assert_kmeans_equal(tkm.kmeans(tf, k, **kw), jkm.kmeans(jf, k, **kw))


def test_kmeans_empty_cluster_keeps_its_centroid():
    feats = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    init = np.vstack([feats[:2], np.full((1, 3), 100.0, np.float32)])
    t = tkm.kmeans(torch.from_numpy(feats), 3, max_iter=5,
                   init_centroids=init)
    j = jkm.kmeans(feats, 3, max_iter=5, init_centroids=init)
    _assert_kmeans_equal(t, j)
    assert (t.centroids[2] == 100.0).all()


def test_cluster_scene_and_recolor_match_jax():
    js = jsynthetic.random_scene(300, seed=8, num_labels=4)
    for recolor in (True, False):
        jout, _ = jkm.cluster_scene(js, k=5, recolor=recolor)
        tout, _ = tkm.cluster_scene(_port(js), k=5, recolor=recolor)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                          np.asarray(getattr(jout, f)), f)


def test_kmeans_refuses_a_mesh():
    # a mesh that is not a parallel.mesh.Mesh (the sharded k-means itself
    # is held against the unsharded one in tests/test_torch_parallel.py)
    with pytest.raises(TypeError, match="Mesh"):
        tkm.kmeans(torch.zeros(10, 3), 2, mesh=object())


def test_full_precision_products_are_checked(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tkm.check_f32_matmul(torch.device("cuda"))
    tkm.check_f32_matmul(torch.device("cpu"))


# ---------------------------------------------------------------------------
# region growing
# ---------------------------------------------------------------------------


def test_region_growing_geometry_matches_jax():
    js = _two_spheres()
    pts = js.to_numpy().means
    tp = torch.from_numpy(np.asarray(pts, np.float32))
    jn = np.asarray(jrg.knn_indices(pts, 20))
    tn = trg.knn_indices(tp, 20)
    assert tn.dtype == torch.int32
    # the same neighbours in the same order (no ties on these points)
    np.testing.assert_array_equal(tn.numpy(), jn)
    jnorm, jres = jrg.pca_normals(pts, jn, 20)
    tnorm, tres = trg.pca_normals(tp, tn, 20)
    jnorm = np.asarray(jnorm)
    # up to the sign rule: where n . (p - centroid) ~ 0 the flip is free
    side = np.abs(np.sum(jnorm * (pts - pts.mean(0)), axis=1))
    sure = side > 1e-3
    assert sure.mean() > 0.95
    np.testing.assert_allclose(tnorm.numpy()[sure], jnorm[sure], atol=1e-4)
    dots = np.abs(np.sum(tnorm.numpy() * jnorm, axis=1))
    assert np.abs(dots - 1).max() <= 1e-4
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres), atol=1e-5)


def test_segment_scene_matches_jax():
    js = _two_spheres()
    kw = dict(normals_k=20, neighbors_k=8, residual_threshold=0.2,
              angle_threshold=0.6, seed=4)
    jout, jgeo = jrg.segment_scene(js, **kw)
    tout, tgeo = trg.segment_scene(_port(js), **kw)
    labels = tout.labels.numpy()
    np.testing.assert_array_equal(labels, np.asarray(jout.labels))
    np.testing.assert_array_equal(
        trg.grow_regions(tgeo, residual_threshold=0.2, angle_threshold=0.6),
        jrg.grow_regions(jgeo, residual_threshold=0.2, angle_threshold=0.6))
    assert not set(labels[:250]) & set(labels[250:])
    np.testing.assert_array_equal(tout.sh.numpy(), np.asarray(jout.sh))


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _cli_pair(tmp_path, jmain, tmain, extra, capsys):
    scene = jsynthetic.random_scene(400, seed=6, num_labels=3)
    src = str(tmp_path / "in.ply")
    jply.scene_to_ply(src, scene)
    args = ["--file_path", src] + extra
    assert jmain(args + ["--save_path", str(tmp_path / "jax.ply")]) == 0
    jax_out = capsys.readouterr().out
    assert tmain(args + ["--save_path", str(tmp_path / "port.ply"),
                         "--device", CPU]) == 0
    port_out = capsys.readouterr().out
    strip = lambda out: [l for l in out.splitlines()
                         if not l.startswith("wrote")]
    assert strip(port_out) == strip(jax_out)
    return (jply.read_ply(str(tmp_path / "jax.ply"))["vertex"],
            tply.read_ply(str(tmp_path / "port.ply"))["vertex"])


@pytest.mark.parametrize("extra", [[], ["--binary", "--no_color_features",
                                        "--k", "4"]])
def test_kmeans_cli_matches_jax(tmp_path, capsys, extra):
    want, got = _cli_pair(tmp_path, jkmeans_cli.main, tkmeans_cli.main,
                          extra, capsys)
    assert "label" in got.dtype.names and (got["label"] >= 0).all()
    for f in want.dtype.names:
        np.testing.assert_array_equal(got[f], want[f], f)


def test_region_growing_cli_matches_jax(tmp_path, capsys):
    want, got = _cli_pair(tmp_path, jrg_cli.main, trg_cli.main,
                          ["--normals_k", "16", "--neighbors_k", "6",
                           "--binary"], capsys)
    np.testing.assert_array_equal(got["label"], want["label"])
    assert (got["label"] >= 0).all()
    for f in want.dtype.names:
        np.testing.assert_array_equal(got[f], want[f], f)


def test_kmeans_cli_refuses_sharded(tmp_path, capsys, monkeypatch):
    # --sharded, refused before the multi-GPU slice, now clusters over a
    # mesh (8 CPU shards here) and writes what the unsharded CLI writes
    from gsplat_tpu_torch.parallel import mesh as mesh_lib

    scene = jsynthetic.random_scene(400, seed=6, num_labels=3)
    src = str(tmp_path / "in.ply")
    jply.scene_to_ply(src, scene)
    make = mesh_lib.make_mesh
    monkeypatch.setattr(mesh_lib, "make_mesh",
                        lambda devices=None: make((2, 4), devices))
    outs = {}
    for tag, flags in (("one", []), ("sharded", ["--sharded"])):
        assert tkmeans_cli.main(["--file_path", src, "--save_path",
                                 str(tmp_path / f"{tag}.ply"), "--device",
                                 CPU, "--binary"] + flags) == 0
        outs[tag] = [l for l in capsys.readouterr().out.splitlines()
                     if not l.startswith("wrote")]
    assert outs["sharded"] == outs["one"]
    want = tply.read_ply(str(tmp_path / "one.ply"))["vertex"]
    got = tply.read_ply(str(tmp_path / "sharded.ply"))["vertex"]
    for f in want.dtype.names:
        np.testing.assert_array_equal(got[f], want[f], f)


# ---------------------------------------------------------------------------
# the native codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("labels,sh_degree", [(6, 2), (None, 0)])
def test_native_parse_matches_jax_bindings(tmp_path, labels, sh_degree):
    js = jsynthetic.random_scene(500, seed=51, num_labels=labels,
                                 sh_degree=sh_degree)
    p = str(tmp_path / "s.ply")
    jply.scene_to_ply(p, js)
    want = jnative.scene_from_ply_native(p)
    got = tnative.scene_from_ply_native(p, device=CPU)
    numpy_read = tply.scene_from_ply(p, use_native=False, device=CPU)
    default = tply.scene_from_ply(p, device=CPU)
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        for t in (got, numpy_read, default):
            np.testing.assert_array_equal(getattr(t, f).numpy(), w, f)


def test_native_declines_ascii_and_ply_reads_it(tmp_path):
    js = jsynthetic.random_scene(10, seed=53)
    p = str(tmp_path / "s.ply")
    jply.scene_to_ply(p, js, binary=False)
    assert tnative.scene_from_ply_native(p, device=CPU) is None
    got = tply.scene_from_ply(p, device=CPU)
    np.testing.assert_array_equal(got.means.numpy(),
                                  np.asarray(jply.scene_from_ply(p).means))


def test_native_order_and_pack_match_jax_bindings():
    js = jsynthetic.random_scene(300, seed=55, num_labels=3)
    s = js.to_numpy()
    want = jnative.importance_order_native(s.log_scales, s.opacities)
    got = tnative.importance_order_native(s.log_scales, s.opacities)
    np.testing.assert_array_equal(got, want)
    ts = _port(js)
    assert tnative.pack_splat_native(ts) == jnative.pack_splat_native(js)
    order = np.arange(300, dtype=np.int32)[::-1].copy()
    assert (tnative.pack_splat_native(ts, order)
            == jnative.pack_splat_native(js, order))
    # the port's numpy .splat rows are unchanged, equal to JAX's
    assert tsplat.pack_splat(ts)[0] == jsplat.pack_splat(js)[0]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building"):
        tnative.build()
    assert not any((tmp_path / "native").iterdir())
