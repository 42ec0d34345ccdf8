"""Parity of the port's CLOTH3D data path with the JAX package, on the CPU.

The mini-CLOTH3D tree of `data/fixture.py` (a ring garment of 8 x 12
vertices, two sequences of 6 frames, 700 garment points a frame), 300-vertex
synthetic bodies, T=3, N=512: the fixture writers, the dataset's windows,
`raw_item` (bitwise), `finalize_batch` (floats within 1e-5, indices and
labels equal), the asset and SMPL loaders and the config.
"""

import dataclasses
import filecmp
import os
import pickle
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from garment4d_tpu import smpl as jsmpl
from garment4d_tpu.data import cloth3d as jcloth3d
from garment4d_tpu.data import native as jnative
from garment4d_tpu.data.fixture import write_fixture as jwrite_fixture
from garment4d_tpu.data.obj_io import read_obj as jread_obj
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.utils import config as jconfig

from garment4d_tpu_torch import smpl as tsmpl
from garment4d_tpu_torch.data import cloth3d as tcloth3d
from garment4d_tpu_torch.data import native as tnative
from garment4d_tpu_torch.data.fixture import write_fixture as twrite_fixture
from garment4d_tpu_torch.data.obj_io import read_obj as tread_obj
from garment4d_tpu_torch.data.obj_io import write_obj as twrite_obj
from garment4d_tpu_torch.models import GarmentAssets as TAssets
from garment4d_tpu_torch.utils import config as tconfig
from torch_port_threads import one_torch_thread  # noqa: F401

RINGS, RING_SIZE, NB, T, N = 8, 12, 300, 3, 512
SEQS, FRAMES = 2, 6


def _tree_files(root):
    out = []
    for d, _, files in os.walk(root):
        out.extend(os.path.relpath(os.path.join(d, f), root) for f in files)
    return sorted(out)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The port's and the JAX package's fixture trees from one seed."""
    roots = []
    for name, writer, assets in (("torch", twrite_fixture, TAssets), ("jax", jwrite_fixture, JAssets)):
        root = str(tmp_path_factory.mktemp(f"cloth3d_{name}"))
        lists = writer(root, assets.synthetic(name="Skirt", num_rings=RINGS, ring_size=RING_SIZE),
                       num_seqs=SEQS, frames_per_seq=FRAMES)
        roots.append((root, lists))
    return roots


def _datasets(root, lists, split, rng_seed=None):
    """(port dataset, JAX dataset) over one tree; train windows from one
    seeded RandomState each."""
    out = []
    for mod in (tcloth3d, jcloth3d):
        paths = mod.Cloth3dPaths(root=root, garment_folder="Skirt_reg",
                                 template_prefix=os.path.join(root, "CLOTH3D_template"))
        rng = None if rng_seed is None else np.random.RandomState(rng_seed)
        out.append(mod.Cloth3dDataset(paths, lists[split], "Skirt", T=T, npoints=N,
                                      is_train=split == "train", body_verts=NB, rng=rng))
    return out


@pytest.fixture(scope="module")
def datasets(trees):
    root, lists = trees[0]
    return {"eval": _datasets(root, lists, "eval"), "train": _datasets(root, lists, "train", 0)}


@pytest.fixture(scope="module")
def bodies():
    """{gender: (port body, JAX body)}: two different synthetic bodies."""
    return {g: (tsmpl.synthetic_smpl(num_verts=NB, seed=s, device="cpu"),
                jsmpl.synthetic_smpl(num_verts=NB, seed=s))
            for s, g in enumerate(("male", "female"))}


def test_fixture_trees_byte_identical(trees):
    (troot, tlists), (jroot, jlists) = trees
    files = _tree_files(troot)
    assert files == _tree_files(jroot)
    assert len(files) == 2 + SEQS * (4 + 3 * FRAMES)  # lists; gender, reg, template; frames
    _, mismatch, errors = filecmp.cmpfiles(troot, jroot, files, shallow=False)
    assert mismatch == [] and errors == []
    assert [os.path.relpath(p, troot) for p in tlists.values()] == \
        [os.path.relpath(p, jroot) for p in jlists.values()]


@pytest.mark.parametrize("split", ["train", "eval"])
def test_windows_equal(datasets, split):
    tds, jds = datasets[split]
    assert tds.windows == jds.windows
    assert len(tds) == 3 * SEQS  # int(6 / 3) + 1 windows a sequence
    if split == "eval":  # the exact-multiple duplication kept from the reference
        assert tds.windows[2] == [f"10000/{FRAMES - 1:05d}"] * T


@pytest.mark.parametrize("split", ["train", "eval"])
def test_raw_item_bitwise(datasets, split):
    tds, jds = datasets[split]
    for i in range(len(tds)):
        got, want = tds.raw_item(i), jds.raw_item(i)
        assert list(got) == list(want)
        for k in want:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), f"window {i}: {k}"


def test_finalize_batch_matches_jax(datasets, bodies):
    """Windows of both sequences (genders 0 and 1) in one batch: floats
    within 1e-5, indices and labels (after the -1 shift) equal."""
    tds, _ = datasets["eval"]
    raw = tds.collate([tds.raw_item(i) for i in (0, 4, 1)])
    assert sorted(set(raw["gender"].tolist())) == [0, 1]
    got = tcloth3d.finalize_batch(raw, {g: b[0] for g, b in bodies.items()})
    want = jcloth3d.finalize_batch(raw, {g: b[1] for g, b in bodies.items()})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.integer):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)
    labels = got["pcd_label"].numpy()
    assert labels.min() == 0 and labels.max() == 1  # body 0, skirt 1
    # J_regressor / lbs_weights: one pick per batch element, expanded over T
    assert got["J_regressor"].stride(1) == 0 and got["lbs_weights"].stride(1) == 0


def test_unknown_gender_raises(trees, tmp_path):
    root = str(tmp_path / "tree")
    shutil.copytree(trees[0][0], root)
    with open(os.path.join(root, "CLOTH3D", "10000", "gender.pkl"), "wb") as f:
        pickle.dump(2, f)
    lists = {k: os.path.join(root, "list", os.path.basename(v)) for k, v in trees[0][1].items()}
    tds, jds = _datasets(root, lists, "eval")
    for ds in (tds, jds):
        with pytest.raises(NotImplementedError, match="gender 2"):
            ds.raw_item(0)


def test_sequence_cache_is_lru(tmp_path):
    """The port's per-sequence cache evicts the least recently used
    sequence; the JAX package's evicts the oldest inserted, so a sequence
    read on every window is dropped while it is in use (a fault of that
    package). Cache of two sequences, windows of A, B, A, C."""
    root = str(tmp_path / "three")
    lists = twrite_fixture(root, TAssets.synthetic(name="Skirt", num_rings=RINGS,
                                                   ring_size=RING_SIZE),
                           num_seqs=3, frames_per_seq=T, garment_points=64)
    tds, jds = _datasets(root, lists, "eval")
    a, b, c = 0, 2, 4  # one window of each sequence (each has 2)
    for ds in (tds, jds):
        ds._seq_cache_max = 2
        for i in (a, b, a, c):
            ds.raw_item(i)
    assert list(tds._seq_cache) == ["10000", "10002"]
    assert list(jds._seq_cache) == ["10001", "10002"]


def _write_template(root, assets):
    obj = os.path.join(root, "Skirt_template.obj")
    twrite_obj(obj, assets.template_v, [list(f) for f in assets.faces])
    pca = os.path.join(root, "PCABase_SS.pkl")
    with open(pca, "wb") as f:
        pickle.dump({"components": assets.pca_components, "mean": assets.pca_mean,
                     "explained": assets.pca_explained, "ss_scale": assets.pca_scale}, f)
    return obj, pca


def _assert_assets_equal(got, want):
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), field.name
        else:
            assert g == w, field.name


def test_assets_from_files_and_permuted(tmp_path):
    """`from_files` (quads kept, PCA cut to pca_dim) and `permuted` give
    every array of the JAX package's, the graph operators relabelled (the
    tri-face (0, 0) adjacency entry follows the vertex)."""
    obj, pca = _write_template(str(tmp_path), TAssets.synthetic(num_rings=RINGS,
                                                                ring_size=RING_SIZE))
    got = TAssets.from_files("Skirt", obj, pca, pca_dim=32)
    want = JAssets.from_files("Skirt", obj, pca, pca_dim=32)
    _assert_assets_equal(got, want)
    assert got.pca_dim == 32
    perm = np.random.RandomState(3).permutation(got.num_verts)
    _assert_assets_equal(got.permuted(perm), want.permuted(perm))
    # a triangle mesh: the (0, 0) entry of `build_mesh_adjacency` stays on
    # the vertex it was built on
    tri = TAssets.build("Skirt", got.template_v, [list(f) for f in got.faces_tri],
                        got.pca_components, got.pca_mean, got.pca_explained, got.pca_scale)
    jtri = JAssets.build("Skirt", want.template_v, [list(f) for f in want.faces_tri],
                         want.pca_components, want.pca_mean, want.pca_explained,
                         want.pca_scale)
    _assert_assets_equal(tri.permuted(perm), jtri.permuted(perm))


def _make_fake_ch(x):
    return x


def _fake_chumpy_pickle(path, model, chumpy_module):
    """A released-SMPL-style pickle (float64 buffers, a sparse J_regressor,
    posedirs (V, 3, P), kintree_table) as in tests/test_smpl.py; with
    `chumpy_module`, v_template is stored as a chumpy `Ch` object."""
    import scipy.sparse as sp

    V = model.v_template.shape[0]
    data = {
        "v_template": np.asarray(model.v_template, np.float64),
        "shapedirs": np.asarray(model.shapedirs, np.float64),
        "posedirs": np.asarray(model.posedirs).T.reshape(V, 3, -1).astype(np.float64),
        "J_regressor": sp.csc_matrix(np.asarray(model.J_regressor, np.float64)),
        "weights": np.asarray(model.lbs_weights, np.float64),
        "kintree_table": np.stack([model.parents, np.arange(24)]),
        "f": model.faces,
    }
    if chumpy_module:
        mod = types.ModuleType("chumpy.ch")

        class Ch:
            def __init__(self, x):
                self.x = x

        Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
        mod.Ch = Ch
        package = types.ModuleType("chumpy")
        package.ch = mod
        sys.modules.update({"chumpy": package, "chumpy.ch": mod})
        try:
            data["v_template"] = Ch(data["v_template"])
            with open(path, "wb") as f:
                pickle.dump(data, f, protocol=2)
        finally:
            del sys.modules["chumpy"], sys.modules["chumpy.ch"]
    else:
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=2)


@pytest.mark.parametrize("kind", ["npz", "pkl", "pkl_chumpy"])
def test_smpl_loaders_match_jax(tmp_path, kind):
    model = jsmpl.synthetic_smpl(num_verts=60)
    path = str(tmp_path / f"SMPL_TEST.{kind[:3]}")
    if kind == "npz":
        np.savez(path, v_template=np.asarray(model.v_template),
                 shapedirs=np.asarray(model.shapedirs), posedirs=np.asarray(model.posedirs),
                 J_regressor=np.asarray(model.J_regressor),
                 lbs_weights=np.asarray(model.lbs_weights), parents=model.parents,
                 faces=model.faces)
    else:
        _fake_chumpy_pickle(path, model, kind == "pkl_chumpy")
    got = tsmpl.load_smpl(path, device="cpu")
    want = jsmpl.load_smpl(path)
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), np.asarray(getattr(want, field.name))
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape, field.name
        assert g.tobytes() == w.tobytes(), field.name


def test_smpl_loader_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default does not raise")
    path = str(tmp_path / "SMPL.npz")
    m = tsmpl.synthetic_smpl(num_verts=20, device="cpu")
    np.savez(path, **{k: (getattr(m, k).numpy() if isinstance(getattr(m, k), torch.Tensor)
                          else getattr(m, k)) for k in
                      ("v_template", "shapedirs", "posedirs", "J_regressor",
                       "lbs_weights", "parents", "faces")})
    with pytest.raises(RuntimeError, match="cuda"):
        tsmpl.load_smpl(path)


@pytest.mark.parametrize("n_in,n", [(700, 512), (512, 256), (300, 512), (100, 250), (64, 64)])
def test_sample_choices_match_jax(n_in, n):
    np.testing.assert_array_equal(tcloth3d.sample_choice(n_in, n),
                                  jcloth3d.sample_choice(n_in, n))
    np.testing.assert_array_equal(tcloth3d._body_shuffle_choice(NB, n_in, n),
                                  jcloth3d._body_shuffle_choice(NB, n_in, n))


def test_file_readers_match_jax(tmp_path):
    """The port's numpy readers against the JAX package's (its C++
    extension where it builds): .bin payloads, OBJ faces (quads kept) and
    vertices, and the barycentric remesh, bitwise."""
    rng = np.random.RandomState(0)
    pts = rng.randn(57, 3).astype(np.float32)
    paths = []
    for i, n in enumerate((57, 5)):
        p = str(tmp_path / f"{i}.bin")
        pts[:n].tofile(p)
        paths.append(p)
    for g, w in zip(tnative.read_bin_batch(paths), jnative.read_bin_batch(paths)):
        assert g.tobytes() == w.tobytes()
    obj = str(tmp_path / "m.obj")
    twrite_obj(obj, pts[:9], [[0, 1, 2], [2, 3, 4, 5], [6, 7, 8]])
    (gv, gf), (wv, wf) = tnative.parse_obj(obj), jnative.parse_obj(obj)
    assert gv.tobytes() == np.ascontiguousarray(wv).tobytes() and gf == wf
    gv, gf, _, _ = tread_obj(obj)
    wv, wf, _, _ = jread_obj(obj)
    assert gv.tobytes() == wv.tobytes() and gf == wf
    ind = rng.randint(0, 57, size=(400, 3))
    w = rng.rand(400, 3)
    w /= w.sum(1, keepdims=True)
    assert tnative.barycentric(pts, ind, w).tobytes() == jnative.barycentric(pts, ind, w).tobytes()
    with pytest.raises(IndexError):
        tnative.barycentric(pts, ind + 57, w)


def _config_values(cfg):
    return {s: dataclasses.asdict(getattr(cfg, s)) for s in ("GARMENT", "NETWORK", "DATASET", "LOSS")}


@pytest.mark.parametrize("which", ["skirt", "overlay"])
def test_config_matches_jax(tmp_path, which):
    path = "cfgs/skirt.yaml"
    if which == "overlay":
        path = str(tmp_path / "overlay.yaml")
        with open(path, "w") as f:
            f.write("_BASE_CONFIG_: cfgs/trousers.yaml\nNETWORK:\n  LBSK: 16\n  NPOINTS: 512\n"
                    "DATASET:\n  ROOT_FOLDER: /data/mini\nLOSS:\n  GARMENT_L2_LOSS_LAMBDA: 7\n")
    argv = ["--config", path, "--GarmentPCALBS", "1", "--batch_size", "4", "--lr_sche"]
    targs, tcfg = tconfig.parse_args(argv)
    jargs, jcfg = jconfig.parse_args(argv)
    assert vars(targs) == vars(jargs)
    assert _config_values(tcfg) == _config_values(jcfg)
    assert type(tcfg.LOSS).__module__.startswith("garment4d_tpu_torch.")
    if which == "overlay":
        assert tcfg.NETWORK.LBSK == 16 and tcfg.LOSS.garment_l2 == 7.0
        assert tcfg.GARMENT.TEMPLATE.startswith("/data/mini/")
