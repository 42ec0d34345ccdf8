"""The port's tracing tools and offline file tools against the JAX
package's, on the CPU.

- `tools/fit_pca.py`: the basis (components, mean, explained, ss_scale),
  the coefficients and the reconstruction bitwise the JAX package's (the
  same float64 numpy calls in the same order), the pickle's keys;
- `tools/model_pkl.py`: `clean` and `merge`, as functions and through
  their CLI, key for key and bitwise the JAX package's outputs, on the
  chumpy-shim pickles of `tests/test_tools.py`;
- `data/matlab_io.py`: `load_info` on a nested struct written with
  `scipy.io.savemat`, equal to the JAX package's;
- `utils/profiling.py`: `StepTimer.summary` on scripted times equal to
  JAX's, `measure`'s host copy, `device_trace` and `summarize_trace` on a
  CPU session, `profile_device` on the CPU;
- `tools/profile_posed.py` on the CPU at a shrunken size for each path,
  with weights from an npz holding a key without "/" (the JAX tool's
  `k.split("/", 2)[1]` raises IndexError on one), and a clear KeyError
  for an npz without a canonical subtree.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import test_tools
from garment4d_tpu.data import matlab_io as jmatlab
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.tools import fit_pca as jfit
from garment4d_tpu.tools import model_pkl as jpkl
from garment4d_tpu.utils import profiling as jprof

from garment4d_tpu_torch.data import matlab_io
from garment4d_tpu_torch.tools import fit_pca, model_pkl, profile_posed
from garment4d_tpu_torch.utils import profiling
from torch_port_threads import one_torch_thread  # noqa: F401

SMALL = dict(T=2, npoints=256, rings=6, ring_size=8, body_verts=200, lbs_k=16, train_batch=1)
WEIGHTS = "ckpt_synth/posed_synth.npz"


def _same(a, b):
    """Equal types and values, arrays bitwise (dtype and shape too)."""
    if isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


# ---- fit_pca ------------------------------------------------------------------


def test_fit_pca_bitwise(rng, tmp_path):
    """The JAX test's registered set (tests/test_tools.py:64-95): 40
    garments of the 48-vertex ring on a 16-dimensional basis, and one
    constant coordinate (ss_scale's eps branch)."""
    assets = JAssets.synthetic(num_rings=6, ring_size=8)
    V = assets.num_verts
    S, k = 40, 16
    coeffs = rng.randn(S, k).astype(np.float32)
    dirs = rng.randn(k, V * 3).astype(np.float32) * 0.05
    verts = (assets.template_v.reshape(-1)[None] + coeffs @ dirs).reshape(S, V, 3)
    verts[:, 5, 1] = 0.25
    for n in (k, 64):
        got, want = fit_pca.fit_pca_basis(verts, n_components=n), jfit.fit_pca_basis(
            verts, n_components=n)
        assert list(got) == list(want) == ["components", "mean", "explained", "ss_scale"]
        for key in want:
            assert _same(got[key], want[key]), key
        coeff = fit_pca.transform(got, verts)
        assert _same(coeff, jfit.transform(want, verts))
        assert _same(fit_pca.inverse_transform(got, coeff), jfit.inverse_transform(want, coeff))
    assert np.abs(fit_pca.inverse_transform(got, coeff) - verts).max() < 1e-3
    paths = [str(tmp_path / f"{tag}.pkl") for tag in ("port", "jax")]
    fit_pca.save_basis(paths[0], got)
    jfit.save_basis(paths[1], want)
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    assert list(a) == list(b) and all(_same(a[key], b[key]) for key in b)


# ---- model_pkl -------------------------------------------------------------------


def _chumpy_pickle(path, arrays, plain=None):
    test_tools.TestModelPklTools._chumpy_pickle(str(path), arrays, plain)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_dict(a, b):
    assert list(a) == list(b)
    for key in b:
        assert _same(a[key], b[key]), key


def test_clean_matches_jax(rng, tmp_path):
    arrays = {"v_template": rng.randn(10, 3), "weights": rng.rand(10, 24).astype(np.float32),
              "shapedirs": rng.randn(10, 3, 4)}
    plain = {"f": np.arange(12).reshape(4, 3), "bs_style": "lbs", "bs_type": "lrotmin"}
    src = tmp_path / "SMPL_TEST.pkl"
    _chumpy_pickle(src, arrays, plain)
    got = model_pkl.clean_model_pkl(str(src), str(tmp_path / "port"))
    want = jpkl.clean_model_pkl(str(src), str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want) == "SMPL_TEST.pkl"
    _same_dict(_load(got), _load(want))
    for key in arrays:
        assert isinstance(_load(got)[key], np.ndarray)


def test_merge_matches_jax(rng, tmp_path):
    body = {"v_template": rng.randn(20, 3), "kintree_table": np.arange(10).reshape(2, 5)}
    hands = [{"hands_components": rng.randn(6, 45), "hands_coeffs": rng.randn(100, 6),
              "hands_mean": rng.randn(45)} for _ in range(2)]
    paths = [tmp_path / name for name in ("SMPLH_TEST.pkl", "L.pkl", "R.pkl")]
    for p, data in zip(paths, [body] + hands):
        _chumpy_pickle(p, data)
    got = model_pkl.merge_hand_models(*map(str, paths), str(tmp_path / "port"))
    want = jpkl.merge_hand_models(*map(str, paths), str(tmp_path / "jax"))
    _same_dict(_load(got), _load(want))
    assert set(_load(got)) >= {"hands_componentsl", "hands_componentsr", "hands_coeffsl",
                               "hands_coeffsr", "hands_meanl", "hands_meanr"}


def test_model_pkl_cli_matches_jax(rng, tmp_path, capsys):
    """Both subcommands through `main` with the reference's flag names."""
    srcs = []
    for name in ("SMPL_MALE.pkl", "SMPL_FEMALE.pkl"):
        srcs.append(tmp_path / name)
        _chumpy_pickle(srcs[-1], {"v_template": rng.randn(8, 3)}, {"f": np.arange(6)})
    hand = {"hands_components": rng.randn(3, 45), "hands_coeffs": rng.randn(5, 3),
            "hands_mean": rng.randn(45)}
    for name in ("L.pkl", "R.pkl"):
        _chumpy_pickle(tmp_path / name, hand)
    for tag, mod in (("port", model_pkl), ("jax", jpkl)):
        out = str(tmp_path / tag)
        mod.main(["clean", "--input-models", *map(str, srcs), "--output-folder", out])
        mod.main(["merge", "--smplh-fn", str(srcs[0]), "--mano-left-fn",
                  str(tmp_path / "L.pkl"), "--mano-right-fn", str(tmp_path / "R.pkl"),
                  "--output-folder", out + "_merged"])
    printed = capsys.readouterr().out.split()
    assert [os.path.basename(p) for p in printed] == ["SMPL_MALE.pkl", "SMPL_FEMALE.pkl",
                                                      "SMPL_MALE.pkl"] * 2
    for sub, names in (("", ("SMPL_MALE.pkl", "SMPL_FEMALE.pkl")), ("_merged", ("SMPL_MALE.pkl",))):
        for name in names:
            _same_dict(_load(tmp_path / f"port{sub}" / name), _load(tmp_path / f"jax{sub}" / name))


# ---- matlab_io ---------------------------------------------------------------------


def test_load_info_matches_jax(tmp_path):
    import scipy.io

    info = {"gender": 1, "trans": np.arange(6.0).reshape(3, 2),
            "outfit": {"top": {"fabric": "cotton", "texture": {"type": "pattern",
                                                                "data": np.eye(2)}},
                       "bottom": {"fabric": "denim", "size": np.float64(3.5)}},
            "camLoc": np.array([0.5, -1.0, 2.0])}
    path = str(tmp_path / "info.mat")
    scipy.io.savemat(path, {"info": info, "name": "seq01"})
    got, want = matlab_io.load_info(path), jmatlab.load_info(path)
    assert isinstance(got["info"], dict) and isinstance(got["info"]["outfit"]["top"], dict)
    assert got["info"]["outfit"]["top"]["texture"]["type"] == "pattern"

    def same_tree(a, b):
        assert type(a) is type(b)
        if isinstance(b, dict):
            assert list(a) == list(b)
            for key in b:
                same_tree(a[key], b[key])
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b

    same_tree(got, want)


# ---- profiling -----------------------------------------------------------------------


@pytest.mark.parametrize("times", [[0.5, 0.1, 0.2, 0.3, 0.9], [0.25]])
def test_step_timer_summary_matches_jax(times):
    got, want = profiling.StepTimer(), jprof.StepTimer()
    got.times, want.times = list(times), list(times)
    assert got.summary() == want.summary()


def test_step_timer_measure():
    """`measure` records one time a step, after the host copy of one
    element of what `sync` was given (or of `sync_array`)."""
    timer = profiling.StepTimer()
    x = torch.arange(6.0).reshape(2, 3)
    for _ in range(3):
        with timer.measure() as sync:
            sync({"out": (x * 2, None)})
    with timer.measure(sync_array=[x]):
        pass
    assert len(timer.times) == 4 and all(t >= 0 for t in timer.times)
    assert timer.summary()["steps"] == 4


def test_device_trace_and_summary(tmp_path):
    """A CPU session's trace lands in `log_dir`; its summary lists the CPU
    operators in ms, largest first, `top` of them."""
    a = torch.randn(64, 64)
    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir):
        for _ in range(3):
            torch.relu(a @ a).sum()
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(log_dir))
    summary = profiling.summarize_trace(log_dir, top=4)
    assert 0 < len(summary) <= 4 and "aten::mm" in summary
    ms = list(summary.values())
    assert ms == sorted(ms, reverse=True) and all(v > 0 for v in ms)
    assert profiling.summarize_trace(str(tmp_path / "none")) == {}


def test_profile_device_cpu():
    """On the CPU: the operators by self time, no kernel counted."""
    a = torch.randn(32, 32)
    rows, total = profiling.profile_device(lambda: torch.relu(a @ a), runs=2, device="cpu")
    names = [r[2] for r in rows]
    assert "aten::mm" in names and total == pytest.approx(sum(r[0] for r in rows))
    assert all(r[1] == 1.0 for r in rows if r[2] in ("aten::mm", "aten::relu"))


# ---- profile_posed ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def odd_npz(tmp_path_factory):
    """posed_synth.npz with one more key, without a "/"."""
    path = str(tmp_path_factory.mktemp("weights") / "odd.npz")
    with np.load(WEIGHTS) as data:
        np.savez(path, format_version=np.int32(1), **{k: data[k] for k in data.files})
    return path


@pytest.mark.parametrize("which", profile_posed.WHICH)
def test_profile_posed_cpu(which, odd_npz, capsys):
    out = profile_posed.main([which, "--iters", "1", "--batch", "1", "--top", "3",
                              "--device", "cpu", "--weights", odd_npz], **SMALL)
    text = capsys.readouterr().out
    assert "weights: odd.npz" in text and "step time:" in text and "frames/s" in text
    frames = SMALL["T"]  # batch 1, train_batch 1
    assert out["frames_per_sec"] == pytest.approx(frames / out["step_ms"] * 1e3)
    assert out["total_ms"] > 0 and len(out["rows"]) > 3 and "CPU operator self time" in text


def test_profile_posed_weights(tmp_path):
    """A file without a canonical subtree raises KeyError for `canonical`;
    a missing file raises; `random` loads nothing."""
    bare = str(tmp_path / "bare.npz")
    np.savez(bare, format_version=np.int32(1), **{"params/other/w": np.zeros(2)})
    with pytest.raises(KeyError, match="canonical"):
        profile_posed.build("canonical", 1, bare, "cpu", **SMALL)
    with pytest.raises(FileNotFoundError):
        profile_posed.build("posed", 1, str(tmp_path / "missing.npz"), "cpu", **SMALL)
    with pytest.raises(ValueError):
        profile_posed.build("forward", 1, "random", "cpu", **SMALL)
    _, frames, label = profile_posed.build("canonical", 2, "random", "cpu", **SMALL)
    assert label == "random-init" and frames == 2 * SMALL["T"]
