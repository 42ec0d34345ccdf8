"""The port's prediction export (`data/export.py`), the opt-in levers and
`--vis` on the entry point, and the recipe scripts, on the CPU.

- The port's and the JAX package's export functions on the same arrays:
  every file byte-identical, `render_mesh` images equal.
- `train_temporal.main(..., device="cpu")` on synthetic posed data with
  `--spatial_sample 1`, `--candidate_reuse_margin 0.05` and both: one epoch
  runs, losses finite; the reuse run's history equal to the default
  run's (reuse is exact).
- `--only_eval 1 --vis` (posed and canonical stages): the expected file set
  under <output_dir>/vis, the predicted garment OBJs byte-identical to the
  eval forward's vertices written by `write_obj`.
- `garment4d_tpu_torch/scripts/{train,test}/*.sh`: each script's argument
  list equals its `scripts/` twin's, and `parse_args` accepts it.
"""

import os
import re
import shlex

import numpy as np
import pytest
import torch

from garment4d_tpu.data import export as jexport

from garment4d_tpu_torch import train_temporal
from garment4d_tpu_torch.data import export as texport
from garment4d_tpu_torch.data.obj_io import read_obj, write_obj
from garment4d_tpu_torch.data.synthetic import make_batch
from garment4d_tpu_torch.models import GarmentAssets
from garment4d_tpu_torch.smpl import synthetic_smpl
from garment4d_tpu_torch.train import loop
from garment4d_tpu_torch.train.step import body_inputs_from_batch
from garment4d_tpu_torch.utils.config import parse_args
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.fixture(scope="module")
def frame():
    rng = np.random.RandomState(3)
    assets = GarmentAssets.synthetic(num_rings=6, ring_size=8)
    body = synthetic_smpl(num_verts=300, device="cpu")
    return dict(
        pcd=rng.randn(500, 3).astype(np.float32),
        pcd_labels=rng.randint(0, 9, size=500),  # past the 7 classes: colours wrap
        pred_garment=(assets.template_v + 0.01 * rng.randn(*assets.template_v.shape)
                      ).astype(np.float32),
        gt_garment=assets.template_v.astype(np.float32),
        body=body.v_template.numpy()), assets.faces_tri, body.faces


def test_export_frame_byte_identical(tmp_path, frame):
    result, garment_faces, body_faces = frame
    for pkg, name in ((texport, "port"), (jexport, "jax")):
        pkg.export_frame(str(tmp_path / name), "b0_s1_f2", result,
                         garment_faces=garment_faces, body_faces=body_faces)
        pkg.export_frame(str(tmp_path / name), "nofaces",
                         {k: v for k, v in result.items() if k != "pcd_labels"})
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want) == sorted(
        f"{tag}_{kind}" for tag in ("b0_s1_f2", "nofaces")
        for kind in ("pcd.ply", "pred_garment.obj", "gt_garment.obj", "body.obj"))
    for name in want:
        assert got[name] == want[name], name
    np.testing.assert_array_equal(texport.SEG_COLORS, jexport.SEG_COLORS)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_render_mesh_equal(frame, axis):
    result, garment_faces, _ = frame
    got = texport.render_mesh(result["pred_garment"], garment_faces, size=64, axis=axis)
    want = jexport.render_mesh(result["pred_garment"], garment_faces, size=64, axis=axis)
    assert got.dtype == np.float64 and got.shape == (64, 64) and got.max() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [None, 3])
def test_save_image_byte_identical(tmp_path, frame, channels):
    result, garment_faces, _ = frame
    img = texport.render_mesh(result["pred_garment"], garment_faces, size=32)
    if channels:
        img = np.stack([img, 0.5 * img, img ** 2], -1)
    texport.save_image(str(tmp_path / "port.png"), img)
    jexport.save_image(str(tmp_path / "jax.png"), img)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


# ---- the entry point ----------------------------------------------------------


def _posed_args(out, *extra):
    return ["--config", "cfgs/skirt.yaml", "--synthetic_data", "1", "--GarmentPCALBS", "1",
            "--batch_size", "1", "--T", "2", "--npoints", "512", "--epoch_num", "1",
            "--output_dir", out, *extra]


@pytest.fixture(scope="module")
def default_history(tmp_path_factory):
    return train_temporal.main(_posed_args(str(tmp_path_factory.mktemp("default"))),
                               device="cpu")


@pytest.mark.parametrize("levers", [
    ["--spatial_sample", "1"], ["--candidate_reuse_margin", "0.05"],
    ["--spatial_sample", "1", "--candidate_reuse_margin", "0.05"]],
    ids=["spatial", "reuse", "both"])
def test_levers_through_main(tmp_path, monkeypatch, default_history, levers):
    """One synthetic posed epoch with the levers: finite losses, the model
    built with them; the reuse lever alone gives the default run's history
    exactly (its 400-vertex body is not compacted, and reuse is exact)."""
    built = []
    original = train_temporal._make_state

    def recording(*args, **kwargs):
        state, path = original(*args, **kwargs)
        built.append(state.model)
        return state, path

    monkeypatch.setattr(train_temporal, "_make_state", recording)
    hist = train_temporal.main(_posed_args(str(tmp_path / "out"), *levers), device="cpu")
    model, = built
    assert model.spatial_sample == ("--spatial_sample" in levers)
    assert model.candidate_reuse_margin == (0.05 if "--candidate_reuse_margin" in levers
                                            else 0.0)
    assert len(hist) == 1
    for split in ("train", "eval"):
        assert all(np.isfinite(v) for v in hist[0][split].values())
    if levers == ["--candidate_reuse_margin", "0.05"]:
        assert hist == default_history


@pytest.mark.parametrize("stage", ["posed", "canonical"])
def test_only_eval_vis(tmp_path, stage):
    """--only_eval 1 --vis writes, for each frame of the first two eval
    batches (B=2, T=2; the canonical stage: one T-pose frame a sequence),
    the coloured point cloud and the predicted, ground-truth and body OBJs;
    the predicted garment files those of the eval forward of the same
    weights on the same batch, byte for byte."""
    out = str(tmp_path / "eval")
    argv = ["--config", "cfgs/skirt.yaml", "--synthetic_data", "1", "--batch_size", "2",
            "--T", "2", "--npoints", "512", "--only_eval", "1", "--vis", "--output_dir", out,
            "--GarmentPCALBS" if stage == "posed" else "--GarmentPCA", "1"]
    means = train_temporal.main(argv, device="cpu")
    assert all(np.isfinite(v) for v in means.values())
    frames = 2 if stage == "posed" else 1
    tags = [f"b{bi}_s{b}_f{t}" for bi in range(2) for b in range(2) for t in range(frames)]
    kinds = ("pcd.ply", "pred_garment.obj", "gt_garment.obj", "body.obj")
    assert sorted(os.listdir(os.path.join(out, "vis"))) == sorted(
        f"{tag}_{kind}" for tag in tags for kind in kinds)

    # the same weights (seed 0, nothing loaded) and the first eval batch
    args, cfg = parse_args(argv)
    assets = GarmentAssets.synthetic(name=cfg.GARMENT.NAME, num_rings=12, ring_size=16)
    body = synthetic_smpl(num_verts=400, seed=0, device="cpu")
    state, _ = train_temporal._make_state(args, cfg, assets, body, torch.device("cpu"),
                                          loop.make_logger())
    batch = make_batch(assets, body, batch_size=2, T=2, npoints=512, seed=1000, device="cpu")
    with torch.inference_mode():
        model = state.model.eval()
        if stage == "posed":
            pred = model(batch["pcd"], body_inputs_from_batch(batch)).iter_garment_v[-1]
        else:
            pred = model(batch["pcd"]).tpose_garment[:, None]
    for b in range(2):
        for t in range(frames):
            path = os.path.join(out, "vis", f"b0_s{b}_f{t}_pred_garment.obj")
            write_obj(str(tmp_path / "want.obj"), pred[b, t].numpy(), assets.faces_tri)
            with open(path, "rb") as f:
                assert f.read() == (tmp_path / "want.obj").read_bytes()
            v, faces, _, _ = read_obj(path)
            assert v.shape == (assets.num_verts, 3) and len(faces) == len(assets.faces_tri)
            ply = open(os.path.join(out, "vis", f"b0_s{b}_f{t}_pcd.ply")).read()
            assert "property uchar red" in ply and "element vertex 512" in ply


# ---- the recipe scripts ---------------------------------------------------------


def _script_argv(path):
    """The arguments a recipe script passes to the entry point (the flags
    after its python line, `"$@"` left out), and its python line."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    line = next(l for l in text.splitlines() if l.lstrip().startswith("python"))
    words = shlex.split(line)
    words = [w for w in words if w != "$@"]
    module = words.index("-m") + 1 if "-m" in words else None
    start = module + 1 if module else 2
    return words[:start], words[start:]


SCRIPTS = sorted(f"{sub}/{name}" for sub in ("train", "test")
                 for name in os.listdir(os.path.join(REPO, "scripts", sub)))


def test_every_script_has_a_port_twin():
    assert len(SCRIPTS) == 9
    port = sorted(f"{sub}/{name}" for sub in ("train", "test")
                  for name in os.listdir(os.path.join(REPO, "garment4d_tpu_torch", "scripts",
                                                      sub)))
    assert port == SCRIPTS


@pytest.mark.parametrize("script", SCRIPTS)
def test_port_script_matches_its_twin(script):
    port = os.path.join(REPO, "garment4d_tpu_torch", "scripts", script)
    head, argv = _script_argv(port)
    _, want = _script_argv(os.path.join(REPO, "scripts", script))
    assert head == ["python", "-m", "garment4d_tpu_torch.train_temporal"]
    assert argv == want
    assert os.access(port, os.X_OK)
    with open(port) as f:
        text = f.read()
    # from the repo root, where the relative config and output paths point
    assert re.search(r'cd "\$\(dirname "\$0"\)/\.\./\.\./\.\."', text)
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        args, cfg = parse_args(argv)
    finally:
        os.chdir(cwd)
    assert cfg.GARMENT.NAME.lower() in script
    assert bool(args.GarmentPCA) != bool(args.GarmentPCALBS)
