"""The port's entry point, `garment4d_tpu_torch.train_temporal.main`, on the
CPU (`device="cpu"`: the plain torch versions).

- one synthetic-branch epoch of the canonical stage;
- the recipe on a disk fixture (the counterpart of tests/test_cli.py's
  `TestCliDiskFixture`): one sequence of 6 frames, T=3, batch 3, so one
  train and one eval batch an epoch; a posed `--fix_PCA 1` epoch
  bootstrapped by `--GarmentPCA_pretrain` from a canonical checkpoint that
  `save_checkpoint` wrote, an auto-resume from its checkpoint, then
  `--only_eval 1 --pretrained_model`;
- `--bf16` and `--debug_nans` reach the model and its steps, `--remat` is
  logged as a no-op;
- one canonical eval epoch over a disk-fixture batch against the JAX
  package's, at identical weights (a JAX init through `flax_to_torch`):
  every mean within 1e-4 relative.

NPOINTS 512 and a 300-vertex body, as in tests/test_cli.py.
"""

import json
import logging
import os
import pickle

import numpy as np
import pytest
import torch

import jax
from flax import traverse_util

from garment4d_tpu import smpl as jsmpl
from garment4d_tpu.data import cloth3d as jcloth3d
from garment4d_tpu.data.synthetic import make_batch as jmake_batch
from garment4d_tpu.losses import LossWeights as JLossWeights
from garment4d_tpu.models import CanonicalGarmentModel as JCanonical
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.models import PosedGarmentModel as JPosed
from garment4d_tpu.train import loop as jloop
from garment4d_tpu.train.step import body_inputs_from_batch as jbody_inputs
from garment4d_tpu.train.step import make_canonical_steps as jmake_canonical_steps
from garment4d_tpu.train.step import make_state_for as jmake_state_for

from garment4d_tpu_torch import smpl as tsmpl
from garment4d_tpu_torch import train_temporal
from garment4d_tpu_torch.data import cloth3d as tcloth3d
from garment4d_tpu_torch.data.fixture import write_fixture
from garment4d_tpu_torch.data.obj_io import write_obj
from garment4d_tpu_torch.models import CanonicalGarmentModel, GarmentAssets
from garment4d_tpu_torch.train import checkpoint as ckpt
from garment4d_tpu_torch.train import loop
from garment4d_tpu_torch.train.convert import flax_to_torch
from garment4d_tpu_torch.train.step import make_canonical_steps, make_state_for
from torch_port_threads import one_torch_thread  # noqa: F401

NB, T, BATCH = 300, 3, 3


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """A mini-CLOTH3D tree of one sequence, the registered template and PCA
    pickle, SMPL npz files and a config over them."""
    root = str(tmp_path_factory.mktemp("cloth3d_port_cli"))
    assets = GarmentAssets.synthetic(name="Skirt", num_rings=8, ring_size=12)
    lists = write_fixture(root, assets, num_seqs=1, frames_per_seq=6)
    reg = os.path.join(root, "Skirt_reg")
    write_obj(os.path.join(reg, "Skirt_template.obj"), assets.template_v,
              [list(f) for f in assets.faces])
    with open(os.path.join(reg, "PCABase_SS.pkl"), "wb") as f:
        pickle.dump({"components": assets.pca_components, "mean": assets.pca_mean,
                     "explained": assets.pca_explained, "ss_scale": assets.pca_scale}, f)
    smpl_dir = os.path.join(root, "smpl_models")
    os.makedirs(smpl_dir)
    for s, gender in enumerate(("male", "female")):
        m = tsmpl.synthetic_smpl(num_verts=NB, seed=s, device="cpu")
        np.savez(os.path.join(smpl_dir, f"SMPL_{gender.upper()}.npz"),
                 **{k: getattr(m, k).numpy() for k in ("v_template", "shapedirs", "posedirs",
                                                       "J_regressor", "lbs_weights")},
                 parents=m.parents, faces=m.faces)
    cfg = os.path.join(root, "fixture.yaml")
    with open(cfg, "w") as f:
        f.write(f"""_BASE_CONFIG_: cfgs/skirt.yaml
NETWORK:
  LBSK: 16
  NPOINTS: 512
DATASET:
  ROOT_FOLDER: {root}
  TRAIN_F_LIST: {lists["train"]}
  EVAL_F_LIST: {lists["eval"]}
  EXCLUDE_SEQ_LIST: ""
""")
    return dict(root=root, cfg=cfg, smpl_dir=smpl_dir, lists=lists,
                template=os.path.join(reg, "Skirt_template.obj"),
                pca=os.path.join(reg, "PCABase_SS.pkl"))


def _disk_args(disk, out, *extra):
    return ["--config", disk["cfg"], "--batch_size", str(BATCH), "--T", str(T),
            "--num_workers", "2", "--smpl_model_dir", disk["smpl_dir"],
            "--output_dir", out, *extra]


def _finite(means):
    return all(np.isfinite(v) for v in means.values())


def test_synthetic_canonical_epoch(tmp_path):
    out = str(tmp_path / "syn")
    hist = train_temporal.main(
        ["--config", "cfgs/skirt.yaml", "--synthetic_data", "1", "--GarmentPCA", "1",
         "--batch_size", "1", "--T", "2", "--npoints", "512", "--epoch_num", "1",
         "--lr_sche", "--output_dir", out], device="cpu")
    assert len(hist) == 1 and _finite(hist[0]["train"]) and _finite(hist[0]["eval"])
    assert "garment_msre" in hist[0]["eval"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        tags = {l.split('"tag": "')[1].split('"')[0] for l in f}
    assert {"LR", "Eval/01_v_sqrt_l2_loss", "Train/00_garment_l2_loss"} <= tags
    saved = torch.load(os.path.join(out, "ckpt", "model.ckpt"), weights_only=True)
    assert saved["other_state"]["step"] == 2  # two synthetic train batches


def test_disk_fixture_chain(tmp_path, disk):
    """Canonical checkpoint -> posed --fix_PCA epoch -> auto-resume with
    --epoch_num 2 -> --only_eval: the canonical stage bitwise the
    bootstrap's through both epochs, the resume picking up the saved state
    and running epoch 1 only (a checkpoint written after epoch e resumes
    at e + 1), its `Train/*` scalars at the restored step count, the eval
    pass equal to the eval of the epoch its checkpoint holds."""
    torch.manual_seed(0)
    canonical = CanonicalGarmentModel(GarmentAssets.from_files(
        "Skirt", disk["template"], disk["pca"]))
    canon_ckpt = str(tmp_path / "canonical" / "ckpt" / "model.ckpt")
    ckpt.save_checkpoint(canon_ckpt, make_state_for(canonical, lr=1e-3), 0, {"best_v_l2": 1.0})
    out = str(tmp_path / "posed")
    posed_args = _disk_args(disk, out, "--GarmentPCALBS", "1", "--fix_PCA", "1",
                            "--GarmentPCA_pretrain", canon_ckpt, "--epoch_num", "1",
                            "--lr", "1e-3")
    posed_ckpt = os.path.join(out, "ckpt", "model.ckpt")

    def saved():
        return torch.load(posed_ckpt, weights_only=True)

    hist = train_temporal.main(posed_args, device="cpu")
    assert _finite(hist[0]["train"]) and "lbs_garment_msre" in hist[0]["eval"]
    first = saved()
    assert first["other_state"]["step"] == 1
    want = canonical.state_dict()
    for k, v in want.items():
        assert torch.equal(first["model_state"][f"canonical.{k}"], v), k

    resumed = train_temporal.main(posed_args + ["--epoch_num", "2"], device="cpu")
    assert [h["epoch"] for h in resumed] == [1] and _finite(resumed[0]["train"])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        steps = [json.loads(l)["step"] for l in f if '"Train/' in l]
    n_keys = len(steps) // 2
    assert steps == [0] * n_keys + [1] * n_keys  # epoch 0's step, then the restored count
    second = saved()
    if second["epoch"] == 1:  # epoch 1 a new best: saved on top of the restored step
        assert second["other_state"]["step"] == 2
    else:
        assert second["epoch"] == 0 and second["other_state"]["step"] == 1
    for k, v in want.items():
        assert torch.equal(second["model_state"][f"canonical.{k}"], v), k

    means = train_temporal.main(
        _disk_args(disk, str(tmp_path / "eval"), "--GarmentPCALBS", "1", "--only_eval", "1",
                   "--pretrained_model", posed_ckpt), device="cpu")
    logged = {h["epoch"]: h for h in hist + resumed}[second["epoch"]]["eval"]
    assert sorted(means) == sorted(logged)
    for k, v in logged.items():
        assert means[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k


@pytest.mark.parametrize("flag,stage", [("--bf16", "--GarmentPCA"), ("--remat", "--GarmentPCALBS"),
                                        ("--debug_nans", "--GarmentPCALBS")],
                         ids=["bf16", "remat", "debug_nans"])
def test_flag_reaches_the_model(tmp_path, monkeypatch, caplog, flag, stage):
    """`--bf16 1`, `--remat 1` and `--debug_nans 1` through `main` on
    synthetic data, one epoch: the model the steps get computes in bf16,
    is the plain fp32 posed model (`--remat` logged as a no-op), or
    carries the NaN tripwire's hooks (and the steps its checks); the
    epoch's losses are finite."""
    built = {}

    def recorder(make):
        def wrapped(model, *args, **kwargs):
            wire = kwargs.get("tripwire")
            built.update(model=model, watched=wire.modules if wire else None)
            return make(model, *args, **kwargs)
        return wrapped

    for name in ("make_canonical_steps", "make_posed_steps"):
        monkeypatch.setattr(train_temporal, name, recorder(getattr(train_temporal, name)))
    with caplog.at_level(logging.INFO, logger="garment4d_tpu_torch"):
        hist = train_temporal.main(
            ["--config", "cfgs/skirt.yaml", "--synthetic_data", "1", stage, "1", flag, "1",
             "--batch_size", "1", "--T", "2", "--npoints", "512", "--epoch_num", "1",
             "--output_dir", str(tmp_path / "out")], device="cpu")
    assert len(hist) == 1 and _finite(hist[0]["train"]) and _finite(hist[0]["eval"])
    model = built["model"]
    if flag == "--bf16":
        assert model.compute_dtype == torch.bfloat16
        assert model.pointnet.sa1.mlp0.layer0.bn.compute_dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in model.parameters())
    elif flag == "--remat":
        assert type(model).__name__ == "PosedGarmentModel" and built["watched"] is None
        assert model.canonical.compute_dtype is None
        assert "--remat 1: a no-op" in caplog.text
    else:
        assert built["watched"] == len(list(model.modules()))


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default does not raise")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_temporal.main(["--config", "cfgs/skirt.yaml", "--synthetic_data", "1",
                             "--GarmentPCA", "1", "--output_dir", str(tmp_path / "out")])


def test_config_widths_build_the_posed_model(disk, tmp_path):
    """NETWORK.LBSK and NETWORK.ITERATION reach the posed model the entry
    point builds: at 2 iterations its state_dict names are the JAX model's
    variables (through `flax_to_torch`)."""
    cfg = str(tmp_path / "two.yaml")
    with open(disk["cfg"]) as f, open(cfg, "w") as g:
        g.write(f.read().replace("  LBSK: 16\n", "  LBSK: 24\n  ITERATION: 2\n"))
    argv = _disk_args(disk, str(tmp_path / "out"), "--GarmentPCALBS", "1")
    argv[argv.index("--config") + 1] = cfg
    args, config = train_temporal.parse_args(argv)
    assert (config.NETWORK.LBSK, config.NETWORK.ITERATION) == (24, 2)
    assets = GarmentAssets.from_files("Skirt", disk["template"], disk["pca"])
    body = tsmpl.load_smpl(os.path.join(disk["smpl_dir"], "SMPL_MALE.npz"), device="cpu")
    state, _ = train_temporal._make_state(args, config, assets, body, torch.device("cpu"),
                                          loop.make_logger())
    assert (state.model.lbs_k, state.model.iterations) == (24, 2)

    jassets = JAssets.from_files("Skirt", disk["template"], disk["pca"])
    jbody = jsmpl.load_smpl(os.path.join(disk["smpl_dir"], "SMPL_MALE.npz"))
    batch = jmake_batch(jassets, jbody, batch_size=1, T=2, npoints=256)
    jmodel = JPosed(assets=jassets, body_faces=jbody.faces, lbs_k=24, iterations=2)
    shapes = jax.eval_shape(lambda p, b: jmodel.init(jax.random.PRNGKey(0), p, b, train=False),
                            batch["pcd"], jbody_inputs(batch))
    flat = {f"{coll}/{k}": np.zeros(v.shape, np.float32) for coll in ("params", "batch_stats")
            for k, v in traverse_util.flatten_dict(shapes[coll], sep="/").items()}
    assert set(flax_to_torch(flat)) == set(state.model.state_dict())


def test_canonical_eval_epoch_matches_jax(disk):
    """One disk-fixture batch (the sequence's three eval windows, completed
    by each package's `finalize_batch`) through each package's
    `eval_one_epoch` and canonical eval step, at the weights of one JAX
    init: every mean within 1e-4 relative."""
    tassets = GarmentAssets.from_files("Skirt", disk["template"], disk["pca"])
    jassets = JAssets.from_files("Skirt", disk["template"], disk["pca"])
    paths = tcloth3d.Cloth3dPaths(root=disk["root"],
                                  template_prefix=os.path.join(disk["root"], "CLOTH3D_template"))
    ds = tcloth3d.Cloth3dDataset(paths, disk["lists"]["eval"], "Skirt", T=T, npoints=512,
                                 is_train=False, body_verts=NB)
    raw = ds.collate([ds.raw_item(i) for i in range(BATCH)])
    smpl_paths = {g: os.path.join(disk["smpl_dir"], f"SMPL_{g.upper()}.npz")
                  for g in ("male", "female")}
    tbodies = {g: tsmpl.load_smpl(p, device="cpu") for g, p in smpl_paths.items()}
    jbodies = {g: jsmpl.load_smpl(p) for g, p in smpl_paths.items()}
    tbatch = tcloth3d.finalize_batch(raw, tbodies)
    jbatch = jcloth3d.finalize_batch(raw, jbodies)

    jmodel = JCanonical(assets=jassets)
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jbatch["pcd"], train=False)
    flat = {f"{coll}/{k}": np.asarray(v) for coll in ("params", "batch_stats")
            for k, v in traverse_util.flatten_dict(variables[coll], sep="/").items()}
    model = CanonicalGarmentModel(tassets)
    model.load_state_dict(flax_to_torch(flat), strict=True)

    _, jeval = jmake_canonical_steps(jmodel, jassets, jbodies["male"].faces, JLossWeights())
    jmeans = jloop.eval_one_epoch(jmake_state_for(jmodel, variables, jassets, lr=1e-3),
                                  [jbatch], jeval)
    _, teval = make_canonical_steps(model, tassets, tbodies["male"].faces)
    tmeans = loop.eval_one_epoch(make_state_for(model, lr=1e-3), [tbatch], teval)
    assert sorted(tmeans) == sorted(jmeans) and "garment_msre" in tmeans
    for k, v in jmeans.items():
        assert tmeans[k] == pytest.approx(v, rel=1e-4, abs=1e-7), k
