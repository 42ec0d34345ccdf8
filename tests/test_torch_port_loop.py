"""The port's training loop and checkpoints, on the CPU, without model steps.

- The loop against the JAX package's with scripted steps: the same loss
  dicts and `valid_mask`s through both packages' `fit` (and so
  `train_one_epoch` / `eval_one_epoch`) give the same history, the same
  `metrics.jsonl` lines (the plateau's `LR` scales among them; the port
  writes `Train/*` at the step count, epoch * steps + i, where the JAX
  package writes i) and the same `save_fn` calls.
- Checkpoints on the port's real canonical and posed models (8 x 12 ring,
  300-vertex body): save -> restore bitwise on weights, BatchNorm
  statistics, Adam's moments and step counts, `step`, `lr_scale`, `epoch`
  and `other_state`; `load_pretrained` with a `module.` prefix, from a Flax
  npz, and its refusal when no tensor matches; `bootstrap_canonical`, and
  its refusal of another PCADIM or an `--only_seg` checkpoint.
- Resume: `fit` for three epochs equals one epoch, its saved checkpoint
  restored into a fresh state, and `fit` again from the epoch after the
  checkpoint's with the same data functions, bitwise: weights, Adam, the
  dropout generator (a stand-in model with seeded dropout), the plateau,
  the history and the `Train/*` step indices. Here the port differs from
  the JAX package, whose `fit` counts from epoch 0 again.
- The loader threads give the items of a synchronous read, bitwise.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from garment4d_tpu.train import loop as jloop
from garment4d_tpu.train.state import create_train_state as jcreate_state

from garment4d_tpu_torch import smpl as tsmpl
from garment4d_tpu_torch.data.cloth3d import Cloth3dDataset, Cloth3dPaths
from garment4d_tpu_torch.data.fixture import write_fixture
from garment4d_tpu_torch.data.pipeline import ParallelItemLoader, prefetch_iterator
from garment4d_tpu_torch.models import CanonicalGarmentModel, GarmentAssets, PosedGarmentModel
from garment4d_tpu_torch.nn.layers import BatchNorm
from garment4d_tpu_torch.train import checkpoint as ckpt
from garment4d_tpu_torch.train import loop
from garment4d_tpu_torch.train.convert import load_npz
from garment4d_tpu_torch.train.state import PlateauScheduler, TrainState
from garment4d_tpu_torch.train.step import make_state_for
from torch_port_threads import one_torch_thread  # noqa: F401

POSED_NPZ = "ckpt_synth/posed_synth.npz"


# ---- the loop against JAX's, scripted steps ------------------------------------


def _scripted(epochs=11, train_batches=2, seed=0):
    """Per epoch: train loss dicts, and eval batches (loss dict, mask or
    None, batch size). The eval metric is 5 at epoch 0, 4 after: the plateau
    (patience 8) cuts the scale at epoch 10; a (3,)-shaped entry is not a
    scalar and is left out of the means."""
    rng = np.random.RandomState(seed)

    def losses(metric=None):
        d = {k: np.float32(rng.rand() * 10) for k in ("total_loss", "lbs_garment_l2_loss",
                                                       "lbs_garment_msre")}
        if metric is not None:
            d["lbs_garment_msre"] = np.float32(metric)
        d["per_frame"] = rng.rand(3).astype(np.float32)
        return d

    plan = []
    for e in range(epochs):
        metric = 5.0 if e == 0 else 4.0
        plan.append(([losses() for _ in range(train_batches)],
                     [(losses(metric), None, 3),
                      (losses(metric), np.array([1, 0, 1], np.float32), 3)]))
    return plan


def _run_torch(plan, out):
    model = torch.nn.Linear(1, 1)
    state = TrainState(model=model, optimizer=torch.optim.Adam(model.parameters()), lr=1e-3)
    saved, generators = [], set()

    def train_step(st, batch, generator):
        assert st is state and isinstance(generator, torch.Generator)
        generators.add((id(generator), str(generator.device)))
        st.step += 1  # as `apply_gradients`
        return {k: torch.from_numpy(np.asarray(v)) for k, v in batch["losses"].items()}

    def eval_step(st, batch):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in batch["losses"].items()}

    def batches(e, split):
        if split == "train":
            return [{"losses": d} for d in plan[e][0]]
        return [dict({"losses": d, "pcd": torch.zeros(b, 1)},
                     **({} if m is None else {"valid_mask": torch.from_numpy(m)}))
                for d, m, b in plan[e][1]]

    state, history = loop.fit(
        state, lambda e: batches(e, "train"), lambda e: batches(e, "eval"), train_step,
        eval_step, epochs=len(plan), output_dir=out, use_plateau=True,
        eval_metric="lbs_garment_msre",
        save_fn=lambda st, e, best: saved.append((e, best, st.lr_scale)))
    assert generators == {(next(iter(generators))[0], "cpu")}  # one generator, every step
    return state.lr_scale, history, saved


def _run_jax(plan, out):
    state = jcreate_state({"w": jnp.zeros((1,))}, {}, lr=1e-3)
    saved = []

    def train_step(st, batch, rng):
        return st, {k: jnp.asarray(v) for k, v in batch["losses"].items()}

    def eval_step(st, batch):
        return {k: jnp.asarray(v) for k, v in batch["losses"].items()}

    def batches(e, split):
        if split == "train":
            return [{"losses": d} for d in plan[e][0]]
        return [dict({"losses": d, "pcd": np.zeros((b, 1), np.float32)},
                     **({} if m is None else {"valid_mask": m}))
                for d, m, b in plan[e][1]]

    state, history = jloop.fit(
        state, lambda e: batches(e, "train"), lambda e: batches(e, "eval"), train_step,
        eval_step, epochs=len(plan), output_dir=out, use_plateau=True,
        eval_metric="lbs_garment_msre",
        save_fn=lambda st, e, best: saved.append((e, best, float(st.lr_scale))))
    return float(state.lr_scale), history, saved


def _jsonl(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return f.read().splitlines()


def test_loop_matches_jax_with_scripted_steps(tmp_path):
    plan = _scripted()
    tout, jout = str(tmp_path / "torch"), str(tmp_path / "jax")
    t_scale, t_hist, t_saved = _run_torch(plan, tout)
    j_scale, j_hist, j_saved = _run_jax(plan, jout)
    assert t_hist == j_hist
    t_lines = [json.loads(l) for l in _jsonl(tout)]
    j_lines = [json.loads(l) for l in _jsonl(jout)]
    assert [(l["tag"], l["value"]) for l in t_lines] == [(l["tag"], l["value"]) for l in j_lines]
    epoch = 0
    for t, j in zip(t_lines, j_lines):
        if t["tag"].startswith("Train/"):  # 2 train batches an epoch
            assert t["step"] == epoch * 2 + j["step"], (t, j)
        else:
            assert t["step"] == j["step"] == epoch, (t, j)
            epoch += t["tag"] == "LR"
    assert [s[:2] for s in t_saved] == [s[:2] for s in j_saved] == [(0, 5.0), (1, 4.0)]
    assert t_scale == pytest.approx(0.1, rel=1e-12) and j_scale == pytest.approx(0.1, rel=1e-6)
    lr = [json.loads(l)["value"] for l in _jsonl(tout) if json.loads(l)["tag"] == "LR"]
    assert lr == [1.0] * 10 + [t_scale]
    # the masked eval batch weighs 2, the unmasked one its 3 rows
    e0 = plan[0][1]
    want = (float(e0[0][0]["total_loss"]) * 3 + float(e0[1][0]["total_loss"]) * 2) / 5
    assert t_hist[0]["eval"]["total_loss"] == want
    assert "per_frame" not in t_hist[0]["train"]


def test_host_scalars_reads_exact_values():
    d = {"a": torch.tensor(0.1, dtype=torch.float32), "v": torch.ones(3),
         "b": torch.tensor(1 / 3, dtype=torch.float64)}
    got = loop.host_scalars(d, torch.tensor([1.0, 0.0, 1.0]).sum())
    assert got == ({"a": float(np.float32(0.1)), "b": 1 / 3}, [2.0])
    assert loop.host_scalars({"v": torch.ones(3)}) == ({}, [])


# ---- checkpoints on the port's models -------------------------------------------


@pytest.fixture(scope="module")
def small():
    assets = GarmentAssets.synthetic(num_rings=8, ring_size=12)
    body = tsmpl.synthetic_smpl(num_verts=300, device="cpu")
    return assets, body


def _model(kind, small, seed):
    assets, body = small
    torch.manual_seed(seed)
    if kind == "canonical":
        return CanonicalGarmentModel(assets)
    return PosedGarmentModel(assets, body.faces, lbs_k=16)


def _trained_state(kind, small, seed=0):
    """A train state after one Adam update from seeded gradients, with
    BatchNorm statistics off their init and the schedule moved."""
    model = _model(kind, small, seed)
    state = make_state_for(model, lr=1e-3, freeze_canonical=kind == "posed")
    rng = np.random.RandomState(seed)
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
    state.apply_gradients()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(torch.from_numpy(rng.randn(m.num_features).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.rand(m.num_features).astype(np.float32)))
                m.num_batches_tracked.fill_(7)
    state.lr_scale = 0.1
    return state


def _assert_state_dicts_equal(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def _assert_optimizers_equal(got, want):
    g, w = got.state_dict(), want.state_dict()
    assert g["param_groups"] == w["param_groups"]
    assert sorted(g["state"]) == sorted(w["state"])
    for i, ws in w["state"].items():
        assert sorted(g["state"][i]) == sorted(ws)
        for k, v in ws.items():
            assert torch.equal(g["state"][i][k], v), (i, k)


@pytest.mark.parametrize("kind", ["canonical", "posed"])
def test_checkpoint_round_trip_bitwise(tmp_path, small, kind):
    state = _trained_state(kind, small)
    path = str(tmp_path / "ckpt" / "model.ckpt")
    ckpt.save_checkpoint(path, state, 3, {"best_v_l2": 0.25})
    payload = torch.load(path, weights_only=True)
    assert sorted(payload) == ["epoch", "model_state", "optimizer_state", "other_state"]
    assert payload["other_state"] == {"best_v_l2": 0.25, "step": 1, "lr_scale": 0.1}

    fresh = make_state_for(_model(kind, small, seed=1), lr=1e-3,
                           freeze_canonical=kind == "posed")
    fresh, epoch, other = ckpt.restore_checkpoint(path, fresh)
    assert (epoch, other, fresh.step, fresh.lr_scale) == (3, {"best_v_l2": 0.25}, 1, 0.1)
    _assert_state_dicts_equal(fresh.model.state_dict(), state.model.state_dict())
    _assert_optimizers_equal(fresh.optimizer, state.optimizer)
    if kind == "posed":
        assert not any(p.requires_grad for p in fresh.model.canonical.parameters())


def test_load_pretrained(tmp_path, small):
    """A `module.`-prefixed port checkpoint and a Flax variables npz load
    every tensor; a file of other key names (the reference's) raises."""
    want = _trained_state("canonical", small).model.state_dict()
    path = str(tmp_path / "prefixed.ckpt")
    torch.save({"model_state": {f"module.{k}": v for k, v in want.items()}}, path)
    model = _model("canonical", small, seed=2)
    report = ckpt.load_pretrained(path, model)
    assert report == {"loaded": sorted(want), "skipped": []}
    _assert_state_dicts_equal(model.state_dict(), want)

    posed = _model("posed", small, seed=2)
    report = ckpt.load_pretrained(POSED_NPZ, posed)
    flax = load_npz(POSED_NPZ)
    assert report["loaded"] == sorted(flax) and report["skipped"] == []
    _assert_state_dicts_equal({k: posed.state_dict()[k] for k in flax}, flax)

    odd = str(tmp_path / "odd.ckpt")
    torch.save({"model_state": {**{f"module.{k}": v for k, v in want.items()},
                                "extra.weight": torch.zeros(2),
                                "pca_head0.conv.weight": torch.zeros(3, 3)}}, odd)
    model = _model("canonical", small, seed=3)
    report = ckpt.load_pretrained(odd, model)
    assert report["skipped"] == ["extra.weight", "pca_head0.conv.weight"]
    assert len(report["loaded"]) == len(want)

    reference = str(tmp_path / "reference.ckpt")
    torch.save({"epoch": 1, "model_state": {
        "module.garment_encoder.SA_modules.0.mlps.0.layer0.conv.weight": torch.zeros(32, 6, 1, 1)},
        "optimizer_state": {}, "other_state": {}}, reference)
    with pytest.raises(KeyError, match="none of its 1 tensors"):
        ckpt.load_pretrained(reference, _model("canonical", small, seed=3))


def test_bootstrap_canonical(tmp_path, small):
    canonical = _trained_state("canonical", small)
    path = str(tmp_path / "canonical" / "model.ckpt")
    ckpt.save_checkpoint(path, canonical, 0, {"best_v_l2": 1.0})
    posed = _model("posed", small, seed=4)
    rest = {k: v.clone() for k, v in posed.state_dict().items() if not k.startswith("canonical.")}
    report = ckpt.bootstrap_canonical(path, posed)
    assert report["loaded"] == sorted(canonical.model.state_dict())
    _assert_state_dicts_equal(posed.canonical.state_dict(), canonical.model.state_dict())
    _assert_state_dicts_equal(
        {k: v for k, v in posed.state_dict().items() if not k.startswith("canonical.")}, rest)


@pytest.mark.parametrize("other", ["pca_dim", "only_seg"])
def test_bootstrap_canonical_refuses_another_stage(tmp_path, small, other):
    """A canonical checkpoint of another PCADIM (the PCA head's last layer
    another shape) or of an `--only_seg` run (no garment encoder, no PCA
    head) raises, and the posed model keeps every tensor."""
    assets, _ = small
    torch.manual_seed(5)
    if other == "pca_dim":
        canonical = CanonicalGarmentModel(GarmentAssets.synthetic(num_rings=8, ring_size=12,
                                                                  pca_dim=32))
        match = r"missing \[\], unexpected \[\], shapes differ \['pca_head2\.conv\.bias', "
    else:
        canonical = CanonicalGarmentModel(assets, only_seg=True)
        match = r"missing \['garment_sa1\..*'pca_head2\.conv\.weight'\], unexpected \[\]"
    path = str(tmp_path / "model.ckpt")
    ckpt.save_checkpoint(path, make_state_for(canonical, lr=1e-3), 0)
    posed = _model("posed", small, seed=4)
    before = {k: v.clone() for k, v in posed.state_dict().items()}
    with pytest.raises(KeyError, match=match):
        ckpt.bootstrap_canonical(path, posed)
    _assert_state_dicts_equal(posed.state_dict(), before)


# ---- resume ---------------------------------------------------------------------


class StandIn(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 3)
        self.bn = BatchNorm(3)

    def forward(self, x):
        return self.bn(self.lin(x))


def _stand_in_steps():
    def train_step(state, batch, generator):
        state.model.train()
        # seeded dropout on the inputs: the generator's draws reach the loss
        keep = torch.rand(batch["x"].shape, generator=generator) >= 0.3
        loss = ((state.model(batch["x"] * keep / 0.7) - batch["y"]) ** 2).mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        return {"total_loss": loss.detach()}

    @torch.no_grad()
    def eval_step(state, batch):
        state.model.eval()
        return {"total_loss": ((state.model(batch["x"]) - batch["y"]) ** 2).mean()}

    return train_step, eval_step


def _batches(epoch, split):
    rng = np.random.RandomState(epoch * 10 + (split == "eval"))
    return [{"x": torch.from_numpy(rng.randn(5, 4).astype(np.float32)),
             "y": torch.from_numpy(rng.randn(5, 3).astype(np.float32))} for _ in range(3)]


def _stand_in_state(seed):
    torch.manual_seed(seed)
    return make_state_for(StandIn(), lr=1e-2)


def _train_lines(out):
    return [(l["tag"], l["value"], l["step"]) for l in map(json.loads, _jsonl(out))
            if l["tag"].startswith("Train/")]


def test_resume_equals_straight_run(tmp_path):
    """Three epochs straight equal one epoch, its checkpoint restored into
    a fresh state, and `fit` from the epoch after the checkpoint's with the
    same data functions: the restored run continues the dropout
    generator, the plateau (patience 0: epoch 2 does not improve on epoch
    1, so the resumed part cuts the scale) and the step count (`Train/*` at
    epoch * 3 + i)."""
    train_step, eval_step = _stand_in_steps()
    train_fn, eval_fn = (lambda e: _batches(e, "train")), (lambda e: _batches(e, "eval"))

    def run(state, out, epochs, save_fn=None, **resume):
        plateau = PlateauScheduler(patience=0)
        if state.plateau is None:
            state.plateau = dataclasses.asdict(plateau)
        return loop.fit(state, train_fn, eval_fn, train_step, eval_step, epochs=epochs,
                        use_plateau=True, output_dir=str(out), save_fn=save_fn, seed=7,
                        **resume)

    straight, s_hist = run(_stand_in_state(0), tmp_path / "straight", 3)

    path = str(tmp_path / "ckpt" / "model.ckpt")
    saves = []

    def save_fn(st, e, best):
        saves.append(e)
        ckpt.save_checkpoint(path, st, e, {"best_v_l2": best})

    first, f_hist = run(_stand_in_state(0), tmp_path / "resumed", 1, save_fn)
    assert saves == [0]
    resumed, epoch, other = ckpt.restore_checkpoint(path, _stand_in_state(1))
    assert epoch == 0 and resumed.step == 3
    assert torch.equal(resumed.generator_state, first.generator_state)
    assert resumed.plateau == first.plateau
    resumed, r_hist = run(resumed, tmp_path / "resumed", 3, start_epoch=epoch + 1,
                          best=other["best_v_l2"])
    assert [h["epoch"] for h in r_hist] == [1, 2]
    assert f_hist + r_hist == s_hist
    assert resumed.step == straight.step == 9
    assert resumed.lr_scale == straight.lr_scale == pytest.approx(0.1, rel=1e-12)
    assert resumed.plateau == straight.plateau
    assert torch.equal(resumed.generator_state, straight.generator_state)
    _assert_state_dicts_equal(resumed.model.state_dict(), straight.model.state_dict())
    _assert_optimizers_equal(resumed.optimizer, straight.optimizer)
    assert _train_lines(tmp_path / "resumed") == _train_lines(tmp_path / "straight")
    assert [s for _, _, s in _train_lines(tmp_path / "straight")] == list(range(9))


# ---- loader threads ---------------------------------------------------------------


def test_loader_threads_match_synchronous_reads(tmp_path):
    root = str(tmp_path / "tree")
    lists = write_fixture(root, GarmentAssets.synthetic(name="Skirt", num_rings=8, ring_size=12),
                          num_seqs=2, frames_per_seq=6)
    paths = Cloth3dPaths(root=root, template_prefix=os.path.join(root, "CLOTH3D_template"))
    index_batches = [[0, 3, 1], [5, 2, 4], [1]]
    got = {}
    for workers in (0, 2):
        ds = Cloth3dDataset(paths, lists["eval"], "Skirt", T=3, npoints=512, is_train=False,
                            body_verts=300)
        loader = ParallelItemLoader(ds.raw_item, num_workers=workers, prefetch_batches=1)
        try:
            got[workers] = list(loader.map_batches(index_batches))
        finally:
            loader.close()
    assert [len(b) for b in got[2]] == [3, 3, 1]
    for b0, b2 in zip(got[0], got[2]):
        for i0, i2 in zip(b0, b2):
            assert list(i0) == list(i2)
            for k in i0:
                assert np.asarray(i0[k]).tobytes() == np.asarray(i2[k]).tobytes(), k


def test_prefetch_iterator_keeps_order_and_raises():
    assert list(prefetch_iterator(lambda: iter(range(7)), depth=2)) == list(range(7))

    def failing():
        yield 1
        raise ValueError("read failed")

    it = prefetch_iterator(failing)
    assert next(it) == 1
    with pytest.raises(ValueError, match="read failed"):
        next(it)
