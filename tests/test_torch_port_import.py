"""The port's loader of the reference's torch checkpoints
(`garment4d_tpu_torch/train/torch_import.py`), on the CPU.

The reference's three networks are built class for class with the released
checkpoints' key names (`torch_ref_mirror.py`: the canonical stage
`PCAGarmentEncoderSeg`, the posed stage `PCALBSGarmentUseSegEncoderSeg` at
lbs_k 72, so the K and K64 transfers differ, and its MGN variant), every
parameter and BatchNorm statistic drawn from a seed. Each state_dict is
imported into the port's model and into the JAX package's
(`import_torch_checkpoint`), and all three run one input:

- every key maps onto the port's model with its shape, and every tensor of
  the port's model is filled but `num_batches_tracked`;
- the port matches the mirror within the JAX package's own tolerances for
  it (`test_reference_parity.py`): the canonical outputs rtol 1e-3 / atol
  1e-4 (segmentation logits 1e-4, the garment points 1e-5), the LBS
  results rtol 1e-3 / atol 2e-4, the refinement iterations rtol 2e-3 /
  atol 1e-3;
- the port matches the JAX package within 1e-5 on the canonical
  `tpose_garment` and `lbs.posed_garment` and within 1e-4 on the last
  `iter_garment_v` (fp32 roundoff of the same arithmetic);
- a transposed square GCN weight moves the port's output by more than 1e-2,
  so the comparisons see a wrong orientation;
- a file in the reference's layout (`module.` prefixes, `{epoch,
  model_state, optimizer_state, other_state}`) is read as the JAX package
  reads it, by torch and by the numpy-only reader, and loads through
  `load_pretrained`, `bootstrap_canonical` and `from_assets(checkpoint=)`.

The head's last bias is moved so that about half of the points take the
garment's label: with all-random weights every point takes one class, and
the garment encoder would see no point.

Shapes are small: the 96-vertex ring garment (`synthetic(8, 12)`, PCA
dimension 16), a 512-vertex synthetic body, B=1, T=2, N=1024 points.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

import jax

from garment4d_tpu import smpl as jsmpl
from garment4d_tpu.data.synthetic import make_batch as jmake_batch
from garment4d_tpu.models import CanonicalGarmentModel as JCanonical
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.models import MgnGarmentModel as JMgn
from garment4d_tpu.models import PosedGarmentModel as JPosed
from garment4d_tpu.train.step import body_inputs_from_batch as jbody_inputs
from garment4d_tpu.train.torch_import import import_torch_checkpoint, load_torch_state_dict

from garment4d_tpu_torch import smpl as tsmpl
from garment4d_tpu_torch.api import GarmentReconstructor
from garment4d_tpu_torch.models import CanonicalGarmentModel, MgnGarmentModel, PosedGarmentModel
from garment4d_tpu_torch.train import checkpoint as ckpt
from garment4d_tpu_torch.train import torch_import as ti
from garment4d_tpu_torch.train.step import body_inputs_from_batch as tbody_inputs
from test_reference_parity import _randomize
from test_torch_port_posed import _port_assets, _t
from torch_port_threads import one_torch_thread  # noqa: F401
from torch_ref_mirror import (
    PCAGarmentEncoderSeg,
    PCALBSGarmentUseSegEncoderSeg,
    PCALBSGarmentUseSegEncoderSegMGN,
)

B, T, N, NB, LBS_K = 1, 2, 1024, 512, 72
KINDS = ("canonical", "posed", "mgn")


def _np(x):
    return x.detach().numpy()


@pytest.fixture(scope="module")
def world():
    jassets = JAssets.synthetic(name="Skirt", num_rings=8, ring_size=12, pca_dim=16)
    jbody = jsmpl.synthetic_smpl(num_verts=NB)
    tbody = tsmpl.SmplModel(**{f.name: getattr(jbody, f.name) if f.name in ("parents", "faces")
                               else _t(getattr(jbody, f.name))
                               for f in dataclasses.fields(tsmpl.SmplModel)})
    batch = jmake_batch(jassets, jbody, batch_size=B, T=T, npoints=N, seed=5)
    return dict(jassets=jassets, assets=_port_assets(jassets), jbody=jbody, tbody=tbody,
                batch=batch, tbatch={k: _t(v) for k, v in batch.items()})


def _mirror(kind, world):
    a, jbody = world["jassets"], world["jbody"]
    pca = (a.pca_components, a.pca_mean, a.pca_scale)
    if kind == "canonical":
        return PCAGarmentEncoderSeg("Skirt", *pca)
    if kind == "posed":
        return PCALBSGarmentUseSegEncoderSeg("Skirt", *pca, garment_faces=a.faces,
                                             body_faces_tri=jbody.faces,
                                             parents=jbody.parents, lbs_k=LBS_K)
    return PCALBSGarmentUseSegEncoderSegMGN("Skirt", *pca, garment_faces=a.faces,
                                            parents=jbody.parents)


def _port_model(kind, world):
    if kind == "canonical":
        return CanonicalGarmentModel(world["assets"])
    if kind == "posed":
        return PosedGarmentModel(world["assets"], world["jbody"].faces, lbs_k=LBS_K)
    return MgnGarmentModel(world["assets"], world["jbody"].faces)


def _jax_model(kind, world):
    if kind == "canonical":
        return JCanonical(assets=world["jassets"])
    if kind == "posed":
        return JPosed(assets=world["jassets"], body_faces=world["jbody"].faces, lbs_k=LBS_K,
                      iterations=3)
    return JMgn(assets=world["jassets"])


def _balance_labels(canonical, pcd):
    """Move the head's last bias so that about half of the points take the
    garment's label (the median margin to the best other class)."""
    with torch.no_grad():
        _, logits, _, _ = canonical.pointnet(pcd.reshape(B * T, N, 3))
        g = canonical.garment_label
        others = torch.cat([logits[..., :g], logits[..., g + 1:]], dim=-1).amax(-1)
        canonical.pointnet.FC_layer[2].conv.bias[g] += (others - logits[..., g]).median()


def _jax_variables(model, args, jassets, jbody):
    """Variables of the JAX model for a strict import: params and
    statistics zero (the import fills every one), the constants as the
    model builds them; shapes from an abstract init (no compile)."""
    shapes = jax.eval_shape(
        lambda *a: model.init(jax.random.PRNGKey(0), *a, train=False), *args)

    def constant(path, leaf):
        name = path[-1].key
        value = (np.asarray(jbody.faces, np.int32) if name == "body_faces"
                 else np.asarray(getattr(jassets, name)))
        assert value.shape == leaf.shape, name
        return jax.numpy.asarray(value, leaf.dtype)

    zeros = {c: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes[c])
             for c in ("params", "batch_stats")}
    return dict(zeros, constants=jax.tree_util.tree_map_with_path(constant,
                                                                  shapes["constants"]))


@pytest.fixture(scope="module")
def cases(world):
    """kind -> `_case(kind, world)`, each built once."""
    built = {}

    def get(kind):
        if kind not in built:
            built[kind] = _case(kind, world)
        return built[kind]
    return get


@pytest.fixture(params=KINDS)
def case(request, cases):
    return cases(request.param)


def _case(kind, world):
    """One mirror with seeded weights, its forward, the port's model
    imported strictly and its forward, the JAX model's forward of the same
    state_dict (one compile)."""
    ref = _mirror(kind, world)
    _randomize(ref, seed=KINDS.index(kind))
    ref.eval()
    _balance_labels(ref if kind == "canonical" else ref.PCA_garment_encoder,
                    world["tbatch"]["pcd"])
    pcd, tbatch = world["tbatch"]["pcd"], world["tbatch"]
    with torch.no_grad():
        want = ref(pcd) if kind == "canonical" else ref(pcd, tbatch)
    sd = ref.state_dict()
    port = _port_model(kind, world)
    report = ti.import_reference_state_dict(sd, port, strict=True)
    port.eval()
    with torch.no_grad():
        got = port(pcd) if kind == "canonical" else port(pcd, tbody_inputs(tbatch))

    jmodel = _jax_model(kind, world)
    batch = world["batch"]
    args = (batch["pcd"],) if kind == "canonical" else (batch["pcd"], jbody_inputs(batch))
    variables = _jax_variables(jmodel, args, world["jassets"], world["jbody"])
    variables, _ = import_torch_checkpoint({k: _np(v) for k, v in sd.items()}, variables,
                                           strict=True)
    jout = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(variables, *args)
    return dict(kind=kind, ref=ref, sd=sd, want=want, port=port, got=got, report=report,
                jout=jout, variables=variables)


def test_every_key_maps_with_its_shape(case):
    sd, port, report = case["sd"], case["port"], case["report"]
    mappable = [k for k in sd if not k.endswith("num_batches_tracked")]
    assert report["loaded"] == mappable and report["skipped"] == []
    own = port.state_dict()
    targets = [ti.map_reference_key(k) for k in mappable]
    assert len(set(targets)) == len(targets)
    assert set(targets) == {k for k in own if not k.endswith("num_batches_tracked")}
    for key, name in zip(mappable, targets):
        want = sd[key].reshape(own[name].shape)  # 1x1 convolutions lose their unit axes
        assert tuple(sd[key].shape[:2]) == tuple(own[name].shape[:2]), key
        assert torch.equal(own[name], want), key


def test_garment_points_selected(case):
    """The balanced head gives the garment encoder real points."""
    labels = case["got"].backbone.sem_logits.argmax(-1) if case["kind"] == "canonical" \
        else case["got"].canonical.backbone.sem_logits.argmax(-1)
    per_frame = (labels == case["port"].canonical.garment_label
                 if case["kind"] != "canonical" else labels == case["port"].garment_label).sum(-1)
    assert bool((per_frame >= N // 4).all()), per_frame


def test_port_matches_mirror(case):
    got, want, kind = case["got"], case["want"], case["kind"]
    canonical = got if kind == "canonical" else got.canonical
    np.testing.assert_allclose(_np(canonical.backbone.sem_logits).reshape(want["sem_logits"].shape),
                               _np(want["sem_logits"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(canonical.garment_xyz[0]), _np(want["garment_v"]),
                               rtol=1e-5, atol=1e-5)
    for ours, theirs in (("garment_summary", "garment_summary"), ("pca_coeff", "garment_PCA_coeff"),
                         ("tpose_garment", "tpose_garment")):
        np.testing.assert_allclose(_np(getattr(canonical, ours)), _np(want[theirs]),
                                   rtol=1e-3, atol=1e-4, err_msg=ours)
    if kind == "canonical":
        return
    np.testing.assert_allclose(_np(got.lbs.posed_garment), _np(want["lbs_pred_garment_v"]),
                               rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(_np(got.lbs.unposed_garment),
                               _np(want["lbs_stage1_pred_garment_v"]), rtol=1e-3, atol=2e-4)
    assert len(got.iter_garment_v) == len(want["iter_regressed_lbs_garment_v"])
    for i, (g, w) in enumerate(zip(got.iter_garment_v, want["iter_regressed_lbs_garment_v"])):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-3, atol=1e-3,
                                   err_msg=f"iteration {i}")


def test_port_matches_jax(case):
    got, jout, kind = case["got"], case["jout"], case["kind"]
    if kind == "canonical":
        np.testing.assert_allclose(_np(got.tpose_garment), np.asarray(jout.tpose_garment),
                                   rtol=0, atol=1e-5)
        return
    np.testing.assert_allclose(_np(got.canonical.tpose_garment),
                               np.asarray(jout.canonical.tpose_garment), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(got.lbs.posed_garment), np.asarray(jout.lbs.posed_garment),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(got.iter_garment_v[-1]), np.asarray(jout.iter_garment_v[-1]),
                               rtol=0, atol=1e-4)


def test_sensitive_to_gcn_orientation(world, cases):
    """A square (128 x 128) GCN weight loaded transposed passes every shape
    check; the port's refined vertices move by more than 1e-2."""
    case = cases("posed")
    sd = dict(case["sd"])
    key = "lbs_graph_regress1.1.weight"
    assert sd[key].shape[0] == sd[key].shape[1]
    sd[key] = sd[key].t().contiguous()
    bad = _port_model("posed", world)
    ti.import_reference_state_dict(sd, bad, strict=True)
    bad.eval()
    with torch.no_grad():
        out = bad(world["tbatch"]["pcd"], tbody_inputs(world["tbatch"]))
    delta = float((out.iter_garment_v[0] - case["got"].iter_garment_v[0]).abs().max())
    assert delta > 1e-2, f"orientation flip invisible (delta={delta})"


def _save_reference(path, sd, other_state=None):
    torch.save({"epoch": 7, "model_state": {f"module.{k}": v for k, v in sd.items()},
                "optimizer_state": {"state": {}, "param_groups": [{"lr": 1e-3}]},
                "other_state": other_state or {"best_v_l2": 0.5}}, path)


def _equal_dicts(a, b):
    assert list(a) == list(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_readers_match_the_jax_reader(tmp_path, cases):
    """torch's safe reader and the numpy-only reader against the JAX
    package's `load_torch_state_dict`, key for key and bit for bit; a file
    whose other state pickles an object outside torch's safe list loads
    through the numpy-only reader."""
    case = cases("posed")
    safe, unsafe = str(tmp_path / "safe.ckpt"), str(tmp_path / "unsafe.ckpt")
    _save_reference(safe, case["sd"])
    _save_reference(unsafe, case["sd"], {"args": argparse.Namespace(lr=1e-3, T=10)})
    with pytest.raises(Exception):
        torch.load(unsafe, weights_only=True)
    for path in (safe, unsafe):
        want = load_torch_state_dict(path)
        _equal_dicts({k: _np(v) for k, v in ti.load_reference_state_dict(path).items()}, want)
        _equal_dicts(ti._load_torch_zip_numpy(path)["model_state"], want)
    bare = str(tmp_path / "bare.pth")
    torch.save(case["sd"], bare)
    _equal_dicts({k: _np(v) for k, v in ti.load_reference_state_dict(bare).items()},
                 load_torch_state_dict(bare))


def test_reference_file_loads(tmp_path, world, case):
    """A reference-layout file through the port's entry points: the
    loaded model bitwise the strict import."""
    path = str(tmp_path / f"{case['kind']}.ckpt")
    _save_reference(path, case["sd"], {"args": argparse.Namespace(lr=1e-3)})
    mappable = [f"module.{k}" for k in case["sd"] if not k.endswith("num_batches_tracked")]
    want = case["port"].state_dict()

    def same(model):
        own = model.state_dict()
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(own[k], v), k

    model = _port_model(case["kind"], world)
    report = ckpt.load_pretrained(path, model)
    assert report == {"loaded": mappable, "skipped": []}
    same(model)
    if case["kind"] == "canonical":
        posed = _port_model("posed", world)
        assert ckpt.bootstrap_canonical(path, posed)["skipped"] == []
        own = posed.canonical.state_dict()
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(own[k], v), k
    if case["kind"] == "posed":
        recon = GarmentReconstructor.from_assets(world["assets"], world["tbody"], device="cpu",
                                                 lbs_k=LBS_K, checkpoint=path)
        same(recon.model)
        with pytest.raises(KeyError, match="not a canonical stage"):
            ckpt.bootstrap_canonical(path, _port_model("posed", world))


def test_unknown_key_skipped_strict_raises(world, cases):
    case = cases("mgn")
    sd = dict(case["sd"], **{"displacement_encoder.9.weight": torch.zeros(3, 3),
                             "not_a_module.weight": torch.zeros(2)})
    report = ti.import_reference_state_dict(sd, _port_model("mgn", world))
    assert report["skipped"] == ["displacement_encoder.9.weight", "not_a_module.weight"]
    assert len(report["loaded"]) == len(case["report"]["loaded"])
    with pytest.raises(KeyError, match="displacement_encoder.9.weight"):
        ti.import_reference_state_dict(sd, _port_model("mgn", world), strict=True)
    wrong = dict(case["sd"])
    wrong["displacement_encoder.4.bias"] = torch.zeros(7)
    assert ti.import_reference_state_dict(wrong, _port_model("mgn", world))["skipped"] == [
        "displacement_encoder.4.bias"]
    with pytest.raises(ValueError, match="displacement_encoder.4.bias"):
        ti.import_reference_state_dict(wrong, _port_model("mgn", world), strict=True)


def test_mixed_names_raise(tmp_path, world, cases):
    """A file with both the reference's and the port's key names is
    ambiguous."""
    case = cases("mgn")
    path = str(tmp_path / "mixed.pth")
    mixed = dict(case["sd"])
    mixed["displacement.linear0.bias"] = case["port"].state_dict()["displacement.linear0.bias"]
    torch.save(mixed, path)
    with pytest.raises(ValueError, match="both reference-named and port-named"):
        ckpt.load_pretrained(path, _port_model("mgn", world))
