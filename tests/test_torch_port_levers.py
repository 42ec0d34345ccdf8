"""The posed model's opt-in levers in the torch port, on the CPU:
`--spatial_sample` (Morton-ordered sampling, `ops/morton.py`) and
`--candidate_reuse_margin` (the body query's candidate reuse,
`ops.query_group_pe_multi`).

- Morton codes bitwise a numpy reference and the JAX package's codes,
  duplicate points and a flat frame included; `spatial_order` a stable
  permutation.
- The Morton-ordered candidate compaction at B=2, N=1152, M=64 (so the
  compaction runs) against the numpy oracle of tests/test_pallas_kernels.py's
  `TestMortonSpatial`, copied here: the compacted order and the ball-query
  indices bitwise, the PE outputs within rtol 1e-4 / atol 1e-5; the result
  bitwise invariant under a permutation of the centers.
- Candidate reuse: below the margin the state is reused (`centers0` kept),
  beyond it and after an overflow it is rebuilt; the outputs bitwise those
  of a fresh call every time, except under the spatial lever where the
  widened coverage overflows and the plain one does not (then the sample
  is the index-order one); no state without reuse.
- The whole `PosedGarmentModel` with each lever against the JAX model with
  the same lever, on a 400-vertex body (under 1024: neither package
  compacts), every iteration within atol 1e-4; the reuse model bitwise the
  default model on an 1100-vertex body (compacted), with and without the
  spatial lever, reusing its candidates where the iterations move the
  vertices less than the margin; the state dict unchanged.

The JAX side runs its CPU path (no Pallas interpret mode): its morton module
is plain jnp, and its lever models on the CPU use the plain queries.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from garment4d_tpu import smpl as jsmpl
from garment4d_tpu.data.synthetic import make_batch as jmake_batch
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.models import PosedGarmentModel as JPosed
from garment4d_tpu.ops import morton as jmorton
from garment4d_tpu.train.step import body_inputs_from_batch as jbody_inputs

from garment4d_tpu_torch import ops as tops
from garment4d_tpu_torch.api import GarmentReconstructor
from garment4d_tpu_torch.models import PosedGarmentModel
from garment4d_tpu_torch.ops import morton, pemax
from garment4d_tpu_torch.ops import pointcloud as pc
from garment4d_tpu_torch.train.convert import flax_to_torch
from garment4d_tpu_torch.train.step import body_inputs_from_batch as tbody_inputs

from golden import ball_query_ref
from test_torch_port_posed import WEIGHTS, _port_assets, _t
from torch_port_threads import one_torch_thread  # noqa: F401

PE_TOL = dict(rtol=1e-4, atol=1e-5)
RADII, NSAMPLES = (0.2, 0.45), (4, 8)


def _morton_ref(xyz):
    """numpy Morton codes (tests/test_pallas_kernels.py's `_morton_ref`)."""
    lo = xyz.min(1, keepdims=True)
    hi = xyz.max(1, keepdims=True)
    q = np.clip((xyz - lo) / np.maximum(hi - lo, 1e-12) * 1023, 0, 1023).astype(np.int64)

    def spread(v):
        out = np.zeros_like(v)
        for bit in range(10):
            out |= ((v >> bit) & 1) << (3 * bit)
        return out

    return (spread(q[..., 0]) | (spread(q[..., 1]) << 1)
            | (spread(q[..., 2]) << 2)).astype(np.int32)


def _cloud(rng, case):
    xyz = rng.randn(3, 200, 3).astype(np.float32)
    if case == "duplicates":
        xyz[:, 50:60] = xyz[:, 40:50]
    elif case == "flat":  # a degenerate axis quantises to 0
        xyz[:, :, 1] = 0.25
    elif case == "lattice":  # codes on exact quantisation steps
        xyz = (rng.randint(0, 8, size=(3, 200, 3)) / 7.0).astype(np.float32)
    return xyz


@pytest.mark.parametrize("case", ["random", "duplicates", "flat", "lattice"])
def test_morton_codes_bitwise(rng, case):
    xyz = _cloud(rng, case)
    got = morton.morton_codes(_t(xyz))
    assert got.dtype == torch.int32
    want = _morton_ref(xyz)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmorton.morton_codes(jnp.asarray(xyz))))


@pytest.mark.parametrize("case", ["duplicates", "lattice"])
def test_spatial_order_is_stable_permutation(rng, case):
    xyz = _cloud(rng, case)
    perm = morton.spatial_order(_t(xyz))
    assert perm.dtype == torch.int32
    codes = _morton_ref(xyz)
    for b in range(xyz.shape[0]):
        assert sorted(perm[b].tolist()) == list(range(xyz.shape[1]))
        np.testing.assert_array_equal(perm[b].numpy(), np.argsort(codes[b], kind="stable"))
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(jmorton.spatial_order(jnp.asarray(xyz))))


# ---- the body query's levers ------------------------------------------------


def _query_case(rng, B=2, N=1152, M=64, scale=0.6):
    """tests/test_pallas_kernels.py's setup: a cloud, its normals, 56
    centers near the cloud's middle and 8 far from every point; two PE
    blocks."""
    xyz = rng.randn(B, N, 3).astype(np.float32) * scale
    vn = rng.randn(B, N, 3).astype(np.float32)
    ctr = np.concatenate([xyz[:, :M - 8] * 0.2, np.full((B, 8, 3), 30.0, np.float32)],
                         axis=1)
    params = [(rng.randn(6, 32).astype(np.float32) * 0.2, rng.randn(32).astype(np.float32),
               rng.randn(32, 32).astype(np.float32) * 0.2, rng.randn(32).astype(np.float32))
              for _ in NSAMPLES]
    return xyz, vn, ctr, params


def _tparams(params):
    return [tuple(_t(a) for a in p) for p in params]


def _query(xyz, ctr, vn, params, **kw):
    return pemax.query_group_pe_multi(RADII, NSAMPLES, _t(xyz), _t(ctr), _t(vn),
                                      _tparams(params), **kw)


def _outs(xyz, ctr, vn, params, **kw):
    """A call without reuse: its outputs; it carries no state."""
    outs, state = _query(xyz, ctr, vn, params, **kw)
    assert state is None
    return outs


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_query_group_pe_multi_spatial_oracle(rng, monkeypatch):
    """spatial=True against the numpy oracle: candidates covered at the
    largest radius, Morton-ordered over the whole frame's box (ties in
    index order), sentinel-padded; the ball query over that table (indices
    bitwise); the PE math with the no-hit row-0 fix-up."""
    xyz, vn, ctr, params = _query_case(rng)
    B, N, M = xyz.shape[0], xyz.shape[1], ctr.shape[1]
    cap = pemax.candidate_cap(N)
    assert cap == 896
    compactions, queries = [], []

    def record(store, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            store.append(out)
            return out
        return wrapper

    monkeypatch.setattr(pemax, "_compact_candidates",
                        record(compactions, pemax._compact_candidates))
    monkeypatch.setattr(pemax, "ball_query_multi", record(queries, pemax.ball_query_multi))
    got = _outs(xyz, ctr, vn, params, spatial=True)

    packed = np.concatenate([xyz, vn], axis=-1)
    d2 = ((xyz[:, :, None] - ctr[:, None]) ** 2).sum(-1)  # (B, N, M)
    cover = d2.min(-1) < max(RADII) ** 2
    assert (cover.sum(1) < cap).all() and (cover.sum(1) > 0).all()
    keys = np.where(cover, _morton_ref(xyz), np.int32(1 << 30))
    order = np.argsort(keys, kind="stable", axis=1)[:, :cap]
    counts, overflow, compact_idx = compactions[0]
    assert not overflow
    np.testing.assert_array_equal(counts.numpy(), cover.sum(1))
    np.testing.assert_array_equal(compact_idx.numpy(),
                                  np.where(np.arange(cap) < cover.sum(1)[:, None], order, N))
    ctable = np.take_along_axis(xyz, order[..., None], axis=1)
    ctable = np.where(cover.sum(1)[:, None, None] > np.arange(cap)[None, :, None], ctable,
                      np.float32(1e9))
    cpacked = np.take_along_axis(packed, order[..., None], axis=1)
    ctr_pad = np.concatenate([ctr, np.zeros((B, M, 3), np.float32)], axis=-1)
    d0 = ((ctr - ctable[:, 0:1]) ** 2).sum(-1)  # (B, M)
    for g, q, r, s, (k0, b0, k1, b1) in zip(got, queries[0], RADII, NSAMPLES, params):
        idx = ball_query_ref(r, s, ctable, ctr)
        np.testing.assert_array_equal(q.numpy(), idx)
        rows = np.take_along_axis(cpacked, idx.reshape(B, -1, 1), axis=1).reshape(B, M, s, 6)
        qg = rows - ctr_pad[:, :, None, :]
        h = np.maximum(np.einsum("bmsc,cf->bmsf", qg, k0) + b0, 0.0)
        want = np.max(np.einsum("bmsf,fg->bmsg", h, k1) + b1, axis=2)
        no_hit = (idx[:, :, 0] == 0) & ~(d0 < r ** 2)
        assert no_hit[:, M - 8:].all() and not no_hit[:, :M - 8].all()
        qg0 = packed[:, 0][:, None, :] - ctr_pad
        h0 = np.maximum(np.einsum("bmc,cf->bmf", qg0, k0) + b0, 0.0)
        pe0 = np.einsum("bmf,fg->bmg", h0, k1) + b1
        want = np.where(no_hit[..., None], pe0, want)
        np.testing.assert_allclose(g.numpy(), want, **PE_TOL)


@pytest.mark.parametrize("spatial", [False, True])
def test_center_permutation_invariance(rng, spatial):
    """Query-center order is free: the outputs for Morton-sorted centers,
    gathered back by the inverse order, are bitwise those for the centers
    as given (the property the spatial lever's center sort relies on)."""
    xyz, vn, ctr, params = _query_case(rng)
    perm = morton.spatial_order(_t(ctr))
    inv = torch.argsort(perm, dim=1)
    base = _outs(xyz, ctr, vn, params, spatial=spatial)
    got = _outs(xyz, tops.gather_points(_t(ctr), perm).numpy(), vn, params, spatial=spatial)
    _equal([tops.gather_points(g, inv) for g in got], base)


def _unit(rng, shape):
    j = rng.randn(*shape).astype(np.float32)
    return j / np.maximum(np.linalg.norm(j, axis=-1, keepdims=True), 1e-9)


@pytest.mark.parametrize("spatial", [False, True])
def test_reuse_matches_fresh(rng, spatial):
    """Coverage at r_max + margin makes the reused table exact: drift
    below the margin reuses the state (centers0 kept), drift beyond it
    rebuilds it at the new centers; every output bitwise a fresh call's."""
    xyz, vn, ctr0, params = _query_case(rng)
    margin = 0.1

    def fresh(c):
        return _outs(xyz, c, vn, params, spatial=spatial)

    out0, state0 = _query(xyz, ctr0, vn, params, spatial=spatial, reuse_margin=margin)
    _equal(out0, fresh(ctr0))
    assert not state0["overflow"]
    assert int(state0["counts"].min()) > 0
    # the widened coverage holds more candidates than the plain one
    plain = pemax._compact_candidates(_t(xyz), _t(ctr0), max(RADII), 896)[0]
    assert bool((state0["counts"] >= plain).all()) and bool((state0["counts"] > plain).any())

    ctr1 = ctr0 + 0.04 * _unit(rng, ctr0.shape)
    out1, state1 = _query(xyz, ctr1, vn, params, spatial=spatial, candidates=state0,
                          reuse_margin=margin)
    assert state1 is state0  # reused
    assert torch.equal(state1["centers0"], _t(ctr0))
    _equal(out1, fresh(ctr1))

    ctr2 = ctr0.copy()
    ctr2[:, :, 0] += 0.3
    out2, state2 = _query(xyz, ctr2, vn, params, spatial=spatial, candidates=state1,
                          reuse_margin=margin)
    assert state2 is not state1  # rebuilt at the moved centers
    assert torch.equal(state2["centers0"], _t(ctr2))
    _equal(out2, fresh(ctr2))


def test_overflowed_state_rebuilds(rng):
    """A dense cluster covers every point (1152 > the 896-row cap), so the
    build overflows; the next call rebuilds though its drift is below the
    margin (anchored at its own centers), and its outputs are a fresh
    call's."""
    xyz = rng.randn(2, 1152, 3).astype(np.float32) * 0.05
    vn = rng.randn(2, 1152, 3).astype(np.float32)
    ctr0 = xyz[:, :64] * 0.5
    params = _query_case(rng)[3]
    margin = 0.1
    out0, state0 = _query(xyz, ctr0, vn, params, reuse_margin=margin)
    assert state0["overflow"] and "cxyz" not in state0
    _equal(out0, _outs(xyz, ctr0, vn, params))
    ctr1 = ctr0 + 0.01
    out1, state1 = _query(xyz, ctr1, vn, params, candidates=state0, reuse_margin=margin)
    assert state1 is not state0
    assert torch.equal(state1["centers0"], _t(ctr1))
    _equal(out1, _outs(xyz, ctr1, vn, params))


@pytest.mark.parametrize("spatial", [False, True])
def test_reuse_overflow_samples_in_index_order(rng, spatial):
    """A margin whose widened coverage overflows the cap where max(radii)'s
    does not: the call takes the overflow branch, the full set in index
    order. Without the spatial lever that is a fresh call's sample (reuse
    is exact); with it, it is the index-order sample and not the
    Morton-ordered one of a fresh spatial call."""
    xyz, vn, ctr, params = _query_case(rng)
    plain = pemax._compact_candidates(_t(xyz), _t(ctr), max(RADII), 896)[1]
    assert not plain
    out, state = _query(xyz, ctr, vn, params, spatial=spatial, reuse_margin=3.0)
    assert state["overflow"]
    _equal(out, _outs(xyz, ctr, vn, params))
    if spatial:
        fresh = _outs(xyz, ctr, vn, params, spatial=True)
        assert not all(torch.equal(a, b) for a, b in zip(out, fresh))


def test_reuse_state_needs_a_compacted_table(rng):
    """Tables under 1024 rows are not compacted: the state is None, and a
    state without a margin is refused."""
    xyz, vn, ctr, params = _query_case(rng, N=600)
    out, state = _query(xyz, ctr, vn, params, reuse_margin=0.05)
    assert state is None
    _equal(out, _outs(xyz, ctr, vn, params))
    big = _query_case(rng)
    _, state = _query(big[0], big[2], big[1], big[3], reuse_margin=0.05)
    with pytest.raises(ValueError, match="reuse_margin"):
        _query(big[0], big[2], big[1], big[3], candidates=state)


# ---- the whole posed model ------------------------------------------------------


B, T, N = 1, 2, 1024
LBS_K = 16
LEVERS = {"spatial": dict(spatial_sample=True),
          "reuse": dict(candidate_reuse_margin=0.05),
          "both": dict(spatial_sample=True, candidate_reuse_margin=0.05)}


@pytest.fixture(scope="module")
def ring():
    return JAssets.synthetic(num_rings=6, ring_size=8)


def _synth_variables(jassets, jbody):
    """The whole `ckpt_synth/posed_synth.npz` (its shapes do not depend on
    the template's size) as the JAX posed model's variables, with the
    constants the model builds; and the flat npz for `flax_to_torch`."""
    with np.load(WEIGHTS) as data:
        flat = {k: data[k] for k in data.files}
    tree = traverse_util.unflatten_dict(flat, sep="/")
    constants = {
        "body_faces": jnp.asarray(np.asarray(jbody.faces, np.int32)),
        "smooth_op": jnp.asarray(jassets.smooth_op),
        "gcn_adj": jnp.asarray(jassets.gcn_adj),
        "canonical": {k: jnp.asarray(getattr(jassets, k)) for k in
                      ("pca_components", "pca_mean", "pca_scale")},
    }
    return flat, dict(params=tree["params"], batch_stats=tree["batch_stats"],
                      constants=constants)


def _port_model(jassets, jbody, sd, **levers):
    model = PosedGarmentModel(_port_assets(jassets), jbody.faces, lbs_k=LBS_K, **levers)
    model.load_state_dict(sd, strict=True)
    return GarmentReconstructor(assets=model.assets, model=model.eval(),
                                device=torch.device("cpu"))


@pytest.mark.parametrize("lever", list(LEVERS))
def test_posed_model_levers_match_jax(ring, lever):
    """Each lever's model against the JAX model with the same lever, at the
    same weights (`posed_synth.npz`), on a 400-vertex body (neither package compacts
    the body table below 1024 rows, so the reuse lever keeps no state and
    the spatial lever's subsets are the same in both): the garment level
    tables and the centers Morton-sorted alike, so every iteration within
    atol 1e-4 (fp32 roundoff, as the default model's parity test)."""
    jbody = jsmpl.synthetic_smpl(num_verts=400)
    batch = jmake_batch(ring, jbody, batch_size=B, T=T, npoints=N, seed=7)
    body = jbody_inputs(batch)
    jmodel = JPosed(assets=ring, body_faces=jbody.faces, lbs_k=LBS_K, iterations=3,
                    **LEVERS[lever])
    flat, variables = _synth_variables(ring, jbody)
    jout = jax.jit(lambda v, p, b: jmodel.apply(v, p, b, train=False))(
        variables, batch["pcd"], body)
    recon = _port_model(ring, jbody, flax_to_torch(flat), **LEVERS[lever])
    tbatch = {k: _t(v) for k, v in batch.items()}
    tout = recon.posed(tbatch["pcd"], tbody_inputs(tbatch), return_all=True)
    for i, (a, b) in enumerate(zip(tout.iter_garment_v, jout.iter_garment_v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=f"{lever}, iteration {i}")


@pytest.fixture(scope="module")
def compacted():
    """A posed model at seeded random weights with each GCN's last layer
    scaled by 1e-3 (offsets of ~1e-3, as trained weights move the vertices
    little), an 1100-vertex body (its queries compacted) and one batch."""
    jassets = JAssets.synthetic(num_rings=6, ring_size=8)
    jbody = jsmpl.synthetic_smpl(num_verts=1100)
    torch.manual_seed(5)
    model = PosedGarmentModel(_port_assets(jassets), jbody.faces, lbs_k=LBS_K)
    with torch.no_grad():
        for it in range(3):
            getattr(model, f"gcn{it}_3").weight.mul_(1e-3)
            getattr(model, f"gcn{it}_3").bias.mul_(1e-3)
    batch = jmake_batch(jassets, jbody, batch_size=B, T=T, npoints=N, seed=9)
    tbatch = {k: _t(v) for k, v in batch.items()}
    return jassets, jbody, model.state_dict(), tbatch


@pytest.mark.parametrize("spatial", [False, True])
@pytest.mark.parametrize("margin", [1e-6, 0.05])
def test_reuse_model_bitwise_default(compacted, monkeypatch, spatial, margin):
    """The reuse model bitwise the model without it (with the same spatial
    setting), body tables compacted: at a margin below the iterations'
    drift every iteration rebuilds (3 builds), above it the first build
    serves all three; none overflows."""
    jassets, jbody, sd, batch = compacted
    builds = []
    compact = pemax._compact_candidates

    def counting(*args, **kwargs):
        out = compact(*args, **kwargs)
        builds.append(out[1])
        return out

    monkeypatch.setattr(pemax, "_compact_candidates", counting)
    base = _port_model(jassets, jbody, sd, spatial_sample=spatial)
    want = base.posed(batch["pcd"], tbody_inputs(batch), return_all=True)
    assert len(builds) == 3
    builds.clear()
    recon = _port_model(jassets, jbody, sd, spatial_sample=spatial,
                        candidate_reuse_margin=margin)
    got = recon.posed(batch["pcd"], tbody_inputs(batch), return_all=True)
    assert builds == [False] * (3 if margin < 1e-3 else 1)
    for a, b in zip(got.iter_garment_v, want.iter_garment_v):
        assert torch.equal(a, b)


def test_spatial_model_close_to_default(compacted):
    """The spatial lever samples other in-radius subsets, so its vertices
    differ from the default model's, but little at these small offsets."""
    jassets, jbody, sd, batch = compacted
    default = _port_model(jassets, jbody, sd).posed(batch["pcd"], tbody_inputs(batch))
    spatial = _port_model(jassets, jbody, sd, spatial_sample=True).posed(
        batch["pcd"], tbody_inputs(batch))
    assert torch.isfinite(spatial).all()
    assert float((spatial - default).abs().max()) < 1e-2


def test_lever_models_keep_the_state_dict(compacted):
    """A default model's state dict loads strictly into a lever model (the
    parameter tree is the same), and the levers add no buffer."""
    jassets, jbody, sd, _ = compacted
    for levers in LEVERS.values():
        model = PosedGarmentModel(_port_assets(jassets), jbody.faces, lbs_k=LBS_K, **levers)
        model.load_state_dict(sd, strict=True)
        assert list(model.state_dict()) == list(sd)

