"""Parity of the torch port's point-cloud ops and PointNet++ modules with the
JAX package, on the CPU.

The same numpy inputs (made from a seed) go through both packages. The JAX
side runs its CPU path, which tests/test_pallas_kernels.py holds to the
Pallas kernels in interpret mode; the port runs its plain torch versions,
which chip_smoke.py holds to the CUDA kernels on the card. Index outputs
must be bitwise equal; float outputs agree to fp32 roundoff (rtol 1e-5,
atol 1e-5: matmul summation order differs between XLA and torch).
"""

import contextlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from flax import traverse_util

from garment4d_tpu import ops as jops
from garment4d_tpu.nn import FPModule as JFPModule
from garment4d_tpu.nn import SAModuleMSG as JSAModuleMSG
from garment4d_tpu.nn.layers import SharedMLP as JSharedMLP

from garment4d_tpu_torch import ops as tops
from garment4d_tpu_torch.nn import FPModule, SAModuleMSG, SharedMLP
from garment4d_tpu_torch.ops import _build
from garment4d_tpu_torch.train.convert import flax_to_torch
from torch_port_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _cloud(rng, B, N, dup=0):
    """Uniform points in the unit cube, with `dup` exact duplicates (ties)."""
    pts = rng.rand(B, N, 3).astype(np.float32)
    if dup:
        pts[:, N - dup:] = pts[:, :dup]
    return pts


def randomized_variables(variables, rng):
    """Flat {path: array} of Flax variables with BatchNorm statistics and
    affine parameters moved off their init values, so that a test sees
    BatchNorm do something."""
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables, sep="/").items()}
    for k, v in flat.items():
        if k.endswith("bn/mean"):
            flat[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k.endswith("bn/var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("bn/scale"):
            flat[k] = (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k.endswith("bn/bias"):
            flat[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
    return flat


def load_into(module, flat):
    module.load_state_dict(flax_to_torch(flat), strict=True)
    return module.eval()


class TestIndexOps:
    def test_fps_bitwise(self, rng):
        xyz = _cloud(rng, 2, 300, dup=40)
        want = jops.furthest_point_sample(jnp.asarray(xyz), 64, use_pallas=False)
        got = tops.furthest_point_sample(_t(xyz), 64)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(want))

    def test_ball_query_multi_bitwise(self, rng):
        xyz = _cloud(rng, 2, 500, dup=50)
        centers = np.concatenate(
            [xyz[:, :60], np.full((2, 4, 3), 5.0, np.float32)], axis=1)  # 4 no-hit
        radii, ns = (0.1, 0.2, 0.3), (8, 16, 24)
        want = jops.ball_query_multi(radii, ns, jnp.asarray(xyz),
                                     jnp.asarray(centers), use_pallas=False)
        got = tops.ball_query_multi(radii, ns, _t(xyz), _t(centers))
        for w, g, s in zip(want, got, ns):
            assert g.shape == (2, 64, s) and g.dtype == torch.int32
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        assert (_np(got[0])[:, -4:] == 0).all()

    @pytest.mark.parametrize("radius,center", [
        (0.5, (0.0, 0.0, 0.0)), (0.5, (0.3, 0.2, 0.1)),
        (0.1, (0.3, 0.2, 0.1)), (0.05, (-0.7, 0.45, 0.15))])
    def test_ball_query_radius_boundary(self, radius, center):
        """Points at exactly r from the center and at r -+ 1 and 2 ulp along
        each axis: membership is bitwise the JAX package's."""
        center = np.array(center, np.float32)
        r = np.float32(radius)
        lo1 = np.nextafter(r, np.float32(0))
        hi1 = np.nextafter(r, np.float32(1))
        offs = [r, lo1, hi1, np.nextafter(lo1, np.float32(0)),
                np.nextafter(hi1, np.float32(1))]
        pts = []
        for o in offs:
            for axis in range(3):
                for sign in (1.0, -1.0):
                    p = center.copy()
                    p[axis] = np.float32(p[axis] + np.float32(sign) * o)
                    pts.append(p)
        xyz = np.stack(pts)[None]  # (1, 30, 3)
        ctr = center[None, None]
        want = jops.ball_query(float(radius), 32, jnp.asarray(xyz),
                               jnp.asarray(ctr), use_pallas=False)
        got = tops.ball_query(float(radius), 32, _t(xyz), _t(ctr))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        if not center.any():
            # exact distances: d^2 == r^2 is outside, r - 1 and 2 ulp inside
            hits = set(_np(got)[0, 0].tolist())
            assert hits == set(range(6, 12)) | set(range(18, 24))

    def test_three_nn_bitwise(self, rng):
        unknown = _cloud(rng, 2, 200)
        known = _cloud(rng, 2, 50, dup=10)
        unknown[:, :10] = known[:, :10]  # zero distances tie with duplicates
        wd, wi = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known),
                               use_pallas=False)
        gd, gi = tops.three_nn(_t(unknown), _t(known))
        assert gi.dtype == torch.int32
        np.testing.assert_array_equal(_np(gi), np.asarray(wi))
        np.testing.assert_allclose(_np(gd), np.asarray(wd), rtol=1e-6)

    def test_gather_and_group_bitwise(self, rng):
        pts = rng.randn(2, 80, 7).astype(np.float32)
        idx = rng.randint(0, 80, size=(2, 30)).astype(np.int32)
        gidx = rng.randint(0, 80, size=(2, 10, 4)).astype(np.int32)
        np.testing.assert_array_equal(
            _np(tops.gather_points(_t(pts), _t(idx))),
            np.asarray(jops.gather_points(jnp.asarray(pts), jnp.asarray(idx))))
        np.testing.assert_array_equal(
            _np(tops.group_points(_t(pts), _t(gidx))),
            np.asarray(jops.group_points(jnp.asarray(pts), jnp.asarray(gidx))))

    @pytest.mark.parametrize("op", ["gather_points", "group_points"])
    def test_gather_out_of_range_matches_jax(self, rng, op):
        """The JAX package's out-of-range rule (`_gather_rows`,
        take_along_axis on the CPU): indices drawn from [-N-3, N+3) with
        -N, -1, N and N+1 among them; an index in [-N, 0) reads row idx + N,
        any other index outside [0, N) a NaN row. Forward bitwise (NaN rows
        equal), the table's gradient within rtol 1e-6 / atol 1e-6 of
        jax.vjp (a wrapped index's cotangent into row idx + N, the others
        dropped)."""
        B, N, C = 2, 20, 5
        table = rng.randn(B, N, C).astype(np.float32)
        shape = (B, 60) if op == "gather_points" else (B, 12, 5)
        idx = rng.randint(-N - 3, N + 3, shape).astype(np.int32)
        idx.reshape(B, -1)[:, :4] = (-N, -1, N, N + 1)
        jout, vjp = jax.vjp(lambda t: getattr(jops, op)(t, jnp.asarray(idx)),
                            jnp.asarray(table))
        tt = _t(table).requires_grad_(True)
        out = getattr(tops, op)(tt, _t(idx))
        np.testing.assert_array_equal(_np(out), np.asarray(jout))  # NaN rows compare equal
        assert np.isnan(_np(out)).any() and (_np(out).view(np.int32) == 0x7fc00000).any()
        cot = rng.randn(*jout.shape).astype(np.float32)
        (want,) = vjp(jnp.asarray(cot))
        (got,) = torch.autograd.grad((out * _t(cot)).sum(), tt)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)

    def test_gather_plain_empty_table(self):
        """A table of no rows: every index is out of range, every row NaN."""
        out = tops.pointcloud._gather_rows_plain(torch.zeros(2, 0, 3),
                                                 torch.tensor([[0, -1], [1, 2]]))
        assert out.shape == (2, 2, 3) and bool(out.isnan().all())

    def test_three_interpolate(self, rng):
        feats = rng.randn(2, 50, 6).astype(np.float32)
        unknown, known = _cloud(rng, 2, 120), _cloud(rng, 2, 50)
        d, i = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known),
                             use_pallas=False)
        w = jops.interp_weights_from_dists(d)
        want = jops.three_interpolate(jnp.asarray(feats), i, w, use_cf=False)
        td, ti = tops.three_nn(_t(unknown), _t(known))
        got = tops.three_interpolate(_t(feats), ti, tops.interp_weights_from_dists(td))
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


class TestPlainAgainstPallas:
    """The port's plain flat query and plain 3-NN against the TPU kernels
    (`ball_query_multi_pallas`, `three_nn_pallas`) in interpret mode, as
    the JAX package's own tests run them on the CPU."""

    def test_flat_query_plain_matches_pallas(self, rng):
        """Two radii in one call, duplicated points and centers with no hit
        (every slot 0): indices equal."""
        from jax.experimental.pallas import tpu as pltpu
        from garment4d_tpu.ops.pallas.ball_query import ball_query_multi_pallas

        xyz = _cloud(rng, 2, 300, dup=60)
        centers = np.concatenate([xyz[:, 200:250], np.full((2, 6, 3), 7.0, np.float32)], 1)
        radii, ns = (0.1, 0.25), (8, 32)
        with pltpu.force_tpu_interpret_mode():
            want = ball_query_multi_pallas(radii, ns, jnp.asarray(xyz), jnp.asarray(centers))
        got = tops.pointcloud.ball_query_multi(radii, ns, _t(xyz), _t(centers))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        assert (_np(got[1])[:, -6:] == 0).all()

    def test_three_nn_plain_matches_pallas(self, rng):
        """Duplicated known points (ties to the lower index) and queries on
        them: indices equal, squared distances to fp32 roundoff (rtol 1e-6:
        the kernel forms its distances in another order). Finite inputs
        only: the JAX package's paths disagree on NaN (`TestNearestNaN`)."""
        from jax.experimental.pallas import tpu as pltpu
        from garment4d_tpu.ops.pallas.three_nn import three_nn_pallas

        known = _cloud(rng, 2, 90, dup=30)
        unknown = _cloud(rng, 2, 70)
        unknown[:, :15] = known[:, 60:75]
        with pltpu.force_tpu_interpret_mode():
            wd, wi = three_nn_pallas(jnp.asarray(unknown), jnp.asarray(known))
        gd, gi = tops.pointcloud._three_nn_plain(_t(unknown), _t(known))
        np.testing.assert_array_equal(_np(gi), np.asarray(wi))
        assert (_np(gi)[:, :15, 0] < 30).all()
        np.testing.assert_allclose(_np(gd), np.asarray(wd), rtol=1e-6)


def _boundary_points(center, radius):
    """Points at exactly r from `center` and at r -+ 1 and 2 ulp along each
    axis, both signs: (30, 3)."""
    r = np.float32(radius)
    lo1 = np.nextafter(r, np.float32(0))
    hi1 = np.nextafter(r, np.float32(1))
    offs = [r, lo1, hi1, np.nextafter(lo1, np.float32(0)),
            np.nextafter(hi1, np.float32(1))]
    pts = []
    for o in offs:
        for axis in range(3):
            for sign in (1.0, -1.0):
                p = center.copy()
                p[axis] = np.float32(p[axis] + np.float32(sign) * o)
                pts.append(p)
    return np.stack(pts)


class TestCoverageAndGroupedQuery:
    @pytest.mark.parametrize("radius,center", [
        (0.4, (0.0, 0.0, 0.0)), (0.4, (0.3, 0.2, 0.1)), (0.1, (-0.7, 0.45, 0.15))])
    def test_covered_mask_radius_boundary(self, rng, radius, center):
        """Against the Pallas coverage kernel in interpret mode: points at
        exactly r and r -+ 1, 2 ulp of one center, plus a random cloud."""
        from jax.experimental.pallas import tpu as pltpu
        from garment4d_tpu.ops.pallas.coverage import covered_mask_pallas

        center = np.array(center, np.float32)
        pts = np.concatenate([_boundary_points(center, radius),
                              rng.rand(70, 3).astype(np.float32) - 0.5])[None]
        centers = np.concatenate([center[None], rng.rand(4, 3).astype(np.float32) + 2.0])[None]
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(covered_mask_pallas(jnp.asarray(pts), jnp.asarray(centers),
                                                  radius))
        got = tops.covered_mask(_t(pts), _t(centers), radius)
        assert got.dtype == torch.int32 and got.shape == (1, 100)
        np.testing.assert_array_equal(_np(got), want)
        if not center.any():  # d^2 == r^2 is outside, r - 1 and 2 ulp inside
            assert set(np.nonzero(_np(got)[0, :30])[0]) == set(range(6, 12)) | set(range(18, 24))

    def test_ball_query_multi_n_valid(self, rng):
        """Rows at or past n_valid[b] are never hits, real points or
        sentinels: equal to the JAX flat query over the valid rows."""
        cap, M = 400, 50
        counts = [400, 230, 0]
        table = (0.4 * rng.randn(3, cap, 3)).astype(np.float32)
        table[1, 300:] = 1e9  # sentinels past a real tail
        centers = (0.4 * rng.randn(3, M, 3)).astype(np.float32)
        centers[:, -3:] = 7.0  # no hit
        radii, ns = (0.1, 0.2, 0.4), (8, 16, 32)
        got = tops.ball_query_multi(radii, ns, _t(table), _t(centers),
                                    n_valid=torch.tensor(counts, dtype=torch.int32))
        for b, nv in enumerate(counts):
            if nv:
                want = jops.ball_query_multi(radii, ns, jnp.asarray(table[b:b + 1, :nv]),
                                             jnp.asarray(centers[b:b + 1]), use_pallas=False)
            else:
                want = [np.zeros((1, M, s), np.int32) for s in ns]
            for w, g in zip(want, got):
                np.testing.assert_array_equal(_np(g)[b:b + 1], np.asarray(w))

    @pytest.mark.parametrize("spread", ["compact", "overflow"])
    def test_query_group_pe_multi(self, rng, monkeypatch, spread):
        """N=1100 >= 1024: the compaction path (coverage <= cap = 896) or,
        with centers all over the cloud, the overflow path; both equal the
        JAX package's flat query + PE blocks, no-hit centers included."""
        B, N, M = 2, 1100, 40
        xyz = rng.rand(B, N, 3).astype(np.float32)
        feats = rng.randn(B, N, 3).astype(np.float32)
        if spread == "compact":
            centers = (0.15 * rng.rand(B, M, 3)).astype(np.float32)
        else:
            centers = rng.rand(B, M, 3).astype(np.float32)
        centers[:, -3:] = 5.0  # no hit at any radius
        radii, ns = (0.1, 0.2, 0.4), (8, 16, 32)
        params = [((rng.randn(6, 32) / 2.5).astype(np.float32),
                   (0.1 * rng.randn(32)).astype(np.float32),
                   (rng.randn(32, 32) / 5.7).astype(np.float32),
                   (0.1 * rng.randn(32)).astype(np.float32)) for _ in radii]
        want = jops.query_group_pe_multi(
            radii, ns, jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(feats),
            [tuple(jnp.asarray(a) for a in p) for p in params], use_pallas=False)
        compacted = []
        gather = tops.pemax._gather_candidates
        monkeypatch.setattr(tops.pemax, "_gather_candidates",
                            lambda *a: compacted.append(1) or gather(*a))
        got, state = tops.query_group_pe_multi(radii, ns, _t(xyz), _t(centers), _t(feats),
                                               [tuple(_t(a) for a in p) for p in params])
        assert state is None  # no candidate state without a reuse margin
        assert bool(compacted) == (spread == "compact")
        for w, g in zip(want, got):
            assert g.shape == (B, M, 32)
            np.testing.assert_allclose(_np(g), np.asarray(w), **F32)


class TestChain:
    def test_group_chain_max(self, rng):
        xyz = _cloud(rng, 2, 200)
        feats = rng.randn(2, 200, 5).astype(np.float32)
        table = np.concatenate([xyz, feats], -1)
        centers = xyz[:, :40]
        idx = np.asarray(jops.ball_query(0.2, 16, jnp.asarray(xyz),
                                         jnp.asarray(centers), use_pallas=False))
        widths = (8, 12, 16)
        ws, bs, c = [], [], 8
        for w in widths:
            ws.append((rng.randn(c, w) / np.sqrt(c)).astype(np.float32))
            bs.append((0.1 * rng.randn(w)).astype(np.float32))
            c = w
        relus = (True, True, False)
        want = jops.group_chain_max(jnp.asarray(table), jnp.asarray(idx),
                                    jnp.asarray(centers),
                                    [jnp.asarray(w) for w in ws],
                                    [jnp.asarray(b) for b in bs], relus)
        got = tops.group_chain_max(_t(table), _t(idx), _t(centers),
                                   [_t(w) for w in ws], [_t(b) for b in bs], relus)
        assert got.shape == (2, 40, 16)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)

    def test_folded_mlp_matches_jax(self, rng):
        mlp = JSharedMLP((16, 32))
        x = jnp.asarray(rng.randn(4, 11).astype(np.float32))
        flat = randomized_variables(mlp.init(jax.random.PRNGKey(1), x), rng)
        variables = traverse_util.unflatten_dict(flat, sep="/")
        jw, jb = mlp.apply(variables, 11, method=JSharedMLP.folded)
        tw, tb = load_into(SharedMLP(11, (16, 32)), flat).folded()
        for a, b in zip(tw + tb, list(jw) + list(jb)):
            np.testing.assert_allclose(_np(a), np.asarray(b), **F32)


def _pe_case(rng, B=2, N=300, M=150, S=8, C=6, F=32, G=32):
    """The PE-backward case of tests/test_pallas_kernels.py: half the slots
    replicate slot 0 (the first-hit replication of the ball query), so the
    max over S has exact ties."""
    table = rng.randn(B, N, C).astype(np.float32)
    centers = rng.randn(B, M, 3).astype(np.float32)
    idx = rng.randint(0, N, (B, M, S)).astype(np.int32)
    idx[:, :, S // 2:] = idx[:, :, :1]
    k0 = rng.randn(C, F).astype(np.float32) * 0.3
    b0 = rng.randn(F).astype(np.float32) * 0.1
    k1 = rng.randn(F, G).astype(np.float32) * 0.3
    b1 = rng.randn(G).astype(np.float32) * 0.1
    cot = rng.randn(B, M, G).astype(np.float32)
    return table, idx, centers, k0, b0, k1, b1, cot


def _grads(fn, *args):
    """torch.autograd.grad of sum(fn(*args) * cot) w.r.t. the float args;
    the last arg is the cotangent."""
    *args, cot = args
    leaves = [_t(a).requires_grad_(a.dtype == np.float32) for a in args]
    out = fn(*leaves)
    wanted = [x for x in leaves if x.requires_grad]
    return [_np(g) for g in torch.autograd.grad((out * _t(cot)).sum(), wanted)]


class TestGradients:
    """The port's backward passes against the JAX package's VJPs."""

    def test_chain_reference_splits_ties_like_jax(self, rng):
        """Two distinct table rows with equal values in one neighbourhood:
        the max ties exactly, and the gradient splits evenly between the
        two rows, as `jnp.max` routes it (torch's `max(dim)` would give it
        all to one). dtable, dcenters and the weight grads within fp32
        roundoff (rtol 1e-5, atol 1e-5)."""
        from garment4d_tpu.ops.pemax import _pe_reference

        table, idx, centers, k0, b0, k1, b1, cot = _pe_case(rng, B=1, N=40, M=12, S=4)
        table[:, 7] = table[:, 3]
        idx[:, :, 0], idx[:, :, 1] = 3, 7
        args = (table, centers, k0, b0, k1, b1)
        _, vjp = jax.vjp(lambda t, c, a0, a1, a2, a3: _pe_reference(
            t, jnp.asarray(idx), c, a0, a1, a2, a3), *[jnp.asarray(a) for a in args])
        want = vjp(jnp.asarray(cot))
        got = _grads(lambda t, c, a0, a1, a2, a3: tops.pemax._chain_reference(
            t, _t(idx), c, (a0, a2), (a1, a3), (True, False)), *args, cot)
        assert np.abs(np.asarray(want[0])[0, 7]).sum() > 0  # the tie is live
        for name, g, w in zip(("dtable", "dcenters", "dk0", "db0", "dk1", "db1"),
                              got, want):
            np.testing.assert_allclose(g, np.asarray(w), **F32, err_msg=name)

    def test_pe_backward_plain_matches_pallas(self, rng):
        """The plain PE backward against the TPU kernel (interpret mode),
        table_grad=False. Tolerances as the kernel's own test: dcenters atol
        2e-6, weight grads atol 1e-4 (sums of ~B*M*S terms in another
        order), rtol 2e-5."""
        from jax.experimental.pallas import tpu as pltpu
        from garment4d_tpu.ops.pallas.fusedpe import fused_pe_bwd_pallas

        table, idx, centers, k0, b0, k1, b1, cot = _pe_case(rng)
        with pltpu.force_tpu_interpret_mode():
            want = fused_pe_bwd_pallas(
                *[jnp.asarray(a) for a in (table, idx, centers, k0, b0, k1, b1)],
                idx.shape[2], jnp.asarray(cot), table_grad=False)
        got = tops.pemax._pe_bwd_plain(*[_t(a) for a in (table, idx, centers, k0, b0,
                                                           k1, cot)])
        for name, g, w, atol in zip(("dcenters", "dk0", "db0", "dk1", "db1"), got, want,
                                    (2e-6, 1e-4, 1e-4, 1e-4, 1e-4)):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=atol,
                                       err_msg=name)

    def test_pe_near_ties(self, rng):
        """The PE-backward comparisons' near-tie oracle (`chip_smoke.py`):
        exact ties (replicated slots, two rows with equal values) are not
        near-ties; a row one ulp away from another on a feature channel is
        one, in channels those two rows win, and only at its center."""
        from chip_smoke import pe_near_ties

        table, idx, centers, k0, b0, k1, _, _ = _pe_case(rng, B=1, N=40, M=12, S=4)
        table[:, 7] = table[:, 3]
        idx[:, 4, :2] = (3, 7)
        args = [_t(a) for a in (table, idx, centers, k0, b0, k1)]
        assert not pe_near_ties(*args).any()
        table[:, 9] = table[:, 3]
        table[:, 9, 4] = np.nextafter(table[:, 3, 4], np.float32(np.inf))
        idx[:, 5, :2] = (3, 9)
        args = [_t(a) for a in (table, idx, centers, k0, b0, k1)]
        tied = pe_near_ties(*args)
        assert tied.shape == (1, 12, k1.shape[1])
        assert tied[0, 5].any() and tied.any(-1).sum() == 1

    def test_pe_bwd_float64_witness(self, rng):
        """The float64 PE backward that the card's checks hold the kernel
        to (`chip_smoke.pe_bwd_float64`), given the plain version's routing
        and ReLU masks (`chip_smoke.pe_routing`): the plain fp32 version's
        values to fp32 roundoff (rtol 1e-5 / atol 1e-6), with an exact tie of
        two equal rows split evenly, as JAX routes it."""
        from chip_smoke import pe_bwd_float64, pe_routing

        table, idx, centers, k0, b0, k1, _, cot = _pe_case(rng, B=1, N=40, M=12, S=4)
        table[:, 7] = table[:, 3]
        idx[:, 4, :2] = (3, 7)
        args = [_t(a) for a in (table, idx, centers, k0, b0, k1, cot)]
        tie, _ = pe_routing(*args[:6])
        assert tie.shape == (1, 12, 4, k1.shape[1]) and (tie.sum(dim=2) == 2).any()
        got = pe_bwd_float64(*args, pe_routing(*args[:6]))
        want = tops.pemax._pe_bwd_plain(*args)
        assert all(g.dtype == torch.float64 for g in got)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g.float()), _np(w), rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("S", [4, 8])
    def test_group_pe_max_frozen_table(self, rng, S):
        """`group_pe_max(table_grad=False)` through its autograd Function:
        the table gets no gradient, the rest equals JAX's VJP (fp32
        roundoff, rtol 2e-5 / atol 1e-5)."""
        from garment4d_tpu import ops as jo

        table, idx, centers, k0, b0, k1, b1, cot = _pe_case(rng, B=1, N=120, M=40, S=S)
        args = (centers, k0, b0, k1, b1)
        _, vjp = jax.vjp(lambda c, a0, a1, a2, a3: jo.group_pe_max(
            jnp.asarray(table), jnp.asarray(idx), c, a0, a1, a2, a3, table_grad=False),
            *[jnp.asarray(a) for a in args])
        want = vjp(jnp.asarray(cot))
        tt = _t(table).requires_grad_(True)
        got = _grads(lambda c, a0, a1, a2, a3: tops.group_pe_max(
            tt, _t(idx), c, a0, a1, a2, a3, table_grad=False), *args, cot)
        assert tt.grad is None
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=2e-5, atol=1e-5)

    def test_backward_follows_forward_dispatch_on_another_thread(self, rng, monkeypatch):
        """Autograd runs the backward of CUDA tensors on a worker thread,
        where a caller's `plain_ops()` is not in effect. With CPU tensors
        standing in for the card (the kernel wrappers replaced by recorded
        plain versions) and the backward run on a new thread: a forward
        inside `plain_ops()` reaches no kernel in its backward either, and
        one outside reaches the PE-backward and banded kernels."""
        import threading

        pc, pemax, graph = tops.pointcloud, tops.pemax, tops.graph
        calls = []

        def recorded(name, fn):
            def run(*args):
                calls.append(name)
                return fn(*args)
            return run

        def chain(table, idx, centers, ws, bs, relus, name):
            return pemax._chain_reference(table, idx, centers, ws, bs, relus)

        for mod in (pemax, graph):
            monkeypatch.setattr(mod, "use_kernel", lambda t: not pc._plain_only.get())
        monkeypatch.setattr(pemax, "_chain_kernel", chain)
        monkeypatch.setattr(pemax, "_pe_bwd_kernel", recorded("pe_bwd", pemax._pe_bwd_plain))
        monkeypatch.setattr(graph, "_banded_kernel", recorded("banded", graph._banded_plain))
        table, idx, centers, k0, b0, k1, b1, cot = _pe_case(rng, B=1, N=60, M=10, S=8)
        k0, x = _t(k0).requires_grad_(True), torch.randn(2, 12, 3, requires_grad=True)
        adj = torch.eye(12).roll(1, 1) + torch.eye(12)
        for plain, want in ((True, []), (False, ["pe_bwd", "banded"])):
            with tops.plain_ops() if plain else contextlib.nullcontext():
                out = tops.group_pe_max(_t(table), _t(idx), _t(centers), k0, _t(b0), _t(k1),
                                        _t(b1), table_grad=False)
                y = tops.graph_matmul_banded(adj, x, (0, 1))
            loss = (out * _t(cot)).sum() + (y * y).sum()
            calls.clear()
            grads = []
            worker = threading.Thread(target=lambda: grads.extend(
                torch.autograd.grad(loss, [k0, x])))
            worker.start()
            worker.join()
            assert len(grads) == 2 and sorted(calls) == sorted(want), (plain, calls)

    def test_group_pe_max_split_frozen(self, rng):
        """Split forward, unsplit backward: the output and the gradients of
        (centers, k0, b0, k1, b1) equal JAX's `group_pe_max_split_frozen`
        (rtol 2e-5 / atol 1e-5); xyz and features get none."""
        from garment4d_tpu import ops as jo

        B, N, M, S, C, F = 1, 120, 40, 4, 9, 32
        xyz = rng.randn(B, N, 3).astype(np.float32)
        feats = rng.randn(B, N, C).astype(np.float32)
        _, idx, centers, _, b0, k1, b1, cot = _pe_case(rng, B=B, N=N, M=M, S=S, C=3 + C)
        k0 = (rng.randn(3 + C, F) * 0.3).astype(np.float32)
        args = (centers, k0, b0, k1, b1)
        jout, vjp = jax.vjp(lambda c, a0, a1, a2, a3: jo.group_pe_max_split_frozen(
            jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(idx), c, a0, a1, a2, a3),
            *[jnp.asarray(a) for a in args])
        want = vjp(jnp.asarray(cot))
        tx, tf = _t(xyz).requires_grad_(True), _t(feats).requires_grad_(True)
        out = tops.group_pe_max_split_frozen(tx, tf, _t(idx), *[_t(a) for a in args])
        np.testing.assert_allclose(_np(out), np.asarray(jout), **F32)
        got = _grads(lambda c, a0, a1, a2, a3: tops.group_pe_max_split_frozen(
            tx, tf, _t(idx), c, a0, a1, a2, a3), *args, cot)
        assert tx.grad is None and tf.grad is None
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=2e-5, atol=1e-5)

    @pytest.mark.parametrize("V,C,offsets", [
        (37, 3, (0, 1, 7, 30, 36)),        # V not a multiple of 8, wrapping
        (41, 128, (0, 1, 5, 36, 40)),
        (48, 3, (1, 8, 40, 47)),           # no diagonal at offset 0
    ])
    def test_banded_product_and_transpose(self, rng, V, C, offsets):
        """Random values on every diagonal (an off-by-one roll of the
        transposed values would show). The plain product against the TPU
        kernel (interpret mode) and its gradient, the transposed band,
        against jax.vjp of JAX's `_banded_apply`: fp32 roundoff (rtol 1e-6,
        atol 1e-6; both sum the same terms in offset order)."""
        from jax.experimental.pallas import tpu as pltpu
        from garment4d_tpu.ops.graph import _banded_apply
        from garment4d_tpu.ops.pallas.banded import banded_matmul_pallas

        vals = rng.rand(len(offsets), V).astype(np.float32)
        x = rng.randn(2, V, C).astype(np.float32)
        g = rng.randn(2, V, C).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(banded_matmul_pallas(jnp.asarray(vals), jnp.asarray(x),
                                                   offsets, V))
        _, vjp = jax.vjp(lambda xx: _banded_apply(jnp.asarray(vals), xx, offsets),
                         jnp.asarray(x))
        tx = _t(x).requires_grad_(True)
        got = tops.graph._BandedApply.apply(_t(vals), tx, offsets)
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
        (gx,) = torch.autograd.grad((got * _t(g)).sum(), tx)
        np.testing.assert_allclose(_np(gx), np.asarray(vjp(jnp.asarray(g))[0]),
                                   rtol=1e-6, atol=1e-6)
        dense = np.zeros((V, V), np.float32)
        for d, o in enumerate(offsets):
            dense[np.arange(V), (np.arange(V) + o) % V] = vals[d]
        np.testing.assert_allclose(_np(gx), np.einsum("vw,bvc->bwc", dense, g),
                                   rtol=1e-5, atol=1e-5)

    def test_nn1_plain_matches_pallas(self, rng):
        """The plain 1-NN against the TPU kernel (interpret mode): indices
        equal with duplicated points (ties to the lower index), squared
        distances equal to fp32 roundoff (rtol 1e-6); the query gradient
        against jax.vjp of `nn1_pallas` (rtol 1e-5 / atol 1e-6). Finite
        inputs only: on NaN `nn1_pallas` gives NaN and an index past N, the
        XLA K=1 path NaN and the NaN point's index, the K=3 path skips NaN
        points (`TestNearestNaN` holds the port's rule)."""
        from jax.experimental.pallas import tpu as pltpu
        from garment4d_tpu.ops.pallas.nn1 import nn1_pallas

        p = _cloud(rng, 2, 600, dup=150)
        q = _cloud(rng, 2, 140)
        q[:, :20] = p[:, 450:470]  # zero distance to a duplicated point
        g = rng.randn(2, 140).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            (wd, wi), vjp = jax.vjp(nn1_pallas, jnp.asarray(q), jnp.asarray(p))
            wq, wp = vjp((jnp.asarray(g), np.zeros((2, 140), jax.dtypes.float0)))
        tq, tp = _t(q).requires_grad_(True), _t(p).requires_grad_(True)
        gd, gi = tops.knn_points(tq, tp, K=1)
        assert gi.dtype == torch.int32 and gd.shape == (2, 140, 1)
        np.testing.assert_array_equal(_np(gi)[..., 0], np.asarray(wi))
        assert (_np(gi)[:, :20, 0] < 150).all()
        np.testing.assert_allclose(_np(gd)[..., 0], np.asarray(wd), rtol=1e-6)
        dq, dp = torch.autograd.grad((gd[..., 0] * _t(g)).sum(), (tq, tp))
        np.testing.assert_allclose(_np(dq), np.asarray(wq), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(dp), np.asarray(wp), rtol=1e-5, atol=1e-6)

    def test_knn_points_k3(self, rng):
        """K > 1: plain distances + top-k, against JAX's exact form."""
        q, p = _cloud(rng, 2, 50), _cloud(rng, 2, 90)
        want = jops.knn_points(jnp.asarray(q), jnp.asarray(p), K=3, exact=True,
                               use_pallas=False)
        gd, gi = tops.knn_points(_t(q), _t(p), K=3)
        np.testing.assert_array_equal(_np(gi), np.asarray(want.idx))
        np.testing.assert_allclose(_np(gd), np.asarray(want.dists), rtol=1e-6)


class TestTableGradients:
    """The deterministic scatter-add and the gradients that go through it
    (the row gathers, the PE block's dtable half, the chain), the
    valid-count PE call, and the cotangent Laplacian, against the JAX
    package."""

    @pytest.mark.parametrize("case", ["duplicates", "out_of_range"])
    def test_scatter_add_rows_matches_gather_vjp(self, rng, case):
        """Against JAX's `_gather_rows` VJP (XLA's scatter-add on the CPU)
        and `np.add.at`: bitwise, both add each row's contributions in
        ascending order from 0.0. Heavy duplicates (every index in 0..4),
        and indices at or past n, which both drop."""
        from garment4d_tpu.ops.pointcloud import _gather_rows

        B, R, n, C = 2, 1500, 40, 7
        idx = rng.randint(0, 5, (B, R)).astype(np.int32)
        if case == "out_of_range":
            idx = rng.randint(0, n + 30, (B, R)).astype(np.int32)
        g = rng.randn(B, R, C).astype(np.float32)
        _, vjp = jax.vjp(lambda t: _gather_rows(t, jnp.asarray(idx)),
                         jnp.zeros((B, n, C), jnp.float32))
        want = np.asarray(vjp(jnp.asarray(g))[0])
        got = _np(tops.scatter_add_rows(_t(g), _t(idx), n))
        np.testing.assert_array_equal(got, want)
        ref = np.zeros((B, n + 30, C), np.float32)
        for b in range(B):
            np.add.at(ref[b], idx[b], g[b])
        np.testing.assert_array_equal(got, ref[:, :n])

    def test_scatter_add_rows_matches_pallas(self, rng):
        """Against the TPU kernel (interpret mode), which drops negative
        indices and indices past n too: within 1e-6 of the magnitude each
        output element sums (the kernel's bf16x3 split is exact, but it
        adds in another order, and a row here collects ~400 terms)."""
        from jax.experimental.pallas import tpu as pltpu
        from garment4d_tpu.ops.pallas.scatter import scatter_add_rows_pallas

        B, R, n, C = 2, 1300, 130, 6
        idx = rng.randint(-20, n + 20, (B, R)).astype(np.int32)
        idx[:, :400] = 3  # collisions
        g = rng.randn(B, R, C).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(scatter_add_rows_pallas(jnp.asarray(g), jnp.asarray(idx), n))
        got = _np(tops.scatter_add_rows(_t(g), _t(idx), n))
        magnitude = np.zeros((B, n + 20, C), np.float32)
        for b in range(B):
            ok = idx[b] >= 0
            np.add.at(magnitude[b], idx[b][ok], np.abs(g[b][ok]))
        assert (np.abs(got - want) <= 1e-6 * magnitude[:, :n]).all()

    @pytest.mark.parametrize("op", ["gather_points", "group_points", "three_interpolate"])
    def test_gather_vjps(self, rng, op):
        """The table's gradient through each gather, against jax.vjp of the
        JAX op (the same scatter-add and products): rtol 1e-6 / atol 1e-6."""
        B, N, M, C = 2, 50, 30, 5
        table = rng.randn(B, N, C).astype(np.float32)
        if op == "gather_points":
            args = (rng.randint(0, N, (B, M)).astype(np.int32),)
        elif op == "group_points":
            args = (rng.randint(0, 8, (B, M, 6)).astype(np.int32),)
        else:
            w = rng.rand(B, M, 3).astype(np.float32)
            args = (rng.randint(0, N, (B, M, 3)).astype(np.int32), w / w.sum(-1, keepdims=True))
        jout, vjp = jax.vjp(lambda t: getattr(jops, op)(t, *[jnp.asarray(a) for a in args]),
                            jnp.asarray(table))
        cot = rng.randn(*jout.shape).astype(np.float32)
        (want,) = vjp(jnp.asarray(cot))
        tt = _t(table).requires_grad_(True)
        out = getattr(tops, op)(tt, *[_t(a) for a in args])
        np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-6, atol=1e-6)
        (got,) = torch.autograd.grad((out * _t(cot)).sum(), tt)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("S", [4, 8])
    def test_group_pe_max_table_grad(self, rng, S):
        """`group_pe_max(table_grad=True)` with a table that requires grad:
        the output and all six gradients (dtable through the scatter-add
        of the row gradients) against JAX's VJP, exact ties among the
        replicated slots included: the output, dtable and dcenters within
        rtol 1e-5 / atol 1e-6; each weight gradient, a sum of B*M*S
        products in another order, within 1e-5 of its largest magnitude."""
        from garment4d_tpu import ops as jo

        table, idx, centers, k0, b0, k1, b1, cot = _pe_case(rng, B=2, N=60, M=40, S=S)
        args = (table, centers, k0, b0, k1, b1)
        jout, vjp = jax.vjp(lambda t, c, a0, a1, a2, a3: jo.group_pe_max(
            t, jnp.asarray(idx), c, a0, a1, a2, a3), *[jnp.asarray(a) for a in args])
        want = vjp(jnp.asarray(cot))
        got = _grads(lambda t, c, a0, a1, a2, a3: tops.group_pe_max(
            t, _t(idx), c, a0, a1, a2, a3), *args, cot)
        out = tops.group_pe_max(*[_t(a) for a in (table, idx, centers, k0, b0, k1, b1)])
        np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-5, atol=1e-6)
        assert np.abs(got[0]).sum() > 0
        for name, g, w in zip(("dtable", "dcenters"), got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)
        for name, g, w in zip(("dk0", "db0", "dk1", "db1"), got[2:], want[2:]):
            w = np.asarray(w)
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), name

    def test_pe_backward_table_grad_plain_matches_pallas(self, rng):
        """The plain PE backward's dtable half against the TPU kernel's
        (interpret mode, table_grad=True): tolerances as
        `test_pe_backward_plain_matches_pallas` (dtable sums few rows:
        atol 2e-6)."""
        from jax.experimental.pallas import tpu as pltpu
        from garment4d_tpu.ops.pallas.fusedpe import fused_pe_bwd_pallas

        table, idx, centers, k0, b0, k1, b1, cot = _pe_case(rng)
        with pltpu.force_tpu_interpret_mode():
            want = fused_pe_bwd_pallas(
                *[jnp.asarray(a) for a in (table, idx, centers, k0, b0, k1, b1)],
                idx.shape[2], jnp.asarray(cot))
        got = tops.pemax._pe_bwd_plain(*[_t(a) for a in (table, idx, centers, k0, b0,
                                                           k1, cot)], table_grad=True)
        assert len(got) == 6
        for name, g, w, atol in zip(("dtable", "dcenters", "dk0", "db0", "dk1", "db1"),
                                    got, want, (2e-6, 2e-6, 1e-4, 1e-4, 1e-4, 1e-4)):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=atol,
                                       err_msg=name)

    def test_group_pe_max_n_valid(self, rng):
        """The valid-count call over a sentinel-padded table against JAX's
        `group_pe_max(table_grad=False, n_valid=)` (fp32 roundoff, rtol
        1e-5 / atol 1e-5), bitwise the call without the count; an index at
        or past max(n_valid[b], 1) raises (a frame with a count of 0 may
        still gather row 0)."""
        from garment4d_tpu import ops as jo

        table, idx, centers, k0, b0, k1, b1, _ = _pe_case(rng, B=2, N=80, M=30, S=8)
        n_valid = np.array([50, 0], np.int32)
        idx[0] = idx[0] % 50
        idx[1] = 0
        table[0, 50:, :3] = 1e9  # sentinel rows past the count
        args = (table, idx, centers, k0, b0, k1, b1)
        want = jo.group_pe_max(*[jnp.asarray(a) for a in args], table_grad=False,
                               n_valid=jnp.asarray(n_valid))
        got = tops.group_pe_max(*[_t(a) for a in args], table_grad=False, n_valid=_t(n_valid))
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
        plain = tops.group_pe_max(*[_t(a) for a in args], table_grad=False)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        idx[0, 3, 2] = 50
        with pytest.raises(ValueError, match="past max"):
            tops.group_pe_max(*[_t(a) for a in args], table_grad=False, n_valid=_t(n_valid))
        with pytest.raises(ValueError, match="table_grad=False"):
            tops.group_pe_max(*[_t(a) for a in args], n_valid=_t(n_valid))

    def test_group_chain_max_gradients(self, rng):
        """`group_chain_max` through its autograd Function (the backward
        recomputes the unfused chain) against JAX's custom VJP: a 3-layer
        chain with a linear last layer; the table's, centers' and every
        weight's gradient within rtol 1e-5 / atol 1e-5."""
        from garment4d_tpu import ops as jo

        table, idx, centers, _, _, _, _, _ = _pe_case(rng, B=2, N=60, M=20, S=8, C=7)
        widths = (7, 16, 12, 8)
        ws = [(rng.randn(a, b) * 0.3).astype(np.float32) for a, b in zip(widths, widths[1:])]
        bs = [(rng.randn(b) * 0.1).astype(np.float32) for b in widths[1:]]
        relus = (True, True, False)
        cot = rng.randn(2, 20, 8).astype(np.float32)
        jargs = [jnp.asarray(a) for a in (table, centers)]
        _, vjp = jax.vjp(lambda t, c, w, b: jo.group_chain_max(t, jnp.asarray(idx), c, w, b,
                                                               relus),
                         *jargs, [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
        jt, jc, jw, jb = vjp(jnp.asarray(cot))
        got = _grads(lambda t, c, *wb: tops.group_chain_max(t, _t(idx), c, wb[:3], wb[3:],
                                                            relus),
                     table, centers, *ws, *bs, cot)
        for g, w in zip(got, [jt, jc, *jw, *jb]):
            np.testing.assert_allclose(g, np.asarray(w), **F32)

    def test_cot_laplacian_apply(self, rng):
        """`cot_laplacian_apply` against JAX's on a ring mesh with a
        degenerate face (two coincident vertices: its weights are NaN/Inf,
        zeroed), and its gradient w.r.t. x (the weights are constants):
        rtol 1e-5 / atol 1e-5."""
        from garment4d_tpu.models import GarmentAssets as JAssets

        assets = JAssets.synthetic(num_rings=4, ring_size=6)
        faces = np.asarray(assets.faces_tri)
        verts = (assets.template_v[None] + 0.01 * rng.randn(2, assets.num_verts, 3)
                 ).astype(np.float32)
        verts[:, faces[0, 1]] = verts[:, faces[0, 0]]
        x = rng.randn(2, assets.num_verts, 3).astype(np.float32)
        cot = rng.randn(2, assets.num_verts, 3).astype(np.float32)
        w = np.asarray(jops.meshmath.cotangent_weights(jnp.asarray(verts), faces))
        assert (w[:, 0] == 0).all()
        np.testing.assert_allclose(_np(tops.cotangent_weights(_t(verts), faces)), w, **F32)
        jout, vjp = jax.vjp(lambda v, xx: jops.cot_laplacian_apply(v, xx, faces),
                            jnp.asarray(verts), jnp.asarray(x))
        jv, jx = vjp(jnp.asarray(cot))
        tv, tx = _t(verts).requires_grad_(True), _t(x).requires_grad_(True)
        out = tops.cot_laplacian_apply(tv, tx, faces)
        np.testing.assert_allclose(_np(out), np.asarray(jout), **F32)
        gv, gx = torch.autograd.grad((out * _t(cot)).sum(), (tv, tx), allow_unused=True)
        assert gv is None and not np.asarray(jv).any()
        np.testing.assert_allclose(_np(gx), np.asarray(jx), **F32)


class TestModules:
    @pytest.mark.parametrize("with_feats", [False, True])
    def test_sa_module(self, rng, with_feats):
        xyz = _cloud(rng, 2, 256)
        feats = rng.randn(2, 256, 6).astype(np.float32) if with_feats else None
        kw = dict(npoint=64, radii=(0.15, 0.3), nsamples=(8, 16),
                  mlps=((8, 16), (16, 32)))
        jm = JSAModuleMSG(**kw)
        jf = None if feats is None else jnp.asarray(feats)
        flat = randomized_variables(
            jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jf), rng)
        jx, jout = jm.apply(traverse_util.unflatten_dict(flat, sep="/"),
                            jnp.asarray(xyz), jf)
        tm = load_into(SAModuleMSG(in_channels=6 if with_feats else 0, **kw), flat)
        with torch.no_grad():
            tx, tout = tm(_t(xyz), None if feats is None else _t(feats))
        np.testing.assert_array_equal(_np(tx), np.asarray(jx))
        np.testing.assert_allclose(_np(tout), np.asarray(jout), **F32)

    def test_group_all_module(self, rng):
        xyz = _cloud(rng, 2, 64)
        feats = rng.randn(2, 64, 5).astype(np.float32)
        kw = dict(npoint=None, radii=(None,), nsamples=(None,), mlps=((16, 8),))
        jm = JSAModuleMSG(**kw)
        flat = randomized_variables(
            jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(feats)), rng)
        _, jout = jm.apply(traverse_util.unflatten_dict(flat, sep="/"),
                           jnp.asarray(xyz), jnp.asarray(feats))
        tm = load_into(SAModuleMSG(in_channels=5, **kw), flat)
        with torch.no_grad():
            tx, tout = tm(_t(xyz), _t(feats))
        assert tx is None and tout.shape == (2, 1, 8)
        np.testing.assert_allclose(_np(tout), np.asarray(jout), **F32)

    def test_fp_module(self, rng):
        unknown, known = _cloud(rng, 2, 128), _cloud(rng, 2, 32)
        uf = rng.randn(2, 128, 4).astype(np.float32)
        kf = rng.randn(2, 32, 6).astype(np.float32)
        args = [jnp.asarray(a) for a in (unknown, known, uf, kf)]
        jm = JFPModule(mlp=(16, 8))
        flat = randomized_variables(jm.init(jax.random.PRNGKey(0), *args), rng)
        jout = jm.apply(traverse_util.unflatten_dict(flat, sep="/"), *args)
        tm = load_into(FPModule((16, 8), in_channels=10), flat)
        with torch.no_grad():
            tout = tm(*[_t(a) for a in (unknown, known, uf, kf)])
        np.testing.assert_allclose(_np(tout), np.asarray(jout), **F32)


class TestDispatch:
    def test_kernel_wrappers_refuse_cpu_tensors(self):
        """A kernel wrapper takes CUDA tensors only; the CPU path is the
        plain version, chosen by the tensor's device."""
        xyz = torch.zeros(1, 16, 3)
        with pytest.raises(ValueError, match="cuda|on "):
            tops.pointcloud._fps_kernel(xyz, 4)
        with pytest.raises(ValueError):
            tops.pointcloud._three_nn_kernel(xyz, xyz)

    def test_cpu_path_launches_no_kernel(self, rng):
        _build.reset_counts()
        xyz = _t(_cloud(rng, 1, 64))
        tops.ball_query(0.3, 8, xyz, xyz[:, :8])
        tops.furthest_point_sample(xyz, 8)
        assert sum(_build.launch_counts.values()) == 0

    def test_other_devices_raise(self):
        with pytest.raises(ValueError, match="no kernel"):
            tops.furthest_point_sample(torch.zeros(1, 8, 3, device="meta"), 2)

    def test_plain_ops_selects_the_plain_versions(self):
        meta = torch.zeros(1, 8, 3, device="meta")
        with tops.plain_ops():
            assert not tops.use_kernel(meta)
            with tops.plain_ops():
                assert not tops.use_kernel(meta)
            assert not tops.use_kernel(meta)
        with pytest.raises(ValueError, match="no kernel"):
            tops.use_kernel(meta)

    @pytest.mark.parametrize("wrapper", ["gather_rows", "fused_chain", "group_pe_max",
                                         "knn_transfer", "gcn_stack", "banded", "nn1",
                                         "pe_bwd"])
    def test_forward_only_wrappers_refuse_grad(self, wrapper):
        """A kernel wrapper raises, before any launch, when autograd records
        and an input requires grad; under no_grad it goes on to its checks."""
        from garment4d_tpu_torch.models import skinning

        table = torch.zeros(1, 8, 3, requires_grad=True)
        idx = torch.zeros(1, 2, 8, dtype=torch.int32)
        w, b = torch.zeros(3, 8), torch.zeros(8)

        def call():
            if wrapper == "gather_rows":
                return tops.pointcloud._gather_rows_kernel(table, idx[:, 0])
            if wrapper == "knn_transfer":
                return skinning._knn_transfer_kernel(table, table.detach(),
                                                     torch.zeros(1, 8, 4), 2, 2)
            if wrapper == "gcn_stack":
                return tops.graph._gcn_stack_kernel([table], [w], [b],
                                                    torch.ones(1, 8), (0,), (True,), 0)
            if wrapper == "banded":
                return tops.graph._banded_kernel(torch.ones(1, 8), table, (0,))
            if wrapper == "nn1":
                return tops.pointcloud._nn1_kernel(table, table.detach())
            if wrapper == "pe_bwd":
                return tops.pemax._pe_bwd_kernel(table, idx, table[:, :2].detach(), w, b,
                                                 torch.zeros(8, 8), torch.zeros(1, 2, 8))
            return tops.pemax._chain_kernel(table, idx, table[:, :2].detach(),
                                            [w], [b], (True,), name=wrapper)

        with pytest.raises(RuntimeError, match=f"{wrapper}: the CUDA kernel is forward-only"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="cuda|on "):
            call()  # past the grad check: the CPU tensor is refused

    def test_build_without_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build._nvcc()

    def test_package_imports_no_jax(self):
        code = ("import sys, garment4d_tpu_torch, garment4d_tpu_torch.api, "
                "garment4d_tpu_torch.data.synthetic; "
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'flax', 'garment4d_tpu')]; "
                "print(bad); sys.exit(1 if bad else 0)")
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr


def _replay_gather(plan, B, R, frames=None):
    """`gather.cu`'s index arithmetic for `plan`, block by block: (frame,
    slot, row, vector) int64 arrays of the slots written, per unrolled
    step of each frame's threads (`frames`: these frames only)."""
    T, U, CV = tops.pointcloud._GATHER_THREADS, plan["U"], plan["CV"]
    bpf = plan["blocks_per_frame"]
    for f in range(B) if frames is None else frames:
        block = f * bpf + np.arange(bpf, dtype=np.int64)
        b = (block * plan["frame_magic"]) >> plan["frame_shift"]
        assert (b == f).all()
        s0 = ((block - b * bpf)[:, None] * plan["tile"] + np.arange(T, dtype=np.int64)).ravel()
        for u in range(U):
            slot = s0 + u * T
            r = (slot * plan["magic"]) >> plan["shift"]
            keep = slot < R * CV
            yield np.int64(f), slot[keep], r[keep], (slot - r * CV)[keep]


# the scatter-adds of the canonical train step at the recipe's shape (B=20,
# T=10: 200 frames), (R, C, n) in launch order, and the PE backward's dtable
# scatter at garment pe0 unsplit (40 frames x 2000 centers x 32 slots)
CANONICAL_SCATTERS = [(4096, 99, 512), (2048, 99, 512), (16384, 67, 1722),
                      (8192, 67, 1722), (20670, 128, 1024), (3072, 256, 256),
                      (768, 384, 64), (4096, 195, 256), (2048, 195, 256),
                      (8192, 99, 1024), (4096, 99, 1024)]
# the PE backward's six shapes in the posed train step (C, S), F = G = 32
POSED_PE_BWD = [(6, 8), (6, 16), (6, 32), (67, 32), (99, 16), (387, 8)]


# the chain kernel's 16 shapes in a posed forward (C, S, widths, M): the 10
# set-abstraction chains of the canonical stage, the body PE blocks over
# the compacted table and the split garment PE blocks
POSED_CHAINS = [(3, 16, (16, 16, 32), 1024), (3, 32, (32, 32, 64), 1024),
                (99, 16, (32, 32, 64), 256), (99, 32, (64, 64, 128), 256),
                (195, 32, (64, 64, 128), 64), (195, 64, (128, 128, 256), 64),
                (67, 16, (32, 32), 512), (67, 32, (64, 64), 512),
                (99, 32, (128, 128), 64), (99, 64, (256, 256), 64),
                (6, 8, (32, 32), 2000), (6, 16, (32, 32), 2000), (6, 32, (32, 32), 2000),
                (35, 32, (32, 32), 2000), (35, 16, (32, 32), 2000), (35, 8, (32, 32), 2000)]
# the weights of these do not fit in shared memory beside the activations
STREAMED_CHAINS = {(195, 32), (195, 64), (99, 64)}
RING_BAND = (0, 1, 15, 16, 1984, 1985, 1999)  # the ring template's cyclic diagonals, V = 2000


class TestKernelPlans:
    """The host-side planning of the scatter-add, PE-backward, chain and
    GCN-layer wrappers: every shape of the main paths is planned, not
    refused, so that a ValueError shows here and not first on the card."""

    @settings(max_examples=80, deadline=None, derandomize=True, database=None)
    @given(C=st.integers(1, 1024), aligned=st.booleans(), R=st.integers(0, 300),
           B=st.integers(1, 3))
    def test_gather_plan_covers_once(self, C, aligned, R, B):
        """`gather.cu`'s slots replayed from `_gather_plan`: every output
        float written exactly once, from the row and channel it belongs
        to, the division by C / V exact; offsets in 64 bits (the last frame
        of 2^24 frames lies past 2^32 floats)."""
        plan = tops.pointcloud._gather_plan(R, C, aligned)
        V = plan["V"]
        assert V == (4 if C % 4 == 0 and aligned else 1) and plan["CV"] * V == C
        assert plan["U"] == (8 if V == 1 and C >= 32 else 4)
        assert plan["tile"] == tops.pointcloud._GATHER_THREADS * plan["U"]
        written = []
        for b, slot, r, c in _replay_gather(plan, B, R):
            assert (r == slot // plan["CV"]).all() and (c == slot % plan["CV"]).all()
            written.append(((b * R + r) * C + c * V)[:, None] + np.arange(V))
        flat = np.concatenate(written).ravel() if written else np.zeros(0, np.int64)
        np.testing.assert_array_equal(np.sort(flat), np.arange(B * R * C))
        far = 2 ** 24 - 1
        offsets = np.concatenate([(b * R + r) * C + c * V for b, _, r, c in
                                  _replay_gather(plan, 2 ** 24, R, frames=[far])])
        assert offsets.dtype == np.int64
        np.testing.assert_array_equal(np.sort(offsets), far * R * C + np.arange(0, R * C, V))

    @pytest.mark.parametrize("aligned", [False, True])
    def test_gather_plan_divider(self, aligned):
        """For every C up to 1024, at the largest frame the plan takes: the
        magic-number division exact at the frame's last slots and the
        block's padding past them (every slot a block computes a row of),
        and one row more refused."""
        for C in range(1, 1025):
            empty = tops.pointcloud._gather_plan(0, C, aligned)
            CV, tile = empty["CV"], empty["tile"]
            R = (2 ** 31 - tile) // CV
            plan = tops.pointcloud._gather_plan(R, C, aligned)
            top = plan["blocks_per_frame"] * tile
            assert top <= 2 ** 31 and plan["magic"] < 2 ** 32
            for s in (0, CV - 1, CV, R * CV - 1, top - tile, top - 1):
                assert (s * plan["magic"]) >> plan["shift"] == s // CV, (C, s)
            bpf = plan["blocks_per_frame"]
            for block in (0, bpf - 1, bpf, (2 ** 31 - 1) // bpf * bpf - 1, 2 ** 31 - 1):
                assert (block * plan["frame_magic"]) >> plan["frame_shift"] == block // bpf
            with pytest.raises(ValueError, match="past the kernel"):
                tops.pointcloud._gather_plan(R + 1, C, aligned)

    def test_gather_plan_refuses(self):
        for R, C in ((-1, 3), (5, 0)):
            with pytest.raises(ValueError):
                tops.pointcloud._gather_plan(R, C, True)

    @pytest.mark.parametrize("C,S,widths,M", POSED_CHAINS)
    def test_chain_plan_main_path(self, C, S, widths, M):
        """Groups of a power of two of centers, at most 512 rows; every
        layer gives each of the 256 threads an item; weights resident for
        the PE blocks (two blocks per SM), streamed (one item per thread) or
        read through L1 where they do not fit beside the activations; the
        max over S in warp shuffles for the PE blocks; the persistent
        grid."""
        plan = tops.pemax._chain_plan(C, S, widths, M)
        G, R = plan["G"], plan["R"]
        assert G & (G - 1) == 0 and R == G * S <= 512 and plan["Rp"] == R + 4
        assert plan["items"] == [256] * len(widths)
        assert plan["tcs"] == [tops.pemax._chain_tc(R, f) for f in widths]
        if (C, S) in STREAMED_CHAINS:
            assert plan["wmode"] != tops.pemax.RESIDENT
        assert (plan["kc"] > 0) == (plan["wmode"] == tops.pemax.STREAMED)
        limit = _build.SMEM_TWO_BLOCKS if plan["per_sm"] == 2 else _build.SMEM_LIMIT
        assert plan["smem"] <= limit
        assert plan["per_sm"] == 1 or plan["wmode"] != tops.pemax.STREAMED
        if C in (6, 35):  # the PE blocks: resident, two blocks per SM, no per-tile maxima
            assert plan["wmode"] == tops.pemax.RESIDENT and plan["per_sm"] == 2
            assert plan["direct"]
        blocks = tops.pemax._chain_grid(80, M, plan, 132)
        assert blocks == min(80 * -(-M // G), plan["per_sm"] * 132)

    @pytest.mark.parametrize("C,S,widths,M", POSED_CHAINS + [
        (6, 24, (4,), 33), (7, 16, (8, 12), 5), (3, 8, (16,), 1), (67, 32, (32, 64, 64, 128), 300)])
    def test_chain_layout(self, C, S, widths, M):
        """fused_chain.cu's regions in order, none overlapping, each a whole
        number of float4s, the chunk buffers three of kc rows of the widest
        layer; the plan's ints are ChainPlan's 33 fields."""
        plan = tops.pemax._chain_plan(C, S, widths, M)
        L, Rp = len(widths), plan["Rp"]
        h0 = max([widths[l] for l in range(0, L - 1, 2)], default=0) * Rp
        h1 = max([widths[l] for l in range(1, L - 1, 2)], default=0) * Rp
        x = _build.pitch(C) * (plan["R"] + plan["R"] // 8)  # quad planes of R + R / 8 float4s
        if plan["late"]:  # odd hidden layers in X's memory
            assert L >= 3
            x, h1 = max(x, h1), 0
        assert plan["x_off"] == 0 and plan["h_off"] == (x, 0 if plan["late"] else x + h0)
        assert plan["w_off"] == x + h0 + h1
        resident = sum(k * f for k, f in zip((C,) + widths[:-1], widths))
        w = {0: resident, 1: 3 * plan["kc"] * max(widths), 2: 0}[plan["wmode"]]
        part = 0 if plan["direct"] else plan["R"] // 8 * widths[-1]
        assert plan["part_off"] == plan["w_off"] + w
        assert plan["ib_off"] == plan["part_off"] + part
        assert plan["cb_off"] == plan["ib_off"] + 2 * plan["R"]
        assert plan["smem"] == 4 * (plan["cb_off"] + _build.pitch(6 * plan["G"]))
        assert all(o % 4 == 0 for o in (*plan["h_off"], plan["w_off"], plan["part_off"],
                                        plan["ib_off"], plan["cb_off"]))
        ints = tops.pemax._chain_plan_ints(C, S, widths, (True,) * L, plan)
        assert len(ints) == 33 and ints[:2] == [L, C] and ints[14] == 2 ** L - 1
        assert ints[19:21] == [_build.pitch(C) // 4, plan["R"] * 9 // 8]
        for f, tc, wt in zip(widths, plan["tcs"], plan["wts"]):  # 4 x 8 warp tiles
            assert wt == (f // tc >= 16 and f // tc % 8 == 0 and plan["R"] // 8 % 4 == 0)
        if plan["direct"]:  # a center's row tiles within a warp, ls lanes apart
            ls = 8 if plan["wts"][-1] else widths[-1] // plan["tcs"][-1]
            assert S // 8 * ls <= 32 and 32 % (S // 8 * ls) == 0

    def test_chain_plan_small_m(self):
        """A frame of few centers takes groups no larger than it needs."""
        assert tops.pemax._chain_plan(6, 32, (32, 32), 1)["G"] == 1
        assert tops.pemax._chain_plan(6, 8, (32, 32), 5)["G"] <= 8
        assert tops.pemax._chain_grid(2, 5, tops.pemax._chain_plan(6, 8, (32, 32), 5), 132) == 2

    @pytest.mark.parametrize("C,S,widths", [(2, 8, (32,)), (6, 12, (32,)), (6, 8, (30,)),
                                            (6, 8, (32,) * 5), (6, 1024, (32,)),
                                            (6, 8, ()), (4096, 64, (256, 256))])
    def test_chain_plan_refuses(self, C, S, widths):
        with pytest.raises(ValueError, match="fused_chain"):
            tops.pemax._chain_plan(C, S, widths, 100)

    @pytest.mark.parametrize("K,F", [(195, 128), (323, 128), (128, 128), (128, 3)])
    def test_gcn_plan_main_path(self, K, F):
        """The ring template's band (signed offsets -16..16): a window of
        160 rows; 128-wide layers on 128-column blocks within two blocks'
        shared memory; the 128 -> 3 layer on the narrow kernel."""
        plan = tops.graph._gcn_plan(2000, RING_BAND, K, F)
        assert plan["soff"] == [0, 1, 15, 16, -16, -15, -1] and plan["lo"] == -16
        assert plan["nw"] == 128 + 32
        assert plan["narrow"] == (F == 3)
        if plan["narrow"]:
            assert plan["Fp"] == plan["FT"] == 4
        else:
            assert plan["Fp"] == plan["FT"] == 128
        assert plan["smem"] <= _build.SMEM_TWO_BLOCKS

    @pytest.mark.parametrize("V,offsets,nw", [(200, (0, 1, 199), 130), (48, (0, 7, 40, 47), 143),
                                              (2000, (0, 1, 100, 1999), 0),
                                              (300, (0, 1, 150, 299), 0), (5, (0, 2, 3), 132)])
    def test_gcn_plan_window(self, V, offsets, nw):
        """The window holds the tile plus the signed span where it is at most
        64 rows; wider bands read their rows from L2 (nw = 0)."""
        plan = tops.graph._gcn_plan(V, offsets, 64, 128)
        assert plan["nw"] == nw
        assert all((s - o) % V == 0 and abs(s) <= V // 2 + 1
                   for s, o in zip(plan["soff"], offsets))

    @pytest.mark.parametrize("F,Fp,FT", [(8, 8, 8), (12, 16, 16), (136, 256, 128), (4, 4, 4),
                                         (1, 4, 4)])
    def test_gcn_plan_widths(self, F, Fp, FT):
        plan = tops.graph._gcn_plan(200, (0, 1, 199), 32, F)
        assert (plan["Fp"], plan["FT"]) == (Fp, FT) and plan["Fp"] % plan["FT"] == 0

    @pytest.mark.parametrize("widths,aligned", [
        ((3, 32, 32, 32, 32, 32, 32), (True,) * 7),
        ((3, 32, 32, 32, 32, 32, 32, 128), (True,) * 8), ((128,), (True,)),
        ((3, 5, 8), (True, True, False)), ((70,), (True,))])
    def test_gcn_chunks(self, widths, aligned):
        """The main path's first layers (the 3-wide piece, six 32-wide PEs,
        the 128-wide attention mix) and the 128-wide hidden layers in chunks
        of at most 32 channels, each within one piece and in order; 16-byte
        staging only for aligned pieces a multiple of 4 wide."""
        chunks = tops.graph._gcn_chunks(widths, aligned)
        kb = 0
        for p, off, first, kn, vec in chunks:
            assert first == kb and 1 <= kn <= 32 and off + kn <= widths[p]
            assert vec == int(aligned[p] and widths[p] % 4 == 0)
            kb += kn
        assert kb == sum(widths)
        assert len(chunks) == sum(-(-w // 32) for w in widths)
        if widths[:2] == (3, 32):
            assert chunks[0] == (0, 0, 0, 3, 0) and all(c[4] for c in chunks[1:])

    def test_gcn_chunks_refuses(self):
        with pytest.raises(ValueError, match="gcn_stack"):
            tops.graph._gcn_chunks((32,) * 65, (True,) * 65)

    @pytest.mark.parametrize("V,offsets,K,F", [(10, (), 8, 8), (10, (10,), 8, 8),
                                               (100, tuple(range(65)), 8, 8),
                                               (10, (0,), 20000, 3)])
    def test_gcn_plan_refuses(self, V, offsets, K, F):
        with pytest.raises(ValueError, match="gcn_stack"):
            tops.graph._gcn_plan(V, offsets, K, F)

    @pytest.mark.parametrize("B,R,C,n", [(200, *s) for s in CANONICAL_SCATTERS]
                             + [(40, 64000, 67, 2000)])
    @pytest.mark.parametrize("aligned", [True, False])
    def test_scatter_plan_main_path(self, B, R, C, n, aligned):
        """(V, J, lanes): float4 loads only for C % 4 == 0 and aligned
        pointers, a power-of-two lane group of at most a warp, J within the
        kernel's instantiations, and the chunks of lanes * J * V channels
        covering C; the sort's counts in shared memory; the scratch
        offsets within int32."""
        V, J, lanes = tops.pointcloud._scatter_plan(C, aligned)
        assert V == (4 if aligned and C % 4 == 0 else 1)
        assert J in ((1, 2) if V == 4 else (1, 2, 4, 8))
        assert lanes in (1, 2, 4, 8, 16, 32)
        chunk = lanes * J * V
        assert chunk >= min(C, 32 * J * V)
        assert -(-C // chunk) <= (1 if C <= 256 else 2)
        assert tops.pointcloud._scatter_hist_in_shared(n)
        assert R * C < 2 ** 31 and B * (n + 1) < 2 ** 31

    @pytest.mark.parametrize("C,want", [(0, (1, 1, 1)), (1, (1, 1, 1)), (3, (1, 1, 4)),
                                        (16, (4, 1, 4)), (387, (1, 8, 32)),
                                        (1024, (4, 2, 32))])
    def test_scatter_plan_edges(self, C, want):
        assert tops.pointcloud._scatter_plan(C, True) == want

    def test_scatter_plan_refuses(self):
        with pytest.raises(ValueError, match="C=1025"):
            tops.pointcloud._scatter_plan(1025, True)
        assert not tops.pointcloud._scatter_hist_in_shared(5000)  # counts in scratch

    @pytest.mark.parametrize("C,S", POSED_PE_BWD)
    def test_pe_bwd_plan_main_path(self, C, S):
        """Tiles of at most 256 rows, a power of two of centers, and two
        blocks' shared memory on one SM, as the fixed block count assumes;
        the layout of pe_bwd.cu holds k1, k1^T and the partition-combine
        buffer."""
        gc, smem = tops.pemax._pe_bwd_plan(C, S, 32, 32)
        assert gc >= 1 and gc & (gc - 1) == 0 and gc * S <= 256
        assert smem == tops.pemax._pe_bwd_smem(gc, S, C, 32, 32)
        assert smem <= tops.pemax._PE_BWD_TWO_BLOCKS
        assert smem >= (2 * 32 * 32 + 16 * 256) * 4

    @pytest.mark.parametrize("C,S,F,G", [(2, 8, 32, 32), (6, 8, 30, 32), (6, 8, 32, 6),
                                         (6, 8, 260, 4), (1000, 8, 32, 32),
                                         (6, 8, 128, 64)])
    def test_pe_bwd_plan_refuses(self, C, S, F, G):
        with pytest.raises(ValueError, match="pe_bwd"):
            tops.pemax._pe_bwd_plan(C, S, F, G)

    def test_pe_bwd_plan_limits(self):
        """The widest shapes the kernel takes: C*F and F*G at their limits
        (F = 256, and 387-wide tables) and S = 64 plan within one block."""
        for C, S, F, G in [(64, 8, 256, 16), (387, 8, 40, 100), (6, 64, 32, 32)]:
            gc, smem = tops.pemax._pe_bwd_plan(C, S, F, G)
            assert gc >= 1 and smem <= _build.SMEM_LIMIT

    @pytest.mark.parametrize("B", [8, 4])
    def test_knn_plan_main_path(self, B):
        """The posed forward's (B=8) and the posed train step's (B=4) K-NN
        transfer, 2000 garment vertices against the 6890-point body at
        K=256, K64=64, J=24: the body staged, 32 warps, candidate lists of
        at least 2K entries, the layout of knn_transfer.cu within one
        block's shared memory, at most one block per SM over the B
        elements, every vertex in one block's chunk, 8-bit digits into 256
        bins, at most 4 passes a threshold."""
        from garment4d_tpu_torch.models import skinning

        plan = skinning._knn_plan(B, 2000, 6890, 24, 256, 64, 132)
        assert plan["staged"] and plan["warps"] == 32
        assert plan["cap"] >= 2 * 256 and plan["cap"] % 32 == 0
        assert plan["smem"] == 16 + 16 * 6890 + 32 * (2 * 256 * 4 + 2 * plan["cap"])
        assert plan["smem"] <= _build.SMEM_LIMIT
        assert B * plan["per_b"] <= 132 and B * plan["per_b"] >= 128
        assert (plan["per_b"] - 1) * plan["chunk"] < 2000 <= plan["per_b"] * plan["chunk"]
        assert (plan["bins"], plan["passes"]) == (256, 4)

    @pytest.mark.parametrize("N,k,staged", [(20, 20, True), (1717, 256, True),
                                            (12000, 64, True), (20000, 300, False),
                                            (57000, 556, False)])
    def test_knn_plan_edges(self, N, k, staged):
        """Bodies up to the op's limit (N + 2k <= 58112): staged
        while at least 8 warps fit beside the body, else read through L1
        by 32 warps; lists no longer than N rounded up to 32."""
        from garment4d_tpu_torch.models import skinning

        plan = skinning._knn_plan(1, 45, N, 24, k, 1, 132)
        assert plan["staged"] == staged and plan["smem"] <= _build.SMEM_LIMIT
        assert plan["warps"] >= 8 and plan["warps"] == 32 or staged
        assert plan["cap"] <= -(-N // 32) * 32 and plan["cap"] >= min(N, 2 * k, 1024)
        assert plan["per_b"] * plan["chunk"] >= 45

    @pytest.mark.parametrize("N,J,k,k64", [(100, 33, 8, 8), (100, 0, 8, 8), (10, 24, 11, 8),
                                           (100, 24, 8, 9), (100, 24, 8, 0),
                                           (58000, 24, 100, 64)])
    def test_knn_plan_refuses(self, N, J, k, k64):
        from garment4d_tpu_torch.models import skinning

        with pytest.raises(ValueError, match="knn_transfer"):
            skinning._knn_plan(1, 10, N, J, k, k64, 132)

    @pytest.mark.parametrize("B", [80, 40])
    def test_grouped_plan_main_path(self, B):
        """The posed forward's (80 frames) and train step's (40) body
        queries, 2000 garment vertices over the 4992-row compacted table:
        every row staged in two blocks' shared memory, 16 warps a block,
        four waves of two blocks per SM, every warp a center."""
        plan = tops.pointcloud._grouped_plan(B, 4992, 2000, (8, 16, 32), 132)
        assert plan["rows"] == 4992 and plan["smem"] == 16 * 4992 <= _build.SMEM_TWO_BLOCKS
        assert plan["warps"] == 16 and plan["blocks"] * 16 <= 2000
        assert B * (plan["blocks"] - 1) < 4 * 2 * 132 <= B * plan["blocks"]

    @pytest.mark.parametrize("B,N,M,rows,blocks", [(1, 9000, 5, 7168, 1), (2, 30, 1, 128, 1),
                                                   (400, 4992, 2000, 4992, 3)])
    def test_grouped_plan_edges(self, B, N, M, rows, blocks):
        """Tables past two blocks' shared memory stage their first 7168
        rows; short tables are padded to a whole 128-row step; few centers
        take no more blocks than warps need; many frames keep a few blocks
        each."""
        plan = tops.pointcloud._grouped_plan(B, N, M, (8,), 132)
        assert (plan["rows"], plan["blocks"]) == (rows, blocks)

    @pytest.mark.parametrize("nsamples", [(), (8, 16, 32, 64), (8, 0)])
    def test_grouped_plan_refuses(self, nsamples):
        with pytest.raises(ValueError, match="ball_query_grouped"):
            tops.pointcloud._grouped_plan(80, 4992, 2000, nsamples, 132)

    @pytest.mark.parametrize("B", [80, 40])
    def test_coverage_plan_main_path(self, B):
        """The posed forward's (80 frames) and train step's (40) body
        coverage, 6890 points vs 2000 garment vertices: 512-thread blocks,
        a point a thread (14 blocks a frame), every center staged at once in
        whole 32-center tiles; four blocks' shared memory fit an SM."""
        plan = tops.pointcloud._coverage_plan(B, 6890, 2000)
        assert plan == dict(threads=512, blocks=14, tile=32, chunk=2016, dense=16,
                            smem=16 * 2016 + 32 * 63 + 16 * 512 + 4 * 512)
        assert 4 * plan["smem"] <= _build.SMEM_LIMIT

    @pytest.mark.parametrize("B,N,M,threads,chunk,blocks", [
        (1, 1, 1, 512, 32, 1), (3, 77, 45, 512, 64, 1), (8, 6890, 0, 512, 32, 14),
        (2, 10, 100000, 512, 4096, 1), (1, 0, 5, 512, 32, 0), (65535, 3, 3, 512, 32, 1),
        (80, 6890, 4097, 512, 4096, 14)])
    def test_coverage_plan_edges(self, B, N, M, threads, chunk, blocks):
        """512-thread blocks at every size; no center still stages one
        tile; more centers than 4096 stage 4096 at a time; no point, no
        block."""
        plan = tops.pointcloud._coverage_plan(B, N, M)
        assert (plan["threads"], plan["chunk"], plan["blocks"]) == (threads, chunk, blocks)
        assert plan["smem"] <= _build.SMEM_LIMIT

    @pytest.mark.parametrize("B,N,M", [(-1, 5, 5), (1, -5, 5), (1, 5, -1), (65536, 5, 5)])
    def test_coverage_plan_refuses(self, B, N, M):
        with pytest.raises(ValueError, match="covered_mask"):
            tops.pointcloud._coverage_plan(B, N, M)

    @pytest.mark.parametrize("N,npoint,threads,ppt", [
        (6890, 1024, 864, 8), (1024, 256, 256, 4), (256, 64, 32, 8), (1722, 512, 448, 4),
        (512, 64, 128, 4)])
    def test_fps_plan_main_path(self, N, npoint, threads, ppt):
        """The five FPS launches of every path (sa1-sa3, garment_sa1-2):
        sa1 on 27 warps of 8 points a thread in the kernel that skips far
        warps (its sorted frame 16 N bytes), sa3 on one warp (no barrier),
        the others on 4 points a thread; all in registers."""
        far = N == 6890
        for B in (80, 40, 200):
            plan = tops.pointcloud._fps_plan(B, N, npoint)
            assert plan == dict(threads=threads, ppt=ppt, staged=False, far=far, wide=False,
                                smem=(16 if far else 12) * N)

    @pytest.mark.parametrize("N,ppt,threads,staged,far", [
        (1, 1, 32, False, False), (33, 2, 32, False, False), (100, 4, 32, False, False),
        (256, 8, 32, False, False), (257, 4, 96, False, False), (4096, 4, 1024, False, False),
        (4097, 8, 544, False, True), (8192, 8, 1024, False, True),
        (8193, 16, 544, True, False), (14528, 16, 928, True, False)])
    def test_fps_plan_edges(self, N, ppt, threads, staged, far):
        """One warp up to 256 points, 4 points a thread up to 32 warps, then 8
        in the kernel that skips far warps, then the staged instance of 16
        up to the largest set (16 N bytes in shared memory, the parent
        kernel's limit)."""
        plan = tops.pointcloud._fps_plan(3, N, N)
        assert (plan["ppt"], plan["threads"], plan["staged"], plan["far"]) == (
            ppt, threads, staged, far)

    def test_fps_plan_takes_every_n_the_parent_took(self):
        """Every N with 16 N <= SMEM_LIMIT, at npoint 1 and N, and sampled N
        past it up to 2^20 (the wide kernel) at npoint 1, N and above N: a
        block of at most 1024 threads, a multiple of 32, covering the set
        with a kernel instance, and its dynamic shared memory beside the
        static (the slots, and for the far kernel the boxes and the sort's
        partials) in a block's shared memory; the wide kernel's threads
        each own a point, its running distances in device memory (no
        dynamic shared memory). npoint above N takes the same plan as
        npoint N."""
        pc = tops.pointcloud
        static = {"far": 2336}
        staged_n = _build.SMEM_LIMIT // 16
        wide_n = np.random.RandomState(19).randint(staged_n + 1, 2 ** 20 + 1, size=300)
        for N in [*range(1, staged_n + 1), *wide_n.tolist(), staged_n + 1, 2 ** 20]:
            npoints = (1, N) if N <= staged_n else (1, N, N + 1, 3 * N)
            for npoint in npoints:
                plan = pc._fps_plan(2, N, npoint)
                kind = "far" if plan["far"] else "wide" if plan["wide"] else None
                assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 1024
                assert plan["threads"] * plan["ppt"] >= N
                assert plan["smem"] + static.get(kind, 512) <= _build.SMEM_LIMIT
                assert plan["wide"] == (N > staged_n)
                if plan["wide"]:
                    assert plan["threads"] <= N and not plan["staged"] and plan["smem"] == 0
                else:
                    assert plan["ppt"] in pc._FPS_PPTS + (pc._FPS_STAGED_PPT,)
            if N % 97 == 1 or N > staged_n:
                assert pc._fps_plan(2, N, N + 5) == pc._fps_plan(2, N, N)

    @pytest.mark.parametrize("B,N,npoint,plan", [
        (1, 10, 11, (32, 1, False, 120)), (80, 512, 1024, (128, 4, False, 12 * 512)),
        (80, 128, 512, (32, 4, False, 12 * 128)), (4, 5, 12, (32, 1, False, 60)),
        (1, _build.SMEM_LIMIT // 16 + 1, 5, (1024, 15, True, 0)),
        (10, 20000, 1024, (1024, 20, True, 0)), (1, 2 ** 20, 2 ** 20 + 1, (1024, 1024, True, 0)),
        (10, 65536, 1024, (1024, 64, True, 0)), (0, 2 ** 20, 3, (1024, 1024, True, 0))])
    def test_fps_plan_accepts(self, B, N, npoint, plan):
        """What the parent kernel refused: more centers than points (the
        JAX package's SA1 and garment encoder at npoints 512 and 1536; the
        loop runs on) and sets past 16 N bytes of shared memory (the wide
        kernel: 1024 threads, the running distances in device memory, smem
        0)."""
        got = tops.pointcloud._fps_plan(B, N, npoint)
        assert (got["threads"], got["ppt"], got["wide"], got["smem"]) == plan
        assert not got["far"] and not got["staged"]

    @pytest.mark.parametrize("B,N,npoint", [(1, 10, 0), (-1, 10, 5), (1, 0, 5),
                                            (1, (2 ** 31 - 1) // 3 + 1, 5)])
    def test_fps_plan_refuses(self, B, N, npoint):
        """No center, a negative batch, an empty frame (the plain version has
        no argmax there), and a frame past the kernel's int offsets."""
        with pytest.raises(ValueError, match="fps"):
            tops.pointcloud._fps_plan(B, N, npoint)

    # the flat query's cases: (N, M, R) of the posed forward / train step
    # (80 / 40 frames) and the canonical train step (200 frames, one radius
    # a call); frames of at most 512 points take a lane per center
    FLAT_CASES = [(6890, 1024, 2), (1024, 256, 2), (256, 64, 2), (1722, 512, 2), (512, 64, 2),
                  (1722, 2000, 1), (512, 2000, 1), (64, 2000, 1)]

    @pytest.mark.parametrize("N,M,R", FLAT_CASES + [(6890, 1024, 1), (1024, 256, 1),
                                                     (256, 64, 1), (1722, 512, 1), (512, 64, 1)])
    def test_flat_plan_main_path(self, N, M, R):
        """Every flat case of the three paths is planned: frames past 512
        points sorted into 32-point tiles with a box per 32 tiles, staged
        with 32 warps a block and a bitmap row of the frame's indices (one
        window), blocks for the SMs' resident ones; smaller frames a lane
        per center, 4 warps a block, blocks enough for a frame's centers;
        the shared memory is the layout's."""
        for B in (80, 40, 200):
            plan = tops.pointcloud._flat_plan(B, N, M, R, 132)
            tiles = -(-N // 32)
            assert plan["tiles"] == tiles and plan["staged"]
            assert plan["smem"] <= _build.SMEM_LIMIT
            if N > 512:
                words = -(-tiles // 4) * 4
                assert plan["sort"] and plan["warps"] == 32 and plan["words"] == words
                assert plan["supers"] == -(-tiles // 32) and 32 * words >= N
                assert plan["smem"] == 16 * 32 * tiles + 32 * (tiles + plan["supers"]) \
                    + 4 * 32 * R * words
                resident = 1 if plan["smem"] > _build.SMEM_LIMIT // 2 else 2
                assert plan["blocks"] == min(132 * resident, -(-B * M // 32))
            else:
                assert not plan["sort"] and plan["warps"] == 4
                assert plan["smem"] == 16 * N and plan["blocks"] == -(-M // 128)

    @pytest.mark.parametrize("B,N,M,R,sort,staged,warps,windows", [
        (2, 0, 5, 1, False, True, 4, 0), (1, 1, 1, 3, False, True, 4, 0),
        (2, 513, 7, 3, True, True, 32, 1), (2, 8000, 40, 3, True, True, 16, 1),
        (2, 15000, 30, 1, True, False, 32, 1), (2, 20000, 50, 3, True, False, 16, 1),
        (2, 700000, 5, 3, True, False, 8, 10), (70000, 100, 4, 1, True, True, 32, 1)])
    def test_flat_plan_edges(self, B, N, M, R, sort, staged, warps, windows):
        """No point; one point; a frame just past the lane mode; a staged
        frame with fewer warps; frames past the staged size (read through
        L1) with every index in one window, and one whose bitmaps take ten
        windows; more frames than the grid's y (the lane mode's) holds."""
        plan = tops.pointcloud._flat_plan(B, N, M, R, 132)
        assert (plan["sort"], plan["staged"], plan["warps"]) == (sort, staged, warps)
        assert plan["smem"] <= _build.SMEM_LIMIT and plan["blocks"] >= 1
        if sort:
            assert -(-N // (32 * plan["words"])) == windows and plan["words"] % 4 == 0

    @pytest.mark.parametrize("B,N,M,R", [(1, 10, 5, 0), (1, 10, 5, 4), (-1, 10, 5, 1),
                                         (1, -3, 5, 1)])
    def test_flat_plan_refuses(self, B, N, M, R):
        with pytest.raises(ValueError, match="ball_query"):
            tops.pointcloud._flat_plan(B, N, M, R, 132)

    @pytest.mark.parametrize("n,m,sort", [(6890, 1024, True), (1024, 256, False),
                                          (256, 64, False)])
    def test_three_nn_plan_main_path(self, n, m, sort):
        """fp1-fp3 at 80, 40 and 200 frames: fp1's 1024 known points sorted
        into 8-point tiles with boxes, staged (20 KB), 8 warps a block; fp2
        and fp3 scanned whole in index order, 4 warps a block."""
        for B in (80, 40, 200):
            plan = tops.pointcloud._three_nn_plan(B, n, m)
            tiles = -(-m // 8)
            assert (plan["tile"], plan["tiles"], plan["sort"], plan["staged"]) == (
                8, tiles, sort, True)
            assert plan["warps"] == (8 if sort else 4)
            assert plan["smem"] == 16 * (8 + (2 if sort else 0)) * tiles

    @pytest.mark.parametrize("B,n,m,sort,staged", [(2, 1, 3, False, True), (2, 5, 256, False, True),
                                                   (2, 5, 257, True, True),
                                                   (2, 3000, 9000, True, False),
                                                   (65535, 1, 3, False, True)])
    def test_three_nn_plan_edges(self, B, n, m, sort, staged):
        """Three known points; the largest scanned set; the smallest sorted
        one; known points past two blocks' shared memory (read through L1,
        no shared memory); the grid's largest frame count."""
        plan = tops.pointcloud._three_nn_plan(B, n, m)
        assert (plan["sort"], plan["staged"]) == (sort, staged)
        assert plan["smem"] == (16 * (8 + (2 if sort else 0)) * plan["tiles"] if staged else 0)

    @pytest.mark.parametrize("B,n,m", [(1, 5, 2), (65536, 5, 5), (1, -1, 5)])
    def test_three_nn_plan_refuses(self, B, n, m):
        with pytest.raises(ValueError, match="three_nn"):
            tops.pointcloud._three_nn_plan(B, n, m)

    @pytest.mark.parametrize("B,warps", [(40, 21), (20, 11), (1, 8)])
    def test_nn1_plan_main_path(self, B, warps):
        """The loss's 2000 garment vertices against the 6890 body vertices in
        the posed train step (40 frames), the canonical train and eval steps
        (20) and the single-frame callers: sorted into 862 8-point tiles
        with boxes, staged (138 KB), blocks wide enough that a step's blocks
        fit on the 132 SMs at one a SM, 8 warps at least."""
        plan = tops.pointcloud._nn1_plan(B, 2000, 6890, 132)
        assert plan == dict(tile=8, tiles=862, sort=True, warps=warps, staged=True,
                            smem=16 * 10 * 862)
        assert B * -(-2000 // (32 * warps)) <= 132
        assert tops.pointcloud._nn1_plan(B, 2000, 6890, 66)["warps"] >= warps  # fewer SMs

    @pytest.mark.parametrize("B,M,N,sort,staged", [
        (2, 5, 1, False, True), (2, 5, 2, False, True), (2, 5, 9, False, True),
        (2, 5, 256, False, True), (2, 5, 257, True, True), (1, 0, 6890, True, True),
        (2, 5, 20000, True, False), (65535, 1, 1, False, True)])
    def test_nn1_plan_edges(self, B, M, N, sort, staged):
        """One to nine points; the largest scanned set; the smallest sorted
        one; no query; a set past the staging limit (read through L1, no
        shared memory); the grid's largest frame count. A few queries take
        the narrowest blocks."""
        plan = tops.pointcloud._nn1_plan(B, M, N, 132)
        assert (plan["sort"], plan["staged"], plan["tiles"]) == (sort, staged, -(-N // 8))
        assert plan["smem"] == (16 * (8 + (2 if sort else 0)) * plan["tiles"] if staged else 0)
        assert plan["warps"] == (8 if sort else 4)

    def test_nn1_plan_staging_limit(self, monkeypatch):
        """The sorted points and boxes are staged up to the plan's limit (160
        bytes a tile) and read through L1 past it; 3-NN's limit (two blocks
        an SM) would read the body through L1, in 8-warp blocks."""
        pc = tops.pointcloud
        edge = pc._NN1_STAGE_LIMIT // 160 * 8
        assert pc._nn1_plan(4, 100, edge, 132)["staged"]
        assert not pc._nn1_plan(4, 100, edge + 1, 132)["staged"]
        monkeypatch.setattr(pc, "_NN1_STAGE_LIMIT", _build.SMEM_TWO_BLOCKS)
        pc._nn1_plan.cache_clear()
        try:
            plan = pc._nn1_plan(40, 2000, 6890, 132)
        finally:
            pc._nn1_plan.cache_clear()
        assert (plan["staged"], plan["smem"], plan["warps"]) == (False, 0, 8)

    @pytest.mark.parametrize("B,M,N", [(1, 5, 0), (65536, 5, 5), (1, -1, 5), (-1, 5, 5)])
    def test_nn1_plan_refuses(self, B, M, N):
        with pytest.raises(ValueError, match="nn1"):
            tops.pointcloud._nn1_plan(B, M, N, 132)

    def test_knn_float64_witness(self, rng):
        """The float64 K-NN transfer that the card's checks hold the kernel
        to (`chip_smoke.knn_float64`), over the plain version's fp32
        selection (`chip_smoke.knn_plain_selection`): exactly k points a
        row, as a one-hot w0 reads back from the plain version wherever
        1/d^2 is finite; the plain version's weights to fp32 roundoff (rtol
        1e-5 / atol 1e-7), with ties at the k-th distance and zero
        distances."""
        from chip_smoke import knn_float64, knn_plain_selection
        from garment4d_tpu_torch.models import skinning

        base = rng.randn(2, 60, 3).astype(np.float32)
        body = _t(np.concatenate([base, base[:, :20]], 1))  # 20 points twice
        garment = _t(np.concatenate([base[:, :3], rng.randn(2, 9, 3).astype(np.float32)], 1))
        w0 = _t(rng.rand(2, 80, 24).astype(np.float32))
        d2 = tops.pointcloud.pairwise_sqdist(garment, body)
        finite = torch.isfinite(1.0 / d2)
        eye = torch.eye(80).expand(2, 80, 80)
        for k in (1, 7, 33, 80):
            sel = knn_plain_selection(d2, k)
            assert (sel.sum(-1) == k).all()
            q = skinning._knn_transfer_plain(garment, body, eye, k, k)[0]
            read = (q != 0) & ~torch.isnan(q)  # NaN: every selected point at distance 0
            assert torch.equal(read & finite, sel & finite)
            got = knn_float64(garment, body, w0, sel)
            assert got.dtype == torch.float64
            want = skinning._knn_transfer_plain(garment, body, w0, k, k)[0]
            np.testing.assert_allclose(_np(got.float()), _np(want), rtol=1e-5, atol=1e-7)


class TestWorkModels:
    """The data-dependent work that `chip_smoke.py` counts for the bounds of
    the culled coverage kernel (`coverage_work`) and the FPS kernel that
    skips far warps (`fps_work`): never less than the work that the data
    forces on any order of visits."""

    @pytest.mark.parametrize("N,npoint,far", [(300, 40, False), (4500, 60, True),
                                              (5000, 1, True)])
    def test_fps_work(self, rng, N, npoint, far):
        """Every point a step in the register kernel; in the far-skipping
        kernel a box test per run of 256 points a step after the first and,
        among the updates it counts, every one whose running distance
        drops (a run skipped there would change the result)."""
        from chip_smoke import fps_work

        xyz = _t(_cloud(rng, 2, N))
        assert tops.pointcloud._fps_plan(2, N, npoint)["far"] == far
        idx = tops.pointcloud._fps_plain(xyz, npoint)
        updates, boxes = fps_work(xyz, npoint, idx)
        if not far:
            assert (updates, boxes) == (2 * N * (npoint - 1), 0)
            return
        assert boxes == 2 * -(-N // 256) * max(npoint - 2, 0)
        drops = 0
        mind = torch.full((2, N), 1e10)
        for j in range(1, npoint):
            d2 = tops.pointcloud._sqdist(xyz, xyz[torch.arange(2), idx[:, j - 1].long()][:, None])
            drops += int((d2 < mind).sum())
            mind = torch.minimum(mind, d2)
        assert drops <= updates <= 2 * N * (npoint - 1)
        if npoint > 2:
            assert updates < 2 * N * (npoint - 1)  # the far runs of this cloud are skipped

    def test_coverage_work(self, rng):
        """Between the exact tests every covered point needs (one) plus the
        centers of the tiles that no cull can skip, and the first-hit
        linear scan's; a box test per open point and tile at most."""
        from chip_smoke import coverage_tests, coverage_work

        xyz = _t(_cloud(rng, 2, 700))
        centers = _t(_cloud(rng, 2, 90)) * 0.5 + 0.25
        r = 0.1
        exact, boxes = coverage_work(xyz, centers, r)
        mask = tops.pointcloud._covered_mask_plain(xyz, centers, r)
        assert int(mask.sum()) <= exact <= 2 * 700 * 90
        assert 0 < boxes <= 2 * 700 * 3
        far = coverage_work(xyz + 10.0, centers, r)
        assert far == (0, 2 * 700 * 3)  # every tile culled for every point
        assert coverage_tests(xyz + 10.0, centers, r) == 2 * 700 * 90

    @pytest.mark.parametrize("N,C,R,offset", [(50, 3, 40, 0), (50, 3, 40, 1), (9, 1, 30, 0),
                                              (20, 67, 12, 1), (16, 8, 64, 0), (7, 5, 0, 0)])
    def test_gather_bytes(self, rng, N, C, R, offset):
        """The row gather's bytes (`chip_smoke.gather_bytes`): the distinct
        32-byte sectors of the table that the rows read touch (wrapped
        negatives read, NaN rows not; duplicates and rows sharing a sector
        counted once), counted here by a walk over every index; plus the
        indices read and the rows written."""
        from chip_smoke import gather_bytes

        B = 2
        table = torch.from_numpy(rng.randn(B * N * C + offset).astype(np.float32))
        table = table[offset:].view(B, N, C)
        idx = torch.from_numpy(rng.randint(-N - 3, N + 3, size=(B, R)).astype(np.int32))
        sectors = set()
        for b in range(B):
            for i in idx[b].tolist():
                i = i + N if i < 0 else i
                if 0 <= i < N:
                    start = table.data_ptr() + 4 * (b * N + i) * C
                    sectors.update(range(start // 32, (start + 4 * C - 1) // 32 + 1))
        assert gather_bytes(table, idx) == 32 * len(sectors) + 4 * B * R + 4 * B * R * C
        assert gather_bytes(table, torch.full((B, R), N, dtype=torch.int32)) == 4 * B * R * (1 + C)


def _tied_cloud(draw_seed, B, N, lattice):
    """Points for the work models' tests: uniform, or (lattice) on an integer
    lattice of spacing 0.1, scrambled, with duplicates: exact distance ties
    at every rank and many points in one tile box."""
    g = np.random.RandomState(draw_seed)
    if lattice:
        pts = g.randint(0, 6, size=(B, N, 3)).astype(np.float32) * np.float32(0.1)
    else:
        pts = g.rand(B, N, 3).astype(np.float32)
    return _t(pts)


class TestFlatAndThreeNNWork:
    """The work models of the flat query (`chip_smoke.query_work`) and the
    3-NN (`three_nn_work`) that their bounds count: never less than the
    data forces. Every (center, point) hit lies in a tile the flat model
    keeps; each query's true three nearest (ties to the lower index) lie in
    tiles the 3-NN model keeps for it; and neither counts more than a full
    scan plus its box tests."""

    @settings(max_examples=12, deadline=None, derandomize=True, database=None)
    @given(seed=st.integers(0, 2 ** 16), n=st.integers(513, 900), m=st.integers(1, 40),
           lattice=st.booleans(), r=st.sampled_from([0.05, 0.1, 0.25]))
    def test_query_work_keeps_every_hit(self, seed, n, m, lattice, r):
        from chip_smoke import query_kept, query_work

        xyz = _tied_cloud(seed, 2, n, lattice)
        centers = _tied_cloud(seed + 1, 2, m, lattice)
        centers[:, : m // 2] = xyz[:, : m // 2]  # centers on points
        r2 = tops.pointcloud._r2(r)
        order, _, need = query_kept(xyz, centers, r2)
        tile_of = torch.empty_like(order)
        tile_of.scatter_(1, order, torch.arange(n).expand(2, n) // 32)
        hit = tops.pointcloud.pairwise_sqdist(centers, xyz) < r2  # (B, m, n)
        kept_for_hit = torch.gather(need, 2, tile_of[:, None, :].expand(2, m, n))
        assert bool(kept_for_hit[hit].all())
        outs = [tops.pointcloud._ball_query_plain(r, 16, xyz, centers)]
        exact, boxes, words = query_work(xyz, centers, (r,), outs)
        tiles = -(-n // 32)
        hit_tiles = torch.zeros(2, m, tiles, dtype=torch.bool)
        hit_tiles.scatter_(2, tile_of[:, None, :].expand(2, m, n), hit)
        assert 32 * int(hit_tiles.sum()) <= exact <= 2 * m * 32 * tiles
        assert 2 * m * -(-tiles // 32) <= boxes <= 2 * m * (tiles + -(-tiles // 32))
        assert words == 2 * m * (-(-tiles // 4) * 4)

    def test_query_work_lane_mode(self, rng):
        """Frames of at most 512 points: the index-order scan's tests up to
        each center's S-th hit (`scan_tests`), no box, no bitmap."""
        from chip_smoke import query_work, scan_tests

        xyz = _t(_cloud(rng, 2, 300))
        centers = xyz[:, :20].clone()
        outs = [tops.pointcloud._ball_query_plain(r, s, xyz, centers) for r, s in ((0.1, 8),
                                                                                 (0.3, 32))]
        work = query_work(xyz, centers, (0.1, 0.3), outs)
        assert work == (scan_tests(outs, torch.full((2,), 300)), 0, 0)

    @settings(max_examples=12, deadline=None, derandomize=True, database=None)
    @given(seed=st.integers(0, 2 ** 16), n=st.integers(1, 300), m=st.integers(257, 600),
           lattice=st.booleans())
    def test_three_nn_work_keeps_the_three_nearest(self, seed, n, m, lattice):
        from chip_smoke import nearest_kept, three_nn_work

        known = _tied_cloud(seed, 2, m, lattice)
        unknown = _tied_cloud(seed + 1, 2, n, lattice)
        unknown[:, : n // 2] = known[:, : n // 2]  # queries on known points
        d2, idx = tops.pointcloud._three_nn_plain(unknown, known)
        order_k, order_q, need = nearest_kept(unknown, known, d2, 8)
        tile_of = torch.empty_like(order_k)
        tile_of.scatter_(1, order_k, torch.arange(m).expand(2, m) // 8)
        rank_q = torch.empty_like(order_q)
        rank_q.scatter_(1, order_q, torch.arange(n).expand(2, n))
        need_q = torch.gather(need, 1, rank_q[..., None].expand_as(need))  # queries in index order
        nearest_tiles = torch.gather(tile_of, 1, idx.long().reshape(2, -1)).reshape(2, n, 3)
        assert bool(torch.gather(need_q, 2, nearest_tiles).all())
        tests, boxes = three_nn_work(unknown, known, d2)
        tiles = -(-m // 8)
        assert 8 * int(need_q.any(-1).sum()) <= tests <= 2 * n * 8 * tiles + 2 * 31 * 8 * tiles
        assert boxes >= 2 * -(-n // 32) * tiles

    def test_three_nn_work_scan(self, rng):
        """A known set of at most 256 points is scanned whole by every query."""
        from chip_smoke import three_nn_work

        unknown, known = _t(_cloud(rng, 3, 50)), _t(_cloud(rng, 3, 100))
        d2, _ = tops.pointcloud._three_nn_plain(unknown, known)
        assert three_nn_work(unknown, known, d2) == (3 * 50 * 104, 0)


    @settings(max_examples=12, deadline=None, derandomize=True, database=None)
    @given(seed=st.integers(0, 2 ** 16), n=st.integers(1, 300), m=st.integers(257, 600),
           lattice=st.booleans())
    def test_nn1_work_keeps_the_nearest(self, seed, n, m, lattice):
        """The 1-NN's model (`nn1_work`, the same code as the 3-NN's under
        `_nn1_plan`) keeps the tile of each query's nearest point (ties to
        the lower index) for it, on lattices of exact ties."""
        from chip_smoke import nearest_kept, nn1_work

        points = _tied_cloud(seed, 2, m, lattice)
        query = _tied_cloud(seed + 1, 2, n, lattice)
        query[:, : n // 2] = points[:, : n // 2]  # queries on points
        d2, idx = tops.pointcloud._nn1_plain(query, points)
        order_p, order_q, need = nearest_kept(query, points, d2[..., None], 8)
        tile_of = torch.empty_like(order_p)
        tile_of.scatter_(1, order_p, torch.arange(m).expand(2, m) // 8)
        rank_q = torch.empty_like(order_q)
        rank_q.scatter_(1, order_q, torch.arange(n).expand(2, n))
        need_q = torch.gather(need, 1, rank_q[..., None].expand_as(need))
        nearest_tile = torch.gather(tile_of, 1, idx.long())
        assert bool(torch.gather(need_q, 2, nearest_tile[..., None]).all())
        tests, boxes = nn1_work(query, points, d2)
        tiles = -(-m // 8)
        assert 8 * int(need_q.any(-1).sum()) <= tests <= 2 * n * 8 * tiles + 2 * 31 * 8 * tiles
        assert boxes >= 2 * -(-n // 32) * tiles

    def test_nn1_work_scan(self, rng):
        """A set of at most 256 points is scanned whole by every query."""
        from chip_smoke import nn1_work

        query, points = _t(_cloud(rng, 3, 50)), _t(_cloud(rng, 3, 100))
        d2, _ = tops.pointcloud._nn1_plain(query, points)
        assert nn1_work(query, points, d2) == (3 * 50 * 104, 0)


class TestNearestNaN:
    """The plain nearest-neighbour searches' rule for NaN input, which their
    kernels follow bitwise (CUDA edge tests): a NaN distance (a NaN point or
    query) is never taken, nor an infinite one, and a slot that no finite
    distance fills holds (+inf, 0). The JAX package's paths disagree among
    themselves there (`nn1_pallas`: NaN and an index past N; XLA's K=1
    path: NaN and the NaN point's index; its K=3 path skips NaN points), so
    the tests against JAX stay on finite inputs."""

    def _nan_cloud(self, rng, B, N, nan):
        pts = _t(_cloud(rng, B, N))
        pts[:, nan] = float("nan")
        return pts

    def test_nn1_skips_nan_points(self, rng):
        """A search with NaN points gives what the search over the other
        points gives, indices mapped back."""
        nan = [0, 3, 4, 50]
        points, query = self._nan_cloud(rng, 2, 60, nan), _t(_cloud(rng, 2, 40))
        keep = [i for i in range(60) if i not in nan]
        d2, idx = tops.pointcloud._nn1_plain(query, points)
        want_d2, want = tops.pointcloud._nn1_plain(query, points[:, keep])
        assert torch.equal(d2, want_d2)
        assert torch.equal(idx, torch.tensor(keep, dtype=torch.int32)[want.long()])

    def test_nn1_nan_query_and_no_finite_point(self, rng):
        """A NaN query, and queries whose points are all NaN or all too far
        for a finite fp32 distance, get (+inf, 0)."""
        points, query = _t(_cloud(rng, 3, 30)), _t(_cloud(rng, 3, 10))
        query[0, 2, 1] = float("nan")
        points[1] = float("nan")
        points[2, :, 0] = 3e38
        d2, idx = tops.pointcloud._nn1_plain(query, points)
        assert d2[0, 2] == float("inf") and idx[0, 2] == 0
        assert (d2[1:] == float("inf")).all() and (idx[1:] == 0).all()
        assert torch.isfinite(torch.cat([d2[0, :2], d2[0, 3:]])).all()

    def test_three_nn_skips_nan_points(self, rng):
        """A NaN known point no longer raises; the search gives what the
        search over the other points gives, indices mapped back."""
        nan = [1, 2, 30]
        known, unknown = self._nan_cloud(rng, 2, 40, nan), _t(_cloud(rng, 2, 25))
        keep = [i for i in range(40) if i not in nan]
        d2, idx = tops.pointcloud._three_nn_plain(unknown, known)
        want_d2, want = tops.pointcloud._three_nn_plain(unknown, known[:, keep])
        assert torch.equal(d2, want_d2)
        assert torch.equal(idx, torch.tensor(keep, dtype=torch.int32)[want.long()])

    def test_three_nn_open_slots(self, rng):
        """Fewer finite known points than three: the open slots hold (+inf,
        0); a NaN query holds them all."""
        known, unknown = self._nan_cloud(rng, 1, 4, [0, 2]), _t(_cloud(rng, 1, 6))
        unknown[0, 5] = float("nan")
        d2, idx = tops.pointcloud._three_nn_plain(unknown, known)
        assert (idx[0, :5, :2].sort(-1).values == torch.tensor([1, 3], dtype=torch.int32)).all()
        assert (d2[0, :5, 2] == float("inf")).all() and (idx[0, :5, 2] == 0).all()
        assert (d2[0, 5] == float("inf")).all() and (idx[0, 5] == 0).all()


class TestCoverageBound:
    """The coverage kernel skips a tile of centers where the float32 lower
    bound from a point to the tile's box is >= r^2 (`coverage.cu`'s header
    argues why that is exact). `_box_lower_bound` computes the kernel's
    arithmetic; these check the argument on float32 inputs."""

    coords = st.floats(min_value=-1e3, max_value=1e3, width=32, allow_nan=False,
                       allow_infinity=False)
    points = st.tuples(coords, coords, coords)

    @settings(max_examples=300, deadline=None, derandomize=True, database=None)
    @given(p=points, centers=st.lists(points, min_size=1, max_size=6))
    def test_bound_below_every_distance(self, p, centers):
        """lb(p, box of the centers) <= the fp32 diff-form d^2 of each center."""
        c = torch.tensor(centers, dtype=torch.float32)
        q = torch.tensor(p, dtype=torch.float32)
        lb = tops.pointcloud._box_lower_bound(q, c.amin(0), c.amax(0))
        d2 = tops.pointcloud._sqdist(c, q)
        assert lb.dtype == torch.float32
        assert bool((lb <= d2).all()), (lb.item(), d2.tolist())

    @settings(max_examples=300, deadline=None, derandomize=True, database=None)
    @given(c=points, ulps=st.integers(-3, 3),
           r=st.floats(min_value=2.0 ** -10, max_value=10.0, width=32),
           axis=st.integers(0, 2), sign=st.sampled_from([-1.0, 1.0]),
           spread=st.floats(min_value=0.0, max_value=5.0, width=32))
    def test_skip_only_without_a_hit(self, c, ulps, r, axis, sign, spread):
        """A point at r (up to 3 ulp either way) from a center on its box's
        face: where the bound is >= r^2 no center of the box is within r."""
        c = torch.tensor(c, dtype=torch.float32)
        p = c.clone()
        p[axis] = c[axis] + torch.tensor(sign * r, dtype=torch.float32)
        toward = torch.tensor(float("inf") if sign * ulps > 0 else float("-inf"))
        for _ in range(abs(ulps)):
            p[axis] = torch.nextafter(p[axis], toward)
        # the box: c as one corner, a second center spread away from the point
        far = c - torch.sign(p - c) * spread
        box = torch.stack([c, far])
        r2 = tops.pointcloud._f32(float(r) * float(r))
        lb = tops.pointcloud._box_lower_bound(p, box.amin(0), box.amax(0))
        hit = bool((tops.pointcloud._sqdist(box, p) < r2).any())
        if lb.item() >= r2:
            assert not hit
        assert lb.item() <= tops.pointcloud._sqdist(c, p).item()
