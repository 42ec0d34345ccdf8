"""Parity of the torch port's point-cloud ops and PointNet++ modules with the
JAX package, on the CPU.

The same numpy inputs (made from a seed) go through both packages. The JAX
side runs its CPU path, which tests/test_pallas_kernels.py holds to the
Pallas kernels in interpret mode; the port runs its plain torch versions,
which chip_smoke.py holds to the CUDA kernels on the card. Index outputs
must be bitwise equal; float outputs agree to fp32 roundoff (rtol 1e-5,
atol 1e-5: matmul summation order differs between XLA and torch).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

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
        got = tops.query_group_pe_multi(radii, ns, _t(xyz), _t(centers), _t(feats),
                                        [tuple(_t(a) for a in p) for p in params])
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
                                         "knn_transfer", "gcn_stack"])
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
