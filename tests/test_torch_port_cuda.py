"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device: it is marked `cuda` and skips where
there is none (the CPU test run). On a GPU machine, without JAX:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

The shapes are the awkward ones the forward does not reach: ragged tiles,
one point, no-hit centers, odd radius counts, 1- to 4-layer chains with a
linear last layer, points at exactly the radius, empty and full valid
counts, distance ties at the k-th neighbour and zero distances, GCN frames
that are not a multiple of the vertex tile with offsets near V. Indices and
masks must be bitwise equal; the fused chain and the GCN stack agree within
rtol 1e-4 / atol 1e-5, the K-NN weights within rtol 1e-4 / atol 1e-6 (fp32
summation order).
"""

import numpy as np
import pytest
import torch

from garment4d_tpu_torch import ops
from garment4d_tpu_torch.models import skinning
from garment4d_tpu_torch.nn import SAModuleMSG
from garment4d_tpu_torch.ops import graph, pemax
from garment4d_tpu_torch.ops import pointcloud as pc

pytestmark = pytest.mark.cuda
CHAIN_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def cloud(seed, B, N, dup=0, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand(B, N, 3, generator=g)
    if dup:
        pts[:, N - dup:] = pts[:, :dup]
    return pts.to(device)


@pytest.mark.parametrize("N,npoint", [(1, 1), (5, 5), (1000, 3), (2049, 512), (6890, 64)])
def test_fps(dev, N, npoint):
    xyz = cloud(0, 3, N, dup=N // 4)
    got = pc._fps_kernel(xyz, npoint)
    torch.testing.assert_close(got, pc._fps_plain(xyz, npoint), rtol=0, atol=0)


@pytest.mark.parametrize("radii,ns", [
    ((0.1,), (1,)), ((0.1, 0.2), (16, 32)), ((0.05, 0.1, 0.3), (8, 16, 24))])
@pytest.mark.parametrize("N,M", [(7, 3), (1500, 333)])
def test_ball_query(dev, radii, ns, N, M):
    xyz = cloud(1, 2, N, dup=N // 5)
    centers = torch.cat([xyz[:, :M - 2], torch.full((2, 2, 3), 9.0, device=dev)], 1)
    got = pc._ball_query_kernel(radii, ns, xyz, centers)
    for g, r, s in zip(got, radii, ns):
        torch.testing.assert_close(g, pc._ball_query_plain(r, s, xyz, centers),
                                   rtol=0, atol=0)
        assert (g[:, -2:] == 0).all()  # no hit -> all slots 0


@pytest.mark.parametrize("n,m", [(1, 3), (100, 3), (3000, 1500)])
def test_three_nn(dev, n, m):
    known = cloud(2, 2, m, dup=m // 3)
    unknown = cloud(3, 2, n)
    unknown[:, : min(n, m)] = known[:, : min(n, m)]  # zero-distance ties
    dk, ik = pc._three_nn_kernel(unknown, known)
    dp, ip = pc._three_nn_plain(unknown, known)
    torch.testing.assert_close(ik, ip, rtol=0, atol=0)
    torch.testing.assert_close(dk, dp, rtol=0, atol=0)


@pytest.mark.parametrize("C,offset", [(1, 0), (5, 0), (128, 0), (128, 1), (130, 0)])
def test_gather_rows(dev, C, offset):
    """Narrow, float4-wide, misaligned (storage offset 4 bytes) and ragged rows."""
    g = torch.Generator().manual_seed(4)
    flat = torch.randn(offset + 3 * 50 * C, generator=g).to(dev)
    table = flat[offset:].view(3, 50, C)
    idx = torch.randint(0, 50, (3, 77), generator=g, dtype=torch.int32).to(dev)
    got = pc._gather_rows_kernel(table, idx)
    torch.testing.assert_close(got, pc._gather_rows_plain(table, idx), rtol=0, atol=0)
    idx[0, 0] = 50  # out of range -> NaN row, never a stray read
    assert torch.isnan(pc._gather_rows_kernel(table, idx)[0, 0]).all()


@pytest.mark.parametrize("C,widths,relus,S,M", [
    (3, (16,), (False,), 8, 1),
    (6, (32, 32), (True, False), 12, 9),  # S padded to 16 with slot 0
    (35, (32, 32), (True, False), 4, 70),
    (7, (8, 12), (True, False), 16, 5),
    (67, (32, 64, 64, 128), (True, True, True, True), 32, 300),
    (195, (128, 128, 256), (True, True, True), 64, 64),
    (99, (256, 256), (True, False), 64, 7),
])
def test_fused_chain(dev, C, widths, relus, S, M):
    g = torch.Generator().manual_seed(5)
    B, N = 2, 300
    table = torch.randn(B, N, C, generator=g).to(dev)
    idx = torch.randint(0, N, (B, M, S), generator=g, dtype=torch.int32).to(dev)
    centers = torch.randn(B, M, 3, generator=g).to(dev)
    ws, bs, c = [], [], C
    for w in widths:
        ws.append((torch.randn(c, w, generator=g) / c ** 0.5).to(dev))
        bs.append((0.1 * torch.randn(w, generator=g)).to(dev))
        c = w
    got = pemax._chain_kernel(table, idx, centers, ws, bs, relus)
    want = pemax._chain_reference(table, idx, centers, ws, bs, relus)
    torch.testing.assert_close(got, want, **CHAIN_TOL)


def test_fused_chain_refuses_unsupported_shapes(dev):
    table = torch.zeros(1, 10, 3, device=dev)
    centers = torch.zeros(1, 2, 3, device=dev)
    with pytest.raises(ValueError, match="multiples of 4"):
        pemax._chain_kernel(table, torch.zeros(1, 2, 8, dtype=torch.int32, device=dev),
                            centers, [torch.zeros(3, 6, device=dev)],
                            [torch.zeros(6, device=dev)], (True,))


def test_wrappers_refuse_wrong_dtypes(dev):
    with pytest.raises(TypeError):
        pc._fps_kernel(cloud(0, 1, 10).double(), 4)
    with pytest.raises(TypeError):
        pc._gather_rows_kernel(torch.zeros(1, 4, 2, device=dev),
                               torch.zeros(1, 3, dtype=torch.int64, device=dev))


def test_each_wrapper_counts_one_launch(dev):
    xyz = cloud(6, 1, 64)
    ops.reset_counts()
    idx = ops.furthest_point_sample(xyz, 8)
    ctr = ops.gather_points(xyz, idx)
    ops.ball_query_multi((0.2, 0.4), (8, 16), xyz, ctr)  # two radii, one launch
    ops.three_nn(xyz, ctr)
    assert dict(ops.launch_counts) == {"fps": 1, "gather_rows": 1,
                                       "ball_query": 1, "three_nn": 1}
    with ops.plain_ops():
        ops.furthest_point_sample(xyz, 8)
    assert ops.launch_counts["fps"] == 1


@torch.no_grad()
def test_sa_module_fused_matches_plain(dev):
    torch.manual_seed(0)
    sa = SAModuleMSG(128, (0.15, 0.3), (16, 32), ((16, 16, 32), (32, 64)), 6).to(dev)
    for m in sa.modules():  # BatchNorm away from its init
        if isinstance(m, torch.nn.BatchNorm1d):
            m.running_mean.uniform_(-0.1, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    sa.eval()
    xyz, feats = cloud(7, 2, 700), torch.randn(2, 700, 6, device=dev)
    ops.reset_counts()
    kx, kf = sa(xyz, feats)
    assert ops.launch_counts["fused_chain"] == 2
    with ops.plain_ops():
        px, pf = sa(xyz, feats)
    torch.testing.assert_close(kx, px, rtol=0, atol=0)
    torch.testing.assert_close(kf, pf, **CHAIN_TOL)


def test_forward_only_kernels_refuse_autograd(dev):
    """The kernels have no backward: training on the card raises at the
    first kernel whose input requires grad, instead of cutting the gradient
    off; the plain versions inside `plain_ops()` still differentiate."""
    torch.manual_seed(0)
    sa = SAModuleMSG(64, (0.2, 0.4), (8, 16), ((16, 32), (32, 32)), 6).to(dev)
    xyz = cloud(8, 2, 300)
    feats = torch.randn(2, 300, 6, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="gather_rows: the CUDA kernel is forward-only"):
        sa.train()(xyz, feats)[1].sum().backward()
    with pytest.raises(RuntimeError, match="fused_chain: the CUDA kernel is forward-only"):
        sa.eval()(xyz, feats.detach())[1].sum().backward()
    with ops.plain_ops():
        sa.train()(xyz, feats)[1].sum().backward()
    assert feats.grad is not None and torch.isfinite(feats.grad).all()
    assert sa.mlp0.layer0.conv.weight.grad is not None
    with torch.no_grad():  # eval under no_grad: the fused kernels run
        sa.eval()(xyz, feats)


def test_canonical_cuda_matches_cpu(dev):
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.models import GarmentAssets
    from garment4d_tpu_torch.smpl import synthetic_smpl

    torch.manual_seed(0)
    assets = GarmentAssets.synthetic(num_rings=12, ring_size=16)
    body = synthetic_smpl(400, device="cpu")
    batch = make_batch(assets, body, batch_size=1, T=2, npoints=2048, device="cpu")
    cpu = GarmentReconstructor.from_assets(assets, body, device="cpu")
    gpu = GarmentReconstructor.from_assets(
        assets, body, dev, state_dict=cpu.model.state_dict())
    want, got = cpu.run(batch["pcd"]), gpu.run(batch["pcd"])
    np.testing.assert_allclose(got.backbone.sem_logits.cpu().numpy(),
                               want.backbone.sem_logits.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.tpose_garment.cpu().numpy(),
                               want.tpose_garment.numpy(), atol=1e-4)


# ---- posed-stage kernels ---------------------------------------------------

KNN_TOL = dict(rtol=1e-4, atol=1e-6)


def boundary_cloud(radius, center=(0.3, 0.2, 0.1)):
    """Points at exactly r from `center` and r -+ 1, 2 ulp along each axis."""
    c = np.array(center, np.float32)
    r = np.float32(radius)
    lo, hi = np.nextafter(r, np.float32(0)), np.nextafter(r, np.float32(1))
    pts = []
    for o in (r, lo, hi, np.nextafter(lo, np.float32(0)), np.nextafter(hi, np.float32(1))):
        for axis in range(3):
            for sign in (1.0, -1.0):
                p = c.copy()
                p[axis] = np.float32(p[axis] + np.float32(sign) * o)
                pts.append(p)
    return torch.from_numpy(np.stack(pts)), torch.from_numpy(c)


@pytest.mark.parametrize("radius", [0.1, 0.4])
@pytest.mark.parametrize("N,M", [(1, 1), (300, 7), (6890, 2000)])
def test_coverage(dev, radius, N, M):
    pts, c = boundary_cloud(radius)
    xyz = torch.cat([cloud(10, 2, N, device="cpu") * 2 - 0.5, pts.expand(2, -1, -1)], 1)
    centers = torch.cat([c.expand(2, 1, 3), cloud(11, 2, M, device="cpu") * 2 - 0.5], 1)
    xyz, centers = xyz.contiguous().to(dev), centers.contiguous().to(dev)
    got = pc._covered_mask_kernel(xyz, centers, radius)
    torch.testing.assert_close(got, pc._covered_mask_plain(xyz, centers, radius),
                               rtol=0, atol=0)


@pytest.mark.parametrize("radii,ns", [((0.2,), (8,)), ((0.1, 0.3), (8, 16)),
                                      ((0.1, 0.2, 0.4), (8, 16, 32))])
def test_ball_query_grouped(dev, radii, ns):
    """n_valid 0, partial (sentinels, and real points past it) and cap."""
    cap, M = 1500, 333
    table = cloud(12, 4, cap, device="cpu") * 0.8
    n_valid = torch.tensor([0, 700, 1100, cap], dtype=torch.int32)
    table[1, 700:] = 1e9
    centers = torch.cat([cloud(13, 4, M - 2, device="cpu") * 0.8,
                         torch.full((4, 2, 3), 9.0)], 1)
    table, centers, n_valid = table.to(dev), centers.to(dev), n_valid.to(dev)
    got = pc._ball_query_grouped_kernel(radii, ns, table, centers, n_valid)
    for g, r, s in zip(got, radii, ns):
        want = pc._ball_query_plain(r, s, table, centers, n_valid)
        torch.testing.assert_close(g, want, rtol=0, atol=0)
        assert (g[0] == 0).all() and (g[:, -2:] == 0).all()
    full = pc._ball_query_grouped_kernel(radii, ns, table[3:], centers[3:], n_valid[3:])
    for g, f in zip(got, full):  # n_valid = cap is the plain full scan
        torch.testing.assert_close(g[3:], f, rtol=0, atol=0)


@pytest.mark.parametrize("k,k64", [(16, 16), (96, 64), (256, 64)])
@pytest.mark.parametrize("J", [24, 5])
def test_knn_transfer(dev, k, k64, J):
    """Every body point 4x duplicated (ties at the k-th distance), garment
    vertices on body points (zero distance: an inf weight, zeroed), N not
    a multiple of 32, Vg not a multiple of the block's rows."""
    g = torch.Generator().manual_seed(14)
    base = torch.randn(2, 431, 3, generator=g)
    body = base.repeat(1, 4, 1)[:, :1717]
    garment = torch.cat([body[:, :40] + 0.01, body[:, 100:103]], 1)
    w0 = torch.rand(2, body.shape[1], J, generator=g)
    args = [t.contiguous().to(dev) for t in (garment, body, w0)]
    kk, k6, ki = skinning._knn_transfer_kernel(*args, k, k64)
    pk, p6, pi = skinning._knn_transfer_plain(*args, k, k64)
    torch.testing.assert_close(ki, pi, rtol=0, atol=0)
    torch.testing.assert_close(kk, pk, **KNN_TOL)
    torch.testing.assert_close(k6, p6, **KNN_TOL)
    assert torch.isfinite(kk).all()


@pytest.mark.parametrize("V,offsets", [(48, (0, 1, 7, 8, 40, 41, 47)),
                                       (200, (0, 1, 199)),
                                       (2000, (0, 1, 15, 16, 1984, 1985, 1999))])
@pytest.mark.parametrize("attn", [False, True])
def test_gcn_stack(dev, V, offsets, attn):
    g = torch.Generator().manual_seed(15)
    widths = [3, 32, 32, 32, 32, 32, 32] + ([128] if attn else [])
    xs = [torch.randn(3, V, w, generator=g).to(dev) for w in widths]
    dims = (sum(widths), 128, 128, 128, 3)
    ws = [(torch.randn(a, b, generator=g) / a ** 0.5).to(dev) for a, b in zip(dims, dims[1:])]
    bs = [(0.1 * torch.randn(b, generator=g)).to(dev) for b in dims[1:]]
    vals = torch.rand(len(offsets), V, generator=g).to(dev)
    adj = torch.zeros(V, V)
    rows = torch.arange(V)
    for d, o in enumerate(offsets):
        adj[rows, (rows + o) % V] = vals[d].cpu()
    adj = adj.to(dev)
    torch.testing.assert_close(graph.diagonal_values(adj, offsets), vals, rtol=0, atol=0)
    relus = (True, True, True, False)
    ko, kh = graph._gcn_stack_kernel(xs, ws, bs, vals, offsets, relus, 2)
    po, ph = graph._gcn_stack_ref(xs, ws, bs, adj, offsets, relus, 2)
    assert ko.shape == (3, V, 3) and kh.shape == (3, V, 128)
    torch.testing.assert_close(ko, po, **CHAIN_TOL)
    torch.testing.assert_close(kh, ph, **CHAIN_TOL)


def test_posed_wrappers_refuse_autograd(dev):
    x = torch.zeros(1, 16, 3, device=dev, requires_grad=True)
    w = torch.zeros(3, 8, device=dev)
    with pytest.raises(RuntimeError, match="knn_transfer: the CUDA kernel is forward-only"):
        skinning.knn_transfer(x, x.detach(), torch.zeros(1, 16, 4, device=dev), 2, 2)
    with pytest.raises(RuntimeError, match="gcn_stack: the CUDA kernel is forward-only"):
        ops.gcn_stack([x], [w], [torch.zeros(8, device=dev)],
                      torch.eye(16, device=dev), (0,), (True,), 0)
    with pytest.raises(RuntimeError, match="group_pe_max: the CUDA kernel is forward-only"):
        ops.group_pe_max(x, torch.zeros(1, 2, 8, dtype=torch.int32, device=dev),
                         x[:, :2].detach(), w, torch.zeros(8, device=dev),
                         torch.zeros(8, 8, device=dev), torch.zeros(8, device=dev))
    with torch.no_grad():  # the same calls launch under no_grad
        skinning.knn_transfer(x, x, torch.zeros(1, 16, 4, device=dev), 2, 2)


def test_posed_wrappers_count_launches(dev):
    xyz = cloud(16, 2, 1200)
    centers = xyz[:, :50].contiguous()
    ops.reset_counts()
    ops.covered_mask(xyz, centers, 0.3)
    ops.ball_query_multi((0.1, 0.2, 0.4), (8, 16, 32), xyz, centers,
                         n_valid=torch.full((2,), 1200, dtype=torch.int32, device=dev))
    skinning.knn_transfer(centers, xyz, torch.rand(2, 1200, 24, device=dev), 16, 16)
    ops.gcn_stack([xyz[:, :48]], [torch.zeros(3, 4, device=dev)], [torch.zeros(4, device=dev)],
                  torch.eye(48, device=dev), (0,), (True,), 0)
    assert dict(ops.launch_counts) == {"coverage": 1, "ball_query_grouped": 1,
                                       "knn_transfer": 1, "gcn_stack": 1}


@pytest.mark.parametrize("shuffle", [False, True])
def test_posed_cuda_matches_cpu(dev, shuffle):
    """The posed forward on the card against the plain path on the CPU,
    at random weights; the shuffled template runs the RCM band order."""
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.models import GarmentAssets
    from garment4d_tpu_torch.smpl import synthetic_smpl
    from garment4d_tpu_torch.train.step import body_inputs_from_batch

    torch.manual_seed(0)
    assets = GarmentAssets.synthetic(num_rings=12, ring_size=16)
    if shuffle:
        perm = np.random.RandomState(11).permutation(assets.num_verts)
        inv = np.argsort(perm)
        assets = GarmentAssets.build(
            assets.name, assets.template_v[perm], [[int(inv[i]) for i in f] for f in assets.faces],
            assets.pca_components.reshape(-1, assets.num_verts, 3)[:, perm].reshape(
                assets.pca_dim, -1),
            assets.pca_mean.reshape(-1, 3)[perm].reshape(-1), assets.pca_explained,
            assets.pca_scale)
    body = synthetic_smpl(1100, device="cpu")
    batch = make_batch(assets, body, batch_size=1, T=2, npoints=2048, device="cpu")
    cpu = GarmentReconstructor.from_assets(assets, body, device="cpu", lbs_k=64)
    gpu = GarmentReconstructor.from_assets(assets, body, dev, lbs_k=64,
                                           state_dict=cpu.model.state_dict())
    assert gpu.model.band_reordered == shuffle
    want = cpu.posed(batch["pcd"], body_inputs_from_batch(batch), return_all=True)
    ops.reset_counts()
    got = gpu.posed(batch["pcd"], body_inputs_from_batch(batch), return_all=True)
    assert all(ops.launch_counts[k] > 0 for k in (
        "coverage", "ball_query_grouped", "group_pe_max", "knn_transfer", "gcn_stack"))
    np.testing.assert_array_equal(got.lbs.nn_idx.cpu().numpy(), want.lbs.nn_idx.numpy())
    for a, b in zip(got.iter_garment_v, want.iter_garment_v):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)
