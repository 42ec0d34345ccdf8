"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device: it is marked `cuda` and skips where
there is none (the CPU test run). On a GPU machine, without JAX:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

The shapes are the awkward ones the forward does not reach: ragged tiles,
one point, no-hit centers, odd radius counts, 1- to 4-layer chains with a
linear last layer (widths 4 to 256, tables 3 to 195 wide, S not a multiple
of the 8-row tile, resident and streamed weights, more groups of centers
than resident blocks with a partial last one, an out-of-range index giving
its center NaN), points at exactly the radius, empty and full valid
counts, distance ties at the k-th neighbour and zero distances, GCN frames
that are not a multiple of the 128-vertex tile or below it, with offsets
near V (staged window) and a band wider than the window, 1 to 8 pieces, the
narrow last layer and widths off the column tile, 1-NN ties and
tables around the 2048-point tile, banded products with 1 to 64 diagonals at
C = 3, 5 and 128 and their transposes, PE backwards with padded S (1, 4,
12), every slot tied, one slot winning every channel, a zero cotangent and
tables up to 387 wide, with and without their dtable half, scatter-adds
with every row or 90% of them into one index, ragged R, R = 0, C from 1 to
1024, one output row, more output rows than the sort's counts in shared
memory hold, and out-of-range indices, and the valid-count PE call's flag.
Indices, masks, the 1-NN, the banded product and the scatter-add (against
the CPU's ascending-order sum) must be bitwise equal; the fused chain, the GCN
stack and the PE backward's dcenters agree within rtol 1e-4 / atol 1e-5,
its weight gradients and dtable within 1e-4 of their largest magnitude,
the K-NN weights within rtol 1e-4 / atol 1e-6 (fp32 summation order); two
chain, GCN-stack, PE-backward or scatter-add launches are bitwise equal. A small posed train
step on the card matches the CPU's; an SA stage trains through the
gathers' scatter-add and the chain kernel's backward.
"""

import contextlib
import itertools

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


def _chain_inputs(seed, B, N, M, S, C, widths, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(B, N, C, generator=g).to(device)
    idx = torch.randint(0, N, (B, M, S), generator=g, dtype=torch.int32).to(device)
    centers = torch.randn(B, M, 3, generator=g).to(device)
    ws, bs, c = [], [], C
    for w in widths:
        ws.append((torch.randn(c, w, generator=g) / c ** 0.5).to(device))
        bs.append((0.1 * torch.randn(w, generator=g)).to(device))
        c = w
    return table, idx, centers, ws, bs


@pytest.mark.parametrize("C,widths,relus,S,M", [
    (3, (16,), (False,), 8, 1),
    (6, (32, 32), (True, False), 12, 9),  # S padded to 16 with slot 0
    (35, (32, 32), (True, False), 4, 70),
    (7, (8, 12), (True, False), 16, 5),
    (67, (32, 64, 64, 128), (True, True, True, True), 32, 300),
    (195, (128, 128, 256), (True, True, True), 64, 64),
    (99, (256, 256), (True, False), 64, 7),
    # the redesign's plans: widths 4 / 8 / 12, a center's row tiles not a
    # power of two (S=24: maxima through shared memory), resident weights
    # at the PE and SA shapes with 8 x 8 and 8 x 4 tiles, streamed weights
    # (sa3 / garment_sa2 at S=64, sa3 at S=32), table widths 3 to 195
    (6, (4,), (True,), 24, 33),
    (3, (8, 12, 4), (True, True, False), 16, 50),
    (6, (32, 32), (True, False), 32, 2000),
    (35, (32, 32), (True, False), 32, 2000),
    (35, (32, 32), (True, False), 8, 517),
    (3, (16, 16, 32), (True, True, True), 16, 1024),
    (99, (64, 64, 128), (True, True, True), 32, 256),
    (195, (64, 64, 128), (True, True, True), 32, 64),
    (67, (64, 64), (True, True), 32, 512),
    (99, (128, 128), (True, True), 32, 64),
    (99, (256, 256), (True, True), 64, 64),
])
def test_fused_chain(dev, C, widths, relus, S, M):
    """Against the plain version, and two launches bitwise equal."""
    table, idx, centers, ws, bs = _chain_inputs(5, 2, 300, M, S, C, widths)
    got = pemax._chain_kernel(table, idx, centers, ws, bs, relus)
    want = pemax._chain_reference(table, idx, centers, ws, bs, relus)
    torch.testing.assert_close(got, want, **CHAIN_TOL)
    torch.testing.assert_close(pemax._chain_kernel(table, idx, centers, ws, bs, relus), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("C,widths,relus,S,M", [
    (6, (32, 32), (True, False), 32, 300), (35, (32, 32), (True, False), 8, 517),
    (195, (128, 128, 256), (True, True, True), 64, 20), (99, (256, 256), (True, True), 64, 9),
    (67, (32, 64, 64, 128), (True, True, True, False), 32, 30)])
def test_fused_chain_weight_modes(dev, monkeypatch, C, widths, relus, S, M):
    """Weights resident in shared memory, streamed through it in chunks and
    read through L1, each with and without the odd hidden layers in X's
    memory, forced by the plan's scores: within the tolerance of the plain
    version and bitwise equal to one another (every output sums in the
    same order)."""
    table, idx, centers, ws, bs = _chain_inputs(8, 2, 300, M, S, C, widths)
    want = pemax._chain_reference(table, idx, centers, ws, bs, relus)
    modes = (pemax.RESIDENT, pemax.STREAMED, pemax.THROUGH_L1)
    got = {}
    for mode, late in itertools.product(modes, (False, True)):
        monkeypatch.setattr(pemax, "_CHAIN_WMODE_SCORE",
                            {m: 1.0 if m == mode else 0.0 for m in modes})
        monkeypatch.setattr(pemax, "_CHAIN_LATE_SCORE", 2.0 if late else 0.0)
        plan = pemax._chain_plan(C, S, list(widths), M)
        if plan["wmode"] != mode or plan["late"] != late:
            # resident weights that do not fit (sa3 / garment_sa2 at S=64);
            # streaming that would need more than one item per thread; no
            # odd hidden layer to share X's memory below three layers
            assert (mode == pemax.RESIDENT and S == 64 or mode == pemax.STREAMED
                    or late and len(widths) < 3)
            continue
        got[mode, late] = pemax._chain_kernel(table, idx, centers, ws, bs, relus)
        torch.testing.assert_close(got[mode, late], want, **CHAIN_TOL)
    assert len(got) >= 2
    first = next(iter(got.values()))
    for g in got.values():
        torch.testing.assert_close(g, first, rtol=0, atol=0)


@pytest.mark.parametrize("C,widths,S,M", [(6, (32, 32), 32, 6001), (35, (32, 32), 16, 3001),
                                          (195, (128, 128, 256), 64, 301)])
def test_fused_chain_persistent_groups(dev, C, widths, S, M):
    """More groups than resident blocks (each block walks several, the
    next group's rows landing while the layers run) and a partial last
    group, resident and streamed weights."""
    table, idx, centers, ws, bs = _chain_inputs(6, 2, 400, M, S, C, widths)
    relus = (True,) * (len(widths) - 1) + (False,)
    plan = pemax._chain_plan(C, S, list(widths), M)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 2 * -(-M // plan["G"]) > plan["per_sm"] * sms
    assert plan["G"] == 1 or M % plan["G"]
    got = pemax._chain_kernel(table, idx, centers, ws, bs, relus)
    torch.testing.assert_close(got, pemax._chain_reference(table, idx, centers, ws, bs, relus),
                               **CHAIN_TOL)


@pytest.mark.parametrize("C,widths,relus", [(6, (32, 32), (True, False)),
                                            (99, (256, 256), (True, True))])
def test_fused_chain_out_of_range_gives_nan(dev, C, widths, relus):
    """An index past the table makes its center's outputs NaN (a NaN row,
    carried through ReLU and max as torch carries it); the other centers
    keep the plain version's values."""
    table, idx, centers, ws, bs = _chain_inputs(7, 2, 300, 40, 16, C, widths)
    want = pemax._chain_reference(table, idx, centers, ws, bs, relus)
    idx[1, 5, 3] = 300
    got = pemax._chain_kernel(table, idx, centers, ws, bs, relus)
    assert torch.isnan(got[1, 5]).all()
    keep = torch.ones(2, 40, dtype=torch.bool, device=dev)
    keep[1, 5] = False
    torch.testing.assert_close(got[keep], want[keep], **CHAIN_TOL)


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
    """The kernel wrappers themselves stay forward-only (one whose input
    requires grad under autograd raises), and training on the card goes
    through autograd Functions instead: an SA stage in train mode (the
    gathers' backward is the scatter-add kernel) and in eval mode (the
    chain kernel's backward recomputes the unfused chain) gives the
    features and the weights the gradients of the plain versions, within
    rtol 1e-4 / atol 1e-5 (the atomics of the plain scatter add in another
    order)."""
    torch.manual_seed(0)
    sa = SAModuleMSG(64, (0.2, 0.4), (8, 16), ((16, 32), (32, 32)), 6).to(dev)
    xyz = cloud(8, 2, 300)
    feats = torch.randn(2, 300, 6, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="gather_rows: the CUDA kernel is forward-only"):
        pc._gather_rows_kernel(feats, torch.zeros(2, 4, dtype=torch.int32, device=dev))
    for train, kernel in ((True, "scatter_add"), (False, "fused_chain")):
        grads = []
        for plain in (False, True):
            feats.grad = None
            sa.zero_grad()
            ops.reset_counts()
            with ops.plain_ops() if plain else contextlib.nullcontext():
                sa.train(train)(xyz, feats)[1].square().sum().backward()
            assert (ops.launch_counts[kernel] > 0) != plain, dict(ops.launch_counts)
            grads.append([feats.grad.clone()] + [p.grad.clone() for p in sa.parameters()])
        for g, w in zip(*grads):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
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
                                       (2000, (0, 1, 15, 16, 1984, 1985, 1999)),
                                       # a signed span of 101 rows: no window
                                       (2000, (0, 1, 100, 1999)),
                                       (300, (0, 1, 150, 299))])
@pytest.mark.parametrize("attn", [False, True])
def test_gcn_stack(dev, V, offsets, attn):
    """7 or 8 pieces (a 3-wide one first), the 128-wide tile layers and the
    narrow 128 -> 3 layer, `hidden` from layer 2; V below one 128-vertex
    tile or not a multiple of it; the staged window of rows and the rows
    from L2 (wide offsets); two launches bitwise equal. Held to the float64
    stack (`chip_smoke.gcn_float64`): with outputs up to ~90 an output that
    cancels to ~0.06 sits within a few fp32 roundings of the tolerance, so
    the fp32 plain version's own error (up to 2.3e-5 here) would decide the
    verdict element by element; the shapes are checked against it too."""
    from chip_smoke import gcn_float64

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
    assert ko.shape == po.shape == (3, V, 3) and kh.shape == ph.shape == (3, V, 128)
    ro, rh = gcn_float64(xs, ws, bs, vals, offsets, relus, 2)
    torch.testing.assert_close(ko.double(), ro, **CHAIN_TOL)
    torch.testing.assert_close(kh.double(), rh, **CHAIN_TOL)
    for a, b in zip((ko, kh), graph._gcn_stack_kernel(xs, ws, bs, vals, offsets, relus, 2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("V,offsets", [(130, (0, 1, 129)), (300, (0, 1, 100, 299))])
@pytest.mark.parametrize("dims", [(3, 4), (3, 3), (3, 12, 200, 3)])
def test_gcn_stack_one_piece(dev, V, offsets, dims):
    """One 3-wide piece; a stack of one narrow layer (F = 4 and 3, with
    ReLU), and widths off the 128-column tile (12, and 200 in two column
    blocks); with and without the window."""
    g = torch.Generator().manual_seed(16)
    xs = [torch.randn(2, V, 3, generator=g).to(dev)]
    ws = [(torch.randn(a, b, generator=g) / a ** 0.5).to(dev) for a, b in zip(dims, dims[1:])]
    bs = [(0.1 * torch.randn(b, generator=g)).to(dev) for b in dims[1:]]
    vals = torch.rand(len(offsets), V, generator=g).to(dev)
    adj = torch.zeros(V, V)
    rows = torch.arange(V)
    for d, o in enumerate(offsets):
        adj[rows, (rows + o) % V] = vals[d].cpu()
    relus = (True,) * len(ws)
    ko, kh = graph._gcn_stack_kernel(xs, ws, bs, vals, offsets, relus, 0)
    po, ph = graph._gcn_stack_ref(xs, ws, bs, adj.to(dev), offsets, relus, 0)
    torch.testing.assert_close(ko, po, **CHAIN_TOL)
    torch.testing.assert_close(kh, ph, **CHAIN_TOL)


def test_posed_wrappers_refuse_autograd(dev):
    """The K-NN transfer stays forward-only; a PE table that requires grad
    (table_grad=True) now differentiates on the card through the dtable
    half of the PE backward, to the plain version's gradient (rtol 1e-4 /
    atol 1e-5); a frozen-table PE block and the GCN stack differentiate."""
    x = torch.randn(1, 16, 3, device=dev, requires_grad=True)
    w = torch.randn(3, 8, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="knn_transfer: the CUDA kernel is forward-only"):
        skinning.knn_transfer(x, x.detach(), torch.zeros(1, 16, 4, device=dev), 2, 2)
    pe_args = (torch.randint(0, 16, (1, 2, 8), dtype=torch.int32, device=dev),
               x[:, :2].detach(), w, torch.zeros(8, device=dev),
               torch.randn(8, 8, device=dev), torch.zeros(8, device=dev))
    grads = []
    for plain in (False, True):
        x.grad = w.grad = None
        ops.reset_counts()
        with ops.plain_ops() if plain else contextlib.nullcontext():
            ops.group_pe_max(x, *pe_args).sum().backward()
        assert ((ops.launch_counts["pe_bwd"] == 1 and ops.launch_counts["scatter_add"] == 1)
                != plain), dict(ops.launch_counts)
        grads.append((x.grad.clone(), w.grad.clone()))
    for g, want in zip(*grads):
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-5)
    x.grad = w.grad = None
    ops.group_pe_max(x, *pe_args, table_grad=False).sum().backward()
    assert x.grad is None and w.grad is not None
    out, _ = ops.gcn_stack([x], [w], [torch.zeros(8, device=dev)],
                           torch.eye(16, device=dev), (0,), (True,), 0)
    out.sum().backward()
    assert x.grad is not None
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


# ---- posed train-step kernels ----------------------------------------------


@pytest.mark.parametrize("N", [1, 5, 2047, 2049, 6890])
@pytest.mark.parametrize("M", [1, 300])
def test_nn1(dev, N, M):
    """Ties (every point duplicated, queries on points), one query, N
    around the 2048-point tile: d^2 and idx bitwise the plain version's."""
    base = cloud(17, 2, (N + 1) // 2)
    points = torch.cat([base, base], 1)[:, :N].contiguous()
    query = cloud(18, 2, M)
    query[:, : min(M, N)] = points[:, : min(M, N)]
    dk, ik = pc._nn1_kernel(query, points)
    dp, ip = pc._nn1_plain(query, points)
    torch.testing.assert_close(ik, ip, rtol=0, atol=0)
    torch.testing.assert_close(dk, dp, rtol=0, atol=0)


def test_knn_points_gradient(dev):
    q = cloud(19, 2, 500).requires_grad_(True)
    p = cloud(20, 2, 3000)
    g = torch.randn(2, 500, 1, device=dev)
    d, _ = ops.knn_points(q, p, K=1)
    (dq,) = torch.autograd.grad((d * g).sum(), q)
    with ops.plain_ops():
        d2, _ = ops.knn_points(q, p, K=1)
        (dq2,) = torch.autograd.grad((d2 * g).sum(), q)
    torch.testing.assert_close(dq, dq2, rtol=0, atol=0)


@pytest.mark.parametrize("V,D", [(5, 1), (7, 3), (48, 7), (200, 64), (2000, 7)])
@pytest.mark.parametrize("C", [3, 128, 5])
def test_banded(dev, V, D, C):
    """Random offsets (0 and wrapping ones) and random diagonal values:
    the product and its transposed band bitwise the plain roll loop."""
    g = torch.Generator().manual_seed(21)
    offsets = tuple(sorted(torch.randperm(V, generator=g)[:D].tolist()))
    vals = torch.rand(D, V, generator=g).to(dev)
    x = torch.randn(4, V, C, generator=g).to(dev)
    torch.testing.assert_close(graph._banded_kernel(vals, x, offsets),
                               graph._banded_plain(vals, x, offsets), rtol=0, atol=0)
    vt, ot = graph.transposed_band(vals, offsets)
    torch.testing.assert_close(graph._banded_kernel(vt.contiguous(), x, ot),
                               graph._banded_plain(vt, x, ot), rtol=0, atol=0)


PE_TOL = dict(rtol=1e-4, atol=1e-5)


def _pe_inputs(seed, B, N, M, S, C, F=32, G=32):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(B, N, C, generator=g)
    idx = torch.randint(0, N, (B, M, S), generator=g, dtype=torch.int32)
    idx[:, :, S // 2:] = idx[:, :, :1]  # replicated slots: exact ties
    centers = torch.randn(B, M, 3, generator=g)
    k0 = 0.3 * torch.randn(C, F, generator=g)
    b0 = 0.1 * torch.randn(F, generator=g)
    k1 = 0.3 * torch.randn(F, G, generator=g)
    cot = torch.randn(B, M, G, generator=g)
    return [t.to("cuda") for t in (table, idx, centers, k0, b0, k1, cot)]


@pytest.mark.parametrize("C,S,M", [(6, 32, 2000), (6, 4, 37), (67, 32, 300),
                                   (387, 8, 2000), (99, 16, 1), (99, 16, 2000),
                                   (3, 12, 50), (6, 40, 300)])
def test_pe_bwd(dev, C, S, M):
    """S=4 and 12 (padded with slot 0), S=40 (two words of slot masks), C up
    to 387, one center, ragged
    tiles: dcenters within rtol 1e-4 / atol 1e-5 and the weight gradients
    within 1e-4 of their largest magnitude (sums of up to ~1e5 terms in
    another order), both of the plain version and of the plain version in
    float64, and two launches bitwise equal (fixed block count, partials
    summed in block order). The cotangent is zero at the (center, channel)
    pairs whose max another summation order may put on another slot
    (`chip_smoke.pe_near_ties`, at most 2% of them); the float64 version
    takes the plain version's routing and ReLU masks (`chip_smoke.pe_routing`)."""
    from chip_smoke import pe_bwd_float64, pe_near_ties, pe_routing

    args = _pe_inputs(22, 2, 700, M, S, C)
    near = pe_near_ties(*args[:6])
    assert near.float().mean() <= 0.02
    args[-1] = args[-1] * ~near
    got = pemax._pe_bwd_kernel(*args)
    again = pemax._pe_bwd_kernel(*args)
    want = pemax._pe_bwd_plain(*args)
    exact = pe_bwd_float64(*args, pe_routing(*args[:6]))
    for ref in (want, exact):
        ref = [r.float() for r in ref]
        torch.testing.assert_close(got[0], ref[0], **PE_TOL)
        for g, w in zip(got[1:], ref[1:]):
            assert g.shape == w.shape
            assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    for g, a in zip(got, again):
        torch.testing.assert_close(g, a, rtol=0, atol=0)


def test_train_wrappers_count_launches(dev):
    """One launch per call: pe_bwd for a PE block's backward, banded for
    each product (forward and transposed), nn1 for a 1-NN query."""
    args = _pe_inputs(23, 1, 300, 40, 8, 6)
    table, idx, centers, k0, b0, k1, cot = args
    k0.requires_grad_(True)
    ops.reset_counts()
    out = ops.group_pe_max(table, idx, centers, k0, b0, k1, torch.zeros(32, device=dev),
                           table_grad=False)
    (out * cot).sum().backward()
    x = torch.randn(2, 48, 3, device=dev, requires_grad=True)
    ops.graph_matmul_banded(torch.eye(48, device=dev).roll(1, 1), x, (1,)).sum().backward()
    ops.knn_points(x, torch.randn(2, 100, 3, device=dev), K=1)
    assert dict(ops.launch_counts) == {"group_pe_max": 1, "pe_bwd": 1, "banded": 2,
                                       "nn1": 1}


def test_plain_ops_reaches_the_backward(dev):
    """Inside `plain_ops()` the PE block, the banded product and the GCN
    stack launch no kernel, in the forward or in the backward that autograd
    runs on its CUDA worker thread."""
    table, idx, centers, k0, b0, k1, cot = _pe_inputs(24, 1, 300, 40, 8, 6)
    k0.requires_grad_(True)
    x = torch.randn(2, 48, 3, device=dev, requires_grad=True)
    w = torch.randn(3, 8, device=dev, requires_grad=True)
    adj = torch.eye(48, device=dev) + torch.eye(48, device=dev).roll(1, 1)
    ops.reset_counts()
    with ops.plain_ops():
        out = ops.group_pe_max(table, idx, centers, k0, b0, k1, torch.zeros(32, device=dev),
                               table_grad=False)
        y = ops.graph_matmul_banded(adj, x, (0, 1))
        h, _ = ops.gcn_stack([x], [w], [torch.zeros(8, device=dev)], adj, (0, 1), (True,), 0)
    ((out * cot).sum() + (y * y).sum() + h.sum()).backward()
    assert dict(ops.launch_counts) == {}
    assert k0.grad is not None and x.grad is not None and w.grad is not None


def test_train_step_cuda_matches_cpu(dev):
    """One posed train step on the card and on the CPU from the same
    weights: every loss term within rtol 1e-4, every parameter gradient
    within 1e-3 relative L2 (fp32 rounding may move a radius-boundary
    membership)."""
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.models import GarmentAssets
    from garment4d_tpu_torch.smpl import synthetic_smpl
    from garment4d_tpu_torch.train import make_posed_steps, make_state_for

    torch.manual_seed(0)
    assets = GarmentAssets.synthetic(num_rings=12, ring_size=16)
    body = synthetic_smpl(1100, device="cpu")
    batch = make_batch(assets, body, batch_size=2, T=3, npoints=2048, device="cpu")
    weights = GarmentReconstructor.from_assets(assets, body, "cpu").model.state_dict()
    runs = []
    for device in ("cpu", dev):
        recon = GarmentReconstructor.from_assets(assets, body, device, lbs_k=64,
                                                 state_dict=weights)
        state = make_state_for(recon.model, lr=1e-3, freeze_canonical=True)
        train_step, _ = make_posed_steps(recon.model, assets, body.faces)
        ops.reset_counts()
        losses = train_step(state, {k: v.to(device) for k, v in batch.items()})
        grads = {k: p.grad.cpu() for k, p in recon.model.named_parameters()
                 if p.requires_grad}
        runs.append((losses, grads, dict(ops.launch_counts)))
    (lc, gc, _), (lg, gg, counts) = runs
    assert all(counts.get(k, 0) > 0 for k in ("pe_bwd", "banded", "nn1", "gcn_stack"))
    for k, v in lc.items():
        torch.testing.assert_close(lg[k].cpu(), v, rtol=1e-4, atol=1e-6)
    for k, v in gc.items():
        assert float((gg[k] - v).norm() / v.norm().clamp_min(1e-12)) <= 1e-3, k


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


@pytest.mark.parametrize("B,R,C,n,case", [
    (3, 4000, 3, 50, "one index"), (2, 1001, 67, 1722, "ragged"), (2, 5000, 99, 1024, ""),
    (2, 3000, 128, 1024, ""), (1, 2048, 195, 256, ""), (2, 768, 384, 64, ""),
    (2, 700, 16, 1, "n=1"), (2, 900, 33, 40, "out of range"),
    (2, 5000, 67, 1722, "skew"), (2, 3000, 16, 5000, "counts in scratch"),
    (3, 0, 67, 100, "R=0"), (2, 600, 1024, 50, ""), (2, 4000, 1, 300, ""),
    (2, 2000, 387, 500, ""), (2, 64000, 67, 2000, "")])
def test_scatter_add(dev, B, R, C, n, case):
    """Every row to one index, one row taking 90% of R, R not a multiple of
    the 32-row scan or of a sort warp's range, R = 0, C from 1 to 1024 (4-
    and 1-float loads, one and several channel chunks), a single output
    row, n too large for the sort's counts in shared memory, and indices
    outside [0, n) (dropped): bitwise the ascending-order sum on the CPU,
    two launches bitwise equal, and `index_add_` on the card (atomics, in
    another order) within 1e-6 of the magnitude each element sums (a row
    here collects up to 4500 terms)."""
    g = torch.Generator().manual_seed(R + C)
    grads = torch.randn(B, R, C, generator=g)
    idx = torch.randint(0, n, (B, R), generator=g, dtype=torch.int32)
    if case == "one index":
        idx[:] = n // 2
    if case == "skew":
        idx[:, torch.randperm(R, generator=g)[:R * 9 // 10]] = 7
    if case == "out of range":
        idx[:, ::3] = torch.randint(-50, 0, (B, (R + 2) // 3), generator=g, dtype=torch.int32)
        idx[:, 1::7] += n
    want = pc._scatter_add_rows_plain(grads, idx, n)
    got = pc._scatter_add_rows_kernel(grads.to(dev), idx.to(dev), n)
    again = pc._scatter_add_rows_kernel(grads.to(dev), idx.to(dev), n)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    on_card = pc._scatter_add_rows_plain(grads.to(dev), idx.to(dev), n)
    magnitude = pc._scatter_add_rows_plain(grads.abs(), idx, n)
    assert ((got.cpu() - on_card.cpu()).abs() <= 1e-6 * magnitude).all()


@pytest.mark.parametrize("C,S,M", [(67, 32, 300), (6, 12, 50), (99, 16, 2000)])
def test_pe_bwd_dtable(dev, C, S, M):
    """The dtable half (table_grad=True; S=12 padded with slot 0): all six
    gradients against the plain version with the near-tie cotangent mask,
    dtable and the weight gradients within 1e-4 of their largest magnitude,
    dcenters within rtol 1e-4 / atol 1e-5; two launches bitwise equal; the
    first five outputs bitwise those of the launch without the dtable
    half."""
    from chip_smoke import pe_near_ties

    args = _pe_inputs(25, 2, 700, M, S, C)
    args[-1] = args[-1] * ~pe_near_ties(*args[:6])
    got = pemax._pe_bwd_kernel(*args, table_grad=True)
    again = pemax._pe_bwd_kernel(*args, table_grad=True)
    want = pemax._pe_bwd_plain(*args, table_grad=True)
    assert len(got) == 6 and got[0].shape == args[0].shape
    torch.testing.assert_close(got[1], want[1], **PE_TOL)
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    for g, a in zip(got, again):
        torch.testing.assert_close(g, a, rtol=0, atol=0)
    for g, a in zip(got[1:], pemax._pe_bwd_kernel(*args)):
        torch.testing.assert_close(g, a, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["all tied", "one winner", "S=1", "zero cotangent"])
@pytest.mark.parametrize("C", [6, 67])
def test_pe_bwd_edge_cases(dev, case, C):
    """Every slot of a center gathering one row (each channel split S ways),
    one slot winning every channel (non-negative rows and weights, the
    slot's row the largest), one slot per center (padded to 8 copies), and
    a zero cotangent (no slot routes anything; every gradient but db1
    zero): both halves against the plain version with the near-tie mask,
    dcenters within rtol 1e-4 / atol 1e-5, the other gradients within 1e-4
    of their largest magnitude (0 for a zero gradient), and against the
    float64 version given the plain routing; two launches bitwise equal."""
    from chip_smoke import pe_bwd_float64, pe_near_ties, pe_routing

    S = 1 if case == "S=1" else 16
    args = _pe_inputs(27, 2, 600, 300, S, C)
    table, idx, centers, k0, b0, k1, cot = args
    if case == "all tied":
        idx[:] = idx[:, :, :1]
    if case == "one winner":
        table.abs_()
        table[:, :100] += 10.0
        centers.zero_()
        k0.abs_(), b0.abs_(), k1.abs_()
        idx[:, :, 0] %= 100
        idx[:, :, 1:] = 100 + idx[:, :, 1:] % 500
    if case == "zero cotangent":
        cot.zero_()
    args[-1] = cot * ~pe_near_ties(*args[:6])
    want = pemax._pe_bwd_plain(*args, table_grad=True)
    exact = pe_bwd_float64(*args, pe_routing(*args[:6]), table_grad=True)
    got = pemax._pe_bwd_kernel(*args, table_grad=True)
    again = pemax._pe_bwd_kernel(*args, table_grad=True)
    for ref in (want, exact):
        ref = [r.float() for r in ref]
        torch.testing.assert_close(got[1], ref[1], **PE_TOL)
        for g, w in zip(got[:1] + got[2:], ref[:1] + ref[2:]):
            assert g.shape == w.shape
            assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    for g, a in zip(got, again):
        torch.testing.assert_close(g, a, rtol=0, atol=0)
    for g, a in zip(got[1:], pemax._pe_bwd_kernel(*args)):
        torch.testing.assert_close(g, a, rtol=0, atol=0)
    if case == "zero cotangent":
        assert all(not g.any() for g in got[:5])


def test_group_pe_max_nv_flag(dev):
    """The valid-count PE call: bitwise the chain kernel without the count
    while every index stays below max(n_valid[b], 1) (a frame with a count
    of 0 gathers row 0); an index at or past it raises; counted under
    `group_pe_max_nv`."""
    table, idx, centers, k0, b0, k1, _ = _pe_inputs(26, 2, 500, 300, 16, 6)
    b1 = torch.zeros(32, device=dev)
    n_valid = torch.tensor([300, 0], dtype=torch.int32, device=dev)
    idx[0] %= 300
    idx[1] = 0
    ops.reset_counts()
    with torch.no_grad():
        got = ops.group_pe_max(table, idx, centers, k0, b0, k1, b1, table_grad=False,
                               n_valid=n_valid)
        want = ops.group_pe_max(table, idx, centers, k0, b0, k1, b1, table_grad=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert dict(ops.launch_counts) == {"group_pe_max_nv": 1, "group_pe_max": 1}
    idx[0, 7, 3] = 300
    with pytest.raises(ValueError, match="past max"):
        ops.group_pe_max(table, idx, centers, k0, b0, k1, b1, table_grad=False, n_valid=n_valid)
    idx[0, 7, 3] = 0
    idx[1, 0, 0] = 1
    with pytest.raises(ValueError, match="past max"):
        ops.group_pe_max(table, idx, centers, k0, b0, k1, b1, table_grad=False, n_valid=n_valid)
