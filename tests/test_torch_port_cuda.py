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
narrow last layer and widths off the column tile, 1-NN ties, one to
nine points, sets around the scan threshold and the staging limit, the
body's size at 1 and 40 frames, 20000 points, no query, lattices of exact
ties, NaN points and queries, banded products with 1 to 64 diagonals at
C = 3, 5 and 128 and their transposes, PE backwards with padded S (1, 4,
12), every slot tied, one slot winning every channel, a zero cotangent and
tables up to 387 wide, with and without their dtable half, scatter-adds
with every row or 90% of them into one index, ragged R, R = 0, C from 1 to
1024, one output row, more output rows than the sort's counts in shared
memory hold, and out-of-range indices, the valid-count PE call's flag;
K-NN transfers with distances on both sides of every radix digit's bin
edge, all equal, k = N, k64 = k or 1, N < 32, bodies past the staged
size (20000 points, and N + 2k at its limit), J = 1 and 32, and the
kernel's own selections read back against the plain version's; grouped
queries with every row in radius, no hit, rows at r, hits and sentinels
past n_valid, fewer valid rows than S, 1 to 2000 centers, and a table
longer than a block stages; flat queries with points at r -+ 1, 2 ulp on a
tile box's face, every point in one Morton cell, N < 32, a ragged last
tile, a frame past the staged size, S above the hits and S = N, NaN
points, 1 and 2000 centers, index order scrambled against space, 1 to 3
radii, every instance the plan picks and bitmaps smaller than the frame;
3-NN with three known points, all equal, a lattice of exact ties whose
lower indices sit in later tiles, queries on (duplicated) known points,
one query, fp1's shape at 2 and 200 frames, known points past the staged
size and NaN known points and queries; FPS with more centers than points
in every instance (all points equal, each point twice, zero-padded garment
frames) and on frames past shared memory (the wide kernel, its running
distances in device memory); the C entries refusing plans that
do not match them.
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


@pytest.mark.parametrize("N,npoint", [(1, 1), (5, 5), (1000, 3), (2049, 512), (6890, 64),
                                      (512, 1024), (128, 512), (384, 512), (5, 12),
                                      (20000, 1024), (65536, 1024)])
def test_fps(dev, N, npoint):
    """Bitwise the plain version, also at the JAX package's shapes: more
    centers than points (SA1 at 512 points, the garment encoder's 512 from
    128 and 384) and sets past shared memory (the wide kernel, its running
    distances in device memory)."""
    xyz = cloud(0, 3, N, dup=N // 4)
    got = pc._fps_kernel(xyz, npoint)
    torch.testing.assert_close(got, pc._fps_plain(xyz, npoint), rtol=0, atol=0)


@pytest.mark.parametrize("B,N,npoint,ppt,staged,far", [
    (2, 20, 20, 1, False, False), (2, 50, 7, 2, False, False), (2, 100, 33, 4, False, False),
    (2, 256, 64, 8, False, False), (2, 1024, 256, 4, False, False),
    (2, 1722, 512, 4, False, False), (2, 4096, 300, 4, False, False),
    (2, 4097, 300, 8, False, True), (2, 8192, 100, 8, False, True),
    (2, 9000, 64, 16, True, False), (2, 14528, 16, 16, True, False),
    (200, 6890, 64, 8, False, True), (2, 14529, 64, 15, False, False),
    (2, 300000, 8, 293, False, False)])
def test_fps_plans(dev, B, N, npoint, ppt, staged, far):
    """Every instance the plan picks (one warp, several, 32 warps, the kernel
    that skips far warps from 4097 to 8192 points, the staged kernel up to
    16 N bytes of shared memory, more frames than SMs, then the wide kernel
    with its running distances in device memory), bitwise the plain version
    on clouds with duplicates."""
    plan = pc._fps_plan(B, N, npoint)
    assert (plan["ppt"], plan["staged"], plan["far"]) == (ppt, staged, far)
    assert plan["wide"] == (N > 14528) and (plan["smem"] == 0) == plan["wide"]
    xyz = cloud(22, B, N, dup=N // 3)
    torch.testing.assert_close(pc._fps_kernel(xyz, npoint), pc._fps_plain(xyz, npoint),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["padded", "far_padded", "all_equal", "far_equal", "one",
                                  "grid", "far_grid", "nan", "far_nan", "equal_past_n",
                                  "pairs_past_n", "far_pairs_past_n", "far_equal_past_n",
                                  "staged_pairs_past_n", "wide_pairs_past_n", "wide_equal",
                                  "wide_nan", "padded_past_n"])
def test_fps_ties(dev, case):
    """Ties everywhere, to the lowest index: garment frames zero-padded by a
    quarter (as `select_garment_points` pads them), every point the same,
    one point, a lattice of equal distances, and a NaN point (a NaN running
    distance wins, as torch.argmax has it), at sizes of both register
    kernels (`far`: past 4096 points); then more centers than points, where
    every running distance reaches 0 and each further step takes index 0
    (all points equal, each point twice, the zero-padded garment frame),
    in every instance (the far kernel's skipped warps keep keys of bits 0),
    and the wide kernel's ties; against the plain version on the CPU."""
    if case.endswith("pairs_past_n"):
        n = {"pairs": 400, "far_pairs": 6000, "staged_pairs": 9000,
             "wide_pairs": 16000}[case[:-len("_past_n")]]
        xyz = cloud(27, 2, n)
        xyz[:, n // 2:] = xyz[:, :n // 2]
        npoint = 512 if n == 400 else n + 50
    elif case == "equal_past_n":
        xyz, npoint = torch.full((2, 300, 3), 0.5, device=dev), 1024
    elif case == "far_equal_past_n":
        xyz, npoint = torch.full((2, 5000, 3), 0.5, device=dev), 5100
    elif case == "wide_equal":
        xyz, npoint = torch.full((2, 60000, 3), 0.5, device=dev), 70
    elif case == "wide_nan":
        xyz = cloud(28, 2, 20000)
        xyz[1, 12345, 0] = float("nan")
        npoint = 50
    elif case == "padded_past_n":
        xyz = cloud(29, 80, 128)
        xyz[:, -32:] = 0
        npoint = 512
    elif case in ("padded", "far_padded"):
        n = 1722 if case == "padded" else 6890
        xyz = cloud(23, 4, n)
        xyz[:, -n // 4:] = 0
        npoint = 512
    elif case == "far_equal":
        xyz, npoint = torch.full((2, 5000, 3), 0.5, device=dev), 300
    elif case == "far_grid":
        ax = torch.arange(17, dtype=torch.float32, device=dev)
        xyz = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(1, 4913, 3)
        npoint = 700
    elif case == "far_nan":
        xyz = cloud(26, 2, 6000)
        xyz[1, 4321, 2] = float("nan")
        npoint = 60
    elif case == "all_equal":
        xyz, npoint = torch.full((3, 300, 3), 0.5, device=dev), 300
    elif case == "one":
        xyz, npoint = cloud(24, 5, 1), 1
    elif case == "grid":
        ax = torch.arange(10, dtype=torch.float32, device=dev)
        xyz = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(1, 1000, 3)
        npoint = 1000
    else:
        xyz = cloud(25, 2, 600)
        xyz[0, 300, 1] = float("nan")
        npoint = 40
    torch.testing.assert_close(pc._fps_kernel(xyz.contiguous(), npoint).cpu(),
                               pc._fps_plain(xyz.cpu(), npoint), rtol=0, atol=0)


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


def bits(t):
    """A float tensor's bit patterns (NaN rows compare equal)."""
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 67, 99, 128, 130, 195, 384])
def test_gather_rows(dev, C, offset):
    """Each width the models gather (3, 6 x 2, 67, 99, 128, 195, 256 x 1.5,
    384) and its neighbours, the table aligned and misaligned (storage
    offset 4 bytes: the float path for every width), R odd so that the
    output is no whole number of float4s for odd C: bitwise the plain
    version, indices from [-N-3, N+3) with -N, -1, N and N+1 among them (an
    index in [-N, 0) reads row idx + N, the others outside [0, N) NaN rows,
    0x7fc00000)."""
    g = torch.Generator().manual_seed(4)
    flat = torch.randn(offset + 3 * 50 * C, generator=g).to(dev)
    table = flat[offset:].view(3, 50, C)
    idx = torch.randint(0, 50, (3, 77), generator=g, dtype=torch.int32).to(dev)
    got = pc._gather_rows_kernel(table, idx)
    assert torch.equal(bits(got), bits(pc._gather_rows_plain(table, idx)))
    idx = torch.randint(-53, 53, (3, 77), generator=g, dtype=torch.int32)
    idx[:, :4] = torch.tensor([-50, -1, 50, 51], dtype=torch.int32)
    idx = idx.to(dev)
    got = pc._gather_rows_kernel(table, idx)
    want = pc._gather_rows_plain(table, idx)
    assert torch.equal(bits(got), bits(want))
    assert torch.equal(bits(want.cpu()), bits(pc._gather_rows_plain(table.cpu(), idx.cpu())))
    assert torch.equal(got[:, 0], table[:, 0]) and torch.equal(got[:, 1], table[:, 49])
    assert (bits(got[:, 2:4]) == 0x7fc00000).all()


@pytest.mark.parametrize("B,N,R,C", [(1, 7, 33, 3), (2, 9, 0, 5), (3, 1, 41, 67), (2, 0, 9, 4),
                                     (1, 6890, 4992, 6), (200, 1024, 2067, 128),
                                     (4, 1722, 16384, 67)])
def test_gather_rows_shapes(dev, B, N, R, C):
    """One frame, no rows (no launch), a one-row table (every index 0, -1
    or out of range), an empty table (every row NaN), a frame of many
    blocks, more frames than SMs, a float4 and a float width over many
    blocks a frame: bitwise the plain version."""
    g = torch.Generator().manual_seed(5)
    table = torch.randn(B, N, C, generator=g).to(dev)
    idx = torch.randint(-N - 2, N + 2, (B, R), generator=g, dtype=torch.int32).to(dev)
    ops.reset_counts()
    got = pc._gather_rows_kernel(table, idx)
    assert ops.launch_counts["gather_rows"] == int(R > 0)
    assert got.shape == (B, R, C)
    assert torch.equal(bits(got), bits(pc._gather_rows_plain(table, idx)))


@pytest.mark.parametrize("case", ["V=4 off width", "V=2", "U=2", "float4 U=8", "blocks",
                                  "magic", "shift", "frame magic", "frame shift",
                                  "misaligned", "rows"])
def test_gather_entry_refuses(dev, case):
    """The C entry refuses a plan that does not match the kernel: float4
    slots for a width off 4 or a misaligned table, another slot width, an
    unroll the kernel has no instance of (2, or 8 float4s), a wrong block
    count or divider (of the slots or the frames), a frame of 2^31 slots."""
    from garment4d_tpu_torch.ops import _build

    B, N, R, C = 2, 10, 600, 5
    flat = torch.randn(B * N * C + 4, device=dev)
    table, aligned = flat[:-4], False
    if case == "misaligned":
        C, table, aligned = 4, flat[1:1 + B * N * 4], True
    if case == "float4 U=8":
        C, table, aligned = 4, flat[:B * N * 4], True
    idx = torch.zeros((B, R), dtype=torch.int32, device=dev)
    out = torch.empty((B, R, C), device=dev)
    plan = dict(pc._gather_plan(R, C, aligned))
    if case == "rows":
        R = 2 ** 31 // plan["CV"]
        plan["blocks_per_frame"] = -(-R * plan["CV"] // plan["tile"])
    plan.update({"V=4 off width": dict(V=4, U=4), "V=2": dict(V=2), "U=2": dict(U=2),
                 "float4 U=8": dict(U=8),
                 "blocks": dict(blocks_per_frame=plan["blocks_per_frame"] + 1),
                 "magic": dict(magic=plan["magic"] + 1),
                 "shift": dict(shift=plan["shift"] + 1),
                 "frame magic": dict(frame_magic=plan["frame_magic"] + 1),
                 "frame shift": dict(frame_shift=plan["frame_shift"] + 1)}.get(case, {}))
    err = _build.library().g4d_gather_rows(
        table.data_ptr(), idx.data_ptr(), B, N, C, R, plan["V"], plan["U"],
        plan["blocks_per_frame"], plan["magic"], plan["shift"], plan["frame_magic"],
        plan["frame_shift"], out.data_ptr(), _build.stream_of(table))
    assert err != 0


def test_gather_scatter_wrap(dev):
    """The gather's backward through the scatter-add kernel's `wrap`: a
    wrapped index's cotangent into row idx + N, the others outside [0, N)
    dropped, bitwise the CPU's ascending-order sum; without `wrap` the
    scatter-add drops every negative index, as before."""
    g = torch.Generator().manual_seed(6)
    B, N, R, C = 3, 40, 900, 7
    grads = torch.randn(B, R, C, generator=g)
    idx = torch.randint(-N - 5, N + 5, (B, R), generator=g, dtype=torch.int32)
    for wrap in (False, True):
        got = pc._scatter_add_rows_kernel(grads.to(dev), idx.to(dev), N, wrap)
        assert torch.equal(got.cpu(), pc._scatter_add_rows_plain(grads, idx, N, wrap))
    table = torch.randn(B, N, C, device=dev, requires_grad=True)
    out = ops.gather_points(table, idx.to(dev))
    (dt,) = torch.autograd.grad((out.nan_to_num() * grads.to(dev)).sum(), table)
    wrapped = torch.where(idx < 0, idx + N, idx)
    assert torch.equal(dt.cpu(), pc._scatter_add_rows_plain(grads, wrapped, N))


def test_gather_bf16_table(dev):
    """A bf16 table (an FP stage's features under --bf16, fp2's shape: 3 x
    1024 rows from 256 of 128 channels) through `gather_points`: the gather
    kernel on its fp32 cast, the rows back in bf16, bitwise the plain
    version's rows and the table's own values; the backward rounds each
    row's cotangent to bf16 and the scatter-add kernel sums them in fp32
    before one cast to bf16, bitwise the CPU's ascending-order sum, and
    within one bf16 rounding of the card's plain path (its `index_add_`
    sums in another order). The kernel itself still refuses a bf16
    table."""
    g = torch.Generator().manual_seed(7)
    B, N, R, C = 4, 256, 3 * 1024, 128
    table = torch.randn(B, N, C, generator=g).bfloat16()
    idx = torch.randint(0, N, (B, R), generator=g, dtype=torch.int32)
    cot = torch.randn(B, R, C, generator=g)

    def run(device, plain):
        t = table.to(device).clone().requires_grad_(True)
        ops.reset_counts()
        with ops.plain_ops() if plain else contextlib.nullcontext():
            out = ops.gather_points(t, idx.to(device))
            (dt,) = torch.autograd.grad((out * cot.to(device)).sum(), t)
        torch.cuda.synchronize()
        return out.detach(), dt, dict(ops.launch_counts)

    out, dt, launches = run(dev, False)
    assert launches["gather_rows"] == 1 and launches["scatter_add"] == 1
    assert out.dtype == torch.bfloat16 and dt.dtype == torch.bfloat16
    out_plain, dt_plain, launches_plain = run(dev, True)
    assert not any(launches_plain.values())
    assert torch.equal(out, out_plain)
    rows = torch.gather(table, 1, idx.long()[..., None].expand(B, R, C))
    assert torch.equal(out.cpu(), rows)
    _, dt_cpu, _ = run("cpu", True)
    assert torch.equal(dt.cpu(), dt_cpu)
    torch.testing.assert_close(dt_plain.float(), dt.float(), rtol=2 ** -7, atol=1e-6)
    with pytest.raises(TypeError, match="bfloat16"):
        pc._gather_rows_kernel(table.to(dev), idx.to(dev))


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


def coverage_check(xyz, centers, radius):
    xyz, centers = xyz.contiguous(), centers.contiguous()
    got = pc._covered_mask_kernel(xyz, centers, radius)
    torch.testing.assert_close(got, pc._covered_mask_plain(xyz, centers, radius),
                               rtol=0, atol=0)
    return got


def coverage_case(dev, case):
    """(xyz, centers, radius) of one coverage edge case."""
    g = torch.Generator().manual_seed(17)
    xyz = torch.rand(3, 700, 3, generator=g)
    if case == "far":  # every tile culled: nothing within r
        return xyz, torch.rand(3, 300, 3, generator=g) + 5.0, 0.3
    if case == "one_point":  # every box of zero size, at and beside the points
        return xyz, xyz[:, 5:6].expand(3, 100, 3), 0.2
    if case == "ragged":  # M not a multiple of the 32-center tile
        return xyz, torch.rand(3, 37, 3, generator=g), 0.1
    if case == "chunks":  # more centers than one staged chunk, hits in the last
        centers = torch.rand(3, 9000, 3, generator=g) + 3.0
        centers[:, -5:] = xyz[:, :5]
        return xyz, centers, 0.05
    if case == "no_centers":
        return xyz, torch.zeros(3, 0, 3), 0.3
    if case == "nan":  # NaN points (their bound is NaN) and NaN centers (left out of boxes)
        centers = xyz[:, ::7].clone()
        xyz = xyz.clone()
        xyz[:, ::5, 1] = float("nan")
        centers[:, ::3, 2] = float("nan")
        return xyz, centers, 0.1
    if case == "face":  # boundary points around a center on its tile's box faces
        radius = 0.25
        c = torch.tensor([0.3, 0.2, 0.1])
        pts, _ = boundary_cloud(radius, tuple(c.tolist()))
        tile = c + torch.rand(32, 3, generator=g)  # c is the tile's lower corner
        tile[7] = c
        centers = torch.cat([tile, torch.rand(40, 3, generator=g) + 4.0], 0)
        mirror = torch.cat([2 * c - tile, torch.rand(40, 3, generator=g) + 4.0], 0)
        xyz = torch.cat([pts, torch.rand(100, 3, generator=g)], 0)
        return (torch.stack([xyz, xyz]), torch.stack([centers, mirror]), radius)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["far", "one_point", "ragged", "chunks", "no_centers", "face",
                                  "nan"])
def test_coverage_edges(dev, case):
    """The cull at its edges, bitwise the plain version: every tile culled,
    zero-size boxes, a ragged last tile, two staged chunks, no center,
    points at r and r -+ 1, 2 ulp from a center on the lower (and, mirrored,
    upper) faces of its tile's box, NaN points and centers."""
    xyz, centers, radius = coverage_case(dev, case)
    got = coverage_check(xyz.to(dev), centers.to(dev), radius)
    if case in ("far", "no_centers"):
        assert not got.any()


@pytest.mark.parametrize("B,threads", [(2, 512), (8, 512), (80, 512)])
def test_coverage_plans(dev, B, threads):
    """The plan's blocks (a point a thread, the block's points sorted along
    the curve) on grids smaller and larger than the card: 6890 points with
    boundary points against 2000 centers at r 0.4, over 2, 8 and 80
    frames."""
    assert pc._coverage_plan(B, 6890, 2000)["threads"] == threads
    pts, c = boundary_cloud(0.4)
    xyz = torch.cat([cloud(18, B, 6890 - pts.shape[0], device="cpu") * 2 - 0.5,
                     pts.expand(B, -1, -1)], 1)
    centers = torch.cat([c.expand(B, 1, 3), cloud(19, B, 1999, device="cpu") * 2 - 0.5], 1)
    coverage_check(xyz.to(dev), centers.to(dev), 0.4)


@pytest.mark.parametrize("field,value", [("tile", 16), ("dense", 33), ("smem", -16)])
def test_coverage_entry_refuses(dev, field, value):
    """The C entry refuses a plan that does not match the kernel: another
    tile than a warp's 32 centers, a `dense` past a warp, shared memory
    short of the chunk, its boxes, the points and the sort's counts."""
    from garment4d_tpu_torch.ops import _build

    xyz, centers = cloud(30, 2, 100), cloud(31, 2, 50)
    out = torch.empty((2, 100), dtype=torch.int32, device=dev)
    plan = dict(pc._coverage_plan(2, 100, 50))
    plan[field] = plan["smem"] + value if field == "smem" else value
    err = _build.library().g4d_coverage(
        xyz.data_ptr(), centers.data_ptr(), 2, 100, 50, 0.01, plan["threads"], plan["blocks"],
        plan["tile"], plan["chunk"], plan["dense"], plan["smem"], out.data_ptr(),
        _build.stream_of(xyz))
    assert err != 0


@pytest.mark.parametrize("N", [300, 6000, 20000])
def test_fps_entry_refuses_short_smem(dev, N):
    """The C entry refuses a plan whose shared memory cannot hold the
    frame's planes (in the far-skipping kernel, the sorted frame), and the
    wide kernel without its scratch array for the running distances."""
    from garment4d_tpu_torch.ops import _build

    xyz = cloud(32, 2, N)
    out = torch.empty((2, 8), dtype=torch.int32, device=dev)
    plan = pc._fps_plan(2, N, 8)
    err = _build.library().g4d_fps(xyz.data_ptr(), 2, N, 8, plan["threads"], plan["ppt"],
                                   int(plan["far"]), int(plan["wide"]), plan["smem"] - 4, None,
                                   out.data_ptr(), _build.stream_of(xyz))
    assert err != 0


@pytest.mark.parametrize("case", ["no_center", "empty_frame", "wide_small_frame"])
def test_fps_entry_refuses_bad_plans(dev, case):
    """The C entry refuses no center (its first index would be written past
    the output), an empty frame, and the wide kernel on fewer points than
    threads (each thread must own its first point)."""
    from garment4d_tpu_torch.ops import _build

    N, npoint, wide = {"no_center": (300, 0, 0), "empty_frame": (0, 4, 0),
                       "wide_small_frame": (1000, 4, 1)}[case]
    xyz = cloud(33, 2, max(N, 1))
    out = torch.empty((2, max(npoint, 1)), dtype=torch.int32, device=dev)
    scratch = torch.empty((2, max(N, 1)), dtype=torch.float32, device=dev)
    err = _build.library().g4d_fps(xyz.data_ptr(), 2, N, npoint, 1024, 1, 0, wide,
                                   4 * max(N, 1) * 4, scratch.data_ptr() if wide else None,
                                   out.data_ptr(), _build.stream_of(xyz))
    assert err != 0


# ---- the flat query and 3-NN (sorted tiles with exact box culls) ------------


def flat_check(dev, radii, ns, xyz, centers):
    """The flat query bitwise the plain version, on the card."""
    xyz, centers = xyz.contiguous().to(dev), centers.contiguous().to(dev)
    got = pc._ball_query_kernel(radii, ns, xyz, centers)
    for g, r, s in zip(got, radii, ns):
        torch.testing.assert_close(g, pc._ball_query_plain(r, s, xyz, centers), rtol=0, atol=0)
    return got


def face_frame(radius, filler=0):
    """A center c and, along +x, points at r -+ 1 and 2 ulp and at r from
    it, each the lowest x of its own 32-point tile in index order (the
    others further along +x at c's y and z), so that each tile's box bound
    from c is that point's distance; `filler` far points after them."""
    c = np.array([0.3, 0.2, 0.1], np.float32)
    r = np.float32(radius)
    lo1, hi1 = np.nextafter(r, np.float32(0)), np.nextafter(r, np.float32(1))
    pts = []
    for o in (np.nextafter(lo1, np.float32(0)), lo1, r, hi1, np.nextafter(hi1, np.float32(1))):
        tile = np.repeat(c[None], 32, 0)
        tile[:, 0] = np.float32(c[0] + o) + np.linspace(0, 0.05, 32, dtype=np.float32)
        pts.append(tile)
    pts.append(np.random.default_rng(5).random((filler, 3), dtype=np.float32) + 3.0)
    return torch.from_numpy(np.concatenate(pts))[None], torch.from_numpy(c)[None, None]


def flat_case(case):
    """(radii, nsamples, xyz, centers) of one flat-query edge case."""
    g = torch.Generator().manual_seed(21)
    r3, s3 = (0.05, 0.1, 0.3), (8, 16, 24)
    if case in ("face", "face sorted"):
        xyz, c = face_frame(0.25, 0 if case == "face" else 600)
        return (0.25,), (32,), xyz, c
    if case == "boundary":  # points at r -+ 1, 2 ulp along each axis, both signs
        pts, c = boundary_cloud(0.1)
        xyz = torch.cat([torch.rand(1, 700, 3, generator=g), pts[None]], 1)
        return (0.1, 0.2), (16, 32), xyz, torch.cat([c[None, None], xyz[:, :30]], 1)
    if case == "one cell":  # every point in one Morton cell but one far point
        xyz = torch.rand(2, 2000, 3, generator=g) * 0.01
        xyz[:, 1234] = 10.0
        return r3, (8, 16, 2000), xyz, xyz[:, :40].clone()
    if case == "N < 32":
        xyz = torch.rand(3, 7, 3, generator=g)
        return r3[:2], (4, 16), xyz, torch.rand(3, 9, 3, generator=g)
    if case == "ragged":  # 1000 = 31 tiles of 32 and one of 8
        xyz = torch.rand(2, 1000, 3, generator=g)
        return r3, s3, xyz, xyz[:, :100].clone()
    if case == "past staged":  # a frame too large to stage: read through L1
        xyz = torch.rand(2, 20000, 3, generator=g)
        return r3, s3, xyz, torch.rand(2, 50, 3, generator=g)
    if case == "S > hits":
        xyz = torch.rand(2, 900, 3, generator=g)
        return (0.05,), (64,), xyz, xyz[:, :80].clone()
    if case == "S = N":
        xyz = torch.rand(2, 600, 3, generator=g)
        return (0.3, 2.0), (600, 600), xyz, xyz[:, :20].clone()
    if case == "nan":  # NaN points (never hit, left out of boxes), 1 and 3 radii
        xyz = torch.rand(2, 800, 3, generator=g)
        xyz[:, ::7, 1] = float("nan")
        return r3, s3, xyz, torch.rand(2, 60, 3, generator=g)
    if case == "M = 1":
        xyz = torch.rand(2, 3000, 3, generator=g)
        return (0.2,), (32,), xyz, xyz[:, 5:6].clone()
    if case == "M = 2000":
        xyz = torch.rand(4, 1722, 3, generator=g)
        return (0.1,), (32,), xyz, torch.rand(4, 2000, 3, generator=g)
    if case == "scrambled":  # a lattice, its index order random against space
        lat = torch.stack(torch.meshgrid(*[torch.arange(14.0)] * 3, indexing="ij"), -1)
        lat = lat.reshape(-1, 3)[torch.randperm(14 ** 3, generator=g)] * 0.05
        return (0.05, 0.1), (16, 32), lat[None], lat[None, :300].clone()
    raise ValueError(case)


FLAT_CASES = ["face", "face sorted", "boundary", "one cell", "N < 32", "ragged", "past staged",
              "S > hits", "S = N", "nan", "M = 1", "M = 2000", "scrambled"]


@pytest.mark.parametrize("case", FLAT_CASES)
def test_flat_query_edges(dev, case):
    """The flat query at the edges of its cull and its bitmaps, bitwise the
    plain version: points at r and r -+ 1, 2 ulp on a tile box's face (index
    order, and sorted), around a center on every axis; every point in one
    Morton cell; N < 32, a ragged last tile, a frame past the staged size
    (read through L1); S above the hits, S = N; NaN points; 1 and 2000
    centers; index order scrambled against space; 1 to 3 radii."""
    radii, ns, xyz, centers = flat_case(case)
    got = flat_check(dev, radii, ns, xyz, centers)
    if case == "face":  # only a tile's first point lies near r, the rest beyond
        assert set(got[0][0, 0].tolist()) <= {0, 32, 64, 96, 128}


def test_flat_query_plans(dev):
    """Every instance the plan picks: a lane per center over a frame in
    index order (N <= 512), sorted and staged with 32 or fewer warps, read
    through L1, over frame counts below and above the card's blocks."""
    seen = set()
    for B, N, M, radii, ns in [(80, 256, 64, (0.2, 0.4), (32, 64)), (3, 6890, 1024, (0.05, 0.1),
                               (16, 32)), (200, 1024, 256, (0.1,), (16,)),
                               (2, 8000, 40, (0.1, 0.2, 0.4), (8, 16, 32)),
                               (1, 15000, 30, (0.1,), (8,))]:
        g = torch.Generator().manual_seed(B + N)
        xyz = torch.rand(B, N, 3, generator=g)
        plan = pc._flat_plan(B, N, M, len(radii), torch.cuda.get_device_properties(dev)
                             .multi_processor_count)
        seen.add((plan["sort"], plan["staged"], plan["warps"]))
        flat_check(dev, radii, ns, xyz, torch.rand(B, M, 3, generator=g))
    assert {(True, True, 32), (True, False, 32)} <= seen
    assert any(not s and st for s, st, w in seen)  # a lane per center, index order
    assert any(s and st and w < 32 for s, st, w in seen)


@pytest.mark.parametrize("words", [4, 8, 216])
def test_flat_query_windows(dev, words):
    """Bitmaps smaller than the frame's indices (windows of 32 x words,
    through the C entry): the same hits as one window."""
    from garment4d_tpu_torch.ops import _build

    xyz = cloud(40, 2, 6890)
    centers = xyz[:, :64].contiguous()
    radii, ns = (0.05, 0.1), (16, 32)
    plan = pc._flat_plan(2, 6890, 64, 2, 132)
    outs = [torch.full((2, 64, s), -1, dtype=torch.int32, device=dev) for s in ns]
    tiles = plan["tiles"]
    scratch = torch.empty((2, 32 * tiles + 2 * (tiles + plan["supers"]), 4), device=dev)
    warps = 8
    err = _build.library().g4d_ball_query(
        xyz.data_ptr(), centers.data_ptr(), 2, 6890, 64, 2, pc._r2(0.05), 16, outs[0].data_ptr(),
        pc._r2(0.1), 32, outs[1].data_ptr(), 0.0, 0, None, 1, 0, warps, words, 4,
        4 * warps * 2 * words, scratch.data_ptr(), scratch.data_ptr() + 16 * 2 * 32 * tiles,
        _build.stream_of(xyz))
    assert err == 0
    for o, r, s in zip(outs, radii, ns):
        torch.testing.assert_close(o, pc._ball_query_plain(r, s, xyz, centers), rtol=0, atol=0)


@pytest.mark.parametrize("field,value", [("R", 4), ("words", 6), ("smem", -4), ("unstaged", 0),
                                         ("warps", 33)])
def test_flat_entry_refuses(dev, field, value):
    """The C entry refuses a plan that does not match the kernel: more than
    three radii, bitmap rows not whole walk steps, shared memory short of
    the staged frame and bitmaps, an unstaged frame without the pre-pass,
    more warps than a block holds."""
    from garment4d_tpu_torch.ops import _build

    xyz = cloud(41, 2, 700)
    centers = xyz[:, :10].contiguous()
    plan = dict(pc._flat_plan(2, 700, 10, 1, 132), R=1)
    if field == "unstaged":
        plan.update(staged=False, sort=False)
    elif field == "smem":
        plan["smem"] += value
    else:
        plan[field] = value
    out = torch.empty((2, 10, 8), dtype=torch.int32, device=dev)
    scratch = torch.empty((2, 32 * plan["tiles"] + 2 * (plan["tiles"] + plan["supers"]), 4),
                          device=dev)
    err = _build.library().g4d_ball_query(
        xyz.data_ptr(), centers.data_ptr(), 2, 700, 10, plan["R"], 0.01, 8, out.data_ptr(),
        0.01, 8, out.data_ptr(), 0.01, 8, out.data_ptr(), int(plan["sort"]), int(plan["staged"]),
        plan["warps"], plan["words"], plan["blocks"], plan["smem"], scratch.data_ptr(),
        scratch.data_ptr() + 16 * 2 * 32 * plan["tiles"], _build.stream_of(xyz))
    assert err != 0


def three_nn_check(unknown, known):
    """The 3-NN kernel bitwise the plain version, indices and squared
    distances, on the card."""
    dk, ik = pc._three_nn_kernel(unknown.contiguous(), known.contiguous())
    dp, ip = pc._three_nn_plain(unknown, known)
    torch.testing.assert_close(ik, ip, rtol=0, atol=0)
    torch.testing.assert_close(dk, dp, rtol=0, atol=0)
    return dk, ik


def lattice(n, seed):
    """An n^3 lattice of unit spacing whose index order is random against
    space (so a lower index often sits in a later tile), and queries on
    half-integer points: many exact ties at every rank."""
    g = torch.Generator().manual_seed(seed)
    lat = torch.stack(torch.meshgrid(*[torch.arange(float(n))] * 3, indexing="ij"), -1)
    lat = lat.reshape(1, -1, 3)[:, torch.randperm(n ** 3, generator=g)]
    q = (torch.rand(1, 500, 3, generator=g) * (2 * n - 2)).round() * 0.5
    return q, lat


@pytest.mark.parametrize("case", ["m = 3", "all equal", "lattice ties", "on known points",
                                  "n = 1", "m past staged", "NaN known points"])
def test_three_nn_edges(dev, case):
    """Three known points; every known point equal (ties to the lowest
    indices); a lattice of exact ties, its lower indices in later tiles;
    queries on known points (zero distances) and on duplicated ones; one
    query; known points past the staged size (read through L1); NaN known
    points (never taken; sorted and scanned) and NaN queries ((+inf, 0) in
    every slot)."""
    g = torch.Generator().manual_seed(31)
    if case == "m = 3":
        unknown, known = torch.rand(2, 400, 3, generator=g), torch.rand(2, 3, 3, generator=g)
    elif case == "all equal":
        unknown, known = torch.rand(2, 300, 3, generator=g), torch.full((2, 50, 3), 0.5)
    elif case == "lattice ties":
        unknown, known = lattice(9, 32)
    elif case == "on known points":
        known = torch.rand(2, 1024, 3, generator=g)
        known[:, 900:] = known[:, :124]  # duplicates at higher indices
        unknown = torch.cat([known[:, 1000:], known[:, :300], torch.rand(2, 500, 3, generator=g)], 1)
    elif case == "n = 1":
        unknown, known = torch.rand(3, 1, 3, generator=g), torch.rand(3, 1024, 3, generator=g)
    elif case == "m past staged":
        unknown, known = torch.rand(2, 3000, 3, generator=g), torch.rand(2, 9000, 3, generator=g)
        assert not pc._three_nn_plan(2, 3000, 9000)["staged"]
    else:
        unknown, known = torch.rand(2, 500, 3, generator=g), torch.rand(2, 1024, 3, generator=g)
        known[:, ::3, 0] = float("nan")
        unknown[:, ::9, 1] = float("nan")
        three_nn_check(unknown.to(dev), known[:, :100].to(dev))
    d, i = three_nn_check(unknown.to(dev), known.to(dev))
    if case == "all equal":
        assert (i == torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)).all()
    if case == "NaN known points":
        assert (i[:, 1::9] % 3 != 0).all()
        assert (d[:, ::9] == float("inf")).all() and (i[:, ::9] == 0).all()


@pytest.mark.parametrize("B", [2, 200])
def test_three_nn_main_shapes(dev, B):
    """fp1's shape, 6890 queries against 1024 known points, at 2 and 200
    frames (the canonical train step's), with duplicated known points."""
    known = cloud(33, B, 1024, dup=100)
    unknown = cloud(34, B, 6890)
    unknown[:, :50] = known[:, 974:]  # on the duplicates: ties to the lower index
    three_nn_check(unknown, known)


@pytest.mark.parametrize("field,value", [("tile", 16), ("smem", -16), ("warps", 0),
                                         ("staged", False)])
def test_three_nn_entry_refuses(dev, field, value):
    """The C entry refuses a plan that does not match the kernel: another
    tile size, shared memory short of the staged points and boxes, no
    warps, unstaged known points without the pre-pass."""
    from garment4d_tpu_torch.ops import _build

    unknown, known = cloud(35, 2, 100), cloud(36, 2, 300)
    plan = dict(pc._three_nn_plan(2, 100, 300))
    plan[field] = plan["smem"] + value if field == "smem" else value
    if field == "staged":
        plan["sort"] = False
    d = torch.empty((2, 100, 3), device=dev)
    i = torch.empty((2, 100, 3), dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * (4 * (8 * plan["tiles"] + 2 * plan["tiles"] + 100) + 100), device=dev)
    p = scratch.data_ptr()
    err = _build.library().g4d_three_nn(
        unknown.data_ptr(), known.data_ptr(), 2, 100, 300, plan["tile"], int(plan["sort"]),
        plan["warps"], int(plan["staged"]), plan["smem"], p, p, p, p, d.data_ptr(), i.data_ptr(),
        _build.stream_of(unknown))
    assert err != 0


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


def edge_distances():
    """Squared distances at powers of two and one and two ulps around them,
    each six times: ties, and values on both sides of every digit boundary
    that a radix pass over the exponent bits can draw."""
    vals = [np.float32(2.0 ** e) * np.float32(1 + d * 2.0 ** -23)
            for e in range(-6, 2) for d in (-2, -1, 0, 1)]
    return np.array(vals * 6, np.float32)


def knn_edge_case(case):
    """(garment, body, w0, [(k, k64), ...]) on the CPU for one edge case."""
    g = torch.Generator().manual_seed(15)
    if case == "bin edges":
        d2 = edge_distances()
        body = torch.zeros(1, len(d2), 3)
        body[0, :, 0] = torch.from_numpy(np.sqrt(d2.astype(np.float64)).astype(np.float32))
        garment = torch.zeros(1, 3, 3)
        garment[0, 1:, 0] = body[0, 7, 0]  # on a body point, and on its six copies
        return garment, body, torch.rand(1, len(d2), 24, generator=g), [
            (5, 4), (17, 4), (64, 64), (100, 33), (len(d2), 1)]
    if case == "all equal":
        body = torch.full((2, 300, 3), 0.5)
        return torch.rand(2, 9, 3, generator=g), body, torch.rand(2, 300, 24, generator=g), [
            (1, 1), (40, 7), (300, 300)]
    if case == "N < 32":
        body = torch.rand(2, 20, 3, generator=g)
        return torch.rand(2, 5, 3, generator=g), body, torch.rand(2, 20, 24, generator=g), [
            (1, 1), (7, 3), (20, 20), (20, 1)]
    if case in ("J = 1", "J = 32"):
        body = torch.rand(2, 700, 3, generator=g)
        J = int(case[-2:])
        return torch.rand(2, 45, 3, generator=g), body, torch.rand(2, 700, J, generator=g), [
            (256, 64), (33, 33)]
    if case == "on body points":
        base = torch.rand(2, 400, 3, generator=g)
        body = torch.cat([base, base[:, :50]], 1)  # 50 points twice: two zero distances
        garment = torch.cat([body[:, :60], body[:, 300:303]], 1)
        return garment, body, torch.rand(2, 450, 24, generator=g), [(256, 64), (1, 1), (2, 2)]
    if case == "N >= 20000":  # the body read through L1, not staged
        body = torch.rand(1, 20000, 3, generator=g)
        return torch.rand(1, 40, 3, generator=g), body, torch.rand(1, 20000, 24, generator=g), [
            (256, 64), (512, 512)]
    if case == "N + 2k at the limit":
        body = torch.rand(1, 57000, 3, generator=g)
        return torch.rand(1, 9, 3, generator=g), body, torch.rand(1, 57000, 5, generator=g), [
            (556, 100)]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["bin edges", "all equal", "N < 32", "J = 1", "J = 32",
                                  "on body points", "N >= 20000", "N + 2k at the limit"])
def test_knn_transfer_edges(dev, case):
    """The radix-select kernel at the shapes and distances its passes and
    plan must survive (k = N, k64 = k, k64 = 1 among them): the 1-NN
    bitwise and the weights within KNN_TOL of the plain version."""
    garment, body, w0, ks = knn_edge_case(case)
    args = [t.contiguous().to(dev) for t in (garment, body, w0)]
    for k, k64 in ks:
        kk, k6, ki = skinning._knn_transfer_kernel(*args, k, k64)
        pk, p6, pi = skinning._knn_transfer_plain(*args, k, k64)
        torch.testing.assert_close(ki, pi, rtol=0, atol=0)
        torch.testing.assert_close(kk, pk, **KNN_TOL, equal_nan=True)
        torch.testing.assert_close(k6, p6, **KNN_TOL, equal_nan=True)


@pytest.mark.parametrize("case,k,k64", [("bin edges", 17, 4), ("bin edges", 100, 33),
                                        ("on body points", 256, 64), ("all equal", 40, 7)])
def test_knn_transfer_selection(dev, case, k, k64):
    """The kernel's own selections, read back through one-hot weights
    (`chip_smoke.knn_selection`), are exactly the plain version's wherever
    1/d^2 is finite (a zero distance weighs 0 either way), and its weights
    lie within KNN_TOL of the float64 transfer over them."""
    from chip_smoke import knn_float64_err, knn_plain_selection

    garment, body, w0, _ = knn_edge_case(case)
    garment, body, w0 = (t.contiguous().to(dev) for t in (garment, body, w0))
    outs = skinning._knn_transfer_kernel(garment, body, w0, k, k64)[:2]
    _, ok64, sel = knn_float64_err(garment, body, w0, k, k64, outs)
    d2 = pc.pairwise_sqdist(garment, body)
    finite = torch.isfinite(1.0 / d2)
    for s, kn in zip(sel, (k, k64)):
        assert torch.equal(s & finite, knn_plain_selection(d2, kn) & finite)
    assert ok64


def grouped_check(dev, radii, ns, table, centers, n_valid):
    """The grouped kernel bitwise the plain version, on the card."""
    table, centers, n_valid = (t.contiguous().to(dev) for t in (table, centers, n_valid))
    got = pc._ball_query_grouped_kernel(radii, ns, table, centers, n_valid)
    for g, r, s in zip(got, radii, ns):
        torch.testing.assert_close(g, pc._ball_query_plain(r, s, table, centers, n_valid),
                                   rtol=0, atol=0)
    return got


@pytest.mark.parametrize("radii,ns", [((0.2,), (8,)), ((0.1, 0.3), (8, 16)),
                                      ((0.1, 0.2, 0.4), (8, 16, 32))])
@pytest.mark.parametrize("case", ["all in radius", "no hit", "at r", "past n_valid",
                                  "S > n_valid", "ragged M"])
def test_ball_query_grouped_edges(dev, radii, ns, case):
    """The warp-per-center grouped query against the plain version: every
    row within every radius (the quotas full in the first 32-row step), no
    hit (every slot 0), rows exactly at r and an ulp or two off, real hits
    and far sentinels past n_valid (never found), fewer valid rows than S
    (tail slots copy the first hit), and centers that do not fill the last
    warp or block."""
    g = torch.Generator().manual_seed(16)
    N, M = 1200, 97
    table = torch.rand(3, N, 3, generator=g) * 0.8
    centers = torch.rand(3, M, 3, generator=g) * 0.8
    n_valid = torch.tensor([N, 900, 1], dtype=torch.int32)
    if case == "all in radius":
        table = 0.3 + torch.rand(3, N, 3, generator=g) * 0.01
        centers = 0.3 + torch.rand(3, M, 3, generator=g) * 0.01
    elif case == "no hit":
        centers = centers + 9.0
    elif case == "at r":
        pts = [boundary_cloud(r)[0] for r in radii]
        table = torch.cat([*pts, table[0, :100]], 0).expand(3, -1, -1)
        centers = torch.cat([boundary_cloud(radii[0])[1][None], centers[0]], 0).expand(3, -1, -1)
        n_valid = torch.tensor([table.shape[1], 7, 31], dtype=torch.int32)
    elif case == "past n_valid":
        n_valid = torch.tensor([300, 0, 650], dtype=torch.int32)
        table[0, 300:] = centers[0, :1]  # hits, but past the valid rows
        table[2, 650:] = 1e9  # far sentinels
    elif case == "S > n_valid":
        n_valid = torch.tensor([5, 3, 7], dtype=torch.int32)
        table = 0.3 + torch.rand(3, N, 3, generator=g) * 0.01
        centers[:, : M // 2] = 0.3
    elif case == "ragged M":
        centers = centers[:, :33]
    out = grouped_check(dev, radii, ns, table, centers, n_valid)
    if case == "no hit":
        assert all((o == 0).all() for o in out)
    if case == "all in radius":
        for o, s in zip(out, ns):
            assert torch.equal(o[0], torch.arange(s, dtype=torch.int32, device=dev).expand_as(o[0]))


@pytest.mark.parametrize("M", [1, 15, 16, 17, 2000])
def test_ball_query_grouped_centers(dev, M):
    """Center counts around the 16 warps of a block and the main path's
    2000, at the main path's table (4992 rows, 3000-4000 valid)."""
    g = torch.Generator().manual_seed(17)
    table = torch.rand(4, 4992, 3, generator=g)
    centers = torch.rand(4, M, 3, generator=g)
    n_valid = torch.tensor([4992, 3464, 3809, 4000], dtype=torch.int32)
    grouped_check(dev, (0.1, 0.2, 0.4), (8, 16, 32), table, centers, n_valid)


def test_ball_query_grouped_large_table(dev):
    """A table longer than the rows a block stages (7168): the rows past
    them read from device memory, in the same index order."""
    g = torch.Generator().manual_seed(18)
    table = torch.rand(3, 9000, 3, generator=g)
    centers = torch.rand(3, 50, 3, generator=g)
    n_valid = torch.tensor([9000, 7300, 7168], dtype=torch.int32)
    grouped_check(dev, (0.05, 0.1, 0.4), (8, 16, 32), table, centers, n_valid)


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


# the most points the 1-NN plan stages sorted (160 bytes a tile of 8)
NN1_STAGED = pc._NN1_STAGE_LIMIT // 160 * 8


@pytest.mark.parametrize("N", [1, 2, 7, 8, 9, 256, 257, NN1_STAGED, NN1_STAGED + 1, 6890, 20000])
@pytest.mark.parametrize("M", [1, 300])
def test_nn1(dev, N, M):
    """Ties (every point duplicated, queries on points), one query, one to
    nine points (a ragged tile), N around the scan threshold and the
    staging limit, the body's 6890 points, a set read through L1: d^2 and
    idx bitwise the plain version's."""
    base = cloud(17, 2, (N + 1) // 2)
    points = torch.cat([base, base], 1)[:, :N].contiguous()
    query = cloud(18, 2, M)
    query[:, : min(M, N)] = points[:, : min(M, N)]
    nn1_check(query, points)


def nn1_check(query, points):
    """The 1-NN kernel bitwise the plain version, squared distances and
    indices, on the card."""
    dk, ik = pc._nn1_kernel(query.contiguous(), points.contiguous())
    dp, ip = pc._nn1_plain(query, points)
    torch.testing.assert_close(ik, ip, rtol=0, atol=0)
    torch.testing.assert_close(dk, dp, rtol=0, atol=0, equal_nan=False)
    return dk, ik


@pytest.mark.parametrize("case", ["M = 0", "B = 1", "all equal", "lattice ties", "NaN points",
                                  "NaN queries", "no finite point", "main shape"])
def test_nn1_edges(dev, case):
    """No query (no launch); one frame of the body's size; every point
    equal (index 0 wins); a lattice of exact ties, its lower indices in
    later tiles; NaN points (never taken) and NaN queries ((+inf, 0)),
    sorted and scanned; frames whose points are all NaN or too far for a
    finite distance; the posed train step's shape, 40 frames of 2000
    vertices against 6890."""
    g = torch.Generator().manual_seed(41)
    if case == "M = 0":
        ops.reset_counts()
        d, i = pc._nn1_kernel(cloud(42, 2, 0), cloud(43, 2, 6890))
        assert d.shape == i.shape == (2, 0) and not ops.launch_counts
        return
    if case == "B = 1":
        query, points = torch.rand(1, 2000, 3, generator=g), torch.rand(1, 6890, 3, generator=g)
    elif case == "all equal":
        query, points = torch.rand(2, 300, 3, generator=g), torch.full((2, 700, 3), 0.5)
    elif case == "lattice ties":
        query, points = lattice(9, 44)
    elif case in ("NaN points", "NaN queries"):
        points = torch.rand(2, 3000, 3, generator=g)
        query = torch.rand(2, 400, 3, generator=g)
        if case == "NaN points":
            points[:, ::7, 1] = float("nan")
            small = points[:, :200].clone()  # a scanned set too
            nn1_check(query.to(dev), small.to(dev))
        else:
            query[:, ::5, 2] = float("nan")
            nn1_check(query.to(dev), points[:, :200].to(dev))
    elif case == "no finite point":
        points = torch.rand(3, 500, 3, generator=g)
        points[0] = float("nan")
        points[1, :, 0] = 3e38
        query = torch.rand(3, 100, 3, generator=g)
    else:
        points, query = cloud(45, 40, 6890, dup=300), cloud(46, 40, 2000)
        query[:, :100] = points[:, -100:]  # on the duplicates: ties to the lower index
    d, i = nn1_check(query.to(dev), points.to(dev))
    if case == "all equal":
        assert (i == 0).all()
    if case == "NaN points":
        assert (i % 7 != 0).all()
    if case == "NaN queries":
        assert (d[:, ::5] == float("inf")).all() and (i[:, ::5] == 0).all()
    if case == "no finite point":
        assert (d[:2] == float("inf")).all() and (i[:2] == 0).all()


@pytest.mark.parametrize("field,value", [("tile", 16), ("smem", -16), ("warps", 0),
                                         ("warps", 33), ("staged", False), ("N", 0)])
def test_nn1_entry_refuses(dev, field, value):
    """The C entry refuses a plan that does not match the kernel: another
    tile size, shared memory short of the staged points and boxes, no or
    too many warps, unstaged points without the pre-pass, no point."""
    from garment4d_tpu_torch.ops import _build

    query, points = cloud(47, 2, 100), cloud(48, 2, 300)
    plan = dict(pc._nn1_plan(2, 100, 300, 132))
    N = 0 if field == "N" else 300
    if field == "smem":
        plan["smem"] += value
    elif field != "N":
        plan[field] = value
    if field == "staged":
        plan["sort"] = False
    d = torch.empty((2, 100), device=dev)
    i = torch.empty((2, 100), dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * (4 * (8 * plan["tiles"] + 2 * plan["tiles"] + 100) + 100), device=dev)
    p = scratch.data_ptr()
    err = _build.library().g4d_nn1(
        query.data_ptr(), points.data_ptr(), 2, 100, N, plan["tile"], int(plan["sort"]),
        plan["warps"], int(plan["staged"]), plan["smem"], p, p, p, p, d.data_ptr(), i.data_ptr(),
        _build.stream_of(query))
    assert err != 0


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


@pytest.mark.parametrize("C,S", [(387, 4), (6, 4), (67, 12)])
def test_pe_bwd_padded_tie(dev, C, S):
    """S off the kernel's 8-row tile (padded with copies of slot 0) with
    slot 0 tied exactly to another row of equal content
    (`chip_smoke.padded_tie_case`): the pads take no share of the tie, so
    both halves match the plain version, which splits each tie evenly
    between the two rows as JAX does (dtable and the weight gradients
    within 1e-4 of their largest magnitude, dcenters within rtol 1e-4 /
    atol 1e-5, near-tie cotangents zeroed). Counting the pads among the
    tied slots gave slot 0's row 5/6 of an S=4 tie's share."""
    from chip_smoke import padded_tie_case, pe_near_ties

    args = padded_tie_case(C, S)
    args[-1] = args[-1] * ~pe_near_ties(*args[:6])
    got = pemax._pe_bwd_kernel(*args, table_grad=True)
    want = pemax._pe_bwd_plain(*args, table_grad=True)
    rows = args[1][:, :, 0].long()
    assert want[0].gather(1, rows[..., None].expand(-1, -1, C)).abs().sum() > 0  # ties live
    torch.testing.assert_close(got[1], want[1], **PE_TOL)
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


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
