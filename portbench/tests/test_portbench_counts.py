"""The frozen counts against torch's FlopCounterMode on the plain
reference at a tiny size: the products the counts name are the products
the model computes. The counts' own first layers of grouped MLPs are
counted per point (`split=True`), never above the grouped form."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, harness, inputs
from portbench.reference.network import Net, load_weights

OVER = dict(batch=2, frames=2, points=600)
CONF = dict(template={"num_rings": 6, "ring_size": 8}, body_vertices=300)


def flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    cell = harness.load_cell("skirt-reconstruct", overrides=OVER, config_overrides=CONF)
    body = inputs.body_on(cell.body, "cpu")
    net = Net(load_weights(cell.weights, "cpu"), cell.template, body,
              cell.config["garment_label"], cell.sizes, "cpu")
    batch = inputs.make_batch(cell.template, 1, body, batch_size=2, T=2, npoints=600, seed=3,
                              device="cpu")
    return cell, net, batch


def test_canonical_stage_products(setup):
    cell, net, batch = setup
    s = cell.shapes
    want = sum(o.flops for o in counts.canonical_ops(s, s.B * s.T, False, split=False)
               if o.family not in ("fps",))
    assert flops(lambda: net.canonical(batch["pcd"])) == want


def test_refinement_products(setup):
    cell, net, batch = setup
    s = cell.shapes
    F, B, T = s.B * s.T, s.B, s.T
    with torch.no_grad():
        canon = net.canonical(batch["pcd"])
        body_v = batch["smpl_vertices"].reshape(F, -1, 3)
        from portbench.reference import geometry as G
        body_vn = G.vertex_normals(body_v, net.body_faces)
        lbs = net.lbs(canon["tpose_garment"], batch)
    got = flops(lambda: net.refine(canon["levels"], body_v, body_vn, lbs, B, T))
    want = 0
    for o in counts.refine_ops(s, F, False):
        if o.family == "gcn_stack":
            # the reference's dense adjacency in place of its nonzeros
            out = 3 if o.name.endswith("gcn3") else s.hidden
            want += o.flops - 2 * F * s.adj_nnz * out + 2 * F * s.Vg * s.Vg * out
        elif o.family == "fused_chain":
            name = o.name.split(".")[1]
            i = int(name[-1])
            S = (s.body_nsample if name.startswith("body") else s.garment_nsample)[i]
            n = s.nb if name.startswith("body") else (s.N // 4, 512, 64)[i]
            c = 3 if name.startswith("body") else (64, 96, 384)[i]
            want += counts.grouped_mlp("", "", F, n, s.Vg, S, c, (32, 32), split=False).flops
        else:
            want += o.flops
    assert got == want


def test_split_first_layers_never_count_more(setup):
    cell = setup[0]
    for path in ("reconstruct", "train_posed", "train_canonical"):
        s = cell.shapes
        assert counts.model_flops(path, s) <= counts.model_flops(path, s, split=False)


def test_adjacency_nonzeros_of_the_ring():
    faces = inputs.ring_template(5, 8, 4)["faces"]
    s = counts.Shapes.of(dict(template={"num_rings": 5, "ring_size": 8}, body_vertices=10,
                              lbs_k=4, pca_dim=4, garment_nsample=[1, 1, 1],
                              body_nsample=[1, 1, 1], iterations=3),
                         dict(batch=1, frames=1, points=8), faces)
    # 5 rings of 8: inner rings 4 neighbours, the two end rings 3, plus the diagonal
    assert s.adj_nnz == 3 * 8 * 4 + 2 * 8 * 3 + 40


def test_bound_is_the_larger_of_bytes_and_arithmetic():
    op = counts.Op("x", "fps", flops=67e9, bytes=3.35e9)
    assert op.bound_s == pytest.approx(1e-3)
    assert counts.Op("x", "fps", flops=0, bytes=6.7e9).bound_s == pytest.approx(2e-3)
