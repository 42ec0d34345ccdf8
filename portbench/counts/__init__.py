"""Frozen operation and byte counts of the cells' work, from shapes alone.

Nothing here reads the program: the counts follow from the configuration
(widths, sample counts, radii) and the workload (batch, frames, points,
template), so a kernel's roofline reads the same work whatever implements
it. Each `Op` is one operation of the model with

- `flops`: the least arithmetic the algorithm needs, 2 M N K for a
  product. The first layer of a grouped MLP (`grouped_mlp`) is counted
  per table row and per center, not per grouped row: (x_j - c) W =
  x_j W - c W, so no implementation needs more;
- `bytes`: each input read once and each output written once, float32
  and int32;
- `family`: the port's kernel counter (`portbench.profile.PROFILED`) whose
  launches do this work, or "torch" for work outside the port's kernels;
- `grad`: whether, in training, a gradient flows through its input or
  weights (the backward then costs twice its forward, recomputation not
  counted).

Searches (ball queries, coverage, 3-NN, 1-NN, K-NN) are counted by bytes
only: what an exact search computes depends on the data.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

PEAK_FP32 = 67e12   # H100 SXM, float32 outside the tensor cores, FLOP/s
PEAK_HBM = 3.35e12  # H100 SXM, HBM3, bytes/s
FPS_FLOPS = 9       # a distance update: 3 differences, 3 squares, 2 sums, a min
F4 = 4


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    family: str
    flops: float
    bytes: float
    grad: bool = False

    @property
    def bound_s(self) -> float:
        return max(self.flops / PEAK_FP32, self.bytes / PEAK_HBM)


@dataclasses.dataclass(frozen=True)
class Shapes:
    """The sizes a cell runs: batch, frames, points, body and template
    vertices, the configuration's widths and sample counts."""

    B: int
    T: int
    N: int
    Vg: int
    nb: int
    lbs_k: int
    pca_dim: int
    garment_nsample: tuple
    body_nsample: tuple
    adj_nnz: int        # nonzeros of the template's (A + I)
    joints: int = 24
    iterations: int = 3
    feat: int = 32
    hidden: int = 128

    @classmethod
    def of(cls, config: dict, workload: dict, template_faces: np.ndarray):
        Vg = config["template"]["num_rings"] * config["template"]["ring_size"]
        f = np.asarray(template_faces, np.int64)
        edges = set()
        for s, t in ((0, 1), (1, 2), (2, 3), (3, 0)):
            for a, b in zip(f[:, s], f[:, t]):
                edges.add((int(a), int(b)))
                edges.add((int(b), int(a)))
        return cls(B=workload["batch"], T=workload["frames"], N=workload["points"], Vg=Vg,
                   nb=config["body_vertices"], lbs_k=config["lbs_k"],
                   pca_dim=config["pca_dim"],
                   garment_nsample=tuple(config["garment_nsample"]),
                   body_nsample=tuple(config["body_nsample"]),
                   adj_nnz=len(edges) + Vg, iterations=config["iterations"])


def grouped_mlp(name, family, F, n, m, S, c_feat, widths, grad=False, split=True) -> Op:
    """An MLP over the (m x S) grouped rows of a table of n points with
    c_feat feature channels (the rows are xyz - center and the features),
    max over the S samples; `F` frames."""
    rows = F * m * S
    c_in = 3 + c_feat
    w0 = widths[0]
    first = (2 * F * (n * c_in + m * 3) * w0 + rows * w0) if split else 2 * rows * c_in * w0
    rest = sum(2 * rows * a * b for a, b in zip(widths[:-1], widths[1:]))
    weights = sum(a * b + b for a, b in zip((c_in,) + tuple(widths[:-1]), widths))
    byts = F4 * (F * n * c_in + F * m * 3 + rows + weights + F * m * widths[-1])
    return Op(name, family, first + rest, byts, grad)


def dense(name, family, rows, widths, grad=False) -> Op:
    flops = sum(2 * rows * a * b for a, b in zip(widths[:-1], widths[1:]))
    byts = F4 * (rows * widths[0] + rows * widths[-1]
                 + sum(a * b + b for a, b in zip(widths[:-1], widths[1:])))
    return Op(name, family, flops, byts, grad)


def fps(name, F, n, npoint) -> Op:
    return Op(name, "fps", FPS_FLOPS * F * n * (npoint - 1), F4 * F * (n * 3 + npoint))


def search(name, family, F, n, m, out_per_query) -> Op:
    """A search of m queries over n points a frame, writing
    `out_per_query` int32 or float32 values a query."""
    return Op(name, family, 0, F4 * F * (n * 3 + m * 3 + m * out_per_query))


def gather(name, F, rows, C, n_table) -> Op:
    """`rows` rows of C floats taken from a table of `n_table` rows by
    int32 indices, a frame."""
    return Op(name, "gather_rows", 0, F4 * F * (n_table * C + rows * (C + 1)))


def _sa(prefix, F, n, npoint, nsamples, c_feat, mlps, fused, train, split) -> List[Op]:
    ops = [fps(f"{prefix}.fps", F, n, npoint),
           search(f"{prefix}.ball_query", "ball_query", F, n, npoint, sum(nsamples))]
    for i, (S, widths) in enumerate(zip(nsamples, mlps)):
        fam = "fused_chain" if fused else "torch"
        ops.append(grouped_mlp(f"{prefix}.mlp{i}", fam, F, n, npoint, S, c_feat, widths,
                               grad=train, split=split))
        if not fused:
            ops.append(gather(f"{prefix}.group{i}", F, npoint * S, 3 + c_feat, n))
    return ops


def canonical_ops(s: Shapes, F: int, train: bool, split: bool = True) -> List[Op]:
    """The canonical stage over F frames: in eval the SA stages are the
    fused chains, in training plain products over gathered rows."""
    N, fused = s.N, not train
    ops = []
    ops += _sa("sa1", F, N, 1024, (16, 32), 0, ((16, 16, 32), (32, 32, 64)), fused, train, split)
    ops += _sa("sa2", F, 1024, 256, (16, 32), 96, ((32, 32, 64), (64, 64, 128)), fused, train,
               split)
    ops += _sa("sa3", F, 256, 64, (32, 64), 192, ((64, 64, 128), (128, 128, 256)), fused,
               train, split)
    for name, n, m, c_known, c_unknown, widths in (("fp3", 256, 64, 384, 192, (512, 256)),
                                                   ("fp2", 1024, 256, 256, 96, (256, 128)),
                                                   ("fp1", N, 1024, 128, 0, (128, 64))):
        ops.append(search(f"{name}.three_nn", "three_nn", F, m, n, 6))
        ops.append(gather(f"{name}.interp", F, n * 3, c_known, m))
        ops.append(dense(f"{name}.mlp", "torch", F * n, (c_known + c_unknown,) + widths, train))
    ops.append(dense("head", "torch", F * N, (64, 32, 7), train))
    ng = N // 4
    ops += _sa("garment_sa1", F, ng, 512, (16, 32), 64, ((32, 32), (64, 64)), fused, train,
               split)
    ops += _sa("garment_sa2", F, 512, 64, (32, 64), 96, ((128, 128), (256, 256)), fused, train,
               split)
    ops.append(dense("garment_summarize", "torch", F * 64, (387, 512, 512), train))
    B = F // s.T
    ops.append(dense("pca_head", "torch", B, (512, 128, 64, s.pca_dim), train))
    ops.append(dense("pca_inverse", "torch", B, (s.pca_dim, 3 * s.Vg), train))
    return ops


def lbs_ops(s: Shapes) -> List[Op]:
    B, F, Vg, J = s.B, s.B * s.T, s.Vg, s.joints
    return [
        Op("lbs.knn_transfer", "knn_transfer", 0,
           F4 * B * (Vg * 3 + s.nb * 3 + s.nb * J + 2 * Vg * J + Vg)),
        # the 100-step smoothing, each step a sparse product with (A + I)
        Op("lbs.smoothing", "torch", 100 * 2 * B * s.adj_nnz * J, F4 * 2 * B * Vg * J),
        Op("lbs.skinning", "torch", 2 * F * Vg * J * 16 + 2 * F * Vg * 12, F4 * F * Vg * 3 * 2),
    ]


def refine_ops(s: Shapes, F: int, train: bool) -> List[Op]:
    Vg, nb, W = s.Vg, s.nb, s.feat
    ops = []
    for it in range(s.iterations):
        ops.append(Op(f"it{it}.coverage", "coverage", 0, F4 * F * (nb * 3 + Vg * 3) + F * nb))
        ops.append(search(f"it{it}.body_query", "ball_query_grouped", F, nb, Vg,
                          sum(s.body_nsample)))
        for i, S in enumerate(s.body_nsample):
            ops.append(grouped_mlp(f"it{it}.body_pe{i}", "fused_chain", F, nb, Vg, S, 3,
                                   (W, W), grad=train))
        for i, (n, c, S) in enumerate(zip((s.N // 4, 512, 64), (64, 96, 384),
                                          s.garment_nsample)):
            ops.append(search(f"it{it}.garment_query{i}", "ball_query", F, n, Vg, S))
            ops.append(grouped_mlp(f"it{it}.garment_pe{i}", "fused_chain", F, n, Vg, S, c,
                                   (W, W), grad=train))
        width = 3 + 6 * W
        if it > 0:
            B, T, H = F // s.T, s.T, s.hidden
            ops.append(dense(f"it{it}.temporal_qkv", "torch", F * Vg, (H, 3 * H), train))
            ops.append(Op(f"it{it}.attention", "torch", 2 * 2 * B * T * T * Vg * H,
                          F4 * 4 * F * Vg * H, train))
            width += s.hidden
        for layer, (a, b) in enumerate(zip((width, 128, 128, 128), (128, 128, 128, 3))):
            ops.append(Op(f"it{it}.gcn{layer}", "gcn_stack",
                          2 * F * Vg * a * b + 2 * F * s.adj_nnz * b,
                          F4 * (F * Vg * (a + b) + a * b + b), train))
    return ops


def forward_ops(path: str, s: Shapes, split: bool = True) -> List[Op]:
    """The forward work of one step of `path` ("reconstruct",
    "train_posed", "train_canonical")."""
    F = s.B * s.T
    if path == "train_canonical":
        return canonical_ops(s, F, True, split)
    ops = canonical_ops(s, F, False, split) + lbs_ops(s)
    # the body's vertex normals: each face normal taken by its three corners
    ops.append(gather("body_normals", F, 6 * s.nb, 3, 2 * s.nb))
    return ops + refine_ops(s, F, path == "train_posed")


def model_flops(path: str, s: Shapes, split: bool = True) -> float:
    """The model's arithmetic a step: its forward, and in training twice
    the forward of every operation that carries a gradient."""
    ops = forward_ops(path, s, split)
    extra = 2 * sum(o.flops for o in ops if o.grad) if path.startswith("train") else 0
    return sum(o.flops for o in ops) + extra


def kernel_ops(path: str, s: Shapes) -> List[Op]:
    """The work a step gives the port's kernels: the forward operations of
    a kernel family, and in training the backward's (PE blocks' weight
    gradients, the graph products' transposes, the gathers' scatter-adds,
    the losses' 1-NN searches), each counted at its least."""
    F = s.B * s.T
    ops = [o for o in forward_ops(path, s) if o.family != "torch"]
    if path == "train_posed":
        for o in forward_ops(path, s):
            if o.family == "fused_chain" and (".body_pe" in o.name or ".garment_pe" in o.name):
                # the weight gradients of the second layer and its input gradient,
                # over each center's routed rows (one a channel)
                ops.append(Op(o.name + ".bwd", "pe_bwd", 2 * 2 * F * s.Vg * s.feat * s.feat,
                              F4 * F * s.Vg * s.feat * 2))
        for it in range(s.iterations):
            for layer in range(4):
                width = 3 if layer == 3 else s.hidden
                ops.append(Op(f"it{it}.gcn{layer}.banded_bwd", "banded",
                              2 * F * s.adj_nnz * width, F4 * 2 * F * s.Vg * width))
            ops.append(search(f"it{it}.loss_nn1", "nn1", F, s.nb, s.Vg, 2))
    if path == "train_canonical":
        for o in forward_ops(path, s):
            if o.family == "gather_rows":
                ops.append(Op(o.name + ".scatter", "scatter_add", 0, o.bytes))
        ops.append(search("loss_nn1", "nn1", s.B, s.nb, s.Vg, 2))
    return ops
