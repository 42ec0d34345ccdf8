"""The comparisons that decide `correct`: the program's outputs against the
plain reference's, as the numbers each cell holds to its limits.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch


QUANTILES = (0.5, 0.9, 0.99, 0.999, 1.0)
FAR_M = 5e-4  # a vertex farther than this from the reference's counts in `far_share`


def reconstruct_numbers(port: List[dict], ref: List[dict]) -> Dict[str, float]:
    """`port` and `ref`: per checked batch {"logits" (F, N, 7), "coeff"
    (B, P), "lbs" (B, T, V, 3), "iters" [(B, T, V, 3)]}. The segmentation
    is compared on every point (the share of points whose label differs,
    the logits' relative gap); the stages after it on the sequences whose
    labels agree on every point (a label that flips on a near-tie changes
    which points the garment encoder sees), the share of the others given
    beside them: the PCA coefficients' relative gap, and of each garment
    (LBS, each refinement) the 90th percentile of the vertices' distance
    to the reference's, in metres. A vertex whose ball query takes another
    point on a radius tie moves further, with its neighbours in the GCN,
    so the distances' tail belongs to the rounding and their bulk does
    not; that tail is a small share of the vertices, so `far_share`, the
    largest share over the garments of vertices farther than `FAR_M` from
    the reference's, catches a fault confined to a frame or a sequence."""
    flips = points = disagree = seqs = 0
    d2 = {"logits": 0.0, "coeff": 0.0}
    n2 = dict(d2)
    dist = {k: [] for k in ("lbs", "iter0", "iter1", "iter2")}

    def add(key, a, r):
        d2[key] += float(((a.double() - r.double()) ** 2).sum())
        n2[key] += float((r.double() ** 2).sum())

    for p, r in zip(port, ref):
        add("logits", p["logits"], r["logits"])
        B = r["lbs"].shape[0]
        same = p["logits"].argmax(-1) == r["logits"].argmax(-1)
        flips += int((~same).sum())
        points += same.numel()
        ok = same.reshape(B, -1).all(dim=1)
        disagree += int((~ok).sum())
        seqs += B
        if ok.any():
            add("coeff", p["coeff"][ok], r["coeff"][ok])
            for key, a, b in [("lbs", p["lbs"], r["lbs"])] + [
                    (f"iter{i}", p["iters"][i], r["iters"][i]) for i in range(3)]:
                dist[key].append((a[ok].double() - b[ok].double()).norm(dim=-1).flatten().cpu())
    out = {"label_flip_share": flips / max(points, 1),
           "sequences_with_flips_share": disagree / max(seqs, 1)}
    for k in d2:
        out[f"{k}_rel"] = math.sqrt(d2[k] / n2[k]) if n2[k] > 0 else math.inf
    far = []
    for k, parts in dist.items():
        if not parts:
            out[f"{k}_p90_m"] = math.inf
            far.append(math.inf)
            continue
        d = torch.cat(parts)
        q = torch.quantile(d, torch.tensor(QUANTILES, dtype=torch.float64))
        out[f"{k}_p90_m"] = float(q[1])
        out[f"_{k}_quantiles_m"] = [float(x) for x in q]
        far.append(float((d > FAR_M).double().mean()))
        out[f"_{k}_far_share"] = far[-1]
    out["far_share"] = max(far)
    return out


def _leaf_gap(port: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep=None):
    """The worst leaf's |‖port‖ - ‖ref‖| over max(‖ref‖, the median
    leaf's ‖ref‖), over the leaves in `keep` (all by default)."""
    names = sorted(ref if keep is None else keep)
    norms = {n: float(ref[n].double().norm()) for n in names}
    floor = statistics.median(norms.values())
    worst, at = 0.0, ""
    for n in names:
        gap = abs(float(port[n].double().norm()) - norms[n]) / max(norms[n], floor, 1e-30)
        if not gap <= worst:  # NaN propagates as the worst
            worst, at = gap, n
    return worst, at


def train_numbers(port: dict, ref: dict) -> Dict[str, float]:
    """`port` / `ref`: {"losses": [{term: float}] a step, "grads": the
    first step's gradient by leaf, "start", "end": the trained tensors
    before the first step and after the last}. Compared: every loss term
    of each step (the total and each weighted term), as the worst
    relative gap of the step's terms (`loss_gap_<step>`); the first
    gradient and the change
    over the steps, by the worst leaf. Leaves whose reference gradient is
    under a thousandth of the median leaf's move under Adam by round-off
    alone and are left out of the change."""
    out = {}
    for step, (p, r) in enumerate(zip(port["losses"], ref["losses"]), 1):
        gaps = {k: abs(p[k] - v) / max(abs(v), 1e-30) for k, v in r.items()}
        worst = max(gaps, key=lambda k: (math.isnan(gaps[k]), gaps[k]))
        out[f"loss_gap_{step}"] = gaps[worst]
        out[f"_worst_term_{step}"] = worst
    grad_gap, grad_at = _leaf_gap(port["grads"], ref["grads"])
    gnorm = {n: float(g.double().norm()) for n, g in ref["grads"].items()}
    floor = statistics.median(gnorm.values())
    keep = [n for n, v in gnorm.items() if v >= 1e-3 * floor]
    change = {n: port["end"][n] - port["start"][n] for n in keep}
    ref_change = {n: ref["end"][n] - ref["start"][n] for n in keep}
    change_gap, change_at = _leaf_gap(change, ref_change)
    out.update(grad_gap=grad_gap, change_gap=change_gap,
               leaves_left_out=float(len(gnorm) - len(keep)),
               _worst_grad_leaf=grad_at, _worst_change_leaf=change_at)
    return out
