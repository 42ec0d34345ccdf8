"""GCN node-classification demo on a synthetic citation-style graph.

Counterpart of `demos/gcn_node_demo.py` (the reference's vendored Cora
demo, `modules/pygcn/train.py`): two `nn.GraphConvolution` layers over the
dense row-normalised adjacency of a stochastic-block-model graph (3
communities), trained with Adam at 1e-2 on the card (`--cpu` for the CPU).
The graph and the features are the JAX demo's, drawn from
`RandomState(0)`. Gate: accuracy above 0.9.

Usage: python -m garment4d_tpu_torch.demos.gcn_node_demo [--steps 100] [--nodes 300] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from garment4d_tpu_torch import _device
from garment4d_tpu_torch.nn import GraphConvolution
from garment4d_tpu_torch.ops import row_normalize

CLASSES = 3


def sbm_graph(nodes: int, seed: int = 0):
    """The JAX demo's graph: labels (nodes,) in [0, 3), an SBM adjacency
    (intra 0.1, inter 0.01), symmetric without self loops, row-normalised
    with I added, and identity-plus-noise features. -> (features (n, n),
    normalised adjacency (n, n), labels (n,)), numpy."""
    rng = np.random.RandomState(seed)
    n = nodes
    labels = rng.randint(0, CLASSES, n)
    p = np.where(labels[:, None] == labels[None, :], 0.1, 0.01)
    adj = (rng.rand(n, n) < p).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0)
    norm_adj = row_normalize(adj + np.eye(n, dtype=np.float32))
    feats = np.eye(n, dtype=np.float32) + rng.randn(n, n).astype(np.float32) * 0.01
    return feats, norm_adj, labels


class GCN(nn.Module):
    def __init__(self, in_features: int, hidden: int = 32, classes: int = CLASSES):
        super().__init__()
        self.gc1 = GraphConvolution(in_features, hidden)
        self.gc2 = GraphConvolution(hidden, classes)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        return self.gc2(torch.relu(self.gc1(x, adj)), adj)


def train(feats, norm_adj, labels, steps: int, device, lr: float = 1e-2, log_every: int = 20):
    """Full-batch training from a seed-0 init: -> [(loss, accuracy)] a
    step, each read after its step."""
    dev = _device.resolve(device)
    torch.manual_seed(0)
    x = torch.as_tensor(feats, device=dev)[None]
    a = torch.as_tensor(norm_adj, device=dev)
    y = torch.as_tensor(labels, device=dev).long()
    model = GCN(x.shape[-1]).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    history = []
    for i in range(steps):
        logits = model(x, a)[0]
        loss = -torch.log_softmax(logits, -1).gather(1, y[:, None]).mean()
        acc = (logits.argmax(-1) == y).float().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        history.append((loss.item(), acc.item()))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:3d}  loss {history[-1][0]:.4f}  acc {history[-1][1]:.3f}", flush=True)
    return history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--nodes", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    history = train(*sbm_graph(args.nodes), args.steps, "cpu" if args.cpu else _device.DEFAULT)
    if not history[-1][1] > 0.9:
        raise SystemExit(f"gcn_node_demo: accuracy {history[-1][1]:.3f}; the demo should fit "
                         f"the SBM communities (> 0.9)")
    print("OK")
    return history


if __name__ == "__main__":
    main()
