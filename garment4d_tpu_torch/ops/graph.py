"""Mesh-graph operators.

Counterpart of `garment4d_tpu/ops/graph.py`. Built once on the host, in
numpy: dense adjacency with the reference's construction quirks, row
normalisation, the GCN propagation matrix, the uniform Laplacian, the
precomputed 100-step weight-smoothing operator, the cyclic-diagonal offsets
of a banded matrix and the reverse Cuthill-McKee permutation that recovers
a banded vertex order. On the device, in torch: the dense and banded graph
products and the posed stage's 4-layer GCN stack, which a CUDA tensor with
a banded adjacency runs on the kernel `csrc/gcn_stack.cu`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from garment4d_tpu_torch.ops import _build
from garment4d_tpu_torch.ops.pointcloud import use_kernel


def build_mesh_adjacency(faces, num_vertices: int) -> np.ndarray:
    """Symmetric adjacency from (quad or tri) faces, dense float32.

    Reproduces the reference construction: 4 edge slots per face, zero-
    initialised, so duplicate directed edges sum and a triangle face leaves
    slot 2 at the spurious (0, 0) entry; symmetrised as max(A, A^T).
    """
    adj = np.zeros((num_vertices, num_vertices), dtype=np.float32)
    for f in faces:
        f = list(f)
        if len(f) == 4:
            pairs = [(f[0], f[1]), (f[1], f[2]), (f[2], f[3]), (f[3], f[0])]
        elif len(f) == 3:
            pairs = [(f[0], f[1]), (f[1], f[2]), (0, 0), (f[2], f[0])]
        else:
            raise NotImplementedError(f"face of degree {len(f)}")
        for a, b in pairs:
            adj[a, b] += 1.0
    return np.maximum(adj, adj.T)


def row_normalize(adj: np.ndarray) -> np.ndarray:
    """D^-1 A row normalisation (zero rows stay zero)."""
    rowsum = adj.sum(axis=1)
    inv = np.where(rowsum > 0, 1.0 / np.where(rowsum > 0, rowsum, 1.0), 0.0)
    return (adj * inv[:, None]).astype(np.float32)


def gcn_adjacency(adj: np.ndarray) -> np.ndarray:
    """Row-normalised (A + I), the GCN propagation matrix."""
    return row_normalize(adj + np.eye(adj.shape[0], dtype=np.float32))


def laplacian_adjacency(adj: np.ndarray) -> np.ndarray:
    """I - D^-1 A, the uniform graph Laplacian."""
    return (np.eye(adj.shape[0], dtype=np.float32) - row_normalize(adj)).astype(np.float32)


def smoothing_operator(adj: np.ndarray, coeff: float = 0.1, iters: int = 100) -> np.ndarray:
    """(I + coeff * (D^-1 A - I))^iters as a dense float32 matrix, by
    repeated squaring in float64."""
    n = adj.shape[0]
    m = np.eye(n, dtype=np.float64) + coeff * (row_normalize(adj).astype(np.float64) - np.eye(n))
    result = np.eye(n, dtype=np.float64)
    base = m
    k = iters
    while k > 0:
        if k & 1:
            result = result @ base
        base = base @ base
        k >>= 1
    return result.astype(np.float32)


def cyclic_diagonals(mat: np.ndarray, max_diags: int = 32):
    """Offsets (ascending) of the nonzero cyclic diagonals of a (V, V)
    matrix: `mat[i, j] != 0` only where `(j - i) mod V` is one of them; None
    if there are more than `max_diags`."""
    v = mat.shape[0]
    i, j = np.nonzero(mat)
    offs = np.unique((j - i) % v)
    if len(offs) > max_diags:
        return None
    return tuple(int(o) for o in offs)


def bandwidth_permutation(adj: np.ndarray, max_diags: int = 64):
    """A vertex permutation that makes `adj` cyclic-banded: of the identity
    and the reverse Cuthill-McKee order (scipy), the one with the fewest
    nonzero cyclic diagonals. Returns (perm (V,) int32, offsets), or
    (None, None) if both exceed `max_diags`."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    v = adj.shape[0]
    rcm = reverse_cuthill_mckee(
        csr_matrix((adj != 0).astype(np.int8)), symmetric_mode=True)
    best = (None, None, v + 1)
    for perm in (np.arange(v, dtype=np.int32), np.asarray(rcm, np.int32)):
        offs = cyclic_diagonals(adj[perm][:, perm], max_diags=max_diags)
        if offs is not None and len(offs) < best[2]:
            best = (perm, offs, len(offs))
    return best[0], best[1]


def diagonal_values(adj: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """(D, V): row d holds adj[i, (i + offsets[d]) mod V]."""
    v = adj.shape[0]
    rows = torch.arange(v, device=adj.device)
    offs = torch.as_tensor(offsets, dtype=torch.long, device=adj.device)
    return adj[rows[None, :], (rows[None, :] + offs[:, None]) % v]


def graph_matmul(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """adj (V, V), x (..., V, C) -> (..., V, C)."""
    return torch.matmul(adj, x)


def graph_matmul_banded(adj: torch.Tensor, x: torch.Tensor, offsets) -> torch.Tensor:
    """`graph_matmul` for a matrix whose nonzero cyclic diagonals are
    `offsets`: sum over d of vals[d] * roll(x, -o_d) along V, in offset
    order (the same result up to fp32 summation order)."""
    vals = diagonal_values(adj, offsets)
    out = None
    for d, o in enumerate(offsets):
        term = torch.roll(x, -int(o), dims=-2) * vals[d][:, None]
        out = term if out is None else out + term
    return out


def _gcn_stack_ref(xs, weights, biases, adj, offsets, relus, hidden_layer):
    """Unfused stack: h <- adj @ (h @ W) + b (+ ReLU) per layer, banded when
    `offsets` is given, dense otherwise. Returns (final output, the
    post-activation output of layer `hidden_layer`)."""
    h = torch.cat(list(xs), dim=-1) if len(xs) > 1 else xs[0]
    hidden = None
    for i, (w, b, r) in enumerate(zip(weights, biases, relus)):
        support = torch.matmul(h, w)
        if offsets is not None:
            h = graph_matmul_banded(adj, support, offsets) + b
        else:
            h = graph_matmul(adj, support) + b
        if r:
            h = torch.relu(h)
        if i == hidden_layer:
            hidden = h
    return h, hidden


_MAX_PIECES = 8
_MAX_DIAGS = 64  # bandwidth_permutation's limit
_GCN_TILE = 64  # vertices per block; a multiple of the kernel's 8-row tile


def _gcn_stack_kernel(xs, weights, biases, vals: torch.Tensor,
                      offsets: Sequence[int], relus, hidden_layer: int):
    """One launch of `g4d_gcn_layer` per layer. Layer 0 reads the pieces
    through a pointer array, so their concatenation is never written."""
    _build.refuse_grad("gcn_stack", *xs, *weights, *biases)
    dev = xs[0].device
    B, V = xs[0].shape[:2]
    if not 1 <= len(xs) <= _MAX_PIECES:
        raise ValueError(f"gcn_stack: {len(xs)} pieces (1..{_MAX_PIECES} supported)")
    for x in xs:
        _build.require(x, "piece", torch.float32, 3, dev)
        if x.shape[:2] != (B, V):
            raise ValueError(f"gcn_stack: piece {tuple(x.shape)} after ({B}, {V}, .)")
    D = len(offsets)
    if not 1 <= D <= _MAX_DIAGS or any(not 0 <= o < V for o in offsets):
        raise ValueError(f"gcn_stack: offsets {tuple(offsets)} for V={V} "
                         f"(1..{_MAX_DIAGS} offsets in [0, V))")
    _build.require(vals, "vals", torch.float32, 2, dev)
    if vals.shape != (D, V):
        raise ValueError(f"gcn_stack: vals {tuple(vals.shape)}, expected ({D}, {V})")
    if sum(x.shape[2] for x in xs) != weights[0].shape[0]:
        raise ValueError("gcn_stack: piece widths must sum to the rows of W0")
    lib = _build.library()
    offs = (ctypes.c_int * _MAX_DIAGS)(*offsets)
    pieces = list(xs)
    hidden = out = None
    for layer, (w, b, relu) in enumerate(zip(weights, biases, relus)):
        _build.require(w, "weight", torch.float32, 2, dev)
        _build.require(b, "bias", torch.float32, 1, dev)
        K, F = w.shape
        if K != sum(p.shape[2] for p in pieces) or b.shape[0] != F:
            raise ValueError(f"gcn_stack: layer {layer} weight {tuple(w.shape)}, "
                             f"bias {tuple(b.shape)} after width "
                             f"{sum(p.shape[2] for p in pieces)}")
        F4 = _build.pitch(F)
        if F4 != F:  # float4 weight loads: pad the columns with zeros
            w = torch.nn.functional.pad(w, (0, F4 - F))
            b = torch.nn.functional.pad(b, (0, F4 - F))
        P = _build.pitch(K)
        smem = _GCN_TILE * P * 4
        if smem > _build.SMEM_LIMIT:
            raise ValueError(f"gcn_stack: width {K} needs {smem} B of shared memory")
        out = torch.empty((B, V, F), dtype=torch.float32, device=dev)
        ptrs = (ctypes.c_void_p * _MAX_PIECES)(*[p.data_ptr() for p in pieces])
        widths = (ctypes.c_int * _MAX_PIECES)(*[p.shape[2] for p in pieces])
        _build.launch_counts["gcn_stack"] += 1
        _build.check(lib.g4d_gcn_layer(
            ptrs, widths, len(pieces), B, V, K, vals.data_ptr(), offs, D,
            w.data_ptr(), b.data_ptr(), F, F4, int(bool(relu)), _GCN_TILE,
            smem, out.data_ptr(), _build.stream_of(out)), "gcn_stack")
        if layer == hidden_layer:
            hidden = out
        pieces = [out]
    return out, hidden


def gcn_stack(xs, weights, biases, adj: torch.Tensor,
              offsets: Optional[Sequence[int]], relus, hidden_layer: int):
    """The posed stage's GCN refinement stack as one op.

    xs: sequence of (B, V, C_i) feature pieces whose channel concatenation
    is the stack input; weights: (C_in, C_out) per layer, weights[0] taking
    sum(C_i) rows; biases: (C_out,); adj: (V, V) dense adjacency; offsets:
    its cyclic-diagonal offsets, or None for a dense product; relus: per
    layer; hidden_layer: the layer whose post-activation output is returned
    too. -> (out (B, V, C_last), hidden (B, V, C_hidden)).

    A CUDA tensor with a banded adjacency runs the kernel, which forms
    (adj @ h) @ W per layer (the plain version adj @ (h @ W): equal up to
    fp32 summation order). A dense adjacency, a CPU tensor or any tensor
    inside `plain_ops()` runs the plain stack. The kernel path is
    forward-only."""
    if offsets is not None and use_kernel(xs[0]):
        return _gcn_stack_kernel(
            [x.contiguous() for x in xs], [w.contiguous() for w in weights],
            [b.contiguous() for b in biases],
            diagonal_values(adj, offsets).contiguous(),
            tuple(int(o) for o in offsets), tuple(relus), int(hidden_layer))
    return _gcn_stack_ref(xs, weights, biases, adj, offsets, relus, hidden_layer)
