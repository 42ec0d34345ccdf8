"""Morton (Z-order) spatial ordering of point tables.

Counterpart of `garment4d_tpu/ops/morton.py`. The reference's ball query
takes the first `nsample` in-radius points in index order; sorting a table
by Morton code instead makes each spatial neighbourhood a narrow index
window, and the first-`nsample` subset a different but equally arbitrary
in-radius sample. `PosedGarmentModel(spatial_sample=True)` and
`query_group_pe_multi(spatial=True)` use it; the default path keeps index
order (checkpoint-parity eval).

Plain torch ops on the tensor's device, as the JAX package computes the
codes in plain `jnp` outside any kernel. The codes are bitwise the JAX
package's on every device: the same fp32 operations in the same order
(per-frame bounds over all points, `(xyz - lo) / span * 1023`, clip,
truncation to int32), then the same bit interleave.
"""

from __future__ import annotations

import torch

_BITS = 10  # 10 bits an axis -> 30-bit codes in int32
_MAX_Q = (1 << _BITS) - 1


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x (int32) two zero bits apart (the
    Morton magic-number expansion)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_codes(xyz: torch.Tensor) -> torch.Tensor:
    """Per-frame Morton codes: xyz (B, N, 3) float32 -> (B, N) int32.
    Coordinates are quantised to 10 bits over each frame's own bounding
    box (a degenerate axis quantises to 0), then interleaved x | y << 1 |
    z << 2."""
    xyz = xyz.detach()
    lo = xyz.amin(dim=1, keepdim=True)
    hi = xyz.amax(dim=1, keepdim=True)
    span = torch.clamp_min(hi - lo, 1e-12)
    q = (xyz - lo) / span * _MAX_Q
    q = torch.clamp(q, 0, _MAX_Q).to(torch.int32)
    return (_part1by2(q[..., 0]) | (_part1by2(q[..., 1]) << 1)
            | (_part1by2(q[..., 2]) << 2))


def spatial_order(xyz: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts each frame's points by Morton code,
    stable (ties in index order): xyz (B, N, 3) -> (B, N) int32, with
    xyz[b, perm[b]] in Z-order."""
    return torch.argsort(morton_codes(xyz), dim=1, stable=True).to(torch.int32)
