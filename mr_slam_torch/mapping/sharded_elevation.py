"""Terrain features over a grid cut into row blocks, one a rank, with a
halo exchange (port of `mr_slam_tpu/mapping/sharded_elevation.py`:
`HALO`, `features_sharded`).

The reference's third scaling axis is map extent: it shards the global
2.5D grid by row blocks over the mesh and runs the 5x5 terrain-feature
stencil on each block after exchanging 2-row halos with the
neighbouring blocks (`ppermute`). Here a block is a rank's: each rank
sends its top and bottom HALO rows, receives its neighbours', and runs
`elevation.features` on its (Hl + 2 HALO, W) block — on a CUDA tensor
the stencil kernel, once a block — then crops the halo. Gloo has no
`send` / `recv` for CUDA tensors, so the exchange is one all-gather of
every rank's edge rows (4 x W cells a rank).

At the grid's top and bottom the reference's halo holds wrapped rows,
which it replaces by zero height and `valid = False`; so does this
port. That zero takes part in the step's window max where the
unsharded `features` has none (out-of-grid cells are -inf there), so
the two agree bit for bit on rows [HALO, H - HALO) and step (and with it
traversability) may differ on the two border rows at each end.
"""
from __future__ import annotations

import torch

from ..parallel import mesh
from . import elevation

HALO = 2  # the 5x5 window's radius


def features_block(height: torch.Tensor, valid: torch.Tensor, resolution, group,
                   slope_crit: float = 0.6, rough_crit: float = 0.15,
                   step_crit: float = 0.3) -> elevation.TerrainFeatures:
    """Terrain features of this rank's (Hl, W) row block of a grid cut
    over the ranks of `group` in rank order: exchange the halos, run the
    features on the padded block, crop."""
    n, me = mesh.size(group), mesh.rank(group)
    edges = torch.stack([height[:HALO], height[-HALO:],
                         valid[:HALO].to(height.dtype), valid[-HALO:].to(height.dtype)])
    if group is not None:
        edges = mesh.all_gather(edges, group)                # (n, 4, HALO, W)
    else:
        edges = edges[None]
    fill = torch.zeros_like(height[:HALO])
    # my top halo is the previous block's bottom rows, my bottom halo the
    # next block's top rows; the grid's own edges get empty rows
    h_prev, v_prev = (edges[me - 1, 1], edges[me - 1, 3]) if me > 0 else (fill, fill)
    h_next, v_next = (edges[me + 1, 0], edges[me + 1, 2]) if me < n - 1 else (fill, fill)
    h = torch.cat([h_prev, height, h_next])
    v = torch.cat([v_prev > 0, valid, v_next > 0])
    m = elevation.ElevationMap(
        height=h, variance=torch.ones_like(h), valid=v,
        origin=torch.zeros(2, device=h.device), resolution=resolution,
    )
    f = elevation.features(m, slope_crit=slope_crit, rough_crit=rough_crit, step_crit=step_crit)
    return elevation.TerrainFeatures(*(a[HALO:-HALO] for a in f))


def features_sharded(m: elevation.ElevationMap, group, slope_crit: float = 0.6,
                     rough_crit: float = 0.15, step_crit: float = 0.3
                     ) -> elevation.TerrainFeatures:
    """Terrain features of the whole grid `m` (the same on every rank),
    computed as row blocks over the ranks of `group`: each rank takes
    its block (`mesh.block`) and runs `features_block` on it, and the
    blocks are all-gathered back into (H, W) layers on every rank. The
    rows must split into equal blocks of at least HALO rows."""
    n = mesh.size(group)
    H = m.height.shape[0]
    if H % n or H // n < HALO:
        raise ValueError(f"grid rows {H} must split into >= {HALO}-row blocks across {n} ranks")
    rows = mesh.block(H, n, mesh.rank(group))
    f = features_block(m.height[rows], m.valid[rows], m.resolution, group,
                       slope_crit=slope_crit, rough_crit=rough_crit, step_crit=step_crit)
    if group is None:
        return f
    layers = mesh.all_gather(torch.stack(list(f)), group)    # (n, 4, Hl, W)
    return elevation.TerrainFeatures(*layers.transpose(0, 1).flatten(1, 2))
