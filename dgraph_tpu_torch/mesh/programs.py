"""Mesh programs: multi-hop traversal with the exchange on the devices
(PyTorch port of ``dgraph_tpu/mesh/programs.py``).

The per-hop serving path (``parallel/mesh.py::sharded_expand_segments``)
pays a host round trip each level.  The program here is the mesh twin of
the single-device multi-hop pass (``ops.multi_hop``): a loop over hops
whose cross-chip frontier exchange — each shard's bucketed expansion
gathered on the root, the count reduction a sum there, the merged
frontier copied back to every shard — stays on the devices between
iterations.  The reference's ``lax.scan`` becomes that Python loop;
nothing in it waits on the host (fixed capacities, no ``.item()``, no
``torch.unique``), so a segment is one unsynchronized stream of work
that only the caller's fetch waits on.

Byte-parity contract: each hop's merged frontier is
``sort_unique(all_gather(per-shard expand_csr))[:cap]`` — the same
sorted-unique-padded set the unsharded pass produces, because the
shards partition the rows and the re-sort erases gather order.

The reference donates the carry so XLA threads one [cap] buffer through
every level; here each hop's frontier is a fresh [cap] tensor that the
next hop reads, and the previous one is freed when the caller drops it
(``final`` is the last hop's frontier itself, not a copy).
"""

from __future__ import annotations

import torch

from dgraph_tpu_torch import ops
from dgraph_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedArena,
    _on_chip,
    _to,
    all_gather,
    local_expand,
    psum,
)


def mesh_multi_hop_step(
    mesh: Mesh,
    sharded: ShardedArena,
    frontier: torch.Tensor,
    cap: int,
    n_hops: int,
):
    """``n_hops`` hops over the mesh from ``frontier`` (int32[cap]
    sorted-unique-padded, on the root device).

    Returns ``(frontiers int32[n_hops, cap], totals int32[n_hops],
    final int32[cap])`` on the root: per-level post-dedup frontiers and
    global edge counts, plus the final frontier (the carry of a next
    segment).  Every hop shares one capacity, planned by the caller from
    the worst level, like the unsharded multi-hop pass."""
    devs = mesh.model_devices()
    root = mesh.root
    f = frontier
    fs, totals = [], []
    for _ in range(n_hops):
        outs, ts = [], []
        for i, d in enumerate(devs):
            with _on_chip(mesh, i, d):
                # the rows this shard owns expand here; off-shard uids
                # expand to nothing here and to their targets on the owner
                out, _seg, t = local_expand(sharded, i, _to(f, d), cap)
                outs.append(out)
                ts.append(t)
        # the exchange: every shard's [cap] expansion gathered on the
        # root, the count reduction a sum, and the re-sort erases gather
        # order so placement cannot leak into results
        gathered = all_gather(outs, root)  # [n_model, cap]
        f = ops.sort_unique(gathered.reshape(-1))[:cap]
        fs.append(f)
        totals.append(psum(ts, root))
    return torch.stack(fs), torch.stack(totals), f


def exchange_bytes_per_hop(mesh: Mesh, cap: int) -> int:
    """The cross-chip payload one hop moves: each of the n chips' [cap]
    int32 expansion and int32 count reaches the root, and the merged
    [cap] frontier reaches each of the other chips.  A shape-accurate
    estimate for ledger attribution (the reference's convention: (n-1)
    chips' buffers per chip); on virtual chips of one card the copies
    are no-ops and the figure counts what distinct cards would move."""
    n = int(mesh.shape["model"])
    per_chip = (n - 1) * cap * 4 + (n - 1) * 4
    return n * per_chip
