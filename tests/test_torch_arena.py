"""The port's arenas (dgraph_tpu_torch/models/arena.py) against the
reference's: the resident layout a seed uploads, and the device-side
delta merge (``_resident_merge``) over random add/del batches, including
the reseed branch (new source rows, or growth past the slack).

Tolerance: none (int32 offsets and uids, byte-equal)."""

import numpy as np
import pytest
import torch

from dgraph_tpu.models import arena as jarena
from dgraph_tpu_torch.models import arena as tarena
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")


def _pair(seed, n=300, n_edges=3000):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n, size=n_edges)
    dst = rng.integers(1, 4 * n, size=n_edges)
    ja = jarena.csr_from_edges(src, dst)
    ta = tarena.csr_from_edges(src, dst, torch.device("cpu"))
    return rng, ja, ta


def _same_resident(ja, ta):
    jr, tr = ja.resident(), ta.resident()
    assert np.asarray(jr.off).tobytes() == tr.off.numpy().tobytes()
    assert np.asarray(jr.dst).tobytes() == tr.dst.numpy().tobytes()
    assert jr.n_edges == tr.n_edges
    assert jr.device_bytes() == tr.device_bytes()


def _same_host(ja, ta):
    assert np.array_equal(ja.h_src, ta.h_src)
    assert np.array_equal(ja.h_offsets, ta.h_offsets)
    assert np.array_equal(ja.host_dst(), ta.host_dst())
    assert ja.n_rows == ta.n_rows and ja.n_edges == ta.n_edges


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seed_layout_matches_reference(seed):
    _, ja, ta = _pair(seed)
    _same_host(ja, ta)
    assert np.asarray(ja.offsets).tobytes() == ta.offsets.numpy().tobytes()
    assert np.asarray(ja.dst).tobytes() == ta.dst.numpy().tobytes()
    assert np.asarray(ja.src).tobytes() == ta.src.numpy().tobytes()
    _same_resident(ja, ta)
    assert ja.device_bytes() == ta.device_bytes()
    assert tarena._resident_cap(ta.n_edges) == jarena._resident_cap(ja.n_edges)


def _delta(rng, a, n_add, n_del, new_src=False):
    """(adds, dels) honouring the journal contract: adds absent, dels
    present, no key in both."""
    rows = np.repeat(a.h_src, np.diff(a.h_offsets))
    live = set(zip(rows.tolist(), a.host_dst().tolist()))
    pool = sorted(live)
    dels = [pool[i] for i in rng.choice(len(pool), size=n_del, replace=False)]
    adds = set()
    lo = int(a.h_src.max()) + 1 if new_src else 1
    while len(adds) < n_add:
        s = int(rng.integers(lo, lo + 50)) if new_src else int(
            a.h_src[rng.integers(0, a.n_rows)])
        e = (s, int(rng.integers(1, 2000)))
        if e not in live:
            adds.add(e)
    as_arr = lambda x: np.array(sorted(x), dtype=np.int64).reshape(-1, 2)
    return as_arr(adds), as_arr(dels)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_matches_reference_over_random_deltas(seed):
    rng, ja, ta = _pair(seed)
    ja.resident()
    ta.resident()
    for step in range(6):
        ra0 = ta._resident
        adds, dels = _delta(rng, ta, int(rng.integers(0, 40)),
                            int(rng.integers(0, 40)))
        ja.apply_delta(adds, dels)
        ta.apply_delta(adds, dels)
        assert ta._resident is ra0, "a merge must not reseed"
        assert ta.epoch == ja.epoch
        _same_host(ja, ta)
        _same_resident(ja, ta)


def test_reseed_on_new_source_rows():
    rng, ja, ta = _pair(11)
    ja.resident()
    ra0 = ta.resident()
    adds, dels = _delta(rng, ta, 10, 5, new_src=True)
    ja.apply_delta(adds, dels)
    ta.apply_delta(adds, dels)
    assert ta._resident is not ra0
    assert ta._resident._prev[0] is ra0.off  # old epoch kept as shadow
    _same_host(ja, ta)
    _same_resident(ja, ta)


def test_reseed_when_slack_would_be_breached():
    rng, ja, ta = _pair(12, n=100, n_edges=400)
    ja.resident()
    ra0 = ta.resident()
    room = ra0.ecap - ra0.n_edges - 128
    adds, _ = _delta(rng, ta, room + 1, 0)
    ja.apply_delta(adds, np.zeros((0, 2), np.int64))
    ta.apply_delta(adds, np.zeros((0, 2), np.int64))
    assert ta._resident is not ra0
    _same_resident(ja, ta)


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_kernel_direct(seed):
    """_resident_merge itself on padded delta pairs, against the JAX
    program on the same buffers."""
    import jax.numpy as jnp

    rng, ja, ta = _pair(seed + 20)
    jr = ja.resident()
    adds, dels = _delta(rng, ta, 17, 9)
    rows = lambda arr: np.searchsorted(ta.h_src, arr[:, 0]).astype(np.int32)
    pads = [
        tarena.ops.pad_to(x, tarena.ops.bucket(max(1, len(x))))
        for x in (rows(adds), adds[:, 1].astype(np.int32),
                  rows(dels), dels[:, 1].astype(np.int32))
    ]
    j_off, j_dst = jarena._resident_merge(
        jr.off, jr.dst, *[jnp.asarray(p) for p in pads])
    t_off, t_dst = tarena._resident_merge(
        torch.from_numpy(np.array(jr.off)), torch.from_numpy(np.array(jr.dst)),
        *[torch.from_numpy(p) for p in pads])
    assert t_off.dtype == torch.int32 and t_dst.dtype == torch.int32
    assert np.asarray(j_off).tobytes() == t_off.numpy().tobytes()
    assert np.asarray(j_dst).tobytes() == t_dst.numpy().tobytes()
