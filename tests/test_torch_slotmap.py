"""The port's grouped slot-map (dgraph_tpu_torch/ops/slotmap.py) against
the TPU kernel it replaces, ``slotmap_pallas`` in Pallas interpret mode,
and the numpy oracle ``slotmap_reference``, on the cases of
tests/test_pallas.py; and the port's scan/scatter chain ``_ov_slot_map``
against the reference's XLA one.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
itself is compared with that plain version on the card by
tests/test_torch_cuda.py and by chip_smoke.py.  Tolerance: none
(int32 chunk ids, byte-equal)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgraph_tpu.ops.pallas_slotmap import slotmap_pallas, slotmap_reference
from dgraph_tpu.ops.sets import _ov_slot_map as j_ov_slot_map
from dgraph_tpu_torch.ops import sets as tsets
from dgraph_tpu_torch.ops import slotmap as tslot
import torch_cases  # tests/torch_cases.py (pytest puts tests/ on the path)
from torch_pins import pinned_planner  # noqa: F401

pytestmark = [
    pytest.mark.pallas_interpret,
    pytest.mark.usefixtures("pinned_planner"),
]


def _grouped_case(rng, n_rows, pcap):
    """Random grouped-prefix inputs: strictly-ascending chunk starts for
    n_rows productive rows (cd >= 1), zero-padded to pcap."""
    cd = rng.integers(1, 6, size=n_rows).astype(np.int32)
    gaps = rng.integers(0, 3, size=n_rows).astype(np.int64)
    cs = np.zeros(n_rows, dtype=np.int32)
    nxt = 0
    for i in range(n_rows):
        nxt += int(gaps[i])
        cs[i] = nxt
        nxt += int(cd[i])
    csp = np.zeros(pcap, np.int32)
    cdp = np.zeros(pcap, np.int32)
    csp[:n_rows] = cs
    cdp[:n_rows] = cd
    return csp, cdp


def _random_batch(seed):
    rng = np.random.default_rng(seed)
    pcap, capc = 256, 512
    rows = [_grouped_case(rng, int(rng.integers(1, pcap // 2)), pcap)
            for _ in range(3)]
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]), capc


def _boundary(total_target):
    rng = np.random.default_rng(total_target)
    pcap, capc = 256, 512
    cs, cd = [], []
    nxt = total = 0
    while total < total_target:
        d = min(int(rng.integers(1, 5)), total_target - total)
        nxt += int(rng.integers(0, 2))
        cs.append(nxt)
        cd.append(d)
        nxt += d
        total += d
    csp = np.zeros((1, pcap), np.int32)
    cdp = np.zeros((1, pcap), np.int32)
    csp[0, : len(cs)] = cs
    cdp[0, : len(cd)] = cd
    return csp, cdp, capc


def _dense():
    pcap = 128
    return (np.arange(pcap, dtype=np.int32)[None],
            np.ones((1, pcap), np.int32), 256)


def _giant_row():
    cs = np.zeros((1, 128), np.int32)
    cd = np.zeros((1, 128), np.int32)
    cs[0, 0], cd[0, 0] = 17, 200
    return cs, cd, 256


def _empty_prefix():
    z = np.zeros((1, 128), np.int32)
    return z, z.copy(), 256


def _truncated():
    # total (several hundred chunks) > capc: every slot below capc valid
    cs, cd = _grouped_case(np.random.default_rng(21), 120, 128)
    return cs[None], cd[None], 128


def _ragged_batch():
    # narrower queries of a batch end in cd = 0 rows (hop 1's shape), one
    # query is all zero (an empty frontier)
    rng = np.random.default_rng(5)
    pcap = 256
    rows = [_grouped_case(rng, n, pcap) for n in (200, 17, 0, 90)]
    return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]), 384)


CASES = {
    **{f"random_seed{s}": (lambda s=s: _random_batch(s)) for s in (0, 1, 2)},
    **{f"total_{t}": (lambda t=t: _boundary(t))
       for t in (127, 128, 129, 255, 256, 257, 383)},
    "dense_identity": _dense,
    "giant_row": _giant_row,
    "empty_prefix": _empty_prefix,
    "truncated": _truncated,
    "ragged_batch": _ragged_batch,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slotmap_matches_pallas_and_oracle(case):
    cs, cd, capc = CASES[case]()
    pal = np.asarray(slotmap_pallas(jnp.asarray(cs), jnp.asarray(cd), capc,
                                    interpret=True))
    want = np.stack([slotmap_reference(cs[q], cd[q], capc)
                     for q in range(cs.shape[0])])
    assert np.array_equal(pal, want)
    tcs, tcd = torch.from_numpy(cs), torch.from_numpy(cd)
    plain = tslot.slotmap_plain(tcs, tcd, capc)
    n0 = tslot.KERNEL.launches
    got = tslot.slotmap(tcs, tcd, capc)
    assert tslot.KERNEL.launches == n0  # the CPU runs the plain version
    for out in (plain, got):
        assert out.dtype == torch.int32 and out.shape == (cs.shape[0], capc)
        assert out.numpy().tobytes() == pal.tobytes()


@pytest.mark.parametrize("case", torch_cases.SLOTMAP_CASES)
def test_plain_version_matches_the_oracle_on_the_kernel_tiles(case):
    """The inputs the card holds the kernel to its plain version on
    (pcap past several kernel tiles, a row owning more than capc, Q 1 and
    Q 20,000, totals on tile boundaries): the plain version against the
    numpy oracle."""
    cs, cd, capc = torch_cases.slotmap_case(case)
    want = np.stack([slotmap_reference(cs[q], cd[q], capc) for q in range(cs.shape[0])])
    got = tslot.slotmap(torch.from_numpy(cs), torch.from_numpy(cd), capc)
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("batched", [False, True])
def test_ov_slot_map_chain_matches_xla(batched):
    """The torch scan/scatter chain == the reference's XLA chain, chunk
    ids, ok mask, starts and productive mask alike (grouped inputs, a
    ragged tail of cd = 0 rows, and truncation at capc)."""
    rng = np.random.default_rng(17)
    pcap, capc = 128, 200
    cases = [_grouped_case(rng, n, pcap) for n in (50, 3, 0, 127)]
    cs = np.stack([c[0] for c in cases])
    cd = np.stack([c[1] for c in cases])
    f = jax.jit(lambda c, d: j_ov_slot_map(c, d, capc))
    if batched:
        want = jax.vmap(f)(jnp.asarray(cs), jnp.asarray(cd))
        got = tsets._ov_slot_map(torch.from_numpy(cs), torch.from_numpy(cd), capc)
        for w, g in zip(want, got):
            assert np.asarray(w).tobytes() == g.numpy().tobytes()
    else:
        for q in range(cs.shape[0]):
            want = f(jnp.asarray(cs[q]), jnp.asarray(cd[q]))
            got = tsets._ov_slot_map(torch.from_numpy(cs[q]),
                                     torch.from_numpy(cd[q]), capc)
            for w, g in zip(want, got):
                assert np.asarray(w).tobytes() == g.numpy().tobytes()


def test_chain_and_kernel_form_agree_on_grouped_inputs():
    """Where the grouped invariant holds, the chain's valid chunk ids are
    exactly the kernel's map (what lets the kernel take the chain's
    place in the grouped expansion)."""
    cs, cd, capc = _ragged_batch()
    chunkid, ok, _c, _p = tsets._ov_slot_map(torch.from_numpy(cs),
                                             torch.from_numpy(cd), capc)
    want = tslot.slotmap_plain(torch.from_numpy(cs), torch.from_numpy(cd), capc)
    assert torch.equal(torch.where(ok, chunkid, -1), want)


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "rank", "shape",
                                 "capc", "empty", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    cs = torch.zeros((2, 8), dtype=torch.int32)
    cd = torch.ones((2, 8), dtype=torch.int32)
    capc = 16
    if bad == "dtype":
        cd = cd.to(torch.int64)
    elif bad == "noncontig":
        cs = torch.zeros((8, 2), dtype=torch.int32).t()
    elif bad == "rank":
        cs, cd = cs[0], cd[0]
    elif bad == "shape":
        cd = torch.ones((2, 4), dtype=torch.int32)
    elif bad == "capc":
        capc = 0
    elif bad == "empty":
        cs, cd = cs[:0], cd[:0]
    elif bad == "device":
        cs, cd = cs.to("meta"), cd.to("meta")
    with pytest.raises(ValueError):
        tslot.slotmap(cs, cd, capc)

