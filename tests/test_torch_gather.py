"""The port's resident gather (dgraph_tpu_torch/ops/gather.py) against
the TPU kernel it replaces, ``gather_pallas`` in Pallas interpret mode,
and against the numpy oracle ``gather_reference`` — over the real
ResidentArena slack-padded layout, on the cases of tests/test_pallas.py.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
itself is compared with that plain version on the card by the
``cuda``-marked tests below and in tests/test_torch_cuda.py, and by
chip_smoke.py, on the edge cases of tests/torch_cases.py too.  Tolerance:
none (int32 uids and row indices, byte-equal)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgraph_tpu import ops as jops
from dgraph_tpu.models.arena import ResidentArena, csr_dense_from_edges
from dgraph_tpu_torch.ops import gather as tgather
import torch_cases  # tests/torch_cases.py (pytest puts tests/ on the path)
from torch_pins import pinned_planner  # noqa: F401

pytestmark = [
    pytest.mark.pallas_interpret,
    pytest.mark.usefixtures("pinned_planner"),
]


def _seeded(src, dst, n):
    a = csr_dense_from_edges(np.asarray(src), np.asarray(dst), n)
    ra = ResidentArena.seed(a.h_offsets, a.host_dst(), a.n_rows, a.n_edges)
    return a, ra


def _random(seed, n, n_edges):
    rng = np.random.default_rng(seed)
    return rng, _seeded(rng.integers(1, n, size=n_edges),
                        rng.integers(1, n, size=n_edges), n)


def _check(a, ra, rows, cap):
    """Port packed output == concat(Pallas out, seg) == oracle."""
    rows = np.asarray(rows, dtype=np.int32)
    p_out, p_seg, _ = jops.gather_pallas(ra.off, ra.dst, jnp.asarray(rows),
                                         cap, interpret=True)
    w_out, w_seg, _ = jops.gather_reference(a.h_offsets, a.host_dst(), rows, cap)
    got = tgather.gather_packed(
        torch.from_numpy(np.array(ra.off)), torch.from_numpy(np.array(ra.dst)),
        torch.from_numpy(rows), cap,
    )
    assert got.dtype == torch.int32 and got.shape == (2 * cap,)
    got = got.numpy()
    assert got[:cap].tobytes() == np.asarray(p_out).tobytes()
    assert got[cap:].tobytes() == np.asarray(p_seg).tobytes()
    assert np.array_equal(got[:cap], w_out)
    assert np.array_equal(got[cap:], w_seg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_arena_matches_pallas_and_oracle(seed):
    rng, (a, ra) = _random(seed, 500, 6000)
    f = np.unique(rng.integers(0, a.n_rows, size=64)).astype(np.int64)
    rows = jops.pad_rows(f, jops.bucket(len(f)))
    cap = jops.bucket(int(np.sum(a.h_offsets[f + 1] - a.h_offsets[f])) or 1)
    _check(a, ra, rows, cap)


def test_empty_frontier():
    _, (a, ra) = _random(3, 100, 800)
    _check(a, ra, np.full(8, -1, dtype=np.int32), 128)


def test_padded_rows_interleaved():
    _, (a, ra) = _random(4, 300, 4000)
    rows = np.array([-1, 5, -1, 17, 42, -1, 99, -1], dtype=np.int32)
    _check(a, ra, rows, jops.bucket(int(np.sum(np.diff(a.h_offsets))) or 1))


def test_heavy_row_spans_many_tiles():
    heavy = np.full(300, 7, dtype=np.int64)
    light = np.array([9, 9, 9], dtype=np.int64)
    src = np.concatenate([heavy, light])
    a, ra = _seeded(src, np.arange(1, len(src) + 1, dtype=np.int64), 16)
    rows = jops.pad_rows(
        np.array([np.searchsorted(a.h_src, 7), np.searchsorted(a.h_src, 9)]), 8
    )
    _check(a, ra, rows, jops.bucket(303))


def test_truncates_at_cap():
    _, (a, ra) = _random(5, 200, 3000)
    rows = jops.pad_rows(np.arange(0, min(a.n_rows, 64)), 64)
    _check(a, ra, rows, 128)


def test_packed_layout_is_out_then_seg():
    rng, (a, ra) = _random(6, 200, 2500)
    f = np.unique(rng.integers(0, a.n_rows, size=32)).astype(np.int64)
    rows = jops.pad_rows(f, 32)
    packed = np.asarray(jops.gather_pallas_packed(
        ra.off, ra.dst, jnp.asarray(rows), 4096, interpret=True))
    got = tgather.gather_packed(
        torch.from_numpy(np.array(ra.off)), torch.from_numpy(np.array(ra.dst)),
        torch.from_numpy(rows), 4096,
    ).numpy()
    assert got.tobytes() == packed.tobytes()


def test_plain_version_counts_no_launch():
    _, (a, ra) = _random(7, 50, 300)
    before = tgather.KERNEL.launches
    _check(a, ra, jops.pad_rows(np.arange(8), 8), 64)
    assert tgather.KERNEL.launches == before


@pytest.mark.parametrize("name", torch_cases.GATHER_CASES)
def test_kernel_edge_cases_match_pallas_and_oracle(name):
    """The inputs the card holds the kernel to its plain version on (B 1,
    B ragged, B 2^20, total == cap, cap inside a row, tiles starting inside
    a long row, a 10^6-edge row, long runs of rows that own no slot, an
    all-skip frontier): the plain version against the numpy oracle, and
    against ``gather_pallas_packed`` in interpret mode where its grid of
    one step per row is short enough for a CPU (not at B 2^20)."""
    off, dst, rows, cap = torch_cases.gather_case(name)
    got = tgather.gather_packed(torch.from_numpy(off), torch.from_numpy(dst),
                                torch.from_numpy(rows), cap)
    assert got.dtype == torch.int32 and got.shape == (2 * cap,)
    got = got.numpy()
    w_out, w_seg, _ = jops.gather_reference(off, dst, rows, cap)
    assert np.array_equal(got[:cap], w_out)
    assert np.array_equal(got[cap:], w_seg)
    if len(rows) <= torch_cases.GATHER_INTERPRET_MAX_B:
        packed = jops.gather_pallas_packed(jnp.asarray(off), jnp.asarray(dst),
                                           jnp.asarray(rows), cap, interpret=True)
        assert got.tobytes() == np.asarray(packed).tobytes()


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "cap", "empty_rows", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    off = torch.tensor([0, 2, 3], dtype=torch.int32)
    dst = torch.tensor([4, 5, 6, 0], dtype=torch.int32)
    rows = torch.tensor([0, 1], dtype=torch.int32)
    cap = 8
    if bad == "dtype":
        rows = rows.to(torch.int64)
    elif bad == "noncontig":
        dst = torch.arange(8, dtype=torch.int32)[::2]
    elif bad == "cap":
        cap = 0
    elif bad == "empty_rows":
        rows = rows[:0]
    elif bad == "device":
        dst = dst.to("meta")
    with pytest.raises(ValueError):
        tgather.gather_packed(off, dst, rows, cap)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_on_the_card():
    """Runs where a CUDA GPU and nvcc exist (chip_smoke.py covers the
    main path's shapes there too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the gather kernel has no CPU mode")
    rng, (a, ra) = _random(8, 5000, 60000)
    f = np.unique(rng.integers(0, a.n_rows, size=1024)).astype(np.int64)
    rows = torch.from_numpy(jops.pad_rows(f, jops.bucket(len(f))))
    off = torch.from_numpy(np.array(ra.off))
    dst = torch.from_numpy(np.array(ra.dst))
    for cap in (jops.bucket(int(np.sum(a.h_offsets[f + 1] - a.h_offsets[f]))), 256):
        want = tgather.gather_packed_plain(off, dst, rows, cap)
        n0 = tgather.KERNEL.launches
        got = tgather.gather_packed(off.cuda(), dst.cuda(), rows.cuda(), cap)
        torch.cuda.synchronize()
        assert tgather.KERNEL.launches == n0 + 1
        assert torch.equal(got.cpu(), want)
