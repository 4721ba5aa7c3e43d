"""The port's k-way intersection (dgraph_tpu_torch/ops/kway.py) against
the TPU kernel it replaces, ``intersect_pallas`` in Pallas interpret
mode, the XLA tree ``intersect_many``, the pure oracle
``intersect_reference`` and the reference's
``spgemm.intersect_stack(_batch)``, the device route of its
``kway_intersect``.

Inputs are sorted-unique, SENT-padded int32 rows made with numpy from a
seed.  On the CPU the wrappers run the kernel's plain version; the CUDA
kernel itself is compared with that plain version on the card by
tests/test_torch_cuda.py and by chip_smoke.py.  Tolerance: none (int32
uids, byte-equal)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgraph_tpu import ops as jops
from dgraph_tpu_torch import ops as tops
from dgraph_tpu_torch.ops.kway import (
    KERNEL, KMAX, intersect_batch, intersect_kernel, intersect_plain,
)
import torch_cases  # tests/torch_cases.py (pytest puts tests/ on the path)
from torch_pins import pinned_planner  # noqa: F401

pytestmark = [
    pytest.mark.pallas_interpret,
    pytest.mark.usefixtures("pinned_planner"),
]

SENT = tops.SENT


def _sets(rng, k, L, universe):
    """k sorted-unique sets of 1..L uids drawn from [0, universe),
    SENT-padded to L."""
    rows = []
    for _ in range(k):
        m = int(rng.integers(1, L + 1))
        s = np.unique(rng.integers(0, universe, size=m)).astype(np.int32)
        rows.append(jops.pad_to(s, L))
    return np.stack([np.asarray(r) for r in rows])


def _case(name, k, L):
    rng = np.random.default_rng(1000 * k + L)
    if name == "random":
        # a universe a little wider than L: most rows overlap, some not
        return _sets(rng, k, L, max(8, L + L // 4))
    mat = _sets(rng, k, L, max(8, L // 2))
    if name == "empty_row":  # one row with no valid entry annihilates
        mat[k - 1, :] = SENT
    elif name == "all_sent":  # nothing to probe at all
        mat[:, :] = SENT
    elif name == "all_sent_row0":
        mat[0, :] = SENT
    elif name == "identical_rows":
        mat[:] = mat[0]
    return mat


def _torch_outputs(mat):
    """Every port entry on the same [K, L] input, with the launch count
    checked: on the CPU the kernel never launches."""
    t = torch.from_numpy(mat)
    n0 = KERNEL.launches
    outs = [intersect_plain(t), intersect_batch(t.unsqueeze(0))[0]]
    if mat.shape[0] <= KMAX:
        outs.append(intersect_kernel(t))
    assert KERNEL.launches == n0
    return outs


CASES = (
    [("random", k, L) for k in (1, 2, 3, 4, 8) for L in (8, 128, 1000, 8192)]
    + [(n, k, 128) for n in ("empty_row", "all_sent", "all_sent_row0",
                              "identical_rows") for k in (2, 8)]
)


@pytest.mark.parametrize("name,k,L", CASES)
def test_intersect_matches_pallas_xla_and_oracle(name, k, L):
    mat = _case(name, k, L)
    pal = np.asarray(jops.intersect_pallas(jnp.asarray(mat), interpret=True))
    xla = np.asarray(jops.intersect_many(jnp.asarray(mat)))
    want = jops.intersect_reference(mat)
    assert np.array_equal(pal, xla)
    valid = pal[pal != SENT]
    assert valid.tolist() == list(want)
    assert (pal[len(valid):] == SENT).all()
    if name == "identical_rows":
        assert valid.tolist() == mat[0][mat[0] != SENT].tolist()
    for out in _torch_outputs(mat):
        assert out.dtype == torch.int32 and out.shape == (L,)
        assert out.numpy().tobytes() == pal.tobytes()


@pytest.mark.parametrize("k", [1, 2, 5, 9, 16])
def test_intersect_stack_matches_the_reference(k):
    """spgemm.intersect_stack has no K limit (kway_intersect sends up to
    16 sets); the port's ``intersect_batch`` goes past KMAX the same
    way."""
    rng = np.random.default_rng(k)
    mat = _sets(rng, k, 512, 300)
    want = np.asarray(jops.intersect_stack(jnp.asarray(mat)))
    got = intersect_batch(torch.from_numpy(mat)[None])[0]
    assert got.numpy().tobytes() == want.tobytes()
    assert got.numpy().tobytes() == intersect_plain(torch.from_numpy(mat)).numpy().tobytes()


@pytest.mark.parametrize("k", [1, 3, 16])
def test_intersect_stack_batch_matches_the_reference(k):
    rng = np.random.default_rng(100 + k)
    mat = np.stack([_sets(rng, k, 256, 200) for _ in range(5)])
    mat[2, k - 1] = SENT  # an empty member in one batch row
    want = np.asarray(jops.intersect_stack_batch(jnp.asarray(mat)))
    got = intersect_batch(torch.from_numpy(mat))
    assert got.shape == (5, 256)
    assert got.numpy().tobytes() == want.tobytes()
    assert (got[2] == SENT).all()


@pytest.mark.parametrize("case", ["all_sent_65536", "B70000"])
def test_intersect_batch_takes_any_b(case):
    """B above the 65,535 a grid's y axis holds: the reference's
    ``intersect_stack_batch`` (a vmap) takes any B, and so does the port,
    the plain version here and the kernel on the card."""
    if case == "all_sent_65536":
        mat = np.full((65536, 2, 8), SENT, np.int32)
    else:
        mat = torch_cases.intersect_case(case)
    want = np.asarray(jops.intersect_stack_batch(jnp.asarray(mat)))
    got = intersect_batch(torch.from_numpy(mat))
    assert got.shape == (mat.shape[0], mat.shape[2])
    assert got.numpy().tobytes() == want.tobytes()
    if case == "all_sent_65536":
        assert (want == SENT).all()
    else:
        assert (want != SENT).any()


@pytest.mark.parametrize("case", torch_cases.INTERSECT_CASES)
def test_plain_version_matches_the_oracle_on_the_kernel_tiles(case):
    """The inputs the card holds the kernel to its plain version on
    (every lane surviving, survivors only in the last tile, a dense row,
    thin survivors at L 2^21, B 1024): the plain version against an
    np.intersect1d fold."""
    mat = torch_cases.intersect_case(case)
    got = intersect_batch(torch.from_numpy(mat)).numpy()
    assert got.shape == (mat.shape[0], mat.shape[2])
    for g, fold in zip(got, torch_cases.intersect_fold(mat)):
        assert np.array_equal(g[: len(fold)], fold)
        assert (g[len(fold):] == SENT).all()


@pytest.mark.parametrize("bad", ["dtype", "dim", "noncontig", "batch",
                                 "empty", "kmax", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    mat = torch.zeros((2, 3, 16), dtype=torch.int32)
    fn = intersect_batch
    if bad == "dtype":
        mat = mat.to(torch.int64)
    elif bad == "dim":
        mat = mat[0]
    elif bad == "noncontig":
        mat = torch.zeros((2, 16, 3), dtype=torch.int32).transpose(1, 2)
    elif bad == "batch":
        mat = mat[:0]
    elif bad == "empty":
        mat = mat[:, :0]
    elif bad == "kmax":
        mat = torch.zeros((KMAX + 1, 16), dtype=torch.int32)
        fn = intersect_kernel
    elif bad == "device":
        mat = mat.to("meta")
    with pytest.raises(ValueError):
        fn(mat)
