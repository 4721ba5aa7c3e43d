"""The port's set ops (dgraph_tpu_torch/ops/sets.py) against the JAX
kernels of dgraph_tpu.ops, on the random grids of tests/test_ops.py.

Tolerance: none.  Outputs are int32 uid vectors, padding included, and
must be byte-equal to the reference's (docs/sets-contract.md)."""

import numpy as np
import pytest
import torch

from dgraph_tpu import ops as jops
from dgraph_tpu_torch import ops as tops

SEEDS = [0, 1, 2]


def rand_set(rng, max_len=64, max_val=200):
    n = rng.integers(0, max_len + 1)
    return np.unique(rng.integers(0, max_val, size=n)).astype(np.int32)


def same(j, t):
    """Byte-equality of a JAX result and a torch result."""
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    assert j.shape == t.shape, (j.shape, t.shape)
    assert j.tobytes() == t.tobytes()


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_scalars_and_host_helpers_match():
    assert tops.SENT == jops.SENT
    for n in (0, 1, 7, 8, 9, 1000, 262144, 262145):
        assert tops.bucket(n) == jops.bucket(n)
    x = np.array([5, 3, 9], dtype=np.int64)
    assert np.array_equal(tops.pad_to(x, 8), jops.pad_to(x, 8))
    assert np.array_equal(tops.pad_rows(x, 8), jops.pad_rows(x, 8))
    assert tops.pad_rows(x, 8).dtype == np.int32


@pytest.mark.parametrize("seed", SEEDS)
def test_sort_unique_and_count_valid(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(0, 50))
        raw = rng.integers(0, 60, size=n).astype(np.int32)
        p = jops.pad_to(raw, jops.bucket(max(1, n)))
        same(jops.sort_unique(p), tops.sort_unique(T(p)))
        same(jops.count_valid(p), tops.count_valid(T(p)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("op", ["intersect", "difference", "union", "member_mask"])
def test_binary_ops(seed, op):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        a, b = rand_set(rng), rand_set(rng)
        cap = jops.bucket(max(1, len(a), len(b)))
        pa, pb = jops.pad_to(a, cap), jops.pad_to(b, cap)
        same(getattr(jops, op)(pa, pb), getattr(tops, op)(T(pa), T(pb)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("op", ["intersect_many", "union_many"])
def test_kway_ops(seed, op):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        k = int(rng.integers(1, 9))
        lists = [rand_set(rng, max_val=80) for _ in range(k)]
        cap = jops.bucket(max(1, max(len(l) for l in lists)))
        mat = np.stack([jops.pad_to(l, cap) for l in lists])
        same(getattr(jops, op)(mat), getattr(tops, op)(T(mat)))


@pytest.mark.parametrize("seed", SEEDS)
def test_rows_of(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        src = rand_set(rng, max_val=100)
        if not len(src):
            continue
        srcp = jops.pad_to(src, jops.bucket(len(src)))
        uids = jops.pad_to(rand_set(rng, max_val=120), 64)
        same(jops.rows_of(srcp, uids), tops.rows_of(T(srcp), T(uids)))


def make_csr(rng, nrows=10, max_deg=8, max_val=100):
    lists = [np.sort(rng.choice(max_val, size=rng.integers(0, max_deg), replace=False)).astype(np.int32)
             for _ in range(nrows)]
    offsets = np.zeros(nrows + 1, dtype=np.int32)
    offsets[1:] = np.cumsum([len(l) for l in lists])
    dst = np.concatenate(lists).astype(np.int32)
    return offsets, dst


@pytest.mark.parametrize("seed", SEEDS)
def test_expand_csr(seed):
    rng = np.random.default_rng(seed)
    for _ in range(15):
        offsets, dst = make_csr(rng)
        b = int(rng.integers(1, 6))
        rows = rng.integers(-1, len(offsets) - 1, size=b).astype(np.int32)
        deg = np.where(rows >= 0, offsets[rows + 1] - offsets[rows], 0)
        # exact, rounded-up and truncating capacities
        for cap in {jops.bucket(max(1, int(deg.sum()))), 8}:
            jo, js, jt = jops.expand_csr(offsets, dst, rows, cap)
            to, ts, tt = tops.expand_csr(T(offsets), T(dst), T(rows), cap)
            same(jo, to)
            same(js, ts)
            same(jt, tt)


def test_expand_csr_edgeless_arena():
    off = np.zeros(9, np.int32)
    dst = np.zeros(0, np.int32)
    rows = np.array([0, 3, -1], np.int32)
    jo, js, jt = jops.expand_csr(off, dst, rows, 16)
    to, ts, tt = tops.expand_csr(T(off), T(dst), T(rows), 16)
    same(jo, to)
    same(js, ts)
    same(jt, tt)
