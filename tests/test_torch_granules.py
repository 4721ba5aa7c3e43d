"""The 32-byte granule gather (``dgraph_tpu_torch/ops/granules.py``) on
the CPU, and the inline expansions that go through it.

- The plain version, and the wrapper on CPU tensors (which runs it and
  launches nothing), against numpy's clamped row gather plus the fill:
  negative indices, indices at and past N, empty indices, 1-D, 2-D and
  3-D indices.
- The wrapper's checks raise on what the kernel does not take.
- ``expand_inline_grouped_kernel``, ``expand_inline_seg`` and
  ``expand_chunked`` on CPU tensors return the same bytes as their
  torch-indexing forms before the granule gather (kept below as the
  oracle): rows < 0 now come back all-SENT from the metap gather (all 0
  from the meta8 gather), and the overflow gathers take the slot map's
  -1 as the fill.
- A row at or past the end of metap or meta8 raises on CPU tensors, as
  the index gather did: the granule gather alone would clamp it.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from dgraph_tpu_torch import ops as tops
from dgraph_tpu_torch.models import arena as tarena
from dgraph_tpu_torch.ops import granules, sets, slotmap

SENT = sets.SENT
CPU = torch.device("cpu")


def _want(table: np.ndarray, idx: np.ndarray, fill: int) -> np.ndarray:
    rows = table[np.clip(idx, 0, table.shape[0] - 1)]
    return np.where(idx[..., None] >= 0, rows, np.int32(fill)).astype(np.int32)


def _table(rng, n: int) -> np.ndarray:
    return rng.integers(-(1 << 31), 1 << 31, size=(n, 8)).astype(np.int32)


@pytest.mark.parametrize("shape", [(0,), (1,), (257,), (2, 0), (5, 33), (2, 3, 17)],
                         ids=["empty", "one", "1d", "2d_empty", "2d", "3d"])
@pytest.mark.parametrize("fill", [SENT, 0, -1])
def test_plain_version_matches_numpy(shape, fill):
    rng = np.random.default_rng(sum(shape) + fill % 97)
    n = 29
    table = _table(rng, n)
    idx = rng.integers(-4, n + 6, size=shape).astype(np.int32)
    if idx.size:  # the edges: -1, the last row, N and far past it
        flat = idx.reshape(-1)
        flat[: min(4, flat.size)] = [-1, n - 1, n, 1 << 30][: min(4, flat.size)]
    want = _want(table, idx, fill)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    got = granules.gather_granules_plain(t, i, fill)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape + (8,)
    assert got.numpy().tobytes() == want.tobytes()
    n0 = granules.KERNEL.launches
    via = granules.gather_granules(t, i, fill)
    assert granules.KERNEL.launches == n0
    assert torch.equal(via, got)


def test_a_single_row_table_clamps_every_index_to_it():
    table = torch.arange(8, dtype=torch.int32).reshape(1, 8)
    idx = torch.tensor([[0, 5], [-2, (1 << 31) - 1]], dtype=torch.int32)
    got = granules.gather_granules(table, idx, 7)
    assert got.tolist() == [[list(range(8))] * 2, [[7] * 8, list(range(8))]]


def _bad(kind):
    t = torch.zeros((4, 8), dtype=torch.int32)
    i = torch.zeros(3, dtype=torch.int32)
    return {
        "table_int64": (t.long(), i, 0),
        "table_width_4": (torch.zeros((4, 4), dtype=torch.int32), i, 0),
        "table_1d": (torch.zeros(32, dtype=torch.int32), i, 0),
        "table_strided": (torch.zeros((4, 16), dtype=torch.int32)[:, ::2], i, 0),
        "table_empty": (torch.zeros((0, 8), dtype=torch.int32), i, 0),
        "idx_int64": (t, i.long(), 0),
        "idx_strided": (t, torch.zeros(6, dtype=torch.int32)[::2], 0),
        "fill_past_int32": (t, i, 1 << 31),
        "fill_below_int32": (t, i, -(1 << 31) - 1),
    }[kind]


@pytest.mark.parametrize("kind", ["table_int64", "table_width_4", "table_1d",
                                  "table_strided", "table_empty", "idx_int64",
                                  "idx_strided", "fill_past_int32",
                                  "fill_below_int32"])
def test_checks_raise_on_what_the_kernel_does_not_take(kind):
    with pytest.raises(ValueError, match="gather_granules"):
        granules.gather_granules(*_bad(kind))


# -- the expansions before the granule gather, as the oracle --------------------


def _torch_inline_gather(metap, rows):
    valid = rows >= 0
    m = metap[torch.where(valid, rows, 0)]
    inline = torch.where(valid[..., None], m[..., 2:], SENT)
    dg = torch.where(valid, m[..., 1], 0)
    return m, valid, inline, dg, dg.sum(-1, dtype=torch.int32)


def _torch_ov_rows(ov_chunks, chunkid, ok):
    nc = ov_chunks.shape[0]
    ov = ov_chunks[torch.where(ok, chunkid, 0).clamp(0, nc - 1)]
    return torch.where(ok[..., None], ov, SENT)


def _torch_grouped_kernel(metap, ov_chunks, rows, capc, pcap):
    m, valid, inline, dg, total = _torch_inline_gather(metap, rows)
    cs, cd = sets._prefix_chunks(m, valid, dg, pcap)
    lead = cs.shape[:-1]
    cid = slotmap.slotmap(cs.reshape(-1, cs.shape[-1]).contiguous(),
                          cd.reshape(-1, cd.shape[-1]).contiguous(),
                          capc).reshape(lead + (capc,))
    return inline, _torch_ov_rows(ov_chunks, cid, cid >= 0), total


def _torch_seg(metap, ov_chunks, rows, capc):
    m, valid, inline, dg, total = _torch_inline_gather(metap, rows)
    cs, cd = sets._prefix_chunks(m, valid, dg, rows.shape[-1])
    cid = slotmap.slotmap(cs[None].contiguous(), cd[None].contiguous(), capc)[0]
    ok = cid >= 0
    ccum = torch.cumsum(cd, 0, dtype=torch.int32)
    ovseg = sets._ov_owner_map(ccum - cd, cd > 0, capc)
    return inline, _torch_ov_rows(ov_chunks, cid, ok), total, torch.where(ok, ovseg, -1)


def _torch_chunked(meta8, chunk_dst, rows, capc, with_seg):
    valid = rows >= 0
    m = meta8[torch.where(valid, rows, 0)]
    cs = torch.where(valid, m[:, 0], 0)
    cd = torch.where(valid, m[:, 1], 0)
    total = torch.where(valid, m[:, 2], 0).sum(dtype=torch.int32)
    chunkid, ok, cstart, productive = sets._ov_slot_map(cs, cd, capc)
    out = _torch_ov_rows(chunk_dst, chunkid, ok)
    if not with_seg:
        return out, total, None
    seg = sets._ov_owner_map(cstart, productive, capc)
    return out, total, torch.where(ok, seg, -1)


def _same(want, got):
    """Equal dtypes, shapes and bytes (the inline lanes are a view of
    the metap rows now, so their strides are not the oracle's)."""
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if w is None:
            assert g is None
            continue
        assert w.dtype == g.dtype and w.shape == g.shape
        assert w.contiguous().numpy().tobytes() == g.contiguous().numpy().tobytes()


def _arena(seed, n=700):
    """A dense arena with one celebrity source (uid 17) far past the
    inline heads, so rows carry 0 to hundreds of overflow chunks."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(1, n + 1, size=6000), np.full(2500, 17)])
    dst = rng.integers(1, n + 1, size=src.size)
    return tarena.csr_dense_from_edges(src, dst, n, CPU), rng, n


def _grouped_rows(a, rng, n, q):
    """q frontiers in skey order (rows with overflow chunks first), -1
    padded to one width, with their prefix and chunk capacities."""
    deg = a.h_offsets[1:] - a.h_offsets[:-1]
    fronts = []
    for _ in range(q):
        f = np.unique(rng.integers(1, n + 1, size=int(rng.integers(1, 150))))
        key = tops.skey_encode(f, deg[f] > tops.INLINE)
        fronts.append(f[np.argsort(key, kind="stable")])
    width = tops.bucket(max(len(f) for f in fronts))
    rows = np.stack([tops.pad_rows(f, width) for f in fronts])
    pcap = tops.bucket(max(1, max(int((deg[f] > tops.INLINE).sum()) for f in fronts)))
    need = max(int(a.ov_chunk_degree_of_rows(f).sum()) for f in fronts)
    return rows, pcap, need


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("q", [None, 1, 5], ids=["rows_1d", "q1", "q5"])
def test_grouped_kernel_expansion_is_byte_identical(seed, q):
    a, rng, n = _arena(seed)
    metap, ov = a.inline_layout_grouped()
    rows, pcap, need = _grouped_rows(a, rng, n, q or 1)
    if q is None:
        rows = rows[0]
    for capc in (tops.bucket(max(1, need)), max(1, need // 3)):  # whole, truncated
        r = torch.from_numpy(rows)
        want = _torch_grouped_kernel(metap, ov, r, capc, pcap)
        got = tops.expand_inline_grouped_kernel(metap, ov, r, capc, pcap)
        _same(want, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inline_seg_expansion_is_byte_identical(seed):
    a, rng, n = _arena(seed)
    metap, ov = a.inline_layout()
    for trial in range(6):
        f = np.unique(rng.integers(1, n + 1, size=int(rng.integers(1, 200))))
        if trial == 0:
            f = np.array([17])
        rows = np.insert(f, rng.integers(0, len(f) + 1, size=trial), -1)
        rows = tops.pad_rows(rows, tops.bucket(len(rows)))
        need = int(a.ov_chunk_degree_of_rows(f).sum())
        capc = tops.bucket(max(1, need)) if trial % 2 else max(1, need // 2)
        r = torch.from_numpy(rows)
        _same(_torch_seg(metap, ov, r, capc), tops.expand_inline_seg(metap, ov, r, capc))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_seg", [False, True])
def test_chunked_expansion_is_byte_identical(seed, with_seg):
    a, rng, n = _arena(seed)
    meta8, chunk_dst = a.chunked()
    for trial in range(6):
        f = np.unique(rng.integers(1, n + 1, size=int(rng.integers(1, 120))))
        rows = np.insert(f, rng.integers(0, len(f) + 1, size=trial), -1)
        rows = tops.pad_rows(rows, tops.bucket(len(rows)))
        need = int(a.chunk_degree_of_rows(f).sum())
        capc = tops.bucket(max(1, need)) if trial % 2 else max(1, need // 2)
        r = torch.from_numpy(rows)
        _same(_torch_chunked(meta8, chunk_dst, r, capc, with_seg),
              tops.expand_chunked(meta8, chunk_dst, r, capc, with_seg))


@pytest.mark.parametrize("past", [0, 1, 1000], ids=["at_end", "one_past", "far_past"])
def test_a_row_past_the_table_raises_on_cpu(past):
    a, rng, n = _arena(0)
    metap, ov = a.inline_layout_grouped()
    meta8, chunk_dst = a.chunked()
    for table, call in (
            (metap, lambda r: sets._inline_gather(metap, r)),
            (metap, lambda r: tops.expand_inline_seg(metap, ov, r, 64)),
            (meta8, lambda r: tops.expand_chunked(meta8, chunk_dst, r, 64))):
        rows = torch.tensor([3, -1, table.shape[0] + past, -1], dtype=torch.int32)
        with pytest.raises(IndexError, match="past the table"):
            call(rows)
        call(torch.tensor([3, -1, table.shape[0] - 1, -1], dtype=torch.int32))
