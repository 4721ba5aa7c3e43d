"""The crossover model of the port (``dgraph_tpu_torch/parallel/
crossover.py``): the decision ``use_mesh_for`` asks it for on a mesh
of distinct cards, over the H100's constants (measured gather tiers, the measured on-card copy rate
and per-shard dispatch, NVLink from the data sheet).

The reference's cases (``tests/test_crossover.py``) are v5e answers.
Where the card's constants give another answer the case below says so;
those divergences are by design and listed in ROADMAP.md Queue 3:

- 20 GB is not forced on an 80 GB card (it is on a 16 GB v5e);
- a 16M-edge query does not pay for 8 shards (the port's host-driven
  dispatch, ~1 ms a shard, outweighs the gather it saves), so the
  tier-cliff flip and the speedup's growth with width show only at a
  billion-edge query;
- an 8 GB predicate stays on one card under the typical query (below
  40 % of 80 GB, and the dispatch dominates)."""

import pytest

from dgraph_tpu_torch.parallel import crossover as cx
from torch_pins import pinned_planner  # noqa: F401

pytestmark = pytest.mark.usefixtures("pinned_planner")

BILLION = 1 << 30


def test_gather_tiers_monotone():
    assert cx.GATHER_NS_L2 < cx.GATHER_NS_HBM < cx.GATHER_NS_HBM_FAR
    assert cx.gather_ns(1 << 20) == cx.GATHER_NS_L2
    assert cx.gather_ns(cx.L2_BYTES) == cx.GATHER_NS_L2
    assert cx.gather_ns(256 << 20) == cx.GATHER_NS_HBM
    assert cx.gather_ns(4 << 30) == cx.GATHER_NS_HBM_FAR


def test_small_arena_stays_single_chip():
    est = cx.estimate(10 << 20, frontier_rows=4096, out_edges=32_768, n_devices=8)
    assert not est.forced
    assert not est.shard_wins


def test_tier_cliff_flips_only_at_a_billion_edges():
    big = 2 * (256 << 20)
    # the reference's query size (16M edges): the dispatch outweighs the
    # tier the shards drop to
    est = cx.estimate(big, frontier_rows=1 << 20, out_edges=16 << 20, n_devices=8)
    assert not est.shard_wins
    # a billion-edge query pays for the shards
    est = cx.estimate(big, frontier_rows=1 << 20, out_edges=BILLION, n_devices=8)
    assert est.sharded_s < est.single_chip_s
    est_small = cx.estimate(big, frontier_rows=256, out_edges=2048, n_devices=8)
    assert not est_small.shard_wins


def test_forced_rule():
    # 20 GB fits an 80 GB card's budget: a choice, not forced
    assert not cx.estimate(20 << 30, 4096, 32_768, 8).forced
    # past 80% of the card's memory: sharding is not a choice
    est = cx.estimate(70 << 30, frontier_rows=4096, out_edges=32_768, n_devices=8)
    assert est.forced and est.shard_wins
    # should_shard's budget is 40% of the card: 33 GB must shard
    assert cx.should_shard(33 << 30, 500_000_000, 4.0, 8)


def test_speedup_grows_with_width_only_for_huge_queries():
    big = 4 * (256 << 20)
    s2 = cx.estimate(big, 1 << 20, 16 << 20, 2).speedup
    s8 = cx.estimate(big, 1 << 20, 16 << 20, 8).speedup
    assert s8 < s2 < 1.0
    s2 = cx.estimate(big, 1 << 20, BILLION, 2).speedup
    s8 = cx.estimate(big, 1 << 20, BILLION, 8).speedup
    assert 1.0 < s2 < s8


def test_should_shard_typical_cases():
    # an 8 GB predicate fits the card: the typical query stays local
    assert not cx.should_shard(8 << 30, 500_000_000, 4.0, 8)
    assert not cx.should_shard(1 << 20, 10_000, 4.0, 8)


def test_virtual_chips_never_pay_unless_forced():
    """Shards of one card run in turn and their exchange is a copy on
    the card: only the forced rule shards there."""
    est = cx.estimate(4 << 30, 1 << 20, BILLION, 8, distinct_cards=False)
    assert not est.shard_wins
    # the typical query (4096 rows, degree 4) at should_shard's 40% budget
    typical = dict(frontier_rows=4096, out_edges=4 * 4096, n_devices=4,
                   hbm_budget_frac=0.4, distinct_cards=False)
    assert not cx.estimate(8 << 30, **typical).shard_wins
    est = cx.estimate(33 << 30, **typical)
    assert est.forced and est.shard_wins


def test_exchange_uses_the_link_of_the_layout():
    a = cx.estimate(1 << 30, 0, BILLION, 4, distinct_cards=True)
    b = cx.estimate(1 << 30, 0, BILLION, 4, distinct_cards=False)
    payload = BILLION * 4.0 * 3 / 4
    dispatch = 4 * cx.MESH_SHARD_DISPATCH_S
    compute = (BILLION / 4) * cx.gather_ns(1 << 28) * 1e-9
    assert a.sharded_s == pytest.approx(
        compute + payload / cx.NVLINK_BYTES_PER_S + dispatch, rel=1e-12)
    assert b.sharded_s == pytest.approx(
        4 * compute + payload / cx.ON_CARD_COPY_BYTES_PER_S + dispatch,
        rel=1e-12)
