"""The port's storage plane (``dgraph_tpu_torch.models.wal`` /
``models/durability.py`` / ``utils/atomicio.py`` and the server's
storage wiring): the 24 cases of tests/test_durability.py, run on the
port's modules, the server on ``device="cpu"``.

- atomic_write_file: all-or-nothing replacement, failpoint crash windows
- group commit: leader/follower fsync sharing, ack-after-barrier durability
- seal/compact: two-phase snapshotting, double-replay fixpoint (the
  install-then-crash-before-delete window), bounded-WAL recovery
- corrupt-snapshot boot policy: quarantine + actionable refusal, restore path
- disk-fault read-only mode: latch, shed, probe re-arm, torn-tail hygiene
- Snapshotter: thresholds, explicit trigger, fault behavior
- the serving surface: mutations 503 + Retry-After while reads keep
  answering, /health?detail=1 storage section, /admin/snapshot,
  sustained-write WAL boundedness end to end
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from dgraph_tpu_torch.models import codec
from dgraph_tpu_torch.models.durability import (
    ReadOnlyError,
    SnapshotCorruptError,
    Snapshotter,
    StorageFaultError,
    StorageHealth,
)
from dgraph_tpu_torch.models.store import Edge
from dgraph_tpu_torch.models.types import TypeID, TypedValue
from dgraph_tpu_torch.models.wal import DurableStore, Wal, replay_records
from dgraph_tpu_torch.utils.atomicio import atomic_write_file
from dgraph_tpu_torch.utils.failpoints import FailpointError, fail
from dgraph_tpu_torch.utils.metrics import (
    GROUP_COMMIT_SYNCS,
    GROUP_COMMIT_WRITES,
    SNAPSHOTS,
)
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")


def _nb(store, pred, uid):
    """The sorted neighbours of ``uid`` under ``pred``."""
    p = store.peek(pred)
    return [] if p is None else sorted(p.edges.get(uid, ()))


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fail.reset()
    yield
    fail.reset()


# ---------------------------------------------------------------- atomicio

def test_atomic_write_file_bytes_and_chunks(tmp_path):
    p = str(tmp_path / "f.bin")
    atomic_write_file(p, b"hello")
    assert open(p, "rb").read() == b"hello"
    atomic_write_file(p, (c for c in [b"a", b"bc", b"def"]))
    assert open(p, "rb").read() == b"abcdef"
    assert not os.path.exists(p + ".tmp")


def test_atomic_write_file_failure_keeps_old_content(tmp_path):
    """An injected fault in either crash window (mid-tmp, pre-replace)
    leaves the target byte-identical to the old content."""
    p = str(tmp_path / "f.bin")
    atomic_write_file(p, b"old", site="t.site")
    for window in ("t.site.tmp", "t.site.replace"):
        fail.arm(window, "error(n=1)")
        with pytest.raises(OSError):
            atomic_write_file(p, b"NEW", site="t.site")
        assert open(p, "rb").read() == b"old", window


# ------------------------------------------------------------- group commit

def _edge(i: int, pred: str = "p") -> Edge:
    return Edge(pred=pred, src=i, dst=i + 1)


def test_group_commit_follower_skips_fsync(tmp_path):
    """sync_upto is leader/follower: a barrier whose seq a previous
    fsync already covered returns WITHOUT touching the disk."""
    w = Wal(str(tmp_path / "w.log"), sync=True)
    w.group_commit = True
    w.append(codec.encode_edge(_edge(1)))
    w.flush()  # group-commit mode: pushes to OS, does NOT fsync
    writes0, syncs0 = GROUP_COMMIT_WRITES.value(), GROUP_COMMIT_SYNCS.value()
    seq = w._seq
    w.sync_upto(seq)          # leader: one fsync
    w.sync_upto(seq)          # follower-after-the-fact: covered, no fsync
    assert GROUP_COMMIT_WRITES.value() - writes0 == 2
    assert GROUP_COMMIT_SYNCS.value() - syncs0 == 1
    w.close()


def test_group_commit_concurrent_writers_all_durable(tmp_path):
    """8 writer threads × apply-then-barrier under group commit: every
    acknowledged (post-barrier) record replays after reopen, and the
    shared fsync amortizes (syncs <= writes)."""
    s = DurableStore(str(tmp_path / "s"), sync_writes=True)
    s.enable_group_commit()
    lock = threading.Lock()  # the serving layer's write-lock analog
    writes0, syncs0 = GROUP_COMMIT_WRITES.value(), GROUP_COMMIT_SYNCS.value()
    acked = []

    def writer(base):
        for i in range(base, base + 8):
            with lock:
                s.apply(_edge(i * 2))
            s.sync_barrier()  # OUTSIDE the exclusive section
            acked.append(i * 2)

    ts = [
        threading.Thread(target=writer, args=(1 + 100 * c,))
        for c in range(8)
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    dw = GROUP_COMMIT_WRITES.value() - writes0
    ds = GROUP_COMMIT_SYNCS.value() - syncs0
    assert dw == 64 and 1 <= ds <= dw
    # reopen WITHOUT close (close would fsync anyway): the barrier alone
    # must have made every acked record reachable by replay
    got = list(replay_records(s.wal_path, truncate_torn=False))
    srcs = {codec.decode_edge(p).src for p in got}
    assert set(acked) <= srcs
    s.close()


def test_group_commit_off_without_sync(tmp_path):
    s = DurableStore(str(tmp_path / "s"))  # sync_writes=False
    s.enable_group_commit()
    assert not s._group_commit  # opt-in is meaningless without --sync
    s.sync_barrier()  # no-op, must not raise
    s.close()


# ------------------------------------------------------------- seal/compact

def test_seal_then_recover_replays_segment(tmp_path):
    s = DurableStore(str(tmp_path / "s"))
    s.apply(_edge(1))
    seg = s.seal_segment()
    assert seg and os.path.exists(seg)
    s.apply(_edge(10))  # lands in the fresh active WAL
    s.close()
    r = DurableStore(str(tmp_path / "s"))
    assert _nb(r, "p", 1) == [2] and _nb(r, "p", 10) == [11]
    assert r.recovery["segment_records"] == 1
    assert r.recovery["wal_records"] == 1
    r.close()


def test_seal_empty_wal_returns_none(tmp_path):
    s = DurableStore(str(tmp_path / "s"))
    assert s.seal_segment() is None
    s.close()


def test_compact_folds_and_deletes_segments(tmp_path):
    s = DurableStore(str(tmp_path / "s"))
    for i in range(1, 9):
        s.apply(_edge(i * 3))
    snaps0 = SNAPSHOTS.value()
    s.seal_segment()
    s.compact()
    assert SNAPSHOTS.value() - snaps0 == 1
    assert s._list_segments() == []
    assert os.path.getsize(s.wal_path) == 0
    s.close()
    r = DurableStore(str(tmp_path / "s"))
    assert r.recovery["snapshot_records"] >= 8
    assert r.recovery["segment_records"] == 0
    assert r.recovery["wal_records"] == 0
    for i in range(1, 9):
        assert _nb(r, "p", i * 3) == [i * 3 + 1]
    r.close()


def test_compact_double_replay_is_fixpoint(tmp_path):
    """The install-then-crash-before-delete window: a segment already
    folded into the snapshot replays AGAIN on the next boot.  Every
    record type is last-writer-wins or idempotent, so state must be
    byte-identical to the clean recovery."""
    import shutil

    s = DurableStore(str(tmp_path / "s"))
    s.apply_schema("name: string .")
    u = s.uids.assign("alice")
    s.apply(_edge(1))
    s.apply(Edge(pred="p", src=1, dst=2, op="del"))
    s.apply(_edge(5))
    s.apply(Edge(pred="name", src=u, value=TypedValue(TypeID.STRING, "A")))
    seg = s.seal_segment()
    shutil.copy(seg, str(tmp_path / "resurrected.seg"))
    s.compact()
    s.close()
    # crash window: snapshot installed, segment delete never happened
    shutil.copy(str(tmp_path / "resurrected.seg"), seg)
    r = DurableStore(str(tmp_path / "s"))
    assert _nb(r, "p", 1) == []       # the del wins twice over
    assert _nb(r, "p", 5) == [6]
    assert r.uids.lookup("alice") == u
    assert r.value("name", u).value == "A"
    r.close()


def test_seal_concurrent_with_group_commit_barriers(tmp_path):
    """A seal (segment swap) racing sync_barrier callers must never
    drop a record: barriers hold the same _sync_lock the seal takes."""
    s = DurableStore(str(tmp_path / "s"), sync_writes=True)
    s.enable_group_commit()
    lock = threading.Lock()
    stop = threading.Event()
    errors = []

    def writer(base):
        try:
            for i in range(base, base + 30):
                with lock:
                    s.apply(_edge(i))
                s.sync_barrier()
        except Exception as e:  # noqa: BLE001 — surfaced via errors list
            errors.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=writer, args=(1000,))
    t.start()
    while not stop.is_set():
        with lock:  # the snapshotter's exclusive-seal discipline
            s.seal_segment()
        s.compact()
    t.join()
    assert not errors
    s.close()
    r = DurableStore(str(tmp_path / "s"))
    for i in range(1000, 1030):
        assert _nb(r, "p", i) == [i + 1], i
    r.close()


# ------------------------------------------------------- corrupt snapshot

def test_corrupt_snapshot_quarantined_with_actionable_error(tmp_path):
    s = DurableStore(str(tmp_path / "s"))
    for i in range(1, 6):
        s.apply(_edge(i * 7))
    s.snapshot()
    s.close()
    snap = tmp_path / "s" / "snapshot.bin"
    good = snap.read_bytes()
    bad = bytearray(good)
    bad[len(bad) // 2] ^= 0xFF  # flip one payload byte mid-file
    snap.write_bytes(bytes(bad))
    with pytest.raises(SnapshotCorruptError) as ei:
        DurableStore(str(tmp_path / "s"))
    msg = str(ei.value)
    assert "quarantined" in msg and "snapshot.bin.corrupt" in msg
    assert not snap.exists()
    corrupt = tmp_path / "s" / "snapshot.bin.corrupt"
    assert corrupt.read_bytes() == bytes(bad)
    # the documented restore path: put a good copy back, boot normally
    snap.write_bytes(good)
    r = DurableStore(str(tmp_path / "s"))
    for i in range(1, 6):
        assert _nb(r, "p", i * 7) == [i * 7 + 1]
    r.close()


def test_rejected_mutation_never_journaled(tmp_path):
    """Validate-BEFORE-journal: a rejected op must not resurface from
    the WAL on restart (the crash matrix's 'rejected writes' leg)."""
    s = DurableStore(str(tmp_path / "s"))
    s.apply(_edge(1))
    with pytest.raises(ValueError):
        s.apply(Edge(pred="p", src=9, dst=10, op="upsert"))
    s.close()
    r = DurableStore(str(tmp_path / "s"))
    assert r.recovery["wal_records"] == 1  # only the good write
    assert _nb(r, "p", 9) == []
    r.close()


# ------------------------------------------------- read-only mode (store)

def test_disk_fault_latches_readonly_and_probe_rearms(tmp_path, monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_STORAGE_PROBE_S", "30")  # probe manually
    s = DurableStore(str(tmp_path / "s"))
    s.apply(_edge(1))
    fail.arm("wal.append", "error(n=1)")
    with pytest.raises(StorageFaultError) as ei:
        s.apply(_edge(2))
    assert ei.value.retry_after == pytest.approx(30.0)
    assert s.storage_readonly()
    assert s.health.status()["last_site"] == "wal.append"
    # reads keep serving from memory
    assert _nb(s, "p", 1) == [2]
    # disk is actually fine: one probe re-arms the write path
    assert s.health.probe_now()
    assert not s.storage_readonly()
    s.apply(_edge(3))
    s.close()
    r = DurableStore(str(tmp_path / "s"))
    assert _nb(r, "p", 3) == [4]
    # the faulted append died BEFORE the frame was written: it must not
    # resurface, and the post-fault write must
    assert _nb(r, "p", 2) == []
    r.close()


def test_rearm_truncates_torn_tail_before_reopening(tmp_path, monkeypatch):
    """A failed append can leave a torn frame; re-arm must cut it so
    post-fault appends never land after garbage (and vanish at replay)."""
    monkeypatch.setenv("DGRAPH_TPU_STORAGE_PROBE_S", "30")
    s = DurableStore(str(tmp_path / "s"))
    s.apply(_edge(1))
    s.wal.flush()
    # simulate the half-written frame a mid-append fault leaves
    with open(s.wal_path, "ab") as f:
        f.write(b"\x50\x00\x00\x00torn")
    s.health.note_error("wal.append", OSError("injected"))
    assert s.storage_readonly()
    assert s.health.probe_now()  # rearm: truncate + reopen
    s.apply(_edge(8))
    s.close()
    r = DurableStore(str(tmp_path / "s"))
    assert _nb(r, "p", 1) == [2]
    assert _nb(r, "p", 8) == [9]
    assert r.recovery["torn_bytes"] == 0  # the tail was cut at re-arm
    r.close()


def test_storage_health_status_counts(tmp_path):
    probed = []

    def probe():
        probed.append(1)

    h = StorageHealth(probe, probe_interval_s=30)
    h.note_error("x.site", OSError("boom"))
    h.note_error("x.site", OSError("boom2"))
    st = h.status()
    assert st["readonly"] and st["errors"] == 2
    assert "boom2" in st["last_error"]
    assert h.probe_now() and not h.readonly()
    assert h.status()["rearms"] == 1
    h.stop()


# ------------------------------------------------------------- snapshotter

def test_snapshotter_due_and_once(tmp_path):
    s = DurableStore(str(tmp_path / "s"))
    sn = Snapshotter(s, wal_records=5, wal_mb=10_000)
    assert not sn.due()
    for i in range(6):
        s.apply(_edge(i * 11 + 1))
    assert sn.due()
    assert sn.snapshot_once()
    assert os.path.getsize(s.wal_path) == 0 and s._list_segments() == []
    assert not sn.due()
    s.close()


def test_snapshotter_trigger_waits_for_completion(tmp_path):
    s = DurableStore(str(tmp_path / "s"))
    s.apply(_edge(1))
    sn = Snapshotter(s, wal_records=10**9, wal_mb=10**9, interval_s=0.05)
    sn.start()
    try:
        assert sn.trigger(wait=True, timeout=30)
        assert os.path.exists(s.snapshot_path)
        assert os.path.getsize(s.wal_path) == 0
    finally:
        sn.stop()
        s.close()


def test_snapshotter_refuses_on_readonly_store(tmp_path, monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_STORAGE_PROBE_S", "30")
    s = DurableStore(str(tmp_path / "s"))
    s.apply(_edge(1))
    s.health.note_error("wal.flush", OSError("dead disk"))
    sn = Snapshotter(s, wal_records=1)
    assert not sn.snapshot_once()
    s.health.probe_now()
    assert sn.snapshot_once()
    s.close()


# ------------------------------------------------------- failpoint grammar

def test_failpoint_after_skips_then_fires():
    fail.arm("t.after", "error(after=2,n=1)")
    fail.point("t.after")  # skipped
    fail.point("t.after")  # skipped
    with pytest.raises(FailpointError):
        fail.point("t.after")
    fail.point("t.after")  # n=1 exhausted
    assert fail.hits("t.after") == 1


def test_failpoint_crash_action_parses():
    from dgraph_tpu_torch.utils.failpoints import _Action

    a = _Action.parse("crash(after=3)")
    assert a.kind == "crash" and a.after == 3 and a.n == -1
    with pytest.raises(ValueError):
        _Action.parse("explode(n=1)")


# --------------------------------------------------- serving surface e2e

def _post(port: int, body: str, path: str = "/query"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body.encode()
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(port: int, path: str):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=30
    ) as r:
        return json.loads(r.read())


@pytest.fixture
def durable_server(tmp_path, monkeypatch):
    """DgraphServer over a DurableStore with test-friendly knobs.
    Yields (server, store); caller-armed failpoints cleaned by the
    autouse fixture."""
    monkeypatch.setenv("DGRAPH_TPU_STORAGE_PROBE_S", "30")
    monkeypatch.setenv("DGRAPH_TPU_SNAPSHOT_WAL_RECORDS", "40")
    monkeypatch.setenv("DGRAPH_TPU_SNAPSHOT_WAL_MB", "10000")
    from dgraph_tpu_torch.serve.server import DgraphServer

    store = DurableStore(str(tmp_path / "p"), sync_writes=True)
    srv = DgraphServer(store, device="cpu")
    srv.start()
    yield srv, store
    srv.stop()


def _set_mutation(i: int) -> str:
    return "mutation { set { <0x%x> <cv> \"%d\" . } }" % (i, i)


def test_server_readonly_mode_sheds_mutations_serves_reads(durable_server):
    srv, store = durable_server
    port = srv.port
    _post(port, "mutation { schema { cv: string . } }")
    _post(port, _set_mutation(1))
    fail.arm("wal.append", "error(n=100)")
    # mutation: 503 + Retry-After; connection-level we need the raw error
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/query", data=_set_mutation(2).encode()
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 503
    assert int(ei.value.headers["Retry-After"]) >= 1
    body = json.loads(ei.value.read())
    assert body["code"] == "ErrorServiceUnavailable"
    # a SECOND mutation is shed at admission (ReadOnlyError), not by
    # hitting the disk again
    hits_before = fail.hits("wal.append")
    with pytest.raises(urllib.error.HTTPError) as ei2:
        urllib.request.urlopen(req, timeout=30)
    assert ei2.value.code == 503
    assert fail.hits("wal.append") == hits_before
    # reads keep answering
    out = _post(port, '{ q(func: uid(0x1)) { cv } }')
    assert out["q"] == [{"cv": "1"}]
    # health detail carries the storage section
    detail = _get(port, "/health?detail=1")
    st = detail["storage"]
    assert st["readonly"] is True
    assert st["last_site"] == "wal.append"
    assert st["sync"] is True and st["group_commit"] is True
    # fault clears → probe re-arms → mutations flow again
    fail.disarm("wal.append")
    assert store.health.probe_now()
    _post(port, _set_mutation(3))
    assert _get(port, "/health?detail=1")["storage"]["readonly"] is False


def test_live_schema_mutation_bumps_the_version(durable_server, tmp_path):
    """A schema mutation through a durable server moves ``store.version``
    and the IVM floor, as the replay of the same record does, so a cache
    entry keyed before the change goes stale; a restart reaches the same
    version.  The reference's live path bumps neither (asserted beside
    it): the port's fix of that fault."""
    srv, store = durable_server
    _post(srv.port, 'mutation { set { <0x1> <cv> "1" . } }')
    v0 = store.version
    _post(srv.port, "mutation { schema { cv: string @index(exact) . } }")
    assert store.version == v0 + 1
    assert store.pred_floor == store.version
    live = store.version
    srv.stop()
    again = DurableStore(str(tmp_path / "p"))
    try:
        assert again.version == live
    finally:
        again.close()

    from dgraph_tpu.models.store import Edge as JEdge
    from dgraph_tpu.models.types import TypeID as JTypeID
    from dgraph_tpu.models.types import TypedValue as JTypedValue
    from dgraph_tpu.models.wal import DurableStore as JaxDurable

    ref = JaxDurable(str(tmp_path / "ref"))
    try:
        ref.apply(JEdge(pred="cv", src=1,
                        value=JTypedValue(JTypeID.STRING, "1")))
        r0 = ref.version
        ref.apply_schema("cv: string @index(exact) .")
        assert ref.version == r0
    finally:
        ref.close()


def test_server_sustained_writes_keep_wal_bounded(durable_server, tmp_path):
    """The acceptance-criterion load test, sized for tier-1: a sustained
    write run must trip the snapshotter (WAL sealed + compacted +
    segments deleted), and a restart must replay only post-snapshot
    records."""
    srv, store = durable_server
    port = srv.port
    _post(port, "mutation { schema { cv: string . } }")
    snaps0 = SNAPSHOTS.value()
    total = 140  # > 3x the 40-record threshold
    for i in range(1, total + 1):
        _post(port, _set_mutation(i))
    deadline = time.monotonic() + 30
    while SNAPSHOTS.value() == snaps0 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert SNAPSHOTS.value() > snaps0, "snapshotter never fired under load"
    # settle: snapshotter runs async; force one final round so the tail
    # is compacted too, then assert boundedness
    assert srv.snapshotter.trigger(wait=True, timeout=60)
    st = _get(port, "/health?detail=1")["storage"]
    assert st["sealed_segments"] == 0
    assert st["wal_records"] < total
    srv.stop()
    r = DurableStore(str(tmp_path / "p"))
    try:
        # replay processed only post-snapshot records...
        assert r.recovery["snapshot_records"] > 0
        assert r.recovery["wal_records"] + r.recovery["segment_records"] < total
        # ...and lost nothing
        eng_out = []
        for i in (1, total // 2, total):
            v = r.value("cv", i)
            eng_out.append(None if v is None else v.value)
        assert eng_out == [str(1), str(total // 2), str(total)]
    finally:
        r.close()


def test_admin_snapshot_endpoint(durable_server):
    srv, _store = durable_server
    port = srv.port
    _post(port, "mutation { schema { cv: string . } }")
    _post(port, _set_mutation(9))
    out = _get(port, "/admin/snapshot?wait=1")
    assert out["code"] == "Success"
    st = _get(port, "/health?detail=1")["storage"]
    assert st["wal_records"] == 0 and st["sealed_segments"] == 0
    assert st["snapshot_age_s"] is not None and st["snapshot_age_s"] < 60


def test_recovery_metrics_and_log_line(tmp_path, capfd):
    s = DurableStore(str(tmp_path / "s"))
    for i in range(1, 4):
        s.apply(_edge(i * 5))
    s.close()
    # torn tail on top, to exercise the torn_bytes leg of the line
    with open(os.path.join(str(tmp_path / "s"), "wal.log"), "ab") as f:
        f.write(b"\x99\x00\x00\x00oops")
    capfd.readouterr()
    r = DurableStore(str(tmp_path / "s"))
    err = capfd.readouterr().err
    assert "# recovery" in err
    assert "wal_records=3" in err
    assert "torn_bytes=8" in err
    from dgraph_tpu_torch.utils.metrics import (
        RECOVERY_RECORDS,
        RECOVERY_TORN_BYTES,
    )

    assert RECOVERY_RECORDS.value() == 3
    assert RECOVERY_TORN_BYTES.value() == 8
    assert r.recovery["torn_bytes"] == 8
    r.close()
