"""The port's clustered server (``dgraph_tpu_torch.cluster.service`` +
``serve/server.py``'s cluster plane + ``cli/server.py``'s cluster flags)
against the reference's, on the CPU.

- tests/test_cluster_http.py's eight cases and tests/test_placement.py's
  six, on port servers (``device="cpu"``, real HTTP between them, one
  process).  Where a case reads query bodies, a reference cluster of
  the same shape is booted in the same test, sent the same requests, and
  every body must equal the reference's (``server_latency`` aside).
- A mixed cluster: two port servers and one reference server in one
  Raft group.  A write through each is read back alike on all three —
  the raft frames, batches and snapshots cross between the packages.
- The CLI: three ``python -m dgraph_tpu_torch.cli.server --peer ...
  --device cpu`` processes answer a replicated write; ``--raft_transport
  grpc`` boots a node whose raft plane and reads ride gRPC, and an
  ``https://`` peer under ``--peer_tls_insecure`` boots and serves.

The reference tests' patience is reused: their proposal patience
(``_patient_proposals``), their condition-polling writes and waits.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from dgraph_tpu.cluster.groups import GroupConfig as JGroupConfig
from dgraph_tpu.cluster.service import ClusterService as JClusterService
from dgraph_tpu.serve.server import DgraphServer as JDgraphServer
from dgraph_tpu_torch.cluster.groups import GroupConfig
from dgraph_tpu_torch.cluster.service import (
    METADATA_GROUP,
    ClusterService,
    parse_peer_groups,
)
from dgraph_tpu_torch.serve.server import DgraphServer

from tests.test_cluster_http import (  # noqa: F401 — the module-wide fixture
    _patient_proposals,
    _post,
    _post_retry,
    _try_post,
    _wait,
)
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

ROOT = Path(__file__).resolve().parents[1]


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _server(kind, svc, port):
    if kind == "port":
        return DgraphServer(svc.store, port=port, cluster=svc, device="cpu")
    return JDgraphServer(svc.store, port=port, cluster=svc)


def _svc(kind, **kw):
    return (ClusterService if kind == "port" else JClusterService)(**kw)


def _boot(kind, tmp_path, n=3, group_ids=(0, 1), kinds=None, **svc_kwargs):
    """n servers of ``kind`` ("port" or "ref"; ``kinds`` mixes them, one a
    node) on fresh ports, every one a member of one cluster; returns them
    once every group knows a leader."""
    ports = _free_ports(n)
    peers = {str(i + 1): f"http://127.0.0.1:{ports[i]}" for i in range(n)}
    kinds = kinds or [kind] * n
    servers = []
    for i in range(n):
        nid = str(i + 1)
        svc = _svc(kinds[i], node_id=nid, my_addr=peers[nid], peers=peers,
                   group_ids=list(group_ids),
                   directory=str(tmp_path / f"{kinds[i]}{nid}"), **svc_kwargs)
        svc.start()
        srv = _server(kinds[i], svc, ports[i])
        srv.start()
        servers.append(srv)
    assert _wait(lambda: all(s.cluster.has_leader() for s in servers)), (
        "no leader elected"
    )
    return servers


def _stop(servers):
    for s in servers:
        try:
            s.stop()
        except Exception:  # noqa: BLE001 — teardown of a stopped node
            pass


def _body(addr, q):
    """A query's body without its latency map, as the JSON text the
    server sent (key order kept): what two servers must agree on."""
    got = _try_post(addr, "/query", q)
    got.pop("server_latency", None)
    return json.dumps(got)


def _same(port_addr, ref_addr, q, want=None):
    """The body of ``q`` on a port server equals the reference server's
    (and ``want``'s, when given); polled, so both may still converge."""
    def ok():
        b = _body(port_addr, q)
        return b == _body(ref_addr, q) and (want is None or json.loads(b) == want)

    return _wait(ok)


@pytest.fixture()
def pair3(tmp_path):
    """A port cluster of three servers and a reference cluster of the
    same shape (groups 0 and 1 on every server)."""
    port = _boot("port", tmp_path / "port")
    ref = _boot("ref", tmp_path / "ref")
    yield port, ref
    _stop(port + ref)


# -- tests/test_cluster_http.py's cases -----------------------------------------


def test_cluster_secret_gates_raft_plane(tmp_path):
    port = _boot("port", tmp_path / "port", secret="s3kr1t")
    ref = _boot("ref", tmp_path / "ref", secret="s3kr1t")
    try:
        for servers in (port, ref):
            out = _post_retry(servers[1].addr, "/query",
                              'mutation { set { <0x1> <name> "sec" . } }')
            assert out.get("code") == "Success"
        for path in ("/raft/0", "/raft-propose/0", "/assign-uids", "/join"):
            answers = []
            for servers in (port, ref):
                req = urllib.request.Request(servers[0].addr + path,
                                             data=b"\x00garbage")
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(req, timeout=5)
                answers.append((ei.value.code, ei.value.read()))
            assert answers[0][0] == 403, path
            assert answers[0] == answers[1], path
        for path in ("/pred-snapshot?name=name", "/predlist?group=1"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(port[0].addr + path, timeout=5)
            assert ei.value.code == 403
        assert _same(port[0].addr, ref[0].addr, "{ q(func: uid(0x1)) { name } }",
                     {"q": [{"name": "sec"}]})
    finally:
        _stop(port + ref)


def test_replicated_write_read_everywhere(pair3):
    port, ref = pair3
    mu = """
    mutation {
      schema { name: string @index(term) . friend: uid @reverse . }
      set {
        <0x1> <name> "Alice" .
        <0x2> <name> "Bob" .
        <0x1> <friend> <0x2> .
      }
    }"""
    for servers in (port, ref):
        assert _post_retry(servers[0].addr, "/query", mu).get("code") == "Success"
    q = '{ q(func: uid(0x1)) { name friend { name ~friend { name } } } }'
    want = {"q": [{"name": "Alice", "friend": [{"name": "Bob", "~friend": [
        {"name": "Alice"}]}]}]}
    for p, r in zip(port, ref):
        assert _same(p.addr, r.addr, q, want), "replicas did not converge"


def test_write_via_every_server(pair3):
    port, ref = pair3
    for servers in (port, ref):
        for i, s in enumerate(servers):
            out = _post_retry(s.addr, "/query",
                              'mutation { set { <0x%x> <tag> "from-%d" . } }' % (0x10 + i, i))
            assert out.get("code") == "Success"
    q = "{ q(func: has(tag)) { uid tag } }"
    assert _wait(lambda: len(_try_post(port[0].addr, "/query", q).get("q", [])) == 3)
    for p, r in zip(port, ref):
        assert _same(p.addr, r.addr, q)


def test_blank_nodes_get_cluster_unique_uids(pair3):
    port, ref = pair3
    for servers in (port, ref):
        uids = set()
        for s in servers:
            out = _post_retry(s.addr, "/query", 'mutation { set { _:x <kind> "blank" . } }')
            uids.add(out["uids"]["x"])
        assert len(uids) == 3, f"lease handed out duplicate uids: {uids}"
    q = "{ q(func: has(kind)) { kind } }"
    assert _same(port[2].addr, ref[2].addr, q,
                 {"q": [{"kind": "blank"}] * 3})


def test_leader_failover(pair3):
    """Kill the metadata-group leader; the surviving quorum elects a new
    one and keeps accepting writes."""
    bodies = []
    for servers in pair3:
        leader_id = servers[0].cluster.groups[METADATA_GROUP].node.leader_id
        assert leader_id is not None
        victim = next(s for s in servers if s.cluster.node_id == leader_id)
        survivors = [s for s in servers if s is not victim]
        victim.stop()
        alive = {s.cluster.node_id for s in survivors}
        assert _wait(lambda: all(
            g.node.leader_id in alive for g in survivors[0].cluster.groups.values()
        ), timeout=30), "no re-election"
        out = _post_retry(survivors[0].addr, "/query",
                          'mutation { set { _:y <kind> "post-failover" . } }')
        assert out.get("code") == "Success"
        q = "{ q(func: has(kind)) { kind } }"
        assert _wait(lambda: _body(survivors[1].addr, q)
                     == json.dumps({"q": [{"kind": "post-failover"}]}))
        bodies.append(_body(survivors[1].addr, q))
    assert bodies[0] == bodies[1]


def test_schema_then_set_via_follower_converts_with_new_schema(pair3):
    """A schema change and a set block in one request through a follower:
    the set converts against the new schema."""
    for servers in pair3:
        follower = next(
            s for s in servers
            if not s.cluster.groups[METADATA_GROUP].node.is_leader
        )
        out = _post_retry(follower.addr, "/query", """
        mutation {
          schema { age: int @index(int) . }
          set { <0x9> <age> "41" . }
        }""")
        assert out.get("code") == "Success"
    q = "{ q(func: eq(age, 41)) { age } }"
    for p, r in zip(*pair3):
        assert _same(p.addr, r.addr, q, {"q": [{"age": 41}]}), (
            "set converted against stale schema")


def _join_fourth(kind, cluster, tmp_path):
    """A 4th server of ``kind`` joins ``cluster`` at runtime; returns it."""
    port4 = _free_ports(1)[0]
    addr4 = f"http://127.0.0.1:{port4}"
    svc4 = _svc(kind, node_id="4", my_addr=addr4, peers={"4": addr4},
                group_ids=[0, 1], directory=str(tmp_path / f"{kind}4"), passive=True)
    svc4.start()
    srv4 = _server(kind, svc4, port4)
    srv4.start()
    svc4.join_cluster(cluster[1].addr, timeout=100)
    return srv4


def test_runtime_server_join(pair3, tmp_path):
    """A 4th server joins the live 3-server cluster at runtime, catches up
    via snapshot+log, serves reads and accepts writes; restarted from its
    directory alone it replays the membership and serves again."""
    port, ref = pair3
    seed = """
    mutation { schema { name: string @index(exact) . }
               set { <0x21> <name> "pre-join" . } }"""
    for servers in (port, ref):
        assert _post_retry(servers[0].addr, "/query", seed).get("code") == "Success"
    fourth = {}
    try:
        for kind, servers in (("port", port), ("ref", ref)):
            fourth[kind] = _join_fourth(kind, servers, tmp_path)
            assert _wait(lambda: all("4" in s.cluster.peers for s in servers)), (
                "membership did not replicate")
        q_pre = '{ q(func: eq(name, "pre-join")) { name } }'
        assert _wait(lambda: _body(fourth["port"].addr, q_pre)
                     == json.dumps({"q": [{"name": "pre-join"}]}), timeout=40), (
            "joiner never caught up")
        assert _same(fourth["port"].addr, fourth["ref"].addr, q_pre)
        q_via = '{ q(func: eq(name, "via-joiner")) { name } }'
        for kind, servers in (("port", port), ("ref", ref)):
            out = _post_retry(fourth[kind].addr, "/query",
                              'mutation { set { <0x22> <name> "via-joiner" . } }')
            assert out.get("code") == "Success"
        assert _same(port[0].addr, ref[0].addr, q_via,
                     {"q": [{"name": "via-joiner"}]}), "joiner write did not replicate"
    finally:
        _stop(list(fourth.values()))
    # restart the port's joiner from its directory ONLY: the replicated
    # MEMBER records restore the full peer map
    addr4 = fourth["port"].addr
    port4 = int(addr4.rsplit(":", 1)[1])
    svc4b = ClusterService(node_id="4", my_addr=addr4, peers={"4": addr4},
                           group_ids=[0, 1], directory=str(tmp_path / "port4"),
                           passive=True)
    svc4b.start()
    srv4b = DgraphServer(svc4b.store, port=port4, cluster=svc4b, device="cpu")
    srv4b.start()
    try:
        assert _wait(lambda: "1" in svc4b.peers and "2" in svc4b.peers,
                     timeout=20), "restart did not replay membership"
        assert _wait(lambda: _body(addr4, q_via)
                     == json.dumps({"q": [{"name": "via-joiner"}]}), timeout=40), (
            "restarted joiner not serving")
    finally:
        srv4b.stop()


def test_explicit_uid_reservation_reaches_leader(tmp_path):
    """An explicit uid written through a follower is never handed out
    later as a fresh uid by the metadata leader."""
    servers = _boot("port", tmp_path)
    try:
        leader = next(
            s for s in servers
            if s.cluster.groups[METADATA_GROUP].node.is_leader
        )
        follower = next(s for s in servers if s is not leader)
        leader.cluster.assign_uids(1)
        explicit = 0x40
        follower.cluster.store.uids.reserve_through(explicit)
        start, end = leader.cluster.assign_uids(200)
        assert not (start <= explicit <= end), (
            f"leader handed out reserved uid {explicit:#x} in [{start}, {end}]")
    finally:
        _stop(servers)


# -- tests/test_placement.py's cases ------------------------------------------

CONF = """
    1: name, knows
    2: city, lives_in
    default: fp % 2 + 1
"""


def _placed(kind, tmp_path):
    """Two servers, disjoint data groups: server 1 places group 1
    (name, knows), server 2 group 2 (city, lives_in)."""
    ports = _free_ports(2)
    peers = {str(i + 1): f"http://127.0.0.1:{ports[i]}" for i in range(2)}
    pg = parse_peer_groups("1=0,1;2=0,2")
    conf = (GroupConfig if kind == "port" else JGroupConfig).parse(CONF)
    servers = []
    for i, own in ((0, [0, 1]), (1, [0, 2])):
        nid = str(i + 1)
        svc = _svc(kind, node_id=nid, my_addr=peers[nid], peers=peers, group_ids=own,
                   directory=str(tmp_path / f"{kind}{nid}"), group_config=conf,
                   peer_groups=pg, tick_ms=10)
        srv = _server(kind, svc, ports[i])
        svc.start()
        srv.start()
        servers.append(srv)
    for srv in servers:
        srv.store.remote_ttl = 0.05
    assert _wait(lambda: all(s.cluster.has_leader() for s in servers))
    return servers


@pytest.fixture()
def placed2(tmp_path):
    port = _placed("port", tmp_path / "port")
    ref = _placed("ref", tmp_path / "ref")
    yield port, ref
    _stop(port + ref)


@pytest.fixture()
def placed(tmp_path):
    """The port's pair alone, for the cases that read no query body."""
    port = _placed("port", tmp_path)
    yield port
    _stop(port)


def _load(servers):
    _post(servers[0].addr, "/query", """
    mutation {
      schema {
        name: string @index(exact) .
        city: string @index(exact) .
        knows: uid .
        lives_in: uid .
      }
    }""")
    _post(servers[0].addr, "/query", """
    mutation { set {
      <0x1> <name> "ann" .
      <0x2> <name> "bob" .
      <0x1> <knows> <0x2> .
      <0x10> <city> "oslo" .
      <0x1> <lives_in> <0x10> .
      <0x2> <lives_in> <0x10> .
    } }""")


def test_disjoint_placement_and_cross_reads(placed2):
    port, ref = placed2
    for servers in placed2:
        _load(servers)
    q = '{ q(func: eq(name, "ann")) { name knows { name } lives_in { city } } }'
    want = {"q": [{"name": "ann", "knows": [{"name": "bob"}],
                   "lives_in": [{"city": "oslo"}]}]}
    for p, r in zip(port, ref):
        assert _same(p.addr, r.addr, q, want), _body(p.addr, q)
    s1 = set().union(*(g.store._preds.keys() for g in port[0].cluster.groups.values()))
    s2 = set().union(*(g.store._preds.keys() for g in port[1].cluster.groups.values()))
    assert {"name", "knows"} <= s1 and not ({"city", "lives_in"} & s1)
    assert {"city", "lives_in"} <= s2 and not ({"name", "knows"} & s2)


def test_remote_write_routes_to_owner_and_invalidates(placed2):
    port, ref = placed2
    q = '{ q(func: eq(name, "bob")) { lives_in { city } } }'
    for servers in placed2:
        _load(servers)
        _wait(lambda: _post(servers[0].addr, "/query", q).get("q"))
        _post(servers[0].addr, "/query",
              'mutation { set { <0x11> <city> "rome" . <0x2> <lives_in> <0x11> . } }')
    want = {"q": [{"lives_in": [{"city": "oslo"}, {"city": "rome"}]}]}
    assert _same(port[0].addr, ref[0].addr, q, want), _body(port[0].addr, q)


def test_kill_non_owner_keeps_owned_data(placed2):
    q1 = '{ q(func: eq(name, "ann")) { name knows { name } } }'
    q2 = '{ q(func: eq(name, "ann")) { lives_in { city } } }'
    got = []
    for servers in placed2:
        _load(servers)
        _wait(lambda: _post(servers[0].addr, "/query", q1).get("q"))
        _wait(lambda: _post(servers[0].addr, "/query", q2).get("q"))
        servers[1].stop()
        a = _post(servers[0].addr, "/query", q1)
        b = _post(servers[0].addr, "/query", q2)
        assert a["q"][0]["knows"] == [{"name": "bob"}]
        assert b["q"][0]["lives_in"] == [{"city": "oslo"}]
        for x in (a, b):
            x.pop("server_latency", None)
            # whether a read lands after the freshness window (and so
            # carries the stale-serve annotation, with its age) is timing
            deg = x.pop("degraded", None)
            assert deg is None or deg["stale_groups"] == [2]
        got.append(json.dumps([a, b]))
    assert got[0] == got[1]


def test_pred_versions_are_per_predicate(placed):
    """A write to one predicate does not bump another's snapshot
    version; a write to it does."""
    port = placed
    _load(port)
    q = '{ q(func: eq(name, "ann")) { lives_in { city } } }'
    _wait(lambda: _post(port[0].addr, "/query", q).get("q"))

    def fetch_city_ver(since):
        req = urllib.request.Request(
            port[1].addr + f"/pred-snapshot?name=city&since={since}")
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, int(r.headers["X-Pred-Version"])

    _st, ver = fetch_city_ver(-1)
    _post(port[0].addr, "/query", 'mutation { set { <0x3> <name> "cid" . } }')
    _post(port[1].addr, "/query", 'mutation { set { <0x4> <lives_in> <0x10> . } }')
    st2, ver2 = fetch_city_ver(ver)
    assert st2 == 204 and ver2 == ver, (st2, ver2, ver)
    _post(port[1].addr, "/query", 'mutation { set { <0x12> <city> "bern" . } }')
    assert _wait(lambda: fetch_city_ver(ver)[0] == 200)


def test_cluster_version_for_unmasked_across_groups(placed):
    """The cluster clock composes per-predicate versions across groups: a
    write to a group whose raft index is far behind another's still
    advances the footprint version, and a schema change lifts the floor."""
    from dgraph_tpu_torch.ivm.versions import version_for

    port = placed
    _load(port)
    st = port[0].store
    q = '{ q(func: eq(name, "ann")) { lives_in { city } } }'
    _wait(lambda: _post(port[0].addr, "/query", q).get("q"))
    for i in range(10):
        _post(port[1].addr, "/query",
              f"mutation {{ set {{ <0x{0x20 + i:x}> <lives_in> <0x10> . }} }}")
    time.sleep(0.1)
    _post(port[0].addr, "/query", q)
    fp = {"name", "lives_in"}
    v1 = version_for(st, fp)
    assert version_for(st, fp) == v1
    _post(port[0].addr, "/query", 'mutation { set { <0x5> <name> "eve" . } }')
    assert _wait(lambda: version_for(st, fp) > v1)
    v_city = version_for(st, {"city"})
    assert version_for(st, {"city"}) == v_city
    _post(port[0].addr, "/query", "mutation { schema { nick: string . } }")
    assert _wait(lambda: version_for(st, {"city"}) > v_city)


def test_predicates_fetch_does_not_hold_remote_lock():
    """ClusterStore.predicates() does not hold _remote_lock across the
    network fetch of a remote group's predicate list."""
    from dgraph_tpu_torch.cluster.service import ClusterStore

    entered = threading.Event()
    release = threading.Event()

    class _Conf:
        def known_groups(self):
            return [1, 7]

    class _Svc:
        groups = {}
        conf = _Conf()
        peer_groups = {1: [], 7: []}

        def fetch_predlist(self, gid, timeout=5.0):
            entered.set()
            assert release.wait(5), "test deadlock"
            return ["remote_pred"]

        def servers_of_group(self, gid):
            return ["somewhere"]

    store = ClusterStore(_Svc())
    t = threading.Thread(target=store.predicates, daemon=True)
    t.start()
    assert entered.wait(5)
    assert store._remote_lock.acquire(timeout=1.0), (
        "_remote_lock held across the network fetch")
    store._remote_lock.release()
    release.set()
    t.join(5)
    assert not t.is_alive()
    assert "remote_pred" in store.predicates()


# -- port and reference in one cluster ------------------------------------------


def test_mixed_cluster_replicates_and_answers_alike(tmp_path):
    """Two port servers and one reference server in one Raft group per
    group: writes through each server (leader or follower, whichever
    package leads) replicate to all three, which answer alike."""
    servers = _boot("mixed", tmp_path, kinds=["port", "port", "ref"])
    try:
        out = _post_retry(servers[2].addr, "/query", """
        mutation { schema { name: string @index(term) . tag: string . knows: uid . } }""")
        assert out.get("code") == "Success"
        for i, s in enumerate(servers):
            out = _post_retry(s.addr, "/query", (
                'mutation { set { <0x%x> <tag> "via-%d" . <0x%x> <name> "n%d alpha" . '
                '<0x%x> <knows> <0x%x> . } }') % (0x30 + i, i, 0x30 + i, i, 0x30 + i, 0x31 + i))
            assert out.get("code") == "Success"
        q = ('{ q(func: has(tag)) { uid tag name knows { uid } } '
             'a(func: allofterms(name, "alpha")) { count() } }')

        def alike():
            bodies = {_body(s.addr, q) for s in servers}
            return len(bodies) == 1 and len(json.loads(bodies.pop()).get("q", [])) == 3

        assert _wait(alike), [_body(s.addr, q) for s in servers]
        assert json.loads(_body(servers[0].addr, q))["a"] == [{"count": 3}]
    finally:
        _stop(servers)


# -- the CLI ----------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _cli(*flags, wait_serving=True):
    proc = subprocess.Popen(
        [sys.executable, "-m", "dgraph_tpu_torch.cli.server", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(),
    )
    if not wait_serving:
        return proc
    lines = []
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line.strip())
        if line.startswith("serving on "):
            return proc
    proc.kill()
    proc.wait(timeout=30)
    raise AssertionError(f"server did not start: {lines} {proc.stderr.read()[-2000:]}")


def test_cli_cluster_of_three_answers(tmp_path):
    ports = _free_ports(3)
    peer = ",".join(f"{i + 1}@127.0.0.1:{p}" for i, p in enumerate(ports))
    procs = []
    try:
        for i, p in enumerate(ports):
            procs.append(_cli("--p", str(tmp_path / f"n{i + 1}"), "--port", str(p),
                              "--idx", str(i + 1), "--groups", "0,1", "--peer", peer,
                              "--device", "cpu", wait_serving=False))
        for proc in procs:
            line = ""
            deadline = time.monotonic() + 120
            while not line.startswith("serving on ") and time.monotonic() < deadline:
                line = proc.stdout.readline()
                assert line, proc.stderr.read()[-2000:]
        addrs = [f"http://127.0.0.1:{p}" for p in ports]
        out = _post_retry(addrs[1], "/query", """
        mutation { schema { name: string @index(exact) . }
                   set { <0x1> <name> "cli" . <0x2> <name> "three" . } }""")
        assert out.get("code") == "Success"
        q = '{ q(func: eq(name, "cli")) { uid name } }'
        want = json.dumps({"q": [{"_uid_": "0x1", "name": "cli"}]})
        for a in addrs:
            assert _wait(lambda a=a: _body(a, q) == want), _body(a, q)
        with urllib.request.urlopen(addrs[0] + "/health?detail=1", timeout=10) as r:
            detail = json.loads(r.read())
        assert detail["node"] == "1" and set(detail["raft"]) == {"0", "1"}
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)


@pytest.mark.parametrize("kind", ["grpc_raft", "https_peer"])
def test_cli_refuses_grpc_and_https_peers(tmp_path, kind):
    """(Named when the port refused both; it asserts the opposite now.)
    Neither is refused: the CLI boots both as the reference's does.  ``--raft_transport grpc``: a one-node cluster whose raft plane
    is the gRPC Worker RPC serves its gRPC listener at the HTTP port +
    1000 and answers a write read back over gRPC.  An ``https://`` peer
    under ``--peer_tls_insecure``: the node boots and serves, no
    warning."""
    grpc = pytest.importorskip("grpc")
    port, other = _free_ports(2)
    flags = ["--p", str(tmp_path / "p"), "--port", str(port), "--idx", "1",
             "--device", "cpu"]
    if kind == "grpc_raft":
        flags += ["--peer", f"1@127.0.0.1:{port}", "--raft_transport", "grpc"]
    else:
        flags += ["--peer", f"1@127.0.0.1:{port},2@https://127.0.0.1:{other}",
                  "--peer_tls_insecure", "--grpc_port", "-1"]
    proc = _cli(*flags)
    try:
        addr = f"http://127.0.0.1:{port}"
        if kind == "grpc_raft":
            line = proc.stdout.readline().strip()
            assert line == f"gRPC (protos.Dgraph) at 127.0.0.1:{port + 1000}", line
            out = _post_retry(addr, "/query",
                              'mutation { set { <0x1> <name> "raft over grpc" . } }')
            assert out.get("code") == "Success"
            from dgraph_tpu_torch.serve.grpc_server import encode_request
            from dgraph_tpu_torch.serve.proto import decode_response

            with grpc.insecure_channel(f"127.0.0.1:{port + 1000}") as ch:
                got = decode_response(ch.unary_unary("/protos.Dgraph/Run")(
                    encode_request("{ q(func: uid(0x1)) { name } }"), timeout=60))
            assert got["q"] == [{"name": "raft over grpc"}]
        else:
            with urllib.request.urlopen(addr + "/health", timeout=30) as r:
                assert r.status == 200
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    err = proc.stderr.read()
    assert proc.returncode == 0, err[-2000:]
    assert "refused" not in err and "warning: TLS peers" not in err


def test_clustered_server_default_device_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    port = _free_ports(1)[0]
    addr = f"http://127.0.0.1:{port}"
    svc = ClusterService(node_id="1", my_addr=addr, peers={"1": addr},
                         group_ids=[0, 1], directory=str(tmp_path / "n1"))
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            DgraphServer(svc.store, port=port, cluster=svc)
    finally:
        svc.stop()
    from dgraph_tpu_torch.cli import server as cli

    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--p", str(tmp_path / "c"), "--port", str(port), "--idx", "1",
                  "--peer", f"1@127.0.0.1:{port}"])


def test_cluster_admin_and_debug_surfaces(pair3, tmp_path):
    """The clustered server's admin and debug endpoints answer as the
    reference's: ``/admin/snapshot`` compacts the raft logs (same code
    and body), ``/health?detail=1`` carries the cluster summary's keys,
    ``/debug/store`` reads the ClusterStore (its version clock has a
    ``len``), and the result cache stays off (the store's versions are
    not strict); a plain server answers the cluster plane 404."""
    from dgraph_tpu_torch.models.store import PostingStore

    port, ref = pair3
    for servers in (port, ref):
        out = _post_retry(servers[0].addr, "/query",
                          'mutation { set { <0x1> <name> "dbg" . <0x1> <e> <0x2> . } }')
        assert out.get("code") == "Success"
    # the write was acknowledged by server 0; server 1 of each cluster
    # applies it asynchronously: wait until both serve it before reading
    # their admin and debug surfaces
    q = '{ q(func: uid(0x1)) { name e { uid } } }'
    want = {"q": [{"name": "dbg", "e": [{"_uid_": "0x2"}]}]}
    assert _same(port[1].addr, ref[1].addr, q, want), _body(port[1].addr, q)
    snaps = []
    for servers in (port, ref):
        with urllib.request.urlopen(servers[1].addr + "/admin/snapshot", timeout=10) as r:
            snaps.append((r.status, r.read()))
    assert snaps[0] == snaps[1]
    details = []
    for servers in (port, ref):
        with urllib.request.urlopen(servers[0].addr + "/health?detail=1", timeout=10) as r:
            details.append(json.loads(r.read()))
    for key in ("node", "peers", "raft", "degraded"):
        assert key in details[0] and key in details[1], key
    assert details[0]["raft"].keys() == details[1]["raft"].keys() == {"0", "1"}
    assert details[0]["raft"]["0"].keys() == details[1]["raft"]["0"].keys()
    assert details[0]["degraded"] is None
    assert _same(port[1].addr, ref[1].addr, q)
    for _ in range(3):
        _post(port[1].addr, "/query", q)
    rc = port[1].scheduler.result_cache
    assert rc is None or len(rc) == 0  # tier 2 stays off on a cluster store
    with urllib.request.urlopen(port[1].addr + "/debug/store", timeout=10) as r:
        stats = json.loads(r.read())
    assert stats["predicates"]["name"] == {"edges": 0, "values": 1}
    assert stats["predicates"]["e"] == {"edges": 1, "values": 0}
    assert stats["ivm"]["tracked_preds"] >= 1
    plain = DgraphServer(PostingStore(), device="cpu", export_path=str(tmp_path / "x"))
    plain.start()
    try:
        for path, data in (("/pred-snapshot?name=e", None), ("/predlist?group=1", None),
                           ("/raft/1", b"x"), ("/assign-uids", b"1")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    plain.addr + path, data=data), timeout=5)
            assert ei.value.code == 404
            assert json.loads(ei.value.read()) == {
                "code": "ErrorInvalidRequest", "message": "not clustered"}
    finally:
        plain.stop()


def test_truncated_raft_body_is_refused(tmp_path):
    """A raft POST whose body is cut short of its Content-Length (the
    sender hung up mid-frame) answers 400 and delivers nothing: the
    group's log does not grow."""
    servers = _boot("port", tmp_path, n=1)
    try:
        g = servers[0].cluster.groups[1]
        before = g.node.storage.last_index()
        from dgraph_tpu_torch.cluster import raft, transport

        frame = transport.encode_msg(raft.AppendReq(
            g.node.storage.term + 5, "9", before, g.node.storage.last_term(),
            [raft.Entry(g.node.storage.term + 5, before + 1, b"y" * 4000)], 0))
        host, port = servers[0].addr[len("http://"):].split(":")
        with socket.create_connection((host, int(port)), timeout=10) as sk:
            sk.sendall((f"POST /raft/1 HTTP/1.1\r\nHost: x\r\n"
                        f"Content-Length: {len(frame)}\r\n\r\n").encode()
                       + frame[:len(frame) // 2])
            sk.shutdown(socket.SHUT_WR)
            chunks = []  # the server closes the connection after its answer
            while True:
                b = sk.recv(65536)
                if not b:
                    break
                chunks.append(b)
            reply = b"".join(chunks).decode("latin-1")
        assert reply.startswith("HTTP/1.1 400"), reply
        assert "truncated request body" in reply
        time.sleep(0.3)
        assert g.node.storage.last_index() == before
    finally:
        _stop(servers)
