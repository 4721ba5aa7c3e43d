"""PeerClient: the single gate every intra-cluster RPC goes through (copy
of ``dgraph_tpu/cluster/peerclient.py``).

Upstream Dgraph survives slow and dead peers because its worker conn pool
retries, follows leader hints, and balances reads across replicas
(worker/conn.go, groups.go:268 AnyServer).  A one-shot
``urlopen_peer`` call per cross-server read or forwarded proposal would
add a full connect-timeout stall to every query touching a down peer's
group.  PeerClient owns three defenses, applied to every peer call:

1. **Retry with exponential backoff + full jitter under a deadline
   budget.**  The caller hands an overall ``budget`` (seconds); each
   attempt's timeout is derived from the REMAINING budget split over the
   remaining attempts, so three attempts against a 3s budget never take
   9s, and backoff sleeps are clamped to never overshoot the deadline.

2. **A per-peer circuit breaker** (closed → open after
   ``breaker_threshold`` consecutive failures → half-open single probe
   after ``breaker_cooldown`` seconds).  Open circuits shed calls in
   microseconds (:class:`BreakerOpenError`) instead of re-paying the
   connect timeout per query; a successful half-open probe closes the
   circuit, a failed one re-opens it for another cooldown.  An HTTP
   error response (409 leader hint, 404, …) counts as a breaker SUCCESS:
   the peer answered — the failure is application-level, not transport.
   Breaker state is scoped per ``(peer, op)``, not per peer alone: the
   raft heartbeats that keep flowing to a peer whose snapshot endpoint
   is partitioned must not keep closing the read plane's breaker (and a
   broken raft port must not shed that peer's healthy reads).  A fully
   dead peer opens every op's circuit within one threshold each.

3. **Per-peer health scores**: :meth:`order_by_health` sorts a replica
   candidate list healthiest-first, so group reads try a live replica
   before the one that just timed out instead of always ``members[0]``.

Every attempt passes through the failpoint ``peerclient.<op>``
(utils/failpoints.py), which is how the chaos suite injects
deterministic faults below the retry/breaker machinery.  A sampled
caller's span records one ``rpc.<op>`` child per attempt, and its
context rides the ``Traceparent`` header of every HTTP peer call (the
``traceparent`` metadata of a gRPC one), so the remote node records its
leg of the trace under the same trace id.

``DGRAPH_TPU_RESILIENCE=0`` is the escape hatch: calls degrade to the
single-shot behavior (one attempt, legacy timeout, no breaker, no
degraded-read bookkeeping).

Env knobs: ``DGRAPH_TPU_RPC_ATTEMPTS`` (default 3),
``DGRAPH_TPU_RPC_BACKOFF`` (base seconds, default 0.05; cap 2.0),
``DGRAPH_TPU_BREAKER_THRESHOLD`` (default 5),
``DGRAPH_TPU_BREAKER_COOLDOWN`` (seconds, default 2.0).
"""

from __future__ import annotations

import os
import random
import threading
import time
import urllib.error
from typing import Callable, Dict, List, Optional, Tuple

from dgraph_tpu_torch import obs
from dgraph_tpu_torch.cluster.transport import PeerAuth, urlopen_peer
from dgraph_tpu_torch.utils.env import env_float as _env_f
from dgraph_tpu_torch.utils.failpoints import fail
from dgraph_tpu_torch.utils.health import HalfOpenGate
from dgraph_tpu_torch.utils.metrics import (
    BREAKER_STATE,
    BREAKER_TRANSITIONS,
    PEER_BACKOFF,
    PEER_RPC,
    PEER_RPC_ATTEMPTS,
)

CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

# per-attempt timeout floor: below this a local-network RPC cannot even
# complete a TCP+HTTP round trip, so slicing the budget thinner than
# this just manufactures failures
_MIN_ATTEMPT_TIMEOUT = 0.05


def resilience_enabled() -> bool:
    """The DGRAPH_TPU_RESILIENCE gate (default ON)."""
    return os.environ.get("DGRAPH_TPU_RESILIENCE", "1") != "0"


class PeerUnavailableError(OSError):
    """Every attempt failed (or the budget ran out) for one peer."""

    def __init__(self, peer: str, op: str, detail: str = ""):
        self.peer = peer
        self.op = op
        super().__init__(
            f"peer {peer} unavailable for {op}" + (f": {detail}" if detail else "")
        )


class BreakerOpenError(PeerUnavailableError):
    """Shed without touching the network: the peer's circuit is open."""

    def __init__(self, peer: str, op: str, retry_after: float):
        self.retry_after = retry_after
        super().__init__(peer, op, f"circuit open (retry in ~{retry_after:.1f}s)")


class StaleUnavailableError(OSError):
    """A cross-server read found the owner group unreachable AND holds no
    cached snapshot to degrade to.  The serving layer maps this to
    HTTP 503 + Retry-After / gRPC UNAVAILABLE — a retriable service
    condition, not a client error."""

    def __init__(self, msg: str, retry_after: float = 2.0):
        self.retry_after = retry_after
        super().__init__(msg)


class _PeerState:
    __slots__ = (
        "failures", "state", "gate",
        "last_success", "last_failure", "total_failures", "_race_serial",
    )
    # breaker counters and state transitions must all carry
    # PeerClient._lock — the armed lockset witness (analysis/witness.py)
    # proves the "mutated under PeerClient._lock" comment stays true
    __race_fields__ = frozenset({
        "failures", "state", "last_success", "last_failure",
        "total_failures",
    })

    def __init__(self):
        self.failures = 0           # consecutive transport failures
        self.state = CLOSED
        # cooldown + half-open probe-slot discipline: the shared helper
        # (utils/health.py HalfOpenGate — StorageHealth and the device
        # guard ride the same one), mutated under PeerClient._lock
        self.gate = HalfOpenGate()
        self.last_success = 0.0     # monotonic; 0 = never
        self.last_failure = 0.0
        self.total_failures = 0

    @property
    def opened_at(self) -> float:
        return self.gate.opened_at


class PeerClient:
    """One instance per ClusterService, shared with its raft transports."""

    def __init__(
        self,
        auth: Optional[PeerAuth] = None,
        *,
        attempts: Optional[int] = None,
        backoff_base: Optional[float] = None,
        backoff_cap: float = 2.0,
        breaker_threshold: Optional[int] = None,
        breaker_cooldown: Optional[float] = None,
        rng: Optional[random.Random] = None,
    ):
        self.auth = auth
        self.attempts = int(
            attempts
            if attempts is not None
            else _env_f("DGRAPH_TPU_RPC_ATTEMPTS", 3)
        )
        self.backoff_base = (
            backoff_base
            if backoff_base is not None
            else _env_f("DGRAPH_TPU_RPC_BACKOFF", 0.05)
        )
        self.backoff_cap = backoff_cap
        self.breaker_threshold = int(
            breaker_threshold
            if breaker_threshold is not None
            else _env_f("DGRAPH_TPU_BREAKER_THRESHOLD", 5)
        )
        self.breaker_cooldown = (
            breaker_cooldown
            if breaker_cooldown is not None
            else _env_f("DGRAPH_TPU_BREAKER_COOLDOWN", 2.0)
        )
        # backoff jitter rng: seeded for tests, fresh entropy otherwise
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        # breaker/health state per (peer, op) — see the module docstring
        # for why per-peer alone is wrong (heartbeats masking partitions)
        self._peers: Dict[Tuple[str, str], _PeerState] = {}

    # -- breaker ------------------------------------------------------------

    def _state(self, peer: str, op: str) -> _PeerState:
        st = self._peers.get((peer, op))
        if st is None:
            st = self._peers[(peer, op)] = _PeerState()
        return st

    def _set_state(self, peer: str, op: str, st: _PeerState, state: str) -> None:
        if st.state != state:
            st.state = state
            BREAKER_TRANSITIONS.add((peer, op, state))
        BREAKER_STATE.set(f"{peer}:{op}", _STATE_GAUGE[state])

    def _admit(self, peer: str, op: str) -> Tuple[bool, float, Optional[int]]:
        """(admitted, retry_after, probe_token).  Transitions
        open→half-open when the cooldown elapsed, allowing exactly one
        probe at a time.  A non-None ``probe_token`` tells the caller IT
        holds the half-open probe slot — it must hand the token back to
        ``_release_probe`` on every exit path, or the breaker wedges
        shedding forever.  The token (not a bare flag) keeps a slow call
        admitted under an EARLIER state from releasing a probe slot it
        never held."""
        now = time.monotonic()
        with self._lock:
            st = self._state(peer, op)
            if st.state == CLOSED:
                return True, 0.0, None
            granted, retry_after, token = st.gate.admit(
                now, self.breaker_cooldown, half_open=st.state == HALF_OPEN
            )
            if granted and st.state == OPEN:
                self._set_state(peer, op, st, HALF_OPEN)
            return granted, retry_after, token

    def _release_probe(self, peer: str, op: str, token: int) -> None:
        """Free the half-open probe slot WITHOUT judging the peer — runs
        on every probe exit path (including zero-attempt budget
        exhaustion and KeyboardInterrupt).  A stale token (the slot was
        re-granted to a newer probe) is a no-op."""
        with self._lock:
            st = self._peers.get((peer, op))
            if st is not None:
                st.gate.release(token)

    def _record(self, peer: str, op: str, ok: bool) -> None:
        now = time.monotonic()
        with self._lock:
            st = self._state(peer, op)
            if ok:
                st.failures = 0
                st.last_success = now
                self._set_state(peer, op, st, CLOSED)
            else:
                st.failures += 1
                st.total_failures += 1
                st.last_failure = now
                if st.state == HALF_OPEN or st.failures >= self.breaker_threshold:
                    st.gate.open(now)
                    self._set_state(peer, op, st, OPEN)

    def state_of(self, peer: str, op: Optional[str] = None) -> str:
        """Breaker state for one op, or the WORST state across the peer's
        ops (OPEN > HALF_OPEN > CLOSED) when ``op`` is None."""
        with self._lock:
            if op is not None:
                st = self._peers.get((peer, op))
                return st.state if st is not None else CLOSED
            worst = CLOSED
            for (p, _o), st in self._peers.items():
                if p != peer:
                    continue
                if st.state == OPEN:
                    return OPEN
                if st.state == HALF_OPEN:
                    worst = HALF_OPEN
            return worst

    def snapshot(self) -> Dict[str, dict]:
        """Per-peer, per-op breaker/health view for /health."""
        now = time.monotonic()
        with self._lock:
            out: Dict[str, dict] = {}
            for (peer, op), st in self._peers.items():
                out.setdefault(peer, {})[op] = {
                    "breaker": st.state,
                    "consecutive_failures": st.failures,
                    "total_failures": st.total_failures,
                    "last_success_age_s": (
                        round(now - st.last_success, 3) if st.last_success else None
                    ),
                    "last_failure_age_s": (
                        round(now - st.last_failure, 3) if st.last_failure else None
                    ),
                }
            return out

    def order_by_health(
        self,
        members: List[Tuple[str, str]],
        op: Optional[str] = None,
    ) -> List[Tuple[str, str]]:
        """Sort (node_id, addr) candidates healthiest-first: closed
        circuits before open ones, fewer consecutive failures before
        more, most-recent success first.  ``op`` narrows the judgment to
        one op's state (a peer whose raft port is down can still be the
        best snapshot source).  Stable, and open peers are kept (last
        resort — their breaker sheds in microseconds)."""
        if not resilience_enabled():
            return list(members)
        now = time.monotonic()
        with self._lock:
            def key(item: Tuple[str, str]):
                nid = item[0]
                if op is not None:
                    st = self._peers.get((nid, op))
                    sts = [st] if st is not None else []
                else:
                    sts = [s for (p, _o), s in self._peers.items() if p == nid]
                if not sts:
                    return (0, 0, 0.0)
                is_open = (
                    1
                    if any(
                        s.state == OPEN
                        and now - s.opened_at < self.breaker_cooldown
                        for s in sts
                    )
                    else 0
                )
                fails = sum(s.failures for s in sts)
                last = max(s.last_success for s in sts)
                return (is_open, fails, -last)

            return sorted(members, key=key)

    # -- calls --------------------------------------------------------------

    def call(
        self,
        peer: str,
        op: str,
        attempt: Callable[[Optional[float]], object],
        *,
        budget: Optional[float] = None,
        attempts: Optional[int] = None,
        off_timeout: Optional[float] = None,
        transient: Tuple[type, ...] = (OSError,),
        alive: Optional[Callable[[BaseException], bool]] = None,
        slice_budget: bool = True,
    ):
        """Run ``attempt(per_attempt_timeout)`` with retries/backoff under
        the budget and the peer's breaker.

        ``transient`` classifies retriable transport failures (gRPC
        callers extend it with ``grpc.RpcError``).  ``HTTPError`` always
        passes through un-retried — the peer is alive — and counts as a
        breaker success.  ``alive`` refines ``transient`` for exception
        types that cover both cases: a transient-matched exception it
        judges alive gets the HTTPError treatment (un-retried, breaker
        success) — how gRPC's single ``RpcError`` tells a responding peer
        (INVALID_ARGUMENT, UNAUTHENTICATED, …) from a dead one
        (UNAVAILABLE).  ``off_timeout`` is the
        single-attempt timeout used when DGRAPH_TPU_RESILIENCE=0
        (defaults to ``budget``).

        ``slice_budget=False`` gives EVERY attempt the full remaining
        budget instead of splitting it over the attempts left.  This is
        for calls that legitimately block server-side while succeeding
        (a forwarded proposal committing, a join waiting for its MEMBER
        record to apply, a raft frame to a loaded peer): slicing would
        time out work that was about to succeed and re-send it — the
        duplicate-proposal amplification this module exists to kill.
        Retries then only ever fire on failures FASTER than the budget
        (connect refused, RST, injected faults), which leave most of the
        window intact; a first attempt that times out consumes the whole
        budget and simply raises."""
        if not resilience_enabled():
            fail.point(f"peerclient.{op}")
            return attempt(off_timeout if off_timeout is not None else budget)
        n_attempts = max(1, int(attempts if attempts is not None else self.attempts))
        deadline = None if budget is None else time.monotonic() + budget
        # flight recorder: the calling thread's span (the query's engine
        # span, a forwarder's root, …) — every attempt below records one
        # ``rpc.<op>`` child with the breaker/backoff outcome, so a trace
        # shows each wire try.  None = unsampled: no span objects here.
        tsp = obs.current_span()
        admitted, retry_after, probe_token = self._admit(peer, op)
        if not admitted:
            PEER_RPC.add((peer, op, "open"))
            if tsp is not None:
                with tsp.child(f"rpc.{op}") as a:
                    a.set_attr("peer", peer)
                    a.set_attr("outcome", "breaker_open")
                    a.set_attr("retry_after_s", round(retry_after, 3))
            raise BreakerOpenError(peer, op, retry_after)
        last: Optional[BaseException] = None
        made = 0  # attempts actually issued (≠ n_attempts under sheds)
        try:
            for i in range(n_attempts):
                if deadline is None:
                    per = budget
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    # split remaining over the attempts left, but never
                    # slice below the floor — a sub-floor timeout cannot
                    # complete a round trip and would charge the breaker
                    # a manufactured failure against a healthy peer
                    # (deadline overshoot is bounded by the floor)
                    per = remaining if not slice_budget else (
                        remaining / (n_attempts - i)
                    )
                    per = max(per, _MIN_ATTEMPT_TIMEOUT)
                made = i + 1
                asp = None
                if tsp is not None:
                    asp = tsp.child(f"rpc.{op}")
                    asp.set_attr("peer", peer)
                    asp.set_attr("attempt", i + 1)
                    if per is not None:
                        asp.set_attr("timeout_s", round(per, 3))
                try:
                    try:
                        fail.point(f"peerclient.{op}")
                        res = attempt(per)
                        if asp is not None:
                            # BEFORE the finally publishes the span: a
                            # reader racing the finish must never see a
                            # successful attempt with no outcome
                            asp.set_attr("outcome", "ok")
                    except urllib.error.HTTPError as e:
                        # an HTTP response IS the peer talking: transport is fine
                        self._record(peer, op, True)
                        PEER_RPC.add((peer, op, "http_error"))
                        PEER_RPC_ATTEMPTS.observe(i + 1)
                        if asp is not None:
                            asp.set_attr("outcome", "http_error")
                            asp.set_attr("code", getattr(e, "code", 0))
                        raise
                    except transient as e:
                        if alive is not None and alive(e):
                            # the peer RESPONDED with an application-level
                            # rejection: transport is fine, same rule as the
                            # HTTPError arm above
                            self._record(peer, op, True)
                            PEER_RPC.add((peer, op, "http_error"))
                            PEER_RPC_ATTEMPTS.observe(i + 1)
                            if asp is not None:
                                asp.set_attr("outcome", "http_error")
                            raise
                        last = e
                        self._record(peer, op, False)
                        if asp is not None:
                            asp.set_attr("outcome", "transient")
                            asp.set_attr("error", type(e).__name__)
                            asp.set_attr("breaker", self.state_of(peer, op))
                        if self.state_of(peer, op) == OPEN:
                            break  # this attempt tripped the breaker: stop burning budget
                        if i + 1 < n_attempts:
                            b = min(
                                self.backoff_cap, self.backoff_base * (2 ** i)
                            ) * self._rng.random()
                            if deadline is not None:
                                b = min(b, max(0.0, deadline - time.monotonic()))
                            PEER_BACKOFF.observe(b)
                            if asp is not None:
                                # close the attempt span BEFORE sleeping:
                                # the deliberate backoff rides as an attr,
                                # not as span duration (finish is
                                # idempotent; the finally below no-ops)
                                asp.set_attr("backoff_s", round(b, 4))
                                asp.finish()
                            if b > 0:
                                time.sleep(b)
                        continue
                    except Exception as e:
                        # not transient, not an HTTP response: the peer spoke
                        # garbage (BadStatusLine, truncated frame, …).  Count
                        # it as a transport failure — un-recorded, a half-open
                        # probe's flag would leak and wedge the breaker shut.
                        self._record(peer, op, False)
                        PEER_RPC.add((peer, op, "unavailable"))
                        PEER_RPC_ATTEMPTS.observe(i + 1)
                        if asp is not None:
                            asp.set_attr("outcome", "garbage")
                            asp.set_attr("error", type(e).__name__)
                        raise
                finally:
                    if asp is not None:
                        asp.finish()
                self._record(peer, op, True)
                PEER_RPC.add((peer, op, "ok"))
                PEER_RPC_ATTEMPTS.observe(i + 1)
                return res
            PEER_RPC.add((peer, op, "unavailable"))
            PEER_RPC_ATTEMPTS.observe(made)
            raise PeerUnavailableError(
                peer, op,
                f"{type(last).__name__}: {last}" if last else "budget exhausted",
            ) from last
        finally:
            if probe_token is not None:
                self._release_probe(peer, op, probe_token)

    def urlopen(
        self,
        peer: str,
        req,
        *,
        op: str,
        budget: Optional[float] = None,
        attempts: Optional[int] = None,
        off_timeout: Optional[float] = None,
        slice_budget: bool = True,
    ):
        """The HTTP peer call: ``urlopen_peer`` wrapped in retry/breaker.
        Returns the (context-managed) response object."""
        # trace propagation: a sampled caller's context rides the W3C
        # traceparent header, so the remote node records ITS half of the
        # trace under the same trace_id (obs/spans.py)
        sp = obs.current_span()
        if sp is not None and hasattr(req, "add_header"):
            req.add_header("Traceparent", obs.format_traceparent(sp))

        def attempt(t: Optional[float]):
            return urlopen_peer(req, t if t is not None else 10.0, self.auth)

        return self.call(
            peer, op, attempt,
            budget=budget, attempts=attempts, off_timeout=off_timeout,
            slice_budget=slice_budget,
        )

    def grpc_unary(
        self,
        peer: str,
        op: str,
        channel,
        method: str,
        payload: bytes,
        *,
        metadata=None,
        budget: Optional[float] = None,
        attempts: Optional[int] = None,
        slice_budget: bool = True,
    ):
        """The gRPC peer call (raft frames over the Worker plane): the
        channel-RPC invocation lives here, under the same retries and
        breakers as the HTTP calls."""
        import grpc

        # multicallables are cached ON the channel (their lifetime), not
        # rebuilt per frame — this is the raft hot path, one send per
        # heartbeat per peer
        try:
            mcs = channel._dgraph_tpu_multicallables
        except AttributeError:
            mcs = channel._dgraph_tpu_multicallables = {}
        rpc = mcs.get(method)
        if rpc is None:
            rpc = mcs[method] = channel.unary_unary(method)

        # trace propagation, gRPC leg: traceparent rides metadata (same
        # W3C field the HTTP leg puts in a header)
        sp = obs.current_span()
        if sp is not None:
            metadata = list(metadata or []) + [
                ("traceparent", obs.format_traceparent(sp))
            ]

        def attempt(t: Optional[float]):
            return rpc(payload, timeout=t, metadata=metadata)

        # every RpcError carries a status; only these mean the peer
        # itself is unreachable/slow.  Anything else (UNAUTHENTICATED on
        # a secret mismatch, INVALID_ARGUMENT, UNIMPLEMENTED, …) is the
        # peer ANSWERING with a rejection — retrying doubles traffic to
        # an alive peer and opening its breaker misreports a config
        # error as a network outage
        transient_codes = (
            grpc.StatusCode.UNAVAILABLE,
            grpc.StatusCode.DEADLINE_EXCEEDED,
            grpc.StatusCode.CANCELLED,
        )

        def peer_alive(e: BaseException) -> bool:
            code = getattr(e, "code", None)
            try:
                return code is not None and code() not in transient_codes
            except Exception:  # noqa: BLE001 — unknown error shape:
                return False   # keep the old everything-transient rule

        # ValueError: grpcio raises it when the channel closed under the
        # call mid-shutdown — transient for a sender loop, same as before
        return self.call(
            peer, op, attempt,
            budget=budget, attempts=attempts,
            transient=(grpc.RpcError, OSError, ValueError),
            alive=peer_alive, slice_budget=slice_budget,
        )
