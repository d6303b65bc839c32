"""RemoteEngine: a fleet member whose ServingEngine lives across the wire
(the port's copy of vtpu/serving/fabric/remote.py).

The client half of the fabric. One ``HostClient`` owns one channel to an
``EngineHost`` and multiplexes every proxied engine on it: a receiver
thread delivers token/terminal messages into the CLIENT-side ``Request``
objects (in-order, exactly-once — per-session sequence numbers, a
reassembly buffer for out-of-order arrivals, resend requests on gaps,
duplicates dropped), and a pinger thread drives heartbeats whose pongs
carry each engine's beat age and ``EngineSignals``.

``RemoteEngine`` exposes exactly the member surface ``EngineFleet``
consumes — ``submit``/``signals()``/``stats()``, the ledger hook, park /
migrate / drain tickets, ``_beat_ns`` for the probe ladder — so the
fleet routes, drains, rebalances and fails over local and remote members
through ONE code path. Three proxy-specific contracts:

- **Link death is not engine death.** ``_beat_ns`` advances only on
  pongs, so a partition ages the beat and walks the same SUSPECT→DEAD
  ladder a hung engine would — but a heal delivers a fresh pong and the
  ladder's hysteresis restores HEALTHY with ``failovers == 0``, while
  the seq+resend protocol replays anything the blip swallowed. Tokens
  are delayed, never doubled.

- **The client mirror is the rebuild truth.** The host's flush-boundary
  ledger cannot be read from a SIGKILLed process, so the proxy keeps its
  own: prompt + every token actually delivered across the wire. Its
  ``ledger_entries()`` derives the exact migrate-meta shape the fleet's
  ``_rebuild`` feeds to ``migrate_in`` (history-exact, payload-less →
  recompute), which is precisely the at-most-once guarantee: a rebuilt
  stream continues from the last token the CLIENT saw.

- **Asks fail typed, fast.** A lifecycle ticket whose reply the
  transport dropped raises ``MigrationError`` the moment the link is
  known dead (or on its own timeout), never stranding the caller; only
  idempotent asks (park, stats) get one backoff'd retry.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, Optional

import numpy as np

from vtpu_torch.serving.fabric.transport import Channel, TransportError
from vtpu_torch.serving.fabric.wire import PROTO_VERSION, ProtocolError

#: asks safe to re-send after a dropped reply: re-parking a parked
#: session and re-reading stats are no-ops; migrate_* are NOT (a
#: duplicated migrate_out could fork a stream) and never retry.
_IDEMPOTENT_OPS = ("park", "stats")

#: minimum spacing between cancel retransmits for one session — cancels
#: re-send until the terminal arrives, so one swallowed by a partition
#: is replayed after heal instead of leaving the host decoding forever
_CANCEL_RESEND_S = 0.25


class _Session:
    """Client-side mirror of one remote stream: the real ``Request`` the
    caller iterates, the prompt, every generated token seen so far, and
    the in-order delivery cursor."""

    __slots__ = ("req", "eng", "cid", "rid", "prompt", "gen", "budget",
                 "next_seq", "buf", "done", "cancel_last",
                 "last_gap_req", "ack_floor", "pid", "prefix_len")

    def __init__(self, req, eng, cid, prompt, budget):
        self.req = req
        self.eng = eng
        self.cid = cid
        self.rid = -1
        self.prompt = list(prompt)
        self.gen: list = []
        self.budget = int(budget)
        self.next_seq = 0     # next in-order seq expected from the host
        self.buf: dict = {}   # out-of-order arrivals awaiting the gap
        self.done = False
        self.cancel_last = 0.0  # monotonic stamp of the last SENT cancel
        self.last_gap_req = 0.0
        self.ack_floor = 0    # last cumulative ack piggybacked on a ping
        self.pid: Optional[str] = None  # content pid of a shared prefix
        self.prefix_len = 0   # its token length (rides the ledger meta)


class _PendingAsk:
    __slots__ = ("ev", "result", "payload", "error", "etype")

    def __init__(self):
        self.ev = threading.Event()
        self.result = None
        self.payload = None
        self.error: Optional[str] = None
        self.etype: Optional[str] = None


class HostClient:
    """One channel to one EngineHost; builds and serves the
    ``RemoteEngine`` proxies for every engine the host advertises."""

    def __init__(self, chan: Channel, host: str = "remote",
                 ping_interval_s: float = 0.01, proc=None):
        self.chan = chan
        self.host = host
        self.proc = proc  # optional child Popen, for close()
        self.ping_interval_s = float(ping_interval_s)
        self._mu = threading.Lock()
        self._sessions: Dict[int, _Session] = {}
        self._cid_ctr = itertools.count(1)
        self._tid_ctr = itertools.count(1)
        self._asks: Dict[int, _PendingAsk] = {}
        self._stop = threading.Event()
        self._broken = False
        self.engines: Dict[str, "RemoteEngine"] = {}
        self.rtt_ms: Optional[float] = None
        self.gbps: Optional[float] = None
        self._last_pong_ns = 0
        self._rx: Optional[threading.Thread] = None
        self._px: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def connect(self, timeout: float = 120.0) -> Dict[str, "RemoteEngine"]:
        """Hello handshake, then start the receiver/pinger threads and
        return the RemoteEngine proxies. A version mismatch surfaces as
        a typed ProtocolError (the host refuses and closes)."""
        self.chan.send({"kind": "hello", "proto": PROTO_VERSION})
        deadline = time.monotonic() + timeout
        while True:
            if time.monotonic() > deadline:
                raise TransportError(
                    f"hello handshake timed out after {timeout}s")
            msg, _ = self.chan.recv(timeout=0.2)
            if msg is None:
                continue
            kind = msg.get("kind")
            if kind == "refuse":
                raise ProtocolError(
                    f"host refused the connection: {msg.get('reason')}")
            if kind == "hello_ok":
                if msg.get("proto") != PROTO_VERSION:
                    raise ProtocolError(
                        f"host answered hello with protocol "
                        f"{msg.get('proto')!r}, expected {PROTO_VERSION}")
                break
            # anything else pre-handshake is a protocol violation
            raise ProtocolError(
                f"expected hello_ok, got {kind!r} before the handshake")
        for name, geom in msg["engines"].items():
            self.engines[name] = RemoteEngine(self, name, geom)
        self._rx = threading.Thread(target=self._recv_loop, daemon=True,
                                    name=f"fabric-rx-{self.host}")
        self._px = threading.Thread(target=self._ping_loop, daemon=True,
                                    name=f"fabric-ping-{self.host}")
        self._rx.start()
        self._px.start()
        return dict(self.engines)

    def close(self) -> None:
        self._stop.set()
        try:
            self.chan.close()
        except Exception:
            pass
        self._fail_pending("fabric client closed")
        if self.proc is not None:
            try:
                self.proc.terminate()
                self.proc.wait(timeout=10)
            except Exception:
                try:
                    self.proc.kill()
                except Exception:
                    pass

    @property
    def link_ok(self) -> bool:
        return not self._broken and not self.chan.closed \
            and not self._stop.is_set()

    def fabric_stats(self) -> dict:
        c = dict(self.chan.counters)
        c["rtt_ms"] = self.rtt_ms
        c["gbps"] = self.gbps
        c["link_ok"] = self.link_ok
        return c

    # ------------------------------------------------------------- receive

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                msg, payload = self.chan.recv(timeout=0.05)
            except TransportError:
                self._broken = True
                self._fail_pending("fabric link down mid-ask")
                return
            if msg is None:
                continue
            try:
                self._dispatch(msg, payload)
            except Exception:  # a bad frame must not kill delivery
                pass

    def _dispatch(self, msg: dict, payload) -> None:
        kind = msg.get("kind")
        if kind in ("tok", "end"):
            with self._mu:
                sess = self._sessions.get(int(msg["cid"]))
            if sess is not None:
                self._ingest(sess, msg)
            else:
                # no mirror for this cid (submit-timeout race, a mirror
                # dropped before the host settled): answer with a cancel
                # so the host retires the orphan session instead of
                # retaining its outbox for the channel's lifetime
                try:
                    self.chan.send({"kind": "cancel",
                                    "cid": int(msg["cid"])})
                except TransportError:
                    self._broken = True
        elif kind == "pong":
            self._on_pong(msg)
        elif kind == "ask_reply":
            with self._mu:
                pend = self._asks.pop(int(msg["ticket"]), None)
            if pend is not None:
                pend.result = msg.get("result")
                pend.payload = payload
                pend.error = msg.get("error")
                pend.etype = msg.get("etype")
                pend.ev.set()
        elif kind == "submitted":
            with self._mu:
                sess = self._sessions.get(int(msg["cid"]))
            if sess is not None:
                sess.rid = int(msg["rid"])
                sess.budget = int(msg.get("max_new", sess.budget))
                sess.req._fabric_ack.set()
        elif kind == "refused":
            with self._mu:
                sess = self._sessions.pop(int(msg["cid"]), None)
            if sess is not None:
                sess.req._fabric_err = (msg.get("etype"),
                                        msg.get("error", "refused"))
                sess.req._fabric_ack.set()

    def _ingest(self, sess: _Session, msg: dict) -> None:
        """In-order, exactly-once: deliver at the cursor, buffer ahead of
        it, drop behind it (duplicates from a resend overlap)."""
        seq = int(msg["seq"])
        if seq < sess.next_seq:
            return  # duplicate — already delivered
        if seq > sess.next_seq:
            sess.buf[seq] = msg
            self._maybe_request_resend(sess)
            return
        self._deliver(sess, msg)
        sess.next_seq += 1
        while sess.next_seq in sess.buf:
            self._deliver(sess, sess.buf.pop(sess.next_seq))
            sess.next_seq += 1

    def _deliver(self, sess: _Session, msg: dict) -> None:
        with sess.eng._deliver_mu:
            self._deliver_locked(sess, msg)

    def _deliver_locked(self, sess: _Session, msg: dict) -> None:
        eng = sess.eng
        req = sess.req
        if sess.done:
            return
        if msg["kind"] == "end":
            sess.done = True
            # a fenced engine's terminal must NOT finish the request:
            # the fleet has moved the stream to a survivor
            if eng._stop.is_set():
                return
            status = msg["status"]
            if req.finish(status):
                from vtpu_torch.obs.trace import TERMINAL_CODES
                eng.trace.record("retire", sess.rid, -1,
                                 TERMINAL_CODES.get(status, 0))
            return
        if eng._stop.is_set():
            return  # fenced mid-failover: the survivor re-delivers
        tok = int(msg["t"])
        first = not sess.gen
        sess.gen.append(tok)
        sess.budget -= 1
        eng.trace.record("first_token" if first else "token",
                         sess.rid, -1)
        req.delivered += 1
        req.out.put(tok)
        hook = eng._ledger_hook
        if hook is not None:
            hook(eng)

    def _maybe_request_resend(self, sess: _Session) -> None:
        now = time.monotonic()
        if now - sess.last_gap_req < 0.05:
            return
        sess.last_gap_req = now
        self.chan.counters["resends"] += 1
        try:
            self.chan.send({"kind": "resend", "cid": sess.cid,
                            "from": sess.next_seq})
        except TransportError:
            self._broken = True

    # ---------------------------------------------------------- heartbeats

    def _on_pong(self, msg: dict) -> None:
        self._broken = False  # a pong proves the link
        now = time.monotonic_ns()
        self._last_pong_ns = now
        t0 = msg.get("t")
        if t0 is not None:
            # the serving-plane sibling of vtpu/plugin/dcnprobe.py's
            # node-level DCN scores: the same link the prober annotates
            # for gang placement, measured here PER fabric connection
            # off the heartbeats already flowing, surfaced as
            # EngineSignals.fabric_rtt_ms / fabric_gbps so RoutePolicy
            # can prefer DCN-near members without extra probe traffic
            rtt = (now - int(t0)) / 1e6
            self.rtt_ms = rtt if self.rtt_ms is None \
                else 0.8 * self.rtt_ms + 0.2 * rtt
        beats = msg.get("beats") or {}
        sigs = msg.get("signals") or {}
        draining = msg.get("draining") or {}
        for name, eng in self.engines.items():
            age_ms = beats.get(name)
            if age_ms is None:
                continue
            if age_ms < 0:
                eng._beat_ns = 0  # still warming host-side
            else:
                # host-reported age, anchored at LOCAL pong receipt: a
                # dead link stops pongs and the beat ages here exactly
                # like a hung engine's would — same ladder, one probe
                eng._beat_ns = now - int(age_ms * 1e6)
            d = sigs.get(name)
            if d is not None:
                eng._note_signals(d)
            eng._remote_draining = bool(draining.get(name))
        # gap detection via the host's high-water marks: covers a stream
        # whose LAST message (the terminal) was swallowed by a partition
        hi = msg.get("hi") or {}
        with self._mu:
            sessions = list(self._sessions.values())
        for sess in sessions:
            h = hi.get(str(sess.cid), hi.get(sess.cid))
            if h is not None and int(h) > sess.next_seq \
                    and not sess.done:
                self._maybe_request_resend(sess)

    def _ping_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.ping_interval_s)
            with self._mu:
                sessions = list(self._sessions.items())
            now = time.monotonic()
            acks = {}
            cancels = []
            drop = []
            for cid, sess in sessions:
                if sess.next_seq > sess.ack_floor:
                    acks[cid] = sess.next_seq
                    sess.ack_floor = sess.next_seq
                if sess.done and sess.next_seq <= sess.ack_floor:
                    drop.append(cid)
                req = sess.req
                # re-send until the terminal arrives: a cancel can be
                # swallowed by a partition without a send error, so a
                # one-shot latch would leave the host decoding a
                # cancelled/fenced stream forever
                if not sess.done and (
                        req.cancelled or sess.eng._stop.is_set()) \
                        and now - sess.cancel_last >= _CANCEL_RESEND_S:
                    cancels.append((cid, sess))
            if drop:
                with self._mu:
                    for cid in drop:
                        self._sessions.pop(cid, None)
            for cid, sess in cancels:
                try:
                    self.chan.send({"kind": "cancel", "cid": cid})
                    sess.cancel_last = now  # latched only once SENT
                except TransportError:
                    self._broken = True
                    break  # link down: the rest retry next tick
            try:
                self.chan.send({"kind": "ping",
                                "t": time.monotonic_ns(), "acks": acks})
            except TransportError:
                self._broken = True

    # ----------------------------------------------------------------- asks

    def _fail_pending(self, reason: str) -> None:
        with self._mu:
            pending = list(self._asks.values())
            self._asks.clear()
        for pend in pending:
            pend.error = reason
            pend.etype = "TransportError"
            pend.ev.set()

    def ask(self, op: str, msg: dict, timeout: float,
            payload=None):
        """One lifecycle ask over the wire. Fails typed
        (``MigrationError``) the moment the link is known dead or the
        per-ask timeout lapses; idempotent ops get ONE backoff'd retry.
        Returns ``(result, payload)``."""
        from vtpu_torch.serving.migrate import MigrationError

        attempts = 2 if op in _IDEMPOTENT_OPS else 1
        last: Optional[Exception] = None
        for attempt in range(attempts):
            if attempt:
                self.chan.counters["retries"] += 1
                time.sleep(min(0.2 * attempt, 1.0))
            if not self.link_ok:
                raise MigrationError(
                    f"{op} failed: fabric link to {self.host} is down")
            tid = next(self._tid_ctr)
            pend = _PendingAsk()
            with self._mu:
                self._asks[tid] = pend
            wire = dict(msg)
            # the host serves under a SHORTER budget than the client
            # waits: a migrate_out completing near the deadline gets its
            # typed reply back before the client abandons the ticket —
            # an abandoned-but-served migrate_out would leave the stream
            # pumpless with no terminal and no failover trigger
            wire.update({"kind": "ask", "op": op, "ticket": tid,
                         "timeout": max(timeout * 0.8, timeout - 5.0)})
            try:
                if payload is not None:
                    t0 = time.monotonic()
                    self.chan.send(wire, payload)
                    dt = time.monotonic() - t0
                    nbytes = sum(int(a.nbytes) for a in payload.values())
                    if dt > 0 and nbytes:
                        g = nbytes * 8 / dt / 1e9
                        self.gbps = g if self.gbps is None \
                            else 0.5 * self.gbps + 0.5 * g
                else:
                    self.chan.send(wire)
            except TransportError as exc:
                self._broken = True
                with self._mu:
                    self._asks.pop(tid, None)
                last = MigrationError(f"{op} failed to send: {exc}")
                continue
            if not pend.ev.wait(timeout):
                self.chan.counters["timeouts"] += 1
                with self._mu:
                    self._asks.pop(tid, None)
                last = MigrationError(
                    f"{op} timed out after {timeout}s on the fabric")
                continue
            if pend.error is not None:
                # the host served the ask and failed it — typed, and
                # NEVER retried (the failure is semantic, not transport)
                raise MigrationError(
                    f"{op} failed on {self.host}: "
                    f"[{pend.etype}] {pend.error}")
            return pend.result, pend.payload
        raise last if last is not None else MigrationError(
            f"{op} failed on the fabric")

    # -------------------------------------------------------------- streams

    def open_session(self, req, eng: "RemoteEngine", prompt,
                     budget: int) -> _Session:
        cid = next(self._cid_ctr)
        sess = _Session(req, eng, cid, prompt, budget)
        with self._mu:
            self._sessions[cid] = sess
        return sess

    def drop_session(self, cid: int) -> None:
        with self._mu:
            self._sessions.pop(cid, None)

    def sessions_of(self, eng: "RemoteEngine") -> list:
        with self._mu:
            return [s for s in self._sessions.values() if s.eng is eng]


class _StopWaiter(threading.Thread):
    """A joinable stand-in for a local engine's loop thread: the fleet's
    fence is ``_stop.set(); _thread.join(timeout)`` — for a proxy there
    is no loop to join, only the stop event to observe, and a delivery
    already past its stop check (``gate``, held by ``_deliver``) to let
    land, its ledger record included: the fence then reads a ledger that
    holds exactly the tokens the client got."""

    def __init__(self, stop_ev: threading.Event, gate, name: str):
        super().__init__(daemon=True, name=name)
        self._ev = stop_ev
        self._gate = gate

    def run(self) -> None:
        self._ev.wait()

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if self._gate.acquire(timeout=-1 if timeout is None else timeout):
            self._gate.release()


class RemoteEngine:
    """Duck-typed fleet member backed by an engine across the fabric.

    Carries the exact attribute surface ``EngineFleet``/``migrate.py``
    touch on a member: ``_swap_enabled``/``_disagg``/``mesh``/``_page``/
    ``_swap_planes``/``_plane_shapes``/``_plane_dtypes``/``_block_bytes``
    for the compat gate (from the host's advertised geometry), ``_beat_ns`` for the probe ladder,
    ``_stop``/``_wake``/``_thread`` for the fence, ``_died``/
    ``_draining`` for routability, ``trace`` (a real client-side
    ``RequestTrace`` fed by wire deliveries, so journey stitching and
    blackout spans work unchanged), plus the dispatch hooks the fleet
    prefers when present: ``ledger_entries()``, ``live_sessions()``,
    ``fleet_reap()``, ``ask()``."""

    is_remote = True

    def __init__(self, client: HostClient, name: str, geom: dict):
        from vtpu_torch.obs.trace import RequestTrace

        self._client = client
        self.name = name
        self.host = client.host
        # --- advertised geometry: what _compat_check compares
        self._page = int(geom["page"])
        self._swap_planes = tuple(geom["planes"])
        self._plane_shapes = {k: tuple(int(x) for x in v)
                              for k, v in geom["plane_shapes"].items()}
        self._plane_dtypes = dict(geom["plane_dtypes"])
        self._block_bytes = int(geom["block_bytes"])
        self._swap_enabled = True
        self._disagg = None
        self.mesh = None  # no pool here: the host's engine moves the payload
        # --- fleet member surface
        self._beat_ns = 0
        self._died = False
        self._stop = threading.Event()
        self._wake = threading.Event()
        # one delivery at a time against the fence (_StopWaiter.join)
        self._deliver_mu = threading.RLock()
        self._thread = _StopWaiter(self._stop, self._deliver_mu, f"remote-{name}")
        self._thread.start()
        self._ledger_hook = None
        self.trace = RequestTrace(capacity=16384)
        self._remote_draining = False
        self._want_draining = False
        self._sig_cache: Optional[dict] = None
        self._sig_ns = 0
        self._stats_cache: dict = {}
        self._parked: Dict[object, dict] = {}
        # client-side mirror of prefixes registered on the REMOTE engine:
        # {lid: {"pid","tokens","len","build_ms"}} — what a prefix submit
        # resolves (the suffix crosses the wire, the full prompt seeds
        # the session mirror) and what the fleet's directory reports for
        # a remote member (its host-side listener reports elsewhere)
        self._prefix_meta: Dict[int, dict] = {}

    # ------------------------------------------------------------- routing

    @property
    def _draining(self) -> bool:
        return self._want_draining or self._remote_draining

    @_draining.setter
    def _draining(self, on: bool) -> None:
        self._want_draining = bool(on)
        try:
            self._client.chan.send({"kind": "set_draining",
                                    "eng": self.name, "on": bool(on)})
        except TransportError:
            pass  # the pong's draining echo reconciles on heal

    def _note_signals(self, d: dict) -> None:
        self._sig_cache = d
        self._sig_ns = time.monotonic_ns()

    def signals(self):
        from vtpu_torch.serving.shed import EngineSignals

        base = EngineSignals.from_dict(self._sig_cache) \
            if self._sig_cache else EngineSignals(
                queue_depth=0, active_slots=0, pool_free=0,
                pool_used_hwm=0, parked_sessions=0, prefill_backlog=0,
                now_ns=0)
        return dataclasses.replace(
            base, now_ns=time.monotonic_ns(), draining=self._draining,
            fabric_rtt_ms=self._client.rtt_ms,
            fabric_gbps=self._client.gbps)

    def stats(self) -> dict:
        try:
            result, _ = self._client.ask(
                "stats", {"eng": self.name}, timeout=2.0)
            self._stats_cache = dict(result)
        except Exception:
            pass  # a dead link serves the last snapshot
        out = dict(self._stats_cache)
        out.setdefault("active_slots", 0)
        out.setdefault("parked_sessions", 0)
        out.setdefault("queued", 0)
        out.setdefault("admitting_slots", 0)
        out["fabric_link_ok"] = self._client.link_ok
        out["fabric_host"] = self.host
        return out

    def fabric_stats(self) -> dict:
        return self._client.fabric_stats()

    # -------------------------------------------------------------- submit

    def submit(self, tokens, max_new_tokens: int = 0,
               prefix=None, priority: int = 0,
               deadline_ms: Optional[float] = None):
        from vtpu_torch.serving.engine import Request

        if self._stop.is_set() or self._died:
            raise RuntimeError(f"remote engine {self.name} is fenced")
        if self._draining:
            raise RuntimeError(f"remote engine {self.name} is draining")
        if not self._client.link_ok:
            raise RuntimeError(
                f"fabric link to {self.host} is down")
        pm = None
        if prefix is not None:
            pm = self._prefix_meta.get(int(prefix))
            if pm is None:
                raise ValueError(
                    f"unknown prefix id {prefix!r} on remote engine "
                    f"{self.name}")
        suffix = [int(t) for t in list(tokens)] \
            if not hasattr(tokens, "tolist") else \
            [int(t) for t in tokens.tolist()]
        # the mirror's prompt is the FULL history (prefix + suffix): the
        # ledger rebuild must replay the whole sequence on a survivor
        # even though only the suffix crosses the wire here
        prompt = (list(pm["tokens"]) + suffix) if pm is not None \
            else suffix
        req = Request(tokens=np.asarray(suffix, np.int32),
                      max_new_tokens=int(max_new_tokens),
                      priority=int(priority))
        req.t_submit_ns = time.monotonic_ns()
        if deadline_ms is not None:
            req.deadline_ns = req.t_submit_ns + int(deadline_ms * 1e6)
        req._fabric_ack = threading.Event()
        req._fabric_err = None
        sess = self._client.open_session(req, self, prompt,
                                         max_new_tokens)
        if pm is not None:
            sess.pid = pm["pid"]
            sess.prefix_len = int(pm["len"])
        try:
            self._client.chan.send({
                "kind": "submit", "cid": sess.cid, "eng": self.name,
                "tokens": suffix, "max_new": int(max_new_tokens),
                "prefix": int(prefix) if prefix is not None else None,
                "priority": int(priority), "deadline_ms": deadline_ms})
        except TransportError as exc:
            self._client.drop_session(sess.cid)
            raise RuntimeError(
                f"fabric submit to {self.name} failed: {exc}") from None
        if not req._fabric_ack.wait(30.0):
            self._client.drop_session(sess.cid)
            try:  # the host may land it later: make sure it dies there
                self._client.chan.send({"kind": "cancel",
                                        "cid": sess.cid})
            except TransportError:
                pass
            raise RuntimeError(
                f"fabric submit to {self.name} timed out")
        if req._fabric_err is not None:
            etype, err = req._fabric_err
            self._client.drop_session(sess.cid)
            if etype == "ValueError":
                raise ValueError(err)
            raise RuntimeError(err)
        req.rid = sess.rid
        self.trace.record("submit", sess.rid, -1, len(prompt))
        return req

    # -------------------------------------------------------------- prefixes

    def register_prefix(self, prefix_tokens) -> int:
        """Build a shared prefix on the remote engine (its loop thread
        runs the chunked prefill) and mirror the registration client-
        side so prefix submits and the fleet directory can resolve it."""
        toks = [int(t) for t in (prefix_tokens.tolist()
                                 if hasattr(prefix_tokens, "tolist")
                                 else list(prefix_tokens))]
        result, _ = self._client.ask(
            "register_prefix", {"eng": self.name, "tokens": toks},
            timeout=120.0)
        lid = int(result["lid"])
        self._prefix_meta[lid] = {"pid": result["pid"], "tokens": toks,
                                  "len": int(result["len"]),
                                  "build_ms": result.get("build_ms")}
        return lid

    def unregister_prefix(self, lid: int) -> None:
        self._prefix_meta.pop(int(lid), None)
        self._client.ask("unregister_prefix",
                         {"eng": self.name, "lid": int(lid)},
                         timeout=30.0)

    # ------------------------------------------------- lifecycle / tickets

    def _session_for(self, req):
        for sess in self._client.sessions_of(self):
            if sess.req is req:
                return sess
        return None

    def ask(self, kind: str, ticket, timeout: float):
        """The fleet/migrate `_ask` dispatch target: serve a lifecycle
        ticket across the wire, returning the same result shapes the
        local lifecycle queue produces."""
        from vtpu_torch.serving.migrate import MigrationError

        req = ticket.req
        if kind == "migrate_out":
            sess = self._session_for(req)
            if sess is None:
                raise MigrationError(
                    f"request has no live session on {self.name}")
            result, payload = self._client.ask(
                "migrate_out", {"eng": self.name, "cid": sess.cid},
                timeout)
            if result["status"] in ("ok", "completed", "cancelled",
                                    "gone"):
                self._client.drop_session(sess.cid)
                self._parked.pop(req, None)
            return {"status": result["status"], "meta": result["meta"],
                    "payload": payload,
                    "src_died": result["src_died"]}
        if kind == "migrate_in":
            meta = ticket.meta
            history = [int(t) for t in meta["tokens"]]
            prompt = list(req.tokens.tolist()) \
                if hasattr(req.tokens, "tolist") else \
                [int(t) for t in req.tokens]
            sess = self._client.open_session(
                req, self, prompt,
                meta.get("budget", req.max_new_tokens))
            # seed the mirror with history already generated pre-hop so
            # the ledger meta stays exact if THIS engine later dies too
            sess.gen = list(history[len(prompt):])
            if not meta.get("unstarted") \
                    and meta.get("pending") is not None:
                sess.gen.append(int(meta["pending"]))
            sess.budget = int(meta.get("budget", sess.budget))
            try:
                result, _ = self._client.ask(
                    "migrate_in",
                    {"eng": self.name, "cid": sess.cid,
                     "meta": dict(meta), "prompt": sess.prompt,
                     "max_new": int(req.max_new_tokens)},
                    timeout, payload=ticket.payload)
            except MigrationError:
                self._client.drop_session(sess.cid)
                raise
            sess.rid = int(result["rid"])
            req.rid = sess.rid
            return {"path": result["path"]}
        if kind == "prefix_out":
            # payload-carrying export: the staged D2H gather runs on the
            # host; the KV pages + logits plane ride back CRC-chunked
            result, payload = self._client.ask(
                "prefix_out",
                {"eng": self.name, "lid": int(ticket.meta["lid"])},
                timeout)
            return {"meta": result["meta"], "payload": payload}
        if kind == "prefix_in":
            meta = ticket.meta
            result, _ = self._client.ask(
                "prefix_in", {"eng": self.name, "meta": dict(meta)},
                timeout, payload=ticket.payload)
            lid = int(result["lid"])
            self._prefix_meta[lid] = {
                "pid": result["pid"], "tokens": list(meta["tokens"]),
                "len": int(meta["len"]), "build_ms": None}
            return {"lid": lid, "pid": result["pid"],
                    "installed": bool(result.get("installed", True))}
        raise MigrationError(
            f"unsupported remote lifecycle ticket {kind!r}")

    def park(self, req) -> None:
        """Synchronous proxy park: migrate.py polls ``_parked`` after
        calling this, so the ask completes (or fails typed) inline and
        the mirror is populated before return."""
        sess = self._session_for(req)
        if sess is None:
            return
        result, _ = self._client.ask(
            "park", {"eng": self.name, "cid": sess.cid}, timeout=30.0)
        if result.get("parked"):
            self._parked[req] = {
                "unstarted": bool(result.get("unstarted"))}

    def resume(self, req) -> None:
        sess = self._session_for(req)
        self._parked.pop(req, None)
        if sess is None:
            return
        try:
            self._client.chan.send({"kind": "resume", "cid": sess.cid})
        except TransportError as exc:
            from vtpu_torch.serving.migrate import MigrationError
            raise MigrationError(
                f"resume on {self.name} failed: {exc}") from None

    # ---------------------------------------------------- fleet dispatches

    def ledger_entries(self) -> dict:
        """The client-mirror ledger: exact migrate-meta for every live
        stream, derived from tokens ACTUALLY delivered across the wire.
        Payload-less by construction — the fleet's rebuild recomputes
        from this history, which is what makes a host SIGKILL
        token-lossless."""
        out = {}
        for sess in self._client.sessions_of(self):
            req = sess.req
            if sess.done or req.status is not None or req.cancelled:
                continue
            g = len(sess.gen)
            if g == 0:
                continue  # unstarted: the fleet requeues from _assigned
            toks = sess.prompt + sess.gen[:-1]
            seq_len = len(toks)
            budget = max(int(sess.budget), 0)
            n_pages = -(-(seq_len + budget + 1) // self._page)
            out[req] = {
                "unstarted": False, "tokens": list(toks),
                "pending": int(sess.gen[-1]), "budget": budget,
                "seq_len": seq_len, "n_pages": n_pages,
                "hist_exact": True, "priority": int(req.priority),
                "pid": sess.pid, "prefix_len": int(sess.prefix_len),
            }
        return out

    def live_sessions(self) -> list:
        out = [s.req for s in self._client.sessions_of(self)
               if not s.done and s.req.status is None]
        for req in self._parked:
            if req.status is None and req not in out:
                out.append(req)
        return out

    def fleet_reap(self, finisher) -> None:
        """The fleet's post-failover reap, proxy-shaped: every mirror
        session is finished through the fleet's spared/unspared closure
        and cancelled host-side best-effort."""
        for sess in self._client.sessions_of(self):
            self._client.drop_session(sess.cid)
            if not sess.done:
                try:
                    self._client.chan.send({"kind": "cancel",
                                            "cid": sess.cid})
                except TransportError:
                    pass
            finisher(sess.req)
        for req in list(self._parked):
            self._parked.pop(req, None)
            finisher(req)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        try:
            self._client.chan.send({"kind": "stop_eng",
                                    "eng": self.name})
        except TransportError:
            pass
        for sess in self._client.sessions_of(self):
            self._client.drop_session(sess.cid)
            if not sess.done and sess.req.status is None:
                from vtpu_torch.serving.engine import Status
                sess.req.finish(Status.CANCELLED)


def connect_host(chan: Channel, host: str = "remote", proc=None,
                 ping_interval_s: float = 0.01,
                 timeout: float = 120.0):
    """Dial + handshake in one call: returns ``(client, engines)``."""
    client = HostClient(chan, host=host, proc=proc,
                        ping_interval_s=ping_interval_s)
    engines = client.connect(timeout=timeout)
    return client, engines
