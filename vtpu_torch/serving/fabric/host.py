"""EngineHost: one or more of the port's ServingEngines behind the fabric
wire protocol (the port's copy of vtpu/serving/fabric/host.py).

The server half of the fabric. An ``EngineHost`` owns ``{name:
ServingEngine}`` (all in THIS process) and serves one client channel:
hello/version handshake, submits, per-session token streaming, lifecycle
asks (park / migrate_out / migrate_in / stats / the prefix asks),
heartbeat pongs carrying every engine's beat age + ``EngineSignals``, and
cancel/resume/drain control. Run in-proc over a loopback channel (the
tests' workhorse) or as a child process over TCP (``python -m
vtpu_torch.serving.fabric.host --spec ...``, the SIGKILL target of the
fleet's failover), whose engines run on the card unless the spec says
``"device": "cpu"``.

Delivery is exactly-once and in-order per session: every ``tok``/``end``
message carries a per-session sequence number and is kept in an outbox
until the client's cumulative ack (piggybacked on pings) covers it; a
client that detects a gap (message loss, partition) asks for a ``resend``
and drops duplicates by seq, so a network blip can delay tokens, never
double-deliver or reorder them.

Ownership: the host-side ``Request`` objects here are SERVER mirrors; the
client ``Request`` whose ``stream()`` a user iterates lives on the
RemoteEngine side, and tokens cross the wire to reach it. A channel that
dies takes its sessions with it: the host cancels them (their client is
unreachable and the fleet has rebuilt the streams on survivors, so the
host-side cancel is what prevents a fork).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from vtpu_torch.serving.fabric.transport import Channel, TcpChannel, TransportError
from vtpu_torch.serving.fabric.wire import PROTO_VERSION, json_safe

log = logging.getLogger(__name__)

#: pump sentinel: stop streaming a session WITHOUT sending a terminal
#: (the session migrated off this host and its stream continues elsewhere)
_PUMP_STOP = object()

#: a done session whose final ack never arrives (lost ack ping, client
#: mirror dropped in a submit-timeout race) is reaped after this long:
#: longer than any partition the fleet's ladder survives without
#: failover, so a terminal is never reaped while a live client could
#: still ask for its resend
_ACK_IDLE_REAP_S = 30.0


def _engine_geom(eng) -> dict:
    """The compat-check geometry a RemoteEngine advertises in the fleet:
    page size, KV plane names, per-block plane shapes (whole heads under a
    mesh) and dtypes (what ``migrate._compat_check`` compares), block
    bytes."""
    from vtpu_torch.serving.engine import block_geometry

    shapes, dtypes = {}, {}
    for key in eng._swap_planes:
        shapes[key] = list(block_geometry(eng.state[key], eng.mesh))
        dtypes[key] = str(eng.state[key].dtype).removeprefix("torch.")
    return {"page": int(eng._page), "planes": list(eng._swap_planes),
            "plane_shapes": shapes, "plane_dtypes": dtypes,
            "block_bytes": int(eng._block_bytes)}


def reap_corpse(eng) -> None:
    """Host-side post-mortem reclamation of a died engine's resources:
    the host process is the corpse's supervisor, as the fleet's ``_reap``
    is a local member's, and runs the same sweep. Deliberately SILENT: no
    terminals are delivered and nothing is sent to the client (a died
    engine's remote clients must observe SIGKILL semantics, silence, so the
    fleet's ledger-driven failover, not a typed error, recovers the
    streams). The serve loop stops the corpse's pumps separately."""
    from vtpu_torch.serving.fleet import sweep_corpse

    sweep_corpse(eng)


def _park_settled(eng, req) -> bool:
    """Whether a park asked of ``eng`` has taken effect: the loop took the
    command and the session sits in the parked set with no park or resume
    pending. The parked set alone answers too early for a session a
    migration just installed and resumed: it is still parked until its
    resume advances, and a park applied after that parks it again only at a
    later tick head, where an extract asked meanwhile would find nothing."""
    with eng._lifecycle_q.mutex:
        if any(kind == "park" and item is req for kind, item in eng._lifecycle_q.queue):
            return False
    return (req in eng._parked and req not in eng._want_park
            and req not in eng._want_resume)


class EngineHost:
    """Serve a dict of started ServingEngines over one fabric channel."""

    def __init__(self, engines: Dict[str, object]):
        if not engines:
            raise ValueError("EngineHost needs at least one engine")
        self.engines = dict(engines)
        self._stop_ev = threading.Event()
        self._reap_mu = threading.Lock()
        self._reaped: set = set()

    def stop(self) -> None:
        self._stop_ev.set()

    # ------------------------------------------------------------- serving

    def serve_channel(self, chan: Channel) -> None:
        """Blocking dispatch loop for one client channel; returns when
        the channel dies or the host stops. Sessions created on this
        channel are cancelled on exit (their client is unreachable)."""
        from vtpu_torch.serving.engine import Request, Status, Terminal
        from vtpu_torch.serving.migrate import MigrationError, _ask, _Ticket

        mu = threading.Lock()
        sessions: Dict[int, dict] = {}

        def send(msg, payload=None):
            try:
                chan.send(msg, payload)
                return True
            except TransportError:
                return False

        def send_seq(sess, msg):
            """Assign the session's next seq, retain in the outbox, ship."""
            with mu:
                msg["seq"] = sess["seq"]
                sess["seq"] += 1
                sess["outbox"].append(msg)
            send(msg)

        def pump(cid):
            """Per-session streamer: consume the host-side Request's out
            queue, forward each token / the typed terminal with a seq."""
            sess = sessions[cid]
            req = sess["req"]
            while not self._stop_ev.is_set():
                tok = req.out.get()
                if tok is _PUMP_STOP:
                    return  # migrated off this host: stream continues there
                if tok is None or isinstance(tok, Terminal):
                    status = tok.status if tok is not None \
                        else Status.CANCELLED
                    send_seq(sess, {"kind": "end", "cid": cid,
                                    "status": status})
                    sess["done"] = True
                    sess["done_at"] = time.monotonic()
                    return
                send_seq(sess, {"kind": "tok", "cid": cid, "t": int(tok)})

        def start_session(cid, eng_name, req):
            sess = {"req": req, "eng": eng_name, "seq": 0, "outbox": [],
                    "done": False, "done_at": None}
            with mu:
                sessions[cid] = sess
            t = threading.Thread(target=pump, args=(cid,), daemon=True)
            sess["pump"] = t
            t.start()
            return sess

        def serve_ask(msg, payload):
            """Lifecycle asks run off the dispatch thread: a park that
            waits for a flush boundary must not stall heartbeats."""
            tid = msg["ticket"]
            op = msg.get("op")
            timeout = float(msg.get("timeout", 30.0))
            out_payload = None
            try:
                eng = self.engines[msg["eng"]]
                if op == "stats":
                    result = json_safe(eng.stats())
                elif op == "park":
                    sess = sessions.get(msg["cid"])
                    if sess is None:
                        raise MigrationError(
                            f"unknown session cid={msg['cid']}")
                    req = sess["req"]
                    eng.park(req)
                    deadline = time.monotonic() + timeout
                    while (not _park_settled(eng, req)
                           and req.status is None
                           and time.monotonic() < deadline):
                        time.sleep(0.002)
                    entry = eng._parked.get(req)
                    result = {"parked": entry is not None,
                              "unstarted": bool(entry.get("unstarted"))
                              if entry is not None else False,
                              "status": req.status}
                elif op == "migrate_out":
                    sess = sessions.get(msg["cid"])
                    if sess is None:
                        raise MigrationError(
                            f"unknown session cid={msg['cid']}")
                    req = sess["req"]
                    res = _ask(eng, "migrate_out", _Ticket(req), timeout)
                    out_payload = res.get("payload")
                    result = {"status": res["status"],
                              "meta": res.get("meta"),
                              "src_died": bool(res.get("src_died"))}
                    if res["status"] in ("ok", "completed", "cancelled",
                                         "gone"):
                        # the session left this host (or settled): stop
                        # its pump without a terminal; the stream, if it
                        # lives, continues on the destination engine. The
                        # pump ships every token delivered before the
                        # extract first: the client drops the session's
                        # mirror on this reply, and a token that reached
                        # the wire after it would be lost
                        with mu:
                            sessions.pop(msg["cid"], None)
                        req.out.put(_PUMP_STOP)
                        sess["pump"].join(timeout)
                elif op == "migrate_in":
                    meta = msg["meta"]
                    req = Request(
                        tokens=np.asarray(msg["prompt"], np.int32),
                        max_new_tokens=int(msg["max_new"]),
                        priority=int(meta.get("priority", 0)))
                    req.t_submit_ns = time.monotonic_ns()
                    start_session(msg["cid"], msg["eng"], req)
                    try:
                        res = _ask(eng, "migrate_in",
                                   _Ticket(req, meta=dict(meta),
                                           payload=payload), timeout)
                    except MigrationError:
                        with mu:
                            sessions.pop(msg["cid"], None)
                        req.out.put(_PUMP_STOP)
                        raise
                    result = {"path": res["path"], "rid": int(req.rid)}
                elif op == "register_prefix":
                    # prefix-gravity build: the engine computes the KV on
                    # its loop thread (chunked prefill) and reports the
                    # content pid + build cost back for the directory
                    lid = eng.register_prefix(msg["tokens"])
                    ent = eng._prefixes[lid]
                    result = {"lid": int(lid), "pid": ent.get("pid"),
                              "len": int(ent["len"]),
                              "build_ms": ent.get("build_ms")}
                elif op == "unregister_prefix":
                    eng.unregister_prefix(int(msg["lid"]))
                    result = {"ok": True}
                elif op == "prefix_out":
                    res = _ask(eng, "prefix_out",
                               _Ticket(None, meta={"lid": int(msg["lid"])}),
                               timeout)
                    out_payload = res["payload"]
                    result = {"meta": res["meta"]}
                elif op == "prefix_in":
                    res = _ask(eng, "prefix_in",
                               _Ticket(None, meta=dict(msg["meta"]),
                                       payload=payload), timeout)
                    result = {"lid": int(res["lid"]), "pid": res["pid"],
                              "installed": bool(res.get("installed", True))}
                else:
                    raise MigrationError(f"unknown ask op {op!r}")
            except Exception as exc:  # typed reply, never a hang
                send({"kind": "ask_reply", "ticket": tid,
                      "error": str(exc), "etype": type(exc).__name__})
                return
            send({"kind": "ask_reply", "ticket": tid,
                  "result": result}, out_payload)

        def handle(msg, payload):
            kind = msg.get("kind")
            if kind == "ping":
                for cid, upto in (msg.get("acks") or {}).items():
                    sess = sessions.get(int(cid))
                    if sess is None:
                        continue
                    with mu:
                        sess["outbox"] = [m for m in sess["outbox"]
                                          if m["seq"] >= int(upto)]
                        if sess["done"] and not sess["outbox"]:
                            sessions.pop(int(cid), None)
                now = time.monotonic_ns()
                beats, sigs, draining = {}, {}, {}
                for name, eng in self.engines.items():
                    if eng._died:
                        # supervise the corpse: reclaim its resources
                        # once (silently: its clients must see SIGKILL
                        # semantics) and stop this channel's pumps for it
                        with self._reap_mu:
                            fresh = name not in self._reaped
                            self._reaped.add(name)
                        if fresh:
                            reap_corpse(eng)
                        with mu:
                            doomed = [c for c, s in sessions.items()
                                      if s["eng"] == name]
                            dead_sess = [sessions.pop(c) for c in doomed]
                        for s in dead_sess:
                            s["req"].out.put(_PUMP_STOP)
                    b = eng._beat_ns
                    beats[name] = -1.0 if b == 0 else (now - b) / 1e6
                    try:
                        sigs[name] = eng.signals().to_dict()
                    except Exception:
                        sigs[name] = None
                    draining[name] = bool(eng._draining)
                with mu:
                    hi = {cid: s["seq"] for cid, s in sessions.items()}
                send({"kind": "pong", "t": msg.get("t"), "beats": beats,
                      "signals": sigs, "draining": draining, "hi": hi,
                      "proto": PROTO_VERSION})
            elif kind == "resend":
                sess = sessions.get(int(msg["cid"]))
                if sess is not None:
                    with mu:
                        missing = [dict(m) for m in sess["outbox"]
                                   if m["seq"] >= int(msg["from"])]
                    for m in missing:
                        send(m)
            elif kind == "submit":
                cid = int(msg["cid"])
                try:
                    eng = self.engines[msg["eng"]]
                    req = eng.submit(
                        msg["tokens"],
                        max_new_tokens=int(msg.get("max_new", 0)),
                        prefix=msg.get("prefix"),
                        priority=int(msg.get("priority", 0)),
                        deadline_ms=msg.get("deadline_ms"))
                except (RuntimeError, ValueError) as exc:
                    send({"kind": "refused", "cid": cid, "error": str(exc),
                          "etype": type(exc).__name__})
                    return
                start_session(cid, msg["eng"], req)
                send({"kind": "submitted", "cid": cid, "rid": int(req.rid),
                      "max_new": int(req.max_new_tokens)})
            elif kind == "cancel":
                sess = sessions.get(int(msg["cid"]))
                if sess is not None:
                    sess["req"].cancel()
                    self.engines[sess["eng"]]._wake.set()
            elif kind == "resume":
                sess = sessions.get(int(msg["cid"]))
                if sess is not None:
                    self.engines[sess["eng"]].resume(sess["req"])
            elif kind == "set_draining":
                eng = self.engines.get(msg["eng"])
                if eng is not None:
                    eng._draining = bool(msg["on"])
            elif kind == "ask":
                threading.Thread(target=serve_ask, args=(msg, payload),
                                 daemon=True).start()
            elif kind == "stop_eng":
                eng = self.engines.get(msg["eng"])
                if eng is not None:
                    threading.Thread(target=eng.stop, daemon=True).start()
            elif kind == "hello":
                # a late/duplicate hello is answered idempotently
                self._answer_hello(chan, msg)

        try:
            # hello handshake first: an unversioned or mismatched peer is
            # refused TYPED and the channel closed, never half-served
            deadline = time.monotonic() + 30.0
            while not self._stop_ev.is_set():
                if time.monotonic() > deadline:
                    return
                msg, payload = chan.recv(timeout=0.1)
                if msg is None:
                    continue
                if msg.get("kind") != "hello":
                    continue
                if not self._answer_hello(chan, msg):
                    return
                break
            last_reap = time.monotonic()
            while not self._stop_ev.is_set():
                msg, payload = chan.recv(timeout=0.1)
                now = time.monotonic()
                if now - last_reap > 1.0:
                    # ack-idle reaper: acks normally trim done sessions,
                    # but a lost final ack or a client that never
                    # mirrored the cid would otherwise retain the
                    # session dict + outbox for the channel's lifetime
                    last_reap = now
                    with mu:
                        stale = [c for c, s in sessions.items()
                                 if s["done_at"] is not None
                                 and now - s["done_at"] > _ACK_IDLE_REAP_S]
                        for c in stale:
                            sessions.pop(c, None)
                if msg is None:
                    continue
                handle(msg, payload)
        except TransportError:
            pass
        finally:
            # the client is unreachable: cancel every session this
            # channel owned (the fleet has rebuilt / will rebuild the
            # streams on survivors; cancelling here prevents a fork)
            with mu:
                live = list(sessions.values())
                sessions.clear()
            for sess in live:
                sess["req"].cancel()
                eng = self.engines.get(sess["eng"])
                if eng is not None:
                    eng._wake.set()
                sess["req"].out.put(_PUMP_STOP)
            try:
                chan.close()
            except Exception:
                pass

    def _answer_hello(self, chan: Channel, msg: dict) -> bool:
        proto = msg.get("proto")
        if proto != PROTO_VERSION:
            try:
                chan.send({"kind": "refuse", "proto": PROTO_VERSION,
                           "reason": f"protocol version mismatch: host "
                                     f"speaks {PROTO_VERSION}, client "
                                     f"sent {proto!r}"})
            except TransportError:
                pass
            chan.close()
            return False
        try:
            chan.send({"kind": "hello_ok", "proto": PROTO_VERSION,
                       "engines": {n: _engine_geom(e)
                                   for n, e in self.engines.items()}})
        except TransportError:
            return False
        return True


# ------------------------------------------------------- child entrypoint


def build_engines_from_spec(spec: dict):
    """Construct (cfg, engines) from a JSON spec, the child-process half
    of ``spawn_host``: ``{"model": ModelConfig fields (dtype as a torch
    dtype name), "seed": the port's seeded init, "device": absent for the
    card or "cpu", "engines": {name: ServingConfig fields}}``. List-valued
    serving fields (prefill_buckets, ...) become tuples."""
    import torch

    from vtpu_torch.models import ModelConfig, init_params
    from vtpu_torch.serving import ServingConfig, ServingEngine

    mk = dict(spec["model"])
    mk["dtype"] = getattr(torch, mk.get("dtype", "float32"))
    cfg = ModelConfig(**mk)
    device = spec.get("device")
    params = init_params(int(spec.get("seed", 0)), cfg, device=device)
    engines = {}
    for name, kw in spec["engines"].items():
        kw = dict(kw)
        # deterministic seams ride the spec as FaultSpec dicts: a caller
        # throttles the child's decode (delayed_fetch) so a SIGKILL from
        # the parent lands mid-stream, not after a small model has already
        # finished into the socket buffer
        faults = kw.pop("faults", None)
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in kw.items()}
        if faults is not None:
            from vtpu_torch.serving.faults import FaultPlan, FaultSpec
            kw["faults"] = FaultPlan([FaultSpec(**f) for f in faults])
        engines[name] = ServingEngine(params, cfg, ServingConfig(**kw),
                                      device=device)
    return cfg, engines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fabric engine host (child process)")
    ap.add_argument("--spec", required=True,
                    help="JSON: {model, seed, device, engines:{name:serving_kw}}")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    # the first line on stdout is the port; everything else goes to stderr
    out, sys.stdout = sys.stdout, sys.stderr
    logging.basicConfig(stream=sys.stderr, level=logging.WARNING)
    spec = json.loads(args.spec)
    _, engines = build_engines_from_spec(spec)
    host = EngineHost(engines)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", args.port))
    srv.listen(4)
    # the port line is the parent's readiness signal for CONNECTING; the
    # engines' loops start behind it (an engine beats only once its loop
    # runs: the fleet's WARMING state covers the gap)
    print(json.dumps({"port": srv.getsockname()[1]}), file=out, flush=True)
    for eng in engines.values():
        eng.start()
    try:
        while True:
            conn, _ = srv.accept()
            threading.Thread(target=host.serve_channel,
                             args=(TcpChannel(conn),), daemon=True).start()
    except KeyboardInterrupt:
        pass
    finally:
        for eng in engines.values():
            eng.stop()
    return 0


def spawn_host(spec: dict, timeout: float = 120.0, env: Optional[dict] = None):
    """Launch a child engine-host process and return ``(proc, port)``.
    The child is a fresh interpreter (``python -m
    vtpu_torch.serving.fabric.host``: a process holding a CUDA context must
    not fork) that builds its engines, then prints its port as a JSON line
    once listening; its loops start behind the accept loop, its logs go to
    this process's stderr. ``env`` adds to this process's environment (the
    child's device is the spec's: no CPU default is set here)."""
    root = str(Path(__file__).resolve().parents[3])
    full = dict(os.environ)
    full.update(env or {})
    full["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, full.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "vtpu_torch.serving.fabric.host",
         "--spec", json.dumps(spec)],
        stdout=subprocess.PIPE, env=full, text=True)
    port_box: list = []

    def read_port():
        line = proc.stdout.readline()
        try:
            port_box.append(int(json.loads(line)["port"]))
        except Exception:
            port_box.append(None)

    t = threading.Thread(target=read_port, daemon=True)
    t.start()
    t.join(timeout)
    if not port_box or port_box[0] is None:
        proc.kill()
        proc.wait()
        raise TransportError(
            f"engine host child did not report a port within {timeout}s "
            f"(exit code {proc.poll()})")
    return proc, port_box[0]


if __name__ == "__main__":
    sys.exit(main())
