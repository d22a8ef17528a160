"""SWIM-style gossip membership: the rebuild's third communication plane.

The reference delegates membership to hashicorp/serf over memberlist
(reference: nomad/serf.go:16-180 consumes the events; vendored
hashicorp/memberlist implements the protocol). This is a from-scratch
implementation of the same capability — scalable weakly-consistent
membership with failure detection — built on the SWIM algorithm:

- **Probe loop**: each probe interval, one member is pinged over UDP;
  no ack within the timeout triggers indirect pings through k random
  peers; total failure marks the member *suspect*.
- **Suspicion**: a suspect member has `suspicion_mult * log(n)` probe
  intervals to refute (any node that still hears from it, or the node
  itself bumping its incarnation) before it is declared *dead*.
- **Dissemination**: state changes (alive / suspect / dead) ride
  piggybacked on ping/ack traffic and a periodic fanout gossip tick,
  each broadcast retransmitted O(log n) times.
- **Anti-entropy**: periodic full state push-pull over TCP against one
  random member, also used for `join()`.

Incarnation numbers order statements about a member; only the member
itself may increment its own (that is the refutation mechanism).

Wire format: msgpack compound packets (a list of messages) over UDP,
length-prefixed msgpack frames over TCP (shared with rpc/wire.py).

Copied from nomad_tpu/gossip/memberlist.py; only the imports differ.
"""

from __future__ import annotations

import logging
import math
import random
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import msgpack

from nomad_tpu_torch.analysis import guarded_by
from nomad_tpu_torch.resilience import failpoints
from nomad_tpu_torch.rpc.wire import recv_frame, send_frame

LOG = logging.getLogger("nomad.gossip")

# Member states
ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"
LEFT = "left"

# Events delivered to the listener callback
EVENT_JOIN = "member-join"
EVENT_LEAVE = "member-leave"
EVENT_FAILED = "member-failed"
EVENT_UPDATE = "member-update"

# UDP message kinds (tuples keep packets small)
_PING = 0        # (_PING, seq, target_name, from_name)
_ACK = 1         # (_ACK, seq)
_PING_REQ = 2    # (_PING_REQ, seq, target, taddr, tport, from, faddr, fport)
_ALIVE = 3       # (_ALIVE, name, addr, port, incarnation, tags)
_SUSPECT = 4     # (_SUSPECT, name, incarnation, from_name)
_DEAD = 5        # (_DEAD, name, incarnation, from_name, left)


@dataclass
class GossipConfig:
    probe_interval: float = 1.0
    probe_timeout: float = 0.5
    indirect_checks: int = 3
    gossip_interval: float = 0.2
    gossip_fanout: int = 3
    retransmit_mult: int = 4
    suspicion_mult: int = 4
    push_pull_interval: float = 30.0
    packet_limit: int = 1400

    @classmethod
    def fast(cls) -> "GossipConfig":
        """Test-friendly timings (reference analogue: the tightened Serf
        timeouts in nomad/server_test.go testServer)."""
        return cls(probe_interval=0.06, probe_timeout=0.03,
                   gossip_interval=0.02, push_pull_interval=0.5)


@dataclass
class Member:
    name: str
    addr: str
    port: int
    tags: Dict[str, str]
    incarnation: int = 0
    state: str = ALIVE
    state_change: float = field(default_factory=time.monotonic)
    # suspicion deadline (monotonic) when state == SUSPECT
    suspect_deadline: float = 0.0

    def snapshot(self) -> "Member":
        return Member(self.name, self.addr, self.port, dict(self.tags),
                      self.incarnation, self.state, self.state_change)


class Memberlist:
    """One gossip participant. Thread-safe; all background work runs on
    daemon threads started by `start()`."""

    _concurrency = guarded_by(
        "_lock", "_members", "_incarnation", "_probe_ring", "_probe_pos",
        "_seq", "_broadcasts", "_left")

    def __init__(self, name: str, bind_addr: str = "127.0.0.1",
                 port: int = 0, tags: Optional[Dict[str, str]] = None,
                 config: Optional[GossipConfig] = None,
                 on_event: Optional[Callable[[str, Member], None]] = None):
        self.name = name
        self.config = config or GossipConfig()
        self.on_event = on_event

        # UDP and TCP share one port number. With port=0 the kernel picks the
        # UDP port freely, and the matching TCP port may be taken by an
        # unrelated process — retry the pair until both bind.
        for attempt in range(16):
            self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._udp.bind((bind_addr, port))
            self.addr, self.port = self._udp.getsockname()
            self._tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                self._tcp.bind((bind_addr, self.port))
                break
            except OSError:
                self._udp.close()
                self._tcp.close()
                if port != 0 or attempt == 15:
                    raise
        self._tcp.listen(16)

        self._lock = threading.RLock()
        self._members: Dict[str, Member] = {}
        self._incarnation = 0
        self._members[name] = Member(name, self.addr, self.port,
                                     dict(tags or {}), incarnation=0)
        self._probe_ring: List[str] = []
        self._probe_pos = 0

        self._seq = 0
        self._acks: Dict[int, threading.Event] = {}
        # broadcast queue: [remaining_transmits, packed_message]
        self._broadcasts: List[List[Any]] = []

        self._shutdown = threading.Event()
        self._left = False
        self._threads: List[threading.Thread] = []
        # Fault-injection seam (tests only): called with (dest, msgs) before
        # every UDP send; return False to drop the packet. Models lossy
        # links and asymmetric partitions — the conditions SWIM's
        # suspicion/refutation pipeline exists to survive. Never set in
        # production paths.
        self.transport_filter: Optional[
            Callable[[Tuple[str, int], List[Any]], bool]] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        for target, nm in ((self._udp_loop, "udp"), (self._tcp_loop, "tcp"),
                           (self._probe_loop, "probe"),
                           (self._gossip_loop, "gossip"),
                           (self._push_pull_loop, "pushpull")):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"gossip-{nm}-{self.name}")
            t.start()
            self._threads.append(t)

    def shutdown(self) -> None:
        self._shutdown.set()
        try:
            self._udp.close()
        except OSError:
            pass
        try:
            # shutdown() wakes the blocked accept(); close() alone leaves
            # the kernel socket LISTENING under the accept thread on Linux,
            # so a restarted agent could never rebind its serf port.
            self._tcp.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._tcp.close()
        except OSError:
            pass

    def leave(self) -> None:
        """Graceful departure: broadcast our own death with the `left` flag
        so peers emit a leave (not a failure) event, give the gossip a few
        ticks to spread it, then stop."""
        with self._lock:
            self._left = True
            me = self._members[self.name]
            me.state = LEFT
            msg = (_DEAD, self.name, me.incarnation, self.name, True)
            self._queue_broadcast_locked(msg)
        # push the leave out directly too — don't rely on gossip ticks
        for m in self._random_members(self.config.gossip_fanout * 2):
            self._send_udp((m.addr, m.port), [msg])
        # Give the gossip ticks a window to spread the leave; a concurrent
        # shutdown() cuts the grace period short instead of blocking it.
        self._shutdown.wait(4 * self.config.gossip_interval)
        self.shutdown()

    def force_leave(self, name: str) -> bool:
        """Operator override: declare a (usually already unreachable) member
        dead without waiting for the suspicion pipeline (reference: serf
        ForceLeave behind the force-leave CLI)."""
        with self._lock:
            m = self._members.get(name)
            if m is None:
                return False
            inc = m.incarnation
        self._on_dead(name, inc, self.name, True)
        return True

    # ------------------------------------------------------------- queries
    def members(self) -> List[Member]:
        """All known members in any state (snapshot copies)."""
        with self._lock:
            return [m.snapshot() for m in self._members.values()]

    def alive_members(self) -> List[Member]:
        with self._lock:
            return [m.snapshot() for m in self._members.values()
                    if m.state in (ALIVE, SUSPECT)]

    def local_member(self) -> Member:
        with self._lock:
            return self._members[self.name].snapshot()

    def num_alive(self) -> int:
        with self._lock:
            return sum(1 for m in self._members.values()
                       if m.state in (ALIVE, SUSPECT))

    def set_tags(self, tags: Dict[str, str]) -> None:
        """Update our metadata and re-broadcast (reference: serf SetTags,
        used for e.g. advertising leadership/ports)."""
        with self._lock:
            me = self._members[self.name]
            me.tags = dict(tags)
            self._incarnation += 1
            me.incarnation = self._incarnation
            self._queue_broadcast_locked(self._alive_msg_locked(me))

    # ---------------------------------------------------------------- join
    def join(self, seeds: List[Any]) -> int:
        """Sync state with each seed ("host:port" or (host, port)); returns
        the number of seeds successfully contacted."""
        ok = 0
        for seed in seeds:
            if isinstance(seed, str):
                host, _, p = seed.rpartition(":")
                seed = (host, int(p))
            try:
                self._push_pull(tuple(seed))
                ok += 1
            except OSError as exc:
                LOG.warning("%s: join %s failed: %s", self.name, seed, exc)
        return ok

    # ------------------------------------------------------------ transport
    def _send_udp(self, dest: Tuple[str, int], msgs: List[Any]) -> None:
        if failpoints.fire("gossip.send") == "drop":
            return  # datagram lost in transit
        f = self.transport_filter
        if f is not None and not f(dest, msgs):
            return
        try:
            self._udp.sendto(msgpack.packb(msgs, use_bin_type=True), dest)
        except OSError:
            pass

    def _udp_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                raw, src = self._udp.recvfrom(65535)
            except OSError:
                return
            try:
                msgs = msgpack.unpackb(raw, raw=False)
            except Exception:
                LOG.debug("%s: undecodable datagram from %s dropped",
                          self.name, src)
                continue
            for msg in msgs:
                try:
                    self._handle_udp(msg, src)
                except Exception:
                    LOG.exception("%s: bad gossip message", self.name)

    def _handle_udp(self, msg: List[Any], src: Tuple[str, int]) -> None:
        kind = msg[0]
        if kind == _PING:
            _, seq, target, frm = msg
            if target != self.name:
                return  # misdirected (stale addr)
            out: List[Any] = [(_ACK, seq)]
            out.extend(self._drain_piggyback())
            self._send_udp(src, out)
        elif kind == _ACK:
            ev = self._acks.pop(msg[1], None)
            if ev is not None:
                ev.set()
        elif kind == _PING_REQ:
            _, seq, target, taddr, tport, frm, faddr, fport = msg
            self._indirect_probe(seq, target, (taddr, tport), (faddr, fport))
        elif kind == _ALIVE:
            self._on_alive(msg[1], msg[2], msg[3], msg[4], msg[5])
        elif kind == _SUSPECT:
            self._on_suspect(msg[1], msg[2], msg[3])
        elif kind == _DEAD:
            self._on_dead(msg[1], msg[2], msg[3], msg[4])

    def _indirect_probe(self, orig_seq: int, target: str,
                        taddr: Tuple[str, int],
                        reply_to: Tuple[str, int]) -> None:
        """Probe `target` on behalf of `reply_to`; relay the ack."""
        def run() -> None:
            if self._ping(target, taddr):
                self._send_udp(reply_to, [(_ACK, orig_seq)])
        threading.Thread(target=run, daemon=True,
                         name=f"gossip-relay-{self.name}").start()

    def _ping(self, target: str, dest: Tuple[str, int]) -> bool:
        if failpoints.fire("gossip.probe") == "drop":
            return False  # probe lost: caller escalates to indirect pings
        with self._lock:
            self._seq += 1
            seq = self._seq
        ev = threading.Event()
        self._acks[seq] = ev
        out: List[Any] = [(_PING, seq, target, self.name)]
        out.extend(self._drain_piggyback())
        self._send_udp(dest, out)
        ok = ev.wait(self.config.probe_timeout)
        self._acks.pop(seq, None)
        return ok

    # ----------------------------------------------------------- probe loop
    def _probe_loop(self) -> None:
        while not self._shutdown.wait(self.config.probe_interval):
            try:
                self._expire_suspects()
                member = self._next_probe_target()
                if member is not None:
                    self._probe(member)
            except Exception:
                # The failure detector must outlive any single bad probe
                # round (injected or real): a dead probe loop would stop
                # ALL failure detection on this member, silently.
                LOG.exception("%s: probe round failed", self.name)

    def _next_probe_target(self) -> Optional[Member]:
        with self._lock:
            candidates = [n for n, m in self._members.items()
                          if n != self.name and m.state in (ALIVE, SUSPECT)]
            if not candidates:
                return None
            if self._probe_pos >= len(self._probe_ring):
                self._probe_ring = candidates
                random.shuffle(self._probe_ring)
                self._probe_pos = 0
            while self._probe_pos < len(self._probe_ring):
                name = self._probe_ring[self._probe_pos]
                self._probe_pos += 1
                m = self._members.get(name)
                if m is not None and m.state in (ALIVE, SUSPECT):
                    return m.snapshot()
            return None

    def _probe(self, member: Member) -> None:
        if self._ping(member.name, (member.addr, member.port)):
            return
        # Indirect probes through k random other members
        ev = threading.Event()
        with self._lock:
            self._seq += 1
            seq = self._seq
        self._acks[seq] = ev
        req = (_PING_REQ, seq, member.name, member.addr, member.port,
               self.name, self.addr, self.port)
        relays = [m for m in self._random_members(self.config.indirect_checks)
                  if m.name != member.name]
        for r in relays:
            self._send_udp((r.addr, r.port), [req])
        ok = ev.wait(self.config.probe_interval)
        self._acks.pop(seq, None)
        if not ok:
            with self._lock:
                cur = self._members.get(member.name)
                inc = cur.incarnation if cur else member.incarnation
            self._on_suspect(member.name, inc, self.name)

    def _expire_suspects(self) -> None:
        now = time.monotonic()
        expired: List[Tuple[str, int]] = []
        with self._lock:
            for m in self._members.values():
                if m.state == SUSPECT and now >= m.suspect_deadline:
                    expired.append((m.name, m.incarnation))
        for name, inc in expired:
            self._on_dead(name, inc, self.name, False)

    def _suspicion_timeout(self) -> float:
        n = max(1, self.num_alive())
        return (self.config.suspicion_mult
                * max(1.0, math.log10(n) + 1.0)
                * self.config.probe_interval)

    # --------------------------------------------------------- dissemination
    def _retransmit_limit(self) -> int:
        n = max(1, self.num_alive())
        return self.config.retransmit_mult * int(math.ceil(math.log10(n) + 1))

    def _queue_broadcast_locked(self, msg: Tuple) -> None:
        # A newer statement about a node invalidates queued older ones.
        name = msg[1]
        self._broadcasts = [b for b in self._broadcasts
                            if b[1][1] != name]
        self._broadcasts.append([self._retransmit_limit(), msg])

    def _drain_piggyback(self, budget: int = 6) -> List[Tuple]:
        out: List[Tuple] = []
        with self._lock:
            for b in list(self._broadcasts):
                if len(out) >= budget:
                    break
                out.append(b[1])
                b[0] -= 1
                if b[0] <= 0:
                    self._broadcasts.remove(b)
        return out

    def _random_members(self, k: int) -> List[Member]:
        with self._lock:
            pool = [m.snapshot() for n, m in self._members.items()
                    if n != self.name and m.state in (ALIVE, SUSPECT)]
        random.shuffle(pool)
        return pool[:k]

    def _gossip_loop(self) -> None:
        while not self._shutdown.wait(self.config.gossip_interval):
            msgs = self._drain_piggyback()
            if not msgs:
                continue
            for m in self._random_members(self.config.gossip_fanout):
                self._send_udp((m.addr, m.port), msgs)

    # ------------------------------------------------------------ state FSM
    def _alive_msg_locked(self, m: Member) -> Tuple:
        return (_ALIVE, m.name, m.addr, m.port, m.incarnation, m.tags)

    def _notify(self, event: str, member: Member) -> None:
        if self.on_event is not None:
            try:
                self.on_event(event, member)
            except Exception:
                LOG.exception("%s: member event handler failed", self.name)

    def _on_alive(self, name: str, addr: str, port: int, inc: int,
                  tags: Dict[str, str]) -> None:
        notify: Optional[Tuple[str, Member]] = None
        with self._lock:
            if name == self.name:
                # A statement about us we didn't make: refute if it's old
                # news (e.g. a stale address) by out-incarnating it.
                me = self._members[self.name]
                if (addr, port) != (me.addr, me.port) \
                        and inc > me.incarnation and me.incarnation > 0:
                    # Post-restart echoes of our stale record arrive while
                    # our incarnation is still 0 and are refuted silently;
                    # only a claim that OUT-INCARNATES a refutation we
                    # already issued means a live node is fighting us for
                    # the name.
                    LOG.warning(
                        "%s: ANOTHER member is gossiping under our name "
                        "from %s:%s — member names must be unique per "
                        "region (set a distinct `name` in each agent "
                        "config)", self.name, addr, port)
                if inc > me.incarnation and not self._left:
                    self._incarnation = inc + 1
                    me.incarnation = self._incarnation
                    self._queue_broadcast_locked(self._alive_msg_locked(me))
                return
            m = self._members.get(name)
            if m is None:
                m = Member(name, addr, port, dict(tags), inc)
                self._members[name] = m
                self._queue_broadcast_locked(self._alive_msg_locked(m))
                notify = (EVENT_JOIN, m.snapshot())
            elif inc > m.incarnation:
                rejoined = m.state in (DEAD, LEFT)
                updated = (tags != m.tags or addr != m.addr
                           or port != m.port)
                m.addr, m.port, m.tags = addr, port, dict(tags)
                m.incarnation = inc
                if m.state != ALIVE:
                    m.state = ALIVE
                    m.state_change = time.monotonic()
                self._queue_broadcast_locked(self._alive_msg_locked(m))
                if rejoined:
                    notify = (EVENT_JOIN, m.snapshot())
                elif updated:
                    notify = (EVENT_UPDATE, m.snapshot())
        if notify is not None:
            self._notify(*notify)

    def _on_suspect(self, name: str, inc: int, from_name: str) -> None:
        with self._lock:
            if name == self.name:
                if self._left:
                    return
                # Refute: only we may raise our incarnation (SWIM's
                # mechanism against false positives).
                me = self._members[self.name]
                self._incarnation = max(self._incarnation, inc) + 1
                me.incarnation = self._incarnation
                self._queue_broadcast_locked(self._alive_msg_locked(me))
                return
            m = self._members.get(name)
            if m is None or inc < m.incarnation:
                return
            if m.state == ALIVE:
                m.state = SUSPECT
                m.state_change = time.monotonic()
                m.suspect_deadline = (time.monotonic()
                                      + self._suspicion_timeout())
                m.incarnation = inc
                self._queue_broadcast_locked((_SUSPECT, name, inc, from_name))

    def _on_dead(self, name: str, inc: int, from_name: str,
                 left: bool) -> None:
        notify: Optional[Tuple[str, Member]] = None
        with self._lock:
            if name == self.name:
                if self._left:
                    return
                me = self._members[self.name]
                self._incarnation = max(self._incarnation, inc) + 1
                me.incarnation = self._incarnation
                self._queue_broadcast_locked(self._alive_msg_locked(me))
                return
            m = self._members.get(name)
            if m is None or inc < m.incarnation:
                return
            if m.state in (DEAD, LEFT):
                return
            m.state = LEFT if left else DEAD
            m.state_change = time.monotonic()
            m.incarnation = inc
            self._queue_broadcast_locked((_DEAD, name, inc, from_name, left))
            notify = (EVENT_LEAVE if left else EVENT_FAILED, m.snapshot())
        if notify is not None:
            self._notify(*notify)

    # ----------------------------------------------------------- push-pull
    def _local_state(self) -> List[List[Any]]:
        with self._lock:
            return [[m.name, m.addr, m.port, m.incarnation, m.tags, m.state]
                    for m in self._members.values()]

    def _merge_state(self, remote: List[List[Any]]) -> None:
        for name, addr, port, inc, tags, state in remote:
            if state in (ALIVE, SUSPECT):
                self._on_alive(name, addr, port, inc, tags)
                if state == SUSPECT:
                    self._on_suspect(name, inc, name)
            elif state in (DEAD, LEFT):
                self._on_dead(name, inc, name, state == LEFT)

    def _push_pull(self, dest: Tuple[str, int]) -> None:
        sock = socket.create_connection(dest, timeout=2.0)
        try:
            send_frame(sock, {"PushPull": self._local_state(),
                              "From": self.name})
            resp = recv_frame(sock)
            if resp is not None:
                self._merge_state(resp.get("PushPull", []))
        finally:
            sock.close()

    def _tcp_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._tcp.accept()
            except OSError:
                return
            threading.Thread(target=self._handle_tcp, args=(conn,),
                             daemon=True,
                             name=f"gossip-tcp-conn-{self.name}").start()

    def _handle_tcp(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(2.0)
            req = recv_frame(conn)
            if req is None:
                return
            send_frame(conn, {"PushPull": self._local_state(),
                              "From": self.name})
            self._merge_state(req.get("PushPull", []))
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _push_pull_loop(self) -> None:
        while not self._shutdown.wait(self.config.push_pull_interval):
            targets = self._random_members(1)
            if targets:
                m = targets[0]
                # The fault-injection seam gates anti-entropy too: a
                # "partitioned" link must not heal through the TCP side.
                f = self.transport_filter
                if f is not None and not f((m.addr, m.port),
                                           [("push-pull",)]):
                    continue
                try:
                    self._push_pull((m.addr, m.port))
                except OSError:
                    pass
