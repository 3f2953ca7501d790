"""Networked transport: multi-host replacement for the in-process bus.

The reference's robots communicate over DDS; here the same topic semantics
ride a small TCP hub (the "thin async host messaging shim" of SURVEY.md §5):

- ``TransportHub`` — a broker that fans every frame out to every connected
  client (including the sender, matching DDS self-delivery; node callbacks
  already filter by robot id).
- ``NetworkBus`` — drop-in for
  :class:`cslam_tpu_torch.runtime.bus.MessageBus`: ``publish`` sends a
  length-prefixed frame; a reader thread queues inbound frames;
  ``deliver`` drains them into local subscribers. All node code
  (detection front end, back end, sensor handlers) runs unchanged on top.

The hub is a single broker (the reference's DDS is masterless); to keep the
swarm's liveness story at least as strong as the reference's failure model,
a hub restart must not lose the frames clients buffered while it was down.
The mechanism is a generation/sequence handshake:

- the hub stamps every relayed frame with a monotonically increasing
  sequence number and keeps the last ``history`` frames in a replay ring;
- on connect it sends ``HELLO(generation, next_seq)`` and the client
  answers ``RESYNC(from_seq)`` *before* joining the live relay set — a
  fresh client asks for ``next_seq`` (future frames only), a client whose
  connection blipped asks for ``last_seq + 1`` (missed frames), and a
  client that observes a *new generation* (hub restarted) asks for ``0``
  (everything the new hub has relayed, because peers may have flushed
  their outage buffers before this client reconnected);
- the client drops frames with ``seq <= last_seq``, so hub-side replay
  overlap never double-delivers;
- every published frame additionally carries a (publisher id, publisher
  seq) stamp: if a client's ``sendall`` raises after the kernel already
  shipped the frame, the reconnect flush's retransmit is dropped at every
  receiver's per-publisher watermark — delivery is exactly-once up to the
  explicit bounded-buffer drops;
- those bounds are surfaced, not silent: a receiver that observes a seq
  gap (the hub's per-client queue overflowed — by arithmetic such frames
  are already beyond the replay ring, so a resync cannot recover them)
  counts it in ``connection_stats()['missed_frames'/'seq_gaps']``, the
  same honesty contract as DDS's bounded reliable QoS depth.

Frames are pickled tuples — robot swarms are a trusted network in the
reference's model too; swap ``_encode``/``_decode`` for a schema codec if
that assumption changes.

Counterpart of ``cslam_tpu/runtime/transport.py``, the same protocol and
code. Two differences: a frame is pickled by ``utils.host_pickle``, which
refuses a ``torch.Tensor`` anywhere inside it (a receiving robot process
would otherwise rebuild the sender's device tensor), and a frame names the
port's classes (``cslam_tpu_torch.types.*``). The port and the JAX package
therefore do not share a wire: a port robot that unpickled a JAX-package
frame would import ``cslam_tpu``. There is no bridge between the two.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Sequence, Tuple

from cslam_tpu_torch.runtime.bus import MessageBus
from cslam_tpu_torch.utils import host_pickle

_HEADER = struct.Struct("!I")

# control-frame topics (never collide with /cslam/... topics)
_HELLO = "__hub_hello__"
_RESYNC = "__hub_resync__"
_DATA = "__hub_data__"
_LATCHED = "__hub_latched__"


def _encode(topic: str, msg: Any, src_robot: int,
            pub: Optional[Tuple[str, int]] = None,
            latch: bool = False) -> bytes:
    """Frame a message. ``pub`` = (publisher id, publisher seq) lets
    receivers drop retransmits (a reconnect flush re-sends frames whose
    first sendall may already have reached the hub). ``latch`` marks the
    frame transient-local: the hub stores the latest latched value per
    (topic, publisher) and serves it to every later-joining client."""
    if latch:
        item = (topic, msg, src_robot, pub, True)
    elif pub is not None:
        item = (topic, msg, src_robot, pub)
    else:
        item = (topic, msg, src_robot)
    payload = host_pickle.dumps(item)
    return _HEADER.pack(len(payload)) + payload


def _read_frame(sock: socket.socket) -> Optional[Tuple[str, Any, int]]:
    header = _read_exact(sock, _HEADER.size)
    if header is None:
        return None
    (length,) = _HEADER.unpack(header)
    payload = _read_exact(sock, length)
    if payload is None:
        return None
    return pickle.loads(payload)


def _shutdown_close(sock: socket.socket) -> None:
    """shutdown() before close(): a bare close() while another thread is
    blocked in recv() on the same fd defers the kernel-side teardown until
    that recv returns — which it never does. shutdown() sends FIN and wakes
    the blocked reader immediately."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


#: sentinel meaning "the handshake consumed the first frame"
_HANDSHAKEN = object()


class _HubClient:
    """One connected client: socket + ordered outbound queue + writer.

    Relay threads (one per *source* client) append under the hub lock in
    seq-assignment order; the single writer thread drains sequentially, so
    every destination observes frames in global seq order — the invariant
    the NetworkBus watermark dedup relies on. A writer also means a slow
    client back-pressures only its own bounded queue, never the hub."""

    QUEUE_DEPTH = 8192  # drop-oldest beyond this (slow client misses frames)

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._queue: deque = deque(maxlen=self.QUEUE_DEPTH)
        self._cv = threading.Condition()
        self.alive = True
        self._writer = threading.Thread(target=self._writer_loop, daemon=True)
        self._writer.start()

    def send(self, data: bytes) -> None:
        with self._cv:
            self._queue.append(data)
            self._cv.notify()

    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                while self.alive and not self._queue:
                    self._cv.wait()
                if not self.alive:
                    return
                data = self._queue.popleft()
            try:
                self.sock.sendall(data)
            except OSError:
                self.stop()
                return

    def stop(self) -> None:
        with self._cv:
            self.alive = False
            self._cv.notify()
        _shutdown_close(self.sock)


class TransportHub:
    """TCP fan-out broker with a bounded replay ring. One per swarm."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 history: int = 4096):
        self._server = socket.create_server((host, port))
        self.address = self._server.getsockname()
        self._clients: Dict[socket.socket, _HubClient] = {}
        self._lock = threading.Lock()
        self._generation = os.urandom(8).hex()
        self._seq = 0
        self._history: deque = deque(maxlen=history)  # (seq, bytes)
        # transient-local store: latest latched frame per (topic, pub id),
        # as (seq, encoded _LATCHED frame) — served to late joiners whose
        # resync window starts after the frame left the replay ring
        self._latch_store: Dict[Tuple[str, Any], Tuple[int, bytes]] = {}
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                client, _ = self._server.accept()
            except OSError:
                return
            client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._client_loop, args=(client,),
                             daemon=True).start()

    def _handshake(self, client: socket.socket):
        """HELLO → RESYNC → queue replay → join live relay. Replay frames
        are queued and the client registered under one hub-lock hold, so
        replayed and live frames reach the client in seq order."""
        with self._lock:
            hello = _encode(_HELLO, (self._generation, self._seq), -2)
        try:
            client.sendall(hello)
        except OSError:
            return None
        first = _read_frame(client)
        if first is None:
            return None
        hc = _HubClient(client)
        with self._lock:
            if (isinstance(first, tuple) and len(first) == 3
                    and first[0] == _RESYNC):
                from_seq = int(first[1])
                for s, data in self._history:
                    if s >= from_seq:
                        hc.send(data)
                # transient-local durability (reference publishes
                # ReferenceFrames latched, decentralized_pgo.cpp:194-196):
                # latched values older than the resync window are served
                # explicitly; newer ones arrive via replay/live and the
                # receiver's per-publisher watermark drops this copy
                for _seq0, data in self._latch_store.values():
                    hc.send(data)
                first = _HANDSHAKEN  # consumed
            # (else: legacy client sent data before resync — relay it below)
            self._clients[client] = hc
        return first

    def _client_loop(self, client: socket.socket) -> None:
        first = self._handshake(client)
        if first is None:
            _shutdown_close(client)
            return
        while self._running:
            if first is not _HANDSHAKEN:
                frame = first
                first = _HANDSHAKEN
            else:
                frame = _read_frame(client)
            if frame is None:
                break
            topic, msg, src = frame[:3]
            pub = frame[3] if len(frame) > 3 else None
            latch = bool(frame[4]) if len(frame) > 4 else False
            with self._lock:
                seq = self._seq
                self._seq += 1
                data = _encode(_DATA, (seq, topic, msg, src, pub, latch), -2)
                self._history.append((seq, data))
                if latch:
                    pid = pub[0] if pub else None
                    self._latch_store[(topic, pid)] = (seq, _encode(
                        _LATCHED, (topic, msg, src, pub), -2))
                # fan out UNDER the lock (send is a cheap deque append):
                # two relay threads enqueueing to the same destination out
                # of seq-assignment order would trip the client watermark
                # into dropping the lower seq forever
                for hc in self._clients.values():
                    if hc.alive:
                        hc.send(data)
        self._drop(client)

    def _drop(self, client: socket.socket) -> None:
        with self._lock:
            hc = self._clients.pop(client, None)
        if hc is not None:
            hc.stop()
        else:
            _shutdown_close(client)

    def close(self) -> None:
        self._running = False
        _shutdown_close(self._server)
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for hc in clients:
            hc.stop()


class NetworkBus(MessageBus):
    """MessageBus whose queue is fed by a TransportHub connection.

    A dropped hub connection is NOT terminal: the reader thread reconnects
    with exponential backoff, frames published while disconnected land in a
    bounded drop-oldest buffer that is flushed after the reconnect
    handshake, the hub's generation/seq replay covers frames peers flushed
    before this client reconnected, and the connection state is surfaced
    via :meth:`connection_stats` so node heartbeat logic can report it.
    """

    #: outgoing frames buffered while the hub is unreachable (drop-oldest)
    PENDING_DEPTH = 1024

    def __init__(self, hub_address: Optional[Tuple[str, int]] = None,
                 reconnect: bool = True,
                 backoff_initial: float = 0.05, backoff_max: float = 2.0,
                 hub_addresses: Optional[Sequence[Tuple[str, int]]] = None):
        """``hub_address`` targets one hub; ``hub_addresses`` lists primary
        + standby hubs tried in rotation — when the connected hub dies the
        reconnect loop fails over to the next address (each hub has its own
        generation, so the existing new-generation resync path takes the
        standby's full relayed window and the per-publisher watermarks
        dedup anything already seen). This removes the single-broker
        liveness gap vs the reference's masterless DDS: the swarm survives
        any one hub as long as a standby is reachable."""
        super().__init__()
        if hub_addresses:
            self._addresses = [tuple(a) for a in hub_addresses]
        elif hub_address is not None:
            self._addresses = [tuple(hub_address)]
        else:
            raise ValueError("need hub_address or hub_addresses")
        self._addr_idx = 0
        self.failovers = 0
        self._reconnect = reconnect
        self._backoff = (backoff_initial, backoff_max)
        self._hub_generation: Optional[str] = None
        self._last_seq = -1
        self._sock = self._connect_and_sync()
        self.connected = True
        self.disconnects = 0
        self.reconnects = 0
        self.dropped_frames = 0
        self.missed_frames = 0   # inbound seq gaps (hub dropped for us)
        self.seq_gaps = 0
        self._client_id = os.urandom(8).hex()
        self._pub_seq = 0
        # publisher-side durability: our latched frames, re-sent whenever
        # the hub generation changes (restart or failover to a standby
        # whose latch store never saw them); receivers that already
        # delivered them drop the copy at their per-publisher watermark
        self._latched_out: Dict[str, bytes] = {}
        self._pub_seen: Dict[str, int] = {}  # publisher id -> watermark
        # (topic, publisher id) -> newest latched pseq delivered; separate
        # from _pub_seen so an old-but-unseen latched value is never
        # shadowed by newer non-latched traffic from the same publisher
        self._latch_seen: Dict[Tuple[str, str], int] = {}
        self._pending_out: deque = deque(maxlen=self.PENDING_DEPTH)
        self._inbox: deque = deque()
        self._inbox_lock = threading.Lock()
        self._send_lock = threading.Lock()  # publish() may be multi-threaded
        self._running = True
        self._reader = threading.Thread(target=self._reader_loop, daemon=True)
        self._reader.start()

    def _connect_and_sync(self) -> socket.socket:
        """Connect + HELLO/RESYNC handshake (see module docstring).

        With multiple hub addresses, tries each in rotation starting from
        the last-connected one; raises only when every hub is unreachable
        (the reconnect loop then backs off and sweeps again). Sets
        ``self._generation_changed`` so the reconnect path can re-latch
        our transient-local frames onto a fresh hub generation.
        """
        last_err: Optional[OSError] = None
        for k in range(len(self._addresses)):
            idx = (self._addr_idx + k) % len(self._addresses)
            try:
                sock = self._handshake_with(self._addresses[idx])
            except OSError as e:
                last_err = e
                continue
            if idx != self._addr_idx:
                self._addr_idx = idx
                self.failovers += 1
            return sock
        raise last_err if last_err is not None else OSError("no hub")

    @property
    def hub_address(self) -> Tuple[str, int]:
        """The currently targeted hub address."""
        return self._addresses[self._addr_idx]

    def _handshake_with(self, address: Tuple[str, int]) -> socket.socket:
        sock = socket.create_connection(address, timeout=10.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello = _read_frame(sock)
        if not (isinstance(hello, tuple) and len(hello) == 3
                and hello[0] == _HELLO):
            _shutdown_close(sock)
            raise OSError("hub handshake failed")
        generation, next_seq = hello[1]
        if self._hub_generation is None:
            from_seq = next_seq          # fresh client: future frames only
            self._last_seq = next_seq - 1
        elif generation == self._hub_generation:
            from_seq = self._last_seq + 1  # our link blipped: catch up
        else:
            from_seq = 0                 # hub restarted: take everything the
            self._last_seq = -1          # new generation relayed so far
        self._generation_changed = generation != self._hub_generation
        self._hub_generation = generation
        sock.sendall(_encode(_RESYNC, from_seq, -2))
        sock.settimeout(None)
        return sock

    def _reader_loop(self) -> None:
        while self._running:
            frame = _read_frame(self._sock)
            if frame is not None:
                if (isinstance(frame, tuple) and len(frame) == 3
                        and frame[0] == _LATCHED):
                    topic, msg, src, pub = frame[1]
                    # dedup by the PER-(topic, publisher) latch watermark —
                    # NOT the shared retransmit watermark: a late joiner
                    # whose resync replayed newer frames from this
                    # publisher must still deliver the older latched value
                    if pub is not None:
                        pid, pseq = pub
                        key = (topic, pid)
                        if pseq <= self._latch_seen.get(key, -1):
                            continue  # this latched value already seen
                        self._latch_seen[key] = pseq
                    with self._inbox_lock:
                        self._inbox.append((topic, msg, src, True))
                    continue
                if (isinstance(frame, tuple) and len(frame) == 3
                        and frame[0] == _DATA):
                    payload = frame[1]
                    seq, topic, msg, src = payload[:4]
                    pub = payload[4] if len(payload) > 4 else None
                    latch = (bool(payload[5]) if len(payload) > 5
                             else False)
                    if seq <= self._last_seq:
                        continue  # hub replay overlap: already seen
                    if seq > self._last_seq + 1:
                        # the hub dropped frames for us (its per-client
                        # queue overflowed, or its replay ring had already
                        # evicted part of a resync window — incl. the
                        # post-restart from-0 window, where _last_seq is
                        # -1) — those frames are beyond the ring, so
                        # surface the loss instead of resyncing futilely
                        # (fresh connects never trip this: _last_seq
                        # initializes to next_seq - 1)
                        self.seq_gaps += 1
                        self.missed_frames += seq - self._last_seq - 1
                    self._last_seq = seq
                    if pub is not None:
                        pid, pseq = pub
                        if pseq <= self._pub_seen.get(pid, -1):
                            continue  # publisher retransmit (flush overlap)
                        self._pub_seen[pid] = pseq
                        if latch:
                            key = (topic, pid)
                            self._latch_seen[key] = max(
                                self._latch_seen.get(key, -1), pseq)
                    with self._inbox_lock:
                        self._inbox.append((topic, msg, src, latch))
                continue
            # connection lost (or close() shut the socket down)
            if not self._running:
                return
            with self._send_lock:
                if self.connected:  # publish() may have noticed first
                    self.connected = False
                    self.disconnects += 1
            if not self._reconnect:
                return
            delay, cap = self._backoff
            while self._running:
                try:
                    sock = self._connect_and_sync()
                except OSError:
                    # hub still down: back off and retry (daemon thread, so
                    # a permanently-dead hub costs one sleeping thread)
                    time.sleep(delay)
                    delay = min(delay * 2, cap)
                    continue
                with self._send_lock:
                    self._sock = sock
                    self.connected = True
                    self.reconnects += 1
                    pending = deque(self._pending_out)
                    self._pending_out.clear()
                    if getattr(self, "_generation_changed", False):
                        # a fresh hub never saw our latched frames: re-send
                        # them first, in publisher-seq order (reversing the
                        # order would make receivers' retransmit watermark
                        # drop all but the newest); receivers that already
                        # delivered them drop the copies, and a newer
                        # latched value sitting in pending overwrites the
                        # hub's store right after
                        pending = deque(list(self._latched_out.values())
                                        + list(pending))
                    try:
                        while pending:
                            sock.sendall(pending[0])
                            pending.popleft()
                    except OSError:
                        # hub died again mid-flush: requeue ONLY the
                        # unsent remainder (sent frames are in the hub's
                        # replay ring if it got them before dying; resend
                        # would double-deliver) and drop the dead socket
                        self._pending_out.extend(pending)
                        _shutdown_close(sock)
                        self.connected = False
                        self.disconnects += 1
                        continue
                break

    def connection_stats(self) -> Dict[str, Any]:
        """Surfaced connection state for heartbeat/metrics planes."""
        with self._send_lock:
            return {"connected": self.connected,
                    "disconnects": self.disconnects,
                    "reconnects": self.reconnects,
                    "pending_out": len(self._pending_out),
                    "failovers": self.failovers,
                    "hub_address": self.hub_address,
                    "dropped_frames": self.dropped_frames,
                    "missed_frames": self.missed_frames,
                    "seq_gaps": self.seq_gaps}

    def _buffer_out(self, data: bytes) -> None:
        # caller holds _send_lock; deque maxlen drops oldest silently, so
        # count the overflow explicitly
        if len(self._pending_out) == self._pending_out.maxlen:
            self.dropped_frames += 1
        self._pending_out.append(data)

    def publish(self, topic: str, msg: Any, src_robot: int = -1,
                latch: bool = False) -> None:
        with self._send_lock:
            # stamp (publisher id, publisher seq) so receivers can drop the
            # retransmit if this sendall raises AFTER the kernel shipped
            # the frame and the reconnect flush re-sends it
            data = _encode(topic, msg, src_robot,
                           pub=(self._client_id, self._pub_seq),
                           latch=latch)
            self._pub_seq += 1
            if latch:
                # keep the latest latched frame per topic for re-latching
                # onto a fresh hub generation; also latch locally so
                # late in-process subscribers get transient-local QoS
                self._latched_out[topic] = data
                self._latched[topic] = (msg, src_robot)
            if not self.connected:
                self._buffer_out(data)
                return
            try:
                self._sock.sendall(data)
            except OSError:
                self.connected = False
                self.disconnects += 1
                self._buffer_out(data)

    def deliver(self, max_messages: int = 100000) -> int:
        with self._inbox_lock:
            pending = list(self._inbox)
            self._inbox.clear()
        for topic, msg, src, latch in pending:
            # route through the in-process publish path: QoS bounding for
            # best-effort subscribers AND latch marking in one place, on
            # the delivering thread — marking _latched from the reader
            # thread raced subscribe() into a double delivery (latch-
            # pending copy + inbox copy)
            MessageBus.publish(self, topic, msg, src, latch=latch)
        return super().deliver(max_messages)

    def close(self) -> None:
        self._running = False
        _shutdown_close(self._sock)
