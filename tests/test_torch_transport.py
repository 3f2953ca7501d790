"""The port's networked transport (``cslam_tpu_torch/runtime/transport.py``):
the cases of ``tests/test_transport.py`` on the port's copy, and two of its
own: no frame of the full node stack carries a ``torch.Tensor``, and a
port frame unpickles in an interpreter where ``cslam_tpu`` cannot be
imported. Port-only: the module is the JAX package's code with the port's
imports, so there is nothing to hold against the reference but the cases."""
import time

import numpy as np
import pytest
import torch

from cslam_tpu_torch.config import CslamConfig
from cslam_tpu_torch.runtime.bus import RobotContext
from cslam_tpu_torch.runtime.clock import VirtualClock
from cslam_tpu_torch.runtime.transport import NetworkBus, TransportHub
from cslam_tpu_torch.types import GlobalDescriptor, GlobalDescriptors
from torch_threads import one_torch_thread  # noqa: F401


def wait_for(predicate, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def _full_node_stack():
    """Two robots' detection front ends gossiping over real sockets:
    descriptors cross the wire and a candidate match forms."""
    from cslam_tpu_torch.runtime.lcd_node import DetectionFrontEnd
    from cslam_tpu_torch.runtime.simulator import IdentityDescriptorModel
    from cslam_tpu_torch.types import KeyframeRGB

    hub = TransportHub()
    try:
        clock = VirtualClock()
        robots = []
        for rid in range(2):
            cfg = CslamConfig(robot_id=rid, max_nb_robots=2)
            cfg.frontend.similarity_threshold = 0.9
            cfg.neighbor_management.enable_neighbor_monitoring = False
            bus = NetworkBus(hub.address)
            ctx = RobotContext(bus, clock, rid, cfg.flatten())
            det = DetectionFrontEnd(ctx, model=IdentityDescriptorModel(),
                                    device="cpu")
            robots.append((bus, ctx, det))

        rng = np.random.default_rng(0)
        place = rng.standard_normal(16)
        place /= np.linalg.norm(place)

        def step(seconds=1.0):
            for _ in range(int(seconds / 0.25)):
                clock.advance(0.25)
                for bus, ctx, _ in robots:
                    ctx.poll_timers()
                    bus.deliver()
                time.sleep(0.02)  # let the wire catch up
                for bus, _, _ in robots:
                    bus.deliver()

        # robot 0 sees the place; descriptor gossips to robot 1
        robots[0][1].bus.publish("/r0/cslam/keyframe_data",
                                 KeyframeRGB(id=0, image=place),
                                 src_robot=0)
        step(2.0)
        assert robots[1][2].lcm.other_robots_nnsm[0].n == 1

        # robot 1 revisits the same place -> candidate match forms there
        robots[1][1].bus.publish("/r1/cslam/keyframe_data",
                                 KeyframeRGB(id=0, image=place),
                                 src_robot=1)
        step(2.0)
        cands = robots[1][2].lcm.candidate_selector.candidate_edges
        assert len(cands) == 1
        edge = next(iter(cands.values()))
        assert {edge.robot0_id, edge.robot1_id} == {0, 1}
    finally:
        for bus, _, _ in robots:
            bus.close()
        hub.close()


class TestTransport:

    def test_pubsub_across_buses(self):
        hub = TransportHub()
        try:
            bus_a = NetworkBus(hub.address)
            bus_b = NetworkBus(hub.address)
            got_a, got_b = [], []
            bus_a.subscribe("/cslam/x", got_a.append)
            bus_b.subscribe("/cslam/x", got_b.append)
            bus_a.publish("/cslam/x", {"v": np.arange(3)}, src_robot=0)
            assert wait_for(lambda: bus_b.deliver() or got_b)
            bus_a.deliver()
            # both sides receive (DDS-like self-delivery included)
            assert len(got_b) == 1 and len(got_a) == 1
            np.testing.assert_array_equal(got_b[0]["v"], np.arange(3))
        finally:
            hub.close()

    def test_best_effort_bounds_network_backlog(self):
        """Best-effort topics on a NetworkBus keep only the freshest
        `depth` frames that arrived between two delivers (reference
        sensor-intake QoS, rgbd_handler.cpp:58-61)."""
        from cslam_tpu_torch.runtime.bus import QoSProfile
        hub = TransportHub()
        try:
            tx = NetworkBus(hub.address)
            rx = NetworkBus(hub.address)
            got = []
            rx.subscribe("/cslam/sensor", got.append,
                         qos=QoSProfile(best_effort=True, depth=4))
            for i in range(100):
                tx.publish("/cslam/sensor", i, src_robot=0)
            # wait until the flood has crossed the wire, then deliver once
            assert wait_for(lambda: len(rx._inbox) >= 100, timeout=10.0)
            rx.deliver()
            assert got == [96, 97, 98, 99]
            assert rx.messages_dropped == 96
        finally:
            tx.close()
            rx.close()
            hub.close()

    def test_full_node_stack_over_network(self):
        """Two robots' detection front ends gossiping over real sockets:
        descriptors cross the wire and a candidate match forms."""
        _full_node_stack()

    def test_client_disconnect_does_not_kill_hub(self):
        hub = TransportHub()
        try:
            bus_a = NetworkBus(hub.address)
            bus_b = NetworkBus(hub.address)
            got = []
            bus_b.subscribe("/t", got.append)
            bus_a.close()  # a drops off
            time.sleep(0.05)
            bus_c = NetworkBus(hub.address)
            bus_c.publish("/t", 42)
            assert wait_for(lambda: bus_b.deliver() or got)
            assert got == [42]
        finally:
            hub.close()


class TestTransportStress:
    """Concurrency stress: many clients publishing simultaneously must not
    corrupt the length-prefixed stream (regression guard for the hub's
    per-client write-lock fix)."""

    def test_concurrent_publishers_no_corruption(self):
        import threading
        hub = TransportHub()
        try:
            n_clients, n_msgs = 4, 200
            buses = [NetworkBus(hub.address) for _ in range(n_clients)]
            received = [[] for _ in range(n_clients)]
            for i, bus in enumerate(buses):
                bus.subscribe("/stress", received[i].append)

            def blast(bus, cid):
                for m in range(n_msgs):
                    bus.publish("/stress",
                                {"cid": cid, "seq": m,
                                 "payload": np.full(64, cid, np.int32)})

            threads = [threading.Thread(target=blast, args=(b, i))
                       for i, b in enumerate(buses)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

            total = n_clients * n_msgs
            assert wait_for(
                lambda: all((b.deliver() or True)
                            and len(received[i]) >= total
                            for i, b in enumerate(buses)), timeout=20.0)
            for i in range(n_clients):
                assert len(received[i]) == total
                per_cid = {}
                for msg in received[i]:
                    assert np.all(msg["payload"] == msg["cid"])  # intact
                    per_cid.setdefault(msg["cid"], []).append(msg["seq"])
                for cid, seqs in per_cid.items():
                    assert sorted(seqs) == list(range(n_msgs))  # none lost
                    assert seqs == sorted(seqs)  # per-source order kept
        finally:
            for b in buses:
                b.close()
            hub.close()


class TestHubResilience:
    """The hub is a single broker; a dropped hub must not silently
    partition the swarm forever (round-2 review, transport weak #4)."""

    def test_hub_restart_swarm_resumes(self):
        hub = TransportHub()
        host, port = hub.address
        bus_a = NetworkBus(hub.address)
        bus_b = NetworkBus(hub.address)
        try:
            got_b = []
            bus_b.subscribe("/cslam/x", got_b.append)
            bus_a.publish("/cslam/x", 1, src_robot=0)
            assert wait_for(lambda: bus_b.deliver() or got_b)

            hub.close()
            # both clients notice the drop and surface it
            assert wait_for(
                lambda: not bus_a.connection_stats()["connected"])
            assert wait_for(
                lambda: not bus_b.connection_stats()["connected"])
            # frames published while down are buffered, not lost/raised
            bus_a.publish("/cslam/x", 2, src_robot=0)
            stats = bus_a.connection_stats()
            assert stats["disconnects"] >= 1
            assert stats["pending_out"] == 1

            hub = TransportHub(host, port)  # same address, new broker
            assert wait_for(
                lambda: bus_a.connection_stats()["connected"]
                and bus_b.connection_stats()["connected"], timeout=10.0)
            # the buffered frame flushes through the new hub
            assert wait_for(lambda: bus_b.deliver() or len(got_b) >= 2,
                            timeout=10.0)
            # and fresh traffic flows again
            bus_a.publish("/cslam/x", 3, src_robot=0)
            assert wait_for(lambda: bus_b.deliver() or len(got_b) >= 3)
            assert got_b == [1, 2, 3]
            assert bus_a.connection_stats()["reconnects"] >= 1
        finally:
            bus_a.close()
            bus_b.close()
            hub.close()

    def test_failover_to_standby_hub(self):
        """Clients given [primary, standby] survive the primary dying:
        the reconnect loop rotates to the standby (new generation),
        buffered frames flush through it, traffic resumes, and the
        failover is surfaced in connection_stats."""
        primary = TransportHub()
        standby = TransportHub()
        addrs = [primary.address, standby.address]
        bus_a = NetworkBus(hub_addresses=addrs)
        bus_b = NetworkBus(hub_addresses=addrs)
        try:
            got_b = []
            bus_b.subscribe("/cslam/x", got_b.append)
            bus_a.publish("/cslam/x", 1, src_robot=0)
            assert wait_for(lambda: bus_b.deliver() or got_b)
            assert bus_a.connection_stats()["hub_address"] == primary.address

            primary.close()
            assert wait_for(
                lambda: not bus_a.connection_stats()["connected"]
                or bus_a.connection_stats()["failovers"] >= 1)
            bus_a.publish("/cslam/x", 2, src_robot=0)

            assert wait_for(
                lambda: bus_a.connection_stats()["connected"]
                and bus_b.connection_stats()["connected"], timeout=10.0)
            sa = bus_a.connection_stats()
            assert sa["failovers"] >= 1
            assert sa["hub_address"] == standby.address
            # the buffered frame flushes through the standby
            assert wait_for(lambda: bus_b.deliver() or len(got_b) >= 2,
                            timeout=10.0)
            bus_a.publish("/cslam/x", 3, src_robot=0)
            assert wait_for(lambda: bus_b.deliver() or len(got_b) >= 3)
            assert got_b == [1, 2, 3]
        finally:
            bus_a.close()
            bus_b.close()
            primary.close()
            standby.close()

    def test_startup_skips_dead_primary(self):
        """A client whose first address is unreachable connects through
        the standby at construction time."""
        dead = TransportHub()
        dead_addr = dead.address
        dead.close()
        live = TransportHub()
        bus = NetworkBus(hub_addresses=[dead_addr, live.address])
        try:
            assert bus.connection_stats()["connected"]
            assert bus.connection_stats()["hub_address"] == live.address
        finally:
            bus.close()
            live.close()

    def test_no_reconnect_mode_stays_down(self):
        hub = TransportHub()
        bus = NetworkBus(hub.address, reconnect=False)
        try:
            hub.close()
            assert wait_for(lambda: not bus.connection_stats()["connected"])
            bus.publish("/cslam/x", 1, src_robot=0)  # buffered, no raise
            assert bus.connection_stats()["pending_out"] == 1
        finally:
            bus.close()
            hub.close()


class TestDeliverySemantics:

    def test_publisher_retransmit_deduped(self):
        """A frame whose sendall raised after the kernel shipped it gets
        re-sent by the reconnect flush; receivers must drop the duplicate
        via the per-publisher watermark. Simulated by re-sending the
        identical stamped bytes straight down the socket."""
        from cslam_tpu_torch.runtime.transport import _encode
        hub = TransportHub()
        try:
            bus_a = NetworkBus(hub.address)
            bus_b = NetworkBus(hub.address)
            got = []
            bus_b.subscribe("/cslam/x", got.append)
            time.sleep(0.3)   # B joins the relay set before A publishes
            bus_a.publish("/cslam/x", "payload", src_robot=0)
            # retransmit: identical bytes, same (publisher id, pub seq)
            dup = _encode("/cslam/x", "payload", 0,
                          pub=(bus_a._client_id, bus_a._pub_seq - 1))
            bus_a._sock.sendall(dup)
            bus_a.publish("/cslam/x", "next", src_robot=0)
            assert wait_for(lambda: bus_b.deliver() or len(got) >= 2)
            time.sleep(0.3)
            bus_b.deliver()
            assert got == ["payload", "next"]
            bus_a.close()
            bus_b.close()
        finally:
            hub.close()

    def test_replay_ring_eviction_surfaces_missed_frames(self):
        """A reconnecting client whose resync window fell off the hub's
        replay ring must observe a counted seq gap (missed_frames) rather
        than silently advancing its watermark."""
        hub = TransportHub(history=8)
        port = hub.address[1]
        try:
            bus_a = NetworkBus(hub.address, backoff_initial=0.05,
                               backoff_max=0.2)
            bus_b = NetworkBus(hub.address, backoff_initial=0.05,
                               backoff_max=0.2)
            got = []
            bus_b.subscribe("/cslam/x", got.append)
            time.sleep(0.3)
            bus_a.publish("/cslam/x", 0, src_robot=0)
            assert wait_for(lambda: bus_b.deliver() or got)
            # hub restarts; A reconnects first and floods PAST the new
            # hub's 8-frame ring before B's resync-from-0 lands
            hub.close()
            time.sleep(0.2)
            hub = TransportHub(host="127.0.0.1", port=port, history=8)
            assert wait_for(lambda: bus_a.connection_stats()["connected"],
                            timeout=8.0)
            for i in range(32):
                bus_a.publish("/cslam/x", 1 + i, src_robot=0)
            assert wait_for(
                lambda: bus_b.deliver() or len(got) >= 9, timeout=8.0)
            time.sleep(0.4)
            bus_b.deliver()
            stats = bus_b.connection_stats()
            # B missed the frames the ring evicted — and knows it
            if stats["missed_frames"] == 0:
                # timing fallback: B's resync may have landed before the
                # flood, in which case nothing was missed and all arrived
                assert len(got) == 33
            else:
                assert stats["seq_gaps"] >= 1
                assert len(got) < 33
            bus_a.close()
            bus_b.close()
        finally:
            hub.close()


_PROC_CLIENT = r'''
import sys, time
sys.path.insert(0, %(repo)r)
from cslam_tpu_torch.runtime.transport import NetworkBus

rid = int(sys.argv[1])
bus = NetworkBus(("127.0.0.1", %(port)d),
                 backoff_initial=0.05, backoff_max=0.2)
got = []
bus.subscribe("/cslam/chat", got.append)
time.sleep(0.8)  # both peers join before first publish (volatile QoS)
for i in range(12):
    bus.publish("/cslam/chat", f"r{rid}-m{i}", rid)
    bus.deliver()
    time.sleep(0.25)
deadline = time.time() + 8
want = {f"r{1 - rid}-m{i}" for i in range(12)}
while time.time() < deadline and not want <= set(got):
    bus.deliver()
    time.sleep(0.1)
missing = sorted(want - set(got))
print(f"missing={missing} reconnects={bus.reconnects}", flush=True)
bus.close()
sys.exit(0 if not missing else 1)
'''


class TestTransientLocal:
    """Transient-local (latched) durability across the hub: the reference
    publishes ReferenceFrames latched so robots that come into range LATE
    still receive them (decentralized_pgo.cpp:194-196). The hub keeps the
    latest latched frame per (topic, publisher) and serves it at every
    resync; publishers re-latch onto fresh hub generations."""

    def test_late_joiner_receives_latched_frame(self):
        # small ring so the latched frame is long gone from replay
        hub = TransportHub(history=4)
        bus_a = NetworkBus(hub.address)
        try:
            bus_a.publish("/cslam/ref", {"origin": 0}, src_robot=0,
                          latch=True)
            for i in range(16):   # evict it from the replay ring
                bus_a.publish("/cslam/noise", i, src_robot=0)

            bus_late = NetworkBus(hub.address)   # fresh join, future-only
            got = []
            from cslam_tpu_torch.runtime.bus import QoSProfile
            bus_late.subscribe("/cslam/ref", got.append,
                               qos=QoSProfile(transient_local=True))
            assert wait_for(lambda: bus_late.deliver() or got)
            assert got == [{"origin": 0}]
            bus_late.close()
        finally:
            bus_a.close()
            hub.close()

    def test_latched_value_last_write_wins(self):
        hub = TransportHub()
        bus_a = NetworkBus(hub.address)
        try:
            own = []
            bus_a.subscribe("/cslam/ref", own.append)
            bus_a.publish("/cslam/ref", 1, src_robot=0, latch=True)
            bus_a.publish("/cslam/ref", 2, src_robot=0, latch=True)
            # the late joiner joins after the hub relayed both (else it
            # rightly gets 1 from the store and then 2 live)
            assert wait_for(lambda: bus_a.deliver() or len(own) >= 2)
            bus_late = NetworkBus(hub.address)
            got = []
            bus_late.subscribe("/cslam/ref", got.append)
            assert wait_for(lambda: bus_late.deliver() or got)
            assert got[-1] == 2 and len(got) == 1
            bus_late.close()
        finally:
            bus_a.close()
            hub.close()

    def test_multi_topic_latch_store_order_independent(self):
        """Review scenario: latch refA, latch refB, update refA — the hub
        store now serves refA(newest) before refB. A shared-watermark
        dedup would drop refB forever; the per-(topic, publisher) latch
        watermark must deliver both."""
        hub = TransportHub()
        bus_a = NetworkBus(hub.address)
        try:
            bus_a.publish("/cslam/refA", "A0", src_robot=0, latch=True)
            bus_a.publish("/cslam/refB", "B0", src_robot=0, latch=True)
            bus_a.publish("/cslam/refA", "A1", src_robot=0, latch=True)
            own = []
            bus_a.subscribe("/cslam/noise", own.append)
            for i in range(8):
                bus_a.publish("/cslam/noise", i, src_robot=0)
            # join after the hub relayed everything (else A0 may be served
            # from the store and A1 arrive live)
            assert wait_for(lambda: bus_a.deliver() or len(own) >= 8)
            bus_late = NetworkBus(hub.address)
            got_a, got_b = [], []
            bus_late.subscribe("/cslam/refA", got_a.append)
            bus_late.subscribe("/cslam/refB", got_b.append)
            assert wait_for(
                lambda: bus_late.deliver() or (got_a and got_b),
                timeout=10.0)
            assert got_a == ["A1"] and got_b == ["B0"]
            bus_late.close()
        finally:
            bus_a.close()
            hub.close()

    def test_latched_frame_survives_replay_of_newer_traffic(self):
        """Review scenario: a joiner whose resync replays NEWER frames
        from the publisher first (advancing the retransmit watermark)
        must still deliver the older latched frame afterwards."""
        hub = TransportHub(history=64)
        bus_a = NetworkBus(hub.address)
        bus_b = NetworkBus(hub.address)
        try:
            got = []
            bus_b.subscribe("/cslam/ref", got.append)
            bus_a.publish("/cslam/ref", "frame0", src_robot=0, latch=True)
            for i in range(10):
                bus_a.publish("/cslam/noise", i, src_robot=0)
            assert wait_for(lambda: bus_b.deliver() or got)
            # simulate the raced handshake: force bus_b to resync from 0
            # on its current connection state (replays everything — newer
            # noise frames advance the shared watermark — then the hub
            # serves the latched frame again; nothing may double-deliver)
            from cslam_tpu_torch.runtime.transport import _shutdown_close
            bus_b._last_seq = -1
            bus_b._pub_seen.clear()
            bus_b._latch_seen.clear()
            _shutdown_close(bus_b._sock)   # blip -> reconnect same gen
            assert wait_for(
                lambda: bus_b.connection_stats()["reconnects"] >= 1
                and bus_b.connection_stats()["connected"], timeout=10.0)
            deadline = time.time() + 3
            while time.time() < deadline:
                bus_b.deliver()
                time.sleep(0.05)
            assert got == ["frame0", "frame0"]  # replayed once, not lost
            assert bus_b._latched.get("/cslam/ref") == ("frame0", 0)
        finally:
            bus_a.close()
            bus_b.close()
            hub.close()

    def test_relatch_after_hub_restart(self):
        hub = TransportHub()
        host, port = hub.address
        bus_a = NetworkBus(hub.address)
        try:
            got_a_own = []
            bus_a.subscribe("/cslam/ref", got_a_own.append)
            bus_a.publish("/cslam/ref", {"g": 1}, src_robot=0, latch=True)
            assert wait_for(lambda: bus_a.deliver() or got_a_own)

            hub.close()
            assert wait_for(
                lambda: not bus_a.connection_stats()["connected"])
            hub = TransportHub(host, port)   # fresh generation, empty store
            assert wait_for(
                lambda: bus_a.connection_stats()["connected"], timeout=10.0)

            # a client joining only the NEW hub still gets the frame
            bus_late = NetworkBus(hub.address)
            got = []
            bus_late.subscribe("/cslam/ref", got.append)
            assert wait_for(lambda: bus_late.deliver() or got, timeout=10.0)
            assert got == [{"g": 1}]
            # and the original publisher did not double-deliver to itself
            bus_a.deliver()
            assert got_a_own == [{"g": 1}]
            bus_late.close()
        finally:
            bus_a.close()
            hub.close()

    def test_relatch_flush_order_preserves_all_topics(self):
        """Review scenario: two latched topics re-flushed onto a standby
        must arrive in publisher-seq order — a reversed flush makes
        receivers' retransmit watermark drop all but the newest."""
        primary = TransportHub()
        standby = TransportHub()
        bus_a = NetworkBus(hub_addresses=[primary.address, standby.address])
        bus_b = NetworkBus(standby.address)   # already on the standby
        try:
            got_a, got_b = [], []
            bus_b.subscribe("/cslam/refA", got_a.append)
            bus_b.subscribe("/cslam/refB", got_b.append)
            bus_a.publish("/cslam/refA", "A", src_robot=0, latch=True)
            bus_a.publish("/cslam/refB", "B", src_robot=0, latch=True)
            time.sleep(0.3)
            primary.close()
            assert wait_for(
                lambda: bus_a.connection_stats()["failovers"] >= 1
                and bus_a.connection_stats()["connected"], timeout=10.0)
            # deliver until both topics are in (one deliver() may run
            # between the two frames' arrival)
            assert wait_for(
                lambda: (bus_b.deliver(), bool(got_a and got_b))[1],
                timeout=10.0)
            assert got_a == ["A"] and got_b == ["B"]
        finally:
            bus_a.close()
            bus_b.close()
            primary.close()
            standby.close()

    def test_relatch_after_failover(self):
        primary = TransportHub()
        standby = TransportHub()
        bus_a = NetworkBus(hub_addresses=[primary.address, standby.address])
        try:
            bus_a.publish("/cslam/ref", "frameA", src_robot=0, latch=True)
            time.sleep(0.3)
            primary.close()
            assert wait_for(
                lambda: bus_a.connection_stats()["connected"]
                and bus_a.connection_stats()["failovers"] >= 1,
                timeout=10.0)
            bus_late = NetworkBus(standby.address)
            got = []
            bus_late.subscribe("/cslam/ref", got.append)
            assert wait_for(lambda: bus_late.deliver() or got, timeout=10.0)
            assert got == ["frameA"]
            bus_late.close()
        finally:
            bus_a.close()
            primary.close()
            standby.close()


def test_hub_restart_across_processes(tmp_path):
    """Two real OS-process clients across a hub kill/restart: zero frame
    loss. In-process threaded tests have missed stream races that real
    processes caught; this also exercises the generation/seq replay ring
    end-to-end (a peer flushing its outage buffer before the other client
    reconnects must not lose frames for the late reconnector)."""
    import subprocess
    import sys as _sys
    repo = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    hub = TransportHub(host="127.0.0.1", port=0)
    port = hub.address[1]
    code = _PROC_CLIENT % {"repo": repo, "port": port}
    procs = [subprocess.Popen(
        [_sys.executable, "-u", "-c", code, str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    try:
        time.sleep(2.2)        # ~6 frames exchanged live
        hub.close()
        time.sleep(1.5)        # clients publish into outage buffers
        hub = TransportHub(host="127.0.0.1", port=port)  # new generation
        outs = [p.communicate(timeout=30)[0] for p in procs]
        assert all(p.returncode == 0 for p in procs), outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        hub.close()


class TestTransportChaos:
    """Property-style stress: under random hub kills/restarts/failovers,
    every receiver must see each publisher's stream as a STRICTLY
    INCREASING subsequence (exactly-once up to counted losses, never
    duplicated, never reordered) — the invariant all the watermark/
    replay/re-latch machinery exists to uphold."""

    def test_ordering_and_no_duplicates_under_hub_chaos(self):
        primary = TransportHub(history=64)
        standby = TransportHub(history=64)
        addr_p, addr_s = primary.address, standby.address
        hubs = {"p": primary, "s": standby}
        buses = [NetworkBus(hub_addresses=[addr_p, addr_s])
                 for _ in range(3)]
        received = [[] for _ in buses]
        for bus, sink in zip(buses, received):
            bus.subscribe("/cslam/chaos", sink.append)
        try:
            n_msgs = 60
            for i in range(n_msgs):
                for pid, bus in enumerate(buses):
                    bus.publish("/cslam/chaos", (pid, i), src_robot=pid)
                for bus in buses:
                    bus.deliver()
                time.sleep(0.01)
                if i in (15, 35):        # kill whichever hub is alive first
                    key = "p" if i == 15 else "s"
                    before = [b.connection_stats()["disconnects"]
                              + b.connection_stats()["failovers"]
                              for b in buses]
                    hubs[key].close()
                    # first wait until every client OBSERVED the death
                    # (connected stays True until the reader hits EOF),
                    # then until every client landed somewhere again
                    assert wait_for(lambda: all(
                        b.connection_stats()["disconnects"]
                        + b.connection_stats()["failovers"] > pre
                        for b, pre in zip(buses, before)), timeout=10.0)
                    assert wait_for(lambda: all(
                        b.connection_stats()["connected"] for b in buses),
                        timeout=10.0)
                if i == 25:              # resurrect the primary
                    hubs["p"] = TransportHub(addr_p[0], addr_p[1],
                                             history=64)
            deadline = time.time() + 5
            while time.time() < deadline:
                for bus in buses:
                    bus.deliver()
                time.sleep(0.05)

            for rid, sink in enumerate(received):
                per_pub = {}
                for pid, i in sink:
                    per_pub.setdefault(pid, []).append(i)
                for pid, seq in per_pub.items():
                    assert seq == sorted(set(seq)), (
                        f"receiver {rid} saw publisher {pid} out of order "
                        f"or duplicated: {seq}")
                # liveness: the final messages (published when a hub was
                # up and stable) must have arrived from every publisher
                assert all(per_pub.get(pid, [-1])[-1] >= n_msgs - 5
                           for pid in range(len(buses))), per_pub
        finally:
            for bus in buses:
                bus.close()
            for hub in hubs.values():
                hub.close()


def _tensors_in(obj, seen=None) -> int:
    """Count the ``torch.Tensor`` objects reachable from ``obj`` through
    containers, dataclass fields and instance attributes."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float, bool,
                                           type(None))):
        return 0
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return 1
    if isinstance(obj, np.ndarray):
        return (sum(_tensors_in(x, seen) for x in obj.ravel())
                if obj.dtype == object else 0)
    if isinstance(obj, dict):
        return sum(_tensors_in(k, seen) + _tensors_in(v, seen)
                   for k, v in obj.items())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return sum(_tensors_in(x, seen) for x in obj)
    fields = dict(getattr(obj, "__dict__", {}))
    for name in getattr(type(obj), "__slots__", ()):
        if hasattr(obj, name):
            fields[name] = getattr(obj, name)
    return sum(_tensors_in(v, seen) for v in fields.values())


class TestNoDeviceStateOnTheWire:

    def test_full_node_stack_frames_carry_no_tensor(self, monkeypatch):
        """Every frame the full-node-stack case encodes (the nodes' own
        publishes and the hub's relays) is walked: no ``torch.Tensor``."""
        from cslam_tpu_torch.runtime import transport
        frames = []
        encode = transport._encode

        def recording_encode(topic, msg, *args, **kwargs):
            frames.append((topic, msg))
            return encode(topic, msg, *args, **kwargs)
        monkeypatch.setattr(transport, "_encode", recording_encode)
        _full_node_stack()
        topics = {t for t, _ in frames}
        assert {"/r0/cslam/keyframe_data", "/cslam/global_descriptors",
                transport._DATA} <= topics, sorted(topics)
        assert sum(_tensors_in(m) for _, m in frames) == 0
        # the walk does see a tensor where there is one
        assert _tensors_in(GlobalDescriptors(descriptors=[GlobalDescriptor(
            keyframe_id=0, robot_id=0, descriptor=torch.zeros(3))])) == 1

    def test_encode_refuses_a_tensor(self):
        """A tensor anywhere in a frame is refused at the sender, CPU or
        not, nested or not."""
        from cslam_tpu_torch.runtime.transport import _encode
        with pytest.raises(TypeError, match="torch.Tensor"):
            _encode("/cslam/x", torch.zeros(2), 0)
        with pytest.raises(TypeError, match="torch.Tensor"):
            _encode("/cslam/x", GlobalDescriptors(descriptors=[
                GlobalDescriptor(keyframe_id=0, robot_id=0,
                                 descriptor=torch.zeros(3))]), 0,
                    pub=("p", 0))
        assert len(_encode("/cslam/x", np.zeros(3), 0)) > 4

    def test_frame_unpickles_without_the_jax_package(self, tmp_path):
        """A port frame names only the port's classes: a fresh interpreter
        in which ``cslam_tpu`` and ``jax`` cannot be imported decodes it."""
        import pathlib
        import subprocess
        import sys as _sys

        from cslam_tpu_torch.runtime.transport import _encode
        from cslam_tpu_torch.types import KeyframeRGB
        frame = _encode("/cslam/global_descriptors", GlobalDescriptors(
            descriptors=[GlobalDescriptor(keyframe_id=3, robot_id=1,
                                          descriptor=np.arange(4.0))]), 1,
            pub=("p", 7))
        frame2 = _encode("/r1/cslam/keyframe_data",
                         KeyframeRGB(id=2, image=np.ones((2, 2))), 1)
        (tmp_path / "frames.bin").write_bytes(frame + frame2)
        repo = str(pathlib.Path(__file__).resolve().parents[1])
        code = (
            "import io, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['cslam_tpu'] = None\n"
            "from cslam_tpu_torch.runtime.transport import _HEADER\n"
            "import pickle\n"
            f"data = open({str(tmp_path / 'frames.bin')!r}, 'rb').read()\n"
            "out, pos = [], 0\n"
            "while pos < len(data):\n"
            "    (n,) = _HEADER.unpack(data[pos:pos + 4])\n"
            "    out.append(pickle.loads(data[pos + 4:pos + 4 + n]))\n"
            "    pos += 4 + n\n"
            "(t, msg, src, pub), (t2, kf, src2) = out\n"
            "d = msg.descriptors[0]\n"
            "print(type(msg).__module__, t, src, pub, d.keyframe_id,\n"
            "      d.descriptor.sum(), type(kf).__name__, kf.image.shape)\n"
            "print(sorted(m for m, mod in sys.modules.items()\n"
            "             if m.split('.')[0] in ('cslam_tpu', 'jax')\n"
            "             and mod is not None))\n")
        out = subprocess.run([_sys.executable, "-c", code], cwd=repo,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        lines = out.stdout.splitlines()
        assert lines[0].split() == [
            "cslam_tpu_torch.types", "/cslam/global_descriptors", "1",
            "('p',", "7)", "3", "6.0", "KeyframeRGB", "(2,", "2)"]
        assert lines[1] == "[]"
