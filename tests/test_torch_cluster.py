"""The cluster tier (``repro_torch.cluster``) on the port's copy of the
control plane, on the CPU, and the same cluster runs in both packages.

These are the contracts of the JAX package's ``tests/test_cluster_executor.py``,
``test_transport.py`` and ``test_cluster_sim.py``, run on
``repro_torch.cluster``, each limit as the original has it: roster parsing
and placement, the content-addressed cross-host fetch, the socket tier end to
end (its FIFO streams equal the process tier's, a crashed trial restores
across hosts, a corrupt frame evicts its host and the pump survives, a wrong
roster token is turned away), the wire framing under fuzzed and malformed
input, age math that rides the monotonic clock, and the simulated fleet's
host-fault matrix on virtual time.  Worker processes run the port's toy
trainables (``_torch_worker_trainables``), forked from its own forkserver.

Then both packages in one process: the same host-fault scenario (a crash and
a partition on a ``4x4`` roster under ``VirtualClock``) gives the same
journal (results, decisions, restarts, kills, trial ends) and the same host
evictions, and the same 2-host socket-tier FIFO sweep of ``LrCounter`` gives
the same statuses, streams and losses.  Placement is ``fixed`` throughout, so
the port's H100 ``HostSpec`` defaults steer nothing.
"""
import json
import os
import pickle
import socket
import struct
import threading
import time

import jax  # noqa: F401  (both packages in one process, as in every test_torch_* file)
import pytest
import torch  # noqa: F401

import _torch_worker_trainables as PW
import _worker_trainables as JW
import repro.core as jcore
import repro.testing as jtesting
import repro_torch.core as pcore
import repro_torch.testing as ptesting
from repro_torch.cluster import (ClusterMeshExecutor, FixedPlacement, HostSpec,
                                 RooflinePlacement, parse_hosts)
from repro_torch.cluster.hosts import HostAgent, fetch
from repro_torch.cluster.placement import estimate_step_s, workload_cost
from repro_torch.cluster.transport import (DEFAULT_MAX_FRAME, HEARTBEAT, MAGIC,
                                           PROTO_VERSION, FramingError,
                                           TransportClosed, TransportError,
                                           client_handshake, server_handshake,
                                           virtual_pair)
from repro_torch.core import (CheckpointManager, EventType, FIFOScheduler,
                              ObjectStore, Resources, TrainableFactory, Trial,
                              TrialStatus, grid_search, register_worker_factory,
                              run_experiments)
from repro_torch.core.clock import VirtualClock, WallClock
from repro_torch.core.object_store import ObjectStore as _Store
from repro_torch.testing import Scenario, run_scenario
from repro_torch.testing.invariants import (check_decision_provenance,
                                            check_event_log, check_no_slice_leaks)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


# -- the cluster executor (test_cluster_executor.py) ------------------------------------

def factory(name: str) -> TrainableFactory:
    return TrainableFactory(target=f"_torch_worker_trainables:{name}",
                            sys_path=(TESTS_DIR,))


def make_executor(name: str, hosts="2x4", **kw):
    kw.setdefault("placement", "fixed")
    return ClusterMeshExecutor(
        factory_resolver=lambda _n: factory(name),
        checkpoint_manager=CheckpointManager(ObjectStore()),
        hosts=hosts, checkpoint_freq=kw.pop("checkpoint_freq", 1), **kw)


# -- roster parsing --------------------------------------------------------------------

class TestParseHosts:
    def test_formats(self):
        assert [(s.name, s.devices) for s in parse_hosts(3)] == [
            ("h0", 8), ("h1", 8), ("h2", 8)]
        assert [(s.name, s.devices) for s in parse_hosts("2x4")] == [
            ("h0", 4), ("h1", 4)]
        assert [(s.name, s.devices) for s in parse_hosts("a:2,b:6")] == [
            ("a", 2), ("b", 6)]
        specs = parse_hosts([HostSpec("x", devices=1), ("y", 3)])
        assert [(s.name, s.devices) for s in specs] == [("x", 1), ("y", 3)]

    def test_rejects_duplicates_and_empty(self):
        with pytest.raises(ValueError):
            parse_hosts("a:2,a:4")
        with pytest.raises(ValueError):
            parse_hosts([])


# -- placement cost model --------------------------------------------------------------

def _trial(config=None, devices=1):
    return Trial(config or {}, trainable_name="T",
                 resources=Resources(cpu=1.0, devices=devices),
                 stopping_criteria={"training_iteration": 1})


class TestPlacement:
    def test_collective_term_grows_with_width(self):
        spec = HostSpec("h", devices=8)
        cost = {"flops": 0.0, "bytes": 0.0, "coll_bytes": 1e9}
        assert estimate_step_s(cost, spec, 1) == 0.0  # no ring of one
        assert (estimate_step_s(cost, spec, 8)
                > estimate_step_s(cost, spec, 2) > 0.0)

    def test_roofline_right_sizes_instead_of_max_width(self):
        """Collective-bound workload: the model must pick a NARROW slice
        even though 8 devices are free."""
        hosts = [HostAgent(HostSpec("h0", devices=8), WallClock())]
        pol = RooflinePlacement(devices_per_trial=8)
        t = _trial({"_cost": {"flops": 1e9, "bytes": 0.0, "coll_bytes": 1e12}},
                   devices=8)
        choice = pol.place(t, hosts)
        assert choice is not None
        host, width = choice
        assert width < 8, ("collective-bound trial was given the full host; "
                           "right-sizing is not happening")

    def test_roofline_compute_bound_goes_wide(self):
        hosts = [HostAgent(HostSpec("h0", devices=8), WallClock())]
        pol = RooflinePlacement(devices_per_trial=1)
        t = _trial({"_cost": {"flops": 1e18, "bytes": 0.0, "coll_bytes": 0.0}},
                   devices=1)
        _, width = pol.place(t, hosts)
        assert width == 8, "compute-bound trial should take the widest slice"

    def test_unprofiled_falls_back_to_fixed(self):
        hosts = [HostAgent(HostSpec("h0", devices=8), WallClock())]
        pol = RooflinePlacement(devices_per_trial=2)
        t = _trial(devices=4)
        assert workload_cost(t) is None
        _, width = pol.place(t, hosts)
        assert width == 2  # devices_per_trial override, not the request

    def test_profile_denormalizes_to_cost(self):
        t = _trial()
        t.profile = {"roofline_compute_s": 1.0, "roofline_memory_s": 0.5,
                     "roofline_collective_s": 0.0, "dominant": "compute"}
        cost = workload_cost(t)
        assert cost is not None and cost["flops"] > 0 and cost["bytes"] > 0

    def test_fixed_prefers_most_free_alive_host(self):
        clock = WallClock()
        a = HostAgent(HostSpec("a", devices=8), clock)
        b = HostAgent(HostSpec("b", devices=8), clock)
        a.pool.acquire(6)
        choice = FixedPlacement().place(_trial(devices=2), [a, b])
        assert choice is not None and choice[0] is b
        b.alive = False
        choice = FixedPlacement().place(_trial(devices=2), [a, b])
        assert choice is not None and choice[0] is a


# -- cross-host checkpoint fetch -------------------------------------------------------

class TestFetch:
    def test_cas_digest_verified(self, tmp_path):
        import hashlib
        src = _Store(spill_dir=str(tmp_path / "src"))
        dst = _Store(spill_dir=str(tmp_path / "dst"))
        data = b"checkpoint-bytes"
        key = f"cas/t0/{hashlib.sha256(data).hexdigest()}"
        src.put_spilled(data, key=key)
        fetch(key, src, dst)
        assert dst.peek(key) == data
        # Corrupt payload under a digest key must be refused.
        bad_key = f"cas/t0/{hashlib.sha256(b'other').hexdigest()}"
        src.put_spilled(data, key=bad_key)
        with pytest.raises(IOError):
            fetch(bad_key, src, dst)

    def test_missing_key_raises(self, tmp_path):
        src = _Store(spill_dir=str(tmp_path / "a"))
        dst = _Store(spill_dir=str(tmp_path / "b"))
        with pytest.raises(KeyError):
            fetch("cas/t0/nope", src, dst)


# -- socket tier end-to-end ------------------------------------------------------------

@pytest.mark.timeout(600)
class TestSocketTier:
    def test_fifo_stream_equality_vs_process_tier(self):
        """Acceptance criterion: a 2-host localhost-socket sweep reproduces
        the process tier's statuses, result streams and losses exactly."""
        from _torch_worker_trainables import LrCounter
        register_worker_factory("LrCounter", factory("LrCounter"))

        def sweep(executor, **kw):
            an = run_experiments(
                LrCounter, {"lr": grid_search([0.001, 0.005, 0.02, 0.08])},
                stop={"training_iteration": 5}, checkpoint_freq=1,
                executor=executor, seed=0, total_devices=8, **kw)
            return {
                t.config["lr"]: (t.status.value,
                                 [r.training_iteration for r in t.results],
                                 [r.metrics["loss"] for r in t.results])
                for t in an.trials}

        ref = sweep("process")
        got = sweep("cluster", hosts="2x4", placement="fixed")
        assert got == ref

    def test_crash_restart_restores_across_hosts(self, tmp_path):
        """A crashed trial's checkpoint was fetched to the controller before
        adoption, so the restart restores wherever placement lands it."""
        from _torch_worker_trainables import CrashOnce
        register_worker_factory("CrashOnce", factory("CrashOnce"))
        an = run_experiments(
            CrashOnce, {"marker_dir": str(tmp_path), "fail_at": 3},
            stop={"training_iteration": 6}, checkpoint_freq=1,
            executor="cluster", hosts="2x4", placement="fixed",
            max_failures=2, seed=0)
        (t,) = an.trials
        assert t.status == TrialStatus.TERMINATED
        assert t.num_failures == 1
        ns = [round(1.0 / r.metrics["loss"]) for r in t.results]
        assert ns == [1, 2, 3, 4, 5, 6], (
            f"stream reset instead of restoring from checkpoint: {ns}")

    def test_framing_corruption_evicts_host_pump_survives(self):
        """A stranger dialing back with the victim's trial_id and spewing a
        corrupt frame must evict that host — and the pump must keep serving
        the other host's trials afterwards."""
        ex = make_executor("Sleeper", hosts="2x2", heartbeat_timeout=0.0)
        victim = Trial({"sleep_s": 0.2}, trainable_name="Sleeper",
                       resources=Resources(cpu=1.0, devices=1),
                       stopping_criteria={"training_iteration": 50},
                       trial_id="victim")
        try:
            assert ex.start_trial(victim)
            deadline = time.time() + 60
            while time.time() < deadline:
                if ex.get_next_event(timeout=1.0) is not None:
                    break  # worker is up and talking
            victim_host = ex._host_of["victim"].name
            # Reconnect-attach as the victim, then send garbage.
            sock = socket.create_connection(ex._listener.address, timeout=10)
            tr = client_handshake(
                sock, {"trial_id": "victim", "pid": 0, "token": ex._token})
            junk = b"this is not a pickle"
            tr.sock.sendall(struct.pack("!I", len(junk)) + junk)
            deadline = time.time() + 60
            while time.time() < deadline and ex.n_host_evictions == 0:
                ex.get_next_event(timeout=0.5)
            assert ex.n_host_evictions == 1
            assert not ex.hosts[victim_host].alive
            assert "corrupt" in (ex.hosts[victim_host].evicted_reason or "")
            tr.close()

            # The pump is not wedged: a fresh trial on the surviving host
            # still runs to completion.
            pump_alive = any(t.name == "repro-proc-pump" and t.is_alive()
                             for t in threading.enumerate())
            assert pump_alive, "pump thread died on the corrupt frame"
            after = Trial({"sleep_s": 0.01}, trainable_name="Sleeper",
                          resources=Resources(cpu=1.0, devices=1),
                          stopping_criteria={"training_iteration": 1},
                          trial_id="after")
            assert ex.start_trial(after)
            seen = set()
            deadline = time.time() + 60
            while time.time() < deadline and EventType.RESULT not in seen:
                ev = ex.get_next_event(timeout=1.0)
                if ev is not None and ev.trial_id == "after":
                    seen.add(ev.type)
            assert EventType.RESULT in seen, (
                "surviving host's trial produced nothing — pump wedged")
        finally:
            ex.shutdown()

    def test_host_state_and_listener_rejects_bad_token(self):
        ex = make_executor("Counter", hosts="2x2", heartbeat_timeout=0.0)
        try:
            state = ex.host_state()
            assert sorted(state) == ["h0", "h1"]
            assert all(s["alive"] and s["free"] == 2 for s in state.values())
            # A dialer with the wrong roster token is turned away: the
            # handshake acks (the token rides the hello, checked after), then
            # the listener hangs up without attaching.
            sock = socket.create_connection(ex._listener.address, timeout=10)
            sock.settimeout(10)
            tr = client_handshake(
                sock, {"trial_id": "x", "pid": 0, "token": "wrong"},
                timeout=10.0)
            tr.sock.settimeout(10.0)
            with pytest.raises(EOFError):
                tr.recv()
            tr.close()
            deadline = time.time() + 10
            while time.time() < deadline and ex._listener.n_rejected == 0:
                time.sleep(0.05)
            assert ex._listener.n_rejected == 1
        finally:
            ex.shutdown()


# -- the wire framing (test_transport.py) -----------------------------------------------

def pair():
    """A connected (server_transport, client_socket) pair, handshake done."""
    srv = socket.create_server(("127.0.0.1", 0))
    addr = srv.getsockname()[:2]
    out = {}

    def serve():
        s, _ = srv.accept()
        out["tr"], out["hello"] = server_handshake(s)

    t = threading.Thread(target=serve)
    t.start()
    c = socket.create_connection(addr)
    ctr = client_handshake(c, {"trial_id": "t0", "pid": 1, "token": "tok"})
    t.join()
    srv.close()
    return out["tr"], ctr, out["hello"]


class TestFraming:
    def test_round_trip_and_hello(self):
        tr, ctr, hello = pair()
        assert hello == {"trial_id": "t0", "pid": 1, "token": "tok"}
        ctr.send(("STEP", {"k": 1}))
        assert tr.recv() == ("STEP", {"k": 1})
        tr.send(("RESULT", [1, 2, 3]))
        assert ctr.recv() == ("RESULT", [1, 2, 3])
        tr.close()
        ctr.close()

    def test_heartbeat_is_zero_length_frame_and_returns_sentinel(self):
        tr, ctr, _ = pair()
        ctr.send_heartbeat()
        # Must RETURN the sentinel, not swallow it and block for a next
        # frame: a recv that loops would wedge the shared pump thread.
        assert tr.recv() == HEARTBEAT
        tr.close()
        ctr.close()

    def test_large_frame_round_trips(self):
        tr, ctr, _ = pair()
        blob = os.urandom(2_000_000)
        ctr.send(("CKPT", blob))
        kind, got = tr.recv()
        assert kind == "CKPT" and got == blob
        tr.close()
        ctr.close()

    def test_partial_reads_reassemble(self):
        """A frame dribbled one byte at a time still parses (TCP gives no
        message boundaries; _read_exact must loop)."""
        tr, ctr, _ = pair()
        payload = pickle.dumps(("STEP", {"x": list(range(100))}))
        frame = struct.pack("!I", len(payload)) + payload
        done = []

        def dribble():
            for i in range(len(frame)):
                ctr.sock.sendall(frame[i:i + 1])
                if i % 50 == 0:
                    time.sleep(0.001)
            done.append(True)

        t = threading.Thread(target=dribble)
        t.start()
        assert tr.recv() == ("STEP", {"x": list(range(100))})
        t.join()
        assert done
        tr.close()
        ctr.close()


class TestMalformedInput:
    """Every corruption class maps to a typed error, immediately."""

    def test_oversized_frame_rejected_before_allocation(self):
        tr, ctr, _ = pair()
        ctr.sock.sendall(struct.pack("!I", DEFAULT_MAX_FRAME + 1))
        with pytest.raises(FramingError, match="cap"):
            tr.recv()
        tr.close()
        ctr.close()

    def test_corrupt_length_prefix_garbage_payload(self):
        """A plausible length followed by non-pickle bytes -> FramingError
        (corrupt stream), not a crash and not a hang."""
        tr, ctr, _ = pair()
        junk = b"\x00\x01\x02not a pickle at all"
        ctr.sock.sendall(struct.pack("!I", len(junk)) + junk)
        with pytest.raises(FramingError):
            tr.recv()
        tr.close()
        ctr.close()

    def test_mid_frame_disconnect_is_transport_closed(self):
        tr, ctr, _ = pair()
        payload = pickle.dumps(("STEP",))
        # Announce a full frame, deliver half, vanish.
        ctr.sock.sendall(struct.pack("!I", len(payload)) + payload[: len(payload) // 2])
        ctr.close()
        with pytest.raises(TransportClosed, match="mid-frame"):
            tr.recv()
        tr.close()

    def test_clean_disconnect_between_frames_is_transport_closed(self):
        tr, ctr, _ = pair()
        ctr.close()
        with pytest.raises(TransportClosed):
            tr.recv()
        tr.close()

    def test_error_taxonomy_matches_pump_except_clause(self):
        """The base pump catches (EOFError, OSError); both cluster error
        types must land in that net without the core importing cluster."""
        assert issubclass(TransportClosed, EOFError)
        assert issubclass(FramingError, OSError)
        assert issubclass(TransportClosed, TransportError)
        assert issubclass(FramingError, TransportError)

    @pytest.mark.parametrize("greeting", [
        b"HTTP/1.1 GET /",                      # wrong protocol entirely
        b"XXXX" + bytes([PROTO_VERSION]),       # bad magic
        MAGIC + bytes([PROTO_VERSION + 1]),     # version skew
    ])
    def test_handshake_rejects_bad_greeting(self, greeting):
        srv = socket.create_server(("127.0.0.1", 0))
        addr = srv.getsockname()[:2]
        err = []

        def serve():
            s, _ = srv.accept()
            try:
                server_handshake(s, timeout=5.0)
            except TransportError as e:
                err.append(e)

        t = threading.Thread(target=serve)
        t.start()
        c = socket.create_connection(addr)
        c.sendall(greeting)
        t.join()
        assert err, "server accepted a bad greeting"
        c.close()
        srv.close()

    def test_fuzz_random_prefixes_never_wedge(self):
        """Random garbage streams: recv must raise a TransportError subclass
        within the socket timeout, never hang and never raise anything the
        pump wouldn't catch."""
        import random
        rng = random.Random(0)
        for trial in range(8):
            tr, ctr, _ = pair()
            tr.sock.settimeout(5.0)
            n = rng.randint(1, 64)
            ctr.sock.sendall(bytes(rng.getrandbits(8) for _ in range(n)))
            ctr.close()  # garbage then EOF
            with pytest.raises((TransportError, OSError)):
                while True:  # at most a few frames of garbage then EOF
                    tr.recv()
            tr.close()


class TestWallJumpSafety:
    """Satellite 2: heartbeat/reconnect age math must read clock.monotonic()
    (never time.time()) — the wall-jump-safe contract."""

    class JumpyClock(WallClock):
        """Wall clock whose epoch axis teleports hours on every read; the
        monotonic axis stays honest.  Any age math that touches time()
        becomes wildly wrong under it."""

        def __init__(self):
            super().__init__()
            self._jump = 0.0

        def time(self):
            self._jump = -self._jump + (3600.0 if self._jump <= 0 else 0.0)
            return super().time() + self._jump

    def test_recv_stamp_rides_monotonic_not_wall(self):
        clock = self.JumpyClock()
        srv = socket.create_server(("127.0.0.1", 0))
        addr = srv.getsockname()[:2]
        out = {}

        def serve():
            s, _ = srv.accept()
            out["tr"], _ = server_handshake(s, clock=clock)

        t = threading.Thread(target=serve)
        t.start()
        c = socket.create_connection(addr)
        ctr = client_handshake(c, {"trial_id": "t", "pid": 0, "token": ""})
        t.join()
        srv.close()
        tr = out["tr"]
        before = clock.monotonic()
        ctr.send_heartbeat()
        assert tr.recv() == HEARTBEAT
        after = clock.monotonic()
        # The stamp sits inside the monotonic window: a time()-based stamp
        # would be off by +-1h.
        assert before <= tr.last_recv_mono <= after
        assert abs(tr.last_recv_mono - clock.monotonic()) < 60.0
        tr.close()
        ctr.close()

    def test_host_age_math_survives_wall_jumps(self):
        """A 2-host virtual-tier mini-run under the jumpy clock: heartbeat
        ages stay sane, so no host is ever evicted and every trial finishes.
        If any eviction path read time(), the +-1h teleports would blow the
        1s host_timeout instantly."""
        from repro_torch.cluster import ClusterMeshExecutor
        from repro_torch.cluster.sim import SimFleet
        from repro_torch.core import (CheckpointManager, ObjectStore, Resources,
                                Trial, TrialRunner, FIFOScheduler)
        from repro_torch.core.clock import use_clock
        from repro_torch.core.workers import TrainableFactory

        clock = self.JumpyClock()
        with use_clock(clock):
            ex = ClusterMeshExecutor(
                checkpoint_manager=CheckpointManager(ObjectStore()),
                hosts="2x2", transport="virtual", placement="fixed",
                heartbeat_timeout=0.2,  # -> 0.05s monitor cadence
                host_timeout=1.0, spawn_timeout=0,
                checkpoint_freq=1, clock=clock,
                factory_resolver=lambda _n: TrainableFactory(
                    target="repro_torch.testing.sim:SimTrainable"))
            fleet = SimFleet(ex, clock, heartbeat_interval=0.05)
            runner = TrialRunner(
                FIFOScheduler(metric="loss", mode="min"), ex,
                trainable_name="SimTrainable",
                stopping_criteria={"training_iteration": 3})
            for i in range(3):
                runner.add_trial(Trial(
                    {"sim_id": f"j{i}", "sim_token": "jumpy",
                     "step_s": 0.05},
                    trainable_name="SimTrainable",
                    resources=Resources(cpu=1.0, devices=1),
                    stopping_criteria={"training_iteration": 3},
                    trial_id=f"jumpy-{i}"))
            fleet.start()
            try:
                trials = runner.run()
            finally:
                fleet.stop()
        assert ex.n_host_evictions == 0, (
            "wall-time jumps triggered a host eviction: some age math is "
            "reading time() instead of monotonic()")
        assert all(t.status.value == "TERMINATED" for t in trials)


class TestVirtualTransport:
    def test_round_trip_eof_and_partition(self):
        clock = VirtualClock()
        a, b = virtual_pair(clock, name="v")
        a.send(("STEP",))
        assert b.recv() == ("STEP",)
        assert not b.poll(0)
        a.close()
        with pytest.raises(TransportClosed):
            b.recv()

    def test_partition_drops_silently_but_close_delivers(self):
        clock = VirtualClock()
        dropped = []
        a, b = virtual_pair(clock, name="p",
                            drop=lambda side, obj: dropped.append(obj) or True)
        a.send(("RESULT", 1))
        assert b._q.empty() and dropped == [("RESULT", 1)]
        # A SIGKILL'd process's FIN still arrives through a partition.
        a.close()
        with pytest.raises(TransportClosed):
            b.recv()

    def test_send_after_peer_close_raises(self):
        clock = VirtualClock()
        a, b = virtual_pair(clock, name="c")
        b.close()
        with pytest.raises(TransportClosed):
            a.send(("STEP",))


# -- the simulated fleet (test_cluster_sim.py) ------------------------------------------

def _fifo():
    return FIFOScheduler(metric="loss", mode="min")


def run(sc, **kw):
    return run_scenario(sc, _fifo, executor="cluster",
                        max_steps=500_000, **kw)


@pytest.mark.timeout(120)
class TestHostFaultMatrix:
    def test_crash_and_partition_fleet_survives(self):
        """4 hosts, 12 trials; h1 dies abruptly at t=8s and h2 falls off the
        network at t=12s for 200s (longer than host_timeout, so it is
        evicted too).  Every trial must still terminate, every invariant
        must hold, and both evictions must be attributed correctly."""
        sc = Scenario(
            name="crash+partition", stop_iteration=40, max_failures=2,
            heartbeat_timeout=60.0, hosts="4x4", host_timeout=90.0,
            host_faults=[("crash", "h1", 8.0),
                         ("partition", "h2", 12.0, 200.0)],
            configs=[{"lr": 0.01 + i * 0.001, "step_s": 1.0,
                      "jitter_s": 0.25} for i in range(12)])
        res = run(sc)
        check_no_slice_leaks(res)
        check_event_log(res)
        check_decision_provenance(res)
        assert res.by_status() == {"TERMINATED": 12}, res.by_status()
        ex = res.executor
        assert ex.n_host_evictions == 2
        assert not ex.hosts["h1"].alive
        assert "crash" in ex.hosts["h1"].evicted_reason
        assert not ex.hosts["h2"].alive
        assert "no heartbeat" in ex.hosts["h2"].evicted_reason
        assert ex.hosts["h0"].alive and ex.hosts["h3"].alive
        # Each evicted host's resident trials were requeued, so restarts at
        # least match the trials the two dead hosts were carrying — and the
        # partition really dropped traffic on the floor.
        assert res.runner.n_restarts > 0
        # crash + partition fired; the heal (t=212s) may land after the run
        # already finished, in which case the fault loop is stopped first.
        assert res.fleet.n_faults_fired >= 2
        assert res.fleet.network.n_dropped > 0
        # Virtual run: hundreds of simulated seconds, sub-second wall time.
        assert res.virtual_elapsed_s > 40.0
        assert res.wall_elapsed_s < 30.0

    def test_partition_heals_before_timeout_no_eviction(self):
        """A blip shorter than host_timeout must NOT evict: heartbeats resume
        after the heal and the age math forgives."""
        sc = Scenario(
            name="short-blip", stop_iteration=30, max_failures=1,
            heartbeat_timeout=60.0, hosts="2x4", host_timeout=120.0,
            host_faults=[("partition", "h1", 5.0, 20.0)],
            configs=[{"lr": 0.01, "step_s": 1.0} for _ in range(4)])
        res = run(sc)
        check_no_slice_leaks(res)
        check_event_log(res)
        assert res.by_status() == {"TERMINATED": 4}
        assert res.executor.n_host_evictions == 0
        assert res.runner.n_restarts == 0
        assert res.fleet.network.n_dropped > 0  # the blip was real

    def test_losing_every_host_but_one_still_finishes(self):
        """Serial degradation: 3 of 4 hosts crash in sequence; the survivor
        absorbs the whole queue."""
        sc = Scenario(
            name="cascade", stop_iteration=20, max_failures=4,
            heartbeat_timeout=60.0, hosts="4x2", host_timeout=60.0,
            host_faults=[("crash", "h0", 6.0), ("crash", "h1", 14.0),
                         ("crash", "h2", 22.0)],
            configs=[{"lr": 0.01 + i * 0.001, "step_s": 1.0}
                     for i in range(6)])
        res = run(sc)
        check_no_slice_leaks(res)
        check_event_log(res)
        assert res.by_status() == {"TERMINATED": 6}
        ex = res.executor
        assert ex.n_host_evictions == 3
        alive = sorted(n for n, ha in ex.hosts.items() if ha.alive)
        assert alive == ["h3"]

    def test_host_crash_exhausts_trial_budget(self):
        """max_failures=0 turns a host crash into trial ERRORs: the eviction
        is charged to every resident trial's budget."""
        sc = Scenario(
            name="no-budget", stop_iteration=60, max_failures=0,
            heartbeat_timeout=60.0, hosts="2x4", host_timeout=60.0,
            host_faults=[("crash", "h0", 10.0)],
            configs=[{"lr": 0.01 + i * 0.001, "step_s": 1.0}
                     for i in range(8)])
        res = run(sc)
        check_no_slice_leaks(res)
        check_event_log(res)
        by = res.by_status()
        assert by.get("ERROR", 0) >= 1, by  # h0 was carrying trials at t=10
        assert by.get("ERROR", 0) + by.get("TERMINATED", 0) == 8
        for t in res.trials:
            if t.status.value == "ERROR":
                # A scripted crash is indistinguishable from the processes
                # vanishing, so the base worker-death message is the record.
                assert "died unexpectedly" in t.error


@pytest.mark.timeout(120)
class TestDeterminism:
    def test_same_script_same_streams(self):
        """The virtual fleet is deterministic: identical scenario + scheduler
        (and a pinned run token, so trial ids line up) give identical
        per-trial result streams and statuses across runs."""
        def once():
            sc = Scenario(
                name="det", stop_iteration=25, max_failures=2,
                heartbeat_timeout=60.0, hosts="3x2", host_timeout=80.0,
                host_faults=[("crash", "h1", 7.0)],
                configs=[{"lr": 0.01 + i * 0.002, "step_s": 1.0,
                          "jitter_s": 0.5} for i in range(6)])
            res = run(sc, token="pinned")
            return {t.trial_id: (t.status.value,
                                 [r.training_iteration for r in t.results],
                                 [r.metrics["loss"] for r in t.results])
                    for t in res.trials}

        assert once() == once()


@pytest.mark.timeout(120)
class TestFlightRecorderHosts:
    def test_bundle_carries_per_host_state(self):
        sc = Scenario(
            name="forensics", stop_iteration=10, max_failures=2,
            heartbeat_timeout=60.0, hosts="2x2", host_timeout=60.0,
            host_faults=[("crash", "h1", 4.0)],
            configs=[{"lr": 0.01, "step_s": 1.0} for _ in range(3)])
        res = run(sc)
        assert res.flightrec is not None
        bundle = res.flightrec.bundle(executor=res.executor)
        hosts = bundle.get("hosts")
        assert hosts is not None and sorted(hosts) == ["h0", "h1"]
        assert hosts["h1"]["alive"] is False
        assert "crash" in (hosts["h1"]["evicted_reason"] or "")
        assert hosts["h0"]["alive"] is True


# -- the same cluster runs in both packages ---------------------------------------------

# The host-fault scenario of TestHostFaultMatrix: 4 hosts of 4 devices, 12
# trials; h1 crashes at t=8s and h2 is partitioned from t=12s for 200s, past
# its 90s host timeout, so it is evicted too.
HOST_FAULTS = dict(
    name="crash+partition", stop_iteration=40, max_failures=2,
    heartbeat_timeout=60.0, hosts="4x4", host_timeout=90.0,
    host_faults=[("crash", "h1", 8.0), ("partition", "h2", 12.0, 200.0)],
    configs=[{"lr": 0.01 + i * 0.001, "step_s": 1.0, "jitter_s": 0.25}
             for i in range(12)])


def _fault_journal(testing, core, path):
    """The scenario's journal, trial by trial, and its host states, run on
    ``testing``.  Trials whose events share a virtual instant may journal
    them in either order, so each record's global ``seq`` is dropped and
    each trial's records are compared in their own order; so is a KILLED
    event's ``pid``, which virtual workers draw from a counter of their
    module that earlier runs in the process have moved."""
    res = testing.run_scenario(
        testing.Scenario(**HOST_FAULTS),
        lambda: core.FIFOScheduler(metric="loss", mode="min"),
        executor="cluster", max_steps=500_000, token="pinned",
        journal_path=str(path))
    assert res.by_status() == {"TERMINATED": 12}
    journal = {}
    for line in path.read_text().splitlines():
        e = json.loads(line)
        e.pop("seq", None)
        if e["event"] == "killed":
            assert e["info"].pop("pid") >= 100000
        journal.setdefault(e.get("trial_id"), []).append(e)
    return journal, res.executor.host_state(), res.executor.n_host_evictions


@pytest.mark.timeout(120)
def test_the_same_host_faults_give_the_same_journal(tmp_path):
    ref, ref_hosts, ref_evictions = _fault_journal(jtesting, jcore, tmp_path / "jax.jsonl")
    got, got_hosts, got_evictions = _fault_journal(ptesting, pcore, tmp_path / "port.jsonl")
    assert got == ref
    assert got_hosts == ref_hosts and got_evictions == ref_evictions == 2
    events = [e for trial in ref.values() for e in trial]
    assert len(ref) == 13           # the run header and 12 trials
    assert {"result", "decision", "restarted", "killed", "heartbeat_missed",
            "complete"} <= {e["event"] for e in events}
    evicted = {e["info"]["host"] for e in events if e["event"] == "killed"}
    assert evicted == {"h2"}        # h1's crash shows as its workers dying


@pytest.mark.timeout(600)
def test_the_same_socket_sweep_gives_the_same_streams():
    """A 2-host sweep on loopback sockets: every trial's status, iterations
    and losses are the same in both packages."""
    def sweep(core, module, cls):
        core.register_worker_factory("LrCounter", core.TrainableFactory(
            target=f"{module}:LrCounter", sys_path=(TESTS_DIR,)))
        an = core.run_experiments(
            cls, {"lr": core.grid_search([0.001, 0.005, 0.02, 0.08])},
            stop={"training_iteration": 5}, checkpoint_freq=1,
            executor="cluster", hosts="2x4", placement="fixed", seed=0,
            total_devices=8)
        return {t.config["lr"]: (t.status.value,
                                 [r.training_iteration for r in t.results],
                                 [r.metrics["loss"] for r in t.results])
                for t in an.trials}

    ref = sweep(jcore, "_worker_trainables", JW.LrCounter)
    got = sweep(pcore, "_torch_worker_trainables", PW.LrCounter)
    assert got == ref
    assert {s for s, _, _ in ref.values()} == {"TERMINATED"}
    assert all(its == [1, 2, 3, 4, 5] for _, its, _ in ref.values())
