"""The port's wire protocol (``serve/wire.py``) and transport
(``serve/transport.py``) against the JAX package's, on the CPU.

- Frames and payloads: every codec's bytes EQUAL the JAX codec's for the
  same input (parametrised over the opcodes and the payload kinds), and
  each package decodes the other's.
- Across packages: a port ``RemoteShard`` against a JAX ``ShardServer``
  booted from a cache the port seeded, and a JAX ``RemoteShard`` against
  a port ``ShardServer`` booted from a cache the JAX package seeded, both
  servers on threads of this process: lookups BITWISE.
- The shard seam over TCP is BITWISE the in-process tier at 1, 2 and 4
  shards; publishes are idempotent; a reordered delta chain keeps the
  version monotonic.
- The dispatch seam: ``RemoteEngineClient.predict`` is BITWISE the
  engine; the port engine is within rtol 1e-5, atol 1e-6 of the JAX
  engine on the same parameters (carried across through numpy; XLA sums
  the MLPs' products in another fp32 order, as tests/test_torch_serve.py
  holds the two forwards).
- The watcher restores, and applies a delta chain, over the wire.

Steadiness: every socket binds port 0, no test rebinds a freed port,
every wait is bounded, and no assertion compares wall-clock times: a
slow peer is made slow by an ``Event``.
"""

import os
import threading

import numpy as np
import pytest
import torch

from dlrm_flexflow_tpu.serve import engine as jax_engine
from dlrm_flexflow_tpu.serve import shardtier as jax_tier
from dlrm_flexflow_tpu.serve import transport as jax_tp
from dlrm_flexflow_tpu.serve import wire as jax_wire
from dlrm_flexflow_tpu.serve.shard_server import build_shard as jax_boot
from dlrm_flexflow_tpu.quant.store import QuantTable as JaxQuantTable
from dlrm_flexflow_tpu.utils import faults as jax_faults

from dlrm_flexflow_tpu_torch.quant.store import QuantTable
from dlrm_flexflow_tpu_torch.serve import (EmbeddingShardSet,
                                           InferenceEngine, Prediction,
                                           ServeConfig, ShardTierConfig,
                                           SnapshotWatcher)
from dlrm_flexflow_tpu_torch.serve import engine as port_engine
from dlrm_flexflow_tpu_torch.serve import shardtier as tier
from dlrm_flexflow_tpu_torch.serve import transport as tp
from dlrm_flexflow_tpu_torch.serve import wire
from dlrm_flexflow_tpu_torch.serve.shard_server import build_shard
from dlrm_flexflow_tpu_torch.serve.wire import FrameError
from dlrm_flexflow_tpu_torch.utils import delta, faults

from test_torch_delta import _jax_model, _port_model, _query
from test_torch_shardtier import BS, KEY, _jax, _port, _rows, _tier_cfg
from test_torch_watcher import _publisher, _train

WAIT_S = 20.0


@pytest.fixture(autouse=True)
def _clean_wire_telemetry():
    tp.reset_wire_stats()
    yield
    tp.reset_wire_stats()


def _echo(**kw):
    return tp.WireServer({wire.OP_PROBE: lambda p: p}, name="echo",
                         **kw).start()


# ---------------------------------------------------------------------
# frames and payloads: byte-identical to the JAX package's
# ---------------------------------------------------------------------
OPCODES = [wire.OP_LOOKUP, wire.OP_PUBLISH, wire.OP_INSTALL, wire.OP_PROBE,
           wire.OP_STATS, wire.OP_PREDICT, wire.OP_HEALTH, wire.OP_MANIFEST,
           wire.OP_FETCH, wire.OP_ERR, wire.OP_LOOKUP | wire.RESP_BIT]


class TestFrames:
    @pytest.mark.parametrize("op", OPCODES, ids=wire.opcode_name)
    def test_frame_bytes_equal_jax(self, op):
        payload = bytes(range(37))
        rid = (0x1234 << 32) | 77
        mine = wire.encode_frame(op, rid, payload)
        assert mine == jax_wire.encode_frame(op, rid, payload)
        assert wire.decode_frame(mine) == jax_wire.decode_frame(mine)
        assert wire.opcode_name(op) == jax_wire.opcode_name(op)

    def test_constants_equal_jax(self):
        for name in ("MAGIC", "WIRE_VERSION", "MAX_FRAME_BYTES",
                     "HEADER_BYTES", "RESP_BIT", "OPCODE_NAMES"):
            assert getattr(wire, name) == getattr(jax_wire, name), name

    @pytest.mark.parametrize("corrupt,match", [
        (lambda f: f.__setitem__(-1, f[-1] ^ 0xFF), "CRC"),
        (lambda f: f.__setitem__(0, 0), "magic"),
        (lambda f: f.__setitem__(4, wire.WIRE_VERSION + 1), "version"),
        (lambda f: f.__delitem__(slice(-3, None)), "truncated"),
    ], ids=["crc", "magic", "version", "truncated"])
    def test_corrupt_frames_raise_as_jax_does(self, corrupt, match):
        frame = bytearray(wire.encode_frame(wire.OP_LOOKUP, 1, b"data!"))
        corrupt(frame)
        with pytest.raises(FrameError, match=match) as mine:
            wire.decode_frame(bytes(frame))
        with pytest.raises(jax_wire.FrameError) as theirs:
            jax_wire.decode_frame(bytes(frame))
        assert str(mine.value) == str(theirs.value)


def _sub():
    return {"rows": {KEY: (np.asarray([3, 7], np.int64),
                           np.full((2, 8), 5.5, np.float32))},
            "full": {"hostparams/emb_stack/bias": np.arange(
                6, dtype=np.float32).reshape(3, 2)}, "crc": 123}


def _codes():
    rng = np.random.default_rng(0)
    return (rng.integers(-127, 128, (5, 8)).astype(np.int8),
            rng.random(5).astype(np.float32))


def _pred(mod):
    return mod.Prediction(np.arange(4, dtype=np.float32).reshape(4, 1), 9,
                          1.25, versions={0: 9, 1: 8}, degraded=True)


# (name, the port's encoding, the JAX package's encoding)
PAYLOADS = [
    ("payload", lambda: wire.encode_payload(
        {"b": [1, 2], "a": "x"}, {"w/kernel": np.arange(6.0, dtype=np.float32),
                                  "ids": np.asarray([5, 1], np.int64)}),
     lambda: jax_wire.encode_payload(
         {"b": [1, 2], "a": "x"}, {"w/kernel": np.arange(6.0, dtype=np.float32),
                                   "ids": np.asarray([5, 1], np.int64)})),
    ("lookup_request",
     lambda: wire.encode_lookup_request({"emb_stack": np.asarray([1, 9])}),
     lambda: jax_wire.encode_lookup_request(
         {"emb_stack": np.asarray([1, 9])})),
    ("lookup_dense", lambda: wire.encode_lookup_response(
        {"emb_stack": np.ones((3, 8), np.float32)}, 7),
     lambda: jax_wire.encode_lookup_response(
         {"emb_stack": np.ones((3, 8), np.float32)}, 7)),
    ("lookup_quant", lambda: wire.encode_lookup_response(
        {"idx": (*map(torch.from_numpy, _codes()), "int8")},
        2),
     lambda: jax_wire.encode_lookup_response(
         {"idx": (*_codes(), "int8")}, 2)),
    ("publish", lambda: wire.encode_publish(_sub(), 10, 99),
     lambda: jax_wire.encode_publish(_sub(), 10, 99)),
    ("publish_none", lambda: wire.encode_publish(None, 4, None),
     lambda: jax_wire.encode_publish(None, 4, None)),
    ("blocks", lambda: wire.encode_blocks(
        {"emb_stack": np.ones((4, 8), np.float32),
         "idx": QuantTable.from_encoded(*_codes(), "int8")}, 3, 0xDEADBEEF),
     lambda: jax_wire.encode_blocks(
         {"emb_stack": np.ones((4, 8), np.float32),
          "idx": JaxQuantTable.from_encoded(*_codes(), "int8")}, 3,
         0xDEADBEEF)),
    ("predict_request", lambda: wire.encode_predict_request(
        {"dense": np.ones((2, 4), np.float32),
         "sparse": np.zeros((2, 4, 1), np.int32)}),
     lambda: jax_wire.encode_predict_request(
         {"dense": np.ones((2, 4), np.float32),
          "sparse": np.zeros((2, 4, 1), np.int32)})),
    ("prediction", lambda: wire.encode_prediction(_pred(port_engine)),
     lambda: jax_wire.encode_prediction(_pred(jax_engine))),
    ("error_shard", lambda: wire.encode_error(tier.ShardDown(3, "gone")),
     lambda: jax_wire.encode_error(jax_tier.ShardDown(3, "gone"))),
    ("error_replica",
     lambda: wire.encode_error(port_engine.ReplicaDown(2, "gone")),
     lambda: jax_wire.encode_error(jax_engine.ReplicaDown(2, "gone"))),
]


class TestPayloads:
    @pytest.mark.parametrize("mine,theirs", [p[1:] for p in PAYLOADS],
                             ids=[p[0] for p in PAYLOADS])
    def test_payload_bytes_equal_jax(self, mine, theirs):
        a, b = mine(), theirs()
        assert a == b
        # and each package decodes the other's bytes alike
        ma, aa = wire.decode_payload(b)
        mb, ab = jax_wire.decode_payload(a)
        assert ma == mb and sorted(aa) == sorted(ab)
        for k in aa:
            np.testing.assert_array_equal(aa[k], ab[k])

    def test_seam_decoders_read_jax_bytes(self):
        out, ver = wire.decode_lookup_response(
            jax_wire.encode_lookup_response(
                {"idx": (*_codes(), "int8")}, 2))
        q, s, dtype = out["idx"]
        np.testing.assert_array_equal(q, _codes()[0])
        assert ver == 2 and dtype == "int8" and q.dtype == np.int8
        sub, ver, crc = wire.decode_publish(
            jax_wire.encode_publish(_sub(), 10, 99))
        assert (ver, crc, sub["crc"]) == (10, 99, 123)
        np.testing.assert_array_equal(sub["rows"][KEY][0], [3, 7])
        blocks, ver, crc = wire.decode_blocks(jax_wire.encode_blocks(
            {"idx": JaxQuantTable.from_encoded(*_codes(), "int8")}, 3, 5))
        assert isinstance(blocks["idx"], QuantTable) and (ver, crc) == (3, 5)
        np.testing.assert_array_equal(blocks["idx"].q.numpy(), _codes()[0])
        p = wire.decode_prediction(jax_wire.encode_prediction(
            _pred(jax_engine)))
        assert isinstance(p, Prediction) and p.versions == {0: 9, 1: 8}
        assert p.degraded is True and p.version == 9

    def test_torn_payload_is_frame_error(self):
        data = wire.encode_payload({"a": 1}, {"x": np.ones(3)})
        with pytest.raises(FrameError, match="payload decode failed"):
            wire.decode_payload(data[:-9])


# ---------------------------------------------------------------------
# the tcp transport: pooling, retry, dedup, deadlines, telemetry
# ---------------------------------------------------------------------
class TestTcpTransport:
    def test_echo_round_trip_pool_and_telemetry(self):
        with _echo() as srv:
            cli = tp.WireClient(srv.address, name="t")
            for i in range(5):
                op, payload = cli.request(wire.OP_PROBE, b"p%d" % i)
                assert (op, payload) == (wire.OP_PROBE | wire.RESP_BIT,
                                         b"p%d" % i)
            assert cli._made == 1   # one pooled socket, reused
            cli.close()
        st = tp.wire_stats()["lookup"]
        assert st["frames_sent"] == st["frames_recv"] == 5
        assert tp.measured_rtt_floor("lookup") > 0

    def test_unreachable_names_the_address(self):
        # a port no server holds: the listener of a closed server socket
        import socket
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        addr = s.getsockname()
        cli = tp.WireClient(addr, retries=0, name="t")
        try:
            with pytest.raises(tp.WireError,
                               match=f"127.0.0.1:{addr[1]}"):
                cli.request(wire.OP_PROBE, b"", deadline_s=2.0)
        finally:
            cli.close()
            s.close()

    def test_missing_handler_and_typed_errors(self):
        def boom(_payload):
            raise tier.ShardDown(4, "down for the test")

        calls = []

        def value(_payload):
            calls.append(1)
            raise ValueError("bad request")

        with tp.WireServer({wire.OP_LOOKUP: boom, wire.OP_STATS: value},
                           name="t").start() as srv:
            cli = tp.WireClient(srv.address, retries=3, name="t")
            with pytest.raises(tp.WireRemoteError, match="no handler"):
                cli.request(wire.OP_PROBE, b"")
            with pytest.raises(tier.ShardDown, match="down for the test") \
                    as e:
                cli.request(wire.OP_LOOKUP, b"")
            assert e.value.shard_id == 4
            with pytest.raises(ValueError, match="bad request"):
                cli.request(wire.OP_STATS, b"")
            assert calls == [1] and cli.wire_retries == 0   # no retry
            cli.close()

    def test_dedup_answers_a_repeated_request_id(self):
        calls = []
        srv = tp.WireServer({wire.OP_PROBE: lambda p: calls.append(p)
                             or p}, name="t")
        first = srv.dispatch(wire.OP_PROBE, 99, b"a")
        again = srv.dispatch(wire.OP_PROBE, 99, b"a")
        assert first == again and calls == [b"a"] and srv.dedup_hits == 1

    def test_deadline_bounds_a_stalled_server(self):
        gate = threading.Event()

        def stall(p):
            gate.wait(WAIT_S)
            return p

        with tp.WireServer({wire.OP_PROBE: stall},
                           name="t").start() as srv:
            cli = tp.WireClient(srv.address, retries=0, name="t")
            try:
                with pytest.raises(tp.WireError, match="budget"):
                    cli.request(wire.OP_PROBE, b"", deadline_s=0.2)
            finally:
                gate.set()
                cli.close()

    def test_request_ids_unique_across_threads(self):
        got, lock = [], threading.Lock()

        def take():
            ids = [tp.next_request_id() for _ in range(200)]
            with lock:
                got.extend(ids)

        ts = [threading.Thread(target=take) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT_S)
        assert len(set(got)) == 800
        assert all(r >> 32 == os.getpid() & 0xFFFF for r in got)


# ---------------------------------------------------------------------
# FF_FAULT_NET_*: parsed as the JAX package parses them, applied on frames
# ---------------------------------------------------------------------
def _parse_both(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = []
    for mod in (faults, jax_faults):
        try:
            out.append(mod.plan_from_env())
        except ValueError as e:
            out.append(e)
    return out


class TestNetFaults:
    def test_env_forms_parse_as_jax(self, monkeypatch):
        mine, theirs = _parse_both(monkeypatch, {
            "FF_FAULT_NET_DROP": "lookup:0.5", "FF_FAULT_NET_DUP":
            "dispatch:2", "FF_FAULT_NET_REORDER": "any:1",
            "FF_FAULT_NET_SLOW": "manifest:25",
            "FF_FAULT_REPLICA_DOWN": "1:8", "FF_FAULT_SERVE_DELAY":
            "0.05,1:0.2"})
        for f in ("net_drop", "net_dup", "net_reorder", "net_slow_ms",
                  "replica_down", "serve_delay_s", "serve_delay_replica"):
            assert getattr(mine, f) == getattr(theirs, f), f

    @pytest.mark.parametrize("var,val", [
        ("FF_FAULT_NET_DROP", "lookup"),
        ("FF_FAULT_NET_DROP", "lookup:nope"),
        ("FF_FAULT_NET_DROP", "lookup:1.5"),
        ("FF_FAULT_NET_DUP", "lookup:1.5"),
        ("FF_FAULT_NET_REORDER", "bogus-seam:1"),
        ("FF_FAULT_NET_SLOW", ":3"),
        ("FF_FAULT_REPLICA_DOWN", "1:x"),
    ])
    def test_bad_values_raise_naming_the_variable(self, monkeypatch, var,
                                                  val):
        mine, theirs = _parse_both(monkeypatch, {var: val})
        assert isinstance(mine, ValueError) and var in str(mine)
        assert isinstance(theirs, ValueError)
        if var.startswith("FF_FAULT_NET"):
            assert str(mine) == str(theirs)

    def test_drop_spends_the_budget_then_recovers(self):
        plan = faults.FaultPlan(net_drop={"lookup": 1.0})
        with _echo() as srv:
            cli = tp.WireClient(srv.address, retries=2, backoff_ms=1.0,
                                name="t")
            with faults.active_plan(plan):
                with pytest.raises(tp.WireError, match="drop"):
                    cli.request(wire.OP_PROBE, b"x", deadline_s=2.0)
            assert cli.wire_retries == 2
            assert cli.request(wire.OP_PROBE, b"x")[1] == b"x"
            cli.close()
        assert tp.wire_stats()["lookup"]["drops"] == 3

    @pytest.mark.parametrize("transport", ["tcp", "inproc"])
    def test_duplicate_delivery_runs_the_handler_once(self, transport):
        calls = []
        srv = tp.WireServer({wire.OP_PROBE: lambda p: calls.append(p)
                             or p}, name="t")
        plan = faults.FaultPlan(net_dup={"lookup": 1})
        if transport == "tcp":
            srv.start()
            cli = tp.WireClient(srv.address, name="t")
        else:
            cli = tp.InprocTransport(srv)
        try:
            with faults.active_plan(plan):
                assert cli.request(wire.OP_PROBE, b"dup")[1] == b"dup"
        finally:
            cli.close()
            srv.close()
        assert len(calls) == 1 and srv.dedup_hits == 1
        assert plan.fired == [("net_dup", "lookup")]

    def test_slow_link_sleeps_every_frame(self, monkeypatch):
        slept = []
        monkeypatch.setattr(faults.time, "sleep", slept.append)
        with faults.active_plan(faults.FaultPlan(
                net_slow_ms={"any": 40.0})):
            faults.maybe_net_slow("lookup")
            faults.maybe_net_slow("dispatch")
        assert slept == [0.04, 0.04]


# ---------------------------------------------------------------------
# across packages: each package's client against the other's server
# ---------------------------------------------------------------------
def _close_jax_server(srv):
    """The JAX server's close() joins its accept thread for up to 5 s: a
    bare close of the listener does not wake accept(). Shut the listener
    down first (the port's close() does so itself)."""
    import socket
    listener = srv._server._listener
    if listener is not None:
        listener.shutdown(socket.SHUT_RDWR)
    srv.close()


class TestAcrossPackages:
    def test_port_client_jax_server(self, tmp_path):
        pm = _port()
        EmbeddingShardSet.seed_shard_cache(pm, 2, str(tmp_path))
        local = EmbeddingShardSet.build(pm, 2)
        servers = [jax_tp.ShardServer(jax_boot(str(tmp_path), 2, s)).start()
                   for s in range(2)]
        sset = EmbeddingShardSet.connect([s.address for s in servers],
                                         config=_tier_cfg(),
                                         cache_dir=str(tmp_path))
        try:
            ids = np.asarray([0, 5, 63, 64, 130, 255], np.int64)
            got = sset.fetch({"emb_stack": ids})
            want = local.fetch({"emb_stack": ids})
            np.testing.assert_array_equal(got.rows["emb_stack"],
                                          want.rows["emb_stack"])
            assert got.versions == want.versions == {0: 0, 1: 0}
            assert not got.default_mask["emb_stack"].any()
        finally:
            sset.close()
            local.close()
            for s in servers:
                _close_jax_server(s)

    def test_jax_client_port_server(self, tmp_path):
        jm = _jax()
        jax_tier.EmbeddingShardSet.seed_shard_cache(jm, 2, str(tmp_path))
        servers = [build_shard(str(tmp_path), 2, s).serve()
                   for s in range(2)]
        jset = jax_tier.EmbeddingShardSet.connect(
            [s.address for s in servers], cache_dir=str(tmp_path))
        local = jax_tier.EmbeddingShardSet.build(jm, 2)
        try:
            ids = np.asarray([0, 5, 63, 64, 130, 255], np.int64)
            got = jset.fetch({"emb_stack": ids})
            want = local.fetch({"emb_stack": ids})
            np.testing.assert_array_equal(got.rows["emb_stack"],
                                          want.rows["emb_stack"])
            # one seed draws the same tables in both packages
            np.testing.assert_array_equal(
                got.rows["emb_stack"],
                _port().host_params["emb_stack"]["kernel"].reshape(
                    -1, 8)[ids])
        finally:
            jset.close()
            local.close()
            for s in servers:
                s.close()


# ---------------------------------------------------------------------
# the shard seam over tcp
# ---------------------------------------------------------------------
class TcpTier:
    """N port ShardServers on threads, booted from a cache seeded from
    ``model``, and the tier connected to them: the tcp twin of
    ``EmbeddingShardSet.build`` without process start-up."""

    def __init__(self, model, nshards, cache_dir, config=None):
        self.cache_dir = str(cache_dir)
        EmbeddingShardSet.seed_shard_cache(model, nshards, self.cache_dir)
        self.servers = [build_shard(self.cache_dir, nshards, s).serve()
                        for s in range(nshards)]
        self.sset = EmbeddingShardSet.connect(
            [s.address for s in self.servers],
            config=config or _tier_cfg(nshards=nshards),
            cache_dir=self.cache_dir)

    def close(self):
        self.sset.close()
        for s in self.servers:
            s.close()


class TestShardSeam:
    @pytest.mark.parametrize("nshards", [1, 2, 4])
    def test_bitwise_to_inproc(self, nshards, tmp_path):
        m = _port()
        x = _rows(8)
        local = EmbeddingShardSet.build(m, nshards,
                                        config=_tier_cfg(nshards=nshards))
        tcp = TcpTier(m, nshards, tmp_path)
        engines = [InferenceEngine(m, ServeConfig(max_batch=BS),
                                   shard_set=s).start()
                   for s in (local, tcp.sset)]
        try:
            a, b = (e.predict(x, timeout=WAIT_S) for e in engines)
            np.testing.assert_array_equal(a.scores, b.scores)
            assert a.versions == b.versions == {s: 0
                                                for s in range(nshards)}
            assert not a.degraded and not b.degraded
            assert tcp.sset.shards[0].shard.remote is True
        finally:
            for e in engines:
                e.close()
            local.close()
            tcp.close()

    def test_publish_idempotent_and_install(self, tmp_path):
        m = _port()
        tcp = TcpTier(m, 2, tmp_path)
        payload = {"rows": {KEY: (np.asarray([3, 200], np.int64),
                                  np.full((2, 8), 5.5, np.float32))},
                   "full": {}}
        try:
            assert tcp.sset.apply_delta(payload, 10) == 2
            assert tcp.sset.apply_delta(payload, 10) == 0   # a replay
            assert tcp.sset.version_vector() == {0: 10, 1: 10}
            r = tcp.sset.fetch({"emb_stack": np.asarray([3, 200])})
            assert np.all(r.rows["emb_stack"] == 5.5)
            assert all(s.shard.stats()["publishes_applied"] == 1
                       for s in tcp.servers)
            # a full install over the wire: the servers' blocks are the
            # model's tables
            flat = m.host_params["emb_stack"]["kernel"].reshape(-1, 8)
            assert tcp.sset.install_full(
                {"emb_stack": {"kernel": flat * 2}}, 11)
            r = tcp.sset.fetch({"emb_stack": np.asarray([3, 200])})
            np.testing.assert_array_equal(r.rows["emb_stack"],
                                          flat[[3, 200]] * 2)
            # the install's blocks went to the warm cache a replacement of
            # a shard process boots from
            blocks, ver, _crc = tcp.sset._cache.get(2, 1)
            lo, hi = tcp.sset._ranges["emb_stack"][1]
            assert ver == 11
            np.testing.assert_array_equal(blocks["emb_stack"],
                                          flat[lo:hi] * 2)
        finally:
            tcp.close()

    def test_reordered_delta_chain_stays_monotonic(self, tmp_path):
        """FF_FAULT_NET_REORDER holds the server's next frame until a
        later one is handled: whichever publish lands second, the shard's
        version never goes back and the stale one is a no-op."""
        m = _port()
        tcp = TcpTier(m, 1, tmp_path)
        shard = tcp.servers[0].shard
        seen, applied = [], {}
        orig = shard.apply_publish

        def recording(sub, version, expect_crc=None):
            ok = orig(sub, version, expect_crc)
            seen.append(shard.version)
            return ok

        shard.apply_publish = recording
        remote = tcp.sset.shards[0].shard

        def pub(version, val):
            sub = delta.split_host_rows_by_shard(
                {"rows": {KEY: (np.asarray([3], np.int64),
                                np.full((1, 8), val, np.float32))},
                 "full": {}}, tcp.sset._ranges)[0]
            applied[version] = remote.apply_publish(sub, version,
                                                    sub["crc"])

        try:
            with faults.active_plan(faults.FaultPlan(
                    net_reorder={"lookup": 1})):
                ts = [threading.Thread(target=pub, args=a)
                      for a in ((10, 1.0), (11, 2.0))]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(WAIT_S)
            assert not any(t.is_alive() for t in ts)
            assert shard.version == 11 == remote.version
            assert seen == sorted(seen) and applied[11] is True
            assert tp.wire_stats()["lookup"]["reorders"] == 1
        finally:
            tcp.close()

    def test_dead_server_degrades_then_the_slot_is_replaced(self,
                                                            tmp_path):
        m = _port()
        x = _rows(8)
        cfg = _tier_cfg(eject_after=1, retries=0, lookup_deadline_ms=2000)
        tcp = TcpTier(m, 2, tmp_path, config=cfg)
        eng = InferenceEngine(m, ServeConfig(max_batch=BS),
                              shard_set=tcp.sset).start()
        try:
            want = eng.predict(x, timeout=WAIT_S).scores
            tcp.servers[0].close()   # the shard's process is gone
            p = eng.predict(x, timeout=WAIT_S)   # never raises
            assert p.degraded and 0 not in p.versions
            # replace-dead: an in-process shard from the same warm cache
            for _ in range(2 * cfg.replace_after + 2):
                tcp.sset.health_tick()
            assert tcp.sset.replacements == 1
            assert not tcp.sset.shards[0].shard.__dict__.get("remote")
            np.testing.assert_array_equal(
                eng.predict(_rows(8, seed=5), timeout=WAIT_S).scores,
                m.forward_bucket(_rows(8, seed=5), bucket=8).numpy())
            del want
        finally:
            eng.close()
            tcp.close()

    def test_connect_names_the_slot_that_does_not_answer(self, tmp_path):
        import socket
        m = _port()
        EmbeddingShardSet.seed_shard_cache(m, 2, str(tmp_path))
        with _echo() as live:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            try:
                with pytest.raises(tier.ShardDown, match="slot 1"):
                    EmbeddingShardSet.connect(
                        [live.address, s.getsockname()],
                        config=ShardTierConfig(nshards=2, retries=0),
                        cache_dir=str(tmp_path))
            finally:
                s.close()


# ---------------------------------------------------------------------
# the dispatch seam: router -> ranker replica
# ---------------------------------------------------------------------
class TestDispatchSeam:
    def test_remote_predict_bitwise_and_the_jax_engine(self):
        jm = _jax_model()
        pm = _port_model(jm)
        q = _query(5)
        eng = InferenceEngine(pm, ServeConfig(max_batch=8)).start()
        jeng = jax_engine.InferenceEngine(
            jm, jax_engine.ServeConfig(max_batch=8)).start()
        server = eng.serve()
        client = tp.RemoteEngineClient(server.address, rid=3)
        try:
            local = eng.predict(q, timeout=WAIT_S)
            got = client.predict(q, timeout=WAIT_S)
            np.testing.assert_array_equal(got.scores, local.scores)
            assert got.version == local.version
            np.testing.assert_allclose(
                got.scores, np.asarray(jeng.predict(q).scores),
                rtol=1e-5, atol=1e-6)
            st = client.stats()
            assert st["remote"] is True and st["replica_id"] == 3
            assert st["responses"] == 2 and client.healthz()["ok"]
            with pytest.raises(RuntimeError, match="own process"):
                client.state_snapshot()
        finally:
            client.close()
            server.close()
            eng.close()
            jeng.close()

    def test_a_jax_router_client_reaches_a_port_engine(self):
        pm = _port_model(_jax_model())
        q = _query(3)
        eng = InferenceEngine(pm, ServeConfig(max_batch=8)).start()
        server = eng.serve()
        client = jax_tp.RemoteEngineClient(server.address, rid=0)
        try:
            np.testing.assert_array_equal(
                client.predict(q, timeout=WAIT_S).scores,
                eng.predict(q, timeout=WAIT_S).scores)
        finally:
            client.close()
            server.close()
            eng.close()

    def test_unreachable_replica_is_replica_down(self):
        import socket
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        client = tp.RemoteEngineClient(s.getsockname(), rid=1, retries=0,
                                       deadline_s=2.0)
        try:
            with pytest.raises(port_engine.ReplicaDown, match="replica 1"):
                client.predict(_query(1))
            assert client.healthz()["ok"] is False
            assert "unreachable" in client.stats()
        finally:
            client.close()
            s.close()


# ---------------------------------------------------------------------
# the manifest seam: the watcher over the wire
# ---------------------------------------------------------------------
def _wire_watcher(engine, directory, spool, **kw):
    srv = tp.SnapshotServer(str(directory)).start()
    cli = tp.WireClient(srv.address, seam=tp.SEAM_MANIFEST, name="watch",
                        **kw.pop("client_kw", {}))
    src = tp.SnapshotWireSource(cli, str(spool), **kw)
    return srv, src, SnapshotWatcher(engine, str(directory), wire=src)


class TestWatcherWire:
    def test_restores_then_applies_the_delta_chain(self, tmp_path):
        pm = _port_model(_jax_model())
        pub = _publisher(pm, tmp_path / "pub", full_every=3)
        _train(pm, pub, 2)                  # a full base
        eng = InferenceEngine(_port_model(seed=11),
                              ServeConfig(max_batch=8, warmup=False))
        srv, src, w = _wire_watcher(eng, tmp_path / "pub",
                                    tmp_path / "spool")
        try:
            assert w.poll_once() and eng.version == 2
            _train(pm, pub, 2, start=2)      # two deltas on the chain
            _train(pm, pub, 2, start=4)
            assert w.poll_once() and eng.version == 6
            assert w.stats()["delta_installs"] == 2
            q = _query(4)
            np.testing.assert_array_equal(
                eng.model.forward_bucket(q, 4).numpy(),
                pm.forward_bucket(q, 4).numpy())
            st = w.stats()
            assert st["wire_retries"] == 0 and st["last_wire_error"] == ""
            assert os.listdir(tmp_path / "spool")
        finally:
            src.close()
            srv.close()

    def test_a_gone_publisher_counts_retries_and_says_why(self, tmp_path):
        pm = _port_model()
        _train(pm, _publisher(pm, tmp_path / "pub"), 1)
        eng = InferenceEngine(_port_model(seed=11),
                              ServeConfig(max_batch=8, warmup=False))
        srv, src, w = _wire_watcher(
            eng, tmp_path / "pub", tmp_path / "spool", retries=2,
            backoff_s=0.01, client_kw={"retries": 0,
                                       "default_deadline_s": 2.0})
        srv.close()
        try:
            assert w.poll_once() is False and eng.version == 0
            st = w.stats()
            assert st["wire_retries"] == 3 and st["last_wire_error"]
            assert "over the wire" in st["last_reload_error"]
        finally:
            src.close()

    def test_fetch_is_confined_to_the_publish_directory(self, tmp_path):
        (tmp_path / "pub").mkdir()
        srv = tp.SnapshotServer(str(tmp_path / "pub")).start()
        cli = tp.WireClient(srv.address, seam=tp.SEAM_MANIFEST, name="t")
        try:
            with pytest.raises(ValueError, match="escapes"):
                cli.request(wire.OP_FETCH,
                            wire.encode_payload({"name": "../x"}))
            meta, _ = wire.decode_payload(cli.request(
                wire.OP_MANIFEST, wire.encode_payload({}))[1])
            assert meta == {"manifest": None}
        finally:
            cli.close()
            srv.close()


def test_wire_series_scrape_with_obs_on():
    """The ``ff_wire_*`` series the JAX package exports: a counter a seam
    and the RTT window, in the Prometheus text of the obs registry."""
    from dlrm_flexflow_tpu_torch.obs import metrics as obsm
    tel = tp._WireTelemetry()
    with obsm.override(True):
        tel._ensure_registered()
        tel.count("lookup", "drops", 2)
        tel.observe_rtt("dispatch", 1.5)
        try:
            text = obsm.registry().prometheus_text()
        finally:
            obsm.unregister_collector(tel._obs_collect)
            obsm.registry().reset()
    assert 'ff_wire_drops_total{seam="lookup"} 2' in text
    assert 'ff_wire_rtt_ms_count{seam="dispatch"} 1' in text
    assert tel.measured_rtt_floor("dispatch") == 1.5
    assert tel.stats() == {"dispatch": {"rtt_p50_ms": 1.5,
                                        "rtt_p99_ms": 1.5},
                           "lookup": {"drops": 2}}
