"""DLRM online serving app over the port, the counterpart of
``examples/native/serve_dlrm.py``: dynamic-batched JSON inference over
HTTP, on one card (or, with ``--device cpu``, on the CPU). Run it as a
module from the root of a checkout::

    # terminal 1: train, publishing snapshots (fit_stream with a
    # utils.delta.DeltaPublisher into /tmp/dlrm-ckpt, or fit with
    # --checkpoint-dir /tmp/dlrm-ckpt --save-every N)
    # terminal 2: serve them, hot-reloading as they land
    python -m dlrm_flexflow_tpu_torch.examples.native.serve_dlrm \\
        --checkpoint-dir /tmp/dlrm-ckpt --serve-max-batch 64 --port 8000

    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/predict -d \\
        '{"dense": [[0.1, 0.2, 0.3, 0.4]], "sparse": [[[1],[2],[3],[4]]]}'

The app builds the trainer's graph from the same flags (so the
fingerprints match), restores the newest valid snapshot of
``--checkpoint-dir`` params-only through the snapshot watcher, then
serves it with ``serve.InferenceEngine`` while the engine's watcher
hot-reloads every later full or delta snapshot (``--serve-poll``).
Without ``--checkpoint-dir`` it serves the initialized weights.
With ``--host-tables`` the tables stay in host RAM:
``--serve-cache-rows N`` fronts their gather with an N-sample row cache,
pre-warmed from ``--serve-cache-warm PATH`` (a trainer's
``id_histogram.npz`` or the directory holding it), and
``--serve-shards N`` row-shards them over N in-process lookup shards
(``serve/shardtier.py``; the ranker releases its own copy) under
``--serve-lookup-deadline-ms``, ``--serve-hedge-ms`` and
``--serve-degrade cache|fail``; the trainer's publishes reach the shards
through the watcher, and each /predict answer carries the per-shard
version vector it read and whether it was degraded::

    python -m dlrm_flexflow_tpu_torch.examples.native.serve_dlrm \
        --host-tables --serve-shards 4 --serve-cache-rows 65536 \
        --serve-cache-warm /tmp/dlrm-ckpt --checkpoint-dir /tmp/dlrm-ckpt

``--serve-replicas N`` turns the engine into a FLEET: N replicas (each
its own model on the card) behind a ``serve.FleetRouter``: queue-depth
load balancing, ``--serve-retries`` re-dispatches with backoff, a circuit
breaker that ejects and re-admits replicas, ``--serve-hedge-ms``
hedging, canary and shadow rollouts (``--serve-canary-fraction``); each
replica follows the trainer's snapshots. ``--serve-slo-ms MS`` adds the
autoscaler (``serve/autoscale.py``), which grows the fleet under a
sustained p99 breach up to ``--serve-max-replicas``, replaces replicas
below ``--serve-min-replicas`` and shrinks it when idle.

``--serve-transport tcp --serve-shard-procs N`` moves the lookup tier
into N processes: the app seeds the shard warm cache from its model into
``--compile-cache-dir`` (``auto``: ``<checkpoint-dir>/cache``; the port
has no executables to cache, so the flag serves this role only, and the
executable half is ROADMAP queue 1 item 9.5), spawns ``python -m
dlrm_flexflow_tpu_torch.serve.shard_server`` once a slot, connects to
them over loopback TCP (``serve/wire.py``, ``serve/transport.py``),
releases its own tables, and reaps the children when it stops. A killed
shard process degrades answers (never fails them) until the health loop
replaces the slot from the warm cache; a shard process that fails to
boot stops the app, naming its slot. ``--compile-cache-dir`` also gives
the in-process tier (``--serve-shards``) its warm replace-dead.

``--retrieve on`` puts the retrieve -> rank cascade in front of the
ranker (or the fleet): two-tower user and item heads sized to the DLRM's inputs, the
item catalog encoded into an int8 MIPS index that rides the ranker's
shard tier under ``--serve-shards`` (else ``--retrieve-shards``
standalone index shards, at least one), ``--retrieve-k`` candidates
under ``--retrieve-deadline-ms``. ``--host`` (default 0.0.0.0) and
``--port`` (default 8000; 0 picks a free one) say where to listen; the
app prints ``serving DLRM on http://HOST:PORT`` once it accepts requests,
and SIGTERM or SIGINT stop it cleanly.

Endpoints (the JAX app's, with its status codes and JSON keys):
  POST /predict  {"dense": [...], "sparse": [...]} ->
                 {"scores": [...], "version": N, "latency_ms": ...}
                 (with --serve-shards also "versions", the per-shard
                 version vector read, and "degraded");
                 429 on Overloaded, 504 on DeadlineExceeded, 400 on a
                 malformed request (--retrieve on: the request describes
                 users; the response holds "candidates", "scores",
                 "version", "retrieve_versions", "degraded",
                 "latency_ms", "stage_ms", and "versions" with
                 --serve-shards)
  POST /retrieve {"dense": [...], "sparse": [...][, "k": N]} ->
                 {"ids", "scores", "versions", "degraded",
                 "dropped_slots", "latency_ms"} (--retrieve on only;
                 404 otherwise)
  GET  /stats    the engine's stats() (and the cascade's)
  GET  /healthz  200 {"ok": true, ...} while the engine takes requests,
                 503 {"ok": false, ...} when its queue is full, it is
                 draining or its batcher died
  GET  /metrics  Prometheus text of the obs registry (``--obs on``;
                 with obs off, a comment saying so)

Scores go out as ``tolist()`` of the float32 array: every float32 value
survives the float64 JSON round trip exactly.

Refused at start-up, before any model is built, as the JAX app refuses
them: ``--serve-shard-procs`` without ``--serve-transport tcp``, and
``--retrieve on`` with ``--serve-transport tcp`` or shard processes. The
port also refuses ``--serve-transport tcp`` with in-process
``--serve-shards`` (the JAX app builds that tier in process): a tcp tier
never quietly turns into method calls. ``--eval-exec-cache`` raises
``NotImplementedError`` naming ROADMAP queue 1 item 9.5.
"""

from __future__ import annotations

import dataclasses
import json
import os
import selectors
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from ...config import FFConfig
from ...core.model import FFModel
from ...core.optimizers import SGDOptimizer
from ...models.dlrm import DLRMConfig, build_dlrm
from ...serve import (AutoscaleConfig, Autoscaler, DeadlineExceeded, Fleet,
                      FleetRouter, FleetUnavailable, InferenceEngine,
                      Overloaded, RouterConfig, ServeConfig,
                      SnapshotWatcher)
from ...serve.shardtier import EmbeddingShardSet, ShardTierConfig
from ...utils.logging import get_logger
from ...utils.warmcache import cache_dir_for

log_app = get_logger("serve_dlrm")

# flags of the JAX app that the port does not serve yet, by the ROADMAP
# queue 1 item that ports what they drive
_UNPORTED = {"--eval-exec-cache": "9.5 (the warm executable caches)"}

# the checkout's root: the shard processes run the package from there
_ROOT = Path(__file__).resolve().parents[3]
# how long a shard process may take to print its SHARD_SERVER_OK line
SHARD_BOOT_S = 300.0


def _flag(rest, name, default=None):
    return rest[rest.index(name) + 1] if name in rest else default


def _refuse_unported(cfg, rest):
    """The flags the port does not serve, and the transport combinations
    the JAX app refuses, before any model is built."""
    for a in rest:
        if a in _UNPORTED:
            raise NotImplementedError(
                f"{a} is not ported yet (ROADMAP queue 1 item "
                f"{_UNPORTED[a]})")
    if cfg.serve_shard_procs > 0 and cfg.serve_transport != "tcp":
        raise SystemExit(
            "--serve-shard-procs requires --serve-transport tcp "
            "(separate processes cannot share in-process method calls)")
    if cfg.serve_transport == "tcp" and cfg.serve_shard_procs == 0 \
            and cfg.serve_shards > 0:
        raise SystemExit(
            "--serve-transport tcp carries the shard tier to shard "
            "processes: pass --serve-shard-procs N (--serve-shards N keeps "
            "the tier in process, over --serve-transport inproc)")


def _shard_cache_dir(cfg, rest, ckpt_dir):
    """The shard warm cache's directory: ``--compile-cache-dir`` (or its
    ``auto``), as the JAX app takes it; None when unset."""
    configured = _flag(rest, "--compile-cache-dir", "")
    if configured:
        log_app.info("--compile-cache-dir %s: the shard warm cache's "
                     "directory (the port has no executables to cache; "
                     "that half is ROADMAP queue 1 item 9.5)", configured)
    return cache_dir_for(ckpt_dir, configured)


def _wants_shard_tier(cfg):
    return cfg.serve_shards > 0 or cfg.serve_shard_procs > 0


class ShardProcs:
    """The app's child processes: spawned, each read until its OK line,
    reaped by :meth:`stop`."""

    def __init__(self):
        self.procs: list = []

    def spawn(self, cache_dir: str, nshards: int, env=None) -> list:
        """One ``shard_server`` process a slot, booted from the seeded
        warm cache; returns their addresses. ``env`` adds variables to
        the children's environment."""
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(_ROOT), child_env.get("PYTHONPATH", "")) if p)
        child_env.update(env or {})
        return self.start(
            [[sys.executable, "-m",
              "dlrm_flexflow_tpu_torch.serve.shard_server",
              "--cache-dir", cache_dir, "--nshards", str(nshards),
              "--slot", str(slot), "--port", "0"]
             for slot in range(nshards)],
            "SHARD_SERVER_OK", "shard server slot", child_env)

    def start(self, cmds, ok_prefix: str, what: str, env, stderr=None,
              boot_s: float = SHARD_BOOT_S) -> list:
        """One process a command, all started at once, each read until
        its first line ``<ok_prefix> port=P``; returns their addresses on
        127.0.0.1. A process that exits or stays silent for ``boot_s``
        before its OK line stops the app, naming it as ``what`` and its
        index."""
        first = len(self.procs)
        for cmd in cmds:
            self.procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=stderr, text=True,
                env=env))
        addresses = []
        for i, proc in enumerate(self.procs[first:]):
            sel = selectors.DefaultSelector()
            sel.register(proc.stdout, selectors.EVENT_READ)
            ready = sel.select(boot_s)
            sel.close()
            line = proc.stdout.readline().strip() if ready else ""
            if not line.startswith(ok_prefix):
                raise SystemExit(
                    f"{what} {i} failed to boot (got {line!r}, "
                    f"exit={proc.poll()})")
            port = int(dict(kv.split("=", 1)
                            for kv in line.split()[1:])["port"])
            addresses.append(("127.0.0.1", port))
            log_app.info("%s %d up: pid=%d port=%d", what, i, proc.pid,
                         port)
        return addresses

    def stop(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs:
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
            if proc.stdout is not None:
                proc.stdout.close()
        self.procs.clear()


def _build_shard_set(cfg, model, cache_dir, procs: ShardProcs):
    """Row-shard the model's host tables into the lookup tier, then
    release the ranker's own copies (the point of the split): over
    ``--serve-shard-procs`` processes booted from the warm cache seeded
    from this model, or over ``--serve-shards`` in-process shards (warm
    replace-dead with a cache directory)."""
    tier_cfg = ShardTierConfig.from_config(cfg)
    n_procs = cfg.serve_shard_procs
    if n_procs > 0:
        if not cache_dir:
            raise SystemExit(
                "--serve-shard-procs needs a shard cache directory to boot "
                "the child processes from — set --checkpoint-dir or "
                "--compile-cache-dir")
        EmbeddingShardSet.seed_shard_cache(model, n_procs, cache_dir,
                                           config=tier_cfg)
        shard_set = EmbeddingShardSet.connect(
            procs.spawn(cache_dir, n_procs), config=tier_cfg,
            cache_dir=cache_dir)
        n = n_procs
    else:
        n = cfg.serve_shards
        shard_set = EmbeddingShardSet.build(model, n, config=tier_cfg,
                                            cache_dir=cache_dir)
    freed = EmbeddingShardSet.release_ranker_tables(model)
    log_app.info("sharded serving tier: %d lookup shard(s) [%s], ranker "
                 "released %.1f MB of tables", n,
                 "tcp, separate processes" if n_procs > 0 else "inproc",
                 freed / 1e6)
    return shard_set


def build_server_model(cfg, dcfg):
    """The trainer's graph (fingerprints must match for hot reload),
    built with ``build_dlrm(model, dcfg)`` as the training launcher and
    the JAX app build it (``--arch-interaction-op dot``: the unfused
    graph), compiled as the launcher compiles it, initialized from
    ``--seed``. A snapshot of either package's trainer loads in either
    package's app. With ``--host-tables`` the tables stay in host RAM
    and every forward gathers their rows there."""
    model = FFModel(cfg)
    build_dlrm(model, dcfg)
    model.compile(SGDOptimizer(lr=cfg.learning_rate), "mean_squared_error",
                  ["mse"])
    model.init_layers()
    return model


def make_handler(serve, input_names, cascade=None):
    """The HTTP handler class over ``serve`` (an InferenceEngine or a
    FleetRouter: both expose predict, stats and healthz);
    ``cascade`` (a retrieve.CascadeEngine) switches /predict to cascade
    mode and opens POST /retrieve."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code, text,
                        ctype="text/plain; version=0.0.4"):
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):   # route through our logger
            log_app.debug(fmt, *args)

        def do_GET(self):
            if self.path == "/healthz":
                hz = serve.healthz()
                # 503 tells a balancer to stop routing here; a 200 with
                # ok:false would keep the traffic coming
                self._reply(200 if hz["ok"] else 503, hz)
            elif self.path == "/stats":
                st = serve.stats()
                if cascade is not None:
                    st = dict(st)
                    st["cascade"] = cascade.stats()
                self._reply(200, st)
            elif self.path == "/metrics":
                from ...obs import metrics as obsm
                if obsm.enabled():
                    self._reply_text(200,
                                     obsm.registry().prometheus_text())
                else:
                    self._reply_text(
                        200, "# observability is off — restart with "
                             "--obs on to populate this endpoint\n")
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path not in ("/predict", "/retrieve"):
                self._reply(404, {"error": f"no route {self.path}"})
                return
            if self.path == "/retrieve" and cascade is None:
                self._reply(404, {"error": "retrieval is off — restart "
                                           "with --retrieve on"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                feats = {}
                for name in input_names:
                    if name not in req:
                        raise ValueError(f"missing input {name!r}")
                    arr = np.asarray(req[name])
                    feats[name] = (arr.astype(np.int32)
                                   if name == "sparse"
                                   else arr.astype(np.float32))
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            try:
                if self.path == "/retrieve":
                    k = int(req.get("k", cascade.config.k))
                    r = cascade.index.topk(
                        cascade.user_encoder(feats), k,
                        deadline_s=cascade.config.retrieve_deadline_ms
                        / 1e3)
                    self._reply(200, {
                        "ids": r.ids.tolist(),
                        "scores": r.scores.tolist(),
                        "versions": {str(s): int(v)
                                     for s, v in r.versions.items()},
                        "degraded": bool(r.degraded),
                        "dropped_slots": list(r.dropped_slots),
                        "latency_ms": round(r.latency_ms, 3)})
                    return
                if cascade is not None:
                    cp = cascade.predict(feats)
                    body = {
                        "candidates": cp.ids.tolist(),
                        "scores": cp.scores.tolist(),
                        "version": cp.rank_version,
                        "retrieve_versions": {
                            str(s): int(v)
                            for s, v in cp.retrieve_versions.items()},
                        "degraded": bool(cp.degraded),
                        "latency_ms": round(cp.latency_ms, 3),
                        "stage_ms": {s: round(v, 3)
                                     for s, v in cp.stage_ms.items()}}
                    if cp.rank_versions is not None:
                        body["versions"] = {
                            str(s): int(v)
                            for s, v in cp.rank_versions.items()}
                    self._reply(200, body)
                    return
                pred = serve.predict(feats)
                body = {
                    "scores": np.asarray(pred.scores).reshape(-1).tolist(),
                    "version": pred.version,
                    "latency_ms": round(pred.latency_ms, 3)}
                if getattr(pred, "versions", None) is not None:
                    # the shard tier: the per-shard version vector this
                    # answer read, and whether default rows went into it
                    body["versions"] = {str(k): int(v)
                                        for k, v in pred.versions.items()}
                    body["degraded"] = bool(pred.degraded)
                self._reply(200, body)
            except Overloaded as e:
                self._reply(429, {"error": str(e)})
            except FleetUnavailable as e:
                self._reply(503, {"error": str(e)})
            except (DeadlineExceeded, TimeoutError) as e:
                self._reply(504, {"error": str(e)})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:   # noqa: BLE001 — an uncaught handler
                # error would drop the connection without any status
                log_app.exception("predict failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def _validate_retrieve(cfg, rest) -> bool:
    """``--retrieve on|off`` (default off), with the JAX app's rules,
    checked before any model is built: ``--retrieve-shards`` needs
    ``--retrieve on``, the cascade scores through in-process shards (no
    ``--serve-transport tcp``, no ``--serve-shard-procs``), and with
    ``--serve-shards N`` the index rides those N shards, so
    ``--retrieve-shards`` must be 0 or N."""
    v = _flag(rest, "--retrieve", "off")
    if v not in ("on", "off"):
        raise ValueError(f"--retrieve expects on|off, got {v!r}")
    if v == "off":
        if cfg.retrieve_shards > 0:
            raise SystemExit(
                "--retrieve-shards does nothing without --retrieve on — "
                "refusing to silently ignore it")
        return False
    if cfg.serve_transport != "inproc":
        raise SystemExit(
            "--retrieve on requires --serve-transport inproc: the "
            "cascade scores candidates through in-process shard calls "
            "(the wire path for retrieval is not plumbed yet)")
    if cfg.serve_shard_procs > 0:
        raise SystemExit(
            "--retrieve on is incompatible with --serve-shard-procs: "
            "the index attaches to in-process shards")
    n = cfg.serve_shards
    if n > 0 and cfg.retrieve_shards not in (0, n):
        raise SystemExit(
            f"--retrieve-shards {cfg.retrieve_shards} conflicts with "
            f"--serve-shards {n}: with a sharded ranker tier the index "
            f"rides THOSE shards (pass 0, or match the count)")
    return True


def _build_cascade(cfg, dcfg, serve, shard_set=None):
    """The retrieval stage in front of the ranker, as the JAX app builds
    it: two-tower user/item heads sized to the DLRM's own inputs (so
    /predict's features feed both stages), both serving the same
    initialization, the item catalog encoded and attached as the MIPS
    index: to the ranker's shard set when there is one, else over
    ``--retrieve-shards`` standalone shards. Returns ``(CascadeEngine,
    the standalone set or None)``."""
    from ...retrieve import (CascadeConfig, CascadeEngine,
                             ShardedMIPSIndex, TwoTowerConfig,
                             build_two_tower, dlrm_candidate_features,
                             item_embeddings, transfer_tower_params)
    tcfg = TwoTowerConfig(
        n_items=int(dcfg.embedding_size[0]), dim=32,
        user_dense_dim=int(dcfg.mlp_bot[0]),
        user_embedding_size=list(dcfg.embedding_size),
        user_sparse_dim=8, user_bag_size=int(dcfg.embedding_bag_size))

    # the heads keep their tables on the device: ``--host-tables`` is the
    # ranker's (a host table must read a model input, and the user head
    # splits its input; the JAX app passes the flag on and fails here)
    head_cfg = dataclasses.replace(cfg, host_resident_tables=False)

    def build_head(head):
        m = FFModel(head_cfg)
        build_two_tower(m, tcfg, head=head)
        m.compile(SGDOptimizer(lr=cfg.learning_rate),
                  "mean_squared_error", ["mse"])
        m.init_layers()
        return m

    user_model = build_head("user")
    item_model = build_head("item")
    transfer_tower_params(user_model, item_model)

    def encode(feats):
        """The user head over the request's users in batches of its
        compiled batch, zero-padded: (n, dim) fp32 on the device."""
        dense = np.asarray(feats["dense"], np.float32)
        sparse = np.asarray(feats["sparse"], np.int64)
        n, ub = dense.shape[0], user_model.config.batch_size
        out = []
        for lo in range(0, n, ub):
            d, s = dense[lo:lo + ub], sparse[lo:lo + ub]
            pad = ub - d.shape[0]
            if pad:
                d = np.concatenate([d, np.zeros((pad,) + d.shape[1:],
                                                np.float32)])
                s = np.concatenate([s, np.zeros((pad,) + s.shape[1:],
                                                np.int64)])
            out.append(user_model.forward_batch(
                {"user_dense": d, "user_sparse": s})[:ub - pad])
        return torch.cat(out)

    items = item_embeddings(item_model, tcfg)
    del item_model
    owned = None
    if shard_set is not None:
        index = ShardedMIPSIndex.build(shard_set, items, device=cfg.device)
        where = f"riding the {shard_set.nshards}-shard ranker tier"
    else:
        m = max(1, int(cfg.retrieve_shards))
        owned = ShardedMIPSIndex.standalone_set(m)
        index = ShardedMIPSIndex.build(owned, items, device=cfg.device)
        where = f"{m} standalone index shard(s)"
    cascade = CascadeEngine(
        index, encode, serve,
        dlrm_candidate_features(len(dcfg.embedding_size),
                                list(dcfg.embedding_size)),
        CascadeConfig.from_config(cfg))
    log_app.info("retrieval cascade on: %d-item index (%s), k=%d, "
                 "retrieve deadline %.0f ms", index.n_items, where,
                 cascade.config.k, cascade.config.retrieve_deadline_ms)
    return cascade, owned


def _restore(engine, ckpt_dir, who="serving"):
    """The first restore through the watcher's READ-ONLY manifest scan
    (a CheckpointManager would sweep temp files under a live trainer):
    params only, the newest valid snapshot."""
    if SnapshotWatcher(engine, ckpt_dir,
                       elastic=engine.config.reshard).poll_once():
        log_app.info("%s snapshot version %d", who, engine.version)
    else:
        log_app.warning("%s: no restorable snapshot in %s — serving fresh "
                        "init until the trainer publishes one", who,
                        ckpt_dir)


def _build_fleet(cfg, dcfg, n, ckpt_dir, cache_dir, procs):
    """N replicas, each its own model on the card, behind a FleetRouter.
    With a shard tier the FIRST model built seeds the one shared set;
    every ranker then releases its own tables and resolves ids through
    the set (the autoscaler's grown replicas too)."""
    holder = {}

    def factory(i):
        model = build_server_model(cfg, dcfg)
        if _wants_shard_tier(cfg):
            if "set" not in holder:
                holder["set"] = _build_shard_set(cfg, model, cache_dir,
                                                 procs)
            else:
                EmbeddingShardSet.release_ranker_tables(model)
        return model

    fleet = Fleet.build(factory, n, ServeConfig.from_config(cfg),
                        checkpoint_dir=ckpt_dir)
    if holder:
        fleet.shard_set = holder["set"]
        for rep in fleet:
            rep.engine.attach_shard_set(fleet.shard_set)
    if ckpt_dir:
        for rep in fleet:
            _restore(rep.engine, ckpt_dir, f"replica {rep.rid}")
    return FleetRouter(fleet, RouterConfig.from_config(cfg))


class App:
    """One serving app: the engine or, with ``--serve-replicas`` > 1, the
    router over its fleet (started), its HTTP server bound to
    ``address``, with ``--serve-slo-ms`` the autoscaler, with
    ``--retrieve on`` the cascade, and its shard processes. ``serve``
    blocks until ``shutdown`` (from another thread or a signal);
    ``close`` releases everything and reaps the children."""

    def __init__(self, argv=None):
        from http.server import ThreadingHTTPServer

        from ... import obs
        cfg = FFConfig.parse_args(argv)
        # --obs on lands BEFORE the engine is built: instruments resolve
        # at creation time
        if obs.configure(cfg):
            log_app.info("observability on: GET /metrics serves the "
                         "registry%s",
                         f", traces export to {cfg.obs_trace_dir}"
                         if cfg.obs_trace_dir else "")
        rest = list(cfg.unparsed)
        _refuse_unported(cfg, rest)
        dcfg = DLRMConfig.parse_args(rest)
        port = int(_flag(rest, "--port", 8000))
        host = _flag(rest, "--host", "0.0.0.0")
        retrieve = _validate_retrieve(cfg, rest)
        ckpt_dir = cfg.checkpoint_dir or None
        cache_dir = _shard_cache_dir(cfg, rest, ckpt_dir)
        self.procs = ShardProcs()
        self.shard_set = self.router = self.scaler = None
        self.cascade = self._index_set = None
        self.httpd = None
        try:
            n = cfg.serve_replicas
            if n > 1:
                self.router = _build_fleet(cfg, dcfg, n, ckpt_dir,
                                           cache_dir, self.procs)
                self.shard_set = self.router.fleet.shard_set
                self.engine = self.router.fleet.replicas[0].engine
                model = self.engine.model
                serve = self.router
            else:
                model = build_server_model(cfg, dcfg)
                if _wants_shard_tier(cfg):
                    self.shard_set = _build_shard_set(cfg, model,
                                                      cache_dir, self.procs)
                self.engine = InferenceEngine(model,
                                              checkpoint_dir=ckpt_dir,
                                              shard_set=self.shard_set)
                if ckpt_dir:
                    _restore(self.engine, ckpt_dir)
                serve = self.engine
            if retrieve:
                self.cascade, self._index_set = _build_cascade(
                    cfg, dcfg, serve, self.shard_set)
            # the autoscaler over the fleet: fleet mode only, a single
            # engine has nothing to grow
            if n > 1 and cfg.serve_slo_ms > 0:
                self.scaler = Autoscaler(self.router,
                                         AutoscaleConfig.from_config(cfg))
                log_app.info("autoscaler on: SLO %.0f ms, %d..%d replicas",
                             cfg.serve_slo_ms, cfg.serve_min_replicas,
                             cfg.serve_max_replicas)
            if self.shard_set is not None and self.scaler is None:
                # no autoscaler drives the shards' health: the set
                # probes, re-admits and replaces on its own thread
                self.shard_set.start_health()
            serve.start()
            if self.scaler is not None:
                self.scaler.start()
            self.httpd = ThreadingHTTPServer(
                (host, port), make_handler(
                    serve, [t.name for t in model.input_tensors],
                    cascade=self.cascade))
        except BaseException:
            self.close()
            raise
        self.address = self.httpd.server_address[:2]

    def serve(self):
        self.httpd.serve_forever()

    def shutdown(self):
        """Stop ``serve`` (safe from a signal handler: it must not wait
        on the thread it interrupts)."""
        threading.Thread(target=self.httpd.shutdown, daemon=True).start()

    def close(self):
        from ...obs import trace as obstrace
        try:
            if self.httpd is not None:
                self.httpd.server_close()
            if self.scaler is not None:
                self.scaler.close()
            if self.router is not None:
                self.router.close()
            elif getattr(self, "engine", None) is not None:
                self.engine.close()
            if self.shard_set is not None:
                self.shard_set.close()   # stops its health thread first
            if self._index_set is not None:
                self._index_set.close()
        finally:
            self.procs.stop()
        path = obstrace.export_to_dir()
        if path:
            log_app.info("exported serving trace to %s", path)


def main(argv=None):
    app = App(argv)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: app.shutdown())
    host, port = app.address
    print(f"serving DLRM on http://{host}:{port}", flush=True)
    try:
        app.serve()
    finally:
        app.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
