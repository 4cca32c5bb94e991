"""DLRM online serving app over the port, the counterpart of
``examples/native/serve_dlrm.py``'s single-engine path: dynamic-batched
JSON inference over HTTP, on one card (or, with ``--device cpu``, on the
CPU). Run it as a module from the root of a checkout::

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

``--retrieve on`` puts the retrieve -> rank cascade in front of the
ranker: two-tower user and item heads sized to the DLRM's inputs, the
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

The JAX app's other deployments raise ``NotImplementedError`` naming
their ROADMAP queue 1 item: the fleet and shard processes
(``--serve-replicas`` > 1, the autoscaler's ``--serve-slo-ms`` /
``--serve-min-replicas`` / ``--serve-max-replicas``,
``--serve-retries``, ``--serve-canary-fraction``,
``--serve-shard-procs``, ``--serve-transport tcp``: 9.4) and the warm
executable caches (``--compile-cache-dir``, ``--eval-exec-cache``: 9.5;
without them a replaced shard has no warm cache to boot from, so a dead
shard of the app's tier heals by its probe alone).
"""

from __future__ import annotations

import dataclasses
import json
import signal
import sys
import threading

import numpy as np
import torch

from ...config import FFConfig
from ...core.model import FFModel
from ...core.optimizers import SGDOptimizer
from ...models.dlrm import DLRMConfig, build_dlrm
from ...serve import (DeadlineExceeded, InferenceEngine, Overloaded,
                      SnapshotWatcher)
from ...serve.shardtier import EmbeddingShardSet, ShardTierConfig
from ...utils.logging import get_logger

log_app = get_logger("serve_dlrm")

# flags of the JAX app that the port does not serve yet, by the ROADMAP
# queue 1 item that ports what they drive
_UNPORTED = {
    **dict.fromkeys(("--serve-slo-ms", "--serve-min-replicas",
                     "--serve-max-replicas", "--serve-retries",
                     "--serve-canary-fraction"),
                    "9.4 (the serving fleet)"),
    **dict.fromkeys(("--compile-cache-dir", "--eval-exec-cache"),
                    "9.5 (the warm executable caches)"),
}


def _flag(rest, name, default=None):
    return rest[rest.index(name) + 1] if name in rest else default


def _refuse_unported(cfg, rest):
    for a in rest:
        if a in _UNPORTED:
            raise NotImplementedError(
                f"{a} is not ported yet (ROADMAP queue 1 item "
                f"{_UNPORTED[a]})")
    if cfg.serve_shard_procs > 0 or cfg.serve_transport != "inproc":
        raise NotImplementedError(
            f"--serve-transport {cfg.serve_transport} / "
            f"--serve-shard-procs {cfg.serve_shard_procs}: the wire "
            f"transport and shard processes are not ported yet (ROADMAP "
            f"queue 1 item 9.4); --serve-shards runs the tier in process")


def _build_shard_set(cfg, model):
    """Row-shard the model's host tables over ``--serve-shards``
    in-process lookup shards and release the ranker's own copies (the
    point of the split). No warm cache: its directory is
    ``--compile-cache-dir``'s, item 9.5."""
    shard_set = EmbeddingShardSet.build(
        model, cfg.serve_shards, config=ShardTierConfig.from_config(cfg))
    freed = EmbeddingShardSet.release_ranker_tables(model)
    log_app.info("sharded serving tier: %d in-process lookup shard(s), "
                 "ranker released %.1f MB of tables", cfg.serve_shards,
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
    """The HTTP handler class over ``serve`` (an InferenceEngine);
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
                if pred.versions is not None:
                    # the shard tier: the per-shard version vector this
                    # answer read, and whether default rows went into it
                    body["versions"] = {str(k): int(v)
                                        for k, v in pred.versions.items()}
                    body["degraded"] = bool(pred.degraded)
                self._reply(200, body)
            except Overloaded as e:
                self._reply(429, {"error": str(e)})
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
    ``--retrieve on``, and with ``--serve-shards N`` the index rides
    those N shards, so ``--retrieve-shards`` must be 0 or N."""
    v = _flag(rest, "--retrieve", "off")
    if v not in ("on", "off"):
        raise ValueError(f"--retrieve expects on|off, got {v!r}")
    if v == "off":
        if cfg.retrieve_shards > 0:
            raise SystemExit(
                "--retrieve-shards does nothing without --retrieve on — "
                "refusing to silently ignore it")
        return False
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


class App:
    """One serving app: the engine (started), its HTTP server bound to
    ``address`` and, with ``--retrieve on``, the cascade. ``serve``
    blocks until ``shutdown`` (from another thread or a signal);
    ``close`` releases everything."""

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
        model = build_server_model(cfg, dcfg)
        self.shard_set = None
        if cfg.serve_shards > 0:
            self.shard_set = _build_shard_set(cfg, model)
        self.engine = InferenceEngine(model, checkpoint_dir=ckpt_dir,
                                      shard_set=self.shard_set)
        if ckpt_dir:
            # the first restore through the watcher's READ-ONLY manifest
            # scan (a CheckpointManager would sweep temp files under a
            # live trainer): params only, the newest valid snapshot
            if SnapshotWatcher(self.engine, ckpt_dir).poll_once():
                log_app.info("serving snapshot version %d",
                             self.engine.version)
            else:
                log_app.warning(
                    "no restorable snapshot in %s — serving fresh init "
                    "until the trainer publishes one", ckpt_dir)
        self.cascade = self._index_set = None
        if retrieve:
            self.cascade, self._index_set = _build_cascade(
                cfg, dcfg, self.engine, self.shard_set)
        if self.shard_set is not None:
            # no autoscaler drives the shards' health: the set probes,
            # re-admits and replaces on its own thread
            self.shard_set.start_health()
        self.engine.start()
        self.httpd = ThreadingHTTPServer(
            (host, port), make_handler(
                self.engine, [t.name for t in model.input_tensors],
                cascade=self.cascade))
        self.address = self.httpd.server_address[:2]

    def serve(self):
        self.httpd.serve_forever()

    def shutdown(self):
        """Stop ``serve`` (safe from a signal handler: it must not wait
        on the thread it interrupts)."""
        threading.Thread(target=self.httpd.shutdown, daemon=True).start()

    def close(self):
        from ...obs import trace as obstrace
        self.httpd.server_close()
        self.engine.close()
        if self.shard_set is not None:
            self.shard_set.close()      # stops its health thread first
        if self._index_set is not None:
            self._index_set.close()
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
