#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases:

1. device — the card's name and power limit, as nvidia-smi reports them;
2. build — every CUDA kernel of the serving path, compiled from
   ``dlrm_flexflow_tpu_torch/csrc`` with nvcc for sm_90a, one nvcc per
   source, all started together;
3. kernels — each kernel at the serving path's full-width shapes
   (B=2048, T=8, bag=1, d=64, 8M-row table; H=1024 for the interaction)
   against its plain PyTorch version on the same inputs, then timed
   beside its bound, the plain version and, where one PyTorch call
   computes the same function, that call: device time from the
   profiler's trace, and the time of back-to-back calls between CUDA
   events, which the host's launch rate bounds;
4. serve — the full-width ``DLRMConfig.random_benchmark()`` model in the
   "cat" graph and in the fused "dot" graph, each behind
   ``InferenceEngine(ServeConfig(max_batch=256))`` taking a few dozen
   requests of 1-64 rows from 4 threads. Every kernel's launch count is
   set to 0 just before each run and read just after; the kernel of that
   graph must have launched and its plain version must not have run.
   Every response must equal ``forward_batch`` of its rows, and a small
   batch must agree with the same weights run on the CPU. One full
   bucket (256 rows) is profiled: its wall time against the device time
   of its kernels gives the device's idle share.

The last two lines are a JSON object with every kernel's numbers and
``{"ok": true, "device": {...}}``. Without a GPU, or when any check
fails, the script exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from dlrm_flexflow_tpu_torch import FFConfig, FFModel
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.ops.kernels import build
from dlrm_flexflow_tpu_torch.ops.kernels import embedding_bag as bag_mod
from dlrm_flexflow_tpu_torch.ops.kernels import interaction as inter_mod
from dlrm_flexflow_tpu_torch.serve import InferenceEngine, ServeConfig

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# fp32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
SEED = 0
B, T, BAG, D, ROWS, H = 2048, 8, 1, 64, 1_000_000, 1024
ID_SETS = 20     # distinct id batches cycled while timing: 80 MB of rows,
#                  more than the 50 MB L2, as live traffic would touch


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, arg_sets, iters=60, warmup=6):
    """(device ms, call ms) per call over `iters` calls cycling
    `arg_sets`, after a warmup. Device ms is the summed time of every
    kernel the calls ran, from the profiler's CUPTI trace; call ms is
    the span of back-to-back calls between two CUDA events, which the
    host's launch rate bounds when the calls are short."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t1.record()
    torch.cuda.synchronize()
    call_ms = t0.elapsed_time(t1) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    check(device_us > 0, "the profiler recorded no device time")
    return device_us / 1e3 / iters, call_ms


def timed(prefix, fn, arg_sets):
    dev_ms, call_ms = time_ms(fn, arg_sets)
    return {f"{prefix}ms": dev_ms, f"{prefix}call_ms": call_ms}


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stacked_ids(gen, batch, dev):
    ids = torch.randint(0, ROWS, (batch, T, BAG), device=dev, generator=gen)
    return ids + (torch.arange(T, device=dev) * ROWS)[None, :, None]


def kernel_phase(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = 0.5 * torch.randn(T * ROWS, D, device=dev, generator=gen)
    id_sets = [stacked_ids(gen, B, dev) for _ in range(ID_SETS)]
    rows = {}

    # -- kernel 1: embedding bag over the stacked table ----------------
    flat = [i.reshape(B * T, BAG) for i in id_sets]
    got = bag_mod.embedding_bag(table, flat[0], "sum")
    want = bag_mod.embedding_bag_reference(table, flat[0], "sum")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # same fp32 sum in bag order on both sides
    check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
          f"embedding_bag kernel disagrees with its plain version: {err}")
    n = B * T
    b_ms, b_by = bound(n * BAG * D * 4 + n * D * 4 + n * BAG * 8,
                       n * BAG * D)
    args = [(i,) for i in flat]
    rows["embedding_bag"] = {
        "name": "embedding_bag", "route": "cuda",
        "source": "dlrm_flexflow_tpu_torch/csrc/embedding_bag.cu",
        "replaces": "dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:55",
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        **timed("", lambda i: bag_mod.embedding_bag(table, i, "sum"), args),
        **timed("plain_", lambda i: bag_mod.embedding_bag_reference(
            table, i, "sum"), args),
        **timed("library_", lambda i: torch.nn.functional.embedding_bag(
            i, table, mode="sum"), args),
    }

    # -- kernel 2: fused gather -> X·Xᵀ -> tril -> first top layer -----
    P = (T + 1) * T // 2
    bottom = torch.rand(B, D, device=dev, generator=gen)
    lim = (6.0 / (D + P + H)) ** 0.5
    w = (torch.rand(D + P, H, device=dev, generator=gen) * 2 - 1) * lim
    bias = 0.01 * torch.randn(H, device=dev, generator=gen)
    got = inter_mod.fused_interaction(table, id_sets[0], bottom, w, bias)
    want = inter_mod.fused_interaction_reference(table, id_sets[0], bottom,
                                                 w, bias)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # the dots and the layer's products sum in another fp32 order
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"fused_interaction kernel disagrees with its plain version: "
          f"{err}")
    b_ms, b_by = bound(
        B * T * BAG * (D * 4 + 8) + B * D * 4 + (D + P) * H * 4 + H * 4
        + B * H * 4,
        B * (2 * P * D + 2 * (D + P) * H))
    args = [(i,) for i in id_sets]
    rows["fused_interaction"] = {
        "name": "fused_interaction", "route": "cuda",
        "source": "dlrm_flexflow_tpu_torch/csrc/interaction.cu",
        "replaces": "dlrm_flexflow_tpu/ops/pallas/interaction_kernel.py:92",
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        **timed("", lambda i: inter_mod.fused_interaction(
            table, i, bottom, w, bias), args),
        **timed("plain_", lambda i: inter_mod.fused_interaction_reference(
            table, i, bottom, w, bias), args),
        "library_ms": None, "library_call_ms": None,
    }
    for r in rows.values():
        def fmt(key):
            v = r[key]
            return "n/a" if v is None else f"{v:.4f} ms"

        print(f"kernel {r['name']}: device {fmt('ms')} (call "
              f"{fmt('call_ms')}), plain {fmt('plain_ms')} (call "
              f"{fmt('plain_call_ms')}), library {fmt('library_ms')} (call "
              f"{fmt('library_call_ms')}), bound "
              f"{1e3 * r['bound_ms']:.2f} us ({r['bound_by']}), max abs "
              f"err {r['max_abs_err']:.3g}")
    return rows


class PlainCalls:
    """Counts calls of the kernels' plain versions while installed (the
    wrappers look them up as module globals at each call)."""

    def __init__(self):
        self.calls = 0
        self._saved = []

    def __enter__(self):
        for mod, name in ((bag_mod, "embedding_bag_reference"),
                          (inter_mod, "fused_interaction_reference")):
            real = getattr(mod, name)

            def counted(*a, _real=real, **kw):
                self.calls += 1
                return _real(*a, **kw)

            self._saved.append((mod, name, real))
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self._saved:
            setattr(mod, name, real)


def serve_phase(mode):
    """Serve the full-width model of one graph; returns the kernels'
    launch counts over the run."""
    cfg = DLRMConfig.random_benchmark()
    fused = mode == "dot"
    if fused:
        cfg.arch_interaction_op = "dot"
        cfg.mlp_top = [D + (T + 1) * T // 2] + cfg.mlp_top[1:]
    model = FFModel(FFConfig(batch_size=256, seed=SEED, device="cuda"))
    build_dlrm(model, cfg, fuse_interaction=fused)
    model.compile()
    t0 = time.perf_counter()
    model.init_layers()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    rng = np.random.RandomState(SEED + 1)
    sizes = [int(s) for s in rng.randint(1, 65, size=48)]
    data, _ = synthetic_batch(cfg, sum(sizes), seed=SEED + 2)
    spans, off = [], 0
    for s in sizes:
        spans.append((off, off + s))
        off += s
    results = {}
    errors = []

    # the main path: every count at 0 just before, read just after
    bag_mod.embedding_bag.launches = 0
    inter_mod.fused_interaction.launches = 0
    with PlainCalls() as plain:
        engine = InferenceEngine(model, ServeConfig(max_batch=256))
        with engine:
            def client(k):
                try:
                    for i in range(k, len(spans), 4):
                        a, b = spans[i]
                        feats = {kk: v[a:b] for kk, v in data.items()}
                        results[i] = engine.predict(feats, timeout=120)
                except Exception as e:   # noqa: BLE001 — reported below
                    errors.append(repr(e))

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            wall = time.perf_counter() - t0
            stats = engine.stats()
    launches = {"embedding_bag": bag_mod.embedding_bag.launches,
                "fused_interaction": inter_mod.fused_interaction.launches}
    check(not errors and not any(t.is_alive() for t in threads),
          f"{mode}: requests failed: {errors[:3]}")
    check(len(results) == len(spans), f"{mode}: missing responses")
    kernel = "fused_interaction" if fused else "embedding_bag"
    check(launches[kernel] > 0,
          f"{mode}: the {kernel} kernel never launched on the serve path")
    check(plain.calls == 0,
          f"{mode}: a plain version ran {plain.calls} times on the card")

    # every response equals forward_batch of its rows (cuBLAS may reduce
    # in another order for another row count, hence the tolerance)
    worst = 0.0
    for i, (a, b) in enumerate(spans):
        feats = {k: v[a:b] for k, v in data.items()}
        want = model.forward_batch(feats).cpu().numpy()
        got = results[i].scores
        check(got.shape == (b - a, 1) and np.isfinite(got).all(),
              f"{mode}: bad scores for request {i}: {got.shape}")
        worst = max(worst, float(np.abs(got - want).max()))
        check(np.allclose(got, want, rtol=1e-5, atol=1e-6),
              f"{mode}: request {i} differs from forward_batch by "
              f"{np.abs(got - want).max()}")

    # where a full bucket's time goes: host wall clock per forward (to
    # the scores on the host) against the device time of its kernels
    full = {k: v[:256] for k, v in data.items()}
    model.forward_bucket(full, 256).cpu()
    reps = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            model.forward_bucket(full, 256).cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    per_kernel = sorted(((e.self_device_time_total / reps, e.key)
                         for e in prof.key_averages()), reverse=True)
    dev_ms = sum(us for us, _ in per_kernel) / 1e3
    top = ", ".join(f"{k[:40]} {us:.1f} us" for us, k in per_kernel[:4])
    print(f"serve {mode}: forward_bucket(256 rows) wall {wall_ms:.3f} ms, "
          f"device {dev_ms:.3f} ms, device idle "
          f"{100 * (1 - dev_ms / wall_ms):.1f}%; top: {top}")

    # the same weights on the CPU (plain versions, MKL) on a small batch
    cpu = FFModel(FFConfig(batch_size=256, seed=SEED, device="cpu"))
    build_dlrm(cpu, cfg, fuse_interaction=fused)
    cpu.compile()
    cpu.swap_params({op: {n: v.cpu() for n, v in p.items()}
                     for op, p in model.params.items()})
    small = {k: v[:64] for k, v in data.items()}
    on_card = model.forward_batch(small).cpu().numpy()
    on_cpu = cpu.forward_batch(small).numpy()
    cpu_err = float(np.abs(on_card - on_cpu).max())
    check(np.allclose(on_card, on_cpu, rtol=1e-5, atol=1e-5),
          f"{mode}: card and CPU disagree by {cpu_err}")
    print(f"serve {mode}: {len(spans)} requests, {sum(sizes)} rows in "
          f"{wall:.3f} s ({len(spans) / wall:.1f} req/s, "
          f"{sum(sizes) / wall:.1f} rows/s), p50 {stats['p50_ms']:.3f} ms, "
          f"p99 {stats['p99_ms']:.3f} ms, {stats['batches']} batches, "
          f"fill {stats['batch_fill']:.3f}, warmup {stats['warmup_s']} s, "
          f"init {t_init:.2f} s; launches {launches}; max err vs "
          f"forward_batch {worst:.3g}, vs cpu {cpu_err:.3g}")
    del model, cpu, engine
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(device_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {len(logs)} kernel sources in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rows = kernel_phase(dev)
    torch.cuda.empty_cache()

    launches = {}
    for mode in ("cat", "dot"):
        got = serve_phase(mode)
        launches.update({k: v for k, v in got.items() if v})
    for name, r in rows.items():
        r["launches"] = launches.get(name, 0)
        check(r["launches"] > 0, f"{name} never launched on the main path")

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
