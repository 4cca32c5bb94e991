#!/usr/bin/env python3
"""Development probe of the LSTM backward's gate phase (``csrc/lstm.cu``:
``lstm_gates_wgmma_kernel``, the "wgmma" route, beside
``lstm_gates_kernel``, the "mma" route) on one GPU, at the NMT layer's
shape (T = 40, b = 64, h = 1,024, bf16 wh).

Run from the root of a checkout of the port, with one card visible:

    python3 tools/gates_probe.py [--check]

The script writes copies of ``csrc/lstm.cu`` into ``build/probe/`` and
builds them with the package's nvcc flags: "as built" (128 × 256 tiles,
32-deep stages, clusters of 2 × 2 CTAs multicasting ys and wh, the
storer's TMA stores, L2 hints); the tilings "BK 64" and "BN 128"; "no
overlap" (each stage waits for its own wgmmas, none left in flight
while the next stage's A fragments load); the clusters "cluster 1×1"
(no multicast), "1×2" (ys multicast), "2×1" (wh multicast) and "2×4";
"cluster-scope arrivals" (the consumers' arrivals in the cluster with
.release.cluster); "no L2 hints" (every copy and store at the normal
eviction priority); "prefetch xproj" (the tile's xproj into L2 by TMA
four k stages before its copies); and the kernel cut: "no epilogue"
(PROBE 1: no xproj is loaded and no gate stored; the main loop alone),
"no products" (PROBE 2: every copy, A fragment and store, no wgmma) and
"loads only" (PROBE 3: the producer's copies alone, each stage released
as it lands, nothing stored). It prints ptxas's registers and spills of
the two kernels, holds every uncut variant to ``lstm_gates_reference``
(atol 1e-4, as the card tests) at the card tests' shapes, then times
each through the wrapper with chip_smoke.py's queued CUDA-event timing
over three input sets (182 MB, more than the L2), the routes in turns
(mma, wgmma, wgmma, mma). The differences between the cuts are the
phases' times; a phase that overlaps another shows less than it takes
alone. The copies never ship: the kernel has no probe switch.

``--check`` builds "as built" and "swapped offsets" (the B descriptor's
leading and stride byte offsets exchanged, a deliberately wrong
descriptor) and only holds each to the plain version at every shape: a
check that the shapes catch a wrong MN-major descriptor.
"""

import argparse
import importlib.util
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))

from kernel_probe import build_libs, sub  # noqa: E402

T, B, H = 40, 64, 1024
# the card tests' shapes: the NMT layer, K = 136 (not a multiple of the
# k depth), one row, a tile across the zero rows of t = 0 with N = 4,000,
# the largest resident h
SHAPES = ((40, 64, 1024), (3, 5, 136), (1, 1, 8), (2, 100, 1000),
          (40, 64, 3296))


def tiling(s, bn, bk):
    s = sub(s, "constexpr int kWgBN = 256;", f"constexpr int kWgBN = {bn};")
    return sub(s, "constexpr int kWgBK = 32;", f"constexpr int kWgBK = {bk};")


def cuts(s):
    """The wgmma kernel with PROBE 1 (no epilogue), 2 (no wgmma) and 3
    (the producer's copies alone)."""
    s = s.replace("      for (int c = 0; c < kWgChunks; ++c) {",
                  "      for (int c = 0; c < (PROBE == 1 ? 0 : kWgChunks);"
                  " ++c) {")
    if s.count("(PROBE == 1 ? 0 : kWgChunks)") != 3:
        raise SystemExit("probe: the source's chunk loops moved")
    s = sub(s, "  for (int kk = 0; kk < kWgBK / 16; ++kk) {\n"
               "    const uint32_t base",
            "  for (int kk = 0; kk < (PROBE == 3 ? 0 : kWgBK / 16); ++kk) {\n"
            "    const uint32_t base")
    s = sub(s, "    wgmma_rs<kWgBN>(acc, a[kk],",
            "    if (PROBE < 2) wgmma_rs<kWgBN>(acc, a[kk],")
    s = sub(s, "            tma_store(&gt_map,",
            "            if (PROBE != 3) tma_store(&gt_map,")
    return sub(s, "        for (int x = 0; x < kWgXBoxes; ++x)\n#pragma unroll\n"
                  "          for (int j = 0; j < 4; ++j)",
               "        for (int x = 0; x < (PROBE == 3 ? 0 : kWgXBoxes); ++x)"
               "\n#pragma unroll\n          for (int j = 0; j < 4; ++j)")


def cluster(s, cm, cn):
    return sub(s, "constexpr int kWgCM = 2, kWgCN = 2;",
               f"constexpr int kWgCM = {cm}, kWgCN = {cn};")


def no_overlap(s):
    return sub(s, "  wgmma_wait<1>();\n  if (!first)",
               "  wgmma_wait<0>();\n  if (!first)")


def cluster_arrivals(s):
    return sub(s, " mbarrier.arrive.shared::cluster.b64 _, [ra];",
               " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];")


def no_hints(s):
    s = sub(s, "__device__ __forceinline__ uint64_t evict_first() {",
            "__device__ __forceinline__ uint64_t evict_normal() {\n"
            "  uint64_t p;\n  asm volatile(\"createpolicy.fractional"
            ".L2::evict_normal.b64 %0, 1.0;\\n\" : \"=l\"(p));\n"
            "  return p;\n}\n"
            "__device__ __forceinline__ uint64_t evict_first() {")
    s = sub(s, "const uint64_t keep = evict_last(), once = evict_first();",
            "const uint64_t keep = evict_normal(), once = keep;")
    return sub(s, "const uint64_t out = evict_first();",
               "const uint64_t out = evict_normal();")


def prefetch(s):
    """xproj into L2 by TMA four k stages before its copies."""
    s = sub(s, "__device__ __forceinline__ float2 lds_f2(uint32_t addr) {",
            "__device__ __forceinline__ void tma_prefetch(const CUtensorMap* "
            "map, int c0, int r0) {\n  asm volatile(\"cp.async.bulk.prefetch"
            ".tensor.2d.L2.global.tile [%0, {%1, %2}];\\n\" :: \"l\"("
            "reinterpret_cast<uint64_t>(map)), \"r\"(c0), \"r\"(r0) : "
            "\"memory\");\n}\n"
            "__device__ __forceinline__ float2 lds_f2(uint32_t addr) {")
    return sub(s, "        mbar_expect_tx(bar, kWgStage);\n",
               "        mbar_expect_tx(bar, kWgStage);\n"
               "        if (kb == (kbs > 4 ? kbs - 4 : 0))\n"
               "          for (int x = 0; x < kWgBN / 32; ++x)\n"
               "            tma_prefetch(&xp_map, n0 + 32 * x, m0);\n")


def swapped(s):
    return sub(s, "(uint64_t)(kWgBBox >> 4) << 16 | (uint64_t)(1024 >> 4) << 32",
               "(uint64_t)(1024 >> 4) << 16 | (uint64_t)(kWgBBox >> 4) << 32")


def variants(s, check):
    if check:
        return [("as built", s, []), ("swapped offsets", swapped(s), [])]
    cut = cuts(s)
    return [("as built", s, []), ("BK 64", tiling(s, 256, 64), []),
            ("BN 128", tiling(s, 128, 32), []),
            ("no overlap", no_overlap(s), []),
            ("cluster 1×1", cluster(s, 1, 1), []),
            ("cluster 1×2", cluster(s, 1, 2), []),
            ("cluster 2×1", cluster(s, 2, 1), []),
            ("cluster 2×4", cluster(s, 2, 4), []),
            ("cluster-scope arrivals", cluster_arrivals(s), []),
            ("no L2 hints", no_hints(s), []),
            ("prefetch xproj", prefetch(s), []),
            ("no epilogue", cut, ["-DPROBE=1"]),
            ("no products", cut, ["-DPROBE=2"]),
            ("loads only", cut, ["-DPROBE=3"])]


def l2_mb(bn, cm=2, cn=2, bm=128, m=T * B, n=4 * H, k=H):
    """L2-to-SM megabytes of the operands at tiles bm × bn, fp32 ys, in
    clusters of cm × cn CTAs multicasting them."""
    return k * (m * -(-n // bn) * 4 / cn + n * -(-m // bm) * 2 / cm) / 1e6


def ptxas_lines(log):
    """ptxas's registers and spills of the two gate kernels."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in ("lstm_gates_wgmma_kernel",
                                     "lstm_gates_kernel")
                         if k in m.group(1)), None)
        elif name and ("registers" in line or "spill" in line
                       or "Potential" in line):
            out.append(f"{name}: {line.strip()}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    import torch
    from dlrm_flexflow_tpu_torch.ops.kernels import build
    from dlrm_flexflow_tpu_torch.ops.kernels import lstm as lm
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    csrc = HERE / "dlrm_flexflow_tpu_torch" / "csrc"
    sources = variants((csrc / "lstm.cu").read_text(), args.check)
    # a fresh checkout builds the package's library here, and prints
    # ptxas's report of it
    log = build.build_all(["lstm"]).get("lstm", "")
    for line in ptxas_lines(log) or ["(library already built: no report)"]:
        print(f"  ptxas: {line}")
    libs = build_libs(build, sources,
                      {name: lm._SIGNATURES for name, _, _ in sources}, csrc)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.device_line())
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)

    def inputs(t, b, h):
        xp, wh, _ = cs.lstm_inputs(gen, dev, t, b, h, torch.bfloat16)
        return xp, wh, torch.randn(t, b, h, device=dev, generator=gen)

    def use(name):
        build._libs["lstm"] = libs[name]

    def err_at(name, route, shape):
        use(name)
        xp, wh, ys = inputs(*shape)
        got = lm.lstm_gates(xp, wh, ys, route=route)
        torch.cuda.synchronize()
        return float((got - lm.lstm_gates_reference(xp, wh, ys))
                     .abs().max())

    uncut = [n for n, _, flags in sources if not flags]
    for name in uncut:
        errs = [err_at(name, "wgmma", s) for s in SHAPES]
        ok = all(e <= 1e-4 for e in errs)
        print(f"probe check {name}: max abs err by shape "
              + ", ".join(f"{s}: {e:.3g}" for s, e in zip(SHAPES, errs))
              + (" (within 1e-4)" if ok else " (DISAGREES)"))
        if name == "as built":
            built_ok = ok
    cs.check(built_ok, "the wgmma kernel as built disagrees with its "
             "plain version")
    if args.check:
        return

    use("as built")
    sets = [inputs(T, B, H) for _ in range(3)]
    nbytes = 2 * T * B * 4 * H * 4 + (T - 1) * B * H * 4 + H * 4 * H * 2
    bound_ms, by = cs.bound(nbytes, bf16_flops=2 * (T - 1) * B * H * 4 * H)

    def time_us(name, route):
        use(name)
        return 1e3 * cs.time_ms(lambda xp, wh, ys: lm.lstm_gates(
            xp, wh, ys, route=route), sets)[0]

    line = [f"{r} {time_us('as built', r):.2f}"
            for r in ("mma", "wgmma", "wgmma", "mma")]
    print(f"probe gates T={T}, b={B}, h={H} us (bound {1e3 * bound_ms:.2f}, "
          f"{by}): " + ", ".join(line))
    for name, _, flags in sources[1:]:
        bn = 128 if "BN 128" in name else 256
        cm, cn = ((int(name[-3]), int(name[-1]))
                  if name.startswith("cluster ") else (2, 2))
        extra = "" if flags else f", L2 to SM {l2_mb(bn, cm, cn):.0f} MB"
        print(f"probe gates {name}: {time_us(name, 'wgmma'):.2f} us{extra}")
    use("as built")
    split = cs.traced_split(lambda xp, wh, ys: lm.lstm_gates(xp, wh, ys),
                            sets)
    print(f"probe gates as built, traced: {split}")


if __name__ == "__main__":
    main()
