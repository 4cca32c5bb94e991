#!/usr/bin/env python3
"""Development probe of the touched-rows pre-pass (``csrc/scatter_rows.cu``:
the rank kernel and the cluster radix kernel) and of kernel 4's call on
one GPU: the two kernels at the main path's lookup counts, the radix
kernel's cluster sizes, digit widths and block widths, the radix kernel
cut after each phase, and kernel 4 with each pre-pass and with the
update launched with and without programmatic dependent launch.

Run from the root of a checkout of the port, with one card visible:

    python3 tools/presort_probe.py

The script writes copies of ``csrc/scatter_rows.cu`` into
``build/probe/``: "as built"; "11-bit digits" (kDigitBits 11: 2 passes
over 22-bit keys, 3 over 23); "256 threads" (kSortThreads 256: 8 warps a
block); "no dependent launch" (the update launched plainly); "match
peers" (a key's digit group in its warp from __match_any_sync in place
of the kernel's 8 ballots); and the radix kernel cut "loads" (the keys
loaded, then every block leaves), "1 pass" (one radix pass, no heads),
"ranks" (every pass left after the warps' ranks), "+counts" (after the
digit counts' cluster barrier), "+offsets" (after the digit offsets)
and "passes" (every pass whole, no heads).
It builds them with the package's nvcc flags and times each through the
wrapper with chip_smoke.py's queued CUDA-event timing, the kernel chosen
by setting the wrapper's ``presort_cluster`` (0: the rank kernel), every
uncut result held bitwise to the plain version first. The copies never
ship: the kernels have no probe switch. Shapes: n = 2,048 on the 8M-row
table (the "cat" step's), 4,096, 4,608 and 5,120 there (about the
kernels' crossover), 6,656 on Criteo-Kaggle's 11,386,880
rows (its step's count; uniform ids here, the step's own in
chip_smoke.py) and 8,192 on a rank's 4M-row block [4M, 8M); kernel 4 at
the last, d = 64. Kernels are timed in turns (rank, radix, radix, rank)
within the one call.
"""

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))

from kernel_probe import build_libs, sub  # noqa: E402

# (n, lo, rows, what)
SIZES = ((2048, 0, 8_000_000, "the \"cat\" step, 8M rows"),
         (4096, 0, 8_000_000, "8M rows"),
         (4608, 0, 8_000_000, "8M rows"),
         (5120, 0, 8_000_000, "8M rows"),
         (6656, 0, 11_386_880, "Criteo-Kaggle's count, 11.4M rows"),
         (8192, 4_000_000, 4_000_000, "a rank's 4M-row block"))
CLUSTERS = (1, 2, 4, 8, 16)


def cuts(s):
    """The radix kernel cut after its loads (PROBE 1), after one pass
    (2), after every pass (3), and with every pass left after its ranks
    (4), its counts' barrier (5) or its offsets (6), each keeping its
    work by writing the keys' positions into order."""
    s = sub(s, """  int* mine = counts + warp * kDigits;
  const int passes = max(1, (bits + kDigitBits - 1) / kDigitBits);""",
            """#if PROBE == 1
#pragma unroll
  for (int k = 0; k < kSortSteps; ++k)
    if (k * 32 < span && first + k * 32 + lane < cnt)
      order[p0 + first + k * 32 + lane] = (int)(uint32_t)key[k];
  return;
#endif
  int* mine = counts + warp * kDigits;
  const int passes =
      PROBE == 2 ? 1 : max(1, (bits + kDigitBits - 1) / kDigitBits);""")
    s = sub(s, """  // heads and counts: thread t holds the places [t per, (t + 1) per) of""",
            """#if PROBE >= 4
  cluster.sync();
#endif
#if PROBE >= 2
  for (int l = threadIdx.x; l < cnt; l += kSortThreads)
    order[p0 + l] = (int)(uint32_t)keys[l];
  return;
#endif
  // heads and counts: thread t holds the places [t per, (t + 1) per) of""")
    # inside every pass: leave it after the ranks (4), after the digit
    # counts' barrier (5), after the digit offsets (6)
    s = sub(s, """      if (on && below == 0) mine[d] = seen + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
""", """      if (on && below == 0) mine[d] = seen + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    if (PROBE == 4) continue;
""")
    s = sub(s, """    cluster.sync();                   // every block's counts are here
""", """    cluster.sync();                   // every block's counts are here
    if (PROBE == 5) continue;
""")
    s = sub(s, """      if (d < kDigits) base[d] = at + lower[q];
      at += tot[q];
    }
    __syncthreads();
""", """      if (d < kDigits) base[d] = at + lower[q];
      at += tot[q];
    }
    __syncthreads();
    if (PROBE == 6) continue;
""")
    return s


def match_peers(s):
    """A key's digit group in its warp from __match_any_sync in place of
    the kernel's ballots (one a digit bit)."""
    return sub(s, """      unsigned peers = __ballot_sync(0xffffffffu, on);
#pragma unroll
      for (int b = 0; b < kDigitBits; ++b) {
        const unsigned set = __ballot_sync(0xffffffffu, (d >> b) & 1);
        peers &= (d >> b) & 1 ? set : ~set;
      }""", """      const unsigned peers =
          __match_any_sync(0xffffffffu, on ? d : kDigits + lane);""")


def variants(s):
    cut = cuts(s)
    return [("as built", s, []),
            ("11-bit digits", sub(s, "constexpr int kDigitBits = 8;",
                                  "constexpr int kDigitBits = 11;"), []),
            ("256 threads", sub(s, "constexpr int kSortThreads = 512;",
                                "constexpr int kSortThreads = 256;"), []),
            ("no dependent launch",
             sub(s, "constexpr int kDependentLaunch = 1;",
                 "constexpr int kDependentLaunch = 0;"), []),
            ("match peers", match_peers(s), []),
            ("loads", cut, ["-DPROBE=1"]), ("1 pass", cut, ["-DPROBE=2"]),
            ("ranks", cut, ["-DPROBE=4"]), ("+counts", cut, ["-DPROBE=5"]),
            ("+offsets", cut, ["-DPROBE=6"]), ("passes", cut, ["-DPROBE=3"])]


def main():
    import torch
    from dlrm_flexflow_tpu_torch.ops.kernels import build
    from dlrm_flexflow_tpu_torch.ops.kernels import scatter_rows as sm
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    csrc = HERE / "dlrm_flexflow_tpu_torch" / "csrc"
    sources = variants((csrc / "scatter_rows.cu").read_text())
    libs = build_libs(build, sources,
                      {name: sm._SIGNATURES for name, _, _ in sources}, csrc)
    for line in build.build_all(["scatter_rows"]).get("scatter_rows",
                                                       "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda", 0)
    print(cs.device_line())
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    plan = sm.presort_cluster

    def presort(name, cluster, lo, rows, sets, want):
        """Device us of the pre-pass of library `name` on `cluster`
        blocks (0: the rank kernel); held to `want` unless cut."""
        build._libs["scatter_rows"] = libs[name]
        sm.presort_cluster = lambda n: cluster
        try:
            got = sm.scatter_presort(sets[0][0], lo, rows)
            cs.check(want is None or all(
                torch.equal(a.cpu(), w) for a, w in zip(got, want)),
                f"{name} pre-pass (cluster {cluster}) disagrees with its "
                f"plain version")
            return 1e3 * cs.time_ms(lambda i: sm.scatter_presort(i, lo, rows),
                                    sets)[0]
        finally:
            sm.presort_cluster = plan

    for n, lo, rows, what in SIZES:
        sets = [(lo + torch.randint(0, rows, (n,), device=dev,
                                    generator=gen),)
                for _ in range(cs.ID_SETS)]
        want = sm.presort_reference(sm.window_ids(sets[0][0].cpu(), lo,
                                                  rows))
        c = plan(n) or -(-n // sm.SLICE_MAX)
        line = []
        for name, cl in (("rank", 0), ("radix", c), ("radix", c),
                         ("rank", 0)):
            us = presort("as built", cl, lo, rows, sets, want)
            line.append(f"{name} {us:.2f}")
        for cl in CLUSTERS:
            if -(-n // cl) <= sm.SLICE_MAX:
                us = presort("as built", cl, lo, rows, sets, want)
                line.append(f"C={cl} {us:.2f}")
        for name in ("11-bit digits", "256 threads", "match peers"):
            us = presort(name, c, lo, rows, sets, want)
            line.append(f"{name} {us:.2f}")
        for name in ("loads", "1 pass", "ranks", "+counts", "+offsets",
                     "passes"):
            us = presort(name, c, lo, rows, sets, None)
            line.append(f"cut {name} {us:.2f}")
        print(f"probe pre-pass n={n} ({what}, {sm.key_bits(rows)}-bit keys; "
              f"radix C={c}, the wrapper's {plan(n)}) us: "
              + ", ".join(line))

    # kernel 4 at a rank's shape: the pre-pass and the update
    n, lo, rows, _ = SIZES[-1]
    base = 0.5 * torch.randn(rows, cs.D, device=dev, generator=gen)
    block = base.clone()            # timing only: its values drift
    sets = [(lo + torch.randint(0, rows, (n,), device=dev, generator=gen),
             torch.randn(n, cs.D, device=dev, generator=gen))
            for _ in range(cs.ID_SETS)]
    want = sm.sharded_scatter_add_rows_reference(
        base.cpu(), sets[0][0].cpu(), sets[0][1].cpu(), lo, scale=-cs.LR)

    def kernel4(name, cluster):
        build._libs["scatter_rows"] = libs[name]
        sm.presort_cluster = lambda n: cluster
        try:
            got = sm.sharded_scatter_add_rows(base.clone(), *sets[0], lo,
                                              scale=-cs.LR)
            cs.check(torch.equal(got.cpu(), want),
                     f"{name}: kernel 4 disagrees with its plain version")

            def call(i, u):
                sm.sharded_scatter_add_rows(block, i, u, lo, scale=-cs.LR)
            split = cs.traced_split(call, sets)
            return 1e3 * cs.time_ms(call, sets)[0], split
        finally:
            sm.presort_cluster = plan

    turns = [(name, cl) for name in ("as built", "no dependent launch")
             for cl in (0, plan(n))]
    for name, cl in turns + turns[::-1]:
        us, split = kernel4(name, cl)
        kind = "rank" if cl == 0 else f"radix C={cl}"
        print(f"probe kernel 4 n={n} on a {rows:,}-row block, {name}, "
              f"{kind}: {us:.2f} us; traced: {split}")


if __name__ == "__main__":
    main()
