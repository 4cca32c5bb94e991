#!/usr/bin/env python3
"""Development probe of the one-launch stateful touched-rows update
(``stateful_fused_kernel`` in ``csrc/scatter_rows.cu``) on one GPU: the
kernel cut after each phase, in ids spread over the 8M-row table and in
ids confined to its first rows.

Run from the root of a checkout of the port, with one card visible:

    python3 tools/stateful_probe.py

The script writes copies of ``csrc/scatter_rows.cu`` with the cuts into
``build/probe/``, builds them with the package's nvcc flags and times
each through the wrapper's fused route with chip_smoke.py's queued
CUDA-event timing, at the "cat" step's n = 2,048 lookups, d = 64, under
Adam, with the forward rows as residual. The copies never ship: the
kernel has no probe switch. Cuts: "stage" (the ids staged as keys, then
every warp leaves), "+owner" (each warp scans the keys before its
lookup for its row, then leaves), "+rows" (the
owner loads and updates its rows from its own lookup's update alone and
writes them, no scan for the row's later lookups) and "full". Ids
"spread" are uniform over the 8M rows (the step's); "first rows"
uniform over the first 16,384 rows, whose weight and slab rows (4 MB
each) stay in the L2 cache and its address translation. The
differences between neighbouring cuts are the phases' times; a phase
that overlaps another shows less than it takes alone.
"""

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))

from kernel_probe import build_libs, sub  # noqa: E402

# a side effect no input meets, so that a cut keeps the work before it
_KEEP = ("if (threadIdx.x == 0 && keys32[n - 1] == -7) "
         "table[0].x = u0.x + f0.x;")


def cuts(s):
    s = sub(s, """  __syncthreads();
  for (int g = g0; g < n;""", """  __syncthreads();
#if PROBE == 1
  """ + _KEEP + """
  return;
#endif
  for (int g = g0; g < n;""")
    s = sub(s, """  const int64_t row = key;
  const float a = alpha_t""", """#if PROBE == 2
  if (key == -7) table[0].x = u0.x + f0.x;
  return;
#endif
  const int64_t row = key;
  const float a = alpha_t""")
    s = sub(s, "for (int base = g / kStep * kStep; base < n;",
            "for (int base = g / kStep * kStep; PROBE != 3 && base < n;")
    return s, [("stage", 1), ("+owner", 2), ("+rows", 3), ("full", 9)]


def main():
    import torch
    from dlrm_flexflow_tpu_torch.ops.kernels import build
    from dlrm_flexflow_tpu_torch.ops.kernels import scatter_rows as sm
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    csrc = HERE / "dlrm_flexflow_tpu_torch" / "csrc"
    text, levels = cuts((csrc / "scatter_rows.cu").read_text())
    libs = build_libs(build, [(name, text, [f"-DPROBE={lv}"])
                              for name, lv in levels],
                      {name: sm._SIGNATURES for name, _ in levels}, csrc)
    dev = torch.device("cuda", 0)
    print(cs.device_line())
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rows = cs.T * cs.ROWS
    table = torch.randn(rows, cs.D, device=dev, generator=gen)
    slabs = {k: 1e-3 * torch.rand(rows, cs.D, device=dev, generator=gen)
             for k in ("m", "v")}
    opt = cs.TRAIN_OPTS["adam"]()
    p = opt.row_params()
    alpha_t = opt.alpha_t(torch.tensor(4, dtype=torch.int32, device=dev))
    n = cs.TRAIN_B * cs.T * cs.BAG
    for what, span in (("spread", rows), ("first rows", 16384)):
        sets = []
        for _ in range(60):
            ids = torch.randint(0, span, (n,), device=dev, generator=gen)
            sets.append((ids, torch.randn(n, cs.D, device=dev,
                                          generator=gen), table[ids]))
        line = []
        for name, _ in levels:
            build._libs["scatter_rows"] = libs[name]
            ms = cs.time_ms(lambda i, u, f: sm._stateful_kernels(
                table, i, u, f, slabs, p, alpha_t, 1, True), sets)[0]
            line.append(f"{name} {1e3 * ms:.2f}")
        print(f"probe stateful fused n={n} ({what} ids) us: "
              + ", ".join(line))


if __name__ == "__main__":
    main()
