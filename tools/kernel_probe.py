#!/usr/bin/env python3
"""Development probes of the fused interaction and the embedding bag on
one GPU: the interaction cut after each phase and at other tilings, the
bag with other load and store instructions.

Run from the root of a checkout of the port, with one card visible:

    python3 tools/kernel_probe.py [--tree DIR]

DIR (default: this checkout) is the tree whose package and kernel
sources (``csrc/interaction.cu``, ``csrc/embedding_bag.cu``) are probed,
so that an older tree unpacked beside this one can be probed by the same
script. The script writes modified copies of the sources into
``build/probe/`` of this checkout, builds them with the package's nvcc
flags and times each through the tree's own wrapper with chip_smoke.py's
queued CUDA-event timing: the interaction at the batch sizes the paths
launch (chip_smoke.py's INTER_BATCHES, T = 8, d = 64, H = 1,024, over an
8M-row table), the bag at chip_smoke.py's BAG_SHAPES. The copies never
ship: the kernels have no probe switch.

Cuts of the kernel whose design has a W tile staged beside a cluster's
gather (``interaction_tiles`` in the wrapper): "floor" (a cluster
barrier and one store: the launch), "gather" (X only), "stage" (the W
tile only), "gather+stage", "+dots" (the dots, written into every
block of the cluster, and the cluster barrier) and "full". The cuts
that return before step 2 end the kernel's arrived cluster barrier with
a wait first (a block leaves no barrier half passed). the tilings of ``SWEEP`` beside the
chosen one. Cuts of the earlier design (one 16-sample tile a block, no
cluster): "gather", "+dots" and "full". The differences between
neighbouring cuts are the phases' times; a phase that overlaps another
shows less than it takes alone.

Bag variants, where the tree's source has their anchor: "as built";
"cached loads" (rows always read with __ldg); "non-allocating loads"
(rows always read with ld.global.nc.L1::no_allocate); "streaming
stores" (out and rows_out written with __stcs).
"""

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "build" / "probe"
# other tilings (sb, hc) at each batch, beside the chosen one
SWEEP = {16: [(2, 64), (4, 32)], 64: [(4, 64), (8, 64)],
         256: [(16, 128), (8, 64), (8, 256)],
         2048: [(32, 128), (64, 256), (32, 256), (128, 128)]}


def sub(s, old, new):
    if old not in s:
        raise SystemExit(f"probe: the source has no {old[:60]!r}")
    return s.replace(old, new, 1)


def cuts_of_clustered(s):
    """The kernel with a cluster's gather and a staged W tile."""
    s = sub(s, "  // 1. X rows of the own samples", """#if PROBE == 10
  cluster_wait();
  if (has_cols && tid < hc && s0 < B) out[(int64_t)s0 * H + col0 + tid] = 1.f;
  return;
#endif
  // 1. X rows of the own samples""")
    s = sub(s, "  const int items = n_own * F * vec;",
            "  const int items = PROBE == 12 ? 0 : n_own * F * vec;")
    s = sub(s, "  const bool tma_w = has_cols && tma;",
            "  const bool tma_w = PROBE != 11 && has_cols && tma;")
    s = sub(s, "  } else if (has_cols) {",
            "  } else if (has_cols && PROBE != 11) {")
    s = sub(s, """  __syncthreads();

  // 2. the own samples' feat rows""", """  __syncthreads();
#if PROBE == 1 || PROBE == 11 || PROBE == 12
  if (tma_w) mbar_wait(w_bar);
  __syncthreads();
  if (has_cols && tid < hc && s0 < B)
    out[(int64_t)s0 * H + col0 + tid] = xs[tid % (F * DS)] + ws[tid];
  cluster_wait();
  return;
#endif

  // 2. the own samples' feat rows""")
    s = sub(s, """  if (tma_w) mbar_wait(w_bar);
  __syncthreads();

  // 4. y =""", """  if (tma_w) mbar_wait(w_bar);
  __syncthreads();
#if PROBE == 2
  if (has_cols && tid < hc && s0 < B)
    out[(int64_t)s0 * H + col0 + tid] = feat[tid % (sb * KS)] + ws[tid];
  return;
#endif

  // 4. y =""")
    return s, (("floor", 10), ("gather", 11), ("stage", 12),
               ("gather+stage", 1), ("+dots", 2), ("full", 3))


def cuts_of_tiled(s):
    """The earlier kernel: one 16-sample tile a block, every block
    gathering its tile."""
    s = sub(s, """    reinterpret_cast<float4*>(xs + (s * F + f) * d)[c] = acc;
  }
  __syncthreads();
""", """    reinterpret_cast<float4*>(xs + (s * F + f) * d)[c] = acc;
  }
  __syncthreads();
#if PROBE == 1
  { const int h = blockIdx.y * kThreads + tid;
    if (h < H && s0 < B) out[(int64_t)s0 * H + h] = xs[tid % (kTileB * F * d)];
    return; }
#endif
""")
    s = sub(s, """    feat[s * K + k] = xs[s * F * d + k];
  }
  __syncthreads();
""", """    feat[s * K + k] = xs[s * F * d + k];
  }
  __syncthreads();
#if PROBE == 2
  { const int h = blockIdx.y * kThreads + tid;
    if (h < H && s0 < B) out[(int64_t)s0 * H + h] = feat[tid % (kTileB * K)];
    return; }
#endif
""")
    return s, (("gather", 1), ("+dots", 2), ("full", 3))


def bag_variants(s):
    """(name, source) of the bag kernel as built and with other load and
    store instructions, each where the source has its anchor."""
    out = [("as built", s)]
    asm = s[s.find("    float4 v;\n    asm(\"ld.global.nc.L1::no_allocate"):]
    if asm and "return v;" in asm:
        block = asm[:asm.index("return v;") + len("return v;")]
        out.append(("cached loads", s.replace(block, "    return __ldg(p);")))
    if "row_bytes >= kStreamBytes" in s:
        out.append(("non-allocating loads", s.replace(
            "row_bytes >= kStreamBytes", "true")))
    if "    out[g] = acc;" in s:
        out.append(("streaming stores", s.replace(
            "    out[g] = acc;", "    __stcs(out + g, acc);").replace(
            "rows_out[(row * bag + j) * vec + c] = v;",
            "__stcs(rows_out + (row * bag + j) * vec + c, v);")))
    return out


def build_libs(build, sources, signatures, include):
    """{name: loaded library} of (name, source text, extra nvcc flags),
    one nvcc each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, text, flags) in enumerate(sources):
        cu = OUT / f"probe_{i}.cu"
        cu.write_text(text)
        lib = OUT / f"libprobe_{i}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, *flags, f"-I{include}",
               "-o", str(lib), str(cu)]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, path, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"probe {name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(path))
        for fn, (args, res) in signatures[name].items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = res
        lib.ff_error_string.argtypes = [ctypes.c_int]
        lib.ff_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    tree = Path(ap.parse_args().tree).resolve()
    # the probed tree's package; this checkout's chip_smoke.py (its shapes
    # and its timing), whatever the tree is
    sys.path.insert(0, str(tree))
    import torch
    from dlrm_flexflow_tpu_torch.ops.kernels import build
    from dlrm_flexflow_tpu_torch.ops.kernels import embedding_bag as bm
    from dlrm_flexflow_tpu_torch.ops.kernels import interaction as im
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    csrc = tree / "dlrm_flexflow_tpu_torch" / "csrc"
    text = (csrc / "interaction.cu").read_text()
    clustered = "cluster_group" in text
    text, cuts = (cuts_of_clustered if clustered else cuts_of_tiled)(text)
    bags = bag_variants((csrc / "embedding_bag.cu").read_text())
    sources = [(name, text, [f"-DPROBE={level}"]) for name, level in cuts]
    sources += [(f"bag {name}", t, []) for name, t in bags]
    signatures = {name: im._SIGNATURES for name, _ in cuts}
    signatures.update({f"bag {name}": bm._SIGNATURES for name, _ in bags})
    libs = build_libs(build, sources, signatures, csrc)

    dev = torch.device("cuda", 0)
    print(cs.device_line())
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    table = 0.5 * torch.randn(cs.T * cs.ROWS, cs.D, device=dev,
                              generator=gen)
    for batch in cs.INTER_BATCHES:
        id_sets = [cs.stacked_ids(gen, batch, dev)
                   for _ in range(cs.ID_SETS)]
        bottom, w, bias = cs.interaction_args(gen, dev, batch)
        args = [(i,) for i in id_sets]
        want = im.fused_interaction_reference(table, id_sets[0], bottom, w,
                                              bias)

        def timed():
            return 1e3 * cs.time_ms(lambda i: im.fused_interaction(
                table, i, bottom, w, bias), args)[0]

        if clustered:
            t = im.interaction_tiles(batch, cs.H, cs.T, cs.D)
            n = libs["full"].ff_fused_interaction_max_clusters(
                batch, cs.T, cs.D, cs.H, t.sb, t.hc, t.ss, t.cl)
            tiles = (f" (sb={t.sb} hc={t.hc} ss={t.ss} cl={t.cl}, "
                     f"{t.grid[0] * t.grid[1] // t.cl} clusters, {n} "
                     f"resident)")
        line = []
        for name, _ in cuts:
            build._libs["interaction"] = libs[name]
            line.append(f"{name} {timed():.2f}")
        got = im.fused_interaction(table, id_sets[0], bottom, w, bias)
        cs.check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                 "the full probe disagrees with the plain version")
        tiles = ""
        print(f"probe B={batch}{tiles} us: " + ", ".join(line))
        if not clustered:
            continue
        chosen = im.interaction_tiles
        line = []
        for sb, hc in SWEEP.get(batch, []):
            u = im._tiles(batch, cs.H, cs.T, cs.D, sb, hc)
            im.interaction_tiles = lambda *a, _u=u: _u
            try:
                got = im.fused_interaction(table, id_sets[0], bottom, w, bias)
                cs.check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                         f"tiling {u} disagrees with the plain version")
                n = libs["full"].ff_fused_interaction_max_clusters(
                    batch, cs.T, cs.D, cs.H, u.sb, u.hc, u.ss, u.cl)
                line.append(f"sb={sb} hc={hc} ss={u.ss} "
                            f"({u.grid[0] * u.grid[1] // u.cl} clusters, "
                            f"{n} resident) {timed():.2f}")
            finally:
                im.interaction_tiles = chosen
        print(f"probe B={batch} other tilings us: " + ", ".join(line))

    user = torch.randn(cs.T * cs.ROWS, 8, device=dev, generator=gen)
    for n, d, what in cs.BAG_SHAPES:
        tab = table if d == cs.D else user
        args = [(torch.randint(0, cs.ROWS, (n, 1), device=dev, generator=gen)
                 + (s % cs.T) * cs.ROWS,) for s in range(cs.ID_SETS)]
        line = []
        for name, _ in bags:
            build._libs["embedding_bag"] = libs[f"bag {name}"]
            got = bm.embedding_bag(tab, args[0][0])
            cs.check(torch.equal(got, tab[args[0][0][:, 0]]),
                     f"bag {name} disagrees with the rows it gathers")
            ms = cs.time_ms(lambda i: bm.embedding_bag(tab, i), args)[0]
            line.append(f"{name} {1e3 * ms:.2f}")
        print(f"probe bag n={n} d={d} ({what}) us: " + ", ".join(line))


if __name__ == "__main__":
    main()
