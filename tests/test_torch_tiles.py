"""The fused interaction kernel's tiles, chosen on the host.

``interaction_tiles`` (ops/kernels/interaction.py) picks the sample
tile, the column tile, the samples a thread keeps and the cluster from
B and H; the kernel maps its blocks and threads onto them as these
tests do. They check, on the CPU, that the blocks' tiles and the
threads inside them cover every (sample, column) of the output exactly
once, that every sample of a tile is gathered by exactly one block of
its cluster, that B >= 64 puts at least a block on each of the card's
132 SMs, and that a block's shared memory and threads stay within the
card's and the kernel's limits. The kernel itself is held to its plain
version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

from dlrm_flexflow_tpu_torch.ops.kernels import interaction as im


def _cover_once(starts, size, width):
    """Every index of [0, width) lies in exactly one [start, start+size)
    clipped to width."""
    hits = np.zeros(width + size, dtype=np.int64)
    for s in starts:
        hits[s:s + size] += 1
    return bool((hits[:width] == 1).all())


def _check(t, B, H):
    nx, ny = t.grid
    assert ny % t.cl == 0 and 1 <= t.cl <= im.CLUSTER_MAX
    # blocks: sample tiles along x, column tiles along y (past H: idle)
    assert _cover_once([x * t.sb for x in range(nx)], t.sb, B)
    assert _cover_once([y * t.hc for y in range(ny) if y * t.hc < H],
                       t.hc, H)
    # threads of a block: ss samples x 4 columns each
    assert t.sb % t.ss == 0 and t.hc % 4 == 0
    assert _cover_once(range(0, t.sb, t.ss), t.ss, t.sb)
    assert _cover_once(range(0, t.hc, 4), 4, t.hc)
    layer = (t.hc // 4) * (t.sb // t.ss)
    assert layer <= t.threads <= im.MAX_THREADS and t.threads % 32 == 0
    # the gather: block r of a cluster takes samples r, r + cl, ...
    owned = np.concatenate([np.arange(r, t.sb, t.cl) for r in range(t.cl)])
    assert np.array_equal(np.sort(owned), np.arange(t.sb))
    assert t.smem + im.STATIC_SMEM_BYTES <= im.MAX_SMEM_BYTES


@pytest.mark.parametrize("H", [16, 300, 1024])
def test_tiles_cover_every_output_once(H):
    for B in range(1, 4097):
        _check(im.interaction_tiles(B, H, 8, 64), B, H)


@pytest.mark.parametrize("H", [16, 300, 1024])
def test_tiles_fill_the_card_from_b64(H):
    for B in range(64, 4097):
        t = im.interaction_tiles(B, H, 8, 64)
        assert t.grid[0] * t.grid[1] >= 132, (B, H, t)


@pytest.mark.parametrize("B,H,T,d", [(2048, 1024, 26, 128), (37, 16, 3, 128),
                                     (5, 300, 8, 132), (1, 3000, 8, 64),
                                     (4096, 4096, 8, 64), (300, 17, 2, 4)])
def test_tiles_fit_other_shapes(B, H, T, d):
    _check(im.interaction_tiles(B, H, T, d), B, H)


def test_paths_batches_take_a_cluster_of_eight_column_tiles():
    """At the model's H = 1,024 a cluster spans all 8 column tiles of
    128, so a sample tile is gathered once."""
    for B, sb in ((16, 1), (64, 2), (256, 8), (2048, 64)):
        t = im.interaction_tiles(B, 1024, 8, 64)
        assert (t.sb, t.hc, t.cl, t.grid[1]) == (sb, 128, 8, 8), t


def test_smem_bytes_mirror_the_kernel_layout():
    # W tile 100 x 128, feat 64 x 100, X of 8 samples x 9 rows x 68
    assert im.interaction_smem_bytes(8, 64, 64, 128, 8) == \
        4 * (100 * 128 + 64 * 100 + 8 * 9 * 68)
    # K = 3 + 64 = 67 rounds to 68 rows; rows padded to an odd count of
    # float4s: feat 68 -> 68 (17), X 64 -> 68
    assert im.interaction_smem_bytes(2, 64, 4, 16, 1) == \
        4 * (68 * 16 + 4 * 68 + 4 * 3 * 68)


def test_too_wide_a_shape_raises():
    with pytest.raises(ValueError, match="shared memory"):
        im.interaction_tiles(16, 1024, 200, 512)
    with pytest.raises(ValueError):
        im.interaction_tiles(0, 1024, 8, 64)


def test_probe_cuts_apply_to_the_kernel_sources():
    """tools/kernel_probe.py cuts a copy of the interaction's source
    after each phase and swaps the bag's load and store instructions;
    its anchors must stay in the shipped sources."""
    import importlib.util
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "kernel_probe", repo / "tools" / "kernel_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    csrc = repo / "dlrm_flexflow_tpu_torch" / "csrc"
    text, cuts = probe.cuts_of_clustered(
        (csrc / "interaction.cu").read_text())
    assert [n for n, _ in cuts][-1] == "full"
    assert text.count("#if PROBE") == 3
    bag = (csrc / "embedding_bag.cu").read_text()
    variants = dict(probe.bag_variants(bag))
    assert set(variants) == {"as built", "cached loads",
                             "non-allocating loads", "streaming stores"}
    assert "no_allocate.v4" not in variants["cached loads"]
    assert variants["streaming stores"].count("__stcs") == 2
