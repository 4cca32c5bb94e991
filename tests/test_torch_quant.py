"""The port's quantized storage and quantized kernels' plain versions
against the JAX package.

- The codec: codes and scales equal ``quantize_rows_np``'s bit for bit,
  int8 and fp8, on zero rows and on .5 ties; dequantized rows equal
  ``fake_quant_np``'s; ``encode_q``/``decode_q`` carry the same bytes.
- ``QuantTable``: ``set_rows`` writes what the JAX table writes and
  leaves neighbouring rows untouched.
- ``embedding_bag_quant`` on the CPU (its plain version) against the JAX
  ``embedding_bag_quant`` in interpret mode and its oracle: bitwise for
  sum at bag 1, else atol 1e-5, the tolerance of tests/test_quant.py
  (the bag sums in another fp32 order).
- ``fused_interaction_quant`` likewise, within rtol 1e-5, atol 1e-3, the
  tolerance of tests/test_interaction_kernel.py (the dots and the
  layer's products sum in other fp32 orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlrm_flexflow_tpu.ops.pallas.embedding_kernel import (
    embedding_bag_quant as jax_bag_quant,
    embedding_bag_quant_reference as jax_bag_quant_ref)
from dlrm_flexflow_tpu.ops.pallas.interaction_kernel import (
    fused_interaction_quant as jax_inter_quant,
    fused_interaction_quant_reference as jax_inter_quant_ref, tril_pairs)
from dlrm_flexflow_tpu.quant.codec import (encode_q as np_encode_q,
                                           fake_quant_np, quantize_rows_np)
from dlrm_flexflow_tpu.quant.store import QuantTable as JaxQuantTable

from dlrm_flexflow_tpu_torch.ops.kernels.embedding_bag import (
    embedding_bag_quant, embedding_bag_quant_reference)
from dlrm_flexflow_tpu_torch.ops.kernels.interaction import (
    fused_interaction_quant, fused_interaction_quant_reference)
from dlrm_flexflow_tpu_torch.quant import (QuantTable, decode_q,
                                           dequantize_rows, encode_q,
                                           quantize_rows, validate_scales)

DTYPES = ["int8", "fp8"]


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a tensor (fp8 included) as uint8."""
    return t.contiguous().view(torch.uint8).numpy()


def _rows(seed=0, n=512, d=64):
    """Random rows, an all-zero row, and a row whose scaled values land
    on .5 ties (amax 127 gives scale 1.0, so x/scale = x exactly)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n, d).astype(np.float32)
    a[3] = 0.0
    a[5] = (np.arange(d) - d / 2).astype(np.float32) + 0.5
    a[5, 0] = 127.0
    a[7] = -a[5]
    a[9, :] = 1e-30            # tiny: scale underflows toward denormals
    return a


class TestCodec:
    @pytest.mark.parametrize("dt", DTYPES)
    def test_codes_and_scales_bitwise(self, dt):
        a = _rows()
        q, s = quantize_rows_np(a, dt)
        tq, ts = quantize_rows(torch.from_numpy(a), dt)
        assert tq.dtype == (torch.int8 if dt == "int8"
                            else torch.float8_e4m3fn)
        np.testing.assert_array_equal(_bits(tq), q.view(np.uint8))
        np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                      s.view(np.uint32))
        assert float(ts[3]) == 0.0 and not _bits(tq[3]).any()
        # the .5 ties round half to even, as np.rint
        if dt == "int8":
            np.testing.assert_array_equal(tq[5].numpy(),
                                          np.rint(a[5]).astype(np.int8))

    @pytest.mark.parametrize("dt", DTYPES)
    def test_dequantized_rows_equal_fake_quant(self, dt):
        a = _rows(seed=1)
        tq, ts = quantize_rows(torch.from_numpy(a), dt)
        np.testing.assert_array_equal(
            dequantize_rows(tq, ts, dt).numpy().view(np.uint32),
            fake_quant_np(a, dt).view(np.uint32))

    @pytest.mark.parametrize("dt", DTYPES)
    def test_stacked_leading_axes(self, dt):
        a = _rows(seed=2, n=24).reshape(3, 8, 64)
        q, s = quantize_rows_np(a, dt)
        tq, ts = quantize_rows(torch.from_numpy(a), dt)
        assert tuple(ts.shape) == (3, 8)
        np.testing.assert_array_equal(_bits(tq), q.view(np.uint8))
        np.testing.assert_array_equal(ts.numpy(), s)

    @pytest.mark.parametrize("dt", DTYPES)
    def test_encode_decode_round_trip(self, dt):
        tq, _ = quantize_rows(torch.from_numpy(_rows(seed=3)), dt)
        raw = encode_q(tq, dt)
        q_np, _ = quantize_rows_np(_rows(seed=3), dt)
        np.testing.assert_array_equal(raw.numpy().view(np.uint8),
                                      np_encode_q(q_np, dt).view(np.uint8))
        back = decode_q(raw, dt)
        assert back.dtype == tq.dtype
        np.testing.assert_array_equal(_bits(back), _bits(tq))

    def test_bad_dtype_raises(self):
        with pytest.raises(ValueError, match="not a quantized dtype"):
            quantize_rows(torch.zeros(2, 4), "bf16")

    def test_validate_scales(self):
        validate_scales("k", torch.tensor([0.0, 0.5, 1.0]), bound=1.0)
        validate_scales("k", torch.tensor([]))
        with pytest.raises(ValueError, match="non-finite"):
            validate_scales("k", torch.tensor([1.0, float("nan")]))
        with pytest.raises(ValueError, match="negative"):
            validate_scales("k", torch.tensor([1.0, -0.5]))
        with pytest.raises(ValueError, match="bound"):
            validate_scales("k", torch.tensor([1.0, 2.0]), bound=1.0)


class TestQuantTable:
    @pytest.mark.parametrize("dt", DTYPES)
    def test_set_rows_matches_jax_and_spares_neighbours(self, dt):
        a = _rows(seed=4, n=64)
        mine = QuantTable.from_dense(torch.from_numpy(a), dt)
        ref = JaxQuantTable.from_dense(a, dt)
        before = mine.copy()
        rows = np.asarray([2, 17, 40])
        vals = np.random.RandomState(5).randn(3, 64).astype(np.float32) * 3
        mine.set_rows(torch.from_numpy(rows), torch.from_numpy(vals))
        ref.set_rows(rows, vals)
        np.testing.assert_array_equal(_bits(mine.q),
                                      np.asarray(ref.q).view(np.uint8))
        np.testing.assert_array_equal(mine.scales.numpy(), ref.scales)
        rest = np.setdiff1d(np.arange(64), rows)
        np.testing.assert_array_equal(_bits(mine.q[rest]),
                                      _bits(before.q[rest]))
        np.testing.assert_array_equal(mine.scales[rest].numpy(),
                                      before.scales[rest].numpy())
        # copy() owns its storage
        assert not torch.equal(before.scales[rows], mine.scales[rows])

    def test_reads_and_accounting(self):
        a = _rows(seed=6, n=32)
        t = QuantTable.from_dense(torch.from_numpy(a), "int8")
        ref = JaxQuantTable.from_dense(a, "int8")
        assert t.shape == (32, 64) and t.nbytes == ref.nbytes
        q, s = t.take(torch.tensor([4, 1]))
        np.testing.assert_array_equal(q.numpy(), ref.q[[4, 1]])
        np.testing.assert_array_equal(s.numpy(), ref.scales[[4, 1]])
        np.testing.assert_array_equal(t.dense_rows([4, 1]).numpy(),
                                      ref.dense_rows(np.asarray([4, 1])))
        np.testing.assert_array_equal(t.to_dense().numpy(), ref.to_dense())
        back = QuantTable.from_encoded(t.encoded(), t.scales, "int8")
        assert torch.equal(back.q, t.q) and torch.equal(back.scales,
                                                        t.scales)


def _quant_table(dt, rows, d, seed):
    rng = np.random.RandomState(seed)
    q, s = quantize_rows_np(rng.randn(rows, d).astype(np.float32), dt)
    tq = torch.from_numpy(q.view(np.uint8).copy())
    if dt == "fp8":
        tq = tq.view(torch.float8_e4m3fn)
    else:
        tq = tq.view(torch.int8)
    return q, s, tq, torch.from_numpy(s)


class TestBagQuant:
    # the JAX kernel needs d % 128 == 0
    @pytest.mark.parametrize("dt,aggr,bag", [
        ("int8", "sum", 1), ("int8", "avg", 3), ("fp8", "sum", 1),
        ("fp8", "sum", 3)])
    def test_plain_matches_jax_kernel_and_oracle(self, dt, aggr, bag):
        q, s, tq, ts = _quant_table(dt, 64, 128, seed=0)
        idx = np.random.RandomState(1).randint(0, 64, (5, bag))
        want_k = np.asarray(jax_bag_quant(jnp.asarray(q), jnp.asarray(s),
                                          jnp.asarray(idx), aggr,
                                          interpret=True))
        want_r = np.asarray(jax_bag_quant_ref(jnp.asarray(q),
                                              jnp.asarray(s),
                                              jnp.asarray(idx), aggr))
        got = embedding_bag_quant(tq, ts, torch.from_numpy(idx), aggr)
        assert got.dtype == torch.float32 and got.shape == (5, 128)
        plain = embedding_bag_quant_reference(tq, ts, torch.from_numpy(idx),
                                              aggr)
        assert torch.equal(got, plain)     # the CPU takes the plain version
        if bag == 1 and aggr == "sum":
            np.testing.assert_array_equal(got.numpy(), want_k)
            np.testing.assert_array_equal(got.numpy(), want_r)
        else:
            np.testing.assert_allclose(got.numpy(), want_k, rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(got.numpy(), want_r, rtol=0,
                                       atol=1e-5)

    def test_rejects_bad_inputs(self):
        _, _, tq, ts = _quant_table("int8", 8, 16, seed=2)
        ids = torch.zeros(2, 1, dtype=torch.int64)
        with pytest.raises(ValueError, match="aggr"):
            embedding_bag_quant(tq, ts, ids, "max")
        with pytest.raises(ValueError, match="int8 or float8"):
            embedding_bag_quant(tq.float(), ts, ids)
        with pytest.raises(ValueError, match="scales"):
            embedding_bag_quant(tq, ts[:4], ids)


class TestInteractionQuant:
    T, ROWS, D, H, B = 3, 64, 128, 32, 5

    @pytest.mark.parametrize("dt,bag", [("int8", 1), ("fp8", 1),
                                        ("int8", 2)])
    def test_plain_matches_jax_kernel(self, dt, bag):
        T, ROWS, D, H, B = self.T, self.ROWS, self.D, self.H, self.B
        P = len(tril_pairs(T + 1))
        q, s, tq, ts = _quant_table(dt, T * ROWS, D, seed=3)
        rng = np.random.RandomState(4)
        idx = np.stack([rng.randint(t * ROWS, (t + 1) * ROWS, size=(B, bag))
                        for t in range(T)], axis=1).astype(np.int64)
        bottom = rng.randn(B, D).astype(np.float32)
        w = (rng.randn(D + P, H) * 0.1).astype(np.float32)
        bias = rng.randn(H).astype(np.float32)
        jargs = (jnp.asarray(q), jnp.asarray(s),
                 jnp.asarray(idx.astype(np.int32)), jnp.asarray(bottom),
                 jnp.asarray(w), jnp.asarray(bias))
        want_k = np.asarray(jax_inter_quant(*jargs, True, True))
        want_r = np.asarray(jax_inter_quant_ref(*jargs, relu=True))
        targs = (tq, ts, torch.from_numpy(idx), torch.from_numpy(bottom),
                 torch.from_numpy(w), torch.from_numpy(bias))
        got = fused_interaction_quant(*targs)
        assert got.shape == (B, H)
        assert torch.equal(got, fused_interaction_quant_reference(*targs))
        np.testing.assert_allclose(got.numpy(), want_k, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got.numpy(), want_r, rtol=1e-5, atol=1e-3)

    def test_rejects_bad_codes(self):
        _, _, tq, ts = _quant_table("int8", 16, 8, seed=5)
        P = len(tril_pairs(3))
        args = (torch.zeros(2, 2, dtype=torch.int64), torch.zeros(2, 8),
                torch.zeros(8 + P, 4), torch.zeros(4))
        with pytest.raises(ValueError, match="int8 or float8"):
            fused_interaction_quant(tq.float(), ts, *args)
        with pytest.raises(ValueError, match="bias"):
            fused_interaction_quant(tq, ts, *args[:3], torch.zeros(5))
