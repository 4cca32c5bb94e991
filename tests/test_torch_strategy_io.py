"""The port's strategy files against the JAX package's.

Every bundled ``strategies/*.pb`` decodes to the same configs in both
packages, field by field; for the same map both write byte-identical
``.pb`` and ``.json`` files, the extension fields (row shards, hot
fraction, dedup exchange, quantized storage, overlap) included; and a
malformed or misplaced file fails with the same error (file, op and
reason) in both.
"""

import dataclasses
from pathlib import Path

import pytest

from dlrm_flexflow_tpu.parallel import strategy_io as jio
from dlrm_flexflow_tpu.parallel.pconfig import ParallelConfig as JaxPC

from dlrm_flexflow_tpu_torch.parallel import strategy_io as pio
from dlrm_flexflow_tpu_torch.parallel.pconfig import ParallelConfig

REPO = Path(__file__).resolve().parents[1]
PB_FILES = sorted(p.name for p in (REPO / "strategies").glob("*.pb"))


def _fields(strategies):
    return {k: dataclasses.asdict(v) for k, v in strategies.items()}


def _to_jax(strategies):
    return {k: JaxPC(**dataclasses.asdict(v)) for k, v in strategies.items()}


def test_every_bundled_file_is_there():
    assert len(PB_FILES) == 11


@pytest.mark.parametrize("name", PB_FILES)
def test_reads_every_bundled_pb_as_jax(name):
    path = str(REPO / "strategies" / name)
    got = pio.load_strategies(path)
    assert got and all(isinstance(v, ParallelConfig) for v in got.values())
    assert _fields(got) == _fields(jio.load_strategies(path))


@pytest.mark.parametrize("ext", [".pb", ".json"])
@pytest.mark.parametrize("name", PB_FILES)
def test_writes_byte_identical_files(name, ext, tmp_path):
    strategies = pio.load_strategies(str(REPO / "strategies" / name))
    pio.save_strategies(str(tmp_path / f"port{ext}"), strategies)
    jio.save_strategies(str(tmp_path / f"jax{ext}"), _to_jax(strategies))
    mine = (tmp_path / f"port{ext}").read_bytes()
    assert mine == (tmp_path / f"jax{ext}").read_bytes()
    if ext == ".pb":
        # and the same bytes as the bundled file
        assert mine == (REPO / "strategies" / name).read_bytes()
    back = pio.load_strategies(str(tmp_path / f"port{ext}"))
    assert _fields(back) == _fields(strategies)


EXTENDED = {
    "emb_stack": ParallelConfig((4, 1, 1), param_degree=4, hot_fraction=0.25,
                                exchange="dedup", quant_dtype="int8",
                                quant_update="stochastic_rounding",
                                overlap=True),
    "emb_0": ParallelConfig((1, 2), device_type="CPU", device_ids=(3,),
                            memory_types=("ZCM",)),
    "top_dense_0": ParallelConfig((2, 2), device_ids=(0, 1, 2, 3),
                                  memory_types=("FBM",) * 4),
}


@pytest.mark.parametrize("ext", [".pb", ".json"])
def test_extension_fields_round_trip_byte_identical(ext, tmp_path):
    pio.save_strategies(str(tmp_path / f"port{ext}"), EXTENDED)
    jio.save_strategies(str(tmp_path / f"jax{ext}"), _to_jax(EXTENDED))
    assert (tmp_path / f"port{ext}").read_bytes() == \
        (tmp_path / f"jax{ext}").read_bytes()
    assert _fields(pio.load_strategies(str(tmp_path / f"port{ext}"))) == \
        _fields(EXTENDED)


def _raises_alike(call_port, call_jax):
    with pytest.raises(ValueError) as port:
        call_port()
    with pytest.raises(ValueError) as jax_err:
        call_jax()
    assert type(port.value).__name__ == type(jax_err.value).__name__
    assert str(port.value) == str(jax_err.value)


@pytest.mark.parametrize("case", ["mesh", "unknown_op", "hot_no_rows",
                                  "truncated", "bad_dims"])
def test_refuses_what_jax_refuses(case, tmp_path):
    if case == "truncated":
        data = (REPO / "strategies" / "dlrm_strategy_8embs_8gpus.pb") \
            .read_bytes()[:-3]
        path = tmp_path / "cut.pb"
        path.write_bytes(data)
        _raises_alike(lambda: pio.load_strategies(str(path)),
                      lambda: jio.load_strategies(str(path)))
        return
    if case == "bad_dims":
        path = tmp_path / "bad.json"
        path.write_text('{"ops": [{"name": "x", "dims": [0, 1]}]}')
        _raises_alike(lambda: pio.load_strategies(str(path)),
                      lambda: jio.load_strategies(str(path)))
        return
    strategies = {
        "mesh": {"linear": ParallelConfig((8, 1))},
        "unknown_op": {"nope": ParallelConfig((2, 1))},
        "hot_no_rows": {"emb_stack": ParallelConfig((1, 1, 1))},
    }[case]
    kw = {"mesh": dict(num_devices=4),
          "unknown_op": dict(known_ops={"emb_stack"}),
          "hot_no_rows": {}}[case]
    path = str(tmp_path / "s.json")
    pio.save_strategies(path, strategies)
    if case == "hot_no_rows":
        text = Path(path).read_text().replace('"memory_types": []',
                                              '"memory_types": [], '
                                              '"hot_frac": 0.5')
        Path(path).write_text(text)
    _raises_alike(lambda: pio.load_strategies(path, **kw),
                  lambda: jio.load_strategies(path, **kw))
    with pytest.raises(pio.StrategyValidationError, match=path):
        pio.load_strategies(path, **kw)
