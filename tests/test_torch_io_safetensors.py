"""``io/hf.py::save_safetensors``, the port's writer of ``.safetensors``
files (counterpart of ``compactfusion_tpu/io/hf.py::save_safetensors``,
written by hand: the card's machine has no ``safetensors`` package): what
it writes reads back bit for bit through the JAX package's
``load_safetensors`` (the ``safetensors`` package) and through the port's
own reader."""

import ml_dtypes
import numpy as np
import pytest
import torch

from compactfusion_tpu.io import hf as jhf
from compactfusion_tpu_torch.io import hf as thf


def _state():
    rng = np.random.default_rng(0)
    return {
        "blocks.0.attn.weight": rng.standard_normal((7, 5)).astype(np.float32),
        "blocks.0.attn.bias": rng.standard_normal(5).astype(np.float64),
        "norm.weight": rng.standard_normal((3, 2, 4)).astype(np.float16),
        "codes": rng.integers(0, 255, (9,), dtype=np.uint8),
        "ids": rng.integers(-2**40, 2**40, (2, 3), dtype=np.int64),
        "small": rng.integers(-100, 100, (4,), dtype=np.int8),
        "mask": rng.standard_normal(6) > 0,
        "scalar": np.array(3.5, np.float32),
        "empty": np.zeros((0, 3), np.int32),
        "strided": rng.standard_normal((6, 4)).astype(np.float32)[::2, ::-1],
        "emb.bf16": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)).to(torch.bfloat16),
    }


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_port_file_reads_back_bit_for_bit_in_jax_and_the_port(tmp_path):
    state = _state()
    path = tmp_path / "model.safetensors"
    thf.save_safetensors(state, str(path))
    jax_read, port_read = jhf.load_safetensors(str(path)), thf.load_safetensors(str(path))
    assert set(jax_read) == set(port_read) == set(state)
    for name, want in state.items():
        got_j, got_t = jax_read[name], port_read[name]
        if isinstance(want, torch.Tensor):  # bf16: JAX reads bf16, the port exact fp32
            bits = want.view(torch.int16).numpy().view(np.uint16)
            assert got_j.dtype == ml_dtypes.bfloat16 and np.array_equal(_bits(got_j), bits), name
            assert np.array_equal(got_t, want.float().numpy()), name
            continue
        assert got_j.dtype == got_t.dtype == want.dtype and got_j.shape == got_t.shape == want.shape, name
        assert np.array_equal(got_j, want) and np.array_equal(got_t, want), name


def test_torch_tensors_and_shards(tmp_path):
    """CPU torch tensors are written as their numpy arrays; a directory of
    port-written shards reads as their union through both readers."""
    state = _state()
    names = sorted(state)
    thf.save_safetensors({n: state[n] for n in names[:5]}, str(tmp_path / "a.safetensors"))
    thf.save_safetensors({n: (torch.from_numpy(np.ascontiguousarray(state[n])) if isinstance(state[n], np.ndarray)
                              and state[n].dtype != np.float16 else state[n]) for n in names[5:]},
                         str(tmp_path / "b.safetensors"))
    for read in (jhf.load_safetensors(str(tmp_path)), thf.load_safetensors(str(tmp_path))):
        assert set(read) == set(state)
        assert np.array_equal(read["strided"], state["strided"]) and read["ids"].dtype == np.int64


def test_dtypes_the_format_does_not_hold_raise(tmp_path):
    with pytest.raises(ValueError, match="complex64"):
        thf.save_safetensors({"z": np.zeros(2, np.complex64)}, str(tmp_path / "z.safetensors"))
