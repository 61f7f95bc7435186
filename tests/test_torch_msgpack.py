"""The port's pure-Python msgpack decoder (ha2g_torch/utils/msgpack.py)
against flax: trees written by ``flax.serialization.to_bytes`` and
``msgpack_serialize`` read equal to ``msgpack_restore``, chunked arrays
included; unknown extension types and truncated input raise."""

import msgpack
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_torch.utils.msgpack import unpackb


def _equal(got, want, path="") -> None:
    """Same structure, types and values; a JAX bfloat16 array is read as a
    torch.bfloat16 tensor with the same bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{path}[{i}]")
    elif getattr(want, "dtype", None) == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"dense": {"kernel": rng.normal(size=(3, 4))
                             .astype(np.float32),
                             "bias": np.zeros(4, np.float32)},
                   "levels": ({"w": np.arange(6, dtype=np.int32)
                               .reshape(2, 3)},
                              [np.float32(1.5), np.int64(-7)])},
        "scalars": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                    2 ** 63, -1, -32, -33, -128, -129, -32768, -32769,
                    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.5, -1e300, True,
                    False, None],
        "text": ["", "x" * 31, "y" * 32, "z" * 300, "é" * 40000],
        "zero_d": np.float32(3.25) * np.ones((), np.float32),
        "empty": np.zeros((0, 5), np.float64),
        "bf16": jnp.asarray(rng.normal(size=(2, 3)), jnp.bfloat16),
        "bf16_scalar": jnp.bfloat16(-2.5),
        "u8": np.arange(200, dtype=np.uint8),
        "big_map": {f"k{i}": i for i in range(20)},
    }


def test_flax_to_bytes_reads_equal_to_msgpack_restore():
    data = serialization.to_bytes(_tree())
    _equal(unpackb(data), serialization.msgpack_restore(data))


def test_msgpack_serialize_lists_and_bytes():
    """Without to_state_dict, lists stay msgpack arrays (read as lists),
    and bin stays bytes."""
    tree = {"a": [1, [2.5, {"b": np.ones(3, np.float32)}]],
            "raw": b"\x00\x01" * 40000, "long": list(range(70000))}
    data = serialization.msgpack_serialize(tree)
    _equal(unpackb(data), serialization.msgpack_restore(data))


def test_chunked_arrays_join(monkeypatch):
    """flax splits an array over MAX_CHUNK_SIZE bytes into flat chunks
    under a ``__msgpack_chunked_array__`` map; the reader joins them."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "nested": {"v": np.arange(50, dtype=np.int64),
                       "bf": jnp.asarray(rng.normal(size=(9, 11)),
                                         jnp.bfloat16)},
            "small": np.ones(3, np.float32)}
    data = serialization.to_bytes(tree)
    raw = msgpack.unpackb(data, raw=False)   # chunks really were written
    assert raw["w"]["__msgpack_chunked_array__"]
    assert len(raw["w"]["chunks"]) == 3
    got = unpackb(data)
    _equal(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["w"], tree["w"])


@pytest.mark.parametrize("code,size", [(2, 3), (5, 4), (127, 300)])
def test_an_unknown_ext_type_raises(code, size):
    """ext 8 / fixext 4 / ext 16 records of types flax does not write."""
    data = msgpack.packb({"x": msgpack.ExtType(code, b"\x01" * size)})
    with pytest.raises(ValueError, match=f"ext type {code}"):
        unpackb(data)


def test_truncated_or_trailing_input_raises():
    data = serialization.to_bytes({"w": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        unpackb(data[:-3])
    with pytest.raises(ValueError, match="after the object"):
        unpackb(data + b"\xc0")
