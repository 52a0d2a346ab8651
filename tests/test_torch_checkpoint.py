"""The port's flax-msgpack checkpoint IO against flax's own reader and writer."""
import numpy as np
import pytest
from flax import serialization

from mri2speech_tpu.train import checkpoint as jax_ckpt
from mri2speech_tpu_torch.train import checkpoint as port_ckpt


def _tree():
    rng = np.random.default_rng(31)
    return {
        "params": {
            "conv": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32)},
            "head": {"bias": np.arange(5, dtype=np.float64)},
        },
        "step": np.int64(42),
        "mask": np.array([[True, False]]),
        "ids": np.arange(6, dtype=np.int32).reshape(2, 3),
        "epoch": 3,
        "name": "g_00000001",
    }


def _assert_same(a, b):
    assert type(a) is dict and set(a) == set(b), (a, b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k])
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), (k, a[k], b[k])


def test_reader_matches_flax_writer(tmp_path):
    path = tmp_path / "ckpt"
    jax_ckpt.save_checkpoint(str(path), _tree())
    _assert_same(port_ckpt.load_checkpoint_raw(str(path)), jax_ckpt.load_checkpoint_raw(str(path)))


def test_writer_matches_flax_reader(tmp_path):
    path = tmp_path / "ckpt"
    port_ckpt.save_checkpoint(str(path), _tree())
    restored = serialization.msgpack_restore(path.read_bytes())
    _assert_same(restored, port_ckpt.load_checkpoint_raw(str(path)))
    _assert_same(restored, jax_ckpt.load_checkpoint_raw(str(path)))
    assert path.read_bytes() == serialization.msgpack_serialize(_tree())


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        port_ckpt.load_checkpoint_raw(str(tmp_path / "nope"))
