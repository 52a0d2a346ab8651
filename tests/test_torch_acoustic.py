"""The port's acoustic model and weight carry-across against the JAX package.

Tolerance: fp32 through the conv stack, BatchNorm, BiLSTM and head with sums
in another order; 1e-4 absolute on outputs of size ~1 is about 50x the
differences seen.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri2speech_tpu.config import default_vocoder_config as jax_default_config
from mri2speech_tpu.models.acoustic import AcousticModel as JaxAcousticModel
from mri2speech_tpu.models.effnetv2 import StageSpec as JaxStageSpec
from mri2speech_tpu.models.vocoder import Generator as JaxGenerator
from mri2speech_tpu_torch.models.effnetv2 import StageSpec
from mri2speech_tpu_torch.weights import (
    acoustic_jax_shapes,
    acoustic_model_from_jax,
    generator_from_jax,
    generator_jax_shapes,
    random_acoustic_params,
)

torch.set_num_threads(1)

ATOL = 1e-4

# `TINY_SPEC` of tests/test_e2e_slice.py, one stage of each block kind
JAX_TINY_SPEC = (
    JaxStageSpec("cn", 3, 1, 1, 8, 1),
    JaxStageSpec("er", 3, 2, 2, 8, 1),
    JaxStageSpec("ir", 3, 2, 2, 16, 1, 0.25),
)
TINY_SPEC = tuple(StageSpec(**vars(s)) for s in JAX_TINY_SPEC)
TINY = dict(spec=TINY_SPEC, stem_channels=8, rnn_hidden=16, n_mels=64)


def _tiny_port(params, stats, impl):
    return acoustic_model_from_jax(
        params, stats, rnn_hidden=16, cnn_spec=TINY_SPEC, cnn_stem=8, lstm_impl=impl
    )


@pytest.mark.parametrize(
    "serving", [True, False], ids=["s2d-padir-pallas", "canonical-scan"]
)
def test_acoustic_matches_jax(serving):
    """JAX with stem_s2d/pad_ir/lstm_impl="pallas" on (serving) or off (scan)."""
    params, stats = random_acoustic_params(seed=11, **TINY)
    jm = JaxAcousticModel(
        n_mels=64, rnn_hidden=16, cnn_spec=JAX_TINY_SPEC, cnn_stem=8,
        lstm_impl="pallas" if serving else "scan", stem_s2d=serving, pad_ir=serving,
    )
    rng = np.random.default_rng(12)
    x = rng.random((2, 7, 1, 64, 62 if not serving else 64)).astype(np.float32)
    mask = np.ones((2, 7), np.float32)
    mask[1, 4:] = 0.0
    ref = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x, mask=mask))
    model = _tiny_port(params, stats, "kernel" if serving else "scan")
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        feats_ref = np.asarray(
            jm.apply({"params": params, "batch_stats": stats}, x,
                     method=JaxAcousticModel.cnn_features)
        )
        feats = model.cnn_features(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 7, 64)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)  # padded steps too
    np.testing.assert_allclose(feats, feats_ref, atol=ATOL, rtol=0)


def test_acoustic_split_methods_agree():
    params, stats = random_acoustic_params(seed=13, **TINY)
    model = _tiny_port(params, stats, "kernel")
    x = torch.from_numpy(np.random.default_rng(14).random((1, 5, 64, 64)).astype(np.float32))
    with torch.no_grad():
        full = model(x)
        pred, feats = model.forward_with_features(x)
        split = model.head_from_features(model.cnn_features(x), 1, 5)
    torch.testing.assert_close(pred, full, atol=0, rtol=0)
    torch.testing.assert_close(split, full, atol=0, rtol=0)
    assert feats.shape == (5, 8, 8, 16)  # stem /2, er /2, ir /2


def _ones_like_tree(tree):
    return jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32), tree)


def _as_shape_tree(tree):
    return jax.tree_util.tree_map(lambda s: tuple(s.shape), tree)


def test_full_width_acoustic_loads_strict_from_jax_shapes():
    """EfficientNetV2-B2 + BiLSTM(640): eval_shape shapes filled with ones, no JAX init."""
    shapes = jax.eval_shape(
        JaxAcousticModel().init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 1, 64, 64)),
    )
    model = acoustic_model_from_jax(
        _ones_like_tree(shapes["params"]), _ones_like_tree(shapes["batch_stats"])
    )
    assert model.cnn.out_channels == 208
    assert model.rnn.lstm.weight_hh_l0.shape == (2560, 640)
    p_ours, s_ours = acoustic_jax_shapes()
    assert p_ours == _as_shape_tree(shapes["params"])
    assert s_ours == _as_shape_tree(shapes["batch_stats"])
    sd = model.state_dict()
    # the 530 keys of timm's tf_efficientnetv2_b2 backbone (tests/test_timm_manifest.py)
    assert sum(1 for k in sd if k.startswith("cnn.backbone.")) == 530


def test_full_width_generator_loads_strict_from_jax_shapes():
    h = dict(jax_default_config())
    shapes = jax.eval_shape(
        JaxGenerator(h=h).init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 4))
    )["params"]
    assert generator_jax_shapes(h) == _as_shape_tree(shapes)
    gen = generator_from_jax(_ones_like_tree(shapes), h)
    assert gen.ups[0].weight.shape == (512, 256, 20)
    assert len(gen.resblocks) == 12
