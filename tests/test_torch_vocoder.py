"""The port's HiFi-GAN generator against the JAX package's.

Same weights (numpy, seeded) in both packages. Tolerance: fp32 convs summed
in another order through ~40 layers; audio is tanh output of size <= 1, and
1e-5 absolute is about 100x the differences seen.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri2speech_tpu.config import default_vocoder_config as jax_default_config
from mri2speech_tpu.models.layers import fold_weight_norm as jax_fold
from mri2speech_tpu.models.vocoder import Generator as JaxGenerator
from mri2speech_tpu.models.vocoder import default_fuse_mode, fuse_mrf_params
from mri2speech_tpu.models.vocoder import generator_receptive_field as jax_rf
from mri2speech_tpu_torch.config import default_vocoder_config
from mri2speech_tpu_torch.models.vocoder import generator_receptive_field
from mri2speech_tpu_torch.weights import (
    fold_weight_norm,
    generator_from_jax,
    random_generator_params,
)

torch.set_num_threads(1)

ATOL = 1e-5


def _h(resblock="1"):
    over = dict(upsample_initial_channel=16)
    if resblock == "2":
        over.update(resblock="2", resblock_dilation_sizes=[[1, 3], [1, 3], [1, 3]])
    return dict(jax_default_config(**over))


def _mel(seed, T=9):
    return np.random.default_rng(seed).uniform(-6.0, 1.0, (1, 64, T)).astype(np.float32)


def _port(params, h, mel):
    with torch.no_grad():
        return generator_from_jax(params, h)(torch.from_numpy(mel)).numpy()


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_generator_matches_jax_weight_normed_and_folded(resblock):
    h = _h(resblock)
    params = random_generator_params(h, seed=3)
    mel = _mel(4)
    ref_wn = np.asarray(JaxGenerator(h=h).apply({"params": params}, mel))
    folded = jax_fold(params)
    ref_folded = np.asarray(
        JaxGenerator(h=h, use_weight_norm=False).apply({"params": folded}, mel)
    )
    assert ref_wn.shape == (1, 1, 9 * 420)
    for src in (params, folded):  # weight-normed in, or folded by the JAX package
        got = _port(src, h, mel)
        np.testing.assert_allclose(got, ref_wn, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, ref_folded, atol=ATOL, rtol=0)


def test_generator_matches_jax_serving_fuse_mode():
    """The JAX serving layout: default_fuse_mode (dense on the last stage) + polyphase."""
    h = _h()
    params = random_generator_params(h, seed=5)
    mode = default_fuse_mode(h)
    fused = fuse_mrf_params(jax_fold(params), h, mode=mode)
    gen = JaxGenerator(h=h, use_weight_norm=False, fuse_mrf=True, fuse_mode=mode)
    mel = _mel(6, T=13)
    ref = np.asarray(gen.apply({"params": fused}, mel))
    np.testing.assert_allclose(_port(params, h, mel), ref, atol=ATOL, rtol=0)


def test_fold_weight_norm_matches_jax():
    h = _h()
    params = random_generator_params(h, seed=7)
    ref = jax.tree_util.tree_leaves(jax_fold(params))
    got = jax.tree_util.tree_leaves(fold_weight_norm(params))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_receptive_field_and_config(resblock):
    h = _h(resblock)
    assert generator_receptive_field(h) == jax_rf(h)
    assert dict(default_vocoder_config()) == dict(jax_default_config())


def test_random_generator_params_match_jax_init_tree():
    h = _h()
    shapes = jax.eval_shape(
        JaxGenerator(h=h).init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 4))
    )["params"]
    ours = random_generator_params(h, seed=0)
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(ours)
    for s, a in zip(jax.tree_util.tree_leaves(shapes), jax.tree_util.tree_leaves(ours)):
        assert tuple(s.shape) == a.shape and a.dtype == np.float32
