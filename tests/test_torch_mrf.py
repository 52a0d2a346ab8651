"""The port's MRF stage (K3, both entry points) against the JAX package's Pallas kernels.

The JAX side runs `mrf_stage_pallas` (v1, branch-tiled input) and
`mrf_stage_pallas_v2` (v2, compact input) with interpret=True, as
tests/test_pallas_mrf.py does; v2 at T=300 runs with tile=128, so its halo
path crosses three tiles. Same numpy inputs and packed weights on both sides;
the port unpacks the packing (on the CPU it runs the plain version).

Tolerances:
* mxu_dtype=float32: 1e-5 absolute on outputs of size ~1-2 (fp32 sums in
  another order; 1.2e-7 to 2.4e-7 seen);
* mxu_dtype=bfloat16: 1e-5 absolute as well. Both sides round the same
  activations to bf16 before each product, at the same places, so on the
  CPU they differ by fp32 reordering alone (1.2e-7 seen: no rounding
  flipped). The control, the port with fp32 operands held against the JAX
  bf16 output, must fail this limit; it differs by 4.7e-4 to 5.4e-4.
* bf16 x (the output then is bf16 on both sides): each element within one
  bf16 ulp of JAX's, since both round the same fp32 stage output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri2speech_tpu.config import default_vocoder_config as jax_default_config
from mri2speech_tpu.models.vocoder import fuse_mrf_params
from mri2speech_tpu.ops import pallas_mrf as jax_mrf
from mri2speech_tpu_torch.models.vocoder import FUSED_MODE, Generator
from mri2speech_tpu_torch.ops import mrf
from mri2speech_tpu_torch.weights import (
    fold_weight_norm,
    generator_from_jax,
    generator_state_dict_from_jax,
    random_generator_params,
)

torch.set_num_threads(1)

KERNELS = (3, 7, 11)
DILS = (1, 3, 5)
C = 8
B = 2
TOL = 1e-5


def _random_resblocks(rng, channels):
    """Per-branch ResBlock1 params in the JAX layout, N(0, 0.05) as in test_pallas_mrf.py."""
    blocks = []
    for k in KERNELS:
        blk = {}
        for u in range(len(DILS)):
            for name in (f"convs1_{u}", f"convs2_{u}"):
                blk[name] = {
                    "w": (rng.standard_normal((k, channels, channels)) * 0.05).astype(np.float32),
                    "b": (rng.standard_normal(channels) * 0.05).astype(np.float32),
                }
        blocks.append(blk)
    return blocks


@pytest.fixture(scope="module")
def resblocks():
    return _random_resblocks(np.random.default_rng(31), C)


@pytest.mark.parametrize(
    "entry,dtype,T",
    [("v1", "bfloat16", 300), ("v1", "float32", 64), ("v2", "bfloat16", 64),
     ("v2", "float32", 300)],
)
def test_stage_matches_jax_pallas(resblocks, entry, dtype, T):
    packed = jax_mrf.pack_mrf_stage_params(resblocks, KERNELS, DILS)
    rng = np.random.default_rng(32)
    width = 3 * C if entry == "v1" else C  # v1: three different branch inputs
    x = (rng.standard_normal((B, T, width)) * 0.5).astype(np.float32)
    kw = dict(channels=C, kernels=KERNELS, dils=DILS)
    if entry == "v1":
        ref = jax_mrf.mrf_stage_pallas(jnp.asarray(x), packed, interpret=True,
                                       mxu_dtype=getattr(jnp, dtype), **kw)
        port_fn = mrf.mrf_stage_pallas
    else:
        ref = jax_mrf.mrf_stage_pallas_v2(jnp.asarray(x), packed, interpret=True,
                                          mxu_dtype=getattr(jnp, dtype),
                                          tile=128 if T > 128 else None, **kw)
        port_fn = mrf.mrf_stage_pallas_v2
    ref = np.asarray(ref)
    launches = dict(mrf.launches)
    got = port_fn(torch.from_numpy(x), packed, mxu_dtype=getattr(torch, dtype), **kw)
    assert got.shape == ref.shape == (B, T, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    # the generator's (B, C, T) layout gives the same numbers
    bct = port_fn(torch.from_numpy(x).transpose(1, 2).contiguous(), packed,
                  mxu_dtype=getattr(torch, dtype), layout="bct", **kw)
    torch.testing.assert_close(bct.transpose(1, 2), got, atol=0, rtol=0)
    if dtype == "bfloat16":  # control: fp32 operands are told apart from bf16 ones
        f32 = port_fn(torch.from_numpy(x), packed, mxu_dtype=torch.float32, **kw)
        assert np.abs(f32.numpy() - ref).max() > TOL
    assert mrf.launches == launches  # CPU tensors never reach the kernel


@pytest.mark.parametrize("entry", ["v1", "v2"])
def test_bf16_input_matches_jax(resblocks, entry):
    """bf16 x: computed in fp32, returned in bf16, as `pallas_mrf.py:273, 337, 374, 421`."""
    packed = jax_mrf.pack_mrf_stage_params(resblocks, KERNELS, DILS)
    width = 3 * C if entry == "v1" else C
    x = torch.from_numpy((np.random.default_rng(33).standard_normal((1, 40, width)) * 0.5)
                         .astype(np.float32)).to(torch.bfloat16)
    kw = dict(channels=C, kernels=KERNELS, dils=DILS)
    jax_fn = jax_mrf.mrf_stage_pallas if entry == "v1" else jax_mrf.mrf_stage_pallas_v2
    ref = jax_fn(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), packed, interpret=True,
                 **kw)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    port_fn = mrf.mrf_stage_pallas if entry == "v1" else mrf.mrf_stage_pallas_v2
    got = port_fn(x, packed, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 40, C)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), np.finfo(np.float32).tiny))) - 7)
    diff = np.abs(got.float().numpy() - ref)
    assert (diff <= ulp).all(), diff.max()
    bct = port_fn(x.transpose(1, 2).contiguous(), packed, layout="bct", **kw)
    assert bct.dtype == torch.bfloat16
    torch.testing.assert_close(bct.transpose(1, 2), got, atol=0, rtol=0)


def test_pack_matches_jax_and_unpack_inverts_it(resblocks):
    ours = mrf.pack_mrf_stage_params(resblocks, KERNELS, DILS)
    ref = jax_mrf.pack_mrf_stage_params(resblocks, KERNELS, DILS)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]))
    back = mrf.unpack_mrf_stage_params(ref, KERNELS, DILS)
    for j in range(len(KERNELS)):
        assert sorted(back[j]) == sorted(resblocks[j])
        for name, p in resblocks[j].items():
            np.testing.assert_array_equal(back[j][name]["w"], p["w"])
            np.testing.assert_array_equal(back[j][name]["b"], p["b"])
    assert mrf.stage_receptive_field(KERNELS, DILS) == jax_mrf.stage_receptive_field(
        KERNELS, DILS) == 120


@pytest.mark.parametrize("where", ["off-diagonal block", "tap past k_j"])
def test_unpack_refuses_a_packing_of_coupled_branches(resblocks, where):
    packed = mrf.pack_mrf_stage_params(resblocks, KERNELS, DILS)
    w = packed["u1_c2_w"]
    if where == "off-diagonal block":
        w[0, 0, C] = 1e-3  # branch 0's input feeding branch 1's output
    else:
        w[5, 2, 2] = 1e-3  # tap 5 of branch 0, whose kernel has 3 taps
    with pytest.raises(ValueError, match="u1_c2"):
        mrf.unpack_mrf_stage_params(packed, KERNELS, DILS)


def _h():
    return dict(jax_default_config(upsample_initial_channel=16))


def test_fused_generator_loads_the_jax_fused_tree_strictly():
    """The "pallas" tree unpacks to the same state_dict as the unfused tree."""
    h = _h()
    params = random_generator_params(h, seed=33)
    fused_tree = fuse_mrf_params(fold_weight_norm(params), h, mode=FUSED_MODE)
    assert all(f"mrf_{i}" in fused_tree for i in range(4))
    sd_fused = generator_state_dict_from_jax(fused_tree, h)
    sd_plain = generator_state_dict_from_jax(params)
    assert sorted(sd_fused) == sorted(sd_plain)
    for k in sd_plain:
        torch.testing.assert_close(sd_fused[k], sd_plain[k], atol=0, rtol=0)
    gen = generator_from_jax(fused_tree, h, fuse_mode=FUSED_MODE)
    assert gen.fuse_modes == FUSED_MODE
    with pytest.raises(ValueError, match="needs the config"):
        generator_state_dict_from_jax(fused_tree)
    dense_tree = fuse_mrf_params(fold_weight_norm(params), h, mode="dense")
    with pytest.raises(KeyError, match="only the Pallas MRF layout"):
        generator_state_dict_from_jax(dense_tree, h)


def test_fused_generator_follows_new_weights():
    """No stale kernel-layout copy: after load_state_dict the fused stages use the new taps."""
    h = _h()
    mel = torch.from_numpy(
        np.random.default_rng(34).uniform(-6.0, 1.0, (1, 64, 5)).astype(np.float32))
    a = generator_from_jax(random_generator_params(h, seed=35), h, fuse_mode=FUSED_MODE)
    b = generator_from_jax(random_generator_params(h, seed=36), h, fuse_mode=FUSED_MODE)
    with torch.no_grad():
        ya, yb = a(mel), b(mel)
        a.load_state_dict(b.state_dict())  # in place: copy_ into a's parameters
        torch.testing.assert_close(a(mel), yb, atol=0, rtol=0)
    assert not torch.equal(ya, yb)


def test_generator_fuse_mode_errors():
    h = _h()
    with pytest.raises(ValueError, match="4 entries"):
        Generator(h, fuse_mode=("pallas", "none"))
    with pytest.raises(ValueError, match="unknown fuse modes"):
        Generator(h, fuse_mode="pallas3")
    h2 = dict(h, resblock="2", resblock_dilation_sizes=[[1, 3]] * 3)
    with pytest.raises(ValueError, match="resblock '1'"):
        Generator(h2, fuse_mode=FUSED_MODE)
    gen = Generator(h, fuse_mode=FUSED_MODE).train()
    with pytest.raises(RuntimeError, match="inference transform"):
        gen(torch.zeros(1, 64, 3))
    x = torch.zeros(1, 5, C)
    with pytest.raises(TypeError, match="float32"):
        mrf.mrf_stage_pallas_v2(x.double(), mrf.pack_mrf_stage_params(
            _random_resblocks(np.random.default_rng(0), C), KERNELS, DILS), channels=C)
