"""The port's fused MBConv block (K4) and fuse_ir encoder against the JAX package.

The JAX side runs `_FusedMBConv` (bf16 operands) and `mbconv_block_pallas`
(fp32 operands) with interpret=True, as tests/test_pallas_mbconv.py does, at
its shapes (C 16 / E 64 / 8x8 and C 24 / E 144 / 16x16), with non-trivial
BatchNorm statistics so the folding is exercised. The same variables reach
the port through `weights.py`'s names; on the CPU it runs the plain version.

Tolerances:
* fp32 operands: 1e-5 absolute (outputs of size ~2.5-3.6; fp32 sums in
  another order, 4.8e-7 seen);
* bf16 operands: 1e-5 absolute as well. The operands are rounded at the
  same places on both sides, so on the CPU they differ by fp32 reordering
  alone (2.4e-7 to 4.8e-7 seen: no rounding flipped). The control, the port
  with fp32 operands held against the JAX bf16 output, must fail this limit;
  it differs by 3.9e-3 to 4.5e-3.
* the BN-folded weights: bit for bit, in fp32 and rounded to bf16.
* frames of any size (5x5, 7x3, 1x1, 32x32; C 16 / E 64 / R 4, weights
  N(0, 0.2)): TOL, except bf16 operands at 32x32. There the mean over 1,024
  pixels, summed in another order on each side, can flip the bf16 rounding
  of the SE input s, which moves the output far beyond TOL (with these
  inputs none flipped: 3e-8 to 1.2e-7 seen at every size), so that case is
  held by the card tests' rule: the smaller of 2e-4 x max|ref| and half the
  control, the port with fp32 operands against JAX's bf16 output (1.2e-3).
* bf16 x (the output then is bf16 too, on both sides): each element within
  one bf16 ulp of JAX's, since both round the same fp32 value, which
  differs by fp32 reordering alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri2speech_tpu.models.effnetv2 import EffNetV2Features as JaxFeatures
from mri2speech_tpu.models.effnetv2 import InvertedResidual as JaxInvertedResidual
from mri2speech_tpu.models.effnetv2 import StageSpec as JaxStageSpec
from mri2speech_tpu.models.effnetv2 import _FusedMBConv as JaxFusedMBConv
from mri2speech_tpu.ops import pallas_mbconv as jax_mbconv
from mri2speech_tpu_torch.models.effnetv2 import (
    EFFNETV2_B2_SPEC,
    EffNetV2Features,
    FusedMBConv,
    StageSpec,
)
from mri2speech_tpu_torch.ops import mbconv
from mri2speech_tpu_torch.weights import acoustic_state_dict_from_jax

torch.set_num_threads(1)

TOL = 1e-5


def _with_random_bn(variables, rng):
    """Random BN scale/bias/mean/var (var in [0.5, 1.5]) in a flax variables tree."""

    def fill(tree, path=()):
        if isinstance(tree, dict):
            return {k: fill(v, path + (k,)) for k, v in tree.items()}
        shape, name = np.shape(tree), path[-1]
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in ("mean", "bias") and path[-2].startswith("bn"):
            return (0.3 * rng.standard_normal(shape)).astype(np.float32)
        return np.asarray(tree)

    return {"params": fill(variables["params"]), "batch_stats": fill(variables["batch_stats"])}


def _port_state_dict(variables, prefix):
    """The port's names for a JAX tree under `cnn`, with `prefix` stripped."""
    sd = acoustic_state_dict_from_jax({"cnn": variables["params"]},
                                      {"cnn": variables["batch_stats"]})
    return {k[len(prefix):]: v for k, v in sd.items()}


@pytest.fixture(scope="module", params=[(16, 4, 8, 3), (24, 6, 16, 2)],
                ids=["C16-E64-8x8", "C24-E144-16x16"])
def block(request):
    C, expand, hw, N = request.param
    rng = np.random.default_rng(40 + C)
    x = (rng.standard_normal((N, hw, hw, C)) * 0.5).astype(np.float32)
    jax_block = JaxInvertedResidual(C, 3, 1, expand, 0.25)
    variables = _with_random_bn(jax_block.init(jax.random.PRNGKey(C), jnp.asarray(x), False), rng)
    port = FusedMBConv(C, expand, 0.25)
    port.load_state_dict(_port_state_dict({"params": {"s0_b0": variables["params"]},
                                           "batch_stats": {"s0_b0": variables["batch_stats"]}},
                                          "cnn.backbone.blocks.0.0."), strict=True)
    return x, variables, port.eval(), (C, expand)


def _jax_folded(variables, C, expand):
    """The folded params exactly as `_FusedMBConv` builds them (`effnetv2.py:257-271`)."""
    p, s = variables["params"], variables["batch_stats"]
    mid, red = C * expand, max(1, int(C * 0.25))

    def bn(name):
        return jax_mbconv.fold_bn(p[name]["scale"], p[name]["bias"], s[name]["mean"],
                                  s[name]["var"])

    (m1, a1), (m2, a2), (m3, a3) = bn("bn1"), bn("bn2"), bn("bn3")
    return {
        "w1": p["conv_pw"]["kernel"].reshape(C, mid) * m1[None, :], "b1": a1,
        "wd": (p["conv_dw"]["kernel"].reshape(9, mid) * m2[None, :]).reshape(3, 3, mid),
        "bd": a2,
        "wr": p["se"]["reduce"]["kernel"].reshape(mid, red), "br": p["se"]["reduce"]["bias"],
        "we": p["se"]["expand"]["kernel"].reshape(red, mid), "be": p["se"]["expand"]["bias"],
        "w3": p["conv_pwl"]["kernel"].reshape(mid, C) * m3[None, :], "b3": a3,
    }


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def test_fused_block_matches_jax_fused_mbconv(block):
    """bf16 operands: the port's FusedMBConv against JAX `_FusedMBConv`."""
    x, variables, port, (C, expand) = block
    ref = np.asarray(JaxFusedMBConv(C, expand, 0.25).apply(variables, jnp.asarray(x), False))
    launches = mbconv.launches
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    # control: the same block with fp32 operands is told apart from the bf16 one
    f32 = mbconv.mbconv_block_pallas(torch.from_numpy(x), port.folded_weights(),
                                     mxu_dtype=torch.float32)
    assert np.abs(f32.numpy() - ref).max() > TOL
    assert mbconv.launches == launches  # CPU tensors never reach the kernel


def test_block_fp32_matches_jax_kernel(block):
    """fp32 operands: `mbconv_block_pallas` of both packages on the same folded params."""
    x, variables, _, (C, expand) = block
    params = {k: np.asarray(v) for k, v in _jax_folded(variables, C, expand).items()}
    ref = np.asarray(jax_mbconv.mbconv_block_pallas(jnp.asarray(x), params, interpret=True,
                                                    mxu_dtype=jnp.float32))
    got = mbconv.mbconv_block_pallas(torch.from_numpy(x), params, mxu_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    nchw = mbconv.mbconv_block_pallas(_nchw(x), params, mxu_dtype=torch.float32, layout="nchw")
    torch.testing.assert_close(nchw.permute(0, 2, 3, 1), got, atol=0, rtol=0)


def test_folded_weights_match_jax_bit_for_bit(block):
    _, variables, port, (C, expand) = block
    ref = {k: np.asarray(v) for k, v in _jax_folded(variables, C, expand).items()}
    ours = mbconv.MBConvWeights.from_block(port)
    from_jax = mbconv.MBConvWeights.from_jax(ref)
    for name in mbconv.NAMES:
        a, b = getattr(ours, name), getattr(from_jax, name)
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
        torch.testing.assert_close(a.to(torch.bfloat16), b.to(torch.bfloat16), atol=0, rtol=0,
                                   msg=name)
    bf16 = ours.operands(torch.bfloat16, "cpu")
    for name in mbconv.PRODUCT_WEIGHTS:
        assert bf16[name].dtype == torch.bfloat16
    assert bf16["wd"].dtype == torch.float32  # the depthwise taps stay fp32


def test_folded_weights_follow_every_change():
    """The folded copy is built once, and again after an in-place change or a replacement."""
    block = FusedMBConv(16, 4, 0.25).eval()
    first = block.folded_weights()
    assert block.folded_weights() is first  # nothing changed: the cached copy
    with torch.no_grad():
        block.bn1.running_var.mul_(2.0)  # in place
    second = block.folded_weights()
    assert second is not first and not torch.equal(second.w1, first.w1)
    sd = {k: v.clone() for k, v in block.state_dict().items()}
    sd["conv_pwl.weight"] = sd["conv_pwl.weight"] + 1.0
    block.load_state_dict(sd, assign=True)  # new tensor objects
    third = block.folded_weights()
    assert third is not second
    torch.testing.assert_close(third.w1, second.w1, atol=0, rtol=0)
    assert not torch.equal(third.w3, second.w3)


SPEC = (StageSpec("cn", 3, 1, 1, 8, 1), StageSpec("ir", 3, 2, 4, 16, 2, 0.25))


def test_features_fuse_ir_matches_jax():
    """EffNetV2Features(fuse_ir=True): b0 (stride 2) unfused, b1 through the block kernel."""
    jax_spec = tuple(JaxStageSpec(**vars(s)) for s in SPEC)
    rng = np.random.default_rng(45)
    x = (rng.standard_normal((2, 32, 32, 3)) * 0.5).astype(np.float32)
    jax_feats = JaxFeatures(spec=jax_spec, stem_channels=8, fuse_ir=True, pad_ir=False)
    variables = _with_random_bn(jax_feats.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    ref = np.asarray(jax_feats.apply(variables, jnp.asarray(x)))
    port = EffNetV2Features(SPEC, 8, fuse_ir=True)
    port.load_state_dict(_port_state_dict(variables, "cnn."), strict=True)
    port.eval()
    blocks = [b for stage in port.backbone.blocks for b in stage]
    assert [type(b).__name__ for b in blocks] == ["ConvBnAct", "InvertedResidual", "FusedMBConv"]
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    with pytest.raises(RuntimeError, match="inference transform"):
        port.train()(_nchw(x))


def test_b2_fuses_17_blocks():
    """As in the JAX package: every ir block with stride 1, cin == cout, k 3 and SE."""
    with torch.device("meta"):
        feats = EffNetV2Features(EFFNETV2_B2_SPEC, fuse_ir=True)
    names = [f"s{si}_b{bi}" for si, stage in enumerate(feats.backbone.blocks)
             for bi, b in enumerate(stage) if isinstance(b, FusedMBConv)]
    assert len(names) == 17
    assert names == ([f"s3_b{i}" for i in range(1, 4)] + [f"s4_b{i}" for i in range(1, 6)]
                     + [f"s5_b{i}" for i in range(1, 10)])
    with torch.device("meta"):
        plain = EffNetV2Features(EFFNETV2_B2_SPEC)
    assert sorted(plain.state_dict()) == sorted(feats.state_dict())


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |v| (8 significant bits; the smallest normal's ulp at 0)."""
    a = np.maximum(np.abs(v.astype(np.float64)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def test_bf16_input_matches_jax(block):
    """bf16 x: computed in fp32, returned in bf16, as `pallas_mbconv.py:67, 113, 185`."""
    x, variables, port, (C, expand) = block
    params = {k: np.asarray(v) for k, v in _jax_folded(variables, C, expand).items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = jax_mbconv.mbconv_block_pallas(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                                         params, interpret=True)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    got = mbconv.mbconv_block_pallas(xb, port.folded_weights())
    assert got.dtype == torch.bfloat16 and got.shape == xb.shape
    diff = np.abs(got.float().numpy() - ref)
    assert (diff <= _bf16_ulp(ref)).all(), diff.max()
    nchw = mbconv.mbconv_block_pallas(_nchw(xb.float().numpy()).to(torch.bfloat16),
                                      port.folded_weights(), layout="nchw")
    assert nchw.dtype == torch.bfloat16
    torch.testing.assert_close(nchw.permute(0, 2, 3, 1), got, atol=0, rtol=0)


def _random_folded(C, E, R, rng, scale=0.2):
    shapes = {"w1": (C, E), "b1": (E,), "wd": (3, 3, E), "bd": (E,), "wr": (E, R), "br": (R,),
              "we": (R, E), "be": (E,), "w3": (E, C), "b3": (C,)}
    return {k: (rng.standard_normal(v) * scale).astype(np.float32) for k, v in shapes.items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,W", [(5, 5), (7, 3), (1, 1), (32, 32)])
def test_any_frame_size_matches_jax_kernel(H, W, dtype):
    """Frames the card kernel once refused (H*W not a multiple of 32, or above 256)."""
    rng = np.random.default_rng(0)
    params = _random_folded(16, 64, 4, rng)
    x = (rng.standard_normal((2, H, W, 16)) * 0.5).astype(np.float32)
    ref = np.asarray(jax_mbconv.mbconv_block_pallas(jnp.asarray(x), params, interpret=True,
                                                    mxu_dtype=getattr(jnp, dtype)))
    got = mbconv.mbconv_block_pallas(torch.from_numpy(x), params,
                                     mxu_dtype=getattr(torch, dtype)).numpy()
    assert got.shape == ref.shape == x.shape
    err = np.abs(got - ref).max()
    tol = TOL
    if dtype == "bfloat16":
        f32 = mbconv.mbconv_block_pallas(torch.from_numpy(x), params,
                                         mxu_dtype=torch.float32).numpy()
        control = np.abs(f32 - ref).max()
        if H * W > 256:  # a flipped rounding of s is allowed, under the control rule
            tol = min(2e-4 * np.abs(ref).max(), 0.5 * control)
        assert control > tol  # the limit tells bf16 operands from fp32 ones
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("H,W", [(1, 1), (5, 5), (8, 8), (16, 16), (7, 3), (32, 32)])
@pytest.mark.parametrize("N", [1, 16, 256])
def test_tile_plan_covers_every_pixel_once(N, H, W):
    """Each pixel owned by exactly one tile; halos inside the frame; no empty tile; within
    the kernel's limits, for both launches that tile frames (1: pool, 3: project), at the
    B2 widths (s3, s4, s5) and a narrow block."""
    for C, E, R in ((16, 64, 4), (104, 416, 26), (120, 720, 30), (208, 1248, 52)):
        for dtype in mbconv.MXU_DTYPES:
            for pool in (False, True):
                plan = mbconv.tile_plan(N, H, W, C, E, R, dtype, pool=pool)
                owned = np.zeros((H, W), np.int64)
                rects = plan.rectangles()
                assert len(rects) == plan.tiles
                for (h0, w0, th, tw), (r0, c0, eh, ew) in rects:
                    assert th >= 1 and tw >= 1
                    owned[h0:h0 + th, w0:w0 + tw] += 1
                    assert 0 <= r0 and 0 <= c0 and r0 + eh <= H and c0 + ew <= W
                    assert (r0, c0) == (max(h0 - 1, 0), max(w0 - 1, 0))
                    assert (r0 + eh, c0 + ew) == (min(h0 + th + 1, H), min(w0 + tw + 1, W))
                    assert eh * ew <= mbconv.M_CAP
                    assert pool or th * tw <= mbconv.owned_cap(C)
                assert (owned == 1).all()
                assert 1 <= plan.e_splits <= (-(-E // mbconv.CHUNK[dtype]) if pool else 1)
                assert mbconv.smem_bytes(plan.th, plan.tw, H, W, C, E, R, dtype,
                                         not pool) <= mbconv.SMEM_LIMIT
