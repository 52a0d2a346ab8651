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


# ---- the kernel's tiling (csrc/mrf_stage.cu), checked on the CPU ----

# (T, C) of the generator's four MRF stages: a 250-frame request (bucket 256) and a
# steady 48-frame online window
REQUEST_STAGES = ((2560, 256), (17920, 128), (53760, 64), (107520, 32))
ONLINE_STAGES = ((480, 256), (3360, 128), (10080, 64), (20160, 32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("T,C", REQUEST_STAGES + ONLINE_STAGES)
def test_tile_plan_fits_the_sm_and_fills_the_card(T, C, dtype):
    plan = mrf.tile_plan(1, T, C, KERNELS, DILS, dtype)
    assert plan.smem <= mrf.SMEM_LIMIT  # 227 KB
    assert plan.ctas >= mrf.SMS
    assert plan.chain == (C <= 64) and plan.np * plan.nw == mrf.padded_channels(C)
    assert plan.kernel_launches == (2 if plan.chain else len(DILS) + 1)
    spans = [(0, 6)] if plan.chain else [(0, 2), (2, 4), (4, 6)]
    for j, k in enumerate(KERNELS):
        for q0, q1 in spans:
            rows, n = mrf.branch_rows(k, DILS, q0, q1, plan.tm[j])
            assert rows <= plan.rows and max(n) <= mrf.NWG * mrf.tiles_a_warpgroup(plan.nw, C, dtype)
            # every conv's tiles cover its outputs and what the later convs reach back
            reach = [mrf._reach(q, k, DILS) for q in range(q0, q1)]
            for i, nq in enumerate(n):
                assert 64 * nq >= plan.tm[j] + sum(reach[i + 1:])
                assert 64 * nq + reach[i] <= rows
    tiles = plan.tiles(T)
    assert all(t[0][0] == 0 and t[-1][1] == T for t in tiles)
    assert plan.ctas == plan.np * sum(len(t) for t in tiles)


@pytest.mark.parametrize("kw,match", [
    (dict(dils=(1, 3, 7)), "receptive field"),
    (dict(kernels=(3, 5, 7, 9, 11)), "1 to 4 branches"),
    (dict(C=520), "C <= 512"),
    (dict(tile=100), "multiple of 64"),
    (dict(tile=4096), "cannot hold a time tile"),
])
def test_tile_plan_refuses_what_the_kernel_cannot_take(kw, match):
    args = dict(B=1, T=1000, C=64, kernels=KERNELS, dils=DILS)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        mrf.tile_plan(args["B"], args["T"], args["C"], args["kernels"], args["dils"],
                      torch.bfloat16, args.get("tile"))


def _unpack_tap_layout(flat, C, units, dtype):
    """Reads mrf.tap_layout back: [u][c][j] -> (C, C, k_j) torch conv weights, fp32.

    Tile (q, j, m, s) of Kp output x KS input channels at ((q * sum(k) + sum_{i<j} k_i
    + m) * Kp / KS + s) * Kp * kdim; bf16 in wgmma's core-matrix layout (element (r, c)
    at (r // 8) * 8 KS + (c // 8) * 64 + (r % 8) * 8 + c % 8), fp32 rows KS + 4 apart;
    tap m is the torch weight's index k - 1 - m."""
    Kp = mrf.padded_channels(C)
    KS = mrf.k_slice(Kp, dtype)
    NS = Kp // KS
    t = flat.float().reshape(-1, NS, Kp * (KS if dtype == torch.bfloat16 else KS + 4))
    if dtype == torch.bfloat16:
        r, c = np.meshgrid(np.arange(Kp), np.arange(KS), indexing="ij")
        pos = (r // 8) * (8 * KS) + (c // 8) * 64 + (r % 8) * 8 + c % 8
        t = t[:, :, torch.from_numpy(pos.reshape(-1))].reshape(-1, NS, Kp, KS)
    else:
        t = t.reshape(-1, NS, Kp, KS + 4)[..., :KS]
    taps = t.permute(0, 2, 1, 3).reshape(-1, Kp, Kp)  # (tap, co, ci)
    out, i = [], 0
    for _ in range(units):
        per_u = []
        for _ in range(2):
            per_c = []
            for k in KERNELS:
                per_c.append(taps[i:i + k, :C, :C].permute(1, 2, 0).flip(-1))
                i += k
            per_u.append(per_c)
        out.append(per_u)
    assert i == taps.shape[0]
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("channels", [8, 40, 96])
def test_tap_layout_round_trips_to_the_branch_taps(channels, dtype):
    """The ring's layout (core-matrix tiles for bf16, padded rows for fp32, zero past C)
    gives back every branch's taps exactly, rounded to the operand type."""
    w = mrf.MRFStageWeights.from_resblocks(
        _random_resblocks(np.random.default_rng(channels), channels), KERNELS, DILS)
    flat = mrf.tap_layout(w, dtype)
    Kp = mrf.padded_channels(channels)
    KS = mrf.k_slice(Kp, dtype)
    kdim = KS if dtype == torch.bfloat16 else KS + 4
    assert flat.dtype == dtype and flat.numel() == 2 * len(DILS) * sum(KERNELS) * Kp * Kp * kdim // KS
    back = _unpack_tap_layout(flat, channels, len(DILS), dtype)
    for u in range(len(DILS)):
        for c in range(2):
            for j in range(len(KERNELS)):
                torch.testing.assert_close(back[u][c][j], w.weights[u][c][j].to(dtype).float(),
                                           atol=0, rtol=0)
    # what the kernel reads past C is zero: the layout holds the taps and nothing else
    assert int(flat.count_nonzero()) == sum(
        int(w.weights[u][c][j].to(dtype).count_nonzero())
        for u in range(len(DILS)) for c in range(2) for j in range(len(KERNELS)))


def _branch(w, j, units):
    """One branch of a stage (and of the given units) as weights of its own."""
    return mrf.MRFStageWeights(
        [[[w.weights[u][c][j]] for c in range(2)] for u in units],
        [[[w.biases[u][c][j]] for c in range(2)] for u in units],
        (w.kernels[j],), tuple(w.dils[u] for u in units))


def _stitched(xs, w, plan, dtype):
    """The plain version run tile by tile as the plan cuts the stage: each tile with its
    halo (the buffer rows before it, cut at t = 0, where the plain version's own zero
    padding stands for the kernel's), the tiles' rows stitched; unit mode one unit at a
    time, as the kernel's launches."""
    T = xs[0].shape[-1]
    nu = len(w.dils)
    spans = [range(nu)] if plan.chain else [range(u, u + 1) for u in range(nu)]
    acc = None
    for j, k in enumerate(w.kernels):
        cur = xs[j].float()
        for units in spans:
            bw = _branch(w, j, units)
            q0, q1 = 2 * units[0], 2 * units[-1] + 2
            rows, _ = mrf.branch_rows(k, w.dils, q0, q1, plan.tm[j])
            out = torch.empty_like(cur)
            for t0, t1 in plan.tiles(T)[j]:
                lo = max(0, t0 + plan.tm[j] - rows)
                out[..., t0:t1] = mrf.mrf_stage_reference(cur[..., lo:t1], bw, dtype)[..., t0 - lo:]
            cur = out
        acc = cur if acc is None else acc + cur
    return acc * (1.0 / len(w.kernels))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("entry,C,T,tile", [
    ("v2", 8, 7, 64), ("v1", 8, 119, 64), ("v2", 8, 121, 64), ("v1", 8, 300, 64),
    ("v2", 8, 300, 128), ("v1", 72, 130, 64), ("v2", 72, 50, 64),
])
def test_tile_by_tile_plain_version_is_the_whole_sequence(entry, C, T, tile, dtype):
    """The halo arithmetic: each tile of the plan with its halo gives the whole-sequence
    plain version bit for bit, in both operand types, and with fp32 operands JAX's
    kernel (interpret mode) within TOL. T below the receptive field (120), T that cuts
    through a halo; chain mode (C=8) and unit mode (C=72: Kp=128, one launch a unit).
    oneDNN is off for the conv1d's here: its result for a time step may depend on the
    length of the sequence it is part of (the native convolution's does not). JAX is
    held with fp32 operands only: with bf16 ones a sum taken in another order may flip
    a rounding of the operand (2^-8 relative), which then travels through the later
    convs (6.8e-4 at C=72 here), as the card tests' bf16 limits say."""
    rb = _random_resblocks(np.random.default_rng(40 + C), C)
    w = mrf.MRFStageWeights.from_resblocks(rb, KERNELS, DILS)
    dt = getattr(torch, dtype)
    plan = mrf.tile_plan(2, T, C, KERNELS, DILS, dt, tile)
    assert plan.chain == (C <= 64) and set(plan.tm) == {tile}
    rng = np.random.default_rng(41)
    width = 3 * C if entry == "v1" else C
    x = (rng.standard_normal((2, T, width)) * 0.5).astype(np.float32)
    xt = torch.from_numpy(x).transpose(1, 2)
    xs = [xt[:, j * C:(j + 1) * C] for j in range(3)] if entry == "v1" else [xt] * 3
    with torch.backends.mkldnn.flags(enabled=False):
        whole = mrf.mrf_stage_reference(xs, w, dt)
        tiled = _stitched(xs, w, plan, dt)
    torch.testing.assert_close(tiled, whole, atol=0, rtol=0)
    if dtype == "bfloat16":
        return
    packed = jax_mrf.pack_mrf_stage_params(rb, KERNELS, DILS)
    kw = dict(channels=C, kernels=KERNELS, dils=DILS, interpret=True,
              mxu_dtype=getattr(jnp, dtype))
    if entry == "v1":
        ref = jax_mrf.mrf_stage_pallas(jnp.asarray(x), packed, **kw)
    else:
        ref = jax_mrf.mrf_stage_pallas_v2(jnp.asarray(x), packed, **kw)
    np.testing.assert_allclose(tiled.transpose(1, 2).numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_v2_takes_the_jax_tile_keyword(resblocks):
    """`tile=` as the JAX function takes it: the kernel's time tile on the card, no effect
    on the result; a tile the kernel cannot hold raises."""
    packed = jax_mrf.pack_mrf_stage_params(resblocks, KERNELS, DILS)
    x = torch.from_numpy((np.random.default_rng(42).standard_normal((2, 300, C)) * 0.5)
                         .astype(np.float32))
    kw = dict(channels=C, kernels=KERNELS, dils=DILS, mxu_dtype=torch.bfloat16)
    want = mrf.mrf_stage_pallas_v2(x, packed, **kw)
    for tile in (128, 256):
        torch.testing.assert_close(mrf.mrf_stage_pallas_v2(x, packed, tile=tile, **kw), want,
                                   atol=0, rtol=0)
    ref = jax_mrf.mrf_stage_pallas_v2(jnp.asarray(x.numpy()), packed, interpret=True, tile=128,
                                      channels=C, kernels=KERNELS, dils=DILS,
                                      mxu_dtype=jnp.float32)
    got = mrf.mrf_stage_pallas_v2(x, packed, tile=128, **dict(kw, mxu_dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    for tile in (100, 4096):
        with pytest.raises(ValueError, match="tile"):
            mrf.mrf_stage_pallas_v2(x, packed, tile=tile, **kw)
