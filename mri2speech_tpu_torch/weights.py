"""Carry JAX parameter trees (numpy) across into the port's state_dicts.

The names are the reference torch names that `tools/export_torch_checkpoint.py`
emits: timm `cnn.backbone.*` for the encoder, `rnn.lstm.*` for the BiLSTM,
`head.*`, and `conv_pre` / `ups.{i}` / `resblocks.{i}.convs1.{j}` /
`conv_post` for the generator. The transposes:

* conv kernels (k, in, out) -> (out, in, k); 2-D (kh, kw, in, out) -> (out, in, kh, kw)
* ConvTranspose (k, in, out) -> (in, out, k)
* flax Dense (in, out) -> Linear (out, in); LSTM (C, 4H) -> (4H, C)
* the fused LSTM bias goes to bias_ih, with bias_hh = 0 (nn.LSTM adds them)
* a fused MRF stage's packed taps (`mrf_{i}`) are unpacked to its branches

Also here: the weight-norm fold, and the JAX parameter shapes of both models
(the trees `Module.init` would give), so random weights can be made in the
JAX layout from a numpy seed without JAX.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mri2speech_tpu_torch.models.acoustic import AcousticModel
from mri2speech_tpu_torch.models.effnetv2 import (
    EFFNETV2_B2_SPEC,
    EFFNETV2_B2_STEM,
    StageSpec,
)
from mri2speech_tpu_torch.models.vocoder import Generator
from mri2speech_tpu_torch.ops.mrf import unpack_mrf_stage_params

_STAGE_RE = re.compile(r"s(\d+)_b(\d+)$")
_PACKED_RE = re.compile(r"u\d+_c\d+_[wb]$")  # a Pallas MRF stage's packed leaves


def _flatten(tree: Dict, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))  # msgpack arrays are read-only


# ---------------------------------------------------------------------------
# weight norm
# ---------------------------------------------------------------------------

def _wn_norm(v: np.ndarray, preserved_axis: int) -> np.ndarray:
    axes = tuple(a for a in range(v.ndim) if a != preserved_axis)
    return np.sqrt(np.sum(np.square(v), axis=axes, keepdims=True))


def fold_weight_norm(params):
    """Fold {v, g} weight-norm leaves into plain {w} (remove_weight_norm).

    ConvTranspose1d preserves axis 1 (torch dim 0 = in-channels), every other
    conv the last axis; they are told apart by the shape of g
    (`mri2speech_tpu/models/layers.py:382-385`).
    """
    if not isinstance(params, dict):
        return params
    if "v" in params and "g" in params:
        v = np.asarray(params["v"], np.float32)
        g = np.asarray(params["g"], np.float32)
        if g.ndim == 3 and g.shape[1] > 1 and g.shape[2] == 1:
            preserved = 1
        else:
            preserved = v.ndim - 1
        out = {k: val for k, val in params.items() if k not in ("v", "g")}
        out["w"] = g * v / _wn_norm(v, preserved)
        return out
    return {k: fold_weight_norm(val) for k, val in params.items()}


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------

def _unpack_fused_stages(params: Dict[str, Any], h: dict) -> Dict[str, Any]:
    """Replace the JAX fused tree's ``mrf_{i}`` stages (`fuse_mrf_params` in a
    "pallas"/"pallas2" mode) by the ``resblocks_*`` they were packed from."""
    kernels = list(h["resblock_kernel_sizes"])
    dils = tuple(h["resblock_dilation_sizes"][0])
    nb = len(kernels)
    out = {k: v for k, v in params.items() if not k.startswith("mrf_")}
    for name, stage in params.items():
        if not name.startswith("mrf_"):
            continue
        if not all(_PACKED_RE.match(k) for k in stage):
            raise KeyError(f"{name}: only the Pallas MRF layout (u{{u}}_c{{c}}_w/_b) is "
                           f"carried across, got {sorted(stage)}")
        i = int(name.split("_")[1])
        for j, blk in enumerate(unpack_mrf_stage_params(stage, kernels, dils)):
            out[f"resblocks_{i * nb + j}"] = blk
    return out


def generator_state_dict_from_jax(
    params: Dict[str, Any], h: Optional[dict] = None
) -> Dict[str, torch.Tensor]:
    """JAX Generator params (weight-normed {v, g, b} or folded {w, b}) -> state_dict.

    Weight norm is folded first: the port's Generator holds plain weights.
    The JAX fused tree of a "pallas"/"pallas2" stage (``mrf_{i}`` with
    ``u{u}_c{c}_w`` (k_max, 3C, 3C) and ``u{u}_c{c}_b`` (1, 3C)) is unpacked
    to its branches' ``resblocks.*``; that needs ``h``.
    """
    params = fold_weight_norm(params)
    if any(k.startswith("mrf_") for k in params):
        if h is None:
            raise ValueError("a fused generator tree (mrf_* stages) needs the config h")
        params = _unpack_fused_stages(params, h)
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params).items():
        scope, kind = path[:-1], path[-1]
        name = scope[0]
        if name in ("conv_pre", "conv_post"):
            key = name
        elif name.startswith("ups_"):
            key = f"ups.{int(name.split('_')[1])}"
        elif name.startswith("resblocks_"):
            conv_list, j = scope[1].rsplit("_", 1)
            key = f"resblocks.{int(name.split('_')[1])}.{conv_list}.{j}"
        else:
            raise KeyError(f"unrecognised generator param scope: {path}")
        if kind == "b":
            sd[f"{key}.bias"] = _tensor(v)
        elif kind == "w":
            perm = (1, 2, 0) if name.startswith("ups_") else (2, 1, 0)
            sd[f"{key}.weight"] = _tensor(v.transpose(perm))
        else:
            raise KeyError(f"unrecognised generator param: {path}")
    return sd


def generator_jax_shapes(h: dict) -> Dict[str, Any]:
    """Shapes of the JAX Generator's weight-normed params (unfused, as trained)."""
    n_mels = int(h.get("num_mels", 64))
    c0 = int(h["upsample_initial_channel"])

    def conv(k, cin, cout):
        return {"v": (k, cin, cout), "g": (1, 1, cout), "b": (cout,)}

    tree: Dict[str, Any] = {"conv_pre": {"w": (7, n_mels, c0), "b": (c0,)}}
    nk = len(h["resblock_kernel_sizes"])
    convs = ("convs1", "convs2") if str(h["resblock"]) == "1" else ("convs",)
    ch = c0
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        cin, ch = ch, c0 // (2 ** (i + 1))
        tree[f"ups_{i}"] = {"v": (k, cin, ch), "g": (1, cin, 1), "b": (ch,)}
        for j, (rk, rd) in enumerate(
            zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"])
        ):
            tree[f"resblocks_{i * nk + j}"] = {
                f"{c}_{u_}": conv(rk, ch, ch)
                for c in convs for u_ in range(len(rd))
            }
    tree["conv_post"] = conv(7, ch, 1)
    return tree


# ---------------------------------------------------------------------------
# acoustic model
# ---------------------------------------------------------------------------

_BN_NAMES = {"stem_bn": "bn1", "bn": "bn1", "bn1": "bn1", "bn2": "bn2", "bn3": "bn3"}
_CONV_NAMES = {
    "stem_conv": "conv_stem", "conv": "conv", "conv_exp": "conv_exp",
    "conv_pw": "conv_pw", "conv_dw": "conv_dw", "conv_pwl": "conv_pwl",
}


def _timm_prefix(scope: str) -> str:
    m = _STAGE_RE.match(scope)
    if m:
        return f"cnn.backbone.blocks.{m.group(1)}.{m.group(2)}"
    return "cnn.backbone"


def acoustic_state_dict_from_jax(
    params: Dict[str, Any], batch_stats: Dict[str, Any]
) -> Dict[str, torch.Tensor]:
    """JAX AcousticModel {params, batch_stats} -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}

    def conv2d(v):  # (kh, kw, in, out) -> (out, in, kh, kw)
        return _tensor(v.transpose(3, 2, 0, 1))

    for path, v in _flatten(params).items():
        top = path[0]
        if top == "cnn":
            scope = path[1]
            if scope in _CONV_NAMES and path[2:] == ("kernel",):
                sd[f"cnn.backbone.{_CONV_NAMES[scope]}.weight"] = conv2d(v)
                continue
            if scope in _BN_NAMES:
                t = f"cnn.backbone.{_BN_NAMES[scope]}"
                sd[f"{t}.weight" if path[2] == "scale" else f"{t}.bias"] = _tensor(v)
                continue
            pre, name = _timm_prefix(scope), path[2]
            if name in _CONV_NAMES and path[3:] == ("kernel",):
                sd[f"{pre}.{_CONV_NAMES[name]}.weight"] = conv2d(v)
            elif name in _BN_NAMES:
                t = f"{pre}.{_BN_NAMES[name]}"
                sd[f"{t}.weight" if path[3] == "scale" else f"{t}.bias"] = _tensor(v)
            elif name == "se":
                sub = "conv_reduce" if path[3] == "reduce" else "conv_expand"
                if path[4] == "kernel":
                    sd[f"{pre}.se.{sub}.weight"] = conv2d(v)
                else:
                    sd[f"{pre}.se.{sub}.bias"] = _tensor(v)
            else:
                raise KeyError(f"unrecognised cnn param: {path}")
        elif top == "rnn":
            name = path[1]
            sfx = {"fwd": "l0", "bwd": "l0_reverse"}[name.rsplit("_", 1)[-1]]
            if name.startswith("w_ih"):
                sd[f"rnn.lstm.weight_ih_{sfx}"] = _tensor(v.T)
            elif name.startswith("w_hh"):
                sd[f"rnn.lstm.weight_hh_{sfx}"] = _tensor(v.T)
            elif name.startswith("b_"):
                sd[f"rnn.lstm.bias_ih_{sfx}"] = _tensor(v)
                sd[f"rnn.lstm.bias_hh_{sfx}"] = torch.zeros(v.shape, dtype=torch.float32)
            else:
                raise KeyError(f"unrecognised rnn param: {path}")
        elif top == "head":
            sd["head.weight" if path[1] == "kernel" else "head.bias"] = _tensor(
                v.T if path[1] == "kernel" else v
            )
        else:
            raise KeyError(f"unrecognised param scope: {path}")

    for path, v in _flatten(batch_stats).items():
        if path[0] != "cnn":
            raise KeyError(f"unrecognised batch_stats scope: {path}")
        scope = path[1]
        if scope in _BN_NAMES:
            t = f"cnn.backbone.{_BN_NAMES[scope]}"
        else:
            t = f"{_timm_prefix(scope)}.{_BN_NAMES[path[2]]}"
        sd[f"{t}.running_mean" if path[-1] == "mean" else f"{t}.running_var"] = _tensor(v)
        sd.setdefault(f"{t}.num_batches_tracked", torch.tensor(0, dtype=torch.int64))
    return sd


def acoustic_jax_shapes(
    spec: Sequence[StageSpec] = EFFNETV2_B2_SPEC,
    stem_channels: int = EFFNETV2_B2_STEM,
    rnn_hidden: int = 640,
    n_mels: int = 64,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Shapes of the JAX AcousticModel's (params, batch_stats) trees."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def bn(c):
        return {"scale": (c,), "bias": (c,)}, {"mean": (c,), "var": (c,)}

    cnn, cnn_stats = {}, {}
    cnn["stem_conv"] = {"kernel": (3, 3, 3, stem_channels)}
    cnn["stem_bn"], cnn_stats["stem_bn"] = bn(stem_channels)
    cin = stem_channels
    for si, st in enumerate(spec):
        for bi in range(st.repeats):
            blk, blk_stats = {}, {}
            k = st.kernel
            if st.block == "cn":
                blk["conv"] = {"kernel": (k, k, cin, st.channels)}
                blk["bn"], blk_stats["bn"] = bn(st.channels)
            elif st.block == "er":
                mid = cin * st.expand
                blk["conv_exp"] = {"kernel": (k, k, cin, mid)}
                blk["bn1"], blk_stats["bn1"] = bn(mid)
                blk["conv_pwl"] = {"kernel": (1, 1, mid, st.channels)}
                blk["bn2"], blk_stats["bn2"] = bn(st.channels)
            else:
                mid = cin * st.expand
                blk["conv_pw"] = {"kernel": (1, 1, cin, mid)}
                blk["bn1"], blk_stats["bn1"] = bn(mid)
                blk["conv_dw"] = {"kernel": (k, k, 1, mid)}
                blk["bn2"], blk_stats["bn2"] = bn(mid)
                if st.se_ratio > 0:
                    red = max(1, int(cin * st.se_ratio))
                    blk["se"] = {
                        "reduce": {"kernel": (1, 1, mid, red), "bias": (red,)},
                        "expand": {"kernel": (1, 1, red, mid), "bias": (mid,)},
                    }
                blk["conv_pwl"] = {"kernel": (1, 1, mid, st.channels)}
                blk["bn3"], blk_stats["bn3"] = bn(st.channels)
            cnn[f"s{si}_b{bi}"], cnn_stats[f"s{si}_b{bi}"] = blk, blk_stats
            cin = st.channels
    params["cnn"] = cnn
    stats["cnn"] = cnn_stats
    H = rnn_hidden
    params["rnn"] = {
        f"{w}_{d}": s
        for d in ("fwd", "bwd")
        for w, s in (("w_ih", (cin, 4 * H)), ("w_hh", (H, 4 * H)), ("b", (4 * H,)))
    }
    params["head"] = {"kernel": (H, n_mels), "bias": (n_mels,)}
    return params, stats


# ---------------------------------------------------------------------------
# modules with carried-across weights
# ---------------------------------------------------------------------------

def acoustic_model_from_jax(
    params: Dict[str, Any], batch_stats: Dict[str, Any], **model_kwargs
) -> AcousticModel:
    """AcousticModel(**model_kwargs) holding the JAX weights (strict load), eval mode, CPU.

    Built on the meta device, so no random init runs.
    """
    with torch.device("meta"):
        model = AcousticModel(**model_kwargs)
    sd = acoustic_state_dict_from_jax(params, batch_stats)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval()


def generator_from_jax(params: Dict[str, Any], h: dict, fuse_mode=None) -> Generator:
    """Generator(h, fuse_mode) holding the JAX weights (folded, strict load), eval mode, CPU.

    ``params`` may be the unfused tree or the JAX fused tree of
    `fuse_mrf_params(..., mode=[..."pallas"/"pallas2"...])`.
    """
    with torch.device("meta"):
        gen = Generator(h, fuse_mode=fuse_mode)
    gen.load_state_dict(generator_state_dict_from_jax(params, h), strict=True, assign=True)
    return gen.eval()


# ---------------------------------------------------------------------------
# random weights in the JAX layout, from a numpy seed
# ---------------------------------------------------------------------------

def random_acoustic_params(
    seed: int, **shape_kwargs
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Random (params, batch_stats) in the JAX layout: fan-out-scaled conv
    kernels, U(-1/sqrt(fan), 1/sqrt(fan)) for the LSTM and head, BatchNorm
    statistics near identity."""
    rng = np.random.default_rng(seed)
    p_shapes, s_shapes = acoustic_jax_shapes(**shape_kwargs)
    H = p_shapes["rnn"]["w_hh_fwd"][0]

    def fill_params(tree, path=()):
        if isinstance(tree, dict):
            return {k: fill_params(v, path + (k,)) for k, v in tree.items()}
        shape, name = tree, path[-1]
        if path[0] in ("rnn", "head"):  # torch's LSTM and Linear init, fan = H
            b = 1.0 / np.sqrt(H)
            return rng.uniform(-b, b, shape).astype(np.float32)
        if name == "kernel":  # conv (kh, kw, in, out): variance_scaling(2, fan_out)
            fan_out = shape[0] * shape[1] * shape[3]
            return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_out)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)  # biases

    def fill_stats(tree):
        if isinstance(tree, dict):
            if set(tree) == {"mean", "var"}:
                return {
                    "mean": (0.05 * rng.standard_normal(tree["mean"])).astype(np.float32),
                    "var": rng.uniform(0.8, 1.2, tree["var"]).astype(np.float32),
                }
            return {k: fill_stats(v) for k, v in tree.items()}
        raise TypeError(tree)

    return fill_params(p_shapes), fill_stats(s_shapes)


def random_generator_params(h: dict, seed: int) -> Dict[str, Any]:
    """Random JAX-layout Generator params: N(0, 0.01) weight-normed kernels
    (g = ||v||, as at init), U(-1/sqrt(fan_in), ...) for conv_pre and biases."""
    rng = np.random.default_rng(seed)

    def fill(tree, path=()):
        if isinstance(tree, dict):
            if "v" in tree:
                v = (0.01 * rng.standard_normal(tree["v"])).astype(np.float32)
                preserved = 1 if path[-1].startswith("ups_") else 2
                g = _wn_norm(v, preserved).astype(np.float32)
                fan_in = tree["v"][0] * tree["v"][1]
                b = 1.0 / np.sqrt(fan_in)
                return {"v": v, "g": g,
                        "b": rng.uniform(-b, b, tree["b"]).astype(np.float32)}
            if "w" in tree:
                fan_in = tree["w"][0] * tree["w"][1]
                b = 1.0 / np.sqrt(fan_in)
                return {"w": rng.uniform(-b, b, tree["w"]).astype(np.float32),
                        "b": rng.uniform(-b, b, tree["b"]).astype(np.float32)}
            return {k: fill(v, path + (k,)) for k, v in tree.items()}
        raise TypeError(tree)

    return fill(generator_jax_shapes(h))
