"""The port's fused serving configuration on the CPU against the JAX package's.

Both packages run the same fused configuration from the same numpy weights:
the encoder with fuse_ir (the JAX side with pad_ir=False, which would
otherwise take precedence), the BiLSTM through its kernel (Pallas in
interpret mode on the JAX side), and the generator with FUSED_MODE: v1 MRF
stages on the two wide stages, v2 on the two narrow ones, bf16 operands. The
JAX generator takes `fuse_mrf_params` of the folded weights; that tree is
carried across by `weights.py`. The ir stage has 2 repeats, so its second
block fuses; T = 13 is not a bucket multiple.

Tolerances (both sides round the same activations to bf16 before each
product, at the same places, so on the CPU they differ by fp32 reordering
alone; no rounding flipped at this size), ~5x what was seen: mel_db 2e-5 dB
(values -40..-10 dB; 3.8e-6 seen), mel_log 1e-5 (1.9e-6 seen), audio 5e-7
absolute (tanh output up to ~0.3; 8.9e-8 seen). The control, the port's fp32
configuration on the same weights, must fail the mel_db limit (it differs
from the JAX fused output by 1.9e-4 dB).
"""
import numpy as np
import pytest
import torch

from mri2speech_tpu.config import default_vocoder_config as jax_default_config
from mri2speech_tpu.infer.pipeline import VideoToSpeechPipeline as JaxPipeline
from mri2speech_tpu.models.acoustic import AcousticModel as JaxAcousticModel
from mri2speech_tpu.models.effnetv2 import StageSpec as JaxStageSpec
from mri2speech_tpu.models.vocoder import Generator as JaxGenerator
from mri2speech_tpu.models.vocoder import fuse_mrf_params
from mri2speech_tpu.ops.scaler import MelScaler as JaxMelScaler
from mri2speech_tpu_torch.infer.pipeline import VideoToSpeechPipeline
from mri2speech_tpu_torch.models.effnetv2 import FusedMBConv, StageSpec
from mri2speech_tpu_torch.models.vocoder import FUSED_MODE
from mri2speech_tpu_torch.ops import bilstm, mbconv, mrf
from mri2speech_tpu_torch.ops.scaler import MelScaler
from mri2speech_tpu_torch.weights import (
    acoustic_model_from_jax,
    fold_weight_norm,
    generator_from_jax,
    random_acoustic_params,
    random_generator_params,
)

torch.set_num_threads(1)

JAX_SPEC = (
    JaxStageSpec("cn", 3, 1, 1, 8, 1),
    JaxStageSpec("er", 3, 2, 2, 8, 1),
    JaxStageSpec("ir", 3, 2, 2, 16, 2, 0.25),  # b0 stride 2, b1 fused
)
SPEC = tuple(StageSpec(**vars(s)) for s in JAX_SPEC)
TOL = {"audio": 5e-7, "mel_db": 2e-5, "mel_log": 1e-5}


@pytest.fixture(scope="module")
def pipelines():
    params, stats = random_acoustic_params(seed=51, spec=SPEC, stem_channels=8, rnn_hidden=16)
    h = dict(jax_default_config(upsample_initial_channel=16))
    gen_tree = fuse_mrf_params(fold_weight_norm(random_generator_params(h, seed=52)), h,
                               mode=FUSED_MODE)
    mean = np.linspace(-40, -10, 64).astype(np.float32)
    std = np.full(64, 5.0, dtype=np.float32)
    jm = JaxAcousticModel(n_mels=64, rnn_hidden=16, cnn_spec=JAX_SPEC, cnn_stem=8,
                          lstm_impl="pallas", fuse_ir=True, pad_ir=False)
    jgen = JaxGenerator(h=h, use_weight_norm=False, fuse_mrf=True, fuse_mode=FUSED_MODE)
    jax_pipe = JaxPipeline(jm, {"params": params, "batch_stats": stats}, jgen, gen_tree,
                           JaxMelScaler(mean=mean, std=std), frame_bucket=8,
                           input_norm="zscore_minmax")

    def port(fused):
        model = acoustic_model_from_jax(params, stats, rnn_hidden=16, cnn_spec=SPEC, cnn_stem=8,
                                        lstm_impl="kernel", fuse_ir=fused)
        gen = generator_from_jax(gen_tree, h, fuse_mode=FUSED_MODE if fused else None)
        return VideoToSpeechPipeline(model, gen, MelScaler(mean=mean, std=std), frame_bucket=8,
                                     input_norm="zscore_minmax", device="cpu")

    return jax_pipe, port(True), port(False)


def test_fused_pipeline_matches_jax_fused_serving(pipelines):
    jax_pipe, port, port_fp32 = pipelines
    assert sum(isinstance(m, FusedMBConv) for m in port.acoustic_model.modules()) == 1
    assert port.generator.fuse_modes == FUSED_MODE
    frames = (np.random.default_rng(53).random((13, 64, 64)) * 255).astype(np.uint8)
    counts = (dict(bilstm.launches), dict(mrf.launches), mbconv.launches)
    got = port(frames)
    ref = jax_pipe(frames)
    assert got[0].shape == (13 * 420,) and got[1].shape == got[2].shape == (13, 64)
    for name, g, r in zip(("audio", "mel_db", "mel_log"), got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=TOL[name], rtol=0, err_msg=name)
    assert (bilstm.launches, mrf.launches, mbconv.launches) == counts  # CPU: plain versions
    # control: the fp32 configuration on the same weights is told apart from the fused one
    assert np.abs(port_fp32(frames)[1] - np.asarray(ref[1])).max() > TOL["mel_db"]
