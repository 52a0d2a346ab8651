"""Card-only tests of the port: each kernel against its plain version on the card.

These skip without a CUDA card. The file imports neither JAX nor the JAX
package, so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Tolerance 1e-4: fp32 dot products summed in another order, carried through
T steps of contractive gates (differences of ~2e-7 are seen at H=640).
"""
import numpy as np
import pytest
import torch

from mri2speech_tpu_torch.config import default_vocoder_config
from mri2speech_tpu_torch.infer.pipeline import VideoToSpeechPipeline
from mri2speech_tpu_torch.models.effnetv2 import StageSpec
from mri2speech_tpu_torch.ops import bilstm
from mri2speech_tpu_torch.ops.scaler import MelScaler
from mri2speech_tpu_torch.weights import (
    acoustic_model_from_jax,
    generator_from_jax,
    random_acoustic_params,
    random_generator_params,
)

torch.set_num_threads(1)

ATOL = 1e-4
TINY_SPEC = (
    StageSpec("cn", 3, 1, 1, 8, 1),
    StageSpec("er", 3, 2, 2, 8, 1),
    StageSpec("ir", 3, 2, 2, 16, 1, 0.25),
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(70, 1, 640), (37, 3, 48), (5, 6, 640)])
def test_kernel_matches_plain_version_on_card(cuda_device, T, B, H):
    rng = np.random.default_rng(10)
    xs = [rng.standard_normal((T, B, 4 * H)).astype(np.float32) for _ in range(2)]
    ws = [(rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32) for _ in range(2)]
    mask = np.ones((T, B), np.float32)
    mask[T - 3:, 0] = 0.0
    xf, xb, wf, wb, m = [torch.from_numpy(a).to(cuda_device) for a in (*xs, *ws, mask)]
    before = bilstm.launches
    kf, kb = bilstm.bilstm_recurrence(xf, xb, wf, wb, m)
    torch.cuda.synchronize()
    assert bilstm.launches == before + 1
    rf, rb = bilstm.bilstm_recurrence_reference(
        bilstm.freeze_padded_steps(xf, m), bilstm.freeze_padded_steps(xb, m), wf, wb
    )
    torch.testing.assert_close(kf, rf, atol=ATOL, rtol=0)
    torch.testing.assert_close(kb, rb, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda_device):
    x = torch.zeros(4, 1, 32, device=cuda_device)
    w = torch.zeros(8, 32, device=cuda_device)
    with pytest.raises(TypeError):
        bilstm.bilstm_recurrence(x.double(), x.double(), w.double(), w.double())
    with pytest.raises(ValueError):
        bilstm.bilstm_recurrence(x, x, w, w.cpu())
    with pytest.raises(ValueError):
        bilstm.bilstm_recurrence(x, x, w[:, :16], w[:, :16])


@pytest.mark.cuda
def test_tiny_pipeline_card_matches_cpu(cuda_device):
    """Same weights on the card and on the CPU; the card goes through K1 once per request."""
    params, stats = random_acoustic_params(seed=41, spec=TINY_SPEC, stem_channels=8,
                                           rnn_hidden=16)
    h = dict(default_vocoder_config(upsample_initial_channel=16))
    gen_params = random_generator_params(h, seed=42)
    scaler = MelScaler(mean=np.linspace(-40, -10, 64).astype(np.float32),
                       std=np.full(64, 5.0, np.float32))

    def pipe(device):
        model = acoustic_model_from_jax(params, stats, rnn_hidden=16, cnn_spec=TINY_SPEC,
                                        cnn_stem=8)
        return VideoToSpeechPipeline(model, generator_from_jax(gen_params, h), scaler,
                                     frame_bucket=8, input_norm="zscore_minmax", device=device)

    frames = (np.random.default_rng(43).random((13, 64, 64)) * 255).astype(np.uint8)
    before = bilstm.launches
    card = pipe(cuda_device)(frames)
    assert bilstm.launches == before + 1
    cpu = pipe("cpu")(frames)
    for name, c, r, tol in zip(("audio", "mel_db", "mel_log"), card, cpu, (1e-5, 1e-3, 1e-4)):
        np.testing.assert_allclose(c, r, atol=tol, rtol=0, err_msg=name)
