"""The prediction paths on the card against the port's own CPU run.

Torch only (the card's machine has no flax); every test is ``gpu``-marked
and skips without a CUDA device.  Tolerances are the reference's
(``tests/test_inference.py``): the bfloat16 U-Net's sigmoid within atol
2e-2 (``test_inference_blockwise_matches_single_shot``), the float32 U-Net's
logits within atol/rtol 2e-4 (``test_torch_checkpoint_import_numerical_
parity``; TF32 off for the convolutions), the filter bank within atol 2e-4
(``test_symmetric3_eigenvalues_vs_lapack``) and the forest on identical
features within atol 1e-6 (``test_vigra_forest_parse_and_predict``).

Run on the card: ``python3 -m pytest tests/test_torch_prediction_card.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from cluster_tools_tpu_torch.models import UNet3D
from cluster_tools_tpu_torch.tasks import ilastik as il
from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the prediction paths on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_unet_forward_on_the_card_matches_the_cpu(cuda, dtype):
    """The full-width U-Net (base 16, depth 2, GroupNorm) on a 48^3 input."""
    x = torch.from_numpy(np.random.default_rng(9).random((1, 1, 48, 48, 48)).astype(np.float32))
    model = UNet3D(dtype=getattr(torch, dtype))
    model.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = model(x).numpy()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            got = model.to(cuda)(x.to(cuda)).cpu().numpy()
    if dtype == "bfloat16":
        np.testing.assert_allclose(1 / (1 + np.exp(-got)), 1 / (1 + np.exp(-want)), atol=2e-2, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.gpu
def test_feature_banks_and_forest_on_the_card_match_the_cpu(cuda):
    x = synthetic_boundaries((1, 40, 40, 40), torch.Generator().manual_seed(4))[0]
    sel = tuple((fid, 1.3) for fid in il.ILP_SUPPORTED_FEATURES)
    for bank in (lambda v: il.feature_bank(v), lambda v: il.ilp_feature_bank(v, sel)):
        got, want = bank(x.to(cuda)).cpu(), bank(x)
        torch.testing.assert_close(got, want, atol=2e-4, rtol=0)
    rng = np.random.default_rng(5)
    T, N, F = 8, 63, want.shape[-1]
    children = np.stack([2 * np.arange(N) + 1, 2 * np.arange(N) + 2], -1)
    children[31:] = np.arange(31, N)[:, None]
    probs = rng.random((T, N, 3)).astype(np.float32)
    forest = [torch.from_numpy(a) for a in (
        rng.integers(0, F, (T, N)).astype(np.int32), rng.random((T, N)).astype(np.float32),
        np.broadcast_to(children, (T, N, 2)).astype(np.int32).copy(), probs / probs.sum(-1, keepdims=True))]
    flat = want.reshape(-1, F)
    got = il.forest_predict_proba(*[a.to(cuda) for a in forest], flat.to(cuda), 5).cpu()
    torch.testing.assert_close(got, il.forest_predict_proba(*forest, flat, 5), atol=1e-6, rtol=0)
