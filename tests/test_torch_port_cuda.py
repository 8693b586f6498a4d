"""PyTorch port on the GPU: the hand-written CUDA kernels against their plain
PyTorch versions on the card, and the model on the card against the CPU.

Marked `cuda`: without a CUDA device every test skips. On the GPU host
(which has no JAX, so the repo's JAX conftest is left out):

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
from gfs3dseg_gws_tpu_torch.ops.attention_kernel import (attention_plain,
                                                         fused_attention)
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import (fused_edgeconv_infer,
                                                       fused_edgeconv_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(r, *shape, scale=1.0):
    return torch.from_numpy((r.standard_normal(shape) * scale).astype(
        np.float32))


@pytest.mark.parametrize("b,n,c,w0,w1,k", [
    (2, 100, 9, 8, 8, 5),         # ragged N, narrow tables
    (2, 300, 64, 64, 64, 20),     # model widths, ragged N
    (1, 64, 3, 48, 24, 32),       # k at its limit, W0 != W1
    (3, 2048, 9, 64, 64, 20),     # first block at full N
])
def test_fused_edgeconv_kernel_matches_plain(dev, b, n, c, w0, w1, k):
    r = np.random.default_rng(n + c)
    args = [_randn(r, b, n, c), _randn(r, b, n, w0), _randn(r, b, n, w0),
            _randn(r, w0, w1, scale=0.3), _randn(r, w1, scale=0.1)]
    ref = fused_edgeconv_plain(*[a.to(dev) for a in args], k)
    before = fused_edgeconv_infer.launches
    got = fused_edgeconv_infer(*[a.to(dev) for a in args], k)
    torch.cuda.synchronize()
    assert fused_edgeconv_infer.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,n,d", [(2, 100, 16), (2, 2048, 64), (1, 33, 64),
                                   (3, 130, 44)])
def test_fused_attention_kernel_matches_plain(dev, b, n, d):
    r = np.random.default_rng(n + d)
    q, k, v = (_randn(r, b, n, d).to(dev) for _ in range(3))
    before = fused_attention.launches
    got = fused_attention(q, k, v, d ** 0.5)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    torch.testing.assert_close(got, attention_plain(q, k, v, d ** 0.5),
                               rtol=1e-4, atol=1e-5)


def test_kernel_wrappers_refuse_what_they_cannot_take(dev):
    x = torch.zeros((1, 16, 65), device=dev)
    a = torch.zeros((1, 16, 8), device=dev)
    w2, bias2 = torch.zeros((8, 8), device=dev), torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="C, W0, W1 <= 64"):
        fused_edgeconv_infer(x, a, a, w2, bias2, 5)
    with pytest.raises(ValueError, match="k <= min"):
        fused_edgeconv_infer(x[..., :3].contiguous(), a, a, w2, bias2, 17)
    with pytest.raises(TypeError, match="float32"):
        fused_attention(a.double(), a.double(), a.double(), 1.0)
    odd = torch.zeros((1, 16, 6), device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_attention(odd, odd, odd, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(a.transpose(1, 2), a.transpose(1, 2),
                        a.transpose(1, 2), 1.0)


def test_model_on_card_agrees_with_cpu(dev):
    """evaluate_multi at the model's widths: kernels on the card vs plain
    versions on the CPU, same weights and inputs."""
    g = torch.Generator().manual_seed(0)
    cpu = GWCAPL(num_gw=150, generator=g)
    gpu = GWCAPL(num_gw=150, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    r = np.random.default_rng(1)
    x = _randn(r, 2, 512, 9)
    gp = _randn(r, 150, 192)
    gened = _randn(r, 2, 13, 128)
    bc = torch.from_numpy((r.random((7, 150)) < 0.3).astype(np.float32))
    nc = torch.from_numpy((r.random((2, 6, 150)) < 0.3).astype(np.float32))
    with torch.inference_mode():
        ref, _, _ = cpu.evaluate_multi(x, gp, gened, bc, nc)
        got, _, _ = gpu.evaluate_multi(*(a.to(dev) for a in
                                         (x, gp, gened, bc, nc)))
    got = got.cpu()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    assert agree >= 0.999, agree
    close = ((got - ref).abs() <= 1e-3).all(-1).float().mean().item()
    assert close >= 0.999, close
