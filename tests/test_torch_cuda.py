"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small sizes. Every test here needs an NVIDIA GPU (`cuda` marker) and
skips without one. The file imports no jax, so it runs on a machine that
has only PyTorch and the CUDA toolkit, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`python3 chip_smoke.py` holds every kernel at the main paths' full shapes.)
"""

import pytest
import torch

from rohm_tpu_torch.models import PoseNet
from rohm_tpu_torch.models.blocks import TransformerEncoderLayer
from rohm_tpu_torch.ops import kernel_common as kc
from rohm_tpu_torch.ops import transformer_layer as l32
from rohm_tpu_torch.ops import transformer_layer_bf16 as l16
from rohm_tpu_torch.ops import transformer_layer_int8 as l8
from rohm_tpu_torch.ops import transformer_layer_train as lt

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_a_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card (see chip_smoke.py)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products


def test_kernels_match_plain_on_cuda():
    """The bf16 and int8 layer chains against their plain chains, at D=64
    (the kernels' tile widths)."""
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(64, 4, 128).cuda()
    x = torch.randn(2, 144, 64, device="cuda").to(torch.bfloat16)
    for fn, plain, prep, atol in (
        (l16.fused_encoder_layer_bf16, l16.fused_encoder_layer_bf16_plain, l16.prepare_layer_bf16(layer), 6e-2),
        (l8.fused_encoder_layer_int8, l8.fused_encoder_layer_int8_plain, l8.prepare_layer_int8(layer), 0.3),
    ):
        err = (fn(x, prep, 4).float() - plain(x, prep, 4).float()).abs()
        assert err.max().item() < atol


def test_f32_and_int8qa_kernels_match_plain_on_cuda():
    """The f32 and the int8qa layer chains against their plain chains, at
    D=64."""
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(64, 4, 128).cuda()
    x = torch.randn(2, 144, 64, device="cuda")
    err = (l32.fused_encoder_layer(x, layer, 4) - l32.fused_encoder_layer_plain(x, layer, 4)).abs()
    assert err.max().item() < 2e-4
    prep = l8.prepare_layer_int8(layer)
    xb = x.to(torch.bfloat16)
    got = l8.fused_encoder_layer_int8(xb, prep, 4, qattn=True).float()
    assert (got - l8.fused_encoder_layer_int8_plain(xb, prep, 4, qattn=True).float()).abs().max().item() < 0.3


def test_training_kernels_match_plain_on_cuda():
    """The training layer (K6 forward, K7 backward) through the autograd
    Function with the kernels against the plain chain: y, dx and the 12
    parameter gradients, f32 and bf16, at D=64 and S=145 (ragged tiles),
    dropout 0.1 with the same masks. Gates as chip_smoke.py's: f32 sum
    order (1e-4 of each tensor's max); bf16 rounding flips (4e-3)."""
    torch.manual_seed(0)
    b, s, d, f, h = 3, 145, 64, 128, 4
    layer = TransformerEncoderLayer(d, h, f).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():  # random biases and LayerNorm parameters, so every term is seen
        for prm in layer.parameters():
            if prm.dim() == 1:
                prm.add_(0.1 * torch.randn(prm.shape, device="cuda", generator=g))
    masks = lt.gen_dropout_masks(g, b, s, d, f, h, 0.1)
    x = torch.randn(b, s, d, device="cuda", generator=g)
    readout = torch.randn(b, s, d, device="cuda", generator=g)  # every output coordinate matters
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 4e-3)):
        outs = []
        for kernels in (lt.KERNELS, lt.PLAIN):
            layer.zero_grad()
            xx = x.clone().requires_grad_()
            y = lt.fused_train_layer(layer, xx, masks, h, 0.1, dtype, kernels)
            (y * readout).sum().backward()
            outs.append([y.detach(), xx.grad] + [p.grad.clone() for p in lt.layer_params(layer)])
        for got, ref in zip(*outs):
            assert (got - ref).abs().max().item() <= tol * ref.abs().max().item() + 1e-6


def test_training_gemm_layouts_and_split_k_on_cuda():
    """gemm_train's three layouts at ragged sizes (rows not a tile
    multiple), with a weight gradient small enough to be split over K."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = 2 * 145 + 6  # 296 rows
    a = torch.randn(rows, 96, device="cuda", generator=g)
    w = torch.randn(160, 96, device="cuda", generator=g)  # a Linear weight [out, in]
    dy = torch.randn(rows, 160, device="cuda", generator=g)
    for bf16 in (False, True):
        for kw in (dict(a=a, b=w, b_t=True), dict(a=dy, b=w), dict(a=dy, b=a, a_t=True)):
            got = lt.gemm_train(bf16=bf16, **kw)
            ref = lt.gemm_train_plain(bf16=bf16, **kw)
            scale = lt.gemm_train_plain(kw["a"].abs(), kw["b"].abs(), kw.get("a_t", False),
                                        kw.get("b_t", False), bf16)
            assert ((got - ref).abs() <= 2e-5 * scale + 1e-6).all()


def test_stack_kernel_matches_the_k3_chain_and_plain_on_cuda():
    """The whole-stack kernel (one cooperative launch) at D=64, F=128, two
    layers, S=144: bit-identical to two launches of the K3 chain (the same
    device routines), and within the int8 layer's envelope of the plain
    stack; S=15 gives ragged attention and GEMM tiles."""
    torch.manual_seed(0)
    posenet = PoseNet(latent_dim=64, ff_size=128, num_layers=2, num_heads=4).cuda()
    stacked = l8.prepare_posenet_int8(posenet, mega=True)["layers_stacked"]
    for seq in (144, 15):
        x = torch.randn(3, seq, 64, device="cuda").to(torch.bfloat16)
        before = l8.fused_encoder_stack_int8.launches
        got = l8.fused_encoder_stack_int8(x, stacked, 4)
        assert l8.fused_encoder_stack_int8.launches == before + 1
        ref = x
        for i in range(2):
            ref = l8.fused_encoder_layer_int8(ref, tuple(t[i] for t in stacked), 4)
        assert torch.equal(got, ref)
        err = (got.float() - l8.fused_encoder_stack_int8_plain(x, stacked, 4).float()).abs()
        assert err.max().item() < 0.3 and err.mean().item() < 5e-2


def test_new_kernel_modes_match_plain_on_cuda():
    """quant_rows_int8 with a row stride (the q third of a QKV buffer, read
    in place) and with the fixed scale 1/8: exact. attention_bf16 without
    the softmax: one bf16 flip per prob (2^-8 sum|p||v|) plus one bf16 ulp
    of the output."""
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(2 * 144, 3 * 64, device="cuda", generator=g).to(torch.bfloat16)
    for args in ((qkv[:, :64],), (qkv, 0.125), (qkv.float(), 0.125)):
        q, s = l8.quant_rows_int8(*args)
        q_ref, s_ref = l8.quant_rows_int8_plain(*args)
        assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    got = kc.attention_bf16(qkv, 144, 4, no_softmax=True).float()
    ref = kc.attention_bf16_plain(qkv, 144, 4, no_softmax=True).float()
    q, k, v = (t.reshape(2, 144, 4, 16).transpose(1, 2).float() for t in qkv.split(64, -1))
    p = ((q @ k.transpose(-1, -2)) * 0.01).to(torch.bfloat16).float().abs()
    pv = (p @ v.abs()).transpose(1, 2).reshape(2 * 144, 64)
    assert ((got - ref).abs() <= 2.0 ** -8 * pv + 2.0 ** -7 * ref.abs() + 1e-6).all()
