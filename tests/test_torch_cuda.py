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


def _gemm_train_within_gate(bf16: bool, **kw) -> None:
    """gemm_train against its plain version under chip_smoke.py's gate for
    a product without an epilogue: 2e-5 sum|a||b| (f32 sum order)."""
    got = lt.gemm_train(bf16=bf16, **kw)
    ref = lt.gemm_train_plain(bf16=bf16, **kw)
    scale = lt.gemm_train_plain(kw["a"].abs(), kw["b"].abs(), kw.get("a_t", False), kw.get("b_t", False), bf16)
    assert ((got - ref).abs() <= 2e-5 * scale + 1e-6).all()


def test_training_gemm_layouts_and_split_k_on_cuda():
    """gemm_train's three layouts at ragged sizes (rows not a tile
    multiple), with a weight gradient deep enough to be split over K, in
    both operand modes: f32 operands (3xTF32), and bf16 operands in memory
    (TMA + wgmma), where the epilogue's bf16 copy is its f32 result
    rounded. Then the three f32 layouts at the full training shapes (9280
    rows; 512, 1024 and 1536 wide; the weight gradients split over K), and
    each mode's launch count moves."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = 8 * 145 + 6  # 1166 rows: the K of the weight gradient
    a = torch.randn(rows, 96, device="cuda", generator=g)
    w = torch.randn(160, 96, device="cuda", generator=g)  # a Linear weight [out, in]
    dy = torch.randn(rows, 160, device="cuda", generator=g)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bf16 in (False, True):
        assert lt.plan_splits(160, 96, rows, lt.GEMM_TILES[bf16], sms)[0] > 1
        ops = [t.to(torch.bfloat16) for t in (a, w, dy)] if bf16 else [a, w, dy]
        aa, ww, dd = ops
        counter = "launches_bf16" if bf16 else "launches_f32"
        before = getattr(lt.gemm_train, counter)
        for kw in (dict(a=aa, b=ww, b_t=True), dict(a=dd, b=ww), dict(a=dd, b=aa, a_t=True)):
            _gemm_train_within_gate(bf16, **kw)
        assert getattr(lt.gemm_train, counter) == before + 3
        if bf16:
            v32, v16 = lt.gemm_train(dd, ww, bf16=True, out="both")
            assert v16.dtype == torch.bfloat16 and torch.equal(v16, v32.to(torch.bfloat16))
            x = torch.randn(rows, 96, device="cuda", generator=g)
            assert torch.equal(lt.round_bf16(x), x.to(torch.bfloat16))
    # the f32 mode at the training layer's shapes: R = 64 x 145 rows, D =
    # 512, F = 1024, the qkv width 1536, weights at a Linear layer's scale
    r = 64 * 145
    before = lt.gemm_train.launches_f32
    for k, n in ((512, 1536), (512, 512), (512, 1024), (1024, 512)):
        x = torch.randn(r, k, device="cuda", generator=g)
        wt = torch.randn(n, k, device="cuda", generator=g) * k ** -0.5  # [out, in]
        d = torch.randn(r, n, device="cuda", generator=g)
        assert lt.plan_splits(n, k, r, lt.GEMM_TILES[False], sms)[0] > 1
        for kw in (dict(a=x, b=wt, b_t=True), dict(a=d, b=wt), dict(a=d, b=x, a_t=True)):
            _gemm_train_within_gate(False, **kw)
    assert lt.gemm_train.launches_f32 == before + 12


def test_bf16_attention_forward_on_the_tensor_cores():
    """attention_train_fwd in the bf16 mode (one block per sequence and
    head, tensor cores) against its plain version at the training layer's
    S = 145, dh = 128, H = 4, for two sequences with dropout 0.1, under
    the per-element gate of chip_smoke.py: 2^-14 inv_keep max|v| plus one
    bf16 flip of every pd that the scores' f32 sums could push across a
    rounding boundary. The f32-mode kernel, which rounds nothing, must
    fall outside that gate."""
    g = torch.Generator(device="cuda").manual_seed(2)
    b, s, h, dh, ik = 2, 145, 4, 128, 1.0 / 0.9
    d = h * dh
    qkv = 0.7 * torch.randn(b * s, 3 * d, device="cuda", generator=g)
    mask = (torch.rand(b, h, s, s, device="cuda", generator=g) < 0.9).to(torch.int8)
    qkv = qkv.to(torch.bfloat16)  # the bf16 mode's QKV buffer
    got = lt.attention_train_fwd(qkv, mask, s, h, ik, bf16=True)
    ref = lt.attention_train_fwd_plain(qkv, mask, s, h, ik, bf16=True)
    q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2).float() for t in qkv.split(d, -1))
    scale = dh ** -0.5
    pd = torch.softmax((q @ k.transpose(-1, -2)) * scale, -1) * (mask.float() * ik)
    rel = 2.0 * (2.0 ** -16 * scale * (q.abs() @ k.abs().transpose(-1, -2))).amax(-1, keepdim=True) + 2.0 ** -20
    flip = (pd * (1 + rel)).to(torch.bfloat16).float() - (pd * (1 - rel)).to(torch.bfloat16).float()
    gate = 2.0 ** -14 * ik * v.abs().max() + (flip @ v.abs()).transpose(1, 2).reshape(b * s, d)
    assert ((got - ref).abs() <= gate).all()
    f32_mode = lt.attention_train_fwd(qkv.float(), mask, s, h, ik, bf16=False)
    assert not ((f32_mode - ref).abs() <= gate).all()


def test_stack_kernel_matches_the_k3_chain_and_plain_on_cuda():
    """The whole-stack kernel (one cooperative launch) at D=64, F=128, two
    layers, S=144: bit-identical to two launches of the K3 chain (the same
    device routines), and within the int8 layer's envelope of the plain
    stack; S=15 gives ragged attention and GEMM tiles."""
    torch.manual_seed(0)
    posenet = PoseNet(latent_dim=64, ff_size=128, num_layers=2, num_heads=4).cuda()
    stacked = l8.prepare_posenet_int8(posenet, mega=True)["layers_stacked"]
    layers = l8.prepare_posenet_int8(posenet)["layers"]  # the same codes, K-major for the K3 chain
    for seq in (144, 15):
        x = torch.randn(3, seq, 64, device="cuda").to(torch.bfloat16)
        before = l8.fused_encoder_stack_int8.launches
        got = l8.fused_encoder_stack_int8(x, stacked, 4)
        assert l8.fused_encoder_stack_int8.launches == before + 1
        ref = l8.fused_encoder_layers_int8(x, layers, 4)  # the K3 chain, the LayerNorms writing the codes
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


def _bwd_within_gate(got, qkv, da, mask, s, h, ik, bf16):
    """dq, dk and dv each within chip_smoke.check_bwd's gate against the
    plain version in f32: 1e-5 (f32 mode) or 2^-10 (bf16 mode) of max|ref|.
    Returns, per part, the tolerance and the reference."""
    d = qkv.shape[1] // 3
    ref = lt.attention_train_bwd_plain(qkv, da, mask, s, h, ik, bf16)
    ref = ref[0] if bf16 else ref
    out = []
    for i in range(3):
        blk = slice(i * d, (i + 1) * d)
        tol = (2.0 ** -10 if bf16 else 1e-5) * ref[:, blk].abs().max()
        assert ((got[:, blk] - ref[:, blk]).abs() <= tol).all()
        out.append((tol, ref[:, blk]))
    return out


def _chain_operands(b, s, d, h, f, bf16, seed):
    """qkv and d(attn) as the plain training chain of a random layer hands
    them to the attention backward (dropout 0.1), and the probs' mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    layer = TransformerEncoderLayer(d, h, f).cuda()
    with torch.no_grad():
        for prm in layer.parameters():
            if prm.dim() == 1:
                prm.add_(0.1 * torch.randn(prm.shape, device="cuda", generator=g))
    params = tuple(t.detach() for t in lt.layer_params(layer))
    fm = lt.flat_masks(lt.gen_dropout_masks(g, b, s, d, f, h, 0.1), b * s)
    seen = {}

    def attn_bwd(qkv, da, *args, **kw):
        seen["qkv"], seen["da"] = qkv, da
        return lt.attention_train_bwd_plain(qkv, da, *args, **kw)

    k = lt.PLAIN._replace(attn_bwd=attn_bwd)
    kp = lt.cast_weight_mats(params) if bf16 else params
    x, dy = (torch.randn(b * s, d, device="cuda", generator=g) for _ in range(2))
    _, saved = lt.layer_train_fwd(x, kp, fm, s, h, 1.0 / 0.9, bf16, k)
    lt.layer_train_bwd(dy, saved, kp, fm, s, h, 1.0 / 0.9, bf16, k)
    return seen["qkv"], seen["da"], fm[0]


@pytest.mark.parametrize("s", [97, 145])
def test_bf16_attention_backward(s):
    """attention_train_bwd in the bf16 mode (a query kernel and a key
    kernel, no [B, H, S, S] buffer) on the operands the plain chain hands
    it, at an odd S and at the training layer's 145 (dh = 128, 16
    sequences x 2 heads, dropout 0.1): dq, dk and dv within the gate of
    _bwd_within_gate, the bf16 copy of dqkv its f32 result rounded, and the
    f32-mode kernel, which rounds nothing, outside that gate."""
    b, d, h, f, ik = 16, 256, 2, 512, 1.0 / 0.9
    qkv, da, mask = _chain_operands(b, s, d, h, f, True, s)
    assert qkv.dtype == da.dtype == torch.bfloat16
    got, got16 = lt.attention_train_bwd(qkv, da, mask, s, h, ik, True)
    assert torch.equal(got16, got.to(torch.bfloat16))
    f32_mode = lt.attention_train_bwd(qkv.float(), da.float(), mask, s, h, ik, False)
    outside = 0
    for i, (tol, ref) in enumerate(_bwd_within_gate(got, qkv, da, mask, s, h, ik, True)):
        outside += int(((f32_mode[:, i * d:(i + 1) * d] - ref).abs() > tol).sum().item())
    assert outside > 0


# the training length, one past each kernel's old single-tile limit at dh =
# 128 (160, 166, 176), past the limit attention_int8's header once stated
# (208), and 1024
LONG_S = [145, 161, 167, 177, 209, 1024]


@pytest.mark.parametrize("s", LONG_S)
def test_attention_kernels_take_any_sequence_length(s):
    """Every attention kernel of the port against its plain version at
    dh = 128 (2 sequences x 2 heads), its keys streamed in tiles past the
    length one tile holds, under chip_smoke.py's gates: attention_f32 1e-5
    max|v| (f32 sum order); attention_bf16 2^-6 max|v| (a bf16 flip per
    prob + the output's rounding); attention_int8 one prob code of the
    column + one bf16 ulp; the training forward 2^-14 inv_keep max|v| plus
    one bf16 flip of every pd whose score the tensor cores' sums could move
    (bf16 mode), 1e-5 inv_keep max|v| (f32 mode); the backward within
    _bwd_within_gate, on the chain's operands."""
    b, h, dh, ik = 2, 2, 128, 1.0 / 0.9
    d = h * dh
    g = torch.Generator(device="cuda").manual_seed(s)
    qkv = torch.randn(b * s, 3 * d, device="cuda", generator=g)
    qkv[:, :d] *= dh ** -0.5
    vmax = qkv[:, 2 * d:].abs().max().item()
    assert ((l32.attention_f32(qkv, s, h) - l32.attention_f32_plain(qkv, s, h)).abs() <= 1e-5 * vmax).all()
    q16 = qkv.to(torch.bfloat16)
    err = (kc.attention_bf16(q16, s, h).float() - kc.attention_bf16_plain(q16, s, h).float()).abs()
    assert (err <= 2.0 ** -6 * vmax).all()
    ref = l8.attention_int8_plain(q16, s, h).float()
    cmax = l8.attention_int8_codes(q16, s, h)[-1].expand(b, h, s, dh).transpose(1, 2).reshape(b * s, d)
    assert ((l8.attention_int8(q16, s, h).float() - ref).abs() <= cmax / 127.0 + 2.0 ** -7 * ref.abs()).all()
    for bf16 in (True, False):
        qq, dd, mask = _chain_operands(b, s, d, h, 2 * d, bf16, s)
        got, ref = lt.attention_train_fwd(qq, mask, s, h, ik, bf16), lt.attention_train_fwd_plain(qq, mask, s, h, ik, bf16)
        q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2).float() for t in qq.split(d, -1))
        vmax = v.abs().max().item()
        if bf16:
            pd = torch.softmax((q @ k.transpose(-1, -2)) * dh ** -0.5, -1) * (mask.float() * ik)
            rel = 2.0 * (2.0 ** -16 * dh ** -0.5 * (q.abs() @ k.abs().transpose(-1, -2))).amax(-1, keepdim=True) + 2.0 ** -20
            flip = (pd * (1 + rel)).to(torch.bfloat16).float() - (pd * (1 - rel)).to(torch.bfloat16).float()
            tol = 2.0 ** -14 * ik * vmax + (flip @ v.abs()).transpose(1, 2).reshape(b * s, d)
        else:
            tol = 1e-5 * ik * vmax
        assert ((got - ref).abs() <= tol).all()
        got = lt.attention_train_bwd(qq, dd, mask, s, h, ik, bf16)
        _bwd_within_gate(got[0] if bf16 else got, qq, dd, mask, s, h, ik, bf16)


@pytest.mark.parametrize("s", [144, 145, 161, 1024])
@pytest.mark.parametrize("dh", [128, 64])
def test_f32_attention_forwards_on_the_tensor_cores(dh, s):
    """attention_f32 and attention_train_fwd in the f32 mode (one 3xTF32
    routine, csrc/attention_tf32.cuh) against their plain versions, 2
    sequences x 2 heads, at the layers' lengths, one past the 160-key tile
    and 1024, under chip_smoke.py's gates: 1e-5 max|v|, 1e-5 inv_keep
    max|v|; each call launches its kernel once."""
    b, h, ik = 2, 2, 1.0 / 0.9
    d = h * dh
    g = torch.Generator(device="cuda").manual_seed(100 * dh + s)
    qkv = torch.randn(b * s, 3 * d, device="cuda", generator=g)
    vmax = qkv[:, 2 * d:].abs().max().item()
    mask = (torch.rand(b, h, s, s, device="cuda", generator=g) >= 0.1).to(torch.int8)
    before = lt.attention_train_fwd.launches
    got, ref = lt.attention_train_fwd(qkv, mask, s, h, ik), lt.attention_train_fwd_plain(qkv, mask, s, h, ik)
    assert lt.attention_train_fwd.launches == before + 1
    assert ((got - ref).abs() <= 1e-5 * ik * vmax).all()
    qkv[:, :d] *= dh ** -0.5  # attention_f32 takes Q pre-scaled
    before = l32.attention_f32.launches
    got, ref = l32.attention_f32(qkv, s, h), l32.attention_f32_plain(qkv, s, h)
    assert l32.attention_f32.launches == before + 1
    assert ((got - ref).abs() <= 1e-5 * vmax).all()


@pytest.mark.parametrize("s", [144, 145, 161, 1024])
@pytest.mark.parametrize("dh", [128, 64])
def test_f32_attention_backward_on_the_tensor_cores(dh, s):
    """attention_train_bwd in the f32 mode (a query kernel and a key kernel
    on the 3xTF32 routines of csrc/attention_tf32.cuh) on the operands the
    plain chain of a random layer hands it, 2 sequences x 2 heads, dropout
    0.1, at the layers' lengths, one past the 160-key tile and 1024: dq, dk
    and dv within chip_smoke.check_bwd's gate (1e-5 of each one's max|ref|),
    one launch per call, and no [B, H, S, S] f32 buffer: at S = 1024 the
    call's peak memory above what it was handed stays under B H S^2 4 bytes
    (its output, dqkv, is 3/8 of that)."""
    b, h, ik = 2, 2, 1.0 / 0.9
    d = h * dh
    qkv, da, mask = _chain_operands(b, s, d, h, 2 * d, False, 10 * dh + s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before = lt.attention_train_bwd.launches
    got = lt.attention_train_bwd(qkv, da, mask, s, h, ik, False)
    torch.cuda.synchronize()
    above = torch.cuda.max_memory_allocated() - held
    assert lt.attention_train_bwd.launches == before + 1
    _bwd_within_gate(got, qkv, da, mask, s, h, ik, False)
    if s == 1024:
        assert above < b * h * s * s * 4, above


@pytest.mark.parametrize("s", [177, 300])
def test_stack_kernel_at_long_sequences_on_cuda(s):
    """The whole-stack kernel past the length one attention tile holds (144
    keys): bit-identical to two launches of the K3 chain at D=64 (dh=16)."""
    torch.manual_seed(s)
    posenet = PoseNet(latent_dim=64, ff_size=128, num_layers=2, num_heads=4).cuda()
    stacked = l8.prepare_posenet_int8(posenet, mega=True)["layers_stacked"]
    x = torch.randn(2, s, 64, device="cuda").to(torch.bfloat16)
    ref = l8.fused_encoder_layers_int8(x, l8.prepare_posenet_int8(posenet)["layers"], 4)  # the same codes
    assert torch.equal(l8.fused_encoder_stack_int8(x, stacked, 4), ref)


def test_stack_kernel_grid_and_weight_layout_on_cuda():
    """The stack kernel's cooperative grid at the shipped shape (S = 144,
    dh = 128): one block of 288 threads (two consumer warpgroups and the
    producer warp of its GEMM phases) on every SM; a stacked weight in a
    contiguous [L, K, N] (not K-major) is refused before any launch."""
    per_sm, sms, threads = l8.stack_grid(144, 128)
    assert (per_sm, threads) == (1, 288) and sms == torch.cuda.get_device_properties(0).multi_processor_count
    torch.manual_seed(0)
    posenet = PoseNet(latent_dim=64, ff_size=128, num_layers=2, num_heads=4).cuda()
    stacked = list(l8.prepare_posenet_int8(posenet, mega=True)["layers_stacked"])
    stacked[8] = stacked[8].contiguous()
    before = l8.fused_encoder_stack_int8.launches
    with pytest.raises(ValueError, match="K-major"):
        l8.fused_encoder_stack_int8(torch.zeros(2, 16, 64, device="cuda"), tuple(stacked), 4)
    assert l8.fused_encoder_stack_int8.launches == before


@pytest.mark.parametrize("s", [16, 144, 145, l8.ATTENTION_INT8_HEAD_KEYS, l8.ATTENTION_INT8_HEAD_KEYS + 1, 1024])
def test_attention_int8_paths_on_cuda(s):
    """attention_int8 at dh = 128 (3 sequences x 4 heads) on both of its
    paths: one block per (sequence, head) up to ATTENTION_INT8_HEAD_KEYS,
    the key-tiled blocks of 48 queries past it; within chip_smoke.py's gate
    of its plain version (one prob code, vmax/127 of the column, plus one
    bf16 ulp), one launch per call."""
    b, h, dh = 3, 4, 128
    d = h * dh
    g = torch.Generator(device="cuda").manual_seed(s)
    qkv = torch.randn(b * s, 3 * d, device="cuda", generator=g)
    qkv[:, :d] *= dh ** -0.5
    q16 = qkv.to(torch.bfloat16)
    before = l8.attention_int8.launches
    got = l8.attention_int8(q16, s, h).float()
    assert l8.attention_int8.launches == before + 1
    ref = l8.attention_int8_plain(q16, s, h).float()
    cmax = l8.attention_int8_codes(q16, s, h)[-1].expand(b, h, s, dh).transpose(1, 2).reshape(b * s, d)
    assert ((got - ref).abs() <= cmax / 127.0 + 2.0 ** -7 * ref.abs()).all()


def _gemm_bf16_within_gate(a, w, bias, mode, sum_flip=False):
    """gemm_bf16 against its plain version under chip_smoke.py's gates: the
    f32 result within 1e-5 of max|ref| (f32 sum order), a bf16 result
    within one bf16 ulp of |ref| + |bias| (the sum order may flip the
    product's bf16 rounding). With `sum_flip` (qkv with a nonzero bf16 bias)
    also one ulp of |ref| for the rounding of the sum with the bias, which
    a flipped product can move across a tie: the WMMA kernel this one
    replaced shows the same two-ulp cases on the same inputs."""
    got, ref = l16.gemm_bf16(a, w, bias, mode), l16.gemm_bf16_plain(a, w, bias, mode)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs()
    if mode == "f32":
        assert (err <= 1e-5 * ref.abs().max() + 1e-6).all()
    else:
        gate = 2.0 ** -7 * (ref.float().abs() + bias.float().abs()) + 1e-5
        if sum_flip:
            gate = gate + 2.0 ** -7 * ref.float().abs()
        assert (err <= gate).all()


# (M, K, N): the four products of a bf16 layer at 32 x 144 tokens (qkv, out,
# FF1, FF2), ragged rows, one tile narrower than the kernel's tiles, and N
# and K that are multiples of 8 but not of a tile (TMA's zero fill)
GEMM_BF16_SHAPES = [(4608, 512, 1536), (4608, 512, 512), (4608, 512, 1024), (4608, 1024, 512),
                    (288, 512, 1536), (4608 + 37, 1024, 512), (4608 + 37, 512, 1024), (300, 64, 64),
                    (300, 72, 200), (300, 136, 1160)]


@pytest.mark.parametrize("m,k,n", GEMM_BF16_SHAPES)
@pytest.mark.parametrize("mode", ["qkv", "f32", "gelu"])
def test_gemm_bf16_shapes_on_cuda(m, k, n, mode):
    """gemm_bf16 (TMA + wgmma) in each epilogue mode at the layer's four
    shapes, at ragged M (288, 4608 + 37), at N = K = 64, and at N and K off
    the tiles (both tile widths); qkv both with
    the zero bias of a freshly built layer (chip_smoke.py's case) and with
    a nonzero one."""
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    a = torch.randn(m, k, device="cuda", generator=g).to(torch.bfloat16)
    w = (k ** -0.5 * torch.randn(k, n, device="cuda", generator=g)).to(torch.bfloat16)
    bias = 0.1 * torch.randn(n, device="cuda", generator=g)
    if mode == "qkv":
        _gemm_bf16_within_gate(a, w, torch.zeros_like(bias).to(torch.bfloat16), mode)
        _gemm_bf16_within_gate(a, w, bias.to(torch.bfloat16), mode, sum_flip=True)
    else:
        _gemm_bf16_within_gate(a, w, bias, mode)


# (M, K, N): the four products of an f32 layer at 32 x 144 tokens (qkv, out,
# FF1, FF2), ragged rows, the smallest N and K the kernel takes (4: TMA's
# 16-byte row pitch) with N and K off its 128 x BN x 32 tiles, and the four
# products at the f32 benchmark cell's 64 x 145 rows
GEMM_F32_SHAPES = [(4608, 512, 1536), (4608, 512, 512), (4608, 512, 1024), (4608, 1024, 512),
                   (288, 512, 1536), (4608 + 37, 1024, 512), (4608 + 37, 512, 1024), (300, 4, 4),
                   (37, 4, 68), (300, 36, 4),
                   (9280, 512, 1536), (9280, 512, 512), (9280, 512, 1024), (9280, 1024, 512)]


@pytest.mark.parametrize("m,k,n", GEMM_F32_SHAPES)
@pytest.mark.parametrize("mode", ["bias", "qkv", "gelu"])
def test_gemm_f32_shapes_on_cuda(m, k, n, mode):
    """gemm_f32 (3xTF32 on wgmma) in each epilogue mode at the layer's four
    shapes, at ragged M (288, 4608 + 37) and at the smallest N and K it
    takes, against its plain version under chip_smoke.py's gate, 1e-5
    max|ref| + 1e-6; each call adds exactly one launch of the product, and
    the first call on a weight one split."""
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    a = torch.randn(m, k, device="cuda", generator=g)
    w = (2 * torch.rand(n, k, device="cuda", generator=g) - 1) * k ** -0.5  # a Linear weight [out, in]
    bias = 0.1 * torch.randn(n, device="cuda", generator=g)
    scale, scale_cols = 128 ** -0.5, n // 3
    ref = l32.gemm_f32_plain(a, w, bias, mode, scale, scale_cols)
    for splits in (1, 0):  # the weight's first product splits it; the second reuses the halves
        before, split_before = l32.gemm_f32.launches, l32.split_tf32.launches
        got = l32.gemm_f32(a, w, bias, mode, scale, scale_cols)
        assert l32.gemm_f32.launches == before + 1
        assert l32.split_tf32.launches == split_before + splits
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert ((got - ref).abs() <= 1e-5 * ref.abs().max() + 1e-6).all()


def test_gemm_f32_weight_updated_in_place_on_cuda():
    """The weight's TF32 halves are split once, equal split_tf32_plain's bit
    for bit, and are split again after the weight is updated in place
    (copy_, mul_ under no_grad: its version counter moves), before the next
    product, which then matches the plain product of the new weight."""
    g = torch.Generator(device="cuda").manual_seed(7)
    a = torch.randn(300, 512, device="cuda", generator=g)
    w = torch.nn.Parameter((2 * torch.rand(1024, 512, device="cuda", generator=g) - 1) * 512 ** -0.5)
    bias = 0.1 * torch.randn(1024, device="cuda", generator=g)

    def product_within_gate():
        got, ref = l32.gemm_f32(a, w, bias, "gelu"), l32.gemm_f32_plain(a, w, bias, "gelu")
        assert ((got - ref).abs() <= 1e-5 * ref.abs().max() + 1e-6).all()

    before = l32.split_tf32.launches
    product_within_gate()
    halves = l32.split_tf32(w)
    assert l32.split_tf32.launches == before + 1
    assert torch.equal(halves, l32.split_tf32_plain(w.detach()))
    with torch.no_grad():
        w.copy_((2 * torch.rand(1024, 512, device="cuda", generator=g) - 1) * 512 ** -0.5)
    product_within_gate()
    assert l32.split_tf32.launches == before + 2
    with torch.no_grad():
        w.mul_(-3.0)
    product_within_gate()
    product_within_gate()
    assert l32.split_tf32.launches == before + 3
    assert torch.equal(l32.split_tf32(w), l32.split_tf32_plain(w.detach()))


@pytest.mark.parametrize("s", [1, 15, 16, 17, 143, 144, 145])
@pytest.mark.parametrize("dh", [16, 64, 128])
def test_attention_bf16_lengths_and_head_widths_on_cuda(dh, s):
    """attention_bf16 at each head width and at lengths around the chunk
    (16) and the one-tile edge (144 keys; 145 takes the tiled path), 3
    sequences x 2 heads: with the softmax within 2^-6 max|v| (a bf16 flip
    per prob + the output's rounding), without it within one bf16 flip per
    prob (2^-8 sum|p||v|) plus one bf16 ulp of the output."""
    b, h = 3, 2
    d = h * dh
    g = torch.Generator(device="cuda").manual_seed(1000 * dh + s)
    qkv = torch.randn(b * s, 3 * d, device="cuda", generator=g)
    qkv[:, :d] *= dh ** -0.5
    q16 = qkv.to(torch.bfloat16)
    vmax = q16[:, 2 * d:].float().abs().max().item()
    got = kc.attention_bf16(q16, s, h).float()
    assert ((got - kc.attention_bf16_plain(q16, s, h).float()).abs() <= 2.0 ** -6 * vmax).all()
    got = kc.attention_bf16(q16, s, h, no_softmax=True).float()
    ref = kc.attention_bf16_plain(q16, s, h, no_softmax=True).float()
    q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2).float() for t in q16.split(d, -1))
    p = ((q @ k.transpose(-1, -2)) * 0.01).to(torch.bfloat16).float().abs()
    pv = (p @ v.abs()).transpose(1, 2).reshape(b * s, d)
    assert ((got - ref).abs() <= 2.0 ** -8 * pv + 2.0 ** -7 * ref.abs() + 1e-6).all()


# (M, K, N, mode): the four products of an int8 layer at 32 x 144 tokens
# (qkv, out, FF1, FF2), then ragged rows, N and K off the tiles (16 and 4
# are the kernel's steps), and K past one 128-deep k-step by a part
GEMM_INT8_CASES = [(4608, 512, 1536, "bf16"), (4608, 512, 512, "f32"), (4608, 512, 1024, "gelu"),
                   (4608, 1024, 512, "f32"), (4608 + 37, 144, 1540, "bf16"), (300, 48, 68, "f32"),
                   (37, 1040, 516, "gelu")]


@pytest.mark.parametrize("m,k,n,mode", GEMM_INT8_CASES)
def test_gemm_int8_on_cuda(m, k, n, mode):
    """gemm_int8 (TMA + wgmma s8) on K-major weights against its plain
    version: the int32 sums are exact and the epilogue takes the plain
    version's rounded f32 steps, so the bf16 and f32 modes agree bit for
    bit and the gelu mode within chip_smoke.py's gate (2^-22 |ref| +
    1e-6: tanhf); one launch per call; a row-major weight is refused."""
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    qa, rs = l8.quant_rows_int8(torch.randn(m, k, device="cuda", generator=g))
    w, cs = l8._quant_cols(k ** -0.5 * torch.randn(k, n, device="cuda", generator=g))
    bias = 0.1 * torch.randn(n, device="cuda", generator=g)
    before = l8.gemm_int8.launches
    got = l8.gemm_int8(qa, rs, w, cs, bias, mode)
    assert l8.gemm_int8.launches == before + 1
    ref = l8.gemm_int8_plain(qa, rs, w, cs, bias, mode)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if mode == "gelu":
        assert ((got - ref).abs() <= 2.0 ** -22 * ref.abs() + 1e-6).all()
    else:
        assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="K-major"):
        l8.gemm_int8(qa, rs, w.contiguous(), cs, bias, mode)


def test_layernorm_bf16_copies_and_two_casts_on_cuda():
    """The training LayerNorm kernels' bf16 copies are their f32 outputs
    rounded (round_bf16_plain), bit for bit, and a bf16 layer call
    launches round_bf16 twice (x, attn) and the LayerNorm kernels twice
    each way."""
    g = torch.Generator(device="cuda").manual_seed(3)
    r, d = 2 * 145 + 3, 64
    a, b, dy = (torch.randn(r, d, device="cuda", generator=g) for _ in range(3))
    gamma, beta = 1.0 + 0.1 * torch.randn(d, device="cuda", generator=g), 0.1 * torch.randn(d, device="cuda", generator=g)
    mask = (torch.rand(r, d, device="cuda", generator=g) < 0.9).to(torch.int8)
    y, norm, rstd, y16 = lt.layernorm_train_fwd(a, b, gamma, beta, out_bf16=True)
    assert torch.equal(y16, lt.round_bf16_plain(y))
    dr, drm, drm16 = lt.layernorm_train_bwd(dy, norm, rstd, gamma, mask, 1.25, out_bf16=True)
    assert torch.equal(drm16, lt.round_bf16_plain(drm))
    torch.manual_seed(0)
    bsz, s, f, h = 2, 145, 128, 4
    layer = TransformerEncoderLayer(d, h, f).cuda()
    masks = lt.gen_dropout_masks(g, bsz, s, d, f, h, 0.1)
    x = torch.randn(bsz, s, d, device="cuda", generator=g, requires_grad=True)
    counters = (lt.round_bf16, lt.layernorm_train_fwd, lt.layernorm_train_bwd)
    before = [fn.launches for fn in counters]
    lt.fused_train_layer(layer, x, masks, h, 0.1, "bfloat16").sum().backward()
    assert [fn.launches - n for fn, n in zip(counters, before)] == [2, 2, 2]


# (dtype, C, row stride): the layer's widths in both types, a row past one
# span of registers (f32 1024, bf16 2048), a narrow one, and strided rows
QUANT_CASES = [(torch.bfloat16, 512, 512), (torch.float32, 1024, 1024), (torch.float32, 1040, 1040),
               (torch.bfloat16, 2056, 2056), (torch.bfloat16, 8, 8), (torch.float32, 4, 12),
               (torch.bfloat16, 512, 1536)]


@pytest.mark.parametrize("dtype,c,ld", QUANT_CASES)
def test_quant_rows_int8_widths_on_cuda(dtype, c, ld):
    """quant_rows_int8 (one warp per row, 16-byte loads) equal to its plain
    version at any whole number of 16-byte vectors, with an all-zero row
    (amax clamps to 1e-12) and a row of ties (x * 127/amax on .5 steps);
    one launch; rows off 16-byte boundaries refused."""
    g = torch.Generator(device="cuda").manual_seed(c + ld)
    r = 2 * 145 + 3
    buf = torch.randn(r, ld, device="cuda", generator=g).to(dtype)
    buf[0] = 0.0
    buf[1] = torch.arange(ld, device="cuda").remainder(5).to(dtype) * 0.5 - 1.0  # amax 1: x * 127 ends in .5
    x = buf[:, :c]
    before = l8.quant_rows_int8.launches
    q, s = l8.quant_rows_int8(x)
    assert l8.quant_rows_int8.launches == before + 1
    q_ref, s_ref = l8.quant_rows_int8_plain(x)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    per_vec = 16 // buf.element_size()
    for bad in (buf[:, 1:c], buf[:, : c - 1] if c > 1 else buf[:, :0]):
        if bad.shape[1] % per_vec or bad.data_ptr() % 16:
            with pytest.raises(ValueError, match="16-byte"):
                l8.quant_rows_int8(bad)


def test_residual_layernorm_codes_on_cuda():
    """residual_layernorm with `quant`: the codes and scales equal
    quant_rows_int8_plain of the kernel's own output (f32 where it writes
    one, else bf16), the outputs equal those of the launch without codes,
    and the int8 chain launches quant_rows_int8 1 + 2 L times and
    residual_layernorm 2 L times for L layers, bit for bit the chain of
    single-layer calls (each quantizing its input itself)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    r, d = 2 * 145 + 3, 64
    x16 = torch.randn(r, d, device="cuda", generator=g).to(torch.bfloat16)
    a32, b = (torch.randn(r, d, device="cuda", generator=g) for _ in range(2))
    gamma, beta = 1.0 + 0.1 * torch.randn(d, device="cuda", generator=g), 0.1 * torch.randn(d, device="cuda", generator=g)
    for a, of, ob in ((x16, True, False), (a32, False, True), (x16, True, True)):
        f32, bf16, (q, s) = kc.residual_layernorm(a, b, gamma, beta, of, ob, quant=True)
        assert torch.equal(q, l8.quant_rows_int8_plain(f32 if of else bf16)[0])
        assert torch.equal(s, l8.quant_rows_int8_plain(f32 if of else bf16)[1])
        f32_, bf16_ = kc.residual_layernorm(a, b, gamma, beta, of, ob)
        assert all(u is None and v is None or torch.equal(u, v) for u, v in ((f32, f32_), (bf16, bf16_)))
    torch.manual_seed(0)
    posenet = PoseNet(latent_dim=64, ff_size=128, num_layers=3, num_heads=4).cuda()
    for key, qattn in (("layers", False), ("layers_qattn", True)):
        layers = l8.prepare_posenet_int8(posenet, qattn=qattn)[key]
        x = torch.randn(2, 145, 64, device="cuda", generator=g).to(torch.bfloat16)
        before = (l8.quant_rows_int8.launches, kc.residual_layernorm.launches)
        got = l8.fused_encoder_layers_int8(x, layers, 4, qattn=qattn)
        after = (l8.quant_rows_int8.launches, kc.residual_layernorm.launches)
        assert (after[0] - before[0], after[1] - before[1]) == (1 + 2 * 3, 2 * 3)
        ref = x
        for prep in layers:
            ref = l8.fused_encoder_layer_int8(ref, prep, 4, qattn=qattn)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("r,n", [(64 * 145, 512), (64 * 145, 1536), (2 * 145 + 3, 64), (5, 36)])
def test_colsum_one_launch_repeatable_on_cuda(r, n):
    """colsum (one launch, a cluster of blocks per 32 columns) within
    chip_smoke.py's gate (1e-5 of sum|terms|) of its plain version, bit
    for bit the same in two runs, with and without the product; N off a
    multiple of 4 refused."""
    g = torch.Generator(device="cuda").manual_seed(r + n)
    a, b = (torch.randn(r, n, device="cuda", generator=g) for _ in range(2))
    for args, sums in (((a,), (a.abs().sum(0),)), ((a, b), ((a * b).abs().sum(0), a.abs().sum(0)))):
        before = lt.colsum.launches
        got, again = lt.colsum(*args), lt.colsum(*args)
        assert lt.colsum.launches == before + 2
        got, again, ref = ((t,) if len(args) == 1 else t for t in (got, again, lt.colsum_plain(*args)))
        for g_, a_, r_, sm in zip(got, again, ref, sums):
            assert torch.equal(g_, a_)
            assert ((g_ - r_).abs() <= 1e-5 * sm + 1e-6).all()
    with pytest.raises(ValueError, match="multiple of 4"):
        lt.colsum(torch.zeros(8, 6, device="cuda"))
