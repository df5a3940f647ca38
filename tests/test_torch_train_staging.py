"""The bf16 mode of the port's training layer keeps its product operands in
device memory as bf16: the four weight matrices cast once per layer call
(`cast_weight_mats`), the activations cast once where they are made
(the bf16 copy that a product's epilogue, the attention backward or a
LayerNorm writes, or `round_bf16` for x and attn). Rounding to
nearest even is idempotent, so this staging must not change a single bit of
what the layer computes: these tests hold the staged chain against the
formulation that rounds f32 operands inside every product, and against the
JAX package's bf16 layer (rohm_tpu/ops/transformer_layer_train.py, Pallas
in interpret mode), on the CPU, where the wrappers take their plain
versions. They also hold the LayerNorms' bf16 copies to round_bf16, count
the chain's casts, and hold the split-K planner of the wgmma GEMM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rohm_tpu.ops import transformer_layer_train as jt
from rohm_tpu_torch.ops import transformer_layer_train as lt
from tests.test_torch_ops_train import B, D, F, H, S, _flax_grads, _flax_layer, _jax_masks, _leaves, _t, _torch_layer

torch.set_num_threads(1)


def _f32_operand_gemm(*args, out="f32", **kw):
    """The product as before staging: f32 operands, rounded to bf16 inside
    the product (gemm_train_plain's c()), f32 results only."""
    res = lt.gemm_train_plain(*args, **kw)
    return (res, res) if out == "both" else res


F32_OPERANDS = lt.PLAIN._replace(gemm=_f32_operand_gemm, cast=lambda t: t)


def _chain(kernels, params, x, dy, masks, p):
    ik = 1.0 / (1.0 - p) if p > 0 else 1.0
    fm = lt.flat_masks(masks, B * S)
    y, saved = lt.layer_train_fwd(x, params, fm, S, H, ik, True, kernels)
    dx, grads = lt.layer_train_bwd(dy, saved, params, fm, S, H, ik, True, kernels)
    return y, dx, grads, saved


@pytest.mark.parametrize("p", [0.0, 0.25])
def test_staged_bf16_operands_change_no_bit(p):
    """The plain chain in the bf16 mode on staged operands (bf16 weights
    and activations) against the same chain rounding f32 operands inside
    every product: the forward output, dx and the 12 parameter gradients
    are equal bit for bit; the staged operands really are bf16; and the
    output is the JAX package's bf16 layer within the layer test's gate
    (2e-3 of its max, tests/test_torch_ops_train.py)."""
    tree = _flax_layer(2)
    layer = _torch_layer(tree)
    params = tuple(t.detach() for t in lt.layer_params(layer))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    key, masks = _jax_masks(13, p)
    xt, dyt = _t(x).reshape(B * S, D), _t(dy).reshape(B * S, D)

    y, dx, grads, saved = _chain(lt.PLAIN, lt.cast_weight_mats(params), xt, dyt, masks, p)
    y0, dx0, grads0, _ = _chain(F32_OPERANDS, params, xt, dyt, masks, p)
    for got, ref in zip((y, dx, *grads), (y0, dx0, *grads0)):
        assert got.dtype == torch.float32 and torch.equal(got, ref)
    xc, _, attn, y1c, _, _, _, gld, _, _ = saved
    assert all(t.dtype == torch.bfloat16 for t in (xc, attn, y1c, gld))
    assert all(lt.cast_weight_mats(params)[i].dtype == torch.bfloat16 for i in lt.WEIGHT_MATS)

    y_j = np.asarray(jt.fused_train_layer(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), key,
                                          num_heads=H, dropout_p=p, dtype=jnp.bfloat16))
    err = np.abs(y.reshape(B, S, D).numpy() - y_j).max()
    assert err <= 2e-3 * np.abs(y_j).max(), err


def _f32_qkv_gemm(*args, out="f32", gelu=0, **kw):
    """The products of the chain before bf16 qkv: the QKV and dattn
    products hand over their f32 results (rounded inside the attention
    kernels); the gelu product keeps its bf16 operand."""
    return lt.gemm_train_plain(*args, gelu=gelu, out="f32" if out == "operand" and not gelu else out, **kw)


def _rounded_dqkv(*args):
    """The attention backward before its bf16 copy: dqkv f32, then cast."""
    dqkv = lt.attention_train_bwd_plain(*args)[0]
    return dqkv, lt.round_bf16_plain(dqkv)


F32_QKV = lt.PLAIN._replace(gemm=_f32_qkv_gemm, attn_bwd=_rounded_dqkv)


@pytest.mark.parametrize("p", [0.0, 0.25])
def test_bf16_qkv_and_dqkv_copy_change_no_bit(p):
    """qkv and dattn in memory as bf16 (the products' bf16 copies) and the
    attention backward's own bf16 copy of dqkv, against the chain that
    keeps qkv and dattn f32 and casts dqkv with round_bf16: the forward
    output, dx and the 12 parameter gradients are equal bit for bit, and
    the staged qkv really is bf16."""
    layer = _torch_layer(_flax_layer(4))
    params = lt.cast_weight_mats(tuple(t.detach() for t in lt.layer_params(layer)))
    rng = np.random.default_rng(12)
    xt, dyt = (_t(rng.standard_normal((B * S, D)).astype(np.float32)) for _ in range(2))
    _, masks = _jax_masks(14, p)
    y, dx, grads, saved = _chain(lt.PLAIN, params, xt, dyt, masks, p)
    y0, dx0, grads0, saved0 = _chain(F32_QKV, params, xt, dyt, masks, p)
    assert saved[1].dtype == torch.bfloat16 and saved0[1].dtype == torch.float32
    for got, ref in zip((y, dx, *grads), (y0, dx0, *grads0)):
        assert got.dtype == torch.float32 and torch.equal(got, ref)


def test_outputs_of_a_product():
    """`out` of a product: "operand" is the bf16 rounding of the f32 result
    in the bf16 mode and the f32 result itself in the f32 mode; "both" is
    the pair; the gelu product returns (out, pre-gelu h) either way."""
    g = torch.Generator().manual_seed(0)
    a, w = torch.randn(2 * S, D, generator=g), torch.randn(F, D, generator=g)
    bias, mask = torch.randn(F, generator=g), (torch.rand(2 * S, F, generator=g) < 0.9).to(torch.int8)
    for bf16 in (True, False):
        ops = (lt.round_bf16(a), w.to(torch.bfloat16)) if bf16 else (a, w)
        kw = dict(b_t=True, bf16=bf16, bias=bias, mask=mask, inv_keep=1.25)
        v32 = lt.gemm_train(*ops, **kw)
        v_op = lt.gemm_train(*ops, **kw, out="operand")
        both = lt.gemm_train(*ops, **kw, out="both")
        assert torch.equal(v_op, v32.to(torch.bfloat16) if bf16 else v32)
        assert torch.equal(both[0], v32) and torch.equal(both[1], v_op)
        (gv, h), (gv32, h32) = (lt.gemm_train(*ops, **kw, gelu=1, out=o) for o in ("operand", "f32"))
        assert torch.equal(h, h32) and torch.equal(gv, gv32.to(torch.bfloat16) if bf16 else gv32)
    x = torch.randn(3, 5, generator=g)
    assert torch.equal(lt.round_bf16(x), x.to(torch.bfloat16))


# the weight gradients of one layer at the training shapes (B*S = 9280
# rows): dW2 = df^T gld, dW1 = dh1^T y1, dWo = do^T attn, dWqkv = dqkv^T x
WEIGHT_GRADS = [(512, 1024), (1024, 512), (512, 512), (1536, 512)]


@pytest.mark.parametrize("m,n", WEIGHT_GRADS)
def test_split_k_plan_fills_the_card(m, n):
    """plan_splits for the wgmma tile (128 x 128, 64-deep k-steps) on an
    H100's 132 SMs: every chunk a whole number of k-steps and at least 8 of
    them, the splits cover K with none empty, and tiles x splits reaches
    two blocks per SM."""
    k, sms = 64 * 145, 132
    bm, bn, bk = lt.GEMM_TILES[True]
    splits, chunk = lt.plan_splits(m, n, k, (bm, bn, bk), sms)
    assert chunk % bk == 0 and chunk >= 8 * bk
    assert splits * chunk >= k > (splits - 1) * chunk
    assert -(-m // bm) * -(-n // bn) * splits >= 2 * sms
    assert lt.plan_splits(m, n, k, (bm, bn, bk), sms) == (splits, chunk)  # a pure function


@pytest.mark.parametrize("part", ["forward", "backward"])
def test_plain_layernorm_bf16_copies(part):
    """The plain LayerNorms' bf16 copies (`out_bf16`: y forward, the
    masked gradient backward) are round_bf16_plain of their own f32
    outputs, and asking for them changes no other output."""
    g = torch.Generator().manual_seed(3)
    a, b, dy = (torch.randn(2 * S, D, generator=g) for _ in range(3))
    gamma, beta = 1.0 + 0.1 * torch.randn(D, generator=g), 0.1 * torch.randn(D, generator=g)
    mask = (torch.rand(2 * S, D, generator=g) < 0.9).to(torch.int8)
    _, norm, rstd = lt.layernorm_train_fwd_plain(a, b, gamma, beta)
    if part == "forward":
        *outs, copy = lt.layernorm_train_fwd(a, b, gamma, beta, out_bf16=True)
        ref = lt.layernorm_train_fwd(a, b, gamma, beta)
        f32 = outs[0]
    else:
        *outs, copy = lt.layernorm_train_bwd(dy, norm, rstd, gamma, mask, 1.25, out_bf16=True)
        ref = lt.layernorm_train_bwd(dy, norm, rstd, gamma, mask, 1.25)
        f32 = outs[1]
    assert copy.dtype == torch.bfloat16 and torch.equal(copy, lt.round_bf16_plain(f32))
    assert len(outs) == len(ref) and all(torch.equal(o, r) for o, r in zip(outs, ref))


class _Counted:
    """A kernel function that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("p", [0.0, 0.25])
def test_bf16_chain_casts_twice_and_matches_jax(p):
    """The bf16 layer through fused_train_layer with a counting Kernels
    tuple of the plain versions: `cast` (round_bf16) runs twice in the
    forward (x, attn) and never in the backward, since LN1's forward and
    both LayerNorm backwards hand over y1, df and do in bf16; the f32 mode
    never casts. The layer's output, dx and its 12 parameter gradients
    (the 16 flax leaves) hold the JAX package's bf16 layer to
    tests/test_torch_ops_train.py's gate, 2e-3 of each output's max."""
    tree = _flax_layer(5)
    rng = np.random.default_rng(15)
    x, w = (rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(2))
    key, masks = _jax_masks(16, p)

    def loss(t, xx):
        y = jt.fused_train_layer(t, xx, key, num_heads=H, dropout_p=p, dtype=jnp.bfloat16)
        return jnp.sum(y * w), y

    (_, y_j), (g_tree, gx_j) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))

    for dtype in ("bfloat16", "float32"):
        cast, ln_fwd, ln_bwd = (_Counted(f) for f in (lt.PLAIN.cast, lt.PLAIN.ln_fwd, lt.PLAIN.ln_bwd))
        kernels = lt.PLAIN._replace(cast=cast, ln_fwd=ln_fwd, ln_bwd=ln_bwd)
        layer = _torch_layer(tree)
        xt = _t(x).requires_grad_()
        y = lt.fused_train_layer(layer, xt, masks, H, p, dtype, kernels)
        assert (cast.calls, ln_fwd.calls, ln_bwd.calls) == ((2, 2, 0) if dtype == "bfloat16" else (0, 2, 0))
        (y * _t(w)).sum().backward()
        assert (cast.calls, ln_fwd.calls, ln_bwd.calls) == ((2, 2, 2) if dtype == "bfloat16" else (0, 2, 2))
    # the last layer run is the f32 one: compare the bf16 one, run again
    layer = _torch_layer(tree)
    xt = _t(x).requires_grad_()
    y = lt.fused_train_layer(layer, xt, masks, H, p, "bfloat16", lt.PLAIN)
    (y * _t(w)).sum().backward()
    g_j, g_t = _leaves(g_tree), _flax_grads(layer)
    assert sorted(g_t) == sorted(g_j) and len(g_j) == 16
    for name, got, ref in [("y", y.detach().numpy(), np.asarray(y_j)), ("dx", xt.grad.numpy(), np.asarray(gx_j))] + \
            [(k, g_t[k], g_j[k]) for k in g_j]:
        err, scale = np.abs(got - ref).max(), np.abs(ref).max()
        assert err <= 2e-3 * scale + 1e-6, f"{name}: max err {err} vs scale {scale}"
