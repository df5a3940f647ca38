"""The training layer of the port (`--fused_train=float32|bfloat16`) against
the JAX package's custom-VJP Pallas layer (rohm_tpu/ops/
transformer_layer_train.py: K6 forward, K7 backward) in interpret mode, on
the CPU, where the port's kernel wrappers take their plain versions.

Both sides get the same inputs from numpy and the same dropout masks: the
JAX package's `gen_dropout_masks` (rbg bits torch cannot reproduce) are
handed to the port. The CUDA kernels run only on the card: `python3
chip_smoke.py` holds each against these plain versions at the training
shapes, and tests/test_torch_cuda.py does so at a small size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rohm_tpu.models.posenet import PoseNet as FlaxPoseNet
from rohm_tpu.ops import transformer_layer_train as jt
from rohm_tpu_torch.models import PoseNet
from rohm_tpu_torch.models.blocks import TransformerEncoderLayer
from rohm_tpu_torch.ops import transformer_layer_train as lt
from rohm_tpu_torch.utils.convert_flax import posenet_flax_params, posenet_state_dict

torch.set_num_threads(1)

B, S, D, F, H = 4, 9, 32, 64, 4  # as tests/test_ops_train.py
DH = D // H


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _flax_layer(seed: int) -> dict:
    """A random flax-layout encoder-layer scope (numpy), biases nonzero."""
    rng = np.random.default_rng(seed)

    def n(shape, sc=0.3):
        return (sc * rng.standard_normal(shape)).astype(np.float32)

    attn = {name: {"kernel": n((D, H, DH)), "bias": n((H, DH), 0.05)} for name in ("query", "key", "value")}
    attn["out"] = {"kernel": n((H, DH, D)), "bias": n((D,), 0.05)}
    return {
        "MultiHeadDotProductAttention_0": attn,
        "LayerNorm_0": {"scale": 1.0 + n((D,), 0.1), "bias": n((D,), 0.1)},
        "Dense_0": {"kernel": n((D, F)), "bias": n((F,), 0.05)},
        "Dense_1": {"kernel": n((F, D)), "bias": n((D,), 0.05)},
        "LayerNorm_1": {"scale": 1.0 + n((D,), 0.1), "bias": n((D,), 0.1)},
    }


def _wrap(layer_tree: dict) -> dict:
    """A one-layer flax param tree -> the flat keys posenet_state_dict maps
    (the embeddings and head are dummies, dropped again)."""
    flat = {}
    for k, v in _leaves(layer_tree).items():
        flat[f"params/layer_0/{k}"] = v
    z = np.zeros((D, D), np.float32)
    for name in ("Dense_0", "Dense_1", "input_process", "input_process_cond", "output_process"):
        flat[f"params/{name}/kernel"], flat[f"params/{name}/bias"] = z, z[0]
    return flat


def _torch_layer(layer_tree: dict) -> TransformerEncoderLayer:
    sd = posenet_state_dict(_wrap(layer_tree), num_layers=1)
    prefix = "seqTransEncoder.layers.0."
    layer = TransformerEncoderLayer(D, H, F)
    layer.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    return layer


def _flax_grads(layer: TransformerEncoderLayer) -> dict:
    """The torch layer's .grad -> flax leaves {"path/to/leaf": array}."""
    pn = PoseNet(latent_dim=D, ff_size=F, num_layers=1, num_heads=H)
    sd = {k: torch.zeros_like(v) for k, v in pn.state_dict().items()}
    for name, p in layer.named_parameters():
        sd[f"seqTransEncoder.layers.0.{name}"] = p.grad
    flat = posenet_flax_params(sd, H)
    return {k[len("params/layer_0/"):]: v for k, v in flat.items() if k.startswith("params/layer_0/")}


def _leaves(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _jax_masks(seed: int, p: float):
    key = jax.random.key_data(jax.random.key(seed, impl="rbg"))
    masks = jt.gen_dropout_masks(key, B, S, D, F, H, p)
    return key, tuple(torch.from_numpy(np.array(m)) for m in masks)


def _both(p: float, dtype: str, seed: int = 0):
    """The JAX fused layer (value, d/dx, d/dleaves of sum(y * w)) and the
    port's fused_train_layer on the same inputs and masks."""
    layer_tree = _flax_layer(seed)
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((B, S, D)).astype(np.float32)
    key, masks = _jax_masks(seed + 7, p)
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def loss(tree, xx):
        y = jt.fused_train_layer(tree, xx, key, num_heads=H, dropout_p=p, dtype=jdtype)
        return jnp.sum(y * w), y

    (_, y_j), (g_tree, gx_j) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, layer_tree), jnp.asarray(x))

    layer = _torch_layer(layer_tree)
    xt = _t(x).requires_grad_()
    y_t = lt.fused_train_layer(layer, xt, masks, H, p, dtype)
    (y_t * _t(w)).sum().backward()
    return (np.asarray(y_j), np.asarray(gx_j), _leaves(g_tree)), (y_t.detach().numpy(), xt.grad.numpy(), _flax_grads(layer))


@pytest.mark.parametrize("p", [0.0, 0.25])
def test_f32_layer_matches_jax(p):
    """y, dx and all 16 flax leaves, f32 mode: the same arithmetic in
    another summation order. The JAX test's own gates (tests/
    test_ops_train.py: 2e-5 forward, 5e-4 gradients) hold here too."""
    (y_j, gx_j, g_j), (y_t, gx_t, g_t) = _both(p, "float32")
    np.testing.assert_allclose(y_t, y_j, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(gx_t, gx_j, atol=5e-4, rtol=1e-4)
    assert sorted(g_t) == sorted(g_j) and len(g_j) == 16
    for k in g_j:
        np.testing.assert_allclose(g_t[k], g_j[k], atol=5e-4, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("p", [0.0, 0.25])
def test_bf16_layer_matches_jax(p):
    """bf16 mode against the JAX bf16 mode: every product operand rounds to
    bf16 at the same places on both sides, but the f32 values being
    rounded differ in their last bits (summation order), which flips an
    occasional rounding by one bf16 ulp (2^-8 relative). Measured over two
    seeds and both p: at most 1.2e-4 of an output's max. The gate, 2e-3 of
    each output's max, sits well below the bf16-vs-f32 gap (>= 8.9e-3 of
    the max on y and dx), so a rounding point missed or added fails it."""
    (y_j, gx_j, g_j), (y_t, gx_t, g_t) = _both(p, "bfloat16", seed=1)
    for name, got, ref in [("y", y_t, y_j), ("dx", gx_t, gx_j)] + [(k, g_t[k], g_j[k]) for k in g_j]:
        scale = np.abs(ref).max()
        err = np.abs(got - ref).max()
        assert err <= 2e-3 * scale + 1e-6, f"{name}: max err {err} vs scale {scale}"
    assert len(g_j) == 16


def test_plain_backward_matches_autograd_of_plain_forward():
    """The hand-written backward chain (K7's arithmetic) against
    torch.autograd through the plain forward chain, f32, p = 0.25: the same
    function differentiated two ways (f32 sums in other orders)."""
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(D, H, F)
    with torch.no_grad():
        for prm in layer.parameters():
            if prm.dim() == 1:
                prm.add_(0.1 * torch.randn(prm.shape))
    g = torch.Generator().manual_seed(1)
    masks = lt.gen_dropout_masks(g, B, S, D, F, H, 0.25)
    x = torch.randn(B, S, D, generator=g, requires_grad=True)
    w = torch.randn(B, S, D, generator=g)
    (lt.fused_train_layer(layer, x, masks, H, 0.25, "float32") * w).sum().backward()
    hand = [p.grad.clone() for p in lt.layer_params(layer)] + [x.grad.clone()]
    layer.zero_grad()
    x.grad = None
    y, _ = lt.layer_train_fwd(x.reshape(B * S, D), lt.layer_params(layer), lt.flat_masks(masks, B * S),
                              S, H, 1.0 / 0.75, False, lt.PLAIN)
    (y.reshape(B, S, D) * w).sum().backward()
    auto = [p.grad for p in lt.layer_params(layer)] + [x.grad]
    for a, b in zip(hand, auto):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5)


def test_module_forward_train_is_the_reference():
    """TransformerEncoderLayer.forward_train (flax's train-mode composition:
    two-pass LayerNorm, torch's exact erf) against the fused layer's f32
    forward (one-pass LayerNorm, A-S erf): ~1e-6 apart on these inputs."""
    layer = _torch_layer(_flax_layer(3))
    _, masks = _jax_masks(5, 0.25)
    x = _t(np.random.default_rng(4).standard_normal((B, S, D)))
    ref = layer.forward_train(x, masks, 0.25)
    got = lt.fused_train_layer(layer, x, masks, H, 0.25, "float32")
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-5)


def test_pieces_match_the_tpu_kernels_formulas():
    """gelu and its derivative (A-S erf, x / sqrt(2)), the one-pass
    LayerNorm and its backward, against the JAX kernel's own helpers:
    the same f32 operations (exp and rsqrt differ by ulps)."""
    x = np.linspace(-6, 6, 1201).astype(np.float32)
    np.testing.assert_allclose(lt.gelu_as(_t(x)).numpy(), np.asarray(jt._gelu_erf(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(lt.gelu_grad_as(_t(x)).numpy(),
                               np.asarray(jt._gelu_erf_grad(jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    rng = np.random.default_rng(0)
    r, gamma, beta, dy = (rng.standard_normal(s).astype(np.float32) for s in ((7, D), (D,), (D,), (7, D)))
    y_j, n_j, rs_j = jt._ln_fwd(jnp.asarray(r), jnp.asarray(gamma), jnp.asarray(beta))
    y_t, n_t, rs_t = lt.layernorm_train_fwd_plain(_t(r), torch.zeros(7, D), _t(gamma), _t(beta))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-6)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=2e-6)
    np.testing.assert_allclose(rs_t.numpy(), np.asarray(rs_j)[:, 0], rtol=2e-6)
    dr_j, _, _ = jt._ln_bwd(jnp.asarray(dy), n_j, rs_j, jnp.asarray(gamma))
    dr_t, _ = lt.layernorm_train_bwd_plain(_t(dy), n_t, rs_t, _t(gamma))
    np.testing.assert_allclose(dr_t.numpy(), np.asarray(dr_j), atol=2e-6)


def test_dropout_masks():
    g = torch.Generator().manual_seed(0)
    masks = lt.gen_dropout_masks(g, B, S, D, F, H, 0.1)
    assert [tuple(m.shape) for m in masks] == [(B, H, S, S), (B, S, D), (B, S, F), (B, S, D)]
    assert all(m.dtype == torch.int8 for m in masks)
    frac = torch.cat([m.flatten().float() for m in masks]).mean().item()
    assert 0.87 < frac < 0.93  # keep-prob 0.9 over ~3.6k draws
    again = lt.gen_dropout_masks(torch.Generator().manual_seed(0), B, S, D, F, H, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(masks, again))
    assert all(bool((m == 1).all()) for m in lt.gen_dropout_masks(g, B, S, D, F, H, 0.0))


@pytest.mark.parametrize("name", ["gemm", "attn_fwd", "attn_bwd", "ln_fwd", "ln_bwd", "colsum"])
def test_wrappers_never_fall_back_off_the_cpu(name):
    """A tensor that is not on the CPU goes to the kernel or raises: a
    `meta` tensor (no CUDA here) is refused, never computed plainly."""
    m = torch.empty(2 * S, D, device="meta")
    qkv = torch.empty(2 * S, 3 * D, device="meta")
    mask = torch.empty(2, H, S, S, dtype=torch.int8, device="meta")
    vec = torch.empty(D, device="meta")
    calls = {
        "gemm": lambda: lt.gemm_train(m, m, a_t=True),
        "attn_fwd": lambda: lt.attention_train_fwd(qkv, mask, S, H),
        "attn_bwd": lambda: lt.attention_train_bwd(qkv, m, mask, S, H),
        "ln_fwd": lambda: lt.layernorm_train_fwd(m, m, vec, vec),
        "ln_bwd": lambda: lt.layernorm_train_bwd(m, m, vec[:1].expand(2 * S), vec),
        "colsum": lambda: lt.colsum(m),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[name]()


def test_posenet_apply_train_matches_jax():
    """The whole training forward (embeddings, input dropout, 2 fused f32
    layers, head) and every parameter gradient against the JAX package's
    posenet_apply_train, with its masks: keys = split(dropout_key, L + 1),
    the input keep-mask from keys[0], one gen_dropout_masks per layer."""
    p, layers, t_len = 0.25, 2, S - 1
    model = FlaxPoseNet(latent_dim=D, ff_size=F, num_layers=layers, num_heads=H, dropout=p)
    rng = np.random.default_rng(0)
    x_t, cond = (rng.standard_normal((B, t_len, 294)).astype(np.float32) for _ in range(2))
    t = np.array([3, 500, 999, 0], np.int32)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), x_t, cond, t))
    params = jax.tree.map(  # wake the zero-initialised biases
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a, params)
    drop_key = jax.random.key(9, impl="rbg")
    keys = jax.random.split(drop_key, layers + 1)
    keep = np.array(jax.random.bernoulli(keys[0], 1.0 - p, (B, t_len + 1, D)))
    layer_masks = [tuple(torch.from_numpy(np.array(m)) for m in jt.gen_dropout_masks(
        jax.random.key_data(keys[i + 1]), B, t_len + 1, D, F, H, p)) for i in range(layers)]
    wout = rng.standard_normal((B, t_len, 294)).astype(np.float32)

    def loss(prm):
        out = jt.posenet_apply_train(prm, jnp.asarray(x_t), jnp.asarray(cond), jnp.asarray(t), drop_key,
                                     num_layers=layers, num_heads=H, dropout_p=p, dtype=jnp.float32)
        return jnp.sum(out * wout), out

    (_, out_j), g_j = jax.value_and_grad(loss, has_aux=True)(jax.tree.map(jnp.asarray, params))

    port = PoseNet(latent_dim=D, ff_size=F, num_layers=layers, num_heads=H, dropout=p)
    port.load_state_dict(posenet_state_dict(params, num_layers=layers))
    out_t = lt.posenet_apply_train(port, _t(x_t), _t(cond), torch.from_numpy(t).long(),
                                   (torch.from_numpy(keep), layer_masks), "float32")
    (out_t * _t(wout)).sum().backward()
    # value: f32 throughout, ~1e-5 after two layers; gradients: summed over
    # B x T of an O(1) readout, 5e-4 absolute as the layer test
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=5e-5, rtol=1e-5)
    ref = posenet_state_dict(jax.tree.map(np.asarray, g_j), num_layers=layers)
    for name, prm in port.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), ref[name].numpy(), atol=5e-4, rtol=1e-4, err_msg=name)
