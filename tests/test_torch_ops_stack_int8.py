"""The whole int8 stack in one launch (K5, `fused_encoder_stack_int8`) and
its `mega` prep against the JAX package, on the CPU.

The port's wrapper takes its plain version for a CPU tensor: each layer's
plain chain on the layer's slice of the stacked tensors. The JAX side runs
the Pallas program `_mega_kernel_int8` in interpret mode. The CUDA kernel
(csrc/encoder_stack_int8.cu) runs only on the card, where
`python3 chip_smoke.py` and tests/test_torch_cuda.py hold it against the
K3 chain (bit for bit) and the plain stack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rohm_tpu.models import PoseNet as FlaxPoseNet
from rohm_tpu.ops import posenet_apply_prepared as jax_apply_prepared
from rohm_tpu.ops import prepare_posenet_int8 as jax_prepare_int8
from rohm_tpu.ops.transformer_layer_int8 import fused_encoder_stack_int8 as jax_stack
from rohm_tpu_torch.models import PoseNet
from rohm_tpu_torch.ops import posenet_apply_prepared, prepare_posenet_int8
from rohm_tpu_torch.ops import transformer_layer_int8 as l8
from rohm_tpu_torch.utils.convert_flax import posenet_state_dict

torch.set_num_threads(1)

D, FF, LAYERS, HEADS = 32, 64, 2, 2
B, T = 2, 15


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def setup():
    """A flax PoseNet init, its port twin, the JAX and port mega preps and
    seeded inputs."""
    rng = np.random.default_rng(0)
    model = FlaxPoseNet(latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS)
    x = rng.standard_normal((B, T, 294)).astype(np.float32)
    cond = rng.standard_normal((B, T, 294)).astype(np.float32)
    t = np.array([5, 900], np.int32)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), x, cond, t))
    port = PoseNet(latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS)
    port.load_state_dict(posenet_state_dict(params))
    jprep = jax_prepare_int8(params, num_layers=LAYERS, mega=True)
    tprep = prepare_posenet_int8(port, mega=True)
    return params, port, jprep, tprep, x, cond, t


def test_layers_stacked_bit_exact(setup):
    """The mega prep's 16 stacked tensors are the JAX package's, bit for bit."""
    _, _, jprep, tprep, *_ = setup
    assert set(jprep) == set(tprep) and "layers" not in tprep and "layers_qattn" not in tprep
    assert len(jprep["layers_stacked"]) == len(tprep["layers_stacked"]) == 16
    for ja, ta in zip(jprep["layers_stacked"], tprep["layers_stacked"]):
        assert ta.shape[0] == LAYERS and tuple(ja.shape) == tuple(ta.shape)
        assert ta.dtype == (torch.int8 if ja.dtype == jnp.int8 else torch.float32)
        np.testing.assert_array_equal(np.asarray(ja.astype(jnp.float32)), ta.float().numpy())


@pytest.mark.parametrize("seq", [T + 1, 33])
def test_stack_plain_matches_pallas_interpret(setup, seq):
    """The stack on the mega prep (weights stored K-major) against the
    Pallas program in interpret mode; 33 rows a sequence leave ragged
    16-row chunks."""
    _, _, jprep, tprep, *_ = setup
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((B, seq, D)), jnp.bfloat16)
    ref = jax_stack(x, jprep["layers_stacked"], num_heads=HEADS, interpret=True)
    out = l8.fused_encoder_stack_int8(torch.from_numpy(_np(x)).to(torch.bfloat16), tprep["layers_stacked"], HEADS)
    assert out.dtype == torch.bfloat16 and out.shape == (B, seq, D)
    # The per-layer int8 gates (tests/test_torch_ops.py): the same
    # arithmetic, but the f32 sums of the attention and LayerNorm run in
    # another order, which can flip a bf16 rounding (2^-8 relative) or an
    # int8 code (amax/127 of its row). Over these two layers the flips stay
    # inside the one-layer gates, far inside the kernels' envelope against
    # flax (tests/test_ops.py: 0.3 / 5e-2).
    dev = np.abs(out.float().numpy() - _np(ref))
    assert dev.max() < 6e-2 and dev.mean() < 5e-3, (dev.max(), dev.mean())


def test_posenet_apply_prepared_mega_matches_jax(setup):
    _, _, jprep, tprep, x, cond, t = setup
    ref = np.asarray(jax_apply_prepared(jprep, x, cond, jnp.asarray(t), num_heads=HEADS, interpret=True))
    out = posenet_apply_prepared(tprep, torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t),
                                 num_heads=HEADS).numpy()
    # the int8 gates of tests/test_torch_models.py for the per-layer prep
    dev = np.abs(out - ref)
    assert dev.max() < 6e-2 and dev.mean() < 1e-2, (dev.max(), dev.mean())
    np.testing.assert_array_equal(out[..., :22], cond[..., :22])


def test_a_layer_of_the_mega_prep_is_the_per_layer_prep(setup):
    """Each layer's slice of the stacked tensors equals the per-layer
    prep's tuple, the weights in its K-major layout: the K3 chain's layout
    check takes them as they are."""
    _, port, _, tprep, *_ = setup
    stacked = tprep["layers_stacked"]
    for l, layer in enumerate(prepare_posenet_int8(port)["layers"]):
        for i, (s, t) in enumerate(zip(stacked, layer, strict=True)):
            assert torch.equal(s[l], t) and s[l].stride() == t.stride(), i
        for i in l8.STACKED_WEIGHTS:
            l8.check_gemm_int8_operands(torch.zeros(3, stacked[i].shape[1], dtype=torch.int8), stacked[i][l])


def test_mega_and_per_layer_preps_bit_identical_on_cpu(setup):
    """On the CPU both preps run the same plain chain per layer."""
    _, port, _, tprep, x, cond, t = setup
    args = (torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t))
    mega = posenet_apply_prepared(tprep, *args, num_heads=HEADS)
    per_layer = posenet_apply_prepared(prepare_posenet_int8(port), *args, num_heads=HEADS)
    assert torch.equal(mega, per_layer)


def test_layers_stacked_dispatch_takes_precedence(setup, monkeypatch):
    """"layers_stacked" goes to the stack kernel before "layers_qattn" and
    "layers" are looked at (as rohm_tpu/ops/transformer_layer_bf16.py
    dispatches), and `mega` takes precedence over `qattn` in the prep."""
    _, port, _, tprep, x, cond, _ = setup
    both = prepare_posenet_int8(port, qattn=True, mega=True)
    assert "layers_stacked" in both and "layers_qattn" not in both
    calls = []
    stack, layers_fn = l8.fused_encoder_stack_int8, l8.fused_encoder_layers_int8

    def stack_spy(seq, stacked, num_heads):
        calls.append("stack")
        return stack(seq, stacked, num_heads)

    def layers_spy(seq, layers, num_heads, qattn=False):  # one entry per layer of the chain
        calls.extend(["qattn" if qattn else "layer"] * len(layers))
        return layers_fn(seq, layers, num_heads, qattn=qattn)

    monkeypatch.setattr(l8, "fused_encoder_stack_int8", stack_spy)
    monkeypatch.setattr(l8, "fused_encoder_layers_int8", layers_spy)
    tx, tc = torch.from_numpy(x), torch.from_numpy(cond)
    qattn = prepare_posenet_int8(port, qattn=True)
    mixed = {**qattn, "layers_stacked": tprep["layers_stacked"], "layers": qattn["layers_qattn"]}
    for prep in (tprep, mixed, qattn, prepare_posenet_int8(port)):
        posenet_apply_prepared(prep, tx, tc, 5, num_heads=HEADS)
    assert calls == ["stack", "stack"] + ["qattn"] * LAYERS + ["layer"] * LAYERS


def test_stack_cpu_tensors_take_the_plain_version(setup):
    _, _, _, tprep, *_ = setup
    counters = (l8.fused_encoder_stack_int8, l8.gemm_int8, l8.quant_rows_int8)
    before = [fn.launches for fn in counters]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((B, T + 1, D)).astype(np.float32))
    stacked = tprep["layers_stacked"]
    torch.testing.assert_close(l8.fused_encoder_stack_int8(x, stacked, HEADS),
                               l8.fused_encoder_stack_int8_plain(x, stacked, HEADS), rtol=0, atol=0)
    assert [fn.launches for fn in counters] == before


def test_stack_non_cpu_tensors_never_fall_back(setup):
    _, _, _, tprep, *_ = setup
    meta = torch.empty(B, T + 1, D, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        l8.fused_encoder_stack_int8(meta, tprep["layers_stacked"], HEADS)
