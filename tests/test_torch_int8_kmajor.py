"""The int8 layer's weights stored K-major, against the JAX package, on the
CPU.

gemm_int8 and the whole-stack kernel run on Hopper's int8 tensor cores
through wgmma, which reads 8-bit operands only K-major: the port keeps each
weight's logical shape [K, N] (the JAX package's [in, out]) and its codes,
but stores it as the .t() view of an [N, K] buffer (the stack: [L, K, N]
over [L, N, K]). These tests hold the preps to the JAX package's codes and
scales bit for bit, the plain product on the K-major view to JAX's
`_dot_i8` plus bias, and the wrappers' layout checks (pure-Python helpers,
so they run here) to refusing any other layout. The kernel itself
runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rohm_tpu.models import PoseNet as FlaxPoseNet
from rohm_tpu.ops import kernel_common as jkc
from rohm_tpu.ops import prepare_posenet_int8 as jax_prepare_int8
from rohm_tpu.ops import transformer_layer_int8 as ji8
from rohm_tpu_torch.models import PoseNet
from rohm_tpu_torch.ops import transformer_layer_int8 as l8
from rohm_tpu_torch.utils.convert_flax import posenet_state_dict

torch.set_num_threads(1)

D, FF, LAYERS, HEADS = 32, 64, 2, 2
WEIGHTS = {"qkv": 0, "out": 3, "ff1": 8, "ff2": 11}  # index in prepare_layer_int8's tuple -> (K, N) below
SHAPES = {"qkv": (D, 3 * D), "out": (D, D), "ff1": (D, FF), "ff2": (FF, D)}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def preps():
    """A flax PoseNet init (biases woken), its port twin, and both
    packages' per-layer and stacked int8 preps."""
    rng = np.random.default_rng(0)
    model = FlaxPoseNet(latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS)
    z = np.zeros((1, 5, 294), np.float32)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), z, z, np.zeros(1, np.int32)))
    params = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a, params)
    port = PoseNet(latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS)
    port.load_state_dict(posenet_state_dict(params))
    return (jax_prepare_int8(params, num_layers=LAYERS), l8.prepare_posenet_int8(port),
            jax_prepare_int8(params, num_layers=LAYERS, mega=True), l8.prepare_posenet_int8(port, mega=True))


@pytest.mark.parametrize("name", list(WEIGHTS))
def test_prepared_weights_are_k_major_and_the_jax_codes(preps, name):
    """Each layer's weight is [K, N] with strides (1, K) (the .t() view of a
    contiguous [N, K] buffer); its int8 codes and its column scales equal
    the JAX package's prep exactly."""
    jprep, tprep, _, _ = preps
    i = WEIGHTS[name]
    for jl, tl in zip(jprep["layers"], tprep["layers"], strict=True):
        w, scale = tl[i], tl[i + 1]
        k, n = SHAPES[name]
        assert w.dtype == torch.int8 and tuple(w.shape) == (k, n) and w.stride() == (1, k)
        assert w.t().is_contiguous()
        np.testing.assert_array_equal(w.numpy(), np.asarray(jl[i]))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jl[i + 1]))


def test_stacked_prep_is_contiguous_and_equal(preps):
    """The mega prep hands the whole-stack kernel each int8 weight as an
    [L, K, N] stored K-major (strides (N K, 1, K): the .transpose(1, 2)
    view of a contiguous [L, N, K], what its tensor maps read), each other
    tensor contiguous; a layer's slice of a weight is the per-layer prep's
    K-major [K, N]. The values are the per-layer ones, and the JAX
    package's mega prep bit for bit."""
    _, tprep, jmega, tmega = preps
    stacked = tmega["layers_stacked"]
    assert len(stacked) == 16
    for i, t in enumerate(stacked):
        if i in WEIGHTS.values():
            k, n = t.shape[1:]
            assert t.stride() == (n * k, 1, k) and t.transpose(1, 2).is_contiguous()
            assert all(t[l].stride() == (1, k) for l in range(LAYERS))
        else:
            assert t.is_contiguous()
        assert torch.equal(t, torch.stack([lay[i] for lay in tprep["layers"]]))
        np.testing.assert_array_equal(t.float().numpy(), _np(jmega["layers_stacked"][i]))
    l8.check_stack_int8_weights(stacked)


@pytest.mark.parametrize("name", list(WEIGHTS))
def test_stack_weight_check_refuses_a_row_major_weight(preps, name):
    """check_stack_int8_weights, which the stack wrapper runs before a
    launch: the mega prep passes; the same values in a contiguous
    [L, K, N] (the layout of the stack's WMMA tiles before its GEMM phases
    took the wgmma loop) are refused, never copied per call."""
    stacked = list(preps[3]["layers_stacked"])
    i = WEIGHTS[name]
    stacked[i] = stacked[i].contiguous()
    with pytest.raises(ValueError, match="K-major"):
        l8.check_stack_int8_weights(tuple(stacked))


@pytest.mark.parametrize("name, mode", [("qkv", "bf16"), ("out", "f32"), ("ff1", "gelu"), ("ff2", "f32")])
def test_gemm_int8_plain_on_the_k_major_view_matches_dot_i8(name, mode):
    """The four products of a layer at a small width: JAX's `_quant_rows`,
    `_quant_cols` and `_dot_i8` plus bias against the port's codes (its
    `_quant_cols` returns the K-major view) and `gemm_int8_plain`. The
    int32 sums are exact and the rescale takes the same rounded steps, so
    the bf16 and f32 modes hold within one ulp of the output type (2^-7
    |ref| for bf16, the f32 spacing of |ref|); the gelu mode adds the
    tanh of XLA against torch's CPU code (tests/test_torch_ops.py's gate
    for gelu_tanh, 1e-6 absolute and relative)."""
    k, n = SHAPES[name]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, k)).astype(np.float32)
    w = (0.3 * rng.standard_normal((k, n))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    qx, rs = ji8._quant_rows(jnp.asarray(x))
    wq_j, cs_j = ji8._quant_cols(jnp.asarray(w))
    ref = ji8._dot_i8(qx, rs, wq_j, cs_j) + bias
    ref = {"bf16": lambda r: r.astype(jnp.bfloat16), "f32": lambda r: r, "gelu": jkc.gelu_tanh}[mode](ref)
    ref = _np(ref)

    wq, cs = l8._quant_cols(torch.from_numpy(w))
    assert wq.stride() == (1, k)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(cs.numpy(), np.asarray(cs_j))
    out = l8.gemm_int8_plain(torch.from_numpy(np.array(qx)), torch.from_numpy(np.array(rs)[:, 0]), wq, cs,
                             torch.from_numpy(bias), mode)
    assert out.dtype == (torch.bfloat16 if mode == "bf16" else torch.float32) and out.shape == (40, n)
    err = np.abs(out.float().numpy() - ref)
    if mode == "gelu":
        assert (err <= 1e-6 + 1e-6 * np.abs(ref)).all(), err.max()
    else:
        ulp = 2.0 ** -7 * np.abs(ref) if mode == "bf16" else np.spacing(np.abs(ref))
        assert (err <= ulp).all(), err.max()


def _operands(layout: str):
    """(qa, w_q) for the layout check: a K-major weight, a row-major one,
    or a K-major one outside the kernel's shape limits."""
    k, n = {"k-major": (32, 24), "row-major": (32, 24), "k=24": (24, 24), "n=6": (32, 6)}[layout]
    qa = torch.zeros(5, k, dtype=torch.int8)
    w = torch.zeros(n, k, dtype=torch.int8).t()
    return qa, (w.contiguous() if layout == "row-major" else w)


@pytest.mark.parametrize("layout, error", [("k-major", None), ("row-major", "K-major"), ("k=24", "multiple of 16"),
                                           ("n=6", "multiple of 16, N of 4")])
def test_gemm_int8_operand_check(layout, error):
    """check_gemm_int8_operands, which the wrapper runs before a launch:
    a K-major weight passes; a row-major one is refused (never copied per
    call); K must be a multiple of 16 (TMA's 16-byte row pitch), N of 4
    (the epilogue's four columns)."""
    qa, w = _operands(layout)
    if error is None:
        l8.check_gemm_int8_operands(qa, w)
        assert torch.equal(l8.gemm_int8_plain(qa, torch.ones(5), w, torch.ones(w.shape[1]),
                                              torch.zeros(w.shape[1]), "f32"), torch.zeros(5, w.shape[1]))
    else:
        with pytest.raises(ValueError, match=error):
            l8.check_gemm_int8_operands(qa, w)
