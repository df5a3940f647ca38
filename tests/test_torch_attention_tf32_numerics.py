"""The error budget of the port's f32 attention (3xTF32 on the tensor cores,
rohm_tpu_torch/ops/csrc/attention_tf32.cuh), forward and backward, emulated
on the CPU.

The routine behind `attention_f32` (K1) and the f32 mode of
`attention_train_fwd` (K6) runs both products as the f32 GEMM main loop
does (tests/test_torch_gemm_f32_numerics.py emulates that loop): each
operand element is split into big = rna(x) and small = x - big (cut to
TF32 as the tensor cores read it), and each m16n8k8 step issues three
products, small terms first, into a partial accumulator per 32-deep k-step
that is added to the running sum rounded to nearest. What is particular
to the attention is the order of the sums:
- Q.K^T runs over dh, and in a 32-deep k-step the k8 step kk takes dh
  8t + 2kk and 8t + 2kk + 1 for t = 0..3 (each lane's operands are
  contiguous), zeros past dh up to a multiple of 32;
- P.V runs over the keys in 8-key steps (the score accumulators become the
  A fragments in place: slot t is key 2t, slot t + 4 key 2t + 1) and
  32-key partials, zeros past S up to a multiple of 32;
- the softmax is f32: s (x scale in K6), the row's max, exp(s - max), its
  sum, p = e / sum rounded once, in K6 x the keep mask x inv_keep.
The emulation below does that arithmetic in torch (each mma an exact sum
of its 8 products and the accumulator, rounded once to f32) and holds it
under the kernels' gates against their plain versions (chip_smoke.py:
attention_f32 1e-5 max|v|; attention_train_fwd f32 1e-5 inv_keep max|v|)
on the layers' operands: an N(0, 1) input through a xavier in_proj
weight. One TF32 pass misses both gates. The tensor cores' own rounding of
their f32 sums is measured on the card (chip_smoke.py logs each kernel's
worst error as a fraction of its gate). The backward (the f32 mode of
`attention_train_bwd`) runs its seven products on the same two routines;
`emulate_bwd` below holds dq, dk and dv under 0.2 of chip_smoke.py's gate
(1e-5 of each one's max|ref|).
"""

import numpy as np
import pytest
import torch

from rohm_tpu_torch.ops import transformer_layer as l32
from rohm_tpu_torch.ops import transformer_layer_train as lt

H, B, IK = 2, 2, 1.0 / 0.9
TB_K, MMA_K = 32, 8


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x f32 rounded to TF32 (10 explicit mantissa bits), ties away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """x f32 cut to TF32 toward zero, as the tensor cores read an operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32_rna(x)
    return big, tf32_cut(x - big)


def mma_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N], K a multiple of 32, with the k8 steps
    taking columns 8i .. 8i + 7 of a (rows of b): the routine's 3xTF32
    (passes=3) or the big terms alone (passes=1)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    terms = ((as_, bb), (ab, bs), (ab, bb)) if passes == 3 else ((ab, bb),)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], TB_K):
        part = torch.zeros_like(acc)
        for k in range(k0, k0 + TB_K, MMA_K):
            for x, y in terms:  # one mma: exact products and sum, one rounding
                prod = x[..., k:k + MMA_K].double() @ y[..., k:k + MMA_K, :].double()
                part = (part.double() + prod).float()
        acc = acc + part
    return acc


def dh_order(dh: int) -> torch.Tensor:
    """The dh index of each k slot of Q.K^T, in the order the k8 steps take
    them (dh padded to a multiple of 32; indices >= dh read zeros)."""
    order = [kb + 8 * t + 2 * kk + c for kb in range(0, -(-dh // 32) * 32, 32)
             for kk in range(4) for t in range(4) for c in range(2)]
    return torch.tensor(order)


def pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def emulate(qkv: torch.Tensor, s_len: int, mask=None, passes: int = 3) -> torch.Tensor:
    """The routine's forward on qkv [B*S, 3D]: K1's (Q pre-scaled, mask
    None) or K6's f32 mode (scale after the product, the keep mask)."""
    rows, d3 = qkv.shape
    d = d3 // 3
    dh = d // H
    q, k, v = (t.reshape(rows // s_len, s_len, H, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
    order = dh_order(dh)
    q, k = (pad_last(t, int(order.max()) + 1)[..., order] for t in (q, k))
    s = mma_3xtf32(q, k.transpose(-1, -2), passes)
    if mask is not None:
        s = s * (1.0 / dh ** 0.5)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    if mask is not None:
        p = p * (mask.float() * IK)
    keys = -(-s_len // 32) * 32
    out = mma_3xtf32(pad_last(p, keys), pad_last(v.transpose(-1, -2), keys).transpose(-1, -2), passes)
    return out.transpose(1, 2).reshape(rows, d)


def _operands(s_len: int, dh: int, train: bool, seed: int):
    """qkv as a layer's QKV product makes it: an N(0, 1) input through a
    xavier in_proj weight (Q pre-scaled by 1/sqrt(dh) in K1), and K6's keep
    mask at dropout 0.1."""
    rng = np.random.default_rng(1000 * s_len + dh + seed)
    d = H * dh
    bound = (6.0 / (d + 3 * d)) ** 0.5
    w = torch.from_numpy(rng.uniform(-bound, bound, size=(3 * d, d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((B * s_len, d)).astype(np.float32))
    qkv = x @ w.t()
    if not train:
        qkv[:, :d] *= dh ** -0.5
        return qkv, None
    mask = torch.from_numpy((rng.random((B, H, s_len, s_len)) >= 0.1).astype(np.int8))
    return qkv, mask


def _gate_ratio(qkv, s_len, mask, passes):
    """The emulation's error against the kernel's plain version, as a
    fraction of the kernel's gate."""
    d = qkv.shape[1] // 3
    vmax = qkv[:, 2 * d:].abs().max().item()
    if mask is None:
        ref, gate = l32.attention_f32_plain(qkv, s_len, H), 1e-5 * vmax
    else:
        ref, gate = lt.attention_train_fwd_plain(qkv, mask, s_len, H, IK), 1e-5 * IK * vmax
    return (emulate(qkv, s_len, mask, passes) - ref).abs().max().item() / gate


def test_dh_order_takes_each_column_once():
    """Every dh index of a 32-deep k-step appears once, and each lane t
    reads 8 contiguous columns of it (8t .. 8t + 7)."""
    order = dh_order(64).reshape(2, 4, 4, 2)  # [k-step, kk, t, c]
    assert sorted(order.flatten().tolist()) == list(range(64))
    lanes = order.permute(0, 2, 1, 3).reshape(2, 4, 8)  # [k-step, t, 8 values]
    for ks in range(2):
        for t in range(4):
            assert lanes[ks, t].tolist() == list(range(32 * ks + 8 * t, 32 * ks + 8 * t + 8))


@pytest.mark.parametrize("train", [False, True], ids=["attention_f32", "attention_train_fwd"])
@pytest.mark.parametrize("dh", [128, 64])
@pytest.mark.parametrize("s_len", [144, 145, 177])
def test_3xtf32_forward_stays_under_the_gate(s_len, dh, train):
    """At the layers' lengths (144, 145) and one past a key tile (177):
    a small fraction of each gate, with room for the card's own rounding
    of its sums."""
    qkv, mask = _operands(s_len, dh, train, 0)
    ratio = _gate_ratio(qkv, s_len, mask, passes=3)
    assert ratio < 0.1, ratio


@pytest.mark.parametrize("train", [False, True], ids=["attention_f32", "attention_train_fwd"])
@pytest.mark.parametrize("s_len", [144, 145])
def test_one_tf32_pass_misses_the_gate(s_len, train):
    """The big terms alone (plain TF32) miss each gate: the gate tells
    3xTF32 from TF32."""
    qkv, mask = _operands(s_len, 128, train, 0)
    ratio = _gate_ratio(qkv, s_len, mask, passes=1)
    assert ratio > 1.5, ratio


# ---------------------------------------------------------------------------
# the backward (the f32 mode of attention_train_bwd, K7)
# ---------------------------------------------------------------------------


def pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[-2]))


def quad_order_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis as the query kernel forms D: lane t of a
    quad adds keys 8j + 2t and 8j + 2t + 1 in order of j, then the quad's
    four sums meet as (t0 + t1) + (t2 + t3)."""
    n = x.shape[-1]
    x = pad_last(x, -(-n // 8) * 8).reshape(*x.shape[:-1], -1, 4, 2)
    v = torch.zeros(*x.shape[:-3], 4, dtype=torch.float32)
    for j in range(x.shape[-3]):
        for c in range(2):
            v = v + x[..., j, :, c]
    return ((v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3]))[..., None]


def emulate_bwd(qkv: torch.Tensor, da: torch.Tensor, mask: torch.Tensor, s_len: int,
                passes: int = 3) -> torch.Tensor:
    """The two backward kernels' arithmetic on qkv [B*S, 3D] and dA
    [B*S, D] -> dqkv [B*S, 3D]. Query kernel: dpd = dA.V^T and s = Q.K^T
    over dh in the slot order of `scores`, the softmax as the forward forms
    it, D in the kernel's order, ds = p (dp - D) scale, dq = ds.K over the
    keys in 32-key partials. Key kernel: s^T = K.Q^T and dpd^T = V.dA^T
    give what the query kernel's products give (the emulated mma is
    symmetric), p^T from the query rows' stats; dv = pd^T.dA and dk =
    ds^T.Q over the queries in 32-query partials (past a 160-query tile the
    stored sums are read back, the same f32 values)."""
    rows, d3 = qkv.shape
    d = d3 // 3
    dh = d // H
    scale = 1.0 / dh ** 0.5
    q, k, v = (t.reshape(rows // s_len, s_len, H, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
    a = da.reshape(rows // s_len, s_len, H, dh).transpose(1, 2)
    order = dh_order(dh)
    qo, ko, vo, ao = (pad_last(t, int(order.max()) + 1)[..., order] for t in (q, k, v, a))
    keep = mask.float() * IK
    dp = mma_3xtf32(ao, vo.transpose(-1, -2), passes) * keep
    s = mma_3xtf32(qo, ko.transpose(-1, -2), passes) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    ds = (p * (dp - quad_order_sum(dp * p))) * scale
    n = -(-s_len // 32) * 32
    dq = mma_3xtf32(pad_last(ds, n), pad_rows(k, n), passes)
    dv = mma_3xtf32(pad_last((p * keep).transpose(-1, -2), n), pad_rows(a, n), passes)
    dk = mma_3xtf32(pad_last(ds.transpose(-1, -2), n), pad_rows(q, n), passes)
    return torch.cat([t.transpose(1, 2).reshape(rows, d) for t in (dq, dk, dv)], dim=-1)


def _bwd_gate_ratios(s_len: int, dh: int, passes: int) -> list[float]:
    """dq, dk and dv of the emulation against attention_train_bwd_plain
    (f32 mode), each as a fraction of chip_smoke.check_bwd's gate: 1e-5 of
    the part's max|ref|. dA as the out-projection's backward hands it: an
    N(0, 1) gradient through a xavier [D, D] weight."""
    qkv, mask = _operands(s_len, dh, True, 0)
    rng = np.random.default_rng(7 * s_len + dh)
    d = H * dh
    bound = (6.0 / (2 * d)) ** 0.5
    w = torch.from_numpy(rng.uniform(-bound, bound, size=(d, d)).astype(np.float32))
    da = torch.from_numpy(rng.standard_normal((B * s_len, d)).astype(np.float32)) @ w
    ref = lt.attention_train_bwd_plain(qkv, da, mask, s_len, H, IK, False)
    got = emulate_bwd(qkv, da, mask, s_len, passes)
    return [((got[:, i * d:(i + 1) * d] - ref[:, i * d:(i + 1) * d]).abs().max()
             / (1e-5 * ref[:, i * d:(i + 1) * d].abs().max())).item() for i in range(3)]


def test_quad_order_sum_takes_each_key_once():
    x = torch.arange(1.0, 146.0)
    assert quad_order_sum(x).item() == x.sum().item()


@pytest.mark.parametrize("dh", [128, 64])
@pytest.mark.parametrize("s_len", [144, 145, 177])
def test_3xtf32_backward_stays_under_the_gate(s_len, dh):
    """dq, dk and dv each under 0.2 of the gate at the layers' lengths and
    one past a 160-key tile, with room for the card's own rounding of its
    sums."""
    ratios = _bwd_gate_ratios(s_len, dh, passes=3)
    assert max(ratios) < 0.2, ratios


@pytest.mark.parametrize("s_len", [144, 145])
def test_one_tf32_pass_misses_the_backward_gate(s_len):
    """The big terms alone (plain TF32) miss the gate."""
    ratios = _bwd_gate_ratios(s_len, 128, passes=1)
    assert max(ratios) > 1.5, ratios
