"""The error budget of the port's f32 GEMM main loop (3xTF32 on the tensor
cores, rohm_tpu_torch/ops/csrc/f32_gemm.cuh), emulated on the CPU.

The kernel splits each operand element x in registers into two TF32 values,
big = rna(x) (round to 10 explicit mantissa bits, ties away from zero: the
bits of cvt.rna.tf32.f32) and small = x - big, which the tensor cores cut
to TF32 toward zero as they read it, and issues three products per fragment
pair, small terms first: a_small.b_big, a_big.b_small, a_big.b_big, into a
partial accumulator per 32-deep k-step that is added to the running sum
rounded to nearest. The emulation below does the same arithmetic in torch:
TF32 rounding and cutting by bit masking, each m16n8k8 product as an exact
sum of its 8 terms and the accumulator rounded once to f32. It holds the result under both callers' gates against the
plain f32 product (chip_smoke.py: gemm_train's 2e-5 sum|a||b|, gemm_f32's
1e-5 max|ref| + 1e-6) at the layers' K values, and shows that one TF32
pass would miss gemm_f32's. The tensor cores' own rounding of their f32 sums is
measured on the card (chip_smoke.py logs each product's error as a
fraction of its gate). It also holds the split-K plan of the f32 mode's
tile.
"""

import pytest
import torch

from rohm_tpu_torch.ops import transformer_layer_train as lt

TB_K, MMA_K = 32, 8  # the main loop's k-step, one mma.sync's depth


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x f32 rounded to TF32 (10 explicit mantissa bits), ties away from
    zero: half of the 13 dropped bits added to the magnitude, then cut."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """x f32 cut to TF32 toward zero, as the tensor cores read an operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) as the tensor cores see them."""
    big = tf32_rna(x)
    return big, tf32_cut(x - big)


def emulate_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the main loop computes it (passes=3), or with
    the big terms alone (passes=1: plain TF32)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    terms = ((as_, bb), (ab, bs), (ab, bb)) if passes == 3 else ((ab, bb),)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], TB_K):
        part = torch.zeros_like(acc)
        for k in range(k0, min(k0 + TB_K, a.shape[1]), MMA_K):
            for x, y in terms:  # one mma: exact products and sum, one rounding
                prod = x[:, k:k + MMA_K].double() @ y[k:k + MMA_K].double()
                part = (part.double() + prod).float()
        acc = acc + part
    return acc


def _operands(k: int, rows: int = 48, cols: int = 64, seed: int = 0):
    """Activations of unit scale and a weight at a Linear layer's init scale."""
    g = torch.Generator().manual_seed(seed + k)
    a = torch.randn(rows, k, generator=g)
    w = (2 * torch.rand(k, cols, generator=g) - 1) * k ** -0.5
    return a, w


def _gate_ratios(got, a, b):
    """The error against the plain f32 product as a fraction of each gate."""
    ref = a @ b
    err = (got - ref).abs()
    train_gate = 2e-5 * (a.abs() @ b.abs()) + 1e-7
    f32_gate = 1e-5 * ref.abs().max() + 1e-6
    return (err / train_gate).max().item(), (err / f32_gate).max().item()


def test_tf32_split_error_budget():
    """|x - big| <= 2^-11 |x| and |x - big - small| <= 2^-21 |x|, both
    halves TF32 (their 13 low mantissa bits zero), over six decades."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(100_000, generator=g) * 10.0 ** torch.randint(-3, 3, (100_000,), generator=g)
    big, small = split(x)
    for t in (big, small):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    x64 = x.double()
    assert ((x64 - big.double()).abs() <= 2.0 ** -11 * x64.abs()).all()
    assert ((x64 - big.double() - small.double()).abs() <= 2.0 ** -21 * x64.abs()).all()
    # ties go away from zero: 1 + 2^-11 is halfway between two TF32 values
    half = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32_rna(half).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


@pytest.mark.parametrize("k", [512, 1024, 9280])
def test_3xtf32_stays_under_both_gates(k):
    """At the layers' K (the inference products' 512 and 1024, the
    training weight gradients' 9280 rows), 48 rows: the emulated main loop
    stays under gemm_train's and gemm_f32's gates, with room to spare for
    the card's own rounding of its sums (a quarter of each gate)."""
    a, w = _operands(k)
    train_ratio, f32_ratio = _gate_ratios(emulate_3xtf32(a, w), a, w)
    assert train_ratio < 0.25 and f32_ratio < 0.25, (train_ratio, f32_ratio)


@pytest.mark.parametrize("k", [512, 1024, 9280])
def test_one_tf32_pass_misses_the_f32_gate(k):
    """The big terms alone (plain TF32) miss gemm_f32's gate by far at
    every K (~25-30x), so it tells 3xTF32 from TF32. gemm_train's gate
    grows with sum|a||b| (~K) while TF32's error on random operands grows
    with sqrt(K): it catches TF32 at the inference K (~4x at 512, ~3x at
    1024) but not at the weight gradients' 9280 (~0.8x)."""
    a, w = _operands(k)
    train_ratio, f32_ratio = _gate_ratios(emulate_3xtf32(a, w, passes=1), a, w)
    assert f32_ratio > 4, f32_ratio
    assert train_ratio > 2 if k <= 1024 else train_ratio < 1, train_ratio


# the weight gradients of one layer at the training shapes (B*S = 9280
# rows): dW2 = df^T gld, dW1 = dh1^T y1, dWo = do^T attn, dWqkv = dqkv^T x
@pytest.mark.parametrize("m,n", [(512, 1024), (1024, 512), (512, 512), (1536, 512)])
def test_f32_split_k_plan(m, n):
    """plan_splits for the f32 mode's tile on an H100's 132 SMs: every
    weight gradient is split, every chunk is a whole number of the main
    loop's 32-deep k-steps (rt_gemm_train refuses anything else), the
    splits cover K with none empty, and tiles x splits reaches two blocks
    per SM."""
    k, sms = 64 * 145, 132
    bm, bn, bk = lt.GEMM_TILES[False]
    assert bk == TB_K
    splits, chunk = lt.plan_splits(m, n, k, (bm, bn, bk), sms)
    assert splits > 1 and chunk % bk == 0 and chunk >= 8 * bk
    assert splits * chunk >= k > (splits - 1) * chunk
    assert -(-m // bm) * -(-n // bn) * splits >= 2 * sms
