"""PoseNet's forward in the numerics each configuration states, plain PyTorch.

`make_posenet_fn` takes a PoseNet module (parameters only), the
step-invariant condition and a mode, and returns model_fn(x_t, t) -> pred_x0
[B, T, 294] with the condition's 22 trajectory dims passed through, as the
port's PoseNet paths do. Nothing here is read from the port: whatever the port derives from the
raw weights (the fused QKV weight, the 1/sqrt(dh) fold, int8 codes and
scales) is worked out again.

- "f32": every product in float32 (TF32 off is the caller's switch), exact
  gelu, two-pass LayerNorm; the q columns scaled after their bias.
- "int8": W8A8, the arithmetic of the port's int8 chain: symmetric int8
  weights with one scale per output column; each product's input quantized
  per row (amax/127, round half to even); int32 sums; (acc * row) * col +
  bias; the QKV product stored bf16; attention as f32 scores of the bf16
  operands, f32 softmax, bf16 probabilities, f32 P.V rounded to bf16; f32
  LayerNorms; tanh gelu; bf16 activations between layers.
- "int4": the same with 4-bit codes (amax/7), the precision below int8:
  the control that the check has to refuse.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def _quant(x: torch.Tensor, qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows of x -> (int8 codes, f32 scales [R]): amax/qmax, round half to even."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12)
    q = torch.clamp_(torch.round_(xf * (torch.full_like(amax, qmax) / amax)), -qmax, qmax).to(torch.int8)
    return q, (amax * (1.0 / qmax)).squeeze(-1)


def _weight_codes(w_out_in: torch.Tensor, qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    """A [N, K] weight -> ([K, N] int8 codes, [N] scales), one scale per output column."""
    q, s = _quant(w_out_in.detach().float(), qmax)
    return q.t().contiguous(), s


def _qgemm(qa, row_scale, w_q, col_scale, bias):
    """(float(qa @ w_q) * row) * col + bias; the int32 sums are exact."""
    acc = torch._int_mm(qa, w_q).float()
    return torch.addcmul(bias, acc.mul_(row_scale[:, None]), col_scale)


def _attention_bf16(qkv: torch.Tensor, b: int, s: int, h: int) -> torch.Tensor:
    d = qkv.shape[-1] // 3
    q, k, v = (t.reshape(b, s, h, d // h).transpose(1, 2).float() for t in qkv.split(d, dim=-1))
    probs = torch.softmax(q @ k.transpose(-1, -2), dim=-1).to(torch.bfloat16)
    out = (probs.float() @ v).to(torch.bfloat16)
    return out.transpose(1, 2).reshape(b * s, d)


def _prepare_quant(posenet, qmax: float) -> list:
    layers = []
    for layer in posenet.seqTransEncoder.layers:
        sa = layer.self_attn
        d = sa.in_proj_weight.shape[1]
        fold = 1.0 / ((d // sa.num_heads) ** 0.5)
        w = sa.in_proj_weight.detach().float().clone()
        bq = sa.in_proj_bias.detach().float().clone()
        w[:d] *= fold
        bq[:d] *= fold
        layers.append((
            *_weight_codes(w, qmax), bq,
            *_weight_codes(sa.out_proj.weight, qmax), sa.out_proj.bias.detach().float(),
            layer.norm1.weight.detach().float(), layer.norm1.bias.detach().float(),
            *_weight_codes(layer.linear1.weight, qmax), layer.linear1.bias.detach().float(),
            *_weight_codes(layer.linear2.weight, qmax), layer.linear2.bias.detach().float(),
            layer.norm2.weight.detach().float(), layer.norm2.bias.detach().float(),
        ))
    return layers


def _embed(posenet, x_t, cond_emb, t):
    b, s, _ = x_t.shape
    te = posenet.embed_timestep.time_embed
    tt = torch.as_tensor(t, device=x_t.device).expand(b)
    emb = F.linear(F.silu(F.linear(posenet.pe[tt], te[0].weight, te[0].bias)), te[2].weight, te[2].bias)
    lin = posenet.input_process.poseEmbedding
    h = F.linear(x_t, lin.weight, lin.bias) + cond_emb
    return torch.cat([emb[:, None, :], h], dim=1) + posenet.pe[None, : s + 1, :]


def _head(posenet, seq, cond):
    head = posenet.output_process.poseFinal
    out = F.linear(seq[:, 1:].float(), head.weight, head.bias)
    return torch.cat([cond[..., : posenet.traj_feat_dim], out], dim=-1)


def make_posenet_fn(posenet, cond: torch.Tensor, mode: str):
    """model_fn(x_t, t) for `mode` in ("f32", "int8", "int4")."""
    nh = posenet.num_heads
    lin = posenet.input_process_cond.poseEmbedding
    cond_emb = F.linear(cond, lin.weight, lin.bias)
    if mode == "f32":
        def fn(x_t, t):
            seq = _embed(posenet, x_t, cond_emb, t)
            b, s, d = seq.shape
            x = seq.reshape(b * s, d)
            for layer in posenet.seqTransEncoder.layers:
                sa = layer.self_attn
                qkv = F.linear(x, sa.in_proj_weight, sa.in_proj_bias)
                qkv[:, :d] *= 1.0 / ((d // nh) ** 0.5)
                q, k, v = (u.reshape(b, s, nh, d // nh).transpose(1, 2) for u in qkv.split(d, dim=-1))
                attn = (torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v).transpose(1, 2).reshape(b * s, d)
                a = F.linear(attn, sa.out_proj.weight, sa.out_proj.bias)
                y = F.layer_norm(x + a, (d,), layer.norm1.weight, layer.norm1.bias, LN_EPS)
                h2 = F.linear(F.gelu(F.linear(y, layer.linear1.weight, layer.linear1.bias)),
                              layer.linear2.weight, layer.linear2.bias)
                x = F.layer_norm(y + h2, (d,), layer.norm2.weight, layer.norm2.bias, LN_EPS)
            return _head(posenet, x.reshape(b, s, d), cond)
        return fn
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown PoseNet mode {mode!r}")
    qmax = 127.0 if mode == "int8" else 7.0
    layers = _prepare_quant(posenet, qmax)

    def fn(x_t, t):
        seq = _embed(posenet, x_t, cond_emb, t).to(torch.bfloat16)
        b, s, d = seq.shape
        x = seq.reshape(b * s, d)
        qx = _quant(x, qmax)
        for i, (wqkv, sqkv, bqkv, wo, so, bo, ln1_s, ln1_b, w1, s1, b1, w2, s2, b2, ln2_s, ln2_b) in enumerate(layers):
            qkv = _qgemm(*qx, wqkv, sqkv, bqkv).to(torch.bfloat16)
            a = _qgemm(*_quant(_attention_bf16(qkv, b, s, nh), qmax), wo, so, bo)
            y = F.layer_norm(x.float() + a, (d,), ln1_s, ln1_b, LN_EPS)
            h1 = F.gelu(_qgemm(*_quant(y, qmax), w1, s1, b1), approximate="tanh")
            h2 = _qgemm(*_quant(h1, qmax), w2, s2, b2)
            x = F.layer_norm(y + h2, (d,), ln2_s, ln2_b, LN_EPS).to(torch.bfloat16)
            if i + 1 < len(layers):
                qx = _quant(x, qmax)
        return _head(posenet, x.reshape(b, s, d), cond)

    return fn
