"""Which rounding orders the f32 plain attention backward takes on the card,
and how far each departure from them moves dq, dk and dv.

    python -m rohm_tpu_torch.scripts.attention_bwd_orders

On the operands the plain training chain of a random layer hands the
attention backward (bf16 mode, dropout 0.1; B = 64, S = 145 for seeds 0-2,
and B = 2, S = 1024), it counts the elements where the plain version's
products (torch.matmul, f32), softmax and row sum D differ from emulations
in a given order: a sequential FMA chain over dh, 16-deep blocks, the
softmax's warp order (lane c % 32, then a butterfly) or other orders, with
division or a reciprocal. Then it evaluates the backward with one part
taken in another order and prints how far dq, dk and dv move from the
plain version, in units of the gate (2^-10 of max|ref|). The emulations
run in float64 on the card, rounding to f32 at each step. It runs only on
a CUDA device.
"""
import subprocess
import sys

import torch
from torch.nn import TransformerEncoderLayer

from rohm_tpu_torch.ops import transformer_layer_train as lt

D, H, F, dev = 512, 4, 1024, "cuda"
f32 = torch.float32


def operands(seed, B, S):
    g = torch.Generator(device=dev).manual_seed(seed)
    torch.manual_seed(seed)
    layer = TransformerEncoderLayer(D, H, F).to(dev)
    with torch.no_grad():
        for prm in layer.parameters():
            if prm.dim() == 1:
                prm.add_(0.1 * torch.randn(prm.shape[0], generator=g, device=dev))
    params = tuple(t.detach() for t in lt.layer_params(layer))
    fm = lt.flat_masks(lt.gen_dropout_masks(g, B, S, D, F, H, 0.1), B * S)
    x, dy = torch.randn(B * S, D, generator=g, device=dev), torch.randn(B * S, D, generator=g, device=dev)
    seen = {}

    def attn_bwd(qkv, da, *args, **kw):  # the operands the chain hands the attention backward
        seen["qkv"], seen["da"] = qkv, da
        return lt.attention_train_bwd_plain(qkv, da, *args, **kw)

    k = lt.PLAIN._replace(attn_bwd=attn_bwd)
    kp = lt.cast_weight_mats(params)
    _, saved = lt.layer_train_fwd(x, kp, fm, S, H, 1 / 0.9, True, k)
    lt.layer_train_bwd(dy, saved, kp, fm, S, H, 1 / 0.9, True, k)
    return seen["qkv"], seen["da"], fm[0]


def mm_seq(a, b):
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=f32, device=dev)
    bt = b.transpose(-1, -2).double()
    for d in range(a.shape[-1]):
        acc = (acc.double() + a[..., d, None].double() * bt[..., d:d + 1, :]).float()
    return acc

def mm_blk(a, b, blk=16):
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=f32, device=dev)
    for d0 in range(0, a.shape[-1], blk):
        part = (a[..., d0:d0 + blk].double() @ b[..., d0:d0 + blk].double().transpose(-1, -2)).float()
        acc = (acc.double() + part.double()).float()
    return acc

def mm_torch(a, b):
    return a @ b.transpose(-1, -2)

def warp_sum(e):  # torch's persistent softmax: lane j % 32 sums its elements in order, then xor butterfly
    n = e.shape[-1]
    p2 = 1 << (n - 1).bit_length()
    w = min(p2, 32)
    ep = torch.nn.functional.pad(e, (0, p2 - n)).reshape(e.shape[:-1] + (p2 // w, w))
    acc = ep[..., 0, :].clone()
    for it in range(1, p2 // w): acc = acc + ep[..., it, :]
    off = w // 2
    while off:
        idx = torch.arange(w, device=dev) ^ off
        acc = acc + acc[..., idx]
        off //= 2
    return acc[..., :1]

def quad_sum(e):  # the kernel's: lane q of a quad sums keys 8j + 2q, +1 in order, then the quad
    n = e.shape[-1]
    ep = torch.nn.functional.pad(e, (0, (-n) % 8)).reshape(e.shape[:-1] + (-1, 4, 2))
    acc = torch.zeros(e.shape[:-1] + (4,), dtype=f32, device=dev)
    for j in range(ep.shape[-3]):
        acc = acc + ep[..., j, :, 0]
        acc = acc + ep[..., j, :, 1]
    a2 = acc + acc[..., [1, 0, 3, 2]]
    return (a2 + a2[..., [2, 3, 0, 1]])[..., :1]

def seq_sum(e):
    acc = e[..., :1].clone()
    for j in range(1, e.shape[-1]):
        acc = acc + e[..., j:j + 1]
    return acc


def bwd(q, k, v, da, keep, mm=mm_torch, ssum=None, div=True, dsum=None):
    scale = 1.0 / q.shape[-1] ** 0.5
    x = mm(q, k) * scale
    if ssum is None:
        p = torch.softmax(x, -1)
    else:
        e = torch.exp(x - x.amax(-1, keepdim=True))
        s = ssum(e)
        p = e / s if div else e * (1.0 / s)
    pd = p * keep
    dp = mm(da, v) * keep
    pr = dp * p
    Dd = pr.sum(-1, keepdim=True) if dsum is None else dsum(pr)
    ds = p * (dp - Dd) * scale
    c = lambda t: t.to(torch.bfloat16).float()
    return c(ds) @ c(k), c(ds).transpose(-1, -2) @ c(q), c(pd).transpose(-1, -2) @ c(da), (x, p, Dd)


def dist(got, ref):
    return " ".join(f"{n} {(a - r).abs().max().item() / (2 ** -10 * r.abs().max().item()):.3f}"
                    for n, a, r in zip(("dq", "dk", "dv"), got[:3], ref[:3]))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this measures the card's orders")
    print(sys.version, torch.__version__, torch.version.cuda, subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    for seed, B, S in ((0, 64, 145), (1, 64, 145), (2, 64, 145), (0, 2, 1024)):
        qkv, da, mask = operands(seed, B, S)
        dh = D // H
        q, k, v = (t.float().reshape(B, S, H, dh).transpose(1, 2).contiguous() for t in qkv.split(D, -1))
        da = da.float().reshape(B, S, H, dh).transpose(1, 2).contiguous()
        keep = mask.float() * (1 / 0.9)
        ref = bwd(q, k, v, da, keep)
        # the library's own orders
        st, pt, Dt = ref[3]
        xs = mm_seq(q, k) * (1.0 / dh ** 0.5)
        print(f"seed {seed} B {B} S {S}: scores torch vs sequential FMA chain: {(xs != st).sum().item()} of {st.numel()} differ; "
              f"vs 16-deep blocks: {((mm_blk(q, k) * (1.0 / dh ** 0.5)) != st).sum().item()}", flush=True)
        e = torch.exp(st - st.amax(-1, keepdim=True))
        for nm, fn in (("warp", warp_sum), ("quad", quad_sum), ("seq", seq_sum)):
            for dv_ in (True, False):
                pp = e / fn(e) if dv_ else e * (1.0 / fn(e))
                print(f"  softmax sum {nm} {'div' if dv_ else 'rcp'}: {(pp != pt).sum().item()} of p differ", flush=True)
        dp = mm_torch(da, v) * keep
        pr = dp * pt
        for nm, fn in (("warp", warp_sum), ("quad", quad_sum), ("seq", seq_sum)):
            print(f"  D sum {nm}: {(fn(pr) != Dt).sum().item()} of {Dt.numel()} differ", flush=True)
        for nm, kw in (("all torch but the products in 16-deep blocks", dict(mm=mm_blk)),
                       ("products sequential FMA", dict(mm=mm_seq)),
                       ("softmax warp order, div", dict(ssum=warp_sum)),
                       ("softmax quad order, div", dict(ssum=quad_sum)),
                       ("softmax quad order, rcp", dict(ssum=quad_sum, div=False)),
                       ("D quad order", dict(dsum=quad_sum)),
                       ("D warp order", dict(dsum=warp_sum)),
                       ("seq FMA + warp div + D quad", dict(mm=mm_seq, ssum=warp_sum, dsum=quad_sum)),
                       ("seq FMA + warp div + D warp (the kernel's orders)", dict(mm=mm_seq, ssum=warp_sum, dsum=warp_sum)),
                       ("blocks + quad rcp + D quad (a tensor-core kernel's)", dict(mm=mm_blk, ssum=quad_sum, div=False, dsum=quad_sum))):
            print(f"  {nm}: {dist(bwd(q, k, v, da, keep, **kw), ref)}", flush=True)


if __name__ == "__main__":
    main()
