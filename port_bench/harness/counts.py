"""Operations and bytes from the shapes: the frozen arithmetic of the
roofline bounds and of the model's work.

Peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense, at 700 W):
int8 1979 TOP/s, bf16 989 TFLOP/s, f32 products 165 TFLOP/s (3xTF32 on
the 495 TFLOP/s TF32 tensor cores: the fastest f32-accurate route, the
repo's convention for the port's f32 kernels), HBM 3.35 TB/s.

A launch's least time is the larger of its operations over the peak of its
class and its bytes over the HBM rate; every input byte is counted once and
every output byte once.
"""

from __future__ import annotations

PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 165e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, cls: str) -> float:
    return max(ops / PEAK_OPS[cls], nbytes / HBM_BYTES_PER_S)


def posenet_layer_ops(tokens: int, batch: int, seq: int, d: int = 512, f: int = 1024) -> tuple[float, float]:
    """(products, attention) operations of one encoder layer over `tokens`
    = batch * seq rows: 2 M (3d^2 + d^2 + 2 d f) and the two attention
    products 4 batch seq^2 d."""
    return 2.0 * tokens * (4 * d * d + 2 * d * f), 4.0 * batch * seq * seq * d


def posenet_kernel_launches(mode: str, batch: int, seq: int = 144, d: int = 512, f: int = 1024,
                            layers: int = 8) -> list[tuple[str, float, float, str]]:
    """The port's kernel launches of one PoseNet forward at these shapes,
    as (kernel, operations, bytes, class): the int8 chain's 1 + 9 L
    launches (quant_rows_int8, gemm_int8, attention_bf16,
    residual_layernorm) or the f32 chain's 7 L (gemm_f32, attention_f32,
    residual_layernorm)."""
    m = batch * seq
    att_ops = 4.0 * batch * seq * seq * d
    out = []
    if mode == "int8":
        def quant(width, in_bytes):
            out.append(("quant_rows_int8", 0.0, m * width * in_bytes + m * width + 4 * m, "int8"))

        def gemm(k, n, out_bytes):
            out.append(("gemm_int8", 2.0 * m * k * n,
                        m * k + 4 * m + k * n + 8 * n + m * n * out_bytes, "int8"))

        quant(d, 2)
        for i in range(layers):
            gemm(d, 3 * d, 2)
            out.append(("attention_bf16", att_ops, m * 3 * d * 2 + m * d * 2, "bf16"))
            quant(d, 2)
            gemm(d, d, 4)
            out.append(("residual_layernorm", 0.0, m * d * 2 + m * d * 4 + 8 * d + m * d * 4 + m * d + 4 * m, "f32"))
            gemm(d, f, 4)
            quant(f, 4)
            gemm(f, d, 4)
            codes = m * d + 4 * m if i + 1 < layers else 0
            out.append(("residual_layernorm", 0.0, m * d * 4 * 2 + 8 * d + m * d * 2 + codes, "f32"))
        return out
    if mode == "f32":
        def gemm(k, n):
            out.append(("gemm_f32", 2.0 * m * k * n, 4 * (m * k + k * n + n + m * n), "f32"))

        for _ in range(layers):
            gemm(d, 3 * d)
            out.append(("attention_f32", att_ops, 4 * (m * 3 * d + m * d), "f32"))
            gemm(d, d)
            out.append(("residual_layernorm", 0.0, 4 * (3 * m * d + 2 * d), "f32"))
            gemm(d, f)
            gemm(f, d)
            out.append(("residual_layernorm", 0.0, 4 * (3 * m * d + 2 * d), "f32"))
        return out
    raise ValueError(f"no kernel list for PoseNet mode {mode!r}")


def _rtb(b, t, cin, cout, time_dim, k=5):
    ops = 2.0 * b * t * cout * cin * k + 2.0 * b * t * cout * cout * k
    if cin != cout:
        ops += 2.0 * b * t * cout * cin
    if time_dim:
        ops += 2.0 * b * time_dim * cout
    return ops


def _down(b, t_out, dim):
    return 2.0 * b * t_out * dim * dim * 3


def _up(b, t_in, dim):
    return 2.0 * b * t_in * dim * dim * 4


def trajnet_ops(batch: int, t: int, m: int = 512, traj_dim: int = 13, cond_dim: int = 13,
                time_dim: int = 32, trajcontrol: bool = False, control_dim: int = 272) -> float:
    """Operations of one TrajNet (or TrajControl) forward: every
    convolution and linear layer of the 1-D U-Net, its condition encoder
    and (TrajControl) its control branch; elementwise work not counted."""
    b = batch
    ops = 2.0 * b * (time_dim * 4 * time_dim) * 2
    ops += _rtb(b, t, cond_dim, m // 8, 0) + _down(b, t // 2, m // 8)
    ops += _rtb(b, t // 2, m // 8, m // 4, 0) + _down(b, t // 4, m // 4)
    ops += _rtb(b, t // 4, m // 4, m // 2, 0) + _down(b, t // 8, m // 2)
    ops += _rtb(b, t // 8, m // 2, m, 0)
    ops += _rtb(b, t, traj_dim, m // 8, time_dim) + _down(b, t // 2, m // 4)
    ops += _rtb(b, t // 2, m // 4, m // 4, time_dim) + _down(b, t // 4, m // 2)
    ops += _rtb(b, t // 4, m // 2, m // 2, time_dim) + _down(b, t // 8, m)
    ops += _rtb(b, t // 8, m, m, time_dim) + _down(b, t // 16, 2 * m)
    ops += _rtb(b, t // 16, 2 * m, m, time_dim) + _rtb(b, t // 16, m, m, time_dim)
    ops += _up(b, t // 16, m) + _rtb(b, t // 8, 2 * m, m // 2, time_dim)
    ops += _up(b, t // 8, m // 2) + _rtb(b, t // 4, m, m // 4, time_dim)
    ops += _up(b, t // 4, m // 4) + _rtb(b, t // 2, m // 2, m // 8, time_dim)
    ops += _up(b, t // 2, m // 8) + _rtb(b, t, m // 4, 32, time_dim)
    ops += 2.0 * b * t * 32 * 32 * 5 + 2.0 * b * t * 32 * traj_dim
    if trajcontrol:
        ops += 2.0 * b * t * control_dim * traj_dim
        ops += _rtb(b, t, traj_dim, m // 8, time_dim) + 2.0 * b * t * (m // 8) * 32 + _down(b, t // 2, m // 4)
        ops += _rtb(b, t // 2, m // 4, m // 4, time_dim) + 2.0 * b * (t // 2) * (m // 4) * (m // 8) + _down(b, t // 4, m // 2)
        ops += _rtb(b, t // 4, m // 2, m // 2, time_dim) + 2.0 * b * (t // 4) * (m // 2) * (m // 4) + _down(b, t // 8, m)
        ops += _rtb(b, t // 8, m, m, time_dim) + 2.0 * b * (t // 8) * m * (m // 2) + _down(b, t // 16, 2 * m)
        ops += _rtb(b, t // 16, 2 * m, m, time_dim) + _rtb(b, t // 16, m, m, time_dim)
        ops += 2.0 * b * (t // 16) * m * m
    return ops


def posenet_step_ops(batch: int, frames: int, d: int = 512, f: int = 1024, layers: int = 8,
                     body_dim: int = 294, pose_dim: int = 272) -> dict:
    """One PoseNet forward over frames + 1 tokens, by kind: "products"
    and "attention" of the encoder, "embed" (x_t's embedding, the
    timestep MLP, the output head; the condition's embedding is once per
    chain and left out)."""
    seq = frames + 1
    prod, att = posenet_layer_ops(batch * seq, batch, seq, d, f)
    embed = 2.0 * batch * frames * (body_dim * d + d * pose_dim) + 2.0 * batch * 2 * d * d
    return {"products": layers * prod, "attention": layers * att, "embed": embed}


def batch_least_seconds(posenet_mode: str, batch: int, frames: int, traj_frames: int,
                        pose_steps: int, traj_steps: int, sample_iter: int, traj_dim: int,
                        mid_dim: int) -> float:
    """The least time of one batch's model work at the published peaks:
    PoseNet's products, attention and embeddings per step, TrajNet's and
    TrajControl's convolutions per step, each class over its peak."""
    p = posenet_step_ops(batch, frames)
    chains = pose_steps * sample_iter
    if posenet_mode == "int8":
        t = chains * (p["products"] / PEAK_OPS["int8"] + p["attention"] / PEAK_OPS["bf16"]
                      + p["embed"] / PEAK_OPS["f32"])
    elif posenet_mode == "f32":
        t = chains * (p["products"] + p["attention"] + p["embed"]) / PEAK_OPS["f32"]
    else:
        raise ValueError(f"no operation count for PoseNet mode {posenet_mode!r}")
    traj = traj_steps * trajnet_ops(batch, traj_frames, mid_dim, traj_dim, traj_dim)
    if sample_iter > 1:
        traj += (sample_iter - 1) * traj_steps * trajnet_ops(batch, traj_frames, mid_dim, traj_dim, traj_dim,
                                                            trajcontrol=True)
    return t + traj / PEAK_OPS["f32"]
