"""The port's `--model_dtype=bfloat16` against the JAX package's, on the CPU:
PoseNet, TrajNet and TrajControl built with a bf16 compute dtype
(`dtype=jnp.bfloat16` in flax, `dtype=torch.bfloat16` in the port) on the
same converted params and the same numpy inputs; the dtype every block
returns; one grads-function step of each net. The train CLIs are in
test_torch_cli_model_dtype.py.

bf16 tolerance: the port's bf16 layers round where flax's do, step by
step (the activations and the softmax as jax.nn computes them on XLA's
CPU backend), so a bf16 net agrees with flax's to float32 rounding: 1e-5
at the output, against a bf16-vs-float32 gap of 1.6e-2 to 4.5e-2. Each
value gate is run on the port's float32 module too, which must fail it:
the control that the bf16 rounding is where flax puts it. The per-block
dtypes are held exactly.
"""

import functools
from types import SimpleNamespace

import jax
import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_train_grads as tgrads
import test_torch_train_trajnet as ttraj
import torch
from test_torch_train import WEIGHTS

from rohm_tpu.diffusion import make_schedule as jax_make_schedule
from rohm_tpu.models import PoseNet as FlaxPoseNet
from rohm_tpu.models import TrajNet as FlaxTrajNet
from rohm_tpu.train import make_posenet_grads_fn as jax_make_posenet_grads_fn
from rohm_tpu.train import make_trajnet_grads_fn as jax_make_trajnet_grads_fn
from rohm_tpu_torch.cli.common import model_dtype
from rohm_tpu_torch.diffusion import make_schedule
from rohm_tpu_torch.models import PoseNet, TrajNet
from rohm_tpu_torch.models.blocks import Conv1dBlock, ResidualTemporalBlock, conv1d, dense, group_norm, linear
from rohm_tpu_torch.train.steps import make_posenet_grads_fn, make_trajnet_grads_fn
from rohm_tpu_torch.utils.convert_flax import posenet_state_dict, trajnet_state_dict

torch.set_num_threads(1)

BF16 = torch.bfloat16
POSE = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@functools.cache
def posenet_case():
    """Flax params of a 2-layer PoseNet (a flax init, biases woken) and inputs."""
    rng = np.random.default_rng(0)
    z = np.zeros((1, 15, 294), np.float32)
    params = jax.jit(FlaxPoseNet(**POSE).init)(jax.random.PRNGKey(0), z, z, np.zeros(1, np.int32))
    params = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32) if not np.any(a) else np.asarray(a),
        params)
    x, cond = (rng.standard_normal((2, 15, 294)).astype(np.float32) for _ in range(2))
    return params, x, cond, np.array([3, 700])


def port_posenet(params, dtype, **kw) -> PoseNet:
    net = PoseNet(**POSE, dtype=dtype, **kw)
    net.load_state_dict(posenet_state_dict(params, num_layers=POSE["num_layers"]))
    return net


@functools.cache
def trajnet_case(trajcontrol: bool):
    rng = np.random.default_rng(1)
    params = ttraj.flax_params(trajcontrol, True)
    x, cond = (rng.standard_normal((2, 16, 13)).astype(np.float32) for _ in range(2))
    kw = {"control_cond": rng.standard_normal((2, 16, 272)).astype(np.float32)} if trajcontrol else {}
    return params, x, cond, np.array([3, 70]), kw


def port_trajnet(params, trajcontrol: bool, dtype) -> TrajNet:
    net = TrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=ttraj.MID, trajcontrol=trajcontrol, dtype=dtype)
    net.load_state_dict(trajnet_state_dict(params, trajcontrol=trajcontrol))
    return net


def flax_trajnet(trajcontrol: bool, dtype=jnp.float32) -> FlaxTrajNet:
    return FlaxTrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=ttraj.MID, trajcontrol=trajcontrol, dtype=dtype)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "forward_train"])
def test_bf16_posenet_matches_flax(train):
    """The bf16 PoseNet, eval forward and forward_train (dropout 0, the
    keep-masks handed in as ones: torch cannot draw flax's masks), against
    flax PoseNet(dtype=bfloat16) on the same params: max 1e-5 (measured
    9.5e-7 on outputs up to |4.7|). The float32 module fails the gate
    (the JAX package's own bf16-vs-f32 gap is 4.5e-2). The output is
    float32."""
    params, x, cond, t = posenet_case()
    flax = FlaxPoseNet(**POSE, dtype=jnp.bfloat16, dropout=0.0)
    ref = np.asarray(flax.apply(params, x, cond, jnp.asarray(t), train=train))
    s = x.shape[1] + 1
    masks = (None, [(torch.ones(2, 2, s, s, dtype=torch.int8), torch.ones(2, s, 32, dtype=torch.int8),
                     torch.ones(2, s, 64, dtype=torch.int8), torch.ones(2, s, 32, dtype=torch.int8))] * 2)
    devs = {}
    for dtype in (BF16, torch.float32):
        net = port_posenet(params, dtype, dropout=0.0)
        if train:
            out = net.forward_train(_t(x), _t(cond), torch.from_numpy(t), masks).detach()
        else:
            out = net(_t(x), _t(cond), torch.from_numpy(t))
        assert out.dtype == torch.float32
        devs[dtype] = np.abs(out.numpy() - ref).max()
    assert devs[BF16] <= 1e-5 < devs[torch.float32], devs


@pytest.mark.parametrize("trajcontrol", [False, True], ids=["trajnet", "trajcontrol"])
def test_bf16_trajnet_matches_flax(trajcontrol):
    """The bf16 TrajNet and TrajControl (the zero convs woken) against flax
    TrajNet(dtype=bfloat16): max 1e-5 (measured 1.8e-7 and 2.4e-7 on
    outputs up to |1.5|). The float32 module fails the gate (the JAX
    package's own bf16-vs-f32 gap is 1.7e-2 and 1.6e-2). The output is
    float32."""
    params, x, cond, t, kw = trajnet_case(trajcontrol)
    ref = np.asarray(flax_trajnet(trajcontrol, jnp.bfloat16).apply(params, x, cond, jnp.asarray(t), **kw))
    devs = {}
    for dtype in (BF16, torch.float32):
        out = port_trajnet(params, trajcontrol, dtype)(_t(x), _t(cond), torch.from_numpy(t),
                                                       **{k: _t(v) for k, v in kw.items()})
        assert out.dtype == torch.float32
        devs[dtype] = np.abs(out.numpy() - ref).max()
    assert devs[BF16] <= 1e-5 < devs[torch.float32], devs


def _port_output_dtypes(net, paths, run) -> dict:
    got, hooks = {}, []
    for port_path in paths:
        mod = net.get_submodule(port_path)
        def hook(module, inputs, output, path=port_path):
            got.setdefault(path, output.dtype)

        hooks.append(mod.register_forward_hook(hook))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return got


def _flax_output_dtypes(model, params, *args, **kw) -> dict:
    _, state = model.apply(params, *args, capture_intermediates=True, mutable=["intermediates"], **kw)
    return {k.split("/__call__")[0]: v.dtype for k, v in _flat(state["intermediates"]).items()}


def _trajnet_module_map(trajcontrol: bool) -> dict:
    """Port module path -> flax module path, for every block with a forward."""
    m = {"diff_final_conv.0": "Conv1dBlock_0"}
    for i in range(1, 5):
        m[f"cond_enc{i}"] = f"CondEncoder_0/ResidualTemporalBlock_{i - 1}"
        if i < 4:
            m[f"cond_downsample{i}"] = f"CondEncoder_0/Downsample1d_{i - 1}"
    for prefix, scope in [("diff_", "")] + ([("controlnet.control_", "ControlNet_0/")] if trajcontrol else []):
        for i in range(1, 5):
            m[f"{prefix}enc{i}"] = f"{scope}ResidualTemporalBlock_{i - 1}"
            m[f"{prefix}downsample{i}"] = f"{scope}Downsample1d_{i - 1}"
        m[f"{prefix}mid_block1"] = f"{scope}ResidualTemporalBlock_4"
        m[f"{prefix}mid_block2"] = f"{scope}ResidualTemporalBlock_5"
    for slot, i in enumerate((4, 3, 2, 1)):
        m[f"diff_upsample{i}"] = f"Upsample1d_{slot}"
        m[f"diff_dec{i}"] = f"ResidualTemporalBlock_{6 + slot}"
    for name, scope in list(m.items()):
        if name.endswith(("enc1", "enc2", "enc3", "enc4", "mid_block1", "mid_block2")) or name.startswith("diff_dec"):
            for j in (0, 1):
                m[f"{name}.blocks.{j}"] = f"{scope}/Conv1dBlock_{j}"
    return m


@pytest.mark.parametrize("net", ["posenet", "trajnet", "trajcontrol"])
def test_every_block_returns_flax_dtype(net):
    """The dtype each block returns in bf16 mode equals what the flax block
    returns (flax's capture_intermediates): bf16 out of the convolution
    blocks, the downsamples and the attention, float32 out of Upsample1d
    (its f32 bias), the encoder layers (their f32 LayerNorms) and, for an
    identity residual on a float32 input, the residual block. Each such
    place is checked, and at least one of each dtype occurs."""
    if net == "posenet":
        params, x, cond, t = posenet_case()
        mapping = {f"seqTransEncoder.layers.{i}": f"layer_{i}" for i in range(2)}
        mapping.update({f"seqTransEncoder.layers.{i}.self_attn": f"layer_{i}/MultiHeadDotProductAttention_0"
                        for i in range(2)})
        want = _flax_output_dtypes(FlaxPoseNet(**POSE, dtype=jnp.bfloat16), params, x, cond, jnp.asarray(t))
        port = port_posenet(params, BF16)
        got = _port_output_dtypes(port, mapping, lambda: port(_t(x), _t(cond), torch.from_numpy(t)))
    else:
        trajcontrol = net == "trajcontrol"
        params, x, cond, t, kw = trajnet_case(trajcontrol)
        mapping = _trajnet_module_map(trajcontrol)
        want = _flax_output_dtypes(flax_trajnet(trajcontrol, jnp.bfloat16), params, x, cond, jnp.asarray(t), **kw)
        port = port_trajnet(params, trajcontrol, BF16)
        got = _port_output_dtypes(port, mapping, lambda: port(_t(x), _t(cond), torch.from_numpy(t),
                                                              **{k: _t(v) for k, v in kw.items()}))
    names = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}
    assert sorted(got) == sorted(mapping)
    for port_path, flax_path in mapping.items():
        assert got[port_path] == names[jnp.dtype(want[flax_path])], (port_path, flax_path)
    assert {torch.bfloat16, torch.float32} <= set(got.values())


def _flax_calls(model, params, *args, **kw) -> dict:
    """flax module path -> (positional inputs, output, whether the module
    computes in bf16) of the first call of every module in one forward
    (flax's method interceptor)."""
    calls = {}

    def record(next_fun, a, k, ctx):
        out = next_fun(*a, **k)
        if ctx.method_name == "__call__":
            bf16 = getattr(ctx.module, "dtype", None) == jnp.bfloat16
            calls.setdefault("/".join(ctx.module.scope.path), (a, out, bf16))
        return out

    with nn.intercept_methods(record):
        model.apply(params, *args, **kw)
    return calls


def _to_port(a, conv: bool):
    """A flax array as the port takes it: its own dtype (bf16 or float32),
    the convolution blocks' [B, T, C] as [B, C, T]."""
    if a is None:
        return None
    v = torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF16 if a.dtype == jnp.bfloat16 else torch.float32)
    return v.transpose(1, 2) if conv and v.ndim == 3 else v


def _rel_dev(got: torch.Tensor, ref, conv: bool) -> float:
    """mean |got - ref| / mean |ref|, on flax's layout."""
    got = got.detach().float()
    got = got.transpose(1, 2) if conv and got.ndim == 3 else got
    ref = np.asarray(ref.astype(jnp.float32))
    return float(np.abs(got.numpy() - ref).mean() / np.abs(ref).mean())


def _posenet_layers(net: PoseNet) -> tuple[dict, dict]:
    """(single layers, composite blocks): flax path -> the port's callable on
    that layer's input. Each single layer takes the dtype its port module
    holds, so a module that was not handed the dtype shows."""
    te, d, h = net.embed_timestep.time_embed, POSE["latent_dim"], POSE["num_heads"]
    layers = {"Dense_0": lambda v: linear(te[0], v, net.dtype), "Dense_1": lambda v: linear(te[2], v, net.dtype),
              "input_process": lambda v: linear(net.input_process.poseEmbedding, v, net.dtype),
              "input_process_cond": lambda v: linear(net.input_process_cond.poseEmbedding, v, net.dtype),
              "output_process": net.output_process}
    blocks = {}
    for i, layer in enumerate(net.seqTransEncoder.layers):
        at, scope = layer.self_attn, f"layer_{i}/MultiHeadDotProductAttention_0"
        for j, name in enumerate(("query", "key", "value")):
            rows = slice(j * d, (j + 1) * d)
            layers[f"{scope}/{name}"] = lambda v, at=at, rows=rows: dense(
                v, at.in_proj_weight[rows], at.in_proj_bias[rows], at.dtype).unflatten(-1, (h, d // h))
        layers[f"{scope}/out"] = lambda v, at=at: linear(at.out_proj, v.flatten(-2), at.dtype)
        layers[f"layer_{i}/Dense_0"] = lambda v, layer=layer: linear(layer.linear1, v, layer.dtype)
        layers[f"layer_{i}/Dense_1"] = lambda v, layer=layer: linear(layer.linear2, v, layer.dtype)
        layers[f"layer_{i}/LayerNorm_0"], layers[f"layer_{i}/LayerNorm_1"] = layer.norm1, layer.norm2
        blocks[f"layer_{i}"] = layer
        blocks[scope] = lambda q, kv, at=at: at(q)  # flax's call passes the keys' input too
    return layers, blocks


def _trajnet_layers(net: TrajNet, trajcontrol: bool) -> tuple[dict, dict]:
    """As _posenet_layers, for TrajNet / TrajControl (the [B, C, T] layout)."""
    mlp = net.time_mlp
    layers = {"TimeMlp_0/Dense_0": lambda v: linear(mlp[1], v, net.dtype),
              "TimeMlp_0/Dense_1": lambda v: linear(mlp[3], v, net.dtype),
              "Conv_0": lambda v: conv1d(net.diff_final_conv[1], v, torch.float32)}
    if trajcontrol:
        names = ("0", "1", "2", "3", "4", "mid")
        for i, n in enumerate(names):
            conv = getattr(net.controlnet, f"control_zero_conv_{n}")
            layers[f"ControlNet_0/ZeroConv1x1_{i}"] = lambda v, conv=conv: conv1d(conv, v, torch.float32)
    blocks = {}
    for port_path, flax_path in _trajnet_module_map(trajcontrol).items():
        mod = net.get_submodule(port_path)
        if isinstance(mod, Conv1dBlock):
            layers[f"{flax_path}/Conv_0"] = lambda v, mod=mod: conv1d(mod.block[0], v, mod.dtype)
            layers[f"{flax_path}/GroupNorm_0"] = lambda v, mod=mod: group_norm(mod.block[2], v, mod.dtype)
            blocks[flax_path] = mod
        elif isinstance(mod, ResidualTemporalBlock):
            if mod.time_mlp is not None:
                layers[f"{flax_path}/Dense_0"] = lambda v, mod=mod: linear(mod.time_mlp[1], v, mod.dtype)
            if not isinstance(mod.residual_conv, torch.nn.Identity):
                layers[f"{flax_path}/Conv_0"] = lambda v, mod=mod: conv1d(mod.residual_conv, v, mod.dtype)
            blocks[flax_path] = mod
        else:  # Downsample1d, Upsample1d: one product each
            layers[flax_path] = mod
    return layers, blocks


@pytest.mark.parametrize("net", ["posenet", "trajnet", "trajcontrol"])
def test_bf16_layers_round_as_flax_on_its_inputs(net):
    """Each layer and block of the bf16 port, fed the input flax's bf16
    module gave that layer, against flax's output there (mean |dev| over
    mean |out|), so a misplaced rounding shows in the block that holds it.
    Every layer and block that flax computes in bf16 (each Dense, Conv,
    attention projection, GroupNorm, downsample and upsample; each encoder
    layer, attention, Conv1dBlock and ResidualTemporalBlock) is reproduced
    to 1e-5 (measured <= 7.2e-7, most bit for bit), and the port's float32
    module misses each by more than 5e-4 (measured >= 1.25e-3): the
    control. The layers flax keeps in float32 (the LayerNorms, the zero
    convs, the final conv, output_process) agree to 1e-5 in both
    modules."""
    if net == "posenet":
        params, x, cond, t = posenet_case()
        calls = _flax_calls(FlaxPoseNet(**POSE, dtype=jnp.bfloat16), params, x, cond, jnp.asarray(t))
        ports = {dt: _posenet_layers(port_posenet(params, dt)) for dt in (BF16, torch.float32)}
        conv = False
    else:
        trajcontrol = net == "trajcontrol"
        params, x, cond, t, kw = trajnet_case(trajcontrol)
        calls = _flax_calls(flax_trajnet(trajcontrol, jnp.bfloat16), params, x, cond, jnp.asarray(t), **kw)
        ports = {dt: _trajnet_layers(port_trajnet(params, trajcontrol, dt), trajcontrol)
                 for dt in (BF16, torch.float32)}
        conv = True

    def dev(dt, group, path):
        args, out, _ = calls[path]
        with torch.no_grad():
            return _rel_dev(ports[dt][group][path](*(_to_port(a, conv) for a in args)), out, conv)

    n_bf16 = 0
    for group in (0, 1):
        for path in ports[BF16][group]:
            got, control = dev(BF16, group, path), dev(torch.float32, group, path)
            if calls[path][2] or group == 1:
                n_bf16 += 1
                assert got <= 1e-5 and control > 5e-4, (path, got, control)
            else:
                assert got <= 1e-5 and control <= 1e-5, (path, got, control)
    assert n_bf16 >= 10


@pytest.mark.parametrize("net", ["posenet", "trajnet"])
def test_bf16_differs_from_f32_and_params_stay_f32(net):
    """The bf16 module computes something else than the f32 one on the same
    params (by more than f32 rounding), and every parameter and the
    state_dict stay float32."""
    if net == "posenet":
        params, x, cond, t = posenet_case()
        a, b = port_posenet(params, BF16), port_posenet(params, torch.float32)
        args = (_t(x), _t(cond), torch.from_numpy(t))
    else:
        params, x, cond, t, _ = trajnet_case(False)
        a, b = port_trajnet(params, False, BF16), port_trajnet(params, False, torch.float32)
        args = (_t(x), _t(cond), torch.from_numpy(t))
    assert all(p.dtype == torch.float32 for p in a.parameters())
    assert all(v.dtype == torch.float32 for v in a.state_dict().values())
    diff = (a(*args) - b(*args)).abs().max().item()
    assert diff > 1e-3, diff


def test_model_dtype_flag():
    assert model_dtype(SimpleNamespace()) == torch.float32
    assert model_dtype(SimpleNamespace(model_dtype="bfloat16")) == torch.bfloat16
    with pytest.raises(ValueError, match="--model_dtype"):
        model_dtype(SimpleNamespace(model_dtype="float16"))


# ---------------------------------------------------------------------------
# one grads-function step
# ---------------------------------------------------------------------------


def jit_rounding_each_step(fn, *args):
    """fn(*args) jitted with XLA's excess precision off, so each bf16 step
    rounds to bf16 as it does op by op (and in the port); by default XLA
    may keep float32 inside a fused elementwise chain."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


def jax_gap_failures(l_t, g_t, jax16, jax32, to_state_dict, skip=lambda name, g: False) -> list:
    """The bf16 gate against the JAX package's bf16 step (jax16) with its
    float32 step (jax32) for scale; the failures (none: passed). Every loss
    term within 1e-4 relative of the JAX bf16 term (measured <= 1.4e-6,
    where the bf16-vs-f32 gap is 2e-2); every gradient tensor float32 and
    within 4x the JAX package's bf16-vs-f32 gap on that tensor of the JAX
    bf16 gradient, and the median of those ratios over the tensors below
    0.5 (measured 0.05 for PoseNet, 0.31 for TrajNet). The JAX step runs
    through jit_rounding_each_step."""
    (g16, l16), (g32, _) = jax16, jax32
    fails = []
    if sorted(l_t) != sorted(l16):
        return ["loss terms"]
    for k in l16:
        if abs(float(l_t[k]) - float(l16[k])) > 1e-4 * max(abs(float(l16[k])), 1e-6):
            fails.append(f"loss {k}: {float(l_t[k])} vs {float(l16[k])}")
    r16, r32 = (to_state_dict(jax.tree.map(np.asarray, g)) for g in (g16, g32))
    if sorted(g_t) != sorted(r16):
        return fails + ["gradient names"]
    ratios = []
    for name, got in g_t.items():
        if got.dtype != torch.float32:
            fails.append(f"{name}: {got.dtype}")
        if skip(name, got):
            continue
        want = r16[name].numpy()
        gap = np.abs(r32[name].numpy() - want).max()
        err = np.abs(got.numpy() - want).max()
        ratios.append(err / max(gap, 1e-30))
        if err > 4 * gap + 1e-6 * np.abs(want).max():
            fails.append(f"{name}: {err} vs the JAX bf16-vs-f32 gap {gap}")
    if np.median(ratios) >= 0.5:
        fails.append(f"median gradient error {np.median(ratios)} of the bf16-vs-f32 gap")
    return fails


def test_bf16_posenet_grads_fn_matches_jax():
    """make_posenet_grads_fn on the bf16 PoseNet against the JAX package's on
    flax PoseNet(dtype=bfloat16), test_torch_train_grads.py's step (dropout
    0, the skating gate on), held to jax_gap_failures; the same step on the
    float32 PoseNet fails that gate."""
    _, params, jbody, tbody = tgrads.setup()
    batch, t, noise = tgrads._draws(0)
    _, _, mean, std = tgrads.repr_batch(0, tgrads.B, tgrads.T)
    size = dict(latent_dim=tgrads.D, ff_size=tgrads.F, num_layers=tgrads.LAYERS, num_heads=tgrads.H, dropout=0.0)

    def jax_run(dtype):
        fn = jax_make_posenet_grads_fn(FlaxPoseNet(**size, dtype=dtype), jax_make_schedule("cosine", 1000),
                                       jnp.asarray(mean), jnp.asarray(std), jbody, WEIGHTS)
        return jit_rounding_each_step(fn, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch),
                                      jnp.asarray(t), jnp.asarray(noise), jax.random.key(1, impl="rbg"),
                                      jnp.asarray(1.0))

    s = tgrads.T + 1
    masks = (None, [(torch.ones(tgrads.B, tgrads.H, s, s, dtype=torch.int8),
                     torch.ones(tgrads.B, s, tgrads.D, dtype=torch.int8),
                     torch.ones(tgrads.B, s, tgrads.F, dtype=torch.int8),
                     torch.ones(tgrads.B, s, tgrads.D, dtype=torch.int8))] * tgrads.LAYERS)
    refs = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    fails = {}
    for dtype in (BF16, torch.float32):
        port = PoseNet(**size, dtype=dtype)
        port.load_state_dict(posenet_state_dict(params, num_layers=tgrads.LAYERS))
        g_t, l_t = make_posenet_grads_fn(port, make_schedule("cosine", 1000), _t(mean), _t(std), tbody, WEIGHTS)(
            port, {k: _t(v) for k, v in batch.items()}, torch.from_numpy(t).long(), _t(noise), masks,
            torch.tensor(1.0))
        fails[dtype] = jax_gap_failures(l_t, g_t, *refs, lambda g: posenet_state_dict(g, num_layers=tgrads.LAYERS))
    assert not fails[BF16], fails[BF16]
    assert fails[torch.float32]


def test_bf16_trajnet_grads_fn_matches_jax():
    """make_trajnet_grads_fn on the bf16 TrajNet against the JAX package's on
    flax TrajNet(dtype=bfloat16), test_torch_train_trajnet.py's abs-only
    step, held to jax_gap_failures, the gauge biases (rounding noise on
    both sides) excepted; the same step on the float32 TrajNet fails that
    gate."""
    params = ttraj.flax_params(False, True)
    mean, std = ttraj.stats()
    batch, t, noise = ttraj.draws(0, False, True)
    jbody, tbody = ttraj.bodies()

    def jax_run(dtype):
        fn = jax_make_trajnet_grads_fn(flax_trajnet(False, dtype), jax_make_schedule("cosine", ttraj.STEPS),
                                       jnp.asarray(mean), jnp.asarray(std), jbody, ttraj.WEIGHTS, True, 13)
        return jit_rounding_each_step(fn, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch),
                                      jnp.asarray(t), jnp.asarray(noise))

    refs = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    fails = {}
    for dtype in (BF16, torch.float32):
        port = port_trajnet(params, False, dtype)
        g_t, l_t = make_trajnet_grads_fn(port, make_schedule("cosine", ttraj.STEPS), _t(mean), _t(std), tbody,
                                         ttraj.WEIGHTS, True, 13)(
            port, {k: _t(v) for k, v in batch.items()}, torch.from_numpy(t).long(), _t(noise))
        fails[dtype] = jax_gap_failures(l_t, g_t, *refs, lambda g: trajnet_state_dict(g, trajcontrol=False),
                                        ttraj.is_gauge)
    assert not fails[BF16], fails[BF16]
    assert fails[torch.float32]
