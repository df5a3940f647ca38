"""The port's data parallelism on the CPU: two gloo ranks (spawned processes,
a file rendezvous in tmp_path) against the single-process port and against
the JAX package on a 2-device data mesh, with the same inputs from numpy.

Covered: the mesh helpers at world sizes 1 and 2; foot_skating_loss, both
'prox' guidance terms and posenet_losses over the global batch (the
ranks' skating-mask counts differ, where a mean of per-rank means would be
wrong); one PoseNet step (plain and fused_train float32 on the plain
versions) and one TrajNet step. The pipeline is in
test_torch_pipeline_data_parallel.py; the rank bodies are in
torch_dp_workers.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_train_grads as tgrads
import test_torch_train_trajnet as ttraj
import torch
import torch_dp_workers as workers
from jax.sharding import NamedSharding, PartitionSpec as P
from scipy.spatial.transform import Rotation as R
from test_torch_train import WEIGHTS, repr_batch

from rohm_tpu.body import forward_joints as jax_fk
from rohm_tpu.body import synthetic_model as jax_synthetic_model
from rohm_tpu.data.synthetic import _synthetic_params
from rohm_tpu.models import guidance as jg
from rohm_tpu.models.losses import foot_skating_loss as jax_foot_skating_loss
from rohm_tpu.models.losses import posenet_losses as jax_posenet_losses
from rohm_tpu.parallel import data_parallel_mesh as jax_data_parallel_mesh
from rohm_tpu.reprs import get_repr as jax_get_repr
from rohm_tpu.train import create_train_state as jax_create_train_state
from rohm_tpu.train import make_posenet_grads_fn as jax_make_posenet_grads_fn
from rohm_tpu_torch.body import synthetic_model
from rohm_tpu_torch.models.guidance import (
    GUIDANCE_2D_JOINTS,
    camera_inverses,
    projection_2d_loss_fn,
    prox_guidance,
    skating_loss_fn,
)
from rohm_tpu_torch.models.losses import foot_skating_loss, posenet_losses
from rohm_tpu_torch.parallel import DataMesh, spawn
from rohm_tpu_torch.pipeline import GUIDANCE_DATA_KEYS
from rohm_tpu_torch.reprs.schema import FOOT_JOINT_INDEX
from rohm_tpu_torch.utils.convert_flax import posenet_state_dict, trajnet_state_dict

torch.set_num_threads(1)

_rdzv = itertools.count()
LR = 1e-4


def ranks(tmp_path, fn, world: int, *args) -> list:
    """fn(mesh, *args) on `world` spawned gloo ranks on the CPU; each rank's result."""
    return spawn(fn, world, args, devices=[torch.device("cpu")] * world,
                 init_method=f"file://{tmp_path}/rdzv{next(_rdzv)}", timeout_s=120, deadline_s=300)


def assert_same_adam_step(after: dict, ref_after: dict, ref_grads: dict, grad_tol: float, who: str,
                          skip=lambda name, g: False) -> None:
    """One AdamW step from the same parameters moves an entry by
    lr * g / (|g| + eps): about lr times the sign of its gradient, whatever
    the gradient's size. So where two sound runs' gradients agree to
    `grad_tol` of a tensor's largest entry, the entries whose reference
    gradient is above 100 times that cannot change sign: there the two
    parameters after the step agree to 1e-3 lr and float32 rounding. The
    other entries (gradients at rounding level, such as the key biases')
    may go either way. The gate covers most entries; a step on another
    gradient than the reference's moves many of them by 2 lr. `skip`: the
    tensors whose whole gradient is rounding noise (the gauge biases)."""
    covered = total = 0
    for name, p in after.items():
        g = ref_grads[name]
        if skip(name, g):
            continue
        sure = np.abs(g) > 100 * grad_tol * np.abs(g).max()
        np.testing.assert_allclose(p[sure], ref_after[name][sure], rtol=2**-22, atol=1e-3 * LR,
                                   err_msg=f"{who}: {name}")
        covered, total = covered + int(sure.sum()), total + g.size
    assert covered > total / 2, (who, covered, total)


def jax_mesh2():
    return jax_data_parallel_mesh(jax.devices()[:2])


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2])
def test_mesh_helpers(tmp_path, world):
    """shard_rows/shard_batch split the leading axis in rank order,
    gather_rows inverts them (on any axis), global_sum sums over ranks with
    the identity as its gradient, sum_gradients sums .grad in place,
    draw_rows keeps this rank's rows of the global draw and leaves the
    generator where the global draw leaves it; broadcast_object and
    barrier complete."""
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    out = ranks(tmp_path, workers.collectives, world, x)
    gen = torch.Generator().manual_seed(3)
    full = torch.randn((2 * world, 5), generator=gen).numpy()
    after = torch.randn(1, generator=gen).numpy()
    n = 4 // world
    for r, o in enumerate(out):
        assert (o["rank"], o["size"]) == (r, world)
        rows = x[r * n:(r + 1) * n]
        np.testing.assert_array_equal(o["rows"], rows)
        np.testing.assert_array_equal(o["batch_x"], rows)
        np.testing.assert_array_equal(o["batch_y"], rows[:, :1])
        assert o["batch_scalar"] == 7
        np.testing.assert_array_equal(o["gathered"], x)
        np.testing.assert_array_equal(o["gathered_ax1"], x.T)
        assert float(o["total"]) == float((x ** 2).sum())
        np.testing.assert_array_equal(o["grad"], 2 * rows)
        np.testing.assert_array_equal(o["grad_sum"], np.full(2, world * (world + 1) / 2))
        np.testing.assert_array_equal(o["drawn"], full[2 * r:2 * (r + 1)])
        np.testing.assert_array_equal(o["after"], after)
        assert o["broadcast"] == {"rank": 0}


def test_mesh_refuses_an_uneven_split():
    from rohm_tpu_torch.parallel import shard_rows

    with pytest.raises(ValueError, match="does not split"):
        shard_rows(np.zeros((3, 2)), DataMesh(None, 0, 2, torch.device("cpu")))


# ---------------------------------------------------------------------------
# reductions over the global batch
# ---------------------------------------------------------------------------


def _skating_mask_counts(joints, contact):
    """Per clip: how many (frame, foot) entries the skating mask keeps."""
    foot = joints[..., FOOT_JOINT_INDEX, :]
    vel = np.linalg.norm((foot[:, 1:] - foot[:, :-1]) * 30.0, axis=-1)
    return ((vel > 0.1) * contact[:, :-1]).sum(axis=(1, 2))


def _guidance_case(b: int = 4, t: int = 12):
    """A normalized repr of b synthetic motions with planted feet (the
    skating mask then differs from clip to clip), cameras 3.5 m away and
    noisy keypoints (test_torch_guidance_prox.py's case, b clips)."""
    jbody = jax_synthetic_model(num_verts=64, seed=3)
    rng = np.random.default_rng(7)
    plist = [_synthetic_params(t + 1, seed=s) for s in range(b)]
    params = {k: np.stack([p[k] for p in plist]).astype(np.float32) for k in plist[0]}
    joints = np.asarray(jax_fk(jbody, params["betas"], params["global_orient"], params["body_pose"],
                               params["transl"]), np.float32)
    rep = np.asarray(jax_get_repr(jnp.asarray(joints), global_orient=params["global_orient"],
                                  transl=params["transl"], body_pose=params["body_pose"],
                                  betas=params["betas"]), np.float32)
    mean = rep.reshape(-1, 294).mean(0)
    std = rep.reshape(-1, 294).std(0) + 0.1
    mean[-4:], std[-4:] = 0.0, 1.0
    x = (rep - mean) / std
    x[..., -4:] = rng.uniform(0, 1, size=x[..., -4:].shape) > np.linspace(0.1, 0.8, b)[:, None, None]
    x = x + 0.05 * rng.standard_normal(x.shape)
    transf = np.tile(np.eye(4), (b, 1, 1))
    transf[:, :3, :3] = R.from_euler("z", rng.uniform(-np.pi, np.pi, (b, 1))).as_matrix()
    transf[:, :3, 3] = rng.normal(scale=0.5, size=(b, 3))
    cam_r = R.from_rotvec(rng.normal(scale=0.4, size=3)).as_matrix()
    center = (np.linalg.inv(transf[0]) @ np.r_[joints[0, :, 0].mean(0), 1.0])[:3]
    cam_t = center - cam_r @ np.array([0.0, 0.0, 3.5])
    kp = np.concatenate([rng.uniform([400, 100], [1500, 1000], size=(b, t + 3, 22, 2)),
                         rng.uniform(size=(b, t + 3, 22, 1))], -1)
    cameras = {"transf_matrix": transf, "cam_r": cam_r, "cam_t": cam_t, "focal_length": np.tile([1060.0, 1055.0], (b, 1)),
               "camera_center": np.tile([960.0, 540.0], (b, 1)), "keypoints_2d": kp}
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    contact = (rng.uniform(size=(b, t + 1, 4)) > np.linspace(0.2, 0.9, b)[:, None, None]).astype(np.float32)
    return jbody, f32(joints), contact, f32(x), f32(mean), f32(std), {k: f32(v) for k, v in cameras.items()}


def test_global_reductions_over_two_ranks(tmp_path):
    """foot_skating_loss, the 'amass'/'prox' skating guidance loss, the 2-D
    reprojection loss and posenet_losses, with each rank holding 2 of 4
    clips: every rank's value is the single-process value (relative 1e-5:
    the same f32 sums in two parts; measured <= 2.2e-6) and the gathered
    row gradients are the single-process gradient (1e-5 of its largest
    entry). The two ranks'
    skating masks keep different counts, so the per-rank means' mean
    differs from the global mean there, and the value is also the JAX
    package's under a jit over a 2-device mesh (relative 1e-5)."""
    jbody, joints, contact, x, mean, std, cameras = _guidance_case()
    clean, out, _, _ = repr_batch(4, 4, 12)
    counts = _skating_mask_counts(joints, contact)
    assert counts[:2].sum() != counts[2:].sum() and counts.min() > 0
    res = ranks(tmp_path, workers.guidance_terms, 2, joints, contact, x, mean, std, cameras, out, clean, WEIGHTS)
    body = synthetic_model(num_verts=64, seed=3)

    def value_and_grad(fn, a):
        leaf = _t(a).requires_grad_()
        val = fn(leaf)
        return val.item(), torch.autograd.grad(val, leaf)[0].numpy()

    cano, cam_r_inv = camera_inverses(_t(cameras["transf_matrix"]), _t(cameras["cam_r"]))
    single = {
        "skating": value_and_grad(lambda j: foot_skating_loss(j, _t(contact)), joints),
        "guide_skating": value_and_grad(lambda v: skating_loss_fn(v, _t(mean), _t(std), body), x),
        "proj": value_and_grad(lambda v: projection_2d_loss_fn(
            v, _t(mean), _t(std), body, cano, cam_r_inv, _t(cameras["cam_t"]), _t(cameras["focal_length"]),
            _t(cameras["camera_center"]), _t(cameras["keypoints_2d"]), torch.as_tensor(GUIDANCE_2D_JOINTS)), x),
        "losses": value_and_grad(lambda o: posenet_losses(o, _t(clean), _t(mean), _t(std), body, WEIGHTS)["loss"],
                                 out),
    }
    per_rank_means = [foot_skating_loss(_t(joints[s]), _t(contact[s])).item() for s in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(per_rank_means) - single["skating"][0]) > 1e-3 * single["skating"][0]
    for key in ("skating", "guide_skating"):
        for r in res:
            np.testing.assert_allclose(float(r[key]), single[key][0], rtol=1e-5, err_msg=key)
    for key, gkey in (("skating", "skating_grad"), ("guide_skating", "guide_skating_grad"), ("proj", "proj_grad"),
                      ("losses", "losses_grad")):
        ref = single[key][1]
        assert np.abs(ref).max() > 0, key
        for r in res:
            np.testing.assert_allclose(r[gkey], ref, atol=1e-5 * np.abs(ref).max(), rtol=0, err_msg=gkey)
    ref_losses = posenet_losses(_t(out), _t(clean), _t(mean), _t(std), body, WEIGHTS)
    for r in res:
        assert sorted(r["losses"]) == sorted(ref_losses)
        for k, v in ref_losses.items():
            np.testing.assert_allclose(r["losses"][k], float(v), rtol=1e-5, atol=1e-9, err_msg=k)

    # the JAX package under GSPMD on 2 devices: the same global values
    mesh = jax_mesh2()
    data = NamedSharding(mesh, P("data"))
    put = lambda a: jax.device_put(jnp.asarray(a), data)  # noqa: E731
    j_skating = jax.jit(jax_foot_skating_loss)(put(joints), put(contact))
    np.testing.assert_allclose(float(res[0]["skating"]), float(j_skating), rtol=1e-5)
    j_guide = jax.jit(lambda v: jg.skating_loss_fn(v, mean, std, jbody))(put(x))
    np.testing.assert_allclose(float(res[1]["guide_skating"]), float(j_guide), rtol=1e-5)
    j_losses = jax.jit(lambda o, c: jax_posenet_losses(o, c, mean, std, jbody, WEIGHTS))(put(out), put(clean))
    for k, v in j_losses.items():
        np.testing.assert_allclose(res[0]["losses"][k], float(v), rtol=1e-5, atol=1e-7, err_msg=k)


def _cameras_per_row(joints, cameras: dict) -> dict:
    """The case's cameras with one camera per clip: a rotation of its own,
    the clip's scene-coord center 3.5 m along its z."""
    rng = np.random.default_rng(11)
    b = len(joints)
    cam_r = R.from_rotvec(rng.normal(scale=0.4, size=(b, 3))).as_matrix()
    centers = [(np.linalg.inv(cameras["transf_matrix"][i]) @ np.r_[joints[i, :, 0].mean(0), 1.0])[:3]
               for i in range(b)]
    cam_t = np.stack([c - r @ np.array([0.0, 0.0, 3.5]) for c, r in zip(centers, cam_r)])
    return dict(cameras, cam_r=cam_r.astype(np.float32), cam_t=cam_t.astype(np.float32))


@pytest.mark.parametrize("per_row", [False, True])
def test_prox_terms_over_two_ranks(tmp_path, per_row):
    """Both 'prox' guidance terms with their inputs sharded as
    RohmPipeline.run_batch shards them, the camera given once ([3, 3],
    [3]) or one per clip ([4, 3, 3], [4, 3], four distinct cameras): each
    rank's gathered row gradient is the single-process gradient (1e-5 of
    its largest entry, as above)."""
    _, joints, _, x, mean, std, cameras = _guidance_case()
    if per_row:
        cameras = _cameras_per_row(joints, cameras)
    res = ranks(tmp_path, workers.prox_terms, 2, x, mean, std, cameras)
    body = synthetic_model(num_verts=64, seed=3)
    specs = prox_guidance(_t(mean), _t(std), body, *(_t(cameras[k]) for k in GUIDANCE_DATA_KEYS))
    assert [s.name for s in specs] == ["proj2d", "skating"]
    for spec in specs:
        leaf = _t(x).requires_grad_()
        (ref,) = torch.autograd.grad(spec.loss_fn(leaf), leaf)
        ref = ref.numpy()
        assert np.abs(ref).max() > 0, spec.name
        for r in res:
            np.testing.assert_allclose(r[spec.name][1], ref, atol=1e-5 * np.abs(ref).max(), rtol=0, err_msg=spec.name)


# ---------------------------------------------------------------------------
# one optimizer step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["", "float32"])
def test_posenet_step_over_two_ranks(tmp_path, mode):
    """make_posenet_grads_fn and one AdamW step with each rank on 1 of the 2
    clips of test_torch_train_grads.py's step (fused_train `mode`, the
    kernels' plain versions here), the skating gate on, dropout 0 with
    the keep-masks handed in. The gradients are the single-process port's
    (1e-5 of each tensor's largest entry: two partial sums) and the JAX
    package's on a 2-device mesh (tgrads.GRAD_GATE); the losses are the
    single-process ones (relative 1e-6); the parameters after AdamW are the
    single-process port's and the JAX package's AdamW step's, as
    assert_same_adam_step holds them."""
    model, params, jbody, _ = tgrads.setup()
    batch, t, noise = tgrads._draws(0)
    _, _, mean, std = repr_batch(0, tgrads.B, tgrads.T)
    cfg = dict(latent_dim=tgrads.D, ff_size=tgrads.F, num_layers=tgrads.LAYERS, num_heads=tgrads.H, dropout=0.0)
    sd = {k: v.numpy() for k, v in posenet_state_dict(params, num_layers=tgrads.LAYERS).items()}
    b, s = tgrads.B, tgrads.T + 1
    ones = np.ones
    masks = (None, [(ones((b, tgrads.H, s, s), np.int8), ones((b, s, tgrads.D), np.int8),
                     ones((b, s, tgrads.F), np.int8), ones((b, s, tgrads.D), np.int8))] * tgrads.LAYERS)
    args = (sd, cfg, batch, t, noise, masks, mean, std, WEIGHTS, mode, True, LR)
    single = workers.posenet_step(None, *args)
    two = ranks(tmp_path, workers.posenet_step, 2, *args)

    jmesh = jax_mesh2()
    data, rep = NamedSharding(jmesh, P("data")), NamedSharding(jmesh, P())
    fn = jax_make_posenet_grads_fn(model, tgrads.jax_make_schedule("cosine", 1000), jnp.asarray(mean),
                                   jnp.asarray(std), jbody, WEIGHTS, mesh=jmesh, fused_train=mode or None)
    g_j, l_j = jax.jit(fn, in_shardings=(rep, data, data, data, rep, rep))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch), jnp.asarray(t),
        jnp.asarray(noise), jax.random.key(1, impl="rbg"), jnp.asarray(1.0))
    ref_j = posenet_state_dict(jax.tree.map(np.asarray, g_j), num_layers=tgrads.LAYERS)
    for r in two:
        for name, g in r["grads"].items():
            want = single["grads"][name]
            np.testing.assert_allclose(g, want, atol=1e-5 * np.abs(want).max() + 1e-9, rtol=0, err_msg=name)
            rj = ref_j[name].numpy()
            assert np.abs(g - rj).max() <= tgrads.GRAD_GATE[mode] * np.abs(rj).max() + 1e-7, name
        for k, v in single["losses"].items():
            np.testing.assert_allclose(r["losses"][k], v, rtol=1e-5, atol=1e-9, err_msg=k)
            np.testing.assert_allclose(r["losses"][k], float(l_j[k]), rtol=1e-5, atol=1e-7, err_msg=k)
        assert_same_adam_step(r["params"], single["params"], single["grads"], 1e-5, "single process")
    # the two ranks hold the same parameters, bit for bit
    for name in two[0]["params"]:
        np.testing.assert_array_equal(two[0]["params"][name], two[1]["params"][name])
    # and the JAX package's AdamW from its own gradients lands as close
    state_j = jax_create_train_state(jax.tree.map(jnp.asarray, params), LR, 0.0).apply_gradients(g_j)
    after_j = posenet_state_dict(jax.tree.map(np.asarray, state_j.params), num_layers=tgrads.LAYERS)
    assert_same_adam_step(two[0]["params"], {k: v.numpy() for k, v in after_j.items()},
                          {k: v.numpy() for k, v in ref_j.items()}, tgrads.GRAD_GATE[mode], "JAX")


def test_trajnet_step_over_two_ranks(tmp_path):
    """make_trajnet_grads_fn and one AdamW step, each rank on 1 of the 2
    clips of test_torch_train_trajnet.py's abs-only step: the gradients are
    the single-process port's (1e-5 of each tensor's largest entry) and the
    JAX package's under a jit over a 2-device mesh (1e-4, as in that file;
    the gauge biases, whose gradient is rounding noise, excepted), the
    losses relative 1e-5, the parameters after AdamW the single-process
    ones as assert_same_adam_step holds them."""
    params = ttraj.flax_params(False, True)
    sd = {k: v.numpy() for k, v in trajnet_state_dict(params, trajcontrol=False).items()}
    batch, t, noise = ttraj.draws(0, False, True)
    mean, std = ttraj.stats()
    cfg = dict(traj_feat_dim=13, cond_dim=13, mid_dim=ttraj.MID)
    args = (sd, cfg, batch, t, noise, mean, std, ttraj.WEIGHTS, True, LR)
    single = workers.trajnet_step(None, *args)
    two = ranks(tmp_path, workers.trajnet_step, 2, *args)

    jmesh = jax_mesh2()
    data, rep = NamedSharding(jmesh, P("data")), NamedSharding(jmesh, P())
    fn = ttraj.jax_grads_fn(False, True)
    g_j, l_j = jax.jit(fn, in_shardings=(rep, data, data, data))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch), jnp.asarray(t), jnp.asarray(noise))
    ref_j = trajnet_state_dict(jax.tree.map(np.asarray, g_j), trajcontrol=False)
    for r in two:
        for name, g in r["grads"].items():
            want, rj = single["grads"][name], ref_j[name].numpy()
            if ttraj.is_gauge(name, want):
                continue
            np.testing.assert_allclose(g, want, atol=1e-5 * np.abs(want).max() + 1e-9, rtol=0, err_msg=name)
            assert np.abs(g - rj).max() <= 1e-4 * np.abs(rj).max(), name
        for k, v in single["losses"].items():
            np.testing.assert_allclose(r["losses"][k], v, rtol=1e-5, atol=1e-9, err_msg=k)
            np.testing.assert_allclose(r["losses"][k], float(l_j[k]), rtol=1e-5, atol=1e-8, err_msg=k)
        assert_same_adam_step(r["params"], single["params"], single["grads"], 1e-5, "single process", ttraj.is_gauge)
    for name in two[0]["params"]:
        np.testing.assert_array_equal(two[0]["params"][name], two[1]["params"][name])
