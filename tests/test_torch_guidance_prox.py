"""The port's PROX/EgoBody guidance against the JAX package, on the CPU:
the pinhole projection, the 2-D keypoint reprojection loss through SMPL-X,
and the gradients of both terms of `prox_guidance` (reprojection and
skating) against `jax.grad` of the JAX functions, from seeded numpy
inputs: a synthetic motion encoded by the JAX package, a rigid
canonicalization transform per clip, a rotated camera 3.5 m away and
noisy keypoints with random confidences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from rohm_tpu.body import forward_joints as jax_fk
from rohm_tpu.body import synthetic_model as jax_synthetic_model
from rohm_tpu.data.synthetic import _synthetic_params
from rohm_tpu.models import guidance as jg
from rohm_tpu.reprs import get_repr as jax_get_repr
from rohm_tpu_torch.models import guidance as tg
from rohm_tpu_torch.utils.convert_flax import body_model_from_jax

torch.set_num_threads(1)

B, T = 2, 12


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def case():
    jbody = jax_synthetic_model(num_verts=64, seed=3)
    rng = np.random.default_rng(7)
    plist = [_synthetic_params(T + 1, seed=s) for s in range(B)]
    params = {k: np.stack([p[k] for p in plist]).astype(np.float32) for k in plist[0]}
    joints = np.asarray(jax_fk(jbody, params["betas"], params["global_orient"], params["body_pose"],
                               params["transl"]), np.float32)
    rep = np.asarray(jax_get_repr(jnp.asarray(joints), global_orient=params["global_orient"],
                                  transl=params["transl"], body_pose=params["body_pose"],
                                  betas=params["betas"]), np.float32)  # [B, T, 294]
    mean = rep.reshape(-1, 294).mean(0)
    std = rep.reshape(-1, 294).std(0) + 0.1
    mean[-4:], std[-4:] = 0.0, 1.0
    x = (rep - mean) / std
    x[..., -4:] = rng.uniform(0, 1, size=x[..., -4:].shape) > 0.3  # planted feet
    x = x + 0.05 * rng.standard_normal(x.shape)  # off the clean motion: a non-zero loss

    transf = np.tile(np.eye(4), (B, 1, 1))  # scene -> canonical, per clip
    transf[:, :3, :3] = R.from_euler("z", rng.uniform(-np.pi, np.pi, (B, 1))).as_matrix()
    transf[:, :3, 3] = rng.normal(scale=0.5, size=(B, 3))
    cam_r = R.from_rotvec(rng.normal(scale=0.4, size=3)).as_matrix()
    # the body's scene-coord center sits 3.5 m along the camera's z
    center = (np.linalg.inv(transf[0]) @ np.r_[joints[0, :, 0].mean(0), 1.0])[:3]
    cam_t = center - cam_r @ np.array([0.0, 0.0, 3.5])
    focal = np.tile([1060.0, 1055.0], (B, 1))
    c = np.tile([960.0, 540.0], (B, 1))
    kp = np.concatenate([rng.uniform([400, 100], [1500, 1000], size=(B, T + 3, 22, 2)),
                         rng.uniform(size=(B, T + 3, 22, 1))], -1)
    arrays = dict(x=x, mean=mean, std=std, transf=transf, cam_r=cam_r, cam_t=cam_t, focal=focal, c=c, kp=kp)
    return jbody, body_model_from_jax(jbody, "cpu"), {k: np.asarray(v, np.float32) for k, v in arrays.items()}


def test_perspective_projection_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2, 5, 22, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(0.05, 4.0, size=pts.shape[:-1])  # near-zero depths too
    f, c = rng.uniform(900, 1100, (2, 5, 2)).astype(np.float32), rng.uniform(500, 900, (2, 5, 2)).astype(np.float32)
    ref = np.asarray(jg.perspective_projection(pts, f, c))
    out = tg.perspective_projection(_t(pts), _t(f), _t(c)).numpy()
    np.testing.assert_array_equal(out, ref)  # the same three f32 operations in the same order


def test_projection_loss_matches_jax(case):
    """The loss value through SMPL-X FK in f32 on both sides (the port with
    its inverses taken once by `camera_inverses`): measured relative
    difference 2.5e-7, held to 1e-5."""
    jbody, tbody, a = case
    ref = float(jg.projection_2d_loss_fn(
        jnp.asarray(a["x"]), a["mean"], a["std"], jbody, a["transf"], a["cam_r"], a["cam_t"],
        a["focal"], a["c"], a["kp"]))
    inv, cam_r_inv = tg.camera_inverses(_t(a["transf"]), _t(a["cam_r"]))
    out = tg.projection_2d_loss_fn(_t(a["x"]), _t(a["mean"]), _t(a["std"]), tbody, inv, cam_r_inv,
                                   _t(a["cam_t"]), _t(a["focal"]), _t(a["c"]), _t(a["kp"]),
                                   torch.as_tensor(tg.GUIDANCE_2D_JOINTS)).item()
    assert ref > 10.0  # pixels: the joints are off the keypoints
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_prox_guidance_gradients_match_jax(case):
    """Each term's gradient wrt x (f32 chain rule through FK in another
    order): measured <= 6.4e-7 of the largest entry, held to 1e-4; the
    weights, thresholds and masks equal."""
    jbody, tbody, a = case
    jspecs = jg.prox_guidance(a["mean"], a["std"], jbody, a["transf"], a["cam_r"], a["cam_t"],
                              a["focal"], a["c"], a["kp"])
    tspecs = tg.prox_guidance(_t(a["mean"]), _t(a["std"]), tbody, _t(a["transf"]), _t(a["cam_r"]),
                              _t(a["cam_t"]), _t(a["focal"]), _t(a["c"]), _t(a["kp"]))
    assert len(tspecs) == len(jspecs) == 2
    for js, ts in zip(jspecs, tspecs):
        assert (ts.weight, ts.t_threshold) == (js.weight, js.t_threshold)
        np.testing.assert_array_equal(ts.grad_mask.numpy(), np.asarray(js.grad_mask))
        ref_loss, ref_grad = jax.jit(jax.value_and_grad(js.loss_fn))(jnp.asarray(a["x"]))
        xt = _t(a["x"]).requires_grad_()
        loss = ts.loss_fn(xt)
        (grad,) = torch.autograd.grad(loss, xt)
        assert float(ref_loss) > 0
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
        g, gr = grad.numpy(), np.asarray(ref_grad)
        assert np.isfinite(g).all() and np.abs(gr).max() > 0
        np.testing.assert_allclose(g, gr, atol=1e-4 * np.abs(gr).max())
