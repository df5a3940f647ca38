"""The port's geometry, SMPL-X joints, repr encoder/decoder and skating
guidance loss against the JAX package, on the CPU, from seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rohm_tpu import geometry as jgeo
from rohm_tpu.body import forward_joints as jax_fk
from rohm_tpu.body import load_smplx_npz as jax_load_npz
from rohm_tpu.body import synthetic_model as jax_synthetic_model
from rohm_tpu.body.model import NUM_JOINTS, SMPLX_PARENTS
from rohm_tpu.data.synthetic import _synthetic_params
from rohm_tpu.models.guidance import skating_loss_fn as jax_skating_loss
from rohm_tpu.reprs import get_repr as jax_get_repr
from rohm_tpu.reprs import recover_from_repr as jax_recover
from rohm_tpu_torch import geometry as tgeo
from rohm_tpu_torch.body import forward_joints, load_smplx_npz, synthetic_model
from rohm_tpu_torch.models.guidance import skating_loss_fn
from rohm_tpu_torch.reprs import get_repr, recover_from_repr
from rohm_tpu_torch.utils.convert_flax import body_model_from_jax

torch.set_num_threads(1)

T = 12  # frames per clip
N_CLIPS = 2


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def bodies():
    return jax_synthetic_model(num_verts=64, seed=3), synthetic_model(num_verts=64, seed=3)


@pytest.fixture(scope="module")
def clips(bodies):
    """Smooth synthetic SMPL-X clips [N_CLIPS, T, ...] and their FK joints."""
    jbody, _ = bodies
    plist = [_synthetic_params(T, seed=s) for s in range(N_CLIPS)]
    params = {k: np.stack([p[k] for p in plist]).astype(np.float32) for k in plist[0]}
    joints = _np(jax_fk(jbody, params["betas"], params["global_orient"], params["body_pose"],
                        params["transl"]))
    return params, joints


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _rotations(rng, n=64):
    aa = rng.normal(scale=1.2, size=(n, 3)).astype(np.float32)
    aa[0] = 0.0  # identity: the series branch of every conversion
    aa[1] = [np.pi, 0.0, 0.0]  # 180 degrees: the non-w Shepperd branches
    aa[2] = [0.0, 1e-4, 0.0]  # below the eps switch
    return aa


@pytest.mark.parametrize("name", [
    "aa_to_rotmat", "aa_to_quat", "rotmat_to_quat", "rotmat_to_aa", "quat_to_aa",
    "quat_to_rotmat", "rot6d_to_rotmat", "rotmat_to_rot6d",
])
def test_rotation_conversions_match_jax(name):
    rng = np.random.default_rng(0)
    aa = _rotations(rng)
    inputs = {
        "aa_to_rotmat": aa, "aa_to_quat": aa,
        "rotmat_to_quat": _np(jgeo.aa_to_rotmat(aa)), "rotmat_to_aa": _np(jgeo.aa_to_rotmat(aa)),
        "quat_to_aa": _np(jgeo.aa_to_quat(aa)), "quat_to_rotmat": _np(jgeo.aa_to_quat(aa)),
        "rot6d_to_rotmat": rng.normal(size=(64, 6)).astype(np.float32),
        "rotmat_to_rot6d": _np(jgeo.aa_to_rotmat(aa)),
    }[name]
    ref = _np(getattr(jgeo, name)(jnp.asarray(inputs)))
    out = getattr(tgeo, name)(_t(inputs)).numpy()
    # f32 both sides; elementary functions differ by ulps (sqrt/atan2 near
    # the 180-degree branch amplify them to ~1e-5 in the angle)
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=1e-5)


def test_quaternion_algebra_matches_jax():
    rng = np.random.default_rng(1)
    q = _np(jgeo.qnormalize(jnp.asarray(rng.normal(size=(32, 4)))))
    r = _np(jgeo.qnormalize(jnp.asarray(rng.normal(size=(32, 4)))))
    v = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(tgeo.qmul(_t(q), _t(r)).numpy(), _np(jgeo.qmul(q, r)), atol=1e-6)
    np.testing.assert_allclose(tgeo.qrot(_t(q), _t(v)).numpy(), _np(jgeo.qrot(q, v)), atol=1e-5)
    np.testing.assert_array_equal(tgeo.qinv(_t(q)).numpy(), _np(jgeo.qinv(q)))
    np.testing.assert_allclose(tgeo.qbetween(_t(v), _t(v[::-1].copy())).numpy(),
                               _np(jgeo.qbetween(v, v[::-1].copy())), atol=1e-5)
    mats = _np(jgeo.aa_to_rotmat(_rotations(rng, 33)))
    drdt = mats[1:] - mats[:-1]
    np.testing.assert_allclose(
        tgeo.skew_angular_velocity(_t(mats[:-1]), _t(drdt)).numpy(),
        _np(jgeo.skew_angular_velocity(mats[:-1], drdt)), atol=1e-6)


@pytest.mark.parametrize("name", ["aa_to_rotmat", "rotmat_to_aa", "rot6d_to_rotmat"])
def test_rotation_gradients_match_jax_at_singular_points(name):
    """Guidance differentiates through these; the double-where keeps the
    gradient finite at 0 and at the identity, as in the JAX package."""
    rng = np.random.default_rng(2)
    aa = _rotations(rng, 16)
    x = {"aa_to_rotmat": aa, "rotmat_to_aa": _np(jgeo.aa_to_rotmat(aa)),
         "rot6d_to_rotmat": _np(jgeo.rotmat_to_rot6d(jgeo.aa_to_rotmat(aa)))}[name]
    w = rng.normal(size=np.shape(getattr(jgeo, name)(jnp.asarray(x)))).astype(np.float32)
    ref = _np(jax.grad(lambda a: jnp.sum(getattr(jgeo, name)(a) * w))(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    (g,) = torch.autograd.grad((getattr(tgeo, name)(xt) * _t(w)).sum(), xt)
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(g.numpy(), ref, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# body model
# ---------------------------------------------------------------------------


def test_synthetic_model_same_arrays(bodies):
    jbody, tbody = bodies
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(tbody, name).numpy(), _np(getattr(jbody, name)))
    # the precomputed joint tables are f32 products on both sides
    np.testing.assert_allclose(tbody.j_template.numpy(), _np(jbody.j_template), atol=1e-6)
    np.testing.assert_allclose(tbody.j_shapedirs.numpy(), _np(jbody.j_shapedirs), atol=1e-7)
    assert tbody.parents == jbody.parents
    converted = body_model_from_jax(jbody, "cpu")
    np.testing.assert_array_equal(converted.j_template.numpy(), _np(jbody.j_template))


def test_load_smplx_npz_matches_jax(tmp_path, bodies):
    jbody, _ = bodies
    rng = np.random.default_rng(3)
    v = jbody.num_verts
    shapedirs = np.concatenate(
        [np.asarray(jbody.shapedirs, np.float64), rng.normal(size=(v, 3, 20)) * 0.01], axis=-1)
    kintree = np.zeros((2, NUM_JOINTS), np.uint32)
    kintree[0] = np.array([2**32 - 1] + list(SMPLX_PARENTS[1:]), np.int64).astype(np.uint32)
    kintree[1] = np.arange(NUM_JOINTS, dtype=np.uint32)
    path = str(tmp_path / "SMPLX_NEUTRAL.npz")
    np.savez(path, v_template=np.asarray(jbody.v_template, np.float64), shapedirs=shapedirs,
             posedirs=np.asarray(jbody.posedirs, np.float64).T.reshape(v, 3, 486),
             J_regressor=np.asarray(jbody.j_regressor, np.float64),
             weights=np.asarray(jbody.lbs_weights, np.float64), kintree_table=kintree,
             f=rng.integers(0, v, size=(8, 3)).astype(np.uint32))
    jl, tl = jax_load_npz(path), load_smplx_npz(path, "cpu")
    assert tl.parents == jl.parents
    np.testing.assert_array_equal(tl.faces, np.asarray(jl.faces))
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(), _np(getattr(jl, name)))


def test_forward_joints_matches_jax(bodies, clips):
    jbody, tbody = bodies
    params, ref = clips
    p = {k: _t(v) for k, v in params.items()}
    out = forward_joints(tbody, p["betas"], p["global_orient"], p["body_pose"], p["transl"])
    # f32 kinematic chain of 3x3 products in another summation order
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    mats = tgeo.aa_to_rotmat(p["body_pose"].reshape(N_CLIPS, T, 21, 3))
    out_m = forward_joints(tbody, p["betas"], None, None, p["transl"],
                           global_orient_mat=tgeo.aa_to_rotmat(p["global_orient"]), body_pose_mat=mats)
    np.testing.assert_allclose(out_m.numpy(), ref, atol=1e-5)


# ---------------------------------------------------------------------------
# reprs
# ---------------------------------------------------------------------------


def _jax_repr(joints, params):
    fn = jax.jit(lambda j, p: jax_get_repr(j, global_orient=p["global_orient"], transl=p["transl"],
                                           body_pose=p["body_pose"], betas=p["betas"]))
    return _np(fn(joints, params))


def _repr_inputs(clips):
    params, joints = clips
    joints = joints.copy()
    # one frame whose forward direction is -y: qbetween degenerates and the
    # encoder patches the frame with the previous frame's heading
    joints[0, 5, [1, 2, 16, 17]] = [[0, 0, 1], [1, 0, 1], [1, 0, 1.5], [0, 0, 1.5]]
    return params, joints


def test_get_repr_matches_jax(clips):
    params, joints = _repr_inputs(clips)
    ref = _jax_repr(joints, params)
    out = get_repr(_t(joints), global_orient=_t(params["global_orient"]), transl=_t(params["transl"]),
                   body_pose=_t(params["body_pose"]), betas=_t(params["betas"])).numpy()
    assert out.shape == (N_CLIPS, T - 1, 294)
    # f32 both sides; atan2/sqrt ulps; contact labels are thresholds of the
    # same positions and agree exactly
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(out[..., -4:], ref[..., -4:])


@pytest.mark.parametrize("mode", ["joint_abs_traj", "smplx_params"])
def test_recover_from_repr_matches_jax(bodies, clips, mode):
    jbody, tbody = bodies
    params, joints = clips
    rep = _jax_repr(joints, params)
    ref = _np(jax.jit(lambda r: jax_recover(r, mode=mode, body_model=jbody))(rep))
    out = recover_from_repr(_t(rep), mode=mode, body_model=tbody).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)
    # decoding the encoder's output gives back the FK joints
    np.testing.assert_allclose(out, joints[:, :-1], atol=1e-4)


def test_skating_loss_and_gradient_match_jax(bodies, clips):
    jbody, tbody = bodies
    params, joints = clips
    rep = _jax_repr(joints, params)
    rng = np.random.default_rng(4)
    mean = rep.reshape(-1, 294).mean(0)
    std = rep.reshape(-1, 294).std(0) + 0.1
    mean[-4:], std[-4:] = 0.0, 1.0
    x = (rep - mean) / std
    x[..., -4:] = rng.uniform(0, 1, size=x[..., -4:].shape) > 0.3  # planted feet
    ref_loss, ref_grad = jax.jit(jax.value_and_grad(
        lambda a: jax_skating_loss(a, jnp.asarray(mean), jnp.asarray(std), jbody)))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    loss = skating_loss_fn(xt, _t(mean), _t(std), tbody)
    (grad,) = torch.autograd.grad(loss, xt)
    assert float(ref_loss) > 0  # the mask is not empty: the gradient is not trivially 0
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    g, gr = grad.numpy(), _np(ref_grad)
    assert np.isfinite(g).all()
    # f32 chain rule through FK in another order: relative to the largest entry
    np.testing.assert_allclose(g, gr, atol=1e-4 * np.abs(gr).max())
