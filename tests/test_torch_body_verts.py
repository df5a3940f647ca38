"""The port's full SMPL-X forward against the JAX package, on the CPU:
`forward_joints` past the 22 body joints (25 and 55), `forward_vertices`
from axis-angle and from rotation matrices, and `recover_from_repr(...,
return_verts=True)`, on one synthetic body carried across with
`convert_flax.body_model_from_jax` and seeded numpy inputs."""

import numpy as np
import pytest
import torch

from rohm_tpu.body import forward_joints as jax_forward_joints
from rohm_tpu.body import forward_vertices as jax_forward_vertices
from rohm_tpu.body import synthetic_model as jax_synthetic_model
from rohm_tpu.data.synthetic import _synthetic_params
from rohm_tpu.geometry import aa_to_rotmat as jax_aa_to_rotmat
from rohm_tpu.reprs import recover_from_repr as jax_recover
from rohm_tpu_torch.body import NUM_JOINTS, forward_joints, forward_vertices
from rohm_tpu_torch.reprs import get_repr, recover_from_repr
from rohm_tpu_torch.utils.convert_flax import body_model_from_jax

torch.set_num_threads(1)

N, T = 2, 6  # clips x frames


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def bodies():
    jbody = jax_synthetic_model(num_verts=96, seed=5)
    return jbody, body_model_from_jax(jbody, "cpu")


@pytest.fixture(scope="module")
def params():
    """Posed bodies [N, T, ...] with rotations of up to ~2 rad per joint."""
    rng = np.random.default_rng(1)
    return {
        "betas": rng.normal(scale=0.8, size=(N, T, 10)).astype(np.float32),
        "global_orient": rng.normal(scale=1.0, size=(N, T, 3)).astype(np.float32),
        "body_pose": rng.normal(scale=0.6, size=(N, T, 63)).astype(np.float32),
        "transl": rng.normal(size=(N, T, 3)).astype(np.float32),
    }


def _args(p):
    return p["betas"], p["global_orient"], p["body_pose"], p["transl"]


@pytest.mark.parametrize("num_joints", [25, NUM_JOINTS])
def test_forward_joints_past_the_body(bodies, params, num_joints):
    """f32 chains of products in another order: measured <= 2.4e-7 m on
    joints up to ~3 m from the origin; held at 1e-5."""
    jbody, tbody = bodies
    ref = np.asarray(jax_forward_joints(jbody, *_args(params), num_joints=num_joints))
    got = forward_joints(tbody, *map(_t, _args(params)), num_joints=num_joints).numpy()
    assert got.shape == ref.shape == (N, T, num_joints, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # the first 22 are the body joints of the guided path, unchanged
    body22 = forward_joints(tbody, *map(_t, _args(params)))
    np.testing.assert_array_equal(got[..., :22, :], body22.numpy())


def test_forward_joints_refuses_more_than_55(bodies, params):
    with pytest.raises(ValueError, match="num_joints"):
        forward_joints(bodies[1], *map(_t, _args(params)), num_joints=56)


@pytest.mark.parametrize("route", ["axis_angle", "matrices"])
def test_forward_vertices_matches_jax(bodies, params, route):
    """Shape and pose blendshapes, then LBS with the weights contracted with
    the 3 x 4 part of the skinning matrices (the JAX package builds the
    4 x 4): the same f32 function up to summation order. Measured <= 4.8e-7
    m on vertices and joints; held at 1e-5."""
    jbody, tbody = bodies
    if route == "axis_angle":
        jkw, tkw = {}, {}
        jargs, targs = _args(params), tuple(map(_t, _args(params)))
    else:
        go = np.asarray(jax_aa_to_rotmat(params["global_orient"]))
        bp = np.asarray(jax_aa_to_rotmat(params["body_pose"].reshape(N, T, 21, 3)))
        zeros = (np.zeros((N, T, 3), np.float32), np.zeros((N, T, 63), np.float32))
        jargs = (params["betas"], *zeros, params["transl"])
        targs = (_t(params["betas"]), None, None, _t(params["transl"]))
        jkw = {"global_orient_mat": go, "body_pose_mat": bp}
        tkw = {"global_orient_mat": _t(go), "body_pose_mat": _t(bp)}
    jv, jj = (np.asarray(a) for a in jax_forward_vertices(jbody, *jargs, **jkw))
    tv, tj = forward_vertices(tbody, *targs, **tkw)
    assert tv.shape == jv.shape == (N, T, 96, 3) and tj.shape == jj.shape == (N, T, NUM_JOINTS, 3)
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tj.numpy(), jj, atol=1e-5, rtol=0)
    # the mesh moves with the pose: posed vertices are not the rest template
    assert np.abs(jv - np.asarray(jbody.v_template)).max() > 0.1


def test_forward_vertices_gradient_is_finite(bodies, params):
    """Guidance-style use: autograd through the whole forward."""
    _, tbody = bodies
    args = [_t(a).requires_grad_() for a in _args(params)]
    verts, joints = forward_vertices(tbody, *args)
    (verts.square().sum() + joints.sum()).backward()
    assert all(torch.isfinite(a.grad).all() and a.grad.abs().max() > 0 for a in args)


def test_recover_from_repr_returns_verts(bodies):
    """The smplx_params decode with return_verts: (joints [.., 22, 3], verts)
    from rot6d matrices through forward_vertices, on reprs the port encoded
    from smooth synthetic motion; measured <= 2.4e-7 m, held at 1e-5."""
    jbody, tbody = bodies
    p = {k: _t(v[None]) for k, v in _synthetic_params(T + 1, seed=2).items()}
    joints = forward_joints(tbody, p["betas"], p["global_orient"], p["body_pose"], p["transl"])
    repr_ = get_repr(joints, global_orient=p["global_orient"], transl=p["transl"],
                     body_pose=p["body_pose"], betas=p["betas"])
    jj, jv = (np.asarray(a) for a in jax_recover(repr_.numpy(), mode="smplx_params",
                                                  body_model=jbody, return_verts=True))
    tj, tv = recover_from_repr(repr_, mode="smplx_params", body_model=tbody, return_verts=True)
    assert tj.shape == jj.shape == (1, T, 22, 3) and tv.shape == jv.shape == (1, T, 96, 3)
    np.testing.assert_allclose(tj.numpy(), jj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-5, rtol=0)
    # its joints are the joints-only decode's
    np.testing.assert_allclose(
        tj.numpy(), recover_from_repr(repr_, mode="smplx_params", body_model=tbody).numpy(),
        atol=1e-6, rtol=0)
