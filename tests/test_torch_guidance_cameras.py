"""The 'prox' guidance with one camera per row (cam_r [B, 3, 3], cam_t
[B, 3]) on the CPU: the same camera on every row gives the one-camera
form's losses and gradients bit for bit, the one-camera form is the
reprojection as it was before per-row cameras, and distinct cameras agree
with the benchmark's plain reference (port_bench/reference/reprojection.py).
Inputs: the benchmark's synthetic PROX recordings (port_bench/harness/
video.py), four windows of four recordings, each with its own camera."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rohm_tpu_torch.body.model import SMPLX_PARENTS, make_model
from rohm_tpu_torch.models import guidance as tg
from rohm_tpu_torch.pipeline import GUIDANCE_DATA_KEYS
from rohm_tpu_torch.reprs.decode import recover_from_repr
from rohm_tpu_torch.reprs.schema import split_repr

BENCH = Path(__file__).resolve().parents[1] / "port_bench"
ROWS, CLIP_LEN = 4, 33


@pytest.fixture(scope="module")
def case():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness import inputs
    from harness.video import make_recordings
    from reference.body import make_model as ref_make_model

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        arrays, ref_body = inputs.make_body(5, "cpu", 512)
        noise = {"global_orient_deg": 3, "body_pose_deg": 3, "transl": 0.03, "betas": 0.1}
        pool = make_recordings(ref_body, ROWS, 1, CLIP_LEN, 2, 2**31 + 27, noise, "cpu")
    finally:
        torch.set_num_threads(n)
    data = {k: torch.as_tensor(v) for k, v in pool.items()}
    g = torch.Generator().manual_seed(3)
    # off the input motion, so that both terms' losses are not at a kink
    x = data["pose_noisy"][:, : CLIP_LEN - 2] + 0.05 * torch.randn(ROWS, CLIP_LEN - 2, 294, generator=g)
    x[..., -4:] = (torch.rand(ROWS, CLIP_LEN - 2, 4, generator=g) > 0.3).float()  # planted feet
    return {"x": x, "data": data, "body": make_model(arrays, SMPLX_PARENTS, "cpu"),
            "ref_body": ref_make_model(arrays, inputs.SMPLX_PARENTS, "cpu")}


def specs(case, **cameras):
    d = dict(case["data"], **cameras)
    return tg.prox_guidance(d["mean"], d["std"], case["body"], *(d[k] for k in GUIDANCE_DATA_KEYS))


def value_and_grad(fn, x):
    leaf = x.clone().requires_grad_()
    loss = fn(leaf)
    return loss.detach(), torch.autograd.grad(loss, leaf)[0]


def test_cameras_differ_per_row(case):
    cam_r = case["data"]["cam_r"]
    assert cam_r.shape == (ROWS, 3, 3) and case["data"]["cam_t"].shape == (ROWS, 3)
    assert all(not torch.equal(cam_r[0], cam_r[i]) for i in range(1, ROWS))


def test_one_camera_per_row_equals_one_camera_bit_for_bit(case):
    """Every row given the first row's camera as [B, 3, 3] and [B, 3] (its
    own copy per row) against [3, 3] and [3]: the same losses and gradients
    of both terms, bit for bit."""
    cam_r, cam_t = case["data"]["cam_r"][0], case["data"]["cam_t"][0]
    one = specs(case, cam_r=cam_r, cam_t=cam_t)
    rows = specs(case, cam_r=cam_r.repeat(ROWS, 1, 1), cam_t=cam_t.repeat(ROWS, 1))
    assert [s.name for s in one] == [s.name for s in rows] == ["proj2d", "skating"]
    for a, b in zip(one, rows):
        (la, ga), (lb, gb) = value_and_grad(a.loss_fn, case["x"]), value_and_grad(b.loss_fn, case["x"])
        assert float(la) > 0 and ga.abs().max() > 0, a.name
        assert torch.equal(la, lb) and torch.equal(ga, gb), a.name


def _projection_loss_one_camera(x, mean, std, body_model, cano_to_scene, cam_r_inv, cam_t, focal_length,
                                camera_center, keypoints_2d, joint_index):
    """projection_2d_loss_fn as it was before per-row cameras (one camera
    for the batch), for the bit-for-bit check of that form."""
    d = split_repr(x * std + mean)
    joints = recover_from_repr(d, mode="smplx_params", body_model=body_model)
    r = cano_to_scene[:, :3, :3]
    t = cano_to_scene[:, :3, 3]
    scene = torch.einsum("bij,btnj->btni", r, joints) + t[:, None, None, :]
    cam = torch.einsum("ij,btnj->btni", cam_r_inv, scene - cam_t)
    proj = tg.perspective_projection(cam, focal_length[:, None, :], camera_center[:, None, :])
    kp = keypoints_2d[:, : joints.shape[-3]]
    return ((proj - kp[..., :2]).abs() * kp[..., 2:3])[..., joint_index, :].mean()


def test_one_camera_form_is_unchanged(case):
    d = case["data"]
    cam_r, cam_t = d["cam_r"][1], d["cam_t"][1]
    inv, cam_r_inv = tg.camera_inverses(d["transf_matrix"], cam_r)
    args = (d["mean"], d["std"], case["body"], inv, cam_r_inv, cam_t, d["focal_length"], d["camera_center"],
            d["keypoints_2d"], torch.as_tensor(tg.GUIDANCE_2D_JOINTS))
    la, ga = value_and_grad(lambda v: tg.projection_2d_loss_fn(v, *args), case["x"])
    lb, gb = value_and_grad(lambda v: _projection_loss_one_camera(v, *args), case["x"])
    assert torch.equal(la, lb) and torch.equal(ga, gb)


def test_per_row_cameras_match_the_plain_reference(case):
    """Distinct cameras: the port's projection_2d_loss_fn and its gradient
    through SMPL-X against the reference's reprojection_loss, which takes
    the same path in another order of operations (batched matmuls where
    the port has einsums, the projection's division and scaling in one
    expression). Measured: the same loss, the gradient 1.5e-7 of its
    largest entry apart; held to 1e-5 relative and 1e-5 of the largest
    entry (f32 rounding through the FK chain, with a margin of 60)."""
    from reference.reprojection import camera_inverses as ref_inverses, reprojection_loss

    d = case["data"]
    inv, cam_r_inv = tg.camera_inverses(d["transf_matrix"], d["cam_r"])
    port = (d["mean"], d["std"], case["body"], inv, cam_r_inv, d["cam_t"], d["focal_length"], d["camera_center"],
            d["keypoints_2d"], torch.as_tensor(tg.GUIDANCE_2D_JOINTS))
    r_inv, r_cam_inv = ref_inverses(d["transf_matrix"], d["cam_r"])
    ref = (d["mean"], d["std"], case["ref_body"], r_inv, r_cam_inv, d["cam_t"], d["focal_length"],
           d["camera_center"], d["keypoints_2d"])
    lp, gp = value_and_grad(lambda v: tg.projection_2d_loss_fn(v, *port), case["x"])
    lr, gr = value_and_grad(lambda v: reprojection_loss(v, *ref), case["x"])
    assert float(lr) > 1.0  # pixels: the joints are off the keypoints
    np.testing.assert_allclose(float(lp), float(lr), rtol=1e-5)
    np.testing.assert_allclose(gp.numpy(), gr.numpy(), atol=1e-5 * float(gr.abs().max()), rtol=0)
    # another row's camera moves the loss: the rows are not all on one camera
    one = tg.projection_2d_loss_fn(case["x"], *port[:4], cam_r_inv[0], d["cam_t"][0], *port[6:])
    assert abs(float(one) - float(lp)) > 1e-3 * float(lp)


def test_a_camera_form_mismatch_is_refused(case):
    d = case["data"]
    cam_r, cam_t = d["cam_r"], d["cam_t"]
    for r, t in ((cam_r, cam_t[0]), (cam_r[0], cam_t), (cam_r[None], cam_t[None])):
        with pytest.raises(ValueError, match="expected"):
            specs(case, cam_r=r, cam_t=t)
