"""The port's viz/ and utils/profiling.py, and utils/runlog.fixseed, against
the JAX package's on the CPU.

open3d, pyrender and trimesh are absent on this host and on the card's
machine: every viz entry point must raise the JAX package's exception, type
and message, on the same inputs. The numpy helpers must give the JAX
package's values on seeded inputs, and the port's vertex decode for
rendering the JAX package's `recover_from_repr(return_verts=True)`.
"""

import dataclasses
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the exception is what is compared
        return type(e), str(e)
    raise AssertionError("no exception")


@pytest.fixture(scope="module")
def bodies():
    """The JAX package's synthetic body and the port's copy of it, each
    with a one-triangle face array (the synthetic body has none, and every
    render entry checks for faces before it reaches pyrender)."""
    from rohm_tpu.body import synthetic_model as jax_synthetic_model
    from rohm_tpu_torch.utils.convert_flax import body_model_from_jax

    jbody = jax_synthetic_model()
    tbody = body_model_from_jax(jbody, "cpu")
    faces = np.array([[0, 1, 2]], np.int64)
    return jbody.replace(faces=faces), dataclasses.replace(tbody, faces=faces)


@pytest.fixture(scope="module")
def saved():
    rng = np.random.default_rng(0)
    return {
        "rec_ric_data_clean_list": rng.standard_normal((2, 5, 22, 3)).astype(np.float32),
        "rec_ric_data_rec_list_from_smpl": rng.standard_normal((2, 5, 22, 3)).astype(np.float32),
        "motion_repr_rec_list": rng.standard_normal((2, 5, 294)).astype(np.float32),
        "trans_scene2cano_list": np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
        "frame_name_list": [["f0"] * 5, ["f1"] * 5],
        "mask_scheme": "lower",
    }


def _entry_points(viz, skeleton, render, body, saved, tmp):
    joints = np.zeros((22, 3))
    cam = {"f": [1000.0, 1000.0], "c": [960.0, 540.0]}
    return {
        "vis_skeleton": lambda: skeleton.vis_skeleton(joints),
        "vis_foot_contact": lambda: skeleton.vis_foot_contact(joints, np.ones(4)),
        "body_mesh": lambda: skeleton.body_mesh(np.zeros((3, 3)), np.array([[0, 1, 2]])),
        "animate_skeletons": lambda: viz.animate_skeletons([np.zeros((3, 22, 3))], [(1.0, 0.0, 0.0)]),
        "visualize_amass_results": lambda: viz.visualize_amass_results(saved),
        "visualize_amass_results render": lambda: viz.visualize_amass_results(
            saved, render=True, body_model=body, render_save_path=str(tmp / "r")),
        "render_amass_results": lambda: viz.render_amass_results(saved, body, str(tmp / "r")),
        "render_prox_overlay": lambda: viz.render_prox_overlay(saved, body, str(tmp), cam, str(tmp / "p")),
        "material": lambda: render.material(render.COLOR_BODY_GT),
        "create_render_cam": lambda: render.create_render_cam(960, 540, 1000.0, 1000.0),
        "checkerboard_floor": lambda: render.checkerboard_floor(np.eye(4)),
        "create_scene": lambda: render.create_scene(None, np.eye(4), None),
        "add_body_mesh": lambda: render.add_body_mesh(None, np.zeros((3, 3)), np.array([[0, 1, 2]])),
        "render_rgba": lambda: render.render_rgba(None),
    }


def test_viz_entry_points_raise_the_jax_errors(bodies, saved, tmp_path):
    import rohm_tpu.viz as jviz
    import rohm_tpu.viz.render as jrender
    import rohm_tpu.viz.skeleton as jskeleton
    import rohm_tpu_torch.viz as tviz
    import rohm_tpu_torch.viz.render as trender
    import rohm_tpu_torch.viz.skeleton as tskeleton

    jbody, tbody = bodies
    jax_calls = _entry_points(jviz, jskeleton, jrender, jbody, saved, tmp_path)
    port_calls = _entry_points(tviz, tskeleton, trender, tbody, saved, tmp_path)
    for name, call in port_calls.items():
        got, want = _raised(call), _raised(jax_calls[name])
        assert issubclass(got[0], ImportError), (name, got)
        assert got == want, name
    assert tviz.LIMBS_BODY_SMPL == jviz.LIMBS_BODY_SMPL


def test_rotation_from_z_and_cam_extrinsic(rng):
    from rohm_tpu.viz.skeleton import _rotation_from_z as j_rot
    from rohm_tpu.viz.skeleton import update_cam_extrinsic as j_cam
    from rohm_tpu_torch.viz.skeleton import _rotation_from_z as t_rot
    from rohm_tpu_torch.viz.skeleton import update_cam_extrinsic as t_cam

    dirs = [*rng.standard_normal((16, 3)), np.array([0.0, 0.0, 2.0]), np.array([0.0, 0.0, -0.5])]
    for d in dirs:
        r = t_rot(d)
        np.testing.assert_array_equal(r, j_rot(d))
        np.testing.assert_allclose(r @ np.array([0.0, 0.0, 1.0]), d / np.linalg.norm(d), atol=1e-12)
    for _ in range(4):
        trans = np.eye(4)
        trans[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        trans[:3, 3] = rng.standard_normal(3)
        got = t_cam(SimpleNamespace(), trans).extrinsic
        np.testing.assert_array_equal(got, j_cam(SimpleNamespace(), trans).extrinsic)


def test_occluded_vertex_alpha_and_overlay(bodies, rng):
    from rohm_tpu.viz.render import overlay_on_image as j_overlay
    from rohm_tpu.viz.results import occluded_vertex_alpha as j_alpha
    from rohm_tpu_torch.viz.render import overlay_on_image as t_overlay
    from rohm_tpu_torch.viz.results import occluded_vertex_alpha as t_alpha

    jbody, tbody = bodies
    for scheme in ("lower", "upper", "full", ""):
        a, b = t_alpha(tbody, scheme), j_alpha(jbody, scheme)
        assert (a is None) == (b is None) == (scheme not in ("lower", "upper")), scheme
        if a is not None:
            np.testing.assert_array_equal(a, b)
            assert 0 < (a < 1).sum() < len(a)
    rgba = rng.integers(0, 256, (6, 7, 4), dtype=np.uint8)
    image = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(t_overlay(rgba, image), j_overlay(rgba, image))


def test_decode_vertices_matches_jax(bodies, rng):
    """The vertices a render entry decodes from one saved clip: the port's
    `decode_vertices` against the JAX package's recover_from_repr on the
    same repr: f32 FK and LBS in each framework, measured ~1e-6."""
    import jax.numpy as jnp

    from rohm_tpu.reprs import recover_from_repr, split_repr
    from rohm_tpu_torch.viz.results import decode_vertices

    jbody, tbody = bodies
    rec = (0.3 * rng.standard_normal((5, 294))).astype(np.float32)
    _, want = recover_from_repr(split_repr(jnp.asarray(rec)), mode="smplx_params", body_model=jbody,
                                return_verts=True)
    got = decode_vertices(rec, tbody)
    assert got.shape == (5, tbody.num_verts, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_profile_kv_like_jax():
    from rohm_tpu.utils import profiling as jprof
    from rohm_tpu_torch.utils import profiling as tprof

    out = {}
    for prof in (jprof, tprof):
        prof.reset_timings()

        @prof.profile
        def work():
            return sum(range(1000))

        for _ in range(3):
            with prof.profile_kv("block"):
                work()
        out[prof] = prof.get_timings()
        prof.reset_timings()
        assert prof.get_timings() == {}
    j, t = out[jprof], out[tprof]
    assert sorted(t) == sorted(j) == ["block", "work"]
    assert {k: n for k, (_, n) in t.items()} == {k: n for k, (_, n) in j.items()} == {"block": 3, "work": 3}
    assert all(s >= 0 for s, _ in t.values()) and t["block"][0] >= t["work"][0]


def test_fixseed_like_jax():
    """The same python and numpy draws after either fixseed; the port's
    returns a torch.Generator seeded with `seed` and seeds torch's global RNG."""
    import jax

    from rohm_tpu.utils.runlog import fixseed as j_fixseed
    from rohm_tpu_torch.utils.runlog import fixseed as t_fixseed

    key = j_fixseed(5)
    want = (random.random(), np.random.rand(3))
    gen = t_fixseed(5)
    got = (random.random(), np.random.rand(3))
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    assert np.array_equal(np.asarray(key), np.asarray(jax.random.PRNGKey(5)))
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 5 == torch.initial_seed()
    assert torch.equal(torch.rand(3, generator=gen), torch.rand(3, generator=torch.Generator().manual_seed(5)))


def test_trace_writes_a_chrome_trace(tmp_path):
    import json

    from rohm_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(tmp_path / "tr")
    assert name.startswith("trace_") and name.endswith(".json")
    events = json.loads((tmp_path / "tr" / name).read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
