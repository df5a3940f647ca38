"""The port's host tools against the JAX package's, on the CPU:
`preprocessing_amass` on a raw tree with both npz layouts, an SSM sequence
and files each skip rule drops; `get_occlusion_mask` with the fake pyrender
and trimesh of tests/test_occlusion_mask.py; `project_points_distorted`
against `cv2.projectPoints`; `make_eval_noise` against the JAX package's
script. Both tools run in one tmp directory without body-model weights, so
both take the synthetic SMPL-X model."""

import importlib.util
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rohm_tpu.cli import get_occlusion_mask as jocc
from rohm_tpu.cli import preprocessing_amass as jpre
from rohm_tpu_torch.cli import get_occlusion_mask as tocc
from rohm_tpu_torch.cli import preprocessing_amass as tpre
from rohm_tpu_torch.data import write_synthetic_amass_raw
from rohm_tpu_torch.data.synthetic import RAW_AMASS_SEQUENCES
from rohm_tpu_torch.data.video import project_points_distorted

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from test_occlusion_mask import _FakeDepthRenderer, _fake_modules  # noqa: E402

# the PROX color camera with a distortion of the size PROX's calibration has
COLOR_CAM = {
    "camera_mtx": [[1060.53, 0, 951.30], [0, 1060.38, 536.77], [0, 0, 1]],
    "k": [0.08, -0.21, 0.0012, -0.0021, 0.09],
}


# ---------------------------------------------------------------------------
# preprocessing_amass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dataset,name", [
    (d, s[1]) for d, seqs in RAW_AMASS_SEQUENCES.items() for s in seqs
] + [("HDM05", "HDM_dg_07-01_01_120"), ("HDM05", "HDM_dg_07-02_01_120"), ("BMLrub", "rub002_normal_walk"),
     ("BMLrub", "rub004"), ("CMU", "01_01_treadmill")])
def test_skip_rules_match_jax(dataset, name):
    assert tpre.should_skip_recording(dataset, name) is jpre.should_skip_recording(dataset, name)


@pytest.mark.parametrize("dataset,fps,target", [
    ("SSM", 59.9944, 30), ("SSM", 120.0041, 30), ("SSM", 120.0041, 60), ("ACCAD", 120.0, 30),
    ("KIT", 100.0, 30), ("ACCAD", 59.99, 30), ("ACCAD", 120.0, 60), ("CMU", 60.0, 20),
])
def test_downsample_stride_matches_jax(dataset, fps, target):
    assert tpre.downsample_stride(dataset, fps, target) == jpre.downsample_stride(dataset, fps, target)


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("preprocessing")
    kept = write_synthetic_amass_raw(str(tmp / "raw"), n_frames=48, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        jpre.main([f"--amass_root={tmp / 'raw'}", f"--save_root={tmp / 'jax'}"])
        n = tpre.main([f"--amass_root={tmp / 'raw'}", f"--save_root={tmp / 'torch'}", "--device=cpu"])
    return tmp, kept, n


def test_preprocessing_matches_jax(preprocessed):
    """The same files (the kept sequences only), the same params exactly
    (host float64 copies) and the same 25 joints: FK in f32 in each
    framework, measured <= 4.8e-7 m, held at 1e-5."""
    tmp, kept, n = preprocessed
    files = {tree: sorted(p.relative_to(tmp / tree) for p in (tmp / tree).rglob("*.npy"))
             for tree in ("jax", "torch")}
    assert files["torch"] == files["jax"] and n == kept == 3
    assert {str(p.parent.parent.parent) for p in files["torch"]} == {"pose_data_fps_30", "smpl_data_fps_30"}
    frames = {"walk_poses": 12, "run_poses": 24, "dance_poses": 24}  # 48 frames at stride 4, 2, 2
    for rel in files["torch"]:
        a, b = np.load(tmp / "torch" / rel), np.load(tmp / "jax" / rel)
        assert a.shape == b.shape and a.dtype == b.dtype, rel
        if rel.parts[0] == "pose_data_fps_30":
            assert a.shape == (frames[rel.stem], 25, 3)
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=str(rel))
        else:
            assert a.shape == (frames[rel.stem], 178)
            np.testing.assert_array_equal(a, b)


def test_preprocessing_needs_a_device_or_cpu(tmp_path):
    missing = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="--device=cpu"):
        tpre.main([f"--amass_root={tmp_path}", f"--device={missing}"])


# ---------------------------------------------------------------------------
# get_occlusion_mask
# ---------------------------------------------------------------------------


def test_project_points_distorted_matches_cv2():
    """OpenCV's forward model in float64 numpy against cv2.projectPoints
    (and the JAX tool, which calls it), with nonzero k1, k2, p1, p2, k3:
    measured <= 2.3e-13 px, held at 1e-9."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    pts = rng.normal(scale=0.6, size=(200, 3)) + [0.0, 0.0, 2.5]
    got = project_points_distorted(pts, COLOR_CAM)
    ref, _ = cv2.projectPoints(pts.reshape(-1, 1, 3), np.zeros(3), np.zeros(3),
                               np.asarray(COLOR_CAM["camera_mtx"]), np.asarray(COLOR_CAM["k"]))
    np.testing.assert_allclose(got, ref.reshape(-1, 2), atol=1e-9, rtol=0)
    np.testing.assert_allclose(got, jocc.project_points_distorted(pts, COLOR_CAM), atol=1e-9, rtol=0)
    # the distortion moves the points: not the pinhole projection
    pinhole = pts[:, :2] / pts[:, 2:] * [1060.53, 1060.38] + [951.30, 536.77]
    assert np.abs(got - pinhole).max() > 1.0


def _prox_tree(root: Path, frames: list[dict]) -> None:
    for sub in ("cam2world", "calibration", "scenes"):
        (root / "PROX" / sub).mkdir(parents=True)
    with open(root / "PROX" / "cam2world" / "MPH11.json", "w") as f:
        json.dump(np.eye(4).tolist(), f)
    with open(root / "PROX" / "calibration" / "Color.json", "w") as f:
        json.dump(COLOR_CAM, f)
    (root / "PROX" / "scenes" / "MPH11.ply").touch()
    for i, params in enumerate(frames):
        d = root / "init" / "seq" / "results" / f"frame_{i:04d}"
        d.mkdir(parents=True)
        with open(d / "000.pkl", "wb") as f:
            pickle.dump(params, f)


def test_occlusion_mask_matches_jax(tmp_path, monkeypatch):
    """Two posed frames in front of the camera. The depth maps are built
    from the JAX package's joints projected by cv2: per frame, two joints'
    pixels lie 0.2 m behind the scene (occluded), one 0.05 m (visible), and
    one has no scene depth (visible). Both tools write the same mask, the
    depth rule's, and the port hands the renderer the same vertices (f32
    LBS in each framework: measured <= 2.4e-7 m, held at 1e-5)."""
    import jax.numpy as jnp

    from rohm_tpu.body import forward_vertices as jax_forward_vertices
    from rohm_tpu.body import synthetic_model as jax_synthetic_model

    _fake_modules(monkeypatch)
    meshes = []
    trimesh_cls = sys.modules["trimesh"].Trimesh

    class RecordingTrimesh(trimesh_cls):
        def __init__(self, verts=None, faces=None, process=False):
            super().__init__(verts, faces, process)
            if verts is not None:
                meshes.append(np.asarray(verts))

    monkeypatch.setattr(sys.modules["trimesh"], "Trimesh", RecordingTrimesh)

    rng = np.random.default_rng(1)
    frames = [{"betas": rng.normal(scale=0.3, size=(1, 10)), "global_orient": rng.normal(scale=0.3, size=(1, 3)),
               "body_pose": rng.normal(scale=0.3, size=(1, 63)), "transl": np.array([[0.1 * i, 0.0, 2.5]])}
              for i in range(2)]
    _prox_tree(tmp_path, frames)

    body = jax_synthetic_model()
    w, h = jocc.IMG_W, jocc.IMG_H
    depth_scene = np.full((h, w), 5.0)
    bodies, uvs = [], []
    for params in frames:
        _, joints = jax_forward_vertices(body, *(jnp.asarray(np.asarray(params[k])[:, :n], jnp.float32)
                                                 for k, n in (("betas", 10), ("global_orient", 3),
                                                              ("body_pose", 63), ("transl", 3))))
        uv = jocc.project_points_distorted(np.asarray(joints)[0, :25], COLOR_CAM).astype(int)
        inside = np.flatnonzero((uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h))
        assert len(inside) >= 10
        # one pixel per role, distinct from the others'
        pix = {}
        for j in inside:
            pix.setdefault(tuple(uv[j]), j)
        occ1, occ2, near, hole = list(pix.values())[:4]
        depth_body = np.full((h, w), 4.0)
        for j, depth in ((occ1, 5.2), (occ2, 5.2), (near, 5.05), (hole, 6.0)):
            depth_body[uv[j][1], uv[j][0]] = depth
        depth_scene[uv[hole][1], uv[hole][0]] = 0.0
        bodies.append(depth_body)
        uvs.append(uv)
    # the rule, on the final maps: in the image, scene depth there, body
    # more than 0.1 m behind it
    expect = np.ones((2, 25))
    for i, uv in enumerate(uvs):
        for j, (x, y) in enumerate(uv):
            if 0 <= x < w and 0 <= y < h and depth_scene[y, x] != 0 and bodies[i][y, x] - depth_scene[y, x] > 0.1:
                expect[i, j] = 0

    argv = [f"--prox_root={tmp_path / 'PROX'}", f"--init_body_path={tmp_path / 'init'}", "--seq_name=seq",
            "--scene_name=MPH11"]
    monkeypatch.chdir(tmp_path)
    _FakeDepthRenderer.queue = [depth_scene, *bodies]
    jocc.main(argv + [f"--save_mask_path={tmp_path / 'jax'}"])
    _FakeDepthRenderer.queue = [depth_scene, *bodies]
    got = tocc.main(argv + [f"--save_mask_path={tmp_path / 'torch'}", "--device=cpu"])
    jmask = np.load(tmp_path / "jax" / "seq" / "mask_joint.npy")
    tmask = np.load(tmp_path / "torch" / "seq" / "mask_joint.npy")
    assert tmask.shape == jmask.shape == (2, 25)
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_array_equal(got, tmask)
    np.testing.assert_array_equal(tmask, expect)
    assert (tmask == 0).sum(axis=1).min() >= 1 and (tmask == 1).sum(axis=1).min() >= 10
    # meshes: the JAX tool's two bodies, then the port's
    assert len(meshes) == 4
    for j, t in zip(meshes[:2], meshes[2:]):
        assert t.shape == j.shape == (512, 3)
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)


def test_occlusion_mask_needs_pyrender():
    """Neither this host nor the card's machine has pyrender: the tool
    raises ImportError and does nothing else."""
    if importlib.util.find_spec("pyrender") is not None:
        pytest.skip("pyrender is installed here")
    with pytest.raises(ImportError):
        tocc.main(["--device=cpu"])


def test_occlusion_mask_needs_a_device_or_cpu(monkeypatch):
    _fake_modules(monkeypatch)
    missing = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="--device=cpu"):
        tocc.main([f"--device={missing}"])


# ---------------------------------------------------------------------------
# make_eval_noise
# ---------------------------------------------------------------------------


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_make_eval_noise", ROOT / "scripts" / "make_eval_noise.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_eval_noise_matches_jax_script(tmp_path):
    """The same numpy generator: the pickles equal the JAX script's
    make_noise arrays bit for bit, one file per level, seeded seed + level."""
    from rohm_tpu_torch.scripts import make_eval_noise

    paths = make_eval_noise.main(["--n_clips=3", "--clip_len=9", "--levels=3,5", "--seed=2",
                                  f"--out_dir={tmp_path}"])
    assert [Path(p).name for p in paths] == ["smplx_noise_level_3.pkl", "smplx_noise_level_5.pkl"]
    jax_script = _jax_script()
    for path, level in zip(paths, (3, 5)):
        with open(path, "rb") as f:
            got = pickle.load(f)
        ref = jax_script.make_noise(3, 9, level, 2 + level)
        assert list(got) == list(ref) == ["transl", "betas", "global_orient", "body_pose"]
        for k in ref:
            assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype == np.float64
            np.testing.assert_array_equal(got[k], ref[k])
    assert make_eval_noise.make_noise(3, 9, 3, 5)["body_pose"].shape == (3, 9, 21, 3)
