"""The port's video data layer against the JAX package, on the CPU: the
synthetic PROX and EgoBody writers file for file, VideoClipDataset items on
both trees (every key), the EgoBody canonicalization, the keypoint
undistortion against OpenCV, and a disk cache that round-trips and never
reads the JAX package's."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from rohm_tpu.body import synthetic_model as jax_synthetic_model
from rohm_tpu.data import VideoClipDataset as JaxVideo
from rohm_tpu.data import write_synthetic_egobody as jax_write_egobody
from rohm_tpu.data import write_synthetic_prox as jax_write_prox
from rohm_tpu.reprs import canonicalize as jcano
from rohm_tpu_torch.body import synthetic_model
from rohm_tpu_torch.data import VideoClipDataset, write_synthetic_egobody, write_synthetic_prox
from rohm_tpu_torch.data import video as tvideo
from rohm_tpu_torch.reprs import canonicalize as tcano
from rohm_tpu_torch.reprs.stats import save_stats

torch.set_num_threads(1)

CLIP_LEN, N_FRAMES = 17, 47  # 3 windows at stride 15
PROX_REC = "MPH11_00034_01"
EGO_REC = "recording_20211004_S12_S20_01"
WRITERS = {"prox": (jax_write_prox, write_synthetic_prox, PROX_REC),
           "egobody": (jax_write_egobody, write_synthetic_egobody, EGO_REC)}


@pytest.fixture(scope="module")
def bodies():
    return jax_synthetic_model(num_verts=64), synthetic_model(num_verts=64)


@pytest.fixture(scope="module")
def trees(bodies, tmp_path_factory):
    """Per dataset: the tree each package's writer made from seed 3, and a
    stats logdir."""
    root = tmp_path_factory.mktemp("video")
    rng = np.random.default_rng(0)
    logdir = str(root / "stats")
    save_stats(logdir, rng.normal(size=294).astype(np.float32),
               rng.uniform(0.5, 1.5, 294).astype(np.float32))
    out = {}
    for name, (jw, tw, rec) in WRITERS.items():
        for pkg, writer, body in (("jax", jw, bodies[0]), ("torch", tw, bodies[1])):
            writer(str(root / name / pkg / "init"), str(root / name / pkg / "base"), body,
                   recording_name=rec, n_frames=N_FRAMES, seed=3)
        out[name] = root / name
    return out, logdir


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("dataset", ["prox", "egobody"])
def test_synthetic_writers_match_file_for_file(trees, dataset):
    """The same file names; pkls, masks, CSVs and calibration JSON equal
    exactly (numpy params and constants in both); keypoint JSON is the
    pinhole projection of each package's f32 FK joints: measured <= 1.9e-3 px
    apart on ~1000 px values (f32 FK over a depth of ~1 m, times 1060)."""
    root = trees[0][dataset]
    jroot, troot = root / "jax", root / "torch"
    files = _files(jroot)
    assert files == _files(troot) and len(files) > 2 * N_FRAMES
    for rel in files:
        a, b = jroot / rel, troot / rel
        if rel.endswith(".pkl"):
            pa, pb = pickle.loads(a.read_bytes()), pickle.loads(b.read_bytes())
            assert pa.keys() == pb.keys(), rel
            for k in pa:
                assert pa[k].dtype == pb[k].dtype and np.array_equal(pa[k], pb[k]), (rel, k)
        elif rel.endswith(".npy"):
            assert np.array_equal(np.load(a), np.load(b)), rel
        elif rel.endswith("_keypoints.json"):
            ka = np.asarray(json.loads(a.read_text())["people"][0]["pose_keypoints_2d"])
            kb = np.asarray(json.loads(b.read_text())["people"][0]["pose_keypoints_2d"])
            np.testing.assert_allclose(kb, ka, atol=1e-2, rtol=0, err_msg=rel)
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def _datasets(bodies, tree, logdir, dataset, **kw):
    rec = WRITERS[dataset][2]
    common = dict(dataset=dataset, init_root=str(tree / "init"), base_dir=str(tree / "base"),
                  recording_name=rec, use_scene_floor_height=True, task="traj", repr_abs_only=True,
                  overlap_len=2, clip_len=CLIP_LEN, logdir=logdir)
    return JaxVideo(body_model=bodies[0], **common), VideoClipDataset(body_model=bodies[1], **common, **kw)


@pytest.mark.parametrize("dataset", ["prox", "egobody"])
def test_video_items_match_jax(bodies, trees, dataset):
    """Every key of every item, both loaders on the JAX writer's tree.
    Scene and canonical joints are the f32 FK of each package, then float64
    numpy: measured <= 9e-7 m; the normalized repr goes through each
    encoder in f32: measured <= 1.5e-5 (held to 4e-5); transforms and
    canonical params <= 9e-7; intrinsics, keypoints, masks and frame names
    equal."""
    tree, logdir = trees[0][dataset], trees[1]
    jds, tds = _datasets(bodies, tree / "jax", logdir, dataset)
    assert len(tds) == len(jds) == 3
    for attr in ("scene_name", "scene_floor_height", "color_cam") + (
            ("kinect_view", "body_idx", "gender_gt") if dataset == "egobody" else ()):
        assert getattr(tds, attr) == getattr(jds, attr), attr
    np.testing.assert_array_equal(tds.cam_r, jds.cam_r)
    np.testing.assert_array_equal(tds.cam_t, jds.cam_t)
    for i in range(len(jds)):
        a, b = tds[i], jds[i]
        assert a.keys() == b.keys()
        assert a["frame_name"] == b["frame_name"]
        assert a["cano_smplx_params_dict"].keys() == b["cano_smplx_params_dict"].keys()
        for k, v in b["cano_smplx_params_dict"].items():
            np.testing.assert_allclose(a["cano_smplx_params_dict"][k], v, atol=1e-5, err_msg=k)
        for k in sorted(set(b) - {"frame_name", "cano_smplx_params_dict"}):
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            tol = 4e-5 if k in ("motion_repr_noisy", "cond", "control_cond") else 1e-5
            np.testing.assert_allclose(a[k], b[k], atol=tol, rtol=0, err_msg=k)
    # batches: the bucket pads 3 windows to 4, the lists stay lists
    (bt,) = list(tds.view("pose").batches(4, pad_last="bucket"))
    (bj,) = list(jds.view("pose").batches(4, pad_last="bucket"))
    assert bt["_valid"] == bj["_valid"] == 3 and bt.keys() == bj.keys()
    assert bt["frame_name"] == bj["frame_name"]
    for k in set(bj) - {"_valid", "frame_name", "cano_smplx_params_dict"}:
        assert bt[k].shape == bj[k].shape, k


def test_cano_egobody_matches_jax():
    """A y-up sequence with a preset floor and without: the same numpy and
    scipy calls, so equal to rounding (measured 0 on positions)."""
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(9, 22, 3)) + np.array([0.3, 1.2, -0.4])
    params = {"global_orient": rng.normal(scale=0.5, size=(9, 3)), "transl": rng.normal(size=(9, 3)),
              "betas": rng.normal(size=(9, 10)), "body_pose": rng.normal(size=(9, 63))}
    for floor in (None, -0.2):
        pj, cj, tj = jcano.cano_seq_smplx_egobody(pos, params, floor, return_transf_mat=True)
        pt, ct, tt = tcano.cano_seq_smplx_egobody(pos, params, floor, return_transf_mat=True)
        np.testing.assert_allclose(pt, pj, atol=1e-12)
        np.testing.assert_allclose(tt, tj, atol=1e-12)
        for k in cj:
            np.testing.assert_allclose(ct[k], cj[k], atol=1e-12, err_msg=k)


def test_undistort_matches_opencv():
    """undistort_keypoints_prox (numpy) against cv2.undistortPoints on
    non-zero k1, k2, p1, p2, k3 (PROX's Color.json model; the synthetic
    tree's k is all zero), points across a 1920 x 1080 frame: held to
    1e-9 px, measured 0 (the same float64 operations in the same order)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    color_cam = {"camera_mtx": [[1060.5, 0.0, 951.3], [0.0, 1061.2, 536.8], [0.0, 0.0, 1.0]],
                 "k": [0.061, -0.153, 0.0012, -0.0008, 0.074]}
    kp = np.concatenate([rng.uniform([0, 0], [1919, 1079], size=(7, 22, 2)), rng.uniform(size=(7, 22, 1))], -1)
    got = tvideo.undistort_keypoints_prox(kp, color_cam)
    flipped = kp[..., :2].copy()
    flipped[..., 0] = 1919 - flipped[..., 0]
    mtx = np.asarray(color_cam["camera_mtx"])
    ref = cv2.undistortPoints(flipped.reshape(-1, 1, 2), mtx, np.asarray(color_cam["k"]), P=mtx).reshape(7, 22, 2)
    ref[..., 0] = 1919 - ref[..., 0]
    assert np.abs(ref - kp[..., :2]).max() > 0.5  # the distortion moves the points
    np.testing.assert_allclose(got[..., :2], ref, atol=1e-9, rtol=0)
    np.testing.assert_array_equal(got[..., 2], kp[..., 2])
    # zero distortion: the identity, as cv2
    zero = dict(color_cam, k=[0.0] * 5)
    np.testing.assert_allclose(tvideo.undistort_keypoints_prox(kp, zero), kp, atol=1e-9)


def test_disk_cache_round_trip_and_never_reads_jax(bodies, trees, monkeypatch):
    """The port caches video_torch_<key>.npz (no pickled objects), beside the
    JAX package's video_<key>.pkl in the same directory; a second build loads
    it without reading the tree and gives the same items."""
    tree, logdir = trees[0]["egobody"] / "jax", trees[1]
    cache = str(tree / "base" / "_repr_cache")
    jds, tds = _datasets(bodies, tree, logdir, "egobody")
    JaxVideo(body_model=bodies[0], dataset="egobody", init_root=str(tree / "init"),
             base_dir=str(tree / "base"), recording_name=EGO_REC, clip_len=CLIP_LEN,
             logdir=logdir, use_scene_floor_height=True, disk_cache_dir=cache)
    kw = dict(dataset="egobody", init_root=str(tree / "init"), base_dir=str(tree / "base"),
              recording_name=EGO_REC, use_scene_floor_height=True, task="traj", repr_abs_only=True,
              overlap_len=2, clip_len=CLIP_LEN, logdir=logdir, disk_cache_dir=cache)
    first = VideoClipDataset(body_model=bodies[1], **kw)
    names = sorted(os.listdir(cache))
    assert len(names) == 2 and names[0].startswith("video_") and names[0].endswith(".pkl")
    assert names[1].startswith("video_torch_") and names[1].endswith(".npz")
    with np.load(os.path.join(cache, names[1]), allow_pickle=False) as z:
        assert all(z[k].dtype != object for k in z.files)

    def no_read(*a, **k):
        raise AssertionError("the cache was not used")

    monkeypatch.setattr(VideoClipDataset, "_read_egobody", no_read)
    again = VideoClipDataset(body_model=bodies[1], **kw)
    assert sorted(os.listdir(cache)) == names
    for attr in ("scene_name", "gender_gt", "kinect_view", "body_idx", "color_cam", "scene_floor_height"):
        assert getattr(again, attr) == getattr(first, attr), attr
    for i in range(len(first)):
        a, b = again[i], first[i]
        assert a["frame_name"] == b["frame_name"]
        for k in set(b) - {"frame_name", "cano_smplx_params_dict"}:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in b["cano_smplx_params_dict"]:
            np.testing.assert_array_equal(a["cano_smplx_params_dict"][k], b["cano_smplx_params_dict"][k])
        np.testing.assert_allclose(a["motion_repr_noisy"], tds[i]["motion_repr_noisy"], atol=0)
