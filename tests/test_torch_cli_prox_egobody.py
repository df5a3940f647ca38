"""The port's PROX/EgoBody CLIs against the JAX package's, end to end on
the CPU.

Both `test_prox_egobody.main` functions run with the shipped video YAMLs
in one tmp directory (no body-model weights there, so both take the
synthetic SMPL-X model) on the same synthetic PROX and EgoBody trees
(3 windows of 17 frames, padded to a batch of 4 by the bucket), with the
same `.npz` checkpoints and the same stats beside the PoseNet one, and the
same replayed diffusion noise: each package's `RohmPipeline.run_batch` is
wrapped (in the test only) to pass the same `preset_noise`. Two inference
iterations, so the second one's prediction-fed conditions and TrajControl
run on the video loop; 24 PoseNet steps with early stop (the chain runs 4
of them, all guided by the 2-D reprojection and skating terms). Then both
`eval_prox_egobody` CLIs score the pickles and stitch the windows.
"""

import os
import pickle
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {"prox": ROOT / "cfg_files" / "test_cfg" / "prox_rgb.yaml",
           "egobody": ROOT / "cfg_files" / "test_cfg" / "egobody_rgb.yaml"}
RECORDINGS = {"prox": "MPH11_00034_01", "egobody": "recording_20211004_S12_S20_01"}
CLIP_LEN, N_FRAMES, STEPS_TRAJ, STEPS_POSE, ITERS = 17, 47, 3, 24, 2


def _preset_noise(b: int, t_traj: int, tf: int) -> dict:
    rng = np.random.default_rng(11)
    shapes = {
        "traj_init": (ITERS, b, t_traj, tf),
        "traj_step": (ITERS, STEPS_TRAJ, b, t_traj, tf),
        "pose_init": (ITERS, b, t_traj - 1, 294),
        "pose_step": (ITERS, STEPS_POSE, b, t_traj - 1, 294),
    }
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _with_noise(run_batch):
    def wrapped(self, traj_cond, *args, **kwargs):
        kwargs["preset_noise"] = _preset_noise(*np.shape(traj_cond))
        return run_batch(self, traj_cond, *args, **kwargs)
    return wrapped


def _unflatten(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        node = tree
        *scopes, leaf = key.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = v
    return tree


def _checkpoints(ckpt_dir: Path, body) -> dict:
    """Seeded port TrajNet, TrajControl and PoseNet (all-zero tensors woken,
    so the ControlNet taps count) as flattened-flax `.npz`, and AMASS stats
    beside the PoseNet checkpoint. Returns the paths."""
    from rohm_tpu_torch.cli.common import build_posenet, build_trajnet
    from rohm_tpu_torch.data import AmassClipDataset, synthetic_amass_arrays
    from rohm_tpu_torch.utils.convert_flax import posenet_flax_params, trajnet_flax_params

    args = SimpleNamespace(mid_dim=64, latent_dim=32)
    rng = np.random.default_rng(0)
    nets = {
        "trajnet": (build_trajnet(args, 13, False, seed=1), trajnet_flax_params),
        "trajnet_control": (build_trajnet(args, 13, True, seed=2), trajnet_flax_params),
        "posenet": (build_posenet(args, seed=3), lambda sd: posenet_flax_params(sd, num_heads=4)),
    }
    os.makedirs(ckpt_dir, exist_ok=True)
    paths = {}
    for name, (model, to_flax) in nets.items():
        sd = {k: 0.05 * torch.from_numpy(rng.standard_normal(v.shape)).float() if not v.any() else v
              for k, v in model.state_dict().items()}
        paths[name] = str(ckpt_dir / f"{name}.npz")
        np.savez(paths[name], **to_flax(sd))
    AmassClipDataset(body_model=body, split="train", clip_len=CLIP_LEN, input_noise=False, task="pose",
                     logdir=str(ckpt_dir), clips=synthetic_amass_arrays(body, n_clips=2, clip_len=CLIP_LEN, seed=1))
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from rohm_tpu.body import synthetic_model as jax_synthetic_model
    from rohm_tpu.cli import test_prox_egobody as jcli
    from rohm_tpu.data import write_synthetic_egobody, write_synthetic_prox
    from rohm_tpu.pipeline import RohmPipeline as JaxPipeline
    from rohm_tpu_torch.body import synthetic_model
    from rohm_tpu_torch.cli import test_prox_egobody as tcli
    from rohm_tpu_torch.pipeline import RohmPipeline

    tmp = tmp_path_factory.mktemp("video_cli")
    ckpt = _checkpoints(tmp / "ckpt", synthetic_model())

    # the JAX CLI initialises each model, then loads the checkpoint over it;
    # hand it the checkpoint's own tree as the init (no init compile)
    def init_params(model, clip_len, seed=0):
        name = "posenet" if not hasattr(model, "trajcontrol") else (
            "trajnet_control" if model.trajcontrol else "trajnet")
        with np.load(ckpt[name]) as z:
            return _unflatten(dict(z))

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setattr(jcli, "init_trajnet_params", init_params)
        mp.setattr(jcli, "init_posenet_params", init_params)
        mp.setattr(JaxPipeline, "run_batch", _with_noise(JaxPipeline.run_batch))
        mp.setattr(RohmPipeline, "run_batch", _with_noise(RohmPipeline.run_batch))
        for dataset, writer in (("prox", write_synthetic_prox), ("egobody", write_synthetic_egobody)):
            root = tmp / dataset
            writer(str(root / "init"), str(root / "base"), jax_synthetic_model(),
                   recording_name=RECORDINGS[dataset], n_frames=N_FRAMES, seed=4)
            argv = [
                f"--config={CONFIGS[dataset]}", f"--dataset_root={root / 'base'}", f"--init_root={root / 'init'}",
                f"--recording_name={RECORDINGS[dataset]}", f"--clip_len={CLIP_LEN}", "--batch_size=4",
                f"--diffusion_steps_trajnet={STEPS_TRAJ}", f"--diffusion_steps_posenet={STEPS_POSE}",
                "--mid_dim=64", "--latent_dim=32", f"--sample_iter={ITERS}", "--seed=0",
                *[f"--model_path_{net}={path}" for net, path in ckpt.items()],
            ]
            jpath = jcli.main(argv + [f"--save_root={tmp / 'res_jax'}"])
            tpath, timing = tcli.run(argv + [f"--save_root={tmp / 'res_torch'}", "--device=cpu"])
            with open(jpath, "rb") as f:
                jdata = pickle.load(f)
            with open(tpath, "rb") as f:
                tdata = pickle.load(f)
            out[dataset] = (Path(jpath), Path(tpath), jdata, tdata, timing)
            if dataset == "prox":  # the port once more without guidance: it must differ
                upath = tcli.main(argv + [f"--save_root={tmp / 'res_unguided'}", "--device=cpu",
                                          "--cond_fn_with_grad=False"])
                with open(upath, "rb") as f:
                    out["unguided"] = pickle.load(f)
    return out


@pytest.mark.parametrize("dataset", ["prox", "egobody"])
def test_cli_pickle_path_and_keys(runs, dataset):
    jpath, tpath, jdata, tdata, timing = runs[dataset]
    assert tpath.name == jpath.name == f"{RECORDINGS[dataset]}.pkl"
    assert tpath.parent.name == jpath.parent.name == (
        f"test_{dataset}_grad_True_iter_{ITERS}_iter2trajnoisy_False_iter2posenoisy_False_earlystop_True_seed_0")
    assert list(tdata) == list(jdata)
    want = {"repr_name_list", "repr_dim_dict", "recording_name", "frame_name_list", "scene_name",
            "color_cam", "window_stride", "trans_scene2cano_list", "rec_ric_data_noisy_list",
            "rec_ric_data_rec_list_from_abs_traj", "rec_ric_data_rec_list_from_smpl",
            "joints_input_scene_coord_list", "motion_repr_rec_list", "motion_repr_noisy_list",
            "mask_joint_vis_list"}
    if dataset == "egobody":
        want |= {"gender_gt", "joints_gt_scene_coord_list"}
    assert set(tdata) == want
    for k in jdata:
        if not isinstance(jdata[k], np.ndarray):
            assert tdata[k] == jdata[k], k
    assert len(tdata["frame_name_list"]) == 3  # 3 windows, the padded 4th trimmed
    assert {"dataset_build", "batch_dispatch", "device_wait_and_collect", "total"} <= set(timing)


@pytest.mark.parametrize("dataset", ["prox", "egobody"])
def test_cli_arrays_match_jax(runs, dataset):
    """Every array of the JAX pickle. The inputs (transforms, scene joints,
    masks, noisy reprs and their joints) are f32 FK and encoding in each
    package: measured <= 8.7e-6 on values up to |5.3|. The reconstruction
    went through 2 x 3 TrajNet and 2 x 4 guided PoseNet steps with the same
    noise and weights, f32 on both sides: measured <= 3.1e-6 on reprs up to
    |1.5| and joints up to |0.9| m. Held to 5e-5 and 1e-4."""
    *_, jdata, tdata, _ = runs[dataset]
    for key in sorted(k for k, v in jdata.items() if isinstance(v, np.ndarray)):
        a, b = tdata[key], jdata[key]
        assert a.shape == b.shape and a.dtype == b.dtype, key
        assert a.shape[0] == 3, key
        assert np.isfinite(a).all(), key
        tol = 1e-4 if "_rec_" in key or key.startswith("motion_repr_rec") else 5e-5
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=key)


def test_guidance_moves_the_reconstruction(runs):
    """The 2-D and skating terms ran: without them (the same noise and
    weights, --cond_fn_with_grad=False) the reconstruction moves by more
    than 1e-2, 100 times the parity tolerance."""
    guided, unguided = runs["prox"][3], runs["unguided"]
    moved = np.abs(guided["motion_repr_rec_list"] - unguided["motion_repr_rec_list"]).max()
    assert moved > 1e-2, moved


@pytest.mark.parametrize("dataset", ["prox", "egobody"])
def test_eval_cli_matches_jax(runs, dataset, tmp_path, capsys):
    from rohm_tpu.cli import eval_prox_egobody as jeval
    from rohm_tpu_torch.cli import eval_prox_egobody as teval

    jpath, tpath, *_ = runs[dataset]
    capsys.readouterr()
    metrics, lines, stitched = [], [], []
    for mod, path, tag in ((jeval, jpath, "jax"), (teval, tpath, "torch")):
        metrics.append(mod.main([f"--dataset={dataset}", f"--saved_data_dir={path.parent}",
                                 f"--recording_list={RECORDINGS[dataset]}",
                                 f"--stitch_save_dir={tmp_path / tag}"]))
        lines.append([line for line in capsys.readouterr().out.splitlines() if ":" in line or "/" in line])
        with np.load(tmp_path / tag / f"{RECORDINGS[dataset]}.npz") as z:
            stitched.append({k: z[k] for k in z.files})
    jm, tm = metrics
    # the same metric lines, label for label
    assert [line.split(":")[0] for line in lines[1] if "stitched" not in line] == \
        [line.split(":")[0] for line in lines[0] if "stitched" not in line]
    assert set(tm) == set(jm) and len(tm) == (4 if dataset == "prox" else 8)
    for k in jm:
        assert np.isfinite(tm[k]), k
        # metrics of joints within 1e-4 m: measured <= 4e-7 relative (the
        # thresholded ratios equal)
        assert abs(tm[k] - jm[k]) <= max(1e-4, 1e-5 * abs(jm[k])), (k, tm[k], jm[k])
    assert stitched[1].keys() == stitched[0].keys() == {"joints_rec", "joints_input"}
    assert stitched[1]["joints_rec"].shape == (2 * (CLIP_LEN - 2) + CLIP_LEN - 2, 22, 3)
    np.testing.assert_allclose(stitched[1]["joints_input"], stitched[0]["joints_input"], atol=1e-4)
    np.testing.assert_allclose(stitched[1]["joints_rec"], stitched[0]["joints_rec"], atol=1e-4)


@pytest.mark.parametrize("flag", ["--via_server=True"])
def test_unported_test_flags_raise(flag):
    from rohm_tpu_torch.cli import test_prox_egobody as tcli

    with pytest.raises(NotImplementedError, match="not yet ported"):
        tcli.main([flag, "--device=cpu"])


@pytest.mark.parametrize("flag", ["--visualize=True", "--render=True", "--via_server=True"])
def test_unported_eval_flags_raise(flag):
    from rohm_tpu_torch.cli import eval_prox_egobody as teval

    with pytest.raises(NotImplementedError, match="not yet ported"):
        teval.main([flag])
