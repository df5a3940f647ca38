"""preprocessing_amass — raw AMASS npz -> per-sequence joints and params npys,
in PyTorch.

The port of rohm_tpu/cli/preprocessing_amass.py (reference
preprocessing_amass.py:16-155): 30 fps downsampling (SSM special-cased:
59.99 -> stride 2, 120.00 -> stride 4; every other dataset rejected unless
its fps is an exact integer multiple of the target), the reference's skip
rules (neutral_stagei, HDM05 inline skating, BMLrub treadmill and normal),
neutral SMPL-X sequences only, both npz layouts (the SMPL-X release's
root_orient/pose_body/pose_hand/pose_jaw/pose_eye and the flat 165-d
'poses'). The SMPL-X forward for 25 joints runs as one batched call per
sequence on the device. Writes pose_data_fps_<fps>/<dataset>/<seq>/<name>.npy
([T, 25, 3]) and smpl_data_fps_<fps>/... ([T, 178]: 3 global_orient + 3
transl + 10 betas + 63 body_pose + 90 hands + 9 jaw/eyes). Run:

    python -m rohm_tpu_torch.cli.preprocessing_amass --amass_root=<raw tree> \\
        --save_root=<out> --device=0

`--device` is a CUDA index (default 0) or `cpu`; an index with no CUDA
device raises.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from rohm_tpu_torch.body.model import forward_joints
from rohm_tpu_torch.cli.common import resolve_body_model, resolve_device
from rohm_tpu_torch.utils.config import ConfigParser

NUM_JOINTS_OUT = 25  # the 22 body joints, the jaw and both eyes


def should_skip_recording(dataset_name: str, recording_name: str) -> bool:
    """The reference's skip rules (preprocessing_amass.py:120-134): SMPL-X
    staging artifacts, HDM05 inline-skating clips (HDM_dg_07-01*), and
    BMLrub treadmill/normal (walking-in-place) clips."""
    if recording_name == "neutral_stagei":
        return True
    if dataset_name == "HDM05" and recording_name[0:12] == "HDM_dg_07-01":
        return True
    if dataset_name == "BMLrub":
        parts = recording_name.split("_")
        if len(parts) > 1 and parts[1] in ("treadmill", "normal"):
            return True
    return False


def downsample_stride(dataset_name: str, fps: float, target_fps: int = 30):
    """Frame stride for downsampling to target_fps, or None to reject
    (reference preprocessing_amass.py:31-40): SSM's metadata fps (59.99xx or
    120.00xx) maps to stride 2 or 4, for 30 fps only; every other dataset
    needs an fps that is an exact integer multiple of the target."""
    if dataset_name == "SSM":
        if target_fps != 30:
            return None
        return 2 if fps - 60 < 1 else 4
    stride = int(fps / target_fps)
    if stride != fps / target_fps:
        return None
    return stride


def build_parser() -> ConfigParser:
    p = ConfigParser("RoHM AMASS preprocessing (PyTorch)")
    p.add_argument("--amass_root", type=str, default="datasets/AMASS_smplx_raw")
    # reference flag names (preprocessing_amass.py:148-153) and the JAX
    # package's aliases
    p.add_argument("--save_root", "--out_root", type=str, default="datasets/AMASS_smplx_preprocessed")
    p.add_argument("--body_model_path", type=str, default="data/body_models/smplx_model")
    p.add_argument("--dataset_name", "--datasets", type=str, default="",
                   help="subset name, or comma-separated list ('' = all)")
    p.add_argument("--target_fps", type=int, default=30)
    p.add_argument("--device", type=str, default="0")
    return p


def _read_sequence(npz_path: str):
    """(fps, trans, betas, global_orient, body_pose, hands, jaw_eyes) as
    float64 arrays, or None for a file that is unreadable, not neutral or
    not SMPL-X."""
    try:
        with np.load(npz_path, allow_pickle=True) as data:
            fps = float(data.get("mocap_frame_rate", data.get("mocap_framerate", 0)))
            if fps == 0:
                return None
            # reference :22-28: neutral smplx sequences only
            if "gender" in data and str(data["gender"]) != "neutral":
                return None
            if "surface_model_type" in data and str(data["surface_model_type"]) != "smplx":
                return None
            trans = np.asarray(data["trans"], np.float64)
            betas = np.asarray(data["betas"], np.float64)[:10]
            if "root_orient" in data:
                global_orient = np.asarray(data["root_orient"], np.float64)
                body_pose = np.asarray(data["pose_body"], np.float64)
                hands = np.asarray(data["pose_hand"], np.float64)
                jaw = np.asarray(data["pose_jaw"], np.float64)
                eye = np.asarray(data["pose_eye"], np.float64)
                jaw_eyes = np.concatenate([jaw, eye[:, 0:3], eye[:, 0:3]], axis=-1)
            else:
                # flat 'poses' [T, 165]: global orient, body, jaw, eyes, hands
                poses = np.asarray(data["poses"], np.float64)
                global_orient = poses[:, 0:3]
                body_pose = poses[:, 3:66]
                jaw_eyes = poses[:, 66:75]
                hands = poses[:, 75:165]
    except Exception:  # an unreadable or foreign file is skipped, as the reference's loop does
        return None
    return fps, trans, betas, global_orient, body_pose, hands, jaw_eyes


def amass_to_pose(npz_path: str, body, target_fps: int = 30, dataset_name: str = ""):
    """One sequence: (joints [T, 25, 3] float32, params [T, 178] float64),
    or None where the sequence is skipped."""
    seq = _read_sequence(npz_path)
    if seq is None:
        return None
    fps, trans, betas, global_orient, body_pose, hands, jaw_eyes = seq
    stride = downsample_stride(dataset_name, fps, target_fps)
    if stride is None:
        return None
    sl = slice(None, None, stride)
    global_orient, body_pose = global_orient[sl], body_pose[sl]
    hands, jaw_eyes, trans = hands[sl], jaw_eyes[sl], trans[sl]
    t = len(trans)
    if t < 2:
        return None
    betas_t = np.tile(betas[None], (t, 1))

    dev = body.v_template.device
    with torch.no_grad():
        joints = forward_joints(
            body, *(torch.as_tensor(a, dtype=torch.float32, device=dev)
                    for a in (betas_t, global_orient, body_pose, trans)),
            num_joints=NUM_JOINTS_OUT,
        ).cpu().numpy()

    params = np.zeros((t, 178))
    params[:, 0:3] = global_orient
    params[:, 3:6] = trans
    params[:, 6:16] = betas_t
    params[:, 16:79] = body_pose
    params[:, 79:169] = hands
    params[:, 169:178] = jaw_eyes
    return joints, params


def main(argv=None) -> int:
    """Preprocess every sequence of the selected datasets; returns how many
    were written."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    body = resolve_body_model(args.body_model_path, device)
    datasets = [d for d in args.dataset_name.split(",") if d] or sorted(os.listdir(args.amass_root))
    n_done = 0
    for dataset_name in datasets:
        for path in sorted(glob.glob(os.path.join(args.amass_root, dataset_name, "*/*.npz"))):
            recording_name = os.path.basename(path)[:-4]
            if should_skip_recording(dataset_name, recording_name):
                continue
            out = amass_to_pose(path, body, args.target_fps, dataset_name)
            if out is None:
                continue
            joints, params = out
            seq_name = os.path.basename(os.path.dirname(path))
            # the tree's name carries the actual fps: downstream loaders look
            # for "pose_data_fps_30", so other rates never pass for it
            for tree, arr in (("pose_data", joints), ("smpl_data", params)):
                out_dir = os.path.join(args.save_root, f"{tree}_fps_{args.target_fps}", dataset_name, seq_name)
                os.makedirs(out_dir, exist_ok=True)
                np.save(os.path.join(out_dir, recording_name + ".npy"), arr)
            n_done += 1
    print(f"preprocessed {n_done} sequences -> {args.save_root}")
    return n_done


if __name__ == "__main__":
    main()
