"""Build the trained fixture in tests/torch_trained/ with the JAX package.

    python tests/torch_trained/build_fixture.py [--out DIR]

On the CPU (about 30 minutes on 8 cores). It trains the three nets with the
JAX package's own train steps (not its CLIs: a CLI-trained tiny PoseNet
hedges its contact outputs near 0.5, see tests/test_e2e_parity_trained.py)
on the fixture's tree with ground contact planted at the stance frames, so
that contacts saturate and the guidance sits far from its 0.5 threshold:

  1. TrajNet (mid_dim 64) with make_trajnet_train_step: the stage-3 loss
     weights (trajnet_train_vanilla_stage3.yaml) and its infill curriculum,
     windows scaled to the 80-frame clip (up to a quarter of it, which
     covers the CLI's 14-frame window at frame 65).
  2. TrajControl: bootstrap_trajcontrol grafts the trained TrajNet, then the
     ControlNet branch alone trains under trajcontrol_frozen_mask at the
     trajnet_ft_trajcontrol.yaml weights.
  3. PoseNet (latent 64, ff 1024, 8 layers, 4 heads) with
     make_posenet_train_step: the posenet_train_stage1.yaml weights, the
     skating loss on from the first step, the condition masked by the
     training curriculum (posenet_train_cond_mask).

Each net trains on the one batch the CLIs evaluate: the tree's N_CLIPS
clips as `test_amass_full` builds them (--seed=0, --load_noise=False), at
the rates of LR. Then it measures the contact margin |c - 0.5| of PoseNet's x0
prediction at t = 25 under each config's evaluation mask, and runs the JAX
RohmPipeline on the batch for both configs with the full chains and
`fixture.preset_noise`, scoring each with the JAX eval_amass_full. See
fixture.py for the files. Nothing of the port is imported here.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import flax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import yaml  # noqa: E402

from rohm_tpu.body import synthetic_model  # noqa: E402
from rohm_tpu.cli import common as jcommon  # noqa: E402
from rohm_tpu.cli.eval_amass_full import evaluate  # noqa: E402
from rohm_tpu.cli.test_amass_full import make_pickle_decoders  # noqa: E402
from rohm_tpu.data import AmassClipDataset, synthetic_amass_arrays  # noqa: E402
from rohm_tpu.diffusion import make_schedule, q_sample  # noqa: E402
from rohm_tpu.pipeline import RohmPipeline, amass_eval_pose_mask  # noqa: E402
from rohm_tpu.train.masking import posenet_train_cond_mask, traj_infill_mask  # noqa: E402
from rohm_tpu.train.state import create_train_state, trajcontrol_frozen_mask  # noqa: E402
from rohm_tpu.train.steps import make_posenet_train_step, make_trajnet_train_step  # noqa: E402

from tests.torch_trained import fixture as fx  # noqa: E402

DATA_SEED = 0  # synthetic_amass_arrays
TRAIN_SEED = 0  # inits, JAX keys, curriculum draws
TRAIN_STEPS = {"trajnet": 600, "trajcontrol": 300, "posenet": 7000}
# PoseNet at 1e-3 (the rate of the JAX package's 2-layer trained test)
# collapses at this depth: 8 post-LN layers settle by step 2000 on a
# constant output, contacts at their base rate (|c - 0.5| ~0.15 at 4000
# steps, the loss flat); at the stage YAML's 1e-4 the mean margin reaches
# 0.47 by 7000 steps but the worst entry stays near 0; at 3e-4 both clear
# their bounds by 7000
LR = {"trajnet": 1e-3, "trajcontrol": 1e-3, "posenet": 3e-4}
MASK_PROB, MAX_INFILL_RATIO = 0.4, 0.25  # stage 3's 0.4; its 0.1 of 145 frames scaled to 80
MARGIN_T, MARGIN_SEED = 25, 9
SEQ_LEN = fx.CLIP_LEN + 2  # the test split trims a frame at each end
TRAIN_CFG = ROOT / "cfg_files" / "train_cfg"


def _yaml(path) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def loss_weights(name: str) -> dict:
    return {k: float(v) for k, v in _yaml(TRAIN_CFG / name).items() if k.startswith("weight_loss_")}


def cli_masks(cfg: dict, bs: int) -> tuple:
    """(traj_mask [bs, T], pose_mask) as test_amass_full draws them for its
    first batch (rohm_tpu/cli/test_amass_full.py: the infill window at frame
    65, the scheme's PoseNet mask; both deterministic in the fixture's
    configs, which leave out the random windows of 'full' without infill)."""
    assert cfg["infill_traj"] or cfg["mask_scheme"] != "full"
    t_repr = fx.CLIP_LEN - 1
    mask_len = int(cfg["traj_mask_ratio"] * 145)
    traj_mask = np.ones((bs, t_repr), np.float32)
    if cfg["infill_traj"]:
        traj_mask[:, 65:65 + mask_len] = 0.0
    pose_mask = amass_eval_pose_mask(
        cfg["mask_scheme"], bs, t_repr - 1,
        window_start=np.full(bs, 65) if cfg["infill_traj"] else None,
        window_len=mask_len if cfg["infill_traj"] else 30)
    return traj_mask, pose_mask


def nets(latent_dim: int = fx.LATENT_DIM, mid_dim: int = fx.MID_DIM) -> dict:
    args = SimpleNamespace(mid_dim=mid_dim, latent_dim=latent_dim)
    return {"trajnet": jcommon.build_trajnet(args, 13, False),
            "trajcontrol": jcommon.build_trajnet(args, 13, True),
            "posenet": jcommon.build_posenet(args)}


def load_params(src=fx.FIXTURE_DIR) -> dict:
    """The fixture's checkpoints as flax param trees."""
    out = {name: flax.traverse_util.unflatten_dict(dict(np.load(Path(src) / f)), sep="/")
           for name, f in fx.CHECKPOINTS.items()}
    out["trajnet"] = {"params": {k: v for k, v in out["trajnet"]["params"].items() if k != "ControlNet_0"}}
    return out


def pipeline(params: dict, cfg: dict, mean, std, body, models=None):
    """The JAX RohmPipeline of a test config, built as test_amass_full
    builds it, with the infill flag handed on (the JAX CLI drops it)."""
    models = models or nets()
    return RohmPipeline(
        trajnet=models["trajnet"], trajnet_params=params["trajnet"],
        trajcontrol=models["trajcontrol"], trajcontrol_params=params["trajcontrol"],
        posenet=models["posenet"], posenet_params=params["posenet"],
        sched_traj=make_schedule("cosine", fx.STEPS_TRAJ), sched_pose=make_schedule("cosine", fx.STEPS_POSE),
        body_model=body, mean=jnp.asarray(mean), std=jnp.asarray(std),
        repr_abs_only=cfg["repr_abs_only"], traj_feat_dim=13, sample_iter=cfg["sample_iter"],
        early_stop=cfg["early_stop"], grad_type="amass" if cfg["cond_fn_with_grad"] else None,
        mask_scheme=cfg["mask_scheme"], input_noise=cfg["input_noise"],
        iter2_cond_noisy_pose=cfg["iter2_cond_noisy_pose"],
        iter2_cond_noisy_traj=cfg["iter2_cond_noisy_traj"], infill_traj=cfg["infill_traj"])


def score(pose, clean, mean, std, cfg: dict, body) -> dict:
    """The JAX eval_amass_full's metrics of a final pose repr [n, T-1, 294]
    on the clean repr `clean`, decoded as test_amass_full decodes them."""
    decode_rec, _ = make_pickle_decoders(body, fx.CLIP_LEN - 2)
    out = decode_rec(jnp.asarray(pose), jnp.asarray(clean), jnp.asarray(mean), jnp.asarray(std))
    saved = dict(zip(("motion_repr_clean_list", "motion_repr_rec_list", "rec_ric_data_clean_list",
                      "rec_ric_data_rec_list_from_abs_traj", "rec_ric_data_rec_list_from_smpl"),
                     (np.asarray(a) for a in out)))
    return {k: float(v) for k, v in evaluate(saved, cfg["mask_scheme"], cfg["traj_mask_ratio"]).items()}


def run_and_score(pipe, b: dict, noise: dict, cfg: dict, body) -> tuple:
    """run_batch on fixture.batch's arrays, then `score`. Returns (pose
    [n, T-1, 294], traj, metrics)."""
    pose, traj = pipe.run_batch(*(b[k] for k in fx.BATCH_INPUTS), jax.random.PRNGKey(0), preset_noise=noise)
    pose, traj = np.asarray(pose), np.asarray(traj)
    return pose, traj, score(pose, b["pose_clean"], pipe.mean, pipe.std, cfg, body)


def _flat(params) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in flax.traverse_util.flatten_dict(params, sep="/").items()}


def _train(step, state, batches, n: int, label: str, log: dict):
    key = jax.random.PRNGKey(TRAIN_SEED)
    t0 = time.perf_counter()
    for i in range(n):
        key, sub = jax.random.split(key)
        state, losses = step(state, *batches(i), sub)
    loss = float(losses["loss"])
    log[label] = {"steps": n, "final_loss": loss, "seconds": round(time.perf_counter() - t0, 1)}
    print(f"[build_fixture] {label}: {n} steps, final loss {loss:.4f}, {log[label]['seconds']} s", flush=True)
    return state


def build(out_dir, steps: dict = TRAIN_STEPS) -> dict:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    body = synthetic_model()
    n, t_repr = fx.N_CLIPS, fx.CLIP_LEN - 1
    joints, params = synthetic_amass_arrays(body, n_clips=n, clip_len=SEQ_LEN, seed=DATA_SEED, grounded=True)
    np.savez_compressed(out_dir / "tree.npz", joints=joints, params=params)

    # stats from the clean repr of the clips the test split cuts, beside
    # PoseNet's checkpoint where both CLIs read them
    clips = (joints[:, 1:-1], params[:, 1:-1])
    ds_stats = AmassClipDataset(split="train", task="pose", logdir=str(out_dir), body_model=body,
                                clip_len=fx.CLIP_LEN, clips=clips)
    mean, std = ds_stats.mean, ds_stats.std

    # the CLIs' batch (noise settings: the CLI defaults, which the test YAMLs keep)
    with tempfile.TemporaryDirectory() as tree:
        fx.write_tree(tree, src=out_dir)
        ds_pose = AmassClipDataset(
            split="test", task="pose", repr_abs_only=False, logdir=str(out_dir), body_model=body,
            preprocessed_amass_root=tree, amass_datasets=list(fx.DATASETS), clip_len=fx.CLIP_LEN, seed=0,
            input_noise=True, noise_std_smplx_global_rot=3.0, noise_std_smplx_body_rot=3.0,
            noise_std_smplx_trans=0.03, noise_std_smplx_betas=0.1, load_noise=False)
    ds_traj = ds_pose.view("traj", repr_abs_only=True)
    kw = dict(shuffle=False, drop_last=False, pad_last="bucket")
    bp, bt = next(ds_pose.batches(n, **kw)), next(ds_traj.batches(n, **kw))
    assert bp["_valid"] == n and np.array_equal(bp["motion_repr_clean"], bt["motion_repr_clean"])
    arrays = {"traj_cond": bt["cond"], "traj_clean": bt["motion_repr_clean"], "pose_noisy": bp["motion_repr_noisy"]}
    cfgs = {name: fx.config(name) for name in fx.CONFIGS}
    for name, cfg in cfgs.items():
        arrays[f"{name}_traj_mask"], arrays[f"{name}_pose_mask"] = cli_masks(cfg, n)
    np.savez_compressed(out_dir / "batch.npz", **{k: np.asarray(v, np.float32) for k, v in arrays.items()})

    # planted contact: all four labels on at the stance frames (the frames
    # whose natural labels are on in any clip, where the feet are lowest),
    # in both task views; the traj view's feeds TrajControl's control_cond
    clean = bp["motion_repr_clean"].astype(np.float32)
    planted = np.nonzero(clean[..., -4:].max(axis=(0, 2)) > 0.5)[0]
    clean[:, planted, -4:] = 1.0
    mean_j, std_j = jnp.asarray(mean), jnp.asarray(std)
    sched_traj = make_schedule("cosine", fx.STEPS_TRAJ)
    sched_pose = make_schedule("cosine", fx.STEPS_POSE)
    models = nets()
    log = {}

    # 1. TrajNet, stage 3
    traj_cond = jnp.asarray(bt["cond"], jnp.float32)
    clean_j = jnp.asarray(clean)

    rng = np.random.default_rng(TRAIN_SEED)

    def traj_batch(i):
        cond = traj_cond
        if rng.uniform() > 1 - MASK_PROB:
            cond = cond * traj_infill_mask(rng, n, t_repr, MAX_INFILL_RATIO)[..., None]
        return ({"motion_repr_clean": clean_j, "cond": cond},)

    p0 = jcommon.init_trajnet_params(models["trajnet"], fx.CLIP_LEN, TRAIN_SEED)
    step = make_trajnet_train_step(models["trajnet"], sched_traj, mean_j, std_j, body,
                                   loss_weights("trajnet_train_vanilla_stage3.yaml"))
    vanilla = _train(step, create_train_state(p0, LR["trajnet"]), traj_batch, steps["trajnet"], "trajnet", log).params
    vanilla = jax.tree.map(np.asarray, vanilla)

    # 2. TrajControl: the graft, then the ControlNet branch alone
    p0 = jcommon.bootstrap_trajcontrol(
        jcommon.init_trajnet_params(models["trajcontrol"], fx.CLIP_LEN, TRAIN_SEED), vanilla)
    ctrl_batch = {"motion_repr_clean": clean_j, "cond": traj_cond, "control_cond": clean_j[..., -272:]}
    step = make_trajnet_train_step(models["trajcontrol"], sched_traj, mean_j, std_j, body,
                                   loss_weights("trajnet_ft_trajcontrol.yaml"))
    state = create_train_state(p0, LR["trajcontrol"], frozen_mask=trajcontrol_frozen_mask(p0))
    control = _train(step, state, lambda i: (ctrl_batch,), steps["trajcontrol"], "trajcontrol", log).params
    control = jax.tree.map(np.asarray, control)
    for k, v in _flat(vanilla).items():  # the frozen backbone stayed the TrajNet
        assert np.array_equal(v, _flat(control)[k]), k

    # 3. PoseNet, the shipped stage weights, skating on
    pcfg = _yaml(TRAIN_CFG / "posenet_train_stage1.yaml")
    pose_noisy = bp["motion_repr_noisy"].astype(np.float32)
    on = jnp.asarray(1.0)
    rng = np.random.default_rng(TRAIN_SEED)

    def pose_batch(i):
        vis = posenet_train_cond_mask(rng, n, t_repr, i, pcfg["start_prox_mask_epoch"], pcfg["mask_scheme"],
                                      None, True)
        return {"motion_repr_clean": clean_j, "cond": jnp.asarray(pose_noisy * vis)}, on

    p0 = jcommon.init_posenet_params(models["posenet"], fx.CLIP_LEN, TRAIN_SEED)
    step = make_posenet_train_step(models["posenet"], sched_pose, mean_j, std_j, body,
                                   loss_weights("posenet_train_stage1.yaml"))

    def pose_step(state, batch, skating, key):
        return step(state, batch, key, skating)

    posenet = _train(pose_step, create_train_state(p0, LR["posenet"]), pose_batch, steps["posenet"], "posenet", log).params
    posenet = jax.tree.map(np.asarray, posenet)
    trained = {"trajnet": vanilla, "trajcontrol": control, "posenet": posenet}
    for name in ("trajcontrol", "posenet"):  # TrajControl's file holds TrajNet too
        np.savez_compressed(out_dir / fx.CHECKPOINTS[name], **_flat(trained[name]))

    # contact saturation: PoseNet's x0 prediction at t = 25 from the planted
    # clean pose, under each config's evaluation condition
    x0 = jnp.asarray(clean[:, :t_repr - 1])
    noise = np.random.default_rng(MARGIN_SEED).standard_normal(x0.shape).astype(np.float32)
    t = jnp.full((n,), MARGIN_T, jnp.int32)
    x_t = q_sample(sched_pose, x0, t, jnp.asarray(noise))
    margins = {}
    for name in cfgs:
        cond = jnp.asarray(pose_noisy[:, :t_repr - 1] * arrays[f"{name}_pose_mask"])
        out = np.asarray(models["posenet"].apply(posenet, x_t, cond, t))
        m = np.abs(out[..., -4:] - 0.5)
        margins[name] = {"mean": float(m.mean()), "min": float(m.min()),
                         "per_clip_min": [float(v) for v in m.min(axis=(1, 2))]}
        print(f"[build_fixture] contact margin ({name}): mean {m.mean():.3f}, min {m.min():.3f}", flush=True)

    # the JAX metrics of each config on the batch, with the replayed noise
    noise = fx.preset_noise(n)
    metrics, seconds = {}, {}
    for name, cfg in cfgs.items():
        t0 = time.perf_counter()
        pipe = pipeline(trained, cfg, mean, std, body, models)
        _, _, metrics[name] = run_and_score(pipe, fx.batch(name, n, src=out_dir), noise, cfg, body)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"[build_fixture] JAX metrics ({name}): {metrics[name]}", flush=True)

    meta = {
        "built_by": "tests/torch_trained/build_fixture.py",
        "jax": jax.__version__, "flax": flax.__version__,
        "data_seed": DATA_SEED, "train_seed": TRAIN_SEED, "noise_seed": fx.NOISE_SEED,
        "n_clips": n, "clip_len": fx.CLIP_LEN, "sequence_len": SEQ_LEN, "datasets": fx.DATASETS,
        "latent_dim": fx.LATENT_DIM, "ff_size": 1024, "num_layers": 8, "num_heads": 4, "mid_dim": fx.MID_DIM,
        "lr": LR, "train_steps": steps, "train": log,
        "infill_curriculum": {"mask_prob": MASK_PROB, "max_infill_ratio": MAX_INFILL_RATIO},
        "planted_contact_frames": [int(f) for f in planted],
        "contact_margin": {"t": MARGIN_T, "noise_seed": MARGIN_SEED, **margins},
        "chains": {"trajnet": fx.STEPS_TRAJ, "posenet": fx.STEPS_POSE, "sample_iter": fx.SAMPLE_ITER},
        "configs": fx.CONFIGS, "jax_metrics": metrics, "jax_pipeline_seconds": seconds,
        "build_seconds": round(time.perf_counter() - t_start, 1),
    }
    with open(out_dir / "meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", default=str(fx.FIXTURE_DIR))
    build(parser.parse_args().out)
