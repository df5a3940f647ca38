"""The port's data layer and its copied helpers against the JAX package, on
the CPU: config parsing, stats, canonicalization, clip cutting, metrics, the
synthetic AMASS tree, and AmassClipDataset (arrays, stats, batch order and
padding, and a disk cache that never reads the JAX package's)."""

import os
import pickle

import numpy as np
import pytest
import torch

from rohm_tpu.body import synthetic_model as jax_synthetic_model
from rohm_tpu.data import AmassClipDataset as JaxDataset
from rohm_tpu.data import clips as jclips
from rohm_tpu.data import write_synthetic_amass as jax_write_amass
from rohm_tpu.data.synthetic import synthetic_clip_batch as jax_clip_batch
from rohm_tpu.evals import metrics as jmetrics
from rohm_tpu.reprs import canonicalize as jcano
from rohm_tpu.reprs import stats as jstats
from rohm_tpu.utils import config as jconfig
from rohm_tpu_torch.body import synthetic_model
from rohm_tpu_torch.data import AmassClipDataset, write_synthetic_amass
from rohm_tpu_torch.data import clips as tclips
from rohm_tpu_torch.data.synthetic import synthetic_clip_batch
from rohm_tpu_torch.evals import metrics as tmetrics
from rohm_tpu_torch.reprs import canonicalize as tcano
from rohm_tpu_torch.reprs import stats as tstats
from rohm_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

CLIP_LEN = 17
DATASETS = {"SetA": 2, "SetB": 1}
NOISE = dict(input_noise=True, noise_std_smplx_global_rot=3.0, noise_std_smplx_body_rot=3.0,
             noise_std_smplx_trans=0.03, noise_std_smplx_betas=0.1)


# ---------------------------------------------------------------------------
# copied helpers
# ---------------------------------------------------------------------------


def _parser(mod):
    p = mod.ConfigParser("t")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--input_noise", type=bool, default=False)
    p.add_argument("--mask_scheme", type=str, default="full")
    p.add_argument("--fused_posenet", type=mod.fused_mode, default=False)
    p.add_argument("--clip_len", "--clip-len", type=int, default=145)
    return p


def test_config_parser_matches(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("seed: 3\ninput_noise: 'True'\nclip-len: 17\nextra_key: 5\nmask_scheme: lower\n")
    argvs = [[], [f"--config={cfg}"], [f"--config={cfg}", "--seed=7", "--fused_posenet=int8qa"],
             ["--fused_posenet=1", "--input_noise=false"], ["--fused_posenet=F32"]]
    for argv in argvs:
        assert vars(_parser(tconfig).parse_args(argv)) == vars(_parser(jconfig).parse_args(argv))
    for x in ("True", "1", "false", "0", "yes", True, False):
        assert tconfig.str2bool(x) == jconfig.str2bool(x)
        assert tconfig.fused_mode(x) == jconfig.fused_mode(x)
    argv = ["--a=1", "--via_server", "x", "--via_server=True", "--b", "2"]
    assert tconfig.strip_flag(argv, "--via_server") == jconfig.strip_flag(argv, "--via_server")


def test_stats_match_and_share_a_format(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((5, 16, 294)) * rng.uniform(0.1, 3, 294)
    mean, std = tstats.compute_stats(frames)
    jmean, jstd = jstats.compute_stats(frames)
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)
    # pickles written by either package load in the other
    tstats.save_stats(str(tmp_path / "t"), mean, std)
    jstats.save_stats(str(tmp_path / "j"), jmean, jstd)
    for a, b in zip(jstats.load_stats(str(tmp_path / "t")) + tstats.load_stats(str(tmp_path / "j")),
                    (mean, std, jmean, jstd)):
        np.testing.assert_array_equal(a, b)


def test_canonicalize_matches():
    body = jax_synthetic_model(num_verts=64)
    pos, params = jax_clip_batch(body, 2, CLIP_LEN, seed=4)
    for i in range(2):
        p = {k: v[i] for k, v in params.items()}
        out, cp, mat = tcano.cano_seq_smplx(pos[i], p, return_transf_mat=True)
        jout, jcp, jmat = jcano.cano_seq_smplx(pos[i], p, return_transf_mat=True)
        np.testing.assert_array_equal(out, jout)
        np.testing.assert_array_equal(mat, jmat)
        for k in jcp:
            np.testing.assert_array_equal(cp[k], jcp[k])


def test_clip_helpers_match():
    seq = np.arange(50 * 3).reshape(50, 3)
    for clip_len in (7, 16, 50, 60):
        a, b = tclips.divide_into_clips(seq, seq * 2, clip_len), jclips.divide_into_clips(seq, seq * 2, clip_len)
        assert len(a[0]) == len(b[0])
        for x, y in zip(a[0] + a[1], b[0] + b[1]):
            np.testing.assert_array_equal(x, y)
    for valid in range(1, 17):
        for pad_last, mult in ((True, 1), ("bucket", 1), ("bucket", 4)):
            assert tclips.pad_tail_size(valid, 16, pad_last, mult) == jclips.pad_tail_size(valid, 16, pad_last, mult)
    assert tclips.overlapping_windows(300, 145, 20) == jclips.overlapping_windows(300, 145, 20)


def test_metrics_match():
    rng = np.random.default_rng(1)
    clean = rng.standard_normal((3, 100, 22, 3)) * 0.3  # 100 frames: the infill window is 65-79
    clean[..., 2] = np.abs(clean[..., 2])
    rec = clean + 0.05 * rng.standard_normal(clean.shape)
    repr_clean = rng.integers(0, 2, (3, 100, 294)).astype(np.float32)
    repr_rec = rng.uniform(0, 1, (3, 100, 294)).astype(np.float32)
    assert tmetrics.mpjpe_global(clean, rec) == jmetrics.mpjpe_global(clean, rec)
    for scheme in ("lower", "upper", "full"):
        assert tmetrics.mpjpe_masked(clean, rec, scheme, 0.1) == jmetrics.mpjpe_masked(clean, rec, scheme, 0.1)
    assert tmetrics.contact_label_accuracy(repr_clean, repr_rec) == jmetrics.contact_label_accuracy(repr_clean, repr_rec)
    assert tmetrics.skating_ratio(rec, clean) == jmetrics.skating_ratio(rec, clean)
    assert tmetrics.accel_error(clean, rec) == jmetrics.accel_error(clean, rec)
    assert tmetrics.ground_penetration(rec, clean) == jmetrics.ground_penetration(rec, clean)


# ---------------------------------------------------------------------------
# synthetic trees and the dataset
# ---------------------------------------------------------------------------


def _models():
    return synthetic_model(num_verts=64), jax_synthetic_model(num_verts=64)


def test_synthetic_clip_batch_matches():
    tbody, jbody = _models()
    pos, params = synthetic_clip_batch(tbody, 3, CLIP_LEN, seed=2, grounded=True)
    jpos, jparams = jax_clip_batch(jbody, 3, CLIP_LEN, seed=2, grounded=True)
    for k in jparams:
        np.testing.assert_array_equal(params[k], jparams[k])  # the same numpy generators
    # f32 forward kinematics in both frameworks: a 22-joint chain of 3x3
    # products, ~1e-7 relative on positions of ~1 m
    np.testing.assert_allclose(pos, jpos, atol=2e-6, rtol=0)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("amass")
    tbody, jbody = _models()
    write_synthetic_amass(str(root / "torch"), tbody, datasets=DATASETS, seq_len=40, seed=1)
    jax_write_amass(str(root / "jax"), jbody, datasets=DATASETS, seq_len=40, seed=1)
    return root


def test_synthetic_amass_tree_matches(trees):
    files = sorted(os.path.relpath(os.path.join(d, f), trees / "torch")
                   for d, _, fs in os.walk(trees / "torch") for f in fs)
    jfiles = sorted(os.path.relpath(os.path.join(d, f), trees / "jax")
                    for d, _, fs in os.walk(trees / "jax") for f in fs)
    assert files == jfiles and len(files) == 2 * sum(DATASETS.values())
    for f in files:
        a, b = np.load(trees / "torch" / f), np.load(trees / "jax" / f)
        assert a.shape == b.shape
        # params are the same numpy draws; joints come from f32 FK
        np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)


def _datasets(root, split="train", cache=None, **kw):
    tbody, jbody = _models()
    common = dict(preprocessed_amass_root=str(root), amass_datasets=list(DATASETS), split=split,
                  clip_len=CLIP_LEN, seed=5, task="pose", **NOISE, **kw)
    t = AmassClipDataset(tbody, disk_cache_dir=cache, **common)
    j = JaxDataset(jbody, disk_cache_dir=cache, **common)
    return t, j


def test_dataset_matches_jax(trees):
    """One tree (the JAX package's), both datasets: the same clips, the same
    noise draws (one default_rng(seed), the same order), FK and the repr
    encoding in f32 in each framework."""
    t, j = _datasets(trees / "jax")
    assert t.n_samples == j.n_samples == 6  # 3 sequences of 40 frames, two 17-frame clips each
    for k in ("global_orient", "transl", "body_pose", "betas"):
        np.testing.assert_array_equal(t.smplx_noise_dict[k], j.smplx_noise_dict[k])
        np.testing.assert_array_equal(t.cano_params[k], j.cano_params[k])
    np.testing.assert_allclose(t.joints_noisy, j.joints_noisy, atol=2e-6, rtol=0)
    # f32 encoders: positions and velocities to ~1e-6; the heading angle
    # (atan2 of a normalized cross product) to ~1e-5
    np.testing.assert_allclose(t.repr_clean, j.repr_clean, atol=5e-5, rtol=0)
    np.testing.assert_allclose(t.repr_noisy, j.repr_noisy, atol=5e-5, rtol=0)
    # stats over those frames; each normalized dim is (x - mean) / std
    np.testing.assert_allclose(t.mean, j.mean, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.std, j.std, atol=1e-5, rtol=1e-4)

    traj_t, traj_j = t.view("traj", repr_abs_only=True), j.view("traj", repr_abs_only=True)
    for bs in (3, 4):
        for (x, y), kw in (
            ((t, j), dict(shuffle=False, pad_last="bucket")),
            ((traj_t, traj_j), dict(shuffle=True, seed=2, drop_last=True)),
        ):
            bx, by = list(x.batches(bs, **kw)), list(y.batches(bs, **kw))
            assert len(bx) == len(by) > 0
            for a, b in zip(bx, by):
                assert set(a) == set(b)
                for k in b:
                    if k == "_valid":
                        assert a[k] == b[k]
                        continue
                    assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                    # normalized by stds down to ~0.05: 5e-5 / 0.05 = 1e-3
                    np.testing.assert_allclose(a[k], b[k], atol=2e-3, rtol=0)
    assert set(next(traj_t.batches(2))) == {"motion_repr_clean", "motion_repr_noisy", "noisy_joints",
                                            "cond", "control_cond"}
    # a short last batch pads to the next power of two by repeating its last
    # clip: 6 clips at bs=4 leave 2 (bucket 2); at bs=16, 6 pad to 8
    last = list(t.batches(4, shuffle=False, pad_last="bucket"))[-1]
    assert last["_valid"] == 2 and last["motion_repr_clean"].shape[0] == 2
    whole = next(t.batches(16, shuffle=False, pad_last="bucket"))
    assert whole["_valid"] == 6 and whole["motion_repr_clean"].shape[0] == 8
    np.testing.assert_array_equal(whole["motion_repr_clean"][6:], whole["motion_repr_clean"][[5, 5]])


def test_disk_cache_never_reads_the_jax_packages(trees, tmp_path):
    """Both packages cache derived arrays in <root>/_repr_cache. The port's
    files carry their own tag (amass_torch_<key>), so a JAX cache in the
    directory, here one overwritten with zeros, is never read."""
    cache = str(tmp_path / "_repr_cache")
    t0, j = _datasets(trees / "jax", cache=cache)
    jax_file = j._cache_path
    assert os.path.basename(jax_file).startswith("amass_") and os.path.exists(jax_file)
    assert os.path.basename(t0._cache_path).startswith("amass_torch_")
    assert os.path.exists(t0._cache_path) and t0._cache_path != jax_file
    with np.load(jax_file) as z:
        poisoned = {k: np.zeros_like(v) for k, v in z.items()}
    with open(jax_file, "wb") as f:
        np.savez(f, **poisoned)
    os.remove(t0._cache_path)
    t1, _ = _datasets(trees / "jax", split="train", cache=cache)
    assert np.abs(t1.repr_clean).max() > 0.1
    np.testing.assert_array_equal(t1.repr_clean, t0.repr_clean)
    # and a second port build reads its own cache back unchanged
    t2, _ = _datasets(trees / "jax", cache=cache)
    np.testing.assert_array_equal(t2.repr_noisy, t0.repr_noisy)


def test_noise_dict_pickle_roundtrip(tmp_path):
    from rohm_tpu.data import load_noise_dict as jload
    from rohm_tpu_torch.data import load_noise_dict, save_noise_dict

    d = {"transl": np.ones((2, 3)), "betas": np.zeros((2, 10))}
    save_noise_dict(str(tmp_path / "n.pkl"), d)
    for loaded in (load_noise_dict(str(tmp_path / "n.pkl")), jload(str(tmp_path / "n.pkl"))):
        for k in d:
            np.testing.assert_array_equal(loaded[k], d[k])
    with open(tmp_path / "n.pkl", "rb") as f:
        assert set(pickle.load(f)) == set(d)
