"""RohmPipeline(mesh=) on the CPU: two gloo ranks (spawned processes, a file
rendezvous in tmp_path), each on 1 of the 2 clips of test_torch_pipeline.py's
slice with every noise replayed, against the single-process port and the
JAX pipeline on a 2-device data mesh (as tests/test_pipeline.py builds it).
The rank body is torch_dp_workers.pipeline_batch."""

import jax
import numpy as np
import pytest
import test_torch_pipeline as tpipe
import torch
import torch_dp_workers as workers
from test_torch_data_parallel import jax_mesh2, ranks

from rohm_tpu_torch.parallel import DataMesh
from rohm_tpu_torch.pipeline import RohmPipeline

torch.set_num_threads(1)


# (fused, guided, (max, mean) gates against the single-process port, and against JAX)
CASES = [
    # guided f32: only the skating guidance's sums are split in two
    # (measured max 2.1e-4); the JAX gates of test_torch_pipeline.py
    (False, True, (1e-3, 1e-5), (1e-2, 1e-3)),
    # int8 unguided (the guided int8 tail is knife-edge, test_torch_pipeline_int8.py):
    # an f32 product over 16 rows instead of 32 sums in another order and can
    # flip an int8 rounding, as across packages: the JAX gates of
    # test_torch_pipeline_unguided.py for both
    ("int8", False, (0.5, 2e-2), (0.5, 2e-2)),
]


@pytest.mark.parametrize("fused, guided, own, jax_gate", CASES, ids=["f32_guided", "int8"])
def test_pipeline_over_two_ranks(tmp_path, fused, guided, own, jax_gate):
    """The global outputs come back on both ranks, equal to each other, to
    the single-process port's within `own` and to the JAX pipeline's
    within `jax_gate` (int8: the JAX kernel in interpret mode, the port's
    plain version)."""
    models, _, _, mean, std, inputs, noise = tpipe._slice_setup()
    sds = {k: {n: v.numpy() for n, v in m.state_dict().items()} for k, m in models.items()}
    steps = (tpipe.STEPS_TRAJ, tpipe.STEPS_POSE)
    two = ranks(tmp_path, workers.pipeline_batch, 2, sds, mean, std, inputs, noise, fused, guided, steps)
    jp, tp = tpipe._pipelines(fused)
    if not guided:
        jp.grad_type = tp.grad_type = None
    pose1, traj1 = tp.run_batch(*inputs, torch.Generator().manual_seed(0), preset_noise=noise)
    jp.mesh = jax_mesh2()
    pose_j, traj_j = jp.run_batch(*inputs, jax.random.PRNGKey(0), preset_noise=noise)
    assert len(pose_j.sharding.device_set) == 2
    for pose, traj in two:
        assert pose.shape == (tpipe.B, tpipe.T_POSE, 294) and traj.shape == (tpipe.B, tpipe.T_TRAJ, 13)
        for got, want, gate in ((pose, pose1.numpy(), own), (traj, traj1.numpy(), own),
                                (pose, pose_j, jax_gate), (traj, traj_j, jax_gate)):
            dev = np.abs(got - np.asarray(want))
            assert dev.max() < gate[0] and dev.mean() < gate[1], (dev.max(), dev.mean(), gate)
    np.testing.assert_array_equal(two[0][0], two[1][0])


def test_f32_pipeline_refuses_a_mesh():
    """fused_posenet='f32' with a mesh raises, as in the JAX package; the
    other modes take one."""
    models, _, tbody, mean, std, *_ = tpipe._slice_setup()
    mesh = DataMesh(None, 0, 2, torch.device("cpu"))

    def make(mode):
        return RohmPipeline(trajnet=models["trajnet"], trajcontrol=None, posenet=models["posenet"],
                            sched_traj=tpipe.make_schedule("cosine", 5), sched_pose=tpipe.make_schedule("cosine", 8),
                            body_model=tbody, mean=torch.from_numpy(mean), std=torch.from_numpy(std),
                            fused_posenet=mode, mesh=mesh)

    with pytest.raises(ValueError, match="'f32' does not support a mesh"):
        make("f32")
    for mode in (False, True, "bf16", "int8", "int8qa"):
        make(mode)
