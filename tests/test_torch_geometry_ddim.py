"""The port's Euler-angle, qfix and slerp surface and its DDIM sampler
against the JAX package, on the CPU, from seeded numpy inputs (the JAX
functions are the reference here, not the reference repository)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rohm_tpu import geometry as jgeo
from rohm_tpu.diffusion import ddim_sample_loop as jax_ddim
from rohm_tpu.diffusion import make_schedule as jax_make_schedule
from rohm_tpu_torch import geometry as tgeo
from rohm_tpu_torch.diffusion import ddim_sample_loop, make_schedule

torch.set_num_threads(1)

ORDERS = ("xyz", "yzx", "zxy", "xzy", "yxz", "zyx")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _quats(n=256, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[0] = [1, 0, 0, 0]  # identity
    q[1] = [np.cos(np.pi / 4), 0, np.sin(np.pi / 4), 0]  # 90 degrees about y: a gimbal pole
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("order", ORDERS)
def test_qeuler_and_euler_to_quat_match_jax(order):
    """Both directions in every order, degrees and radians. f32 asin/atan2
    of the same matrix entries, whose one-ulp differences asin amplifies
    near its poles: measured <= 8.4e-5 deg, 1.5e-6 rad and 1.2e-7 on the
    quaternions; held at 2e-4 deg, 4e-6 rad and 1e-6."""
    q = _quats()
    for deg, tol in ((True, 2e-4), (False, 4e-6)):
        ref = np.asarray(jgeo.qeuler(jnp.asarray(q), order, deg=deg))
        got = tgeo.qeuler(_t(q), order, deg=deg).numpy()
        assert got.shape == ref.shape == (len(q), 3)
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    e = tgeo.qeuler(_t(q), order, deg=False)
    back = tgeo.euler_to_quat(e, order)
    ref = np.asarray(jgeo.euler_to_quat(jnp.asarray(e.numpy()), order))
    np.testing.assert_allclose(back.numpy(), ref, atol=1e-6, rtol=0)
    # the round trip is the same rotation (q or -q), the pole included
    np.testing.assert_allclose(tgeo.quat_to_rotmat(back).numpy(), tgeo.quat_to_rotmat(_t(q)).numpy(),
                               atol=2e-5, rtol=0)


def test_qeuler_rejects_repeated_axes():
    with pytest.raises(ValueError, match="euler order"):
        tgeo.qeuler(_t(_quats(4)), "xyx")


def test_qfix_matches_jax():
    """Sign continuity over a sequence with flips planted: exact (sign
    changes and equal comparisons)."""
    rng = np.random.default_rng(1)
    q = np.cumsum(0.05 * rng.normal(size=(3, 40, 4)), axis=1) + [1, 0, 0, 0]
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    q *= np.where(rng.uniform(size=(3, 40, 1)) < 0.3, -1.0, 1.0).astype(np.float32)
    ref = np.asarray(jgeo.qfix(jnp.asarray(q)))
    got = tgeo.qfix(_t(q)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ((got[:, 1:] * got[:, :-1]).sum(-1) >= 0).all()


def test_qslerp_matches_jax():
    """Shortest arc with the lerp fallback, broadcast over t: measured <=
    9e-8, held at 1e-6; endpoints, an antipodal pair and a near-equal
    pair (the lerp branch) included."""
    q0, q1 = _quats(64, 2), _quats(64, 3)
    q1[0] = -q0[0]  # antipodal: the same rotation, dot < 0
    q1[1] = q0[1] + np.float32(1e-8)  # sin(theta) below 1e-6
    t = np.linspace(0.0, 1.0, 64, dtype=np.float32)[:, None]
    ref = np.asarray(jgeo.qslerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t)))
    got = tgeo.qslerp(_t(q0), _t(q1), _t(t)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    for tt, end in ((0.0, q0), (1.0, q1)):
        same = np.abs((tgeo.qslerp(_t(q0), _t(q1), tt).numpy() * end).sum(-1))
        np.testing.assert_allclose(same, 1.0, atol=1e-5)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_matches_jax(eta):
    """DDIM on a ddim5 schedule of 50 cosine steps, the same x_T and per-step
    noise handed to both, through a model that depends on x and on the
    original timestep. f32 posterior arithmetic in another order: measured
    <= 1.2e-7 on samples up to |0.94|, held at 1e-5."""
    shape = (2, 7, 5)
    jsched, tsched = jax_make_schedule("cosine", 50, "ddim5"), make_schedule("cosine", 50, "ddim5")
    assert tsched.num_timesteps == 5
    rng = np.random.default_rng(4)
    noise = rng.standard_normal(shape).astype(np.float32)
    step_noise = rng.standard_normal((5,) + shape).astype(np.float32)
    seen = []

    def tmodel(x, t):
        seen.append(t)
        return 0.6 * x + 0.01 * t

    ref = np.asarray(jax_ddim(lambda x, t: 0.6 * x + 0.01 * t, jsched, shape, jax.random.PRNGKey(0),
                              eta=eta, noise=jnp.asarray(noise), step_noise=jnp.asarray(step_noise)))
    gen = torch.Generator().manual_seed(0)
    got = ddim_sample_loop(tmodel, tsched, shape, gen, eta=eta, noise=_t(noise), step_noise=_t(step_noise))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    # the model sees the original timesteps, from the noisiest down
    assert seen == sorted(tsched.timestep_map.tolist(), reverse=True) == [40, 30, 20, 10, 0]
    # the per-step noise counts only with eta > 0
    other = ddim_sample_loop(tmodel, tsched, shape, gen, eta=eta, noise=_t(noise),
                             step_noise=_t(step_noise) + 1.0)
    assert torch.equal(other, got) == (eta == 0.0)


def test_ddim_draws_from_the_generator():
    """Without replayed noise: x_T, then one draw per step only when eta > 0;
    the same seed gives the same sample."""
    sched = make_schedule("cosine", 50, "ddim5")

    def run(eta, seed):
        return ddim_sample_loop(lambda x, t: 0.5 * x, sched, (1, 3, 2), torch.Generator().manual_seed(seed),
                                eta=eta)

    assert torch.equal(run(0.5, 3), run(0.5, 3)) and not torch.equal(run(0.5, 3), run(0.5, 4))
    gen = torch.Generator().manual_seed(3)
    ddim_sample_loop(lambda x, t: 0.5 * x, sched, (1, 3, 2), gen, eta=0.0)
    after_eta0 = torch.randn(1, generator=gen)
    gen = torch.Generator().manual_seed(3)
    torch.randn((1, 3, 2), generator=gen)
    assert torch.equal(after_eta0, torch.randn(1, generator=gen))
