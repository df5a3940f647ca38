"""Where the trained fixture came from: tests/torch_trained/build_fixture.py
run again (about 30 minutes on the CPU, so `slow`) makes what is committed.

Held: the tree, the batch and the stats to 1e-6 (the same seeds, FK and
encoding); every weight within 1e-3 of its tensor's largest |value| (on the
host that built the fixture the rebuild is bit for bit the same; XLA on
another CPU may round differently, and thousands of AdamW steps carry
that); the contact margins over their bounds; the JAX metrics within rel
1e-2 or abs 1e-6 of meta.json's, the bound of the tier-1 parity tests.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from tests.torch_trained import fixture as fx

pytestmark = pytest.mark.slow

WEIGHT_TOL = 1e-3


@pytest.fixture(scope="module")
def rebuilt(tmp_path_factory):
    from tests.torch_trained import build_fixture as bf

    out = tmp_path_factory.mktemp("fixture")
    bf.build(out)
    return out


@pytest.mark.parametrize("name", ["tree.npz", "batch.npz", "AMASS_mean.pkl", "AMASS_std.pkl"])
def test_inputs_rebuilt(rebuilt, name):
    if name.endswith(".pkl"):
        from rohm_tpu.reprs.stats import load_stats

        for a, b in zip(load_stats(str(rebuilt)), load_stats(str(fx.FIXTURE_DIR))):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        return
    new, old = np.load(rebuilt / name), np.load(fx.FIXTURE_DIR / name)
    assert set(new.files) == set(old.files)
    for k in old.files:
        np.testing.assert_allclose(new[k], old[k], atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", sorted(set(fx.CHECKPOINTS.values())))
def test_weights_rebuilt(rebuilt, name):
    new, old = np.load(rebuilt / name), np.load(fx.FIXTURE_DIR / name)
    assert set(new.files) == set(old.files)
    worst = max(np.abs(new[k] - old[k]).max() / max(np.abs(old[k]).max(), 1e-12) for k in old.files)
    print(f"[trained-fixture] {name}: worst weight difference {worst:.3e} of its tensor's largest |value|")
    assert worst <= WEIGHT_TOL


def test_meta_rebuilt(rebuilt):
    with open(rebuilt / "meta.json") as f:
        new = json.load(f)
    old = fx.meta()
    assert new["planted_contact_frames"] == old["planted_contact_frames"]
    for name in fx.CONFIGS:
        m = new["contact_margin"][name]
        assert m["mean"] > 0.4 and m["min"] > 0.2, (name, m)
        assert fx.metric_gaps(new["jax_metrics"][name], old["jax_metrics"][name], fx.JAX_REL, fx.JAX_ABS) == [], name
