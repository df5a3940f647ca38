"""The int8 --fused_posenet modes ("int8", "int8qa") against the plain path
with trained weights, as test_torch_trained_modes.py holds "f32" and "bf16"
(the same batch, noise and budgets; a file of their own so that each file
stays within a few minutes on one test worker)."""

from __future__ import annotations

import pytest

from tests.test_torch_trained_modes import few_threads, trained  # noqa: F401 (fixtures)
from tests.test_torch_trained_modes import test_mode_metrics_within_budget as _gate

MODES = ("int8", "int8qa")


@pytest.mark.parametrize("mode", MODES)
def test_mode_metrics_within_budget(trained, mode):  # noqa: F811
    _gate(trained, mode)
