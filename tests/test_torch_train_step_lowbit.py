"""One training step of DoReFa and wbwtab (W = 3 and W = 2), the port
against ``jax.grad`` of the JAX package, block by block; the cases and
tolerances of ``test_torch_train_step.py``, split off to keep each file
short."""

import pytest

from _torch_step_flow import run_case
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("case", ["dorefa", "wbwtab_w3", "wbwtab_w2"])
def test_one_step_matches_jax_grad(case):
    n, excused = run_case(case)
    assert n >= 12
