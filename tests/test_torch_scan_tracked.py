"""The port's tracked scan path by path against the JAX package's: every
case of ``test_torch_scan.py`` in tracked mode (the per-path vectors and
the trajectory, price-level and withdrawal-rate series), with the same
bounds."""

import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_scan import CASES, check_case  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("case", list(CASES))
def test_tracked_simulate_paths_equals_jax_path_by_path(case):
    check_case(case, tracked=True)
