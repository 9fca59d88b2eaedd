"""The sharded serving steps of ``tests/test_torch_sharded_steps.py`` on the
2x2x2 pod mesh: eight ``gloo`` ranks, the batch over ('pod', 'data'), the
serving layout's experts over every axis their count divides.  A file of
its own, so that its eight-process groups run beside the 2x2 ones."""

import pytest

import repro.configs as jconfigs
from test_torch_sharded_steps import check_sharded_serving


@pytest.mark.parametrize("arch", list(jconfigs.ARCH_IDS))
def test_sharded_serving_on_pod_mesh_matches(arch, tmp_path):
    check_sharded_serving(arch, (2, 2, 2), tmp_path)
