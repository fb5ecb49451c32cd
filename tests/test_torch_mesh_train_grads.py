"""The sharded ``lm_loss`` and every gradient on eight CPU shards against
the port's one device and the reference's ``jax.value_and_grad``, for
the dense and vlm archs (``tests/_mesh_train.py``): (data 2, model 4) and
(data 4, model 2) meshes, sequence parallelism off and on (with remat),
accumulation 1 and 2, labels of -1 placed unevenly. Tolerance 1e-4:
the loss relative, each gradient leaf of its own largest magnitude.
"""
import pytest

from _mesh_train import (MESH_IDS, MESHES,  # noqa: F401
                         check_loss_and_grads, one_thread)
from repro.configs import get_config, list_configs

ARCHS = [a for a in list_configs() if get_config(a).family in ('dense', 'vlm')]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("sp", [False, True], ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_loss_and_grads_match_one_device_and_reference(
        arch, mesh_shape, sp, accum):
    check_loss_and_grads(arch, mesh_shape, sp, accum)
