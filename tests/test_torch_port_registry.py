"""Every name of the JAX package's model registry builds in the port (on the
meta device: the DINOv2 giant would take 4.5 GB in f32 on the CPU) with
JAX's parameter count at its default image size, and the port registers no
other name than its tiny DINOv2 test backbone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from octic_vits_tpu.models import registry as J_reg
from octic_vits_tpu_torch import create_model, list_models

# the names the JAX registry module registers itself (test modules add theirs)
JAX_NAMES = sorted(name for name, fn in J_reg._REGISTRY.items()
                   if fn.__module__ == J_reg.__name__)


def test_registry_names_match_jax():
    assert len(JAX_NAMES) == 31
    assert set(list_models()) - set(JAX_NAMES) == {"hybrid_dinov2_vit_tiny_test"}
    assert set(JAX_NAMES) <= set(list_models())


@pytest.mark.parametrize("name", JAX_NAMES)
def test_registry_model_builds_with_jax_parameter_count(name):
    model = create_model(name, device="meta")
    jmodel = J_reg.create_model(name)
    size = jmodel.img_size
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == count
