"""The weight bridge: catseg_tpu parameters -> the port's modules, on the CPU.

JAX parameters (as numpy) go through catseg_tpu.weights.export's
export_catseg_checkpoint into load_state_dict(strict=True) with no renaming
table, so every key and shape of the port's module tree must be the
exporter's.
"""

import numpy as np
import torch

import jax

from catseg_tpu.core.catseg import init_catseg_params
from catseg_tpu.weights.export import export_catseg_checkpoint

from catseg_tpu import configs as jconfigs
from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
from catseg_tpu_torch.weights.from_jax import load_params_, state_dict_from_params

from test_torch_aggregator import mini_cfg, mini_cfg_port, mini_params


def test_jax_init_loads_strictly():
    """A JAX random init of the mini flagship config loads with strict=True,
    every tensor equal to the exporter's array."""
    cfg = mini_cfg()
    params = jax.tree.map(np.asarray, jax.jit(lambda k: init_catseg_params(k, cfg))(jax.random.PRNGKey(0)))
    model = load_params_(CATSeg(mini_cfg_port()), params)
    want = export_catseg_checkpoint(params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k], np.float32), err_msg=k)


def test_weight_bridge_round_trips_the_port_init():
    """The port's seeded init -> JAX pytree (catseg_tpu.weights.convert) ->
    export -> load gives back the same tensors."""
    params = mini_params()
    sd = state_dict_from_params(params)
    model = CATSeg(mini_cfg_port())
    assert set(sd) == set(model.state_dict())
    load_params_(model, params)
    ref = init_catseg_(CATSeg(mini_cfg_port()), 0).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]) and torch.equal(v, ref[k]), k


def test_flagship_parameter_shapes_match_jax():
    """The port's module tree at the flagship config holds exactly the
    reference's parameters (abstract JAX init, meta-device port)."""
    jcfg = jconfigs.eval_preset(jconfigs.vitb384())
    shapes = jax.eval_shape(lambda k: init_catseg_params(k, jcfg), jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = CATSeg(tconfigs.eval_preset(tconfigs.vitb384()))
    assert sum(p.numel() for p in model.parameters()) == n_jax
