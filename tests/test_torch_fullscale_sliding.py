"""The port against catseg_tpu at full width on the sliding-window branch,
on the CPU: the ``eval_preset`` case of tests/test_torch_fullscale.py (its
text features, image and bound), in a file of its own so that the two
halves run on two workers.  Its parameters are the port's seeded init at
``vitb384(compute_dtype="float32")`` converted to a catseg_tpu pytree by
catseg_tpu.weights.convert (as test_torch_aggregator.py's ``mini_params``
makes them), which costs seconds where catseg_tpu's jitted init costs
half a minute; tests/test_torch_fullscale.py keeps that init and its load.
"""

import pytest

from catseg_tpu.weights.convert import convert_catseg_checkpoint

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
from catseg_tpu_torch.weights.from_jax import load_params_

from test_torch_fullscale import check_image_path, make_image, make_names, make_text, two_torch_threads  # noqa: F401


@pytest.mark.parametrize("branch", ["sliding"])
def test_image_paths_fullscale(branch):
    """The sliding window under eval_preset (5 tiles of 384^2, T = 150)."""
    cfg = tconfigs.vitb384(compute_dtype="float32")
    sd = {k: v.numpy() for k, v in init_catseg_(CATSeg(cfg), 0).state_dict().items()}
    params = convert_catseg_checkpoint(sd, num_layers=cfg.num_layers)
    models, names = (params, load_params_(CATSeg(cfg), params).eval()), make_names()
    check_image_path(models, names, make_text(models, names), make_image(), branch)
