"""The port's aggregator against catseg_tpu, on the CPU, and its guards.

Config: the flagship eval preset cut to a mini CLIP (patch 16 at 384^2,
width 128, 2 heads of 64, 3 layers, taps (0, 1), embed 64) and pad_len 8
with T = 6 classes, so every JAX kernel gate holds (hidden 128, 24x24 grid,
window 12, >= 512 LN rows) and the class layer's pad terms are live.  fp32.
Parameters: the port's seeded init, converted to a JAX pytree by
catseg_tpu.weights.convert (numpy; a JAX random init of the same tree takes
~20 s eagerly on this CPU), then exported back with
export_catseg_checkpoint and loaded with load_state_dict(strict=True).
Aggregator logits are held to 1e-4 abs (summation order; the reference's
fp32 GELU polynomial is 1.5e-5 from erf).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catseg_tpu.configs import CLIPVariant, eval_preset, vitb384
from catseg_tpu.core.aggregator import aggregator_forward as j_aggregator_forward
from catseg_tpu.weights.convert import convert_catseg_checkpoint
from catseg_tpu.weights.export import export_aggregator_state_dict

from catseg_tpu_torch.core.aggregator import Aggregator, aggregator_forward
from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
from catseg_tpu_torch.kernels import selfcheck

MINI = CLIPVariant("mini-B/16", 16, 128, 3, 2, 64, 224, 128, 2, 2)


def mini_cfg(**kw):
    return eval_preset(vitb384(clip=MINI, guidance_layers=(0, 1), guidance_proj_dim=128,
                               text_guidance_dim=64, appearance_guidance_dim=64, pad_len=8,
                               compute_dtype="float32", fused_decoder=False, **kw))


def mini_params(seed: int = 0) -> dict:
    """A JAX CATSeg pytree (numpy leaves) for mini_cfg()."""
    cfg = mini_cfg()
    sd = {k: v.numpy() for k, v in init_catseg_(CATSeg(cfg), seed).state_dict().items()}
    return convert_catseg_checkpoint(sd, num_layers=cfg.num_layers)


@pytest.fixture(scope="module")
def params():
    return mini_params()


def test_aggregator_matches_jax(params):
    cfg = mini_cfg()
    agg = Aggregator(cfg)
    agg.load_state_dict({k: torch.tensor(v) for k, v in export_aggregator_state_dict(params["agg"]).items()},
                        strict=True)
    rng = np.random.RandomState(0)
    img = rng.randn(1, 24, 24, 64).astype(np.float32)
    txt = rng.randn(1, 6, 1, 64).astype(np.float32)
    guid = (rng.randn(1, 24, 24, 64).astype(np.float32), rng.randn(1, 48, 48, 256).astype(np.float32),
            rng.randn(1, 96, 96, 128).astype(np.float32))
    want = j_aggregator_forward(params["agg"], jnp.asarray(img), jnp.asarray(txt),
                                tuple(jnp.asarray(g) for g in guid), cfg)
    with torch.no_grad():
        got = aggregator_forward(agg, torch.from_numpy(img), torch.from_numpy(txt),
                                 tuple(torch.from_numpy(g) for g in guid), cfg)
    assert got.shape == (1, 6, 96, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_topk_path_raises():
    """T > pad_len needs the top-k truncation, which the port does not have yet."""
    cfg = eval_preset(vitb384(pad_len=4))
    with pytest.raises(NotImplementedError, match="top-k"):
        aggregator_forward(None, None, torch.zeros(1, 5, 1, 512), (), cfg)


@pytest.mark.parametrize("name", [k[0] for k in selfcheck.KERNELS])
def test_kernel_wrappers_refuse_other_devices(name):
    """A wrapper runs its plain version only for CPU tensors: any other
    non-CUDA device raises instead of falling back."""
    kernel, _ = selfcheck.cases(torch.device("meta"), torch.float32, small=True)[name]
    with pytest.raises(RuntimeError, match="no .* path for device meta"):
        kernel()
