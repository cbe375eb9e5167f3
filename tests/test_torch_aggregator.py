"""The port's aggregator against catseg_tpu, on the CPU, and its guards.

Config: the flagship eval preset cut to a mini CLIP (patch 16 at 384^2,
width 128, 2 heads of 64, 3 layers, taps (0, 1), embed 64) and pad_len 8
with T = 6 classes, so every JAX kernel gate holds (hidden 128, 24x24 grid,
window 12, >= 512 LN rows) and the class layer's pad terms are live.  fp32.
The JAX config and the port's come from the same keyword arguments
(``mini_cfg`` / ``mini_cfg_port``).
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

from catseg_tpu import configs as jconfigs
from catseg_tpu.core.aggregator import aggregator_forward as j_aggregator_forward
from catseg_tpu.weights.convert import convert_catseg_checkpoint
from catseg_tpu.weights.export import export_aggregator_state_dict

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core.aggregator import Aggregator, aggregator_forward
from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
from catseg_tpu_torch.kernels import selfcheck


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads: beside the suite's parallel workers and JAX's
    threads, the default pool (one thread a core) took about twice as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _mini(configs, **kw):
    base = dict(clip=configs.CLIPVariant("mini-B/16", 16, 128, 3, 2, 64, 224, 128, 2, 2),
                guidance_layers=(0, 1), guidance_proj_dim=128, text_guidance_dim=64,
                appearance_guidance_dim=64, pad_len=8, compute_dtype="float32", fused_decoder=False)
    base.update(kw)
    return configs.eval_preset(configs.vitb384(**base))


def mini_cfg(**kw):
    """The mini config as catseg_tpu's dataclass (for the JAX side)."""
    return _mini(jconfigs, **kw)


def mini_cfg_port(**kw):
    """The same config as the port's own dataclass."""
    return _mini(tconfigs, **kw)


def mini_params(seed: int = 0) -> dict:
    """A JAX CATSeg pytree (numpy leaves) for mini_cfg()."""
    cfg = mini_cfg_port()
    sd = {k: v.numpy() for k, v in init_catseg_(CATSeg(cfg), seed).state_dict().items()}
    return convert_catseg_checkpoint(sd, num_layers=cfg.num_layers)


@pytest.fixture(scope="module")
def params():
    return mini_params()


def test_aggregator_matches_jax(params):
    cfg = mini_cfg()
    agg = Aggregator(mini_cfg_port())
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
                                 tuple(torch.from_numpy(g) for g in guid), mini_cfg_port())
    assert got.shape == (1, 6, 96, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_topk_path_raises(monkeypatch):
    """T > pad_len runs the top-k truncation (tests/test_torch_topk.py holds it
    to catseg_tpu); like every path it raises on a device with no kernel path
    (here meta) rather than falling back to the plain versions."""
    from catseg_tpu_torch.core import aggregator as agg_mod

    picked, topk = [], agg_mod.topk_classes
    monkeypatch.setattr(agg_mod, "topk_classes", lambda corr, k: picked.append(k) or topk(corr, k))
    meta = torch.device("meta")
    agg = Aggregator(mini_cfg_port()).to(meta)
    img, txt = torch.empty(1, 24, 24, 64, device=meta), torch.empty(1, 10, 1, 64, device=meta)
    guid = tuple(torch.empty(1, s, s, c, device=meta) for s, c in ((24, 64), (48, 256), (96, 128)))
    with pytest.raises(RuntimeError, match="no .* path for device meta"):
        aggregator_forward(agg, img, txt, guid, mini_cfg_port())
    assert picked == [8]


@pytest.mark.parametrize("name", [k[0] for k in selfcheck.KERNELS])
def test_kernel_wrappers_refuse_other_devices(name):
    """A wrapper runs its plain version only for CPU tensors: any other
    non-CUDA device raises instead of falling back."""
    case = selfcheck.cases(torch.device("meta"), torch.float32, small=True)[name]
    with pytest.raises(RuntimeError, match="no .* path for device meta"):
        case.kernel()
