"""The port's checkpoint converter and loaders against catseg_tpu's, on the CPU.

State dicts: catseg_tpu.weights.export of a mini catseg_tpu pytree (the
port's seeded init at the mini config of test_torch_aggregator.py, through
catseg_tpu's converter), with the CLIP attention split (the released files'
``q/k/v_proj_weight``) or fused (``in_proj_weight``, OpenAI / open_clip), the
swin ``attn_mask`` buffers and VPT prompts added; the open_clip mini state
dict of tests/test_openclip.py (``attn_mask`` buffer, a grid-2 positional
embedding run at grid 4); a TorchScript archive built as
tests/test_clip_parity.py builds one.  The port's converted state dict must
equal ``state_dict_from_params(catseg_tpu.weights.convert.<converter>(sd))``
bit for bit (the resized positional embedding within 1 ulp), and
``tools.common.load_params`` must load every format as catseg_tpu's does.
``tools.parity_check`` runs on a synthetic checkpoint at the mini config over
the committed fixture set.
"""

import dataclasses

import numpy as np
import pytest
import torch

from catseg_tpu.weights import convert as jconvert
from catseg_tpu.weights.export import export_catseg_checkpoint, export_clip_state_dict

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core.catseg import CATSeg, build_catseg, init_catseg_
from catseg_tpu_torch.tools import common
from catseg_tpu_torch.tools import parity_check
from catseg_tpu_torch.weights import convert
from catseg_tpu_torch.weights.from_jax import state_dict_from_params

from test_openclip import VARIANT as OPENCLIP_VARIANT
from test_openclip import _mini_openclip_state_dict
from test_torch_aggregator import mini_cfg_port, mini_params

FIXTURES = "tests/torch_fixtures/dataset"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the mini model's small ops would each wait on a
    barrier of the whole pool, which stalls when the suite's parallel
    workers oversubscribe the cores (as tests/test_torch_tools.py does)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def released(params: dict, fused: bool) -> dict[str, np.ndarray]:
    """catseg_tpu's export of ``params`` with VPT prompts added, under the
    released files' names, the CLIP qkv split or fused, with the swin
    attn_mask buffers of the reference (one per shifted block)."""
    clip = dict(params["clip"], visual=dict(params["clip"]["visual"]))
    clip["visual"]["prompt_tokens"] = np.random.RandomState(4).randn(2, 3, 128).astype(np.float32)
    sd = export_catseg_checkpoint(dict(params, clip=clip))
    if fused:
        sd = {k: v for k, v in sd.items() if not k.startswith(convert.CLIP_PREFIX)}
        sd.update({convert.CLIP_PREFIX + k: v for k, v in export_clip_state_dict(clip, split_qkv=False).items()})
    for i in range(len(params["agg"]["layers"])):
        sd[f"{convert.AGG_PREFIX}layers.{i}.swin_block.block_2.attn_mask"] = np.zeros((4, 144, 144))
    return sd


def fused(sd: dict) -> dict:
    """``sd`` with each CLIP attention's q / k / v weights fused into one
    ``in_proj_weight`` (as the OpenAI and open_clip files hold them)."""
    out = dict(sd)
    for k in [k for k in sd if k.endswith("attn.q_proj_weight")]:
        stem = k[:-len("q_proj_weight")]
        out[stem + "in_proj_weight"] = torch.cat([out.pop(f"{stem}{n}_proj_weight") for n in "qkv"])
    return out


def _torch(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _bit_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def params():
    return mini_params(seed=2)


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_released_checkpoint_matches_jax(params, fused):
    sd = released(params, fused)
    got = convert.convert_catseg_checkpoint(_torch(sd), num_layers=2)
    _bit_equal(got, state_dict_from_params(jconvert.convert_catseg_checkpoint(sd, num_layers=2)))
    assert not any(k.endswith("attn_mask") or "in_proj_weight" in k for k in got)
    # the numpy route gives the same tensors, and the result loads strictly
    _bit_equal(convert.convert_catseg_checkpoint(sd), got)
    model = CATSeg(mini_cfg_port())
    model.clip.visual.add_prompt_tokens(2, 3)
    model.load_state_dict(got, strict=True)


def test_layer_count_mismatch_raises(params):
    sd = released(params, fused=True)
    with pytest.raises(ValueError, match="checkpoint has 2 aggregator layers") as want:
        jconvert.convert_catseg_checkpoint(sd, num_layers=4)
    with pytest.raises(ValueError) as got:
        convert.convert_catseg_checkpoint(_torch(sd), num_layers=4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("key", ["sem_seg_head.predictor.transformer.fusion_corr.weight",
                                 "dino_model.blocks.0.norm1.weight", "sam_encoder.blocks.0.norm1.weight"])
def test_fusion_checkpoint_raises_naming_a8(params, key):
    """A fusion module's key in a plain checkpoint makes it a fusion
    checkpoint (converted since the fusion families were ported: bit-equal
    round trips in tests/test_torch_fusion.py); the fusion modules it lacks
    raise KeyError, as catseg_tpu's converter does."""
    sd = released(params, fused=False)
    sd[key] = np.zeros(4, np.float32)
    with pytest.raises(KeyError) as want:
        jconvert.convert_catseg_checkpoint(sd)
    with pytest.raises(KeyError) as got:
        convert.convert_catseg_checkpoint(_torch(sd))
    assert type(got.value) is type(want.value)


@pytest.fixture(scope="module")
def openclip_sd():
    sd = _mini_openclip_state_dict()
    sd["logit_bias"] = torch.tensor(-10.0)
    return sd


def test_openclip_conversion_matches_jax(openclip_sd):
    """Buffers dropped; the grid-2 positional embedding resized to grid 4 in
    float64 within 1 ulp of catseg_tpu's resize_pos_embed_grid; every other
    tensor bit-equal to catseg_tpu's conversion."""
    grid = OPENCLIP_VARIANT.pretrain_grid
    got = convert.convert_openclip_state_dict(openclip_sd, grid)
    want = _torch(export_clip_state_dict(jconvert.convert_openclip_state_dict(
        {k: t.numpy() for k, t in openclip_sd.items()}, target_grid=grid)))
    pe = "visual.positional_embedding"
    np.testing.assert_array_max_ulp(got[pe].numpy(), jconvert.resize_pos_embed_grid(
        openclip_sd[pe].numpy(), grid), maxulp=1)
    assert got[pe].shape == (grid * grid + 1, OPENCLIP_VARIANT.width)
    _bit_equal({k: v for k, v in got.items() if k != pe}, {k: v for k, v in want.items() if k != pe})
    assert "attn_mask" not in got and "logit_bias" not in got
    # a grid that already matches is left alone
    assert torch.equal(convert.convert_openclip_state_dict(openclip_sd, 2)[pe], openclip_sd[pe])


def _torchscript(sd: dict, path) -> None:
    """A TorchScript archive whose state_dict is ``sd``, as the OpenAI zoo's."""

    class Holder(torch.nn.Module):
        def forward(self):
            return torch.zeros(1)

    root = Holder()
    for k, t in sd.items():
        *parts, leaf = k.split(".")
        m = root
        for p in parts:
            if not hasattr(m, p):
                m.add_module(p, torch.nn.Module())
            m = getattr(m, p)
        m.register_buffer(leaf, t)
    torch.jit.save(torch.jit.trace(root, (), strict=False), str(path))


def test_torchscript_archive_loads(openclip_sd, tmp_path):
    _torchscript(openclip_sd, tmp_path / "clip.pt")
    flat = convert.load_torch_checkpoint(str(tmp_path / "clip.pt"))
    assert set(flat) == set(openclip_sd)
    assert all(torch.equal(flat[k], v) for k, v in openclip_sd.items())
    # the pickle route: weights_only=True reads plain state dicts, bare or wrapped
    torch.save({"model": openclip_sd, "iteration": 7}, tmp_path / "wrapped.pth")
    flat = convert.load_torch_checkpoint(str(tmp_path / "wrapped.pth"))
    assert set(flat) == set(openclip_sd)


def _openclip_cfg():
    v = tconfigs.CLIPVariant(**dataclasses.asdict(OPENCLIP_VARIANT))
    return mini_cfg_port(clip=v, guidance_proj_dim=v.width, text_guidance_dim=v.embed_dim,
                         appearance_guidance_dim=v.embed_dim)


@pytest.mark.parametrize("fmt", ["openclip.bin", "openai.pt", "released.pth"])
def test_load_params_formats(openclip_sd, params, tmp_path, fmt):
    """load_params as catseg_tpu's (tests/test_openclip.py:160-177): a bare
    CLIP gives the port's seeded init with the converted CLIP in place (the
    grid resized to cfg.clip.pretrain_grid); a released checkpoint loads whole."""
    path = str(tmp_path / fmt)
    if fmt == "released.pth":
        cfg = mini_cfg_port()
        sd = released(params, fused=True)
        torch.save({"model": _torch(sd)}, path)
        want = convert.convert_catseg_checkpoint(sd, num_layers=2)
        model = common.load_params(path, cfg, device="cpu")
        _bit_equal(model.state_dict(), want)
        assert not model.training
        return
    cfg = _openclip_cfg()
    if fmt == "openai.pt":
        _torchscript(openclip_sd, path)
    else:
        torch.save(openclip_sd, path)
    model = common.load_params(path, cfg, seed=3, device="cpu")
    got = model.state_dict()
    clip = convert.convert_openclip_state_dict(openclip_sd, cfg.clip.pretrain_grid)
    _bit_equal({k[len(convert.CLIP_PREFIX):]: v for k, v in got.items() if k.startswith(convert.CLIP_PREFIX)}, clip)
    seeded = build_catseg(cfg, seed=3, device="cpu").state_dict()
    rest = [k for k in got if not k.startswith(convert.CLIP_PREFIX)]
    assert rest and all(torch.equal(got[k], seeded[k]) for k in rest)


def _parity_cfg():
    """A CLIP and aggregator small enough for 150 classes over 4 images on
    the CPU: patch 16 at 128^2 (grid 8), hidden 32, window 4; the text tower
    keeps CLIP's vocabulary and context for the tokenizer."""
    v = tconfigs.CLIPVariant("mini-B/16", 16, 64, 2, 4, 48, 128, 48, 4, 2)
    return tconfigs.eval_preset(tconfigs.vitb384(
        clip=v, clip_resolution=128, guidance_layers=(0, 1), guidance_proj_dim=64, text_guidance_dim=48,
        text_guidance_proj_dim=16, appearance_guidance_dim=48, appearance_guidance_proj_dim=16,
        decoder_dims=(32, 16), decoder_guidance_proj_dims=(8, 4), hidden_dim=32, feature_resolution=(8, 8),
        window_size=4, compute_dtype="float32"))


@pytest.fixture
def mini_checkpoint(monkeypatch, tmp_path):
    """The parity config as a ``mini`` preset with a published-table row, and
    a released-format checkpoint of it (the port's seeded init, qkv fused)."""
    cfg = _parity_cfg()
    monkeypatch.setitem(common.PRESETS, "mini", lambda: cfg)
    monkeypatch.setitem(parity_check.PUBLISHED_MIOU, "mini", {"ade150": 31.8})
    path = str(tmp_path / "model.pth")
    torch.save({"model": fused(init_catseg_(CATSeg(cfg), 0).state_dict())}, path)
    return path


def test_parity_check_on_a_synthetic_checkpoint(mini_checkpoint, capsys):
    """tools.parity_check --limit 4 on the fixture set (4 ADE-150 images):
    the fused-qkv checkpoint loads, a DELTA line, no verdict, exit code 0.
    Two torch threads: 150 classes at 640^2 are large enough to split."""
    torch.set_num_threads(2)
    try:
        rc = parity_check.main(["--device", "cpu", "--config", "mini", "--checkpoint", mini_checkpoint,
                                "--benchmarks", "ade150", "--data-root", FIXTURES, "--limit", "4"])
    finally:
        torch.set_num_threads(1)
    out = capsys.readouterr().out
    assert rc == 0 and "DELTA" in out and "published  31.80" in out and "PARITY" not in out, out


@pytest.mark.parametrize("miou,rc", [(31.5, 0), (33.0, 1)])
def test_parity_check_verdict(mini_checkpoint, monkeypatch, capsys, miou, rc):
    """Without --limit a benchmark PASSes within --tol of the table and FAILs
    outside it, and a FAIL exits 1 (the harness stubbed to a reading)."""
    monkeypatch.setattr(parity_check, "evaluate_benchmark", lambda *a, **k: {"mIoU": miou})
    got = parity_check.main(["--device", "cpu", "--config", "mini", "--checkpoint", mini_checkpoint,
                             "--benchmarks", "ade150"])
    out = capsys.readouterr().out
    assert got == rc and ("PARITY FAIL: ade150" in out) == bool(rc) and ("PARITY PASS" in out) != bool(rc), out
