"""Pytree checkpoint persistence, npz with no pickle (catseg_tpu/weights/io.py).

A flat key -> array npz plus a small JSON manifest of the tree's shape: the
JAX package's ``model_final.npz`` files load here (numpy only) and go into
the port through ``weights.from_jax.load_params_``.
"""

from __future__ import annotations

import json

import numpy as np


def _flatten(tree, prefix="", out=None):
    if out is None:
        out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    elif tree is None:
        out[prefix[:-1] + "#none"] = np.zeros(0)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _spec(tree):
    if isinstance(tree, dict):
        return {k: _spec(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_spec(v) for v in tree]
    if tree is None:
        return None
    return "*"


def save_pytree(path: str, tree) -> None:
    flat = _flatten(tree)
    np.savez(path, __spec__=json.dumps(_spec(tree)), **flat)


def _rebuild(spec, flat, prefix=""):
    if isinstance(spec, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in spec.items()}
    if isinstance(spec, list):
        return [_rebuild(v, flat, f"{prefix}{i}/") for i, v in enumerate(spec)]
    if spec is None:
        return None
    return flat[prefix[:-1]]


def load_pytree(path: str):
    with np.load(path, allow_pickle=False) as zf:
        spec = json.loads(str(zf["__spec__"]))
        flat = {k: zf[k] for k in zf.files if k != "__spec__"}
    return _rebuild(spec, flat)
