"""Flax parameter trees ↔ the port's models.

``load_flax_params`` copies a JAX ``RNNModel``'s params (as numpy arrays,
nested like the Flax tree or flat with ``/``-joined keys, as in an
``.npz``) into a port model; ``init_params`` draws fresh params with
Flax's initialisers for runs with no JAX at hand. Both walk the same map
from Flax paths to torch parameters:

* ``embed/{kernel,bias}``
* ``{cell}_{n}_xproj/{kernel,bias}`` (JAX ``_DenseParams``)
* ``{cell}_{n}/h_proj/kernel`` (JAX ``_GateKernel``)
* ``head/hidden_{i}/{kernel,bias}``, ``head/out/{kernel,bias}``

A seed-stacked model (``RNNModel(..., n_seeds=S)``) takes the tree of the
JAX ensemble's ``jax.vmap(init)``: the same paths, every leaf with a
leading seed axis of S.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence, Union

import numpy as np
import torch
from torch import nn

from lfm_quant_tpu_torch.models.rnn import RNNModel


def flatten_params(tree: Mapping[str, Any], prefix: str = ""
                   ) -> Dict[str, np.ndarray]:
    """Nested param dict → ``{"a/b/c": array}`` (flat input passes
    through)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_params(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def flax_param_map(model: RNNModel) -> Dict[str, nn.Parameter]:
    """Flax path → the port model's parameter, in a fixed order."""
    out: Dict[str, nn.Parameter] = {
        "embed/kernel": model.embed.kernel,
        "embed/bias": model.embed.bias,
    }
    for n in range(model.layers):
        out[f"{model.cell}_{n}_xproj/kernel"] = model.xproj[n].kernel
        out[f"{model.cell}_{n}_xproj/bias"] = model.xproj[n].bias
        out[f"{model.cell}_{n}/h_proj/kernel"] = model.h_proj[n]
    for i, layer in enumerate(model.head.hidden):
        out[f"head/hidden_{i}/kernel"] = layer.kernel
        out[f"head/hidden_{i}/bias"] = layer.bias
    out["head/out/kernel"] = model.head.out.kernel
    out["head/out/bias"] = model.head.out.bias
    return out


def load_flax_params(model: RNNModel, params: Mapping[str, Any]) -> None:
    """Copy a Flax param tree into ``model`` (in place). The tree must
    match the model exactly: a missing, extra or misshapen entry raises."""
    flat = flatten_params(params)
    if "params" in {k.split("/")[0] for k in flat}:
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    target = flax_param_map(model)
    missing = sorted(set(target) - set(flat))
    extra = sorted(set(flat) - set(target))
    if missing or extra:
        raise ValueError(
            f"param tree does not match the model: missing {missing}, "
            f"unexpected {extra}")
    with torch.no_grad():
        for key, p in target.items():
            src = flat[key]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(
                    f"{key}: shape {tuple(src.shape)}, model wants "
                    f"{tuple(p.shape)}")
            p.copy_(torch.tensor(np.asarray(src), dtype=torch.float32))


def init_params(model: RNNModel,
                generator: Union[torch.Generator, Sequence[torch.Generator]]
                ) -> None:
    """Fresh params with Flax ``nn.Dense``'s initialisers: kernels
    ``lecun_normal`` (a normal truncated at two standard deviations,
    scaled to variance 1/fan_in), biases zero. Deterministic in the
    generator's seed; the numbers differ from ``jax.random``'s.

    A seed-stacked model takes one generator per seed: member s is drawn
    from ``generator[s]`` alone, exactly as a one-seed model would be, so
    members differ."""
    params = flax_param_map(model)
    if isinstance(generator, torch.Generator):
        _init_member(params, generator)
        return
    for s, gen in enumerate(generator):
        _init_member({k: p[s] for k, p in params.items()}, gen)


def _init_member(params: Mapping[str, torch.Tensor],
                 generator: torch.Generator) -> None:
    with torch.no_grad():
        for key, p in params.items():
            if key.endswith("kernel"):
                nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                # Flax divides by the truncated normal's own std so the
                # variance is exactly 1/fan_in.
                p.mul_(math.sqrt(1.0 / p.shape[0]) / .87962566103423978)
            else:
                p.zero_()
