"""Flax parameter trees ↔ the port's models.

``load_flax_params`` copies a JAX model's params (as numpy arrays, nested
like the Flax tree or flat with ``/``-joined keys, as in an ``.npz``) into
the port's model of the same kind; ``init_params`` draws fresh params
with each path's Flax initialiser for runs with no JAX at hand. Both walk
the same map from Flax paths to torch parameters (:func:`flax_param_map`):

* every kind: ``head/hidden_{i}/{kernel,bias}``, ``head/out/{kernel,bias}``
* MLP: ``dense_{i}/{kernel,bias}``
* LSTM/GRU: ``embed/{kernel,bias}``, ``{cell}_{n}_xproj/{kernel,bias}``
  (JAX ``_DenseParams``), ``{cell}_{n}/h_proj/kernel`` (JAX
  ``_GateKernel``); factored (the XLA scan's ``_proj`` trees):
  ``{cell}_{n}_xproj/u/kernel``, ``.../v/{kernel,bias}`` and
  ``{cell}_{n}/h_proj/u/kernel``, ``.../v/kernel`` (low-rank), or the
  grouped ``kernel [g, in/g, out/g]`` and ``bias [g, out/g]`` at the
  dense paths
* transformer: ``embed``, ``pos_emb``, ``block_{i}/{ln1,ln2}/{scale,bias}``,
  ``block_{i}/attn/{query,key,value,out}/{kernel,bias}``,
  ``block_{i}/{mlp_in,mlp_out}/{kernel,bias}``, ``ln_f/{scale,bias}``
* LRU: ``embed``, ``norm_{i}/{scale,bias}``, ``lru_{i}/{nu_log,theta_log,
  d_skip}``, ``lru_{i}/b/kernel``, ``lru_{i}/c/{kernel,bias}``

A seed-stacked model (``n_seeds=S``) takes the tree of the JAX
ensemble's ``jax.vmap(init)``: the same paths, every leaf with a leading
seed axis of S. A window-sharded model (``seq_axis``) has the plain
model's tree. The stacked runs' member tree (``train/stacked.py``: R runs
of S seeds as R·S members) takes a JAX run-stacked state's params
through :func:`member_params`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence, Union

import numpy as np
import torch
from torch import nn

from lfm_quant_tpu_torch.models import (
    LRUModel,
    MLPModel,
    RNNModel,
    TransformerModel,
)
from lfm_quant_tpu_torch.models.lru import LRULayer
from lfm_quant_tpu_torch.models.rnn import LowRankDense


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


def member_params(tree: Mapping[str, Any], n_runs: int, n_seeds: int = 1
                  ) -> Dict[str, np.ndarray]:
    """A run-stacked Flax tree → the stacked runs' member tree: leaves
    ``[R, ...]`` (the JAX ``Trainer.init_stacked_states``) or ``[R, S,
    ...]`` (``EnsembleTrainer.init_stacked_states``) become ``[R·S, ...]``,
    run r's seed s at member ``r·S + s``. A leaf without that lead
    raises."""
    out = {}
    lead = (n_runs,) if n_seeds == 1 else (n_runs, n_seeds)
    for k, v in flatten_params(tree).items():
        if tuple(v.shape[:len(lead)]) != lead:
            raise ValueError(f"{k}: shape {tuple(v.shape)} does not lead "
                             f"with the runs x seeds {lead}")
        out[k] = v.reshape((n_runs * n_seeds,) + v.shape[len(lead):])
    return out


def _dense(out: Dict[str, nn.Parameter], path: str, layer) -> None:
    out[f"{path}/kernel"] = layer.kernel
    if getattr(layer, "bias", None) is not None:
        out[f"{path}/bias"] = layer.bias


def _proj(out: Dict[str, nn.Parameter], path: str, layer) -> None:
    """A recurrence's projection: dense, low-rank or grouped."""
    if isinstance(layer, LowRankDense):
        _dense(out, f"{path}/u", layer.u)
        _dense(out, f"{path}/v", layer.v)
    elif isinstance(layer, nn.Module):
        _dense(out, path, layer)
    else:  # the dense model's recurrent kernel, a bare parameter
        out[f"{path}/kernel"] = layer


def _norm(out: Dict[str, nn.Parameter], path: str, layer) -> None:
    out[f"{path}/scale"] = layer.scale
    out[f"{path}/bias"] = layer.bias


def flax_param_map(model: nn.Module) -> Dict[str, nn.Parameter]:
    """Flax path → the port model's parameter, in a fixed order."""
    out: Dict[str, nn.Parameter] = {}
    if isinstance(model, MLPModel):
        for i, layer in enumerate(model.dense):
            _dense(out, f"dense_{i}", layer)
    elif isinstance(model, RNNModel):
        _dense(out, "embed", model.embed)
        for n in range(model.layers):
            _proj(out, f"{model.cell}_{n}_xproj", model.xproj[n])
            _proj(out, f"{model.cell}_{n}/h_proj", model.h_proj[n])
    elif isinstance(model, TransformerModel):
        _dense(out, "embed", model.embed)
        out["pos_emb"] = model.pos_emb
        for i, blk in enumerate(model.blocks):
            p = f"block_{i}"
            _norm(out, f"{p}/ln1", blk.ln1)
            for name in ("query", "key", "value", "out"):
                _dense(out, f"{p}/attn/{name}", getattr(blk.attn, name))
            _norm(out, f"{p}/ln2", blk.ln2)
            _dense(out, f"{p}/mlp_in", blk.mlp_in)
            _dense(out, f"{p}/mlp_out", blk.mlp_out)
        _norm(out, "ln_f", model.ln_f)
    elif isinstance(model, LRUModel):
        _dense(out, "embed", model.embed)
        for i, (norm, lru) in enumerate(zip(model.norm, model.lru)):
            _norm(out, f"norm_{i}", norm)
            out[f"lru_{i}/nu_log"] = lru.nu_log
            out[f"lru_{i}/theta_log"] = lru.theta_log
            _dense(out, f"lru_{i}/b", lru.b)
            _dense(out, f"lru_{i}/c", lru.c)
            out[f"lru_{i}/d_skip"] = lru.d_skip
    else:
        raise TypeError(f"not a model of the port: {type(model).__name__}")
    for i, layer in enumerate(model.head.hidden):
        _dense(out, f"head/hidden_{i}", layer)
    _dense(out, "head/out", model.head.out)
    return out


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> None:
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


def init_params(model: nn.Module,
                generator: Union[torch.Generator, Sequence[torch.Generator]]
                ) -> None:
    """Fresh params with each path's Flax initialiser (:func:`_initialise`).
    Deterministic in the generator's seed; the numbers differ from
    ``jax.random``'s.

    A seed-stacked model takes one generator per seed: member s is drawn
    from ``generator[s]`` alone, exactly as a one-seed model would be, so
    members differ."""
    params = flax_param_map(model)
    if isinstance(generator, torch.Generator):
        _init_member(params, generator)
        return
    for s, gen in enumerate(generator):
        _init_member({k: p[s] for k, p in params.items()}, gen)


def _lecun_normal(p: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """Flax's ``lecun_normal``: a normal truncated at two standard
    deviations, divided by the truncated normal's own std (so the
    variance is exactly ``1/fan_in``)."""
    nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator)
    p.mul_(math.sqrt(1.0 / fan_in) / .87962566103423978)


def _uniform(p: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(p.shape, generator=generator, dtype=p.dtype)


def _initialise(key: str, p: torch.Tensor,
                generator: torch.Generator) -> None:
    """One member's param by its Flax path: kernels ``lecun_normal`` with
    Flax's fan-in (``attn/out``: heads × head_dim, the contracted axes; a
    grouped kernel ``[g, in/g, out/g]``: g × in/g, its receptive field
    times its input axis; every other kernel its first axis), ``pos_emb``
    ``normal(0.02)``,
    LayerNorm ``scale`` and ``d_skip`` ones, the LRU's ``nu_log`` and
    ``theta_log`` the uniform transforms of ``models/lru.py`` (|λ|² uniform
    in ``[R_MIN², R_MAX²]``, the phase in ``[0, MAX_PHASE)``), every other
    leaf (the biases) zero."""
    leaf = key.rsplit("/", 1)[-1]
    if leaf == "kernel":
        grouped = p.dim() == 3 and "attn/" not in key
        fan_in = (p.shape[0] * p.shape[1]
                  if grouped or key.endswith("attn/out/kernel")
                  else p.shape[0])
        _lecun_normal(p, fan_in, generator)
    elif leaf == "pos_emb":
        p.normal_(0.0, 0.02, generator=generator)
    elif leaf in ("scale", "d_skip"):
        p.fill_(1.0)
    elif leaf == "nu_log":
        lo, hi = LRULayer.R_MIN ** 2, LRULayer.R_MAX ** 2
        mag2 = lo + _uniform(p, generator) * (hi - lo)
        p.copy_(torch.log(-0.5 * torch.log(mag2)))
    elif leaf == "theta_log":
        p.copy_(torch.log(LRULayer.MAX_PHASE * _uniform(p, generator)
                          + 1e-4))
    else:
        p.zero_()


def _init_member(params: Mapping[str, torch.Tensor],
                 generator: torch.Generator) -> None:
    with torch.no_grad():
        for key, p in params.items():
            _initialise(key, p, generator)
