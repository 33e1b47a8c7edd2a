"""Carry state from the JAX package into this one, as numpy arrays.

Nothing here imports the JAX package: its state reaches this module as
numpy arrays (``DNDarray.numpy()`` there, a fitted estimator's attributes,
a flax variable tree passed through ``jax.tree.map(np.asarray, variables)``).

Flax layouts and their torch counterparts: a ``Dense`` kernel is
``(in, out)``, torch's weight its transpose; a ``DenseGeneral`` query, key
or value kernel is ``(D, H, D_head)`` and the out kernel ``(H, D_head, D)``,
flattened to ``(D, H * D_head)`` and ``(H * D_head, D)`` and transposed;
LayerNorm ``scale``/``bias`` and the ``embed``/``pos`` ``embedding`` tables
carry as they are. A ``MoEMLP``'s ``w_in``/``w_out`` ``(E, in, out)`` carry as
they are, this rank's experts only. A plain parameter pytree (a dict of
numpy arrays, as the JAX package's DataParallel and DASO train) carries by
name into a module whose parameters have those names and shapes; DASO's
stacked pytree (a leading replica axis) carries one replica. A ``Dense``
carries into a ``torch.nn.Linear`` (kernel transposed, bias as it is).

The scale-out layouts carry in their logical forms:
:func:`transformer_block_from_flax` (a flax ``TransformerBlock``'s
variables), :func:`pipeline_params_from_flax` (the JAX ``Pipeline``'s
per-layer params list into :class:`heat_tpu_torch.nn.Pipeline`'s) and
:func:`fsdp_params_from_flax` (the JAX ``FSDP``'s logical per-stage params,
``FsdpPlan``'s unsharded form, into :class:`heat_tpu_torch.nn.FSDP`'s
stages). :func:`to_flax_params` is the way back (numpy in the flax
layout), so each conversion round-trips.
"""

from __future__ import annotations

import copy
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .cluster.kmeans import KMeans
from .core import factories
from .core.dndarray import DNDarray
from .nn import (LayerNorm, MoEMLP, MultiHeadAttention, QuantDense, TransformerBlock,
                 TransformerLM)

__all__ = [
    "KMeans",
    "array_from_numpy",
    "fsdp_params_from_flax",
    "load_flax_params",
    "load_params",
    "moe_mlp_from_flax",
    "pipeline_params_from_flax",
    "quant_dense_from_flax",
    "to_flax_params",
    "transformer_block_from_flax",
    "transformer_lm_from_flax",
]


def array_from_numpy(global_np: np.ndarray, split: Optional[int] = None, dtype=None,
                     device=None, comm=None) -> DNDarray:
    """A DNDarray holding ``global_np`` (the whole global array, the same on
    every rank), distributed along ``split``; numpy's dtype is kept unless
    ``dtype`` is given."""
    return factories.array(np.asarray(global_np), dtype=dtype, split=split, device=device,
                           comm=comm)


def _set(param: torch.nn.Parameter, value) -> None:
    value = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"flax value of shape {tuple(value.shape)} does not fit "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def _dense(param, kernel) -> None:
    """A flax kernel with input axes first and output axes last, flattened
    to (in, out) by the parameter's shape, into torch's (out, in)."""
    kernel = np.asarray(kernel)
    _set(param, kernel.reshape(param.shape[1], param.shape[0]).T)


def _load(module: torch.nn.Module, p: Mapping) -> None:
    if isinstance(module, LayerNorm):
        _set(module.scale, p["scale"])
        _set(module.bias, p["bias"])
    elif isinstance(module, MultiHeadAttention):
        for name in ("query", "key", "value", "out"):
            _dense(getattr(module, name), p[name]["kernel"])
    elif isinstance(module, TransformerBlock):
        for name in ("ln1", "attn", "ln2"):
            _load(getattr(module, name), p[name])
        for name in ("gate", "up", "down"):
            _dense(getattr(module, name), p[name]["kernel"])
    elif isinstance(module, TransformerLM):
        _set(module.embed, p["embed"]["embedding"])
        _set(module.pos, p["pos"]["embedding"])
        for i, block in enumerate(module.blocks):
            _load(block, p[f"block{i}"])
        _load(module.ln_f, p["ln_f"])
        _dense(module.lm_head, p["lm_head"]["kernel"])
    elif isinstance(module, MoEMLP):
        _dense(module.gate, p["gate"]["kernel"])
        lo, hi = module.expert_range()
        _set(module.w_in, np.asarray(p["w_in"])[lo:hi])
        _set(module.w_out, np.asarray(p["w_out"])[lo:hi])
    elif isinstance(module, QuantDense):
        _dense(module.weight, p["kernel"])
        if module.bias is not None:
            _set(module.bias, p["bias"])
    elif isinstance(module, torch.nn.Linear):
        _dense(module.weight, p["kernel"])
        if module.bias is not None:
            _set(module.bias, p["bias"])
    else:
        raise TypeError(f"no flax layout known for {type(module).__name__}")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def to_flax_params(module: torch.nn.Module) -> dict:
    """``module``'s parameters in the flax layout (nested dicts of numpy
    arrays, without the top-level ``"params"``): the inverse of
    :func:`load_flax_params` for a :class:`TransformerLM`,
    :class:`TransformerBlock`, :class:`MultiHeadAttention`,
    :class:`LayerNorm` or ``torch.nn.Linear``."""
    if isinstance(module, LayerNorm):
        return {"scale": _host(module.scale), "bias": _host(module.bias)}
    if isinstance(module, MultiHeadAttention):
        d, h, dh = module.query.shape[1], module.num_heads, module.d_head
        out = {name: {"kernel": _host(getattr(module, name)).T.reshape(d, h, dh)}
               for name in ("query", "key", "value")}
        out["out"] = {"kernel": _host(module.out).T.reshape(h, dh, d)}
        return out
    if isinstance(module, TransformerBlock):
        out = {name: to_flax_params(getattr(module, name)) for name in ("ln1", "attn", "ln2")}
        out.update({name: {"kernel": _host(getattr(module, name)).T}
                    for name in ("gate", "up", "down")})
        return out
    if isinstance(module, TransformerLM):
        out = {"embed": {"embedding": _host(module.embed)}, "pos": {"embedding": _host(module.pos)},
               "ln_f": to_flax_params(module.ln_f),
               "lm_head": {"kernel": _host(module.lm_head).T}}
        out.update({f"block{i}": to_flax_params(b) for i, b in enumerate(module.blocks)})
        return out
    if isinstance(module, torch.nn.Linear):
        out = {"kernel": _host(module.weight).T}
        if module.bias is not None:
            out["bias"] = _host(module.bias)
        return out
    raise TypeError(f"no flax layout known for {type(module).__name__}")


def transformer_block_from_flax(variables: Mapping, **config) -> TransformerBlock:
    """A :class:`TransformerBlock` built from ``config`` (the flax module's
    arguments, plus ``d_model`` and ``device``) holding the flax block's
    weights."""
    return load_flax_params(TransformerBlock(**config), variables)


def _logical(module: torch.nn.Module) -> dict:
    return {name: p.detach().clone() for name, p in module.named_parameters()}


def pipeline_params_from_flax(layer_params: Sequence[Mapping],
                              layer: Union[torch.nn.Module, None] = None) -> List[dict]:
    """The JAX ``Pipeline``'s per-layer params list as
    :class:`heat_tpu_torch.nn.Pipeline`'s logical list (name -> tensor a
    layer). With ``layer`` (the port's template module, a flax layout
    known to :func:`load_flax_params`) each layer's flax variables are
    loaded into a copy of it; without, each layer is a plain dict of arrays
    whose names are the port layer's parameter names (the JAX package's
    callable layers)."""
    out = []
    for variables in layer_params:
        if layer is None:
            out.append({name: torch.from_numpy(np.array(value, dtype=np.float32))
                        for name, value in variables.items()})
        else:
            out.append(_logical(load_flax_params(copy.deepcopy(layer), variables)))
    return out


def fsdp_params_from_flax(stage_params: Sequence[Mapping],
                          stages: Sequence[torch.nn.Module]) -> List[dict]:
    """The JAX ``FSDP``'s logical per-stage params (a flax variable tree a
    stage: the unsharded form of its ``FsdpPlan``) loaded into the port's
    stage modules; returns :class:`heat_tpu_torch.nn.FSDP`'s logical list
    (name -> tensor a stage)."""
    return [_logical(load_flax_params(stage, variables))
            for stage, variables in zip(stages, stage_params)]


def load_flax_params(module: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Copy a flax variable tree (nested dicts of numpy arrays, with or
    without the top-level ``"params"``) into ``module`` (a
    :class:`TransformerLM`, :class:`TransformerBlock`,
    :class:`MultiHeadAttention`, :class:`LayerNorm`, :class:`MoEMLP` or
    :class:`QuantDense`); returns the module."""
    _load(module, variables.get("params", variables))
    return module


def transformer_lm_from_flax(variables: Mapping, **config) -> TransformerLM:
    """A :class:`TransformerLM` built from ``config`` (the flax module's
    arguments, plus ``device``) holding the flax model's weights."""
    return load_flax_params(TransformerLM(**config), variables)


def quant_dense_from_flax(variables: Mapping, features: int, **config) -> QuantDense:
    """A :class:`QuantDense` holding the flax module's kernel (and bias);
    ``in_features`` is read from the kernel."""
    p = variables.get("params", variables)
    in_features = np.asarray(p["kernel"]).shape[0]
    return load_flax_params(QuantDense(features, in_features=in_features, **config), variables)


def moe_mlp_from_flax(variables: Mapping, **config) -> MoEMLP:
    """A :class:`MoEMLP` built from ``config`` (the flax module's arguments,
    plus ``comm`` and ``device``) holding the flax layer's weights, this
    rank's experts of them; ``d_model`` is read from the gate kernel."""
    p = variables.get("params", variables)
    d_model = np.asarray(p["gate"]["kernel"]).shape[0]
    return load_flax_params(MoEMLP(d_model=d_model, **config), variables)


def load_params(module: torch.nn.Module, params: Mapping,
                replica: Optional[int] = None) -> torch.nn.Module:
    """Copy a plain parameter pytree (parameter name -> numpy array, the
    layout of ``module``'s parameters) into ``module``; with ``replica``,
    ``params`` is DASO's stacked form and that replica's slice is taken.
    Returns the module."""
    for name, param in module.named_parameters():
        value = np.asarray(params[name])
        _set(param, value[replica] if replica is not None else value)
    return module
