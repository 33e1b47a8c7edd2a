"""Pipeline-parallel training (counterpart of ``heat_tpu/nn/pipeline.py``).

:class:`Pipeline` wraps :func:`heat_tpu_torch.parallel.pipeline.pipeline_step_program`
into the plan -> shard -> train-step -> checkpoint workflow of the other
``nn`` wrappers. It holds one homogeneous layer applied ``n_layers`` times:
the layers split into ``S`` stages mapped onto groups of ranks
(:func:`heat_tpu_torch.parallel.schedule.plan_stages`), each stage's weights
live flat-sharded ``1/local`` across its group, microbatch activations hop
stage to stage, and every rank walks the same schedule table.

``layer`` is an ``nn.Module`` (the template whose forward every layer
runs, through ``torch.func.functional_call``; :meth:`Pipeline.init` gives
every layer a copy of its parameters) or a callable ``j -> nn.Module`` (a
factory: layer ``j``'s parameters are those of ``layer(j)``, the template
``layer(0)``). The layers must be homogeneous, as in the JAX package.

Elastic checkpoints: the logical form (per-layer unpadded parameters, the
optimizer's state rows stacked per layer and unpadded, the step cursor), so
a run killed on one ``node x local`` factorization resumes bit for bit on
another with any stage count that divides the layer count: compute inside
a stage is replicated, so the sharding changes where chunks live and not
what a microbatch computes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .. import _knobs as knobs
from ..core import topology as _topo
from ..core.communication import sanitize_comm
from ..parallel import pipeline as _pl
from ..parallel import schedule as _sched

__all__ = ["Pipeline"]


class Pipeline:
    """Pipeline-parallel training of ``n_layers`` homogeneous layers.

    Parameters
    ----------
    layer : nn.Module or callable
        The layer (module docstring); shape-preserving.
    n_layers : int
        The layer count; divisible by the stage count.
    comm, optimizer, loss_fn
        The world, the optimizer (a ``torch.optim.Optimizer``, its class and
        defaults, or a callable ``params -> Optimizer``) and ``loss_fn(out,
        y) -> scalar`` (both needed by :meth:`make_train_step`).
    n_stages : int, optional
        Default ``HEAT_TPU_PIPELINE_STAGES`` (0: the node count of an active
        topology, else one stage a rank).
    n_microbatches : int, optional
        Default ``HEAT_TPU_PIPELINE_MICROBATCHES`` (0: the stage count).
    schedule : str, optional
        ``gpipe`` or ``1f1b`` (default ``HEAT_TPU_PIPELINE_SCHEDULE``); the
        same results bit for bit.
    prefetch : int, optional
        In-stage gather prefetch depth (default ``HEAT_TPU_FSDP_PREFETCH``).
    precision : str, optional
        In-stage gather wire (default the ``fsdp_wire`` chain; modes beyond
        bf16 coerce to bf16).
    remat : bool
        Also checkpoint each layer inside the backward tick (default False).
        The tick already recomputes its stage from the stashed input
        activation, so the stash holds inputs only either way; the layer
        checkpoint costs a third forward a layer and keeps only one layer's
        activations of one microbatch, for a stage whose activations would
        not fit. The JAX package defaults to True (its ``jax.checkpoint``).

    The knobs are resolved at construction.
    """

    def __init__(self, layer, n_layers: int, comm=None, optimizer=None,
                 loss_fn: Optional[Callable] = None, *, n_stages: Optional[int] = None,
                 n_microbatches: Optional[int] = None, schedule: Optional[str] = None,
                 prefetch: Optional[int] = None, precision: Optional[str] = None,
                 remat: bool = False):
        if isinstance(layer, nn.Module):
            self._factory, self.template = None, layer
        elif callable(layer):
            self._factory, self.template = layer, layer(0)
        else:
            raise TypeError(f"layer must be an nn.Module or a factory, got {layer!r}")
        self.layer = layer
        template = self.template
        self.layer_apply = lambda w, h: functional_call(template, w, (h,))
        self.n_layers = int(n_layers)
        self.comm = sanitize_comm(comm)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.mapping = _sched.plan_stages(self.comm.size, n_stages)
        if self.n_layers % self.mapping.n_stages:
            raise ValueError(f"{self.n_layers} layers do not divide into "
                             f"{self.mapping.n_stages} stages")
        m = n_microbatches if n_microbatches is not None else int(
            knobs.get("HEAT_TPU_PIPELINE_MICROBATCHES"))
        self.n_microbatches = int(m) if int(m) > 0 else self.mapping.n_stages
        self.schedule = _sched.resolve_schedule_name(schedule)
        self.prefetch = int(prefetch if prefetch is not None
                            else knobs.get("HEAT_TPU_FSDP_PREFETCH"))
        if self.prefetch < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {self.prefetch}")
        self.precision = _topo.fsdp_wire(torch.float32, self.comm.size, precision, self.comm)
        self.remat = bool(remat)
        self._layout: Optional[_pl.PipelineLayout] = None

    # -- initialization and layout ----------------------------------------------------

    def init(self, *_) -> List[Dict[str, torch.Tensor]]:
        """The logical per-layer parameters: layer ``j``'s of the factory's
        ``layer(j)``, or copies of the template's."""
        if self._factory is not None:
            layers = [self.template if j == 0 else self._factory(j) for j in range(self.n_layers)]
            return [{n: p.detach().clone() for n, p in layer.named_parameters()}
                    for layer in layers]
        return [{n: p.detach().clone() for n, p in self.template.named_parameters()}
                for _ in range(self.n_layers)]

    def plan(self, layer_params: Sequence[Any]) -> _pl.PipelineLayout:
        """Resolve (and pin) the layout."""
        self._layout = _pl.plan_pipeline(layer_params, self.mapping, wire=self.precision)
        return self._layout

    def _ensure_layout(self, layer_params) -> _pl.PipelineLayout:
        return self._layout if self._layout is not None else self.plan(layer_params)

    @property
    def layout(self) -> _pl.PipelineLayout:
        if self._layout is None:
            raise ValueError("no layout pinned: call plan/shard_params first")
        return self._layout

    def shard_params(self, layer_params: Sequence[Any]) -> Dict[str, torch.Tensor]:
        """Logical per-layer list -> this rank's persistent rows (leaf
        tensors that the optimizer steps)."""
        rows = _pl.shard_pipeline_params(layer_params, self._ensure_layout(layer_params),
                                         self.comm)
        return {name: t.requires_grad_(t.is_floating_point()) for name, t in rows.items()}

    def unshard_params(self, params) -> List[Dict[str, np.ndarray]]:
        """Persistent rows -> the logical per-layer numpy list (a
        collective)."""
        return _pl.unshard_pipeline_params(params, self.layout, self.comm)

    def param_bytes_per_device(self) -> int:
        """This rank's persistent parameter bytes: ``1/p`` of the layers."""
        return self.layout.bytes_per_device()

    def init_opt_state(self, params, optimizer=None) -> torch.optim.Optimizer:
        """The optimizer over this rank's rows (ZeRO's sharded state)."""
        from ..optim.zero_optimizer import optimizer_factory

        optimizer = optimizer if optimizer is not None else self.optimizer
        if optimizer is None:
            raise ValueError("no optimizer bound; pass one at construction")
        return optimizer_factory(optimizer)([params[name] for name in self.layout.names])

    # -- the steps ---------------------------------------------------------------------

    def _table(self, train: bool) -> _sched.ScheduleTable:
        return _sched.build_schedule(self.mapping.n_stages, self.n_microbatches, self.schedule,
                                     train=train)

    def _micro(self, arr):
        m = self.n_microbatches
        b = arr.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible into {m} microbatches")
        return arr.reshape((m, b // m) + tuple(arr.shape[1:]))

    def make_train_step(self) -> Callable:
        """``step(params, opt_state, x, y) -> (params, opt_state, loss)``
        (``x``, ``y`` the whole batch, the same on every rank)."""
        if self.optimizer is None or self.loss_fn is None:
            raise ValueError("make_train_step needs optimizer and loss_fn bound at construction")
        prog = _pl.pipeline_step_program(self.layer_apply, self.layout, self.mapping,
                                         self._table(train=True), comm=self.comm,
                                         loss_fn=self.loss_fn, prefetch=self.prefetch,
                                         remat=self.remat)

        def step(params, opt_state, x, y):
            return prog(params, opt_state, self._micro(x), self._micro(y))

        return step

    def __call__(self, params, x):
        """The pipelined forward of all ``n_layers`` layers."""
        prog = _pl.pipeline_step_program(self.layer_apply, self.layout, self.mapping,
                                         self._table(train=False), comm=self.comm,
                                         prefetch=self.prefetch, remat=self.remat)
        out = prog(params, self._micro(x))
        return out.reshape((x.shape[0],) + tuple(out.shape[2:]))

    # -- the elastic checkpoint -----------------------------------------------------------

    def _logical_state(self, opt_state) -> Dict[str, Any]:
        layout = self.layout
        out: Dict[str, Any] = {}
        state = opt_state.state_dict()["state"]
        for i in sorted(state):
            k = i  # the optimizer holds the rows in layout.names order
            for key in sorted(state[i]):
                value = state[i][key]
                if isinstance(value, torch.Tensor) and tuple(value.shape) == (
                        layout.layers_per_stage, layout.chunk(k)):
                    value = _pl.unshard_state_rows(_pl._all_rows(value, self.comm), layout,
                                                   layout.numel(k), layout.shapes[k])
                elif isinstance(value, torch.Tensor):
                    from ..parallel.fsdp import _host

                    value = _host(value)
                out[f"{i:05d}/{key}"] = value
        return out

    def save_checkpoint(self, path: str, params, opt_state, step: int = 0) -> str:
        """Checkpoint the logical form and the step cursor ``step``: nothing
        of this world's factorization, stage count or schedule. Every rank
        calls it."""
        from .. import resilience

        logical_p = self.unshard_params(params)
        logical_s = self._logical_state(opt_state)
        tree = {"params": {f"{j:05d}/{name}": v for j, layer in enumerate(logical_p)
                           for name, v in layer.items()},
                "opt_state": logical_s}
        return resilience.save_checkpoint(
            tree, path, comm=self.comm,
            extra={"algo": "pipeline", "step": int(step), "schedule": self.schedule,
                   "n_microbatches": int(self.n_microbatches), "n_layers": int(self.n_layers),
                   "param_keys": sorted(tree["params"]), "opt_keys": sorted(logical_s)})

    def resume(self, path: str, params_template: Sequence[Any]):
        """Restore onto this world and mapping (possibly another
        factorization or stage count than the writer's), bit for bit.
        ``params_template`` gives the logical shapes (e.g. :meth:`init`'s).
        Returns ``(params, opt_state, step)``."""
        from .. import resilience

        extra = resilience.checkpoint.load_manifest(path).get("extra", {})
        if extra.get("algo") != "pipeline":
            raise resilience.CheckpointError(
                f"{path!r} is a {extra.get('algo')!r} checkpoint, not pipeline")
        if int(extra.get("n_layers", self.n_layers)) != self.n_layers:
            raise resilience.CheckpointError(
                f"checkpoint has {extra.get('n_layers')} layers, this Pipeline has "
                f"{self.n_layers}")
        layout = self._ensure_layout(params_template)
        like = {"params": {key: 0 for key in extra["param_keys"]},
                "opt_state": {key: 0 for key in extra["opt_keys"]}}
        tree = resilience.load_checkpoint(path, like=like, comm=self.comm)
        template = [dict(layer) for layer in params_template]
        layers = [{name: torch.as_tensor(np.asarray(tree["params"][f"{j:05d}/{name}"])).to(
                   torch.as_tensor(template[j][name]).device)
                   for name in layout.names} for j in range(self.n_layers)]
        params = self.shard_params(layers)
        opt_state = self.init_opt_state(params)
        leaves = [params[name] for name in layout.names]
        state: Dict[int, Dict[str, Any]] = {}
        for key, value in tree["opt_state"].items():
            i, k = key.split("/", 1)
            i = int(i)
            t = torch.as_tensor(np.asarray(value))
            if t.dim() == 0:
                value = t.clone()
            elif tuple(t.shape) == (self.n_layers,) + tuple(layout.shapes[i]):
                value = _pl.shard_state_rows(t, layout, self.comm).to(leaves[i].device,
                                                                      leaves[i].dtype)
            else:
                value = t.to(leaves[i].device)
            state.setdefault(i, {})[k] = value
        opt_state.load_state_dict({"state": state,
                                   "param_groups": opt_state.state_dict()["param_groups"]})
        return params, opt_state, int(extra.get("step", 0))
