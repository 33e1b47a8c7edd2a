"""Fully sharded data parallelism (counterpart of ``heat_tpu/nn/fsdp.py``):
the :class:`DataParallel` twin whose parameters live as flat ``1/p`` shards.

The parameters persist in :func:`heat_tpu_torch.parallel.fsdp.fsdp_shard`'s
layout (each rank its flat ``(chunk,)`` row of every sharded leaf) and each
stage's weights are all-gathered just in time
(:func:`~heat_tpu_torch.parallel.fsdp.fsdp_gather`: tiered under
``HEAT_TPU_HIERARCHICAL=1``, at each partition rule's wire), used through
``torch.func.functional_call`` on the stage's module, and dropped. Layouts
come from a :class:`~heat_tpu_torch.parallel.fsdp.PartitionRules` table.

* **Per-stage recomputation**: each stage's gathers run inside its own
  ``torch.utils.checkpoint`` region (non-reentrant), so the backward gathers
  again instead of keeping every stage's full weights, and the gradient of
  a sharded leaf arrives as the reduce-scatter of the gather's backward.
* **Prefetch**: ``HEAT_TPU_FSDP_PREFETCH`` depth ``d`` issues stage ``k``'s
  gathers (asynchronously, exact wires) before stage ``k-d`` computes, so
  at most ``d+1`` stages' gathered weights are live. The JAX package ties
  each gather to an earlier activation with an ``optimization_barrier`` and
  leaves the overlap to XLA's scheduler; here the gather is issued eagerly
  and waited for when its stage starts. Depth 0 gathers each stage when it
  runs. The results are the same bits at every depth. The recomputation in
  the backward gathers again in the same order on every rank.

``HEAT_TPU_FSDP=0`` (the default) is the replicated twin: the parameters
stay whole and one flat all-reduce averages the gradients, the
:class:`DataParallel` step. The optimizer state follows the parameters'
layout (a ``torch.optim`` optimizer over the flat chunks is ZeRO's sharded
state), and the checkpoints are the logical form, so a run restarts on
another world size bit for bit.

Stages are ``nn.Module``s applied left to right (``x = stage_k(x)``); a
single module is one stage. :meth:`heat_tpu_torch.nn.TransformerLM.stages`
gives the LM's embedding, blocks and head as stages. The optimizer is a
``torch.optim.Optimizer`` (its class and defaults) or a callable ``params ->
Optimizer`` (as :class:`heat_tpu_torch.optim.ZeroOptimizer`'s).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from .. import _knobs as knobs
from ..core import collective_prec, program_cache
from ..parallel import fsdp as _fsdp
from .data_parallel import DataParallel, _mean_over

__all__ = ["FSDP"]


def _opt_init(factory: Callable, leaves: list) -> torch.optim.Optimizer:
    """The optimizer over the persistent layout's leaves (site
    ``fsdp_opt_init``)."""
    return factory(leaves)


class FSDP(DataParallel):
    """Fully sharded data parallelism over ``comm``'s ranks.

    Parameters
    ----------
    module : nn.Module or a sequence of them
        One network, or the stages applied left to right (the form that
        gathers and recomputes a stage at a time).
    comm : TorchCommunication, optional
        The data-parallel world.
    optimizer : torch.optim.Optimizer or callable, optional
        The optimizer of :meth:`init_opt_state`/:meth:`make_train_step`.
    rules : PartitionRules, optional
        The layout table (default: shard every non-scalar leaf).
    precision : str, optional
        The wire of the gathers whose rule pins none (default the
        ``fsdp_wire`` chain).
    prefetch : int, optional
        Gather-prefetch depth; default ``HEAT_TPU_FSDP_PREFETCH``.

    ``HEAT_TPU_FSDP`` and the prefetch depth are resolved at construction.
    """

    def __init__(self, module, comm=None, optimizer=None, rules=None,
                 precision: Optional[str] = None, prefetch: Optional[int] = None):
        self._multi = isinstance(module, (list, tuple, nn.ModuleList))
        self.stages: List[nn.Module] = list(module) if self._multi else [module]
        super().__init__(nn.Sequential(*self.stages) if self._multi else module, comm, optimizer,
                         blocking_parameter_updates=True)
        self.rules = rules if rules is not None else _fsdp.PartitionRules.fsdp_default()
        self.precision = precision
        self.enabled = bool(knobs.get("HEAT_TPU_FSDP"))
        self.prefetch = int(prefetch if prefetch is not None
                            else knobs.get("HEAT_TPU_FSDP_PREFETCH"))
        if self.prefetch < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {self.prefetch}")
        self._plan: Optional[_fsdp.FsdpPlan] = None

    # -- initialization and layout ---------------------------------------------------

    def init(self, *_) -> Any:
        """The logical parameters, rank 0's on every rank: a dict (name ->
        tensor) a stage, in a list for a sequence of stages."""
        super().init()
        logical = [{name: p.detach().clone() for name, p in stage.named_parameters()}
                   for stage in self.stages]
        return logical if self._multi else logical[0]

    def plan(self, params) -> _fsdp.FsdpPlan:
        """Resolve (and pin) the partition plan of a logical tree."""
        self._plan = _fsdp.plan_partition(params, self.rules, self.comm,
                                          precision=self.precision)
        return self._plan

    def _ensure_plan(self, params) -> _fsdp.FsdpPlan:
        return self._plan if self._plan is not None else self.plan(params)

    def shard_params(self, params):
        """Logical -> persistent layout: the plan's flat rows (knob off: the
        whole leaves, the DataParallel layout). Leaf tensors that record
        gradients."""
        if not self.enabled:
            return _fsdp._unflatten(params, [
                torch.as_tensor(leaf).detach().clone().requires_grad_(True)
                for leaf in _fsdp._leaves(params)])
        return _fsdp.fsdp_shard(params, self._ensure_plan(params), self.comm)

    def unshard_params(self, params):
        """Persistent layout -> logical numpy (a collective)."""
        if not self.enabled:
            return _fsdp._unflatten(params, [_fsdp._host(leaf) for leaf in _fsdp._leaves(params)])
        if self._plan is None:
            raise ValueError("no plan pinned: call shard_params/plan first")
        return _fsdp.fsdp_unshard(params, self._plan, self.comm)

    def param_bytes_per_device(self, params) -> int:
        """This rank's parameter bytes."""
        return _fsdp.bytes_per_device(params)

    def init_opt_state(self, params, optimizer=None) -> torch.optim.Optimizer:
        """The optimizer over the persistent layout's leaves (over flat
        chunks: ZeRO's sharded state)."""
        from ..optim.zero_optimizer import optimizer_factory

        optimizer = optimizer if optimizer is not None else self.optimizer
        if optimizer is None:
            raise ValueError("no optimizer bound; pass one at construction")
        leaves = list(_fsdp._leaves(params))
        if not self.enabled:  # the replicated optimizer, as the JAX package's knob off
            return optimizer_factory(optimizer)(leaves)
        return program_cache.cached_program(
            "fsdp_opt_init", (getattr(optimizer, "__name__", type(optimizer).__name__),
                              self._ensure_plan(params).signature()),
            lambda: _opt_init, comm=self.comm, inline=True)(optimizer_factory(optimizer), leaves)

    # -- forward -----------------------------------------------------------------------

    def _stage_trees(self, params) -> list:
        return list(params) if self._multi else [params]

    def _issue(self, trees, k: int, plan) -> dict:
        """Stage ``k``'s gathers, issued ahead (sharded leaves only)."""
        prefix = f"{k}/" if self._multi else ""
        out = {}
        for path, leaf in _fsdp.leaf_paths(trees[k]):
            lp = plan.by_path[prefix + path]
            if lp.sharded:
                out[path] = _fsdp.Prefetched(leaf, lp, self.comm)
        return out

    def _stage_fn(self, k: int, names: list, paths: list, plan, pre: dict) -> Callable:
        prefix = f"{k}/" if self._multi else ""
        stage, comm = self.stages[k], self.comm
        block = collective_prec.block_size()

        def run(x, *leaves):
            full = {}
            for name, path, leaf in zip(names, paths, leaves):
                lp = plan.by_path[prefix + path]
                full[name] = (_fsdp.fsdp_gather(leaf, lp, comm, block=block,
                                                prefetched=pre.pop(path, None))
                              if lp.sharded else leaf)
            return functional_call(stage, full, (x,))

        return run

    def _forward_local(self, params, x, plan, depth: int, remat: bool):
        """The staged forward on this rank's rows: gathers issued ``depth``
        stages ahead, each stage (with its gathers) recomputed in the
        backward when ``remat``."""
        trees = self._stage_trees(params)
        issued = {}
        out = x
        for k, tree in enumerate(trees):
            if self.enabled and depth > 0:
                for j in range(k, min(k + depth, len(trees) - 1) + 1):
                    if j not in issued:
                        issued[j] = self._issue(trees, j, plan)
            names = list(tree.keys())
            paths = [name.replace(".", "/") for name in names]
            leaves = [tree[name] for name in names]
            if not self.enabled:
                out = functional_call(self.stages[k], dict(zip(names, leaves)), (out,))
                continue
            fn = self._stage_fn(k, names, paths, plan, issued.get(k, {}))
            if remat and torch.is_grad_enabled():
                out = checkpoint(fn, out, *leaves, use_reentrant=False)
            else:
                out = fn(out, *leaves)
        return out

    def __call__(self, params, *inputs):
        """The forward of this rank's rows of ``inputs[0]``."""
        plan = self._ensure_plan(params) if self.enabled else None
        x = self.shard_batch(*inputs)[0]
        # knob off: the replicated forward, under DataParallel's site as in JAX
        site, sig = ("fsdp_forward", plan.signature()) if self.enabled else ("dp_forward", None)
        return program_cache.cached_program(
            site, (sig, self.prefetch), lambda: FSDP._forward_local, comm=self.comm,
            inline=True)(self, params, x, plan, self.prefetch, False)

    # -- training ------------------------------------------------------------------------

    def make_train_step(self, loss_fn: Callable, optimizer=None,
                        precision: Optional[str] = None) -> Callable:
        """``step(params, opt_state, *batch) -> (params, opt_state, loss)``.

        ``loss_fn(out, *batch_tail) -> scalar`` is the MEAN loss over this
        rank's rows (FSDP owns the forward: ``out`` is the last stage's
        output); ``batch`` holds this rank's rows (:meth:`shard_batch`).
        ``opt_state`` is :meth:`init_opt_state`'s optimizer. Enabled: the
        staged forward (recomputed stages, prefetch), the backward's
        reduce-scatters, each sharded gradient divided by the world size,
        each replicated one averaged exactly, and the optimizer stepped on
        the chunks. Knob off: the replicated step, its gradients averaged by
        one flat all-reduce at ``precision`` (DataParallel's)."""
        comm = self.comm
        if self.enabled and self._plan is None:
            raise ValueError("no plan pinned: call shard_params(params) before make_train_step")
        plan, depth = self._plan, self.prefetch
        wire = collective_prec.resolve(precision) if not self.enabled else "off"
        # in place (donated); knob off: the replicated step, under DataParallel's
        # site as in the JAX package
        site, sig = ("fsdp_train_step", plan.signature()) if self.enabled else ("dp_train_step",
                                                                                None)
        prog = program_cache.cached_program(
            site, (sig, depth, wire, collective_prec.block_size()),
            lambda: FSDP._run_train_step, comm=comm, inline=True, donated=True)

        def step(params, opt_state, *batch):
            return prog(self, loss_fn, plan, depth, wire, params, opt_state, *batch)

        self._train_step = step
        return step

    def _run_train_step(self, loss_fn: Callable, plan, depth: int, wire: str, params,
                        opt_state, *batch):
        comm, p = self.comm, self.comm.size
        x, rest = batch[0], tuple(batch[1:])
        leaves = _fsdp._leaves(params)
        out = self._forward_local(params, x, plan, depth, remat=True)
        loss = loss_fn(out, *rest)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
        loss = loss.detach()
        if not self.enabled:
            grads, loss = _mean_over(comm, grads, loss, wire=wire)
        else:
            if p > 1:
                loss = comm.allreduce_flat([loss.reshape(1)], average=True)[0].reshape(())
                grads = [g / p if lp.sharded else
                         comm.allreduce(g.clone(), precision="off") / p
                         for g, lp in zip(grads, plan.leaves)]
        for t, g in zip(leaves, grads):
            t.grad = g.to(t.dtype)
        opt_state.step()
        for t in leaves:
            t.grad = None
        return params, opt_state, loss

    # -- checkpoint / restore --------------------------------------------------------------

    def _specs(self, params) -> list:
        if not self.enabled:
            return [(False, 0, tuple(t.shape)) for t in _fsdp._leaves(params)]
        return [(lp.sharded, lp.chunk, lp.shape) for lp in self._plan.leaves]

    def save_checkpoint(self, path: str, params, opt_state) -> str:
        """Checkpoint in the topology-independent logical form: sharded
        parameters gathered and unpadded, the optimizer's chunk states
        likewise. Every rank calls it."""
        from .. import resilience
        from ..optim.zero_optimizer import logical_state

        paths = [path_ for path_, _ in _fsdp.leaf_paths(params)]
        logical_p = _fsdp._leaves(self.unshard_params(params))
        logical_s = logical_state(opt_state, self._specs(params), self.comm)
        tree = {"params": dict(zip(paths, logical_p)), "opt_state": logical_s}
        return resilience.save_checkpoint(
            tree, path, comm=self.comm,
            extra={"algo": "fsdp", "enabled": bool(self.enabled), "prefetch": int(self.prefetch),
                   "rules": repr(self.rules), "paths": paths, "opt_keys": sorted(logical_s)})

    def load_checkpoint(self, path: str, params_template):
        """Restore onto this world and plan: the logical blobs re-padded and
        re-cut, bit for bit across world sizes. ``params_template`` gives
        the structure (e.g. :meth:`init`'s). Returns ``(params,
        opt_state)`` in the persistent layout."""
        from .. import resilience
        from ..optim.zero_optimizer import load_logical_state

        extra = resilience.checkpoint.load_manifest(path).get("extra", {})
        if extra.get("algo") != "fsdp":
            raise resilience.CheckpointError(
                f"{path!r} is a {extra.get('algo')!r} checkpoint, not fsdp")
        like = {"params": {key: 0 for key in extra["paths"]},
                "opt_state": {key: 0 for key in extra["opt_keys"]}}
        tree = resilience.load_checkpoint(path, like=like, comm=self.comm)
        template = _fsdp._leaves(params_template)
        logical = _fsdp._unflatten(params_template, [
            torch.as_tensor(np.asarray(tree["params"][key])).to(t.device, t.dtype)
            for key, t in zip(extra["paths"], template)])
        params = self.shard_params(logical)
        opt_state = self.init_opt_state(params)
        load_logical_state(opt_state, _fsdp._leaves(params), self._specs(params),
                           tree["opt_state"], self.comm)
        return params, opt_state
