"""Distributed optimizers: DataParallelOptimizer and DASO (counterpart of
``heat_tpu/optim/dp_optimizer.py``; reference heat/optim/dp_optimizer.py).

:class:`DataParallelOptimizer` wraps a ``torch.optim.Optimizer`` for
:class:`heat_tpu_torch.nn.DataParallel`, whose step has already averaged
the gradients. :class:`DASO` is the hierarchical asynchronous schedule, one
process a rank as in the reference Heat: the world is split into
``n_nodes`` nodes of ``n_local`` consecutive ranks
(``TorchCommunication.node_local``), every rank keeps its own replica of
the module, gradients are averaged inside a node on the batches the local
skip does not skip, and every ``global_skip`` batches the node means of the
parameters are summed across nodes in ``downcast_type`` (bf16) and merged
``batches_to_wait`` batches later with the reference's staleness weights
(``new = numer/denom · local + sent/denom``, ``numer = 2·batches_waited``,
``denom = n_nodes + numer``). The cross-node sum is issued as an
asynchronous all-reduce and waited for when merged. The decision order,
the plateau-driven skip decay and the hold at the maximum skip are the
JAX package's, line for line.

As in :mod:`heat_tpu_torch.nn.data_parallel`, ``params`` is the module (this
rank's replica) and ``opt_state`` the torch optimizer; ``loss_fn(module,
*batch)``. A ``scheduler`` multiplies each group's learning rate by
``scheduler(count)`` before the ``count``-th update (optax's
``scale_by_schedule`` after the optimizer, the same update for optimizers
whose update is linear in the learning rate: SGD, Adam, AdamW, ...).

The node count defaults to the resolved topology (``HEAT_TPU_TOPOLOGY``, else
:func:`heat_tpu_torch.core.topology.detect`). ``collective_precision``
(default the ``HEAT_TPU_COLLECTIVE_PREC`` knob) is the cross-node wire of the
send (:func:`~heat_tpu_torch.core.topology.node_mean_cross_sum`): ``off``
moves ``downcast_type``, ``bf16`` pins bf16, ``int8``/``blockwise`` run the
two-phase quantized sum (synchronously, the payload kept for its merge).

``checkpoint_every=k`` saves every ``k`` steps to ``checkpoint_path``;
:meth:`save_checkpoint` writes every rank's replica and optimizer state as
the rows of ``(p, ...)`` arrays (the JAX package's stacked layout) and the
schedule state, :meth:`load_checkpoint` restores them. In-flight
asynchronous payloads are not checkpointed: a resumed run re-syncs at its
next global-skip boundary.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core import collective_prec, program_cache
from ..core import topology as _topology
from ..core.communication import TorchCommunication, sanitize_comm
from ..nn.data_parallel import (_apply, _check_module, _loss_and_grads, _mean_over,
                                _module_device, _shard_batch, _trainable)
from .utils import DetectMetricPlateau

__all__ = ["DataParallelOptimizer", "DASO"]


class DataParallelOptimizer:
    """A ``torch.optim.Optimizer`` for :class:`heat_tpu_torch.nn.DataParallel`
    (reference dp_optimizer.py:834-877): the gradients it applies were
    averaged by the train step already."""

    def __init__(self, optimizer, blocking: bool = False):
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError(f"optimizer must be a torch.optim.Optimizer, got {type(optimizer)}")
        self.torch_optimizer = optimizer
        self.optimizer = optimizer
        self.blocking = blocking

    def init(self, params) -> "DataParallelOptimizer":
        """The optimizer state of ``params``: this object (torch keeps the
        state in the optimizer)."""
        return self

    def step(self, params=None, opt_state=None, grads: Optional[Dict[str, torch.Tensor]] = None):
        """One update. With ``grads`` (parameter name -> gradient of the
        module ``params``) they are applied and ``(params, opt_state)``
        returned, as the JAX package's ``step(params, opt_state, grads)``;
        without, the parameters' own ``.grad`` are (reference
        ``DataParallelOptimizer.step()``)."""
        if grads is None:
            plist = glist = None
        else:
            named = _trainable(_check_module(params))
            plist, glist = [p for _, p in named], [grads[name] for name, _ in named]
        # the update changes the parameters and the optimizer's state in place
        program_cache.cached_program(
            "dp_optimizer_step", (type(self.torch_optimizer).__name__, grads is None),
            lambda: _optimizer_step, inline=True, donated=True)(
            self.torch_optimizer, plist, glist)
        return params, opt_state

    def zero_grad(self) -> None:
        """Clear the parameters' gradients (reference :871)."""
        self.torch_optimizer.zero_grad(set_to_none=True)


def _optimizer_step(opt: torch.optim.Optimizer, params, grads) -> None:
    """One update of ``opt``: with ``grads`` as the parameters' gradients,
    else with the gradients they hold (site ``dp_optimizer_step``)."""
    if grads is None:
        opt.step()
    else:
        _apply(params, grads, opt)


class _Sent:
    """A cross-node payload that has already arrived (the quantized wires
    run synchronously): :meth:`wait` returns it."""

    def __init__(self, tensors):
        self._tensors = tensors

    def wait(self):
        return self._tensors


class DASO:
    """Distributed Asynchronous and Selective Optimization (reference
    dp_optimizer.py:46-831) over a two-level split of the ranks.

    Parameters
    ----------
    local_optimizer : torch.optim.Optimizer
        This rank's optimizer, over its replica's parameters.
    total_epochs : int
        Training length; bounds the warmup and cooldown phases.
    comm : TorchCommunication, optional
        The world split into nodes.
    n_nodes : int, optional
        Number of nodes (the slow level). By default the resolved
        topology's (``HEAT_TPU_TOPOLOGY``, else one a host when the ranks
        span several, else 2 on an even world), else one a rank.
    scheduler, scheduler_base_lr :
        A scale-factor schedule (``step -> scale``), or with
        ``scheduler_base_lr`` an absolute-lr schedule (the
        :mod:`heat_tpu_torch.optim.lr_scheduler` factories) divided by that
        base lr, so the lr is applied once.
    warmup_epochs, cooldown_epochs, stability_level, max_global_skips,
    skip_reduction_factor, local_skip_factor, verbose :
        Schedule knobs, the reference's defaults (:136-156).
    downcast_type : torch.dtype
        Type of the cross-node parameter sum (bf16).
    checkpoint_every, checkpoint_path :
        Save a checkpoint every ``checkpoint_every`` steps (module
        docstring).
    collective_precision : str, optional
        The cross-node wire (module docstring).
    """

    def __init__(
        self,
        local_optimizer,
        total_epochs: int,
        comm: Optional[TorchCommunication] = None,
        n_nodes: Optional[int] = None,
        warmup_epochs: int = 4,
        cooldown_epochs: int = 4,
        scheduler=None,
        scheduler_base_lr: Optional[float] = None,
        stability_level: float = 0.05,
        max_global_skips: int = 8,
        downcast_type: torch.dtype = torch.bfloat16,
        skip_reduction_factor: int = 2,
        local_skip_factor: int = 4,
        verbose: bool = False,
        checkpoint_every: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        collective_precision: Optional[str] = None,
    ):
        if not isinstance(local_optimizer, torch.optim.Optimizer):
            raise TypeError(
                f"local_optimizer must be a torch.optim.Optimizer, got {type(local_optimizer)}")
        if checkpoint_every is not None:
            if checkpoint_every <= 0:
                raise ValueError(f"checkpoint_every must be positive, got {checkpoint_every}")
            if not checkpoint_path:
                raise ValueError("checkpoint_every requires checkpoint_path")
        if collective_precision is not None:
            collective_prec.resolve(collective_precision)  # validate early
        if scheduler is None and scheduler_base_lr is not None:
            raise ValueError("scheduler_base_lr given without a scheduler — pass the "
                             "absolute-lr schedule it belongs to")
        if scheduler is not None:
            if not callable(scheduler):
                raise TypeError(f"scheduler must be a schedule (step -> scale), got "
                                f"{type(scheduler)}")
            if scheduler_base_lr is not None:
                if scheduler_base_lr <= 0:
                    raise ValueError(
                        f"scheduler_base_lr must be positive, got {scheduler_base_lr}")
                base_sched, base_lr = scheduler, float(scheduler_base_lr)
                scheduler = lambda step: base_sched(step) / base_lr  # noqa: E731
        self.local_optimizer = local_optimizer
        self._base_lrs = [group["lr"] for group in local_optimizer.param_groups]
        self._updates = 0
        self.comm = sanitize_comm(comm)
        p = self.comm.size
        if n_nodes is None:
            topo = _topology.resolve(p, self.comm)
            n_nodes = topo.node if topo.node > 1 else p
        if n_nodes <= 0 or p % n_nodes != 0:
            raise ValueError(f"device count {p} not divisible by n_nodes {n_nodes}")
        self.n_nodes = n_nodes
        self.n_local = p // n_nodes
        self.node_comm, self.local_comm = self.comm.node_local(n_nodes)
        self.cast_dtype = downcast_type
        self._collective_precision = collective_precision
        self.scheduler = scheduler
        self.verbose = verbose
        self.total_epochs = total_epochs
        self.warmup_epochs = warmup_epochs
        self.cooldown_epochs = cooldown_epochs
        self.max_gs = max_global_skips
        self.skip_reduction_factor = skip_reduction_factor
        self.local_skip_factor = local_skip_factor

        self.module = None
        self.loss_fn: Optional[Callable] = None
        self.current_batch, self.last_batch = 0, None
        self.epoch = 0
        self.global_skip = 0
        self.local_skip = 0
        self.batches_to_wait = 0
        self._prev_params = []  # [(pending payload, target batch, batches waited)]
        self.stability = DetectMetricPlateau(patience=2, threshold=stability_level)
        self._gs8_waits = 3
        self._gs8_waited = 0
        self.amp = False
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path
        self._steps_done = 0

    # -- model binding & parameter layout ------------------------------------

    def set_model(self, model) -> None:
        """Bind the model (reference :708)."""
        self.module = model

    def set_loss(self, loss_fn: Callable) -> None:
        """Bind ``loss_fn(module, *batch) -> scalar`` used by :meth:`step`."""
        self.loss_fn = loss_fn

    def stack_params(self, params) -> nn.Module:
        """This rank's replica: the bound module holding ``params`` (a module,
        returned as it is, or parameter name -> array, copied into the
        module bound by :meth:`set_model`)."""
        if isinstance(params, nn.Module):
            return params
        if self.module is None:
            raise ValueError("call set_model(module) before stack_params(parameter dict)")
        with torch.no_grad():
            for name, p in self.module.named_parameters():
                p.copy_(torch.as_tensor(np.asarray(params[name])).to(p.device, p.dtype))
        return self.module

    def unstack_params(self, params) -> Dict[str, torch.Tensor]:
        """The mean of every rank's replica, parameter name -> tensor (one
        all-reduce): the synchronized model."""
        named = list(_check_module(params).named_parameters())
        means = self.comm.allreduce_flat([p.detach() for _, p in named], average=True)
        return {name: m.clone() for (name, _), m in zip(named, means)}

    def init(self, stacked_params) -> torch.optim.Optimizer:
        """The optimizer state of this replica: the local optimizer (torch
        keeps the state in it)."""
        return self.local_optimizer

    # -- the steps -------------------------------------------------------------

    def _local_step(self, module: nn.Module, opt_state, batch, local_sync: bool,
                    full_sync: bool) -> torch.Tensor:
        """This replica's step (site ``daso_step``; it changes the
        parameters, the optimizer and the schedule in place)."""
        return program_cache.cached_program(
            "daso_step", (local_sync, full_sync), lambda: DASO._run_local_step, comm=self.comm,
            inline=True, donated=True)(self, module, opt_state, batch, local_sync, full_sync)

    def _global_send(self, module: nn.Module):
        """The cross-node send (site ``daso_send``)."""
        wire = collective_prec.resolve(self._collective_precision)
        return program_cache.cached_program(
            "daso_send", (str(self.cast_dtype), wire), lambda: DASO._run_global_send,
            comm=self.comm, inline=True)(self, module, wire)

    def _merge(self, module: nn.Module, payload, numer: float) -> None:
        """The merge of a payload into the parameters (site ``daso_merge``;
        in place)."""
        program_cache.cached_program(
            "daso_merge", (self.n_nodes,), lambda: DASO._run_merge, comm=self.comm,
            inline=True, donated=True)(self, module, payload, numer)

    def _run_local_step(self, module: nn.Module, opt_state, batch, local_sync: bool,
                        full_sync: bool) -> torch.Tensor:
        if self.loss_fn is None:
            raise ValueError("call set_loss(loss_fn) before step()")
        opt = getattr(opt_state, "torch_optimizer", opt_state)
        batch = _shard_batch(self.comm, batch, _module_device(module))
        loss, grads = _loss_and_grads(module, self.loss_fn, batch)
        if full_sync:
            grads, loss = _mean_over(self.comm, grads, loss)
        else:
            if local_sync:
                grads, _ = _mean_over(self.local_comm, grads, None)
            loss = self.comm.allreduce_flat([loss], average=True)[0]
        if self.scheduler is not None:
            scale = float(self.scheduler(self._updates))
            for group, base in zip(opt.param_groups, self._base_lrs):
                group["lr"] = base * scale
        self._updates += 1
        _apply([p for _, p in _trainable(module)], grads, opt)
        return loss

    def _run_global_send(self, module: nn.Module, wire: str):
        """Launch the cross-node sum of the node means of the parameters
        (``node_mean_cross_sum``'s arithmetic at the cross-node wire);
        returns the pending payload."""
        params = [p.detach() for p in module.parameters()]
        if wire in ("int8", "blockwise"):
            sent = [_topology.node_mean_cross_sum(
                p, local_comm=self.local_comm, node_comm=self.node_comm, wire=wire,
                cast_dtype=self.cast_dtype, block=collective_prec.block_size()) for p in params]
            return _Sent(sent)
        cast = torch.bfloat16 if wire == "bf16" else self.cast_dtype
        rep = self.local_comm.allreduce_flat(params, average=True)
        return self.node_comm.allreduce_flat([r.to(cast) for r in rep], async_op=True)

    def _run_merge(self, module: nn.Module, payload, numer: float) -> None:
        """``local · numer/denom + sent/denom`` with ``denom = numer +
        n_nodes``, in f32 as the JAX package's merge."""
        numer = np.float32(numer)
        denom = numer + np.float32(self.n_nodes)
        ratio = float(numer / denom)
        with torch.no_grad():
            for p, sent in zip(module.parameters(), payload.wait()):
                p.copy_(p * ratio + sent.to(p.dtype) / float(denom))

    def step(self, params, opt_state, batch) -> Tuple[Any, Any, torch.Tensor]:
        """One DASO step: this replica's update and the sync state machine
        (reference :730-814, the JAX package's decision order). ``batch`` is
        a tuple of arrays, taken as :meth:`DataParallel.shard_batch` takes
        them. Returns ``(params, opt_state, loss)``, the loss averaged over
        every rank."""
        if self.last_batch is None:
            raise ValueError(
                "self.last_batch must be set to the index of the final batch of an epoch "
                "(len(dataloader) - 1)")
        module = _check_module(getattr(params, "module", params))
        batch_idx = self.current_batch
        gs, ls = self.global_skip, self.local_skip
        gmod = batch_idx % gs if gs > 0 else 0
        btw = min(self.batches_to_wait, max(self.last_batch - batch_idx, 0))

        full_sync_now = batch_idx == self.last_batch or gmod == 0
        local_sync_now = ls <= 1 or (batch_idx % ls == 0)

        if full_sync_now and gs == 0 and btw == 0:
            # warmup/cooldown: plain blocking hierarchical DP
            loss = self._local_step(module, opt_state, batch, local_sync=True, full_sync=True)
            self._advance(batch_idx)
            self._maybe_checkpoint(params, opt_state)
            return params, opt_state, loss

        loss = self._local_step(module, opt_state, batch, local_sync=local_sync_now,
                                full_sync=False)
        if full_sync_now:
            # drain the pending payloads first, so the queue cannot grow
            while self._prev_params:
                payload, _target, waited = self._prev_params.pop(0)
                self._merge(module, payload, waited * 2.0 if waited > 0 else 1.0)
            payload = self._global_send(module)
            if btw == 0:
                self._merge(module, payload, 1.0)
            else:
                self._prev_params.append((payload, batch_idx + btw, btw))
        elif self._prev_params and batch_idx >= self._prev_params[0][1]:
            payload, _target, waited = self._prev_params.pop(0)
            self._merge(module, payload, float(waited) * 2.0 if waited > 0 else 1.0)

        self._advance(batch_idx)
        self._maybe_checkpoint(params, opt_state)
        return params, opt_state, loss

    def _advance(self, batch_idx: int) -> None:
        if batch_idx == self.last_batch:
            self.current_batch = 0
            self.epoch += 1
        else:
            self.current_batch += 1

    # -- schedule --------------------------------------------------------------

    def print0(self, *args, **kwargs) -> None:
        """Print on rank 0 when verbose (reference :687)."""
        if self.verbose and self.comm.rank == 0:
            print(*args, **kwargs)

    def reset(self) -> None:
        """Reset the schedule to blocking sync (reference :694)."""
        self.global_skip = 0
        self.local_skip = 0
        self.batches_to_wait = 0
        self._prev_params = []
        self.stability.reset()

    def add_scaler(self, scaler) -> None:
        """AMP hook (reference :238): the scaler is recorded; no loss scaling
        is applied (bf16 needs none)."""
        self.scaler = scaler
        self.amp = True

    def zero_grad(self) -> None:
        """Clear the replica's gradients (reference :825)."""
        self.local_optimizer.zero_grad(set_to_none=True)

    # -- checkpoint / restore ------------------------------------------------

    def _schedule_state(self) -> dict:
        return {
            "epoch": self.epoch,
            "current_batch": self.current_batch,
            "last_batch": self.last_batch,
            "global_skip": self.global_skip,
            "local_skip": self.local_skip,
            "batches_to_wait": self.batches_to_wait,
            "gs8_waited": self._gs8_waited,
            "steps_done": self._steps_done,
            "updates": self._updates,
            "stability": self.stability.get_state(),
        }

    def _restore_schedule(self, sched: dict) -> None:
        self.epoch = int(sched["epoch"])
        self.current_batch = int(sched["current_batch"])
        if sched.get("last_batch") is not None:
            self.last_batch = int(sched["last_batch"])
        self.global_skip = int(sched["global_skip"])
        self.local_skip = int(sched["local_skip"])
        self.batches_to_wait = int(sched["batches_to_wait"])
        self._gs8_waited = int(sched["gs8_waited"])
        self._steps_done = int(sched.get("steps_done", 0))
        self._updates = int(sched.get("updates", self._steps_done))
        self.stability.set_state(sched["stability"])
        # in-flight async payloads are not checkpointed: the next global-skip
        # boundary re-syncs
        self._prev_params = []

    def _rows(self, t: torch.Tensor):
        """``t`` as this rank's row of a ``(p, ...)`` DNDarray split along 0."""
        from ..core import types
        from ..core.devices import sanitize_device
        from ..core.dndarray import DNDarray

        t = t.detach()
        return DNDarray(t[None].contiguous(), (self.comm.size,) + tuple(t.shape),
                        types.canonical_heat_type(t.dtype), 0, sanitize_device(t.device),
                        self.comm, True)

    def save_checkpoint(self, path: str, params, opt_state) -> str:
        """Checkpoint every rank's replica and optimizer state (the rows of
        ``(p, ...)`` arrays: the JAX package's stacked layout) and the whole
        schedule state (skips, waits, the plateau detector) to the directory
        ``path`` (:func:`heat_tpu_torch.resilience.save_checkpoint`: CRC
        checked, swapped into place atomically). Every rank calls it."""
        from .. import resilience

        module = _check_module(getattr(params, "module", params))
        opt = getattr(opt_state, "torch_optimizer", opt_state)
        tree = {f"params/{name}": self._rows(p) for name, p in module.named_parameters()}
        state = opt.state_dict()["state"]
        for i in sorted(state):
            for key, value in state[i].items():
                leaf = self._rows(value) if isinstance(value, torch.Tensor) else value
                tree[f"opt_state/{i:05d}/{key}"] = leaf
        return resilience.save_checkpoint(
            tree, path, comm=self.comm,
            extra={"algo": "daso", "schedule": self._schedule_state(), "keys": sorted(tree)})

    def load_checkpoint(self, path: str, params, opt_state):
        """Restore a :meth:`save_checkpoint` directory into this rank's
        replica ``params`` and optimizer ``opt_state`` (each rank its own
        row) and resume the schedule where it stopped; a checkpoint of
        another algorithm is refused. Returns ``(params, opt_state)``."""
        from .. import resilience

        leaves, extra = resilience.load_checkpoint(path, comm=self.comm, with_extra=True)
        if extra.get("algo") != "daso":
            raise resilience.CheckpointError(
                f"{path!r} is a {extra.get('algo')!r} checkpoint, not daso")
        tree = dict(zip(extra["keys"], leaves))
        module = _check_module(getattr(params, "module", params))
        opt = getattr(opt_state, "torch_optimizer", opt_state)

        def row(leaf, like: torch.Tensor) -> torch.Tensor:
            if not hasattr(leaf, "larray"):
                return leaf
            return leaf.larray[0].to(like.device if like is not None else "cpu")

        with torch.no_grad():
            for name, p in module.named_parameters():
                p.copy_(row(tree[f"params/{name}"], p))
        params_of = list(module.parameters())
        state: Dict[int, Dict[str, Any]] = {}
        for key, leaf in tree.items():
            if key.startswith("opt_state/"):
                _, i, k = key.split("/", 2)
                p = params_of[int(i)]
                value = row(leaf, p)
                if isinstance(value, torch.Tensor) and value.dim() == 0:
                    value = value.cpu()  # a step count lives on the host, as torch keeps it
                state.setdefault(int(i), {})[k] = value
        sd = opt.state_dict()
        opt.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
        self._restore_schedule(extra["schedule"])
        return params, opt_state

    def _maybe_checkpoint(self, params, opt_state) -> None:
        self._steps_done += 1
        if self.checkpoint_every and self._steps_done % self.checkpoint_every == 0:
            self.save_checkpoint(self.checkpoint_path, params, opt_state)

    def epoch_loss_logic(self, loss: Union[float, torch.Tensor],
                         loss_globally_averaged: bool = False) -> None:
        """End-of-epoch schedule update (reference :336-430, the JAX
        package's phases): warmup → blocking; post-warmup → gs=4/ls=1/btw=1;
        cooldown → blocking; otherwise plateau-driven decay, cycling back up
        to ``max_global_skips`` when fully decayed and stable. Unless
        ``loss_globally_averaged``, the loss is first averaged over the
        ranks."""
        avg_loss = float(loss)
        if not loss_globally_averaged and self.comm.size > 1:
            # on the parameters' device: NCCL reduces no host tensor
            device = self.local_optimizer.param_groups[0]["params"][0].device
            t = torch.tensor([avg_loss / self.comm.size], dtype=torch.float64, device=device)
            avg_loss = float(self.comm.allreduce(t)[0])

        if self.epoch < self.warmup_epochs:
            self.global_skip = self.local_skip = self.batches_to_wait = 0
            self.print0("Warmup phase: blocking sync")
            return
        if self.warmup_epochs == self.epoch:
            self.global_skip, self.local_skip, self.batches_to_wait = 4, 1, 1
            self.print0("End of warmup: gs=4 ls=1 btw=1")
        if self.epoch >= self.total_epochs - self.cooldown_epochs:
            self.global_skip = self.local_skip = self.batches_to_wait = 0
            self.print0("Cooldown phase: blocking sync")
            return

        # hold at the maximum global skip for `_gs8_waits` epochs before the
        # plateau tests act; the detector still sees every epoch's loss
        held = False
        if self.global_skip == self.max_gs and self.max_gs > 4:
            self._gs8_waited += 1
            held = self._gs8_waited < self._gs8_waits

        stable = self.stability.test_if_improving(avg_loss)
        if held:
            if stable:
                # a trigger consumed during the hold re-arms the detector, so
                # one more bad epoch triggers it once the hold expires
                self.stability.num_bad_epochs = self.stability.patience
            self.print0(f"holding at gs={self.global_skip} "
                        f"({self._gs8_waited}/{self._gs8_waits} epochs)")
            return
        if stable and self.global_skip > 1:
            self.global_skip //= self.skip_reduction_factor
            self.local_skip //= self.skip_reduction_factor
            self.batches_to_wait -= 1
            if self.global_skip > 0:
                self.batches_to_wait = max(self.batches_to_wait, 1)
                self.local_skip = max(self.local_skip, 1)
            self._gs8_waited = 0
            self.print0(f"dropping skips -> gs={self.global_skip}")
        elif self.global_skip == 1 and stable:
            self.global_skip = self.max_gs
            self.local_skip = self.max_gs // self.local_skip_factor
            self.batches_to_wait = self.max_gs // self.local_skip_factor
            self._gs8_waited = 0
            self.print0(f"resetting skips -> gs={self.global_skip}")
