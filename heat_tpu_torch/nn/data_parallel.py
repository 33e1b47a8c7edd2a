"""Data-parallel model wrappers (counterpart of ``heat_tpu/nn/data_parallel.py``;
reference heat/nn/data_parallel.py).

One process a card, as the reference Heat: every rank holds a replica of
the ``torch.nn.Module`` and takes its rows of each batch. A training step
takes the gradient of the rank's own rows and averages the gradients (and
the loss) over the ranks with ONE all-reduce of a flat buffer, the port of
the JAX package's one gradient ``psum`` a step; the mean of the ranks' mean
gradients is the global mean gradient because every rank holds as many
rows (``shard_batch`` refuses a batch that does not divide).

The JAX contract is functional over a parameter pytree; here the
parameters live in the module and the optimizer state in a
``torch.optim.Optimizer``, so in the train steps ``params`` is the module
and ``opt_state`` the optimizer (or a
:class:`heat_tpu_torch.optim.DataParallelOptimizer`), both updated in place
and returned, with the JAX package's arities and results:

* blocking: ``step(params, opt_state, *batch) -> (params, opt_state, loss)``
  applies this step's global mean gradient;
* double-buffered (the default, as the reference's non-blocking mode):
  ``step(params, opt_state, pending, *batch) -> (params, opt_state,
  next_pending, loss)`` applies ``pending`` (the previous step's average)
  while this step's all-reduce is in flight, and returns this step's
  average. ``init_pending`` seeds it with zero tensors, so the first step
  applies zeros: a torch optimizer skips a parameter whose ``.grad`` is
  None, where optax applies a zero update (Adam's count advances, AdamW's
  decay applies); zero tensors give optax's result.

:class:`DataParallelMultiGPU` binds a module to a
:class:`heat_tpu_torch.optim.DASO` schedule, which owns the two-level
(node, local) averaging.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core import collective_prec, program_cache
from ..core.communication import TorchCommunication, sanitize_comm
from ..core.dndarray import DNDarray

__all__ = ["DataParallel", "DataParallelMultiGPU"]


def _check_module(module) -> nn.Module:
    if not isinstance(module, nn.Module):
        raise TypeError(f"module must be a torch.nn.Module, got {type(module)}")
    return module


def _torch_optimizer(opt_state) -> torch.optim.Optimizer:
    """The torch optimizer of a step's ``opt_state`` (itself, or the one a
    ``DataParallelOptimizer`` wraps)."""
    opt = getattr(opt_state, "torch_optimizer", opt_state)
    if not isinstance(opt, torch.optim.Optimizer):
        raise TypeError(f"opt_state must be a torch.optim.Optimizer or a DataParallelOptimizer, "
                        f"got {type(opt_state)}")
    return opt


def _module_device(module: nn.Module) -> torch.device:
    for p in module.parameters():
        return p.device
    return torch.device("cpu")


def _shard_batch(comm: TorchCommunication, arrays: Sequence, device) -> Tuple[torch.Tensor, ...]:
    """This rank's rows of each batch array: a DNDarray split along 0 gives
    its chunk (refused when the chunks are uneven: pad rows would bias the
    mean), a replicated one all of it; any other array is the global batch,
    of which this rank takes its equal share."""
    out = []
    for a in arrays:
        if isinstance(a, DNDarray):
            if a.split not in (None, 0):
                raise ValueError(f"DataParallel batches must be split along 0, got {a.split}")
            if a.split == 0 and a.pad_count:
                raise ValueError(
                    f"batch axis ({a.shape[0]}) must divide evenly over the {comm.size}-rank "
                    "world; pad rows would bias the loss. Use a divisible batch size.")
            out.append(a.larray)
            continue
        t = torch.from_numpy(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
        t = t.to(device)
        n = t.shape[0]
        if n % comm.size:
            raise ValueError(
                f"batch axis ({n}) must divide evenly over the {comm.size}-rank world; "
                "pad rows would bias the loss. Use a divisible batch size.")
        c = n // comm.size
        out.append(t[comm.rank * c:(comm.rank + 1) * c])
    return tuple(out)


def _trainable(module: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    return [(name, p) for name, p in module.named_parameters() if p.requires_grad]


def _loss_and_grads(module: nn.Module, loss_fn: Callable, batch) -> Tuple[torch.Tensor, list]:
    """The loss of this rank's rows and its gradient, one tensor per
    trainable parameter (zeros where the loss does not reach one)."""
    params = [p for _, p in _trainable(module)]
    loss = loss_fn(module, *batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    return loss.detach(), grads


def _mean_over(comm: TorchCommunication, grads: list, loss: Optional[torch.Tensor],
               async_op: bool = False, wire: str = "off"):
    """Average ``grads`` (and ``loss``) over ``comm``'s ranks in one flat
    all-reduce, the loss riding in the gradients' type. Returns
    ``(grads, loss)``, or with ``async_op`` a callable that waits for them.
    A compressed ``wire`` averages each float gradient on its own
    (``collective_prec.pmean``, the JAX package's per-leaf scales) and the
    loss exactly."""
    if wire != "off" and comm.size > 1:
        out = [collective_prec.pmean(g, comm, wire) if collective_prec.compressible(g.dtype)
               else comm.sum(g) / comm.size for g in grads]
        mean_loss = None if loss is None else comm.allreduce_flat([loss], average=True)[0]
        return (lambda: (out, mean_loss)) if async_op else (out, mean_loss)
    dtypes = {g.dtype for g in grads}
    if len(dtypes) > 1:
        raise TypeError(f"gradients of one type are averaged in one buffer, got {dtypes}")
    wire = [*grads, loss.reshape(1).to(next(iter(dtypes)))] if loss is not None else list(grads)
    pending = comm.allreduce_flat(wire, average=True, async_op=True)

    def finish():
        out = pending.wait()
        if loss is None:
            return out, None
        return out[:-1], out[-1].reshape(()).to(loss.dtype)

    return finish if async_op else finish()


def _apply(params: List[torch.Tensor], grads: Sequence[torch.Tensor],
           opt: torch.optim.Optimizer) -> None:
    """One optimizer step with ``grads`` as the parameters' gradients."""
    for p, g in zip(params, grads):
        p.grad = g.to(p.dtype)
    opt.step()
    for p in params:
        p.grad = None


def _forward(module: nn.Module, *batch):
    """The replica's forward (the registry program of site ``dp_forward``)."""
    return module(*batch)


def _blocking_step(params, opt_state, loss_fn: Callable, comm: TorchCommunication, wire: str,
                   *batch):
    """One blocking step: this rank's loss and gradients, their mean over
    the ranks, the update (site ``dp_train_step``)."""
    module, opt = _check_module(params), _torch_optimizer(opt_state)
    loss, grads = _loss_and_grads(module, loss_fn, batch)
    grads, loss = _mean_over(comm, grads, loss, wire=wire)
    _apply([p for _, p in _trainable(module)], grads, opt)
    return params, opt_state, loss


def _double_buffered_step(params, opt_state, pending_grads: Dict[str, torch.Tensor],
                          loss_fn: Callable, comm: TorchCommunication, wire: str, *batch):
    """One double-buffered step: this step's mean travels while the
    previous step's is applied (site ``dp_train_step``)."""
    module, opt = _check_module(params), _torch_optimizer(opt_state)
    named = _trainable(module)
    loss, grads = _loss_and_grads(module, loss_fn, batch)
    finish = _mean_over(comm, grads, loss, async_op=True, wire=wire)
    _apply([p for _, p in named], [pending_grads[name] for name, _ in named], opt)
    grads, loss = finish()
    return params, opt_state, dict(zip(pending_grads, grads)), loss


class DataParallel:
    """Synchronous data parallelism over the ranks of ``comm``.

    Parameters
    ----------
    module : torch.nn.Module
        The network, one replica on each rank.
    comm : TorchCommunication, optional
        The data-parallel world (the default communicator).
    optimizer : torch.optim.Optimizer or DataParallelOptimizer, optional
        Bound optimizer; :meth:`make_train_step` needs one.
    blocking_parameter_updates : bool
        ``True``: each step applies its own global mean gradient. ``False``
        (the reference's default): the double-buffered step (module
        docstring).
    """

    def __init__(self, module, comm: Optional[TorchCommunication] = None, optimizer=None,
                 blocking_parameter_updates: bool = False):
        self.module = _check_module(module)
        self.comm = sanitize_comm(comm)
        self.optimizer = optimizer
        self.blocking_parameter_updates = blocking_parameter_updates
        self._train_step = None

    def init(self, *_) -> nn.Module:
        """Replicate rank 0's parameters on every rank (one broadcast of a
        flat buffer); returns the module."""
        params = [p for p in self.module.parameters()]
        if params and self.comm.size > 1:
            flat = self.comm.bcast(torch.cat([p.detach().reshape(-1) for p in params]))
            with torch.no_grad():
                offset = 0
                for p in params:
                    p.copy_(flat[offset:offset + p.numel()].view_as(p))
                    offset += p.numel()
        return self.module

    def shard_batch(self, *arrays) -> Tuple[torch.Tensor, ...]:
        """This rank's rows of each batch array (a DNDarray split along 0:
        its chunk, refused when the chunks are uneven; any other array: the
        global batch, of which this rank takes its equal share)."""
        return _shard_batch(self.comm, arrays, _module_device(self.module))

    def __call__(self, *inputs):
        """The forward of this rank's rows of ``inputs`` (site ``dp_forward``)."""
        return program_cache.cached_program(
            "dp_forward", (type(self.module).__name__, len(inputs)), lambda: _forward,
            comm=self.comm, inline=True)(self.module, *self.shard_batch(*inputs))

    def make_train_step(self, loss_fn: Callable, optimizer=None,
                        precision: Optional[str] = None) -> Callable:
        """The train step of this wrapper's mode (module docstring).

        ``loss_fn(module, *batch) -> scalar`` is the MEAN over the batch
        rows it gets; the step gets this rank's rows (:meth:`shard_batch`).
        ``precision`` (``off | bf16 | int8 | blockwise``, default the
        ``HEAT_TPU_COLLECTIVE_PREC`` knob) compresses the gradient wire:
        each float gradient is averaged by ``collective_prec.pmean``, the
        loss exactly."""
        optimizer = optimizer if optimizer is not None else self.optimizer
        if optimizer is None:
            raise ValueError("no optimizer bound; pass one here or at init")
        wire = collective_prec.resolve(precision)
        comm = self.comm

        blocking = self.blocking_parameter_updates
        # the step changes the parameters and the optimizer in place
        prog = program_cache.cached_program(
            "dp_train_step", ("blocking" if blocking else "double_buffered", wire),
            lambda: _blocking_step if blocking else _double_buffered_step, comm=comm,
            inline=True, donated=True)

        if blocking:

            def step(params, opt_state, *batch):
                return prog(params, opt_state, loss_fn, comm, wire, *batch)

        else:

            def step(params, opt_state, pending_grads, *batch):
                named = _trainable(_check_module(params))
                if not isinstance(pending_grads, dict) or list(pending_grads) != [
                        name for name, _ in named]:
                    raise TypeError(
                        "non-blocking (double-buffered) DataParallel step signature is "
                        "step(params, opt_state, pending_grads, *batch) -> (params, opt_state, "
                        "next_pending, loss); seed pending_grads with DataParallel.init_pending("
                        "params), or construct with blocking_parameter_updates=True for the "
                        "3-tuple step")
                return prog(params, opt_state, pending_grads, loss_fn, comm, wire, *batch)

        self._train_step = step
        return step

    @staticmethod
    def init_pending(params) -> Dict[str, torch.Tensor]:
        """Zero gradients seeding the double-buffered loop (the reference's
        iteration-0 zeros, data_parallel.py:276), keyed by parameter name."""
        return {name: torch.zeros_like(p) for name, p in _trainable(_check_module(params))}


class DataParallelMultiGPU:
    """Hierarchical data parallelism paired with DASO (reference
    data_parallel.py:314-376): binds ``module`` to ``daso``'s two-level
    (node, local) schedule."""

    def __init__(self, module, daso):
        self.module = _check_module(module)
        self.daso = daso
        daso.set_model(module)

    def __call__(self, *inputs):
        return self.module(*inputs)
