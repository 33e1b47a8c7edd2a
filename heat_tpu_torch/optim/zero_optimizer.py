"""ZeRO optimizer-state sharding (counterpart of ``heat_tpu/optim/zero_optimizer.py``).

:class:`~heat_tpu_torch.optim.DataParallelOptimizer` keeps the whole
optimizer state on every rank (for Adam twice the parameter bytes, the
same on every rank). ZeRO stage 1 gives rank ``i`` the flat chunk
``[i·c, (i+1)·c)`` of every parameter
(:func:`heat_tpu_torch.parallel.fsdp.flat_chunk`) and a ``torch.optim``
optimizer over those chunks alone, and one step is

    reduce-scatter the gradients -> step the chunks -> all-gather the parameters

The gradient reduce-scatter honours ``precision=`` (resolved once, at
construction: the blockwise chunk padding is part of the state layout) and
takes the tiered lowering under ``HEAT_TPU_HIERARCHICAL=1``; the parameter
all-gather is exact (a compressed one would change the model). The update
of an elementwise optimizer (SGD, momentum, Adam, AdamW, RMSprop) on a
chunk is the update of those elements, so the trajectory is
:class:`DataParallelOptimizer`'s on the same averaged gradients: bit for
bit where the reduction order is the same (a world of one), else within
the reduction's rounding.

The optimizer is given as a ``torch.optim.Optimizer`` (its class and
defaults make the chunks' optimizer; the parameters it was built over are
not used) or as a callable ``params -> Optimizer``. As in
:class:`~heat_tpu_torch.nn.DataParallel`, ``params`` is the module (each
rank's replica, updated in place) and ``opt_state`` this object.

Checkpoints are written in the logical form: every state chunk gathered
and unpadded to its parameter's shape, so that a restore on another world
size continues the same trajectory bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core import collective_prec, program_cache, topology
from ..core.communication import TorchCommunication, sanitize_comm
from ..nn.data_parallel import _check_module, _loss_and_grads, _shard_batch, _trainable
from ..parallel import fsdp
from .dp_optimizer import DataParallelOptimizer

__all__ = ["ZeroOptimizer"]


def optimizer_factory(optimizer) -> Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]:
    """``params -> Optimizer`` from a ``torch.optim.Optimizer`` (its class
    and defaults) or a callable."""
    if isinstance(optimizer, torch.optim.Optimizer):
        import inspect

        cls = type(optimizer)
        accepted = inspect.signature(cls.__init__).parameters
        defaults = {k: v for k, v in optimizer.defaults.items() if k in accepted}
        return lambda params: cls(params, **defaults)
    if callable(optimizer):
        return optimizer
    raise TypeError(f"optimizer must be a torch.optim.Optimizer or a callable params -> "
                    f"Optimizer, got {type(optimizer)}")


def logical_state(opt: torch.optim.Optimizer, specs: Sequence[Tuple[bool, int, tuple]],
                  comm: TorchCommunication) -> Dict[str, Any]:
    """The topology-independent form of ``opt``'s state over flat chunks:
    ``"<index>/<key>"`` -> value, a chunk-shaped state tensor of a sharded
    parameter gathered (exactly) and unpadded to the parameter's shape,
    anything else on the host as it is. ``specs[i]`` is parameter ``i``'s
    ``(sharded, chunk, shape)``. A collective."""
    out: Dict[str, Any] = {}
    state = opt.state_dict()["state"]
    for i in sorted(state):
        sharded, chunk, shape = specs[i]
        for key in sorted(state[i]):
            value = state[i][key]
            if isinstance(value, torch.Tensor):
                if sharded and tuple(value.shape) == (chunk,):
                    whole = comm.allgather(value.detach(), 0, comm.size * chunk, precision="off")
                    value = fsdp.flat_unshard_leaf(fsdp._host(whole), shape)
                else:
                    value = fsdp._host(value)
            out[f"{i:05d}/{key}"] = value
    return out


def load_logical_state(opt: torch.optim.Optimizer, leaves: Sequence[torch.Tensor],
                       specs: Sequence[Tuple[bool, int, tuple]], logical: Dict[str, Any],
                       comm: TorchCommunication) -> None:
    """Load :func:`logical_state`'s form into ``opt`` (over ``leaves``):
    every state leaf of a sharded parameter re-padded and cut to this
    rank's chunk of this world."""
    state: Dict[int, Dict[str, Any]] = {}
    for name, value in logical.items():
        i, key = name.split("/", 1)
        i = int(i)
        sharded, chunk, shape = specs[i]
        like = leaves[i]
        if isinstance(value, (np.ndarray, torch.Tensor)):
            t = torch.as_tensor(np.asarray(value))
            if t.dim() == 0:
                t = t.clone()  # a step count stays on the host, as torch keeps it
            elif sharded and tuple(t.shape) == tuple(shape):
                t = fsdp._row(t, comm.rank, comm.size, chunk).to(like.device, like.dtype)
            else:
                t = t.to(like.device, like.dtype)
            value = t
        state.setdefault(i, {})[key] = value
    opt.load_state_dict({"state": state, "param_groups": opt.state_dict()["param_groups"]})


def state_bytes(opt: Optional[torch.optim.Optimizer]) -> int:
    """This rank's bytes of an optimizer's state tensors."""
    if opt is None:
        return 0
    return sum(v.numel() * v.element_size() for st in opt.state.values() for v in st.values()
               if isinstance(v, torch.Tensor))


class ZeroOptimizer(DataParallelOptimizer):
    """Optimizer-state sharding over ``comm``'s ranks.

    Parameters
    ----------
    optimizer : torch.optim.Optimizer or callable
        The chunks' optimizer (module docstring); it must be elementwise
        (SGD, momentum, Adam, AdamW, RMSprop...).
    comm : TorchCommunication, optional
        The data-parallel world.
    precision : str, optional
        The gradient reduce-scatter's wire (``off | bf16 | int8 |
        blockwise``), resolved once: the ``HEAT_TPU_COLLECTIVE_PREC`` knob,
        or the cross-node tier's chain under ``HEAT_TPU_HIERARCHICAL=1``.
    """

    def __init__(self, optimizer, comm: Optional[TorchCommunication] = None,
                 precision: Optional[str] = None):
        self._factory = optimizer_factory(optimizer)
        self.torch_optimizer: Optional[torch.optim.Optimizer] = None
        self.optimizer = optimizer
        self.blocking = True
        self.comm = sanitize_comm(comm)
        if topology.active(self.comm.size, self.comm) is not None:
            self._wire = topology.cross_mode(torch.float32, precision)
        else:
            self._wire = collective_prec.effective(torch.float32, precision)
        self._block = collective_prec.block_size()
        self.shards: List[torch.Tensor] = []
        self._names: List[str] = []
        self._specs: List[Tuple[bool, int, tuple]] = []

    # -- state layout -------------------------------------------------------------

    def _chunk(self, numel: int) -> int:
        return fsdp.flat_chunk(numel, self.comm.size, self._wire, self._block)

    def init(self, params) -> "ZeroOptimizer":
        """The sharded state of module ``params``: this rank's flat chunk of
        every trainable parameter and the chunks' optimizer. Returns this
        object (the ``opt_state`` of the steps; site ``zero_opt_init``)."""
        return program_cache.cached_program(
            "zero_opt_init", (type(self.optimizer).__name__, self._wire, self._block),
            lambda: ZeroOptimizer._run_init, comm=self.comm, inline=True)(self, params)

    def _run_init(self, params) -> "ZeroOptimizer":
        comm = self.comm
        named = _trainable(_check_module(params))
        shards = []
        for _, p in named:
            c = self._chunk(p.numel())
            shards.append(fsdp._row(p, comm.rank, comm.size, c).requires_grad_(True))
        self._names = [name for name, _ in named]
        self._specs = [(True, self._chunk(p.numel()), tuple(p.shape)) for _, p in named]
        return self.init_from_shards(shards)

    def init_from_shards(self, flat_params: Sequence[torch.Tensor]) -> "ZeroOptimizer":
        """:meth:`init` for parameters already in the flat layout (each
        rank's ``(chunk,)`` rows, leaf tensors): the optimizer over them."""
        self.shards = list(flat_params)
        self.torch_optimizer = self._factory(self.shards)
        return self

    # -- the sharded step -----------------------------------------------------------

    def _update(self, module: nn.Module, my_grads: Sequence[torch.Tensor]) -> None:
        """Step the chunks with their gradients, then gather every
        parameter back exactly."""
        comm = self.comm
        for shard, g in zip(self.shards, my_grads):
            shard.grad = g.to(shard.dtype)
        self.torch_optimizer.step()
        with torch.no_grad():
            for (_, p), shard in zip(_trainable(module), self.shards):
                shard.grad = None
                whole = comm.allgather(shard.detach(), 0, comm.size * shard.numel(),
                                       precision="off") if comm.size > 1 else shard.detach()
                p.copy_(whole[:p.numel()].view(p.shape))

    def step(self, params=None, opt_state=None, grads: Optional[Dict[str, torch.Tensor]] = None):
        """The :class:`DataParallelOptimizer` form: ``grads`` (name ->
        averaged gradient, the same on every rank) are sliced to this
        rank's chunks, the chunks stepped and the parameters gathered.
        Returns ``(params, opt_state)`` (site ``zero_step``; in place)."""
        return program_cache.cached_program(
            "zero_step", (type(self.optimizer).__name__, self._wire, self._block),
            lambda: ZeroOptimizer._run_step, comm=self.comm, inline=True, donated=True)(
            self, params, opt_state, grads)

    def _run_step(self, params, opt_state, grads: Dict[str, torch.Tensor]):
        module = _check_module(params)
        comm = self.comm
        my = [fsdp._row(grads[name], comm.rank, comm.size, self._chunk(p.numel()))
              for name, p in _trainable(module)]
        self._update(module, my)
        return params, opt_state

    def make_train_step(self, loss_fn: Callable) -> Callable:
        """The ZeRO train step: ``step(params, opt_state, *batch) ->
        (params, opt_state, loss)``. ``loss_fn(module, *batch)`` is the mean
        over the rows it gets; ``batch`` holds this rank's rows
        (:meth:`shard_batch`, DataParallel's step contract). Every gradient is
        reduce-scattered at this object's wire (tiered under
        ``HEAT_TPU_HIERARCHICAL=1``) and divided by the world size, the
        chunks stepped and the parameters gathered. The loss is averaged
        exactly (site ``zero_train_step``; in place)."""
        prog = program_cache.cached_program(
            "zero_train_step", (type(self.optimizer).__name__, self._wire, self._block),
            lambda: ZeroOptimizer._run_train_step, comm=self.comm, inline=True, donated=True)

        def step(params, opt_state, *batch):
            return prog(self, loss_fn, params, opt_state, *batch)

        return step

    def _run_train_step(self, loss_fn: Callable, params, opt_state, *batch):
        comm = self.comm
        p = comm.size
        module = _check_module(params)
        loss, grads = _loss_and_grads(module, loss_fn, batch)
        if p > 1:
            loss = comm.allreduce_flat([loss.reshape(1)], average=True)[0].reshape(())
        my = []
        for g in grads:
            c = self._chunk(g.numel())
            flat = fsdp._flat_padded(g, p, c)
            red = comm.reduce_scatter_flat(flat, precision=self._wire) if p > 1 else flat
            my.append(red[:c] / p if p > 1 else red[:c])
        self._update(module, my)
        return params, opt_state, loss

    def shard_batch(self, *arrays):
        """This rank's rows of each batch array (as
        :meth:`heat_tpu_torch.nn.DataParallel.shard_batch`)."""
        device = self.shards[0].device if self.shards else None
        return _shard_batch(self.comm, arrays, device)

    # -- memory ------------------------------------------------------------------------

    def state_bytes_per_device(self, opt_state=None) -> int:
        """This rank's bytes of the sharded optimizer state (strictly below
        :class:`DataParallelOptimizer`'s for ``p > 1`` and a state that is
        not empty)."""
        return state_bytes(self.torch_optimizer)

    # -- checkpoint / restore -----------------------------------------------------------

    def save_checkpoint(self, path: str, params, opt_state=None) -> str:
        """Checkpoint the parameters and the logical optimizer state (the
        chunks gathered and unpadded: nothing of this world's size is in
        the blobs). Every rank calls it."""
        from .. import resilience

        module = _check_module(params)
        tree = {"params": {name: fsdp._host(p) for name, p in _trainable(module)},
                "opt_state": logical_state(self.torch_optimizer, self._specs, self.comm)}
        return resilience.save_checkpoint(
            tree, path, comm=self.comm,
            extra={"algo": "zero", "wire": self._wire, "opt_keys": sorted(tree["opt_state"])})

    def load_checkpoint(self, path: str, params):
        """Restore a :meth:`save_checkpoint` directory into module
        ``params`` and this object's state, re-padded and re-cut for this
        world (bit for bit across world sizes). Returns ``(params,
        opt_state)``."""
        from .. import resilience

        module = _check_module(params)
        manifest = resilience.checkpoint.load_manifest(path)
        extra = manifest.get("extra", {})
        if extra.get("algo") != "zero":
            raise resilience.CheckpointError(
                f"{path!r} is a {extra.get('algo')!r} checkpoint, not zero")
        named = _trainable(module)
        like = {"params": {name: 0 for name, _ in named},
                "opt_state": {key: 0 for key in extra["opt_keys"]}}
        tree = resilience.load_checkpoint(path, like=like, comm=self.comm)
        with torch.no_grad():
            for name, p in named:
                p.copy_(torch.as_tensor(np.asarray(tree["params"][name])).to(p.device, p.dtype))
        self.init(module)
        load_logical_state(self.torch_optimizer, self.shards, self._specs, tree["opt_state"],
                           self.comm)
        return params, self
