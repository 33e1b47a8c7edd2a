"""Pipeline parallelism over the ranks (counterpart of ``heat_tpu/parallel/pipeline.py``).

* :func:`pipeline_apply` — the flat GPipe forward: one stage a rank (its
  parameters the rank's row of stacked ``(p, ...)`` leaves), microbatch
  activations hopping rank to rank by ``ppermute`` for ``p + m - 1`` ticks,
  the last rank collecting and one exact sum replicating the output. The
  JAX package's is differentiable as one traced program; this one is a
  forward (training goes through :func:`pipeline_step_program`).
* The schedule-table step behind :class:`heat_tpu_torch.nn.Pipeline`
  (:func:`pipeline_step_program`): ``S`` stages map onto groups of
  ``local = p / S`` consecutive ranks (:class:`~.schedule.StageMapping`);
  inside a stage the weights live flat-sharded ``1/local``
  (:class:`PipelineLayout`: a ``(layers_per_stage, chunk)`` row a leaf) and
  are all-gathered within the stage group just in time; one process a rank
  walks the same static :class:`~.schedule.ScheduleTable` (``gpipe`` or
  ``1f1b``) tick by tick. A forward tick runs the stage without recording a
  graph and stashes only the microbatch's input activation; a backward
  tick gathers the weights again, recomputes the stage's forward from the
  stashed input and takes its vector-Jacobian product: that recompute is
  the rematerialization, one forward a layer more than the forward tick's
  (``remat=True`` also checkpoints each layer inside it, as the JAX
  package's ``jax.checkpoint`` does: a third forward a layer, for a stage
  whose activations of one microbatch would not fit). After every tick but
  the last the activations hop one stage forward and the cotangents one
  stage back along the full ring of ``fwd_perm``/``bwd_perm``, each a
  matched ``batch_isend_irecv`` on every rank in the same tick order (the
  wraparound pair carries nothing used, as in the JAX package, so the cost
  model's pairs are the pairs issued). Each stage accumulates its gradient
  in increasing microbatch order under both schedules, so ``1f1b`` is
  ``gpipe`` bit for bit.

Compute inside a stage is replicated across its ``local`` ranks (weights
sharded, activations not): each member slices its own chunk of the
gradient, and a checkpoint restores bit for bit on another ``node x local``
factorization.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import telemetry
from ..core import program_cache
from ..telemetry import collectives as _coll
from . import schedule as _schedule

__all__ = [
    "PipelineLayout",
    "pipeline_apply",
    "pipeline_step_program",
    "plan_pipeline",
    "shard_pipeline_params",
    "shard_state_rows",
    "stack_stage_params",
    "unshard_pipeline_params",
    "unshard_state_rows",
]


def stack_stage_params(params_list: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-stage parameter dicts stacked along a new leading stage axis."""
    return {name: torch.stack([torch.as_tensor(p[name]) for p in params_list])
            for name in params_list[0]}


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stacked_params,
                   x: torch.Tensor, *, comm, n_microbatches: int) -> torch.Tensor:
    """``stage_{p-1} ∘ … ∘ stage_0`` of ``x`` by the GPipe schedule, one
    stage a rank. ``stage_fn(params, h) -> h`` keeps the activation's
    shape; ``stacked_params`` is a dict of ``(p, ...)`` leaves (every rank
    uses its row); ``x`` the whole batch, the same on every rank, its rows
    divisible into ``n_microbatches``. Returns the whole output on every
    rank (no gradient; site ``pipeline.apply``)."""
    return program_cache.cached_program(
        "pipeline.apply", (stage_fn, int(n_microbatches)), lambda: _apply_program, comm=comm,
        inline=True)(stage_fn, stacked_params, x, comm, int(n_microbatches))


def _apply_program(stage_fn: Callable, stacked_params, x: torch.Tensor, comm,
                   m: int) -> torch.Tensor:
    """The GPipe forward of :func:`pipeline_apply`."""
    p = comm.size
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    bad = sorted({tuple(v.shape[:1]) for v in stacked_params.values()
                  if tuple(v.shape[:1]) != (p,)})
    if bad:
        raise ValueError(f"stacked_params leaves carry leading dims {bad} for a {p}-rank world; "
                         "exactly one stage a rank is required")
    params = {name: v[comm.rank] for name, v in stacked_params.items()}
    micro = x.reshape((m, b // m) + tuple(x.shape[1:]))
    fwd_perm = [(i, (i + 1) % p) for i in range(p)]
    s = comm.rank
    with torch.no_grad():
        act = torch.zeros_like(micro[0])
        out = torch.zeros_like(micro)
        for t in range(p + m - 1):
            if s == 0 and t < m:
                act = micro[t]
            mth = t - s
            active = 0 <= mth < m
            h = stage_fn(params, act) if active else act
            if s == p - 1 and active:
                out[mth] = h
            act = comm.ppermute(h.contiguous(), fwd_perm, precision="off")
        out = comm.allreduce(out, precision="off")
    return out.reshape((b,) + tuple(x.shape[1:]))


# -- the schedule-table step ------------------------------------------------------------


@dataclass(frozen=True)
class PipelineLayout:
    """The chunked stage-layer layout of :class:`heat_tpu_torch.nn.Pipeline`:
    ``n_layers`` homogeneous layers, ``n_layers / n_stages`` a stage; leaf
    ``k`` (``names[k]``, logical ``shapes[k]``) lives on rank ``(s, l)`` as
    a ``(layers_per_stage, chunk_k)`` row: the ``l``-th ``chunk_k =
    ceil(numel_k / local)`` slice of the flattened leaf (zero-padded) of
    each of stage ``s``'s layers."""

    p: int
    n_stages: int
    n_layers: int
    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    wire: str

    @property
    def local(self) -> int:
        return self.p // self.n_stages

    @property
    def layers_per_stage(self) -> int:
        return self.n_layers // self.n_stages

    def numel(self, k: int) -> int:
        n = 1
        for d in self.shapes[k]:
            n *= int(d)
        return n

    def chunk(self, k: int) -> int:
        return -(-self.numel(k) // self.local)

    def row_shapes(self) -> set:
        return {(self.layers_per_stage, self.chunk(k)) for k in range(len(self.shapes))}

    def signature(self) -> tuple:
        return (self.p, self.n_stages, self.n_layers, self.names, self.shapes, self.dtypes,
                self.wire)

    def bytes_per_device(self) -> int:
        return sum(self.layers_per_stage * self.chunk(k)
                   * torch.empty((), dtype=getattr(torch, self.dtypes[k])).element_size()
                   for k in range(len(self.shapes)))


def _layer_leaves(layer) -> Dict[str, Any]:
    if isinstance(layer, torch.nn.Module):
        return dict(layer.named_parameters())
    return dict(layer)


def plan_pipeline(layer_params: Sequence[Any], mapping: _schedule.StageMapping,
                  wire: str = "off") -> PipelineLayout:
    """The layout of a logical per-layer list (dicts name -> tensor, or
    modules). The layers must be homogeneous (one set of names, shapes and
    types). ``wire`` is the in-stage gather's: ``off`` or ``bf16``; the
    int8 and blockwise modes coerce to bf16 (their chunk-dependent
    quantization would break the elastic restore), as in the JAX package."""
    layers = [_layer_leaves(layer) for layer in layer_params]
    n_layers = len(layers)
    if n_layers == 0:
        raise ValueError("need at least one layer")
    if n_layers % mapping.n_stages:
        raise ValueError(f"{n_layers} layers do not divide into {mapping.n_stages} equal stages")
    names = tuple(layers[0])
    shapes = tuple(tuple(int(d) for d in torch.as_tensor(layers[0][n]).shape) for n in names)
    dtypes = tuple(str(torch.as_tensor(layers[0][n]).dtype).replace("torch.", "") for n in names)
    for j, layer in enumerate(layers[1:], start=1):
        if tuple(layer) != names or tuple(
                tuple(int(d) for d in torch.as_tensor(layer[n]).shape) for n in names) != shapes:
            raise ValueError(f"layer {j} is not homogeneous with layer 0 (pipeline stages must "
                             "share one parameter signature)")
    if wire in ("int8", "blockwise"):
        wire = "bf16"
    if wire not in ("off", "bf16"):
        raise ValueError(f"unsupported pipeline gather wire {wire!r}")
    return PipelineLayout(mapping.p, mapping.n_stages, n_layers, names, shapes, dtypes, wire)


def _position(layout: PipelineLayout, rank: int) -> Tuple[int, int]:
    return rank // layout.local, rank % layout.local


def _rows_of(flat_layers: torch.Tensor, layout: PipelineLayout, rank: int, chunk: int):
    """Rank ``rank``'s ``(lps, chunk)`` row of an ``(L, local * chunk)``
    stack of flattened, padded layers."""
    s, l = _position(layout, rank)
    lps = layout.layers_per_stage
    return flat_layers[s * lps:(s + 1) * lps, l * chunk:(l + 1) * chunk]


def _stack_padded(values: Sequence[torch.Tensor], numel: int, width: int) -> torch.Tensor:
    flat = torch.stack([torch.as_tensor(v).detach().reshape(-1) for v in values])
    if width != numel:
        flat = torch.nn.functional.pad(flat, (0, width - numel))
    return flat


def shard_pipeline_params(layer_params: Sequence[Any], layout: PipelineLayout,
                          comm) -> Dict[str, torch.Tensor]:
    """Logical per-layer list (the same on every rank) -> this rank's
    persistent ``(layers_per_stage, chunk)`` rows, name -> leaf tensor."""
    layers = [_layer_leaves(layer) for layer in layer_params]
    out = {}
    for k, name in enumerate(layout.names):
        c = layout.chunk(k)
        flat = _stack_padded([layer[name] for layer in layers], layout.numel(k), layout.local * c)
        out[name] = _rows_of(flat, layout, comm.rank, c).clone().contiguous()
    return out


def _all_rows(row: torch.Tensor, comm) -> np.ndarray:
    """Every rank's row, stacked ``(p, lps, chunk)``, on the host."""
    from .fsdp import _host

    return _host(comm.gather_stack(row.detach().contiguous()) if comm.size > 1 else row[None])


def unshard_state_rows(rows, layout: PipelineLayout, numel: int, shape) -> np.ndarray:
    """One leaf's ``(p, lps, chunk)`` rows -> the stacked logical
    ``(n_layers, *shape)``."""
    lps, loc, S = layout.layers_per_stage, layout.local, layout.n_stages
    rows = np.asarray(rows)
    chunk = rows.shape[-1]
    flat = (rows.reshape(S, loc, lps, chunk).transpose(0, 2, 1, 3)
            .reshape(layout.n_layers, loc * chunk))
    return flat[:, :numel].reshape((layout.n_layers,) + tuple(shape))


def unshard_pipeline_params(params: Dict[str, torch.Tensor], layout: PipelineLayout,
                            comm) -> List[Dict[str, np.ndarray]]:
    """Persistent rows -> the logical per-layer list of numpy dicts (the
    checkpoint form). A collective."""
    per_layer: List[Dict[str, np.ndarray]] = [{} for _ in range(layout.n_layers)]
    for k, name in enumerate(layout.names):
        logical = unshard_state_rows(_all_rows(params[name], comm), layout, layout.numel(k),
                                     layout.shapes[k])
        for j in range(layout.n_layers):
            per_layer[j][name] = logical[j]
    return per_layer


def shard_state_rows(logical, layout: PipelineLayout, comm) -> torch.Tensor:
    """A stacked logical ``(n_layers, *shape)`` state leaf -> this rank's
    ``(lps, chunk)`` row."""
    t = torch.as_tensor(np.asarray(logical))
    numel = int(np.prod(t.shape[1:], dtype=np.int64))
    chunk = -(-numel // layout.local)
    flat = _stack_padded(list(t.reshape(layout.n_layers, numel)), numel, layout.local * chunk)
    return _rows_of(flat, layout, comm.rank, chunk).clone().contiguous()


class _StageGather:
    """One leaf chunk's all-gather within the stage group (the in-stage
    FSDP tier): issued asynchronously at construction, the logical leaf
    from :meth:`take`."""

    def __init__(self, chunk: torch.Tensor, group_comm, p: int, wire: str, numel: int, shape,
                 dtype: torch.dtype):
        self._numel, self._shape, self._dtype = numel, shape, dtype
        loc = group_comm.size
        if loc == 1:
            self._out = chunk
            return
        lossy = wire == "bf16" and chunk.is_floating_point()
        payload = (chunk.to(torch.bfloat16) if lossy else chunk).contiguous()
        telemetry.trace_event("pipeline_gather", wire="bf16" if lossy else "off",
                              collective="all-gather",
                              bytes=p * (loc - 1) * chunk.numel() * payload.element_size(),
                              group=f"{p // loc}x{loc}")
        self._out = group_comm.gather_stack(payload, "all_gather", async_op=True)

    def take(self) -> torch.Tensor:
        if not torch.is_tensor(self._out):
            self._out = self._out.wait()
        return self._out.reshape(-1)[:self._numel].reshape(self._shape).to(self._dtype)


def pipeline_step_program(layer_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor],
                                             torch.Tensor],
                          layout: PipelineLayout, mapping: _schedule.StageMapping,
                          table: _schedule.ScheduleTable, *, comm,
                          loss_fn: Optional[Callable] = None, prefetch: int = 0,
                          remat: bool = False) -> Callable:
    """The schedule-table step (module docstring).

    Training tables (with ``loss_fn(out, y) -> scalar``, the mean over a
    microbatch) return ``step(params, opt_state, micro_x, micro_y) ->
    (params, opt_state, loss)``: ``params`` this rank's rows (name ->
    ``(lps, chunk)`` leaf), ``opt_state`` a ``torch.optim`` optimizer over
    them, ``micro_*`` the microbatch-major ``(M, mb, ...)`` batch, the same
    on every rank; the loss is the sum of the microbatches' ``loss / M``,
    exact on every rank. Forward tables return ``fwd(params, micro_x) ->
    (M, mb, ...)`` on every rank. ``prefetch`` issues a layer's gathers
    ``prefetch`` layers ahead in a forward tick. ``remat`` checkpoints each
    layer inside the backward tick's recompute (module docstring).

    The step is the registry program of site ``pipeline.step``, keyed on
    everything it is built from: a second call with the same functions,
    layout, mapping and table returns the same program (a training step
    changes the parameters and the optimizer in place)."""
    key = (layer_fn, loss_fn, layout.signature(), mapping.describe(), table.name, table.train,
           table.n_stages, table.n_microbatches, int(prefetch), bool(remat))
    return program_cache.cached_program(
        "pipeline.step", key,
        lambda: _build_step_program(layer_fn, layout, mapping, table, comm=comm,
                                    loss_fn=loss_fn, prefetch=prefetch, remat=remat),
        comm=comm, inline=True, donated=table.train)


def _build_step_program(layer_fn, layout: PipelineLayout, mapping: _schedule.StageMapping,
                        table: _schedule.ScheduleTable, *, comm, loss_fn, prefetch: int,
                        remat: bool) -> Callable:
    """The step or forward callable of :func:`pipeline_step_program`."""
    train = table.train
    if train and loss_fn is None:
        raise ValueError("training tables need loss_fn")
    p, S, M = layout.p, mapping.n_stages, table.n_microbatches
    loc, lps = mapping.local, layout.layers_per_stage
    K = table.stash_depth()
    fwd_tab, bwd_tab = table.action_arrays()
    fwd_perm, bwd_perm = mapping.fwd_perm(), mapping.bwd_perm()
    names, depth = layout.names, int(prefetch)
    sI, mI = _position(layout, comm.rank)
    if loc > 1:
        from ..core.topology import Topology

        group_comm, _ = comm.tiers(Topology(S, loc))
    else:
        group_comm = None
    leaf_item = torch.empty((), dtype=getattr(torch, layout.dtypes[0])).element_size()

    def issue(pleaves, j) -> Dict[str, Any]:
        if group_comm is None:
            return {name: pleaves[name].detach()[j] for name in names}
        return {name: _StageGather(pleaves[name].detach()[j], group_comm, p, layout.wire,
                                   layout.numel(k), layout.shapes[k], pleaves[name].dtype)
                for k, name in enumerate(names)}

    def weights(pending) -> Dict[str, torch.Tensor]:
        if group_comm is None:
            return {name: pending[name].reshape(-1)[:layout.numel(k)].reshape(layout.shapes[k])
                    for k, name in enumerate(names)}
        return {name: pending[name].take() for name in names}

    def stage_forward(pleaves, h):
        ahead = {}
        for j in range(lps):
            for a in range(j, min(j + depth, lps - 1) + 1):
                if a not in ahead:
                    ahead[a] = issue(pleaves, a)
            h = layer_fn(weights(ahead.pop(j)), h)
        return h

    def apply_gathered(ws, h):
        for w in ws:
            h = (checkpoint(layer_fn, w, h, use_reentrant=False) if remat else layer_fn(w, h))
        return h

    def chunk_of(g: torch.Tensor, k: int) -> torch.Tensor:
        c = layout.chunk(k)
        flat = g.reshape(-1)
        if loc * c != flat.numel():
            flat = torch.nn.functional.pad(flat, (0, loc * c - flat.numel()))
        return flat[mI * c:(mI + 1) * c]

    def emit_tick_events(t: int, mb_numel: int) -> None:
        from ..core import topology as _topo

        frow, brow = fwd_tab[t], bwd_tab[t]
        busy = sum(1 for s in range(S) if frow[s] >= 0 or brow[s] >= 0)
        active = _topo.active(p, comm)
        hop = _coll.pipeline_hop_cost(1, mb_numel, leaf_item, p, stride=loc,
                                      local=active.local if active is not None else None)
        telemetry.trace_event(
            "pipeline_tick", tick=t, schedule=table.name, phase=table.phase_of(t), stages=S,
            n_fwd=sum(1 for v in frow if v >= 0), n_bwd=sum(1 for v in brow if v >= 0),
            bubble=S - busy, hops=(2 if train else 1) if t < table.n_ticks - 1 else 0,
            **{f"hop_{k}": v for k, v in hop.as_fields().items()})

    def run(params, opt_state, micro_x, micro_y):
        mb_shape = tuple(micro_x.shape[1:])
        mb_numel = int(np.prod(mb_shape, dtype=np.int64))
        dev, dt = micro_x.device, micro_x.dtype
        fwd_in = torch.zeros(mb_shape, dtype=dt, device=dev)
        bwd_in = torch.zeros(mb_shape, dtype=dt, device=dev)
        stash = torch.zeros((K,) + mb_shape, dtype=dt, device=dev)
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        out = torch.zeros_like(micro_x) if not train else None
        grad_acc = {name: torch.zeros_like(params[name]) for name in names} if train else None
        for t in range(table.n_ticks):
            emit_tick_events(t, mb_numel)
            my_f, my_b = fwd_tab[t][sI], bwd_tab[t][sI]
            h_out = fwd_in
            if my_f >= 0:
                h_in = micro_x[my_f] if sI == 0 else fwd_in
                stash[my_f % K] = h_in
                with torch.no_grad():
                    h_out = stage_forward(params, h_in)
                if not train and sI == S - 1 and mI == 0:
                    out[my_f] = h_out
            dx_out = bwd_in
            if train and my_b >= 0:
                x_in = stash[my_b % K].detach()
                ws = [{n: w.detach().requires_grad_(w.is_floating_point())
                       for n, w in weights(issue(params, j)).items()} for j in range(lps)]
                wants_dx = sI > 0 and x_in.is_floating_point()
                x_in = x_in.requires_grad_(wants_dx)
                wrt = [w[n] for w in ws for n in names] + ([x_in] if wants_dx else [])
                with torch.enable_grad():
                    h = apply_gathered(ws, x_in)
                    if sI == S - 1:
                        lval = loss_fn(h, micro_y[my_b]) / M
                        grads = torch.autograd.grad(lval, wrt, allow_unused=True)
                        loss_acc = loss_acc + lval.detach().float()
                    else:
                        grads = torch.autograd.grad(h, wrt, grad_outputs=bwd_in,
                                                    allow_unused=True)
                dx_out = grads[-1] if wants_dx else torch.zeros_like(bwd_in)
                for k, name in enumerate(names):
                    upd = torch.stack([
                        chunk_of(torch.zeros_like(ws[j][name]) if grads[j * len(names) + k]
                                 is None else grads[j * len(names) + k], k)
                        for j in range(lps)])
                    grad_acc[name] = grad_acc[name] + upd.to(grad_acc[name].dtype)
            if t < table.n_ticks - 1:
                recv_f = comm.ppermute(h_out.detach().contiguous(), fwd_perm, precision="off")
                if sI > 0 and fwd_tab[t][sI - 1] >= 0:
                    fwd_in = recv_f
                if train:
                    recv_b = comm.ppermute(dx_out.detach().to(dt).contiguous(), bwd_perm,
                                           precision="off")
                    if sI < S - 1 and bwd_tab[t][sI + 1] >= 0:
                        bwd_in = recv_b
        if not train:
            return comm.allreduce(out, precision="off") if comm.size > 1 else out
        for name in names:
            params[name].grad = grad_acc[name]
        opt_state.step()
        for name in names:
            params[name].grad = None
        mine = loss_acc if (sI == S - 1 and mI == 0) else torch.zeros_like(loss_acc)
        loss = comm.allreduce(mine.reshape(1).clone(), precision="off")[0]
        return params, opt_state, loss

    if train:
        return run
    return lambda params, micro_x: run(params, None, micro_x, None)
