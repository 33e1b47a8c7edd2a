"""Attention cores, the ring and halo schedules, and the scale-out layouts
(counterpart of ``heat_tpu/parallel``): the plain blockwise
``local_attention``, the ``flash_attention`` kernel, the sequence-parallel
``ring_attention`` and ``ulysses_attention``, ``ring_pipeline``,
``halo_exchange`` and ``halo_stencil``; the FSDP and ZeRO layouts
(:mod:`.fsdp`: ``PartitionRules``, ``plan_partition``, ``fsdp_gather``...),
the pipeline schedule tables (:mod:`.schedule`) and the pipeline step
(:mod:`.pipeline`). The JAX package's ``constrain_pytree`` has no
counterpart (an eager program holds each value where it was made)."""

from . import fsdp, pipeline, schedule
from .attention import local_attention, ring_attention, ulysses_attention
from .cuda_attention import flash_attention
from .fsdp import (FsdpLeaf, FsdpPlan, PartitionRules, fsdp_gather, fsdp_shard, fsdp_unshard,
                   leaf_paths, plan_partition, replicate_pytree, shard_pytree)
from .halo import halo_exchange, halo_stencil
from .pipeline import (PipelineLayout, pipeline_apply, pipeline_step_program, plan_pipeline,
                       shard_pipeline_params, stack_stage_params, unshard_pipeline_params)
from .ring import ring_pipeline
from .schedule import (ScheduleTable, StageMapping, build_schedule, gpipe_schedule,
                       one_f1b_schedule, plan_stages, resolve_schedule_name)

__all__ = ["FsdpLeaf", "FsdpPlan", "PartitionRules", "PipelineLayout", "ScheduleTable",
           "StageMapping", "build_schedule", "flash_attention", "fsdp_gather", "fsdp_shard",
           "fsdp_unshard", "gpipe_schedule", "halo_exchange", "halo_stencil", "leaf_paths",
           "local_attention", "one_f1b_schedule", "pipeline_apply", "pipeline_step_program",
           "plan_partition", "plan_pipeline", "plan_stages", "replicate_pytree",
           "resolve_schedule_name", "ring_attention", "ring_pipeline", "shard_pipeline_params",
           "shard_pytree", "stack_stage_params", "ulysses_attention", "unshard_pipeline_params"]
