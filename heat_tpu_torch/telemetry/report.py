"""Aggregate telemetry events into the benchmark harness's JSON shape.

The port's counterpart of ``heat_tpu/telemetry/report.py``, with the same
summary shape: :func:`summarize` produces the ``telemetry`` block a
benchmark summary gains when telemetry is on — per-phase
compile/execute/bytes-moved columns keyed by span name:

.. code-block:: json

    {"phases": {"resplit": {"calls": 2, "execute_seconds": 0.01,
                            "bytes_moved": 14336}},
     "compile_seconds": 0.4, "compile_events": 3,
     "traced_collectives": {"all_gather": 1},
     "peak_live_bytes": 1048576, "events": 17}

When the collective auditor (:mod:`.hlo`) recorded any ``hlo_audit``
events (``audit=True`` / ``HEAT_TPU_HLO_AUDIT=1``), the summary also gains
an ``hlo_collectives`` section of the counts and wire bytes of the
collectives the port really issued, next to the analytic ``phases``.

A live summary gains the ``fusion`` block (``core.fusion.stats()``: the
deferred ops, flushes, nodes per flush, fallbacks, absorbed reductions and
grafted epilogues) once any op ran deferred. The ``autotune`` block holds
the tuner's counters (:data:`heat_tpu_torch.autotune.EVENT_COUNTER`
names them, live and in an offline replay alike); the ``autoscale`` names
are the controller's ``EVENT_COUNTER``.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional

__all__ = ["load_events", "summarize", "summarize_cluster", "bench_fields"]

def load_events(path: str) -> List[dict]:
    """Read a JSONL event sink back into a list of event dicts (skips
    blank/truncated lines — the sink is append-only across runs)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def summarize(
    events: Optional[Iterable[dict]] = None,
    watermarks: Optional[dict] = None,
) -> dict:
    """Aggregate events (default: the live registry's) into the per-phase
    summary block documented in the module docstring. Only top-level
    (``depth == 0``) spans become phase rows: a ``resplit`` and the
    ``relayout`` primitive it wraps carry the same analytic cost over the
    same wall-clock window, so counting both would double every byte and
    second a consumer sums across phases. Nesting stays visible in the raw
    stream (each span event carries ``depth``/``parent``); a ``relayout``
    invoked outside any op span is depth 0 and still gets its own row."""
    live = events is None
    if events is None:
        from . import get_registry

        reg = get_registry()
        events = list(reg.events)
        if watermarks is None:
            watermarks = dict(reg.watermarks)

    phases: dict = {}
    serve_rows: dict = {}
    serve_span: list = [None, None]  # [first ts, last ts] of serve traffic
    pc_retraces: dict = {}
    res_events: dict = {}
    at_events: dict = {}
    sn_events: dict = {}
    as_events: dict = {}
    sp_events: dict = {}
    st_events: dict = {}
    tr_spans = 0
    tr_ingress = 0
    st_rows = 0
    st_read_seconds = 0.0
    st_swap_seconds: list = []
    st_roll_seconds: list = []
    st_compiles = 0
    st_max_version = 0
    plan_counts: dict = {}
    hier_rows: dict = {}
    pipe_rows: dict = {}
    pipe_gather_bytes = 0
    pipe_gather_events = 0
    plan_last: Optional[dict] = None
    plan_wire = 0
    pc_evictions = 0
    compile_seconds = 0.0
    compile_events = 0
    traced: dict = {}
    hlo_sites: dict = {}
    hlo_audits = 0
    hlo_drift = 0
    n = 0
    for ev in events:
        n += 1
        kind = ev.get("kind")
        if kind == "span":
            if int(ev.get("depth", 0) or 0) != 0:
                continue
            row = phases.setdefault(
                ev.get("name"),
                {"calls": 0, "execute_seconds": 0.0, "bytes_moved": 0},
            )
            row["calls"] += 1
            row["execute_seconds"] += float(ev.get("seconds", 0.0))
            row["bytes_moved"] += int(ev.get("bytes", 0) or 0)
            if ev.get("collective"):
                row["collective"] = ev["collective"]
        elif kind == "compile":
            compile_seconds += float(ev.get("seconds", 0.0))
            compile_events += 1
        elif kind == "collective_trace":
            name = ev.get("name")
            traced[name] = traced.get(name, 0) + 1
            if ev.get("hier"):
                # tiered-lowering rows: per wrapper, how many
                # hierarchical programs were traced, on what topology,
                # and the analytic per-tier split (total vs DCN bytes —
                # the cross-node stage the DCN premium prices)
                hrow = hier_rows.setdefault(
                    name,
                    {"traced": 0, "topology": ev.get("hier"),
                     "bytes": 0, "dcn_bytes": 0, "wire": {}},
                )
                hrow["traced"] += 1
                hrow["topology"] = ev.get("hier")
                hrow["bytes"] += int(ev.get("bytes", 0) or 0)
                hrow["dcn_bytes"] += int(ev.get("dcn_bytes", 0) or 0)
                w = ev.get("wire") or "off"
                hrow["wire"][w] = hrow["wire"].get(w, 0) + 1
            if name == "pipeline_tick":
                # per-tick schedule spans: one event per tick
                # per traced pipeline.step program — the measured bubble
                # accounting the CI gate reconciles against the analytic
                # ScheduleTable, plus the hop wire/DCN volume per tick
                prow = pipe_rows.setdefault(
                    ev.get("schedule") or "?",
                    {"ticks": 0, "fwd": 0, "bwd": 0, "bubble_cells": 0,
                     "steady_bubble_cells": 0, "stages": 0,
                     "phases": {}, "hop_bytes": 0, "hop_dcn_bytes": 0},
                )
                prow["ticks"] += 1
                prow["stages"] = int(ev.get("stages", 0) or 0)
                prow["fwd"] += int(ev.get("n_fwd", 0) or 0)
                prow["bwd"] += int(ev.get("n_bwd", 0) or 0)
                bub = int(ev.get("bubble", 0) or 0)
                prow["bubble_cells"] += bub
                ph = ev.get("phase") or "?"
                prow["phases"][ph] = prow["phases"].get(ph, 0) + 1
                if ph == "steady":
                    prow["steady_bubble_cells"] += bub
                hops = ev.get("hops")
                hops = 1 if hops is None else int(hops)
                prow["hop_bytes"] += hops * int(ev.get("hop_bytes", 0) or 0)
                prow["hop_dcn_bytes"] += hops * int(
                    ev.get("hop_dcn_bytes", 0) or 0
                )
            elif name == "pipeline_gather":
                pipe_gather_bytes += int(ev.get("bytes", 0) or 0)
                pipe_gather_events += 1
        elif kind == "program_cache":
            if ev.get("event") == "retrace":
                name = ev.get("name")
                pc_retraces[name] = pc_retraces.get(name, 0) + 1
            elif ev.get("event") == "eviction":
                pc_evictions += int(ev.get("count", 1) or 1)
        elif kind == "resilience":
            what = ev.get("event") or "event"
            res_events[what] = res_events.get(what, 0) + 1
        elif kind == "autotune":
            what = ev.get("event") or "event"
            at_events[what] = at_events.get(what, 0) + 1
        elif kind == "serve_net":
            what = ev.get("event") or "event"
            sn_events[what] = sn_events.get(what, 0) + 1
        elif kind == "autoscale":
            what = ev.get("event") or "event"
            as_events[what] = as_events.get(what, 0) + 1
        elif kind == "trace_span":
            # request-trace hops: every hop pairs with the
            # `tracing.spans` counter, every ingress hop with
            # `tracing.sampled` — the live/offline reconciliation pair
            tr_spans += 1
            if ev.get("ingress"):
                tr_ingress += 1
        elif kind == "sparse":
            what = ev.get("event") or "event"
            sp_events[what] = sp_events.get(what, 0) + 1
        elif kind == "streaming":
            what = ev.get("event") or "event"
            st_events[what] = st_events.get(what, 0) + 1
            if what == "stream_chunk":
                st_rows += int(ev.get("rows", 0) or 0)
                st_read_seconds += float(ev.get("seconds", 0.0) or 0.0)
            elif what == "version_swap":
                st_swap_seconds.append(float(ev.get("seconds", 0.0) or 0.0))
                st_compiles += int(ev.get("backend_compiles", 0) or 0)
                st_max_version = max(
                    st_max_version, int(ev.get("version", 0) or 0)
                )
            elif what == "roll_step":
                st_roll_seconds.append(float(ev.get("seconds", 0.0) or 0.0))
        elif kind == "relayout_plan":
            p = ev.get("plan") or ev.get("name")
            plan_counts[p] = plan_counts.get(p, 0) + 1
            plan_wire += int(ev.get("predicted_bytes", 0) or 0)
            plan_last = {
                k: ev.get(k)
                for k in ("plan", "gshape", "src_split", "dst_split",
                          "chunks", "stages", "predicted_bytes",
                          "temp_bytes", "budget", "reason")
                if k in ev
            }
        elif kind in ("serve_request", "serve_batch", "serve"):
            what = ev.get("event")
            if kind == "serve" and what not in ("shed", "batch_failed"):
                continue  # warmup/degrade events are not per-endpoint rows
            row = serve_rows.setdefault(
                ev.get("name"),
                {"requests": 0, "errors": 0, "shed": 0, "batches": 0,
                 "rows": 0, "padded_rows": 0, "latencies": []},
            )
            ts = ev.get("ts")
            if ts is not None:
                if serve_span[0] is None or ts < serve_span[0]:
                    serve_span[0] = ts
                if serve_span[1] is None or ts > serve_span[1]:
                    serve_span[1] = ts
                t0, t1 = row.get("_ts0"), row.get("_ts1")
                if t0 is None or ts < t0:
                    row["_ts0"] = ts
                if t1 is None or ts > t1:
                    row["_ts1"] = ts
            if kind == "serve_request":
                row["requests"] += 1
                if not ev.get("ok", True):
                    row["errors"] += 1
                row["latencies"].append(float(ev.get("seconds", 0.0)))
            elif kind == "serve_batch":
                row["batches"] += 1
                row["rows"] += int(ev.get("rows", 0) or 0)
                row["padded_rows"] += int(ev.get("padded_rows", 0) or 0)
            elif what == "shed":
                row["shed"] += 1
            else:  # batch_failed
                row["errors"] += int(ev.get("requests", 1) or 1)
        elif kind == "hlo_audit":
            hlo_audits += 1
            drift = int(ev.get("drift", 0) or 0)
            hlo_drift += drift
            row = hlo_sites.setdefault(
                ev.get("name"),
                {"audits": 0, "instructions": {}, "wire_bytes": {},
                 "emitted_bytes": 0, "predicted_bytes": 0, "drift": 0},
            )
            row["audits"] += 1
            row["drift"] += drift
            for op, cnt in (ev.get("ops") or {}).items():
                row["instructions"][op] = row["instructions"].get(op, 0) + cnt
            for op, b in (ev.get("bytes_by_op") or {}).items():
                row["wire_bytes"][op] = row["wire_bytes"].get(op, 0) + int(b)
            row["emitted_bytes"] += int(ev.get("emitted_bytes", 0) or 0)
            row["predicted_bytes"] += int(ev.get("predicted_bytes", 0) or 0)
    for row in phases.values():
        row["execute_seconds"] = round(row["execute_seconds"], 6)

    out = {
        "phases": phases,
        "compile_seconds": round(compile_seconds, 6),
        "compile_events": compile_events,
        "traced_collectives": traced,
        "events": n,
    }
    if hier_rows:
        # hierarchy view (core/topology.py): per tiered
        # wrapper, traced-program counts, the (node x local) topology,
        # the analytic total-vs-DCN byte split, and the cross-tier wire
        # modes seen. Absent when no tiered program was traced, so flat
        # summaries keep their exact shape.
        out["hierarchy"] = {
            "collectives": hier_rows,
            "dcn_bytes": sum(r["dcn_bytes"] for r in hier_rows.values()),
            "bytes": sum(r["bytes"] for r in hier_rows.values()),
        }
    if pipe_rows or pipe_gather_events:
        # pipeline view (parallel/pipeline.py): per traced
        # schedule, tick/action/bubble tallies (steady_bubble_cells is
        # the schedule-shaped figure 1f1b cuts), per-tick hop wire and
        # DCN bytes, and the in-stage weight-gather stream. Absent when
        # no pipeline program was traced, so other summaries keep shape.
        out["pipeline"] = {
            "schedules": pipe_rows,
            "gather_bytes": pipe_gather_bytes,
            "gather_events": pipe_gather_events,
        }
    if plan_counts:
        # relayout-planner decisions (core/relayout_planner.py): how many
        # relayouts planned per plan kind, the summed predicted wire
        # bytes, and the last full decision payload. Absent when the
        # planner never armed, so unplanned summaries keep their shape.
        out["relayout_plan"] = {
            "plans": plan_counts,
            "predicted_bytes": plan_wire,
            "last": plan_last,
        }
    if serve_rows:
        # serving view (serve/): per-endpoint QPS and
        # latency percentiles over the event window, batch occupancy,
        # shed/error tallies. QPS spans the endpoint's own first→last
        # event; exact percentiles here (the offline aggregate holds the
        # full latency list — the server's live histogram quantizes).
        # Absent when no serve event was recorded, so non-serving
        # summaries keep their exact shape.
        window = (
            (serve_span[1] - serve_span[0])
            if serve_span[0] is not None else 0.0
        )
        eps = {}
        for name, row in serve_rows.items():
            lats = sorted(row.pop("latencies"))
            # per-endpoint QPS over the ENDPOINT'S own first→last event
            # span (two tenants active at different times must not dilute
            # each other's rate)
            ep_window = (
                (row.pop("_ts1") - row.pop("_ts0"))
                if "_ts0" in row else 0.0
            )

            def q(p, _l=lats):
                return _l[min(len(_l) - 1, int(p * len(_l)))] if _l else None

            out_row = dict(row)
            if lats:
                out_row["p50_s"] = round(q(0.50), 6)
                out_row["p95_s"] = round(q(0.95), 6)
                out_row["p99_s"] = round(q(0.99), 6)
                out_row["mean_s"] = round(sum(lats) / len(lats), 6)
            if row["requests"] and ep_window > 0:
                out_row["qps"] = round(row["requests"] / ep_window, 2)
            if row["batches"]:
                denom = row["rows"] + row["padded_rows"]
                out_row["mean_batch_rows"] = round(
                    row["rows"] / row["batches"], 3
                )
                out_row["occupancy"] = round(
                    row["rows"] / denom if denom else 1.0, 4
                )
            eps[name] = out_row
        out["serving"] = {
            "endpoints": eps,
            "requests": sum(r["requests"] for r in serve_rows.values()),
            "window_seconds": round(window, 4),
        }
        if watermarks and "serve.queue_depth" in watermarks:
            out["serving"]["peak_queue_depth"] = int(
                watermarks["serve.queue_depth"]
            )
    if hlo_audits:
        # ground-truth emitted collectives (telemetry/hlo.py) next to the
        # analytic phases — only present when the auditor actually ran, so
        # non-audited summaries keep their exact shape
        out["hlo_collectives"] = {
            "audits": hlo_audits,
            "drift": hlo_drift,
            "sites": hlo_sites,
        }
    # compiled-program registry counters (core/program_cache.py): live
    # summaries read the registry directly (hit/miss/eviction totals plus
    # per-site retrace counts); offline summaries reconstruct retraces
    # from the recorded instant events. Absent entirely when the registry
    # never ran, so pre-existing summary shapes are unchanged.
    if live:
        from ..core import program_cache as _pc

        pc = _pc.stats()
        if pc["hits"] or pc["misses"]:
            out["program_cache"] = pc
        # the fusion counters (core/fusion.py); absent when no op ran
        # deferred, so fusion-off summaries keep their shape
        from ..core import fusion as _fz

        fz = _fz.stats()
        if (fz["deferred"] or fz["flushes"] or fz["fallbacks"] or fz["reductions_absorbed"]
                or fz["epilogues_grafted"]):
            out["fusion"] = fz
    elif pc_retraces or pc_evictions:
        out["program_cache"] = {
            "retraces": pc_retraces,
            "evictions": pc_evictions,
        }
    # resilience counters (resilience/): live summaries
    # read the registry's aggregate counters (retries/transient_faults/
    # gave_up/faults_injected/...); offline summaries reconstruct per-event
    # counts (retry/inject/gave_up/...) from the recorded instant events.
    # Absent entirely when the subsystem never fired, so fault-free
    # summaries keep their exact shape (the chaos CI step's zero-overhead
    # oracle relies on that).
    if live:
        from . import get_registry as _get_registry

        res = {
            k[len("resilience."):]: (int(v) if float(v).is_integer() else v)
            for k, v in _get_registry().counters.items()
            if k.startswith("resilience.")
        }
        if res:
            out["resilience"] = res
    elif res_events:
        # event name -> live counter name, so offline and live blocks
        # carry the SAME keys; transient_faults is derived (every caught
        # transient emitted either a retry or a gave_up event)
        rename = {
            "retry": "retries",
            "inject": "faults_injected",
            "checkpoint_save": "checkpoints_saved",
        }
        res = {rename.get(k, k): v for k, v in res_events.items()}
        transients = res.get("retries", 0) + res.get("gave_up", 0)
        if transients:
            res["transient_faults"] = transients
        out["resilience"] = res
    # autotune counters (heat_tpu_torch.autotune): live summaries
    # read the registry's aggregate counters (trials/db_hits/stores/
    # adopted/...); offline summaries reconstruct the SAME block from the
    # recorded instant events — every counter increments exactly once
    # alongside its event, so live == offline (the resilience
    # reconciliation contract).
    # Absent entirely when the tuner never fired, so untuned summary
    # shapes are unchanged.
    if live:
        from . import get_registry as _get_registry

        at = {
            k[len("autotune."):]: (int(v) if float(v).is_integer() else v)
            for k, v in _get_registry().counters.items()
            if k.startswith("autotune.")
        }
        if at:
            out["autotune"] = at
    elif at_events:
        from ..autotune import EVENT_COUNTER as _at_names

        out["autotune"] = {
            _at_names.get(k, k): v for k, v in at_events.items()
        }
    # network-serving-tier counters (serve/net/): the
    # router/pool/transport layer emits one `serve_net` event per counter
    # increment (serve/net/events.py), so live summaries (registry
    # counters) and offline sink replays reconstruct the SAME
    # `serving_net` block — the reconciliation contract.
    # Absent entirely when no router/pool ran, so single-process serving
    # summaries keep their exact shape.
    if live:
        from . import get_registry as _get_registry

        sn = {
            k[len("serve_net."):]: (int(v) if float(v).is_integer() else v)
            for k, v in _get_registry().counters.items()
            if k.startswith("serve_net.")
        }
        if sn:
            out["serving_net"] = sn
    elif sn_events:
        from ..serve.net.events import EVENT_COUNTER as _sn_names

        out["serving_net"] = {
            _sn_names.get(k, k): v for k, v in sn_events.items()
        }
    # autoscaling-control-plane counters (serve/net/controller):
    # one `autoscale` event per `autoscale.<name>` counter increment, same
    # live/offline reconciliation contract as serving_net above. Absent
    # when no controller ran.
    if live:
        from . import get_registry as _get_registry

        asc = {
            k[len("autoscale."):]: int(v)
            for k, v in _get_registry().counters.items()
            if k.startswith("autoscale.")
        }
        if asc:
            out["autoscale"] = asc
    elif as_events:
        from ..serve.net.controller import EVENT_COUNTER as _as_names

        out["autoscale"] = {
            _as_names.get(k, k): v for k, v in as_events.items()
        }
    # request-tracing counters: one `trace_span` event per
    # `tracing.spans` increment, one ingress span per `tracing.sampled`,
    # so live summaries and offline sink replays reconstruct the SAME
    # `tracing` block. Absent when no request was traced, so untraced
    # summary shapes are unchanged — and the CI off-run pins exactly
    # this absence.
    if live:
        from . import get_registry as _get_registry

        _c = _get_registry().counters
        tr = {
            "sampled": int(_c.get("tracing.sampled", 0)),
            "spans": int(_c.get("tracing.spans", 0)),
        }
        if tr["sampled"] or tr["spans"]:
            out["tracing"] = tr
    elif tr_spans:
        out["tracing"] = {"sampled": tr_ingress, "spans": tr_spans}
    # sparse-container counters (sparse/): every op
    # pairs one `sparse.<op>` counter with one `sparse` instant event
    # (sparse.EVENT_COUNTER), so live summaries (registry counters) and
    # offline sink replays reconstruct the SAME `sparse` block — the
    # reconciliation contract. Absent entirely when no sparse
    # op ran, so dense-only summary shapes are unchanged.
    if live:
        from . import get_registry as _get_registry

        sm = {
            k[len("sparse."):]: (int(v) if float(v).is_integer() else v)
            for k, v in _get_registry().counters.items()
            if k.startswith("sparse.")
        }
        sm.pop("laplacian_live_bytes", None)  # a watermark key, not a counter
        if sm:
            out["sparse"] = sm
    elif sp_events:
        out["sparse"] = dict(sp_events)
    if watermarks and "sparse.laplacian_live_bytes" in watermarks:
        out.setdefault("sparse", {})["laplacian_live_bytes"] = int(
            watermarks["sparse.laplacian_live_bytes"]
        )
    # streaming counters (streaming/): one
    # `streaming.<counter>` per `streaming` instant event (plus the
    # rows-field fold into `streaming.rows` — streaming/events.py), so
    # live summaries (registry counters) and offline sink replays
    # reconstruct the SAME `streaming` block — the
    # reconciliation contract. Derived fields (rows/s ingested, publish
    # latency, compiles-per-swap, max published version, version lag =
    # the longest roll step, i.e. the widest mixed-version window) come
    # from the events in BOTH modes. Absent entirely when no stream ran,
    # so batch-only summary shapes are unchanged.
    if live:
        from . import get_registry as _get_registry

        st = {
            k[len("streaming."):]: (int(v) if float(v).is_integer() else v)
            for k, v in _get_registry().counters.items()
            if k.startswith("streaming.")
        }
        if st:
            out["streaming"] = st
    elif st_events:
        from ..streaming.events import EVENT_COUNTER as _st_names

        st = {_st_names.get(k, k): v for k, v in st_events.items()}
        if st_rows:
            st["rows"] = st_rows
        out["streaming"] = st
    if st_events and "streaming" in out:
        st = out["streaming"]
        if st_read_seconds > 0:
            st["rows_per_s"] = round(st_rows / st_read_seconds, 3)
        if st_swap_seconds:
            st["update_latency"] = {
                "mean": round(sum(st_swap_seconds) / len(st_swap_seconds), 6),
                "max": round(max(st_swap_seconds), 6),
            }
            st["compiles_per_swap"] = st_compiles
            st["max_version"] = st_max_version
        if st_roll_seconds:
            st["version_lag"] = round(max(st_roll_seconds), 6)
    if watermarks and "streaming.chunk_bytes" in watermarks:
        out.setdefault("streaming", {})["chunk_bytes"] = int(
            watermarks["streaming.chunk_bytes"]
        )
    if watermarks:
        peak = watermarks.get("live_bytes.total")
        if peak is not None:
            out["peak_live_bytes"] = int(peak)
    return out


def summarize_cluster(scrapes, **kwargs) -> dict:
    """Fleet-merged summary over per-replica ``GET /metrics`` scrapes —
    thin alias for :func:`heat_tpu_torch.telemetry.cluster.summarize_cluster`,
    living here so the per-process and fleet reports share
    one import surface."""
    from . import cluster

    return cluster.summarize_cluster(scrapes, **kwargs)


def bench_fields() -> dict:
    """The dict the benchmark harness merges into its summary line:
    ``{"telemetry": summarize()}`` when enabled, ``{}`` otherwise."""
    from . import enabled

    if not enabled():
        return {}
    return {"telemetry": summarize()}
