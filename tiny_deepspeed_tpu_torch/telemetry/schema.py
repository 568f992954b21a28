# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The JSONL metrics schema: one source of truth for what a run's metrics
file may contain.

A copy of `tiny_deepspeed_tpu/telemetry/schema.py` below this docstring
(the port imports nothing of the JAX package; three history comments
reworded): the same record kinds, fields, types, validator and
`SCHEMA_VERSION`, so a metrics file the
port writes (`utils.profiling.MetricsLogger`, `telemetry.Telemetry`)
validates under this module and under JAX's, and the JAX package's
`scripts/report_run.py` reads it.

Two record classes share a file:

  * step records   — `MetricsLogger.log(step, **fields)`:
                     {"step": int, "ts": float, ...optional fields}
  * meta records   — `MetricsLogger.log_meta(kind=..., **fields)`:
                     {"kind": one of META_KINDS, "ts": float,
                      ...optional fields}

`validate_record` / `validate_file` check a record or a file against
it.  The port writes a subset: step records and the `flight`,
`straggler` and `telemetry_summary` meta kinds.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

_NUM = (int, float)

# Version of this schema, stamped into every `run_meta` record
# (Telemetry.run_meta / bench.py's sidecar).  Bump it when record kinds or
# fields change so `report_run.py --check` can WARN when a file was
# written by a different schema vintage (a mismatch is advisory — the
# field-level validation below is what hard-fails).
#   1: step + run_meta/telemetry_summary records (the in-step telemetry)
#   2: + trace / flight / straggler meta kinds, schema_version stamp,
#      per-layer health fields
#   3: + resume / fault meta kinds (resilience subsystem: elastic resume
#      reports, chaos fault-injection log) and checkpoint gauges
#   4: + request meta kind (serving tier per-request latency records)
#      and the serve_* gauges
#   5: + serving robustness: request records carry the terminal `status`
#      (ok/shed/expired/failed) + optional deadline_s; fault records may
#      carry a `slot`; serve_shed / serve_expired / serve_quarantined /
#      serve_restarts gauges
#   6: + serving observability: `tick` meta kind (per-tick wall
#      split + scheduler counters), request records grow the lifecycle
#      `events` timeline and the latency attribution components
#      (lat_s / comp_*_s), run_meta may carry the `serve` config dict
#      (what the trace viewer needs to lay out slot tracks), and the
#      dcn_wire_bytes gauge (per-link ICI-vs-DCN ledger split)
#   7: + speculative decoding: tick records carry the drafter
#      wall `draft_s` (the draft-vs-verify split; decode_s/fetch_s are
#      the verify side), request records carry spec_proposed /
#      spec_accepted (per-request draft yield), and the
#      serve_spec_accept_rate / serve_spec_tokens_per_tick gauges —
#      all emitted ONLY by spec-enabled engines, so spec-off files are
#      byte-compatible with v6 readers
#   8: + fleet serving: request / tick / fault records carry
#      `replica_id` when the writing engine has one (a whole fleet
#      shares one metrics stream), request records of disaggregated
#      runs carry kv_migration_bytes / kv_migration_link (the priced
#      prefill->decode paged-KV handoff: measured payload bytes and the
#      wire_link_split granule classification "ici"/"dcn"), and the
#      fleet_dispatch / fleet_failover / fleet_replicas_live router
#      gauges — all emitted only by fleet/disagg runs, so single-engine
#      files stay byte-compatible with v7 readers
#   9: + multi-tenant serving & shared-prefix KV reuse: request records
#      carry `tenant` (the submitting tenant id, when tagged) and, on
#      prefix-cache engines, prefix_blocks / prefix_tokens (blocks
#      aliased from the radix tree / prompt tokens whose prefill the
#      aliases avoided, cumulative over the request's admissions);
#      fault records of the chaos `tenant_flood` kind ride the
#      existing fields; the serve_prefix_* gauges (hit rate, blocks
#      aliased, tokens avoided, cached blocks, refcount-measured pool
#      bytes saved) and serve_tenants_active — all emitted only by
#      prefix/tenant-configured engines, so plain serving files stay
#      byte-compatible with v8 readers
#  10: + kernels & end-to-end autotuning: run_meta records may carry
#      `autotune` (a RuntimeAutoTuner decision/failure — candidate
#      ranking with measured microseconds, or a refused candidate —
#      and bench's tune_e2e plan summary), and the
#      autotune_candidate_failures gauge mirrors the counter of
#      candidates that refused their shapes — emitted only when tuner
#      diagnostics are attached, so tuner-less files stay
#      byte-compatible with v9 readers
#  11: + the in-scan collective scheduler (parallel/schedule.py): on
#      engines whose schedule lowers to the composed multi-slot machine,
#      capture_compiled additionally gauges the per-slot overlap view —
#      sched_gather_overlap_frac / sched_grad_overlap_frac (loop-resident
#      wire per slot family on the MERGED program) — and under hpZ the
#      hpz_dcn_wire_bytes gauge (the loop-resident all-gather wire that
#      crosses a DCN granule: ~zero when the secondary weight partition
#      keeps every in-scan gather intra-slice, ZeRO++ arXiv:2306.10209);
#      run_meta's comm_measured gains gather_link_split_in_loops under
#      `wire_bytes_by_link_in_scan_gather` on hybrid meshes — all
#      emitted only by scheduler-composed engines, so single-slot files
#      stay byte-compatible with v10 readers
#  12: + the HLO cost ledger (utils/hlo_cost.py): capture_compiled
#      additionally gauges hlo_flops / hlo_hbm_bytes (compute FLOPs and
#      modeled HBM traffic counted from the compiled step's post-SPMD
#      HLO, loop-multiplied), arithmetic_intensity (their ratio), and —
#      when step timings exist — step_mfu_hlo (HLO-counted MFU, the
#      measured-numerator replacement for the 6N hand formula);
#      run_meta may carry `hlo_cost` (the cost_summary: totals, roofline
#      bound verdict, top cost centers) and `flops_per_token_matmul`
#      (bench's analytic accounting, kept alongside for drift checks:
#      scripts/perf_diff.py flags modeled-vs-measured MFU divergence),
#      and trace records may carry `compute_spans` (per-layer FLOP-sized
#      schematic spans from the ledger's loop attribution, rendered by
#      trace_view next to the wire-sized collective spans) — all
#      emitted only when the cost ledger ran, so older files stay
#      byte-compatible with v11 readers
#  13: + the wire agenda close-out (quantized ZeRO-3 tail + qwZ hpZ
#      rebuild, parallel/schedule.py): composed engines additionally
#      gauge zero3_tail_wire_bytes (the once-per-step OUTSIDE-loop
#      reduce wire = the tail release, emitted when grad_comm_tail is
#      quantized) and hpz_rebuild_dcn_bytes (the hpZ secondary
#      rebuild's inter-granule all-gather wire isolated by exact
#      replica-group match, utils/hlo_comm.group_wire_outside_loops —
#      ~4x lower under hpz_comm='fp8', ZeRO++ arXiv:2306.10209);
#      run_meta's comm_model may carry zero3_tail_release_bytes /
#      hpz_rebuild_bytes (the modeled counterparts) and autotune plans
#      may carry the comm knob space (grad_comm/grad_buckets/
#      grad_comm_tail/gather_groups/hpz/hpz_comm) — all emitted only
#      by engines running the new knobs, so older files stay
#      byte-compatible with v12 readers
#  14: + the table-driven pipeline schedules (parallel/pipe_schedule.py):
#      engines running pipeline_schedule='interleaved:V'/'zbub[:V]'
#      additionally gauge bubble_frac (idle-tick fraction of the
#      compiled (tick, stage) program — the schedule-occupancy number
#      the interleaved/zero-bubble lowerings exist to shrink below
#      1F1B's (S-1)/(M+S-1)) and pipe_ticks (the program length), and
#      trace records may carry `pipe` (the per-stage tick occupancy
#      rows rendered as the trace viewer's pipeline track) — all
#      emitted only when a pipe program compiled, so older files stay
#      byte-compatible with v13 readers
#  15: + the live observability plane (telemetry/live.py / slo.py):
#      request records carry `trace_id` (stamped at submit, surviving
#      disagg prefill->decode migration, fleet failover adoption and
#      journal recovery — the cross-engine correlation key) and, on
#      migrated requests, comp_migrate_s (export->import wait billed to
#      migration instead of queue; the components still partition
#      lat_s); the new `slo` meta kind records per-tenant error-budget
#      snapshots (windows / tenants / attainment / alerts, written by
#      the engine when a burn-rate alert fires); gauges written by
#      replica-tagged engines are keyed `name{replica=N}` (the registry
#      labels them via live.gauge_key, replacing the earlier last-writer-
#      wins shared gauges) — all emitted only by live/SLO-configured or
#      fleet runs, so plain serving files stay byte-compatible with
#      v14 readers
SCHEMA_VERSION = 15

# step-record fields beyond the required step/ts; values are allowed types
STEP_FIELDS: Dict[str, tuple] = {
    "loss": _NUM,
    "step_s": _NUM,
    "tokens_per_s": _NUM,
    "val_loss": _NUM,
    # on-device health vector (telemetry/health.py)
    "grad_norm": _NUM,
    "update_norm": _NUM,
    "param_norm": _NUM,
    "nonfinite_grads": _NUM,
    # wall-segment breakdown (StepTimer.mark)
    "data_s": _NUM,
    "h2d_s": _NUM,
    "compute_s": _NUM,
    # lowerings paid by this step (first compile / recompile attribution)
    "compiled": int,
    # HBM watermarks (Telemetry.sample_memory; TPU runtime only)
    "hbm_gb_in_use": _NUM,
    "hbm_gb_peak": _NUM,
    # one-shot anomaly xprof capture location
    "anomaly_trace": str,
}

META_KINDS = (
    "run_meta", "telemetry_summary",
    # schematic collective span template from the compiled step's HLO
    # ledger (telemetry/trace.py; rendered by scripts/trace_view.py)
    "trace",
    # flight-recorder flush: the last N steps' health vectors + wall
    # segments (+ per-layer health), written when the anomaly detector
    # fires (telemetry/flight.py)
    "flight",
    # multi-host straggler attribution (Telemetry.sample_stragglers)
    "straggler",
    # elastic-resume report: which checkpoint was restored onto which
    # mesh, what was re-derived (resilience/elastic.py::elastic_load)
    "resume",
    # chaos fault-injection log: one record per injected fault
    # (resilience/chaos.py), and straggler-rebalance mitigation events
    "fault",
    # serving tier: one record per FINISHED request — queueing, TTFT and
    # decode-rate latency breakdown (serving/engine.py::_finish)
    "request",
    # serving tier: one record per SAMPLED/EVENTFUL scheduler tick —
    # wall split (host scheduling vs prefill vs decode dispatch vs token
    # fetch), occupancy/pool/queue state, and per-tick scheduler counts
    # (serving/engine.py::tick; event-triggered + sampled emission so a
    # long-running server's metrics file stays bounded)
    "tick",
    # serving tier: per-tenant SLO error-budget snapshot (telemetry/
    # slo.py::SLOTracker.record) — multi-window burn rates, attainment
    # and the alerts that fired; written by the engine when a burn-rate
    # alert transitions to firing
    "slo",
)

META_FIELDS: Dict[str, tuple] = {
    "engine": str,
    "stage": int,
    "devices": int,
    # SCHEMA_VERSION stamp (run_meta; --check warns on mismatch)
    "schema_version": int,
    # trace record: the collective span template
    "spans": list,
    # trace record: per-layer FLOP-sized compute spans from the HLO cost
    # ledger's loop attribution (utils/hlo_cost; telemetry/trace.py)
    "compute_spans": list,
    # trace record: the compiled pipeline tick program's per-stage
    # occupancy rows (telemetry/trace.py::pipe_trace; rendered by
    # trace_view.py as one timeline row per pipeline stage)
    "pipe": dict,
    # flight record (telemetry/flight.py)
    "reason": str,
    "steps": list,
    "first_nonfinite_layer": int,
    # straggler record (Telemetry.sample_stragglers)
    "hosts": int,
    # what step_s_by_host measures ("step_s", "host_prep_s", ...): SPMD
    # collectives couple whole-step wall across hosts, so attribution
    # gathers an uncoupled host-side quantity and labels it here
    "quantity": str,
    "step_s_by_host": list,
    "slowest_host": int,
    "straggler_frac": _NUM,
    "model": str,
    "n_params": _NUM,
    "tokens_per_step": _NUM,
    "batch": int,
    "seq_len": int,
    "peak_flops_per_chip": _NUM,
    # measured-vs-modeled collective traffic (Telemetry.capture_compiled)
    "comm_model": dict,
    "comm_measured": dict,
    "comm_delta": _NUM,
    # overlap-window analysis (utils/hlo_comm.overlap_report): loop-
    # resident vs top-level reducing-collective wire + async start->done
    # windows — the measured side of the grad_buckets knob
    "comm_overlap": dict,
    # the gathering-collective half of the same analysis (all-gather
    # loop residency + gather-only async windows; ring/pipe permutes
    # excluded — hlo_comm._GATHER_OPS) — the measured side of the
    # ZeRO-3 gather_prefetch knob
    "gather_overlap": dict,
    # quantized grad-collective model (parallel/comm.modeled_wire_bytes):
    # mode, elems_padded, quant vs fp32-all-reduce wire bytes
    "grad_comm": dict,
    "comm_error": str,
    "aot": dict,
    # HLO cost ledger summary (utils/hlo_cost.cost_summary): measured
    # FLOPs/HBM totals, arithmetic intensity, and the named roofline
    # bound verdict with top cost centers — the compute/HBM analogue of
    # comm_measured
    "hlo_cost": dict,
    # bench's analytic matmul-FLOPs-per-token accounting, stamped next
    # to the measured number so perf_diff can flag formula rot
    "flops_per_token_matmul": _NUM,
    # autotuner diagnostics (autotuner/runtime_tuner.py): one per
    # timing decision / refused candidate, and bench's tune_e2e plan
    # summary — the stderr prints these replaced were invisible to
    # every dashboard
    "autotune": dict,
    # registry snapshot (Telemetry.flush)
    "counters": dict,
    "gauges": dict,
    "histograms": dict,
    # resume record (resilience/elastic.py::elastic_load info)
    "resumed_step": int,
    "elastic": bool,
    "old_mesh": (dict, type(None)),
    "new_mesh": dict,
    "residual_action": str,
    "moved_params": int,
    "data": dict,
    "checkpoint_dir": str,
    # fault record (resilience/chaos.py fault log + rebalance events;
    # serving tick faults name the poisoned decode slot, and the
    # engine's warm-restart event rides the same kind)
    "fault": str,
    "at_step": int,
    "path": str,
    "attempts": int,
    "action": str,
    "shares": list,
    "slot": int,
    # request record (serving tier, one per TERMINAL request — every
    # outcome writes one, not just clean finishes)
    "request_id": int,
    "prompt_tokens": int,
    "new_tokens": int,
    "queue_s": _NUM,           # arrival -> first admission
    "ttft_s": _NUM,            # arrival -> first token
    "decode_tokens_per_s": _NUM,
    "preemptions": int,
    # terminal outcome: "ok" (served), "shed" (refused/unmeetable before
    # service), "expired" (blew its deadline mid-service), "failed"
    # (quarantined on non-finite decode logits)
    "status": str,
    # detail under the status: "length" | "eos" | "deadline" |
    # "nonfinite_logits" | "shed:<watermark-or-deadline reason>"
    "finish": str,
    "deadline_s": _NUM,        # the request's SLO, echoed when set
    # request lifecycle timeline (schema v6): [name, t_s(, slot)] event
    # triples on the engine's monotonic clock — submitted / admitted /
    # preempted / restart_requeued / quarantined / expired /
    # terminal:<status>.  trace_view.py lays them out as queue + slot
    # tracks; every request record in one file shares the clock.
    "events": list,
    # terminal latency (arrival -> terminal) and its attribution
    # components; the components PARTITION lat_s (sum == lat_s within
    # float rounding, pinned) so a p99 postmortem can name what the
    # tail paid: queue-wait, prefill walls, decode-active windows,
    # preempted-wait (preemption -> re-admission), restart-overhead
    # (warm-restart/recovery re-queue -> re-admission)
    "lat_s": _NUM,
    "comp_queue_s": _NUM,
    "comp_prefill_s": _NUM,
    "comp_decode_s": _NUM,
    "comp_preempt_s": _NUM,
    "comp_restart_s": _NUM,
    # cross-engine migration wait (schema v15, disagg runs only): the
    # export->import window of a prefill->decode handoff, split out of
    # queue-wait so the disaggregation tax is attributable (the comp_*
    # set still partitions lat_s; single-engine records omit it)
    "comp_migrate_s": _NUM,
    # cross-engine request correlation key (schema v15): stamped at
    # submit(), rides the journal's submit line, KV migration handoffs
    # and failover adoption — every record one request writes anywhere
    # in a fleet carries the same trace_id, which is what lets
    # serving_chrome_trace put one request's spans on correlated
    # per-replica tracks
    "trace_id": str,
    # speculative decoding (schema v7, spec-enabled engines only):
    # per-request draft yield — drafts proposed for this sequence and
    # drafts accepted into it (accept rate = accepted/proposed; the
    # committed sequence itself is target-exact either way)
    "spec_proposed": int,
    "spec_accepted": int,
    # fleet serving (schema v8): which engine replica wrote this
    # request/tick/fault record — one metrics stream carries a whole
    # fleet, and serve_report.py's Fleet section groups by it
    "replica_id": int,
    # multi-tenant serving (schema v9): the submitting tenant id on
    # request records of tagged traffic — serve_report.py's Tenancy
    # table groups by it, and the tenant_flood isolation A/B reads the
    # well-behaved tenant's p99 off it
    "tenant": str,
    # shared-prefix KV reuse (schema v9, prefix-cache engines only):
    # blocks aliased from the radix tree into this request's block
    # table and the prompt tokens whose prefill those aliases avoided
    # — cumulative over the request's admissions (a preemption resume
    # that re-hits the cache counts again: it avoided another prefill)
    "prefix_blocks": int,
    "prefix_tokens": int,
    # disaggregated serving (schema v8): the prefill->decode paged-KV
    # handoff this request paid — MEASURED payload bytes (pool resting
    # dtype + scales, so quantized pools show the same 4x compression
    # they rest at) and the link class the transfer crossed ("ici" /
    # "dcn", classified by wire_link_split's granule logic)
    "kv_migration_bytes": int,
    "kv_migration_link": str,
    # tick record (serving scheduler; schema v6).  t_s is the tick-start
    # stamp on the same monotonic clock as request `events`; wall_s the
    # full tick wall; sched_s/prefill_s/decode_s/fetch_s partition it
    # (host scheduling incl. deadline/grow/journal work, prefill program
    # walls, decode dispatch, token-fetch sync).
    "tick": int,
    "t_s": _NUM,
    "wall_s": _NUM,
    "sched_s": _NUM,
    "prefill_s": _NUM,
    "decode_s": _NUM,
    "fetch_s": _NUM,
    # drafter proposal wall (schema v7, spec-enabled engines only) —
    # the draft side of the draft-vs-verify tick split; decode_s +
    # fetch_s are the verify program's dispatch + sync walls
    "draft_s": _NUM,
    "occupancy": _NUM,          # active slots / max_active after the tick
    "pool_util": _NUM,          # allocated / usable pool blocks
    "queue_depth": int,
    # per-tick scheduler counts (deltas over the tick; submit-time sheds
    # land on the NEXT tick's record)
    "admitted": int,
    "evicted": int,
    "preempted": int,
    "shed": int,
    "expired": int,
    "quarantined": int,
    "restarted": int,
    "produced": int,
    # why this tick record exists: "event" (a count above is nonzero) or
    # "sample" (the tick_record_every cadence)
    "emit": str,
    # run_meta (serving runs): the ServeConfig geometry the trace viewer
    # needs to lay out slot tracks without rebuilding the engine
    "serve": dict,
    # slo record (schema v15, telemetry/slo.py::SLOTracker.record):
    # the burn-rate window lengths ({"s": [30.0, 300.0]}), the
    # per-tenant budget table (objective / requests / good / attainment
    # / budget_spent_frac / burn per window), the all-tenant attainment
    # fraction, and the alert dicts that have fired so far
    "windows": dict,
    "tenants": dict,
    "attainment": _NUM,
    "alerts": list,
}


def validate_record(rec) -> List[str]:
    """Schema errors for one parsed JSONL record ([] = valid)."""
    if not isinstance(rec, dict):
        return ["record is not a JSON object"]
    errs: List[str] = []
    if "kind" in rec:
        kind = rec["kind"]
        if kind not in META_KINDS:
            errs.append(f"unknown meta kind {kind!r}")
        if not isinstance(rec.get("ts"), _NUM):
            errs.append("meta record missing numeric 'ts'")
        for k, v in rec.items():
            if k in ("kind", "ts"):
                continue
            if k not in META_FIELDS:
                errs.append(f"unknown meta field {k!r}")
            elif not isinstance(v, META_FIELDS[k]):
                errs.append(
                    f"meta field {k!r}: expected "
                    f"{META_FIELDS[k]}, got {type(v).__name__}"
                )
        return errs
    # step record
    if not isinstance(rec.get("step"), int) \
            or isinstance(rec.get("step"), bool):
        errs.append("step record missing integer 'step'")
    if not isinstance(rec.get("ts"), _NUM):
        errs.append("step record missing numeric 'ts'")
    for k, v in rec.items():
        if k in ("step", "ts"):
            continue
        if k not in STEP_FIELDS:
            errs.append(f"unknown step field {k!r}")
        elif not isinstance(v, STEP_FIELDS[k]):
            errs.append(
                f"step field {k!r}: expected {STEP_FIELDS[k]}, "
                f"got {type(v).__name__}"
            )
    return errs


def validate_file(path: str) -> Tuple[Dict[str, int], List[str]]:
    """((counts by record class), errors) for a metrics JSONL file.
    Errors carry 1-based line numbers."""
    counts = {"step": 0, "meta": 0}
    errs: List[str] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                errs.append(f"line {i}: invalid JSON ({e})")
                continue
            line_errs = validate_record(rec)
            errs.extend(f"line {i}: {e}" for e in line_errs)
            if not line_errs:
                counts["meta" if "kind" in rec else "step"] += 1
    return counts, errs


def version_warning(metas) -> Optional[str]:
    """Advisory schema-vintage check over parsed meta records: a warning
    string when a run_meta's `schema_version` differs from this module's
    (or predates the stamp entirely), else None.  `report_run.py --check`
    prints it to stderr without failing — field validation is the hard
    gate; the version is provenance."""
    for m in metas:
        if not isinstance(m, dict) or m.get("kind") != "run_meta":
            continue
        v = m.get("schema_version")
        if v is None:
            return (
                "run_meta carries no schema_version (pre-v2 writer); "
                f"current schema is v{SCHEMA_VERSION}"
            )
        if v != SCHEMA_VERSION:
            return (
                f"run_meta written by schema v{v}; this checker is "
                f"v{SCHEMA_VERSION} — fields may have drifted"
            )
        return None
    return None


# Telemetry GAUGE name registry: every `telemetry.gauge("<name>", ...)`
# call site in the package must have its name documented here — the
# repo-hygiene name-drift guard (tests/test_repo_hygiene.py) greps the
# call sites and fails on an undocumented gauge, so a renamed or new
# gauge cannot silently desynchronize dashboards from the code.
#
# Labeling convention (schema v15): a call site passes the BARE name
# documented here plus keyword labels — `gauge("serve_queue_depth",
# v, replica=rid)` — and the registry keys the stored value
# `serve_queue_depth{replica=0}` via telemetry/live.gauge_key.  Labels
# whose value is None are dropped, so single-engine paths keep the
# bare historical keys; readers recover (base, labels) with
# live.parse_gauge_key.  The names below are the BASE names; labeled
# variants are not separately registered.
GAUGES: Dict[str, str] = {
    "anomaly_step_s": "wall time of the step that tripped the anomaly "
                      "detector",
    "anomaly_threshold_s": "rolling-median threshold the anomalous step "
                           "exceeded",
    "hbm_gb_in_use": "device memory in use at the last sample (TPU "
                     "runtime)",
    "hbm_gb_peak": "peak device-memory watermark seen this run",
    "grad_residual_norm": "L2 norm of the quantized-grad-comm error-"
                          "feedback residual (TrainState.grad_residual)",
    "grad_comm_overlap_frac": "loop-resident / total reducing-collective "
                              "wire bytes (hlo_comm.overlap_report)",
    "gather_overlap_frac": "loop-resident / total all-gather wire bytes "
                           "(the ZeRO-3 weight-gather placement)",
    "measured_wire_bytes": "total per-device collective wire bytes from "
                           "the compiled HLO ledger",
    "modeled_wire_bytes": "comm_report ring-model prediction for the same",
    "grad_comm_wire_bytes": "modeled wire bytes of the quantized gradient "
                            "schedule",
    "grad_comm_wire_saved_bytes": "modeled wire saved vs the fp32 "
                                  "all-reduce baseline",
    "aot_temp_bytes": "AOT-predicted step temp allocation",
    "straggler_frac": "(slowest - median) / slowest over the gathered "
                      "per-host wall — the [0,1) fraction of the slowest "
                      "host's time the median host would not have spent",
    "straggler_slowest_host": "process index of the slowest host",
    "straggler_slowest_step_s": "the slowest host's step wall time",
    "checkpoint_save_s": "wall time of the last checkpoint save "
                         "(Orbax write + atomic commit; measured in the "
                         "async writer thread)",
    "checkpoint_last_step": "step number of the last COMMITTED "
                            "checkpoint",
    "checkpoint_overlap_steps": "training steps whose compute ran while "
                                "an async checkpoint save was in flight "
                                "(the steps hidden behind I/O)",
    "serve_batch_occupancy": "active decode slots / max_active at the "
                             "last scheduler tick (serving tier) — the "
                             "quantity continuous batching exists to "
                             "keep high",
    "serve_pool_utilization": "allocated paged-KV blocks / usable pool "
                              "blocks at the last tick",
    "serve_queue_depth": "requests waiting for admission at the last "
                         "tick",
    "serve_eviction_rate": "finished-request evictions per scheduler "
                           "tick, cumulative",
    "serve_shed": "requests shed before service (admission-watermark "
                  "refusals + deadline-unmeetable queue sheds), "
                  "cumulative",
    "serve_expired": "active requests evicted for blowing their "
                     "deadline, cumulative",
    "serve_quarantined": "decode slots quarantined on non-finite "
                         "logits (request -> failed), cumulative",
    "serve_restarts": "engine warm restarts tripped by the decode-"
                      "health watchdog (consecutive poisoned ticks or "
                      "a tick exception), cumulative",
    "dcn_wire_bytes": "per-device collective wire bytes whose replica "
                      "groups CROSS a DCN granule boundary (slices / "
                      "processes) on the hybrid mesh — measured from "
                      "the compiled HLO's replica_groups, not modeled "
                      "(utils/hlo_comm.wire_link_split)",
    "sched_gather_overlap_frac": "composed scheduler (parallel/"
                                 "schedule.py): loop-resident / total "
                                 "all-gather wire on the MERGED "
                                 "multi-slot program — the gather "
                                 "slot's overlap view",
    "sched_grad_overlap_frac": "composed scheduler: loop-resident / "
                               "total reducing-collective wire on the "
                               "merged program — the grad slot's "
                               "overlap view (bucket releases inside "
                               "the backward scan)",
    "hlo_flops": "compute FLOPs of the compiled step counted from its "
                 "post-SPMD HLO (utils/hlo_cost.cost_ledger: dot/conv "
                 "contracting-dim math, while bodies trip-multiplied) — "
                 "the measured numerator the 6N hand formula "
                 "approximates",
    "hlo_hbm_bytes": "modeled HBM traffic of the compiled step "
                     "(operand + result bytes per instruction, fusions "
                     "priced at their call line, loop-multiplied)",
    "step_mfu_hlo": "HLO-counted MFU: hlo_flops / median step wall / "
                    "peak FLOPs per chip — per device, measured "
                    "numerator and denominator",
    "arithmetic_intensity": "hlo_flops / hlo_hbm_bytes (FLOPs per HBM "
                            "byte); below the device's ridge intensity "
                            "the program is HBM-bound "
                            "(utils/hlo_cost.roofline_verdict)",
    "hpz_dcn_wire_bytes": "loop-resident (in-scan) all-gather wire "
                          "whose replica groups cross a DCN granule "
                          "(utils/hlo_comm.gather_link_split_in_loops) "
                          "— ~zero under hpZ secondary weight "
                          "partitioning, where every in-scan gather "
                          "stays intra-slice and only the one "
                          "top-level secondary rebuild crosses DCN",
    "hpz_rebuild_dcn_bytes": "the hpZ secondary rebuild hop itself: "
                             "outside-loop all-gather wire on exactly "
                             "the scheduler's inter-granule replica "
                             "groups (utils/hlo_comm."
                             "group_wire_outside_loops) — the qwZ "
                             "number, ~4x lower under hpz_comm='fp8' "
                             "(fp8 blocks + scales instead of compute "
                             "dtype, ZeRO++ arXiv:2306.10209)",
    "zero3_tail_wire_bytes": "quantized ZeRO-3 tail release: the "
                             "once-per-step outside-loop reduce wire "
                             "(the non-block tail's sync; the bucket "
                             "syncs are the in-loop reduce wire) — "
                             "emitted when grad_comm_tail is "
                             "quantized, comparable against the fp32 "
                             "transpose reduce-scatter it replaces",
    "serve_spec_accept_rate": "speculative decoding: drafts accepted / "
                              "drafts proposed, engine lifetime — the "
                              "drafter-quality number that decides "
                              "whether speculation pays",
    "serve_spec_tokens_per_tick": "speculative decoding: committed "
                                  "tokens per verify tick (1..k+1), "
                                  "engine lifetime — the realized "
                                  "multi-token yield vs the plain "
                                  "path's fixed 1.0",
    "fleet_dispatch": "requests dispatched by the fleet router to any "
                      "replica, cumulative (fleet/router.py) — door "
                      "sheds excluded: those never reach a queue",
    "fleet_failover": "replica deaths failed over by the router "
                      "(journal replayed onto a sibling), cumulative",
    "fleet_replicas_live": "live replicas behind the router at the "
                           "last dispatch/tick — the fleet's serving "
                           "capacity denominator",
    "serve_prefix_hit_rate": "shared-prefix cache: prompt tokens "
                             "aliased from the radix tree / prompt "
                             "tokens admitted, engine lifetime — the "
                             "fraction of prefill work the cache "
                             "avoided",
    "serve_prefix_blocks_aliased": "shared-prefix cache: pool blocks "
                                   "aliased into admissions' block "
                                   "tables instead of re-prefilled, "
                                   "cumulative",
    "serve_prefix_tokens_avoided": "shared-prefix cache: prompt "
                                   "tokens whose prefill an alias "
                                   "replaced, cumulative",
    "serve_prefix_cached_blocks": "blocks the radix tree currently "
                                  "holds warm (one refcount each; "
                                  "yielded LRU under pool pressure)",
    "serve_prefix_pool_saved_bytes": "pool bytes sharing saves right "
                                     "now, measured from refcounts: "
                                     "every holder beyond a block's "
                                     "first would otherwise need its "
                                     "own physical block",
    "serve_tenants_active": "distinct tenants with queued or active "
                            "requests at the last scheduler tick",
    "autotune_candidate_failures": "autotuner candidates that refused "
                                   "their shapes during timing, "
                                   "cumulative (mirrors the counter; "
                                   "occasional failures are normal — "
                                   "a climb means a rotten candidate "
                                   "list)",
    "bubble_frac": "idle-tick fraction of the compiled (tick, stage) "
                   "pipeline program (parallel/pipe_schedule.py: "
                   "1 - busy_ticks / (n_ticks * stages)) — the "
                   "schedule-occupancy number the interleaved / "
                   "zero-bubble lowerings exist to shrink below 1F1B's "
                   "(S-1)/(M+S-1)",
    "pipe_ticks": "length of the compiled pipeline tick program (the "
                  "bubble_frac denominator's tick axis)",
}
