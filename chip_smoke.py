#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each on stdout; any failure exits non-zero before the result:

1. device: the card's name and power limit (``nvidia-smi``), the CUDA version,
   and the build of the three kernel sources (``csrc/segment_sum.cu``,
   ``csrc/even_assign.cu``, ``csrc/graph_loop.cu``: one ``nvcc`` each,
   started together) into ``build/kernels/``;
2. kernels: both segment-sum paths against their plain PyTorch version at
   the solver's shapes (among them the assigner's 8 x 128 position counts, the
   sweep's 64 x 10,000 replication factors and the first level of its float
   totals, 64 x 938 windows, each as one call and as 64 per-lane calls; the
   per-lane calls beside their plain version and one ``index_add_`` a lane) and a rollout
   step's calls (16 pairs' replication factors, the 16 pairs' totals in one
   call, beside one call a pair, the balancedness of 16 pairs),
   the skewed case (all rows in one segment), the snapshot's multi-column
   calls, and the snapshot's calls at config #3 and on the JBOD ladder
   (2,500 brokers: 750,000 rows into 4,096 brokers and 5,000 logdirs;
   config #4: 3M rows into 16,384 brokers and 20,000 logdirs, its topic
   tables of 32,768,000 and rack counts of 40,000,000 segments; timed over 10
   calls), and the lane-form snapshot's calls, one for every lane of S1's
   64 and of the rollout's 16 (the broker loads into 64 x 128 and 16 x 128
   segments, the topic tables into 64 x 2,560 and 16 x 2,560, the rack
   counts into 64 x 100,000 and 16 x 100,000; each beside one call a lane),
   and the same calls of the batched solves' rounds on config #2's 4 and 16
   lanes (the snapshot's whole broker call, the topic tables into 4 x 12,800
   and 16 x 12,800, the rack counts):
   every output bitwise equal to the CPU's sequential sum (floats; ints
   exact), two launches bitwise equal, and every fixed-order call of 100,000
   rows or more into 1,024 segments or more planned on 132 blocks or more.  For the kernel, the plain version and
   one ``index_add_`` call (a yardstick the port never calls): ``device_ms``,
   the summed kernel and memset durations of one call under
   ``torch.profiler`` (median of 30); ``call_ms``, CUDA events around 200
   back-to-back calls over the count; and ``latency_ms``, the median of CUDA
   events around one call (host and device of one call);
3. assign: the kafka-assigner pass (``even_assign``) at config #2's shape
   (10,000 partitions, 128 brokers, RF 3) and at 2,048 brokers, and on its
   lane grid (4 lanes of config #2's shape, one launch a pass, beside one
   launch a lane), every pass equal to the plain CPU loop exactly, with its
   device and call times;
4. config2: one full rebalance proposal (``GoalOptimizer.optimize``, the 16
   default goals, heavy goals on) at the benchmark's config #2 -- 100 brokers,
   10 racks, 100 topics, 10,000 partitions, RF 3, exponential load skewed onto
   25 brokers, seed 7 -- cold and warm; host calls per kernel path and the
   value tensors they carried; fails unless every hard goal is met, the
   placement is valid, both kernel paths launched during the solve and the
   totals are the JAX reference's (24,019 / 22,245 / 7,497 moves, 310 rounds,
   balancedness 97.666), the solve went through the device loop (a goal one
   CUDA graph launch: ``analyzer/device_loop.py``) and the warm solve made at
   most #goals + 4 host syncs.  Then the device loop against its plain
   version: config #2's goal walk goal by goal, each goal once as one graph
   launch and once through the host driver (``_goal_step_fn``, one host read
   a round) from the same state, bitwise equal (placement, rounds, moves,
   violations), with both walls; the CUDA runtime and driver must have
   conditional graph nodes (12.3+); the plain loop control (a round's
   condition read on the host) is timed;
5. the optional-goal paths at config #2 width, each cold and warm with its
   own launch counts: P1 the kafka-assigner mode (goals 22, 23; both kernels
   must launch, every position even), P2 the JBOD north-star list (the 16
   default goals then goals 16, 17, two logdirs per broker in the
   capacityJBOD.json shape), P3 REMOVE_DISKS (goal 16 alone, hard, the second
   logdir of brokers 0-9 removed from a balanced JBOD cluster with room to
   drain them);
6. sim: the what-if planner and the incremental solves on the JAX sweep
   harness's cluster (100 brokers, 10,000 partitions, RF 3, light load) at
   full width -- S1 ``fast_sweep`` of its 64 scenarios cold, warm and warm
   under ``torch.profiler`` (host calls per sweep: the batch-wide sums, the
   integer call at 640,000 segments and one float call a level among them,
   and the lane-form evaluation, one snapshot and one violation pass for
   every lane; each must be the same at 8 lanes as at 64; the device idle share;
   every lane must equal the CPU
   port's sweep of all 64 and lanes s0-s7 its sweep of those 8, and the
   batch-wide float totals of every lane the CPU port's bitwise), S2 ``deep_sweep`` of s0-s3 (one
   batched solve; valid placements, every lane equal to its direct solve), S3 ``plan_capacity`` at
   load 1.0, S4 ``evaluate_drift`` and ``incremental_optimize`` on phase 4's
   solved placement with topics 0-9 scaled, and a 4-lane
   ``batched_incremental_optimize`` whose every lane must equal its own solve;
6b. batched: the solver's lane form -- config #2 (16 goals) under S2's
   first 4 and 16 scenarios through ``batched_optimize``, cold and warm, each
   goal one graph launch for the whole stack: the walls beside each lane's
   own solve in the same run, host syncs, graph launches, the control
   kernels (device and layout), the rounds the graphs ran and the kernels a
   round, kernel host calls, peak memory; every lane must equal its own
   solve, the 16-lane stack's first 4 lanes the 4-lane stack's, and the
   4-lane stack the CPU port's batched solve (a child process started after
   phase 2, run beside the card's phases); the launches must be the
   goals plus the pre-phases' one.  Then one long lane with 15 that apply
   nothing against walking the lanes, and P1's goals over the 4-lane stack
   (``even_assign`` one lane-grid launch a position for the stack);
7. profile: one warm config #2 solve under ``torch.profiler`` in a process
   of its own (in this one the profiler ran before the graphs were
   instantiated, and a profiled replay of them faults), each goal graph's
   device time from CUDA events around its launch -- the device's busy
   time between two bounds (the graph-window occupancy above, the traced
   kernels' time below; the profiler sees only some of a graph's kernels),
   kernel launches per round (the rounds' captured work nodes times their
   trip counts, derived; the control kernels as they counted themselves),
   graph launches, the loop control kernel's device time, top kernels by
   device time; then
   this process's device loop: rounds captured, goal graphs, capture wall
   and its pool's bytes;
8. card vs CPU: the same solve on the CPU port for config1 and config2_small
   (default goals) and for P1-P4 at config2_small (P2 and P3 with two
   logdirs, P4 = goals 19, 21, 20, 18 with two broker sets); placements,
   leaders and logdirs must be identical (P4 capped at 200 rounds a phase);
   then the sim entry points at config2_small (fast sweep of 8, deep sweep of
   4 in two goal orders, a capacity plan with ``deep_verify``, single and
   batched incremental solves), identical on card and CPU;
9. traces: trace rollouts (``traces.rollout``) on the sim cluster at full
   width -- the JAX traces harness's 4 traces x 4 policies (16 pairs, 64
   steps: 1,024 lane evaluations, bucket 128) cold (the step captured) and
   warm, the 64 steps one counted loop's graph launch
   (``csrc/graph_loop.cu``, the JAX ``lax.scan``); the kernels' host calls
   and the calls replayed in the graph per rollout and per step; the CPU
   port's rollout and the host loop on the card (the counted loop's plain
   version), each equal bitwise; the warm rollout profiled in a child
   process (the kernels it ran beside the eager rollout's 331,799, the
   device's busy time between two bounds); the violation-free pairs and the
   winners; then
   ``horizon_requirements`` on the spike trace.  Fails unless a warm rollout
   is one launch of its time loop with one host sync and no segment-sum
   host call, its control kernels count one a step and one to start, and
   both kernel paths ran in it;
10. controller: a ``ContinuousController`` warm-started from phase 4's
   solved config #2 placement (a port ``ClusterModel`` built from it; the
   smoke's ``SmokeFacade`` serves the loads), S4's shift (topics 0-9 x 1.3)
   as one window delta, one drift-triggered tick (drifted goals, rounds, host
   syncs, proposals, reaction latency); the set is journaled in a temporary
   directory and a fresh controller's ``recover()`` must give it back;
11. fleet: four tenants of that cluster with S4's four shifts, one fleet
   tick; every tenant's standing set must equal its own standalone tick's,
   and the warm tick must make no compile event (the warm start captured
   the group's batched walk at its stack's shape);
12. traces/controller card vs CPU: the JAX traces harness's rollout (10
   brokers), a rollout at config2_small, a tick and a 3-tenant fleet tick of
   the config2_small solve shifted -- every series, verdict and set
   identical on card and CPU;
13. facade: the service's own path at config #2 width -- a
   ``FakeClusterBackend`` seeded with config #2's topology and leader loads,
   a ``LoadMonitor`` whose windows ``sample_once`` fills on a window-aligned
   clock, ``CruiseControl(device="cuda").rebalance(dryrun=True)`` cold and
   warm, then ``rebalance(dryrun=False)`` through the ``Executor``: the
   sampling, model-build, optimize and execution walls, host syncs, rounds,
   proposals, tasks by state, the kernel builds of the warm rebalance and
   the peak device memory.  Fails unless the solve leaves no hard violation,
   the warm proposals equal the cold ones, the warm rebalance builds no
   kernel, the execution succeeds, the backend's replica lists and leaders
   equal the proposals' targets, a fresh model after the execution has no
   hard violation on the card, and both segment-sum paths launched;
14. facade card vs CPU: the executed rebalance at config2_small on the CPU
   port and on the card; the proposals, the backend's admin log and final
   placement and the flight records' kinds and attribute names identical;
15. detector: the self-healing plane at config #2 width through
   ``build_facade``, driven synchronously (``manager.run_detector_once``,
   ``manager.handle_anomaly``, a ``SelfHealingNotifier`` on a fake clock):
   the goal violations of the skewed start and their fix (an executed
   rebalance; a re-detection must find fewer violated goals), a killed
   broker (CHECK inside the grace period, FIXED after it: no replica left on
   it, 0 hard violations in a fresh model on the card), and broker 5's only
   logdir taken offline (FIXED; a dry run of the fix with no goals, the
   offline pre-phase alone, must move every replica off it, and the executed
   fix must leave fewer there than it found: the goals after the pre-phase
   refill the broker as the JAX package does).  Every fix must execute, and
   the backend must equal its proposals.  Then a threaded pass at
   config2_small: ``start_detection`` with the broker-failure and
   goal-violation detectors on their own threads must drain a killed broker
   within 120 s.  Both segment-sum paths must launch in the synchronous
   drive and in the threaded pass, each counted on its own;
16. detector card vs CPU: the synchronous drive at config2_small on the CPU
   port and on the card; anomalies, actions, fixes' proposals, admin log,
   final placement, the offline-logdir counts and record shapes identical;
17. replay and harnesses: ``traces.run_replay`` on the JAX replay tests'
   drift storm and quiet trace on the card and the CPU port (every step
   identical but for the host-sync counts), then the controller, fleet and
   traces bench harnesses once each at their pinned sizes (the fleet's at 8
   of its 32 tenants), each card run
   with its own kernel counts; the controller and fleet harnesses' warm-tick
   host syncs are held to the JAX dispatch budgets (ROADMAP C5);
18. ingest: the config layer, the metrics ingest, the replication and the
   self-monitoring plane at config #2 width.  ``config/cruisecontrol
   .properties`` through the port's registry (the window keys overridden,
   every class key a class of the port); the facade stack of phase 13 with
   a deployment's route as sampler -- a ``MetricsReporter`` for each of the
   100 brokers serializing its share of one backend fetch an interval with
   the wire format onto an ``IntervalTransport`` (batches stamped with the
   interval they report), a ``FetcherPool`` of 4 ``TransportMetricSampler`` samplers
   -- filling the windows; a dry-run rebalance cold and warm (0 hard
   violations, warm = cold = phase 13's proposals, each optimize record's
   ``cost`` equal to the profiler census of its kernel calls); a
   ``ContinuousController`` journaling to a temporary directory (recovered
   and fenced as at the service's startup), a writer ``ReplicationState``
   on the journal's listener and a ``FollowerTailer``; topics 0-9 x 1.3 at
   the backend, sampled through the reporters until a tick publishes; the
   follower's version, epoch and set equal the writer's, then a compaction
   gives it one reset and no delta.  A ``SelfMonitor`` samples the process
   registry around the steps after the warm start and the shipped SLOs
   evaluate: the page
   parses, carries the replication gauges and the census (equal to the
   launch counts), no step but the cold rebalance and the controller's
   warm start (which captures the tick's goal graphs, as the JAX warm start
   compiles its programs) makes a compile event, ``warm-recompiles`` and
   ``replication-staleness``
   stay quiet, and ``warm-tick-dispatches`` is printed beside the JAX
   budget of 7.  The self-monitor starts once the warm start has ended (its
   first sample then), as the steady state starts after the service's
   startup; the steps before it count their compile events from the flight
   record.
   Then ``selfmon_bench.run_bench`` on the card, its denominator phase
   17's controller harness tick p50: 0 kernel calls and builds while
   sampling, no false positive, the burn caught within two periods;
19. ingest card vs CPU: phase 18's ingest and replication steps at
   config2_small on the CPU port and on the card; proposals, the sets of
   controller, writer and follower, the journal records and the flight
   records' shapes identical;
20. api: the REST API at config #2 width -- the port's app
   (``CruiseControlTpuApp`` on the card) over phase 13's seeded backend and
   capacities, its windows sampled on the facade clock, serving HTTP on
   127.0.0.1 (the proposal refresher stopped, detectors hourly with no
   initial pass: every solve comes from a request); the port's client sends
   HEALTHZ (readiness), STATE, LOAD, PARTITION_LOAD (10 rows),
   KAFKA_CLUSTER_STATE, PROPOSALS cold and warm (past the cache), REBALANCE
   ``dryrun=true`` polled through its user task, the kafka-assigner
   PROPOSALS (goals 22, 23), SIMULATE (8 scenarios), USER_TASKS, METRICS and
   TRACES (``kind=optimize``), each request's wall printed.  Fails unless
   every body passes its schema (the page parses), no response is a 5xx, the
   proposals over HTTP equal an in-process ``rebalance(dryrun=True)`` on the
   same app with no hard goal violated, the warm optimize record has no
   compile event, and all three kernels launched with the census equal to
   the launches.  Then ``python -m cruise_control_tpu_torch --config`` a
   copy of ``config/cruisecontrol.properties`` on an ephemeral port: its
   probe line must name the card, HEALTHZ and STATE answer, and it is
   stopped;
21. api harnesses: ``api/bench.run_bench`` (200 clients, 4 execution slots,
   a queue of 8) with its app on the card, then ``replication/bench
   .run_bench`` (2 follower processes on the CPU, 500 watchers, 10
   publishes); each must meet its own contract (0 5xx, a Retry-After on
   every shed; every delivery made, no version regression);
22. api card vs CPU: phase 20's requests (PROPOSALS once) at config2_small
   to an app on the CPU port and one on the card; every body but the page
   and the flight records identical once the wall-clock fields, the sensor,
   profiler and self-monitor blocks and ``bucketHit`` are dropped;
23. parallel: config #2 at full width through ``ShardedGoalOptimizer`` on
   4 ranks (processes started by ``parallel.run_ranks``) sharing the card
   over gloo, every collective staged through host copies: every rank's
   placements, leaders, proposals, violations and balancedness must equal
   phase 4's single-device solve with no hard violation; the backend, the
   cold and warm walls, host syncs, collectives per goal step, each rank's
   K1 and K2 host calls (each must launch in every rank) and peak device
   memory.  Then one rank on NCCL at config2_small must equal the
   single-device solve there;
24. parallel card vs CPU: the gate's mesh8 workload (32 brokers, 256
   partitions, RF 3, seed 5, 16 goals) on 8 card ranks and on 8 gloo ranks
   of the CPU port, every rank identical to the single-device card solve;
   then on 4 card ranks a preferred-leader goal list through the gather path
   (one all_gather, then the single-device solver; equal to the
   single-device solve) and ``fast_sweep(mesh=)`` of 10 scenarios (padded
   to 12), bit-equal to the unsharded sweep;
25. scale: BASELINE.md config #3 through ``bench_scale.run`` on the card --
   1,000 brokers (bucket 1,024), 20 racks, 1,000 topics, 100,000
   partitions, RF 3, seed 11, RackAware and the five capacity goals, the
   active-broker window of 256 rotating its sources -- cold, then warm:
   the walls, host syncs, each kernel path's host calls in the warm solve,
   peak device memory and rounds per goal.  Fails unless the solution
   equals the committed JAX record (``obs/baselines/SCALE_REFERENCE_config3
   .json``: moves, per-goal rounds, moves and violations, movement,
   balancedness, the placement's digest) with no hard violation, and both
   segment-sum paths launched.  Then config #4's goal list (18 goals, heavy
   goals on, two logdirs a broker) at 48 brokers and 1,500 partitions on
   the card and on the CPU port: fails unless both equal the committed JAX
   record (``SCALE_REFERENCE_config4_small.json``);
26. gate: the port's regression gate on the card in its own child
   processes, ``python -m cruise_control_tpu_torch.obs.gate --device cuda
   --tiers config1,config2_small,exporter,traces,controller,fleet`` against the committed
   ``GATE_BASELINE_cuda.json`` with ``CC_TPU_GATE_WALL_SLACK`` 3 (walls
   follow the shared host; host syncs, hard violations, balancedness,
   builds and recorder drift stay exact); it must exit 0.  The tiers
   include ``controller`` and ``fleet``: their warm ticks must stay within
   the JAX dispatch budgets (#goals + 3, #goals + 4; ROADMAP C5);
27. recovery: ``executor/recovery_bench`` on the card's host -- the JAX
   script's pinned journal (50 executions, one interrupted, 2,000 user
   tasks), its counts and its wall against the committed
   ``BENCH_RECOVERY_cuda.json`` (same slack); it must exit 0;
28. the total wall with the kernels' build and each phase's wall, the
   ``kernels`` JSON line, the ``nvidia-smi`` line, then the result line.
   ``launches`` is the wrapper's count of kernel calls in phase 4's cold
   solve (phase 5's P1 for ``even_assign``): its ``host_calls`` plus, for
   K1 and K2, ``replayed_calls_derived``, the calls the device replayed in
   goal graphs as each captured round's calls times its fetched trip count
   (not counted at a launch); the other ``*_launches`` keys count the same
   way.  ``sim_launches`` are
   those of phase 6's cold S1 sweep, ``traces_launches`` those of phase 9's
   warm rollout, ``controller_launches`` those of phase 10's tick,
   ``facade_launches`` those of phase 13's three rebalances,
   ``detector_launches`` those of phase 15's synchronous drive at config #2
   (its detections and fixes; not the checks between them),
   ``detector_threaded_launches`` those of its threaded pass,
   ``replay_launches`` those of each of phase 17's card runs by name, and
   ``ingest_launches`` those of phase 18's ingest and replication steps,
   ``api_launches`` those of phase 20's requests, ``parallel_launches``
   those of phase 23's cold sharded solve summed over its 4 ranks (each
   rank counted from 0 around its solve) and ``parallel_collectives`` rank
   0's collectives in that solve, ``scale_launches`` those of phase 25's
   warm config #3 solve and ``scale_shapes`` phase 2's times at config
   #3's shapes;
   ``sim_shape`` and ``traces_shapes`` are phase 2's times at the sweep's and
   the rollout's call shapes, ``lane_shapes`` at the lane-form snapshot's;
   ``batched_launches`` those of phase 6b's warm 4-lane batched solve (for
   ``even_assign``, of its batched P1), ``graph_loop``'s
   ``batched_graph_launches`` and ``batched_kernel_launches`` its goal
   graphs and control kernels, and ``even_assign``'s ``lane_grid`` phase
   3's times on the lane grid;
   ``count_ctl``'s ``launches`` are the control kernels of phase 9's warm
   rollout as they counted themselves on the device, its ``host_calls`` the
   counted loop's graph launches; ``kernel_launches`` are the kernels
   those calls enqueued in phase 7's solve (the fixed-order path enqueues
   three per pass), beside that solve's own host calls.

Config #2 walls of two trees are compared with
``python3 -m cruise_control_tpu_torch.bench_walls``, run in each checkout.

Needs the CUDA toolkit's ``nvcc`` and one GPU; imports nothing of JAX.
"""

from __future__ import annotations

import collections
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

H100_HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12        # non-tensor-core float32 peak, H100 SXM data sheet
CONFIG2 = dict(
    num_racks=10, num_brokers=100, num_topics=100, num_partitions=10_000,
    replication_factor=3, distribution="exponential", skew_brokers=25,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=7,
)
CONFIG1 = dict(
    num_racks=2, num_brokers=3, num_topics=2, num_partitions=20,
    replication_factor=2, distribution="exponential", skew_brokers=1,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=3,
)
CONFIG2_SMALL = dict(
    num_racks=5, num_brokers=40, num_topics=20, num_partitions=2000,
    replication_factor=3, distribution="exponential", skew_brokers=10,
    mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15, mean_nw_out=0.15, seed=7,
)
#: capacityJBOD.json: two logdirs per broker, CPU 100, NW 100k, disk 1M in all
JBOD = dict(
    disks_per_broker=2, capacity_cpu=100.0, capacity_disk=1_000_000.0,
    capacity_nw_in=100_000.0, capacity_nw_out=100_000.0,
)
#: REMOVE_DISKS needs room on the remaining logdirs: a balanced cluster at half
#: config #2's disk load (at mean_disk 0.2 and RF 3 a broker fills 60 % of its
#: disk, so losing half of it leaves 120 % of what remains)
REMOVE_DISKS_LOAD = dict(skew_brokers=0, mean_disk=0.1)
DEFAULT_GOALS = tuple(range(16))
NORTH_STAR = DEFAULT_GOALS + (16, 17)
#: the JAX package's sweep harness cluster (scripts/bench_sim.py:60-68), full width
SIM = dict(
    num_racks=10, num_brokers=100, num_topics=20, num_partitions=10_000,
    replication_factor=3, seed=7, mean_cpu=0.08, mean_disk=0.08, mean_nw_in=0.08,
    mean_nw_out=0.06, build_maps=False,
)
SIM_SCENARIOS = 64
#: (trace, policy) pairs of the traces phase's rollout: the JAX traces harness's 4 x 4
TRACE_PAIRS = 16
#: the round cap of the incremental solves (a controller tick's bound)
SIM_MAX_ROUNDS = 64
KERNEL_SOURCES = {
    "segment_sum_f32": "cruise_control_tpu_torch/csrc/segment_sum.cu",
    "segment_sum_i32": "cruise_control_tpu_torch/csrc/segment_sum.cu",
    "even_assign": "cruise_control_tpu_torch/csrc/even_assign.cu",
    "graph_loop": "cruise_control_tpu_torch/csrc/graph_loop.cu",
    "count_ctl": "cruise_control_tpu_torch/csrc/graph_loop.cu",
}
REPLACES = {
    "segment_sum_f32": "cruise_control_tpu/ops/segments.py:98 (segment_sum_pallas, pallas_call :127)",
    "segment_sum_i32": "cruise_control_tpu/ops/segments.py:196 (segment_sum_radix, pallas_call :227)",
    "even_assign": "cruise_control_tpu/analyzer/kafka_assigner.py:111 (the lax.scan of "
                   "_assign_position, :61; not a Pallas kernel)",
    "graph_loop": "cruise_control_tpu/analyzer/optimizer.py:436-453 (the lax.while_loop of _phase_loop) and "
                  ":559-587 (the goal's pass cycle in _goal_step_fn); not Pallas kernels",
    "count_ctl": "cruise_control_tpu/traces/rollout.py:151 (the lax.scan over time of _rollout_kernel_fn); "
                 "not a Pallas kernel",
}
#: config #2's default path in the JAX reference (BASELINE config #2)
CONFIG2_TOTALS = dict(total_moves=24_019, inter_broker_moves=22_245, leadership_moves=7_497,
                      rounds=310, balancedness=97.666)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def latency_ms(fn, reps: int = 30) -> float:
    """Median single-call latency: CUDA events around ONE call, ``reps`` times
    (after warm-up).  The device idles while the host runs the wrapper, so this
    is host plus device time of one call, not kernel time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def call_ms(fn, calls: int = 200) -> float:
    """Time per call of ``calls`` back-to-back calls (CUDA events around the
    run, divided by the count): what a caller that issues them in a loop pays,
    the larger of host and device time."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fns, calls: int = 30):
    """Per function, the median over ``calls`` calls of the device time one
    call enqueues: the durations of all its kernels and memsets under
    ``torch.profiler``, summed.  Each call runs in its own profiler range,
    ends in a synchronize and is followed by a 2 ms pause.  Also returns the
    first function's device time per call by kernel name."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(calls):
                with record_function("smoke_call"):
                    fn()
                    torch.cuda.synchronize()
                time.sleep(0.002)
    events = prof.events()
    starts = sorted(e.time_range.start for e in events
                    if e.name == "smoke_call" and e.device_type == DeviceType.CPU)
    check(len(starts) == calls * len(fns), f"profiler: {len(starts)} ranges for {calls * len(fns)} calls")
    # a call's device events start between its range's start and the next
    # range's (less 1 ms for the offset between the two clocks; calls are 2 ms
    # apart); the median over calls tolerates an event the profiler drops
    edges = [x - 1000.0 for x in starts] + [float("inf")]
    per_call = [0.0] * len(starts)
    by_name = {}     # the first function's time by kernel name
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name != "smoke_call":
            q = bisect.bisect_right(edges, e.time_range.start) - 1
            check(q >= 0, f"profiler: device event {e.name} before the first call")
            per_call[q] += e.time_range.elapsed_us()
            if q < calls:
                name = e.name.replace("(anonymous namespace)::", "").split("(")[0][-40:]
                by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / calls / 1e3
    out = []
    for i in range(len(fns)):
        us = sorted(per_call[i * calls:(i + 1) * calls])
        check(us[calls // 2] > 0.0, "profiler: most calls show no device time")
        out.append(us[calls // 2] / 1e3)
    return out, by_name


def _kernel_cases(gen):
    """(label, path, value columns, ids, segments) at the solver's shapes."""
    from cruise_control_tpu_torch.ops.index import _window_ids

    R = 30_000

    def ids(S):
        x = torch.randint(0, S, (R,), generator=gen, dtype=torch.int32)
        x[::997] = -1          # dropped ids ride along, as in the solver's sinks
        return x

    def f32(*shape):
        return torch.empty(shape).exponential_(generator=gen) * 1000.0

    def bits(p):
        return torch.rand((R,), generator=gen) < p

    rb = ids(128)
    return [
        ("bload [30000,4] S=128", "segment_sum_f32", [f32(R, 4)], rb, 128),
        ("topic counts [30000] S=12800", "segment_sum_i32",
         [torch.randint(0, 2, (R,), generator=gen, dtype=torch.int32)], ids(12_800), 12_800),
        ("rack counts [30000] bool S=100000", "segment_sum_i32", [bits(0.95)], ids(100_000), 100_000),
        ("[30000,1] S=2048", "segment_sum_f32", [f32(R, 1)], ids(2_048), 2_048),
        ("skewed: all rows in segment 5, [30000,4] S=128", "segment_sum_f32", [f32(R, 4)],
         torch.full((R,), 5, dtype=torch.int32), 128),
        ("snapshot broker call: [30000,4] + 2 bool + 5 f32 -> S=128", "segment_sum_f32",
         [f32(R, 4), bits(0.95), bits(0.33), f32(R), f32(R), f32(R),
          bits(0.05).float(), bits(0.05).float()], rb, 128),
        ("snapshot topic call: 2 bool [30000] -> S=12800", "segment_sum_i32",
         [bits(0.95), bits(0.33)], ids(12_800), 12_800),
        ("assigner position counts: bool [30000] -> 8 x 128 = 1024", "segment_sum_i32",
         [bits(0.97)], ids(1_024), 1_024),
        ("band sums, first level: [128,4] x2 + [128] -> 4 windows", "segment_sum_f32",
         [f32(128, 4), f32(128, 4), f32(128)],
         torch.arange(128, dtype=torch.int32) // 32, 4),
        # the sweep's replication factors (JAX sim/batch.py:88): every lane's
        # replica_valid under ids lane * 10,000 + partition, one call
        (SWEEP_CASE + " bool", "segment_sum_i32", [torch.ones(SIM_SCENARIOS * R, dtype=torch.bool)],
         sweep_ids(), SIM_SCENARIOS * 10_000),
        (SWEEP_CASE + " i32", "segment_sum_i32",
         [torch.randint(0, 2, (SIM_SCENARIOS * R,), generator=gen, dtype=torch.int32)],
         sweep_ids(), SIM_SCENARIOS * 10_000),
        # the first level of the sweep's float totals (sim.batch.sweep_totals):
        # every lane's must-serve load and offline bytes into XLA's 32-row
        # windows, each lane's windows after the last lane's, as one call, as
        # the sweep makes it (ops.index.LANE_CALL_WINDOWS); beside it one call a lane
        (SWEEP_TOTALS_CASE, "segment_sum_f32",
         [f32(SIM_SCENARIOS * R, 4), f32(SIM_SCENARIOS * R)],
         _window_ids(R, torch.device("cpu"), SIM_SCENARIOS), SIM_SCENARIOS * SWEEP_WINDOWS),
        # a rollout step's calls (traces/rollout.py) at the harness's 16 pairs:
        # every pair's replication factors, the first level of every pair's
        # satisfiability totals in one call, the balancedness over the 24
        # goals of every pair
        (f"rollout replication factors: bool [{TRACE_PAIRS} x 30000] -> {TRACE_PAIRS} x 10000", "segment_sum_i32",
         [torch.ones(TRACE_PAIRS * R, dtype=torch.bool)], sweep_ids(TRACE_PAIRS), TRACE_PAIRS * 10_000),
        (ROLLOUT_TOTALS_CASE, "segment_sum_f32", [f32(TRACE_PAIRS * R, 4), f32(TRACE_PAIRS * R)],
         _window_ids(R, torch.device("cpu"), TRACE_PAIRS), TRACE_PAIRS * SWEEP_WINDOWS),
        (f"rollout balancedness: f32 [{TRACE_PAIRS} x 24] -> {TRACE_PAIRS}", "segment_sum_f32",
         [f32(TRACE_PAIRS * 24)], torch.arange(TRACE_PAIRS, dtype=torch.int32).repeat_interleave(24),
         TRACE_PAIRS),
    ] + (_rank_cases(gen, CONFIG2, PARALLEL_RANKS) + _rank_cases(gen, MESH8, MESH8_RANKS, counts=False)
         + _scale_cases(gen) + _ladder_cases(gen) + _lane_cases(gen))


#: the label every case of a lane-form snapshot starts with
LANE_CASE = "lane-stacked"
#: the stacks the lane-form snapshot takes on the main paths, with their
#: cluster: S1's sweep and the rollout's pairs (the sim cluster), and the
#: batched phase's config #2 stacks, whose rounds take the snapshot in its
#: lane form
LANE_STACKS = (("S1", SIM_SCENARIOS, SIM), ("rollout", TRACE_PAIRS, SIM),
               ("config #2 x 4", 4, CONFIG2), ("config #2 x 16", 16, CONFIG2))


def _lane_cases(gen):
    """The lane-form snapshot's kernel calls (``analyzer/context.py`` over a
    stack; 30,000 replicas a lane, bucket 128, 10,000 partitions x 10 racks):
    on the sim cluster (20 topics) S1's 64 lanes and the rollout's 16, on
    config #2 (100 topics) the batched solves' 4 and 16, one call for every
    lane with each lane's ids offset past the last lane's segments -- K1 the
    broker loads (in a round of the batched solve, the snapshot's whole
    broker call), K2 the topic tables and the rack counts.  Every lane's ids
    are lane 0's plus the offset, so the per-lane calls beside each case take
    lane 0's ids."""
    R, B = 30_000, 128
    cases = []
    for tag, lanes, spec in LANE_STACKS:
        BT, PR = B * spec["num_topics"], spec["num_partitions"] * spec["num_racks"]
        rows = lanes * R

        def ids(n):
            x = torch.randint(0, n, (R,), generator=gen, dtype=torch.int32)
            x[::997] = -1
            offset = torch.arange(lanes, dtype=torch.int32)[:, None] * n
            return torch.where(x >= 0, offset + x, -1).reshape(-1)

        def bits(p):
            return torch.rand((rows,), generator=gen) < p

        def f32(*shape):
            return torch.empty(shape).exponential_(generator=gen) * 1000.0

        if spec is CONFIG2:
            broker = (f"{LANE_CASE} {tag}: snapshot broker call: [{rows},4] + 2 bool + 5 f32 -> "
                      f"{lanes} x {B} = {lanes * B}", "segment_sum_f32",
                      [f32(rows, 4), bits(0.95), bits(0.33), f32(rows), f32(rows), f32(rows),
                       bits(0.05).float(), bits(0.05).float()], ids(B), lanes * B)
        else:
            broker = (f"{LANE_CASE} {tag}: bload [{rows},4] -> {lanes} x {B} = {lanes * B}", "segment_sum_f32",
                      [f32(rows, 4)], ids(B), lanes * B)
        cases += [
            broker,
            (f"{LANE_CASE} {tag}: topic tables: 2 bool [{rows}] -> {lanes} x {BT} = {lanes * BT}", "segment_sum_i32",
             [bits(0.95), bits(0.33)], ids(BT), lanes * BT),
            (f"{LANE_CASE} {tag}: rack counts: bool [{rows}] -> {lanes} x {PR} = {lanes * PR}", "segment_sum_i32",
             [bits(0.95)], ids(PR), lanes * PR),
        ]
    return cases


#: the label every case at config #3's shapes starts with
SCALE_CASE = "config #3"
#: BASELINE.md config #3 (the root bench_scale.py:104-121)
CONFIG3 = dict(num_racks=20, num_brokers=1000, num_topics=1000, num_partitions=100_000, replication_factor=3)


def _scale_cases(gen):
    """The snapshot's kernel calls at config #3 (``analyzer/context.py``):
    300,000 replicas into the broker bucket of 1,024 (the load columns alone,
    and the whole broker call: loads, 2 counted bools, 5 float columns), the
    topic tables (bucket x topics = 1,024,000 segments) and the rack counts
    (partitions x racks = 2,000,000)."""
    from cruise_control_tpu_torch.model.arrays import broker_bucket

    R = CONFIG3["num_partitions"] * CONFIG3["replication_factor"]
    B = broker_bucket(CONFIG3["num_brokers"])
    BT, PR = B * CONFIG3["num_topics"], CONFIG3["num_partitions"] * CONFIG3["num_racks"]

    def ids(S):
        x = torch.randint(0, S, (R,), generator=gen, dtype=torch.int32)
        x[::997] = -1
        return x

    def f32(*shape):
        return torch.empty(shape).exponential_(generator=gen) * 1000.0

    def bits(p):
        return torch.rand((R,), generator=gen) < p

    rb = ids(B)
    return [
        (f"{SCALE_CASE}: bload [{R},4] -> S={B}", "segment_sum_f32", [f32(R, 4)], rb, B),
        (f"{SCALE_CASE}: snapshot broker call: [{R},4] + 2 bool + 5 f32 -> S={B}", "segment_sum_f32",
         [f32(R, 4), bits(0.95), bits(0.33), f32(R), f32(R), f32(R), bits(0.05).float(), bits(0.05).float()],
         rb, B),
        (f"{SCALE_CASE}: snapshot topic call: 2 bool [{R}] -> S={BT}", "segment_sum_i32",
         [bits(0.95), bits(0.33)], ids(BT), BT),
        (f"{SCALE_CASE}: rack counts: bool [{R}] -> S={PR}", "segment_sum_i32", [bits(0.95)], ids(PR), PR),
    ]


#: the label every case at the JBOD ladder's shapes starts with
LADDER_CASE = "JBOD ladder"
#: the ladder's rungs (``bench_scale.workload(config4=True, ...)``): 2,500
#: brokers with 250,000 partitions, and config #4 (BASELINE.md: 10,000
#: brokers, 1M partitions, 2,000 topics, 40 racks, RF 3, two logdirs a broker)
LADDER = (dict(brokers=2_500, partitions=250_000), dict(brokers=10_000, partitions=1_000_000))
LADDER_TOPICS, LADDER_RACKS, LADDER_DISKS = 2_000, 40, 2


def ladder_placement(gen, partitions: int, brokers: int):
    """Replica broker ids as ``bench_scale.workload`` places a ladder rung
    (``synthetic.generate`` with ``skew_brokers = brokers // 4``): each
    partition's RF 3 replicas on consecutive brokers of the first quarter."""
    m = brokers // 4
    base = torch.randint(0, m, (partitions,), generator=gen, dtype=torch.int32)
    return ((base[:, None] + torch.arange(3, dtype=torch.int32)[None, :]) % m).reshape(-1)


def _ladder_cases(gen):
    """The snapshot's kernel calls on the JBOD ladder (``analyzer/context.py``,
    ``model/arrays.disk_load``): K1 over every replica into the broker bucket
    (the load columns alone and the whole broker call) and into the logdirs
    (two a broker; padding the broker axis leaves them as they are); at config #4,
    K2's topic tables (bucket x topics = 32,768,000 segments) and rack counts
    (partitions x racks = 40,000,000), and the broker call and the topic
    tables again with the ladder's own skewed placement (every replica on
    the first quarter of the brokers)."""
    from cruise_control_tpu_torch.model.arrays import broker_bucket

    cases = []
    for rung in LADDER:
        R, B = 3 * rung["partitions"], broker_bucket(rung["brokers"])
        D = LADDER_DISKS * rung["brokers"]
        tag = f"{LADDER_CASE}, {rung['brokers']} brokers"

        def ids(S):
            x = torch.randint(0, S, (R,), generator=gen, dtype=torch.int32)
            x[::997] = -1
            return x

        def f32(*shape):
            return torch.empty(shape).exponential_(generator=gen) * 1000.0

        def bits(p):
            return torch.rand((R,), generator=gen) < p

        rb = ids(B)
        cases += [
            (f"{tag}: bload [{R},4] -> S={B}", "segment_sum_f32", [f32(R, 4)], rb, B),
            (f"{tag}: snapshot broker call: [{R},4] + 2 bool + 5 f32 -> S={B}", "segment_sum_f32",
             [f32(R, 4), bits(0.95), bits(0.33), f32(R), f32(R), f32(R), bits(0.05).float(), bits(0.05).float()],
             rb, B),
            (f"{tag}: disk load [{R}] -> S={D}", "segment_sum_f32", [f32(R)], ids(D), D),
        ]
        if rung is LADDER[-1]:
            BT, PR = B * LADDER_TOPICS, rung["partitions"] * LADDER_RACKS
            skewed = ladder_placement(gen, rung["partitions"], rung["brokers"])
            topic = torch.arange(rung["partitions"], dtype=torch.int32).repeat_interleave(3) % LADDER_TOPICS
            cases += [
                (f"{tag}: snapshot topic call: 2 bool [{R}] -> S={BT}", "segment_sum_i32",
                 [bits(0.95), bits(0.33)], ids(BT), BT),
                (f"{tag}: rack counts: bool [{R}] -> S={PR}", "segment_sum_i32", [bits(0.95)], ids(PR), PR),
                (f"{tag}: skewed broker call: [{R},4] + 2 bool + 5 f32 -> S={B}", "segment_sum_f32",
                 [f32(R, 4), bits(0.95), bits(0.33), f32(R), f32(R), f32(R), bits(0.05).float(),
                  bits(0.05).float()], skewed, B),
                (f"{tag}: skewed topic call: 2 bool [{R}] -> S={BT}", "segment_sum_i32",
                 [bits(0.95), bits(0.33)], skewed * LADDER_TOPICS + topic, BT),
            ]
    return cases


#: the label every case of a rank of the sharded solve starts with
RANK_CASE = "rank block"


def _rank_cases(gen, spec, ranks, counts=True):
    """A sharded solve's kernel calls in one rank (``parallel/spmd.py``) at
    ``spec`` over ``ranks`` ranks: the snapshot's fold call, built as
    ``chained_segment_sums`` builds it (one carry row a segment in front of
    the rank's block, the carry float32 for the float columns and int32 for
    the counted bool ones, ids ``arange(S)`` then the block's), and with
    ``counts`` the rank's count partials (topic tables, rack counts, a
    round's per-broker count)."""
    from cruise_control_tpu_torch.model.arrays import broker_bucket

    P = spec["num_partitions"]
    n = -(-P * spec["replication_factor"] // ranks)          # rows a rank, after padding
    B = broker_bucket(spec["num_brokers"])
    T, racks = spec["num_topics"], spec["num_racks"]
    tag = f"{RANK_CASE} of {ranks}, {P * spec['replication_factor']} replicas"

    def block_ids(S):
        x = torch.randint(0, S, (n,), generator=gen, dtype=torch.int32)
        x[::997] = -1
        return x

    def f32(*shape):
        return torch.empty(shape).exponential_(generator=gen) * 1000.0

    def bits(p):
        return torch.rand((n,), generator=gen) < p

    def carried_f32(*shape):          # the previous ranks' float sums
        return torch.cat([f32(B, *shape) * 50.0, f32(n, *shape)])

    def carried_count(p):             # the previous ranks' counts, then this block's bools
        return torch.cat([torch.randint(0, 250, (B,), generator=gen, dtype=torch.int32), bits(p).to(torch.int32)])

    fold_ids = torch.cat([torch.arange(B, dtype=torch.int32), block_ids(B)])
    cases = [(f"{tag}: fold broker call: {B} carry rows + [{n},4] + 2 i32 + 5 f32 -> S={B}", "segment_sum_f32",
              [carried_f32(4), carried_count(0.95), carried_count(0.33), carried_f32(), carried_f32(), carried_f32(),
               carried_f32(), carried_f32()], fold_ids, B)]
    if counts:
        cases += [
            (f"{tag}: topic counts: 2 bool [{n}] -> S={B * T}", "segment_sum_i32",
             [bits(0.95), bits(0.33)], block_ids(B * T), B * T),
            (f"{tag}: rack counts: bool [{n}] -> S={P * racks}", "segment_sum_i32",
             [bits(0.95)], block_ids(P * racks), P * racks),
            (f"{tag}: a round's per-broker count: bool [{n}] -> S={B}", "segment_sum_i32",
             [bits(0.05)], block_ids(B), B),
        ]
    return cases


#: each segment-sum path's kernels (``csrc/segment_sum.cu``), by name
SEGMENT_KERNELS = {
    "segment_sum_f32": ("group_count", "group_offsets", "group_scatter", "group_walk", "pack_rows",
                        "radix_count", "radix_offsets", "radix_scatter", "seg_bounds", "gather_sorted"),
    "segment_sum_i32": ("int_direct", "int_shared"),
}
SWEEP_CASE = "sweep replication factors: [64 x 30000] -> 64 x 10000 = 640000"
#: what the kernels line gives of each case at another path's shapes
SHAPE_KEYS = ("case", "route", "routes", "device_ms", "call_ms", "latency_ms", "plain_device_ms",
              "library_device_ms", "library_call_ms", "bound_ms", "bound_by")
#: XLA's 32-row windows over one lane's 30,000 replicas
SWEEP_WINDOWS = -(-30_000 // 32)
SWEEP_TOTALS_CASE = (f"sweep totals, first level: [64 x 30000,4] + [64 x 30000] -> 64 x {SWEEP_WINDOWS} = "
                     f"{SIM_SCENARIOS * SWEEP_WINDOWS} windows")
ROLLOUT_TOTALS_CASE = (f"rollout totals, first level: [{TRACE_PAIRS} x 30000,4] + [{TRACE_PAIRS} x 30000] -> "
                       f"{TRACE_PAIRS} x {SWEEP_WINDOWS} = {TRACE_PAIRS * SWEEP_WINDOWS} windows")
#: the cases of one call for many lanes: (lanes, one lane's segments) by label prefix
SWEEP_LANE_SEGMENTS = {SWEEP_CASE: (SIM_SCENARIOS, 10_000), SWEEP_TOTALS_CASE: (SIM_SCENARIOS, SWEEP_WINDOWS),
                       ROLLOUT_TOTALS_CASE: (TRACE_PAIRS, SWEEP_WINDOWS)}


def lane_stack(label: str):
    """(lanes, one lane's segments) of a case that is one call for many
    lanes (the sweep's batch-wide calls and the lane-form snapshot's), else
    None."""
    for prefix, split in SWEEP_LANE_SEGMENTS.items():
        if label.startswith(prefix):
            return split
    for tag, lanes, _ in LANE_STACKS:
        if label.startswith(f"{LANE_CASE} {tag}:"):
            return lanes, int(label.rsplit(" = ", 1)[1]) // lanes
    return None


def sweep_ids(lanes: int = SIM_SCENARIOS):
    """The sweep's ids at the harness's shape: lane * P + partition, each
    partition's 3 replicas together, as the synthetic cluster lays them out."""
    rp = torch.arange(10_000, dtype=torch.int32).repeat_interleave(3)
    return (torch.arange(lanes, dtype=torch.int32)[:, None] * 10_000 + rp).reshape(-1)


def _plan_of(SEG, path, rows, segments, columns, fields, dev, route=None):
    if path == "segment_sum_f32":
        return SEG.segment_sums_plan(rows, segments, dev, columns=columns, fields=fields, route=route)
    return SEG.segment_counts_plan(rows, segments, dev, columns=columns, route=route)


def _check_plan(SEG, label, path, plan, rows, segments, columns, fields):
    """The route each path's plan takes for a call
    (``ops.segments.digits_route``; the integer path's shared route where
    every bin fits 57,344 ints and rows outnumber bins 4 to 1), and the
    fixed-order blocks: one_pass takes them from the rows and the card (132+
    from 100,000 rows), digits takes a block a 2,048 rows of 8 warps
    whatever the segments."""
    if path == "segment_sum_f32":
        digits = SEG.digits_route(rows, segments, fields)
        want = "digits" if digits else "one_pass"
        ok = (plan["blocks"] == max(1, -(-rows // 2048)) and plan["warps"] == 8 if digits
              else rows < 100_000 or plan["blocks"] >= 132)
    else:
        bins = columns * segments
        want = "shared" if bins <= 57_344 and rows >= 4 * bins else "direct"
        ok = True
    check(plan["route"] == want and ok, f"{label}: the plan {plan}, want route {want}")


def _other_routes(SEG, label, path, plan, fn, want, rows, segments, columns, fields, dev):
    """Each route the plan does not take, as a function forcing it on the
    same call where it can take it (checked bitwise equal to the plan's
    route), else None."""
    out = {}
    for route in SEG.ROUTES[path]:
        if route == plan["route"]:
            continue
        out[route] = None
        if _plan_of(SEG, path, rows, segments, columns, fields, dev, route)["route"] is None:
            continue

        def forced(route=route):
            with SEG.forced_route(path, route):
                return fn()

        got = forced()
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, want)), f"{label}: route {route} differs")
        out[route] = forced
    return out


def phase_kernels(dev):
    """Every kernel path against its plain version at the solver's shapes:
    floats bitwise equal to the CPU's sequential sum, ints exact, two launches
    bitwise equal; then device time, call time and single-call latency of the
    kernel, the plain version and one ``index_add_`` call (a yardstick the
    port never calls), and the device and call time of the route the plan
    does not take, where it can take the call.  Returns the per-case
    records."""
    from cruise_control_tpu_torch.ops import segments as SEG

    gen = torch.Generator().manual_seed(0)
    records = []
    for label, path, cols_cpu, ids_cpu, S in _kernel_cases(gen):
        cols, ids = [c.to(dev) for c in cols_cpu], ids_cpu.to(dev)
        SEG.reset_launch_counts()
        a = SEG.segment_sums(cols, ids, S)
        b = SEG.segment_sums(cols, ids, S)
        torch.cuda.synchronize()
        check(SEG.LAUNCHES[path] == 2 and sum(SEG.LAUNCHES.values()) == 2,
              f"{label}: {SEG.LAUNCHES} host calls for two calls on {path}")
        plain = SEG.segment_sums_plain(cols, ids, S)
        cpu = SEG.segment_sums_plain(cols_cpu, ids_cpu, S)
        err = 0.0
        for x, y, p, c in zip(a, b, plain, cpu):
            check(torch.isfinite(x.float()).all().item(), f"{label}: non-finite kernel output")
            check(torch.equal(x, y), f"{label}: two launches differ")
            check(x.dtype == c.dtype and x.shape == c.shape, f"{label}: dtype or shape differs")
            check(torch.equal(x.cpu(), c), f"{label}: differs from the CPU sequential sum")
            e = (x.double() - p.double()).abs().max().item() if x.numel() else 0.0
            check(e == 0.0 or x.dtype.is_floating_point, f"{label}: int sums differ by {e}")
            err = max(err, e)

        lib_dtype = torch.float32 if path == "segment_sum_f32" else torch.int32
        flat = torch.cat([c.reshape(c.shape[0], -1).to(lib_dtype) for c in cols], dim=1)
        lib_ids = ids.clamp(min=0).long()
        lib_out = torch.zeros((S, flat.shape[1]), dtype=lib_dtype, device=dev)
        fns = [
            lambda: SEG.segment_sums(cols, ids, S),
            lambda: SEG.segment_sums_plain(cols, ids, S),
            lambda: lib_out.index_add_(0, lib_ids, flat),
        ]
        width = flat.shape[1]
        plan = _plan_of(SEG, path, ids.numel(), S, width, len(cols), dev)
        _check_plan(SEG, label, path, plan, ids.numel(), S, width, len(cols))
        # the other route, timed in the same profiler session
        others = _other_routes(SEG, label, path, plan, fns[0], a, ids.numel(), S, width, len(cols), dev)
        timed_others = [r for r, fn in others.items() if fn is not None]
        # the ladder's calls read up to 3M rows: few reps
        reps = 10 if label.startswith(LADDER_CASE) else None
        dev_ms, phases = device_ms(fns + [others[r] for r in timed_others], calls=reps or 30)
        calls = [call_ms(fn, calls=reps or 200) for fn in fns]
        lat = latency_ms(fns[0], reps=reps or 30)
        routes = {plan["route"]: dict(device_ms=dev_ms[0], call_ms=calls[0])}
        for r in others:
            routes[r] = None if others[r] is None else dict(
                device_ms=dev_ms[3 + timed_others.index(r)], call_ms=call_ms(others[r], calls=reps or 50))
        per_lane = {}
        lane_split = lane_stack(label)
        if lane_split:
            # beside it, one call per lane (lane 0's ids are every lane's, less the offset)
            lanes, lane_segments = lane_split
            lane_ids = ids.view(lanes, -1)[0]
            lane_cols = [c.view(lanes, -1, *c.shape[1:]) for c in cols]

            def per_lane_fn():
                return [SEG.segment_sums([c[i] for c in lane_cols], lane_ids, lane_segments)
                        for i in range(lanes)]

            def per_lane_plain():
                return [SEG.segment_sums_plain([c[i] for c in lane_cols], lane_ids, lane_segments)
                        for i in range(lanes)]

            lane_flat = flat.view(lanes, -1, width)
            lane_lib_ids = lane_ids.clamp(min=0).long()
            lane_out = torch.zeros((lane_segments, width), dtype=lib_dtype, device=dev)

            def per_lane_library():
                for i in range(lanes):
                    lane_out.index_add_(0, lane_lib_ids, lane_flat[i])

            outs = per_lane_fn()
            check(all(torch.equal(torch.cat([o[j] for o in outs]), x) for j, x in enumerate(a)),
                  f"{label}: per-lane calls differ")
            (pl_dev, pl_plain, pl_lib), _ = device_ms([per_lane_fn, per_lane_plain, per_lane_library], calls=10)
            per_lane = dict(per_lane_calls=lanes, per_lane_device_ms=pl_dev,
                            per_lane_call_ms=call_ms(per_lane_fn, calls=20),
                            per_lane_latency_ms=latency_ms(per_lane_fn, reps=10),
                            per_lane_plain_device_ms=pl_plain,
                            per_lane_plain_call_ms=call_ms(per_lane_plain, calls=5),
                            per_lane_library_device_ms=pl_lib,
                            per_lane_library_call_ms=call_ms(per_lane_library, calls=20))
        nbytes = (sum(c.element_size() * c.numel() for c in cols) + 4 * ids.numel()
                  + sum(x.element_size() * x.numel() for x in a))
        ops = ids.numel() * width
        t_bytes, t_ops = nbytes / H100_HBM_BYTES_PER_S, ops / H100_FP32_OPS_PER_S
        rec = dict(
            case=label, path=path, route=plan["route"], routes=routes, plan=plan,
            fields=len(cols), columns=width, max_abs_err=err,
            bitwise_repeat=True, bitwise_vs_cpu_sequential=True,
            device_ms=dev_ms[0], call_ms=calls[0], latency_ms=lat,
            plain_device_ms=dev_ms[1], plain_call_ms=calls[1],
            library_device_ms=dev_ms[2], library_call_ms=calls[2],
            bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
            device_ms_by_kernel=phases, **per_lane,
        )
        say("kernels", **rec)
        records.append(rec)
    return records


def _valid_placement(state) -> bool:
    """Every partition's replicas sit on distinct alive brokers and its leader
    is one of its replicas."""
    rp = state.replica_partition.cpu().numpy()
    rb = state.replica_broker.cpu().numpy()
    alive = state.broker_alive.cpu().numpy()
    leader = state.partition_leader.cpu().numpy()
    pairs = set(zip(rp.tolist(), rb.tolist()))
    return (
        len(pairs) == len(rp)
        and bool(alive[rb].all())
        and bool((rp[leader] == list(range(len(leader)))).all())
    )


def _solve(spec, device):
    from cruise_control_tpu_torch.analyzer import GoalOptimizer

    state, ctx, idx_maps = _case(spec, device)
    return state, ctx, GoalOptimizer(enable_heavy_goals=True, device=device), idx_maps


def _reset_counts() -> None:
    from cruise_control_tpu_torch.ops import assign as PA
    from cruise_control_tpu_torch.ops import segments as SEG

    SEG.reset_launch_counts()
    PA.reset_launch_counts()


def _counts() -> dict:
    """Host calls per kernel path since the last :func:`_reset_counts`."""
    from cruise_control_tpu_torch.ops import assign as PA
    from cruise_control_tpu_torch.ops import segments as SEG

    return {**SEG.LAUNCHES, **PA.LAUNCHES}


def _case(spec, device, removed=(), broker_sets=False):
    """(state, ctx, maps) of a synthetic spec on ``device``: the second logdir
    of each broker in ``removed`` at capacity 0 (a removed logdir), brokers and
    topics in two broker sets by parity when ``broker_sets``."""
    from cruise_control_tpu_torch.analyzer import GoalContext
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    state, maps = generate(SyntheticSpec(**spec), device=device)
    if removed:
        cap = state.disk_capacity.clone()
        cap[[2 * b + 1 for b in removed]] = 0.0
        state = state.replace(disk_capacity=cap)
    kw = {}
    if broker_sets:
        kw = dict(broker_set_of_broker=[b % 2 for b in range(state.num_brokers)],
                  broker_set_of_topic=[t % 2 for t in range(state.num_topics)])
    ctx = GoalContext.build(state.num_topics, state.num_brokers, device=device, **kw)
    return state, ctx, maps


def _goal_rows(res):
    return [[r.name, r.violations_before, r.violations_after, r.rounds, r.moves_applied,
             round(r.duration_s, 3)] for r in res.goal_reports]


def phase_config2(dev):
    from cruise_control_tpu_torch.ops import graph_loop as GL
    from cruise_control_tpu_torch.ops import segments as SEG

    state, ctx, opt, maps = _solve(CONFIG2, dev)
    SEG.reset_launch_counts()
    GL.reset_launch_counts()
    t0 = time.monotonic()
    final, res = opt.optimize(state, ctx, maps=maps)
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    launches, fields, graphs = dict(SEG.LAUNCHES), dict(SEG.FIELDS), dict(GL.LAUNCHES)
    replayed = dict(SEG.REPLAYED)
    t0 = time.monotonic()
    _, warm = opt.optimize(state, ctx, maps=maps)
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    say(
        "config2", cold_wall_s=cold_s, warm_wall_s=warm_s,
        brokers=state.num_brokers, replicas=state.num_replicas,
        total_moves=res.total_moves,
        inter_broker_moves=res.movement.num_inter_broker_moves,
        leadership_moves=res.movement.num_leadership_moves,
        proposals=len(res.proposals),
        residual_hard_violations=res.residual_hard_violations,
        residual_soft_violations=res.residual_soft_violations,
        balancedness=res.balancedness_score,
        num_host_syncs=res.num_host_syncs, warm_num_host_syncs=warm.num_host_syncs,
        rounds=sum(r.rounds for r in res.goal_reports),
        calls=launches, host_calls={k: n - replayed[k] for k, n in launches.items()},
        replayed_calls_derived=replayed, fields_carried=fields, graph_launches=graphs,
        warm_total_moves=warm.total_moves,
        goals=[[r.name, r.violations_before, r.violations_after, r.rounds, r.moves_applied,
                round(r.duration_s, 3)] for r in res.goal_reports],
    )
    check(res.residual_hard_violations == 0, f"config2: hard goals violated {res.violated_hard_goals}")
    check(warm.total_moves == res.total_moves, "config2: warm run differs from cold run")
    check(_valid_placement(final), "config2: invalid final placement")
    for path, n in launches.items():
        check(n > 0, f"config2: kernel path {path} never launched on the main path")
    check(graphs["graph_loop"] == len(res.goal_reports) + 1,
          f"config2: {graphs} goal graphs launched for {len(res.goal_reports)} goals and the pre-phases")
    # the control kernels count themselves on the device; the fetched passes
    # and trip counts must imply the same number (the derived counts rest on them)
    check(graphs["loop_ctl"] == graphs["loop_ctl_by_layout"] > 0,
          f"config2: {graphs['loop_ctl']} control kernels ran, the trip counts imply {graphs['loop_ctl_by_layout']}")
    check(warm.num_host_syncs <= len(warm.goal_reports) + 4,
          f"config2: {warm.num_host_syncs} host syncs in the warm solve (budget #goals + 4)")
    got = dict(total_moves=res.total_moves, inter_broker_moves=res.movement.num_inter_broker_moves,
               leadership_moves=res.movement.num_leadership_moves,
               rounds=sum(r.rounds for r in res.goal_reports),
               balancedness=round(res.balancedness_score, 3))
    check(got == CONFIG2_TOTALS, f"config2: {got} differ from the JAX reference's {CONFIG2_TOTALS}")
    return launches, replayed, graphs, final, res


#: what the loop control reads and writes a step: the carry's four int32
#: words and the goal's four, each once
LOOP_CTL_BYTES = 32


def phase_device_loop(dev):
    """The device loop against its plain version, the host driver, on the
    card: config #2's goal walk (bucketed, as the main path runs it) goal by
    goal, each goal from the same state once as one graph launch
    (``_goal_step_device``) and once through ``_goal_step_fn`` (one host read
    a round), every result bitwise equal; then the plain loop control -- one
    round's condition, round and move counts read on the host -- timed.
    Returns the record for the ``kernels`` line."""
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.analyzer import optimizer as O
    from cruise_control_tpu_torch.analyzer.device_loop import device_loops
    from cruise_control_tpu_torch.analyzer.goal_rounds import GOAL_ROUNDS
    from cruise_control_tpu_torch.ops import graph_loop as GL

    runtime, driver = GL.cuda_versions()
    check(runtime >= GL.MIN_CUDA_VERSION and driver >= GL.MIN_CUDA_VERSION,
          f"device loop: CUDA runtime {runtime}, driver {driver}: no conditional graph nodes")
    state, ctx, opt, _ = _solve(CONFIG2, dev)
    state, ctx, _ = opt._bucketed(state, ctx)
    loops = device_loops(dev)
    fields = ("replica_broker", "partition_leader", "replica_disk")
    prior, rows, walls, max_err, host_syncs = (), [], [0.0, 0.0], 0.0, 0
    for gid in opt.goal_ids:
        kw = dict(gid=gid, round_fns=GOAL_ROUNDS[gid], max_rounds=opt.max_rounds_per_phase,
                  enable_heavy=True, prior_ids=prior, admit_ids=prior + (gid,))
        out = []
        for i, step in enumerate((lambda sy: O._goal_step_device(loops, state, ctx, syncs=sy, **kw),
                                  lambda sy: O._goal_step_fn(state, ctx, syncs=sy, **kw))):
            syncs = O.HostSyncs()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            final, *scalars = step(syncs)
            scalars = [float(x) for x in O.host_fetch(syncs, scalars)]
            torch.cuda.synchronize()
            walls[i] += time.monotonic() - t0
            host_syncs += syncs.count if i else 0
            out.append((final, scalars))
        (dfinal, dvals), (hfinal, hvals) = out
        for f in fields:
            max_err = max(max_err, float((getattr(dfinal, f) - getattr(hfinal, f)).abs().max()))
        max_err = max(max_err, max(abs(a - b) for a, b in zip(dvals, hvals)))
        rows.append([G.GOAL_NAMES[gid], *dvals])
        state, prior = dfinal, prior + (gid,)
    # the plain loop control: a round's condition read on the host
    carry = O.phase_carry(state)
    syncs = O.HostSyncs()
    for _ in range(20):
        syncs.tolist(torch.stack([O.phase_cond(carry, 2000).to(torch.int32), carry.it, carry.total]))
    t0 = time.perf_counter()
    for _ in range(200):
        syncs.tolist(torch.stack([O.phase_cond(carry, 2000).to(torch.int32), carry.it, carry.total]))
    plain_ms = (time.perf_counter() - t0) / 200 * 1e3
    goals = len(opt.goal_ids)
    say("device_loop", cuda_runtime=runtime, cuda_driver=driver, goals=goals,
        device_loop_walk_s=walls[0], host_loop_walk_s=walls[1], host_loop_syncs=host_syncs,
        max_abs_err=max_err, plain_control_ms=plain_ms,
        goal_rows=[[n, int(r), int(m), b, a] for n, r, m, b, a in rows])
    check(max_err == 0.0, f"device loop: the graph's goals differ from the host loop's by {max_err}")
    return dict(max_abs_err=max_err, plain_ms=plain_ms, goal_ms=walls[0] / goals * 1e3,
                plain_goal_ms=walls[1] / goals * 1e3)


def phase_assign(dev):
    """The kafka-assigner pass against its plain version: three passes (RF 3)
    on the card and in the CPU loop, counts and picks equal exactly; then the
    kernel's device time, call time and single-call latency per launch, and
    the plain loop's time per pass on the CPU.  Returns the per-shape records."""
    from cruise_control_tpu_torch.ops import assign as PA

    gen = torch.Generator().manual_seed(1)
    records = []
    for label, P, B, alive, racks in (
        ("config #2: P=10000, B=128 (100 eligible), RF 3, 10 racks", 10_000, 128, 100, 10),
        ("P=10000, B=2048, RF 3, 40 racks", 10_000, 2_048, 2_048, 40),
    ):
        rf = torch.full((P,), 3, dtype=torch.int32)
        excluded = torch.rand(P, generator=gen) < 0.02
        rack = torch.arange(B, dtype=torch.int32) % racks
        eligible = torch.arange(B) < alive
        cpu_in, gpu_in = (rf, excluded, rack, eligible), tuple(x.to(dev) for x in (rf, excluded, rack, eligible))
        counts_c = torch.zeros((3, B), dtype=torch.int32)
        chosen_c = torch.full((P, 3), -1, dtype=torch.int32)
        counts_g, chosen_g = counts_c.to(dev), chosen_c.to(dev)
        t0 = time.monotonic()
        for pos in range(3):
            PA.even_assign(counts_c[pos], chosen_c, pos, *cpu_in)
        plain_ms = (time.monotonic() - t0) * 1e3 / 3

        def passes():
            for pos in range(3):
                PA.even_assign(counts_g[pos], chosen_g, pos, *gpu_in)

        PA.reset_launch_counts()
        passes()
        torch.cuda.synchronize()
        check(PA.LAUNCHES["even_assign"] == 3, f"{label}: {PA.LAUNCHES} launches for three passes")
        check(torch.equal(counts_g.cpu(), counts_c), f"{label}: counts differ from the plain version")
        check(torch.equal(chosen_g.cpu(), chosen_c), f"{label}: picks differ from the plain version")
        spread = [int(counts_c[pos, :alive].max() - counts_c[pos, :alive].min()) for pos in range(3)]
        check(max(spread) <= 1, f"{label}: uneven counts {spread}")
        (dev_ms,), by_kernel = device_ms([passes], calls=10)
        call = call_ms(passes, calls=10)
        lat = latency_ms(passes, reps=10)
        # per pass: counts in and out, earlier picks read (pos columns), picks
        # written, rf, excluded, racks, eligibility; two argmins over B a partition
        nbytes = sum(8 * B + 4 * P * pos + 4 * P + 5 * P + 5 * B for pos in range(3)) / 3
        ops = 2 * P * B
        t_bytes, t_ops = nbytes / H100_HBM_BYTES_PER_S, ops / H100_FP32_OPS_PER_S
        rec = dict(
            case=label, partitions=P, brokers=B, max_abs_err=0.0, equal_to_plain=True,
            position_spread=spread, device_ms=dev_ms / 3, call_ms=call / 3, latency_ms=lat / 3,
            plain_ms=plain_ms, us_per_partition=dev_ms / 3 / P * 1e3,
            bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
            device_ms_by_kernel=by_kernel,
        )
        say("assign", **rec)
        records.append(rec)

    # the lane grid: a stack's position pass as one launch, a block a lane
    # (config #2's shape, 4 lanes with their own eligible brokers), against the
    # plain version (a loop over the lanes) and one launch a lane
    lanes, P, B, racks = 4, 10_000, 128, 10
    rf = torch.full((lanes, P), 3, dtype=torch.int32)
    excluded = torch.rand((lanes, P), generator=gen) < 0.02
    rack = (torch.arange(B, dtype=torch.int32) % racks).repeat(lanes, 1)
    eligible = torch.arange(B)[None, :] < torch.tensor([100, 101, 102, 99])[:, None]
    cpu_in = (rf, excluded, rack, eligible)
    gpu_in = tuple(x.to(dev) for x in cpu_in)
    counts_c = torch.zeros((3, lanes, B), dtype=torch.int32)
    chosen_c = torch.full((lanes, P, 3), -1, dtype=torch.int32)
    counts_g, chosen_g = counts_c.to(dev), chosen_c.to(dev)
    t0 = time.monotonic()
    for pos in range(3):
        PA.even_assign(counts_c[pos], chosen_c, pos, *cpu_in)
    plain_ms = (time.monotonic() - t0) * 1e3 / 3

    def lane_passes():
        for pos in range(3):
            PA.even_assign(counts_g[pos], chosen_g, pos, *gpu_in)

    one_counts = counts_c.to(dev).zero_()
    one_chosen = chosen_c.to(dev).fill_(-1)

    def per_lane_passes():
        for pos in range(3):
            for i in range(lanes):
                PA.even_assign(one_counts[pos, i], one_chosen[i], pos, *(x[i] for x in gpu_in))

    PA.reset_launch_counts()
    lane_passes()
    torch.cuda.synchronize()
    label = f"lane grid: {lanes} lanes of P=10000, B=128, RF 3, one launch a pass"
    check(PA.LAUNCHES["even_assign"] == 3, f"{label}: {PA.LAUNCHES} launches for three passes")
    check(torch.equal(counts_g.cpu(), counts_c) and torch.equal(chosen_g.cpu(), chosen_c),
          f"{label}: differs from the plain version")
    per_lane_passes()
    torch.cuda.synchronize()
    check(torch.equal(one_chosen.cpu(), chosen_c), f"{label}: one launch a lane differs")
    (dev_ms, per_lane_ms), by_kernel = device_ms([lane_passes, per_lane_passes], calls=10)
    nbytes = lanes * sum(8 * B + 4 * P * pos + 4 * P + 5 * P + 5 * B for pos in range(3)) / 3
    t_bytes, t_ops = nbytes / H100_HBM_BYTES_PER_S, lanes * 2 * P * B / H100_FP32_OPS_PER_S
    rec = dict(
        case=label, lanes=lanes, partitions=P, brokers=B, max_abs_err=0.0, equal_to_plain=True,
        device_ms=dev_ms / 3, call_ms=call_ms(lane_passes, calls=10) / 3, latency_ms=latency_ms(lane_passes, reps=10) / 3,
        plain_ms=plain_ms, per_lane_launches_device_ms=per_lane_ms / 3,
        bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
        device_ms_by_kernel=by_kernel,
    )
    say("assign", **rec)
    records.append(rec)
    return records


def _run_path(label, spec, dev, goal_ids, hard_ids, removed=(), broker_sets=False):
    """One optional-goal path at full width, cold then warm, the launch
    counts read around the cold solve.  Hard-goal failure raises."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizationFailure

    state, ctx, maps = _case(spec, dev, removed, broker_sets)
    opt = GoalOptimizer(goal_ids=goal_ids, hard_ids=hard_ids, enable_heavy_goals=True, device=dev)
    _reset_counts()
    t0 = time.monotonic()
    try:
        final, res = opt.optimize(state, ctx, maps=maps, raise_on_hard_failure=True)
    except OptimizationFailure as exc:
        raise SmokeFailure(f"{label}: {exc}") from exc
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    launches = _counts()
    t0 = time.monotonic()
    _, warm = opt.optimize(state, ctx, maps=maps)
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    say(
        "path", path=label, goal_ids=list(goal_ids), hard_ids=list(hard_ids),
        cold_wall_s=cold_s, warm_wall_s=warm_s, brokers=state.num_brokers,
        replicas=state.num_replicas, disks=state.num_disks,
        total_moves=res.total_moves, inter_broker_moves=res.movement.num_inter_broker_moves,
        intra_broker_moves=res.movement.num_intra_broker_moves,
        leadership_moves=res.movement.num_leadership_moves, proposals=len(res.proposals),
        violated_hard_goals=res.violated_hard_goals, balancedness=res.balancedness_score,
        num_host_syncs=res.num_host_syncs, rounds=sum(r.rounds for r in res.goal_reports),
        host_calls=launches, goals=_goal_rows(res), warm_total_moves=warm.total_moves,
    )
    check(not res.violated_hard_goals, f"{label}: hard goals violated {res.violated_hard_goals}")
    check(warm.total_moves == res.total_moves, f"{label}: warm run differs from cold run")
    check(_valid_placement(final), f"{label}: invalid final placement")
    for path in ("segment_sum_f32", "segment_sum_i32"):
        check(launches[path] > 0, f"{label}: kernel path {path} never launched")
    return state, final, res, launches


def phase_paths(dev):
    """P1-P3 at config #2 width.  Returns P1's launch counts."""
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.analyzer.kafka_assigner import replica_positions

    # P1: the kafka-assigner mode
    _, final, res, p1 = _run_path("P1 kafka assigner", CONFIG2, dev, (22, 23), (22,))
    check(res.violations_after["KafkaAssignerEvenRackAwareGoal"] == 0, "P1: goal 22 not met")
    check(p1["even_assign"] == 3, f"P1: {p1['even_assign']} even_assign launches, want 3 (RF 3)")
    pos = replica_positions(final).cpu().numpy()
    rb = final.replica_broker.cpu().numpy()
    alive = final.broker_alive.cpu().numpy()
    for q in range(3):
        per_broker = np.bincount(rb[pos == q], minlength=final.num_brokers)[alive]
        check(per_broker.max() - per_broker.min() <= 1, f"P1: position {q} uneven: {per_broker.min()}-{per_broker.max()}")

    # P2: the JBOD north-star list, the default hard goals
    _run_path("P2 JBOD north star", dict(CONFIG2, **JBOD), dev, NORTH_STAR, G.HARD_GOALS)

    # P3: REMOVE_DISKS of the second logdir of brokers 0-9
    removed = tuple(range(10))
    _, final, res, _ = _run_path("P3 remove disks", dict(CONFIG2, **JBOD, **REMOVE_DISKS_LOAD), dev,
                                 (16,), (16,), removed=removed)
    check(res.violations_after["IntraBrokerDiskCapacityGoal"] == 0, "P3: goal 16 not met")
    check(res.movement.num_inter_broker_moves == 0, "P3: replicas left their brokers")
    disk = final.replica_disk.cpu().numpy()[final.replica_valid.cpu().numpy()]
    check(not np.isin(disk, [2 * b + 1 for b in removed]).any(), "P3: replicas left on removed logdirs")
    check(res.movement.num_intra_broker_moves > 0, "P3: nothing drained")
    return p1


def make_scenarios(n: int, brokers: int = 100):
    """The JAX sweep harness's scenarios (scripts/bench_sim.py:45-58): broker
    adds x load scaling x spot failures."""
    from cruise_control_tpu_torch.sim import Scenario

    return [
        Scenario(
            name=f"s{i}", add_brokers=i % 8,
            kill_brokers=(i % min(5, brokers),) if i % 3 == 0 else (),
            load_factor=1.0 + 0.02 * i,
        )
        for i in range(n)
    ]


def _verdict_rows(sweep):
    return [[v.name, v.verdict, v.hard_violations, v.balancedness, v.min_brokers_needed,
             v.offline_moves, (v.movement or {}).get("num_inter_broker_moves"), v.provision_status]
            for v in sweep.scenarios]


def _same_placement(a, b) -> bool:
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in ("replica_broker", "partition_leader", "replica_disk"))


def _same_arrays(a, b) -> bool:
    """Every tensor field of two ``ClusterArrays`` equal, shape and value."""
    import dataclasses

    ts = [(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)]
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in ts if isinstance(x, torch.Tensor))


def _drift_lanes(final, factors):
    """Each factor's drift of a solved placement: topics 0-9 scaled by it."""
    from cruise_control_tpu_torch.sim import Scenario, apply_scenario

    return [apply_scenario(final, Scenario(topic_load_factors=tuple((t, f) for t in range(10))))
            for f in factors]


def _incremental_lanes(opt, lanes, ctx, dev):
    """Each lane's own incremental solve, then the batched solve of all of
    them: (singles, batched final, batched result, wall of the batched solve).
    Fails unless every lane of the batch equals its own solve."""
    from cruise_control_tpu_torch.model.arrays import index_arrays, stack_arrays

    singles = [opt.incremental_optimize(x, ctx, max_rounds=SIM_MAX_ROUNDS) for x in lanes]
    t0 = time.monotonic()
    bfinal, bres = opt.batched_incremental_optimize(stack_arrays(lanes), ctx, max_rounds=SIM_MAX_ROUNDS)
    _sync(dev)
    wall = time.monotonic() - t0
    for i, ((final, res), lane) in enumerate(zip(singles, bres.results)):
        check(_same_placement(index_arrays(bfinal, i), final), f"batched incremental lane {i} placement differs")
        check(lane.total_moves == res.total_moves and (lane.violations_after == res.violations_after).all(),
              f"batched incremental lane {i}: {lane.total_moves} moves against {res.total_moves}")
    return singles, bfinal, bres, wall


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


#: a device event of :func:`_profiled`: kernel or memset name, its time in µs
DeviceEvent = collections.namedtuple("DeviceEvent", "name device_time_total correlation")


def _profiled(fn):
    """One call of ``fn`` under ``torch.profiler`` (device activity only):
    ``(its result, wall s, the device events)``.  The events are read from
    the profiler's raw records, with the same names and durations: building
    its ``FunctionEvent`` list for the ~440,000 kernels of a config #2 solve
    took most of the profile phase's 96 s on an H100 host (PERF.md §7)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    return out, wall_s, [DeviceEvent(e.name(), e.duration_ns() / 1e3, e.correlation_id())
                         for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]


def phase_sim(dev, config2_final):
    """The what-if planner and the incremental solves on the card.

    S1 ``fast_sweep`` of the JAX sweep harness's 64 scenarios on its
    100-broker, 10,000-partition cluster (bucket 128), cold then warm; S2
    ``deep_sweep`` of s0-s3 (default goals, heavy goals off); S3
    ``plan_capacity`` at load 1.0; S4 ``evaluate_drift``,
    ``incremental_optimize`` and ``batched_incremental_optimize`` on config
    #2's solved placement with topics 0-9 scaled.  Returns the kernel host
    calls of S1's cold sweep."""
    from cruise_control_tpu_torch import sim
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.controller import evaluate_drift
    from cruise_control_tpu_torch.sim import batch as SB
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    base, _ = generate(SyntheticSpec(**SIM), device="cpu")
    scs = make_scenarios(SIM_SCENARIOS)

    # S1: the fast sweep, cold then warm; then warm at 8 lanes (the host calls must not grow with the lanes)
    _reset_counts()
    t0 = time.monotonic()
    cold = sim.fast_sweep(base, scs, device=dev)
    _sync(dev)
    cold_s = time.monotonic() - t0
    calls = _counts()
    _reset_counts()
    t0 = time.monotonic()
    warm = sim.fast_sweep(base, scs, device=dev)
    _sync(dev)
    warm_s = time.monotonic() - t0
    warm_calls = _counts()
    _reset_counts()
    t0 = time.monotonic()
    sim.fast_sweep(base, scs[:8], device=dev)
    _sync(dev)
    warm8_s, calls8 = time.monotonic() - t0, _counts()
    prof, prof_s, events = _profiled(lambda: sim.fast_sweep(base, scs, device=dev))
    busy_s = sum(e.device_time_total for e in events) / 1e6
    # the batch-wide sums alone (one integer call at the sweep shape; the float
    # totals one call a level for all lanes), at 64 lanes and at 8; the rest
    # is the lane-form evaluation, one snapshot and one violation pass for all
    # lanes; neither's host calls may grow with the lanes
    batch_calls, evaluation = [], []
    for lanes, total in ((scs, warm_calls), (scs[:8], calls8)):
        batch = sim.build_batch(base, lanes, device=dev)
        ctx = GoalContext.build(base.num_topics, batch.bucket[0], device=dev)
        _reset_counts()
        SB._sweep_reductions(batch.states, ctx)
        _sync(dev)
        batch_calls.append(_counts())
        evaluation.append({p: total[p] - batch_calls[-1][p] for p in ("segment_sum_f32", "segment_sum_i32")})
    batch = sim.build_batch(base, scs, device=dev)
    ctx = GoalContext.build(base.num_topics, batch.bucket[0], device=dev)
    # the CPU port: every lane's verdict, and the batch-wide totals bitwise
    t0 = time.monotonic()
    cpu64 = sim.fast_sweep(base, scs, device="cpu")
    cpu64_s = time.monotonic() - t0
    cpu8 = sim.fast_sweep(base, scs[:8], device="cpu")
    cpu_batch = sim.build_batch(base, scs, device="cpu")
    totals = [SB.sweep_totals(batch.states, ctx), SB.sweep_totals(cpu_batch.states, ctx.to("cpu"))]
    same_totals = [torch.equal(x.cpu(), y) for x, y in zip(*totals)]
    say("sim", step="S1 fast_sweep", scenarios=len(scs), bucket=list(cold.bucket),
        cold_wall_s=cold_s, warm_wall_s=warm_s, num_host_syncs=warm.num_host_syncs,
        host_calls=calls, host_calls_per_sweep=warm_calls, host_calls_at_8_lanes=calls8, warm_wall_8_lanes_s=warm8_s,
        host_calls_batch_wide=batch_calls[0], host_calls_batch_wide_at_8_lanes=batch_calls[1],
        host_calls_evaluation=evaluation[0], host_calls_evaluation_at_8_lanes=evaluation[1],
        profiled_wall_s=prof_s, device_busy_s=busy_s, device_idle_share=1.0 - busy_s / prof_s,
        kernel_launches=len(events), cpu_port_wall_s=cpu64_s,
        satisfiable=sum(v.satisfiable for v in warm.scenarios),
        min_brokers_needed=sorted({v.min_brokers_needed for v in warm.scenarios}),
        totals_bitwise_vs_cpu=same_totals, verdicts=_verdict_rows(warm)[:8])
    for other, what in ((warm, "warm sweep"), (prof, "profiled sweep")):
        check([v.to_dict() for v in other.scenarios] == [v.to_dict() for v in cold.scenarios], f"S1: {what} differs")
    check([v.to_dict() for v in cold.scenarios] == [v.to_dict() for v in cpu64.scenarios],
          "S1: lanes differ from the CPU port's sweep of all 64")
    check([v.to_dict() for v in cold.scenarios[:8]] == [v.to_dict() for v in cpu8.scenarios],
          "S1: lanes s0-s7 differ from the CPU port's sweep of them")
    check(all(same_totals), f"S1: batch-wide totals differ from the CPU port's ({same_totals})")
    check(batch_calls[0]["segment_sum_i32"] == 1 and evaluation[0]["segment_sum_i32"] > 0,
          f"S1: the sweep-shape integer call did not launch once ({batch_calls[0]})")
    check(evaluation[0] == evaluation[1] and all(calls8[p] == warm_calls[p] for p in evaluation[0]),
          f"S1: the kernels' host calls grow with the lanes: {calls8} at 8, {warm_calls} at 64 "
          f"(the evaluation's {evaluation[1]}, {evaluation[0]})")

    # S2: the deep sweep of s0-s3 (one batched solve); every lane against its direct solve on the card
    sim.deep_sweep(base, scs[:4], device=dev)
    _sync(dev)
    t0 = time.monotonic()
    deep = sim.deep_sweep(base, scs[:4], device=dev)
    _sync(dev)
    deep_s = time.monotonic() - t0
    bucket = deep.bucket[0]
    direct_opt = GoalOptimizer(enable_heavy_goals=False, bucket_brokers=False, device=dev)
    direct_ctx = GoalContext.build(base.num_topics, bucket, device=dev)
    direct_s = []
    for i, (v, st) in enumerate(zip(deep.scenarios, deep.states)):
        t0 = time.monotonic()
        direct, direct_res = direct_opt.optimize(sim.apply_scenario(base, scs[i], bucket_brokers=bucket), direct_ctx)
        _sync(dev)
        direct_s.append(time.monotonic() - t0)
        check(_valid_placement(st), f"S2 {v.name}: invalid placement")
        check(_same_placement(st, direct), f"S2: lane {i} differs from its direct solve")
        check(v.balancedness == direct_res.balancedness_score, f"S2: lane {i} balancedness differs")
    say("sim", step="S2 deep_sweep", scenarios=4, warm_wall_s=deep_s, num_host_syncs=deep.num_host_syncs,
        direct_walls_s=direct_s, verdicts=_verdict_rows(deep))

    # S3: the capacity plan at load 1.0
    t0 = time.monotonic()
    plan = sim.plan_capacity(base, load_factor=1.0, device=dev)
    _sync(dev)
    rec = plan.recommendation
    say("sim", step="S3 plan_capacity", wall_s=time.monotonic() - t0, probes=len(plan.probes),
        min_brokers=plan.min_brokers, sweeps=plan.num_host_syncs, num_host_syncs=plan.num_host_syncs,
        status=rec.status, message=rec.message, bucket=rec.sweep["bucket_brokers"])
    check(plan.min_brokers is not None and plan.min_brokers <= plan.current_brokers, "S3: no satisfiable count")

    # S4: drift and the incremental solves on config #2's solved placement
    opt = GoalOptimizer(enable_heavy_goals=True, device=dev)
    ctx2 = GoalContext.build(config2_final.num_topics, sim.broker_bucket(config2_final.num_brokers), device=dev)
    solved = sim.apply_scenario(config2_final, sim.Scenario())
    lanes = _drift_lanes(config2_final, (1.1, 1.2, 1.3, 1.4))
    at_solve = opt.violations(solved, ctx2).cpu().numpy()
    now = opt.violations(lanes[2], ctx2).cpu().numpy()
    drift = evaluate_drift(now, at_solve, opt.goal_ids, opt.hard_ids)
    _reset_counts()
    t0 = time.monotonic()
    inc_final, inc = opt.incremental_optimize(lanes[2], ctx2, max_rounds=SIM_MAX_ROUNDS, violations=now)
    _sync(dev)
    inc_s = time.monotonic() - t0
    inc_calls = _counts()
    singles, _, bres, batched_s = _incremental_lanes(opt, lanes, ctx2, dev)
    check(_same_placement(singles[2][0], inc_final), "S4: the probe-fed solve differs from the probing one")
    say("sim", step="S4 incremental", drift_score=drift.score, drift_hard_score=drift.hard_score,
        drifted_goals=drift.violated_goals, balancedness_drop=drift.balancedness_drop,
        goals_run=inc.goals_run, moves=inc.total_moves, rounds=inc.total_rounds,
        num_host_syncs=inc.num_host_syncs, wall_s=inc_s, host_calls=inc_calls,
        residual=inc.residual_violations,
        batched=dict(lanes=4, wall_s=batched_s, goals_run=bres.goals_run, num_host_syncs=bres.num_host_syncs,
                     moves=[r.total_moves for r in bres.results], rounds=[r.total_rounds for r in bres.results],
                     lane_goals_run=[r.goals_run for r in bres.results]))
    check(drift.score > 0 and inc.goals_run, "S4: the drift ran no goal")
    return calls


#: the batched phase's stacks: config #2 under the first 4 and 16 of the JAX
#: sweep harness's scenarios (S2's), one lane each
BATCHED_LANES = (4, 16)
#: the lanes the CPU port's batched solve (in a child process) holds
BATCHED_CPU_LANES = 4


def _batched_stack(lanes, device):
    """(stack, ctx): config #2 under ``make_scenarios(lanes)``, padded to one
    broker bucket (``sim.build_batch``, as ``deep_sweep`` builds its lanes)."""
    from cruise_control_tpu_torch import sim
    from cruise_control_tpu_torch.analyzer import GoalContext
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    base, _ = generate(SyntheticSpec(**CONFIG2), device="cpu")
    batch = sim.build_batch(base, make_scenarios(lanes), device=device)
    return batch.states, GoalContext.build(base.num_topics, batch.bucket[0], device=device)


def _lane_digest(states, i) -> str:
    """sha256 of lane ``i``'s placement (brokers, leaders, logdirs)."""
    import hashlib

    h = hashlib.sha256()
    for f in ("replica_broker", "partition_leader", "replica_disk"):
        h.update(getattr(states, f)[i].cpu().numpy().tobytes())
    return h.hexdigest()


def _report_rows(res):
    """A result's goal reports without their walls."""
    return [[r.name, r.violations_before, r.violations_after, r.rounds, r.moves_applied] for r in res.goal_reports]


def batched_cpu_child() -> None:
    """The CPU port's batched solve of the batched phase's 4-lane stack, in
    a process of its own so that it runs beside the card's phases
    (``python -c "import chip_smoke; chip_smoke.batched_cpu_child()"``):
    prints one JSON object, each lane's placement digest and goal rows."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer

    torch.set_num_threads(3)
    states, ctx = _batched_stack(BATCHED_CPU_LANES, "cpu")
    t0 = time.monotonic()
    final, res = GoalOptimizer(enable_heavy_goals=True, bucket_brokers=False, device="cpu").batched_optimize(
        states, ctx)
    print(json.dumps(dict(wall_s=time.monotonic() - t0, num_host_syncs=res.num_host_syncs,
                          digests=[_lane_digest(final, i) for i in range(BATCHED_CPU_LANES)],
                          rows=[_report_rows(r) for r in res.results])), flush=True)


def start_batched_cpu_child():
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.batched_cpu_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _batched_run(opt, states, ctx, dev):
    """One warm batched solve with every count set to 0 just before it:
    (final, result, wall s, kernel host calls, graph-loop counts, peak bytes)."""
    from cruise_control_tpu_torch.ops import graph_loop as GL

    _sync(dev)
    _reset_counts()
    GL.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    final, res = opt.batched_optimize(states, ctx)
    _sync(dev)
    wall = time.monotonic() - t0
    return final, res, wall, _counts(), dict(GL.LAUNCHES), torch.cuda.max_memory_allocated(dev)


def phase_batched(dev, cpu_child):
    """The solver's lane form on the card (``analyzer/lanes.py``): config #2
    with the 16 default goals over stacks of 4 and 16 lanes (S2's scenarios)
    through ``GoalOptimizer.batched_optimize`` -- each goal one graph launch
    for the whole stack -- cold, then warm with every count from 0; then each
    lane's own solve on the card, warm, in the same run (the 16-lane stack's
    first 4 lanes are the 4-lane stack's, so their solves are the 4-lane
    run's, not solved again).  Fails unless every lane equals its own solve
    (placement, leaders, logdirs, per-goal rounds, moves and violations), the
    16-lane stack's first 4 lanes equal the 4-lane stack's, the 4-lane stack
    equals the CPU port's batched solve (run in a child process since the
    kernels phase ended), the graph launches are the goals plus the offline
    pre-phases' one (not lanes x goals), the control
    kernels the device counted equal the layout's, and both segment-sum paths
    and the loop control ran in the warm solve.  Then one long lane and 15
    that apply nothing, against walking the lanes (the lane form's worst
    case; the 15 identical short lanes are walked once and counted 15
    times).  Then P1's goals (22, 23) over the 4-lane stack: the assigner's
    position passes one lane-grid ``even_assign`` launch each for the stack
    (3: RF 3), every lane equal to its own P1 solve (a lane with a killed
    broker may leave goal 22 unmet, as its own solve does).  Returns the
    counts of the 4-lane warm solve and of the batched P1."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.model.arrays import index_arrays

    opt = GoalOptimizer(enable_heavy_goals=True, bucket_brokers=False, device=dev)
    goals = len(opt.goal_ids)
    out, finals = {}, {}
    single = {}     # lane -> (its own solve's placement, goal rows, warm wall)
    first = None
    for lanes in BATCHED_LANES:
        states, ctx = _batched_stack(lanes, dev)
        if first is None:
            first = states
        for i in range(len(single)):      # a lane solved alone before is this stack's lane too
            check(_same_arrays(index_arrays(states, i), index_arrays(first, i)),
                  f"batched x{lanes}: lane {i}'s input differs from the {BATCHED_LANES[0]}-lane stack's")
        t0 = time.monotonic()
        opt.batched_optimize(states, ctx)
        _sync(dev)
        cold_s = time.monotonic() - t0
        final, res, warm_s, calls, graphs, peak = _batched_run(opt, states, ctx, dev)
        finals[lanes] = final, res
        if not single:
            opt._optimize_core(index_arrays(states, 0), ctx)      # the one-lane shape captured
        for i in range(len(single), lanes):
            _sync(dev)
            t0 = time.monotonic()
            f1, r1 = opt._optimize_core(index_arrays(states, i), ctx)
            _sync(dev)
            single[i] = f1, _report_rows(r1), time.monotonic() - t0
        single_s = sum(single[i][2] for i in range(lanes))
        for i in range(lanes):
            check(_same_placement(index_arrays(final, i), single[i][0]),
                  f"batched x{lanes}: lane {i} differs from its own solve")
            check(_report_rows(res.results[i]) == single[i][1],
                  f"batched x{lanes}: lane {i}'s goal rows differ from its own solve's")
        trips = graphs["round_trips"]
        out[lanes] = dict(calls=calls, graphs=graphs)
        say("batched", lanes=lanes, goals=goals, cold_wall_s=cold_s, warm_wall_s=warm_s,
            singles_warm_wall_s=single_s, num_host_syncs=res.num_host_syncs,
            graph_launches=graphs["graph_loop"], loop_ctl=graphs["loop_ctl"],
            loop_ctl_by_layout=graphs["loop_ctl_by_layout"], round_trips=trips,
            kernels_a_round=graphs["round_nodes"] / max(trips, 1), host_calls=calls,
            peak_memory_bytes=peak, moves=[r.total_moves for r in res.results],
            rounds=[sum(g.rounds for g in r.goal_reports) for r in res.results],
            hard_violated=[r.violated_hard_goals for r in res.results])
        check(graphs["graph_loop"] == goals + 1,
              f"batched x{lanes}: {graphs['graph_loop']} graph launches, want {goals} goals + the pre-phases' 1")
        check(graphs["loop_ctl"] == graphs["loop_ctl_by_layout"] > 0,
              f"batched x{lanes}: control kernels {graphs['loop_ctl']} on the device, {graphs['loop_ctl_by_layout']} by layout")
        for path in ("segment_sum_f32", "segment_sum_i32"):
            check(calls[path] > 0, f"batched x{lanes}: {path} never launched")
    (small, res4), (big, _) = finals[BATCHED_LANES[0]], finals[BATCHED_LANES[1]]
    for i in range(BATCHED_LANES[0]):
        check(_same_placement(index_arrays(small, i), index_arrays(big, i)),
              f"batched: lane {i} of the 16-lane stack differs from the 4-lane stack's")

    # the lane form's worst case: one long lane (s0 unsolved) and 15 that
    # apply nothing (s0 solved) -- every round of the long lane pays 16 lanes'
    # work, where walking the lanes pays one lane's work a round
    from cruise_control_tpu_torch.model.arrays import stack_arrays

    states, ctx = _batched_stack(1, dev)
    raw, solved = index_arrays(states, 0), index_arrays(big, 0)
    skewed = stack_arrays([raw] + [solved] * 15)
    opt.batched_optimize(skewed, ctx)
    final, res, skewed_s, _, graphs, _ = _batched_run(opt, skewed, ctx, dev)
    walked = []
    for lane in (raw, solved):
        _sync(dev)
        t0 = time.monotonic()
        opt._optimize_core(lane, ctx)
        _sync(dev)
        walked.append(time.monotonic() - t0)
    walked_s = walked[0] + 15 * walked[1]       # the 15 short lanes are one solve 15 times
    check(_same_placement(index_arrays(final, 0), index_arrays(big, 0)), "batched: the long lane differs")
    say("batched", step="one long lane and 15 that apply nothing", lanes=16, warm_wall_s=skewed_s,
        walked_lanes_wall_s=walked_s, long_lane_wall_s=walked[0], short_lane_wall_s=walked[1], round_trips=graphs["round_trips"],
        kernels_a_round=graphs["round_nodes"] / max(graphs["round_trips"], 1),
        rounds=[sum(g.rounds for g in r.goal_reports) for r in res.results[:2]])

    # the CPU port's batched solve of the 4-lane stack
    stdout, stderr = cpu_child.communicate(timeout=900)
    check(cpu_child.returncode == 0, f"batched: the CPU child exited {cpu_child.returncode}: {stderr.strip()[-800:]}")
    cpu = json.loads(stdout.strip().splitlines()[-1])
    same_cpu = [cpu["digests"][i] == _lane_digest(small, i) and cpu["rows"][i] == _report_rows(res4.results[i])
                for i in range(BATCHED_CPU_LANES)]
    say("batched", step="card vs CPU port", lanes=BATCHED_CPU_LANES, cpu_wall_s=cpu["wall_s"],
        cpu_num_host_syncs=cpu["num_host_syncs"], equal=same_cpu)
    check(all(same_cpu), f"batched: the card's lanes differ from the CPU port's ({same_cpu})")

    # P1's goals over the 4-lane stack: the assigner's passes on the lane grid
    p1 = GoalOptimizer(goal_ids=(22, 23), hard_ids=(22,), enable_heavy_goals=True, bucket_brokers=False, device=dev)
    states, ctx = _batched_stack(BATCHED_LANES[0], dev)
    p1.batched_optimize(states, ctx)
    final, res, warm_s, calls, graphs, _ = _batched_run(p1, states, ctx, dev)
    p1._optimize_core(index_arrays(states, 0), ctx)      # the one-lane shape captured
    single_s = 0.0
    for i in range(BATCHED_LANES[0]):
        t0 = time.monotonic()
        f1, r1 = p1._optimize_core(index_arrays(states, i), ctx)
        _sync(dev)
        single_s += time.monotonic() - t0
        check(_same_placement(index_arrays(final, i), f1), f"batched P1: lane {i} differs from its own solve")
        check(_report_rows(res.results[i]) == _report_rows(r1), f"batched P1: lane {i}'s goal rows differ")
    say("batched", step="P1 kafka assigner", lanes=BATCHED_LANES[0], warm_wall_s=warm_s,
        singles_warm_wall_s=single_s, num_host_syncs=res.num_host_syncs, host_calls=calls,
        graph_launches=graphs["graph_loop"], moves=[r.total_moves for r in res.results],
        goal22_violations_after=[r.violations_after["KafkaAssignerEvenRackAwareGoal"] for r in res.results])
    check(calls["even_assign"] == 3, f"batched P1: {calls['even_assign']} even_assign launches, want 3 (RF 3)")
    return out[BATCHED_LANES[0]], calls


def _plan_outcome(plan) -> dict:
    """A capacity plan without its wall and host-sync counts: the card counts
    one sync per copy of a state to the host, the CPU none, so the counts
    (and the message that quotes them) differ by device."""
    counts = ("num_host_syncs", "num_dispatches")   # the port's key and the JAX one, one count
    d = plan.to_dict()
    del d["durationS"], d["numHostSyncs"], d["numDispatches"]
    d["recommendation"]["message"] = d["recommendation"]["message"].split(" scenarios, ")[0]
    sweep = {k: v for k, v in plan.recommendation.sweep.items() if k not in counts}
    if "deep_verify" in sweep:
        sweep["deep_verify"] = {k: v for k, v in sweep["deep_verify"].items() if k not in counts}
    d["sweep"] = sweep
    return d


def phase_sim_card_vs_cpu(dev, small_final):
    """The what-if planner and the incremental solves at config2_small on the
    CPU port and on the card: a fast sweep of 8 scenarios, a deep sweep of 4
    (one in its own goal order: two groups), a capacity plan with the edge
    verified by the full solver, and single and batched incremental solves of
    the config2_small solve drifted.  Every verdict, plan and placement must
    be identical."""
    from cruise_control_tpu_torch import sim
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    base, _ = generate(SyntheticSpec(**CONFIG2_SMALL), device="cpu")
    scs = make_scenarios(8, brokers=base.num_brokers)
    deep_scs = scs[:3] + [sim.Scenario(name="order", kill_brokers=(2,),
                                       goal_order=(G.DISK_CAPACITY, G.RACK_AWARE, G.REPLICA_DISTRIBUTION))]
    lanes = _drift_lanes(small_final, (1.2, 1.5))
    out = {}
    for where in (torch.device("cpu"), dev):
        walls = {}
        t0 = time.monotonic()
        fast = sim.fast_sweep(base, scs, device=where)
        walls["fast_sweep"] = time.monotonic() - t0
        t0 = time.monotonic()
        deep = sim.deep_sweep(base, deep_scs, device=where)
        walls["deep_sweep"] = time.monotonic() - t0
        t0 = time.monotonic()
        plan = sim.plan_capacity(base, deep_verify=True, device=where)
        walls["plan_capacity"] = time.monotonic() - t0
        opt = GoalOptimizer(enable_heavy_goals=True, device=where)
        ctx = GoalContext.build(base.num_topics, sim.broker_bucket(base.num_brokers), device=where)
        t0 = time.monotonic()
        singles, bfinal, bres, _ = _incremental_lanes(opt, lanes, ctx, where)
        walls["incremental"] = time.monotonic() - t0
        out[where.type] = (fast, deep, plan, singles, bfinal, bres, walls)
    (fc, dc, pc, sc, bc, rc, wc), (fg, dg, pg, sg, bg, rg, wg) = out["cpu"], out[dev.type]
    plan_c, plan_g = _plan_outcome(pc), _plan_outcome(pg)
    say("sim_card_vs_cpu", config="config2_small", cpu_walls_s=wc, gpu_walls_s=wg,
        fast=_verdict_rows(fg), deep=_verdict_rows(dg), plan=plan_g,
        host_syncs=dict(cpu=pc.num_host_syncs, gpu=pg.num_host_syncs),
        incremental=[[r.goals_run, r.total_moves, r.total_rounds] for _, r in sg],
        batched_incremental=[[r.goals_run, r.total_moves, r.total_rounds] for r in rg.results])
    check([v.to_dict() for v in fg.scenarios] == [v.to_dict() for v in fc.scenarios], "fast_sweep: card differs")
    check([v.to_dict() for v in dg.scenarios] == [v.to_dict() for v in dc.scenarios], "deep_sweep: card differs")
    check(all(_same_placement(a, b) for a, b in zip(dg.states, dc.states)), "deep_sweep: card placement differs")
    check(plan_g == plan_c, f"plan_capacity: card differs: {plan_g} against {plan_c}")
    check(all(_same_placement(a[0], b[0]) for a, b in zip(sg, sc)), "incremental: card placement differs")
    check([(r.goals_run, r.total_moves, r.total_rounds) for _, r in sg]
          == [(r.goals_run, r.total_moves, r.total_rounds) for _, r in sc], "incremental: card result differs")
    check(_same_placement(bg, bc) and [r.total_rounds for r in rg.results] == [r.total_rounds for r in rc.results],
          "batched incremental: card differs")


def profile_child() -> None:
    """Phase 7's measurement in a process of its own (``python -c "import
    chip_smoke; chip_smoke.profile_child()"``): config #2 solved cold (its
    goal graphs captured) and warm, then once under ``torch.profiler`` with
    each goal graph's device time between CUDA events recorded around its
    launch; prints one JSON object.  A fresh process: in the smoke's own
    process the profiler had run before the graphs were instantiated, and a
    profiled replay of them then faulted (PERF.md §7)."""
    from cruise_control_tpu_torch.analyzer.device_loop import device_loops
    from cruise_control_tpu_torch.ops import graph_loop as GL
    from cruise_control_tpu_torch.ops import segments as SEG

    dev = torch.device("cuda")
    state, ctx, opt, _ = _solve(CONFIG2, dev)
    opt.optimize(state, ctx)
    opt.optimize(state, ctx)
    torch.cuda.synchronize()
    windows = []
    launch = GL.GoalGraph.launch

    def timed_launch(graph, stream):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        launch(graph, stream)
        end.record(stream)
        windows.append((start, end))

    SEG.reset_launch_counts()
    GL.reset_launch_counts()
    GL.GoalGraph.launch = timed_launch
    try:
        (_, res), wall_s, kernels = _profiled(lambda: opt.optimize(state, ctx))
    finally:
        GL.GoalGraph.launch = launch
    loops = device_loops(dev)
    print(json.dumps(dict(
        wall_s=wall_s, graph_s=sum(a.elapsed_time(b) for a, b in windows) / 1e3, windows=len(windows),
        kernels=[list(e) for e in kernels], segments=dict(SEG.LAUNCHES), graphs=dict(GL.LAUNCHES),
        rounds=sum(r.rounds for r in res.goal_reports), goals=len(res.goal_reports),
        num_host_syncs=res.num_host_syncs, total_moves=res.total_moves, capture_s=loops.capture_s,
    )), flush=True)


def phase_profile(dev):
    """Where a warm config #2 solve spends its time (:func:`profile_child`,
    in its own process).  The profiler does not see every kernel a graph's
    WHILE nodes run, so the device's busy time is known only between two
    bounds: above, the goal graphs' CUDA-event windows (which count the gaps
    between a graph's nodes as busy) plus the traced kernels launched outside
    them (those sharing no correlation id with a traced loop control kernel),
    printed as the graph-window occupancy; below, the summed device time of
    the kernels the profiler traced.  Neither is the summed kernel time of
    the host loop's profile (run L's idle share), so no idle share is printed
    beside it.  The kernels a round are the captured rounds' work nodes times
    their trip counts (derived), the control kernels (counted on the device)
    and the traced kernels outside the graphs, over the rounds.
    Then this process's device loop: rounds captured, goal graphs, capture
    wall and its pool's bytes.  The profiler slows the host side, so its
    wall is longer than phase 4's warm wall."""
    from cruise_control_tpu_torch.analyzer.device_loop import device_loops

    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.profile_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0, f"profile: the child exited {proc.returncode}: {proc.stderr.strip()[-800:]}")
    m = json.loads(proc.stdout.strip().splitlines()[-1])
    kernels = [DeviceEvent(*e) for e in m["kernels"]]
    graphs = m["graphs"]
    in_graphs = {e.correlation for e in kernels if "loop_ctl" in e.name}
    outside = [e for e in kernels if e.correlation not in in_graphs]
    busy_upper_s = m["graph_s"] + sum(e.device_time_total for e in outside) / 1e6
    busy_traced_s = sum(e.device_time_total for e in kernels) / 1e6
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    ran = graphs["round_nodes"] + graphs["loop_ctl"] + len(outside)
    # the kernels each segment-sum path enqueued in this solve, as far as the profiler saw
    # them (the integer path's memsets are not told apart from other memsets)
    seg_kernels = {
        path: sum(n for name, (n, _) in by_name.items() if any(k in name for k in names))
        for path, names in SEGMENT_KERNELS.items()
    }
    ctl = [(n, t) for name, (n, t) in by_name.items() if "loop_ctl" in name]
    ctl_n, ctl_us = sum(n for n, _ in ctl), sum(t for _, t in ctl)
    loops = device_loops(dev)
    say(
        "profile", profiled_wall_s=m["wall_s"], graph_window_occupancy=busy_upper_s / m["wall_s"],
        device_busy_upper_s=busy_upper_s, device_busy_traced_s=busy_traced_s,
        device_idle_share_bounds=[1.0 - busy_upper_s / m["wall_s"], 1.0 - busy_traced_s / m["wall_s"]],
        goal_graphs_device_s=m["graph_s"], traced_kernels=len(kernels), traced_outside_graphs=len(outside),
        correlation_ids_in_graphs=len(in_graphs), rounds=m["rounds"], kernels_ran=ran,
        launches_per_round=ran / max(m["rounds"], 1), round_work_nodes_derived=graphs["round_nodes"],
        graph_launches=graphs["graph_loop"], loop_ctl_kernels=graphs["loop_ctl"],
        loop_ctl_by_layout=graphs["loop_ctl_by_layout"], loop_ctl_traced=ctl_n,
        loop_ctl_device_ms=ctl_us / 1e3 / ctl_n if ctl_n else None, num_host_syncs=m["num_host_syncs"],
        segment_sum_host_calls=m["segments"], segment_sum_kernel_launches=seg_kernels,
        child_capture_wall_s=m["capture_s"], captured_rounds=loops.captures, goal_graphs=loops.goal_graphs,
        capture_wall_s=loops.capture_s, pool_bytes=loops.pool_bytes(), shapes_held=loops.shapes(),
        shapes_evicted=loops.evictions,
        top_kernels=[[name[:80], n, t / 1e3] for name, (n, t) in top],
    )
    check(m["total_moves"] == CONFIG2_TOTALS["total_moves"], f"profile: {m['total_moves']} moves")
    check(graphs["graph_loop"] == m["goals"] + 1 == m["windows"],
          f"profile: {graphs['graph_loop']} goal graphs for {m['goals']} goals and the pre-phases")
    return m["segments"], seg_kernels, dict(launches=ctl_n, ms=ctl_us / 1e3 / ctl_n if ctl_n else None)


def phase_card_vs_cpu(dev):
    """The same solve on the CPU port and on the card: identical placements,
    leaders and logdirs, no hard goal violated on either.  Returns the CPU
    port's config2_small solve."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer import goals_base as G

    small_jbod = dict(CONFIG2_SMALL, **JBOD)
    # (name, spec, goal ids, hard ids, case options, round cap per phase).  P4's
    # topic-leader goal cycles leadership until the cap (as the JAX reference
    # does), so its depth is cut to 200 rounds a phase on both sides.
    cases = (
        ("config1", CONFIG1, DEFAULT_GOALS, G.HARD_GOALS, {}, 2000),
        ("config2_small", CONFIG2_SMALL, DEFAULT_GOALS, G.HARD_GOALS, {}, 2000),
        ("P1 config2_small", CONFIG2_SMALL, (22, 23), (22,), {}, 2000),
        ("P2 config2_small JBOD", small_jbod, NORTH_STAR, G.HARD_GOALS, {}, 2000),
        ("P3 config2_small JBOD", dict(small_jbod, **REMOVE_DISKS_LOAD), (16,), (16,),
         dict(removed=tuple(range(4))), 2000),
        ("P4 config2_small", CONFIG2_SMALL, (19, 21, 20, 18), (), dict(broker_sets=True), 200),
    )
    for name, spec, goal_ids, hard_ids, kw, max_rounds in cases:
        out = {}
        for where in ("cpu", dev):
            state, ctx, _ = _case(spec, where, **kw)
            opt = GoalOptimizer(goal_ids=goal_ids, hard_ids=hard_ids, enable_heavy_goals=True,
                                max_rounds_per_phase=max_rounds, device=where)
            t0 = time.monotonic()
            final, res = opt.optimize(state, ctx)
            out[str(where)] = (final, res, time.monotonic() - t0)
        (fc, rc, tc), (fg, rg, tg) = out["cpu"], out[str(dev)]
        differ = int((fc.replica_broker != fg.replica_broker.cpu()).sum().item())
        leaders = int((fc.partition_leader != fg.partition_leader.cpu()).sum().item())
        disks = int((fc.replica_disk != fg.replica_disk.cpu()).sum().item())
        say(
            "card_vs_cpu", config=name, goal_ids=list(goal_ids), cpu_wall_s=tc, gpu_wall_s=tg,
            replicas_placed_differently=differ, leaders_differ=leaders, disks_differ=disks,
            cpu_moves=rc.total_moves, gpu_moves=rg.total_moves,
            cpu_balancedness=rc.balancedness_score, gpu_balancedness=rg.balancedness_score,
            gpu_violated_hard=rg.violated_hard_goals, goals=_goal_rows(rg),
        )
        check(_valid_placement(fg), f"{name}: invalid placement on the card")
        check(not rg.violated_hard_goals and not rc.violated_hard_goals,
              f"{name}: hard goals violated (cpu {rc.violated_hard_goals}, gpu {rg.violated_hard_goals})")
        check(abs(rg.balancedness_score - rc.balancedness_score) <= 1.0, f"{name}: balancedness differs")
        check(differ == 0 and leaders == 0 and disks == 0,
              f"{name}: card placement differs from the CPU port")
        if name == "config2_small":
            small_final = fc
    return small_final


# -- traces, the continuous controller and the fleet ---------------------------------

#: the JAX traces harness (traces/bench.py:46-60): 4 traces x 4 policies, 64 steps
TRACE_STEPS = 64
#: the policies' ceiling and the rollout's broker bucket on the sim cluster
TRACE_BUCKET = 128
#: the controller's and the fleet's tick: drift-triggered, 64 rounds a phase at most
TICK_CFG = dict(tick_interval_s=3_600.0, drift_threshold=1.0, max_rounds_per_tick=SIM_MAX_ROUNDS)
#: S4's shift of topics 0-9, one factor per fleet tenant (the controller takes the third)
SHIFT_FACTORS = (1.1, 1.2, 1.3, 1.4)


def trace_workload(steps: int = TRACE_STEPS, max_brokers: int = TRACE_BUCKET):
    """The JAX traces harness's traces and policies (``traces/bench.py:46-60``),
    the policies' ceiling at ``max_brokers``."""
    from cruise_control_tpu_torch.traces import AutoscalePolicy, diurnal_trace, ramp_trace, spike_trace

    traces = [
        diurnal_trace(name="diurnal", num_steps=steps, amplitude=0.4),
        ramp_trace(name="ramp", num_steps=steps, rate=0.02),
        spike_trace(name="spike", num_steps=steps, at=16, magnitude=1.5),
        diurnal_trace(name="noisy", num_steps=steps, amplitude=0.3, sigma=0.05, seed=9),
    ]
    policies = [
        AutoscalePolicy(name=f"p{i}", scale_out_threshold=0.6 + 0.08 * i, scale_in_threshold=0.3,
                        cooldown_ticks=i, step_brokers=1 + i % 2, max_brokers=max_brokers)
        for i in range(4)
    ]
    return traces, policies


def _rollout_rows(res):
    return [[v.trace, v.policy, v.violation_steps, v.broker_hours, v.scale_ups, v.scale_downs,
             v.peak_brokers, v.final_brokers, v.min_balancedness] for v in res.verdicts]


def _same_rollout(a, b) -> bool:
    """Every verdict and every per-step series identical (floats bitwise)."""
    return ([v.to_dict() for v in a.verdicts] == [v.to_dict() for v in b.verdicts]
            and a.series.keys() == b.series.keys()
            and all(a.series[k].dtype == b.series[k].dtype and np.array_equal(a.series[k], b.series[k])
                    for k in a.series))


#: the 16 x 64 rollout before its time loop was one device program (each step
#: eager, each lane evaluated alone): its wall and the kernels the profiler
#: traced on an NVIDIA H100 80GB HBM3 at 700.00 W
TRACE_BEFORE = dict(wall_s=6.754, kernel_launches=331_799)
#: what the counted loop's control kernel reads and writes a step: the step
#: index and its own count, each once
COUNT_CTL_BYTES = 16


def traces_profile_child() -> None:
    """Phase 9's profile in a process of its own (``python -c "import
    chip_smoke; chip_smoke.traces_profile_child()"``): the rollout cold (its
    step captured) and warm, then warm once under ``torch.profiler`` with
    CUDA events around the counted loop's launch; prints one JSON object.
    A fresh process, as :func:`profile_child`: a profiled replay of graphs
    built after an earlier profiler session faults."""
    from cruise_control_tpu_torch.ops import graph_loop as GL
    from cruise_control_tpu_torch.ops import segments as SEG
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate
    from cruise_control_tpu_torch.traces import rollout

    dev = torch.device("cuda")
    base, _ = generate(SyntheticSpec(**SIM), device="cpu")
    traces, policies = trace_workload()
    for _ in range(2):
        rollout(base, traces, policies, bucket_brokers=TRACE_BUCKET, device=dev)
    torch.cuda.synchronize()
    windows = []
    launch = GL.CountedLoop.launch

    def timed_launch(loop, stream):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        launch(loop, stream)
        end.record(stream)
        windows.append((start, end))

    SEG.reset_launch_counts()
    GL.reset_launch_counts()
    GL.CountedLoop.launch = timed_launch
    try:
        res, wall_s, kernels = _profiled(lambda: rollout(base, traces, policies, bucket_brokers=TRACE_BUCKET,
                                                         device=dev))
    finally:
        GL.CountedLoop.launch = launch
    print(json.dumps(dict(
        wall_s=wall_s, graph_s=sum(a.elapsed_time(b) for a, b in windows) / 1e3, windows=len(windows),
        kernels=[list(e) for e in kernels], segments=dict(SEG.LAUNCHES), graphs=dict(GL.LAUNCHES),
        num_host_syncs=res.num_host_syncs, steps=res.num_steps,
    )), flush=True)


def phase_traces(dev):
    """Trace rollouts on the card at the sim cluster's full width: the JAX
    traces harness's 4 traces x 4 policies (16 pairs, 64 steps: 1,024 lane
    evaluations, bucket 128), cold (the step captured) and warm, each step
    one lane-form evaluation of the 16 pairs and the 64 steps one counted
    loop's graph launch; the kernels' host calls and the calls replayed in
    the graph (derived: the captured step's calls times the steps), per
    rollout and per step; then the same rollout on the CPU port (equal
    bitwise) and through the plain version of the counted loop, the host
    loop on the card (equal bitwise, its wall), the plain control (one
    eager step-index add) timed; the warm rollout profiled in a child
    process (:func:`traces_profile_child`): the kernels it ran beside the
    331,799 of the eager rollout, and the device's busy time between the
    graph window (above) and the traced kernels (below); then
    ``horizon_requirements`` on
    the spike trace.  Fails unless a warm rollout is one launch of its time
    loop with one host sync and no segment-sum host call, the control
    kernels counted on the device are the loop's layout (one a step and one
    to start), both kernel paths ran in it and every rollout agrees.
    Returns the warm rollout's calls (host and replayed) and the counted
    loop's record for the ``kernels`` line."""
    from cruise_control_tpu_torch.ops import graph_loop as GL
    from cruise_control_tpu_torch.ops import segments as SEG
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate
    from cruise_control_tpu_torch.traces import horizon_requirements, rollout

    # the package exports a function named ``rollout`` over the module's name
    R = importlib.import_module("cruise_control_tpu_torch.traces.rollout")

    base, _ = generate(SyntheticSpec(**SIM), device="cpu")
    traces, policies = trace_workload()

    def run(where=dev):
        return rollout(base, traces, policies, bucket_brokers=TRACE_BUCKET, device=where)

    _reset_counts()
    GL.reset_launch_counts()
    t0 = time.monotonic()
    cold = run()
    _sync(dev)
    cold_s = time.monotonic() - t0
    cold_calls = _counts()
    _reset_counts()
    GL.reset_launch_counts()
    t0 = time.monotonic()
    warm = run()
    _sync(dev)
    warm_s = time.monotonic() - t0
    calls, replayed, loop = _counts(), dict(SEG.REPLAYED), dict(GL.LAUNCHES)
    host_calls = {p: calls[p] - replayed[p] for p in ("segment_sum_f32", "segment_sum_i32")}
    N, T = warm.num_pairs, warm.num_steps
    # the CPU port, and the plain version of the counted loop: the host loop on the card
    t0 = time.monotonic()
    cpu = run(torch.device("cpu"))
    cpu_s = time.monotonic() - t0
    time_loop = R._time_loop
    R._time_loop = lambda inputs, outputs, step, T_, dev_, key, syncs: R._host_loop(inputs, outputs, step, T_, dev_)
    try:
        run()
        _sync(dev)
        t0 = time.monotonic()
        host_loop = run()
        _sync(dev)
        host_loop_s = time.monotonic() - t0
    finally:
        R._time_loop = time_loop
    step = torch.zeros(2, dtype=torch.int32, device=dev)
    plain_ms = call_ms(lambda: step[GL.STEP].add_(1))
    # the warm rollout profiled in a fresh process
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.traces_profile_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0, f"traces: the profile child exited {proc.returncode}: {proc.stderr.strip()[-800:]}")
    m = json.loads(proc.stdout.strip().splitlines()[-1])
    kernels = [DeviceEvent(*e) for e in m["kernels"]]
    in_graph = {e.correlation for e in kernels if "count_ctl" in e.name}
    outside = [e for e in kernels if e.correlation not in in_graph]
    busy_upper_s = m["graph_s"] + sum(e.device_time_total for e in outside) / 1e6
    busy_traced_s = sum(e.device_time_total for e in kernels) / 1e6
    ctl = [e.device_time_total for e in kernels if "count_ctl" in e.name]
    ran = m["graphs"]["step_nodes"] + m["graphs"]["count_ctl"] + len(outside)
    t0 = time.monotonic()
    horizon = horizon_requirements(base, traces[2], device=dev)
    _sync(dev)
    horizon_s = time.monotonic() - t0
    say("traces", pairs=N, steps=T, lane_evaluations=N * T, bucket=list(warm.bucket),
        cold_wall_s=cold_s, warm_wall_s=warm_s, warm_wall_before_s=TRACE_BEFORE["wall_s"],
        ms_per_step=warm_s / T * 1e3, num_host_syncs=warm.num_host_syncs, count_loop_launches=loop["count_loop"],
        count_ctl_kernels=loop["count_ctl"], count_ctl_by_layout=loop["count_ctl_by_layout"],
        step_work_nodes_derived=loop["step_nodes"], cold_calls=cold_calls, host_calls=host_calls,
        replayed_calls_derived=replayed, calls_per_step={p: calls[p] / T for p in host_calls},
        cpu_port_wall_s=cpu_s, host_loop_wall_s=host_loop_s, plain_control_ms=plain_ms,
        profiled_wall_s=m["wall_s"], kernels_ran=ran, kernels_ran_before=TRACE_BEFORE["kernel_launches"],
        traced_kernels=len(kernels), traced_outside_graph=len(outside), graph_device_s=m["graph_s"],
        graph_window_occupancy=busy_upper_s / m["wall_s"], device_busy_upper_s=busy_upper_s,
        device_busy_traced_s=busy_traced_s,
        device_idle_share_bounds=[1.0 - busy_upper_s / m["wall_s"], 1.0 - busy_traced_s / m["wall_s"]],
        count_ctl_traced=len(ctl), count_ctl_device_ms=sum(ctl) / 1e3 / len(ctl) if ctl else None,
        violation_free_pairs=sum(v.violation_free for v in warm.verdicts), winners=warm.winners(),
        verdicts=_rollout_rows(warm),
        horizon=dict(horizon, wall_s=horizon_s))
    check(warm.num_host_syncs == 1 and cold.num_host_syncs == 1 and m["num_host_syncs"] == 1,
          f"traces: {warm.num_host_syncs} host syncs in a warm rollout, want 1")
    check(loop["count_loop"] == 1 and m["windows"] == 1,
          f"traces: {loop['count_loop']} launches of the time loop in a warm rollout, want 1")
    check(loop["count_ctl"] == loop["count_ctl_by_layout"] == T + 1,
          f"traces: {loop['count_ctl']} control kernels on the device, {loop['count_ctl_by_layout']} by the layout")
    check(all(n == 0 for n in host_calls.values()), f"traces: segment-sum host calls in a warm rollout: {host_calls}")
    for path in ("segment_sum_f32", "segment_sum_i32"):
        check(replayed[path] >= T, f"traces: kernel path {path} ran {replayed[path]} times in {T} steps")
    check(_same_rollout(cold, warm), "traces: rollouts of the same inputs differ")
    check(_same_rollout(warm, cpu), "traces: the card's rollout differs from the CPU port's")
    check(_same_rollout(warm, host_loop), "traces: the counted loop differs from the host loop on the card")
    check(all(np.isfinite(warm.series["viol"]).ravel()), "traces: non-finite violation counts")
    check(horizon["horizonSteps"] == TRACE_STEPS and horizon["numHostSyncs"] == 1,
          f"horizon: {horizon}")
    return calls, dict(launches=loop["count_ctl"], host_calls=loop["count_loop"], max_abs_err=0.0,
                       ms=sum(ctl) / 1e3 / len(ctl) if ctl else None, plain_ms=plain_ms,
                       rollout_s=warm_s, host_loop_rollout_s=host_loop_s)


class SmokeFacade:
    """The smoke's stand-in for the service facade a ``ContinuousController``
    reads: the goal lists, a monitor whose current partition loads the smoke
    sets, and ``cluster_model()`` built from a solved placement with those
    loads (the leader's measured load is the partition's, a follower's the
    follower-equivalent, as the load monitor builds it)."""

    def __init__(self, state, maps, loads, goal_ids=DEFAULT_GOALS) -> None:
        import types

        from cruise_control_tpu_torch.analyzer import goals_base as G
        from cruise_control_tpu_torch.model.model_utils import DEFAULT_CPU_WEIGHTS

        self.goal_ids = tuple(goal_ids)
        self.hard_ids = tuple(g for g in G.HARD_GOALS if g in self.goal_ids)
        self.enable_heavy_goals = True
        self.constraint = None
        self.loads = dict(loads)
        self.maps = maps
        self.placement = {k: getattr(state, k).cpu().numpy() for k in (
            "replica_partition", "replica_broker", "replica_valid", "partition_leader",
            "broker_rack", "broker_host", "broker_capacity")}
        self.listeners = []
        self.monitor = types.SimpleNamespace(
            current_partition_loads=lambda: dict(self.loads),
            cpu_weights=DEFAULT_CPU_WEIGHTS,
            add_window_listener=self.listeners.append,
        )
        self.backend = types.SimpleNamespace(describe_cluster=lambda: types.SimpleNamespace(
            brokers={b: None for b in maps.broker_ids}))
        self.executor = None

    def cluster_model(self):
        from cruise_control_tpu_torch.core.resources import Resource
        from cruise_control_tpu_torch.model.cluster import ClusterModel
        from cruise_control_tpu_torch.model.model_utils import DEFAULT_CPU_WEIGHTS, follower_cpu_from_leader_load

        s, m = self.placement, self.maps
        model = ClusterModel()
        for b, bid in enumerate(m.broker_ids):
            model.create_broker(m.rack_names[s["broker_rack"][b]], bid,
                                {r: float(s["broker_capacity"][b, int(r)]) for r in Resource},
                                host=m.host_names[s["broker_host"][b]])
        index = {}
        for r in np.flatnonzero(s["replica_valid"]):
            p = int(s["replica_partition"][r])
            tp, bid = m.partitions[p], m.broker_ids[s["replica_broker"][r]]
            i = index.get(p, 0)
            index[p] = i + 1
            leader = int(s["partition_leader"][p]) == r
            model.create_replica(bid, tp, i, leader)
            cpu, nw_in, nw_out, disk = self.loads[tp]
            fcpu = float(follower_cpu_from_leader_load(nw_in, nw_out, cpu, DEFAULT_CPU_WEIGHTS))
            model.set_replica_load(bid, tp, (cpu, nw_in, nw_out, disk) if leader else (fcpu, nw_in, 0.0, disk))
        return model

    def deliver(self, window: int) -> None:
        """One window delta to every listener, stamped now."""
        from cruise_control_tpu_torch.monitor.loadmonitor import WindowDelta

        delta = WindowDelta(window_id=window, ts_ms=window * 60_000, num_samples=len(self.loads),
                            new_window=True, ingest_monotonic=time.monotonic())
        for fn in self.listeners:
            fn(delta)


def partition_loads(state, maps):
    """Each partition's leader load (base plus leadership delta), by name."""
    base = state.base_load.cpu().double().numpy()
    delta = state.leadership_delta.cpu().double().numpy()
    leader = state.partition_leader.cpu().numpy()
    return {tp: tuple(float(x) for x in base[leader[p]] + delta[p]) for p, tp in enumerate(maps.partitions)}


def shifted(loads, maps, factor):
    """S4's shift: every load of topics 0-9 times ``factor``."""
    hot = set(maps.topic_names[:10])
    return {tp: tuple(x * factor for x in v) if tp[0] in hot else v for tp, v in loads.items()}


def _set_key(standing):
    """A standing set without its wall-clock fields (``created_ms``,
    ``reaction_s``): what two runs of the same tick must agree on."""
    from cruise_control_tpu_torch.executor.journal import proposal_to_record

    if standing is None:
        return None
    return (standing.version, standing.trigger, standing.drift, standing.epoch,
            [proposal_to_record(p) for p in standing.proposals])


def _controller(facade, dev, journal=None, tenant_cfg=None):
    from cruise_control_tpu_torch.controller import ContinuousController, ControllerConfig

    c = ContinuousController(facade, journal=journal, config=ControllerConfig(**(tenant_cfg or TICK_CFG)),
                             device=dev)
    facade.monitor.add_window_listener(c.on_window_delta)
    return c


def _standalone_tick(state, maps, loads, factor, dev):
    """One tenant's own controller: warm start, the shift, one tick."""
    facade = SmokeFacade(state, maps, loads)
    c = _controller(facade, dev)
    c.warm_start()
    facade.loads = shifted(loads, maps, factor)
    facade.deliver(1)
    return c.maybe_tick(), c


def tick_dispatch_slo():
    """The shipped ``warm-tick-dispatches`` SLO over the last controller tick
    in the flight recorder (one self-monitoring sample, one evaluation):
    its value (the tick's host syncs), objective (``slo.dispatch.budget``),
    whether the value is good and whether an alert fires."""
    from cruise_control_tpu_torch.core.config import Config, load_properties
    from cruise_control_tpu_torch.core.config_defs import cruise_control_config
    from cruise_control_tpu_torch.obs.selfmon import SelfMonitor
    from cruise_control_tpu_torch.obs.slo import SloEngine, build_pairs, shipped_specs

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "cruisecontrol.properties")
    cfg = Config(cruise_control_config(), load_properties(path))
    mon = SelfMonitor()
    mon.sample()
    engine = SloEngine(shipped_specs(cfg.get), mon, pairs=build_pairs(cfg.get))
    st = next(st for st in engine.evaluate() if st["slo"] == "warm-tick-dispatches")
    return dict(value=st["value"], objective=st["objective"], ok=st["ok"],
                firing=any(a["firing"] for a in st["alerts"]))


def check_tick_budget(c, label):
    """ROADMAP C5's pin: the controller's last tick made at most
    ``slo.dispatch.budget`` host syncs (its spans' sum, the final state's
    copy to the host included), the SLO over the tick's record is good and
    quiet, and the tick captured or built nothing.  Returns ``(syncs, slo,
    compile events)``."""
    from cruise_control_tpu_torch.obs import RECORDER

    syncs = sum(s.dispatches for s in c.last_spans)
    slo = tick_dispatch_slo()
    tick = RECORDER.recent(1, kind="controller_tick")
    events = len(tick[0].compile_events) if tick else None
    check(syncs <= slo["objective"] and slo["ok"] and not slo["firing"],
          f"{label}: {syncs} host syncs in the warm tick against slo.dispatch.budget: {slo}")
    check(events == 0, f"{label}: the warm tick captured or built {events} program(s)")
    return syncs, slo, events


def phase_controller(dev, config2_final, maps):
    """A ``ContinuousController`` at config #2 width on the card: warm start
    from config #2's solved placement (a port ``ClusterModel`` built from it,
    the smoke's facade serving the loads), S4's shift (topics 0-9 x 1.3) as
    one window delta, one drift-triggered tick; the set journaled in a
    temporary directory and recovered by a fresh controller, which must give
    the published set back.  The tick must stay within
    ``slo.dispatch.budget`` host syncs with ``warm-tick-dispatches`` quiet
    and capture nothing (:func:`check_tick_budget`, ROADMAP C5).  Returns
    the tick's host calls."""
    import tempfile

    from cruise_control_tpu_torch.controller import ControllerJournal
    from cruise_control_tpu_torch.core.journal import Journal

    loads = partition_loads(config2_final, maps)
    with tempfile.TemporaryDirectory() as jdir:
        facade = SmokeFacade(config2_final, maps, loads)
        c = _controller(facade, dev, journal=ControllerJournal(Journal(jdir)))
        t0 = time.monotonic()
        c.warm_start()
        _sync(dev)
        warm_start_s = time.monotonic() - t0
        facade.loads = shifted(loads, maps, SHIFT_FACTORS[2])
        _reset_counts()
        facade.deliver(1)
        t0 = time.monotonic()
        published = c.maybe_tick()
        _sync(dev)
        tick_s = time.monotonic() - t0
        calls = _counts()
        syncs, slo, events = check_tick_budget(c, "controller")
        drift = c._last_drift
        spans = {s.name: s for s in c.last_spans}
        c2 = _controller(SmokeFacade(config2_final, maps, loads), dev,
                         journal=ControllerJournal(Journal(jdir)))
        records = c2.recover()
        attrs = c._last_tick_attrs or {}
        say("controller", config="config2", shift=SHIFT_FACTORS[2], warm_start_s=warm_start_s,
            tick_wall_s=tick_s, reaction_s=published and published.reaction_s,
            trigger=published and published.trigger, drift_score=drift.score,
            drifted_goals=drift.violated_goals, balancedness=drift.balancedness,
            goals_run=attrs.get("goals_run"), moves=attrs.get("moves"),
            rounds=spans["optimize"].attrs["rounds"] if "optimize" in spans else None,
            num_host_syncs=syncs, dispatch_slo=slo, tick_compile_events=events,
            span_s={k: s.duration_s for k, s in spans.items()},
            proposals=len(published.proposals) if published else 0, host_calls=calls,
            journal_records=records, recovered_version=c2.standing and c2.standing.version)
        check(published is not None and published.trigger == "drift", "controller: the shift published nothing")
        check(c2.standing == published, "controller: the recovered set differs from the published one")
        for path in ("segment_sum_f32", "segment_sum_i32"):
            check(calls[path] > 0, f"controller: kernel path {path} never launched in the tick")
    return calls


def _fleet_tick(state, maps, loads, factors, dev):
    """A fleet of one tenant per shift factor (the same cluster), warmed,
    shifted, one tick: ``(fleet, attrs, wall s, the tick's compile events)``."""
    from cruise_control_tpu_torch.fleet import FleetConfig, FleetController
    from cruise_control_tpu_torch.obs.recorder import compile_events_since, compile_mark

    fleet = FleetController(config=FleetConfig(**TICK_CFG), device=dev)
    facades = []
    for i, f in enumerate(factors):
        facade = SmokeFacade(state, maps, loads)
        fleet.add_tenant(f"t{i}", facade)
        facades.append(facade)
    fleet.warm()
    for f, facade in zip(factors, facades):
        facade.loads = shifted(loads, maps, f)
        facade.deliver(1)
    mark = compile_mark()
    t0 = time.monotonic()
    attrs = fleet.maybe_tick()
    _sync(dev)
    return fleet, attrs, time.monotonic() - t0, compile_events_since(mark)


def phase_fleet(dev, config2_final, maps):
    """Four tenants of config #2's solved cluster with S4's four shifts, one
    fleet tick on the card; each tenant's standing set must equal its own
    standalone controller's tick.  The drift probe's lanes and kernel host
    calls are printed (one lane-form evaluation of the four tenants)."""
    from cruise_control_tpu_torch.analyzer import optimizer as O
    from cruise_control_tpu_torch.model import arrays as A

    loads = partition_loads(config2_final, maps)
    probe = {}
    batched_violations = O.GoalOptimizer.batched_violations

    def counted_probe(opt, states, ctx):
        """The drift probe: one lane-form evaluation of the group's stack."""
        before = _counts()
        out = batched_violations(opt, states, ctx)
        after = _counts()
        probe.update(lanes=A.num_lanes(states), host_calls={p: after[p] - before[p] for p in after})
        return out

    _reset_counts()
    O.GoalOptimizer.batched_violations = counted_probe
    try:
        fleet, attrs, wall, tick_events = _fleet_tick(config2_final, maps, loads, SHIFT_FACTORS, dev)
    finally:
        O.GoalOptimizer.batched_violations = batched_violations
    calls = _counts()
    t0 = time.monotonic()
    solos = [_standalone_tick(config2_final, maps, loads, f, dev)[0] for f in SHIFT_FACTORS]
    _sync(dev)
    solo_s = time.monotonic() - t0
    sets = [fleet.tenant(f"t{i}").controller.standing for i in range(len(SHIFT_FACTORS))]
    say("fleet", config="config2", tenants=len(SHIFT_FACTORS), shifts=list(SHIFT_FACTORS), tick_wall_s=wall,
        standalone_ticks_wall_s=solo_s, groups=attrs and attrs["groups"],
        published=attrs and attrs["published"], num_host_syncs=attrs and attrs["num_host_syncs"],
        span_s={s.name: s.duration_s for s in fleet.last_spans if s.name != "publish"},
        goals_run=[s.attrs.get("goals_run") for s in fleet.last_spans if s.name == "optimize"],
        proposals=[len(s.proposals) if s else 0 for s in sets], host_calls=calls, probe=probe,
        tick_compile_events=[e.get("event") for e in tick_events])
    check(attrs is not None and attrs["published"] == len(SHIFT_FACTORS), f"fleet: {attrs}")
    # the warm start captured the group's batched walk at its stack's shape
    check(not tick_events, f"fleet: the warm tick made compile events {tick_events}")
    check(probe.get("lanes") == len(SHIFT_FACTORS), f"fleet: the drift probe evaluated {probe}")
    for i, (s, solo) in enumerate(zip(sets, solos)):
        check(s is not None and _set_key(s) == _set_key(solo),
              f"fleet: tenant t{i}'s set differs from its standalone tick")


def phase_traces_controller_card_vs_cpu(dev, small_final):
    """The rollout, one controller tick and one fleet tick on the CPU port
    and on the card: the JAX traces harness's rollout (10 brokers, 16 pairs,
    64 steps, bucket 16), a rollout at config2_small (the 4 traces x 2
    policies, 16 steps), and a tick and a 3-tenant fleet tick of the
    config2_small solve shifted.  Every series, verdict and set identical."""
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate
    from cruise_control_tpu_torch.traces import rollout

    harness, _ = generate(SyntheticSpec(num_racks=5, num_brokers=10, num_topics=5, num_partitions=50,
                                        replication_factor=2, seed=2, mean_cpu=0.08, mean_disk=0.08,
                                        mean_nw_in=0.08, mean_nw_out=0.06), device="cpu")
    small, maps = generate(SyntheticSpec(**CONFIG2_SMALL), device="cpu")
    loads = partition_loads(small_final, maps)
    out, walls = {}, {}
    for where in (torch.device("cpu"), dev):
        w = {}
        t0 = time.monotonic()
        h = rollout(harness, *trace_workload(max_brokers=16), bucket_brokers=16, device=where)
        w["harness_rollout"] = time.monotonic() - t0
        traces, policies = trace_workload(steps=16, max_brokers=64)
        t0 = time.monotonic()
        r = rollout(small, traces, policies[:2], bucket_brokers=64, device=where)
        w["config2_small_rollout"] = time.monotonic() - t0
        t0 = time.monotonic()
        tick, _ = _standalone_tick(small_final, maps, loads, 1.3, where)
        w["tick"] = time.monotonic() - t0
        fleet, attrs, w["fleet_tick"], _ = _fleet_tick(small_final, maps, loads, SHIFT_FACTORS[:3], where)
        sets = [fleet.tenant(f"t{i}").controller.standing for i in range(3)]
        out[where.type] = (h, r, tick, sets, attrs)
        walls[where.type] = w
    (hc, rc, tc, sc, ac), (hg, rg, tg, sg, ag) = out["cpu"], out[dev.type]
    say("traces_controller_card_vs_cpu", cpu_walls_s=walls["cpu"], gpu_walls_s=walls[dev.type],
        harness_winners=hg.winners(), config2_small_winners=rg.winners(),
        tick_proposals=len(tg.proposals) if tg else 0,
        fleet_proposals=[len(s.proposals) if s else 0 for s in sg], fleet_groups=ag and ag["groups"])
    check(_same_rollout(hg, hc), "harness rollout: card differs from the CPU port")
    check(_same_rollout(rg, rc), "config2_small rollout: card differs from the CPU port")
    check(tc is not None and _set_key(tg) == _set_key(tc), "controller tick: card differs from the CPU port")
    check(all(s is not None for s in sg) and [_set_key(s) for s in sg] == [_set_key(s) for s in sc],
          "fleet tick: card differs from the CPU port")
    check(ag["published"] == ac["published"] == 3, f"fleet tick: {ag} against {ac}")


#: the facade phases' metric windows: window-aligned, one metric interval a
#: window, two valid windows after the newest (current) one
FACADE_WINDOW_MS = 60_000
FACADE_WINDOWS = 2
#: the executor's wait between progress checks (the fake backend finishes a
#: reassignment at its next poll)
FACADE_CHECK_INTERVAL_S = 0.001


def seed_fake_backend(backend, state, maps, num_racks):
    """Load a ``FakeClusterBackend`` (of either package) with a synthetic
    cluster's topology and leader loads: broker ``b`` on rack ``b % num_racks``,
    each partition's replicas in placement order (the leader first) and its
    leader-replica load ``[CPU, NW_IN, NW_OUT, DISK]``, the leader row's base
    load plus the partition's leadership delta."""
    rb = state.replica_broker.cpu().numpy()
    rp = state.replica_partition.cpu().numpy()
    for b in range(state.num_brokers):
        backend.add_broker(b, rack=str(b % num_racks))
    replicas = [[] for _ in range(state.num_partitions)]
    for p, b in zip(rp.tolist(), rb.tolist()):
        replicas[p].append(b)
    loads = seeded_loads(state, maps)
    for p, tp in enumerate(maps.partitions):
        backend.create_partition(tp, replicas[p], load=loads[tp])
    return backend


def seeded_loads(state, maps) -> dict:
    """tp -> the leader-replica load ``seed_fake_backend`` gives a partition."""
    leader = state.partition_leader.cpu().numpy()
    load = state.base_load.cpu().numpy()[leader] + state.leadership_delta.cpu().numpy()
    return {tp: load[p].tolist() for p, tp in enumerate(maps.partitions)}


def _facade_stack(spec, device, goal_ids, make_sampler, num_windows=FACADE_WINDOWS, window_ms=FACADE_WINDOW_MS):
    """A ``FakeClusterBackend`` seeded with a synthetic spec, a ``LoadMonitor``
    over ``make_sampler(backend)``, an ``Executor`` that pauses sampling while
    replicas move, and a started ``CruiseControl`` on ``device``:
    ``(facade, the synthetic state, its maps)``."""
    from cruise_control_tpu_torch.backend import FakeClusterBackend
    from cruise_control_tpu_torch.core.resources import Resource
    from cruise_control_tpu_torch.executor import Executor
    from cruise_control_tpu_torch.facade import CruiseControl
    from cruise_control_tpu_torch.monitor import LoadMonitor, StaticCapacityResolver
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate
    from cruise_control_tpu_torch.analyzer import goals_base as G

    syn = SyntheticSpec(**spec)
    state, maps = generate(syn, device="cpu")
    backend = seed_fake_backend(FakeClusterBackend(metric_interval_ms=window_ms), state, maps, syn.num_racks)
    capacity = {Resource.CPU: syn.capacity_cpu, Resource.NW_IN: syn.capacity_nw_in,
                Resource.NW_OUT: syn.capacity_nw_out, Resource.DISK: syn.capacity_disk}
    monitor = LoadMonitor(backend, make_sampler(backend), StaticCapacityResolver(capacity),
                          num_windows=num_windows, window_ms=window_ms)
    executor = Executor(backend, progress_check_interval_s=FACADE_CHECK_INTERVAL_S,
                        pause_sampling=monitor.pause_sampling, resume_sampling=monitor.resume_sampling)
    cc = CruiseControl(backend, monitor, executor, goal_ids=goal_ids,
                       hard_ids=tuple(g for g in goal_ids if g in G.HARD_GOALS), device=device)
    cc.start()
    return cc, state, maps


def facade_clock(w: int) -> int:
    """The facade phases' window-aligned clock: the start of window ``w``."""
    return 1_700_000_000_000 // FACADE_WINDOW_MS * FACADE_WINDOW_MS + w * FACADE_WINDOW_MS


def build_facade(spec, device, goal_ids=DEFAULT_GOALS):
    """The port's service stack on a synthetic spec (``_facade_stack`` over
    the ``BackendMetricSampler``), its windows filled by ``sample_once`` on
    the window-aligned clock.  ``(facade, sampling wall s)``."""
    from cruise_control_tpu_torch.monitor import BackendMetricSampler

    cc, _, _ = _facade_stack(spec, device, goal_ids, BackendMetricSampler)
    t0 = time.monotonic()
    for w in range(FACADE_WINDOWS + 2):
        cc.monitor.sample_once(now_ms=facade_clock(w))
    return cc, time.monotonic() - t0


def backend_placement(backend) -> dict:
    """tp -> (replica list, leader) as the backend reports it."""
    return {i.tp: (i.replicas, i.leader) for infos in backend.describe_topics().values() for i in infos}


def _timed_rebalance(cc, dev, dryrun):
    t0 = time.monotonic()
    out = cc.rebalance(dryrun=dryrun)
    _sync(dev)
    return out, time.monotonic() - t0


def _record_shape(records) -> list:
    """Flight records as (kind, attribute names, spans' (kind, name, attribute names))."""
    return [(r.kind, sorted(r.attrs), [(s.kind, s.name, sorted(s.attrs)) for s in r.spans]) for r in records]


def phase_facade(dev):
    """The service's own path on the card at config #2 width: the facade's
    dry-run rebalance cold and warm, then an executed one, through the fake
    backend, the load monitor, the solver and the executor.  Returns the
    kernel host calls of the three rebalances and the dry run's proposals."""
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.obs import PROFILER, RECORDER
    from cruise_control_tpu_torch.obs.recorder import compile_events_since, compile_mark

    RECORDER.clear()
    torch.cuda.reset_peak_memory_stats()
    cc, sample_s = build_facade(CONFIG2, dev)
    _reset_counts()
    cold, cold_s = _timed_rebalance(cc, dev, True)
    mark = compile_mark()
    warm, warm_s = _timed_rebalance(cc, dev, True)
    warm_builds = compile_events_since(mark)
    done, exec_s = _timed_rebalance(cc, dev, False)
    launches = _counts()
    placement = backend_placement(cc.backend)
    wrong = [p.tp for p in done.optimizer_result.proposals
             if placement[p.tp] != (p.new_replicas, p.new_replicas[0])]
    t0 = time.monotonic()
    after = cc.cluster_model()
    state, _ = after.to_arrays(device=dev)
    viol = GoalOptimizer(device=dev).violations(state, GoalContext.build(state.num_topics, state.num_brokers,
                                                                          device=dev))
    after_hard = float(sum(viol[g] for g in G.HARD_GOALS).item())
    after_s = time.monotonic() - t0
    res, summary = cold.optimizer_result, done.execution
    walls = {kind: [r.duration_s for r in reversed(RECORDER.recent(RECORDER.capacity, kind=kind))]
             for kind in ("model", "optimize", "execution")}
    say(
        "facade", brokers=CONFIG2["num_brokers"], partitions=CONFIG2["num_partitions"],
        sampling_wall_s=sample_s, model_walls_s=walls["model"], optimize_walls_s=walls["optimize"],
        cold_rebalance_s=cold_s, warm_rebalance_s=warm_s,
        num_host_syncs=res.num_host_syncs, rounds=sum(r.rounds for r in res.goal_reports),
        proposals=len(res.proposals), total_moves=res.total_moves,
        inter_broker_moves=res.movement.num_inter_broker_moves,
        leadership_moves=res.movement.num_leadership_moves,
        residual_hard_violations=res.residual_hard_violations, balancedness=res.balancedness_score,
        execution_rebalance_s=exec_s, execution_walls_s=walls["execution"],
        tasks=summary and dict(completed=summary.completed, dead=summary.dead, aborted=summary.aborted,
                               failed=summary.failed),
        warm_kernel_builds=warm_builds,
        after_model_hard_violations=after_hard, after_model_wall_s=after_s,
        peak_device_memory_bytes=PROFILER.memory_peak_bytes(), host_calls=launches,
    )
    check(res.residual_hard_violations == 0, f"facade: hard goals violated {res.violated_hard_goals}")
    check(warm.optimizer_result.proposals == res.proposals, "facade: the warm rebalance differs from the cold one")
    check(not warm_builds, f"facade: kernels built in the warm rebalance: {warm_builds}")
    check(summary is not None and summary.succeeded, f"facade: the execution did not succeed: {summary}")
    check(done.optimizer_result.proposals == res.proposals, "facade: the executed proposals differ")
    check(not wrong, f"facade: {len(wrong)} partitions off their proposed replicas/leader, e.g. {wrong[:3]}")
    check(after_hard == 0, f"facade: the model taken after the execution has {after_hard} hard violations")
    for path in ("segment_sum_f32", "segment_sum_i32"):
        check(launches[path] > 0, f"facade: kernel path {path} never launched on the facade's path")
    return launches, res.proposals


def phase_facade_card_vs_cpu(dev):
    """The same path at config2_small on the CPU port and on the card: an
    executed rebalance each.  The proposals, the backend's admin log and its
    final placement, and the flight records' kinds and attribute names must
    be identical."""
    from cruise_control_tpu_torch.obs import RECORDER

    out = {}
    for where in (torch.device("cpu"), dev):
        RECORDER.clear()
        cc, _ = build_facade(CONFIG2_SMALL, where)
        done, wall = _timed_rebalance(cc, where, False)
        out[where.type] = (done, cc.backend, _record_shape(reversed(RECORDER.recent(RECORDER.capacity))), wall)
    (dc, bc, rc, wc), (dg, bg, rg, wg) = out["cpu"], out[dev.type]
    say("facade_card_vs_cpu", cpu_wall_s=wc, gpu_wall_s=wg, proposals=len(dg.optimizer_result.proposals),
        record_kinds=[k for k, _, _ in rg], completed=dg.execution and dg.execution.completed)
    check(dg.optimizer_result.proposals == dc.optimizer_result.proposals, "facade: card proposals differ from the CPU port's")
    check(bg.admin_log == bc.admin_log, "facade: the card's execution ran other admin calls than the CPU port's")
    check(backend_placement(bg) == backend_placement(bc), "facade: executed placements differ")
    check(rg == rc, f"facade: flight records differ: {rg} against {rc}")
    check(dg.execution is not None and dg.execution.succeeded, "facade: the card's execution did not succeed")


#: the self-healing notifier's grace period on the detector phases' fake clock
ALERT_MS, SELF_HEAL_MS = 10_000, 20_000
#: the broker the detector phases kill, and the broker whose only logdir dies
DEAD_BROKER, BAD_DISK_BROKER, BAD_LOGDIR = 3, 5, "/data/d0"
#: the threaded pass's detector interval (s) and its bound on the drain (s)
DETECTOR_INTERVAL_S, DRAIN_TIMEOUT_S = 0.5, 120.0


def _anomaly_row(a) -> dict:
    """An anomaly as plain data, without its id and clock."""
    from cruise_control_tpu_torch.detector import BrokerFailures, DiskFailures, GoalViolations

    row = {"type": a.anomaly_type.name, "description": a.description()}
    if isinstance(a, GoalViolations):
        row.update(violated_goals=list(a.violated_goals), fixable=a.fixable)
    if isinstance(a, BrokerFailures):
        row.update(failed_brokers=sorted(a.failed_brokers))
    if isinstance(a, DiskFailures):
        row.update(failed_disks={b: list(d) for b, d in sorted(a.failed_disks.items())})
    return row


def _hard_violations(cc, dev) -> float:
    """Hard-goal violations of a fresh model of the cluster, on ``dev``."""
    from cruise_control_tpu_torch.analyzer import GoalContext, GoalOptimizer
    from cruise_control_tpu_torch.analyzer import goals_base as G

    state, _ = cc.cluster_model().to_arrays(device=dev)
    viol = GoalOptimizer(device=dev).violations(state, GoalContext.build(state.num_topics, state.num_brokers,
                                                                          device=dev))
    return float(sum(viol[g] for g in G.HARD_GOALS).item())


class SelfHealDrive:
    """The synchronous self-healing drive of phases ``detector`` and
    ``detector_card_vs_cpu`` (and of the card tests): a facade from
    ``build_facade(spec, dev)``, a ``SelfHealingNotifier`` on a fake clock,
    ``manager.run_detector_once`` / ``manager.handle_anomaly``.  Its steps:

    1. :meth:`goal_violations`: the skewed start, fixed by an executed
       rebalance, then a re-detection;
    2. :meth:`broker_failure`: ``kill_broker(DEAD_BROKER)``, CHECK inside the
       grace period, FIXED (``remove_brokers``) once the fake clock passes it;
    3. :meth:`disk_failure`: ``kill_logdir(BAD_DISK_BROKER, BAD_LOGDIR)``, the
       broker's only logdir, FIXED (``fix_offline_replicas``).

    ``out`` holds the comparable outcome (anomalies, actions, every fix's
    proposals, the offline-logdir counts), ``info`` the walls and counts the
    phase prints, and ``host_calls`` the kernel host calls of the detections
    and fixes: the counts are set to 0 just before each and read just after,
    so the checks between them (fresh models, the pre-phase dry run) are not
    counted."""

    def __init__(self, spec, dev, workdir):
        from cruise_control_tpu_torch.detector import AnomalyDetectorManager, SelfHealingNotifier
        from cruise_control_tpu_torch.obs import RECORDER

        RECORDER.clear()
        self.dev, self.workdir = dev, workdir
        self.cc, sample_s = build_facade(spec, dev)
        self.backend = self.cc.backend
        self.clock = {"now": 1_000_000}
        notifier = SelfHealingNotifier(broker_failure_alert_threshold_ms=ALERT_MS,
                                       broker_failure_self_healing_threshold_ms=SELF_HEAL_MS,
                                       now_ms=lambda: self.clock["now"])
        self.manager = AnomalyDetectorManager(self.cc, notifier, detectors=[])
        self.out = {"anomalies": [], "actions": [], "fixes": []}
        self.info = {"sampling_wall_s": sample_s, "steps": []}
        _reset_counts()
        self.host_calls = dict.fromkeys(_counts(), 0)

    def _counted(self, fn, *args):
        """``fn(*args)`` with the kernel counts set to 0 before it, added to
        ``host_calls`` after it."""
        _reset_counts()
        try:
            return fn(*args)
        finally:
            for path, n in _counts().items():
                self.host_calls[path] += n

    def _detect(self, detector):
        t0 = time.monotonic()
        found = self._counted(self.manager.run_detector_once, detector)
        check(found == 1, f"detector: {type(detector).__name__} found no anomaly")
        anomaly = self.manager._next_anomaly(timeout_s=0.0)
        self.out["anomalies"].append(_anomaly_row(anomaly))
        return anomaly, time.monotonic() - t0

    def _handle(self, anomaly, step, want):
        t0 = time.monotonic()
        action = self._counted(self.manager.handle_anomaly, anomaly)
        _sync(self.dev)
        self.out["actions"].append(action)
        check(action == want, f"detector: step {step} gave {action}, want {want}")
        row = {"step": step, "action": action, "handle_wall_s": time.monotonic() - t0}
        res = anomaly.fix_result
        if action == "FIXED":
            s, opt = res.execution, res.optimizer_result
            check(s is not None and s.succeeded, f"detector: step {step}'s execution did not succeed: {s}")
            placement = backend_placement(self.backend)
            wrong = [p.tp for p in opt.proposals if placement[p.tp] != (p.new_replicas, p.new_replicas[0])]
            check(not wrong, f"detector: step {step}: {len(wrong)} partitions off their proposed placement")
            self.out["fixes"].append([(p.tp, p.old_replicas, p.new_replicas) for p in opt.proposals])
            row.update(num_host_syncs=opt.num_host_syncs, rounds=sum(r.rounds for r in opt.goal_reports),
                       proposals=len(opt.proposals), total_moves=opt.total_moves,
                       residual_hard_violations=opt.residual_hard_violations,
                       tasks=dict(completed=s.completed, dead=s.dead, aborted=s.aborted, failed=s.failed))
        self.info["steps"].append(row)
        return action

    def goal_violations(self):
        """Step 1: goal violations, their fix, a re-detection."""
        from cruise_control_tpu_torch.detector import GoalViolationDetector

        gv = GoalViolationDetector(self.cc, self.cc.goal_ids)
        a, det_s = self._detect(gv)
        check(a.anomaly_type.name == "GOAL_VIOLATION" and a.fixable, f"detector: {a.description()} is not fixable")
        check(gv.balancedness_score < 100.0, f"detector: balancedness {gv.balancedness_score} on the skewed start")
        self.info.update(violated_goals=list(a.violated_goals), balancedness=gv.balancedness_score,
                         detect_goal_s=det_s)
        self._handle(a, "goal violations", "FIXED")
        again = self._counted(gv.run)
        after = len(again[0].violated_goals) if again else 0
        self.out["redetected"] = [_anomaly_row(x) for x in again]
        check(after < len(a.violated_goals),
              f"detector: {after} goals violated after the fix, {len(a.violated_goals)} before")
        hard = _hard_violations(self.cc, self.dev)
        check(hard == 0, f"detector: {hard} hard violations in a fresh model after the goal fix")
        self.info.update(violated_goals_after=after, hard_violations_after_goal_fix=hard)

    def broker_failure(self):
        """Step 2: a dead broker, held back by the grace period, then drained."""
        from cruise_control_tpu_torch.detector import BrokerFailureDetector

        self.backend.kill_broker(DEAD_BROKER)
        bf = BrokerFailureDetector(self.backend, os.path.join(self.workdir, f"failed-brokers-{self.dev.type}.json"),
                                   now_ms=lambda: self.clock["now"])
        a, _ = self._detect(bf)
        check(a.failed_brokers == {DEAD_BROKER: self.clock["now"]}, f"detector: failed brokers {a.failed_brokers}")
        self._handle(a, "broker failure, in the grace period", "CHECK")
        self.clock["now"] += SELF_HEAL_MS + 5_000
        a, det_s = self._detect(bf)
        self._handle(a, "broker failure", "FIXED")
        on_dead = [tp for tp, (replicas, _) in backend_placement(self.backend).items() if DEAD_BROKER in replicas]
        check(not on_dead, f"detector: {len(on_dead)} partitions still on the dead broker, e.g. {on_dead[:3]}")
        hard = _hard_violations(self.cc, self.dev)
        check(hard == 0, f"detector: {hard} hard violations in a fresh model after the broker fix")
        self.info.update(detect_broker_s=det_s, hard_violations_after_broker_fix=hard)

    def disk_failure(self):
        """Step 3: the only logdir of a broker goes offline.  The fix's
        offline pre-phase moves every replica off it (a dry run of the fix
        with no goals proves it); the goals after it refill the broker, which
        is alive, as the JAX package does (ROADMAP Queue C, C4): a partition
        that gets its replica back there is not moved at all, and the others
        land on the dead logdir.  So the executed fix must leave fewer of the
        offline replicas there than it found, not none."""
        from cruise_control_tpu_torch.detector import DiskFailureDetector

        offline = sorted(tp for tp, (replicas, _) in backend_placement(self.backend).items()
                         if BAD_DISK_BROKER in replicas)
        self.backend.kill_logdir(BAD_DISK_BROKER, BAD_LOGDIR)
        a, det_s = self._detect(DiskFailureDetector(self.backend))
        check(a.failed_disks == {BAD_DISK_BROKER: [BAD_LOGDIR]}, f"detector: failed disks {a.failed_disks}")
        pre = self.cc.fix_offline_replicas(dryrun=True, goal_ids=()).optimizer_result.proposals
        moved_off = {p.tp for p in pre if BAD_DISK_BROKER in p.old_replicas and BAD_DISK_BROKER not in p.new_replicas}
        check(moved_off == set(offline),
              f"detector: the offline pre-phase moved {len(moved_off)} of the {len(offline)} offline replicas")
        self._handle(a, "disk failure", "FIXED")
        placement = backend_placement(self.backend)
        left = [tp for tp in offline if BAD_DISK_BROKER in placement[tp][0]]
        now_on = [tp for tp, (replicas, _) in placement.items() if BAD_DISK_BROKER in replicas]
        check(len(left) < len(offline), f"detector: {len(left)} of the {len(offline)} offline replicas never left")
        self.out["disk"] = dict(replicas_on_offline_logdir_before=len(offline),
                                moved_off_by_the_pre_phase=len(moved_off), offline_replicas_left=len(left),
                                replicas_on_offline_logdir_after=len(now_on))
        self.info.update(detect_disk_s=det_s, **self.out["disk"],
                         hard_violations_after_disk_fix=_hard_violations(self.cc, self.dev))

    def outcome(self, detailed=False):
        """(the comparable outcome, the printed info); ``detailed`` adds the
        walls by record kind and ``manager.state()``."""
        from cruise_control_tpu_torch.obs import RECORDER

        records = list(reversed(RECORDER.recent(RECORDER.capacity)))
        out = dict(self.out, admin_log=self.backend.admin_log, placement=backend_placement(self.backend),
                   records=_record_shape(records))
        info = dict(self.info)
        if detailed:
            kinds = {}
            for r in records:
                kinds.setdefault(r.kind, []).append(r.duration_s)
            info["walls_by_record_kind_s"] = kinds
            st = self.manager.state()
            info["manager_state"] = dict(num_self_healing_started=st.num_self_healing_started,
                                         num_self_healing_failed=st.num_self_healing_failed,
                                         queue_size=st.queue_size,
                                         recent_anomalies={k: v for k, v in st.recent_anomalies.items() if v})
        return out, info


def self_heal_steps(spec, dev, workdir, detailed=False):
    """All three steps of :class:`SelfHealDrive`: (outcome, info, host calls)."""
    drive = SelfHealDrive(spec, dev, workdir)
    drive.goal_violations()
    drive.broker_failure()
    drive.disk_failure()
    return (*drive.outcome(detailed), drive.host_calls)


def _threaded_pass(dev, workdir):
    """``start_detection`` at config2_small: the broker-failure and
    goal-violation detectors on their own threads, the handler on a third;
    a killed broker must be drained within ``DRAIN_TIMEOUT_S``.  The kernel
    counts are set to 0 just before the threads start and read once they
    have ended."""
    from cruise_control_tpu_torch.detector import (
        AnomalyDetectorManager,
        BrokerFailureDetector,
        GoalViolationDetector,
        SelfHealingNotifier,
    )
    from cruise_control_tpu_torch.obs import RECORDER

    RECORDER.clear()
    cc, _ = build_facade(CONFIG2_SMALL, dev)
    notifier = SelfHealingNotifier(broker_failure_alert_threshold_ms=0, broker_failure_self_healing_threshold_ms=0)
    manager = AnomalyDetectorManager(cc, notifier, detectors=[
        (BrokerFailureDetector(cc.backend, os.path.join(workdir, "threaded.json")), DETECTOR_INTERVAL_S),
        (GoalViolationDetector(cc, cc.goal_ids), DETECTOR_INTERVAL_S),
    ])
    cc.backend.kill_broker(DEAD_BROKER)
    t0 = time.monotonic()
    _reset_counts()
    manager.start_detection()
    threads = list(manager._threads)
    drained = False
    try:
        while not drained and time.monotonic() - t0 < DRAIN_TIMEOUT_S:
            time.sleep(0.1)
            drained = not cc.executor.has_ongoing_execution and all(
                DEAD_BROKER not in replicas for replicas, _ in backend_placement(cc.backend).values())
    finally:
        manager.shutdown()
        # shutdown waits 5 s a thread; a pass in the middle of a solve takes
        # longer, and must end before the next phase reads the recorder
        for t in threads:
            t.join(timeout=DRAIN_TIMEOUT_S)
    launches = _counts()
    wall = time.monotonic() - t0
    check(not any(t.is_alive() for t in threads), "detector: a detector thread outlived the threaded pass")
    actions = [r.attrs.get("action") for r in reversed(RECORDER.recent(RECORDER.capacity, kind="anomaly"))]
    passes = len(RECORDER.recent(RECORDER.capacity, kind="detector"))
    st = manager.state()
    row = dict(drained=drained, wall_s=wall, actions=actions, detector_passes=passes,
               num_self_healing_started=st.num_self_healing_started,
               num_self_healing_failed=st.num_self_healing_failed, host_calls=launches)
    check(drained, f"detector: the threaded pass did not drain broker {DEAD_BROKER} in {DRAIN_TIMEOUT_S} s: {row}")
    check(st.num_self_healing_failed == 0 and "FIX_FAILED" not in actions and "IGNORE" not in actions,
          f"detector: the threaded pass: {row}")
    return row, launches


def phase_detector(dev):
    """The self-healing plane on the card at config #2 width (the three
    steps of :class:`SelfHealDrive`), then the threaded pass at
    config2_small.  Returns the kernel host calls of each, apart."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="cc-smoke-detector-") as workdir:
        _, info, launches = self_heal_steps(CONFIG2, dev, workdir, detailed=True)
        threaded, threaded_launches = _threaded_pass(dev, workdir)
    say("detector", brokers=CONFIG2["num_brokers"], partitions=CONFIG2["num_partitions"], **info,
        threaded=threaded, host_calls=launches)
    for path in ("segment_sum_f32", "segment_sum_i32"):
        check(launches[path] > 0, f"detector: kernel path {path} never launched on the self-healing path")
        check(threaded_launches[path] > 0, f"detector: kernel path {path} never launched in the threaded pass")
    return launches, threaded_launches


def phase_detector_card_vs_cpu(dev):
    """:func:`self_heal_steps` at config2_small on the CPU port and on the
    card: the anomalies, actions, fixes' proposals, offline-logdir counts,
    admin log, final placement and record shapes must be identical."""
    import tempfile

    out, walls = {}, {}
    with tempfile.TemporaryDirectory(prefix="cc-smoke-detector-") as workdir:
        for where in (torch.device("cpu"), dev):
            t0 = time.monotonic()
            out[where.type], _, _ = self_heal_steps(CONFIG2_SMALL, where, workdir)
            walls[where.type] = time.monotonic() - t0
    c, g = out["cpu"], out[dev.type]
    say("detector_card_vs_cpu", cpu_wall_s=walls["cpu"], gpu_wall_s=walls[dev.type], actions=g["actions"],
        anomalies=[a["description"] for a in g["anomalies"]], proposals=[len(f) for f in g["fixes"]],
        disk=g["disk"], record_kinds=sorted({k for k, _, _ in g["records"]}))
    for key in ("anomalies", "actions", "fixes", "redetected", "disk", "admin_log", "placement", "records"):
        check(g[key] == c[key], f"detector: the card's {key} differ from the CPU port's")


#: the JAX replay tests' traces (tests/test_traces.py::TestReplay)
REPLAY_STORM = dict(phases=3, hold=3, magnitude=20.0)
#: the fleet harness's tenants here (its pinned 32 took 57.9 s on an H100,
#: PERF.md §7; the gate's fleet tier runs all 32)
REPLAY_FLEET_TENANTS = 8
REPLAY_QUIET = dict(name="flat", num_steps=6, step_s=60.0)


def phase_replay_harnesses(dev):
    """``run_replay`` on the JAX replay tests' drift storm and quiet trace on
    the card and on the CPU port (publishes, reactions, every step's
    outcome identical but for the host-sync counts), then the three ported
    bench harnesses once each at their pinned sizes on the card.  Returns
    the kernel host calls of each card run by name (the counts are set to 0
    just before it and read just after) and the controller harness's warm
    tick p50."""
    from cruise_control_tpu_torch.controller import bench as CB
    from cruise_control_tpu_torch.fleet import bench as FB
    from cruise_control_tpu_torch.traces import LoadTrace, drift_storm_trace, run_replay

    TB = importlib.import_module("cruise_control_tpu_torch.traces.bench")

    def comparable(report):
        d = report.to_dict()
        d["replay"] = {k: v for k, v in d["replay"].items() if k not in ("durationS", "totalDispatches")}
        d["steps"] = [{k: v for k, v in st.items() if k != "num_dispatches"} for st in d["steps"]]
        return d

    def counted(fn):
        _reset_counts()
        got = fn()
        return got, _counts()

    launches, rows = {}, {}
    for name, make in (("drift_storm", lambda: drift_storm_trace(**REPLAY_STORM)),
                       ("quiet", lambda: LoadTrace(**REPLAY_QUIET))):
        c = run_replay(make(), device=torch.device("cpu"))
        g, launches[name] = counted(lambda: run_replay(make(), device=dev))
        rows[name] = dict(published=g.published, reactions=g.reactions, steps=g.steps,
                          host_syncs=dict(cpu=c.total_dispatches, gpu=g.total_dispatches),
                          wall_s=dict(cpu=c.duration_s, gpu=g.duration_s),
                          warm_kernel_builds=g.warm_compile_events, host_calls=launches[name])
        check(comparable(g) == comparable(c), f"replay {name}: the card's report differs from the CPU port's")
        check(g.warm_compile_events == 0, f"replay {name}: {g.warm_compile_events} kernel builds after a publish")
    check(1 <= rows["drift_storm"]["published"] <= REPLAY_STORM["phases"], f"replay: {rows['drift_storm']}")
    check(rows["quiet"]["published"] <= 1, f"replay: the quiet trace published {rows['quiet']['published']}")
    harness = {}
    for name, run in (("controller", lambda: CB.run_bench(device=dev)),
                      ("fleet", lambda: FB.run_bench(num_tenants=REPLAY_FLEET_TENANTS, device=dev)),
                      ("traces", lambda: TB.run_bench(device=dev))):
        t0 = time.monotonic()
        harness[name], launches[f"{name}_harness"] = counted(run)
        harness[name]["harness_wall_s"] = time.monotonic() - t0
    say("replay_harnesses", replays=rows, **{f"{k}_harness": v for k, v in harness.items()},
        controller_warm_tick_host_syncs=harness["controller"]["warm_tick_host_syncs"],
        controller_dispatch_budget=harness["controller"]["dispatch_budget"], host_calls=launches)
    check(harness["controller"]["published"] == CB.SHIFTS, f"controller harness: {harness['controller']}")
    check(harness["fleet"]["published"] == REPLAY_FLEET_TENANTS * FB.SHIFTS, f"fleet harness: {harness['fleet']}")
    check(harness["traces"]["warm_host_syncs"] == 1, f"traces harness: {harness['traces']}")
    for name in ("controller", "fleet"):
        h = harness[name]
        check(h["warm_tick_host_syncs"] <= h["dispatch_budget"] and h["warm_compile_events"] == 0,
              f"{name} harness: {h['warm_tick_host_syncs']} host syncs a warm tick against a budget of "
              f"{h['dispatch_budget']}, {h['warm_compile_events']} build(s) or capture(s)")
    for name, h in harness.items():
        check(h["warm_compile_events"] == 0, f"{name} harness: kernel builds when warm: {h}")
    for name, calls in launches.items():
        check(calls["segment_sum_f32"] > 0, f"{name}: the fixed-order segment sum never launched on the card")
    return launches, harness


# -- phases 18-19: the metrics ingest, the replication and the self-monitoring --

#: the fetcher pool of the ingest phases
INGEST_FETCHERS = 4
#: the keys the ingest phases override in ``config/cruisecontrol.properties``:
#: the facade phases' windows, one metric interval a window
INGEST_OVERRIDES = {
    "partition.metrics.window.ms": FACADE_WINDOW_MS,
    "num.partition.metrics.windows": FACADE_WINDOWS,
    "metric.sampling.interval.ms": FACADE_WINDOW_MS,
}
#: windows of shifted load sampled, at most, until a tick publishes (the two
#: valid windows are averaged, so the second shifted window is the first
#: whose average is all shift)
INGEST_SHIFT_WINDOWS = 3
#: the JAX package's dispatch budget of a warm tick (``slo.dispatch.budget``
#: of its bench and gate), printed beside the port's host syncs
JAX_DISPATCH_BUDGET = 7


class IntervalTransport:
    """The ingest phases' metrics transport: the ``MetricsTransport`` SPI of
    either package (``publish``, ``poll``) with each batch stamped with the
    metric interval its reporter reports (``interval_ms``, set before the
    reporters publish).  The package's ``InMemoryTransport`` stamps the wall
    clock, which the phases' window-aligned clock never reaches.  Counts the
    bytes on the wire."""

    def __init__(self) -> None:
        self.interval_ms = 0
        self.batches = []
        self.bytes = 0

    def publish(self, payload: bytes) -> None:
        self.batches.append((self.interval_ms, payload))
        self.bytes += len(payload)

    def poll(self, from_ms: int, to_ms: int):
        return [p for ts, p in self.batches if from_ms <= ts < to_ms]


class ReporterFleet:
    """One ``MetricsReporter`` per broker of a fake backend (``reporter`` is
    either package's ``monitor.reporter`` module) publishing through one
    :class:`IntervalTransport`.  Each metric interval the backend's raw
    metrics are fetched once and split by broker, and each broker's reporter
    publishes its share: one fetch builds the metrics of every replica (and
    draws the backend's noise in the order the direct path does), so a fetch
    per reporter would cost a hundred times the host work."""

    def __init__(self, backend, reporter, interval_ms: int, first_ms: int) -> None:
        self.backend = backend
        self.interval_ms = interval_ms
        self.transport = IntervalTransport()
        self._share = {}
        self.reporters = [reporter.MetricsReporter(b, self.transport, collect_fn=self._collector(b))
                          for b in sorted(backend.describe_cluster().brokers)]
        self._next_ms = first_ms
        self.collect_s = self.serialize_s = 0.0

    def _collector(self, broker: int):
        return lambda: self._share.get(broker, [])

    def publish_until(self, now_ms: int) -> None:
        """Publish every interval from the last one published up to ``now_ms``."""
        for ts in range(self._next_ms, now_ms, self.interval_ms):
            t0 = time.perf_counter()
            share = {}
            for m in self.backend.fetch_raw_metrics(ts, ts + self.interval_ms):
                share.setdefault(m.broker_id, []).append(m)
            self._share = share
            t1 = time.perf_counter()
            self.transport.interval_ms = ts
            for r in self.reporters:
                r.report_once()
            self.collect_s += t1 - t0
            self.serialize_s += time.perf_counter() - t1
        self._next_ms = max(self._next_ms, now_ms)


def ingest_sampler(backend, transport, fetcher, reporter):
    """The ingest route's sampler: a ``FetcherPool`` of ``INGEST_FETCHERS``
    ``TransportMetricSampler``\\ s polling ``transport``, partitions assigned
    by the ``DefaultPartitionAssignor`` (``fetcher`` and ``reporter`` are
    either package's ``monitor`` modules)."""
    def partitions():
        return [i.tp for infos in backend.describe_topics().values() for i in infos]

    return fetcher.FetcherPool(lambda: reporter.TransportMetricSampler(transport, backend.describe_topics),
                               partitions, num_fetchers=INGEST_FETCHERS,
                               assignor=fetcher.DefaultPartitionAssignor())


def ingest_config():
    """``config/cruisecontrol.properties`` through the port's registry with
    ``INGEST_OVERRIDES``: ``(Config, {class key: resolved class name})``.
    Fails unless every class key resolves to a class of the port."""
    from cruise_control_tpu_torch.core.config import Config, load_properties, resolve_class
    from cruise_control_tpu_torch.core.config_defs import cruise_control_config

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "cruisecontrol.properties")
    cfg = Config(cruise_control_config(), {**load_properties(path), **INGEST_OVERRIDES})
    classes = {}
    for name, key in cfg.definition.keys().items():
        if key.type.value == "class":
            cls = resolve_class(cfg.get(name))
            classes[name] = f"{cls.__module__}.{cls.__name__}"
    check(len(classes) == 6 and all(c.startswith("cruise_control_tpu_torch.") for c in classes.values()),
          f"config: class keys {classes}")
    return cfg, classes


def build_ingest_facade(spec, device, cfg, goal_ids=DEFAULT_GOALS):
    """The facade stack of :func:`build_facade` with a deployment's ingest
    route as its sampler: a reporter in each broker, the wire format, an
    :class:`IntervalTransport` and a fetcher pool; the windows (``cfg``'s)
    fill on the window-aligned clock.  A namespace: the facade, the reporter
    fleet, the synthetic state and maps, the next window and the walls."""
    import types

    from cruise_control_tpu_torch.monitor import fetcher, reporter

    windows, window_ms = cfg.get("num.partition.metrics.windows"), cfg.get("partition.metrics.window.ms")
    check(window_ms == FACADE_WINDOW_MS, f"ingest: window {window_ms} ms off the facade clock")
    made = {}

    def make_sampler(backend):
        made["fleet"] = ReporterFleet(backend, reporter, window_ms, facade_clock(-(windows + 1)))
        return ingest_sampler(backend, made["fleet"].transport, fetcher, reporter)

    cc, state, maps = _facade_stack(spec, device, goal_ids, make_sampler, windows, window_ms)
    run = types.SimpleNamespace(cc=cc, fleet=made["fleet"], state=state, maps=maps, window=0, sample_s=0.0,
                                fetch_s=0.0)
    for _ in range(windows + 2):
        ingest_window(run)
    return run


def ingest_window(run) -> None:
    """The reporters publish up to the next window and the monitor samples it
    through the fetcher pool; ``run.fetch_s`` gains the pool's wall."""
    from cruise_control_tpu_torch.core.sensors import REGISTRY, SAMPLE_FETCH_TIMER

    now = facade_clock(run.window)
    timer = REGISTRY.timer(SAMPLE_FETCH_TIMER)
    before = timer.total_s
    t0 = time.perf_counter()
    run.fleet.publish_until(now)
    run.cc.monitor.sample_once(now_ms=now)
    run.sample_s += time.perf_counter() - t0
    run.fetch_s += timer.total_s - before
    run.window += 1


def _census() -> dict:
    """The profiler census per kernel: (calls, reckoned operations, bytes)."""
    from cruise_control_tpu_torch.obs import PROFILER

    return {k: (v["calls"], v["flops_total"], v["bytes_total"]) for k, v in PROFILER.per_program_totals().items()}


def _census_grown(before: dict, after: dict) -> dict:
    zero = (0, 0.0, 0.0)
    return {k: tuple(a - b for a, b in zip(after[k], before.get(k, zero))) for k in after
            if after[k] != before.get(k, zero)}


def _journal_key(records) -> list:
    """Controller-WAL records without their wall-clock fields."""
    return [{k: v for k, v in r.items() if k not in ("created_ms", "reaction_s", "ts_ms")} for r in records]


def ingest_steps(spec, device, workdir, cfg, on_step=None):
    """Steps 2-3 of the ingest phases on ``device``.  Ingest: the reporters
    fill the windows through the fetcher pool, then a dry-run rebalance cold
    and warm, each with the census's growth over it beside its optimize
    record's ``cost``.  Replication: a ``ContinuousController`` journaling
    under ``workdir`` and listening to the monitor's windows, a writer
    ``ReplicationState`` fed by the journal's listener, a ``FollowerTailer``
    on the same directory; the controller recovers and fences its epoch as
    the service does at startup; the backend's topics 0-9 scaled by 1.3, and their
    metrics sampled through the reporters window by window until a tick
    publishes; the follower polls; then the journal is compacted
    (``ControllerJournal.rewrite``) and the follower polls once more.
    ``on_step(label, window)`` runs between the steps, outside the walls."""
    import types

    from cruise_control_tpu_torch.controller import ContinuousController, ControllerConfig, ControllerJournal
    from cruise_control_tpu_torch.core.journal import Journal, JournalTail
    from cruise_control_tpu_torch.obs import RECORDER
    from cruise_control_tpu_torch.replication import FollowerTailer, ReplicationState

    step = on_step or (lambda label, window: None)
    out = types.SimpleNamespace(rebalances=[])
    run = build_ingest_facade(spec, device, cfg)
    out.run = run
    step("sampled", run.window)
    for label in ("cold", "warm"):
        census = _census()
        res, wall = _timed_rebalance(run.cc, device, True)
        cost = RECORDER.recent(1, kind="optimize")[0].attrs["cost"]
        out.rebalances.append(types.SimpleNamespace(result=res.optimizer_result, wall_s=wall, cost=cost,
                                                    census=_census_grown(census, _census())))
        step(label, run.window)
    jdir = os.path.join(workdir, "controller")
    c = ContinuousController(run.cc, journal=ControllerJournal(Journal(jdir)), config=ControllerConfig(**TICK_CFG),
                             device=device)
    run.cc.monitor.add_window_listener(c.on_window_delta)
    writer, records = ReplicationState(writer=True), []
    c.journal.listener = lambda rec: (records.append(rec), writer.apply(rec))
    follower = FollowerTailer(jdir, ReplicationState())
    out.recovered_records = c.recover()     # the service's startup: recover, then fence epoch + 1
    t0 = time.monotonic()
    c.warm_start()
    _sync(device)
    out.warm_start_s = time.monotonic() - t0
    step("warm_start", run.window)     # on the card the warm start captures the tick's goal graphs
    hot = set(run.maps.topic_names[:10])
    for tp, load in seeded_loads(run.state, run.maps).items():
        if tp[0] in hot:
            run.cc.backend.set_partition_load(tp, [x * SHIFT_FACTORS[2] for x in load])
    published, out.shift_windows = None, 0
    while published is None and out.shift_windows < INGEST_SHIFT_WINDOWS:
        ingest_window(run)
        out.shift_windows += 1
        t0 = time.monotonic()
        published = c.maybe_tick()
        _sync(device)
        out.tick_s = time.monotonic() - t0
    check(published is not None, f"replication: no tick published in {out.shift_windows} shifted windows")
    out.published, out.tick_attrs = published, dict(c._last_tick_attrs or {})
    out.tick_host_syncs = sum(s.dispatches for s in c.last_spans)
    step("tick", run.window)
    out.follower_applied = follower.poll_once()
    out.follower_staleness_ms = follower.state.staleness_ms()
    out.sets = {"controller": _set_key(c.standing), "writer": _set_key(writer.standing),
                "follower": _set_key(follower.state.standing)}
    out.versions = {"writer": (writer.set_version, writer.epoch),
                    "follower": (follower.state.set_version, follower.state.epoch)}
    seq = follower.state.seq
    c.journal.rewrite(c.standing)
    out.compaction_applied = follower.poll_once()
    out.compaction = dict(resets=follower.tail.resets, deltas=follower.state.seq - seq,
                          same_set=_set_key(follower.state.standing) == out.sets["writer"],
                          version=(follower.state.set_version, follower.state.epoch))
    out.journal = _journal_key(records)
    out.replayed = _journal_key(JournalTail(jdir).poll())   # a read that leaves the writer's segment open
    step("compacted", run.window)
    c.journal.close()
    run.cc.shutdown()
    return out


def _check_ingest(out, label) -> None:
    """The checks of steps 2-3 that hold on every device and size."""
    cold, warm = out.rebalances
    check(cold.result.residual_hard_violations == 0,
          f"{label}: hard goals violated {cold.result.violated_hard_goals}")
    check(warm.result.proposals == cold.result.proposals, f"{label}: the warm rebalance differs from the cold one")
    for r in out.rebalances:
        calls = sum(n for n, _, _ in r.census.values())
        check(r.cost["flops"] is not None and r.cost["bytes_accessed"] is not None and calls > 0,
              f"{label}: optimize cost {r.cost}")
        check((r.cost["profiled_calls"], r.cost["flops"], r.cost["bytes_accessed"])
              == (calls, sum(f for _, f, _ in r.census.values()), sum(b for _, _, b in r.census.values())),
              f"{label}: optimize cost {r.cost} is not its kernel calls' census {r.census}")
    check(out.published.trigger == "drift", f"{label}: the tick published on {out.published.trigger}")
    check(out.sets["follower"] == out.sets["writer"] == out.sets["controller"],
          f"{label}: the follower's set differs from the writer's")
    check(out.versions["follower"] == out.versions["writer"], f"{label}: versions {out.versions}")
    check(out.compaction == dict(resets=1, deltas=0, same_set=True, version=out.versions["writer"]),
          f"{label}: compaction {out.compaction}")
    check(out.replayed == out.journal[-1:], f"{label}: the compacted journal holds {len(out.replayed)} records")


def phase_ingest(dev, facade_proposals, tick_p50_s):
    """Phase 18 on the card at config #2 width: the config layer, the metrics
    ingest, the replication and the self-monitoring plane, then the
    self-monitoring bench, its denominator ``tick_p50_s``, the controller
    harness's warm tick p50 of phase 17.  Returns the kernel host calls of
    steps 2-3."""
    import tempfile

    from cruise_control_tpu_torch.obs import PROFILER, RECORDER
    from cruise_control_tpu_torch.obs import selfmon_bench
    from cruise_control_tpu_torch.obs.exporter import parse_exposition, render_prometheus
    from cruise_control_tpu_torch.obs.recorder import compile_events_since, compile_mark
    from cruise_control_tpu_torch.obs.selfmon import SelfMonitor
    from cruise_control_tpu_torch.obs.slo import SloEngine, build_pairs, shipped_specs
    from cruise_control_tpu_torch.monitor.wire import deserialize

    cfg, classes = ingest_config()
    say("ingest_config", overrides={k: cfg.get(k) for k in INGEST_OVERRIDES}, classes=classes)
    RECORDER.clear()
    with tempfile.TemporaryDirectory() as workdir:
        samples, statuses, compiles, started = [], {}, {}, {}
        mark = [compile_mark()]

        def on_step(label, window):
            # the steps up to the controller's warm start are the service's
            # startup: their compile events are counted from the flight record
            # (the warm start's captures among them); the self-monitor and its
            # SLOs start after it, its first sample taken then
            now = facade_clock(window) + 1_000 * len(samples)
            if not started:
                compiles[label] = float(len(compile_events_since(mark[0])))
                mark[0] = compile_mark()
                if label != "warm_start":
                    return
                started["mon"] = SelfMonitor(
                    interval_s=cfg.get("selfmon.sample.interval.ms") / 1000.0,
                    num_windows=cfg.get("selfmon.num.windows"), window_ms=cfg.get("selfmon.window.ms"),
                    spool_dir=os.path.join(workdir, "selfmon"), spool_max_bytes=cfg.get("selfmon.spool.max.bytes"))
                started["engine"] = SloEngine(shipped_specs(cfg.get), started["mon"], pairs=build_pairs(cfg.get))
                started["mon"].sample(now_ms=now)
            else:
                compiles[label] = started["mon"].sample(now_ms=now)["flight.compile-events.delta"]
            statuses.update({st["slo"]: st for st in started["engine"].evaluate(now_ms=now)})
            samples.append(label)

        census = _census()
        _reset_counts()
        out = ingest_steps(CONFIG2, dev, workdir, cfg, on_step)
        mon, engine = started["mon"], started["engine"]
        launches = _counts()
        grown = _census_grown(census, _census())
        run = out.run
        t0 = time.perf_counter()
        n = sum(len(deserialize(p)) for _, p in run.fleet.transport.batches)
        deserialize_s = time.perf_counter() - t0
        text = render_prometheus(slo_engine=engine, selfmon=mon, selfmon_window=2)
        parsed = parse_exposition(text)
        mon.stop()
        cold, warm = out.rebalances
        walls = {kind: [r.duration_s for r in reversed(RECORDER.recent(RECORDER.capacity, kind=kind))]
                 for kind in ("model", "optimize")}
        slos = {name: dict(value=st["value"], ok=st["ok"], firing=any(a["firing"] for a in st["alerts"]))
                for name, st in statuses.items()}
        say("ingest", brokers=CONFIG2["num_brokers"], partitions=CONFIG2["num_partitions"],
            reporters=len(run.fleet.reporters), fetchers=INGEST_FETCHERS, windows_sampled=run.window,
            sampling_wall_s=run.sample_s, collect_s=run.fleet.collect_s, serialize_s=run.fleet.serialize_s,
            fetch_s=run.fetch_s, deserialize_s_per_fetcher=deserialize_s, records_on_wire=n,
            bytes_on_wire=run.fleet.transport.bytes, batches_on_wire=len(run.fleet.transport.batches),
            model_walls_s=walls["model"], optimize_walls_s=walls["optimize"],
            cold_rebalance_s=cold.wall_s, warm_rebalance_s=warm.wall_s,
            proposals=len(cold.result.proposals), residual_hard_violations=cold.result.residual_hard_violations,
            num_host_syncs=cold.result.num_host_syncs, optimize_cost=[r.cost for r in out.rebalances],
            host_calls=launches)
        say("replication", warm_start_s=out.warm_start_s, shift=SHIFT_FACTORS[2], shift_windows=out.shift_windows,
            tick_wall_s=out.tick_s, reaction_s=out.published.reaction_s, trigger=out.published.trigger,
            proposals=len(out.published.proposals), tick_host_syncs=out.tick_host_syncs,
            goals_run=out.tick_attrs.get("goals_run"), journal_records=len(out.journal),
            follower_records_applied=out.follower_applied, follower_staleness_ms=out.follower_staleness_ms,
            version=out.versions["follower"], compaction=out.compaction,
            compaction_records_applied=out.compaction_applied)
        say("selfmon", samples=samples, series=len(mon.series_names()), spool_bytes=mon.status()["spool"]["bytes"],
            slos=slos, compile_events_by_step=compiles,
            warm_tick_dispatches=slos.get("warm-tick-dispatches", {}).get("value"),
            jax_dispatch_budget=JAX_DISPATCH_BUDGET, exposition_families=len(parsed),
            census_calls={k: v[0] for k, v in grown.items()})
        _check_ingest(out, "ingest")
        check(cold.result.proposals == facade_proposals, "ingest: the proposals differ from phase facade's")
        for path in ("segment_sum_f32", "segment_sum_i32"):
            check(launches[path] > 0, f"ingest: kernel path {path} never launched")
        check({k: v[0] for k, v in grown.items()} == {k: v for k, v in launches.items() if v},
              f"ingest: census calls {grown} are not the launches {launches}")
        gauges = {dict(lb)["sensor"] for lb, _ in parsed["cruise_control_tpu_gauge"]["samples"]
                  if dict(lb)["family"] == "Replication"}
        check("follower-staleness-ms" in gauges, f"selfmon: replication gauges {gauges}")
        programs = {dict(lb)["program"]: v for lb, v in parsed["cruise_control_tpu_executable_calls_total"]["samples"]}
        totals = PROFILER.per_program_totals()
        check(programs == {k: float(v["calls"]) for k, v in totals.items()}, f"selfmon: census rows {programs}")
        # the cold rebalance may capture its goal graphs (a shape this process
        # has not solved, or one the registry evicted), the controller's warm
        # start captures the tick's (the JAX warm start compiles its
        # programs); no other step builds or captures
        check(all(n == 0 for k, n in compiles.items() if k not in ("cold", "warm_start")),
              f"selfmon: compile events by step {compiles}")
        for name in ("replication-staleness", "warm-recompiles"):
            check(name in slos and not slos[name]["firing"], f"selfmon: {name} {slos.get(name)}")
    t0 = time.monotonic()
    bench = selfmon_bench.run_bench(tick_p50_s=tick_p50_s, device=dev)
    say("selfmon_bench", phase_wall_s=time.monotonic() - t0, **bench)
    failures = selfmon_bench.contract_failures(bench)
    check(not failures, f"selfmon_bench: {failures}")
    return launches


def phase_ingest_card_vs_cpu(dev):
    """Phase 19: steps 2-3 at config2_small on the CPU port and on the card.
    The proposals, the standing sets of controller, writer and follower, the
    journal records and the flight records' shapes must be identical."""
    import tempfile

    from cruise_control_tpu_torch.executor.journal import proposal_to_record
    from cruise_control_tpu_torch.obs import RECORDER

    cfg, _ = ingest_config()
    out = {}
    for where in (torch.device("cpu"), dev):
        RECORDER.clear()
        with tempfile.TemporaryDirectory() as workdir:
            t0 = time.monotonic()
            res = ingest_steps(CONFIG2_SMALL, where, workdir, cfg)
            wall = time.monotonic() - t0
        _check_ingest(res, f"ingest {where.type}")
        shapes = _record_shape(reversed(RECORDER.recent(RECORDER.capacity)))
        out[where.type] = (res, shapes, wall)
    (rc, sc, wc), (rg, sg, wg) = out["cpu"], out[dev.type]
    say("ingest_card_vs_cpu", cpu_wall_s=wc, gpu_wall_s=wg, proposals=len(rg.rebalances[0].result.proposals),
        tick_proposals=len(rg.published.proposals), journal_records=len(rg.journal),
        record_kinds=[k for k, _, _ in sg])
    check([proposal_to_record(p) for p in rg.rebalances[0].result.proposals]
          == [proposal_to_record(p) for p in rc.rebalances[0].result.proposals],
          "ingest: card proposals differ from the CPU port's")
    check(rg.sets == rc.sets, "ingest: card standing sets differ from the CPU port's")
    check(rg.journal == rc.journal and rg.replayed == rc.replayed, "ingest: card journal differs from the CPU port's")
    check(sg == sc, f"ingest: flight records differ: {sg} against {sc}")


#: the api phases' kafka-assigner request (goals 22, 23: ``even_assign`` runs)
API_ASSIGNER_GOALS = ("KafkaAssignerEvenRackAwareGoal", "KafkaAssignerDiskUsageDistributionGoal")
#: SIMULATE's fast sweep: 4 broker counts x 2 load factors, 8 scenarios
API_SIMULATE = dict(add_broker_counts=[0, 1, 2, 3], load_factors=[1.0, 1.25])
#: fields that record when, how long or with what timers something ran, the
#: sensor, profiler and self-monitor blocks (process-wide registries), and
#: ``bucketHit`` (whether this process had swept that shape before): dropped
#: before the card's bodies are held against the CPU's
API_WALL_CLOCK_KEYS = frozenset({
    "durationS", "startMs", "StartMs", "UserTaskId", "RequestId", "uptime_s", "ts", "wall_s",
    "Sensors", "Profiler", "SelfMonitor", "bucketHit",
})
#: the schema of a request whose name is not its endpoint's (REBALANCE answers
#: the PROPOSALS body)
API_SCHEMA_OF = {"PROPOSALS_warm": "PROPOSALS", "PROPOSALS_assigner": "PROPOSALS", "REBALANCE": "PROPOSALS"}
#: the entry point's wait for its serving line and its first HEALTHZ
API_ENTRY_TIMEOUT_S = 180.0


def api_props() -> dict:
    """The app's properties in the api phases: HTTP on an ephemeral port of
    127.0.0.1, the facade phases' windows, detectors and sampling on an hourly
    cadence with no initial pass (every solve comes from a request), and no
    sample store."""
    return {
        "webserver.http.address": "127.0.0.1",
        "webserver.http.port": 0,
        "partition.metrics.window.ms": FACADE_WINDOW_MS,
        "num.partition.metrics.windows": FACADE_WINDOWS,
        "metric.sampling.interval.ms": 3_600_000,
        "anomaly.detection.interval.ms": 3_600_000,
        "anomaly.detection.initial.pass": False,
        "sample.store.class": "cruise_control_tpu_torch.monitor.samplestore.NoopSampleStore",
    }


def build_api_app(spec, device):
    """The port's app (``CruiseControlTpuApp``) on ``device`` over a
    ``FakeClusterBackend`` seeded with ``spec`` (``seed_fake_backend``, the
    facade phases' capacities), its windows sampled on ``facade_clock``,
    serving HTTP.  The proposal refresher is stopped, so that every solve
    comes from a request."""
    from cruise_control_tpu_torch.app import CruiseControlTpuApp
    from cruise_control_tpu_torch.backend import FakeClusterBackend
    from cruise_control_tpu_torch.core.resources import Resource
    from cruise_control_tpu_torch.monitor import StaticCapacityResolver
    from cruise_control_tpu_torch.synthetic import SyntheticSpec, generate

    syn = SyntheticSpec(**spec)
    state, maps = generate(syn, device="cpu")
    backend = seed_fake_backend(FakeClusterBackend(metric_interval_ms=FACADE_WINDOW_MS), state, maps, syn.num_racks)
    app = CruiseControlTpuApp(api_props(), backend=backend, device=device)
    app.monitor.capacity_resolver = StaticCapacityResolver(
        {Resource.CPU: syn.capacity_cpu, Resource.NW_IN: syn.capacity_nw_in,
         Resource.NW_OUT: syn.capacity_nw_out, Resource.DISK: syn.capacity_disk})
    for w in range(FACADE_WINDOWS + 2):
        app.monitor.sample_once(now_ms=facade_clock(w))
    app.start(serve_http=True)
    app.app.stop_proposal_refresher()
    return app


def api_client(port: int):
    """The port's ``CruiseControlClient`` on 127.0.0.1:``port`` that keeps the
    status of every response it reads (``statuses``: (endpoint, status)), the
    user-task polls included."""
    from cruise_control_tpu_torch.client import ClientError, CruiseControlClient

    class RecordingClient(CruiseControlClient):
        statuses: list

        def _request(self, method, endpoint, params=None, headers=None, raw=False):
            try:
                out = super()._request(method, endpoint, params, headers=headers, raw=raw)
            except ClientError as e:
                self.statuses.append((endpoint, e.status))
                raise
            self.statuses.append((endpoint, out[0]))
            return out

    client = RecordingClient(f"http://127.0.0.1:{port}", poll_timeout_s=600.0, poll_interval_s=0.05)
    client.statuses = []
    return client


def api_requests(client, warm: bool = True):
    """The api phases' requests in order: ``(bodies by request, wall s by
    request)``.  PROPOSALS cold (filling the server's cache) and, with
    ``warm``, again past the cache; REBALANCE ``dryrun=true`` through its
    user task; the kafka-assigner PROPOSALS; SIMULATE's 8 scenarios."""
    calls = [
        ("HEALTHZ", lambda: client.healthz(readiness=True)),
        ("STATE", client.state),
        ("LOAD", client.load),
        ("PARTITION_LOAD", lambda: client.partition_load(entries=10)),
        ("KAFKA_CLUSTER_STATE", client.kafka_cluster_state),
        ("PROPOSALS", client.proposals),
        *([("PROPOSALS_warm", lambda: client.proposals(ignore_proposal_cache=True))] if warm else []),
        ("REBALANCE", lambda: client.rebalance(dryrun=True)),
        ("PROPOSALS_assigner", lambda: client.proposals(goals=API_ASSIGNER_GOALS)),
        ("SIMULATE", lambda: client.simulate(**API_SIMULATE)),
        ("USER_TASKS", client.user_tasks),
        ("METRICS", client.metrics),
        ("TRACES", lambda: client.traces(kind="optimize", limit=50)),
    ]
    bodies, walls = {}, {}
    for name, call in calls:
        t0 = time.monotonic()
        bodies[name] = call()
        walls[name] = time.monotonic() - t0
    return bodies, walls


def _check_api_bodies(bodies, statuses, label) -> None:
    """Every body passes its endpoint's schema (REBALANCE's is the PROPOSALS
    body), the page parses, and no response was a 5xx."""
    from cruise_control_tpu_torch.api.schemas import validate_endpoint
    from cruise_control_tpu_torch.obs.exporter import parse_exposition

    for name, body in bodies.items():
        if name == "METRICS":
            check(len(parse_exposition(body)) > 0, f"{label}: the METRICS page parses to nothing")
            continue
        validate_endpoint(API_SCHEMA_OF.get(name, name), body)
    errors = [(e, s) for e, s in statuses if s >= 500]
    check(not errors, f"{label}: 5xx responses {errors}")


def _wire_proposals(proposals) -> list:
    """The PROPOSALS body's first 1,000 proposals of an in-process result."""
    return [{"topic": p.tp[0], "partition": p.tp[1], "oldLeader": p.old_leader,
             "oldReplicas": list(p.old_replicas), "newReplicas": list(p.new_replicas)} for p in proposals[:1000]]


def api_entry_point(dev, workdir):
    """``python -m cruise_control_tpu_torch --config`` a copy of
    ``config/cruisecontrol.properties`` that serves on an ephemeral port and
    keeps its files in ``workdir`` (the card by default; ``--device cpu`` only
    when ``dev`` is the CPU).  Waits for its serving line and HEALTHZ, reads
    STATE, then stops it (SIGINT, a kill after 30 s).  Returns its lines, the
    STATE body, the walls and its exit code."""
    import re
    import signal
    import threading

    from cruise_control_tpu_torch.client import ClientError

    root = os.path.dirname(os.path.abspath(__file__))
    overrides = {"webserver.http.port": "0", "sample.store.dir": os.path.join(workdir, "samples"),
                 "failed.brokers.file.path": os.path.join(workdir, "failed-brokers.txt")}
    with open(os.path.join(root, "config", "cruisecontrol.properties")) as f:
        lines = [ln for ln in f.read().splitlines() if ln.split("=", 1)[0].strip() not in overrides]
    path = os.path.join(workdir, "cruisecontrol.properties")
    with open(path, "w") as f:
        f.write("\n".join(lines + [f"{k}={v}" for k, v in overrides.items()]) + "\n")
    cmd = [sys.executable, "-m", "cruise_control_tpu_torch", "--config", path]
    if dev.type != "cuda":
        cmd += ["--device", dev.type]
    out_lines, serving = [], threading.Event()
    t0 = time.monotonic()
    with open(os.path.join(workdir, "entry.stderr"), "w") as err:
        proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=err, text=True)

        def read():
            for ln in proc.stdout:
                out_lines.append(ln.rstrip("\n"))
                if "serving on" in ln:
                    serving.set()

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        try:
            while not serving.wait(0.2):
                check(proc.poll() is None, f"api entry point exited {proc.returncode}: {out_lines}")
                check(time.monotonic() - t0 < API_ENTRY_TIMEOUT_S, f"api entry point never served: {out_lines}")
            boot_s = time.monotonic() - t0
            port = int(re.search(r":(\d+) \(", out_lines[-1]).group(1))
            client = api_client(port)
            while True:
                try:
                    health = client.healthz()
                    break
                except (ClientError, OSError):
                    check(time.monotonic() - t0 < API_ENTRY_TIMEOUT_S, "api entry point: HEALTHZ never answered")
                    time.sleep(0.2)
            state = client.state()
            ready_s = time.monotonic() - t0
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            reader.join(timeout=10)
    with open(os.path.join(workdir, "entry.stderr")) as f:
        stderr_tail = f.read()[-2000:]
    return dict(lines=out_lines, health=health, state=state, boot_s=boot_s, ready_s=ready_s,
                statuses=client.statuses, returncode=proc.returncode, stderr_tail=stderr_tail)


def phase_api(dev, facade_proposals):
    """Phase 20, the REST API at config #2 width on the card: the port's app
    (``build_api_app``) driven over HTTP by the port's client, every request's
    wall, then the process entry point.  Returns the kernel host calls of the
    requests."""
    import tempfile

    from cruise_control_tpu_torch.obs import RECORDER

    RECORDER.clear()
    t0 = time.monotonic()
    app = build_api_app(CONFIG2, dev)
    build_s = time.monotonic() - t0
    try:
        client = api_client(app.port)
        census = _census()
        _reset_counts()
        bodies, walls = api_requests(client)
        _sync(dev)
        launches = _counts()
        grown = _census_grown(census, _census())
        t0 = time.monotonic()
        op = app.cruise_control.rebalance(dryrun=True)     # in process, for the comparison: not counted
        _sync(dev)
        in_process_s = time.monotonic() - t0
    finally:
        app.stop()
    _check_api_bodies(bodies, client.statuses, "api")
    res = op.optimizer_result
    cold, warm, rebalance = bodies["PROPOSALS"], bodies["PROPOSALS_warm"], bodies["REBALANCE"]
    optimize = list(reversed(bodies["TRACES"]["traces"]))    # oldest first
    polled = [s for e, s in client.statuses if e == "rebalance"]
    say("api", brokers=CONFIG2["num_brokers"], partitions=CONFIG2["num_partitions"], device=str(app.device),
        app_build_and_sampling_s=build_s, request_walls_s=walls, in_process_rebalance_s=in_process_s,
        proposals=cold["numProposals"], proposals_equal_facade_phase=cold["numProposals"] == len(facade_proposals),
        facade_phase_proposals=len(facade_proposals), assigner_proposals=bodies["PROPOSALS_assigner"]["numProposals"],
        violated_hard_goals=cold["violatedHardGoals"], load_rows=len(bodies["LOAD"]["brokers"]),
        partition_load_rows=len(bodies["PARTITION_LOAD"]["records"]),
        simulate_scenarios=len(bodies["SIMULATE"]["scenarios"]), user_tasks=len(bodies["USER_TASKS"]["userTasks"]),
        rebalance_statuses=polled, responses=len(client.statuses),
        status_counts={str(s): sum(1 for _, x in client.statuses if x == s) for s in sorted({x for _, x in client.statuses})},
        optimize_records=len(optimize), optimize_compile_events=[len(t["compile_events"]) for t in optimize],
        host_calls=launches, census_calls={k: v[0] for k, v in grown.items()})
    check(cold["proposals"] == _wire_proposals(res.proposals) and cold["numProposals"] == len(res.proposals),
          "api: PROPOSALS over HTTP differ from the in-process rebalance's")
    for name, body in (("PROPOSALS_warm", warm), ("REBALANCE", rebalance)):
        check(body["proposals"] == cold["proposals"] and body["numProposals"] == cold["numProposals"],
              f"api: {name} differs from the cold PROPOSALS")
    check(res.residual_hard_violations == 0 and not cold["violatedHardGoals"],
          f"api: hard goals violated {cold['violatedHardGoals']}")
    check(len(optimize) >= 2 and not optimize[1]["compile_events"],
          f"api: the warm optimize record {optimize[1:2]} has a compile event")
    check(polled and polled[0] in (200, 202), f"api: REBALANCE answered {polled}")
    for path in ("segment_sum_f32", "segment_sum_i32", "even_assign"):
        check(launches[path] > 0, f"api: kernel path {path} never launched")
    check({k: v[0] for k, v in grown.items()} == {k: v for k, v in launches.items() if v},
          f"api: census calls {grown} are not the launches {launches}")
    with tempfile.TemporaryDirectory() as workdir:
        entry = api_entry_point(dev, workdir)
    say("api_entry_point", lines=entry["lines"], boot_s=entry["boot_s"], ready_s=entry["ready_s"],
        readiness=entry["health"]["state"], monitor_state=entry["state"]["MonitorState"]["state"],
        statuses=entry["statuses"], returncode=entry["returncode"])
    check(entry["lines"] and entry["lines"][0].startswith("cruise-control-tpu-torch device: "),
          f"api entry point: no probe line in {entry['lines']} ({entry['stderr_tail']})")
    if dev.type == "cuda":
        check(entry["lines"][0].endswith(torch.cuda.get_device_name(0)),
              f"api entry point: the probe named {entry['lines'][0]!r}")
    check(f"({dev.type})" in entry["lines"][-1], f"api entry point served on {entry['lines'][-1]!r}")
    check(not [s for _, s in entry["statuses"] if s >= 500], f"api entry point: 5xx {entry['statuses']}")
    return launches


def phase_api_harnesses(dev):
    """Phase 21: the serving overload bench (``api/bench.py``, its pinned 200
    clients against 4 execution slots and a queue of 8) with its app on the
    card, then the replication fan-out bench (``replication/bench.py``, 2
    follower processes on the CPU, 500 watchers, 10 publishes).  Each must
    meet its harness's own contract."""
    from cruise_control_tpu_torch.api import bench as api_bench
    from cruise_control_tpu_torch.replication import bench as repl_bench

    _reset_counts()
    t0 = time.monotonic()
    serving = api_bench.run_bench(device=dev)
    serving_s = time.monotonic() - t0
    launches = _counts()
    say("api_bench", phase_wall_s=serving_s, host_calls=launches,
        **{k: serving[k] for k in ("platform", "workload", "requests", "admitted", "solver_admitted", "shed",
                                   "http_5xx", "status_counts", "other_4xx", "sheds_missing_retry_after",
                                   "p50_admitted_s", "p95_admitted_s", "max_admitted_s", "goodput_rps", "wall_s")})
    problems = api_bench.check_contract(serving)
    check(not problems, f"api_bench: {problems}")
    t0 = time.monotonic()
    repl = repl_bench.run_bench(device=dev)
    say("replication_bench", phase_wall_s=time.monotonic() - t0, **repl)
    problems = repl_bench.check_contract(repl)
    check(not problems, f"replication_bench: {problems}")


def _strip_wall_clock(body):
    if isinstance(body, dict):
        return {k: _strip_wall_clock(v) for k, v in body.items() if k not in API_WALL_CLOCK_KEYS}
    if isinstance(body, list):
        return [_strip_wall_clock(v) for v in body]
    return body


def phase_api_card_vs_cpu(dev):
    """Phase 22: the api phase's requests (PROPOSALS once) at config2_small to
    one app on the CPU port and one on the card.  Every body but the METRICS
    page and the flight records (timings through and through) must be
    identical once ``API_WALL_CLOCK_KEYS`` are dropped."""
    out = []
    for where in (torch.device("cpu"), dev):
        app = build_api_app(CONFIG2_SMALL, where)
        try:
            client = api_client(app.port)
            t0 = time.monotonic()
            bodies, _ = api_requests(client, warm=False)
            wall = time.monotonic() - t0
        finally:
            app.stop()
        _check_api_bodies(bodies, client.statuses, f"api_card_vs_cpu {where.type}")
        out.append(({k: _strip_wall_clock(v) for k, v in bodies.items() if k not in ("METRICS", "TRACES")}, wall))
    (bc, wc), (bg, wg) = out
    differ = sorted(k for k in bc if bc[k] != bg[k])
    say("api_card_vs_cpu", cpu_wall_s=wc, gpu_wall_s=wg, requests=sorted(bc), proposals=bg["PROPOSALS"]["numProposals"],
        assigner_proposals=bg["PROPOSALS_assigner"]["numProposals"], differ=differ)
    check(not differ, f"api: card bodies differ from the CPU port's: {differ}")


# -- the sharded solver ---------------------------------------------------------------

#: ranks of the config #2 sharded solve; they share the one card over gloo
PARALLEL_RANKS = 4
#: the gate's mesh8 tier (cruise_control_tpu/obs/gate.py:142-147): 8 ranks
MESH8 = dict(
    num_racks=4, num_brokers=32, num_topics=8, num_partitions=256, replication_factor=3,
    distribution="exponential", skew_brokers=8, mean_cpu=0.25, mean_disk=0.2, mean_nw_in=0.15,
    mean_nw_out=0.15, seed=5,
)
MESH8_RANKS = 8
#: the gather path's case: the JAX gather-path test's cluster
#: (tests/test_parallel.py:205, 128 partitions on 8 brokers) under a
#: preferred-leader goal list that moves replicas and leaders there
GATHER = dict(
    num_racks=4, num_brokers=8, num_topics=6, num_partitions=128, replication_factor=3,
    distribution="exponential", skew_brokers=3, seed=23, mean_disk=0.2, mean_nw_in=0.15,
)
#: fast_sweep(mesh=) of these load factors and one removed broker: 10
#: scenarios over 4 ranks, padded to 12
PARALLEL_SWEEP_FACTORS = (0.6, 0.8, 1.0, 1.1, 1.25, 1.5, 2.0, 2.5, 3.0)
PARALLEL_TIMEOUT_S = 600


def _solution(final, res, num_replicas: int) -> dict:
    """A solve's outcome as host values: placements (trimmed to the input's
    replicas; a sharded final is padded to a multiple of the ranks), leaders,
    proposals as (tp, old, new), violations after, balancedness."""
    return dict(
        replica_broker=final.replica_broker.cpu().numpy()[:num_replicas].tolist(),
        partition_leader=final.partition_leader.cpu().numpy().tolist(),
        proposals=[(p.tp, tuple(p.old_replicas), tuple(p.new_replicas)) for p in res.proposals],
        violations_after=dict(res.violations_after),
        balancedness=res.balancedness_score,
        residual_hard_violations=res.residual_hard_violations,
    )


def _first_difference(got: dict, want: dict):
    """The first key where two solutions differ, or None."""
    return next((k for k in want if got[k] != want[k]), None)


def parallel_rank_solve(mesh, spec, goal_kw, warm=False):
    """One rank of a sharded solve (``run_ranks`` calls it in every rank):
    ``ShardedGoalOptimizer.optimize`` on ``spec`` cold (and warm), with the
    rank's kernel host calls, collectives and host wall inside them counted
    from 0 around the cold solve (the walls around the warm one too) and
    its peak device memory."""
    from cruise_control_tpu_torch.parallel import ShardedGoalOptimizer
    from cruise_control_tpu_torch.parallel.mesh import COLLECTIVE_WALL_S, COLLECTIVES, reset_collective_counts

    cuda = mesh.device.type == "cuda"
    state, ctx, maps = _case(spec, mesh.device)
    opt = ShardedGoalOptimizer(mesh=mesh, **goal_kw)
    if cuda:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    _reset_counts()
    reset_collective_counts()
    t0 = time.monotonic()
    final, res = opt.optimize(state, ctx, maps=maps)
    if cuda:
        torch.cuda.synchronize(mesh.device)
    cold_s = time.monotonic() - t0
    launches, collectives, cold_walls = _counts(), dict(COLLECTIVES), dict(COLLECTIVE_WALL_S)
    warm_s = warm_walls = None
    if warm:
        reset_collective_counts()
        t0 = time.monotonic()
        _, warm_res = opt.optimize(state, ctx, maps=maps)
        if cuda:
            torch.cuda.synchronize(mesh.device)
        warm_s = time.monotonic() - t0
        warm_walls = dict(COLLECTIVE_WALL_S)
        check(warm_res.total_moves == res.total_moves, f"rank {mesh.rank}: warm sharded solve differs from cold")
    return dict(
        solution=_solution(final, res, state.num_replicas), use_spmd=opt.use_spmd,
        backend=mesh.backend, world=mesh.world, cold_wall_s=cold_s, warm_wall_s=warm_s,
        host_syncs=res.num_host_syncs, goal_steps=len(res.goal_reports),
        rounds=sum(r.rounds for r in res.goal_reports), launches=launches, collectives=collectives,
        cold_collective_wall_s=cold_walls, warm_collective_wall_s=warm_walls,
        peak_mib=torch.cuda.max_memory_allocated(mesh.device) / 2**20 if cuda else None,
    )


def parallel_rank_gather_and_sweep(mesh, ple_kw, sweep_spec, factors):
    """One rank of the gather path (a preferred-leader goal list on
    :data:`GATHER`) and of ``fast_sweep(mesh=)`` beside the same sweep
    unsharded."""
    from cruise_control_tpu_torch.sim import Scenario, fast_sweep

    out = parallel_rank_solve(mesh, GATHER, ple_kw)
    state, _, _ = _case(sweep_spec, mesh.device)
    scenarios = [Scenario(name=f"x{f}", load_factor=f) for f in factors] + [
        Scenario(name="minus1", remove_brokers=(0,))
    ]
    sharded = fast_sweep(state, scenarios, goal_ids=DEFAULT_GOALS, device=mesh.device, mesh=mesh)
    whole = fast_sweep(state, scenarios, goal_ids=DEFAULT_GOALS, device=mesh.device)
    out["sweep"] = [v.to_dict() for v in sharded.scenarios]
    out["sweep_unsharded"] = [v.to_dict() for v in whole.scenarios]
    return out


def failing_rank(mesh):
    """A rank function for the launcher's failure path (the card and CPU
    tests): rank 1 raises while the others wait in a collective that can
    never finish."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.all_gather(torch.zeros(1, device=mesh.device))
    return mesh.rank


def _check_ranks(label, runs, want):
    for rank, run in enumerate(runs):
        diff = _first_difference(run["solution"], want)
        check(diff is None, f"{label}: rank {rank}'s {diff} differs from the single-device solve")
        check(run["solution"]["residual_hard_violations"] == 0, f"{label}: rank {rank} leaves hard violations")


def phase_parallel(dev, config2_final, config2_res):
    """Config #2 at full width through ``ShardedGoalOptimizer`` on 4 ranks
    sharing the card over gloo: the placements, leaders, proposals,
    violations and balancedness of every rank must equal phase 4's
    single-device card solve, with no hard violation.  Then one rank on
    NCCL at config2_small must equal the single-device solve there.  Returns
    the K1/K2 host calls summed over the 4 ranks and rank 0's collectives."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.parallel import run_ranks

    heavy = dict(enable_heavy_goals=True)
    t0 = time.monotonic()
    runs = run_ranks(parallel_rank_solve, PARALLEL_RANKS, device="cuda", timeout_s=PARALLEL_TIMEOUT_S,
                     args=(CONFIG2, heavy, True))
    phase_s = time.monotonic() - t0
    _check_ranks("parallel config2", runs, _solution(config2_final, config2_res, config2_final.num_replicas))
    check(all(r["use_spmd"] and r["backend"] == "gloo" for r in runs), "parallel: not the SPMD path over gloo")
    launches = {path: sum(r["launches"][path] for r in runs) for path in runs[0]["launches"]}
    for path in ("segment_sum_f32", "segment_sum_i32"):
        check(all(r["launches"][path] > 0 for r in runs), f"parallel: kernel path {path} never launched in a rank")
    r0 = runs[0]
    total = sum(r0["collectives"].values())
    say(
        "parallel", backend=r0["backend"], ranks=PARALLEL_RANKS, brokers=config2_final.num_brokers,
        replicas=config2_final.num_replicas, spawn_and_solves_wall_s=phase_s,
        cold_wall_s=[r["cold_wall_s"] for r in runs], warm_wall_s=[r["warm_wall_s"] for r in runs],
        host_syncs=r0["host_syncs"], goal_steps=r0["goal_steps"], rounds=r0["rounds"],
        collectives=r0["collectives"], collectives_per_goal_step=total / r0["goal_steps"],
        collectives_per_round=total / max(r0["rounds"], 1),
        host_calls_per_rank=[r["launches"] for r in runs], host_calls_summed=launches,
        # the host wall inside the collectives, a fold's including its ranks'
        # kernel calls and the waits for the ranks before it
        warm_collective_wall_s_per_rank=[r["warm_collective_wall_s"] for r in runs],
        warm_fold_share_per_rank=[r["warm_collective_wall_s"]["fold"] / r["warm_wall_s"] for r in runs],
        cold_collective_wall_s_per_rank=[r["cold_collective_wall_s"] for r in runs],
        peak_mib_per_rank=[r["peak_mib"] for r in runs],
        total_moves=config2_res.total_moves, balancedness=config2_res.balancedness_score,
    )

    # one rank on NCCL: the communicator path on this card
    state, ctx, maps = _case(CONFIG2_SMALL, dev)
    final, res = GoalOptimizer(device=dev, **heavy).optimize(state, ctx, maps=maps)
    (nccl,) = run_ranks(parallel_rank_solve, 1, device="cuda", backend="nccl", timeout_s=PARALLEL_TIMEOUT_S,
                        args=(CONFIG2_SMALL, heavy))
    _check_ranks("parallel nccl config2_small", [nccl], _solution(final, res, state.num_replicas))
    check(nccl["backend"] == "nccl" and nccl["use_spmd"], "parallel: the NCCL rank did not run the SPMD path")
    say("parallel_nccl", config="config2_small", backend=nccl["backend"], ranks=1,
        cold_wall_s=nccl["cold_wall_s"], collectives=nccl["collectives"], host_calls=nccl["launches"],
        peak_mib=nccl["peak_mib"])
    return launches, r0["collectives"]


def mesh8_card_vs_cpu(dev, ranks=MESH8_RANKS):
    """The gate's mesh8 workload (16 goals, heavy goals on) sharded over
    ``ranks`` ranks on the card and over as many gloo ranks on the CPU port:
    every rank of both identical, and equal to the single-device card solve.
    Returns the two sets of rank results."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.parallel import run_ranks

    heavy = dict(enable_heavy_goals=True)
    state, ctx, maps = _case(MESH8, dev)
    final, res = GoalOptimizer(device=dev, **heavy).optimize(state, ctx, maps=maps)
    want = _solution(final, res, state.num_replicas)
    card = run_ranks(parallel_rank_solve, ranks, device="cuda", timeout_s=PARALLEL_TIMEOUT_S, args=(MESH8, heavy))
    cpu = run_ranks(parallel_rank_solve, ranks, device="cpu", timeout_s=PARALLEL_TIMEOUT_S, args=(MESH8, heavy))
    _check_ranks("mesh8 card", card, want)
    _check_ranks("mesh8 cpu", cpu, want)
    return card, cpu


def phase_parallel_card_vs_cpu(dev):
    """mesh8 on 8 card ranks and 8 CPU ranks (identical, and equal to the
    single-device solve); then, on 4 card ranks, a preferred-leader goal
    list through the gather path (equal to the single-device solve) and
    ``fast_sweep(mesh=)`` (bit-equal to the unsharded sweep)."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer import goals_base as G
    from cruise_control_tpu_torch.parallel import run_ranks

    t0 = time.monotonic()
    card, cpu = mesh8_card_vs_cpu(dev)
    mesh8_s = time.monotonic() - t0
    ple = dict(goal_ids=(G.RACK_AWARE, G.REPLICA_DISTRIBUTION, G.LEADER_REPLICA_DIST, G.PREFERRED_LEADER_ELECTION),
               hard_ids=(G.RACK_AWARE,), enable_heavy_goals=True)
    state, ctx, maps = _case(GATHER, dev)
    final, res = GoalOptimizer(device=dev, **ple).optimize(state, ctx, maps=maps)
    check(res.total_moves > 0, "gather path: the case moves nothing")
    runs = run_ranks(parallel_rank_gather_and_sweep, PARALLEL_RANKS, device="cuda", timeout_s=PARALLEL_TIMEOUT_S,
                     args=(ple, MESH8, PARALLEL_SWEEP_FACTORS))
    _check_ranks("gather path", runs, _solution(final, res, state.num_replicas))
    check(not any(r["use_spmd"] for r in runs), "gather path: a preferred-leader list ran the SPMD path")
    check(all(r["collectives"] == {"all_gather": 1, "all_reduce": 0, "fold": 0} for r in runs),
          "gather path: not one all_gather")
    for rank, r in enumerate(runs):
        check(r["sweep"] == r["sweep_unsharded"] == runs[0]["sweep_unsharded"],
              f"fast_sweep(mesh=): rank {rank}'s verdicts differ from the unsharded sweep")
    say(
        "parallel_card_vs_cpu", config="mesh8", ranks=MESH8_RANKS, mesh8_wall_s=mesh8_s,
        card_cold_wall_s=[r["cold_wall_s"] for r in card], cpu_cold_wall_s=[r["cold_wall_s"] for r in cpu],
        card_collectives=card[0]["collectives"], card_host_calls_summed={
            p: sum(r["launches"][p] for r in card) for p in card[0]["launches"]},
        gather_path_goal_ids=list(ple["goal_ids"]), gather_path_moves=res.total_moves,
        sweep_scenarios=len(runs[0]["sweep"]), sweep_ranks=PARALLEL_RANKS,
    )


# -- phases 25-27: the scale ladder, the regression gate, the recovery bench ---

#: the gate phase's tiers and its wall slack (walls follow the shared host)
GATE_TIERS = "config1,config2_small,exporter,traces,controller,fleet"
GATE_WALL_SLACK = "3"
GATE_TIMEOUT_S = 900


#: config #4's goal list (18 goals, heavy goals on, two logdirs a broker) cut
#: to 48 brokers and 1,500 partitions: ``SCALE_REFERENCE_config4_small.json``
CONFIG4_SMALL = dict(config4=True, brokers=48, partitions=1500)


def phase_scale(dev):
    """Config #3's default goal subset through ``bench_scale.run`` on the
    card, cold then warm, held to the committed JAX record; then config #4's
    goal list at :data:`CONFIG4_SMALL` on the card and on the CPU port, both
    held to its JAX record.  Returns the kernel host calls of config #3's
    warm solve (counted from 0 just before it)."""
    from cruise_control_tpu_torch import bench_scale

    line, artifact = bench_scale.run(device=dev)
    with open(bench_scale.reference_path("config3")) as f:
        reference = json.load(f)
    diffs = bench_scale.differences(artifact, reference)
    launches = line["host_calls"]
    say("scale", workload=line["metric"], cold_wall_s=line["first_run_s"], warm_wall_s=line["value"],
        host_syncs=line["num_host_syncs"], host_calls=launches, peak_device_mib=line["peak_device_mib"],
        generate_s=artifact["generate_s"], total_moves=line["total_moves"], total_rounds=line["total_rounds"],
        balancedness=line["balancedness"], residual_hard_violations=line["residual_hard_violations"],
        max_active_brokers=artifact["max_active_brokers"], digest=line["digest"],
        goals=[[r["name"], r["rounds"], r["moves"], r["violations_before"], r["violations_after"]]
               for r in artifact["goal_reports"]],
        reference_jax_cpu_wall_s=reference.get("jax_cpu_wall_s"), differences=diffs)
    check(not diffs, f"scale: config #3 differs from the JAX record: {diffs[:5]}")
    check(line["residual_hard_violations"] == 0.0, f"scale: {line['residual_hard_violations']} hard violations left")
    for path in ("segment_sum_f32", "segment_sum_i32"):
        check(launches[path] > 0, f"scale: {path} never launched in the warm config #3 solve")

    with open(bench_scale.reference_path("config4_small")) as f:
        reference = json.load(f)
    t = time.monotonic()
    card, card_art = bench_scale.run(**CONFIG4_SMALL, warmup=False, device=dev)
    card_s = time.monotonic() - t
    t = time.monotonic()
    cpu, cpu_art = bench_scale.run(**CONFIG4_SMALL, warmup=False, device="cpu")
    cpu_s = time.monotonic() - t
    diffs = bench_scale.differences(card_art, reference)
    say("scale_config4_small", workload=card["metric"], goals=card["goals"], card_wall_s=card_s,
        cpu_port_wall_s=cpu_s, total_moves=card["total_moves"], total_rounds=card["total_rounds"],
        host_syncs=card["num_host_syncs"], host_calls=card["host_calls"], digest=card["digest"],
        cpu_port_digest=cpu["digest"], reference_digest=reference["digest"],
        residual_hard_violations=card["residual_hard_violations"], differences=diffs)
    check(not diffs, f"scale: config #4's goal list at 48 brokers differs from the JAX record: {diffs[:5]}")
    check(card["digest"] == cpu["digest"], "scale: config #4's goal list at 48 brokers: card != CPU port")
    check(bench_scale.differences(cpu_art, reference) == [], "scale: the CPU port differs from the JAX record")
    return launches


def phase_gate(dev):
    """The port's gate on the card over :data:`GATE_TIERS` in its own child
    processes against the committed card baseline."""
    env = dict(os.environ, CC_TPU_GATE_WALL_SLACK=GATE_WALL_SLACK)
    proc = subprocess.run(
        [sys.executable, "-m", "cruise_control_tpu_torch.obs.gate", "--device", str(dev), "--tiers", GATE_TIERS],
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=GATE_TIMEOUT_S,
    )
    say("gate", tiers=GATE_TIERS, wall_slack=float(GATE_WALL_SLACK), rc=proc.returncode,
        output=proc.stdout.strip().splitlines(), stderr_tail=proc.stderr.strip().splitlines()[-5:])
    check(proc.returncode == 0, f"gate: exit {proc.returncode} over {GATE_TIERS}")


def phase_recovery():
    """``recovery_bench`` on this host against the committed card-host
    baseline (same wall slack as the gate)."""
    proc = subprocess.run(
        [sys.executable, "-m", "cruise_control_tpu_torch.executor.recovery_bench", "--device", "cuda"],
        env=dict(os.environ, CC_TPU_GATE_WALL_SLACK=GATE_WALL_SLACK), cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=GATE_TIMEOUT_S,
    )
    lines = proc.stdout.strip().splitlines()
    say("recovery", rc=proc.returncode, result=json.loads(lines[-1]) if lines else None,
        verdict=proc.stderr.strip().splitlines()[-3:])
    check(proc.returncode == 0, f"recovery: exit {proc.returncode}: {proc.stderr.strip()[-500:]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from cruise_control_tpu_torch.ops import _build

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = start = time.monotonic()
    libs = _build.build_all(["segment_sum", "even_assign", "graph_loop"])
    build_s = time.monotonic() - t0
    ptxas = {
        name: [ln for ln in _build.BUILD_LOG.get(name, (path, 0.0, ""))[2].splitlines()
               if "registers" in ln or "smem" in ln]
        for name, path in libs.items()
    }
    say("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        kernel_build_s=build_s, libraries={k: os.path.relpath(v) for k, v in libs.items()},
        ptxas=ptxas)

    walls = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its wall kept under ``name`` for the total line."""
        t = time.monotonic()
        out = fn(*args)
        walls[name] = time.monotonic() - t
        return out

    records = timed("kernels", phase_kernels, dev)
    # the CPU port's batched solve runs beside the card's phases until
    # phase_batched reads it (after the kernels phase, whose CPU references
    # it would slow)
    cpu_child = start_batched_cpu_child()
    try:
        return _phases(dev, start, build_s, timed, walls, cpu_child, records)
    finally:
        if cpu_child.poll() is None:
            cpu_child.kill()
            cpu_child.wait()


def _phases(dev, start, build_s, timed, walls, cpu_child, records) -> int:
    assign_records = timed("assign", phase_assign, dev)
    launches, replayed, config2_graphs, config2_final, config2_res = timed("config2", phase_config2, dev)
    device_loop = timed("device_loop", phase_device_loop, dev)
    p1_launches = timed("path", phase_paths, dev)
    sim_launches = timed("sim", phase_sim, dev, config2_final)
    batched, batched_p1 = timed("batched", phase_batched, dev, cpu_child)
    profile_calls, profile_kernels, loop_ctl = timed("profile", phase_profile, dev)
    small_final = timed("card_vs_cpu", phase_card_vs_cpu, dev)
    timed("sim_card_vs_cpu", phase_sim_card_vs_cpu, dev, small_final)
    traces_launches, count_loop = timed("traces", phase_traces, dev)
    config2_maps = _case(CONFIG2, "cpu")[2]
    controller_launches = timed("controller", phase_controller, dev, config2_final, config2_maps)
    timed("fleet", phase_fleet, dev, config2_final, config2_maps)
    timed("traces_controller_card_vs_cpu", phase_traces_controller_card_vs_cpu, dev, small_final)
    facade_launches, facade_proposals = timed("facade", phase_facade, dev)
    timed("facade_card_vs_cpu", phase_facade_card_vs_cpu, dev)
    detector_launches, threaded_launches = timed("detector", phase_detector, dev)
    timed("detector_card_vs_cpu", phase_detector_card_vs_cpu, dev)
    replay_launches, harness = timed("replay_harnesses", phase_replay_harnesses, dev)
    ingest_launches = timed("ingest", phase_ingest, dev, facade_proposals, harness["controller"]["reaction_p50_s"])
    timed("ingest_card_vs_cpu", phase_ingest_card_vs_cpu, dev)
    api_launches = timed("api", phase_api, dev, facade_proposals)
    timed("api_harnesses", phase_api_harnesses, dev)
    timed("api_card_vs_cpu", phase_api_card_vs_cpu, dev)
    parallel_launches, parallel_collectives = timed("parallel", phase_parallel, dev, config2_final, config2_res)
    timed("parallel_card_vs_cpu", phase_parallel_card_vs_cpu, dev)
    scale_launches = timed("scale", phase_scale, dev)
    timed("gate", phase_gate, dev)
    timed("recovery", phase_recovery)

    kernels = []
    for path in ("segment_sum_f32", "segment_sum_i32"):
        rec = next(r for r in records if r["path"] == path)   # the main path's shape
        sweep = next(r for r in records if r["path"] == path and r["case"].startswith("sweep"))
        at_rollout = [r for r in records if r["path"] == path and r["case"].startswith("rollout")]
        in_ranks = [r for r in records if r["path"] == path and r["case"].startswith(RANK_CASE)]
        kernels.append({
            "name": path, "route": "cuda", "source": KERNEL_SOURCES[path], "replaces": REPLACES[path],
            "kernel_route": rec["route"], "kernel_routes": rec["routes"],
            "launches": launches[path], "host_calls": launches[path] - replayed[path],
            "replayed_calls_derived": replayed[path],
            "kernel_launches": profile_kernels[path], "kernel_launches_host_calls": profile_calls[path],
            "max_abs_err": max(r["max_abs_err"] for r in records if r["path"] == path),
            "ms": rec["device_ms"], "plain_ms": rec["plain_device_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_device_ms"],
            "device_ms": rec["device_ms"], "call_ms": rec["call_ms"], "latency_ms": rec["latency_ms"],
            "plain_call_ms": rec["plain_call_ms"], "library_call_ms": rec["library_call_ms"],
            "shape": rec["case"], "sim_launches": sim_launches[path],
            "batched_launches": batched["calls"][path],
            "traces_launches": traces_launches[path], "controller_launches": controller_launches[path],
            "facade_launches": facade_launches[path], "detector_launches": detector_launches[path],
            "detector_threaded_launches": threaded_launches[path],
            "replay_launches": {run: n[path] for run, n in replay_launches.items()},
            "ingest_launches": ingest_launches[path], "api_launches": api_launches[path],
            "parallel_launches": parallel_launches[path], "parallel_collectives": parallel_collectives,
            "traces_shapes": [{k: r[k] for k in SHAPE_KEYS} for r in at_rollout],
            "lane_shapes": [{k: r[k] for k in SHAPE_KEYS + ("max_abs_err", "per_lane_calls", "per_lane_device_ms",
                                                            "per_lane_call_ms", "per_lane_library_device_ms")}
                            for r in records if r["path"] == path and r["case"].startswith(LANE_CASE)],
            "parallel_shapes": [{k: r[k] for k in SHAPE_KEYS + ("max_abs_err",)} for r in in_ranks],
            "scale_launches": scale_launches[path],
            "scale_shapes": [{k: r[k] for k in SHAPE_KEYS + ("max_abs_err",)} for r in records
                             if r["path"] == path and r["case"].startswith(SCALE_CASE)],
            "ladder_shapes": [{k: r[k] for k in SHAPE_KEYS + ("max_abs_err",)} for r in records
                              if r["path"] == path and r["case"].startswith(LADDER_CASE)],
            "sim_shape": {k: sweep[k] for k in ("case", "device_ms", "call_ms", "latency_ms", "plain_device_ms",
                                                "library_device_ms", "bound_ms", "bound_by", "per_lane_calls",
                                                "per_lane_device_ms", "per_lane_call_ms",
                                                "per_lane_plain_device_ms", "per_lane_library_device_ms")},
        })
    # the loop control: a goal graph is the wrapper's host call, the one-thread
    # control kernels are what the device ran in it; "plain" is the host
    # driver's read of a round's condition, and no PyTorch call computes it
    kernels.append({
        "name": "graph_loop", "route": "cuda", "source": KERNEL_SOURCES["graph_loop"],
        "replaces": REPLACES["graph_loop"],
        "launches": config2_graphs["graph_loop"], "host_calls": config2_graphs["graph_loop"],
        "kernel_launches": config2_graphs["loop_ctl"], "kernel_launches_host_calls": config2_graphs["graph_loop"],
        "kernel_launches_by_layout": config2_graphs["loop_ctl_by_layout"],
        "round_nodes_derived": config2_graphs["round_nodes"],
        "max_abs_err": device_loop["max_abs_err"],
        "ms": loop_ctl["ms"], "plain_ms": device_loop["plain_ms"],
        "bound_ms": LOOP_CTL_BYTES / H100_HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        "goal_ms": device_loop["goal_ms"], "plain_goal_ms": device_loop["plain_goal_ms"],
        "profiled_kernel_launches": loop_ctl["launches"],
        "batched_graph_launches": batched["graphs"]["graph_loop"],
        "batched_kernel_launches": batched["graphs"]["loop_ctl"],
        "batched_kernel_launches_by_layout": batched["graphs"]["loop_ctl_by_layout"],
    })
    # the rollout's time loop: one graph launch a rollout, the one-thread
    # control kernel once to start and once a step (counted on the device);
    # "plain" is the host loop's step-index add, and no PyTorch call computes it
    kernels.append({
        "name": "count_ctl", "route": "cuda", "source": KERNEL_SOURCES["count_ctl"],
        "replaces": REPLACES["count_ctl"],
        "launches": count_loop["launches"], "host_calls": count_loop["host_calls"],
        "kernel_launches": count_loop["launches"], "kernel_launches_host_calls": count_loop["host_calls"],
        "max_abs_err": count_loop["max_abs_err"],
        "ms": count_loop["ms"], "plain_ms": count_loop["plain_ms"],
        "bound_ms": COUNT_CTL_BYTES / H100_HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        "rollout_s": count_loop["rollout_s"], "host_loop_rollout_s": count_loop["host_loop_rollout_s"],
    })
    # one kernel per host call; "plain" is the CPU loop (no PyTorch call computes it)
    rec = assign_records[0]                                    # config #2's shape
    kernels.append({
        "name": "even_assign", "route": "cuda", "source": KERNEL_SOURCES["even_assign"],
        "replaces": REPLACES["even_assign"],
        "launches": p1_launches["even_assign"], "host_calls": p1_launches["even_assign"],
        "kernel_launches": p1_launches["even_assign"],
        "kernel_launches_host_calls": p1_launches["even_assign"],
        "max_abs_err": max(r["max_abs_err"] for r in assign_records),
        "ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        "device_ms": rec["device_ms"], "call_ms": rec["call_ms"], "latency_ms": rec["latency_ms"],
        "us_per_partition": rec["us_per_partition"], "shape": rec["case"],
        "lane_grid": {k: assign_records[-1][k] for k in ("case", "device_ms", "call_ms", "latency_ms", "plain_ms",
                                                          "per_lane_launches_device_ms", "bound_ms", "bound_by")},
        "batched_launches": batched_p1["even_assign"],
        "sim_launches": sim_launches["even_assign"], "traces_launches": traces_launches["even_assign"],
        "controller_launches": controller_launches["even_assign"],
        "facade_launches": facade_launches["even_assign"],
        "detector_launches": detector_launches["even_assign"],
        "detector_threaded_launches": threaded_launches["even_assign"],
        "replay_launches": {run: n["even_assign"] for run, n in replay_launches.items()},
        "ingest_launches": ingest_launches["even_assign"], "api_launches": api_launches["even_assign"],
        "parallel_launches": parallel_launches["even_assign"], "scale_launches": scale_launches["even_assign"],
    })
    say("total", wall_s=time.monotonic() - start, kernel_build_s=build_s, phase_walls_s=walls)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
