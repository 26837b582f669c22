#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (gan_deeplearning4j_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

  1. env      — torch/CUDA versions, the card's name and power limit, the
                TF32 switches (off: f32 parity mode).
  2. build    — nvcc builds every kernel under gan_deeplearning4j_tpu_torch/
                csrc/ for sm_90a (all sources at once).
  3. kernel   — each kernel against its plain torch version on the card,
                at the shapes one DCGAN protocol step at batch 200 gives it
                (the sync-BN pair at a 2-rank step's per-rank shapes, the
                4-D BN at the JAX package's benchmark shapes and at one
                shape whose channels take its streamed branch), then the
                times of that step's launches: kernel, plain version, one
                PyTorch library call where there is one, and the card's
                bound for the same work.  The RmsProp update runs as the
                step runs it, one multi-leaf launch per trained graph
                (dis, gan, classifier); each launch must also give the bits
                of one launch per leaf, of the same leaves' gradients as
                split views of one buffer at an odd offset (the
                data-parallel layout: the scalar path) and of a second
                launch, and beside its device time stands the host's time
                to enqueue the three launches.  A ``plans`` line gives the
                launch plan (cluster size, grid, shared memory, branch) of
                each launch of the two cluster BN kernels and the grids of
                the pair's moments and apply kernels; each kernel must give
                the same bits on two launches, and each is
                timed in turns with its library call (kernel, library,
                library, kernel).  The pair's apply kernel runs as the
                data-parallel step runs it, from the all-reduced sums: its
                mean and var must be the bits of the torch epilogue it
                replaces, for worlds 1-4; both pair kernels must give the
                same bits from an offset view of x (their scalar path) as
                from x.  Beside each kernel's time stands ``floor_ms``: as
                many back-to-back empty launches, timed the same way.  A
                ``kernel_insurance`` line does the same at the insurance
                step's shapes: ``bn_act`` at each of its four BNs (shape,
                activation, gradient, bitwise repeat, time against
                ``F.batch_norm`` in turns, floor and bound), the pair at a
                2-rank insurance step's per-rank shapes ([25, 2] on the
                scalar path) and ``fused_update`` over its three leaf
                tables.  A ``kernel_roadmap_pair`` line does the same for
                the pair at the roadmap families' per-rank shapes at world
                2 ([64, 8192] and [64, 6272], relu): the moments kernel and
                the apply kernel from the sums, against their plain
                versions, the float4 path and the offset view's scalar
                path bit for bit, a bitwise repeat, mean and var the
                epilogue's bits, each timed against ``torch.var_mean`` /
                ``F.batch_norm`` in turns, floor and bound.
  4. main     — the trainer (the cv_main entry) on cuda for 20 protocol
                steps at batch 200, full width, on synthetic MNIST, as
                cv_main runs it on one card: the step captured as a CUDA
                graph, two calls of 10 replays.  The launch counters are
                zeroed just before and read just after (a replay counts
                the launches its capture recorded), and each kernel must
                have run its expected count per step (``fused_update`` once
                per graph update: 3).  Then a 10x10 latent grid from the
                trained generator.
  4b. dl4j    — the main phase's four trained graphs and the insurance
                program's four through DL4J ModelSerializer zips
                (``graph/dl4j_import.py``): each written by
                ``export_dl4j`` with its RmsProp state and read back onto
                the card by ``import_dl4j``; params and updater state
                bitwise, the outputs bitwise the source graph's on a fixed
                batch; each zip's bytes and seconds.
  5. parity   — one protocol step on cuda (kernels) and on the CPU (plain
                versions) from the same state, latents and targets.
  6. graph    — from one start, 20 eager steps against two graphed calls
                of 10 replays, bitwise (losses and the final state), with
                and without the generator EMA; the eager and the graphed
                step timed in turns, the capture's seconds and memory, and
                the copy-back's device time.
  7. dp       — data parallel over torch.distributed, two ranks (one per
                card over NCCL when two cards are attached, else both on
                cuda:0 over gloo), one process each: the sync-BN pair's
                gradient against its plain composition, one 2-rank step
                against one single-process step, then 20 trainer steps at
                global batch 200 with exact per-rank launch counts and the
                ranks' final states bitwise equal, and the time of one
                step's gradient all-reduces alone, then 4 steps of the
                unfused per-fit loop with param_averaging (exact launch
                counts, the ranks' states bitwise equal after the last
                average), then INS_DP_STEPS insurance steps at global
                batch 50 (the pair at [50, 12], [25, 2], [25, 12],
                [25, 100] per rank), each held against the single-process
                step, with exact launch counts, then the supervision
                phase's world-2 telemetry steps and the world-2 rollback
                (reported there); then, in this process,
                one step of a 1-rank NCCL group against the single-process
                step, and under torch.profiler one sync-BN forward per BN
                shape on that group: exactly one moments and one apply
                kernel and nothing but NCCL's work beside them (the old
                composition, profiled beside it, shows what it replaced).
  8. cv_main  — the CV program as a user runs it (``cv_main``: the CSV
                pair written and decoded, 200 steps at batch 200 graphed in
                calls of K = 100, the grid and prediction dumps at 100 and
                200, the four model zips, the evaluation with FID on 2,000
                samples), four times: with the launch counters zeroed just
                before and read just after (a warm-up step and 200 replays'
                worth), the dumps' shapes, the metrics JSONL, the zips read
                back bit for bit as the trained graphs, finite scores,
                ``DCGAN_Generated_Images.png`` decoded to the last grid
                dump's mosaic; then with ``--sync-dumps`` (the dumps
                byte-identical); then with the table streamed in chunks of
                100 steps on the plain chunk tier (``stream_dedup=False``)
                and on the dedup tier (the u8 table once, a row schedule a
                chunk), each run's per-step losses bitwise the resident
                run's, and the bytes each put on the host link.  Host
                seconds of the export,
                decode, upload, capture, each dump, the save and the
                evaluation, and examples/sec, beside the card's name and
                power limit.
  9. insurance — the insurance program as a user runs it
                (``insurance_main`` at its defaults: 5,000 steps at batch
                50 graphed in calls of K = 100, the grid, grid-extras and
                prediction dumps every 100 steps, the four model zips, the
                AUROC), twice: with the launch counters zeroed just before
                and read just after (4 ``bn_act`` and 3 ``fused_update`` a
                step, warm-up included, nothing else), every dump's shape,
                the metrics JSONL, the zips read back bit for bit, a test
                AUROC above 0.5, the three lattice PNGs decoded to the last
                dump's mosaic and first lattice; then with ``--sync-dumps``
                (every dump byte-identical).  Then the program's step graphed against
                eager (bitwise over 20 steps) and the two timed in turns.
 10. resume   — checkpoints, preemption and resume, each check required:
                the insurance program at its defaults in child processes,
                one sent SIGTERM after step 2,000 (exit 75, PREEMPTED.json,
                a verified checkpoint at its step, ``preempt.signal``,
                ``preempt.exit`` and the saves' ``checkpoint.*`` stages
                in its ``events.jsonl`` and the flight record beside it)
                and one resuming it to
                5,000, bitwise the insurance phase's uninterrupted run (the
                four zips' params and updater state, every metrics record,
                test_auroc); the CV program at full width, 100 steps at
                batch 200 with checkpoints every 50, preempted at 50 and
                resumed in this process (bitwise the uninterrupted run,
                with the resumed path's launch counts), and in a child
                process from a copy of that checkpoint (the largest param
                difference and the bound it meets, reported: cuDNN times
                its choices per process); then, under cuDNN's untimed
                deterministic choice in two fresh child processes, a run
                with checkpoints and a resume of its step-50 checkpoint,
                bitwise; the latent generator's state after graph replays
                against eager draws; the insurance step at world 2 over
                gloo on one card, checkpointed at 4 and resumed to 8
                (equal to the uninterrupted world-2 run); one run whose
                first CSV read meets an injected transient OSError (one
                retry); and the cost of a checkpoint (snapshot ms, sync
                and async save seconds, bytes, restore seconds, the
                capture after a resume) for both models.  The world-2 run
                goes beside the insurance children, both beside the CV
                children, and the default-policy CV child beside the first
                untimed one (the script's limit; every check they make is
                bitwise or reported; their seconds and host timings,
                several runs' at once, stand under ``shared_card``).  The
                CV runs read the cv_main phase's CSV pair.
 11. roadmap  — the roadmap families (``roadmap_main``: CelebA-64 DCGAN,
                WGAN-GP and the conditional cgan-cifar10 on the ``GANPair``
                engine, Adam) at full width and batch 128: ``bn_act`` at
                the celeba and wgan-gp generators' gen_bn0 shapes ([128,
                8192] and [128, 6272], relu) against its plain version and
                its gradient, bitwise repeat, timed against
                ``F.batch_norm`` in turns; one iteration of each of the
                three families on the card against the CPU path from the
                same params and draws; RM_K graphed iterations against
                RM_K eager ones, bitwise, with and without the EMA, the
                capture's seconds and pool memory, and the two timed in
                turns; each program as a child process, the three side
                by side, their timings under ``shared_card`` (artifacts,
                result line, and the port kernels' launches around its
                graphed iterations: one ``bn_act`` an iteration for celeba
                and wgan-gp, none of the six for cgan-cifar10, whose child
                also prints its ``conditional_fidelity`` and
                ``mean_class_fid``); celeba's and wgan-gp's ``train``
                in this process with the launch counters zeroed just before
                and read just after; and celeba checkpointed at
                RM_RESUME[1] and resumed in this process, its zips
                byte-equal to the straight run's (RM_RESUME[0]).
 12. pair_dp  — the roadmap families on two ranks (``GANPair`` over a
                group: one per card over NCCL when two cards are attached,
                else both on cuda:0 over gloo), spawned: on each rank the
                pair's gradient against its plain composition at the
                RM_PAIR shapes; per family at full width and global batch
                128, PD_ITERS eager iterations from the seeded params and
                one global draw stream, with the launch counters zeroed
                just before and read just after (per rank: ``bn_moments``
                = ``bn_apply`` = PD_ITERS for celeba and wgan-gp, 0 for
                cgan-cifar10, 0 of the other four), the ranks' states and
                losses bit for bit equal, rank 0's held against the
                single-process pair over the whole batch on the same
                draws (PD_TOL), and PD_TIME_ITERS more iterations timed
                (beside the roadmap phase's one-card graphed and eager
                ms); then ``roadmap_main --family celeba --n-devices 2``
                through its entry point: PD_MAIN[0] iterations with a
                checkpoint, ``--resume`` to PD_MAIN[1] (rank 0's files,
                metrics steps, the checkpoints' 2-rank mesh spec, its
                launches); then, when PIL is installed, ``--data-dir`` on
                PNGs written by the port's PNG writer (the table exactly
                the pixels, graphed iterations with their ``bn_act``
                launches), else a line saying it did not run.
 13. precision — the reference's precision modes (``--bf16``: bf16
                operands into every convolution and GEMM, result rounded
                once; ``--mp``: bf16 params and activations with f32
                master params, BNs and losses), per workload (cv,
                insurance, celeba, wgan-gp, cgan-cifar10) in ``--bf16``
                and ``--mp``, cv and celeba also in both: PR_CALLS graphed
                calls of PR_K replays against as many eager calls from one
                start, bit for bit, with each port kernel's launches (eager
                run and per replay) equal to PR_PER_STEP (``upsample_bwd``
                0 under ``--mp``: its bf16 cotangent takes the plain block
                sum, as in the JAX package) and finite losses; the same in
                parity, whose losses give each mode's drift (max |d| and
                the final step's); one step at learning rates 0 on the card
                against the CPU in the mode, within the mode's own distance
                from parity; each f32-only wrapper refusing bf16; the plain
                bf16 block sum timed at the CV shapes beside the f32
                kernel; and ``roadmap_main --family cgan-cifar10 --mp`` and
                ``cv_main --bf16 --mp`` as child processes, evaluation
                included, side by side (their seconds and rates under
                ``shared_card``).
 14. serve    — the serving plane (``serve/``, ``parallel/inference.py``)
                with the CV generator at full width, buckets (8, 32, 64),
                under cuDNN's untimed choice (so that the replica child
                answers bit for bit what this process answers), each check
                required: the warm-up captures exactly 3 CUDA graphs (their
                seconds, the pool's memory); rows 1-130 against the CPU's
                eager forward of the same params within SERVE_CPU_TOL;
                each bucket's graph bitwise its eager forward; coalesced
                requests against the same requests alone; the JAX bench's
                load (``measure_saturation`` on the size mix, then 5
                stages at 80% of saturation): saturation req/s, p50/p95/
                p99, batch fill, 0 captures after warm-up, the host's ms
                per dispatch cycle by stage, 0 launches of each port
                kernel; a hot swap from the resume phase's CV checkpoint
                (cut to ``gen``) under load, the outputs then bitwise the
                new params' forward; an injected hang (``WatchdogTimeout``
                within the deadline) and raise (``DispatchError``), the
                engine serving after each; each bucket's graphed and eager
                device ms, here and under the default (timed) policy in a
                child; and the replica as a child process (``python -m
                ...serve.replica --port 0 --checkpoint``): its ready line,
                /healthz, the size mix in both encodings bitwise this
                process's engine, 413 / 400 / 404 / 405 / 429 (admission
                shedding) / 408 (a slow body) / 503 (wedged), /admin/
                hotswap, ``run_socket_load`` at 80% of the in-process
                saturation, SIGTERM -> exit 0.
 15. serve_mesh — the serving plane across processes, traced, each check
                required, its seconds beside SM_BUDGET_S: a generator at
                full width from a seed, saved by the port's checkpointer and
                served here through a ``ServeEngine`` behind a ``Gateway``;
                a ``ControlPlane`` spawns two replica processes (``python
                -m ...serve.replica --events``, buckets (8, 32, 64)) from
                that checkpoint, each one's seconds from spawn to its ready
                line recorded; a ``MeshRouter`` over the two sends one
                request to the first, the second is SIGKILLed (before it
                serves anything: a killed process loses its unflushed
                events) and a traced request fails over (the seconds from
                the kill to its answer), the control plane replacing the
                dead replica; SM_REQUESTS traced requests of the size mix
                through a client of each live replica and through the
                control plane's mesh, each held against the same rows
                through this process's engine within SERVE_CPU_TOL; a
                replica wedged through ``/admin/chaos/wedge``, its seconds
                to ejection and to re-admission; a canary deploy of the
                checkpoint promoting and a deploy of its poisoned successor
                rolling back to step 1 and charging the budget; one scrape
                of a ``MetricsRegistry`` fed by the engine's, gateway's,
                client's, mesh's and control plane's reports (the serve and
                gateway series non-zero); the control plane stopped (each
                replica flushes its events on SIGTERM) and the files merged
                with ``merge_trace_files``: every trace tree complete, the
                failover trace over two processes with two ``trace.hop``
                spans, one closing with ``error``, and no port kernel
                launched here or in any replica; then what tracing
                costs, in turns: the engine's wall ms per full batch of
                a queued burst under no recorder, the ring, the ring
                with a trace on every request (as the gateway mints
                one) and a file with traces; and an in-process
                gateway's requests a second, closed loop, under no
                recorder, the ring and a file.
 16. supervision — supervision's numerics and hang half, each check
                required: the CV protocol step at batch 200 with its
                telemetry block (``--telemetry``), captured, 2 calls of
                MAIN_K: losses and state bitwise the same run without the
                block, every column and the state bitwise the eager step
                from the graph's start, the launch counters around the
                graphed calls (3 / 3 / 2 a step), the first step's block
                within SV_TOL of the CPU's from the same start and draws,
                and the graphed step's ms with and without the block in
                turns (on, off, off, on); at world 2 (the dp phase's ranks)
                SV_DP_STEPS eager steps with the block, its launches per
                rank exact and the ranks' blocks equal; then
                ``insurance_main`` streamed on the card three times (400
                steps, K = 10, checkpoints every 50): a NaN in the 131st
                batch under ``--telemetry --nan-alarm rollback`` (the alarm,
                the rollback to the checkpoint before step 131, the
                poisoned checkpoint pruned, the fresh incarnation's capture
                seconds, 400 steps finished), the 16th readback hung under
                ``--watchdog --watchdog-deadline 2 --max-restarts 1``
                (``WatchdogTimeout`` on the training thread, the seconds
                from the hang to the raise, the restart, 400 steps), rows
                x 1e3 from the 151st batch under ``--divergence --nan-alarm
                abort`` (the sentinel trips on the classifier's series, all
                finite; ``DivergenceError``, not restarted); and
                ``cv_main`` healthy at 200 steps, K = 100, with every alarm
                and the auto-deadline watchdog armed: nothing fires, every
                record's block finite, launches exact.  Its
                ``rollback_world2`` is the dp phase's ranks' rollback
                (``rb_world2``): the CV step at global batch 200 on two
                ranks under ``nan_alarm="rollback"``, streamed in f32, a
                checkpoint at step 2, a NaN in the third batch; exactly
                one rollback on each rank to step 2, the same LR scale and
                latent lineage, finite losses after the heal, equal final
                states, the launches per rank exact, and the seconds from
                the rollback's raise to the first healed boundary.
 17. observability — the training run's observability, each check
                required, its seconds beside OBS_BUDGET_S: ``cv_main``
                at full width (200 steps at batch 200) as a child with
                ``--telemetry --profile DIR --metrics-port 0 --live-ui
                PORT``, its
                ``/metrics`` (``gan4j_steps_total`` > 0, the
                ``gan4j_goodput_seconds{phase}`` series), ``/healthz`` and
                the live UI's page and records scraped while it trains and
                closed after; the last metrics record's phases summing to
                its ``wall_s``; ``run_manifest.json`` naming the card; the
                printed summary counting the three port kernels (603 /
                603 / 402: the replays' kernels are traced one by one);
                the Chrome trace merged from ``events.jsonl`` and the
                capture holding the host spans and the kernels inside
                them; beside it, as a second child, ``roadmap_main
                --family celeba`` (2,000 rows, 50 iterations) with
                ``--profile --metrics-port 0`` (one ``bn_act`` an
                iteration in its summary and its ``port_launches``, its
                manifest and goodput); then ``cv_main`` in this process
                in turns (plain, --profile, exporter + live UI, plain),
                each run's ``examples_per_sec`` recorded, the per-step
                losses bitwise across the flags, the launch counters
                around the profiled run; and ``profile_step
                --telemetry``'s split of the telemetry block's cost.  (The
                resume phase's preemption drill must leave
                ``preempt.signal``, ``preempt.exit``, the save's
                ``checkpoint.*`` stages and the flight record.)
 18. migration — early stopping on the card: the DCGAN-MNIST transfer
                classifier at full width under ``EarlyStoppingGraphTrainer``
                over a cut of the cv_main phase's MNIST CSVs (2,000 / 500
                rows, the train split's ``NormalizerMinMaxScaler``, a
                ``ScoreIterationListener``): the reason, the best epoch,
                the restored and the persisted best scores, one
                ``fused_update`` and one ``bn_act`` launch a fit; beside
                it, ``utils/probe.py``'s child on the card (its round
                trip and wall).
 19. fleet    — the insurance fleet (``train/fleet.py``), each check
                required: the tenant-batched ``bn_act`` at the fleet step's
                four BN shapes at batch 16 against its plain version at
                every size of FLEET_SWEEP (every plan the sweep launches:
                1 to 16 tenants a stage, rows split over 1, 2 or 4
                threads, a ring of one or two, a partial last stage), and
                for FLEET_KERNEL_N tenants a bitwise repeat and the
                gradient, timed against ``F.batch_norm`` on the [B, N*F]
                transpose in turns, floor and bound, and at 16 tenants
                beside the [B, F] cluster kernel once a tenant; its
                backward kernel (``bn_act_tenants_bwd``) with non-zero
                cotangents on y, mean and var against its plain version
                and against autograd of the plain forward at every size
                of FLEET_SWEEP, dgamma/dbeta bit for bit without dx, a
                bitwise repeat, the closed form without its gvar term
                outside the tolerance, timed against
                ``aten.native_batch_norm_backward`` in turns; both kernels
                at one odd shape (FLEET_ODD, x off 16 bytes); the graphed
                fleet step (insurance at full width, batch 16) at each size
                of FLEET_SWEEP: FLEET_PER_STEP launches a step at every
                size with the counters zeroed just before and read just
                after, 0 captures after warm-up, step ms, tenants x steps a
                second and the sequential equivalent (N x the single
                insurance step, graphed, in this run); one step at 4
                tenants on the card against the CPU from each of
                FLEET_TOL_SEEDS within FLEET_TOL, and a known fault (the
                tenant BN's variance over B - 1) outside it;
                ``scenario/trainer_child`` at 64 tenants (SIGTERM -> exit
                75 with ``PREEMPTED.json``, ``--resume`` -> exit 0, its
                ``final.json`` bit for bit the uninterrupted run's, the
                uninterrupted run beside the other two); then, alone, a
                ``CheckpointPublisher`` promoting the
                newest fleet checkpoint through a ``ControlPlane`` over one
                ``serve.replica --fleet`` process, rejecting its poisoned
                successor (``poison_fleet_checkpoint_dir``), and requests
                for four tenants held against their slices.
 20. lifecycle — the tenant lifecycle (``train/lifecycle.py``) at the
                reference's width: two cohorts over bucketed capacities,
                one CUDA graph each (cohort, warmed bucket), onboard /
                offboard cycles through ghost slots, a hop to the next
                bucket, an offboard and re-onboard from its checkpoint, and
                the two lifecycle poisoners in a chaos run held against a
                control run (``lifecycle_phase``).
 21. extractors — the three frozen FID extractors' recipes on the card,
                each retrained extractor's held-out score beside the
                committed zip's (``extractors_phase``), run as a child
                beside the precision phase's children (its seconds under
                ``shared_card``); its line is printed after the
                lifecycle's.
 23. elastic — the fleet on a tenant mesh (``parallel/fleet.py``) at the
                scenario's shapes (4 tenants, batch 4): both tenant BN
                kernels against their plain versions with 1, 2 and 4
                tenants a launch (``el_kernels``); the graphed sharded
                step at worlds 1, 2 and 4 sharing the card, one capture a
                shard and none after warm-up, FLEET_PER_STEP launches a
                step a shard, worlds 2 and 4 bitwise world 1 (else within
                FLEET_TOL, the cause named), each world's step ms; a
                world-2 fleet checkpoint restored at 1 and 4 bitwise per
                tenant, with the reshard's seconds; the resume phase's
                world-2 insurance checkpoint restored in this process at
                world 1 through the reshard and stepped to the end, its
                losses within EL_INS_BAND of the world-2 run's
                (``elastic_phase``).
 24. scenario — ``run_scenario`` (``scenario/runner.py``: seed 23, the
                JAX defaults, soak off) on the card in a child started
                before phase 16 and joined after it: the typed verdict
                ok, trainer exits [75, 82, 0], the poisoned checkpoint
                rejected and its direct deploy rolled back, no non-typed
                serving failure, the merged timeline's incarnations,
                replica hosts and chaos events, the band against the
                control; its seconds by stage under ``shared_card``
                (``scenario_phase``).
 22. the ``kernels`` line (each kernel's insurance numbers beside the
     CV step's, where the insurance path runs it, ``bn_act``'s roadmap
     numbers, each kernel's launches on the cgan-cifar10 path: 0, at
     world 2 per roadmap family (``pair_dp``, with the pair's numbers at
     its per-rank shapes), per workload and mode in the precision phase,
     on the serving path: 0, on the mesh over replica processes: 0, on
     the supervision phase's path, one card and world 2, on the
     observability phase's, at world 2 in the rollback's ranks, and on
     the migration surface, on the fleet's step at each size, on the
     lifecycle's cohort steps at each capacity, and on the tenant mesh: a
     step a shard at worlds 1, 2 and 4, the world-1 insurance restore and
     each scenario trainer incarnation), the
     seconds line (the script's total beside
     its total before the precision phase was added and before the serve
     phase in this run, the pair_dp, serve_mesh, supervision and
     observability phases', and every phase line's seconds), the
     nvidia-smi line, and last
     {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is available.
Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

BATCH = 200
MAIN_STEPS = 20
MAIN_K = 10  # steps per call of the main path: two calls
GRAPH_STEPS = 20  # the graph phase's eager run and graphed run
TURN_CALLS = 5  # calls of MAIN_K steps in one timed turn
N_TRAIN = 10000
DP_WORLD = 2
DP_TIMEOUT_S = 300
PA_STEPS = 4  # the dp phase's param_averaging run
# the cv_main phase: the program at its reference cadences, cut to 200 steps
CV_ARGS = ["--n-train", "10000", "--n-test", "2000", "--iterations", "200",
           "--print-every", "100", "--save-every", "100",
           "--fid-samples", "2000"]
CV_STEPS = 200
CV_K = 100
PA_FREQ = 2
# the insurance program (insurance_main) at its reference defaults: 5,000
# steps at batch 50, dumps every 100 steps, K = 100 steps a call
INS_STEPS = 5000
INS_K = 100
INS_BATCH = 50
INS_TURN_K = 10  # steps per call of the insurance phase's timed turns
INS_DP_STEPS = 4  # the dp phase's insurance steps per rank
# the insurance step's 2-D BNs on one card (dis, gan's two, classifier)
# and, at 2 ranks, the sync-BN pair's per-rank shapes
INS_BN = [((100, 12), "elu"), ((50, 2), "tanh"), ((50, 12), "elu"),
          ((50, 100), "elu")]
INS_PAIR = [((50, 12), "elu"), ((25, 2), "tanh"), ((25, 12), "elu"),
            ((25, 100), "elu")]
# the insurance step against another from the same state: STEP_TOL, with
# params held to one generator learning rate of this model (4e-4)
INS_STEP_TOL = {"loss": 1e-4, "param": 4e-4, "cache": 5e-2}
# timed repetitions of a group (30 before the lifecycle and extractors
# phases came; 20 for the script's limit: each costs a ~20 ms sleep)
REPS = 20
# the script's whole run before the precision phase was added (from a
# git archive of that tree, NVIDIA H100 80GB HBM3, 700.00 W)
TOTAL_BEFORE_PRECISION_S = 419.0
T_START = 0.0
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's ~2 GHz clock
# each kernel's CUDA source and the Pallas kernel it replaces
SOURCES = {"fused_update": "fused_update.cu", "bn_act": "bn_act.cu",
           "upsample_bwd": "upsample_bwd.cu",
           "bn_moments": "bn_moments_apply.cu",
           "bn_apply": "bn_moments_apply.cu", "bn_act_4d": "bn_act_4d.cu",
           "bn_act_tenants": "bn_act.cu", "bn_act_tenants_bwd": "bn_act.cu"}
REPLACES = {"fused_update": "ops/pallas/fused_update.py:40",
            "bn_act": "ops/pallas/bn_act.py:56",
            "upsample_bwd": "ops/pallas/dma_pipeline.py:86",
            "bn_moments": "ops/pallas/bn_act.py:71",
            "bn_apply": "ops/pallas/bn_act.py:79",
            "bn_act_4d": "ops/pallas/bn_act.py:180",
            # _fused_kernel under jax.vmap (train/fleet.py make_fleet_step):
            # the batching rule makes the tenant axis a grid axis
            "bn_act_tenants": "ops/pallas/bn_act.py:56",
            # no Pallas kernel: the custom_vjp backward of
            # fused_bn_act_train (_bwd, rematerialized through _reference)
            # under the same vmap
            "bn_act_tenants_bwd": "ops/pallas/bn_act.py:304"}
# f32 peak outside the tensor cores and device-memory bandwidth, by card
# (NVIDIA data sheets, dense rates, full power limit)
PEAK_F32_FLOPS = 67e12
BANDWIDTH = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
             ("H100", 3.35e12))


# seconds of the script by phase line: the time from the line before (the
# script's start for the first) to each line, summed over a phase's lines
PHASE_SECONDS: dict = {}
# the seconds the script spent in ``time_ms``
TIMED_S = [0.0]
_LAST_LINE = [0.0]


def emit(phase: str, **fields) -> None:
    now = time.perf_counter()
    PHASE_SECONDS[phase] = (PHASE_SECONDS.get(phase, 0.0) + now
                            - (_LAST_LINE[0] or T_START))
    _LAST_LINE[0] = now
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bandwidth_for(name: str) -> float:
    for key, bw in BANDWIDTH:
        if key in name:
            return bw
    raise RuntimeError(f"chip_smoke: no memory bandwidth on record for {name!r}")


def time_ms(fn, torch) -> float:
    """Device time of one call of ``fn`` (a whole step's launches of one
    kernel), median over REPS after three warm-ups.  Each repetition first
    parks the stream on a sleep kernel (~20 ms) so the host has enqueued
    the start event, every launch and the end event before the device
    reaches them: the events then time the device's work back to back, not
    the Python wrappers' launch rate.  A repetition whose enqueue took
    longer than half the sleep (a slow host: many small launches) is
    dropped and run again behind a sleep twice as long (up to 16x); more
    than REPS drops fail the run."""
    t_start = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, dropped = [], []
    scale = 1
    for _ in range(2 * REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES * scale)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        enqueue = time.perf_counter() - t0
        end.synchronize()
        if enqueue < 0.01 * scale:
            times.append(start.elapsed_time(end))
        else:
            dropped.append(enqueue)
            scale = min(2 * scale, 16)
        if len(times) == REPS:
            TIMED_S[0] += time.perf_counter() - t_start
            return statistics.median(times)
    raise RuntimeError(
        f"chip_smoke: the host took {max(dropped) * 1e3:.1f} ms to enqueue a "
        f"timed group ({len(dropped)} of {2 * REPS} repetitions over half "
        "their sleep); the sleep no longer covers it")


def in_turns(kernel_fn, library_fn, torch):
    """(kernel ms, library ms, the four times): timed kernel, library,
    library, kernel, so a drift of the card's clock over the run touches
    both; each number is the mean of its two turns."""
    k1 = time_ms(kernel_fn, torch)
    l1 = time_ms(library_fn, torch)
    l2 = time_ms(library_fn, torch)
    k2 = time_ms(kernel_fn, torch)
    return (k1 + k2) / 2, (l1 + l2) / 2, [k1, l1, l2, k2]


def floor_ms(n: int, torch) -> float:
    """What no group of ``n`` launches can beat: ``n`` back-to-back empty
    launches (``torch.cuda._sleep(0)``) timed as ``time_ms`` times a
    kernel's group."""
    return time_ms(lambda: [torch.cuda._sleep(0) for _ in range(n)], torch)


def offset_view(x, torch):
    """A copy of ``x`` that starts 4 bytes past a 16-byte boundary (a
    contiguous view of a larger buffer): the pair kernels' scalar path."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].view_as(x)


def old_epilogue(sums, world, torch):
    """The sync-BN forward's epilogue before the apply kernel took it over
    (``mesh.all_reduce_mean`` after the collective, then ``_BnSync``):
    -> (mean, var)."""
    flat = torch.cat([sums.reshape(-1)])
    flat /= world
    stats = flat.view_as(sums)
    return stats[0].clone(), stats[1] - torch.square(stats[0])


def bitwise_repeat(fn, inputs, torch) -> bool:
    """Two launches on the same inputs give the same bits."""
    return all(torch.equal(a, b) for args in inputs
               for a, b in zip(fn(*args), fn(*args)))


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def within(a, b, atol: float, rtol: float) -> bool:
    return bool(((a.double() - b.double()).abs()
                 <= atol + rtol * b.double().abs()).all())


# one protocol step against another from the same state.  Losses: 1e-4
# relative.  Params and BN statistics: 4e-3 absolute, one generator
# learning rate — RmsProp's update is ~lr*sign(g), and an element whose
# gradient lies near 0 sits on its linear part (slope lr/sqrt(eps) = 40),
# so rounding may move it by up to one lr; a wiring error moves whole
# leaves by lr and shifts the losses.  RmsProp caches (~g^2): 5e-2 of the
# leaf's largest value plus eps (a cache enters the update only as
# cache + eps); a frozen input BN's running-stat gradient sums 200*784
# terms that cancel.
STEP_TOL = {"loss": 1e-4, "param": 4e-3, "cache": 5e-2}


def step_diff(ref, got):
    """(loss relative error, {kind: (worst, where)}) between two
    (state, losses) results of the protocol step."""
    from gan_deeplearning4j_tpu_torch.train.fused_step import state_trees

    (s_ref, l_ref), (s_got, l_got) = ref, got
    loss_err = max(abs(float(a) - float(b)) / max(abs(float(a)), 1e-6)
                   for a, b in zip(l_ref, l_got))
    worst = {"param": (0.0, ""), "cache": (0.0, "")}
    for field, tree in state_trees(s_ref):
        kind = "cache" if field.endswith("_opt") else "param"
        for layer, lp in tree.items():
            for pname, a in lp.items():
                b = getattr(s_got, field)[layer][pname].to(a.device)
                d = max_err(a, b)
                if kind == "cache":
                    d /= float(a.abs().max()) + 1e-8
                if d >= worst[kind][0]:
                    worst[kind] = (d, f"{field}.{layer}.{pname}")
    return loss_err, worst


def require_step_match(what, loss_err, worst, tol=STEP_TOL) -> None:
    require(loss_err <= tol["loss"],
            f"{what}: loss relative error {loss_err} > {tol['loss']}")
    for kind, (d, where) in worst.items():
        require(d <= tol[kind], f"{what}: {where} differs by {d} > {tol[kind]}")


def protocol_step(device, group=None):
    """A fresh DCGAN (seed 666: the same init in every process) and its
    protocol step -> (step, state)."""
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.train import fused_step

    cfg = M.CVConfig()
    d = M.build_discriminator(cfg, device)
    graphs = (d, M.build_generator(cfg, device), M.build_gan(cfg, device),
              M.build_classifier(d, cfg))
    step = fused_step.make_protocol_step(
        *graphs, M.DIS_TO_GAN, M.GAN_TO_GEN, M.DIS_TO_CLASSIFIER,
        z_size=cfg.z_size, num_features=cfg.num_features, group=group)
    return step, fused_step.state_from_graphs(*graphs)


def run_step(step, state, host, device):
    a = {k: v.to(device) for k, v in host.items()}
    return step(state, a["real"], a["labels"], a["y_real"], a["y_fake"],
                a["ones"], z1=a["z1"], z2=a["z2"])


def group_vs_single(group, host):
    """One step with ``group`` against one single-process step on the
    rank's card from the same state, latents and targets."""
    dev = group.device
    got = run_step(*protocol_step(dev, group), host, dev)
    ref = run_step(*protocol_step(dev), host, dev)
    return step_diff(ref, got)


def state_digest(state) -> str:
    """sha256 over every tensor of a step state (a ProtocolState or a
    PairState: the EMA tree included when there is one, updater state of
    any depth, the step counter), path and bytes, in sorted order."""
    from gan_deeplearning4j_tpu_torch.train import fused_step

    h = hashlib.sha256()
    for path, t in sorted(fused_step._leaves(state).items(),
                          key=lambda kv: tuple(map(str, kv[0]))):
        h.update(".".join(map(str, path)).encode())
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def insurance_protocol(device, group=None):
    """A fresh insurance MLP-GAN (seed 666) and its protocol step ->
    (step, state)."""
    from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MI
    from gan_deeplearning4j_tpu_torch.train import fused_step

    cfg = MI.InsuranceConfig()
    d = MI.build_discriminator(cfg, device)
    graphs = (d, MI.build_generator(cfg, device), MI.build_gan(cfg, device),
              MI.build_classifier(d, cfg))
    step = fused_step.make_protocol_step(
        *graphs, MI.DIS_TO_GAN, MI.GAN_TO_GEN, MI.DIS_TO_CLASSIFIER,
        z_size=cfg.z_size, num_features=cfg.num_features, group=group)
    return step, fused_step.state_from_graphs(*graphs)


def insurance_host(torch, steps: int) -> dict:
    """CPU tensors of ``steps`` insurance steps at batch 50: the first two
    batches of the program's training table (``insurance_train.csv``), the
    softened targets and global latents, from fixed seeds."""
    from gan_deeplearning4j_tpu_torch.data import datasets
    from gan_deeplearning4j_tpu_torch.data.csv import RecordReaderDataSetIterator

    d = tempfile.mkdtemp(prefix="gan4j_ins_host_")
    try:
        train_csv, _ = datasets.ensure_insurance_csv(d)
        it = RecordReaderDataSetIterator(train_csv, INS_BATCH, 12, 1)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rng = torch.Generator().manual_seed(8)
    B = INS_BATCH
    return dict(
        real=torch.from_numpy(it.features[:2 * B].copy()),
        labels=torch.from_numpy(it.labels[:2 * B].copy()),
        y_real=1.0 + 0.05 * torch.randn((B, 1), generator=rng),
        y_fake=0.05 * torch.randn((B, 1), generator=rng),
        ones=torch.ones((B, 1)),
        z1=torch.rand((steps, B, 2), generator=rng) * 2 - 1,
        z2=torch.rand((steps, B, 2), generator=rng) * 2 - 1)


def insurance_dp(group, ins) -> dict:
    """INS_DP_STEPS insurance steps on ``group`` (the counters zeroed just
    before and read just after), each held against the single-process step
    on the rank's card from the same state, table, targets and latents."""
    import torch

    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels

    dev = group.device
    a = {k: v.to(dev) for k, v in ins.items()}
    inputs = (a["real"], a["labels"], a["y_real"], a["y_fake"], a["ones"])
    step_g, state_g = insurance_protocol(dev, group)
    step_s, state_s = insurance_protocol(dev)
    outs_g, outs_s = [], []
    kernels.reset_launch_counts()
    for i in range(INS_DP_STEPS):
        state_g, losses = step_g(state_g, *inputs, z1=a["z1"][i], z2=a["z2"][i])
        outs_g.append((state_g, losses))
    torch.cuda.synchronize(dev)
    launches = kernels.launch_counts()
    for i in range(INS_DP_STEPS):
        state_s, losses = step_s(state_s, *inputs, z1=a["z1"][i], z2=a["z2"][i])
        outs_s.append((state_s, losses))
    return {"launches": launches,
            "losses": [[float(v) for v in ls] for _, ls in outs_g],
            "vs_single": [step_diff(s, g) for s, g in zip(outs_s, outs_g)],
            "digest": state_digest(state_g)}


def insurance_kernels(torch, randn, dev, bw: float, sms: int) -> dict:
    """The kernels of the insurance step at its shapes, each against its
    plain version: ``bn_act`` at each single-device BN (shape and
    activation) with its gradient, a bitwise repeat, and its time against
    ``F.batch_norm`` in turns, one launch's floor and its bound; the
    sync-BN pair at a 2-rank step's per-rank shapes (the step's four
    launches of each kernel as one timed group; [25, 2] takes the scalar
    path); ``fused_update`` over the insurance step's three leaf tables.
    Returns the phase's line and the two groups' rows for the kernels
    line."""
    from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MI
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import (
        bn_act_plain,
        bn_apply_sums_plain,
        bn_moments_plain,
    )
    from gan_deeplearning4j_tpu_torch.ops.cuda.fused_update import (
        rmsprop_chain_plain,
    )

    torch_f = torch.nn.functional

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / bw * 1e3, flops / PEAK_F32_FLOPS * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    # bn_act, shape by shape
    rows, err = [], 0.0
    bn_in = [((randn(b, f, scale=0.5, shift=0.2), randn(f, scale=0.1, shift=1.0),
               randn(f, scale=0.1)), act) for (b, f), act in INS_BN]
    for (x, gm, bt), act in bn_in:
        b, f = x.shape
        yk, mk, vk = kernels.fused_bn_act_train(x, gm, bt, 1e-5, act)
        yp, mp, vp = bn_act_plain(x, gm, bt, 1e-5, act)
        require(within(yk, yp, 1e-5, 1e-4) and within(mk, mp, 1e-6, 1e-4)
                and within(vk, vp, 1e-6, 1e-4),
                f"bn_act disagrees with its plain version at [{b},{f}] {act}")
        e = max(max_err(yk, yp), max_err(mk, mp), max_err(vk, vp))
        err = max(err, e)
        require(bitwise_repeat(lambda *t: kernels.fused_bn_act_train(
            *t, 1e-5, act), [(x, gm, bt)], torch),
            f"bn_act: two launches differ at [{b},{f}]")
        leaves = [t.clone().requires_grad_(True) for t in (x, gm, bt)]
        gy = randn(b, f)
        gk = torch.autograd.grad(kernels.fused_bn_act_train(
            *leaves, 1e-5, act)[0], leaves, gy)
        gp = torch.autograd.grad(bn_act_plain(*leaves, 1e-5, act)[0], leaves, gy)
        require(all(within(u, v, 1e-4, 1e-3) for u, v in zip(gk, gp)),
                f"bn_act gradient disagrees at [{b},{f}] {act}")
        ms, library_ms, turns = in_turns(
            lambda: kernels.fused_bn_act_train(x, gm, bt, 1e-5, act),
            lambda: torch_f.batch_norm(x, None, None, gm, bt, training=True,
                                       eps=1e-5), torch)
        bound_ms, bound_by = bound(8 * b * f + 16 * f, 10 * b * f)
        rows.append(dict(shape=[b, f], act=act,
                         plan=bn2d.launch_plan(b, f, sms)._asdict(),
                         max_abs_err=e, ms=ms, library_ms=library_ms,
                         turns_ms=turns, floor_ms=floor_ms(1, torch),
                         bound_ms=bound_ms, bound_by=bound_by,
                         kernel_slower_than_library=ms > library_ms))
    xs = [t for t, _ in bn_in]
    group = dict(
        calls=[f"[{b},{f}] {act}" for (b, f), act in INS_BN], max_abs_err=err,
        ms=time_ms(lambda: [kernels.fused_bn_act_train(*t, 1e-5, act)
                            for t, act in bn_in], torch),
        plain_ms=time_ms(lambda: [bn_act_plain(*t, 1e-5, act)
                                  for t, act in bn_in], torch),
        library_ms=time_ms(lambda: [torch_f.batch_norm(
            x, None, None, gm, bt, training=True, eps=1e-5)
            for x, gm, bt in xs], torch),
        floor_ms=floor_ms(len(bn_in), torch))
    group["bound_ms"], group["bound_by"] = bound(
        sum(8 * b * f + 16 * f for (b, f), _ in INS_BN),
        sum(10 * b * f for (b, f), _ in INS_BN))
    out = {"bn_act": rows}
    groups = {"bn_act": group}

    # the sync-BN pair from the sums of 2 ranks (sums made from this
    # input's moments times two, plus noise)
    pair_in = [((randn(b, f, scale=0.5, shift=0.2),
                 randn(f, scale=0.1, shift=1.0), randn(f, scale=0.1)), act)
               for (b, f), act in INS_PAIR]
    pairs = []
    err_m = err_a = 0.0
    for (x, gm, bt), act in pair_in:
        b, f = x.shape
        for u, v in zip(kernels.bn_moments(x), bn_moments_plain(x)):
            require(within(u, v, 1e-6, 1e-4),
                    f"bn_moments disagrees with its plain version at [{b},{f}]")
            err_m = max(err_m, max_err(u, v))
        mean, m2 = bn_moments_plain(x)
        noise = randn(2, f, scale=1e-3)
        sums = torch.stack([mean, m2]) * DP_WORLD + noise * noise
        yk, mk, vk = kernels.bn_apply_sums(x, sums, DP_WORLD, gm, bt, 1e-5, act)
        yp, mp, vp = bn_apply_sums_plain(x, sums, DP_WORLD, gm, bt, 1e-5, act)
        require(within(yk, yp, 1e-5, 1e-4) and torch.equal(mk, mp)
                and torch.equal(vk, vp),
                f"bn_apply (from sums) disagrees at [{b},{f}] {act}")
        err_a = max(err_a, max_err(yk, yp))
        xo = offset_view(x, torch)
        require(all(torch.equal(u, v) for u, v in zip(
            kernels.bn_moments(x), kernels.bn_moments(xo))) and all(
            torch.equal(u, v) for u, v in zip(
                kernels.bn_apply_sums(x, sums, DP_WORLD, gm, bt, 1e-5, act),
                kernels.bn_apply_sums(xo, sums, DP_WORLD, gm, bt, 1e-5, act))),
            f"the pair's scalar path (offset view) gives other bits at [{b},{f}]")
        pairs.append((x, sums, gm, bt, act))
    require(bitwise_repeat(kernels.bn_moments, [(p[0],) for p in pairs], torch)
            and bitwise_repeat(lambda x, s_, g, b_, a: kernels.bn_apply_sums(
                x, s_, DP_WORLD, g, b_, 1e-5, a), pairs, torch),
            "the pair: two launches differ at an insurance shape")
    epilogues = [old_epilogue(p[1], DP_WORLD, torch) for p in pairs]
    m_ms, m_lib, m_turns = in_turns(
        lambda: [kernels.bn_moments(p[0]) for p in pairs],
        lambda: [torch.var_mean(p[0], dim=0, unbiased=False) for p in pairs],
        torch)
    a_ms, a_lib, a_turns = in_turns(
        lambda: [kernels.bn_apply_sums(x, s_, DP_WORLD, g, b_, 1e-5, a)
                 for x, s_, g, b_, a in pairs],
        lambda: [torch_f.batch_norm(p[0], m, v, p[2], p[3], training=False,
                                    eps=1e-5)
                 for p, (m, v) in zip(pairs, epilogues)], torch)
    shapes = [(b, f) for (b, f), _ in INS_PAIR]
    groups["bn_moments"] = dict(
        calls=[f"[{b},{f}]" for b, f in shapes], max_abs_err=err_m, ms=m_ms,
        library_ms=m_lib, turns_ms=m_turns,
        plain_ms=time_ms(lambda: [bn_moments_plain(p[0]) for p in pairs], torch),
        floor_ms=floor_ms(len(pairs), torch),
        plans=[bn2d.moments_plan(b, f)._asdict() for b, f in shapes])
    groups["bn_moments"]["bound_ms"], groups["bn_moments"]["bound_by"] = bound(
        sum(4 * b * f + 8 * f for b, f in shapes), sum(3 * b * f for b, f in shapes))
    groups["bn_apply"] = dict(
        calls=[f"[{b},{f}] {a}, from the sums of {DP_WORLD} ranks"
               for (b, f), a in INS_PAIR], max_abs_err=err_a, ms=a_ms,
        library_ms=a_lib, turns_ms=a_turns,
        plain_ms=time_ms(lambda: [bn_apply_sums_plain(x, s_, DP_WORLD, g, b_,
                                                      1e-5, a)
                                  for x, s_, g, b_, a in pairs], torch),
        floor_ms=floor_ms(len(pairs), torch),
        plans=[bn2d.apply_plan(b, f, sms)._asdict() for b, f in shapes])
    groups["bn_apply"]["bound_ms"], groups["bn_apply"]["bound_by"] = bound(
        sum(8 * b * f + 24 * f for b, f in shapes),
        sum(10 * b * f + 5 * f for b, f in shapes))

    # fused_update over the three leaf tables, each leaf with its rates
    cfg = MI.InsuranceConfig()
    dis = MI.build_discriminator(cfg, dev)
    updates, n_elems, err = [], 0, 0.0
    for g in (dis, MI.build_gan(cfg, dev), MI.build_classifier(dis, cfg)):
        keys = [(layer, n) for layer, lp in g.params.items() for n in lp]
        shp = [g.params[layer][n].shape for layer, n in keys]
        updates.append(dict(
            ps=[randn(*t, scale=0.05) for t in shp],
            gs=[randn(*t, scale=0.02) for t in shp],
            cs=[randn(*t, scale=1e-3).abs() for t in shp],
            rates=[g.updater.rates(layer, n) for layer, n in keys],
            clip=g.updater.clip_threshold))
        n_elems += sum(math.prod(t) for t in shp)

    def chains(u):
        return kernels.fused_rmsprop_chains(u["ps"], u["gs"], u["cs"],
                                            u["rates"], clip=u["clip"])

    def chains_plain(u):
        return [rmsprop_chain_plain(p, g, c, **r._asdict(), clip=u["clip"])
                for p, g, c, r in zip(u["ps"], u["gs"], u["cs"], u["rates"])]

    for u in updates:
        pk, ck = chains(u)
        for (pp, cp), a_, b_ in zip(chains_plain(u), pk, ck):
            require(within(a_, pp, 1e-6, 1e-5) and within(b_, cp, 1e-12, 1e-5),
                    "fused_update disagrees with its plain version on an "
                    f"insurance leaf {tuple(pp.shape)}")
            err = max(err, max_err(a_, pp), max_err(b_, cp))
        pk2, ck2 = chains(u)
        require(all(torch.equal(a_, b_) for a_, b_ in zip(pk + ck, pk2 + ck2)),
                "fused_update: two launches differ on an insurance table")
    groups["fused_update"] = dict(
        calls=[f"{len(u['ps'])} leaves" for u in updates], max_abs_err=err,
        ms=time_ms(lambda: [chains(u) for u in updates], torch),
        plain_ms=time_ms(lambda: [chains_plain(u) for u in updates], torch),
        library_ms=None, floor_ms=floor_ms(len(updates), torch))
    groups["fused_update"]["bound_ms"], groups["fused_update"]["bound_by"] = \
        bound(20 * n_elems, 12 * n_elems)
    out["groups"] = groups
    return out


def dump_summary(host_seconds: dict) -> dict:
    """``host_seconds`` with its per-dump records summed by kind (a long
    run's hundreds of records do not fit on one line)."""
    out = {k: v for k, v in host_seconds.items() if k != "dumps"}
    by_kind = {}
    for rec in host_seconds.get("dumps", []):
        agg = by_kind.setdefault(rec["kind"], {"n": 0})
        agg["n"] += 1
        for k in ("enqueue_s", "readback_s", "write_s"):
            agg[k] = agg.get(k, 0.0) + rec.get(k, 0.0)
    out["dumps_summed"] = by_kind
    return out


def insurance_phase(torch, smi: str, keep: str) -> dict:
    """The insurance program as a user runs it (``insurance_main`` at its
    reference defaults: 5,000 steps at batch 50, the grid, grid-extras and
    prediction dumps every 100 steps, K = 100 steps a call), twice in
    temporary res-paths: as given (the launch counters zeroed just before
    and read just after; the dumps' shapes, the metrics JSONL, the zips
    read back bit for bit, the scores) and with ``--sync-dumps`` (every
    dump byte-identical); then, on one trainer of the program, 2 x
    INS_TURN_K eager steps against two graphed calls (bitwise) and the
    eager and the graphed step timed in turns.  The first run's CSV pair,
    four model zips and metrics JSONL are copied to ``keep`` (the resume
    phase's uninterrupted run).  Returns the phase's line."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.eval import plots
    from gan_deeplearning4j_tpu_torch.graph import serialization
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.train import fused_step, insurance_main
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    def read_csv(path):
        return np.loadtxt(path, delimiter=",", ndmin=2)

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gan4j_ins_")
    try:
        dirs = {k: f"{root}/{k}" for k in ("async", "sync", "turns")}
        out = io.StringIO()  # the program's 5,000 step lines, counted
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            trainer, res = insurance_main.run(insurance_main.parse_args(
                ["--res-path", dirs["async"]]))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        step_lines = sum(ln.startswith("step ")
                         for ln in out.getvalue().splitlines())
        seconds_async = time.perf_counter() - t0
        # one warm-up step before the capture, then a replay per step; the
        # dumps and the evaluation run inference forwards only
        calls = INS_STEPS + 1
        expected = {"fused_update": 3 * calls, "bn_act": 4 * calls,
                    "upsample_bwd": 0, "bn_moments": 0, "bn_apply": 0,
                    "bn_act_4d": 0, "bn_act_tenants": 0,
                "bn_act_tenants_bwd": 0}
        require(launches == expected,
                f"insurance: launch counts {launches} != expected {expected}")
        require(res["steps"] == INS_STEPS and res["graphed"]
                and res["steps_per_call"] == INS_K and res["resident"]
                and step_lines == INS_STEPS,
                f"insurance: {step_lines} step lines, {res}")
        d = dirs["async"]
        ks = range(100, INS_STEPS + 1, 100)
        dumps = {f"insurance_out_{k}.csv": (2500, 12) for k in ks}
        dumps.update({f"insurance_out_pred_{k}.csv": (2500, 1) for k in ks})
        dumps.update({f"insurance_test_predictions_{k}.csv": (300, 1)
                      for k in ks})
        for f, shape in dumps.items():
            a = read_csv(f"{d}/{f}")
            require(a.shape == shape and bool(np.isfinite(a).all()),
                    f"insurance: {f} is {a.shape}, not {shape}, or not finite")
        recs = step_records(f"{d}/insurance_metrics.jsonl")
        require([r["step"] for r in recs] == list(range(1, INS_STEPS + 1)),
                "insurance: the metrics JSONL does not hold one record a step")
        require(os.path.getsize(f"{d}/evaluation_stats.txt") > 0,
                "insurance: no evaluation_stats.txt")
        # the loss curves' PNG (utils/plot_metrics.py: the stdlib raster
        # where matplotlib is absent, as on the card's host)
        with open(f"{d}/insurance_metrics_losses.png", "rb") as f:
            require(f.read(8) == b"\x89PNG\r\n\x1a\n",
                    "insurance: no loss-curve PNG")
        # the reference's three lattice PNGs (eval/plots.py, no
        # matplotlib): the last grid dump's mosaic and its first lattice
        grid = read_csv(f"{d}/insurance_out_{INS_STEPS}.csv")
        raw, plotted = plots.lattice_images(grid, (4, 3))
        pngs = check_pngs(d, [
            ("DCGAN_Generated_Lattices.png", plots.grid_image(grid, (4, 3))),
            ("DCGAN_Generated_Lattice_Example.png", raw),
            ("DCGAN_Generated_Lattice_Example_Plotted.png", plotted)])
        for g, path in trainer.model_paths().items():
            back = serialization.read_model(path, trainer.device)
            live = getattr(trainer, g)
            require(back.params.keys() == live.params.keys()
                    and all(torch.equal(back.params[ly][n], t)
                            for ly, lp in live.params.items()
                            for n, t in lp.items()),
                    f"insurance: {path} does not read back as the trained "
                    f"{g} graph")
        require(isinstance(res.get("test_auroc"), float)
                and math.isfinite(res["test_auroc"]) and res["test_auroc"] > 0.5
                and math.isfinite(res.get("test_f1", float("nan"))),
                f"insurance: test_auroc {res.get('test_auroc')}, test_f1 "
                f"{res.get('test_f1')}")
        del trainer
        os.makedirs(keep, exist_ok=True)
        for f in ["insurance_train.csv", "insurance_test.csv",
                  "insurance_metrics.jsonl",
                  *(f"insurance_{g}_model.zip"
                    for g in ("dis", "gan", "gen", "insurance"))]:
            shutil.copy(f"{d}/{f}", f"{keep}/{f}")

        for k in ("sync", "turns"):
            os.makedirs(dirs[k])
            for f in ("insurance_train.csv", "insurance_test.csv"):
                shutil.copy(f"{d}/{f}", f"{dirs[k]}/{f}")
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            _, res_sync = insurance_main.run(insurance_main.parse_args(
                ["--res-path", dirs["sync"], "--sync-dumps"]))
        seconds_sync = time.perf_counter() - t1
        for f in dumps:
            require(open(f"{d}/{f}", "rb").read()
                    == open(f"{dirs['sync']}/{f}", "rb").read(),
                    f"insurance: {f} differs between async and --sync-dumps")

        # the program's step, graphed against eager, on one trainer
        trainer = GANTrainer(
            device=res["device"], workload=insurance_main.InsuranceWorkload(),
            config=insurance_main.default_config(
                res_path=dirs["turns"], num_iterations=0, print_every=0,
                save_every=0, metrics=False, steps_per_call=INS_TURN_K))
        graphed = trainer.graphed
        z_gen = torch.Generator(device=trainer.device)
        z_gen.set_state(trainer.z_gen.get_state())
        box = {"state": fused_step.clone_state(graphed.state)}
        step = trainer.step_fn(INS_TURN_K)
        inputs = (trainer.features, trainer.labels, trainer.y_real,
                  trainer.y_fake, trainer.ones)

        def eager():
            box["state"], losses = step(box["state"], *inputs, z_gen=z_gen)
            return torch.stack(losses, -1).cpu()

        def replays():
            return graphed(INS_TURN_K)

        le = torch.cat([eager() for _ in range(2)])
        lg = torch.cat([replays() for _ in range(2)])
        require(torch.equal(le, lg)
                and state_digest(box["state"]) == state_digest(graphed.state),
                "insurance: the graphed step's bits differ from the eager "
                f"step's (losses max |d| {max_err(le, lg)})")
        # what a checkpoint saves of the latent generator: its state after
        # the replays of a graph it is registered with must be the eager
        # generator's after as many steps
        z_eager, z_graphed = z_gen.get_state(), trainer.z_gen.get_state()
        require(torch.equal(z_eager, z_graphed),
                "insurance: the graph-registered generator's state "
                f"{z_graphed.tolist()} after {2 * INS_TURN_K} replays is not "
                f"the eager generator's {z_eager.tolist()}")

        def turn(fn):
            times = []
            for _ in range(TURN_CALLS):
                t2 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t2)
            return statistics.median(times) / INS_TURN_K * 1e3

        turns = [turn(eager), turn(replays), turn(replays), turn(eager)]
        launches_per_replay = graphed.launches
        del trainer, graphed, box
    finally:
        shutil.rmtree(root, ignore_errors=True)
    eager_ms, graphed_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    return dict(
        seconds=time.perf_counter() - t0, seconds_as_given=seconds_async,
        seconds_sync_dumps=seconds_sync, steps=res["steps"], batch=INS_BATCH,
        steps_per_call=res["steps_per_call"], launches=launches,
        expected_launches=expected, launches_per_replay=launches_per_replay,
        examples_per_sec=res["examples_per_sec"],
        examples_per_sec_sync_dumps=res_sync["examples_per_sec"],
        step_ms_median=res["step_ms_median"],
        turns_ms=turns, eager_ms=eager_ms, graphed_ms=graphed_ms,
        eager_examples_per_s=INS_BATCH / eager_ms * 1e3,
        graphed_examples_per_s=INS_BATCH / graphed_ms * 1e3,
        graphed_bitwise_eager=True, z_gen_state_after_replays_is_eager=True,
        z_gen_state=z_graphed.tolist(), losses=[
            res[k] for k in ("d_loss", "g_loss", "clf_loss")],
        test_auroc=res["test_auroc"], test_f1=res["test_f1"],
        test_auroc_sync_dumps=res_sync["test_auroc"],
        host_seconds=dump_summary(res["host_seconds"]),
        host_seconds_sync=dump_summary(res_sync["host_seconds"]),
        dumps_checked=len(dumps), sync_dumps_byte_identical=True,
        pngs=pngs, nvidia_smi=smi)


def graph_phase(cfg, torch):
    """The graphed step against the eager step on one card, at batch 200
    and full width, without and with the EMA: from one start, GRAPH_STEPS
    eager steps (calls of MAIN_K) against GRAPH_STEPS // MAIN_K graphed
    calls of MAIN_K replays must give the same losses and the same final
    state, bit for bit.  Without the EMA, also: the eager and the graphed
    step timed in turns (E G G E, each turn TURN_CALLS calls, a call ending
    in its readback) and the copy-back's device time.  (What each cuDNN
    algorithm policy costs and whether it keeps the bits: ``python -m
    gan_deeplearning4j_tpu_torch.train.cudnn_ab``.)"""
    from gan_deeplearning4j_tpu_torch.train import fused_step
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    out = {}
    for ema in (0.0, 0.999):
        trainer = GANTrainer(cfg, batch_size=BATCH, n_train=N_TRAIN,
                             device="cuda", steps_per_call=MAIN_K,
                             ema_decay=ema)
        graphed = trainer.graphed
        # the eager run from the graph's start: a copy of the static state,
        # and a generator at the state the graph's generator starts from
        z_gen = torch.Generator(device=trainer.device)
        z_gen.set_state(trainer.z_gen.get_state())
        box = {"state": fused_step.clone_state(graphed.state)}
        step = trainer.step_fn(MAIN_K)
        inputs = (trainer.features, trainer.labels, trainer.y_real,
                  trainer.y_fake, trainer.ones)

        def eager():
            box["state"], losses = step(box["state"], *inputs, z_gen=z_gen)
            return torch.stack(losses, -1).cpu()

        def replays():
            return graphed(MAIN_K)

        calls = GRAPH_STEPS // MAIN_K
        le = torch.cat([eager() for _ in range(calls)])
        lg = torch.cat([replays() for _ in range(calls)])
        res = dict(steps=GRAPH_STEPS, steps_per_call=MAIN_K,
                   losses_bitwise=torch.equal(le, lg),
                   loss_max_abs_diff=max_err(le, lg),
                   digest_eager=state_digest(box["state"]),
                   digest_graphed=state_digest(graphed.state),
                   setup=graphed.setup, launches_per_replay=graphed.launches)
        if not ema:
            def turn(fn):
                times = []
                for _ in range(TURN_CALLS):
                    t0 = time.perf_counter()
                    fn()
                    times.append(time.perf_counter() - t0)
                return statistics.median(times) / MAIN_K * 1e3

            turns = [turn(eager), turn(replays), turn(replays), turn(eager)]
            res["turns_ms"] = turns
            res["eager_ms"] = (turns[0] + turns[3]) / 2
            res["graphed_ms"] = (turns[1] + turns[2]) / 2
            res["eager_img_per_s"] = BATCH / res["eager_ms"] * 1e3
            res["graphed_img_per_s"] = BATCH / res["graphed_ms"] * 1e3
            # the copy of a new state into the static one, as the graph ends
            a = fused_step.clone_state(graphed.state)
            b = fused_step.clone_state(graphed.state)
            res["copy_back_ms"] = time_ms(lambda: fused_step.copy_state_(a, b),
                                          torch)
            res["copy_back_bytes"] = 2 * sum(
                t.numel() * t.element_size() for _, tree in
                fused_step.state_trees(a) for lp in tree.values()
                for t in lp.values())
            del a, b
        out["ema" if ema else "plain"] = res
        del trainer, graphed, box
        torch.cuda.empty_cache()
    return out


def dp_rank(group, host, ins, rb_root):
    """One rank of the dp phase (a spawned process); ``rb_root``: the
    world-2 rollback's res-path, one for both ranks."""
    import torch

    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import bn_act_plain
    from gan_deeplearning4j_tpu_torch.parallel import mesh
    from gan_deeplearning4j_tpu_torch.train import fused_step
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    dev = group.device
    out = {"rank": group.rank, "device": str(dev),
           "device_name": torch.cuda.get_device_name(dev),
           "backend": group.backend}
    # the sync-BN pair's autograd.Function against autograd through the
    # plain composition (with the differentiable all-reduce), on this
    # rank's rows of one global batch per BN shape of the step
    gen = torch.Generator(device=dev).manual_seed(20261017)
    Bl = BATCH // group.world
    rows = slice(group.rank * Bl, (group.rank + 1) * Bl)
    pair_err = 0.0
    for F in (2, 7 * 7 * 128, 1024):
        x = torch.randn((BATCH, F), generator=gen, device=dev)[rows] * 0.5
        gm = torch.randn(F, generator=gen, device=dev) * 0.1 + 1.0
        bt = torch.randn(F, generator=gen, device=dev) * 0.1
        gy = torch.randn((BATCH, F), generator=gen, device=dev)[rows]
        res = []
        for fn in (kernels.fused_bn_act_train, bn_act_plain):
            leaves = [t.clone().requires_grad_(True) for t in (x, gm, bt)]
            y, mean, var = fn(*leaves, 1e-5, "tanh", group)
            res.append((y, mean, var,
                        *torch.autograd.grad(y, leaves, gy)))
        for a, b, (atol, rtol) in zip(
                *res, [(1e-5, 1e-4), (1e-6, 1e-4), (1e-6, 1e-4)]
                + [(1e-4, 1e-3)] * 3):
            require(within(a.detach(), b.detach(), atol, rtol),
                    f"dp rank {group.rank}: the sync-BN pair disagrees with "
                    f"its plain composition at [{Bl},{F}]")
            pair_err = max(pair_err, max_err(a.detach(), b.detach()))
    out["pair_max_abs_err"] = pair_err
    # one 2-rank step against one single-process step
    out["step_vs_single"] = group_vs_single(group, host)
    # the main path, data parallel: counts zeroed just before, read after
    trainer = GANTrainer(M.CVConfig(), batch_size=BATCH, n_train=N_TRAIN,
                         group=group)
    kernels.reset_launch_counts()
    result = trainer.train(MAIN_STEPS, log=None)
    torch.cuda.synchronize(dev)
    out["launches"] = kernels.launch_counts()
    out["result"] = result
    trained = (trainer.dis, trainer.gan, trainer.classifier)
    out["rmsprop_leaves"] = sum(len(lp) for g in trained
                                for lp in g.opt_state.values())
    out["digest"] = state_digest(trainer.state)
    # a step's gradient collectives alone (one all-reduce per trained
    # graph, of a tree the size of its params), host clock to completion
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        for g in trained:
            mesh.all_reduce_mean(g.params, group)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    out["grad_allreduce_ms"] = statistics.median(times[1:]) * 1e3
    # the unfused per-fit loop, param_averaging: local steps (BN on the
    # rank's rows), params and updater state averaged after every fit
    pa = GANTrainer(M.CVConfig(), batch_size=BATCH, n_train=N_TRAIN,
                    group=group, fused=False, dp_mode="param_averaging",
                    averaging_frequency=PA_FREQ)
    kernels.reset_launch_counts()
    out["pa_result"] = pa.train(PA_STEPS, log=None)
    torch.cuda.synchronize(dev)
    out["pa_launches"] = kernels.launch_counts()
    out["pa_digest"] = state_digest(fused_step.state_from_graphs(
        pa.dis, pa.gen, pa.gan, pa.classifier, start_step=pa.steps))
    del pa, trainer
    out["insurance"] = insurance_dp(group, ins)
    out["supervision"] = sv_world2(group)
    out["rollback"] = rb_world2(group, rb_root)
    return out


def sync_bn_profile(group, torch):
    """One ``_BnSync`` forward per BN shape of a 2-rank step on ``group``
    under torch.profiler, and the same for the composition it replaced
    (moments kernel, ``all_reduce_mean``, clone, square, subtract, apply
    kernel) -> {"new": ..., "old": ...}: device activities per forward,
    their device time (ms, all three forwards) and their names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
    from gan_deeplearning4j_tpu_torch.parallel import mesh

    dev = group.device
    gen = torch.Generator(device=dev).manual_seed(20261018)
    inputs = [(torch.randn((BATCH // DP_WORLD, f), generator=gen, device=dev),
               torch.randn(f, generator=gen, device=dev) * 0.1 + 1.0,
               torch.randn(f, generator=gen, device=dev) * 0.1)
              for f in (2, 7 * 7 * 128, 1024)]

    def new(x, gm, bt):
        return bn2d._BnSync.apply(x, gm, bt, 1e-5, "tanh", group)

    def old(x, gm, bt):
        stats = mesh.all_reduce_mean(bn2d._moments_launch(x), group)
        mean = stats[0].clone()
        var = stats[1] - torch.square(stats[0])
        return bn2d._apply_launch(x, mean, var, gm, bt, 1e-5, "tanh"), mean, var

    outs = {}
    for label, fn in (("new", new), ("old", old)):
        for a in inputs:  # warm-up: the collective's first call sets it up
            fn(*a)
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = [fn(*a) for a in inputs]
            torch.cuda.synchronize(dev)
        acts = [(e.name, e.time_range.end - e.time_range.start)
                for e in prof.events() if e.device_type == DeviceType.CUDA]
        kinds = {"bn_moments": 0, "bn_apply": 0, "nccl": 0, "other": 0}
        for n, _ in acts:
            kinds["bn_moments" if "bn_moments_kernel" in n else
                  "bn_apply" if "bn_apply_kernel" in n else
                  "nccl" if "nccl" in n.lower() else "other"] += 1
        outs[label] = dict(
            per_forward=len(acts) / len(inputs), kinds=kinds,
            device_ms=sum(us for _, us in acts) / 1e3,
            names=sorted({n[:100] for n, _ in acts}), results=res)
    for (y, m, v), (yo, mo, vo) in zip(outs["new"].pop("results"),
                                       outs["old"].pop("results")):
        require(torch.equal(m, mo) and torch.equal(v, vo)
                and within(y, yo, 1e-6, 1e-5),
                "sync-BN forward: the new pair differs from the old "
                "composition on a 1-rank group")
    return outs


def check_pngs(res: str, pngs) -> dict:
    """Each (file, the image its dump gives) decodes (``read_png``: its
    chunks' CRCs and filter-0 rows checked) to that image; -> the decoded
    shapes by file."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.eval import plots

    out = {}
    for name, want in pngs:
        img = plots.read_png(os.path.join(res, name))
        require(img.shape == want.shape and bool(np.array_equal(img, want)),
                f"{name} does not show the run's dump")
        out[name] = list(img.shape)
    return out


def cv_main_phase(torch, smi: str, keep_csv: str) -> dict:
    """The CV program as a user runs it (``cv_main``), on the card, four
    times in temporary res-paths: as given (the launch counters zeroed just
    before and read just after; artifacts, model zips read back, scores,
    ``DCGAN_Generated_Images.png`` decoded against the last grid dump's
    mosaic), with ``--sync-dumps`` (the dumps byte-identical), with the
    table streamed in chunks of K = 100 steps on the plain chunk tier
    (``data_on_device=False``, ``stream_dedup=False``: 50 batches a pass
    would let the dedup tier engage) and on the dedup tier (``stream_dedup``
    auto: the u8 table crosses once, each chunk its row schedule); both
    streamed runs' per-step losses bitwise the resident run's.  The run's
    MNIST CSV pair is kept in ``keep_csv`` (the migration phase's early
    stopping reads a cut of it).  Returns the phase's line."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.eval import plots
    from gan_deeplearning4j_tpu_torch.graph import serialization
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.train import cv_main

    def read_csv(path):
        return np.loadtxt(path, delimiter=",", ndmin=2)

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gan4j_cv_")
    try:
        dirs = {k: f"{root}/{k}" for k in ("async", "sync", "stream",
                                            "dedup")}
        kernels.reset_launch_counts()
        trainer, res = cv_main.run(cv_main.parse_args(
            CV_ARGS + ["--res-path", dirs["async"]]))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        # one warm-up step before the capture, then a replay per step; the
        # dumps and the evaluation run inference forwards only
        calls = CV_STEPS + 1
        expected = {"fused_update": 3 * calls, "bn_act": 3 * calls,
                    "upsample_bwd": 2 * calls, "bn_moments": 0,
                    "bn_apply": 0, "bn_act_4d": 0, "bn_act_tenants": 0,
                "bn_act_tenants_bwd": 0}
        require(launches == expected,
                f"cv_main: launch counts {launches} != expected {expected}")
        require(res["steps"] == CV_STEPS and res["graphed"]
                and res["steps_per_call"] == CV_K and res["resident"],
                f"cv_main: {res}")
        d = dirs["async"]
        dumps = [f"mnist_out_{k}.csv" for k in (100, 200)] + [
            f"mnist_test_predictions_{k}.csv" for k in (100, 200)]
        for f in dumps[:2]:
            a = read_csv(f"{d}/{f}")
            require(a.shape == (100, 784) and bool(np.isfinite(a).all()),
                    f"cv_main: {f} is {a.shape}")
        for f in dumps[2:]:
            a = read_csv(f"{d}/{f}")
            require(a.shape == (2000, 10)
                    and float(np.abs(a.sum(axis=1) - 1).max()) <= 1e-4,
                    f"cv_main: {f} is {a.shape} or its rows do not sum to 1")
        recs = step_records(f"{d}/mnist_metrics.jsonl")
        require([r["step"] for r in recs] == list(range(1, CV_STEPS + 1)),
                "cv_main: the metrics JSONL does not hold one record a step")
        require(os.path.getsize(f"{d}/evaluation_stats.txt") > 0,
                "cv_main: no evaluation_stats.txt")
        # the loss curves' PNG (utils/plot_metrics.py: the stdlib raster
        # where matplotlib is absent, as on the card's host)
        with open(f"{d}/mnist_metrics_losses.png", "rb") as f:
            require(f.read(8) == b"\x89PNG\r\n\x1a\n",
                    "cv_main: no loss-curve PNG")
        # the sample grid's PNG (eval/plots.py, no matplotlib): the
        # mosaic of the last grid dump
        pngs = check_pngs(d, [("DCGAN_Generated_Images.png", plots.grid_image(
            f"{d}/mnist_out_{CV_STEPS}.csv", (28, 28)))])
        # the four zips read back give the trainer's params, bit for bit
        for g, path in trainer.model_paths().items():
            back = serialization.read_model(path, "cuda")
            live = getattr(trainer, g)
            require(all(torch.equal(back.params[ly][n], t)
                        for ly, lp in live.params.items()
                        for n, t in lp.items())
                    and back.params.keys() == live.params.keys(),
                    f"cv_main: {path} does not read back as the trained "
                    f"{g} graph")
        scores = {k: res.get(k) for k in (
            "test_accuracy", "test_f1", "fid", "fid_frozen", "fid_primary",
            "fid_primary_source")}
        require(all(isinstance(res.get(k), float) and math.isfinite(res[k])
                    for k in ("test_accuracy", "fid", "fid_frozen")),
                f"cv_main: scores {scores}")
        del trainer

        # the same run with synchronous dumps, from the same CSV pair
        for k in ("sync", "stream", "dedup"):
            os.makedirs(dirs[k])
            for f in ("mnist_train.csv", "mnist_test.csv"):
                shutil.copy(f"{d}/{f}", f"{dirs[k]}/{f}")
        _, res_sync = cv_main.run(cv_main.parse_args(
            CV_ARGS[:-1] + ["0", "--res-path", dirs["sync"], "--sync-dumps"]))
        for f in dumps:
            require(open(f"{d}/{f}", "rb").read()
                    == open(f"{dirs['sync']}/{f}", "rb").read(),
                    f"cv_main: {f} differs between async and --sync-dumps")
        # streamed: K = 100 steps of u8 codes a chunk (5 bytes a feature
        # in the byte budget, as in the JAX trainer), the plain chunk tier
        budget = CV_K * 200 * (5 * 784 + 4 * 10)
        _, res_stream = cv_main.run(
            cv_main.parse_args(CV_ARGS[:-1] + ["0", "--res-path",
                                               dirs["stream"]]),
            data_on_device=False, stream_chunk_bytes=budget,
            stream_dedup=False)
        keys = ("d_loss", "g_loss", "classifier_loss")
        require(not res_stream["resident"] and not res_stream["stream_dedup"]
                and res_stream["steps_per_call"] == CV_K
                and res_stream["data_codec"] == "u8x100",
                f"cv_main streamed: {res_stream}")
        # the dedup tier, on auto: the same arguments
        _, res_dedup = cv_main.run(
            cv_main.parse_args(CV_ARGS[:-1] + ["0", "--res-path",
                                               dirs["dedup"]]),
            data_on_device=False, stream_chunk_bytes=budget)
        require(not res_dedup["resident"] and res_dedup["stream_dedup"]
                and res_dedup["steps_per_call"] == CV_K
                and res_dedup["data_codec"] == "u8x100",
                f"cv_main dedup: {res_dedup}")
        for k in ("stream", "dedup"):
            recs_s = step_records(f"{dirs[k]}/mnist_metrics.jsonl")
            require([[r[x] for x in keys] for r in recs]
                    == [[r[x] for x in keys] for r in recs_s],
                    f"cv_main: the {k} run's per-step losses differ from "
                    "the resident run's")
        for split in ("train", "test"):
            shutil.copy(f"{dirs['async']}/mnist_{split}.csv", keep_csv)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(
        seconds=time.perf_counter() - t0, argv=CV_ARGS, steps=res["steps"],
        steps_per_call=res["steps_per_call"],
        launches=launches, expected_launches=expected,
        examples_per_sec=res["examples_per_sec"],
        examples_per_sec_sync_dumps=res_sync["examples_per_sec"],
        examples_per_sec_streamed=res_stream["examples_per_sec"],
        examples_per_sec_dedup=res_dedup["examples_per_sec"],
        step_ms_median=res["step_ms_median"], losses=[
            res[k] for k in ("d_loss", "g_loss", "clf_loss")],
        scores=scores, host_seconds=res["host_seconds"],
        host_seconds_sync=res_sync["host_seconds"],
        host_seconds_streamed=res_stream["host_seconds"],
        host_seconds_dedup=res_dedup["host_seconds"],
        # bytes on the host link: the plain chunk tier's chunk, the dedup
        # tier's table (once) and its chunk (the row schedule)
        link_bytes={"plain_chunk": res_stream["link_bytes"],
                    "dedup": res_dedup["link_bytes"]},
        sync_dumps_byte_identical=True, streamed_losses_bitwise=True,
        dedup_losses_bitwise=True, pngs=pngs, nvidia_smi=smi)


# -- the resume phase ---------------------------------------------------------

RES_INS_EVERY = 500  # the insurance children's --checkpoint-every
RES_INS_SIGNAL_AFTER = 2000  # SIGTERM after this step's "Completed Batch"
# the CV runs: full width, batch 200, RES_CV_STEPS steps in calls of K =
# 50, the CSV pair cut as in the cv_main phase, no FID
RES_CV_BASE = ["--n-train", "10000", "--n-test", "2000", "--iterations",
               "100", "--print-every", "50", "--save-every", "50",
               "--fid-samples", "0"]
RES_CV_CKPT = ["--checkpoint-every", "50"]
# 100 steps, preempted at 50 (once 400 and 200, then 200 and 100: a save's
# DEFLATE is seconds of host time, and the script must stay inside its
# limit)
RES_CV_STEPS = 100
RES_CV_STOP = 50
RES_DP_STEPS = (4, 8)  # the world-2 run: a checkpoint at 4, resumed to 8
RES_CHILD_TIMEOUT_S = 300
# the cross-process CV resume under the default policy against the
# in-process run: the largest param difference is reported with the first
# of these bounds it meets (not gated: cuDNN times its choices per
# process, and a chaotic GAN run amplifies another choice); under the
# untimed choice the check is bitwise
RES_CV_BOUNDS = (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 5e-2)
# what the resume phase's CV children run beside (the script's limit)
BESIDE_CV_CHILDREN = "the insurance children and the world-2 resume's ranks"
# a child process under cuDNN's untimed deterministic choice (benchmark
# off: the "heuristic" policy of train/moment_triage.py): every entry
# point sets the parity switches through backend.set_f32_parity, so the
# child wraps it and then runs the module as ``python -m`` would.  Two
# fresh processes make the same untimed choices; a process that already
# timed a shape keeps that choice (cuDNN's plan cache ignores the flag).
UNTIMED_CHILD = """
import runpy, sys, torch
from gan_deeplearning4j_tpu_torch.runtime import backend
_parity = backend.set_f32_parity
def _untimed():
    _parity()
    torch.backends.cudnn.benchmark = False
backend.set_f32_parity = _untimed
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""
LOSS_KEYS = ("classifier_loss", "d_loss", "g_loss")


class _SignalAt(io.TextIOBase):
    """A stdout that sends SIGTERM to this process when ``line`` is
    written (the in-process preemption), discarding everything."""

    def __init__(self, line: str):
        self.line, self.fired = line, False

    def write(self, text: str) -> int:
        if not self.fired and self.line in text:
            import signal

            self.fired = True
            os.kill(os.getpid(), signal.SIGTERM)
        return len(text)


def child_command(module: str, args, untimed: bool = False):
    """(argv, cwd, env) of ``python -m module args`` from this checkout;
    ``untimed``: under cuDNN's untimed choice (UNTIMED_CHILD).  With
    ``module`` None, ``args`` follow the interpreter as they are."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    head = (["-c", UNTIMED_CHILD, module] if untimed
            else [] if module is None else ["-m", module])
    return [sys.executable, *head, *args], root, env


def shared_card(beside, **timings) -> dict:
    """Timings taken while ``beside`` ran on the same card (children run
    side by side for the script's limit): kept under their own key, so that
    none of them reads as a program's rate alone."""
    return {"beside": beside, **timings}


def run_child(module: str, args, stop_after=None, untimed: bool = False,
              profile_lines=None):
    """``python -m module args`` in a child process from this checkout ->
    (exit code, its last JSON line or None, seconds, stderr tail); with
    ``stop_after``, SIGTERM once it printed ``Completed Batch
    {stop_after}!``; ``untimed``: under cuDNN's untimed choice;
    ``profile_lines``: a list that gets its ``[profile]`` lines.  The child
    is killed at RES_CHILD_TIMEOUT_S."""
    import signal
    import threading

    argv, root, env = child_command(module, args, untimed)
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(argv,
                                cwd=root, env=env, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        killer = threading.Timer(RES_CHILD_TIMEOUT_S, proc.kill)
        killer.start()
        last, sent = None, False
        try:
            for line in proc.stdout:
                if (stop_after is not None and not sent and line.startswith(
                        f"Completed Batch {stop_after}!")):
                    proc.send_signal(signal.SIGTERM)
                    sent = True
                if line.startswith("{"):
                    last = line
                elif profile_lines is not None and line.startswith(
                        "[profile]"):
                    profile_lines.append(line.rstrip())
            rc = proc.wait()
        finally:
            killer.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        tail = err.read()[-3000:]
    return (rc, json.loads(last) if last else None,
            time.perf_counter() - t0, tail)


def zip_arrays(path: str) -> dict:
    """A model zip's params and updater state, {member/key: array}."""
    import zipfile

    import numpy as np

    out = {}
    with zipfile.ZipFile(path) as zf:
        for member in ("params.npz", "updater.npz"):
            with np.load(io.BytesIO(zf.read(member))) as z:
                out.update({f"{member[:-4]}/{k}": z[k] for k in z.files})
    return out


def zips_diff(ref_dir: str, got_dir: str, prefix: str, names) -> tuple:
    """(largest |difference|, (first differing leaf, its difference) or
    None) over the params and updater state of two runs' model zips."""
    import numpy as np

    worst, first = 0.0, None
    for g in names:
        a = zip_arrays(f"{ref_dir}/{prefix}_{g}_model.zip")
        b = zip_arrays(f"{got_dir}/{prefix}_{g}_model.zip")
        require(a.keys() == b.keys(), f"{prefix}_{g}: the zips' leaves differ")
        for k in sorted(a):
            d = (float(np.abs(a[k].astype(np.float64) - b[k]).max())
                 if a[k].size else 0.0)
            if not math.isfinite(d):
                d = float("inf")
            if d > 0 and first is None:
                first = (f"{g}:{k}", d)
            worst = max(worst, d)
    return worst, first


def step_records(path: str) -> list:
    """A metrics JSONL's step records, in order; each run ends its file
    with one run-level ``{"goodput", "run_id"}`` record, left out here,
    which must be there."""
    recs = [json.loads(ln) for ln in open(path)]
    require(recs and set(recs[-1]) == {"goodput", "run_id"},
            f"{path} does not end in the run's goodput record")
    return [r for r in recs if "step" in r]


def metrics_by_step(path: str) -> dict:
    """A metrics JSONL by step, the last record of a step winning (a
    resumed run appends to the file)."""
    out = {}
    for ln in open(path):
        rec = json.loads(ln)
        if "step" in rec:
            out[rec["step"]] = rec
    return out


def manifest_bytes(ckpt_dir: str) -> int:
    with open(f"{ckpt_dir}/MANIFEST.json") as f:
        return sum(m["bytes"] for m in json.load(f)["files"].values())


def checkpoint_costs(trainer, root: str, torch) -> dict:
    """The cost of checkpointing ``trainer``'s state at its step: the
    snapshot (copies to pinned host memory behind one event: the host's
    enqueue ms and the ms until the copies are done), a synchronous save,
    an asynchronous one (the
    seconds that block the caller, and until durable; its manifest must be
    the synchronous one's), the bytes, and a restore of the saved
    checkpoint (which must give back the state, bit for bit)."""
    from gan_deeplearning4j_tpu_torch.checkpoint import (
        AsyncCheckpointer,
        TrainCheckpointer,
    )
    from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
        snapshot_state,
    )
    from gan_deeplearning4j_tpu_torch.train import fused_step

    fused_step.state_to_graphs(trainer.state, trainer.dis, trainer.gen,
                               trainer.gan, trainer.classifier)
    graphs, step = trainer._graphs(), trainer.steps
    extra, spec = trainer._checkpoint_extra(), trainer._mesh_spec()
    want = {f"{g}/{f}/{ly}/{n}": t.detach().clone()
            for g, gr in graphs.items() for f in ("params", "opt_state")
            for ly, lp in getattr(gr, f).items() for n, t in lp.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = snapshot_state(graphs, step, extra, mesh_spec=spec)
    t1 = time.perf_counter()
    snap["event"].synchronize()
    snapshot = {"enqueue_ms": (t1 - t0) * 1e3,
                "copied_ms": (time.perf_counter() - t0) * 1e3}
    del snap
    sync_dir, async_dir = f"{root}/sync", f"{root}/async"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TrainCheckpointer(sync_dir).save(step, graphs, extra, mesh_spec=spec)
    sync_s = time.perf_counter() - t0
    ack = AsyncCheckpointer(TrainCheckpointer(async_dir))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ack.save(step, graphs, extra, mesh_spec=spec)
    async_blocking_s = time.perf_counter() - t0
    ack.wait()
    async_total_s = time.perf_counter() - t0
    ack.close()
    m_sync = json.load(open(f"{sync_dir}/ckpt_{step}/MANIFEST.json"))
    m_async = json.load(open(f"{async_dir}/ckpt_{step}/MANIFEST.json"))
    require(m_sync == m_async,
            "the async checkpoint's manifest differs from the sync one's")
    t0 = time.perf_counter()
    TrainCheckpointer(sync_dir).restore(graphs, target_mesh=spec)
    restore_s = time.perf_counter() - t0
    got = {f"{g}/{f}/{ly}/{n}": t
           for g, gr in graphs.items() for f in ("params", "opt_state")
           for ly, lp in getattr(gr, f).items() for n, t in lp.items()}
    require(want.keys() == got.keys()
            and all(torch.equal(want[k], got[k]) for k in want),
            "the restored checkpoint is not the saved state")
    return {"snapshot": snapshot, "sync_save_s": sync_s,
            "async_save_blocking_s": async_blocking_s,
            "async_save_s": async_total_s,
            "bytes": manifest_bytes(f"{sync_dir}/ckpt_{step}"),
            "files": sorted(m_sync["files"]), "restore_s": restore_s,
            "leaves": len(want)}


def resume_insurance(ref: str, ref_auroc: float, root: str) -> dict:
    """The insurance program at its defaults in child processes: child A
    with ``--checkpoint-every RES_INS_EVERY --preempt-signal SIGTERM``,
    sent SIGTERM after step RES_INS_SIGNAL_AFTER, must exit 75 and leave
    PREEMPTED.json, a verified checkpoint at its step, and the signal, the
    exit and the saves' stages in its timeline; child B resumes
    it to INS_STEPS.  The four zips (params and updater state), every
    metrics record's losses and test_auroc must be bitwise those of the
    insurance phase's uninterrupted run (``ref``)."""
    from gan_deeplearning4j_tpu_torch.checkpoint import TrainCheckpointer
    from gan_deeplearning4j_tpu_torch.telemetry.events import read_events

    module = "gan_deeplearning4j_tpu_torch.train.insurance_main"
    d = f"{root}/ins"
    os.makedirs(d)
    for f in ("insurance_train.csv", "insurance_test.csv"):
        shutil.copy(f"{ref}/{f}", f"{d}/{f}")
    args = ["--res-path", d, "--checkpoint-every", str(RES_INS_EVERY),
            "--preempt-signal", "SIGTERM"]
    rc_a, res_a, sec_a, err = run_child(module, args,
                                        stop_after=RES_INS_SIGNAL_AFTER)
    require(rc_a == 75 and res_a is not None and res_a.get("preempted"),
            f"insurance child A: exit {rc_a}, {res_a}; stderr: {err}")
    marker = json.load(open(f"{d}/PREEMPTED.json"))
    stop = marker["step"]
    ck = TrainCheckpointer(f"{d}/checkpoints", sweep_debris=False)
    require(RES_INS_SIGNAL_AFTER <= stop < INS_STEPS
            and marker["signal"] == "SIGTERM"
            and ck.latest_verified_step() == stop == res_a["step"],
            f"insurance child A: marker {marker}, checkpoints {ck.steps()}")
    # the drill's timeline: the signal, the exit and the saves' stages
    names_a = sorted({e["name"] for e in read_events(f"{d}/events.jsonl")})
    require({"preempt.signal", "preempt.exit", "checkpoint.serialize",
             "checkpoint.commit"} <= set(names_a)
            and os.path.exists(f"{d}/flight_record_preemption.json"),
            f"insurance child A: events {names_a}")
    ckpt_bytes = manifest_bytes(f"{d}/checkpoints/ckpt_{stop}")
    rc_b, res_b, sec_b, err = run_child(module, args + ["--resume"])
    require(rc_b == 0 and res_b is not None
            and res_b.get("steps") == INS_STEPS
            and not os.path.exists(f"{d}/PREEMPTED.json"),
            f"insurance child B: exit {rc_b}, {res_b}; stderr: {err}")
    worst, first = zips_diff(ref, d, "insurance",
                             ("dis", "gan", "gen", "insurance"))
    m_ref = metrics_by_step(f"{ref}/insurance_metrics.jsonl")
    m_got = metrics_by_step(f"{d}/insurance_metrics.jsonl")
    require(sorted(m_got) == list(range(1, INS_STEPS + 1)),
            "insurance resume: the metrics JSONL misses steps")
    bad = [s for s in sorted(m_ref)
           if any(m_ref[s][k] != m_got[s][k] for k in LOSS_KEYS)]
    require(worst == 0.0 and not bad and res_b["test_auroc"] == ref_auroc,
            f"insurance resume is not bitwise the uninterrupted run: first "
            f"differing leaf {first}, largest difference {worst}; metrics "
            f"differ at {len(bad)} steps (first {bad[:1]}); test_auroc "
            f"{res_b['test_auroc']} vs {ref_auroc}")
    hs = res_b["host_seconds"]
    return {"stopped_at": stop, "exit_a": rc_a, "marker": marker,
            "events_a": names_a, "checkpoint_bytes": ckpt_bytes,
            "bitwise": True, "largest_param_diff": worst,
            "metrics_steps_equal": INS_STEPS, "test_auroc": ref_auroc,
            # the world-2 resume runs beside both children, and all of
            # them beside the CV resume's children
            "shared_card": shared_card(
                ["the world-2 resume", "the CV resume's children"],
                seconds_a=sec_a, seconds_b=sec_b,
                b_restore_s=hs.get("restore_s"),
                b_capture_s=hs.get("capture_s"),
                b_checkpoint_s=hs.get("checkpoint_s"))}


def resume_cv(torch, root: str, serve_src: str, csv_dir: str, beside=None):
    """The CV program at full width, RES_CV_STEPS steps at batch 200 in
    calls of K = 50, checkpoints every 50: (1) in this process, U runs
    uninterrupted, P is preempted (SIGTERM to itself after step
    RES_CV_STOP's line: the emergency checkpoint), R resumes it with the
    launch counters zeroed just before and read just after; R's final
    state and latent generator must be U's, bitwise.  (2) The generator's
    state after U's replays must be that of a fresh generator after
    2 x RES_CV_STEPS eager draws (the resume route of a checkpoint without
    ``z_gen_state``).  (3) The cost of a checkpoint of R's state.  (4)
    Across processes, under the default policy: a child resumes a copy of
    P's directory (its checkpoint and PREEMPTED.json) to RES_CV_STEPS; its
    zips against U's, with the bound they meet (reported).  (5) Across
    processes under cuDNN's untimed choice: a child W runs uninterrupted
    with checkpoints, a second child resumes a copy of W's directory cut
    back to its step-RES_CV_STOP checkpoint (its final zips removed); the
    two runs' zips must be bitwise equal.  W's checkpoints are copied to
    ``serve_src`` for the serve phase.  (The insurance part sends SIGTERM
    to a child; here the signal reaches this process, which keeps the CV
    part to its children.)"""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.runtime import prng
    from gan_deeplearning4j_tpu_torch.train import cv_main, fused_step
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import advance_latents

    data = csv_dir

    def res_dir(name: str) -> str:
        d = f"{root}/{name}"
        os.makedirs(d)
        for f in ("mnist_train.csv", "mnist_test.csv"):
            shutil.copy(f"{data}/{f}", f"{d}/{f}")
        return d

    def run(args, out=None):
        with contextlib.redirect_stdout(out or io.StringIO()):
            return cv_main.run(cv_main.parse_args(RES_CV_BASE + args))

    t0 = time.perf_counter()
    u = res_dir("cv_u")
    tu, ru = run(["--res-path", u])
    p = res_dir("cv_p")
    # the step line (a "Completed Batch" line comes every 100 steps only)
    sig = _SignalAt(f"step {RES_CV_STOP}: ")
    tp, rp = run(RES_CV_CKPT + ["--res-path", p, "--preempt-signal",
                                "SIGTERM", "--async-checkpoint"], sig)
    require(sig.fired and tp is None and rp.get("preempted")
            and rp["step"] == RES_CV_STOP
            and os.path.exists(f"{p}/PREEMPTED.json"),
            f"cv: the in-process preemption gave {rp}")
    # the preempted run as this process left it, for a resume in another
    x = f"{root}/cv_x"
    shutil.copytree(p, x)
    kernels.reset_launch_counts()
    tr, rr = run(RES_CV_CKPT + ["--res-path", p, "--resume",
                                "--async-checkpoint"])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    calls = 1 + RES_CV_STEPS - RES_CV_STOP  # the warm-up step and replays
    expected = {"fused_update": 3 * calls, "bn_act": 3 * calls,
                "upsample_bwd": 2 * calls, "bn_moments": 0, "bn_apply": 0,
                "bn_act_4d": 0, "bn_act_tenants": 0,
                "bn_act_tenants_bwd": 0}
    require(launches == expected,
            f"cv resume: launch counts {launches} != expected {expected}")
    require(rr["steps"] == RES_CV_STEPS and rr["graphed"],
            f"cv resume: {rr}")
    lu, lr = fused_step._leaves(tu.state), fused_step._leaves(tr.state)
    differ = [(".".join(k), max_err(lu[k], lr[k])) for k in lu
              if not torch.equal(lu[k], lr[k])]
    z_u, z_r = tu.z_gen.get_state(), tr.z_gen.get_state()
    require(not differ and torch.equal(z_u, z_r)
            and int(tu.state.it) == int(tr.state.it) == RES_CV_STEPS,
            f"cv: the in-process resume is not bitwise the uninterrupted run "
            f"({len(differ)} leaves differ, first {differ[:1]}; generator "
            f"states equal: {torch.equal(z_u, z_r)})")
    # the generator: replays of a registered generator against eager draws
    z_fresh = prng.generator(prng.NUMBER_OF_THE_BEAST, "train-z", tu.device)
    advance_latents(z_fresh, RES_CV_STEPS, BATCH, 2, tu.device)
    require(torch.equal(z_fresh.get_state(), z_u),
            f"cv: the generator's state after {RES_CV_STEPS} graphed steps "
            f"{z_u.tolist()} is not that of {2 * RES_CV_STEPS} eager draws "
            f"{z_fresh.get_state().tolist()}")
    seconds_in_process = time.perf_counter() - t0
    costs = checkpoint_costs(tr, f"{root}/cv_costs", torch)
    restore_s, capture_s = tr.timings["restore_s"], tr.timings["capture_s"]
    resumed_checkpoint_s = tr.timings.get("checkpoint_s")
    del tu, tr

    # across processes under the default policy: a child resumes the copy
    # of P's directory (reported, not gated).  It runs beside W below (the
    # script's limit): the two children share the card, so their seconds
    # are those of two runs at once, and X's timed cuDNN choices are made
    # beside W's work (its distance is reported, W's checks are bitwise
    # under the untimed choice whatever runs beside)
    cv_main_mod = "gan_deeplearning4j_tpu_torch.train.cv_main"
    zips = ("dis", "gan", "gen", "CV")
    # across processes under the untimed choice: W uninterrupted, then a
    # resume of W's step-RES_CV_STOP checkpoint, both fresh children
    from gan_deeplearning4j_tpu_torch.checkpoint import TrainCheckpointer

    # (checkpoints at RES_CV_STOP only: the resume needs no other)
    untimed_ckpt = ["--checkpoint-every", str(RES_CV_STOP)]
    w = res_dir("cv_w")
    # ``beside`` (the insurance children and the world-2 ranks) runs from
    # here to the last CV child's end
    side_pool = concurrent.futures.ThreadPoolExecutor(1)
    side = side_pool.submit(beside) if beside is not None else None
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        x_child = pool.submit(run_child, cv_main_mod, RES_CV_BASE
                              + RES_CV_CKPT + ["--res-path", x, "--resume"])
        rc_w, res_w, sec_w, err = run_child(
            cv_main_mod, RES_CV_BASE + untimed_ckpt + ["--res-path", w],
            untimed=True)
        rc_b, res_b, sec_b, err_b = x_child.result()
    require(rc_b == 0 and res_b is not None
            and res_b.get("steps") == RES_CV_STEPS
            and not os.path.exists(f"{x}/PREEMPTED.json"),
            f"cv child: exit {rc_b}, {res_b}; stderr: {err_b}")
    worst, first = zips_diff(u, x, "mnist", zips)
    bound = next((b for b in RES_CV_BOUNDS if worst <= b), None)
    require(rc_w == 0 and res_w is not None
            and res_w.get("steps") == RES_CV_STEPS,
            f"cv untimed child W: exit {rc_w}, {res_w}; stderr: {err}")
    y = f"{root}/cv_y"
    shutil.copytree(w, y)
    cut = TrainCheckpointer(f"{y}/checkpoints",
                            sweep_debris=False).prune_above(RES_CV_STOP)
    for g in zips:
        os.remove(f"{y}/mnist_{g}_model.zip")
    rc_y, res_y, sec_y, err = run_child(
        cv_main_mod, RES_CV_BASE + untimed_ckpt + ["--res-path", y,
                                                   "--resume"],
        untimed=True)
    require(rc_y == 0 and res_y is not None
            and res_y.get("steps") == RES_CV_STEPS,
            f"cv untimed resume child: exit {rc_y}, {res_y}; stderr: {err}")
    worst_u, first_u = zips_diff(w, y, "mnist", zips)
    require(worst_u == 0.0,
            f"cv: under cuDNN's untimed choice the cross-process resume "
            f"differs from the uninterrupted run by {worst_u} (first "
            f"differing leaf {first_u}); it must be bitwise")
    shutil.copytree(f"{w}/checkpoints", serve_src, dirs_exist_ok=True)
    side_out = side.result() if side is not None else {}
    side_pool.shutdown()
    return {"steps": RES_CV_STEPS, "stopped_at": RES_CV_STOP,
            "in_process_bitwise": True, "launches": launches,
            "expected_launches": expected,
            "z_gen_state_is_eager_draws": True, "z_gen_state": z_u.tolist(),
            "seconds_in_process": seconds_in_process,
            "resumed_run_restore_s": restore_s,
            "resumed_run_capture_s": capture_s,
            "resumed_run_checkpoint_s": resumed_checkpoint_s,
            "examples_per_sec_uninterrupted": ru["examples_per_sec"],
            "examples_per_sec_resumed": rr["examples_per_sec"],
            "costs": costs,
            "cross_process_untimed": {
                "policy": "cudnn deterministic, benchmark off, both children",
                "largest_param_diff": worst_u, "bitwise": True,
                "resumed_from": RES_CV_STOP, "checkpoints_cut": cut,
                "seconds_resumed": sec_y,
                "shared_card": shared_card(
                    ["the timed-choice resume child (W's run)",
                     BESIDE_CV_CHILDREN], seconds_uninterrupted=sec_w,
                    seconds_resumed=sec_y)},
            "cross_process": {
                # cuDNN timed its choices while W ran on the card
                "policy": "default (timed, beside the untimed child W), "
                          "not gated",
                "largest_param_diff": worst, "first_differing_leaf": first,
                "bound_met": bound, "bitwise": worst == 0.0,
                "shared_card": shared_card(
                    ["the untimed child W", BESIDE_CV_CHILDREN],
                    seconds=sec_b,
                    **{k: res_b["host_seconds"].get(k) for k in (
                        "checkpoint_s", "restore_s", "capture_s")})}}, side_out


def resume_dp_rank(group, dirs) -> dict:
    """One rank of the world-2 resume (a spawned process): the insurance
    program's trainer run uninterrupted for RES_DP_STEPS[1] steps, then in
    a second res-path for RES_DP_STEPS[0] steps with a checkpoint there
    and resumed to RES_DP_STEPS[1] -> the two final states' digests."""
    from gan_deeplearning4j_tpu_torch.train import insurance_main
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    every, steps = RES_DP_STEPS

    def run(res, n, **kw):
        t = GANTrainer(group=group, workload=insurance_main.InsuranceWorkload(),
                       config=insurance_main.default_config(
                           res_path=res, num_iterations=n, print_every=every,
                           save_every=every, metrics=False, **kw))
        t.result = t.train(log=None)
        return t

    u = run(dirs["u"], steps)
    run(dirs["r"], every, checkpoint_every=every)
    b = run(dirs["r"], steps, checkpoint_every=every, resume=True)
    return {"rank": group.rank, "backend": group.backend,
            "uninterrupted": state_digest(u.state),
            "resumed": state_digest(b.state), "steps": b.steps,
            "restore_s": b.timings.get("restore_s"),
            "losses": {k: float(b.result[k]) for k in ("d_loss", "g_loss")}}


def resume_dp(root: str) -> dict:
    from gan_deeplearning4j_tpu_torch.data import datasets
    from gan_deeplearning4j_tpu_torch.parallel import mesh

    dirs = {k: f"{root}/dp_{k}" for k in ("u", "r")}
    for d in dirs.values():
        datasets.ensure_insurance_csv(d)  # before the ranks read it
    t0 = time.perf_counter()
    ranks = mesh.spawn(resume_dp_rank, DP_WORLD, (dirs,), device="cuda",
                       timeout=DP_TIMEOUT_S)
    digests = {r["uninterrupted"] for r in ranks} | {r["resumed"]
                                                    for r in ranks}
    require(len(digests) == 1
            and all(r["steps"] == RES_DP_STEPS[1] for r in ranks),
            f"dp resume: the resumed world-2 run is not the uninterrupted "
            f"one: {ranks}")
    # the world-2 run and its checkpoints, for the elastic phase's restore
    # at world 1
    keep = tempfile.mkdtemp(prefix="gan4j_el_src_")
    shutil.copytree(dirs["r"], keep, dirs_exist_ok=True)
    EL_KEEP.update(dir=keep, losses=ranks[0]["losses"])
    # the insurance resume's children run beside the two ranks
    return {"world": DP_WORLD, "backend": ranks[0]["backend"],
            "checkpoint_at": RES_DP_STEPS[0], "steps": RES_DP_STEPS[1],
            "equal": True,
            "ranks": [{k: v for k, v in r.items()
                       if k not in ("restore_s", "losses")} for r in ranks],
            "shared_card": shared_card(
                ["the insurance resume's children",
                 "the CV resume's children"],
                seconds=time.perf_counter() - t0,
                restore_s=[r["restore_s"] for r in ranks])}


def resume_data_retry(root: str, torch) -> dict:
    """One insurance run with ``--data-retries 3`` whose first CSV read
    meets an injected transient OSError -> its retry count (must be 1),
    and the checkpoint costs at the insurance model's size."""
    from gan_deeplearning4j_tpu_torch.data.csv import CSVRecordReader
    from gan_deeplearning4j_tpu_torch.train import insurance_main
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    orig = CSVRecordReader.read
    calls = {"n": 0}

    def flaky(self, path, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError(f"injected transient read error on {path}")
        return orig(self, path, *a, **kw)

    CSVRecordReader.read = flaky
    try:
        t = GANTrainer(workload=insurance_main.InsuranceWorkload(),
                       config=insurance_main.default_config(
                           res_path=f"{root}/retry", num_iterations=100,
                           data_retries=3, metrics=False))
    finally:
        CSVRecordReader.read = orig
    res = t.train(log=None)
    retries = t.data_health.retries_total
    require(retries == 1 and res["steps"] == 100,
            f"data retries: {retries} retries, {res['steps']} steps")
    costs = checkpoint_costs(t, f"{root}/ins_costs", torch)
    return {"retries": retries, "reads": calls["n"], "steps": res["steps"],
            "insurance_costs": costs,
            "insurance_capture_s": t.timings.get("capture_s")}


def resume_phase(torch, smi: str, ins_ref: str, ins_auroc: float,
                 serve_src: str, csv_dir: str) -> dict:
    """Checkpoints, preemption and resume on the card (see the module
    docstring, phase 10); the CV runs read the cv_main phase's CSV pair
    in ``csv_dir``; leaves a CV checkpoint directory in ``serve_src``."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gan4j_resume_")
    try:
        # the world-2 resume's ranks run beside the insurance children, and
        # both beside the CV children (the script's limit): every check of
        # them is bitwise, whatever shares the card; their timings stand
        # under ``shared_card``
        def insurance_and_dp():
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                dp = pool.submit(resume_dp, root)
                return {"insurance": resume_insurance(ins_ref, ins_auroc,
                                                      root),
                        "dp": dp.result()}

        out = {}
        out["cv"], side = resume_cv(torch, root, serve_src, csv_dir,
                                    beside=insurance_and_dp)
        out.update(side)
        t2 = time.perf_counter()
        out["data_retry"] = resume_data_retry(root, torch)
        out["seconds_by_part"] = {"cv_insurance_and_dp": t2 - t0,
                                  "retry": time.perf_counter() - t2}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    out["nvidia_smi"] = smi
    return out


# -- the roadmap phase --------------------------------------------------------

RM_BATCH = 128  # roadmap_main.DEFAULT_BATCH_SIZE
# bn_act's two shapes on the roadmap path: the generators' gen_bn0 (one
# launch per G-step)
RM_BN = {"celeba": ((RM_BATCH, 4 * 4 * 8 * 64), "relu"),
         "wgan-gp": ((RM_BATCH, 7 * 7 * 4 * 32), "relu")}
RM_N_TRAIN = 2000  # cgan-cifar10: ~200 rows a class, over the 50 its
#                   class metrics need
RM_FAMILIES = ("celeba", "wgan-gp", "cgan-cifar10")
RM_K = 10  # iterations per call of the graphed-vs-eager runs
RM_TURN_CALLS = 3  # calls of RM_K iterations in one timed turn
RM_EMA = 0.999
# the programs as child processes: (iterations, print_every)
# (50 iterations: the depth the script's time limit leaves them)
RM_CHILD = {"celeba": (50, 25), "wgan-gp": (50, 25),
            "cgan-cifar10": (50, 25)}
RM_FIDELITY_STEPS = 100  # the cgan child's --fidelity-steps
RM_RESUME = (50, 25)  # celeba in this process: straight, then 25 + resume
# one iteration on the card against one on the CPU, from the same state and
# draws, each held against the CPU in float64.  A GAN's first generator
# gradients are mostly cancellation (D's outputs sit near 0.5, and a
# train-mode BN's backward subtracts means): the CPU's own f32 gradients
# of the celeba generator lie ~3.5% (in norm) from the f64 ones, the
# card's ~4%.  So the card is held to the CPU's f32 accuracy, not to the
# CPU: leaf by leaf, the gradients read from Adam's m and v
# (||m' - m64|| / ||m64||) within 4x the CPU's distance plus 2e-3 (the
# celeba D-step's dis_bn3.gamma sits 1.1e-3 from f64 on the card, 2e-6 on
# the CPU; below); the share of a leaf's params more than 2.5e-5 (a quarter of the
# smallest learning rate) from f64's within 2x the CPU's share plus 2%
# (Adam's first step moves an element by about lr * sign(g), so a
# gradient near 0 may flip: 1.2% of gen_bn1.gamma on the card, none on the
# CPU); every param within 2 lr per update of the CPU's; the losses within
# 1e-4 of f64's, relative.
RM_CARD_TOL = {"loss": 1e-4, "moment_ratio": 4.0, "moment_slack": 2e-3,
               "param": 2.5e-5, "share_ratio": 2.0, "share_slack": 0.02,
               "flip_lr": 2.0}
# celeba's dis_bn3.gamma error is cuDNN's (``train/moment_triage.py`` on
# the H100): with cuDNN off (PyTorch's own CUDA convolutions) it falls from
# 1.1e-3 to 4.6e-7, while cuDNN's heuristic (untimed) choice and the BNs
# computed in float64 leave it as it is.  cgan-cifar10's card lies closer to
# f64 than the CPU does (its largest gradient error on the card 4.3e-6,
# gen_deconv2.b; the CPU's 1.7e-3, gen_bn0.gamma; no leaf above 4x the
# CPU's): its moment slack is sized from that reading, 1e-5.
RM_CARD_TOL_BY_FAMILY = {"cgan-cifar10": {**RM_CARD_TOL, "moment_slack": 1e-5}}


def roadmap_kernels(torch, randn, bw: float, sms: int) -> dict:
    """``bn_act`` at the roadmap path's two shapes: against its plain
    version (and its gradient), a bitwise repeat, its time against
    ``F.batch_norm`` in turns, one launch's floor and its bound."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import bn_act_plain

    torch_f = torch.nn.functional
    rows = {}
    for family, ((b, f), act) in RM_BN.items():
        x, gm, bt = (randn(b, f, scale=0.5, shift=0.2),
                     randn(f, scale=0.1, shift=1.0), randn(f, scale=0.1))
        yk, mk, vk = kernels.fused_bn_act_train(x, gm, bt, 1e-5, act)
        yp, mp, vp = bn_act_plain(x, gm, bt, 1e-5, act)
        require(within(yk, yp, 1e-5, 1e-4) and within(mk, mp, 1e-6, 1e-4)
                and within(vk, vp, 1e-6, 1e-4),
                f"bn_act disagrees with its plain version at [{b},{f}] {act}")
        require(bitwise_repeat(lambda *t: kernels.fused_bn_act_train(
            *t, 1e-5, act), [(x, gm, bt)], torch),
            f"bn_act: two launches differ at [{b},{f}]")
        leaves = [t.clone().requires_grad_(True) for t in (x, gm, bt)]
        gy = randn(b, f)
        gk = torch.autograd.grad(kernels.fused_bn_act_train(
            *leaves, 1e-5, act)[0], leaves, gy)
        gp = torch.autograd.grad(bn_act_plain(*leaves, 1e-5, act)[0], leaves, gy)
        require(all(within(u, v, 1e-4, 1e-3) for u, v in zip(gk, gp)),
                f"bn_act gradient disagrees at [{b},{f}] {act}")
        ms, library_ms, turns = in_turns(
            lambda: kernels.fused_bn_act_train(x, gm, bt, 1e-5, act),
            lambda: torch_f.batch_norm(x, None, None, gm, bt, training=True,
                                       eps=1e-5), torch)
        t_bytes = (8 * b * f + 16 * f) / bw * 1e3
        t_ops = 10 * b * f / PEAK_F32_FLOPS * 1e3
        rows[family] = dict(
            shape=[b, f], act=act, plan=bn2d.launch_plan(b, f, sms)._asdict(),
            max_abs_err=max(max_err(yk, yp), max_err(mk, mp), max_err(vk, vp)),
            ms=ms, library_ms=library_ms, turns_ms=turns,
            plain_ms=time_ms(lambda: bn_act_plain(x, gm, bt, 1e-5, act), torch),
            floor_ms=floor_ms(1, torch), bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_call="F.batch_norm(training=True), without the activation",
            kernel_slower_than_library=ms > library_ms)
    return rows


@contextlib.contextmanager
def _plain_bn_act():
    """The 2-D BN layer on ``bn_act``'s plain version (the float64
    reference; the kernel's wrapper takes f32 only)."""
    from gan_deeplearning4j_tpu_torch.graph import layers
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import bn_act_plain

    fused = layers.fused_bn_act_train
    layers.fused_bn_act_train = (
        lambda x, g, b, eps, act, group=None: bn_act_plain(x, g, b, eps, act))
    try:
        yield
    finally:
        layers.fused_bn_act_train = fused


def _pair_to(tree, dev, dtype):
    return {k: _pair_to(v, dev, dtype) if isinstance(v, dict)
            else v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
            for k, v in tree.items()}


def roadmap_card_vs_cpu(family: str, torch) -> dict:
    """One iteration (n_critic D-steps, one G-step) at full width and batch
    RM_BATCH on the card, on the CPU and on the CPU in float64, from the
    same params and draws (made on the CPU): within RM_CARD_TOL."""
    from gan_deeplearning4j_tpu_torch.train import fused_step, roadmap_main
    from gan_deeplearning4j_tpu_torch.train.gan_pair import Draws, PairState

    base, cfg, _ = roadmap_main._build(family, "cpu")
    n_critic = getattr(cfg, "n_critic", 1)
    real_label = getattr(cfg, "real_label", 1.0) if base.mode == "gan" else 1.0
    x, y = roadmap_main._data(family, 512, 7)
    table = torch.from_numpy(x)
    cond = None if y is None else torch.from_numpy(y)
    draws = base.draw(torch.Generator().manual_seed(8), 512, RM_BATCH,
                      n_critic, cfg.z_size, "cpu")
    runs = {}
    for key, dev, dtype in (("f64", "cpu", torch.float64),
                            ("cpu", "cpu", torch.float32),
                            ("card", "cuda", torch.float32)):
        pair, _, _ = roadmap_main._build(family, dev)
        for g in (pair.gen, pair.dis):
            src = base.gen if g is pair.gen else base.dis
            g.params = _pair_to(src.params, dev, dtype)
            g.opt_state = _pair_to(g.opt_state, dev, dtype)
        d = Draws(*[None if v is None else
                    [_pair_to({0: t}, dev, dtype)[0] for t in v]
                    if isinstance(v, list) else _pair_to({0: v}, dev, dtype)[0]
                    for v in draws])
        state = PairState(pair.gen.params, pair.gen.opt_state, pair.dis.params,
                          pair.dis.opt_state, torch.tensor(0, device=dev))
        labels = [t.to(dtype) for t in pair.label_vectors(RM_BATCH, real_label)]
        one = pair.iteration(RM_BATCH, n_critic, cfg.z_size)
        with _plain_bn_act() if dtype == torch.float64 else contextlib.nullcontext():
            runs[key] = one(state, table.to(dev, dtype), *labels,
                            None if cond is None else cond.to(dev, dtype),
                            draws=d)
    tol = RM_CARD_TOL_BY_FAMILY.get(family, RM_CARD_TOL)
    out = {k: [float(v) for v in r[1]] for k, r in runs.items()}
    out["loss_rel_err"] = {k: max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)
                                  for a, b in zip(runs[k][1], runs["f64"][1]))
                           for k in ("cpu", "card")}
    require(out["loss_rel_err"]["card"] <= tol["loss"],
            f"roadmap {family} card vs f64: loss relative error "
            f"{out['loss_rel_err']['card']} > {tol['loss']}")
    leaves = {k: fused_step._leaves(r[0]) for k, r in runs.items()}
    steps = {"gen": 1, "dis": n_critic}
    worst = {"moment": (-1.0, ""), "share": (-1.0, ""), "flip_lr": (0.0, "")}
    detail = {}
    for path, ref in leaves["f64"].items():
        field = path[0]
        if field == "it" or ref.dim() == 0:
            continue
        g = field.split("_")[0]
        cpu, card = leaves["cpu"][path].double(), leaves["card"][path].cpu().double()
        where = ".".join(map(str, path))
        if field.endswith("_opt"):
            nref = float(ref.norm())
            if nref == 0:
                continue
            e_cpu = float((cpu - ref).norm()) / nref
            e_card = float((card - ref).norm()) / nref
            margin = e_card - (tol["moment_ratio"] * e_cpu + tol["moment_slack"])
            detail[where] = (e_cpu, e_card)
            if margin >= worst["moment"][0] or worst["moment"][1] == "":
                worst["moment"] = (margin, where)
        else:
            lr = getattr(base, g).updater.updater_for(path[1]).learning_rate
            s_cpu = float(((cpu - ref).abs() > tol["param"]).double().mean())
            s_card = float(((card - ref).abs() > tol["param"]).double().mean())
            margin = s_card - (tol["share_ratio"] * s_cpu + tol["share_slack"])
            detail[where] = (s_cpu, s_card)
            if margin >= worst["share"][0] or worst["share"][1] == "":
                worst["share"] = (margin, where)
            flip = float((card - cpu).abs().max()) / (lr * steps[g])
            if flip >= worst["flip_lr"][0]:
                worst["flip_lr"] = (flip, where)
    out["worst"] = {k: (v, w, detail.get(w)) for k, (v, w) in worst.items()}
    out["tolerance"] = tol
    require(worst["moment"][0] <= 0 and worst["share"][0] <= 0
            and worst["flip_lr"][0] <= tol["flip_lr"],
            f"roadmap {family} card vs cpu: {out['worst']} beyond {tol}")
    return out


def roadmap_graphed_vs_eager(family: str, torch) -> dict:
    """From one start at full width and batch RM_BATCH: RM_K graphed
    iterations (one call of RM_K replays) against RM_K eager ones, bit for
    bit (losses and every leaf of the state), without and with the EMA;
    the capture's seconds and pool memory; without the EMA also the eager
    and the graphed iteration timed in turns (E G G E, RM_TURN_CALLS calls
    of RM_K iterations each, a call ending in its readback) and
    examples/s = batch * (n_critic + 1) per iteration."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.runtime import prng
    from gan_deeplearning4j_tpu_torch.train import fused_step, roadmap_main

    out = {}
    for ema in (0.0, RM_EMA):
        pair, cfg, _ = roadmap_main._build(family, "cuda")
        n_critic = getattr(cfg, "n_critic", 1)
        real_label = getattr(cfg, "real_label", 1.0) if pair.mode == "gan" else 1.0
        x, y = roadmap_main._data(family, RM_N_TRAIN,
                                  prng.NUMBER_OF_THE_BEAST)
        table = torch.from_numpy(x).cuda()
        cond = None if y is None else torch.from_numpy(y).cuda()
        kw = dict(batch_size=RM_BATCH, steps_per_call=RM_K, n_critic=n_critic,
                  real_label=real_label, z_size=cfg.z_size, ema_decay=ema)
        z_g = prng.generator(cfg.seed, "roadmap-z", "cuda")
        fg, sg = pair.make_multistep(table, cond, z_gen=z_g, graphed=True,
                                     **kw)
        z_e = torch.Generator(device="cuda")
        z_e.set_state(z_g.get_state())
        box = {"e": fused_step.clone_state(sg), "g": sg}
        fe, _ = pair.make_multistep(table, cond, z_gen=z_e, graphed=False,
                                    **kw)

        def eager():
            box["e"], (d, g) = fe(box["e"])
            return torch.stack([d, g], -1).cpu()

        def graphed():
            box["g"], (d, g) = fg(box["g"])  # the static state, replayed
            return torch.stack([d, g], -1).cpu()

        le, lg = eager(), graphed()
        le_leaves = fused_step._leaves(box["e"])
        lg_leaves = fused_step._leaves(box["g"])
        res = dict(iterations=RM_K, losses_bitwise=torch.equal(le, lg),
                   loss_max_abs_diff=max_err(le, lg),
                   state_bitwise=le_leaves.keys() == lg_leaves.keys() and all(
                       torch.equal(le_leaves[k], lg_leaves[k]) for k in le_leaves),
                   generator_state_equal=torch.equal(z_e.get_state(),
                                                     z_g.get_state()),
                   setup=fg.graphed.setup,
                   launches_per_replay=fg.graphed.launches,
                   losses_last=lg[-1].tolist())
        require(res["losses_bitwise"] and res["state_bitwise"]
                and res["generator_state_equal"],
                f"roadmap {family} (ema {ema}): the graphed iterations' bits "
                f"differ from the eager ones' ({res})")
        require(bool(torch.isfinite(lg).all()),
                f"roadmap {family}: non-finite losses {lg.tolist()}")
        if not ema:
            def turn(fn):
                times = []
                for _ in range(RM_TURN_CALLS):
                    t0 = time.perf_counter()
                    fn()
                    times.append(time.perf_counter() - t0)
                return statistics.median(times) / RM_K * 1e3

            turns = [turn(eager), turn(graphed), turn(graphed), turn(eager)]
            res["turns_ms"] = turns
            res["eager_ms"] = (turns[0] + turns[3]) / 2
            res["graphed_ms"] = (turns[1] + turns[2]) / 2
            per_it = RM_BATCH * (n_critic + 1)
            res["eager_examples_per_s"] = per_it / res["eager_ms"] * 1e3
            res["graphed_examples_per_s"] = per_it / res["graphed_ms"] * 1e3
        out["ema" if ema else "plain"] = res
        del pair, fg, fe, sg, box, table, cond
        kernels.reset_launch_counts()
        torch.cuda.empty_cache()
    return out


def roadmap_children(root: str) -> dict:
    """``roadmap_main`` as a user runs it, one child process per family at
    its defaults but the length (RM_CHILD) and ``--n-train`` RM_N_TRAIN:
    the exit code, the artifact set and the result line.  Each result's
    ``port_launches`` counts the port kernels' launches around the child's
    graphed iterations (the capture's warm-up included): one ``bn_act`` an
    iteration for celeba and wgan-gp (gen_bn0), and none at all for
    cgan-cifar10 (its generator's BNs are conditional, with no kernel route
    in the JAX package either; its one plain BN, dis_bn2, is 4-D, which the
    JAX layer does not send to Pallas; Adam is torch ops).  The cgan child
    also runs its end-of-run conditional evaluation (``--fidelity-steps``
    RM_FIDELITY_STEPS; every class has over 50 rows, so the per-class
    frozen FID runs too).  The three children run side by side (the
    script's limit): every check here is a count, a file or a score; each
    child's seconds, ``examples_per_sec``, host seconds and goodput are
    those of three programs at once and stand under ``shared_card``; the
    graph part's graphed and eager rates, timed in turns, are the
    families' rates of record."""
    out = {}
    with concurrent.futures.ThreadPoolExecutor(len(RM_CHILD)) as pool:
        children = {family: pool.submit(
            run_child, "gan_deeplearning4j_tpu_torch.train.roadmap_main",
            ["--family", family, "--iterations", str(iters), "--n-train",
             str(RM_N_TRAIN), "--print-every", str(every), "--res-path",
             f"{root}/{family}_child",
             *(["--fidelity-steps", str(RM_FIDELITY_STEPS)]
               if family == "cgan-cifar10" else [])])
            for family, (iters, every) in RM_CHILD.items()}
        done = {family: child.result() for family, child in children.items()}
    for family, (iters, every) in RM_CHILD.items():
        res = f"{root}/{family}_child"
        rc, result, secs, tail = done[family]
        require(rc == 0 and result is not None,
                f"roadmap_main {family}: exit {rc}, stderr {tail}")
        want = sorted([f"{family}_samples_{s}.png"
                       for s in range(every, iters + 1, every)]
                      + [f"{family}_metrics.jsonl", f"{family}_gen_model.zip",
                         f"{family}_dis_model.zip", "events.jsonl",
                         "run_manifest.json"])
        files = sorted(os.listdir(res))
        steps = [r["step"] for r in step_records(
            f"{res}/{family}_metrics.jsonl")]
        require(files == want and steps == list(range(1, iters + 1)),
                f"roadmap_main {family}: files {files}, metrics steps "
                f"{steps[:3]}..{steps[-3:]}")
        require(result["family"] == family and result["steps"] == iters
                and result["graphed"] and result["device"].startswith("cuda")
                and math.isfinite(result["d_loss"])
                and math.isfinite(result["g_loss"])
                and result["examples_per_sec"] > 0,
                f"roadmap_main {family}: result {result}")
        expected = {k: 0 for k in result["port_launches"]}
        if family != "cgan-cifar10":
            expected["bn_act"] = iters + 1  # the warm-up and the replays
        require(result["port_launches"] == expected,
                f"roadmap_main {family}: launch counts "
                f"{result['port_launches']} != {expected}")
        if family == "cgan-cifar10":
            keys = ("conditional_fidelity", "probe_train_acc",
                    "mean_class_fid", "diversity_ratio")
            require(all(math.isfinite(result.get(k, math.nan)) for k in keys)
                    and len(result["per_class_fid"]) == 10
                    and 0.0 <= result["conditional_fidelity"] <= 1.0,
                    f"roadmap_main {family}: conditional scores {result}")
            print(json.dumps({"cgan_child": {k: result[k] for k in keys}}),
                  flush=True)
        timed = ("examples_per_sec", "host_seconds", "goodput")
        out[family] = dict(
            files=len(files), expected_launches=expected,
            result={k: v for k, v in result.items() if k not in timed},
            shared_card=shared_card(
                [f for f in RM_CHILD if f != family], seconds=secs,
                **{k: result.get(k) for k in timed}))
    return out


def roadmap_counted_and_resume(torch, root: str) -> dict:
    """The main path in this process: ``roadmap_main.train`` for celeba
    (RM_RESUME[0] iterations) and wgan-gp (RM_CHILD's length), each with
    the launch counters zeroed just before and read just after (one
    ``bn_act`` a G-step: the warm-up iteration and every replay).  Then
    celeba checkpointed at RM_RESUME[1] and resumed in this process to
    RM_RESUME[0]: its zips must be the straight run's, byte for byte."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.train import roadmap_main

    out = {}
    straight = {}
    for family, iters in (("celeba", RM_RESUME[0]),
                          ("wgan-gp", RM_CHILD["wgan-gp"][0])):
        res = f"{root}/{family}_counted"
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        r = roadmap_main.train(family, iters, RM_BATCH, res, RM_N_TRAIN,
                               RM_RESUME[1], device="cuda", log=None)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        expected = {k: 0 for k in launches}
        expected["bn_act"] = iters + 1  # the warm-up iteration and the replays
        require(launches == expected,
                f"roadmap {family}: launch counts {launches} != {expected}")
        straight[family] = res
        out[family] = dict(iterations=iters, launches=launches,
                           expected_launches=expected,
                           steps_per_call=r["steps_per_call"],
                           examples_per_sec=r["examples_per_sec"],
                           host_seconds=r["host_seconds"],
                           losses=[r["d_loss"], r["g_loss"]])
    res = f"{root}/celeba_resumed"
    total, stop = RM_RESUME
    roadmap_main.train("celeba", stop, RM_BATCH, res, RM_N_TRAIN, stop,
                       device="cuda", checkpoint_every=stop, log=None)
    r = roadmap_main.train("celeba", total, RM_BATCH, res, RM_N_TRAIN, stop,
                           device="cuda", checkpoint_every=stop, resume=True,
                           log=None)
    same = {}
    for name in ("gen", "dis"):
        with open(f"{straight['celeba']}/celeba_{name}_model.zip", "rb") as f:
            a = f.read()
        with open(f"{res}/celeba_{name}_model.zip", "rb") as f:
            same[name] = a == f.read()
    require(all(same.values()) and r["steps"] == total,
            f"roadmap celeba resume: zips equal {same}, steps {r['steps']}")
    out["resume"] = dict(stop=stop, total=total, zips_bitwise=same,
                         restore_s=r["host_seconds"].get("restore_s"))
    return out


def roadmap_phase(torch, smi: str, randn, bw: float, sms: int) -> dict:
    """The roadmap families on the card (module docstring, phase 11)."""
    t0 = time.perf_counter()
    out = {"kernels": roadmap_kernels(torch, randn, bw, sms)}
    t1 = time.perf_counter()
    out["card_vs_cpu"] = {f: roadmap_card_vs_cpu(f, torch)
                          for f in RM_FAMILIES}
    t2 = time.perf_counter()
    out["graph"] = {f: roadmap_graphed_vs_eager(f, torch)
                    for f in RM_FAMILIES}
    t3 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gan4j_roadmap_")
    try:
        out["program"] = roadmap_children(root)
        t4 = time.perf_counter()
        out["main"] = roadmap_counted_and_resume(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds_by_part"] = {
        "kernels": t1 - t0, "card_vs_cpu": t2 - t1, "graph": t3 - t2,
        "program": t4 - t3, "main_and_resume": time.perf_counter() - t4}
    out["seconds"] = time.perf_counter() - t0
    out["batch"] = RM_BATCH
    out["nvidia_smi"] = smi
    return out


# -- the pair_dp phase ---------------------------------------------------------

# the sync-BN pair's shapes on the roadmap path at world 2: each rank's rows
# of the celeba and wgan-gp generators' gen_bn0 (one moments and one apply
# launch per G-step)
RM_PAIR = {family: ((RM_BATCH // DP_WORLD, f), act)
           for family, ((_, f), act) in RM_BN.items()}
PD_ITERS = 3  # world-2 iterations held against the single-process pair
PD_TIME_ITERS = 4  # eager world-2 iterations timed after them
PD_N_TRAIN = 512
# roadmap_main --n-devices 2 in this process: (iterations with a checkpoint
# at the end, the resumed run's iterations); calls of PD_MAIN_K
PD_MAIN = (10, 20)
PD_MAIN_K = 5
PD_DATA_IMAGES = 64  # the --data-dir run's PNGs (celeba, 64x64 RGB)
PD_DATA_ITERS = 10
# the world-2 iterations against the single-process card pair from the
# same params and global draws.  Losses: the tests' band (rtol 1e-4, atol
# 1e-5).  Params and BN statistics: each graph's share of elements outside
# the tests' band (rtol 1e-3, atol 1e-4) within 2x that of a second
# single-process run with cuDNN off (PyTorch's own convolutions: the same
# sums in another f32 order) plus 2% (RM_CARD_TOL's share ratio and
# slack), and no element further from the single-process pair's than two
# Adam runs of as many updates can move apart (2 lr sum_t c_t, c_t Adam's
# largest normalized step after t steps; ``adam_spread``).  Not each
# element within the band: a GAN's first generator gradients are mostly
# cancellation (celeba's lie ~4% in norm from float64 on the card:
# RM_CARD_TOL), so the two batch splits' f32 sums differ in many small
# elements, and Adam turns each such difference into up to +-lr: on an
# H100 (700 W), 3 celeba iterations put 2.9% of the generator's elements
# outside the band, and the cuDNN-off run 5.7%.  The sharp checks of the
# wiring are the losses and the ranks' bitwise equality.
PD_TOL = {"loss_rtol": 1e-4, "loss_atol": 1e-5, "param_rtol": 1e-3,
          "param_atol": 1e-4, "share_ratio": 2.0, "share_slack": 0.02}


def _draws_to(d, dev):
    """A ``Draws`` (lists and tensors) moved to ``dev``."""
    from gan_deeplearning4j_tpu_torch.train.gan_pair import Draws

    return Draws(*(None if v is None else [t.to(dev) for t in v]
                   if isinstance(v, list) else v.to(dev) for v in d))


def pd_setup(family, dev, group, torch):
    """(pair, cfg, table, cond, draws, n_critic, real_label) of ``family``
    at full width on ``dev`` (over ``group``): the same data, params
    (each graph's seeded init) and global draws in every process."""
    from gan_deeplearning4j_tpu_torch.train import roadmap_main

    pair, cfg, _ = roadmap_main._build(family, dev, group=group)
    n_critic = getattr(cfg, "n_critic", 1)
    real_label = getattr(cfg, "real_label", 1.0) if pair.mode == "gan" else 1.0
    x, y = roadmap_main._data(family, PD_N_TRAIN, 7)
    gen = torch.Generator().manual_seed(9)
    draws = [_draws_to(pair.draw(gen, PD_N_TRAIN, RM_BATCH, n_critic,
                                 cfg.z_size, "cpu"), dev)
             for _ in range(PD_ITERS + PD_TIME_ITERS)]
    table = torch.from_numpy(x).to(dev)
    cond = None if y is None else torch.from_numpy(y).to(dev)
    return pair, cfg, table, cond, draws, n_critic, real_label


def adam_spread(beta1: float, beta2: float, steps: int) -> float:
    """How far apart, in learning rates, two Adam runs of ``steps`` updates
    can move an element, whatever their gradients: 2 sum_t c_t, with c_t =
    max |mhat_t| / sqrt(vhat_t) over gradient sequences (Cauchy-Schwarz:
    sqrt(sum_i a_i^2 / w_i) sqrt(1 - beta2^t) / (1 - beta1^t), a_i and w_i
    the weights of g_i in m_t and v_t)."""
    total = 0.0
    for t in range(1, steps + 1):
        s2 = sum(((1 - beta1) * beta1 ** (t - i)) ** 2
                 / ((1 - beta2) * beta2 ** (t - i)) for i in range(1, t + 1))
        total += math.sqrt(s2) * math.sqrt(1 - beta2 ** t) / (1 - beta1 ** t)
    return 2 * total


def pd_compare(ref, got, ref_losses, got_losses, steps, updaters,
               torch) -> dict:
    """A run (``got``: state, losses) against the single-process pair
    (``ref``) under PD_TOL's bands -> the losses' worst ratio to their
    band; per graph, the share of elements outside the params' band (and
    the leaf with the largest share); the largest difference as a fraction
    of ``adam_spread`` (``steps``: updates per graph; ``updaters``:
    {graph: {layer: its updater}})."""
    from gan_deeplearning4j_tpu_torch.train import fused_step

    t = PD_TOL
    loss_ratio = max(
        float(((a.double() - b.double()).abs()
               / (t["loss_atol"] + t["loss_rtol"] * b.double().abs())).max())
        for a, b in zip(got_losses, ref_losses))
    lr_, lg_ = fused_step._leaves(ref), fused_step._leaves(got)
    outside = {"gen": [0, 0], "dis": [0, 0]}
    leaf_share, spread = (0.0, ""), (0.0, "")
    for path, a in lr_.items():
        field = path[0]
        if field not in ("gen_params", "dis_params"):
            continue
        g = field.split("_")[0]
        d = (lg_[path].double() - a.double()).abs()
        out_band = d > t["param_atol"] + t["param_rtol"] * a.double().abs()
        outside[g][0] += int(out_band.sum())
        outside[g][1] += out_band.numel()
        where = ".".join(map(str, path))
        frac = float(out_band.double().mean())
        if frac > leaf_share[0]:
            leaf_share = (frac, where)
        u = updaters[g][path[1]]
        u = getattr(u, "base", u)  # Scheduled(Adam)
        f = float(d.max()) / (u.learning_rate * adam_spread(
            u.beta1, u.beta2, steps[g]))
        if f > spread[0]:
            spread = (f, where)
    share = {g: n / max(total, 1) for g, (n, total) in outside.items()}
    return {"loss_ratio": loss_ratio, "graph_share_outside_band": share,
            "largest_leaf_share": leaf_share, "adam_spread_fraction": spread}


def pd_within(got: dict, noise: dict) -> bool:
    """World 2's comparison (``got``) within PD_TOL, given the cuDNN-off
    run's (``noise``)."""
    t = PD_TOL
    return (got["loss_ratio"] <= 1.0
            and got["adam_spread_fraction"][0] <= 1.0
            and all(share <= t["share_ratio"]
                    * noise["graph_share_outside_band"][g] + t["share_slack"]
                    for g, share in got["graph_share_outside_band"].items()))


def pd_grad_check(group, torch) -> dict:
    """The sync-BN pair (``fused_bn_act_train`` over ``group``: moments
    kernel, all-reduce, apply kernel, and its backward) against autograd
    through the plain composition with the differentiable all-reduce, on
    this rank's rows of one global batch at each RM_PAIR shape -> the
    largest difference per shape."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import bn_act_plain

    dev = group.device
    gen = torch.Generator(device=dev).manual_seed(20261019)
    out = {}
    for family, ((b, f), act) in RM_PAIR.items():
        rows = slice(group.rank * b, (group.rank + 1) * b)
        x = (torch.randn((b * group.world, f), generator=gen, device=dev)
             * 0.5 + 0.2)[rows]
        gm = torch.randn(f, generator=gen, device=dev) * 0.1 + 1.0
        bt = torch.randn(f, generator=gen, device=dev) * 0.1
        gy = torch.randn((b * group.world, f), generator=gen, device=dev)[rows]
        res = []
        for fn in (kernels.fused_bn_act_train, bn_act_plain):
            leaves = [t.clone().requires_grad_(True) for t in (x, gm, bt)]
            y, mean, var = fn(*leaves, 1e-5, act, group)
            res.append((y, mean, var, *torch.autograd.grad(y, leaves, gy)))
        err = 0.0
        for a, c, (atol, rtol) in zip(
                *res, [(1e-5, 1e-4), (1e-6, 1e-4), (1e-6, 1e-4)]
                + [(1e-4, 1e-3)] * 3):
            require(within(a.detach(), c.detach(), atol, rtol),
                    f"pair_dp rank {group.rank}: the sync-BN pair disagrees "
                    f"with its plain composition at [{b},{f}] {act}")
            err = max(err, max_err(a.detach(), c.detach()))
        out[family] = {"shape": [b, f], "act": act, "max_abs_err": err}
    return out


def pair_dp_rank(group) -> dict:
    """One rank of the pair_dp phase (a spawned process): the pair's
    gradient check, then per family PD_ITERS world-2 iterations from the
    seeded params and global draws (``make_multistep``, eager under a
    group) with the launch counters zeroed just before and read just
    after, the state's digest, and PD_TIME_ITERS more iterations timed;
    rank 0 also runs the single-process pair over the whole batch on the
    same draws (its card, no group), and again with cuDNN off, and holds
    world 2 and the cuDNN-off run to it."""
    import torch

    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.parallel import mesh

    dev = group.device
    out = {"rank": group.rank, "backend": group.backend, "device": str(dev),
           "pair_gradient": pd_grad_check(group, torch), "families": {}}
    for family in RM_FAMILIES:
        pair, cfg, table, cond, draws, n_critic, real_label = pd_setup(
            family, dev, group, torch)
        kw = dict(batch_size=RM_BATCH, n_critic=n_critic,
                  real_label=real_label, z_size=cfg.z_size)
        step, state0 = pair.make_multistep(table, cond,
                                           steps_per_call=PD_ITERS, **kw)
        torch.cuda.synchronize(dev)
        kernels.reset_launch_counts()
        state, (dl, gl) = step(state0, draws=draws[:PD_ITERS])
        torch.cuda.synchronize(dev)
        res = {"launches": kernels.launch_counts(),
               "graphed": step.graphed is not None,
               "losses": [dl.tolist(), gl.tolist()],
               "digest": state_digest(state)}
        # the eager world-2 iteration's time, both ranks starting together
        # (the iterations are functional: ``state`` stays as it is)
        timed, _ = pair.make_multistep(table, cond,
                                       steps_per_call=PD_TIME_ITERS, **kw)
        mesh.barrier(group)
        t0 = time.perf_counter()
        _, (dl2, _) = timed(state, draws=draws[PD_ITERS:])
        dl2.tolist()  # the call's readback
        res["eager_iteration_ms"] = ((time.perf_counter() - t0)
                                     / PD_TIME_ITERS * 1e3)
        if group.rank == 0:
            single = []
            for cudnn in (True, False):
                torch.backends.cudnn.enabled = cudnn
                try:
                    ref, _, table1, cond1, draws1, _, _ = pd_setup(
                        family, dev, None, torch)
                    step1, s1 = ref.make_multistep(
                        table1, cond1, graphed=False,
                        steps_per_call=PD_ITERS, **kw)
                    single.append(step1(s1, draws=draws1[:PD_ITERS]))
                finally:
                    torch.backends.cudnn.enabled = True
            updaters = {g: {n: getattr(ref, g).updater.updater_for(n)
                            for n in getattr(ref, g).params}
                        for g in ("gen", "dis")}
            (s1, l1), (s1b, l1b) = single
            steps = {"gen": PD_ITERS, "dis": PD_ITERS * n_critic}
            res["vs_single_process"] = pd_compare(s1, state, l1, (dl, gl),
                                                  steps, updaters, torch)
            res["cudnn_off_vs_single_process"] = pd_compare(
                s1, s1b, l1, l1b, steps, updaters, torch)
            del ref, step1, s1, s1b, single, table1, cond1, draws1
        out["families"][family] = res
        del pair, step, timed, state, state0, table, cond, draws
        torch.cuda.empty_cache()
    return out


def pd_kernels(torch, randn, bw: float) -> dict:
    """The sync-BN pair at the roadmap path's per-rank shapes (RM_PAIR):
    the moments kernel and the apply kernel from a world-2 all-reduce's
    sums, each against its plain version, on the float4 path and from an
    offset view (the scalar path, the same bits), a bitwise repeat, mean
    and var the bits of the torch epilogue, each timed against its library
    call in turns, with one launch's floor and the bound."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import (
        bn_apply_sums_plain,
        bn_moments_plain,
    )

    torch_f = torch.nn.functional
    rows = {}
    for family, ((b, f), act) in RM_PAIR.items():
        x = randn(b, f, scale=0.5, shift=0.2)
        gm, bt = randn(f, scale=0.1, shift=1.0), randn(f, scale=0.1)
        xo = offset_view(x, torch)
        stats = torch.empty((2, f), device=x.device)
        require(bn2d.float4_ok(f, x, stats) and not bn2d.float4_ok(f, xo),
                f"pair at [{b},{f}]: x must take the float4 path and its "
                "offset view the scalar one")
        mk, mp = kernels.bn_moments(x), bn_moments_plain(x)
        require(all(within(u, v, 1e-6, 1e-4) for u, v in zip(mk, mp)),
                f"bn_moments disagrees with its plain version at [{b},{f}]")
        require(bitwise_repeat(kernels.bn_moments, [(x,)], torch)
                and all(torch.equal(u, v) for u, v in
                        zip(mk, kernels.bn_moments(xo))),
                f"bn_moments at [{b},{f}]: a repeat or the scalar path gives "
                "other bits")
        noise = randn(2, f, scale=1e-3)
        sums = torch.stack(mp) * DP_WORLD + noise * noise
        ak = kernels.bn_apply_sums(x, sums, DP_WORLD, gm, bt, 1e-5, act)
        ap = bn_apply_sums_plain(x, sums, DP_WORLD, gm, bt, 1e-5, act)
        mo, vo = old_epilogue(sums, DP_WORLD, torch)
        require(within(ak[0], ap[0], 1e-5, 1e-4)
                and torch.equal(ak[1], mo) and torch.equal(ak[2], vo),
                f"bn_apply (from sums) at [{b},{f}] {act} disagrees with its "
                "plain version or the epilogue's bits")
        require(bitwise_repeat(lambda *t: kernels.bn_apply_sums(
            *t, DP_WORLD, gm, bt, 1e-5, act), [(x, sums)], torch)
            and all(torch.equal(u, v) for u, v in zip(
                ak, kernels.bn_apply_sums(xo, sums, DP_WORLD, gm, bt, 1e-5,
                                          act))),
            f"bn_apply at [{b},{f}]: a repeat or the scalar path gives other "
            "bits")
        m_ms, m_lib, m_turns = in_turns(
            lambda: kernels.bn_moments(x),
            lambda: torch.var_mean(x, dim=0, unbiased=False), torch)
        a_ms, a_lib, a_turns = in_turns(
            lambda: kernels.bn_apply_sums(x, sums, DP_WORLD, gm, bt, 1e-5,
                                          act),
            lambda: torch_f.batch_norm(x, mo, vo, gm, bt, training=False,
                                       eps=1e-5), torch)
        floor = floor_ms(1, torch)

        def bound(nbytes, flops):
            t_b, t_o = nbytes / bw * 1e3, flops / PEAK_F32_FLOPS * 1e3
            return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

        mb, mby = bound(4 * b * f + 8 * f, 3 * b * f)
        ab, aby = bound(8 * b * f + 24 * f, 10 * b * f + 5 * f)
        rows[family] = {"shape": [b, f], "act": act, "bn_moments": dict(
            max_abs_err=max(max_err(u, v) for u, v in zip(mk, mp)),
            ms=m_ms, library_ms=m_lib, turns_ms=m_turns,
            plain_ms=time_ms(lambda: bn_moments_plain(x), torch),
            floor_ms=floor, bound_ms=mb, bound_by=mby,
            library_call="torch.var_mean(x, dim=0, unbiased=False)"),
            "bn_apply": dict(
            max_abs_err=max_err(ak[0], ap[0]), ms=a_ms, library_ms=a_lib,
            turns_ms=a_turns,
            plain_ms=time_ms(lambda: bn_apply_sums_plain(
                x, sums, DP_WORLD, gm, bt, 1e-5, act), torch),
            floor_ms=floor, bound_ms=ab, bound_by=aby,
            library_call="F.batch_norm(training=False) on the epilogue's "
            "mean/var, without the epilogue or the activation"),
            "float4_path": True, "bitwise_scalar_path": True,
            "bitwise_repeat": True,
            "gradient": "checked in the pair_dp phase (2 ranks, these "
                        "shapes)"}
    return rows


def pd_program(torch, root: str) -> dict:
    """``roadmap_main --family celeba --n-devices 2`` through its entry
    point in this process (two spawned ranks): PD_MAIN[0] iterations with
    a checkpoint at the end, then ``--resume`` to PD_MAIN[1]: rank 0's
    files, result lines, the checkpoint's mesh spec (2 ranks) and each
    run's launches on rank 0 (one moments and one apply an iteration)."""
    from gan_deeplearning4j_tpu_torch.checkpoint import TrainCheckpointer
    from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
        mesh_spec_dict,
    )
    from gan_deeplearning4j_tpu_torch.train import roadmap_main

    res = f"{root}/celeba_world2"
    stop, total = PD_MAIN

    def run(iters, *extra):
        args = roadmap_main.parse_args(
            ["--family", "celeba", "--n-devices", str(DP_WORLD),
             "--iterations", str(iters), "--print-every", str(PD_MAIN_K),
             "--checkpoint-every", str(stop), "--n-train", str(RM_N_TRAIN),
             "--res-path", res, *extra])
        t0 = time.perf_counter()
        r = roadmap_main.run(args, timeout=DP_TIMEOUT_S)
        return r, time.perf_counter() - t0

    out = {}
    for label, iters, extra, done in (("first", stop, (), stop),
                                      ("resumed", total, ("--resume",),
                                       total - stop)):
        r, secs = run(iters, *extra)
        expected = {k: 0 for k in r["port_launches"]}
        expected["bn_moments"] = expected["bn_apply"] = done
        require(r["steps"] == iters and r["world"] == DP_WORLD
                and not r["graphed"] and r["steps_per_call"] == PD_MAIN_K
                and math.isfinite(r["d_loss"]) and math.isfinite(r["g_loss"])
                and r["examples_per_sec"] > 0
                and r["port_launches"] == expected,
                f"roadmap_main --n-devices {DP_WORLD} ({label}): {r}, "
                f"expected launches {expected}")
        out[label] = dict(seconds=secs, steps=r["steps"],
                          losses=[r["d_loss"], r["g_loss"]],
                          examples_per_sec=r["examples_per_sec"],
                          launches=r["port_launches"],
                          host_seconds=r["host_seconds"])
    ck = TrainCheckpointer(f"{res}/celeba_ckpt", sweep_debris=False)
    # the two runs' step records, each run's goodput record after them
    steps = sorted({json.loads(line)["step"]
                    for line in open(f"{res}/celeba_metrics.jsonl")
                    if '"step"' in line})
    want = sorted([f"celeba_samples_{s}.png"
                   for s in range(PD_MAIN_K, total + 1, PD_MAIN_K)]
                  + ["celeba_metrics.jsonl", "celeba_gen_model.zip",
                     "celeba_dis_model.zip", "celeba_ckpt", "events.jsonl",
                     "run_manifest.json"])
    files = sorted(os.listdir(res))
    require(ck.steps() == [stop, total] and files == want
            and all(ck.mesh_spec(s) == mesh_spec_dict(DP_WORLD)
                    for s in ck.steps())
            and steps == list(range(1, total + 1))
            and out["resumed"]["host_seconds"].get("restore_s") is not None,
            f"roadmap_main --n-devices {DP_WORLD}: checkpoints {ck.steps()}, "
            f"files {files}, metrics steps {steps[:3]}..{steps[-3:]}")
    out.update(checkpoints=ck.steps(), mesh_spec=ck.mesh_spec(total),
               files=files)
    return out


def pd_data_dir(torch, root: str) -> dict:
    """``roadmap_main --family celeba --data-dir`` on the card, when PIL is
    installed: PD_DATA_IMAGES PNGs of synthetic CelebA rows written with
    the port's PNG writer, the table read back (64x64 already: no resize,
    so exactly the PNG bytes / 255 in the tanh range), PD_DATA_ITERS
    graphed iterations.  Without PIL, the reader's ImportError, which
    names --data-dir, and a line saying the run was left out."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.data.datasets import synthetic_celeba
    from gan_deeplearning4j_tpu_torch.eval.plots import png_bytes, to_u8
    from gan_deeplearning4j_tpu_torch.train import roadmap_main

    d = f"{root}/celeba_pngs"
    os.makedirs(d)
    imgs = to_u8((synthetic_celeba(PD_DATA_IMAGES, seed=5)
                  .reshape(-1, 3, 64, 64).transpose(0, 2, 3, 1) + 1) / 2)
    for i, img in enumerate(imgs):
        with open(f"{d}/img_{i:03d}.png", "wb") as f:
            f.write(png_bytes(img))
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        try:
            roadmap_main._data("celeba", PD_DATA_IMAGES, 0, d)
        except ImportError as err:
            require("--data-dir" in str(err),
                    f"--data-dir without PIL: {err}")
            return {"run": False, "reason": f"PIL is not installed on this "
                    f"host ({e}); the reader raised: {err}"}
        raise RuntimeError("chip_smoke: --data-dir read images without PIL")
    x, _ = roadmap_main._data("celeba", 10 * PD_DATA_IMAGES, 0, d)
    want = (imgs.transpose(0, 3, 1, 2).reshape(PD_DATA_IMAGES, -1)
            .astype(np.float32) / 255.0 * 2.0 - 1.0)
    require(x.shape == want.shape and np.array_equal(x, want),
            "--data-dir: the table is not the PNGs' pixels")
    res = f"{root}/celeba_data_dir"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = roadmap_main.run(roadmap_main.parse_args(
        ["--family", "celeba", "--data-dir", d, "--iterations",
         str(PD_DATA_ITERS), "--print-every", str(PD_DATA_ITERS),
         "--res-path", res]))
    secs = time.perf_counter() - t0
    expected = {k: 0 for k in r["port_launches"]}
    expected["bn_act"] = PD_DATA_ITERS + 1  # the warm-up and the replays
    require(r["steps"] == PD_DATA_ITERS and r["graphed"]
            and math.isfinite(r["d_loss"]) and math.isfinite(r["g_loss"])
            and r["port_launches"] == expected
            and os.path.exists(f"{res}/celeba_samples_{PD_DATA_ITERS}.png"),
            f"roadmap_main --data-dir: {r}, expected launches {expected}")
    return {"run": True, "images": PD_DATA_IMAGES, "table_exact": True,
            "iterations": PD_DATA_ITERS, "seconds": secs,
            "launches": r["port_launches"], "losses": [r["d_loss"],
                                                      r["g_loss"]],
            "data_s": r["host_seconds"]["data_s"]}


def pair_dp_phase(torch, smi: str, rm: dict) -> dict:
    """The roadmap families on two ranks (module docstring, phase 12);
    ``rm``: the roadmap phase's line (its one-card graphed ms)."""
    from gan_deeplearning4j_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    ranks = mesh.spawn(pair_dp_rank, DP_WORLD, (), device="cuda",
                       timeout=DP_TIMEOUT_S)
    r0 = ranks[0]
    require(r0["backend"] == ("nccl" if n_cards >= DP_WORLD else "gloo"),
            f"pair_dp: backend {r0['backend']} with {n_cards} cards")
    fams = {}
    for family in RM_FAMILIES:
        per = [r["families"][family] for r in ranks]
        expected = {k: 0 for k in per[0]["launches"]}
        if family != "cgan-cifar10":
            expected["bn_moments"] = expected["bn_apply"] = PD_ITERS
        for rank, p in enumerate(per):
            require(p["launches"] == expected and not p["graphed"],
                    f"pair_dp {family} rank {rank}: launches "
                    f"{p['launches']} != {expected} (graphed {p['graphed']})")
            require(all(math.isfinite(v) for ls in p["losses"] for v in ls),
                    f"pair_dp {family} rank {rank}: losses {p['losses']}")
        require(len({p["digest"] for p in per}) == 1
                and per[0]["losses"] == per[1]["losses"],
                f"pair_dp {family}: the ranks' states differ")
        fams[family] = dict(
            launches_per_rank=[p["launches"] for p in per],
            expected_launches=expected, losses=per[0]["losses"],
            ranks_bitwise=True, vs_single_process=per[0]["vs_single_process"],
            cudnn_off_vs_single_process=per[0]["cudnn_off_vs_single_process"],
            eager_world2_iteration_ms=[p["eager_iteration_ms"] for p in per],
            one_card_graphed_iteration_ms=rm["graph"][family]["plain"][
                "graphed_ms"],
            one_card_eager_iteration_ms=rm["graph"][family]["plain"][
                "eager_ms"])
    t1 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gan4j_pair_dp_")
    try:
        program = pd_program(torch, root)
        t2 = time.perf_counter()
        data_dir = pd_data_dir(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(all(pd_within(f["vs_single_process"],
                          f["cudnn_off_vs_single_process"])
                for f in fams.values()),
            f"pair_dp: world 2 against the single-process pair beyond "
            f"{PD_TOL}: " + str({family: (f["vs_single_process"],
                                          f["cudnn_off_vs_single_process"])
                                for family, f in fams.items()}))
    return {"world": DP_WORLD, "backend": r0["backend"],
            "shared_card": n_cards < DP_WORLD,
            "devices": [r["device"] for r in ranks], "batch": RM_BATCH,
            "iterations": PD_ITERS, "timed_iterations": PD_TIME_ITERS,
            "tolerance": PD_TOL,
            "pair_gradient": [r["pair_gradient"] for r in ranks],
            "families": fams, "program": program, "data_dir": data_dir,
            "seconds_by_part": {"ranks": t1 - t0, "program": t2 - t1,
                                "data_dir": time.perf_counter() - t2},
            "seconds": time.perf_counter() - t0, "nvidia_smi": smi}


# -- the precision phase ------------------------------------------------------

# the JAX package's two precision flags, as runtime policies
PR_MODES = {"bf16": {"matmul_bf16": True}, "mp": {"compute_bf16": True},
            "bf16_mp": {"matmul_bf16": True, "compute_bf16": True}}
# the modes each workload runs in (CV and celeba also both flags at once)
PR_WORKLOADS = {"cv": ("bf16", "mp", "bf16_mp"), "insurance": ("bf16", "mp"),
                "celeba": ("bf16", "mp", "bf16_mp"), "wgan-gp": ("bf16", "mp"),
                "cgan-cifar10": ("bf16", "mp")}
PR_K = 10  # steps (iterations) per graphed call
PR_CALLS = 2  # calls from one start: the graphed-vs-eager and drift runs
# launches per step (iteration) of each port kernel on each path, the JAX
# routing's: the BN carve-out keeps bn_act f32 in every mode; under --mp
# the upsample cotangent is bf16 and takes the plain block sum
PR_PER_STEP = {"cv": {"fused_update": 3, "bn_act": 3, "upsample_bwd": 2},
               "insurance": {"fused_update": 3, "bn_act": 4},
               "celeba": {"bn_act": 1}, "wgan-gp": {"bn_act": 1},
               "cgan-cifar10": {}}
# the CV step's two upsample cotangents (the G-step's backward)
PR_UPSAMPLE = [(BATCH, 128, 14, 14), (BATCH, 64, 28, 28)]
# the card-vs-CPU step's batch (the CPU runs it in the mode and in parity)
PR_CPU_BATCH = 16
PR_PAIR_MODELS = {"celeba": ("dcgan_celeba", "CelebAConfig"),
                  "wgan-gp": ("wgan_gp", "WGANGPConfig"),
                  "cgan-cifar10": ("cgan_cifar10", "CGANConfig")}
PR_CHILD_CGAN = ["--family", "cgan-cifar10", "--iterations", "100",
                 "--n-train", "2000", "--print-every", "50",
                 "--fidelity-steps", "100", "--mp"]


def pr_expected(workload: str, mode: str, steps: int) -> dict:
    """Each port kernel's launches over ``steps`` steps of ``workload``
    under ``mode`` (PR_PER_STEP)."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels

    per = dict(PR_PER_STEP[workload])
    if workload == "cv" and PR_MODES.get(mode, {}).get("compute_bf16"):
        per["upsample_bwd"] = 0
    return {k: per.get(k, 0) * steps for k in kernels.launch_counts()}


def pr_runs(workload: str, torch):
    """(graphed call, eager call, the graph, its generator, the eager
    generator) for ``workload`` at full width on the card under the current
    policy: the trainer's captured step (cv at batch 200, insurance at 50)
    or the pair's captured iteration (batch RM_BATCH), and the same step
    eager from a copy of the graph's start; each call runs PR_K steps and
    returns their losses [PR_K, n] on the host."""
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.runtime import prng
    from gan_deeplearning4j_tpu_torch.train import (
        fused_step,
        insurance_main,
        roadmap_main,
    )
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    if workload in ("cv", "insurance"):
        if workload == "cv":
            trainer = GANTrainer(M.CVConfig(), batch_size=BATCH,
                                 n_train=N_TRAIN, device="cuda",
                                 steps_per_call=PR_K)
        else:
            res = tempfile.mkdtemp(prefix="gan4j_pr_ins_")
            try:
                trainer = GANTrainer(
                    device="cuda",
                    workload=insurance_main.InsuranceWorkload(),
                    config=insurance_main.default_config(
                        res_path=res, batch_size=INS_BATCH, num_iterations=0,
                        print_every=0, save_every=0, metrics=False,
                        steps_per_call=PR_K))
            finally:
                shutil.rmtree(res, ignore_errors=True)
        g = trainer.graphed
        z_e = torch.Generator(device="cuda")
        z_e.set_state(trainer.z_gen.get_state())
        box = {"s": fused_step.clone_state(g.state)}
        step = trainer.step_fn(PR_K)
        inputs = (trainer.features, trainer.labels, trainer.y_real,
                  trainer.y_fake, trainer.ones)

        def eager():
            box["s"], losses = step(box["s"], *inputs, z_gen=z_e)
            return torch.stack(losses, -1).cpu()

        return (lambda: g(PR_K)), eager, g, trainer.z_gen, z_e, box
    pair, cfg, _ = roadmap_main._build(workload, "cuda")
    n_critic = getattr(cfg, "n_critic", 1)
    real_label = getattr(cfg, "real_label", 1.0) if pair.mode == "gan" else 1.0
    x, y = roadmap_main._data(workload, RM_N_TRAIN, prng.NUMBER_OF_THE_BEAST)
    table = torch.from_numpy(x).cuda()
    cond = None if y is None else torch.from_numpy(y).cuda()
    kw = dict(batch_size=RM_BATCH, steps_per_call=PR_K, n_critic=n_critic,
              real_label=real_label, z_size=cfg.z_size)
    z_g = prng.generator(cfg.seed, "roadmap-z", "cuda")
    fg, sg = pair.make_multistep(table, cond, z_gen=z_g, graphed=True, **kw)
    z_e = torch.Generator(device="cuda")
    z_e.set_state(z_g.get_state())
    box = {"s": fused_step.clone_state(sg), "g": sg}
    fe, _ = pair.make_multistep(table, cond, z_gen=z_e, graphed=False, **kw)

    def eager():
        box["s"], (d, gl) = fe(box["s"])
        return torch.stack([d, gl], -1).cpu()

    def graphed():
        box["g"], (d, gl) = fg(box["g"])
        return torch.stack([d, gl], -1).cpu()

    return graphed, eager, fg.graphed, z_g, z_e, box


def pr_graphed_vs_eager(workload: str, mode: str, torch) -> dict:
    """Under ``mode``: PR_CALLS graphed calls of PR_K replays against as
    many eager calls from one start, bit for bit (losses, every leaf of the
    final state, the generators); the eager run's launches (counters zeroed
    just before, read just after) and the graph's per replay, each against
    ``pr_expected``; the graphed losses [PR_CALLS * PR_K, n]; the graphed
    and eager call ms (host clock around a call ending in its readback,
    median over the calls after the first); and, off parity, a replay
    under the parity policy refused."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.runtime import backend
    from gan_deeplearning4j_tpu_torch.train import fused_step

    with backend.configured(**PR_MODES.get(mode, {})):
        graphed, eager, g, z_g, z_e, box = pr_runs(workload, torch)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        le, te = [], []
        for _ in range(PR_CALLS):
            t0 = time.perf_counter()
            le.append(eager())
            te.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        eager_launches = kernels.launch_counts()
        lg, tg = [], []
        for _ in range(PR_CALLS):
            t0 = time.perf_counter()
            lg.append(graphed())
            tg.append(time.perf_counter() - t0)
        state_g = g.state
    # the graph keeps the policy of its capture: a replay under another
    # (here the policy put back) is refused
    refused = None
    if mode != "parity":
        try:
            g(1)
            refused = False
        except ValueError:
            refused = True
    le, lg = torch.cat(le), torch.cat(lg)
    a, b = fused_step._leaves(box["s"]), fused_step._leaves(state_g)
    steps = PR_CALLS * PR_K
    out = dict(
        steps=steps, losses_bitwise=torch.equal(le, lg),
        state_bitwise=a.keys() == b.keys() and all(
            torch.equal(a[k], b[k]) for k in a),
        generator_state_equal=torch.equal(z_e.get_state(), z_g.get_state()),
        losses=lg, eager_launches=eager_launches,
        launches_per_replay=g.launches,
        expected_per_step=pr_expected(workload, mode, 1),
        replay_under_parity_refused=refused,
        graphed_call_ms=statistics.median(tg[1:]) * 1e3 / PR_K,
        eager_call_ms=statistics.median(te[1:]) * 1e3 / PR_K,
        capture=g.setup)
    require(out["losses_bitwise"] and out["state_bitwise"]
            and out["generator_state_equal"],
            f"precision {workload} {mode}: the graphed steps' bits differ "
            f"from the eager ones' (losses max |d| {max_err(le, lg)})")
    require(eager_launches == pr_expected(workload, mode, steps)
            and g.launches == out["expected_per_step"],
            f"precision {workload} {mode}: launches eager {eager_launches}, "
            f"per replay {g.launches}, expected per step "
            f"{out['expected_per_step']}")
    require(bool(torch.isfinite(lg).all()),
            f"precision {workload} {mode}: non-finite losses {lg.tolist()}")
    require(refused is not False, f"precision {workload} {mode}: the graph "
            "replayed under parity")
    del graphed, eager, g, box
    kernels.reset_launch_counts()
    torch.cuda.empty_cache()
    return out


def _lr0(cfg):
    """``cfg`` with every learning rate 0: each update of a step leaves the
    params where they were, so every gradient is taken at the start."""
    import dataclasses

    names = {f.name for f in dataclasses.fields(cfg)}
    return dataclasses.replace(cfg, **{k: 0.0 for k in (
        "learning_rate", "d_learning_rate", "dis_learning_rate",
        "gen_learning_rate") if k in names})


def pr_step_lr0(workload: str, device, torch):
    """One step (iteration) of ``workload`` at full width on ``device``
    under the current policy, learning rates 0, at batch PR_CPU_BATCH (the
    insurance step's own 50), from the seed-666 init and fixed draws made
    on the CPU -> (losses, {leaf: gradient}); the gradient
    read back from the updater state (RmsProp: sqrt(cache), the cache being
    (1 - 1e-8) g^2; Adam: m / (1 - b1))."""
    from gan_deeplearning4j_tpu_torch.train import fused_step, roadmap_main
    from gan_deeplearning4j_tpu_torch.train.gan_pair import Draws, PairState

    gen = torch.Generator().manual_seed(31)
    if workload in ("cv", "insurance"):
        if workload == "cv":
            from gan_deeplearning4j_tpu_torch.data.datasets import (
                synthetic_mnist,
            )
            from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M

            cfg, B = _lr0(M.CVConfig()), PR_CPU_BATCH
            feats, lab = synthetic_mnist(B, seed=11)
            real = torch.from_numpy(feats)
            labels = torch.nn.functional.one_hot(torch.from_numpy(lab),
                                                 10).float()
        else:
            from gan_deeplearning4j_tpu_torch.models import (
                mlpgan_insurance as M,
            )

            cfg, B = _lr0(M.InsuranceConfig()), INS_BATCH
            real = torch.rand((B, 12), generator=gen)
            labels = (torch.rand((B, 1), generator=gen) > 0.5).float()
        d = M.build_discriminator(cfg, device)
        graphs = (d, M.build_generator(cfg, device), M.build_gan(cfg, device),
                  M.build_classifier(d, cfg))
        step = fused_step.make_protocol_step(
            *graphs, M.DIS_TO_GAN, M.GAN_TO_GEN, M.DIS_TO_CLASSIFIER,
            z_size=cfg.z_size, num_features=cfg.num_features)
        host = [real, labels, 1.0 + 0.05 * torch.randn((B, 1), generator=gen),
                0.05 * torch.randn((B, 1), generator=gen), torch.ones((B, 1)),
                torch.rand((B, cfg.z_size), generator=gen) * 2 - 1,
                torch.rand((B, cfg.z_size), generator=gen) * 2 - 1]
        a = [t.to(device) for t in host]
        state, losses = step(fused_step.state_from_graphs(*graphs), *a[:5],
                             z1=a[5], z2=a[6])
        grads = {k: v.double().sqrt().cpu()
                 for k, v in fused_step._leaves(state).items()
                 if k[0].endswith("_opt")}
        return torch.stack(losses).cpu().double(), grads
    import importlib

    from gan_deeplearning4j_tpu_torch.train.gan_pair import GANPair

    mod, cls = PR_PAIR_MODELS[workload]
    M = importlib.import_module(f"gan_deeplearning4j_tpu_torch.models.{mod}")
    cfg = _lr0(getattr(M, cls)())
    if workload == "wgan-gp":
        pair = GANPair(M.build_generator(cfg, device),
                       M.build_critic(cfg, device), mode="wgan-gp",
                       gp_weight=cfg.gp_weight)
    else:
        pair = GANPair(M.build_generator(cfg, device),
                       M.build_discriminator(cfg, device),
                       ms_weight=cfg.ms_weight)
    n_critic = getattr(cfg, "n_critic", 1)
    real_label = getattr(cfg, "real_label", 1.0) if pair.mode == "gan" else 1.0
    x, y = roadmap_main._data(workload, 512, 7)
    draws = pair.draw(torch.Generator().manual_seed(8), 512, PR_CPU_BATCH,
                      n_critic, cfg.z_size, "cpu")
    draws = Draws(*[None if v is None else
                    [t.to(device) for t in v] if isinstance(v, list)
                    else v.to(device) for v in draws])
    state = PairState(pair.gen.params, pair.gen.opt_state, pair.dis.params,
                      pair.dis.opt_state, torch.tensor(0, device=device))
    one = pair.iteration(PR_CPU_BATCH, n_critic, cfg.z_size)
    state, losses = one(state, torch.from_numpy(x).to(device),
                        *pair.label_vectors(PR_CPU_BATCH, real_label),
                        None if y is None else torch.from_numpy(y).to(device),
                        draws=draws)
    b1 = 0.5  # every roadmap family's Adam beta1
    grads = {k[:-1]: v.double().cpu() / (1 - b1)
             for k, v in fused_step._leaves(state).items()
             if k[0].endswith("_opt") and k[-1] == "m"}
    return torch.stack(losses).cpu().double(), grads


def _grad_rel(ref: dict, got: dict) -> float:
    num = sum(float((got[k] - v).square().sum()) for k, v in ref.items())
    den = sum(float(v.square().sum()) for v in ref.values())
    return math.sqrt(num / den)


def pr_card_vs_cpu(workload: str, mode: str, parity_cpu, torch) -> dict:
    """One step (learning rates 0, ``pr_step_lr0``) under ``mode`` on the
    card and on the CPU, and the CPU's parity step (``parity_cpu``), from
    the same params and draws.  The gradients (norm relative over every
    leaf) of the card lie within PR_CARD_RATIO of the mode's own distance
    from parity on the CPU (cuDNN's and the CPU's f32 sums round to bf16
    differently, far less than the mode's roundings move the step); each
    loss within PR_LOSS_REL of the CPU's, relative (one bf16 rounding of a
    loss taken from bf16 activations).  The mode's own loss deviation is
    printed beside it."""
    from gan_deeplearning4j_tpu_torch.runtime import backend

    with backend.configured(**PR_MODES[mode]):
        cpu = pr_step_lr0(workload, "cpu", torch)
        card = pr_step_lr0(workload, "cuda", torch)
    out = {"loss_err": float((card[0] - cpu[0]).abs().max()),
           "loss_dev": float((parity_cpu[0] - cpu[0]).abs().max()),
           "grad_err": _grad_rel(cpu[1], card[1]),
           "grad_dev": _grad_rel(cpu[1], parity_cpu[1]),
           "losses_card": card[0].tolist(), "losses_cpu": cpu[0].tolist()}
    out["loss_rel"] = float(((card[0] - cpu[0]).abs()
                             / cpu[0].abs().clamp_min(1e-6)).max())
    out["grad_ratio"] = out["grad_err"] / max(out["grad_dev"], 1e-30)
    require(bool(torch.isfinite(card[0]).all())
            and out["loss_rel"] <= PR_LOSS_REL
            and out["grad_ratio"] <= PR_CARD_RATIO,
            f"precision {workload} {mode}: the card against the CPU {out}")
    return out


PR_CARD_RATIO = 0.5
PR_LOSS_REL = 2.0 ** -8


def pr_block_sum(torch, bw: float) -> list:
    """The plain bf16 block sum that a ``--mp`` cotangent takes, at the CV
    step's two shapes: its device time beside the f32 kernel's on the f32
    cotangent of the same shape (in turns: kernel, plain, plain, kernel)
    and the bf16 sum's bound (bf16 read once, written once)."""
    from gan_deeplearning4j_tpu_torch.ops.cuda.upsample_bwd import upsample_bwd

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for B, C, H, W in PR_UPSAMPLE:
        g32 = torch.randn((B, C, 2 * H, 2 * W), generator=gen, device="cuda")
        g16 = g32.bfloat16()

        def plain():
            return g16.reshape(B, C, H, 2, W, 2).sum((3, 5))

        kernel_ms, plain_ms, turns = in_turns(
            lambda: upsample_bwd(g32, 2, 2), plain, torch)
        ref = g16.float().reshape(B, C, H, 2, W, 2).sum((3, 5)).bfloat16()
        nbytes = 2 * (g16.numel() + B * C * H * W)
        rows.append(dict(g_shape=[B, C, 2 * H, 2 * W], bf16_plain_ms=plain_ms,
                         f32_kernel_ms=kernel_ms, turns_ms=turns,
                         bf16_bound_ms=nbytes / bw * 1e3,
                         f32_sum_rounded_once=torch.equal(plain(), ref)))
        require(rows[-1]["f32_sum_rounded_once"],
                f"precision: the bf16 block sum of g {rows[-1]['g_shape']} is "
                "not the f32 sum rounded once")
    return rows


def pr_wrappers_refuse_bf16(torch) -> dict:
    """Each f32-only kernel wrapper refuses a bf16 card tensor (TypeError,
    before any launch), so a mode's step that ran through a wrapper gave
    it f32."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels

    x = torch.randn((8, 64), device="cuda").bfloat16()
    f = torch.ones(64, device="cuda")
    calls = {
        "bn_act": lambda: kernels.fused_bn_act_train(x, f, f * 0, 1e-5,
                                                     "relu"),
        "upsample_bwd": lambda: kernels.upsample_bwd(
            x.reshape(2, 4, 8, 8), 2, 2),
        "fused_update": lambda: kernels.fused_rmsprop_chains(
            [x.float()], [x], [x.float()], [None])}
    before = kernels.launch_counts()
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = "accepted"
        except TypeError as e:
            out[name] = f"TypeError: {e}"[:120]
    require(all(v.startswith("TypeError") for v in out.values())
            and kernels.launch_counts() == before,
            f"precision: an f32-only wrapper took bf16: {out}")
    return out


def precision_phase(torch, smi: str, bw: float, beside=None) -> dict:
    """The reference's precision modes on the card (module docstring,
    phase 13).  ``beside``: one more child's function (the extractors'
    recipes), run beside the two children; its result under
    ``beside_result``."""
    t0 = time.perf_counter()
    out = {"wrappers_refuse_bf16": pr_wrappers_refuse_bf16(torch),
           "upsample_bf16_block_sum": pr_block_sum(torch, bw)}
    runs, card = {}, {}
    for workload, modes in PR_WORKLOADS.items():
        runs[workload] = {m: pr_graphed_vs_eager(workload, m, torch)
                          for m in ("parity",) + modes}
        parity_cpu = pr_step_lr0(workload, "cpu", torch)
        card[workload] = {m: pr_card_vs_cpu(workload, m, parity_cpu, torch)
                          for m in modes}
    t1 = time.perf_counter()
    drift = {}
    for workload, res in runs.items():
        ref = res["parity"]["losses"]
        drift[workload] = {m: {
            "max_abs": float((r["losses"] - ref).abs().max()),
            "final": (r["losses"][-1] - ref[-1]).tolist()}
            for m, r in res.items() if m != "parity"}
    out["graphed_vs_eager"] = {w: {m: {k: v for k, v in r.items()
                                       if k != "losses"}
                                   for m, r in res.items()}
                               for w, res in runs.items()}
    out["loss_drift"] = drift
    out["card_vs_cpu"] = card
    root = tempfile.mkdtemp(prefix="gan4j_precision_")
    try:
        # the two children side by side (the script's limit): their
        # seconds are two programs' at once and stand under shared_card;
        # every check on them is a count, a flag or a finite score
        specs = {"roadmap_cgan_mp": (
                     "gan_deeplearning4j_tpu_torch.train.roadmap_main",
                     PR_CHILD_CGAN + ["--res-path", f"{root}/cgan"]),
                 "cv_main_bf16_mp": (
                     "gan_deeplearning4j_tpu_torch.train.cv_main",
                     CV_ARGS + ["--bf16", "--mp", "--res-path",
                                f"{root}/cv"])}
        with concurrent.futures.ThreadPoolExecutor(
                len(specs) + (beside is not None)) as pool:
            extra = pool.submit(beside) if beside is not None else None
            futures = {name: pool.submit(run_child, *spec)
                       for name, spec in specs.items()}
            done = {name: f.result() for name, f in futures.items()}
            out["beside_result"] = extra.result() if extra else None
        children = {}
        for name, (rc, result, secs, tail) in done.items():
            require(rc == 0 and result is not None,
                    f"precision child {name}: exit {rc}, stderr {tail}")
            timed = ("examples_per_sec", "host_seconds", "goodput")
            children[name] = dict(
                result={k: v for k, v in result.items() if k not in timed},
                shared_card=shared_card(
                    [n for n in specs if n != name]
                    + (["the extractors' recipes"] if beside else []),
                    seconds=secs, **{k: result.get(k) for k in timed}))
        cg = done["roadmap_cgan_mp"][1]
        require(cg["precision"] == {"matmul_bf16": False, "compute_bf16": True}
                and cg["steps"] == 100 and cg["graphed"]
                and math.isfinite(cg["d_loss"]) and math.isfinite(cg["g_loss"])
                and 0.0 <= cg["conditional_fidelity"] <= 1.0
                and math.isfinite(cg["mean_class_fid"]),
                f"precision child roadmap_cgan_mp: {cg}")
        cv = done["cv_main_bf16_mp"][1]
        require(cv["precision"] == {"matmul_bf16": True, "compute_bf16": True}
                and cv["steps"] == CV_STEPS and cv["graphed"]
                and all(math.isfinite(cv[k]) for k in (
                    "d_loss", "g_loss", "test_accuracy", "fid_frozen")),
                f"precision child cv_main_bf16_mp: {cv}")
        out["children"] = children
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds_by_part"] = {"steps": t1 - t0,
                              "children": time.perf_counter() - t1}
    out["seconds"] = time.perf_counter() - t0
    out["nvidia_smi"] = smi
    return out


# -- the serve phase ----------------------------------------------------------

SERVE_BUCKETS = (8, 32, 64)  # the DEFAULT_SERVING_BUCKETS
SERVE_ROWS = (1, 5, 8, 32, 64, 70, 130)
# the card against the CPU's eager forward of the same params: f32 on
# both, other convolution code; the generator's sigmoid outputs lie in
# [0, 1], so this is an absolute bound
SERVE_CPU_TOL = 1e-5
# a request served coalesced against the same request served alone:
# bitwise is expected (one bucket's graph, no row coupling); otherwise it
# must stay at float32 ulp scale, the JAX package's own bound (rtol, atol)
SERVE_COALESCE_TOL = (1e-6, 1e-7)
SERVE_COALESCE = ((3, 5), (5, 6), (1, 4, 16, 32), (70,))
# the JAX bench's serving methodology (gan_deeplearning4j_tpu/bench.py
# serve_bench): a geometric ramp to saturation, then stages at 80% of it
SERVE_SATURATION = {"start_rps": 50.0, "growth": 1.6, "stage_s": 2.0,
                    "max_stages": 14}
SERVE_SLO_FRAC = 0.8
SERVE_SLO_STAGES = 5
SERVE_SWAP_S = 2.0  # the load stage a hot swap lands in
SERVE_HANG_DEADLINE_S = 2.0
# run_socket_load through the replica child at 80% of the in-process
# saturation, several times what one replica's gateway answers: the stage
# overloads it and requires every request answered.  A 2 s stage's backlog
# took 10-15 s to drain on an H100 host; at 0.5 s the achieved req/s is not
# a backlogged replica's steady rate (the serve_mesh phase's gateway turns
# time what tracing costs a replica)
SERVE_SOCKET_S = 0.5
SERVE_MIX_SIZES = (1, 4, 16, 48)
SERVE_CHILD_TIMEOUT_S = 180


@contextlib.contextmanager
def untimed_cudnn(torch):
    """This process under cuDNN's untimed deterministic choice (as
    UNTIMED_CHILD puts a child), the parity switches put back after."""
    from gan_deeplearning4j_tpu_torch.runtime import backend

    parity = backend.set_f32_parity

    def untimed():
        parity()
        torch.backends.cudnn.benchmark = False

    backend.set_f32_parity = untimed
    untimed()
    try:
        yield
    finally:
        backend.set_f32_parity = parity
        parity()


def bucket_device_times(torch, infer) -> dict:
    """Each captured bucket's device ms: its graph's replay and the eager
    forward it recorded, on the graph's static inputs (``time_ms``)."""
    out = {}
    for key, cap in sorted(infer._graphs.items()):
        rows = key[0][0]
        out[str(rows)] = {
            "graphed_ms": time_ms(cap.graph.replay, torch),
            "eager_ms": time_ms(lambda c=cap: infer._forward(c.inputs),
                                torch)}
    return out


def serve_timed_times() -> dict:
    """The bucket device times under the port's default (timed) cuDNN
    policy, for a child process: the serve phase itself runs untimed."""
    import numpy as np
    import torch

    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.serve import ServeEngine

    eng = ServeEngine(M.build_generator(device="cuda"),
                      buckets=SERVE_BUCKETS, supervise=False)
    eng.warmup(np.zeros((1, 2), np.float32))
    return {"cudnn_benchmark": torch.backends.cudnn.benchmark,
            "captures": eng.infer.captures,
            "buckets": bucket_device_times(torch, eng.infer)}


def _z(rng, rows):
    return rng.rand(rows, 2).astype("float32") * 2 - 1


def _http(port, method, path, body=None, headers=()):
    """(status, headers, body) of one request on a fresh connection."""
    from http.client import HTTPConnection

    conn = HTTPConnection("127.0.0.1", port, timeout=60.0)
    try:
        conn.request(method, path, body=body, headers=dict(headers))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _npy(x) -> bytes:
    import numpy as np

    buf = io.BytesIO()
    np.save(buf, x, allow_pickle=False)
    return buf.getvalue()


def _slow_body_status(port: int, box: dict) -> None:
    """A slow-loris body: declare 1000 bytes and drip one every 0.05 s
    until the gateway answers (its total read deadline: 408).  The status
    and the seconds go to ``box``.  (A body that stops for longer than
    the gateway's 0.25 s read tick is closed unanswered, as in the JAX
    gateway: CPython refuses to read a socket again after a timeout.)"""
    import select
    import socket

    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port), timeout=30.0) as s:
        s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: 1000\r\n\r\n")
        for _ in range(1000):
            if select.select([s], [], [], 0.05)[0]:
                break
            s.sendall(b" ")
        line = s.makefile("rb").readline().decode("latin-1")
    box["status"] = int(line.split()[1]) if line.startswith("HTTP/") else None
    box["seconds"] = time.perf_counter() - t0


def serve_replica_child(torch, ckpt_dir: str, step: int, ref_eng,
                        rate: float) -> dict:
    """The replica as a user runs it (``python -m ...serve.replica --port
    0 --checkpoint``), under the untimed choice as this process is: its
    ready line, /healthz, replies from the size mix in both encodings
    bitwise ``ref_eng``'s (this process's engine on the same weights),
    the wire contract, /admin/hotswap, ``run_socket_load`` at ``rate``
    and SIGTERM -> exit 0."""
    import signal
    import threading

    import numpy as np

    from gan_deeplearning4j_tpu_torch.serve import (
        GatewayClient,
        GatewayHTTPError,
        run_socket_load,
        z_inputs,
    )

    argv, cwd, env = child_command(
        "gan_deeplearning4j_tpu_torch.serve.replica",
        ["--port", "0", "--checkpoint", ckpt_dir], untimed=True)
    out = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(argv, cwd=cwd, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=err)
        try:
            box = []
            reader = threading.Thread(
                target=lambda: box.append(proc.stdout.readline()),
                daemon=True)
            reader.start()
            reader.join(SERVE_CHILD_TIMEOUT_S)
            err.seek(0)
            require(box and box[0].startswith("{"),
                    f"serve replica: no ready line (exit {proc.poll()}); "
                    f"stderr: {err.read()[-3000:]}")
            ready = json.loads(box[0])
            require(ready["event"] == "replica_ready"
                    and ready["pid"] == proc.pid, f"ready line {ready}")
            port = ready["port"]
            out["ready_s"] = time.perf_counter() - t0
            client = GatewayClient("127.0.0.1", port, retries=0, seed=13)
            health = client.healthz()
            require(health["_status"] == 200 and health["serve"]["ok"],
                    f"serve replica: /healthz {health}")
            # first, while nothing else runs: a drip that stalls for the
            # gateway's 0.25 s read tick is closed, not answered (above)
            loris = {}
            _slow_body_status(port, loris)
            rng = np.random.RandomState(20261018)
            for rows in SERVE_MIX_SIZES:
                z = _z(rng, rows)
                want = ref_eng.generate(z, timeout=120.0)[0]
                for enc in ("json", "npy"):
                    got = client.generate([z], encoding=enc)[0]
                    require(got.dtype == np.float32
                            and np.array_equal(got, want),
                            f"serve replica: {rows} rows over {enc} differ "
                            f"from the in-process engine by "
                            f"{float(np.abs(got - want).max())}")
            status = {}
            conn_headers = (("Content-Type", "application/json"),)
            from http.client import HTTPConnection

            conn = HTTPConnection("127.0.0.1", port, timeout=60.0)
            try:
                conn.putrequest("POST", "/v1/generate")
                conn.putheader("Content-Type", "application/json")
                conn.putheader("Content-Length", str(1 << 30))
                conn.endheaders()
                resp = conn.getresponse()
                status["413"] = (resp.status,
                                 json.loads(resp.read())["type"])
            finally:
                conn.close()
            s, _, body = _http(port, "POST", "/v1/generate",
                               _npy(np.zeros((2, 2), np.float64)),
                               (("Content-Type", "application/x-npy"),))
            status["400"] = (s, json.loads(body)["type"])
            s, _, body = _http(port, "POST", "/v1/nothing", b"{}",
                               conn_headers)
            status["404"] = (s, json.loads(body)["type"])
            s, _, body = _http(port, "GET", "/v1/generate")
            status["405"] = (s, json.loads(body)["type"])
            # 429: admission sheds a request whose estimated wait exceeds
            # its 1 s budget.  One-row requests teach the rate estimate a
            # small rows/s; then bursts of maximal requests arrive.
            shed, attempts = [], []
            for burst in (8, 16, 32):
                for _ in range(20):
                    client.generate([_z(rng, 1)], encoding="npy")
                big = _z(rng, 4096)
                results = []

                def one():
                    try:
                        client.generate([big], encoding="npy")
                        results.append(200)
                    except GatewayHTTPError as e:
                        results.append((e.status, e.error_type,
                                        e.retry_after))

                threads = [threading.Thread(target=one, daemon=True)
                           for _ in range(burst)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(120.0)
                attempts.append({"burst": burst, "ok": results.count(200),
                                 "rejected": len(results)
                                 - results.count(200)})
                shed = [r for r in results if r != 200]
                if shed:
                    break
            require(shed and all(r[0] == 429 and r[1] == "shed"
                                 and r[2] is not None and r[2] >= 1
                                 for r in shed),
                    f"serve replica: no typed 429 from admission: "
                    f"{attempts} {shed[:3]}")
            status["429"] = (shed[0][0], shed[0][1])
            s, _, body = _http(port, "POST", "/admin/hotswap",
                               json.dumps({"directory": ckpt_dir}).encode(),
                               conn_headers)
            require(s == 200 and json.loads(body)["result"] == {"step": step},
                    f"serve replica: /admin/hotswap {s} {body[:200]}")
            slo = run_socket_load(
                GatewayClient("127.0.0.1", port, retries=2, seed=21), rate,
                duration_s=SERVE_SOCKET_S, make_inputs=z_inputs(2, seed=22),
                encoding="npy", seed=23)
            require(slo["errors"] == 0 and slo["undrained"] == 0,
                    f"serve replica: socket load {slo}")
            s, _, _ = _http(port, "POST", "/admin/chaos/wedge",
                            json.dumps({"seconds": 30}).encode(),
                            conn_headers)
            wedged = client.healthz()
            status["503"] = (wedged["_status"],
                             wedged["serve"].get("wedged"))
            status["408"] = (loris.get("status"), loris.get("seconds"))
            want = {"413": (413, "validation"), "400": (400, "validation"),
                    "404": (404, "route"), "405": (405, "method"),
                    "429": (429, "shed"), "503": (503, True)}
            require(all(status[k] == v for k, v in want.items())
                    and loris.get("status") == 408,
                    f"serve replica: wire statuses {status}")
            client.close()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60.0)
            require(rc == 0, f"serve replica: exit {rc} after SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
    out.update({"exit_code_after_sigterm": 0, "statuses": status,
                "shed_attempts": attempts, "hotswap_step": step,
                "replies_bitwise_in_process": True,
                "socket_load": slo, "seconds": time.perf_counter() - t0})
    return out


def serve_phase(torch, smi: str, serve_src: str) -> dict:
    """The serving plane on the card (module docstring, phase 14)."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gan4j_serve_")
    try:
        # the timed policy's bucket times, in a fresh process of its own
        rc, timed, sec, err = run_child_code(
            "import chip_smoke, json; "
            "print(json.dumps(chip_smoke.serve_timed_times()))")
        require(rc == 0 and timed is not None and timed["captures"] == 3
                and timed["cudnn_benchmark"],
                f"serve timed child: exit {rc}, {timed}; stderr: {err}")
        with untimed_cudnn(torch):
            out = _serve(torch, root, serve_src)
        out["timed_policy_child"] = {**timed, "seconds": sec}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    out["nvidia_smi"] = smi
    return out


def run_child_code(code: str):
    """``python -c code`` from this checkout -> (exit code, its last JSON
    line or None, seconds, stderr tail)."""
    argv, root, env = child_command(None, ["-c", code])
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=root, env=env, capture_output=True,
                          text=True, timeout=RES_CHILD_TIMEOUT_S)
    last = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return (proc.returncode, json.loads(last[-1]) if last else None,
            time.perf_counter() - t0, proc.stderr[-3000:])


def _serve(torch, root: str, serve_src: str) -> dict:
    import threading

    import numpy as np

    from gan_deeplearning4j_tpu_torch.checkpoint import TrainCheckpointer
    from gan_deeplearning4j_tpu_torch.graph import serialization
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.parallel.inference import (
        ParallelInference,
    )
    from gan_deeplearning4j_tpu_torch.serve import (
        DispatchError,
        Request,
        ServeEngine,
        measure_saturation,
        run_load,
        z_inputs,
    )
    from gan_deeplearning4j_tpu_torch.serve import engine as engine_mod
    from gan_deeplearning4j_tpu_torch.serve.loadgen import DEFAULT_SIZE_MIX
    from gan_deeplearning4j_tpu_torch.train.watchdog import WatchdogTimeout

    dev = torch.device("cuda")
    out = {"cudnn_policy": "deterministic, untimed (benchmark off), here "
                           "and in the replica child",
           "buckets": list(SERVE_BUCKETS),
           "size_mix": [list(p) for p in DEFAULT_SIZE_MIX]}
    # the serving checkpoint: the resume phase's CV run at its newest
    # verified step, cut to the generator a replica serves ("gen")
    src = TrainCheckpointer(serve_src, sweep_debris=False)
    step = src.latest_verified_step()
    require(step is not None, f"serve: no verified checkpoint in {serve_src}")
    trained = serialization.read_model(f"{serve_src}/ckpt_{step}/gen_model.zip",
                                       dev)
    ckpt_dir = f"{root}/gen_ckpt"
    TrainCheckpointer(ckpt_dir).save(step, {"gen": trained})

    # 1. capture
    gen = M.build_generator(device=dev)
    out["gen_params"] = gen.num_params()
    infer = ParallelInference(gen, buckets=SERVE_BUCKETS)
    eng = ServeEngine(infer=infer)
    with kernels.captured_launches() as in_warmup:
        t1 = time.perf_counter()
        eng.warmup(np.zeros((1, 2), np.float32))
        warmup_s = time.perf_counter() - t1
    require(infer.captures == len(SERVE_BUCKETS),
            f"serve: warm-up captured {infer.captures} graphs")
    out["capture"] = {"captures": infer.captures, "warmup_s": warmup_s,
                      "capture_s": {str(k): v for k, v in
                                    infer.capture_seconds.items()},
                      "pool_bytes": infer.pool_bytes,
                      "launches_in_warmup": in_warmup}

    # 2. the card against the CPU, graphed against eager, coalesced
    # against alone
    rng = np.random.RandomState(20261017)
    cpu = M.build_generator(device="cpu")
    cpu.params = {layer: {n: t.cpu() for n, t in lp.items()}
                  for layer, lp in infer.params.items()}
    cpu_err = {}
    for rows in SERVE_ROWS:
        z = _z(rng, rows)
        card = infer.output(z)[0].cpu()
        ref = cpu.output(torch.from_numpy(z))[0]
        require(tuple(card.shape) == (rows, 1, 28, 28)
                and bool(torch.isfinite(card).all()),
                f"serve: {rows} rows gave {tuple(card.shape)}")
        cpu_err[str(rows)] = max_err(card, ref)
    require(max(cpu_err.values()) <= SERVE_CPU_TOL,
            f"serve: card against CPU {cpu_err} beyond {SERVE_CPU_TOL}")
    for b in SERVE_BUCKETS:
        z = torch.from_numpy(_z(rng, b)).to(dev)
        graphed = infer.output(z)[0]
        eager = gen.output(z, params=infer.params)[0]
        require(torch.equal(graphed, eager),
                f"serve: bucket {b}'s graph differs from its eager forward "
                f"by {max_err(graphed, eager)}")
    coalesced = {}
    for sizes in SERVE_COALESCE:
        reqs = [Request((_z(np.random.RandomState(n), n),)) for n in sizes]
        one = ServeEngine(infer=infer, supervise=False)
        for r in reqs:
            one.admission.submit(r)
        with one:
            got = [r.result(timeout=120.0)[0] for r in reqs]
            batches = one.report()["batches_total"]
        require(batches == 1, f"serve: {sizes} took {batches} batches")
        worst = 0.0
        for n, g in zip(sizes, got):
            alone = infer.output(_z(np.random.RandomState(n), n))[0].cpu()
            worst = max(worst, max_err(torch.from_numpy(g), alone))
            require(within(torch.from_numpy(g), alone,
                           SERVE_COALESCE_TOL[1], SERVE_COALESCE_TOL[0]),
                    f"serve: coalesced {sizes} against alone: {worst}")
        coalesced[str(sizes)] = worst
    out["card_vs_cpu"] = {"max_abs_err": cpu_err, "tolerance": SERVE_CPU_TOL}
    out["graphed_vs_eager_bitwise"] = True
    out["coalesced_vs_alone"] = {"max_abs_err": coalesced,
                                 "bitwise": not any(coalesced.values()),
                                 "tolerance": SERVE_COALESCE_TOL}

    # 3. load: saturation, then the SLO stages at 80% of it, with the
    # port kernels counted around them
    mk = z_inputs(2, seed=20261017)
    eng.start()
    before = eng.stage_report()
    kernels.reset_launch_counts()
    sat = measure_saturation(eng, mk, size_mix=DEFAULT_SIZE_MIX, seed=0,
                             **SERVE_SATURATION)
    require(sat["saturation_rps"] > 0, f"serve: no stage sustained: {sat}")
    rate = SERVE_SLO_FRAC * sat["saturation_rps"]
    slo = [run_load(eng, rate, duration_s=SERVE_SATURATION["stage_s"],
                    make_inputs=mk, seed=100 + i)
           for i in range(SERVE_SLO_STAGES)]
    launches = kernels.launch_counts()
    rep = eng.report()
    after = eng.stage_report()
    require(not any(launches.values()),
            f"serve: port kernels launched under load: {launches}")
    require(all(s["errors"] == 0 and s["undrained"] == 0 for s in slo),
            f"serve: SLO stages {slo}")
    require(infer.captures == len(SERVE_BUCKETS),
            f"serve: {infer.captures - len(SERVE_BUCKETS)} captures under "
            "load")
    batches = after["batches"] - before["batches"]
    cycle = {k: (after[k] - before[k]) / batches * 1e3
             for k in engine_mod.STAGES}

    def med(key):
        vals = [s[key] for s in slo if s[key] is not None]
        return statistics.median(vals) if vals else None

    out["load"] = {
        "saturation_rps": sat["saturation_rps"],
        "saturation_stages": sat["stages_run"],
        "saturation_failed_stage": sat["failed_stage"],
        "slo_rate_rps": rate,
        "p50_ms": med("p50_ms"), "p95_ms": med("p95_ms"),
        "p99_ms": med("p99_ms"),
        "slo_stages": [{k: s[k] for k in (
            "offered_rps", "achieved_rps", "completed", "shed", "errors",
            "p50_ms", "p95_ms", "p99_ms")} for s in slo],
        "batch_fill": rep["batch_fill"],
        "captures_after_warmup": infer.captures - len(SERVE_BUCKETS),
        "launches": launches,
        "host_ms_per_cycle": {**cycle, "total": sum(cycle.values()),
                              "batches": batches},
        "engine": {k: rep[k] for k in ("requests_total", "batches_total",
                                       "shed_total", "rate_rows_per_s",
                                       "timeouts_total")}}

    # 4. a hot swap from the serving checkpoint, under load
    swap = {}

    def swapper():
        time.sleep(SERVE_SWAP_S / 4)
        t = time.perf_counter()
        swap["step"] = eng.hotswap_from(ckpt_dir)
        swap["seconds"] = time.perf_counter() - t

    th = threading.Thread(target=swapper, daemon=True)
    th.start()
    during = run_load(eng, rate, duration_s=SERVE_SWAP_S, make_inputs=mk,
                      seed=300)
    th.join(60.0)
    require(swap.get("step") == step and during["errors"] == 0
            and during["undrained"] == 0
            and infer.captures == len(SERVE_BUCKETS),
            f"serve: hot swap {swap} under load {during}, captures "
            f"{infer.captures}")
    restored = M.build_generator(device=dev)
    TrainCheckpointer(ckpt_dir, sweep_debris=False).restore({"gen": restored})

    def served_shapes_forward(z):
        """The eager forward of ``restored`` at the shapes the engine
        dispatches ``z`` as (its bucket plan, zero rows appended)."""
        segs = eng._plan(len(z))
        zp = np.concatenate([z, np.zeros((sum(segs) - len(z), 2),
                                         np.float32)])
        outs, lo = [], 0
        for seg in segs:
            outs.append(restored.output(
                torch.from_numpy(zp[lo:lo + seg]).to(dev))[0])
            lo += seg
        return torch.cat(outs)[:len(z)].cpu().numpy()

    for rows in SERVE_MIX_SIZES + (70,):
        z = _z(rng, rows)
        got = eng.generate(z, timeout=120.0)[0]
        want = served_shapes_forward(z)
        require(np.array_equal(got, want),
                f"serve: after the swap {rows} rows differ from the new "
                f"params' forward by {float(np.abs(got - want).max())}")
    out["hotswap"] = {"step": step, "swap_s": swap["seconds"],
                      "captures": infer.captures,
                      "load": {k: during[k] for k in (
                          "completed", "shed", "errors", "p99_ms")},
                      "bitwise_new_params": True}
    eng.stop()
    out["device_ms"] = bucket_device_times(torch, infer)

    # 5. an injected hang and an injected raise
    heng = ServeEngine(infer=infer, watchdog_deadline_s=SERVE_HANG_DEADLINE_S)
    hung, release = threading.Event(), threading.Event()

    def hang():
        hung.set()
        while not release.is_set():
            time.sleep(0.05)

    def boom():
        engine_mod._chaos_dispatch_hook = None
        raise RuntimeError("injected dispatch fault")

    faults = {}
    with heng:
        heng.generate(_z(rng, 4), timeout=60.0)
        try:
            engine_mod._chaos_dispatch_hook = hang
            t = time.perf_counter()
            req = heng.submit(_z(rng, 8))
            require(hung.wait(30.0), "serve: the hang hook never ran")
            engine_mod._chaos_dispatch_hook = None
            try:
                req.result(timeout=60.0)
                faults["hang"] = "answered"
            except WatchdogTimeout:
                faults["hang"] = "WatchdogTimeout"
            faults["hang_s"] = time.perf_counter() - t
        finally:
            engine_mod._chaos_dispatch_hook = None
            release.set()
        faults["after_hang_rows"] = heng.generate(
            _z(rng, 4), timeout=60.0)[0].shape[0]
        engine_mod._chaos_dispatch_hook = boom
        try:
            heng.generate(_z(rng, 8), timeout=60.0)
            faults["raise"] = "answered"
        except DispatchError as e:
            faults["raise"] = ("DispatchError"
                               if isinstance(e.__cause__, RuntimeError)
                               else repr(e.__cause__))
        finally:
            engine_mod._chaos_dispatch_hook = None
        faults["after_raise_rows"] = heng.generate(
            _z(rng, 4), timeout=60.0)[0].shape[0]
        hrep = heng.report()
    faults.update(timeouts_total=hrep["timeouts_total"],
                  errors_total=hrep["errors_total"], ok=hrep["ok"],
                  deadline_s=SERVE_HANG_DEADLINE_S)
    require(faults["hang"] == "WatchdogTimeout"
            and faults["hang_s"] <= SERVE_HANG_DEADLINE_S + 1.0
            and faults["raise"] == "DispatchError"
            and faults["after_hang_rows"] == faults["after_raise_rows"] == 4
            and hrep["timeouts_total"] == 1 and hrep["errors_total"] == 1,
            f"serve: faults {faults}")
    out["faults"] = faults

    # 6. the replica as a child process, held against this process's
    # engine on the same (swapped) weights
    ref_eng = ServeEngine(infer=infer, supervise=False)
    with ref_eng:
        out["replica"] = serve_replica_child(torch, ckpt_dir, step, ref_eng,
                                             rate)
    out["launches"] = launches
    return out


# -- the serve_mesh phase -----------------------------------------------------

SM_BUDGET_S = 90.0
SM_SEED = 20261018
SM_REQUESTS = 24  # traced requests of the size mix: half by client, half mesh
SM_WEDGE_S = 2.0
SM_SETTLE_S = 60.0  # the longest wait for a replacement or a deploy
SM_CYCLE_REQUESTS = 2000  # requests queued for each engine turn
# the engine's turns: (recorder, traced requests).  "ring" is a replica's
# default recorder, "file" its ``--events`` one, "off" a recorder that
# records nothing (not the ``serve.dispatch`` span either)
SM_CYCLE_MODES = {"off": ("off", False), "ring": ("ring", False),
                  "ring_traced": ("ring", True),
                  "file_traced": ("file", True)}
SM_CYCLE_TURNS = ("off", "ring", "ring_traced", "file_traced",
                  "file_traced", "ring_traced", "ring", "off")
SM_GW_REQUESTS = 400  # requests over the loopback for each gateway turn
SM_GW_CONNS = 8  # closed-loop keep-alive connections, a thread each
SM_GW_TURNS = ("off", "ring", "file", "file", "ring", "off")


def _sm_wait(pred, timeout_s: float, what: str) -> float:
    """Seconds until ``pred()`` holds, polled every 20 ms (raises past
    ``timeout_s``)."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout_s:
            raise RuntimeError(f"chip_smoke: serve_mesh: no {what} within "
                               f"{timeout_s} s")
        time.sleep(0.02)
    return time.perf_counter() - t0


def _sm_recorder(kind: str, path: str):
    """The recorder of a cost turn: "off" records nothing, "ring" keeps
    the default ring only, "file" writes ``path`` as well."""
    from gan_deeplearning4j_tpu_torch.telemetry import events

    if kind == "off":
        return events.EventRecorder(enabled=False)
    return events.EventRecorder(path=path if kind == "file" else None)


def _sm_spread(turns, key: str) -> dict:
    """Median, least and most of ``key`` over each mode's turns."""
    by = {}
    for t in turns:
        by.setdefault(t["mode"], []).append(t[key])
    return {m: {"median": statistics.median(v), "min": min(v), "max": max(v)}
            for m, v in by.items()}


def sm_cycle_cost(infer, root: str) -> dict:
    """The engine's wall ms per full batch on ``infer`` under each of
    SM_CYCLE_MODES, in turns (SM_CYCLE_TURNS, after one not counted):
    each turn queues SM_CYCLE_REQUESTS requests of the size mix before the
    engine starts (every batch full, ~7.8 requests), then the wall seconds
    until the last is answered over the batches it took (graph replay and
    readback fence included), and the stage sums (``stage_report``) over
    the same batches.  The differences of the modes' medians: the
    ``serve.dispatch`` span (ring - off), a trace on every request as the
    gateway mints one (ring_traced - ring), the file (file_traced -
    ring_traced)."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.serve import (
        AdmissionQueue,
        Request,
        ServeEngine,
    )
    from gan_deeplearning4j_tpu_torch.serve.loadgen import DEFAULT_SIZE_MIX
    from gan_deeplearning4j_tpu_torch.telemetry import events, tracing

    rows, p = zip(*DEFAULT_SIZE_MIX)
    sizes = np.random.RandomState(SM_SEED + 1).choice(
        rows, size=SM_CYCLE_REQUESTS, p=p)
    turns = []
    # a first turn, not counted: the first after the phase's traffic reads
    # slow (1.28 against 0.80 ms on the card, same mode)
    for i, mode in enumerate(("off", *SM_CYCLE_TURNS)):
        kind, traced = SM_CYCLE_MODES[mode]
        path = f"{root}/cycle_{i}.jsonl"
        rec = _sm_recorder(kind, path)
        prev = events.install(rec)
        try:
            eng = ServeEngine(infer=infer, admission=AdmissionQueue(
                max_depth=SM_CYCLE_REQUESTS, deadline_ms=1e9))
            reqs = [Request((_z(np.random.RandomState(j), int(n)),),
                            trace=tracing.mint() if traced else None)
                    for j, n in enumerate(sizes)]
            for r in reqs:
                eng.admission.submit(r)
            t0 = time.perf_counter()
            with eng:
                for r in reqs:
                    r.result(timeout=120.0)
                wall = time.perf_counter() - t0
                st = eng.stage_report()
        finally:
            events.install(prev)
            rec.close()
        if i == 0:
            continue
        batches = st["batches"]
        turns.append({
            "mode": mode, "requests": len(reqs), "batches": batches,
            "wall_ms_per_full_batch": wall / batches * 1e3,
            "stage_ms_per_full_batch": sum(
                v for k, v in st.items() if k != "batches") / batches * 1e3,
            "events_written": (len(events.read_events(path))
                               if kind == "file" else None)})
    wall = _sm_spread(turns, "wall_ms_per_full_batch")

    def added(mode, over):
        return wall[mode]["median"] - wall[over]["median"]

    return {"turns": turns, "wall_ms_per_full_batch": wall,
            "stage_ms_per_full_batch": _sm_spread(
                turns, "stage_ms_per_full_batch"),
            "added_ms_per_full_batch": {
                "dispatch_span": added("ring", "off"),
                "traces_in_ring": added("ring_traced", "ring"),
                "file": added("file_traced", "ring_traced"),
                "file_traced_over_off": added("file_traced", "off")}}


def sm_gateway_cost(infer, root: str) -> dict:
    """Requests a second through an in-process ``Gateway`` over an engine
    on ``infer`` under each recorder, in turns (SM_GW_TURNS, after one not
    counted): SM_GW_CONNS
    threads, each a keep-alive connection, send SM_GW_REQUESTS requests of
    the size mix closed loop.  The gateway mints a trace for every request
    (its own and the engine's ``trace.*`` spans), so "ring" is what a
    replica pays by default, "file" what it pays under ``--events``, and
    "off" the same work recording nothing.  The senders share this
    process; p50 / p99 ms of the requests beside."""
    import threading
    from http.client import HTTPConnection

    import numpy as np

    from gan_deeplearning4j_tpu_torch.serve import (
        AdmissionQueue,
        Gateway,
        Router,
        ServeEngine,
    )
    from gan_deeplearning4j_tpu_torch.serve.loadgen import (
        DEFAULT_SIZE_MIX,
        percentiles,
    )
    from gan_deeplearning4j_tpu_torch.telemetry import events

    rows, p = zip(*DEFAULT_SIZE_MIX)
    rng = np.random.RandomState(SM_SEED + 2)
    bodies = [_npy(_z(rng, int(n)))
              for n in rng.choice(rows, size=SM_GW_REQUESTS, p=p)]
    turns = []
    for i, mode in enumerate(("off", *SM_GW_TURNS)):  # the first not counted
        rec = _sm_recorder(mode, f"{root}/gateway_{i}.jsonl")
        prev = events.install(rec)
        lat, bad = [], []
        try:
            eng = ServeEngine(infer=infer, admission=AdmissionQueue(
                deadline_ms=60_000.0))
            with eng, Gateway(Router([eng])) as gw:
                def send(k):
                    conn = HTTPConnection("127.0.0.1", gw.port, timeout=60.0)
                    try:
                        for body in bodies[k::SM_GW_CONNS]:
                            t = time.perf_counter()
                            conn.request("POST", "/v1/generate", body=body,
                                         headers={"Content-Type":
                                                  "application/x-npy"})
                            resp = conn.getresponse()
                            resp.read()
                            lat.append(time.perf_counter() - t)
                            if resp.status != 200:
                                bad.append(resp.status)
                    finally:
                        conn.close()

                threads = [threading.Thread(target=send, args=(k,))
                           for k in range(SM_GW_CONNS)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t0
        finally:
            events.install(prev)
            rec.close()
        require(not bad and len(lat) == SM_GW_REQUESTS,
                f"serve_mesh: gateway turn {mode}: {len(lat)} answered, "
                f"statuses {bad[:5]}")
        if i == 0:
            continue
        p50, p99 = percentiles([x * 1e3 for x in lat], (50, 99))
        turns.append({"mode": mode, "requests_per_s": SM_GW_REQUESTS / wall,
                      "p50_ms": p50, "p99_ms": p99})
    rps = _sm_spread(turns, "requests_per_s")
    return {"turns": turns, "requests_per_s": rps,
            "p99_ms": _sm_spread(turns, "p99_ms"),
            "ring_over_off": rps["ring"]["median"] / rps["off"]["median"],
            "file_over_off": rps["file"]["median"] / rps["off"]["median"]}


def serve_mesh_phase(torch, smi: str) -> dict:
    """The serving plane across processes, traced (module docstring, phase
    15), each check required."""
    import glob

    import numpy as np

    from gan_deeplearning4j_tpu_torch.checkpoint import TrainCheckpointer
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.parallel.inference import (
        ParallelInference,
    )
    from gan_deeplearning4j_tpu_torch.serve import (
        AdmissionQueue,
        Autoscaler,
        ControlPlane,
        Gateway,
        GatewayClient,
        MeshRouter,
        RemoteReplica,
        ReplicaLauncher,
        Router,
        ServeEngine,
    )
    from gan_deeplearning4j_tpu_torch.serve.loadgen import DEFAULT_SIZE_MIX
    from gan_deeplearning4j_tpu_torch.telemetry import events, tracing
    from gan_deeplearning4j_tpu_torch.telemetry.exporter import (
        MetricsRegistry,
        serve_exporter,
    )
    from gan_deeplearning4j_tpu_torch.testing import chaos

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gan4j_serve_mesh_")
    out = {"nvidia_smi": smi, "buckets": list(SERVE_BUCKETS),
           "size_mix": [list(p) for p in DEFAULT_SIZE_MIX],
           "tolerance": SERVE_CPU_TOL}
    recorder = events.EventRecorder(path=f"{root}/parent.events.jsonl",
                                    ring_size=8192)
    prev = events.install(recorder)
    cp = gw = ref = ref_client = None
    clients = []
    try:
        # the served weights: the generator at full width from a seed,
        # saved by the port's checkpointer; the replicas boot from it and
        # this process serves it through its own engine behind a gateway
        torch.manual_seed(SM_SEED)
        gen = M.build_generator(device="cuda")
        ckpt_dir = f"{root}/gen_ckpt"
        TrainCheckpointer(ckpt_dir).save(1, {"gen": gen})
        infer = ParallelInference(gen, buckets=SERVE_BUCKETS)
        ref = ServeEngine(infer=infer,
                          admission=AdmissionQueue(deadline_ms=60_000.0))
        ref.warmup(np.zeros((1, 2), np.float32))
        ref.start()
        gw = Gateway(Router([ref])).start()
        ref_client = GatewayClient("127.0.0.1", gw.port, retries=0)
        kernels.reset_launch_counts()
        worst = [0.0]

        def check(z, got, what):
            want = ref_client.generate([z], encoding="npy")[0]
            err = float(np.abs(got - want).max())
            worst[0] = max(worst[0], err)
            require(got.shape == want.shape and err <= SERVE_CPU_TOL,
                    f"serve_mesh: {what}: {got.shape} against "
                    f"{want.shape}, max abs err {err}")

        # 1. two replica processes of the CV generator under the control
        # plane, each with --events
        launcher = ReplicaLauncher(
            checkpoint=ckpt_dir, buckets=SERVE_BUCKETS, log_dir=root,
            events_dir=root)
        cp = ControlPlane(launcher, autoscaler=Autoscaler(
            min_replicas=2, max_replicas=2, down_after=10 ** 9),
            tick_s=0.25, hold_ticks=2, max_rollbacks=2,
            p99_floor_ms=10_000.0)
        t1 = time.perf_counter()
        cp.start()
        out["start_s"] = time.perf_counter() - t1
        first = cp.replica_names()
        require(len(first) == 2, f"serve_mesh: started {first}")
        rng = np.random.RandomState(SM_SEED)

        # 3. (first, so that the replica killed has served nothing: a
        # SIGKILLed process loses its unflushed events) a mesh over the
        # two; one request to replica 0, replica 1 SIGKILLed, the next
        # traced request fails over to replica 0
        hosts = [n.rsplit(":", 1) for n in first]
        fmesh = MeshRouter([RemoteReplica(h, int(p)) for h, p in hosts],
                           recheck_s=30.0)
        try:
            z = _z(rng, 4)
            check(z, fmesh.generate([z])[0], "mesh warm request")
            victim = cp.process(first[1])
            t_kill = time.perf_counter()
            chaos.kill_replica_process(victim)
            failover = tracing.mint()
            with events.span("trace.client", trace=failover.trace,
                             span=failover.span):
                got = fmesh.generate([z], trace=failover)[0]
            out["failover_s"] = time.perf_counter() - t_kill
            check(z, got, "failover request")
        finally:
            fmesh.close()
        out["replace_s"] = _sm_wait(
            lambda: (cp.report()["replaced_total"] >= 1
                     and len(cp.replica_names()) == 2
                     and cp.mesh.report()["replicas_healthy"] == 2),
            SM_SETTLE_S, "replacement") + out["failover_s"]
        live = cp.replica_names()
        require(first[1] not in live, f"serve_mesh: {first[1]} still in "
                f"{live} after its kill")

        # 2. traced requests of the size mix over both live replicas:
        # through a client of each (the client mints the root) and through
        # the control plane's mesh (the mesh mints), each output held
        # against the same rows through this process's engine
        clients = [GatewayClient(h, int(p), retries=0)
                   for h, p in (n.rsplit(":", 1) for n in live)]
        rows, p = zip(*DEFAULT_SIZE_MIX)
        sizes = rng.choice(rows, size=SM_REQUESTS, p=p)
        for i, n in enumerate(sizes):
            z = _z(rng, int(n))
            if i % 2:
                got = cp.mesh.generate([z])[0]
            else:
                got = clients[(i // 2) % 2].generate([z], encoding="npy")[0]
            check(z, got, f"{n} rows")
        out["requests"] = {"traced": int(SM_REQUESTS),
                           "rows": [int(n) for n in sizes],
                           "max_abs_err": worst[0]}

        # 4. a replica wedged: ejected by the probe, then re-admitted
        wname = live[0]

        def healthy():
            cp.mesh.poll()  # one probe sweep
            return cp.mesh.report()["replica_ok"][
                cp.mesh.names().index(wname)]

        wh, wp = wname.rsplit(":", 1)
        t_w = time.perf_counter()
        chaos.wedge_replica(wh, int(wp), seconds=SM_WEDGE_S)
        eject_s = _sm_wait(lambda: not healthy(), 10.0,
                           "ejection of the wedged replica")
        z = _z(rng, 4)
        check(z, cp.mesh.generate([z])[0], "request while wedged")
        readmit_s = _sm_wait(healthy, 10.0 + SM_WEDGE_S,
                             "re-admission") + eject_s
        out["wedge"] = {"seconds": SM_WEDGE_S, "eject_s": eject_s,
                        "readmit_s": readmit_s,
                        "wedge_to_readmit_s": time.perf_counter() - t_w}

        # 5. a canary deploy of the checkpoint promotes; a deploy of its
        # poisoned successor rolls back and charges the budget
        def deploy(what):
            t = time.perf_counter()
            cp.deploy(ckpt_dir)
            s = _sm_wait(lambda: cp.deployment_status()["state"]
                         not in ("pending", "canary"), SM_SETTLE_S, what)
            return cp.deployment_status(), s

        promoted, promote_s = deploy("promotion")
        require(promoted["state"] == "promoted" and promoted["step"] == 1,
                f"serve_mesh: clean deploy {promoted}")
        bad = chaos.poison_checkpoint_dir(ckpt_dir)
        rolled, rollback_s = deploy("rollback")
        rep = cp.report()
        require(rolled["state"] == "rolled_back" and rolled["step"] == bad
                and rolled["restored_step"] == 1
                and "non-finite" in rolled["reason"]
                and rep["rollbacks_total"] == 1 and rep["ok"],
                f"serve_mesh: poisoned deploy {rolled}, {rep}")
        for _ in live:
            z = _z(rng, 8)
            check(z, cp.mesh.generate([z])[0], "request after rollback")
        out["canary"] = {"promote_s": promote_s, "rollback_s": rollback_s,
                         "poisoned_step": bad,
                         "restored_step": rolled["restored_step"],
                         "rollbacks_total": rep["rollbacks_total"],
                         "promoted_total": rep["promoted_total"]}

        # 7. the five reports fed to one registry, scraped once
        reg = MetricsRegistry()
        reg.observe_serve(ref.report)
        reg.observe_gateway(gw.report)
        reg.observe_client(ref_client.report)
        reg.observe_serving_mesh(cp.mesh.report)
        reg.observe_controlplane(cp.report)
        stop_exporter = serve_exporter(reg, 0)
        try:
            got = http_get(f"http://127.0.0.1:{stop_exporter.port}/metrics")
        finally:
            stop_exporter()
        require(got is not None and got[0] == 200,
                f"serve_mesh: /metrics answered {got}")
        text = got[1].decode()
        series = {s: prom_value(text, s) for s in (
            "gan4j_serve_requests_total", "gan4j_serve_batch_fill",
            "gan4j_gateway_requests_total", "gan4j_client_reused_total",
            "gan4j_mesh_replicas", "gan4j_mesh_replicas_healthy",
            "gan4j_mesh_ejected_total", "gan4j_controlplane_replicas",
            "gan4j_controlplane_replaced_total",
            "gan4j_controlplane_rollbacks_total")}
        require(all(series[s] for s in (
            "gan4j_serve_requests_total", "gan4j_serve_batch_fill",
            "gan4j_gateway_requests_total")),
            f"serve_mesh: serving series {series}")
        out["scrape"] = series
        spawned = [e for e in recorder.recent()
                   if e["name"] == "controlplane.replica_spawned"]
        out["ready_s"] = [e["ready_s"] for e in spawned]
    finally:
        for c in clients:
            c.close()
        if cp is not None:
            cp.stop()  # SIGTERM: each replica flushes its events' tail
        if ref_client is not None:
            ref_client.close()
        if gw is not None:
            gw.stop()
        if ref is not None:
            ref.stop()
        events.install(prev)
        recorder.close()
    try:
        launches = kernels.launch_counts()
        # 6. the per-process files merged into one timeline
        files = [f"{root}/parent.events.jsonl"] + sorted(
            glob.glob(f"{root}/replica_*.events.jsonl"))
        merged = tracing.merge_trace_files(files,
                                           include_events=("controlplane.",))
        stats = merged["stats"]
        tr = merged["traces"].get(failover.trace, {})
        hops = [s for s in tr.get("spans", []) if s["name"] == "trace.hop"]
        stopped = [e for f in files[1:] for e in events.read_events(f)
                   if e["name"] == "replica.stopped"]
        for e in stopped:
            for k, v in e["port_launches"].items():
                launches[k] += v
        require(stats["traces"] >= SM_REQUESTS + 2
                and stats["complete"] == stats["traces"],
                f"serve_mesh: trace trees {stats}")
        require(tr.get("complete") and len(tr["processes"]) >= 2
                and len(hops) == 2
                and sum("error" in h for h in hops) == 1,
                f"serve_mesh: the failover trace {tr}")
        require(len(stopped) == 2 and not any(launches.values()),
                f"serve_mesh: replicas stopped {len(stopped)}, port "
                f"kernels launched {launches}")
        require(len(out["ready_s"]) == 3,
                f"serve_mesh: spawns {out['ready_s']}")
        out["traces"] = {k: stats[k] for k in (
            "files", "segments", "spans", "traces", "complete",
            "complete_frac", "cross_process", "errors", "timeline_events",
            "stage_p50_ms")}
        out["failover_trace"] = {"processes": len(tr["processes"]),
                                 "spans": len(tr["spans"]),
                                 "hops": [h.get("error") is not None
                                          for h in hops]}
        out["launches"] = launches
        # 8. what tracing costs: the engine's ms per full batch and the
        # gateway's requests a second under each recorder, in turns
        out["cycle"] = sm_cycle_cost(infer, root)
        out["gateway_cost"] = sm_gateway_cost(infer, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


# -- the supervision phase ----------------------------------------------------

# the card's first telemetry block against the CPU's from the same start and
# draws: each norm and ratio within SV_TOL of the CPU's value (relative);
# the NaN/Inf count exactly (the card's f32 sums run in other orders, and a
# step's params differ by up to STEP_TOL's 4e-3)
SV_TOL = 1e-3
SV_TURN_CALLS = 5  # calls of MAIN_K steps in one timed turn
# the insurance program streamed on the card: 400 steps, K = 10,
# checkpoints every 50, dumps every 100; its first training iterator is
# wrapped by a fault source (the NaN run, the scaled-rows run) or its
# readbacks hang once (the hang run)
SV_INS = ["--iterations", "400", "--steps-per-call", "10",
          "--checkpoint-every", "50", "--print-every", "100",
          "--save-every", "100"]
SV_INS_STEPS = 400
SV_NAN_AT = 130  # the 131st batch carries a NaN: step 131 goes bad
SV_HANG_AT = 15  # the 16th readback (steps 151-160) hangs
SV_HANG_DEADLINE_S = 2.0
SV_SCALE_AT, SV_SCALE = 150, 1e3  # rows x 1e3 from the 151st batch
# the healthy CV program: the cv_main phase's run with every alarm and the
# watchdog armed, no FID
SV_CV_ARGS = CV_ARGS[:-1] + ["0", "--steps-per-call", str(CV_K),
                             "--telemetry", "--nan-alarm", "abort",
                             "--divergence", "--watchdog"]
SV_DP_STEPS = 4  # the dp phase's telemetry steps per rank
# the world-2 rollback (the dp phase's ranks): the CV protocol step at
# global batch 200, streamed in f32 (no u8 codec, which would not carry a
# NaN), one step a call, a checkpoint every RB_CKPT steps, RB_STEPS steps;
# the first incarnation's RB_NAN_AT-th batch (0-based) carries a NaN
RB_STEPS = 3
RB_CKPT = 2
RB_NAN_AT = 2  # step 3 goes bad; the heal restores step 2 and redoes 3
RB_RESTORED = 2
RB_EXECUTED = RB_NAN_AT + 1 + RB_STEPS - RB_RESTORED  # steps run per rank


def sv_config(**kw):
    """The bare loop's config (``GANTrainer(cfg, batch_size=...)``) at the
    main phase's batch and K, with ``kw`` on top."""
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainerConfig

    cfg = M.CVConfig()
    fields = dict(
        dataset_name="mnist", num_features=cfg.num_features,
        label_index=cfg.num_features, num_classes=cfg.num_classes,
        batch_size=BATCH, batch_size_pred=500, num_iterations=0,
        num_gen_samples=10, z_size=cfg.z_size, print_every=0, save_every=0,
        seed=cfg.seed, res_path=None, steps_per_call=MAIN_K, metrics=False)
    fields.update(kw)
    return GANTrainerConfig(**fields)


def state_to(state, dev):
    """A step state's tensors on ``dev`` (trees of any depth)."""
    def move(v):
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        return v.to(dev) if hasattr(v, "to") else v

    return type(state)(*(move(v) for v in state))


def sv_world2(group) -> dict:
    """The dp phase's telemetry run on one rank: SV_DP_STEPS steps of the
    CV trainer with ``telemetry`` on the group (eager), the counters zeroed
    just before and read just after; the block's records and a digest of
    them (the ranks must agree: the block is computed from the reduced
    gradients)."""
    import torch

    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.train.fused_step import TELEMETRY_KEYS
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    trainer = GANTrainer(M.CVConfig(), n_train=N_TRAIN, group=group,
                         config=sv_config(telemetry=True, steps_per_call=1))
    kernels.reset_launch_counts()
    result = trainer.train(SV_DP_STEPS, log=None)
    torch.cuda.synchronize(group.device)
    launches = kernels.launch_counts()
    blocks = [[r[k] for k in TELEMETRY_KEYS]
              for r in trainer.metrics.records() if "step" in r]
    return {"launches": launches, "steps": result["steps"],
            "blocks": blocks,
            "digest": hashlib.sha256(json.dumps(blocks).encode()).hexdigest()}


def rb_world2(group, root: str) -> dict:
    """The world-2 rollback on one rank (module docstring, phases 7 and
    16): ``nan_alarm="rollback"`` through ``run_with_recovery`` as the
    mains run it under a group, the first incarnation's training iterator
    wrapped by a ``NanSource``; the counters zeroed just before and read
    just after; the seconds from the rollback's raise to the first healed
    step's boundary, the rank's budget, LR scale, latent lineage and final
    state digest."""
    import dataclasses

    import torch

    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.testing import NanSource
    from gan_deeplearning4j_tpu_torch.train import gan_trainer
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import (
        GANTrainer,
        run_with_recovery,
    )

    config = sv_config(
        telemetry=True, nan_alarm="rollback", checkpoint_every=RB_CKPT,
        num_iterations=RB_STEPS, steps_per_call=1, res_path=root,
        data_on_device=False, use_data_codec=False)
    orig_iter = gan_trainer.RecordReaderDataSetIterator
    orig_rollback = GANTrainer._maybe_rollback
    orig_book = GANTrainer._boundary_bookkeeping
    built, marks = [], {"raised": None, "healed": None, "boundaries": []}

    def first_wrapped(*a, **kw):
        it = orig_iter(*a, **kw)
        built.append(it)
        return NanSource(it, nan_at=RB_NAN_AT) if len(built) == 1 else it

    def maybe_rollback(self):
        try:
            orig_rollback(self)
        except Exception:
            marks["raised"] = time.perf_counter()
            raise

    def boundary(self):
        if marks["raised"] is not None and marks["healed"] is None:
            marks["healed"] = time.perf_counter()
        marks["boundaries"].append(self.steps)
        orig_book(self)

    def make_trainer(resume, manager):
        c = dataclasses.replace(config, resume=True) if resume else config
        t = GANTrainer(M.CVConfig(), n_train=N_TRAIN, group=group, config=c,
                       rollback_manager=manager)
        # the alarm trips at the bad step's own boundary
        t.metrics.flush_every = 1
        return t

    gan_trainer.RecordReaderDataSetIterator = first_wrapped
    GANTrainer._maybe_rollback = maybe_rollback
    GANTrainer._boundary_bookkeeping = boundary
    # the run's end writes no model zips (the checkpoints hold the state;
    # the observability phase's turns skip them the same way)
    save = GANTrainer.save_models
    GANTrainer.save_models = lambda self: None
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer, result = run_with_recovery(make_trainer, config, log=None)
        torch.cuda.synchronize(group.device)
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        gan_trainer.RecordReaderDataSetIterator = orig_iter
        GANTrainer._maybe_rollback = orig_rollback
        GANTrainer._boundary_bookkeeping = orig_book
        GANTrainer.save_models = save
    mgr = trainer._rollback_mgr
    return {"rank": group.rank, "launches": launches,
            "steps": result["steps"], "boundaries": marks["boundaries"],
            "rollbacks": mgr.total, "attempts": mgr.attempts,
            "lr_scale": mgr.lr_scale,
            "z_gen": hashlib.sha256(
                trainer.z_gen.get_state().cpu().numpy().tobytes()
            ).hexdigest(),
            "losses": [result[k] for k in ("d_loss", "g_loss", "clf_loss")],
            "digest": state_digest(trainer.state),
            "heal_s": marks["healed"] - marks["raised"]
            if marks["healed"] is not None and marks["raised"] else None,
            "seconds": seconds}


def sv_telemetry(torch) -> dict:
    """The CV protocol step at batch 200 with its telemetry block, captured
    (module docstring, phase 16): 2 graphed calls of MAIN_K steps against
    the same run without the block (losses and state bitwise) and against
    the eager step from the graph's start (every column and the state
    bitwise), the counters around the graphed calls, the first step's block
    against the CPU's from the same start and draws, and the graphed step's
    ms with and without the block in turns (on, off, off, on)."""
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.train import fused_step
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    cfg = M.CVConfig()
    on = GANTrainer(cfg, n_train=N_TRAIN, device="cuda",
                    config=sv_config(telemetry=True))
    off = GANTrainer(cfg, n_train=N_TRAIN, device="cuda", config=sv_config())
    g_on, g_off = on.graphed, off.graphed
    # the eager run and the CPU step from the graph's start: a copy of the
    # static state, a generator at the graph generator's state
    start = fused_step.clone_state(g_on.state)
    z_gen = torch.Generator(device="cuda")
    z_gen.set_state(on.z_gen.get_state())
    z_first = torch.Generator(device="cuda")
    z_first.set_state(on.z_gen.get_state())
    z1 = torch.rand((BATCH, cfg.z_size), generator=z_first,
                    device="cuda") * 2 - 1
    z2 = torch.rand((BATCH, cfg.z_size), generator=z_first,
                    device="cuda") * 2 - 1
    inputs = (on.features, on.labels, on.y_real, on.y_fake, on.ones)
    box = {"state": fused_step.clone_state(start)}
    eager_step = on.step_fn(MAIN_K)

    def eager():
        box["state"], out = eager_step(box["state"], *inputs, z_gen=z_gen)
        return fused_step.pack_outputs(out).reshape(MAIN_K, -1).cpu()

    calls = GRAPH_STEPS // MAIN_K
    le = torch.cat([eager() for _ in range(calls)])
    kernels.reset_launch_counts()
    lg = torch.cat([g_on(MAIN_K) for _ in range(calls)])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    lo = torch.cat([g_off(MAIN_K) for _ in range(calls)])
    # the states after the same GRAPH_STEPS steps (the timed turns below
    # advance the graphs further)
    digests = {"on": state_digest(g_on.state), "off": state_digest(g_off.state),
               "eager": state_digest(box["state"])}
    n_cols = 3 + len(fused_step.TELEMETRY_KEYS)
    expected = {"fused_update": 3 * GRAPH_STEPS, "bn_act": 3 * GRAPH_STEPS,
                "upsample_bwd": 2 * GRAPH_STEPS, "bn_moments": 0,
                "bn_apply": 0, "bn_act_4d": 0, "bn_act_tenants": 0,
                "bn_act_tenants_bwd": 0}
    _, tel = fused_step.unpack_rows(lg)
    # the CPU's first step from the same start, draws and targets
    d = M.build_discriminator(cfg, "cpu")
    cpu_graphs = (d, M.build_generator(cfg, "cpu"), M.build_gan(cfg, "cpu"),
                  M.build_classifier(d, cfg))
    cpu_step = fused_step.make_protocol_step(
        *cpu_graphs, M.DIS_TO_GAN, M.GAN_TO_GEN, M.DIS_TO_CLASSIFIER,
        z_size=cfg.z_size, num_features=cfg.num_features, telemetry=True)
    _, (_, cpu_tel) = cpu_step(state_to(start, "cpu"),
                               *(t.cpu() for t in inputs), z1=z1.cpu(),
                               z2=z2.cpu())
    card_vs_cpu = {k: abs(tel[k][0] - float(cpu_tel[k]))
                   / max(abs(float(cpu_tel[k])), 1e-30)
                   for k in fused_step.TELEMETRY_KEYS if k != "nonfinite"}

    def turn(graphed):
        times = []
        for _ in range(SV_TURN_CALLS):
            t0 = time.perf_counter()
            graphed(MAIN_K)
            times.append(time.perf_counter() - t0)
        return statistics.median(times) / MAIN_K * 1e3

    turns = [turn(g_on), turn(g_off), turn(g_off), turn(g_on)]
    res = dict(
        steps=GRAPH_STEPS, steps_per_call=MAIN_K, columns=n_cols,
        ring_shape=list(g_on.losses.shape),
        losses_bitwise_off=torch.equal(lg[:, :3], lo),
        digest_on=digests["on"], digest_off=digests["off"],
        block_bitwise_eager=torch.equal(le, lg),
        digest_eager=digests["eager"],
        launches=launches, expected_launches=expected,
        launches_per_replay=g_on.launches,
        block_first=[float(v) for v in lg[0, 3:]],
        block_last=[float(v) for v in lg[-1, 3:]],
        nonfinite=max(tel["nonfinite"]),
        cpu_block=[float(cpu_tel[k]) for k in fused_step.TELEMETRY_KEYS],
        card_vs_cpu_rel=card_vs_cpu, tolerance=SV_TOL, turns_ms=turns,
        on_ms=(turns[0] + turns[3]) / 2, off_ms=(turns[1] + turns[2]) / 2,
        setup_on=g_on.setup, setup_off=g_off.setup)
    res["cost_ms"] = res["on_ms"] - res["off_ms"]
    require(tuple(g_on.losses.shape) == (MAIN_K, n_cols)
            and tuple(lg.shape) == (GRAPH_STEPS, n_cols),
            f"supervision: the ring is {tuple(g_on.losses.shape)}")
    require(res["losses_bitwise_off"]
            and res["digest_on"] == res["digest_off"],
            "supervision: the step with its telemetry block differs from the "
            "step without it (the block must only read)")
    require(res["block_bitwise_eager"]
            and res["digest_eager"] == res["digest_on"],
            "supervision: the graphed block differs from the eager step's "
            f"(max |d| {max_err(le, lg)})")
    require(launches == expected, f"supervision: launch counts {launches} "
            f"!= expected {expected}")
    require(bool(torch.isfinite(lg).all()) and res["nonfinite"] == 0.0,
            "supervision: a non-finite block on a healthy run")
    require(float(cpu_tel["nonfinite"]) == 0.0
            and all(v <= SV_TOL for v in card_vs_cpu.values()),
            f"supervision: card vs CPU block {card_vs_cpu} > {SV_TOL}")
    del on, off, g_on, g_off, box
    torch.cuda.empty_cache()
    return res


class SvScaled:
    """Rows (features and label) scaled by ``factor`` from the ``at``-th
    batch on: the discriminator's input BN normalizes the features back,
    the classifier's label blows its loss up."""

    def __init__(self, source, at, factor):
        self.source, self.at, self.factor, self.n = source, at, factor, 0

    def has_next(self):
        return self.source.has_next()

    def reset(self):
        return self.source.reset()

    def next(self):
        import numpy as np

        ds = self.source.next()
        if self.n >= self.at:
            ds.features = np.asarray(ds.features) * self.factor
            ds.labels = np.asarray(ds.labels) * self.factor
        self.n += 1
        return ds

    def __getattr__(self, name):
        return getattr(self.source, name)


def sv_insurance(root: str, name: str, flags, wrap=None) -> dict:
    """``insurance_main`` on the card, streamed (``data_on_device=False``:
    the source is read while the run trains), at SV_INS plus ``flags``,
    its first training iterator wrapped by ``wrap``; prunes of the
    checkpoint directory are recorded.  -> {dir, trainer, result (or the
    exception it raised), events, pruned, seconds}."""
    from gan_deeplearning4j_tpu_torch.checkpoint import TrainCheckpointer
    from gan_deeplearning4j_tpu_torch.telemetry.events import read_events
    from gan_deeplearning4j_tpu_torch.train import gan_trainer, insurance_main

    d = f"{root}/{name}"
    orig_iter = gan_trainer.RecordReaderDataSetIterator
    orig_prune = TrainCheckpointer.prune_above
    built, pruned = [], []

    def first_wrapped(*a, **kw):
        it = orig_iter(*a, **kw)
        built.append(it)
        return wrap(it) if wrap is not None and len(built) == 1 else it

    def prune_above(self, step):
        out = orig_prune(self, step)
        pruned.append((step, out))
        return out

    gan_trainer.RecordReaderDataSetIterator = first_wrapped
    TrainCheckpointer.prune_above = prune_above
    out = {"dir": d, "trainer": None}
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                out["trainer"], out["result"] = insurance_main.run(
                    insurance_main.parse_args(
                        SV_INS + list(flags) + ["--res-path", d]),
                    data_on_device=False)
            except Exception as e:  # the caller requires the class it expects
                out["error"] = e
    finally:
        gan_trainer.RecordReaderDataSetIterator = orig_iter
        TrainCheckpointer.prune_above = orig_prune
    out["seconds"] = time.perf_counter() - t0
    out["events"] = read_events(f"{d}/events.jsonl")
    out["pruned"] = pruned
    return out


def _named(evs, name):
    return [e for e in evs if e["name"] == name]


def sv_nan(root: str) -> dict:
    """The NaN run: one NaN in the 131st batch; the alarm trips at the next
    flush, the run rolls back to the newest checkpoint before step 131
    (100), prunes the poisoned one after it (150), re-captures its step,
    and finishes its 400 steps."""
    import math

    from gan_deeplearning4j_tpu_torch.testing import NanSource

    run = sv_insurance(root, "nan", ["--telemetry", "--nan-alarm",
                                     "rollback"],
                       lambda it: NanSource(it, nan_at=SV_NAN_AT))
    require("error" not in run, f"supervision nan: {run.get('error')!r}")
    res, evs, trainer = run["result"], run["events"], run["trainer"]
    alarm, request = _named(evs, "alarm.nan"), _named(evs, "rollback.request")
    restore = _named(evs, "rollback.restore")
    out = dict(
        steps=res["steps"], seconds=run["seconds"],
        alarm=[{k: e.get(k) for k in ("step", "action")} for e in alarm],
        request=[{k: e.get(k) for k in ("step", "bad_step", "rollbacks",
                                         "lr_scale")} for e in request],
        restore=[{k: e.get(k) for k in ("step", "bad_step", "lr_scale")}
                 for e in restore],
        pruned=run["pruned"], starts=len(_named(evs, "train.start")),
        recapture_s=trainer.timings.get("capture_s"),
        graphed=res["graphed"], steps_per_call=res["steps_per_call"],
        resident=res["resident"], losses=[res["d_loss"], res["g_loss"]],
        flight_record=os.path.exists(
            f"{run['dir']}/flight_record_rollback.json"))
    bad = SV_NAN_AT + 1
    require(res["steps"] == SV_INS_STEPS and res["graphed"]
            and not res["resident"]
            and all(math.isfinite(v) for v in out["losses"]),
            f"supervision nan: {out}")
    require(len(alarm) == len(request) == len(restore) == 1
            and alarm[0]["step"] == request[0]["bad_step"] == bad
            and restore[0]["bad_step"] == bad
            and restore[0]["step"] < bad and restore[0]["lr_scale"] == 0.5
            and out["starts"] == 2 and out["flight_record"],
            f"supervision nan: the rollback's timeline {out}")
    require(out["pruned"] and out["pruned"][0][0] == restore[0]["step"]
            and out["pruned"][0][1],
            f"supervision nan: no poisoned checkpoint pruned {out['pruned']}")
    require(isinstance(out["recapture_s"], float) and out["recapture_s"] > 0,
            "supervision nan: the fresh incarnation did not capture")
    return out


def sv_hang(root: str) -> dict:
    """The hang run: the 16th readback never completes; the watchdog (fixed
    deadline) raises ``WatchdogTimeout`` on the training thread, the
    recovery wrapper restarts from the checkpoint at 150, and the run
    finishes.  Reports the seconds from the hang to the raise."""
    from gan_deeplearning4j_tpu_torch.testing import ReadbackHang

    with ReadbackHang(SV_HANG_AT) as hang:
        run = sv_insurance(root, "hang", [
            "--watchdog", "--watchdog-deadline", str(SV_HANG_DEADLINE_S),
            "--max-restarts", "1"])
    require("error" not in run, f"supervision hang: {run.get('error')!r}")
    evs = run["events"]
    timeout = _named(evs, "watchdog.timeout")
    out = dict(
        steps=run["result"]["steps"], seconds=run["seconds"],
        fired=hang.fired,
        hang_to_raise_s=(None if hang.t_raised is None
                         else hang.t_raised - hang.t_hung),
        deadline_s=SV_HANG_DEADLINE_S,
        timeout=[{k: e.get(k) for k in ("step", "region", "age_s",
                                         "deadline_s")} for e in timeout],
        restarts=len(_named(evs, "recovery.restart")),
        starts=len(_named(evs, "train.start")),
        flight_records=sorted(f for f in os.listdir(run["dir"])
                              if f.startswith("flight_record_")))
    require(out["steps"] == SV_INS_STEPS and hang.fired
            and out["hang_to_raise_s"] is not None
            and SV_HANG_DEADLINE_S <= out["hang_to_raise_s"]
            <= SV_HANG_DEADLINE_S + 10,
            f"supervision hang: {out}")
    require(len(timeout) == 1 and timeout[0]["region"] == "readback"
            and out["restarts"] == 1 and out["starts"] == 2
            and "flight_record_watchdog_timeout.json" in out["flight_records"],
            f"supervision hang: the timeline {out}")
    return out


def sv_divergence(root: str) -> dict:
    """The scaled-rows run: rows x 1e3 from the 151st batch, ``--divergence
    --nan-alarm abort``: the sentinel trips on the classifier's exploding
    series with every value finite, and the abort is fatal (no restart)."""
    from gan_deeplearning4j_tpu_torch.train.divergence import DivergenceError

    run = sv_insurance(root, "divergence",
                       ["--telemetry", "--divergence", "--nan-alarm", "abort",
                        "--max-restarts", "2"],
                       lambda it: SvScaled(it, SV_SCALE_AT, SV_SCALE))
    err = run.get("error")
    evs = run["events"]
    trip = _named(evs, "alarm.divergence")
    out = dict(error=repr(err), seconds=run["seconds"],
               trip=[{k: e.get(k) for k in ("step", "key", "value",
                                             "baseline", "action")}
                     for e in trip],
               starts=len(_named(evs, "train.start")),
               nan_alarms=len(_named(evs, "alarm.nan")),
               flight_record=os.path.exists(
                   f"{run['dir']}/flight_record_divergence.json"))
    require(isinstance(err, DivergenceError),
            f"supervision divergence: the run ended with {err!r}")
    require(len(trip) == 1 and trip[0]["step"] > SV_SCALE_AT
            and trip[0]["key"] in ("classifier_loss", "clf_grad_norm")
            and abs(trip[0]["value"]) > 20 * trip[0]["baseline"]
            and out["starts"] == 1 and out["flight_record"],
            f"supervision divergence: {out}")
    return out


def sv_healthy(torch, root: str) -> dict:
    """The healthy CV program (SV_CV_ARGS: every alarm, the sentinel and
    the auto-deadline watchdog armed, 200 steps at K = 100): no alarm, no
    trip, no timeout; every record carries a finite block, count 0; the
    launch counters around it exact."""
    import math

    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.telemetry.events import read_events
    from gan_deeplearning4j_tpu_torch.train import cv_main
    from gan_deeplearning4j_tpu_torch.train.fused_step import TELEMETRY_KEYS

    d = f"{root}/healthy"
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        _, res = cv_main.run(cv_main.parse_args(SV_CV_ARGS + ["--res-path", d]))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    calls = CV_STEPS + 1  # the warm-up step, then a replay per step
    expected = {"fused_update": 3 * calls, "bn_act": 3 * calls,
                "upsample_bwd": 2 * calls, "bn_moments": 0, "bn_apply": 0,
                "bn_act_4d": 0, "bn_act_tenants": 0,
                "bn_act_tenants_bwd": 0}
    names = [e["name"] for e in read_events(f"{d}/events.jsonl")]
    recs = step_records(f"{d}/mnist_metrics.jsonl")
    out = dict(steps=res["steps"], steps_per_call=res["steps_per_call"],
               graphed=res["graphed"], seconds=time.perf_counter() - t0,
               events=sorted(set(names)), records=len(recs),
               launches=launches, expected_launches=expected,
               max_grad_norm={k: max(r[k] for r in recs) for k in (
                   "d_grad_norm", "g_grad_norm", "clf_grad_norm")})
    require(res["steps"] == CV_STEPS and res["graphed"]
            and res["steps_per_call"] == CV_K, f"supervision healthy: {out}")
    require(not any(n.startswith(("alarm.", "watchdog.", "rollback."))
                    for n in names)
            and {"train.start", "train.end"} <= set(names),
            f"supervision healthy: events {sorted(set(names))}")
    require(len(recs) == CV_STEPS and all(
        r["nonfinite"] == 0.0 and all(math.isfinite(r[k])
                                      for k in TELEMETRY_KEYS)
        for r in recs), "supervision healthy: a bad telemetry record")
    require(launches == expected, f"supervision healthy: launch counts "
            f"{launches} != expected {expected}")
    return out


def rb_check(rb, rb_events) -> dict:
    """The world-2 rollback's line, each check required: exactly one
    rollback on each rank, to the checkpoint before the bad step, the
    same budget, LR scale and latent lineage on both ranks, finite losses
    after the heal, equal final states, the launches per rank exact.
    ``rb``: one result per rank; ``rb_events``: rank 0's timeline."""
    per_step = {"fused_update": 3, "bn_act": 0, "upsample_bwd": 2,
                "bn_moments": 3, "bn_apply": 3, "bn_act_4d": 0,
                "bn_act_tenants": 0,
                "bn_act_tenants_bwd": 0}
    expected = {k: v * RB_EXECUTED for k, v in per_step.items()}
    request = [{k: e.get(k) for k in ("step", "bad_step", "rollbacks",
                                       "lr_scale")}
               for e in _named(rb_events, "rollback.request")]
    restore = [{k: e.get(k) for k in ("step", "bad_step")}
               for e in _named(rb_events, "rollback.restore")]
    out = dict(
        world=len(rb), steps=[r["steps"] for r in rb],
        nan_at_batch=RB_NAN_AT, checkpoint_every=RB_CKPT,
        rollbacks=[r["rollbacks"] for r in rb],
        lr_scale=[r["lr_scale"] for r in rb],
        losses=[r["losses"] for r in rb],
        boundaries=rb[0]["boundaries"], request=request, restore=restore,
        heal_s=[r["heal_s"] for r in rb], seconds=[r["seconds"] for r in rb],
        launches=[r["launches"] for r in rb], expected_launches=expected,
        digests=[r["digest"] for r in rb])
    bad = RB_NAN_AT + 1
    for r in rb:
        require(r["steps"] == RB_STEPS and r["rollbacks"] == 1
                and r["attempts"] == 1 and r["lr_scale"] == 0.5
                and all(math.isfinite(v) for v in r["losses"])
                and isinstance(r["heal_s"], float) and r["heal_s"] > 0,
                f"rollback world 2 rank {r['rank']}: {out}")
        require(r["launches"] == expected,
                f"rollback world 2 rank {r['rank']}: launches "
                f"{r['launches']} != {expected}")
    require(len({r["digest"] for r in rb}) == 1
            and len({r["z_gen"] for r in rb}) == 1,
            f"rollback world 2: the ranks' states differ {out['digests']}")
    require(request == [{"step": bad, "bad_step": bad, "rollbacks": 1,
                         "lr_scale": 0.5}]
            and restore == [{"step": RB_RESTORED, "bad_step": bad}]
            and rb[0]["boundaries"] == list(range(1, bad + 1))
            + list(range(RB_RESTORED + 1, RB_STEPS + 1)),
            f"rollback world 2: the timeline {out}")
    return out


def supervision_phase(torch, smi: str, world2, rb, rb_events) -> dict:
    """Supervision's numerics and hang half on the card (module docstring,
    phase 16).  ``world2``: the dp phase's telemetry runs, one per rank;
    ``rb``, ``rb_events``: its world-2 rollback (``rb_check``)."""
    t0 = time.perf_counter()
    out = {"nvidia_smi": smi, "telemetry": sv_telemetry(torch)}
    root = tempfile.mkdtemp(prefix="gan4j_sv_")
    try:
        out["nan_rollback"] = sv_nan(root)
        out["hang"] = sv_hang(root)
        out["divergence"] = sv_divergence(root)
        out["healthy"] = sv_healthy(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sv_expected = {"fused_update": 3 * SV_DP_STEPS, "bn_act": 0,
                   "upsample_bwd": 2 * SV_DP_STEPS,
                   "bn_moments": 3 * SV_DP_STEPS,
                   "bn_apply": 3 * SV_DP_STEPS, "bn_act_4d": 0,
                   "bn_act_tenants": 0,
                "bn_act_tenants_bwd": 0}
    out["world2"] = dict(
        steps=[r["steps"] for r in world2],
        launches=[r["launches"] for r in world2],
        expected_launches=sv_expected, block_last=world2[0]["blocks"][-1],
        digests=[r["digest"] for r in world2])
    for rank, r in enumerate(world2):
        require(r["steps"] == SV_DP_STEPS and r["launches"] == sv_expected,
                f"supervision world 2 rank {rank}: {r['launches']} != "
                f"{sv_expected}")
        require(all(b[-1] == 0.0 and all(math.isfinite(v) for v in b)
                    for b in r["blocks"]),
                f"supervision world 2 rank {rank}: a bad block")
    require(len({r["digest"] for r in world2}) == 1,
            "supervision world 2: the ranks' blocks differ")
    out["rollback_world2"] = rb_check(rb, rb_events)
    out["seconds"] = time.perf_counter() - t0
    return out


# -- the observability phase --------------------------------------------------

# the cv_main phase's run without its FID (the phase times the flags, not
# the evaluation)
OBS_CV_ARGS = CV_ARGS[:-1] + ["0"]
# the port kernels on the CV program's path, as its summary lists them
OBS_KERNELS = ("fused_update", "bn_act", "upsample_bwd")
# the celeba run: the roadmap phase's cut (rows, iterations, print-every)
OBS_RM = ("celeba", 2000, 50, 25)
OBS_SCRAPE_TIMEOUT_S = 0.5
OBS_BUDGET_S = 120.0
OBS_PHASES = ("data_wait", "dispatch", "readback", "checkpoint", "eval",
              "other")


def summary_counts(lines) -> dict:
    """The port kernels' (ms, count) from a ``--profile`` run's printed
    summary (``print_trace_summary``'s "the port's kernels" lines)."""
    out, on = {}, False
    for ln in lines:
        if ln.startswith("[profile] the port's kernels:"):
            on = True
        elif on:
            ms, _, n, kernel = ln.split()[1:5]
            out[kernel] = (float(ms), int(n.rstrip("x")))
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_get(url: str):
    """(status, body bytes) of a GET, None when nothing answers."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=OBS_SCRAPE_TIMEOUT_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except OSError:
        return None


def prom_value(text: str, series: str):
    """A series' value in Prometheus text (None: absent)."""
    for ln in text.splitlines():
        if ln.startswith(series + " "):
            return float(ln.split()[-1])
    return None


class ObsScraper:
    """Polls a training child's ``/metrics``, ``/healthz`` and live UI
    (``/data`` and the page) on a thread from the moment their ports are
    known until each has answered with the run going: the first scrape
    whose ``gan4j_steps_total`` is positive, and the first non-empty
    ``/data``."""

    def __init__(self):
        import threading

        self.metrics_port = self.ui_port = None
        self.got: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.metrics_port and "metrics" not in self.got:
                base = f"http://127.0.0.1:{self.metrics_port}"
                r = http_get(base + "/metrics")
                if r is not None and r[0] == 200:
                    text = r[1].decode()
                    if (prom_value(text, "gan4j_steps_total") or 0) > 0:
                        self.got["metrics"] = text
                        h = http_get(base + "/healthz")
                        self.got["healthz"] = (
                            (h[0], json.loads(h[1])) if h else None)
            if self.ui_port and "ui_data" not in self.got:
                base = f"http://127.0.0.1:{self.ui_port}"
                r = http_get(base + "/data")
                if r is not None and r[0] == 200 and json.loads(r[1]):
                    self.got["ui_data"] = json.loads(r[1])
                    page = http_get(base + "/")
                    self.got["ui_page"] = page[1].decode() if page else None
            self._stop.wait(0.02)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(10)


def obs_full_run(torch, root: str, csv_dir: str) -> dict:
    """``cv_main`` at full width as a child with ``--telemetry --profile
    DIR --metrics-port 0 --live-ui PORT``, scraped while it trains
    (ObsScraper); then its files: the last metrics record's phases sum to
    ``wall_s``, the manifest names the card, the capture's summary lists
    the three port kernels with their counts, and the Chrome trace merged
    from ``events.jsonl`` and the capture holds host and device lanes."""
    import signal
    import threading

    from gan_deeplearning4j_tpu_torch.telemetry.events import (
        export_chrome_trace,
    )

    d, prof = f"{root}/full", f"{root}/full/prof"
    os.makedirs(d)
    for f in ("mnist_train.csv", "mnist_test.csv"):
        shutil.copy(f"{csv_dir}/{f}", f"{d}/{f}")
    ui_port = free_port()
    argv, cwd, env = child_command(
        "gan_deeplearning4j_tpu_torch.train.cv_main",
        OBS_CV_ARGS + ["--telemetry", "--profile", prof, "--metrics-port",
                       "0", "--live-ui", str(ui_port), "--res-path", d])
    env["PYTHONUNBUFFERED"] = "1"  # the ports' lines as they are printed
    scraper = ObsScraper()
    t0 = time.perf_counter()
    lines, last = [], None
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(argv, cwd=cwd, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=err)
        killer = threading.Timer(RES_CHILD_TIMEOUT_S, proc.kill)
        killer.start()
        try:
            for line in proc.stdout:
                if line.startswith("[metrics] serving"):
                    scraper.metrics_port = int(line.rsplit(":", 1)[1])
                elif line.startswith("[live-ui]"):
                    scraper.ui_port = int(line.rsplit(":", 1)[1].strip("/\n"))
                elif line.startswith("[profile]"):
                    lines.append(line.rstrip())
                elif line.startswith("{"):
                    last = line
            rc = proc.wait()
        finally:
            killer.cancel()
            scraper.close()
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
        err.seek(0)
        tail = err.read()[-3000:]
    secs = time.perf_counter() - t0
    require(rc == 0 and last is not None,
            f"observability: cv_main exit {rc}; stderr {tail}")
    res = json.loads(last)
    got = scraper.got
    require(scraper.metrics_port and scraper.ui_port == ui_port,
            f"observability: ports {scraper.metrics_port} / "
            f"{scraper.ui_port} (asked {ui_port})")
    text = got.get("metrics") or ""
    steps_total = prom_value(text, "gan4j_steps_total")
    goodput_series = sorted(
        ln.split("{")[1].split("}")[0] for ln in text.splitlines()
        if ln.startswith("gan4j_goodput_seconds{"))
    health = got.get("healthz")
    require(steps_total and steps_total > 0 and goodput_series
            and health is not None and health[0] == 200
            and health[1]["run_id"] == res["run_id"],
            f"observability: the live /metrics scrape {steps_total}, "
            f"goodput series {goodput_series}, /healthz {health}")
    require(got.get("ui_data") and "gan4j live metrics" in (
        got.get("ui_page") or ""),
        "observability: the live UI served no records while the run went")
    # the ports are closed once the program has printed its result
    require(http_get(f"http://127.0.0.1:{scraper.metrics_port}/metrics")
            is None and http_get(f"http://127.0.0.1:{ui_port}/") is None,
            "observability: a server still answers after the run")
    recs = [json.loads(ln) for ln in open(f"{d}/mnist_metrics.jsonl")]
    final = recs[-1]
    gp = final.get("goodput", {})
    phase_sum = sum(gp.get(k, 0.0) for k in OBS_PHASES)
    require(final.get("run_id") == res["run_id"]
            and abs(phase_sum - gp.get("wall_s", -1.0)) <= 1e-5 * 7
            and gp == res["goodput"],
            f"observability: the final record {final} against the "
            f"result's goodput {res.get('goodput')}")
    manifest = json.load(open(f"{d}/run_manifest.json"))
    name = torch.cuda.get_device_name(0)
    require(manifest["run_id"] == res["run_id"]
            and manifest.get("devices", {}).get("kind") == name
            and manifest["devices"]["platform"] == "gpu",
            f"observability: the manifest's devices {manifest.get('devices')}")
    port = summary_counts(lines)
    counts = {k: port.get(k, (0.0, 0))[1] for k in OBS_KERNELS}
    kernel_ms = {k: port.get(k, (0.0, 0))[0] for k in OBS_KERNELS}
    calls = CV_STEPS + 1  # the warm-up step, then a replay per step
    want = {"fused_update": 3 * calls, "bn_act": 3 * calls,
            "upsample_bwd": 2 * calls}
    graph_kernels = counts == want
    if not graph_kernels:
        # the stated fallback: a trace that shows the graph launches only
        # holds the warm-up step's kernels, and the summary says so
        require(counts == {k: v // calls for k, v in want.items()},
                f"observability: the trace counts {counts}, neither the "
                f"replays' {want} nor the warm-up's alone")
    merged = export_chrome_trace(f"{d}/events.jsonl", f"{root}/merged.json",
                                 trace_dir=prof)
    doc = json.load(open(merged))["traceEvents"]
    host_lane = [e for e in doc if e.get("pid") == 1 and "cat" not in e
                 and e.get("ph") in ("X", "i")]
    device = [e for e in doc if e.get("cat") == "kernel"]
    spans = {e["name"] for e in host_lane}
    lo = min(e["ts"] for e in host_lane)
    hi = max(e["ts"] + e.get("dur", 0) for e in host_lane)
    aligned = sum(lo <= e["ts"] <= hi for e in device) / max(len(device), 1)
    require(host_lane and device and aligned > 0.9
            and {"eval.grid", "data.prepare"} <= spans,
            f"observability: the merged trace has {len(host_lane)} host "
            f"spans ({sorted(spans)}), {len(device)} kernels, {aligned:.3f} "
            "of them inside the host events' span")
    return dict(
        seconds=secs, steps=res["steps"], run_id=res["run_id"],
        examples_per_sec=res["examples_per_sec"], goodput=res["goodput"],
        phase_sum_minus_wall=phase_sum - gp["wall_s"],
        metrics_steps_total_mid_run=steps_total,
        goodput_series=goodput_series, healthz=health[1],
        ui_records_mid_run=len(got["ui_data"]), manifest_devices=manifest[
            "devices"], manifest_versions=manifest["versions"],
        trace_counts=counts, expected_counts=want,
        graph_kernels_traced=graph_kernels, trace_kernel_ms=kernel_ms,
        summary=lines, merged_trace=dict(
            host_spans=len(host_lane), kernels=len(device),
            kernels_inside_host_span=aligned),
        trace_bytes=sum(os.path.getsize(os.path.join(prof, f))
                        for f in os.listdir(prof)))


def obs_turns(torch, root: str, csv_dir: str) -> dict:
    """``cv_main`` in this process without and with the flags, in turns
    (plain, --profile, exporter + live UI, plain): each run's
    ``examples_per_sec`` (recorded, not gated); the
    profiled runs' per-step losses bitwise the plain runs' (the capture
    under an active profiler records the same step), and the port kernels'
    launches around one profiled run.  The runs write no model zips: their
    DEFLATE is seconds of host time after the timed window, and the
    cv_main phase checks them."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.train import cv_main
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    t0 = time.perf_counter()
    d = f"{root}/turns"
    os.makedirs(d)
    for f in ("mnist_train.csv", "mnist_test.csv"):
        shutil.copy(f"{csv_dir}/{f}", f"{d}/{f}")
    flags = {"plain": [], "profile": ["--profile", f"{root}/turn_prof"],
             "exporter_ui": ["--metrics-port", "0", "--live-ui",
                             str(free_port())]}
    eps = {k: [] for k in flags}
    losses, launches = {}, None
    for label in ("plain", "profile", "exporter_ui", "plain"):
        if label == "profile" and launches is None:
            kernels.reset_launch_counts()
        save = GANTrainer.save_models
        GANTrainer.save_models = lambda self: None
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                _, res = cv_main.run(cv_main.parse_args(
                    OBS_CV_ARGS + flags[label] + ["--res-path", d]))
        finally:
            GANTrainer.save_models = save
        if label == "profile" and launches is None:
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
        eps[label].append(res["examples_per_sec"])
        losses.setdefault(label, [[r[k] for k in LOSS_KEYS]
                                  for r in step_records(
                                      f"{d}/mnist_metrics.jsonl")])
    calls = CV_STEPS + 1
    expected = {"fused_update": 3 * calls, "bn_act": 3 * calls,
                "upsample_bwd": 2 * calls, "bn_moments": 0, "bn_apply": 0,
                "bn_act_4d": 0, "bn_act_tenants": 0,
                "bn_act_tenants_bwd": 0}
    require(launches == expected,
            f"observability: a profiled run's launches {launches} != "
            f"{expected}")
    require(losses["profile"] == losses["plain"] == losses["exporter_ui"],
            "observability: the per-step losses under --profile or the "
            "exporter differ from the plain run's")
    return dict(examples_per_sec=eps, launches=launches,
                expected_launches=expected, losses_bitwise=True,
                seconds=time.perf_counter() - t0)


def obs_roadmap(torch, root: str, child) -> dict:
    """``roadmap_main --family celeba`` (OBS_RM: the roadmap phase's cut)
    with ``--profile`` and ``--metrics-port 0``, a child run beside the
    full run (``child``: run_child's result): one ``bn_act`` an iteration
    (and the warm-up's) in the capture's summary and in the result's
    ``port_launches``, its manifest, and its goodput summing to its
    ``wall_s``."""
    family, rows, iters, every = OBS_RM
    (rc, res, secs, tail), lines = child
    require(rc == 0 and res is not None,
            f"observability roadmap: exit {rc}; stderr {tail}")
    port = summary_counts(lines)
    counts = {k: port.get(k, (0.0, 0))[1] for k in OBS_KERNELS}
    launches = res["port_launches"]
    manifest = json.load(open(f"{root}/rm/run_manifest.json"))
    gp = res["goodput"]
    phase_sum = sum(gp[k] for k in OBS_PHASES)
    want = iters + 1  # the capture's warm-up iteration, then the replays
    require(counts["bn_act"] == launches["bn_act"] == want
            and counts["fused_update"] == counts["upsample_bwd"] == 0
            and manifest["run_id"] == res["run_id"]
            and manifest["devices"]["kind"] == torch.cuda.get_device_name(0)
            and abs(phase_sum - gp["wall_s"]) <= 1e-5 * 7,
            f"observability roadmap: trace counts {counts}, launches "
            f"{launches}, goodput {gp}")
    return dict(family=family, rows=rows, iterations=iters,
                trace_counts=counts, launches=launches, goodput=gp,
                examples_per_sec=res["examples_per_sec"],
                run_id=res["run_id"], seconds=secs)


def observability_phase(torch, smi: str, csv_dir: str) -> dict:
    """The training run's observability on the card (module docstring,
    phase 17), on the cv_main phase's CSV pair in ``csv_dir``.  The
    preemption drill's events are the resume phase's
    (``resume_insurance``: its SIGTERM'd child's ``events.jsonl``)."""
    import threading

    from gan_deeplearning4j_tpu_torch.train import profile_step

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gan4j_obs_")
    try:
        out = {"nvidia_smi": smi}
        # the celeba child beside the full run (neither is timed: their
        # checks are counts, files and scrapes)
        family, rows, iters, every = OBS_RM
        box, rm_lines = {}, []
        rm = threading.Thread(target=lambda: box.update(child=(run_child(
            "gan_deeplearning4j_tpu_torch.train.roadmap_main",
            ["--family", family, "--n-train", str(rows), "--iterations",
             str(iters), "--print-every", str(every), "--res-path",
             f"{root}/rm", "--profile", f"{root}/rm_prof",
             "--metrics-port", "0"], profile_lines=rm_lines), rm_lines)))
        rm.start()
        try:
            out["full_run"] = obs_full_run(torch, root, csv_dir)
        finally:
            rm.join()
        out["roadmap"] = obs_roadmap(torch, root, box["child"])
        out["flag_cost"] = obs_turns(torch, root, csv_dir)
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            split = profile_step.main(["--telemetry"])
        ts = dict(split["telemetry_split"], seconds=time.perf_counter() - t1)
        t1 = time.perf_counter()
        require(ts["added_kernels_per_step"] > 0
                and ts["added_device_ms"] > 0,
                f"observability: the telemetry block added nothing: {ts}")
        out["telemetry_split"] = ts
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["cleanup_s"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


# -- the migration surface: DL4J zips, early stopping, the probe --------------

# the fixed batch each imported graph is held to its source on: a batch no
# later phase runs the CV graphs at in this process (cuDNN keeps its first
# choice for a shape for the process, and the serve phase holds its
# buckets, 8 / 32 / 64, to a fresh child's untimed choice)
MG_BATCH = 5
ES_TRAIN, ES_VAL = 2000, 500  # the cut of the cv_main phase's MNIST CSVs
ES_BATCH = 200
ES_EPOCHS, ES_PATIENCE = 4, 1
ES_PRINT = 5  # the ScoreIterationListener's cadence (iterations)
PROBE_TIMEOUT_S = 120.0


def _graph_batch(graph, torch, seed: int):
    """A fixed [MG_BATCH, ...] input per graph input, on the graph's
    device, in [-1, 1) (feature-flat for the flat CNN inputs)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    xs = []
    for name in graph.input_names:
        spec = graph.input_specs[name]
        n = math.prod(spec.shape)
        xs.append((torch.rand((MG_BATCH, n), generator=gen) * 2 - 1)
                  .reshape((MG_BATCH,) + ((n,) if spec.kind != "cnn"
                                          else tuple(spec.shape)))
                  .to(graph.device))
    return xs


def dl4j_phase(torch, smi: str, trainer, dev: str = "cuda") -> dict:
    """DL4J ModelSerializer zips on the card (module docstring, phase
    4b): the main phase's four trained CV graphs at full width and the
    insurance program's four, each written by ``export_dl4j`` with its
    RmsProp state and read back by ``import_dl4j`` onto the card; params
    and updater state bitwise, and the outputs bitwise the source graph's
    on a fixed batch.  The counters are zeroed just before and read just
    after."""
    from gan_deeplearning4j_tpu_torch.graph import dl4j_import
    from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as I
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp

    t0 = time.perf_counter()
    trainer._sync_graphs()
    ins_dis = I.build_discriminator(device=dev)
    graphs = {**{f"cv_{k}": g for k, g in trainer._graphs().items()},
              "ins_dis": ins_dis, "ins_gen": I.build_generator(device=dev),
              "ins_gan": I.build_gan(device=dev),
              "ins_classifier": I.build_classifier(ins_dis)}
    root = tempfile.mkdtemp(prefix="gan4j_dl4j_")
    kernels.reset_launch_counts()
    out = {"nvidia_smi": smi, "graphs": {}}
    try:
        for i, (name, g) in enumerate(graphs.items()):
            up = next(u for u in g.updater.layer_updaters.values()
                      if isinstance(u, RmsProp))
            path = f"{root}/{name}.zip"
            t1 = time.perf_counter()
            dl4j_import.export_dl4j(g, path, save_updater=True)
            t2 = time.perf_counter()
            back = dl4j_import.import_dl4j(path, updater=up, device=dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            params = all(torch.equal(back.params[l][k], v)
                         for l, lp in g.params.items() for k, v in lp.items())
            state = all(torch.equal(back.opt_state[l][k], g.opt_state[l][k])
                        for l, lp in g.params.items() for k in lp
                        if k not in ("mean", "var"))
            xs = _graph_batch(g, torch, 20261018 + i)
            outputs = all(torch.equal(a, b) for a, b in
                          zip(g.output(*xs), back.output(*xs)))
            rec = {"zip_bytes": os.path.getsize(path),
                   "params": g.num_params(), "export_s": t2 - t1,
                   "import_s": t3 - t2, "params_bitwise": params,
                   "updater_state_bitwise": state,
                   "outputs_bitwise": outputs}
            out["graphs"][name] = rec
            require(params and state and outputs,
                    f"dl4j {name}: the round trip is not bitwise {rec}")
        torch.cuda.synchronize()
        out["launches"] = kernels.launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def es_run(torch, csv_dir: str, root: str, dev: str = "cuda") -> dict:
    """Early stopping on the card: the DCGAN-MNIST transfer classifier at
    full width, ``EarlyStoppingGraphTrainer`` over a cut of the cv_main
    phase's MNIST CSVs (ES_TRAIN / ES_VAL rows, the train split's
    ``NormalizerMinMaxScaler`` on both iterators), a
    ``ScoreIterationListener``, the best model persisted; the counters
    zeroed just before and read just after."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.data.csv import (
        RecordReaderDataSetIterator,
        write_csv_matrix,
    )
    from gan_deeplearning4j_tpu_torch.data.normalizers import (
        NormalizerMinMaxScaler,
    )
    from gan_deeplearning4j_tpu_torch.graph import serialization
    from gan_deeplearning4j_tpu_torch.graph.layers import BatchNorm
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.train.early_stopping import (
        EarlyStoppingConfig,
        EarlyStoppingGraphTrainer,
    )
    from gan_deeplearning4j_tpu_torch.utils.listeners import (
        ScoreIterationListener,
    )

    cut = {}
    for split, rows in (("train", ES_TRAIN), ("test", ES_VAL)):
        table = np.loadtxt(f"{csv_dir}/mnist_{split}.csv", delimiter=",",
                           max_rows=rows, ndmin=2, dtype=np.float32)
        cut[split] = f"{root}/es_{split}.csv"
        write_csv_matrix(cut[split], table)
    cfg = M.CVConfig()
    train = RecordReaderDataSetIterator(cut["train"], ES_BATCH,
                                        cfg.num_features, cfg.num_classes)
    val = RecordReaderDataSetIterator(cut["test"], ES_VAL, cfg.num_features,
                                      cfg.num_classes)
    scaler = NormalizerMinMaxScaler().fit(train)
    train.set_preprocessor(scaler)
    val.set_preprocessor(scaler)
    clf = M.build_classifier(M.build_discriminator(cfg, dev), cfg)
    lines = []
    clf.set_listeners(ScoreIterationListener(ES_PRINT, log=lines.append))
    val.reset()
    first = val.next()
    before = clf.score_on(first.features, first.labels)
    save = f"{root}/es_best.zip"
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = EarlyStoppingGraphTrainer(
        clf, train, val, EarlyStoppingConfig(
            max_epochs=ES_EPOCHS, patience=ES_PATIENCE,
            save_path=save)).fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    fits = res.total_epochs * (ES_TRAIN // ES_BATCH)
    n_bn = sum(isinstance(n.layer, BatchNorm) for n in clf.nodes.values()
               if n.name not in clf.frozen)
    after = clf.score_on(first.features, first.labels)
    back = serialization.read_model(save, dev).score_on(first.features,
                                                        first.labels)
    out = {"reason": res.reason, "best_epoch": res.best_epoch,
           "best_score": res.best_score, "total_epochs": res.total_epochs,
           "score_before": before, "score_restored": after,
           "score_persisted": back, "fits": fits, "seconds": seconds,
           "listener_lines": len(lines), "last_line": lines[-1:],
           "launches": launches, "bn_layers_trained": n_bn,
           "rows": {"train": ES_TRAIN, "val": ES_VAL}}
    require(res.reason in ("max_epochs", "patience") and res.best_epoch >= 1
            and math.isfinite(res.best_score) and res.best_score < before
            and abs(after - res.best_score) <= 1e-5 * abs(res.best_score)
            and abs(back - res.best_score) <= 1e-5 * abs(res.best_score),
            f"early stopping: {out}")
    require(len(lines) == fits // ES_PRINT,
            f"early stopping: {len(lines)} listener lines for {fits} fits")
    require(launches["fused_update"] == fits
            and launches["bn_act"] == n_bn * fits
            and launches["upsample_bwd"] == launches["bn_moments"]
            == launches["bn_apply"] == launches["bn_act_4d"] == 0,
            f"early stopping: launches {launches} for {fits} fits")
    return out


def migration_phase(torch, smi: str, csv_dir: str) -> dict:
    """Early stopping and the device probe on the card (module docstring,
    phase 18): ``es_run`` while the probe's child reaches the card beside
    it (its round trip is then a shared card's)."""
    import threading

    from gan_deeplearning4j_tpu_torch.utils import probe

    t0 = time.perf_counter()
    box = {}

    def run_probe():
        try:
            box["probe"] = probe.probe(PROBE_TIMEOUT_S)
        except Exception as e:  # required below, on the main thread
            box["error"] = e

    th = threading.Thread(target=run_probe)
    th.start()
    root = tempfile.mkdtemp(prefix="gan4j_es_")
    try:
        es = es_run(torch, csv_dir, root)
    finally:
        th.join()
        shutil.rmtree(root, ignore_errors=True)
    require("error" not in box, f"probe: {box.get('error')!r}")
    pr = box["probe"]
    require(pr["platform"] == "gpu"
            and pr["device"] == torch.cuda.get_device_name(0)
            and pr["rt_ms"] > 0, f"probe: {pr}")
    return {"nvidia_smi": smi, "early_stopping": es,
            "probe": {**pr, "shared_card": "beside early stopping"},
            "seconds": time.perf_counter() - t0}


# -- 19. the insurance fleet ---------------------------------------------------

FLEET_B = 16  # FleetConfig's batch
FLEET_SWEEP = (1, 64, 256, 1024, 4096)
FLEET_KERNEL_N = 1024
FLEET_ROWS = 64  # a tenant's table: four batches
FLEET_CALLS = 3  # timed calls of FLEET_K replays at each fleet size
FLEET_K = 10
FLEET_SEED = 20261019
# the fleet step's four train-mode BNs, per tenant: (rows, features), act
FLEET_BN = [((32, 12), "elu"), ((16, 2), "tanh"), ((16, 12), "elu"),
            ((16, 100), "elu")]
FLEET_PER_STEP = {"fused_update": 3, "bn_act_tenants": 4,
                  "bn_act_tenants_bwd": 4}  # the others 0
# the card's fleet step against the CPU's from one start at 4 tenants, from
# each seed of FLEET_TOL_SEEDS (the weights' init, tables and latents):
# loss relative, params (and BN statistics) absolute, caches relative to a
# leaf's max.  Each band sits between the largest sound reading of the
# first twenty seeds (loss 3.7e-5, param 1.1e-4, cache 3.0e-2: the tests'
# one-step bands, 1e-5 / 2e-5 / 2e-3, did not hold there) and the
# smallest reading of a known fault, ``_unbiased_bn``, checked at every
# seed; the other twenty seeds are held out (PERF.md, the fleet's
# findings).  cuBLAS sums in another order than the CPU's GEMMs, BN over
# 16 rows scales that by 1 / std, RmsProp's first step moves an element
# whose gradient sits near 0 by up to lr / sqrt(eps) times it, and a
# small leaf whose gradients cancel over the batch has a cache of
# rounding.  The same numbers as INS_STEP_TOL
FLEET_TOL = {"loss": 1e-4, "param": 4e-4, "cache": 5e-2}
FLEET_TOL_SEEDS = tuple(range(40))
FLEET_CHILD_TENANTS = 64
FLEET_CHILD_STEPS = 150
FLEET_CHILD_ARGS = ["--tenants", str(FLEET_CHILD_TENANTS), "--iterations",
                    str(FLEET_CHILD_STEPS), "--batch-size", str(FLEET_B),
                    "--checkpoint-every", "50", "--seed", "7"]
FLEET_SERVE_TENANTS = (0, 5, 17, 63)
FLEET_BUCKETS = (8,)


def fleet_kernel(torch, randn, bw: float, sms: int) -> dict:
    """The tenant-batched ``bn_act`` at the fleet step's four BN shapes:
    against its plain version at every size of FLEET_SWEEP (each plan the
    graphed sweep launches), and for FLEET_KERNEL_N tenants a bitwise
    repeat and the gradient; timed against ``F.batch_norm`` (training) on the
    [B, N*F] transpose in turns, without the copy or the activation; the
    plain version's time, the floor of four launches, the bound; and, at
    16 tenants, the [B, F] cluster kernel launched once a tenant (the 2-D
    plan carried over) beside one tenant-batched launch a shape.  -> the
    kernels line's row."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d

    torch_f = torch.nn.functional
    n = FLEET_KERNEL_N

    def inputs(m):
        return [((randn(m, b, f, scale=0.5, shift=0.2),
                  randn(m, f, scale=0.1, shift=1.0), randn(m, f, scale=0.1)),
                 act) for (b, f), act in FLEET_BN]

    ins = inputs(n)
    err = 0.0
    for m in FLEET_SWEEP:
        for (x, gm, bt), act in ins if m == n else inputs(m):
            _, b, f = x.shape
            outk = kernels.fused_bn_act_train_tenants(x, gm, bt, 1e-5, act)
            outp = bn2d.bn_act_tenants_plain(x, gm, bt, 1e-5, act)
            for a, p, (atol, rtol) in zip(outk, outp, [
                    (1e-5, 1e-4), (1e-6, 1e-4), (1e-6, 1e-4)]):
                require(within(a, p, atol, rtol), "bn_act_tenants disagrees "
                        f"with its plain version at [{m},{b},{f}] {act}")
                err = max(err, max_err(a, p))
    for (x, gm, bt), act in ins:
        _, b, f = x.shape
        require(bitwise_repeat(lambda *t: kernels.fused_bn_act_train_tenants(
            *t, 1e-5, act), [(x, gm, bt)], torch),
            f"bn_act_tenants: two launches differ at [{n},{b},{f}]")
        leaves = [t.clone().requires_grad_(True) for t in (x, gm, bt)]
        gy = randn(*x.shape)
        gk = torch.autograd.grad(kernels.fused_bn_act_train_tenants(
            *leaves, 1e-5, act)[0], leaves, gy)
        gp = torch.autograd.grad(bn2d.bn_act_tenants_plain(
            *leaves, 1e-5, act)[0], leaves, gy)
        require(all(within(u, v, 1e-4, 1e-3) for u, v in zip(gk, gp)),
                f"bn_act_tenants gradient disagrees at [{n},{b},{f}] {act}")
    lib_in = [(x.transpose(0, 1).reshape(x.shape[1], -1).contiguous(),
               gm.reshape(-1), bt.reshape(-1)) for (x, gm, bt), _ in ins]
    ms, library_ms, turns = in_turns(
        lambda: [kernels.fused_bn_act_train_tenants(*t, 1e-5, act)
                 for t, act in ins],
        lambda: [torch_f.batch_norm(xt, None, None, g, b_, training=True,
                                    eps=1e-5) for xt, g, b_ in lib_in], torch)
    sub = [((x[:16], gm[:16], bt[:16]), act) for (x, gm, bt), act in ins]
    nbytes = sum(8 * n * b * f + 16 * n * f for (b, f), _ in FLEET_BN)
    flops = sum(10 * n * b * f for (b, f), _ in FLEET_BN)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return dict(
        name="bn_act_tenants", tolerance="|d| <= 1e-5 + 1e-4|plain| on y, "
        "1e-6 + 1e-4|plain| on mean/var; gradients 1e-4 + 1e-3|plain|",
        max_abs_err=err, calls=[f"[{n},{b},{f}] {act}"
                                for (b, f), act in FLEET_BN],
        checked_at_tenants=list(FLEET_SWEEP),
        plans={str(m): [bn2d.tenant_plan(m, b, f, sms)._asdict()
                        for (b, f), _ in FLEET_BN] for m in FLEET_SWEEP},
        bitwise_repeat=True, gradient="checked at every shape", ms=ms,
        plain_ms=time_ms(lambda: [bn2d.bn_act_tenants_plain(*t, 1e-5, act)
                                  for t, act in ins], torch),
        library_ms=library_ms, turns_ms=turns,
        library_call="F.batch_norm(training=True) on the [B, N*F] transpose "
        "of x, without the copy or the activation",
        floor_ms=floor_ms(len(ins), torch),
        at_16_tenants={
            "tenant_kernel_ms": time_ms(lambda: [
                kernels.fused_bn_act_train_tenants(*t, 1e-5, act)
                for t, act in sub], torch),
            "cluster_kernel_once_a_tenant_ms": time_ms(lambda: [
                kernels.fused_bn_act_train(x[i], gm[i], bt[i], 1e-5, act)
                for (x, gm, bt), act in sub for i in range(16)], torch)},
        bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations")


def _without_gvar(x, gamma, beta, mean, var, gy, gmean, gvar, eps, act):
    """A known fault for the backward's tolerance to catch: the closed form
    with the variance cotangent's term, gvar * 2 (x - mean) / B, dropped."""
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d

    dx, dgamma, dbeta = bn2d.bn_act_tenants_bwd_plain(
        x, gamma, beta, mean, var, gy, gmean, gvar, eps, act)
    return (dx - gvar[:, None] * 2 * (x - mean[:, None]) / x.shape[1],
            dgamma, dbeta)


FLEET_BWD_TOL = (1e-4, 1e-4)  # atol, rtol on dx, dgamma, dbeta
FLEET_ODD = ((1000, 5, 2), "sigmoid")  # 40 bytes a tenant, x off 16 bytes


def fleet_kernel_bwd(torch, randn, bw: float, sms: int) -> dict:
    """The tenant BN's backward kernel (``bn_act_tenants_bwd``) at the fleet
    step's four BN shapes, from the forward kernel's mean and var with
    non-zero cotangents on y, mean and var: against its plain version (the
    closed form) and against autograd of the plain forward (the recompute
    it replaced) at every N of FLEET_SWEEP; without dx, the same dgamma and
    dbeta bit for bit; for FLEET_KERNEL_N tenants a bitwise repeat, and the
    closed form with the gvar term dropped (``_without_gvar``) outside the
    tolerance.  One odd shape (FLEET_ODD: [5, 2] a tenant, 40 bytes, x a
    view 4 bytes past a 16-byte boundary) through both kernels against
    their plain versions.  Timed at FLEET_KERNEL_N against
    ``aten.native_batch_norm_backward`` on the [B, N*F] transpose (without
    the activation or the copy) in turns; the plain time is the recompute
    as the backward ran it before (autograd through
    ``bn_act_tenants_plain``).  -> the kernels line's row."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d

    n = FLEET_KERNEL_N
    atol, rtol = FLEET_BWD_TOL

    def case(m, b, f, act, offset=False):
        x = randn(m, b, f, scale=0.5, shift=0.2)
        if offset:
            x = offset_view(x, torch)
        gm, bt = randn(m, f, scale=0.1, shift=1.0), randn(m, f, scale=0.1)
        _, mean, var = kernels.fused_bn_act_train_tenants(x, gm, bt, 1e-5, act)
        return (x, gm, bt, mean, var, randn(m, b, f), randn(m, f),
                randn(m, f)), act

    err, grad_err, fault = 0.0, 0.0, float("inf")
    for m in FLEET_SWEEP:
        for (b, f), act in FLEET_BN:
            args, _ = case(m, b, f, act)
            got = kernels.bn_act_tenants_bwd(*args, 1e-5, act)
            want = bn2d.bn_act_tenants_bwd_plain(*args, 1e-5, act)
            for a, p in zip(got, want):
                require(within(a, p, atol, rtol), "bn_act_tenants_bwd "
                        f"disagrees with its plain version at [{m},{b},{f}] "
                        f"{act}")
                err = max(err, max_err(a, p))
            leaves = [t.clone().requires_grad_(True) for t in args[:3]]
            auto = torch.autograd.grad(bn2d.bn_act_tenants_plain(
                *leaves, 1e-5, act), leaves, args[5:])
            for a, p in zip(got, auto):
                require(within(a, p, 1e-4, 1e-3), "bn_act_tenants_bwd "
                        f"disagrees with autograd of the plain forward at "
                        f"[{m},{b},{f}] {act}")
                grad_err = max(grad_err, max_err(a, p))
            none, dg, db = kernels.bn_act_tenants_bwd(*args, 1e-5, act,
                                                      need_dx=False)
            require(none is None and torch.equal(dg, got[1])
                    and torch.equal(db, got[2]), "bn_act_tenants_bwd: "
                    f"without dx, other dgamma/dbeta at [{m},{b},{f}]")
            if m == n:
                require(bitwise_repeat(lambda *t: kernels.bn_act_tenants_bwd(
                    *t, 1e-5, act), [args], torch),
                    f"bn_act_tenants_bwd: two launches differ at [{n},{b},{f}]")
                bad = _without_gvar(*args, 1e-5, act)[0]
                require(not within(got[0], bad, atol, rtol),
                        "bn_act_tenants_bwd: the tolerance does not catch the "
                        f"dropped gvar term at [{n},{b},{f}] {act}")
                fault = min(fault, max_err(got[0], bad))
    (m, b, f), act = FLEET_ODD
    args, _ = case(m, b, f, act, offset=True)
    require(args[0].data_ptr() % 16 == 4, "fleet: the odd shape's x is aligned")
    for a, p in zip(kernels.fused_bn_act_train_tenants(*args[:3], 1e-5, act),
                    bn2d.bn_act_tenants_plain(*args[:3], 1e-5, act)):
        require(within(a, p, 1e-5, 1e-4), f"bn_act_tenants disagrees with its "
                f"plain version at the odd shape [{m},{b},{f}]")
    for a, p in zip(kernels.bn_act_tenants_bwd(*args, 1e-5, act),
                    bn2d.bn_act_tenants_bwd_plain(*args, 1e-5, act)):
        require(within(a, p, atol, rtol), "bn_act_tenants_bwd disagrees with "
                f"its plain version at the odd shape [{m},{b},{f}]")

    ins = [case(n, b, f, act) for (b, f), act in FLEET_BN]
    lib_in = []
    for (x, gm, _, mean, var, gy, _, _), _ in ins:
        nb = x.shape[1]
        lib_in.append((gy.transpose(0, 1).reshape(nb, -1).contiguous(),
                       x.transpose(0, 1).reshape(nb, -1).contiguous(),
                       gm.reshape(-1), mean.reshape(-1),
                       torch.rsqrt(var + 1e-5).reshape(-1)))

    def recompute(args, act):
        x, gm, bt, _, _, gy, gmean, gvar = args
        leaves = [t.detach().requires_grad_(True) for t in (x, gm, bt)]
        torch.autograd.grad(bn2d.bn_act_tenants_plain(*leaves, 1e-5, act),
                            leaves, (gy, gmean, gvar))

    ms, library_ms, turns = in_turns(
        lambda: [kernels.bn_act_tenants_bwd(*t, 1e-5, act) for t, act in ins],
        lambda: [torch.ops.aten.native_batch_norm_backward(
            g, xt, w, None, None, mu, inv, True, 1e-5, [True, True, True])
            for g, xt, w, mu, inv in lib_in], torch)
    nbytes = sum(12 * n * b * f + 32 * n * f for (b, f), _ in FLEET_BN)
    flops = sum(24 * n * b * f for (b, f), _ in FLEET_BN)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return dict(
        name="bn_act_tenants_bwd", tolerance=f"|d| <= {atol} + {rtol}|plain| "
        "on dx, dgamma, dbeta; against autograd of the plain forward "
        "1e-4 + 1e-3|autograd|", max_abs_err=err, autograd_max_abs_err=grad_err,
        known_fault={"without_gvar_least_max_abs_d": fault},
        calls=[f"[{n},{b},{f}] {act}" for (b, f), act in FLEET_BN],
        checked_at_tenants=list(FLEET_SWEEP),
        odd_shape=f"[{FLEET_ODD[0][0]},{FLEET_ODD[0][1]},{FLEET_ODD[0][2]}] "
        f"{FLEET_ODD[1]}, x 4 bytes past 16",
        plans={str(m_): [bn2d.tenant_plan(m_, b, f, sms, slabs=2)._asdict()
                         for (b, f), _ in FLEET_BN] for m_ in FLEET_SWEEP},
        bitwise_repeat=True, ms=ms,
        plain_ms=sum(time_ms(lambda: recompute(t, act), torch)
                     for t, act in ins),
        plain_call="autograd through bn_act_tenants_plain from x, gamma, beta "
        "(the recompute the kernel replaced), each BN timed alone (the four "
        "together take the host over the sleep's cover to enqueue)",
        library_ms=library_ms, turns_ms=turns,
        library_call="aten.native_batch_norm_backward (training, all three "
        "grads) on the [B, N*F] transpose, without the activation or the copy",
        floor_ms=floor_ms(len(ins), torch),
        bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations")


def _fleet_graphs(dev, seed=None):
    """The insurance graphs on ``dev`` (their init from ``seed``, else the
    config's) and the three param maps."""
    from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MI

    cfg = MI.InsuranceConfig() if seed is None else MI.InsuranceConfig(
        seed=seed)
    dis = MI.build_discriminator(cfg, dev)
    return ((dis, MI.build_generator(cfg, dev), MI.build_gan(cfg, dev),
             MI.build_classifier(dis, cfg)),
            (MI.DIS_TO_GAN, MI.GAN_TO_GEN, MI.DIS_TO_CLASSIFIER))


def _fleet_diff(ref, got) -> dict:
    """The fleet step's outputs on the card against the CPU's: losses
    relative, params (and BN statistics) absolute, caches relative to each
    leaf's largest value plus eps -> the worst of each, and the leaf it
    was read on."""
    from gan_deeplearning4j_tpu_torch.train import fused_step as FT

    (s_ref, l_ref), (s_got, l_got) = ref, got
    out = {"loss": max(float(((a.cpu().double() - b.double()).abs()
                              / b.double().abs()).max())
                       for a, b in zip(l_got, l_ref)),
           "param": 0.0, "cache": 0.0}
    leaves_ref, leaves_got = FT._leaves(s_ref), FT._leaves(s_got)
    for key, a in leaves_ref.items():
        if key[0] == "it" or not a.numel():
            continue
        d = float((leaves_got[key].cpu().double() - a.double()).abs().max())
        kind = "cache" if key[0].endswith("_opt") else "param"
        if kind == "cache":
            d /= float(a.abs().max()) + 1e-8
        if d > out[kind]:
            out[kind], out[f"{kind}_leaf"] = d, "/".join(map(str, key))
    return out


def _unbiased_bn(x, gamma, beta, eps: float, act_name: str):
    """A known fault for FLEET_TOL to catch: the tenant BN with its
    variance over B - 1 rows in place of B."""
    from gan_deeplearning4j_tpu_torch.ops import activations as act_lib

    mean = x.mean(dim=1)
    var = x.var(dim=1, unbiased=True)
    y = (x - mean[:, None]) * (var[:, None] + eps).rsqrt()
    return act_lib.get(act_name)(y * gamma[:, None] + beta[:, None]), mean, var


def fleet_sweep(torch) -> dict:
    """The graphed fleet step (``train/fleet.py``, insurance at full width,
    batch FLEET_B, per-tenant tables) at each size of FLEET_SWEEP: capture,
    FLEET_CALLS timed calls of FLEET_K replays with the launch counters
    zeroed just before and read just after (FLEET_PER_STEP a step at every
    size), the CUDA graph captures during the timed calls (must be 0),
    step ms, tenants x steps a second, and the sequential equivalent (N x
    the single insurance step at batch FLEET_B, graphed, timed in the same
    run); then one step at 4 tenants on the card against the CPU from each
    seed of FLEET_TOL_SEEDS (one start, tables and latents), within
    FLEET_TOL, and each seed's step with ``_unbiased_bn`` in place of the
    tenant kernel outside FLEET_TOL on every reading."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.runtime import prng
    from gan_deeplearning4j_tpu_torch.train import fleet as FL
    from gan_deeplearning4j_tpu_torch.train import fused_step as FT
    from gan_deeplearning4j_tpu_torch.utils import device as device_lib

    B = FLEET_B
    rng = np.random.RandomState(FLEET_SEED)
    ones = np.ones((B, 1), np.float32)
    host_targets = [torch.from_numpy(a) for a in (
        ones + (0.05 * rng.randn(B, 1)).astype(np.float32),
        (0.05 * rng.randn(B, 1)).astype(np.float32), ones)]
    targets = [t.cuda() for t in host_targets]
    graphs, maps = _fleet_graphs("cuda")
    data_gen = torch.Generator(device="cuda")
    data_gen.manual_seed(FLEET_SEED)
    captures = [0]
    begin = torch.cuda.CUDAGraph.capture_begin

    def counted_begin(self, *a, **kw):
        captures[0] += 1
        return begin(self, *a, **kw)

    def timed(g) -> float:
        """Median device ms a step over FLEET_CALLS calls of FLEET_K."""
        times = []
        for _ in range(FLEET_CALLS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.launch(FLEET_K)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / FLEET_K)
        return statistics.median(times)

    def table(n):
        feats = torch.rand((n, FLEET_ROWS, 12), generator=data_gen,
                           device="cuda")
        labs = (torch.rand((n, FLEET_ROWS, 1), generator=data_gen,
                           device="cuda") < 0.5).float()
        return feats, labs

    torch.cuda.CUDAGraph.capture_begin = counted_begin
    try:
        # the sequential unit: one insurance model's graphed step
        feats, labs = table(1)
        single = FT.GraphedStep(
            FT.make_protocol_step(*graphs, *maps, z_size=2, num_features=12),
            FT.state_from_graphs(*graphs), feats[0], labs[0], *targets,
            z_gen=prng.generator(FLEET_SEED, "single-z", "cuda"))
        single(1)
        single_ms = timed(single)
        del single
        rows, launches_total = [], {}
        for n in FLEET_SWEEP:
            feats, labs = table(n)
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            step = FL.make_fleet_step(*graphs, *maps, z_size=2,
                                      num_features=12, per_tenant_data=True)
            t0 = time.perf_counter()
            g = FL.graphed_fleet_step(
                step, FL.replicate_state(FT.state_from_graphs(*graphs), n),
                feats, labs, *targets,
                z_gen=prng.generator(FLEET_SEED, f"fleet-z-{n}", "cuda"))
            setup_s = time.perf_counter() - t0
            first = g(1)  # warm-up: one replay and its readback
            require(bool(torch.isfinite(first).all()),
                    f"fleet: non-finite losses at {n} tenants")
            caps = captures[0]
            kernels.reset_launch_counts()
            step_ms = timed(g)
            counts = kernels.launch_counts()
            recaptures = captures[0] - caps
            steps = FLEET_CALLS * FLEET_K
            per_step = {k: v / steps for k, v in counts.items()}
            want = {k: FLEET_PER_STEP.get(k, 0) for k in counts}
            require(per_step == want and g.launches == want,
                    f"fleet: {n} tenants launch {per_step} a step "
                    f"(replay {g.launches}), not {want}")
            require(recaptures == 0, f"fleet: {recaptures} captures after "
                    f"warm-up at {n} tenants")
            last = np.asarray(device_lib.readback(g.losses))
            require(bool(np.isfinite(last).all()),
                    f"fleet: non-finite losses after {steps} steps at {n}")
            for k, v in counts.items():
                launches_total[k] = launches_total.get(k, 0) + v
            rows.append(dict(
                tenants=n, step_ms=step_ms,
                tenants_steps_per_s=n * 1e3 / step_ms,
                sequential_ms=n * single_ms,
                speedup_over_sequential=n * single_ms / step_ms,
                launches_per_step=per_step, recaptures=recaptures,
                setup_s=setup_s, capture_s=g.setup["capture_s"],
                peak_added_bytes=torch.cuda.max_memory_allocated() - before))
            del g, step, feats, labs
            torch.cuda.empty_cache()
    finally:
        torch.cuda.CUDAGraph.capture_begin = begin

    # card against CPU at 4 tenants, one step from each seed's start
    n = 4
    cpu_graphs, _ = _fleet_graphs("cpu")
    ref_step = FL.make_fleet_step(*cpu_graphs, *maps, z_size=2,
                                  num_features=12, per_tenant_data=True)
    card_step = FL.make_fleet_step(*graphs, *maps, z_size=2, num_features=12,
                                   per_tenant_data=True)
    readings, faults = [], []
    for seed in FLEET_TOL_SEEDS:
        srng = np.random.RandomState(FLEET_SEED + seed)
        start = FL.replicate_state(FT.state_from_graphs(
            *_fleet_graphs("cpu", FLEET_SEED + seed)[0]), n)
        feats = torch.from_numpy(srng.rand(n, FLEET_ROWS, 12).astype(
            np.float32))
        labs = torch.from_numpy((srng.rand(n, FLEET_ROWS, 1) < 0.5).astype(
            np.float32))
        z1, z2 = (torch.from_numpy(srng.uniform(-1, 1, (n, B, 2)).astype(
            np.float32)) for _ in range(2))
        ref = ref_step(FT.clone_state(start), feats, labs, *host_targets,
                       z1=z1, z2=z2)

        def on_card():
            return card_step(state_to(start, "cuda"), feats.cuda(),
                             labs.cuda(), *targets, z1=z1.cuda(),
                             z2=z2.cuda())

        readings.append({"seed": FLEET_SEED + seed,
                         **_fleet_diff(ref, on_card())})
        kernel_bn, FL.fused_bn_act_train_tenants = (
            FL.fused_bn_act_train_tenants, _unbiased_bn)
        try:
            faults.append({"seed": FLEET_SEED + seed,
                           **_fleet_diff(ref, on_card())})
        finally:
            FL.fused_bn_act_train_tenants = kernel_bn
    worst = {k: max(r[k] for r in readings) for k in FLEET_TOL}
    least_fault = {k: min(r[k] for r in faults) for k in FLEET_TOL}
    require(all(worst[k] <= FLEET_TOL[k] for k in FLEET_TOL),
            f"fleet: the card's step against the CPU's: worst {worst} "
            f"(tolerance {FLEET_TOL}) over {readings}")
    require(all(least_fault[k] > FLEET_TOL[k] for k in FLEET_TOL),
            f"fleet: the band does not catch the unbiased-variance fault: "
            f"least {least_fault} (tolerance {FLEET_TOL}) over {faults}")
    return {"batch": B, "rows_per_tenant": FLEET_ROWS,
            "calls": FLEET_CALLS, "steps_per_call": FLEET_K,
            "single_step_ms": single_ms, "sweep": rows,
            "launches": launches_total,
            "card_vs_cpu": {"tenants": n, **worst, "tolerance": FLEET_TOL,
                            "readings": readings,
                            "fault_variance_over_b_minus_1": {
                                "least": least_fault, "readings": faults}}}


def _fleet_csv(path: str, tenants: int) -> None:
    import numpy as np

    rng = np.random.RandomState(FLEET_SEED)
    rows = [",".join(f"{v:.6f}" for v in rng.rand(12))
            + f",{int(rng.rand() < 0.5)}" for _ in range(tenants * FLEET_ROWS)]
    for r in (3, 70):  # tenants 3 and 6
        rows[r] = "#CORRUPT#," + rows[r]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def fleet_children(root: str) -> dict:
    """``scenario/trainer_child`` at FLEET_CHILD_TENANTS tenants on the card
    (FLEET_CHILD_ARGS: a checkpoint every 50 steps): one run straight to
    the end (``root/ref``), and beside it one sent SIGTERM once its first
    checkpoint is committed (exit 75, ``PREEMPTED.json``, the emergency
    checkpoint at its step) then resumed (exit 0); the two ``final.json``
    bit for bit equal."""
    import signal

    data = os.path.join(root, "feed.csv")
    _fleet_csv(data, FLEET_CHILD_TENANTS)

    def start(name, *extra):
        argv, cwd, env = child_command(
            "gan_deeplearning4j_tpu_torch.scenario.trainer_child",
            ["--res-path", os.path.join(root, name), "--data", data,
             *FLEET_CHILD_ARGS, *extra])
        return subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def finish(proc):
        out, err = proc.communicate(timeout=RES_CHILD_TIMEOUT_S)
        return proc.returncode, out.strip().splitlines(), err[-3000:]

    def ckpts(name):
        d = os.path.join(root, name, "checkpoints")
        return sorted(int(p[5:]) for p in os.listdir(d)
                      if p.startswith("ckpt_")) if os.path.isdir(d) else []

    t0 = time.perf_counter()
    ref = start("ref")
    term = start("term", "--step-delay-s", "0.02")
    deadline = time.monotonic() + RES_CHILD_TIMEOUT_S
    while not (os.path.exists(os.path.join(root, "term", "READY.json"))
               and ckpts("term")):
        require(term.poll() is None and time.monotonic() < deadline,
                f"fleet child: no checkpoint before exit or timeout "
                f"(rc {term.poll()})")
        time.sleep(0.02)
    term.send_signal(signal.SIGTERM)
    t_signal = time.perf_counter()
    rc_t, out_t, err_t = finish(term)
    preempt_s = time.perf_counter() - t_signal
    require(rc_t == 75, f"fleet child: SIGTERM gave exit {rc_t}: {err_t}")
    said = json.loads(out_t[-1])
    marker = json.loads(open(os.path.join(root, "term",
                                          "PREEMPTED.json")).read())
    require(said["preempted"] and said["step"] in ckpts("term")
            and marker["step"] == said["step"],
            f"fleet child: preempted {said}, marker {marker}, "
            f"checkpoints {ckpts('term')}")
    resumed = start("term", "--resume")
    rc_0, out_0, err_0 = finish(ref)
    require(rc_0 == 0, f"fleet child: exit {rc_0}: {err_0}")
    rc_r, out_r, err_r = finish(resumed)
    require(rc_r == 0, f"fleet child: the resume's exit {rc_r}: {err_r}")
    finals = [json.loads(open(os.path.join(root, n, "final.json")).read())
              for n in ("ref", "term")]
    require(finals[0]["step"] == FLEET_CHILD_STEPS
            and finals[0]["quarantined"] == 2
            and math.isfinite(finals[0]["d_loss"]),
            f"fleet child: final {finals[0]}")
    require(finals[0] == finals[1], "fleet child: the resumed run's final "
            f"{finals[1]} is not the uninterrupted run's {finals[0]}")
    return {"tenants": FLEET_CHILD_TENANTS, "args": FLEET_CHILD_ARGS,
            "preempted_at": said["step"], "signal_to_exit_s": preempt_s,
            "final": finals[0], "resumed_bitwise": True,
            "checkpoints": ckpts("term"),
            "seconds": time.perf_counter() - t0,
            "shared_card": "the straight run beside the preempted and the "
            "resumed one"}


def fleet_serving(torch, root: str, ckpt_dir: str) -> dict:
    """The publisher and a ``--fleet`` replica under the control plane: one
    replica process (``serve.replica --fleet --fleet-tenants 64``, a fresh
    fleet) spawned by a ``ControlPlane``; a ``CheckpointPublisher`` over a
    directory holding the children's newest verified fleet checkpoint
    promotes it through the canary; ``poison_fleet_checkpoint_dir`` forges
    its verifying successor, which the publisher rejects (never deployed);
    a few requests for each of FLEET_SERVE_TENANTS through the replica's
    gateway, each held against the plain generator on that tenant's slice
    (SERVE_CPU_TOL), the plain route as tenant 0, unknown and negative
    tenants 404."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MI
    from gan_deeplearning4j_tpu_torch.serve import (
        Autoscaler,
        CheckpointPublisher,
        ControlPlane,
        GatewayClient,
        GatewayHTTPError,
        ReplicaLauncher,
    )
    from gan_deeplearning4j_tpu_torch.testing import chaos
    from gan_deeplearning4j_tpu_torch.train.fleet import FleetCheckpointer

    t0 = time.perf_counter()
    newest = FleetCheckpointer(ckpt_dir, sweep_debris=False) \
        .latest_verified_step()
    pub_dir = os.path.join(root, "published")
    os.makedirs(pub_dir)
    shutil.copytree(os.path.join(ckpt_dir, f"ckpt_{newest}"),
                    os.path.join(pub_dir, f"ckpt_{newest}"))
    launcher = ReplicaLauncher(
        buckets=FLEET_BUCKETS, log_dir=root,
        args=("--fleet", "--fleet-tenants", str(FLEET_CHILD_TENANTS)))
    cp = ControlPlane(launcher, autoscaler=Autoscaler(
        min_replicas=1, max_replicas=1, down_after=10 ** 9),
        tick_s=0.25, hold_ticks=2, max_rollbacks=2, p99_floor_ms=10_000.0)
    client = None
    out = {"published_from": newest}
    try:
        t1 = time.perf_counter()
        cp.start()
        out["spawn_s"] = time.perf_counter() - t1
        pub = CheckpointPublisher(pub_dir, controlplane=cp,
                                  deploy_timeout_s=120.0, stale_after_s=1e9)
        t1 = time.perf_counter()
        pub.poll_once()
        out["promote_s"] = time.perf_counter() - t1
        rep = pub.report()
        require(rep["last_step"] == newest and rep["promoted_total"] == 1
                and cp.deployment_status().get("state") == "promoted",
                f"fleet publish: {rep}, {cp.deployment_status()}")
        bad = chaos.poison_fleet_checkpoint_dir(pub_dir, tenant=0)
        t1 = time.perf_counter()
        pub.poll_once()
        out["reject_s"] = time.perf_counter() - t1
        rep = pub.report()
        require(rep["rejected_total"] == 1 and rep["last_step"] == newest
                and rep["promoted_total"] == 1
                and cp.deployment_status().get("step") == newest,
                f"fleet publish: the poisoned step {bad} was not rejected: "
                f"{rep}")
        out["publisher"] = {k: rep[k] for k in (
            "last_step", "promoted_total", "rejected_total",
            "rollback_total", "promoted_steps")}
        out["poisoned_step"] = bad
        proc = cp.process(cp.replica_names()[0])
        client = GatewayClient(proc.host, proc.port, retries=0)
        _, state, _ = FleetCheckpointer(pub_dir, sweep_debris=False).restore(
            step=newest)
        gen = MI.build_generator(device="cuda")
        rng = np.random.RandomState(FLEET_SEED)
        worst, served = 0.0, 0
        t1 = time.perf_counter()
        for t in FLEET_SERVE_TENANTS:
            gen.params = {layer: {k: v[t].to(gen.device) for k, v in lp.items()}
                          for layer, lp in state.gen_params.items()}
            for rows in (3, 8):
                z = rng.uniform(-1, 1, (rows, 2)).astype(np.float32)
                got = client.generate([z], tenant=str(t))[0]
                want = gen.output(torch.from_numpy(z).to(gen.device))[0] \
                    .cpu().numpy()
                err = float(np.abs(got - want).max())
                worst = max(worst, err)
                require(got.shape == want.shape and err <= SERVE_CPU_TOL,
                        f"fleet serve: tenant {t}, {rows} rows: max abs err "
                        f"{err}")
                if t == 0:
                    plain = client.generate([z])[0]
                    require(float(np.abs(plain - got).max()) <= SERVE_CPU_TOL,
                            "fleet serve: /v1/generate is not tenant 0")
                served += 1
        out["requests_s"] = time.perf_counter() - t1
        for t in (str(FLEET_CHILD_TENANTS), "-1"):
            try:
                client.generate([z], tenant=t)
                require(False, f"fleet serve: tenant {t} answered")
            except GatewayHTTPError as e:
                require((e.status, e.error_type) == (404, "unknown_tenant"),
                        f"fleet serve: tenant {t}: {e.status} {e.error_type}")
        out.update(tenants=list(FLEET_SERVE_TENANTS), requests=served,
                   max_abs_err=worst, tolerance=SERVE_CPU_TOL)
    finally:
        if client is not None:
            client.close()
        cp.stop()
    out["seconds"] = time.perf_counter() - t0
    return out


def fleet_phase(torch, smi: str, randn, bw: float, sms: int) -> dict:
    """The insurance fleet (module docstring, phase 19), each check
    required: the tenant-batched kernel, the graphed step over the sweep,
    the children, the publisher and the fleet replica."""
    t0 = time.perf_counter()
    row = fleet_kernel(torch, randn, bw, sms)
    row_bwd = fleet_kernel_bwd(torch, randn, bw, sms)
    sweep = fleet_sweep(torch)
    root = tempfile.mkdtemp(prefix="gan4j_fleet_")
    try:
        children = fleet_children(root)
        serving = fleet_serving(torch, root,
                                os.path.join(root, "ref", "checkpoints"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"nvidia_smi": smi, "kernel": row, "kernel_bwd": row_bwd,
            "step": sweep,
            "trainer_child": children, "serving": serving,
            "seconds": time.perf_counter() - t0}


# -- the tenant lifecycle ----------------------------------------------------

LC_BATCH = FLEET_B
LC_BUCKETS = (2, 4, 32, 64)
LC_STEPS = 10  # steps a window
LC_BIG = ("h100_l3", 100, 3, 30)  # the reference's width: 30 tenants (32)
LC_SMALL = ("h64_l2", 64, 2, 2)   # 2 tenants (bucket 2)
LC_GHOSTS = (40, 41, 42)          # one onboard / offboard cycle each
LC_GROW = (43, 44, 45)            # take h100_l3 past 32: the hop to 64
LC_RETURN = 5                     # offboarded with its checkpoint, then back
LC_POISON = 7                     # poison_tenant_params
LC_FEED = 11                      # TenantFeedPoisoner
LC_SEGMENTS = 46
LC_WINDOWS = 11
LC_POISON_W = 8                   # the window poison_tenant_params lands in
LC_FEED_W = 9                     # the window the feed poisoner arms
# the capacities warm-up captures (JAX ``_warm_caps``: every bucket up to
# one above the cohort's start)
LC_WARMED = {LC_BIG[0]: (2, 4, 32, 64), LC_SMALL[0]: (2, 4)}
# each cohort's train-mode BNs at batch 16, per tenant: (rows, features),
# act, as its masked step calls the tenant kernels (the discriminator's
# over the real and fake rows; h64_l2's classifier BN is 64 wide)
LC_BN = {LC_BIG[0]: FLEET_BN,
         LC_SMALL[0]: [((32, 12), "elu"), ((16, 2), "tanh"),
                       ((16, 12), "elu"), ((16, 64), "elu")]}


def lc_kernels(torch) -> dict:
    """Both tenant BN kernels at each cohort's BN shapes (LC_BN) and at
    every capacity its graphs are captured at (LC_WARMED), the plans the
    lifecycle's replays launch, on lanes of the lifecycle's kinds: the last
    lane a ghost's (one row repeated, BN variance 0: a ghost's zero data
    gives each later layer constant rows) and, from 3 lanes, the one
    before it all zeros.  Each against its plain version on the same
    inputs on the host, the forward at ``fleet_kernel``'s tolerances and
    the backward at FLEET_BWD_TOL (so the ghost lanes' outputs finite):
    the kernels sum each column in the CPU reference's order, and on a
    lane of variance 0 y is the mean's rounding times rsqrt(eps) ~ 316, so
    torch's CUDA reductions, which round the mean otherwise, move it by
    ~2e-5.  Then lane 0's x given a NaN: every other lane's outputs,
    forward and backward, bitwise those of the clean launch.  -> what was
    checked and the largest differences."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261021)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale + shift

    fwd_tol = [(1e-5, 1e-4), (1e-6, 1e-4), (1e-6, 1e-4)]
    atol, rtol = FLEET_BWD_TOL
    err_f = err_b = ghost_var = 0.0
    checked = []
    for key, caps in LC_WARMED.items():
        for cap in caps:
            for (b, f), act in LC_BN[key]:
                at = f"{key}@{cap} [{cap},{b},{f}] {act}"
                x = randn(cap, b, f, scale=0.5, shift=0.2)
                x[-1] = randn(1, f, scale=0.5)
                if cap >= 3:
                    x[-2] = 0.0
                gm = randn(cap, f, scale=0.1, shift=1.0)
                bt = randn(cap, f, scale=0.1)
                got = kernels.fused_bn_act_train_tenants(x, gm, bt, 1e-5, act)
                want = bn2d.bn_act_tenants_plain(x.cpu(), gm.cpu(), bt.cpu(),
                                                 1e-5, act)
                for a, p_, (at_, rt_) in zip(got, want, fwd_tol):
                    require(within(a.cpu(), p_, at_, rt_), "bn_act_tenants "
                            f"disagrees with its plain version at {at}")
                    err_f = max(err_f, max_err(a.cpu(), p_))
                _, mean, var = got
                # E[x^2] - E[x]^2 of one repeated row: zero up to rounding
                ghost_var = max(ghost_var, float(var[-1].abs().max()))
                cot = (randn(cap, b, f), randn(cap, f), randn(cap, f))
                gb = kernels.bn_act_tenants_bwd(x, gm, bt, mean, var, *cot,
                                                1e-5, act)
                wb = bn2d.bn_act_tenants_bwd_plain(
                    *(t.cpu() for t in (x, gm, bt, mean, var, *cot)), 1e-5,
                    act)
                for a, p_ in zip(gb, wb):
                    require(within(a.cpu(), p_, atol, rtol),
                            "bn_act_tenants_bwd disagrees with its plain "
                            f"version at {at}")
                    err_b = max(err_b, max_err(a.cpu(), p_))
                xn = x.clone()
                xn[0, 0, 0] = float("nan")
                gn = kernels.fused_bn_act_train_tenants(xn, gm, bt, 1e-5, act)
                bn = kernels.bn_act_tenants_bwd(xn, gm, bt, gn[1], gn[2],
                                                *cot, 1e-5, act)
                require(all(torch.equal(u[1:], v[1:])
                            for u, v in zip((*gn, *bn), (*got, *gb))),
                        f"lifecycle kernels: a NaN in lane 0 moved another "
                        f"lane at {at}")
                checked.append(at)
    return {"checked": checked, "max_abs_err": err_f,
            "bwd_max_abs_err": err_b, "ghost_var_max_abs": ghost_var,
            "lanes": "the last a ghost's (variance 0), from 3 lanes the one "
                     "before it zeros; lane 0 then given a NaN (the others "
                     "bitwise)"}


def lc_run(torch, root: str, poison: bool) -> dict:
    """One lifecycle run (``train/lifecycle.py``, the JAX ``bench.py``
    ``lifecycle_dryrun`` at the reference's width): two cohorts, windows of
    LC_STEPS steps, the membership events of the ``lifecycle_phase``
    docstring, with or without the two poisonings; the launch counters
    zeroed after the warm-up and read after the last window."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.testing import chaos
    from gan_deeplearning4j_tpu_torch.train import lifecycle as L

    specs = ([L.TenantSpec(i, LC_BIG[1], LC_BIG[2]) for i in range(LC_BIG[3])]
             + [L.TenantSpec(LC_BIG[3] + i, LC_SMALL[1], LC_SMALL[2])
                for i in range(LC_SMALL[3])])
    cfg = L.LifecycleConfig(batch_size=LC_BATCH, buckets=LC_BUCKETS,
                            warm_buckets=None, res_path=root,
                            num_segments=LC_SEGMENTS, record_timelines=True,
                            device="cuda")
    m = L.FleetManager(specs, cfg)
    t0 = time.perf_counter()
    warmed = m.warmup()
    warm_s = time.perf_counter() - t0

    def feed(w):
        rng = np.random.RandomState(20261021 + w)
        return (rng.rand(LC_SEGMENTS * LC_BATCH, 12).astype(np.float32),
                (rng.rand(LC_SEGMENTS * LC_BATCH) < 0.5).astype(np.float32))

    poisoner = chaos.TenantFeedPoisoner(feed, LC_FEED, LC_SEGMENTS)
    spec = lambda t: L.TenantSpec(t, LC_BIG[1], LC_BIG[2])  # noqa: E731
    window_s, caps, back = [], [], None
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for w in range(LC_WINDOWS):
        if 1 <= w <= len(LC_GHOSTS):
            m.onboard(spec(LC_GHOSTS[w - 1]))
        if 2 <= w <= len(LC_GHOSTS) + 1:
            m.offboard(LC_GHOSTS[w - 2])
        if w == 5:
            for t in LC_GROW:
                m.onboard(spec(t))
        if w == 6:
            back = os.path.dirname(m.offboard(LC_RETURN))
        if w == 7:
            m.onboard(spec(LC_RETURN), from_checkpoint=back)
        if poison and w == LC_POISON_W:
            chaos.poison_tenant_params(m, LC_POISON)
        if poison and w == LC_FEED_W:
            poisoner.arm()
        feats, labs = poisoner(w)
        caps.append({k: c.capacity for k, c in m.cohorts.items()})
        t1 = time.perf_counter()
        m.step_window(feats, labs, LC_STEPS)
        window_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    # the ghost lanes' losses in the last window: finite (zero data, BN
    # variance 0 on every ghost feature)
    ghosts_finite = True
    for c in m.cohorts.values():
        g = c.lane_graphs[c.capacity]
        rows = [(g.steps - LC_STEPS + i) % g.ring for i in range(LC_STEPS)]
        ring = torch.stack([g.losses[r] for r in rows]).view(
            LC_STEPS, -1, 3).cpu()
        for slot, t in enumerate(c.slots):
            if t is None:
                ghosts_finite &= bool(torch.isfinite(ring[:, slot]).all())
    lanes = {t: L._host_row(c.state, c.slot_of(t))
             for c in m.cohorts.values() for t in c.occupied_ids()}
    return {"manager": m, "warmed": warmed, "warm_s": warm_s,
            "window_s": window_s, "capacities": caps,
            "launches": launches, "ghosts_finite": ghosts_finite,
            "lanes": lanes}


def lifecycle_phase(torch, smi: str) -> dict:
    """The tenant lifecycle on the card (the JAX ``bench.py:1327``
    ``lifecycle_dryrun``): ``LifecycleConfig(batch_size=16, buckets=(2, 4,
    32, 64), warm_buckets=None)``, cohort h100_l3 (the reference's
    insurance MLP-GAN: 30 tenants, bucket 32, warmed 2 / 4 / 32 / 64) and
    h64_l2 (2 tenants, bucket 2, warmed 2 / 4), LC_WINDOWS windows of
    LC_STEPS steps.  Events: three onboard / offboard cycles through a ghost
    slot; three onboards taking h100_l3 past 32 tenants (the hop to 64); an
    offboard with its final checkpoint and the re-onboard from it; then,
    in the chaos run only, ``poison_tenant_params`` on one tenant and
    ``TenantFeedPoisoner`` on another.  Required: 0 captures after warm-up;
    exactly the poisoned tenants quarantined; every survivor's per-step
    losses and final lane bitwise the control run's, each poisoned
    tenant's up to its poisoning's window; every (cohort, capacity) graph
    launching the tenant kernels and ``fused_update`` at the counts its
    graphs give (4 + 4 + 3 a step at both widths) and the counters at
    those counts over the windows; the ghost lanes finite.  Reports the
    onboard latency (median, IQR), each (cohort, capacity)'s device ms a
    step, the quarantine windows' seconds and the captures.  First, the
    tenant kernels at the lifecycle's shapes, capacities and lane kinds
    (``lc_kernels``)."""
    import numpy as np

    t0 = time.perf_counter()
    at_shapes = lc_kernels(torch)
    root = tempfile.mkdtemp(prefix="gan4j_lifecycle_")
    try:
        ctl = lc_run(torch, f"{root}/control", poison=False)
        run = lc_run(torch, f"{root}/chaos", poison=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mc, mr = ctl["manager"], run["manager"]
    require(ctl["warmed"] == run["warmed"] == {
        k: list(v) for k, v in LC_WARMED.items()},
        f"lifecycle: warmed {run['warmed']}")
    require(mc.captures_after_warmup == mr.captures_after_warmup == 0,
            f"lifecycle: {mr.captures_after_warmup} captures after warm-up")
    require(mc.quarantined == {}
            and mr.quarantined == {LC_POISON: "nan",
                                   LC_FEED: "data-quarantine-budget"},
            f"lifecycle: quarantined {mr.quarantined} (control "
            f"{mc.quarantined})")
    require(run["capacities"][-1][LC_BIG[0]] == 64
            and run["capacities"][4][LC_BIG[0]] == 32,
            f"lifecycle: capacities {run['capacities']}")
    cut = {LC_POISON: LC_POISON_W * LC_STEPS, LC_FEED: LC_FEED_W * LC_STEPS}
    for t, hist in mc.loss_history.items():
        got = mr.loss_history[t]
        n = cut.get(t, len(hist["d"]))
        require(n <= len(got["d"]) and all(
            got[k][:n] == hist[k][:n] for k in ("d", "g", "clf")),
            f"lifecycle: tenant {t}'s losses differ from the control's "
            f"within its first {n} steps")
    survivors = [t for t in ctl["lanes"] if t not in cut]
    for t in survivors:
        a = fused_leaves(ctl["lanes"][t])
        b = fused_leaves(run["lanes"][t])
        require(all(torch.equal(a[k], b[k]) for k in a),
                f"lifecycle: survivor {t}'s final lane differs from the "
                "control's")
    # the launches: each (cohort, capacity) graph's per replay, and the
    # counters over every window
    per_graph, want = {}, {}
    for res in (ctl, run):
        for key, c in res["manager"].cohorts.items():
            for cap, g in c.lane_graphs.items():
                got = {k: g.launches.get(k, 0) for k in LC_KERNELS}
                require(got["bn_act_tenants"] == len(LC_BN[key]),
                        f"lifecycle: {key} has {got['bn_act_tenants']} "
                        f"tenant BNs, LC_BN checks {len(LC_BN[key])}")
                require(got == c.launches_per_step(),
                        f"lifecycle: {key}@{cap} launches {got} a step, not "
                        f"{c.launches_per_step()}")
                per_graph[f"{key}@{cap}"] = got
    for key, c in mr.cohorts.items():
        for k, n in c.launches_per_step().items():
            want[k] = want.get(k, 0) + n * LC_STEPS * LC_WINDOWS
    for res in (ctl, run):
        got = {k: res["launches"][k] for k in LC_KERNELS}
        require(got == want, f"lifecycle: launches {got} over the windows, "
                f"not {want}")
        others = {k: v for k, v in res["launches"].items()
                  if k not in LC_KERNELS and v}
        require(not others, f"lifecycle: other kernels launched {others}")
    require(ctl["ghosts_finite"] and run["ghosts_finite"],
            "lifecycle: a ghost lane's losses are not finite")
    onboard = list(mr._onboard_ms)
    q1, med, q3 = np.percentile(onboard, [25, 50, 75])
    return {
        "nvidia_smi": smi, "batch": LC_BATCH, "buckets": LC_BUCKETS,
        "steps_per_window": LC_STEPS, "windows": LC_WINDOWS,
        "cohorts": {LC_BIG[0]: LC_BIG[3], LC_SMALL[0]: LC_SMALL[3]},
        "warmed": run["warmed"], "warm_s": [ctl["warm_s"], run["warm_s"]],
        "captures": mr.captures,
        "captures_after_warmup": mr.captures_after_warmup,
        "capacities": run["capacities"],
        "quarantined": {str(k): v for k, v in mr.quarantined.items()},
        "survivors_bitwise": len(survivors),
        "onboard_ms": {"median": med, "iqr": q3 - q1, "n": len(onboard),
                       "all": onboard},
        "device_ms_per_step": {
            f"{k}@{cap}": v for (k, cap), v in
            mr.window_device_ms.items()},
        "window_s": run["window_s"],
        "quarantine_window_s": {
            "param_poison": run["window_s"][LC_POISON_W],
            "feed_poison": run["window_s"][LC_FEED_W]},
        "launches_per_step": per_graph,
        "launches": {k: run["launches"][k] for k in LC_KERNELS},
        "kernels_at_lifecycle_shapes": at_shapes,
        "steps": LC_STEPS * LC_WINDOWS,
        "seconds": time.perf_counter() - t0}


LC_KERNELS = ("bn_act_tenants", "bn_act_tenants_bwd", "fused_update")


def fused_leaves(state) -> dict:
    from gan_deeplearning4j_tpu_torch.train import fused_step

    return fused_step._leaves(state)


# -- the frozen extractors' recipes -------------------------------------------

EX_TOL = 0.02  # a retrained extractor's held-out score below the zip's, at most
PR_CHILDREN = ("roadmap_cgan_mp", "cv_main_bf16_mp")  # what the child is beside
EX_CHILD = """
import json, sys, time, torch
import chip_smoke
chip_smoke.T_START = time.perf_counter()
print(json.dumps(chip_smoke.extractors_phase(torch, {smi!r})), flush=True)
"""
EX_FID_N = 2000  # rows of each fixed MNIST sample set of the frozen FID


def extractors_child(smi: str) -> dict:
    """``extractors_phase`` in a child process (beside the precision
    phase's children, for the script's limit): its line, each recipe's
    seconds under ``shared_card``."""
    rc, result, secs, tail = run_child_code(EX_CHILD.format(smi=smi))
    require(rc == 0 and result is not None,
            f"extractors: child exit {rc}, stderr {tail}")
    timed = ("data_s", "train_s")
    for row in result["families"].values():
        row["shared_card"] = shared_card(
            list(PR_CHILDREN), **{k: row.pop(k) for k in timed})
    result["shared_card"] = shared_card(list(PR_CHILDREN),
                                        seconds=result.pop("seconds"),
                                        child_seconds=secs)
    return result


def extractors_phase(torch, smi: str) -> dict:
    """The three frozen extractors' recipes (``eval/fid_extractor.py``) on
    the card from the port's own init, each written under a temporary
    root: the recipe's seconds (its data, its training), the held-out score
    beside the committed zip's on the same held-out set (required within
    EX_TOL below it), and a frozen FID between two fixed MNIST sample sets
    through the new MNIST weights and through the committed ones.  Nothing
    is written under the JAX package (its assets' times are unchanged)."""
    from gan_deeplearning4j_tpu_torch.data import datasets
    from gan_deeplearning4j_tpu_torch.eval import fid as fid_lib
    from gan_deeplearning4j_tpu_torch.eval import fid_extractor as fx

    t0 = time.perf_counter()
    before = {f: os.stat(p).st_mtime_ns for f, p in fx.ASSET_PATHS.items()}
    root = tempfile.mkdtemp(prefix="gan4j_extractors_")
    out = {}
    try:
        for family in fx.FAMILIES:
            t1 = time.perf_counter()
            data = fx.recipe_data(family)
            t2 = time.perf_counter()
            graph = fx.TRAINERS[family]("cuda", log=None, data=data)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            held = fx.held_out_set(family)
            committed = fx._load(fx.ASSET_PATHS[family], "cuda")
            score = fx.held_out_score(graph, family, held)
            ref = fx.held_out_score(committed, family, held)
            path = fx.save_asset(graph, os.path.join(
                root, os.path.basename(fx.ASSET_PATHS[family])), family)
            require(os.path.getsize(path) > 0, f"extractors: no {path}")
            require(score >= ref - EX_TOL,
                    f"extractors: {family} held-out {score} against the "
                    f"committed zip's {ref} (tolerance {EX_TOL})")
            row = {"data_s": t2 - t1, "train_s": t3 - t2,
                   "steps": fx.RECIPES[family][3],
                   "held_out_score": score, "committed_score": ref,
                   "below_committed": ref - score}
            if family == "mnist":
                a = datasets.synthetic_mnist(EX_FID_N, seed=668)[0]
                b = datasets.synthetic_mnist(EX_FID_N, seed=669,
                                             noise=0.2)[0]
                row["frozen_fid"] = {
                    "new": fid_lib.compute_fid(graph, a, b,
                                               layer=fx.FEATURE_LAYER),
                    "committed": fid_lib.compute_fid(committed, a, b,
                                                     layer=fx.FEATURE_LAYER),
                    "sets": "synthetic_mnist 2000 rows, seed 668 against "
                            "seed 669 at noise 0.2"}
                require(all(math.isfinite(v) and v >= 0 for v in (
                    row["frozen_fid"]["new"], row["frozen_fid"]["committed"])),
                    f"extractors: frozen FID {row['frozen_fid']}")
            out[family] = row
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require({f: os.stat(p).st_mtime_ns for f, p in fx.ASSET_PATHS.items()}
            == before, "extractors: a committed asset was rewritten")
    return {"nvidia_smi": smi, "families": out, "tolerance": EX_TOL,
            "seconds": time.perf_counter() - t0}


# -- the elastic phase (23) and the scenario phase (24) -------------------------

EL_TENANTS = 4  # run_scenario's fleet: 4 tenants, batch 4, 16 rows a tenant
EL_B = 4
EL_ROWS = 16
EL_WORLDS = (1, 2, 4)  # the tenant meshes; 1 is the unsharded mesh step
EL_STEPS = 3  # replays compared across the worlds
EL_CALLS = 3  # timed calls of EL_K replays a world
EL_K = 20
EL_SEED = 23
# the fleet step's four train-mode BNs at batch EL_B, per tenant
EL_BN = [((2 * EL_B, 12), "elu"), ((EL_B, 2), "tanh"), ((EL_B, 12), "elu"),
         ((EL_B, 100), "elu")]
EL_INS_BAND = 0.05  # the world-1 resume's losses against the world-2 run's
EL_KEEP: dict = {}  # resume_dp's world-2 run, kept for the elastic phase


def el_kernels(torch) -> dict:
    """Both tenant BN kernels at the scenario's shapes (EL_BN at batch
    EL_B) with 1, 2 and 4 tenants a launch (a shard of EL_TENANTS at worlds
    4, 2 and 1): the forward at ``fleet_kernel``'s tolerances and the
    backward at FLEET_BWD_TOL against their plain versions on the host,
    from the same inputs and non-zero cotangents."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261022)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale + shift

    fwd_tol = [(1e-5, 1e-4), (1e-6, 1e-4), (1e-6, 1e-4)]
    atol, rtol = FLEET_BWD_TOL
    err_f = err_b = 0.0
    checked = []
    for n in (1, 2, 4):
        for (b, f), act in EL_BN:
            at = f"[{n},{b},{f}] {act}"
            x = randn(n, b, f, scale=0.5, shift=0.2)
            gm = randn(n, f, scale=0.1, shift=1.0)
            bt = randn(n, f, scale=0.1)
            got = kernels.fused_bn_act_train_tenants(x, gm, bt, 1e-5, act)
            want = bn2d.bn_act_tenants_plain(x.cpu(), gm.cpu(), bt.cpu(),
                                             1e-5, act)
            for a, p_, (at_, rt_) in zip(got, want, fwd_tol):
                require(within(a.cpu(), p_, at_, rt_), "bn_act_tenants "
                        f"disagrees with its plain version at {at}")
                err_f = max(err_f, max_err(a.cpu(), p_))
            cot = (randn(n, b, f), randn(n, f), randn(n, f))
            gb = kernels.bn_act_tenants_bwd(x, gm, bt, got[1], got[2], *cot,
                                            1e-5, act)
            wb = bn2d.bn_act_tenants_bwd_plain(
                *(t.cpu() for t in (x, gm, bt, got[1], got[2], *cot)), 1e-5,
                act)
            for a, p_ in zip(gb, wb):
                require(within(a.cpu(), p_, atol, rtol), "bn_act_tenants_bwd "
                        f"disagrees with its plain version at {at}")
                err_b = max(err_b, max_err(a.cpu(), p_))
            checked.append(at)
    return {"checked": checked, "max_abs_err": err_f,
            "bwd_max_abs_err": err_b,
            "tolerance": {"forward": fwd_tol, "backward": FLEET_BWD_TOL}}


def el_cause(torch) -> dict:
    """What of the fleet step depends on the number of tenants a launch on
    the card: each op of the step at EL_TENANTS tenants against the same
    inputs split into shards of 2 and of 1 tenant, bitwise or not -> {op:
    [shard sizes that differ]}.  The ops: the dense layers' ``bmm`` at
    the insurance widths (rows EL_B and 2 * EL_B), the per-tenant loss
    (``vmap`` of the XENT mean), a bias gradient's row sum, and the two
    tenant BN kernels at EL_BN."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops import losses as loss_lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261023)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    n = EL_TENANTS
    ops = {}
    for rows in (EL_B, 2 * EL_B):
        for f, h in ((12, 100), (100, 100), (100, 1), (2, 100), (100, 12)):
            x, w = randn(n, rows, f), randn(n, f, h)
            ops[f"bmm [{rows},{f}]x[{f},{h}]"] = (torch.bmm, (x, w))
    xent = loss_lib.get("xent")
    p_ = torch.sigmoid(randn(n, 2 * EL_B, 1))
    y = (randn(n, 2 * EL_B, 1) > 0).float()
    ops["vmap xent"] = (lambda a, b: torch.func.vmap(xent)(a, b), (p_, y))
    ops["row sum [8,100]"] = (lambda a: a.sum(1), (randn(n, 2 * EL_B, 100),))
    for (b_, f), act in EL_BN:
        ins = (randn(n, b_, f) * 0.5 + 0.2, randn(n, f) * 0.1 + 1.0,
               randn(n, f) * 0.1)
        ops[f"bn_act_tenants [{b_},{f}] {act}"] = (
            lambda *t, act=act: kernels.fused_bn_act_train_tenants(
                *t, 1e-5, act), ins)
    out = {}
    for name, (fn, args) in ops.items():
        full = fn(*args)
        full = full if isinstance(full, tuple) else (full,)
        bad = []
        for per in (2, 1):
            parts = [fn(*(a[i:i + per] for a in args))
                     for i in range(0, n, per)]
            parts = [p if isinstance(p, tuple) else (p,) for p in parts]
            if not all(torch.equal(f_, torch.cat([p[j] for p in parts]))
                       for j, f_ in enumerate(full)):
                bad.append(per)
        out[name] = bad
    return out


def el_sharded(torch) -> dict:
    """The fleet step on a tenant mesh of 1, 2 and 4 shards sharing the
    card (``parallel/fleet.py``: a ``GraphedShards``, one CUDA graph a
    shard, each drawing its tenants' latents from their global ids), from
    one start, tables and targets: EL_STEPS replays with the launch
    counters zeroed just before and read just after (FLEET_PER_STEP a step
    a shard), the captures (one a shard, none after warm-up through the
    timed calls), the losses of every replay and the final state of worlds
    2 and 4 against world 1's: bitwise, or else the first step within
    FLEET_TOL (a one-step band), the drift after EL_STEPS reported and the
    cause named (``el_cause``: the ops whose bits depend on the tenants a
    launch); and each world's device ms a step (EL_CALLS calls of EL_K
    replays, median)."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.parallel import fleet as pfleet
    from gan_deeplearning4j_tpu_torch.runtime import prng
    from gan_deeplearning4j_tpu_torch.train import fleet as FL
    from gan_deeplearning4j_tpu_torch.train import fused_step as FT
    from gan_deeplearning4j_tpu_torch.utils import device as device_lib

    rng = np.random.RandomState(EL_SEED)
    feats = torch.from_numpy(rng.rand(EL_TENANTS, EL_ROWS, 12)
                             .astype(np.float32)).cuda()
    labs = torch.from_numpy((rng.rand(EL_TENANTS, EL_ROWS, 1) < 0.5)
                            .astype(np.float32)).cuda()
    ones = np.ones((EL_B, 1), np.float32)
    targets = [torch.from_numpy(a).cuda() for a in (
        ones + (0.05 * rng.randn(EL_B, 1)).astype(np.float32),
        (0.05 * rng.randn(EL_B, 1)).astype(np.float32), ones)]
    graphs, maps = _fleet_graphs("cuda")
    start = FL.replicate_state(FT.state_from_graphs(*graphs), EL_TENANTS)
    step = FL.make_fleet_step(*graphs, *maps, z_size=2, num_features=12,
                              per_tenant_data=True)
    key = prng.stream_seed(EL_SEED, "fleet-z")
    captures = [0]
    begin = torch.cuda.CUDAGraph.capture_begin

    def counted_begin(self, *a, **kw):
        captures[0] += 1
        return begin(self, *a, **kw)

    out, ref = {}, None
    torch.cuda.CUDAGraph.capture_begin = counted_begin
    try:
        for world in EL_WORLDS:
            mesh = pfleet.tenant_mesh(world, "cuda")
            caps = captures[0]
            t0 = time.perf_counter()
            gs = pfleet.GraphedShards(
                step, pfleet.shard_fleet_state(start, mesh),
                pfleet.split_inputs(mesh, feats, labs, *targets, True),
                pfleet.shard_tenant_ids(mesh, EL_TENANTS), key, 2)
            setup_s = time.perf_counter() - t0
            made = captures[0] - caps
            kernels.reset_launch_counts()
            rows = gs.launch(1)
            torch.cuda.synchronize()
            first = pfleet.gather_fleet_state(gs.states)
            rows += gs.launch(EL_STEPS - 1)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            want = {k: FLEET_PER_STEP.get(k, 0) * world * EL_STEPS
                    for k in counts}
            require(counts == want, f"elastic: world {world} launched "
                    f"{counts} over {EL_STEPS} steps, not {want}")
            rings = [np.asarray(device_lib.readback(g.losses)) for g in
                     gs.graphs]
            losses = torch.from_numpy(np.stack([np.concatenate(
                [r[row].reshape(-1, 3) for r in rings]) for row in rows]))
            state = pfleet.gather_fleet_state(gs.states)
            require(bool(torch.isfinite(losses).all()),
                    f"elastic: non-finite losses at world {world}")
            caps = captures[0]
            times = []
            for _ in range(EL_CALLS):
                start_ev = torch.cuda.Event(enable_timing=True)
                end_ev = torch.cuda.Event(enable_timing=True)
                start_ev.record()
                gs.launch(EL_K)
                end_ev.record()
                end_ev.synchronize()
                times.append(start_ev.elapsed_time(end_ev) / EL_K)
            recaptures = captures[0] - caps
            require(made == world and recaptures == 0,
                    f"elastic: world {world} captured {made} graphs "
                    f"({world} wanted) and {recaptures} after warm-up")
            row = {"shards": world, "tenants_a_shard": EL_TENANTS // world,
                   "captures": made, "captures_after_warmup": recaptures,
                   "launches": counts,
                   "launches_a_step_a_shard": {
                       k: v // (world * EL_STEPS) for k, v in counts.items()},
                   "step_ms": statistics.median(times), "step_ms_calls": times,
                   "setup_s": setup_s}
            if ref is None:
                ref = (first, state, losses)
            else:
                def same(a_state, b_state):
                    return all(torch.equal(a, b) for a, b in zip(
                        FT._leaves(a_state).values(),
                        FT._leaves(b_state).values()))

                bitwise = torch.equal(losses, ref[2]) and same(state, ref[1])
                row["bitwise_world_1"] = bitwise
                if not bitwise:
                    # FLEET_TOL bounds one step (the card's against the
                    # CPU's): held on the first replay; the drift after
                    # EL_STEPS is reported
                    one = _fleet_diff((ref[0], [ref[2][0]]),
                                      (first, [losses[0]]))
                    row["vs_world_1_first_step"] = one
                    row["vs_world_1_after_steps"] = _fleet_diff(
                        (ref[1], [ref[2].reshape(-1)]),
                        (state, [losses.reshape(-1)]))
                    row["first_step_bitwise"] = (
                        torch.equal(losses[0], ref[2][0])
                        and same(first, ref[0]))
                    cause = {op: bad for op, bad in el_cause(torch).items()
                             if EL_TENANTS // world in bad}
                    row["cause"] = cause
                    require(all(one[k] <= FLEET_TOL[k] for k in FLEET_TOL),
                            f"elastic: world {world}'s first step against "
                            f"world 1's {one} outside {FLEET_TOL} (ops that "
                            f"depend on the tenants a launch: {cause})")
            out[str(world)] = row
            del gs
    finally:
        torch.cuda.CUDAGraph.capture_begin = begin
    return {"tenants": EL_TENANTS, "batch": EL_B, "rows": EL_ROWS,
            "steps_compared": EL_STEPS, "worlds": out, "tolerance": FLEET_TOL}


def el_checkpoint(torch) -> dict:
    """A fleet checkpoint written by a tenant mesh of 2 on the card,
    restored onto meshes of 1 and 4: every tenant's state bitwise the
    written one, ``__reshard__`` from 2, and the seconds the reshard paid
    (gather to the host, split, place on the card)."""
    from gan_deeplearning4j_tpu_torch.parallel import fleet as pfleet
    from gan_deeplearning4j_tpu_torch.train import fleet as FL
    from gan_deeplearning4j_tpu_torch.train import fused_step as FT

    graphs, _ = _fleet_graphs("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(EL_SEED)
    state = FL._map_state(
        lambda t: t + 0.01 * torch.randn(t.shape, generator=gen, device="cuda")
        if t.is_floating_point() else t,
        FL.replicate_state(FT.state_from_graphs(*graphs), EL_TENANTS))
    mesh2 = pfleet.tenant_mesh(2, "cuda")
    root = tempfile.mkdtemp(prefix="gan4j_el_ckpt_")
    out = {}
    try:
        ck = FL.FleetCheckpointer(root)
        ck.save(1, pfleet.shard_fleet_state(state, mesh2), mesh=mesh2)
        for world in (1, 4):
            _, shards, extra = ck.restore(
                target_mesh=pfleet.tenant_mesh(world, "cuda"))
            info = extra["__reshard__"]
            full = pfleet.gather_fleet_state(shards)
            bitwise = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
                FT._leaves(full).values(), FT._leaves(state).values()))
            require(len(shards) == world and bitwise
                    and info["from"]["device_count"] == 2
                    and info["to"]["device_count"] == world,
                    f"elastic: the world-2 fleet checkpoint at world {world}: "
                    f"{len(shards)} shards, bitwise {bitwise}, {info}")
            out[str(world)] = {"bitwise_per_tenant": True,
                               "reshard_s": info["seconds"],
                               "shards_on": sorted({str(s.it.device)
                                                    for s in shards})}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def el_insurance(torch) -> dict:
    """The resume phase's world-2 insurance run (``resume_dp``: two ranks,
    a checkpoint at RES_DP_STEPS[0]) restored in this process at world 1:
    its step-RES_DP_STEPS[0] checkpoint (the later ones pruned from a copy)
    resharded onto one card, then stepped to RES_DP_STEPS[1] as the
    graphed single-card step, the launch counters zeroed just before the
    training and read just after; its final losses within EL_INS_BAND of
    the world-2 run's."""
    from gan_deeplearning4j_tpu_torch.checkpoint import TrainCheckpointer
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.train import insurance_main
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    src, world2 = EL_KEEP["dir"], EL_KEEP["losses"]
    every, steps = RES_DP_STEPS
    res = tempfile.mkdtemp(prefix="gan4j_el_ins_")
    try:
        shutil.copytree(src, res, dirs_exist_ok=True)
        ck = TrainCheckpointer(os.path.join(res, "checkpoints"))
        ck.prune_above(every)
        spec = ck.mesh_spec(every)
        t = GANTrainer(device="cuda",
                       workload=insurance_main.InsuranceWorkload(),
                       config=insurance_main.default_config(
                           res_path=res, num_iterations=steps,
                           print_every=every, save_every=every,
                           metrics=False, checkpoint_every=every,
                           resume=True))
        report = t._mesh_report()
        require(t.steps == every and report["reshard_total"] == 1,
                f"elastic insurance: restored at {t.steps}, {report}")
        kernels.reset_launch_counts()
        result = t.train(log=None)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        n = steps - every
        want = {k: {"fused_update": 3 * n, "bn_act": 4 * n}.get(k, 0)
                for k in counts}
        require(counts == want, f"elastic insurance: launches {counts}, not "
                f"{want}")
        losses = {k: float(result[k]) for k in ("d_loss", "g_loss")}
        rel = {k: abs(losses[k] - world2[k]) / max(abs(world2[k]), 1e-6)
               for k in losses}
        require(all(v <= EL_INS_BAND for v in rel.values()),
                f"elastic insurance: world-1 losses {losses} against the "
                f"world-2 run's {world2}: {rel} outside {EL_INS_BAND}")
        return {"saved_spec": spec, "restored_at": every, "steps": steps,
                "launches": counts,
                "losses": losses, "world2_losses": world2, "rel": rel,
                "band": EL_INS_BAND, "graphed": result["graphed"]}
    finally:
        shutil.rmtree(res, ignore_errors=True)


def elastic_phase(torch, smi: str) -> dict:
    """The tenant mesh and the elastic restore on the card (see the module
    docstring, phase 23)."""
    t0 = time.perf_counter()
    out = {"nvidia_smi": smi, "kernels": el_kernels(torch),
           "sharded": el_sharded(torch), "checkpoint": el_checkpoint(torch)}
    if EL_KEEP:
        out["insurance"] = el_insurance(torch)
    out["seconds"] = time.perf_counter() - t0
    return out


SC_TIMEOUT_S = 900  # the scenario child's bound (its own waits are bounded)
SC_CHILD = """
import glob, json, os, shutil, sys, tempfile, time
from gan_deeplearning4j_tpu_torch.scenario import run_scenario
out = tempfile.mkdtemp(prefix="gan4j_scenario_")
try:
    t0 = time.perf_counter()
    v = run_scenario(out, seed=23, soak=False, log=lambda s: None)
    wall = time.perf_counter() - t0
    launches = []
    for path in sorted(glob.glob(os.path.join(out, "trainer_*.log")),
                       key=lambda p: int(p.rsplit("_", 1)[1][:-4])):
        said = [json.loads(ln) for ln in open(path) if ln.startswith("{")]
        counted = [d["launches"] for d in said if "launches" in d]
        launches.append(counted[-1] if counted else None)
    keep = ("ok", "failures", "trainer", "control", "band",
            "band_clean_feed", "serving", "trace", "stages", "wall_s",
            "budget_s", "chaos")
    pub = v.get("publish", {})
    cp = v.get("controlplane", {})
    print(json.dumps({**{k: v.get(k) for k in keep},
                      "publish": {k: pub.get(k) for k in (
                          "rejected_total", "promoted_steps", "last_step",
                          "stale")},
                      "controlplane": {k: cp.get(k) for k in (
                          "rollbacks_total", "replaced_total")},
                      "trainer_launches": launches,
                      "child_wall_s": wall}, default=str), flush=True)
finally:
    shutil.rmtree(out, ignore_errors=True)
"""


def scenario_start():
    """``run_scenario`` on the card (seed 23, the JAX defaults, soak off) in
    a child process of a session of its own, started now -> a function
    that waits for it (killing the whole session past SC_TIMEOUT_S) and
    returns (exit code, its JSON line or None, seconds, stderr tail)."""
    argv, root, env = child_command(None, ["-c", SC_CHILD])
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    done = pool.submit(proc.communicate, timeout=SC_TIMEOUT_S)

    def wait():
        try:
            out, err = done.result()
        except subprocess.TimeoutExpired:
            import signal as signal_lib

            os.killpg(proc.pid, signal_lib.SIGKILL)
            out, err = proc.communicate()
        finally:
            pool.shutdown()
            with contextlib.suppress(ProcessLookupError):
                import signal as signal_lib

                os.killpg(proc.pid, signal_lib.SIGKILL)  # any straggler
        last = [ln for ln in out.splitlines() if ln.startswith("{")]
        return (proc.returncode, json.loads(last[-1]) if last else None,
                time.perf_counter() - t0, err[-3000:])

    return wait


def scenario_phase(smi: str, wait, beside) -> dict:
    """The scenario child's verdict, held to JAX's
    ``test_combined_chaos_scenario_end_to_end`` and ISSUE's checks: ``ok``,
    trainer exits [75, 82, 0], the poisoned checkpoint rejected and the
    direct poisoned deploy rolled back, no non-typed serving failure and at
    least 5 answered requests, at least 2 trainer incarnations, 2 replica
    hosts and 4 chaos events on the merged timeline, the final d/g losses
    within the band of the control's on the same feed (the clean-feed
    control's band, the JAX runner's, reported beside it).  Its seconds
    stand under ``shared_card`` (``beside`` ran meanwhile)."""
    rc, v, secs, tail = wait()
    require(rc == 0 and v is not None,
            f"scenario: child exit {rc}, stderr {tail}")
    if not v["ok"]:
        emit("scenario_verdict", **v)  # the evidence, before the failure
    require(v["ok"], f"scenario: verdict failures {v['failures']}")
    exits = v["trainer"]["exits"]
    require(exits == [75, 82, 0], f"scenario: trainer exits {exits}")
    # the verdict's own checks include canary_rollback: the direct
    # poisoned deploy ended rolled_back
    require(v["publish"]["rejected_total"] >= 1
            and v["controlplane"]["rollbacks_total"] >= 1,
            f"scenario: poison {v['publish']}, {v['controlplane']}")
    serving = v["serving"]
    require(not serving["non_typed"] and serving["ok"] >= 5,
            f"scenario: serving {serving}")
    trace = v["trace"]
    require(trace["trainer_incarnations"] >= 2
            and trace["replica_processes"] >= 2
            and trace["chaos_events"] >= 4, f"scenario: timeline {trace}")
    from gan_deeplearning4j_tpu_torch.scenario.runner import BAND

    require(all(b["rel"] <= BAND for b in v["band"].values())
            and set(v["band"]) == {"d_loss", "g_loss"},
            f"scenario: band {v['band']} outside {BAND}")
    return {"nvidia_smi": smi, "verdict_ok": True, "exits": exits,
            "incarnations": v["trainer"]["incarnations"],
            "band": v["band"], "band_limit": BAND,
            "band_clean_feed": v["band_clean_feed"],
            "serving": {k: serving[k] for k in (
                "requests", "ok", "typed_errors")},
            "publish": v["publish"], "controlplane": v["controlplane"],
            "trace": {k: trace.get(k) for k in (
                "trainer_incarnations", "replica_processes", "chaos_events",
                "reshards")},
            "trainer_launches": v["trainer_launches"],
            "shared_card": shared_card(beside, stages_s=v["stages"],
                                       wall_s=v["wall_s"],
                                       child_seconds=secs)}


def main() -> int:
    global T_START
    T_START = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from gan_deeplearning4j_tpu_torch.data.datasets import synthetic_mnist
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import build
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act_4d as bn4d
    from gan_deeplearning4j_tpu_torch.ops.cuda import fused_update as fu
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import (
        bn_act_plain,
        bn_apply_plain,
        bn_apply_sums_plain,
        bn_moments_plain,
    )
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act_4d import bn_act_4d_plain
    from gan_deeplearning4j_tpu_torch.ops.cuda.fused_update import (
        rmsprop_chain_plain,
    )
    from gan_deeplearning4j_tpu_torch.ops.cuda.upsample_bwd import (
        upsample_bwd_plain,
    )
    from gan_deeplearning4j_tpu_torch.parallel import mesh
    from gan_deeplearning4j_tpu_torch.runtime import backend
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    # -- 1. environment ------------------------------------------------------
    dev = backend.resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw = bandwidth_for(name)
    print(smi, flush=True)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=name, nvidia_smi=smi, device_count=torch.cuda.device_count(),
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_deterministic=torch.backends.cudnn.deterministic,
         cudnn_benchmark=torch.backends.cudnn.benchmark,
         bandwidth_bytes_per_s=bw)
    require(not torch.backends.cudnn.allow_tf32
            and not torch.backends.cuda.matmul.allow_tf32
            and torch.backends.cudnn.deterministic,
            "TF32 is on or cuDNN may pick nondeterministic algorithms; the "
            "port runs in f32 parity mode")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    per_kernel = build.build()
    ptxas = {n: [ln.strip() for ln in (build.build_dir() / f"lib{n}.log")
                 .read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in build.KERNELS
             if (build.build_dir() / f"lib{n}.log").exists()}
    emit("build", seconds=time.perf_counter() - t0, per_kernel=per_kernel,
         dir=str(build.build_dir()), ptxas=ptxas)

    # -- 3. kernels against their plain versions, and their times ------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    report = []

    # fused_update: one multi-leaf launch per graph update, over every
    # RmsProp leaf of the three trained graphs, with each leaf's own rates
    # as the protocol step runs it
    cfg = M.CVConfig()
    dis = M.build_discriminator(cfg, dev)
    graphs = {"dis": dis, "gan": M.build_gan(cfg, dev),
              "classifier": M.build_classifier(dis, cfg)}
    updates = []
    for g in graphs.values():
        keys = [(layer, n) for layer, lp in g.params.items() for n in lp]
        shapes = [g.params[layer][n].shape for layer, n in keys]
        updates.append(dict(
            ps=[randn(*s, scale=0.05) for s in shapes],
            gs=[randn(*s, scale=0.02) for s in shapes],
            cs=[randn(*s, scale=1e-3).abs() for s in shapes],
            rates=[g.updater.rates(layer, n) for layer, n in keys],
            clip=g.updater.clip_threshold))

    def chains(u, gs=None):
        return kernels.fused_rmsprop_chains(
            u["ps"], u["gs"] if gs is None else gs, u["cs"], u["rates"],
            clip=u["clip"])

    def chains_plain(u):
        return [rmsprop_chain_plain(p, g, c, **r._asdict(), clip=u["clip"])
                for p, g, c, r in zip(u["ps"], u["gs"], u["cs"], u["rates"])]

    err, scalar_leaves, calls, n_elems = 0.0, 0, [], 0
    for name_g, u in zip(graphs, updates):
        sizes = [p.numel() for p in u["ps"]]
        calls.append(f"{name_g}: {len(sizes)} leaves, {sum(sizes)} elements")
        n_elems += sum(sizes)
        pk, ck = chains(u)
        for (pp, cp), a, b in zip(chains_plain(u), pk, ck):
            require(within(a, pp, 1e-6, 1e-5) and within(b, cp, 1e-12, 1e-5),
                    f"fused_update disagrees with its plain version on a "
                    f"{name_g} leaf {tuple(pp.shape)}")
            err = max(err, max_err(a, pp), max_err(b, cp))
        # the same kernel launched once per leaf
        single = [kernels.fused_rmsprop_chain(p, g, c, **r._asdict(),
                                              clip=u["clip"])
                  for p, g, c, r in zip(u["ps"], u["gs"], u["cs"], u["rates"])]
        require(all(torch.equal(a, s[0]) and torch.equal(b, s[1])
                    for a, b, s in zip(pk, ck, single)),
                f"fused_update: the {name_g} launch differs from one launch "
                "per leaf")
        # the dp path's layout: the gradients as split views of one buffer,
        # from an odd element offset, so most leaves take the scalar path
        flat = torch.empty(1 + sum(sizes), device=dev)
        flat[1:] = torch.cat([g.reshape(-1) for g in u["gs"]])
        split = [v.view_as(g) for v, g in zip(flat[1:].split(sizes), u["gs"])]
        plan = fu.launch_plan(sizes, [p.data_ptr() | g.data_ptr() | c.data_ptr()
                                      for p, g, c in zip(u["ps"], split, u["cs"])],
                              u["rates"], u["clip"])
        require(len(plan.launches) == 1 and not all(plan.vec),
                f"fused_update: the {name_g} split layout plans "
                f"{len(plan.launches)} launches, vec {plan.vec}")
        scalar_leaves += plan.vec.count(False)
        ps2, cs2 = chains(u, split)
        require(all(torch.equal(a, b) for a, b in zip(pk + ck, ps2 + cs2)),
                f"fused_update: the {name_g} split views give other bits")
        ps3, cs3 = chains(u)
        require(all(torch.equal(a, b) for a, b in zip(pk + ck, ps3 + cs3)),
                f"fused_update: two {name_g} launches differ")

    def enqueue_ms():
        """The host's time to enqueue the three launches (the wrappers' own
        work, the device idle), median over REPS."""
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for u in updates:
                chains(u)
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    report.append(dict(
        name="fused_update", tolerance="|d| <= 1e-6 + 1e-5|plain| on p', "
        "1e-12 + 1e-5|plain| on the cache", max_abs_err=err, calls=calls,
        bitwise_single_leaf=True, bitwise_split_views=True,
        split_scalar_leaves=scalar_leaves, bitwise_repeat=True,
        ms=time_ms(lambda: [chains(u) for u in updates], torch),
        enqueue_ms=enqueue_ms(),
        plain_ms=time_ms(lambda: [chains_plain(u) for u in updates], torch),
        floor_ms=floor_ms(len(updates), torch),
        library_ms=None, bytes=20 * n_elems, flops=12 * n_elems))

    # the cluster BN kernels' plans at every shape this phase gives them:
    # the step's three 2-D BNs (all tanh), the JAX package's 4-D benchmark
    # shapes with C > 1 (benchmarks/pallas_bn_bench.py; no model path runs
    # the 4-D kernel) and one 4-D shape (21 MB) whose 2 MB channels do not
    # fit in a cluster's shared memory
    bn_shapes = [(BATCH, 2), (BATCH, 7 * 7 * 128), (BATCH, 1024)]
    shapes_4d = [(200, 64, 12, 12), (128, 64, 32, 32), (128, 128, 16, 16),
                 (128, 256, 8, 8), (128, 512, 4, 4)]
    streamed_4d = (32, 10, 128, 128)
    bn_in = [(randn(b, f, scale=0.5), randn(f, scale=0.1, shift=1.0),
              randn(f, scale=0.1)) for b, f in bn_shapes]
    in_4d = [(randn(*s, scale=0.5, shift=0.2), randn(s[1], scale=0.1, shift=1.0),
              randn(s[1], scale=0.1)) for s in shapes_4d + [streamed_4d]]
    sms = bn2d.sm_count(dev)
    # the sync-BN pair: the three 2-D BNs of a 2-rank step, per rank
    pair_shapes = [(BATCH // DP_WORLD, f) for _, f in bn_shapes]

    def plan_line(shape, plan):
        return {"shape": list(shape), **plan._asdict(),
                "branch": "resident" if plan.resident else "streamed"}

    plans_4d = [bn4d.launch_plan(b, c, h * w, x.data_ptr(), sms)
                for (b, c, h, w), (x, _, _) in zip(shapes_4d + [streamed_4d],
                                                   in_4d)]
    emit("plans", sms=sms,
         bn_act=[plan_line(s, bn2d.launch_plan(*s, sms)) for s in bn_shapes],
         bn_act_4d=[plan_line(s, p) for s, p in
                    zip(shapes_4d + [streamed_4d], plans_4d)],
         bn_moments=[{"shape": list(s), **bn2d.moments_plan(*s)._asdict()}
                     for s in pair_shapes],
         bn_apply=[{"shape": list(s), **bn2d.apply_plan(*s, sms)._asdict()}
                   for s in pair_shapes])
    require(not plans_4d[-1].resident and all(p.resident for p in plans_4d[:-1]),
            "bn_act_4d: the streamed shape must stream and the others not")
    err = 0.0
    for x, gm, bt in bn_in:
        yk, mk, vk = kernels.fused_bn_act_train(x, gm, bt, 1e-5, "tanh")
        yp, mp, vp = bn_act_plain(x, gm, bt, 1e-5, "tanh")
        require(within(yk, yp, 1e-5, 1e-4) and within(mk, mp, 1e-6, 1e-4)
                and within(vk, vp, 1e-6, 1e-4),
                f"bn_act disagrees with its plain version at {tuple(x.shape)}")
        err = max(err, max_err(yk, yp), max_err(mk, mp),
                  max_err(vk, vp))
    # the gradient: the kernel's autograd.Function against autograd
    # through the plain version
    x, gm, bt = (t.clone().requires_grad_(True) for t in bn_in[1])
    gy = randn(*x.shape)
    yk, _, _ = kernels.fused_bn_act_train(x, gm, bt, 1e-5, "tanh")
    gk = torch.autograd.grad(yk, (x, gm, bt), gy)
    yp, _, _ = bn_act_plain(x, gm, bt, 1e-5, "tanh")
    gp = torch.autograd.grad(yp, (x, gm, bt), gy)
    for a, b in zip(gk, gp):
        require(within(a, b, 1e-4, 1e-3), "bn_act gradient disagrees")
    require(bitwise_repeat(lambda *a: kernels.fused_bn_act_train(
        *a, 1e-5, "tanh"), bn_in, torch), "bn_act: two launches differ")
    torch_f = torch.nn.functional
    ms, library_ms, turns = in_turns(
        lambda: [kernels.fused_bn_act_train(x, gm, bt, 1e-5, "tanh")
                 for x, gm, bt in bn_in],
        lambda: [torch_f.batch_norm(x, None, None, gm, bt, training=True,
                                    eps=1e-5) for x, gm, bt in bn_in], torch)
    report.append(dict(
        name="bn_act", tolerance="|d| <= 1e-5 + 1e-4|plain| on y, "
        "1e-6 + 1e-4|plain| on mean/var", max_abs_err=err,
        calls=[f"[{b},{f}] tanh" for b, f in bn_shapes], bitwise_repeat=True,
        ms=ms, plain_ms=time_ms(lambda: [bn_act_plain(x, gm, bt, 1e-5, "tanh")
                                         for x, gm, bt in bn_in], torch),
        floor_ms=floor_ms(len(bn_in), torch),
        library_ms=library_ms, turns_ms=turns,
        library_call="F.batch_norm(training=True), without the activation",
        bytes=sum(8 * b * f + 16 * f for b, f in bn_shapes),
        flops=sum(10 * b * f for b, f in bn_shapes)))

    # upsample_bwd: the G-step backward of the generator's two upsamples
    up_shapes = [(BATCH, 128, 14, 14), (BATCH, 64, 28, 28)]
    up_in = [randn(*s) for s in up_shapes]
    err = 0.0
    for g in up_in:
        dk = kernels.upsample_bwd(g, 2, 2)
        dp = upsample_bwd_plain(g, 2, 2)
        require(within(dk, dp, 1e-5, 1e-5),
                f"upsample_bwd disagrees with its plain version at {tuple(g.shape)}")
        err = max(err, max_err(dk, dp))

    def library_block_sum(g):
        B, C, Hs, Ws = g.shape
        return g.view(B, C, Hs // 2, 2, Ws // 2, 2).sum((3, 5))

    report.append(dict(
        name="upsample_bwd", tolerance="|d| <= 1e-5 + 1e-5|plain|",
        max_abs_err=err,
        calls=[f"[{b},{c},{h},{w}] -> [{b},{c},{h // 2},{w // 2}]"
               for b, c, h, w in up_shapes],
        ms=time_ms(lambda: [kernels.upsample_bwd(g, 2, 2) for g in up_in], torch),
        plain_ms=time_ms(lambda: [upsample_bwd_plain(g, 2, 2) for g in up_in],
                         torch),
        floor_ms=floor_ms(len(up_in), torch),
        library_ms=time_ms(lambda: [library_block_sum(g) for g in up_in], torch),
        library_call="g.view(B,C,H,2,W,2).sum((3,5))",
        bytes=sum(4 * math.prod(s) * 5 // 4 for s in up_shapes),
        flops=sum(math.prod(s) for s in up_shapes)))

    # bn_moments / bn_apply: the three 2-D BNs of a 2-rank step, per rank
    # (the pair's gradient needs a group: it is checked in the dp phase)
    pair_in = [(randn(b, f, scale=0.5, shift=0.2), randn(f, scale=0.1, shift=1.0),
                randn(f, scale=0.1)) for b, f in pair_shapes]
    err = 0.0
    for x, _, _ in pair_in:
        for a, b in zip(kernels.bn_moments(x), bn_moments_plain(x)):
            require(within(a, b, 1e-6, 1e-4), "bn_moments disagrees with its "
                    f"plain version at {tuple(x.shape)}")
            err = max(err, max_err(a, b))
    require(bitwise_repeat(kernels.bn_moments, [(x,) for x, _, _ in pair_in],
                           torch), "bn_moments: two launches differ")
    # the float4 and the scalar path: the [100, 1024] input, and the same
    # values from an offset view
    x = pair_in[2][0]
    require(all(torch.equal(a, b) for a, b in zip(
        kernels.bn_moments(x), kernels.bn_moments(offset_view(x, torch)))),
        "bn_moments: the scalar path (offset view) gives other bits")
    ms, library_ms, turns = in_turns(
        lambda: [kernels.bn_moments(x) for x, _, _ in pair_in],
        lambda: [torch.var_mean(x, dim=0, unbiased=False)
                 for x, _, _ in pair_in], torch)
    report.append(dict(
        name="bn_moments", tolerance="|d| <= 1e-6 + 1e-4|plain|",
        max_abs_err=err, calls=[f"[{b},{f}]" for b, f in pair_shapes],
        bitwise_repeat=True, bitwise_scalar_path=True,
        gradient="checked in the dp phase (2 ranks)", ms=ms,
        plain_ms=time_ms(lambda: [bn_moments_plain(x) for x, _, _ in pair_in],
                         torch),
        floor_ms=floor_ms(len(pair_in), torch),
        library_ms=library_ms, turns_ms=turns,
        library_call="torch.var_mean(x, dim=0, unbiased=False)",
        bytes=sum(4 * b * f + 8 * f for b, f in pair_shapes),
        flops=sum(3 * b * f for b, f in pair_shapes)))

    # bn_apply as the step runs it: from the [2, F] sums the all-reduce
    # leaves, for worlds 1-4 (sums made from this rank's moments times the
    # world, plus noise); mean and var must be the old epilogue's bits
    def sums_for(x, world):
        mean, m2 = bn_moments_plain(x)
        noise = randn(2, x.shape[1], scale=1e-3)
        return torch.stack([mean, m2]) * world + noise * noise

    err, worlds = 0.0, (1, 2, 3, 4)
    for x, gm, bt in pair_in:
        for world in worlds:
            sums = sums_for(x, world)
            yk, mk, vk = kernels.bn_apply_sums(x, sums, world, gm, bt, 1e-5,
                                               "tanh")
            yp, mp, vp = bn_apply_sums_plain(x, sums, world, gm, bt, 1e-5,
                                             "tanh")
            mo, vo = old_epilogue(sums, world, torch)
            require(within(yk, yp, 1e-5, 1e-4), "bn_apply (from sums) "
                    f"disagrees with its plain version at {tuple(x.shape)}, "
                    f"world {world}")
            require(all(torch.equal(a, b) for a, b in
                        ((mk, mp), (vk, vp), (mk, mo), (vk, vo))),
                    f"bn_apply (from sums): mean/var at {tuple(x.shape)}, "
                    f"world {world} are not the old epilogue's bits")
            err = max(err, max_err(yk, yp))
        # the entry given mean and var (the wrapper bn_apply)
        yk = kernels.bn_apply(x, mp, vp, gm, bt, 1e-5, "tanh")
        require(within(yk, bn_apply_plain(x, mp, vp, gm, bt, 1e-5, "tanh"),
                       1e-5, 1e-4),
                f"bn_apply disagrees with its plain version at {tuple(x.shape)}")
    pairs = [(x, sums_for(x, DP_WORLD), gm, bt) for x, gm, bt in pair_in]
    require(bitwise_repeat(lambda x, s, gm, bt: kernels.bn_apply_sums(
        x, s, DP_WORLD, gm, bt, 1e-5, "tanh"), pairs, torch),
        "bn_apply: two launches differ")
    x, sums, gm, bt = pairs[2]
    require(all(torch.equal(a, b) for a, b in zip(
        kernels.bn_apply_sums(x, sums, DP_WORLD, gm, bt, 1e-5, "tanh"),
        kernels.bn_apply_sums(offset_view(x, torch), sums, DP_WORLD, gm, bt,
                              1e-5, "tanh"))),
        "bn_apply: the scalar path (offset view) gives other bits")
    moments = [old_epilogue(s, DP_WORLD, torch) for _, s, _, _ in pairs]
    ms, library_ms, turns = in_turns(
        lambda: [kernels.bn_apply_sums(x, s, DP_WORLD, gm, bt, 1e-5, "tanh")
                 for x, s, gm, bt in pairs],
        lambda: [torch_f.batch_norm(x, m, v, gm, bt, training=False, eps=1e-5)
                 for (x, _, gm, bt), (m, v) in zip(pairs, moments)], torch)
    report.append(dict(
        name="bn_apply", tolerance="|d| <= 1e-5 + 1e-4|plain| on y; mean and "
        "var bitwise equal to the torch epilogue", max_abs_err=err,
        calls=[f"[{b},{f}] tanh, from the sums of {DP_WORLD} ranks"
               for b, f in pair_shapes], worlds_checked=list(worlds),
        bitwise_repeat=True, bitwise_scalar_path=True,
        gradient="checked in the dp phase (2 ranks)", ms=ms,
        mean_var_entry_ms=time_ms(lambda: [
            kernels.bn_apply(x, m, v, gm, bt, 1e-5, "tanh")
            for (x, _, gm, bt), (m, v) in zip(pairs, moments)], torch),
        plain_ms=time_ms(lambda: [bn_apply_sums_plain(x, s, DP_WORLD, gm, bt,
                                                      1e-5, "tanh")
                                  for x, s, gm, bt in pairs], torch),
        floor_ms=floor_ms(len(pairs), torch),
        library_ms=library_ms, turns_ms=turns,
        library_call="F.batch_norm(training=False) on the epilogue's mean/var, "
        "without the epilogue or the activation",
        bytes=sum(8 * b * f + 24 * f for b, f in pair_shapes),
        flops=sum(10 * b * f + 5 * f for b, f in pair_shapes)))

    # bn_act_4d: the benchmark shapes and the streamed shape
    kernels.fused_bn_act_train_4d.launches = 0
    err = 0.0
    for x, gm, bt in in_4d:
        outk = kernels.fused_bn_act_train_4d(x, gm, bt, 1e-5, "tanh")
        outp = bn_act_4d_plain(x, gm, bt, 1e-5, "tanh")
        for a, b, (atol, rtol) in zip(outk, outp, [(1e-5, 1e-4), (1e-6, 1e-4),
                                                   (1e-6, 1e-4)]):
            require(within(a, b, atol, rtol), "bn_act_4d disagrees with its "
                    f"plain version at {tuple(x.shape)}")
            err = max(err, max_err(a, b))
    x, gm, bt = (t.clone().requires_grad_(True) for t in in_4d[0])
    gy = randn(*x.shape)
    yk, _, _ = kernels.fused_bn_act_train_4d(x, gm, bt, 1e-5, "tanh")
    gk = torch.autograd.grad(yk, (x, gm, bt), gy)
    yp, _, _ = bn_act_4d_plain(x, gm, bt, 1e-5, "tanh")
    gp = torch.autograd.grad(yp, (x, gm, bt), gy)
    for a, b in zip(gk, gp):
        require(within(a, b, 1e-4, 1e-3), "bn_act_4d gradient disagrees")
    require(bitwise_repeat(lambda *a: kernels.fused_bn_act_train_4d(
        *a, 1e-5, "tanh"), in_4d, torch), "bn_act_4d: two launches differ")
    bn4d_launches = kernels.fused_bn_act_train_4d.launches
    streamed_in = in_4d.pop()
    n_4d = [math.prod(s) for s in shapes_4d]
    ms, library_ms, turns = in_turns(
        lambda: [kernels.fused_bn_act_train_4d(x, gm, bt, 1e-5, "tanh")
                 for x, gm, bt in in_4d],
        lambda: [torch_f.batch_norm(x, None, None, gm, bt, training=True,
                                    eps=1e-5) for x, gm, bt in in_4d], torch)
    streamed_ms, streamed_library_ms, _ = in_turns(
        lambda: kernels.fused_bn_act_train_4d(*streamed_in, 1e-5, "tanh"),
        lambda: torch_f.batch_norm(streamed_in[0], None, None, *streamed_in[1:],
                                   training=True, eps=1e-5), torch)
    report.append(dict(
        name="bn_act_4d", tolerance="|d| <= 1e-5 + 1e-4|plain| on y, "
        "1e-6 + 1e-4|plain| on mean/var", max_abs_err=err,
        calls=[f"[{b},{c},{h},{w}] tanh" for b, c, h, w in shapes_4d],
        checked_also="[{},{},{},{}] tanh (streamed branch)".format(*streamed_4d),
        bitwise_repeat=True, ms=ms,
        plain_ms=time_ms(lambda: [bn_act_4d_plain(x, gm, bt, 1e-5, "tanh")
                                  for x, gm, bt in in_4d], torch),
        library_ms=library_ms, turns_ms=turns,
        streamed_ms=streamed_ms, streamed_library_ms=streamed_library_ms,
        streamed_bound_ms=8 * math.prod(streamed_4d) / bw * 1e3,
        floor_ms=floor_ms(len(in_4d), torch),
        library_call="F.batch_norm(training=True), without the activation",
        bytes=sum(8 * n + 16 * s[1] for n, s in zip(n_4d, shapes_4d)),
        flops=sum(10 * n for n in n_4d)))

    # the insurance step's kernels at its shapes
    ins_kernels = insurance_kernels(torch, randn, dev, bw, sms)
    emit("kernel_insurance", nvidia_smi=smi, **ins_kernels)
    # the sync-BN pair at the roadmap families' per-rank shapes (world 2)
    pd_rows = pd_kernels(torch, randn, bw)
    emit("kernel_roadmap_pair", nvidia_smi=smi,
         plans={f: {"bn_moments": bn2d.moments_plan(b, f_)._asdict(),
                    "bn_apply": bn2d.apply_plan(b, f_, sms)._asdict()}
                for f, ((b, f_), _) in RM_PAIR.items()}, **pd_rows)

    for r in report:
        t_bytes, t_ops = r["bytes"] / bw * 1e3, r["flops"] / PEAK_F32_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        emit("kernel", **r)
    del graphs, dis, updates, bn_in, up_in, pair_in, pairs, moments, in_4d
    del streamed_in

    # -- 4. the main path ----------------------------------------------------
    # as cv_main runs it on one card: the step captured as a CUDA graph (at
    # construction), MAIN_STEPS steps in calls of MAIN_K replays; the
    # counters count each replay as the launches its capture recorded
    trainer = GANTrainer(cfg, batch_size=BATCH, n_train=N_TRAIN, device="cuda",
                         steps_per_call=MAIN_K)
    n_leaves = sum(len(lp) for g in (trainer.dis, trainer.gan, trainer.classifier)
                   for lp in g.opt_state.values())
    kernels.reset_launch_counts()
    result = trainer.train(MAIN_STEPS, log=None)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    expected = {"fused_update": 3 * MAIN_STEPS,
                "bn_act": 3 * MAIN_STEPS, "upsample_bwd": 2 * MAIN_STEPS,
                "bn_moments": 0, "bn_apply": 0, "bn_act_4d": 0,
                "bn_act_tenants": 0,
                "bn_act_tenants_bwd": 0}
    losses = [result[k] for k in ("d_loss", "g_loss", "clf_loss")]
    grid = trainer.sample_grid(10)
    emit("main", steps=result["steps"], batch=BATCH, n_train=N_TRAIN,
         losses=losses, step_ms_median=result["step_ms_median"],
         img_per_s=result["img_per_s"], graphed=result["graphed"],
         steps_per_call=result["steps_per_call"],
         launches_per_replay=trainer.graphed.launches, launches=launches,
         expected_launches=expected, rmsprop_leaves=n_leaves,
         grid_shape=list(grid.shape))
    require(result["graphed"] and result["steps_per_call"] == MAIN_K,
            f"main: graphed {result['graphed']}, K {result['steps_per_call']}")
    require(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    require(launches == expected,
            f"launch counts {launches} != expected {expected}")
    require(tuple(grid.shape) == (100, 1, 28, 28)
            and bool(torch.isfinite(grid).all()), "bad latent grid")

    # -- 4b. the main phase's graphs through DL4J zips --------------------------
    dl4j = dl4j_phase(torch, smi, trainer)
    emit("dl4j", **dl4j)
    del trainer, grid

    # -- 5. one step on the card against one on the CPU ----------------------
    rng = torch.Generator().manual_seed(7)
    feats, labels = synthetic_mnist(BATCH, seed=11)
    host = dict(
        real=torch.from_numpy(feats),
        labels=torch_f.one_hot(torch.from_numpy(labels), 10).float(),
        y_real=1.0 + 0.05 * torch.randn((BATCH, 1), generator=rng),
        y_fake=0.05 * torch.randn((BATCH, 1), generator=rng),
        ones=torch.ones((BATCH, 1)),
        z1=torch.rand((BATCH, cfg.z_size), generator=rng) * 2 - 1,
        z2=torch.rand((BATCH, cfg.z_size), generator=rng) * 2 - 1)
    # cuDNN and the CPU sum the convolutions in other orders (f32, TF32
    # off; a conv weight gradient sums up to 200*14*14 terms): STEP_TOL
    out_cpu = run_step(*protocol_step("cpu"), host, "cpu")
    out_gpu = run_step(*protocol_step(dev), host, dev)
    loss_err, worst = step_diff(out_cpu, out_gpu)
    emit("parity", losses_cpu=[float(v) for v in out_cpu[1]],
         losses_cuda=[float(v) for v in out_gpu[1]], loss_rel_err=loss_err,
         worst=worst, tolerance=STEP_TOL)
    require_step_match("parity", loss_err, worst)
    del out_cpu, out_gpu

    # -- 6. the graphed step against the eager step --------------------------
    graph = graph_phase(cfg, torch)
    emit("graph", batch=BATCH, **graph)
    for label, res in graph.items():
        require(res["losses_bitwise"]
                and res["digest_eager"] == res["digest_graphed"],
                f"graph ({label}): the graphed step's bits differ from the "
                f"eager step's (losses max |d| {res['loss_max_abs_diff']})")

    # -- 7. data parallel ----------------------------------------------------
    n_cards = torch.cuda.device_count()
    ins_host = insurance_host(torch, INS_DP_STEPS)
    from gan_deeplearning4j_tpu_torch.telemetry.events import read_events

    rb_root = tempfile.mkdtemp(prefix="gan4j_rb_")
    try:
        ranks = mesh.spawn(dp_rank, DP_WORLD, (host, ins_host, rb_root),
                           device="cuda", timeout=DP_TIMEOUT_S)
        rb_events = read_events(f"{rb_root}/events.jsonl")
    finally:
        shutil.rmtree(rb_root, ignore_errors=True)
    r0 = ranks[0]
    dp_expected = {"fused_update": 3 * MAIN_STEPS,
                   "bn_act": 0, "upsample_bwd": 2 * MAIN_STEPS,
                   "bn_moments": 3 * MAIN_STEPS, "bn_apply": 3 * MAIN_STEPS,
                   "bn_act_4d": 0, "bn_act_tenants": 0,
                "bn_act_tenants_bwd": 0}
    dp_losses = [r0["result"][k] for k in ("d_loss", "g_loss", "clf_loss")]
    emit("dp", world=DP_WORLD, backend=r0["backend"],
         shared_card=n_cards < DP_WORLD,
         devices=[r["device"] for r in ranks], steps=r0["result"]["steps"],
         global_batch=BATCH, losses=dp_losses,
         step_ms_median=[r["result"]["step_ms_median"] for r in ranks],
         img_per_s=r0["result"]["img_per_s"],
         launches=[r["launches"] for r in ranks],
         expected_launches=dp_expected, rmsprop_leaves=r0["rmsprop_leaves"],
         digests=[r["digest"] for r in ranks],
         pair_max_abs_err=[r["pair_max_abs_err"] for r in ranks],
         grad_allreduce_ms=[r["grad_allreduce_ms"] for r in ranks],
         step_vs_single=[r["step_vs_single"] for r in ranks],
         tolerance=STEP_TOL)
    require(r0["backend"] == ("nccl" if n_cards >= DP_WORLD else "gloo"),
            f"dp: backend {r0['backend']} with {n_cards} cards")
    require(all(math.isfinite(v) for v in dp_losses),
            f"dp: non-finite losses {dp_losses}")
    for r in ranks:
        require(r["launches"] == dp_expected,
                f"dp rank {r['rank']}: launch counts {r['launches']} != "
                f"expected {dp_expected}")
        require_step_match(f"dp rank {r['rank']} 2-rank step vs single",
                           *r["step_vs_single"])
    require(len({r["digest"] for r in ranks}) == 1,
            "dp: the ranks' states differ after the run")
    pa_expected = {"fused_update": 3 * PA_STEPS, "bn_act": 3 * PA_STEPS,
                   "upsample_bwd": 2 * PA_STEPS, "bn_moments": 0,
                   "bn_apply": 0, "bn_act_4d": 0, "bn_act_tenants": 0,
                "bn_act_tenants_bwd": 0}
    pa_losses = [r0["pa_result"][k] for k in ("d_loss", "g_loss", "clf_loss")]
    emit("dp_param_averaging", world=DP_WORLD, backend=r0["backend"],
         steps=r0["pa_result"]["steps"], averaging_frequency=PA_FREQ,
         losses=pa_losses,
         step_ms_median=[r["pa_result"]["step_ms_median"] for r in ranks],
         launches=[r["pa_launches"] for r in ranks],
         expected_launches=pa_expected,
         digests=[r["pa_digest"] for r in ranks])
    require(r0["pa_result"]["steps"] == PA_STEPS
            and not r0["pa_result"]["fused"],
            f"dp param_averaging: {r0['pa_result']}")
    require(all(math.isfinite(v) for v in pa_losses),
            f"dp param_averaging: non-finite losses {pa_losses}")
    for r in ranks:
        require(r["pa_launches"] == pa_expected,
                f"dp param_averaging rank {r['rank']}: launch counts "
                f"{r['pa_launches']} != expected {pa_expected}")
    require(len({r["pa_digest"] for r in ranks}) == 1,
            "dp param_averaging: the ranks' states differ after the last "
            "average")
    ins_expected = {"fused_update": 3 * INS_DP_STEPS, "bn_act": 0,
                    "upsample_bwd": 0, "bn_moments": 4 * INS_DP_STEPS,
                    "bn_apply": 4 * INS_DP_STEPS, "bn_act_4d": 0,
                    "bn_act_tenants": 0,
                "bn_act_tenants_bwd": 0}
    ins_dp = [r["insurance"] for r in ranks]
    emit("dp_insurance", world=DP_WORLD, backend=r0["backend"],
         steps=INS_DP_STEPS, global_batch=INS_BATCH,
         losses=ins_dp[0]["losses"], launches=[r["launches"] for r in ins_dp],
         expected_launches=ins_expected,
         vs_single=[r["vs_single"] for r in ins_dp],
         digests=[r["digest"] for r in ins_dp], tolerance=INS_STEP_TOL)
    for rank, r in enumerate(ins_dp):
        require(r["launches"] == ins_expected,
                f"dp insurance rank {rank}: launch counts {r['launches']} != "
                f"expected {ins_expected}")
        for i, (loss_err, worst) in enumerate(r["vs_single"]):
            require_step_match(f"dp insurance rank {rank} step {i + 1} vs "
                               "single", loss_err, worst, INS_STEP_TOL)
    require(len({r["digest"] for r in ins_dp}) == 1,
            "dp insurance: the ranks' states differ after the run")
    # a 1-rank NCCL group in this process, so the NCCL path runs on a
    # one-card machine too
    rdv = tempfile.mkdtemp(prefix="gan4j_nccl1_")
    try:
        group = mesh.data_group(0, 1, f"file://{rdv}/store", "cuda")
        try:
            require(group.backend == "nccl",
                    f"1-rank group on {group.backend}, not nccl")
            loss_err, worst = group_vs_single(group, host)
            sync_bn = sync_bn_profile(group, torch)
        finally:
            group.close()
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
    emit("dp_nccl1", backend="nccl", loss_rel_err=loss_err, worst=worst,
         tolerance=STEP_TOL, sync_bn_forward=sync_bn)
    require_step_match("1-rank NCCL step vs single", loss_err, worst)
    kinds = sync_bn["new"]["kinds"]
    require(kinds["bn_moments"] == kinds["bn_apply"] == 3
            and kinds["other"] == 0 and sync_bn["new"]["per_forward"] <= 3,
            f"a sync-BN forward is not moments, collective, apply: {sync_bn}")

    # -- 8. the CV program end to end -----------------------------------------
    mnist_csv = tempfile.mkdtemp(prefix="gan4j_mnist_")
    emit("cv_main", **cv_main_phase(torch, smi, mnist_csv))

    # -- 9. the insurance program end to end ----------------------------------
    ins_ref = tempfile.mkdtemp(prefix="gan4j_ins_ref_")
    # the resume phase's CV checkpoints, which the serve phase serves
    serve_src = tempfile.mkdtemp(prefix="gan4j_serve_src_")
    try:
        ins = insurance_phase(torch, smi, ins_ref)
        emit("insurance", **ins)

        # -- 10. checkpoints, preemption and resume ---------------------------
        emit("resume", **resume_phase(torch, smi, ins_ref, ins["test_auroc"],
                                      serve_src, mnist_csv))
    finally:
        shutil.rmtree(ins_ref, ignore_errors=True)

    # -- 11. the roadmap families ---------------------------------------------
    rm = roadmap_phase(torch, smi, randn, bw, sms)
    emit("roadmap", **rm)

    # -- 12. the roadmap families on two ranks --------------------------------
    pdp = pair_dp_phase(torch, smi, rm)
    emit("pair_dp", **pdp)

    # -- 13. the precision modes ---------------------------------------------
    # the extractors' recipes (phase 21) run as a child beside the
    # precision phase's two children
    prec = precision_phase(torch, smi, bw,
                           beside=lambda: extractors_child(smi))
    ex = prec.pop("beside_result")
    emit("precision", **prec)

    # -- 14. the serving plane ------------------------------------------------
    before_serve_s = time.perf_counter() - T_START
    try:
        serve = serve_phase(torch, smi, serve_src)
    finally:
        shutil.rmtree(serve_src, ignore_errors=True)
    emit("serve", **serve)

    # -- 15. the serving plane across processes, traced -----------------------
    sm = serve_mesh_phase(torch, smi)
    # its time against its budget, recorded as the observability phase's
    emit("serve_mesh", budget_s=SM_BUDGET_S,
         within_budget=sm["seconds"] <= SM_BUDGET_S, **sm)

    # -- 16. supervision's numerics and hangs ---------------------------------
    # the combined chaos scenario (phase 24) runs as a child beside it: its
    # checks are the scenario's verdict, and this phase's timings stand
    # under shared_card
    scenario_wait = scenario_start()
    sv = supervision_phase(torch, smi, [r["supervision"] for r in ranks],
                           [r["rollback"] for r in ranks], rb_events)
    sv["shared_card"] = shared_card(["the scenario child (phase 24)"])
    emit("supervision", **sv)
    sc = scenario_phase(smi, scenario_wait, ["the supervision phase"])

    # -- 17. the training run's observability --------------------------------
    obs = observability_phase(torch, smi, mnist_csv)
    # its time against its budget, recorded (the script's own limit is
    # what a run must meet)
    emit("observability", budget_s=OBS_BUDGET_S,
         within_budget=obs["seconds"] <= OBS_BUDGET_S, **obs)

    # -- 18. early stopping and the device probe ------------------------------
    try:
        mig = migration_phase(torch, smi, mnist_csv)
    finally:
        shutil.rmtree(mnist_csv, ignore_errors=True)
    emit("migration", **mig)

    # -- 19. the insurance fleet ---------------------------------------------
    fleet = fleet_phase(torch, smi, randn, bw, sms)
    emit("fleet", **fleet)
    report.append(fleet["kernel"])
    report.append(fleet["kernel_bwd"])

    # -- 20. the tenant lifecycle --------------------------------------------
    lc = lifecycle_phase(torch, smi)
    emit("lifecycle", **lc)

    # -- 21. the frozen extractors' recipes (run beside the precision
    # phase's children)
    emit("extractors", **ex)

    # -- 23. the tenant mesh and the elastic restore --------------------------
    try:
        el = elastic_phase(torch, smi)
    finally:
        shutil.rmtree(EL_KEEP.get("dir", ""), ignore_errors=True)
    emit("elastic", **el)

    # -- 24. the combined train -> serve chaos scenario (run beside phase 16)
    emit("scenario", **sc)

    # -- 22. the kernels line and the result ---------------------------------
    # launches: the main phase's, the dp phase's (rank 0) for the sync-BN
    # pair, the kernel phase's check for the 4-D BN, which no model path
    # runs (as in the JAX package), and the fleet's sweep for the
    # tenant-batched BN
    counted = {**launches, "bn_moments": r0["launches"]["bn_moments"],
               "bn_apply": r0["launches"]["bn_apply"],
               "bn_act_4d": bn4d_launches,
               "bn_act_tenants": fleet["step"]["launches"]["bn_act_tenants"],
               "bn_act_tenants_bwd": fleet["step"]["launches"][
                   "bn_act_tenants_bwd"]}
    # the insurance path's own: the program's run for bn_act and
    # fused_update, the dp phase's insurance steps (rank 0) for the pair
    ins_counted = {"bn_act": ins["launches"]["bn_act"],
                   "fused_update": ins["launches"]["fused_update"],
                   "bn_moments": ins_dp[0]["launches"]["bn_moments"],
                   "bn_apply": ins_dp[0]["launches"]["bn_apply"]}
    ins_groups = ins_kernels["groups"]
    cgan_launches = rm["program"]["cgan-cifar10"]["result"]["port_launches"]
    print(json.dumps({"kernels": [
        {"name": r["name"], "route": "cuda",
         "source": f"gan_deeplearning4j_tpu_torch/csrc/{SOURCES[r['name']]}",
         "replaces": f"gan_deeplearning4j_tpu/{REPLACES[r['name']]}",
         "launches": counted[r["name"]], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "floor_ms": r["floor_ms"],
         **{k: r[k] for k in ("enqueue_ms",) if k in r},
         **({"insurance": {
             "launches": ins_counted[r["name"]],
             **{k: ins_groups[r["name"]][k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "floor_ms")}}}
            if r["name"] in ins_groups else {}),
         **({"roadmap": {
             family: {"launches": rm["main"][family]["launches"]["bn_act"],
                      "launches_per_iteration": rm["graph"][family]["plain"][
                          "launches_per_replay"]["bn_act"],
                      **{k: rm["kernels"][family][k] for k in (
                          "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "floor_ms")}}
             for family in RM_BN}} if r["name"] == "bn_act" else {}),
         # the conditional family's path runs none of the six (the
         # roadmap_children docstring says why): its child's counts
         "cgan-cifar10": {"launches": cgan_launches[r["name"]]},
         # the roadmap families at world 2: rank 0's launches over the
         # pair_dp phase's counted iterations, and the pair's numbers at
         # the per-rank shapes
         "pair_dp": {family: {
             "launches": pdp["families"][family]["launches_per_rank"][0][
                 r["name"]],
             "iterations": PD_ITERS,
             **({k: pd_rows[family][r["name"]][k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "floor_ms")} | {
                 "shape": pd_rows[family]["shape"]}
                if family in pd_rows and r["name"] in pd_rows[family]
                else {})}
             for family in RM_FAMILIES},
         # each workload's eager run in each mode (PR_CALLS * PR_K steps)
         "precision": {w: {m: res["eager_launches"][r["name"]]
                           for m, res in modes.items()}
                       for w, modes in prec["graphed_vs_eager"].items()},
         # the serving path's inference forward runs none of the six
         # (the JAX forward reaches no Pallas kernel): counted around the
         # serve phase's load stages
         "serve": {"launches": serve["launches"][r["name"]]},
         # the mesh over replica processes runs none of the six either:
         # this process's counts over the phase plus each replica's own
         "serve_mesh": {"launches": sm["launches"][r["name"]]},
         # the supervision phase's path: the CV step with its telemetry
         # block, captured (GRAPH_STEPS replays), and at world 2 per rank
         # (SV_DP_STEPS eager steps)
         "supervision": {
             "launches": sv["telemetry"]["launches"][r["name"]],
             "steps": GRAPH_STEPS,
             "world2_launches_per_rank": sv["world2"]["launches"][0][
                 r["name"]],
             "world2_steps": SV_DP_STEPS},
         # the observability phase's path: a cv_main run under --profile
         # in this process (counted), the child's capture under every flag
         # (the trace's counts), the celeba run's capture and counters
         "observability": {
             "launches": obs["flag_cost"]["launches"][r["name"]],
             "trace_counts": obs["full_run"]["trace_counts"].get(r["name"]),
             "celeba_launches": obs["roadmap"]["launches"][r["name"]],
             "steps": CV_STEPS},
         # the world-2 rollback in the dp phase's ranks: each rank's
         # launches over its RB_EXECUTED steps (the NaN step, then the
         # healed redo)
         "rollback_world2": {
             "launches_per_rank": [
                 rl[r["name"]]
                 for rl in sv["rollback_world2"]["launches"]],
             "steps_per_rank": RB_EXECUTED},
         # the migration surface: the DL4J round trips' forwards (the
         # source and the imported graph, inference) and early stopping's
         # fits on the transfer classifier
         "migration": {
             "dl4j_launches": dl4j["launches"][r["name"]],
             "early_stopping_launches": mig["early_stopping"]["launches"][
                 r["name"]],
             "early_stopping_fits": mig["early_stopping"]["fits"]},
         # the fleet's graphed step: launches over the sweep's timed
         # calls, and a step's at each fleet size (the same at every N)
         "fleet": {
             "launches": fleet["step"]["launches"][r["name"]],
             "launches_per_step": {
                 str(x["tenants"]): x["launches_per_step"][r["name"]]
                 for x in fleet["step"]["sweep"]},
             "steps": FLEET_CALLS * FLEET_K * len(FLEET_SWEEP)},
         # the tenant lifecycle's masked cohort steps (the chaos run):
         # launches over its windows, and a step's at every (cohort,
         # capacity) graph
         "lifecycle": {
             "launches": lc["launches"].get(r["name"], 0),
             "launches_per_step": {
                 k: v.get(r["name"], 0)
                 for k, v in lc["launches_per_step"].items()},
             "steps": lc["steps"]},
         # the tenant mesh: a step's launches a shard at worlds 1, 2 and 4
         # (the elastic phase's graphed shards), the world-1 insurance
         # restore's over its steps, and each trainer incarnation's of the
         # scenario (warm-up steps and replays)
         "elastic": {
             "launches_a_step_a_shard": {
                 w: x["launches_a_step_a_shard"].get(r["name"], 0)
                 for w, x in el["sharded"]["worlds"].items()},
             "insurance_world_1": el["insurance"]["launches"].get(
                 r["name"], 0),
             "insurance_steps": RES_DP_STEPS[1] - RES_DP_STEPS[0],
             "scenario_incarnations": [
                 (x or {}).get(r["name"], 0)
                 for x in sc["trainer_launches"]]}}
        for r in report]}), flush=True)
    print(json.dumps({"seconds": {
        "total": time.perf_counter() - T_START,
        "in_time_ms": TIMED_S[0],
        "precision": prec["seconds"],
        "total_before_the_precision_phase": TOTAL_BEFORE_PRECISION_S,
        "serve": serve["seconds"],
        "total_before_the_serve_phase": before_serve_s,
        "serve_mesh": sm["seconds"],
        "pair_dp": pdp["seconds"], "supervision": sv["seconds"],
        "observability": obs["seconds"], "dl4j": dl4j["seconds"],
        "migration": mig["seconds"], "fleet": fleet["seconds"],
        "lifecycle": lc["seconds"], "elastic": el["seconds"],
        "scenario_child": sc["shared_card"]["child_seconds"],
        "extractors": ex["shared_card"]["child_seconds"],
        "rollback_world2": max(sv["rollback_world2"]["seconds"]),
        "by_phase": PHASE_SECONDS}}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
