"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (reporter_tpu_torch) at full size on two
metros, the synthetic grid city "sf" and the irregular "organic" metro,
and holds every CUDA kernel of it against its plain PyTorch version, and
the native host half against its Python forms, in phases:

  1. device   — require CUDA; print the card's name and power limit;
  2. build    — nvcc-build kernels/sweep_exact.cu once per top-K width of
                SWEEP_KS (the five arms at that K, sm_90a) and once as the
                wide library (the five arms at a run-time K, which serve
                every K past 16, each with its lists in shared memory and
                past the arm's shared_max_k in a global scratch; the six
                nvcc started together), nvcc-build kernels/viterbi.cu
                (the batched Viterbi decode, K a run-time argument; a
                seventh nvcc beside them) and
                g++-build the host library
                (native/prepare.cc, walker.cc) into reporter_tpu_torch/
                _build/, with the build times side by side; the ptxas
                figures of every kernel instance and each arm's launch
                shape at each K of SWEEP_KS and WIDE_KS (threads, ring
                depth, dynamic shared memory, CTAs per SM, SMs, grid,
                where the lists are: dc.list_plan);
  3. tiles    — compile "sf" (~5.3k directed edges, its spatial grid
                included); [tiles:native]: its
                node-space reach rows by the C++ builder (native/reach.cc,
                the compiler's default) and by the Python one, byte for
                byte equal, both timed (organic's too, in phase 6);
  4. kernel   — on sf, 1024 traces x 120 points padded to the 128 bucket
                (131,072 points) through all five sweep arms at K = 8
                (block, sub, sub_bf16, mxu, mxu_bf16) and through
                _dense_plain on the card: edge, offset and dist must be
                bit-equal; CUDA-event times of each, as the median of
                single launches (``ms``) and per launch in a back-to-back
                run (``ms_back_to_back``); bound, vote and gate shares.
                The chunk order kernel against _chunk_order; the work
                spread; each coarse gate's decisions (a debug launch)
                against its plain gate, equal for the bf16 filter, for the
                tensor-core pass different only within 1e-3 of the
                threshold, with the share of voted tiles whose gate passed
                in its first group of columns;
     kernel:k — every arm at every K of SWEEP_KS on the same 131,072
                points (512 chunks, more than the persistent grid at every
                K, so CTAs take second chunks), every arm equal to the
                others on all of them and bit-equal to _dense_plain at that
                K on 64 chunks: the first 32 and the last 32 the CTAs take
                (heaviest first, so these are taken after a CTA's first
                chunk); the same times and bounds;
                Then K = 5, 7 and 10 (KERNEL_BETWEEN_KS, between the
                built widths) on every arm: the next built instance K'
                runs and its first K columns are returned, bit-equal to
                _dense_plain at K on the 64 chunks and to the K'
                instance's first K columns on every point, the launch
                counted under (arm, K') (on organic too);
                Then, at WIDE_RADIUS (150 m, where most sf points have more
                than 16 edges within reach), every arm through the wide
                instances at each K of WIDE_KS (20, 24, 32, 48, 64: the
                lists in shared memory, and at 48 for the gated arms and
                64 for every arm in the scratch) and through the register
                K = 16 beside them: equal across arms on all points,
                bit-equal to _dense_plain on the 64 chunks, times and
                bounds, each wide line with its lists, shared memory, CTAs
                per SM, ring depth and its times' ratio to that K = 16;
                [kernel:wide] their seconds;
     gates    — parallel streets 500 m apart, where every coarse gate
                culls: the gate share must be below the vote share;
  5. main     — with a fresh autotune cache, SegmentMatcher(ts) calibrates
                every arm and serves the fastest (no calibration error
                allowed); match_many on the 1024 traces, BATCH_RUNS times
                after a warm-up (median, min-max spread and stage
                medians: prepare, dispatch, device, walk), then once with
                a matcher pinned to each arm (records all equal); one
                match(request). Each of these runs is its own launch
                window (counts set to 0 just before, read just after): the
                calibration must launch every arm, each served run only
                the kernel instance it serves;
     walk     — on the tuned batch, the C walk through match_many, the
                Python walk (build_segments) and NativeWalker.walk of the
                same decoded arrays must give equal records (to_json(),
                tolerance 0), each walk timed; the C prepare against the
                numpy form (bytes equal, timed); and, in 256-trace slices,
                whether the harvest's walk overlaps the wait in .cpu();
     main:k   — at each other K of SWEEP_KS and at K = 5, 7 and 10, and
                with a WIDE_RADIUS search radius at MAIN_WIDE_K = 32 (the
                wide instance, the lists in shared memory) and at
                MAIN_SCRATCH_K = 64 (past every arm's shared_max_k: the
                lists in the global scratch), a tuned matcher (calibration
                launches every arm at the instance K' serving K, each
                counted under dc.launch_key) serves the 1024 traces (512
                chunks of the sweep), whose first 16 records equal the CPU
                matcher's at that K; each line names its instance
                (dc.list_plan: register, shared or scratch);
  kernel:viterbi — the batched Viterbi kernel (kernels/viterbi.cu) on
                the first wire slice of the 1024 traces (first_slice: 1024
                x 128 points) at K = 8 (50 m) and K = 16, 32 and 64 (at
                WIDE_RADIUS): mismatches against its plain version on the
                card per field (choice, edge, offset, chain_start,
                matched; all must be 0), ms and ms_back_to_back, plain_ms,
                bound_ms and bound_by (the lattice pairs this slice looks
                up, a binary search of ceil(log2(M + 1)) probes each at
                VITERBI_OPS_PER_LOOKUP operations plus
                VITERBI_OPS_PER_PAIR, against the bytes, the tables only
                as far as the searches read them; the linear scan's count
                and bound beside it), library_ms null (no
                PyTorch call decodes a lattice), the launch plan (traces
                per CTA, threads per trace, chunk, shared bytes, where the
                levels live), the seconds; every main-path window counts
                its launches per K (Windows.viterbi_by_path);
     breakdown — one slice's sweep per arm, the Viterbi kernel and its plain
                version and the pack timed alone, and the device busy
                share and kernel launches of one wire entry
                (torch.profiler);
     reference — golden fixture ids on the card, through the matcher and
                through make_app's /report, and card-vs-CPU records on a
                small batch;
     oracle   — the first ORACLE_TRACES["sf"] traces through the
                exact-Dijkstra oracle (matcher_backend="reference_cpu",
                numpy on the host): length-weighted agreement of the
                card's records with it at AGREEMENT_GATE or better, their
                equality with the CPU port's, the oracle's probes/s beside
                the host CPU's model;
     grid     — [grid:native] sf's spatial grid by the C++ fill and the
                Python one at the compiler's capacity, byte-equal and
                equal to the compiled tile's; a matcher with
                candidate_backend="grid": GRID_BATCH_RUNS timed batches,
                its candidate stage beside the tuned sweep's, its batch
                and the tuned dense matcher's in turns (AB_ROUNDS rounds),
                edge sets and distances equal to the sweep's on every
                point, the first REFERENCE_TRACES records equal the CPU
                port's, the traces whose records differ from the dense
                matcher's counted, no sweep instance launched;
     topk     — match_topk on the tuned matcher (terminal and exact) on
                TOPK_TRACES traces and one TOPK_LONG_POINTS-point trace:
                paths equal the CPU port's, scores ascending, rank 0 one
                path in both forms, exact dominating terminal, a longer
                trace refused, only the tuned instance launched;
     wide     — past K = 64, which the JAX package serves: [wide:decode]
                matchers at K = 96 and 128 (viterbi_decode_wide_kernel's
                instance 1) and 256 (instance 2) at WIDE_RADIUS, and at K
                = 96 at LONG_LIST_RADIUS (lists past 64 edges), serve the
                1024 traces (main-path windows sf:k<K>, sf:k96@250m),
                their first WIDE_CPU_TRACES records equal the CPU's, the
                kernel bit-equal to its plain version on the whole first
                wire slice, with ms, back to back, plain ms, bound and
                the plan (kernel, chunk, pass budget, levels);
                [wide:topk] match_topk at K = 96 on the
                TOPK_LONG_POINTS-point probe, both forms equal to the
                CPU's, launching the keep mask, the forward's wide
                instance (lattice_forward_kernel<-1>, both plans printed)
                and the backtrack's ring and in-place instances (window
                sf:topk96); the lattice's wide kernels against their plain
                versions, with ms, back to back and bound, are
                [kernel:lattice]'s K = 96 lines (at WIDE_RADIUS and
                LONG_LIST_RADIUS);
     restrict — sf with add_random_restrictions at its defaults (122
                restrictions, 329 banned pairs): [restrict:tiles] the
                compile (C++ node rows, the ban-affected node rows and one
                private row per from-edge in edge space: R = N + F), table
                bytes, a legal fleet of 1024 x 120 (seed 0); the main phase
                (tuned matcher, BATCH_RUNS batches, pinned matchers) and the
                walk phase on it (metro=sf+r); [restrict] the first
                REFERENCE_TRACES traces' records equal the CPU port's, and
                every transition inside an HMM chain, rebuilt through the
                reach rows' next hops, takes no banned turn; [oracle] the
                banned-turn oracle (edge space) on ORACLE_TRACES["sf+r"];
                [restrict:ab] sf and sf+r batches through matchers pinned
                to sub at K = 8, in turns, AB_ROUNDS rounds: the medians;
     modes    — sf with assign_mode_access at its defaults, compiled for
                auto, bicycle and foot from the full network: the edges
                per mode, a road's OSMLR id the same in every mode tile;
                for bicycle and foot a 1024 x 120 fleet on that mode's tile
                through a tuned matcher with the mode's preset (only the
                tuned instance launched; the first MODES_CPU_TRACES records
                equal the CPU port's), make_app(Config.for_mode(mode)) on
                the card answering /report tagged with the mode, 400 for a
                request naming another; [modes:server] python -m
                reporter_tpu_torch.service.server --mode bicycle --tiles
                <the bicycle tile, saved> as a subprocess: answers equal
                the in-process app's, 400, SIGINT to exit 0;
     pbf      — (host) tests/fixtures/irregular.osm and the adversarial
                extract (tests/fixtures/adversarial_osm.py) written with
                write_osm_pbf, parsed back and compiled: every array equal
                to the XML form's compile (segment coordinates within the
                reader's decode bound, PBF_DECODE_M plus one f32 rounding);
  6. organic  — generate_city("organic") (seed 11, 62,757 directed edges),
                compiled by the port (timed), [tiles:native]; its kernel
                phase (131,072 fleet points, every arm equal to the
                others, bit-equal to _dense_plain on 64 chunks as in
                kernel:k, gate checks,
                shares), gates line, main phase (tuned matcher, BATCH_RUNS
                batches, records equal across it and five pinned
                matchers), walk phase (the three walks and the prepares,
                as on sf), card-vs-CPU records on 32 traces and [oracle]
                on ORACLE_TRACES["organic"] traces, each line tagged
                metro=organic; [grid:native] on organic;
     tools    — [capacity] plan_staging on sf, sf+r and organic: the
                formula equal to the staged table_bytes, and the rise of
                torch.cuda.memory_allocated() around staging at least it
                and within CAPACITY_SLACK; the card's memory beside
                DEFAULT_HBM_BUDGET; [tiles:cli] (host) python -m
                reporter_tpu_torch.tiles convert, build --mode bicycle,
                synth, info, osmlr and osmlr --binary as subprocesses:
                files equal to the in-process compile, info's hbm_bytes
                equal to [capacity]'s sf figure, the binary tile read back
                to the GeoJSON's segments; [reach_audit] (host) audit_reach
                on sf and sf+r over REACH_AUDIT_TRACES fleet traces;
  7. serve    — on sf, the report service in-process (make_app on the
                card, a fresh tuner cache, behind serve()'s threaded WSGI
                server on an ephemeral port; the datastore a local HTTP
                server reached through the publisher's urllib transport):
                three lone requests, then 64 client threads each posting
                its 2 uuids' 120-point traces as three in-order /report
                requests of 40 points (384 requests; 16 uuids and 3,072
                requests before the oracle, watchdog, audit and backfill
                phases joined the run, 8 and 1,536 before the router's
                traffic did, 4 and 768 before the fleet's), then one
                /report_many of 256 traces. Every response 200; the first
                32 uuids' responses equal a CPU app's fed the same
                per-uuid order, and the datastore's reports for them the
                CPU app's (sorted); the served window launched only the
                tuned (arm, 8) instance; /stats counts the real traces
                (padding excluded); GET /slo answers 200 and /health
                carries the slo block and the link block (mood, round
                trip, MB/s and duty of the process sampler's probe of the
                card, none null). Latency p50 / p99, traces/s,
                batches, occupancy, padding, deferrals, overlap, stages;
     server   — python -m reporter_tpu_torch.service.server as a
                subprocess (it compiles sf and calibrates with a fresh
                tuner cache): /health within SERVER_START_S, 8 /report
                answers equal [serve]'s for the same payloads, SIGINT
                drains to exit code 0; the start-up time;
     router   — BASELINE config 4's trio: sf, nyc and la at their
                generator sizes, compiled and saved under
                _chip_scratch/router, behind make_router on the card
                (three calibrations, a fresh tuner cache) and serve():
                ROUTER_CLIENTS clients round-robin over the metros, each
                posting its ROUTER_UUIDS uuids as SERVE_PARTS in-order
                40-point /report requests, every ROUTER_EXPLICIT_EVERY-th
                client naming its "metro" (the rest routed by location);
                one /report_many of ROUTER_MANY traces mixing the metros;
                a trace outside every metro (404, known_metros,
                router_unroutable 1 in /metrics and /health) and an
                unknown metro (400). Every routed response equals a
                dedicated single-metro app's on the card fed the same
                per-metro requests; each metro's wire entries launch only
                its own plan's instance (a count per metro, summing to
                the window's launches); /health's metros and link blocks;
                p50 / p99, traces/s. [router:server]: the entry point over
                the three files as a subprocess (its own calibrations):
                start-up, tile bytes per metro, answers equal, 404,
                SIGINT to exit 0;
     fleet    — twelve metros in one FleetResidency on the card:
                sf, nyc and la of [router], organic, and the JAX bench's
                eight generated metros (fleet00..07); [fleet] every metro
                promoted (pinned cold tier, its own calibration), its
                pre-paging wire harvested, memory_allocated against the
                ledger; FLEET_ROUNDS rounds of every metro's traffic from
                FLEET_THREADS threads under leases (probes/s, per-metro
                kprobes/s, staged bytes, launches only the tuned
                instances). [fleet:storm] the budget at half the staged
                total, cyclic touches (every one a miss): promote ms p50 /
                p99 apart from the dispatch, MB/s beside a pinned probe
                copy, promotions, demotions, evictions, memory_allocated's
                rise and drop per promotion and demotion within the
                allocator's bound. [fleet:fidelity] every metro's wire
                through its lease equal to a dedicated matcher's (a plan
                cache hit) and to its pre-paging harvest, one instance
                launched. [fleet:router] make_fleet_router over sf, nyc
                and la (sf pinned, sf plus 1.5 of the larger other metro
                as the budget): 96 in-order /report requests from 16
                clients equal a dedicated MetroRouter's, /health's fleet
                block adds up, p50 / p99. [fleet:guard] a hung page-in
                (fleet_promote:hang) under promote_timeout_s 1 s sheds as
                ServiceOverloaded, rolls the ledger back and promotes once
                the plan is cleared;
  8. stream   — on sf, the streaming worker at full width: the 1024 x 120
                fleet as one firehose of 122,880 {uuid, lat, lon, time}
                records in STREAM_ROUNDS rounds of STREAM_ROUND_POINTS
                points per vehicle (round-robin, as the JAX tests'
                _records), default StreamingConfig (4 partitions, flush at
                16 points: every vehicle flushes every second round), the
                datastore a local HTTP server. Each step must consume its
                whole round; after the drain lag 0, committed at the end
                offsets, malformed 0. [stream]: StreamPipeline on the card
                over IngestQueue (checkpointed after round
                STREAM_CHECKPOINT_ROUND; records/s, flush ms, the
                matcher's stage split, reports, histogram rows); the first
                STREAM_CPU_UUIDS uuids streamed alone on the CPU and on
                the card give equal reports, all held in the full run; the
                stream window launched only the tuned (arm, 8) instance.
                [stream:columnar]: ColumnarStreamPipeline over
                ColumnarIngestQueue, the rounds as ProbeColumns, at
                pipeline depth 1 (each round waits for the in-flight wave
                before its step, so every uuid flushes at the dict
                pipeline's points) and 0: reports, hist and qhist equal
                [stream]'s, and the same launches; waves in flight and the
                per-wave prepare / match / report build / publish split
                (flight-recorder spans). [stream:recover]: the columnar
                pipeline checkpointed after round STREAM_CHECKPOINT_ROUND,
                one more round, dropped; a fresh one restored on the same
                queue finishes the feed: the reports before the checkpoint
                and after the restore cover the uninterrupted run's; the
                dict pipeline's checkpoint restored into a columnar
                pipeline has the columnar checkpoint's histograms and
                finishes with the uninterrupted ones. [stream:worker]:
                python -m reporter_tpu_torch.streaming --exit-on-drain as
                a subprocess over a pre-staged durable broker (the saved
                sf tile): the dict worker and --columnar at pipeline depth
                0 (--config), each with exit 0, lag 0, committed at the
                end offsets and the reports at the datastore equal to an
                in-process pipeline's of its kind over a copy of the
                directory; then --columnar at its default depth 1 (flush
                points that depend on the match thread's speed): exit 0,
                lag 0, every report published; the start-up, step-loop
                and drain times. [kafka]: the same rounds through
                KafkaProbeConsumer over an in-process fake kafka-python
                client, and through a durable broker, each into a dict
                pipeline on the card: reports, hist and qhist equal each
                other and [stream]'s; records/s beside [stream]'s;
  9. topo     — on sf, the supervised topology (reporter_tpu_torch.
                distributed): N worker subprocesses of the entry point
                sharing the card, over the same feed pre-staged in a
                durable records broker under _chip_scratch/topo (every
                TOPO_STAMP_EVERY-th record stamped with a trace id by a
                producer with its own flight recorder), with [stream]'s
                tuner cache. [topo:stage] the uninterrupted reports, per
                partition, from an in-process pipeline owning only it.
                [topo]: a Supervisor with two dict workers on {0, 1} and
                {2, 3}, polls of TOPO_POLL records, the port's ReportSink,
                snapshot spool, SLO plane at TOPO_SLO_SCALE and tracing;
                worker-0 SIGKILLed once the sink has rows: the supervisor
                records the death and one post-mortem, restarts it from
                its checkpoint, the topology drains to lag 0, the sink
                covers the uninterrupted reports (duplicates counted), the
                merged registry is the per-leaf sum of the snapshots;
                detect, recovery and restart-to-ready seconds.
                [topo:trace]: the producer's and workers' rings stitched
                into one Chrome trace (a process row each, flows,
                broker_dwell spans). [topo:slo]: per spec, the bad and
                total events over the merged exports equal the members'
                sums; the alerts that fired. [topo:scale]: records/s of
                1, 2 and 4 dict workers (default StreamingConfig) and of
                4 columnar workers at depth 0 started cold (a copy of the
                package without _build/, an empty tuner cache: every
                worker builds and calibrates at once), from the last
                "ready" to the last exit; start-up apart; the card's busy
                share and used memory (nvidia-smi beside the run); every
                run's reports and merged histograms equal the 1-worker
                run's; each worker launched only the instance it serves.
                [topo:lease]: two leased workers, a third joining, lease-b
                SIGKILLed: floors at the end offsets, no commit at a stale
                epoch, the zombie's commit refused, stable partitions'
                reports covered; join and adoption latencies;
 10. watchdog — on sf, the dispatch watchdog: [watchdog] the columnar
                pipeline (depth 0) over WATCHDOG_VEHICLES vehicles with
                dispatch_timeout_s = WATCHDOG_TIMEOUT_S (checked to be over
                5x a warm batch), uninterrupted and with the second
                dispatch hanging WATCHDOG_HANG_S: exactly one timeout, the
                released wave retried on the same rows, reports equal;
                [watchdog:fallback] dispatch_fallback="reference_cpu"
                under a hang of every dispatch: every wave served by the
                oracle and counted, none released, no kernel launched;
                [watchdog:503] a hung /report answers 503, its retry 200;
     link     — a link-health sampler on the card probes LINK_SAMPLES
                times (round trip, host-to-card MB/s, mood: none null);
                the process sampler's device, probes and duty; the
                watchdog's timeouts above noted in its record (mood dead
                in the window since);
     autotune:guard — a matcher whose first calibration measurement
                stalls GUARD_HANG_S under CAL_TIMEOUT_S = GUARD_TIMEOUT_S:
                construction within the timeout plus GUARD_MARGIN_S,
                source "timeout", nothing cached, the abandoned
                measurement's later launches and landing, records equal to
                an untuned default-plan matcher's;
     audit    — AUDIT_BATCHES batches of AUDIT_BATCH traces through the
                tuned matcher with the shadow auditor at rate 1, interval
                0 and duty cap 100: audited batches and traces, mean
                disagreement against the oracle, audit seconds and duty;
     backfill — on sf, the fleet's 122,880 records spooled into a
                4-partition durable columnar broker and a records broker
                (_chip_scratch/backfill); BackfillEngine with the tuned
                matcher and the default BackfillConfig, its grids held
                against the host twin (agg_identical), records/s, stage
                seconds; the records spool (same document); a closed-loop
                columnar drain of a copy of the spool (depth 0): vs_soak_x;
                slice_traces=1024 (same grids); backfill:crash@1 and a
                resume from its checkpoint (same grids, the replay tax);
                GET /aggregates of an app holding the store (the
                document, one segment, 404 for an unknown one);
 11. mesh     — multi-GPU (reporter_tpu_torch/parallel/), each phase its
                own launch window, the five timed together ([mesh]):
                [mesh:dp] a SegmentMatcher over make_mesh(dp=MESH_DP,
                devices=["cuda:0"] * MESH_DP), and over make_mesh() when
                more than one card is visible: MESH_BATCH_RUNS timed
                batches of the 1024 x 120 fleet (median, stages, launches
                per (arm, K)), records equal to the tuned single-device
                matcher's (to_json(), tolerance 0), the wire bytes of
                MESH_WIRE_TRACES traces (rows padded to a multiple of the
                devices) equal; [mesh:sharded] sf's segment table over
                tile=MESH_SHARDS, dp=1: edge, offset and dist of all
                131,072 points bit-equal to the unsharded sweep's, the
                MatchOutput equal to match_traces', each shard's sweep ms
                and the merge ms; [mesh:metro] [router]'s sf, nyc and la
                stacked on tile=3, dp=MESH_METRO_DP, MESH_METRO_TRACES x
                120 traces each: every metro's outputs equal its own
                single-device match, the histogram the bincount of the
                matched OSMLR rows (zero past each metro's real G);
                [mesh:backfill] partition 0 of [backfill]'s spool through
                BackfillConfig(mesh_devices=MESH_DP) (with fewer cards:
                the refusal checked, then over MESH_DP x cuda:0): grids
                and document equal to the tuned single-device engine's,
                records/s of both; [mesh:group] a 1-process nccl group
                through initialize_multihost in a subprocess: all_reduce,
                shutdown twice;
 12. gates    — the port's own gates on the card, together under 60 s:
                [lockdep] a child process armed by RTPU_LOCKDEP=1 before
                any import (this process's timed phases stay unarmed)
                serves LOCKDEP_CLIENTS x LOCKDEP_PER_CLIENT /reports from
                LOCKDEP_CLIENTS threads, one fleet round of sf and tiny
                from LOCKDEP_SUBMITTERS threads under leases and one
                columnar stream round: its observed order edges, its
                violations and the edges outside the port's contract
                (analysis/concurrency_contract.py), none allowed;
                [analysis:device] a child runs the device contract
                (analysis/device_contract.py) on the card: every wire entry
                x the five arms at K = 8 x three wire layouts x {single,
                mesh}, the scatters and five staging cases (windows that
                start from host arrays: the matcher's prepare and dispatch,
                the mesh's stage and run, the histogram's update, the
                backfill grid's add, single and over a mesh), each under
                set_sync_debug_mode("error") and the aten recorder: cases,
                staging cases, aten ops, findings, none unwaived;
                [analysis:manifest] the built instances' (the wide
                library's among them) ptxas figures and launch shapes
                against the golden block of analysis/compile_manifest.py;
                [profile] (run after sf's [walk], the process's first
                profiler session) one sf batch
                of the tuned matcher with REPORTER_TPU_TRACE_DIR set (the
                matcher's own device_trace hook, a torch.profiler Chrome
                trace under _chip_scratch/profile): the trace's size, the
                CUDA launches and kernels in the window, its
                sweep_exact_kernel kernel events and host-side spans;
 13. tooling  — [api] (after [device]): every name of the port's
                top-level API (reporter_tpu_torch._LAZY, the JAX
                package's 17 and FleetResidency) resolves to an object of
                that name; [examples] examples/torch_quickstart.py on the
                card as a child (started beside the gates' children): its
                markers and seconds; [bench_delta] (last) this run's own
                phase lines through analysis/bench_delta.py: every numeric
                field classifies or is neutral (none skipped in silence,
                the two **fields lines [mesh:dp] and [build:exact_shape]
                included), and the run compared with itself finds no
                regression;
 14. summary  — the kernels JSON line (every arm at every K, its wide
                instance at MAIN_WIDE_K, with its ms at each K of
                WIDE_KS, and its scratch instance at MAIN_SCRATCH_K; the
                sources,
                the host library among them; the topology's workers'
                launches by member; the sf:topk, sf:grid, fleet and mesh:*
                windows in every entry's launches_by_path), a
                viterbi_decode_k<K> entry per K of [kernel:viterbi] and
                [wide:decode] (its launches at that K in the main-path
                windows; none is an error; each names its kernel
                function), the lattice's keep, forward
                and backtrack entries and their wide instances'
                (lattice_forward_wide, lattice_backtrack_global:
                [kernel:lattice] at K = 96,
                launched in sf:topk96), grid_candidates, the card line,
                and the final {"ok": true, "device": {...}} line.

Any failed phase raises and the script exits non-zero without the final
line. Every time printed carries the card name and power limit, and each
phase line its seconds since the run's start (``at_s``).
"""

from __future__ import annotations

import gc
import json
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

# peak rates of one H100 SXM (dense, no sparsity) at its full 700 W limit
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores (data sheet)
H100_BF16_FLOPS = 133.8e12    # bf16 outside the tensor cores (NVIDIA Hopper
#                               architecture white paper, H100 SXM5 table)
H100_TF32_TC_FLOPS = 495e12   # tf32 tensor cores (data sheet)
H100_BF16_TC_FLOPS = 989e12   # bf16 tensor cores (data sheet)
H100_HBM_BYTES_S = 3.35e12    # HBM3 bandwidth (data sheet)
SWEEP_OPS_PER_PAIR = 24       # f32 operations per exactly swept (point, column) pair
BF16_OPS_PER_PAIR = 18        # the bf16 filter per pair: 17 bf16 operations + a min
MMA_OPS_PER_PAIR = 16         # the tensor-core pass per pair: 8 multiply-adds
N_TRACES, N_POINTS, BUCKET = 1024, 120, 128
CHECK_CHUNKS = 64             # chunks held against _dense_plain where not
#                               all are (the plain sweep is slow): 16,384 points
BATCH_RUNS = 5                # timed match_many batches after the warm-up
MAIN_K_CPU_TRACES = 16        # traces of the main path at the other K also
#                               matched on the CPU
REFERENCE_TRACES = 32         # traces matched on both the card and the CPU
OVERLAP_SLICE = 256           # traces per slice of the overlap check
SERVE_CLIENTS, SERVE_UUIDS, SERVE_PARTS = 64, 2, 3   # [serve]: clients,
#                               uuids per client, in-order requests per uuid
#                               (16 uuids before the watchdog, audit and
#                               backfill phases joined the run, 8 before the
#                               router's traffic did, 4 before the fleet's)
SERVE_MANY = 256              # traces of [serve]'s one /report_many
SERVE_CPU_UUIDS = 32          # uuids also served by the CPU app
SERVER_START_S = 300          # [server]: /health must answer within this
SERVER_REQUESTS = 8           # [server]: requests checked against [serve]
STREAM_ROUNDS, STREAM_ROUND_POINTS = 10, 12   # the streaming feed: rounds
#                               of points per vehicle (10 x 12 = N_POINTS)
STREAM_CHECKPOINT_ROUND = 4   # [stream:recover]: checkpoint after this round
STREAM_CPU_UUIDS = 32         # [stream]: uuids also streamed on the CPU
STREAM_WORKER_TIMEOUT_S = 600  # [stream:worker]: a worker subprocess's limit
TOPO_POLL, TOPO_FLUSH = 1024, 4  # [topo], [topo:lease]: records per partition
#                               a poll (4 points of each of a partition's 256
#                               vehicles) and points a flush: every step
#                               flushes every vehicle it read, so buffers
#                               are empty between steps and a replay from a
#                               checkpoint or a lease floor polls at the same
#                               boundaries as the uninterrupted run
TOPO_STAMP_EVERY = 4          # [topo:trace]: the producer stamps every 4th record
TOPO_SLO_SCALE = "0.01"       # [topo:slo]: RTPU_SLO_SCALE of the topology
TOPO_LEASE_TTL_S = 2.4        # [topo:lease]: the lease time-to-live
TOPO_TIMEOUT_S = 300          # the bound of each wait of a topology run
TOPO_SAMPLE_S = 0.2           # _CardSampler's period
TOPO_SCALE_RUNS = (("dict", 1), ("dict", 2), ("dict", 4), ("columnar", 4))
ORACLE_TRACES = {"sf": 16, "sf+r": 16, "organic": 4}   # [oracle]: traces
#                               through the numpy oracle (exact Dijkstra per
#                               transition on the host: ~160 probes/s on sf
#                               and ~20 on organic on the H100 machine's host;
#                               the restricted sf searches edge space, about
#                               3.4x sf's time on this host), about a minute
#                               at most on each (32, 32 and 6 before the
#                               fleet phases joined the run)
AGREEMENT_GATE = 0.95         # the length-weighted agreement the JAX package
#                               holds its matcher to against the oracle
WATCHDOG_VEHICLES = 256       # [watchdog]: vehicles fed through the pipeline
WATCHDOG_TIMEOUT_S = 2.5      # dispatch_timeout_s: over 5x a warm batch of
#                               the subset (checked), so only the hang trips it
WATCHDOG_HANG_S = 7.5         # the injected hang: 3x the timeout
FALLBACK_VEHICLES = 8         # [watchdog:fallback]: vehicles the oracle serves
FALLBACK_TIMEOUT_S = 0.5      # under a hang of every dispatch
FALLBACK_HANG_S = 30.0
AUDIT_BATCHES, AUDIT_BATCH = 6, 64   # [audit]: served batches, traces each
BACKFILL_PARTITIONS = 4       # [backfill]: the spool's partitions
MESH_DP = 4                   # [mesh:dp], [mesh:backfill]: shards of the
#                               data axis on one card (["cuda:0"] * 4)
MESH_WIRE_TRACES = 1021       # [mesh:dp]: the wire check's traces (not a
#                               multiple of MESH_DP: rows are padded)
MESH_BATCH_RUNS = 3           # [mesh:dp]: timed batches
MESH_SHARDS = 4               # [mesh:sharded]: segment shards (tile axis)
MESH_METRO_TRACES = 64        # [mesh:metro]: traces per metro (N_POINTS)
MESH_METRO_DP = 2             # [mesh:metro]: tile = 3 metros x dp = 2
MESH_GROUP_TIMEOUT_S = 120    # [mesh:group]: the subprocess's limit
KERNEL_BETWEEN_KS = (5, 7, 10)  # [kernel:k], [main:k]: widths between the
#                               built ones (each runs the next built K')
WIDE_RADIUS = 150.0           # [kernel:k], [main:k] past the register widths:
#                               on sf at 50 m no point has more than 16 edges
#                               within reach (a wide list would never evict)
WIDE_KS = (20, 24, 32, 48, 64)  # [kernel:k]: the wide instances' widths
#                               (and the register K = 16 beside them, at
#                               150 m): the lists in shared memory, and at
#                               48 (the gated arms) and 64 (every arm) past
#                               the arm's shared-memory K, in the scratch
MAIN_WIDE_K = 32              # [main:k]: the wide instance on the main path
MAIN_SCRATCH_K = 64           # [main:k]: the scratch instance on the main path
ROUTER_METROS = ("sf", "nyc", "la")   # [router]: BASELINE config 4's trio
ROUTER_CLIENTS, ROUTER_UUIDS = 64, 2  # [router]: clients (round-robin over
#                               the metros) and uuids each, SERVE_PARTS
#                               in-order requests per uuid (384 requests; 8
#                               uuids and 1,536 before the restricted and
#                               per-mode phases joined the run, 4 and 768
#                               before the fleet phases did)
ROUTER_EXPLICIT_EVERY = 4     # every 4th client names its "metro"
ROUTER_MANY = 48              # traces of the mixed /report_many (16 a metro)
ROUTER_START_S = 600          # [router:server]: /health within this
KAFKA_FETCH = 500             # [kafka]: records a fake-client fetch returns
#                               (kafka-python's default max_poll_records)
LINK_SAMPLES = 5              # [link]: probes of the card's host path
GUARD_TIMEOUT_S = 2.0         # [autotune:guard]: CAL_TIMEOUT_S of the run
GUARD_HANG_S = 6.0            # the first measurement's host-side stall
GUARD_MARGIN_S = 5.0          # construction within timeout + this margin
GUARD_TRACES = 256            # traces served by the guarded matcher
AB_ROUNDS = 3                 # [restrict:ab], [grid]: rounds of A, B, B, A
MODES = ("auto", "bicycle", "foot")   # [modes]: the compiled modes
MODES_SERVED = ("bicycle", "foot")   # [modes]: the modes served on the card
MODES_CPU_TRACES = 16         # [modes]: traces also matched on the CPU
MODES_SERVER_REQUESTS = 8     # [modes:server]: requests checked
GRID_BATCH_RUNS = 3           # [grid]: timed batches of the grid matcher
TOPK_TRACES = 16              # [topk]: fleet traces ranked at T = 120
TOPK_LONG_POINTS = 1024       # [topk]: the one long trace (the largest bucket)
TOPK_SCORE_RTOL = 2e-6        # [topk]: card vs CPU scores (tests/test_torch_topk.py)
TOPK_K64_PEAK = 100_000_000   # [topk:k64]: a call's peak bytes at K = 64, T =
#                               1024 stay under this (the outputs, about 34
#                               MB at R = 64; no [T, K, K, M] temporaries)
CAPACITY_SLACK = 2 * 1024**2  # [capacity]: memory_allocated over the formula
FLEET_GEN = 8                 # [fleet]: the JAX bench's generated metros
FLEET_GEN_TRACES, FLEET_GEN_POINTS = 24, 60   # each one's traffic
FLEET_CITY_TRACES = 64        # [fleet]: traces of each city metro (N_POINTS)
FLEET_THREADS, FLEET_ROUNDS = 4, 3   # submitter threads, rounds of traffic
FLEET_STORM_FRAC = 0.5        # [fleet:storm]: budget over the staged total
FLEET_STORM_CYCLES = 2        # cycles of cyclic touches (every one a miss)
FLEET_STORM_TRACES = 8        # traces dispatched at each touch
FLEET_ROUTER_CLIENTS, FLEET_ROUTER_REQUESTS = 16, 96   # [fleet:router]
FLEET_ROUTER_WAIT_S = 300.0   # promote_wait_s there: a metro waits out
#                               the other's leases rather than shed
FLEET_GUARD_TIMEOUT_S, FLEET_GUARD_HANG_S = 1.0, 3.0   # [fleet:guard]
REACH_AUDIT_TRACES = 8        # [reach_audit]: fleet traces audited per tile
#                               (cut from 16 to keep the script's time)
PBF_DECODE_M = 1.2e-7         # [pbf]: 1e-12 degrees (the decode's bound in
#                               tests/test_pbf.py) in meters, with margin
SCRATCH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_chip_scratch")
SOURCES = ("reporter_tpu_torch/kernels/sweep_exact.cu",
           "reporter_tpu_torch/kernels/topk.cuh",
           "reporter_tpu_torch/kernels/viterbi.cu",
           "reporter_tpu_torch/kernels/lattice.cu",
           "reporter_tpu_torch/kernels/grid.cu",
           "reporter_tpu_torch/kernels/route.cuh",
           "reporter_tpu_torch/native/prepare.cc",
           "reporter_tpu_torch/native/walker.cc",
           "reporter_tpu_torch/native/reach.cc")
HOST_SOURCES = SOURCES[6:]    # the host library's (g++)
VITERBI_SOURCE = SOURCES[2]
LATTICE_SOURCE = SOURCES[3]
GRID_SOURCE = SOURCES[4]
# the ranked-path lattice's kernels: launch key → (kernel line name, the
# JAX scan it replaces)
LATTICE_KERNELS = {
    "keep": ("lattice_keep_mask",
             "reporter_tpu/ops/hmm.py:268 interpolation_keep_mask "
             "(lax.scan; not Pallas)"),
    "forward": ("lattice_forward",
                "reporter_tpu/ops/hmm.py:290 _forward_lattice and :519 the "
                "list step of viterbi_kbest_paths (lax.scan; not Pallas)"),
    "backtrack": ("lattice_backtrack",
                  "reporter_tpu/ops/hmm.py:454 and :566 back_one, vmapped "
                  "(lax.scan; not Pallas)"),
}
# the kernel function behind each lattice launch key (the forward's
# shared instances by tree depth, LOG = 0 at R = 1)
LATTICE_FUNCTIONS = {
    "keep": "lattice_keep_kernel", "forward": "lattice_forward_kernel<LOG>",
    "forward:wide": "lattice_forward_kernel<-1>",
    "backtrack": "lattice_backtrack_kernel",
    "backtrack:global": "lattice_backtrack_global_kernel"}
GRID_REPLACES = ("reporter_tpu/ops/candidates.py:117 _topk_distinct_edges "
                 "in find_candidates :139 (lax.scan, vmapped; not Pallas)")
LONG_LIST_RADIUS = 250.0      # [wide:decode], [kernel:lattice]: sf's
#                               lists run past 64 edges here (up to some
#                               90), so a wide instance's second mask word,
#                               its list entries past 63 and a merge of
#                               more than 64 live heads carry candidates;
#                               the phases fail unless a list is over 64
LATTICE_CASES = ((8, None, (1, 8)), (64, WIDE_RADIUS, (1, 64)),
                 (96, WIDE_RADIUS, (1, 96)), (96, LONG_LIST_RADIUS, (1, 96)))
#                               [kernel:lattice]: (K, radius, the R run);
#                               T = 128 and 1024 at K = 8, 1024 at K = 64
#                               and 96 (the wide forward, the backtrack's
#                               ring of three walker warps at R = 1 and its
#                               levels read in place at R = 96)
GRID_CASES = ((8, None), (64, WIDE_RADIUS))   # [kernel:grid]: (K, radius)
LATTICE_OPS_PER_KEEP = 6      # a point of the keep mask: 2 sub, 2 mul, add,
#                               compare
GRID_OPS_PER_SLOT = 24        # a slot's distance, projection and radius test
GRID_OPS_PER_ROUND_SLOT = 3   # a selection round's compare, pack and mask
#                               per slot
VITERBI_REPLACES = ("reporter_tpu/ops/hmm.py:112 viterbi_decode_batched "
                    "(lax.scan; not Pallas)")
VITERBI_CASES = ((8, None), (16, WIDE_RADIUS), (32, WIDE_RADIUS),
                 (64, WIDE_RADIUS))   # [kernel:viterbi]: (K, search radius;
#                               None the default 50 m)
WIDE_DECODE_CASES = ((96, WIDE_RADIUS), (128, WIDE_RADIUS),
                     (256, WIDE_RADIUS), (96, LONG_LIST_RADIUS))
#                               [wide:decode]: (K, search radius) past K =
#                               64 (Viterbi instances 1, 1, 2, 1)
WIDE_PLAIN_SLICE = 128        # the plain version's traces at once
WIDE_CPU_TRACES = 4           # [wide:decode]: records held to the CPU's
WIDE_TOPK_K = 96              # [wide:topk]: match_topk's K
VITERBI_OPS_PER_LOOKUP = 2    # a reach-row entry read: a compare and a
#                               select (a probe of the binary search, or an
#                               entry of a linear scan)
VITERBI_OPS_PER_PAIR = 16     # a looked-up pair's route, cost and argmin step
GATE_REL_TOL = 1e-3           # tensor-core vs plain gate: decisions may differ
#                               only where the plain minimum is this close
#                               (relative) to the threshold (summation order)

# arm → (MatcherParams levers, the TPU kernel it replaces)
ARMS = {
    "block": (dict(sweep_subcull=False),
              "reporter_tpu/ops/dense_candidates.py:389"),
    "sub": ({}, "reporter_tpu/ops/dense_candidates.py:433"),
    "sub_bf16": (dict(sweep_lowp="bf16"),
                 "reporter_tpu/ops/dense_candidates.py:567"),
    "mxu": (dict(sweep_mxu=True), "reporter_tpu/ops/dense_candidates.py:521"),
    "mxu_bf16": (dict(sweep_mxu=True, sweep_lowp="bf16"),
                 "reporter_tpu/ops/dense_candidates.py:549"),
}
PLAN_ARMS = {"block": "block", "subcull": "sub", "subcull+bf16": "sub_bf16",
             "mxu": "mxu", "mxu+bf16": "mxu_bf16"}


T0 = time.perf_counter()      # the run's start: each phase line's at_s
LINES: "list[str]" = []       # every phase line printed ([bench_delta])


def phase(tag: str, card: str, **fields) -> None:
    fields["at_s"] = round(time.perf_counter() - T0, 3)
    line = f"[{tag}] [{card}] " + json.dumps(fields)
    LINES.append(line)
    print(line, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timed runs,
    each timed alone (the host's time to issue it included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def launch_ms(fn, runs: int = 20) -> float:
    """Milliseconds per call of ``fn`` in a back-to-back run of ``runs``
    calls between two CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def fleet_points(fleet):
    pts = np.zeros((len(fleet), BUCKET, 2), np.float32)
    for i, p in enumerate(fleet):
        pts[i, :len(p.xy)] = p.xy
        pts[i, len(p.xy):] = p.xy[0]
    return pts.reshape(-1, 2)


def kernel_gates(dc, arm, fpts, ids, nhits, pack, sub, feat, coarse, radius,
                 k, sweep):
    """The kernel's (warp, slice) vote and gate decisions (one debug
    launch) against the plain vote and gates; raises where they disagree
    beyond the stated tolerance. → (kernel decisions, plain gate or None,
    fields to print, first-group passes or None)."""
    log = torch.zeros((ids.shape[0], dc._P // 32, ids.shape[1]),
                      dtype=torch.int32, device="cuda")
    dc.sweep_topk(fpts, ids, nhits, sweep, sub, coarse, radius, k, arm,
                  gate_log=log)
    kg = dc.decode_gate_log(log)
    if not torch.equal(kg.vote, dc._slice_votes(
            fpts, ids, nhits, sub, dc.cull_radius(radius) ** 2)):
        raise SystemExit(f"arm {arm}: the kernel's slice votes differ from "
                         "the plain vote")
    if arm == "sub":
        return kg, None, {}, None
    if arm == "sub_bf16":
        pg = dc._coarse_bf16_gate(fpts, ids, nhits, pack, sub, radius)
        differ = pg.gate != kg.gate
        off, tol = differ, 0
    else:
        pg = dc._coarse_mxu_gate(fpts, ids, nhits, sub, feat, radius,
                                 "bf16" if arm == "mxu_bf16" else "off")
        differ = pg.gate != kg.gate
        off = differ & ((pg.cmin - pg.thr).abs() > GATE_REL_TOL * pg.thr)
        tol = f"relative {GATE_REL_TOL} of the threshold"
    if off.any():
        raise SystemExit(f"{arm} gate: {int(off.sum())} decisions differ "
                         f"from the plain gate beyond the tolerance {tol}")
    # bit 8 + s: slice s's gate passed in its first group of columns
    first = dc.decode_gate_log(log >> 8).vote
    if (first & ~kg.gate).any():
        raise SystemExit(f"{arm}: a gate passed early but was not swept")
    fields = {"gate_mismatches": int(differ.sum()),
              "gate_mismatches_off_threshold": int(off.sum()),
              "gate_tolerance": tol,
              "gate_first_group_share_of_voted":
                  int(first.sum()) / max(int(kg.vote.sum()), 1)}
    return kg, pg, fields, first


def order_phase(card, dc, build, fpts, ids, nhits, sweep, sub, radius, k,
                metro):
    """The ring-fed call's chunk order kernel against its plain version,
    _chunk_order (tolerance 0), and the counter it zeroes: after the sweep
    it must hold nchunks + grid (each CTA fails one take)."""
    nchunks, nblocks = ids.shape
    order = torch.full((nchunks + 1,), -7, dtype=torch.int32, device="cuda")
    out = [torch.empty((nchunks * dc._P, k), dtype=dt, device="cuda")
           for dt in (torch.int32, torch.float32, torch.float32)]
    rc = dc.cull_radius(radius)
    build.launch_sweep_exact(fpts, ids, nhits, order, sweep, sub, None,
                             dc.SWEEP_ARMS.index("sub"), nchunks, nblocks,
                             radius * radius, rc * rc, radius, *out)
    sh = build.exact_shape(dc.SWEEP_ARMS.index("sub"), k)
    grid = min(nchunks, sh["ctas_per_sm"] * sh["sms"])
    equal = torch.equal(order[:nchunks], dc._chunk_order(nhits))
    counter = int(order[nchunks])
    phase("kernel:order", card, metro=metro, chunks=nchunks,
          equal_to_plain=equal, counter=counter, grid=grid)
    if not equal or counter != nchunks + grid:
        raise SystemExit("the chunk order kernel differs from _chunk_order "
                         f"(equal {equal}) or its counter ended at {counter}")


def spread_phase(card, dc, nhits, kg, metro):
    """The work spread the exact kernel balances: hit blocks per chunk,
    and (from the sub arm's votes) voted (warp, slice) tiles per chunk
    and per (warp, hit block)."""
    per_chunk = kg.vote.sum(dim=(1, 2, 3)).float()
    hit = (torch.arange(kg.vote.shape[2], device="cuda")[None, :]
           < nhits[:, None])                             # [nc, slot]
    per_wb = kg.vote.sum(3).float()[hit[:, None, :].expand(
        -1, kg.vote.shape[1], -1)]
    phase("kernel:spread", card, metro=metro, chunks=int(nhits.numel()),
          hit_blocks_per_chunk={"max": int(nhits.max()),
                                "mean": float(nhits.float().mean())},
          voted_tiles_per_chunk={"max": int(per_chunk.max()),
                                 "mean": float(per_chunk.mean())},
          voted_slices_per_warp_block={"max": int(per_wb.max()),
                                       "mean": float(per_wb.mean()),
                                       "zero_share": float((per_wb == 0)
                                                           .float().mean())})


def check_rows(dc, nhits, n_chunks):
    """Point rows of ``n_chunks`` chunks: the first half in point order and
    the last half in the order the persistent CTAs take them
    (_chunk_order, heaviest first): with more chunks than the grid, those
    are taken by a CTA after its first. → (rows i64, chunk ids i64)."""
    order = dc._chunk_order(nhits).long()
    half = n_chunks // 2
    chunks = torch.unique(torch.cat([
        torch.arange(half, device="cuda"), order[-(n_chunks - half):]]))
    rows = (chunks[:, None] * dc._P
            + torch.arange(dc._P, device="cuda")[None, :]).reshape(-1)
    return rows, chunks


def kernel_phase(card, tab, pts, radius, k, dc, build, metro, tag="kernel",
                 check_chunks=None, plain_reps=3, versus=None):
    """Every arm on the same points at top-K width k: equal to the first
    arm on all of them and bit-equal to _dense_plain on all of them, or
    on ``check_chunks`` chunks (check_rows); its gate against the plain
    gate, its time and its bound; its instance's launch shape and where
    it keeps its lists (dc.list_plan); the chunk order and the work
    spread (tag "kernel"). ``versus`` ({arm: record} of another K in this
    call) adds each arm's ratio of times to it. → {arm: record}."""
    n = pts.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    nchunks = n // dc._P
    fpts, fval = dc._fill_invalid(pts, valid, nchunks)

    def prepass():
        return dc._chunk_block_ids(fpts, fval, tab["seg_bbox"], radius,
                                   nchunks)

    ids, nhits = prepass()
    pack, sub, feat = tab["seg_pack"], tab["seg_sub"], tab["seg_feat"]
    sweep, co_tab = tab["seg_sweep"], tab["seg_coarse"]
    if tag == "kernel":
        order_phase(card, dc, build, fpts, ids, nhits, sweep, sub, radius, k,
                    metro)
    if check_chunks is None:
        rows, chunks = torch.arange(n, device="cuda"), None
    else:
        rows, chunks = check_rows(dc, nhits, check_chunks)
    check_n = int(rows.numel())
    cpts = pts[rows]
    ref = dc._dense_plain(cpts, pack, radius, k)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: dc._dense_plain(cpts, pack, radius, k),
                       reps=plain_reps, warmup=1 if plain_reps > 1 else 0)
    prepass_ms = cuda_ms(prepass, reps=20)
    nblocks = ids.shape[1]
    hit = torch.arange(nblocks, device="cuda")[None, :] < nhits[:, None]
    used = torch.zeros(nblocks, dtype=torch.bool, device="cuda")
    used[ids[hit].long()] = True
    n_used = int(used.sum())
    io_bytes = (pts.numel() * 4 + ids.numel() * 4 + nhits.numel() * 4
                + n * k * 12)
    slices = int(nhits.sum()) * (dc._P // 32) * (dc._SBLK // dc._SUB)
    tile = 32 * dc._SUB                       # pairs of one (warp, slice)
    arms, first_out = {}, None
    for arm in dc.SWEEP_ARMS:
        def run(a=arm):
            return dc.sweep_topk(fpts, ids, nhits, sweep, sub, co_tab,
                                 radius, k, a)
        got = run()
        torch.cuda.synchronize()
        mism = {f: int((g[rows] != r).sum()) for f, g, r in
                zip(("edge", "offset", "dist"), got, ref)}
        err = max(float((got[1][rows] - ref[1]).abs().max()),
                  float((got[2][rows] - ref[2]).abs().max()))
        if any(mism.values()):
            raise SystemExit(f"{metro} K={k}: kernel arm {arm} disagrees "
                             f"with _dense_plain: {mism}")
        if first_out is None:
            first_out = got
        elif not all(torch.equal(g, f) for g, f in zip(got, first_out)):
            raise SystemExit(f"{metro} K={k}: kernel arm {arm} differs from "
                             f"arm {dc.SWEEP_ARMS[0]} on {n} points")
        sh = build.exact_shape(dc.SWEEP_ARMS.index(arm), k)
        grid = min(nchunks, sh["ctas_per_sm"] * sh["sms"])
        rec = {"mismatches": mism, "max_abs_err": err,
               "ms": cuda_ms(run, reps=20), "ms_back_to_back": launch_ms(run),
               "plain_ms": plain_ms, "plain_points": check_n,
               "chunks": nchunks, "grid": grid,
               "instance": "wide" if dc.is_wide(k) else "register",
               "lists": dc.list_plan(arm, k)[0],
               "smem_bytes": sh["smem_bytes"],
               "ctas_per_sm": sh["ctas_per_sm"], "depth": sh["depth"],
               "equal_across_arms": True}
        if versus is not None:
            rec["ratio"] = {
                "single": rec["ms"] / versus[arm]["ms"],
                "back_to_back": (rec["ms_back_to_back"]
                                 / versus[arm]["ms_back_to_back"])}
        if chunks is not None:
            # checked chunks a CTA takes after its first (order position
            # at or past the grid)
            pos = torch.empty(nchunks, dtype=torch.long, device="cuda")
            pos[dc._chunk_order(nhits).long()] = torch.arange(
                nchunks, device="cuda")
            rec["checked_chunks_taken_later"] = int(
                (pos[chunks] >= grid).sum())
            if nchunks > grid and not rec["checked_chunks_taken_later"]:
                raise SystemExit(f"{metro} K={k} {arm}: no checked chunk is "
                                 "taken after a CTA's first")
        nbytes = io_bytes + n_used * dc.SP_NCOMP * dc._SBLK * 4
        if arm == "block":
            exact = int(nhits.sum()) * dc._SBLK * dc._P
            coarse, coarse_rate = 0, None
        else:
            kg, pg, fields, first = kernel_gates(
                dc, arm, fpts, ids, nhits, pack, sub, feat, co_tab, radius,
                k, sweep)
            if arm == "sub" and tag == "kernel":
                spread_phase(card, dc, nhits, kg, metro)
            nbytes += n_used * sub.shape[1] * 4
            exact = int(kg.gate.sum()) * tile
            coarse, coarse_rate = 0, None
            rec.update(vote_share=int(kg.vote.sum()) / slices,
                       gate_share=int(kg.gate.sum()) / slices, **fields)
            if pg is not None:
                rec["plain_gate_share"] = int(pg.gate.sum()) / slices
            if arm != "sub":
                # the pairs the gate's early exit leaves to test: a group
                # where it passed in its first, at least two where it
                # passed later, all 128 columns where it culled
                later = int((kg.gate & ~first).sum())
                culled = int((kg.vote & ~kg.gate).sum())
                group = build.exact_shape(
                    dc.SWEEP_ARMS.index(arm), k)["gate_group"]
                coarse = 32 * (int(first.sum()) * group + later * 2 * group
                               + culled * dc._SUB)
                coarse_rate = {"sub_bf16": H100_BF16_FLOPS,
                               "mxu": H100_TF32_TC_FLOPS,
                               "mxu_bf16": H100_BF16_TC_FLOPS}[arm]
                # the gate's table columns of every slice some warp voted
                # for: the feat rows, or the filter's five bf16 fields
                bs = torch.zeros((nblocks, dc._SBLK // dc._SUB),
                                 dtype=torch.bool, device="cuda")
                v = kg.vote.any(1)                         # [nc, slot, nsub]
                c, j, s = v.nonzero(as_tuple=True)
                bs[ids[c, j].long(), s] = True
                per_col = dc.SF_NCOMP * 4 if arm.startswith("mxu") \
                    else dc.FL_NCOMP * 2
                nbytes += int(bs.sum()) * dc._SUB * per_col
        t_exact = exact * SWEEP_OPS_PER_PAIR / H100_F32_FLOPS * 1e3
        t_coarse = (coarse * (BF16_OPS_PER_PAIR if arm == "sub_bf16"
                              else MMA_OPS_PER_PAIR) / coarse_rate * 1e3
                    if coarse else 0.0)
        # the bf16 filter shares the CUDA cores with the exact pass (times
        # add); the tensor cores may run beside them (the larger counts)
        t_ops = t_exact + t_coarse if arm == "sub_bf16" \
            else max(t_exact, t_coarse)
        t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
        rec.update(exact_pairs=exact, coarse_pairs=coarse, bytes=nbytes,
                   coarse_rate_flops=coarse_rate,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        arms[arm] = rec
        # lint: allow[bench-coverage] 2026-10-18 the kernel record's keys
        # (rec, with kernel_gates' fields); [bench_delta] reads the printed
        # line
        phase(tag if tag != "kernel" else f"kernel:{arm}", card, metro=metro,
              arm=arm, k=k, points=n, search_radius=radius,
              prepass_ms=prepass_ms,
              mean_hit_blocks=float(nhits.float().mean()), **rec)
    return arms


def gates_phase(card, dc, radius, k):
    """Parallel streets 500 m apart (8 m segments every 10 m) and 256
    patches of 32 points within 30 m of a centre: the coarse gates cull a
    share of the voted slices here (on sf the tensor-core gate admits every
    voted slice). Every arm bit-equal to _dense_plain; each coarse gate
    held to its plain version and required to cull."""
    x = np.arange(0.0, 4000.0, 10.0)
    y = np.arange(0.0, 4000.0, 500.0)
    a = np.stack(np.meshgrid(x, y), -1).reshape(-1, 2).astype(np.float32)
    b = (a + np.float32([8.0, 0.0])).astype(np.float32)
    sp = dc.build_seg_pack(a, b, np.arange(len(a), dtype=np.int32),
                           np.zeros(len(a), np.float32),
                           np.full(len(a), 8.0, np.float32))
    pack, bbox, sub, feat, sweep, coarse = (torch.from_numpy(v).cuda()
                                            for v in sp)
    rng = np.random.default_rng(4)
    centres = rng.uniform(0.0, 4000.0, (256, 1, 2))
    pts = torch.from_numpy((centres + rng.uniform(-30.0, 30.0, (256, 32, 2)))
                           .reshape(-1, 2).astype(np.float32)).cuda()
    nchunks = pts.shape[0] // dc._P
    fpts, fval = dc._fill_invalid(
        pts, torch.ones(pts.shape[0], dtype=torch.bool, device="cuda"),
        nchunks)
    ids, nhits = dc._chunk_block_ids(fpts, fval, bbox, radius, nchunks)
    ref = dc._dense_plain(pts, pack, radius, k)
    out = {}
    for arm in dc.SWEEP_ARMS:
        got = dc.sweep_topk(fpts, ids, nhits, sweep, sub, coarse, radius, k,
                            arm)
        mism = sum(int((g != r).sum()) for g, r in zip(got, ref))
        if mism:
            raise SystemExit(f"parallel streets: arm {arm} differs from "
                             f"_dense_plain in {mism} values")
        if arm in ("block", "sub"):
            continue
        kg, pg, fields, _ = kernel_gates(dc, arm, fpts, ids, nhits, pack,
                                         sub, feat, coarse, radius, k, sweep)
        vote, gate, plain = (int(kg.vote.sum()), int(kg.gate.sum()),
                             int(pg.gate.sum()))
        out[arm] = dict(voted=vote, gate_passed=gate, plain_gate_passed=plain,
                        **fields)
        if not (gate < vote and plain < vote):
            raise SystemExit(f"parallel streets: the {arm} gate culls "
                             f"nothing ({gate} and plain {plain} of {vote})")
    phase("gates:rows", card, points=int(pts.shape[0]),
          segments=len(a), arms=out)


class Windows:
    """Launch windows of the main path: ``run(path, fn)`` sets every
    instance's launch count (the sweep's, the Viterbi's, the lattice's
    and the grid's) to 0 just before fn() and reads them just after; the
    counts are kept per path, the sweep's in ``by_path`` (returned), the
    Viterbi's, keyed by K, in ``viterbi_by_path``, the lattice's, keyed
    by kernel, in ``lattice_by_path`` and the grid's, keyed by K, in
    ``grid_by_path``."""

    def __init__(self, dc):
        from reporter_tpu_torch.ops import candidates, hmm

        self.dc = dc
        self.hmm = hmm
        self.cand = candidates
        self.by_path: dict = {}
        self.viterbi_by_path: dict = {}
        self.lattice_by_path: dict = {}
        self.grid_by_path: dict = {}

    def run(self, path, fn):
        for counts in (self.dc.SWEEP_LAUNCHES, self.hmm.VITERBI_LAUNCHES,
                       self.hmm.LATTICE_LAUNCHES, self.cand.GRID_LAUNCHES):
            for key in counts:
                counts[key] = 0
        out = fn()
        counts = dict(self.dc.SWEEP_LAUNCHES)
        self.by_path[path] = counts
        self.viterbi_by_path[path] = dict(self.hmm.VITERBI_LAUNCHES)
        self.lattice_by_path[path] = dict(self.hmm.LATTICE_LAUNCHES)
        self.grid_by_path[path] = dict(self.cand.GRID_LAUNCHES)
        return out, counts


def only(counts, inst, what):
    """The run launched instance ``inst`` (its dc.launch_key: (arm, K), or
    (arm + ":scratch", K)) and no other."""
    if counts.get(inst, 0) < 1 \
            or any(n for i, n in counts.items() if i != inst):
        raise SystemExit(f"{what} should launch {inst} and no other "
                         f"instance: { {i: n for i, n in counts.items() if n} }")


def json_records(recs):
    return [[r.to_json() for r in x] for x in recs]


def timed_batches(m, traces, runs=BATCH_RUNS):
    """A warm-up match_many, then ``runs`` timed ones. → (the last run's
    records, fields: the batch's median, min-max spread and stage
    medians, in ms)."""
    m.match_many(traces)
    m.point_counts = dict.fromkeys(m.point_counts, 0)
    walls, stages, first = [], {k: [] for k in m.stage_seconds}, None
    for _ in range(runs):
        m.stage_seconds = dict.fromkeys(m.stage_seconds, 0.0)
        t0 = time.perf_counter()
        recs = m.match_many(traces)
        walls.append(time.perf_counter() - t0)
        for key, v in m.stage_seconds.items():
            stages[key].append(v)
        if first is None:
            first = json_records(recs)
    if json_records(recs) != first:
        raise SystemExit("match_many gave different records on two runs")
    med = statistics.median(walls)
    probes = sum(len(t.xy) for t in traces)
    pc = m.point_counts
    return recs, {
        "batches": runs, "batch_ms_median": med * 1e3,
        "batch_ms_min": min(walls) * 1e3, "batch_ms_max": max(walls) * 1e3,
        "spread_pct_of_median": (max(walls) - min(walls)) / med * 100,
        "probes_per_s": probes / med,
        **{f"{key}_ms": statistics.median(v) * 1e3
           for key, v in stages.items()},
        "unmatched_share": pc["unmatched"] / max(pc["points"], 1)}


def main_phase(card, ts, fleet, dc, win, metro, MatcherParams,
               SegmentMatcher, Trace, request=True):
    """Construction (calibration), the tuned batch timed BATCH_RUNS times,
    one pinned matcher's batch per arm and one request, each its own
    launch window. → (tuned matcher, traces, records, batch fields, tuner
    report's per-arm ms)."""
    from reporter_tpu_torch.matcher.autotune import CAL_DISPATCHES

    traces = [Trace(uuid=p.uuid, xy=p.xy.astype(np.float32), times=p.times)
              for p in fleet]
    t0 = time.perf_counter()
    m, cal = win.run(f"{metro}:calibration", lambda: SegmentMatcher(ts))
    build_s = time.perf_counter() - t0
    rep = m.tuned_report
    cand_ms = {lab: c["device_ms_per_dispatch"]
               for lab, c in rep.get("candidates", {}).items()}
    phase("autotune", card, metro=metro,
          plan=m.tuned_plan and m.tuned_plan.label,
          source=rep.get("source"), construct_s=build_s,
          calibration_seconds=rep.get("calibration_seconds"),
          calibration_dispatches=rep.get("calibration_dispatches"),
          candidate_ms=cand_ms, errors=rep.get("errors"),
          calibration_launches={a: n for (a, k), n in cal.items() if n})
    if rep.get("errors") or rep.get("source") != "measured" \
            or m.tuned_plan is None or len(cand_ms) != len(dc.SWEEP_ARMS):
        raise SystemExit(f"calibration did not measure every arm: {rep}")
    # one warm-up and CAL_DISPATCHES timed launches of every arm at K = 8
    if any(n != (CAL_DISPATCHES + 1 if k == 8 else 0)
           for (a, k), n in cal.items()):
        raise SystemExit(f"calibration launches: {cal}")
    tuned = PLAN_ARMS[m.tuned_plan.label.split("@")[0]]
    m.match_many(traces[:64])                     # warm the allocator
    (recs, fields), served = win.run(f"{metro}:tuned_batch",
                                     lambda: timed_batches(m, traces))
    only(served, (tuned, 8), f"{metro}: the tuned matcher's batches")
    want = json_records(recs)
    pinned_ms = {}
    for arm, (levers, _) in ARMS.items():
        pm, built = win.run(f"{metro}:pinned_build",
                            lambda lv=levers: SegmentMatcher(
                                ts, MatcherParams(sweep_autotune=False,
                                                  **lv)))
        if any(built.values()) or pm.tuned_plan is not None:
            raise SystemExit(f"the matcher pinned to {arm} tuned: {built}")
        t0 = time.perf_counter()
        got, counts = win.run(f"{metro}:pinned_batch:{arm}",
                              lambda pm=pm: pm.match_many(traces))
        pinned_ms[arm] = (time.perf_counter() - t0) * 1e3
        only(counts, (arm, 8), f"{metro}: the matcher pinned to {arm}")
        if json_records(got) != want:
            raise SystemExit(f"{metro}: the matcher pinned to {arm} differs "
                             "from the tuned matcher")
    n_req = None
    if request:
        answer, req = win.run(f"{metro}:request",
                              lambda: m.match(fleet[0].to_report_json()))
        only(req, (tuned, 8), "the request")
        n_req = len(answer["segments"])
        if not n_req:
            raise SystemExit("the request matched no segment")
    n_rec = recs.n_records
    # lint: allow[bench-coverage] 2026-10-18 timed_batches' fields
    # (batch_ms_*, stage medians, probes_per_s); [bench_delta] reads the
    # printed line
    phase("main", card, metro=metro, traces=len(traces),
          probes=sum(len(t.xy) for t in traces), tuned_arm=tuned,
          records=n_rec, pinned_batch_ms=pinned_ms,
          request_segments=n_req, result=type(recs).__name__, **fields)
    if not n_rec:
        raise SystemExit("main path produced no records")
    c = recs.columns
    if not (np.isfinite(c.length).all() and np.isfinite(c.start_time).all()
            and np.isfinite(c.end_time).all()):
        raise SystemExit(f"{metro}: non-finite record fields")
    return m, traces, recs, fields, cand_ms


def walk_phase(card, m, ts, traces, recs, fields, MatcherParams,
               SegmentMatcher, metro):
    """The three walks of the tuned batch (the C walk through match_many,
    the Python walk, NativeWalker.walk of the same decoded arrays), equal
    record for record; the C prepare against the numpy form; whether the
    harvest's walk overlaps the main thread's wait in .cpu() in
    OVERLAP_SLICE-trace slices."""
    from reporter_tpu_torch.matcher import native_prepare
    from reporter_tpu_torch.matcher.api import walk_python

    decoded = m._decode_many(traces)
    t0 = time.perf_counter()
    py = walk_python(ts, traces, decoded, m._route_fn,
                     m.params.backward_slack)
    py_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    direct = m._walk_decoded(traces, decoded)
    direct_ms = (time.perf_counter() - t0) * 1e3
    want = json_records(recs)
    equal = {"python_walk": json_records(py) == want,
             "native_walker_walk": json_records(direct) == want}
    work, sliced = m.plan_submit(traces)
    xys = [work[w][2] for w in sliced[0][1]]
    c_prep = native_prepare.prepare_slice(xys, sliced[0][0])
    np_prep = native_prepare.prepare_slice_python(xys, sliced[0][0])
    prep_equal = c_prep[0] == np_prep[0] and all(
        a.tobytes() == b.tobytes() for a, b in zip(c_prep[1:], np_prep[1:])
        if a is not None)
    prep_ms = {name: 1e3 * statistics.median(
        _seconds(lambda f=f: f(xys, sliced[0][0])) for _ in range(5))
        for name, f in (("c", native_prepare.prepare_slice),
                        ("numpy", native_prepare.prepare_slice_python))}
    # the overlap: slices of OVERLAP_SLICE traces, so the worker walks
    # slice k while the main thread waits on slice k + 1
    om = SegmentMatcher(ts, m.params.replace(max_device_batch=OVERLAP_SLICE,
                                             sweep_autotune=False))
    om.match_many(traces)
    om.stage_seconds = dict.fromkeys(om.stage_seconds, 0.0)
    orecs = om.match_many(traces)
    st = {k: v * 1e3 for k, v in om.stage_seconds.items()}
    serial = st["prepare"] + st["dispatch"] + st["device"] + st["walk"]
    phase("walk", card, metro=metro, records_equal=equal,
          walk_ms={"c_match_many_median": fields["walk_ms"],
                   "python": py_ms, "native_walker_walk": direct_ms},
          prepare_ms={"c": prep_ms["c"], "numpy": prep_ms["numpy"],
                      "bytes_equal": prep_equal, "mode": int(c_prep[0]),
                      "slice_traces": len(xys)},
          overlap={"slices": -(-len(traces) // OVERLAP_SLICE),
                   "stage_ms": st, "serial_sum_ms": serial,
                   "overlapped_ms": serial - st["wall"],
                   "records_equal": json_records(orecs) == want})
    if not (all(equal.values()) and prep_equal
            and json_records(orecs) == want):
        raise SystemExit(f"{metro}: the walks or the prepares differ")


def _seconds(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main_k_phase(card, ts, traces, dc, win, MatcherParams, SegmentMatcher,
                 cache):
    """The main path at every other K of SWEEP_KS and at each K of
    KERNEL_BETWEEN_KS, and with a WIDE_RADIUS search radius at MAIN_WIDE_K
    (the wide instance, lists in shared memory) and MAIN_SCRATCH_K (lists
    in the global scratch): a tuned matcher (its calibration launches
    every arm at the instance K' that serves K, each under its
    dc.launch_key) serves the batch of
    ``traces`` (at 1024 traces, 512 sweep chunks: more than the grid);
    its first MAIN_K_CPU_TRACES records equal the CPU matcher's. The
    tuner's cache is keyed by tile and card, not K, so each K gets a
    fresh cache directory under ``cache`` (or it would reuse K = 8's
    plan and calibrate nothing)."""
    from reporter_tpu_torch.matcher.autotune import CAL_DISPATCHES

    register = sorted(set(dc.SWEEP_KS) | set(KERNEL_BETWEEN_KS))
    cases = [(k, {}) for k in register if k != 8] + [
        (k, {"search_radius": WIDE_RADIUS})
        for k in (MAIN_WIDE_K, MAIN_SCRATCH_K)]
    for k, levers in cases:
        t_k = time.perf_counter()
        kk = dc.sweep_instance_k(k)
        os.environ["RTPU_AUTOTUNE_CACHE"] = os.path.join(cache, f"k{k}")
        p = MatcherParams(max_candidates=k, **levers)
        m, cal = win.run(f"sf:k{k}:calibration",
                         lambda p=p: SegmentMatcher(ts, p))
        # every arm at the serving instance, nothing else (a wide
        # instance's key exists only once launched)
        if m.tuned_plan is None or {key: n for key, n in cal.items() if n} \
                != {dc.launch_key(a, kk): CAL_DISPATCHES + 1
                    for a in dc.SWEEP_ARMS}:
            raise SystemExit(f"K={k}: calibration launches {cal}")
        tuned = PLAN_ARMS[m.tuned_plan.label.split("@")[0]]
        batch = traces
        t0 = time.perf_counter()
        recs, served = win.run(f"sf:k{k}:tuned_batch",
                               lambda m=m, b=batch: m.match_many(b))
        ms = (time.perf_counter() - t0) * 1e3
        only(served, dc.launch_key(tuned, kk), f"the tuned matcher at K={k}")
        small = batch[:MAIN_K_CPU_TRACES]
        cpu = SegmentMatcher(ts, p, device="cpu").match_many(small)
        equal = json_records(cpu) == json_records(recs[:MAIN_K_CPU_TRACES])
        phase("main:k", card, metro="sf", k=k, instance_k=kk,
              instance=dc.list_plan(tuned, kk)[0],
              search_radius=p.search_radius, tuned_arm=tuned,
              traces=len(batch), batch_ms=ms, records=recs.n_records,
              card_vs_cpu_records_equal=equal, traces_checked=len(small),
              seconds=time.perf_counter() - t_k)
        if not equal or not recs.n_records:
            raise SystemExit(f"K={k}: the card's records differ from the "
                             "CPU's, or there are none")
    os.environ["RTPU_AUTOTUNE_CACHE"] = cache


def first_slice(m, traces):
    """The first bucket slice of ``traces`` as the wire entries decode it
    on the card: (prepared slice, points f32 [B, T, 2], valid [B, T])."""
    from reporter_tpu_torch.ops import match as match_ops

    work, sliced = m.plan_submit(traces)
    ps = m.prepare_submit_slice(traces, work, *sliced[0])
    if ps.mode == 0:
        bpts = torch.from_numpy(ps.pts).cuda()
    else:                          # the wire entries' integer decode
        q = torch.from_numpy(ps.payload).cuda().to(torch.int32)
        if ps.mode == 2:
            q = torch.cumsum(q, 1, dtype=torch.int32)
        bpts = (torch.from_numpy(ps.origins).cuda()[:, None, :]
                + q.to(torch.float32) * match_ops.OFFSET_QUANTUM)
    lens = torch.from_numpy(ps.lens).cuda()
    return ps, bpts, match_ops._valid(lens, bpts.shape[1])


def breakdown_phase(card, m, ts, traces, cand_ms, MatcherParams):
    """Where the device time of one slice goes: the sweep (pre-pass +
    kernel) per arm, the Viterbi (the kernel, and its plain version beside
    it) and the wire pack, each timed alone."""
    from reporter_tpu_torch.ops import hmm
    from reporter_tpu_torch.ops import match as match_ops
    from reporter_tpu_torch.ops.hmm import viterbi_decode_batched
    from torch.profiler import ProfilerActivity, profile

    ps, bpts, bval = first_slice(m, traces)
    p = m.params
    cands = match_ops.batch_candidates(bpts, bval, m.tables, p)
    vit_args = (p.sigma_z, p.beta, p.max_route_distance_factor,
                p.breakage_distance, p.backward_slack, p.interpolation_distance)
    vit = viterbi_decode_batched(cands, bpts, bval, m.tables, *vit_args)
    out = match_ops.MatchOutput(vit.edge, vit.offset, vit.chain_start,
                                vit.matched)
    cand_arm_ms = {}
    for arm, (levers, _) in ARMS.items():
        pa = MatcherParams(sweep_autotune=False, **levers)
        cand_arm_ms[arm] = cuda_ms(lambda pa=pa: match_ops.batch_candidates(
            bpts, bval, m.tables, pa), reps=10)
    stage_ms = {
        "viterbi": cuda_ms(lambda: viterbi_decode_batched(
            cands, bpts, bval, m.tables, *vit_args), reps=5, warmup=1),
        "viterbi_plain": cuda_ms(lambda: hmm._viterbi_plain(
            cands, bpts, bval, m.tables, *vit_args), reps=2, warmup=1),
        "pack": cuda_ms(lambda: match_ops._pack_wire(
            out, ts.num_edges, m.wire_spec), reps=5),
        "wire_entry": cuda_ms(lambda: m.submit_prepared(ps), reps=5,
                              warmup=1)}
    # device busy share of one wire entry: kernel time summed by the
    # profiler over the entry's wall time (None if the trace shows none)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.submit_prepared(ps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_run = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels_run)
    top = sorted(kernels_run, key=lambda e: -e.self_device_time_total)
    # lint: allow[bench-coverage] 2026-10-18 one <stage>_ms field per timed
    # stage; [bench_delta] reads the printed line
    phase("breakdown", card, slice_traces=len(ps.ws), bucket=ps.b,
          mode=ps.mode, candidates_ms_by_arm=cand_arm_ms,
          calibration_ms_by_arm_128x64={PLAN_ARMS[lab.split("@")[0]]: v
                                        for lab, v in cand_ms.items()},
          fastest_here=min(cand_arm_ms, key=cand_arm_ms.get),
          **{f"{k}_ms": v for k, v in stage_ms.items()},
          device_busy_share=busy_us / wall_us if busy_us else None,
          device_kernel_launches=sum(e.count for e in kernels_run),
          top_device_ms={e.key[:60]: e.self_device_time_total / 1e3
                         for e in top[:5]})


def viterbi_work(cands, bpts, bval, tables, interp, breakage):
    """What one decode of these inputs must do and move: the lattice pairs
    whose reach row is looked up (an active point with an earlier active
    one within the breakage distance, a valid candidate with an edge at
    both ends), its operations (each pair's lookup, a binary search of
    its sorted reach row: ceil(log2(M + 1)) probes, plus its route, cost
    and argmin step), its bytes and, beside them, the operations a linear
    scan of the M entries a pair would count (the bound stated before the
    rows were searched). The bytes: the candidates, points and valid
    flags read once, the five [B, T] outputs written once, and of the
    tables only what the searches need: reach_row and edge_len of each
    distinct looked-up previous edge, each distinct reach_to entry that
    the binary searches of the distinct (row, edge) lookups probe (the
    kernel's search, replayed here), and one reach_dist entry per
    distinct hit. → (pairs, ops, bytes, scan ops)."""
    from reporter_tpu_torch.ops import hmm
    from reporter_tpu_torch.ops.dense_candidates import sqrt_f32

    B, T, K = cands.edge.shape
    keep = hmm._keep_mask_batched(bpts.permute(1, 2, 0), bval.T, interp).T
    active = keep & cands.valid.any(-1)
    idx = torch.arange(T, device=bpts.device).expand(B, T)
    run = torch.cummax(torch.where(active, idx, -1), dim=1).values
    prev = torch.cat([idx[:, :1] * 0, run[:, :-1].clamp_min(0)], 1)
    has_prev = torch.cat([active[:, :1] & False, run[:, :-1] >= 0], 1)
    prev_pts = torch.gather(bpts, 1, prev[..., None].expand(B, T, 2))
    gc = sqrt_f32(((bpts - prev_pts) ** 2).sum(-1))
    look = active & has_prev & (gc <= breakage)
    ok = cands.valid & (cands.edge >= 0)
    to, row_of = tables["reach_to"], tables["reach_row"]
    M, E = to.shape[1], row_of.shape[0]
    # the looked-up pairs, 64 traces at a time: distinct previous edges
    # and distinct (row, next edge) lookups
    pairs, firsts, lookups = 0, [], []
    for b0 in range(0, B, 64):
        sl = slice(b0, b0 + 64)
        at = prev[sl, :, None].expand(-1, -1, K)
        e1 = torch.gather(cands.edge[sl], 1, at).long()
        ok1 = torch.gather(ok[sl], 1, at) & look[sl, :, None]
        sel = ok1[..., :, None] & ok[sl][..., None, :]
        pairs += int(sel.sum())
        first = e1[..., :, None].expand(sel.shape)[sel]
        nxt = cands.edge[sl].long()[..., None, :].expand(sel.shape)[sel]
        firsts.append(torch.unique(first))
        lookups.append(torch.unique(row_of[first].long() * E + nxt))
    firsts = torch.unique(torch.cat(firsts))
    lookups = torch.unique(torch.cat(lookups))
    row, key = lookups // E, lookups % E
    # the kernel's binary search: halving steps from the largest power
    # of two <= M, -1 read past every id, each probe < M read
    pos = torch.full_like(row, -1)
    hit = torch.full_like(row, -1)
    probed = []
    step = 1 << (M.bit_length() - 1)
    while step:
        at = pos + step
        inside = at < M
        v = to[row, at.clamp(max=M - 1)].long()
        v = torch.where(v < 0, 1 << 32, v)
        probed.append(torch.unique((row * M + at)[inside]))
        hit = torch.where(inside & (v == key), at, hit)
        pos = torch.where(inside & (v < key), at, pos)
        step >>= 1
    n_probed = int(torch.unique(torch.cat(probed)).numel())
    n_hits = int(torch.unique((row * M + hit)[hit >= 0]).numel())
    probes = M.bit_length()                    # ceil(log2(M + 1))
    ops = pairs * (probes * VITERBI_OPS_PER_LOOKUP + VITERBI_OPS_PER_PAIR)
    scan_ops = pairs * (M * VITERBI_OPS_PER_LOOKUP + VITERBI_OPS_PER_PAIR)
    nbytes = (sum(x.numel() * x.element_size() for x in cands)
              + bpts.numel() * 4 + bval.numel()
              + firsts.numel() * (row_of.element_size()
                                  + tables["edge_len"].element_size())
              + n_probed * to.element_size()
              + n_hits * tables["reach_dist"].element_size()
              + B * T * (4 + 4 + 4 + 1 + 1))
    return pairs, ops, nbytes, scan_ops


def viterbi_phase(card, m, traces):
    """[kernel:viterbi]: the batched Viterbi kernel (kernels/viterbi.cu)
    against its plain version on the card, on the first wire slice of the
    1024 sf traces (first_slice), at each (K, radius) of VITERBI_CASES:
    mismatches per field (all must be 0), the kernel's times (single,
    back to back), the plain version's, the bound and the phase's
    seconds. → {K: record} for the kernels line."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.ops import hmm
    from reporter_tpu_torch.ops import match as match_ops

    ps, bpts, bval = first_slice(m, traces)
    out = {}
    for k, radius in VITERBI_CASES:
        t_k = time.perf_counter()
        levers = {} if radius is None else {"search_radius": radius}
        p = MatcherParams(sweep_autotune=False, max_candidates=k, **levers)
        cands = match_ops.batch_candidates(bpts, bval, m.tables, p)
        args = (cands, bpts, bval, m.tables, p.sigma_z, p.beta,
                p.max_route_distance_factor, p.breakage_distance,
                p.backward_slack, p.interpolation_distance)
        got = hmm.viterbi_decode_batched(*args)
        want = hmm._viterbi_plain(*args)
        torch.cuda.synchronize()
        mism = {f: int((getattr(got, f) != getattr(want, f)).sum())
                for f in got._fields}
        err = max(float((getattr(got, f).double()
                         - getattr(want, f).double()).abs().max())
                  for f in got._fields)
        ms = cuda_ms(lambda: hmm.viterbi_decode_batched(*args), reps=20)
        b2b = launch_ms(lambda: hmm.viterbi_decode_batched(*args))
        plain_ms = cuda_ms(lambda: hmm._viterbi_plain(*args), reps=2,
                           warmup=1)
        pairs, ops, nbytes, scan_ops = viterbi_work(
            cands, bpts, bval, m.tables, p.interpolation_distance,
            p.breakage_distance)
        plan = hmm.viterbi_plan(*cands.edge.shape)
        by_ops = ops / H100_F32_FLOPS * 1e3
        by_bytes = nbytes / H100_HBM_BYTES_S * 1e3
        rec = dict(ms=ms, ms_back_to_back=b2b, plain_ms=plain_ms,
                   bound_ms=max(by_ops, by_bytes),
                   bound_by="operations" if by_ops >= by_bytes else "bytes",
                   library_ms=None, max_abs_err=err,
                   search_radius=p.search_radius,
                   mismatches=sum(mism.values()), kernel=plan["kernel"],
                   instance=plan["instance"])
        phase("kernel:viterbi", card, metro="sf", k=k,
              search_radius=p.search_radius, traces=int(bpts.shape[0]),
              points=int(bval.numel()),
              choice_mismatches=mism["choice"],
              edge_mismatches=mism["edge"],
              offset_mismatches=mism["offset"],
              chain_start_mismatches=mism["chain_start"],
              matched_mismatches=mism["matched"], max_abs_err=err, ms=ms,
              ms_back_to_back=b2b,
              plain_ms=plain_ms, bound_ms=rec["bound_ms"],
              bound_by=rec["bound_by"], library_ms=None,
              lattice_pairs=pairs, operations=ops, bytes=nbytes,
              linear_scan_operations=scan_ops,
              linear_scan_bound_ms=max(scan_ops / H100_F32_FLOPS * 1e3,
                                       by_bytes),
              traces_per_cta=plan["traces_per_cta"],
              threads_per_trace=plan["threads_per_trace"],
              chunk=plan["chunk"], smem_bytes=plan["smem_bytes"],
              levels=plan["levels"], seconds=time.perf_counter() - t_k)
        if any(mism.values()) or err:
            raise SystemExit(f"the Viterbi kernel differs from its plain "
                             f"version at K={k}: {mism}")
        if not got.matched.any():
            raise SystemExit(f"the Viterbi kernel matched nothing at K={k}")
        out[k] = rec
    return out


def _plain_sliced(args, n):
    """hmm._viterbi_plain over the batch of ``args`` in slices of n traces
    (each trace decodes alone, so the slices' fields joined are the whole
    batch's): the plain version's [K, K, B, M] steps within the card's
    memory at wide K."""
    from reporter_tpu_torch.ops import hmm
    from reporter_tpu_torch.ops import match as match_ops

    cands, bpts, bval, *rest = args
    parts = [hmm._viterbi_plain(
        match_ops.CandidateSet(*(x[i:i + n] for x in cands)), bpts[i:i + n],
        bval[i:i + n], *rest) for i in range(0, bpts.shape[0], n)]
    return hmm.ViterbiResult(*(torch.cat(f) for f in zip(*parts)))


def wide_decode_phase(card, ts, traces, win):
    """[wide:decode]: the card past K = 64, where the JAX package serves
    any K. For each (K, radius) of WIDE_DECODE_CASES (the Viterbi's wide
    instance 1 at K = 96 and 128, instance 2 at 256; at LONG_LIST_RADIUS
    the longest list must be over 64): a matcher at that K and radius
    serves the 1024 traces through match_many in a main-path window
    (``sf:k<K>``, ``sf:k<K>@250m``: the Viterbi launched at K), its first
    WIDE_CPU_TRACES records equal a CPU matcher's; the kernel against
    its plain version (in slices of WIDE_PLAIN_SLICE traces, one run,
    timed) on the whole first wire slice: mismatches per field (all must
    be 0), ms, back to back, the plain version's ms, the bound
    (viterbi_work), the plan, the longest list, the seconds. Then
    match_topk at WIDE_TOPK_K on the TOPK_LONG_POINTS-point probe,
    terminal (R = 1) and exact (R = K), in a main-path window
    (``sf:topk96``: the keep mask, the forward's wide instance and the
    backtrack's ring and levels read in place), each equal to a CPU
    matcher's (paths and offsets exact, scores within TOPK_SCORE_RTOL, as
    [topk] holds them), with its ms. → {K: the WIDE_RADIUS record, that
    at LONG_LIST_RADIUS under "long_lists"} for the kernels line's
    Viterbi entries."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
    from reporter_tpu_torch.netgen.traces import synthesize_probe
    from reporter_tpu_torch.ops import hmm
    from reporter_tpu_torch.ops import match as match_ops

    t_all = time.perf_counter()
    out = {}
    for k, radius in WIDE_DECODE_CASES:
        t_k = time.perf_counter()
        path = f"sf:k{k}" if radius == WIDE_RADIUS \
            else f"sf:k{k}@{radius:g}m"
        p = MatcherParams(sweep_autotune=False, max_candidates=k,
                          search_radius=radius)
        mk = SegmentMatcher(ts, p)
        mk.match_many(traces[:WIDE_CPU_TRACES])      # the build, a warm-up
        t0 = time.perf_counter()
        recs, _ = win.run(path, lambda: mk.match_many(traces))
        batch_s = time.perf_counter() - t0
        launched = win.viterbi_by_path[path].get(k, 0)
        cpu = SegmentMatcher(ts, p, device="cpu").match_many(
            traces[:WIDE_CPU_TRACES])
        cpu_equal = json_records(cpu) == json_records(
            recs[:WIDE_CPU_TRACES])
        _, bpts, bval = first_slice(mk, traces)
        cands = match_ops.batch_candidates(bpts, bval, mk.tables, p)
        longest = int(cands.valid.sum(-1).max())
        args = (cands, bpts, bval, mk.tables, p.sigma_z, p.beta,
                p.max_route_distance_factor, p.breakage_distance,
                p.backward_slack, p.interpolation_distance)
        got = hmm.viterbi_decode_batched(*args)
        plain = []
        plain_ms = cuda_ms(lambda: plain.append(
            _plain_sliced(args, WIDE_PLAIN_SLICE)), reps=1, warmup=0)
        want = plain[0]
        torch.cuda.synchronize()
        mism = {f: int((getattr(got, f) != getattr(want, f)).sum())
                for f in got._fields}
        err = max(float((getattr(got, f).double()
                         - getattr(want, f).double()).abs().max())
                  for f in got._fields)
        ms = cuda_ms(lambda: hmm.viterbi_decode_batched(*args), reps=10)
        b2b = launch_ms(lambda: hmm.viterbi_decode_batched(*args))
        pairs, ops, nbytes, _ = viterbi_work(
            cands, bpts, bval, mk.tables, p.interpolation_distance,
            p.breakage_distance)
        bound_ms, bound_by = _bound(ops, nbytes)
        plan = hmm.viterbi_plan(*cands.edge.shape)
        rec = dict(ms=ms, ms_back_to_back=b2b, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                   max_abs_err=err, search_radius=radius,
                   mismatches=sum(mism.values()),
                   instance=plan["instance"], kernel=plan["kernel"],
                   chunk=plan["chunk"], pairs=plan["pairs"],
                   traces=int(bpts.shape[0]), longest_list=longest)
        phase("wide:decode", card, metro="sf", k=k,
              search_radius=radius, traces=int(bpts.shape[0]),
              points=int(bval.numel()),
              choice_mismatches=mism["choice"],
              edge_mismatches=mism["edge"],
              offset_mismatches=mism["offset"],
              chain_start_mismatches=mism["chain_start"],
              matched_mismatches=mism["matched"], max_abs_err=err, ms=ms,
              ms_back_to_back=b2b, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, library_ms=None, lattice_pairs=pairs,
              operations=ops, bytes=nbytes, plan=plan,
              longest_list=longest, batch_traces=len(traces),
              batch_seconds=batch_s, viterbi_launches=launched,
              cpu_records_equal=cpu_equal, cpu_traces=WIDE_CPU_TRACES,
              seconds=time.perf_counter() - t_k)
        if any(mism.values()) or err:
            raise SystemExit(f"[wide:decode] the Viterbi's wide instance "
                             f"differs from its plain version at K={k}: "
                             f"{mism}")
        if launched < 1 or not cpu_equal:
            raise SystemExit(f"[wide:decode] K={k}: the Viterbi launched "
                             f"{launched} times in match_many, records "
                             f"equal to the CPU's: {cpu_equal}")
        if not got.matched.any():
            raise SystemExit(f"[wide:decode] nothing matched at K={k}")
        if radius == LONG_LIST_RADIUS and longest <= 64:
            raise SystemExit(f"[wide:decode] K={k} at {radius:g} m: the "
                             f"longest list is {longest}, not past 64")
        if radius == WIDE_RADIUS:
            out[k] = rec
        else:
            out[k]["long_lists"] = rec
    # ranked paths at WIDE_TOPK_K on the 1024-point probe
    t_k = time.perf_counter()
    p = MatcherParams(sweep_autotune=False, max_candidates=WIDE_TOPK_K,
                      search_radius=WIDE_RADIUS)
    mk = SegmentMatcher(ts, p)
    pr = synthesize_probe(ts, seed=7, num_points=TOPK_LONG_POINTS)
    long = Trace(uuid="probe", xy=pr.xy.astype(np.float32), times=pr.times)
    mk.match_topk(long)                              # the build, a warm-up
    walls = {}

    def both():
        res = {}
        for form, exact in (("terminal", False), ("exact", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[form] = mk.match_topk(long, exact=exact)
            walls[form] = (time.perf_counter() - t0) * 1e3
        return res

    card_out, _ = win.run(f"sf:topk{WIDE_TOPK_K}", both)
    lattice = win.lattice_by_path[f"sf:topk{WIDE_TOPK_K}"]
    cpu_m = SegmentMatcher(ts, p, device="cpu")
    equal = {}
    for form, exact in (("terminal", False), ("exact", True)):
        cpu = cpu_m.match_topk(long, exact=exact)
        got = card_out[form]
        equal[form] = bool(
            [[(q.edge, q.offset) for q in pts] for _, pts in cpu]
            == [[(q.edge, q.offset) for q in pts] for _, pts in got]
            and np.allclose([x for x, _ in got], [x for x, _ in cpu],
                            rtol=TOPK_SCORE_RTOL, atol=0))
    want = {"keep": 2, "forward:wide": 2, "backtrack": 1,
            "backtrack:global": 1}
    phase("wide:topk", card, metro="sf", k=WIDE_TOPK_K,
          search_radius=WIDE_RADIUS, points=TOPK_LONG_POINTS,
          plans={form: hmm.lattice_plan(TOPK_LONG_POINTS, WIDE_TOPK_K, r)
                 for form, r in (("terminal", 1), ("exact", WIDE_TOPK_K))},
          paths={form: len(v) for form, v in card_out.items()},
          ms={form: walls[form] for form in walls},
          lattice_launches=lattice, cpu_equal=equal,
          seconds=time.perf_counter() - t_k)
    if {key: lattice.get(key, 0) for key in want} != want \
            or not all(equal.values()):
        raise SystemExit(f"[wide:topk] K={WIDE_TOPK_K}: launches {lattice} "
                         f"(want {want}), equal to the CPU's: {equal}")
    phase("wide", card, seconds=time.perf_counter() - t_all)
    return out


def organic_phase(card, dc, build, win, MatcherParams, SegmentMatcher, Trace,
                  generate_city, compile_network, tables_from_numpy,
                  synthesize_fleet, radius):
    """The irregular metro at full width: compile, kernel phase, gates
    line, main phase, walk phase and card-vs-CPU records, tagged
    metro=organic. → ({arm: kernel record}, the tile)."""
    t0 = time.perf_counter()
    net = generate_city("organic")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts = compile_network(net)
    compile_s = time.perf_counter() - t0
    tab = tables_from_numpy(ts.arrays(), "cuda")
    phase("tiles", card, metro="organic", generate_s=gen_s,
          compile_s=compile_s, edges=ts.num_edges, nodes=net.num_nodes,
          line_segments=int(len(ts.seg_edge)),
          seg_pack_columns=int(tab["seg_pack"].shape[1]),
          blocks=int(tab["seg_bbox"].shape[0]),
          reach_truncated_nodes=ts.stats["reach_truncated_nodes"])
    tiles_native_phase(card, ts, "organic")
    grid_native_phase(card, ts, "organic")
    fleet = synthesize_fleet(ts, N_TRACES, num_points=N_POINTS, seed=0)
    pts = torch.from_numpy(fleet_points(fleet)).cuda()
    arms = kernel_phase(card, tab, pts, radius, 8, dc, build, "organic",
                        check_chunks=CHECK_CHUNKS, plain_reps=1)
    kernel_between_phase(card, tab, pts, radius, dc, "organic")
    phase("gates", card, metro="organic", arms={
        a: {key: r.get(key) for key in (
            "vote_share", "gate_share", "plain_gate_share",
            "gate_mismatches", "gate_mismatches_off_threshold",
            "gate_tolerance", "gate_first_group_share_of_voted")}
        for a, r in arms.items() if a not in ("block", "sub")},
        fastest_back_to_back=min(arms, key=lambda a:
                                 arms[a]["ms_back_to_back"]))
    m, traces, recs, fields, _ = main_phase(
        card, ts, fleet, dc, win, "organic", MatcherParams, SegmentMatcher,
        Trace, request=False)
    walk_phase(card, m, ts, traces, recs, fields, MatcherParams,
               SegmentMatcher, "organic")
    small = traces[:REFERENCE_TRACES]
    cpu_recs = SegmentMatcher(ts, device="cpu").match_many(small)
    cpu_ok = json_records(cpu_recs) == json_records(recs[:REFERENCE_TRACES])
    phase("reference", card, metro="organic", card_vs_cpu_records_equal=cpu_ok,
          traces_checked=len(small))
    if not cpu_ok:
        raise SystemExit("organic: the card's records differ from the CPU's")
    oracle_phase(card, ts, traces, recs, cpu_recs, "organic")
    return arms, ts


def wsgi_post(app, path, payload):
    """One POST through the WSGI callable itself. → (status, JSON)."""
    import io

    body = json.dumps(payload).encode()
    got = {}

    def start_response(status, headers):
        got["status"] = int(status.split()[0])

    data = b"".join(app({"REQUEST_METHOD": "POST", "PATH_INFO": path,
                         "CONTENT_LENGTH": str(len(body)),
                         "wsgi.input": io.BytesIO(body)}, start_response))
    return got["status"], json.loads(data)


def http_json(url, payload=None, timeout=120.0):
    """GET (payload None) or POST JSON over HTTP. → (status, JSON)."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"null")


class _Datastore(BaseHTTPRequestHandler):
    """The datastore: keeps every POSTed body."""

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        with self.server.lock:
            self.server.bodies.append(json.loads(body))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


def _sorted_reports(reports):
    return sorted(json.dumps(r, sort_keys=True) for r in reports)


def _pct(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(q * (len(v) - 1) + 0.5))]


def serve_phase(card, ts, fleet, dc, win, cache):
    """The report service in-process on the card, behind serve()'s threaded
    WSGI server, with a local datastore; the checks of the module
    docstring. → what [server] compares with: {"payloads": [...],
    "responses": [...]} of the first requests of SERVER_REQUESTS uuids."""
    from reporter_tpu_torch.config import Config, ServiceConfig
    from reporter_tpu_torch.service.app import make_app
    from reporter_tpu_torch.service.server import serve

    sink = ThreadingHTTPServer(("127.0.0.1", 0), _Datastore)
    sink.bodies, sink.lock = [], threading.Lock()
    threading.Thread(target=sink.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{sink.server_address[1]}/store"
    cfg = Config(service=ServiceConfig(datastore_url=url))
    os.environ["RTPU_AUTOTUNE_CACHE"] = os.path.join(cache, "serve")
    t0 = time.perf_counter()
    app, cal = win.run("sf:serve:calibration",
                       lambda: make_app(ts, cfg, device="cuda"))
    build_s = time.perf_counter() - t0
    p = app.matcher.params
    tuned = (dc.sweep_arm(p.sweep_subcull, p.sweep_lowp, p.sweep_mxu),
             p.max_candidates)
    server = serve(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    n_uuid = SERVE_CLIENTS * SERVE_UUIDS
    part = N_POINTS // SERVE_PARTS
    # requests[u][k]: uuid u's k-th request, its points in time order
    requests = [[{"uuid": f"veh-{u}", "trace": fleet[u].to_report_json()[
        "trace"][k * part:(k + 1) * part]} for k in range(SERVE_PARTS)]
        for u in range(n_uuid)]
    responses = [[None] * SERVE_PARTS for _ in range(n_uuid)]
    lat, statuses = [], []
    lock = threading.Lock()
    try:
        def lone():
            out, bodies = [], []
            for i in range(3):        # warm-up and the lone-request latency
                t = time.perf_counter()
                st, body = http_json(base + "/report", dict(
                    fleet[-1 - i].to_report_json(), uuid=f"lone-{i}"))
                out.append((time.perf_counter() - t) * 1e3)
                statuses.append(st)
                bodies.append(body)
            return out, bodies

        def client(c):
            for j in range(SERVE_UUIDS):
                u = c * SERVE_UUIDS + j
                for k in range(SERVE_PARTS):
                    t = time.perf_counter()
                    st, body = http_json(base + "/report", requests[u][k])
                    dt = time.perf_counter() - t
                    with lock:
                        lat.append(dt)
                        statuses.append(st)
                    responses[u][k] = body

        def traffic():
            t = time.perf_counter()
            with ThreadPoolExecutor(max_workers=SERVE_CLIENTS) as pool:
                list(pool.map(client, range(SERVE_CLIENTS)))
            clients_s = time.perf_counter() - t
            many = [dict(f.to_report_json(), uuid=f"many-{i}")
                    for i, f in enumerate(fleet[:SERVE_MANY])]
            t = time.perf_counter()
            st, body = http_json(base + "/report_many", {"traces": many})
            many_ms = (time.perf_counter() - t) * 1e3
            statuses.append(st)
            return clients_s, many, body, many_ms

        (lone_ms, lone_bodies), _ = win.run("sf:serve:lone", lone)
        stages0 = dict(app.matcher.stage_seconds)
        t = time.perf_counter()
        (clients_s, many, many_body, many_ms), counts = win.run(
            "sf:serve", traffic)
        wall_s = time.perf_counter() - t
        _, stats = http_json(base + "/stats")
        _, health = http_json(base + "/health")
        slo_status, slo_body = http_json(base + "/slo")
    finally:
        server.shutdown()
        server.server_close()
        app.close()
    sched = health["scheduler"]
    stage_ms = {k: (v - stages0[k]) * 1e3
                for k, v in app.matcher.stage_seconds.items()}
    n_real = n_uuid * SERVE_PARTS + SERVE_MANY + 3
    probes = n_uuid * N_POINTS + SERVE_MANY * N_POINTS + 3 * N_POINTS
    occ = (stats["sched_batch_occupancy_total"]
           / stats["sched_batch_occupancy_count"])
    phase("serve", card, metro="sf", tuned_instance=list(tuned),
          construct_s=build_s,
          calibration_launches={f"{a}@k{k}": n for (a, k), n in cal.items()
                                if n},
          lone_request_ms=lone_ms,
          requests=len(lat), clients=SERVE_CLIENTS,
          latency_ms_p50=_pct(lat, 0.50) * 1e3,
          latency_ms_p99=_pct(lat, 0.99) * 1e3,
          latency_ms_max=max(lat) * 1e3,
          clients_s=clients_s, report_many_traces=SERVE_MANY,
          report_many_ms=many_ms, traffic_s=wall_s,
          traces_per_s=(n_uuid * SERVE_PARTS + SERVE_MANY) / wall_s,
          probes_per_s=(n_uuid * N_POINTS + SERVE_MANY * N_POINTS) / wall_s,
          batches=sched["batches"], submissions=sched["submissions"],
          mean_occupancy=occ, padded_traces=sched["padded_traces"],
          padding_by_bucket=sched["padding_by_bucket"],
          deferred=sched["deferred"],
          max_inflight_seen=sched["max_inflight_seen"],
          inflight_hist=sched["inflight_hist"],
          stats_traces=stats["traces"], stats_probes=stats["probes"],
          points_sent=probes, match_s_total=stats["match_seconds_total"],
          match_s_over_traffic_s=stats["match_seconds_total"] / wall_s,
          queue_age_ms_p50=stats["sched_queue_age_seconds_p50"] * 1e3,
          stage_ms=stage_ms,
          launches={f"{a}@k{k}": n for (a, k), n in counts.items() if n},
          slo_status=slo_status, slo_active=slo_body.get("active"),
          slo_ticks=slo_body.get("ticks"), health_slo=health.get("slo"),
          health_link=health.get("link"))
    # ---- the checks ----
    if slo_status != 200 or "slos" not in slo_body or "slo" not in health:
        raise SystemExit("[serve] GET /slo did not answer 200 with the SLO "
                         "status, or /health lacks its slo block")
    link = health.get("link") or {}
    if link.get("mood") not in ("healthy", "degraded") \
            or link.get("rtt_ms") is None or link.get("mbps") is None \
            or link.get("probe_duty_pct") is None:
        raise SystemExit(f"[serve] /health's link block {link}")
    if any(st != 200 for st in statuses):
        raise SystemExit(f"[serve] non-200 responses: "
                         f"{sorted(set(statuses))}")
    # probes count the merged traces (the cache's tails matched again),
    # so only the trace count must equal what was sent
    if stats["traces"] != n_real:
        raise SystemExit(f"[serve] /stats counts {stats['traces']} traces; "
                         f"{n_real} were sent")
    only(counts, tuned, "[serve]: the served window")
    served = _sorted_reports(
        [r for row in responses for body in row for r in body["reports"]]
        + [r for body in many_body["results"] for r in body["reports"]]
        + [r for body in lone_bodies for r in body["reports"]])
    sunk = _sorted_reports(r for b in sink.bodies for r in b["reports"])
    sink.shutdown()
    sink.server_close()
    # the CPU app, fed the first uuids in the same per-uuid order
    cpu_bodies = []
    cpu = make_app(ts, Config(service=ServiceConfig(datastore_url=url)),
                   transport=lambda u, b: cpu_bodies.append(json.loads(b))
                   or 200, device="cpu")
    cpu_resp = [cpu.report_many([requests[u][k]
                                 for u in range(SERVE_CPU_UUIDS)])
                for k in range(SERVE_PARTS)]
    cpu.close()
    card_first = [responses[u][k] for k in range(SERVE_PARTS)
                  for u in range(SERVE_CPU_UUIDS)]
    same_resp = [r for batch in cpu_resp for r in batch] == card_first
    cpu_reports = _sorted_reports(r for b in cpu_bodies for r in b["reports"])
    card_reports = _sorted_reports(r for body in card_first
                                   for r in body["reports"])
    # the datastore got exactly the reports the responses hold, so the
    # first uuids' reports there are card_reports
    phase("serve:check", card, metro="sf", cpu_uuids=SERVE_CPU_UUIDS,
          cpu_requests=SERVE_CPU_UUIDS * SERVE_PARTS,
          card_vs_cpu_responses_equal=same_resp,
          card_vs_cpu_datastore_reports_equal=cpu_reports == card_reports,
          datastore_equals_responses=sunk == served,
          reports_served=len(served), reports_at_datastore=len(sunk),
          first_uuids_reports=len(card_reports))
    if not (same_resp and cpu_reports == card_reports and sunk == served
            and card_reports):
        raise SystemExit("[serve] the card's responses or datastore reports "
                         "differ from the CPU app's, or the datastore's from "
                         "the responses")
    return {"payloads": [requests[u][0] for u in range(SERVER_REQUESTS)],
            "responses": [responses[u][0] for u in range(SERVER_REQUESTS)]}


def server_phase(card, served, cache):
    """python -m reporter_tpu_torch.service.server as a subprocess on a
    free port: /health within SERVER_START_S, SERVER_REQUESTS answers
    equal [serve]'s, SIGINT drains to exit code 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, RTPU_AUTOTUNE_CACHE=os.path.join(cache, "server"),
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    log_path = os.path.join(cache, "server.log")
    base = f"http://127.0.0.1:{port}"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "reporter_tpu_torch.service.server",
             "--host", "127.0.0.1", "--port", str(port)],
            stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            health, start_s = _await_health(proc, base, SERVER_START_S,
                                            log_path, "server")
            got = [http_json(base + "/report", p)
                   for p in served["payloads"]]
            equal = [st == 200 and body == want for (st, body), want
                     in zip(got, served["responses"])]
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ready = re.search(r"ready in ([0-9.]+) s", open(log_path).read())
    phase("server", card, start_to_health_s=start_s,
          server_ready_s=float(ready.group(1)) if ready else None,
          device=health.get("device"), backend=health.get("backend"),
          tile_hbm_bytes=health.get("tile_hbm_bytes"),
          requests=len(got), responses_equal_serve=all(equal),
          sigint_exit_code=rc,
          drained="draining scheduler" in open(log_path).read())
    if not all(equal) or rc != 0:
        raise SystemExit(f"[server] responses equal {equal}, exit code "
                         f"{rc}:\n" + _tail(log_path))


# ---- streaming: the feed, the datastore, the checks ------------------------


def stream_rounds(fleet):
    """The fleet as one firehose in STREAM_ROUNDS rounds: round k holds
    points k*STREAM_ROUND_POINTS .. (k+1)*STREAM_ROUND_POINTS - 1 of every
    vehicle as {uuid, lat, lon, time} records, round-robin over the
    vehicles (point-major, as the JAX tests' _records interleaves)."""
    rounds = []
    for k in range(STREAM_ROUNDS):
        recs = []
        for t in range(k * STREAM_ROUND_POINTS, (k + 1) * STREAM_ROUND_POINTS):
            for p in fleet:
                recs.append({"uuid": p.uuid, "lat": float(p.lonlat[t, 1]),
                             "lon": float(p.lonlat[t, 0]),
                             "time": float(p.times[t])})
        rounds.append(recs)
    return rounds


def _sink():
    """A local datastore (HTTP) on a free port. → (server, its URL)."""
    sink = ThreadingHTTPServer(("127.0.0.1", 0), _Datastore)
    sink.bodies, sink.lock = [], threading.Lock()
    threading.Thread(target=sink.serve_forever, daemon=True).start()
    return sink, f"http://127.0.0.1:{sink.server_address[1]}/store"


def _close_sink(sink):
    sink.shutdown()
    sink.server_close()


def _report_rows(bodies):
    """The report rows of datastore bodies (histogram flushes excluded)."""
    return [r for b in bodies for r in b.get("reports", ())]


def _capture(bodies):
    """A publisher transport that keeps each POSTed body."""
    return lambda url, body: bodies.append(json.loads(body)) or 200


def _covers(have, want):
    """The multiset ``have`` holds every element of ``want``."""
    from collections import Counter

    return not (Counter(want) - Counter(have))


def _ends(q):
    return [q.end_offset(p) for p in range(q.num_partitions)]


def _settle(pipe):
    """Wait for the columnar pipeline's in-flight waves to finish their
    match (the next step harvests them): a round then meets the same
    flush points as the sequential pipelines, whatever the card's speed."""
    for w in list(getattr(pipe, "_inflight", ())):
        w.future.result()


def _wave_buckets(pipe, new_points):
    """{bucket: traces} of the wave a columnar pipeline's next step
    flushes in this feed, where every vehicle gets ``new_points`` per
    round: each ripe vehicle's merged trace is its buffered points, the
    round's and its cached tail; match_many runs one wire entry per
    bucket."""
    from reporter_tpu_torch.matcher.api import _bucket_len

    out = {}
    for c in np.nonzero(pipe._count + new_points >= pipe._wave_points)[0]:
        e = pipe.cache._entries.get(pipe._uuid_of[c])
        n = int(pipe._count[c]) + new_points + (0 if e is None
                                                 else len(e.time))
        out[_bucket_len(n)] = out.get(_bucket_len(n), 0) + 1
    return dict(sorted(out.items()))


def stream_feed(pipe, rounds, append, tag, settle=False, on_round=None,
                buckets=False):
    """Append each round to the pipeline's queue and step once; the step
    must consume the whole round. Then drain. → fields: per-step and
    drain walls (ms), the steps whose flush completed, the worker's
    seconds (steps + drain) and the producer's (appends)."""
    q = pipe.queue
    batches = (lambda: pipe.app.stats["batches"]) if hasattr(pipe, "app") \
        else (lambda: pipe.stats_counters["batches"])
    step_ms, settle_ms, flush_steps, inflight, waves = [], [], [], [], []
    append_s = 0.0
    for k, recs in enumerate(rounds):
        if buckets:
            waves.append(_wave_buckets(pipe, STREAM_ROUND_POINTS))
        t = time.perf_counter()
        append(q, recs)
        append_s += time.perf_counter() - t
        if settle:
            t = time.perf_counter()
            _settle(pipe)
            settle_ms.append((time.perf_counter() - t) * 1e3)
        before = batches()
        t = time.perf_counter()
        pipe.step()
        step_ms.append((time.perf_counter() - t) * 1e3)
        if pipe._consumed != _ends(q):
            raise SystemExit(f"[{tag}] round {k}: the step consumed "
                             f"{pipe._consumed}, the queue ends at {_ends(q)}")
        if batches() > before:
            flush_steps.append(k)
        elif buckets:
            waves.pop()                  # no wave this round
        inflight.append(len(getattr(pipe, "_inflight", ())))
        if on_round is not None:
            on_round(k)
    t = time.perf_counter()
    pipe.drain()
    drain_ms = (time.perf_counter() - t) * 1e3
    # the worker's time: its steps, the waits for its own in-flight waves
    # and the drain; the producer's appends are apart
    return {"step_ms": step_ms, "settle_ms": settle_ms, "drain_ms": drain_ms,
            "flush_steps": flush_steps, "inflight_after_step": inflight,
            "wave_buckets": waves,
            "worker_s": (sum(step_ms) + sum(settle_ms) + drain_ms) / 1e3,
            "append_s": append_s}


def _stream_fields(pipe, feed, n_records, bodies):
    st = pipe.stats()
    flush_ms = [feed["step_ms"][k] for k in feed["flush_steps"]]
    return {"steps": st["steps"], "flushes": len(feed["flush_steps"]),
            "records": n_records,
            "records_per_s": n_records / feed["worker_s"],
            "worker_s": feed["worker_s"], "producer_append_s":
            feed["append_s"], "step_ms": feed["step_ms"],
            "settle_ms": feed["settle_ms"],
            "flush_step_ms_p50": (statistics.median(flush_ms)
                                  if flush_ms else None),
            "flush_step_ms_max": max(flush_ms) if flush_ms else None,
            "drain_ms": feed["drain_ms"],
            "reports_published": len(_report_rows(bodies)),
            "hist_rows": st["hist_rows"], "qhist_rows": st["qhist_rows"],
            "lag": st["lag"], "malformed": st["malformed"]}


def _check_drained(pipe, tag):
    st = pipe.stats()
    if st["lag"] != 0 or pipe.committed != _ends(pipe.queue) \
            or st["malformed"] != 0:
        raise SystemExit(f"[{tag}] lag {st['lag']}, committed "
                         f"{pipe.committed} against ends {_ends(pipe.queue)}, "
                         f"malformed {st['malformed']}")


def _launches(counts):
    return {f"{a}@k{k}": n for (a, k), n in counts.items() if n}


def stream_phase(card, ts, fleet, dc, win, cache, device="cuda"):
    """[stream]: the dict StreamPipeline on the card over IngestQueue, fed
    the rounds, checkpointed after round STREAM_CHECKPOINT_ROUND; its
    first STREAM_CPU_UUIDS uuids' reports against a CPU pipeline's. → what
    the later phases compare with."""
    from reporter_tpu_torch.config import Config, ServiceConfig
    from reporter_tpu_torch.streaming import StreamPipeline

    rounds = stream_rounds(fleet)
    n_records = sum(len(r) for r in rounds)
    os.environ["RTPU_AUTOTUNE_CACHE"] = os.path.join(cache, "stream")
    sink, url = _sink()
    cfg = Config(service=ServiceConfig(datastore_url=url))
    t0 = time.perf_counter()
    pipe, cal = win.run("sf:stream:calibration",
                        lambda: StreamPipeline(ts, cfg, device=device))
    construct_s = time.perf_counter() - t0
    m = pipe.app.matcher
    p = m.params
    tuned = (dc.sweep_arm(p.sweep_subcull, p.sweep_lowp, p.sweep_mxu),
             p.max_candidates)
    ck_dict = os.path.join(cache, "stream_dict_ckpt.npz")

    def on_round(k):
        if k == STREAM_CHECKPOINT_ROUND - 1:
            pipe.checkpoint(ck_dict)

    stages0 = dict(m.stage_seconds)
    feed, counts = win.run("sf:stream", lambda: stream_feed(
        pipe, rounds, lambda q, recs: q.append_many(recs), "stream",
        on_round=on_round))
    stage_ms = {k: (v - stages0[k]) * 1e3 for k, v in m.stage_seconds.items()}
    _check_drained(pipe, "stream")
    with sink.lock:
        bodies = list(sink.bodies)
    _close_sink(sink)
    reports = _sorted_reports(_report_rows(bodies))
    hist, qhist = pipe.hist.snapshot(), pipe.qhist.snapshot()
    # lint: allow[bench-coverage] 2026-10-18 _stream_fields' keys;
    # [bench_delta] reads the printed line
    phase("stream", card, metro="sf", device=device,
          tuned_instance=list(tuned), construct_s=construct_s,
          calibration_launches=_launches(cal),
          **_stream_fields(pipe, feed, n_records, bodies),
          matcher_stage_ms=stage_ms, launches=_launches(counts))
    only(counts, tuned, "[stream]: the stream window")

    # the first uuids through a CPU pipeline and a card pipeline of their
    # own: a uuid flushes at the same points whatever else is in the
    # stream, and decodes alone, so the three agree
    first = {f.uuid for f in fleet[:STREAM_CPU_UUIDS]}
    small = [[r for r in recs if r["uuid"] in first] for recs in rounds]
    got = {}
    for dev in ("cpu", device):
        cap = []
        sp = StreamPipeline(ts, Config(service=ServiceConfig(
            datastore_url="http://datastore.local/")),
            transport=_capture(cap), device=dev)
        (_, small_counts) = win.run(
            f"sf:stream:first_{dev}", lambda: stream_feed(
                sp, small, lambda q, recs: q.append_many(recs),
                f"stream:{dev}"))
        _check_drained(sp, f"stream:{dev}")
        got[dev] = _sorted_reports(_report_rows(cap))
    same = got["cpu"] == got[device]
    covered = _covers(reports, got["cpu"])
    phase("stream:check", card, cpu_uuids=STREAM_CPU_UUIDS,
          first_uuids_reports=len(got["cpu"]),
          card_vs_cpu_reports_equal=same,
          full_run_holds_first_uuids_reports=covered,
          first_uuids_launches=_launches(small_counts))
    if not (same and covered and got["cpu"]):
        raise SystemExit("[stream] the first uuids' reports differ between "
                         "the card and the CPU, or the full run lacks them")
    return {"rounds": rounds, "reports": reports, "hist": hist,
            "qhist": qhist, "ck_dict": ck_dict, "tuned": tuned,
            "launches": dict(counts),
            "records_per_s": n_records / feed["worker_s"]}


def _wave_split(tracing, wave_ids):
    """Per-wave ms of the columnar pipeline's stage spans."""
    out = {name: [] for name in ("prepare", "device_match", "report_build",
                                 "publish")}
    for s in tracing.tracer().snapshot():
        if s.name in out and s.wave in wave_ids:
            out[s.name].append((s.t1 - s.t0) * 1e3)
    return out


def stream_columnar_phase(card, ts, dc, win, ref, device="cuda"):
    """[stream:columnar]: ColumnarStreamPipeline on the card over
    ColumnarIngestQueue, the same rounds as ProbeColumns, at pipeline
    depth 1 and 0; reports and both histograms equal [stream]'s."""
    from reporter_tpu_torch.config import (Config, ServiceConfig,
                                           StreamingConfig)
    from reporter_tpu_torch.streaming import (ColumnarStreamPipeline,
                                              pack_records)
    from reporter_tpu_torch.utils import tracing

    cols = [pack_records(recs) for recs in ref["rounds"]]
    n_records = sum(c.n for c in cols)
    ok = True
    launches = {}
    for depth in (1, 0):
        sink, url = _sink()
        # trace=True: the flight recorder keeps each wave's stage spans
        cfg = Config(service=ServiceConfig(datastore_url=url, trace=True),
                     streaming=StreamingConfig(pipeline_depth=depth))
        pipe = ColumnarStreamPipeline(ts, cfg, device=device)
        tracing.tracer().clear()
        m = pipe.matcher
        stages0 = dict(m.stage_seconds)
        feed, counts = win.run(f"sf:stream:columnar:d{depth}", lambda: (
            stream_feed(pipe, cols, lambda q, c: q.append_columns(c),
                        f"stream:columnar:d{depth}", settle=depth > 0,
                        buckets=depth == 0)))
        stage_ms = {k: (v - stages0[k]) * 1e3
                    for k, v in m.stage_seconds.items()}
        _check_drained(pipe, f"stream:columnar:d{depth}")
        split = _wave_split(tracing, set(range(1, pipe._wave_serial + 1)))
        pipe.close()
        with sink.lock:
            bodies = list(sink.bodies)
        _close_sink(sink)
        reports = _sorted_reports(_report_rows(bodies))
        same = reports == ref["reports"]
        hist_eq = np.array_equal(pipe.hist.snapshot(), ref["hist"])
        qhist_eq = np.array_equal(pipe.qhist.snapshot(), ref["qhist"])
        wave_ms = [a + b + c for a, b, c in zip(
            split["prepare"], split["device_match"], split["report_build"])]
        fields = _stream_fields(pipe, feed, n_records, bodies)
        fields.update(
            flush_wave_ms_p50=statistics.median(wave_ms) if wave_ms else None,
            flush_wave_ms_max=max(wave_ms) if wave_ms else None)
        launches[depth] = dict(counts)
        # lint: allow[bench-coverage] 2026-10-18 _stream_fields' keys;
        # [bench_delta] reads the printed line
        phase("stream:columnar", card, metro="sf", device=device,
              pipeline_depth=depth, **fields,
              waves=pipe.waves_completed,
              max_inflight_waves=max(feed["inflight_after_step"]),
              wave_buckets=feed["wave_buckets"] or None,
              wave_split_ms=split, matcher_stage_ms=stage_ms,
              reports_equal_stream=same, hist_equal_stream=hist_eq,
              qhist_equal_stream=qhist_eq, launches=_launches(counts))
        only(counts, ref["tuned"], f"[stream:columnar] depth {depth}")
        ok = ok and same and hist_eq and qhist_eq
    # the same waves launch the same sweeps, whichever thread matched them:
    # the launch counter is exact under the pipelined flush
    same_launches = launches[1] == launches[0] == ref["launches"]
    phase("stream:columnar:check", card, launches_equal_stream=same_launches)
    if not (ok and same_launches):
        raise SystemExit("[stream:columnar] reports, histograms or launch "
                         "counts differ from [stream]'s")
    return cols


def stream_recover_phase(card, ts, win, ref, cols, cache, device="cuda"):
    """[stream:recover]: checkpoint the columnar pipeline after round
    STREAM_CHECKPOINT_ROUND, run one more round, drop it, restore a fresh
    one on the same queue and finish; then the dict pipeline's checkpoint
    of that round restored into a columnar pipeline."""
    from reporter_tpu_torch.config import Config, ServiceConfig
    from reporter_tpu_torch.streaming import (ColumnarIngestQueue,
                                              ColumnarStreamPipeline)

    k_ck = STREAM_CHECKPOINT_ROUND
    app = lambda q, c: q.append_columns(c)     # noqa: E731
    sink, url = _sink()
    cfg = Config(service=ServiceConfig(datastore_url=url))
    ck = os.path.join(cache, "stream_col_ckpt.npz")

    def run():
        pipe = ColumnarStreamPipeline(ts, cfg, device=device)
        for k in range(k_ck):
            app(pipe.queue, cols[k])
            _settle(pipe)
            pipe.step()
        pipe.checkpoint(ck)
        with sink.lock:
            n_before = len(sink.bodies)
        at_ck = (pipe.hist.snapshot(), pipe.qhist.snapshot(),
                 list(pipe.committed))
        app(pipe.queue, cols[k_ck])      # one more round, then the "crash"
        _settle(pipe)
        pipe.step()
        pipe.close()                     # no drain: its tail is lost
        fresh = ColumnarStreamPipeline(ts, cfg, queue=pipe.queue,
                                       device=device)
        fresh.restore(ck)
        fresh.step()                     # replays the round after the cut
        if fresh._consumed != _ends(fresh.queue):
            raise SystemExit("[stream:recover] the restored pipeline did "
                             "not replay the round after the checkpoint")
        stream_feed(fresh, cols[k_ck + 1:], app, "stream:recover",
                    settle=True)
        _check_drained(fresh, "stream:recover")
        fresh.close()
        # the dict pipeline's checkpoint, into a columnar pipeline
        caps = []
        q3 = ColumnarIngestQueue()
        for k in range(k_ck + 1):
            app(q3, cols[k])
        cross = ColumnarStreamPipeline(
            ts, Config(service=ServiceConfig(
                datastore_url="http://datastore.local/")),
            queue=q3, transport=_capture(caps), device=device)
        cross.restore(ref["ck_dict"])
        restored = (cross.hist.snapshot(), cross.qhist.snapshot(),
                    list(cross.committed))
        cross.step()
        stream_feed(cross, cols[k_ck + 1:], app, "stream:recover:cross",
                    settle=True)
        _check_drained(cross, "stream:recover:cross")
        cross.close()
        return (n_before, at_ck, fresh, restored, cross, caps)

    (n_before, at_ck, fresh, restored, cross, caps), counts = win.run(
        "sf:stream:recover", run)
    only(counts, ref["tuned"], "[stream:recover]")
    with sink.lock:
        bodies = list(sink.bodies)
    _close_sink(sink)
    before = _report_rows(bodies[:n_before])
    after = _report_rows(bodies[n_before:])
    got = _sorted_reports(before + after)
    covers = _covers(got, ref["reports"])
    cross_at_ck = all(np.array_equal(a, b) for a, b in
                      zip(restored[:2], at_ck[:2])) \
        and restored[2] == at_ck[2]
    cross_final = (np.array_equal(cross.hist.snapshot(), ref["hist"])
                   and np.array_equal(cross.qhist.snapshot(), ref["qhist"]))
    cross_after = _sorted_reports(_report_rows(caps)) == \
        _sorted_reports(after)
    phase("stream:recover", card, metro="sf", device=device,
          checkpoint_round=k_ck, reports_before=len(before),
          reports_after=len(after), uninterrupted_reports=len(ref["reports"]),
          cover_uninterrupted=covers,
          equal_uninterrupted=got == ref["reports"],
          restored_hist_equal_uninterrupted=(
              np.array_equal(fresh.hist.snapshot(), ref["hist"])
              and np.array_equal(fresh.qhist.snapshot(), ref["qhist"])),
          cross_restore_hist_equal_at_checkpoint=cross_at_ck,
          cross_restore_final_hist_equal=cross_final,
          cross_restore_reports_equal_after=cross_after,
          launches=_launches(counts))
    if not (covers and cross_at_ck and cross_final):
        raise SystemExit("[stream:recover] the recovered run misses reports "
                         "of the uninterrupted one, or the cross-restored "
                         "histograms differ")


def _worker(cmd, env, cwd):
    """Run a worker subprocess to its end (killed past
    STREAM_WORKER_TIMEOUT_S); the time from the spawn to its "ready" log
    line is ``ready_s``, the whole run ``wall_s``."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=cwd)
    out, err, ready = [], [], []

    def read_err():
        for ln in proc.stderr:
            err.append(ln)
            if not ready and "ready in" in ln:
                ready.append(time.perf_counter() - t0)

    readers = [threading.Thread(target=read_err),
               threading.Thread(target=lambda: out.append(proc.stdout.read()))]
    for th in readers:
        th.start()
    try:
        proc.wait(timeout=STREAM_WORKER_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for th in readers:
            th.join()
    proc.wall_s = time.perf_counter() - t0
    proc.ready_s = ready[0] if ready else None
    proc.stdout, proc.stderr = "".join(out), "".join(err)
    return proc


def stream_worker_phase(card, ts, win, ref, cols, cache, device="cuda"):
    """[stream:worker]: python -m reporter_tpu_torch.streaming as a
    subprocess over a pre-staged durable broker: the dict worker and the
    columnar one at pipeline depth 0, each held to an in-process pipeline
    of its kind over a copy of the same directory; then the columnar
    worker at its default depth 1, held to exit 0, lag 0 and every report
    published (its flush points depend on the match thread's speed, so no
    second run can be held to its reports)."""
    import shutil

    from reporter_tpu_torch.config import (Config, ServiceConfig,
                                           StreamingConfig)
    from reporter_tpu_torch.streaming import (ColumnarStreamPipeline,
                                              DurableColumnarIngestQueue,
                                              DurableIngestQueue,
                                              StreamPipeline)

    here = os.path.dirname(os.path.abspath(__file__))
    tiles = ts.save(os.path.join(cache, "sf_stream.npz"))
    brokers = {}
    for fmt in ("dict", "columnar"):
        path = os.path.join(cache, f"broker_{fmt}")
        t = time.perf_counter()
        if fmt == "dict":
            q = DurableIngestQueue(path)
            for recs in ref["rounds"]:
                q.append_many(recs)
        else:
            q = DurableColumnarIngestQueue(path)
            for c in cols:
                q.append_columns(c)
        brokers[fmt] = (path, _ends(q), time.perf_counter() - t)
        q.close()
        shutil.copytree(path, path + "_copy")
    depth0 = StreamingConfig(pipeline_depth=0)
    cfg_path = os.path.join(cache, "worker_depth0.json")
    with open(cfg_path, "w") as f:
        f.write(Config(streaming=depth0).to_json())
    ok, reports = True, {}
    for kind in ("dict", "columnar", "columnar:d1"):
        broker, ends, stage_s = brokers[kind.split(":")[0]]
        sink, url = _sink()
        cmd = [sys.executable, "-m", "reporter_tpu_torch.streaming",
               "--tiles", tiles, "--broker-dir", broker, "--checkpoint",
               os.path.join(cache, f"worker_{kind.replace(':', '_')}.ckpt"),
               "--exit-on-drain", "--device", device]
        if kind != "dict":
            cmd.append("--columnar")
        if kind in ("dict", "columnar"):
            cmd += ["--config", cfg_path]
        proc = _worker(cmd, dict(os.environ, DATASTORE_URL=url,
                                 PYTHONPATH=here), here)
        with sink.lock:
            bodies = list(sink.bodies)
        _close_sink(sink)
        lines = proc.stdout.strip().splitlines()
        try:
            exit_json = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            exit_json = None
        consumed = re.search(r"stepped ([0-9]+) times in ([0-9.]+) s",
                             proc.stderr)
        drained = re.search(r"drained in ([0-9.]+) s", proc.stderr)
        got = reports[kind] = _sorted_reports(_report_rows(bodies))
        good = (proc.returncode == 0 and exit_json is not None
                and exit_json.get("lag") == 0
                and exit_json.get("committed") == ends and bool(got)
                and exit_json.get("published") == len(got))
        fields = {}
        if kind == "columnar:d1":
            fields["reports_equal_depth0_worker"] = got == reports["columnar"]
        else:
            # the same kind of pipeline in-process over the copy: stepped
            # until it has consumed the log and flushes no more, drained
            cap = []
            pcfg = Config(service=ServiceConfig(
                datastore_url="http://datastore.local/"), streaming=depth0)
            if kind == "dict":
                qc = DurableIngestQueue(broker + "_copy")
                pipe = StreamPipeline(ts, pcfg, queue=qc,
                                      transport=_capture(cap), device=device)
            else:
                qc = DurableColumnarIngestQueue(broker + "_copy")
                pipe = ColumnarStreamPipeline(ts, pcfg, queue=qc,
                                              transport=_capture(cap),
                                              device=device)

            def pump():
                while True:
                    n = pipe.step()
                    if pipe._consumed == _ends(qc) and n == 0:
                        break
                pipe.drain()

            _, counts = win.run(f"sf:stream:worker:{kind}", pump)
            _check_drained(pipe, f"stream:worker:{kind}")
            close = getattr(pipe, "close", None)
            if close is not None:
                close()
            qc.close()
            want = _sorted_reports(_report_rows(cap))
            good = good and got == want
            fields.update(in_process_reports=len(want),
                          reports_equal_in_process=got == want,
                          in_process_launches=_launches(counts))
        phase("stream:worker", card, metro="sf", kind=kind, device=device,
              broker_stage_s=stage_s, exit_code=proc.returncode,
              wall_s=proc.wall_s, start_to_ready_s=proc.ready_s,
              step_loop_s=float(consumed.group(2)) if consumed else None,
              drain_s=float(drained.group(1)) if drained else None,
              exit=exit_json, end_offsets=ends,
              reports_at_datastore=len(got),
              hist_bodies=sum(1 for b in bodies if "histograms" in b),
              **fields)
        if not good:
            print(proc.stderr[-4000:], file=sys.stderr)
            ok = False
    if not ok:
        raise SystemExit("[stream:worker] a worker failed, did not drain, or "
                         "its reports differ from the in-process pipeline's")


# ---- the supervised topology: several workers on one card -----------------


def _sink_key(r):
    """The report key of the topology's datastore sinks (ReportSink's)."""
    return (r.get("id"), r.get("next_id"), round(float(r.get("t0", 0.0)), 2),
            round(float(r.get("t1", 0.0)), 2))


def _sink_keys(bodies):
    from collections import Counter

    return Counter(_sink_key(r) for b in bodies for r in b.get("reports", ()))


def _merged_hists(bodies):
    """Histogram deltas POSTed by any number of workers, summed per
    segment: (speed, queue), each {segment_id: counts}."""
    out = ({}, {})
    for b in bodies:
        for side, key in zip(out, ("histograms", "queue_histograms")):
            for h in b.get(key, ()):
                prev = side.get(h["segment_id"])
                side[h["segment_id"]] = (list(h["counts"]) if prev is None
                                         else [x + y for x, y in
                                               zip(prev, h["counts"])])
    return out


def _wait_for(pred, timeout, what):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise SystemExit(what)
        time.sleep(0.05)
    return time.monotonic() - t0


def _instances(counts):
    """An exit JSON's {"arm@kK": n} as {(arm, K): n} over every instance."""
    from reporter_tpu_torch.kernels.build import SWEEP_KS

    out = {(a, k): 0 for a in ARMS for k in SWEEP_KS}
    for key, n in (counts or {}).items():
        arm, k = key.rsplit("@k", 1)
        out[arm, int(k)] = n
    return out


def launched_only(rep, inst):
    """A worker's exit JSON shows launches of the kernel instance ``inst``
    (arm, K) since it was ready, and of no other."""
    return set(rep.get("launches") or ()) == {f"{inst[0]}@k{inst[1]}"}


def _plan_instance(label):
    """A plan label (``mxu+bf16@128``) → its kernel instance at K = 8."""
    return PLAN_ARMS[label.split("@")[0]], 8


class _CardSampler:
    """nvidia-smi polled beside a run (every TOPO_SAMPLE_S): the card's
    utilization (the share of the sample period in which a kernel ran)
    and its used memory, each stamped with the host's wall clock."""

    def __init__(self):
        self.samples, self._stop = [], threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=utilization.gpu,memory.used",
                 "--format=csv,noheader,nounits", "-i", "0"],
                capture_output=True, text=True, timeout=30).stdout
            util, mem = (float(x) for x in out.strip().split(","))
            self.samples.append((time.time(), util, mem))
            self._stop.wait(TOPO_SAMPLE_S)

    def __enter__(self):
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join(60)

    def window(self, t0, t1):
        s = [x for x in self.samples if t0 <= x[0] <= t1]
        return {"samples": len(s),
                "busy_share": (statistics.mean(x[1] for x in s) / 100.0
                               if s else None),
                "memory_used_mib_max": max((x[2] for x in s), default=None)}


def _topo_env(**extra):
    env = {"RTPU_TOPO_SNAPSHOT_INTERVAL_S": "0.3"}
    env.update(extra)
    return env


def _write_config(path, **streaming):
    from reporter_tpu_torch.config import Config, StreamingConfig

    with open(path, "w") as f:
        f.write(Config(streaming=StreamingConfig(**streaming)).to_json())
    return path


def topo_stage(card, ts, ref, cache, win, device="cuda"):
    """The topology's feed: [stream]'s rounds in a durable records broker
    under _chip_scratch/topo, every TOPO_STAMP_EVERY-th record stamped
    with a trace id under a ``produce`` span of the producer's own flight
    recorder (its ring dumped for [topo:trace]); the sf tile saved for
    the workers; and the uninterrupted reports (topo_reference over every
    partition). → the shared state of the [topo*] phases."""
    import shutil

    from reporter_tpu_torch.streaming import DurableIngestQueue
    from reporter_tpu_torch.utils import tracing

    root = os.path.join(SCRATCH, "topo")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "traces"))
    tiles = ts.save(os.path.join(root, "sf.npz"))
    broker = os.path.join(root, "broker")
    rec = tracing.FlightRecorder(capacity=65536).configure(enabled=True)
    t = time.perf_counter()
    q = DurableIngestQueue(broker)
    n = stamped = 0
    for recs in ref["rounds"]:
        for r in recs:
            if n % TOPO_STAMP_EVERY == 0:
                r = tracing.stamp_record(dict(r), f"{r['uuid']}@{n}")
                with rec.span("produce", trace_id=r[tracing.TRACE_KEY]["id"]):
                    q.append(r)
                stamped += 1
            else:
                q.append(r)
            n += 1
    ends = _ends(q)
    q.close()
    stage_s = time.perf_counter() - t
    producer_dump = os.path.join(root, "traces", "ring_producer.json")
    rec.dump(path=producer_dump, reason="producer_done")
    cfg = dict(poll_max_records=TOPO_POLL, flush_min_points=TOPO_FLUSH,
               hist_flush_interval=0.0, flush_max_age=1e6)
    cfg_path = _write_config(os.path.join(root, "topo.json"), **cfg)
    shutil.copytree(broker, broker + "_ref")
    st = {"root": root, "tiles": tiles, "broker": broker, "ends": ends,
          "records": n, "cfg": cfg, "cfg_path": cfg_path,
          "producer_dump": producer_dump,
          "warm_cache": os.path.join(cache, "stream"),
          "tuned": ref["tuned"], "device": device, "win": win, "ts": ts}
    st["uninterrupted"], ref_s = topo_reference(st, range(len(ends)))
    phase("topo:stage", card, metro="sf", records=n, stamped=stamped,
          end_offsets=ends, broker_stage_s=stage_s, config=cfg,
          reference_reports=sum(st["uninterrupted"].values()),
          reference_s=ref_s,
          reference_launches=_launches(win.by_path["sf:topo:reference"]))
    return st


def topo_reference(st, partitions):
    """The uninterrupted reports of ``partitions``: one in-process
    StreamPipeline owning them, over a copy of the broker, with the
    [topo] config, stepped until it has consumed them and flushes no
    more, then drained; its own launch window, only the tuned instance.
    → (report keys, seconds)."""
    from reporter_tpu_torch.config import (Config, ServiceConfig,
                                           StreamingConfig)
    from reporter_tpu_torch.streaming import (DurableIngestQueue,
                                              StreamPipeline)

    parts = sorted(partitions)
    os.environ["RTPU_AUTOTUNE_CACHE"] = st["warm_cache"]
    q = DurableIngestQueue(st["broker"] + "_ref")
    cap = []
    pipe = StreamPipeline(st["ts"], Config(
        service=ServiceConfig(datastore_url="http://datastore.local/"),
        streaming=StreamingConfig(**st["cfg"])), queue=q,
        transport=_capture(cap), partitions=parts, device=st["device"])

    def pump():
        while True:
            got = pipe.step()
            if [pipe._consumed[p] for p in parts] == \
                    [st["ends"][p] for p in parts] and got == 0:
                break
        pipe.drain()

    tag = "sf:topo:reference" + ("" if len(parts) == len(st["ends"]) else
                                 ":" + "".join(map(str, parts)))
    t = time.perf_counter()
    _, counts = st["win"].run(tag, pump)
    seconds = time.perf_counter() - t
    q.close()
    if [pipe.committed[p] for p in parts] != [st["ends"][p] for p in parts]:
        raise SystemExit(f"[topo] the reference over {parts} did not drain")
    only(counts, st["tuned"], f"[topo] the reference over {parts}")
    return _sink_keys(cap), seconds


def topo_phase(card, st):
    """[topo]: a Supervisor with two dict workers on partitions {0, 1} and
    {2, 3} (restart, max_restarts 2, snapshot spool, SLO plane at
    TOPO_SLO_SCALE, tracing on), its WSGI face and the port's ReportSink;
    worker-0 SIGKILLed once the sink has rows. The supervisor must see
    the death, restart worker-0 from its checkpoint, and the topology
    drain to lag 0; the sink's reports cover the uninterrupted ones; the
    merged registry is the per-leaf sum of the members' snapshots. Then
    [topo:trace] (the stitched trace) and [topo:slo] (the topology's burn
    against the members')."""
    from collections import Counter

    from reporter_tpu_torch.distributed import (Supervisor, aggregate,
                                                stitch, worker_member)
    from reporter_tpu_torch.obs import slo as slo_mod
    from reporter_tpu_torch.utils import tracing

    workdir = os.path.join(st["root"], "main")
    traces = os.path.join(st["root"], "traces")
    dumps = os.path.join(workdir, "dumps")
    members = [worker_member(f"worker-{i}", st["tiles"], st["broker"],
                             workdir, partitions=parts,
                             config=st["cfg_path"],
                             extra_args=["--device", st["device"]])
               for i, parts in enumerate(([0, 1], [2, 3]))]
    tr = tracing.tracer()
    saved = (tr.enabled, tr.dump_dir, tr.dumps_written,
             os.environ.get("RTPU_SLO_SCALE"))
    tr.configure(enabled=True, dump_dir=dumps)
    tr.dumps_written = 0
    os.environ["RTPU_SLO_SCALE"] = TOPO_SLO_SCALE   # the supervisor's own
    try:
        sup = Supervisor(members, workdir, restart=True, max_restarts=2,
                         poll_s=0.05, base_env=_topo_env(
                             RTPU_SLO_SCALE=TOPO_SLO_SCALE, RTPU_TRACE="1",
                             RTPU_TRACE_DIR=traces,
                             RTPU_AUTOTUNE_CACHE=st["warm_cache"]))
    finally:
        if saved[3] is None:
            del os.environ["RTPU_SLO_SCALE"]
        else:
            os.environ["RTPU_SLO_SCALE"] = saved[3]
    try:
        t_start = time.time()
        sup.start()
        port = sup.serve_http().server_address[1]
        ckpt = os.path.join(workdir, "worker-0.ckpt.npz")
        _wait_for(lambda: sup.sink.stats()["rows"] > 0
                  and os.path.exists(ckpt), TOPO_TIMEOUT_S,
                  "[topo] no report reached the sink, or worker-0 never "
                  "checkpointed")
        snap0 = sup.snapshots().get("worker-0") or {}
        t_kill = time.time()
        killed = sup.kill_member("worker-0")
        if killed is None:
            raise SystemExit("[topo] worker-0 had exited before the kill")
        rows_at_kill = sup.sink.stats()["rows"]
        with np.load(ckpt) as z:
            ck_committed = json.loads(bytes(z["state"]).decode())["committed"]

        def deaths():
            return [e for e in sup.events() if e["event"] == "member_death"
                    and e["member"] == "worker-0"]

        _wait_for(lambda: deaths(), 60, "[topo] the supervisor never saw "
                  "worker-0's death")
        detect_s = deaths()[0]["t"] - t_kill
        _wait_for(lambda: (sup.snapshots().get("worker-0") or {}).get("pid")
                  not in (None, killed), TOPO_TIMEOUT_S,
                  "[topo] the restarted worker-0 never spooled")
        recovery_s = time.time() - t_kill
        _wait_for(sup.drained, TOPO_TIMEOUT_S, "[topo] did not drain")
        time.sleep(2 * sup.poll_s)
        sup.poll_once()
        drained_at = time.time()
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=30).read())
        exposition = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=30).read().decode()
        slo_http = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/slo", timeout=30).read())
        reports = sup.exit_reports()
        events = sup.events()
        snaps = sup.snapshots()
        have = Counter(sup.sink.reports)
        sink_stats = sup.sink.stats()
        sup_export = sup.metrics.export()
        sup_slo = sup.slo.status() if sup.slo is not None else None
    finally:
        sup.stop()
        tr.configure(enabled=saved[0])
        tr.dump_dir = saved[1]
        tr.dumps_written = saved[2]
    ends = st["ends"]
    want = st["uninterrupted"]
    missing = want - have
    duplicates = sum((have - want).values())
    # the merged registry is the per-leaf sum of the members' snapshots
    merged = aggregate.merge_registry(snaps)
    want_c, want_h = Counter(), {}
    for doc in snaps.values():
        want_c.update({k: float(v) for k, v in
                       doc["metrics"]["counters"].items()})
        for k, b in doc["metrics"]["hist"].items():
            want_h[k] = [x + y for x, y in zip(want_h.get(k, [0] * len(b)),
                                                 b)]
    fidelity = (merged._counters == dict(want_c) and merged._hist == want_h)
    spawns = [e for e in events if e["event"] == "member_spawn"
              and e["member"] == "worker-0"]
    w0 = reports.get("worker-0") or {}
    post_mortems = sorted(n for n in os.listdir(dumps)
                          if "worker_death" in n) if os.path.isdir(dumps) \
        else []
    tuned = st["tuned"]
    for name, rep in reports.items():
        st["win"].by_path[f"sf:topo:{name}"] = _instances(rep.get("launches"))
    good = {
        "death_seen": sum(e["event"] == "member_death" for e in events) == 1,
        "restarted": [e["reason"] for e in spawns] == ["start", "restart"],
        "from_checkpoint": sum(ck_committed) > 0,
        "drained": all(rep is not None and rep["lag"] == 0
                       for rep in reports.values())
        and w0.get("committed", [])[:2] == ends[:2]
        and (reports.get("worker-1") or {}).get("committed", [])[2:]
        == ends[2:],
        "covers_uninterrupted": not missing and sum(want.values()) > 0,
        "merged_is_sum_of_snapshots": fidelity,
        "one_post_mortem_per_death": len(post_mortems) == 1,
        "slo_blocks": all(set(rep.get("slo") or ()) == {
            "active", "alerts_total", "ticks", "budget_remaining"}
            for rep in reports.values()),
        "only_tuned_instance": all(launched_only(rep, tuned)
                                   for rep in reports.values()),
        "exposition": "rtpu_topo_deaths" in exposition
        and "rtpu_probes" in exposition,
    }
    phase("topo", card, metro="sf", device=st["device"], workers=2,
          spawn_to_kill_s=t_kill - t_start, rows_at_kill=rows_at_kill,
          lag_at_kill=(snap0.get("stats") or {}).get("lag"),
          checkpoint_committed_at_kill=ck_committed,
          detect_s=detect_s, recovery_s=recovery_s,
          restart_to_ready_s=(w0.get("ready_unix_s", 0.0) - spawns[-1]["t"]
                              if len(spawns) > 1 else None),
          kill_to_drained_s=drained_at - t_kill,
          post_mortems=post_mortems, deaths=health["deaths_total"],
          restarts=health["restarts_total"],
          sink_rows=sink_stats["rows"], sink_posts=sink_stats["posts"],
          uninterrupted_reports=sum(want.values()),
          reports_missing=sum(missing.values()),
          duplicate_reports=duplicates,
          merged_counters=len(want_c),
          merged_buckets=sum(len(b) for b in want_h.values()),
          exits={n: {k: (r or {}).get(k) for k in (
              "steps", "reports", "committed", "lag", "plan", "launches")}
              for n, r in reports.items()}, checks=good)
    if not all(good.values()):
        raise SystemExit(f"[topo] a check failed: "
                         f"{[k for k, v in good.items() if not v]}")

    # [topo:trace]: the producer's ring and each worker's exit ring
    doc = stitch.stitch(
        {"producer": st["producer_dump"],
         **{f"worker-{i}": os.path.join(traces, f"ring_worker-{i}.json")
            for i in range(2)}},
        out_path=os.path.join(st["root"], "topology_trace.json"))
    s = doc["stitched"]
    rows = [e["args"]["name"] for e in doc["traceEvents"]
            if e.get("name") == "process_name"]
    dwell = [e for e in doc["traceEvents"] if e.get("name") == "broker_dwell"]
    flows = [e for e in doc["traceEvents"] if e.get("name") == "probe_path"]
    phase("topo:trace", card, processes=s["processes"],
          unsynced=s["unsynced_processes"], events=s["events"],
          traced_ids=s["traced_ids"], cross_pid_tracks=s["cross_pid_tracks"],
          process_rows=sorted(rows), flow_events=len(flows),
          broker_dwell_spans=len(dwell),
          broker_dwell_ms_p50=(statistics.median(e["dur"] for e in dwell)
                               / 1e3 if dwell else None))
    if not (s["processes"] == 3 and s["unsynced_processes"] == 0
            and {"producer", "worker-0", "worker-1"} <= set(rows)
            and flows and dwell):
        raise SystemExit("[topo:trace] the stitched trace lacks a process "
                         "row, a flow or a broker_dwell span")

    # [topo:slo]: per spec, the events over the merged exports are the sum
    # of the members' (the supervisor's own registry is a member too)
    from reporter_tpu_torch.utils import metrics as metrics_mod
    from reporter_tpu_torch.utils.eventlog import read_events

    exports = {m: d["metrics"] for m, d in snaps.items()}
    exports["supervisor"] = sup_export
    merged_exp = metrics_mod.merge_exports(exports).export()
    identity = {}
    for spec in slo_mod.DEFAULT_SLOS:
        bad, total = slo_mod._bad_total(spec, merged_exp)
        parts = [slo_mod._bad_total(spec, e) for e in exports.values()]
        identity[spec.name] = {
            "bad": bad, "total": total,
            "equal": (bad == sum(p[0] for p in parts)
                      and total == sum(p[1] for p in parts))}
    ledger = os.path.join(workdir, "alerts.jsonl")
    fired = [e for e in read_events(ledger) if e["event"] == "fire"]
    worker_alerts = {}
    for name in reports:
        worker_alerts[name] = [
            e["slo"] for e in read_events(os.path.join(
                workdir, "snapshots", f"alerts_{name}.jsonl"))
            if e["event"] == "fire"]
    phase("topo:slo", card, scale=float(TOPO_SLO_SCALE), identity=identity,
          supervisor_ticks=(sup_slo or {}).get("ticks"),
          supervisor_active=(sup_slo or {}).get("active"),
          supervisor_fired=[e["slo"] for e in fired],
          slo_endpoint_active=slo_http.get("active"),
          health_slo=health.get("slo"), worker_fired=worker_alerts,
          worker_blocks={n: (r or {}).get("slo") for n, r in reports.items()})
    if sup_slo is None or not all(v["equal"] for v in identity.values()) \
            or "slos" not in slo_http or "slo" not in health:
        raise SystemExit("[topo:slo] the merged burn is not the members' "
                         "sum, or the supervisor serves no SLO status")


def topo_scale_phase(card, st):
    """[topo:scale]: the feed through 1, 2 and 4 dict workers on static
    partitions (default StreamingConfig, as [stream:worker]) and 4
    columnar workers at pipeline depth 0, each run a Supervisor (no
    restarts) with a local datastore. The 4 columnar workers start cold:
    a copy of the package without _build/ (each worker builds the
    kernels and the host library at once) and an empty tuner cache (each
    calibrates at once). records/s over the workers' time: the last
    member's "ready" to the last exit at drain (the exit JSON's wall
    stamps); start-up apart; the card's busy share and used memory from
    nvidia-smi polled beside the run (_CardSampler). Every run's reports
    and merged histograms equal the 1-worker run's."""
    import shutil

    from reporter_tpu_torch.distributed import Supervisor, worker_member

    here = os.path.dirname(os.path.abspath(__file__))
    depth0 = _write_config(os.path.join(st["root"], "depth0.json"),
                           pipeline_depth=0)
    cold = os.path.join(st["root"], "cold")
    shutil.copytree(os.path.join(here, "reporter_tpu_torch"),
                    os.path.join(cold, "reporter_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cold_cache = os.path.join(st["root"], "cold_autotune")
    splits = {1: [[0, 1, 2, 3]], 2: [[0, 1], [2, 3]],
              4: [[0], [1], [2], [3]]}
    base, out = None, {}
    for kind, n in TOPO_SCALE_RUNS:
        workdir = os.path.join(st["root"], f"scale_{kind}{n}")
        sink, url = _sink()
        columnar = kind == "columnar"
        env = _topo_env(DATASTORE_URL=url,
                        RTPU_AUTOTUNE_CACHE=(cold_cache if columnar
                                             else st["warm_cache"]))
        if columnar:
            env["PYTHONPATH"] = cold
        members = [worker_member(f"{kind}{n}-{i}", st["tiles"], st["broker"],
                                 workdir, partitions=parts,
                                 columnar=columnar,
                                 config=depth0 if columnar else None,
                                 extra_args=["--device", st["device"]])
                   for i, parts in enumerate(splits[n])]
        sup = Supervisor(members, workdir, restart=False, max_restarts=0,
                         start_sink=False, base_env=env)
        cwd = os.getcwd()
        if columnar:
            os.chdir(cold)       # `python -m` puts the cwd first on the path
        try:
            with _CardSampler() as sampler:
                t_start = time.time()
                sup.start()
                _wait_for(sup.drained, TOPO_TIMEOUT_S,
                          f"[topo:scale] {kind} x{n} did not drain")
                sup.poll_once()
                time.sleep(TOPO_SAMPLE_S)
        finally:
            os.chdir(cwd)
            sup.stop()
        reports, events = sup.exit_reports(), sup.events()
        with sink.lock:
            bodies = list(sink.bodies)
        _close_sink(sink)
        reps = [reports[m.name] or {} for m in members]
        reports = {m.name: r for m, r in zip(members, reps)}
        t_ready = max(r.get("ready_unix_s", 0.0) for r in reps)
        t_exit = max(r.get("exit_unix_s", 0.0) for r in reps)
        spawned = {e["member"]: e["t"] for e in events
                   if e["event"] == "member_spawn"}
        keys, hists = _sink_keys(bodies), _merged_hists(bodies)
        plans = {m.name: reports[m.name].get("plan") for m in members}
        for m in members:
            st["win"].by_path[f"sf:topo:scale:{m.name}"] = _instances(
                reports[m.name].get("launches"))
            if columnar:
                st["win"].by_path[f"sf:topo:scale:{m.name}:calibration"] = \
                    _instances(reports[m.name].get("calibration_launches"))
        if base is None:
            base = (keys, hists)
        checks = {
            "drained": all(r.get("lag") == 0 for r in reps) and all(
                [r["committed"][p] for p in parts]
                == [st["ends"][p] for p in parts]
                for r, parts in zip(reps, splits[n])),
            "reports_equal_1_worker": keys == base[0] and bool(keys),
            "hists_equal_1_worker": hists == base[1],
            "slo_blocks": all(r.get("slo") for r in reps),
            "only_served_instance": all(
                launched_only(r, _plan_instance(r["plan"])) for r in reps),
        }
        fields = {}
        if columnar:
            build = os.path.join(cold, "reporter_tpu_torch", "_build")
            built = sorted(os.listdir(build))
            cached = (sorted(os.listdir(cold_cache))
                      if os.path.isdir(cold_cache) else [])
            # one library of each kind, no temp file: the host library,
            # and on the card the sweep at K = 8 and the Viterbi
            kinds = ["librtt_native_"] + (
                ["libsweep_exact_k8_", "libviterbi_"]
                if st["device"] == "cuda" else [])
            # (a CUDA library's ptxas report sits beside it: the
            # compile manifest reads it)
            libs = [f for f in built if not f.endswith(".ptxas.txt")]
            checks["one_build_per_library"] = sorted(
                next((k for k in kinds if f.startswith(k) and
                      f.endswith(".so")), f) for f in libs) == sorted(kinds) \
                and all(f[:-len(".ptxas.txt")] in libs for f in built
                        if f.endswith(".ptxas.txt"))
            # the card's workers each calibrated and stored a plan: one
            # whole plan file and no temp file (a CPU matcher never tunes)
            checks["one_whole_plan"] = (
                [f.endswith(".json") for f in cached]
                == ([True] if st["device"] == "cuda" else []))
            fields.update(cold_build=built, cold_cache=cached,
                          calibration_launches={
                              m.name: reports[m.name].get(
                                  "calibration_launches") for m in members})
        card_use = sampler.window(t_ready, t_exit)
        out[kind, n] = rps = st["records"] / (t_exit - t_ready)
        # lint: allow[bench-coverage] 2026-10-18 the card sampler's window
        # (busy and memory); [bench_delta] reads the printed line
        phase("topo:scale", card, metro="sf", kind=kind, workers=n,
              device=st["device"], records=st["records"],
              records_per_s=rps, window_s=t_exit - t_ready,
              start_up_s={m.name: reports[m.name].get("ready_unix_s", 0.0)
                          - spawned[m.name] for m in members},
              spawn_to_last_ready_s=t_ready - t_start,
              sampler="nvidia-smi utilization.gpu, memory.used every "
                      f"{TOPO_SAMPLE_S} s", **card_use,
              this_process_reserved_mib=torch.cuda.memory_reserved() / 2**20,
              plans=plans, reports=sum(keys.values()),
              hist_segments=len(hists[0]),
              exits={m.name: {k: reports[m.name].get(k) for k in (
                  "steps", "reports", "lag", "launches")} for m in members},
              checks=checks, **fields)
        if not all(checks.values()):
            raise SystemExit(f"[topo:scale] {kind} x{n}: a check failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    phase("topo:scale:summary", card, records_per_s={
        f"{k}{n}": v for (k, n), v in out.items()},
        speedup_vs_1={f"{k}{n}": v / out["dict", 1]
                      for (k, n), v in out.items()})


def topo_lease_phase(card, st):
    """[topo:lease]: two leased dict workers (ttl TOPO_LEASE_TTL_S, no
    restarts) bootstrap from a fresh lease table; once the table shows an
    acquire a third joins (add_member), and lease-b is SIGKILLed while it
    owns a partition. The table's floors must reach the end offsets; every
    commit event must carry the epoch of the partition's latest acquire
    and chain its floors (no commit at a stale epoch moves a floor, none
    overlaps); the killed member's stale-epoch commit is refused. The
    sink must cover the uninterrupted reports of every partition that
    never changed owner; a moved partition's reports are counted, not
    held (the per-uuid cache does not move with a lease, in either
    package). Printed: the join's rebalance latency and the orphan's
    adoption after the kill."""
    from collections import Counter

    from reporter_tpu_torch.distributed import Supervisor, worker_member
    from reporter_tpu_torch.distributed.lease import (LeaseTable,
                                                      StaleLeaseError)

    workdir = os.path.join(st["root"], "lease")
    lease_dir = os.path.join(workdir, "leases")
    table = LeaseTable(lease_dir, num_partitions=4, ttl_s=TOPO_LEASE_TTL_S)

    def member(name):
        return worker_member(name, st["tiles"], st["broker"], workdir,
                             config=st["cfg_path"], lease_dir=lease_dir,
                             lease_ttl_s=TOPO_LEASE_TTL_S,
                             extra_args=["--device", st["device"]])

    sup = Supervisor([member("lease-a"), member("lease-b")], workdir,
                     restart=False, max_restarts=0, poll_s=0.05,
                     lease_dir=lease_dir, base_env=_topo_env(
                         RTPU_AUTOTUNE_CACHE=st["warm_cache"]))

    def acquires(who=None, part=None):
        return [e for e in table.events() if e["event"] == "acquire"
                and (who is None or e["member"] == who)
                and (part is None or e["partition"] == part)]

    def owned_by(who):
        return sorted((int(p), int(e["epoch"])) for p, e in
                      table.state()["partitions"].items()
                      if e["owner"] == who)

    try:
        t_start = time.time()
        sup.start()
        _wait_for(lambda: acquires(), TOPO_TIMEOUT_S,
                  "[topo:lease] no lease was ever acquired")
        t_join = time.time()
        sup.add_member(member("lease-c"))
        _wait_for(lambda: owned_by("lease-b"), TOPO_TIMEOUT_S,
                  "[topo:lease] lease-b never owned a partition")
        p_vic, epoch_vic = owned_by("lease-b")[0]
        t_kill = time.time()
        if sup.kill_member("lease-b") is None:
            raise SystemExit("[topo:lease] lease-b exited before the kill")

        def reacquired():
            e = table.state()["partitions"][str(p_vic)]
            return e["owner"] not in (None, "lease-b") \
                and int(e["epoch"]) > epoch_vic

        _wait_for(reacquired, TOPO_TIMEOUT_S,
                  "[topo:lease] the killed member's partition was never "
                  "adopted")
        adopt = [e for e in acquires(part=p_vic) if e["t"] >= t_kill]
        adoption_s = adopt[0]["t"] - t_kill
        floor = table.committed(p_vic)
        try:
            table.commit("lease-b", p_vic, epoch_vic, floor + 1)
            fenced = False
        except StaleLeaseError:
            fenced = table.committed(p_vic) == floor
        _wait_for(lambda: acquires("lease-c"), TOPO_TIMEOUT_S,
                  "[topo:lease] the joiner never acquired a partition")
        join_s = acquires("lease-c")[0]["t"] - t_join
        _wait_for(lambda: sup.drained() and table.floors() == st["ends"],
                  TOPO_TIMEOUT_S, "[topo:lease] did not drain")
        sup.poll_once()
        reports = sup.exit_reports()
        have = Counter(sup.sink.reports)
        events = table.events()
        sup_events = sup.events()
    finally:
        sup.stop()
    # fencing: each commit at the epoch of the partition's latest acquire,
    # floors chained (floor_from == the last floor_to)
    epoch_of, floor_of, stale_moves, overlaps = {}, {}, 0, 0
    moved = set()
    counts = Counter(e["event"] for e in events)
    for e in events:
        p = e.get("partition")
        if e["event"] == "acquire":
            if p in epoch_of:
                moved.add(p)
            epoch_of[p] = e["epoch"]
        elif e["event"] == "commit":
            stale_moves += e["epoch"] != epoch_of.get(p)
            overlaps += e["floor_from"] != floor_of.get(p, 0)
            floor_of[p] = e["floor_to"]
    stable = sorted(set(range(4)) - moved)
    # the uninterrupted reports of the stable partitions must all be at
    # the sink; of the moved ones, those missing are counted
    kept, kept_s = (topo_reference(st, stable) if stable
                    else (Counter(), 0.0))
    lost = sum((st["uninterrupted"] - kept - have).values())
    for name, rep in reports.items():
        if rep is not None:
            st["win"].by_path[f"sf:topo:lease:{name}"] = _instances(
                rep.get("launches"))
    checks = {"floors_at_ends": table.floors() == st["ends"],
              "no_stale_commit_moved_a_floor": stale_moves == 0,
              "floors_chained": overlaps == 0,
              "zombie_commit_refused": fenced,
              "stable_partitions_covered": not (kept - have),
              "slo_blocks": all((r or {}).get("slo") for n, r in
                                reports.items() if n != "lease-b"),
              "only_tuned_instance": all(
                  launched_only(r, st["tuned"]) for n, r in reports.items()
                  if n != "lease-b")}
    phase("topo:lease", card, metro="sf", ttl_s=TOPO_LEASE_TTL_S,
          spawn_to_join_s=t_join - t_start,
          join_to_first_acquire_s=join_s,
          joiner_ready_to_first_acquire_s=(
              acquires("lease-c")[0]["t"]
              - (reports.get("lease-c") or {}).get("ready_unix_s", 0.0)),
          killed_partition=p_vic, kill_to_adoption_s=adoption_s,
          lease_events=dict(counts),
          rebalances=sum(1 for e in sup_events if e["event"] == "rebalance"),
          moved_partitions=sorted(moved), stable_partitions=stable,
          stable_reports=sum(kept.values()), stable_reference_s=kept_s,
          stable_reports_missing=sum((kept - have).values()),
          moved_reports_not_published=lost,
          reports_at_sink=sum(have.values()),
          exits={n: (r or {}).get("lease") for n, r in reports.items()},
          checks=checks)
    if not all(checks.values()):
        raise SystemExit(f"[topo:lease] a check failed: "
                         f"{[k for k, v in checks.items() if not v]}")


def host_cpu():
    """The host CPU and its core count (the oracle's rate is a host
    figure): /proc/cpuinfo's model name, else its vendor, family and
    model numbers (a virtual machine may hide the name), else the
    architecture."""
    import platform

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, sep, val = line.partition(":")
                if not sep:
                    if info:
                        break           # the first processor's block
                    continue
                info.setdefault(key.strip().lower(), val.strip())
    except OSError:
        pass
    name = info.get("model name", "")
    if not name or name == "unknown":
        name = " ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family",
                                                   "model") if k in info)
    return f"{name or platform.machine()} x{os.cpu_count()}"


def oracle_phase(card, ts, traces, recs, cpu_recs, metro):
    """[oracle]: the first ORACLE_TRACES[metro] traces through the
    exact-Dijkstra oracle (matcher_backend="reference_cpu", numpy on the
    host): the card's records must agree with it, length-weighted, at
    AGREEMENT_GATE or better, and equal the CPU port's records."""
    from reporter_tpu_torch.config import Config
    from reporter_tpu_torch.matcher.api import SegmentMatcher
    from reporter_tpu_torch.matcher.fidelity import (
        length_weighted_agreement, mean_disagreement)

    n = ORACLE_TRACES[metro]
    small, card_recs = traces[:n], recs[:n]
    oracle = SegmentMatcher(ts, Config(matcher_backend="reference_cpu"))
    t0 = time.perf_counter()
    ref = oracle.match_many(small)
    oracle_s = time.perf_counter() - t0
    agree, total = length_weighted_agreement(card_recs, ref)
    cpu_ok = json_records(cpu_recs[:n]) == json_records(card_recs)
    probes = sum(len(t.xy) for t in small)
    phase("oracle", card, metro=metro, traces=n, probes=probes,
          agreement=agree / total, gate=AGREEMENT_GATE, agree_m=agree,
          total_m=total, mean_disagreement=mean_disagreement(card_recs, ref),
          oracle_records=sum(len(r) for r in ref),
          card_records=sum(len(r) for r in card_recs),
          oracle_s=oracle_s, oracle_probes_per_s=probes / oracle_s,
          dijkstra_searches=oracle._dij_cache.searches,
          dijkstra_hits=oracle._dij_cache.hits, host_cpu=host_cpu(),
          card_vs_cpu_records_equal=cpu_ok)
    if agree / total < AGREEMENT_GATE or not cpu_ok:
        raise SystemExit(f"[oracle] {metro}: agreement {agree / total:.4f} "
                         f"(gate {AGREEMENT_GATE}) or card != CPU records")


def _tuned(m, dc):
    return _params_instance(m.params, dc)


def _params_instance(p, dc):
    """The kernel instance (arm, K) a MatcherParams' levers select."""
    return dc.sweep_arm(p.sweep_subcull, p.sweep_lowp, p.sweep_mxu), \
        p.max_candidates


def _drive_columnar(pipe, cols):
    """Feed round by round at pipeline depth 0; a round whose wave timed
    out steps again on the same rows (no new records), so the retried
    wave flushes at the uninterrupted run's points. Then drain."""
    q = pipe.queue
    for c in cols:
        q.append_columns(c)
        before = pipe.dispatch_timeouts
        pipe.step()
        while pipe.dispatch_timeouts > before:
            before = pipe.dispatch_timeouts
            pipe.step()
    pipe.drain()


def watchdog_phase(card, ts, fleet, m, dc, win, device="cuda"):
    """[watchdog]: the dispatch watchdog on the card. (1) The columnar
    pipeline (depth 0) over WATCHDOG_VEHICLES vehicles with
    dispatch_timeout_s = WATCHDOG_TIMEOUT_S, once uninterrupted and once
    with the second dispatch hanging WATCHDOG_HANG_S: one timeout, the
    same reports. (2) dispatch_fallback="reference_cpu" under a hang of
    every dispatch, FALLBACK_VEHICLES vehicles: every wave from the
    oracle, reports present, fallbacks counted, no wave released. (3) A
    /report under a hang answers 503; its retry answers 200."""
    from reporter_tpu_torch import faults
    from reporter_tpu_torch.config import (Config, MatcherParams,
                                           ServiceConfig, StreamingConfig)
    from reporter_tpu_torch.service.app import make_app
    from reporter_tpu_torch.streaming import (ColumnarStreamPipeline,
                                              pack_records)

    from reporter_tpu_torch.matcher.api import Trace

    sub = fleet[:WATCHDOG_VEHICLES]
    # warm batches of the subset, with the tuned matcher
    probe = [Trace(p.uuid, p.xy.astype(np.float32), p.times) for p in sub]
    entry_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        m.match_many(probe)
        entry_s.append(time.perf_counter() - t0)
    if WATCHDOG_TIMEOUT_S < 5 * max(entry_s):
        raise SystemExit(f"[watchdog] timeout {WATCHDOG_TIMEOUT_S} s is not "
                         f"well above a warm batch {max(entry_s):.3f} s")
    cols = [pack_records(r) for r in stream_rounds(sub)]

    def run(plan, timeout, fallback="retry", rounds=cols, tag="run"):
        bodies = []
        cfg = Config(matcher=MatcherParams(dispatch_timeout_s=timeout,
                                           dispatch_fallback=fallback),
                     service=ServiceConfig(
                         datastore_url="http://datastore.local/"),
                     streaming=StreamingConfig(pipeline_depth=0))
        pipe = ColumnarStreamPipeline(ts, cfg, transport=_capture(bodies),
                                      device=device)
        tuned = _tuned(pipe.matcher, dc)
        t0 = time.perf_counter()
        with faults.use(faults.FaultPlan.parse(plan) if plan else None):
            _, counts = win.run(f"sf:watchdog:{tag}",
                                lambda: _drive_columnar(pipe, rounds))
        seconds = time.perf_counter() - t0
        _check_drained(pipe, f"watchdog:{tag}")
        reg = pipe.matcher.metrics
        out = {"reports": _sorted_reports(_report_rows(bodies)),
               "seconds": seconds, "tuned": tuned, "counts": counts,
               "released": pipe.dispatch_timeouts,
               "timeouts": int(reg.value("dispatch_timeout")),
               "fallbacks": int(reg.value("dispatch_fallback")),
               "breaker": int(reg.value("dispatch_breaker_open")),
               "waves": pipe.waves_completed}
        pipe.close()
        return out

    clean = run(None, WATCHDOG_TIMEOUT_S, tag="clean")
    hung = run(f"dispatch:hang({WATCHDOG_HANG_S:g})@1", WATCHDOG_TIMEOUT_S,
               tag="hang")
    same = hung["reports"] == clean["reports"]
    phase("watchdog", card, metro="sf", vehicles=len(sub),
          records=sum(c.n for c in cols),
          warm_batch_ms=[s * 1e3 for s in entry_s],
          dispatch_timeout_s=WATCHDOG_TIMEOUT_S,
          injected_hang_s=WATCHDOG_HANG_S,
          clean_s=clean["seconds"], hang_s=hung["seconds"],
          clean_waves=clean["waves"], hang_waves=hung["waves"],
          clean_timeouts=clean["timeouts"], timeouts=hung["timeouts"],
          waves_released=hung["released"], reports=len(clean["reports"]),
          reports_equal_uninterrupted=same,
          launches=_launches(hung["counts"]))
    only(clean["counts"], clean["tuned"], "[watchdog] uninterrupted")
    only(hung["counts"], hung["tuned"], "[watchdog] with the hang")
    if not (same and clean["reports"] and clean["timeouts"] == 0
            and hung["timeouts"] == hung["released"] == 1):
        raise SystemExit("[watchdog] the hang did not give exactly one "
                         "timeout, or the reports differ")

    few = [pack_records(r) for r in stream_rounds(fleet[:FALLBACK_VEHICLES])]
    fb = run(f"dispatch:hang({FALLBACK_HANG_S:g})@0-", FALLBACK_TIMEOUT_S,
             fallback="reference_cpu", rounds=few, tag="fallback")
    phase("watchdog:fallback", card, metro="sf", vehicles=FALLBACK_VEHICLES,
          dispatch_timeout_s=FALLBACK_TIMEOUT_S,
          injected_hang_s=FALLBACK_HANG_S, seconds=fb["seconds"],
          waves=fb["waves"], dispatch_fallback=fb["fallbacks"],
          dispatch_timeout=fb["timeouts"],
          dispatch_breaker_open=fb["breaker"],
          waves_released=fb["released"], reports=len(fb["reports"]),
          launches=_launches(fb["counts"]))
    if not (fb["reports"] and fb["fallbacks"] == fb["waves"] > 0
            and fb["released"] == 0 and not any(fb["counts"].values())):
        raise SystemExit("[watchdog:fallback] the oracle did not serve "
                         "every wave")

    app = make_app(ts, Config(
        matcher=MatcherParams(dispatch_timeout_s=WATCHDOG_TIMEOUT_S),
        service=ServiceConfig(batching="combine")), device=device)
    body = fleet[0].to_report_json()
    with faults.use(faults.FaultPlan.parse(
            f"dispatch:hang({WATCHDOG_HANG_S:g})@0")):
        t0 = time.perf_counter()
        hung_answer = wsgi_post(app, "/report", body)
        hung_s = time.perf_counter() - t0
        retry = wsgi_post(app, "/report", body)
    app.close()
    ok = (hung_answer[0] == 503
          and "device dispatch exceeded" in hung_answer[1].get("error", "")
          and retry[0] == 200 and len(retry[1].get("segments", ())) > 0)
    phase("watchdog:503", card, metro="sf", status=hung_answer[0],
          body=hung_answer[1], answer_s=hung_s, retry_status=retry[0],
          retry_segments=len(retry[1].get("segments", ())))
    if not ok:
        raise SystemExit("[watchdog:503] a hung /report did not answer 503, "
                         "or its retry failed")


def audit_phase(card, m, traces, dc, win):
    """[audit]: AUDIT_BATCHES served batches of AUDIT_BATCH traces through
    the tuned card matcher with the process auditor at rate 1, interval 0
    and duty cap 100: the sampled batches are audited against the oracle
    on the auditor's thread."""
    from reporter_tpu_torch.quality import audit

    def serve():
        for k in range(AUDIT_BATCHES):
            m.match_many(traces[k * AUDIT_BATCH:(k + 1) * AUDIT_BATCH])

    prev = audit._global
    # the same batches with the auditor off, then at rate 1: what the
    # oracle on the auditor's thread costs the serving thread
    off = audit.ShadowAuditor(rate=0.0)
    a = audit.ShadowAuditor(rate=1.0, min_interval_s=0.0,
                            duty_pct_cap=100.0, timeout_s=300.0)
    try:
        audit.configure(off)
        t0 = time.perf_counter()
        serve()
        off_s = time.perf_counter() - t0
        audit.configure(a)
        t0 = time.perf_counter()
        _, counts = win.run("sf:audit", serve)
        serve_s = time.perf_counter() - t0
        drained = a.drain(600.0)
        st = a.stats()
    finally:
        audit.configure(prev)
        a.stop()
        off.stop()
    # lint: allow[bench-coverage] 2026-10-18 the auditor's stats;
    # [bench_delta] reads the printed line
    phase("audit", card, metro="sf", batches=AUDIT_BATCHES,
          batch_traces=AUDIT_BATCH, serve_s_auditor_off=off_s,
          serve_s=serve_s, drained=drained, **st, host_cpu=host_cpu(),
          launches=_launches(counts))
    only(counts, _tuned(m, dc), "[audit] the served batches")
    if not (drained and st["audited_batches"] >= 1
            and st["audit_timeouts"] == 0 and st["audit_calls"]
            == AUDIT_BATCHES):
        raise SystemExit(f"[audit] {st}")


def wsgi_get(app, path, query=""):
    """One GET through the WSGI callable. → (status, JSON)."""
    import io

    status = []
    env = {"REQUEST_METHOD": "GET", "PATH_INFO": path,
           "QUERY_STRING": query, "wsgi.input": io.BytesIO(b"")}
    data = b"".join(app(env, lambda s, h: status.append(s)))
    return int(status[0].split()[0]), json.loads(data)


def backfill_phase(card, ts, fleet, m, dc, win, device="cuda"):
    """[backfill]: the fleet's 122,880 records spooled into a 4-partition
    durable columnar broker and a records broker under _chip_scratch/
    backfill; BackfillEngine with the tuned sf matcher and the default
    BackfillConfig (shadow on: the card's grids must equal the host
    twin), the records spool (the same document), a closed-loop columnar
    drain of the same spool (pipeline depth 0, default StreamingConfig),
    slice_traces=1024 (the same grids), backfill:crash@1 and a resume
    from its checkpoint (the same grids, the replay tax), and GET
    /aggregates of an app holding the store."""
    import dataclasses
    import shutil

    from reporter_tpu_torch import faults
    from reporter_tpu_torch.backfill import BackfillConfig, BackfillEngine
    from reporter_tpu_torch.config import (Config, ServiceConfig,
                                           StreamingConfig)
    from reporter_tpu_torch.service.app import make_app
    from reporter_tpu_torch.streaming import (ColumnarStreamPipeline,
                                              DurableColumnarIngestQueue,
                                              DurableIngestQueue,
                                              pack_records)

    root = os.path.join(SCRATCH, "backfill")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rounds = stream_rounds(fleet)
    n_records = sum(len(r) for r in rounds)
    col_dir, rec_dir = os.path.join(root, "col"), os.path.join(root, "rec")
    t0 = time.perf_counter()
    q = DurableColumnarIngestQueue(col_dir, BACKFILL_PARTITIONS)
    for r in rounds:
        q.append_columns(pack_records(r))
    q.close()
    col_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = DurableIngestQueue(rec_dir, BACKFILL_PARTITIONS)
    for r in rounds:
        q.append_many(r)
    q.close()
    rec_s = time.perf_counter() - t0
    tuned = _tuned(m, dc)

    def run(tag, broker, shadow=False, **kw):
        """One engine run in its launch window, the card sampled beside
        it. → (engine, stats or None where InjectedCrash stopped it,
        launches, the card's busy share)."""
        eng = BackfillEngine(ts, matcher=m, bf=BackfillConfig(**kw))
        if shadow:
            eng.enable_shadow_reference()

        def go():
            try:
                return eng.run(broker)
            except faults.InjectedCrash:
                return None

        with _CardSampler() as sampler:
            t0 = time.time()
            stats, counts = win.run(f"sf:backfill:{tag}", go)
            t1 = time.time()
        only(counts, tuned, f"[backfill] {tag}")
        return eng, stats, counts, sampler.window(t0, t1)["busy_share"]

    def grids(eng):
        return eng.hist.snapshot(), eng.qhist.snapshot()

    def same_grids(a, b):
        return all(np.array_equal(x, y) for x, y in zip(grids(a), grids(b)))

    def doc_of(eng):
        return json.dumps(eng.store.snapshot(), sort_keys=True)

    base, st, counts, busy = run("default", col_dir, shadow=True)
    identical = base.shadow_identical()
    # lint: allow[bench-coverage] 2026-10-18 the engine's stats;
    # [bench_delta] reads the printed line
    phase("backfill", card, metro="sf", arm="default",
          spool_seconds={"columnar": col_s, "records": rec_s},
          config=dataclasses.asdict(BackfillConfig()),
          **st, records_per_s=st["records"] / st["seconds"],
          stage_s=base.stage_seconds, card_busy_share=busy,
          agg_identical=identical, launches=_launches(counts))
    rec_eng, rst, _, _ = run("records", rec_dir)
    rec_same = doc_of(rec_eng) == doc_of(base) and same_grids(rec_eng, base)

    # the closed loop over a copy of the same spool (the pipeline's
    # commits may truncate its broker)
    loop_dir = os.path.join(root, "loop")
    shutil.copytree(col_dir, loop_dir)
    bodies = []
    pipe = ColumnarStreamPipeline(
        ts, Config(service=ServiceConfig(
            datastore_url="http://datastore.local/"),
            streaming=StreamingConfig(pipeline_depth=0)),
        queue=DurableColumnarIngestQueue(loop_dir, BACKFILL_PARTITIONS),
        transport=_capture(bodies), device=device)
    loop_tuned = _tuned(pipe.matcher, dc)

    def drain_loop():
        steps = 0
        while pipe._consumed != _ends(pipe.queue):
            pipe.step()
            steps += 1
        pipe.drain()
        return steps

    with _CardSampler() as sampler:
        t_wall = time.time()
        t0 = time.perf_counter()
        steps, loop_counts = win.run("sf:backfill:closed_loop", drain_loop)
        loop_s = time.perf_counter() - t0
        loop_busy = sampler.window(t_wall, time.time())["busy_share"]
    _check_drained(pipe, "backfill:closed_loop")
    pipe.close()
    only(loop_counts, loop_tuned, "[backfill] the closed loop")
    loop_rps = n_records / loop_s
    open_rps = st["records"] / st["seconds"]

    wide, wst, wcounts, wide_busy = run("slice_1024", col_dir,
                                        slice_traces=1024)
    wide_same = same_grids(wide, base) and doc_of(wide) == doc_of(base)

    ck = os.path.join(root, "ckpt")
    with faults.use(faults.FaultPlan.parse("backfill:crash@1")):
        _, crash_st, crash_counts, _ = run("crash", col_dir,
                                           checkpoint_path=ck,
                                           checkpoint_every_waves=1)
    crashed = crash_st is None
    resumed, cst, resume_counts, _ = run("resume", col_dir,
                                         checkpoint_path=ck,
                                         checkpoint_every_waves=1)
    resume_same = same_grids(resumed, base) and doc_of(resumed) == \
        doc_of(base)

    app = make_app(ts, device=device, aggregates=base.store)
    doc = base.store.snapshot()
    seg = next(iter(doc["segments"]), None)
    full = wsgi_get(app, "/aggregates")
    one = wsgi_get(app, "/aggregates", f"segment={seg}")
    unknown = wsgi_get(app, "/aggregates", "segment=0")
    app.close()
    want = json.loads(json.dumps(doc))
    agg_ok = (full == (200, want) and one == (200, json.loads(json.dumps(
        base.store.snapshot(seg)))) and unknown[0] == 404)

    phase("backfill:check", card, metro="sf",
          records_spool={k: rst[k] for k in ("records", "reports",
                                             "seconds", "krows_per_s")},
          records_spool_doc_equal=rec_same,
          closed_loop={"records_per_s": loop_rps, "seconds": loop_s,
                       "steps": steps, "waves": pipe.waves_completed,
                       "reports": len(_report_rows(bodies)),
                       "card_busy_share": loop_busy,
                       "launches": _launches(loop_counts)},
          open_loop_records_per_s=open_rps, vs_soak_x=open_rps / loop_rps,
          slice_1024={"records_per_s": wst["records"] / wst["seconds"],
                      "seconds": wst["seconds"], "chunks": wst["chunks"],
                      "stage_s": wide.stage_seconds,
                      "card_busy_share": wide_busy,
                      "launches": _launches(wcounts)},
          slice_1024_x=(wst["records"] / wst["seconds"]) / open_rps,
          slice_1024_grids_equal=wide_same, crashed_at_wave_1=crashed,
          crash_launches=_launches(crash_counts),
          resume={k: cst[k] for k in ("records", "records_total",
                                      "replay_tax_records", "waves",
                                      "seconds")},
          resume_launches=_launches(resume_counts),
          resume_grids_equal=resume_same, aggregates_endpoint_equal=agg_ok,
          segments_kept=len(doc["segments"]),
          kanon_dropped=doc["kanon_dropped"])
    if not (identical and rec_same and wide_same and crashed and resume_same
            and agg_ok and st["records"] == n_records and st["reports"]):
        raise SystemExit("[backfill] a check failed")


# ---- the metro router, the Kafka feed, link health, the tuner's guard ------


def kernel_between_phase(card, tab, pts, radius, dc, metro):
    """[kernel:k] at each K of KERNEL_BETWEEN_KS (between the built
    widths): every arm runs the next built instance K' and keeps its first
    K columns, bit-equal to _dense_plain at K on CHECK_CHUNKS chunks and
    to the K' instance's first K columns on every point; the launch is
    counted under (arm, K'). Comparison launches: no launch window."""
    n = pts.shape[0]
    nchunks = n // dc._P
    fpts, fval = dc._fill_invalid(
        pts, torch.ones(n, dtype=torch.bool, device="cuda"), nchunks)
    ids, nhits = dc._chunk_block_ids(fpts, fval, tab["seg_bbox"], radius,
                                     nchunks)
    rows, _ = check_rows(dc, nhits, CHECK_CHUNKS)
    cpts = pts[rows]
    tables = (tab["seg_sweep"], tab["seg_sub"], tab["seg_coarse"])
    for k in KERNEL_BETWEEN_KS:
        kk = dc.sweep_instance_k(k)
        ref = dc._dense_plain(cpts, tab["seg_pack"], radius, k)
        out, bad = {}, []
        for arm in dc.SWEEP_ARMS:
            def run(kx=k, a=arm):
                return dc.sweep_topk(fpts, ids, nhits, *tables, radius, kx, a)

            before = dict(dc.SWEEP_LAUNCHES)
            got = run()
            torch.cuda.synchronize()
            ran = {f"{a}@k{kx}": v - before.get((a, kx), 0)
                   for (a, kx), v in dc.SWEEP_LAUNCHES.items()
                   if v != before.get((a, kx), 0)}
            wide = run(kk)
            mism = {f: int((g[rows] != r).sum()) for f, g, r in
                    zip(("edge", "offset", "dist"), got, ref)}
            prefix = all(torch.equal(g, w[:, :k]) for g, w in zip(got, wide))
            out[arm] = {"instance_launched": ran, "mismatches": mism,
                        "equal_to_wide_prefix_on_all_points": prefix,
                        "max_abs_err": max(
                            float((got[1][rows] - ref[1]).abs().max()),
                            float((got[2][rows] - ref[2]).abs().max())),
                        "ms": cuda_ms(run, reps=10),
                        "ms_at_instance_k": cuda_ms(lambda: run(kk), reps=10)}
            if any(mism.values()) or not prefix \
                    or ran != {f"{arm}@k{kk}": 1}:
                bad.append(arm)
        phase("kernel:k", card, metro=metro, k=k, instance_k=kk, points=n,
              plain_points=int(rows.numel()), arms=out)
        if bad:
            raise SystemExit(f"[kernel:k] {metro} K={k}: arms {bad} differ "
                             f"from _dense_plain or from the K={kk} "
                             "instance, or launched another instance")


def http_text(url, timeout=60.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def _no_metro(body):
    return {k: v for k, v in body.items() if k != "metro"}


def router_phase(card, dc, win, cache):
    """[router]: BASELINE config 4's trio (sf, nyc, la at their generator
    sizes, compiled by the port and saved as .npz) behind one endpoint.
    In-process (make_router on the card behind serve(), so the launches
    can be read): ROUTER_CLIENTS clients, round-robin over the metros,
    each posting its ROUTER_UUIDS uuids' 120-point traces as SERVE_PARTS
    in-order /report requests of 40 points, every ROUTER_EXPLICIT_EVERY-th
    client naming its "metro" (the rest routed by location); one mixed
    /report_many; a trace outside every metro (404, known_metros,
    router_unroutable in /metrics); an unknown metro (400). Every routed
    response equals a dedicated single-metro app's on the card fed the
    same per-metro request sequence (as report_many rounds); each metro's
    wire entries launch only its own plan's instance. Then [router:server]:
    the entry point as a subprocess over the three files (three
    calibrations): start-up, /health per metro, answers equal, 404,
    SIGINT."""
    from reporter_tpu_torch.config import Config
    from reporter_tpu_torch.netgen.synthetic import generate_city
    from reporter_tpu_torch.netgen.traces import synthesize_fleet
    from reporter_tpu_torch.service.app import make_app
    from reporter_tpu_torch.service.router import make_router
    from reporter_tpu_torch.service.server import serve
    from reporter_tpu_torch.tiles.compiler import compile_network

    root = os.path.join(SCRATCH, "router")
    os.makedirs(root, exist_ok=True)
    tilesets, paths, compile_s = [], [], {}
    for name in ROUTER_METROS:
        t = time.perf_counter()
        tsm = compile_network(generate_city(name))
        compile_s[name] = time.perf_counter() - t
        tilesets.append(tsm)
        paths.append(tsm.save(os.path.join(root, name)))
    names = [t.name for t in tilesets]
    clients = {n: [c for c in range(ROUTER_CLIENTS) if c % len(names) == i]
               for i, n in enumerate(names)}
    n_many = ROUTER_MANY // len(names)
    part = N_POINTS // SERVE_PARTS
    requests, fleets = {}, {}
    for i, (n, tsm) in enumerate(zip(names, tilesets)):
        n_uuid = len(clients[n]) * ROUTER_UUIDS
        fleets[n] = synthesize_fleet(tsm, n_uuid + n_many,
                                     num_points=N_POINTS, seed=i + 1)
        requests[n] = [[{"uuid": f"{n}-veh-{u}", "trace":
                         fleets[n][u].to_report_json()["trace"][
                             k * part:(k + 1) * part]}
                        for k in range(SERVE_PARTS)] for u in range(n_uuid)]
        for j, c in enumerate(clients[n]):
            if c % ROUTER_EXPLICIT_EVERY == 0:
                for u in range(j * ROUTER_UUIDS, (j + 1) * ROUTER_UUIDS):
                    for r in requests[n][u]:
                        r["metro"] = n
    os.environ["RTPU_AUTOTUNE_CACHE"] = os.path.join(cache, "router")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    router, cal = win.run("router:calibration", lambda: make_router(
        tilesets, Config(), device="cuda"))
    construct_s = time.perf_counter() - t0
    mem_router = torch.cuda.memory_allocated() - mem0
    tuned = {n: _tuned(a.matcher, dc) for n, a in router.apps.items()}
    inst = {n: (arm, dc.sweep_instance_k(k)) for n, (arm, k) in tuned.items()}
    # each metro's wire entries, by the instance they launch: a counting
    # shim over its matcher's submit_prepared (one sweep launch each)
    entries, elock = {n: {} for n in names}, threading.Lock()
    for n, app in router.apps.items():
        real = app.matcher.submit_prepared

        def counted(ps, tables=None, n=n, real=real):
            with elock:
                entries[n][inst[n]] = entries[n].get(inst[n], 0) + 1
            return real(ps, tables)
        app.matcher.submit_prepared = counted
    server = serve(router, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    responses = {n: [[None] * SERVE_PARTS for _ in requests[n]]
                 for n in names}
    lat, statuses, lock = [], [], threading.Lock()
    many = [dict(fleets[n][-1 - i].to_report_json(), uuid=f"many-{n}-{i}")
            for i in range(n_many) for n in names]
    try:
        def client(c):
            n = names[c % len(names)]
            j = clients[n].index(c)
            for u in range(j * ROUTER_UUIDS, (j + 1) * ROUTER_UUIDS):
                for k in range(SERVE_PARTS):
                    t = time.perf_counter()
                    st, body = http_json(base + "/report", requests[n][u][k])
                    dt = time.perf_counter() - t
                    with lock:
                        lat.append(dt)
                        statuses.append(st)
                    responses[n][u][k] = body

        def traffic():
            t = time.perf_counter()
            with ThreadPoolExecutor(max_workers=ROUTER_CLIENTS) as pool:
                list(pool.map(client, range(ROUTER_CLIENTS)))
            clients_s = time.perf_counter() - t
            t = time.perf_counter()
            st, body = http_json(base + "/report_many", {"traces": many})
            statuses.append(st)
            return clients_s, body, (time.perf_counter() - t) * 1e3

        stages0 = {n: dict(a.matcher.stage_seconds)
                   for n, a in router.apps.items()}
        with _CardSampler() as sampler:
            t, t_wall = time.perf_counter(), time.time()
            (clients_s, many_body, many_ms), counts = win.run("router",
                                                              traffic)
            wall_s = time.perf_counter() - t
            busy = sampler.window(t_wall, time.time())
        far = {"uuid": "far", "trace": [{"lat": -45.0, "lon": 100.0,
                                         "time": 0.0}]}
        far_status, far_body = http_json(base + "/report", far)
        unknown_status, unknown_body = http_json(
            base + "/report", dict(requests[names[0]][0][0],
                                   metro="atlantis"))
        _, prom = http_text(base + "/metrics")
        _, health = http_json(base + "/health")
        _, stats = http_json(base + "/stats")
    finally:
        server.shutdown()
        server.server_close()
        router.close()
    unroutable = re.search(r"^rtpu_router_unroutable(?:_total)? ([0-9.]+)$",
                           prom, re.M)
    sent = {n: len(requests[n]) * SERVE_PARTS + n_many for n in names}
    n_req = sum(len(requests[n]) for n in names) * SERVE_PARTS
    summed = {}
    for n in names:
        for key, v in entries[n].items():
            summed[key] = summed.get(key, 0) + v
    window = {key: v for key, v in counts.items() if v}
    phase("router", card, metros=names,
          edges={t.name: t.num_edges for t in tilesets},
          compile_s=compile_s, construct_s=construct_s,
          calibration_launches=_launches(cal),
          tuned_instance={n: list(v) for n, v in inst.items()},
          table_bytes={n: a.matcher.table_bytes
                       for n, a in router.apps.items()},
          cuda_allocated_bytes_after_construct=mem_router,
          clients=ROUTER_CLIENTS,
          clients_by_metro={n: len(c) for n, c in clients.items()},
          explicit_metro_clients=len(range(0, ROUTER_CLIENTS,
                                           ROUTER_EXPLICIT_EVERY)),
          requests=len(lat), latency_ms_p50=_pct(lat, 0.50) * 1e3,
          latency_ms_p99=_pct(lat, 0.99) * 1e3,
          latency_ms_max=max(lat) * 1e3, clients_s=clients_s,
          report_many_traces=len(many), report_many_ms=many_ms,
          traffic_s=wall_s,
          traces_per_s=(n_req + len(many)) / wall_s,
          card_busy_share=busy["busy_share"], busy_samples=busy["samples"],
          stage_s_by_metro={n: {key: v - stages0[n][key] for key, v in
                                a.matcher.stage_seconds.items()}
                            for n, a in router.apps.items()},
          scheduler_by_metro={n: {key: h["scheduler"].get(key) for key in (
              "batches", "submissions", "padded_traces",
              "max_inflight_seen")} for n, h in health["metros"].items()},
          far_status=far_status, far_known_metros=far_body.get(
              "known_metros"), unknown_metro_status=unknown_status,
          unknown_metro_error=unknown_body.get("error"),
          metrics_router_unroutable=(float(unroutable.group(1))
                                     if unroutable else None),
          stats_traces={n: stats[n]["traces"] for n in names},
          launches=_launches(window),
          launches_by_metro={n: _launches(e) for n, e in entries.items()},
          health_unroutable=health.get("unroutable"),
          health_metros={n: {key: h.get(key) for key in (
              "tileset", "edges", "tile_hbm_bytes", "device", "published",
              "traces", "link")} for n, h in health["metros"].items()})
    # ---- the checks ----
    problems = []
    if any(st != 200 for st in statuses):
        problems.append(f"non-200 responses {sorted(set(statuses))}")
    if [r.get("metro") for r in many_body.get("results", ())] != \
            [p["uuid"].split("-")[1] for p in many]:
        problems.append("the mixed /report_many routed a trace elsewhere")
    if any(responses[n][u][k].get("metro") != n for n in names
           for u in range(len(requests[n])) for k in range(SERVE_PARTS)):
        problems.append("a /report was routed to another metro")
    if far_status != 404 or far_body.get("known_metros") != sorted(names):
        problems.append(f"the far trace answered {far_status} {far_body}")
    if unknown_status != 400:
        problems.append(f"the unknown metro answered {unknown_status}")
    if unroutable is None or float(unroutable.group(1)) != 1.0 \
            or health.get("unroutable") != 1:
        problems.append("router_unroutable is not 1 in /metrics and /health")
    if any(stats[n]["traces"] != sent[n] for n in names):
        problems.append(f"/stats traces {[stats[n]['traces'] for n in names]}"
                        f" against {sent}")
    for n in names:
        if set(entries[n]) != {inst[n]} or not entries[n][inst[n]]:
            problems.append(f"{n} launched {entries[n]}, not only "
                            f"{inst[n]}")
    if window != summed:
        problems.append(f"the window's launches {window} are not the "
                        f"metros' sum {summed}")
    for n, h in health["metros"].items():
        link = h.get("link") or {}
        if link.get("mood") not in ("healthy", "degraded") \
                or link.get("rtt_ms") is None or link.get("mbps") is None:
            problems.append(f"{n}'s /health link block {link}")
    # dedicated single-metro apps on the card, the same per-metro order
    equal = {}
    for n, tsm in zip(names, tilesets):
        app = make_app(tsm, Config(), device="cuda")   # the cached plan
        same_plan = _tuned(app.matcher, dc) == tuned[n]
        uu = range(len(requests[n]))
        got = [r for k in range(SERVE_PARTS) for r in app.report_many(
            [_no_metro(requests[n][u][k]) for u in uu])]
        want = [_no_metro(responses[n][u][k]) for k in range(SERVE_PARTS)
                for u in uu]
        mine = [p for p in many if p["uuid"].startswith(f"many-{n}-")]
        got_many = app.report_many(mine)
        want_many = [_no_metro(r) for p, r in zip(many,
                                                  many_body["results"])
                     if p["uuid"].startswith(f"many-{n}-")]
        app.close()
        equal[n] = {"same_plan": same_plan, "responses": got == want,
                    "report_many": got_many == want_many,
                    "segments": sum(len(r["segments"]) for r in want),
                    "reports": sum(len(r["reports"]) for r in want)}
        if not (same_plan and got == want and got_many == want_many
                and equal[n]["segments"]):
            problems.append(f"{n}: routed responses differ from a "
                            f"dedicated app's: {equal[n]}")
    if not sum(e["reports"] for e in equal.values()):
        problems.append("no routed response holds a report")
    phase("router:check", card, dedicated_app_equal=equal)
    if problems:
        raise SystemExit("[router] " + "; ".join(problems))

    # ---- the entry point over the three files ----
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here,
               RTPU_AUTOTUNE_CACHE=os.path.join(cache, "router_server"))
    log_path = os.path.join(root, "server.log")
    base = f"http://127.0.0.1:{port}"
    firsts = [(n, requests[n][0][0], responses[n][0][0]) for n in names]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "reporter_tpu_torch.service.server",
             "--tiles", *paths, "--host", "127.0.0.1", "--port", str(port)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=here)
        try:
            health, start_s = _await_health(proc, base, ROUTER_START_S,
                                            log_path, "router:server")
            got = [http_json(base + "/report", p) for _, p, _ in firsts]
            far_status, far_body = http_json(base + "/report", far)
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = open(log_path).read()
    ready = re.search(r"ready in ([0-9.]+) s", text)
    same = [st == 200 and body == want
            for (st, body), (_, _, want) in zip(got, firsts)]
    phase("router:server", card, start_to_health_s=start_s,
          server_ready_s=float(ready.group(1)) if ready else None,
          logged_router=f"router[{', '.join(names)}]" in text,
          tile_hbm_bytes={n: h.get("tile_hbm_bytes")
                          for n, h in health["metros"].items()},
          device={n: h.get("device") for n, h in health["metros"].items()},
          answers_equal_in_process=same, far_status=far_status,
          sigint_exit_code=rc, drained="draining scheduler" in text)
    if not (all(same) and rc == 0 and far_status == 404
            and sorted(health["metros"]) == sorted(names)
            and f"router[{', '.join(names)}]" in text):
        raise SystemExit("[router:server] the entry point's answers, 404, "
                         "metros or exit differ:\n" + _tail(log_path))
    return tilesets


class _KafkaRecord:
    __slots__ = ("offset", "value")

    def __init__(self, offset, value):
        self.offset, self.value = offset, value


class _FakeKafka:
    """An in-process kafka-python KafkaConsumer shape over per-partition
    logs of JSON bytes (a keyed producer's: partition by uuid): assign,
    seek, pause, resume, a cursor-based poll fetching at most KAFKA_FETCH
    records a call, end_offsets."""

    def __init__(self, topic, num_partitions):
        from reporter_tpu_torch.streaming.queue import partition_of

        self.topic, self._part_of = topic, partition_of
        self.logs = [[] for _ in range(num_partitions)]
        self._cursor, self._paused, self._assigned = {}, set(), []

    def produce_many(self, records):
        for r in records:
            self.logs[self._part_of(str(r["uuid"]), len(self.logs))].append(
                json.dumps(r).encode())

    def partitions_for_topic(self, topic):
        return set(range(len(self.logs))) if topic == self.topic else None

    def assign(self, tps):
        self._assigned = list(tps)
        for tp in tps:
            self._cursor.setdefault(tp, 0)

    def seek(self, tp, offset):
        self._cursor[tp] = int(offset)

    def pause(self, *tps):
        self._paused.update(tps)

    def resume(self, *tps):
        self._paused.difference_update(tps)

    def poll(self, timeout_ms=0, max_records=500):
        out, budget = {}, max_records
        for tp in self._assigned:
            if tp in self._paused or budget <= 0:
                continue
            cur = self._cursor[tp]
            take = self.logs[tp.partition][cur:cur + min(budget, KAFKA_FETCH)]
            if take:
                out[tp] = [_KafkaRecord(cur + i, v) for i, v in
                           enumerate(take)]
                self._cursor[tp] = cur + len(take)
                budget -= len(take)
        return out

    def end_offsets(self, tps):
        return {tp: len(self.logs[tp.partition]) for tp in tps}


def kafka_phase(card, ts, dc, win, ref, cache, device="cuda"):
    """[kafka]: the [stream] feed (the rounds) through KafkaProbeConsumer
    over an in-process fake kafka-python client (JSON bytes, fetches of
    KAFKA_FETCH), consumed by the dict StreamPipeline on the card; beside
    it the same feed through a durable broker (DurableIngestQueue) in
    another dict pipeline. Reports, hist and qhist of the two equal each
    other and [stream]'s; records/s of each beside [stream]'s."""
    from reporter_tpu_torch.config import Config, ServiceConfig
    from reporter_tpu_torch.streaming import (DurableIngestQueue,
                                              KafkaProbeConsumer,
                                              StreamPipeline)

    rounds = ref["rounds"]
    n_records = sum(len(r) for r in rounds)
    os.environ["RTPU_AUTOTUNE_CACHE"] = os.path.join(cache, "stream")
    out, fields = {}, {}
    for kind in ("kafka", "durable"):
        sink, url = _sink()
        cfg = Config(service=ServiceConfig(datastore_url=url))
        parts = cfg.streaming.num_partitions
        if kind == "kafka":
            client = _FakeKafka("probes", parts)
            queue = KafkaProbeConsumer(client, "probes")

            def append(q, recs, client=client):
                client.produce_many(recs)
        else:
            queue = DurableIngestQueue(os.path.join(cache, "kafka_durable"),
                                       num_partitions=parts)

            def append(q, recs):
                q.append_many(recs)
        pipe = StreamPipeline(ts, cfg, queue=queue, device=device)
        tuned = _tuned(pipe.app.matcher, dc)
        feed, counts = win.run(f"sf:kafka:{kind}", lambda: stream_feed(
            pipe, rounds, append, f"kafka:{kind}"))
        _check_drained(pipe, f"kafka:{kind}")
        with sink.lock:
            bodies = list(sink.bodies)
        _close_sink(sink)
        pipe.app.close()
        if kind == "durable":
            queue.close()
        out[kind] = {"reports": _sorted_reports(_report_rows(bodies)),
                     "hist": pipe.hist.snapshot(),
                     "qhist": pipe.qhist.snapshot()}
        fields[kind] = dict(_stream_fields(pipe, feed, n_records, bodies),
                            launches=_launches(counts))
        only(counts, tuned, f"[kafka] the {kind} window")
    k, d = out["kafka"], out["durable"]
    eq = {"reports_kafka_eq_durable": k["reports"] == d["reports"],
          "hist_kafka_eq_durable": bool(np.array_equal(k["hist"], d["hist"])
                                        and np.array_equal(k["qhist"],
                                                           d["qhist"])),
          "reports_eq_stream": k["reports"] == ref["reports"],
          "hist_eq_stream": bool(np.array_equal(k["hist"], ref["hist"])
                                 and np.array_equal(k["qhist"],
                                                    ref["qhist"]))}
    phase("kafka", card, metro="sf", records=n_records,
          fetch_records=KAFKA_FETCH,
          records_per_s={"kafka": fields["kafka"]["records_per_s"],
                         "durable": fields["durable"]["records_per_s"],
                         "stream": ref["records_per_s"]},
          kafka=fields["kafka"], durable=fields["durable"],
          reports=len(k["reports"]), **eq)
    if not (all(eq.values()) and k["reports"]):
        raise SystemExit(f"[kafka] the Kafka-fed run differs: {eq}")


def link_phase(card, since):
    """[link]: a link-health sampler on the card probes LINK_SAMPLES times
    (round trip, host-to-card MB/s, mood: none null); the process
    sampler (started by the first app) with its duty; the dispatch
    watchdog's timeouts of [watchdog] (since ``since``) in its record."""
    from reporter_tpu_torch.utils import linkhealth

    probe = linkhealth.LinkHealthSampler(device="cuda")
    samples = [probe.sample_once().to_json() for _ in range(LINK_SAMPLES)]
    s = linkhealth.sampler()
    notes = [x.to_json() for x in s.samples()
             if x.source == "dispatch_timeout" and x.t >= since]
    since_wd = s.window(since)
    latest = s.latest()
    phase("link", card, probe_bytes=probe.probe_bytes,
          degraded_rtt_ms=probe.degraded_rtt_s * 1e3,
          degraded_mbps=probe.degraded_mbps, samples=samples,
          window=probe.window(),
          process_sampler={
              "device": str(s.device), "running": s.running,
              "period_s": s.period_s, "probes": s.probes_total,
              "dead_probes": s.dead_probes_total,
              "probe_duty_pct": s.probe_duty_pct(),
              "latest": None if latest is None else latest.to_json()},
          dispatch_timeout_notes=len(notes),
          first_note=notes[0] if notes else None,
          window_since_watchdog=since_wd)
    if not (all(x["rtt_ms"] is not None and x["mbps"] is not None
                and x["mood"] in ("healthy", "degraded") for x in samples)
            and notes and since_wd["mood"] == "dead"
            and str(s.device).startswith("cuda")
            and s.probe_duty_pct() is not None):
        raise SystemExit("[link] a probe read null or dead, the process "
                         "sampler is not on the card, or the watchdog's "
                         "timeouts did not reach the link record")


def guard_phase(card, ts, traces, dc, win, cache):
    """[autotune:guard]: a matcher whose first calibration measurement
    hangs GUARD_HANG_S (host side, before its first launch) under
    autotune.CAL_TIMEOUT_S = GUARD_TIMEOUT_S: construction returns within
    the timeout plus GUARD_MARGIN_S, source "timeout", the default plan
    unapplied and uncached; the abandoned measurement lands later (its
    launches counted apart); the matcher's records on GUARD_TRACES traces
    equal an untuned default-plan matcher's, and it launches only the
    default instance."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.matcher import autotune
    from reporter_tpu_torch.matcher.api import SegmentMatcher
    from reporter_tpu_torch.ops import match as match_ops

    d = os.path.join(cache, "guard")
    os.environ["RTPU_AUTOTUNE_CACHE"] = d
    t0 = time.perf_counter()
    pinned = SegmentMatcher(ts, MatcherParams(sweep_autotune=False))
    pinned_s = time.perf_counter() - t0
    real, saved = match_ops.batch_candidates, autotune.CAL_TIMEOUT_S
    hung = {}

    def hanging(*args, **kw):
        if not hung:
            hung["thread"] = threading.current_thread().name
            time.sleep(GUARD_HANG_S)
            hung["resumed"] = time.perf_counter()
        return real(*args, **kw)

    match_ops.batch_candidates = hanging
    autotune.CAL_TIMEOUT_S = GUARD_TIMEOUT_S
    try:
        t0 = time.perf_counter()
        m, cal = win.run("sf:guard:calibration", lambda: SegmentMatcher(ts))
        returned = time.perf_counter()
        construct_s = returned - t0
        abandoned = m._watchdog.abandoned
    finally:
        autotune.CAL_TIMEOUT_S = saved
        match_ops.batch_candidates = real
    # the abandoned measurement runs on (a CUDA call cannot be cancelled):
    # wait for it to land, its launches apart from any window
    before = dict(dc.SWEEP_LAUNCHES)
    deadline = time.perf_counter() + GUARD_HANG_S + 120.0
    while m._watchdog.abandoned and time.perf_counter() < deadline:
        time.sleep(0.05)
    landed_s = time.perf_counter() - returned
    torch.cuda.synchronize()
    late = {f"{a}@k{k}": v - before.get((a, k), 0)
            for (a, k), v in dc.SWEEP_LAUNCHES.items()
            if v != before.get((a, k), 0)}
    batch = traces[:GUARD_TRACES]
    recs, served = win.run("sf:guard:served", lambda: m.match_many(batch))
    want = pinned.match_many(batch)
    equal = json_records(recs) == json_records(want)
    cached = os.listdir(d) if os.path.isdir(d) else []
    default = _tuned(pinned, dc)
    rep = m.tuned_report
    phase("autotune:guard", card, metro="sf", timeout_s=GUARD_TIMEOUT_S,
          hang_s=GUARD_HANG_S, margin_s=GUARD_MARGIN_S,
          construct_s=construct_s, untuned_construct_s=pinned_s,
          source=rep.get("source"), note=rep.get("note"),
          tuned_plan=m.tuned_plan and m.tuned_plan.label,
          abandoned_at_return=abandoned, hung_thread=hung.get("thread"),
          abandoned_landed_after_s=landed_s,
          abandoned_count_after=m._watchdog.abandoned,
          abandoned_thread_launches=late,
          calibration_launches=_launches(cal), cache_files=cached,
          traces=len(batch), records_equal_untuned_default=equal,
          served_launches=_launches(served))
    only(served, default, "[autotune:guard] the guarded matcher")
    if not (construct_s <= GUARD_TIMEOUT_S + GUARD_MARGIN_S
            and rep.get("source") == "timeout" and m.tuned_plan is None
            and abandoned == 1 and m._watchdog.abandoned == 0
            and not cached and equal and recs.n_records
            and not any(cal.values())):
        raise SystemExit("[autotune:guard] construction did not degrade to "
                         "the default plan within its bound, or its records "
                         "differ")


# ---- restricted and per-mode metros, the C++ reach builder, PBF ----------


def tiles_native_phase(card, ts, metro):
    """[tiles:native]: the compiler's node-space reach rows of ``ts`` built
    by the C++ builder (tiles/native.py) and by the Python one
    (tiles/reach.py), byte for byte equal, each timed."""
    from reporter_tpu_torch.config import CompilerParams
    from reporter_tpu_torch.tiles.native import build_reach_native
    from reporter_tpu_torch.tiles.reach import build_reach_tables

    args = (ts.node_out, ts.edge_src, ts.edge_dst, ts.edge_len)
    cp = CompilerParams()
    t0 = time.perf_counter()
    c = build_reach_native(*args, cp.reach_radius, cp.reach_max)
    c_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = build_reach_tables(*args, cp.reach_radius, cp.reach_max)
    py_s = time.perf_counter() - t0
    equal = all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                for a, b in zip(c[:3], py[:3])) and c[3] == py[3]
    # the compile used the C++ rows (no bans here: the tile's rows are them)
    same_as_tile = all(a.tobytes() == getattr(ts, f).tobytes() for a, f in
                       zip(c[:3], ("reach_to", "reach_dist", "reach_next")))
    phase("tiles:native", card, metro=metro, nodes=ts.num_nodes,
          edges=ts.num_edges, reach_max=cp.reach_max,
          truncated_nodes=c[3], c_seconds=c_s, python_seconds=py_s,
          speedup=py_s / c_s, threads=os.cpu_count(),
          bytes_equal=equal, equal_to_the_compiled_tile=same_as_tile,
          compile_seconds=ts.stats.get("compile_seconds"))
    if not (equal and same_as_tile):
        raise SystemExit(f"[tiles:native] {metro}: the C++ and Python reach "
                         "rows differ")


def chain_transitions(ts, traces, decoded):
    """Every transition inside an HMM chain of the decoded paths (two
    consecutive matched points on different edges), rebuilt through the
    reach rows' next hops as the walk rebuilds it: how many, how many
    take a banned turn of ``ts.ban_set``, how many pass a from-edge (a
    private row) and how many cannot be rebuilt (the walk splits there)."""
    from reporter_tpu_torch.matcher.api import _to_chains
    from reporter_tpu_torch.matcher.segments import reach_route_fn

    route, ban = reach_route_fn(ts), ts.ban_set
    from_edges = {a for a, _ in ban}
    out = {"transitions": 0, "banned": 0, "via_private_rows": 0,
           "unrouted": 0}
    for (edges, offs, starts), tr in zip(decoded, traces):
        pts = list(zip(edges.tolist(), offs.tolist(), starts.tolist()))
        for chain in _to_chains(pts, tr.times):
            for e1, e2 in zip(chain.edges, chain.edges[1:]):
                if e1 == e2:
                    continue
                out["transitions"] += 1
                mid = route(e1, e2)
                if mid is None:
                    out["unrouted"] += 1
                    continue
                path = [e1, *mid, e2]
                out["via_private_rows"] += sum(e in from_edges
                                               for e in path[:-1])
                out["banned"] += sum(pair in ban
                                     for pair in zip(path, path[1:]))
    return out


def restrict_phase(card, dc, win, cache, base_ts, base_traces):
    """[restrict]: sf with add_random_restrictions at its defaults, compiled
    by the port (C++ node rows, the ban-affected rows and the private
    from-edge rows in edge space); its legal fleet (seed 0) through the
    main phase (a tuned matcher, BATCH_RUNS batches, pinned matchers) and
    the walk phase; the first REFERENCE_TRACES traces' records equal the
    CPU port's; no transition inside a chain takes a banned turn; the
    banned-turn oracle's agreement on ORACLE_TRACES["sf+r"] traces.
    [restrict:ab]: the batch of sf (``base_ts``, ``base_traces``) and of
    sf+r through matchers pinned to one arm (sub, K = 8), in turns (sf,
    sf+r, sf+r, sf) AB_ROUNDS times: their medians side by side."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
    from reporter_tpu_torch.netgen.synthetic import (add_random_restrictions,
                                                     generate_city)
    from reporter_tpu_torch.netgen.traces import synthesize_fleet
    from reporter_tpu_torch.tiles.compiler import compile_network
    from reporter_tpu_torch.tiles.tileset import tables_from_numpy

    net = add_random_restrictions(generate_city("sf"))
    t0 = time.perf_counter()
    ts = compile_network(net)
    compile_s = time.perf_counter() - t0
    tab = tables_from_numpy(ts.arrays(), "cuda")
    rows = len(ts.reach_to)
    table_bytes = sum(int(t.numel() * t.element_size()) for t in tab.values())
    t0 = time.perf_counter()
    fleet = synthesize_fleet(ts, N_TRACES, num_points=N_POINTS, seed=0)
    fleet_s = time.perf_counter() - t0
    illegal = sum(pair in ts.ban_set for p in fleet
                  for pair in zip(p.path_edges.tolist(),
                                  p.path_edges[1:].tolist()))
    phase("restrict:tiles", card, metro=ts.name,
          restrictions=ts.stats["restrictions"],
          banned_turn_pairs=ts.stats["banned_turn_pairs"],
          from_edges=rows - ts.num_nodes, nodes=ts.num_nodes, rows=rows,
          edges=ts.num_edges, device_table_bytes=table_bytes,
          reach_truncated_nodes=ts.stats["reach_truncated_nodes"],
          compile_s=compile_s, fleet_s=fleet_s,
          fleet_banned_turns=illegal)
    if not (rows > ts.num_nodes and ts.ban_set) or illegal:
        raise SystemExit("[restrict] no private rows, or the fleet took a "
                         "banned turn")
    del tab
    os.environ["RTPU_AUTOTUNE_CACHE"] = os.path.join(cache, "restrict")
    m, traces, recs, fields, _ = main_phase(
        card, ts, fleet, dc, win, ts.name, MatcherParams, SegmentMatcher,
        Trace, request=False)
    walk_phase(card, m, ts, traces, recs, fields, MatcherParams,
               SegmentMatcher, ts.name)
    small = traces[:REFERENCE_TRACES]
    cpu_recs = SegmentMatcher(ts, device="cpu").match_many(small)
    cpu_ok = json_records(cpu_recs) == json_records(recs[:REFERENCE_TRACES])
    t0 = time.perf_counter()
    moves = chain_transitions(ts, traces, m._decode_many(traces))
    # lint: allow[bench-coverage] 2026-10-18 chain_transitions' tallies;
    # [bench_delta] reads the printed line
    phase("restrict", card, metro=ts.name, card_vs_cpu_records_equal=cpu_ok,
          traces_checked=len(small), check_s=time.perf_counter() - t0,
          **moves)
    if not cpu_ok or moves["banned"] or not moves["via_private_rows"]:
        raise SystemExit(f"[restrict] card != CPU records, or a banned turn "
                         f"inside a chain: {moves}")
    oracle_phase(card, ts, traces, recs, cpu_recs, ts.name)
    os.environ["RTPU_AUTOTUNE_CACHE"] = cache
    pinned = {name: (SegmentMatcher(t, MatcherParams(sweep_autotune=False)),
                     tr) for name, t, tr in (("sf", base_ts, base_traces),
                                             (ts.name, ts, traces))}
    for pm, tr in pinned.values():
        pm.match_many(tr)                         # warm
    walls = {name: [] for name in pinned}
    for r in range(AB_ROUNDS):
        for i, name in enumerate(("sf", ts.name, ts.name, "sf")):
            pm, tr = pinned[name]
            t0 = time.perf_counter()
            _, counts = win.run(f"{ts.name}:ab:{name}:{r}{i}",
                                lambda pm=pm, tr=tr: pm.match_many(tr))
            walls[name].append((time.perf_counter() - t0) * 1e3)
            only(counts, ("sub", 8), f"[restrict:ab] {name}")
    med = {name: statistics.median(v) for name, v in walls.items()}
    phase("restrict:ab", card, arm="sub", k=8, rounds=AB_ROUNDS,
          order="sf, sf+r, sf+r, sf", batch_ms=walls, median_ms=med,
          ratio=med[ts.name] / med["sf"])
    return ts


def osmlr_by_road(ts):
    """{(way id, src xy, dst xy): OSMLR id or -1} of every directed edge:
    a key that holds across mode tiles (node ids are compacted per mode,
    positions are in the full network's frame)."""
    out = {}
    for e in range(ts.num_edges):
        r = int(ts.edge_osmlr[e])
        key = (int(ts.edge_way[e]), *ts.node_xy[ts.edge_src[e]].tolist(),
               *ts.node_xy[ts.edge_dst[e]].tolist())
        out[key] = int(ts.osmlr_id[r]) if r >= 0 else -1
    return out


def modes_phase(card, dc, win, cache):
    """[modes]: sf with assign_mode_access at its defaults, compiled for
    each of MODES from the full network (edges per mode); a road's OSMLR
    id is the same in every mode tile. For each of MODES_SERVED: a fleet
    synthesized on that mode's tile through a tuned matcher with
    MatcherParams.preset(mode), launching only its tuned instance, whose
    first MODES_CPU_TRACES records equal the CPU port's; make_app with
    Config.for_mode(mode) on the card answers /report with that mode and
    a request naming another mode with 400. → what [modes:server] checks:
    the bicycle tile and MODES_SERVER_REQUESTS payloads with the app's
    answers."""
    from reporter_tpu_torch.config import Config, MatcherParams
    from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
    from reporter_tpu_torch.netgen.synthetic import (assign_mode_access,
                                                     generate_city)
    from reporter_tpu_torch.netgen.traces import synthesize_fleet
    from reporter_tpu_torch.service.app import make_app
    from reporter_tpu_torch.tiles.compiler import compile_network

    net = assign_mode_access(generate_city("sf"))
    tiles, compile_s = {}, {}
    for mode in MODES:
        t0 = time.perf_counter()
        tiles[mode] = compile_network(net, mode=mode)
        compile_s[mode] = time.perf_counter() - t0
    ids = {mode: osmlr_by_road(ts) for mode, ts in tiles.items()}
    shared = mismatched = 0
    for key, want in ids["auto"].items():
        for mode in MODES[1:]:
            if key in ids[mode]:
                shared += 1
                mismatched += ids[mode][key] != want
    for key, want in ids["bicycle"].items():
        if key in ids["foot"] and key not in ids["auto"]:
            shared += 1
            mismatched += ids["foot"][key] != want
    same_tables = all(
        tiles[m].osmlr_id.tobytes() == tiles["auto"].osmlr_id.tobytes()
        for m in MODES)
    phase("modes:tiles", card, metro=net.name,
          edges={m: t.num_edges for m, t in tiles.items()},
          nodes={m: t.num_nodes for m, t in tiles.items()},
          ways={m: len(set(t.edge_way.tolist())) for m, t in tiles.items()},
          compile_s=compile_s, shared_road_edges=shared,
          osmlr_id_mismatches=mismatched, osmlr_tables_equal=same_tables)
    if mismatched or not shared or not same_tables:
        raise SystemExit("[modes] a road's OSMLR id differs across modes")
    out = None
    for mode in MODES_SERVED:
        ts = tiles[mode]
        params = MatcherParams.preset(mode)
        os.environ["RTPU_AUTOTUNE_CACHE"] = os.path.join(cache, f"mode_{mode}")
        t0 = time.perf_counter()
        fleet = synthesize_fleet(ts, N_TRACES, num_points=N_POINTS, seed=0)
        fleet_s = time.perf_counter() - t0
        traces = [Trace(uuid=p.uuid, xy=p.xy.astype(np.float32),
                        times=p.times) for p in fleet]
        m, cal = win.run(f"{ts.name}:calibration",
                         lambda ts=ts, p=params: SegmentMatcher(ts, p))
        if m.tuned_plan is None or m.tuned_report.get("errors"):
            raise SystemExit(f"[modes] {mode}: calibration {m.tuned_report}")
        inst = _plan_instance(m.tuned_plan.label)
        m.match_many(traces[:64])                 # warm the allocator
        t0 = time.perf_counter()
        recs, served = win.run(f"{ts.name}:tuned_batch",
                               lambda m=m: m.match_many(traces))
        batch_ms = (time.perf_counter() - t0) * 1e3
        only(served, inst, f"[modes] {mode}: the tuned matcher's batch")
        small = traces[:MODES_CPU_TRACES]
        cpu = SegmentMatcher(ts, params, device="cpu").match_many(small)
        cpu_ok = json_records(cpu) == json_records(recs[:MODES_CPU_TRACES])
        app, app_cal = win.run(f"{ts.name}:app:calibration",
                               lambda ts=ts, mode=mode: make_app(
                                   ts, Config.for_mode(mode), device="cuda"))
        payloads = [{**fleet[i].to_report_json(), "uuid": f"{mode}-{i}"}
                    for i in range(MODES_SERVER_REQUESTS)]
        try:
            answers, app_served = win.run(
                f"{ts.name}:app", lambda: [wsgi_post(app, "/report", p)
                                           for p in payloads])
            wrong = wsgi_post(app, "/report", {**payloads[0], "uuid": "x",
                                               "mode": "auto"})
            app_inst = _plan_instance(app.matcher.tuned_plan.label)
        finally:
            app.close()
        tagged = all(st == 200 and body.get("mode") == mode
                     for st, body in answers)
        only(app_served, app_inst, f"[modes] {mode}: the app's requests")
        phase("modes", card, metro=ts.name, mode=mode,
              search_radius=params.search_radius, edges=ts.num_edges,
              fleet_s=fleet_s, plan=m.tuned_plan.label, batch_ms=batch_ms,
              records=recs.n_records, card_vs_cpu_records_equal=cpu_ok,
              traces_checked=len(small), app_plan=app.matcher.tuned_plan.label,
              app_answers_tagged=tagged, wrong_mode_status=wrong[0],
              calibration_launches={f"{a}@k{k}": n
                                    for (a, k), n in cal.items() if n})
        if not (cpu_ok and tagged and wrong[0] == 400 and recs.n_records):
            raise SystemExit(f"[modes] {mode}: card != CPU records, an "
                             "untagged answer, or no 400 for another mode")
        if mode == "bicycle":
            out = {"tile": ts, "payloads": payloads,
                   "answers": [body for _, body in answers]}
    os.environ["RTPU_AUTOTUNE_CACHE"] = cache
    return out


def _await_health(proc, base, limit, log_path, tag):
    """Poll GET /health of a starting entry point until it answers 200.
    → (its JSON, seconds); a process that exits or stays silent past
    ``limit`` seconds fails the phase ``tag``."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < limit:
        if proc.poll() is not None:
            break
        try:
            st, health = http_json(base + "/health", timeout=5.0)
            if st == 200:
                return health, time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.5)
    raise SystemExit(f"[{tag}] /health did not answer within {limit} s "
                     f"(exit {proc.poll()}):\n" + _tail(log_path))


def modes_server_phase(card, bike, cache):
    """[modes:server]: python -m reporter_tpu_torch.service.server --mode
    bicycle --tiles <the bicycle tile, saved> as a subprocess on the card
    (its own calibration): /report answers equal the in-process [modes]
    app's, another mode gets 400, SIGINT to exit 0."""
    root = os.path.join(SCRATCH, "modes")
    os.makedirs(root, exist_ok=True)
    path = bike["tile"].save(os.path.join(root, "bicycle"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here,
               RTPU_AUTOTUNE_CACHE=os.path.join(cache, "modes_server"))
    log_path = os.path.join(root, "server.log")
    base = f"http://127.0.0.1:{port}"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "reporter_tpu_torch.service.server",
             "--mode", "bicycle", "--tiles", path, "--host", "127.0.0.1",
             "--port", str(port)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=here)
        try:
            health, start_s = _await_health(proc, base, SERVER_START_S,
                                            log_path, "modes:server")
            got = [http_json(base + "/report", p) for p in bike["payloads"]]
            wrong = http_json(base + "/report",
                              {**bike["payloads"][0], "uuid": "x",
                               "mode": "auto"})
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    equal = [st == 200 and body == want
             for (st, body), want in zip(got, bike["answers"])]
    phase("modes:server", card, tile_bytes=os.path.getsize(path),
          start_to_health_s=start_s, device=health.get("device"),
          requests=len(got), answers_equal_in_process=all(equal),
          wrong_mode_status=wrong[0], sigint_exit_code=rc)
    if not all(equal) or wrong[0] != 400 or rc != 0:
        raise SystemExit(f"[modes:server] answers equal {equal}, another "
                         f"mode {wrong[0]}, exit {rc}:\n" + _tail(log_path))


def pbf_phase(card):
    """[pbf] (host): the element sets of tests/fixtures/irregular.osm and
    of tests/fixtures/adversarial_osm.py (restriction relations,
    non-drivable ways) written with write_osm_pbf, parsed back and
    compiled (the adversarial one for each of MODES): every TileSet array
    equals the compile of the XML form, except where the reader's decode
    1e-9 * (offset + granularity * raw), the JAX package's, lands a few
    doubles off the XML's decimal parse of a 7-decimal coordinate: a
    line-segment coordinate may then move by PBF_DECODE_M plus one f32
    rounding (held to that, and counted)."""
    import importlib.util
    import warnings

    from reporter_tpu_torch.config import CompilerParams
    from reporter_tpu_torch.netgen.osm_xml import parse_osm_xml, xml_elements
    from reporter_tpu_torch.netgen.pbf import parse_osm_pbf, write_osm_pbf
    from reporter_tpu_torch.tiles.compiler import compile_network
    from reporter_tpu_torch.tiles.tileset import ARRAY_FIELDS

    here = os.path.dirname(os.path.abspath(__file__))
    fix = os.path.join(here, "tests", "fixtures")
    spec = importlib.util.spec_from_file_location(
        "adversarial_osm", os.path.join(fix, "adversarial_osm.py"))
    adv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(adv)
    with open(os.path.join(fix, "golden_irregular.json")) as f:
        kw = json.load(f)[0]["compiler"]
    osm = os.path.join(fix, "irregular.osm")
    cases = [("irregular", xml_elements(osm), osm, (None,)),
             ("adversarial", adv.build_elements(), adv.as_xml(), MODES)]
    root = os.path.join(SCRATCH, "pbf")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    report, bad = {}, []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the extracts' own warnings
        for name, elements, xml, modes in cases:
            path = os.path.join(root, f"{name}.osm.pbf")
            write_osm_pbf(path, *elements)
            from_pbf, from_xml = parse_osm_pbf(path, name), parse_osm_xml(
                xml, name)
            for mode in modes:
                a = compile_network(from_pbf, CompilerParams(**kw), mode=mode)
                b = compile_network(from_xml, CompilerParams(**kw), mode=mode)
                near = {}
                for f in ARRAY_FIELDS:
                    x, y = getattr(a, f), getattr(b, f)
                    if x.dtype == y.dtype and x.tobytes() == y.tobytes():
                        continue
                    if (f in ("seg_a", "seg_b", "node_xy")
                            and x.shape == y.shape and np.all(
                                np.abs(x - y) <= PBF_DECODE_M
                                + np.spacing(np.abs(y)))):
                        near[f] = int((x != y).sum())
                    else:
                        bad.append(f"{name}/{mode}/{f}")
                report[f"{name}/{mode or 'as-is'}"] = {
                    "edges": a.num_edges, "banned_turn_pairs": len(a.ban_set),
                    "bytes": os.path.getsize(path),
                    "elements_within_decode_bound": near}
    phase("pbf", card, cases=report, seconds=time.perf_counter() - t0,
          arrays_held=not bad)
    if bad:
        raise SystemExit(f"[pbf] PBF and XML compiles differ: {bad}")


def grid_native_phase(card, ts, metro):
    """[grid:native]: the spatial grid of ``ts`` filled by the C++ builder
    (tiles/native.py) and by the Python loop (tiles/compiler.py), each
    with the compiler's capacity doubling, byte for byte equal (grid,
    dims, origin, dropped registrations, capacity) and equal to the
    compiled tile's; both timed."""
    from reporter_tpu_torch.config import CompilerParams
    from reporter_tpu_torch.tiles.compiler import _build_sized_grid

    cp = CompilerParams()
    out = {}
    for native in (True, False):
        t0 = time.perf_counter()
        g = _build_sized_grid(ts.seg_a, ts.seg_b, cp, use_native=native)
        out[native] = (g, time.perf_counter() - t0)
    (gc, c_s), (gp, py_s) = out[True], out[False]
    equal = (gc[0].shape == gp[0].shape
             and gc[0].tobytes() == gp[0].tobytes() and gc[1] == gp[1]
             and gc[2].tobytes() == gp[2].tobytes() and gc[3:] == gp[3:])
    same_as_tile = gc[0].tobytes() == ts.grid.tobytes()
    phase("grid:native", card, metro=metro, cells=int(gc[0].shape[0]),
          dims=list(gc[1]), capacity=gc[4],
          capacity_start=cp.cell_capacity, overflow=int(gc[3]),
          c_seconds=c_s, python_seconds=py_s, speedup=py_s / c_s,
          bytes_equal=equal, equal_to_the_compiled_tile=same_as_tile)
    if not (equal and same_as_tile):
        raise SystemExit(f"[grid:native] {metro}: the C++ and Python grids "
                         "differ")


def launch_calls(fn):
    """fn() under the profiler after a synchronize: → (its result, the
    work the host put on the card in it: the runtime's kernel launches
    and its copies and fills (LaunchKernel, Memcpy and Memset records),
    the kernel launches alone). PyTorch runs one copy as a memcpy or as
    a copy kernel by the tensors' layout, so the sum is what does not
    depend on a length; the host records are whole even in a later
    profiler session of the process, which may lose its window's first
    device records."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    kernels = sum(e.count for e in ka if "LaunchKernel" in e.key)
    copies = sum(e.count for e in ka if e.key.startswith("cudaMem")
                 and ("cpy" in e.key or "set" in e.key))
    return out, kernels + copies, kernels


def _mismatches(got, want) -> dict:
    return {f: int((g != w).sum()) for f, g, w in zip(
        getattr(want, "_fields", range(len(want))), got, want)}


def _bound(ops: float, nbytes: float) -> "tuple[float, str]":
    by_ops = ops / H100_F32_FLOPS * 1e3
    by_bytes = nbytes / H100_HBM_BYTES_S * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def _topk_trace(m, xy, bucket):
    """One trace as match_topk stages it on the card: → (points f32 [T,
    2], valid [T], its candidates [T, K])."""
    from reporter_tpu_torch.ops import match as match_ops

    pts = np.zeros((1, bucket, 2), np.float32)
    pts[0, :len(xy)] = xy
    valid = np.zeros((1, bucket), bool)
    valid[0, :len(xy)] = True
    pj, vj = torch.from_numpy(pts).cuda(), torch.from_numpy(valid).cuda()
    c = match_ops.batch_candidates(pj, vj, m.tables, m.params, m.ts.meta)
    return pj[0], vj[0], match_ops.CandidateSet(*(x[0] for x in c))


def lattice_kernel_phase(card, ts, m, traces):
    """[kernel:lattice]: the ranked-path lattice's three kernels
    (kernels/lattice.cu) against their plain versions on the card, on the
    inputs match_topk gives them: the first fleet trace (T = 128) and the
    [topk] long trace (T = 1024) at K = 8 (the tuned matcher, 50 m), the
    long trace at K = 64 and 96 (150 m; 96 the forward's wide instance,
    also at LONG_LIST_RADIUS, where its longest list must be over 64),
    each at the R of LATTICE_CASES (1: the terminal form, K: the exact
    one): the longest list, mismatches per field (all must be 0), the launches of one call of each wrapper (each must be 1), ms
    single and back to back, the plain version's ms, the bound, the
    forward and backtrack plans, the forward kernel's peak bytes beside
    the plain inputs' (``_lattice_prep``'s [T, K, K, M] temporaries),
    the steps that look up and their pairs, the forward's bound beside
    that of a forward reading transition blocks, the backtrack's beside
    the bytes it streams, and the phase's seconds. The forward kernel reads the
    candidates and looks its blocks up itself: it is held to
    ``_lattice_prep`` + ``_forward_list_plain`` (and ``active``). → {kernel:
    the K = 8, T = 1024 record at the largest R, with the K = 64 one under
    "k64" and the K = 96 ones under "k96_r1" and "k96_r96" (at 250 m
    "k96_r1_250m", "k96_r96_250m"), each with its instance's launch key}
    for the kernels line."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.matcher.api import SegmentMatcher
    from reporter_tpu_torch.netgen.traces import synthesize_probe
    from reporter_tpu_torch.ops import hmm
    from reporter_tpu_torch.ops import match as match_ops
    from reporter_tpu_torch.ops.dense_candidates import sqrt_f32

    t_all = time.perf_counter()
    long_xy = synthesize_probe(ts, seed=7, num_points=TOPK_LONG_POINTS).xy
    out = {}
    for k, radius, rs in LATTICE_CASES:
        mk = m if radius is None else SegmentMatcher(
            ts, MatcherParams(sweep_autotune=False, max_candidates=k,
                              search_radius=radius))
        p = mk.params
        sets = [("t1024", long_xy, 1024)]
        if radius is None:
            sets.insert(0, ("t128", traces[0].xy, BUCKET))
        for name, xy, bucket in sets:
            t_k = time.perf_counter()
            pts, valid, tc = _topk_trace(mk, xy, bucket)
            longest = int(tc.valid.sum(-1).max())
            if radius == LONG_LIST_RADIUS and longest <= 64:
                raise SystemExit(f"[kernel:lattice] K={k} at {radius:g} "
                                 f"m: the longest list is {longest}, not "
                                 f"past 64")
            interp = p.interpolation_distance
            keep_before = hmm.LATTICE_LAUNCHES.get("keep", 0)
            keep = hmm.interpolation_keep_mask(pts, valid, interp)
            keep_calls = hmm.LATTICE_LAUNCHES.get("keep", 0) - keep_before
            keep_plain = hmm._keep_mask_batched(pts[:, :, None],
                                                valid[:, None], interp)[:, 0]
            torch.cuda.synchronize()
            keep_mis = int((keep != keep_plain).sum())
            T = int(pts.shape[0])
            keep_ms = cuda_ms(lambda: hmm.interpolation_keep_mask(
                pts, valid, interp), reps=20)
            keep_b2b = launch_ms(lambda: hmm.interpolation_keep_mask(
                pts, valid, interp))
            keep_plain_ms = cuda_ms(lambda: hmm._keep_mask_batched(
                pts[:, :, None], valid[:, None], interp), reps=2, warmup=1)
            keep_bound = _bound(T * LATTICE_OPS_PER_KEEP, T * (8 + 1 + 1))
            consts = (p.sigma_z, p.beta, p.max_route_distance_factor,
                      p.breakage_distance, p.backward_slack)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            em, act, pany, trans = hmm._lattice_prep(
                tc, pts, keep_plain, mk.tables, *consts)
            torch.cuda.synchronize()
            prep_peak = torch.cuda.max_memory_allocated() - base
            n_act = int(act.sum())
            # the steps that look up (active, an active point before, gc
            # within the breakage distance), and the lookups' work and
            # bytes: viterbi_work on a batch of one, less its outputs
            idx = torch.arange(T, device=pts.device)
            run = torch.cummax(torch.where(act, idx, -1), dim=0).values
            prev = torch.cat([idx[:1] * 0, run[:-1].clamp_min(0)])
            gc = sqrt_f32(((pts - pts[prev]) ** 2).sum(-1))
            n_look = int((act & pany & (gc <= p.breakage_distance)).sum())
            pairs, lookup_ops, lookup_bytes, _ = viterbi_work(
                match_ops.CandidateSet(*(x[None] for x in tc)), pts[None],
                valid[None], mk.tables, interp, p.breakage_distance)
            lookup_bytes -= T * (4 + 4 + 4 + 1 + 1)
            lg = (k - 1).bit_length()
            for R in rs:
                fwd_args = (tc, pts, keep, mk.tables, *consts, R)
                before = dict(hmm.LATTICE_LAUNCHES)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                got = hmm._forward_list_cuda(*fwd_args)
                torch.cuda.synchronize()
                kernel_peak = torch.cuda.max_memory_allocated() - base
                want = (*hmm._forward_list_plain(em, act, pany, trans, R),
                        act)
                torch.cuda.synchronize()
                fwd_mis = dict(zip(("scores", "backptrs", "started", "own",
                                    "active"),
                                   (int((g != w).sum())
                                    for g, w in zip(got, want))))
                fwd_err = float((got[0].double() - want[0].double()).abs()
                                .max())
                S = k * R
                seed = torch.sort(want[0][-1], stable=True).indices[
                    :k if R == 1 else R].to(torch.int32)
                bt_args = (want[1], want[2], act, want[3], seed)
                bt = hmm._backtrack_cuda(*bt_args)
                # each kernel's launches over its instances' keys
                # ("forward:wide", "backtrack:global", ...)
                calls = {kern: sum(
                    n - before.get(key, 0)
                    for key, n in hmm.LATTICE_LAUNCHES.items()
                    if key.split(":")[0] == kern)
                    for kern in ("forward", "backtrack")}
                calls["keep"] = keep_calls
                bt_plain = hmm._backtrack_plain(*bt_args)
                torch.cuda.synchronize()
                bt_mis = int((bt != bt_plain).sum())
                P = int(seed.shape[0])
                fwd_ms = cuda_ms(lambda: hmm._forward_list_cuda(*fwd_args),
                                 reps=20)
                fwd_b2b = launch_ms(lambda: hmm._forward_list_cuda(
                    *fwd_args))
                fwd_plain_ms = cuda_ms(lambda: hmm._forward_list_plain(
                    *hmm._lattice_prep(tc, pts, keep_plain, mk.tables,
                                       *consts), R), reps=2, warmup=1)
                bt_ms = cuda_ms(lambda: hmm._backtrack_cuda(*bt_args),
                                reps=20)
                bt_b2b = launch_ms(lambda: hmm._backtrack_cuda(*bt_args))
                bt_plain_ms = cuda_ms(lambda: hmm._backtrack_plain(
                    *bt_args), reps=2, warmup=1)
                # the forward's work: the lookups (each looked-up pair's
                # binary search, route and cost) and, per step that looks
                # up, each column's merge (R = 1: K adds and compares; R >
                # 1: K heads, a tree's K - 1 matches, and per pick an add,
                # ceil(log2 K) matches and the row's next head); bytes:
                # the candidates, points, keep mask and the table entries
                # the searches read, once, and the five outputs
                merge_ops = n_look * k * (2 * k if R == 1
                                          else 2 * k + R * (lg + 2))
                fwd_bound = _bound(lookup_ops + merge_ops,
                                   lookup_bytes + T * S * 8 + T * 6)
                # a forward that reads transition blocks [T, K, K]: the
                # heads, R picks over K heads and R advances a column, then
                # the K * R writes
                fwd_bound_blocks = _bound(
                    n_act * k * (k + R * k + 2 * R),
                    T * k * 4 + 2 * T + T * k * k * 4 + T * S * 8 + T * 5)
                # the backtrack's: a step a path and level; bytes: its
                # output, the level flags and own states, and the distinct
                # backpointer entries the paths read; beside it what the
                # kernel streams, every level's whole backpointer row
                reads = bt_plain[:, 1:].long()
                lv = torch.arange(1, T, device=reads.device).expand_as(reads)
                n_reads = int(torch.unique(
                    (lv * S + reads)[reads >= 0]).numel())
                bt_bound = _bound(P * T * 4, P * T * 4 + T * 6 + n_reads * 4)
                bt_streamed = _bound(P * T * 4,
                                     P * T * 4 + T * 6 + T * S * 4)
                plan = hmm.lattice_plan(T, k, R)
                bt_plan = hmm.backtrack_plan(T, S, P)
                bt_key = hmm.backtrack_key(bt_plan)
                rec = {
                    "keep": {"mismatches": keep_mis, "max_abs_err": 0.0,
                             "ms": keep_ms, "ms_back_to_back": keep_b2b,
                             "plain_ms": keep_plain_ms,
                             "bound_ms": keep_bound[0],
                             "bound_by": keep_bound[1]},
                    "forward": {"mismatches": sum(fwd_mis.values()),
                                "max_abs_err": fwd_err, "ms": fwd_ms,
                                "ms_back_to_back": fwd_b2b,
                                "plain_ms": fwd_plain_ms,
                                "bound_ms": fwd_bound[0],
                                "bound_by": fwd_bound[1],
                                "block_read_bound_ms": fwd_bound_blocks[0]},
                    "backtrack": {"mismatches": bt_mis, "max_abs_err": 0.0,
                                  "ms": bt_ms, "ms_back_to_back": bt_b2b,
                                  "plain_ms": bt_plain_ms,
                                  "bound_ms": bt_bound[0],
                                  "bound_by": bt_bound[1],
                                  "streamed_bound_ms": bt_streamed[0]}}
                phase("kernel:lattice", card, metro="sf", k=k, r=R,
                      search_radius=p.search_radius, kind=name, steps=T,
                      longest_list=longest, active_steps=n_act, lookup_steps=n_look,
                      lattice_pairs=pairs,
                      chain_starts=int(want[2].sum()), paths=P,
                      forward_mismatches=fwd_mis,
                      keep_mismatches=keep_mis,
                      backtrack_mismatches=bt_mis,
                      forward_plan=plan, backtrack_plan=bt_plan,
                      kernel_peak_bytes=kernel_peak,
                      prep_peak_bytes=prep_peak, call_launches=calls, **rec,
                      seconds=time.perf_counter() - t_k)
                if any(n != 1 for n in calls.values()):
                    raise SystemExit(f"[kernel:lattice] one call of each "
                                     f"wrapper launched {calls}")
                if keep_mis or any(fwd_mis.values()) or bt_mis or fwd_err:
                    raise SystemExit(
                        f"[kernel:lattice] a lattice kernel differs from its "
                        f"plain version at K={k}, R={R}, T={T}: keep "
                        f"{keep_mis}, forward {fwd_mis}, backtrack {bt_mis}")
                if not bool(want[2].any()) or not bool((bt >= 0).any()):
                    raise SystemExit(f"[kernel:lattice] the lattice at "
                                     f"K={k}, R={R}, T={T} chose nothing")
                if name == "t1024":
                    if k == 8:
                        out = {key: dict(v, k=k, r=R, T=T)
                               for key, v in rec.items()}
                    elif k <= hmm.LATTICE_MAX_K:
                        for key, v in rec.items():
                            out[key][f"k{k}"] = dict(v, r=R, T=T)
                    else:
                        # the wide instances, each R's apart: the forward's
                        # wide one, the backtrack's of this plan
                        at = "" if radius == WIDE_RADIUS \
                            else f"_{radius:g}m"
                        for key, v in rec.items():
                            out[key][f"k{k}_r{R}{at}"] = dict(
                                v, r=R, T=T, instance=(
                                    bt_key if key == "backtrack" else
                                    "forward:wide" if key == "forward"
                                    else "keep"))
    phase("kernel:lattice:all", card, seconds=time.perf_counter() - t_all)
    return out


def _grid_work(cands, pts, pack, gm, k):
    """What one grid batch must do and move: each point's C slots
    measured and tested, and per point the selection rounds its list
    takes (its picks, and the round that ends it below K), each over the
    C slots; the bytes: the points, the distinct cell rows the points
    read, the four outputs. → (operations, bytes)."""
    C = pack.shape[1] // 8
    N = pts.shape[0]
    rounds = torch.clamp_max(cands.valid.reshape(N, k).sum(1) + 1, k)
    cell_f = torch.full((), gm.cell_size, dtype=torch.float32,
                        device=pts.device)

    def axis(v, o, n):
        q = torch.floor((v - torch.full((), o, dtype=torch.float32,
                                        device=pts.device)) / cell_f)
        return torch.clamp(q, -1.0, float(n)).to(torch.int64).clamp(0, n - 1)

    cells = axis(pts[:, 0], gm.ox, gm.gw) * gm.gh + axis(pts[:, 1], gm.oy,
                                                          gm.gh)
    n_cells = int(torch.unique(cells).numel())
    ops = N * C * GRID_OPS_PER_SLOT \
        + int(rounds.sum()) * C * GRID_OPS_PER_ROUND_SLOT
    nbytes = N * 8 + n_cells * 8 * C * 4 + N * k * (4 + 4 + 4 + 1)
    return ops, nbytes, n_cells


def grid_kernel_phase(card, ts, pts):
    """[kernel:grid]: the grid backend's kernel (kernels/grid.cu) against
    its plain version on the card, on the 131,072 points of [kernel] at
    each (K, radius) of GRID_CASES (150 m on a tile compiled with that
    index radius): mismatches per field (all must be 0), ms single and
    back to back, the plain version's ms, the bound, the row width C,
    and the kernel launches of one candidate stage (``batch_candidates``,
    the profiler's count), equal at every K. → the K = 8 record, the K =
    64 one under "k64", for the kernels line."""
    from reporter_tpu_torch.config import CompilerParams, Config, MatcherParams
    from reporter_tpu_torch.matcher.api import SegmentMatcher
    from reporter_tpu_torch.netgen.synthetic import generate_city
    from reporter_tpu_torch.ops import candidates as cand
    from reporter_tpu_torch.ops import match as match_ops
    from reporter_tpu_torch.tiles.compiler import compile_network

    t_all = time.perf_counter()
    out, stage_launches = {}, {}
    for k, radius in GRID_CASES:
        t_k = time.perf_counter()
        compiler = CompilerParams() if radius is None else CompilerParams(
            index_radius=radius)
        tsg = ts if radius is None else compile_network(generate_city("sf"),
                                                        compiler)
        levers = {} if radius is None else {"search_radius": radius}
        gmm = SegmentMatcher(tsg, Config(compiler=compiler, matcher=(
            MatcherParams(candidate_backend="grid", max_candidates=k,
                          **levers))))
        p, gm = gmm.params, cand.as_grid_meta(tsg.meta)
        pack = gmm.tables["cell_pack"]
        args = (pts, gmm.tables, tsg.meta, p.search_radius, k)
        before = cand.GRID_LAUNCHES.get(k, 0)
        got = cand.find_candidates(*args)
        want = cand._find_candidates_plain(*args)
        torch.cuda.synchronize()
        launched = cand.GRID_LAUNCHES.get(k, 0) - before
        mis = _mismatches(got, want)
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
        ms = cuda_ms(lambda: cand.find_candidates(*args), reps=20)
        b2b = launch_ms(lambda: cand.find_candidates(*args))
        plain_ms = cuda_ms(lambda: cand._find_candidates_plain(*args),
                           reps=2, warmup=1)
        ops, nbytes, n_cells = _grid_work(want, pts, pack, gm, k)
        bound_ms, bound_by = _bound(ops, nbytes)
        bpts = pts.reshape(N_TRACES, BUCKET, 2)
        bval = torch.ones(bpts.shape[:2], dtype=torch.bool, device="cuda")
        _, stage_launches[k], _ = launch_calls(
            lambda: match_ops.batch_candidates(bpts, bval, gmm.tables, p,
                                               tsg.meta))
        rec = dict(mismatches=sum(mis.values()), max_abs_err=err, ms=ms,
                   ms_back_to_back=b2b, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        phase("kernel:grid", card, metro="sf", k=k,
              search_radius=p.search_radius, points=int(pts.shape[0]),
              capacity=int(pack.shape[1]) // 8, cells_read=n_cells,
              candidates=int(want.valid.sum()),
              edge_mismatches=mis["edge"], offset_mismatches=mis["offset"],
              dist_mismatches=mis["dist"], valid_mismatches=mis["valid"],
              operations=ops, bytes=nbytes, library_ms=None,
              call_launches=launched,
              stage_kernel_launches=stage_launches[k], **rec,
              seconds=time.perf_counter() - t_k)
        if any(mis.values()) or err or launched != 1:
            raise SystemExit(f"[kernel:grid] the grid kernel differs from "
                             f"its plain version at K={k}: {mis}, or "
                             f"launched {launched} times in one call")
        if not bool(want.valid.any()):
            raise SystemExit(f"[kernel:grid] no candidate at K={k}")
        if radius is None:
            out = dict(rec, k=k)
        else:
            out[f"k{k}"] = dict(rec, search_radius=radius)
    phase("kernel:grid:stage", card, stage_kernel_launches=stage_launches,
          seconds=time.perf_counter() - t_all)
    if len(set(stage_launches.values())) != 1:
        raise SystemExit(f"[kernel:grid] the candidate stage's launches "
                         f"differ across K: {stage_launches}")
    return out


def _sorted_sets(cands):
    """Per point, the candidate edges and their distances sorted (empty
    slots last): comparable across backends whatever the slot order."""
    big = torch.iinfo(torch.int32).max
    e = torch.where(cands.valid, cands.edge, big)
    d = torch.where(cands.valid, cands.dist, torch.zeros_like(cands.dist))
    return torch.sort(e, dim=1).values, torch.sort(d, dim=1).values


def grid_phase(card, ts, pts, m, traces, recs, dc, win):
    """[grid]: sf's grid (C++ against Python), then a matcher with
    candidate_backend="grid" on the card: GRID_BATCH_RUNS timed batches
    of the 1024 x 120 fleet (median, stages), the grid candidate stage of
    one slice beside the tuned sweep's, the tuned dense matcher's batch
    and the grid matcher's in turns (dense, grid, grid, dense) AB_ROUNDS
    times, candidate edge sets equal to the
    sweep's on every point of ``pts`` (distance multisets within rtol
    1e-5, atol 1e-3), the first REFERENCE_TRACES traces' records equal
    the CPU port's grid matcher's, the traces whose records differ from
    the tuned dense matcher's counted (a reported figure), no sweep
    instance launched in the grid matcher's window and the grid kernel
    did (its launches by K); the kernel launches of one candidate stage
    (the profiler's count)."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.matcher.api import SegmentMatcher
    from reporter_tpu_torch.ops import match as match_ops
    from reporter_tpu_torch.ops.candidates import find_candidates

    grid_native_phase(card, ts, "sf")
    p = MatcherParams(candidate_backend="grid")
    t0 = time.perf_counter()
    gm, built = win.run("sf:grid_build", lambda: SegmentMatcher(ts, p))
    build_s = time.perf_counter() - t0
    if any(built.values()) or gm.tuned_plan is not None:
        raise SystemExit(f"[grid] the grid matcher tuned or launched: {built}")
    gm.match_many(traces[:64])                    # warm the allocator
    (grecs, fields), served = win.run(
        "sf:grid", lambda: timed_batches(gm, traces, GRID_BATCH_RUNS))
    grid_launches = win.grid_by_path["sf:grid"]
    _, bpts, bval = first_slice(m, traces)
    _, stage_launches, _ = launch_calls(lambda: match_ops.batch_candidates(
        bpts, bval, gm.tables, gm.params, ts.meta))
    stage_ms = {
        "grid": cuda_ms(lambda: match_ops.batch_candidates(
            bpts, bval, gm.tables, gm.params, ts.meta), reps=10),
        "sweep_tuned": cuda_ms(lambda: match_ops.batch_candidates(
            bpts, bval, m.tables, m.params), reps=10)}
    walls = {"dense": [], "grid": []}
    for r in range(AB_ROUNDS):
        for i, name in enumerate(("dense", "grid", "grid", "dense")):
            mm = m if name == "dense" else gm
            t0 = time.perf_counter()
            _, counts = win.run(f"sf:grid:ab:{name}:{r}{i}",
                                lambda mm=mm: mm.match_many(traces))
            walls[name].append((time.perf_counter() - t0) * 1e3)
            if name == "dense":
                only(counts, _tuned(m, dc), "[grid:ab] dense")
            elif any(counts.values()):
                raise SystemExit(f"[grid:ab] the grid matcher launched "
                                 f"a sweep instance: {counts}")
    ab_med = {name: statistics.median(v) for name, v in walls.items()}
    radius, k = m.params.search_radius, m.params.max_candidates
    grid = find_candidates(pts, gm.tables, ts.meta, radius, k)
    dense = dc.find_candidates_dense(
        pts, tuple(m.tables[key] for key in (
            "seg_pack", "seg_bbox", "seg_sub", "seg_feat", "seg_sweep",
            "seg_coarse")), radius, k)
    (ge, gd), (de, dd) = _sorted_sets(grid), _sorted_sets(dense)
    set_bad = int((ge != de).any(dim=1).sum())
    dist_bad = int((~torch.isclose(gd, dd, rtol=1e-5, atol=1e-3)).any(
        dim=1).sum())
    want, got = json_records(recs), json_records(grecs)
    cpu = SegmentMatcher(ts, p, device="cpu").match_many(
        traces[:REFERENCE_TRACES])
    cpu_ok = json_records(cpu) == got[:REFERENCE_TRACES]
    # lint: allow[bench-coverage] 2026-10-18 timed_batches' fields;
    # [bench_delta] reads the printed line
    phase("grid", card, metro="sf", build_s=build_s,
          cells=int(ts.grid.shape[0]), capacity=int(ts.grid.shape[1]),
          cell_pack_bytes=int(gm.tables["cell_pack"].numel() * 4),
          table_bytes=gm.table_bytes, dense_table_bytes=m.table_bytes,
          candidates_ms=stage_ms, slice_shape=list(bpts.shape[:2]),
          grid_over_sweep=stage_ms["grid"] / stage_ms["sweep_tuned"],
          ab_order="dense, grid, grid, dense", ab_rounds=AB_ROUNDS,
          ab_batch_ms=walls, ab_median_ms=ab_med,
          ab_grid_over_dense=ab_med["grid"] / ab_med["dense"],
          points=int(pts.shape[0]), edge_set_mismatches=set_bad,
          distance_mismatches=dist_bad,
          candidates=int(grid.valid.sum()),
          card_vs_cpu_records_equal=cpu_ok, traces_checked=REFERENCE_TRACES,
          traces_differing_from_dense=sum(a != b
                                          for a, b in zip(got, want)),
          launches={f"{a}@k{kk}": n for (a, kk), n in served.items() if n},
          grid_launches=grid_launches,
          stage_kernel_launches=stage_launches, **fields)
    if set_bad or dist_bad or not cpu_ok or any(served.values()) \
            or not grid_launches.get(gm.params.max_candidates):
        raise SystemExit("[grid] edge sets or distances differ from the "
                         "sweep's, the card's records from the CPU's, a "
                         "sweep instance launched or the grid kernel did "
                         "not")


def topk_phase(card, ts, m, traces, dc, win):
    """[topk]: the tuned sf matcher's match_topk on the card, terminal
    completions and the exact list Viterbi, on TOPK_TRACES fleet traces
    of 120 points and one TOPK_LONG_POINTS-point trace: ranked paths
    equal the CPU port's (edges and offsets; scores within
    TOPK_SCORE_RTOL), scores ascend, rank 0 is one path in both forms,
    the exact scores dominate the terminal ones, a longer trace raises,
    and the window launched only the tuned instance and each lattice
    kernel once a call. ms per call; the work one call puts on the card
    (kernel launches and copies, the profiler's count; ``launch_calls``),
    equal at T = 120 and 1024, the kernel launches alone beside it. Then
    K = 64 at 150 m on the long trace (the widest list): card = CPU, ms,
    the call's peak bytes (under TOPK_K64_PEAK), its launches."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.matcher.api import _BUCKETS, SegmentMatcher, Trace
    from reporter_tpu_torch.netgen.traces import synthesize_probe

    pr = synthesize_probe(ts, seed=7, num_points=TOPK_LONG_POINTS)
    long = Trace(uuid="long", xy=pr.xy.astype(np.float32), times=pr.times)
    sets = {"t120": traces[:TOPK_TRACES], f"t{TOPK_LONG_POINTS}": [long]}

    def run():
        out = {}
        for name, trs in sets.items():
            for exact in (False, True):
                res, ms = [], []
                for tr in trs:
                    t0 = time.perf_counter()
                    res.append(m.match_topk(tr, exact=exact))
                    ms.append((time.perf_counter() - t0) * 1e3)
                out[name, exact] = (res, statistics.median(ms))
        return out

    card_out, counts = win.run("sf:topk", run)
    only(counts, _tuned(m, dc), "[topk]")
    # every call ran the three lattice kernels once (no Python loop over
    # T: the plain versions count nothing), and no grid launch
    calls = sum(len(trs) for trs in sets.values()) * 2
    lattice = win.lattice_by_path["sf:topk"]
    if any(lattice.get(key, 0) != calls for key in LATTICE_KERNELS) \
            or any(win.grid_by_path["sf:topk"].values()):
        raise SystemExit(f"[topk] {calls} calls launched the lattice "
                         f"kernels {lattice} times")
    # the work one call puts on the card (the profiler's count), at each T
    per_call, per_call_kernels = {}, {}
    for name, trs in sets.items():
        for exact in (False, True):
            key = f"{name}_{'exact' if exact else 'terminal'}"
            _, per_call[key], per_call_kernels[key] = launch_calls(
                lambda tr=trs[0], e=exact: m.match_topk(tr, exact=e))
    # the widest list: K = 64 at 150 m on the long trace, both forms
    wide = SegmentMatcher(ts, MatcherParams(
        sweep_autotune=False, max_candidates=64, search_radius=WIDE_RADIUS))
    wide_out = {}
    for exact in (False, True):
        wide.match_topk(long, exact=exact)          # the build, the warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = wide.match_topk(long, exact=exact)
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        _, launches, _ = launch_calls(lambda e=exact: wide.match_topk(
            long, exact=e))
        wide_out[exact] = (got, ms, peak, launches)
    cpu = SegmentMatcher(ts, device="cpu")
    bad = []

    def paths(ranked):
        return [[(q.edge, q.offset) for q in pts] for _, pts in ranked]

    for (name, exact), (res, _) in card_out.items():
        for i, (tr, got) in enumerate(zip(sets[name], res)):
            want = cpu.match_topk(tr, exact=exact)
            s = [x for x, _ in got]
            if (paths(got) != paths(want) or not s or s != sorted(s)
                    or not np.allclose(s, [x for x, _ in want],
                                       rtol=TOPK_SCORE_RTOL, atol=0)):
                bad.append(f"{name}/{'exact' if exact else 'terminal'}/{i}")
    for name in sets:
        for i, (ex, tc) in enumerate(zip(card_out[name, True][0],
                                         card_out[name, False][0])):
            if (paths(ex)[:1] != paths(tc)[:1]
                    or any(a > b + 1e-3 for (a, _), (b, _) in zip(ex, tc))):
                bad.append(f"{name}/forms/{i}")
    cpu_wide = SegmentMatcher(ts, wide.params, device="cpu")
    for exact, (got, _, _, _) in wide_out.items():
        want = cpu_wide.match_topk(long, exact=exact)
        s = [x for x, _ in got]
        if (paths(got) != paths(want) or not s or s != sorted(s)
                or not np.allclose(s, [x for x, _ in want],
                                   rtol=TOPK_SCORE_RTOL, atol=0)):
            bad.append(f"k64/{'exact' if exact else 'terminal'}")
    too_long = _BUCKETS[-1] + 1
    try:
        m.match_topk(Trace(uuid="x", xy=np.zeros((too_long, 2), np.float32),
                           times=np.arange(float(too_long))))
        refused = False
    except ValueError:
        refused = True
    same_launches = all(
        per_call[f"t120_{form}"] == per_call[f"t{TOPK_LONG_POINTS}_{form}"]
        for form in ("terminal", "exact"))
    phase("topk", card, metro="sf", traces=TOPK_TRACES,
          long_points=TOPK_LONG_POINTS,
          ms_per_call={f"{name}_{'exact' if exact else 'terminal'}": ms
                       for (name, exact), (_, ms) in card_out.items()},
          paths={f"{name}_{'exact' if exact else 'terminal'}":
                 sum(len(r) for r in res)
                 for (name, exact), (res, _) in card_out.items()},
          launches={f"{a}@k{kk}": n for (a, kk), n in counts.items() if n},
          lattice_launches=lattice, per_call_launches=per_call,
          per_call_kernel_launches=per_call_kernels,
          launches_equal_across_t=same_launches,
          card_vs_cpu_equal=not bad, mismatches=bad[:8],
          refused_points=too_long, refused=refused)
    forms = {("exact" if exact else "terminal"): v
             for exact, v in wide_out.items()}
    phase("topk:k64", card, metro="sf", k=64, search_radius=WIDE_RADIUS,
          long_points=TOPK_LONG_POINTS,
          ms_per_call={f: v[1] for f, v in forms.items()},
          paths={f: len(v[0]) for f, v in forms.items()},
          peak_bytes={f: v[2] for f, v in forms.items()},
          per_call_launches={f: v[3] for f, v in forms.items()})
    peak = max(v[2] for v in forms.values())
    if bad or not refused or not same_launches or peak >= TOPK_K64_PEAK:
        raise SystemExit(f"[topk] checks failed: {bad[:8]}, refused "
                         f"{refused}, launches per call {per_call}, K = 64 "
                         f"peak bytes {peak}")


def capacity_phase(card, tiles):
    """[capacity]: plan_staging on each (name, tile); the formula
    (dense_staged_bytes) equals the staged matcher's table_bytes, and
    the rise of torch.cuda.memory_allocated() around staging is at least
    the formula and within CAPACITY_SLACK of it. The card's memory
    beside the budget."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.matcher.api import SegmentMatcher
    from reporter_tpu_torch.tiles.capacity import (DEFAULT_HBM_BUDGET,
                                                   plan_staging)

    out, ok = {}, True
    for name, ts in tiles:
        t0 = time.perf_counter()
        plan = plan_staging(ts)
        plan_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        pm = SegmentMatcher(ts, MatcherParams(sweep_autotune=False))
        torch.cuda.synchronize()
        rise = torch.cuda.memory_allocated() - before
        good = (plan.table_bytes == pm.table_bytes
                and plan.table_bytes <= rise
                <= plan.table_bytes + CAPACITY_SLACK)
        ok &= good
        out[name] = {**plan.to_json(), "table_bytes_staged": pm.table_bytes,
                     "memory_allocated_rise": rise, "plan_s": plan_s,
                     "held": good}
        del pm
    total = torch.cuda.get_device_properties(0).total_memory
    phase("capacity", card, total_memory=total,
          default_budget=DEFAULT_HBM_BUDGET,
          budget_share=DEFAULT_HBM_BUDGET / total, slack=CAPACITY_SLACK,
          tiles=out)
    if not ok:
        raise SystemExit("[capacity] the formula differs from the staged "
                         "bytes or from memory_allocated")
    return {name: o["table_bytes"] for name, o in out.items()}


def tiles_cli_phase(card, sf_ts, sf_bytes):
    """[tiles:cli] (host): python -m reporter_tpu_torch.tiles as
    subprocesses, in two waves of concurrent ones (each start imports
    torch): convert tests/fixtures/irregular.osm to PBF and synth --city
    sf --seed 1 (sf's preset seed); then build the PBF --mode bicycle,
    info, osmlr and osmlr --binary of the sf file. Each built file's arrays equal the
    in-process compile's; info carries the JAX keys, with hbm_bytes equal
    to [capacity]'s sf figure; the binary tile reads back to the
    GeoJSON's segments."""
    from reporter_tpu_torch.netgen.pbf import parse_osm_pbf
    from reporter_tpu_torch.tiles.compiler import compile_network
    from reporter_tpu_torch.tiles.osmlr_tiles import read_osmlr_tile
    from reporter_tpu_torch.tiles.tileset import ARRAY_FIELDS, TileSet

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(SCRATCH, "tiles_cli")
    os.makedirs(root, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=here)
    secs = {}

    def cli(*args):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "reporter_tpu_torch.tiles", *args],
            cwd=here, env=env, capture_output=True, text=True, timeout=600)
        secs[args[0] + ("_binary" if "--binary" in args else "")] = \
            time.perf_counter() - t0
        if proc.returncode:
            raise SystemExit(f"[tiles:cli] {args[0]} exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
        return json.loads(proc.stdout)

    def same(path, ts):
        got = TileSet.load(path)
        return all(getattr(got, f).tobytes() == getattr(ts, f).tobytes()
                   and getattr(got, f).dtype == getattr(ts, f).dtype
                   for f in ARRAY_FIELDS) and tuple(got.meta) == tuple(ts.meta)

    osm = os.path.join(here, "tests", "fixtures", "irregular.osm")
    pbf, bike = os.path.join(root, "irregular.osm.pbf"), \
        os.path.join(root, "bike.npz")
    sf, geo, bin_ = (os.path.join(root, n) for n in (
        "sf.npz", "sf.geojson", "sf.osmlr"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        conv, _ = pool.map(lambda a: cli(*a), [
            ("convert", osm, pbf),
            ("synth", "--city", "sf", "--seed", "1", "-o", sf)])
        built, info, geo_line, bin_line = pool.map(lambda a: cli(*a), [
            ("build", "--osm", pbf, "--mode", "bicycle", "-o", bike),
            ("info", sf), ("osmlr", sf, "-o", geo),
            ("osmlr", sf, "--binary", "-o", bin_)])
    wall_s = time.perf_counter() - t0
    bike_ok = same(bike, compile_network(parse_osm_pbf(pbf, "irregular"),
                                         mode="bicycle"))
    sf_ok = same(sf, sf_ts)
    keys = ["name", "nodes", "edges", "line_segments", "osmlr_segments",
            "grid_cells", "hbm_bytes", "meta", "stats"]
    info_ok = (list(info) == keys and info["hbm_bytes"] == sf_bytes
               and info["grid_cells"] == int(sf_ts.grid.shape[0])
               and info["edges"] == sf_ts.num_edges)
    n_geo, n_bin = geo_line["segments"], bin_line["segments"]
    with open(geo) as f:
        feats = json.load(f)["features"]
    segs = read_osmlr_tile(bin_)["segments"]
    osmlr_ok = n_geo == n_bin == len(feats) == len(segs) > 0 and all(
        s["id"] == g["id"] and s["way_ids"] == g["properties"]["way_ids"]
        and abs(s["length_m"] - g["properties"]["length_m"]) <= 0.005
        and np.allclose(s["coordinates"], g["geometry"]["coordinates"],
                        atol=1.5e-7, rtol=0)
        for s, g in zip(segs, feats))
    phase("tiles:cli", card, seconds=secs, wall_s=wall_s, converted=conv,
          bicycle_edges=built["stats"]["edges"], bicycle_equal=bike_ok,
          synth_equal=sf_ok, info_ok=info_ok, hbm_bytes=info["hbm_bytes"],
          osmlr_segments=n_geo, osmlr_binary_bytes=os.path.getsize(bin_),
          osmlr_geojson_bytes=os.path.getsize(geo), osmlr_equal=osmlr_ok)
    if not (bike_ok and sf_ok and info_ok and osmlr_ok):
        raise SystemExit("[tiles:cli] a subcommand's output differs")


def reach_audit_phase(card, tiles):
    """[reach_audit] (host): audit_reach on each (name, tile) over
    REACH_AUDIT_TRACES fleet traces of N_POINTS points: the summary and
    the seconds."""
    from reporter_tpu_torch.netgen.traces import synthesize_fleet
    from reporter_tpu_torch.tiles.reach_audit import audit_reach

    for name, ts in tiles:
        fleet = synthesize_fleet(ts, REACH_AUDIT_TRACES, num_points=N_POINTS,
                                 seed=0)
        t0 = time.perf_counter()
        audit = audit_reach(ts, [p.xy for p in fleet])
        # lint: allow[bench-coverage] 2026-10-18 ReachAudit.summary()'s keys;
        # [bench_delta] reads the printed line
        phase("reach_audit", card, metro=name, traces=REACH_AUDIT_TRACES,
              seconds=time.perf_counter() - t0, host_cpu=host_cpu(),
              **audit.summary())
        if not audit.pairs_accepted_exact:
            raise SystemExit(f"[reach_audit] {name}: nothing audited")


def _wire(m, traces) -> bytes:
    """The wire tensors of these traces, harvested in submission order:
    the bytes the fleet's fidelity checks compare."""
    _, inflight = m._submit_many(traces)
    return b"".join(w.cpu().numpy().tobytes() for _, w in inflight)


def _alloc_bound(nbytes):
    """The most bytes the caching allocator counts for one tensor of
    ``nbytes``: whole 512-byte blocks, and past 1 MiB (the large pool)
    up to 1 MiB more, since a cached block is not split when its
    remainder would be 1 MiB or less."""
    nbytes = int(nbytes)
    return -(-nbytes // 512) * 512 + (1 << 20 if nbytes > 1 << 20 else 0)


def _tables_bound(tables):
    return sum(_alloc_bound(t.numel() * t.element_size())
               for t in tables.values())


def fleet_metros(city_tiles):
    """The [fleet] metros: the city tiles of the earlier phases (name,
    tile) with FLEET_CITY_TRACES x N_POINTS traces of their own fleets
    (seed 0), and the JAX bench's FLEET_GEN generated metros
    (bench.py:2955-3010: tiny at nx = ny = 8, seed 60 + i, centre
    (-125 + 0.7 i, 38), reach radius 500 m, named fleet00..07) with
    FLEET_GEN_TRACES x FLEET_GEN_POINTS traces (seed 9 + i). → ([tile],
    {name: [Trace]})."""
    from reporter_tpu_torch.config import CompilerParams
    from reporter_tpu_torch.matcher.api import Trace
    from reporter_tpu_torch.netgen.synthetic import generate_city
    from reporter_tpu_torch.netgen.traces import synthesize_fleet
    from reporter_tpu_torch.tiles.compiler import compile_network

    tiles, traffic = [], {}
    for ts in city_tiles:
        tiles.append(ts)
        probes = synthesize_fleet(ts, FLEET_CITY_TRACES,
                                  num_points=N_POINTS, seed=0)
        traffic[ts.name] = [Trace(uuid=f"{ts.name}-{j}", xy=p.xy,
                                  times=p.times)
                            for j, p in enumerate(probes)]
    for i in range(FLEET_GEN):
        net = generate_city("tiny", nx=8, ny=8, seed=60 + i,
                            center=(-125.0 + 0.7 * i, 38.0))
        net.name = f"fleet{i:02d}"
        ts = compile_network(net, CompilerParams(reach_radius=500.0))
        tiles.append(ts)
        probes = synthesize_fleet(ts, FLEET_GEN_TRACES,
                                  num_points=FLEET_GEN_POINTS, seed=9 + i)
        traffic[ts.name] = [Trace(uuid=f"f{i}-{j}", xy=p.xy, times=p.times)
                            for j, p in enumerate(probes)]
    return tiles, traffic


def fleet_phase(card, dc, win, cache, city_tiles):
    """[fleet]: the 12 metros in one FleetResidency on the card, the
    budget unbounded. Every metro promoted once (its first touch stages
    the pinned cold tier and tunes its matcher, a fresh tuner cache) and
    its pre-paging wire harvested; memory_allocated's rise against the
    ledger (at least the staged total, at most the allocator's bound:
    512-byte blocks per table, an unsplit 1 MiB past the large pool's
    threshold).
    Then FLEET_ROUNDS rounds of every metro's traffic from FLEET_THREADS
    submitter threads, each dispatch a match_many under a lease: probes/s,
    per-metro kprobes/s on its own busy time, the window's launches only
    the metros' tuned instances, one wire entry per dispatch. → the
    state the later fleet phases read."""
    from reporter_tpu_torch.config import Config
    from reporter_tpu_torch.fleet import FleetResidency

    t0 = time.perf_counter()
    tiles, traffic = fleet_metros(city_tiles)
    build_s = time.perf_counter() - t0
    names = [t.name for t in tiles]
    os.environ["RTPU_AUTOTUNE_CACHE"] = os.path.join(cache, "fleet")
    fr = FleetResidency(tiles, Config(), device="cuda")
    # free earlier phases' unreachable cycles now: a collection inside
    # warm() would release their tensors and hide part of the rise
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    first_ms, pre = {}, {}

    def warm():
        for n in names:
            t = time.perf_counter()
            fr.promote(n)           # staging, the copy and the tuner
            first_ms[n] = (time.perf_counter() - t) * 1e3
            with fr.lease(n) as m:
                pre[n] = _wire(m, traffic[n])

    _, cal = win.run("fleet:warm", warm)
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - mem0
    occ = fr.occupancy()
    staged = {n: occ["metros"][n]["staged_bytes"] for n in names}
    matchers = {n: fr.matcher(n) for n in names}
    blocks = sum(_tables_bound(m.tables) for m in matchers.values())
    inst = {n: (arm, dc.sweep_instance_k(k))
            for n, (arm, k) in ((n, _tuned(m, dc))
                                for n, m in matchers.items())}
    # dispatches per metro: one wire entry each (every trace fits one
    # bucket), counted through a shim on submit_prepared
    entries, elock = {n: 0 for n in names}, threading.Lock()
    for n, m in matchers.items():
        real = m.submit_prepared

        def counted(ps, tables=None, n=n, real=real):
            with elock:
                entries[n] += 1
            return real(ps, tables)
        m.submit_prepared = counted
    jobs = [n for _ in range(FLEET_ROUNDS) for n in names]
    cursor, lock = {"i": 0}, threading.Lock()
    busy = dict.fromkeys(names, 0.0)
    probes = {n: sum(len(t.xy) for t in traffic[n]) for n in names}
    errors = []

    def submitter():
        while True:
            with lock:
                if cursor["i"] >= len(jobs):
                    return
                n = jobs[cursor["i"]]
                cursor["i"] += 1
            try:
                t = time.perf_counter()
                with fr.lease(n) as m:
                    m.match_many(traffic[n])
                dt = time.perf_counter() - t
                with lock:
                    busy[n] += dt
            except Exception as exc:        # reported below
                with lock:
                    errors.append(repr(exc))

    def traffic_run():
        threads = [threading.Thread(target=submitter)
                   for _ in range(FLEET_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    for n in entries:
        entries[n] = 0
    t = time.perf_counter()
    _, counts = win.run("fleet", traffic_run)
    wall_s = time.perf_counter() - t
    in_window = dict(entries)   # the window's wire entries
    # one more round from one thread, apart: what a dispatch costs
    # without the other submitters
    one_ms = {}
    for n in names:
        t = time.perf_counter()
        with fr.lease(n) as m:
            m.match_many(traffic[n])
        one_ms[n] = (time.perf_counter() - t) * 1e3
    window = {key: v for key, v in counts.items() if v}
    want = {}
    for n in names:
        want[inst[n]] = want.get(inst[n], 0) + in_window[n]
    total = sum(staged.values())
    phase("fleet", card, metros=names, build_s=build_s,
          edges={t.name: t.num_edges for t in tiles},
          traces={n: len(traffic[n]) for n in names},
          first_promote_ms=first_ms,
          calibration_launches=_launches(cal),
          plans={n: m.tuned_plan and m.tuned_plan.label
                 for n, m in matchers.items()},
          tuned_instance={n: list(v) for n, v in inst.items()},
          staged_bytes=staged, staged_total=total,
          ledger_resident_bytes=occ["resident_bytes"],
          memory_allocated_rise=rise, allocator_bound=blocks,
          rounds=FLEET_ROUNDS, threads=FLEET_THREADS, dispatches=len(jobs),
          wall_s=wall_s,
          probes_per_s=sum(probes[n] * FLEET_ROUNDS for n in names) / wall_s,
          kprobes_per_s_own_busy={
              n: probes[n] * FLEET_ROUNDS / busy[n] / 1e3 for n in names},
          busy_s=busy, one_thread_dispatch_ms=one_ms,
          one_thread_probes_per_s=sum(probes.values())
          / sum(one_ms.values()) * 1e3,
          wire_entries=in_window, launches=_launches(window),
          errors=errors[:4])
    problems = []
    if errors:
        problems.append(f"{len(errors)} dispatches failed: {errors[:2]}")
    if occ["resident_bytes"] != total or occ["resident_metros"] != len(names):
        problems.append(f"the ledger {occ['resident_bytes']} B of "
                        f"{occ['resident_metros']} metros")
    if any(staged[n] != matchers[n].table_bytes for n in names):
        problems.append("a metro's staged bytes differ from table_bytes")
    if not total <= rise <= blocks:
        problems.append(f"memory_allocated rose {rise} B for a ledger of "
                        f"{total} B (the allocator's bound {blocks} B)")
    if window != want:
        problems.append(f"the window launched {window}, the metros' tuned "
                        f"instances one per wire entry are {want}")
    if problems:
        raise SystemExit("[fleet] " + "; ".join(problems))
    for m in matchers.values():
        del m.submit_prepared       # the shim off: the class's method
    return {"fr": fr, "tiles": tiles, "traffic": traffic, "pre": pre,
            "inst": inst, "staged": staged}


def fleet_storm_phase(card, st):
    """[fleet:storm]: the budget set to FLEET_STORM_FRAC of the staged
    total (raised to the largest metro's bytes, so each can page in),
    then FLEET_STORM_CYCLES cycles of cyclic touches (every touch a
    miss): each touch a promote, timed apart from the dispatch of
    FLEET_STORM_TRACES of the metro's traces under a lease. The copy's
    ms (the pinned transfer and its event wait) and MB/s beside a
    pinned copy of [link]'s probe; promotions, demotions, evictions; the
    memory_allocated rise of each transfer and drop of each demotion
    against the metro's staged bytes (within the allocator's bound)."""
    from reporter_tpu_torch.utils import linkhealth

    fr, tiles, traffic = st["fr"], st["tiles"], st["traffic"]
    names = [t.name for t in tiles]
    staged = st["staged"]
    bound = {n: _tables_bound(fr.matcher(n).tables) for n in names}
    copies, drops, rises = [], [], []
    real_transfer, real_demote = fr._transfer, fr._demote_locked

    def transfer(host):
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = real_transfer(host)
        dt = time.perf_counter() - t
        tensors = {k: v for k, v in out.items()
                   if isinstance(v, torch.Tensor)}
        nbytes = sum(v.numel() * v.element_size() for v in tensors.values())
        copies.append((dt, nbytes))
        rises.append((nbytes, torch.cuda.memory_allocated() - before,
                      _tables_bound(tensors)))
        return out

    def demote(m):
        before = torch.cuda.memory_allocated()
        real_demote(m)
        drops.append((m.name, before - torch.cuda.memory_allocated()))

    fr._transfer, fr._demote_locked = transfer, demote
    occ0 = fr.occupancy()
    ev0 = {n: fr.metrics.value(f'fleet_evictions{{metro="{n}"}}')
           for n in names}
    # organic alone is 70% of the staged total: the budget is raised to
    # the largest metro, so that every metro can page in
    cap = max(int(sum(staged.values()) * FLEET_STORM_FRAC),
              max(staged.values()))
    touch_ms, dispatch_ms = [], []
    try:
        fr.set_capacity(cap)
        t0 = time.perf_counter()
        for _ in range(FLEET_STORM_CYCLES):
            for n in names:
                t = time.perf_counter()
                fr.promote(n)
                t1 = time.perf_counter()
                with fr.lease(n) as m:
                    m.match_many(traffic[n][:FLEET_STORM_TRACES])
                touch_ms.append((t1 - t) * 1e3)
                dispatch_ms.append((time.perf_counter() - t1) * 1e3)
        storm_s = time.perf_counter() - t0
    finally:
        fr._transfer, fr._demote_locked = real_transfer, real_demote
    occ = fr.occupancy()
    evictions = {n: int(fr.metrics.value(f'fleet_evictions{{metro="{n}"}}')
                        - ev0[n]) for n in names}
    _, mbps = linkhealth._device_probe(256 * 1024, "cuda")
    copy_ms = [dt * 1e3 for dt, _ in copies]
    nbytes = [b for _, b in copies]
    by_size = sorted(copies, key=lambda c: c[1])
    bad_drop = [(n, d, staged[n]) for n, d in drops
                if not staged[n] <= d <= bound[n]]
    bad_rise = [(b, r) for b, r, hi in rises if not b <= r <= hi]
    phase("fleet:storm", card, capacity_bytes=cap,
          staged_total=sum(staged.values()), cycles=FLEET_STORM_CYCLES,
          touches=len(touch_ms), storm_s=storm_s,
          promote_ms_p50=_pct(copy_ms, 0.50), promote_ms_p99=_pct(copy_ms, 0.99),
          touch_ms_p50=_pct(touch_ms, 0.50), touch_ms_p99=_pct(touch_ms, 0.99),
          dispatch_ms_p50=_pct(dispatch_ms, 0.50),
          copy_bytes_min=min(nbytes), copy_bytes_max=max(nbytes),
          copy_mb_per_s_p50=_pct([b / dt / 1e6 for dt, b in copies], 0.50),
          largest_copy={"bytes": by_size[-1][1],
                        "ms": by_size[-1][0] * 1e3,
                        "mb_per_s": by_size[-1][1] / by_size[-1][0] / 1e6},
          link_pinned_copy_mb_per_s=mbps,
          promotions=occ["promotions"] - occ0["promotions"],
          demotions=occ["demotions"] - occ0["demotions"],
          evictions=evictions, resident_after=fr.resident_names,
          memory_drops=len(drops),
          memory_drop_over_staged_max=max(d - staged[n] for n, d in drops)
          if drops else None,
          memory_rise_over_copy_max=max(r - b for b, r, _ in rises)
          if rises else None,
          memory_drop_mismatches=bad_drop, memory_rise_mismatches=bad_rise)
    problems = []
    if occ["promotions"] - occ0["promotions"] != len(touch_ms):
        problems.append("a touch was not a miss")
    if not drops or bad_drop or bad_rise:
        problems.append(f"memory_allocated does not track the ledger: "
                        f"drops {bad_drop[:3]}, rises {bad_rise[:3]}")
    if occ["resident_bytes"] > cap:
        problems.append(f"{occ['resident_bytes']} B resident over {cap} B")
    if problems:
        raise SystemExit("[fleet:storm] " + "; ".join(problems))


def fleet_fidelity_phase(card, dc, win, st):
    """[fleet:fidelity]: after the storm, each metro's wire harvested
    through its lease (a promotion where it is cold) equals a dedicated
    SegmentMatcher's (its plan a cache hit: no calibration) and its own
    harvest before paging, and its window launched only its tuned
    instance."""
    from reporter_tpu_torch.config import Config
    from reporter_tpu_torch.matcher.api import SegmentMatcher

    fr, tiles, traffic = st["fr"], st["tiles"], st["traffic"]
    out, problems = {}, []
    t0 = time.perf_counter()
    for ts in tiles:
        n = ts.name
        ded, cal = win.run(f"fleet:dedicated:{n}",
                           lambda: SegmentMatcher(ts, Config()))
        want = _wire(ded, traffic[n])

        def leased():
            with fr.lease(n) as m:
                return _wire(m, traffic[n]), m

        (got, m), counts = win.run(f"fleet:{n}", leased)
        occ = fr.occupancy()["metros"][n]
        out[n] = {"equal_dedicated": got == want,
                  "equal_pre_paging": got == st["pre"][n],
                  "dedicated_plan_source": ded.tuned_report.get("source"),
                  "same_plan": _tuned(ded, dc) == _tuned(m, dc),
                  "launches": _launches({k: v for k, v in counts.items()
                                         if v}),
                  "promotions": occ["promotions"],
                  "demotions": occ["demotions"], "plan": occ["tuned_plan"]}
        if not (got == want == st["pre"][n] and out[n]["same_plan"]
                and out[n]["dedicated_plan_source"] == "cache"
                and not any(cal.values())):
            problems.append(f"{n}: {out[n]}")
        try:
            only(counts, st["inst"][n], f"[fleet:fidelity] {n}")
        except SystemExit as exc:
            problems.append(str(exc))
        del ded
    phase("fleet:fidelity", card, seconds=time.perf_counter() - t0,
          metros=out, paged_metros=sum(1 for o in out.values()
                                       if o["demotions"]))
    if problems:
        raise SystemExit("[fleet:fidelity] " + "; ".join(problems))


def fleet_router_phase(card, cache, router_tiles):
    """[fleet:router]: make_fleet_router over sf, nyc and la, sf pinned
    through MetroSLO(pinned=True), the budget sf's staged bytes plus one
    and a half of the larger other metro's (so nyc and la page in turns
    beside the pinned sf); FLEET_ROUTER_CLIENTS clients round-robin over
    the metros post FLEET_ROUTER_REQUESTS in-order 40-point /report
    requests (SERVE_PARTS per uuid) behind serve(). Every response equals
    a dedicated MetroRouter's fed the same per-metro order; /health's
    fleet block adds up; p50 / p99 and the promotions."""
    from reporter_tpu_torch.config import Config
    from reporter_tpu_torch.fleet import FleetConfig, MetroSLO, \
        make_fleet_router
    from reporter_tpu_torch.netgen.traces import synthesize_fleet
    from reporter_tpu_torch.service.router import make_router
    from reporter_tpu_torch.service.server import serve
    from reporter_tpu_torch.tiles.tileset import staged_nbytes

    names = [t.name for t in router_tiles]
    size = {t.name: staged_nbytes(t.host_tables("dense"))
            for t in router_tiles}
    others = [n for n in names if n != "sf"]
    cap = size["sf"] + int(1.5 * max(size[n] for n in others))
    clients = {n: [c for c in range(FLEET_ROUTER_CLIENTS)
                   if c % len(names) == i] for i, n in enumerate(names)}
    per_client = FLEET_ROUTER_REQUESTS // FLEET_ROUTER_CLIENTS
    uuids_per_client = per_client // SERVE_PARTS
    part = N_POINTS // SERVE_PARTS
    requests = {}
    for i, t in enumerate(router_tiles):
        n = t.name
        n_uuid = len(clients[n]) * uuids_per_client
        fleet = synthesize_fleet(t, n_uuid, num_points=N_POINTS, seed=20 + i)
        requests[n] = [[{"uuid": f"fr-{n}-{u}", "trace":
                         fleet[u].to_report_json()["trace"][
                             k * part:(k + 1) * part]}
                        for k in range(SERVE_PARTS)] for u in range(n_uuid)]
    os.environ["RTPU_AUTOTUNE_CACHE"] = os.path.join(cache, "fleet")
    router = make_fleet_router(
        router_tiles, Config(),
        fleet=FleetConfig(max_resident_bytes=cap,
                          promote_wait_s=FLEET_ROUTER_WAIT_S),
        slos={"sf": MetroSLO(pinned=True)}, device="cuda")
    server = serve(router, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    responses = {n: [[None] * SERVE_PARTS for _ in requests[n]]
                 for n in names}
    lat, statuses, lock = [], [], threading.Lock()
    try:
        def client(c):
            n = names[c % len(names)]
            j = clients[n].index(c)
            for u in range(j * uuids_per_client, (j + 1) * uuids_per_client):
                for k in range(SERVE_PARTS):
                    t = time.perf_counter()
                    st_, body = http_json(base + "/report", requests[n][u][k])
                    with lock:
                        lat.append(time.perf_counter() - t)
                        statuses.append(st_)
                    responses[n][u][k] = body

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=FLEET_ROUTER_CLIENTS) as pool:
            list(pool.map(client, range(FLEET_ROUTER_CLIENTS)))
        traffic_s = time.perf_counter() - t0
        _, health = http_json(base + "/health")
        _, prom = http_text(base + "/metrics")
    finally:
        server.shutdown()
        server.server_close()
        router.close()
    fl = health.get("fleet", {})
    metros = fl.get("metros", {})
    adds_up = (
        fl.get("resident_bytes") == sum(v["staged_bytes"]
                                        for v in metros.values()
                                        if v["resident"])
        and fl.get("resident_metros") == sum(v["resident"]
                                             for v in metros.values())
        and fl.get("promotions") == sum(v["promotions"]
                                        for v in metros.values())
        and fl.get("demotions") == sum(v["demotions"]
                                       for v in metros.values())
        and fl.get("resident_bytes", cap + 1) <= cap
        and metros.get("sf", {}).get("resident")
        and metros.get("sf", {}).get("pinned"))
    # the dedicated router: every metro staged, the same per-metro order
    ded = make_router(router_tiles, Config(), device="cuda")
    try:
        equal = {}
        for n in names:
            uu = range(len(requests[n]))
            got = [r for k in range(SERVE_PARTS) for r in ded.report_many(
                [requests[n][u][k] for u in uu])]
            want = [responses[n][u][k] for k in range(SERVE_PARTS)
                    for u in uu]
            equal[n] = {"equal": got == want,
                        "segments": sum(len(r.get("segments", ()))
                                        for r in want)}
    finally:
        ded.close()
    phase("fleet:router", card, metros=names, staged_bytes=size,
          capacity_bytes=cap, pinned="sf", clients=FLEET_ROUTER_CLIENTS,
          requests=len(lat), traffic_s=traffic_s,
          latency_ms_p50=_pct(lat, 0.50) * 1e3,
          latency_ms_p99=_pct(lat, 0.99) * 1e3,
          latency_ms_max=max(lat) * 1e3,
          promotions=fl.get("promotions"), demotions=fl.get("demotions"),
          resident_after=[n for n, v in metros.items() if v["resident"]],
          fleet_block_adds_up=bool(adds_up), dedicated_router_equal=equal,
          metrics_fleet_series=sorted({
              line.split()[0].split("{")[0] for line in prom.splitlines()
              if line.startswith("rtpu_fleet_")}))
    problems = []
    if any(s != 200 for s in statuses):
        problems.append(f"non-200 responses {sorted(set(statuses))}")
    if not all(e["equal"] and e["segments"] for e in equal.values()):
        problems.append(f"responses differ from a dedicated router's: "
                        f"{equal}")
    if not adds_up or not fl.get("demotions"):
        problems.append(f"the fleet block does not add up or never paged: "
                        f"{fl}")
    if problems:
        raise SystemExit("[fleet:router] " + "; ".join(problems))


def fleet_guard_phase(card, cache, ts):
    """[fleet:guard]: a one-metro fleet with promote_timeout_s =
    FLEET_GUARD_TIMEOUT_S under fleet_promote:hang(FLEET_GUARD_HANG_S)@0:
    the promotion sheds as ServiceOverloaded within the timeout's
    margin, the ledger rolled back (nothing resident, no bytes, a
    timeout counted); with the plan cleared the next touch promotes and
    serves."""
    from reporter_tpu_torch import faults
    from reporter_tpu_torch.config import Config
    from reporter_tpu_torch.fleet import FleetConfig, FleetResidency
    from reporter_tpu_torch.service.scheduler import ServiceOverloaded

    os.environ["RTPU_AUTOTUNE_CACHE"] = os.path.join(cache, "fleet")
    fr = FleetResidency([ts], Config(), FleetConfig(
        promote_timeout_s=FLEET_GUARD_TIMEOUT_S), device="cuda")
    plan = faults.FaultPlan.parse(
        f"fleet_promote:hang({FLEET_GUARD_HANG_S})@0")
    shed, err = None, None
    with faults.use(plan):
        t = time.perf_counter()
        try:
            fr.promote(ts.name)
        except ServiceOverloaded as exc:
            shed, err = time.perf_counter() - t, str(exc)
        rolled_back = (fr.resident_bytes == 0 and fr.resident_names == []
                       and fr.occupancy()["metros"][ts.name]["promotions"]
                       == 0)
    timeouts = fr.metrics.value(f'fleet_promote_timeouts{{metro="{ts.name}"}}')
    t = time.perf_counter()
    with fr.lease(ts.name) as m:
        staged = m.tables_staged
    recover_s = time.perf_counter() - t
    phase("fleet:guard", card, timeout_s=FLEET_GUARD_TIMEOUT_S,
          hang_s=FLEET_GUARD_HANG_S, shed_s=shed, error=err,
          rolled_back=rolled_back, timeouts=timeouts,
          recovered=staged and fr.resident_names == [ts.name],
          recover_s=recover_s)
    if not (shed is not None
            and FLEET_GUARD_TIMEOUT_S <= shed < FLEET_GUARD_TIMEOUT_S + 2.0
            and rolled_back and timeouts == 1 and staged
            and fr.resident_names == [ts.name]):
        raise SystemExit("[fleet:guard] the hung promotion did not shed, "
                         "roll back and recover")


# ---- multi-GPU: the mesh's programs on the card ----------------------------


def _mesh_wire(m, traces) -> bytes:
    """The wire of these traces, harvested in submission order with the
    padded rows dropped (a mesh pads each slice to a multiple of its
    devices)."""
    _, inflight = m._submit_many(traces)
    return b"".join(w.cpu().numpy()[:len(ws)].tobytes()
                    for ws, w in inflight)


def mesh_dp_phase(card, ts, traces, recs, m, fields, dc, win):
    """[mesh:dp]: a SegmentMatcher over make_mesh(dp=MESH_DP,
    devices=["cuda:0"] * MESH_DP), and over make_mesh() of every visible
    card when there are more than one: MESH_BATCH_RUNS timed batches of
    the 1024 x 120 fleet (median, stages, launches per (arm, K)), records
    equal to the tuned single-device matcher's (to_json(), tolerance 0),
    the wire bytes of MESH_WIRE_TRACES traces equal to its wire's; then
    MESH_BATCH_RUNS batches of each in turns (medians and their
    ratio)."""
    from reporter_tpu_torch.matcher.api import SegmentMatcher
    from reporter_tpu_torch.parallel import make_mesh

    meshes = {"one_card": make_mesh(dp=MESH_DP,
                                    devices=["cuda:0"] * MESH_DP)}
    if torch.cuda.device_count() > 1:
        meshes["every_card"] = make_mesh()
    want = json_records(recs)
    want_wire = _mesh_wire(m, traces[:MESH_WIRE_TRACES])
    out = {}
    for tag, mesh in meshes.items():
        mm = SegmentMatcher(ts, mesh=mesh)
        inst = _tuned(mm, dc)
        (got, f), counts = win.run(
            "mesh:dp", lambda mm=mm: timed_batches(mm, traces,
                                                   runs=MESH_BATCH_RUNS))
        only(counts, inst, f"[mesh:dp] {tag}")
        wire_eq = _mesh_wire(mm, traces[:MESH_WIRE_TRACES]) == want_wire
        rec_eq = json_records(got) == want
        # the tuned single-device matcher and the mesh in turns (A B, B A,
        # ...): the host's launch rate drifts within a run
        walls = {"single": [], "mesh": []}
        for r in range(MESH_BATCH_RUNS):
            for who in (("single", "mesh") if r % 2 == 0
                        else ("mesh", "single")):
                t = time.perf_counter()
                (m if who == "single" else mm).match_many(traces)
                walls[who].append((time.perf_counter() - t) * 1e3)
        turns = {k: statistics.median(v) for k, v in walls.items()}
        out[tag] = {
            "mesh": dict(mesh.shape),
            "devices": [str(d) for d in mesh.flat_devices],
            "arm": f"{inst[0]}@k{inst[1]}", "records_equal": rec_eq,
            "wire_equal": wire_eq, "launches": _launches(counts),
            "launches_per_batch": counts.get(inst, 0) / (MESH_BATCH_RUNS + 1),
            "in_turns_ms": turns,
            "x_single_in_turns": turns["mesh"] / turns["single"],
            **{k: f[k] for k in ("batch_ms_median", "batch_ms_min",
                                 "batch_ms_max", "prepare_ms",
                                 "dispatch_ms", "device_ms", "walk_ms",
                                 "probes_per_s")}}
        if not (rec_eq and wire_eq):
            # lint: allow[bench-coverage] 2026-10-18 one record per mesh,
            # keyed by its name; [bench_delta] reads the printed line
            phase("mesh:dp", card, **out)
            raise SystemExit(f"[mesh:dp] {tag}: records or wire differ from "
                             "the single-device matcher's")
    tuned_slices = m.plan_submit(traces)[1]
    # lint: allow[bench-coverage] 2026-10-18 one record per mesh, keyed by
    # its name; [bench_delta] reads the printed line
    phase("mesh:dp", card, metro="sf", traces=len(traces),
          wire_traces=MESH_WIRE_TRACES, single_batch_ms=fields[
              "batch_ms_median"], single_slices=len(tuned_slices), **out)


def mesh_sharded_phase(card, ts, fleet, dc, win):
    """[mesh:sharded]: sf's segment table over tile=MESH_SHARDS, dp=1 on
    one card: each shard's tables built from its own columns; edge,
    offset and dist of all 131,072 fleet points bit-equal to the
    unsharded sweep's; make_sharded_matcher's MatchOutput equal to the
    single-device match_traces; each shard's squared output (the merge's
    input) bit-equal to _dense_plain(squared=True) of its pack on
    CHECK_CHUNKS chunks; each shard's sweep ms and the merge ms (CUDA
    events)."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.ops.match import match_traces
    from reporter_tpu_torch.parallel import make_mesh, make_sharded_matcher
    from reporter_tpu_torch.parallel.sharded_candidates import (
        SEG_KEYS, _merge_topk, sharded_candidates)
    from reporter_tpu_torch.tiles.tileset import tables_from_numpy

    params = MatcherParams(sweep_autotune=False)
    inst = _params_instance(params, dc)
    mesh = make_mesh(tile=MESH_SHARDS, dp=1,
                     devices=["cuda:0"] * MESH_SHARDS)
    t0 = time.perf_counter()
    step = make_sharded_matcher(mesh, ts, params)
    build_s = time.perf_counter() - t0
    tables = step.tables
    tab = tables_from_numpy(ts.arrays(), "cuda")
    pts3 = fleet_points(fleet).reshape(len(fleet), BUCKET, 2)
    valid3 = np.zeros(pts3.shape[:2], bool)
    for i, p in enumerate(fleet):
        valid3[i, :len(p.xy)] = True
    pts = torch.from_numpy(pts3.reshape(-1, 2)).cuda()
    valid = torch.from_numpy(valid3.reshape(-1)).cuda()
    (me, md, mo), counts = win.run(
        "mesh:sharded", lambda: sharded_candidates(tables, pts, valid,
                                                   params))
    only(counts, inst, "[mesh:sharded] candidates")
    seg = tuple(tab[k] for k in SEG_KEYS)
    whole = dc.find_candidates_dense(pts, seg, params.search_radius,
                                     params.max_candidates, valid=valid)
    cand_eq = (torch.equal(me, whole.edge) and torch.equal(mo, whole.offset)
               and torch.equal(md, whole.dist))
    out, step_counts = win.run("mesh:sharded",
                               lambda: step(pts3, valid3))
    ref = match_traces(torch.from_numpy(pts3).cuda(),
                       torch.from_numpy(valid3).cuda(), tab, params, None,
                       ts.meta)
    out_eq = all(torch.equal(getattr(out, f), getattr(ref, f))
                 for f in out._fields)
    only(step_counts, inst, "[mesh:sharded] make_sharded_matcher")
    win.by_path["mesh:sharded"] = {
        key: counts.get(key, 0) + step_counts.get(key, 0)
        for key in counts.keys() | step_counts.keys()}
    shard_ms, lists, plain_eq = [], [], []
    for i in range(MESH_SHARDS):
        tb = tables.segments[i, mesh.devices[i, 0]]
        args = tuple(tb[k] for k in SEG_KEYS)

        def one(args=args):
            return dc.find_candidates_dense(
                pts, args, params.search_radius, params.max_candidates,
                valid=valid, squared=True)
        shard_ms.append(cuda_ms(one, 5))
        lists.append(one())
        # the squared output against the plain sweep of the shard's pack
        head = CHECK_CHUNKS * dc._P
        plain = dc._dense_plain(pts[:head], tb["seg_pack"],
                                params.search_radius, params.max_candidates,
                                squared=True)
        plain_eq.append(all(
            torch.equal(g[:head][valid[:head]], r[valid[:head]])
            for g, r in zip((lists[-1].edge, lists[-1].offset,
                             lists[-1].dist), plain)))
    stacked = [torch.stack([getattr(f, fld) for f in lists])
               for fld in ("edge", "dist", "offset")]
    merge_ms = cuda_ms(lambda: _merge_topk(*stacked, params.max_candidates),
                       5)
    whole_ms = cuda_ms(lambda: dc.find_candidates_dense(
        pts, seg, params.search_radius, params.max_candidates, valid=valid),
        5)
    phase("mesh:sharded", card, metro="sf", shards=MESH_SHARDS,
          points=int(pts.shape[0]), arm=f"{inst[0]}@k{inst[1]}",
          blocks_per_shard=[int(h["seg_bbox"].shape[0])
                            for h in tables.host],
          real_blocks=int(tab["seg_bbox"].shape[0]),
          build_s=build_s, candidates_bit_equal=cand_eq,
          match_output_equal=out_eq, plain_points=CHECK_CHUNKS * dc._P,
          shard_squared_equal_plain=plain_eq, shard_candidates_ms=shard_ms,
          merge_ms=merge_ms, unsharded_candidates_ms=whole_ms,
          launches=_launches(win.by_path["mesh:sharded"]))
    if not (cand_eq and out_eq and all(plain_eq)):
        raise SystemExit("[mesh:sharded] the sharded sweep or match differs "
                         "from the unsharded one or a shard from its plain "
                         "sweep")


def mesh_metro_phase(card, metros, dc, win):
    """[mesh:metro]: sf, nyc and la stacked on tile=3, dp=MESH_METRO_DP
    (one card), MESH_METRO_TRACES x 120 traces each: every metro's
    outputs equal its own single-device match_traces; the histogram
    equals the bincount of the matched OSMLR rows, zero past each
    metro's real G."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.netgen.traces import synthesize_fleet
    from reporter_tpu_torch.ops.match import match_traces
    from reporter_tpu_torch.parallel import (make_mesh,
                                             make_multimetro_matcher,
                                             stack_tilesets)
    from reporter_tpu_torch.tiles.tileset import tables_from_numpy

    params = MatcherParams(sweep_autotune=False)
    inst = _params_instance(params, dc)
    n = len(metros)
    mesh = make_mesh(tile=n, dp=MESH_METRO_DP,
                     devices=["cuda:0"] * (n * MESH_METRO_DP))
    t0 = time.perf_counter()
    stacked = stack_tilesets(metros)
    step = make_multimetro_matcher(mesh, stacked, params)
    build_s = time.perf_counter() - t0
    points = np.zeros((n, MESH_METRO_TRACES, N_POINTS, 2), np.float32)
    for i, tsm in enumerate(metros):
        points[i] = np.stack([p.xy for p in synthesize_fleet(
            tsm, MESH_METRO_TRACES, num_points=N_POINTS, seed=0)])
    valid = np.ones(points.shape[:3], bool)
    (out, hist), counts = win.run("mesh:metro", lambda: step(points, valid))
    only(counts, inst, "[mesh:metro]")
    ms = cuda_ms(lambda: step(points, valid), 3, warmup=0)
    per, hist_ok = {}, []
    for i, tsm in enumerate(metros):
        ref = match_traces(torch.from_numpy(points[i]).cuda(),
                           torch.from_numpy(valid[i]).cuda(),
                           tables_from_numpy(tsm.arrays(), "cuda"), params,
                           None, tsm.meta)
        eq = all(torch.equal(getattr(out, f)[i], getattr(ref, f))
                 for f in out._fields)
        edges = out.edge[i].cpu().numpy()
        matched = out.matched[i].cpu().numpy()
        rows = tsm.edge_osmlr[np.maximum(edges, 0)][matched & (edges >= 0)]
        want = np.bincount(rows[rows >= 0], minlength=stacked.osmlr_pad)
        h = hist[i].cpu().numpy()
        ok = (np.array_equal(h, want)
              and not h[stacked.num_osmlr[i]:].any())
        hist_ok.append(ok)
        per[tsm.name] = {"output_equal": eq, "histogram_equal": ok,
                         "matched_share": float(matched.mean()),
                         "osmlr_rows": stacked.num_osmlr[i],
                         "observations": int(h.sum())}
    # lint: allow[bench-coverage] 2026-10-18 one record per metro, keyed by
    # its name; [bench_delta] reads the printed line
    phase("mesh:metro", card, metros=list(stacked.names),
          mesh=dict(mesh.shape), traces_per_metro=MESH_METRO_TRACES,
          arm=f"{inst[0]}@k{inst[1]}", osmlr_pad=stacked.osmlr_pad,
          build_s=build_s, step_ms=ms, launches=_launches(counts),
          **per)
    if not all(p["output_equal"] for p in per.values()) or not all(hist_ok):
        raise SystemExit("[mesh:metro] a metro's outputs or histogram "
                         "differ from its single-device match")


def mesh_backfill_phase(card, ts, rounds, m, dc, win):
    """[mesh:backfill]: partition 0 of the backfill spool's 4-way split
    (its records in a 1-partition durable columnar broker) through
    BackfillEngine with BackfillConfig(mesh_devices=MESH_DP): over the
    first MESH_DP cards where there are that many, else (make_mesh
    raises for want of cards, checked) over make_mesh(dp=MESH_DP,
    devices=["cuda:0"] * MESH_DP). Grids and document equal to the
    single-device engine's (the tuned matcher) on the same spool;
    records/s of both."""
    import shutil

    from reporter_tpu_torch.backfill import BackfillConfig, BackfillEngine
    from reporter_tpu_torch.parallel import make_mesh
    from reporter_tpu_torch.streaming import (DurableColumnarIngestQueue,
                                              pack_records)
    from reporter_tpu_torch.streaming.queue import partition_of

    root = os.path.join(SCRATCH, "mesh_backfill")
    shutil.rmtree(root, ignore_errors=True)
    q = DurableColumnarIngestQueue(root, 1)
    n_records = 0
    for r in rounds:
        part = [x for x in r
                if partition_of(x["uuid"], BACKFILL_PARTITIONS) == 0]
        n_records += len(part)
        q.append_columns(pack_records(part))
    q.close()
    bf = BackfillConfig(mesh_devices=MESH_DP)
    refused = None
    if torch.cuda.device_count() >= MESH_DP:
        eng = BackfillEngine(ts, bf=bf)
    else:
        try:
            BackfillEngine(ts, bf=bf)
        except ValueError as exc:
            refused = str(exc)
        else:
            raise SystemExit("[mesh:backfill] mesh_devices past the card "
                             "count built a mesh")
        eng = BackfillEngine(ts, bf=bf, mesh=make_mesh(
            dp=MESH_DP, devices=["cuda:0"] * MESH_DP))
    inst = _tuned(eng.matcher, dc)
    stats, counts = win.run("mesh:backfill", lambda: eng.run(root))
    only(counts, inst, "[mesh:backfill]")
    one = BackfillEngine(ts, matcher=m, bf=BackfillConfig())
    one_stats = one.run(root)
    same = (np.array_equal(eng.hist.snapshot(), one.hist.snapshot())
            and np.array_equal(eng.qhist.snapshot(), one.qhist.snapshot())
            and json.dumps(eng.store.snapshot(), sort_keys=True)
            == json.dumps(one.store.snapshot(), sort_keys=True))
    phase("mesh:backfill", card, metro="sf", partition=0,
          records=n_records, mesh=dict(eng.mesh.shape),
          devices=[str(d) for d in eng.mesh.flat_devices],
          mesh_devices_refused=refused, arm=f"{inst[0]}@k{inst[1]}",
          records_per_s=stats["records"] / stats["seconds"],
          single_records_per_s=one_stats["records"] / one_stats["seconds"],
          seconds=stats["seconds"], waves=stats["waves"],
          chunks=stats["chunks"], reports=stats["reports"],
          stage_s=eng.stage_seconds, grids_and_document_equal=same,
          launches=_launches(counts))
    if not (same and stats["records"] == n_records and stats["reports"]):
        raise SystemExit("[mesh:backfill] the mesh engine's grids differ "
                         "from the single-device engine's")


_GROUP_CODE = """
import sys
import torch
import torch.distributed as dist
from reporter_tpu_torch.parallel.multihost import (initialize_multihost,
                                                   shutdown_multihost)
assert initialize_multihost(sys.argv[1], 1, 0) is True
x = torch.arange(8, dtype=torch.float32, device="cuda")
dist.all_reduce(x)
torch.cuda.synchronize()
ok = bool(torch.equal(x.cpu(), torch.arange(8, dtype=torch.float32)))
backend = dist.get_backend()
shutdown_multihost()
shutdown_multihost()
print("GROUP", backend, ok, dist.is_initialized(), flush=True)
"""


def mesh_group_phase(card):
    """[mesh:group]: a 1-process nccl group through initialize_multihost
    in a subprocess: an all_reduce on the card, then shutdown (twice:
    idempotent)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPORTER_TPU_")}
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _GROUP_CODE,
                           f"localhost:{port}"], capture_output=True,
                          text=True, env=env, timeout=MESH_GROUP_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("GROUP ")), "")
    ok = proc.returncode == 0 and line == "GROUP nccl True False"
    phase("mesh:group", card, returncode=proc.returncode, answer=line,
          seconds=seconds, ok=ok)
    if not ok:
        raise SystemExit("[mesh:group] the nccl group failed:\n"
                         + proc.stderr[-3000:])


# [lockdep]: a child armed by RTPU_LOCKDEP=1 before any import (the timed
# phases of this process stay unarmed) drives a short threaded load on the
# card: /reports from LOCKDEP_CLIENTS threads through the scheduler, one
# fleet round from LOCKDEP_SUBMITTERS threads under leases, one columnar
# stream round; it prints its ledger as one JSON line
_LOCKDEP_CODE = """
import json, sys, threading, time
t0 = time.perf_counter()
from reporter_tpu_torch.utils import locks
assert locks.armed(), "RTPU_LOCKDEP=1 did not arm the port's lockdep"
from reporter_tpu_torch.analysis import concurrency_contract as contract
from reporter_tpu_torch.config import Config, MatcherParams, StreamingConfig
from reporter_tpu_torch.fleet import FleetResidency
from reporter_tpu_torch.matcher.api import Trace
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.service.app import make_app
from reporter_tpu_torch.streaming import ColumnarStreamPipeline, pack_records
from reporter_tpu_torch.tiles.compiler import compile_network
clients, per_client, submitters = (int(a) for a in sys.argv[1:4])
ts = compile_network(generate_city("sf"))
small = compile_network(generate_city("tiny"))
fleet = synthesize_fleet(ts, clients * per_client, num_points=40, seed=5)
app = make_app(ts, device="cuda")
errors = []
def client(i):
    try:
        for p in fleet[i::clients]:
            out = app.report_one(p.to_report_json())
            assert "segments" in out, out
    except Exception as e:
        errors.append(repr(e))
th = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
[t.start() for t in th]
[t.join() for t in th]
app.close()
pinned = Config(matcher=MatcherParams(sweep_autotune=False))
fr = FleetResidency([ts, small], pinned, device="cuda")
names = [ts.name, small.name]
mtr = {t.name: [Trace.from_json(p.to_report_json(), t) for p in
                synthesize_fleet(t, 16, num_points=40, seed=6)]
       for t in (ts, small)}
def submit(i):
    try:
        with fr.lease(names[i % 2]) as m:
            m.match_many(mtr[names[i % 2]])
    except Exception as e:
        errors.append(repr(e))
th = [threading.Thread(target=submit, args=(i,)) for i in range(submitters)]
[t.start() for t in th]
[t.join() for t in th]
pipe = ColumnarStreamPipeline(ts, Config(streaming=StreamingConfig(
    pipeline_depth=1)), device="cuda")
recs = [{"uuid": p.uuid, "lat": float(p.lonlat[t, 1]),
         "lon": float(p.lonlat[t, 0]), "time": float(p.times[t])}
        for t in range(40) for p in fleet]
pipe.queue.append_columns(pack_records(recs))
pipe.step()
pipe.drain()
pipe.close()
snap = locks.global_dep().snapshot()
edges = sorted(map(list, snap["edges"]))
print(json.dumps({
    "seconds": time.perf_counter() - t0, "errors": errors,
    "edges": edges, "violations": [str(v) for v in snap["violations"]],
    "unknown_edges": [e for e in edges
                      if tuple(e) not in contract.LOCK_ORDER_EDGES]}))
"""
LOCKDEP_CLIENTS, LOCKDEP_PER_CLIENT, LOCKDEP_SUBMITTERS = 16, 3, 4
AUDIT_TIMEOUT_S = 300         # [lockdep], [analysis:*]: each child's limit

# [analysis:device] and [analysis:manifest]: the port's --device gate on
# the card, in a process of its own (sync-debug "error" is process-wide):
# the device contract, then the compile manifest against its golden block
ANALYSIS_ARGV = ("-m", "reporter_tpu_torch.analysis", "--device", "--on",
                 "cuda", "--json")


def _child(argv, env=None):
    """Start ``python *argv`` from the checkout's root."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen([sys.executable, *map(str, argv)],
                            cwd=here, env={**os.environ, **(env or {})},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _child_json(proc, tag, n):
    """The ``n`` JSON lines a child printed and its exit code; raises on a
    child that ran past its limit or printed another count of lines."""
    try:
        out, err = proc.communicate(timeout=AUDIT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SystemExit(f"[{tag}] the child ran past {AUDIT_TIMEOUT_S} s")
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    if len(lines) != n:
        raise SystemExit(f"[{tag}] the child exited {proc.returncode} with "
                         f"{len(lines)} of {n} result lines:\n{err[-3000:]}")
    return lines, proc.returncode


def lockdep_start(cache):
    """[lockdep]'s child, started (runs beside [analysis:*]'s)."""
    return _child(("-c", _LOCKDEP_CODE, LOCKDEP_CLIENTS, LOCKDEP_PER_CLIENT,
                   LOCKDEP_SUBMITTERS),
                  env={"RTPU_LOCKDEP": "1", "RTPU_AUTOTUNE_CACHE": cache})


def lockdep_phase(card, proc, t0):
    """[lockdep]: the armed child's ledger; fails on any violation, error
    or edge outside the port's contract."""
    (res,), rc = _child_json(proc, "lockdep", 1)
    phase("lockdep", card, seconds=time.perf_counter() - t0,
          child_seconds=res["seconds"], clients=LOCKDEP_CLIENTS,
          reports=LOCKDEP_CLIENTS * LOCKDEP_PER_CLIENT,
          fleet_submitters=LOCKDEP_SUBMITTERS, edges=res["edges"],
          violations=res["violations"], unknown_edges=res["unknown_edges"],
          errors=res["errors"])
    if res["violations"] or res["unknown_edges"] or res["errors"] or rc:
        raise SystemExit(f"[lockdep] violations, unknown edges or errors "
                         f"(the child exited {rc})")


def analysis_phase(card, proc, t0):
    """[analysis:device] and [analysis:manifest] from the --device gate's
    child (its exit code is 1 on an unwaived finding or a drift)."""
    (dev, man), rc = _child_json(proc, "analysis", 2)
    phase("analysis:device", card, seconds=dev["seconds"],
          device=dev["device"], cases=dev["cases"],
          staging_cases=dev["staging_cases"], aten_ops=dev["aten_ops"],
          findings=len(dev["findings"]), unwaived=dev["unwaived"],
          sync_debug="error")
    if dev["unwaived"] or not dev["device"].startswith("cuda"):
        raise SystemExit("[analysis:device] unwaived findings, or not on "
                         "the card")
    m = man["manifest"]
    phase("analysis:manifest", card, seconds=man["seconds"],
          wall_seconds=time.perf_counter() - t0, problems=man["problems"],
          ptxas=m["ptxas"], launch=m["launch"])
    if man["problems"] or rc:
        raise SystemExit(f"[analysis:manifest] drift from the golden block "
                         f"(the child exited {rc})")


def profile_phase(card, m, traces):
    """[profile]: one sf batch of the tuned matcher under the matcher's
    own device_trace hook (REPORTER_TPU_TRACE_DIR set for the call): the
    Chrome trace's size, its sweep kernel events and the CUDA kernels in
    the window."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()          # the window starts on an idle card
    out_dir = os.path.join(SCRATCH, "profile")
    if os.path.isdir(out_dir):
        for fn in os.listdir(out_dir):
            os.unlink(os.path.join(out_dir, fn))
    os.environ["REPORTER_TPU_TRACE_DIR"] = out_dir
    try:
        t1 = time.perf_counter()
        m.match_many(traces)
        batch_s = time.perf_counter() - t1
    finally:
        del os.environ["REPORTER_TPU_TRACE_DIR"]
    files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    if len(files) != 1:
        raise SystemExit(f"[profile] expected one trace file, got {files}")
    path = os.path.join(out_dir, files[0])
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    sweep = [e for e in kernels if "sweep_exact_kernel" in e.get("name", "")]
    # the host-side span round each sweep launch (ops.dense_candidates
    # sweep_topk)
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "sweep_exact_kernel"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "")]
    phase("profile", card, seconds=time.perf_counter() - t0,
          traced_batch_s=batch_s, traces=len(traces), trace_file=files[0],
          trace_bytes=os.path.getsize(path), events=len(events),
          cuda_launch_calls=len(launches), cuda_kernels=len(kernels),
          sweep_exact_kernels=len(sweep), sweep_exact_spans=len(spans))
    # the window is whole: the sweep's kernel record is there, and every
    # launch has its kernel (a later profiler session of a process has
    # lost its window's first kernel records)
    if not (spans and sweep and launches
            and len(kernels) == len(launches)):
        raise SystemExit(f"[profile] the trace holds {len(spans)} sweep "
                         f"launch spans, {len(sweep)} sweep kernels, "
                         f"{len(launches)} CUDA launches and {len(kernels)} "
                         "kernels")


def api_phase(card):
    """[api]: every name of the port's top-level API resolves, to an
    object of that name from the port's own modules."""
    import reporter_tpu_torch

    t0 = time.perf_counter()
    bad = {}
    for name in sorted(reporter_tpu_torch._LAZY):
        obj = getattr(reporter_tpu_torch, name)
        mod = getattr(obj, "__module__", "") or ""
        if obj.__name__ != name or not mod.startswith("reporter_tpu_torch."):
            bad[name] = f"{mod}.{obj.__name__}"
    jaxish = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "reporter_tpu"))
    phase("api", card, names=len(reporter_tpu_torch._LAZY), wrong=bad,
          jax_modules=jaxish, seconds=time.perf_counter() - t0)
    if bad or jaxish or len(reporter_tpu_torch._LAZY) != API_NAMES:
        raise SystemExit(f"[api] names that do not resolve to the port's "
                         f"counterpart: {bad}; jax modules: {jaxish}")


API_NAMES = 18                # the JAX package's 17 and FleetResidency
EXAMPLE = os.path.join("examples", "torch_quickstart.py")
EXAMPLE_MARKERS = ("POST /report", "GET /stats", "segments",
                   "matcher on cuda")
EXAMPLE_TIMEOUT_S = 300


def examples_start():
    """[examples]' child, the port's quickstart on the card, and a thread
    that waits for it (its exit time is the child's own seconds)."""
    t0 = time.perf_counter()
    proc = _child((EXAMPLE, "--device", "cuda"))
    done = {}

    def wait():
        try:
            done["out"] = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
        done["seconds"] = time.perf_counter() - t0

    waiter = threading.Thread(target=wait, name="examples-wait",
                              daemon=True)
    waiter.start()
    return proc, waiter, done


def examples_phase(card, child):
    """[examples]: the quickstart exited 0 with its markers."""
    proc, waiter, done = child
    waiter.join(EXAMPLE_TIMEOUT_S + 30)
    if "out" not in done:
        raise SystemExit(f"[examples] {EXAMPLE} ran past "
                         f"{EXAMPLE_TIMEOUT_S} s")
    out, err = done["out"]
    missing = [m for m in EXAMPLE_MARKERS if m not in out]
    phase("examples", card, example=EXAMPLE, device="cuda",
          returncode=proc.returncode, missing_markers=missing,
          stdout_lines=len(out.splitlines()), seconds=done["seconds"])
    if proc.returncode or missing:
        raise SystemExit(f"[examples] {EXAMPLE} exited {proc.returncode}, "
                         f"markers missing {missing}:\n{err[-3000:]}")


# the two lines whose fields come from a dict built at run time
STAR_PHASES = ("mesh:dp", "build:exact_shape")


def bench_delta_phase(card):
    """[bench_delta]: this run's phase lines through the port's
    regression sentinel. Every numeric field must classify or be neutral
    (the runtime twin of the lint's bench-coverage rule), the two
    **fields lines among them, and the run compared with itself must
    find no regression and no drift."""
    from reporter_tpu_torch.analysis import bench_delta

    t0 = time.perf_counter()
    log = bench_delta.parse_log("\n".join(LINES))
    missing = bench_delta.unclassified_fields(log)
    self_diff = bench_delta.compare(log, log)
    star = {tag: sum(1 for t in log["tags"].values() if t == tag)
            for tag in STAR_PHASES}
    phase("bench_delta", card, lines=log["lines"], keys=len(log["phases"]),
          compared=self_diff["compared"], unclassified=missing,
          star_phase_lines=star, link=self_diff["link"]["new"],
          seconds=time.perf_counter() - t0)
    if missing or not all(star.values()) or self_diff["regressions"] \
            or self_diff["link_attributable"] or self_diff["card_drift"] \
            or self_diff["only_old_keys"] or self_diff["only_new_keys"] \
            or not self_diff["compared"]:
        raise SystemExit(f"[bench_delta] numeric fields neither classified "
                         f"nor neutral: {missing}; **fields lines {star}")


def _tail(path, n=30):
    with open(path) as f:
        return "".join(f.readlines()[-n:])


def main() -> int:
    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port's modules: a copy of this script without the repo stops here
    from reporter_tpu_torch.analysis import compile_manifest
    from reporter_tpu_torch.config import CompilerParams, MatcherParams
    from reporter_tpu_torch.kernels import build
    from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
    from reporter_tpu_torch.native import build as native_build
    from reporter_tpu_torch.netgen.synthetic import generate_city
    from reporter_tpu_torch.netgen.traces import synthesize_fleet
    from reporter_tpu_torch.ops import dense_candidates as dc
    from reporter_tpu_torch.service.app import make_app
    from reporter_tpu_torch.tiles.compiler import compile_network
    from reporter_tpu_torch.tiles.tileset import tables_from_numpy
    from reporter_tpu_torch.utils import linkhealth

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = smi.strip()
    print(card, flush=True)
    phase("device", card, torch=torch.__version__, cuda=torch.version.cuda,
          name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    api_phase(card)

    # ---- 2. build: every K's nvcc and the host library's g++ at once ------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        cuda_job = pool.submit(build.build_all)
        host_job = pool.submit(native_build.load)
        cuda_job.result()
        host_job.result()
    built = {lib: {"nvcc_seconds": log["seconds"],
                   "kernels": compile_manifest.ptxas_figures(log["ptxas"])}
             for lib, log in build.BUILD_LOG.items()}
    # a library already built from the same sources (by an earlier run in
    # this checkout) is loaded, not rebuilt, and shows no build time
    phase("build", card, seconds=time.perf_counter() - t0, sources=built,
          host_library={"sources": list(HOST_SOURCES),
                        "gxx_seconds": native_build.BUILD_LOG.get("seconds")})
    # the persistent grid is min(chunks, CTAs per SM x SMs); the kernel
    # phase runs 512 chunks
    # the wide library's shape follows K (its lists in shared memory, or
    # past the arm's shared_max_k in the scratch): one per K of WIDE_KS
    shapes = {}
    for k in (*dc.SWEEP_KS, *WIDE_KS):
        for code, arm in enumerate(dc.SWEEP_ARMS):
            sh = build.exact_shape(code, k)
            sh["grid_at_512_chunks"] = min(512, sh["ctas_per_sm"] * sh["sms"])
            sh["lists"] = dc.list_plan(arm, k)[0]
            shapes[f"{arm}@k{k}"] = sh
    # lint: allow[bench-coverage] 2026-10-18 one launch shape per arm and K
    # (kernels/build.exact_shape); [bench_delta] reads the printed line
    phase("build:exact_shape", card, **shapes)

    # ---- 3. tiles ---------------------------------------------------------
    t0 = time.perf_counter()
    ts = compile_network(generate_city("sf"))
    tab = tables_from_numpy(ts.arrays(), "cuda")
    phase("tiles", card, metro="sf", seconds=time.perf_counter() - t0,
          edges=ts.num_edges, line_segments=int(len(ts.seg_edge)),
          seg_pack_columns=int(tab["seg_pack"].shape[1]),
          blocks=int(tab["seg_bbox"].shape[0]))
    tiles_native_phase(card, ts, "sf")

    # ---- 4. kernel vs plain, at K = 8 and at every K -----------------------
    fleet = synthesize_fleet(ts, N_TRACES, num_points=N_POINTS, seed=0)
    pts = torch.from_numpy(fleet_points(fleet)).cuda()      # [131072, 2]
    radius = MatcherParams().search_radius
    arms = kernel_phase(card, tab, pts, radius, 8, dc, build, "sf")
    by_k = {k: kernel_phase(card, tab, pts, radius, k, dc, build, "sf",
                            tag="kernel:k", check_chunks=CHECK_CHUNKS)
            for k in dc.SWEEP_KS}
    kernel_between_phase(card, tab, pts, radius, dc, "sf")
    # past the register widths: the wide instances at each K of WIDE_KS,
    # and the register K = 16 beside them, at a radius where lists evict;
    # each wide line with its ratio to that K = 16
    t_wide = time.perf_counter()
    k16 = dc.SWEEP_KS[-1]
    wide = {k16: kernel_phase(card, tab, pts, WIDE_RADIUS, k16, dc, build,
                              "sf", tag="kernel:k",
                              check_chunks=CHECK_CHUNKS)}
    for k in WIDE_KS:
        wide[k] = kernel_phase(card, tab, pts, WIDE_RADIUS, k, dc, build,
                               "sf", tag="kernel:k",
                               check_chunks=CHECK_CHUNKS, versus=wide[k16])
    phase("kernel:wide", card, seconds=time.perf_counter() - t_wide,
          search_radius=WIDE_RADIUS)
    gates_phase(card, dc, radius, 8)

    # ---- 5. main path (calibration included), walk, breakdown, reference -
    win = Windows(dc)
    with tempfile.TemporaryDirectory(prefix="rtt_autotune_") as cache:
        os.environ["RTPU_AUTOTUNE_CACHE"] = cache     # every run calibrates
        m, traces, recs, fields, cand_ms = main_phase(
            card, ts, fleet, dc, win, "sf", MatcherParams, SegmentMatcher,
            Trace)
        walk_phase(card, m, ts, traces, recs, fields, MatcherParams,
                   SegmentMatcher, "sf")
        # the process's first profiler session (a later one can lose the
        # first kernel records of its window)
        profile_phase(card, m, traces)
        main_k_phase(card, ts, traces, dc, win, MatcherParams, SegmentMatcher,
                     cache)
        viterbi = viterbi_phase(card, m, traces)
        breakdown_phase(card, m, ts, traces, cand_ms, MatcherParams)

        here = os.path.dirname(os.path.abspath(__file__))
        with open(os.path.join(here, "tests", "fixtures",
                               "golden_traces.json")) as f:
            golden = json.load(f)
        gts = compile_network(generate_city(golden[0]["city"]),
                              CompilerParams(**golden[0]["compiler"]))
        gm = SegmentMatcher(gts)
        golden_ok = all([s["segment_id"] for s in gm.match(g["request"])["segments"]]
                        == g["expected_segment_ids"] for g in golden)
        gapp = make_app(gts, device="cuda")
        golden_app = [wsgi_post(gapp, "/report", g["request"]) for g in golden]
        gapp.close()
        golden_app_ok = all(
            st == 200 and [s["segment_id"] for s in body["segments"]]
            == g["expected_segment_ids"]
            for (st, body), g in zip(golden_app, golden))
        small = traces[:REFERENCE_TRACES]
        cpu_recs = SegmentMatcher(ts, device="cpu").match_many(small)
        cpu_ok = json_records(cpu_recs) == json_records(
            recs[:REFERENCE_TRACES])
        phase("reference", card, golden_fixture_ok=golden_ok,
              golden_app_report_ok=golden_app_ok,
              golden_plan=gm.tuned_plan and gm.tuned_plan.label,
              card_vs_cpu_records_equal=cpu_ok, traces_checked=len(small))
        if not (golden_ok and golden_app_ok and cpu_ok):
            raise SystemExit("reference check failed")
        oracle_phase(card, ts, traces, recs, cpu_recs, "sf")

        # ---- the grid candidate backend and ranked paths (sf) -----------
        lattice = lattice_kernel_phase(card, ts, m, traces)
        grid_k = grid_kernel_phase(card, ts, pts)
        # past K = 64: the Viterbi's and the lattice's wide instances on
        # the main path, held to their plain versions and the CPU
        viterbi.update(wide_decode_phase(card, ts, traces, win))
        grid_phase(card, ts, pts, m, traces, recs, dc, win)
        topk_phase(card, ts, m, traces, dc, win)

        # ---- restricted and per-mode sf, PBF input ----------------------
        ts_r = restrict_phase(card, dc, win, cache, ts, traces)
        bike = modes_phase(card, dc, win, cache)
        modes_server_phase(card, bike, cache)
        pbf_phase(card)

        # ---- 6. the organic metro -----------------------------------------
        organic, ts_o = organic_phase(card, dc, build, win, MatcherParams,
                                      SegmentMatcher, Trace, generate_city,
                                      compile_network, tables_from_numpy,
                                      synthesize_fleet, radius)

        # ---- the tile tools: capacity, the command line, the audit -------
        staged = capacity_phase(card, [("sf", ts), (ts_r.name, ts_r),
                                       ("organic", ts_o)])
        tiles_cli_phase(card, ts, staged["sf"])
        reach_audit_phase(card, [("sf", ts), (ts_r.name, ts_r)])

        # ---- 7. the report service, in-process and as the entry point ---
        served = serve_phase(card, ts, fleet, dc, win, cache)
        server_phase(card, served, cache)
        router_tiles = router_phase(card, dc, win, cache)

        # ---- the fleet: 12 metros paged on one card ---------------------
        fleet_st = fleet_phase(card, dc, win, cache, [*router_tiles, ts_o])
        fleet_storm_phase(card, fleet_st)
        fleet_fidelity_phase(card, dc, win, fleet_st)
        guard_ts = fleet_st["tiles"][len(router_tiles) + 1]
        del fleet_st, ts_o
        fleet_router_phase(card, cache, router_tiles)
        fleet_guard_phase(card, cache, guard_ts)

        # ---- 8. the streaming worker: dict, columnar, recovery, entry ----
        ref = stream_phase(card, ts, fleet, dc, win, cache)
        cols = stream_columnar_phase(card, ts, dc, win, ref)
        stream_recover_phase(card, ts, win, ref, cols, cache)
        stream_worker_phase(card, ts, win, ref, cols, cache)
        kafka_phase(card, ts, dc, win, ref, cache)

        # ---- 9. the supervised topology: N workers on one card ----------
        st = topo_stage(card, ts, ref, cache, win)
        topo_phase(card, st)
        topo_scale_phase(card, st)
        topo_lease_phase(card, st)

        # ---- 10. the watchdog, the shadow audit and backfill (sf) -------
        since = linkhealth.sampler().clock()
        watchdog_phase(card, ts, fleet, m, dc, win)
        link_phase(card, since)
        guard_phase(card, ts, traces, dc, win, cache)
        audit_phase(card, m, traces, dc, win)
        backfill_phase(card, ts, fleet, m, dc, win)

        # ---- 11. multi-GPU: the mesh's programs (sf; sf, nyc, la) ---
        t_mesh = time.perf_counter()
        mesh_dp_phase(card, ts, traces, recs, m, fields, dc, win)
        mesh_sharded_phase(card, ts, fleet, dc, win)
        mesh_metro_phase(card, router_tiles, dc, win)
        mesh_backfill_phase(card, ts, stream_rounds(fleet), m, dc, win)
        mesh_group_phase(card)
        phase("mesh", card, seconds=time.perf_counter() - t_mesh)

        # ---- the port's gates on the card: lockdep, the device contract
        #      and the compile manifest, in children side by side --------
        t_gates = time.perf_counter()
        lockdep_proc = lockdep_start(cache)
        analysis_proc = _child(ANALYSIS_ARGV)
        examples = examples_start()
        lockdep_phase(card, lockdep_proc, t_gates)
        analysis_phase(card, analysis_proc, t_gates)
        examples_phase(card, examples)
        phase("gates", card, seconds=time.perf_counter() - t_gates)
    bench_delta_phase(card)

    # ---- 12. summary -------------------------------------------------------
    kernels = []
    for arm, (_, replaces) in ARMS.items():
        for k in dc.SWEEP_KS:
            a = arms[arm] if k == 8 else by_k[k][arm]
            paths = {path: c.get((arm, k), 0)
                     for path, c in win.by_path.items()
                     if c.get((arm, k), 0)
                     or path in ("sf:topk", "sf:grid", "fleet")
                     or path.startswith("mesh:")}
            entry = {
                "name": f"sweep_topk_{arm}_k{k}", "route": "cuda",
                "source": SOURCES[0], "replaces": replaces,
                "launches": sum(paths.values()), "launches_by_path": paths,
                "points": len(pts), "plain_points": a["plain_points"],
                "max_abs_err": a["max_abs_err"], "ms": a["ms"],
                "ms_back_to_back": a["ms_back_to_back"],
                "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                "bound_by": a["bound_by"], "library_ms": None}
            if k == 8:
                o = organic[arm]
                entry["organic"] = {key: o[key] for key in (
                    "ms", "ms_back_to_back", "bound_ms", "bound_by",
                    "plain_ms", "plain_points", "max_abs_err")}
            if entry["launches"] < 1:
                raise SystemExit(f"{arm} at K={k} was never launched on the "
                                 "main path")
            kernels.append(entry)
        # the wide instances served on the main path: the lists in shared
        # memory at MAIN_WIDE_K, in the global scratch at MAIN_SCRATCH_K
        for label, k in (("wide", MAIN_WIDE_K), ("scratch", MAIN_SCRATCH_K)):
            a = wide[k][arm]
            key = dc.launch_key(arm, k)
            paths = {path: c.get(key, 0) for path, c in win.by_path.items()
                     if c.get(key, 0)}
            entry = {
                "name": f"sweep_topk_{arm}_{label}", "route": "cuda",
                "source": SOURCES[0], "replaces": replaces,
                "k": k, "search_radius": WIDE_RADIUS,
                "launches": sum(paths.values()), "launches_by_path": paths,
                "points": len(pts), "plain_points": a["plain_points"],
                "max_abs_err": a["max_abs_err"], "ms": a["ms"],
                "ms_back_to_back": a["ms_back_to_back"],
                "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                "bound_by": a["bound_by"], "library_ms": None}
            if label == "wide":
                entry["ms_by_k"] = {kw: wide[kw][arm]["ms"] for kw in WIDE_KS}
            if entry["launches"] < 1:
                raise SystemExit(f"{arm}'s {label} instance at K={k} was "
                                 "never launched on the main path")
            kernels.append(entry)
    # the batched Viterbi kernel at each K of [kernel:viterbi] and
    # [wide:decode] (its wide instances), its launches at that K in every
    # main-path window
    for k, a in viterbi.items():
        paths = {path: c[k] for path, c in win.viterbi_by_path.items()
                 if c.get(k, 0)}
        entry = {
            "name": f"viterbi_decode_k{k}", "route": "cuda",
            "source": VITERBI_SOURCE, "replaces": VITERBI_REPLACES, "k": k,
            "kernel": a["kernel"], "instance": a["instance"],
            "search_radius": a["search_radius"],
            "launches": sum(paths.values()), "launches_by_path": paths,
            "mismatches": a["mismatches"], "max_abs_err": a["max_abs_err"],
            "ms": a["ms"], "ms_back_to_back": a["ms_back_to_back"],
            "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": None}
        if "long_lists" in a:
            entry["long_lists"] = a["long_lists"]
        if entry["launches"] < 1:
            raise SystemExit(f"the Viterbi kernel at K={k} was never "
                             "launched on the main path")
        kernels.append(entry)
    # the ranked-path lattice's three kernels and the grid kernel, their
    # launches in every main-path window; each with the cases its
    # instance ran (K = 64; K = 96 at 150 and 250 m)
    singles = [(LATTICE_KERNELS[key][0], LATTICE_SOURCE,
                LATTICE_KERNELS[key][1], lattice[key],
                {path: c.get(key, 0)
                 for path, c in win.lattice_by_path.items()},
                key, lattice[key])
               for key in LATTICE_KERNELS]
    # the lattice's wide instances at K = 96 (the forward's, the
    # backtrack's levels read in place at R = 96), each counted under its
    # own key
    for kernel in ("forward", "backtrack"):
        a = lattice[kernel]["k96_r96"]
        key = a["instance"]
        singles.append((
            f"lattice_{key.replace(':', '_')}", LATTICE_SOURCE,
            LATTICE_KERNELS[kernel][1], a,
            {path: c.get(key, 0) for path, c in win.lattice_by_path.items()},
            key, lattice[kernel]))
    singles.append(("grid_candidates", GRID_SOURCE, GRID_REPLACES, grid_k,
                    {path: sum(c.values())
                     for path, c in win.grid_by_path.items()}, None, grid_k))
    for name, source, replaces, a, by_path, inst, cases in singles:
        paths = {path: n for path, n in by_path.items() if n}
        entry = {
            "name": name, "route": "cuda", "source": source,
            "kernel": LATTICE_FUNCTIONS.get(inst, "grid_candidates_kernel"),
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths,
            **{key: a[key] for key in (
                "mismatches", "max_abs_err", "ms", "ms_back_to_back",
                "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            **{key: v for key, v in cases.items()
               if isinstance(v, dict) and v.get("instance", inst) == inst}}
        if entry["launches"] < 1:
            raise SystemExit(f"{name} was never launched on the main path")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels, "sources": list(SOURCES),
                      "host_library": {
                          "sources": list(HOST_SOURCES), "route": "g++",
                          "seconds": native_build.BUILD_LOG.get("seconds")}}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
