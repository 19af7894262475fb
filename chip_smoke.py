#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths (``llm_d_kv_cache_manager_tpu_torch``) at the
full width and depth of Llama-3-8B with random weights from a seed, and
its training, MoE and checkpoint paths at the widths noted below.
The serving path: the port's ``Indexer`` scores a prompt's text
(tokenization pool and prefix store, block-hash chain, in-memory block
index, longest-prefix scorer) and the chosen pod serves it by prefill
(index miss) or by continuation over the cached prefix (index hit),
then decodes.  The card's machine has no tokenizer library, so the
Indexer is given a word tokenizer (``"t<id>"`` words, ``WordTokenizer``).  The long-context prefill path: one 8192-token prompt
through ``forward(sp_mesh=...)``, ring attention over a 4-rank ``sp``
mesh whose ranks share the card, in both sequence layouts.  The
offload path: the served prefix is stored to files through the offload
connector and served on another pod from them.  Training: AdamW steps
at Llama-3-8B's widths, cut to 8 of its 32 layers, with a checkpoint of
the state saved, restored onto the card and resumed.  The MoE family at
its one configuration, ``MoEConfig()``: a forward over 8192 tokens on the
prefill kernel and on the ring, and train steps.  Before that, it builds
the hand-written kernels from ``csrc/`` with nvcc and the native
I/O engine from ``native/src/`` with g++, and holds each kernel against
its plain PyTorch version at the shapes the paths give it.  Last, the
sharded paths over the dp x pp x tp x sp x ep mesh, with every rank on
the one card.  It imports nothing of JAX or the JAX package.

Phases (any failure exits non-zero):
  1. environment: card name and power limit, versions, kernel build
     with each kernel's registers and spills (``-Xptxas -v``);
  2. prefill kernel vs its plain version (full prefill, continuation,
     small edge cases), element by element within ``LIMITS``, with
     kernel (device time, from a CUDA graph, and back-to-back calls),
     plain and library times, the card's bound, the achieved TFLOP/s,
     the kernel/library ratio and the share of the bound; at
     the serving shapes the same limit must reject a planted fault (one
     key tile skipped);
  3. decode kernel vs its plain version (the serving batch, B=1 at the
     context of 5c's and 7c's last decode step, B=4, B=16,
     shuffled tables, ragged contexts down to 1, sequences that end on
     and just past a CTA's run, one inside a run beside one cut over
     all, G = 1 and 2, tables wider than any context), likewise, the
     planted fault being one CTA's partial dropped; an empty context
     must give 0 and three replays of one CUDA graph the same bits;
  4. ring partial kernel vs its plain version (causal offsets None, 0
     and -1 at one rank's chunk of the ring prefill, small edge cases
     including the exact empty-row sentinel), likewise, on the
     normalized output acc/l and on m and l, the planted fault being
     one key tile skipped; phases 2-4 also hold each kernel at the
     shapes other models give it (``SHAPE_*``: head dims 32 to 256,
     groups up to 16, pool blocks of 8 to 128 tokens; timed at serving
     length, ragged edges untimed, float32 at 32, 96 and 256), and a
     head dim outside the set must raise ``ValueError`` from every
     wrapper before any launch;
  5. serving: two simulated pods routed by the port's ``Indexer``
     (``get_pod_scores`` over the prompt's text; A misses with every pod
     at 0.0, B hits pod-a, its score over the blocks of the tokens the
     prefix store serves from A's text, and reuses its 512 prefix
     blocks); each pod publishes the blocks it wrote as KV events
     (``BlockStored`` with its own ``sha256_cbor`` hashes, evictions as
     ``BlockRemoved``), framed ``kv@<pod>@<model>`` with a seq, which
     reach the index only through ``parse_event_message`` and the event
     pool of a ``PrecisePrefixCacheScorer`` built around the Indexer (the
     event lag, publish to keys in the index, printed apart from TTFT);
     the scorer's ``score`` of B's completion gives pod-a 1.0, pod-b 0.0;
     a miss, a hit, 8 decode steps replayed
     from one captured CUDA graph (``make_decode_step``), which must
     launch the prefill kernel once per layer per request and the
     decode kernel once per layer per step (counted from the kernels the
     profiler sees a replay run); the eager ``decode_step`` over the same
     eight inputs on a copy of the pool must give the same logits,
     tokens and pool bytes; then the prefix-hit contract, chunked
     prefill and decode are checked against fresh full passes and the
     device time of each step is broken down by kernel category;
 5c. serving through the service, right after phase 5's checks: the
     port's ``api.http_service.serve`` over a metrics-wrapped Indexer on
     phase 5's index (filled only by the pods' KV events); request C, phase 5's
     8192-token prefix and 256 new tokens (``padded_words``: its text is
     new to the prefix store, so the pool tokenizes it in full), by
     ``POST /score_completions?explain=1`` with a sampled traceparent over
     a keep-alive connection, its scores exactly those of
     ``get_pod_scores`` in-process and pod-a's 512 prefix blocks; pod-a
     continues C on the prefill kernel (one launch a layer) and decodes
     4 tokens eagerly on the decode kernel (one launch a layer a step),
     each decode call and each call of a second run of the continuation
     (its logits bit-equal) held against the plain version on its inputs;
     TTFT from the POST to the first token, the HTTP round trip apart;
     pod-a publishes C's 16 new blocks as KV events and C's second score
     over HTTP rises by exactly those 16 at the device tier's weight;
     ``/debug/traces/<id>`` holds the reference's span tree, the lookup
     counter on ``/metrics`` rises by the scoring requests made, and
     ``/healthz`` carries the event-plane block;
 5d. serving at pool block 64, right after 5c: phase 5's miss, hit and
     8 decode steps (one captured graph) over a pool of 64-token
     blocks, logits within the model-level limit of phase 5's and its
     next tokens (``serving_block``);
 5e. the reference's own small configuration (``GRAFT_CFG``, a copy of
     ``__graft_entry__._CFG``: head dim 32): ``forward`` on [2, 64]
     tokens, ``prefill_paged`` and 4 decode steps, bf16 and float32,
     each against ``forward(use_flash=False)`` on the card;
  6. ring prefill: the 8192-token prompt through the striped and the
     contiguous ring and through the dense forward; each ring must
     launch the partial kernel exactly 16 (striped) or 10 (contiguous)
     times a layer and agree with the dense logits; walls and device
     breakdowns as in phase 5;
 6b. the ring across processes: the same prompt through
     ``forward(sp_mesh=make_hybrid_mesh(...))`` over 4 spawned processes
     of one ring rank each, all on the one card, in a gloo group over
     loopback (the parent's params and phase 6's logits reach them as
     CUDA IPC handles; K/V staged through pinned host buffers): each
     process's partial launches its share of phase 6's, its logits equal
     to its rows of phase 6's ring logits (bit for bit, else within phase
     6's tolerance), the dense forward's last-position token, its walls,
     staging copies and gloo waits per ring step and device idle share
     beside phase 6's; process 0 holds each of its partial launches
     against the plain version and times the kernel at a rank's shape;
     last, an NCCL group of 2 ranks on the one card is tried and its
     answer printed (NCCL refuses two ranks on one device);
  2-4 also hold the prefill and ring partial kernels at the MoE
     forward's shapes (8 heads, 4 KV heads, 8192 tokens, a 2048-token
     ring chunk), planted faults included;
 4b. the layer kernels (``csrc/layer_fused.cu``: RMSNorm, RoPE with the
     K/V pool write, SiLU(gate) * up) at the benchmark's shapes (a
     Mistral continuation of 256 tokens, its decode at bucket 16,
     DeepSeek's decode batch of 24), each against its plain chain on the
     card: RoPE and SiLU bit for bit, RMSNorm within one bf16 rounding
     (a zeroed column rejected); kernel and plain device times from a
     CUDA graph and back to back, beside the bytes bound (phase 15's
     ``kernels`` line carries them, with each kernel's launches on every
     main path: 5, 5c, 5d, 5e, 7b, 7c, and 0 on 12a's tp path);
 4c. Mellum2-12B-A2.5B's kernels at the ``mellum2.repo-agent`` cell's
     shapes (``python3 chip_smoke.py 4c`` runs this phase alone after the
     build): the windowed prefill and decode kernels, the YaRN RoPE
     kernel and the routed experts at decode (grouped) and at a prefill
     of 16,384 tokens (per-expert products; held beside the float64
     value of their routing), each with a planted fault; the grouped
     kernels and the products timed from 64 to 16,384 tokens; then the
     block's main path at its widths and 4 layers (a prefill, a captured
     decode step's replays, an eager step), every launch and the expert
     layer's device counters held to their counts;
  7. offload: pod-a's 512 prefix blocks (1 GiB) stored through the
     offload connector, one-shot and staged (pinned lanes), on the native
     I/O engine, as 128 files that must equal each other and the pool's
     bytes; a third pod looks them up and loads them from files (one-shot,
     staged, and one-shot after dropping the page cache) and from a host
     tier, each time bit-equal to pod-a's blocks, and continues request B
     over them, which must give phase 5's hit logits; store, load and
     offload-hit TTFT timed, and the copies apart against their bounds;
 7c. the vLLM connector, right after phase 7: the port's
     ``offload.vllm_spec.TPUSharedStorageOffloadingSpec`` built from
     duck-typed vLLM config objects with the reference's documented
     settings (256-token files, 8 threads a chip, 16 GB of staging); (i)
     over the serving pool's own tensors, ``pool.kv[l]`` a layer (the
     standard layout), pod-a's 512 prefix blocks stored as 32 files of
     32 MiB and loaded into 512 zeroed blocks of pod-c (byte-equal,
     ``manager.lookup`` finds 32), B continued there on the prefill
     kernel (logits bit-equal to phase 5's hit) and decoded 2 steps on
     the decode kernel, every call held against its plain version; (ii)
     FlashAttention's split-KV layout, 32 tensors ``[2, 512, 16, 8,
     128]`` on the card filled from pod-a's prefix (64 views), through a
     round trip; both sets of files byte-equal to each other and to the
     files written from a host copy; store and load walls, GB/s against
     PCIe, the per-view copies counted, beside phase 7's connector;
 7b. tiering and transfer, over phase 5's Indexer and event pool and
     phase 7's pods: a ``PolicyEngine`` attached to the Indexer learns
     B's family from scored requests; a ``StagedDemotionTarget`` over
     pod-a's pool demotes its 512 prefix blocks (128 groups keyed by
     phase 7's file hashes) in two ``DemotionWorker`` cycles: hbm ->
     host (device gathers into a host tier, every group equal to phase
     7's files) and host -> shared storage (files equal to phase 7's
     one-shot tree, the host tier freed), the events reaching the index
     as pod-a's so B's score goes 1.0 -> 0.8 -> 0.5 a block; a connector
     over pod-c with ``policy_engine=`` loads the files (the advisor
     counts the loads and the demotion's stores) and the advisor prices
     B's prefix; a ``TransferEngine`` sharing the advisor plans B from
     an overloaded pod-a to pod-c (a priced directive, or the warm-up
     pre-placement when the price says recompute, both printed), pod-c
     loads the bytes, the plan executes through the event pool, B
     routes to pod-c and continues there on the prefill kernel (32
     launches) within the model-level limit of phase 5's hit; a cold
     pod warms up; walls split, advice and the registry's series
     printed;
  8. autograd guard, on the training configuration: with params that
     require grad, the forward on the prefill kernel, the ring forward
     and the decode kernel's wrapper raise before any launch; under
     ``torch.no_grad()`` the forward runs the kernel; ``loss_fn`` (the
     dense op) gives every layer's attention weights and norms finite,
     non-zero gradients; a small float32 step on the card agrees with the
     same step on the CPU (loss, gradients, updated leaves);
  9. training: three AdamW steps at Llama-3-8B widths, 8 layers, bf16,
     one 2048-token sequence each, every loss and leaf finite, no
     prefill kernel launched; ms a step, model TFLOP/s, peak memory;
 10. checkpoint: the state after step 1 (params and AdamW state), saved
     under a fresh temporary directory, restored onto the card into
     ``abstract_like`` targets, bit-equal, and step 2 resumed from it
     gives the uninterrupted step 2's loss (within the spread of two
     identical steps, which it measures); save and restore timed;
 9b. training across processes, after phase 10: 2 spawned processes on
     ``cuda:0`` in a gloo group, phase 9's cut model (8 layers, bf16,
     T=2048) two AdamW steps over ``make_hybrid_mesh`` with dcn dp 2 (a
     batch of two of phase 9's sequences, one a process) and with dcn tp
     2 (phase 9's own); each process's losses held to the single process
     on the same tokens (the parent's batch-2 steps, phase 9's) at 12c's
     limits, the dp replicas' updated params byte-equal (64-bit
     fingerprints); a process's step walls beside the single process's,
     gloo calls, bytes and ms by kind and direction (forward, backward,
     the gradients' sync), staging ms each way, peak memory and the
     device's idle share of the second step;
 12d-across. the tp state after 9b's steps (params and AdamW's state,
     laid out as the params) saved by both processes, each writing only
     its own slices, and restored across them onto dcn pp 2; here, the
     checkpoint read by one process, every slice each process saved and
     restored equal to it (fingerprints), each slice written once, each
     process's read plan its own slices' bytes, then restored onto pp 2
     x tp 2 of one process, every local bit-equal to its slice; save and
     restore seconds, GB/s and each process's peak host RSS;
 11. MoE: ``MoEConfig()``'s bf16 forward over 8192 tokens on the prefill
     kernel (one launch a layer) and on the contiguous ring over sp=4
     (ten a layer), timed beside the dense forward; the float32 kernel and
     ring forwards held against the float32 dense forward at the
     model-level limit, each layer's expert picks compared; three bf16
     train steps at 2048 tokens;
 12. sharded meshes on one card, every rank on ``cuda:0`` (an emulated
     mesh: results and launches, not speed): (a, after phase 7) phase
     5's requests (their block keys from phase 5's Indexer's token
     processor) over params cut by ``param_pspecs`` over tp 2 and a
     pool cut on its kv heads, logits and tokens against phase 5's,
     the captured tp decode step bit-equal to the eager one, 2 x 32
     prefill launches a request and 2 x 32 decode launches a step; (b)
     phase 6's prompt through the tp 2 x sp 4 ring, both layouts
     (2 x 16 and 2 x 10 partial launches a layer), against the dense
     forward; (c, after phase 11) a small float32 step on the
     reference's 8-device plan (dp 1 x pp 2 x tp 2 x sp 2) against the
     unsharded step, then three 8-layer AdamW steps there, each loss
     and step 1's batch after them held to phase 9's at limits that a
     planted fault each crosses (tp rank 1's wo slices zeroed; its
     gradients lost); (d) the 8-layer params saved
     unsharded and restored onto pp 2 x tp 2, every local bit-equal to
     its slice, and one step from them; (e) ``MoEConfig()`` on dp 1 x ep
     2 x tp 2 inside ``activate(mesh)``: ``moe._constrain`` places a
     probe on the active mesh's ranks (a no-op outside it), float32
     against the unsharded forward (expert picks, logits), the bf16
     forward (2 x 8 prefill launches), three train steps; phases 2-4 also hold each
     kernel at the tp shapes (16 heads and 4 KV heads; the MoE's 4 and
     2);
 12f. serving across processes, after 12b: 2 spawned processes on
     ``cuda:0`` in a gloo group over loopback, the parent's 32-layer
     weights and the references as CUDA IPC handles, each process
     holding one copy of what it cannot view (``sharding.share_tree``); phase
     5's miss, hit and 8 eager decode steps over three meshes that
     ``make_hybrid_mesh`` builds in both: tp across the processes
     (logits, tokens and each process's pool slice bit for bit 12a's),
     pp across them (16 layers a process, held to phase 5's, bit for
     bit or within the model-level limit) and the reference's default
     fleet, ``make_hybrid_mesh()`` with dcn dp 2 (A's and a second
     8448-token prompt, one a process, then 8 decode steps, held to the
     parent's batch-2 run over dp 2 on one process: bit for bit or within the
     model-level limit with the same tokens; the pools byte-equal to
     each other, and to the parent's after the prefill; logits and
     pools also within the model-level limit of the unsharded entry
     points' run of the same inputs, which take the layer kernels); then
     ``MoEConfig()`` over ici tp 2 x dcn ep 2 against 12e's single
     controller (bit for bit, else 12e's limits); process 0 holds every
     prefill and decode kernel call against the plain version; walls
     beside 12a's and phase 5's, transfers by kind (gloo ms a call,
     staging ms each way, bytes), each process's device idle share of
     one profiled miss, launches a process; then plain params over an
     ``sp_mesh`` of the two processes, which ``forward`` shares onto it
     (``sharding.share_tree``): ``MoEConfig()`` over ici sp 2 x dcn sp
     2 on phase 11's prompt, logits, aux and each layer's expert picks
     bit for bit the parent's one-process plain ring, and the first 8
     layers over ici tp 2 x dcn sp 2 on phase 6's prompt, both layouts,
     each chunk bit for bit the single controller's on the same layout
     (fingerprints) and within the model-level limit of the 8-layer
     dense forward with its next token; process 0 holds its partial
     launches; launches a process, walls, transfers, idle share, peak
     memory and the bytes the share viewed and copied;
 13. read path, on the host: three Indexers (fast lane, fast lane without
     the score memo, straight path) over metrics-wrapped in-memory
     indexes seeded with 4 pods x 64 random 8192-token conversations
     (131,072 keys, hbm and host) published as KV events (one
     ``BlockStored`` per 2048-token chunk) through a pool each, the
     entries those of the chains (seeding rate and process RSS);
     bench.py's read-path traffic (a resident
     conversation's 8 turns on pod-0 hbm and pod-1 host, 24 cold 8192-token
     prompts, the two alternated), at least 200 requests a cell, p50 and
     p99 ms; every request's scores equal across the lanes and to their
     expected value; the native and the Python block-hash chains timed
     over 8448 tokens, keys equal; one traced fast-lane request whose
     spans must be the reference's (``tokenize`` with
     ``tokenize.prefix_probe`` and ``tokenize.encode`` under it,
     ``hash_blocks``, ``index_lookup``, ``score``); the exposition's lookup
     counter equal to the scoring requests made;
 14. write path, on the host, from phase 13's fleet: (a) its frames seeded
     into fresh indexes through ``parse_event_message`` and
     ``Pool.add_tasks`` in poller bursts, lock-free decode on and off,
     each index's request-key entries equal to phase 13's (events/s,
     blocks/s, decode and apply ms a message, RSS); (b) bench.py's event
     storm (1000 pods, the shared 2-block 32-token payload, 3 s at 6000
     messages/s, then unthrottled if nothing was shed), a quiet pod under
     its budget never shed (applied rate, drops by reason, sheds by pod);
     (c) a pod stores a chunk whose removal is lost with 5 frames: the
     tracker reports a gap of 5, ``ResyncManager`` marks the pod suspect,
     purges and re-applies its inventory, its entries those before the
     gap (staleness ms); (d) ``IndexAuditor`` over the four pods: no
     divergence, then exactly N phantom and M wrong-tier blocks after N
     blocks leave one pod's inventory unannounced and M change tier;
 14b. persistence, on the host, from phase 13's fleet: its frames (and the
     resident conversation's) through a pool with the port's ``Journal``
     tapped in, a snapshot published at half the frames and the rest
     journaled; a restart (fresh index, ``recover()``) whose
     ``dump_entries()`` must equal the live index's and whose scores of
     phase 13's requests, in phase 13's order, must equal its fast lane's
     (snapshot bytes and write ms, recovery split into the snapshot's load
     and the journal's replay, the second half's hit rate warm against a
     fresh index: bench.py's ``bench_indexer_restart`` regime); then the
     journal's last record cut short: the prefix replays and the report
     names the torn tail;
 14c. cluster, on the host: a 3-replica ``LocalCluster`` (strict wire,
     journal-fed followers) seeded with the same frames through a pool
     over its ``RemoteIndex`` (entries equal to phase 13's), phase 13's
     requests through ``Indexer(kv_block_index=RemoteIndex)``, every score
     equal to phase 13's in-memory fast lane, with the owner of the
     conversation's first key killed through its transport half-way (ring
     version and failover counter one up, the hit-rate dip printed); p50
     and p99 beside phase 13's, ``rpc_stats()``; then a purge of pod-1,
     which neither the followers nor a fresh replay of each journal
     brings back;
 14d. service, on the host: a fresh fast-lane Indexer and event pool with
     the port's ``InputCaptureRecorder`` tapped in, seeded with phase 13's
     frames, behind ``api.http_service.serve`` with an ``SloEngine`` of
     the fleet defaults, a started ``SamplingProfiler``, a ``GaugeTimeline``
     of the default series and an ``IncidentManager``; phase 13's requests
     in its order by ``POST /score_completions`` over one keep-alive
     connection, each response equal to phase 13's fast lane's (p50 and p99
     beside its in-process ones, the server's own ``get_pod_scores`` time
     split out of each); ``POST /admin/incident`` writes a bundle
     whose ``capture.cbor`` (every frame and request, nothing truncated)
     ``load_capture`` and ``replay_capture`` replay with every recorded
     score and the index state reproduced (replay ms and records/s); the
     timed requests again from one client process, from 4 at once and
     from 4 threads of the script (requests/s, p99, every answer phase
     13's); ``/debug/``, ``/debug/slo``,
     ``/debug/profile`` (the ``http-handler`` and ``events`` roles
     attributed) and ``/debug/timeline`` answer; last, the what-if
     engine's ``reference_ab()`` over
     ``tests/testdata/whatif_reference.cbor``, its ``gate_headlines``
     equal to ``WHATIF_r01.json``'s;
 14e. gRPC, on the host, when ``grpc`` and ``google.protobuf`` import
     (else it prints which cannot and runs nothing): phase 13's fleet
     behind ``api.indexer_service.serve`` on a Unix socket, its requests
     by ``GetPodScores`` in its order, every answer equal to phase 13's
     (p50 and p99 beside in-process and 14d's HTTP); a sampled traceparent
     echoed in the initial metadata and its trace recorded; the tokenizer
     sidecar (``services.uds_tokenizer.serve``) with the word tokenizer
     registered behind an Indexer built with ``uds_tokenizer_path``, which
     scores a sample of phase 13's requests as the word-tokenizer Indexer
     over the same index does;
 7d. the offload smoke (``hack/offload_smoke_torch.py``'s ``main``, in
     this process) on the card at Llama-3-8B's KV geometry (32 layers,
     8 KV heads, head_dim 128, blocks of 16, bf16: 2 MiB a block): the
     store -> evict -> load round trip through the staged connector
     bit-identical with the pinned staging path on, and the live score
     following the demotions 1.0 -> 0.8 -> 0.5 a block; its store and
     load walls and GB/s printed beside the card's name and power limit;
     then ``StagingConfig(use_pinned=False)`` on a pool on the card at
     that geometry: two files' groups stored through the plain slots and
     through the pinned path, the two trees byte-identical and holding
     the pool's bytes;
 7e. the connector as ``deploy/chart_torch`` deploys it: the chart's
     rendered ``--kv-transfer-config`` (``CHART_KV_TRANSFER_CONFIG``)
     resolved as vLLM's OffloadingConnector does (``spec_module_path``
     imported, ``spec_name`` looked up on it), the spec built at the
     chart's block size 16 and tensor-parallel size 1 with the extra
     config verbatim but for ``shared_storage_path``, re-rooted from
     ``/mnt/shared-kv`` into a temporary directory; pod-a's 8192-token
     prefix stored from split-KV tensors on the card (vLLM
     FlashAttention's layout, 512 blocks at Llama-3-8B's KV geometry,
     1 GiB) as 32 files of 256 tokens under ``<root>/kv-cache/`` and
     loaded into a second pod's fresh tensors at other block ids, byte
     for byte; the spec's threads and staging cap the chart's 8 and
     16 GB; a byte flipped after the load must fail the comparison; its
     walls and GB/s beside the card's name and power limit;
 15. one JSON line listing each kernel's numbers;
  last line: {"ok": true, "device": {...}}.

Usage, from the repository root:  python3 chip_smoke.py [4c]
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import gc
import hashlib
import http.client
import importlib
import json
import math
import os
import queue
import re
import runpy
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

SEED = 0
LAYERS = 32  # Llama-3-8B's full depth
PREFIX_TOKENS = 8192
SUFFIX_TOKENS = 256
DECODE_STEPS = 8
MODEL_NAME = "meta-llama/Llama-3.1-8B"
POOL_BLOCKS = 640  # per pod: A's 528 blocks + B's 16 suffix blocks + 2 decode
# Ring prefill: the ring configuration of the reference's bench (an
# 8192-token prompt over sp=4), its 4 ranks sharing the one card.
RING_SP = 4
RING_TOKENS = 8192
# Phase 6b: the same ring over RING_SP processes of one rank each, all on
# the one card, in a gloo group (its timeout, and the workers' limit
# beside spawn and imports); then NCCL tried with 2 ranks on the card.
RING_GROUP_TIMEOUT_S = 300
NCCL_PROBE_S = 90
# Offload: files of 64 tokens (4 blocks) on 4 I/O threads; pod-c loads
# the prefix from its block 100 on; a warm round, then 3 timed ones.
OFFLOAD_BLOCK = 64
OFFLOAD_THREADS = 4
OFFLOAD_TARGET = 100
OFFLOAD_ROUNDS = 3
HOST_TIER_BYTES = 2 << 30
# Training: Llama-3-8B's widths at 8 of its 32 layers, the depth whose
# bf16 params, gradients and AdamW state (18 GB) and activations fit one
# 80 GB card (PERF.md §4); three steps, each on one 2048-token sequence.
TRAIN_LAYERS = 8
TRAIN_TOKENS = 2048
TRAIN_STEPS = 3
# A small float32 step on the card against the same step on the CPU:
# gradients and updated leaves within atol + rtol * |ref| (float32 sums
# taken in another order), the loss within SMALL_STEP_LOSS_REL.
SMALL_STEP_LIMITS = (1e-6, 1e-4)
SMALL_STEP_LOSS_REL = 1e-5
# MoE: MoEConfig() over one prompt of the ring prefill's 8192 tokens,
# its train steps at 2048.  At float32 a token whose router scores two
# experts within the rounding of two attention paths may take another
# expert; more than 1% of tokens doing so is a fault.
MOE_TOKENS = 8192
MOE_TRAIN_TOKENS = 2048
MOE_PICK_LIMIT = 0.01
# Sharded meshes on one card: every rank names cuda:0.  tp 2 serving
# (phase 5's requests; its miss logits are kept for the last REF_TAIL
# positions), the tp x sp ring over phase 6's prompt, training on the
# reference's 8-device plan (_plan_for(8): dp 1, pp 2, tp 2, sp 2), a
# restore onto pp 2 x tp 2, and the MoE over dp 1 x ep 2 x tp 2.  The
# sharded steps' losses are held to phase 9's (bf16 partial sums taken
# in another order): the first within SHARD_FIRST_LOSS_REL, losses 2-3
# and step 1's batch after the steps within SHARD_LATER_LOSS_REL.  On
# an NVIDIA H100 80GB HBM3 at 700 W the clean gaps read 1.56e-6 and at
# most 6.41e-5; tp rank 1's wo slices zeroed moved the first loss
# 2.19e-3, and its gradients lost at every step moved the later ones
# 2.82e-4 to 1.22e-2 (PERF.md).
SHARD_TP = 2
REF_TAIL = 512
SHARD_TRAIN_PLAN = dict(dp=1, pp=2, tp=2, sp=2)
SHARD_RESTORE_PLAN = dict(dp=1, pp=2, tp=2)
SHARD_MOE_PLAN = dict(dp=1, ep=2, tp=2)
SHARD_FIRST_LOSS_REL = 2e-5
SHARD_LATER_LOSS_REL = 2e-4
# Phase 12f: phase 5's requests served by ACROSS_WORLD spawned processes on
# the one card in a gloo group, over three meshes that make_hybrid_mesh
# builds in every process ({name: (ici plan, dcn plan)}; None: its
# defaults, the reference's fleet of ici tp 1 and dcn dp = the processes),
# then MoEConfig() over ici tp 2 x dcn ep 2.  The default fleet's second
# prompt is drawn from ACROSS_SEED.  The group's timeout, and the
# workers' limit beside spawn and imports.
ACROSS_WORLD = 2
ACROSS_MESHES = {"tp": (dict(dp=1), dict(dp=1, tp=2)), "pp": (dict(dp=1), dict(dp=1, pp=2)),
                 "dp": None}
ACROSS_MOE = (dict(dp=1, tp=2), dict(dp=1, ep=2))
ACROSS_SEED = SEED + 40
ACROSS_GROUP_TIMEOUT_S = 600
# Then, in the same group, plain params (one tensor a leaf, not sharded)
# over an sp_mesh of the processes, which forward shares onto the mesh
# (sharding.share_tree): MoEConfig() uncut over ici sp 2 x dcn sp 2 (a
# ring of RING_SP, two ranks a process, contiguous) on phase 11's prompt,
# and Llama-3-8B's widths cut to PLAIN_LLAMA_LAYERS layers over ici tp 2 x
# dcn sp 2 on phase 6's prompt, both layouts: each process holding the
# plain params and its tp slices' copies of all 32 layers would not fit
# beside the parent's references.
PLAIN_MOE_MESH = (dict(dp=1, sp=RING_SP // ACROSS_WORLD), dict(dp=1, sp=ACROSS_WORLD))
PLAIN_LLAMA_MESH = (dict(dp=1, tp=SHARD_TP), dict(dp=1, sp=ACROSS_WORLD))
PLAIN_LLAMA_LAYERS = 8
# Phase 9b: phases 8-9's cut model trained over ACROSS_WORLD spawned
# processes on the card, TRAIN_ACROSS_STEPS steps on each mesh
# ({name: dcn plan}, one rank a process): dp across them on batches of
# two of phase 9's sequences, tp across them on phase 9's own.  Each is
# held to the single process on the same tokens at SHARD_FIRST_LOSS_REL
# and SHARD_LATER_LOSS_REL.  Phase 12d-across: the tp state (params and
# AdamW's state, laid out as the params) saved by both processes, each
# writing its own slices, restored onto RESTORE_ACROSS across them and,
# in the parent, onto SHARD_RESTORE_PLAN.
TRAIN_ACROSS = {"dp": dict(dp=2), "tp": dict(dp=1, tp=2)}
TRAIN_ACROSS_STEPS = 2
RESTORE_ACROSS = dict(dp=1, pp=2)
# Elements a fingerprint weighs at once (``fingerprint``), and how often
# 12d-across samples a process's resident set.
FINGERPRINT_CHUNK = 1 << 26
RSS_SAMPLE_S = 0.005
# Read path (phase 13): bench.py:bench_read_path's shapes at fleet scale.
# 4 pods (bench.py's NUM_PODS), each holding 64 random 8192-token
# conversations as 32,768 blocks of 16 tokens: one Llama-3-8B block in
# bf16 takes 32 layers x 2 x 16 x 8 x 128 x 2 B = 2 MiB, so that is what
# a pod keeps in about 64 GiB of an 80 GB card beside 16 GB of weights.
# Traffic: one 8192-token conversation plus 8 turns of 256 tokens,
# resident on pod-0 (hbm) and pod-1 (host); 24 cold 8192-token prompts;
# the two alternated.  Each through three Indexers (fast lane, fast lane
# without the score memo, straight path), at least READ_REQUESTS a cell.
READ_PODS = 4
READ_CONVS_PER_POD = 64
READ_CONV_TOKENS = 8192
READ_TURNS = 8
READ_TURN_TOKENS = 256
READ_COLD_PROMPTS = 24
READ_REQUESTS = 200
READ_VOCAB = 128256  # Llama-3's
READ_BLOCK = 16
# The prefix store's text chunk and the pool's overlap threshold
# (LRUStoreConfig and TokenizationPoolConfig defaults).
STORE_CHUNK_BYTES = 256
STORE_MIN_OVERLAP = 0.8
READ_SPANS = {"tokenize": None, "tokenize.prefix_probe": "tokenize",
              "tokenize.encode": "tokenize", "hash_blocks": None, "index_lookup": None,
              "score": None}
# PCIe Gen5 x16, one direction (NVIDIA's H100 SXM data sheet: 128 GB/s
# both ways).
PCIE_GEN5_X16 = 64e9

# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet):
# bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores,
# device memory bytes/s.
H100_SXM_PEAKS = (989e12, 67e12, 3.35e12)

# Per-element limits of a kernel against its plain version:
#   |got - ref| <= rel * |ref| + floor * rms(ref's row),
# a row being the D outputs of one query and head.  ``rel`` covers the
# output's last rounding: both sides round to bf16, so an element may
# differ by one bf16 ulp, 2^-8 to 2^-7 of its value, and 2^-6 allows
# twice that.  ``floor`` covers the error the kernel adds inside a row,
# which spreads with the row's scale, not with each element's.
LIMITS = {
    # The prefill kernel rounds its probabilities to bf16 for the P.V
    # product: each term's relative error is at most 2^-8, and their sum
    # spreads as about 2^-9 of the row's rms, so 2^-6 is ~8 sigma.
    ("prefill", "bfloat16"): (2.0**-6, 2.0**-6),
    # The decode kernel keeps its probabilities in float32.
    ("decode", "bfloat16"): (2.0**-6, 2.0**-10),
    # The ring partial kernel rounds P to bf16 for P.V as the prefill
    # kernel does, so the same floor; its acc/l stays float32, so the
    # rel term (for a bf16 output's last rounding) is slack here.
    ("ring", "bfloat16"): (2.0**-6, 2.0**-6),
    # float32 in and out: the same sums taken in another order.
    ("prefill", "float32"): (2.0**-14, 2.0**-14),
    ("decode", "float32"): (2.0**-14, 2.0**-14),
    ("ring", "float32"): (2.0**-14, 2.0**-14),
}
# The ring partial's m and l against the plain version's.  m is the max
# of the same float32 scores (|m| below ~10 here), summed over D in
# another order and carried in log2 units: a few float32 ulps, far
# inside 2^-12 absolute.  l sums up to 2048 float32 exponentials of
# those scores: 2^-10 relative.  Empty rows must match exactly
# (-1e30 and 0 on both sides).
RING_M_ABS = 2.0**-12
RING_L_REL = 2.0**-10

# Phases 2-4's shapes beyond Llama-3-8B's: the kernels take every
# head dim that is a multiple of 16 from 32 to 256, any group H / Hkv
# (up to 16 for decode) and pool blocks of 8 to 128 tokens, as the
# reference's Pallas kernels do.  Timed at serving length: (H, Hkv, D)
# of prefill (Tq = Tk = 8448) and of the ring partial (one rank's 2048
# rows, offset 0).
SHAPE_PREFILL = ((8, 1, 256), (24, 8, 128), (32, 32, 96), (8, 4, 32))
# Decode at phase 3's B=4 contexts: (H, Hkv, D, block size).
SHAPE_DECODE_CTX = [8448, 1, 5000, 8447]
SHAPE_DECODE = ((32, 8, 128, 8), (32, 8, 128, 32), (32, 8, 128, 64), (32, 8, 128, 128),
                (8, 1, 256, 16), (28, 4, 128, 16), (128, 8, 128, 16))
# Untimed: ragged lengths at head dims 48-256 and groups 3, 5 and 16, and
# float32 at 32, 96 and 256; (B, Tq, Tk, H, Hkv, D, q_offset, dtype).
SHAPE_PREFILL_EDGE = (
    (2, 100, 100, 8, 2, 48, 0, "bfloat16"),
    (1, 77, 300, 15, 5, 80, 223, "bfloat16"),  # G 3
    (1, 192, 250, 10, 2, 112, 58, "bfloat16"),  # G 5
    (1, 130, 400, 16, 1, 144, 270, "bfloat16"),  # G 16
    (2, 200, 333, 4, 1, 256, 133, "bfloat16"),
    (1, 1, 77, 32, 2, 256, 76, "bfloat16"),
    (1, 100, 100, 8, 4, 32, 0, "float32"),
    (1, 70, 90, 6, 2, 96, 20, "float32"),
    (2, 50, 60, 4, 4, 256, 10, "float32"),
    # head dims 160-240, each beside the compiled width that serves it
    (1, 90, 150, 8, 2, 160, 60, "bfloat16"),
    (1, 130, 130, 6, 6, 176, 0, "bfloat16"),
    (2, 64, 200, 14, 2, 192, 136, "bfloat16"),  # G 7
    (1, 150, 170, 16, 4, 208, 20, "bfloat16"),
    (1, 1, 100, 8, 1, 224, 99, "bfloat16"),
    (1, 200, 260, 12, 3, 240, 60, "bfloat16"),
)
# (B, H, Hkv, D, max_blocks, ctx, dtype, block size): contexts that end
# mid-block and on a block's last token at blocks 8, 32 and 128.
SHAPE_DECODE_EDGE = (
    (3, 24, 8, 48, 20, [300, 17, 160], "bfloat16", 16),  # G 3
    (2, 10, 2, 80, 40, [600, 333], "bfloat16", 16),  # G 5
    (2, 16, 1, 112, 40, [500, 95], "bfloat16", 16),  # G 16
    (2, 32, 2, 144, 30, [470, 1], "bfloat16", 16),
    (2, 8, 4, 256, 12, [170, 96], "bfloat16", 16),
    (2, 48, 3, 256, 12, [180, 33], "bfloat16", 16),
    (3, 32, 8, 128, 40, [299, 320, 1], "bfloat16", 8),
    (3, 32, 8, 128, 20, [433, 640, 32], "bfloat16", 32),
    (3, 32, 8, 128, 6, [434, 768, 127], "bfloat16", 128),
    (2, 8, 4, 32, 10, [150, 37], "float32", 16),
    (2, 12, 4, 96, 24, [180, 5], "float32", 8),  # G 3
    (2, 16, 1, 256, 6, [90, 33], "float32", 16),  # G 16: float32 sub-groups
    # phase 5e's decode shape at its last step's contexts (65 to 68)
    (2, 8, 4, 32, 5, [65, 68], "bfloat16", 16),
    (2, 12, 4, 96, 20, [300, 17], "bfloat16", 16),  # G 3
    (2, 8, 2, 160, 12, [170, 64], "bfloat16", 16),
    (2, 8, 8, 176, 10, [150, 31], "bfloat16", 32),
    (2, 14, 2, 192, 20, [150, 8], "bfloat16", 8),  # G 7
    (2, 16, 4, 208, 12, [180, 100], "bfloat16", 16),
    (2, 6, 2, 224, 4, [200, 128], "bfloat16", 64),
    (2, 32, 2, 240, 3, [300, 129], "bfloat16", 128),  # G 16
)
# (B, Tq, Tk, H, Hkv, D, causal_offset, dtype)
SHAPE_RING_EDGE = (
    (1, 100, 300, 8, 2, 48, None, "bfloat16"),
    (1, 77, 77, 15, 5, 80, -1, "bfloat16"),
    (2, 130, 190, 10, 2, 112, 0, "bfloat16"),
    (1, 200, 140, 16, 1, 144, -1, "bfloat16"),
    (1, 150, 260, 4, 2, 256, 30, "bfloat16"),
    (1, 100, 100, 8, 4, 32, -1, "float32"),
    (1, 70, 90, 6, 2, 96, None, "float32"),
    (1, 60, 60, 4, 1, 256, 0, "float32"),
    (1, 100, 200, 8, 2, 160, None, "bfloat16"),
    (1, 90, 90, 6, 6, 176, -1, "bfloat16"),
    (2, 130, 150, 14, 2, 192, 0, "bfloat16"),  # G 7
    (1, 80, 120, 16, 4, 208, 40, "bfloat16"),
    (1, 140, 140, 8, 1, 224, -1, "bfloat16"),
    (1, 64, 190, 12, 3, 240, None, "bfloat16"),
)


def port(name):
    """A module of the port, imported by name."""
    return importlib.import_module("llm_d_kv_cache_manager_tpu_torch." + name)


def card_peaks(name: str):
    """The peaks for this card's bounds.  "NVIDIA H100 80GB HBM3" is the
    SXM part, the only card the port has run on."""
    if "H100" in name and "HBM3" in name:
        return H100_SXM_PEAKS
    raise RuntimeError(f"no peak table for card {name!r}")


def kernel_name(mangled: str) -> str:
    """``name<int args>`` of a mangled kernel: the identifier whose
    length prefix says it ends in ``_kernel``, then its template ints
    (a bool as 0 or 1)."""
    for match in re.finditer(r"\d+", mangled):
        # The digits may start with the tail of a file hash: try each
        # suffix of the run as the length.
        for start in range(match.start(), match.end()):
            end = match.end() + int(mangled[start:match.end()])
            name = mangled[match.end():end]
            if name.endswith("_kernel"):
                rest = mangled[end:]
                args = (re.findall(r"L[ijb](\d+)E", rest[:rest.find("EE") + 2])
                        if rest[:1] == "I" else [])
                return f"{name}<{','.join(args)}>"
    return mangled


def ptxas_lines(log: str):
    """(kernel, "registers; stack and spills") for each kernel in an
    ``nvcc -Xptxas -v`` log, the kernel as ``name<template args>``."""
    props, used, order = {}, {}, []
    current = None
    for ln in log.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln or "Function properties for" in ln:
            current = kernel_name(ln.split("'")[1] if "'" in ln else ln.split()[-1])
            if current not in order:
                order.append(current)
        elif "spill stores" in ln and current is not None:
            props[current] = ln
        elif ln.startswith("ptxas info") and "Used" in ln and current is not None:
            used[current] = ln.split("info    :")[-1].strip()
    return [(k, f"{used.get(k, '?')}; {props.get(k, '?')}") for k in order]


# Host-clock seconds of each phase, by the title's leading number.
PHASE_SECONDS = {}
_phase_start = [None, None]  # (title, perf_counter) of the phase running


def phase(title: str = None) -> None:
    """Close the running phase (its seconds into PHASE_SECONDS) and open
    ``title`` (None: only close)."""
    now = time.perf_counter()
    if _phase_start[0] is not None:
        PHASE_SECONDS[_phase_start[0].split(" ")[0].rstrip(".")] = round(now - _phase_start[1], 1)
    _phase_start[:] = [title, now]
    if title is not None:
        print(f"\n== {title}", flush=True)


def eager_ms(torch, fn, iters: int) -> float:
    """Mean time of ``iters`` back-to-back ``fn`` calls, CUDA events,
    after one warm-up call: the device's time plus any gap the host
    leaves between launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_ms(torch, fn, iters: int) -> float:
    """Mean device time of one ``fn`` call: ``iters`` calls captured in a
    CUDA graph (after a warm-up call on a side stream, as capture
    needs) and replayed once between CUDA events.  A kernel wrapper's
    host work (checks, allocation, the ctypes launch) takes 30-70 us a
    call, as long as the kernel at the small shapes, so back-to-back
    calls (``eager_ms``) would time the host there."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def limit_text(rel: float, floor: float) -> str:
    return f"2^{math.log2(rel):.0f}*|ref| + 2^{math.log2(floor):.0f}*rms(row of ref)"


def add_rates(row: dict, flops: float) -> dict:
    """Achieved TFLOP/s, the kernel's time over the library call's, and
    its share of the bound, from a timed row; printed on one line."""
    row.update(
        tflops=flops / (row["ms"] * 1e-3) / 1e12,
        library_ratio=None if row["library_ms"] is None else row["ms"] / row["library_ms"],
        bound_share=row["bound_ms"] / row["ms"],
    )
    ratio = "none" if row["library_ratio"] is None else f"{row['library_ratio']:.3f}"
    print(f"  achieved {row['tflops']:.1f} TFLOP/s; kernel/library {ratio}; share of bound "
          f"{row['bound_share']:.3f}", flush=True)
    return row


def err_over_limit(got, ref, rel: float, floor: float):
    """(max |got - ref|, max of |got - ref| over its element's limit)."""
    ref = ref.float()
    diff = (got.float() - ref).abs()
    limit = rel * ref.abs() + floor * ref.pow(2).mean(-1, keepdim=True).sqrt()
    ratio = (diff / limit).masked_fill(diff == 0, 0.0)
    return float(diff.max()), float(ratio.max())


def check_close(what: str, got, ref, rel: float, floor: float) -> dict:
    """Fail unless every element of ``got`` is finite and within its limit."""
    err, worst = err_over_limit(got, ref, rel, floor)
    finite = bool(got.float().isfinite().all())
    print(f"  {what}: max_abs_err {err:.6g}, worst err/limit {worst:.4g} (limit "
          f"{limit_text(rel, floor)}){'' if finite else ' NOT FINITE'}", flush=True)
    if not finite or not worst <= 1.0:
        raise AssertionError(f"{what}: an element is past its limit ({worst}) or not finite")
    return {"max_abs_err": err, "worst_err_over_limit": worst,
            "limit": limit_text(rel, floor)}


def check_logits(what: str, got, ref) -> float:
    """Model-level agreement after 32 bf16 layers whose products are
    tiled differently: within 2^-4 of the largest logit."""
    err = float((got.float() - ref.float()).abs().max())
    tol = 2.0**-4 * max(1.0, float(ref.float().abs().max()))
    print(f"  {what}: max_abs_err {err:.6g} (tolerance {tol:.4g})", flush=True)
    if not bool(got.float().isfinite().all()) or not err <= tol:
        raise AssertionError(f"{what}: max_abs_err {err} > {tol} or not finite")
    return err


def check_next_token(what: str, token: int, ref_last, err: float) -> float:
    """Fail unless ``token`` is the reference's next token, or the
    reference's top logits tie within ``err``, the measured max |diff|
    of the two logit tensors: two vectors that differ by at most err per
    element can swap the argmax only between logits within 2*err, so a
    token within err of the reference's top is a tie that any rounding
    order may break either way (with random weights the top two logits
    can lie closer than one bf16 ulp of a logit).  Returns the gap."""
    ref_last = ref_last.float()
    top = int(ref_last.argmax())
    gap = float(ref_last.max() - ref_last[token])
    print(f"  {what}: token {token}, reference's {top}; the reference's logit of {token} is "
          f"{gap:.4g} below its top (max_abs_err {err:.4g})", flush=True)
    if token != top and not gap <= err:
        raise AssertionError(f"{what}: token {token} is not the reference's {top}, and not "
                             f"within {err} of it")
    return gap


def reject_fault(what: str, faulty, ref, rel: float, floor: float) -> dict:
    """Fail unless the limit rejects ``faulty``, the output a kernel with
    a planted fault gives: the check's power at this shape."""
    err, worst = err_over_limit(faulty, ref, rel, floor)
    print(f"  planted fault, {what}: max_abs_err {err:.6g}, worst err/limit "
          f"{worst:.4g} -> {'rejected' if worst > 1.0 else 'NOT rejected'}", flush=True)
    if not worst > 1.0:
        raise AssertionError(f"the limit does not reject the planted fault: {what}")
    return {"fault": what, "max_abs_err": err, "worst_err_over_limit": worst}


# --------------------------------------------------------------- phase 2


def causal_pairs(Tq: int, Tk: int, q_offset: int) -> int:
    """(query, key) pairs the causal mask keeps."""
    return sum(min(q_offset + i + 1, Tk) for i in range(Tq))


def prefill_case(torch, peaks, B, Tq, Tk, H, Hkv, D, q_offset, dtype, timing):
    fc = port("ops.flash_cuda")
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(SEED + Tq + Tk)
    q = torch.randn(B, Tq, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Tk, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Tk, Hkv, D, generator=g, device="cuda").to(dtype)
    got = fc.flash_gqa_attention_cuda(q, k, v, q_offset=q_offset)
    ref = fc.flash_gqa_attention_plain(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    limits = LIMITS["prefill", str(dtype)[6:]]
    shape = f"B={B} Tq={Tq} Tk={Tk} H={H} Hkv={Hkv} D={D} q_offset={q_offset} {str(dtype)[6:]}"
    row = {"shape": shape, **check_close(f"prefill {shape}", got, ref, *limits)}
    if not timing:
        return row
    # Planted fault: a kernel that skips the middle key tile.  Its output
    # is this kernel's over the keys without that tile, for every query
    # row past the tile (rows before it do not see it).
    tile = fc.KV_TILE
    t = -(-min(q_offset + Tq, Tk) // tile) // 2
    r0 = max(0, (t + 1) * tile - q_offset)
    faulty = got.clone()
    faulty[:, r0:] = fc.flash_gqa_attention_cuda(
        q[:, r0:].contiguous(), torch.cat((k[:, : t * tile], k[:, (t + 1) * tile:]), 1),
        torch.cat((v[:, : t * tile], v[:, (t + 1) * tile:]), 1),
        q_offset=q_offset + r0 - tile)
    row["planted"] = reject_fault(
        f"key tile {t} of {-(-Tk // tile)} skipped", faulty, ref, *limits)
    del faulty
    item = q.element_size()
    flops = 4.0 * B * H * D * causal_pairs(Tq, Tk, q_offset)
    nbytes = (2 * B * Tq * H * D + 2 * B * Tk * Hkv * D) * item
    t_ops = flops / (peaks[0] if dtype == torch.bfloat16 else peaks[1])
    t_bytes = nbytes / peaks[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # SDPA's [B, H, T, D]
    if Tq == Tk and q_offset == 0:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        mask = (torch.arange(Tk, device="cuda")[None, :]
                <= q_offset + torch.arange(Tq, device="cuda")[:, None])
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    kernel = lambda: fc.flash_gqa_attention_cuda(q, k, v, q_offset=q_offset)  # noqa: E731
    plain = lambda: fc.flash_gqa_attention_plain(q, k, v, q_offset=q_offset)  # noqa: E731
    row.update(
        ms=timed_ms(torch, kernel, 10),
        eager_ms=eager_ms(torch, kernel, 10),
        plain_ms=eager_ms(torch, plain, 2),
        library_ms=timed_ms(torch, lib, 10),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
    )
    print(f"  ms {row['ms']:.4f}  eager_ms {row['eager_ms']:.4f}  plain_ms "
          f"{row['plain_ms']:.3f}  library_ms {row['library_ms']:.4f}  bound_ms "
          f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
    return add_rates(row, flops)


# --------------------------------------------------------------- phase 3


def decode_items(torch, pc, B, H, Hkv, D, max_blocks, ctx, dtype, block_size=16):
    """The pieces the decode kernel cuts this call into on this card:
    the wrapper's grid and the mirror of the kernel's arithmetic, over
    its lines (KV heads, or float32 sub-groups of them)."""
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    heads, nsub = pc.head_split(H // Hkv, D, dtype)
    resident = pc.RESIDENT_CTAS[torch.cuda.current_device(), D, heads, code, block_size]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = pc.split_plan(B, Hkv * nsub, max_blocks, sms, resident, block_size=block_size)
    return pc.work_items(ctx, Hkv * nsub, max_blocks, ctas, block_size=block_size), heads


def repacked_decode(torch, pc, q, kv, table_row, tokens: int, drop):
    """The decode kernel's output for one sequence whose K and V are the
    first ``tokens`` of ``table_row``'s blocks in ``kv`` without token
    range ``drop``, repacked into a pool of 16-token blocks: what a
    kernel that skipped those tokens would give."""
    bs = kv.shape[2]
    n_blocks = -(-tokens // bs)
    seq = kv[table_row[:n_blocks].long()]  # [n, 2, bs, Hkv, D]
    seq = seq.permute(1, 0, 2, 3, 4).reshape(2, n_blocks * bs, *kv.shape[3:])[:, :tokens]
    keep = torch.cat((seq[:, :drop[0]], seq[:, drop[1]:]), 1)
    n = keep.shape[1]
    pad = -n % 16
    keep = torch.cat((keep, keep.new_zeros(2, pad, *keep.shape[2:])), 1)
    pool = keep.reshape(2, -1, 16, *keep.shape[2:]).permute(1, 0, 2, 3, 4).contiguous()
    table = torch.arange(pool.shape[0], dtype=torch.int32, device=kv.device)[None]
    return pc.paged_decode_attention_cuda(
        q, pool, table, torch.tensor([n], dtype=torch.int32, device=kv.device))


def decode_case(torch, peaks, B, H, Hkv, D, max_blocks, ctx, dtype, timing, block_size=16):
    pc = port("ops.paged_decode_cuda")
    bs = block_size
    g = torch.Generator(device="cuda").manual_seed(SEED + B + max_blocks)
    num_blocks = B * max_blocks + 7
    kv = torch.randn(num_blocks, 2, bs, Hkv, D, generator=g, device="cuda").to(dtype)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    perm = torch.randperm(num_blocks, generator=torch.Generator().manual_seed(SEED))
    table = perm[: B * max_blocks].reshape(B, max_blocks).to(torch.int32).cuda()
    # Past each context the table holds junk the kernel must never read.
    for b, n in enumerate(ctx):
        table[b, -(-n // bs):] = -12345
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    safe = table.clamp(min=0)  # the plain gather reads every column
    got = pc.paged_decode_attention_cuda(q, kv, table, ctx_t)
    ref = pc.paged_decode_attention_plain(q, kv, safe, ctx_t)
    torch.cuda.synchronize()
    limits = LIMITS["decode", str(dtype)[6:]]
    shape = (f"B={B} H={H} Hkv={Hkv} D={D} block_size={bs} max_blocks={max_blocks} ctx={ctx} "
             f"{str(dtype)[6:]}")
    result = check_close(f"decode {shape}", got, ref, *limits)
    if not timing:
        return {"shape": shape, **result}
    # Planted fault: a merge that drops one partial.  The kernel cuts the
    # live 16-token tiles into runs, one a CTA (``work_items``); of the
    # pieces that leave a partial, take the middle one of the longest
    # sequence.  The faulty output is this kernel's over that sequence
    # without the piece's tokens, for the query heads of its line.
    items, heads = decode_items(torch, pc, B, H, Hkv, D, max_blocks, ctx, dtype, bs)
    long_b = max(range(B), key=lambda b: ctx[b])
    live = -(-ctx[long_b] // 16)
    partial = [it for it in items if it[1] == long_b and (it[3], it[4]) != (0, live)]
    if not partial:
        raise AssertionError(f"decode {shape}: no piece leaves a partial to drop")
    cta, _, line, lo, hi = partial[len(partial) // 2]
    drop = (lo * 16, min(ctx[long_b], hi * 16))
    faulty = got.clone()
    faulty[long_b, line * heads:(line + 1) * heads] = repacked_decode(
        torch, pc, q[long_b: long_b + 1], kv, safe[long_b], ctx[long_b], drop,
    )[0, line * heads:(line + 1) * heads]
    planted = reject_fault(
        f"partial of CTA {cta} (sequence {long_b}, line {line}, tiles {lo}-{hi - 1} of "
        f"{live}; {len(partial)} partials in the sequence) dropped", faulty, ref, *limits)
    row = {"shape": shape, **result, "planted": planted}
    item = q.element_size()
    tokens = sum(ctx)
    flops = 4.0 * tokens * H * D
    nbytes = (2 * tokens * Hkv * D + 2 * B * H * D) * item + 4 * (
        sum(len(range(0, n, bs)) for n in ctx) + B)
    t_ops = flops / (peaks[0] if dtype == torch.bfloat16 else peaks[1])
    t_bytes = nbytes / peaks[2]
    kernel = lambda: pc.paged_decode_attention_cuda(q, kv, table, ctx_t)  # noqa: E731
    row.update(
        ms=timed_ms(torch, kernel, 20),
        eager_ms=eager_ms(torch, kernel, 20),
        plain_ms=eager_ms(torch, lambda: pc.paged_decode_attention_plain(q, kv, safe, ctx_t), 3),
        library_ms=None,  # no single PyTorch call reads a paged pool
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
    )
    print(f"  ms {row['ms']:.4f}  eager_ms {row['eager_ms']:.4f}  plain_ms "
          f"{row['plain_ms']:.3f}  bound_ms {row['bound_ms']:.4f} ({row['bound_by']})",
          flush=True)
    return add_rates(row, flops)


def decode_replay_case(torch):
    """What one CUDA graph of one decode call gives on three replays,
    and an empty context beside a live one.  The kernel's arrival
    counters are zeroed inside the launch sequence: left standing, they
    would make the second replay merge early or never.  The merge adds
    the partials in CTA order whatever the order of arrival, so replays
    agree bit for bit with each other and with the eager call."""
    pc = port("ops.paged_decode_cuda")
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 77)
    B, H, Hkv, D, max_blocks = 3, 32, 8, 128, 300
    ctx = [4790, 0, 2333]
    kv = torch.randn(B * max_blocks, 2, 16, Hkv, D, generator=g, device="cuda").to(bf16)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(bf16)
    table = torch.randperm(B * max_blocks, generator=torch.Generator().manual_seed(SEED))
    table = table.reshape(B, max_blocks).to(torch.int32).cuda()
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    eager = pc.paged_decode_attention_cuda(q, kv, table, ctx_t)
    ref = pc.paged_decode_attention_plain(q, kv, table, ctx_t)
    torch.cuda.synchronize()
    live = [0, 2]
    row = check_close(f"decode B={B} ctx={ctx} (live sequences)", eager[live], ref[live],
                      *LIMITS["decode", "bfloat16"])
    if bool((eager[1] != 0).any()):
        raise AssertionError("decode: an empty context must give 0")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pc.paged_decode_attention_cuda(q, kv, table, ctx_t)
    replays = []
    for _ in range(3):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    same = all(torch.equal(r, eager) for r in replays)
    print(f"  decode B={B} ctx={ctx}: empty context gives 0; 3 replays of one CUDA graph equal "
          f"the eager call bit for bit: {same}", flush=True)
    if not same:
        raise AssertionError("decode: replays of one CUDA graph disagree")
    return {"shape": f"B={B} H={H} Hkv={Hkv} D={D} max_blocks={max_blocks} ctx={ctx} bfloat16, "
                     "3 graph replays", **row, "replays_equal": same}


# --------------------------------------------------------------- phase 4


def visible_pairs(Tq: int, Tk: int, offset) -> int:
    """(query, key) pairs a ring partial's mask keeps: key <= row +
    offset and key < Tk (``None``: every pair)."""
    if offset is None:
        return Tq * Tk
    return sum(min(max(i + offset + 1, 0), Tk) for i in range(Tq))


def ring_partial_case(torch, peaks, B, Tq, Tk, H, Hkv, D, offset, dtype, timing):
    rf = port("ops.ring_flash")
    rc = port("ops.ring_flash_cuda")
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(SEED + 3 * Tq + Tk + 5 * (offset or 0))
    q = torch.randn(B, Tq, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Tk, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Tk, Hkv, D, generator=g, device="cuda").to(dtype)
    got = rc.flash_partial_cuda(q, k, v, causal_offset=offset)
    ref = rf.flash_partial_plain(q, k, v, causal_offset=offset)
    torch.cuda.synchronize()

    def norm(part):
        return rf.normalize_partial(part[0], part[2], torch.float32)

    limits = LIMITS["ring", str(dtype)[6:]]
    shape = (f"B={B} Tq={Tq} Tk={Tk} H={H} Hkv={Hkv} D={D} causal_offset={offset} "
             f"{str(dtype)[6:]}")
    row = {"shape": shape, **check_close(f"ring partial {shape}, acc/l", norm(got), norm(ref),
                                         *limits)}
    (acc, m, l), (_, m_ref, l_ref) = got, ref
    m_err = float((m - m_ref).abs().max())
    l_worst = float(((l - l_ref).abs() / (RING_L_REL * l_ref.abs())).nan_to_num(0.0).max())
    empty = m_ref == rf.NEG_INF  # float32(-1e30) on both sides
    exact = bool((m[empty] == rf.NEG_INF).all() and (l[empty] == 0).all()
                 and (acc[empty] == 0).all())
    print(f"  ring partial {shape}, m: max_abs_err {m_err:.3g} (limit {RING_M_ABS:.3g}); "
          f"l: worst err/limit {l_worst:.4g} (limit 2^{math.log2(RING_L_REL):.0f}*|ref|); "
          f"{int(empty.sum())} empty rows, (acc, m, l) = (0, -1e30, 0) exactly: {exact}",
          flush=True)
    if not (m_err <= RING_M_ABS and l_worst <= 1.0 and exact):
        raise AssertionError(f"ring partial {shape}: m, l or the empty rows disagree")
    if offset is not None and offset < 0 and not bool(empty.any()):
        raise AssertionError(f"ring partial {shape}: expected rows that see no key")
    row.update(m_max_abs_err=m_err, l_worst_err_over_limit=l_worst,
               empty_rows=int(empty.sum()))
    if not timing:
        return row
    # Planted fault: a kernel that skips the middle visible key tile.
    # Rows from r0 on see the whole tile; their partial is this kernel's
    # over the keys without it, with the offset moved to match.
    tile = rc.KV_TILE
    n_vis = Tk if offset is None else min(Tk, Tq + offset)
    t = -(-n_vis // tile) // 2
    r0 = 0 if offset is None else max(0, (t + 1) * tile - offset)
    faulty = norm(got)
    faulty[:, r0:] = norm(rc.flash_partial_cuda(
        q[:, r0:].contiguous(), torch.cat((k[:, : t * tile], k[:, (t + 1) * tile:]), 1),
        torch.cat((v[:, : t * tile], v[:, (t + 1) * tile:]), 1),
        causal_offset=None if offset is None else offset + r0 - tile))
    row["planted"] = reject_fault(
        f"key tile {t} of {-(-Tk // tile)} skipped", faulty, norm(ref), *limits)
    del faulty
    item = q.element_size()
    flops = 4.0 * B * H * D * visible_pairs(Tq, Tk, offset)
    nbytes = (B * Tq * H * D + 2 * B * Tk * Hkv * D) * item + 4 * (B * Tq * H * D + 2 * B * Tq * H)
    t_ops = flops / (peaks[0] if dtype == torch.bfloat16 else peaks[1])
    t_bytes = nbytes / peaks[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # SDPA's [B, H, T, D]
    if offset is None:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)  # noqa: E731
    elif offset == 0 and Tq == Tk:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        mask = (torch.arange(Tk, device="cuda")[None, :]
                <= offset + torch.arange(Tq, device="cuda")[:, None])
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    kernel = lambda: rc.flash_partial_cuda(q, k, v, causal_offset=offset)  # noqa: E731
    row.update(
        ms=timed_ms(torch, kernel, 20),
        eager_ms=eager_ms(torch, kernel, 20),
        plain_ms=eager_ms(torch, lambda: rf.flash_partial_plain(q, k, v, causal_offset=offset),
                          2),
        library_ms=timed_ms(torch, lib, 20),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
    )
    print(f"  ms {row['ms']:.4f}  eager_ms {row['eager_ms']:.4f}  plain_ms "
          f"{row['plain_ms']:.3f}  library_ms {row['library_ms']:.4f}  bound_ms "
          f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
    return add_rates(row, flops)


def shape_guard_case(torch, head_dim: int = 40) -> dict:
    """Each kernel wrapper refuses a head dim outside the set the kernels
    take (every multiple of 16 from 32 to 256) on CUDA tensors, with a
    ValueError naming the set, before any launch."""
    fc, rc, pc = (port("ops.flash_cuda"), port("ops.ring_flash_cuda"),
                  port("ops.paged_decode_cuda"))
    lf = port("ops.layer_fused")
    bf16 = torch.bfloat16
    q = torch.zeros(1, 16, 4, head_dim, dtype=bf16, device="cuda")
    kv = torch.zeros(1, 16, 2, head_dim, dtype=bf16, device="cuda")
    pool = torch.zeros(2, 2, 16, 2, head_dim, dtype=bf16, device="cuda")
    table = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    ctx = torch.tensor([5], dtype=torch.int32, device="cuda")
    positions = torch.zeros(1, 16, dtype=torch.long, device="cuda")
    freqs = torch.ones(head_dim // 2, device="cuda")
    before = (fc.flash_gqa_attention_cuda.launches, rc.flash_partial_cuda.launches,
              pc.paged_decode_attention_cuda.launches, lf.rope_kv_fused.launches)
    messages = {}
    for name, call in (
            ("flash_prefill", lambda: fc.flash_gqa_attention_cuda(q, kv, kv)),
            ("ring_partial", lambda: rc.flash_partial_cuda(q, kv, kv, causal_offset=0)),
            ("paged_decode", lambda: pc.paged_decode_attention_cuda(q[0, :1], pool, table,
                                                                     ctx)),
            ("layer_fused", lambda: lf.rope_kv_fused(q, kv, kv, positions, freqs, pool,
                                                     positions))):
        try:
            call()
        except ValueError as exc:
            messages[name] = str(exc)
        else:
            raise AssertionError(f"{name}: head_dim {head_dim} did not raise")
        if "a multiple of 16 from 32 to 256" not in messages[name]:
            raise AssertionError(f"{name}: the message does not name the set: {messages[name]}")
    after = (fc.flash_gqa_attention_cuda.launches, rc.flash_partial_cuda.launches,
             pc.paged_decode_attention_cuda.launches, lf.rope_kv_fused.launches)
    if after != before:
        raise AssertionError("a refused call launched a kernel")
    print(f"  head_dim {head_dim} on CUDA tensors: ValueError from every wrapper, no launch: "
          f"{messages}", flush=True)
    return {"shape": f"head_dim={head_dim} bfloat16, refused", "raised": messages}


# --------------------------------------------------------------- phase 4b


# (row, tokens, d_model, H, Hkv, head_dim, d_ff, first position, sequences):
# the benchmark's two model shapes (bench_port/configs) at a continuation
# of the Mistral cell (256 new tokens over a 4096-token prefix), its decode
# at bucket 16, and the DeepSeek cell's decode batch of 24.
LAYER_FUSED_SHAPES = (
    ("Mistral continuation", 256, 4096, 32, 8, 128, 14336, 4096, 1),
    ("Mistral decode, bucket 16", 16, 4096, 32, 8, 128, 14336, 4352, 16),
    ("DeepSeek decode, batch 24", 24, 4096, 32, 32, 128, 11008, 3000, 24),
)
NORM_LIMIT = (2.0**-7, 2.0**-12)  # RMSNorm: one bf16 rounding (the sum's order differs)


def layer_fused_row(torch, peaks, what, ms_bytes, kernel, plain, got, want, exact):
    """Time ``kernel`` and ``plain`` (device time from a CUDA graph, and
    back to back, which counts the host's launches) and hold ``got`` to
    ``want``: bit for bit where ``exact``, else within ``NORM_LIMIT``;
    a planted fault (the last column zeroed) must be rejected."""
    row = dict(what=what, bound_ms=ms_bytes / peaks[2] * 1e3,
               ms=timed_ms(torch, kernel, 20), plain_ms=timed_ms(torch, plain, 20),
               eager_ms=eager_ms(torch, kernel, 50), plain_eager_ms=eager_ms(torch, plain, 50))
    faulty = got.clone()
    faulty[..., -1] = 0
    if exact:
        diff = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
        if any(diff):
            raise AssertionError(f"{what}: not bit-equal to the plain version ({diff})")
        row.update(max_abs_err=0.0, worst_err_over_limit=0.0, limit="bit for bit")
        row["fault"] = {"rejected": not torch.equal(faulty, got)}
        if not row["fault"]["rejected"]:
            raise AssertionError(f"the limit does not reject the planted fault: {what}")
    else:
        row.update(check_close(what, got, want, *NORM_LIMIT))
        row["fault"] = reject_fault(f"{what}, last column zeroed", faulty, want, *NORM_LIMIT)
    print(f"  {what}: bound {row['bound_ms']:.4f} ms (bytes), kernel {row['ms']:.4f} ms "
          f"(back to back {row['eager_ms']:.4f}), plain {row['plain_ms']:.4f} ms (back to back "
          f"{row['plain_eager_ms']:.4f}), share of bound {row['bound_ms'] / row['ms']:.3f}",
          flush=True)
    return row


def layer_fused_phase(torch, peaks) -> list:
    """The three kernels of csrc/layer_fused.cu at the benchmark's shapes,
    each against its plain version on the card."""
    lf = port("ops.layer_fused")
    bf16, dev = torch.bfloat16, "cuda"
    rows = []
    for name, n, D, H, Hkv, Dh, F, start, seqs in LAYER_FUSED_SHAPES:
        g = torch.Generator(device=dev).manual_seed(n * H)

        def rnd(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=g, device=dev)).to(bf16)
        x, w = rnd(n, D, scale=3.0), 1 + rnd(D, scale=0.1)
        rows.append(layer_fused_row(
            torch, peaks, f"rms_norm, {name}: [{n}, {D}]", (2 * n * D + D) * 2,
            lambda: lf.rms_norm_fused(x, w), lambda: lf.rms_norm_plain(x, w),
            lf.rms_norm_fused(x, w), lf.rms_norm_plain(x, w), exact=False))
        gate, up = rnd(n, F, scale=4.0), rnd(n, F)
        rows.append(layer_fused_row(
            torch, peaks, f"silu_mul, {name}: [{n}, {F}]", 3 * n * F * 2,
            lambda: lf.silu_mul_fused(gate, up), lambda: lf.silu_mul_plain(gate, up),
            lf.silu_mul_fused(gate, up), lf.silu_mul_plain(gate, up), exact=True))
        T = n // seqs
        q, k, v = rnd(seqs, T, H, Dh), rnd(seqs, T, Hkv, Dh), rnd(seqs, T, Hkv, Dh)
        blocks = n // 16 + seqs + 4
        pools = [rnd(blocks, 2, 16, Hkv, Dh) for _ in range(2)]
        pools[1].copy_(pools[0])
        slots = torch.randperm(blocks * 16, generator=g, device=dev)[:n].reshape(seqs, T)
        positions = (start + torch.arange(T, device=dev)).expand(seqs, T)
        freqs = lf.rope_freqs(Dh, 1e6, torch.device(dev))
        # A continuation writes k and v out too, into the tail of the
        # prefix + suffix K/V its attention reads.
        outs = ([torch.zeros(seqs, start + T, Hkv, Dh, dtype=bf16, device=dev)[:, start:]
                 for _ in range(4)] if seqs == 1 else [None] * 4)
        out_bytes = 2 * n * Hkv * Dh * 2 if seqs == 1 else 0
        got = lf.rope_kv_fused(q, k, v, positions, freqs, pools[0], slots, *outs[:2])
        want = lf.rope_kv_plain(q, k, v, positions, freqs, pools[1], slots, *outs[2:])
        pair = [(got, want), (pools[0], pools[1])] + (
            [(outs[0], outs[2]), (outs[1], outs[3])] if seqs == 1 else [])
        rope_bytes = (n * (H + 2 * Hkv) * Dh * 2 + n * 16 + Dh * 2  # read q, k, v, positions,
                      + n * H * Dh * 2 + 2 * n * Hkv * Dh * 2 + out_bytes)  # slots; write
        rows.append(layer_fused_row(
            torch, peaks, f"rope_kv, {name}: q [{seqs}, {T}, {H}, {Dh}], Hkv {Hkv}, "
            f"positions {start}-{start + T - 1}", rope_bytes,
            lambda: lf.rope_kv_fused(q, k, v, positions, freqs, pools[0], slots, *outs[:2]),
            lambda: lf.rope_kv_plain(q, k, v, positions, freqs, pools[1], slots, *outs[2:]),
            torch.stack([torch.cat([a.flatten().float() for a, _ in pair])]),
            torch.stack([torch.cat([b.flatten().float() for _, b in pair])]), exact=True))
    print(f"  launches: rms_norm {lf.rms_norm_fused.launches}, rope_kv "
          f"{lf.rope_kv_fused.launches}, silu_mul {lf.silu_mul_fused.launches}", flush=True)
    return rows


# --------------------------------------------------------------- phase 4c

# Mellum2-12B-A2.5B's widths (bench_port/configs/mellum2-12b-a2.5b.json)
# and the mellum2.repo-agent cell's shapes: prompts of 8-20k tokens,
# decode batches of 24 rows at contexts of 8-24k.
MELLUM_WINDOW = 1024
MELLUM_ATTN = (32, 4, 128)  # query heads, KV heads, head dim
MELLUM_EXPERTS = (2304, 64, 8, 896)  # d_model, experts, top k, expert width
MELLUM_VOCAB = 98304
MELLUM_YARN = (16.0, 8192, 32.0, 1.0)  # factor, original positions, beta fast, slow
MELLUM_SCALE = 1.2772588722239782  # YaRN's attention factor
MELLUM_THETA = 5e5
MELLUM_ROWS = 24
MELLUM_PROMPT = 16368  # the main path's prompt: 1023 pool blocks of 16
MELLUM_LAYERS = 4  # the main path: one period of the layer pattern, 3 windowed + 1 full
MELLUM_STEPS = 32  # its decode steps replayed from the graph
# Routed-expert MLP against its plain version: |got - ref| <= rel |ref|
# + floor rms(row).  Both round each routed row's SiLU(gate) * up and its
# down product to bf16 once, from float32 sums in another order, so a
# hidden element may land one bf16 ulp apart (2^-8 of it), spreading
# through the down product's 896 terms as ~2^-8 / sqrt(896) of the row's
# rms; the output's last rounding is the rel term.  Over millions of
# elements (a prefill's 16,384 tokens) a few such flips line up past it:
# there the kernels are held to the float64 value of their own routing
# (``routed_experts_exact``), no farther past it than the plain version.
MOE_LIMITS = (2.0**-6, 2.0**-9)
MOE_WITNESS_SLACK = 1.25
# Tokens at which the grouped kernels and the per-expert products are
# timed against each other (routed rows: 8 a token).
MOE_CROSSOVER_TOKENS = (64, 128, 512, 2048, 16384)
MELLUM_TITLE = "4c. Mellum2's kernels at the mellum2.repo-agent cell's shapes, then its main path"


def mellum_attention_rows(torch, peaks) -> list:
    """The windowed prefill and decode kernels at Mellum's heads: a whole
    16,384-token prefill and a 256-token continuation after 16,128, and
    decode of 24 rows at 2k to 24k of context, each within ``LIMITS`` of
    its plain version, a window wider by one tile rejected, timed with
    and without the window."""
    fc, pc = port("ops.flash_cuda"), port("ops.paged_decode_cuda")
    H, Hkv, D = MELLUM_ATTN
    W = MELLUM_WINDOW
    bf16, dev = torch.bfloat16, "cuda"
    gen = torch.Generator(device=dev).manual_seed(41)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)
    rows = []
    for T, off in ((16384, 0), (256, 16128)):
        q, k, v = rnd(1, T, H, D), rnd(1, off + T, Hkv, D), rnd(1, off + T, Hkv, D)
        what = f"flash_prefill window {W}: Tq {T} q_offset {off} H {H} Hkv {Hkv} D {D}"
        got = fc.flash_gqa_attention_cuda(q, k, v, q_offset=off, window=W)
        ref = fc.flash_gqa_attention_plain(q, k, v, q_offset=off, window=W)
        row = dict(what=what, **check_close(what, got, ref, *LIMITS["prefill", "bfloat16"]))
        row["fault"] = reject_fault(f"{what}, window {W + 64}", fc.flash_gqa_attention_cuda(
            q, k, v, q_offset=off, window=W + 64), ref, *LIMITS["prefill", "bfloat16"])
        pairs = sum(min(off + i + 1, W) for i in range(T))
        keys = off + T - max(0, off + 1 - W)
        flops, nbytes = 4.0 * H * D * pairs, (2 * T * H + 2 * keys * Hkv) * D * 2
        row.update(ms=timed_ms(torch, lambda: fc.flash_gqa_attention_cuda(
            q, k, v, q_offset=off, window=W), 10),
            ms_no_window=timed_ms(torch, lambda: fc.flash_gqa_attention_cuda(
                q, k, v, q_offset=off), 10),
            plain_ms=eager_ms(torch, lambda: fc.flash_gqa_attention_plain(
                q, k, v, q_offset=off, window=W), 1),
            bound_ms=1e3 * max(flops / peaks[0], nbytes / peaks[2]),
            bound_by="operations" if flops / peaks[0] > nbytes / peaks[2] else "bytes")
        print(f"  {what}: kernel {row['ms']:.4f} ms (no window {row['ms_no_window']:.4f}), "
              f"plain {row['plain_ms']:.2f}, bound {row['bound_ms']:.4f}", flush=True)
        rows.append(row)
        del q, k, v, got, ref
    B, bs = MELLUM_ROWS, 16
    width = 24576 // bs
    kv = rnd(B * width + 1, 2, bs, Hkv, D)
    table = (1 + torch.arange(B * width, device=dev, dtype=torch.int32)).view(B, width)
    q = rnd(B, H, D)
    ragged = [8192 + (i * 12289) % 16384 for i in range(B)]
    for name, ctx in [("ragged 8k-24k", ragged)] + [(f"all {n}", [n] * B)
                                                   for n in (2048, 8192, 16384, 24576)]:
        c = torch.tensor(ctx, dtype=torch.int32, device=dev)
        what = f"paged_decode window {W}: B {B} ctx {name} H {H} Hkv {Hkv} D {D}"
        got = pc.paged_decode_attention_cuda(q, kv, table, c, window=W)
        ref = pc.paged_decode_attention_plain(q, kv, table, c, window=W)
        row = dict(what=what, **check_close(what, got, ref, *LIMITS["decode", "bfloat16"]))
        row["fault"] = reject_fault(f"{what}, window {W + 16}", pc.paged_decode_attention_cuda(
            q, kv, table, c, window=W + 16), ref, *LIMITS["decode", "bfloat16"])
        slots = sum(min(n, W) for n in ctx)
        row.update(ms=timed_ms(torch, lambda: pc.paged_decode_attention_cuda(
            q, kv, table, c, window=W), 20),
            ms_no_window=timed_ms(torch, lambda: pc.paged_decode_attention_cuda(
                q, kv, table, c), 20),
            plain_ms=eager_ms(torch, lambda: pc.paged_decode_attention_plain(
                q, kv, table, c, window=W), 1),
            bound_ms=1e3 * (2 * slots * Hkv * D + 2 * B * H * D) * 2 / peaks[2],
            bound_ms_no_window=1e3 * (2 * sum(ctx) * Hkv * D + 2 * B * H * D) * 2 / peaks[2],
            bound_by="bytes")
        print(f"  {what}: kernel {row['ms']:.4f} ms (no window {row['ms_no_window']:.4f}), "
              f"plain {row['plain_ms']:.3f}, bound {row['bound_ms']:.4f}", flush=True)
        rows.append(row)
    del kv
    return rows


def mellum_rope_row(torch) -> dict:
    """The RoPE kernel with YaRN frequencies and the attention factor, a
    4096-token chunk at positions 20,000-24,095: bit for bit against its
    plain version; the same kernel without the factor must differ."""
    lf = port("ops.layer_fused")
    H, Hkv, D = MELLUM_ATTN
    T, dev = 4096, "cuda"
    gen = torch.Generator(device=dev).manual_seed(42)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = rnd(1, T, H, D), rnd(1, T, Hkv, D), rnd(1, T, Hkv, D)
    pools = [rnd(T // 16 + 2, 2, 16, Hkv, D) for _ in range(3)]
    pools[1].copy_(pools[0])
    pools[2].copy_(pools[0])
    slots = (16 + torch.arange(T, device=dev))[None]
    positions = (20000 + torch.arange(T, device=dev))[None]
    freqs = lf.yarn_freqs(D, MELLUM_THETA, *MELLUM_YARN).to(dev)
    got = lf.rope_kv_fused(q, k, v, positions, freqs, pools[0], slots, scale=MELLUM_SCALE)
    want = lf.rope_kv_plain(q, k, v, positions, freqs, pools[1], slots, scale=MELLUM_SCALE)
    what = f"rope_kv YaRN, attention factor {MELLUM_SCALE}: T {T}, positions 20000-24095"
    if not (torch.equal(got, want) and torch.equal(pools[0], pools[1])):
        raise AssertionError(f"{what}: not bit-equal to the plain version")
    faulty = lf.rope_kv_fused(q, k, v, positions, freqs, pools[2], slots)
    if torch.equal(faulty, got):
        raise AssertionError(f"the limit does not reject the planted fault: {what}, no factor")
    print(f"  {what}: bit for bit; without the factor rejected", flush=True)
    return dict(what=what, max_abs_err=0.0, worst_err_over_limit=0.0, limit="bit for bit",
                fault={"fault": "attention factor left out", "rejected": True})


# A token whose kernel and plain routes differ must do so at a near-tie:
# its two experts' router logits within this of each other in float64
# (float32 sums over d_model terms in two orders).
ROUTE_TIE = 1e-4


def route_ties(torch, ids, want_ids, h, wr) -> dict:
    """Tokens whose kernel route differs from the plain version's, and
    whether each lies at a float64 near-tie (``ROUTE_TIE``)."""
    differ = (ids.sort(-1).values != want_ids.sort(-1).values).any(-1)
    gaps = []
    for t in torch.nonzero(differ).flatten().tolist():
        logits = (h[t].double() @ wr.double())
        a, b = set(ids[t].tolist()), set(want_ids[t].tolist())
        gaps.append(float((logits[sorted(a - b)] - logits[sorted(b - a)]).abs().max()))
    return {"rows": len(gaps), "widest_gap": max(gaps, default=0.0),
            "at_ties": all(g <= ROUTE_TIE for g in gaps), "same": ~differ}


def witness(torch, moe, got, plain, args, same) -> dict:
    """``got`` and the plain version against the float64 value of the
    kernels' own routing (err/limit by ``MOE_LIMITS``), over the tokens
    whose routes agree (``same``)."""
    x, h, wr, wg, wu, wd = args
    ids, wts = moe.moe_route_cuda(h, wr, MELLUM_EXPERTS[2], True)
    exact = moe.routed_experts_exact(x, h, wg, wu, wd, ids, wts)
    _, got_worst = err_over_limit(got[same], exact[same], *MOE_LIMITS)
    _, plain_worst = err_over_limit(plain[same], exact[same], *MOE_LIMITS)
    del exact
    return {"vs_float64": got_worst, "plain_vs_float64": plain_worst,
            "held": got_worst <= max(1.0, MOE_WITNESS_SLACK * plain_worst)}


def mellum_expert_rows(torch, peaks) -> list:
    """The routed-expert MLP at Mellum's widths: decode's 24 tokens (the
    grouped kernels, from a CUDA graph) and a 16,384-token prefill (the
    per-expert products), each against its plain version, the float64
    value beside it, a routed row left out rejected; then the grouped
    kernels and the products timed against each other from 64 to 16,384
    tokens (the grouped kernels forced by a graph capture)."""
    moe = port("ops.moe_experts")
    D, E, K, F = MELLUM_EXPERTS
    bf16, dev = torch.bfloat16, "cuda"
    gen = torch.Generator(device=dev).manual_seed(43)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(bf16)
    weights = (rnd(D, E, scale=D ** -0.5), rnd(E, D, F, scale=D ** -0.5),
               rnd(E, D, F, scale=D ** -0.5), rnd(E, F, D, scale=F ** -0.5))
    expert_bytes = 3 * D * F * 2
    rows = []
    for N in (MELLUM_ROWS, 16384):
        x, h = rnd(N, D), rnd(N, D)
        args = (x, h) + weights
        ids, wts = moe.moe_route_cuda(h, weights[0], K, True)
        want_ids, _ = moe.route_plain(h, weights[0], K, True)
        counts = torch.zeros(4, dtype=torch.int64, device=dev)
        got = moe.routed_experts_fused(*args, K, True, counts)
        plain = moe.routed_experts_plain(*args, K, True)
        path = "grouped" if N * K <= moe.GROUPED_MAX_ROWS else "products"
        what = f"routed experts ({path}): N {N} D {D} F {F} E {E} top {K}"
        offsets, perm, pos = moe.moe_group_cuda(ids, E)
        y = (moe.moe_experts_cuda(h, *weights[1:], offsets, perm, K) if path == "grouped"
             else moe._experts_by_products(h, *weights[1:], offsets, perm, K))
        dropped = wts.clone()
        dropped[N // 2, K - 1] = 0
        faulty = moe.moe_combine_cuda(x, y, pos, dropped)
        distinct = int((torch.bincount(ids.flatten().long(), minlength=E) > 0).sum())
        ties = route_ties(torch, ids, want_ids, h, weights[0])
        same = ties.pop("same")
        err, worst = err_over_limit(got[same], plain[same], *MOE_LIMITS)
        row = dict(what=what, max_abs_err=err, worst_err_over_limit=worst,
                   limit=limit_text(*MOE_LIMITS), routing_differs=ties,
                   distinct_experts=distinct,
                   counters=dict(zip(moe.COUNTER_FIELDS, counts.tolist())),
                   witness=witness(torch, moe, got, plain, args, same))
        row["fault"] = reject_fault(f"{what}, one routed row left out", faulty, plain,
                                    *MOE_LIMITS)
        print(f"  {what}: worst err/limit {worst:.4g} against the plain version; against "
              f"float64 {row['witness']['vs_float64']:.4g} (the plain version "
              f"{row['witness']['plain_vs_float64']:.4g}); routing differs in "
              f"{ties['rows']} tokens (widest float64 gap {ties['widest_gap']:.3g}); counters "
              f"{row['counters']}", flush=True)
        if not (worst <= 1.0 or row["witness"]["held"]) or not ties["at_ties"]:
            raise AssertionError(f"{what}: an element is past its limit ({worst}) and the "
                                 f"float64 witness does not hold it ({row['witness']}), or the "
                                 f"routing differs off a near-tie ({ties})")
        if counts.tolist()[0] != N * K or counts.tolist()[2] != 0:
            raise AssertionError(f"{what}: counters {counts.tolist()}")
        flops, nbytes = 2.0 * N * K * 3 * D * F, distinct * expert_bytes
        row.update(bound_ms=1e3 * max(flops / peaks[0], nbytes / peaks[2]),
                   bound_by="operations" if flops / peaks[0] > nbytes / peaks[2] else "bytes",
                   plain_ms=eager_ms(torch, lambda: moe.routed_experts_plain(*args, K, True), 1))
        if path == "grouped":
            row.update(ms=timed_ms(torch, lambda: moe.routed_experts_fused(*args, K, True), 20),
                       experts_ms=timed_ms(torch, lambda: moe.moe_experts_cuda(
                           h, *weights[1:], offsets, perm, K), 20),
                       experts_bound_ms=1e3 * nbytes / peaks[2],
                       route_group_ms=timed_ms(torch, lambda: moe.moe_group_cuda(
                           moe.moe_route_cuda(h, weights[0], K, True)[0], E), 20))
        else:
            row["ms"] = eager_ms(torch, lambda: moe.routed_experts_fused(*args, K, True), 3)
        print(f"  {what}: {row['ms']:.4f} ms, plain {row['plain_ms']:.3f}, bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
        rows.append(row)
        del x, h, got, plain, faulty, y
        torch.cuda.empty_cache()
    # The crossover: the grouped kernels (captured, as under a decode
    # graph) against the per-expert products (eager: the host reads the
    # offsets), device time of one layer's experts at each size.
    crossover = []
    for N in MOE_CROSSOVER_TOKENS:
        x, h = rnd(N, D), rnd(N, D)
        ids, _ = moe.moe_route_cuda(h, weights[0], K, True)
        offsets, perm, _ = moe.moe_group_cuda(ids, E)
        reps = 3 if N >= 2048 else 10
        grouped = timed_ms(torch, lambda: moe.moe_experts_cuda(h, *weights[1:], offsets, perm,
                                                               K), reps)
        products = eager_ms(torch, lambda: moe._experts_by_products(h, *weights[1:], offsets,
                                                                    perm, K), reps)
        crossover.append({"tokens": N, "routed_rows": N * K, "grouped_ms": grouped,
                          "products_ms": products})
        print(f"  experts of one layer at {N} tokens ({N * K} routed rows): grouped kernels "
              f"{grouped:.4f} ms, per-expert products {products:.4f} ms", flush=True)
        del x, h
    rows[0]["crossover"] = crossover
    return rows


def mellum_main_path(torch) -> dict:
    """Mellum's block at its widths, one period of its layer pattern
    (three windowed layers and a full one) at MELLUM_LAYERS layers,
    through the serving entry points: a prefill of MELLUM_PROMPT tokens,
    then MELLUM_ROWS rows over it decoding MELLUM_STEPS steps from one
    captured graph, and one eager ``decode_step`` on the last step's
    inputs.  Every kernel's counter is zeroed first and read after: the
    launches of this run, by path (eager counts; the graph's kernel nodes
    times its replays), and the expert layer's device counters."""
    llama, pool_mod = port("models.llama"), port("models.kv_cache_pool")
    fc, pc = port("ops.flash_cuda"), port("ops.paged_decode_cuda")
    moe = port("ops.moe_experts")
    H, Hkv, Dh = MELLUM_ATTN
    D, E, K, F = MELLUM_EXPERTS
    L, T, B, S, bs = MELLUM_LAYERS, MELLUM_PROMPT, MELLUM_ROWS, MELLUM_STEPS, 16
    yarn = llama.AttentionKind(rope_theta=MELLUM_THETA, yarn=MELLUM_YARN,
                               rope_scale=MELLUM_SCALE)
    windowed = llama.AttentionKind(window=MELLUM_WINDOW, rope_theta=MELLUM_THETA)
    cfg = llama.MixedLlamaConfig(
        vocab_size=MELLUM_VOCAB, d_model=D, n_layers=L, n_heads=H, n_kv_heads=Hkv, d_ff=7168,
        rope_theta=MELLUM_THETA, block_size=bs, head_dim=Dh,
        attention_kinds=(windowed,) * 3 + (yarn,), n_experts=E, experts_per_token=K,
        d_expert=F, norm_topk_prob=True, tie_embeddings=False)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                               device="cuda")
    own = -(-(S + 1) // bs)  # each row's blocks past the shared prompt
    pool = pool_mod.KVCachePool(pool_mod.KVCachePoolConfig(
        L, 1 + T // bs + B * own, bs, Hkv, Dh, "bfloat16"), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(1, MELLUM_VOCAB, (1, T), generator=gen, device="cuda")
    shared = torch.arange(1, 1 + T // bs, dtype=torch.int32, device="cuda")
    wrappers = [(fc, "flash_gqa_attention_cuda"), (pc, "paged_decode_attention_cuda")] + [
        (moe, f"moe_{name}_cuda") for name in ("route", "group", "experts", "combine")]
    for mod, name in wrappers:
        getattr(mod, name).launches = 0
    zero_layer_launches()
    for path in ("prefill", "decode"):
        moe.counters(path, torch.device("cuda", torch.cuda.current_device())).zero_()

    def counts() -> dict:
        return {**{name.removesuffix("_cuda"): getattr(mod, name).launches
                   for mod, name in wrappers}, **layer_launches()}
    t0 = time.perf_counter()
    logits, _ = llama.prefill_paged(params, prompt, pool.kv, shared[None], cfg)
    first = logits[0, -1].float().clone()
    del logits
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill = counts()
    table = torch.cat([shared.expand(B, -1), (1 + T // bs + torch.arange(
        B * own, device="cuda", dtype=torch.int32)).view(B, own)], dim=1)
    step = llama.make_decode_step(params, pool.kv, cfg, B, table.shape[1])
    step.graph = torch.cuda.CUDAGraph(keep_graph=True)
    tokens = torch.randint(1, MELLUM_VOCAB, (B,), generator=gen, device="cuda")
    ctx = torch.full((B,), T, dtype=torch.int32, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(S):
        ctx = ctx + 1
        if i == 1:
            start.record()
        out = step(tokens, table, ctx)
        last = (tokens, ctx)
        tokens = out.argmax(-1)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / (S - 1)
    replayed = step.replays
    graph_logits = out.float().clone()
    eager, _ = llama.decode_step(params, last[0], pool.kv, table, last[1], cfg)
    eager_err = float((eager.float() - graph_logits).abs().max())
    total = counts()
    fragments = {"paged_decode": ("paged_decode",), "moe_route": ("moe_route_kernel",),
                 "moe_group": ("moe_group_kernel",), "moe_experts": ("moe_rows_kernel",),
                 "moe_combine": ("moe_combine_kernel",)}
    nodes = {name: captured_kernel_nodes(step.graph, frag) for name, frag in fragments.items()}
    graph_layer = layer_launches(step.graph, replayed)
    device_counters = {path: moe.read_counters(path) for path in ("prefill", "decode")}
    # The host counts each wrapper call: the prefill, the capture's eager
    # run and its captured run, and the eager step; a replay runs the
    # graph's nodes, two moe_rows_kernel nodes a layer.
    eager_passes = 3
    want = {"flash_gqa_attention": L, "paged_decode_attention": eager_passes * L,
            "moe_route": (1 + eager_passes) * L, "moe_group": (1 + eager_passes) * L,
            "moe_experts": eager_passes * L, "moe_combine": (1 + eager_passes) * L,
            "rms_norm": (1 + eager_passes) * (2 * L + 1), "rope_kv": (1 + eager_passes) * L,
            "silu_mul": L}
    want_nodes = {"paged_decode": L, "moe_route": L, "moe_group": L, "moe_experts": 2 * L,
                  "moe_combine": L}
    # The device counters: the capture's run adds nothing (captured, not
    # run); the eager runs before and after it and every replay add one
    # call a layer.
    calls = L * (2 + replayed)
    want_counters = {"prefill": {"routed_rows": L * T * K, "dropped_rows": 0, "calls": L},
                     "decode": {"routed_rows": B * K * calls, "dropped_rows": 0, "calls": calls}}
    got_counters = {p: {k: c[k] for k in ("routed_rows", "dropped_rows", "calls")}
                    for p, c in device_counters.items()}
    # Kernel launches: a moe_experts call is two moe_rows_kernel launches.
    launches = {name: total[name] * (2 if name == "moe_experts" else 1)
                + replayed * nodes.get(name.removesuffix("_attention"), 0) for name in total}
    for name in ("rms_norm", "rope_kv", "silu_mul"):
        launches[name] = total[name] + graph_layer[name]
    print(f"  Mellum widths, {L} layers: prefill of {T} tokens {prefill_s:.2f} s (with the "
          f"first call's cuBLAS set-up); decode of {B} rows {step_ms:.3f} ms a step from the "
          f"graph ({replayed} replays); the eager step against the graph's last logits: "
          f"max_abs_err {eager_err:.4g}", flush=True)
    print(f"  launches (host): {total} (prefill alone {prefill}); graph nodes {nodes}, "
          f"layer kernels in the graph {graph_layer}; device counters {device_counters}",
          flush=True)
    if total != want or nodes != want_nodes or got_counters != want_counters:
        raise AssertionError(f"main path: launches {total} (want {want}), graph nodes {nodes} "
                             f"(want {want_nodes}), counters {got_counters} (want "
                             f"{want_counters})")
    if replayed != S or not bool(first.isfinite().all()):
        raise AssertionError(f"main path: {replayed} replays of {S}, or the prefill's "
                             "logits are not finite")
    check_logits("the eager decode step against the graph's", eager, graph_logits)
    distinct = device_counters["decode"]["distinct_experts"] / calls
    del params, pool, step
    torch.cuda.empty_cache()
    return {"layers": L, "prompt": T, "rows": B, "replays": replayed, "step_ms": step_ms,
            "prefill_s": prefill_s, "eager_vs_graph_max_abs_err": eager_err,
            "launches": launches, "host_launches": total, "graph_nodes": nodes,
            "device_counters": device_counters, "distinct_experts_a_call": distinct}


def mellum_phase(torch, peaks) -> dict:
    """Phase 4c: the kernels that serve Mellum2's block at the
    mellum2.repo-agent cell's shapes, then its main path."""
    attention = mellum_attention_rows(torch, peaks)
    torch.cuda.empty_cache()
    rope = mellum_rope_row(torch)
    experts = mellum_expert_rows(torch, peaks)
    return {"attention": attention, "rope": rope, "experts": experts,
            "main_path": mellum_main_path(torch)}


# ---------------------------------------------- KV events (phases 5, 13, 14)


EVENT_CHUNK_TOKENS = 2048  # one BlockStored per 2048-token prefill chunk
DEVICE_MEDIUM = "gpu"  # the medium vLLM pods on GPUs publish their device tier under
POLLER_BURST = 64  # kvevents/poller.py:MAX_RECV_PER_SOCKET, a poller's burst


def engine_hashes(parent, tokens, block_size: int):
    """The block hashes a ``sha256_cbor`` engine (vLLM) publishes for the
    full blocks of ``tokens`` that follow the block hashed ``parent``
    (None at a sequence's start): SHA-256 over the canonical CBOR of
    (parent hash, block tokens, None), chained block to block."""
    encode = port("kvcache.kvblock.cbor_canonical").encode_canonical
    out = []
    for start in range(0, len(tokens) - block_size + 1, block_size):
        parent = hashlib.sha256(encode([parent, tokens[start:start + block_size], None])).digest()
        out.append(parent)
    return out


class EventStream:
    """One pod's KV-event stream as its engine frames it,
    ``[b"kv@<pod>@<model>", seq (u64 big-endian), msgpack(EventBatch)]``
    with seq counting from 1: ``kvevents/publisher.py``'s framing,
    without the socket (the card's machine has no pyzmq)."""

    def __init__(self, pod: str, model: str = MODEL_NAME) -> None:
        self.pod = pod
        self.topic = f"kv@{pod}@{model}".encode()
        self.seq = 0

    def frame(self, *events, payload: bytes = None) -> list:
        """The next frame: ``events`` as one batch, or a payload encoded
        before."""
        if payload is None:
            payload = port("kvevents.events").EventBatch(ts=time.time(),
                                                         events=list(events)).encode()
        self.seq += 1
        return [self.topic, struct.pack(">Q", self.seq), payload]

    def skip(self, count: int) -> None:
        """``count`` frames lost on the wire: the next seq jumps."""
        self.seq += count


class EventSink:
    """A subscriber of one pool, as a poller is: each pod's frames go
    through ``parse_event_message`` with that pod's ``TopicSeqTracker``
    (and the gap listener), then one ``Pool.add_tasks`` a burst."""

    def __init__(self, pool, on_gap=None) -> None:
        self.pool = pool
        self.on_gap = on_gap
        self.trackers = {}

    def deliver(self, pod: str, frames) -> int:
        zs = port("kvevents.zmq_subscriber")
        tracker = self.trackers.setdefault(pod, zs.TopicSeqTracker())
        messages = [zs.parse_event_message(parts, endpoint=f"sim://{pod}", pod_identifier=pod,
                                           tracker=tracker, on_gap=self.on_gap)
                    for parts in frames]
        messages = [m for m in messages if m is not None]
        self.pool.add_tasks(messages)
        return len(messages)


def feed(sinks, frames_by_pod, burst: int = POLLER_BURST) -> int:
    """Deliver every pod's frames to every sink, ``burst`` frames of one
    pod at a time, the pods in turn (a poller's round over its sockets).
    Returns the frames delivered to each sink."""
    sent = dict.fromkeys(frames_by_pod, 0)
    live = [pod for pod, frames in frames_by_pod.items() if frames]
    while live:
        still = []
        for pod in live:
            start = sent[pod]
            chunk = frames_by_pod[pod][start:start + burst]
            for sink in sinks:
                sink.deliver(pod, chunk)
            sent[pod] = start + len(chunk)
            if sent[pod] < len(frames_by_pod[pod]):
                still.append(pod)
        live = still
    return sum(sent.values())


def event_fleet(rng, pods, convs: int, tokens: int, block_size: int, tiers=("hbm", "host")):
    """``convs`` random conversations of ``tokens`` tokens on each pod,
    conversation j on ``tiers[j % len(tiers)]``, as the pods' engines
    publish them: one ``BlockStored`` per EVENT_CHUNK_TOKENS prefill
    chunk, chained by parent, one batch a frame.  Returns the chains
    ``(pod, tier, token ids)``, each pod's frames and stream, its
    inventory (``InventoryBlock`` per chunk, as resync and the auditor
    pull it) and the block count."""
    events, resync = port("kvevents.events"), port("kvevents.resync")
    chains, frames, inventory, streams, blocks = [], {}, {}, {}, 0
    for pod in pods:
        stream = streams[pod] = EventStream(pod)
        frames[pod], inventory[pod] = [], []
        for j in range(convs):
            ids = rng.integers(1, READ_VOCAB, tokens).tolist()
            tier = tiers[j % len(tiers)]
            chains.append((pod, tier, ids))
            parent = None
            for start in range(0, len(ids), EVENT_CHUNK_TOKENS):
                hashes = engine_hashes(parent, ids[start:start + EVENT_CHUNK_TOKENS], block_size)
                if not hashes:
                    break
                chunk = ids[start:start + len(hashes) * block_size]
                frames[pod].append(stream.frame(events.BlockStored(
                    block_hashes=hashes, parent_block_hash=parent, token_ids=chunk,
                    block_size=block_size, medium=tier)))
                inventory[pod].append(resync.InventoryBlock(
                    block_hashes=hashes, token_ids=chunk, block_size=block_size,
                    parent_block_hash=parent, medium=tier))
                parent = hashes[-1]
                blocks += len(hashes)
    return dict(chains=chains, frames=frames, streams=streams, inventory=inventory,
                blocks=blocks, chunks_per_conv=-(-(tokens // block_size * block_size)
                                                 // EVENT_CHUNK_TOKENS))


def event_pool(index, hasher, journal=None, **config):
    """A started ``Pool`` over ``index`` (the write path's workers), with
    ``journal`` tapped in after each apply when given."""
    kv = port("kvevents.pool")
    pool = kv.Pool(index, hasher, kv.PoolConfig(**config), journal=journal)
    pool.start()
    return pool


def seed_by_events(indexers, frames_by_pod) -> float:
    """Every Indexer's index seeded from the same frames, each through
    its own pool and subscriber; returns the seconds until every pool
    drained."""
    pools = [event_pool(ix.kv_block_index, ix.token_processor) for ix in indexers]
    try:
        t0 = time.perf_counter()
        feed([EventSink(pool) for pool in pools], frames_by_pod)
        for pool in pools:
            pool.drain()
        return time.perf_counter() - t0
    finally:
        for pool in pools:
            pool.shutdown()


def index_entries(index, pod: str = None) -> dict:
    """``{request key: {(pod, tier)}}`` of an index (of one pod's
    entries, when ``pod`` is given), from ``dump_entries``."""
    out = {}
    for key, entries in index.dump_entries()[0]:
        held = {(e.pod_identifier, e.device_tier) for e in entries
                if pod is None or e.pod_identifier == pod}
        if held:
            out[key] = held
    return out


def expected_entries(hasher, chains) -> dict:
    """What seeding ``chains`` must leave in an index: each
    conversation's request keys, from the hash chain over its tokens
    alone, held by its pod on its tier."""
    out = {}
    for pod, tier, ids in chains:
        for key in hasher.tokens_to_kv_block_keys(0, ids, MODEL_NAME):
            out.setdefault(key, set()).add((pod, tier))
    return out


def host_state() -> dict:
    """What the host phases share the process with: live threads, objects
    the cyclic collector tracks, its full collections so far, the load."""
    threads = {}
    for thread in threading.enumerate():
        name = re.sub(r"[-_]?\d+$", "", thread.name)
        threads[name] = threads.get(name, 0) + 1
    return {"threads": threads, "gc_tracked": len(gc.get_objects()),
            "gc_full_collections": gc.get_stats()[2]["collections"],
            "loadavg": os.getloadavg()}


def label_totals(counter, label: str) -> dict:
    """A labeled counter's values by one label."""
    return {s.labels[label]: s.value for family in counter.collect() for s in family.samples}


# --------------------------------------------------------------- phase 5


# Kernel-name fragments -> the breakdown's categories (first match wins).
KERNEL_GROUPS = (
    ("prefill_attention", ("flash_bf16_kernel", "flash_merge_kernel")),
    ("decode_attention", ("paged_decode_bf16_kernel", "paged_decode_f32_kernel")),
    ("ring_attention", ("ring_partial_bf16_kernel", "ring_partial_f32_kernel")),
    ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitKreduce")),
)


def device_breakdown(torch, step, steps: int):
    """Where ``step``'s device time goes, per call, from a torch.profiler
    window of ``steps`` calls: the device self time of the kernels
    themselves (not of the host ops that launched them, which would
    count each kernel twice), grouped by ``KERNEL_GROUPS`` with the rest
    as ``other`` (elementwise, copies, gathers, reductions); overlap
    between streams is not subtracted.  Also the window's wall time,
    which the profiler inflates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    rows = []
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        group = next((name for name, keys in KERNEL_GROUPS
                      if any(key in event.key for key in keys)), "other")
        groups[group] += event.self_device_time_total / 1e3 / steps
        rows.append((event.key, event.count))
    device = sum(groups.values())
    if device <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return {"device_ms": device, "kernels_ms": groups, "profiled_wall_ms": wall,
            "kernel_rows": {name: kernel_rows_per_step(rows, keys, steps)
                            for name, keys in KERNEL_GROUPS[:3]}}


def kernel_rows_per_step(rows, fragments, steps: int) -> int:
    """Launches a step of the kernels whose names hold one of
    ``fragments``, from a profiler window of ``steps`` steps: ``rows``
    are (kernel name, times it ran on the device).  The count is taken
    where the kernels ran, so it also sees launches that a replayed CUDA
    graph makes without a Python call.  Fails unless every step ran the
    same number."""
    total = sum(count for name, count in rows if any(f in name for f in fragments))
    if total % steps:
        raise AssertionError(f"{total} launches of {fragments} do not divide over {steps} steps")
    return total // steps


def graph_kernel_nodes(dot: str, fragments) -> int:
    """Kernel nodes of a captured CUDA graph whose kernel's name holds
    one of ``fragments``, from the graph's DOT dump
    (``CUDAGraph.debug_dump``): every replay launches each of them once.
    A node's statement runs from its quoted id and ``[`` to the next
    statement; an edge (``"a" -> "b"``) names no kernel."""
    starts = [m.start() for m in re.finditer(r'^\s*"[^"\n]+"\s*\[', dot, re.MULTILINE)]
    nodes = [dot[a:b] for a, b in zip(starts, starts[1:] + [len(dot)])]
    return sum("KERNEL" in node and any(f in node for f in fragments) for node in nodes)


def captured_kernel_nodes(graph, fragments) -> int:
    """``graph_kernel_nodes`` of a captured ``torch.cuda.CUDAGraph`` made
    with ``keep_graph=True``."""
    import pathlib
    import tempfile

    with tempfile.TemporaryDirectory() as folder:
        path = pathlib.Path(folder) / "graph.dot"
        graph.debug_dump(str(path))
        return graph_kernel_nodes(path.read_text(), fragments)


# The layer kernels of csrc/layer_fused.cu: (the kernels line's name,
# the wrapper in ops/layer_fused.py, the kernel's name in a graph).
LAYER_KERNELS = (("rms_norm", "rms_norm_fused", "rms_norm_kernel"),
                 ("rope_kv", "rope_kv_fused", "rope_kv_kernel"),
                 ("silu_mul", "silu_mul_fused", "silu_mul_kernel"))


def zero_layer_launches() -> None:
    """Set the layer kernels' counters to 0, beside the attention
    kernels' before a main-path run."""
    lf = port("ops.layer_fused")
    for _, wrapper, _ in LAYER_KERNELS:
        getattr(lf, wrapper).launches = 0


def layer_launches(graph=None, replays: int = 0) -> dict:
    """{kernel: launches} of the layer kernels: each wrapper's count since
    ``zero_layer_launches`` (its eager launches), or, given a captured
    ``graph`` (``keep_graph=True``), its nodes of the kernel times its
    ``replays``."""
    lf = port("ops.layer_fused")
    if graph is None:
        return {name: getattr(lf, wrapper).launches for name, wrapper, _ in LAYER_KERNELS}
    return {name: replays * captured_kernel_nodes(graph, (kernel,))
            for name, _, kernel in LAYER_KERNELS}


def layer_expected(layers: int, calls: int) -> dict:
    """The layer kernels' launches of ``calls`` unsharded inference calls
    (prefills, continuations, decode steps) of ``layers`` layers: RMSNorm
    twice a layer and once before the head, RoPE and SiLU·up once a
    layer."""
    return {"rms_norm": calls * (2 * layers + 1), "rope_kv": calls * layers,
            "silu_mul": calls * layers}


def add_counts(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def show_breakdown(what: str, wall_ms: float, busy) -> dict:
    """Print and return a breakdown with the device's idle share of the
    unprofiled wall time ``wall_ms``."""
    idle = max(0.0, 1 - busy["device_ms"] / wall_ms)
    parts = ", ".join(f"{k} {v:.2f}" for k, v in busy["kernels_ms"].items())
    print(f"  {what}: {busy['device_ms']:.2f} ms of device kernels ({parts}); device idle "
          f"share {idle:.2f} of the unprofiled {wall_ms:.2f} ms (profiled window "
          f"{busy['profiled_wall_ms']:.2f} ms); attention kernel launches a step "
          f"{busy['kernel_rows']}", flush=True)
    return dict(busy, wall_ms=wall_ms, idle_share=idle)


class EngineEvents:
    """What a serving pod's engine publishes: its own ``sha256_cbor``
    hash of each cached block (``engine``, by the block's request key)
    and its event stream."""

    def __init__(self, pod: str) -> None:
        self.stream = EventStream(pod)
        self.engine = {}

    def publish(self, keys, tokens, fresh: int, evicted, bs: int) -> list:
        """The frame the engine publishes after a prefill that wrote the
        blocks ``keys[fresh:]`` of ``tokens``: the evicted blocks as one
        ``BlockRemoved``, the new full blocks as one ``BlockStored``
        chained to the cached block before them, both on ``DEVICE_MEDIUM``."""
        events = port("kvevents.events")
        out = []
        gone = [self.engine.pop(k) for k in evicted if k in self.engine]
        if gone:
            out.append(events.BlockRemoved(block_hashes=gone, medium=DEVICE_MEDIUM))
        parent = self.engine[keys[fresh - 1]] if fresh else None
        new_tokens = tokens[fresh * bs:len(keys) * bs]
        hashes = engine_hashes(parent, new_tokens, bs)
        self.engine.update(zip(keys[fresh:], hashes))
        out.append(events.BlockStored(block_hashes=hashes, parent_block_hash=parent,
                                      token_ids=new_tokens, block_size=bs, medium=DEVICE_MEDIUM))
        return self.stream.frame(*out)


class SimPod:
    """One simulated serving pod: paged pool + local prefix cache (the
    fleet benchmark's pod loop, over the port's ``KVCachePool``), and
    the KV events its engine publishes."""

    def __init__(self, name: str, cfg, pool_blocks: int, device: str = "cuda") -> None:
        pool_mod = port("models.kv_cache_pool")
        self.name = name
        self.pool_blocks = pool_blocks
        self.pool = pool_mod.KVCachePool(
            pool_mod.KVCachePoolConfig(
                cfg.n_layers, pool_blocks, cfg.block_size, cfg.n_kv_heads,
                cfg.head_dim, cfg.dtype,
            ),
            device=device,
        )
        self._next_block = 0
        # Engine-side prefix cache: chained block hash -> pool block id,
        # plus the reverse map so reuse evicts the old resident.
        self.cached = {}
        self._block_owner = {}
        self.events = EngineEvents(name)

    def alloc(self, n: int):
        """Bump-allocate n blocks; returns (ids, evicted block hashes)."""
        ids = [(self._next_block + i) % self.pool_blocks for i in range(n)]
        self._next_block = (self._next_block + n) % self.pool_blocks
        evicted = []
        for bid in ids:
            old = self._block_owner.pop(bid, None)
            if old is not None and self.cached.get(old) == bid:
                del self.cached[old]
                evicted.append(old)
        return ids, evicted

    def cached_prefix_blocks(self, block_hashes):
        """Pool ids of the longest cached consecutive prefix."""
        ids = []
        for h in block_hashes:
            if h not in self.cached:
                break
            ids.append(self.cached[h])
        return ids

    def commit(self, block_hashes, block_ids) -> None:
        for h, bid in zip(block_hashes, block_ids):
            self.cached[h] = bid
            self._block_owner[bid] = h


class WordTokenizer:
    """The card's tokenizer: ``"t<id>"`` words to ids, with byte offsets
    (bench.py's word tokenizer).  The card's machine has no tokenizer
    library, so the Indexer is given this one."""

    def type(self) -> str:
        return "word"

    def encode(self, prompt: str, model_name: str, add_special_tokens: bool):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]) if word[:1] == "t" else 0)
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return port("tokenization.tokenizers").Encoding(tokens=tokens, offsets=offsets)


def words(tokens) -> str:
    return " ".join(f"t{t}" for t in tokens)


def store_served_tokens(prompt: str, known: str = None):
    """(token ids, tokenized in full) as the tokenization pool serves a
    ``words`` prompt when ``known`` (None: nothing) is the text whose full
    tokenization the prefix store holds.  The store keeps the tokens of
    each full STORE_CHUNK_BYTES chunk of ``known`` (a token belongs to
    the chunk its end falls in); the prompt matches the chunks inside its
    common prefix with ``known``; if they cover at least
    STORE_MIN_OVERLAP of the prompt, their tokens are served, else the
    prompt is tokenized in full (and the store takes its chunks)."""
    data = prompt.encode()
    matched = 0
    if known is not None:
        text = known.encode()
        common = 0
        for x, y in zip(data, text):
            if x != y:
                break
            common += 1
        matched = common // STORE_CHUNK_BYTES
    if not data or matched * STORE_CHUNK_BYTES / len(data) < STORE_MIN_OVERLAP:
        return [int(w[1:]) for w in prompt.split(" ")], True
    end, pos, tokens = matched * STORE_CHUNK_BYTES, 0, []
    for word in known.split(" "):
        pos += len(word)
        if pos > end:
            break
        tokens.append(int(word[1:]))
        pos += 1
    return tokens, False


def tier_score(blocks: int, weight: float) -> float:
    """A pod's longest-prefix score over ``blocks`` blocks of one tier,
    summed block by block as the scorer sums it."""
    score = 0.0
    for _ in range(blocks):
        score += weight
    return score


def serving(torch, params, cfg):
    llama = port("models.llama")
    index_mod = port("kvcache.kvblock.index")
    indexer_mod = port("kvcache.indexer")
    tp_mod = port("kvcache.kvblock.token_processor")
    fc = port("ops.flash_cuda")
    pc = port("ops.paged_decode_cuda")

    layers = cfg.n_layers
    pods = [SimPod(f"pod-{n}", cfg, POOL_BLOCKS) for n in ("a", "b")]
    names = [p.name for p in pods]
    indexer = indexer_mod.Indexer(
        indexer_mod.IndexerConfig(token_processor_config=tp_mod.TokenProcessorConfig(
            block_size=cfg.block_size, hash_seed="0")),
        tokenizer=WordTokenizer())
    hasher = indexer.token_processor
    bs = cfg.block_size

    rng = torch.Generator().manual_seed(SEED)
    draw = lambda n: torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()  # noqa: E731
    prefix = draw(PREFIX_TOKENS)
    prompt_a = prefix + draw(SUFFIX_TOKENS)
    prompt_b = prefix + draw(SUFFIX_TOKENS)

    def serve(tokens, fallback):
        """Route and prefill one prompt: the Indexer scores its text
        (tokenize, hash, look up, score), then the chosen pod continues
        over its cached prefix (hit) or prefills the whole prompt (miss),
        and publishes its new blocks as KV events, which reach the
        Indexer's index through the scorer's event pool."""
        t_start = time.perf_counter()
        scores = indexer.get_pod_scores(words(tokens), MODEL_NAME, names)
        t_routed = time.perf_counter()
        if any(scores.values()):
            pod = next(p for p in pods if p.name == max(sorted(scores), key=scores.get))
        else:
            pod = fallback
        # The pod's own block keys, from the Indexer's token processor.
        keys = hasher.tokens_to_kv_block_keys(index_mod.EMPTY_BLOCK_HASH, tokens, MODEL_NAME)
        cached = pod.cached_prefix_blocks(keys)
        if cached:  # hit: continue over the cached prefix
            new_ids, evicted = pod.alloc(len(keys) - len(cached))
            ids = cached + new_ids
            prefix_len = len(cached) * bs
            logits, _ = llama.prefill_continue(
                params, torch.tensor([tokens[prefix_len:]]), pod.pool.kv,
                torch.tensor([ids], dtype=torch.int32), prefix_len, cfg)
        else:  # miss: prefill the whole prompt
            new_ids, evicted = pod.alloc(len(keys))
            ids = new_ids
            logits, _ = llama.prefill_paged(
                params, torch.tensor([tokens]), pod.pool.kv,
                torch.tensor([ids], dtype=torch.int32), cfg)
        first = int(logits[0, -1].argmax())
        ttft = time.perf_counter() - t_start
        fresh = len(cached)
        pod.commit(keys[fresh:], ids[fresh:])
        # The engine publishes what it wrote; the blocks reach the index
        # once the scorer's pool has applied the frame (drain).
        frame = pod.events.publish(keys, tokens, fresh, evicted, bs)
        stages0 = scorer.events_pool.stage_stats()
        t_pub = time.perf_counter()
        sink.deliver(pod.name, [frame])
        scorer.events_pool.drain()
        lag = time.perf_counter() - t_pub
        stages = {k: v - stages0[k] for k, v in scorer.events_pool.stage_stats().items()}
        last = tp_mod.engine_hash_to_uint64(pod.events.engine[keys[-1]])
        if indexer.kv_block_index.get_request_key(last) != keys[-1]:
            raise AssertionError(f"{pod.name}'s published blocks are not in the index")
        return dict(pod=pod, keys=keys, ids=ids, logits=logits, first=first,
                    ttft_ms=ttft * 1e3, route_ms=(t_routed - t_start) * 1e3,
                    reused=len(cached), scores=scores, lag_ms=lag * 1e3,
                    published=len(keys) - fresh, evicted=len(evicted),
                    decode_ms=stages["decode_s"] * 1e3, apply_ms=stages["apply_s"] * 1e3)

    # Warm-up outside the measured run, at every shape it will use (a
    # full prefill, a continuation, a batch-2 decode) on pod-b's pool
    # and without touching the index, so cuBLAS has picked its
    # algorithms before anything is timed.
    n_prefix = PREFIX_TOKENS // bs
    warm_ids, _ = pods[1].alloc(len(prompt_a) // bs)
    llama.prefill_paged(params, torch.tensor([draw(len(prompt_a))]), pods[1].pool.kv,
                        torch.tensor([warm_ids], dtype=torch.int32), cfg)
    warm_suffix, _ = pods[1].alloc(SUFFIX_TOKENS // bs)
    warm_hit = warm_ids[:n_prefix] + warm_suffix
    llama.prefill_continue(params, torch.tensor([draw(SUFFIX_TOKENS)]), pods[1].pool.kv,
                           torch.tensor([warm_hit], dtype=torch.int32), PREFIX_TOKENS, cfg)
    warm_extra, _ = pods[1].alloc(2)
    llama.decode_step(
        params, torch.tensor([1, 2]), pods[1].pool.kv,
        torch.tensor([warm_ids + warm_extra[:1], warm_hit + warm_extra[1:]], dtype=torch.int32),
        torch.full((2,), len(prompt_a) + 1, dtype=torch.int32), cfg)
    torch.cuda.synchronize()

    fc.flash_gqa_attention_cuda.launches = 0
    pc.paged_decode_attention_cuda.launches = 0
    zero_layer_launches()

    # The scheduler's scorer around the Indexer: its event pool is the
    # only way blocks reach the index; no sockets (discover_pods off).
    sched = port("scheduler.precise_scorer")
    scorer = sched.PrecisePrefixCacheScorer(
        sched.PrecisePrefixCacheScorerConfig(discover_pods=False), indexer=indexer)
    sink = EventSink(scorer.events_pool)
    try:
        a = serve(prompt_a, pods[0])
        b = serve(prompt_b, pods[1])
        candidates = [sched.Pod(f"default/{p.name}", p.name) for p in pods]
        normalized = scorer.score(sched.LLMRequest(
            target_model=MODEL_NAME, completions=sched.CompletionsBody(prompt=words(prompt_b))),
            candidates)
        normalized = {pod.address: score for pod, score in normalized.items()}
    except BaseException:
        scorer.shutdown()
        raise
    # The scorer (its Indexer and event pool) lives on for phase 7b,
    # which shuts it down; phases 7 and 12a hash with its token processor.
    print(f"  request A: Indexer scores {a['scores']} -> {a['pod'].name}, reused "
          f"{a['reused']} blocks (miss: prefill_paged over {len(prompt_a)} tokens), TTFT "
          f"{a['ttft_ms']:.1f} ms (routing through the Indexer {a['route_ms']:.1f} ms)",
          flush=True)
    # The router sees the tokens the prefix store serves for B: those of
    # A's full text chunks inside the prefix A and B share.
    served_b, _ = store_served_tokens(words(prompt_b), words(prompt_a))
    want_b = {pods[0].name: tier_score(len(served_b) // bs, 1.0), pods[1].name: 0.0}
    print(f"  request B: Indexer scores {b['scores']} (over the {len(served_b)} tokens the "
          f"prefix store serves from A's text) -> {b['pod'].name}, reused {b['reused']} "
          f"blocks (hit: prefill_continue over {len(prompt_b) - b['reused'] * bs} tokens), "
          f"TTFT {b['ttft_ms']:.1f} ms (routing through the Indexer {b['route_ms']:.1f} ms)",
          flush=True)
    pod_a, ids_a, ids_b, logits_b = a["pod"], a["ids"], b["ids"], b["logits"]
    first_a, first_b = a["first"], b["first"]
    if a["scores"] != dict.fromkeys(names, 0.0) or a["reused"]:
        raise AssertionError(f"request A must be an index miss: {a['scores']}")
    if b["pod"] is not pod_a or b["reused"] != PREFIX_TOKENS // bs:
        raise AssertionError("request B must hit A's pod on the whole prefix")
    if b["scores"] != want_b:
        raise AssertionError(f"unexpected scores for B: {b['scores']}, expected {want_b}")
    for name, req in (("A", a), ("B", b)):
        print(f"  event lag, request {name}: {req['pod'].name} published {req['published']} "
              f"blocks ({req['evicted']} evicted) in one frame; {req['lag_ms']:.2f} ms from the "
              f"publish to the keys in the index (decode {req['decode_ms']:.2f} ms, apply "
              f"{req['apply_ms']:.2f} ms in the pool)", flush=True)
    print(f"  PrecisePrefixCacheScorer.score(B's completion, both pods): {normalized}",
          flush=True)
    if normalized != {names[0]: 1.0, names[1]: 0.0}:
        raise AssertionError(f"the scheduler's scores for B: {normalized}")
    if a["logits"].shape != (1, len(prompt_a), cfg.vocab_size) or logits_b.shape != (
            1, SUFFIX_TOKENS, cfg.vocab_size):
        raise AssertionError("unexpected logits shapes")
    miss_tail = a["logits"][:, -REF_TAIL:].clone()  # phase 12a's reference
    del a["logits"]  # 4.3 GB of float32 logits
    # Phase 7 offloads this prefix as B's hit read it; the decode checks
    # below write into three of its blocks (the narrower tables).
    prefix_ids = ids_b[:PREFIX_TOKENS // bs]
    prefix_kv = pod_a.pool.kv[:, torch.tensor(prefix_ids, device="cuda")]

    # Decode both requests in one batch of 2 on their pod, through the
    # captured step: one CUDA graph of decode_step, replayed per token.
    # Pod-b's pool gets a copy of pod-a's first, so that the eager
    # decode_step can run the same eight inputs there afterwards.
    pods[1].pool.kv.copy_(pod_a.pool.kv)
    extra, _ = pod_a.alloc(2)
    table = torch.tensor([ids_a + [extra[0]], ids_b + [extra[1]]], dtype=torch.int32)
    captured = llama.make_decode_step(params, pod_a.pool.kv, cfg, 2, table.shape[1])
    # A graph object that keeps its nodes, for the count below.
    captured.graph = torch.cuda.CUDAGraph(keep_graph=True)
    # The first call captures (outside the timed run, as the warm-up
    # above is): it decodes step 1, and the timed run's step 1 writes
    # the same K/V into the same slot again.
    tokens = torch.tensor([first_a, first_b], device="cuda")
    ctx0 = torch.full((2,), len(prompt_a), dtype=torch.int32, device="cuda")
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    prefill_layer = layer_launches()  # A's and B's prefills, before the capture's runs
    t_cap = time.perf_counter()
    captured(tokens, table, ctx0 + 1)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t_cap
    # What the graph keeps for its life: its private pool holds every
    # intermediate of the step, the float32 copy of the embedding too.
    graph_pool_gb = (torch.cuda.memory_reserved() - reserved) / 2**30
    captured.replays = 0
    inputs, step_logits = [], []
    generated = [tokens]
    ctx = ctx0
    torch.cuda.synchronize()
    t_dec = time.perf_counter()
    for _ in range(DECODE_STEPS):
        ctx = ctx + 1
        inputs.append((tokens, ctx))
        logits = captured(tokens, table, ctx).clone()  # the static output
        step_logits.append(logits)
        tokens = logits.argmax(-1)
        generated.append(tokens)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t_dec) * 1e3 / DECODE_STEPS
    main_replays = captured.replays
    python_calls = pc.paged_decode_attention_cuda.launches
    out_tokens = torch.stack(generated, 1).tolist()
    print(f"  decode: {DECODE_STEPS} steps at batch 2 replayed from one CUDA graph (captured "
          f"in {capture_s:.2f} s, {graph_pool_gb:.2f} GiB of device memory reserved for it), "
          f"{ms_per_step:.2f} ms/step; tokens {out_tokens}", flush=True)
    if not all(bool(x.isfinite().all()) for x in step_logits):
        raise AssertionError("decode logits not finite")
    # The eager decode_step over the same eight inputs, on pod-b's copy.
    table_dev = table.cuda()
    eager_logits = []
    torch.cuda.synchronize()
    t_dec = time.perf_counter()
    for step_tokens, step_ctx in inputs:
        eager_logits.append(llama.decode_step(
            params, step_tokens, pods[1].pool.kv, table_dev, step_ctx, cfg)[0])
    torch.cuda.synchronize()
    eager_ms_per_step = (time.perf_counter() - t_dec) * 1e3 / DECODE_STEPS
    same_logits = [torch.equal(x, y) for x, y in zip(step_logits, eager_logits)]
    same_tokens = [x.argmax(-1).tolist() == y.argmax(-1).tolist()
                   for x, y in zip(step_logits, eager_logits)]
    same_pool = torch.equal(pod_a.pool.kv, pods[1].pool.kv)
    print(f"  eager decode_step over the same {DECODE_STEPS} inputs on pod-b's copy of the "
          f"pool: {eager_ms_per_step:.2f} ms/step; logits bit-equal to the captured step's at "
          f"steps {[i + 1 for i, same in enumerate(same_logits) if same]}, same tokens at "
          f"every step: {all(same_tokens)}, pools bit-equal afterwards: {same_pool}",
          flush=True)
    if not (same_logits[0] and all(same_tokens) and same_pool):
        raise AssertionError("the captured decode step and the eager one disagree")
    del eager_logits
    # The main path's launches, from request A to the last decode step
    # (the profiler windows and the checks below launch the kernels
    # again).  The prefill kernel is launched by its Python wrapper; the
    # decode kernel by the graph the main path replayed, so its count is
    # those replays times the decode kernel nodes of that graph.
    decode_nodes = captured_kernel_nodes(captured.graph, dict(KERNEL_GROUPS)["decode_attention"])
    launches = {
        "flash_prefill": fc.flash_gqa_attention_cuda.launches,
        "paged_decode": main_replays * decode_nodes,
        **add_counts(prefill_layer, layer_launches(captured.graph, main_replays)),
    }
    expected = {"flash_prefill": 2 * layers, "paged_decode": DECODE_STEPS * layers,
                **layer_expected(layers, 2 + DECODE_STEPS)}
    print(f"  kernel launches on the main path (2 prefills, {DECODE_STEPS} decode steps, "
          f"{layers} layers): {launches} ({main_replays} replays x {decode_nodes} decode "
          f"kernel nodes in the replayed graph, and as many of each layer kernel as the graph "
          f"holds; the decode wrapper's Python count, which sees the warm-up and the capture "
          f"only: {python_calls})", flush=True)
    if launches != expected or python_calls != 2 * layers:
        raise AssertionError(f"main-path launches {launches}, expected {expected}; Python "
                             f"calls {python_calls}, expected {2 * layers}")
    # Where the device time of a replay goes, from the kernels the
    # profiler saw run in two further replays; it must see each replay
    # launch the graph's decode nodes.
    decode_split = show_breakdown(
        "decode step (graph replay) under torch.profiler", ms_per_step,
        device_breakdown(torch, lambda: captured(tokens, table, ctx + 1), steps=2))
    if decode_split["kernel_rows"]["decode_attention"] != decode_nodes:
        raise AssertionError(f"the profiler saw {decode_split['kernel_rows']} kernels a replay, "
                             f"the graph holds {decode_nodes} decode kernel nodes")
    # The captured step past the main path's one shape, each call held
    # bit-equal (logits and pool) to the eager decode_step on pod-b's
    # pool: a table narrower than the step's capacity, copied into the
    # left columns while the right ones still hold the wide table's ids;
    # the wide table again; and a second step, captured for another
    # batch size and width over the same pool.
    pods[1].pool.kv.copy_(pod_a.pool.kv)  # the profiled replays wrote pod-a's pool only
    solo = llama.make_decode_step(params, pod_a.pool.kv, cfg, 1, 200)
    captured_cases = {}
    for what, step, toks, tab, lens in (
            ("a 300-block table in the 530-block step", captured, tokens, table[:, :300],
             [300 * bs - 3, 2000]),
            ("the 530-block table again", captured, tokens, table, ctx + 1),
            ("a second step, captured for batch 1 and 200 blocks", solo, tokens[1:],
             table[1:, :200], [200 * bs - 7])):
        lens = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
        got = step(toks, tab, lens).clone()
        want = llama.decode_step(params, toks, pods[1].pool.kv, tab, lens, cfg)[0]
        captured_cases[what] = (torch.equal(got, want)
                                and torch.equal(pod_a.pool.kv, pods[1].pool.kv))
        print(f"  captured step, {what} (context {lens.tolist()}): logits and pool bit-equal "
              f"to the eager decode_step's: {captured_cases[what]}", flush=True)
    if not all(captured_cases.values()) or solo.replays != 1:
        raise AssertionError(f"the captured decode step and the eager one disagree: "
                             f"{captured_cases}")
    del solo, got, want
    # The same for the two prefills, re-run on pod-b's warm-up blocks
    # (the index and pod-a are not touched).
    miss_split = show_breakdown(
        "miss prefill under torch.profiler", a["ttft_ms"] - a["route_ms"],
        device_breakdown(torch, lambda: llama.prefill_paged(
            params, torch.tensor([prompt_a]), pods[1].pool.kv,
            torch.tensor([warm_ids], dtype=torch.int32), cfg), steps=1))
    hit_split = show_breakdown(
        "hit continuation under torch.profiler", b["ttft_ms"] - b["route_ms"],
        device_breakdown(torch, lambda: llama.prefill_continue(
            params, torch.tensor([prompt_b[PREFIX_TOKENS:]]), pods[1].pool.kv,
            torch.tensor([warm_hit], dtype=torch.int32), PREFIX_TOKENS, cfg), steps=1))

    # Prefix-hit contract: B's continuation equals a fresh full prefill
    # of B (on the other pod's pool).
    full_ids, _ = pods[1].alloc(len(b["keys"]))
    full_b, _ = llama.prefill_paged(
        params, torch.tensor([prompt_b]), pods[1].pool.kv,
        torch.tensor([full_ids], dtype=torch.int32), cfg)
    ref = full_b[:, PREFIX_TOKENS:]
    hit_err = check_logits("prefix-hit contract: continuation vs full prefill_paged",
                           logits_b, ref)
    hit_gap = check_next_token("prefix-hit contract: next token", first_b, ref[0, -1], hit_err)
    full_last = full_b[:, -1].clone()
    del full_b, ref
    # Chunked prefill of B (4 chunks, each attending over the pool with
    # its q_offset) ends on the full prefill's last-position logits.
    chunk_ids, _ = pods[1].alloc(len(b["keys"]))
    chunked, _ = llama.prefill_chunked(
        params, torch.tensor([prompt_b]), pods[1].pool.kv,
        torch.tensor([chunk_ids], dtype=torch.int32), cfg,
        chunk_tokens=len(prompt_b) // 4)
    chunk_err = check_logits("prefill_chunked vs full prefill_paged (last position)",
                             chunked, full_last)
    # Decode step 1 of B equals the dense forward over B + its first token.
    dense = llama.forward(params, torch.tensor([prompt_b + [first_b]]), cfg)[:, -1]
    dec_err = check_logits("decode step 1 vs dense forward", step_logits[0][1:2], dense)
    del dense
    # The pool's offload staging on the card: a pinned copy made on a
    # side stream, read after its event, holds the block-major gather.
    staged, event = pod_a.pool.stage_gather_pinned(ids_b[:4])
    event.synchronize()
    if not staged.is_pinned() or staged.view(torch.uint16).numpy().tobytes() != (
            pod_a.pool.gather_block_major(ids_b[:4]).tobytes()):
        raise AssertionError("stage_gather_pinned differs from gather_block_major")
    print("  KVCachePool.stage_gather_pinned: pinned side-stream copy of 4 blocks equals "
          "gather_block_major", flush=True)
    return {
        "launches": launches,
        "ttft_miss_ms": a["ttft_ms"],
        "ttft_hit_ms": b["ttft_ms"],
        "route_miss_ms": a["route_ms"],
        "route_hit_ms": b["route_ms"],
        "event_lag_ms": {"miss": a["lag_ms"], "hit": b["lag_ms"]},
        "event_decode_ms": {"miss": a["decode_ms"], "hit": b["decode_ms"]},
        "event_apply_ms": {"miss": a["apply_ms"], "hit": b["apply_ms"]},
        "scheduler_scores": normalized,
        "decode_ms_per_step": ms_per_step,
        "decode_eager_ms_per_step": eager_ms_per_step,
        "decode_capture_s": capture_s,
        "decode_graph_pool_gib": graph_pool_gb,
        "decode_captured_cases": captured_cases,
        "breakdown_ms": {"miss": miss_split, "hit": hit_split, "decode_step": decode_split},
        "prefix_hit_max_abs_err": hit_err,
        "prefix_hit_token_gap": hit_gap,
        "chunked_max_abs_err": chunk_err,
        "decode_max_abs_err": dec_err,
        "offload_inputs": dict(pod_a=pod_a, prefix_ids=prefix_ids, prefix_kv=prefix_kv,
                               prompt_b=prompt_b, keys_b=b["keys"], logits_b=logits_b,
                               first_b=first_b, hasher=hasher, decode_b1=step_logits[0][1:2]),
        "http_inputs": dict(scorer=scorer, sink=sink, indexer=indexer, pods=pods, prefix=prefix,
                            route_hit_ms=b["route_ms"], ttft_hit_ms=b["ttft_ms"]),
        "tiering_inputs": dict(scorer=scorer, indexer=indexer, pods=pods, prompt_a=prompt_a,
                               prompt_b=prompt_b, keys_b=b["keys"], prefix_ids=prefix_ids,
                               logits_b=logits_b, first_b=first_b, ttft_miss_ms=a["ttft_ms"],
                               route_miss_ms=a["route_ms"]),
        "sharded_inputs": dict(prompt_a=prompt_a, prompt_b=prompt_b, ids_a=ids_a, ids_b=ids_b,
                               keys_a=a["keys"], keys_b=b["keys"], hasher=hasher,
                               miss_tail=miss_tail, logits_b=logits_b, table=table,
                               decode_inputs=inputs, step_logits=step_logits,
                               miss_ms=a["ttft_ms"], hit_ms=b["ttft_ms"],
                               decode_ms=ms_per_step, decode_eager_ms=eager_ms_per_step),
    }


# -------------------------------------------------------------- phase 5c


HTTP_DECODE_STEPS = 4  # C's decode steps on the decode kernel, eager


def padded_words(tokens) -> str:
    """``tokens`` as fixed-width words (``t000123``), the last one padded
    further so that the text is a whole number of the prefix store's
    STORE_CHUNK_BYTES chunks.  The words differ from ``words``' for the
    same ids, so such a text shares no chunk with a ``words`` text in the
    store: the pool tokenizes it in full once, and from then on the store
    serves every one of its tokens (none ends in a partial chunk)."""
    width = len(str(max(tokens))) + 1  # every word carries a leading zero
    text = [f"t{t:0{width}d}" for t in tokens]
    pad = -(len(text) * (width + 2) - 1) % STORE_CHUNK_BYTES
    text[-1] = f"t{tokens[-1]:0{width + pad}d}"
    return " ".join(text)


class HttpClient:
    """One keep-alive HTTP/1.1 connection to a service on the loopback."""

    def __init__(self, server, timeout: float = 120.0) -> None:
        self.conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                               timeout=timeout)

    def call(self, method: str, path: str, body=None, headers=None):
        """``(status, payload)``: JSON bodies parsed, others as bytes."""
        data = json.dumps(body).encode() if body is not None else None
        self.conn.request(method, path, body=data,
                          headers={"Content-Type": "application/json", **(headers or {})})
        response = self.conn.getresponse()
        raw = response.read()
        if "json" in (response.getheader("Content-Type") or ""):
            return response.status, json.loads(raw)
        return response.status, raw

    def ok(self, method: str, path: str, body=None, headers=None):
        status, payload = self.call(method, path, body, headers)
        if status != 200:
            raise AssertionError(f"{method} {path}: HTTP {status}: {payload!r:.300}")
        return payload

    def close(self) -> None:
        self.conn.close()


class HeldCalls:
    """While on, every call the model module makes to a kernel wrapper
    through its ``name`` goes to the wrapper as before (it launches and
    counts as usual) and is kept, inputs and output, so that ``hold`` can
    compare each output afterwards with the wrapper's plain version on the
    same inputs (those comparisons launch no kernel and count nothing)."""

    def __init__(self, module, name: str, plain, kind: str, tag: str = "5c") -> None:
        self.module, self.name, self.plain, self.kind, self.tag = module, name, plain, kind, tag
        self.wrapper = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def held(*args, **kwargs):
            out = self.wrapper(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out

        setattr(self.module, self.name, held)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.wrapper)

    def hold(self, what: str) -> dict:
        """Fail unless every kept output is finite and within ``LIMITS``
        of the plain version's on the same inputs."""
        if not self.calls:  # the CPU's prefill takes the tiled op, not the wrapper
            print(f"  {what}: no call to hold", flush=True)
            return {"calls": 0}
        errs, worst, finite = [], [], True
        for args, kwargs, out in self.calls:
            err, ratio = err_over_limit(out, self.plain(*args, **kwargs),
                                        *LIMITS[self.kind, str(args[0].dtype)[6:]])
            errs.append(err)
            worst.append(ratio)
            finite = finite and bool(out.float().isfinite().all())
        limit = limit_text(*LIMITS[self.kind, str(self.calls[0][0][0].dtype)[6:]])
        print(f"  {what}: {len(self.calls)} calls held against the plain version on the same "
              f"inputs: max_abs_err {max(errs):.6g}, worst err/limit {max(worst):.4g} (limit "
              f"{limit}){'' if finite else ' NOT FINITE'}", flush=True)
        if not finite or not max(worst) <= 1.0:
            raise AssertionError(f"{self.tag}: {what}: an output is past its limit "
                                 f"({max(worst)}) or not finite")
        return {"calls": len(self.calls), "max_abs_err": max(errs),
                "worst_err_over_limit": max(worst), "limit": limit}


def serving_http(torch, params, cfg, t) -> dict:
    """Phase 5c: request C routed through the port's HTTP service
    (``api.http_service.serve``) on phase 5's Indexer, whose index only
    the pods' KV events fill; pod-a continues C on the prefill kernel,
    decodes it on the decode kernel and publishes its new blocks.  Every
    kernel call on the way is held against its plain version."""
    llama, index_mod = port("models.llama"), port("kvcache.kvblock.index")
    fc, pc = port("ops.flash_cuda"), port("ops.paged_decode_cuda")
    service, indexer_mod = port("api.http_service"), port("kvcache.indexer")
    instrumented = port("kvcache.kvblock.instrumented")
    scorer, sink, pods = t["scorer"], t["sink"], t["pods"]
    # The service's Indexer: phase 5's index (which the scorer's event
    # pool fills) behind the metrics wrapper, the service's default
    # (ENABLE_METRICS), so that /metrics counts its lookups; phase 5's
    # own Indexer and its routing times stay as they were.
    indexer = indexer_mod.Indexer(
        t["indexer"].config, token_processor=t["indexer"].token_processor,
        tokenizer=WordTokenizer(),
        kv_block_index=instrumented.InstrumentedIndex(t["indexer"].kv_block_index))
    pod_a, bs, layers = pods[0], cfg.block_size, cfg.n_layers
    names = [p.name for p in pods]
    device = pod_a.pool.kv.device
    suffix_tokens, decode_steps = SUFFIX_TOKENS, HTTP_DECODE_STEPS
    # C's suffix from its own generator: phase 5's draws stay as they were.
    rng = torch.Generator().manual_seed(SEED + 5)
    tokens = t["prefix"] + torch.randint(1, cfg.vocab_size, (suffix_tokens,),
                                         generator=rng).tolist()
    prompt = padded_words(tokens)
    keys = indexer.token_processor.tokens_to_kv_block_keys(index_mod.EMPTY_BLOCK_HASH, tokens,
                                                           MODEL_NAME)
    n_prefix = len(t["prefix"]) // bs
    suffix_blocks = len(keys) - n_prefix
    pool_stats = scorer.events_pool.stage_stats
    server = service.serve(indexer, host="127.0.0.1", port=0, event_plane_status=lambda: {
        "pollers": 0, "subscriptions": len(sink.trackers), "stages": pool_stats()})
    client = HttpClient(server)
    try:
        lookups0 = lookup_counter(client.ok("GET", "/metrics").decode())
        trace_id = f"{SEED + 5:032x}"
        body = {"prompt": prompt, "model": MODEL_NAME, "pods": names}
        held_prefill = HeldCalls(llama, "flash_gqa_attention_cuda",
                                 fc.flash_gqa_attention_plain, "prefill")
        held_decode = HeldCalls(llama, "paged_decode_attention_cuda",
                                pc.paged_decode_attention_plain, "decode")
        fc.flash_gqa_attention_cuda.launches = 0
        pc.paged_decode_attention_cuda.launches = 0
        zero_layer_launches()
        t_post = time.perf_counter()
        routed = client.ok("POST", "/score_completions?explain=1", body,
                           {"traceparent": f"00-{trace_id}-{1:016x}-01"})
        t_routed = time.perf_counter()
        scores = routed["scores"]
        pod = next(p for p in pods if p.name == max(sorted(scores), key=scores.get))
        cached = pod.cached_prefix_blocks(keys)
        new_ids, evicted = pod.alloc(len(keys) - len(cached))
        ids = cached + new_ids
        logits, _ = llama.prefill_continue(
            params, torch.tensor([tokens[len(cached) * bs:]]), pod.pool.kv,
            torch.tensor([ids], dtype=torch.int32), len(cached) * bs, cfg)
        first = int(logits[0, -1].argmax())
        t_first = time.perf_counter()
        # C decodes on its pod, eagerly: one decode_step a token.
        extra, extra_evicted = pod.alloc(-(-decode_steps // bs))
        table = torch.tensor([ids + extra], dtype=torch.int32, device=device)
        step_tokens, generated, finite = torch.tensor([first], device=device), [first], True
        t_dec = time.perf_counter()
        with held_decode:
            for step in range(decode_steps):
                ctx = torch.tensor([len(tokens) + step + 1], dtype=torch.int32, device=device)
                step_logits = llama.decode_step(params, step_tokens, pod.pool.kv, table, ctx,
                                                cfg)[0]
                finite = finite and bool(step_logits.isfinite().all())
                step_tokens = step_logits.argmax(-1)
                generated.append(int(step_tokens[0]))
        if device.type == "cuda":
            torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t_dec) * 1e3 / decode_steps
        launches = {"flash_prefill": fc.flash_gqa_attention_cuda.launches,
                    "paged_decode": pc.paged_decode_attention_cuda.launches,
                    **layer_launches()}
        # Each kernel call of C's decode against the plain version, on its
        # own inputs: the pool views a decode call read have since been
        # written only at positions past its context.  The continuation's
        # calls are held in a second run of it, made after the count was
        # read (keeping each layer's gathered K and V, 1.1 GB, alive inside
        # the timed run made C's continuation 4x slower on an H100): the
        # same tokens, pool and blocks (the decode wrote only past them),
        # so the same calls, and the run's logits must be bit-equal to the
        # main path's.
        with held_prefill:
            again, _ = llama.prefill_continue(
                params, torch.tensor([tokens[len(cached) * bs:]]), pod.pool.kv,
                torch.tensor([ids], dtype=torch.int32), len(cached) * bs, cfg)
        rerun_equal = torch.equal(again, logits)
        del again
        held = {"flash_prefill": held_prefill.hold(
                    f"C's continuation run again (logits bit-equal to the main path's: "
                    f"{rerun_equal}), prefill kernel"),
                "paged_decode": held_decode.hold(f"C's {decode_steps} decode steps at batch 1, "
                                                 f"decode kernel")}
        del held_prefill, held_decode
        in_process = indexer.get_pod_scores(prompt, MODEL_NAME, names)
        # Pod-a publishes C's new blocks; they reach the index through the
        # scorer's event pool, as phase 5's did.
        pod.commit(keys[len(cached):], ids[len(cached):])
        sink.deliver(pod.name, [pod.events.publish(keys, tokens, len(cached),
                                                   evicted + extra_evicted, bs)])
        scorer.events_pool.drain()
        rescored = client.ok("POST", "/score_completions", body)
        trace = client.ok("GET", f"/debug/traces/{trace_id}")
        lookups = lookup_counter(client.ok("GET", "/metrics").decode()) - lookups0
        health = client.ok("GET", "/healthz")
    finally:
        client.close()
        server.shutdown()
        server.server_close()
        indexer.shutdown()
    ttft_ms = (t_first - t_post) * 1e3
    round_trip_ms = (t_routed - t_post) * 1e3
    explain = routed["explain"]
    want = dict.fromkeys(names, 0.0)
    want[pod_a.name] = tier_score(n_prefix, 1.0)
    want_after = dict(want, **{pod_a.name: tier_score(len(keys), 1.0)})
    print(f"  request C ({len(tokens)} tokens: phase 5's {len(t['prefix'])}-token prefix and "
          f"{suffix_tokens} new ones) by POST /score_completions?explain=1 with a sampled "
          f"traceparent over one keep-alive connection: scores {scores} -> {pod.name}, equal "
          f"to get_pod_scores in-process: {scores == in_process}; reused {len(cached)} blocks, "
          f"prefill_continue over {len(tokens) - len(cached) * bs} tokens", flush=True)
    print(f"  C's TTFT {ttft_ms:.1f} ms from the POST to the first token: the HTTP round trip "
          f"{round_trip_ms:.2f} ms (the server's scoring {explain['duration_ms']:.2f} ms of it) "
          f"+ the continuation {(t_first - t_routed) * 1e3:.1f} ms; phase 5 routed B "
          f"in-process in {t['route_hit_ms']:.2f} ms (TTFT {t['ttft_hit_ms']:.1f} ms)",
          flush=True)
    print(f"  C decodes {decode_steps} tokens eagerly (decode_step a token, no graph): "
          f"{decode_ms:.2f} ms/step, tokens {generated}; kernel launches {launches}",
          flush=True)
    if scores != in_process or scores != want or pod is not pod_a:
        raise AssertionError(f"5c: C's scores over HTTP {scores}, in-process {in_process}, "
                             f"expected {want} with {pod_a.name} chosen")
    if explain["pods"][pod_a.name]["blocks_matched"] != n_prefix or explain["block_keys"] != len(
            keys):
        raise AssertionError(f"5c: explain {explain['pods']}, {explain['block_keys']} keys")
    if len(cached) != n_prefix or logits.shape != (1, suffix_tokens, cfg.vocab_size) or not (
            bool(logits.isfinite().all()) and finite and rerun_equal):
        raise AssertionError("5c: C's continuation or decode went wrong")
    calls = {name: h["calls"] for name, h in held.items()}
    attention = {k: launches[k] for k in calls}
    if device.type == "cuda" and not (attention == calls == {
            "flash_prefill": layers, "paged_decode": decode_steps * layers} and {
            k: launches[k] for k in layer_expected(1, 1)} == layer_expected(
                layers, 1 + decode_steps)):
        raise AssertionError(f"5c: kernel launches {launches}, calls held {calls}, expected "
                             f"{layers} prefill and {decode_steps * layers} decode, and "
                             f"{layer_expected(layers, 1 + decode_steps)}")
    print(f"  {pod_a.name} published C's {suffix_blocks} new blocks as KV events; C rescored "
          f"over HTTP: {rescored} (+{rescored[pod_a.name] - scores[pod_a.name]} for "
          f"{pod_a.name})", flush=True)
    if rescored != want_after:
        raise AssertionError(f"5c: C's second score {rescored}, expected {want_after} "
                             f"({suffix_blocks} more blocks at the device tier's weight)")
    tree = check_spans(trace["spans"])
    print(f"  GET /debug/traces/{trace_id}: {trace['name']}, spans (parent) {tree}", flush=True)
    requests_made = 3  # two POSTs and the in-process score
    print(f"  /metrics: kvtpu_kvcache_index_lookup_requests_total rose by {lookups:.0f}, the "
          f"{requests_made} scoring requests made; /healthz event_plane "
          f"{sorted(health.get('event_plane', {}))}", flush=True)
    if lookups != requests_made:
        raise AssertionError(f"5c: {lookups} lookups counted, {requests_made} made")
    if "stages" not in health.get("event_plane", {}):
        raise AssertionError(f"5c: /healthz without the event-plane block: {sorted(health)}")
    return {"launches": launches, "scores": scores, "rescored": rescored, "ttft_ms": ttft_ms,
            "http_round_trip_ms": round_trip_ms, "server_scoring_ms": explain["duration_ms"],
            "continuation_ms": (t_first - t_routed) * 1e3, "decode_ms_per_step": decode_ms,
            "in_process_route_hit_ms": t["route_hit_ms"], "spans": tree,
            "lookups": lookups, "decoded": generated, "held": held}


# -------------------------------------------------------------- phase 5d


SERVE_BLOCK = 64  # phase 5d's pool block: a fleet indexed at 64 tokens a block


def serving_block(torch, params, cfg, ref, block_size: int = SERVE_BLOCK) -> dict:
    """Phase 5d: phase 5's requests over a pool of ``block_size``-token
    blocks (the engine's block size is the index's, so a fleet indexed at
    64 serves at 64): A's prompt through ``prefill_paged`` (a miss), B's
    suffix over the prefix A wrote through ``prefill_continue`` (a hit),
    then phase 5's decode inputs at batch 2, replayed from one captured
    graph.  Logits are held to phase 5's within the model-level limit,
    next tokens to phase 5's (a tie within the measured error allowed,
    as phase 5's own check does; ``tokens_equal`` says whether any was
    one).  On CPU params (the tests' small size) the decode steps run
    eagerly and no launch is counted."""
    llama, pool_mod = port("models.llama"), port("models.kv_cache_pool")
    fc, pc = port("ops.flash_cuda"), port("ops.paged_decode_cuda")
    device = params["embed"].device
    cuda = device.type == "cuda"
    bs, layers = block_size, cfg.n_layers
    cfg_b = dataclasses.replace(cfg, block_size=bs)
    prompt_a, prompt_b, inputs = ref["prompt_a"], ref["prompt_b"], ref["decode_inputs"]
    n_suffix = ref["logits_b"].shape[1]
    prefix_len = len(prompt_b) - n_suffix
    if len(prompt_a) % bs or prefix_len % bs or n_suffix % bs or len(inputs) > bs:
        raise AssertionError(f"5d: phase 5's requests do not fall on {bs}-token blocks")
    n_a, n_prefix, n_sfx = len(prompt_a) // bs, prefix_len // bs, n_suffix // bs
    pool = pool_mod.KVCachePool(pool_mod.KVCachePoolConfig(
        layers, n_a + n_sfx + 2, bs, cfg.n_kv_heads, cfg.head_dim, cfg.dtype), device=device)
    ids_a = list(range(n_a))
    ids_b = ids_a[:n_prefix] + list(range(n_a, n_a + n_sfx))
    table = torch.tensor([ids_a + [n_a + n_sfx], ids_b + [n_a + n_sfx + 1]], dtype=torch.int32)
    print(f"  one pool of {n_a + n_sfx + 2} blocks of {bs} tokens: A's {n_a}, B's {n_sfx} "
          f"behind A's first {n_prefix}, one more a sequence for the decode steps", flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fc.flash_gqa_attention_cuda.launches = 0
    pc.paged_decode_attention_cuda.launches = 0
    zero_layer_launches()
    sync()
    t0 = time.perf_counter()
    logits, _ = llama.prefill_paged(params, torch.tensor([prompt_a]), pool.kv,
                                    torch.tensor([ids_a], dtype=torch.int32), cfg_b)
    first_a = int(logits[0, -1].argmax())
    miss_ms = (time.perf_counter() - t0) * 1e3
    miss_tail = logits[:, -ref["miss_tail"].shape[1]:].clone()
    del logits
    sync()
    t0 = time.perf_counter()
    logits_b, _ = llama.prefill_continue(params, torch.tensor([prompt_b[prefix_len:]]), pool.kv,
                                         torch.tensor([ids_b], dtype=torch.int32), prefix_len,
                                         cfg_b)
    first_b = int(logits_b[0, -1].argmax())
    hit_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = fc.flash_gqa_attention_cuda.launches
    prefill_layer = layer_launches()
    errs = {"miss_tail": check_logits(f"5d miss, last {miss_tail.shape[1]} positions, vs phase "
                                      f"5's", miss_tail, ref["miss_tail"]),
            "hit": check_logits("5d hit vs phase 5's", logits_b, ref["logits_b"])}
    gaps = [check_next_token("5d miss next token", first_a, ref["miss_tail"][0, -1],
                             errs["miss_tail"]),
            check_next_token("5d hit next token", first_b, ref["logits_b"][0, -1], errs["hit"])]
    want = [int(ref["miss_tail"][0, -1].argmax()), int(ref["logits_b"][0, -1].argmax())]
    got_tokens = [first_a, first_b]
    bit_equal = [torch.equal(miss_tail, ref["miss_tail"]), torch.equal(logits_b, ref["logits_b"])]
    del miss_tail, logits_b

    if cuda:
        step = llama.make_decode_step(params, pool.kv, cfg_b, 2, table.shape[1])
        step.graph = torch.cuda.CUDAGraph(keep_graph=True)
        step(inputs[0][0], table, inputs[0][1])  # captures; step 1 writes the same K/V again
        step.replays = 0

        def run(tokens, ctx):
            return step(tokens, table, ctx).clone()
    else:
        def run(tokens, ctx):
            return llama.decode_step(params, tokens, pool.kv, table, ctx, cfg_b)[0]
    sync()
    t0 = time.perf_counter()
    steps = [run(tokens, ctx) for tokens, ctx in inputs]
    sync()
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(inputs)
    decode_errs = []
    for i, (logits, want_logits) in enumerate(zip(steps, ref["step_logits"])):
        decode_errs.append(check_logits(f"5d decode step {i + 1} vs phase 5's", logits,
                                        want_logits))
        bit_equal.append(torch.equal(logits, want_logits))
        for row in range(2):
            token = int(logits[row].argmax())
            gaps.append(check_next_token(f"5d decode step {i + 1}, sequence {row}", token,
                                         want_logits[row], decode_errs[-1]))
            got_tokens.append(token)
            want.append(int(want_logits[row].argmax()))
    launches = {"flash_prefill": prefill_launches, "paged_decode": 0, **prefill_layer}
    expected = dict(launches)
    if cuda:
        nodes = captured_kernel_nodes(step.graph, dict(KERNEL_GROUPS)["decode_attention"])
        launches["paged_decode"] = step.replays * nodes
        launches.update(add_counts(prefill_layer, layer_launches(step.graph, step.replays)))
        expected = {"flash_prefill": 2 * layers, "paged_decode": len(inputs) * layers,
                    **layer_expected(layers, 2 + len(inputs))}
    print(f"  miss {miss_ms:.1f} ms, hit {hit_ms:.1f} ms; decode {len(inputs)} steps at batch 2 "
          f"{'from one captured graph' if cuda else 'eager'}, {decode_ms:.2f} ms/step; next "
          f"tokens {got_tokens}, phase 5's {want}: equal {got_tokens == want}; logits bit-equal "
          f"to phase 5's (miss tail, hit, steps): {bit_equal}; kernel launches {launches}, "
          f"expected {expected}", flush=True)
    if launches != expected:
        raise AssertionError(f"5d: launches {launches}, expected {expected}")
    return {"block_size": bs, "launches": launches, "miss_ms": miss_ms, "hit_ms": hit_ms,
            "decode_ms_per_step": decode_ms, "max_abs_err": dict(errs, decode=max(decode_errs)),
            "token_gaps": gaps, "tokens": got_tokens, "tokens_equal": got_tokens == want,
            "bit_equal": bit_equal}


# -------------------------------------------------------------- phase 5e


# The JAX reference's own small configuration, ``__graft_entry__._CFG``
# (``__graft_entry__.py:29-37``): head dim 256 / 8 = 32, a group of 2.
# Its ``entry()`` (``:40-49``) runs ``llama.forward`` on [2, 64] tokens.
GRAFT_CFG = dict(vocab_size=2048, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4, d_ff=704)
GRAFT_TOKENS = (2, 64)
GRAFT_DECODE_STEPS = 4


def graft_config_phase(torch, device: str = "cuda", dtypes=("bfloat16", "float32")) -> dict:
    """Phase 5e: the reference's small configuration on the port, in
    each dtype: ``forward`` on [2, 64] tokens (entry()'s call; the
    prefill kernel on CUDA), then ``prefill_paged`` and
    GRAFT_DECODE_STEPS eager ``decode_step``s (the decode kernel), each
    held within the model-level limit against the dense op,
    ``forward(use_flash=False)`` on the same device, with its next
    tokens (a tie within the measured error allowed)."""
    llama, pool_mod = port("models.llama"), port("models.kv_cache_pool")
    fc, pc = port("ops.flash_cuda"), port("ops.paged_decode_cuda")
    out = {}
    for dtype in dtypes:
        cfg = llama.LlamaConfig(**GRAFT_CFG, dtype=dtype)
        params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(SEED),
                                   device=device)
        B, T = GRAFT_TOKENS
        tokens = torch.randint(1, cfg.vocab_size, (B, T),
                               generator=torch.Generator().manual_seed(SEED)).to(device)
        bs = cfg.block_size
        n = -(-(T + GRAFT_DECODE_STEPS) // bs)
        pool = pool_mod.KVCachePool(pool_mod.KVCachePoolConfig(
            cfg.n_layers, B * n, bs, cfg.n_kv_heads, cfg.head_dim, dtype), device=device)
        table = torch.arange(B * n, dtype=torch.int32).reshape(B, n)
        fc.flash_gqa_attention_cuda.launches = 0
        pc.paged_decode_attention_cuda.launches = 0
        zero_layer_launches()
        with torch.no_grad():
            fwd = llama.forward(params, tokens, cfg)
            dense = llama.forward(params, tokens, cfg, use_flash=False)
            errs = {"forward": check_logits(f"5e {dtype}: forward vs dense", fwd, dense)}
            gaps = [check_next_token(f"5e {dtype}: forward, sequence {b}, next token",
                                     int(fwd[b, -1].argmax()), dense[b, -1], errs["forward"])
                    for b in range(B)]
            forward_launches = fc.flash_gqa_attention_cuda.launches
            forward_layer = layer_launches()  # forward keeps the op-by-op chains: none
            logits, _ = llama.prefill_paged(params, tokens, pool.kv, table[:, :T // bs], cfg)
            errs["prefill_paged"] = check_logits(f"5e {dtype}: prefill_paged vs dense", logits,
                                                 dense)
            seq = tokens
            step_errs = []
            nxt = logits[:, -1].argmax(-1)
            for i in range(GRAFT_DECODE_STEPS):
                seq = torch.cat((seq, nxt[:, None]), 1)
                ctx = torch.full((B,), seq.shape[1], dtype=torch.int32)
                step, _ = llama.decode_step(params, nxt, pool.kv, table, ctx, cfg)
                want = llama.forward(params, seq, cfg, use_flash=False)[:, -1]
                step_errs.append(check_logits(f"5e {dtype}: decode step {i + 1} vs dense", step,
                                              want))
                gaps += [check_next_token(f"5e {dtype}: decode step {i + 1}, sequence {b}",
                                          int(step[b].argmax()), want[b], step_errs[-1])
                         for b in range(B)]
                nxt = step.argmax(-1)
        launches = {"flash_prefill": fc.flash_gqa_attention_cuda.launches,
                    "paged_decode": pc.paged_decode_attention_cuda.launches,
                    **layer_launches()}
        expected = ({"flash_prefill": 2 * cfg.n_layers,
                     "paged_decode": GRAFT_DECODE_STEPS * cfg.n_layers,
                     **layer_expected(cfg.n_layers, 1 + GRAFT_DECODE_STEPS)}
                    if device != "cpu" else dict.fromkeys(launches, 0))
        if any(forward_layer.values()):
            raise AssertionError(f"5e {dtype}: forward launched layer kernels {forward_layer}")
        print(f"  {dtype}: head_dim {cfg.head_dim}, group {cfg.n_heads // cfg.n_kv_heads}; "
              f"forward ({forward_launches} prefill launches, layer kernels {forward_layer}), "
              f"prefill_paged and "
              f"{GRAFT_DECODE_STEPS} decode steps within the limit of the dense op; tokens "
              f"{seq[:, T:].tolist()}; kernel launches {launches}, expected {expected}",
              flush=True)
        if launches != expected:
            raise AssertionError(f"5e {dtype}: launches {launches}, expected {expected}")
        out[dtype] = {"launches": launches,
                      "max_abs_err": dict(errs, decode=max(step_errs)),
                      "token_gaps": gaps, "tokens": seq[:, T:].tolist()}
        del params, pool
    return out


# --------------------------------------------------------------- phase 6


def ring_prefill(torch, params, cfg):
    """One prompt through the ring (both layouts) and the dense forward:
    launch counts, logits against the dense forward, walls, breakdowns."""
    llama = port("models.llama")
    mesh_mod = port("parallel.mesh")
    fc = port("ops.flash_cuda")
    rc = port("ops.ring_flash_cuda")
    sp_mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=1, sp=RING_SP), ["cuda:0"] * RING_SP)
    rng = torch.Generator().manual_seed(SEED + 1)
    tokens = torch.randint(1, cfg.vocab_size, (1, RING_TOKENS), generator=rng)
    runs = {
        "striped": dict(sp_mesh=sp_mesh, ring_striped=True),
        "contiguous": dict(sp_mesh=sp_mesh, ring_striped=False),
        "dense": {},
    }
    layers = cfg.n_layers
    # Striped: each of the sp*sp (rank, step) pairs is a causal band.
    # Contiguous: sp(sp-1)/2 fully visible steps and sp diagonal ones;
    # the sp(sp-1)/2 fully masked steps launch nothing.
    expected = {
        "striped": {"ring_partial": layers * RING_SP**2, "flash_prefill": 0},
        "contiguous": {"ring_partial": layers * RING_SP * (RING_SP + 1) // 2,
                       "flash_prefill": 0},
        "dense": {"ring_partial": 0, "flash_prefill": layers},
    }
    print(f"  mesh {sp_mesh}; prompt of {RING_TOKENS} tokens, {RING_TOKENS // RING_SP} "
          f"per rank", flush=True)
    for kwargs in runs.values():  # warm-up: cuBLAS picks its algorithms
        llama.forward(params, tokens, cfg, **kwargs)
    torch.cuda.synchronize()

    def run(name):
        fc.flash_gqa_attention_cuda.launches = 0
        rc.flash_partial_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = llama.forward(params, tokens, cfg, **runs[name])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = {"ring_partial": rc.flash_partial_cuda.launches,
                    "flash_prefill": fc.flash_gqa_attention_cuda.launches}
        print(f"  {name} forward: {wall:.1f} ms; kernel launches {launches}", flush=True)
        if launches != expected[name]:
            raise AssertionError(f"{name}: launches {launches}, expected {expected[name]}")
        if logits.shape != (1, RING_TOKENS, cfg.vocab_size):
            raise AssertionError(f"{name}: logits shape {tuple(logits.shape)}")
        return logits, wall, launches

    dense, dense_wall, _ = run("dense")
    walls, launches, errs, kept = {"dense": dense_wall}, {}, {}, {}
    first = int(dense[0, -1].argmax())
    for name in ("striped", "contiguous"):
        logits, walls[name], launches[name] = run(name)
        errs[name] = check_logits(f"{name} ring vs dense forward", logits, dense)
        token = int(logits[0, -1].argmax())
        if token != first:
            raise AssertionError(f"{name} ring picks token {token} at the last position, "
                                 f"the dense forward {first}")
        kept[name] = logits  # 4.2 GB of float32 logits, phase 6b's reference
    print(f"  last-position token {first} in all three", flush=True)
    del dense
    torch.cuda.empty_cache()
    breakdown = {
        name: show_breakdown(f"{name} forward under torch.profiler", walls[name],
                             device_breakdown(torch, lambda kw=kw: llama.forward(
                                 params, tokens, cfg, **kw), steps=1))
        for name, kw in runs.items()
    }
    return {
        "launches": launches,
        "wall_ms": walls,
        "max_abs_err_vs_dense": errs,
        "breakdown_ms": breakdown,
        "logits": kept,
        "dense_token": first,
    }


# -------------------------------------------------------------- phase 6b


def spawn_group(torch, target, world: int, args: tuple, timeout: float, wait_all=True):
    """``target(rank, world, store, results, inbox)`` in ``world``
    processes started with the ``spawn`` method, their group's
    ``FileStore`` in a fresh temporary directory; each takes ``args``
    from ``inbox`` (CUDA tensors as IPC handles, which the worker drops
    when its target returns, while its CUDA context still lives) and
    puts its answer on ``results``.  Returns the answers.  A rank that
    reports an error, exits without an answer or (with ``wait_all``)
    gives none in ``timeout`` seconds fails the phase; without
    ``wait_all`` a silent rank's answer is None.  Every process is
    joined, and killed if it is still alive."""
    ctx = torch.multiprocessing.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="kv-group-")
    results, inbox = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=target, daemon=True,
                         args=(rank, world, os.path.join(store_dir, "store"), results, inbox))
             for rank in range(world)]
    got = {}
    try:
        for proc in procs:
            inbox.put(args)
            proc.start()
        deadline = time.monotonic() + timeout
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                if wait_all:
                    raise AssertionError(f"{target.__name__}: no answer from ranks "
                                         f"{sorted(set(range(world)) - set(got))} in {timeout} s")
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)}
                if dead:
                    raise AssertionError(f"{target.__name__}: exit codes {dead}, no answer")
                continue
            if not ok:
                raise AssertionError(f"{target.__name__}, rank {rank} of {world}:\n{value}")
            got[rank] = value
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    return [got.get(rank) for rank in range(world)]


def hold_partials(torch, run, tag: str = "6b") -> dict:
    """``run()`` with every partial launch of this process's ring held,
    as it is made, against the plain version on the same inputs: the
    normalized output within ``LIMITS``, m and l within ``RING_M_ABS``
    and ``RING_L_REL``, empty rows exact (phase 4's checks).  The plain
    version launches no kernel and counts nothing."""
    ra, rf = port("ops.ring_attention"), port("ops.ring_flash")
    wrapper = ra.flash_partial_cuda
    limits = LIMITS["ring", "bfloat16"]
    seen = {"calls": 0, "max_abs_err": 0.0, "worst_err_over_limit": 0.0, "m_max_abs_err": 0.0,
            "l_worst_err_over_limit": 0.0, "exact_empty_rows": True, "finite": True,
            "offsets": {}}

    def held(q, k, v, *, causal_offset=0):
        out = wrapper(q, k, v, causal_offset=causal_offset)
        ref = rf.flash_partial_plain(q, k, v, causal_offset=causal_offset)
        got_n = rf.normalize_partial(out[0], out[2], torch.float32)
        err, worst = err_over_limit(got_n, rf.normalize_partial(ref[0], ref[2], torch.float32),
                                    *limits)
        empty = ref[1] == rf.NEG_INF
        seen["calls"] += 1
        key = str(causal_offset)
        seen["offsets"][key] = seen["offsets"].get(key, 0) + 1
        seen["max_abs_err"] = max(seen["max_abs_err"], err)
        seen["worst_err_over_limit"] = max(seen["worst_err_over_limit"], worst)
        seen["m_max_abs_err"] = max(seen["m_max_abs_err"], float((out[1] - ref[1]).abs().max()))
        seen["l_worst_err_over_limit"] = max(seen["l_worst_err_over_limit"], float(
            ((out[2] - ref[2]).abs() / (RING_L_REL * ref[2].abs())).nan_to_num(0.0).max()))
        seen["exact_empty_rows"] &= bool((out[1][empty] == rf.NEG_INF).all()
                                         and (out[2][empty] == 0).all()
                                         and (out[0][empty] == 0).all())
        seen["finite"] &= bool(got_n.isfinite().all())
        return out

    ra.flash_partial_cuda = held
    try:
        run()
        torch.cuda.synchronize()
    finally:
        ra.flash_partial_cuda = wrapper
    seen["limit"] = limit_text(*limits)
    if not (seen["calls"] and seen["finite"] and seen["worst_err_over_limit"] <= 1.0
            and seen["m_max_abs_err"] <= RING_M_ABS and seen["l_worst_err_over_limit"] <= 1.0
            and seen["exact_empty_rows"]):
        raise AssertionError(f"{tag}: a partial launch disagrees with the plain version: {seen}")
    return seen


def transfer_summary(records) -> dict:
    """Per ring step of one process: the bytes it sent and received,
    the staging copies' device ms (device to pinned host, host to
    device), the host ms from posting the transfer to the end of its
    wait and of the wait alone (the part the step's partials did not
    hide)."""
    steps = len(records)
    total = {k: sum(r[k] for r in records) for k in ("d2h_ms", "h2d_ms", "wait_ms", "span_ms",
                                                    "bytes_out", "bytes_in")}
    return {"steps": steps, **{f"{k}_per_step": v / max(1, steps) for k, v in total.items()},
            "staging_ms": total["d2h_ms"] + total["h2d_ms"], "wait_ms": total["wait_ms"]}


def group_worker(rank, world, store, results, inbox):
    """A worker of a spawned gloo group (phases 6b and 12f), on
    ``cuda:0``, its group on the loopback interface: ``inbox`` gives the
    name of this module's function to run, the group's timeout and the
    function's arguments (the parent's CUDA tensors as IPC handles); it
    runs ``fn(torch, dist, rank, *args)`` and puts the answer on
    ``results``."""
    import torch
    import torch.distributed as dist

    try:
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        torch.cuda.set_device(0)
        name, group_timeout, args = inbox.get()
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=group_timeout))
        try:
            out = globals()[name](torch, dist, rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the parent fails the phase with this traceback
        results.put((rank, False, traceback.format_exc()))


def ring_process_run(torch, dist, rank, params, cfg, tokens, refs, dense_token) -> dict:
    llama, mesh_mod = port("models.llama"), port("parallel.mesh")
    rc, pg = port("ops.ring_flash_cuda"), port("parallel.process_group")
    hybrid = mesh_mod.make_hybrid_mesh(mesh_mod.MeshPlan(dp=1, sp=1),
                                       mesh_mod.MeshPlan(dp=1, sp=RING_SP), devices=["cuda:0"])
    if not hybrid.is_local(hybrid.coord(sp=rank)) or hybrid.size("sp") != RING_SP:
        raise AssertionError(f"rank {rank} does not own sp rank {rank} of {hybrid}")
    transport = pg.transport(hybrid)
    chunk = RING_TOKENS // RING_SP
    out = {"mesh": repr(hybrid), "backend": transport.backend, "layouts": {}}
    for name, striped in (("striped", True), ("contiguous", False)):
        def forward(striped=striped):
            return llama.forward(params, tokens, cfg, sp_mesh=hybrid, ring_striped=striped)

        forward()  # warm-up: cuBLAS picks its algorithms, pinned buffers are made
        torch.cuda.synchronize()
        dist.barrier()
        rc.flash_partial_cuda.launches = 0
        transport.log.clear()
        t0 = time.perf_counter()
        logits = forward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = rc.flash_partial_cuda.launches
        transfers = transfer_summary(transport.log.records())
        local = logits.local(sp=rank)
        ref = refs[name][:, rank::RING_SP] if striped else refs[name][:, rank * chunk:
                                                                      (rank + 1) * chunk]
        row = {"wall_ms": wall, "launches": launches, "transfers": transfers,
               "shape": list(local.shape), "bit_equal": bool(torch.equal(local, ref)),
               "max_abs_err": float((local - ref).abs().max()),
               "finite": bool(local.isfinite().all()),
               "last_token": int(local[0, -1].argmax()) if rank == RING_SP - 1 else None}
        del logits, local, ref
        dist.barrier()
        busy = device_breakdown(torch, forward, steps=1)
        # Device time and wall from the same profiled forward; no clamp:
        # a share below 0 means this process's kernel spans include time
        # the other processes held the time-sliced card.
        row["device_ms"] = busy["device_ms"]
        row["kernels_ms"] = busy["kernels_ms"]
        row["profiled_wall_ms"] = busy["profiled_wall_ms"]
        row["idle_share"] = 1 - busy["device_ms"] / busy["profiled_wall_ms"]
        dist.barrier()
        # One worker holds each of its partial launches against the plain
        # version; the others run the same ring beside it.
        if rank == 0:
            row["held"] = hold_partials(torch, forward)
        else:
            forward()
            torch.cuda.synchronize()
        out["layouts"][name] = row
        dist.barrier()
    if rank == 0:
        # The kernel alone at a rank's shape, in each layout's offsets,
        # timed here while the other workers wait.
        peaks = card_peaks(torch.cuda.get_device_name(0))
        out["kernel_cases"] = [ring_partial_case(torch, peaks, 1, chunk, chunk, cfg.n_heads,
                                                 cfg.n_kv_heads, cfg.head_dim, off,
                                                 torch.bfloat16, True)
                               for off in (0, -1, None)]
    dist.barrier()
    return out


def nccl_probe(rank, world, store, results, inbox):
    """Try an NCCL group of ``world`` ranks on one GPU and report what it
    says (NCCL refuses two ranks on one device)."""
    import torch
    import torch.distributed as dist

    inbox.get()
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
        x = torch.ones(1, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        answer = f"all_reduce returned {float(x)}"
        dist.destroy_process_group()
    except Exception as exc:  # the answer this probe exists to report
        answer = f"{type(exc).__name__}: {' '.join(str(exc).split())[:400]}"
    results.put((rank, True, answer))
    results.close()
    results.join_thread()
    os._exit(0)  # no NCCL teardown after a refused communicator


def ring_across_processes(torch, params, cfg, phase6) -> dict:
    """Phase 6b: phase 6's prompt through ``forward(sp_mesh=hybrid)`` over
    ``RING_SP`` processes, one ring rank each (``make_hybrid_mesh``, dcn
    sp 4), K/V moved through a gloo group: launch counts, logits against
    phase 6's single-controller ring, walls and transfers, each
    worker's device idle share, one worker's partials held; then a try
    at an NCCL group on the one card."""
    refs, dense_token = phase6.pop("logits"), phase6.pop("dense_token")
    rng = torch.Generator().manual_seed(SEED + 1)  # phase 6's prompt
    tokens = torch.randint(1, cfg.vocab_size, (1, RING_TOKENS), generator=rng)
    layers = cfg.n_layers
    t0 = time.perf_counter()
    workers = spawn_group(torch, group_worker, RING_SP,
                          ("ring_process_run", RING_GROUP_TIMEOUT_S,
                           (params, cfg, tokens, refs, dense_token)),
                          timeout=RING_GROUP_TIMEOUT_S + 120)
    torch.cuda.ipc_collect()  # the workers have exited: release what they shared
    print(f"  {RING_SP} processes, one ring rank each on cuda:0 (gloo over loopback, CUDA "
          f"tensors staged through pinned host buffers): {time.perf_counter() - t0:.1f} s with "
          f"spawn, imports and the kernel checks; mesh {workers[0]['mesh']}", flush=True)
    del refs
    out = {"launches": {}, "launches_per_process": {}, "wall_ms": {}, "phase6_wall_ms": {},
           "per_process": {}}
    for name in ("striped", "contiguous"):
        rows = [w["layouts"][name] for w in workers]
        want = [layers * (RING_SP if name == "striped" else rank + 1) for rank in range(RING_SP)]
        got = [row["launches"] for row in rows]
        print(f"  {name}: partial launches a process {got} (expected {want}; phase 6: "
              f"{phase6['launches'][name]['ring_partial']})", flush=True)
        if got != want or sum(got) != phase6["launches"][name]["ring_partial"]:
            raise AssertionError(f"6b {name}: launches {got}, expected {want}")
        if not all(row["finite"] and row["shape"] == [1, RING_TOKENS // RING_SP,
                                                      cfg.vocab_size] for row in rows):
            raise AssertionError(f"6b {name}: a chunk of logits has another shape or is "
                                 "not finite")
        # Each rank runs phase 6's ops in phase 6's merge order, so its
        # logits are the same bits: anything else is a misrouted or stale
        # chunk, not rounding.
        equal = [row["bit_equal"] for row in rows]
        err = max(row["max_abs_err"] for row in rows)
        print(f"  {name}: each process's logits against its rows of phase 6's single-"
              f"controller ring logits: bit-equal per process {equal}, max_abs_err "
              f"{err:.6g}", flush=True)
        if not all(equal):
            raise AssertionError(f"6b {name}: logits not bit-equal to phase 6's in processes "
                                 f"{[r for r, e in enumerate(equal) if not e]}, max_abs_err "
                                 f"{err}")
        token = rows[-1]["last_token"]
        if token != dense_token:
            raise AssertionError(f"6b {name}: last-position token {token}, the dense "
                                 f"forward's {dense_token}")
        walls = [row["wall_ms"] for row in rows]
        t = [row["transfers"] for row in rows]
        print(f"  {name}: wall {max(walls):.1f} ms (slowest process; each {walls}; phase 6 "
              f"single controller {phase6['wall_ms'][name]:.1f} ms); last-position token "
              f"{token} = the dense forward's", flush=True)
        print(f"  {name}, staging copies per ring step (device ms, device->pinned host + "
              f"host->device): " + "; ".join(
                  f"p{r} {x['d2h_ms_per_step']:.3f} + {x['h2d_ms_per_step']:.3f}"
                  for r, x in enumerate(t)), flush=True)
        print(f"  {name}, gloo send/recv per ring step ({t[0]['steps']} steps, "
              f"{t[0]['bytes_out_per_step'] / 2**20:.1f} MiB out and in; host ms, post to end "
              "of wait / wait alone): " + "; ".join(
                  f"p{r} {x['span_ms_per_step']:.2f} / {x['wait_ms_per_step']:.2f}"
                  for r, x in enumerate(t)), flush=True)
        print(f"  {name}, device idle share per process (1 - kernels ms / wall of the same "
              "profiled forward; below 0 where a process's kernel spans include time the "
              "others held the card): " + "; ".join(
                  f"p{r} {row['idle_share']:.3f} ({row['device_ms']:.1f} / "
                  f"{row['profiled_wall_ms']:.1f})" for r, row in enumerate(rows)), flush=True)
        held = rows[0]["held"]
        print(f"  {name}, process 0: {held['calls']} partial launches held against the plain "
              f"version on the same inputs (offsets {held['offsets']}): max_abs_err "
              f"{held['max_abs_err']:.6g}, worst err/limit {held['worst_err_over_limit']:.4g} "
              f"(limit {held['limit']}); m {held['m_max_abs_err']:.3g}, l worst "
              f"{held['l_worst_err_over_limit']:.4g}", flush=True)
        out["launches"][name] = sum(got)
        out["launches_per_process"][name] = got
        out["wall_ms"][name] = max(walls)
        out["phase6_wall_ms"][name] = phase6["wall_ms"][name]
        out["per_process"][name] = [{k: v for k, v in row.items() if k != "held"}
                                    for row in rows]
        out.setdefault("held", {})[name] = held
        out.setdefault("bit_equal", {})[name] = all(equal)
        out.setdefault("max_abs_err_vs_phase6", {})[name] = err
    out["kernel_cases"] = workers[0]["kernel_cases"]
    t0 = time.perf_counter()
    answers = spawn_group(torch, nccl_probe, 2, (), timeout=NCCL_PROBE_S, wait_all=False)
    answers = [a if a is not None else f"no answer in {NCCL_PROBE_S} s" for a in answers]
    print(f"  NCCL, 2 ranks on cuda:0 ({time.perf_counter() - t0:.1f} s): {answers}; the NCCL "
          "path is unchecked on one card", flush=True)
    out["nccl_two_ranks_one_card"] = answers
    return out


# --------------------------------------------------------------- phase 7


def group_file_hashes(keys, blocks_per_file: int):
    """The file hash of each group of ``blocks_per_file`` blocks: the
    chained key of the group's last block, which covers the prefix up to
    it; a partial tail group ends on the last key."""
    return [keys[min(i + blocks_per_file, len(keys)) - 1]
            for i in range(0, len(keys), blocks_per_file)]


def read_tree(root: str) -> dict:
    """{path relative to root: bytes} of every file under ``root``."""
    out = {}
    for folder, _, files in os.walk(root):
        for name in files:
            path = os.path.join(folder, name)
            with open(path, "rb") as handle:
                out[os.path.relpath(path, root)] = handle.read()
    return out


def tree_mismatches(got: dict, want: dict):
    """Files of either tree that the other lacks or holds other bytes of."""
    return sorted(name for name in set(got) | set(want) if got.get(name) != want.get(name))


def rate(nbytes: int, seconds: float, bound_bytes_per_s: float) -> dict:
    """A transfer of ``nbytes`` in ``seconds`` against a rate bound: its
    ms, GB/s, the bound's ms, and the share of the bound it reached."""
    bound_s = nbytes / bound_bytes_per_s
    return {"ms": seconds * 1e3, "gbps": nbytes / seconds / 1e9, "bound_ms": bound_s * 1e3,
            "share_of_bound": bound_s / seconds}


def mount_of(path: str, mounts: str):
    """(mount point, filesystem type, source) of the mount holding
    ``path``, from the text of /proc/mounts: the longest mount point
    that is a prefix of the real path."""
    real = os.path.realpath(path)
    best = ("", "", "")
    for line in mounts.splitlines():
        fields = line.split()
        if len(fields) < 3:
            continue
        point = fields[1].replace("\\040", " ")
        inside = real == point or real.startswith(point.rstrip("/") + "/")
        if inside and len(point) > len(best[0]):
            best = (point, fields[2], fields[0])
    return best


def clear_dir(root: str) -> None:
    """Delete everything under ``root``, keeping ``root``."""
    for name in os.listdir(root):
        path = os.path.join(root, name)
        if os.path.isdir(path) and not os.path.islink(path):
            shutil.rmtree(path)
        else:
            os.unlink(path)


def drop_page_cache(root: str) -> int:
    """Write back and drop the page cache of every file under ``root``
    (``posix_fadvise`` DONTNEED), so the next read comes from the disk;
    returns the number of files."""
    count = 0
    for folder, _, files in os.walk(root):
        for name in files:
            fd = os.open(os.path.join(folder, name), os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)
            count += 1
    return count


def ms_median(rounds, key: str) -> float:
    return statistics.median(r[key] for r in rounds)


def pinned_allocs(torch):
    """(pinned host blocks created so far, microseconds spent creating
    them) from PyTorch's caching host allocator."""
    stats = torch.cuda.host_memory_stats()
    return stats.get("num_host_alloc", 0), stats.get("host_alloc_time.total", 0)


def offload(torch, params, cfg, peaks, served):
    """Store pod-a's 8192-token prefix through the one-shot and the
    staged connector, load it into a third pod three ways (files,
    staged files, host tier), continue request B there, and time it."""
    import numpy as np

    llama = port("models.llama")
    spec_mod = port("offload.spec")
    worker = port("offload.worker")
    from_numpy, to_numpy = port("utils.device").from_numpy, port("utils.device").to_numpy
    succeeded = port("native.engine").JobStatus.SUCCEEDED
    bs = cfg.block_size
    pod_a, prefix_ids = served["pod_a"], served["prefix_ids"]
    n_prefix = len(prefix_ids)
    bpf = OFFLOAD_BLOCK // bs
    idx_a = torch.tensor(prefix_ids, device="cuda")
    suffix = served["prompt_b"][PREFIX_TOKENS:]

    # Phase 5's decode checks wrote into the prefix after B's hit: put
    # back the bytes the hit read, in place.
    kv_a = pod_a.pool.kv
    dirty = int((kv_a[:, idx_a] != served["prefix_kv"]).flatten(2).any(-1).any(0).sum())
    kv_a[:, idx_a] = served["prefix_kv"]
    del served["prefix_kv"]
    nbytes = n_prefix * pod_a.pool.block_nbytes
    print(f"  prefix: {n_prefix} blocks of pod-a ({nbytes / 2**30:.3f} GiB, "
          f"{pod_a.pool.block_nbytes / 2**20:.0f} MiB a block), {dirty} of them rewritten by "
          f"phase 5's decode checks and restored to the hit's bytes", flush=True)

    hashes = group_file_hashes(served["keys_b"][:n_prefix], bpf)
    pod_c = SimPod("pod-c", cfg, POOL_BLOCKS)
    ids_c = list(range(OFFLOAD_TARGET, OFFLOAD_TARGET + n_prefix))
    idx_c = torch.tensor(ids_c, device="cuda")
    suffix_c = list(range(ids_c[-1] + 1, ids_c[-1] + 1 + SUFFIX_TOKENS // bs))
    table_c = torch.tensor([ids_c + suffix_c], dtype=torch.int32)
    roots = {name: tempfile.mkdtemp(prefix=f"kv-offload-{name}-")
             for name in ("one_shot", "staged", "host_tier", "host_tier_staged")}
    with open("/proc/mounts") as handle:
        point, fstype, source = mount_of(roots["one_shot"], handle.read())
    print(f"  files under {os.path.dirname(roots['one_shot'])}: {fstype} mounted at {point} "
          f"({source}); {len(hashes)} files of {bpf} blocks ({OFFLOAD_BLOCK} tokens), "
          f"{OFFLOAD_THREADS} I/O threads", flush=True)
    connectors = []
    kept = False  # the one-shot tree outlives the phase once it succeeded

    def connector(pool, name, lanes, host_bytes=0):
        """A connector over ``pool`` writing under ``roots[name]``, and the
        list its RTT observers fill: (bytes, io s, device s or None)."""
        spec = spec_mod.TPUOffloadSpec(
            shared_storage_path=roots[name], model_name=MODEL_NAME, device_block_size=bs,
            offloaded_block_size=OFFLOAD_BLOCK, threads_per_chip=OFFLOAD_THREADS,
            staging_lanes=lanes, staging_slots=2, host_cache_bytes=host_bytes, dtype=cfg.dtype)
        seen = []
        conn = spec_mod.TPUOffloadConnector(
            spec, pool, rtt_observer=lambda n, io_s: seen.append((n, io_s, None)),
            store_rtt_observer=lambda n, io_s, dev_s: seen.append((n, io_s, dev_s)))
        connectors.append(conn)
        if not conn.engine.is_native:
            raise AssertionError("the connector is not on the native I/O engine")
        if lanes and not conn.staging.uses_pinned:
            raise AssertionError("the staged connector is not on the pinned path")
        return conn, seen

    jobs = iter(range(1, 1 << 30))

    def store(conn):
        job = next(jobs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conn.store_handler.transfer_async(job, worker.group_blocks_per_file(
            hashes, prefix_ids if conn.pool is pod_a.pool else ids_c, bpf))
        status = conn.store_handler.wait(job)
        wall = time.perf_counter() - t0
        if status != succeeded:
            raise AssertionError(f"store job {job}: {status.name}")
        return wall

    try:
        # 1-2. Store through the one-shot and the staged connector.
        stores = {}
        for name, lanes in (("one_shot", 0), ("staged", 2)):
            conn, seen = connector(pod_a.pool, name, lanes)
            rounds = []
            for r in range(OFFLOAD_ROUNDS + 1):
                clear_dir(roots[name])
                before = pinned_allocs(torch)
                wall = store(conn)
                after = pinned_allocs(torch)
                _, io_s, dev_s = seen[-1]
                row = {"wall_ms": wall * 1e3, "device_ms": dev_s * 1e3, "io_ms": io_s * 1e3,
                       "device_gbps": nbytes / dev_s / 1e9, "write_gbps": nbytes / io_s / 1e9,
                       "pinned_host_allocs": after[0] - before[0],
                       "pinned_host_alloc_ms": (after[1] - before[1]) / 1e3}
                rounds.append(row)
                print(f"  store {name} round {r}{' (warm)' if r == 0 else ''}: wall "
                      f"{row['wall_ms']:.1f} ms, device half {row['device_ms']:.1f} ms "
                      f"({row['device_gbps']:.2f} GB/s), file writes {row['io_ms']:.1f} ms "
                      f"({row['write_gbps']:.2f} GB/s); {row['pinned_host_allocs']} new pinned "
                      f"host blocks ({row['pinned_host_alloc_ms']:.1f} ms in cudaHostAlloc)",
                      flush=True)
            stores[name] = {"rounds": rounds, **{
                k: ms_median(rounds[1:], k) for k in ("wall_ms", "device_ms", "io_ms",
                                                      "device_gbps", "write_gbps")}}

        # The two trees, byte for byte, and each file against the pool's
        # bytes read back without the connector.
        trees = {name: read_tree(roots[name]) for name in ("one_shot", "staged")}
        bad = tree_mismatches(trees["one_shot"], trees["staged"])
        expected = to_numpy(kv_a[:, idx_a].movedim(1, 0))
        mapper = connectors[0].file_mapper
        bad_pool = [g for g, h in enumerate(hashes) if trees["one_shot"].get(
            os.path.relpath(mapper.get_file_name(h), roots["one_shot"]))
            != expected[g * bpf:(g + 1) * bpf].tobytes()]
        sizes = {len(v) for v in trees["one_shot"].values()}
        print(f"  stored trees: {len(trees['one_shot'])} and {len(trees['staged'])} files of "
              f"{sorted(sizes)} bytes; differing between the roots: {len(bad)}; files not equal "
              f"to the pool's bytes: {len(bad_pool)}", flush=True)
        if len(trees["one_shot"]) != len(hashes) or bad or bad_pool:
            raise AssertionError(f"stored files: {len(trees['one_shot'])} of {len(hashes)}, "
                                 f"mismatches {bad[:4]}, pool mismatches {bad_pool[:4]}")
        del trees, expected

        # 3. Look up and load into pod-c, then continue B there.
        loaders = {"one_shot": connector(pod_c.pool, "one_shot", 0),
                   "staged": connector(pod_c.pool, "staged", 2)}
        lookups = {name: conn.get_manager().lookup(hashes) for name, (conn, _) in loaders.items()}
        print(f"  pod-c lookup over the {len(hashes)} file hashes: {lookups}", flush=True)
        if set(lookups.values()) != {len(hashes)}:
            raise AssertionError(f"lookup {lookups}, expected {len(hashes)}")
        loaders["one_shot_cold"] = loaders["one_shot"]

        def offload_hit(mode):
            """TTFT of request B on pod-c from its stored prefix: hash the
            prompt, look up the groups, load them, continue, sample."""
            conn, seen = loaders[mode]
            pod_c.pool.kv[:, idx_c] = 0
            if mode == "one_shot_cold":
                drop_page_cache(roots["one_shot"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            keys = served["hasher"].tokens_to_kv_block_keys(
                port("kvcache.kvblock.index").EMPTY_BLOCK_HASH, served["prompt_b"], MODEL_NAME)
            file_hashes = group_file_hashes(keys[:n_prefix], bpf)
            if mode.startswith("host_tier"):
                found = conn.host_cache.lookup_consecutive(file_hashes)
            else:
                found = conn.get_manager().lookup(file_hashes)
            t1 = time.perf_counter()
            job = next(jobs)
            before = len(seen)
            conn.load_handler.transfer_async(job, worker.group_blocks_per_file(
                file_hashes[:found], ids_c[:found * bpf], bpf))
            status = conn.load_handler.wait(job)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            logits, _ = llama.prefill_continue(params, torch.tensor([suffix]), pod_c.pool.kv,
                                               table_c, found * bpf * bs, cfg)
            first = int(logits[0, -1].argmax())
            t3 = time.perf_counter()
            if status != succeeded or found != len(hashes):
                raise AssertionError(f"{mode} load: {status.name}, {found} groups found")
            io_s = seen[-1][1] if len(seen) > before else None
            same = bool(torch.equal(pod_c.pool.kv[:, idx_c], kv_a[:, idx_a]))
            return logits, first, same, {
                "ttft_ms": (t3 - t0) * 1e3, "lookup_ms": (t1 - t0) * 1e3,
                "load_ms": (t2 - t1) * 1e3, "continue_ms": (t3 - t2) * 1e3,
                "io_ms": None if io_s is None else io_s * 1e3,
                "read_gbps": None if io_s is None else nbytes / io_s / 1e9,
                "after_read_ms": None if io_s is None else (t2 - t1 - io_s) * 1e3}

        def run_mode(mode):
            rounds, last = [], None
            for r in range(OFFLOAD_ROUNDS + 1):
                logits, first, same, row = offload_hit(mode)
                print(f"  offload hit, {mode} round {r}{' (warm)' if r == 0 else ''}: TTFT "
                      f"{row['ttft_ms']:.1f} ms = hash+lookup {row['lookup_ms']:.1f} + load "
                      f"{row['load_ms']:.1f}"
                      + ("" if row["io_ms"] is None else
                         f" (file reads {row['io_ms']:.1f} ms, {row['read_gbps']:.2f} GB/s)")
                      + f" + continuation and token {row['continue_ms']:.1f}; pod-c's blocks "
                      f"equal pod-a's: {same}; token {first}", flush=True)
                if not same:
                    raise AssertionError(f"{mode}: pod-c's loaded blocks differ from pod-a's")
                rounds.append(row)
                last = (logits, first)
            keys = ("ttft_ms", "lookup_ms", "load_ms", "continue_ms")
            keys += () if rounds[0]["io_ms"] is None else ("io_ms", "read_gbps", "after_read_ms")
            return last, {"rounds": rounds, **{k: ms_median(rounds[1:], k) for k in keys}}

        loads, finals = {}, {}
        for mode in ("one_shot", "staged", "one_shot_cold"):
            finals[mode], loads[mode] = run_mode(mode)

        # The host tier: a connector over pod-c stores the loaded prefix
        # (filling its 2 GiB tier and writing a third tree), its files
        # are deleted, and the loads read no file.
        tier, tier_seen = connector(pod_c.pool, "host_tier", 0, HOST_TIER_BYTES)
        loaders["host_tier"] = (tier, tier_seen)
        store(tier)
        third = tree_mismatches(read_tree(roots["host_tier"]), read_tree(roots["one_shot"]))
        resident = tier.host_cache.stats()
        clear_dir(roots["host_tier"])
        print(f"  host tier: pod-c's store put {resident['entries']} groups "
              f"({resident['bytes'] / 2**30:.3f} GiB) in the tier; its files differ from "
              f"pod-a's tree in {len(third)}; files deleted before the loads", flush=True)
        if third or resident["entries"] != len(hashes):
            raise AssertionError(f"host tier store: {resident}, {len(third)} files differ")
        finals["host_tier"], loads["host_tier"] = run_mode("host_tier")
        served_from_tier = tier.host_cache.stats()
        if served_from_tier["hits"] != (OFFLOAD_ROUNDS + 1) * len(hashes) or served_from_tier[
                "misses"] or len(tier_seen) != 1:
            raise AssertionError(f"the host-tier loads read files: {served_from_tier}, "
                                 f"{len(tier_seen) - 1} file-read observations")
        # The host-tier load's steps apart, as the one-shot handler runs
        # them at harvest, on the tier's own groups (host clock).
        cached = [tier.host_cache.get(h) for h in hashes]
        steps = []
        for _ in range(OFFLOAD_ROUNDS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            relaid = np.concatenate([np.moveaxis(g, 0, 1) for g in cached], axis=1)
            t1 = time.perf_counter()
            uploaded = from_numpy(relaid, kv_a.dtype).to("cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pod_c.pool.kv[:, idx_c] = uploaded
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            del relaid, uploaded
            t4 = time.perf_counter()
            steps.append({"relayout_ms": (t1 - t0) * 1e3, "upload_ms": (t2 - t1) * 1e3,
                          "index_write_ms": (t3 - t2) * 1e3, "free_ms": (t4 - t3) * 1e3})
        del cached
        tier_steps = {k: ms_median(steps[1:], k) for k in steps[0]}
        print(f"  host-tier load, its steps apart (medians of {OFFLOAD_ROUNDS}): re-layout "
              f"{tier_steps['relayout_ms']:.1f} ms, pageable upload {tier_steps['upload_ms']:.1f} "
              f"ms, indexed write {tier_steps['index_write_ms']:.1f} ms, freeing the host array "
              f"{tier_steps['free_ms']:.1f} ms", flush=True)

        # The staged handler's host-tier side: a staged connector over
        # pod-c with a tier of its own admits each group from its pinned
        # slot as it stores; with its files deleted, its loads read only
        # the tier and scatter each group under the staging engine's lock.
        tier_staged, tier_staged_seen = connector(pod_c.pool, "host_tier_staged", 2,
                                                  HOST_TIER_BYTES)
        loaders["host_tier_staged"] = (tier_staged, tier_staged_seen)
        staged_tier_store_ms = store(tier_staged) * 1e3
        fourth = tree_mismatches(read_tree(roots["host_tier_staged"]), read_tree(roots["one_shot"]))
        admitted = tier_staged.host_cache.stats()
        clear_dir(roots["host_tier_staged"])
        print(f"  host tier, staged connector: its store ({staged_tier_store_ms:.1f} ms, files "
              f"and tier) admitted {admitted['entries']} groups from the pinned slots; its files "
              f"differ from pod-a's tree in {len(fourth)}; files deleted before the loads",
              flush=True)
        if fourth or admitted["entries"] != len(hashes):
            raise AssertionError(f"staged host tier store: {admitted}, {len(fourth)} files differ")
        finals["host_tier_staged"], loads["host_tier_staged"] = run_mode("host_tier_staged")
        tier_hits = tier_staged.host_cache.stats()
        if tier_hits["hits"] != (OFFLOAD_ROUNDS + 1) * len(hashes) or tier_hits[
                "misses"] or len(tier_staged_seen) != 1:
            raise AssertionError(f"the staged host-tier loads read files: {tier_hits}, "
                                 f"{len(tier_staged_seen) - 1} file-read observations")

        # 4. The continuation on pod-c against phase 5's hit on pod-a.
        continuation = {}
        ref = served["logits_b"]
        for mode, (logits, first) in finals.items():
            equal = bool(torch.equal(logits, ref))
            row = {"bit_equal": equal, "token": first}
            if not equal:
                print(f"  {mode}: the continuation is not bit-equal to phase 5's hit (same "
                      f"bytes, other block ids); held to the model-level limit", flush=True)
                row["max_abs_err"] = check_logits(f"{mode} continuation vs phase 5's hit",
                                                  logits, ref)
                row["token_gap"] = check_next_token(f"{mode} next token", first, ref[0, -1],
                                                    row["max_abs_err"])
            continuation[mode] = row
        equal_modes = [m for m, r in continuation.items() if r["bit_equal"]]
        print(f"  continuation of B on pod-c ({len(suffix)} tokens over the loaded prefix) vs "
              f"phase 5's hit on pod-a: bit-equal logits {equal_modes}; "
              f"tokens {sorted({r['token'] for r in continuation.values()})}, phase 5's "
              f"{served['first_b']}", flush=True)
        del finals
        kept = True
    finally:
        for conn in connectors:
            conn.close()
        for name, root in roots.items():
            if not (kept and name == "one_shot"):
                shutil.rmtree(root, ignore_errors=True)

    # 5. The device and link halves apart, on the same 1 GiB.
    def events_ms(fn, iters=3):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def host_ms(fn, iters=3):
        fn()
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    groups_a = [idx_a[i:i + bpf] for i in range(0, n_prefix, bpf)]
    gathered = kv_a[:, idx_a]
    pinned = torch.empty(gathered.shape, dtype=gathered.dtype, pin_memory=True)
    host_lm = to_numpy(gathered)
    probes = {
        "gather_one_shot": rate(2 * nbytes, events_ms(lambda: kv_a[:, idx_a]) / 1e3, peaks[2]),
        "gather_staged": rate(2 * nbytes, events_ms(lambda: [
            kv_a[:, g].movedim(1, 0).contiguous() for g in groups_a]) / 1e3, peaks[2]),
        "d2h_pageable": rate(nbytes, host_ms(lambda: gathered.cpu()) / 1e3, PCIE_GEN5_X16),
        "d2h_pinned": rate(nbytes, events_ms(lambda: pinned.copy_(gathered)) / 1e3,
                           PCIE_GEN5_X16),
        "h2d_pinned": rate(nbytes, events_ms(lambda: gathered.copy_(pinned)) / 1e3,
                           PCIE_GEN5_X16),
        "h2d_pageable": rate(nbytes, host_ms(
            lambda: from_numpy(host_lm, kv_a.dtype).to("cuda")) / 1e3, PCIE_GEN5_X16),
        "upload_and_scatter": rate(nbytes, host_ms(
            lambda: pod_c.pool.scatter_from_host(ids_c, host_lm)) / 1e3, PCIE_GEN5_X16),
    }
    # The host's own share: the one-shot load's re-layout (128 block-major
    # groups into one layer-major array), into fresh and into touched
    # memory, and a first touch of 1 GiB alone (host clock).
    groups_host = [np.ascontiguousarray(np.moveaxis(host_lm[:, i:i + bpf], 1, 0))
                   for i in range(0, n_prefix, bpf)]

    def relayout(out=None):
        return np.concatenate([np.moveaxis(g, 0, 1) for g in groups_host], axis=1, out=out)

    touched = relayout()
    host = {"first_touch_ms": host_ms(lambda: np.ones(nbytes, np.uint8)),
            "relayout_fresh_ms": host_ms(relayout),
            "relayout_touched_ms": host_ms(lambda: relayout(touched))}
    del gathered, pinned, host_lm, groups_host, touched
    for what, row in probes.items():
        bound = ("HBM 3.35 TB/s, read + write" if what.startswith("gather")
                 else "PCIe Gen5 x16, 64 GB/s")
        print(f"  {what}: {row['ms']:.2f} ms, {row['gbps']:.2f} GB/s, bound {row['bound_ms']:.2f} "
              f"ms ({bound}), share of bound {row['share_of_bound']:.3f}", flush=True)
    gib = f"{nbytes / 2**30:.3g} GiB"
    print(f"  host: first touch of {gib} {host['first_touch_ms']:.1f} ms; the one-shot load's "
          f"re-layout of {gib} {host['relayout_fresh_ms']:.1f} ms into fresh memory, "
          f"{host['relayout_touched_ms']:.1f} ms into touched memory", flush=True)
    for name, row in stores.items():
        print(f"  store {name}, medians of {OFFLOAD_ROUNDS}: wall {row['wall_ms']:.1f} ms, device "
              f"half {row['device_ms']:.1f} ms ({row['device_gbps']:.2f} GB/s), file writes "
              f"{row['io_ms']:.1f} ms ({row['write_gbps']:.2f} GB/s)", flush=True)
    for mode, row in loads.items():
        print(f"  offload hit {mode}, medians of {OFFLOAD_ROUNDS}: TTFT {row['ttft_ms']:.1f} ms, "
              f"load {row['load_ms']:.1f} ms"
              + ("" if "io_ms" not in row else f" (file reads {row['io_ms']:.1f} ms, "
                 f"{row['read_gbps']:.2f} GB/s; {row['after_read_ms']:.1f} ms after them)")
              + f", continuation and token {row['continue_ms']:.1f} ms", flush=True)
    print(f"  beside phase 5: TTFT miss {served['ttft_miss_ms']:.1f} ms, local hit "
          f"{served['ttft_hit_ms']:.1f} ms", flush=True)
    return {"bytes": nbytes, "files": len(hashes), "blocks_per_file": bpf,
            "filesystem": {"type": fstype, "mount": point}, "restored_blocks": dirty,
            "lookup": lookups, "store": stores, "offload_hit": loads, "probes": probes,
            "host": host, "host_tier_load_steps": tier_steps,
            "host_tier_staged_store_ms": staged_tier_store_ms,
            "continuation": continuation, "ttft_miss_ms": served["ttft_miss_ms"],
            "ttft_hit_ms": served["ttft_hit_ms"],
            # Phase 7b's: pod-c, the one-shot tree (its to delete) and B's
            # continuation on pod-c.
            "tiering_inputs": dict(pod_c=pod_c, one_shot_root=roots["one_shot"], hashes=hashes,
                                   ids_c=ids_c, table_c=table_c, suffix=suffix, bpf=bpf)}


# -------------------------------------------------------------- phase 7c


# The connector's kv_connector_extra_config: the reference's documented
# settings (offload/vllm_spec.py's docstring), 256 tokens a file.
VLLM_FILE_TOKENS = 256
VLLM_THREADS = 8
VLLM_STAGING_GB = 16.0
VLLM_DECODE_STEPS = 2  # B's decode steps on pod-c after the load, eager


class PoolLayerBackend:
    """The attention backend vLLM would ask about one layer of a
    ``KVCachePool``, ``pool.kv[l]``: the standard layout, K and V inside
    each block."""

    @staticmethod
    def get_kv_cache_shape(num_blocks, block_size, num_kv_heads, head_size):
        return (num_blocks, 2, block_size, num_kv_heads, head_size)


class FlashAttentionBackend:
    """vLLM FlashAttention's split-KV layout, K and V as the two halves."""

    @staticmethod
    def get_kv_cache_shape(num_blocks, block_size, num_kv_heads, head_size):
        return (2, num_blocks, block_size, num_kv_heads, head_size)


def vllm_config(root: str, cfg, file_tokens: int = VLLM_FILE_TOKENS):
    """Duck-typed vLLM config objects (as tests/test_vllm_spec.py shapes
    them) for one pod of ``cfg`` whose offloading connector writes under
    ``root``."""
    return SimpleNamespace(
        cache_config=SimpleNamespace(block_size=cfg.block_size, cache_dtype="auto"),
        model_config=SimpleNamespace(model=MODEL_NAME, dtype=cfg.dtype),
        parallel_config=SimpleNamespace(tensor_parallel_size=1, pipeline_parallel_size=1,
                                        prefill_context_parallel_size=1, rank=0, world_size=1),
        kv_transfer_config=SimpleNamespace(kv_connector_extra_config={
            "shared_storage_path": root, "block_size": file_tokens,
            "threads_per_chip": VLLM_THREADS, "max_staging_memory_gb": VLLM_STAGING_GB}))


class ViewCopies:
    """While on, counts the vLLM connector's per-view copies between the
    card and the host: each ``KVTensorView.read`` of a device tensor is
    one gather and one pageable device-to-host copy, each ``write`` one
    pageable host-to-device copy and one indexed write (host clock of
    each, the copies synchronous).  It may be entered again: the counts
    add up."""

    def __init__(self, view_cls) -> None:
        self.view_cls = view_cls
        self.counts = {"d2h": 0, "h2d": 0}
        self.seconds = {"d2h": 0.0, "h2d": 0.0}

    def __enter__(self):
        self.read, self.write = self.view_cls.read, self.view_cls.write
        copies, read, write = self, self.read, self.write

        def counted(kind, fn):
            def run(view, *args):
                t0 = time.perf_counter()
                out = fn(view, *args)
                if getattr(view.tensor, "is_cuda", False):
                    copies.counts[kind] += 1
                    copies.seconds[kind] += time.perf_counter() - t0
                return out
            return run

        self.view_cls.read = counted("d2h", read)
        self.view_cls.write = counted("h2d", write)
        return self

    def __exit__(self, *exc) -> None:
        self.view_cls.read, self.view_cls.write = self.read, self.write


def walls_ms(seconds: dict) -> dict:
    return {f"{k[:-2]}_ms": v * 1e3 for k, v in seconds.items()}


def vllm_store(spec_mod, config, caches, backend, block_ids, hashes, sync, copies=None,
               spec_cls=None, tag: str = "7c"):
    """Store ``block_ids`` of ``caches`` through a fresh spec of
    ``config`` (one vLLM worker's handlers; ``spec_cls``, by default the
    module's ``TPUSharedStorageOffloadingSpec``), counting the
    transfer's copies in ``copies`` (a ``ViewCopies``); returns the
    spec, its store handler and the walls: the synchronous submit (every
    view's gather and copy) and the file writes after it."""
    spec = (spec_cls or spec_mod.TPUSharedStorageOffloadingSpec)(config, None)
    (_, _, store), _ = spec.get_handlers(caches, {name: backend for name in caches})
    sync()
    with copies or contextlib.nullcontext():
        t0 = time.perf_counter()
        if not store.transfer_async(1, (spec_mod.GPULoadStoreSpec(block_ids),
                                        spec_mod.TPUSharedStorageLoadStoreSpec(hashes))):
            raise AssertionError(f"{tag}: the store was refused by the staging budget")
        t1 = time.perf_counter()
        store.wait({1})
        t2 = time.perf_counter()
    return spec, store, {"submit_s": t1 - t0, "write_s": t2 - t1, "wall_s": t2 - t0}


def vllm_load(spec_mod, config, caches, backend, block_ids, hashes, sync, copies=None,
              spec_cls=None, tag: str = "7c"):
    """Look ``hashes`` up and load them into ``block_ids`` of ``caches``
    through a fresh spec of ``config`` (the loading pod's worker;
    ``spec_cls`` as in :func:`vllm_store`), counting the transfer's
    copies in ``copies``; returns the spec, the lookup and the walls:
    the submit, and the file reads with the scatter that runs at
    harvest."""
    spec = (spec_cls or spec_mod.TPUSharedStorageOffloadingSpec)(config, None)
    _, (_, _, load) = spec.get_handlers(caches, {name: backend for name in caches})
    found = spec.get_manager().lookup(hashes)
    sync()
    with copies or contextlib.nullcontext():
        t0 = time.perf_counter()
        if not load.transfer_async(2, (spec_mod.TPUSharedStorageLoadStoreSpec(hashes),
                                       spec_mod.GPULoadStoreSpec(block_ids))):
            raise AssertionError(f"{tag}: the load was refused by the staging budget")
        t1 = time.perf_counter()
        load.wait({2})
        sync()
        t2 = time.perf_counter()
    return spec, load, found, {"submit_s": t1 - t0, "read_scatter_s": t2 - t1, "wall_s": t2 - t0}


def vllm_offload(torch, params, cfg, t, phase7=None, file_tokens: int = VLLM_FILE_TOKENS):
    """Phase 7c: pod-a's prefix through the port's vLLM ``OffloadingSpec``
    (``offload.vllm_spec``) over the serving pool's own tensors: (i) the
    pool as vLLM's per-layer tensors ``pool.kv[l]``, stored from pod-a
    and loaded into zeroed blocks of pod-c, where B continues on the
    prefill kernel and decodes on the decode kernel, every kernel call
    held against its plain version; (ii) FlashAttention's split-KV
    layout ``[2, N, ...]`` a layer, filled from pod-a's prefix, through
    a round trip; both sets of files byte-equal to each other and to the
    files the spec writes from a host copy of the same tensors.  Runs on
    the pods' device: the card, or the CPU at a small size (the tests)."""
    llama = port("models.llama")
    spec_mod = port("offload.vllm_spec")
    fc, pc = port("ops.flash_cuda"), port("ops.paged_decode_cuda")
    pod_a, pod_c, prefix_ids = t["pod_a"], t["pod_c"], t["prefix_ids"]
    ids_c, table_c = t["ids_c"], t["table_c"]
    kv_a, kv_c = pod_a.pool.kv, pod_c.pool.kv
    device = kv_a.device
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    bs, layers, n_prefix = cfg.block_size, cfg.n_layers, len(prefix_ids)
    bpf = file_tokens // bs
    hashes = group_file_hashes(t["keys_b"][:n_prefix], bpf)
    idx_a, idx_c = torch.tensor(prefix_ids, device=device), torch.tensor(ids_c, device=device)
    nbytes = n_prefix * pod_a.pool.block_nbytes
    names = [f"model.layers.{layer}.self_attn.attn" for layer in range(layers)]
    roots = {name: tempfile.mkdtemp(prefix=f"kv-vllm-{name}-")
             for name in ("pool", "split", "host")}
    configs = {name: vllm_config(root, cfg, file_tokens) for name, root in roots.items()}
    out = {"bytes": nbytes, "files": len(hashes), "blocks_per_file": bpf}
    handlers = []
    try:
        # (i) The serving pool itself: vLLM's per-layer tensors are views
        # of pod-a's and pod-c's pools, so the load writes pod-c's pool.
        kv_c[:, idx_c] = 0
        copies = ViewCopies(spec_mod.KVTensorView)
        spec, store, stored = vllm_store(
            spec_mod, configs["pool"], dict(zip(names, kv_a.unbind(0))), PoolLayerBackend,
            prefix_ids, hashes, sync, copies)
        _, load, found, loaded = vllm_load(
            spec_mod, configs["pool"], dict(zip(names, kv_c.unbind(0))), PoolLayerBackend,
            ids_c, hashes, sync, copies)
        handlers += [store, load]
        same = bool(torch.equal(kv_c[:, idx_c], kv_a[:, idx_a]))
        out["pool"] = {"views": len(store.views), "threads": store.engine.n_threads,
                       "file_buffer_nbytes": spec.file_buffer_nbytes,
                       "staging_budget_bytes": store.budget.max_bytes, "lookup": found,
                       "copies": dict(copies.counts),
                       "copy_ms": {k: v * 1e3 for k, v in copies.seconds.items()},
                       "store": walls_ms(stored), "load": walls_ms(loaded),
                       "store_rate": rate(nbytes, stored["wall_s"], PCIE_GEN5_X16),
                       "load_rate": rate(nbytes, loaded["wall_s"], PCIE_GEN5_X16),
                       "blocks_equal": same}
        row = out["pool"]
        print(f"  (i) the serving pool as vLLM's {row['views']} per-layer tensors pool.kv[l] "
              f"{list(kv_a.shape[1:])} (standard layout): {len(hashes)} files of {bpf} blocks "
              f"({file_tokens} tokens), {spec.file_buffer_nbytes / 2**20:.4g} MiB each; "
              f"{row['threads']} I/O threads (threads_per_chip {VLLM_THREADS}, "
              f"{os.cpu_count()} cores; a file buffer a thread fits the staging budget of "
              f"{VLLM_STAGING_GB:.0f} GB, {row['staging_budget_bytes']} bytes: "
              f"{row['file_buffer_nbytes'] * row['threads'] <= row['staging_budget_bytes']})",
              flush=True)
        print(f"  (i) store from pod-a: wall {row['store']['wall_ms']:.1f} ms = submit (every "
              f"view's gather and pageable copy) {row['store']['submit_ms']:.1f} + file "
              f"writes {row['store']['write_ms']:.1f}; {row['store_rate']['gbps']:.3f} GB/s, "
              f"share of PCIe Gen5 x16 (64 GB/s) {row['store_rate']['share_of_bound']:.4f}",
              flush=True)
        print(f"  (i) load into pod-c's {len(ids_c)} zeroed blocks: manager.lookup found "
              f"{found} of {len(hashes)} files; wall {row['load']['wall_ms']:.1f} ms = submit "
              f"{row['load']['submit_ms']:.1f} + file reads and the per-view scatter "
              f"{row['load']['read_scatter_ms']:.1f}; {row['load_rate']['gbps']:.3f} GB/s, "
              f"share of PCIe {row['load_rate']['share_of_bound']:.4f}; pod-c's blocks equal "
              f"pod-a's: {same}", flush=True)
        print(f"  (i) copies between the card and the host: {row['copies']['d2h']} "
              f"device-to-host ({row['copy_ms']['d2h']:.1f} ms of host clock in them) and "
              f"{row['copies']['h2d']} host-to-device ({row['copy_ms']['h2d']:.1f} ms), each "
              f"of one view's blocks of one file", flush=True)
        if found != len(hashes) or not same:
            raise AssertionError(f"7c: lookup {found} of {len(hashes)}, blocks equal {same}")
        if on_card and row["copies"] != {"d2h": layers * len(hashes),
                                          "h2d": layers * len(hashes)}:
            raise AssertionError(f"7c: copies {row['copies']}, expected {layers * len(hashes)} "
                                 f"each way")

        # B continues on pod-c over the loaded prefix, then decodes; every
        # kernel call held against the plain version on its inputs.
        suffix = t["prompt_b"][n_prefix * bs:]
        held_prefill = HeldCalls(llama, "flash_gqa_attention_cuda",
                                 fc.flash_gqa_attention_plain, "prefill", tag="7c")
        held_decode = HeldCalls(llama, "paged_decode_attention_cuda",
                                pc.paged_decode_attention_plain, "decode", tag="7c")
        fc.flash_gqa_attention_cuda.launches = 0
        pc.paged_decode_attention_cuda.launches = 0
        zero_layer_launches()
        sync()
        t0 = time.perf_counter()
        with held_prefill:
            logits, _ = llama.prefill_continue(params, torch.tensor([suffix]), kv_c, table_c,
                                               n_prefix * bs, cfg)
        first = int(logits[0, -1].argmax())
        sync()
        continue_ms = (time.perf_counter() - t0) * 1e3
        spare = int(table_c.max()) + 1  # a block past B's table, for the decode steps
        table = torch.tensor([table_c[0].tolist() + [spare]], dtype=torch.int32, device=device)
        step_tokens, decoded, step_logits = torch.tensor([first], device=device), [first], []
        with held_decode:
            for step in range(VLLM_DECODE_STEPS):
                ctx = torch.tensor([len(t["prompt_b"]) + step + 1], dtype=torch.int32,
                                   device=device)
                step_logits.append(llama.decode_step(params, step_tokens, kv_c, table, ctx,
                                                     cfg)[0])
                step_tokens = step_logits[-1].argmax(-1)
                decoded.append(int(step_tokens[0]))
        sync()
        launches = {"flash_prefill": fc.flash_gqa_attention_cuda.launches,
                    "paged_decode": pc.paged_decode_attention_cuda.launches,
                    **layer_launches()}
        equal = bool(torch.equal(logits, t["logits_b"]))
        held = {"flash_prefill": held_prefill.hold(
                    "B's continuation on pod-c over the loaded prefix, prefill kernel"),
                "paged_decode": held_decode.hold(
                    f"B's {VLLM_DECODE_STEPS} decode steps on pod-c at batch 1, decode kernel")}
        del held_prefill, held_decode
        print(f"  B continued on pod-c over the loaded prefix ({len(suffix)} tokens, "
              f"{continue_ms:.1f} ms): logits bit-equal to phase 5's hit on pod-a: {equal}; "
              f"token {first}, phase 5's {t['first_b']}; decoded {decoded}; kernel launches "
              f"{launches}", flush=True)
        if not equal or first != t["first_b"]:
            raise AssertionError("7c: B's continuation on pod-c is not bit-equal to phase 5's "
                                 "hit")
        if not all(bool(x.isfinite().all()) for x in step_logits):
            raise AssertionError("7c: B's decode logits on pod-c are not finite")
        if t.get("decode_b1") is not None:
            out["decode_step1_max_abs_err"] = check_logits(
                "B's decode step 1 on pod-c (batch 1, eager) vs phase 5's (batch 2, captured)",
                step_logits[0], t["decode_b1"])
        calls = {name: h["calls"] for name, h in held.items()}
        want_layer = layer_expected(layers, 1 + VLLM_DECODE_STEPS)
        if on_card and not ({k: launches[k] for k in calls} == calls == {
                "flash_prefill": layers, "paged_decode": VLLM_DECODE_STEPS * layers}
                and {k: launches[k] for k in want_layer} == want_layer):
            raise AssertionError(f"7c: kernel launches {launches}, calls held {calls}, expected "
                                 f"{layers} prefill and {VLLM_DECODE_STEPS * layers} decode, "
                                 f"and {want_layer}")
        out.update(launches=launches, held=held, continuation_bit_equal=equal,
                   continue_ms=continue_ms, decoded=decoded)
        del logits, step_logits

        # (ii) FlashAttention's split-KV layout, [2, N, bs, Hkv, D] a layer.
        split = {}
        for name, layer in zip(names, range(layers)):
            split[name] = torch.stack([kv_a[layer, idx_a, 0], kv_a[layer, idx_a, 1]])
        want = {name: tensor.clone() for name, tensor in split.items()}
        block_ids = list(range(n_prefix))
        copies = ViewCopies(spec_mod.KVTensorView)
        _, store_ii, stored_ii = vllm_store(
            spec_mod, configs["split"], split, FlashAttentionBackend, block_ids, hashes, sync,
            copies)
        for tensor in split.values():
            tensor.zero_()
        _, load_ii, found_ii, loaded_ii = vllm_load(
            spec_mod, configs["split"], split, FlashAttentionBackend, block_ids, hashes, sync,
            copies)
        handlers += [store_ii, load_ii]
        same_ii = all(torch.equal(split[name], want[name]) for name in names)
        del split, want
        out["split"] = {"views": len(store_ii.views), "lookup": found_ii,
                        "copies": dict(copies.counts),
                        "store": walls_ms(stored_ii), "load": walls_ms(loaded_ii),
                        "store_rate": rate(nbytes, stored_ii["wall_s"], PCIE_GEN5_X16),
                        "load_rate": rate(nbytes, loaded_ii["wall_s"], PCIE_GEN5_X16),
                        "blocks_equal": same_ii}
        row = out["split"]
        print(f"  (ii) FlashAttention's split-KV layout, {layers} tensors "
              f"[2, {n_prefix}, {bs}, {cfg.n_kv_heads}, {cfg.head_dim}] on {device} filled from "
              f"pod-a's prefix ({row['views']} views): store {row['store']['wall_ms']:.1f} ms "
              f"({row['store_rate']['gbps']:.3f} GB/s), load {row['load']['wall_ms']:.1f} ms "
              f"({row['load_rate']['gbps']:.3f} GB/s); copies {row['copies']}; lookup "
              f"{found_ii}; the tensors after the round trip equal before it: {same_ii}",
              flush=True)
        if found_ii != len(hashes) or not same_ii:
            raise AssertionError(f"7c: split-KV round trip: lookup {found_ii}, equal {same_ii}")
        if on_card and row["copies"] != {"d2h": 2 * layers * len(hashes),
                                          "h2d": 2 * layers * len(hashes)}:
            raise AssertionError(f"7c: split-KV copies {row['copies']}, expected "
                                 f"{2 * layers * len(hashes)} each way")

        # The same tensors from a host copy, through the same spec.
        host = {name: kv_a[layer, idx_a].cpu() for layer, name in enumerate(names)}
        _, store_host, _ = vllm_store(spec_mod, configs["host"], host, PoolLayerBackend,
                                      block_ids, hashes, sync)
        handlers.append(store_host)
        del host
        trees = {name: read_tree(root) for name, root in roots.items()}
        sizes = sorted({len(v) for v in trees["pool"].values()})
        mismatched = {"split": tree_mismatches(trees["split"], trees["pool"]),
                      "host": tree_mismatches(trees["host"], trees["pool"])}
        out["files_equal"] = {k: not v for k, v in mismatched.items()}
        print(f"  files: {len(trees['pool'])} of {sizes} bytes from (i); (ii)'s differ from "
              f"them in {len(mismatched['split'])} (per block, layer by layer, K then V in "
              f"both); those written from a host copy of the same tensors differ in "
              f"{len(mismatched['host'])}", flush=True)
        if len(trees["pool"]) != len(hashes) or any(mismatched.values()) or sizes != [
                bpf * pod_a.pool.block_nbytes]:
            raise AssertionError(f"7c: files {len(trees['pool'])} of {sizes} bytes, mismatches "
                                 f"{ {k: v[:2] for k, v in mismatched.items()} }")
        del trees
    finally:
        for handler in handlers:
            handler.engine.close()
        for root in roots.values():
            shutil.rmtree(root, ignore_errors=True)
    if phase7 is not None:
        print(f"  beside phase 7's connector over the same 1 GiB (medians): store one-shot "
              f"{phase7['store']['one_shot']['wall_ms']:.1f} ms, staged "
              f"{phase7['store']['staged']['wall_ms']:.1f} ms; load one-shot "
              f"{phase7['offload_hit']['one_shot']['load_ms']:.1f} ms, staged "
              f"{phase7['offload_hit']['staged']['load_ms']:.1f} ms; pinned d2h "
              f"{phase7['probes']['d2h_pinned']['gbps']:.2f} GB/s, pageable d2h "
              f"{phase7['probes']['d2h_pageable']['gbps']:.2f} GB/s", flush=True)
    return out



# --------------------------------------------------------------- phase 7b


FEED_SCORES = 3  # B scored this many times before the demotion cycles
DEMOTE_HOST_IDLE_S = 30.0
DEMOTE_STORAGE_IDLE_S = 120.0
GROUPS_IDLE_S = 600.0  # the prefix groups' age at registration
COLD_POD = "pod-d"
WARMUP_CYCLES = 16
TIERING_SERIES = ("offload_jobs", "offload_bytes", "tiering_demotions", "tiering_demotion_bytes",
                  "tiering_advice", "tiering_evictions", "transfer_plans", "transfer_executions",
                  "transfer_bytes", "transfer_warmup_moves", "transfer_cold_pods")


class TimedPool:
    """A pool as the demotion target sees it, with the seconds its
    device gathers took (one gather and copy to the host a group)."""

    def __init__(self, pool) -> None:
        self.pool = pool
        self.block_nbytes = pool.block_nbytes
        self.gather_s = 0.0

    def gather_block_major(self, block_ids):
        t0 = time.perf_counter()
        out = self.pool.gather_block_major(block_ids)
        self.gather_s += time.perf_counter() - t0
        return out


class TimedCache:
    """A host tier whose admissions (``put``) are timed."""

    def __init__(self, cache) -> None:
        self.cache = cache
        self.put_s = 0.0

    def put(self, key, group) -> bool:
        t0 = time.perf_counter()
        ok = self.cache.put(key, group)
        self.put_s += time.perf_counter() - t0
        return ok

    def __getattr__(self, name):
        return getattr(self.cache, name)


def register_prefix_groups(target, pod, keys, tokens, file_hashes, block_ids, bpf: int,
                           bs: int, family, now: float) -> int:
    """Register a pod's prefix as groups of ``bpf`` blocks, each keyed by
    its file hash, with the engine hashes the pod published for them
    (chained to the group before it) and the group's tokens."""
    for g, group_key in enumerate(file_hashes):
        lo, hi = g * bpf, min((g + 1) * bpf, len(block_ids))
        target.register_pool_group(
            group_key, block_ids=block_ids[lo:hi],
            engine_hashes=[pod.events.engine[k] for k in keys[lo:hi]],
            token_ids=tokens[lo * bs:hi * bs], block_size=bs,
            parent_hash=pod.events.engine[keys[lo - 1]] if lo else None,
            family=family, now=now)
    return len(file_hashes)


def demotion_rung(worker, now: float, events_pool, pool: TimedPool, cache: TimedCache,
                  writes: list) -> dict:
    """One demotion cycle at ``now`` and the event pool drained after
    it: moves, and the wall split into device gathers, host admissions,
    file writes (the store observations of this cycle), the event lag
    (the cycle's end to its events applied) and the rest."""
    gather0, put0, writes0 = pool.gather_s, cache.put_s, len(writes)
    t0 = time.perf_counter()
    moves = worker.run_cycle(now=now)
    t1 = time.perf_counter()
    events_pool.drain()
    t2 = time.perf_counter()
    row = {"moves": moves, "wall_ms": (t2 - t0) * 1e3,
           "gather_ms": (pool.gather_s - gather0) * 1e3,
           "admit_ms": (cache.put_s - put0) * 1e3,
           "write_ms": sum(s for _, s in writes[writes0:]) * 1e3,
           "event_lag_ms": (t2 - t1) * 1e3}
    row["other_ms"] = row["wall_ms"] - sum(row[k] for k in (
        "gather_ms", "admit_ms", "write_ms", "event_lag_ms"))
    return row


def series_totals(metrics, names=TIERING_SERIES) -> dict:
    """{series{labels}: value} of the registry's tiering, transfer and
    offload series."""
    out = {}
    for name in names:
        for family in getattr(metrics, name).collect():
            for sample in family.samples:
                labels = ",".join(f"{k}={v}" for k, v in sorted(sample.labels.items()))
                out[f"{sample.name}{{{labels}}}" if labels else sample.name] = sample.value
    return out


def tiering_transfer(torch, params, cfg, t):
    """Phase 7b: predictive tiering and KV transfer over phase 5's
    Indexer and event pool and phase 7's pods and one-shot tree.  (a) a
    PolicyEngine learns B's family from scored requests; (b) a demotion
    cycle gathers pod-a's prefix groups into a host tier, (c) the next
    writes them to files, each rung's events moving pod-a's score; (d) a
    connector over pod-c with the engine attached loads them (the
    advisor's load and store observations) and the advisor prices B's
    prefix; (e) a TransferEngine plans B from overloaded pod-a to pod-c,
    pod-c loads the bytes, the plan executes, B routes to pod-c and
    continues there; (f) a cold pod warms up.  Runs on the pods' device:
    the card, or the CPU at a small size (the tests)."""
    llama = port("models.llama")
    tiering, transfer = port("tiering"), port("transfer")
    spec_mod, worker_mod = port("offload.spec"), port("offload.worker")
    metrics = port("metrics.collector").METRICS
    fc = port("ops.flash_cuda")
    succeeded = port("native.engine").JobStatus.SUCCEEDED
    indexer, events_pool = t["indexer"], t["scorer"].events_pool
    pod_a, pod_b = t["pods"][0], t["pods"][1]
    pod_c, hashes, bpf = t["pod_c"], t["hashes"], t["bpf"]
    on_card = pod_a.pool.kv.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    bs = cfg.block_size
    prefix_ids = t["prefix_ids"]
    keys = t["keys_b"][:len(prefix_ids)]
    prefix_tokens = len(prefix_ids) * bs
    prompt = words(t["prompt_b"])
    names = [pod_a.name, pod_b.name]
    served, _ = store_served_tokens(prompt, words(t["prompt_a"]))
    # The blocks a router score of B counts: those of the tokens the
    # prefix store serves (phase 5), inside the prefix pod-a holds.
    scored = min(len(served) // bs, len(prefix_ids))
    totals0 = series_totals(metrics)
    fc.flash_gqa_attention_cuda.launches = 0
    zero_layer_launches()

    # (a) Feed: every request sampled; B's family learned from scoring.
    ledger = indexer.cache_stats
    ledger.config.sample_rate = 1.0
    engine = tiering.PolicyEngine(ledger=ledger, config=tiering.TieringConfig(
        refresh_s=0.0, advisor=tiering.AdvisorConfig(block_tokens=bs),
        demotion=tiering.DemotionConfig(demote_host_idle_s=DEMOTE_HOST_IDLE_S,
                                        demote_storage_idle_s=DEMOTE_STORAGE_IDLE_S,
                                        max_moves_per_cycle=len(hashes))))
    indexer.set_policy_engine(engine)
    for _ in range(FEED_SCORES):
        scores = indexer.get_pod_scores(prompt, MODEL_NAME, names)
    family = ledger.family_key(keys, len(keys))
    prediction = engine.feed.prediction(family)
    print(f"  (a) feed: B scored {FEED_SCORES} times through the Indexer with a PolicyEngine "
          f"attached; B's family {family:016x}: {prediction}; pod-a's score "
          f"{scores[pod_a.name]} over the {scored} blocks the prefix store serves", flush=True)
    if prediction is None or scores != {pod_a.name: tier_score(scored, 1.0), pod_b.name: 0.0}:
        raise AssertionError(f"feed: prediction {prediction}, scores {scores}")

    root = tempfile.mkdtemp(prefix="kv-tiering-")
    transfers = None
    conn = spec_mod.TPUOffloadConnector(spec_mod.TPUOffloadSpec(
        shared_storage_path=root, model_name=MODEL_NAME, device_block_size=bs,
        offloaded_block_size=bpf * bs, threads_per_chip=OFFLOAD_THREADS, staging_lanes=2,
        staging_slots=2, dtype=cfg.dtype), pod_c.pool, policy_engine=engine)
    try:
        if not conn.engine.is_native:
            raise AssertionError("the connector is not on the native I/O engine")
        if on_card and not conn.staging.uses_pinned:
            raise AssertionError("the staged connector is not on the pinned path")
        tree7 = read_tree(t["one_shot_root"])
        rel = {h: os.path.relpath(conn.file_mapper.get_file_name(h), root) for h in hashes}

        # (b) hbm -> host: the target gathers pod-a's groups into its host
        # tier; its events reach the index as pod-a's, through the pool.
        timed_pool = TimedPool(pod_a.pool)
        cache = TimedCache(port("offload.host_tier").HostTierCache(
            HOST_TIER_BYTES, eviction_policy=engine.eviction_policy("host_tier")))
        writes = []

        def observe_store(nbytes, seconds, device_s):
            writes.append((nbytes, seconds))
            engine.advisor.observe_store(nbytes, seconds, device_s)

        target = tiering.StagedDemotionTarget(
            capacity_bytes=pod_a.pool_blocks * pod_a.pool.block_nbytes, pool=timed_pool,
            file_mapper=conn.file_mapper, host_cache=cache,
            event_sink=tiering.pool_event_sink(events_pool, pod_a.name, MODEL_NAME),
            feed=engine.feed, store_rtt_observer=observe_store, device_medium=DEVICE_MEDIUM)
        now = time.monotonic()
        register_prefix_groups(target, pod_a, keys, t["prompt_b"], hashes, prefix_ids, bpf, bs,
                               family, now - GROUPS_IDLE_S)
        worker = engine.start_demotion(target, start=False)
        rungs = {}
        rungs["hbm_to_host"] = demotion_rung(worker, now, events_pool, timed_pool, cache, writes)
        off_host = [h for h in hashes if cache.get(h) is None
                    or cache.get(h).tobytes() != tree7[rel[h]]]
        scores = indexer.get_pod_scores(prompt, MODEL_NAME, names)
        row = rungs["hbm_to_host"]
        print(f"  (b) hbm -> host: {row['moves']} groups of {bpf} blocks in one cycle, wall "
              f"{row['wall_ms']:.1f} ms = gathers {row['gather_ms']:.1f} + host admissions "
              f"{row['admit_ms']:.1f} + event lag {row['event_lag_ms']:.1f} + other "
              f"{row['other_ms']:.1f}; host-tier groups not equal to phase 7's files: "
              f"{len(off_host)}; tiers {target.tiers()}; pod-a's score {scores[pod_a.name]}",
              flush=True)
        if (row["moves"] != len(hashes) or off_host
                or scores[pod_a.name] != tier_score(scored, 0.8)):
            raise AssertionError(f"hbm -> host: {row['moves']} moves, {len(off_host)} groups "
                                 f"off, scores {scores}")

        # (c) host -> shared storage, at a later now.
        rungs["host_to_storage"] = demotion_rung(worker, now + DEMOTE_STORAGE_IDLE_S,
                                                 events_pool, timed_pool, cache, writes)
        tree = read_tree(root)
        bad = tree_mismatches(tree, tree7)
        left = cache.stats()
        scores = indexer.get_pod_scores(prompt, MODEL_NAME, names)
        row = rungs["host_to_storage"]
        print(f"  (c) host -> shared storage: {row['moves']} groups, wall {row['wall_ms']:.1f} "
              f"ms = file writes {row['write_ms']:.1f} ({len(tree)} files, "
              f"{sum(map(len, tree.values())) / row['write_ms'] / 1e6:.2f} GB/s) + event lag "
              f"{row['event_lag_ms']:.1f} + other {row['other_ms']:.1f}; files differing from "
              f"phase 7's one-shot tree: {len(bad)}; host tier left {left['entries']} groups, "
              f"{left['bytes']} bytes; pod-a's score {scores[pod_a.name]}", flush=True)
        if (row["moves"] != len(hashes) or bad or len(tree) != len(hashes) or left["entries"]
                or scores[pod_a.name] != tier_score(scored, 0.5)):
            raise AssertionError(f"host -> storage: {row['moves']} moves, {len(bad)} files "
                                 f"differ, host tier {left}, scores {scores}")
        del tree, tree7

        # (d) Compute or load: pod-c loads the demoted files through the
        # connector whose observers are the advisor's own.
        jobs = iter(range(1, 1 << 30))
        idx_c = torch.tensor(t["ids_c"], device=pod_c.pool.kv.device)
        idx_a = torch.tensor(prefix_ids, device=pod_a.pool.kv.device)

        def load_prefix():
            pod_c.pool.kv[:, idx_c] = 0
            sync()
            t0 = time.perf_counter()
            job = next(jobs)
            conn.load_handler.transfer_async(job, worker_mod.group_blocks_per_file(
                hashes, t["ids_c"], bpf))
            status = conn.load_handler.wait(job)
            sync()
            wall = time.perf_counter() - t0
            same = bool(torch.equal(pod_c.pool.kv[:, idx_c], pod_a.pool.kv[:, idx_a]))
            if status != succeeded or not same:
                raise AssertionError(f"load into pod-c: {status.name}, bytes equal: {same}")
            return wall

        load_ms = load_prefix() * 1e3
        prefill_s = (t["ttft_miss_ms"] - t["route_miss_ms"]) / 1e3
        engine.advisor.observe_prefill(len(t["prompt_a"]), prefill_s)
        stats = engine.advisor.stats()
        advice = {tier: engine.advisor.advise(len(prefix_ids), tier).to_dict()
                  for tier in ("host", "shared_storage")}
        print(f"  (d) pod-c loaded the {len(hashes)} demoted files through a connector with "
              f"the PolicyEngine attached in {load_ms:.1f} ms (bytes equal pod-a's); the "
              f"advisor saw {stats['rtt']['observations']} load(s) and "
              f"{stats['rtt_store']['observations']} store(s), bytes_per_block "
              f"{stats['bytes_per_block']}, prefill {stats['prefill_tokens_per_s']} tokens/s "
              f"(phase 5's miss: {len(t['prompt_a'])} tokens in {prefill_s * 1e3:.1f} ms)",
              flush=True)
        for tier, view in advice.items():
            print(f"      advise({len(prefix_ids)}, {tier}): {view['action']}, load_s "
                  f"{view['load_s']}, recompute_s {view['recompute_s']}, hybrid_s "
                  f"{view['hybrid_s']}, load_blocks {view['load_blocks']} ({view['reason']})",
                  flush=True)
        if (stats["rtt"]["observations"] != 1 or stats["rtt_store"]["observations"]
                != len(writes) or len(writes) != len(hashes)
                or stats["bytes_per_block"] != pod_a.pool.block_nbytes
                or any(v["load_s"] is None or v["recompute_s"] is None
                       for v in advice.values())):
            raise AssertionError(f"advisor: {stats}, {len(writes)} writes, advice {advice}")

        # (e) Transfer: pod-a is overloaded, pod-b busy, pod-c idle.
        transfers = transfer.TransferEngine(advisor=engine.advisor, ledger=ledger,
                                            config=transfer.TransferConfig())
        indexer.set_transfer_engine(transfers)
        transfers.attach_executor(indexer.kv_block_index, events_pool, MODEL_NAME,
                                  start_warmup=False, device_medium=DEVICE_MEDIUM)
        threshold = transfers.config.load_threshold
        loads = {pod_a.name: 2 * threshold, pod_b.name: threshold / 2, pod_c.name: 0.0}
        candidates = names + [pod_c.name]
        t0 = time.perf_counter()
        _, directive = indexer.get_pod_scores_planned(prompt, MODEL_NAME, candidates,
                                                      pod_loads=loads)
        t1 = time.perf_counter()
        if directive is None or directive["outcome"] not in ("planned", "recompute-cheaper"):
            raise AssertionError(f"transfer planning: {directive}")
        # The directive without its block keys (the chain's, one a block).
        directive = {k: v for k, v in directive.items() if k != "block_keys"}
        print(f"  (e) get_pod_scores_planned(B, pod_loads={loads}): {directive}; the planner's "
              f"prices for the chain: {transfers.planner.price(scored)}", flush=True)
        if directive["planned"]:
            plan = transfers.planner.get(directive["plan_id"])
            how = via = "the priced directive"
        else:
            # Recompute priced cheaper: the copy is the one a warm-up
            # pre-placement makes (no price gate), from the catalog's
            # record of B's family, which the planned call just noted.
            record = transfers.catalog.get(family)
            plan = transfers.planner.plan_warmup(
                source_pod=record.holder_pod, target_pod=pod_c.name,
                block_keys=record.block_keys, engine_hashes=record.engine_hashes,
                token_ids=record.token_ids, block_size=record.block_size, tier=record.tier)
            how = "a warm-up pre-placement plan (the price said recompute: no priced directive)"
            via = "the pre-placement"
        if (plan.source_pod, plan.target_pod, plan.blocks) != (pod_a.name, pod_c.name, scored):
            raise AssertionError(f"plan {plan.to_dict()}")
        t2 = time.perf_counter()
        load_prefix()  # the bytes first: the index never names a pod without them
        t3 = time.perf_counter()
        executed = transfers.executor.execute(plan)
        events_pool.drain()
        t4 = time.perf_counter()
        scores = indexer.get_pod_scores(prompt, MODEL_NAME, candidates)
        routed = max(sorted(scores), key=scores.get)
        t5 = time.perf_counter()
        logits, _ = llama.prefill_continue(params, torch.tensor([t["suffix"]]), pod_c.pool.kv,
                                           t["table_c"], prefix_tokens, cfg)
        first = int(logits[0, -1].argmax())
        t6 = time.perf_counter()
        launches = fc.flash_gqa_attention_cuda.launches
        layer = layer_launches()
        split = {"plan_ms": (t1 - t0) * 1e3, "load_ms": (t3 - t2) * 1e3,
                 "execute_ms": (t4 - t3) * 1e3, "route_ms": (t5 - t4) * 1e3,
                 "continue_ms": (t6 - t5) * 1e3}
        ttft_ms = sum(split.values())
        print(f"      executed {how} {plan.plan_id} ({plan.blocks} blocks, "
              f"{plan.nbytes / 2**30:.3f} GiB, tier {plan.tier}): {executed}; scores {scores} "
              f"-> {routed}; pod-c's TTFT via {via} {ttft_ms:.1f} ms = plan "
              f"{split['plan_ms']:.1f} + load {split['load_ms']:.1f} + execute and apply "
              f"{split['execute_ms']:.1f} + route {split['route_ms']:.1f} + continuation and "
              f"token {split['continue_ms']:.1f}; prefill kernel launches {launches}", flush=True)
        if not executed or routed != pod_c.name or scores[pod_c.name] != tier_score(scored, 1.0):
            raise AssertionError(f"transfer: executed {executed}, scores {scores}")
        if on_card and (launches != cfg.n_layers or layer != layer_expected(cfg.n_layers, 1)):
            raise AssertionError(f"pod-c's continuation launched the prefill kernel {launches} "
                                 f"times, expected {cfg.n_layers}, and the layer kernels "
                                 f"{layer}, expected {layer_expected(cfg.n_layers, 1)}")
        err = check_logits("pod-c's continuation via the transfer vs phase 5's hit", logits,
                           t["logits_b"])
        gap = check_next_token("pod-c's next token", first, t["logits_b"][0, -1], err)
        del logits

        # (f) Warm-up: a cold pod registers and the worker drains its queue.
        moves0 = metrics.transfer_warmup_moves.collect()[0].samples[0].value
        queued = transfers.register_cold_pod(COLD_POD)
        moved, cycles = 0, 0
        while transfers.warmup.status()["cold_pods"] and cycles < WARMUP_CYCLES:
            moved += transfers.run_warmup_cycle()
            cycles += 1
        events_pool.drain()
        counted = metrics.transfer_warmup_moves.collect()[0].samples[0].value - moves0
        warm = indexer.get_pod_scores(prompt, MODEL_NAME, candidates + [COLD_POD])
        print(f"  (f) warm-up: {COLD_POD} registered cold, {queued} plans queued, {moved} moves "
              f"in {cycles} cycles (transfer_warmup_moves_total +{counted:g}); its score "
              f"{warm[COLD_POD]}; status {transfers.warmup.status()['cold_pods']}", flush=True)
        if (transfers.warmup.status()["cold_pods"] or not moved or counted != moved
                or warm[COLD_POD] <= 0.0):
            raise AssertionError(f"warm-up: {moved} moves, counter +{counted}, scores {warm}")
    finally:
        conn.close()
        engine.close()
        if transfers is not None:
            transfers.close()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(t["one_shot_root"], ignore_errors=True)
    totals = series_totals(metrics)
    moved_series = {k: v - totals0.get(k, 0.0) for k, v in totals.items()
                    if v != totals0.get(k, 0.0)}
    print(f"  registry, this phase: {moved_series}", flush=True)
    return {"launches": {"flash_prefill": launches, **layer}, "scored_blocks": scored,
            "family_prediction": None if prediction is None else dataclasses.asdict(prediction),
            "rungs": rungs, "load_ms": load_ms, "advice": advice,
            "advisor": engine.advisor.stats(), "directive": directive, "executed_plan": how,
            "transfer_ttft_ms": ttft_ms, "transfer_split_ms": split, "routed": routed,
            "continuation_max_abs_err": err, "continuation_token_gap": gap,
            "warmup": {"queued": queued, "moves": moved, "cycles": cycles},
            "series": moved_series}



# --------------------------------------------------------------- phases 8-11


def leaf_paths(tree, prefix=""):
    """(path, leaf) of every leaf of a nested state, dicts and lists
    walked in order: "params.layers.wq", "opt.param_groups.0.lr"."""
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        yield prefix, tree
        return
    for key, value in items:
        yield from leaf_paths(value, f"{prefix}.{key}" if prefix else str(key))


def map_state(torch, state, fn):
    """A nested state of the same structure with ``fn`` applied to each
    tensor and every other leaf copied."""
    if isinstance(state, dict):
        return {key: map_state(torch, value, fn) for key, value in state.items()}
    if isinstance(state, list):
        return [map_state(torch, value, fn) for value in state]
    if isinstance(state, torch.Tensor):
        return fn(state)
    return copy.deepcopy(state)


def gc_cuda(torch) -> None:
    """Return the memory of dropped tensors to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def state_bytes(torch, state) -> int:
    """Bytes of the tensors of a nested state: what a checkpoint of it
    writes and reads, give or take its metadata."""
    return sum(leaf.numel() * leaf.element_size() for _, leaf in leaf_paths(state)
               if isinstance(leaf, torch.Tensor))


def state_mismatches(torch, got, want):
    """Paths where two nested states differ: structure, a tensor's
    dtype, shape or bytes (wherever each lives), or another leaf's
    value."""
    got, want = dict(leaf_paths(got)), dict(leaf_paths(want))
    bad = sorted(set(got) ^ set(want))
    for path in sorted(set(got) & set(want)):
        a, b = got[path], want[path]
        if isinstance(b, torch.Tensor):
            same = (isinstance(a, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a.detach().to(b.device).reshape(-1).view(torch.uint8),
                                    b.detach().reshape(-1).view(torch.uint8)))
        else:
            same = type(a) is type(b) and a == b
        if not same:
            bad.append(path)
    return bad


def train_step_flops(cfg, batch: int, tokens: int) -> float:
    """Model FLOPs of one Llama training step: three times the forward's
    (the backward costs two forwards).  The forward does 2 FLOPs a
    weight a token in every matmul, the tied embedding's logits product
    included and its lookup not, and 4 * H * head_dim a visible causal
    (query, key) pair; the masked half that the dense op also computes
    is not counted."""
    D, H, Hkv, Dh, F_ = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D + 3 * D * F_
    matmul = 2.0 * batch * tokens * (cfg.n_layers * per_layer + cfg.vocab_size * D)
    attention = 4.0 * batch * H * Dh * cfg.n_layers * tokens * (tokens + 1) / 2
    return 3.0 * (matmul + attention)


def routed_experts(dispatch):
    """[S, E] bool of a ``_route`` dispatch [S, E, C]: the experts each
    token went to, after capacity (a dropped pick goes nowhere)."""
    return dispatch.sum(-1) > 0


@contextlib.contextmanager
def recorded_routes(torch, moe, fingerprints: bool = False):
    """Inside the block every ``moe._route`` call appends its
    ``routed_experts`` to the first list of the yielded pair, and (with
    ``fingerprints``) the ``fingerprint`` of the tokens it routed, a
    layer's input to the MoE, to the second."""
    route, picks, inputs = moe._route, [], []

    def recording_route(x, router, c):
        dispatch, combine, aux = route(x, router, c)
        picks.append(routed_experts(dispatch))
        if fingerprints:
            inputs.append(fingerprint(torch, x))
        return dispatch, combine, aux

    moe._route = recording_route
    try:
        yield picks, inputs
    finally:
        moe._route = route


def differing_tokens(got, want):
    """[S] bool: tokens routed differently in any layer, from two lists
    (one entry a layer) of ``routed_experts``."""
    if len(got) != len(want):
        raise ValueError(f"{len(got)} layers against {len(want)}")
    out = None
    for a, b in zip(got, want):
        diff = (a != b).any(-1)
        out = diff if out is None else out | diff
    return out


def leaves_close(torch, got, want, atol: float, rtol: float, free=None):
    """Two params or grads trees, named alike: (max |got - want|, worst
    |got - want| / (atol + rtol |want|) outside ``free``, the elements
    in ``free``, max |got - want| inside it).  ``free`` ({path: bool
    tensor}) marks elements held to another limit by the caller."""
    got, want = dict(leaf_paths(got)), dict(leaf_paths(want))
    if got.keys() != want.keys():
        raise AssertionError(f"trees differ: {sorted(set(got) ^ set(want))}")
    err = worst = free_err = 0.0
    n_free = 0
    for path, b in want.items():
        a = got[path].detach().to(b.device).float()
        b = b.detach().float()
        diff = (a - b).abs()
        ratio = diff / (atol + rtol * b.abs())
        if free is not None:
            mask = free[path].to(b.device)
            n_free += int(mask.sum())
            free_err = max(free_err, float((diff * mask).max()))
            ratio = ratio.masked_fill(mask, 0.0)
        err = max(err, float(diff.max()))
        worst = max(worst, float(ratio.max()))
    return err, worst, n_free, free_err


def grad_tree(torch, params):
    """{leaf path: grad} of a params tree."""
    return {path: leaf.grad for path, leaf in leaf_paths(params)}


def train_batches(torch, vocab: int, tokens: int, steps: int, seed: int):
    """``steps`` batches of one sequence of ``tokens`` ids, from ``seed``."""
    rng = torch.Generator().manual_seed(seed)
    return [torch.randint(0, vocab, (1, tokens), generator=rng) for _ in range(steps)]


def autograd_guard(torch, cfg):
    """The kernels are forward-only: under autograd each wrapper raises
    before its launch, and the dense op (``use_flash=False``) carries
    the gradient to every layer.  Runs on the training configuration."""
    llama = port("models.llama")
    mesh_mod = port("parallel.mesh")
    fc, rc = port("ops.flash_cuda"), port("ops.ring_flash_cuda")
    pc = port("ops.paged_decode_cuda")
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    for leaf in llama.param_leaves(params):
        leaf.requires_grad_()
    (tokens,) = train_batches(torch, cfg.vocab_size, TRAIN_TOKENS, 1, SEED + 10)
    sp_mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=1, sp=RING_SP), ["cuda:0"] * RING_SP)
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    q = torch.randn(2, cfg.n_heads, cfg.head_dim, generator=g, device="cuda").to(torch.bfloat16)
    kv = torch.randn(8, 2, 16, cfg.n_kv_heads, cfg.head_dim, generator=g, device="cuda")
    kv = kv.to(torch.bfloat16)
    table = torch.arange(8, dtype=torch.int32, device="cuda").reshape(2, 4)
    ctx = torch.tensor([50, 17], dtype=torch.int32, device="cuda")
    refused = {}
    for what, call, counter in (
            ("forward(use_flash=True), params requiring grad",
             lambda: llama.forward(params, tokens, cfg), fc.flash_gqa_attention_cuda),
            (f"forward(sp_mesh=sp {RING_SP}), params requiring grad",
             lambda: llama.forward(params, tokens, cfg, sp_mesh=sp_mesh),
             rc.flash_partial_cuda),
            ("paged_decode_attention_cuda, q requiring grad",
             lambda: pc.paged_decode_attention_cuda(q.requires_grad_(), kv, table, ctx),
             pc.paged_decode_attention_cuda)):
        counter.launches = 0
        try:
            call()
        except RuntimeError as exc:
            refused[what] = str(exc).split(";")[0]
        else:
            raise AssertionError(f"{what} under autograd ran without raising")
        if "forward-only" not in refused[what] or counter.launches:
            raise AssertionError(f"{what}: {refused[what]!r}, {counter.launches} launches")
        print(f"  {what}: raises before the launch ({refused[what]!r}); 0 launches",
              flush=True)
    fc.flash_gqa_attention_cuda.launches = 0
    with torch.no_grad():
        llama.forward(params, tokens, cfg)
    no_grad_launches = fc.flash_gqa_attention_cuda.launches
    print(f"  the same forward under torch.no_grad(): runs, {no_grad_launches} prefill "
          f"kernel launches", flush=True)
    if no_grad_launches != cfg.n_layers:
        raise AssertionError(f"no_grad forward launched {no_grad_launches} prefill kernels")
    fc.flash_gqa_attention_cuda.launches = 0
    loss = llama.loss_fn(params, tokens, cfg)
    loss.backward()
    loss = float(loss.detach())
    if fc.flash_gqa_attention_cuda.launches:
        raise AssertionError("loss_fn launched the prefill kernel")
    grads = {}
    for key in ("wq", "wk", "wv", "wo", "ln1", "ln2"):
        grad = params["layers"][key].grad
        per_layer = grad.float().flatten(1).abs().amax(1)
        grads[key] = per_layer.tolist()
        if not bool(grad.isfinite().all()) or not bool((per_layer > 0).all()):
            raise AssertionError(f"{key}: a layer's gradient is zero or not finite: "
                                 f"{grads[key]}")
    print(f"  loss_fn (use_flash=False, the dense op): loss {loss:.6f}; max |grad| "
          f"of each of {cfg.n_layers} layers, finite and non-zero: "
          + "; ".join(f"{k} {min(v):.3g}..{max(v):.3g}" for k, v in grads.items()),
          flush=True)
    return {"refused": refused, "no_grad_launches": no_grad_launches,
            "loss": loss, "grad_max_abs_by_layer": grads}


def small_training_step(torch):
    """One train step at a small float32 shape on the card against the
    same step on the CPU: loss, every gradient, every updated leaf."""
    llama = port("models.llama")
    cfg = llama.LlamaConfig(vocab_size=1024, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, dtype="float32")
    cpu = llama.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    gpu = map_state(torch, cpu, lambda leaf: leaf.cuda())
    (tokens,) = train_batches(torch, cfg.vocab_size, 128, 1, SEED + 12)
    tokens = torch.cat((tokens, tokens.flip(1)))  # B = 2
    losses, grads = {}, {}
    for name, params in (("cpu", cpu), ("cuda", gpu)):
        opt = llama.make_optimizer(params)
        losses[name] = float(llama.train_step(params, opt, tokens, cfg))
        grads[name] = grad_tree(torch, params)
    loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    g_err, g_worst, _, _ = leaves_close(torch, grads["cuda"], grads["cpu"], *SMALL_STEP_LIMITS)
    # Adam's first step moves an element by lr * g / (|g| + eps): where g
    # lies within the gradient limit of zero, its rounding decides that
    # step's size and sign, so such elements are held to 2 * lr instead.
    near_zero = {p: g.abs() <= SMALL_STEP_LIMITS[0] for p, g in grads["cpu"].items()}
    p_err, p_worst, n_free, free_err = leaves_close(torch, gpu, cpu, *SMALL_STEP_LIMITS,
                                                    free=near_zero)
    print(f"  small float32 step (2 layers, d 256, B=2, T=128), card against the CPU: loss "
          f"{losses['cuda']:.7f} vs {losses['cpu']:.7f} (rel err {loss_err:.3g}, limit "
          f"{SMALL_STEP_LOSS_REL:.0e}); gradients max_abs_err {g_err:.3g}, worst err/limit "
          f"{g_worst:.3g}; updated leaves max_abs_err {p_err:.3g}, worst err/limit "
          f"{p_worst:.3g} (limit {SMALL_STEP_LIMITS[0]:.0e} + {SMALL_STEP_LIMITS[1]:.0e}*|ref|; "
          f"{n_free} elements with |grad| within it of 0 held to 2*lr: max err "
          f"{free_err:.3g})", flush=True)
    if not (loss_err <= SMALL_STEP_LOSS_REL and g_worst <= 1.0 and p_worst <= 1.0
            and free_err <= 2 * 3e-4):
        raise AssertionError("the card's small training step disagrees with the CPU's")
    return {"loss": losses, "loss_rel_err": loss_err, "grad_max_abs_err": g_err,
            "grad_worst_err_over_limit": g_worst, "leaf_max_abs_err": p_err,
            "leaf_worst_err_over_limit": p_worst, "near_zero_grads": n_free}


def training_and_checkpoint(torch, peaks, cfg):
    """Three train steps at Llama-3-8B widths (``cfg``: the depth cut),
    a checkpoint of the state after step 1, its restore onto the card and
    step 2 resumed from it against the uninterrupted step 2."""
    llama = port("models.llama")
    ckpt = port("models.checkpoint")
    fc = port("ops.flash_cuda")
    batches = train_batches(torch, cfg.vocab_size, TRAIN_TOKENS, TRAIN_STEPS, SEED + 20)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    opt = llama.make_optimizer(params)
    n_params = sum(leaf.numel() for leaf in llama.param_leaves(params))
    flops = train_step_flops(cfg, 1, TRAIN_TOKENS)
    print(f"  {cfg.n_layers} layers, {n_params / 1e9:.3f} B params, bf16, B=1, "
          f"T={TRAIN_TOKENS}; model FLOPs a step {flops / 1e12:.2f} T", flush=True)

    def step(params, opt, i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(llama.train_step(params, opt, batches[i], cfg))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        finite = math.isfinite(loss) and all(
            bool(leaf.isfinite().all()) for leaf in llama.param_leaves(params))
        if not finite:
            raise AssertionError(f"step {i + 1}: loss {loss} or an updated leaf not finite")
        return loss, ms

    fc.flash_gqa_attention_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    loss, ms = step(params, opt, 0)
    losses.append(loss)
    walls.append(ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state = {"params": params, "opt": opt.state_dict()}
    nbytes = state_bytes(torch, state)
    # The state after step 1, kept on the card for the checks below.
    snapshot = map_state(torch, state, lambda leaf: leaf.detach().clone())
    folder = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free_gb = shutil.disk_usage(folder).free / 1e9
        print(f"  checkpoint of the state after step 1: {nbytes / 1e9:.2f} GB of tensors "
              f"(params and AdamW's exp_avg, exp_avg_sq, step) to {folder} "
              f"({free_gb:.1f} GB free there)", flush=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(folder, state)
        save_s = time.perf_counter() - t0
        del state
        for i in range(1, TRAIN_STEPS):
            loss, ms = step(params, opt, i)
            losses.append(loss)
            walls.append(ms)
        if fc.flash_gqa_attention_cuda.launches:
            raise AssertionError(f"training launched the prefill kernel "
                                 f"{fc.flash_gqa_attention_cuda.launches} times")
        # Step 1's batch under the params after the three steps: the
        # updates' effect, which phase 12c holds the sharded steps to.
        with torch.no_grad():
            after = float(llama.loss_fn(params, batches[0], cfg))
        step_ms = statistics.mean(walls[1:])
        tflops = flops / (step_ms * 1e-3) / 1e12
        print(f"  losses {losses}; ms a step {[round(w, 1) for w in walls]} (step 1 allocates "
              f"AdamW's state); steps 2-{TRAIN_STEPS}: {step_ms:.1f} ms, {tflops:.1f} model "
              f"TFLOP/s, {tflops * 1e12 / peaks[0]:.3f} of the {peaks[0] / 1e12:.0f} TFLOP/s "
              f"bf16 peak; max_memory_allocated over step 1 {peak_gb:.2f} GB; prefill kernel "
              f"launches during the steps: 0; step 1's batch after the steps: loss {after!r}",
              flush=True)
        uninterrupted = losses[1]
        # Where a step's device time goes: one more step, profiled.
        split = show_breakdown("train step under torch.profiler", step_ms, device_breakdown(
            torch, lambda: llama.train_step(params, opt, batches[-1], cfg), steps=1))
        del params, opt
        gc_cuda(torch)

        phase("10. checkpoint: restore the state after step 1 onto the card, resume step 2")
        target = ckpt.abstract_like(snapshot, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = ckpt.restore_checkpoint(folder, target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        on_disk = sum(os.path.getsize(os.path.join(folder, f)) for f in os.listdir(folder))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    bad = state_mismatches(torch, restored, snapshot)
    leaves = dict(leaf_paths(snapshot))
    n_tensors = sum(isinstance(v, torch.Tensor) for v in leaves.values())
    print(f"  save {save_s:.2f} s ({nbytes / save_s / 1e9:.2f} GB/s), restore into "
          f"abstract_like targets on the card {restore_s:.2f} s ({nbytes / restore_s / 1e9:.2f} "
          f"GB/s); {on_disk / 1e9:.2f} GB on disk, removed; {n_tensors} tensors and "
          f"{len(leaves) - n_tensors} Python values, bit-equal to the state saved: "
          f"{not bad}", flush=True)
    if bad:
        raise AssertionError(f"restored state differs at {bad[:10]}")
    resumed = {}
    for name, state in (("restored", restored), ("a device copy", snapshot)):
        params = state["params"]
        opt = llama.make_optimizer(params)
        opt.load_state_dict(state["opt"])
        resumed[name] = step(params, opt, 1)[0]
        del params, opt, state
    del restored, snapshot, target, leaves
    gc_cuda(torch)
    spread = abs(resumed["restored"] - resumed["a device copy"])
    err = abs(resumed["restored"] - uninterrupted)
    print(f"  step 2 resumed from the restored state: loss {resumed['restored']!r}; "
          f"uninterrupted {uninterrupted!r}; from a device copy of the state "
          f"{resumed['a device copy']!r} (spread of two identical steps {spread:.3g}); "
          f"difference {err:.3g}", flush=True)
    if not err <= spread:
        raise AssertionError("the resumed step 2 differs from the uninterrupted one by more "
                             "than two identical steps do")
    return {"layers": cfg.n_layers, "tokens": TRAIN_TOKENS, "params": n_params,
            "losses": losses, "loss_after_steps": after, "step_ms": walls,
            "steady_step_ms": step_ms,
            "model_tflops": tflops, "bf16_peak_share": tflops * 1e12 / peaks[0],
            "max_memory_allocated_gb": peak_gb, "breakdown_ms": split,
            "checkpoint": {"bytes": nbytes, "on_disk_bytes": on_disk, "save_s": save_s,
                           "restore_s": restore_s, "tensors": n_tensors,
                           "resumed_loss": resumed["restored"], "uninterrupted_loss":
                           uninterrupted, "identical_step_spread": spread}}


def moe_phase(torch, peaks):
    """The MoE family at ``MoEConfig()``: the bf16 forward on the prefill
    kernel and on the ring (the main path's launches), the float32
    forwards held against the dense one with each layer's expert picks
    compared, and three train steps."""
    moe = port("models.moe")
    mesh_mod = port("parallel.mesh")
    fc, rc = port("ops.flash_cuda"), port("ops.ring_flash_cuda")
    cfg = moe.MoEConfig()
    L = cfg.n_layers
    params = moe.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    (tokens,) = train_batches(torch, cfg.vocab_size, MOE_TOKENS, 1, SEED + 30)
    sp_mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=1, sp=RING_SP), ["cuda:0"] * RING_SP)
    runs = {"flash": {}, "ring": dict(sp_mesh=sp_mesh), "dense": dict(use_flash=False)}
    # Contiguous ring: sp(sp+1)/2 visible (rank, step) pairs a layer.
    expected = {"flash": {"flash_prefill": L, "ring_partial": 0},
                "ring": {"flash_prefill": 0, "ring_partial": L * RING_SP * (RING_SP + 1) // 2},
                "dense": {"flash_prefill": 0, "ring_partial": 0}}
    print(f"  MoEConfig(): d_model {cfg.d_model}, {L} layers, {cfg.n_heads} heads, "
          f"{cfg.n_kv_heads} KV heads, head_dim {cfg.head_dim}, {cfg.n_experts} experts, top "
          f"{cfg.top_k}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; one prompt of {MOE_TOKENS} "
          f"tokens, capacity {cfg.capacity(MOE_TOKENS)} slots an expert", flush=True)

    def run(params, name):
        fc.flash_gqa_attention_cuda.launches = 0
        rc.flash_partial_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, aux = moe.forward(params, tokens, cfg, **runs[name])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = {"flash_prefill": fc.flash_gqa_attention_cuda.launches,
                    "ring_partial": rc.flash_partial_cuda.launches}
        if launches != expected[name]:
            raise AssertionError(f"MoE {name}: launches {launches}, expected {expected[name]}")
        if logits.shape != (1, MOE_TOKENS, cfg.vocab_size) or not bool(
                logits.isfinite().all()) or not math.isfinite(float(aux)):
            raise AssertionError(f"MoE {name}: logits {tuple(logits.shape)} or aux not finite")
        return logits, float(aux), wall, launches

    for name in runs:  # warm-up: cuBLAS picks its algorithms
        run(params, name)
    walls, launches = {}, {}
    for name in runs:
        _, aux, walls[name], launches[name] = run(params, name)
        print(f"  bf16 {name} forward: {walls[name]:.1f} ms, aux {aux:.6f}, kernel launches "
              f"{launches[name]}", flush=True)
    with torch.no_grad():
        split = show_breakdown("bf16 forward on the prefill kernel under torch.profiler",
                               walls["flash"], device_breakdown(
                                   torch, lambda: moe.forward(params, tokens, cfg), steps=1))

    # float32: the kernels' float32 variants against the dense op, with
    # the experts each token went to recorded in every layer.
    params32 = map_state(torch, params, lambda leaf: leaf.float())
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    outputs = {}
    for name in runs:
        with recorded_routes(torch, moe) as (records, _), torch.no_grad():
            logits, aux = moe.forward(params32, tokens, cfg32, **runs[name])
        outputs[name] = (logits, float(aux), records)
    dense, dense_aux, dense_routes = outputs["dense"]
    checks = {}
    for name in ("flash", "ring"):
        logits, aux, routes = outputs[name]
        differ = differing_tokens(routes, dense_routes)
        n_differ = int(differ.sum())
        print(f"  float32 {name} forward vs the dense forward: tokens routed to other experts "
              f"in some layer: {n_differ} of {MOE_TOKENS} (limit {MOE_PICK_LIMIT:.0%}); aux "
              f"{aux!r} vs {dense_aux!r}", flush=True)
        if n_differ > MOE_PICK_LIMIT * MOE_TOKENS:
            raise AssertionError(f"MoE {name}: {n_differ} tokens routed otherwise")
        agree = ~differ
        err = check_logits(f"float32 {name} vs dense logits, the {int(agree.sum())} tokens "
                           f"routed alike", logits[0, agree], dense[0, agree])
        gap = check_next_token(f"float32 {name} next token", int(logits[0, -1].argmax()),
                               dense[0, -1], err)
        aux_err = abs(aux - dense_aux) / abs(dense_aux)
        if not aux_err <= 2.0**-14:
            raise AssertionError(f"MoE {name}: aux {aux} vs dense {dense_aux}")
        checks[name] = {"tokens_routed_otherwise": n_differ, "max_abs_err": err,
                        "next_token_gap": gap, "aux_rel_err": aux_err}
    del outputs, dense, params32, records
    gc_cuda(torch)

    # Training: three steps at T=MOE_TRAIN_TOKENS through the dense op.
    opt = moe.make_optimizer(params)
    batches = train_batches(torch, cfg.vocab_size, MOE_TRAIN_TOKENS, TRAIN_STEPS, SEED + 31)
    fc.flash_gqa_attention_cuda.launches = 0
    losses, step_ms = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(moe.train_step(params, opt, batch, cfg))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not math.isfinite(loss) or not all(
                bool(leaf.isfinite().all()) for leaf in port("models.llama").param_leaves(params)):
            raise AssertionError(f"MoE train step: loss {loss} or a leaf not finite")
    if fc.flash_gqa_attention_cuda.launches:
        raise AssertionError("MoE training launched the prefill kernel")
    print(f"  bf16 train steps at T={MOE_TRAIN_TOKENS}: losses {losses}, ms a step "
          f"{[round(w, 1) for w in step_ms]}; prefill kernel launches 0", flush=True)
    del params, opt
    gc_cuda(torch)
    return {"launches": {"flash_prefill": launches["flash"]["flash_prefill"],
                         "ring_partial": launches["ring"]["ring_partial"]},
            "forward_ms": walls, "breakdown_ms": split, "float32_vs_dense": checks,
            "train_losses": losses, "train_step_ms": step_ms}


# ----------------------------------------------------- phases 9b, 12d-across


def fingerprint(torch, tensor) -> int:
    """A 64-bit fingerprint of ``tensor``'s bits, cheap on the card: the
    sum, mod 2^64, of each element's bits as an integer times an odd
    weight of its row-major index.  Two tensors that differ in one
    element always differ here (an odd weight is a unit mod 2^64); ones
    that differ in more collide by chance only (2^-64)."""
    flat = tensor.detach().contiguous().view(-1)
    bits = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=flat.device)
    for a in range(0, bits.numel(), FINGERPRINT_CHUNK):
        v = bits[a:a + FINGERPRINT_CHUNK].to(torch.int64)
        w = torch.arange(a, a + v.numel(), dtype=torch.int64, device=flat.device)
        total += (v * (w * -7046029254386353131 | 1)).sum()
    return int(total)


def tree_fingerprints(torch, tree) -> dict:
    """{leaf path: {coord: fingerprint}} of a state's sharded leaves'
    distinct locals, {leaf path: fingerprint} of its plain tensors."""
    out = {}
    for path, leaf in leaf_paths(tree):
        if hasattr(leaf, "distinct"):
            out[path] = {coord: fingerprint(torch, t) for coord, t in leaf.distinct()}
        elif isinstance(leaf, torch.Tensor):
            out[path] = fingerprint(torch, leaf)
    return out


def fingerprint_mismatches(torch, sharding, mesh, specs: dict, got: dict, full: dict,
                           device: str) -> list:
    """The (path, coord) of ``got`` (``tree_fingerprints`` of a state on
    ``mesh``, whose leaves ``specs`` cut: {path: spec}) whose fingerprint
    is not that of its slice of ``full`` ({path: global tensor}), taken
    on ``device``."""
    import numpy as np

    bad = []
    for path, prints in got.items():
        want = full[path]
        if not isinstance(prints, dict):
            if fingerprint(torch, want.to(device)) != prints:
                bad.append((path, None))
            continue
        like = sharding.Sharded(mesh, sharding.P(*specs[path]), tuple(want.shape), want.dtype,
                                np.empty(mesh.devices.shape, dtype=object))
        for coord, value in prints.items():
            piece = want[like.slices(like.shard_index(coord))].to(device)
            if fingerprint(torch, piece) != value:
                bad.append((path, coord))
    return bad


def transfers_by_direction(by_kind: dict) -> dict:
    """``transfers_by_kind`` summed by direction: the forward's
    collectives, the backward's (``:bwd`` kinds and their ``order:``
    checks) and the gradients' sync after the backward (``sum:``)."""
    out = {}
    for kind, row in by_kind.items():
        direction = ("sync" if kind.startswith("sum:") else "backward"
                     if kind.endswith(":bwd") or kind.startswith("order:") else "forward")
        total = out.setdefault(direction, {"calls": 0, "bytes_out": 0, "bytes_in": 0,
                                           "span_ms": 0.0, "d2h_ms": 0.0, "h2d_ms": 0.0})
        for key in total:
            total[key] += row[key]
    return out


def own_bytes(torch, tree) -> int:
    """Bytes of one local copy of each slice of a state's sharded leaves
    in this process, and of its plain tensors: what a restore of it must
    read."""
    total = 0
    for _, leaf in leaf_paths(tree):
        if hasattr(leaf, "distinct"):
            total += sum({leaf.shard_index(c): t.numel() * t.element_size()
                          for c, t in leaf.distinct()}.values())
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def host_rss_bytes() -> int:
    """This process's resident set (``VmRSS`` of /proc/self/status)."""
    with open("/proc/self/status") as status:
        for line in status:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/self/status has no VmRSS")


class RssPeak:
    """The largest resident set sampled every ``RSS_SAMPLE_S`` while the
    block runs (``peak``).  The card's machine keeps no ``VmHWM``, and
    ``ru_maxrss`` carries a spawned worker's parent's peak."""

    def __enter__(self) -> "RssPeak":
        self.peak, self._done = host_rss_bytes(), threading.Event()
        self._thread = threading.Thread(target=self._sample, name="rss-peak", daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._done.wait(RSS_SAMPLE_S):
            self.peak = max(self.peak, host_rss_bytes())

    def __exit__(self, *exc) -> None:
        self._done.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss_bytes())


def param_specs(llama, cfg) -> dict:
    """{leaf path: spec} of a state's params and its AdamW moments."""
    specs = dict(leaf_paths(llama.param_pspecs(cfg)))
    out = {f"params.{k}": v for k, v in specs.items()}
    for moment in ("exp_avg", "exp_avg_sq"):
        out.update({f"opt.{moment}.{k}": v for k, v in specs.items()})
    return out


def named_shardings(sharding, mesh, specs):
    if isinstance(specs, dict):
        return {k: named_shardings(sharding, mesh, v) for k, v in specs.items()}
    return sharding.NamedSharding(mesh, specs)


def train_across_mesh(torch, dist, rank: int, name: str, cfg, batches, device: str) -> dict:
    """Phase 9b in one worker, one mesh: ``TRAIN_ACROSS_STEPS`` train
    steps of the cut model over dcn ``TRAIN_ACROSS[name]``, the first
    timed, the second under torch.profiler (the device's idle share),
    its transfers by kind; the peak memory; the updated params'
    fingerprints.  Returns the live state too (tp: 12d-across saves it)."""
    llama, mesh_mod = port("models.llama"), port("parallel.mesh")
    sharding, pg = port("parallel.sharding"), port("parallel.process_group")
    kernels = (port("ops.flash_cuda").flash_gqa_attention_cuda,
               port("ops.paged_decode_cuda").paged_decode_attention_cuda,
               port("ops.ring_flash_cuda").flash_partial_cuda)
    mesh = mesh_mod.make_hybrid_mesh(mesh_mod.MeshPlan(dp=1),
                                     mesh_mod.MeshPlan(**TRAIN_ACROSS[name]), devices=[device])
    gen = torch.Generator(device=device).manual_seed(SEED)
    sharded = sharding.shard_tree(llama.init_params(cfg, gen, device), mesh,
                                  llama.param_pspecs(cfg))
    gc_cuda(torch)
    opt = llama.make_optimizer(sharded)
    transport = pg.transport(mesh)
    torch.cuda.reset_peak_memory_stats()
    for kernel in kernels:
        kernel.launches = 0
    losses = []
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses.append(float(llama.train_step(sharded, opt, batches[0], cfg)))
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    first = transfers_by_kind(transport.log.records())
    transport.log.clear()
    dist.barrier()
    busy = device_breakdown(torch, lambda: losses.append(float(
        llama.train_step(sharded, opt, batches[1], cfg))), steps=1)
    second = transfers_by_kind(transport.log.records())
    finite = all(math.isfinite(x) for x in losses) and all(
        bool(t.isfinite().all()) for t in sharding.distinct_locals(sharded))
    return {"mesh": repr(mesh), "crossing": list(mesh.crossing_axes()), "losses": losses,
            "step_ms": [first_ms, busy["profiled_wall_ms"]], "finite": finite,
            "kernel_launches": sum(kernel.launches for kernel in kernels),
            "transfers": [first, second],
            "directions": [transfers_by_direction(first), transfers_by_direction(second)],
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "device_ms": busy["device_ms"], "kernels_ms": busy["kernels_ms"],
            "idle_share": max(0.0, 1 - busy["device_ms"] / busy["profiled_wall_ms"]),
            "fingerprints": tree_fingerprints(torch, {"params": sharded}),
            "state": (sharded, opt)}


def checkpoint_across(torch, dist, rank: int, cfg, sharded, opt, folder: str,
                      device: str) -> dict:
    """Phase 12d-across in one worker: the tp state (params and
    ``optimizer_state_tree``) saved with each process writing its own
    slices, then restored onto ``RESTORE_ACROSS`` across the processes;
    walls, bytes, this process's peak host RSS, and the fingerprints of
    the state saved and of the state restored."""
    llama, mesh_mod = port("models.llama"), port("parallel.mesh")
    sharding, ckpt = port("parallel.sharding"), port("models.checkpoint")
    opt.zero_grad(set_to_none=True)
    gc_cuda(torch)
    state = {"params": sharded, "opt": ckpt.optimizer_state_tree(opt, sharded)}
    out = {"saved": tree_fingerprints(torch, state), "rss_gb": host_rss_bytes() / 1e9}
    wrote = {}
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RssPeak() as rss:
        ckpt.save_checkpoint(folder, state, report=wrote)
    out["save_s"] = time.perf_counter() - t0
    out["wrote_bytes"], out["save_peak_rss_gb"] = wrote["bytes"], rss.peak / 1e9
    del state
    mesh = mesh_mod.make_hybrid_mesh(mesh_mod.MeshPlan(dp=1), mesh_mod.MeshPlan(**RESTORE_ACROSS),
                                     devices=[device])
    shardings = named_shardings(sharding, mesh, llama.param_pspecs(cfg))
    target_params = ckpt.abstract_like(sharded, shardings)
    target = {"params": target_params,
              "opt": ckpt.optimizer_state_like(llama.make_optimizer(target_params),
                                               target_params)}
    read = {}
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RssPeak() as rss:
        restored = ckpt.restore_checkpoint(folder, target, report=read)
        torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    out["read_bytes"], out["restore_peak_rss_gb"] = read["bytes"], rss.peak / 1e9
    out["own_bytes"] = own_bytes(torch, restored)
    out["restored"] = tree_fingerprints(torch, restored)
    out["restore_mesh"] = repr(mesh)
    del restored, target, target_params
    gc_cuda(torch)
    return out


def train_across_run(torch, dist, rank, cfg, batches, dp_batches, folder, device) -> dict:
    """A worker of phases 9b and 12d-across: dp across the processes,
    then tp, whose state it saves and restores."""
    out = {}
    for name in TRAIN_ACROSS:
        row = train_across_mesh(torch, dist, rank, name, cfg,
                                dp_batches if name == "dp" else batches, device)
        sharded, opt = row.pop("state")
        if name == "tp":
            out["checkpoint"] = checkpoint_across(torch, dist, rank, cfg, sharded, opt, folder,
                                                  device)
        del sharded, opt
        gc_cuda(torch)
        out[name] = row
    return out


def train_reference(torch, cfg, batches, device: str) -> dict:
    """The single process's steps on ``batches`` (phase 9b's dp
    reference): losses and walls."""
    llama = port("models.llama")
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    opt = llama.make_optimizer(params)
    losses, walls = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(llama.train_step(params, opt, batch, cfg)))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    del params, opt
    gc_cuda(torch)
    return {"losses": losses, "step_ms": walls}


def training_across_processes(torch, cfg, phase9, device: str = "cuda:0") -> dict:
    """Phases 9b and 12d-across: the cut model's train steps over
    ``ACROSS_WORLD`` spawned processes on the card (dp, then tp across
    them), each held to the single process on the same tokens; the tp
    state saved by both processes and restored across them onto
    ``RESTORE_ACROSS`` and here onto ``SHARD_RESTORE_PLAN``, every leaf
    bit-equal to the checkpoint as one process reads it, which holds
    the state the processes trained bit for bit."""
    llama, ckpt = port("models.llama"), port("models.checkpoint")
    sharding, mesh_mod = port("parallel.sharding"), port("parallel.mesh")
    batches = train_batches(torch, cfg.vocab_size, TRAIN_TOKENS, TRAIN_STEPS, SEED + 20)
    batches = batches[:TRAIN_ACROSS_STEPS]
    dp_batches = [torch.cat((b, b.flip(1))) for b in batches]
    dp_ref = train_reference(torch, cfg, dp_batches, device)
    refs = {"dp": dp_ref["losses"], "tp": phase9["losses"][:TRAIN_ACROSS_STEPS]}
    beside = {"dp": ("the single process at B=2", dp_ref["step_ms"]),
              "tp": ("phase 9's, B=1", phase9["step_ms"][:TRAIN_ACROSS_STEPS])}
    folder = tempfile.mkdtemp(prefix="chip_smoke_ckpt_across_")
    try:
        t0 = time.perf_counter()
        workers = spawn_group(torch, group_worker, ACROSS_WORLD,
                              ("train_across_run", ACROSS_GROUP_TIMEOUT_S,
                               (cfg, batches, dp_batches, folder, device)),
                              timeout=ACROSS_GROUP_TIMEOUT_S + 120)
        print(f"  {ACROSS_WORLD} processes on {device} (gloo over loopback): "
              f"{time.perf_counter() - t0:.1f} s with spawn, imports, both meshes and the "
              f"checkpoint", flush=True)
        out = {"meshes": {}}
        limits = [SHARD_FIRST_LOSS_REL] + [SHARD_LATER_LOSS_REL] * (TRAIN_ACROSS_STEPS - 1)
        for name in TRAIN_ACROSS:
            rows = [w[name] for w in workers]
            label, ref_ms = beside[name]
            gaps = [[rel_gap(a, b) for a, b in zip(r["losses"], refs[name])] for r in rows]
            print(f"  {name} across processes: mesh {rows[0]['mesh']}, crossing "
                  f"{rows[0]['crossing']}; losses {[r['losses'] for r in rows]} against the "
                  f"single process's {refs[name]} (relative gaps "
                  f"{[[f'{g:.3g}' for g in gap] for gap in gaps]}, limits {limits})", flush=True)
            for r, row in enumerate(rows):
                print(f"    process {r}: ms a step {[round(w, 1) for w in row['step_ms']]} "
                      f"(step 2 under torch.profiler; beside {label}: "
                      f"{[round(w, 1) for w in ref_ms]}); peak "
                      f"{row['max_memory_allocated_gb']:.2f} GB; device idle share of step 2 "
                      f"{row['idle_share']:.3f} ({row['device_ms']:.1f} ms of kernels: "
                      + ", ".join(f"{k} {v:.1f}" for k, v in row["kernels_ms"].items()) + ")",
                      flush=True)
                for step, (kinds, dirs) in enumerate(zip(row["transfers"], row["directions"])):
                    print(f"      step {step + 1} transfers by direction: " + "; ".join(
                        f"{d} {v['calls']} calls, {v['bytes_out'] / 2**20:.1f} MiB out / "
                        f"{v['bytes_in'] / 2**20:.1f} in, gloo {v['span_ms']:.1f} ms, staging "
                        f"{v['d2h_ms']:.1f} to the host + {v['h2d_ms']:.1f} back"
                        for d, v in sorted(dirs.items())), flush=True)
                    print(f"      step {step + 1} by kind: {transfers_text(kinds)}", flush=True)
            launched = [r["kernel_launches"] for r in rows]
            print(f"    kernel launches during the steps, a process: {launched} (the dense op "
                  f"trains)", flush=True)
            if not all(r["finite"] for r in rows) or any(launched):
                raise AssertionError(f"9b {name}: a loss or an updated leaf is not finite, or a "
                                     f"kernel launched ({launched})")
            if not all(g <= x for gap in gaps for g, x in zip(gap, limits)):
                raise AssertionError(f"9b {name}: a loss is off the single process's: {gaps}")
            equal = all(r["losses"] == rows[0]["losses"] for r in rows)
            copies = None
            if name == "dp":
                # Every leaf is whole in each process (its coordinate
                # differs in dp only): the replicas' bits.
                prints = [{path: list(v.values()) for path, v in r["fingerprints"].items()}
                          for r in rows]
                copies = all(p == prints[0] for p in prints)
                print(f"    updated params of the {len(rows)} processes byte-equal (64-bit "
                      f"fingerprints of every leaf): {copies}; losses equal: {equal}", flush=True)
                if not (copies and equal):
                    raise AssertionError("9b dp: the replicas' updated params or losses differ")
            out["meshes"][name] = {
                "mesh": rows[0]["mesh"], "losses": [r["losses"] for r in rows],
                "reference_losses": refs[name], "loss_rel_gaps": gaps, "limits": limits,
                "step_ms": [r["step_ms"] for r in rows], "reference_step_ms": ref_ms,
                "max_memory_allocated_gb": [r["max_memory_allocated_gb"] for r in rows],
                "idle_share": [r["idle_share"] for r in rows],
                "device_ms": [r["device_ms"] for r in rows],
                "transfers": [r["transfers"] for r in rows],
                "directions": [r["directions"] for r in rows], "replicas_equal": copies}

        phase(f"12d-across. checkpoint across processes: 9b's tp state saved by both, each its "
              f"own slices; restored onto {RESTORE_ACROSS} across them and onto "
              f"{SHARD_RESTORE_PLAN} in one process")
        rows = [w["checkpoint"] for w in workers]
        t0 = time.perf_counter()
        plain = ckpt.restore_checkpoint(folder)  # the checkpoint as one process reads it
        plain_s = time.perf_counter() - t0
        full = {path: leaf for path, leaf in leaf_paths(plain) if isinstance(leaf, torch.Tensor)}
        total = sum(t.numel() * t.element_size() for t in full.values())
        on_disk = sum(os.path.getsize(os.path.join(folder, f)) for f in os.listdir(folder))
        specs = param_specs(llama, cfg)
        tp_mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(**TRAIN_ACROSS["tp"]), [device] * 2)
        pp_mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(**RESTORE_ACROSS), [device] * 2)
        saved_bad = [fingerprint_mismatches(torch, sharding, tp_mesh, specs, r["saved"], full,
                                            device) for r in rows]
        restored_bad = [fingerprint_mismatches(torch, sharding, pp_mesh, specs, r["restored"],
                                               full, device) for r in rows]
        for r, row in enumerate(rows):
            print(f"    process {r}: save {row['save_s']:.2f} s ({row['wrote_bytes'] / 1e9:.2f} GB "
                  f"written, {row['wrote_bytes'] / row['save_s'] / 1e9:.2f} GB/s); restore onto "
                  f"{row['restore_mesh']} {row['restore_s']:.2f} s ({row['read_bytes'] / 1e9:.2f} "
                  f"GB read, {row['read_bytes'] / row['restore_s'] / 1e9:.2f} GB/s; its own "
                  f"slices {row['own_bytes'] / 1e9:.2f} GB); host RSS {row['rss_gb']:.2f} GB "
                  f"before the save, its peak (sampled every {RSS_SAMPLE_S * 1e3:.0f} ms) during "
                  f"the save {row['save_peak_rss_gb']:.2f} GB and during the restore "
                  f"{row['restore_peak_rss_gb']:.2f} GB; the state it "
                  f"saved equal to the checkpoint's slices: {not saved_bad[r]}; its restored "
                  f"slices equal to them: {not restored_bad[r]}", flush=True)
        print(f"    the checkpoint: {total / 1e9:.2f} GB of tensors ({on_disk / 1e9:.2f} GB on "
              f"disk), written once (the processes wrote {sum(r['wrote_bytes'] for r in rows) / 1e9:.2f}"
              f" GB); read whole by one process in {plain_s:.2f} s", flush=True)
        if any(saved_bad) or any(restored_bad):
            raise AssertionError(f"12d-across: slices differ: saved {saved_bad}, restored "
                                 f"{restored_bad}")
        if sum(r["wrote_bytes"] for r in rows) != total or any(
                r["read_bytes"] != r["own_bytes"] for r in rows):
            raise AssertionError("12d-across: a slice written twice, or a process read more "
                                 "than its own slices")
        rmesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(**SHARD_RESTORE_PLAN), [device] * 4)
        shardings = named_shardings(sharding, rmesh, llama.param_pspecs(cfg))
        target_params = ckpt.abstract_like(plain["params"], shardings)
        target = {"params": target_params,
                  "opt": ckpt.optimizer_state_like(llama.make_optimizer(target_params),
                                                   target_params)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = ckpt.restore_checkpoint(folder, target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    bad = tree_shard_mismatches(torch, {k: v for k, v in leaf_paths(restored)
                                        if hasattr(v, "distinct")}, full)
    step_equal = bool(torch.equal(restored["opt"]["step"], full["opt.step"]))
    print(f"    onto {rmesh} in this process: {restore_s:.2f} s ({total / restore_s / 1e9:.2f} "
          f"GB/s), every local bit-equal to its slice of the checkpoint: {not bad}, the step "
          f"equal: {step_equal}", flush=True)
    if bad or not step_equal:
        raise AssertionError(f"12d-across: the restore onto {rmesh} differs: {bad}")
    del restored, target, target_params, plain, full
    gc_cuda(torch)
    out["checkpoint"] = {"bytes": total, "on_disk_bytes": on_disk, "plain_read_s": plain_s,
                         "one_process_restore_s": restore_s,
                         "processes": [{k: v for k, v in r.items()
                                        if k not in ("saved", "restored")} for r in rows]}
    return out


# --------------------------------------------------------------- phase 12


def ring_steps(sp: int, striped: bool) -> int:
    """Partial launches a layer of one head shard's ring over sp ranks:
    every (rank, step) pair striped; the sp(sp+1)/2 pairs that see a key
    contiguous (a fully masked step launches nothing)."""
    return sp * sp if striped else sp * (sp + 1) // 2


def shard_launches(per_shard: int, shards: int, layers: int) -> int:
    """Launches of a kernel over ``layers`` layers when each of
    ``shards`` head shards launches ``per_shard`` times a layer."""
    return per_shard * shards * layers


def shard_mismatches(torch, sharded, full):
    """Coordinates of the ranks whose local tensor is not bit-equal to
    its slice of ``full`` (wherever each lies)."""
    bad = []
    for coord, tensor in sharded.distinct():
        want = full[sharded.slices(sharded.shard_index(coord))]
        got = tensor.detach().to(want.device)
        if got.shape != want.shape or not torch.equal(
                got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8)):
            bad.append(coord)
    return bad


def tree_shard_mismatches(torch, sharded_tree, full_tree):
    """{leaf path: mismatching coordinates} over two trees named alike."""
    full = dict(leaf_paths(full_tree))
    out = {}
    for path, leaf in leaf_paths(sharded_tree):
        bad = shard_mismatches(torch, leaf, full[path])
        if bad:
            out[path] = bad
    return out


def tp_rank_locals(leaf, t: int) -> list:
    """The distinct local tensors of tp rank ``t`` of a leaf cut over tp
    (none for a leaf that tp does not cut)."""
    if "tp" not in leaf.spec:
        return []
    axis = leaf.mesh.axis_names.index("tp")
    return [x for coord, x in leaf.distinct() if coord[axis] == t]


def zero_tp_rank(torch, sharding, leaf, t: int):
    """``leaf`` with tp rank ``t``'s slices replaced by zeros: that
    rank's partial product dropped (a planted fault)."""
    zeros = {id(x): torch.zeros_like(x) for x in tp_rank_locals(leaf, t)}
    locals_ = leaf.locals.copy()
    flat = locals_.reshape(-1)
    for i in range(flat.size):
        flat[i] = zeros.get(id(flat[i]), flat[i])
    return sharding.Sharded(leaf.mesh, leaf.spec, leaf.shape, leaf.dtype, locals_)


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def pool_copy(torch, dst, src) -> None:
    """Copy every local tensor of one sharded pool into another's."""
    for (_, a), (_, b) in zip(dst.distinct(), src.distinct()):
        a.copy_(b)


def pools_equal(torch, a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(a.distinct(), b.distinct()))


def sharded_serving(torch, params, cfg, ref):
    """12a: phase 5's miss, hit and decode over params cut over tp on
    one card, against phase 5's logits and tokens."""
    llama = port("models.llama")
    sharding, mesh_mod, pool_mod = port("parallel.sharding"), port("parallel.mesh"), port(
        "models.kv_cache_pool")
    fc, pc = port("ops.flash_cuda"), port("ops.paged_decode_cuda")
    layers, bs = cfg.n_layers, cfg.block_size
    mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=1, tp=SHARD_TP), ["cuda:0"] * SHARD_TP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = sharding.shard_tree(params, mesh, llama.param_pspecs(cfg))
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    bad = tree_shard_mismatches(torch, sharded, params)
    print(f"  mesh {mesh}; params cut by param_pspecs in {shard_s:.2f} s, every local tensor "
          f"bit-equal to its slice: {not bad}; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated", flush=True)
    if bad:
        raise AssertionError(f"shards differ from their slices: {bad}")
    spec = sharding.P(None, None, None, None, "tp", None)
    pools = [pool_mod.KVCachePool(
        pool_mod.KVCachePoolConfig(layers, POOL_BLOCKS, bs, cfg.n_kv_heads, cfg.head_dim,
                                   cfg.dtype), sharding=sharding.NamedSharding(mesh, spec))
        for _ in range(2)]
    print(f"  two pools of {POOL_BLOCKS} blocks cut on their kv heads ({spec}): each rank "
          f"holds {pools[0].kv.local_shape}", flush=True)
    prompt_a, prompt_b, ids_a, ids_b = ref["prompt_a"], ref["prompt_b"], ref["ids_a"], ref["ids_b"]
    # The tp requests' block keys, from phase 5's Indexer's token
    # processor: the keys phase 5 served and registered, the prefix
    # shared (the hit's 512 reused blocks).
    empty = port("kvcache.kvblock.index").EMPTY_BLOCK_HASH
    keys_a, keys_b = (ref["hasher"].tokens_to_kv_block_keys(empty, p, MODEL_NAME)
                      for p in (prompt_a, prompt_b))
    n_prefix = PREFIX_TOKENS // bs
    if keys_a != ref["keys_a"] or keys_b != ref["keys_b"] or keys_a[:n_prefix] != keys_b[:n_prefix]:
        raise AssertionError("the tp requests' block keys differ from phase 5's")
    print(f"  block keys of A and B from phase 5's Indexer's token processor: equal to phase "
          f"5's, {n_prefix} shared", flush=True)

    def miss(pool):
        return llama.prefill_paged(sharded, torch.tensor([prompt_a]), pool.kv,
                                   torch.tensor([ids_a], dtype=torch.int32), cfg)[0]

    def hit(pool):
        return llama.prefill_continue(sharded, torch.tensor([prompt_b[PREFIX_TOKENS:]]),
                                      pool.kv, torch.tensor([ids_b], dtype=torch.int32),
                                      PREFIX_TOKENS, cfg)[0]

    miss(pools[1])  # warm-up on the second pool: cuBLAS picks its algorithms
    hit(pools[1])
    torch.cuda.synchronize()
    fc.flash_gqa_attention_cuda.launches = 0
    pc.paged_decode_attention_cuda.launches = 0
    zero_layer_launches()
    walls = {}
    for name, run in (("miss", miss), ("hit", hit)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = run(pools[0])
        first = int(logits[0, -1].argmax())
        walls[name] = (time.perf_counter() - t0) * 1e3
        if name == "miss":
            miss_tail = logits[:, -REF_TAIL:].clone()
            first_a = first
            del logits
        else:
            logits_b, first_b = logits, first
    prefill_launches = fc.flash_gqa_attention_cuda.launches
    print(f"  miss (prefill_paged, {len(prompt_a)} tokens) {walls['miss']:.1f} ms, hit "
          f"(prefill_continue, {SUFFIX_TOKENS} over {PREFIX_TOKENS}) {walls['hit']:.1f} ms, "
          f"to the first token (phase 5, unsharded: {ref['miss_ms']:.1f} and "
          f"{ref['hit_ms']:.1f} ms with routing)", flush=True)
    errs = {"miss_tail": check_logits(f"miss, last {REF_TAIL} positions, vs phase 5's",
                                      miss_tail, ref["miss_tail"]),
            "hit": check_logits("hit vs phase 5's", logits_b, ref["logits_b"])}
    check_next_token("miss next token", first_a, ref["miss_tail"][0, -1], errs["miss_tail"])
    check_next_token("hit next token", first_b, ref["logits_b"][0, -1], errs["hit"])
    # Phase 12f holds tp across processes to these logits and this pool.
    across = {"miss_tail": miss_tail, "logits_b": logits_b}
    del miss_tail, logits_b

    # Decode: phase 5's eight inputs through the captured tp step, then
    # the eager tp step over a copy of the pool.
    pool_copy(torch, pools[1].kv, pools[0].kv)
    table = ref["table"]
    step = llama.make_decode_step(sharded, pools[0].kv, cfg, 2, table.shape[1])
    step.graph = torch.cuda.CUDAGraph(keep_graph=True)
    inputs = ref["decode_inputs"]
    step(inputs[0][0], table, inputs[0][1])  # captures; replays write the same K/V
    step.replays = 0
    got = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tokens, ctx in inputs:
        got.append(step(tokens, table, ctx).clone())
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(inputs)
    replays = step.replays
    python_calls = pc.paged_decode_attention_cuda.launches  # the capture's two runs
    decode_nodes = captured_kernel_nodes(step.graph, dict(KERNEL_GROUPS)["decode_attention"])
    table_dev = table.cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = [llama.decode_step(sharded, tokens, pools[1].kv, table_dev, ctx, cfg)[0]
             for tokens, ctx in inputs]
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / len(inputs)
    same = [torch.equal(a, b) for a, b in zip(got, eager)]
    same_pool = pools_equal(torch, pools[0].kv, pools[1].kv)
    decode_errs, gaps = [], []
    for i, (logits, want) in enumerate(zip(got, ref["step_logits"])):
        decode_errs.append(check_logits(f"decode step {i + 1} vs phase 5's", logits, want))
        for row in range(2):
            gaps.append(check_next_token(f"decode step {i + 1}, sequence {row}",
                                         int(logits[row].argmax()), want[row], decode_errs[-1]))
    print(f"  decode: {len(inputs)} steps at batch 2 replayed from one CUDA graph holding "
          f"both shards, {decode_ms:.2f} ms/step (phase 5: {ref['decode_ms']:.2f}); eager "
          f"tp step {eager_ms:.2f} ms/step; captured logits bit-equal to the eager step's at "
          f"every step: {all(same)}, pools bit-equal: {same_pool}", flush=True)
    if not (all(same) and same_pool):
        raise AssertionError("the captured tp decode step and the eager one disagree")
    # The sharded paths keep the op-by-op chains: no layer kernel, eager
    # or in the graph.
    launches = {"flash_prefill": prefill_launches, "paged_decode": replays * decode_nodes,
                **add_counts(layer_launches(), layer_launches(step.graph, replays))}
    expected = {"flash_prefill": 2 * shard_launches(1, SHARD_TP, layers),
                "paged_decode": DECODE_STEPS * shard_launches(1, SHARD_TP, layers),
                **layer_expected(layers, 0)}
    print(f"  kernel launches on the tp path: {launches} ({replays} replays x {decode_nodes} "
          f"decode kernel nodes), expected {expected}", flush=True)
    if launches != expected or python_calls != 2 * shard_launches(1, SHARD_TP, layers):
        raise AssertionError(f"tp launches {launches}, expected {expected}; the decode "
                             f"wrapper's Python count {python_calls} (the capture's eager "
                             f"run and the capture only)")
    breakdown = {
        "miss": show_breakdown("tp miss under torch.profiler", walls["miss"],
                               device_breakdown(torch, lambda: miss(pools[1]), steps=1)),
        "hit": show_breakdown("tp hit under torch.profiler", walls["hit"],
                              device_breakdown(torch, lambda: hit(pools[1]), steps=1)),
        "decode_step": show_breakdown(
            "tp decode step (graph replay) under torch.profiler", decode_ms,
            device_breakdown(torch, lambda: step(inputs[-1][0], table, inputs[-1][1]),
                             steps=2)),
    }
    peak = torch.cuda.max_memory_allocated() / 1e9
    across.update(step_logits=got, pool=[x for _, x in pools[0].kv.distinct()],
                  errs=dict(errs, decode=max(decode_errs)), miss_ms=walls["miss"],
                  hit_ms=walls["hit"], decode_eager_ms=eager_ms)
    del step, pools, sharded, eager
    gc_cuda(torch)
    return {"launches": launches, "mesh": str(mesh), "shard_s": shard_s, "across_inputs": across,
            "miss_ms": walls["miss"], "hit_ms": walls["hit"], "decode_ms_per_step": decode_ms,
            "decode_eager_ms_per_step": eager_ms, "max_abs_err": errs,
            "decode_max_abs_err": max(decode_errs), "next_token_gaps": max(gaps),
            "breakdown_ms": breakdown, "max_memory_allocated_gb": peak}


def sharded_ring(torch, params, cfg, phase6):
    """12b: phase 6's prompt through the tp x sp ring over params cut
    over tp, both layouts, against the unsharded dense forward."""
    llama = port("models.llama")
    sharding, mesh_mod = port("parallel.sharding"), port("parallel.mesh")
    fc, rc = port("ops.flash_cuda"), port("ops.ring_flash_cuda")
    n = SHARD_TP * RING_SP
    mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=1, tp=SHARD_TP, sp=RING_SP), ["cuda:0"] * n)
    sharded = sharding.shard_tree(params, mesh, llama.param_pspecs(cfg))
    rng = torch.Generator().manual_seed(SEED + 1)  # phase 6's prompt
    tokens = torch.randint(1, cfg.vocab_size, (1, RING_TOKENS), generator=rng)
    print(f"  mesh {mesh}: {n} ranks on one card, {RING_TOKENS // RING_SP} tokens and "
          f"{cfg.n_heads // SHARD_TP} of {cfg.n_heads} heads a rank; the tp shards held once "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)", flush=True)
    dense = llama.forward(params, tokens, cfg)
    first = int(dense[0, -1].argmax())
    out = {"wall_ms": {}, "launches": {}, "max_abs_err_vs_dense": {}, "breakdown_ms": {}}
    for name, striped in (("striped", True), ("contiguous", False)):
        llama.forward(sharded, tokens, cfg, sp_mesh=mesh, ring_striped=striped)  # warm-up
        fc.flash_gqa_attention_cuda.launches = 0
        rc.flash_partial_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = llama.forward(sharded, tokens, cfg, sp_mesh=mesh, ring_striped=striped)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = {"ring_partial": rc.flash_partial_cuda.launches,
                    "flash_prefill": fc.flash_gqa_attention_cuda.launches}
        want = {"ring_partial": shard_launches(ring_steps(RING_SP, striped), SHARD_TP,
                                               cfg.n_layers), "flash_prefill": 0}
        print(f"  {name} tp x sp ring: {wall:.1f} ms (phase 6, sp {RING_SP} alone: "
              f"{phase6['wall_ms'][name]:.1f} ms); kernel launches {launches}", flush=True)
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected {want}")
        err = check_logits(f"{name} tp x sp ring vs the unsharded dense forward", logits, dense)
        check_next_token(f"{name} next token", int(logits[0, -1].argmax()), dense[0, -1], err)
        del logits
        out["wall_ms"][name], out["launches"][name] = wall, launches
        out["max_abs_err_vs_dense"][name] = err
        out["breakdown_ms"][name] = show_breakdown(
            f"{name} tp x sp ring under torch.profiler", wall, device_breakdown(
                torch, lambda s=striped: llama.forward(sharded, tokens, cfg, sp_mesh=mesh,
                                                       ring_striped=s), steps=1))
        gc_cuda(torch)
    print(f"  last-position token {first} (dense)", flush=True)
    del sharded, dense
    gc_cuda(torch)
    return out


def small_sharded_step(torch):
    """12c, small: phase 8's float32 configuration, one step over the
    reference's 8-device plan on the card against the unsharded step on
    the card, at phase 8's limits."""
    llama = port("models.llama")
    sharding, mesh_mod = port("parallel.sharding"), port("parallel.mesh")
    cfg = llama.LlamaConfig(vocab_size=1024, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, dtype="float32")
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(**SHARD_TRAIN_PLAN), ["cuda:0"] * 8)
    sharded = sharding.shard_tree(params, mesh, llama.param_pspecs(cfg))
    (tokens,) = train_batches(torch, cfg.vocab_size, 128, 1, SEED + 12)
    tokens = torch.cat((tokens, tokens.flip(1)))
    loss = float(llama.train_step(params, llama.make_optimizer(params), tokens, cfg))
    sloss = float(llama.train_step(sharded, llama.make_optimizer(sharded), tokens, cfg))
    loss_err = abs(sloss - loss) / abs(loss)
    grads = grad_tree(torch, params)
    sgrads = sharding.unshard_tree(sharding.grad_tree(sharded))
    g_err, g_worst, _, _ = leaves_close(torch, sgrads, grads, *SMALL_STEP_LIMITS)
    near_zero = {p: g.abs() <= SMALL_STEP_LIMITS[0] for p, g in grads.items()}
    p_err, p_worst, n_free, free_err = leaves_close(
        torch, sharding.unshard_tree(sharded), params, *SMALL_STEP_LIMITS, free=near_zero)
    print(f"  small float32 step (2 layers, d 256, B=2, T=128) on {mesh}, against the "
          f"unsharded step on the card: loss {sloss:.7f} vs {loss:.7f} (rel err "
          f"{loss_err:.3g}); gradients worst err/limit {g_worst:.3g}, leaves {p_worst:.3g} "
          f"({n_free} near-zero gradients held to 2*lr: max err {free_err:.3g})", flush=True)
    if not (loss_err <= SMALL_STEP_LOSS_REL and g_worst <= 1.0 and p_worst <= 1.0
            and free_err <= 2 * 3e-4):
        raise AssertionError("the sharded small step disagrees with the unsharded one")
    return {"loss_rel_err": loss_err, "grad_worst_err_over_limit": g_worst,
            "leaf_worst_err_over_limit": p_worst, "near_zero_grads": n_free}


def sharded_training_faults(torch, cfg, params, mesh, batches):
    """12c's planted faults, each on its own sharded copy of the initial
    params: (a) tp rank 1's attention output dropped (its slice of every
    layer's ``wo`` zeroed), the first loss; (b) tp rank 1's gradients
    lost at each of the steps, the losses and step 1's batch after them."""
    llama, sharding = port("models.llama"), port("parallel.sharding")
    sharded = sharding.shard_tree(params, mesh, llama.param_pspecs(cfg))
    layers = dict(sharded["layers"], wo=zero_tp_rank(torch, sharding, sharded["layers"]["wo"], 1))
    with torch.no_grad():
        dropped = float(llama.loss_fn(dict(sharded, layers=layers), batches[0], cfg))
    del layers
    opt = llama.make_optimizer(sharded)
    lost = []
    for batch in batches:
        opt.zero_grad(set_to_none=True)
        loss = llama.loss_fn(sharded, batch, cfg)
        loss.backward()
        for leaf in sharding.tree_leaves(sharded):
            for x in tp_rank_locals(leaf, 1):
                x.grad = None
        opt.step()
        lost.append(float(loss.detach()))
    with torch.no_grad():
        lost.append(float(llama.loss_fn(sharded, batches[0], cfg)))
    del opt, sharded
    gc_cuda(torch)
    return {"wo_dropped_first_loss": dropped, "grads_lost_losses": lost}


def sharded_training_and_restore(torch, cfg, phase9):
    """12c and 12d: three AdamW steps of the 8-layer Llama-3-8B-width
    model over the reference's 8-device plan, then its initial params,
    saved unsharded, restored onto a pp x tp layout and stepped once."""
    llama = port("models.llama")
    ckpt = port("models.checkpoint")
    sharding, mesh_mod = port("parallel.sharding"), port("parallel.mesh")
    fc = port("ops.flash_cuda")
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    batches = train_batches(torch, cfg.vocab_size, TRAIN_TOKENS, TRAIN_STEPS, SEED + 20)
    folder = tempfile.mkdtemp(prefix="chip_smoke_sharded_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(folder, params)
        save_s = time.perf_counter() - t0
        mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(**SHARD_TRAIN_PLAN), ["cuda:0"] * 8)
        faults = sharded_training_faults(torch, cfg, params, mesh, batches)
        sharded = sharding.shard_tree(params, mesh, llama.param_pspecs(cfg))
        del params
        gc_cuda(torch)
        opt = llama.make_optimizer(sharded)
        fc.flash_gqa_attention_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, walls = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(llama.train_step(sharded, opt, batch, cfg)))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            finite = math.isfinite(losses[-1]) and all(
                bool(t.isfinite().all()) for t in sharding.distinct_locals(sharded))
            if not finite:
                raise AssertionError(f"sharded step {len(losses)}: loss or a leaf not finite")
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = fc.flash_gqa_attention_cuda.launches
        with torch.no_grad():
            after = float(llama.loss_fn(sharded, batches[0], cfg))
        # Losses 1-3, then step 1's batch after the steps, each against
        # phase 9's: the first at SHARD_FIRST_LOSS_REL, the rest (the
        # updates' effect) at SHARD_LATER_LOSS_REL.
        ref = phase9["losses"] + [phase9["loss_after_steps"]]
        limits = [SHARD_FIRST_LOSS_REL] + [SHARD_LATER_LOSS_REL] * TRAIN_STEPS
        gaps = [rel_gap(a, b) for a, b in zip(losses + [after], ref)]
        wo_gap = rel_gap(faults["wo_dropped_first_loss"], ref[0])
        lost_gaps = [rel_gap(a, b) for a, b in zip(faults["grads_lost_losses"], ref)]
        print(f"  {cfg.n_layers} layers on {mesh}: losses {losses}, step 1's batch after them "
              f"{after!r} (phase 9, unsharded: {phase9['losses']}, "
              f"{phase9['loss_after_steps']!r}); relative gaps {[f'{g:.3g}' for g in gaps]} "
              f"(limits {[f'{x:.3g}' for x in limits]}); ms a step "
              f"{[round(w, 1) for w in walls]} (phase 9: "
              f"{[round(w, 1) for w in phase9['step_ms']]}); peak {peak:.2f} GB (phase 9: "
              f"{phase9['max_memory_allocated_gb']:.2f}); prefill kernel launches {launches}",
              flush=True)
        print(f"  planted faults: tp rank 1's wo slices zeroed, first loss "
              f"{faults['wo_dropped_first_loss']!r} ({wo_gap:.3g} off, limit "
              f"{limits[0]:.3g}); tp rank 1's gradients lost at every step, losses and step 1's "
              f"batch after them {faults['grads_lost_losses']} (gaps "
              f"{[f'{g:.3g}' for g in lost_gaps]})", flush=True)
        if not all(g <= x for g, x in zip(gaps, limits)) or launches:
            raise AssertionError("sharded training: a loss off phase 9's, or the kernel launched")
        if not (wo_gap > limits[0] and any(g > x for g, x in zip(lost_gaps[1:], limits[1:]))):
            raise AssertionError("sharded training: a planted fault passed the loss limits")
        training = {"mesh": str(mesh), "losses": losses, "loss_after_steps": after,
                    "step_ms": walls, "loss_rel_gaps": gaps, "loss_rel_limits": limits,
                    "fault_wo_dropped_first_loss_gap": wo_gap,
                    "fault_grads_lost_gaps": lost_gaps, "max_memory_allocated_gb": peak}
        del opt
        gc_cuda(torch)

        phase(f"12d. sharded: restore the saved params onto {SHARD_RESTORE_PLAN} targets")
        rmesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(**SHARD_RESTORE_PLAN), ["cuda:0"] * 4)
        target = ckpt.abstract_like(sharded, named_shardings(sharding, rmesh,
                                                             llama.param_pspecs(cfg)))
        del sharded
        gc_cuda(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = ckpt.restore_checkpoint(folder, target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        saved = ckpt.restore_checkpoint(folder)  # the saved tensors, on the host
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    bad = tree_shard_mismatches(torch, restored, saved)
    n_locals = len(sharding.distinct_locals(restored))
    print(f"  save (unsharded) {save_s:.2f} s; restore onto {rmesh} {restore_s:.2f} s; "
          f"{n_locals} local tensors, each bit-equal to its slice of the saved tensor: "
          f"{not bad}", flush=True)
    if bad:
        raise AssertionError(f"restored shards differ: {bad}")
    del saved
    loss = float(llama.train_step(restored, llama.make_optimizer(restored), batches[0], cfg))
    finite = math.isfinite(loss) and all(
        bool(t.isfinite().all()) for t in sharding.distinct_locals(restored))
    print(f"  one step from the restored state on {rmesh}: loss {loss!r} (the 8-device "
          f"plan's first: {losses[0]!r}), every leaf finite: {finite}", flush=True)
    if not finite:
        raise AssertionError("the step from the restored state is not finite")
    del restored, target
    gc_cuda(torch)
    return {"training": training,
            "restore": {"mesh": str(rmesh), "save_s": save_s, "restore_s": restore_s,
                        "local_tensors": n_locals, "step_loss": loss}}


def constrain_probe(torch, moe, sharding, mesh_mod, probe, mesh) -> str:
    """Inside ``activate(mesh)``: ``moe._constrain`` places ``probe`` on
    the active mesh's ranks, each local on the card and bit-equal to its
    slice.  Returns what it found."""
    placed = moe._constrain(probe, sharding.P("ep", "tp"))
    ok = (mesh_mod.mesh_is_active() and mesh_mod.active_mesh() is mesh
          and isinstance(placed, sharding.Sharded) and placed.mesh is mesh
          and not shard_mismatches(torch, placed, probe)
          and all(t.is_cuda for _, t in placed.distinct()))
    if not ok:
        raise AssertionError("moe._constrain inside activate(mesh) did not place its input "
                             "on the mesh's ranks")
    return f"{len(placed.distinct())} locals of {placed.local_shape} on the card, bit-equal"


def sharded_moe(torch):
    """12e: MoEConfig() over dp 1 x ep 2 x tp 2 inside activate(mesh):
    float32 against the unsharded float32 forward (expert picks,
    logits), the bf16 forward on the prefill kernel, three train steps."""
    moe = port("models.moe")
    sharding, mesh_mod = port("parallel.sharding"), port("parallel.mesh")
    fc = port("ops.flash_cuda")
    cfg = moe.MoEConfig()
    params = moe.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    (tokens,) = train_batches(torch, cfg.vocab_size, MOE_TOKENS, 1, SEED + 30)
    mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(**SHARD_MOE_PLAN), ["cuda:0"] * 4)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = map_state(torch, params, lambda leaf: leaf.float())
    outputs = {}
    probe = torch.arange(8.0, device="cuda").reshape(4, 2)
    with mesh_mod.activate(mesh):
        placed = constrain_probe(torch, moe, sharding, mesh_mod, probe, mesh)
        sharded32 = sharding.shard_tree(params32, mesh, moe.param_pspecs(cfg))
        for name, tree in (("unsharded", params32), ("sharded", sharded32)):
            with recorded_routes(torch, moe) as (records, _), torch.no_grad():
                logits, aux = moe.forward(tree, tokens, cfg32)
            outputs[name] = (logits, float(aux), records)
        del sharded32, params32
        (want, want_aux, want_routes), (got, got_aux, got_routes) = (
            outputs["unsharded"], outputs["sharded"])
        differ = differing_tokens(got_routes, want_routes)
        n_differ = int(differ.sum())
        print(f"  mesh {mesh}, inside activate(mesh); float32 forward over {MOE_TOKENS} "
              f"tokens, sharded vs unsharded: tokens routed to other experts in some layer "
              f"{n_differ} (limit {MOE_PICK_LIMIT:.0%}); aux {got_aux!r} vs {want_aux!r}",
              flush=True)
        if n_differ > MOE_PICK_LIMIT * MOE_TOKENS:
            raise AssertionError(f"sharded MoE: {n_differ} tokens routed otherwise")
        agree = ~differ
        err = check_logits(f"sharded vs unsharded float32 logits, {int(agree.sum())} tokens "
                           f"routed alike", got[0, agree], want[0, agree])
        check_next_token("sharded float32 next token", int(got[0, -1].argmax()), want[0, -1],
                         err)
        del outputs, got, want
        gc_cuda(torch)

        sharded = sharding.shard_tree(params, mesh, moe.param_pspecs(cfg))
        del params
        with torch.no_grad():
            moe.forward(sharded, tokens, cfg)  # warm-up
            fc.flash_gqa_attention_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, aux = moe.forward(sharded, tokens, cfg)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = fc.flash_gqa_attention_cuda.launches
        want_launches = shard_launches(1, mesh.size("tp"), cfg.n_layers)
        finite = bool(logits.isfinite().all()) and math.isfinite(float(aux))
        print(f"  bf16 sharded forward on the prefill kernel: {wall:.1f} ms, prefill launches "
              f"{launches} (expected {want_launches}), finite: {finite}", flush=True)
        if launches != want_launches or not finite:
            raise AssertionError("sharded bf16 MoE forward: launches or values wrong")
        del logits
        opt = moe.make_optimizer(sharded)
        losses, step_ms = [], []
        for batch in train_batches(torch, cfg.vocab_size, MOE_TRAIN_TOKENS, TRAIN_STEPS,
                                   SEED + 31):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(moe.train_step(sharded, opt, batch, cfg)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if not math.isfinite(losses[-1]) or not all(
                    bool(t.isfinite().all()) for t in sharding.distinct_locals(sharded)):
                raise AssertionError(f"sharded MoE step: loss {losses[-1]} or a leaf not finite")
        print(f"  bf16 sharded train steps at T={MOE_TRAIN_TOKENS}: losses {losses}, ms a step "
              f"{[round(w, 1) for w in step_ms]}", flush=True)
    outside = moe._constrain(probe, sharding.P("ep", "tp"))
    print(f"  moe._constrain inside activate(mesh): {placed}; outside: returns its input: "
          f"{outside is probe and not mesh_mod.mesh_is_active()}", flush=True)
    if outside is not probe or mesh_mod.mesh_is_active():
        raise AssertionError("moe._constrain outside a mesh is not a no-op")
    del sharded, opt
    gc_cuda(torch)
    return {"launches": {"flash_prefill": launches}, "mesh": str(mesh),
            "tokens_routed_otherwise": n_differ, "float32_max_abs_err": err,
            "bf16_forward_ms": wall, "train_losses": losses, "train_step_ms": step_ms}


# -------------------------------------------------------------- phase 12f


def across_launches(name: str, layers: int, decode_steps: int = DECODE_STEPS,
                    world: int = ACROSS_WORLD) -> dict:
    """{kernel: launches} of one process in phase 12f's timed run on mesh
    ``name``: tp across processes, one head shard a process, runs every
    layer of the miss, the hit and each decode step; pp, its stage's
    layers; the default fleet (dp), every layer of its one row's prefill
    and decode steps; the MoE (ici tp 2 x dcn ep 2), each of its two tp
    ranks' attention in every layer of one forward."""
    if name == "tp":
        return {"flash_prefill": 2 * layers, "paged_decode": decode_steps * layers}
    if name == "pp":
        per = layers // world
        return {"flash_prefill": 2 * per, "paged_decode": decode_steps * per}
    if name == "dp":
        return {"flash_prefill": layers, "paged_decode": decode_steps * layers}
    if name == "moe":
        return {"flash_prefill": ACROSS_MOE[0]["tp"] * layers}
    raise ValueError(f"no phase 12f mesh {name!r}")


def across_launches_by_path(meshes: dict) -> dict:
    """{kernel: {launches_by_path key: launches over the processes}} of
    phase 12f's meshes ({name: [each process's {kernel: launches}]})."""
    out = {}
    for name, per_process in meshes.items():
        key = "moe_forward_processes_ep_tp" if name == "moe" else f"llama_serving_processes_{name}"
        for kernel in per_process[0]:
            out.setdefault(kernel, {})[key] = sum(p[kernel] for p in per_process)
    return out


def logits_gap(torch, got, ref) -> dict:
    """``got`` against ``ref``: bit-equal, the largest |difference|, the
    model-level tolerance (2^-4 of the largest reference logit, as
    ``check_logits``) and whether ``got`` is finite."""
    return {"bit_equal": got.shape == ref.shape and bool(torch.equal(got, ref)),
            "max_abs_err": float((got.float() - ref.float()).abs().max()),
            "tol": 2.0**-4 * max(1.0, float(ref.float().abs().max())),
            "finite": bool(got.float().isfinite().all())}


def pool_gap(torch, got, ref) -> dict:
    """``logits_gap`` of two pools, a layer at a time (no float32 copy of
    a whole pool)."""
    gaps = [logits_gap(torch, a, b) for a, b in zip(got, ref)]
    return {"bit_equal": all(g["bit_equal"] for g in gaps),
            "max_abs_err": max(g["max_abs_err"] for g in gaps),
            "tol": max(g["tol"] for g in gaps), "finite": all(g["finite"] for g in gaps)}


def gap_held(gap: dict, exact: bool) -> bool:
    """Whether a ``logits_gap`` passes: bit for bit, or (unless
    ``exact``) finite and within the model-level tolerance."""
    return gap["bit_equal"] or (not exact and gap["finite"] and gap["max_abs_err"] <= gap["tol"])


def transfers_by_kind(records) -> dict:
    """{kind: calls, bytes out and in, host ms a call (from its start to
    the end of its wait), the staging copies' device ms each way} of a
    ``TransferLog``'s records."""
    out = {}
    for rec in records:
        row = out.setdefault(rec["kind"], {"calls": 0, "bytes_out": 0, "bytes_in": 0,
                                           "span_ms": 0.0, "d2h_ms": 0.0, "h2d_ms": 0.0})
        row["calls"] += 1
        for key in ("bytes_out", "bytes_in", "span_ms", "d2h_ms", "h2d_ms"):
            row[key] += rec[key]
    for row in out.values():
        row["ms_per_call"] = row["span_ms"] / row["calls"]
    return out


def transfers_text(by_kind: dict) -> str:
    return "; ".join(
        f"{kind} {row['calls']} calls, {row['bytes_out'] / 2**20:.1f} MiB out / "
        f"{row['bytes_in'] / 2**20:.1f} in, {row['ms_per_call']:.2f} ms a call, staging "
        f"{row['d2h_ms']:.1f} + {row['h2d_ms']:.1f} ms" for kind, row in sorted(by_kind.items()))


def across_mesh(torch, dist, rank: int, name: str, params, cfg, t) -> dict:
    """Phase 12f in one worker, one Llama mesh: the requests once with
    process 0's kernel calls held against the plain version, then timed
    (walls, launches, transfers by kind), their logits and this
    process's pool against the references, and one profiled miss."""
    import numpy as np

    llama, mesh_mod = port("models.llama"), port("parallel.mesh")
    sharding, pool_mod = port("parallel.sharding"), port("models.kv_cache_pool")
    fc, pc, pg = port("ops.flash_cuda"), port("ops.paged_decode_cuda"), port(
        "parallel.process_group")
    plans, card = ACROSS_MESHES[name], str(params["embed"].device)
    if plans is None:  # the reference's default fleet
        mesh = mesh_mod.make_hybrid_mesh(devices=[card])
    else:
        mesh = mesh_mod.make_hybrid_mesh(mesh_mod.MeshPlan(**plans[0]),
                                         mesh_mod.MeshPlan(**plans[1]), devices=[card])
    sharded = sharding.share_tree(params, mesh, llama.param_pspecs(cfg))
    req = t["fleet"] if name == "dp" else t["phase5"]
    spec = sharding.P(None, None, None, None, "tp", None)
    pool = pool_mod.KVCachePool(
        pool_mod.KVCachePoolConfig(cfg.n_layers, req["blocks"], cfg.block_size, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.dtype),
        sharding=sharding.NamedSharding(mesh, spec))
    transport = pg.transport(mesh)
    coord = next(c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c))
    d = coord[mesh.axis_names.index("dp")]
    if name == "dp":
        calls = [("miss", lambda: llama.prefill_paged(sharded, req["tokens"], pool.kv,
                                                      req["prefill_table"], cfg)[0])]
    else:
        calls = [("miss", lambda: llama.prefill_paged(
                     sharded, torch.tensor([req["prompt_a"]]), pool.kv,
                     torch.tensor([req["ids_a"]], dtype=torch.int32), cfg)[0]),
                 ("hit", lambda: llama.prefill_continue(
                     sharded, torch.tensor([req["prompt_b"][PREFIX_TOKENS:]]), pool.kv,
                     torch.tensor([req["ids_b"]], dtype=torch.int32), PREFIX_TOKENS, cfg)[0])]

    (_, kv), = pool.kv.distinct()

    def serve(timed: bool) -> dict:
        walls, logits = {}, {}
        for kind, call in calls:
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            local = call().locals[coord]
            torch.cuda.synchronize()
            walls[kind] = (time.perf_counter() - t0) * 1e3
            logits[kind] = local[:, -REF_TAIL:].clone() if kind == "miss" else local
            del local
        if name == "dp":  # the prefill's blocks against the parent's right after its prefill
            ids = req["prefill_table"].reshape(-1).long()
            blocks = kv[:, ids]
            logits["prefill_pool_equal"] = bool(torch.equal(blocks, req["prefill_pool"][:, ids]))
            logits["prefill_pool_unsharded"] = pool_gap(
                torch, blocks, req["unsharded_prefill_pool"][:, ids])
            del blocks
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits["decode"] = [llama.decode_step(sharded, tokens, pool.kv, req["table"], ctx,
                                              cfg)[0].locals[coord]
                            for tokens, ctx in req["decode_inputs"]]
        torch.cuda.synchronize()
        walls["decode"] = (time.perf_counter() - t0) * 1e3 / len(req["decode_inputs"])
        return {"walls": walls, "logits": logits}

    out = {"mesh": repr(mesh), "crossing": list(mesh.crossing_axes()), "backend": transport.backend}
    # The requests once, process 0's kernel calls held (and every process
    # warmed up): the others run beside it.
    if rank == 0:
        with HeldCalls(llama, "flash_gqa_attention_cuda", fc.flash_gqa_attention_plain,
                       "prefill", tag="12f") as prefill, HeldCalls(
                llama, "paged_decode_attention_cuda", pc.paged_decode_attention_plain,
                "decode", tag="12f") as decode:
            serve(False)
        out["held"] = {"prefill": prefill.hold(f"12f {name}, process 0: prefill kernel calls"),
                       "decode": decode.hold(f"12f {name}, process 0: decode kernel calls")}
        del prefill, decode
    else:
        serve(False)
    dist.barrier()
    fc.flash_gqa_attention_cuda.launches = 0
    pc.paged_decode_attention_cuda.launches = 0
    transport.log.clear()
    run = serve(True)
    out["launches"] = {"flash_prefill": fc.flash_gqa_attention_cuda.launches,
                       "paged_decode": pc.paged_decode_attention_cuda.launches}
    out["transfers"] = transfers_by_kind(transport.log.records())
    out["walls"] = run["walls"]
    refs = t["refs"][name]
    rows = slice(d, d + 1) if name == "dp" else slice(None)
    out["logits"] = {kind: logits_gap(torch, run["logits"][kind], refs[kind][rows])
                     for kind, _ in calls}
    out["logits"]["decode"] = [logits_gap(torch, got, want[rows]) for got, want in
                               zip(run["logits"]["decode"], refs["decode"])]
    out["tokens"] = {kind: int(run["logits"][kind][0, -1].argmax()) for kind, _ in calls}
    out["tokens"]["decode"] = [x.argmax(-1).tolist() for x in run["logits"]["decode"]]
    out["prefill_pool_equal"] = run["logits"].get("prefill_pool_equal")
    if name == "dp":  # the same against the unsharded entry points' run
        unsharded = t["refs"]["dp_unsharded"]
        out["vs_unsharded"] = {
            "miss": logits_gap(torch, run["logits"]["miss"], unsharded["miss"][rows]),
            "decode": [logits_gap(torch, got, want[rows]) for got, want in
                       zip(run["logits"]["decode"], unsharded["decode"])],
            "prefill_pool": run["logits"]["prefill_pool_unsharded"]}
    del run
    # This process's pool against the reference's (tp: 12a's rank slice;
    # dp: the parent's whole pool), and, where every process holds a whole
    # copy (pp, dp), against the other process's copy, a layer at a time.
    if name in ("pp", "dp"):
        axis = "pp" if name == "pp" else "dp"
        out["pool_copies_equal"] = all(
            all(torch.equal(parts[0], part) for part in parts[1:])
            for parts in (transport.all_gather(kv[i], axis, coord) for i in range(cfg.n_layers)))
    if name != "pp":
        want = t["pool12a"][coord[mesh.axis_names.index("tp")]] if name == "tp" else req["pool"]
        out["pool_gap"] = pool_gap(torch, kv, want)
    if name == "dp":
        out["vs_unsharded"]["pool"] = pool_gap(torch, kv, req["unsharded_pool"])
    out["pool_checksum"] = int(kv.view(torch.int16).sum(dtype=torch.int64))
    gc_cuda(torch)
    dist.barrier()
    busy = device_breakdown(torch, lambda: calls[0][1]().locals[coord], steps=1)
    out["device_ms"], out["kernels_ms"] = busy["device_ms"], busy["kernels_ms"]
    out["profiled_wall_ms"] = busy["profiled_wall_ms"]
    out["idle_share"] = 1 - busy["device_ms"] / busy["profiled_wall_ms"]
    dist.barrier()
    del sharded, pool, kv
    gc_cuda(torch)
    return out


def across_moe(torch, dist, rank: int, params, tokens, routes, ref_logits, ref_aux) -> dict:
    """Phase 12f's MoE in one worker: ``MoEConfig()`` over ici tp 2 x dcn
    ep 2, its expert picks recorded, once with process 0's prefill calls
    held, then timed and profiled."""
    import numpy as np

    moe, llama, mesh_mod = port("models.moe"), port("models.llama"), port("parallel.mesh")
    sharding, fc = port("parallel.sharding"), port("ops.flash_cuda")
    pg = port("parallel.process_group")
    cfg = moe.MoEConfig()
    ici, dcn = ACROSS_MOE
    mesh = mesh_mod.make_hybrid_mesh(mesh_mod.MeshPlan(**ici), mesh_mod.MeshPlan(**dcn),
                                     devices=[str(params["embed"].device)] * ici["tp"])
    sharded = sharding.share_tree(params, mesh, moe.param_pspecs(cfg))
    coord = next(c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c))
    transport = pg.transport(mesh)

    def forward():
        with torch.no_grad():
            logits, aux = moe.forward(sharded, tokens, cfg)
        return logits.locals[coord], aux

    out = {"mesh": repr(mesh), "crossing": list(mesh.crossing_axes())}
    with recorded_routes(torch, moe) as (records, _):
        if rank == 0:
            with HeldCalls(llama, "flash_gqa_attention_cuda", fc.flash_gqa_attention_plain,
                           "prefill", tag="12f") as held:
                forward()
            out["held"] = {"prefill": held.hold("12f MoE, process 0: prefill kernel calls")}
            del held
        else:
            forward()
    dist.barrier()
    fc.flash_gqa_attention_cuda.launches = 0
    transport.log.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, aux = forward()
    torch.cuda.synchronize()
    out["wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = {"flash_prefill": fc.flash_gqa_attention_cuda.launches}
    out["transfers"] = transfers_by_kind(transport.log.records())
    differ = differing_tokens(records, routes)
    out["routed_otherwise"] = int(differ.sum())
    agree = ~differ
    out["logits"] = logits_gap(torch, logits, ref_logits)
    out["logits_routed_alike"] = logits_gap(torch, logits[0, agree], ref_logits[0, agree])
    out["aux"], out["aux_equal"] = float(aux), bool(torch.equal(aux, ref_aux))
    out["token"] = int(logits[0, -1].argmax())
    del logits
    dist.barrier()
    busy = device_breakdown(torch, forward, steps=1)
    out["device_ms"], out["profiled_wall_ms"] = busy["device_ms"], busy["profiled_wall_ms"]
    out["idle_share"] = 1 - busy["device_ms"] / busy["profiled_wall_ms"]
    dist.barrier()
    return out


def first_layers(params, n: int):
    """The params of the first ``n`` layers: each stacked leaf a view."""
    return {"embed": params["embed"], "layers": {k: v[:n] for k, v in params["layers"].items()},
            "ln_f": params["ln_f"]}


def share_report(torch, sharding, params, mesh, specs) -> dict:
    """What ``sharding.share_tree`` of the plain ``params`` over ``mesh``
    holds in this process: the plain tree's bytes, the bytes of the
    distinct locals that are views of the plain leaves and of those it
    copied (tp slices), and the memory the share allocated."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    shared = sharding.share_tree(params, mesh, specs)
    grew = torch.cuda.memory_allocated() - before
    views = copies = 0
    for leaf, cut in zip(sharding.tree_leaves(params), sharding.tree_leaves(shared)):
        for _, t in cut.distinct():
            n = t.numel() * t.element_size()
            if t.untyped_storage().data_ptr() == leaf.untyped_storage().data_ptr():
                views += n
            else:
                copies += n
    del shared
    plain = sum(leaf.numel() * leaf.element_size() for leaf in sharding.tree_leaves(params))
    return {"plain_bytes": plain, "view_bytes": views, "copied_bytes": copies,
            "allocated_bytes": grew}


def plain_ring_launches(ranks, sp: int, striped: bool, heads: int, layers: int) -> int:
    """Partial launches of one process's ring ranks ``ranks`` (sp
    indices) over ``layers`` layers and ``heads`` head shards: rank s
    launches s + 1 times a layer contiguous (the steps that see a key),
    sp times striped; over every rank, ``ring_steps``."""
    return sum(sp if striped else s + 1 for s in ranks) * heads * layers


def plain_block_prelude(torch, sharding, params, mesh, specs) -> tuple:
    """A plain block's start in a worker: this process's sp and tp
    indices, the share's report, and the allocated bytes from which its
    peak is read."""
    import numpy as np

    gc_cuda(torch)
    owned = [c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c)]
    ranks = {a: sorted({c[mesh.axis_names.index(a)] for c in owned}) for a in ("sp", "tp")}
    share = share_report(torch, sharding, params, mesh, specs)
    torch.cuda.reset_peak_memory_stats()
    return ranks, share, torch.cuda.memory_allocated()


def plain_moe_over_sp(torch, dist, rank: int, params, tokens, ref) -> dict:
    """12f's MoE block in one worker: plain ``MoEConfig()`` params over ici
    sp 2 x dcn sp 2, contiguous, once with each layer's expert picks and
    routing input recorded (process 0's partials held), then timed
    (wall, launches, transfers) and profiled; each local chunk of its
    logits and its aux against the parent's one-process plain ring."""
    moe, mesh_mod, sharding = port("models.moe"), port("parallel.mesh"), port("parallel.sharding")
    rc, pg = port("ops.ring_flash_cuda"), port("parallel.process_group")
    cfg = moe.MoEConfig()
    ici, dcn = PLAIN_MOE_MESH
    mesh = mesh_mod.make_hybrid_mesh(mesh_mod.MeshPlan(**ici), mesh_mod.MeshPlan(**dcn),
                                     devices=[str(params["embed"].device)] * ici["sp"])
    transport = pg.transport(mesh)
    ranks, share, base = plain_block_prelude(torch, sharding, params, mesh,
                                             moe.param_pspecs(cfg))
    out = {"mesh": repr(mesh), "crossing": list(mesh.crossing_axes()), "ranks": ranks,
           "share": share}

    def forward():
        with torch.no_grad():
            return moe.forward(params, tokens, cfg, sp_mesh=mesh)

    with recorded_routes(torch, moe, fingerprints=True) as (picks, inputs):
        if rank == 0:
            out["held"] = hold_partials(torch, forward, tag="12f plain MoE")
        else:
            forward()
            torch.cuda.synchronize()
    want_picks, want_inputs = ref["routes"]
    out["routed_otherwise"] = int(differing_tokens(picks, want_picks).sum())
    out["first_layer_input_differs"] = next(
        (i for i, (a, b) in enumerate(zip(inputs, want_inputs)) if a != b), None)
    dist.barrier()
    rc.flash_partial_cuda.launches = 0
    transport.log.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, aux = forward()
    torch.cuda.synchronize()
    out["wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = rc.flash_partial_cuda.launches
    out["transfers"] = transfers_by_kind(transport.log.records())
    tl = tokens.shape[1] // mesh.size("sp")
    k = mesh.axis_names.index("sp")
    out["logits"] = {c[k]: logits_gap(torch, local, ref["logits"][:, c[k] * tl:(c[k] + 1) * tl])
                     for c, local in logits.distinct()}
    out["aux"], out["aux_equal"] = float(aux), bool(torch.equal(aux, ref["aux"]))
    del logits
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    dist.barrier()
    busy = device_breakdown(torch, forward, steps=1)
    out["device_ms"], out["profiled_wall_ms"] = busy["device_ms"], busy["profiled_wall_ms"]
    out["idle_share"] = 1 - busy["device_ms"] / busy["profiled_wall_ms"]
    dist.barrier()
    return out


def plain_llama_over_tp_sp(torch, dist, rank: int, params, cfg, tokens, ref) -> dict:
    """12f's Llama block in one worker: the first ``PLAIN_LLAMA_LAYERS``
    layers' plain params over ici tp 2 x dcn sp 2, both layouts, each
    once with process 0's partials held, then timed and profiled; each
    local chunk's fingerprint against the parent's single controller on
    the same layout, and the chunk against the dense forward."""
    llama, mesh_mod, sharding = port("models.llama"), port("parallel.mesh"), port(
        "parallel.sharding")
    rc, pg = port("ops.ring_flash_cuda"), port("parallel.process_group")
    cut = dataclasses.replace(cfg, n_layers=PLAIN_LLAMA_LAYERS)
    plain = first_layers(params, PLAIN_LLAMA_LAYERS)
    ici, dcn = PLAIN_LLAMA_MESH
    mesh = mesh_mod.make_hybrid_mesh(mesh_mod.MeshPlan(**ici), mesh_mod.MeshPlan(**dcn),
                                     devices=[str(params["embed"].device)] * ici["tp"])
    transport = pg.transport(mesh)
    ranks, share, base = plain_block_prelude(torch, sharding, plain, mesh,
                                             llama.param_pspecs(cut))
    out = {"mesh": repr(mesh), "crossing": list(mesh.crossing_axes()), "ranks": ranks,
           "share": share, "layouts": {}}
    R, k = mesh.size("sp"), mesh.axis_names.index("sp")
    tl = tokens.shape[1] // R
    for name, striped in (("contiguous", False), ("striped", True)):
        def forward(striped=striped):
            with torch.no_grad():
                return llama.forward(plain, tokens, cut, sp_mesh=mesh, ring_striped=striped)

        row = {}
        if rank == 0:
            row["held"] = hold_partials(torch, forward, tag=f"12f plain Llama {name}")
        else:
            forward()
            torch.cuda.synchronize()
        dist.barrier()
        rc.flash_partial_cuda.launches = 0
        transport.log.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = forward()
        torch.cuda.synchronize()
        row["wall_ms"] = (time.perf_counter() - t0) * 1e3
        row["launches"] = rc.flash_partial_cuda.launches
        row["transfers"] = transfers_by_kind(transport.log.records())
        row["chunks"] = {}
        for c, local in logits.distinct():
            s = c[k]
            dense = ref["dense"][:, s::R] if striped else ref["dense"][:, s * tl:(s + 1) * tl]
            row["chunks"][s] = {"bit_equal": fingerprint(torch, local) == ref["prints"][name][s],
                                "dense": logits_gap(torch, local, dense)}
            if s == R - 1:  # the chunk of position T - 1, in either layout
                row["token"] = int(local[0, -1].argmax())
        del logits
        dist.barrier()
        busy = device_breakdown(torch, forward, steps=1)
        row["device_ms"], row["profiled_wall_ms"] = busy["device_ms"], busy["profiled_wall_ms"]
        row["idle_share"] = 1 - busy["device_ms"] / busy["profiled_wall_ms"]
        out["layouts"][name] = row
        dist.barrier()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    return out


def plain_references(torch, params, cfg, moe_args) -> tuple:
    """What 12f's plain blocks are held to, made in the parent before the
    workers start: the MoE's one-process plain ring forward (phase 11's
    bf16 forward over ``MeshPlan(sp=RING_SP)``) with each layer's expert
    picks and routing input's fingerprint; the cut Llama's single
    controller on the merged tp x sp mesh with ``shard_tree`` params,
    both layouts, as the fingerprint of each ring rank's chunk (in the
    layout's order), and its dense forward.  Returns (the blocks'
    inputs, the parent's walls)."""
    llama, moe = port("models.llama"), port("models.moe")
    sharding, mesh_mod = port("parallel.sharding"), port("parallel.mesh")
    dev = params["embed"].device
    walls = {}
    mcfg = moe.MoEConfig()
    ring_mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=1, sp=RING_SP), [str(dev)] * RING_SP)
    with torch.no_grad():
        # The warm-up records the picks; the timed forward records nothing.
        with recorded_routes(torch, moe, fingerprints=True) as routes:
            moe.forward(moe_args["params"], moe_args["tokens"], mcfg, sp_mesh=ring_mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mlogits, maux = moe.forward(moe_args["params"], moe_args["tokens"], mcfg,
                                    sp_mesh=ring_mesh)
        torch.cuda.synchronize()
        walls["moe_ring_ms"] = (time.perf_counter() - t0) * 1e3
    cut = dataclasses.replace(cfg, n_layers=PLAIN_LLAMA_LAYERS)
    plain = first_layers(params, PLAIN_LLAMA_LAYERS)
    tokens = torch.randint(1, cfg.vocab_size, (1, RING_TOKENS),
                           generator=torch.Generator().manual_seed(SEED + 1))  # phase 6's
    R = PLAIN_LLAMA_MESH[1]["sp"]
    merged = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=1, tp=SHARD_TP, sp=R),
                                [str(dev)] * (SHARD_TP * R))
    sharded = sharding.shard_tree(plain, merged, llama.param_pspecs(cut))
    tl, prints = RING_TOKENS // R, {}
    with torch.no_grad():
        for name, striped in (("contiguous", False), ("striped", True)):
            llama.forward(sharded, tokens, cut, sp_mesh=merged, ring_striped=striped)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = llama.forward(sharded, tokens, cut, sp_mesh=merged, ring_striped=striped)
            torch.cuda.synchronize()
            walls[f"llama_{name}_ms"] = (time.perf_counter() - t0) * 1e3
            prints[name] = [fingerprint(torch, logits[:, s::R] if striped
                                        else logits[:, s * tl:(s + 1) * tl]) for s in range(R)]
            del logits
        del sharded
        gc_cuda(torch)
        llama.forward(plain, tokens, cut)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense = llama.forward(plain, tokens, cut)
        torch.cuda.synchronize()
        walls["llama_dense_ms"] = (time.perf_counter() - t0) * 1e3
    gc_cuda(torch)
    inputs = {"moe": {"params": moe_args["params"], "tokens": moe_args["tokens"],
                      "ref": {"logits": mlogits, "aux": maux, "routes": routes}},
              "llama": {"params": params, "cfg": cfg, "tokens": tokens,
                        "ref": {"prints": prints, "dense": dense}}}
    return inputs, walls


def across_process_run(torch, dist, rank, params, cfg, t, moe_args, plain_args) -> dict:
    """A worker of phase 12f: the three Llama meshes, the MoE, then the
    plain params' MoE and Llama blocks."""
    out = {"meshes": {}}
    for name in ACROSS_MESHES:
        out["meshes"][name] = across_mesh(torch, dist, rank, name, params, cfg, t)
    out["moe"] = across_moe(torch, dist, rank, **moe_args)
    gc_cuda(torch)
    out["plain_moe"] = plain_moe_over_sp(torch, dist, rank, **plain_args["moe"])
    gc_cuda(torch)
    out["plain_llama"] = plain_llama_over_tp_sp(torch, dist, rank, **plain_args["llama"])
    gc_cuda(torch)
    return out


def across_references(torch, params, cfg, p5, a12) -> tuple:
    """What phase 12f's workers are held to, made in the parent before
    they start: for tp across processes, 12a's tp 2 logits and pool; for
    pp, phase 5's logits; for the default fleet, the parent's batch-2
    prefill of A's prompt and a second one from ``ACROSS_SEED`` over the
    same layout on one process (dp 2, both ranks on the card), its eager
    decode steps, and that pool, and the unsharded entry points' run of
    the same prompts and decode inputs with its pools; for the MoE, 12e's single
    controller (``MoEConfig()`` on ``SHARD_MOE_PLAN``, every rank on the
    card) rerun, with its expert picks.  Returns (the workers' inputs,
    the MoE's, the parent's walls)."""
    llama, moe, pool_mod = port("models.llama"), port("models.moe"), port("models.kv_cache_pool")
    sharding, mesh_mod = port("parallel.sharding"), port("parallel.mesh")
    bs, dev = cfg.block_size, params["embed"].device
    rng = torch.Generator().manual_seed(ACROSS_SEED)
    second = torch.randint(1, cfg.vocab_size, (len(p5["prompt_a"]),), generator=rng).tolist()
    prompts = torch.tensor([p5["prompt_a"], second], device=dev)
    per_row = len(p5["prompt_a"]) // bs + 1  # the prefill's blocks and one for the decode steps
    table = (torch.arange(per_row)[None] + per_row * torch.arange(2)[:, None]).to(
        dev, torch.int32)
    # The fleet's layout on one process: dp over the ranks on this card,
    # the sharded path the workers run (the unsharded entry points take
    # the fused layer kernels, whose RMSNorm rounds otherwise).
    mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=ACROSS_WORLD), [str(dev)] * ACROSS_WORLD)
    fleet = sharding.share_tree(params, mesh, llama.param_pspecs(cfg))
    pool = pool_mod.KVCachePool(pool_mod.KVCachePoolConfig(
        cfg.n_layers, 2 * per_row, bs, cfg.n_kv_heads, cfg.head_dim, cfg.dtype),
        sharding=sharding.NamedSharding(mesh, sharding.P(None, None, None, None, "tp", None)))
    (_, kv), = pool.kv.distinct()
    walls = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = llama.prefill_paged(fleet, prompts, pool.kv, table[:, :per_row - 1], cfg)[0]
    torch.cuda.synchronize()
    walls["fleet_miss_ms"] = (time.perf_counter() - t0) * 1e3
    prefill_pool = kv.clone()
    tails = logits[:, -REF_TAIL:].clone()
    tokens = logits[:, -1].argmax(-1)
    del logits
    inputs, steps = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(DECODE_STEPS):
        ctx = torch.full((2,), len(p5["prompt_a"]) + 1 + i, dtype=torch.int32, device=dev)
        inputs.append((tokens, ctx))
        steps.append(llama.decode_step(fleet, tokens, pool.kv, table, ctx, cfg)[0].clone())
        tokens = steps[-1].argmax(-1)
    torch.cuda.synchronize()
    walls["fleet_decode_ms"] = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    del fleet, pool
    gc_cuda(torch)
    # The unsharded entry points (the fused layer kernels) on the same
    # prompts, table and decode inputs: the fleet is held to them within
    # the model-level limit, beside bit for bit to the run above.
    plain = pool_mod.KVCachePool(pool_mod.KVCachePoolConfig(
        cfg.n_layers, 2 * per_row, bs, cfg.n_kv_heads, cfg.head_dim, cfg.dtype), device=dev)
    logits = llama.prefill_paged(params, prompts, plain.kv, table[:, :per_row - 1], cfg)[0]
    unsharded_tails = logits[:, -REF_TAIL:].clone()
    del logits
    unsharded_prefill_pool = plain.kv.clone()
    unsharded_steps = [llama.decode_step(params, tokens, plain.kv, table, ctx, cfg)[0].clone()
                       for tokens, ctx in inputs]
    gc_cuda(torch)
    mcfg = moe.MoEConfig()
    mparams = moe.init_params(mcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    (mtokens,) = train_batches(torch, mcfg.vocab_size, MOE_TOKENS, 1, SEED + 30)
    mtokens = mtokens.to(dev)
    mmesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(**SHARD_MOE_PLAN), [str(dev)] * 4)
    msharded = sharding.shard_tree(mparams, mmesh, moe.param_pspecs(mcfg))
    with torch.no_grad():
        moe.forward(msharded, mtokens, mcfg)  # warm-up
        with recorded_routes(torch, moe) as (routes, _):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mlogits, maux = moe.forward(msharded, mtokens, mcfg)
            torch.cuda.synchronize()
    walls["moe_ms"] = (time.perf_counter() - t0) * 1e3
    del msharded
    gc_cuda(torch)
    phase5 = {k: p5[k] for k in ("prompt_a", "prompt_b", "ids_a", "ids_b", "decode_inputs")}
    phase5.update(table=p5["table"].to(dev), blocks=POOL_BLOCKS)
    t = {"phase5": phase5, "pool12a": a12["pool"],
         "fleet": {"tokens": prompts, "prefill_table": table[:, :per_row - 1], "table": table,
                   "blocks": 2 * per_row, "decode_inputs": inputs, "pool": kv,
                   "prefill_pool": prefill_pool, "unsharded_pool": plain.kv,
                   "unsharded_prefill_pool": unsharded_prefill_pool},
         "refs": {"tp": {"miss": a12["miss_tail"], "hit": a12["logits_b"],
                         "decode": a12["step_logits"]},
                  "pp": {"miss": p5["miss_tail"], "hit": p5["logits_b"],
                         "decode": p5["step_logits"]},
                  "dp": {"miss": tails, "decode": steps},
                  "dp_unsharded": {"miss": unsharded_tails, "decode": unsharded_steps}}}
    moe_args = {"params": mparams, "tokens": mtokens, "routes": routes, "ref_logits": mlogits,
                "ref_aux": maux}
    return t, moe_args, walls


def serving_across_processes(torch, params, cfg, p5, a12) -> dict:
    """Phase 12f: phase 5's requests over ``ACROSS_WORLD`` spawned
    processes on the one card in a gloo group, on three meshes that
    ``make_hybrid_mesh`` builds in both (tp across the processes, pp
    across them, the reference's default fleet), then the MoE over ici
    tp 2 x dcn ep 2, each against its reference (``across_references``);
    walls, transfers by kind, idle shares and launches a process."""
    layers = cfg.n_layers
    t0 = time.perf_counter()
    t, moe_args, walls = across_references(torch, params, cfg, p5, a12)
    plain_args, plain_walls = plain_references(torch, params, cfg, moe_args)
    print(f"  references in the parent ({time.perf_counter() - t0:.1f} s): the default fleet's "
          f"batch-2 prefill over dp {ACROSS_WORLD} {walls['fleet_miss_ms']:.1f} ms and eager "
          f"decode "
          f"{walls['fleet_decode_ms']:.2f} ms a step; 12e's single-controller MoE forward "
          f"{walls['moe_ms']:.1f} ms; the MoE's one-process plain ring (sp {RING_SP}) "
          f"{plain_walls['moe_ring_ms']:.1f} ms; the {PLAIN_LLAMA_LAYERS}-layer Llama's single "
          f"controller on tp {SHARD_TP} x sp {PLAIN_LLAMA_MESH[1]['sp']}, contiguous "
          f"{plain_walls['llama_contiguous_ms']:.1f} ms, striped "
          f"{plain_walls['llama_striped_ms']:.1f} ms, dense forward "
          f"{plain_walls['llama_dense_ms']:.1f} ms; {torch.cuda.memory_allocated() / 1e9:.2f} "
          "GB allocated", flush=True)
    t0 = time.perf_counter()
    workers = spawn_group(torch, group_worker, ACROSS_WORLD,
                          ("across_process_run", ACROSS_GROUP_TIMEOUT_S,
                           (params, cfg, t, moe_args, plain_args)),
                          timeout=ACROSS_GROUP_TIMEOUT_S + 120)
    torch.cuda.ipc_collect()  # the workers have exited: release what they shared
    print(f"  {ACROSS_WORLD} processes on cuda:0 (gloo over loopback, CUDA tensors staged through "
          f"pinned host buffers): {time.perf_counter() - t0:.1f} s with spawn, imports and the "
          "kernel checks", flush=True)
    beside = {"tp": ("12a's tp 2 on one process", {"miss": a12["miss_ms"], "hit": a12["hit_ms"],
                                                    "decode": a12["decode_eager_ms"]}),
              "pp": ("phase 5's, unsharded", {"miss": p5["miss_ms"], "hit": p5["hit_ms"],
                                              "decode": p5["decode_eager_ms"]}),
              "dp": ("the parent's batch 2 over dp 2", {"miss": walls["fleet_miss_ms"],
                                                        "decode": walls["fleet_decode_ms"]})}
    out = {"meshes": {}, "references_ms": walls}
    for name in ACROSS_MESHES:
        rows = [w["meshes"][name] for w in workers]
        label, ref_ms = beside[name]
        print(f"  {name} across processes: mesh {rows[0]['mesh']}, crossing {rows[0]['crossing']}",
              flush=True)
        wall = {k: max(r["walls"][k] for r in rows) for k in rows[0]["walls"]}
        print("    walls (slowest process): " + ", ".join(
            f"{k} {v:.1f} ms (beside {label}: {ref_ms[k]:.1f})" for k, v in wall.items())
            + " (decode: ms a step, eager)", flush=True)
        exact = name == "tp"
        held, worst = True, {}
        for kind in rows[0]["logits"]:
            gaps = [r["logits"][kind] for r in rows]
            flat = [g for gap in gaps for g in (gap if isinstance(gap, list) else [gap])]
            equal = all(g["bit_equal"] for g in flat)
            worst[kind] = max(g["max_abs_err"] for g in flat)
            held = held and all(gap_held(g, exact) for g in flat)
            how = "bit for bit" if equal else "within the model-level limit" if held else "NOT"
            print(f"    {kind} logits vs the reference: bit-equal in every process "
                  f"{equal}, max_abs_err {worst[kind]:.6g} (tolerance "
                  f"{min(g['tol'] for g in flat):.4g}; held {how})", flush=True)
        if not held:
            raise AssertionError(f"12f {name}: logits off the reference: {worst}")
        if name == "tp":  # bit-equal to 12a's, which 12a held to phase 5's tokens
            worst = {"miss": a12["errs"]["miss_tail"], "hit": a12["errs"]["hit"],
                     "decode": a12["errs"]["decode"]}
        check_tokens(name, rows, t, worst)
        pools = check_pools(name, rows)
        if name == "dp":
            pools["vs_unsharded"] = check_unsharded(rows)
        for r, row in enumerate(rows):
            print(f"    process {r} transfers: {transfers_text(row['transfers'])}", flush=True)
        print("    device idle share a process (1 - kernels ms / wall of one profiled miss): "
              + "; ".join(f"p{r} {row['idle_share']:.3f} ({row['device_ms']:.1f} / "
                          f"{row['profiled_wall_ms']:.1f}: " + ", ".join(
                              f"{k} {v:.1f}" for k, v in row["kernels_ms"].items()) + ")"
                          for r, row in enumerate(rows)), flush=True)
        want = across_launches(name, layers)
        got = [row["launches"] for row in rows]
        print(f"    launches a process {got} (expected {want} each)", flush=True)
        if any(g != want for g in got):
            raise AssertionError(f"12f {name}: launches {got}, expected {want}")
        out["meshes"][name] = {
            "mesh": rows[0]["mesh"], "walls_ms": wall, "reference_ms": ref_ms,
            "launches_per_process": got, "bit_equal": {k: all(
                g["bit_equal"] for r in rows for g in (r["logits"][k] if isinstance(
                    r["logits"][k], list) else [r["logits"][k]])) for k in rows[0]["logits"]},
            "max_abs_err": worst, "pools": pools,
            "idle_share": [r["idle_share"] for r in rows],
            "device_ms": [r["device_ms"] for r in rows],
            "kernels_ms": [r["kernels_ms"] for r in rows],
            "profiled_wall_ms": [r["profiled_wall_ms"] for r in rows],
            "transfers": [r["transfers"] for r in rows],
            "held": rows[0]["held"]}
    rows = [w["moe"] for w in workers]
    print(f"  MoE across processes: mesh {rows[0]['mesh']}, crossing {rows[0]['crossing']}",
          flush=True)
    for r, row in enumerate(rows):
        alike = row["logits_routed_alike"]
        print(f"    process {r}: forward {row['wall_ms']:.1f} ms (12e's single controller "
              f"{walls['moe_ms']:.1f}); logits bit-equal {row['logits']['bit_equal']} (max_abs_err "
              f"{row['logits']['max_abs_err']:.6g}; on the tokens routed alike "
              f"{alike['max_abs_err']:.6g}, tolerance {alike['tol']:.4g}); tokens routed "
              f"otherwise {row['routed_otherwise']} (limit {MOE_PICK_LIMIT:.0%}); aux "
              f"{row['aux']!r}, equal {row['aux_equal']}; transfers "
              f"{transfers_text(row['transfers'])}; idle share {row['idle_share']:.3f}", flush=True)
        if not (row["logits"]["bit_equal"] or (
                gap_held(alike, False) and row["routed_otherwise"] <= MOE_PICK_LIMIT * MOE_TOKENS)):
            raise AssertionError(f"12f MoE, process {r}: off 12e's single controller")
    want = across_launches("moe", port("models.moe").MoEConfig().n_layers)
    got = [row["launches"] for row in rows]
    print(f"    launches a process {got} (expected {want} each)", flush=True)
    if any(g != want for g in got):
        raise AssertionError(f"12f MoE: launches {got}, expected {want}")
    out["moe"] = {"mesh": rows[0]["mesh"], "wall_ms": max(r["wall_ms"] for r in rows),
                  "reference_ms": walls["moe_ms"], "launches_per_process": got,
                  "bit_equal": all(r["logits"]["bit_equal"] for r in rows),
                  "routed_otherwise": [r["routed_otherwise"] for r in rows],
                  "idle_share": [r["idle_share"] for r in rows],
                  "transfers": [r["transfers"] for r in rows], "held": rows[0]["held"]}
    out["launches_by_path"] = across_launches_by_path(
        {**{name: m["launches_per_process"] for name, m in out["meshes"].items()},
         "moe": out["moe"]["launches_per_process"]})
    out["plain"] = check_plain(workers, plain_args, plain_walls)
    out["launches_by_path"]["ring_partial"] = out["plain"].pop("launches_by_path")
    del t, moe_args, plain_args
    gc_cuda(torch)
    return out


def plain_text(row: dict) -> str:
    """A plain block's process: the share, transfers and peak memory."""
    share = row["share"]
    return (f"share of the plain tree ({share['plain_bytes'] / 1e9:.2f} GB): "
            f"{share['view_bytes'] / 1e9:.2f} GB of views, {share['copied_bytes'] / 1e9:.2f} GB "
            f"copied, {share['allocated_bytes'] / 1e9:.2f} GB allocated by it; peak memory "
            f"{row['peak_bytes'] / 1e9:.2f} GB above the block's start")


def check_plain(workers, plain_args, walls) -> dict:
    """12f's plain blocks, from each worker's rows: the MoE's logits and
    aux bit for bit the one-process plain ring's, its picks the same and
    its launches ``plain_ring_launches`` a process; the Llama's chunks
    bit for bit the single controller's (fingerprints), within the
    model-level limit of the dense forward with its next token, and its
    launches likewise.  Prints and returns what held, and the partial's
    launches by path."""
    out = {"launches_by_path": {}}
    L = port("models.moe").MoEConfig().n_layers
    rows = [w["plain_moe"] for w in workers]
    print(f"  plain MoE params over sp across processes: mesh {rows[0]['mesh']}, crossing "
          f"{rows[0]['crossing']}, contiguous", flush=True)
    for r, row in enumerate(rows):
        gaps = row["logits"]
        print(f"    process {r} (sp ranks {row['ranks']['sp']}): forward {row['wall_ms']:.1f} ms "
              f"(the one-process plain ring {walls['moe_ring_ms']:.1f}); logits bit-equal "
              f"{ {s: g['bit_equal'] for s, g in gaps.items()} } (max_abs_err "
              f"{max(g['max_abs_err'] for g in gaps.values()):.6g}); aux {row['aux']!r}, equal "
              f"{row['aux_equal']}; tokens routed otherwise {row['routed_otherwise']}; first "
              f"layer whose routing input differs {row['first_layer_input_differs']}; transfers "
              f"{transfers_text(row['transfers'])}; idle share {row['idle_share']:.3f} "
              f"({row['device_ms']:.1f} / {row['profiled_wall_ms']:.1f}); {plain_text(row)}",
              flush=True)
        if row["share"]["copied_bytes"] or row["share"]["allocated_bytes"]:
            raise AssertionError(f"12f plain MoE, process {r}: the share copied {row['share']}")
        if not (all(g["bit_equal"] for g in gaps.values()) and row["aux_equal"]
                and row["routed_otherwise"] == 0):
            raise AssertionError(
                f"12f plain MoE, process {r}: off the one-process plain ring (first layer whose "
                f"routing input differs: {row['first_layer_input_differs']}): {gaps}, aux "
                f"{row['aux']}, routed otherwise {row['routed_otherwise']}")
    held = rows[0]["held"]
    print(f"    process 0: {held['calls']} partial launches held against the plain version "
          f"(offsets {held['offsets']}): max_abs_err {held['max_abs_err']:.6g}, worst err/limit "
          f"{held['worst_err_over_limit']:.4g} (limit {held['limit']})", flush=True)
    got = [row["launches"] for row in rows]
    want = [plain_ring_launches(row["ranks"]["sp"], RING_SP, False, 1, L) for row in rows]
    print(f"    partial launches a process {got} (expected {want}; over the processes "
          f"{L * ring_steps(RING_SP, False)}, phase 11's ring)", flush=True)
    if got != want or sum(got) != L * ring_steps(RING_SP, False):
        raise AssertionError(f"12f plain MoE: launches {got}, expected {want}")
    out["launches_by_path"]["moe_ring_processes_plain_sp"] = sum(got)
    out["moe"] = {"mesh": rows[0]["mesh"], "wall_ms": max(row["wall_ms"] for row in rows),
                  "reference_ms": walls["moe_ring_ms"], "launches_per_process": got,
                  "bit_equal": True, "aux": rows[0]["aux"],
                  "idle_share": [row["idle_share"] for row in rows],
                  "transfers": [row["transfers"] for row in rows],
                  "share": [row["share"] for row in rows],
                  "peak_bytes": [row["peak_bytes"] for row in rows], "held": held}
    rows = [w["plain_llama"] for w in workers]
    dense = plain_args["llama"]["ref"]["dense"]
    R, layers = PLAIN_LLAMA_MESH[1]["sp"], PLAIN_LLAMA_LAYERS
    print(f"  plain Llama params ({layers} of 32 layers) over tp x sp across processes: mesh "
          f"{rows[0]['mesh']}, crossing {rows[0]['crossing']}", flush=True)
    for r, row in enumerate(rows):
        print(f"    process {r} (sp ranks {row['ranks']['sp']}, tp ranks {row['ranks']['tp']}): "
              f"{plain_text(row)}", flush=True)
    out["llama"] = {"mesh": rows[0]["mesh"], "share": [row["share"] for row in rows],
                    "peak_bytes": [row["peak_bytes"] for row in rows], "layouts": {}}
    for name, striped in (("contiguous", False), ("striped", True)):
        per = [row["layouts"][name] for row in rows]
        chunks = [c for p in per for c in p["chunks"].values()]
        equal = [all(c["bit_equal"] for c in p["chunks"].values()) for p in per]
        worst = max(c["dense"]["max_abs_err"] for c in chunks)
        tol = min(c["dense"]["tol"] for c in chunks)
        print(f"    {name}: wall {max(p['wall_ms'] for p in per):.1f} ms (slowest process; single "
              f"controller {walls[f'llama_{name}_ms']:.1f}, dense {walls['llama_dense_ms']:.1f}); "
              f"chunks bit-equal to the single controller's (fingerprints) per process {equal}; "
              f"max_abs_err against the dense forward {worst:.6g} (tolerance {tol:.4g})",
              flush=True)
        for r, p in enumerate(per):
            print(f"    {name}, process {r}: transfers {transfers_text(p['transfers'])}; idle "
                  f"share {p['idle_share']:.3f} ({p['device_ms']:.1f} / "
                  f"{p['profiled_wall_ms']:.1f})", flush=True)
        if not all(equal) or not all(gap_held(c["dense"], False) for c in chunks):
            raise AssertionError(f"12f plain Llama {name}: bit-equal {equal}, against the dense "
                                 f"forward {worst} (tolerance {tol})")
        token = next(p["token"] for p in per if "token" in p)
        check_next_token(f"12f plain Llama {name} next token", token, dense[0, -1], worst)
        held = per[0]["held"]
        print(f"    {name}, process 0: {held['calls']} partial launches held against the plain "
              f"version (offsets {held['offsets']}): max_abs_err {held['max_abs_err']:.6g}, "
              f"worst err/limit {held['worst_err_over_limit']:.4g}", flush=True)
        got = [p["launches"] for p in per]
        want = [plain_ring_launches(row["ranks"]["sp"], R, striped, len(row["ranks"]["tp"]),
                                    layers) for row in rows]
        total = shard_launches(ring_steps(R, striped), SHARD_TP, layers)
        print(f"    {name}: partial launches a process {got} (expected {want}, {total} over the "
              "processes)", flush=True)
        if got != want or sum(got) != total:
            raise AssertionError(f"12f plain Llama {name}: launches {got}, expected {want}")
        out["launches_by_path"][f"llama_ring_processes_plain_tp_sp_{name}"] = sum(got)
        out["llama"]["layouts"][name] = {
            "wall_ms": max(p["wall_ms"] for p in per), "reference_ms": walls[f"llama_{name}_ms"],
            "dense_ms": walls["llama_dense_ms"], "launches_per_process": got,
            "bit_equal": all(equal), "max_abs_err_vs_dense": worst,
            "idle_share": [p["idle_share"] for p in per],
            "transfers": [p["transfers"] for p in per], "held": held}
    return out


def check_unsharded(rows) -> dict:
    """Phase 12f's default fleet against the unsharded entry points' run
    of the same prompts and decode inputs (which take the fused layer
    kernels, whose RMSNorm rounds otherwise than the sharded paths'
    chain): each process's miss and decode logits, its prefill's blocks
    right after the prefill and its pool after the decode steps, within
    the model-level limit.  Returns the largest gap of each and whether
    all held."""
    gaps = [r["vs_unsharded"] for r in rows]
    out = {}
    for kind in ("miss", "decode", "prefill_pool", "pool"):
        flat = [g for gap in gaps for g in (gap[kind] if kind == "decode" else [gap[kind]])]
        out[kind] = {"bit_equal": all(g["bit_equal"] for g in flat),
                     "max_abs_err": max(g["max_abs_err"] for g in flat),
                     "tol": min(g["tol"] for g in flat),
                     "held": all(gap_held(g, exact=False) for g in flat)}
    print(f"    against the unsharded entry points (fused layer kernels), within the "
          f"model-level limit: {out}", flush=True)
    if not all(v["held"] for v in out.values()):
        raise AssertionError(f"12f dp: off the unsharded entry points' run: {out}")
    return out


def check_pools(name: str, rows) -> dict:
    """Phase 12f's pools: tp across processes, each process's slice
    byte-equal to 12a's rank slice; pp and the default fleet, the two
    processes' whole copies byte-equal; the fleet's also byte-equal to
    the parent's in the prefill's blocks right after the prefill, and,
    after the decode steps, to the parent's pool bit for bit or within
    the model-level limit (a batch of 1 a process decodes against the
    parent's batch of 2, which the decode kernel splits otherwise, as it
    does the logits).  Returns what held."""
    out = {"checksums": [r["pool_checksum"] for r in rows]}
    if name in ("pp", "dp"):
        out["copies_equal"] = [r["pool_copies_equal"] for r in rows]
    if name == "dp":
        out["prefill_equal"] = [r["prefill_pool_equal"] for r in rows]
    if name != "pp":
        gaps = [r["pool_gap"] for r in rows]
        out["bit_equal"] = [g["bit_equal"] for g in gaps]
        out["max_abs_err"] = max(g["max_abs_err"] for g in gaps)
        out["held"] = all(gap_held(g, exact=name == "tp") for g in gaps)
    print(f"    pools: {out}", flush=True)
    if not (all(out.get("copies_equal", [True])) and all(out.get("prefill_equal", [True]))
            and out.get("held", True)):
        raise AssertionError(f"12f {name}: a process's pool is off: {out}")
    return out


def check_tokens(name: str, rows, t, worst) -> None:
    """Phase 12f's next tokens: each process's against phase 5's (tp,
    pp) or the parent's batch-2 run (dp), a tie within the logits'
    measured error allowed (``check_next_token``)."""
    refs = t["refs"][name] if name == "dp" else t["refs"]["pp"]
    for r, row in enumerate(rows):
        d = r if name == "dp" else slice(None)
        for kind in ("miss", "hit"):
            if kind in row["tokens"]:
                last = refs[kind][d][-1] if name == "dp" else refs[kind][0, -1]
                check_next_token(f"12f {name}, process {r}, {kind} next token",
                                 row["tokens"][kind], last, worst[kind])
        for i, tokens in enumerate(row["tokens"]["decode"]):
            want = refs["decode"][i][d] if name == "dp" else refs["decode"][i]
            want = want.reshape(-1, want.shape[-1])
            for j, token in enumerate(tokens):
                check_next_token(f"12f {name}, process {r}, decode step {i + 1}, row {j}", token,
                                 want[j], worst["decode"])


# --------------------------------------------------------------- phase 13


READ_LANES = (("fast", True, True), ("fast_no_memo", True, False), ("straight", False, True))


def read_path_indexer(fast: bool, memo: bool = True, block_size: int = READ_BLOCK, index=None,
                      capture=None):
    """One Indexer of phase 13: the word tokenizer, a metrics-wrapped
    in-memory index (so its lookups reach the exposition) or ``index``,
    the fast lane or the straight path, the score memo on or off, and
    ``capture`` (an ``obs.InputCaptureRecorder``) tapped into its scoring."""
    im, tp = port("kvcache.indexer"), port("kvcache.kvblock.token_processor")
    index_mod = port("kvcache.kvblock.index")
    indexer = im.Indexer(
        im.IndexerConfig(
            token_processor_config=tp.TokenProcessorConfig(block_size=block_size,
                                                           hash_seed="0"),
            kvblock_index_config=index_mod.IndexConfig(enable_metrics=True),
            read_path_fast_lane=fast, score_memo_size=None if memo else 0),
        tokenizer=WordTokenizer(), kv_block_index=index, capture_recorder=capture)
    indexer.run()
    return indexer


def read_traffic(rng, conv_tokens: int, turns: int, turn_tokens: int, cold: int):
    """The conversation's token ids and the three workloads' prompts:
    its turns (the conversation so far after each), cold prompts of
    ``conv_tokens`` new tokens, and the two alternated."""
    convo = rng.integers(1, READ_VOCAB, conv_tokens + turns * turn_tokens).tolist()
    warm = [words(convo[:conv_tokens + (t + 1) * turn_tokens]) for t in range(turns)]
    cold_prompts = [words(rng.integers(1, READ_VOCAB, conv_tokens).tolist())
                    for _ in range(cold)]
    mixed = [p for pair in zip(warm * math.ceil(cold / turns), cold_prompts) for p in pair]
    return convo, {"warm_multi_turn": warm, "cold": cold_prompts, "mixed": mixed}


class PrefixStoreModel:
    """What one Indexer's tokenization pool serves for each of a sequence
    of ``words`` prompts: ``store_served_tokens`` against the texts it
    tokenized in full so far, the one sharing the longest prefix with
    the prompt.  Holds the router's scores to an independent count."""

    def __init__(self) -> None:
        self.known = []

    def served(self, prompt: str):
        def shared(text):
            common = 0
            for x, y in zip(prompt, text):
                if x != y:
                    break
                common += 1
            return common

        best = max(self.known, key=shared, default=None)
        tokens, in_full = store_served_tokens(prompt, best)
        if in_full and prompt not in self.known:
            self.known.append(prompt)
        return tokens


def expected_read_scores(n_blocks: int, pods, holders) -> dict:
    """Scores of ``pods`` for a prompt whose first ``n_blocks`` blocks
    are resident on each ``(pod, tier)`` of ``holders``, from
    ``ScorerConfig``'s tier weights; every other pod 0.0."""
    weights = {t.name: t.weight for t in port("kvcache.scorer").ScorerConfig().tier_configs}
    out = dict.fromkeys(pods, 0.0)
    for pod, tier in holders:
        out[pod] = tier_score(n_blocks, weights[tier])
    return out


def check_spans(spans) -> dict:
    """The traced fast-lane request's span tree: each name of READ_SPANS
    once, under its parent.  Returns {name: parent} of every span."""
    seen = {}
    for sp in spans:
        seen.setdefault(sp["name"], []).append(sp["parent"])
    for name, parent in READ_SPANS.items():
        if seen.get(name) != [parent]:
            raise AssertionError(f"span {name!r} under {parent!r} expected once, got "
                                 f"{seen.get(name)}; spans {sorted(seen)}")
    return {name: parents[0] for name, parents in seen.items()}


def lookup_counter(text: str) -> float:
    """``kvtpu_kvcache_index_lookup_requests_total`` in a text exposition."""
    for line in text.splitlines():
        if line.startswith("kvtpu_kvcache_index_lookup_requests_total "):
            return float(line.split()[1])
    raise AssertionError("no lookup counter in the exposition")


def percentile_ms(latencies, q: float) -> float:
    ordered = sorted(latencies)
    return ordered[min(len(ordered) - 1, int(round(q / 100 * (len(ordered) - 1))))] * 1e3


def read_path(smi: str, pods_n=READ_PODS, convs=READ_CONVS_PER_POD,
              conv_tokens=READ_CONV_TOKENS, turns=READ_TURNS, turn_tokens=READ_TURN_TOKENS,
              cold=READ_COLD_PROMPTS, min_requests=READ_REQUESTS, block=READ_BLOCK) -> dict:
    """Phase 13: the Indexer's read path at fleet scale, three lanes."""
    import numpy as np

    collector = port("metrics.collector")
    tp = port("kvcache.kvblock.token_processor")
    index_mod = port("kvcache.kvblock.index")
    trace_mod = port("obs.trace")
    rng = np.random.default_rng(SEED)
    pods = [f"pod-{i}" for i in range(pods_n)]
    lookups0 = lookup_counter(collector.METRICS.exposition().decode())
    rss0 = collector.update_process_metrics()["rss_bytes"]
    indexers = {}
    try:
        for lane, fast, memo in READ_LANES:
            indexers[lane] = read_path_indexer(fast, memo, block)
        lanes = list(indexers.values())
        if indexers["fast"]._score_memo is None or indexers["fast_no_memo"]._score_memo:
            raise AssertionError("the score memo is not where it was asked for")
        t0 = time.perf_counter()
        fleet = event_fleet(rng, pods, convs, conv_tokens, block)
        publish_s = time.perf_counter() - t0
        keys_added = fleet["blocks"]
        seed_s = seed_by_events(lanes, fleet["frames"])
        rss1 = collector.update_process_metrics()["rss_bytes"]
        # Phase 14 seeds fresh indexes from the same frames and holds them
        # to this one.
        fleet["entries"] = index_entries(lanes[0].kv_block_index)
        if fleet["entries"] != expected_entries(lanes[0].token_processor, fleet["chains"]):
            raise AssertionError("the event-seeded index differs from the fleet's chains")
        print(f"  on {smi}: {len(lanes)} Indexers' in-memory indexes, each {pods_n} pods x "
              f"{convs} conversations of {conv_tokens} tokens = {keys_added} keys "
              f"({conv_tokens // block} blocks a conversation, tiers hbm/host), published as "
              f"{sum(map(len, fleet['frames'].values()))} frames of one BlockStored "
              f"({EVENT_CHUNK_TOKENS}-token chunks; engine hashes and encoding {publish_s:.2f} s) "
              f"and seeded through a pool each at {len(lanes) * keys_added / seed_s:.0f} keys/s "
              f"({seed_s:.2f} s), each index's entries those of the chains; process RSS "
              f"{rss0 / 2**20:.0f} -> {rss1 / 2**20:.0f} MiB", flush=True)
        convo, workloads = read_traffic(rng, conv_tokens, turns, turn_tokens, cold)
        holders = [(pods[0], "hbm"), (pods[1], "host")]
        # The resident conversation, as its two holders publish it.
        convo_frames = {}
        for pod, tier in holders:
            stream, parent, convo_frames[pod] = fleet["streams"][pod], None, []
            for start in range(0, len(convo), EVENT_CHUNK_TOKENS):
                chunk = convo[start:start + EVENT_CHUNK_TOKENS]
                hashes = engine_hashes(parent, chunk, block)
                convo_frames[pod].append(stream.frame(port("kvevents.events").BlockStored(
                    block_hashes=hashes, parent_block_hash=parent,
                    token_ids=chunk[:len(hashes) * block], block_size=block, medium=tier)))
                parent = hashes[-1]
        seed_by_events(lanes, convo_frames)
        # Phases 14b-14c seed their indexes from the same frames, drive the
        # same requests in the same order and hold them to these.
        traffic = {"convo_frames": convo_frames, "entries": index_entries(
            lanes[0].kv_block_index), "pods": pods, "block": block, "sequences": {},
            "timed_from": {}, "scores": {}}
        warm_set = set(workloads["warm_multi_turn"])
        model = PrefixStoreModel()
        calls, cells, checked = 0, {}, 0
        for workload, prompts in workloads.items():
            sequence = prompts + prompts * math.ceil(min_requests / len(prompts))
            timed_from = len(prompts)  # the first pass warms the prefix store
            scores = {}
            cells[workload] = {}
            for lane, indexer in indexers.items():
                got, latencies = [], []
                for i, prompt in enumerate(sequence):
                    t0 = time.perf_counter()
                    got.append(indexer.get_pod_scores(prompt, MODEL_NAME, pods))
                    if i >= timed_from:
                        latencies.append(time.perf_counter() - t0)
                calls += len(sequence)
                scores[lane] = got
                cells[workload][lane] = {
                    "requests": len(latencies),
                    "p50_ms": percentile_ms(latencies, 50),
                    "p99_ms": percentile_ms(latencies, 99),
                    "scores_per_s": len(latencies) / sum(latencies),
                }
            traffic["sequences"][workload] = sequence
            traffic["timed_from"][workload] = timed_from
            traffic["scores"][workload] = scores["fast"]
            for i, prompt in enumerate(sequence):
                served = model.served(prompt)
                want = (expected_read_scores(len(served) // block, pods, holders)
                        if prompt in warm_set else dict.fromkeys(pods, 0.0))
                lane_scores = [scores[lane][i] for lane in indexers]
                if any(s != lane_scores[0] for s in lane_scores):
                    raise AssertionError(f"{workload} request {i}: the lanes disagree: "
                                         f"{lane_scores}")
                if lane_scores[0] != want:
                    raise AssertionError(f"{workload} request {i}: scores {lane_scores[0]}, "
                                         f"expected {want}")
                checked += 1
            print(f"  {workload}: " + "; ".join(
                f"{lane} p50 {c['p50_ms']:.3f} ms p99 {c['p99_ms']:.3f} ms "
                f"({c['requests']} requests)" for lane, c in cells[workload].items()),
                flush=True)
        warm_blocks = len(model.served(workloads["warm_multi_turn"][-1])) // block
        print(f"  scores equal across the three lanes on all {checked} requests, each equal to "
              f"its expected value (warm turns: pod-0 hbm and pod-1 host over the blocks the "
              f"prefix store serves, {warm_blocks} on the last turn; cold: all 0.0)",
              flush=True)

        hash_tokens = rng.integers(1, READ_VOCAB, PREFIX_TOKENS + SUFFIX_TOKENS).tolist()
        config = tp.TokenProcessorConfig(block_size=block, hash_seed="0")
        chains = {"native": tp.ChunkedTokenDatabase(config),
                  "python": tp.ChunkedTokenDatabase(config, use_native=False)}
        hash_ms, hash_keys = {}, {}
        for name, db in chains.items():
            runs = []
            for _ in range(5 if name == "python" else 50):
                t0 = time.perf_counter()
                hash_keys[name] = db.tokens_to_kv_block_keys(
                    index_mod.EMPTY_BLOCK_HASH, hash_tokens, MODEL_NAME)
                runs.append(time.perf_counter() - t0)
            hash_ms[name] = statistics.median(runs) * 1e3
        if hash_keys["native"] != hash_keys["python"]:
            raise AssertionError("the native and Python block-hash chains disagree")
        print(f"  block-hash chain over {len(hash_tokens)} tokens ({len(hash_keys['native'])} "
              f"keys, equal): native {hash_ms['native']:.3f} ms, Python "
              f"{hash_ms['python']:.3f} ms (medians)", flush=True)

        fresh = words(rng.integers(1, READ_VOCAB, conv_tokens).tolist())
        trace = trace_mod.TRACER.start_trace("read_path", force=True)
        with trace_mod.use_trace(trace):
            indexers["fast"].get_pod_scores(fresh, MODEL_NAME, pods)
        trace.finish()
        calls += 1
        spans = trace.to_dict()["spans"]
        tree = check_spans(spans)
        span_ms = {sp["name"]: sp["duration_ms"] for sp in spans}
        print(f"  one traced fast-lane request over a new {conv_tokens}-token prompt (a full "
              f"encode): spans (parent) {tree}; ms " + ", ".join(
                  f"{name} {ms:.3f}" for name, ms in span_ms.items()), flush=True)
        lookups = lookup_counter(collector.METRICS.exposition().decode()) - lookups0
        if lookups != calls:
            raise AssertionError(f"the exposition counts {lookups} lookups, {calls} were made")
        print(f"  generate_latest: kvtpu_kvcache_index_lookup_requests_total rose by "
              f"{lookups:.0f}, the {calls} scoring requests made", flush=True)
        traffic["cells"] = {workload: lanes["fast"] for workload, lanes in cells.items()}
    finally:
        for indexer in indexers.values():
            indexer.shutdown()
    return {"keys_per_index": keys_added, "seed_keys_per_s": len(indexers) * keys_added / seed_s,
            "publish_s": publish_s, "fleet": fleet,
            "rss_mib": [rss0 / 2**20, rss1 / 2**20], "cells": cells, "requests_checked": checked,
            "hash_chain_ms": hash_ms, "hash_tokens": len(hash_tokens), "spans": tree,
            "span_ms": span_ms,
            "lookups": lookups, "card": smi, "traffic": traffic}


# --------------------------------------------------------------- phase 14


# bench.py:bench_event_storm's shapes (STORM_PODS, STORM_PUBLISH_S,
# STORM_RATE, STORM_BLOCK_SIZE; _StormFleet's shared payload).
STORM_PODS = 1000
STORM_SECONDS = 3.0
STORM_RATE = 6000.0
STORM_BLOCK = 16
# The quiet pod's pace: fewer messages in a window than the fair share of
# a shard (max_queue_depth // its ~250 lanes = 16), so under its budget
# however slowly the pool drains.
QUIET_EVERY_S = 0.5
GAP_SEQS = 5
AUDIT_PHANTOM = 40  # blocks dropped from one pod's inventory, with no BlockRemoved
AUDIT_WRONG_TIER = 24  # blocks of that pod moved to the other tier


def storm_payload(tokens, block_hashes) -> bytes:
    """One frame's payload: a root ``BlockStored`` of ``tokens``."""
    events = port("kvevents.events")
    return events.EventBatch(ts=0.0, events=[events.BlockStored(
        block_hashes=block_hashes, parent_block_hash=None, token_ids=tokens,
        block_size=STORM_BLOCK)]).encode()


def storm(pool, index, hasher, pods: int, seconds: float, rate, tag: str = "",
          quiet_every: float = QUIET_EVERY_S):
    """bench.py's event storm into ``pool``: ``pods`` pods publish the
    shared 2-block, 32-token payload at ``rate`` messages/s (None: as fast
    as this thread offers them) in poller bursts (up to POLLER_BURST
    frames of one pod, the pods in turn), beside a quiet pod that stores
    a new 2-block chain every ``quiet_every`` s (pod names carry ``tag``,
    one per window).  Returns what was offered
    and applied in the window, the drops by reason, the sheds by pod, and
    whether every quiet message reached the index."""
    metrics = port("metrics.collector").METRICS
    sink = EventSink(pool)
    streams = [EventStream(f"storm{tag}-{i}") for i in range(pods)]
    quiet = EventStream(f"storm{tag}-quiet")
    shared = storm_payload(list(range(2 * STORM_BLOCK)), [0xBEEF, 0xCAFE])
    dropped0 = label_totals(metrics.kvevents_dropped, "reason")
    shed0 = label_totals(metrics.kvevents_pod_shed, "pod")
    stages0 = pool.stage_stats()
    sent, turn, quiet_chains = 0, 0, []
    t0 = time.perf_counter()
    next_quiet = t0
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        if now >= next_quiet:
            n = len(quiet_chains)
            tokens = [100_000 + 2 * STORM_BLOCK * n + i for i in range(2 * STORM_BLOCK)]
            quiet_chains.append(tokens)
            sink.deliver(quiet.pod, [quiet.frame(
                payload=storm_payload(tokens, [2**40 + 2 * n, 2**40 + 2 * n + 1]))])
            next_quiet += quiet_every
            continue
        due = POLLER_BURST if rate is None else int((now - t0) * rate) - sent
        if due <= 0:
            time.sleep(0.0005)
            continue
        stream = streams[turn % pods]
        turn += 1
        burst = min(due, POLLER_BURST)
        sink.deliver(stream.pod, [stream.frame(payload=shared) for _ in range(burst)])
        sent += burst
    window = time.perf_counter() - t0
    stages1 = pool.stage_stats()
    pool.drain()
    dropped = {k: v - dropped0.get(k, 0.0) for k, v in
               label_totals(metrics.kvevents_dropped, "reason").items()}
    sheds = {k: v - shed0.get(k, 0.0) for k, v in
             label_totals(metrics.kvevents_pod_shed, "pod").items()}
    sheds = {k: v for k, v in sheds.items() if v and k.startswith(f"storm{tag}-")}
    held = index_entries(index, quiet.pod)
    quiet_landed = sum(
        all(key in held for key in hasher.tokens_to_kv_block_keys(0, tokens, MODEL_NAME))
        for tokens in quiet_chains)
    applied = stages1["apply_msgs"] - stages0["apply_msgs"]
    return {
        "rate_asked": rate, "window_s": window, "offered": sent + len(quiet_chains),
        "offered_per_s": (sent + len(quiet_chains)) / window, "applied_in_window": applied,
        "applied_per_s": applied / window,
        "decode_us_per_msg": (stages1["decode_s"] - stages0["decode_s"]) * 1e6 / max(
            1, stages1["decode_msgs"] - stages0["decode_msgs"]),
        "apply_us_per_msg": (stages1["apply_s"] - stages0["apply_s"]) * 1e6 / max(1, applied),
        "dropped": {k: v for k, v in dropped.items() if v}, "pods_shed": len(sheds),
        "sheds": sum(sheds.values()), "max_pod_sheds": max(sheds.values(), default=0.0),
        "quiet_sent": len(quiet_chains), "quiet_shed": sheds.get(quiet.pod, 0.0),
        "quiet_in_index": quiet_landed,
    }


def pod_inventory(fleet):
    """The inventory source of resync and the auditor over ``fleet``'s
    inventories (a pod's current blocks, engine hashes and tokens)."""
    resync = port("kvevents.resync")
    return resync.CallableInventorySource(
        lambda pod: resync.PodInventory(pod, MODEL_NAME, list(fleet["inventory"][pod])))


def plant_divergence(blocks, per_conv: int, phantom: int, wrong_tier: int):
    """One pod's inventory (``per_conv`` chunks a conversation) with
    ``phantom`` blocks dropped from the end of its first conversation (no
    BlockRemoved published: the index still claims them) and the last
    ``wrong_tier`` blocks of its second moved to the other tier."""
    resync = port("kvevents.resync")
    blocks = list(blocks)
    last = blocks[per_conv - 1]
    keep = len(last.block_hashes) - phantom
    bs = last.block_size
    blocks[per_conv - 1] = resync.InventoryBlock(
        last.block_hashes[:keep], last.token_ids[:keep * bs], bs, last.parent_block_hash,
        last.medium)
    i = 2 * per_conv - 1
    moved = blocks[i]
    keep = len(moved.block_hashes) - wrong_tier
    other = "host" if moved.medium == "hbm" else "hbm"
    blocks[i:i + 1] = [
        resync.InventoryBlock(moved.block_hashes[:keep], moved.token_ids[:keep * bs], bs,
                              moved.parent_block_hash, moved.medium),
        resync.InventoryBlock(moved.block_hashes[keep:], moved.token_ids[keep * bs:], bs,
                              moved.block_hashes[keep - 1], other)]
    return blocks


def write_path(smi: str, fleet, storm_pods=STORM_PODS, storm_seconds=STORM_SECONDS,
               storm_rate=STORM_RATE, phantom=AUDIT_PHANTOM, wrong_tier=AUDIT_WRONG_TIER,
               block=READ_BLOCK) -> dict:
    """Phase 14: the KV-event write path at fleet scale, on the host, from
    phase 13's fleet (its frames, inventories and index entries)."""
    import numpy as np

    collector = port("metrics.collector")
    events = port("kvevents.events")
    im, index_mod = port("kvcache.kvblock.in_memory"), port("kvcache.kvblock.index")
    tp, resync = port("kvcache.kvblock.token_processor"), port("kvevents.resync")
    auditor_mod = port("analytics.auditor")
    hasher = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(block_size=block, hash_seed="0"))
    pods = sorted(fleet["frames"])
    n_frames = sum(map(len, fleet["frames"].values()))
    out = {"card": smi, "frames": n_frames, "blocks": fleet["blocks"]}

    # (a) Seeding a fresh index through events, lock-free decode on and off.
    out["seeding"], kept = {}, None
    for lockfree in (True, False):
        index = im.InMemoryIndex(index_mod.InMemoryIndexConfig())
        pool = event_pool(index, hasher, lockfree_decode=lockfree)
        sink = EventSink(pool)
        rss0 = collector.update_process_metrics()["rss_bytes"]
        t0 = time.perf_counter()
        feed([sink], fleet["frames"])
        pool.drain()
        seconds = time.perf_counter() - t0
        rss1 = collector.update_process_metrics()["rss_bytes"]
        stages = pool.stage_stats()
        equal = index_entries(index) == fleet["entries"]
        row = out["seeding"]["lockfree_on" if lockfree else "lockfree_off"] = {
            "seconds": seconds, "events_per_s": n_frames / seconds,
            "blocks_per_s": fleet["blocks"] / seconds,
            "decode_ms_per_msg": stages["decode_s"] * 1e3 / stages["decode_msgs"],
            "apply_ms_per_msg": stages["apply_s"] * 1e3 / stages["apply_msgs"],
            "rss_mib": [rss0 / 2**20, rss1 / 2**20], "entries_equal": equal}
        print(f"  (a) seeding, lock-free decode {'on' if lockfree else 'off'}: {n_frames} frames "
              f"of one BlockStored ({fleet['blocks']} blocks) through parse_event_message -> "
              f"Pool.add_tasks in bursts of {POLLER_BURST}: {seconds:.2f} s, "
              f"{row['events_per_s']:.0f} events/s, {row['blocks_per_s']:.0f} blocks/s; decode "
              f"{row['decode_ms_per_msg']:.3f} ms, apply {row['apply_ms_per_msg']:.3f} ms a "
              f"message; RSS {rss0 / 2**20:.0f} -> {rss1 / 2**20:.0f} MiB; request-key entries "
              f"equal to phase 13's: {equal}", flush=True)
        if not equal:
            raise AssertionError("the event-seeded index differs from phase 13's")
        if lockfree:
            kept = (index, pool, sink)
        else:
            pool.shutdown()
    index, pool, sink = kept
    try:
        # (b) The storm, on an index of its own.
        storm_index = im.InMemoryIndex(index_mod.InMemoryIndexConfig())
        storm_hasher = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(block_size=STORM_BLOCK))
        storm_pool = event_pool(storm_index, storm_hasher)
        out["storm"] = []
        try:
            for tag, rate in (("a", storm_rate), ("b", None)):
                cell = storm(storm_pool, storm_index, storm_hasher, storm_pods, storm_seconds,
                             rate, tag)
                out["storm"].append(cell)
                print(f"  (b) storm, {storm_pods} pods + 1 quiet, "
                      f"{'offered at ' + format(rate, '.0f') + '/s' if rate else 'unthrottled'}: "
                      f"{cell['offered']} messages in {cell['window_s']:.2f} s "
                      f"({cell['offered_per_s']:.0f}/s offered), {cell['applied_per_s']:.0f}/s "
                      f"applied in the window (decode {cell['decode_us_per_msg']:.1f} us, apply "
                      f"{cell['apply_us_per_msg']:.1f} us a message); dropped {cell['dropped']}, "
                      f"{cell['pods_shed']} pods shed ({cell['sheds']:.0f} messages, at most "
                      f"{cell['max_pod_sheds']:.0f} a pod); the quiet pod: {cell['quiet_sent']} "
                      f"sent, {cell['quiet_shed']:.0f} shed, {cell['quiet_in_index']} in the "
                      f"index", flush=True)
                if cell["quiet_shed"] or cell["quiet_in_index"] != cell["quiet_sent"]:
                    raise AssertionError("the storm shed the quiet pod under its budget")
                if cell["dropped"]:
                    break  # the pool no longer keeps up: the offered rate suffices
        finally:
            storm_pool.shutdown()

        # (c) A gap on one pod's stream, then the resync from its inventory.
        pod = pods[-1]
        before = index_entries(index, pod)
        manager = resync.ResyncManager(pool, pod_inventory(fleet),
                                       resync.ResyncConfig(max_attempts=1, apply_timeout_s=120))
        manager.start()
        marked = []  # mark_suspect's answers: True when the gap newly marks the pod
        sink.on_gap = lambda gap_pod, topic, lost: marked.append(manager.mark_suspect(gap_pod))
        try:
            stream = fleet["streams"][pod]
            rng = np.random.default_rng(SEED + 14)
            extra = rng.integers(1, READ_VOCAB, EVENT_CHUNK_TOKENS).tolist()
            hashes = engine_hashes(None, extra, block)
            # A chunk the pod stored and then evicted: the store arrives,
            # the removal is among the lost frames.
            sink.deliver(pod, [stream.frame(events.BlockStored(
                block_hashes=hashes, parent_block_hash=None, token_ids=extra,
                block_size=block, medium="hbm"))])
            pool.drain()
            stale = len(index_entries(index, pod)) - len(before)
            stream.skip(GAP_SEQS)
            first = fleet["inventory"][pod][0]
            t_gap = time.perf_counter()
            sink.deliver(pod, [stream.frame(events.BlockStored(
                block_hashes=first.block_hashes, parent_block_hash=None,
                token_ids=first.token_ids, block_size=block, medium=first.medium))])
            gap = sink.trackers[pod].gap_count
            suspect = marked == [True]
            deadline = time.monotonic() + 120
            while manager.stats()["resyncs_ok"] < 1 and time.monotonic() < deadline:
                time.sleep(0.001)
            staleness = time.perf_counter() - t_gap
            stats = manager.stats()
        finally:
            sink.on_gap = None
            manager.close()
        after = index_entries(index, pod)
        whole = index_entries(index) == fleet["entries"]
        out["resync"] = {"pod": pod, "gap": gap, "suspect": suspect, "stale_blocks": stale,
                         "staleness_ms": staleness * 1e3, "stats": stats,
                         "entries_restored": after == before, "index_equal": whole}
        print(f"  (c) gap: {pod} stored a {len(hashes)}-block chunk whose removal was lost with "
              f"{GAP_SEQS} frames; TopicSeqTracker gap {gap}, suspect {suspect}; "
              f"ResyncManager purged the pod and re-applied its {len(fleet['inventory'][pod])} "
              f"inventory chunks: staleness {staleness * 1e3:.1f} ms (gap to repaired), "
              f"{stats['resyncs_ok']} ok / {stats['resyncs_failed']} failed; the pod's entries "
              f"equal to those before the gap: {after == before}; whole index equal to phase "
              f"13's: {whole}", flush=True)
        if (gap != GAP_SEQS or not suspect or stale != len(hashes) or stats["resyncs_ok"] != 1
                or stats["suspect"] or after != before or not whole):
            raise AssertionError(f"gap and resync: {out['resync']}")

        # (d) The auditor over the four pods, clean, then planted.
        inventories = fleet["inventory"]
        auditor = auditor_mod.IndexAuditor(index, hasher, pod_inventory(fleet),
                                           auditor_mod.AuditorConfig(interval_s=0))
        t0 = time.perf_counter()
        clean = auditor.run_cycle()
        clean_s = time.perf_counter() - t0
        victim = pods[1 % len(pods)]
        original = inventories[victim]
        inventories[victim] = plant_divergence(original, fleet["chunks_per_conv"], phantom,
                                               wrong_tier)
        try:
            planted = auditor.run_cycle()
        finally:
            inventories[victim] = original
        auditor.close()
        counts = lambda r: (r.outcome, r.phantom, r.missing, r.wrong_tier)  # noqa: E731
        out["audit"] = {
            "pods": [r.pod for r in clean], "cycle_ms": clean_s * 1e3,
            "pod_ms": {r.pod: r.duration_s * 1e3 for r in clean},
            "blocks_per_pod": {r.pod: r.inventory_blocks for r in clean},
            "clean": {r.pod: r.to_dict()["divergence_ratio"] for r in clean},
            "planted": {r.pod: counts(r) for r in planted}}
        print(f"  (d) audit of {len(clean)} pods ({sorted(set(out['audit']['blocks_per_pod'].values()))} "
              f"blocks each): divergence {out['audit']['clean']}; one cycle {clean_s * 1e3:.1f} ms, "
              f"per pod " + ", ".join(f"{ms:.1f}" for ms in out["audit"]["pod_ms"].values())
              + f" ms; after dropping {phantom} blocks of {victim}'s inventory (no BlockRemoved) "
              f"and moving {wrong_tier} to the other tier: (outcome, phantom, missing, "
              f"wrong_tier) {out['audit']['planted']}", flush=True)
        want = {p: ("clean", 0, 0, 0) for p in pods}
        want[victim] = ("divergent", phantom, 0, wrong_tier)
        if (sorted(out["audit"]["pods"]) != pods or any(out["audit"]["clean"].values())
                or out["audit"]["planted"] != want):
            raise AssertionError(f"audit: {out['audit']}")
    finally:
        pool.shutdown()
    return out


# ------------------------------------------------------- phases 14b-14c


RESTART_TORN_BYTES = 5  # 14b cuts the journal's last record short by this much
CLUSTER_REPLICAS = ("replica-0", "replica-1", "replica-2")
CATCH_UP_S = 300.0  # the longest 14c waits for the followers to reach their peers' journals
PURGED_POD = "pod-1"  # 14c purges the pod holding the conversation on host


def phase13_frames(fleet, traffic) -> dict:
    """Every pod's frames in phase 13's order: its conversations, then
    (pod-0, pod-1) the resident conversation."""
    return {pod: list(frames) + list(traffic["convo_frames"].get(pod, ()))
            for pod, frames in fleet["frames"].items()}


def phase13_requests(traffic):
    """Phase 13's requests in the order its fast lane scored them:
    ``(workload, i, prompt, timed)``, ``timed`` after the warming pass."""
    for workload, sequence in traffic["sequences"].items():
        for i, prompt in enumerate(sequence):
            yield workload, i, prompt, i >= traffic["timed_from"][workload]


def drive_traffic(indexer, traffic, before=None):
    """Phase 13's requests through ``indexer`` in phase 13's order (its
    prefix store then serves what phase 13's did); ``before(n)`` runs
    ahead of the n-th request.  Returns each workload's scores and timed
    latencies (s)."""
    scores, latencies = {}, {}
    for n, (workload, _, prompt, timed) in enumerate(phase13_requests(traffic)):
        if before is not None:
            before(n)
        t0 = time.perf_counter()
        scores.setdefault(workload, []).append(
            indexer.get_pod_scores(prompt, MODEL_NAME, traffic["pods"]))
        if timed:
            latencies.setdefault(workload, []).append(time.perf_counter() - t0)
    return scores, latencies


def score_mismatches(got, traffic) -> list:
    """``(workload, i, got, phase 13's)`` of every request whose scores
    differ from phase 13's fast lane."""
    return [(workload, i, g, w) for workload, want in traffic["scores"].items()
            for i, (g, w) in enumerate(zip(got.get(workload, []), want)) if g != w] + [
        (workload, "count", len(got.get(workload, [])), len(want))
        for workload, want in traffic["scores"].items()
        if len(got.get(workload, [])) != len(want)]


def hit_rate(scores) -> float:
    """Share of requests whose best pod scored above 0."""
    scores = list(scores)
    return sum(1 for s in scores if max(s.values(), default=0.0) > 0) / max(len(scores), 1)


def flat_scores(scores, traffic) -> list:
    return [scores[workload][i] for workload, i, _, _ in phase13_requests(traffic)]


def without_record(entries: dict, record) -> dict:
    """``entries`` ({key: {(pod, tier)}}) without the effect of one
    applied add record: its entries off its request keys."""
    out = {key: set(held) for key, held in entries.items()}
    for key in record.request_keys:
        for entry in record.entries:
            out.get(key, set()).discard((entry.pod_identifier, entry.device_tier))
    return {key: held for key, held in out.items() if held}


class DroppedRecord:
    """A journal that, once ``armed``, loses the next add record and
    passes everything else to ``journal``: the planted fault 14b's gates
    must catch."""

    def __init__(self, journal) -> None:
        self.journal, self.armed = journal, False

    def record_add(self, *args, **kwargs):
        if self.armed:
            self.armed = False
            return
        self.journal.record_add(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.journal, name)


class RestoreClock:
    """The index ``recover`` restores into, seen through the time at
    which its ``restore_entries`` returned: before it, the snapshot's
    load; after it, the journal's replay."""

    def __init__(self, index) -> None:
        self.index, self.restored_at = index, None

    def restore_entries(self, block_entries, engine_map):
        restored = self.index.restore_entries(block_entries, engine_map)
        self.restored_at = time.perf_counter()
        return restored

    def __getattr__(self, name):
        return getattr(self.index, name)


def journal_root(prefix: str):
    """A fresh temporary directory and the mount it lies on."""
    root = tempfile.mkdtemp(prefix=prefix)
    with open("/proc/mounts") as handle:
        return root, mount_of(root, handle.read())


def persistence_phase(smi: str, fleet, traffic, drop_record: bool = False,
                      torn_bytes: int = RESTART_TORN_BYTES) -> dict:
    """Phase 14b: phase 13's index through the port's snapshot and
    journal, and a warm restart from them (bench.py's
    ``bench_indexer_restart`` regime), on the host."""
    persistence, journal_mod = port("persistence"), port("persistence.journal")
    in_memory = port("kvcache.kvblock.in_memory")
    block = traffic["block"]
    root, mount = journal_root("kv-persistence-")
    config = persistence.PersistenceConfig(directory=root)
    frames = phase13_frames(fleet, traffic)
    first = {pod: f[:len(f) // 2] for pod, f in frames.items()}
    rest = {pod: f[len(f) // 2:] for pod, f in frames.items()}
    out = {"card": smi, "mount": mount, "frames": sum(map(len, frames.values()))}
    try:
        live = read_path_indexer(True, True, block)
        manager = persistence.PersistenceManager(config)
        journal = DroppedRecord(manager.journal) if drop_record else manager.journal
        # One worker: the journal's order is then the order of the applies, so
        # each key's holders replay in the order they were added.
        pool = event_pool(live.kv_block_index, live.token_processor, journal=journal,
                          concurrency=1)
        try:
            sink = EventSink(pool)
            t0 = time.perf_counter()
            feed([sink], first)
            pool.drain()
            seed_first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            info = manager.snapshot(live.kv_block_index)
            snapshot_s = time.perf_counter() - t0
            if drop_record:
                journal.armed = True
            t0 = time.perf_counter()
            feed([sink], rest)
            pool.drain()
            seed_rest_s = time.perf_counter() - t0
        finally:
            pool.shutdown()
            manager.close()
            live.shutdown()
        live_dump = dump_content(live.kv_block_index)
        if index_entries(live.kv_block_index) != traffic["entries"]:
            raise AssertionError("14b: the journaled index's entries differ from phase 13's")
        segments = journal_mod.list_segments(config.journal_dir)
        journal_bytes = sum(os.path.getsize(path) for _, path in segments)
        out.update(seed_first_s=seed_first_s, seed_rest_s=seed_rest_s,
                   snapshot={"bytes": info.size_bytes, "write_ms": snapshot_s * 1e3,
                             "block_keys": info.block_keys,
                             "engine_mappings": info.engine_mappings},
                   journal={"segments": len(segments), "bytes": journal_bytes})
        print(f"  on {smi}: {out['frames']} frames (phase 13's, in its order) through a pool with "
              f"the port's Journal tapped in, under {root} on {mount[1]} ({mount[0]}, from "
              f"{mount[2]}): first half {seed_first_s:.2f} s, snapshot {info.size_bytes} bytes "
              f"({info.block_keys} block keys, {info.engine_mappings} engine mappings) written in "
              f"{snapshot_s * 1e3:.1f} ms incl. fsync, second half {seed_rest_s:.2f} s into "
              f"{len(segments)} journal segments ({journal_bytes} bytes)", flush=True)

        warm = read_path_indexer(True, True, block)
        cold = read_path_indexer(True, True, block)
        try:
            clock = RestoreClock(warm.kv_block_index)
            t0 = time.perf_counter()
            report = persistence.recover(clock, config)
            done = time.perf_counter()
            load_s, replay_s = clock.restored_at - t0, done - clock.restored_at
            out["recovery"] = {
                "ms": (done - t0) * 1e3, "snapshot_load_ms": load_s * 1e3,
                "replay_ms": replay_s * 1e3, "records_replayed": report.records_replayed,
                "records_skipped": report.records_skipped,
                "replay_records_per_s": report.records_replayed / replay_s,
                "block_keys_restored": report.block_keys_restored, "status": report.status}
            print(f"  restart: recover() {out['recovery']['ms']:.1f} ms = snapshot load and "
                  f"restore {load_s * 1e3:.1f} ms + journal replay {replay_s * 1e3:.1f} ms "
                  f"({report.records_replayed} records, {report.records_skipped} skipped, "
                  f"{out['recovery']['replay_records_per_s']:.0f} records/s); {report.status}",
                  flush=True)
            if report.status != "warm" or report.torn_tails or report.rejected_snapshots:
                raise AssertionError(f"14b: recovery {report.to_dict()}")
            if dump_content(warm.kv_block_index) != live_dump:
                raise AssertionError("14b: dump_entries() after recovery differs from the live "
                                     "index's")
            clean_entries = index_entries(warm.kv_block_index)
            warm_scores, warm_lat = drive_traffic(warm, traffic)
            bad = score_mismatches(warm_scores, traffic)
            if bad:
                raise AssertionError(f"14b: {len(bad)} requests score unlike phase 13's, e.g. "
                                     f"{bad[:2]}")
            ordered = flat_scores(warm_scores, traffic)
            second = [prompt for _, _, prompt, _ in phase13_requests(traffic)][len(ordered) // 2:]
            cold_scores = [cold.get_pod_scores(p, MODEL_NAME, traffic["pods"]) for p in second]
            out["hit_rate"] = {"cold": hit_rate(cold_scores),
                               "warm": hit_rate(ordered[len(ordered) // 2:]),
                               "requests": len(second)}
            out["warm_p50_ms"] = {w: percentile_ms(lat, 50) for w, lat in warm_lat.items()}
            print(f"  dump_entries() after recovery equal to the live index's ({live_dump[2]} "
                  f"keys, their holders in order, and the engine mappings); phase 13's "
                  f"{len(ordered)} requests in its order score equal to its fast lane's, "
                  f"request by request (p50 " + ", ".join(
                      f"{w} {ms:.3f}" for w, ms in out["warm_p50_ms"].items()) + " ms); the second "
                  f"half's {len(second)} requests hit {out['hit_rate']['warm']:.3f} warm against "
                  f"{out['hit_rate']['cold']:.3f} cold (a fresh index)", flush=True)
        finally:
            warm.shutdown()
            cold.shutdown()

        records = list(journal_mod.iter_journal(config.journal_dir))
        last_id, path = segments[-1]
        size = os.path.getsize(path)
        with open(path, "r+b") as handle:
            handle.truncate(size - torn_bytes)
        torn_index = in_memory.InMemoryIndex()
        torn = persistence.recover(torn_index, config)
        want = without_record(clean_entries, records[-1])
        out["torn"] = {"cut_bytes": torn_bytes, "segment": last_id,
                       "records_replayed": torn.records_replayed, "torn_tails": torn.torn_tails}
        print(f"  the journal's last record cut short by {torn_bytes} bytes: recover() replays "
              f"{torn.records_replayed} of {report.records_replayed} records and names "
              f"{torn.torn_tails}", flush=True)
        if (torn.records_replayed != report.records_replayed - 1 or len(torn.torn_tails) != 1
                or not torn.torn_tails[0].startswith(f"{path}@")
                or index_entries(torn_index) != want):
            raise AssertionError(f"14b: torn-tail recovery {torn.to_dict()}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def dump_content(index):
    """What ``dump_entries()`` holds, as plain data: each request key's
    holders in order, the engine-key mappings, and the two counts.  The
    order of the keys is the index's LRU order, which a replay does not
    keep: the pool applies a message as one batch of mappings and one of
    entries, the journal replays it as one ``add``."""
    blocks, engine_map = index.dump_entries()
    return ({key: [(e.pod_identifier, e.device_tier) for e in entries]
             for key, entries in blocks}, sorted(map(tuple, engine_map)),
            len(blocks), len(engine_map))


class StaleReplica:
    """A replica transport whose lookup replies hold one stale entry: the
    first key's ``hbm`` holders come back on ``host``, the tier before a
    move.  The planted fault 14c's score gate must catch."""

    def __init__(self, transport) -> None:
        self.transport = transport

    def call_vv(self, method, args, traceparent=None, timeout=None):
        payload, spans, vector = self.transport.call_vv(method, args, traceparent, timeout)
        if method == "lookup" and payload:
            key, entries = payload[0]
            stale = [[pod, "host" if tier == "hbm" else tier] for pod, tier in entries]
            payload = [[key, stale]] + list(payload[1:])
        return payload, spans, vector

    def call(self, method, args):
        return self.call_vv(method, args)[0]

    def __getattr__(self, name):
        return getattr(self.transport, name)


def followers_caught_up(cluster, timeout_s: float) -> float:
    """Waits until every follower's tail position is the end of its
    peer's journal; returns the seconds waited."""
    journal_mod = port("persistence.journal")
    t0 = time.perf_counter()
    while True:
        behind = []
        for follower in cluster.followers:
            segments = journal_mod.list_segments(follower.journal_dir)
            end = [segments[-1][0], os.path.getsize(segments[-1][1])] if segments else None
            if segments and follower.status()["position"] != end:
                behind.append(follower.peer_id)
        if not behind:
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"14c: followers of {behind} still behind after {timeout_s} s")
        time.sleep(0.02)


def cluster_phase(smi: str, fleet, traffic, stale: bool = False,
                  replicas=CLUSTER_REPLICAS, catch_up_s: float = CATCH_UP_S) -> dict:
    """Phase 14c: phase 13's fleet and traffic through a 3-replica
    ``LocalCluster`` (strict wire, journal-fed followers), a replica
    killed mid-traffic, then a purge replayed, on the host."""
    cluster_mod, replication = port("cluster"), port("cluster.replication")
    in_memory = port("kvcache.kvblock.in_memory")
    root, mount = journal_root("kv-cluster-")
    wrap = (lambda rid, t: StaleReplica(t) if rid == replicas[0] else t) if stale else None
    cluster = cluster_mod.LocalCluster(replicas, journal_root=root, strict_wire=True,
                                       transport_wrap=wrap)
    cluster.start(heartbeat=False)
    remote = cluster.remote_index
    indexer = read_path_indexer(True, True, traffic["block"], index=remote)
    frames = phase13_frames(fleet, traffic)
    out = {"card": smi, "mount": mount, "replicas": list(replicas)}
    try:
        pool = event_pool(remote, indexer.token_processor)
        try:
            t0 = time.perf_counter()
            feed([EventSink(pool)], frames)
            pool.drain()
            seed_s = time.perf_counter() - t0
        finally:
            pool.shutdown()
        caught_s = followers_caught_up(cluster, catch_up_s)
        keys = len(traffic["entries"])
        local = {rid: len(r.index.dump_entries()[0]) for rid, r in cluster.replicas.items()}
        out["seeding"] = {"seconds": seed_s, "keys_per_s": keys / seed_s,
                          "followers_caught_up_s": caught_s, "replica_keys": local}
        print(f"  on {smi}: LocalCluster({len(replicas)} replicas, strict wire, followers "
              f"polling, journals under {root} on {mount[1]} ({mount[0]})); phase 13's "
              f"{sum(map(len, frames.values()))} frames through a pool over the RemoteIndex: "
              f"{seed_s:.2f} s, {keys / seed_s:.0f} keys/s; followers at their peers' journal "
              f"ends {caught_s:.2f} s later; keys a replica (own slice and standby) {local}",
              flush=True)
        if index_entries(remote) != traffic["entries"]:
            raise AssertionError("14c: the cluster's entries differ from phase 13's")

        total = sum(len(s) for s in traffic["sequences"].values())
        # Half-way through the last workload (the mixed one, half of it warm
        # turns), so the requests after the kill include hits.
        kill_at = total - len(list(traffic["sequences"].values())[-1]) // 2
        first_key = indexer.token_processor.tokens_to_kv_block_keys(
            0, [int(w[1:]) for w in traffic["sequences"]["warm_multi_turn"][0].split(" ")],
            MODEL_NAME)[0]
        victim = cluster.membership.ring().owner(first_key)
        before = cluster.membership.status()
        kill_s = []

        def kill(n):
            if n == kill_at:
                kill_s.append(time.perf_counter())
                cluster.kill(victim, notice=False)

        scores, latencies = drive_traffic(indexer, traffic, before=kill)
        # A request the score memo serves reaches the victim only through
        # its recency touch, which runs off the request's thread: let those
        # land before reading the membership.
        deadline = time.perf_counter() + 10.0
        while (cluster.membership.status()["failovers"] == before["failovers"]
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        after = cluster.membership.status()
        bad = score_mismatches(scores, traffic)
        ordered, want = flat_scores(scores, traffic), flat_scores(traffic["scores"], traffic)
        window = slice(kill_at, min(total, kill_at + 50))
        out["traffic"] = {
            w: {"p50_ms": percentile_ms(lat, 50), "p99_ms": percentile_ms(lat, 99),
                "requests": len(lat)} for w, lat in latencies.items()}
        stats = remote.rpc_stats()
        out["rpc"] = {"fanout": stats["fanout"], "critical_path": stats["critical_path"],
                      "reroutes": stats["reroutes"]}
        out["failover"] = {
            "victim": victim, "at_request": kill_at,
            "ring_version": [before["ring_version"], after["ring_version"]],
            "failovers": [before["failovers"], after["failovers"]],
            "hit_rate_dip": hit_rate(want[window]) - hit_rate(ordered[window])}
        print("  phase 13's requests in its order through Indexer(kv_block_index=RemoteIndex), "
              "fast lane, pipelined chunk drive: " + "; ".join(
                  f"{w} p50 {c['p50_ms']:.3f} ms p99 {c['p99_ms']:.3f} ms (phase 13's fast lane "
                  f"{traffic['cells'][w]['p50_ms']:.3f} / {traffic['cells'][w]['p99_ms']:.3f})"
                  for w, c in out["traffic"].items()), flush=True)
        print(f"  rpc_stats: fanout {stats['fanout']}; critical path "
              f"{stats['critical_path']}; reroutes {stats['reroutes']}", flush=True)
        print(f"  {victim} (owner of the conversation's first key) killed through its transport "
              f"before request {kill_at} of {total}: ring version "
              f"{before['ring_version']} -> {after['ring_version']}, failovers "
              f"{before['failovers']} -> {after['failovers']}; hit rate over the next "
              f"{window.stop - window.start} requests {hit_rate(ordered[window]):.3f} against "
              f"phase 13's {hit_rate(want[window]):.3f} (dip "
              f"{out['failover']['hit_rate_dip']:.3f})", flush=True)
        if bad:
            raise AssertionError(f"14c: {len(bad)} requests score unlike phase 13's in-memory "
                                 f"fast lane, e.g. {bad[:2]}")
        if (after["ring_version"] != before["ring_version"] + 1
                or after["failovers"] != before["failovers"] + 1):
            raise AssertionError(f"14c: failover {out['failover']}")
        print(f"  every score equal to phase 13's in-memory fast lane, before and after the "
              f"failover ({total} requests)", flush=True)

        removed = remote.purge_pod(PURGED_POD)
        replay_wait = followers_caught_up(cluster, catch_up_s)
        held = {pod for entries in index_entries(remote).values() for pod, _ in entries}
        replayed, records = [], 0
        for rid in cluster.membership.alive():
            fresh = in_memory.InMemoryIndex()
            follower = replication.ReplicationFollower(rid, cluster.journal_dirs[rid], fresh)
            while True:
                read = follower.sync_once()
                records += read
                if not read:
                    break
            replayed.append({pod for entries in index_entries(fresh).values()
                             for pod, _ in entries})
        warm_prompts = set(traffic["sequences"]["warm_multi_turn"])
        last_score = {}
        for workload, i, prompt, _ in phase13_requests(traffic):
            if prompt in warm_prompts:
                last_score[prompt] = dict(traffic["scores"][workload][i], **{PURGED_POD: 0.0})
        rescored = {p: indexer.get_pod_scores(p, MODEL_NAME, traffic["pods"])
                    for p in last_score}
        out["purge"] = {"pod": PURGED_POD, "removed": removed, "followers_s": replay_wait,
                        "replayed_records": records,
                        "resurrected": PURGED_POD in held or any(PURGED_POD in r
                                                                 for r in replayed)}
        print(f"  purge of {PURGED_POD} through the RemoteIndex: {removed} entries removed; "
              f"followers replayed it in {replay_wait:.2f} s; a fresh replay of every alive "
              f"replica's whole journal ({records} records) and the cluster hold "
              f"{PURGED_POD}: {out['purge']['resurrected']}; the warm turns rescored with "
              f"{PURGED_POD} at 0.0", flush=True)
        if out["purge"]["resurrected"] or rescored != last_score:
            raise AssertionError(f"14c: purged entries of {PURGED_POD} returned")
    finally:
        indexer.shutdown()
        cluster.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


# -------------------------------------------------------------- phase 14d


SERVICE_CLIENTS = 4  # 14d's concurrent keep-alive clients
SERVICE_PROFILE_HZ = 50.0
CAPTURE_MAX_BYTES = 1 << 30  # both rings hold phase 13's frames and requests whole
SERVICE_ROLES = ("http-handler", "events")  # thread roles /debug/profile must attribute
WHATIF_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "WHATIF_r01.json")


def concurrent_requests(server, requests, clients: int):
    """``requests`` ((prompt, pods) pairs) split over ``clients`` threads,
    each with its own keep-alive connection: (scores in request order,
    each request's seconds, the wall seconds of the whole)."""
    scores, latencies = [None] * len(requests), [None] * len(requests)
    errors = []

    def run(k: int) -> None:
        client = HttpClient(server)
        try:
            for n in range(k, len(requests), clients):
                prompt, pods = requests[n]
                t0 = time.perf_counter()
                scores[n] = client.ok("POST", "/score_completions",
                                      {"prompt": prompt, "model": MODEL_NAME, "pods": pods})
                latencies[n] = time.perf_counter() - t0
        except BaseException as exc:  # noqa: BLE001 - raised on the caller's thread
            errors.append(exc)
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(k,), name=f"client-{k}")
               for k in range(clients)]
    t0 = time.perf_counter()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return scores, latencies, wall


# One client of phase 14d in its own interpreter: argv is the service's
# port, the job file ({"model", "requests": [[prompt, pods], ...]}), this
# client's number k, the number of clients and its result file.  It
# connects, says "ready", waits for a line on stdin, sends requests k,
# k + clients, ... over its one keep-alive connection and writes their
# scores, their seconds and its first send and last answer on the
# system-wide monotonic clock.
CLIENT_SCRIPT = r"""
import http.client, json, sys, time
port, job, k, clients, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
with open(job) as handle:
    job = json.load(handle)
conn = http.client.HTTPConnection("127.0.0.1", int(port), timeout=120)
conn.connect()
print("ready", flush=True)
sys.stdin.readline()
result = {"scores": {}, "seconds": {}}
result["start"] = time.monotonic()
for n in range(k, len(job["requests"]), clients):
    prompt, pods = job["requests"][n]
    body = json.dumps({"prompt": prompt, "model": job["model"], "pods": pods}).encode()
    t0 = time.monotonic()
    conn.request("POST", "/score_completions", body=body,
                 headers={"Content-Type": "application/json"})
    response = conn.getresponse()
    raw = response.read()
    result["seconds"][n] = time.monotonic() - t0
    if response.status != 200:
        sys.exit(f"request {n}: HTTP {response.status}: {raw[:300]!r}")
    result["scores"][n] = json.loads(raw)
result["end"] = time.monotonic()
conn.close()
with open(out, "w") as handle:
    json.dump(result, handle)
"""


def client_processes(server, requests, clients: int, root: str):
    """``requests`` ((prompt, pods) pairs) split over ``clients`` client
    processes, each with its own keep-alive connection, let go together
    once every one has connected: (scores in request order, each
    request's seconds, the seconds from the first send to the last
    answer)."""
    job = os.path.join(root, "requests.json")
    with open(job, "w") as handle:
        json.dump({"model": MODEL_NAME, "requests": requests}, handle)
    outs = [os.path.join(root, f"client-{k}.json") for k in range(clients)]
    procs = []
    try:
        for k in range(clients):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CLIENT_SCRIPT, str(server.server_address[1]), job,
                 str(k), str(clients), outs[k]],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
        for k, proc in enumerate(procs):
            if proc.stdout.readline().strip() != "ready":
                raise AssertionError(f"14d: client process {k} did not connect")
        for proc in procs:
            proc.stdin.write("go\n")
            proc.stdin.flush()
        for k, proc in enumerate(procs):
            if proc.wait(timeout=600) != 0:
                raise AssertionError(f"14d: client process {k} exited {proc.returncode}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdin.close()
            proc.stdout.close()
    scores, latencies, spans = [None] * len(requests), [None] * len(requests), []
    for out in outs:
        with open(out) as handle:
            result = json.load(handle)
        for n, value in result["scores"].items():
            scores[int(n)] = value
            latencies[int(n)] = result["seconds"][n]
        spans.append((result["start"], result["end"]))
    return scores, latencies, max(end for _, end in spans) - min(start for start, _ in spans)


def service_phase(smi: str, fleet, traffic) -> dict:
    """Phase 14d: phase 13's fleet and traffic through the port's HTTP
    service with its observability plane wired in (an SLO engine, the
    sampling profiler, a gauge timeline, input capture and an incident
    manager), on the host; the incident's capture replayed, and the
    what-if engine's reference A/B."""
    obs, service = port("obs"), port("api.http_service")
    kv = port("kvevents.pool")
    block, pods = traffic["block"], traffic["pods"]
    frames = phase13_frames(fleet, traffic)
    out = {"card": smi, "frames": sum(map(len, frames.values())), "clients": SERVICE_CLIENTS}
    capture = obs.InputCaptureRecorder(
        obs.CaptureConfig(window_s=3600.0, max_bytes=CAPTURE_MAX_BYTES),
        meta={"block_size": block, "hash_seed": "0", "model": MODEL_NAME})
    profiler = obs.SamplingProfiler(obs.ProfilerConfig(hz=SERVICE_PROFILE_HZ))
    root = tempfile.mkdtemp(prefix="kv-incidents-")
    indexer = read_path_indexer(True, True, block, capture=capture)
    pool = kv.Pool(indexer.kv_block_index, indexer.token_processor, kv.PoolConfig(),
                   capture=capture)
    timeline = obs.GaugeTimeline(window_s=600)
    slo, server = None, None
    try:
        profiler.start()
        pool.start()
        sink = EventSink(pool)
        t0 = time.perf_counter()
        feed([sink], frames)
        pool.drain()
        seed_s = time.perf_counter() - t0
        if index_entries(indexer.kv_block_index) != traffic["entries"]:
            raise AssertionError("14d: the captured index's entries differ from phase 13's")
        obs.register_default_series(timeline, pool=pool)
        timeline.start()
        slo = obs.default_fleet_slos(window_fast_s=10.0, window_slow_s=60.0, pool=pool)
        slo.start(1.0)
        incidents = obs.IncidentManager(
            root, capture=capture, index=indexer.kv_block_index, min_interval_s=0.0,
            sources={"profile": lambda: profiler.status(top=20),
                     "slo": lambda: slo.last_payload() or {"no_data": True}})
        server = service.serve(
            indexer, host="127.0.0.1", port=0, slo=slo, profiler=profiler, timeline=timeline,
            capture=capture, incidents=incidents, event_plane_status=lambda: {
                "pollers": 0, "subscriptions": len(sink.trackers), "stages": pool.stage_stats()})
        print(f"  on {smi}: a fresh fast-lane Indexer with the port's InputCaptureRecorder "
              f"tapped into it and its event pool, seeded from phase 13's {out['frames']} "
              f"frames in {seed_s:.2f} s (its entries phase 13's), behind serve() with an SLO "
              f"engine, the sampling profiler ({SERVICE_PROFILE_HZ:.0f} Hz), a gauge timeline "
              f"and an incident manager", flush=True)

        # Phase 13's requests in its order over one keep-alive connection,
        # each with the server's own time in it: the handler's call of
        # get_pod_scores (capture recording included), timed around it.
        server_s, scoring = [], indexer.get_pod_scores

        def timed_scoring(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return scoring(*args, **kwargs)
            finally:
                server_s.append(time.perf_counter() - t0)

        indexer.get_pod_scores = timed_scoring
        client = HttpClient(server)
        try:
            got, latencies, inside = {}, {}, {}
            for workload, i, prompt, timed in phase13_requests(traffic):
                t0 = time.perf_counter()
                got.setdefault(workload, []).append(client.ok(
                    "POST", "/score_completions",
                    {"prompt": prompt, "model": MODEL_NAME, "pods": pods}))
                if timed:
                    latencies.setdefault(workload, []).append(time.perf_counter() - t0)
                    inside.setdefault(workload, []).append(server_s[-1])
        finally:
            client.close()
            del indexer.get_pod_scores  # the class's method again
        bad = score_mismatches(got, traffic)
        if bad:
            raise AssertionError(f"14d: {len(bad)} requests over HTTP score unlike phase 13's, "
                                 f"e.g. {bad[:2]}")
        if len(server_s) != sum(map(len, got.values())):
            raise AssertionError(f"14d: {len(server_s)} scoring calls in the server for "
                                 f"{sum(map(len, got.values()))} requests")
        cells = {w: {"requests": len(lat), "p50_ms": percentile_ms(lat, 50),
                     "p99_ms": percentile_ms(lat, 99),
                     "server_p50_ms": percentile_ms(inside[w], 50),
                     "server_p99_ms": percentile_ms(inside[w], 99),
                     "outside_p50_ms": percentile_ms(
                         [a - b for a, b in zip(lat, inside[w])], 50),
                     "in_process_p50_ms": traffic["cells"][w]["p50_ms"],
                     "in_process_p99_ms": traffic["cells"][w]["p99_ms"]}
                 for w, lat in latencies.items()}
        out["sequential"] = cells
        print(f"  phase 13's {sum(map(len, got.values()))} requests in its order by POST "
              f"/score_completions over one keep-alive connection, each response equal to "
              f"phase 13's fast lane's: " + "; ".join(
                  f"{w} p50 {c['p50_ms']:.3f} ms p99 {c['p99_ms']:.3f} ms, of which the "
                  f"server's get_pod_scores p50 {c['server_p50_ms']:.3f} p99 "
                  f"{c['server_p99_ms']:.3f} ms and the rest (HTTP, JSON, handler) p50 "
                  f"{c['outside_p50_ms']:.3f} ms (phase 13 in-process "
                  f"{c['in_process_p50_ms']:.3f} / {c['in_process_p99_ms']:.3f} ms)"
                  for w, c in cells.items()), flush=True)

        # The incident right after phase 13's requests: its capture holds
        # every frame and every one of those requests.
        client = HttpClient(server)
        try:
            t0 = time.perf_counter()
            manifest = client.ok("POST", "/admin/incident", {"reason": "phase 14d"})
            incident_s = time.perf_counter() - t0
            detail = client.ok("GET", f"/debug/incidents/{manifest['id']}")
        finally:
            client.close()
        path = os.path.join(root, manifest["id"], "capture.cbor")
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        artifact = obs.load_capture(path)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        report = obs.replay_capture(artifact, mode="single")
        replay_s = time.perf_counter() - t0
        records = len(artifact["records"])
        scored = sum(1 for record in artifact["records"] if record[0] == 1)
        out["incident"] = {"id": manifest["id"], "files": manifest["files"],
                           "bundle_ms": incident_s * 1e3, "capture_bytes": size,
                           "truncated": artifact["truncated"], "records": records,
                           "scores": scored, "load_ms": load_s * 1e3,
                           "replay_ms": replay_s * 1e3, "replay_records_per_s": records / replay_s,
                           "replay": report.to_dict()}
        print(f"  POST /admin/incident: bundle {manifest['id']} ({manifest['files']}, "
              f"{len(detail['inventory'])} files) in {incident_s * 1e3:.0f} ms; capture.cbor "
              f"{size} bytes, {records} records ({scored} scoring requests), truncated "
              f"{artifact['truncated']}; load_capture {load_s * 1e3:.0f} ms, "
              f"replay_capture(single) {replay_s * 1e3:.0f} ms ({records / replay_s:.0f} "
              f"records/s): {report.scores_compared} scores and the index state compared, "
              f"ok {report.ok}", flush=True)
        want_scored = sum(map(len, got.values()))
        if artifact["truncated"] or scored != want_scored:
            raise AssertionError(f"14d: the capture holds {scored} of {want_scored} scoring "
                                 f"requests, truncated {artifact['truncated']}")
        if not report.ok or report.scores_compared != scored or not report.state_compared:
            raise AssertionError(f"14d: the incident's replay {report.to_dict()}")
        del artifact

        # The timed requests again from concurrent clients: every prompt's
        # answer is then the one phase 13 gave it once its store was warm.
        steady = {}
        for workload, i, prompt, timed in phase13_requests(traffic):
            if timed:
                steady[prompt] = traffic["scores"][workload][i]
        requests = [(prompt, pods) for workload, i, prompt, timed in phase13_requests(traffic)
                    if timed]
        # Each client on its own keep-alive connection: one client process,
        # then SERVICE_CLIENTS processes (the service's own rate), then as
        # many threads of this process (which share its interpreter).
        out["clients"] = {}
        for what, drive in (
                ("1 process", lambda: client_processes(server, requests, 1, root)),
                (f"{SERVICE_CLIENTS} processes",
                 lambda: client_processes(server, requests, SERVICE_CLIENTS, root)),
                (f"{SERVICE_CLIENTS} threads of this process",
                 lambda: concurrent_requests(server, requests, SERVICE_CLIENTS))):
            scores, lat, wall = drive()
            wrong = [n for n, (prompt, _) in enumerate(requests) if scores[n] != steady[prompt]]
            if wrong:
                raise AssertionError(f"14d: {len(wrong)} responses to {what} differ from "
                                     f"phase 13's, e.g. request {wrong[0]}: {scores[wrong[0]]}")
            row = out["clients"][what] = {
                "requests": len(requests), "requests_per_s": len(requests) / wall,
                "p50_ms": percentile_ms(lat, 50), "p99_ms": percentile_ms(lat, 99)}
            print(f"  the {len(requests)} timed requests again from {what}, each client on "
                  f"its own keep-alive connection: {row['requests_per_s']:.1f} requests/s "
                  f"(first send to last answer), p50 {row['p50_ms']:.3f} ms, p99 "
                  f"{row['p99_ms']:.3f} ms, every response equal to phase 13's", flush=True)

        client = HttpClient(server)
        try:
            surfaces = client.ok("GET", "/debug/")
            slo_view = client.ok("GET", "/debug/slo")
            profile = client.ok("GET", "/debug/profile")
            timeline_view = client.ok("GET", "/debug/timeline?series=score_requests_total")
            enabled = sorted(v["path"] for v in surfaces["surfaces"] if v["enabled"])
            roles = profile["roles"]
            missing = [role for role in SERVICE_ROLES if not roles.get(role)]
            print(f"  GET /debug/ lists {enabled} enabled; /debug/slo state "
                  f"{slo_view.get('state')}; /debug/profile {profile['samples']} samples, "
                  f"{profile['attributed_fraction']:.3f} attributed, roles {roles}; "
                  f"/debug/timeline score_requests_total "
                  f"{len(timeline_view['series'].get('score_requests_total', {}).get('points', []))}"
                  f" points", flush=True)
            if missing:
                raise AssertionError(f"14d: /debug/profile attributes no samples to {missing}")
        finally:
            client.close()
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if slo is not None:
            slo.close()
        timeline.close()
        profiler.close()
        pool.shutdown()
        indexer.shutdown()
        shutil.rmtree(root, ignore_errors=True)

    whatif = port("obs.whatif")
    t0 = time.perf_counter()
    live = whatif.gate_headlines(whatif.reference_ab())
    ab_s = time.perf_counter() - t0
    with open(WHATIF_BASELINE) as handle:
        recorded = json.load(handle)["headlines"]
    out["whatif"] = {"headlines": live, "seconds": ab_s}
    print(f"  the port's reference_ab() over {whatif.reference_capture_path()} in "
          f"{ab_s:.2f} s: gate_headlines {live}, WHATIF_r01.json's {recorded}", flush=True)
    if live != recorded:
        raise AssertionError(f"14d: reference_ab's headlines {live}, recorded {recorded}")
    return out


# ------------------------------------------------------------- phase 14e


GRPC_LIBRARIES = ("grpc", "google.protobuf")
GRPC_UDS_SAMPLE = 64  # phase 13's requests scored again through the tokenizer sidecar


def library_versions(names=GRPC_LIBRARIES) -> dict:
    """{name: its version, or None when it cannot be imported here}."""
    out = {}
    for name in names:
        try:
            out[name] = getattr(importlib.import_module(name), "__version__", "unknown")
        except ImportError:
            out[name] = None
    return out


class HfWordTokenizer:
    """The card's ``WordTokenizer`` behind the call that the sidecar's
    ``Tokenize`` makes of a Hugging Face tokenizer
    (``services/uds_tokenizer.py``): ids and char offsets (the words are
    ASCII, so they are its byte offsets too)."""

    def __call__(self, text, add_special_tokens=False, return_offsets_mapping=True):
        encoding = WordTokenizer().encode(text, MODEL_NAME, add_special_tokens)
        return {"input_ids": encoding.tokens, "offset_mapping": encoding.offsets}


def grpc_phase(smi: str, fleet, traffic, http_cells=None, sample: int = GRPC_UDS_SAMPLE) -> dict:
    """Phase 14e: phase 13's fleet and traffic through the port's gRPC
    scoring service (``api.indexer_service``) on a Unix socket, every
    answer held equal to phase 13's in-process one and a sampled
    traceparent echoed; then the tokenizer sidecar
    (``services.uds_tokenizer``) with the card's word tokenizer
    registered, and an Indexer configured with ``uds_tokenizer_path``
    scoring a sample of phase 13's requests as the word-tokenizer
    Indexer does.  When ``grpc`` or ``google.protobuf`` cannot be
    imported on this host, it says which and runs nothing."""
    libraries = library_versions()
    missing = [name for name, version in libraries.items() if version is None]
    print(f"  on {smi}: " + ", ".join(
        f"{name} {version or 'cannot be imported'}" for name, version in libraries.items()),
        flush=True)
    if missing:
        print(f"  14e: {' and '.join(missing)} cannot be imported on this host; the gRPC service "
              f"and the tokenizer sidecar are checked on the CPU only (tests/"
              f"test_torch_grpc_api.py), and nothing of 14e runs here", flush=True)
        return {"libraries": libraries, "ran": False}
    service, pb2 = port("api.indexer_service"), port("api.indexer_pb2")
    sidecar, im, kv = port("services.uds_tokenizer"), port("kvcache.indexer"), port(
        "kvevents.pool")
    tracer = port("obs.trace").TRACER
    block, pods = traffic["block"], traffic["pods"]
    frames = phase13_frames(fleet, traffic)
    root = tempfile.mkdtemp(prefix="kv-grpc-")
    out = {"libraries": libraries, "ran": True, "card": smi}
    indexer = read_path_indexer(True, True, block)
    pool = kv.Pool(indexer.kv_block_index, indexer.token_processor, kv.PoolConfig())
    server = client = tok_server = None
    lanes = []
    try:
        pool.start()
        feed([EventSink(pool)], frames)
        pool.drain()
        if index_entries(indexer.kv_block_index) != traffic["entries"]:
            raise AssertionError("14e: the index's entries differ from phase 13's")
        address = "unix://" + os.path.join(root, "indexer.sock")
        server = service.serve(indexer, address)
        client = service.new_client(address)
        got, latencies = {}, {}
        for workload, _, prompt, timed in phase13_requests(traffic):
            t0 = time.perf_counter()
            response = client.GetPodScores(pb2.GetPodScoresRequest(
                prompt=prompt, model_name=MODEL_NAME, pod_identifiers=pods), timeout=120)
            if timed:
                latencies.setdefault(workload, []).append(time.perf_counter() - t0)
            got.setdefault(workload, []).append({s.pod: s.score for s in response.scores})
        bad = score_mismatches(got, traffic)
        n = sum(map(len, got.values()))
        if bad:
            raise AssertionError(f"14e: {len(bad)} of {n} answers over gRPC differ from phase "
                                 f"13's, e.g. {bad[:2]}")
        cells = {w: {"requests": len(lat), "p50_ms": percentile_ms(lat, 50),
                     "p99_ms": percentile_ms(lat, 99),
                     "in_process_p50_ms": traffic["cells"][w]["p50_ms"],
                     "in_process_p99_ms": traffic["cells"][w]["p99_ms"],
                     "http_p50_ms": (http_cells or {}).get(w, {}).get("p50_ms"),
                     "http_p99_ms": (http_cells or {}).get(w, {}).get("p99_ms")}
                 for w, lat in latencies.items()}
        out.update(requests=n, sequential=cells)
        http_text = lambda c: ("" if c["http_p50_ms"] is None else  # noqa: E731
                               f", 14d's HTTP {c['http_p50_ms']:.3f} / {c['http_p99_ms']:.3f}")
        print(f"  phase 13's {n} requests in its order by GetPodScores over one channel on a Unix "
              f"socket, every answer equal to phase 13's fast lane's: " + "; ".join(
                  f"{w} p50 {c['p50_ms']:.3f} ms p99 {c['p99_ms']:.3f} ms (in-process "
                  f"{c['in_process_p50_ms']:.3f} / {c['in_process_p99_ms']:.3f}{http_text(c)})"
                  for w, c in cells.items()), flush=True)

        # A sampled traceparent rides the metadata and comes back.
        trace_id = f"{SEED + 14:032x}"
        workload, _, prompt, _ = next(iter(phase13_requests(traffic)))
        response, call = client.GetPodScores.with_call(
            pb2.GetPodScoresRequest(prompt=prompt, model_name=MODEL_NAME, pod_identifiers=pods),
            metadata=(("traceparent", f"00-{trace_id}-{'ab' * 8}-01"),), timeout=120)
        echoed = dict(call.initial_metadata()).get("traceparent")
        trace = tracer.recorder.get(trace_id)
        trace = trace.to_dict() if trace is not None else {}
        spans = sorted({sp["name"] for sp in trace.get("spans", ())})
        out["traceparent"] = {"echoed": echoed, "trace": trace.get("name"), "spans": spans}
        print(f"  a sampled traceparent in the metadata: echoed {echoed}; trace "
              f"{trace.get('name')} under parent {trace.get('parent_span_id')}, spans {spans}",
              flush=True)
        if (echoed is None or echoed.split("-")[1] != trace_id
                or trace.get("name") != "grpc.get_pod_scores"
                or trace.get("parent_span_id") != "ab" * 8
                or not {"index_lookup", "score"} <= set(spans)):
            raise AssertionError(f"14e: traceparent echoed {echoed}, trace {out['traceparent']}")

        # The tokenizer sidecar, with the card's word tokenizer registered.
        registry = sidecar.TokenizerRegistry()
        registry.register(MODEL_NAME, HfWordTokenizer())
        tok_path = os.path.join(root, "tokenizer.sock")
        tok_server = sidecar.serve(tok_path, max_workers=4, registry=registry)
        uds = im.Indexer(dataclasses.replace(indexer.config, uds_tokenizer_path=tok_path),
                         kv_block_index=indexer.kv_block_index)
        lanes.append(uds)
        uds.run()
        words_lane = read_path_indexer(True, True, block, index=indexer.kv_block_index)
        lanes.append(words_lane)
        backends = [b.type() for b in uds.tokenization_pool._tokenizer.backends]
        requests = list(phase13_requests(traffic))
        picked = requests[::max(1, len(requests) // sample)][:sample]
        via_uds, via_words, uds_s = [], [], []
        for _, _, prompt, _ in picked:
            t0 = time.perf_counter()
            via_uds.append(uds.get_pod_scores(prompt, MODEL_NAME, pods))
            uds_s.append(time.perf_counter() - t0)
            via_words.append(words_lane.get_pod_scores(prompt, MODEL_NAME, pods))
        differing = [i for i, (a, b) in enumerate(zip(via_uds, via_words)) if a != b]
        out["sidecar"] = {"backends": backends, "requests": len(picked),
                          "differing": len(differing), "p50_ms": percentile_ms(uds_s, 50),
                          "p99_ms": percentile_ms(uds_s, 99),
                          "hits": sum(1 for s in via_uds if max(s.values(), default=0) > 0)}
        row = out["sidecar"]
        print(f"  the tokenizer sidecar on a Unix socket with the word tokenizer registered; an "
              f"Indexer with uds_tokenizer_path and no tokenizer of its own (backends "
              f"{backends}) scored {len(picked)} of phase 13's requests (every "
              f"{max(1, len(requests) // sample)}th, {row['hits']} hits) as the word-tokenizer "
              f"Indexer over the same index did: {len(picked) - len(differing)} equal; p50 "
              f"{row['p50_ms']:.3f} ms p99 {row['p99_ms']:.3f} ms a request", flush=True)
        if differing or backends[0] != "uds" or not row["hits"]:
            raise AssertionError(f"14e: through the sidecar {len(differing)} of {len(picked)} "
                                 f"requests score otherwise, e.g. {differing[:3]}; backends "
                                 f"{backends}")
    finally:
        if client is not None:
            client.channel.close()
        if server is not None:
            server.stop(grace=None)
        for lane in lanes:
            for backend in getattr(lane.tokenization_pool._tokenizer, "backends", ()):
                if backend.type() == "uds":
                    backend.close()
            lane.shutdown()
        if tok_server is not None:
            tok_server.stop(grace=None)
        pool.shutdown()
        indexer.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    return out



# Phase 7d: hack/offload_smoke_torch.py in this process, at
# Llama-3-8B's KV geometry on the card.
OFFLOAD_SMOKE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hack",
                             "offload_smoke_torch.py")
OFFLOAD_SMOKE_LADDER = (1.0, 0.8, 0.5)  # a block's score at hbm, host, shared storage


def offload_smoke_phase(smi: str, device: str = "cuda:0", geometry: str = "llama3_8b",
                        after_load=None) -> dict:
    """Phase 7d: the offload smoke's ``main`` on ``device`` at
    ``geometry``.  It must report a bit-identical round trip, the score
    ladder 1.0 -> 0.8 -> 0.5 a block and, on a CUDA pool, the pinned
    staging path; returns its walls with their GB/s.  ``after_load``
    goes to ``main`` (a planted fault)."""
    smoke = runpy.run_path(OFFLOAD_SMOKE, run_name="offload_smoke_torch")
    t0 = time.perf_counter()
    result = smoke["main"](["--device", device, "--geometry", geometry], after_load=after_load)
    seconds = time.perf_counter() - t0
    if result["round_trip"] != "bit-identical":
        raise RuntimeError(f"7d: the round trip came back {result['round_trip']}")
    ladder = result["score_ladder"]
    if len(ladder) != len(OFFLOAD_SMOKE_LADDER) or any(
            abs(got - want) > 1e-9 for got, want in zip(ladder, OFFLOAD_SMOKE_LADDER)):
        raise RuntimeError(f"7d: score ladder {ladder}, want {list(OFFLOAD_SMOKE_LADDER)}")
    if device.startswith("cuda") and not result["uses_pinned"]:
        raise RuntimeError("7d: the CUDA pool's staging did not take the pinned path")
    import torch

    plain = plain_slots_check(torch, smoke["geometry"](geometry), device)
    nbytes = result["round_trip_bytes"]
    out = dict(result, plain_slots=plain, store_gbps=nbytes / result["store_s"] / 1e9,
               load_gbps=nbytes / result["load_s"] / 1e9, seconds=round(seconds, 1), card=smi)
    print(f"  {smi}: {geometry} pool on {device}, {result['block_nbytes']} B a block; round "
          f"trip of {nbytes} B bit-identical, store {result['store_s'] * 1e3:.3f} ms "
          f"({out['store_gbps']:.3f} GB/s), load {result['load_s'] * 1e3:.3f} ms "
          f"({out['load_gbps']:.3f} GB/s); score ladder {ladder}; pinned staging "
          f"{result['uses_pinned']}; {seconds:.1f} s", flush=True)
    return out


def plain_slots_check(torch, pool_config, device: str, tamper=None) -> dict:
    """Phase 7d's ``StagingConfig(use_pinned=...)`` check: random bytes in
    a pool of ``pool_config`` on ``device``, two files' groups stored by a
    staging engine that follows the pool (the pinned side-stream path on
    a CUDA pool) and by one forced to plain slots (``use_pinned=False``);
    the two file trees must be byte-identical and each file must hold
    its blocks' bytes from the pool.  ``tamper(root)`` runs on the plain
    tree before the comparison (a planted fault)."""
    pool_mod = port("models.kv_cache_pool")
    spec_mod, staging_mod = port("offload.spec"), port("offload.staging_engine")
    job_status = port("native.engine").JobStatus
    group_blocks = port("offload.worker").group_blocks_per_file
    per_file = 4
    pool = pool_mod.KVCachePool(dataclasses.replace(pool_config, num_blocks=4 * per_file),
                                device=device)
    gen = torch.Generator(device=pool.kv.device).manual_seed(SEED + 80)
    pool.kv.copy_(torch.randn(pool.kv.shape, generator=gen, device=pool.kv.device)
                  .to(pool.kv.dtype))
    ids, hashes = [9, 2, 14, 5, 0, 11, 7], [0xD1, 0xD2]
    trees, paths, uses = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="kvtpu-plain-slots-") as tmp:
        for use_pinned in (None, False):
            root = os.path.join(tmp, "plain" if use_pinned is False else "pool")
            conn = spec_mod.TPUOffloadConnector(spec_mod.TPUOffloadSpec(
                shared_storage_path=root, model_name="plain-slots",
                device_block_size=pool.config.block_size,
                offloaded_block_size=per_file * pool.config.block_size,
                threads_per_chip=2, dtype=pool.config.dtype, staging_lanes=0), pool)
            try:
                staging = staging_mod.StagingEngine(
                    pool, conn.engine, conn.file_mapper, per_file,
                    staging_mod.StagingConfig(lanes_per_chip=1, use_pinned=use_pinned))
                uses[use_pinned] = staging.uses_pinned
                staging.store(1, group_blocks(hashes, ids, per_file))
                if staging.wait(1) != job_status.SUCCEEDED:
                    raise RuntimeError(f"7d: the store with use_pinned={use_pinned} failed")
                paths[use_pinned] = [conn.file_mapper.get_file_name(h) for h in hashes]
            finally:
                conn.close()
            if use_pinned is False and tamper is not None:
                tamper(root)
            trees[use_pinned] = [open(path, "rb").read() for path in paths[use_pinned]]
    if uses[False] or uses[None] != pool.pinned_host:
        raise AssertionError(f"7d: uses_pinned {uses}, the pool's pinned path "
                             f"{pool.pinned_host}")
    want = [pool.gather_block_major(ids[i:i + per_file]).tobytes()
            for i in range(0, len(ids), per_file)]
    for name, tree in (("plain slots", trees[False]), ("pool's path", trees[None])):
        if tree != want:
            raise AssertionError(f"7d: the {name}' files are not byte-identical to the pool")
    nbytes = sum(len(b) for b in want)
    print(f"  use_pinned=False on a pool on {device}: {len(want)} files, {nbytes} B, "
          f"byte-identical to the pinned path's (uses_pinned {uses[None]}) and to the pool",
          flush=True)
    return {"files": len(want), "bytes": nbytes, "pool_path_pinned": uses[None]}


# Phase 7e: the vLLM connector as deploy/chart_torch deploys it.  The
# chart's default-rendered --kv-transfer-config, verbatim: the machine
# with the card may lack PyYAML, so tests/test_torch_chart.py pins this
# string, and the chart values below, to the render.
CHART_KV_TRANSFER_CONFIG = (
    '{"kv_connector":"OffloadingConnector","kv_role":"kv_both",'
    '"kv_connector_extra_config":{"spec_name":"TPUSharedStorageOffloadingSpec",'
    '"spec_module_path":"llm_d_kv_cache_manager_tpu_torch.offload.vllm_spec",'
    '"shared_storage_path":"/mnt/shared-kv/kv-cache","block_size":256,'
    '"threads_per_chip":8,"max_staging_memory_gb":16}}')
CHART_BLOCK_SIZE = 16  # blockSize: vLLM's --block-size
CHART_TENSOR_PARALLEL = 1  # vllm.tensorParallelSize
CHART_MODEL = "meta-llama/Llama-3.1-8B-Instruct"  # vllm.model.name
CHART_STORAGE_MOUNT = "/mnt/shared-kv"  # sharedStorage.mountPath
CHART_SEED = SEED + 70


def resolve_chart_spec(transfer: dict):
    """The spec module and class a ``--kv-transfer-config`` names, found
    as vLLM's OffloadingConnector finds them: the module imported by its
    ``spec_module_path``, the class looked up on it by ``spec_name``;
    both must be the port's."""
    if transfer.get("kv_connector") != "OffloadingConnector":
        raise AssertionError(f"7e: kv_connector {transfer.get('kv_connector')!r}")
    extra = transfer["kv_connector_extra_config"]
    module = importlib.import_module(extra["spec_module_path"])
    if module is not port("offload.vllm_spec"):
        raise AssertionError(f"7e: the config names {module.__name__}, not the port's spec")
    return module, getattr(module, extra["spec_name"])


def differing_layers(torch, got: dict, want: dict, got_ids, want_ids) -> list:
    """Names of the split-KV layers ``[2, N, bs, Hkv, D]`` whose blocks
    ``got_ids`` of ``got`` differ in any byte from blocks ``want_ids`` of
    ``want``."""
    gi = torch.as_tensor(got_ids, device=next(iter(got.values())).device)
    wi = torch.as_tensor(want_ids, device=next(iter(want.values())).device)
    return [name for name in want
            if not torch.equal(got[name][:, gi].view(torch.int16),
                               want[name][:, wi].view(torch.int16))]


def chart_connector_phase(smi: str, device: str = "cuda:0", kv_geometry=None,
                          tokens: int = PREFIX_TOKENS, after_load=None) -> dict:
    """Phase 7e: pod-a's ``tokens``-token prefix through the vLLM spec
    that ``CHART_KV_TRANSFER_CONFIG`` names, built from the chart's own
    settings, into a second pod's fresh tensors on ``device``.
    ``kv_geometry`` is (layers, KV heads, head_dim), by default
    ``LlamaConfig.llama3_8b()``'s; ``after_load(tensors)`` runs between
    the load and the comparison (tests plant a fault there).  Raises on
    any failed check; returns the walls with their GB/s."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    transfer = json.loads(CHART_KV_TRANSFER_CONFIG)
    spec_mod, spec_cls = resolve_chart_spec(transfer)
    extra = dict(transfer["kv_connector_extra_config"])
    chart_root = extra["shared_storage_path"]
    if not chart_root.startswith(CHART_STORAGE_MOUNT + "/"):
        raise AssertionError(f"7e: shared_storage_path {chart_root} is not under "
                             f"{CHART_STORAGE_MOUNT}")
    if kv_geometry is None:
        cfg = port("models.llama").LlamaConfig.llama3_8b()
        kv_geometry = (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    layers, kv_heads, head_dim = kv_geometry
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    bs, file_tokens = CHART_BLOCK_SIZE, int(extra["block_size"])
    n_blocks, bpf = tokens // bs, file_tokens // bs
    rng = np.random.default_rng(CHART_SEED)
    prompt = rng.integers(0, READ_VOCAB, tokens).tolist()
    hashes = group_file_hashes(engine_hashes(None, prompt, bs), bpf)
    src_ids = list(range(n_blocks))
    dst_ids = rng.permutation(n_blocks).tolist()  # the second pod's own block ids
    names = [f"model.layers.{layer}.self_attn.attn" for layer in range(layers)]
    shape = (2, n_blocks, bs, kv_heads, head_dim)
    gen = torch.Generator(device=device).manual_seed(CHART_SEED)
    src = {name: torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)
           for name in names}
    dst = {name: torch.zeros(shape, device=device, dtype=torch.bfloat16) for name in names}
    nbytes = sum(t.numel() * t.element_size() for t in src.values())
    root = tempfile.mkdtemp(prefix="kv-chart-")
    extra["shared_storage_path"] = root + chart_root[len(CHART_STORAGE_MOUNT):]
    # Phase 7c's duck-typed vLLM config at the chart's settings.
    config = vllm_config(root, SimpleNamespace(block_size=bs, dtype="bfloat16"), file_tokens)
    config.model_config.model = CHART_MODEL
    config.parallel_config.tensor_parallel_size = CHART_TENSOR_PARALLEL
    config.kv_transfer_config.kv_connector_extra_config = extra
    backend = FlashAttentionBackend
    handlers = []
    copies = ViewCopies(spec_mod.KVTensorView)
    try:
        spec, store, stored = vllm_store(spec_mod, config, src, backend, src_ids, hashes, sync,
                                         copies, spec_cls=spec_cls, tag="7e")
        handlers.append(store)
        _, load, found, loaded = vllm_load(spec_mod, config, dst, backend, dst_ids, hashes, sync,
                                           copies, spec_cls=spec_cls, tag="7e")
        handlers.append(load)
        if after_load is not None:
            after_load(dst)
        differ = differing_layers(torch, dst, src, dst_ids, src_ids)
        # The gate must see one flipped byte: flip one in a loaded block,
        # compare again, flip it back.
        probe = dst[names[-1]].view(torch.uint8)
        probe[1, dst_ids[-1], bs - 1, kv_heads - 1, -1] ^= 1
        caught = names[-1] in differing_layers(torch, dst, src, dst_ids, src_ids)
        probe[1, dst_ids[-1], bs - 1, kv_heads - 1, -1] ^= 1
        files = sorted(read_tree(root))
        kv_dir = os.path.relpath(extra["shared_storage_path"], root)
        outside = [f for f in files if not f.startswith(kv_dir + os.sep)]
        threads, budget = store.engine.n_threads, store.budget.max_bytes
        sizes = {os.path.getsize(os.path.join(root, f)) for f in files}
    finally:
        for handler in handlers:
            handler.engine.close()
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    out = {"config": transfer["kv_connector_extra_config"],
           "spec": f"{spec_cls.__module__}.{spec_cls.__qualname__}",
           "shared_storage_path": extra["shared_storage_path"], "bytes": nbytes,
           "blocks": n_blocks, "files": len(files), "file_bytes": sorted(sizes),
           "lookup": found, "threads_per_chip": spec.threads_per_chip, "threads": threads,
           "max_staging_memory_gb": spec.max_staging_memory_gb, "staging_budget_bytes": budget,
           "store": walls_ms(stored), "load": walls_ms(loaded),
           "store_rate": rate(nbytes, stored["wall_s"], PCIE_GEN5_X16),
           "load_rate": rate(nbytes, loaded["wall_s"], PCIE_GEN5_X16),
           "copies": dict(copies.counts),
           "copy_ms": {k: v * 1e3 for k, v in copies.seconds.items()},
           "layers_differing": differ, "flip_caught": caught, "seconds": round(seconds, 1),
           "card": smi}
    print(f"  {smi}: {out['spec']} from the chart's --kv-transfer-config "
          f"(threads_per_chip {spec.threads_per_chip}, max_staging_memory_gb "
          f"{spec.max_staging_memory_gb:g}, {threads} I/O threads), block size {bs}, tp "
          f"{CHART_TENSOR_PARALLEL}; {layers} split-KV tensors {list(shape)} on {device}",
          flush=True)
    print(f"  {smi}: {n_blocks} blocks ({nbytes} B) stored as {len(files)} files of "
          f"{file_tokens} tokens under {extra['shared_storage_path']}: wall "
          f"{out['store']['wall_ms']:.1f} ms ({out['store_rate']['gbps']:.3f} GB/s, "
          f"{out['store_rate']['share_of_bound']:.4f} of PCIe Gen5 x16's 64 GB/s); loaded into "
          f"a second pod's blocks: lookup {found} of {len(hashes)} files, wall "
          f"{out['load']['wall_ms']:.1f} ms ({out['load_rate']['gbps']:.3f} GB/s, "
          f"{out['load_rate']['share_of_bound']:.4f}); layers differing {len(differ)}; a "
          f"flipped byte caught {caught}; {seconds:.1f} s", flush=True)
    print(f"  {smi}: store submit {out['store']['submit_ms']:.1f} ms, of it "
          f"{copies.counts['d2h']} device-to-host view copies {out['copy_ms']['d2h']:.1f} ms; "
          f"file writes {out['store']['write_ms']:.1f} ms; load file reads and scatter "
          f"{out['load']['read_scatter_ms']:.1f} ms, of it {copies.counts['h2d']} "
          f"host-to-device view copies {out['copy_ms']['h2d']:.1f} ms", flush=True)
    want_files = -(-tokens // file_tokens)
    if differ:
        raise AssertionError(f"7e: the loaded blocks are not byte-identical to the stored ones "
                             f"in {len(differ)} layers, first {differ[0]}")
    if not caught:
        raise AssertionError("7e: a byte flipped after the load went unseen")
    if len(files) != want_files or outside or found != want_files:
        raise AssertionError(f"7e: {len(files)} files ({outside[:2]} outside {kv_dir}), lookup "
                             f"{found}, want {want_files} under {kv_dir}")
    views = 2 * layers * want_files  # K and V of each layer, for each file
    if on_card and copies.counts != {"d2h": views, "h2d": views}:
        raise AssertionError(f"7e: copies {copies.counts}, expected {views} each way")
    if sizes != {bpf * nbytes // n_blocks}:
        raise AssertionError(f"7e: file sizes {sorted(sizes)}, want {bpf * nbytes // n_blocks}")
    if (spec.threads_per_chip, spec.max_staging_memory_gb, budget) != (
            extra["threads_per_chip"], float(extra["max_staging_memory_gb"]),
            int(extra["max_staging_memory_gb"]) << 30):
        raise AssertionError(f"7e: the spec took threads_per_chip {spec.threads_per_chip}, "
                             f"staging {spec.max_staging_memory_gb} GB ({budget} bytes)")
    return out


def main(argv=None) -> int:
    import torch

    only = sys.argv[1:] if argv is None else argv
    if only not in ([], ["4c"]):
        print("usage: python3 chip_smoke.py [4c]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    t_all = time.perf_counter()

    phase("1. environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}; bounds from the H100 SXM peaks "
          f"(bf16 {peaks[0] / 1e12:.0f} TFLOP/s, f32 {peaks[1] / 1e12:.0f} TFLOP/s, "
          f"{peaks[2] / 1e12:.2f} TB/s)", flush=True)
    build = port("ops._build")
    t0 = time.perf_counter()
    # The native I/O engine (g++) builds beside the kernels (nvcc).
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="native-build") as executor:
        native_lib = executor.submit(port("native.build").build)
        logs = build.build_all(build.SOURCES)
        native_lib = native_lib.result()
    print(f"  kernel build (nvcc, sm_90a, {len(logs)} sources at once) and the native I/O "
          f"engine (g++, {native_lib.name}): {time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in logs.items():
        for kernel, line in ptxas_lines(log):
            print(f"  {src}: {kernel}: {line}", flush=True)

    if only:  # phase 4c alone, after the build
        phase(MELLUM_TITLE)
        mellum = mellum_phase(torch, peaks)
        phase()
        print(json.dumps({"mellum": mellum, "phase_seconds": PHASE_SECONDS}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name}}), flush=True)
        return 0

    phase("2. prefill kernel (csrc/flash_prefill.cu) vs plain tiled op")
    bf16, f32 = torch.bfloat16, torch.float32
    prefill_full = prefill_case(torch, peaks, 1, 8448, 8448, 32, 8, 128, 0, bf16, True)
    prefill_hit = prefill_case(torch, peaks, 1, 256, 8448, 32, 8, 128, 8192, bf16, True)
    # The MoE forward's shape: MoEConfig()'s heads over 8192 tokens.
    prefill_moe = prefill_case(torch, peaks, 1, MOE_TOKENS, MOE_TOKENS, 8, 4, 128, 0, bf16, True)
    # One tp shard's heads (phase 12): Llama-3-8B's and the MoE's over tp 2.
    prefill_tp = [prefill_case(torch, peaks, *case, bf16, True) for case in (
        (1, 8448, 8448, 32 // SHARD_TP, 8 // SHARD_TP, 128, 0),
        (1, 256, 8448, 32 // SHARD_TP, 8 // SHARD_TP, 128, 8192),
        (1, MOE_TOKENS, MOE_TOKENS, 8 // SHARD_TP, 4 // SHARD_TP, 128, 0))]
    prefill_edge = [
        prefill_case(torch, peaks, *case, False)
        for case in [
            (2, 100, 100, 32, 8, 128, 0, bf16),
            (1, 192, 192, 32, 8, 128, 0, bf16),  # a q tile and a half
            (1, 256, 8400, 32, 8, 128, 8144, bf16),  # split keys, ragged last tile
            (1, 40, 300, 8, 2, 64, 260, bf16),
            (1, 1, 77, 4, 1, 128, 76, bf16),
            (2, 100, 100, 4, 2, 128, 0, f32),
            (1, 40, 300, 8, 2, 64, 260, f32),
        ]
    ]
    # Every head dim of the set and any group, as the Pallas kernel takes
    # them: other models' shapes at serving length, then ragged edges.
    prefill_shapes = [prefill_case(torch, peaks, 1, 8448, 8448, *case, 0, bf16, True)
                      for case in SHAPE_PREFILL]
    prefill_edge += [prefill_case(torch, peaks, *case[:7], getattr(torch, case[7]), False)
                     for case in SHAPE_PREFILL_EDGE]
    torch.cuda.empty_cache()

    phase("3. decode kernel (csrc/paged_decode.cu) vs plain paged_attention")
    serving_ctx = PREFIX_TOKENS + SUFFIX_TOKENS + DECODE_STEPS
    decode_serving = decode_case(torch, peaks, 2, 32, 8, 128, serving_ctx // 16 + 1,
                                 [serving_ctx, serving_ctx], bf16, True)
    decode_b4 = decode_case(torch, peaks, 4, 32, 8, 128, 528, [8448, 1, 5000, 8447],
                            bf16, True)
    # Phase 5c's and 7c's batch of one at the end of their decode steps.
    b1_ctx = PREFIX_TOKENS + SUFFIX_TOKENS + HTTP_DECODE_STEPS
    decode_b1 = decode_case(torch, peaks, 1, 32, 8, 128, b1_ctx // 16 + 1, [b1_ctx], bf16, True)
    decode_tp = decode_case(torch, peaks, 2, 32 // SHARD_TP, 8 // SHARD_TP, 128,
                            serving_ctx // 16 + 1, [serving_ctx, serving_ctx], bf16, True)
    ragged16 = [8448 - 523 * i for i in range(15)] + [1]
    decode_b16 = decode_case(torch, peaks, 16, 32, 8, 128, 528, ragged16, bf16, True)
    decode_edge = [
        decode_case(torch, peaks, *case, False)
        for case in [
            (3, 8, 2, 64, 8, [16, 7, 128], bf16),
            (2, 32, 8, 128, 7, [97, 1], f32),
            (1, 8, 8, 128, 4, [33], f32),
            # 264 units over 132 CTAs, 2 a run: sequence 0 ends exactly
            # on a run's end, then one block past it.
            (2, 8, 1, 128, 264, [132 * 16, 132 * 16], bf16),
            (2, 8, 1, 128, 264, [133 * 16, 131 * 16 - 5], bf16),
            # a sequence inside one run beside one cut over all of them
            (2, 32, 8, 128, 528, [20, 8448], bf16),
            (2, 8, 8, 128, 64, [1000, 37], bf16),  # G = 1
            (2, 16, 8, 64, 40, [600, 333], bf16),  # G = 2
            (2, 32, 8, 128, 600, [4000, 77], bf16),  # a table wider than any context
            (2, 16, 4, 64, 80, [1200, 700], f32),  # float32 partials merged across CTAs
        ]
    ] + [decode_replay_case(torch)]
    # Every pool block size, head dim and group the Pallas kernel takes:
    # phase 3's B=4 row at other block sizes and widths, then ragged
    # edges.
    decode_shapes = [
        decode_case(torch, peaks, 4, H, Hkv, D, -(-8448 // bs), SHAPE_DECODE_CTX, bf16, True,
                    block_size=bs)
        for H, Hkv, D, bs in SHAPE_DECODE]
    decode_edge += [decode_case(torch, peaks, *case[:6], getattr(torch, case[6]), False,
                                block_size=case[7]) for case in SHAPE_DECODE_EDGE]
    torch.cuda.empty_cache()

    phase("4. ring partial kernel (csrc/ring_partial.cu) vs plain partial")
    # One rank's chunk of the ring prefill: 8192 tokens over sp=4.
    chunk = RING_TOKENS // RING_SP
    ring_serving = {
        off: ring_partial_case(torch, peaks, 1, chunk, chunk, 32, 8, 128, off, bf16, True)
        for off in (0, None, -1)
    }
    # One rank's chunk of the MoE ring forward (contiguous: offsets 0 and
    # None only).
    ring_moe = {
        off: ring_partial_case(torch, peaks, 1, MOE_TOKENS // RING_SP, MOE_TOKENS // RING_SP,
                               8, 4, 128, off, bf16, True)
        for off in (0, None)
    }
    # One (head shard, rank)'s chunk of the tp x sp ring (phase 12b).
    ring_tp = {
        off: ring_partial_case(torch, peaks, 1, chunk, chunk, 32 // SHARD_TP, 8 // SHARD_TP, 128,
                               off, bf16, True)
        for off in (0, None, -1)
    }
    ring_edge = [
        ring_partial_case(torch, peaks, *case, False)
        for case in [
            (1, 100, 300, 32, 8, 128, None, bf16),
            (1, 192, 320, 32, 8, 128, 0, bf16),  # a q tile and a half, ragged keys
            (2, 64, 200, 8, 1, 64, None, bf16),  # rows past Tq in front of batch 1
            (1, 77, 77, 32, 8, 128, -1, bf16),  # row 0 sees no key
            (1, 200, 200, 8, 2, 64, 0, bf16),
            (2, 130, 130, 32, 8, 128, -1, bf16),
            (1, 100, 100, 4, 2, 128, -1, f32),
            (2, 70, 90, 8, 2, 64, None, f32),
        ]
    ]
    ring_shapes = [ring_partial_case(torch, peaks, 1, chunk, chunk, *case, 0, bf16, True)
                   for case in SHAPE_PREFILL]
    ring_edge += [ring_partial_case(torch, peaks, *case[:7], getattr(torch, case[7]), False)
                  for case in SHAPE_RING_EDGE]
    shape_guard = shape_guard_case(torch)
    torch.cuda.empty_cache()

    phase("4b. layer kernels (csrc/layer_fused.cu) vs their plain chains")
    layer_fused = layer_fused_phase(torch, peaks)
    torch.cuda.empty_cache()

    phase(MELLUM_TITLE)
    mellum = mellum_phase(torch, peaks)
    torch.cuda.empty_cache()

    llama = port("models.llama")
    cfg = llama.LlamaConfig.llama3_8b()
    cfg.n_layers = LAYERS
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    print(f"\n  Llama-3-8B widths, {LAYERS} of 32 layers, bf16 random weights "
          f"(seed {SEED}): {time.perf_counter() - t0:.1f} s to init", flush=True)

    phase("5. serving: index-routed miss, hit and decode on two pods")
    serve = serving(torch, params, cfg)
    offload_inputs = serve.pop("offload_inputs")
    sharded_inputs = serve.pop("sharded_inputs")
    tiering_inputs = serve.pop("tiering_inputs")
    http_inputs = serve.pop("http_inputs")
    torch.cuda.empty_cache()

    phase("5c. serving through the service: request C by POST /score_completions, "
          "continued and decoded on pod-a")
    try:
        served_http = serving_http(torch, params, cfg, http_inputs)
    except BaseException:
        tiering_inputs["scorer"].shutdown()
        raise
    del http_inputs
    torch.cuda.empty_cache()

    try:
        phase(f"5d. serving at pool block {SERVE_BLOCK}: phase 5's miss, hit and decode steps "
              f"over a pool of {SERVE_BLOCK}-token blocks")
        served_block = serving_block(torch, params, cfg, sharded_inputs)
        torch.cuda.empty_cache()
        phase("5e. the reference's small config (__graft_entry__._CFG, head dim 32): forward, "
              "prefill_paged and decode steps against the dense op, bf16 and float32")
        graft = graft_config_phase(torch)
    except BaseException:
        tiering_inputs["scorer"].shutdown()
        raise
    torch.cuda.empty_cache()

    phase(f"6. ring prefill: forward(sp_mesh=sp {RING_SP} on one card) over "
          f"{RING_TOKENS} tokens")
    ring = ring_prefill(torch, params, cfg)

    phase(f"6b. the ring across processes: forward(sp_mesh=make_hybrid_mesh(dcn sp "
          f"{RING_SP})) over {RING_SP} processes on one card, gloo")
    ring_processes = ring_across_processes(torch, params, cfg, ring)
    gc_cuda(torch)

    phase("7. offload: store pod-a's prefix, serve it on pod-c")
    offload_inputs.update(ttft_miss_ms=serve["ttft_miss_ms"], ttft_hit_ms=serve["ttft_hit_ms"])
    try:
        offloaded = offload(torch, params, cfg, peaks, offload_inputs)
        tiering_inputs.update(offloaded.pop("tiering_inputs"))

        phase("7c. the vLLM connector: pod-a's prefix through offload.vllm_spec over the pool's "
              "own tensors and FlashAttention's split-KV layout, B continued on pod-c")
        vllm = vllm_offload(torch, params, cfg, dict(
            offload_inputs, **{k: tiering_inputs[k] for k in ("pod_c", "ids_c", "table_c")}),
            phase7=offloaded)
        del offload_inputs
        torch.cuda.empty_cache()

        phase("7b. tiering and transfer: demote pod-a's prefix, plan and serve B on pod-c")
        tiered = tiering_transfer(torch, params, cfg, tiering_inputs)
    finally:
        tiering_inputs["scorer"].shutdown()
    del tiering_inputs
    gc_cuda(torch)

    phase(f"12a. sharded: tp {SHARD_TP} serving on one card (phase 5's requests), "
          f"{LAYERS} layers")
    tp_serving = sharded_serving(torch, params, cfg, sharded_inputs)
    across_inputs = tp_serving.pop("across_inputs")
    gc_cuda(torch)
    phase(f"12b. sharded: the tp {SHARD_TP} x sp {RING_SP} ring on one card over "
          f"{RING_TOKENS} tokens")
    tp_ring = sharded_ring(torch, params, cfg, ring)
    gc_cuda(torch)
    phase(f"12f. serving across processes: phase 5's requests over {ACROSS_WORLD} processes on "
          f"one card (tp, pp and dp across them), the MoE over ep across them, then plain "
          f"params: the MoE over sp and {PLAIN_LLAMA_LAYERS} Llama layers over tp x sp, gloo")
    across = serving_across_processes(torch, params, cfg, sharded_inputs, across_inputs)
    del params, sharded_inputs, across_inputs
    gc_cuda(torch)
    print(f"\n  phases 5-7's and 12a-b's and 12f's params and pools freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated", flush=True)

    train_cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    phase(f"8. autograd guard: Llama-3-8B widths, {TRAIN_LAYERS} of 32 layers, bf16, "
          f"T={TRAIN_TOKENS}")
    guard = autograd_guard(torch, train_cfg)
    guard["small_step_vs_cpu"] = small_training_step(torch)
    gc_cuda(torch)

    phase(f"9. training: Llama-3-8B widths, {TRAIN_LAYERS} of 32 layers, {TRAIN_STEPS} "
          f"AdamW steps")
    trained = training_and_checkpoint(torch, peaks, train_cfg)

    phase(f"9b. training across processes: phases 8-9's cut model over {ACROSS_WORLD} "
          f"processes on one card, dcn dp 2 and dcn tp 2, gloo")
    across_training = training_across_processes(torch, train_cfg, trained)
    gc_cuda(torch)

    phase(f"11. MoE: MoEConfig(), forward over {MOE_TOKENS} tokens (prefill kernel, ring "
          f"sp {RING_SP}), float32 against dense, train steps")
    moe_run = moe_phase(torch, peaks)

    phase(f"12c. sharded: training on {SHARD_TRAIN_PLAN} on one card, {TRAIN_LAYERS} layers")
    small_sharded = small_sharded_step(torch)
    gc_cuda(torch)
    sharded_train = sharded_training_and_restore(torch, train_cfg, trained)
    sharded_train["training"]["small_step_vs_unsharded"] = small_sharded
    phase(f"12e. sharded: MoEConfig() on {SHARD_MOE_PLAN} inside activate(mesh)")
    tp_moe = sharded_moe(torch)

    phase(f"13. read path: the Indexer over {READ_PODS} pods x {READ_CONVS_PER_POD} "
          f"conversations of {READ_CONV_TOKENS} tokens, three lanes")
    print(f"  host before phase 13: {host_state()}", flush=True)
    read = read_path(smi)
    fleet = read.pop("fleet")
    traffic = read.pop("traffic")

    phase(f"14. write path: phase 13's fleet as KV events, a storm of {STORM_PODS} pods, "
          f"a gap and its resync, the auditor")
    print(f"  host before phase 14: {host_state()}", flush=True)
    write = write_path(smi, fleet)

    phase("14b. persistence: phase 13's index through a snapshot and the journal, a warm "
          "restart, a torn tail")
    print(f"  host before phase 14b: {host_state()}", flush=True)
    persisted = persistence_phase(smi, fleet, traffic)

    phase(f"14c. cluster: phase 13's fleet and traffic through {len(CLUSTER_REPLICAS)} "
          f"replicas, one killed mid-traffic, a purge replayed")
    print(f"  host before phase 14c: {host_state()}", flush=True)
    clustered = cluster_phase(smi, fleet, traffic)

    phase(f"14d. service: phase 13's fleet and traffic through serve() with the "
          f"observability plane, {SERVICE_CLIENTS} clients, an incident replayed, what-if")
    print(f"  host before phase 14d: {host_state()}", flush=True)
    serviced = service_phase(smi, fleet, traffic)

    phase("14e. gRPC: phase 13's fleet and traffic through the gRPC scoring service, the "
          "tokenizer sidecar behind an Indexer")
    print(f"  host before phase 14e: {host_state()}", flush=True)
    grpc_served = grpc_phase(smi, fleet, traffic, http_cells=serviced.get("sequential"))
    del fleet, traffic

    phase("7d. the offload smoke: hack/offload_smoke_torch.py's main on the card at "
          "Llama-3-8B's KV geometry")
    offload_smoke = offload_smoke_phase(smi)

    phase("7e. the chart's connector: deploy/chart_torch's --kv-transfer-config resolved as "
          "vLLM does, pod-a's prefix stored from split-KV tensors on the card and loaded into a "
          "second pod's")
    chart_connector = chart_connector_phase(smi)
    torch.cuda.empty_cache()

    phase("15. kernels")

    def layer_kernel(name: str, replaces: str) -> dict:
        """A layer kernel's entry: its launches by path (phase 12a's tp
        path keeps the op-by-op chains: 0), phase 4b's Mistral
        continuation row as its figures, and every 4b row as its cases."""
        rows = [row for row in layer_fused if row["what"].split(",")[0] == name]
        by_path = {"llama_serving": serve["launches"][name],
                   "llama_serving_block64": served_block["launches"][name],
                   **{f"llama_graft_cfg_{k}": g["launches"][name] for k, g in graft.items()},
                   "llama_serving_http": served_http["launches"][name],
                   "llama_vllm_offload": vllm["launches"][name],
                   "llama_tiering_transfer": tiered["launches"][name],
                   "llama_serving_tp": tp_serving["launches"][name],
                   "mellum_serving": mellum_launches[name]}
        return dict(name=name, route="cuda",
                    source="llm_d_kv_cache_manager_tpu_torch/csrc/layer_fused.cu",
                    replaces=replaces, launches=sum(by_path.values()), launches_by_path=by_path,
                    shape=rows[0]["what"],
                    **{k: rows[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "eager_ms", "plain_eager_ms", "limit",
                                               "worst_err_over_limit", "fault")},
                    cases=rows + ([mellum["rope"]] if name == "rope_kv" else []))

    mellum_launches = mellum["main_path"]["launches"]
    kernels = [
        dict(
            name="flash_prefill",
            route="cuda",
            source="llm_d_kv_cache_manager_tpu_torch/csrc/flash_prefill.cu",
            replaces="llm_d_kv_cache_manager_tpu/ops/flash_pallas.py:49",
            launches=(serve["launches"]["flash_prefill"] + moe_run["launches"]["flash_prefill"]
                      + served_block["launches"]["flash_prefill"]
                      + sum(g["launches"]["flash_prefill"] for g in graft.values())
                      + tp_serving["launches"]["flash_prefill"]
                      + tp_moe["launches"]["flash_prefill"]
                      + tiered["launches"]["flash_prefill"]
                      + served_http["launches"]["flash_prefill"]
                      + vllm["launches"]["flash_prefill"]
                      + mellum_launches["flash_gqa_attention"]
                      + sum(across["launches_by_path"]["flash_prefill"].values())),
            launches_by_path={"llama_serving": serve["launches"]["flash_prefill"],
                              "llama_serving_block64": served_block["launches"]["flash_prefill"],
                              **{f"llama_graft_cfg_{k}": g["launches"]["flash_prefill"]
                                 for k, g in graft.items()},
                              "llama_serving_http": served_http["launches"]["flash_prefill"],
                              "llama_vllm_offload": vllm["launches"]["flash_prefill"],
                              "llama_tiering_transfer": tiered["launches"]["flash_prefill"],
                              "moe_forward": moe_run["launches"]["flash_prefill"],
                              "llama_serving_tp": tp_serving["launches"]["flash_prefill"],
                              "moe_forward_ep_tp": tp_moe["launches"]["flash_prefill"],
                              "mellum_serving": mellum_launches["flash_gqa_attention"],
                              **across["launches_by_path"]["flash_prefill"]},
            **{k: prefill_full[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms", "eager_ms", "tflops",
                                            "library_ratio", "bound_share", "shape", "limit",
                                            "worst_err_over_limit", "planted")},
            cases=[prefill_hit, prefill_moe] + prefill_tp + prefill_shapes + prefill_edge
            + [shape_guard] + [r for r in mellum["attention"] if "flash" in r["what"]],
        ),
        dict(
            name="paged_decode",
            route="cuda",
            source="llm_d_kv_cache_manager_tpu_torch/csrc/paged_decode.cu",
            replaces="llm_d_kv_cache_manager_tpu/ops/paged_decode_pallas.py:40",
            launches=(serve["launches"]["paged_decode"] + tp_serving["launches"]["paged_decode"]
                      + served_block["launches"]["paged_decode"]
                      + sum(g["launches"]["paged_decode"] for g in graft.values())
                      + served_http["launches"]["paged_decode"]
                      + vllm["launches"]["paged_decode"]
                      + mellum_launches["paged_decode_attention"]
                      + sum(across["launches_by_path"]["paged_decode"].values())),
            launches_by_path={"llama_serving": serve["launches"]["paged_decode"],
                              "llama_serving_block64": served_block["launches"]["paged_decode"],
                              **{f"llama_graft_cfg_{k}": g["launches"]["paged_decode"]
                                 for k, g in graft.items()},
                              "llama_serving_http": served_http["launches"]["paged_decode"],
                              "llama_vllm_offload": vllm["launches"]["paged_decode"],
                              "llama_serving_tp": tp_serving["launches"]["paged_decode"],
                              "mellum_serving": mellum_launches["paged_decode_attention"],
                              **across["launches_by_path"]["paged_decode"]},
            **{k: decode_serving[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms", "eager_ms", "tflops",
                                              "library_ratio", "bound_share", "shape", "limit",
                                              "worst_err_over_limit", "planted")},
            cases=[decode_b1, decode_b4, decode_b16, decode_tp] + decode_shapes + decode_edge
            + [shape_guard] + [r for r in mellum["attention"] if "decode" in r["what"]],
        ),
        dict(
            name="ring_partial",
            route="cuda",
            source="llm_d_kv_cache_manager_tpu_torch/csrc/ring_partial.cu",
            replaces="llm_d_kv_cache_manager_tpu/ops/ring_flash_pallas.py:48",
            launches=(sum(n["ring_partial"] for n in ring["launches"].values())
                      + sum(ring_processes["launches"].values())
                      + moe_run["launches"]["ring_partial"]
                      + sum(n["ring_partial"] for n in tp_ring["launches"].values())
                      + sum(across["launches_by_path"]["ring_partial"].values())),
            launches_by_layout={k: n["ring_partial"] for k, n in ring["launches"].items()},
            launches_by_path={**{f"llama_ring_{k}": n["ring_partial"]
                                 for k, n in ring["launches"].items()},
                              **{f"llama_ring_processes_{k}": n
                                 for k, n in ring_processes["launches"].items()},
                              "moe_ring_contiguous": moe_run["launches"]["ring_partial"],
                              **{f"llama_ring_tp_sp_{k}": n["ring_partial"]
                                 for k, n in tp_ring["launches"].items()},
                              **across["launches_by_path"]["ring_partial"]},
            launches_per_process=ring_processes["launches_per_process"],
            **{k: ring_serving[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "eager_ms", "tflops",
                                               "library_ratio", "bound_share", "shape", "limit",
                                               "worst_err_over_limit", "planted",
                                               "m_max_abs_err", "l_worst_err_over_limit")},
            cases=([ring_serving[None], ring_serving[-1], ring_moe[0], ring_moe[None]]
                   + list(ring_tp.values()) + ring_shapes + ring_edge + [shape_guard]
                   + [dict(row, where="phase 6b worker process")
                      for row in ring_processes["kernel_cases"]]),
        ),
        # No TPU kernel: the reference leaves these chains to XLA.
        layer_kernel("rms_norm", "llm_d_kv_cache_manager_tpu/models/llama.py:152 (_rms_norm)"),
        layer_kernel("rope_kv", "llm_d_kv_cache_manager_tpu/models/llama.py:158 (_rope), :304 "
                     "(_scatter_kv_blocks), :555 (decode_step's slot write)"),
        layer_kernel("silu_mul", "llm_d_kv_cache_manager_tpu/models/llama.py:174 (_mlp's gate)"),
        # No TPU kernel: the reference's MoE dispatches one-hot, with a
        # capacity, through XLA.
        dict(name="moe_experts", route="cuda",
             source="llm_d_kv_cache_manager_tpu_torch/csrc/moe_experts.cu",
             replaces="llm_d_kv_cache_manager_tpu/models/moe.py (_route's capacity dispatch)",
             launches=sum(mellum_launches[k] for k in ("moe_route", "moe_group", "moe_experts",
                                                       "moe_combine")),
             launches_by_kernel={k: mellum_launches[k] for k in (
                 "moe_route", "moe_group", "moe_experts", "moe_combine")},
             launches_by_path={"mellum_serving": sum(mellum_launches[k] for k in (
                 "moe_route", "moe_group", "moe_experts", "moe_combine"))},
             shape=mellum["experts"][0]["what"],
             **{k: mellum["experts"][0][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "limit",
                                                     "worst_err_over_limit", "fault")},
             cases=mellum["experts"]),
    ]
    phase()
    print(f"  seconds a phase: {PHASE_SECONDS}", flush=True)
    summary = {k: v for k, v in serve.items() if k != "launches"}
    ring_summary = {k: v for k, v in ring.items() if k != "launches"}
    moe_summary = {k: v for k, v in moe_run.items() if k != "launches"}
    sharded = {"tp_serving": tp_serving, "tp_sp_ring": tp_ring, "moe": tp_moe,
               "across_processes": across, **sharded_train}
    tiering_summary = {k: v for k, v in tiered.items() if k != "launches"}
    http_summary = {k: v for k, v in served_http.items() if k != "launches"}
    print(json.dumps({"serving": summary, "serving_http": http_summary,
                      "serving_block64": served_block, "graft_config": graft,
                      "ring_prefill": ring_summary,
                      "ring_processes": {k: v for k, v in ring_processes.items()
                                         if k != "kernel_cases"},
                      "offload": offloaded,
                      "vllm_offload": {k: v for k, v in vllm.items() if k != "launches"},
                      "tiering": tiering_summary,
                      "autograd_guard": guard, "training": trained,
                      "training_across_processes": across_training, "moe": moe_summary,
                      "sharded": sharded, "read_path": read, "write_path": write,
                      "persistence": persisted, "cluster": clustered, "service": serviced,
                      "grpc": grpc_served, "offload_smoke": offload_smoke,
                      "chart_connector": chart_connector,
                      "mellum_serving": mellum["main_path"],
                      "layers": LAYERS, "phase_seconds": PHASE_SECONDS,
                      "seconds": round(time.perf_counter() - t_all, 1)}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
