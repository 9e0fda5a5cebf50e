#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``defer_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

  1. card   — name and power limit from nvidia-smi;
  2. build  — every CUDA kernel of the port, from ``defer_tpu_torch/csrc``,
              with nvcc for sm_90a (one nvcc per source, all at once);
  3. kernel — each kernel against its plain PyTorch version on the card at
              the main paths' shapes plus edge cases (the quantizer
              bit-equal; flash attention to 1e-5 in f32 and one bf16 ulp
              in bf16, rows with no live key exactly 0, long causal and
              misaligned layouts included), then timed with CUDA events
              beside the plain version, the card's bound for the same
              work and, where one exists, the PyTorch library call that
              computes the same function (flash attention also on the
              long causal prefill and GPT-2 small's causal shapes beside
              SDPA's causal mode);
  4. main   — two paths, each driven through ``Defer.run`` with the kernel
              launch counts zeroed just before every run and read just
              after; on the card every chunk is one CUDA-graph replay;
              outputs are held against the whole-graph forward on the card
              (TF32 off), then alternating timed rounds give throughput and
              a one-chunk profile gives device time by kernel:
                a. ResNet50 at full width, cut at the reference's
                   eight-stage list, ``wire="int8"`` (one quantizer launch
                   per pipeline step) and ``wire="buffer"``;
                b. BERT-Base at full width and depth (seq 128), one encoder
                   block per stage in 12 stages, ``wire="buffer"`` and
                   ``wire="int8"`` (12 flash-attention launches per step;
                   one quantizer launch per step under int8, none under
                   buffer);
                c. graph against eager: one chunk of each model through its
                   graph and through the eager loop from the same ring;
                   the graph pool's size and the capture count;
                d. bf16 compute at full width and depth: ResNet50 on a bf16
                   ring and BERT-Base on an f32 ring (token ids), both
                   wires, held against the whole-graph forward with bf16
                   weights and input; launch counts by dtype; bf16
                   throughput rows beside the f32 ones;
                e. ``reweight`` after capture: new weights into the live
                   rows equal a fresh pipeline, with no new capture;
                f. ``Defer.run_defer``: the bf16 int8 ResNet50 deployment
                   as a queue service, equal to ``Defer.run``;
                g. GPT-2 small (12 blocks, d 768, vocabulary 50257, max_len
                   256) in 12 stages, 96 prompts of 32 tokens: the
                   decoder's tokens equal to an eager incremental loop of
                   the same decode ops (f32 buffer cache on every group;
                   int8 cache, bf16 and W8A16 on two), no flash launch on
                   decode-rate steps; the fused prefill's K/V rows and
                   tokens against decode rate and its flash launch count;
                   beam search; graph against eager; ``reweight``;
                   ``Defer.score`` on both wires against the forward (12
                   flash launches per step); speculative decoding
                   token-exact; tokens/s, time to first token, scored
                   sequences/s and one decode replay profiled;
                h. the rest of the BASELINE zoo at full width and depth:
                   VGG19 in 4 stages and MobileNetV2 in 2 at 224x224,
                   InceptionV3 (torchvision's graph) in 6 at 299x299, each
                   f32 on both wires (one quantizer launch per int8 step;
                   top-1 equal wherever the forward's margin exceeds twice
                   the error), bf16 on a bf16 ring on both wires, graph
                   against eager, images/s, a profiled bf16 int8 chunk and
                   peak device memory; ``fold_batchnorm`` on ResNet50 and
                   MobileNetV2 with randomized statistics (folded and
                   unfolded bf16 int8 pipelines against the unfolded f32
                   forward, images/s side by side, a profiled chunk each);
                   ``moe_tiny`` and ``moe_branched_tiny`` in 2 stages on both
                   wires (flash launches = blocks x steps);
                i. weights and the host edge: g++ builds the native codec
                   and staging ring from ``defer_tpu_torch/csrc`` (both
                   must load natively); ResNet50's seeded parameters
                   written as a torchvision ``.pt`` and read back with
                   ``load_pretrained``, and round-tripped through
                   ``save_params``/``load_params`` (npz, JAX layout) and
                   ``.pt``, each bit-equal with ``Defer.run`` equal; the
                   bf16 int8 deployment on the loaded weights behind
                   ``serve_endpoint(max_clients=2)``: two concurrent
                   clients of 64 images each, raw replies equal to
                   ``Defer.run`` and bf8 replies within blockfloat's
                   bound, one quantizer launch per step the endpoint ran,
                   ``endpoint.samples_in``/``samples_out`` 128, END echoed,
                   ``reweight`` between clients; images/s beside the
                   pipeline's run, wire bytes per image, device idle;
                j. the serving front door: GPT-2 small (12 stages, f32) in a
                   ``ContinuousBatchEngine`` of 32 KV slots (one CUDA-graph
                   replay per step) behind ``ServeFrontDoor`` on localhost;
                   four tenants (weights 1, 1 and 2, and one at priority 1
                   that samples) stream 32 prompts of 8-64 tokens each in
                   three closed-loop rounds, then one open-loop round of
                   Poisson arrivals at half that rate with a 2x burst;
                   checks: requests alone through a fresh engine give the
                   same bytes, greedy tokens equal the eager loop up to the
                   first near tie, an abort mid-decode frees its slot
                   without touching a neighbour's tokens, a replayed step
                   equals the eager step, the stats reply counts every
                   request, and neither kernel launches; tokens/s,
                   per-tenant p50/p99, steps, slot occupancy, the engine's
                   phase times, the device's idle share of a step;
                k. the stage-node chain: ResNet50/8 as eight ``python -m
                   defer_tpu_torch node`` processes on the card held open
                   by ``deploy_chain(persist=True)`` (in-band deploy of
                   ``torch.export`` artifacts), 64 images in frames of 8
                   on lzb hops, then the same processes deployed again
                   in-band on raw hops (rows within 1e-5 of the forward,
                   top-1 equal, raw and lzb byte-identical, every node on
                   cuda with 8 frames processed a segment); BERT-Base/12
                   as twelve in-process ``StageNode`` threads (12 flash
                   launches per frame, by the smoke's counts and the
                   nodes' own, rows within 1e-5 of phase 4b's forward, a
                   ``reweight`` equal to the forward on the new weights);
                   ``ServeFrontDoor`` in tensor mode over the raw chain
                   (two tenants' rows equal to the forward's); each chain
                   timed on streams of 16 frames beside the ring pipeline
                   on the same frames; boot, deploy, exit seconds and the
                   short streams' time to their last result; every hop
                   pinned to tcp (``tier="tcp"``, ``--tier tcp``);
                l. the colocated transport tiers (``/dev/shm``'s size
                   printed first): ResNet50/8 as eight node processes on
                   ``tier="auto"`` (every hop must report shm with no
                   fallback, rows byte-identical to k's tcp rows), then as
                   one process with seven ici hops (``--co-stage``
                   threads; no host sync on the seven nodes before the
                   dispatcher's edge, rows within 1e-5, top-1 equal), each
                   timed on 16-frame streams beside the ring; BERT-Base/12
                   as twelve in-process nodes on ici hops (12 flash
                   launches per frame, no host sync on any node, rows
                   within 1e-5 of 4b's forward), then fused into two
                   programs; ResNet50/8 fused into two processes with one
                   shm hop (``hop_tiers`` device x3, shm, device x3,
                   through ``run_chain``); a shm offer into a node that
                   refuses offers (``tier_accept=False``; tcp, one labeled
                   fallback, a ``tier`` event); per-node phase times;
                m. the planner on the card: ``utils.hw.identify_chip``
                   names the card ``"h100"`` and the cost model takes its
                   data-sheet peaks; ``measured_node_costs`` for ResNet50
                   (f32) and BERT-Base (f32, bf16), each node's calls one
                   CUDA-graph replay (every cost positive, flash launches
                   counted), beside the forward; ResNet50's solved,
                   quantile and paper 8-stage cuts priced on that model,
                   and the int8 ring run at the solved and the paper's
                   cuts (phase 4a's bar, one quantizer launch per step,
                   images/s beside the prediction); ``fit_from_stats`` on
                   l's shm chain (a measured host-sync bandwidth), the
                   artifact round-tripped and applied; a live cutover of
                   BERT-Base over three persistent nodes by
                   ``replan``/``LiveReplan``, the stream byte-identical to
                   two undisturbed chains, 12 flash launches a frame;
                n. replication and failover: ResNet50/8 with stage 1 as
                   two replica processes, ``failover=True``, ``tier="auto"``
                   (nine processes held open by ``deploy_chain``; the fan
                   hops ride tcp, the rest shm): rows byte-identical to k's
                   tcp rows, each replica half the frames, images/s beside
                   k's and l's chains, per-node phase p50s; a ``SIGKILL``
                   of replica 1 after 16 results: the rows unchanged, one
                   ``replica_respawn``, ``failovers == 1`` on stage 0, the
                   fan-in's duplicates, the recovery seconds and the
                   respawn's seconds to bind and to its healed redial
                   beside the 30 s grace; BERT-Base/12 in-process with
                   stages 0, 5 and 11 as two replicas each (rows
                   byte-identical to k's, 12 flash launches per frame,
                   every frame once through each replicated stage);
                   ``solve_replicated`` for nine processes on m's measured
                   costs beside the measured rate;
                o. branched (DAG) chains: InceptionV3 at 299² on the
                   5-vertex topology ``solve_dag`` gives around the
                   ``mixed_3`` region (a fork, three branch vertices, a
                   join), deployed by ``deploy_topology`` on five
                   in-process nodes (rows byte-identical to the serial
                   composition of the nodes' own programs, within 1e-5 of
                   the forward with top-1 equal, every branch every frame,
                   the join's ``join`` = 3), timed on 8 frames beside
                   ``best_linear_plan``'s chain, then as five node
                   processes through ``run_dag_chain`` (rows
                   byte-identical to the in-process rows; boot, export and
                   first-result seconds); the branched MoE at BERT-Base
                   widths (2 layers, 4 experts, 11 vertices) in-process
                   (byte-identical, within 1e-5 of the forward, 2 flash
                   launches per frame, no quantizer launch); every wait
                   under its own deadline naming the vertex that did not
                   answer;
                p. observability, riding k's and n's chains (its seconds
                   carved out of theirs): on k's ResNet50/8 processes,
                   deployed with ``plan=`` (the paper's cuts priced by
                   ``plan.solve``'s model), ``align_clocks`` (each offset
                   printed), a profiled 16-frame stream under the
                   session's live view (rows for all eight stages, its
                   bottleneck beside the stage with the largest infer
                   p50; each node's dispatch + queue + device + host_sync
                   within 0.15 of its infer, 0 recompiles, live bytes in
                   (0, the card's memory); each node's MFU in (0, 1] and
                   equal to ``flops / (infer p50 * 989e12)`` from its
                   stats row) and the plan's ``obs`` entry covering every
                   stage; on k's in-process BERT-Base/12 a profiled
                   stream (12 flash launches per frame in each node's
                   window, the phases tiling infer) with stage 0's window
                   recorded by ``torch.profiler`` (the flash kernel among
                   its kernels); on n's replicated chain, armed with
                   ``journal_dir``, the supervisor's postmortem after the
                   ``SIGKILL`` (``bundle.json`` and ``trace.json``, the
                   verdict naming ``stage1.r1``, a journal for every node
                   process and the dispatcher) and ``postmortem.collect``
                   of the same directory giving the same verdict; the
                   port's ``profile --torch-trace-dir`` command on one of
                   k's ResNet50 node processes while the dispatcher
                   streams (the trace that process wrote holds its
                   convolution kernels);
                q. the command line (``defer_tpu_torch.cli.main`` in this
                   process, each command's model and seeded weights the
                   ones its phase built), its seconds carved out of the
                   phases it rides: after a, ``bench`` of ResNet50 at the
                   paper's cuts on the int8 wire (a bf16 ring), images/s
                   beside a's int8 rates, one quantizer launch per pushed
                   step and no flash launch; after g, ``generate
                   --prefill`` of GPT-2 small in 12 stages (g's prefill
                   flash count for each of its two calls, its first row
                   equal to g's decoder up to the first near tie,
                   tokens/s); inside k, ``serve --nodes`` over k's eight
                   ResNet50 processes and ``serve-client`` against it at
                   half k's chain rate (every request completed, none
                   shed, ``final_stats`` counting each, no kernel launch
                   here or in the nodes); after k, ``export`` of
                   BERT-Base in 12 stages on k's traces, a block stage
                   loaded with ``load_stage`` on the card (one flash
                   launch a frame, within 1e-5 of the ``StageModule``);
                r. training (``PipelineTrainer``, eager, TF32 off), its
                   seconds carved out of the phases it rides: after a, on
                   ResNet50/8 (4a's weights, 4 microbatches = 11 ring
                   steps, remat) the buffer wire's loss and per-stage
                   gradients against a whole-graph autograd reference,
                   the int8 wire (the straight-through hop on the
                   quantizer kernel, one launch per ring step) against the
                   buffer wire, the same chunk on the plain quantizer,
                   two Adam steps, the captured graph serving the
                   trained rows equal to a fresh pipeline; bf16 compute on
                   float32 master rows; the ``train`` command with its
                   checkpoint resumed in a fresh trainer; after g, GPT-2
                   small/12 (``attn_impl="xla"``, 4 x 8 sequences of 64)
                   against its whole-graph reference, two Adam steps and
                   the trained weights in 4g's decoder (greedy next tokens
                   equal to the trained graph's argmax up to a near tie);
                s. mesh parallelism (``defer_tpu_torch.parallel``) on
                   one-card meshes, after o (its training checks carved
                   out of a and g): BERT-Base/12 on a (stage 12, model 2)
                   mesh, both wires, rows against 4b's tp=1 ring (buffer
                   1e-4, int8 5% of max |output|), 24 flash launches per
                   step (two ranks of 6 local heads per block), one
                   quantizer launch per int8 step, one capture per chunk
                   length, sequences/s beside 4b's; BERT-Base/4 through
                   ``Defer(DeferConfig(tensor_parallel=2,
                   data_parallel=2))``, equal to ``SpmdPipeline.run`` on
                   the same mesh; ring (8 ranks) and Ulysses (4 ranks)
                   attention at ``[1, 12, 8192, 64]``, causal and not,
                   within 2e-5 of ``full_attention``, the ring's peak
                   memory below the full product's; expert parallelism on
                   ``moe_0`` at BERT-Base widths over 4 ranks, equal to the
                   dense MoE within 1e-5, capacity 1 dropping tokens to
                   exactly their residual; ResNet50/8 int8 training on a
                   (data 2, stage 8) mesh (loss and gradients against 4r's
                   dp=1, one quantizer launch per ring step) and GPT-2
                   small/12 on a (stage 12, model 2) mesh (loss, unsharded
                   gradients and one SGD step's weights against 4r's
                   tp=1); ``MpmdPipeline(devices=[card] * 8)`` against 4a's
                   forward, and a mesh over two cards refused (A15b);
     4t. the ring across processes: four ``torch.distributed`` processes
         sharing the card over gloo (``scripts/torch_ring_procs.py``,
         spawned once, as 4s begins: a worker's host start runs beside
         4s): ResNet50/8 on a (stage 8) mesh, two stages a
         process, both wires, against 4a's ring (one quantizer launch per
         process and int8 step, the bytes a boundary carries, images/s
         beside 4a's); BERT-Base/12, three stages a process, against 4b's
         ring (12 flash launches a step over the processes); ResNet50/4 on
         (data 2, stage 4), each line on a sub-group, against the one-card
         ring on that mesh; ``Defer(mesh=).run``/``.stream``; the
         collectives across processes against one card; the guards (mpmd
         by design, A15b) and NCCL on one card refused when a ring is
         placed; GPT-2
         small/12, three stages a process, on 4g's weights:
         ``Defer(mesh=).generate`` of 4g's 96 prompts with the prefill
         (tokens against 4g's decoder up to a near tie, the same on every
         process, 144 flash launches over the processes, no capture) and
         ``Defer(mesh=).score`` on both wires against the one-process
         ``score`` (flash launches = blocks x steps, one quantizer launch
         per process and int8 step); tokens/s and sequences/s beside 4g's;
         ``PipelineTrainer`` of ResNet50/8 on the (stage 8) mesh, two
         stages a process, on 4r's chunk: the int8 ``loss_and_grad`` and
         the buffer wire's against 4r b's and a's loss and gradients, one
         quantizer launch per process and ring step, 2 Adam steps against
         4r b's losses, ``trained_params`` the same on every process and
         the trained deployment's run against a fresh pipeline of it, the
         bytes a boundary carries forward and back, seconds beside 4r's;
         ``Defer(mesh=).run_defer`` of ResNet50/8 on the int8 wire, two
         stages a process, on 4a's 8 microbatches (the rows bit-equal to
         the ring group's ``Defer(mesh=).run`` on every process, then
         ``END_OF_STREAM``; one quantizer launch per process and step,
         preflight and drain included) and ``Defer(mesh=).serve_endpoint``
         with two concurrent clients of 4 frames each (raw replies within
         1e-6 of those rows, END echoed to both, the leader's counters at
         64 images, the same address on every process), images/s beside
         4i's with no speed claim; tensor parallelism across the
         processes: BERT-Base/2 (``block_5`` the cut) on a (stage 2, model
         2) mesh, one position a process, on 4b's weights and ids, both
         wires: rows against 4b's whole-graph forward (4s's pp x tp
         bounds), the same on every process, 6 flash launches a process a
         step (24 summed), one quantizer launch a process and int8 step,
         12 all-reduces of the [8, 128, 768] f32 activation a process a
         step, sequences/s beside 4b's ring and 4s's one-card tp=2 ring;
  4u. the smoke scripts — ``scripts/torch_metrics_smoke.py`` and
         ``scripts/torch_decode_profile_smoke.py`` through their
         ``main(argv)`` on the card in this process, full mode: each row
         printed, every check of theirs held (the trace's spans under one
         id, per-stage percentiles and hop bytes; no capture or compile
         in a second identical ``generate``, ``decode.dispatches`` the
         schedule's units, dispatch seconds within the wall), counts read
         as deltas, 0 hand-kernel launches;
  5. report — the ``zoo_path``, ``endpoint_path``, ``serve_path``,
              ``chain_path``, ``colocate_path``, ``planner_path``,
              ``replication_path``, ``dag_path``, ``obs_path``,
              ``cli_path``, ``train_path``, ``mesh_path``,
              ``procs_path``, ``scripts_path``, the ``budget:`` line,
              ``phase_seconds`` and
              ``kernels`` JSON lines, the card line, and the last line
              ``{"ok": true, "device": {...}}``; each phase's seconds are
              also printed as it ends.

The phases run under a budget: ``phase_seconds`` should total at most
BUDGET_S (600 s) with phase 4o at most DAG_BUDGET_S (100 s), phase 4p
at most OBS_BUDGET_S (40 s), phase 4q at most CLI_BUDGET_S (30 s),
phase 4r at most TRAIN_BUDGET_S (45 s), phase 4s at most
MESH_BUDGET_S (30 s), phase 4t at most PROCS_BUDGET_S (45 s) and phase 4u
at most SCRIPTS_BUDGET_S (15 s), paid for by
running earlier paths smaller (PERF.md §4).  A watchdog armed at start
fails the run at WATCHDOG_S (720 s): it names the phase still running,
dumps every thread's stack, kills the node processes the smoke started
and exits 1.  Where the installed torch carries no bytecode and Python
may not write it (``PYTHONDONTWRITEBYTECODE``), the smoke keeps the
bytecode it compiles under ``defer_tpu_torch/_build/pycache`` and its
node processes read it there (``bytecode_cache``).

Weights are the port's own seeded random initialisation (phase 4i also
reads them back from files it writes); inputs come from ``numpy`` with a
fixed seed.  Needs one card; exits non-zero without CUDA
or without the ``defer_tpu_torch`` package beside it.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

SEED = 0
MICROBATCH = 8
CHUNK = 4
IMAGE_SIZE = 224
#: int8-wire bound against the full-precision forward: max |error| over
#: the logits <= this fraction of max |logit|.  Each of the 8 hops adds at
#: most half a quant step (1/254 of its block's max) per value; 5% leaves
#: room for the network to amplify eight such perturbations.
INT8_REL_BOUND = 0.05
#: the buffer wire moves f32 values unchanged: pipeline == forward up to
#: cuDNN choosing another algorithm for a stage's slice of the graph
BUFFER_REL_BOUND = 1e-5
#: bf16 compute against the whole-graph forward with the same bf16
#: weights and input, buffer wire: the pipeline rounds where the forward
#: does (stage outputs cross the ring in a dtype that holds bf16 exactly),
#: so only cuDNN and cuBLAS picking other kernels for a stage's slice
#: separates them
BF16_BUFFER_REL_BOUND = 1e-2
#: a chunk's CUDA graph against the same chunk run eagerly, and a
#: reweighted pipeline against a fresh one: the same kernels on the same
#: inputs, so only a library choosing another algorithm could separate them
GRAPH_REL_BOUND = 1e-6
#: BERT-Base sequence length (BASELINE.md config 5)
SEQ_LEN = 128
#: flash attention against its plain version, f32 on N(0,1) inputs: the
#: kernel forms each product from three TF32 terms (about 1e-6 off exact
#: f32, tests/test_torch_flash_tf32.py) and sums in another order
FLASH_F32_TOL = 1e-5
#: (name, B, H, Tq, Tk, D, causal, dtype): the BERT-Base shape at
#: microbatch 8 (f32 and bf16), the JAX package's flash-attention test
#: cases, D = 128 (one and several key tiles), Tq=5 against Tk=3 causal,
#: whose rows 0 and 1 see no key, a long causal prefill (16 key tiles
#: through the ring), and two layouts that take the kernel's element-wise
#: staging: 20-byte rows (D = 5) and views one element past an allocation
FLASH_CASES = [
    ("bert_base", 8, 12, 128, 128, 64, False, "float32"),
    ("blocks", 2, 3, 64, 64, 16, False, "float32"),
    ("padding_causal", 1, 2, 100, 100, 24, True, "float32"),
    ("tq_ne_tk", 2, 2, 37, 53, 8, False, "float32"),
    ("two_q_tiles_causal", 1, 1, 130, 130, 64, True, "float32"),
    ("decode_tq1", 1, 2, 1, 48, 16, True, "float32"),
    ("decode_tq5", 1, 2, 5, 48, 16, True, "float32"),
    ("bf16", 1, 2, 64, 64, 32, False, "bfloat16"),
    ("d128", 2, 4, 128, 128, 128, False, "float32"),
    ("zero_rows", 1, 2, 5, 3, 16, True, "float32"),
    ("long_causal", 1, 12, 1024, 1024, 64, True, "float32"),
    ("d128_key_tiles_causal", 2, 2, 70, 150, 128, True, "float32"),
    ("d5_rows", 2, 3, 40, 50, 5, False, "float32"),
    ("offset_view", 2, 3, 70, 90, 32, True, "float32"),
    ("bf16_bert_base", 8, 12, 128, 128, 64, False, "bfloat16"),
    # GPT-2 small's causal attention on its served paths (phase 4g): the
    # fused prefill of a 32-token prompt, and Defer.score at bucket 128
    ("gpt2_prefill", 8, 12, 32, 32, 64, True, "float32"),
    ("gpt2_prefill_bf16", 8, 12, 32, 32, 64, True, "bfloat16"),
    ("gpt2_score", 8, 12, 128, 128, 64, True, "float32"),
    ("gpt2_score_bf16", 8, 12, 128, 128, 64, True, "bfloat16"),
    # moe_tiny's and moe_branched_tiny's blocks at microbatch 8 (phase 4h)
    ("moe_tiny", 8, 2, 16, 16, 16, False, "float32"),
    # BERT-Base's local heads under 2-way tensor parallelism (phase 4s):
    # 6 heads of a rank's fused [b, t, 3 * 6 * 64] projection
    ("bert_base_tp2", 8, 6, 128, 128, 64, False, "float32"),
    ("bf16_bert_base_tp2", 8, 6, 128, 128, 64, False, "bfloat16"),
]
#: the causal GPT-2 cases timed beside SDPA's causal mode
GPT2_FLASH_CASES = ("gpt2_prefill", "gpt2_prefill_bf16", "gpt2_score",
                    "gpt2_score_bf16")

#: device memory rate of the cards the smoke knows (bytes/s, data sheets)
MEM_RATE = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
            ("H100", 3.35e12)]
#: float32 rate outside the tensor cores, H100 SXM data sheet (flop/s)
F32_RATE = 67e12
#: TF32 tensor-core rate, H100 SXM data sheet (flop/s, dense)
TF32_RATE = 495e12
#: bf16 tensor-core rate, H100 SXM data sheet (flop/s, dense)
BF16_RATE = 989e12
#: TF32 products per f32 product in the flash kernel (lo*hi + hi*lo + hi*hi)
TF32_TERMS = 3
#: device sleep queued ahead of a timed window (~100 ms at 2 GHz): longer
#: than the host takes to queue 50 calls of a plain version
SLEEP_CYCLES = 200_000_000


#: where the run keeps the bytecode of what it and its node processes
#: import, when the installed torch has none beside its sources and Python
#: may not write any there (``PYTHONDONTWRITEBYTECODE``): every fresh
#: process then compiled torch's modules anew, most of a node's boot
#: (``scripts/torch_chain_boot.py``)
PYCACHE = ("defer_tpu_torch", "_build", "pycache")


def bytecode_cache() -> str | None:
    """Keep this process's and its children's bytecode under the checkout's
    build directory (``PYCACHE``), unless the caller chose a prefix, the
    package is not beside this script, or torch ships its bytecode.  Runs
    before ``import torch``: this process compiles torch once and writes
    it, and every node process it spawns reads it.  Returns the prefix
    (None when left alone)."""
    import importlib.util
    import os
    from pathlib import Path

    pkg = Path(__file__).resolve().parent / PYCACHE[0]
    spec = importlib.util.find_spec("torch")
    if (os.environ.get("PYTHONPYCACHEPREFIX") or not pkg.is_dir()
            or spec is None or spec.origin is None or os.path.exists(
                importlib.util.cache_from_source(spec.origin))):
        return None
    prefix = pkg.parent.joinpath(*PYCACHE)
    prefix.mkdir(parents=True, exist_ok=True)
    sys.pycache_prefix = str(prefix)
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = str(prefix)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    return str(prefix)


#: the smoke's time budget: every phase's seconds together, and phase 4o's
BUDGET_S = 600.0
DAG_BUDGET_S = 100.0
#: the watchdog's limit: the budget plus 20%
WATCHDOG_S = 720.0
#: phase 4p's share of BUDGET_S (its checks ride 4k's and 4n's chains)
OBS_BUDGET_S = 40.0
#: phase 4q's share of BUDGET_S (its commands ride 4a's, 4g's and 4k's
#: models and chains)
CLI_BUDGET_S = 30.0
#: the phases in order (``phase_seconds`` keys); 4p's, 4q's and 4r's
#: seconds are carved out of the phases where their checks run
PHASES = ("1", "2", "3", "4a", "4b", "4c", "4d", "4e", "4f", "4g", "4h",
          "4i", "4j", "4k", "4l", "4m", "4n", "4o", "4s", "4t", "4u", "4p",
          "4q", "4r")


def kill_children() -> list:
    """SIGKILL every process this smoke started, and theirs (the node
    processes of the chain phases), found by parent pid under /proc."""
    import os
    import signal

    kids: dict = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        kids.setdefault(ppid, []).append(int(d))
    todo, found = [os.getpid()], []
    while todo:
        for pid in kids.get(todo.pop(), ()):
            found.append(pid)
            todo.append(pid)
    for pid in found:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return found


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    kill_children()
    sys.exit(1)


class Watchdog:
    """A daemon timer armed when the smoke starts: past ``seconds`` it
    prints which phase is still running, every thread's stack, kills the
    node processes the smoke spawned and exits 1 — a hang fails with its
    phase's name, not the caller's clock."""

    def __init__(self, seconds: float):
        import threading

        self.seconds = seconds
        self.t0 = time.perf_counter()
        self.phase = PHASES[0]
        self.phase_t0 = self.t0
        self._timer = threading.Timer(seconds, self._fire)
        self._timer.daemon = True

    def start(self) -> "Watchdog":
        self.t0 = self.phase_t0 = time.perf_counter()
        self._timer.start()
        return self

    def enter(self, phase: str) -> None:
        self.phase, self.phase_t0 = phase, time.perf_counter()

    def cancel(self) -> None:
        self._timer.cancel()

    def _fire(self) -> None:
        import faulthandler
        import os

        now = time.perf_counter()
        msg = (f"chip_smoke: FAIL: phase {self.phase} still running after "
               f"{now - self.phase_t0:.1f} s (the smoke at "
               f"{now - self.t0:.1f} s, past its {self.seconds:.0f} s "
               f"watchdog)")
        for stream in (sys.stdout, sys.stderr):
            print(msg, file=stream, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.flush()
        killed = kill_children()
        print(f"chip_smoke: watchdog killed {len(killed)} child "
              f"process(es): {killed}", file=sys.stderr, flush=True)
        os._exit(1)


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE:
        if key in name:
            return rate
    fail(f"no memory rate known for card {name!r}; add it to MEM_RATE")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time of one ``fn()`` in ms: ``iters`` calls back to back
    between two CUDA events, queued behind a device-side sleep so that the
    host's launch time stays out of the window (a microsecond kernel
    launched from Python would otherwise be timed at the host's pace)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms > ev[0].elapsed_time(ev[1]):
        print(f"time_ms: the host took {host_ms:.3f} ms to queue {iters} "
              "calls, longer than the device sleep before them: the time "
              "below includes host gaps", flush=True)
    return ev[1].elapsed_time(ev[2]) / iters


# ---------------------------------------------------------------------------
# phase 3: the quantizer against its plain version
# ---------------------------------------------------------------------------


def quant_inputs(torch, ring_shape, device):
    """The main-path ring shape with per-block magnitudes spread over ~6
    decades, plus edge blocks: zeros, +-inf/NaN, exact ties."""
    g = torch.Generator(device=device).manual_seed(SEED)
    n = ring_shape[-1]
    mag = torch.exp(3.0 * torch.randn(
        ring_shape[:-1] + (n // 256, 1), generator=g, device=device))
    ring = (torch.randn(ring_shape[:-1] + (n // 256, 256), generator=g,
                        device=device) * mag).reshape(ring_shape)
    edge = torch.zeros(4, 256, device=device)
    edge[1, :3] = torch.tensor([math.inf, -math.inf, math.nan])
    edge[1, 3:] = torch.linspace(-2.0, 2.0, 253)
    # ties: amax 127 -> scale 1, so k + 0.5 sits exactly on a half;
    # amax 127/8 -> scale 1/8, the same ties scaled by a power of two
    k = torch.arange(-126, 129, device=device, dtype=torch.float32)[:255]
    edge[2, 0] = 127.0
    edge[2, 1:] = (k - 0.5).clamp(-126.5, 126.5)
    edge[3] = edge[2] / 8.0
    return ring, edge


def check_quant(torch, ring_shape, device, zoo_rings):
    """Bit-equality with the plain version, and timings, on ResNet50's
    ring and on each ring of ``zoo_rings`` (``{path: ring shape}``, phase
    4h's paths).  Returns the kernel row of the report (without
    ``launches``)."""
    from defer_tpu_torch.ops.quant import quantize_int8_blocks_plain
    from defer_tpu_torch.ops.quant_cuda import KERNEL

    ring, edge = quant_inputs(torch, ring_shape, device)
    cases = {"ring_f32": ring, "ring_bf16": ring.to(torch.bfloat16),
             "edge_f32": edge, "edge_bf16": edge.to(torch.bfloat16)}
    max_err = 0.0
    for name, x in cases.items():
        qk, sk = KERNEL(x)
        qp, sp = quantize_int8_blocks_plain(x)
        torch.cuda.synchronize()
        if not (torch.equal(qk, qp)
                and torch.equal(sk.view(torch.int32), sp.view(torch.int32))):
            bad = (qk != qp).sum().item()
            fail(f"quant_int8 != plain on {name}: {bad} payload bytes differ,"
                 f" scales equal={torch.equal(sk, sp)}")
        max_err = max(max_err, (qk.int() - qp.int()).abs().max().item(),
                      (sk - sp).abs().max().item())
    print(f"kernel quant_int8: bit-equal to plain on "
          f"{', '.join(f'{k}{tuple(v.shape)}' for k, v in cases.items())}",
          flush=True)

    def timed(x):
        ms = time_ms(torch, lambda: KERNEL(x))
        plain_ms = time_ms(torch, lambda: quantize_int8_blocks_plain(x))
        values = x.numel()
        nbytes = values * x.element_size() + values + 4 * (values // 256)
        bytes_ms = nbytes / mem_rate(torch.cuda.get_device_name(0)) * 1e3
        # flush test, |x|, max, divide, round, clamp: ~6 f32 ops per value
        ops_ms = 6 * values / F32_RATE * 1e3
        return {"ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None, "shape": list(x.shape),
                "dtype": str(x.dtype).removeprefix("torch."),
                "bytes": nbytes}

    # phase 4h's rings, f32 and bf16, bit-equal and timed
    zoo = {}
    for path, shape in zoo_rings.items():
        zring, _ = quant_inputs(torch, shape, device)
        zoo[path] = {}
        for dt in ("float32", "bfloat16"):
            x = zring.to(getattr(torch, dt))
            qk, sk = KERNEL(x)
            qp, sp = quantize_int8_blocks_plain(x)
            torch.cuda.synchronize()
            if not (torch.equal(qk, qp) and torch.equal(
                    sk.view(torch.int32), sp.view(torch.int32))):
                fail(f"quant_int8 != plain on the {path} ring {shape} {dt}")
            zoo[path][dt] = timed(x)
        print(f"kernel quant_int8: bit-equal to plain on the {path} ring "
              f"{tuple(shape)}, f32 and bf16", flush=True)

    # the f32 ring of the f32 deployments, and the bf16 ring of ResNet50
    # under bf16 compute (phase 4d)
    return {"name": KERNEL.name, "route": "cuda",
            "source": "defer_tpu_torch/csrc/quant_int8.cu",
            "replaces": "defer_tpu/ops/quant_pallas.py:35",
            "max_abs_err": max_err, **timed(ring),
            "bf16": timed(cases["ring_bf16"]), "zoo_rings": zoo,
            "checked_by": "phase 3 (bit-equal vs plain) + phase 4 (main "
                          "path launches)"}


def bf16_ulp(torch, x):
    """Spacing of bfloat16 values at |x| (8 significant bits)."""
    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_flash(torch, device, card):
    """Flash attention against its plain version on every case of
    FLASH_CASES, then timed at the BERT-Base shape beside the plain
    version and ``scaled_dot_product_attention``.  Returns the kernel row
    of the report (without ``launches``)."""
    import torch.nn.functional as F

    from defer_tpu_torch.ops.flash_attention import flash_attention_plain
    from defer_tpu_torch.ops.flash_attention_cuda import KERNEL

    g = torch.Generator(device=device).manual_seed(SEED)
    max_err = 0.0
    tensors = {}
    for name, b, h, tq, tk, d, causal, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        if name in ("bert_base", "bert_base_tp2", "bf16_bert_base_tp2"):
            # the main path's layout: head-split views of the fused
            # [b, t, 3 * h * d] projection, read by stride
            qkv = torch.randn((b, tq, 3 * h * d), generator=g,
                              device=device).to(dtype)
            q, k, v = (x.reshape(b, tq, h, d).transpose(1, 2)
                       for x in qkv.chunk(3, dim=-1))
            tensors[f"{name}_qkv"] = qkv
        elif name == "offset_view":
            # bases 4 bytes past a 16-byte boundary
            q, k, v = (torch.randn(math.prod(shape) + 1, generator=g,
                                   device=device)[1:].view(shape)
                       for shape in ((b, h, tq, d), (b, h, tk, d),
                                     (b, h, tk, d)))
        else:
            q, k, v = (torch.randn(shape, generator=g, device=device)
                       .to(dtype) for shape in ((b, h, tq, d), (b, h, tk, d),
                                                (b, h, tk, d)))
        tensors[name] = (q, k, v)
        out = KERNEL(q, k, v, causal)
        ref = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err_t = (out.float() - ref.float()).abs()
        err = err_t.max().item()
        if dtype == torch.float32:
            ok = err <= FLASH_F32_TOL
        else:  # one bf16 ulp of the plain output, after the f32 difference
            ok = bool((err_t <= bf16_ulp(torch, ref) + FLASH_F32_TOL).all())
        if not ok:
            fail(f"flash_attention != plain on {name} {(b, h, tq, tk, d)} "
                 f"causal={causal} {dt}: max|err| {err:.3g}")
        if name == "zero_rows" and bool(out[:, :, :2].any()):
            fail("flash_attention: rows with no live key are not exactly 0")
        if dtype == torch.float32:
            max_err = max(max_err, err)
        print(f"kernel flash_attention {name} {(b, h, tq, tk, d)} "
              f"causal={causal} {dt}: max|err| {err:.3g} vs plain", flush=True)

    # the long causal prefill beside SDPA's causal mode (the same alignment
    # when Tq = Tk)
    lq, lk, lv = tensors["long_causal"]
    long_ms = time_ms(torch, lambda: KERNEL(lq, lk, lv, True))
    long_sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        lq, lk, lv, is_causal=True))
    print(f"kernel flash_attention long_causal {tuple(lq.shape)} f32: "
          f"{long_ms:.4f} ms, scaled_dot_product_attention(is_causal=True) "
          f"{long_sdpa_ms:.4f} ms", flush=True)

    def timed(q, k, v):
        ms = time_ms(torch, lambda: KERNEL(q, k, v, False))
        plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v))
        sdpa_err = (F.scaled_dot_product_attention(q, k, v).float()
                    - flash_attention_plain(q, k, v).float()
                    ).abs().max().item()
        b, h, tq, d = q.shape
        tk = k.shape[2]
        flops = 4 * b * h * tq * tk * d
        nbytes = 4 * q.numel() * q.element_size()  # q, k, v read; o written
        bytes_ms = nbytes / mem_rate(torch.cuda.get_device_name(0)) * 1e3
        # f32 inputs: f32-accurate products on the tensor cores, three TF32
        # passes; bf16 inputs: the card's bf16 rate
        ops_ms = (TF32_TERMS * flops / TF32_RATE if q.dtype == torch.float32
                  else flops / BF16_RATE) * 1e3
        return {"ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                "library_ms": library_ms,
                "library": "torch.nn.functional.scaled_dot_product_attention",
                "library_max_abs_err": sdpa_err,
                "shape": [b, h, tq, tk, d],
                "dtype": str(q.dtype).removeprefix("torch."),
                "bytes": nbytes, "flops": flops}

    def timed_causal(q, k, v):
        """A causal case beside the plain version and SDPA's causal mode
        (the same alignment when Tq = Tk); the bound counts the live
        (query, key) pairs only, T(T+1)/2 per head."""
        ms = time_ms(torch, lambda: KERNEL(q, k, v, True))
        plain_ms = time_ms(torch, lambda: flash_attention_plain(
            q, k, v, causal=True))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        b, h, t, d = q.shape
        flops = 4 * b * h * d * t * (t + 1) // 2
        nbytes = 4 * q.numel() * q.element_size()
        bytes_ms = nbytes / mem_rate(torch.cuda.get_device_name(0)) * 1e3
        ops_ms = (TF32_TERMS * flops / TF32_RATE if q.dtype == torch.float32
                  else flops / BF16_RATE) * 1e3
        return {"ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                "library_ms": library_ms,
                "library": "torch.nn.functional.scaled_dot_product_attention"
                           "(is_causal=True)",
                "shape": [b, h, t, t, d],
                "dtype": str(q.dtype).removeprefix("torch."),
                "bytes": nbytes, "flops": flops}

    causal_rows = {}
    for name in GPT2_FLASH_CASES:
        r = causal_rows[name] = timed_causal(*tensors[name])
        print(f"kernel flash_attention {name} {tuple(r['shape'])} causal "
              f"{r['dtype']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"scaled_dot_product_attention(is_causal=True) "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes'] / 1e6:.2f} MB, "
              f"{r['flops'] / 1e6:.1f} MFLOP), "
              f"{r['bound_ms'] / r['ms'] * 100:.1f}% of the bound, on "
              f"{card}", flush=True)

    # the main paths' layout (head-split views of the fused projection),
    # in f32 and in bf16 (phase 4d's BERT-Base blocks)
    q, k, v = tensors["bert_base"]
    row = timed(q, k, v)
    b, t, h, d = q.shape[0], q.shape[2], q.shape[1], q.shape[3]
    qkv16 = tensors["bert_base_qkv"].to(torch.bfloat16)
    row["bf16"] = timed(*(x.reshape(b, t, h, d).transpose(1, 2)
                          for x in qkv16.chunk(3, dim=-1)))
    # phase 4s's local heads: each tensor-parallel rank's 6 of 12
    tp2 = row["tp2_local_heads"] = timed(*tensors["bert_base_tp2"])
    tp2["bf16"] = timed(*tensors["bf16_bert_base_tp2"])
    for r in (tp2, tp2["bf16"]):
        print(f"kernel flash_attention bert_base_tp2 {tuple(r['shape'])} "
              f"{r['dtype']} (a rank's local heads): {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms'] * 100:.1f}% of "
              f"the bound, on {card}", flush=True)
    return {"name": KERNEL.name, "route": "cuda",
            "source": "defer_tpu_torch/csrc/flash_attention.cu",
            "replaces": "defer_tpu/ops/flash_attention.py:41",
            "max_abs_err": max_err, **row,
            # the bound of an FMA design (no tensor cores), for comparison
            "fma_bound_ms": row["flops"] / F32_RATE * 1e3,
            "long_causal": {"shape": list(lq.shape), "ms": long_ms,
                            "library_ms": long_sdpa_ms},
            "causal_gpt2": causal_rows,
            "checked_by": "phase 3 (f32 <= 1e-5, bf16 <= 1 ulp, zero rows "
                          "vs plain on %d cases) + phase 4b (main path "
                          "launches)" % len(FLASH_CASES)}


# ---------------------------------------------------------------------------
# phase 4a: the ResNet50 main path
# ---------------------------------------------------------------------------


def zero_counts(kernels) -> None:
    for k in kernels:
        k.zero()


def read_counts(kernels) -> dict:
    return {k.name: k.launches for k in kernels}


def read_dtypes(kernels) -> dict:
    return {k.name: dict(k.by_dtype) for k in kernels}


def main_path(torch, device, kernels):
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig
    from defer_tpu_torch.models import RESNET50_8STAGE_CUTS, resnet50
    from defer_tpu_torch.utils.convert import params_to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = resnet50(image_size=IMAGE_SIZE)
    params = g.init(torch.Generator().manual_seed(SEED))
    n = len(RESNET50_8STAGE_CUTS) + 1
    m = 2 * CHUNK  # two full chunks; the flush adds the drain
    inputs = np.random.default_rng(SEED).standard_normal(
        (m, MICROBATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    steps = CHUNK * -(-(m + n - 1) // CHUNK)

    defer = Defer(DeferConfig(wire="int8", microbatch=MICROBATCH,
                              chunk=CHUNK, device=device))
    zero_counts(kernels)
    out = defer.run(g, params, inputs, cut_points=RESNET50_8STAGE_CUTS)
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    print(f"main path: Defer.run(resnet50, {n} stages "
          f"{RESNET50_8STAGE_CUTS}, wire=int8, microbatch={MICROBATCH}, "
          f"chunk={CHUNK}) on {m} microbatches = {steps} steps; kernel "
          f"launches {launches}", flush=True)
    if launches["quant_int8"] != steps:
        fail(f"quant_int8 launched {launches['quant_int8']} times in "
             f"{steps} pipeline steps (want one per step)")

    pdev = params_to_device(params, device)
    with torch.inference_mode():
        ref = np.stack([g.apply(pdev, torch.from_numpy(x).to(device))
                        .cpu().numpy() for x in inputs])
    if out.shape != ref.shape or not np.isfinite(out).all():
        fail(f"int8 output shape {out.shape} (want {ref.shape}) or not "
             "finite")
    scale = float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    top_ref, top_out = ref.argmax(-1), out.argmax(-1)
    srt = np.sort(ref, -1)
    margin = float((srt[..., -1] - srt[..., -2]).min())
    print(f"main path int8 vs whole-graph forward: max|err| {err:.6g} = "
          f"{err / scale:.6g} of max|logit| {scale:.6g} (bound "
          f"{INT8_REL_BOUND}); top-1 agree {int((top_ref == top_out).sum())}"
          f"/{top_ref.size}; smallest top-1 margin {margin:.6g}", flush=True)
    if err > INT8_REL_BOUND * scale:
        fail("int8 wire error above its bound")
    if not (top_ref == top_out).all():
        fail("int8 wire changed a top-1 class")

    zero_counts(kernels)
    buf = Defer(DeferConfig(wire="buffer", microbatch=MICROBATCH,
                            chunk=CHUNK, device=device)).run(
        g, params, inputs, cut_points=RESNET50_8STAGE_CUTS)
    torch.cuda.synchronize()
    buf_launches = read_counts(kernels)
    berr = float(np.abs(buf - ref).max())
    print(f"main path buffer wire vs forward: max|err| {berr:.6g} = "
          f"{berr / scale:.6g} of max|logit| (bound {BUFFER_REL_BOUND}); "
          f"kernel launches {buf_launches}", flush=True)
    if berr > BUFFER_REL_BOUND * scale:
        fail("buffer-wire pipeline differs from the forward")
    return {"steps": steps, "rel_err": err / scale,
            "launches": {"int8": launches, "buffer": buf_launches},
            "top1_agree": f"{int((top_ref == top_out).sum())}/"
                          f"{top_ref.size}", "buffer_rel_err": berr / scale,
            "defer": defer, "graph": g, "params": params, "inputs": inputs,
            "rows": {"int8": out, "buffer": buf},
            "pdev": pdev, "cuts": RESNET50_8STAGE_CUTS, "ref": ref,
            # phase 4d's bf16 deployment: bf16 weights and ring
            "bf16": dict(compute_dtype="bfloat16", buffer_dtype="bfloat16")}


# ---------------------------------------------------------------------------
# phase 4b: the BERT-Base main path
# ---------------------------------------------------------------------------


def bert_path(torch, device, kernels):
    """BERT-Base (seq 128, full width and depth, seeded random weights) in
    12 stages through ``Defer.run`` on both wires, each run's launch
    counts zeroed just before and read just after, the pooler output held
    against the whole-graph forward on the card (TF32 off)."""
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig
    from defer_tpu_torch.models import BERT_BASE_12STAGE_CUTS, bert_base
    from defer_tpu_torch.utils.convert import params_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    g = bert_base(seq_len=SEQ_LEN)
    params = g.init(torch.Generator().manual_seed(SEED))
    cuts = BERT_BASE_12STAGE_CUTS
    n = len(cuts) + 1
    blocks = sum(name.startswith("block_") for name in g.topo_order)
    m = 2 * CHUNK
    vocab = g.nodes["embeddings"].op.vocab
    # token ids ride the f32 ring exactly (ids < 2**24)
    ids = np.random.default_rng(SEED).integers(
        0, vocab, (m, MICROBATCH, SEQ_LEN)).astype(np.float32)
    steps = CHUNK * -(-(m + n - 1) // CHUNK)

    pdev = params_to_device(params, device)
    with torch.inference_mode():
        ref = np.stack([g.apply(pdev, torch.from_numpy(x).to(
            device, torch.int32)).cpu().numpy() for x in ids])
    if not np.isfinite(ref).all():
        fail("BERT-Base forward is not finite")
    scale = float(np.abs(ref).max())

    res = {"steps": steps, "launches": {}, "rel_err": {}}
    for wire, bound in (("buffer", BUFFER_REL_BOUND),
                        ("int8", INT8_REL_BOUND)):
        defer = Defer(DeferConfig(wire=wire, microbatch=MICROBATCH,
                                  chunk=CHUNK, device=device))
        zero_counts(kernels)
        out = defer.run(g, params, ids, cut_points=cuts)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        print(f"bert path: Defer.run(bert_base seq {SEQ_LEN}, {n} stages "
              f"block_0..block_10, wire={wire}, microbatch={MICROBATCH}, "
              f"chunk={CHUNK}) on {m} microbatches = {steps} steps; kernel "
              f"launches {launches}", flush=True)
        want = {"flash_attention": blocks * steps,
                "quant_int8": steps if wire == "int8" else 0}
        if any(launches[k] != c for k, c in want.items()):
            fail(f"bert path wire={wire}: launches {launches}, want {want} "
                 f"({blocks} flash launches and "
                 f"{'one' if wire == 'int8' else 'no'} quantizer launch "
                 f"per step)")
        if out.shape != ref.shape or not np.isfinite(out).all():
            fail(f"bert {wire} output shape {out.shape} (want {ref.shape}) "
                 "or not finite")
        err = float(np.abs(out - ref).max())
        mse = float(np.square(out - ref).mean())
        print(f"bert path {wire} wire vs whole-graph forward: max|err| "
              f"{err:.6g} = {err / scale:.6g} of max|output| {scale:.6g} "
              f"(bound {bound}); MSE {mse:.3g}", flush=True)
        if err > bound * scale:
            fail(f"bert {wire}-wire error above its bound")
        res["launches"][wire] = launches
        res["rel_err"][wire] = err / scale
        res.setdefault("rows", {})[wire] = out
        if wire == "int8":
            res["defer"] = defer
    res.update(graph=g, params=params, inputs=ids, pdev=pdev, cuts=cuts,
               ref=ref, bf16=dict(compute_dtype="bfloat16"))
    return res


# ---------------------------------------------------------------------------
# phase 4, both paths: throughput and profile
# ---------------------------------------------------------------------------


def throughput(torch, device, mp, card, unit: str, rounds: int = 7):
    """Steady-state samples/s of the pipeline (both wires, f32 and the
    path's bf16 deployment) and of the whole-graph forward at the same
    batch (f32 and bf16 weights and input), all on the host clock around a
    chunk of work that ends in a synchronize (launch time included, as a
    user sees it).  The six alternate, round after round, so drift on the
    shared host hits all of them alike; the median round is kept."""
    from defer_tpu_torch import Defer, DeferConfig
    from defer_tpu_torch.graph.ir import tree_map

    def pipeline(wire, **kw):
        pipe = Defer(DeferConfig(wire=wire, microbatch=MICROBATCH,
                                 chunk=CHUNK, device=device, **kw)).build(
            mp["graph"], mp["params"], mp["cuts"])
        xs = pipe.stage_inputs(mp["inputs"][:CHUNK])
        for _ in range(2):  # capture the chunk's graph, fill the ring
            pipe.push(xs)
        return lambda: pipe.push(xs)

    def forward(dtype):
        cast = dtype if mp["graph"].input_spec.dtype.is_floating_point \
            else mp["graph"].input_spec.dtype
        xs = [torch.from_numpy(x).to(device, cast)
              for x in mp["inputs"][:CHUNK]]
        pdev = tree_map(lambda v: v.to(dtype), mp["pdev"])

        def run():
            with torch.inference_mode():
                for x in xs:
                    mp["graph"].apply(pdev, x)
        return run

    runs = {"pipeline_int8": pipeline("int8"),
            "pipeline_buffer": pipeline("buffer"),
            "forward": forward(torch.float32),
            "pipeline_bf16_int8": pipeline("int8", **mp["bf16"]),
            "pipeline_bf16_buffer": pipeline("buffer", **mp["bf16"]),
            "forward_bf16": forward(torch.bfloat16)}
    walls = {k: [] for k in runs}
    for _ in range(rounds):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    rows = {}
    for name, w in walls.items():
        rows[name] = CHUNK * MICROBATCH / statistics.median(w)
        rows[f"{name}_spread"] = (max(w) - min(w)) / statistics.median(w)
    print(f"throughput {mp['graph'].name} on {card} (TF32 off; bf16 rows: "
          f"{mp['bf16']}; microbatch {MICROBATCH}, median of {rounds} "
          f"alternating rounds of {CHUNK} steps, one graph replay each): "
          + ", ".join(f"{k} {rows[k]:.1f} {unit}/s (spread "
                      f"{rows[k + '_spread'] * 100:.0f}%)" for k in runs),
          flush=True)
    return rows


def profile_step(torch, mp, groups: dict, defer=None, label="int8"):
    """Device time by kernel over one chunk of ``defer``'s deployment (the
    path's int8 f32 one by default) — one graph replay — with
    torch.profiler, and each group's share (a kernel joins the first group
    whose pattern its name contains).  Returns the shares, or None without
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe = (defer or mp["defer"]).build(mp["graph"], mp["params"],
                                        mp["cuts"])
    xs = pipe.stage_inputs(mp["inputs"][:CHUNK])
    pipe.push(xs)  # captures the chunk's graph
    walls = []
    for _ in range(5):  # the chunk's wall with the profiler off
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.push(xs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    plain_wall_us = statistics.median(walls) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.push(xs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(r[0] for r in rows)
    if not total:
        print("profile: no device time in the trace (not measured)")
        return None
    rows.sort(reverse=True)
    shares = dict.fromkeys(groups, 0.0)
    shares["everything else"] = 0.0
    for us, key, _ in rows:
        group = next((g for g, ms in groups.items()
                      if any(m in key for m in ms)), "everything else")
        shares[group] += us
    print(f"profile {mp['graph'].name}, one {label} chunk ({CHUNK} steps, "
          f"one graph replay): "
          f"device time {total / 1e3:.3f} ms = {total / 1e3 / CHUNK:.3f} "
          f"ms/step in a {wall_us / 1e3:.3f} ms wall (device idle "
          f"{max(0.0, 1 - total / wall_us) * 100:.1f}%, profiler on; "
          f"{max(0.0, 1 - total / plain_wall_us) * 100:.1f}% of the "
          f"{plain_wall_us / 1e3:.3f} ms median wall with it off); "
          + ", ".join(f"{g} {us / total * 100:.1f}%"
                      for g, us in shares.items()), flush=True)
    for us, key, count in rows[:12]:
        print(f"  {us / total * 100:6.2f}%  {us / 1e3:9.3f} ms  x{count:<5d}"
              f" {key[:100]}")
    return {g: us / total for g, us in shares.items()} | {
        "device_ms_per_step": total / 1e3 / CHUNK,
        "idle_share": max(0.0, 1 - total / wall_us),
        "idle_share_profiler_off": max(0.0, 1 - total / plain_wall_us)}


# ---------------------------------------------------------------------------
# phase 4c: one graph replay per chunk against the eager loop
# ---------------------------------------------------------------------------


def graph_vs_eager(torch, mp):
    """One chunk of the path's int8 deployment through its CUDA graph and
    through the eager loop, from the same ring: outputs and ring within
    GRAPH_REL_BOUND of their max |value|."""
    pipe = mp["defer"].build(mp["graph"], mp["params"], mp["cuts"])
    xs = pipe.stage_inputs(mp["inputs"][:CHUNK])
    for _ in range(-(-pipe.num_stages // CHUNK)):  # capture, fill the ring
        pipe.push(xs)
    ring = pipe._a.clone()
    graph_out = pipe._run_chunk(xs).clone()
    graph_ring = pipe._a.clone()
    pipe._a.copy_(ring)
    eager_out = pipe._eager_chunk(xs)
    torch.cuda.synchronize()
    err = ((graph_out.float() - eager_out.float()).abs().max().item()
           / eager_out.float().abs().max().item())
    ring_err = ((graph_ring.float() - pipe._a.float()).abs().max().item()
                / pipe._a.float().abs().max().item())
    m = pipe.metrics
    print(f"graph vs eager {mp['graph'].name} int8, one chunk of {CHUNK} "
          f"steps: outputs {err:.3g}, ring {ring_err:.3g} of max |value| "
          f"(bound {GRAPH_REL_BOUND}); graph pool "
          f"{m.graph_pool_bytes / 2**20:.1f} MiB (ring "
          f"{pipe._a.numel() * pipe._a.element_size() / 2**20:.1f} MiB), "
          f"captures {m.captures}", flush=True)
    if max(err, ring_err) > GRAPH_REL_BOUND:
        fail(f"{mp['graph'].name}: graph replay differs from the eager loop")
    if m.captures != 1:
        fail(f"{mp['graph'].name}: {m.captures} captures for one chunk "
             "length")
    return {"rel_err": err, "ring_rel_err": ring_err,
            "graph_pool_bytes": m.graph_pool_bytes, "captures": m.captures}


# ---------------------------------------------------------------------------
# phase 4d: bf16 compute
# ---------------------------------------------------------------------------


def bf16_path(torch, device, kernels, mp, want_dtypes):
    """The path's bf16 deployment (``mp["bf16"]``) through ``Defer.run`` on
    both wires, counts zeroed just before each run and read just after,
    held against the whole-graph forward with bf16 weights and input.
    ``want_dtypes(wire, steps)`` is the launch count by kernel and dtype
    the run must show.

    Bounds: the buffer wire rounds where the forward does
    (BF16_BUFFER_REL_BOUND).  The int8 wire gets INT8_REL_BOUND plus the
    bf16 forward's own error against the f32 forward, measured here: its
    perturbations move every later bf16 rounding off the forward's, so
    the two can part by the int8 error plus the bf16 noise the forward
    itself carries."""
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig
    from defer_tpu_torch.graph.ir import tree_map

    g, inputs = mp["graph"], mp["inputs"]
    floating = g.input_spec.dtype.is_floating_point
    pdev16 = tree_map(lambda v: v.to(torch.bfloat16), mp["pdev"])
    with torch.inference_mode():
        ref16 = np.stack([g.apply(pdev16, torch.from_numpy(x).to(
            device, torch.bfloat16 if floating else g.input_spec.dtype))
            .float().cpu().numpy() for x in inputs])
    scale = float(np.abs(ref16).max())
    ref32 = mp["ref"]
    noise = float(np.abs(ref16 - ref32).max()) / float(np.abs(ref32).max())
    print(f"bf16 path {g.name}: the bf16 forward is {noise:.6g} of max "
          "|output| off the f32 forward", flush=True)
    res = {"launches": {}, "by_dtype": {}, "rel_err": {},
           "rel_err_vs_f32": {}, "config": mp["bf16"],
           "forward_bf16_rel_err_vs_f32": noise}
    for wire, bound in (("buffer", BF16_BUFFER_REL_BOUND),
                        ("int8", INT8_REL_BOUND + noise)):
        defer = Defer(DeferConfig(wire=wire, microbatch=MICROBATCH,
                                  chunk=CHUNK, device=device, **mp["bf16"]))
        zero_counts(kernels)
        out = defer.run(g, mp["params"], inputs, cut_points=mp["cuts"])
        torch.cuda.synchronize()
        launches, by_dtype = read_counts(kernels), read_dtypes(kernels)
        steps = mp["steps"]
        want = want_dtypes(wire, steps)
        print(f"bf16 path {g.name} {mp['bf16']}, wire={wire}: "
              f"{len(inputs)} microbatches = {steps} steps; kernel launches "
              f"by dtype {by_dtype}", flush=True)
        if by_dtype != want:
            fail(f"bf16 {g.name} wire={wire}: launches by dtype {by_dtype}, "
                 f"want {want}")
        if out.shape != ref16.shape or not np.isfinite(out).all():
            fail(f"bf16 {g.name} {wire} output shape {out.shape} or not "
                 "finite")
        err = float(np.abs(out - ref16).max())
        mse = float(np.square(out - ref16).mean())
        err32 = float(np.abs(out - ref32).max()) / float(np.abs(ref32).max())
        top = ""
        if g.name.startswith("resnet"):
            agree = (f"{int((out.argmax(-1) == ref32.argmax(-1)).sum())}"
                     f"/{out.shape[0] * out.shape[1]}")
            top = f"; top-1 agree with the f32 forward {agree}"
            res.setdefault("top1_agree_vs_f32", {})[wire] = agree
        print(f"bf16 path {g.name} {wire} vs bf16 forward: max|err| "
              f"{err:.6g} = {err / scale:.6g} of max|output| {scale:.6g} "
              f"(bound {bound:.6g}), MSE {mse:.3g}; vs the f32 forward "
              f"{err32:.6g} (for information){top}", flush=True)
        if err > bound * scale:
            fail(f"bf16 {g.name} {wire}-wire error above its bound")
        res["launches"][wire] = launches
        res["by_dtype"][wire] = by_dtype
        res["rel_err"][wire] = err / scale
        res["rel_err_vs_f32"][wire] = err32
    return res


# ---------------------------------------------------------------------------
# phase 4e: reweight after capture
# ---------------------------------------------------------------------------


def reweight_after_capture(torch, device, mp):
    """Run the captured int8 deployment, ``reweight`` it with every param
    scaled by 0.5, run again: equal to a fresh pipeline on the new params
    (within GRAPH_REL_BOUND of max |output|), with no new capture."""
    import numpy as np

    from defer_tpu_torch.graph.ir import tree_map

    pipe = mp["defer"].build(mp["graph"], mp["params"], mp["cuts"])
    pipe.run(mp["inputs"])
    captures = pipe.metrics.captures
    half = tree_map(lambda v: v * 0.5, mp["params"])
    t0 = time.perf_counter()
    pipe.reweight(half)
    torch.cuda.synchronize()
    reweight_s = time.perf_counter() - t0
    out = pipe.run(mp["inputs"])
    fresh = mp["defer"].run(mp["graph"], half, mp["inputs"],
                            cut_points=mp["cuts"])
    err = float(np.abs(out - fresh).max()) / float(np.abs(fresh).max())
    print(f"reweight after capture ({mp['graph'].name} int8, params x 0.5, "
          f"{reweight_s * 1e3:.1f} ms): vs a fresh pipeline {err:.3g} of "
          f"max|output| (bound {GRAPH_REL_BOUND}); captures {captures} -> "
          f"{pipe.metrics.captures}", flush=True)
    if err > GRAPH_REL_BOUND:
        fail("reweight: outputs differ from a fresh pipeline")
    if pipe.metrics.captures != captures:
        fail("reweight: the engine captured again")
    return {"rel_err": err, "captures": pipe.metrics.captures,
            "reweight_s": reweight_s}


# ---------------------------------------------------------------------------
# phase 4f: run_defer
# ---------------------------------------------------------------------------


def run_defer_path(torch, device, kernels, mp):
    """ResNet50's bf16 int8 deployment as a queue service: 2*CHUNK+3
    microbatches, then END_OF_STREAM; outputs in order, equal to
    ``Defer.run`` on the same inputs."""
    import queue

    import numpy as np

    from defer_tpu_torch import END_OF_STREAM, Defer, DeferConfig
    from defer_tpu_torch.obs import REGISTRY

    m = 2 * CHUNK + 3
    xs = np.random.default_rng(SEED + 1).standard_normal(
        (m, MICROBATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    defer = Defer(DeferConfig(wire="int8", microbatch=MICROBATCH,
                              chunk=CHUNK, device=device, **mp["bf16"]))
    dispatches = REGISTRY.counter("dispatcher.dispatches")
    d0 = dispatches.n
    in_q, out_q = queue.Queue(), queue.Queue()
    zero_counts(kernels)
    t0 = time.perf_counter()
    h = defer.run_defer(mp["graph"], mp["params"], mp["cuts"], in_q, out_q)
    for x in xs:
        in_q.put(x)
    in_q.put(END_OF_STREAM)
    h.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_dtype = read_counts(kernels), read_dtypes(kernels)
    if h._thread.is_alive():
        fail("run_defer: the serve thread did not finish")
    outs = [out_q.get_nowait() for _ in range(out_q.qsize())]
    if len(outs) != m or any(o is END_OF_STREAM for o in outs):
        fail(f"run_defer: {len(outs)} outputs for {m} inputs")
    got = np.stack(outs)
    want = defer.run(mp["graph"], mp["params"], xs, cut_points=mp["cuts"])
    diff = float(np.abs(got - want).max())
    moved = dispatches.n - d0
    print(f"run_defer {mp['graph'].name} int8 {mp['bf16']}: {m} "
          f"microbatches in {wall:.2f} s (build and capture included), "
          f"{h.metrics.chunk_calls} pushes of {CHUNK} steps; max|diff| vs "
          f"Defer.run {diff:.3g}; healthy {h.healthy}; dispatcher."
          f"dispatches +{moved}; kernel launches {launches}, by dtype "
          f"{by_dtype}", flush=True)
    if diff != 0.0:
        fail("run_defer outputs differ from Defer.run")
    if not h.healthy or moved == 0:
        fail("run_defer: unhealthy, or no dispatch counted")
    return {"microbatches": m, "max_abs_diff": diff, "dispatches": moved,
            "launches": launches, "by_dtype": by_dtype, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 4g: GPT-2 small — decoding, prefill, scoring, speculative decoding
# ---------------------------------------------------------------------------

#: one block per stage; 12 groups of MICROBATCH sequences fill the ring
GPT_STAGES = 12
GPT_MAX_LEN = 256
#: [sequences, prompt length] from numpy seed SEED: one fill of the ring
GPT_PROMPTS = (96, 32)
#: new tokens of the decode-rate checks, halved twice to keep the smoke in
#: its budget (the decoder's generate calls are most of 4g; PERF.md §4)
GPT_NEW = 16
#: shorter generations for the graph/eager, reweight, beam and speculative
#: checks, halved twice to keep the smoke in its budget (PERF.md §4)
GPT_SHORT_NEW = 4
#: prefill tokens may part from decode-rate ones only at or after a
#: position whose reference top-2 logit gap is below this share of max
#: |logit| (float reduction order can flip a near tie)
TIE_REL = 1e-4
#: prefill's K/V rows against decode-rate teacher forcing, f32
PREFILL_CACHE_REL = 1e-5
#: Defer.score, buffer wire, against the whole-graph forward
SCORE_RTOL = 1e-4
#: [sequences, length] Defer.score runs at (bucket 128)
SCORE_IDS = (16, 100)
GPT_ROUNDS = 1
DECODE_GROUPS = {"matmul (cuBLAS)": ("gemm", "Gemm", "cutlass", "nvjet"),
                 "softmax": ("softmax", "Softmax"),
                 "index/copy": ("index", "copy", "Copy", "gather", "cat"),
                 "reductions": ("reduce", "Reduce")}


def incremental_greedy(torch, graph, params, prompt, t_tok, max_len, *,
                       dtype, kv_int8=False):
    """The port's counterpart of ``incremental_greedy`` in
    tests/test_decode.py: one group of sequences at a time, eagerly on the
    card, through the same ``embed_at``/``decode`` ops, with its own
    head-major caches.  ``params`` are device tensors in ``dtype``.
    Returns the tokens [b, t_tok] and, for every generated position, the
    top-2 logit gap and max |logit| of the logits that chose it."""
    import numpy as np

    nodes = graph.nodes
    blocks = [nm for nm in graph.topo_order if nm.startswith("block_")]
    op0 = nodes[blocks[0]].op
    d = nodes[blocks[0]].out_spec.shape[-1]
    b, plen = prompt.shape
    device = params["lm_head"]["w"].device
    shape = (b, op0.kv_heads, max_len + 1, d // op0.num_heads)
    cdt = torch.int8 if kv_int8 else dtype
    caches = {nm: [torch.zeros(shape, dtype=cdt, device=device)
                   for _ in range(2)] for nm in blocks}
    if kv_int8:
        for nm in blocks:
            caches[nm] += [torch.zeros(shape[:-1], device=device)
                           for _ in range(2)]
    out = np.zeros((b, t_tok), np.int64)
    out[:, :plen] = prompt
    gap = np.full((b, t_tok), np.inf)
    lmax = np.zeros((b, t_tok))
    with torch.inference_mode():
        for p in range(t_tok - 1):
            tok = torch.from_numpy(out[:, p]).to(device)
            x = nodes["embeddings"].op.embed_at(params["embeddings"], tok,
                                                p).to(dtype)
            for nm in blocks:
                k, v, *scales = caches[nm]
                x = nodes[nm].op.decode(params[nm], x, k, v, p, *scales)[0]
            h = nodes["final_ln"].op.apply(params["final_ln"], x)
            logits = nodes["lm_head"].op.apply(params["lm_head"],
                                               h).to(torch.float32)
            if p + 1 >= plen:
                top2 = logits.topk(2, dim=-1).values
                out[:, p + 1] = logits.argmax(dim=-1).cpu().numpy()
                gap[:, p + 1] = (top2[:, 0] - top2[:, 1]).cpu().numpy()
                lmax[:, p + 1] = logits.abs().amax(dim=-1).cpu().numpy()
    return out, gap, lmax


def loop_groups(torch, graph, params, prompts, groups, new, **kw):
    """``incremental_greedy`` over the named groups of MICROBATCH rows,
    stacked in row order."""
    import numpy as np

    res = [incremental_greedy(torch, graph, params,
                              prompts[g * MICROBATCH:(g + 1) * MICROBATCH],
                              prompts.shape[1] + new, GPT_MAX_LEN, **kw)
           for g in groups]
    return tuple(np.concatenate(parts) for parts in zip(*res))


def timed_rounds(torch, fn, rounds=GPT_ROUNDS):
    """Host-clock seconds of ``fn()`` (ending in a synchronize), per
    round."""
    walls = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def gpt_decode(torch, device, kernels, card, gp):
    """Checks 1-6 of phase 4g on the PipelinedDecoder: decode rate against
    the eager loop, prefill, int8 cache, bf16, W8A16, beam search, graph
    against eager and reweight; throughput and time to first token."""
    import numpy as np

    from defer_tpu_torch.graph.ir import tree_map
    from defer_tpu_torch.runtime import flatbuf
    from defer_tpu_torch.runtime.decode import PipelinedDecoder

    g, params, pdev, prompts = gp["graph"], gp["params"], gp["pdev"], \
        gp["prompts"]
    n_seq, plen = prompts.shape
    t_tok = plen + GPT_NEW
    n_groups = n_seq // MICROBATCH

    def make(p=params, **kw):
        return PipelinedDecoder(g, p, num_stages=kw.pop("stages", GPT_STAGES),
                                microbatch=MICROBATCH, max_len=GPT_MAX_LEN,
                                device=device, **kw)

    res = {"launches": {}, "by_dtype": {}}
    # 1. decode rate, f32 buffer cache: the eager loop on every group
    dec = make()
    zero_counts(kernels)
    t0 = time.perf_counter()
    out = dec.generate(prompts, GPT_NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    res["launches"]["decode_f32"] = launches = read_counts(kernels)
    print(f"gpt2 decode: PipelinedDecoder(gpt2_small, {GPT_STAGES} stages, "
          f"microbatch {MICROBATCH}, max_len {GPT_MAX_LEN}), prompts "
          f"{GPT_PROMPTS}, {GPT_NEW} new tokens: first call {first_s:.3f} s "
          f"including {dec.captures} capture(s) of {dec.capture_s:.3f} s; "
          f"kernel launches {launches}, on {card}", flush=True)
    if launches["flash_attention"] != 0 or launches["quant_int8"] != 0:
        fail(f"gpt2 decode-rate steps launched {launches} (want no flash "
             "and no quantizer launch: decode attention is two matmuls)")
    ref, gap, lmax = loop_groups(torch, g, pdev, prompts, range(n_groups),
                                 GPT_NEW, dtype=torch.float32)
    if out.shape != (n_seq, t_tok) or not (out == ref).all():
        fail(f"gpt2 decode: {int((out != ref).sum())} tokens differ from "
             "the eager incremental loop")
    print(f"gpt2 decode f32: {out.size} tokens equal to the eager "
          f"incremental loop on all {n_groups} groups, on {card}", flush=True)

    k_rate = [c[..., :plen, :].clone() for c in dec.caches["k"]]
    v_rate = [c[..., :plen, :].clone() for c in dec.caches["v"]]

    # 2. the fused prefill: caches, tokens, flash launches
    zero_counts(kernels)
    pre = dec.generate(prompts, GPT_NEW, prefill=True)
    torch.cuda.synchronize()
    res["launches"]["prefill_f32"] = launches = read_counts(kernels)
    want_flash = len(dec.block_names) * n_groups
    kmax = max(float(c.abs().max()) for c in k_rate + v_rate)
    cache_err = max(float((a[..., :plen, :] - b_).abs().max())
                    for a, b_ in zip(dec.caches["k"] + dec.caches["v"],
                                     k_rate + v_rate)) / kmax
    tie = gap < TIE_REL * lmax          # [rows, positions]
    first_tie = np.where(tie.any(1), tie.argmax(1), t_tok)
    diff = pre != out
    first_diff = np.where(diff.any(1), diff.argmax(1), t_tok)
    bad = int((first_diff < first_tie).sum())
    print(f"gpt2 prefill: kernel launches {launches} (want "
          f"{want_flash} flash: {len(dec.block_names)} blocks x {n_groups} "
          f"groups; bubble stage-steps do not run); K/V rows 0..{plen - 1} "
          f"vs decode-rate teacher forcing {cache_err:.3g} of max |K, V| "
          f"(bound {PREFILL_CACHE_REL}); tokens equal to decode rate "
          f"{float((pre == out).mean()) * 100:.2f}%, near-tie positions "
          f"(gap < {TIE_REL} x max|logit|) {int(tie.sum())} in "
          f"{int(tie.any(1).sum())} rows, rows parting before a near tie "
          f"{bad}, on {card}", flush=True)
    if launches["flash_attention"] != want_flash:
        fail(f"gpt2 prefill: {launches['flash_attention']} flash launches, "
             f"want {want_flash}")
    if cache_err > PREFILL_CACHE_REL:
        fail("gpt2 prefill: K/V rows differ from decode-rate teacher forcing")
    if bad:
        fail(f"gpt2 prefill: {bad} rows differ from decode rate before any "
             "near tie")
    res.update(prefill_cache_rel_err=cache_err, near_ties=int(tie.sum()),
               prefill_token_agree=float((pre == out).mean()))
    # what phase 4t's decoder across processes is held to
    gp.update(prefill_tokens=pre, gap=gap, lmax=lmax)

    # time to first token and generated tokens/s (capture excluded: the
    # graphs exist by now)
    ttft = {}
    for label, kw in (("decode_rate", {}), ("prefill", {"prefill": True})):
        ttft[label] = statistics.median(timed_rounds(
            torch, lambda: dec.generate(prompts, 1, **kw)))
    walls = timed_rounds(torch, lambda: dec.generate(prompts, GPT_NEW))
    walls_pre = timed_rounds(torch, lambda: dec.generate(prompts, GPT_NEW,
                                                         prefill=True))
    tok = n_seq * GPT_NEW
    res.update(ttft_s=ttft, tokens_per_s=tok / statistics.median(walls),
               tokens_per_s_prefill=tok / statistics.median(walls_pre),
               spread=(max(walls) - min(walls)) / statistics.median(walls),
               capture_s=dec.capture_s, captures=dec.captures,
               graph_pool_bytes=dec.graph_pool_bytes,
               cache_bytes=sum(c.numel() * c.element_size()
                               for cs in dec.caches.values() for c in cs))
    print(f"gpt2 generate f32: {res['tokens_per_s']:.1f} generated tokens/s "
          f"(decode-rate prompts; {res['tokens_per_s_prefill']:.1f} with "
          f"prefill), median of {GPT_ROUNDS} rounds of {n_seq} x {GPT_NEW} "
          f"tokens, spread {res['spread'] * 100:.0f}%; time to first token "
          f"{ttft['decode_rate'] * 1e3:.1f} ms at decode rate, "
          f"{ttft['prefill'] * 1e3:.1f} ms with prefill; on {card}",
          flush=True)
    print(f"gpt2 capture: {dec.captures} graphs in {dec.capture_s:.3f} s "
          f"(excluded above); graph pool {dec.graph_pool_bytes / 2**20:.1f} "
          f"MiB, KV cache {res['cache_bytes'] / 2**20:.1f} MiB, on {card}",
          flush=True)

    # 3. int8 cache and bf16 compute against the loop with the same ops
    pdev16 = tree_map(lambda v: v.to(torch.bfloat16), pdev)
    outs = {}
    for name, kw, lp, ldt, kv8 in (
            ("int8_kv", {"kv_cache": "int8"}, pdev, torch.float32, True),
            ("bf16", {"compute_dtype": "bfloat16"}, pdev16, torch.bfloat16,
             False),
            ("w8a16_bf16", {"compute_dtype": "bfloat16",
                            "weight_dtype": "int8"}, None, torch.bfloat16,
             False)):
        d2 = make(**kw)
        if name == "w8a16_bf16":
            # 4. the int8 rows are the host's quantize_leaves
            for s in range(GPT_STAGES):
                _, leaves = flatbuf.flatten_leaves(
                    {nm: params[nm] for nm in d2._stage_param_names[s]})
                q, sc, _ = flatbuf.quantize_leaves(leaves, d2._wmeta[s])
                if not (torch.equal(d2._rows[s][0].cpu(), q)
                        and torch.equal(d2._rows[s][1].cpu(), sc)):
                    fail(f"W8A16 stage {s}: rows differ from "
                         "quantize_leaves")
            lp = {}
            for s in range(GPT_STAGES):  # the decoder's dequantized leaves
                lp.update(d2._stage_params(s))
        zero_counts(kernels)
        outs[name] = o = d2.generate(prompts, GPT_NEW)
        torch.cuda.synchronize()
        res["launches"][f"decode_{name}"] = read_counts(kernels)
        ref2 = loop_groups(torch, g, lp, prompts, (0, 1), GPT_NEW,
                           dtype=ldt, kv_int8=kv8)[0]
        if not (o[:2 * MICROBATCH] == ref2).all():
            fail(f"gpt2 {name}: tokens differ from the eager loop with the "
                 "same ops")
        base = outs["bf16"] if name == "w8a16_bf16" else out
        agree = float((o[:, plen:] == base[:, plen:]).mean())
        walls = timed_rounds(torch, lambda: d2.generate(prompts, GPT_NEW))
        res[f"{name}_token_agree"] = agree
        res[f"{name}_tokens_per_s"] = n_seq * GPT_NEW / statistics.median(
            walls)
        print(f"gpt2 {name}: tokens equal to the eager loop (same ops) on "
              f"groups 0-1; generated tokens equal to the "
              f"{'bf16' if name == 'w8a16_bf16' else 'f32 buffer'} run "
              f"{agree * 100:.2f}%; {res[f'{name}_tokens_per_s']:.1f} "
              f"generated tokens/s (median of {GPT_ROUNDS}); kernel launches "
              f"{res['launches'][f'decode_{name}']}, on {card}", flush=True)
        del d2

    # 5. beam search: width 4 at 4 stages (three blocks per stage)
    bp = prompts[:2 * 4]  # 4 groups x (8 rows / 4 beams) sequences
    db = make(stages=4, beam_width=4)
    if db.l_max != 3:
        fail(f"beam decoder: Lmax {db.l_max}, want 3")
    beam_g = db.generate(bp, GPT_SHORT_NEW)
    db.cuda_graphs = False
    beam_e = db.generate(bp, GPT_SHORT_NEW)
    w1 = make(stages=4, beam_width=1).generate(prompts[:4 * MICROBATCH],
                                               GPT_SHORT_NEW)
    print(f"gpt2 beam width 4 at 4 stages: graph equals eager "
          f"{bool((beam_g == beam_e).all())}; width 1 at 4 stages equals "
          f"the 12-stage greedy tokens "
          f"{bool((w1 == out[:4 * MICROBATCH, :plen + GPT_SHORT_NEW]).all())}"
          f", on {card}", flush=True)
    if not (beam_g == beam_e).all():
        fail("gpt2 beam: graph replay differs from the eager steps")
    if not (w1 == out[:4 * MICROBATCH, :plen + GPT_SHORT_NEW]).all():
        fail("gpt2 beam width 1 differs from greedy")
    del db

    # 6. graph replay against the eager steps, and reweight after capture
    short = dec.generate(prompts, GPT_SHORT_NEW)
    snap = {k: [c.clone() for c in cs] for k, cs in dec.caches.items()}
    graphs, dec.cuda_graphs = dec.cuda_graphs, False
    eager = dec.generate(prompts, GPT_SHORT_NEW)
    dec.cuda_graphs = graphs
    gerr = max(float((a - b_).abs().max()) / max(float(b_.abs().max()), 1e-30)
               for k in snap for a, b_ in zip(snap[k], dec.caches[k]))
    captures = dec.captures
    half = tree_map(lambda v: v * 0.5, params)
    t0 = time.perf_counter()
    dec.reweight(half)
    torch.cuda.synchronize()
    reweight_s = time.perf_counter() - t0
    rew = dec.generate(prompts, GPT_SHORT_NEW)
    fresh = make(half).generate(prompts, GPT_SHORT_NEW)
    print(f"gpt2 graph vs eager ({GPT_SHORT_NEW} tokens): tokens equal "
          f"{bool((short == eager).all())}, caches {gerr:.3g} of max |value| "
          f"(bound {GRAPH_REL_BOUND}); reweight after capture "
          f"({reweight_s * 1e3:.1f} ms): equal to a fresh decoder "
          f"{bool((rew == fresh).all())}, captures {captures} -> "
          f"{dec.captures}, on {card}", flush=True)
    if not (short == eager).all() or gerr > GRAPH_REL_BOUND:
        fail("gpt2: graph replay differs from the eager steps")
    if not (rew == fresh).all() or dec.captures != captures:
        fail("gpt2 reweight: differs from a fresh decoder, or captured again")
    dec.reweight(params)
    res.update(graph_vs_eager_cache_rel_err=gerr, reweight_s=reweight_s)
    return dec, res


def gpt_score(torch, device, kernels, card, gp):
    """Check 7: ``Defer.score`` on both wires against the whole-graph
    forward; launch counts; scored sequences/s."""
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig, models

    g, params, pdev = gp["graph"], gp["params"], gp["pdev"]
    vocab = g.nodes["lm_head"].out_spec.shape[-1]
    ids = np.random.default_rng(SEED + 2).integers(0, vocab, SCORE_IDS)
    b, t = SCORE_IDS
    bucket = max(8, 1 << (t - 1).bit_length())
    cuts = models.gpt_stage_cuts(GPT_STAGES, GPT_STAGES)
    padded = np.zeros((b, bucket), np.int32)
    padded[:, :t] = ids
    ref = []
    with torch.inference_mode():
        for lo in range(0, b, MICROBATCH):
            x = torch.from_numpy(padded[lo:lo + MICROBATCH]).to(device)
            logp = g.apply(pdev, x)[:, :t].float().log_softmax(dim=-1)
            tgt = torch.from_numpy(ids[lo:lo + MICROBATCH, 1:]).to(device)
            ref.append(logp[:, :-1].gather(-1, tgt[..., None])[..., 0]
                       .sum(-1).cpu().numpy())
    ref = np.concatenate(ref)
    m = b // MICROBATCH
    steps = CHUNK * -(-(m + GPT_STAGES - 1) // CHUNK)
    blocks = sum(nm.startswith("block_") for nm in g.topo_order)
    res = {"launches": {}, "rel_err": {}, "sequences_per_s": {},
           "bucket": bucket, "steps": steps}
    for wire in ("buffer", "int8"):
        defer = Defer(DeferConfig(wire=wire, microbatch=MICROBATCH,
                                  chunk=CHUNK, device=device))
        defer.score(g, params, ids, cut_points=cuts)  # build and capture
        zero_counts(kernels)
        lp, ppl = defer.score(g, params, ids, cut_points=cuts)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        want = {"flash_attention": blocks * steps,
                "quant_int8": steps if wire == "int8" else 0}
        err = float(np.abs(lp - ref).max() / np.abs(ref).max())
        walls = timed_rounds(torch, lambda: defer.score(
            g, params, ids, cut_points=cuts))
        res["launches"][wire] = launches
        res["rel_err"][wire] = err
        res["sequences_per_s"][wire] = b / statistics.median(walls)
        print(f"gpt2 score: Defer.score({SCORE_IDS} ids, bucket {bucket}, "
              f"gpt_stage_cuts({GPT_STAGES}, {GPT_STAGES}), chunk {CHUNK}, "
              f"wire={wire}) = {steps} steps; kernel launches {launches} "
              f"(want {want}); log-probs vs whole-graph forward max rel err "
              f"{err:.3g}{f' (bound {SCORE_RTOL})' if wire == 'buffer' else ''}"
              f"; {res['sequences_per_s'][wire]:.1f} scored sequences/s "
              f"(median of {GPT_ROUNDS}, spread "
              f"{(max(walls) - min(walls)) / statistics.median(walls) * 100:.0f}"
              f"%), on {card}", flush=True)
        if launches != want:
            fail(f"gpt2 score wire={wire}: launches {launches}, want {want}")
        if not np.isfinite(lp).all() or lp.shape != (b,) or \
                not np.isfinite(ppl).all():
            fail(f"gpt2 score wire={wire}: log-probs not finite or misshapen")
        if wire == "buffer" and not np.allclose(lp, ref, rtol=SCORE_RTOL,
                                                atol=0):
            fail("gpt2 score: buffer-wire log-probs differ from the forward")
        del defer
    return res


def gpt_speculative(torch, device, kernels, card, gp):
    """Check 8: greedy speculative decoding with a small seeded draft,
    token-exact against the target's greedy output by full recompute
    (each forward at the power-of-two bucket ``Defer.logits`` runs)."""
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig, models, \
        speculative_generate

    g, params, pdev = gp["graph"], gp["params"], gp["pdev"]
    vocab = g.nodes["lm_head"].out_spec.shape[-1]
    draft = models.gpt(2, 256, 4, GPT_MAX_LEN, vocab=vocab, name="gpt_draft")
    dparams = draft.init(torch.Generator().manual_seed(SEED + 1))
    prompt = gp["prompts"][:MICROBATCH]
    defer = Defer(DeferConfig(microbatch=MICROBATCH, chunk=CHUNK,
                              device=device))
    zero_counts(kernels)
    t0 = time.perf_counter()
    got, stats = speculative_generate(
        defer, g, params, draft, dparams, prompt, GPT_SHORT_NEW, gamma=4,
        cut_points=models.gpt_stage_cuts(GPT_STAGES, GPT_STAGES),
        draft_num_stages=2, return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    want = np.array(prompt, np.int64)
    with torch.inference_mode():
        for _ in range(GPT_SHORT_NEW):
            t = want.shape[1]
            bucket = min(max(8, 1 << (t - 1).bit_length()), GPT_MAX_LEN)
            x = np.zeros((len(want), bucket), np.int32)
            x[:, :t] = want
            logits = g.apply(pdev, torch.from_numpy(x).to(device))[:, t - 1]
            nxt = logits.argmax(dim=-1).cpu().numpy()
            want = np.concatenate([want, nxt[:, None]], axis=1)
    print(f"gpt2 speculative: gamma 4, a 2-block d=256 draft, {len(prompt)} "
          f"prompts, {GPT_SHORT_NEW} new tokens in {wall:.2f} s (pipelines "
          f"built and captured inside): token-exact vs the target's greedy "
          f"{bool((got == want).all())}; stats {stats}; kernel launches "
          f"{launches}, on {card}", flush=True)
    if not (got == want).all():
        fail("gpt2 speculative decoding differs from the target's greedy "
             "output")
    return {"stats": stats, "launches": launches, "wall_s": wall}


def profile_decode(torch, dec, card):
    """Device time by kernel over one replay of the decode unit (N steps,
    one token per group), and the idle share of that replay."""
    return profile_replay(torch, dec._graphs[("decode", False, None)],
                          dec.num_stages, card,
                          f"gpt2 decode, one replay ({dec.num_stages} "
                          "steps, one token per group)")


def profile_replay(torch, graph, n, card, label):
    """Device time by kernel over one replay of ``graph`` (``n`` steps),
    and the idle share of that replay with the profiler on and off."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = timed_rounds(torch, graph.replay)
    plain_wall_us = statistics.median(walls) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(r[0] for r in rows)
    if not total:
        print(f"profile {label}: no device time in the trace (not "
              "measured)")
        return None
    rows.sort(reverse=True)
    shares = dict.fromkeys(DECODE_GROUPS, 0.0)
    shares["everything else"] = 0.0
    for us, key, _ in rows:
        grp = next((k for k, ms in DECODE_GROUPS.items()
                    if any(m in key for m in ms)), "everything else")
        shares[grp] += us
    out = {"device_ms_per_step": total / 1e3 / n,
           "idle_share": max(0.0, 1 - total / wall_us),
           "idle_share_profiler_off": max(0.0, 1 - total / plain_wall_us),
           "kernels_per_step": sum(r[2] for r in rows) / n,
           "shares": {k: v / total for k, v in shares.items()}}
    print(f"profile {label}: device time {total / 1e3:.3f} ms = "
          f"{out['device_ms_per_step']:.4f} ms/step, "
          f"{out['kernels_per_step']:.0f} kernels/step, in a "
          f"{wall_us / 1e3:.3f} ms wall (device idle "
          f"{out['idle_share'] * 100:.1f}% profiler on; "
          f"{out['idle_share_profiler_off'] * 100:.1f}% of the "
          f"{plain_wall_us / 1e3:.3f} ms median wall with it off); "
          + ", ".join(f"{k} {v * 100:.1f}%" for k, v in out["shares"].items())
          + f"; on {card}", flush=True)
    for us, key, count in rows[:10]:
        print(f"  {us / total * 100:6.2f}%  {us / 1e3:9.3f} ms  x{count:<5d}"
              f" {key[:100]}")
    return out


def gpt_path(torch, device, kernels, card):
    """Phase 4g: GPT-2 small (seeded random weights) through the decoder,
    ``Defer.score`` and speculative decoding."""
    import numpy as np

    from defer_tpu_torch import models
    from defer_tpu_torch.utils.convert import params_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    g = models.gpt2_small(seq_len=GPT_MAX_LEN)
    params = g.init(torch.Generator().manual_seed(SEED))
    vocab = g.nodes["lm_head"].out_spec.shape[-1]
    gp = {"graph": g, "params": params,
          "pdev": params_to_device(params, device),
          "prompts": np.random.default_rng(SEED).integers(
              0, vocab, GPT_PROMPTS)}
    dec, res = gpt_decode(torch, device, kernels, card, gp)
    res["score"] = gpt_score(torch, device, kernels, card, gp)
    res["speculative"] = gpt_speculative(torch, device, kernels, card, gp)
    return dec, res, gp


# ---------------------------------------------------------------------------
# phase 4h: the rest of the BASELINE zoo, folded BatchNorm, the MoE family
# ---------------------------------------------------------------------------

#: (path, model factory, cut list, image size): BASELINE.md configs 2-4 at
#: the JAX package's benchmark sizes (benchmarks/run.py)
ZOO_PATHS = (("vgg19_4", "vgg19", "VGG19_4STAGE_CUTS", 224),
             ("inceptionv3_6", "inception_v3", "INCEPTION_6STAGE_CUTS", 299),
             ("mobilenetv2_2", "mobilenet_v2", "MOBILENETV2_2STAGE_CUTS",
              224))
#: alternating timed rounds of phase 4h's throughput rows
ZOO_ROUNDS = 1
ZOO_GROUPS = {"quant_int8": ("quant_int8",),
              # cuDNN's depthwise kernel on H100 (one launch per
              # DepthwiseConv2D node and step)
              "depthwise conv": ("depthwise", "Depthwise",
                                 "conv2d_c1_k1_nhwc"),
              "conv (cuDNN, incl. layout)": ("fprop", "cudnn", "conv", "Conv",
                                             "nchw", "nhwc", "Nchw", "Nhwc",
                                             "implicit", "winograd"),
              "matmul (cuBLAS)": ("gemm", "Gemm", "cutlass", "nvjet",
                                  "xmma"),
              "pooling": ("pool", "Pool"),
              "concat": ("CatArray", "cat_"),
              "ring roll": ("roll_cuda",)}
BF16_RING = dict(compute_dtype="bfloat16", buffer_dtype="bfloat16")


def free_card(torch) -> None:
    """Drop what the last path left on the card and restart the peak."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def zoo_rings():
    """``{path: (stages, MICROBATCH, int8 ring width)}`` of phase 4h's CNN
    paths, from ``buffer_footprint`` of their full-size graphs."""
    from defer_tpu_torch import models
    from defer_tpu_torch.partition import buffer_footprint, partition

    rings = {}
    for key, factory, cuts_name, size in ZOO_PATHS:
        stages = partition(getattr(models, factory)(image_size=size),
                           getattr(models, cuts_name))
        rings[key] = (len(stages), MICROBATCH, buffer_footprint(
            stages, microbatch=MICROBATCH, wire="int8")["buf_elems"])
    return rings


def cnn_path(torch, device, kernels, card, key, factory, cuts_name, size):
    """One CNN of phase 4h (seeded random weights, numpy inputs from SEED,
    microbatch MICROBATCH, chunk CHUNK, TF32 off) through ``Defer.run``:
    f32 on the int8 wire (one quantizer launch per step, no flash launch,
    within INT8_REL_BOUND of the whole-graph forward; top-1 equal wherever
    the forward's top-1 margin exceeds twice the measured error) and on
    the buffer wire (within BUFFER_REL_BOUND, no launch); bf16 on a bf16
    ring on both wires (``bf16_path``); graph replay against the eager
    loop; images/s; one bf16 int8 chunk profiled; device memory."""
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig, models
    from defer_tpu_torch.utils.convert import params_to_device

    free_card(torch)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = getattr(models, factory)(image_size=size)
    cuts = getattr(models, cuts_name)
    params = g.init(torch.Generator().manual_seed(SEED))
    n = len(cuts) + 1
    m = 2 * CHUNK
    inputs = np.random.default_rng(SEED).standard_normal(
        (m, MICROBATCH, size, size, 3)).astype(np.float32)
    steps = CHUNK * -(-(m + n - 1) // CHUNK)
    pdev = params_to_device(params, device)
    with torch.inference_mode():
        ref = np.stack([g.apply(pdev, torch.from_numpy(x).to(device))
                        .cpu().numpy() for x in inputs])
    if not np.isfinite(ref).all():
        fail(f"{key}: the forward is not finite")
    scale = float(np.abs(ref).max())
    res = {"model": g.name, "image_size": size, "stages": n, "cuts": cuts,
           "steps": steps, "launches": {}, "rel_err": {}}
    defer = None
    for wire, bound in (("int8", INT8_REL_BOUND),
                        ("buffer", BUFFER_REL_BOUND)):
        d = Defer(DeferConfig(wire=wire, microbatch=MICROBATCH, chunk=CHUNK,
                              device=device))
        zero_counts(kernels)
        out = d.run(g, params, inputs, cut_points=cuts)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        want = {"quant_int8": steps if wire == "int8" else 0,
                "flash_attention": 0}
        print(f"zoo {key}: Defer.run({g.name} {size}x{size}, {n} stages "
              f"{cuts}, wire={wire}, microbatch={MICROBATCH}, chunk={CHUNK})"
              f" on {m} microbatches = {steps} steps; kernel launches "
              f"{launches}", flush=True)
        if launches != want:
            fail(f"{key} wire={wire}: launches {launches}, want {want}")
        if out.shape != ref.shape or not np.isfinite(out).all():
            fail(f"{key} {wire} output shape {out.shape} (want {ref.shape}) "
                 "or not finite")
        err = float(np.abs(out - ref).max())
        top = ""
        if wire == "int8":
            srt = np.sort(ref, -1)
            margin = srt[..., -1] - srt[..., -2]
            agree = ref.argmax(-1) == out.argmax(-1)
            decisive = margin > 2 * err
            res["top1_agree"] = f"{int(agree.sum())}/{agree.size}"
            res["top1_agree_decisive"] = (f"{int(agree[decisive].sum())}/"
                                          f"{int(decisive.sum())}")
            top = (f"; top-1 agree {res['top1_agree']}, on the images whose "
                   f"top-1 margin exceeds 2 x max|err| "
                   f"{res['top1_agree_decisive']}; smallest margin "
                   f"{float(margin.min()):.6g}")
            defer = d
        print(f"zoo {key} {wire} wire vs whole-graph forward: max|err| "
              f"{err:.6g} = {err / scale:.6g} of max|logit| {scale:.6g} "
              f"(bound {bound}){top}", flush=True)
        if err > bound * scale:
            fail(f"{key} {wire}-wire error above its bound")
        if wire == "int8" and not agree[decisive].all():
            fail(f"{key}: the int8 wire changed a top-1 class whose margin "
                 "exceeds twice the error")
        res["launches"][wire] = launches
        res["rel_err"][wire] = err / scale
    mp = {"steps": steps, "defer": defer, "graph": g, "params": params,
          "inputs": inputs, "pdev": pdev, "cuts": cuts, "ref": ref,
          "bf16": BF16_RING}
    res["bf16"] = bf16_path(torch, device, kernels, mp, lambda wire, st: {
        "quant_int8": {"bfloat16": st} if wire == "int8" else {},
        "flash_attention": {}})
    res["graph_vs_eager"] = graph_vs_eager(torch, mp)
    res["images_per_s"] = throughput(torch, device, mp, card, "img",
                                     rounds=ZOO_ROUNDS)
    res["profile_bf16_int8"] = profile_step(
        torch, mp, ZOO_GROUPS, label="bf16 int8", defer=Defer(DeferConfig(
            wire="int8", microbatch=MICROBATCH, chunk=CHUNK, device=device,
            **BF16_RING)))
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"zoo {key}: torch.cuda.max_memory_allocated "
          f"{res['max_memory_allocated'] / 2**30:.2f} GiB since the path "
          f"began; graph pool of one f32 int8 pipeline "
          f"{res['graph_vs_eager']['graph_pool_bytes'] / 2**20:.1f} MiB, on "
          f"{card}", flush=True)
    return res


def randomized_bn(torch, graph, params, seed):
    """Non-trivial BatchNorm running statistics from numpy ``seed`` (as
    tests/test_optimize.py draws them), so folding has work to do."""
    import numpy as np

    from defer_tpu_torch.graph.ops import BatchNorm

    rng = np.random.default_rng(seed)
    out = dict(params)
    for name, node in graph.nodes.items():
        if isinstance(node.op, BatchNorm):
            c = node.out_spec.shape[-1]
            out[name] = {k: torch.from_numpy(v.astype(np.float32)) for k, v in
                         (("scale", rng.uniform(0.5, 1.5, c)),
                          ("bias", rng.normal(0, 0.2, c)),
                          ("mean", rng.normal(0, 0.5, c)),
                          ("var", rng.uniform(0.5, 2.0, c)))}
    return out


def fold_path(torch, device, kernels, card, key, graph, cuts, inputs):
    """``fold_batchnorm`` on a BatchNorm CNN with randomized statistics:
    the folded and the unfolded graph through ``Defer.run`` in bf16 on a
    bf16 ring, int8 wire, each held against the UNFOLDED f32 forward
    within INT8_REL_BOUND plus the bf16 forward's own error; then images/s
    of the two pipelines in alternating rounds, and one profiled chunk of
    each.  Recorded, not claimed."""
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig, fold_batchnorm
    from defer_tpu_torch.graph.ir import tree_map
    from defer_tpu_torch.utils.convert import params_to_device

    free_card(torch)
    params = randomized_bn(torch, graph, graph.init(
        torch.Generator().manual_seed(SEED)), SEED + 3)
    fg, fp, folded = fold_batchnorm(graph, params)
    n = len(cuts) + 1
    steps = CHUNK * -(-(len(inputs) + n - 1) // CHUNK)
    pdev = params_to_device(params, device)
    pdev16 = tree_map(lambda v: v.to(torch.bfloat16), pdev)
    with torch.inference_mode():
        ref32 = np.stack([graph.apply(pdev, torch.from_numpy(x).to(device))
                          .cpu().numpy() for x in inputs])
        ref16 = np.stack([graph.apply(pdev16, torch.from_numpy(x).to(
            device, torch.bfloat16)).float().cpu().numpy() for x in inputs])
    scale = float(np.abs(ref32).max())
    noise = float(np.abs(ref16 - ref32).max()) / scale
    bound = INT8_REL_BOUND + noise
    print(f"fold {key}: fold_batchnorm folded {folded} BatchNorm nodes "
          f"({len(graph.nodes)} -> {len(fg.nodes)} nodes); the unfolded "
          f"bf16 forward is {noise:.6g} of max|logit| off the f32 one",
          flush=True)
    res = {"folded": folded, "nodes": [len(graph.nodes), len(fg.nodes)],
           "forward_bf16_rel_err_vs_f32": noise, "rel_err_vs_f32": {},
           "by_dtype": {}}
    variants = {"unfolded": (graph, params), "folded": (fg, fp)}
    want = {"quant_int8": {"bfloat16": steps}, "flash_attention": {}}
    for label, (gg, pp) in variants.items():
        d = Defer(DeferConfig(wire="int8", microbatch=MICROBATCH,
                              chunk=CHUNK, device=device, **BF16_RING))
        zero_counts(kernels)
        out = d.run(gg, pp, inputs, cut_points=cuts)
        torch.cuda.synchronize()
        by_dtype = read_dtypes(kernels)
        err = float(np.abs(out - ref32).max()) / scale
        agree = (f"{int((out.argmax(-1) == ref32.argmax(-1)).sum())}/"
                 f"{out.shape[0] * out.shape[1]}")
        print(f"fold {key} {label} bf16 int8: {steps} steps, launches by "
              f"dtype {by_dtype}; vs the unfolded f32 forward {err:.6g} of "
              f"max|logit| (bound {bound:.6g}); top-1 agree {agree}",
              flush=True)
        if by_dtype != want:
            fail(f"fold {key} {label}: launches by dtype {by_dtype}, want "
                 f"{want}")
        if not np.isfinite(out).all() or err > bound:
            fail(f"fold {key} {label}: error above its bound or not finite")
        res["rel_err_vs_f32"][label] = err
        res["by_dtype"][label] = by_dtype
        res[f"top1_agree_{label}"] = agree
    # images/s: the two pipelines in alternating rounds
    pushes, walls = {}, {}
    for label, (gg, pp) in variants.items():
        pipe = Defer(DeferConfig(wire="int8", microbatch=MICROBATCH,
                                 chunk=CHUNK, device=device,
                                 **BF16_RING)).build(gg, pp, cuts)
        xs = pipe.stage_inputs(inputs[:CHUNK])
        for _ in range(2):  # capture the chunk's graph, fill the ring
            pipe.push(xs)
        pushes[label], walls[label] = (lambda p=pipe, x=xs: p.push(x)), []
    for _ in range(2 * ZOO_ROUNDS):
        for label, fn in pushes.items():
            walls[label].extend(timed_rounds(torch, fn, rounds=1))
    res["images_per_s"] = {k: CHUNK * MICROBATCH / statistics.median(w)
                           for k, w in walls.items()}
    print(f"fold {key} bf16 int8 images/s on {card} (median of "
          f"{2 * ZOO_ROUNDS} alternating rounds of {CHUNK} steps): "
          + ", ".join(f"{k} {v:.1f}" for k, v in res["images_per_s"].items()),
          flush=True)
    del pushes
    res["profile"] = {label: profile_step(
        torch, {"graph": gg, "params": pp, "cuts": cuts, "inputs": inputs},
        ZOO_GROUPS, label=f"bf16 int8 {label}", defer=Defer(DeferConfig(
            wire="int8", microbatch=MICROBATCH, chunk=CHUNK, device=device,
            **BF16_RING))) for label, (gg, pp) in variants.items()}
    return res


def moe_path(torch, device, kernels, card):
    """``moe_tiny`` and ``moe_branched_tiny`` at ``moe_stage_cuts(2)``
    through ``Defer.run`` on both wires: flash launches = blocks x steps,
    one quantizer launch per int8 step, the output within the wire's bound
    of the whole-graph forward."""
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig, models
    from defer_tpu_torch.utils.convert import params_to_device

    free_card(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for factory in ("moe_tiny", "moe_branched_tiny"):
        g = getattr(models, factory)()
        params = g.init(torch.Generator().manual_seed(SEED))
        cuts = models.moe_stage_cuts(2)
        n = len(cuts) + 1
        blocks = sum(nm.startswith("block_") for nm in g.topo_order)
        m = 2 * CHUNK
        vocab = g.nodes["embeddings"].op.vocab
        seq = g.input_spec.shape[0]
        ids = np.random.default_rng(SEED).integers(
            0, vocab, (m, MICROBATCH, seq)).astype(np.float32)
        steps = CHUNK * -(-(m + n - 1) // CHUNK)
        pdev = params_to_device(params, device)
        with torch.inference_mode():
            ref = np.stack([g.apply(pdev, torch.from_numpy(x).to(
                device, torch.int32)).cpu().numpy() for x in ids])
        scale = float(np.abs(ref).max())
        res[factory] = {"launches": {}, "rel_err": {}, "steps": steps}
        for wire, bound in (("buffer", BUFFER_REL_BOUND),
                            ("int8", INT8_REL_BOUND)):
            d = Defer(DeferConfig(wire=wire, microbatch=MICROBATCH,
                                  chunk=CHUNK, device=device))
            zero_counts(kernels)
            out = d.run(g, params, ids, cut_points=cuts)
            torch.cuda.synchronize()
            launches = read_counts(kernels)
            want = {"flash_attention": blocks * steps,
                    "quant_int8": steps if wire == "int8" else 0}
            err = float(np.abs(out - ref).max())
            print(f"moe {factory}: Defer.run({n} stages {cuts}, wire={wire}, "
                  f"microbatch={MICROBATCH}, chunk={CHUNK}) = {steps} steps; "
                  f"kernel launches {launches} (want {want}); vs the forward "
                  f"{err / scale:.6g} of max|output| (bound {bound}), on "
                  f"{card}", flush=True)
            if launches != want:
                fail(f"moe {factory} wire={wire}: launches {launches}, want "
                     f"{want}")
            if out.shape != ref.shape or not np.isfinite(out).all() or \
                    err > bound * scale:
                fail(f"moe {factory} {wire}: output misshapen, not finite or "
                     "above its bound")
            res[factory]["launches"][wire] = launches
            res[factory]["rel_err"][wire] = err / scale
    return res


# ---------------------------------------------------------------------------
# phase 4i: weights and the host edge — checkpoints, the wire codecs, the
# native staging ring and Defer.serve_endpoint
# ---------------------------------------------------------------------------

#: images each endpoint client streams, as [MICROBATCH, 224, 224, 3] frames
ENDPOINT_IMAGES = 64
#: alternating timed rounds of the endpoint against the pipeline's run
ENDPOINT_ROUNDS = 1
#: the raw-reply endpoint against Defer.run: the same graph replays on the
#: same inputs, so 0 is expected
ENDPOINT_RAW_REL_BOUND = 1e-6


def host_build():
    """Build the host C++ (``csrc/codec.cpp``, ``csrc/staging.cpp``) with
    g++ into ``_build/``; fail unless both load and are native."""
    from defer_tpu_torch.codec import (BlockFloatCodec, LosslessCodec,
                                       native_available)
    from defer_tpu_torch.ops import _build
    from defer_tpu_torch.transport.staging import HostStagingRing

    res = {}
    for src in ("codec.cpp", "staging.cpp"):
        try:
            info = _build.build_host(src)
        except RuntimeError as e:
            fail(f"host build of {src}: {e}")
        res[src] = info["seconds"]
        print(f"build {src} (g++): {info['seconds']:.2f} s -> "
              f"{info['path'].name}", flush=True)
    if not native_available():
        fail("the native codec library did not load")
    if BlockFloatCodec()._lib is None or LosslessCodec()._lib is None:
        fail("a codec reports that it is not native")
    if not HostStagingRing(8, 4).is_native:
        fail("the staging ring reports that it is not native")
    return res


def torchvision_state_dict(torch, params):
    """ResNet50's parameters in torchvision's layout: conv weights are
    OIHW in the port already, BatchNorm leaves renamed, ``fc.weight`` the
    transpose of the Dense ``[in, out]`` weight."""
    from defer_tpu_torch.utils.pretrained import resnet50_torch_mapping

    sd = {}
    for (node, leaf), (src, tf) in resnet50_torch_mapping().items():
        v = params[node][leaf].detach().cpu()
        sd[src] = (v.t() if tf.__name__ == "_fc_t" else v).contiguous()
    return sd


def same_leaves(torch, got, want) -> bool:
    from defer_tpu_torch.graph.ir import flatten_tree

    if got.keys() != want.keys():
        return False
    for node in want:
        a, b = flatten_tree(got[node]), flatten_tree(want[node])
        if a.keys() != b.keys():
            return False
        for k in a:
            x, y = a[k].contiguous(), b[k].contiguous()
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                    x.view(torch.int32), y.view(torch.int32)):
                return False
    return True


def stream_clients(address, frames: dict, timeout_s: float = 300):
    """One ``TensorClient.infer_stream`` per entry of ``frames``, all at
    once; returns ``({name: replies}, wall seconds)``."""
    import threading

    from defer_tpu_torch.transport.framed import TensorClient

    outs, errs = {}, []

    def go(name):
        try:
            c = TensorClient(*address, timeout_s=timeout_s)
            outs[name] = c.infer_stream(frames[name])
            c.close()
        except Exception as e:  # noqa: BLE001 — failed below
            errs.append(f"{name}: {e!r}")

    ts = [threading.Thread(target=go, args=(k,), daemon=True) for k in frames]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout_s)
    wall = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in ts):
        fail(f"endpoint clients failed: {errs or 'a client hung'}")
    return outs, wall


def endpoint_path(torch, device, kernels, card, mp, prof16):
    """Phase 4i on ResNet50/8 (bf16 compute on a bf16 ring, int8 wire,
    microbatch MICROBATCH, chunk CHUNK): weights written as a torchvision
    ``.pt`` and loaded with ``load_pretrained``, round-tripped through
    ``save_params``/``load_params`` (npz, JAX layout) and ``.pt``; then
    ``serve_endpoint(max_clients=2)`` on the loaded weights against two
    concurrent clients, raw and bf8 replies, held to ``Defer.run``; the
    quantizer's launches, the endpoint counters, ``reweight`` between
    clients; images/s beside the pipeline's run, wire bytes per image and
    the device's idle share."""
    import os
    import tempfile

    import numpy as np

    from defer_tpu_torch import (Defer, DeferConfig, load_params,
                                 load_params_pt, load_pretrained,
                                 save_params, save_params_pt)
    from defer_tpu_torch.graph.ir import tree_map
    from defer_tpu_torch.obs import REGISTRY

    free_card(torch)
    res = {"host_build_s": host_build(), "card": card}
    g, seeded, cuts = mp["graph"], mp["params"], mp["cuts"]
    defer = Defer(DeferConfig(wire="int8", microbatch=MICROBATCH,
                              chunk=CHUNK, device=device, **mp["bf16"]))
    inputs = mp["inputs"]
    want = defer.run(g, seeded, inputs, cut_points=cuts)

    # 1. weights: torchvision .pt, our npz, our .pt
    loads = {}
    with tempfile.TemporaryDirectory() as tmp:
        tv = os.path.join(tmp, "resnet50_torchvision.pt")
        torch.save(torchvision_state_dict(torch, seeded), tv)
        for name, path, save, load in (
                ("torchvision_pt", tv, None,
                 lambda p: load_pretrained("resnet50", p, g)),
                ("npz_jax_layout", os.path.join(tmp, "ckpt.npz"),
                 lambda p: save_params(p, seeded, g),
                 lambda p: load_params(p, g)),
                ("pt", os.path.join(tmp, "ckpt.pt"),
                 lambda p: save_params_pt(p, seeded),
                 lambda p: load_params_pt(p, g))):
            if save is not None:
                save(path)
            t0 = time.perf_counter()
            loaded = load(path)
            seconds = time.perf_counter() - t0
            size = os.path.getsize(path)
            if not same_leaves(torch, loaded, seeded):
                fail(f"weights from {name} are not bit-equal to the seeded "
                     "parameters")
            out = defer.run(g, loaded, inputs, cut_points=cuts)
            if not np.array_equal(out, want):
                fail(f"Defer.run on weights from {name} differs from the "
                     "seeded parameters' run")
            loads[name] = {"seconds": seconds, "bytes": size}
            print(f"weights {name}: {size / 1e6:.1f} MB loaded in "
                  f"{seconds:.3f} s, every leaf bit-equal to the seeded "
                  f"parameters, Defer.run equal; on {card}", flush=True)
            if save is None:
                served = loaded  # the endpoint serves the torchvision load
    res["load"] = loads

    # 2. the endpoint: two concurrent clients, raw then bf8 replies
    rng = np.random.default_rng(SEED)
    per = ENDPOINT_IMAGES // MICROBATCH
    frames = {c: [rng.standard_normal((MICROBATCH, IMAGE_SIZE, IMAGE_SIZE,
                                       3)).astype(np.float32)
                  for _ in range(per)] for c in ("a", "b")}
    runs = {c: defer.run(g, seeded, np.stack(v), cut_points=cuts)
            for c, v in frames.items()}
    ep_in = REGISTRY.counter("endpoint.samples_in")
    ep_out = REGISTRY.counter("endpoint.samples_out")
    tx = REGISTRY.counter("transport.tx_bytes")
    # the request frames' bytes (clients send raw f32), to part the
    # replies' share of transport.tx_bytes
    from defer_tpu_torch.transport.framed import _HDR
    req_frame = _HDR.size + 3 + 3 + 8 * 4 + frames["a"][0].nbytes
    images = 2 * ENDPOINT_IMAGES
    res["clients"] = {}
    for codec in ("raw", "bf8"):
        address, thread = defer.serve_endpoint(
            g, served, cut_points=cuts, codec=codec, max_clients=2)
        pipe = thread.pipeline
        steps0, n_in, n_out, tx0 = (pipe.metrics.steps, ep_in.n, ep_out.n,
                                    tx.n)
        zero_counts(kernels)
        outs, wall = stream_clients(address, frames)
        thread.join(timeout=300)
        torch.cuda.synchronize()
        launches, by_dtype = read_counts(kernels), read_dtypes(kernels)
        steps = pipe.metrics.steps - steps0
        if thread.is_alive() or thread.errors:
            fail(f"endpoint ({codec}): thread alive {thread.is_alive()}, "
                 f"errors {thread.errors}")
        if launches["quant_int8"] != steps or launches["flash_attention"]:
            fail(f"endpoint ({codec}): launches {launches} in {steps} steps "
                 "(want one quantizer launch per step, no flash)")
        if (ep_in.n - n_in, ep_out.n - n_out) != (images, images):
            fail(f"endpoint ({codec}): samples_in {ep_in.n - n_in}, "
                 f"samples_out {ep_out.n - n_out}, want {images} each")
        errs = {}
        for c in frames:
            got = np.stack(outs[c])
            if got.shape != runs[c].shape or not np.isfinite(got).all():
                fail(f"endpoint ({codec}) client {c}: shape {got.shape} or "
                     "not finite")
            err = np.abs(got - runs[c]).max(axis=(1, 2))
            scale = np.abs(runs[c]).max(axis=(1, 2))
            if codec == "raw":
                ok = err.max() <= ENDPOINT_RAW_REL_BOUND * scale.max()
            else:  # blockfloat, 8 bits: one reply frame is one block
                ok = (err <= scale / 127).all()
            errs[c] = float((err / scale).max())
            if not ok:
                fail(f"endpoint ({codec}) client {c}: rows off Defer.run "
                     f"by {errs[c]:.3g} of their max")
        wire = tx.n - tx0
        res["clients"][codec] = {
            "steps": steps, "launches": launches, "by_dtype": by_dtype,
            "rel_err_vs_run": errs, "wall_s": wall,
            "tx_bytes_per_image": wire / images,
            "reply_bytes_per_image": (wire - 2 * per * req_frame) / images}
        print(f"endpoint ResNet50/8 bf16 int8, {codec} replies: 2 clients x "
              f"{ENDPOINT_IMAGES} images in {wall:.3f} s, {steps} steps, "
              f"kernel launches {launches} by dtype {by_dtype}; rows vs "
              f"Defer.run {errs} of their max; samples_in/out "
              f"{images}/{images}; END echoed to both; transport.tx_bytes "
              f"{wire / images:.1f} per image (replies "
              f"{(wire - 2 * per * req_frame) / images:.1f}); on {card}",
              flush=True)
        if codec == "raw":
            res["launches"] = launches
            res["by_dtype"] = by_dtype

    # 3. reweight between two clients: new weights, then the seeded ones
    address, thread = defer.serve_endpoint(g, served, cut_points=cuts,
                                           max_clients=2)
    half = tree_map(lambda v: v * 0.5, seeded)
    few = {"a": frames["a"][:2]}
    thread.reweight(half)
    first, _ = stream_clients(address, few)
    thread.reweight(seeded)
    second, _ = stream_clients(address, few)
    thread.join(timeout=300)
    want_half = defer.run(g, half, np.stack(few["a"]), cut_points=cuts)
    if not (np.array_equal(np.stack(first["a"]), want_half)
            and np.array_equal(np.stack(second["a"]), runs["a"][:2])
            and not thread.errors):
        fail("endpoint reweight: outputs did not follow the new weights")
    print("endpoint reweight: a client after reweight(params x 0.5) equals "
          "Defer.run on them, and one after reweight(seeded) equals the "
          "seeded run", flush=True)

    # 4. images/s: the endpoint (two concurrent clients) against the same
    # deployment's pipeline run on the same images (built once, as
    # Defer.run runs it), in alternating rounds
    address, thread = defer.serve_endpoint(
        g, served, cut_points=cuts, max_clients=2 * ENDPOINT_ROUNDS + 2)
    pipe = defer.build(g, served, cuts)
    stacked = np.concatenate([np.stack(frames["a"]), np.stack(frames["b"])])
    pipe.run(stacked)  # capture
    walls = {"endpoint": [], "run": []}
    chunks = []
    for _ in range(ENDPOINT_ROUNDS):
        steps0 = thread.pipeline.metrics.steps
        _, wall = stream_clients(address, frames)
        walls["endpoint"].append(wall)
        chunks.append((thread.pipeline.metrics.steps - steps0) // CHUNK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run(stacked)
        walls["run"].append(time.perf_counter() - t0)
    # one more round, traced: the serve loop's pushes (``spmd.push`` spans,
    # real rows or bubbles) against the round's wall
    from defer_tpu_torch.obs import enable_tracing
    tr = enable_tracing()
    tr.clear()
    _, wall = stream_clients(address, frames)
    tr.enabled = False
    pushes = [sp for sp in tr.spans if sp["name"] == "spmd.push"]
    tr.clear()
    thread.join(timeout=300)
    real = [sp for sp in pushes if sp["args"]["n_real"] > 0]
    last = max(sp["ts_us"] for sp in real)
    trace = {"wall_s": wall, "pushes": len(pushes),
             "bubble_pushes": len(pushes) - len(real),
             "bubble_pushes_after_last_input": sum(
                 sp["ts_us"] > last for sp in pushes),
             "push_s": sum(sp["dur_us"] for sp in pushes) / 1e6,
             "first_to_last_push_s": (max(sp["ts_us"] + sp["dur_us"]
                                          for sp in pushes)
                                      - min(sp["ts_us"] for sp in pushes))
             / 1e6}
    res["traced_round"] = trace
    print(f"endpoint traced round: wall {wall:.3f} s; {trace['pushes']} "
          f"pushes ({trace['bubble_pushes']} all-bubble, "
          f"{trace['bubble_pushes_after_last_input']} after the last real "
          f"input, each after a 0.25 s empty-ring wait), {trace['push_s']:.3f}"
          f" s inside push, first push to last "
          f"{trace['first_to_last_push_s']:.3f} s; on {card}", flush=True)
    rates = {k: images / statistics.median(w) for k, w in walls.items()}
    spread = {k: (max(w) - min(w)) / statistics.median(w)
              for k, w in walls.items()}
    res["images_per_s"] = rates
    res["images_per_s_spread"] = spread
    idle = None
    if prof16 is not None:
        # the profiled chunk's device time against the endpoint's wall per
        # chunk, with the profiler off
        busy = prof16["device_ms_per_step"] * CHUNK / 1e3
        k = walls["endpoint"].index(statistics.median(walls["endpoint"]))
        idle = max(0.0, 1 - busy * chunks[k] / walls["endpoint"][k])
    res["idle_share_profiler_off"] = idle
    print(f"endpoint throughput ResNet50/8 bf16 int8 (2 clients x "
          f"{ENDPOINT_IMAGES} images, median of {ENDPOINT_ROUNDS} "
          f"alternating rounds): endpoint {rates['endpoint']:.1f} img/s "
          f"(spread {spread['endpoint'] * 100:.0f}%), the pipeline's run on "
          f"the same images {rates['run']:.1f} img/s (spread "
          f"{spread['run'] * 100:.0f}%); device idle "
          + ("not measured" if idle is None else f"{idle * 100:.1f}%")
          + f" of the endpoint's wall (profiler off; device time of the "
          f"phase 4d bf16 int8 chunk x {chunks} chunks); wire bytes per "
          f"image raw {res['clients']['raw']['tx_bytes_per_image']:.1f}, "
          f"bf8 {res['clients']['bf8']['tx_bytes_per_image']:.1f}; on "
          f"{card}", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 4j: the serving front door — GPT-2 small behind ServeFrontDoor
# ---------------------------------------------------------------------------

#: 12 stages (one block each), 32 KV slots, max_len 256, f32
SERVE_WIDTH = 32
#: (tenant, hello knobs): two at weight 1, one at weight 2, one at
#: priority 1 that samples
SERVE_TENANTS = (("alpha", {"weight": 1.0}), ("beta", {"weight": 1.0}),
                 ("gamma", {"weight": 2.0}),
                 ("delta", {"priority": 1, "temperature": 0.8, "seed": 11}))
#: prompts per tenant, their length range (numpy seed SEED), new tokens
SERVE_PROMPTS = 32
SERVE_LENS = (8, 64)
SERVE_NEW = {"alpha": 32, "beta": 32, "gamma": 32, "delta": 16}
SERVE_ROUNDS = 1
#: the open-loop round: seconds, and one 2x burst (t0, t1, multiplier)
SERVE_OPEN_S = 5.0
SERVE_BURST = (2.0, 3.0, 2.0)
#: the open-loop tenants' completion deadline (ms): an interactive SLO
SERVE_DEADLINE_MS = 2000.0


def _closed_round(address, prompts, order):
    """One closed-loop round: every tenant streams its prompts at once
    (tenants started in ``order``); returns ({tenant: [outcome]},
    {tenant: [latency s]}, wall s)."""
    import threading

    from defer_tpu_torch.serve import ServeClient

    outs, lats, errs = {}, {}, []
    knobs = dict(SERVE_TENANTS)

    def go(t):
        try:
            c = ServeClient(*address, t, max_new_tokens=SERVE_NEW[t],
                            timeout_s=300, **knobs[t])
            seqs = [c.submit(p) for p in prompts[t]]
            res = c.finish()
            outs[t] = [res.get(q) for q in seqs]
            lats[t] = [res[q][2] - c.sent_at[q] for q in seqs if q in res]
        except Exception as e:  # noqa: BLE001 — failed below
            errs.append(f"{t}: {e!r}")

    ts = [threading.Thread(target=go, args=(t,), daemon=True) for t in order]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in ts):
        fail(f"phase 4j closed-loop clients failed: {errs or 'a client hung'}")
    for t, o in outs.items():
        if any(r is None or r[0] != "ok" for r in o):
            fail(f"phase 4j: tenant {t} got a shed or no reply in a "
                 "closed-loop round")
    return outs, lats, wall


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else None


def _engine_state(eng):
    return ([(s.pos, list(s.out), s.last_id) if s is not None else None
             for s in eng._slots],
            [{k: c[k].clone() for k in ("k", "v")} for c in eng._caches])


def _restore_engine(eng, state):
    slots, caches = state
    for s, saved in zip(eng._slots, slots):
        if s is not None:
            s.pos, s.out, s.last_id = saved[0], list(saved[1]), saved[2]
    for c, saved in zip(eng._caches, caches):
        for k in ("k", "v"):
            c[k].copy_(saved[k])


def serve_path(torch, device, kernels, card):
    """Phase 4j: GPT-2 small (seeded random weights, 12 stages, width
    SERVE_WIDTH, f32) in a ``ContinuousBatchEngine`` behind a
    ``ServeFrontDoor`` on localhost; four tenants in closed-loop rounds
    and one open-loop round, then the six checks."""
    import threading

    import numpy as np

    from defer_tpu_torch import models
    from defer_tpu_torch.obs import REGISTRY
    from defer_tpu_torch.obs.events import recorder
    from defer_tpu_torch.serve import (ContinuousBatchEngine, DecodeRequest,
                                       LoadGenerator, ServeClient,
                                       ServeFrontDoor, poisson_trace)
    from defer_tpu_torch.serve.client import fetch_stats
    from defer_tpu_torch.utils.convert import params_to_device

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = models.gpt2_small(seq_len=GPT_MAX_LEN)
    pdev = params_to_device(g.init(torch.Generator().manual_seed(SEED)),
                            device)
    vocab = g.nodes["lm_head"].out_spec.shape[-1]
    rng = np.random.default_rng(SEED)
    prompts = {}
    for t, _ in SERVE_TENANTS:
        lens = rng.integers(SERVE_LENS[0], SERVE_LENS[1] + 1, SERVE_PROMPTS)
        prompts[t] = [rng.integers(0, vocab, int(n)).astype(np.int32)
                      for n in lens]
    tenants = [t for t, _ in SERVE_TENANTS]
    knobs = dict(SERVE_TENANTS)

    def engine():
        return ContinuousBatchEngine(g, pdev, num_stages=GPT_STAGES,
                                     width=SERVE_WIDTH, device=device)

    res = {"width": SERVE_WIDTH, "stages": GPT_STAGES,
           "max_len": GPT_MAX_LEN, "prompts_per_tenant": SERVE_PROMPTS,
           "prompt_lens": list(SERVE_LENS), "new_tokens": SERVE_NEW}
    zero_counts(kernels)
    t0 = time.perf_counter()
    eng = engine()
    res["build_s"] = time.perf_counter() - t0
    res["captures"] = eng.captures
    res["capture_s"] = eng.capture_s
    res["graph_pool_bytes"] = eng.graph_pool_bytes
    door = ServeFrontDoor(engine=eng,
                          decode_defaults={"max_new_tokens": 32}).start()
    address = door.address
    for name in ("step", "gather", "dispatch", "device", "sync",
                 "delivery"):
        REGISTRY.histogram(f"serve.decode.{name}_s").clear()

    # closed-loop rounds, the tenants' start order rotating round to round
    rounds = []
    gen_tokens = sum(SERVE_NEW[t] * SERVE_PROMPTS for t in tenants)
    slot_steps = sum(p.size + SERVE_NEW[t] - 1
                     for t in tenants for p in prompts[t])
    for r in range(SERVE_ROUNDS):
        order = tenants[r % 4:] + tenants[:r % 4]
        steps0 = eng.steps
        outs, lats, wall = _closed_round(address, prompts, order)
        steps = eng.steps - steps0
        rounds.append({"wall_s": wall, "steps": steps, "order": order,
                       "tokens_per_s": gen_tokens / wall,
                       "requests_per_s": len(tenants) * SERVE_PROMPTS / wall,
                       "occupancy": slot_steps / (steps * SERVE_WIDTH),
                       "p50_ms": {t: _pct(lats[t], 50) for t in tenants},
                       "p99_ms": {t: _pct(lats[t], 99) for t in tenants}})
        if r == 0:
            first = outs
        else:
            for t in tenants:
                for a, b in zip(outs[t], first[t]):
                    if not np.array_equal(a[1], b[1]):
                        fail(f"phase 4j: tenant {t}'s tokens changed between"
                             " closed-loop rounds")
    walls = [r["wall_s"] for r in rounds]
    mid = rounds[walls.index(statistics.median(walls))]
    res["closed"] = {"rounds": rounds, "median": mid,
                     "spread": (max(walls) - min(walls))
                     / statistics.median(walls)}
    res["phases_p50_ms"] = {
        name: REGISTRY.histogram(f"serve.decode.{name}_s").quantile(0.5)
        * 1e3 for name in ("step", "gather", "dispatch", "device", "sync",
                           "delivery")}
    print(f"serve closed loop GPT-2 small, 12 stages, width {SERVE_WIDTH}, "
          f"f32 (4 tenants x {SERVE_PROMPTS} prompts of {SERVE_LENS[0]}-"
          f"{SERVE_LENS[1]} tokens, {gen_tokens} generated tokens a round; "
          f"median of {SERVE_ROUNDS} rounds, start order rotating): "
          f"{mid['tokens_per_s']:.1f} generated tokens/s, "
          f"{mid['requests_per_s']:.2f} requests/s through the door, "
          f"{mid['wall_s']:.3f} s wall (spread "
          f"{res['closed']['spread'] * 100:.0f}%), {mid['steps']} engine "
          f"steps, mean slot occupancy {mid['occupancy'] * 100:.1f}%; "
          "latency p50/p99 ms "
          + ", ".join(f"{t} {mid['p50_ms'][t]:.1f}/{mid['p99_ms'][t]:.1f}"
                      for t in tenants)
          + f"; on {card}", flush=True)
    print("serve engine phases p50 ms (closed rounds): "
          + ", ".join(f"{k} {v:.4f}" for k, v in res["phases_p50_ms"].items())
          + f"; {eng.captures} captures in {eng.capture_s:.3f} s, graph pool "
          f"{eng.graph_pool_bytes / 2**20:.1f} MiB; on {card}", flush=True)

    # the open-loop round: one LoadGenerator per tenant (its own trace and
    # a deadline of its own), half the closed-loop request rate in all
    rate = mid["requests_per_s"] / 2 / len(tenants)
    gens, reps, errs = {}, {}, []
    for i, t in enumerate(tenants):
        c = ServeClient(*address, f"{t}_open", max_new_tokens=SERVE_NEW[t],
                        deadline_ms=SERVE_DEADLINE_MS, timeout_s=300,
                        **knobs[t])
        gens[t] = LoadGenerator(c, prompts[t], poisson_trace(
            rate, SERVE_OPEN_S, seed=SEED + i, bursts=[SERVE_BURST]))

    def go(t):
        try:
            reps[t] = gens[t].run()
        except Exception as e:  # noqa: BLE001 — failed below
            errs.append(f"{t}: {e!r}")

    steps0 = eng.steps
    ts = [threading.Thread(target=go, args=(t,), daemon=True)
          for t in tenants]
    t0 = time.perf_counter()
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=300)
    open_wall = time.perf_counter() - t0
    if errs or any(th.is_alive() for th in ts):
        fail(f"phase 4j open-loop clients failed: {errs or 'a client hung'}")
    done_tok = sum(reps[t]["completed"] * SERVE_NEW[t] for t in tenants)
    stats = fetch_stats(*address)
    res["open"] = {
        "rate_per_tenant_hz": rate, "seconds": SERVE_OPEN_S,
        "burst": list(SERVE_BURST), "deadline_ms": SERVE_DEADLINE_MS,
        "wall_s": open_wall, "steps": eng.steps - steps0,
        "tokens_per_s": done_tok / open_wall,
        "offered": {t: reps[t]["offered"] for t in tenants},
        "shed": {t: reps[t]["shed"] for t in tenants},
        "p50_ms": {t: reps[t]["latency_p50_ms"] for t in tenants},
        "p99_ms": {t: reps[t]["latency_p99_ms"] for t in tenants},
        "slo_attainment": {t: stats["tenants"][f"{t}_open"]["slo_attainment"]
                           for t in tenants}}
    o = res["open"]
    print(f"serve open loop ({rate:.2f} requests/s per tenant, Poisson, "
          f"{SERVE_OPEN_S:.0f} s with a {SERVE_BURST[2]:.0f}x burst over "
          f"{SERVE_BURST[0]:.0f}-{SERVE_BURST[1]:.0f} s, deadline "
          f"{SERVE_DEADLINE_MS:.0f} ms): {o['tokens_per_s']:.1f} generated "
          f"tokens/s over {open_wall:.3f} s, {o['steps']} steps; offered "
          f"{sum(o['offered'].values())}, shed {sum(o['shed'].values())}; "
          "latency p50/p99 ms "
          + ", ".join(f"{t} {o['p50_ms'][t]:.1f}/{o['p99_ms'][t]:.1f}"
                      for t in tenants)
          + f"; on {card}", flush=True)

    # check 3: a client that aborts mid-decode frees its slot; a tenant
    # streaming beside it gets the tokens it got in the closed rounds
    cursor = recorder().cursor()
    victim = ServeClient(*address, "victim", max_new_tokens=GPT_MAX_LEN - 8,
                         timeout_s=300)
    victim.submit(prompts["alpha"][0][:8])
    deadline = time.monotonic() + 60
    while eng.active() == 0:
        if time.monotonic() > deadline:
            fail("phase 4j: the aborting client's request never joined")
        time.sleep(0.001)
    victim.abort()
    steady = ServeClient(*address, "steady", max_new_tokens=SERVE_NEW["beta"],
                         timeout_s=300).stream(prompts["beta"][:4])
    for a, b in zip(steady, first["beta"][:4]):
        if a is None or a[0] != "ok" or not np.array_equal(a[1], b[1]):
            fail("phase 4j: a tenant's tokens changed beside a client that "
                 "aborted mid-decode")
    deadline = time.monotonic() + 60
    while eng.free_slots() != eng.width:
        if time.monotonic() > deadline:
            fail("phase 4j: the aborted client's slot was never reclaimed")
        time.sleep(0.01)
    _, evs = recorder().events_since(cursor)
    cancels = [e for e in evs if e["kind"] == "decode_cancel"]
    if not cancels:
        fail("phase 4j: the abort was not caught mid-decode (no "
             "decode_cancel event)")
    res["abort"] = {"cancel_events": len(cancels), "steady_equal": True}

    # check 5: the stats reply carries every tenant, completed = sent
    stats = fetch_stats(*address)
    for t in tenants:
        row = stats["tenants"].get(t)
        want = SERVE_ROUNDS * SERVE_PROMPTS
        if row is None or row["completed"] != want:
            fail(f"phase 4j: stats reply for {t}: {row} (completed should be "
                 f"{want})")
        row = stats["tenants"][f"{t}_open"]
        if row["completed"] + row["shed"] != reps[t]["offered"]:
            fail(f"phase 4j: stats reply for {t}_open: {row}")
    res["stats_decode"] = stats["decode"]
    door.stop()
    door.healthcheck()

    # check 1: two requests per tenant, alone through a fresh engine of
    # the same width (its own captures), give the door's bytes
    solo_eng = engine()
    picks = [(t, i) for t in tenants for i in (0, 1)]
    for t, i in picks:
        req = DecodeRequest(prompt=prompts[t][i],
                            max_new_tokens=SERVE_NEW[t], request_id=0,
                            seed=knobs[t].get("seed", 0),
                            temperature=knobs[t].get("temperature", 0.0))
        got = solo_eng.run_all([req])[0]
        if not np.array_equal(got, first[t][i][1]):
            fail(f"phase 4j: request {t}/{i} alone through a fresh engine "
                 "differs from its tokens in the shared batch")
    res["solo_identical"] = len(picks)

    # check 4: one replayed step against the same step run eagerly
    for t, i in picks[:SERVE_WIDTH]:
        solo_eng.join(DecodeRequest(
            prompt=prompts[t][i], max_new_tokens=SERVE_NEW[t],
            seed=knobs[t].get("seed", 0),
            temperature=knobs[t].get("temperature", 0.0)))
    for _ in range(4):
        solo_eng.step()
    state = _engine_state(solo_eng)
    solo_eng.step()
    torch.cuda.synchronize()
    ids_r = solo_eng._out_np.copy()
    caches_r = _engine_state(solo_eng)[1]
    _restore_engine(solo_eng, state)
    solo_eng.cuda_graphs = False
    solo_eng.step()
    solo_eng.cuda_graphs = True
    torch.cuda.synchronize()
    if not np.array_equal(ids_r, solo_eng._out_np):
        fail("phase 4j: the replayed step's ids differ from the eager step's")
    worst = 0.0
    for a, b in zip(caches_r, solo_eng._caches):
        for k in ("k", "v"):
            scale = b[k].abs().max().item() or 1.0
            worst = max(worst, (a[k] - b[k]).abs().max().item() / scale)
    if worst > GRAPH_REL_BOUND:
        fail(f"phase 4j: replayed caches {worst:.3g} of max |value| off the "
             f"eager step's (bound {GRAPH_REL_BOUND})")
    res["replay_vs_eager_cache_rel"] = worst

    # the device time of one step (replays back to back, CUDA events, no
    # profiler) against the step period of the median closed round
    res["device_ms"] = {
        mode: time_ms(torch, lambda s=s: solo_eng._graphs[s].replay(),
                      iters=20)
        for mode, s in (("greedy", False), ("sampled", True))}
    period_ms = mid["wall_s"] / mid["steps"] * 1e3
    res["step_period_ms"] = period_ms
    res["idle_share_profiler_off"] = max(
        0.0, 1 - res["device_ms"]["sampled"] / period_ms)
    res["profile_sampled_step"] = profile_replay(
        torch, solo_eng._graphs.get(True), 1, card,
        f"gpt2 serve engine, one sampled step (width {SERVE_WIDTH})")
    del solo_eng

    # check 2: four greedy requests against phase 4g's eager loop, up to
    # the first near tie
    ties = 0
    for t, i in (("alpha", 0), ("beta", 0), ("gamma", 0), ("alpha", 1)):
        p = prompts[t][i]
        t_tok = p.size + SERVE_NEW[t]
        ref, gap, lmax = incremental_greedy(
            torch, g, pdev, p[None].astype(np.int64), t_tok, GPT_MAX_LEN,
            dtype=torch.float32)
        got = first[t][i][1]
        near = np.flatnonzero(gap[0] < TIE_REL * lmax[0])
        upto = int(near[0]) if near.size else t_tok
        ties += bool(near.size)
        if not np.array_equal(got[:upto], ref[0, :upto]):
            fail(f"phase 4j: request {t}/{i} differs from the eager "
                 "incremental loop before any near tie")
    res["eager_loop_agree"] = 4
    res["eager_loop_near_ties"] = ties

    # check 6: the engine bypasses both kernels
    res["launches"] = read_counts(kernels)
    if any(res["launches"].values()):
        fail(f"phase 4j launched a kernel: {res['launches']}")
    res["seconds"] = time.perf_counter() - t_phase
    print(f"serve checks: 8 solo requests byte-identical, 4 greedy equal to "
          f"the eager loop ({ties} with a near tie), an abort mid-decode "
          f"reclaimed its slot ({len(cancels)} decode_cancel) with the "
          f"neighbour's tokens unchanged, replay = eager (caches "
          f"{worst:.3g} of max), stats complete, launches "
          f"{res['launches']}; device {res['device_ms']['greedy']:.4f} ms a "
          f"greedy step, {res['device_ms']['sampled']:.4f} ms sampled, "
          f"against a {period_ms:.4f} ms step period (device idle "
          f"{res['idle_share_profiler_off'] * 100:.1f}%, profiler off); "
          f"phase 4j {res['seconds']:.1f} s; on {card}", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 4k: the stage-node process chain
# ---------------------------------------------------------------------------

#: ResNet50/8 images through the process chain, in frames of MICROBATCH
CHAIN_IMAGES = 64
#: BERT-Base sequences through the in-process chain, in frames of MICROBATCH
CHAIN_SEQS = 16
#: images each of the two tenants sends through the tensor-mode door
DOOR_IMAGES = 16
#: alternating timed rounds of the chain's stream and the ring pipeline
CHAIN_ROUNDS = 1
#: frames of each timed stream: twice the stage count (32 until phase 4r
#: came; its seconds are paid for here), so a stream's rate includes its
#: fill and drain
CHAIN_TIMED_FRAMES = 16


def _rel_err(out, ref, what: str, bound: float, phase: str = "4k"
             ) -> float:
    import numpy as np

    if out.shape != ref.shape or not np.isfinite(out).all():
        fail(f"phase {phase} {what}: output shape {out.shape} (want "
             f"{ref.shape}) or not finite")
    rel = float(np.abs(out - ref).max()) / float(np.abs(ref).max())
    if rel > bound:
        fail(f"phase {phase} {what}: {rel:.3g} of max |output| off the "
             f"forward (bound {bound})")
    return rel


def _sum_launches(stats) -> dict:
    out: dict = {}
    for s in stats:
        for k, v in s["kernel_launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def trace_ahead(*work):
    """Trace stage programs on a thread while node processes boot (the
    smoke waits idle for their binds then): each of ``work`` is (stages,
    params), traced at MICROBATCH, and a later deploy of the same stages
    finds the programs kept (``defer_tpu_torch.utils.export``).  Returns
    the thread; a trace that fails is traced again, and raises, in the
    deploy that needs it."""
    import threading

    from defer_tpu_torch.utils.export import trace_stage

    def run():
        try:
            for stages, params in work:
                for s in stages:
                    trace_stage(s, params, batch=MICROBATCH)
        except Exception as e:  # noqa: BLE001 — the deploy raises it
            print(f"trace ahead: {e!r}", file=sys.stderr, flush=True)

    t = threading.Thread(target=run, daemon=True, name="chip-trace-ahead")
    t.start()
    return t


# ---------------------------------------------------------------------------
# phase 4p: the observability plane, on 4k's and 4n's chains
# ---------------------------------------------------------------------------

#: a profile window's dispatch + queue + device + host_sync sums tile its
#: infer sum within this relative error (tests/test_profile.py's bound)
PHASE_TILE_REL = 0.15
#: a node's MFU against ``flops / (infer p50 * peak)`` recomputed from its
#: own stats row: the row's p50 is rounded to the microsecond
MFU_REL = 1e-3
#: the flash kernel's name in a torch.profiler trace
FLASH_TRACE_NAME = "flash_attn_kernel"
#: seconds phase 4p's checks took, carved out of the phases they ride
OBS_SECONDS: list = []


class carved:
    """Times a stretch of phase ``name`` inside another phase: the watchdog
    names ``name`` while it runs and the seconds land in ``into``, which
    ``phase_done`` subtracts from the phase it ran in."""

    def __init__(self, name: str, into: list):
        self.name, self.into = name, into

    def __enter__(self):
        self.prev = WATCH.phase
        WATCH.enter(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        self.into.append(self.seconds)
        WATCH.phase = self.prev
        return False


def obs_phase() -> carved:
    """A stretch of phase 4p (its seconds land in OBS_SECONDS)."""
    return carved("4p", OBS_SECONDS)


def profile_window(addrs, fn, trace_dirs=None):
    """``profile_start`` on every node (one control connection each), run
    ``fn``, ``profile_stop``: (``fn``'s result, each node's report by
    address).  A refused start or stop fails the smoke."""
    from defer_tpu_torch.runtime.node import _parse_hostport
    from defer_tpu_torch.transport.framed import (K_CTRL, connect_retry,
                                                  recv_expect, send_ctrl,
                                                  send_end)
    conns, reports = {}, {}
    try:
        for a in addrs:
            s = conns[a] = connect_retry(*_parse_hostport(a), timeout_s=30)
            msg = {"cmd": "profile_start"}
            if trace_dirs and a in trace_dirs:
                msg["trace_dir"] = trace_dirs[a]
            send_ctrl(s, msg)
            rep = recv_expect(s, K_CTRL)
            if rep.get("cmd") != "profile_started":
                fail(f"phase 4p: profile_start on {a} refused: {rep}")
        out = fn()
        for a, s in conns.items():
            send_ctrl(s, {"cmd": "profile_stop"})
            rep = recv_expect(s, K_CTRL)
            if rep.get("cmd") != "profile_report":
                fail(f"phase 4p: profile_stop on {a} failed: {rep}")
            reports[a] = rep["report"]
            send_end(s)
    finally:
        for s in conns.values():
            s.close()
    return out, reports


def check_windows(torch, reports, frames: int, what: str) -> dict:
    """Each node's window: ``frames`` frames, the four phases tiling infer
    within PHASE_TILE_REL, no compilation, live bytes on the card below
    its memory.  Returns the per-node tiles and memory."""
    from defer_tpu_torch.obs import NODE_PHASES
    total = torch.cuda.get_device_properties(0).total_memory
    tiles, mem = {}, {}
    for a, rep in reports.items():
        ph = rep["phases"]
        inf = ph["infer"]["sum_s"]
        parts = sum(ph[k]["sum_s"] for k in NODE_PHASES)
        tile = parts / inf if inf > 0 else float("nan")
        tiles[rep["node"]], mem[rep["node"]] = tile, rep["mem_bytes"]
        if (ph["infer"]["count"] != frames
                or not abs(tile - 1.0) <= PHASE_TILE_REL
                or rep["recompiles"] != 0
                or not (rep["mem_bytes"] or 0) > 0
                or not rep["mem_bytes"] < total):
            fail(f"phase 4p {what}: node {rep['node']} window: infer count "
                 f"{ph['infer']['count']} (want {frames}), phases/infer "
                 f"{tile:.4f} (want within {PHASE_TILE_REL}), recompiles "
                 f"{rep['recompiles']} (want 0), mem_bytes "
                 f"{rep['mem_bytes']} (want in (0, {total}))")
    return {"phase_tiles": tiles, "mem_bytes": mem}


def obs_resnet(torch, chain, frames, want, card) -> dict:
    """Phase 4p a, on 4k's persistent ResNet50/8 chain (deployed with
    ``plan=``): clock offsets, one profiled stream of ``frames`` under the
    session's live view, the view's rows and bottleneck, every node's MFU
    recomputed from its stats row, and the ``obs`` entry of the plan."""
    import numpy as np

    from defer_tpu_torch.utils import hw

    disp, addrs = chain.dispatcher, chain.addrs
    res = {}
    with obs_phase() as ph:
        offs = disp.align_clocks(addrs)
        res["clock_offsets_us"] = [offs[a]["offset_us"] for a in addrs]
        res["clock_rtt_us"] = [offs[a]["rtt_us"] for a in addrs]
        print(f"obs path: align_clocks over {len(addrs)} node processes: "
              f"offsets us {[round(v, 1) for v in res['clock_offsets_us']]}"
              f", min rtt us {res['clock_rtt_us']}; on {card}", flush=True)
        out, reports = profile_window(
            addrs, lambda: np.stack(disp.stream(frames)))
        if not np.array_equal(out, want):
            fail("phase 4p: the profiled stream's rows differ from 4k's")
        time.sleep(2 * 0.25)  # two pushes past the stream's end
        rows = chain.view.rows()
        bott = chain.view.bottleneck()
        st = disp.stats(addrs)
        res.update(check_windows(torch, reports, len(frames),
                                 "resnet50 chain"))
        stages = sorted(r["stage"] for r in rows)
        if stages != list(range(len(addrs))):
            fail(f"phase 4p: the view's rows cover stages {stages}")
        p50 = [s["infer_latency_s"]["p50"] for s in st]
        peak = hw.peak_flops("h100")
        mfu = [s["mfu"] for s in st]
        want_mfu = [s["flops"] / (p * peak) for s, p in zip(st, p50)]
        if hw.identify_chip(torch.device("cuda")) != "h100" or any(
                m is None or not 0 < m <= 1
                or abs(m - w) > MFU_REL * w for m, w in zip(mfu, want_mfu)):
            fail(f"phase 4p: node MFU {mfu}, want {want_mfu} in (0, 1] "
                 f"(card generation {hw.identify_chip(torch.device('cuda'))})")
        obs = chain.obs()
        stats_out = st + [{"obs": obs}]
        if sorted(r["stage"] for r in stats_out[-1]["obs"]["rows"]) \
                != list(range(len(addrs))):
            fail(f"phase 4p: the obs entry's rows miss a stage: "
                 f"{stats_out[-1]['obs']['rows']}")
        slow = max(range(len(st)), key=lambda k: p50[k])
        res.update({
            "rows": len(rows), "bottleneck": bott,
            "largest_infer_p50_stage": slow,
            "node_infer_p50_ms": [v * 1e3 for v in p50],
            "node_mfu": mfu, "node_flops": [s["flops"] for s in st],
            "obs_bottleneck": obs["bottleneck"],
            "stragglers": obs["stragglers"],
            "replan_moved": (obs.get("replan") or {}).get("moved"),
            "window_frames": len(frames)})
    res["seconds"] = ph.seconds
    print(f"obs path: resnet50 chain, {len(frames)} profiled frames: view "
          f"rows {len(rows)}, bottleneck stage {bott} (largest infer p50: "
          f"stage {slow}, {p50[slow] * 1e3:.3f} ms); phases/infer per node "
          f"{[round(v, 4) for v in res['phase_tiles'].values()]}; MFU per "
          f"node {[v if v is None else round(v, 5) for v in mfu]} (f32 stages against the bf16 "
          f"peak 989e12); mem bytes {list(res['mem_bytes'].values())}; obs "
          f"entry bottleneck {obs['bottleneck']}, {len(obs['stragglers'])} "
          f"straggler flag(s), replan moved {res['replan_moved']}; "
          f"{ph.seconds:.2f} s; on {card}", flush=True)
    return res


#: the ResNet50 node process whose window ``profile --torch-trace-dir``
#: records, the window's seconds, and the frames streamed again and again
#: while it is open
NODE_TRACE_STAGE = 1
NODE_TRACE_S = 1.0
NODE_TRACE_FRAMES = 4
#: substrings that name a convolution kernel (cuDNN's or its implicit GEMM)
#: in a torch.profiler trace
CONV_TRACE_NAMES = ("conv", "cudnn", "fprop", "implicit")


def node_trace(torch, chain, frames, want, card) -> dict:
    """Phase 4p d, on 4k's ResNet50/8 processes: the port's ``profile
    --torch-trace-dir`` command (in this process) brackets a window on one
    node process while the dispatcher streams; the Chrome trace that
    process wrote holds its convolution kernels."""
    import os
    import tempfile
    import threading

    import numpy as np

    from defer_tpu_torch import cli

    k = NODE_TRACE_STAGE
    addr, pid = chain.addrs[k], chain.pid(k)
    frames, want = frames[:NODE_TRACE_FRAMES], want[:NODE_TRACE_FRAMES]
    res = {"stage": k}
    with obs_phase() as ph, \
            tempfile.TemporaryDirectory(prefix="defer_node_trace_") as d:
        out = os.path.join(d, "profile.json")
        errs: list = []

        def profile():
            try:
                cli.main(["profile", "--nodes", addr, "--seconds",
                          str(NODE_TRACE_S), "--torch-trace-dir", d,
                          "--out", out])
            except BaseException as e:  # noqa: BLE001 — failed below
                errs.append(repr(e))

        th = threading.Thread(target=profile, daemon=True,
                              name="cli-profile")
        th.start()
        streams = 0
        while th.is_alive():
            rows = np.stack(chain.dispatcher.stream(frames))
            if not np.array_equal(rows, want):
                fail("phase 4p: a stream under the node's trace changed "
                     "its rows")
            streams += 1
        th.join()
        if errs or not os.path.exists(out):
            fail(f"phase 4p: profile --torch-trace-dir failed: {errs}")
        with open(out) as f:
            rep = json.load(f)["nodes"][addr]
        path = rep.get("trace_file")
        if not path or f"trace-{pid}-" not in os.path.basename(path):
            fail(f"phase 4p: node {addr} (pid {pid}) wrote trace {path!r} "
                 f"(see its stderr)")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        conv = [e for e in kern if any(
            n in e.get("name", "").lower() for n in CONV_TRACE_NAMES)]
        names = sorted({e["name"] for e in conv})
        if not conv:
            fail(f"phase 4p: the trace of node process {pid} holds "
                 f"{len(kern)} kernels and no convolution: "
                 f"{sorted({e.get('name') for e in kern})[:12]}")
        res.update({"pid": pid, "streams": streams,
                    "window_frames": rep["phases"]["infer"]["count"],
                    "trace_kernels": len(kern), "trace_conv": len(conv),
                    "trace_conv_us": sum(e.get("dur", 0) for e in conv),
                    "conv_names": names[:6]})
    res["seconds"] = ph.seconds
    print(f"obs path: profile --torch-trace-dir on node process {pid} "
          f"(stage {k}) for {NODE_TRACE_S:g} s while {streams} streams of "
          f"{len(frames)} frames ran: its trace holds {len(kern)} kernels, "
          f"{len(conv)} convolutions ({res['trace_conv_us']:.1f} us; "
          f"{names[:3]}); {ph.seconds:.2f} s; on {card}", flush=True)
    return res


def obs_bert(torch, disp, addrs, frames, blocks, card) -> dict:
    """Phase 4p b, on 4k's in-process BERT-Base/12 chain: a profiled
    stream with stage 0's window also recorded by ``torch.profiler``: the
    window's launches (the nodes share this process, so each node's window
    sees every block's: ``blocks`` per frame), the phase tiles, and the
    flash kernel among the trace's kernels."""
    import tempfile

    res = {}
    with obs_phase() as ph:
        tdir = tempfile.mkdtemp(prefix="defer_trace_")
        _, reports = profile_window(addrs, lambda: disp.stream(frames),
                                    trace_dirs={addrs[0]: tdir})
        res.update(check_windows(torch, reports, len(frames), "bert chain"))
        want = blocks * len(frames)
        got = [r["kernel_launches"]["flash_attention"]
               for r in reports.values()]
        quant = [r["kernel_launches"]["quant_int8"] for r in reports.values()]
        if set(got) != {want} or set(quant) != {0}:
            fail(f"phase 4p: bert windows' flash launches {got}, quantizer "
                 f"{quant} (want {want}: {blocks} per frame, and 0)")
        path = reports[addrs[0]]["trace_file"]
        if not path:
            fail("phase 4p: stage 0's window wrote no torch.profiler trace")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        flash = [e for e in kern if FLASH_TRACE_NAME in e.get("name", "")]
        if not flash:
            fail(f"phase 4p: the trace's {len(kern)} kernels hold no "
                 f"{FLASH_TRACE_NAME}")
        res.update({"window_frames": len(frames),
                    "window_flash_launches": got[0],
                    "trace_kernels": len(kern), "trace_flash": len(flash),
                    "trace_flash_us": sum(e.get("dur", 0) for e in flash)})
    res["seconds"] = ph.seconds
    print(f"obs path: bert chain, {len(frames)} profiled frames: "
          f"{got[0]} flash launches in each node's window ({blocks} per "
          f"frame), phases/infer per node "
          f"{[round(v, 4) for v in res['phase_tiles'].values()]}; stage 0's "
          f"torch.profiler trace: {len(kern)} kernels, {len(flash)} "
          f"{FLASH_TRACE_NAME} ({res['trace_flash_us']:.1f} us); "
          f"{ph.seconds:.2f} s; on {card}", flush=True)
    return res


def obs_autopsy(jdir, killed_at, node_pids, victim, card) -> dict:
    """Phase 4p c, on 4n's replicated chain armed with ``journal_dir``:
    the supervisor's postmortem bundle after the SIGKILL (``bundle.json``
    and ``trace.json``), its verdict naming ``victim``, a journal for every
    node process and for this dispatcher, and ``postmortem.collect`` of
    the same directory giving the same verdict again."""
    import glob
    import os

    from defer_tpu_torch.obs.postmortem import collect

    res = {}
    with obs_phase() as ph:
        deadline = time.monotonic() + 30
        found = []
        while not found and time.monotonic() < deadline:
            found = glob.glob(os.path.join(jdir, "bundle-*", "bundle.json"))
            if not found:
                time.sleep(0.1)
        if not found:
            fail(f"phase 4p: no postmortem bundle under {jdir} 30 s past "
                 f"the respawn")
        out_dir = os.path.dirname(found[0])
        with open(found[0]) as f:
            bundle = json.load(f)
        pids = {p["pid"] for p in bundle["procs"]}
        procs = sorted(p["proc"] for p in bundle["procs"])
        missing = sorted(set(node_pids + [os.getpid()]) - pids)
        first = bundle["verdict"]["first_fault"]
        if (first != victim or missing
                or not os.path.exists(os.path.join(out_dir, "trace.json"))):
            fail(f"phase 4p: bundle verdict {first!r} (want {victim!r}), "
                 f"journals missing for pids {missing}, procs {procs}, "
                 f"evidence {bundle['verdict']['evidence']}")
        again = collect(jdir, out_dir=os.path.join(jdir, "again"),
                        reason="phase 4p")
        if again["verdict"]["first_fault"] != first:
            fail(f"phase 4p: collect again says "
                 f"{again['verdict']['first_fault']!r}, the supervisor's "
                 f"bundle {first!r}")
        res.update({
            "kill_to_bundle_s": os.path.getmtime(found[0]) - killed_at,
            "first_fault": first, "procs": procs,
            "evidence": bundle["verdict"]["evidence"],
            "warnings": bundle["warnings"],
            "timeline_events": len(bundle["timeline"])})
    res["seconds"] = ph.seconds
    print(f"obs path: autopsy after the SIGKILL: bundle.json "
          f"{res['kill_to_bundle_s']:.2f} s after the kill, verdict "
          f"{first!r} (collect again: the same), {len(procs)} journals "
          f"{procs}, {len(bundle['warnings'])} warning(s), "
          f"{len(bundle['timeline'])} events; evidence "
          f"{res['evidence']}; {ph.seconds:.2f} s; on {card}", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 4q: the command line, on 4a's, 4g's and 4k's models and chains
# ---------------------------------------------------------------------------

#: seconds phase 4q's commands took, carved out of the phases they ride
CLI_SECONDS: list = []
#: ``bench``'s timed window (s)
CLI_BENCH_S = 2.0
#: ``generate``: prompt tokens and new tokens
CLI_PROMPT, CLI_NEW = 32, 8
#: ``serve``'s life after its serving line (s): the client's trace, its
#: drain and a margin
CLI_SERVE_S = 4.0
#: ``serve-client``'s trace (s) and the SLO its hello carries (ms)
CLI_CLIENT_S = 2.0
CLI_DEADLINE_MS = 5000.0
#: the block stage of BERT-Base's export that is loaded and run
CLI_EXPORT_STAGE = 1


def cli_phase() -> carved:
    """A stretch of phase 4q (its seconds land in CLI_SECONDS)."""
    return carved("4q", CLI_SECONDS)


class ThreadTee:
    """``sys.stdout`` while CLI commands run in this process: every write
    goes on to the real stdout and is kept by thread, so the smoke reads
    each command's JSON lines apart from a command running beside it."""

    def __init__(self, real):
        import threading

        self.real, self._lock, self.parts = real, threading.Lock(), {}

    def write(self, text: str) -> int:
        import threading

        with self._lock:
            self.parts.setdefault(threading.get_ident(), []).append(text)
        return self.real.write(text)

    def flush(self) -> None:
        self.real.flush()

    def lines(self, ident: int) -> list:
        with self._lock:
            text = "".join(self.parts.get(ident, []))
        return [ln for ln in text.splitlines() if ln.strip()]


class cli_runs:
    """The port's CLI in this process, as a user calls it
    (``defer_tpu_torch.cli.main(argv)``), with two things held for the
    smoke: stdout tee'd by thread (``run`` returns a command's lines), and
    each command's model and seeded weights served from the graphs and
    parameters this smoke already built from the same factory, size and
    seed (``built``: name -> (graph, params)).  A stage's ``torch.export``
    trace is kept per graph object (``utils/export.py``), so a command on
    a graph a chain already deployed reuses its traces."""

    def __init__(self, built: dict | None = None):
        from defer_tpu_torch import cli, models

        self.cli, self.built = cli, dict(built or {})
        if SEED != 0:
            fail("phase 4q: the CLI's weights are seed 0; SEED must be 0")
        for name, (g, _) in self.built.items():
            fresh = getattr(models, name)()
            if (fresh.topo_order != g.topo_order
                    or fresh.input_spec != g.input_spec):
                fail(f"phase 4q: the smoke's {name} is not the CLI's "
                     f"{name}() ({g.input_spec} vs {fresh.input_spec})")

    def __enter__(self):
        cli = self.cli
        self.saved = cli._get_model, cli._init_params
        get_model, init_params = self.saved

        def get(name):
            return self.built[name][0] if name in self.built \
                else get_model(name)

        def init(graph):
            for g, p in self.built.values():
                if g is graph:
                    return p
            return init_params(graph)

        cli._get_model, cli._init_params = get, init
        self.tee = ThreadTee(sys.stdout)
        sys.stdout = self.tee
        return self

    def __exit__(self, *exc):
        sys.stdout = self.tee.real
        self.cli._get_model, self.cli._init_params = self.saved
        return False

    def run(self, argv) -> list:
        """Run one command on this thread; its stdout lines."""
        import threading

        self.cli.main([str(a) for a in argv])
        return self.tee.lines(threading.get_ident())


def _json_rows(lines) -> list:
    return [json.loads(ln) for ln in lines if ln.startswith("{")]


def cli_bench(torch, kernels, mp, thr, card) -> dict:
    """Phase 4q a: ``bench`` on ResNet50 at the paper's eight-stage cuts,
    int8 wire (a bf16 ring on the card), beside 4a's int8 rates; the
    quantizer launches once per step of every push (the capture push's
    replay included), flash never."""
    with cli_phase() as ph, cli_runs({"resnet50": (mp["graph"],
                                                   mp["params"])}) as c:
        zero_counts(kernels)
        row = _json_rows(c.run([
            "bench", "--model", "resnet50", "--cuts", ",".join(mp["cuts"]),
            "--microbatch", MICROBATCH, "--chunk", CHUNK, "--wire", "int8",
            "--seconds", CLI_BENCH_S]))[-1]
        torch.cuda.synchronize()
        launches = read_counts(kernels)
    per_step = mp["launches"]["int8"]["quant_int8"] // mp["steps"]
    pushed = row["steps"] + CHUNK
    want = {"quant_int8": pushed * per_step, "flash_attention": 0}
    if (launches != want or row["num_stages"] != len(mp["cuts"]) + 1
            or not row["value"] > 0 or row["wire"] != "int8"):
        fail(f"phase 4q bench: launches {launches} (want {want}: "
             f"{per_step} per step, {pushed} steps pushed), row {row}")
    free_card(torch)
    res = {"images_per_s": row["value"], "steps": row["steps"],
           "chunk_calls": row["chunk_calls"], "launches": launches,
           "push_latency_ms": row.get("push_latency_ms"),
           "ring_int8_images_per_s": thr["pipeline_int8"],
           "ring_bf16_int8_images_per_s": thr["pipeline_bf16_int8"],
           "seconds": ph.seconds}
    print(f"cli path: bench --model resnet50 ({row['num_stages']} stages, "
          f"microbatch {MICROBATCH}, chunk {CHUNK}, int8 wire on a bf16 "
          f"ring, f32 "
          f"compute) {row['value']:.1f} images/s over {row['steps']} steps "
          f"beside 4a's int8 ring {thr['pipeline_int8']:.1f} (f32) and "
          f"{thr['pipeline_bf16_int8']:.1f} (bf16 compute and ring) "
          f"images/s; launches {launches} ({per_step} quantizer launch "
          f"per step, {pushed} steps with the capture push's); "
          f"{ph.seconds:.2f} s; on {card}", flush=True)
    return res


def cli_generate(torch, kernels, gdec, gres, gp, card) -> dict:
    """Phase 4q b: ``generate --prefill`` on GPT-2 small in 12 stages: the
    flash launches of 4g's fused prefill for each of the command's two
    calls, and its first row equal to 4g's decoder on the same seeded
    weights and prompt up to the first near tie."""
    import numpy as np

    g = gp["graph"]
    with cli_phase() as ph, cli_runs({"gpt2_small": (g, gp["params"])}) \
            as c:
        zero_counts(kernels)
        row = _json_rows(c.run([
            "generate", "--model", "gpt2_small", "--stages", GPT_STAGES,
            "--microbatch", MICROBATCH, "--prompt-len", CLI_PROMPT,
            "--new-tokens", CLI_NEW, "--prefill"]))[-1]
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        free_card(torch)
        # the command's prompts: seed 0 (its --seed), vocabulary-wide ids
        vocab = g.nodes["lm_head"].out_spec.shape[-1]
        prompt = np.random.default_rng(0).integers(
            0, vocab, (row["batch"], CLI_PROMPT)).astype(np.int32)
        ref = gdec.generate(prompt[:MICROBATCH], CLI_NEW, prefill=True)[0]
        got = np.asarray(row["first_row"])
        first_tie = first_diff = len(ref)
        if not np.array_equal(got, ref):
            first_diff = int(np.flatnonzero(got != ref)[0])
            _, gap, lmax = incremental_greedy(
                torch, g, gp["pdev"], prompt[:1], len(ref), GPT_MAX_LEN,
                dtype=torch.float32)
            tie = np.flatnonzero(gap[0] < TIE_REL * lmax[0])
            first_tie = int(tie[0]) if tie.size else len(ref)
    per_call = gres["launches"]["prefill_f32"]["flash_attention"]
    want = {"flash_attention": 2 * per_call, "quant_int8": 0}
    if row["batch"] != GPT_PROMPTS[0] or launches != want:
        fail(f"phase 4q generate: batch {row['batch']}, launches {launches} "
             f"(want {want}: 4g's {per_call} per generate(prefill=True), "
             f"two calls)")
    if first_diff < first_tie:
        fail(f"phase 4q generate: first_row {got.tolist()} parts from the "
             f"decoder's {ref.tolist()} at position {first_diff}, before "
             f"any near tie")
    res = {"tokens_per_s": row["tokens_per_s"], "batch": row["batch"],
           "launches": launches, "first_row_equal": first_diff == len(ref),
           "seconds": ph.seconds}
    print(f"cli path: generate --model gpt2_small --stages {GPT_STAGES} "
          f"--microbatch {MICROBATCH} --prompt-len {CLI_PROMPT} "
          f"--new-tokens {CLI_NEW} --prefill: {row['tokens_per_s']:.1f} "
          f"tokens/s ({row['batch']} prompts, the timed call); launches "
          f"{launches} ({per_call} per call, as 4g's prefill); first_row "
          f"{'equal to' if first_diff == len(ref) else 'equal up to a near tie with'}"
          f" 4g's decoder; {ph.seconds:.2f} s; on {card}", flush=True)
    return res


def cli_export(torch, device, kernels, bp, card) -> dict:
    """Phase 4q c: ``export`` of BERT-Base in 12 stages at batch MICROBATCH
    (4k's traces of the same stages are kept), then one block stage loaded
    with ``load_stage`` on the card: one flash launch for a frame, within
    BUFFER_REL_BOUND of max |output| of the in-process ``StageModule`` on
    the same weights."""
    import os
    import tempfile

    from defer_tpu_torch.partition import partition
    from defer_tpu_torch.partition.stage import StageModule
    from defer_tpu_torch.utils.export import load_stage

    k = CLI_EXPORT_STAGE
    with cli_phase() as ph, cli_runs({"bert_base": (bp["graph"],
                                                    bp["params"])}) as c, \
            tempfile.TemporaryDirectory(prefix="defer_export_") as d:
        paths = c.run(["export", "--model", "bert_base", "--stages", 12,
                       "--batch", MICROBATCH, "--out", d])
        sizes = [os.path.getsize(p) for p in paths]
        if len(paths) != 12 or not all(sizes):
            fail(f"phase 4q export: artifacts {paths}")
        stage = partition(bp["graph"], None, num_stages=12)[k]
        prog, manifest = load_stage(paths[k], device=device)
        gen = torch.Generator(device=device).manual_seed(SEED)
        x = torch.randn((MICROBATCH,) + tuple(stage.in_spec.shape),
                        generator=gen, device=device)
        zero_counts(kernels)
        out = prog(x)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        with torch.inference_mode():
            ref = StageModule(stage, bp["params"], device)(x)
        rel = _rel_err(out.cpu().numpy(), ref.cpu().numpy(),
                       f"exported stage {k}", BUFFER_REL_BOUND, phase="4q")
        del prog
    want = {"flash_attention": 1, "quant_int8": 0}
    if launches != want or manifest["batch"] != MICROBATCH:
        fail(f"phase 4q export: stage {k} launched {launches} (want {want})"
             f", manifest batch {manifest['batch']}")
    res = {"artifacts": len(paths), "bytes": sum(sizes), "stage": k,
           "rel_err": rel, "launches": launches, "seconds": ph.seconds}
    print(f"cli path: export --model bert_base --stages 12 --batch "
          f"{MICROBATCH}: {len(paths)} artifacts, {sum(sizes) / 1e6:.1f} MB; "
          f"stage {k} ({stage.name}) loaded on {device}: {rel:.3g} of max "
          f"|output| off the StageModule, launches {launches}; "
          f"{ph.seconds:.2f} s; on {card}", flush=True)
    return res


def cli_serve(torch, kernels, chain, mp, rate_hz: float, card) -> dict:
    """Phase 4q d: ``serve --nodes`` over 4k's eight ResNet50 node
    processes (deployed again in-band by the command's own dispatcher) on
    a thread, and ``serve-client`` against it at ``rate_hz``: every request
    completed, none shed, ``final_stats`` counting each one, and no
    quantizer or flash launch in this process or in the nodes."""
    import threading

    addrs = chain.addrs
    cuts = ",".join(mp["cuts"])
    before = _sum_launches(chain.dispatcher.stats(addrs))
    errs: list = []
    with cli_phase() as ph, cli_runs({"resnet50": (mp["graph"],
                                                   mp["params"])}) as c:
        zero_counts(kernels)

        def serve():
            try:
                c.run(["serve", "--nodes", ",".join(addrs), "--model",
                       "resnet50", "--cuts", cuts, "--width", MICROBATCH,
                       "--seconds", CLI_SERVE_S])
            except BaseException as e:  # noqa: BLE001 — failed below
                errs.append(repr(e))

        th = threading.Thread(target=serve, daemon=True, name="cli-serve")
        th.start()
        head, t_up = None, time.monotonic() + 120
        while head is None and th.is_alive() and time.monotonic() < t_up:
            rows = [r for r in _json_rows(c.tee.lines(th.ident))
                    if "serving" in r]
            head = rows[0] if rows else None
            time.sleep(0.01)
        if head is None:
            fail(f"phase 4q serve: no serving line ({errs or 'a hang'})")
        client = _json_rows(c.run([
            "serve-client", "--connect", head["serving"], "--sample-shape",
            f"{IMAGE_SIZE},{IMAGE_SIZE},3", "--deadline-ms",
            CLI_DEADLINE_MS, "--rate", f"{rate_hz:.1f}", "--seconds",
            CLI_CLIENT_S]))[-1]
        th.join(timeout=CLI_SERVE_S + 120)
        final = [r["final_stats"] for r in _json_rows(c.tee.lines(th.ident))
                 if "final_stats" in r]
        launches = read_counts(kernels)
    after = _sum_launches(chain.dispatcher.stats(addrs))
    nodes = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    if errs or th.is_alive() or not final:
        fail(f"phase 4q serve: {errs or 'no final_stats line'}")
    ten = final[0]["tenants"].get(client["tenant"], {})
    zero = {"quant_int8": 0, "flash_attention": 0}
    if (client["completed"] != client["offered"] or client["shed"] != 0
            or not client["offered"] > 0
            or ten.get("completed") != client["offered"]
            or ten.get("admitted") != client["offered"]
            or ten.get("shed", 0) != 0 or launches != zero
            or nodes != zero):
        fail(f"phase 4q serve: client {client}, final_stats tenant {ten}, "
             f"launches here {launches}, in the nodes {nodes} (want every "
             f"request completed, none shed, no kernel launch)")
    res = {"offered": client["offered"], "completed": client["completed"],
           "shed": client["shed"], "rate_hz": rate_hz,
           "throughput_per_s": client["throughput_per_s"],
           "latency_p50_ms": client["latency_p50_ms"],
           "latency_p99_ms": client["latency_p99_ms"],
           "frames": final[0]["frames"], "launches": launches,
           "node_launches": nodes, "seconds": ph.seconds}
    print(f"cli path: serve --nodes (4k's {len(addrs)} ResNet50 processes, "
          f"width {MICROBATCH}) + serve-client at {rate_hz:.1f} Hz for "
          f"{CLI_CLIENT_S:g} s: {client['completed']}/{client['offered']} "
          f"completed, {client['shed']} shed, {client['throughput_per_s']}"
          f" images/s, p50 {client['latency_p50_ms']} ms, p99 "
          f"{client['latency_p99_ms']} ms, {final[0]['frames']} frames; "
          f"launches here {launches}, in the nodes {nodes}; "
          f"{ph.seconds:.2f} s; on {card}", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 4r: training on the card (rides 4a's ResNet50 and 4g's GPT-2 small)
# ---------------------------------------------------------------------------

#: phase 4r's share of BUDGET_S (its checks ride 4a's and 4g's models)
TRAIN_BUDGET_S = 45.0
#: seconds phase 4r took, carved out of the phases it rides
TRAIN_SECONDS: list = []
#: microbatches per training chunk: T = TRAIN_M + N - 1 ring steps
TRAIN_M = 4
#: loss against the whole-graph autograd reference (the summed loss of the
#: same microbatches; the same ops, so only summation order separates them)
TRAIN_LOSS_RTOL = 1e-5
#: each stage's gradient leaf against the reference: within this fraction
#: of the leaf's max |g| (cuDNN and cuBLAS may pick another backward
#: algorithm for a stage's slice of the graph)
TRAIN_GRAD_REL = 1e-3
#: int8 against the buffer wire: the JAX package's bounds
#: (tests/test_training.py, test_int8_wire_trains_straight_through)
TRAIN_INT8_LOSS_REL = 0.05
TRAIN_INT8_COS = 0.98
#: the int8 chunk with the plain quantizer in place of the kernel: the
#: quantizer is bit-equal, so only reduction order separates the runs
TRAIN_PLAIN_REL = 1e-5
#: optimizer steps and learning rates of 4r's trajectories
TRAIN_STEPS = 3
TRAIN_ADAM_LR = 1e-4
TRAIN_SGD_LR = 1e-3
#: GPT-2 small training: tokens per sequence; Adam's learning rate
TRAIN_SEQ = 64
TRAIN_GPT_LR = 1e-4
#: the ``train`` command: steps, then one more after its checkpoint
TRAIN_CLI_STEPS = 2


def train_phase() -> carved:
    """A stretch of phase 4r (its seconds land in TRAIN_SECONDS)."""
    return carved("4r", TRAIN_SECONDS)


def train_ce(torch):
    """Mean cross-entropy of a microbatch's logits (the ``train``
    command's loss)."""
    return lambda logits, labels: torch.nn.functional.cross_entropy(
        logits.float(), labels)


def train_lm(torch):
    """Next-token cross-entropy of a microbatch of sequences
    (tests/test_gpt_training.py's ``lm_loss``)."""
    def lm(logits, ids):
        return torch.nn.functional.cross_entropy(
            logits[:, :-1].float().flatten(0, 1),
            ids[:, 1:].long().flatten())
    return lm


def whole_graph_grads(torch, graph, pdev, xs, ys, loss_fn, device):
    """The summed per-microbatch loss through the whole graph and its
    gradient per (node, leaf path), by autograd on the card."""
    from defer_tpu_torch.graph.ir import flatten_tree, tree_map

    p = tree_map(lambda v: v.detach().clone().requires_grad_(
        v.is_floating_point()), pdev)
    total = 0.0
    for x, y in zip(xs, ys):
        x = torch.from_numpy(x).to(device)
        if not graph.input_spec.dtype.is_floating_point:
            x = x.to(graph.input_spec.dtype)
        total = total + loss_fn(graph.apply(p, x),
                                torch.as_tensor(y).to(device))
    leaves = [((n, k), v) for n, sub in p.items()
              for k, v in flatten_tree(sub).items() if v.requires_grad]
    grads = torch.autograd.grad(total, [v for _, v in leaves])
    return float(total.detach()), {key: g for (key, _), g in
                                   zip(leaves, grads)}


def check_stage_grads(torch, trainer, grads, ref, what: str) -> float:
    """Each stage's gradient leaves against the whole-graph reference:
    within TRAIN_GRAD_REL of the leaf's max |g|.  Returns the worst
    fraction."""
    from defer_tpu_torch.graph.ir import flatten_tree

    worst, seen = 0.0, 0
    for sg in trainer.stage_grads(grads):
        for n, sub in sg.items():
            for k, v in flatten_tree(sub).items():
                r = ref[(n, k)].float().cpu()
                scale = float(r.abs().max())
                err = float((v - r).abs().max())
                if not err <= TRAIN_GRAD_REL * max(scale, 1e-30):
                    fail(f"phase 4r {what}: gradient of {n}/{k} off the "
                         f"whole-graph reference by {err:.3g} (max |g| "
                         f"{scale:.3g}, bound {TRAIN_GRAD_REL} of it)")
                worst = max(worst, err / max(scale, 1e-30))
                seen += 1
    if seen != len(ref):
        fail(f"phase 4r {what}: {seen} gradient leaves, the reference has "
             f"{len(ref)}")
    return worst


def _cos(torch, a, b) -> float:
    a = torch.cat([g.flatten().double() for g in a])
    b = torch.cat([g.flatten().double() for g in b])
    return float(a @ b / (a.norm() * b.norm()))


def _counted(torch, kernels, fn):
    """``fn()`` with the launch counts zeroed just before and read just
    after (the device synchronised): (result, launches, seconds)."""
    zero_counts(kernels)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(kernels), time.perf_counter() - t0


def _want_launches(what: str, got: dict, quant: int) -> None:
    want = {"quant_int8": quant, "flash_attention": 0}
    if got != want:
        fail(f"phase 4r {what}: launches {got} (want {want})")


def train_resnet(torch, device, kernels, card, mp) -> dict:
    """Phase 4r a, b, c and e on 4a's ResNet50/8 (its graph, seed-0
    weights, cuts and first TRAIN_M microbatches of inputs), TF32 off.

    a: ``loss_and_grad`` on the buffer wire against the whole-graph
    autograd reference: loss within TRAIN_LOSS_RTOL, each stage's leaves
    within TRAIN_GRAD_REL of the reference's max |g|.  b: the same chunk
    on ``wire="int8"`` (the straight-through hop): the loss within 5% of
    a's and the gradient cosine above 0.98; the quantizer launched once per
    ring step (T = M + N - 1; the recompute reruns no hop); the same chunk
    with the plain quantizer within TRAIN_PLAIN_REL of the kernel's; three
    Adam steps lower the loss; then the pipeline's captured graph serves
    the trained rows (no new capture) equal to a fresh pipeline of
    ``trained_params()``.  c: bf16 compute on float32 master rows: the rows
    stay float32, a fresh master-bf16 pipeline's run equals a plain bf16
    one's, one SGD step runs.  e: the ``train`` command (int8, ``--save``)
    in this process; its checkpoint loads into a fresh trainer whose next
    loss equals that of a trainer that carried on."""
    import numpy as np

    from defer_tpu_torch import PipelineTrainer, SpmdPipeline
    from defer_tpu_torch.ops import quant
    from defer_tpu_torch.partition import partition

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g, params, cuts = mp["graph"], mp["params"], mp["cuts"]
    stages = partition(g, cuts)
    n = len(stages)
    steps = TRAIN_M + n - 1
    classes = g.output_spec.shape[-1]
    xs = mp["inputs"][:TRAIN_M]
    ys = np.random.default_rng(SEED).integers(0, classes,
                                              (TRAIN_M, MICROBATCH))
    ce = train_ce(torch)
    kw = dict(device=device, microbatch=MICROBATCH, chunk=CHUNK)
    res: dict = {"model": "resnet50", "stages": n, "microbatches": TRAIN_M,
                 "ring_steps": steps, "launches": {}}

    # a. the buffer wire against the whole-graph reference
    tb = PipelineTrainer(SpmdPipeline(stages, params, **kw), ce)
    (lb, gb), got, sec = _counted(torch, kernels,
                                  lambda: tb.loss_and_grad(xs, ys))
    _want_launches("a buffer", got, 0)
    res["launches"]["buffer"] = got
    ref_l, ref_g = whole_graph_grads(torch, g, mp["pdev"], xs, ys, ce,
                                     device)
    if not abs(float(lb) - ref_l) <= TRAIN_LOSS_RTOL * abs(ref_l):
        fail(f"phase 4r a: loss {float(lb)!r} against the whole graph's "
             f"{ref_l!r} (rtol {TRAIN_LOSS_RTOL})")
    worst = check_stage_grads(torch, tb, gb, ref_g, "a buffer")
    res["buffer"] = {"loss": float(lb), "reference_loss": ref_l,
                     "worst_grad_rel": worst, "seconds": sec}
    # phase 4t (iii)'s reference: this chunk's buffer-wire loss, gradients
    res["_buffer_baseline"] = {"loss": float(lb), "grads": tb.stage_grads(gb)}
    print(f"train path a: PipelineTrainer(resnet50, {n} stages, buffer "
          f"wire, microbatch {MICROBATCH}) loss_and_grad on {TRAIN_M} "
          f"microbatches ({steps} ring steps, remat) {sec:.3f} s; loss "
          f"{float(lb):.6f} (whole graph {ref_l:.6f}); worst gradient leaf "
          f"{worst:.3g} of its max |g| (bound {TRAIN_GRAD_REL}); launches "
          f"{got}; on {card}", flush=True)
    del ref_g, tb

    # b. the int8 wire: the straight-through hop on the quantizer kernel
    pq = SpmdPipeline(stages, params, wire="int8", **kw)
    before = pq.run(xs)  # captures the chunk's graph before training
    captures = pq.metrics.captures
    tq = PipelineTrainer(pq, ce, optimizer=lambda rows: torch.optim.Adam(
        rows, lr=TRAIN_ADAM_LR))
    (lq, gq), got, sec_q = _counted(torch, kernels,
                                    lambda: tq.loss_and_grad(xs, ys))
    _want_launches("b int8", got, steps)
    res["launches"]["int8"] = got
    rel = abs(float(lq) - float(lb)) / abs(float(lb))
    cos = _cos(torch, gq, gb)
    if not (rel < TRAIN_INT8_LOSS_REL and cos > TRAIN_INT8_COS):
        fail(f"phase 4r b: int8 loss {float(lq)!r} is {rel:.3g} off the "
             f"buffer wire's (bound {TRAIN_INT8_LOSS_REL}), gradient cosine "
             f"{cos:.6f} (want > {TRAIN_INT8_COS})")
    del gb
    plain = quant.quantize_int8_blocks
    quant.quantize_int8_blocks = quant.quantize_int8_blocks_plain
    try:
        (lp, gp), got_p, sec_p = _counted(torch, kernels,
                                          lambda: tq.loss_and_grad(xs, ys))
    finally:
        quant.quantize_int8_blocks = plain
    _want_launches("b plain quantizer", got_p, 0)
    res["launches"]["int8_plain_quantizer"] = got_p
    prel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(gp, gq))
    if not (abs(float(lp) - float(lq)) <= TRAIN_PLAIN_REL * abs(float(lq))
            and prel <= TRAIN_PLAIN_REL):
        fail(f"phase 4r b: the plain quantizer's loss {float(lp)!r} and "
             f"gradients ({prel:.3g} of max |g|) against the kernel's "
             f"{float(lq)!r} (bound {TRAIN_PLAIN_REL})")
    # phase 4s e's dp=1 baseline and 4t (i)'s reference: this chunk's int8
    # loss and gradients
    res["_int8_baseline"] = {"loss": float(lq), "grads": tq.stage_grads(gq)}
    del gp, gq
    # cuDNN runs deterministic algorithms for the Adam steps (as in e):
    # Adam turns a last-bit difference in a near-zero gradient into a step
    # of 2 lr, and phase 4t holds its processes' steps to these
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    losses, got_s, sec_s = _counted(torch, kernels, lambda: [
        tq.step(xs, ys) for _ in range(TRAIN_STEPS)])
    torch.backends.cudnn.deterministic = deterministic
    _want_launches("b Adam steps", got_s, TRAIN_STEPS * steps)
    res["launches"]["int8_adam_steps"] = got_s
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"phase 4r b: Adam losses {losses} (want finite, the last "
             "below the first)")
    ring_steps = pq.metrics.steps
    out, got_r, _ = _counted(torch, kernels, lambda: pq.run(xs))
    _want_launches("b replay", got_r, pq.metrics.steps - ring_steps)
    if pq.metrics.captures != captures:
        fail(f"phase 4r b: the trained pipeline captured anew "
             f"({pq.metrics.captures} captures, {captures} before)")
    res["launches"]["int8_replay"] = got_r
    fresh, got_f, _ = _counted(torch, kernels, lambda: SpmdPipeline(
        stages, tq.trained_params(), wire="int8", **kw).run(xs))
    res["launches"]["int8_fresh"] = got_f
    scale = float(np.abs(fresh).max())
    gerr = float(np.abs(out - fresh).max())
    moved = float(np.abs(out - before).max())
    if not (gerr <= GRAPH_REL_BOUND * scale and moved > 0):
        fail(f"phase 4r b: the replayed trained pipeline is {gerr:.3g} off "
             f"a fresh pipeline of trained_params() (bound "
             f"{GRAPH_REL_BOUND} of {scale:.3g}); moved {moved:.3g} from "
             "its output before training")
    res["int8"] = {"loss": float(lq), "rel_to_buffer": rel, "cosine": cos,
                   "plain_quantizer_loss": float(lp),
                   "plain_quantizer_grad_rel": prel, "adam_lr": TRAIN_ADAM_LR,
                   "adam_losses": losses, "replay_rel_err": gerr / scale,
                   "captures": pq.metrics.captures,
                   "loss_and_grad_s": sec_q, "plain_s": sec_p,
                   "step_s": sec_s / TRAIN_STEPS}
    print(f"train path b: int8 wire loss {float(lq):.6f} ({rel:.3g} off the "
          f"buffer wire's), gradient cosine {cos:.6f}; loss_and_grad "
          f"{sec_q:.3f} s with {got['quant_int8']} quantizer launches (one "
          f"per ring step; the recompute reruns no hop), {sec_p:.3f} s on "
          f"the plain quantizer ({prel:.3g} of max |g| apart); Adam "
          f"(lr {TRAIN_ADAM_LR:g}) losses {[round(x, 4) for x in losses]}, "
          f"{sec_s / TRAIN_STEPS:.3f} s a step; the captured graph serves "
          f"the trained rows {gerr / scale:.3g} of max|out| off a fresh "
          f"pipeline ({pq.metrics.captures} capture); on {card}", flush=True)
    del tq, pq
    free_card(torch)

    # c. master weights: bf16 compute on float32 rows
    pm = SpmdPipeline(stages, params, master_weights=True, **mp["bf16"],
                      **kw)
    rows32 = all(m.row.dtype == torch.float32 for m in pm.modules)
    out_m = pm.run(xs)
    out_p = SpmdPipeline(stages, params, **mp["bf16"], **kw).run(xs)
    free_card(torch)
    merr = float(np.abs(out_m - out_p).max())
    mscale = float(np.abs(out_p).max())
    tm = PipelineTrainer(pm, ce, optimizer=lambda rows: torch.optim.SGD(
        rows, lr=TRAIN_SGD_LR))
    lm, got_m, sec_m = _counted(torch, kernels, lambda: tm.step(xs, ys))
    _want_launches("c master weights", got_m, 0)
    res["launches"]["master_bf16"] = got_m
    if not (rows32 and all(r.dtype == torch.float32 for r in tm.rows)
            and merr <= GRAPH_REL_BOUND * mscale and math.isfinite(lm)):
        fail(f"phase 4r c: master rows float32 {rows32}, master against "
             f"plain bf16 {merr:.3g} (bound {GRAPH_REL_BOUND} of {mscale:.3g})"
             f", SGD loss {lm!r}")
    res["master_bf16"] = {"rows": "float32", "vs_plain_bf16_rel":
                          merr / mscale, "sgd_loss": lm, "step_s": sec_m}
    print(f"train path c: master_weights (bf16 compute, {mp['bf16']}) rows "
          f"float32 before and after an SGD step (loss {lm:.6f}, "
          f"{sec_m:.3f} s); a fresh master pipeline {merr / mscale:.3g} of "
          f"max|out| off a plain bf16 one; on {card}", flush=True)
    del tm, pm
    free_card(torch)

    # e. the train command, its checkpoint into a fresh trainer
    res["cli"] = train_cli(torch, device, kernels, mp, stages, card)
    free_card(torch)
    return res


def train_cli(torch, device, kernels, mp, stages, card) -> dict:
    """Phase 4r e: ``train`` on ResNet50/8 (int8, ``--save``, Adam at
    TRAIN_ADAM_LR) through ``cli.main`` in this process on 4a's graph and
    weights; its losses finite and equal to the same steps through the
    API, and its checkpoint loaded into a fresh trainer, whose next loss
    equals that of the trainer that carried on (rtol TRAIN_LOSS_RTOL).
    cuDNN runs deterministic algorithms here: its default weight-gradient
    kernels sum in a varying order, and Adam turns a last-bit difference
    in a near-zero gradient into a step of 2 lr, so two runs of the same
    steps would drift apart."""
    import os
    import tempfile

    import numpy as np

    from defer_tpu_torch import PipelineTrainer, SpmdPipeline

    n = len(stages)
    chunk = TRAIN_M + n - 1  # the command trains chunk - N + 1 microbatches
    steps = chunk
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory(prefix="defer_train_") as d, \
            cli_runs({"resnet50": (mp["graph"], mp["params"])}) as c:
        ck = os.path.join(d, "ckpt")
        lines, got, sec = _counted(torch, kernels, lambda: c.run([
            "train", "--model", "resnet50", "--cuts", ",".join(mp["cuts"]),
            "--microbatch", MICROBATCH, "--chunk", chunk, "--wire", "int8",
            "--steps", TRAIN_CLI_STEPS, "--lr", TRAIN_ADAM_LR,
            "--save", ck]))
        row = _json_rows(lines)[-1]
        _want_launches("e train command", got, TRAIN_CLI_STEPS * steps)
        if not (row["stages"] == n and len(row["losses"]) == TRAIN_CLI_STEPS
                and np.isfinite(row["losses"]).all()
                and row["attn_impl"] is None):
            fail(f"phase 4r e: the train command printed {row}")
        # the command's data (its seeded generator) through the API
        rng = np.random.default_rng(0)
        xs = rng.standard_normal((TRAIN_M, MICROBATCH) + tuple(
            stages[0].in_spec.shape)).astype(np.float32)
        ys = rng.integers(0, mp["graph"].output_spec.shape[-1],
                          (TRAIN_M, MICROBATCH))

        def trainer():
            return PipelineTrainer(
                SpmdPipeline(stages, mp["params"], device=device,
                             microbatch=MICROBATCH, chunk=chunk,
                             wire="int8"), train_ce(torch),
                optimizer=lambda rows: torch.optim.Adam(
                    rows, lr=TRAIN_ADAM_LR))

        on = trainer()
        carried, got_c, _ = _counted(torch, kernels, lambda: [
            on.step(xs, ys) for _ in range(TRAIN_CLI_STEPS + 1)])
        _want_launches("e carried on", got_c, (TRAIN_CLI_STEPS + 1) * steps)
        del on
        resumed = trainer()
        resumed.load_checkpoint(ck)
        nxt, got_n, _ = _counted(torch, kernels,
                                 lambda: resumed.step(xs, ys))
        _want_launches("e resumed", got_n, steps)
    torch.backends.cudnn.deterministic = deterministic
    if not all(abs(a - b) <= 1e-4 + TRAIN_LOSS_RTOL * abs(b)
               for a, b in zip(row["losses"], carried)):
        fail(f"phase 4r e: the command's losses {row['losses']} are not the "
             f"API's {carried[:TRAIN_CLI_STEPS]} on its data")
    if not abs(nxt - carried[-1]) <= TRAIN_LOSS_RTOL * abs(carried[-1]):
        fail(f"phase 4r e: the resumed trainer's next loss {nxt!r} against "
             f"{carried[-1]!r} for the trainer that carried on (rtol "
             f"{TRAIN_LOSS_RTOL})")
    print(f"train path e: train --model resnet50 --wire int8 --steps "
          f"{TRAIN_CLI_STEPS} --save: losses {row['losses']} in {sec:.2f} s "
          f"(launches {got}: one per ring step, {steps} a step); resumed "
          f"from its checkpoint the next loss {nxt:.6f} against "
          f"{carried[-1]:.6f} carried on; on {card}", flush=True)
    return {"losses": row["losses"], "launches": got, "seconds": sec,
            "resumed_loss": nxt, "carried_loss": carried[-1],
            "api_launches": {"carried_on": got_c, "resumed": got_n}}


def train_gpt(torch, device, kernels, card, gp, gdec) -> dict:
    """Phase 4r d: GPT-2 small (4g's seed-0 weights, 12 stages, a block
    per stage, every block on ``attn_impl="xla"``) trained on TRAIN_M
    microbatches of MICROBATCH sequences of TRAIN_SEQ tokens with the
    next-token loss: per-stage gradients against the whole-graph
    reference as in a, TRAIN_STEPS Adam steps lower the loss, no kernel
    launches; the trained weights ``reweight``ed into 4g's decoder, whose
    next greedy token equals the trained graph's argmax up to a near tie.
    The graph of TRAIN_SEQ positions holds the first TRAIN_SEQ rows of
    4g's position table; the decoder takes the trained rows and keeps the
    rest (rows the training never reached)."""
    import numpy as np

    from defer_tpu_torch import PipelineTrainer, SpmdPipeline, models
    from defer_tpu_torch.graph import with_attn_impl
    from defer_tpu_torch.partition import partition
    from defer_tpu_torch.utils.convert import params_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    g = with_attn_impl(models.gpt2_small(seq_len=TRAIN_SEQ), "xla")
    params = dict(gp["params"])
    emb = dict(params["embeddings"])
    emb["wpe"] = emb["wpe"][:TRAIN_SEQ]
    params["embeddings"] = emb
    cuts = models.gpt_stage_cuts(GPT_STAGES, GPT_STAGES)
    stages = partition(g, cuts)
    n = len(stages)
    vocab = g.nodes["lm_head"].out_spec.shape[-1]
    ids = np.random.default_rng(SEED).integers(
        0, vocab, (TRAIN_M, MICROBATCH, TRAIN_SEQ))
    xs = ids.astype(np.float32)  # ids ride the f32 buffer exactly
    lm = train_lm(torch)
    t = PipelineTrainer(
        SpmdPipeline(stages, params, device=device, microbatch=MICROBATCH,
                     chunk=CHUNK), lm,
        optimizer=lambda rows: torch.optim.Adam(rows, lr=TRAIN_GPT_LR))
    (l0, g0), got, sec = _counted(torch, kernels,
                                  lambda: t.loss_and_grad(xs, ids))
    _want_launches("d gpt2", got, 0)
    ref_l, ref_g = whole_graph_grads(torch, g, params_to_device(
        params, device), xs, ids, lm, device)
    if not abs(float(l0) - ref_l) <= TRAIN_LOSS_RTOL * abs(ref_l):
        fail(f"phase 4r d: GPT-2 loss {float(l0)!r} against the whole "
             f"graph's {ref_l!r} (rtol {TRAIN_LOSS_RTOL})")
    worst = check_stage_grads(torch, t, g0, ref_g, "d gpt2")
    # phase 4s e's tp=1 baseline: this chunk's loss and gradients, and the
    # weights they start from
    baseline = {"loss": float(l0), "grads": t.stage_grads(g0),
                "params": params, "graph": g, "cuts": cuts, "xs": xs,
                "ids": ids}
    del g0, ref_g
    losses, got_s, sec_s = _counted(torch, kernels, lambda: [
        t.step(xs, ids) for _ in range(TRAIN_STEPS)])
    _want_launches("d gpt2 Adam steps", got_s, 0)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"phase 4r d: GPT-2 Adam losses {losses} (want finite, the "
             "last below the first)")

    # the trained weights into 4g's decoder (its graph's 256 positions)
    trained = t.trained_params()
    del t
    free_card(torch)
    full = dict(trained)
    wpe = gp["params"]["embeddings"]["wpe"]
    full["embeddings"] = dict(trained["embeddings"], wpe=torch.cat(
        [trained["embeddings"]["wpe"], wpe[TRAIN_SEQ:]]))
    gdec.reweight(full)
    prompt = ids[0, :, :GPT_PROMPTS[1]].astype(np.int32)
    toks, got_d, _ = _counted(torch, kernels,
                              lambda: gdec.generate(prompt, 1))
    _want_launches("d decoder", got_d, 0)
    with torch.inference_mode():
        logits = g.apply(params_to_device(trained, device),
                         torch.from_numpy(prompt).to(device))[:, -1]
        logits = logits.float().cpu().numpy()
    top2 = np.sort(logits, -1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) < TIE_REL * float(np.abs(logits).max())
    agree = toks[:, -1] == logits.argmax(-1)
    if not (agree | tie).all():
        fail(f"phase 4r d: the decoder's next tokens {toks[:, -1]} against "
             f"the trained graph's argmax {logits.argmax(-1)} (near ties "
             f"{tie})")
    res = {"model": "gpt2_small", "stages": n, "microbatches": TRAIN_M,
           "seq_len": TRAIN_SEQ, "ring_steps": TRAIN_M + n - 1,
           "loss": float(l0), "reference_loss": ref_l,
           "worst_grad_rel": worst, "adam_lr": TRAIN_GPT_LR,
           "adam_losses": losses, "loss_and_grad_s": sec,
           "step_s": sec_s / TRAIN_STEPS,
           "decoder_tokens_agree": f"{int(agree.sum())}/{agree.size}",
           "near_ties": int(tie.sum()),
           "launches": {"loss_and_grad": got, "adam_steps": got_s,
                        "decoder": got_d}, "_tp1_baseline": baseline}
    print(f"train path d: PipelineTrainer(gpt2_small, {n} stages, attn_impl "
          f"xla, {TRAIN_M} x {MICROBATCH} sequences of {TRAIN_SEQ}) "
          f"loss_and_grad {sec:.3f} s, loss {float(l0):.6f} (whole graph "
          f"{ref_l:.6f}), worst gradient leaf {worst:.3g} of its max |g|; "
          f"Adam (lr {TRAIN_GPT_LR:g}) losses {[round(x, 4) for x in losses]}"
          f", {sec_s / TRAIN_STEPS:.3f} s a step; 4g's decoder on the "
          f"trained weights: next tokens {res['decoder_tokens_agree']} equal "
          f"to the trained graph's argmax ({int(tie.sum())} near ties); "
          f"launches {got}; on {card}", flush=True)
    return res


def chain_path(torch, device, kernels, card, mp, bp):
    """Phase 4k.  a: ResNet50/8 as eight OS processes held open by
    ``deploy_chain`` with ``persist`` (in-band deploy of ``torch.export``
    artifacts, f32, frames of MICROBATCH) on lzb hops: rows within
    BUFFER_REL_BOUND of the forward with top-1 equal, every node's stats on
    cuda with one frame processed per frame sent; every hop pinned to tcp
    (phase 4l runs the colocated tiers).  c: the segment ends and the same
    eight processes are deployed again in-band on raw hops: the same
    images (rows byte-identical to a's lzb rows, every node's codec raw),
    timed streams of CHAIN_TIMED_FRAMES frames beside the ring pipeline,
    then ``ServeFrontDoor`` in tensor mode over the same chain (width
    MICROBATCH): two tenants' rows equal to the forward's rows of their
    images.  One spawn serves both codecs: a spawn costs a minute, a
    redeploy a third of it.  b: BERT-Base/12 as twelve in-process
    ``StageNode`` threads on the card: 12 flash launches per frame (the
    parent's counts and the nodes'), rows within BUFFER_REL_BOUND of phase
    4b's forward, a ``reweight`` between streams equal to the forward on
    the new weights, then a timed stream of CHAIN_TIMED_FRAMES frames
    beside the ring pipeline on the same frames.  Rates come only from the
    long streams: a stream of a few frames through eight or twelve stages
    is mostly filling and draining, so the short streams report their time
    to the last result."""
    import threading

    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig
    from defer_tpu_torch.graph.ir import tree_map
    from defer_tpu_torch.partition import partition
    from defer_tpu_torch.plan import StageCostModel, evaluate_cuts
    from defer_tpu_torch.runtime.node import (ChainDispatcher, StageNode,
                                              deploy_chain)
    from defer_tpu_torch.serve import ServeClient, ServeFrontDoor
    from defer_tpu_torch.serve.frontdoor import ChainBackend
    from defer_tpu_torch.utils.convert import params_to_device

    res = {"card": card, "timed_frames": CHAIN_TIMED_FRAMES}
    t_phase = time.perf_counter()

    def timed_rounds(chain, ring):
        """Alternating rounds of the chain's stream and the ring's run of
        the same frames; (chain walls, ring walls, last outputs)."""
        chain_w, ring_w = [], []
        for _ in range(CHAIN_ROUNDS):
            t0 = time.perf_counter()
            c_out = np.stack(chain())
            chain_w.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r_out = ring()
            torch.cuda.synchronize()
            ring_w.append(time.perf_counter() - t0)
        return chain_w, ring_w, c_out, r_out

    # --- a and c: ResNet50/8, eight processes held open, lzb then raw ----
    g, params, cuts = mp["graph"], mp["params"], mp["cuts"]
    stages = partition(g, cuts)
    n_frames = CHAIN_IMAGES // MICROBATCH
    frames = [mp["inputs"][i] for i in range(n_frames)]
    ref = mp["ref"][:n_frames]

    def check_nodes(stats, frames_each, what):
        bad = [(s["stage"], s["processed"], s["device"], s["tier"])
               for s in stats if s["processed"] != frames_each
               or not s["device"].startswith(device) or s["tier"] != "tcp"]
        if len(stats) != len(stages) or bad:
            fail(f"phase 4k {what}: node (stage, processed, device, tier) "
                 f"{bad} of {len(stats)} (want {len(stages)} nodes on "
                 f"{device}, {frames_each} frames each, tcp hops)")

    def check_rows(out, what):
        rel = _rel_err(out, ref, what, BUFFER_REL_BOUND)
        if not (out.argmax(-1) == ref.argmax(-1)).all():
            fail(f"phase 4k: the {what} changed a top-1 class")
        return rel

    pipe = Defer(DeferConfig(wire="buffer", microbatch=MICROBATCH,
                             chunk=CHUNK, device=device)).build(g, params,
                                                                cuts)
    batch = np.stack(frames)
    timed = [frames[i % n_frames] for i in range(CHAIN_TIMED_FRAMES)]
    tbatch = np.stack(timed)
    pipe.run(batch)  # captures the chunk graphs
    # b's stage programs trace while a's processes boot
    bstages = partition(bp["graph"], bp["cuts"])
    ahead = trace_ahead((bstages, bp["params"]))
    # one spawn for both codecs: the nodes persist across stream segments,
    # so the raw chain is the same eight processes deployed again in-band
    # (each hop pinned to tcp: this phase measures the wire chain; phase
    # 4l runs the colocated tiers)
    # phase 4p's plan: the paper's cuts priced by the model plan.solve
    # uses, which the session's live view is read against
    rplan = evaluate_cuts(g, cuts, StageCostModel(g, batch=MICROBATCH),
                          hop_codecs=["raw"] * len(cuts))
    t_spawn = time.perf_counter()
    with deploy_chain(stages, params, batch=MICROBATCH, codec="lzb",
                      in_band=True, tier="tcp", device=device,
                      persist=True, plan=rplan, graph=g) as chain:
        disp, addrs = chain.dispatcher, chain.addrs
        boot_s, deploy_s = chain.boot_s, chain.deploy_s
        door = None
        try:
            # the traces are done before anything is timed
            ahead.join()
            # a: lzb hops; each node's first frame is its first
            t0 = time.perf_counter()
            lzb = np.stack(disp.stream(frames))
            lzb_first_s = time.perf_counter() - t0
            secs = time.perf_counter() - t_spawn
            rel = check_rows(lzb, "resnet50 lzb chain")
            stats = disp.stats(addrs)
            check_nodes(stats, n_frames, "lzb chain")
            res["resnet50_lzb"] = {
                "rel_err": rel, "spawn_deploy_stream_s": secs,
                "boot_s": boot_s, "deploy_s": deploy_s,
                "first_stream_to_last_result_s": lzb_first_s,
                "launches": _sum_launches(stats),
                "node_infer_p50_ms": [s["infer_latency_s"]["p50"] * 1e3
                                      for s in stats],
                # each node's first frame: its program's first run
                "node_first_frame_ms": [s["infer_latency_s"]["max"] * 1e3
                                        for s in stats],
                "node_mem_bytes": [s["mem_bytes"] for s in stats]}
            print(f"chain path: deploy_chain(resnet50, {len(stages)} "
                  f"processes, in_band, codec=lzb, tier=tcp, device="
                  f"{device}) {CHAIN_IMAGES} images in frames of "
                  f"{MICROBATCH}: boot {boot_s:.2f} s, deploy "
                  f"{deploy_s:.2f} s, first stream to its last result "
                  f"{lzb_first_s:.2f} s (spawn to the last result "
                  f"{secs:.2f} s), {rel:.3g} of max |logit| off the "
                  f"forward, top-1 equal, node launches "
                  f"{res['resnet50_lzb']['launches']}; on {card}",
                  flush=True)
            # c: the segment ends, the same nodes take raw hops
            disp.end_stream()
            t0 = time.perf_counter()
            disp.codec = "raw"
            disp.deploy(stages, params, addrs, batch=MICROBATCH,
                        codecs=["raw"] * len(stages),
                        tiers=["tcp"] * len(stages))
            redeploy_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            raw = np.stack(disp.stream(frames))
            first_s = time.perf_counter() - t0
            raw_rel = check_rows(raw, "resnet50 raw chain")
            if not np.array_equal(raw, lzb):
                fail("phase 4k: raw rows differ from lzb rows (lzb is "
                     "lossless)")
            st = disp.stats(addrs)
            check_nodes(st, 2 * n_frames, "raw chain")
            if [s["codec"] for s in st] != ["raw"] * len(stages):
                fail(f"phase 4k: the redeploy left hop codecs "
                     f"{[s['codec'] for s in st]}")
            chain_w, ring_w, outs, ring_out = timed_rounds(
                lambda: disp.stream(timed), lambda: pipe.run(tbatch))
            cyc = np.arange(CHAIN_TIMED_FRAMES) % n_frames
            if not np.array_equal(outs, raw[cyc]):
                fail("phase 4k: a timed stream's rows differ from the "
                     "first stream's")
            ring_rel = _rel_err(np.asarray(ring_out), ref[cyc],
                                "resnet50 ring timed run",
                                BUFFER_REL_BOUND)
            res["obs_resnet50"] = obs_resnet(torch, chain, timed, raw[cyc],
                                             card)
            res["obs_resnet50"]["node_trace"] = node_trace(
                torch, chain, timed, raw[cyc], card)
            door = ServeFrontDoor(backend=ChainBackend(
                disp, MICROBATCH, g.input_spec.shape)).start()
            images = batch.reshape((-1,) + tuple(g.input_spec.shape))
            flat_ref = ref.reshape(-1, ref.shape[-1])
            tenants = {"tensor_a": range(0, DOOR_IMAGES),
                       "tensor_b": range(DOOR_IMAGES, 2 * DOOR_IMAGES)}
            got, errs = {}, []

            def go(t):
                try:
                    got[t] = ServeClient(*door.address, t,
                                         timeout_s=300).stream(
                        [images[i] for i in tenants[t]])
                except Exception as e:  # noqa: BLE001 — failed below
                    errs.append(f"{t}: {e!r}")

            cts = [threading.Thread(target=go, args=(t,), daemon=True)
                   for t in tenants]
            t0 = time.perf_counter()
            for t in cts:
                t.start()
            for t in cts:
                t.join(timeout=300)
            door_s = time.perf_counter() - t0
            if errs or any(t.is_alive() for t in cts):
                fail(f"phase 4k door clients failed: {errs or 'a hang'}")
            door_rel = 0.0
            for t, idx in tenants.items():
                for i, r in zip(idx, got[t]):
                    if r[0] != "ok":
                        fail(f"phase 4k door: tenant {t} image {i}: {r}")
                    door_rel = max(door_rel, _rel_err(
                        np.asarray(r[1]), flat_ref[i],
                        f"door {t} image {i}", BUFFER_REL_BOUND))
            door.healthcheck()
            st = disp.stats(addrs)
            # phase 4q d: the serve command over the same processes; the
            # door's stop closes this dispatcher and ends the segment
            door.stop()
            door = None
            res["cli_serve"] = cli_serve(
                torch, kernels, chain, mp, 0.5 * CHAIN_TIMED_FRAMES
                * MICROBATCH / statistics.median(chain_w), card)
        finally:
            t0 = time.perf_counter()
            if door is not None:
                door.stop()  # closes the dispatcher: END cascades
    # leaving deploy_chain closed the dispatcher and waited for every node
    # to exit 0 after END
    exit_s = time.perf_counter() - t0
    t_images = CHAIN_TIMED_FRAMES * MICROBATCH
    chain_ips = t_images / statistics.median(chain_w)
    ring_ips = t_images / statistics.median(ring_w)
    res["resnet50_raw"] = {
        "rel_err": raw_rel, "ring_rel_err": ring_rel, "boot_s": boot_s,
        "deploy_s": deploy_s, "redeploy_s": redeploy_s,
        "first_stream_to_last_result_s": first_s,
        "exit_s": exit_s, "chain_images_per_s": chain_ips,
        "ring_images_per_s": ring_ips, "timed_images": t_images,
        "chain_walls_s": chain_w, "ring_walls_s": ring_w,
        "door_images": 2 * DOOR_IMAGES, "door_s": door_s,
        "door_rel_err": door_rel, "launches": _sum_launches(st),
        "node_infer_p50_ms": [s["infer_latency_s"]["p50"] * 1e3
                              for s in st],
        "node_host_sync_p50_ms": [s["host_sync_s"]["p50"] * 1e3
                                  for s in st]}
    print(f"chain path: resnet50 in {len(stages)} processes (raw hops, "
          f"rows {raw_rel:.3g} of max |logit| off the forward and equal "
          f"to lzb's): redeployed in-band in {redeploy_s:.2f} s, first "
          f"stream of {n_frames} frames to its last result {first_s:.2f} s, "
          f"exit after END {exit_s:.2f} s; {chain_ips:.1f} images/s through "
          f"the chain against {ring_ips:.1f} through the ring pipeline "
          f"(buffer wire), median of {CHAIN_ROUNDS} alternating rounds of "
          f"{CHAIN_TIMED_FRAMES} frames ({t_images} images); the door "
          f"served 2 tenants x {DOOR_IMAGES} images in {door_s:.2f} s, "
          f"{door_rel:.3g} of max |logit| off the forward; on {card}",
          flush=True)
    del pipe
    free_card(torch)

    # --- b: BERT-Base/12, in-process nodes ------------------------------
    bg, bparams = bp["graph"], bp["params"]
    blocks = sum(name.startswith("block_") for name in bg.topo_order)
    b_frames = CHAIN_SEQS // MICROBATCH
    all_ids = [x.astype(np.int32) for x in bp["inputs"]]
    ids = all_ids[:b_frames]
    timed_ids = [all_ids[i % len(all_ids)]
                 for i in range(CHAIN_TIMED_FRAMES)]
    bref = bp["ref"][:b_frames]
    params2 = tree_map(lambda v: v * 0.5, bparams)
    pdev2 = params_to_device(params2, device)
    with torch.inference_mode():
        bref2 = np.stack([bg.apply(pdev2, torch.from_numpy(x).to(device))
                          .cpu().numpy() for x in all_ids])
    del pdev2
    bring = Defer(DeferConfig(wire="buffer", microbatch=MICROBATCH,
                              chunk=CHUNK, device=device)).build(
        bg, params2, bp["cuts"])
    bbatch = np.stack(timed_ids)
    bring.run(bbatch[:b_frames])  # captures the chunk graphs
    nodes = [StageNode(None, "127.0.0.1:0", None, device=device)
             for _ in bstages]
    addrs = [f"127.0.0.1:{nd.address[1]}" for nd in nodes]
    served = {}

    def serve(i):
        served[i] = nodes[i].serve()

    ths = [threading.Thread(target=serve, args=(i,), daemon=True)
           for i in range(len(nodes))]
    for t in ths:
        t.start()
    disp = ChainDispatcher(addrs[0])
    want = {"flash_attention": blocks * b_frames, "quant_int8": 0}
    try:
        t0 = time.perf_counter()
        disp.deploy(bstages, bparams, addrs, batch=MICROBATCH)
        deploy_s = time.perf_counter() - t0
        zero_counts(kernels)
        t0 = time.perf_counter()
        outs = disp.stream(ids)
        stream_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        st = disp.stats(addrs)
        node_flash = {s["kernel_launches"]["flash_attention"] for s in st}
        print(f"chain path: bert_base in {len(bstages)} in-process nodes on "
              f"{device}: deploy {deploy_s:.2f} s, first stream of "
              f"{b_frames} frames ({CHAIN_SEQS} sequences) to its last "
              f"result in {stream_s:.3f} s; launches {launches}, nodes' "
              f"count {sorted(node_flash)}", flush=True)
        if launches != want or node_flash != {want["flash_attention"]}:
            fail(f"phase 4k: bert chain launches {launches}, nodes "
                 f"{node_flash}; want {want} ({blocks} per frame)")
        brel = _rel_err(np.stack(outs), bref, "bert chain",
                        BUFFER_REL_BOUND)
        disp.reweight(bstages, params2, addrs)
        zero_counts(kernels)
        t0 = time.perf_counter()
        outs2 = disp.stream(ids)
        stream2_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches2 = read_counts(kernels)
        if launches2 != want:
            fail(f"phase 4k: bert chain after reweight launched {launches2}")
        zero_counts(kernels)
        b_chain_w, b_ring_w, outs3, ring3 = timed_rounds(
            lambda: disp.stream(timed_ids), lambda: bring.run(bbatch))
        launches3 = read_counts(kernels)
        st2 = disp.stats(addrs)
        b_total = 2 * b_frames + CHAIN_ROUNDS * CHAIN_TIMED_FRAMES
        bad = [(s["stage"], s["processed"], s["reweights"], s["device"])
               for s in st2 if s["processed"] != b_total
               or s["reweights"] != 1 or not s["device"].startswith(device)]
        if bad:
            fail(f"phase 4k: bert chain (stage, processed, reweights, "
                 f"device) after reweight: {bad}")
        res["obs_bert_base"] = obs_bert(torch, disp, addrs, ids, blocks,
                                        card)
        b_total += len(ids)
    finally:
        disp.close()
    for t in ths:
        t.join(timeout=60)
    if any(t.is_alive() for t in ths) or served != {
            i: b_total for i in range(len(nodes))}:
        fail(f"phase 4k: bert chain nodes did not drain: {served}")
    brel2 = _rel_err(np.stack(outs2), bref2[:b_frames],
                     "bert chain reweight", BUFFER_REL_BOUND)
    cyc2 = bref2[np.arange(CHAIN_TIMED_FRAMES) % len(all_ids)]
    brel3 = _rel_err(outs3, cyc2, "bert chain timed stream",
                     BUFFER_REL_BOUND)
    _rel_err(np.asarray(ring3), cyc2, "bert ring timed run",
             BUFFER_REL_BOUND)
    # one flash launch per block per chain frame, and per ring step (the
    # ring's fill and drain steps included)
    ring_steps = CHUNK * -(-(CHAIN_TIMED_FRAMES + len(bstages) - 1) // CHUNK)
    want3 = {"flash_attention": blocks * CHAIN_ROUNDS * (CHAIN_TIMED_FRAMES
                                                         + ring_steps),
             "quant_int8": 0}
    if launches3 != want3:
        fail(f"phase 4k: bert timed rounds launched {launches3}, want "
             f"{want3} ({blocks} per chain frame and per ring step)")
    b_seqs = CHAIN_TIMED_FRAMES * MICROBATCH
    b_chain_sps = b_seqs / statistics.median(b_chain_w)
    b_ring_sps = b_seqs / statistics.median(b_ring_w)
    res["bert_base"] = {
        "stages": len(bstages), "frames": b_frames, "deploy_s": deploy_s,
        "first_stream_to_last_result_s": stream_s,
        "stream_after_reweight_to_last_result_s": stream2_s,
        "chain_sequences_per_s": b_chain_sps,
        "ring_sequences_per_s": b_ring_sps,
        "chain_walls_s": b_chain_w, "ring_walls_s": b_ring_w,
        "rel_err": brel, "rel_err_after_reweight": brel2,
        "rel_err_timed": brel3, "launches": launches,
        "launches_after_reweight": launches2,
        "launches_timed_rounds": launches3,
        "node_infer_p50_ms": [s["infer_latency_s"]["p50"] * 1e3
                              for s in st2]}
    print(f"chain path: bert chain {brel:.3g} of max |output| off phase "
          f"4b's forward; after reweight {brel2:.3g} off the forward on the "
          f"new weights ({b_frames} frames to the last result in "
          f"{stream2_s:.3f} s); {b_chain_sps:.1f} seq/s through the chain "
          f"against {b_ring_sps:.1f} through the ring pipeline (buffer "
          f"wire), median of {CHAIN_ROUNDS} alternating rounds of "
          f"{CHAIN_TIMED_FRAMES} frames ({b_seqs} sequences), chain rows "
          f"{brel3:.3g} off the forward; on {card}", flush=True)
    brows = np.stack(outs)
    del nodes, disp, bring
    free_card(torch)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"chain path: phase 4k {res['seconds']:.1f} s; on {card}",
          flush=True)
    return res, raw, brows


# ---------------------------------------------------------------------------
# phase 4l: the colocated transport tiers
# ---------------------------------------------------------------------------

#: slots of each shm ring (the nodes' and the dispatcher's tx depth); lowered
#: only when /dev/shm cannot hold the rings at this depth, and then printed
SHM_DEPTH = 8
#: frames through the refusal check's two-node chain
REFUSAL_FRAMES = 4


def dev_shm() -> dict:
    """/dev/shm's size and free bytes."""
    import os

    try:
        st = os.statvfs("/dev/shm")
    except OSError as e:
        fail(f"phase 4l: no /dev/shm on this host ({e})")
    return {"bytes": st.f_blocks * st.f_frsize,
            "free_bytes": st.f_bavail * st.f_frsize}


def ring_bytes(frame_bytes, depth: int) -> int:
    """What the shm rings of hops carrying ``frame_bytes`` take at
    ``depth`` slots: a slot is 1 MiB or the frame rounded up to a power of
    two (``ShmSender._grow``)."""
    return depth * sum(max(1 << 20, 1 << max(6, (int(b) - 1).bit_length()))
                       for b in frame_bytes)


def shm_depth(frame_bytes, free: int) -> int:
    """SHM_DEPTH, or the deepest ring from 2 up that 90% of /dev/shm's free
    bytes hold; fails when not even 2 slots fit."""
    for depth in range(SHM_DEPTH, 1, -1):
        if ring_bytes(frame_bytes, depth) <= 0.9 * free:
            if depth < SHM_DEPTH:
                print(f"colocate path: /dev/shm has {free / 2**20:.0f} MiB "
                      f"free; the shm rings take {depth} slots, not "
                      f"{SHM_DEPTH} ({ring_bytes(frame_bytes, depth) / 2**20:.0f} "
                      f"MiB)", flush=True)
            return depth
    fail(f"phase 4l: /dev/shm has {free} bytes free; the shm rings need "
         f"{ring_bytes(frame_bytes, 2)} at 2 slots")


def _node_phases(stats) -> dict:
    """Per node: infer, host_sync, dispatch, queue and device p50 in ms,
    and the host_sync sample count."""
    out = {"host_sync_count": [s["host_sync_s"]["count"] for s in stats]}
    for name, key in (("infer", "infer_latency_s"),
                      ("host_sync", "host_sync_s"), ("dispatch", "dispatch_s"),
                      ("queue", "queue_s"), ("device", "device_s")):
        out[f"{name}_p50_ms"] = [s[key].get("p50", 0.0) * 1e3 for s in stats]
    return out


def colocate_path(torch, device, kernels, card, mp, bp, ch, raw,
                  ahead_of=()):
    """Phase 4l: the colocated transport tiers on the card, beside phase
    4k's tcp chains.  a: ResNet50/8 (4a's cuts, f32, frames of MICROBATCH)
    as eight node processes on ``tier="auto"``: every hop (the
    dispatcher's edges too) must report shm with no fallback, rows
    byte-identical to 4k's raw rows, top-1 equal; timed on
    CHAIN_TIMED_FRAMES-frame streams in alternating rounds with the ring.
    b: the same model with ``hop_tiers=["ici"] * 7``: one node process,
    seven ``--co-stage`` threads, every inter-stage hop ici, no host sync
    on the seven nodes whose outbound hop is ici (the last node's is the
    shm edge to the dispatcher's process), rows within BUFFER_REL_BOUND,
    top-1 equal; timed as a.  c: BERT-Base/12 as twelve in-process nodes
    on ici hops (the dispatcher in the same process takes the result edge
    on ici too): 12 flash launches per frame by the smoke's counts and
    every node's, no host sync on any node, rows within BUFFER_REL_BOUND
    of 4b's forward; timed beside 4k's in-process chain; then fused into
    two programs (``device`` hops inside each half, ici between): 12
    flash launches per frame.  d: ResNet50/8 with ``hop_tiers=["device"]
    * 3 + ["shm"] + ["device"] * 3`` through ``run_chain``: two fused
    processes, one shm hop, rows as a's.  e: ``resnet_tiny`` in two in-process
    nodes, stage 0 pinned to shm into a stage 1 that refuses every offer
    (``tier_accept=False``, what ``--tier-accept 0`` sets): the hop runs
    over tcp with one labeled fallback and a ``tier`` event in stage 0's
    flight recorder, rows equal to the forward.  d runs on a thread while
    b's process boots and deploys (host work in other processes), and ends
    before b streams."""
    import threading

    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig, models
    from defer_tpu_torch.obs.events import recorder
    from defer_tpu_torch.partition import fuse_stages, partition
    from defer_tpu_torch.runtime.node import (ChainDispatcher, StageNode,
                                              deploy_chain, run_chain)
    from defer_tpu_torch.utils.convert import params_to_device

    shm = dev_shm()
    print(f"colocate path: /dev/shm {shm['bytes'] / 2**30:.2f} GiB, "
          f"{shm['free_bytes'] / 2**30:.2f} GiB free", flush=True)
    res = {"card": card, "dev_shm": shm, "timed_frames": CHAIN_TIMED_FRAMES,
           "cross_device": "not run: 1 card"}
    t_phase = time.perf_counter()
    g, params, cuts = mp["graph"], mp["params"], mp["cuts"]
    stages = partition(g, cuts)
    n = len(stages)
    n_frames = CHAIN_IMAGES // MICROBATCH
    frames = [mp["inputs"][i] for i in range(n_frames)]
    ref = mp["ref"][:n_frames]
    timed = [frames[i % n_frames] for i in range(CHAIN_TIMED_FRAMES)]
    cyc = np.arange(CHAIN_TIMED_FRAMES) % n_frames
    t_images = CHAIN_TIMED_FRAMES * MICROBATCH
    frame_bytes = ([MICROBATCH * math.prod(s.in_spec.shape) * 4
                    for s in stages]
                   + [MICROBATCH * math.prod(stages[-1].out_spec.shape) * 4])
    depth = shm_depth(frame_bytes, shm["free_bytes"])
    res["shm_depth"] = depth
    res["shm_ring_bytes"] = ring_bytes(frame_bytes, depth)
    pipe = Defer(DeferConfig(wire="buffer", microbatch=MICROBATCH,
                             chunk=CHUNK, device=device)).build(g, params,
                                                                cuts)
    tbatch = np.stack(timed)
    pipe.run(tbatch[:n_frames])  # captures the chunk graphs

    def check_rows(out, what, exact=None):
        rel = _rel_err(out, ref, f"4l {what}", BUFFER_REL_BOUND)
        if not (out.argmax(-1) == ref.argmax(-1)).all():
            fail(f"phase 4l: the {what} changed a top-1 class")
        if exact is not None and not np.array_equal(out, exact):
            fail(f"phase 4l: the {what} rows differ from phase 4k's raw "
                 f"tcp rows")
        return rel

    def timed_chain(chain, what):
        """Alternating rounds of the chain's stream and the ring's run of
        the same frames; images/s of each (median round)."""
        disp = chain.dispatcher
        chain_w, ring_w = [], []
        for _ in range(CHAIN_ROUNDS):
            t0 = time.perf_counter()
            outs = np.stack(disp.stream(timed))
            chain_w.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.run(tbatch)
            torch.cuda.synchronize()
            ring_w.append(time.perf_counter() - t0)
        if not np.array_equal(outs, first[what][cyc]):
            fail(f"phase 4l {what}: a timed stream's rows differ from the "
                 f"first stream's")
        return {"chain_images_per_s": t_images / statistics.median(chain_w),
                "ring_images_per_s": t_images / statistics.median(ring_w),
                "chain_walls_s": chain_w, "ring_walls_s": ring_w}

    first: dict = {}
    # c's and d's fused programs trace while a's processes boot
    bg, bparams = bp["graph"], bp["params"]
    bstages = partition(bg, bp["cuts"])
    bhalf, half = len(bstages) // 2, n // 2
    bfused, _ = fuse_stages(bstages, ["device"] * (bhalf - 1) + ["ici"]
                            + ["device"] * (len(bstages) - bhalf - 1))
    rtiers = ["device"] * (half - 1) + ["shm"] + ["device"] * (n - half - 1)
    ahead = trace_ahead((bfused, bparams),
                        (fuse_stages(stages, rtiers)[0], params))

    # --- a: ResNet50/8, eight processes, the auto ladder -> shm ----------
    with deploy_chain(stages, params, batch=MICROBATCH, in_band=True,
                      tier="auto", tx_depth=depth, device=device) as chain:
        # the traces are done before anything is timed
        ahead.join()
        disp = chain.dispatcher
        t0 = time.perf_counter()
        out = np.stack(disp.stream(frames))
        first_s = time.perf_counter() - t0
        first["shm"] = out
        rel = check_rows(out, "shm chain", exact=raw)
        st = disp.stats(chain.addrs)
        hops = [s["tier"] for s in st]
        if (hops != ["shm"] * n or [s["tier_in"] for s in st] != ["shm"] * n
                or any(s["tier_fallbacks"] for s in st)
                or (disp.tier_out, disp.tier_in) != ("shm", "shm")):
            fail(f"phase 4l shm chain: hops {hops}, inbound "
                 f"{[s['tier_in'] for s in st]}, fallbacks "
                 f"{[s['tier_fallbacks'] for s in st]}, dispatcher "
                 f"{disp.tier_out}/{disp.tier_in} (want shm everywhere, 0 "
                 f"fallbacks)")
        rates = timed_chain(chain, "shm")
        st = disp.stats(chain.addrs)
        # phase 4m fits the planner's constants from these
        res["shm_stats"] = st
        res["shm"] = {"hops": ["shm"] + hops, "rel_err": rel,
                      "byte_identical_to_tcp": True,
                      "boot_s": chain.boot_s, "deploy_s": chain.deploy_s,
                      "first_stream_to_last_result_s": first_s,
                      "launches": _sum_launches(st), **rates,
                      **_node_phases(st)}
    r = res["shm"]
    print(f"colocate path: resnet50 in {n} processes on shm hops (depth "
          f"{depth}; rows byte-identical to 4k's tcp rows): boot "
          f"{r['boot_s']:.2f} s, deploy {r['deploy_s']:.2f} s, first stream "
          f"{first_s:.2f} s; {r['chain_images_per_s']:.1f} images/s through "
          f"the chain against {r['ring_images_per_s']:.1f} through the ring "
          f"and {ch['resnet50_raw']['chain_images_per_s']:.1f} through 4k's "
          f"tcp chain; host_sync p50 ms "
          f"{[round(v, 3) for v in r['host_sync_p50_ms']]}; on {card}",
          flush=True)

    # --- d, started here: ResNet50/8 fused into two processes, one shm hop,
    # through run_chain; it runs while b's process boots and deploys and is
    # done before b streams anything
    fused: dict = {}

    def run_fused():
        stats = []
        t0 = time.perf_counter()
        try:
            fused["out"] = np.stack(run_chain(
                stages, params, frames, batch=MICROBATCH, in_band=True,
                tx_depth=depth, device=device, hop_tiers=rtiers,
                stats_out=stats))
        except Exception as e:  # noqa: BLE001 — failed after the join
            fused["error"] = e
        fused["secs"], fused["stats"] = time.perf_counter() - t0, stats

    fused_th = threading.Thread(target=run_fused, daemon=True,
                                name="chip-4l-fused")
    fused_th.start()

    # --- b: ResNet50/8, one process, seven ici hops ----------------------
    # one process boots here, beside seven idle cores: ``ahead_of`` (phase
    # 4o's stage programs) traces meanwhile, and d runs
    ahead = trace_ahead(*ahead_of)
    with deploy_chain(stages, params, batch=MICROBATCH, in_band=True,
                      hop_tiers=["ici"] * (n - 1), tier="auto",
                      tx_depth=depth, device=device) as chain:
        # the traces and d are done before anything is timed
        ahead.join()
        fused_th.join()
        if "error" in fused:
            fail(f"phase 4l fused chain: {fused['error']!r}")
        disp = chain.dispatcher
        t0 = time.perf_counter()
        out = np.stack(disp.stream(frames))
        first_s = time.perf_counter() - t0
        first["ici"] = out
        rel = check_rows(out, "ici chain")
        st = disp.stats(chain.addrs)
        hops = [s["tier"] for s in st]
        syncs = [s["host_sync_s"]["count"] for s in st]
        if (len(chain.procs) != 1 or hops != ["ici"] * (n - 1) + ["shm"]
                or [s["tier_in"] for s in st[1:]] != ["ici"] * (n - 1)
                or syncs != [0] * (n - 1) + [n_frames]
                or any(s["tier_fallbacks"] for s in st)):
            fail(f"phase 4l ici chain: {len(chain.procs)} processes, hops "
                 f"{hops}, host_sync counts {syncs} (want one process, ici "
                 f"on every inter-stage hop and 0 host syncs before the "
                 f"last node's shm edge)")
        rates = timed_chain(chain, "ici")
        st = disp.stats(chain.addrs)
        res["ici"] = {"hops": [disp.tier_out] + hops, "rel_err": rel,
                      "byte_identical_to_tcp": bool(np.array_equal(out, raw)),
                      "processes": len(chain.procs), "boot_s": chain.boot_s,
                      "deploy_s": chain.deploy_s,
                      "first_stream_to_last_result_s": first_s,
                      "launches": st[0]["kernel_launches"], **rates,
                      **_node_phases(st)}
    r = res["ici"]
    print(f"colocate path: resnet50 in one process, {n - 1} ici hops "
          f"(rows {rel:.3g} of max |logit| off the forward, byte-identical "
          f"to tcp: {r['byte_identical_to_tcp']}): boot {r['boot_s']:.2f} s, "
          f"deploy {r['deploy_s']:.2f} s; {r['chain_images_per_s']:.1f} "
          f"images/s against {r['ring_images_per_s']:.1f} through the ring; "
          f"host_sync counts {r['host_sync_count']}; dispatch p50 ms "
          f"{[round(v, 3) for v in r['dispatch_p50_ms']]}, device p50 ms "
          f"{[round(v, 3) for v in r['device_p50_ms']]}; on {card}",
          flush=True)
    del pipe
    free_card(torch)

    # --- c: BERT-Base/12 in-process on ici hops, then fused in two -------
    blocks = sum(name.startswith("block_") for name in bg.topo_order)
    b_frames = CHAIN_SEQS // MICROBATCH
    all_ids = [x.astype(np.int32) for x in bp["inputs"]]
    ids = all_ids[:b_frames]
    timed_ids = [all_ids[i % len(all_ids)]
                 for i in range(CHAIN_TIMED_FRAMES)]
    bref = bp["ref"]

    def bert_chain(stages_, label):
        nodes = [StageNode(None, "127.0.0.1:0", None, device=device,
                           tier="ici") for _ in stages_]
        addrs = [f"127.0.0.1:{nd.address[1]}" for nd in nodes]
        ths = [threading.Thread(target=nd.serve, daemon=True)
               for nd in nodes]
        for t in ths:
            t.start()
        disp = ChainDispatcher(addrs[0], tier="auto")
        out = {}
        try:
            t0 = time.perf_counter()
            disp.deploy(stages_, bparams, addrs, batch=MICROBATCH)
            out["deploy_s"] = time.perf_counter() - t0
            zero_counts(kernels)
            outs = disp.stream(ids)
            torch.cuda.synchronize()
            launches = read_counts(kernels)
            st = disp.stats(addrs)
            node_flash = {s["kernel_launches"]["flash_attention"]
                          for s in st}
            want = {"flash_attention": blocks * b_frames, "quant_int8": 0}
            hops = [s["tier"] for s in st]
            syncs = [s["host_sync_s"]["count"] for s in st]
            if (launches != want or node_flash != {want["flash_attention"]}
                    or hops != ["ici"] * len(stages_)
                    or syncs != [0] * len(stages_)
                    or disp.tier_in != "ici"):
                fail(f"phase 4l {label}: launches {launches} (nodes "
                     f"{node_flash}), hops {hops}, result edge "
                     f"{disp.tier_in}, host_sync counts {syncs}; want "
                     f"{want}, ici everywhere, 0 host syncs")
            out["rel_err"] = _rel_err(np.stack(outs), bref[:b_frames],
                                      f"4l {label}", BUFFER_REL_BOUND)
            out["launches"] = launches
            out["hops"] = [disp.tier_out] + hops
            walls = []
            for _ in range(CHAIN_ROUNDS):
                t0 = time.perf_counter()
                touts = np.stack(disp.stream(timed_ids))
                walls.append(time.perf_counter() - t0)
            _rel_err(touts, bref[np.arange(CHAIN_TIMED_FRAMES)
                                 % len(all_ids)],
                     f"4l {label} timed stream", BUFFER_REL_BOUND)
            st = disp.stats(addrs)
            out["chain_sequences_per_s"] = (CHAIN_TIMED_FRAMES * MICROBATCH
                                            / statistics.median(walls))
            out["chain_walls_s"] = walls
            out.update(_node_phases(st))
        finally:
            disp.close()
        for t in ths:
            t.join(timeout=60)
        if any(t.is_alive() for t in ths):
            fail(f"phase 4l {label}: nodes did not drain")
        return out

    res["bert_ici"] = r = bert_chain(bstages, "bert ici chain")
    print(f"colocate path: bert_base in {len(bstages)} in-process nodes on "
          f"ici hops: {r['rel_err']:.3g} of max |output| off 4b's forward, "
          f"launches {r['launches']}, host_sync 0 on every node; "
          f"{r['chain_sequences_per_s']:.1f} seq/s against 4k's tcp chain "
          f"{ch['bert_base']['chain_sequences_per_s']:.1f} and ring "
          f"{ch['bert_base']['ring_sequences_per_s']:.1f}; dispatch p50 ms "
          f"{[round(v, 2) for v in r['dispatch_p50_ms']]}, device p50 ms "
          f"{[round(v, 2) for v in r['device_p50_ms']]}; on {card}",
          flush=True)
    res["bert_fused"] = r = bert_chain(bfused, "bert fused chain")
    print(f"colocate path: bert_base fused into {len(bfused)} programs "
          f"(device hops, ici between): {r['rel_err']:.3g} off the forward, "
          f"launches {r['launches']}; {r['chain_sequences_per_s']:.1f} "
          f"seq/s; on {card}", flush=True)
    free_card(torch)

    # --- d: ResNet50/8 fused into two processes, one shm hop (ran beside
    # b's boot and deploy) ---------------------------------------------------
    out, stats, secs = fused["out"], fused["stats"], fused["secs"]
    rel = check_rows(out, "fused chain", exact=raw)
    if ([s["tier"] for s in stats] != ["shm", "shm"]
            or stats[1]["tier_in"] != "shm"
            or [s["processed"] for s in stats] != [n_frames] * 2):
        fail(f"phase 4l fused chain: {len(stats)} nodes, hops "
             f"{[s['tier'] for s in stats]} (want two fused processes and "
             f"one shm hop between them)")
    res["fused"] = {"processes": len(stats), "rel_err": rel,
                    "byte_identical_to_tcp": True,
                    "spawn_deploy_stream_s": secs,
                    "hops": [s["tier"] for s in stats],
                    "launches": _sum_launches(stats), **_node_phases(stats)}
    print(f"colocate path: resnet50 fused into 2 processes, one shm hop: "
          f"rows {rel:.3g} of max |logit| off the forward, byte-identical "
          f"to 4k's tcp rows; run_chain {secs:.2f} s (beside b's boot and "
          f"deploy); on {card}", flush=True)

    # --- e: a refused offer ---------------------------------------------
    tg = models.resnet_tiny()
    tparams = tg.init(torch.Generator().manual_seed(SEED))
    tstages = partition(tg, num_stages=2)
    txs = [np.random.default_rng(SEED + 1).standard_normal(
        (MICROBATCH, 32, 32, 3)).astype(np.float32)
        for _ in range(REFUSAL_FRAMES)]
    # stage 0 offers shm alone; stage 1 refuses every offer, as a node
    # started with --tier-accept 0 does (in-process nodes: the same code
    # path, without two process boots; they share this process's flight
    # recorder, so the events are read from the cursor on)
    cursor = recorder().cursor()
    tnodes = [StageNode(None, "127.0.0.1:0", None, device=device,
                        tier="shm"),
              StageNode(None, "127.0.0.1:0", None, device=device,
                        tier="tcp", tier_accept=False)]
    taddrs = [f"127.0.0.1:{nd.address[1]}" for nd in tnodes]
    tths = [threading.Thread(target=nd.serve, daemon=True) for nd in tnodes]
    for t in tths:
        t.start()
    disp = ChainDispatcher(taddrs[0])
    try:
        disp.deploy(tstages, tparams, taddrs, batch=MICROBATCH)
        outs = disp.stream(txs)
        st = disp.stats(taddrs)
    finally:
        disp.close()
    for t in tths:
        t.join(timeout=60)
    if any(t.is_alive() for t in tths):
        fail("phase 4l refusal: the nodes did not drain")
    tpdev = params_to_device(tparams, device)
    with torch.inference_mode():
        tref = np.stack([tg.apply(tpdev, torch.from_numpy(x).to(device))
                         .cpu().numpy() for x in txs])
    rel = float(np.abs(np.stack(outs) - tref).max()
                / np.abs(tref).max())
    evs = recorder().events_since(cursor)[1]
    tier_evs = [e["data"] for e in evs if e["kind"] == "tier"]
    fb_evs = [e["data"] for e in evs if e["kind"] == "tier_fallback"]
    if (st[0]["tier"] != "tcp" or st[0]["tier_fallbacks"] != 1
            or st[1]["tier_in"] != "tcp" or rel > BUFFER_REL_BOUND
            or fb_evs != [{"hop": "stage0"}]
            or tier_evs != [{"hop": "stage0", "tier": "tcp", "wanted": "shm",
                             "fallback": True}]):
        fail(f"phase 4l refusal: stage 0 tier {st[0]['tier']}, fallbacks "
             f"{st[0]['tier_fallbacks']}, stage 1 inbound {st[1]['tier_in']}, "
             f"events {tier_evs} {fb_evs}, rows {rel:.3g} off (want tcp, one "
             f"labeled fallback and one tier event)")
    res["refusal"] = {"hop": st[0]["tier"], "fallbacks": st[0]["tier_fallbacks"],
                      "tier_event": tier_evs[0], "fallback_event": fb_evs[0],
                      "rel_err": rel}
    print(f"colocate path: a shm offer into a node that refuses offers "
          f"(tier_accept=False) ran over {st[0]['tier']} with "
          f"{st[0]['tier_fallbacks']} labeled fallback (events "
          f"{tier_evs[0]}, {fb_evs[0]}); rows {rel:.3g} off the forward",
          flush=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"colocate path: phase 4l {res['seconds']:.1f} s; on {card}",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 4m: the planner on the card
# ---------------------------------------------------------------------------

#: measured_node_costs: calls per graph replay (16, half the reference's
#: scan length, to pay for phase 4t's training) and timed replays per node
PLAN_K = 16
PLAN_REPS = 3
#: alternating timed rounds of the ring at the solved and the paper's cuts,
#: each a run of PLAN_RING_REPEAT x phase 4a's microbatches
PLAN_ROUNDS = 1
PLAN_RING_REPEAT = 4
#: frames of BERT-Base before and after the live cutover
CUTOVER_FRAMES = (4, 4)


def planner_path(torch, device, kernels, card, mp, bp, shm_stats):
    """Phase 4m.  1: ``utils.hw.identify_chip`` must name the card
    ``"h100"`` and a ``StageCostModel`` with no ``gen`` must take its
    data-sheet peaks.  2: ``measured_node_costs`` on the card for ResNet50
    (f32) and BERT-Base (f32 and bf16) at batch MICROBATCH, each node's
    PLAN_K calls one CUDA-graph replay: every cost > 0 and finite, the
    flash counter moved by blocks x PLAN_K x (PLAN_REPS + 1) (one warm
    and PLAN_REPS timed replays) on BERT and not at all on ResNet50; the
    sum of node costs beside the forward of the same batch.  3: three
    8-stage cut lists for ResNet50 priced by ``evaluate_cuts`` on the
    h100 model with the measured costs (``solve``, quantile
    ``auto_cut_points``, the paper's); ``Defer.run`` on the int8 wire at
    the solved and the paper's cuts (phase 4a's bar, one quantizer launch
    per step), then alternating timed rounds of both rings.  4:
    ``fit_from_stats`` on phase 4l's shm chain: the host-sync bandwidth
    must be ``measured``; save/load, ``apply``, and the per-stage service
    prediction beside the nodes' p50s.  5: the live cutover on BERT-Base:
    three persistent in-process nodes at ``solve(..., 3)``'s cuts, a
    first segment, ``replan`` on the nodes' measured stage seconds (a
    corrected hotspot forces the move when the real suggestion keeps the
    cuts), ``ReplanResult.apply(LiveReplan(...))``, a second segment; the
    stream byte-identical to two undisturbed chains (old cuts, then new),
    ``quiesced`` equal to the first segment's length on every stage, 12
    flash launches a frame."""
    import tempfile
    import threading

    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig
    from defer_tpu_torch.graph.analysis import auto_cut_points
    from defer_tpu_torch.graph.ir import tree_map
    from defer_tpu_torch.partition import partition
    from defer_tpu_torch.plan import (CalibratedConstants, StageCostModel,
                                      evaluate_cuts, fit_from_stats,
                                      measured_stage_seconds,
                                      predict_stage_service_s, replan,
                                      solve)
    from defer_tpu_torch.plan.replan import LiveReplan
    from defer_tpu_torch.runtime.cuda_graph import capture
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode
    from defer_tpu_torch.utils import hw
    from defer_tpu_torch.utils.profiling import measured_node_costs

    t_phase = time.perf_counter()
    res = {"card": card, "k": PLAN_K, "reps": PLAN_REPS}
    g, params = mp["graph"], mp["params"]
    bg, bparams = bp["graph"], bp["params"]
    blocks = sum(name.startswith("block_") for name in bg.topo_order)

    # --- 1: the card and its row ------------------------------------------
    gen = hw.identify_chip(torch.device(device))
    auto = StageCostModel(g)
    print(f"planner path: identify_chip -> {gen!r} for "
          f"{torch.cuda.get_device_name(0)!r}; StageCostModel() gen "
          f"{auto.gen!r}, peak {auto.peak_flops_s:.4g} FLOP/s, HBM "
          f"{auto.hbm_bw_s:.4g} B/s, link {auto.link_bw_s:.4g} B/s; on "
          f"{card}", flush=True)
    if gen != "h100" or auto.gen != "h100" or \
            (auto.peak_flops_s, auto.hbm_bw_s) != (989e12, 3.35e12):
        fail(f"phase 4m: the card was identified as {gen!r} (cost model "
             f"{auto.gen!r}, peaks {auto.peak_flops_s}, {auto.hbm_bw_s}); "
             "want 'h100' with 989e12 FLOP/s and 3.35e12 B/s")
    res["gen"] = gen

    # --- 2: measured node costs -------------------------------------------
    def forward_ms(graph, pdev, x, dtype=None):
        """Device ms of one forward, replayed as a CUDA graph as the node
        costs are (an eager forward is bound by its launches)."""
        if dtype is not None:
            pdev = tree_map(lambda v: v.to(dtype)
                            if v.is_floating_point() else v, pdev)
        snap = [k.snapshot() for k in kernels]
        fwd = capture(lambda: graph.apply(pdev, x), torch.device(device))
        ms = time_ms(torch, fwd.replay, iters=10, warmup=2)
        for k, sn in zip(kernels, snap):
            k.restore(sn)  # the forward is a reference, not the path
        return ms

    costs = {}
    for key, graph, gparams, dtype, want_flash in (
            ("resnet50_f32", g, params, None, 0),
            ("bert_base_f32", bg, bparams, None,
             blocks * PLAN_K * (PLAN_REPS + 1)),
            ("bert_base_bf16", bg, bparams, "bfloat16",
             blocks * PLAN_K * (PLAN_REPS + 1))):
        zero_counts(kernels)
        t0 = time.perf_counter()
        c = measured_node_costs(graph, gparams, batch=MICROBATCH,
                                compute_dtype=dtype, k=PLAN_K,
                                reps=PLAN_REPS, device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counts(kernels)
        bad = [n for n, v in c.items() if not (math.isfinite(v) and v > 0)]
        if list(c) != graph.topo_order or bad:
            fail(f"phase 4m {key}: measured_node_costs gave {len(c)} nodes "
                 f"of {len(graph.topo_order)}, not positive/finite: "
                 f"{bad[:5]}")
        want = {"flash_attention": want_flash, "quant_int8": 0}
        if launches != want:
            fail(f"phase 4m {key}: launches {launches}, want {want} "
                 f"({blocks if want_flash else 0} blocks x {PLAN_K} calls x "
                 f"{PLAN_REPS + 1} replays)")
        src = mp if graph is g else bp
        x = torch.from_numpy(src["inputs"][0]).to(
            device, graph.input_spec.dtype)
        fwd = forward_ms(graph, src["pdev"], x,
                         None if dtype is None else torch.bfloat16)
        total = sum(c.values()) * 1e3
        top = sorted(c.items(), key=lambda kv: -kv[1])[:3]
        costs[key] = c
        res[key] = {"nodes": len(c), "sum_node_ms": total,
                    "forward_ms": fwd, "seconds": secs,
                    "launches": launches,
                    "top_nodes_ms": {n: v * 1e3 for n, v in top}}
        print(f"planner path: measured_node_costs({graph.name}, batch "
              f"{MICROBATCH}, {dtype or 'float32'}): {len(c)} nodes in "
              f"{secs:.1f} s, sum {total:.4f} ms against the forward's "
              f"{fwd:.4f} ms (per-op timing ignores fusion); heaviest "
              f"{[(n, round(v * 1e3, 4)) for n, v in top]}; launches "
              f"{launches}; on {card}", flush=True)

    # phase 4n prices its replicated plan on these
    res["resnet50_node_costs"] = costs["resnet50_f32"]

    # --- 3: the planner's cuts through the ring ---------------------------
    cm = StageCostModel(g, batch=MICROBATCH, gen="h100",
                        node_costs=costs["resnet50_f32"])
    solved = solve(g, 8, cm)
    lists = {"solved": list(solved.cuts),
             "quantile": auto_cut_points(g, 8, costs=costs["resnet50_f32"]),
             "paper": list(mp["cuts"])}
    priced = {k: evaluate_cuts(g, v, cm, objective=k).to_json()
              for k, v in lists.items()}
    res["cuts"] = lists
    res["priced"] = {k: {f: d[f] for f in (
        "bottleneck_ms", "bottleneck_stage", "bound_by", "stage_compute_ms",
        "hop_comm_ms", "hop_codecs")} for k, d in priced.items()}
    for k, d in priced.items():
        print(f"planner path: {k} cuts {lists[k]}: predicted bottleneck "
              f"{d['bottleneck_ms']:.4f} ms at stage {d['bottleneck_stage']} "
              f"({d['bound_by']}-bound; hops {d['hop_codecs']}) -> "
              f"{MICROBATCH / d['bottleneck_ms'] * 1e3:.1f} images/s",
              flush=True)
    if priced["solved"]["bottleneck_ms"] > min(
            priced["quantile"]["bottleneck_ms"],
            priced["paper"]["bottleneck_ms"]) * (1 + 1e-9):
        fail("phase 4m: the solver's plan prices above another cut list on "
             "its own model")
    inputs, ref = mp["inputs"], mp["ref"]
    scale = float(np.abs(ref).max())
    m = inputs.shape[0]
    steps = CHUNK * -(-(m + 8 - 1) // CHUNK)
    rings = {}
    for key in ("solved", "paper"):
        cuts = lists[key]
        zero_counts(kernels)
        out = Defer(DeferConfig(wire="int8", microbatch=MICROBATCH,
                                chunk=CHUNK, device=device)).run(
            g, params, inputs, cut_points=cuts)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        if out.shape != ref.shape or not np.isfinite(out).all():
            fail(f"phase 4m {key} cuts: output {out.shape} or not finite")
        err = float(np.abs(out - ref).max())
        agree = int((out.argmax(-1) == ref.argmax(-1)).sum())
        print(f"planner path: Defer.run(resnet50, {key} cuts, wire=int8) "
              f"{m} microbatches = {steps} steps: max|err| {err / scale:.4g} "
              f"of max|logit| (bound {INT8_REL_BOUND}), top-1 agree "
              f"{agree}/{ref.argmax(-1).size}, launches {launches}",
              flush=True)
        if err > INT8_REL_BOUND * scale or agree != ref.argmax(-1).size:
            fail(f"phase 4m {key} cuts: int8 rows off the forward by "
                 f"{err / scale:.4g} of max|logit| or a top-1 changed")
        if launches != {"quant_int8": steps, "flash_attention": 0}:
            fail(f"phase 4m {key} cuts: launches {launches}, want one "
                 f"quantizer launch per step ({steps})")
        rings[key] = {"rel_err": err / scale, "launches": launches,
                      "pipe": Defer(DeferConfig(
                          wire="int8", microbatch=MICROBATCH, chunk=CHUNK,
                          device=device)).build(g, params, cuts)}
        rings[key]["pipe"].run(inputs)  # captures the chunk graphs
    timed = np.concatenate([inputs] * PLAN_RING_REPEAT)
    walls = {k: [] for k in rings}
    for _ in range(PLAN_ROUNDS):
        for k, r in rings.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r["pipe"].run(timed)
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    res["ring"] = {}
    for k, r in rings.items():
        ips = len(timed) * MICROBATCH / statistics.median(walls[k])
        res["ring"][k] = {"images_per_s": ips, "walls_s": walls[k],
                          "rel_err": r["rel_err"], "launches": r["launches"],
                          "predicted_images_per_s":
                          MICROBATCH / priced[k]["bottleneck_ms"] * 1e3}
        print(f"planner path: int8 ring at the {k} cuts {ips:.1f} images/s "
              f"(median of {PLAN_ROUNDS} alternating rounds of "
              f"{len(timed)} microbatches) against a predicted "
              f"{res['ring'][k]['predicted_images_per_s']:.1f} (the model "
              f"prices hops as tcp between processes; the ring runs every "
              f"stage on one card each step); on {card}", flush=True)
    del rings
    free_card(torch)

    # --- 4: calibration from phase 4l's shm chain -------------------------
    cuts = list(mp["cuts"])
    cal = fit_from_stats(g, cuts, shm_stats, batch=MICROBATCH, gen="h100")
    prov = cal.provenance.get("host_sync_bw_s", {})
    tiers = [s["tier"] for s in shm_stats[:-1]]
    if tiers != ["shm"] * len(cuts) or prov.get("method") != "measured":
        fail(f"phase 4m calibration: hop tiers {tiers}, host_sync_bw_s "
             f"provenance {prov} (want shm hops and a measured fit)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cal_") as d:
        path = f"{d}/cal.json"
        cal.save(path)
        back = CalibratedConstants.load(path)
    if back.to_json() != cal.to_json():
        fail("phase 4m calibration: the artifact did not round-trip")
    ccm = back.apply(cm)
    pred = predict_stage_service_s(g, cuts, ["shm"] * len(cuts), ccm)
    meas = [s["infer_latency_s"].get("p50", 0.0) for s in shm_stats]
    res["calibration"] = {"constants": cal.to_json(),
                          "predicted_service_ms": [v * 1e3 for v in pred],
                          "measured_infer_p50_ms": [v * 1e3 for v in meas]}
    print(f"planner path: fit_from_stats on 4l's shm chain: host_sync_bw_s "
          f"{cal.host_sync_bw_s:.4g} B/s ({prov}), local_bw_s "
          f"{cal.local_bw_s:.4g} B/s ({cal.provenance.get('local_bw_s')}); "
          f"per-stage service predicted ms "
          f"{[round(v * 1e3, 4) for v in pred]} against the nodes' infer "
          f"p50 ms {[round(v * 1e3, 4) for v in meas]}; on {card}",
          flush=True)

    # --- 5: the live cutover on BERT-Base ---------------------------------
    bcm = StageCostModel(bg, batch=MICROBATCH, gen="h100",
                         node_costs=costs["bert_base_f32"])
    plan1 = solve(bg, 3, bcm)
    ids = [x.astype(np.int32) for x in bp["inputs"]]
    n1, n2 = CUTOVER_FRAMES
    seg1, seg2 = ids[:n1], ids[n1:n1 + n2]
    bref = bp["ref"][:n1 + n2]

    def boot(persist):
        nodes = [StageNode(None, "127.0.0.1:0", None, device=device,
                           persist=persist) for _ in range(3)]
        addrs = [f"127.0.0.1:{nd.address[1]}" for nd in nodes]
        ths = [threading.Thread(target=nd.serve, daemon=True)
               for nd in nodes]
        for t in ths:
            t.start()
        return addrs, ths

    def join(ths, what):
        for t in ths:
            t.join(timeout=60)
        if any(t.is_alive() for t in ths):
            fail(f"phase 4m {what}: nodes did not drain")

    def plain(cuts_, frames):
        addrs, ths = boot(False)
        d = ChainDispatcher(addrs[0], codec="raw")
        try:
            d.deploy(partition(bg, list(cuts_)), bparams, addrs,
                     batch=MICROBATCH)
            return d.stream(frames)
        finally:
            d.close()
            join(ths, "undisturbed chain")

    addrs, ths = boot(True)
    disp = ChainDispatcher(addrs[0], codec="raw")
    live = LiveReplan(disp, bg, bparams, addrs, batch=MICROBATCH)
    try:
        disp.deploy(partition(bg, list(plan1.cuts)), bparams, addrs,
                    batch=MICROBATCH)
        zero_counts(kernels)
        outs = disp.stream(seg1)
        torch.cuda.synchronize()
        l1 = read_counts(kernels)
        measured = measured_stage_seconds(disp.stats(addrs))
        result = replan(bg, plan1, measured, bcm)
        forced = not result.moved
        if forced:
            # the real suggestion keeps the cuts: a corrected hotspot on
            # stage 0 forces the move, as the reference's test does
            hot = dict(measured)
            hot[0] = 10 * sum(measured.values())
            result = replan(bg, plan1, hot, bcm)
        if not result.moved:
            fail(f"phase 4m cutover: replan kept the cuts {plan1.cuts} even "
                 f"with a stage-0 hotspot")
        receipt = result.apply(live)
        zero_counts(kernels)
        outs += disp.stream(seg2)
        torch.cuda.synchronize()
        l2 = read_counts(kernels)
    finally:
        disp.close()
        live.shutdown()
        join(ths, "live chain")
    ref = plain(plan1.cuts, seg1) + plain(result.new_plan.cuts, seg2)
    same = len(outs) == len(ref) and all(
        np.array_equal(a, b) for a, b in zip(outs, ref))
    rel = _rel_err(np.stack(outs), bref, "4m cutover", BUFFER_REL_BOUND)
    want1 = {"flash_attention": blocks * n1, "quant_int8": 0}
    want2 = {"flash_attention": blocks * n2, "quant_int8": 0}
    if (not same or receipt is None or receipt["quiesced"] != [n1] * 3
            or l1 != want1 or l2 != want2 or live.cutovers != 1):
        fail(f"phase 4m cutover: byte-identical {same}, receipt {receipt}, "
             f"launches {l1} then {l2} (want {want1}, {want2}), cutovers "
             f"{live.cutovers}")
    res["cutover"] = {"old_cuts": list(plan1.cuts),
                      "new_cuts": list(result.new_plan.cuts),
                      "forced_hotspot": forced,
                      "measured_stage_ms": {k: v * 1e3
                                            for k, v in measured.items()},
                      "predicted_improvement": result.predicted_improvement,
                      "cutover_ms": receipt["cutover_ms"],
                      "quiesced": receipt["quiesced"],
                      "launches": {"first": l1, "second": l2},
                      "byte_identical": True, "rel_err": rel}
    why = "forced by a stage-0 hotspot" if forced \
        else "the measured suggestion"
    stage_ms = [round(v * 1e3, 3) for v in measured.values()]
    print(f"planner path: live cutover of bert_base {plan1.cuts} -> "
          f"{result.new_plan.cuts} ({why}; measured stage ms {stage_ms}) "
          f"in {receipt['cutover_ms']:.1f} ms, quiesced "
          f"{receipt['quiesced']}; "
          f"the stream byte-identical to two undisturbed chains, "
          f"{rel:.3g} of max |output| off the forward; flash launches "
          f"{l1['flash_attention']} + {l2['flash_attention']} for "
          f"{n1} + {n2} frames; on {card}", flush=True)
    free_card(torch)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"planner path: phase 4m {res['seconds']:.1f} s; on {card}",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 4n: replication and failover
# ---------------------------------------------------------------------------

#: ResNet50/8's replicated stage (a): stage 1 as two node processes
REPL_RESNET = {1: 2}
#: BERT-Base/12's replicated stages (b): the dispatcher's own fan-out into
#: stage 0, an interior fan-in below stage 5, the result merge of stage 11
REPL_BERT = {0: 2, 5: 2, 11: 2}
#: results that have arrived when stage 1's replica 1 is killed (a), and
#: the frames of the stream it is killed in
KILL_AFTER = 16
KILL_FRAMES = 64
#: the node budget of the planner's replicated plan (c): (a)'s processes
REPL_NODES = 9


def replication_path(torch, device, kernels, card, mp, bp, ch, co, raw,
                     brows, node_costs):
    """Phase 4n.  a: ResNet50/8 (4a's cuts, f32, frames of MICROBATCH) with
    stage 1 as two replica processes, ``failover=True`` and ``tier="auto"``,
    nine node processes held open by ``deploy_chain``: hops 0->1 and 1->2
    ride tcp (fan paths never negotiate), every other hop and both
    dispatcher edges shm; rows byte-identical to 4k's raw tcp rows, each
    replica processing half the frames; timed on CHAIN_TIMED_FRAMES-frame
    streams (median of CHAIN_ROUNDS after the first stream) beside 4k's tcp
    and 4l's shm chains.  Then one more stream, and a ``SIGKILL`` of stage
    1's replica 1 once KILL_AFTER results have arrived: the rows equal the
    undisturbed stream's, the supervisor respawns the process once (one
    ``replica_respawn``), stage 0 heals its channel once (``failovers ==
    1``), the fan-in's ``merge_duplicates`` are reported; the ``failover``
    event's recovery seconds and the respawn's seconds from spawn to bind
    and to the healed redial beside the fan-in's ``failover_grace_s``.
    b: BERT-Base/12 as in-process nodes on tcp with stages 0, 5 and 11 as
    two replicas each (the dispatcher fans out, stage 6 merges, the
    dispatcher merges the results): rows byte-identical to 4k's in-process
    chain rows, 12 flash launches per frame in all, each replicated
    stage's two replicas processing every frame once between them, both
    nonzero; timed as a.  c: ``solve_replicated`` on 4m's measured ResNet50
    node costs for REPL_NODES processes: its cuts, replica counts and
    predicted images/s beside a's measured rate (a print: on one card the
    replicas share the device)."""
    import os
    import signal
    import threading

    import numpy as np

    from defer_tpu_torch.obs.events import recorder
    from defer_tpu_torch.partition import partition
    from defer_tpu_torch.plan import StageCostModel, solve_replicated
    from defer_tpu_torch.runtime.node import (ChainDispatcher, StageNode,
                                              deploy_chain)

    res = {"card": card, "timed_frames": CHAIN_TIMED_FRAMES,
           "kill_after": KILL_AFTER}
    t_phase = time.perf_counter()
    g, params, cuts = mp["graph"], mp["params"], mp["cuts"]
    stages = partition(g, cuts)
    n = len(stages)
    n_frames = CHAIN_IMAGES // MICROBATCH
    frames = [mp["inputs"][i] for i in range(n_frames)]
    timed = [frames[i % n_frames] for i in range(CHAIN_TIMED_FRAMES)]
    cyc = np.arange(CHAIN_TIMED_FRAMES) % n_frames
    t_images = CHAIN_TIMED_FRAMES * MICROBATCH
    (k_rep, r_rep), = REPL_RESNET.items()

    # --- a: ResNet50/8, stage 1 twice, failover, nine processes ---------
    # one row per node, stage by stage: each stage's OUTBOUND tier
    want_tiers = ["tcp"] * (k_rep + r_rep) + ["shm"] * (n - k_rep - 1)
    # phase 4p c: every process of the chain, and this one, journals here
    import tempfile
    jdir = tempfile.mkdtemp(prefix="defer_journal_")
    with deploy_chain(stages, params, batch=MICROBATCH, replicas=REPL_RESNET,
                      failover=True, tier="auto", device=device,
                      journal_dir=jdir) as chain:
        disp = chain.dispatcher
        t0 = time.perf_counter()
        out = np.stack(disp.stream(frames))
        first_s = time.perf_counter() - t0
        if not np.array_equal(out, raw):
            fail("phase 4n: the replicated chain's rows differ from phase "
                 "4k's raw tcp rows")
        st = disp.stats(chain.addrs)
        hops = [s["tier"] for s in st]
        shares = [s["processed"] for s in st if s["stage"] == k_rep]
        if (len(chain.procs) != n + r_rep - 1 or hops != want_tiers
                or (disp.tier_out, disp.tier_in) != ("shm", "shm")
                or any(s["tier_fallbacks"] for s in st)
                or sum(shares) != n_frames or min(shares) == 0):
            fail(f"phase 4n replicated chain: {len(chain.procs)} processes, "
                 f"hops {hops}, dispatcher {disp.tier_out}/{disp.tier_in}, "
                 f"fallbacks {[s['tier_fallbacks'] for s in st]}, stage "
                 f"{k_rep} shares {shares} (want {n + r_rep - 1} processes, "
                 f"hops {want_tiers}, shm edges, every replica a share of "
                 f"{n_frames} frames)")
        walls = []
        for _ in range(CHAIN_ROUNDS):
            t0 = time.perf_counter()
            outs = np.stack(disp.stream(timed))
            walls.append(time.perf_counter() - t0)
        if not np.array_equal(outs, raw[cyc]):
            fail("phase 4n: a timed stream's rows differ from 4k's raw rows")
        st = disp.stats(chain.addrs)
        shares = [s["processed"] for s in st if s["stage"] == k_rep]
        res["resnet50"] = {
            "replicas": {f"stage{k}": r for k, r in REPL_RESNET.items()},
            "processes": len(chain.procs), "hops": [disp.tier_out] + hops,
            "byte_identical_to_tcp": True, "boot_s": chain.boot_s,
            "first_stream_to_last_result_s": first_s,
            "chain_images_per_s": t_images / statistics.median(walls),
            "chain_walls_s": walls,
            "tcp_chain_images_per_s":
                ch["resnet50_raw"]["chain_images_per_s"],
            "shm_chain_images_per_s": co["shm"]["chain_images_per_s"],
            "replica_frame_share": [v / sum(shares) for v in shares],
            "launches": _sum_launches(st),
            "nodes": [f"stage{s['stage']}" + ("" if s["replica"] is None
                                              else f".r{s['replica']}")
                      for s in st],
            **_node_phases(st)}
        r = res["resnet50"]
        print(f"replication path: resnet50 in {len(chain.procs)} processes, "
              f"stage {k_rep} x {r_rep}, failover armed (hops "
              f"{r['hops']}; rows byte-identical to 4k's tcp rows): boot "
              f"{chain.boot_s:.2f} s, first stream {first_s:.2f} s; "
              f"{r['chain_images_per_s']:.1f} images/s against 4k's tcp "
              f"chain {r['tcp_chain_images_per_s']:.1f} and 4l's shm chain "
              f"{r['shm_chain_images_per_s']:.1f}; replica frame shares "
              f"{[round(v, 4) for v in r['replica_frame_share']]}; infer p50 "
              f"ms {[round(v, 3) for v in r['infer_p50_ms']]}; dispatch "
              f"{[round(v, 3) for v in r['dispatch_p50_ms']]}, queue "
              f"{[round(v, 3) for v in r['queue_p50_ms']]}, device "
              f"{[round(v, 3) for v in r['device_p50_ms']]}, host_sync "
              f"{[round(v, 3) for v in r['host_sync_p50_ms']]} (nodes "
              f"{r['nodes']}); on {card}", flush=True)

        # the kill: item 2 * KILL_AFTER is drawn only once KILL_AFTER
        # results have released the window
        victim = chain.pid(k_rep, 1)
        node_pids = [pr.pid for pr in chain.procs]
        killed: dict = {}

        kcyc = np.arange(KILL_FRAMES) % n_frames

        def feed():
            for i, k in enumerate(kcyc):
                if i == 2 * KILL_AFTER:
                    os.kill(victim, signal.SIGKILL)
                    killed["at"] = time.time()
                yield frames[k]

        respawn_evs0 = sum(e["kind"] == "replica_respawn"
                           for e in recorder().snapshot())
        window, disp.window = disp.window, KILL_AFTER
        t0 = time.perf_counter()
        outs = np.stack(disp.stream(feed()))
        kill_s = time.perf_counter() - t0
        disp.window = window
        if not killed:
            fail("phase 4n: the kill stream never reached its kill")
        if not np.array_equal(outs, raw[kcyc]):
            fail("phase 4n: the rows across the SIGKILL differ from the "
                 "undisturbed stream's")
        deadline = time.monotonic() + 30
        while (not chain.respawns or chain.respawns[0]["ready_s"] is None) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        st = disp.stats(chain.addrs)
        respawn_evs = sum(e["kind"] == "replica_respawn"
                          for e in recorder().snapshot()) - respawn_evs0
        fo = [e for e in st[0]["events"]["events"] if e["kind"] == "failover"]
        fan_in = st[k_rep + r_rep]
        if (len(chain.respawns) != 1 or respawn_evs != 1
                or st[0]["failovers"] != 1 or len(fo) != 1
                or chain.respawns[0]["ready_s"] is None
                or not 0 < chain.respawns[0]["bind_s"]
                <= chain.respawns[0]["ready_s"]
                or chain.pid(k_rep, 1) == victim):
            fail(f"phase 4n kill: respawns {chain.respawns}, "
                 f"replica_respawn events {respawn_evs}, stage 0 failovers "
                 f"{st[0]['failovers']}, failover events {fo} (want one "
                 f"respawn that booted, one event, one failover)")
        res["obs_autopsy"] = obs_autopsy(jdir, killed["at"], node_pids,
                                         f"stage{k_rep}.r1", card)
        rec = chain.respawns[0]
        res["failover"] = {
            "byte_identical": True, "respawns": len(chain.respawns),
            "replica_respawn_events": respawn_evs,
            "stage0_failovers": st[0]["failovers"],
            "failover_event": fo[0]["data"],
            "recovery_s": fo[0]["data"]["recovery_ms"] / 1e3,
            "respawn_rc": rec["rc"],
            "kill_to_spawn_s": rec["spawned_at"] - killed["at"],
            # the node binds first (its listening line carries the bind's
            # time), then makes its CUDA context and loads its artifact,
            # and prints the line: the redial connects at the bind, the
            # heal ends once the replay is written (a replay larger than
            # the socket buffers waits for the boot)
            "spawn_to_bind_s": rec["bind_s"],
            "spawn_to_ready_s": rec["ready_s"],
            "spawn_to_healed_redial_s":
                fo[0]["t_us"] / 1e6 - rec["spawned_at"],
            "failover_grace_s": 30.0,
            "merge_duplicates": fan_in["merge_duplicates"],
            "stream_s": kill_s, "stage0_replay_depth": st[0]["replay_depth"]}
        r = res["failover"]
        print(f"replication path: SIGKILL of stage{k_rep}.r1 (pid {victim}) "
              f"after {KILL_AFTER} results: rows byte-identical to the "
              f"undisturbed stream; {r['respawns']} respawn (rc {rec['rc']}, "
              f"{r['replica_respawn_events']} replica_respawn event), stage 0 "
              f"failovers {r['stage0_failovers']}, fan-in merge_duplicates "
              f"{r['merge_duplicates']}; failover recovery "
              f"{r['recovery_s']:.3f} s (replayed "
              f"{r['failover_event'].get('replayed')}); kill to spawn "
              f"{r['kill_to_spawn_s']:.2f} s, spawn to its bind "
              f"{r['spawn_to_bind_s']:.2f} s and to its listening line "
              f"{r['spawn_to_ready_s']:.2f} s, spawn to the healed redial "
              f"{r['spawn_to_healed_redial_s']:.2f} s against the fan-in's "
              f"grace of {r['failover_grace_s']:.0f} s; the stream took "
              f"{kill_s:.2f} s; on {card}", flush=True)
    free_card(torch)

    # --- b: BERT-Base/12 in-process, stages 0, 5 and 11 replicated -------
    bg, bparams = bp["graph"], bp["params"]
    bstages = partition(bg, bp["cuts"])
    nb = len(bstages)
    blocks = sum(name.startswith("block_") for name in bg.topo_order)
    b_frames = CHAIN_SEQS // MICROBATCH
    all_ids = [x.astype(np.int32) for x in bp["inputs"]]
    ids = all_ids[:b_frames]
    timed_ids = [all_ids[i % len(all_ids)]
                 for i in range(CHAIN_TIMED_FRAMES)]
    r_of = [REPL_BERT.get(k, 1) for k in range(nb)]
    groups = [[StageNode(None, "127.0.0.1:0", None, device=device)
               for _ in range(r_of[k])] for k in range(nb)]
    addrs = [[f"127.0.0.1:{nd.address[1]}" for nd in grp] for grp in groups]
    flat = [a for grp in addrs for a in grp]
    ths = [threading.Thread(target=nd.serve, daemon=True)
           for grp in groups for nd in grp]
    for t in ths:
        t.start()
    disp = ChainDispatcher(",".join(addrs[0]), result_fan_in=r_of[-1])
    try:
        t0 = time.perf_counter()
        disp.deploy(bstages, bparams, [a[0] if len(a) == 1 else a
                                       for a in addrs], batch=MICROBATCH)
        deploy_s = time.perf_counter() - t0
        zero_counts(kernels)
        outs = np.stack(disp.stream(ids))
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        want = {"flash_attention": blocks * b_frames, "quant_int8": 0}
        if launches != want:
            fail(f"phase 4n: replicated bert chain launches {launches}, want "
                 f"{want} ({blocks} per frame)")
        if not np.array_equal(outs, brows):
            fail("phase 4n: the replicated bert chain's rows differ from "
                 "4k's in-process chain rows")
        zero_counts(kernels)
        walls = []
        for _ in range(CHAIN_ROUNDS):
            t0 = time.perf_counter()
            touts = np.stack(disp.stream(timed_ids))
            walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        launches_t = read_counts(kernels)
        st = disp.stats(flat)
    finally:
        disp.close()
    for t in ths:
        t.join(timeout=60)
    if any(t.is_alive() for t in ths):
        fail("phase 4n: replicated bert chain nodes did not drain")
    brel = _rel_err(touts, bp["ref"][np.arange(CHAIN_TIMED_FRAMES)
                                     % len(all_ids)],
                    "4n replicated bert timed stream", BUFFER_REL_BOUND)
    total = b_frames + CHAIN_ROUNDS * CHAIN_TIMED_FRAMES
    want_t = {"flash_attention": blocks * CHAIN_ROUNDS * CHAIN_TIMED_FRAMES,
              "quant_int8": 0}
    split = {k: [s["processed"] for s in st if s["stage"] == k]
             for k in REPL_BERT}
    bad = {k: v for k, v in split.items()
           if len(v) != REPL_BERT[k] or sum(v) != total or min(v) == 0}
    if launches_t != want_t or bad:
        fail(f"phase 4n replicated bert chain: timed launches {launches_t} "
             f"(want {want_t}), replica shares {split} (want {total} frames "
             f"between each stage's replicas, none idle)")
    fan_ins = [s["fan_in"] for s in st]
    res["bert_base"] = {
        "replicas": {f"stage{k}": r for k, r in REPL_BERT.items()},
        "nodes": len(flat), "deploy_s": deploy_s,
        "byte_identical_to_4k": True, "rel_err_timed": brel,
        "chain_sequences_per_s": CHAIN_TIMED_FRAMES * MICROBATCH
        / statistics.median(walls),
        "chain_walls_s": walls,
        "tcp_chain_sequences_per_s": ch["bert_base"]["chain_sequences_per_s"],
        "launches": launches, "launches_timed_rounds": launches_t,
        "replica_processed": {f"stage{k}": v for k, v in split.items()},
        "fan_in": fan_ins, **_node_phases(st)}
    r = res["bert_base"]
    print(f"replication path: bert_base in {len(flat)} in-process nodes, "
          f"stages {sorted(REPL_BERT)} x 2 on tcp (fan_in {fan_ins}): rows "
          f"byte-identical to 4k's chain rows, launches {launches} for "
          f"{b_frames} frames and {launches_t} for {CHAIN_ROUNDS} x "
          f"{CHAIN_TIMED_FRAMES}; replicas processed "
          f"{r['replica_processed']}; {r['chain_sequences_per_s']:.1f} seq/s "
          f"against 4k's unreplicated chain "
          f"{r['tcp_chain_sequences_per_s']:.1f}; deploy {deploy_s:.2f} s; "
          f"on {card}", flush=True)
    del groups, disp
    free_card(torch)

    # --- c: the planner's replicated plan for the same budget ------------
    cm = StageCostModel(g, batch=MICROBATCH, gen="h100",
                        node_costs=node_costs)
    plan = solve_replicated(g, cm, num_nodes=REPL_NODES).to_json()
    res["plan"] = {"num_nodes": REPL_NODES, "cuts": plan["cuts"],
                   "replicas": plan["replicas"],
                   "bottleneck_ms": plan["bottleneck_ms"],
                   "predicted_images_per_s":
                       MICROBATCH / plan["bottleneck_ms"] * 1e3,
                   "measured_images_per_s":
                       res["resnet50"]["chain_images_per_s"]}
    r = res["plan"]
    print(f"replication path: solve_replicated(resnet50, num_nodes="
          f"{REPL_NODES}) on 4m's measured costs: cuts {r['cuts']}, replicas "
          f"{r['replicas']}, predicted bottleneck {r['bottleneck_ms']:.4f} ms "
          f"-> {r['predicted_images_per_s']:.1f} images/s, beside a's "
          f"measured {r['measured_images_per_s']:.1f} at the paper's cuts "
          f"with stage 1 x 2 (one card: the replicas share it)", flush=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"replication path: phase 4n {res['seconds']:.1f} s; on {card}",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 4o: branched (DAG) chains
# ---------------------------------------------------------------------------

#: InceptionV3 DAG (a): frames of MICROBATCH images through the in-process
#: deployment's checked stream (the timed stream's first frames), its
#: timed stream, and the process run
DAG_FRAMES = 16
DAG_TIMED_FRAMES = 16
DAG_PROC_FRAMES = 8
#: InceptionV3's image size (torchvision's) and the node budget of its DAG
#: and of its linear comparison
DAG_IMAGE = 299
DAG_NODES = 5
#: the branched MoE (b) at BERT-Base widths and the family's tiny depth:
#: (layers, hidden, heads, experts, expert hidden, sequence)
DAG_MOE = (2, 768, 12, 4, 3072, 128)
DAG_MOE_NODES = 12
#: token-id frames of MICROBATCH sequences through the branched MoE
DAG_MOE_FRAMES = 8
#: seconds each wait of phase 4o may take before it fails naming the
#: vertex that did not answer: one deploy, one stream, and the process
#: run from its spawn to its last result
DAG_DEPLOY_S = 120.0
DAG_STREAM_S = 60.0
DAG_PROC_S = 150.0


def _vertex_label(v) -> str:
    role = (" (fork)" if v.fan == "broadcast" else
            f" (join of {v.join})" if v.join >= 2 else "")
    return f"{v.label}{role}"


def _lagging(topo, processed, want: int) -> str:
    """The vertices that did not answer: every vertex below ``want``
    frames, the first of them (in topological order) named as the one the
    stream waits on."""
    late = [(v, p) for v, p in zip(topo.vertices, processed)
            if p is None or p < want]
    if not late:
        return f"every vertex processed {want} frames (the result hop?)"
    v, p = late[0]
    seen = "no answer" if p is None else f"{p} of {want} frames"
    rest = ", ".join(f"{u.label}: {'no answer' if q is None else q}"
                     for u, q in late[1:])
    return (f"waiting on vertex {_vertex_label(v)} ({seen})"
            + (f"; also behind: {rest}" if rest else ""))


def _cut_node(node) -> None:
    """Stop an in-process node as its peers see a dead one: its listener
    and its data connections shut both ways."""
    import socket

    for sock in [node._srv] + [getattr(ch, "_sock", None)
                               for ch in (node._live_rx, node._live_tx)]:
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def _node_stats(addr: str, timeout_s: float = 1.0) -> dict:
    """One node's ``stats`` reply over its control plane, within
    ``timeout_s``."""
    from defer_tpu_torch.transport.framed import (K_CTRL, connect_retry,
                                                  recv_expect, send_ctrl,
                                                  send_end)

    host, _, port = addr.rpartition(":")
    s = connect_retry(host, int(port), timeout_s=timeout_s)
    try:
        s.settimeout(timeout_s)
        send_ctrl(s, {"cmd": "stats"})
        out = recv_expect(s, K_CTRL)
        send_end(s)
        return out
    finally:
        s.close()


def bounded(seconds: float, what: str, fn, diagnose, abort=None):
    """``fn()`` on a thread, waited for at most ``seconds``: its result, or
    its exception re-raised; past the deadline a ``TimeoutError`` naming
    ``what`` and ``diagnose()`` (the vertices that did not answer), after
    ``abort()`` cut the wait's sockets or processes."""
    import threading

    box: dict = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True, name="chip-smoke-wait")
    t.start()
    t.join(seconds)
    if t.is_alive():
        try:
            who = diagnose()
        except Exception as e:  # noqa: BLE001 — reported in the message
            who = f"the diagnosis failed ({e!r})"
        if abort is not None:
            abort()
        raise TimeoutError(f"phase 4o: {what} did not finish within "
                           f"{seconds:.0f} s; {who}")
    if "err" in box:
        raise box["err"]
    return box["out"]


def _dag_topology(g, heavy: dict, nodes: int):
    """``solve_dag`` on pinned prices: the ``heavy`` nodes at 1 ms, the
    rest at 1 µs, hops at 1 TB/s (``tests/test_dag_chain.py``'s pricing),
    as a deployable topology beside its cost model."""
    from defer_tpu_torch.plan import StageCostModel, solve_dag
    from defer_tpu_torch.runtime.topology import ChainTopology

    cm = StageCostModel(g, gen="h100", link_bw_s=1e12, batch=MICROBATCH,
                        node_costs={n: heavy.get(n, 1e-6)
                                    for n in g.topo_order})
    plan = solve_dag(g, cm, num_nodes=nodes)
    return ChainTopology.from_json(plan.topology_json()), cm, plan


def _inproc_dag(torch, device, topo, stages, params, streams, what: str):
    """Deploy ``topo`` on in-process nodes (one ``StageNode`` thread per
    vertex) with ``deploy_topology``, run each stream of ``streams`` (a
    list of (label, frames)) under its deadline, and return (outputs per
    stream, per-stream walls, stats, the nodes' own programs, deploy
    seconds).  Every wait names the vertex that did not answer."""
    import threading

    import numpy as np

    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode

    nodes = [StageNode(None, "127.0.0.1:0", None, device=device)
             for _ in topo.vertices]
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    served: dict = {}

    def serve(i):
        try:
            served[i] = nodes[i].serve()
        except BaseException as e:  # noqa: BLE001 — reported below
            served[i] = e

    ths = [threading.Thread(target=serve, args=(i,), daemon=True)
           for i in range(len(nodes))]
    for t in ths:
        t.start()
    disp = ChainDispatcher(addrs[0], timeout_s=DAG_STREAM_S)

    def abort():
        for n in nodes:
            _cut_node(n)

    outs, walls = {}, {}
    total = 0
    try:
        t0 = time.perf_counter()
        bounded(DAG_DEPLOY_S, f"{what}: deploy_topology",
                lambda: disp.deploy_topology(topo, stages, params, addrs,
                                             batch=MICROBATCH),
                lambda: "no ACK from vertex " + next(
                    (_vertex_label(v) for v, n in zip(topo.vertices, nodes)
                     if n.prog is None), "(every vertex loaded)"), abort)
        deploy_s = time.perf_counter() - t0
        for label, xs in streams:
            total += len(xs)
            t0 = time.perf_counter()
            outs[label] = np.stack(bounded(
                DAG_STREAM_S, f"{what}: the {label} stream of {len(xs)} "
                f"frames", lambda: disp.stream(xs),
                lambda: _lagging(topo, [n.processed for n in nodes], total),
                abort))
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
        stats = disp.stats(addrs)
    finally:
        disp.close()
    for t in ths:
        t.join(timeout=DAG_STREAM_S)
    bad = {i: r for i, r in served.items() if r != total}
    if any(t.is_alive() for t in ths) or bad or len(served) != len(nodes):
        fail(f"phase 4o {what}: vertices did not drain {total} frames: "
             f"{ {topo.vertices[i].label: r for i, r in bad.items()} }")
    return outs, walls, stats, [n.prog for n in nodes], deploy_s


def _compose(torch, topo, progs, xs) -> list:
    """Serial composition of the deployment's own stage programs: each
    frame through every vertex's program in topological order, each join
    fed its inputs in path order — the byte-identity reference."""
    import numpy as np

    entry = topo.entry.inputs[0]
    out = []
    with torch.inference_mode():
        for x in xs:
            vals = {}
            for v, p in zip(topo.vertices, progs):
                vals[v.output] = p(*[x if name == entry else vals[name]
                                     for name in v.inputs])
            out.append(vals[topo.exit.output].cpu().numpy())
    return np.stack(out)


def _check_dag_stats(topo, stats, frames: int, what: str) -> dict:
    """Every vertex processed every frame (a branch vertex too: broadcast,
    not round-robin), each stats row carries its vertex's role, the
    join's ``join`` equals its path count, and every hop rode tcp."""
    rows = [(s["stage"], s["branch"], s["join"], s["processed"], s["tier"])
            for s in stats]
    want = [(v.vid, v.branch, v.join, frames, "tcp") for v in topo.vertices]
    if rows != want:
        fail(f"phase 4o {what}: vertex (stage, branch, join, processed, "
             f"tier) rows {rows}, want {want}")
    return {"per_vertex_processed": [s["processed"] for s in stats],
            "joins": [s["join"] for s in stats if s["join"]],
            "branch_vertices": sum(s["branch"] is not None for s in stats),
            "node_infer_p50_ms": [s["infer_latency_s"]["p50"] * 1e3
                                  for s in stats]}


def dag_setup(torch) -> dict:
    """Phase 4o's InceptionV3 (a): the graph at DAG_IMAGE, its seeded
    weights, the DAG topology with its stages, and ``best_linear_plan``'s
    stages for the same node budget — built ahead of the phase, so that
    these programs trace while other phases' node processes boot
    (``trace_ahead``: the DAG's in phase 4l, the linear chain's while
    ``run_dag_chain``'s processes boot)."""
    from defer_tpu_torch import models
    from defer_tpu_torch.graph.analysis import branch_regions
    from defer_tpu_torch.partition import partition
    from defer_tpu_torch.plan.dag import best_linear_plan

    g = models.inception_v3(image_size=DAG_IMAGE)
    params = g.init(torch.Generator().manual_seed(SEED))
    region = next(r for r in branch_regions(g) if r.join == "mixed_3")
    topo, cm, plan = _dag_topology(
        g, {n: 1e-3 for b in region.branches[:2] for n in b.nodes},
        DAG_NODES)
    lin = best_linear_plan(g, cm, num_nodes=DAG_NODES)
    return {"graph": g, "params": params, "topo": topo, "plan": plan,
            "stages": topo.stage_specs(g), "lin": lin,
            "lstages": partition(g, list(lin.cuts))}


def dag_path(torch, device, kernels, card, setup=None):
    """Phase 4o: branched (DAG) chains, A10c.  a: InceptionV3 at 299²
    (seed SEED, f32, frames of MICROBATCH) on the 5-vertex topology
    ``solve_dag`` gives when the first two branches of the ``mixed_3``
    reduction region are priced heavy (a fork after ``mixed_2``, three
    branch vertices, the join and the rest of the network): five
    in-process ``StageNode`` threads deployed by ``deploy_topology`` on
    DAG_FRAMES frames — rows byte-identical to the serial composition of
    the nodes' own programs, within BUFFER_REL_BOUND of max |logit| of the
    whole-graph forward with top-1 equal, every branch vertex every frame,
    the join's ``join`` = 3, 0 launches of either kernel — then one timed
    stream of DAG_TIMED_FRAMES frames beside ``best_linear_plan``'s chain
    for the same node budget on the same frames; then ``run_dag_chain``
    on the card (five ``python -m defer_tpu_torch node`` processes, the
    ``chain --dag`` shape) on DAG_PROC_FRAMES frames, rows byte-identical
    to the in-process rows, with its boot, export and first-result
    seconds.  b: ``moe_branched(*DAG_MOE)`` (BERT-Base widths, 2 layers;
    11 vertices, two 5-path regions) as in-process nodes on DAG_MOE_FRAMES
    frames of token ids: byte-identical to the serial composition, within
    BUFFER_REL_BOUND of the forward (the same kernels on the same inputs:
    the programs only sum some decomposed ops in another order), 2 flash
    launches per frame by the smoke's counts and the nodes'
    ``kernel_launches``, 0 quantizer launches.  Every wait has its own
    deadline (DAG_DEPLOY_S, DAG_STREAM_S, DAG_PROC_S) that names the
    vertex that did not answer."""
    import os

    import numpy as np

    from defer_tpu_torch import models
    from defer_tpu_torch.runtime.node import run_dag_chain
    from defer_tpu_torch.runtime.topology import ChainTopology
    from defer_tpu_torch.utils.convert import params_to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"card": card}
    t_phase = time.perf_counter()
    none = {"quant_int8": 0, "flash_attention": 0}

    # --- a: InceptionV3, the mixed_3 region fanned out -------------------
    setup = setup or dag_setup(torch)
    g, params, topo, plan = (setup["graph"], setup["params"], setup["topo"],
                             setup["plan"])
    if len(topo) != DAG_NODES or sum(v.join >= 2 for v in topo) != 1:
        fail(f"phase 4o: solve_dag gave {topo!r}, want {DAG_NODES} "
             f"vertices around the mixed_3 region")
    stages = setup["stages"]
    rng = np.random.default_rng(SEED)
    xs = rng.standard_normal((DAG_TIMED_FRAMES, MICROBATCH, DAG_IMAGE,
                              DAG_IMAGE, 3)).astype(np.float32)
    frames = list(xs[:DAG_FRAMES])
    timed = list(xs)
    pdev = params_to_device(params, device)
    with torch.inference_mode():
        ref = np.stack([g.apply(pdev, torch.from_numpy(x).to(device))
                        .cpu().numpy() for x in xs])
    del pdev
    zero_counts(kernels)
    outs, walls, stats, progs, deploy_s = _inproc_dag(
        torch, device, topo, stages, params,
        [("checked", frames), ("timed", timed)], "inception_v3 DAG")
    launches = read_counts(kernels)
    if launches != none:
        fail(f"phase 4o inception_v3 DAG: kernel launches {launches}, "
             f"want {none}")
    serial = _compose(torch, topo, progs, frames)
    if not np.array_equal(outs["checked"], serial):
        fail("phase 4o inception_v3 DAG: rows differ from the serial "
             "composition of the deployment's own stage programs")
    if not np.array_equal(outs["timed"][:DAG_FRAMES], serial):
        fail("phase 4o inception_v3 DAG: the timed stream's rows differ "
             "from the checked stream's")
    rel = _rel_err(outs["timed"], ref, "inception_v3 DAG",
                   BUFFER_REL_BOUND, phase="4o")
    if not (outs["timed"].argmax(-1) == ref.argmax(-1)).all():
        fail("phase 4o inception_v3 DAG: a top-1 class differs from the "
             "forward")
    vstats = _check_dag_stats(topo, stats, DAG_FRAMES + DAG_TIMED_FRAMES,
                              "inception_v3 DAG")
    dag_ips = DAG_TIMED_FRAMES * MICROBATCH / walls["timed"]
    del progs

    # the same topology as five node processes: run_dag_chain
    pframes = frames[:DAG_PROC_FRAMES]
    spawned: list = []
    pstats: list = []
    timings: dict = {}

    def proc_state():
        """Each vertex's processed count over its control plane (None:
        no answer within a second)."""
        out = []
        for p in spawned:
            try:
                out.append(_node_stats(
                    p.args[p.args.index("--listen") + 1])["processed"])
            except Exception:  # noqa: BLE001 — a vertex that did not answer
                out.append(None)
        return out

    def proc_diagnose():
        if not spawned:
            return "no vertex process spawned yet"
        state = proc_state()
        first = "" if state[-1] else "no first result; "
        return first + _lagging(topo, state, DAG_PROC_FRAMES)

    def kill_spawned():
        for p in spawned:
            try:
                p.kill()
            except OSError:
                pass

    # the linear chain's stages trace while the five processes boot (from
    # the spawn on: run_dag_chain's own export must not wait for them)
    lin, lstages = setup["lin"], setup["lstages"]
    ahead: list = []

    def on_spawn(procs):
        spawned.extend(procs)
        if not ahead:
            ahead.append(trace_ahead((lstages, params)))

    zero_counts(kernels)
    t0 = time.perf_counter()
    pouts = np.stack(bounded(
        DAG_PROC_S, f"run_dag_chain (spawn, boot, first and last of "
        f"{DAG_PROC_FRAMES} results)",
        lambda: run_dag_chain(g, params, pframes, topology=topo,
                              batch=MICROBATCH, device=device,
                              stats_out=pstats, timings_out=timings,
                              on_spawn=on_spawn,
                              timeout_s=DAG_STREAM_S),
        proc_diagnose, kill_spawned))
    proc_s = time.perf_counter() - t0
    if not np.array_equal(pouts, outs["checked"][:DAG_PROC_FRAMES]):
        fail("phase 4o run_dag_chain: rows differ from the in-process "
             "deployment's rows")
    pv = _check_dag_stats(topo, pstats, DAG_PROC_FRAMES,
                          "run_dag_chain")
    devs = {s["device"] for s in pstats}
    plaunch = _sum_launches(pstats)
    if not all(d.startswith(device) for d in devs) or plaunch != none:
        fail(f"phase 4o run_dag_chain: vertex devices {devs}, launches "
             f"{plaunch}")
    print(f"dag path: run_dag_chain(inception_v3, {len(topo)} node "
          f"processes on {device}) {DAG_PROC_FRAMES} frames: rows "
          f"byte-identical to the in-process rows; boot (spawn to the last "
          f"bind) {timings['boot_s']:.2f} s, export {timings['export_s']:.2f} "
          f"s, first result {timings['first_result_s']:.2f} s after the "
          f"stream began, stream {timings['stream_s']:.2f} s, the whole run "
          f"{proc_s:.2f} s; per-vertex frames {pv['per_vertex_processed']}, "
          f"node launches {plaunch}; on {card}", flush=True)
    proc_res = {"frames": DAG_PROC_FRAMES, "seconds": proc_s, **timings,
                "launches": plaunch, **pv}
    for t in ahead:
        t.join()

    # the best linear plan for the same node budget, on the same frames
    ltopo = ChainTopology.linear(lstages)
    zero_counts(kernels)
    louts, lwalls, lstats, _, ldeploy_s = _inproc_dag(
        torch, device, ltopo, lstages, params,
        [("timed", timed)], "inception_v3 linear chain")
    if read_counts(kernels) != none:
        fail(f"phase 4o linear chain: kernel launches {read_counts(kernels)}")
    lrel = _rel_err(louts["timed"], ref, "inception_v3 linear chain",
                    BUFFER_REL_BOUND, phase="4o")
    lin_ips = DAG_TIMED_FRAMES * MICROBATCH / lwalls["timed"]
    print(f"dag path: inception_v3 {DAG_IMAGE}x{DAG_IMAGE} on {len(topo)} "
          f"in-process "
          f"vertices {[v.label for v in topo]} (fork after "
          f"{topo.entry.output}, join {topo.exit.inputs}): deploy "
          f"{deploy_s:.2f} s, rows byte-identical to the serial composition "
          f"of the nodes' programs, {rel:.3g} of max |logit| off the "
          f"forward, top-1 equal, per-vertex frames "
          f"{vstats['per_vertex_processed']}, join {vstats['joins']}, "
          f"launches {launches}; {dag_ips:.1f} images/s on one "
          f"{DAG_TIMED_FRAMES}-frame stream against {lin_ips:.1f} through "
          f"best_linear_plan's {len(lstages)}-stage chain (cuts "
          f"{list(lin.cuts)}, {lrel:.3g} off the forward) on the same "
          f"frames; predicted bottleneck {plan.bottleneck_s * 1e3:.4f} ms "
          f"(DAG) vs {lin.bottleneck_s * 1e3:.4f} ms (linear) on the pinned "
          f"prices; on {card}", flush=True)
    res["inception_v3"] = {
        "vertices": [v.label for v in topo], "frames": DAG_FRAMES,
        "timed_frames": DAG_TIMED_FRAMES, "rel_err": rel,
        "deploy_s": deploy_s, "stream_walls_s": walls,
        "images_per_s": dag_ips, "launches": launches, **vstats,
        "linear": {"cuts": list(lin.cuts), "stages": len(lstages),
                   "deploy_s": ldeploy_s, "rel_err": lrel,
                   "images_per_s": lin_ips, "stream_wall_s": lwalls["timed"],
                   "per_vertex_processed": [s["processed"]
                                            for s in lstats]},
        "process_run": proc_res}

    del g, params, stages, outs, serial, ref, setup
    free_card(torch)

    # --- b: the branched MoE at BERT-Base widths ------------------------
    mg = models.moe_branched(*DAG_MOE)
    mparams = mg.init(torch.Generator().manual_seed(SEED))
    heavy = {n: 1e-3 for n in mg.topo_order
             if n.startswith("block_") or "_e" in n}
    mtopo, _, _ = _dag_topology(mg, heavy, DAG_MOE_NODES)
    joins = [v.join for v in mtopo if v.join >= 2]
    if len(mtopo) != 11 or joins != [5, 5]:
        fail(f"phase 4o: solve_dag gave {mtopo!r} for the branched MoE "
             f"(joins {joins}), want 11 vertices and two 5-path joins")
    vocab = mg.nodes["embeddings"].op.vocab
    ids = list(np.random.default_rng(SEED).integers(
        0, vocab, (DAG_MOE_FRAMES, MICROBATCH, DAG_MOE[-1])).astype(np.int32))
    blocks = sum(n.startswith("block_") for n in mg.topo_order)
    mpdev = params_to_device(mparams, device)
    with torch.inference_mode():
        mref = np.stack([mg.apply(mpdev, torch.from_numpy(x).to(device))
                         .cpu().numpy() for x in ids])
    del mpdev
    zero_counts(kernels)
    mouts, mwalls, mstats, mprogs, mdeploy_s = _inproc_dag(
        torch, device, mtopo, mtopo.stage_specs(mg), mparams,
        [("checked", ids)], "moe_branched DAG")
    mlaunch = read_counts(kernels)
    node_flash = {s["kernel_launches"]["flash_attention"] for s in mstats}
    mwant = {"quant_int8": 0, "flash_attention": blocks * DAG_MOE_FRAMES}
    if mlaunch != mwant or node_flash != {mwant["flash_attention"]}:
        fail(f"phase 4o moe_branched DAG: launches {mlaunch}, nodes' "
             f"{node_flash}; want {mwant} ({blocks} flash per frame)")
    if not np.array_equal(mouts["checked"],
                          _compose(torch, mtopo, mprogs, ids)):
        fail("phase 4o moe_branched DAG: rows differ from the serial "
             "composition of the deployment's own stage programs")
    mrel = _rel_err(mouts["checked"], mref, "moe_branched DAG",
                    BUFFER_REL_BOUND, phase="4o")
    mv = _check_dag_stats(mtopo, mstats, DAG_MOE_FRAMES, "moe_branched DAG")
    print(f"dag path: moe_branched{DAG_MOE} on {len(mtopo)} in-process "
          f"vertices (joins {mv['joins']}, {mv['branch_vertices']} branch "
          f"vertices): deploy {mdeploy_s:.2f} s, {DAG_MOE_FRAMES} frames of "
          f"{MICROBATCH} x {DAG_MOE[-1]} ids to the last result in "
          f"{mwalls['checked']:.2f} s, rows byte-identical to the serial "
          f"composition, {mrel:.3g} of max |output| off the forward; "
          f"launches {mlaunch} ({blocks} flash per frame), nodes' flash "
          f"count {sorted(node_flash)}; on {card}", flush=True)
    res["moe_branched"] = {
        "config": list(DAG_MOE), "vertices": [v.label for v in mtopo],
        "frames": DAG_MOE_FRAMES, "deploy_s": mdeploy_s,
        "stream_wall_s": mwalls["checked"], "rel_err": mrel,
        "launches": mlaunch, **mv}
    del mprogs
    free_card(torch)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"dag path: phase 4o {res['seconds']:.1f} s (budget "
          f"{DAG_BUDGET_S:.0f} s); on {card}", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 4s: mesh parallelism on one card
# ---------------------------------------------------------------------------

#: phase 4s's share of BUDGET_S (its training checks ride 4a and 4g)
MESH_BUDGET_S = 30.0
#: seconds of phase 4s carved out of the phases it rides
MESH_SECONDS: list = []
#: pp x tp (x dp) rows against the tp=1 ring's on the buffer wire: the
#: same f32 ops, but each block's four products split over the ranks and
#: summed by the psums in another order
MESH_REL_BOUND = 1e-4
#: timed rounds of the tensor-parallel ring (one capture replay each)
MESH_ROUNDS = 3
#: BERT-Base's cuts for the (data 2, stage 4, model 2) mesh
MESH_DP_TP_CUTS = ["block_2", "block_5", "block_8"]
#: sequence parallelism at GPT-2 small's widths on a long context: the
#: ring over 8 ranks; Ulysses needs heads % ranks == 0, so its 12 heads go
#: over 4 ranks (8 must raise)
SP_SHAPE = (1, 12, 8192, 64)
SP_RANKS = 8
SP_ULYSSES_RANKS = 4
#: both schemes against full_attention and each other (the JAX tests'
#: 2e-5, as a fraction of max |out|): the same f32 softmax, TF32 off
SP_REL_BOUND = 2e-5
#: expert parallelism: moe_0 of DAG_MOE's graph on [8, 128, 768] tokens
EP_RANKS = 4
EP_TOKENS = (8, 128)
#: against the dense MoE.apply while no token overflows (the JAX test's)
EP_REL_BOUND = 1e-5


def mesh_phase() -> carved:
    """A stretch of phase 4s (its seconds land in MESH_SECONDS)."""
    return carved("4s", MESH_SECONDS)


def _mesh_rel(out, want) -> float:
    import numpy as np
    return float(np.abs(out - want).max()) / float(np.abs(want).max())


def mesh_bert(torch, device, kernels, card, bp, bthr) -> dict:
    """Phase 4s a and b.  a: BERT-Base/12 (4b's graph, weights and ids) on
    the one-card (stage 12, model 2) mesh, both wires: rows against 4b's
    tp=1 ring rows (buffer within MESH_REL_BOUND, int8 within
    INT8_REL_BOUND of max |output|); 2 x 12 flash launches per ring step
    (each block's two ranks at 6 local heads), one quantizer launch per
    int8 step; one capture per chunk length; sequences/s beside 4b's tp=1
    ring and the chunk's device time (CUDA events around a replay).  b:
    BERT-Base/4 through ``Defer(DeferConfig(tensor_parallel=2,
    data_parallel=2))``: rows as a's buffer wire and equal to
    ``SpmdPipeline.run`` on the same (data 2, stage 4, model 2) mesh."""
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig, SpmdPipeline
    from defer_tpu_torch.parallel import pipeline_mesh
    from defer_tpu_torch.partition import partition

    torch.backends.cuda.matmul.allow_tf32 = False
    g, params, ids = bp["graph"], bp["params"], bp["inputs"]
    blocks = sum(name.startswith("block_") for name in g.topo_order)
    m = ids.shape[0]
    res: dict = {"launches": {}, "rel_err": {}}

    stages = partition(g, bp["cuts"])
    n = len(stages)
    steps = CHUNK * -(-(m + n - 1) // CHUNK)
    for wire, bound in (("buffer", MESH_REL_BOUND),
                        ("int8", INT8_REL_BOUND)):
        pipe = SpmdPipeline(stages, params, device=device,
                            microbatch=MICROBATCH, chunk=CHUNK, wire=wire,
                            tensor_parallel=2)
        out, got, _ = _counted(torch, kernels, lambda: pipe.run(ids))
        want = {"flash_attention": 2 * blocks * steps,
                "quant_int8": steps if wire == "int8" else 0}
        if got != want or pipe.metrics.captures != 1:
            fail(f"phase 4s a {wire}: launches {got} (want {want}: 2 ranks "
                 f"x {blocks} blocks of flash a step), "
                 f"{pipe.metrics.captures} captures (want 1)")
        rel = _mesh_rel(out, bp["rows"][wire])
        if not (np.isfinite(out).all() and rel <= bound):
            fail(f"phase 4s a {wire}: pp x tp rows {rel:.3g} of max|output| "
                 f"off the tp=1 ring's (bound {bound})")
        res["launches"][f"tp2_{wire}"] = got
        res["rel_err"][f"tp2_{wire}"] = rel
        # steady state: a captured chunk, replayed
        xs = pipe.stage_inputs(ids[:CHUNK])
        for _ in range(2):
            pipe.push(xs)
        walls = []
        for _ in range(MESH_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.push(xs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        pipe.push(xs)  # one replay of the captured chunk
        ev[1].record()
        ev[1].synchronize()
        wall = statistics.median(walls)
        res[f"tp2_{wire}"] = {
            "sequences_per_s": CHUNK * MICROBATCH / wall,
            "tp1_sequences_per_s": bthr[f"pipeline_{wire}"],
            "device_ms_per_step": ev[0].elapsed_time(ev[1]) / CHUNK,
            "wall_ms_per_step": wall * 1e3 / CHUNK,
            "rows_per_stage_rank": [r.numel() for r in pipe.modules[1].rows]}
        print(f"mesh path a: SpmdPipeline(bert_base, {n} stages x 2 "
              f"tensor-parallel ranks, wire={wire}, microbatch {MICROBATCH}) "
              f"on {m} microbatches = {steps} steps: launches {got}, rows "
              f"{rel:.3g} of max|output| off the tp=1 ring's (bound {bound}),"
              f" {pipe.metrics.captures} capture; "
              f"{res[f'tp2_{wire}']['sequences_per_s']:.1f} sequences/s "
              f"(4b's tp=1 ring {bthr[f'pipeline_{wire}']:.1f}; one card, "
              f"no scaling claim), device "
              f"{res[f'tp2_{wire}']['device_ms_per_step']:.3f} ms of "
              f"{res[f'tp2_{wire}']['wall_ms_per_step']:.3f} ms a step; on "
              f"{card}", flush=True)
        del pipe
    free_card(torch)
    # where a tensor-parallel step's device time goes (one profiled chunk)
    res["profile_tp2_int8"] = profile_step(
        torch, bp, BERT_GROUPS, label="tp2 int8", defer=Defer(DeferConfig(
            wire="int8", microbatch=MICROBATCH, chunk=CHUNK, device=device,
            tensor_parallel=2)))
    free_card(torch)

    # b. pp x dp x tp through Defer, against SpmdPipeline on the same mesh
    n4 = len(MESH_DP_TP_CUTS) + 1
    steps4 = CHUNK * -(-(m + n4 - 1) // CHUNK)
    defer = Defer(DeferConfig(microbatch=MICROBATCH, chunk=CHUNK,
                              device=device, tensor_parallel=2,
                              data_parallel=2))
    out, got, sec = _counted(torch, kernels, lambda: defer.run(
        g, params, ids, cut_points=MESH_DP_TP_CUTS))
    want = {"flash_attention": 2 * blocks * steps4, "quant_int8": 0}
    mesh = pipeline_mesh(n4, 2, 2, devices=[device] * (4 * n4))
    same = SpmdPipeline(partition(g, MESH_DP_TP_CUTS), params, mesh=mesh,
                        microbatch=MICROBATCH, chunk=CHUNK).run(ids)
    rel = _mesh_rel(out, bp["rows"]["buffer"])
    if got != want or rel > MESH_REL_BOUND or not np.array_equal(out, same):
        fail(f"phase 4s b: Defer(tensor_parallel=2, data_parallel=2) "
             f"launches {got} (want {want}), rows {rel:.3g} of max|output| "
             f"off the tp=1 ring's (bound {MESH_REL_BOUND}), equal to "
             f"SpmdPipeline on the same mesh: {np.array_equal(out, same)}")
    res["launches"]["dp2_tp2"] = got
    res["rel_err"]["dp2_tp2"] = rel
    res["dp2_tp2"] = {"mesh": mesh.shape, "steps": steps4, "run_s": sec}
    print(f"mesh path b: Defer(DeferConfig(tensor_parallel=2, "
          f"data_parallel=2)).run(bert_base, {n4} stages) on the mesh "
          f"{mesh.shape}: launches {got}, rows {rel:.3g} of max|output| off "
          f"the tp=1 ring's, equal to SpmdPipeline.run on the same mesh; "
          f"{sec:.2f} s with the capture; on {card}", flush=True)
    del defer
    free_card(torch)
    return res


def mesh_sequence(torch, device, card) -> dict:
    """Phase 4s c: ``sequence_parallel_attention`` (the ring over
    SP_RANKS ranks) and its Ulysses counterpart (SP_ULYSSES_RANKS ranks)
    at SP_SHAPE, causal and not, against ``full_attention`` and each other
    (SP_REL_BOUND of max |out|); the ring's peak memory below the full
    product's (each rank's score block is (T/8)^2); Ulysses over 8 ranks
    refuses 12 heads."""
    from defer_tpu_torch.parallel import (Mesh, full_attention,
                                          sequence_parallel_attention,
                                          sequence_parallel_attention_ulysses)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v = (torch.randn(SP_SHAPE, generator=gen, device=device)
               for _ in range(3))
    ring_mesh = Mesh([device] * SP_RANKS, ("seq",))
    uly_mesh = Mesh([device] * SP_ULYSSES_RANKS, ("seq",))
    try:
        sequence_parallel_attention_ulysses(q, k, v, ring_mesh)
        fail(f"phase 4s c: Ulysses over {SP_RANKS} ranks took "
             f"{SP_SHAPE[1]} heads")
    except ValueError as e:
        if "divisible" not in str(e):
            raise
    res: dict = {"shape": list(SP_SHAPE), "ring_ranks": SP_RANKS,
                 "ulysses_ranks": SP_ULYSSES_RANKS}

    def measured(fn):
        free_card(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        return out, torch.cuda.max_memory_allocated() - base, sec

    for causal in (False, True):
        full, full_peak, full_s = measured(
            lambda: full_attention(q, k, v, causal=causal))
        ring, ring_peak, ring_s = measured(
            lambda: sequence_parallel_attention(q, k, v, ring_mesh,
                                                causal=causal))
        uly, uly_peak, uly_s = measured(
            lambda: sequence_parallel_attention_ulysses(
                q, k, v, uly_mesh, causal=causal))
        scale = float(full.abs().max())
        errs = {"ring_vs_full": float((ring - full).abs().max()) / scale,
                "ulysses_vs_full": float((uly - full).abs().max()) / scale,
                "ring_vs_ulysses": float((ring - uly).abs().max()) / scale}
        if not (max(errs.values()) <= SP_REL_BOUND
                and ring_peak < full_peak):
            fail(f"phase 4s c causal={causal}: {errs} (bound "
                 f"{SP_REL_BOUND} of max|out|), peak bytes ring {ring_peak}"
                 f" against full {full_peak}")
        key = "causal" if causal else "full"
        res[key] = {**errs, "peak_bytes": {"full": full_peak,
                                           "ring": ring_peak,
                                           "ulysses": uly_peak},
                    "seconds": {"full": full_s, "ring": ring_s,
                                "ulysses": uly_s}}
        print(f"mesh path c: attention {tuple(SP_SHAPE)} causal={causal}: "
              f"ring ({SP_RANKS} ranks) {errs['ring_vs_full']:.3g}, Ulysses "
              f"({SP_ULYSSES_RANKS} ranks) {errs['ulysses_vs_full']:.3g} of "
              f"max|out| off full_attention, {errs['ring_vs_ulysses']:.3g} "
              f"apart (bound {SP_REL_BOUND}); peak {full_peak / 1e9:.3f} GB "
              f"full, {ring_peak / 1e9:.3f} ring, {uly_peak / 1e9:.3f} "
              f"Ulysses; {full_s * 1e3:.1f}/{ring_s * 1e3:.1f}/"
              f"{uly_s * 1e3:.1f} ms (first call, host clock); on {card}",
              flush=True)
        del full, ring, uly
    del q, k, v
    free_card(torch)
    return res


def mesh_expert(torch, device, card) -> dict:
    """Phase 4s d: ``moe_0`` of ``moe_transformer(*DAG_MOE)`` (seed-0
    weights) on EP_TOKENS tokens of width 768 over EP_RANKS expert ranks:
    with ``capacity_factor=EP_RANKS`` (no token dropped) within
    EP_REL_BOUND of max |out| of the dense ``MoE.apply``; with capacity 1,
    all but the at most EP_RANKS^2 kept tokens equal their input exactly
    (the residual) and the kept ones the dense result."""
    from defer_tpu_torch import models
    from defer_tpu_torch.parallel import (expert_parallel_fn,
                                          expert_parallel_mesh,
                                          shard_moe_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    g = models.moe_transformer(*DAG_MOE)
    op = g.nodes["moe_0"].op
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = g.init(gen)["moe_0"]
    d = g.out_spec("moe_0").shape[-1]
    x = torch.randn(EP_TOKENS + (d,), generator=gen, device=device)
    mesh = expert_parallel_mesh(EP_RANKS, devices=[device] * EP_RANKS)
    stk = shard_moe_params(op, params, EP_RANKS, mesh=mesh)
    with torch.inference_mode():
        dense = op.apply(params, x)
        t0 = time.perf_counter()
        out = expert_parallel_fn(op, mesh, capacity_factor=float(
            EP_RANKS))(stk, x)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        cut = expert_parallel_fn(op, mesh, capacity_factor=1.0,
                                 tokens_per_device=1)(stk, x)
    scale = float(dense.abs().max())
    rel = float((out - dense).abs().max()) / scale
    dropped = (cut == x).all(-1)
    kept = ~dropped
    kept_rel = (float((cut[kept] - dense[kept]).abs().max()) / scale
                if bool(kept.any()) else 0.0)
    tokens = EP_TOKENS[0] * EP_TOKENS[1]
    if not (rel <= EP_REL_BOUND and kept_rel <= EP_REL_BOUND
            and int(kept.sum()) <= EP_RANKS * EP_RANKS
            and int(dropped.sum()) >= tokens - EP_RANKS * EP_RANKS):
        fail(f"phase 4s d: expert-parallel {rel:.3g} of max|out| off the "
             f"dense MoE (bound {EP_REL_BOUND}); capacity 1 kept "
             f"{int(kept.sum())} tokens (at most {EP_RANKS ** 2}), kept "
             f"tokens {kept_rel:.3g} off the dense result")
    res = {"tokens": tokens, "experts": op.num_experts, "ranks": EP_RANKS,
           "rel_err": rel, "capacity1_kept": int(kept.sum()),
           "capacity1_dropped": int(dropped.sum()),
           "capacity1_kept_rel_err": kept_rel, "seconds": sec}
    print(f"mesh path d: expert_parallel_fn(moe_0 of moe_transformer"
          f"{DAG_MOE}, {EP_RANKS} ranks) on {tokens} tokens: {rel:.3g} of "
          f"max|out| off the dense MoE.apply (bound {EP_REL_BOUND}), "
          f"{sec * 1e3:.1f} ms; capacity 1: {int(dropped.sum())} tokens "
          f"dropped to exactly their residual, {int(kept.sum())} kept "
          f"({kept_rel:.3g} off the dense result); on {card}", flush=True)
    del g, params, stk, x, dense, out, cut
    free_card(torch)
    return res


def mesh_guard(torch, device, card, mp) -> dict:
    """Phase 4s f: ``MpmdPipeline(devices=[card] * 8)`` (round-robin, every
    stage on the card) gives 4a's forward rows (BUFFER_REL_BOUND of max
    |logit|); a mesh naming ``cuda:0`` and ``cuda:1`` raises, naming
    ROADMAP A15b, before anything is placed."""
    import numpy as np

    from defer_tpu_torch import MpmdPipeline, SpmdPipeline
    from defer_tpu_torch.parallel import pipeline_mesh
    from defer_tpu_torch.partition import partition

    stages = partition(mp["graph"], mp["cuts"])
    mpmd = MpmdPipeline(stages, mp["params"], devices=[device] * 8)
    out = mpmd.run(mp["inputs"])
    rel = _mesh_rel(out, mp["ref"])
    if rel > BUFFER_REL_BOUND or len(set(mpmd.devices)) != 1:
        fail(f"phase 4s f: MpmdPipeline(devices=[{device}] * 8) rows "
             f"{rel:.3g} of max|logit| off 4a's forward (bound "
             f"{BUFFER_REL_BOUND}), devices {mpmd.devices}")
    try:
        SpmdPipeline(stages, mp["params"], mesh=pipeline_mesh(
            len(stages), devices=["cuda:0", "cuda:1"] * 4))
        fail("phase 4s f: a mesh over cuda:0 and cuda:1 did not raise")
    except NotImplementedError as e:
        if "A15b" not in str(e):
            raise
    print(f"mesh path f: MpmdPipeline(devices=[{device}] * 8) rows "
          f"{rel:.3g} of max|logit| off 4a's forward; a mesh over cuda:0 "
          f"and cuda:1 raises NotImplementedError naming A15b; on {card}",
          flush=True)
    del mpmd
    free_card(torch)
    return {"mpmd_rel_err": rel, "distinct_devices_raise": "A15b"}


def mesh_train_resnet(torch, device, kernels, card, mp, base) -> dict:
    """Phase 4s e, ResNet50/8: the int8 ring on the one-card (data 2,
    stage 8) mesh, one ``loss_and_grad`` of 4r's chunk (TRAIN_M
    microbatches, each shard's half of the microbatch, the shards' losses
    averaged): loss within TRAIN_LOSS_RTOL of 4r's dp=1 int8 loss, each
    gradient leaf within TRAIN_GRAD_REL of dp=1's max |g|, one quantizer
    launch per ring step."""
    import numpy as np

    from defer_tpu_torch import PipelineTrainer, SpmdPipeline
    from defer_tpu_torch.partition import partition

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = mp["graph"]
    stages = partition(g, mp["cuts"])
    steps = TRAIN_M + len(stages) - 1
    xs = mp["inputs"][:TRAIN_M]
    ys = np.random.default_rng(SEED).integers(
        0, g.output_spec.shape[-1], (TRAIN_M, MICROBATCH))
    t = PipelineTrainer(SpmdPipeline(
        stages, mp["params"], device=device, microbatch=MICROBATCH,
        chunk=CHUNK, wire="int8", data_parallel=2), train_ce(torch))
    (loss, grads), got, sec = _counted(torch, kernels,
                                       lambda: t.loss_and_grad(xs, ys))
    if got != {"quant_int8": steps, "flash_attention": 0}:
        fail(f"phase 4s e: pp x dp launches {got} (want {steps} quantizer, "
             "one per ring step)")
    worst = _worst_leaf(t.stage_grads(grads), base["grads"])
    if not (abs(float(loss) - base["loss"]) <= TRAIN_LOSS_RTOL
            * abs(base["loss"]) and worst <= TRAIN_GRAD_REL):
        fail(f"phase 4s e: pp x dp loss {float(loss)!r} against dp=1's "
             f"{base['loss']!r} (rtol {TRAIN_LOSS_RTOL}); worst gradient "
             f"leaf {worst:.3g} of dp=1's max |g| (bound {TRAIN_GRAD_REL})")
    print(f"mesh path e: PipelineTrainer(resnet50, {len(stages)} stages x 2 "
          f"data-parallel shards, int8 wire) loss_and_grad {sec:.3f} s, "
          f"loss {float(loss):.6f} (dp=1 {base['loss']:.6f}), worst "
          f"gradient leaf {worst:.3g} of dp=1's max |g|; launches {got}; on "
          f"{card}", flush=True)
    del t, grads
    free_card(torch)
    return {"loss": float(loss), "dp1_loss": base["loss"],
            "worst_grad_rel": worst, "loss_and_grad_s": sec,
            "launches": got}


def _worst_leaf(got: list, want: list) -> float:
    """The largest leaf difference between two lists of per-stage
    parameter dicts, each as a fraction of the wanted leaf's max |v|."""
    from defer_tpu_torch.graph.ir import flatten_tree

    worst = 0.0
    for gs, ws in zip(got, want):
        for n, sub in ws.items():
            flat = flatten_tree(gs[n])
            for k, w in flatten_tree(sub).items():
                w = w.float()
                err = float((flat[k].float() - w).abs().max())
                worst = max(worst, err / max(float(w.abs().max()), 1e-30))
    return worst


def mesh_train_gpt(torch, device, kernels, card, base) -> dict:
    """Phase 4s e, GPT-2 small/12 (4r's graph on ``attn_impl="xla"``,
    weights and 4 x 8 x 64 tokens) on the one-card (stage 12, model 2)
    mesh: one ``loss_and_grad`` (loss within TRAIN_LOSS_RTOL of 4r's tp=1
    loss, the unsharded gradients within TRAIN_GRAD_REL of tp=1's max
    |g|) and one SGD step at TRAIN_SGD_LR, whose unsharded weights are
    within 1e-5 of max |w| of tp=1's after the same step."""
    from defer_tpu_torch import PipelineTrainer, SpmdPipeline
    from defer_tpu_torch.graph.ir import flatten_tree
    from defer_tpu_torch.partition import partition

    torch.backends.cuda.matmul.allow_tf32 = False
    stages = partition(base["graph"], base["cuts"])
    t = PipelineTrainer(
        SpmdPipeline(stages, base["params"], device=device,
                     microbatch=MICROBATCH, chunk=CHUNK, tensor_parallel=2),
        train_lm(torch),
        optimizer=lambda rows: torch.optim.SGD(rows, lr=TRAIN_SGD_LR))
    (loss, grads), got, sec = _counted(
        torch, kernels, lambda: t.loss_and_grad(base["xs"], base["ids"]))
    if got != {"quant_int8": 0, "flash_attention": 0}:
        fail(f"phase 4s e: GPT-2 pp x tp launches {got} (want none: "
             "attn_impl xla)")
    worst = _worst_leaf(t.stage_grads(grads), base["grads"])
    t._apply(grads)
    del grads
    trained = flatten_tree(t.trained_params())
    wworst = 0.0
    for sg in base["grads"]:
        for n, sub in sg.items():
            w0 = flatten_tree(base["params"][n])
            for k, gr in flatten_tree(sub).items():
                want = w0[k].float().cpu() - TRAIN_SGD_LR * gr
                err = float((trained[f"{n}/{k}"].float() - want).abs().max())
                wworst = max(wworst, err / max(float(want.abs().max()),
                                               1e-30))
    if not (abs(float(loss) - base["loss"]) <= TRAIN_LOSS_RTOL
            * abs(base["loss"]) and worst <= TRAIN_GRAD_REL
            and wworst <= 1e-5):
        fail(f"phase 4s e: GPT-2 pp x tp loss {float(loss)!r} against "
             f"tp=1's {base['loss']!r} (rtol {TRAIN_LOSS_RTOL}); worst "
             f"gradient leaf {worst:.3g} (bound {TRAIN_GRAD_REL}); weights "
             f"after one SGD step {wworst:.3g} of max |w| off tp=1's (bound "
             "1e-5)")
    print(f"mesh path e: PipelineTrainer(gpt2_small, {len(stages)} stages x "
          f"2 tensor-parallel ranks, attn_impl xla) loss_and_grad "
          f"{sec:.3f} s, loss {float(loss):.6f} (tp=1 {base['loss']:.6f}), "
          f"worst unsharded gradient leaf {worst:.3g} of tp=1's max |g|, "
          f"weights after one SGD step (lr {TRAIN_SGD_LR:g}) {wworst:.3g} "
          f"of max |w| off tp=1's; launches {got}; on {card}", flush=True)
    del t
    free_card(torch)
    return {"loss": float(loss), "tp1_loss": base["loss"],
            "worst_grad_rel": worst, "sgd_weights_rel": wworst,
            "loss_and_grad_s": sec, "launches": got}


# ---------------------------------------------------------------------------
# phase 4t: the ring across processes on one card
# ---------------------------------------------------------------------------

#: phase 4t's share of BUDGET_S (30 s before its GPT-2 cases)
PROCS_BUDGET_S = 45.0
#: worker processes sharing the card (gloo: NCCL refuses two ranks on one
#: card), and the spawn's deadline (the watchdog still covers the phase)
RING_PROCS = 4
PROCS_DEADLINE_S = 90.0
#: the int8 (data 2, stage 4) rows against the one-card ring on the same
#: one-card mesh, and the buffer rows against 4a's: the same f32 ops on
#: the same rows (cuDNN may choose another algorithm for another batch)
PROCS_REL_BOUND = 1e-5
#: GPT-2 small across the processes: the new tokens of its
#: ``Defer(mesh=).generate`` with the prefill (on 4g's prompts), and the ids
#: its ``Defer.score`` takes, the first 32 of 4g's SCORE_IDS rows (bucket
#: 32: ``logits`` broadcasts every row from stage 0's process, 103 MB of
#: f32 logits a call here against 412 MB at 4g's bucket 128)
PROCS_GPT_NEW = 8
PROCS_SCORE_IDS = (16, 32)
#: its scores against the one-process ``score`` on the same wire (the same
#: kernels on the same rows: 0 expected)
PROCS_SCORE_RTOL = 1e-5
#: ResNet50/8's Adam losses across the processes against 4r b's first
#: PROCS_ADAM_STEPS (the JAX package's Adam bound,
#: tests/test_torch_training.py)
PROCS_ADAM_RTOL = 1e-4
PROCS_ADAM_STEPS = 2
#: the serve group's images: 8 microbatches of 8 (4a's inputs), and the
#: endpoint's two clients' frames of 8 images each
PROCS_SERVE_IMAGES = 2 * CHUNK * MICROBATCH
#: tensor parallelism across the processes: BERT-Base in 2 stages (6
#: blocks each) on a (stage 2, model 2) mesh, one position a process
PROCS_TP_CUTS = ("block_5",)


def ring_procs_module():
    """``scripts/torch_ring_procs.py``, the launcher the CPU tests spawn
    too, loaded from the checkout beside this script."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "scripts" / "torch_ring_procs.py"
    spec = importlib.util.spec_from_file_location("torch_ring_procs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sum_worker_launches(res, key: str) -> dict:
    out: dict = {}
    for r in res:
        for name, c in r["meta"][key]["launches"].items():
            out[name] = out.get(name, 0) + c
    return out


def procs_gpt_refs(torch, device, g4t, ids) -> dict:
    """Phase 4t's GPT-2 references on the card: the one-process
    ``Defer.score`` of ``ids`` on each wire (4g's cuts, a graph replay a
    chunk) and the whole-graph forward's log-probabilities."""
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig, models
    from defer_tpu_torch.utils.convert import params_to_device

    g, params = g4t["graph"], g4t["params"]
    cuts = models.gpt_stage_cuts(GPT_STAGES, GPT_STAGES)
    out = {}
    for wire in ("buffer", "int8"):
        defer = Defer(DeferConfig(wire=wire, microbatch=MICROBATCH,
                                  chunk=CHUNK, device=device))
        out[wire] = defer.score(g, params, ids, cut_points=cuts)[0]
        del defer
    pdev = params_to_device(params, device)
    ref = []
    with torch.inference_mode():
        for lo in range(0, len(ids), MICROBATCH):
            x = torch.from_numpy(ids[lo:lo + MICROBATCH].astype(
                np.int32)).to(device)
            logp = g.apply(pdev, x).float().log_softmax(dim=-1)
            tgt = torch.from_numpy(ids[lo:lo + MICROBATCH, 1:]).to(device)
            ref.append(logp[:, :-1].gather(-1, tgt[..., None])[..., 0]
                       .sum(-1).cpu().numpy())
    out["forward"] = np.concatenate(ref)
    del pdev
    free_card(torch)
    return out


def procs_gpt(torch, res, card, g4t, refs) -> dict:
    """Phase 4t (g) and (h): the workers' GPT-2 small/12 cases against 4g's
    decoder and the one-process references (:func:`procs_gpt_refs`)."""
    import numpy as np

    n_seq, plen = GPT_PROMPTS
    t_tok = plen + PROCS_GPT_NEW
    blocks = sum(nm.startswith("block_") for nm in g4t["graph"].topo_order)
    metas = [r["meta"]["decode"]["s12"] for r in res]
    out = {}

    def slowest(case, units):
        # each process's median call after its first (which builds the
        # engine), the slowest process's
        med = max(statistics.median(m[case]["seconds"][1:]) for m in metas)
        return units / med, med

    def shares(case, want_flash, want_quant):
        # each process launches its stages' share, summed over the four
        got = [m[case]["launches"] for m in metas]
        want = [{"quant_int8": want_quant,
                 "flash_attention": want_flash
                 * len(m[case]["local_stages"]) // GPT_STAGES}
                for m in metas]
        if got != want:
            fail(f"phase 4t: gpt2 {case} launches {got} per process, want "
                 f"{want}")
        return {k: sum(c[k] for c in got) for k in got[0]}

    # (g) generate with the prefill: tokens against 4g's decoder
    case = "defer_prefill"
    toks = [r[f"dec_s12_{case}__tokens"] for r in res]
    if any(not np.array_equal(t, toks[0]) for t in toks[1:]):
        fail("phase 4t: gpt2 generate returned different tokens on the "
             "processes")
    want = g4t["prefill_tokens"][:, :t_tok]
    if toks[0].shape != want.shape:
        fail(f"phase 4t: gpt2 tokens {toks[0].shape}, want {want.shape}")
    tie = g4t["gap"][:, :t_tok] < TIE_REL * g4t["lmax"][:, :t_tok]
    first_tie = np.where(tie.any(1), tie.argmax(1), t_tok)
    diff = toks[0] != want
    first_diff = np.where(diff.any(1), diff.argmax(1), t_tok)
    bad = int((first_diff < first_tie).sum())
    want_flash = blocks * (n_seq // MICROBATCH)
    launches = shares(case, want_flash, 0)
    caps = [m[case]["captures"] for m in metas]
    rate, med = slowest(case, n_seq * PROCS_GPT_NEW)
    print(f"procs path gpt2 generate: Defer(mesh=).generate({GPT_PROMPTS} "
          f"prompts, {PROCS_GPT_NEW} new, prefill=True) over {RING_PROCS} "
          f"processes x {len(metas[0][case]['local_stages'])} stages: the "
          f"same tokens on every process; {int(diff.sum())} of {diff.size} "
          f"tokens differ from 4g's one-process decoder, rows parting "
          f"before a near tie {bad}; launches {launches} (want {want_flash} "
          f"flash: {blocks} blocks x {n_seq // MICROBATCH} groups); "
          f"captures {caps}; {rate:.1f} generated tokens/s (the slowest "
          f"process's median of {len(metas[0][case]['seconds']) - 1} "
          f"calls after the first, "
          f"{med:.3f} s) beside 4g's {g4t['tokens_per_s_prefill']:.1f} "
          f"({GPT_NEW} new, graph replay; no speed claim: four processes "
          f"time-share the card and every hop crosses host memory); on "
          f"{card}", flush=True)
    if bad:
        fail(f"phase 4t: gpt2 generate: {bad} rows differ from 4g's "
             "decoder before any near tie")
    if any(caps):
        fail(f"phase 4t: gpt2 generate captured {caps} graphs across "
             "processes")
    out["generate_prefill"] = {
        "launches": launches, "tokens_differing": int(diff.sum()),
        "rows_parting_before_a_near_tie": bad, "tokens_per_s": rate,
        "call_s": med,
        "one_process_tokens_per_s": g4t["tokens_per_s_prefill"],
        "local_stages": [m[case]["local_stages"] for m in metas],
        "boundary_bytes": [m[case]["boundary_bytes"] for m in metas]}

    # (h) score on both wires against the one-process score
    for wire in ("buffer", "int8"):
        case = f"score_{wire}"
        lps = [r[f"dec_s12_{case}__logprob"] for r in res]
        if any(not np.array_equal(lp, lps[0]) for lp in lps[1:]):
            fail(f"phase 4t: gpt2 {case} differs between the processes")
        lp = lps[0]
        if lp.shape != refs[wire].shape or not np.isfinite(lp).all():
            fail(f"phase 4t: gpt2 {case} not finite or misshapen")
        err = float(np.abs(lp - refs[wire]).max() / np.abs(refs[wire]).max())
        ferr = float(np.abs(lp - refs["forward"]).max()
                     / np.abs(refs["forward"]).max())
        steps = metas[0][case]["steps"]
        launches = shares(case, blocks * steps,
                          steps if wire == "int8" else 0)
        rate, med = slowest(case, PROCS_SCORE_IDS[0])
        print(f"procs path gpt2 {case}: Defer(mesh=).score("
              f"{PROCS_SCORE_IDS} ids, bucket {PROCS_SCORE_IDS[1]}) over "
              f"{RING_PROCS} processes, {steps} steps: log-probs {err:.3g} "
              f"max rel off the one-process score (rtol {PROCS_SCORE_RTOL}),"
              f" {ferr:.3g} off the whole-graph forward; launches "
              f"{launches} (one quantizer launch per process and int8 "
              f"step); {rate:.1f} scored sequences/s (the slowest "
              f"process's median of {len(metas[0][case]['seconds']) - 1} "
          f"calls after the first, "
              f"{med:.3f} s) beside 4g's "
              f"{g4t['score_sequences_per_s'][wire]:.1f} (16 x 100, bucket "
              f"128, graph replay); on {card}", flush=True)
        if not np.allclose(lp, refs[wire], rtol=PROCS_SCORE_RTOL, atol=0):
            fail(f"phase 4t: gpt2 {case} differs from the one-process "
                 "score")
        if wire == "buffer" and not np.allclose(lp, refs["forward"],
                                                rtol=SCORE_RTOL, atol=0):
            fail("phase 4t: gpt2 score differs from the whole-graph forward")
        out[case] = {"launches": launches, "steps": steps, "rel_err": err,
                     "forward_rel_err": ferr, "sequences_per_s": rate,
                     "call_s": med, "boundary_bytes": [
                         m[case]["boundary_bytes"] for m in metas]}
    return out


def procs_train(torch, res, card, t4) -> dict:
    """Phase 4t (i)-(iv): the workers' ResNet50/8 training across the four
    processes (``R.TRAIN["card"]``: 4r's chunk and targets, two stages a
    process) against 4r's own results (``t4``: 4r b's int8 loss, stage
    gradients and Adam losses, 4r a's buffer-wire loss and gradients)."""
    import numpy as np

    from defer_tpu_torch.graph.ir import flatten_tree

    metas = {k: [r["meta"]["train"][k] for r in res]
             for k in res[0]["meta"]["train"]}
    out = {}

    def slowest(key, case):
        # each process's median call, the slowest process's
        return max(statistics.median(m[case]["seconds"])
                   for m in metas[key])

    def per_process(key, case, quant):
        got = [m[case]["launches"] for m in metas[key]]
        want = {"quant_int8": quant, "flash_attention": 0}
        if any(g != want for g in got):
            fail(f"phase 4t: train {key} {case} launches {got} per process, "
                 f"want {want} each")
        return {k: sum(g[k] for g in got) for k in want}

    def held(key, base) -> float:
        # the loss on every process, every stage's leaves from its process
        ref = {f"{n}/{k}": v for sg in base["grads"] for n, sub in sg.items()
               for k, v in flatten_tree(sub).items()}
        losses = [m["grad"]["loss"] for m in metas[key]]
        if not all(abs(lo - base["loss"]) <= TRAIN_LOSS_RTOL
                   * abs(base["loss"]) for lo in losses):
            fail(f"phase 4t: train {key} losses {losses} against 4r's "
                 f"{base['loss']!r} (rtol {TRAIN_LOSS_RTOL})")
        pre, seen, worst = f"tr_{key}_grad__g/", set(), 0.0
        for r in res:
            for name in r:
                if not name.startswith(pre):
                    continue
                leaf = name[len(pre):]
                want = ref[leaf].float().numpy()
                scale = max(float(np.abs(want).max()), 1e-30)
                err = float(np.abs(r[name] - want).max()) / scale
                if not err <= TRAIN_GRAD_REL:
                    fail(f"phase 4t: train {key} gradient of {leaf} "
                         f"{err:.3g} of 4r's max |g| (bound "
                         f"{TRAIN_GRAD_REL})")
                worst = max(worst, err)
                seen.add(leaf)
        if seen != set(ref):
            fail(f"phase 4t: train {key}: the processes returned "
                 f"{len(seen)} gradient leaves, 4r has {len(ref)}")
        return worst

    def wire_bytes(key):
        # a boundary's bytes a ring step, forward and backward apart
        m = metas[key][0]["grad"]
        buf, steps = m["buf_elems"], m["ring_steps"]
        fwd = (MICROBATCH * (buf + 4 * (buf // 256)) if "int8" in key
               else MICROBATCH * buf * 4)
        bwd = MICROBATCH * buf * 4
        for mm in metas[key]:
            g = mm["grad"]
            if (g["boundary_sends"] != 2 * steps
                    or g["boundary_bytes"] != steps * (fwd + bwd)
                    or g["transport"] != "gloo"):
                fail(f"phase 4t: train {key} crossed {g['boundary_bytes']} "
                     f"bytes in {g['boundary_sends']} sends over "
                     f"{g['transport']} (want {steps} x ({fwd} + {bwd}) in "
                     f"{2 * steps}, gloo)")
        return steps, fwd, bwd

    # (i) int8 loss_and_grad against 4r b
    key = "s8_int8"
    steps, fwd, bwd = wire_bytes(key)
    worst = held(key, t4["int8"])
    launches = per_process(key, "grad", steps)
    sec = slowest(key, "grad")
    out["int8_loss_and_grad"] = {
        "losses": [m["grad"]["loss"] for m in metas[key]],
        "reference_loss": t4["int8"]["loss"], "worst_grad_rel": worst,
        "launches": launches, "ring_steps": steps, "seconds": sec,
        "one_process_seconds": t4["int8_s"],
        "local_stages": [m["grad"]["local_stages"] for m in metas[key]],
        "bytes_per_boundary_step": {"forward": fwd, "backward": bwd}}
    print(f"procs path train (i): PipelineTrainer(resnet50, 8 stages, int8) "
          f"over {RING_PROCS} processes x 2 stages: loss "
          f"{metas[key][0]['grad']['loss']:.6f} on every process (4r "
          f"{t4['int8']['loss']:.6f}), worst gradient leaf {worst:.3g} of "
          f"4r's max |g| (bound {TRAIN_GRAD_REL}); launches {launches} "
          f"({steps} a process, one per ring step); a boundary carries "
          f"{fwd / 1e6:.3f} MB forward (int8) and {bwd / 1e6:.3f} MB back "
          f"(f32) a step; loss_and_grad {sec:.3f} s (the slowest process) "
          f"beside 4r's {t4['int8_s']:.3f} s in one process (no speed "
          f"claim: four processes time-share the card and every hop "
          f"crosses host memory); on {card}", flush=True)

    # (ii) PROCS_ADAM_STEPS Adam steps at TRAIN_ADAM_LR against 4r b's
    adam = [m["adam"] for m in metas[key]]
    losses = adam[0]["losses"]
    want_losses = t4["adam_losses"][:PROCS_ADAM_STEPS]
    launches = per_process(key, "adam", PROCS_ADAM_STEPS * steps)
    digests = {a["digest"] for a in adam}
    if (any(a["losses"] != losses for a in adam)
            or len(losses) != PROCS_ADAM_STEPS
            or not np.allclose(losses, want_losses,
                               rtol=PROCS_ADAM_RTOL, atol=0)
            or not losses[-1] < losses[0] or len(digests) != 1):
        fail(f"phase 4t: train Adam losses {[a['losses'] for a in adam]} "
             f"against 4r's {want_losses} (rtol {PROCS_ADAM_RTOL}, "
             f"falling); trained_params digests {sorted(digests)}")
    rel = [float(np.abs(r[f"tr_{key}_adam__run_rows"]
                        - r[f"tr_{key}_adam__fresh_rows"]).max())
           / float(np.abs(r[f"tr_{key}_adam__fresh_rows"]).max())
           for r in res]
    if max(rel) > PROCS_REL_BOUND:
        fail(f"phase 4t: the trained deployment's run is {max(rel):.3g} of "
             f"max |output| off a fresh pipeline of trained_params() (bound "
             f"{PROCS_REL_BOUND})")
    step_s = slowest(key, "adam")
    out["int8_adam"] = {"losses": losses, "reference_losses":
                        want_losses, "launches": launches,
                        "step_s": step_s, "one_process_step_s":
                        t4["step_s"], "run_vs_fresh_rel": max(rel),
                        "trained_params_equal": True}
    print(f"procs path train (ii): Adam (lr {TRAIN_ADAM_LR:g}) losses "
          f"{[round(x, 4) for x in losses]} on every process (4r "
          f"{[round(x, 4) for x in want_losses]}); launches "
          f"{launches}; trained_params() equal on every process; the "
          f"trained deployment's run {max(rel):.3g} of max |output| off a "
          f"fresh pipeline of it; {step_s:.3f} s a step (the slowest "
          f"process's median) beside 4r's {t4['step_s']:.3f} s; on {card}",
          flush=True)

    # (iii) the buffer wire against 4r a
    key = "s8_buffer"
    steps, fwd, bwd = wire_bytes(key)
    worst = held(key, t4["buffer"])
    launches = per_process(key, "grad", 0)
    sec = slowest(key, "grad")
    out["buffer_loss_and_grad"] = {
        "losses": [m["grad"]["loss"] for m in metas[key]],
        "reference_loss": t4["buffer"]["loss"], "worst_grad_rel": worst,
        "launches": launches, "seconds": sec,
        "one_process_seconds": t4["buffer_s"],
        "bytes_per_boundary_step": {"forward": fwd, "backward": bwd}}
    print(f"procs path train (iii): buffer wire loss "
          f"{metas[key][0]['grad']['loss']:.6f} on every process (4r "
          f"{t4['buffer']['loss']:.6f}), worst gradient leaf {worst:.3g}; "
          f"launches {launches}; {fwd / 1e6:.3f} MB a boundary a step each "
          f"way; loss_and_grad {sec:.3f} s beside 4r's "
          f"{t4['buffer_s']:.3f} s; on {card}", flush=True)
    return out


def procs_serve(res, card, ep_rate: float) -> dict:
    """Phase 4t (j) and (k): the workers' ResNet50/8 services on the int8
    wire, two stages a process, against the ring group's own
    ``Defer(mesh=).run`` int8 rows of the same 8 microbatches
    (``defer_run_rows``).  (j) ``run_defer``: the rows bit-equal and the
    same on every process, then ``END_OF_STREAM``; one quantizer launch
    per process and step (preflight and drain included); every handle
    healthy.  (k) ``serve_endpoint(max_clients=2)``: two concurrent
    clients in the leader's worker, frames 0-3 and 4-7, raw replies
    within ENDPOINT_RAW_REL_BOUND of max |output| of those rows; END
    echoed to both (no client error), no endpoint error on any process,
    the leader's counters at 64 images and the followers' at 0, the same
    address everywhere.  Neither captures a graph."""
    import numpy as np

    want = res[0]["defer_run_rows"]
    out: dict = {}
    # (j) run_defer
    metas = [r["meta"]["serve"]["queue_int8"] for r in res]
    for i, (r, m) in enumerate(zip(res, metas)):
        rows = r.get("sv_queue_int8__rows")
        if not (m["end"] and m["healthy"]) or m["error"] or m["threads_left"]:
            fail(f"phase 4t: run_defer on process {i}: end {m['end']}, "
                 f"healthy {m['healthy']}, error {m['error']!r}, threads "
                 f"left {m['threads_left']}")
        if rows is None or not np.array_equal(rows, want) \
                or not np.array_equal(r["defer_run_rows"], want):
            fail(f"phase 4t: run_defer rows on process {i} are not the "
                 "ring group's Defer(mesh=).run int8 rows")
        if m["launches"]["quant_int8"] != m["steps"] or m["captures"]:
            fail(f"phase 4t: run_defer on process {i} made "
                 f"{m['launches']} launches in {m['steps']} steps, "
                 f"{m['captures']} captures: want one quantizer launch a "
                 "step, none captured")
    for k in ("steps", "pushes", "dispatches", "inferences"):
        if len({m[k] for m in metas}) != 1:
            fail(f"phase 4t: run_defer {k} differ between the processes: "
                 f"{[m[k] for m in metas]}")
    j = metas[0]
    out["run_defer"] = {
        "launches": _sum_worker_launches([{"meta": r["meta"]["serve"]}
                                          for r in res], "queue_int8"),
        "steps": j["steps"], "pushes": j["pushes"],
        "dispatches": j["dispatches"], "inferences": j["inferences"],
        "seconds": max(m["seconds"] for m in metas), "max_abs_diff": 0.0}
    print(f"procs path run_defer: ResNet50/8 int8 across {RING_PROCS} "
          f"processes, {PROCS_SERVE_IMAGES} images then END_OF_STREAM on "
          "every process, bit-equal to Defer(mesh=).run; "
          f"{j['pushes']} pushes ({j['steps']} steps, preflight and drain "
          f"included), quantizer launches {out['run_defer']['launches']} "
          f"(one a process and step); {j['dispatches']} dispatches and "
          f"{j['inferences']} inferences on each; "
          f"{out['run_defer']['seconds']:.2f} s; on {card}", flush=True)
    # (k) serve_endpoint, two concurrent clients
    metas = [r["meta"]["serve"]["ep_pair_int8"] for r in res]
    lead = metas[0]
    if lead["client_errors"] or any(m["errors"] or m["alive"]
                                    for m in metas):
        fail(f"phase 4t: serve_endpoint: client errors "
             f"{lead['client_errors']}, endpoint errors "
             f"{[m['errors'] for m in metas]}, alive "
             f"{[m['alive'] for m in metas]}")
    got = np.concatenate([res[0][f"sv_ep_pair_int8__{k}"] for k in "ab"])
    if got.shape != want.shape:
        fail(f"phase 4t: serve_endpoint rows {got.shape}, want {want.shape}")
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if err > ENDPOINT_RAW_REL_BOUND * scale:
        fail(f"phase 4t: serve_endpoint rows {err / scale:.3g} of max "
             f"|output| off Defer(mesh=).run (bound "
             f"{ENDPOINT_RAW_REL_BOUND})")
    counters = [(m["samples_in"], m["samples_out"]) for m in metas]
    if counters != [(PROCS_SERVE_IMAGES,) * 2] + [(0, 0)] * (RING_PROCS - 1):
        fail(f"phase 4t: serve_endpoint counters {counters}")
    if len({tuple(m["address"]) for m in metas}) != 1:
        fail("phase 4t: serve_endpoint addresses differ: "
             f"{[m['address'] for m in metas]}")
    if any(m["launches"]["quant_int8"] != m["steps"] or m["captures"]
           for m in metas):
        fail(f"phase 4t: serve_endpoint launches "
             f"{[m['launches'] for m in metas]} in "
             f"{[m['steps'] for m in metas]} steps")
    rate = PROCS_SERVE_IMAGES / lead["clients_s"]
    out["serve_endpoint"] = {
        "rel_err": err / scale, "launches": _sum_worker_launches(
            [{"meta": r["meta"]["serve"]} for r in res], "ep_pair_int8"),
        "steps": lead["steps"], "pushes": lead["pushes"],
        "images_per_s": rate, "clients_s": lead["clients_s"],
        "one_process_images_per_s": ep_rate}
    print(f"procs path serve_endpoint: two concurrent clients of 4 frames "
          f"x {MICROBATCH} images, raw replies {err / scale:.3g} of max "
          f"|output| off Defer(mesh=).run (bound {ENDPOINT_RAW_REL_BOUND}),"
          f" END echoed to both; counters {counters[0]} on the leader, 0 "
          f"elsewhere; {lead['pushes']} pushes, quantizer launches "
          f"{out['serve_endpoint']['launches']}; {rate:.1f} images/s "
          f"beside 4i's {ep_rate:.1f} (bf16, one process): no speed claim, "
          "four processes time-share one card and every hop crosses host "
          f"memory; on {card}", flush=True)
    return out


def procs_tp(res, R, card, bp, bthr, mesh_rates) -> dict:
    """Phase 4t's tensor parallelism across the processes: BERT-Base/2 on a
    (stage 2, model 2) mesh, process 2s + r holding model rank r of stage
    s.  Per wire: the rows of ``SpmdPipeline.run`` (and of
    ``Defer(mesh=).run`` and ``.stream`` where the preset runs them; the
    card's leaves them to the CPU tests) against 4b's whole-graph forward
    (MESH_REL_BOUND, INT8_REL_BOUND) and the same on every process; per
    process a step's
    flash launches (its stage's 6 blocks, one rank), quantizer launch (one
    on the int8 wire), all-reduces (two a block, each the [8, 128, 768]
    f32 activation) and slot sent; the slowest process's median push in
    sequences/s beside 4b's ring and 4s's one-card tp=2 ring, with the
    host seconds of a push inside the all-reduces and the hop."""
    import numpy as np

    from defer_tpu_torch import partition

    tpc = R.TP["card"]
    g = bp["graph"]
    stage_blocks = [sum(n.startswith("block_") for n in st.node_names)
                    for st in partition(g, list(tpc["ring"][2]))]
    act = MICROBATCH * int(np.prod(g.nodes["block_0"].out_spec.shape)) * 4
    out: dict = {}
    for wire in R.WIRES:
        metas = [r["meta"]["tp"]["ring"][wire] for r in res]
        steps = metas[0]["steps"]
        bound = MESH_REL_BOUND if wire == "buffer" else INT8_REL_BOUND
        rows = [r[f"tp_ring_{wire}__rows"] for r in res]
        err = max(_mesh_rel(x, bp["ref"]) for x in rows)
        if (not all(np.isfinite(x).all() for x in rows) or err > bound
                or any(not np.array_equal(x, rows[0]) for x in rows)):
            fail(f"phase 4t tp {wire}: rows {err:.3g} of max|output| off "
                 f"4b's forward (bound {bound}) or not the same on every "
                 "process")
        for key in (("defer_run", "defer_stream")
                    if tpc.get("defer", True) else ()):
            if any(not np.array_equal(r[f"tp_ring_{wire}__{key}"], x)
                   for r, x in zip(res, rows)):
                fail(f"phase 4t tp {wire}: Defer(mesh=).{key[6:]} differs "
                     "from SpmdPipeline.run")
        buf = metas[0]["buf_elems"]
        slot = (MICROBATCH * (buf + 4 * (buf // 256)) if wire == "int8"
                else MICROBATCH * buf * 4)
        for i, m in enumerate(metas):
            k = i // tpc["tp"]
            want = {"quant_int8": steps if wire == "int8" else 0,
                    "flash_attention": stage_blocks[k] * steps}
            seen = (m["local_stages"], m["ranks"], m["transport"],
                    m["captures"], m["boundary_sends"],
                    m["boundary_bytes"], m["allreduce_calls"],
                    m["allreduce_bytes"])
            calls = 2 * stage_blocks[k] * steps
            if m["launches"] != want or seen != (
                    [k], [i % tpc["tp"]], "gloo", 0, steps, steps * slot,
                    calls, calls * act):
                fail(f"phase 4t tp {wire}: process {i} launches "
                     f"{m['launches']} (want {want}), stages/ranks/"
                     f"transport/captures/sends/bytes/all-reduces/bytes "
                     f"{seen}")
        launches = _sum_worker_launches_tp(res, wire)
        slow = max(metas, key=lambda m: m["push_s"])
        rate = CHUNK * MICROBATCH / slow["push_s"]
        out[wire] = {
            "rel_err": err, "launches": launches, "steps": steps,
            "allreduce_calls_per_process_step": [2 * b for b in stage_blocks],
            "allreduce_bytes_each": act, "bytes_per_boundary_step": slot,
            "sequences_per_s": rate, "push_s": slow["push_s"],
            "push_spread_s": slow["push_spread_s"],
            "push_allreduce_s": slow["push_allreduce_s"],
            "push_boundary_s": slow["push_boundary_s"],
            "ring_sequences_per_s": bthr[f"pipeline_{wire}"],
            "one_card_tp2_sequences_per_s": mesh_rates[wire]}
        print(f"procs path tp {wire}: bert_base in 2 stages x 2 "
              f"tensor-parallel ranks, one a process, over gloo: rows "
              f"{err:.3g} of max|output| off 4b's forward (bound {bound}), "
              f"the same on every process; launches {launches} in {steps} "
              f"steps ({launches['flash_attention'] // steps} flash a step "
              f"summed); {2 * max(stage_blocks)} all-reduces of "
              f"{act / 1e6:.3f} MB a process a step; {slot / 1e6:.3f} MB a "
              f"boundary a step; {rate:.1f} seq/s (median of "
              f"{R.TIMED_PUSHES} pushes of {CHUNK} steps, the slowest "
              f"process's {slow['push_s'] * 1e3:.1f} ms, spread "
              f"{slow['push_spread_s'] * 1e3:.1f} ms; of it "
              f"{slow['push_allreduce_s'] * 1e3:.1f} ms in the all-reduces "
              f"and {slow['push_boundary_s'] * 1e3:.1f} ms in the hop's "
              f"sends) beside 4b's ring {bthr[f'pipeline_{wire}']:.1f} and "
              f"4s's one-card tp=2 ring {mesh_rates[wire]:.1f}: no speed "
              f"claim, four processes share one card and every psum "
              f"crosses host memory; on {card}", flush=True)
    return out


def _sum_worker_launches_tp(res, wire) -> dict:
    """The tp group's launches on ``wire`` summed over the workers."""
    out: dict = {}
    for r in res:
        for name, c in r["meta"]["tp"]["ring"][wire]["launches"].items():
            out[name] = out.get(name, 0) + c
    return out


def procs_spawn(mp, bp, g4t) -> dict:
    """Phase 4t's spawn, started as phase 4o begins: the launcher's card
    presets checked against this smoke's sizes, 4a's, 4b's, 4g's and 4r's
    weights and inputs written once, and ``scripts/torch_ring_procs.py``'s
    four workers spawned on a thread.  A worker imports torch, builds its
    graphs and maps the inputs on the host (10-27 s) beside 4o, then waits
    for the go file that :func:`procs_go` writes as 4s begins before it
    touches the card; :func:`procs_path` joins the thread."""
    import threading
    from pathlib import Path

    import numpy as np

    R = ring_procs_module()
    cfg, dc = R.PRESETS["card"], R.DECODE["card"]
    if (cfg["microbatch"], cfg["chunk"], cfg["frames"]) != (
            MICROBATCH, CHUNK, 2 * CHUNK):
        fail("phase 4t: the launcher's card preset is not 4a's batch")
    if ((dc["microbatch"], dc["chunk"], dc["max_len"], dc["prompts"],
         dc["new"], dc["score_ids"])
            != (MICROBATCH, CHUNK, GPT_MAX_LEN, GPT_PROMPTS, PROCS_GPT_NEW,
                PROCS_SCORE_IDS)
            or dc["meshes"]["s12"][1] != GPT_STAGES):
        fail("phase 4t: the launcher's card decode preset is not 4g's")
    tc = R.TRAIN["card"]
    if ((tc["m"], tc["microbatch"], tc["chunk"], tc["steps"]["resnet50"],
         tc["lr"]["resnet50"]["adam"], tc["models"]["resnet50"][2])
            != (TRAIN_M, MICROBATCH, CHUNK, PROCS_ADAM_STEPS, TRAIN_ADAM_LR,
                "RESNET50_8STAGE_CUTS")
            or list(tc["runs"]) != ["s8_int8", "s8_buffer"]):
        fail("phase 4t: the launcher's card train preset is not 4r's")
    tpc = R.TP["card"]
    if ((tpc["microbatch"], tpc["chunk"], tpc["tp"], tpc["ring"])
            != (MICROBATCH, CHUNK, 2, ("bert_base", {"seq_len": SEQ_LEN},
                                       PROCS_TP_CUTS, 2))):
        fail("phase 4t: the launcher's card tp preset is not 4b's batch "
             "and cut")
    vocab = g4t["graph"].nodes["lm_head"].out_spec.shape[-1]
    ids = np.random.default_rng(SEED + 2).integers(
        0, vocab, SCORE_IDS)[:, :PROCS_SCORE_IDS[1]]

    out_dir = Path(__file__).resolve().parent.joinpath(*PYCACHE[:2],
                                                       "ring_procs")
    go = out_dir / "go"
    go.unlink(missing_ok=True)
    inputs = {"resnet_params": mp["params"], "resnet_x": mp["inputs"],
              "bert_params": bp["params"], "bert_ids": bp["inputs"],
              "gpt2_small_params": g4t["params"],
              "gpt_prompts": g4t["prompts"], "gpt_score_ids": ids,
              # (i)-(iii): 4r's weights (4a's), chunk and targets
              "train_resnet50_params": mp["params"],
              "train_resnet50_x": mp["inputs"][:TRAIN_M],
              "train_resnet50_y": np.random.default_rng(SEED).integers(
                  0, mp["graph"].output_spec.shape[-1],
                  (TRAIN_M, MICROBATCH))}
    spawned: list = []

    def spawn():
        try:
            spawned.append(R.spawn(RING_PROCS, "cuda", "card", out_dir,
                                   inputs, deadline_s=PROCS_DEADLINE_S
                                   + DAG_BUDGET_S, timeout_s=60.0, go=go))
        except RuntimeError as e:
            spawned.append(e)

    th = threading.Thread(target=spawn, daemon=True)
    t0 = time.perf_counter()
    th.start()
    return {"R": R, "ids": ids, "thread": th, "spawned": spawned, "t0": t0,
            "go": go}


def procs_go(run) -> None:
    """Let phase 4t's workers at the card (:func:`procs_spawn`)."""
    run["go"].parent.mkdir(parents=True, exist_ok=True)
    run["go"].touch()
    run["t0"] = time.perf_counter()


def procs_path(torch, device, kernels, card, mp, bp, thr, bthr, g4t, t4,
               run, ep_rate, mesh_rates) -> dict:
    """Phase 4t. Four ``torch.distributed`` processes on the one card (gloo),
    spawned once by ``scripts/torch_ring_procs.py`` with 4a's and 4b's
    seed-0 weights and inputs (written once for the workers to map;
    :func:`procs_spawn` started them as 4s began: ``run``), TF32
    off: (a) ResNet50/8
    on a (stage 8) mesh, two stages a process, both wires: rows against
    4a's ring (buffer within PROCS_REL_BOUND of max |logit|, int8 within
    INT8_REL_BOUND and top-1 equal), one quantizer launch per process and
    int8 step, the transport, the bytes a boundary carries a step, images/s
    of the median of TIMED_PUSHES steady pushes (the slowest process's)
    beside 4a's ring; (b) BERT-Base/12, three stages a
    process, both wires, against 4b's ring rows, 12 flash launches a step
    over the processes; (c) ResNet50/4 on (data 2, stage 4), int8, each
    line's ring on a sub-group, against the one-card ring on the same
    one-card mesh; (d) ``Defer(mesh=).run`` and ``.stream`` of (a)'s int8
    deployment equal to its ``SpmdPipeline.run``; (e) the collectives over
    a stage axis across processes (every process on one line, and lines on
    sub-groups) equal to the same calls on one card; (f) the guards name
    why (mpmd by design, A15b for two devices in one process), and NCCL on one card is
    refused naming gloo when a ring is placed; (g) GPT-2 small/12, three
    stages a process, on 4g's weights: ``Defer(mesh=).generate`` of 4g's
    prompts with the prefill against 4g's decoder (:func:`procs_gpt`);
    (h) ``Defer(mesh=).score`` on both wires against the one-process
    score (:func:`procs_gpt_refs`); (i)-(iv) ``PipelineTrainer`` of
    ResNet50/8, two stages a process, against 4r's results
    (:func:`procs_train`); (j) and (k) ``Defer(mesh=).run_defer`` and
    ``.serve_endpoint`` of (a)'s int8 deployment against (d)'s rows
    (:func:`procs_serve`); (l) tensor parallelism across the processes:
    BERT-Base/2 on a (stage 2, model 2) mesh, one position a process
    (:func:`procs_tp`)."""
    import numpy as np

    from defer_tpu_torch import SpmdPipeline, partition
    from defer_tpu_torch.parallel import mesh as M
    from defer_tpu_torch.parallel import pipeline_mesh

    R, ids, th = run["R"], run["ids"], run["thread"]
    cfg = R.PRESETS["card"]
    t0 = time.perf_counter()
    # the references run while the workers finish their host start
    # (c)'s reference: the one-card (data 2, stage 4) ring, int8
    dstages = cfg["dp_stages"]
    one = SpmdPipeline(partition(mp["graph"], num_stages=dstages),
                       mp["params"], mesh=pipeline_mesh(
                           dstages, 2, devices=[device] * 2 * dstages),
                       microbatch=MICROBATCH, chunk=CHUNK, wire="int8")
    dp_ref = one.run(mp["inputs"])
    del one
    # (h)'s: 4g's score ids cut to PROCS_SCORE_IDS, the one-process score
    grefs = procs_gpt_refs(torch, device, g4t, ids)
    refs_s = time.perf_counter() - t0
    th.join()
    res = run["spawned"][0]
    if isinstance(res, RuntimeError):
        fail(f"phase 4t: {res}")
    spawn_s = time.perf_counter() - run["t0"]
    wait_s = time.perf_counter() - t0
    # each worker's timeline from its start, the latest worker's
    marks = {k: max(r["meta"]["seconds"][k] for r in res)
             for k in res[0]["meta"]["seconds"]}
    out = {"spawn_s": spawn_s, "phase_wait_s": wait_s,
           "references_s": refs_s, "procs": RING_PROCS, "backend": "gloo",
           "timed_pushes": R.TIMED_PUSHES, "worker_seconds": marks}
    print("procs path workers (s from each start, the latest of 4): "
          + ", ".join(f"{k} {v:.2f}" for k, v in marks.items())
          + f"; the references beside them in {refs_s:.2f} s; the go to "
          f"results {spawn_s:.1f} s, {wait_s:.1f} s of them in 4t",
          flush=True)
    if any(len(r["meta"]["stage_latencies"]) != 2
           or min(r["meta"]["stage_latencies"]) <= 0 for r in res):
        fail("phase 4t: stage_latencies is not each process's two stages")

    def rel(a, b):
        return float(np.abs(a - b).max()) / float(np.abs(b).max())

    def held(key, want_rows, bound, top1=False):
        errs = [rel(r[f"{key}_rows"], want_rows) for r in res]
        if max(errs) > bound:
            fail(f"phase 4t: {key} rows {max(errs):.3g} of max |output| off "
                 f"the one-process ring (bound {bound})")
        if top1 and not all((r[f"{key}_rows"].argmax(-1)
                             == want_rows.argmax(-1)).all() for r in res):
            fail(f"phase 4t: {key} changed a top-1 class")
        return max(errs)

    # (a) and (b): rows, launches, transport, bytes, rates
    ring_thr = {"resnet": thr, "bert": bthr}
    want_flash = {"resnet": 0, "bert": sum(
        name.startswith("block_") for name in bp["graph"].topo_order)}
    for key, ref in (("resnet", mp), ("bert", bp)):
        for wire in R.WIRES:
            k = f"{key}_{wire}"
            metas = [r["meta"][k] for r in res]
            steps = metas[0]["steps"]
            bound = PROCS_REL_BOUND if wire == "buffer" else INT8_REL_BOUND
            err = held(k, ref["rows"][wire], bound,
                       top1=key == "resnet" and wire == "int8")
            launches = _sum_worker_launches(res, k)
            want = {"quant_int8": RING_PROCS * steps if wire == "int8"
                    else 0, "flash_attention": want_flash[key] * steps}
            if (launches != want or any(
                    m["launches"]["quant_int8"] != (steps if wire == "int8"
                                                    else 0)
                    for m in metas)):
                fail(f"phase 4t: {k} launches {launches} (per process "
                     f"{[m['launches'] for m in metas]}), want {want}: one "
                     "quantizer launch per process and int8 step")
            buf = metas[0]["buf_elems"]
            hop = (MICROBATCH * (buf + 4 * (buf // 256)) if wire == "int8"
                   else MICROBATCH * buf * 4)
            per_send = [m["boundary_bytes"] / m["boundary_sends"]
                        for m in metas]
            seen = [(m["transport"], m["captures"], m["boundary_sends"])
                    for m in metas]
            if (any(t != ("gloo", 0, steps) for t in seen)
                    or any(b != hop for b in per_send)):
                fail(f"phase 4t: {k} transport/captures/sends {seen} (want "
                     f"gloo, 0, {steps}) or bytes a boundary a step "
                     f"{per_send} (want {hop})")
            # the slowest process's median push, and its pushes' spread
            slow = max(metas, key=lambda m: m["push_s"])
            rate = CHUNK * MICROBATCH / slow["push_s"]
            one_rate = ring_thr[key][f"pipeline_{wire}"]
            unit = "img" if key == "resnet" else "seq"
            out[k] = {"rel_err": err, "launches": launches, "steps": steps,
                      "bytes_per_boundary_step": hop,
                      "per_second": rate, "push_s": slow["push_s"],
                      "push_spread_s": slow["push_spread_s"],
                      "one_process_per_second": one_rate,
                      "local_stages": [m["local_stages"] for m in metas]}
            print(f"procs path {k}: {RING_PROCS} processes x "
                  f"{len(metas[0]['local_stages'])} stages over gloo, rows "
                  f"{err:.3g} of max|output| off the one-process ring "
                  f"(bound {bound}); launches {launches} in {steps} steps; "
                  f"{hop / 1e6:.3f} MB a boundary a step; {rate:.1f} "
                  f"{unit}/s (median of {R.TIMED_PUSHES} steady pushes, "
                  f"{slow['push_s'] * 1e3:.1f} ms, spread "
                  f"{slow['push_spread_s'] * 1e3:.1f} ms) against the "
                  f"one-process ring's {one_rate:.1f} (graph replay); on "
                  f"{card}", flush=True)

    # (c) (data 2, stage 4): each line's ring on a sub-group
    err = held("dp_int8", dp_ref, PROCS_REL_BOUND)
    metas = [r["meta"]["dp_int8"] for r in res]
    launches = _sum_worker_launches(res, "dp_int8")
    if launches["quant_int8"] != RING_PROCS * metas[0]["steps"]:
        fail(f"phase 4t: dp int8 launches {launches}")
    out["dp_int8"] = {"rel_err": err, "launches": launches,
                      "local_stages": [m["local_stages"] for m in metas],
                      "per_second": CHUNK * MICROBATCH / max(
                          m["push_s"] for m in metas)}
    print(f"procs path dp_int8: (data 2, stage {dstages}) over "
          f"{RING_PROCS} processes, rows {err:.3g} of max|logit| off the "
          f"one-card ring on the same one-card mesh (bound "
          f"{PROCS_REL_BOUND}); launches {launches}", flush=True)

    # (d) Defer over the same mesh
    for what in ("run", "stream"):
        for r in res:
            if not np.array_equal(r[f"defer_{what}_rows"],
                                  r["resnet_int8_rows"]):
                fail(f"phase 4t: Defer(mesh=).{what} differs from "
                     "SpmdPipeline.run")

    # (e) the collectives against the same calls on one card
    for which, dp in (("line", 1), ("sub", 2)):
        n = len(res[0][f"{which}_positions"]) * RING_PROCS // dp
        x = np.random.default_rng(R.SEED + 1).integers(
            -8, 8, (dp, n, 8, 8)).astype(np.float32)
        ring = [(i, (i + 1) % n) for i in range(n)]
        for d in range(dp):
            xs = [torch.from_numpy(a.copy()) for a in x[d]]
            want = {"psum": M.psum(xs), "ppermute": M.ppermute(xs, ring),
                    "ppermute_partial": M.ppermute(xs, [(0, 1)]),
                    "all_gather": M.all_gather(xs, 0),
                    "all_gather_tiled": M.all_gather(xs, 0, True),
                    "all_to_all": M.all_to_all(xs, 0, 1)}
            for op in R.COLLECTIVES:
                for r in res:
                    for pos, got in zip(r[f"{which}_positions"],
                                        r[f"{which}_{op}"]):
                        if pos[0] == d and not np.array_equal(
                                got, want[op][pos[1]].numpy()):
                            fail(f"phase 4t: {op} across processes ({which})"
                                 f" differs at {pos.tolist()}")
    # (f) the guards
    for r in res:
        for name, queue in R.GUARDS.items():
            if queue not in r["meta"]["guards"][name]:
                fail(f"phase 4t: guard {name} did not raise naming {queue}: "
                     f"{r['meta']['guards'][name]!r}")
        if 'backend="gloo"' not in r["meta"]["nccl_refused"]:
            fail("phase 4t: NCCL on one card was not refused naming gloo: "
                 f"{r['meta']['nccl_refused']!r}")
    print(f"procs path: Defer(mesh=).run/.stream equal to SpmdPipeline.run; "
          f"{len(R.COLLECTIVES)} collectives x 2 meshes equal to one card; "
          f"guards {sorted(R.GUARDS)} raise naming their queues; NCCL on "
          f"one card refused: {res[0]['meta']['nccl_refused']!r}; spawn "
          f"from the go to results {spawn_s:.1f} s; on {card}", flush=True)
    out["guards"] = {k: R.GUARDS[k] for k in R.GUARDS}
    # (g) and (h): GPT-2 small across the processes
    out["gpt2"] = procs_gpt(torch, res, card, g4t, grefs)
    # (i)-(iv): ResNet50/8 training across the processes
    out["train"] = procs_train(torch, res, card, t4)
    # (j) and (k): ResNet50/8's queue service and endpoint
    out["serve"] = procs_serve(res, card, ep_rate)
    # (l): BERT-Base/2 on (stage 2, model 2), one position a process
    out["tp"] = procs_tp(res, R, card, bp, bthr, mesh_rates)
    del res
    free_card(torch)
    return out


RESNET_GROUPS = {"quant_int8": ("quant_int8",),
                 "conv (cuDNN, incl. layout)": ("xmma", "cudnn", "conv",
                                                "Nchw", "Nhwc", "implicit"),
                 "ring roll": ("roll_cuda",)}
BERT_GROUPS = {"flash_attention": ("flash_attn",),
               "quant_int8": ("quant_int8",),
               "matmul (cuBLAS)": ("gemm", "Gemm", "cutlass", "nvjet"),
               "ring roll": ("roll_cuda",)}


# ---------------------------------------------------------------------------
# phase 4u: the port's smoke scripts, in this process
# ---------------------------------------------------------------------------

#: phase 4u's share of BUDGET_S
SCRIPTS_BUDGET_S = 15.0
#: the scripts phase 4u runs in their full mode, by file and row metric
SCRIPTS_4U = (("torch_metrics_smoke.py", "metrics_smoke"),
              ("torch_decode_profile_smoke.py", "decode_profile"))


def scripts_path(kernels, card) -> dict:
    """Phase 4u: ``scripts/torch_metrics_smoke.py`` (a 2-stage resnet_tiny
    ``SpmdPipeline`` with tracing) and ``scripts/torch_decode_profile_smoke.py``
    (``PipelinedDecoder``'s steady state) through each script's
    ``main(argv)`` on the card, in this process and in their full mode.
    Each prints its row on a line of its own; a failed check of either
    fails the phase.  The scripts read their counts as deltas from their
    own start, since this process's registry and tracer already hold the
    earlier phases' work.  Neither reaches a hand kernel: 0 launches."""
    import contextlib
    import importlib.util
    import io
    from pathlib import Path

    here = Path(__file__).resolve().parent / "scripts"
    out: dict = {}
    zero_counts(kernels)
    for fname, metric in SCRIPTS_4U:
        spec = importlib.util.spec_from_file_location(fname[:-3],
                                                      here / fname)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                mod.main(["--device", "cuda"])
        except (Exception, SystemExit) as e:
            fail(f"phase 4u: {fname}: {type(e).__name__}: {e}")
        seconds = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        try:
            row = json.loads(lines[-1])
        except (IndexError, ValueError):
            fail(f"phase 4u: {fname} printed no JSON row: {lines[-3:]}")
        if row.get("metric") != metric:
            fail(f"phase 4u: {fname}'s row is {row.get('metric')!r}, "
                 f"want {metric!r}")
        print(f"phase 4u: {fname} ({seconds:.1f} s): {json.dumps(row)}",
              flush=True)
        out[metric] = {"seconds": seconds, "row": row}
    out["launches"] = read_counts(kernels)
    if any(out["launches"].values()):
        fail(f"phase 4u: the scripts launched hand kernels "
             f"{out['launches']}; neither path reaches one")
    print(f"phase 4u: metrics {out['metrics_smoke']['row']['spans']} spans; "
          f"decode {out['decode_profile']['row']['value']} tokens/s, "
          f"{out['decode_profile']['row']['dispatches']} dispatches, "
          f"{out['decode_profile']['row']['warmup_compiles']} warm-up and "
          f"{out['decode_profile']['row']['recompiles_steady']} steady "
          f"compiles; on {card}", flush=True)
    return out


def main() -> int:
    pycache = bytecode_cache()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    try:
        import defer_tpu_torch  # noqa: F401
        from defer_tpu_torch.ops import _build
        from defer_tpu_torch.ops.flash_attention_cuda import KERNEL as FLASH
        from defer_tpu_torch.ops.quant_cuda import KERNEL as QUANT
    except ImportError as e:
        fail(f"the defer_tpu_torch package is not beside this script ({e})")
    device = "cuda"
    kernels = [QUANT, FLASH]
    phase_s: dict = {}
    t_last = [time.perf_counter()]
    taken = [0.0]   # phase 4p's, 4q's, 4r's and 4s's seconds carved out

    def phase_done(name: str) -> None:
        # phase 4p's, 4q's, 4r's and 4s's checks ride other phases' models
        # and chains: their seconds count as theirs, not as the phase's
        # they ran in
        now = time.perf_counter()
        inner = (sum(OBS_SECONDS) + sum(CLI_SECONDS) + sum(TRAIN_SECONDS)
                 + sum(MESH_SECONDS) - taken[0])
        taken[0] += inner
        phase_s[name] = now - t_last[0] - inner
        t_last[0] = now
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        i = PHASES.index(name)
        if i + 1 < len(PHASES):
            WATCH.enter(PHASES[i + 1])

    # phase 1: the card
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; bytecode cache {pycache}", flush=True)

    phase_done("1")

    # phase 2: build every kernel (one nvcc per source, started together)
    t0 = time.perf_counter()
    built = _build.build([k.source for k in kernels])
    for k in kernels:
        k.load()
    for src, info in built.items():
        print(f"build {src}: {info['seconds']:.2f} s -> {info['path'].name}")
        for line in info["log"].splitlines():
            # per kernel: its entry name, registers, spills (a line of its
            # own, without "ptxas") and any serialisation warning
            if ("spill" in line or "Compiling entry" in line
                    or ("ptxas" in line and ("Used" in line
                                             or "Performance Loss" in line))):
                print(f"  {line.strip()}")
    print(f"build: all kernels in {time.perf_counter() - t0:.2f} s "
          f"(nvcc, sm_90a)", flush=True)

    phase_done("2")

    # phase 3: each kernel against its plain version, at main-path shapes
    from defer_tpu_torch.models import RESNET50_8STAGE_CUTS, resnet50
    from defer_tpu_torch.partition import buffer_footprint, partition
    stages = partition(resnet50(image_size=IMAGE_SIZE), RESNET50_8STAGE_CUTS)
    buf = buffer_footprint(stages, microbatch=MICROBATCH,
                           wire="int8")["buf_elems"]
    ring_shape = (len(stages), MICROBATCH, buf)
    rows = {"quant_int8": check_quant(torch, ring_shape, device,
                                      zoo_rings())}
    r = rows["quant_int8"]
    print(f"kernel quant_int8 {tuple(ring_shape)} f32: {r['ms']:.4f} ms, "
          f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB), "
          f"{r['bytes'] / r['ms'] / 1e6:.1f} GB/s, 1 launch per pipeline "
          f"step, on {card}", flush=True)
    rows["flash_attention"] = r = check_flash(torch, device, card)
    print(f"kernel flash_attention {tuple(r['shape'])} f32: {r['ms']:.4f} "
          f"ms, plain {r['plain_ms']:.4f} ms, scaled_dot_product_attention "
          f"{r['library_ms']:.4f} ms (max|diff| vs plain "
          f"{r['library_max_abs_err']:.3g}), bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}: {r['bytes'] / 1e6:.1f} MB; "
          f"{TF32_TERMS} x {r['flops'] / 1e6:.1f} MFLOP of TF32), "
          f"{r['bound_ms'] / r['ms'] * 100:.1f}% of the bound, "
          f"{r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s, on {card}", flush=True)
    for name, r in rows.items():
        b = r["bf16"]
        lib = ("" if b["library_ms"] is None else
               f", scaled_dot_product_attention {b['library_ms']:.4f} ms")
        print(f"kernel {name} {tuple(b['shape'])} bf16: {b['ms']:.4f} ms, "
              f"plain {b['plain_ms']:.4f} ms{lib}, bound {b['bound_ms']:.4f} "
              f"ms ({b['bound_by']}), {b['bound_ms'] / b['ms'] * 100:.1f}% "
              f"of the bound, on {card}", flush=True)

    phase_done("3")

    # phase 4a: ResNet50, the counts zeroed just before each run
    mp = main_path(torch, device, kernels)
    thr = throughput(torch, device, mp, card, "img")
    prof = profile_step(torch, mp, RESNET_GROUPS)
    # phase 4q a: the bench command on the same model (carved out)
    cq = {"bench": cli_bench(torch, kernels, mp, thr, card)}
    # phase 4r a, b, c, e: training on the same model (carved out)
    with train_phase():
        tr = {"resnet50": train_resnet(torch, device, kernels, card, mp)}
    # phase 4t (i)-(iii)'s references: 4r a's and b's own results
    r50 = tr["resnet50"]
    t4 = {"int8": r50["_int8_baseline"], "buffer": r50.pop("_buffer_baseline"),
          "adam_losses": r50["int8"]["adam_losses"],
          "int8_s": r50["int8"]["loss_and_grad_s"],
          "step_s": r50["int8"]["step_s"],
          "buffer_s": r50["buffer"]["seconds"]}
    # phase 4s e: pp x dp training on the same model (carved out)
    with mesh_phase():
        ms = {"train_resnet50_dp2": mesh_train_resnet(
            torch, device, kernels, card, mp, r50.pop("_int8_baseline"))}

    phase_done("4a")

    # phase 4b: BERT-Base, the counts zeroed just before each run
    bp = bert_path(torch, device, kernels)
    bthr = throughput(torch, device, bp, card, "seq")
    bprof = profile_step(torch, bp, BERT_GROUPS)

    phase_done("4b")

    # phase 4c: one graph replay per chunk against the eager loop
    graphs = {"resnet50": graph_vs_eager(torch, mp),
              "bert_base": graph_vs_eager(torch, bp)}

    phase_done("4c")

    # phase 4d: bf16 compute, the counts zeroed just before each run.
    # ResNet50's bf16 ring carries a bf16 quantizer launch per int8 step;
    # BERT-Base's f32 ring an f32 one, and its 12 blocks all run in bf16
    # (its embeddings read the bf16 table, as in the JAX engine)
    blocks = sum(name.startswith("block_") for name in bp["graph"].topo_order)
    mp16 = bf16_path(torch, device, kernels, mp, lambda wire, steps: {
        "quant_int8": {"bfloat16": steps} if wire == "int8" else {},
        "flash_attention": {}})
    bp16 = bf16_path(torch, device, kernels, bp, lambda wire, steps: {
        "quant_int8": {"float32": steps} if wire == "int8" else {},
        "flash_attention": {"bfloat16": blocks * steps}})
    from defer_tpu_torch import Defer, DeferConfig
    prof16 = profile_step(torch, mp, RESNET_GROUPS, label="bf16 int8",
                          defer=Defer(DeferConfig(
                              wire="int8", microbatch=MICROBATCH,
                              chunk=CHUNK, device=device, **mp["bf16"])))
    bprof16 = profile_step(torch, bp, BERT_GROUPS, label="bf16 int8",
                           defer=Defer(DeferConfig(
                               wire="int8", microbatch=MICROBATCH,
                               chunk=CHUNK, device=device, **bp["bf16"])))

    phase_done("4d")

    # phase 4e: reweight after capture
    rew = reweight_after_capture(torch, device, mp)

    phase_done("4e")

    # phase 4f: the queue service, the counts zeroed just before it
    rd = run_defer_path(torch, device, kernels, mp)

    phase_done("4f")

    # phase 4g: GPT-2 small, the counts zeroed just before each run
    gdec, gres, gp = gpt_path(torch, device, kernels, card)
    gres["profile_decode"] = profile_decode(torch, gdec, card)
    # phase 4q b: the generate command on the same model (carved out)
    cq["generate"] = cli_generate(torch, kernels, gdec, gres, gp, card)
    # phase 4r d: training GPT-2 small, into 4g's decoder (carved out)
    with train_phase():
        tr["gpt2"] = train_gpt(torch, device, kernels, card, gp, gdec)
    # phase 4s e: pp x tp training on the same model (carved out)
    with mesh_phase():
        ms["train_gpt2_tp2"] = mesh_train_gpt(
            torch, device, kernels, card, tr["gpt2"].pop("_tp1_baseline"))
    # phase 4t's GPT-2 small: 4g's weights (on the host), prompts, prefill
    # tokens and near ties
    g4t = {k: gp[k] for k in ("graph", "params", "prompts", "prefill_tokens",
                              "gap", "lmax")}
    g4t["tokens_per_s_prefill"] = gres["tokens_per_s_prefill"]
    g4t["score_sequences_per_s"] = gres["score"]["sequences_per_s"]
    del gdec, gp
    free_card(torch)

    phase_done("4g")

    # phase 4h: VGG19/4, InceptionV3/6 and MobileNetV2/2, folded BatchNorm
    # on ResNet50 and MobileNetV2, the MoE family; the counts zeroed just
    # before each run, each path freed before the next
    zoo = {}
    for key, factory, cuts_name, size in ZOO_PATHS:
        zoo[key] = cnn_path(torch, device, kernels, card, key, factory,
                            cuts_name, size)
    from defer_tpu_torch import models
    import numpy as np
    folds = {"resnet50_8": fold_path(torch, device, kernels, card,
                                     "resnet50_8", mp["graph"], mp["cuts"],
                                     mp["inputs"])}
    folds["mobilenetv2_2"] = fold_path(
        torch, device, kernels, card, "mobilenetv2_2",
        models.mobilenet_v2(image_size=IMAGE_SIZE),
        models.MOBILENETV2_2STAGE_CUTS,
        np.random.default_rng(SEED).standard_normal(
            (2 * CHUNK, MICROBATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(
            np.float32))
    moe = moe_path(torch, device, kernels, card)

    phase_done("4h")

    # phase 4i: weights and the host edge; the counts zeroed just before
    # each endpoint run
    ep = endpoint_path(torch, device, kernels, card, mp, prof16)
    free_card(torch)

    phase_done("4i")

    # phase 4j: the serving front door; the counts zeroed just before it
    # and read just after (the engine bypasses both kernels)
    sv = serve_path(torch, device, kernels, card)
    free_card(torch)

    phase_done("4j")

    # phase 4k: the stage-node chain; the counts zeroed just before each
    # stream of the in-process chain, the node processes' own counts read
    # from their stats
    ch, raw, brows = chain_path(torch, device, kernels, card, mp, bp)
    # phase 4q c and d: the export command on 4k's BERT-Base traces, and
    # the serve command that rode 4k's ResNet50 processes (carved out)
    cq["export"] = cli_export(torch, device, kernels, bp, card)
    cq["serve"] = ch.pop("cli_serve")
    phase_done("4k")

    # phase 4l: the colocated tiers; the counts zeroed just before each
    # stream of the in-process BERT chains, the node processes' own counts
    # read from their stats
    dsetup = dag_setup(torch)
    co = colocate_path(torch, device, kernels, card, mp, bp, ch, raw,
                       ahead_of=[(dsetup["stages"], dsetup["params"])])
    shm_stats = co.pop("shm_stats")
    phase_done("4l")

    # phase 4m: the planner; the counts zeroed just before each measured
    # cost map, each Defer.run and each stream of the live chain
    pl = planner_path(torch, device, kernels, card, mp, bp, shm_stats)
    node_costs = pl.pop("resnet50_node_costs")
    phase_done("4m")

    # phase 4n: replication and failover; the counts zeroed just before
    # each stream of the in-process BERT chain, the node processes' own
    # counts read from their stats
    rp = replication_path(torch, device, kernels, card, mp, bp, ch, co, raw,
                          brows, node_costs)
    phase_done("4n")

    # phase 4t's workers do their host start beside 4o (imports, graphs,
    # the inputs mapped) and wait for their go
    procs = procs_spawn(mp, bp, g4t)
    # phase 4o: branched chains; the counts zeroed just before each stream
    # of the in-process deployments, the node processes' counts read from
    # their stats
    dg = dag_path(torch, device, kernels, card, dsetup)
    del dsetup
    phase_done("4o")

    # phase 4t's workers at the card, beside 4s
    procs_go(procs)
    # phase 4s: mesh parallelism on the card; the counts zeroed just before
    # each run (its training checks rode 4a and 4g)
    ms["bert_base"] = mesh_bert(torch, device, kernels, card, bp, bthr)
    ms["sequence"] = mesh_sequence(torch, device, card)
    ms["expert"] = mesh_expert(torch, device, card)
    ms["guard"] = mesh_guard(torch, device, card, mp)
    phase_done("4s")
    phase_s["4s"] += sum(MESH_SECONDS)
    print(f"phase 4s: {phase_s['4s']:.1f} s (of which "
          f"{sum(MESH_SECONDS):.1f} s inside 4a and 4g)", flush=True)

    # phase 4t: the ring across four processes on the card; each worker's
    # counts zeroed just before its runs and read just after
    pt = procs_path(torch, device, kernels, card, mp, bp, thr, bthr, g4t,
                    t4, procs, ep["images_per_s"]["endpoint"],
                    {w: ms["bert_base"][f"tp2_{w}"]["sequences_per_s"]
                     for w in ("buffer", "int8")})
    del g4t, t4, procs
    phase_done("4t")

    # phase 4u: the smoke scripts' metrics and decode rows on the card
    su = scripts_path(kernels, card)
    phase_done("4u")
    WATCH.cancel()
    # phase 4p: the observability checks that rode 4k's and 4n's chains
    phase_s["4p"] = sum(OBS_SECONDS)
    print(f"phase 4p: {phase_s['4p']:.1f} s (inside 4k and 4n)", flush=True)
    # phase 4q: the commands that rode 4a's, 4g's and 4k's paths
    phase_s["4q"] = sum(CLI_SECONDS)
    print(f"phase 4q: {phase_s['4q']:.1f} s (inside 4a, 4g and 4k)",
          flush=True)
    # phase 4r: the training that rode 4a's and 4g's models
    phase_s["4r"] = sum(TRAIN_SECONDS)
    print(f"phase 4r: {phase_s['4r']:.1f} s (inside 4a and 4g)", flush=True)
    total_s = sum(phase_s.values())
    print(f"budget: phases {total_s:.1f} s of {BUDGET_S:.0f} s, phase 4o "
          f"{phase_s['4o']:.1f} s of {DAG_BUDGET_S:.0f} s, phase 4p "
          f"{phase_s['4p']:.1f} s of {OBS_BUDGET_S:.0f} s, phase 4q "
          f"{phase_s['4q']:.1f} s of {CLI_BUDGET_S:.0f} s, phase 4r "
          f"{phase_s['4r']:.1f} s of {TRAIN_BUDGET_S:.0f} s, phase 4s "
          f"{phase_s['4s']:.1f} s of {MESH_BUDGET_S:.0f} s, phase 4t "
          f"{phase_s['4t']:.1f} s of {PROCS_BUDGET_S:.0f} s, phase 4u "
          f"{phase_s['4u']:.1f} s of {SCRIPTS_BUDGET_S:.0f} s; watchdog "
          f"{WATCHDOG_S:.0f} s; on {card}", flush=True)

    by_path = {f"resnet50_{w}": c for w, c in mp["launches"].items()}
    by_path.update({f"bert_base_{w}": c for w, c in bp["launches"].items()})
    by_path.update({f"resnet50_bf16_{w}": c
                    for w, c in mp16["launches"].items()})
    by_path.update({f"bert_base_bf16_{w}": c
                    for w, c in bp16["launches"].items()})
    by_path["resnet50_bf16_int8_run_defer"] = rd["launches"]
    by_path.update({f"gpt2_{p}": c for p, c in gres["launches"].items()})
    by_path.update({f"gpt2_score_{w}": c
                    for w, c in gres["score"]["launches"].items()})
    by_path["gpt2_speculative"] = gres["speculative"]["launches"]
    for key, z in zoo.items():
        by_path.update({f"{key}_{w}": c for w, c in z["launches"].items()})
        by_path.update({f"{key}_bf16_{w}": c
                        for w, c in z["bf16"]["launches"].items()})
    for name, r in moe.items():
        by_path.update({f"{name}_{w}": c for w, c in r["launches"].items()})
    for codec, r in ep["clients"].items():
        by_path[f"resnet50_bf16_int8_endpoint_{codec}"] = r["launches"]
    by_path["gpt2_serve"] = sv["launches"]
    by_path["resnet50_chain_lzb"] = ch["resnet50_lzb"]["launches"]
    by_path["resnet50_chain_raw_and_door"] = ch["resnet50_raw"]["launches"]
    by_path["bert_base_chain"] = ch["bert_base"]["launches"]
    by_path["bert_base_chain_reweight"] = ch["bert_base"][
        "launches_after_reweight"]
    by_path["bert_base_chain_and_ring_timed"] = ch["bert_base"][
        "launches_timed_rounds"]
    for key in ("shm", "ici", "fused"):
        by_path[f"resnet50_chain_{key}"] = co[key]["launches"]
    by_path["bert_base_chain_ici"] = co["bert_ici"]["launches"]
    by_path["bert_base_chain_fused"] = co["bert_fused"]["launches"]
    for key in ("resnet50_f32", "bert_base_f32", "bert_base_bf16"):
        by_path[f"{key}_measured_node_costs"] = pl[key]["launches"]
    for key, r in pl["ring"].items():
        by_path[f"resnet50_int8_{key}_cuts"] = r["launches"]
    for seg, c in pl["cutover"]["launches"].items():
        by_path[f"bert_base_live_cutover_{seg}_segment"] = c
    by_path["resnet50_chain_replicated_failover"] = rp["resnet50"]["launches"]
    by_path["bert_base_chain_replicated"] = rp["bert_base"]["launches"]
    by_path["bert_base_chain_replicated_timed"] = rp["bert_base"][
        "launches_timed_rounds"]
    by_path["dag_inception_v3_inprocess"] = dg["inception_v3"]["launches"]
    by_path["dag_inception_v3_processes"] = dg["inception_v3"][
        "process_run"]["launches"]
    by_path["dag_moe_branched"] = dg["moe_branched"]["launches"]
    ob = {"resnet50_chain": ch.pop("obs_resnet50"),
          "bert_base_chain": ch.pop("obs_bert_base"),
          "autopsy": rp.pop("obs_autopsy")}
    # the window's launches, read as the nodes' window deltas (the twelve
    # nodes share this process's counts)
    by_path["bert_base_chain_profiled_window"] = {
        "flash_attention": ob["bert_base_chain"]["window_flash_launches"],
        "quant_int8": 0}
    for key, r in cq.items():
        by_path[f"cli_{key}"] = r["launches"]
    for key, cnt in tr["resnet50"]["launches"].items():
        by_path[f"train_resnet50_{key}"] = cnt
    by_path["train_cli"] = tr["resnet50"]["cli"]["launches"]
    for key, cnt in tr["resnet50"]["cli"]["api_launches"].items():
        by_path[f"train_cli_{key}"] = cnt
    for key, cnt in tr["gpt2"]["launches"].items():
        by_path[f"train_gpt2_{key}"] = cnt
    for key, cnt in ms["bert_base"]["launches"].items():
        by_path[f"mesh_bert_base_{key}"] = cnt
    by_path["mesh_train_resnet50_dp2_int8"] = ms["train_resnet50_dp2"][
        "launches"]
    by_path["mesh_train_gpt2_tp2"] = ms["train_gpt2_tp2"]["launches"]
    for key in ("resnet_buffer", "resnet_int8", "bert_buffer", "bert_int8",
                "dp_int8"):
        by_path[f"procs_{key}"] = pt[key]["launches"]
    for key, r in pt["gpt2"].items():
        by_path[f"procs_gpt2_{key}"] = r["launches"]
    for key, r in pt["train"].items():
        by_path[f"procs_train_resnet50_{key}"] = r["launches"]
    for key, r in pt["serve"].items():
        by_path[f"procs_{key}_resnet50_int8"] = r["launches"]
    for key, r in pt["tp"].items():
        by_path[f"procs_tp_bert_base_{key}"] = r["launches"]
    by_path["scripts_metrics_and_decode_profile"] = su["launches"]
    dtypes = {f"resnet50_bf16_{w}": c for w, c in mp16["by_dtype"].items()}
    dtypes.update({f"bert_base_bf16_{w}": c
                   for w, c in bp16["by_dtype"].items()})
    dtypes["resnet50_bf16_int8_run_defer"] = rd["by_dtype"]
    for codec, r in ep["clients"].items():
        dtypes[f"resnet50_bf16_int8_endpoint_{codec}"] = r["by_dtype"]
    for key, z in zoo.items():
        dtypes.update({f"{key}_bf16_{w}": c
                       for w, c in z["bf16"]["by_dtype"].items()})
    for key, f in folds.items():
        dtypes.update({f"{key}_bf16_int8_{label}_bn": c
                       for label, c in f["by_dtype"].items()})
    for k in kernels:
        row = rows[k.name]
        row["launches_by_path"] = {p: c[k.name] for p, c in by_path.items()}
        row["launches_by_dtype_bf16_paths"] = {
            p: c[k.name] for p, c in dtypes.items()}
        row["launches"] = sum(row["launches_by_path"].values()) + sum(
            sum(c[k.name].values()) for p, c in dtypes.items()
            if p.endswith("_bn"))
        if row["launches"] == 0:
            fail(f"kernel {k.name} was not launched on the main paths")

    # phase 5: report
    print(json.dumps({"main_path": {
        "model": "resnet50", "stages": len(stages), "wire": "int8",
        "microbatch": MICROBATCH, "chunk": CHUNK, "steps": mp["steps"],
        "rel_err": mp["rel_err"], "top1_agree": mp["top1_agree"],
        "buffer_rel_err": mp["buffer_rel_err"], "images_per_s": thr,
        "profile_int8": prof, "graph_vs_eager": graphs["resnet50"],
        "bf16": {k: v for k, v in mp16.items() if k != "launches"},
        "profile_bf16_int8": prof16, "reweight": rew, "run_defer": rd}}))
    print(json.dumps({"bert_path": {
        "model": "bert_base", "seq_len": SEQ_LEN,
        "stages": len(bp["cuts"]) + 1, "microbatch": MICROBATCH,
        "chunk": CHUNK, "steps": bp["steps"], "rel_err": bp["rel_err"],
        "sequences_per_s": bthr, "profile_int8": bprof,
        "graph_vs_eager": graphs["bert_base"],
        "bf16": {k: v for k, v in bp16.items() if k != "launches"},
        "profile_bf16_int8": bprof16}}))
    print(json.dumps({"gpt_path": {
        "model": "gpt2_small", "stages": GPT_STAGES,
        "microbatch": MICROBATCH, "max_len": GPT_MAX_LEN,
        "prompts": list(GPT_PROMPTS), "new_tokens": GPT_NEW,
        **{k: v for k, v in gres.items() if k != "launches"}}}))
    print(json.dumps({"zoo_path": {
        "microbatch": MICROBATCH, "chunk": CHUNK, "card": card,
        **{k: {f: v for f, v in z.items() if f != "launches"}
           for k, z in zoo.items()},
        "fold_batchnorm": folds, "moe": moe}}))
    print(json.dumps({"endpoint_path": {
        "model": "resnet50", "stages": len(stages), "wire": "int8",
        "config": mp["bf16"], "microbatch": MICROBATCH, "chunk": CHUNK,
        "clients": 2, "images_per_client": ENDPOINT_IMAGES, **ep}}))
    print(json.dumps({"serve_path": {
        "model": "gpt2_small", "card": card,
        **{k: v for k, v in sv.items() if k != "launches"}}}))
    print(json.dumps({"chain_path": {
        "model": "resnet50 + bert_base", "microbatch": MICROBATCH,
        "images": CHAIN_IMAGES, "sequences": CHAIN_SEQS, **ch}}))
    print(json.dumps({"colocate_path": {
        "model": "resnet50 + bert_base", "microbatch": MICROBATCH,
        "images": CHAIN_IMAGES, "sequences": CHAIN_SEQS,
        "tcp_chain_images_per_s": ch["resnet50_raw"]["chain_images_per_s"],
        "tcp_chain_sequences_per_s": ch["bert_base"]["chain_sequences_per_s"],
        "ring_sequences_per_s": ch["bert_base"]["ring_sequences_per_s"],
        **co}}))
    print(json.dumps({"planner_path": {
        "models": "resnet50 + bert_base", "microbatch": MICROBATCH, **pl}}))
    print(json.dumps({"replication_path": {
        "models": "resnet50 + bert_base", "microbatch": MICROBATCH, **rp}}))
    print(json.dumps({"dag_path": {
        "microbatch": MICROBATCH, "budget_s": DAG_BUDGET_S, **dg}}))
    print(json.dumps({"obs_path": {
        "microbatch": MICROBATCH, "budget_s": OBS_BUDGET_S,
        "seconds": phase_s["4p"], **ob}}))
    print(json.dumps({"cli_path": {
        "microbatch": MICROBATCH, "budget_s": CLI_BUDGET_S,
        "seconds": phase_s["4q"], **cq}}))
    print(json.dumps({"train_path": {
        "microbatch": MICROBATCH, "budget_s": TRAIN_BUDGET_S,
        "seconds": phase_s["4r"], **tr}}))
    print(json.dumps({"mesh_path": {
        "microbatch": MICROBATCH, "budget_s": MESH_BUDGET_S,
        "seconds": phase_s["4s"], **ms}}))
    print(json.dumps({"procs_path": {
        "microbatch": MICROBATCH, "budget_s": PROCS_BUDGET_S,
        "seconds": phase_s["4t"], **pt}}))
    print(json.dumps({"scripts_path": {
        "budget_s": SCRIPTS_BUDGET_S, "seconds": phase_s["4u"], **su}}))
    print(json.dumps({"phase_seconds": phase_s,
                      "total_s": sum(phase_s.values()),
                      "budget_s": BUDGET_S, "watchdog_s": WATCHDOG_S}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


#: the smoke's watchdog, armed before anything else runs
WATCH = Watchdog(WATCHDOG_S)

if __name__ == "__main__":
    WATCH.start()
    try:
        rc = main()
    except BaseException:
        # a phase that raised leaves no node process behind it
        kill_children()
        raise
    sys.exit(rc)
